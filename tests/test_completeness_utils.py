"""Tests for the completeness utilities: merge, dynamic triggers, template
alignment, normal-noise fit, bias-point discovery, trigger template info."""

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse, tesnoise
from detprocess_jax.ops import filterbank, trigger
from detprocess_jax.pipelines.merge import merge_feature_tables
from detprocess_jax.pipelines.noisemodel import NoiseModel
from detprocess_jax.pipelines.ivsweep import discover_bias_points
from detprocess_jax.pipelines.triggers import get_trigger_template_info

FS = 1.25e6


class TestMerge:
    def test_merge_by_stamp(self):
        df1 = pd.DataFrame({
            "event_time": [100, 200], "trigger_index": [1000, 2000],
            "trigger_delta_chi2": [50.0, 60.0],
            "amp_chan1": [1e-6, 2e-6]})
        df2 = pd.DataFrame({
            "event_time": [100, 300], "trigger_index": [1030, 5000],
            "trigger_delta_chi2": [70.0, 80.0],
            "amp_chan2": [3e-6, 4e-6]})
        out = merge_feature_tables([df1, df2], fs=1.0,
                                   merge_window_samples=100)
        # stamps: 1100, 2200 | 1130, 5300 → 1100+1130 merge
        assert len(out) == 3
        merged = out[out["merge_nb_matched"] == 2]
        assert len(merged) == 1
        row = merged.iloc[0]
        assert row["amp_chan1"] == 1e-6 and row["amp_chan2"] == 3e-6

    def test_duplicate_resolution_by_chi2(self):
        df1 = pd.DataFrame({
            "event_time": [0, 0], "trigger_index": [1000, 1010],
            "trigger_delta_chi2": [10.0, 99.0],
            "amp": [1.0, 2.0]})
        out = merge_feature_tables([df1], fs=1.0, merge_window_samples=50)
        assert len(out) == 1
        assert out.iloc[0]["amp"] == 2.0  # larger delta chi2 wins


class TestDynamicTrigger:
    def test_dynamic_window(self):
        d = np.zeros(1000)
        d[[100, 140, 300]] = [50.0, 45.0, 30.0]
        amps = d[None, :]
        # small window for small amps → 100/140 separate;
        # large window for big amps → they merge
        idx, dd, aa = trigger.find_triggers_dynamic(
            d, amps, 10.0, lambda amp: 20)
        assert len(idx) == 3
        idx2, _, _ = trigger.find_triggers_dynamic(
            d, amps, 10.0, lambda amp: 60 if amp > 40 else 10)
        assert len(idx2) == 2
        assert 100 in idx2 and 300 in idx2


class TestTemplateAlignment:
    def test_shift_templates(self):
        tmpl1 = pulse.make_template(FS, 1024, 256, A=1.0, tau_r=20e-6,
                                    tau_f1=200e-6)
        tmpl2 = np.roll(tmpl1, 37)
        csd = np.full(1024, 1e-20, dtype=complex)
        shifted, shifts = trigger.shift_templates_to_match_chi2(
            FS, tmpl1, [tmpl2], csd, block=4096)
        # ±1 sample: the DC-removed matched filter's peak can sit one
        # sample off for smooth templates (same behavior as the reference)
        assert abs(shifts[0] + 37) <= 1
        residual = np.roll(tmpl2, shifts[0]) - tmpl1
        assert np.max(np.abs(residual)) <= np.max(
            np.abs(np.roll(tmpl1, 1) - tmpl1)) + 1e-12


class TestNormalNoiseFit:
    def test_fit_recovers_params(self):
        rn, rl, tc = 0.3, 0.02, 0.04
        L_true, tload_true, squid_true = 4e-7, 0.033, 3e-12
        freqs = np.geomspace(10, 2e5, 256)
        # s_i_normal is ONE-sided; the fit takes a two-sided
        # measurement, so feed the two-sided density s/2
        psd = tesnoise.s_i_normal(rn, rl, L_true, tc, tload_true,
                                  squid_true, freqs) / 2.0
        nm = NoiseModel(verbose=False)
        # clean synthetic PSD: no spike-flattening needed (the envelope
        # smoothing is for real spectra with EMI lines)
        out = nm.fit_normal_noise("chan1", psd, freqs, rn, rl, tc,
                                  lgc_flatten=False)
        np.testing.assert_allclose(out["L"], L_true, rtol=0.1)
        np.testing.assert_allclose(out["tload"], tload_true, rtol=0.1)
        np.testing.assert_allclose(out["squiddc"], squid_true, rtol=0.15)

    def test_fit_robust_to_emi_lines(self):
        """flatten_psd (noisemodel.py:1293-1321 equivalent) suppresses
        narrow EMI spikes so the fit still recovers the continuum."""
        rn, rl, tc = 0.3, 0.02, 0.04
        L_true, tload_true, squid_true = 4e-7, 0.033, 3e-12
        freqs = np.linspace(0.0, 2e5, 2048)   # folded linear grid, DC first
        psd = tesnoise.s_i_normal(rn, rl, L_true, tc, tload_true,
                                  squid_true, np.where(freqs == 0, 1.0,
                                                       freqs)) / 2.0
        spiky = psd.copy()
        spiky[5::97] *= 300.0  # forest of narrow EMI lines
        nm = NoiseModel(verbose=False)
        out = nm.fit_normal_noise("chan1", spiky, freqs, rn, rl, tc)
        np.testing.assert_allclose(out["L"], L_true, rtol=0.2)
        np.testing.assert_allclose(out["tload"], tload_true, rtol=0.3)

    def test_flatten_psd_and_make_decreasing(self):
        from detprocess_jax.pipelines.noisemodel import (flatten_psd,
                                                         make_decreasing)
        y = np.array([5.0, 3.0, 4.0, 2.0, 6.0])
        np.testing.assert_allclose(make_decreasing(y),
                                   [5.0, 3.0, 3.0, 2.0, 2.0])
        # two-sided symmetric PSD: envelope taken vs |f|
        f = np.fft.fftfreq(1024, 1 / 1e6)
        psd = 1.0 / (1.0 + (np.abs(f) / 1e4) ** 2)
        psd_spiky = psd.copy()
        psd_spiky[100] *= 50
        flat = flatten_psd(f, psd_spiky)
        assert flat[100] < 3 * psd[100]
        # monotone decreasing vs |f| on the positive half
        pos = np.argsort(np.abs(f[1:513]))
        assert np.all(np.diff(flat[1:513][pos]) <= 1e-12)


class TestDiscovery:
    def test_discover_bias_points(self, tmp_path):
        rng = np.random.default_rng(0)
        biases = [100e-6, 50e-6]
        for k, b in enumerate(biases):
            for prefix, dtype in (("iv", "noise"), ("didv", "didv")):
                w = RawWriter(str(tmp_path), f"I1_D20260816_T0{k}{prefix=='didv':d}0000",
                              FS, ["chan1"], prefix=prefix, data_type=dtype,
                              detector_config={"chan1": {"tes_bias": b}})
                w.write_dump(rng.standard_normal((2, 1, 512)), dump_num=1)
        points = discover_bias_points(str(tmp_path), "chan1")
        assert len(points) == 2
        assert points[0]["tes_bias"] == 100e-6  # normal branch first
        for p in points:
            assert p["noise_files"] and p["didv_files"]


class TestTriggerTemplateInfo:
    def test_info(self):
        fd = FilterData(verbose=False)
        tmpl = pulse.make_template(FS, 2048, 512, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=512)
        cfg = {"channels": {"chan1": {"run": True, "channel_name": "chan1",
                                      "template_tag": "default"}}}
        info = get_trigger_template_info(cfg, fd)
        assert info["chan1"]["nb_samples"] == 2048
        assert info["chan1"]["nb_pretrigger_samples"] == 512
        np.testing.assert_allclose(info["min_edge_exclusion"],
                                   1e3 * 512 / FS)
