"""Tests for randoms sampling, autocuts, the noise pipeline, and salting."""

import numpy as np
import jax.numpy as jnp
import pytest
import pandas as pd

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.ops import autocuts
from detprocess_jax.pipelines.randoms import Randoms
from detprocess_jax.pipelines.noise import Noise
from detprocess_jax.pipelines.salting import Salting, sample_from_pdf
from detprocess_jax.pipelines.triggers import TriggerProcessing
import yaml

FS = 1.25e6
L = 250000       # 0.2 s continuous traces
CHANNELS = ["chan1", "chan2"]


@pytest.fixture(scope="module")
def contdata(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(0)
    sigma = 2e-6
    traces = rng.standard_normal((4, 2, L)) * sigma
    # event 2 of chan1 gets a huge glitch (should be cut)
    traces[1, 0, 100000:100500] += 50e-6
    writer = RawWriter(str(root / "raw"), "I1_D20260816_T160000", FS,
                       CHANNELS, data_type="continuous")
    writer.write_dump(traces, dump_num=1)
    raw_files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    return dict(root=root, raw_files=raw_files, sigma=sigma, traces=traces)


class TestRandoms:
    def test_rate_sampling(self, contdata):
        r = Randoms(contdata["raw_files"], verbose=False)
        df = r.process(random_rate=50.0, min_separation_msec=2.0,
                       edge_exclusion_msec=2.0, seed=1)
        # 0.2 s traces × 4 events × 50 Hz = 40 randoms
        assert len(df) == 40
        assert (df["trigger_type"] == 3).all()
        # constraints respected
        edge = int(np.ceil(FS * 2e-3))
        assert df["trigger_index"].min() >= edge
        assert df["trigger_index"].max() <= L - edge
        for _, g in df.groupby("event_number"):
            seps = np.diff(np.sort(g["trigger_index"].to_numpy()))
            assert (seps >= int(np.ceil(FS * 2e-3))).all()

    def test_count_capped(self, contdata):
        r = Randoms(contdata["raw_files"], verbose=False)
        df = r.process(random_rate=100.0, nrandoms=10, seed=2,
                       min_separation_msec=1.0, edge_exclusion_msec=1.0)
        assert len(df) == 10

    def test_windowed_trace_read(self, contdata):
        r = Randoms(contdata["raw_files"], verbose=False)
        df = r.process(random_rate=20.0, seed=3, min_separation_msec=2.0,
                       edge_exclusion_msec=5.0)
        n, p = 4096, 2048
        traces = r.read_random_traces(df, n, p, channels=CHANNELS)
        assert traces.shape[1:] == (2, n)
        # values match the raw data at the right window
        row = df.iloc[0]
        ev = int(row["event_number"]) - 1
        start = int(row["trigger_index"]) - p
        np.testing.assert_allclose(
            traces[0, 0], contdata["traces"][ev, 0, start:start + n],
            rtol=1e-6)


class TestAutocuts:
    def test_glitch_cut(self):
        rng = np.random.default_rng(5)
        traces = rng.standard_normal((64, 2048))
        traces[7] += 25.0          # baseline jump
        traces[21, 1000:1100] += 30.0  # glitch
        traces[40] *= 6.0          # noisy trace
        mask = np.asarray(autocuts.autocuts_noise(jnp.asarray(traces)))
        assert not mask[7] and not mask[21] and not mask[40]
        assert mask.sum() >= 55

    def test_passes_clean_noise(self):
        rng = np.random.default_rng(6)
        traces = rng.standard_normal((128, 1024))
        mask = np.asarray(autocuts.autocuts_noise(jnp.asarray(traces)))
        # sigma clipping at 2.5σ keeps the bulk
        assert mask.mean() > 0.8

    def test_didv_mean_removal(self):
        rng = np.random.default_rng(7)
        t = np.arange(2048)
        square = 5.0 * np.sign(np.sin(2 * np.pi * t / 512))
        traces = square[None, :] + rng.standard_normal((32, 2048)) * 0.1
        traces[3] += 8.0  # offset outlier
        mask = np.asarray(autocuts.autocuts_didv(jnp.asarray(traces)))
        assert not mask[3]
        assert mask.sum() >= 28


class TestNoisePipeline:
    def test_psd_estimation(self, contdata):
        noise = Noise(contdata["raw_files"], verbose=False)
        noise.generate_randoms(random_rate=100.0, seed=4,
                               min_separation_msec=1.0,
                               edge_exclusion_msec=2.0)
        noise.calc_psd(CHANNELS, trace_length_samples=4096,
                       pretrigger_length_samples=2048)
        psd, freqs = noise.get_psd("chan1")
        assert psd.shape == (4096,)
        # white noise: two-sided PSD = sigma²/fs
        expected = contdata["sigma"] ** 2 / FS
        np.testing.assert_allclose(np.median(psd[1:]), expected, rtol=0.1)

    def test_csd_estimation_and_save(self, contdata, tmp_path):
        noise = Noise(contdata["raw_files"], verbose=False)
        noise.generate_randoms(random_rate=100.0, seed=5,
                               min_separation_msec=1.0,
                               edge_exclusion_msec=2.0)
        noise.calc_csd(CHANNELS, trace_length_samples=2048,
                       pretrigger_length_samples=1024)
        csd, freqs = noise.get_csd("chan1|chan2")
        assert csd.shape == (2, 2, 2048)
        # independent channels: off-diagonal much smaller than diagonal
        diag = np.median(np.abs(csd[0, 0, 1:]))
        off = np.median(np.abs(csd[0, 1, 1:]))
        assert off < 0.5 * diag
        # persists through the filter file
        path = str(tmp_path / "filter.h5")
        noise.save_hdf5(path)
        back = FilterData(verbose=False).load_hdf5(path)
        csd2, _ = back.get_csd("chan1|chan2")
        np.testing.assert_allclose(csd2, csd, rtol=1e-12)


class TestSalting:
    def test_sample_from_pdf(self):
        rng = np.random.default_rng(8)
        e = np.linspace(1, 100, 200)
        drde = np.exp(-e / 20.0)
        samples = sample_from_pdf(e, drde, 20000, rng)
        assert samples.min() >= 1 and samples.max() <= 100
        # exponential-ish: mean near 20 (truncated)
        assert 15 < samples.mean() < 25

    def test_pdf_file_sampling(self, contdata, tmp_path):
        """DM PDF file ({mass: {'dmrate': fn}} cloudpickle) sampling
        (salting.py:326-338): per-mass energies + mass column."""
        import cloudpickle
        from detprocess_jax.pipelines.salting import sample_pdf_function

        rng = np.random.default_rng(3)
        samples = sample_pdf_function(lambda x: np.exp(-x / 0.1),
                                      (1e-5, 1.0), 50000, rng)
        assert 0.08 < samples.mean() < 0.12  # truncated exp, mean ~0.1

        pdf_path = tmp_path / "dm.pkl"
        dists = {10.0: {"dmrate": lambda e: np.exp(-e / 0.05)},
                 100.0: {"dmrate": lambda e: np.exp(-e / 0.3)}}
        with open(pdf_path, "wb") as f:
            cloudpickle.dump(dists, f)

        nt, pretrig = 4096, 1024
        tmpl = pulse.make_template(FS, nt, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        fd = FilterData(verbose=False)
        for chan in CHANNELS:
            fd.set_template(chan, tmpl, FS,
                            pretrigger_length_samples=pretrig)
        salting = Salting(fd, verbose=False)
        df = salting.generate_salt(
            contdata["raw_files"], ["chan1"], pdf_file=str(pdf_path),
            nsalt=5, energy_norm_ev_per_amp=1e7,
            channel_fractions={"chan1": 1.0}, seed=4,
            min_separation_msec=10.0, edge_exclusion_msec=5.0)
        assert len(df) == 10
        assert set(df["salt_dm_mass_mev"]) == {10.0, 100.0}
        # energies in eV (keV grid x 1e3), soft spectrum lower for m=10
        e10 = df[df["salt_dm_mass_mev"] == 10.0]["salt_energy_ev"]
        e100 = df[df["salt_dm_mass_mev"] == 100.0]["salt_energy_ev"]
        assert e10.mean() < e100.mean()
        assert (df["salt_energy_ev"] < 1000.0).all()

    def test_generate_and_inject(self, contdata, tmp_path):
        nt, pretrig = 4096, 1024
        tmpl = pulse.make_template(FS, nt, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        fd = FilterData(verbose=False)
        for chan in CHANNELS:
            fd.set_template(chan, tmpl, FS,
                            pretrigger_length_samples=pretrig)
            fd.set_psd(chan, np.full(nt, contdata["sigma"]**2 / FS), FS)

        salting = Salting(fd, verbose=False)
        df = salting.generate_salt(
            contdata["raw_files"], CHANNELS, energies=[100.0], nsalt=10,
            energy_norm_ev_per_amp=1e7, seed=9,
            min_separation_msec=20.0, edge_exclusion_msec=10.0)
        assert len(df) == 10 * len(CHANNELS)
        assert (df["salt_amplitude"] > 0).all()
        np.testing.assert_allclose(df["salt_energy_ev"], 50.0)  # equal split

        # injection modifies the trace at the salt position
        admin = {"series_number": df["series_number"].iloc[0],
                 "event_number": df["event_number"].iloc[0]}
        ev = int(admin["event_number"]) - 1
        traces = contdata["traces"][ev]
        salted = salting.inject_raw_salt(traces, admin, CHANNELS)
        diff = salted - traces
        sel = df[df["event_number"] == admin["event_number"]]
        for _, row in sel.iterrows():
            ci = CHANNELS.index(row["salt_channel"])
            ti = int(row["trigger_index"])
            peak_region = diff[ci, ti:ti + nt]
            assert np.max(peak_region) > 0

    def test_salted_triggering(self, contdata, tmp_path):
        """Salts injected into continuous data are found by the trigger."""
        nt, pretrig = 4096, 1024
        tmpl = pulse.make_template(FS, nt, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        fd = FilterData(verbose=False)
        for chan in CHANNELS:
            fd.set_template(chan, tmpl, FS,
                            pretrigger_length_samples=pretrig)
            fd.set_psd(chan, np.full(nt, contdata["sigma"]**2 / FS), FS)

        salting = Salting(fd, verbose=False)
        df = salting.generate_salt(
            contdata["raw_files"], ["chan1"], energies=[100.0], nsalt=6,
            energy_norm_ev_per_amp=2e6,  # 50 eV → 2.5e-5 A: loud
            channel_fractions={"chan1": 1.0},
            seed=11, min_separation_msec=50.0, edge_exclusion_msec=20.0)

        config = {"trigger": {
            "chan1": {"run": True, "template_tag": "default",
                      "threshold_sigma": 10.0, "pileup_window_msec": 0.5}}}
        cpath = str(tmp_path / "t.yaml")
        yaml.safe_dump(config, open(cpath, "w"))
        proc = TriggerProcessing(contdata["raw_files"], cpath,
                                 filter_data=fd, verbose=False)
        proc.set_salting(salting.make_injector(CHANNELS))
        out = proc.process(capacity=128)
        # every salt recovered within ±2 samples
        found = out["trigger_index"].to_numpy()
        for ti in df["trigger_index"]:
            assert np.min(np.abs(found - ti)) <= 2

    def test_salted_features(self, contdata, tmp_path):
        """Salts must be re-injected during feature extraction too
        (reference processing_data.py:539-553): the OF amplitude of a
        salt trigger should recover the salt amplitude, not noise."""
        from detprocess_jax.pipelines.features import FeatureProcessing

        nt, pretrig = 4096, 1024
        tmpl = pulse.make_template(FS, nt, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        fd = FilterData(verbose=False)
        for chan in CHANNELS:
            fd.set_template(chan, tmpl, FS,
                            pretrigger_length_samples=pretrig)
            fd.set_psd(chan, np.full(nt, contdata["sigma"]**2 / FS), FS)

        salting = Salting(fd, verbose=False)
        df = salting.generate_salt(
            contdata["raw_files"], ["chan1"], energies=[100.0], nsalt=4,
            energy_norm_ev_per_amp=2e6,  # 50 eV → 2.5e-5 A
            channel_fractions={"chan1": 1.0},
            seed=13, min_separation_msec=50.0, edge_exclusion_msec=20.0)
        amp_true = df["salt_amplitude"].iloc[0]

        config = {
            "trigger": {"chan1": {"run": True, "template_tag": "default",
                                  "threshold_sigma": 10.0,
                                  "pileup_window_msec": 0.5}},
            "feature": {
                "trace_length_samples": nt,
                "pretrigger_length_samples": pretrig,
                "chan1": {"of1x1_nodelay": {"run": True,
                                            "template_tag": "default"}}},
        }
        cpath = str(tmp_path / "tf.yaml")
        yaml.safe_dump(config, open(cpath, "w"))

        proc = TriggerProcessing(contdata["raw_files"], cpath,
                                 filter_data=fd, verbose=False)
        proc.set_salting(salting.make_injector(CHANNELS))
        trig_df = proc.process(capacity=128)
        assert len(trig_df) >= len(df)

        feat = FeatureProcessing(contdata["raw_files"], cpath,
                                 filter_data=fd,
                                 trigger_dataframe=trig_df, verbose=False)
        feat.set_salting(salting.make_injector(CHANNELS))
        features = feat.process(batch_size=8)
        amps = features["amp_of1x1_nodelay_chan1"].to_numpy()
        # match feature rows back to salts by trigger_index
        fti = features["trigger_index"].to_numpy()
        for ti in df["trigger_index"]:
            i = int(np.argmin(np.abs(fti - ti)))
            assert abs(fti[i] - ti) <= 2
            np.testing.assert_allclose(amps[i], amp_true, rtol=0.15)

        # without the injector the same windows read unsalted data
        feat2 = FeatureProcessing(contdata["raw_files"], cpath,
                                  filter_data=fd,
                                  trigger_dataframe=trig_df, verbose=False)
        features2 = feat2.process(batch_size=8)
        amps2 = features2["amp_of1x1_nodelay_chan1"].to_numpy()
        fti2 = features2["trigger_index"].to_numpy()
        salt_rows = [int(np.argmin(np.abs(fti2 - ti)))
                     for ti in df["trigger_index"]]
        assert np.max(np.abs(amps2[salt_rows])) < amp_true / 3


class TestCompoundChannelPSD:
    def test_sum_channel_psd(self, contdata):
        noise = Noise(contdata["raw_files"], verbose=False)
        noise.generate_randoms(random_rate=60.0, seed=6,
                               min_separation_msec=1.0,
                               edge_exclusion_msec=2.0)
        noise.calc_psd(["chan1", "chan1+chan2", "chan1-chan2"],
                       trace_length_samples=2048,
                       pretrigger_length_samples=1024)
        psd_sum, _ = noise.get_psd("chan1+chan2")
        psd_single, _ = noise.get_psd("chan1")
        # independent equal-variance channels: sum PSD ≈ 2× single PSD
        ratio = np.median(psd_sum[1:] / psd_single[1:])
        assert 1.6 < ratio < 2.4
        psd_diff, _ = noise.get_psd("chan1-chan2")
        ratio2 = np.median(psd_diff[1:] / psd_single[1:])
        assert 1.6 < ratio2 < 2.4


def test_sample_from_pdf_bin_width_aware():
    """A flat dR/dE on a LOG-spaced grid is uniform in E: the CDF must
    integrate with bin widths, not weight by array index (which would
    oversample low energies by orders of magnitude)."""
    from detprocess_jax.pipelines.salting import sample_from_pdf

    rng = np.random.default_rng(0)
    energies = np.geomspace(1.0, 1000.0, 200)
    drde = np.ones_like(energies)
    samples = sample_from_pdf(energies, drde, 20000, rng)
    # uniform in E: mean ~ 500, median ~ 500, ~10% below 100
    assert abs(samples.mean() - 500.0) < 20
    assert abs(np.median(samples) - 500.0) < 25
    frac_low = np.mean(samples < 100.0)
    assert abs(frac_low - 0.1) < 0.02, frac_low
