"""int16 ADC-code storage + on-device ADC→amps conversion.

Real pytesdaq raw files store int16 ADC codes with per-channel
conversion factors (amps = codes · cal / close_loop_norm). The pipelines
read the STORED codes, upload them as int16 — half the host→device bytes
of float32 — and convert on device (the reference always converts on the
host via pytesio, processing_data.py:520-526).

Losslessness trick used throughout: conversion factors are powers of two
and the underlying data are exact int16 codes, so codes·conv is exactly
representable in float32 — the float-stored and int16-stored pipelines
must then produce BIT-IDENTICAL outputs.
"""

import numpy as np
import pandas as pd
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawReader, RawWriter
from detprocess_jax.models import pulse

FS = 1.25e6
NT = 1024
PRETRIG = 256
L = 30000
CHANNELS = ["chan1", "chan2"]
CAL = 2.0 ** -22                       # volts/bit (power of two: exact)
CLN = {"chan1": 1.0, "chan2": 2.0}     # close_loop_norm per channel
CONV = np.array([CAL / CLN[c] for c in CHANNELS])


def make_codes(rng, positions_amps, tmpl, sigma_codes=30.0):
    """Continuous 2-channel event as exact int16 codes."""
    codes = np.rint(rng.standard_normal((len(CHANNELS), L)) * sigma_codes)
    for ch, pos, amp_codes in positions_amps:
        start = pos - PRETRIG
        codes[ch, start:start + NT] += np.rint(amp_codes * tmpl)
    return codes.astype(np.int16)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("adc")
    rng = np.random.default_rng(7)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)

    ev1 = make_codes(rng, [(0, 8000, 3000.0), (1, 20000, 2500.0)], tmpl)
    ev2 = make_codes(rng, [(1, 12000, 4000.0)], tmpl)
    codes = np.stack([ev1, ev2])                       # [E, C, L] int16
    amps = codes.astype(np.float64) * CONV[None, :, None]

    detcfg = {c: {"close_loop_norm": CLN[c], "output_gain": 10.0}
              for c in CHANNELS}

    int_dir, float_dir = root / "int16", root / "float32"
    w_int = RawWriter(str(int_dir), "I1_D20260816_T150000", FS, CHANNELS,
                      data_type="continuous", detector_config=detcfg,
                      adc_conversion_factor=CAL)
    w_int.write_dump(amps, dump_num=1)
    w_flt = RawWriter(str(float_dir), "I1_D20260816_T150000", FS, CHANNELS,
                      data_type="continuous", detector_config=detcfg)
    w_flt.write_dump(amps, dump_num=1)

    # per-channel noise sigma in amps for the filter PSDs
    sigma_amps = 30.0 * CONV
    fd = FilterData(verbose=False)
    for i, chan in enumerate(CHANNELS):
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(chan, np.full(NT, sigma_amps[i] ** 2 / FS), FS)
    filter_path = str(root / "filter.h5")
    fd.save_hdf5(filter_path)

    config = {
        "trigger": {
            "chan1": {"run": True, "template_tag": "default",
                      "threshold_sigma": 8.0, "pileup_window_msec": 0.2},
            "chan2": {"run": True, "template_tag": "default",
                      "threshold_sigma": 8.0, "pileup_window_msec": 0.2},
        },
    }
    config_path = str(root / "trig.yaml")
    with open(config_path, "w") as fh:
        yaml.safe_dump(config, fh)

    return dict(
        int_files=sorted(str(p) for p in int_dir.glob("*.hdf5")),
        float_files=sorted(str(p) for p in float_dir.glob("*.hdf5")),
        filter_path=filter_path, config_path=config_path,
        codes=codes, amps=amps, tmpl=tmpl)


class TestWriterReader:
    def test_int16_stored_and_raw_read(self, dataset):
        import h5py

        with h5py.File(dataset["int_files"][0], "r") as f:
            ds = f["adc1"]["event_1"]
            assert ds.dtype == np.int16
            assert f["adc1"].attrs["adc_conversion_factor"] == CAL

        rd = RawReader(dataset["int_files"])
        raw, admin = rd.read_next_event(dtype=None, adctoamp=False)
        assert raw.dtype == np.int16
        np.testing.assert_array_equal(raw, dataset["codes"][0])
        np.testing.assert_array_equal(admin["adc_conv"],
                                      CONV.astype(np.float32))

    def test_amps_read_matches_truth(self, dataset):
        rd = RawReader(dataset["int_files"])
        tr, admin = rd.read_next_event()          # float64 amps default
        assert "adc_conv" not in admin
        np.testing.assert_array_equal(tr, dataset["amps"][0])

    def test_raw_mode_requires_no_adctoamp(self, dataset):
        rd = RawReader(dataset["int_files"])
        with pytest.raises(ValueError, match="adctoamp"):
            rd.read_next_event(dtype=None, adctoamp=True)

    def test_channel_subset_conv(self, dataset):
        rd = RawReader(dataset["int_files"])
        raw, admin = rd.read_next_event(channels=["chan2"], dtype=None,
                                        adctoamp=False)
        np.testing.assert_array_equal(raw, dataset["codes"][0][1:])
        np.testing.assert_array_equal(admin["adc_conv"],
                                      CONV[1:].astype(np.float32))

    def test_overflow_raises(self, tmp_path):
        w = RawWriter(str(tmp_path / "ovf"), "I1_D20260816_T150000", FS,
                      ["chan1"], adc_conversion_factor=1e-9)
        big = np.full((1, 1, 64), 1.0)             # 1e9 codes ≫ 32767
        with pytest.raises(ValueError, match="int16 ADC overflow"):
            w.write_dump(big, dump_num=1)


class TestTriggerPipelineParity:
    def test_int16_equals_float32(self, dataset):
        from detprocess_jax.pipelines.triggers import TriggerProcessing

        dfs = {}
        for key in ("int_files", "float_files"):
            proc = TriggerProcessing(dataset[key], dataset["config_path"],
                                     filter_data=dataset["filter_path"],
                                     verbose=False)
            dfs[key] = proc.process(capacity=64)
        di, df_ = dfs["int_files"], dfs["float_files"]
        assert len(di) == len(df_) >= 3
        si = di.sort_values("trigger_index").reset_index(drop=True)
        sf = df_.sort_values("trigger_index").reset_index(drop=True)
        np.testing.assert_array_equal(si["trigger_index"],
                                      sf["trigger_index"])
        # conv factors are powers of two and the data exact codes, so the
        # device inputs are bit-identical → identical outputs
        np.testing.assert_array_equal(si["trigger_delta_chi2"],
                                      sf["trigger_delta_chi2"])
        np.testing.assert_array_equal(si["trigger_amplitude"],
                                      sf["trigger_amplitude"])

    def test_int16_over_device_mesh(self, dataset):
        # codes upload + device conversion under the event-sharded
        # shard_map path (conv [E, C] shards with the batch)
        import jax

        if len(jax.devices()) < 2:
            pytest.skip("needs the virtual multi-device CPU mesh")
        from detprocess_jax.parallel.mesh import make_mesh
        from detprocess_jax.pipelines.triggers import TriggerProcessing

        proc = TriggerProcessing(dataset["int_files"],
                                 dataset["config_path"],
                                 filter_data=dataset["filter_path"],
                                 verbose=False)
        ref = proc.process(capacity=64)
        dfm = proc.process(capacity=64, mesh=make_mesh())
        si = ref.sort_values("trigger_index").reset_index(drop=True)
        sm = dfm.sort_values("trigger_index").reset_index(drop=True)
        np.testing.assert_array_equal(si["trigger_index"],
                                      sm["trigger_index"])
        np.testing.assert_allclose(si["trigger_amplitude"],
                                   sm["trigger_amplitude"], rtol=1e-6)

    def test_salted_path_still_host_converts(self, dataset):
        from detprocess_jax.pipelines.triggers import TriggerProcessing

        proc = TriggerProcessing(dataset["int_files"],
                                 dataset["config_path"],
                                 filter_data=dataset["filter_path"],
                                 verbose=False)
        seen = {}

        def injector(traces, admin, **kw):
            # the injector must see float64 AMPS, not int16 codes
            seen["dtype"] = traces.dtype
            return traces

        proc.set_salting(injector)
        df = proc.process(capacity=64)
        assert seen["dtype"] == np.float64
        assert len(df) >= 3


class TestFeaturePipelineParity:
    @pytest.fixture(scope="class")
    def feature_dataset(self, tmp_path_factory):
        root = tmp_path_factory.mktemp("adcfeat")
        rng = np.random.default_rng(11)
        n, pre, nev = 2048, 1024, 12
        tmpl = pulse.make_template(FS, n, pre, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        codes = np.rint(rng.standard_normal((nev, 2, n)) * 30.0)
        for e in range(nev):
            for c in range(2):
                codes[e, c] += np.rint((2000.0 + 100 * e) * tmpl)
        codes = codes.astype(np.int16)
        amps = codes.astype(np.float64) * CONV[None, :, None]
        detcfg = {c: {"close_loop_norm": CLN[c], "tes_bias": 1e-7}
                  for c in CHANNELS}

        dirs = {}
        for key, cal in (("int16", CAL), ("float32", None)):
            d = root / key
            w = RawWriter(str(d), "I1_D20260816_T150000", FS, CHANNELS,
                          nb_pretrigger_samples=pre,
                          detector_config=detcfg,
                          adc_conversion_factor=cal)
            w.write_dump(amps, dump_num=1)
            dirs[key] = sorted(str(p) for p in d.glob("*.hdf5"))

        sigma_amps = 30.0 * CONV
        fd = FilterData(verbose=False)
        for i, chan in enumerate(CHANNELS):
            fd.set_template(chan, tmpl, FS, pretrigger_length_samples=pre)
            fd.set_psd(chan, np.full(n, sigma_amps[i] ** 2 / FS), FS)
        filter_path = str(root / "filter.h5")
        fd.save_hdf5(filter_path)

        config = {
            "filter_file": filter_path,
            "chan1": {"of1x1_nodelay": {"run": True},
                      "baseline": {"run": True}},
            "chan2": {"of1x1_nodelay": {"run": True}},
        }
        config_path = str(root / "feat.yaml")
        with open(config_path, "w") as fh:
            yaml.safe_dump(config, fh)
        return dict(dirs=dirs, config_path=config_path,
                    filter_path=filter_path, amps=amps)

    def test_int16_equals_float32(self, feature_dataset):
        from detprocess_jax.pipelines.features import FeatureProcessing

        out = {}
        for key, files in feature_dataset["dirs"].items():
            proc = FeatureProcessing(
                files, feature_dataset["config_path"],
                filter_data=feature_dataset["filter_path"], verbose=False)
            out[key] = proc.process(batch_size=4, dtype=np.float32)
        di, df_ = out["int16"], out["float32"]
        assert len(di) == len(df_) == 12
        for col in di.columns:
            if pd.api.types.is_float_dtype(di[col]):
                np.testing.assert_array_equal(
                    di[col].to_numpy(), df_[col].to_numpy(),
                    err_msg=f"column {col}")

    def test_float64_runs_keep_host_conversion(self, feature_dataset):
        # the golden-precision path must not switch to f32 device convert
        from detprocess_jax.pipelines.features import FeatureProcessing

        files = feature_dataset["dirs"]["int16"]
        proc = FeatureProcessing(
            files, feature_dataset["config_path"],
            filter_data=feature_dataset["filter_path"], verbose=False)
        df = proc.process(batch_size=4, dtype=np.float64)
        assert proc._raw_reads is False
        amp_cols = [c for c in df.columns if c.startswith("amp_")]
        assert amp_cols and np.isfinite(
            df[amp_cols[0]].to_numpy()).all()
