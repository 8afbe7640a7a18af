"""End-to-end feature pipeline test: raw HDF5 + YAML + filter file → table.

Exercises the full chain the reference drives via
FeatureProcessing.process() (detprocess/process/features.py): synthetic
pytesdaq-format raw files, a YAML processing config with several algorithms
and channel combinations, a filter file with templates/PSDs/CSD, batched
device execution, and output tables.
"""

import os

import numpy as np
import pandas as pd
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawReader, RawWriter, RawData
from detprocess_jax.io import tables
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.features import FeatureProcessing

from reference_impl import RefOF1x1, generate_noise

FS = 1.25e6
N = 4096
PRETRIG = 2048
CHANNELS = ["chan1", "chan2"]
NB_EVENTS = 24


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Synthetic raw data + filter file + YAML config."""
    root = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(123)

    tmpl1 = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                tau_f1=200e-6)
    tmpl2 = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=15e-6,
                                tau_f1=120e-6)
    f = np.abs(np.fft.fftfreq(N, 1 / FS))
    f[0] = f[1]
    psd1 = 1e-20 * (1 + 50 / f)
    psd2 = 2e-20 * np.ones(N)

    # raw traces with injected pulses in both channels
    amps = rng.uniform(1e-6, 4e-6, (NB_EVENTS, 2))
    noise1 = generate_noise(psd1, FS, NB_EVENTS, rng)
    noise2 = generate_noise(psd2, FS, NB_EVENTS, rng)
    traces = np.stack([noise1 + amps[:, :1] * tmpl1,
                       noise2 + amps[:, 1:] * tmpl2], axis=1)

    raw_dir = root / "raw"
    writer = RawWriter(str(raw_dir), "I1_D20260816_T120000", FS, CHANNELS,
                       detector_config={
                           "chan1": {"tes_bias": 1e-7, "output_gain": 10.0},
                           "chan2": {"tes_bias": 2e-7, "output_gain": 10.0}})
    writer.write_dump(traces[:NB_EVENTS // 2], dump_num=1)
    writer.write_dump(traces[NB_EVENTS // 2:], dump_num=2)

    # filter file
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl1, FS, pretrigger_length_samples=PRETRIG)
    fd.set_template("chan2", tmpl2, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", psd1, FS)
    fd.set_psd("chan2", psd2, FS)
    # 2-channel CSD for the NxM algorithm (diagonal: independent noise)
    csd = np.zeros((2, 2, N), dtype=complex)
    csd[0, 0] = psd1
    csd[1, 1] = psd2
    fd.set_csd("chan1|chan2", csd, FS)
    tmpl_nxm = np.zeros((2, 2, N))
    tmpl_nxm[0, 0] = tmpl1
    tmpl_nxm[1, 1] = tmpl2
    fd.set_template("chan1|chan2", tmpl_nxm, FS,
                    pretrigger_length_samples=PRETRIG)
    filter_path = str(root / "filter.h5")
    fd.save_hdf5(filter_path)

    config = {
        "filter_file": filter_path,
        "chan1": {
            "of1x1_nodelay": {"run": True, "template_tag": "default"},
            "of1x1_unconstrained": {"run": True, "template_tag": "default"},
            "of1x1_constrained": {"run": True, "template_tag": "default",
                                  "window_min_from_trig_usec": -100.0,
                                  "window_max_from_trig_usec": 100.0},
            "baseline": {"run": True,
                         "window_min_from_start_usec": 0.0,
                         "window_max_from_trig_usec": -200.0},
            "integral": {"run": True},
            "maximum": {"run": True},
        },
        "chan2": {
            "of1x1_nodelay": {"run": True, "template_tag": "default"},
            "minimum": {"run": True},
            "psd_amp": {"run": True, "f_lims": [[1000.0, 10000.0]]},
        },
        "chan1+chan2": {
            "baseline": {"run": True,
                         "base_algorithm": "baseline"},
        },
        "chan1|chan2": {
            "ofnxm": {"run": True, "template_tag": "default"},
            # narrow window → exercises the direct windowed DFT-matmul
            # dispatch (ofnxm_withdelay_direct)
            "ofnxm_win": {"run": True, "base_algorithm": "ofnxm",
                          "template_tag": "default",
                          "window_min_from_trig_usec": -40.0,
                          "window_max_from_trig_usec": 40.0},
        },
    }
    config_path = str(root / "process.yaml")
    with open(config_path, "w") as fh:
        yaml.safe_dump(config, fh)

    raw_files = sorted(str(p) for p in raw_dir.glob("*.hdf5"))
    # compare against the traces as stored (the writer stores float32, as
    # real ADC data carries no more precision)
    stored, _ = RawReader(raw_files).read_many_events()
    return dict(root=root, raw_files=raw_files, config_path=config_path,
                filter_path=filter_path, traces=stored, amps=amps,
                tmpl1=tmpl1, tmpl2=tmpl2, psd1=psd1, psd2=psd2)


@pytest.fixture(scope="module")
def result(dataset):
    proc = FeatureProcessing(dataset["raw_files"], dataset["config_path"],
                             filter_data=dataset["filter_path"],
                             verbose=False)
    df = proc.process(batch_size=8, dtype=np.float64)
    return proc, df


def test_rawdata_roundtrip(dataset):
    reader = RawReader(dataset["raw_files"])
    assert reader.sample_rate == FS
    assert reader.channels == CHANNELS
    assert reader.total_events() == NB_EVENTS
    tr, admin = reader.read_next_event()
    np.testing.assert_allclose(tr, dataset["traces"][0], rtol=1e-6)
    assert admin["series_name"] == "I1_D20260816_T120000"
    assert admin["dump_number"] == 1

    # directory scan + classification
    rd = RawData(os.path.dirname(dataset["raw_files"][0]))
    assert rd.get_series_list() == ["I1_D20260816_T120000"]
    dur, nev = rd.get_duration(include_nb_events=True)
    assert nev == NB_EVENTS
    np.testing.assert_allclose(dur, NB_EVENTS * N / FS)


def test_feature_columns_and_naming(result):
    _, df = result
    assert len(df) == NB_EVENTS
    expected = [
        "amp_of1x1_nodelay_chan1", "chi2_of1x1_nodelay_chan1",
        "lowchi2_of1x1_nodelay_chan1",
        "amp_of1x1_unconstrained_chan1", "t0_of1x1_unconstrained_chan1",
        "amp_of1x1_constrained_chan1", "ampres_of1x1_constrained_chan1",
        "timeres_of1x1_constrained_chan1",
        "chi2nopulse_of1x1_constrained_chan1",
        "baseline_chan1", "integral_chan1", "maximum_chan1",
        "amp_of1x1_nodelay_chan2", "minimum_chan2",
        "psd_amp_1000_10000_chan2",
        "baseline_chan1+chan2",
        "amp1_ofnxm_nodelay_chan1|chan2",
        "amp2_ofnxm_constrained_chan1|chan2",
        "chi2_ofnxm_nodelay_chan1|chan2",
        # admin
        "event_number", "series_number", "dump_number", "event_time",
        "processing_id", "group_name", "trigger_type",
        "tes_bias_chan1", "output_gain_chan2",
    ]
    for col in expected:
        assert col in df.columns, f"missing column {col}"


def test_of1x1_features_match_reference(dataset, result):
    _, df = result
    ref = RefOF1x1(dataset["tmpl1"], dataset["psd1"], FS, PRETRIG)
    for i in range(NB_EVENTS):
        amp, chi2, lowchi2 = ref.fit_nodelay(dataset["traces"][i, 0],
                                             lowchi2_fcutoff=10000.0)
        np.testing.assert_allclose(df["amp_of1x1_nodelay_chan1"][i], amp,
                                   rtol=1e-8)
        np.testing.assert_allclose(df["chi2_of1x1_nodelay_chan1"][i], chi2,
                                   rtol=1e-8)
        np.testing.assert_allclose(df["lowchi2_of1x1_nodelay_chan1"][i],
                                   lowchi2, rtol=1e-8)
        ampd, t0d, chi2d, _ = ref.fit_withdelay(dataset["traces"][i, 0])
        np.testing.assert_allclose(df["amp_of1x1_unconstrained_chan1"][i],
                                   ampd, rtol=1e-8)
        np.testing.assert_allclose(df["t0_of1x1_unconstrained_chan1"][i],
                                   t0d, atol=1e-12)
        # constrained window ±100 usec = ±125 samples
        w = (PRETRIG - 125, PRETRIG + 125)
        ampc, t0c, chi2c, _ = ref.fit_withdelay(dataset["traces"][i, 0],
                                                window=w)
        np.testing.assert_allclose(df["amp_of1x1_constrained_chan1"][i],
                                   ampc, rtol=1e-8)


def test_trace_features_match_numpy(dataset, result):
    _, df = result
    traces = dataset["traces"]
    # integral with default window [0, N-1)
    expected_int = np.trapezoid(traces[:, 0, 0:N - 1], axis=-1) / FS
    np.testing.assert_allclose(df["integral_chan1"], expected_int, rtol=1e-8)
    np.testing.assert_allclose(df["maximum_chan1"],
                               np.max(traces[:, 0, 0:N - 1], axis=-1),
                               rtol=1e-8)
    np.testing.assert_allclose(df["minimum_chan2"],
                               np.min(traces[:, 1, 0:N - 1], axis=-1),
                               rtol=1e-8)
    # compound channel baseline: chan1 + chan2 summed trace
    summed = traces[:, 0] + traces[:, 1]
    np.testing.assert_allclose(df["baseline_chan1+chan2"],
                               np.mean(summed[:, 0:N - 1], axis=-1),
                               rtol=1e-8)


def test_amplitude_recovery(dataset, result):
    _, df = result
    amps = dataset["amps"]
    rec = df["amp_of1x1_nodelay_chan1"].to_numpy()
    assert np.all(np.abs(rec - amps[:, 0]) < 5e-8)
    rec2 = df["amp_of1x1_nodelay_chan2"].to_numpy()
    assert np.all(np.abs(rec2 - amps[:, 1]) < 5e-8)
    # NxM amplitudes recover both channels
    a1 = df["amp1_ofnxm_nodelay_chan1|chan2"].to_numpy()
    a2 = df["amp2_ofnxm_nodelay_chan1|chan2"].to_numpy()
    assert np.all(np.abs(a1 - amps[:, 0]) < 1e-7)
    assert np.all(np.abs(a2 - amps[:, 1]) < 1e-7)
    # windowed NxM (direct DFT-matmul dispatch): pulses are at the
    # pretrigger, inside the ±40 µs window → same recovery, t0 in window
    w1 = df["amp1_ofnxm_win_constrained_chan1|chan2"].to_numpy()
    w2 = df["amp2_ofnxm_win_constrained_chan1|chan2"].to_numpy()
    assert np.all(np.abs(w1 - amps[:, 0]) < 1e-7)
    assert np.all(np.abs(w2 - amps[:, 1]) < 1e-7)
    t0w = df["t0_ofnxm_win_constrained_chan1|chan2"].to_numpy()
    assert np.all(np.abs(t0w) <= 40e-6 + 1e-12)


def test_table_output_roundtrip(dataset, result, tmp_path):
    proc, df = result
    # re-run with save enabled
    proc2 = FeatureProcessing(dataset["raw_files"], dataset["config_path"],
                              filter_data=dataset["filter_path"],
                              verbose=False)
    out_dir = tmp_path / "out"
    df2 = proc2.process(batch_size=100, dtype=np.float64, lgc_save=True,
                        output_path=str(out_dir), series_name="I1_D20260816_T130000")
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".hdf5"))
    assert len(files) == 1 and files[0].startswith("feature_")
    back = tables.read_table(str(out_dir / files[0]))
    assert len(back) == NB_EVENTS
    np.testing.assert_allclose(back["amp_of1x1_nodelay_chan1"],
                               df["amp_of1x1_nodelay_chan1"], rtol=1e-12)


def test_batch_invariance(dataset):
    """Results must not depend on batch size (the reference's implicit
    worker-split invariance, SURVEY.md §4)."""
    p1 = FeatureProcessing(dataset["raw_files"], dataset["config_path"],
                           filter_data=dataset["filter_path"], verbose=False)
    d1 = p1.process(batch_size=5, dtype=np.float64)
    p2 = FeatureProcessing(dataset["raw_files"], dataset["config_path"],
                           filter_data=dataset["filter_path"], verbose=False)
    d2 = p2.process(batch_size=24, dtype=np.float64)
    for col in d1.columns:
        if d1[col].dtype.kind == "f":
            np.testing.assert_allclose(d1[col], d2[col], rtol=1e-12,
                                       err_msg=col)


def test_resume_from_dumps(dataset, tmp_path):
    """resume=True continues after existing dumps: identical table to a
    single uninterrupted run, no duplicated events."""
    from detprocess_jax.io import tables
    import glob

    out1 = str(tmp_path / "full")
    proc = FeatureProcessing(dataset["raw_files"],
                             dataset["config_path"],
                             filter_data=dataset["filter_path"],
                             verbose=False)
    full = proc.process(batch_size=4, lgc_save=True, output_path=out1,
                        series_name="I1_D20260816_T200000")

    # interrupted run: only the first 4 events (1 dump), then resume
    out2 = str(tmp_path / "resumed")
    proc2 = FeatureProcessing(dataset["raw_files"],
                              dataset["config_path"],
                              filter_data=dataset["filter_path"],
                              verbose=False)
    proc2.process(nevents=4, batch_size=4, lgc_save=True, output_path=out2,
                  series_name="I1_D20260816_T200000", lgc_output=False)
    assert len(glob.glob(out2 + "/*.hdf5")) == 1

    proc3 = FeatureProcessing(dataset["raw_files"],
                              dataset["config_path"],
                              filter_data=dataset["filter_path"],
                              verbose=False)
    proc3.process(batch_size=4, lgc_save=True, output_path=out2,
                  resume=True, lgc_output=False)

    files1 = sorted(glob.glob(out1 + "/*.hdf5"))
    files2 = sorted(glob.glob(out2 + "/*.hdf5"))
    t_full = tables.concat_tables(files1).sort_values(
        "event_number", ignore_index=True)
    t_res = tables.concat_tables(files2).sort_values(
        "event_number", ignore_index=True)
    assert len(t_res) == len(t_full)
    assert list(t_res["event_number"]) == list(t_full["event_number"])
    amp_cols = [c for c in t_full.columns if c.startswith("amp_")]
    for c in amp_cols:
        np.testing.assert_allclose(t_res[c].to_numpy(),
                                   t_full[c].to_numpy(), rtol=1e-6)


def test_nb_events_per_dump(dataset, tmp_path):
    """Dump files contain nb_events_per_dump rows regardless of batch
    size (reference features.py:593-626 semantics)."""
    from detprocess_jax.io import tables
    import glob

    out = str(tmp_path / "dumps")
    proc = FeatureProcessing(dataset["raw_files"], dataset["config_path"],
                             filter_data=dataset["filter_path"],
                             verbose=False)
    proc.process(batch_size=3, nb_events_per_dump=6, lgc_save=True,
                 output_path=out, lgc_output=False,
                 series_name="I1_D20260816_T210000")
    files = sorted(glob.glob(out + "/*.hdf5"))
    counts = [tables.count_rows(f) for f in files]
    assert all(c >= 6 for c in counts[:-1])          # full dumps
    assert sum(counts) == 24                         # fixture total


def test_memory_limit_dumping(dataset, tmp_path):
    """memory_limit flushes dumps when the pending frames exceed the
    byte budget (reference features.py:283-380 semantics)."""
    from detprocess_jax.io import tables
    import glob

    out = str(tmp_path / "mem")
    proc = FeatureProcessing(dataset["raw_files"], dataset["config_path"],
                             filter_data=dataset["filter_path"],
                             verbose=False)
    proc.process(batch_size=2, memory_limit="1KB", lgc_save=True,
                 output_path=out, lgc_output=False,
                 series_name="I1_D20260816_T230500")
    files = sorted(glob.glob(out + "/*.hdf5"))
    assert len(files) >= 2
    assert sum(tables.count_rows(f) for f in files) == 24


def test_processing_data_accessors(dataset, result):
    # the reference's ProcessingData accessor tail
    # (processing_data.py:130, :500, :1207-1279) lives on the pipeline
    proc, _ = result
    import os

    assert proc.get_sample_rate() == FS
    assert proc.get_nb_samples() == N
    assert proc.get_nb_pretrigger_samples() == PRETRIG
    assert proc.get_filter_data_inst() is not None
    assert proc.get_raw_path() == os.path.dirname(
        os.path.abspath(dataset["raw_files"][0]))


def test_feature_job_summary_written(tmp_path, dataset):
    import glob
    import json

    out = tmp_path / "out"
    proc = FeatureProcessing(dataset["raw_files"], dataset["config_path"],
                             filter_data=dataset["filter_path"],
                             verbose=False)
    proc.process(batch_size=4, lgc_save=True, output_path=str(out))
    summaries = glob.glob(str(out / "*_summary.json"))
    assert len(summaries) == 1
    s = json.load(open(summaries[0]))
    assert s["workload"] == "feature"
    assert s["events"] > 0 and s["wall_sec"] > 0
    assert s["trigger_driven"] is False
    assert len(s["config_digest"]) == 12
