"""End-to-end trigger pipeline test: continuous raw data → trigger tables,
with cross-channel coincidence merging."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter, RawReader
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.triggers import EventBuilder, TriggerProcessing

FS = 1.25e6
NT = 1024
PRETRIG = 256
L = 60000
CHANNELS = ["chan1", "chan2"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("trig")
    rng = np.random.default_rng(42)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    sigma = np.sqrt(psd[0] * FS)

    # event 1: coincident pulses in both channels at 20000 (within window),
    #          isolated pulse in chan1 at 40000
    # event 2: isolated pulse in chan2 at 15000
    def continuous(positions_amps):
        tr = rng.standard_normal((len(CHANNELS), L)) * sigma
        for ch, pos, a in positions_amps:
            start = pos - PRETRIG
            tr[ch, start:start + NT] += a * tmpl
        return tr

    ev1 = continuous([(0, 20000, 20e-6), (1, 20010, 15e-6),
                      (0, 40000, 25e-6)])
    ev2 = continuous([(1, 15000, 30e-6)])
    traces = np.stack([ev1, ev2])

    raw_dir = root / "raw"
    writer = RawWriter(str(raw_dir), "I1_D20260816_T140000", FS, CHANNELS,
                       data_type="continuous")
    writer.write_dump(traces, dump_num=1)

    fd = FilterData(verbose=False)
    for chan in CHANNELS:
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(chan, psd, FS)
    filter_path = str(root / "filter.h5")
    fd.save_hdf5(filter_path)

    config = {
        "trigger": {
            "coincident_window_msec": 0.1,
            "chan1": {"run": True, "template_tag": "default",
                      "threshold_sigma": 8.0, "pileup_window_msec": 0.2},
            "chan2": {"run": True, "template_tag": "default",
                      "threshold_sigma": 8.0, "pileup_window_msec": 0.2},
        },
    }
    config_path = str(root / "trig.yaml")
    with open(config_path, "w") as fh:
        yaml.safe_dump(config, fh)
    raw_files = sorted(str(p) for p in raw_dir.glob("*.hdf5"))
    return dict(raw_files=raw_files, config_path=config_path,
                filter_path=filter_path)


def test_trigger_pipeline_finds_injected_pulses(dataset, tmp_path):
    proc = TriggerProcessing(dataset["raw_files"], dataset["config_path"],
                             filter_data=dataset["filter_path"],
                             verbose=False)
    assert proc.get_output_path() is None
    df = proc.process(capacity=256, lgc_save=True,
                      output_path=str(tmp_path / "out"))
    assert len(df) == 3  # coincidence merged into one + 2 isolated
    assert proc.get_output_path() == str(tmp_path / "out")

    idx = np.sort(df["trigger_index"].to_numpy())
    # merged coincidence keeps the primary (max Δχ² → chan1 at 20000)
    assert abs(idx[0] - 15000) <= 2
    assert abs(idx[1] - 20000) <= 2
    assert abs(idx[2] - 40000) <= 2

    # schema
    for col in ("trigger_index", "trigger_time", "trigger_delta_chi2",
                "trigger_amplitude", "trigger_threshold_sigma",
                "trigger_pileup_window", "trigger_type", "trigger_channel",
                "trigger_prod_id", "series_number", "event_number",
                "dump_number", "processing_id", "group_name"):
        assert col in df.columns, col
    assert (df["trigger_type"] == 4).all()

    # coincidence row carries both channels' suffixed amplitudes
    merged_row = df[np.abs(df["trigger_index"] - 20000) <= 2].iloc[0]
    assert merged_row["trigger_channel"] == "chan1"
    assert np.isfinite(merged_row["trigger_amplitude_chan1"])
    assert np.isfinite(merged_row["trigger_amplitude_chan2"])
    np.testing.assert_allclose(merged_row["trigger_amplitude_chan1"], 20e-6,
                               rtol=0.05)
    np.testing.assert_allclose(merged_row["trigger_amplitude_chan2"], 15e-6,
                               rtol=0.05)

    # trigger_prod_id strictly increasing across events
    ids = df["trigger_prod_id"].to_numpy()
    assert np.all(np.diff(np.sort(ids)) > 0)

    # output file written
    files = list((tmp_path / "out").glob("threshtrig_*.hdf5"))
    assert len(files) == 1


def test_event_builder_pileup_not_merged():
    """Two triggers in the SAME channel within the window stay separate
    (pileup, not coincidence — eventbuilder.py:391-393)."""
    builder = EventBuilder()
    df = pd.DataFrame({
        "trigger_index": [1000, 1050],
        "trigger_time": [1000 / FS, 1050 / FS],
        "trigger_delta_chi2": [500.0, 400.0],
        "trigger_channel": ["chan1", "chan1"],
        "trigger_amplitude_chan1": [1e-6, 2e-6],
    })
    builder.add_triggers(df)
    builder.set_current_nb_samples(L)
    out = builder.build_event({"event_time": 0.0}, fs=FS,
                              coincident_window_samples=100)
    assert len(out) == 2


def test_event_builder_mixed_split():
    """Mixed pileup + coincidence chains split into unique-channel groups
    (eventbuilder.py:399-442)."""
    builder = EventBuilder()
    df = pd.DataFrame({
        "trigger_index": [1000, 1020, 1040, 1060],
        "trigger_time": np.array([1000, 1020, 1040, 1060]) / FS,
        "trigger_delta_chi2": [500.0, 400.0, 600.0, 100.0],
        "trigger_channel": ["chan1", "chan2", "chan1", "chan2"],
        "trigger_amplitude_chan1": [1e-6, np.nan, 3e-6, np.nan],
        "trigger_amplitude_chan2": [np.nan, 2e-6, np.nan, 4e-6],
    })
    builder.add_triggers(df)
    builder.set_current_nb_samples(L)
    out = builder.build_event({"event_time": 0.0}, fs=FS,
                              coincident_window_samples=100)
    # (1000,1020) merge; (1040,1060) merge → 2 rows
    assert len(out) == 2
    assert set(out["trigger_index"]) == {1000, 1040}


def test_event_builder_rebuild_and_existing_columns():
    """build_event called twice on one builder, and trigger dataframes
    that already carry admin columns, must OVERWRITE metadata columns
    rather than duplicate them (reference overwrite semantics,
    eventbuilder.py:261-313; regression: pd.concat silently produced
    duplicate columns and a second build crashed on int(Series))."""
    builder = EventBuilder()
    df = pd.DataFrame({
        "trigger_index": [1000],
        "trigger_time": [1000 / FS],
        "trigger_delta_chi2": [500.0],
        "trigger_channel": ["chan1"],
        "trigger_amplitude_chan1": [1e-6],
        # admin column arriving WITH the trigger data
        "event_number": [77],
    })
    builder.add_triggers(df)
    builder.set_current_nb_samples(L)
    meta = {"event_time": 0.0, "event_number": 5, "series_number": 9}
    out1 = builder.build_event(meta, fs=FS)
    assert not out1.columns.duplicated().any()
    assert int(out1["event_number"].iloc[0]) == 5      # overwritten
    # rebuild on the same builder (e.g. after adding another channel)
    out2 = builder.build_event(meta, fs=FS)
    assert not out2.columns.duplicated().any()
    assert isinstance(out2["trigger_prod_id"].iloc[-1], (int, np.integer))


def test_nxm_compound_channel_trigger(dataset, tmp_path):
    """'chan1|chan2' trigger channel runs the NxM (2-channel) kernel with
    a CSD from the filter file (oftrigger.py NxM path)."""
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    fd = FilterData(verbose=False)
    # 2-channel single-template [C=2, M=1, N] + diagonal CSD
    fd.set_template("chan1|chan2", np.stack([tmpl, tmpl])[:, None, :], FS,
                    pretrigger_length_samples=PRETRIG)
    csd = np.zeros((2, 2, NT), complex)
    csd[0, 0] = psd
    csd[1, 1] = psd
    fd.set_csd(["chan1", "chan2"], csd, FS)
    for chan in CHANNELS:
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(chan, psd, FS)

    config = {"trigger": {
        "chan1|chan2": {"run": True, "template_tag": "default",
                        "threshold_sigma": 8.0,
                        "pileup_window_msec": 0.2}}}
    cpath = str(tmp_path / "nxm.yaml")
    yaml.safe_dump(config, open(cpath, "w"))
    proc = TriggerProcessing(dataset["raw_files"], cpath, filter_data=fd,
                             verbose=False)
    df = proc.process(capacity=64)
    idx = np.sort(df["trigger_index"].to_numpy())
    # the coincident 20000/20010 pair appears as one merged NxM trigger;
    # single-channel pulses at 40000 (chan1) and 15000 (chan2) still
    # trigger the joint filter
    assert len(df) == 3, df[["trigger_index", "trigger_channel"]]
    # single-channel pulses have lower joint-filter SNR -> a few samples
    # of timing jitter is expected physics
    assert abs(idx[0] - 15000) <= 6
    assert 20000 - 6 <= idx[1] <= 20010 + 6
    assert abs(idx[2] - 40000) <= 6
    assert (df["trigger_channel"] == "chan1|chan2").all()


def test_trigger_dumps_and_resume(dataset, tmp_path):
    """Periodic trigger dumps + resume: an interrupted run continued with
    resume=True yields the same triggers as one uninterrupted run."""
    from detprocess_jax.io import tables
    import glob

    out_full = str(tmp_path / "full")
    proc = TriggerProcessing(dataset["raw_files"], dataset["config_path"],
                             filter_data=dataset["filter_path"],
                             verbose=False)
    full = proc.process(capacity=64, lgc_save=True, output_path=out_full,
                        series_name="I1_D20260816_T220000",
                        event_batch=1, pipeline_depth=0,
                        nb_events_per_dump=1)
    files_full = sorted(glob.glob(out_full + "/*.hdf5"))
    assert len(files_full) == 2          # 2 continuous events, 1 per dump

    # interrupted: only the first continuous event
    out_res = str(tmp_path / "resumed")
    proc2 = TriggerProcessing(dataset["raw_files"], dataset["config_path"],
                              filter_data=dataset["filter_path"],
                              verbose=False)
    proc2.process(nevents=1, capacity=64, lgc_save=True,
                  output_path=out_res,
                  series_name="I1_D20260816_T220000",
                  event_batch=1, pipeline_depth=0,
                  nb_events_per_dump=1, lgc_output=False)
    assert len(glob.glob(out_res + "/*.hdf5")) == 1

    proc3 = TriggerProcessing(dataset["raw_files"], dataset["config_path"],
                              filter_data=dataset["filter_path"],
                              verbose=False)
    proc3.process(capacity=64, lgc_save=True, output_path=out_res,
                  resume=True, event_batch=1, pipeline_depth=0,
                  nb_events_per_dump=1, lgc_output=False)
    files_res = sorted(glob.glob(out_res + "/*.hdf5"))
    t_full = tables.concat_tables(files_full)
    t_res = tables.concat_tables(files_res)
    assert len(t_res) == len(t_full)
    np.testing.assert_array_equal(
        np.sort(t_res["trigger_index"].to_numpy()),
        np.sort(t_full["trigger_index"].to_numpy()))
    # resuming a complete run adds nothing
    proc4 = TriggerProcessing(dataset["raw_files"], dataset["config_path"],
                              filter_data=dataset["filter_path"],
                              verbose=False)
    proc4.process(capacity=64, lgc_save=True, output_path=out_res,
                  resume=True, event_batch=1, pipeline_depth=0,
                  nb_events_per_dump=1, lgc_output=False)
    assert sorted(glob.glob(out_res + "/*.hdf5")) == files_res


def test_dynamic_threshold_pipeline(tmp_path):
    """set_dynamic_threshold routes the pipeline through the device
    dynamic-window kernel: a wide-merging window function fuses a pulse
    pair that the static window keeps separate."""
    import yaml as _yaml

    rng = np.random.default_rng(9)
    l = 200_000
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((1, 1, l)) * sigma
    # pulse pair 4000 samples apart: the above-threshold clusters
    # (±~700 samples at this SNR) stay separated under the static
    # 0.5 ms window (625 samples) but merge under the dynamic one below
    for pos in (60_000, 64_000):
        traces[0, 0, pos - PRETRIG:pos - PRETRIG + NT] += 40e-6 * tmpl
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260816_T300000", FS,
                  ["chan1"])
    w.write_dump(traces, dump_num=1)
    raw_files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))

    fd = FilterData(verbose=False)
    psd = np.full(NT, sigma**2 / FS)
    fd.set_psd("chan1", psd, FS)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)

    config = {"trigger": {"chan1": {
        "run": True, "template_tag": "default", "threshold_sigma": 8.0,
        "pileup_window_msec": 0.5}}}
    cpath = tmp_path / "cfg.yaml"
    _yaml.safe_dump(config, open(cpath, "w"))

    # static window: two triggers
    proc = TriggerProcessing(raw_files, str(cpath), filter_data=fd,
                             verbose=False)
    df_static = proc.process()
    near = df_static[(df_static["trigger_index"] > 55_000)
                     & (df_static["trigger_index"] < 65_000)]
    assert len(near) == 2

    # dynamic window grows with the group maximum: one merged trigger
    proc2 = TriggerProcessing(raw_files, str(cpath), filter_data=fd,
                              verbose=False)
    proc2.set_dynamic_threshold(
        "chan1", lambda m: jnp.where(m > 1000.0, 6000.0, 200.0))
    df_dyn = proc2.process()
    near = df_dyn[(df_dyn["trigger_index"] > 55_000)
                  & (df_dyn["trigger_index"] < 65_000)]
    assert len(near) == 1

    # the compiled-fn cache must key on the function OBJECT (holding a
    # strong reference), not id(): a replacement fn allocated at a
    # garbage-collected predecessor's address would otherwise silently
    # reuse the stale compiled trigger logic
    fn2 = proc2._channels[0].dynamic_threshold_function
    assert any(fn2 in key for key in proc2._fn_cache)


def test_job_summary_written(tmp_path):
    import glob
    import json

    rng = np.random.default_rng(5)
    l = 100_000
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((1, 1, l)) * sigma
    traces[0, 0, 50_000 - PRETRIG:50_000 - PRETRIG + NT] += 40e-6 * tmpl
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260816_T310000", FS,
                  ["chan1"])
    w.write_dump(traces, dump_num=1)
    raw_files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))

    fd = FilterData(verbose=False)
    fd.set_psd("chan1", np.full(NT, sigma**2 / FS), FS)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    config = {"trigger": {"chan1": {"run": True,
                                    "template_tag": "default",
                                    "threshold_sigma": 8.0,
                                    "pileup_window_msec": 0.5}}}
    cpath = tmp_path / "cfg.yaml"
    yaml.safe_dump(config, open(cpath, "w"))

    out = tmp_path / "out"
    proc = TriggerProcessing(raw_files, str(cpath), filter_data=fd,
                             processing_id="testrun", verbose=False)
    df = proc.process(lgc_save=True, output_path=str(out))

    summaries = glob.glob(str(out / "*_summary.json"))
    assert len(summaries) == 1
    s = json.load(open(summaries[0]))
    assert s["workload"] == "trigger"
    assert s["continuous_events"] == 1
    assert s["triggers"] == len(df) == 1
    assert s["wall_sec"] > 0 and s["livetime_sec"] > 0
    assert s["processing_id"] == "testrun"
    assert len(s["config_digest"]) == 12
