"""Parallel host feeding + async table writes (round-4 VERDICT item 3).

The reference's only intra-job parallelism is ``Pool.starmap`` over
series (process/features.py:391-420, process/triggers.py:337-377).
This package feeds ONE device pipeline from N concurrent reader
threads instead: ``RawReader.split`` + ``ParallelEventPrefetcher``
(full-trace mode, unordered) and ``OrderedChunkPrefetcher`` (windowed
trigger-df mode, order-preserving). These tests pin the equality
contract: the processed event/row SET is identical to the serial run.
"""

import os
import threading

import numpy as np
import pandas as pd
import pytest
import yaml

from detprocess_jax.io import tables
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.prefetch import (OrderedChunkPrefetcher,
                                        ParallelEventPrefetcher,
                                        prefetch_events)
from detprocess_jax.io.rawdata import RawReader, RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.utils.logging import StageTimer

FS = 1.25e6


def _write_series(tmp_path, series, nev=3, nsamp=8192, nchan=1, seed=0):
    rng = np.random.default_rng(seed)
    w = RawWriter(str(tmp_path / "raw"), series, FS,
                  [f"chan{i+1}" for i in range(nchan)],
                  data_type="continuous")
    traces = rng.standard_normal((nev, nchan, nsamp)) * 1e-9
    w.write_dump(traces, dump_num=1)
    return sorted(str(p) for p in (tmp_path / "raw").glob(f"*{series}*"))


def test_rawreader_split_covers_all_files(tmp_path):
    files = []
    for i in range(5):
        files += _write_series(tmp_path, f"I1_D20260820_T10000{i}",
                               seed=i)
    reader = RawReader(files)
    for n in (1, 2, 3, 5, 8):
        parts = reader.split(n)
        assert len(parts) == min(n, len(files))
        got = sorted(f for p in parts for f in p.files)
        assert got == sorted(files)          # disjoint and complete
        assert sum(len(p.files) for p in parts) == len(files)


def test_parallel_prefetcher_same_event_set(tmp_path):
    files = []
    for i in range(4):
        files += _write_series(tmp_path, f"I1_D20260820_T11000{i}",
                               nev=4, seed=10 + i)

    def collect(source):
        out = {}
        for traces, admin in source:
            key = (admin["series_number"], admin["event_number"])
            assert key not in out
            out[key] = np.asarray(traces).sum()
        return out

    serial = collect(prefetch_events(RawReader(files), depth=8))
    for n in (2, 3):
        par = ParallelEventPrefetcher(RawReader(files).split(n), depth=8)
        got = collect(par)
        assert got.keys() == serial.keys()
        for k in serial:
            assert got[k] == serial[k]


def test_parallel_prefetcher_propagates_reader_error(tmp_path):
    files = _write_series(tmp_path, "I1_D20260820_T120000", nev=2)

    class Boom:
        def read_next_event(self, channels=None, **kw):
            raise RuntimeError("disk on fire")

    pf = ParallelEventPrefetcher([Boom(), RawReader(files)], depth=4)
    with pytest.raises(RuntimeError, match="disk on fire"):
        for _ in pf:
            pass
    pf.close()


def test_ordered_chunk_prefetcher_preserves_order():
    chunks = list(range(23))

    def work(state, chunk):
        # stagger to force out-of-order completion across workers
        import time
        time.sleep(0.001 * ((chunk * 7) % 5))
        return (state, chunk * chunk)

    for n in (1, 2, 4):
        pf = OrderedChunkPrefetcher(work, chunks, list(range(n)), depth=2)
        got = list(pf)
        assert [c for _, c in got] == [c * c for c in chunks]
        # chunk i ran on worker i % n (round-robin assignment)
        assert [w for w, _ in got] == [i % n for i in chunks]


def test_ordered_chunk_prefetcher_propagates_error():
    def work(state, chunk):
        if chunk == 5:
            raise ValueError("bad chunk")
        return chunk

    pf = OrderedChunkPrefetcher(work, list(range(10)), [0, 1], depth=2)
    with pytest.raises(ValueError, match="bad chunk"):
        list(pf)


def test_async_writer_roundtrip_and_error(tmp_path):
    w = tables.AsyncWriter()
    df = pd.DataFrame({"x": np.arange(5), "y": np.linspace(0, 1, 5)})
    path = str(tmp_path / "out.hdf5")
    w.write(df, path, fmt="hdf5")
    w.close()
    back = tables.read_table(path)
    assert np.array_equal(back["x"], df["x"])

    w = tables.AsyncWriter()
    w.write(df, str(tmp_path / "no_such_dir" / "f.hdf5"), fmt="hdf5")
    with pytest.raises(Exception):
        w.close()


@pytest.fixture(scope="module")
def trigger_setup(tmp_path_factory):
    """3-series continuous dataset + filter data + trigger yaml."""
    tmp_path = tmp_path_factory.mktemp("parhost")
    nt, pre = 512, 128
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 1e-9
    files = []
    rng = np.random.default_rng(3)
    for i in range(3):
        series = f"I1_D20260820_T13000{i}"
        w = RawWriter(str(tmp_path / "raw"), series, FS, ["chan1"],
                      data_type="continuous")
        traces = rng.standard_normal((2, 1, 50_000)) * sigma
        for ev in range(2):
            for p in (9000, 21000, 33000):
                traces[ev, 0, p - pre:p - pre + nt] += 50e-9 * tmpl
        w.write_dump(traces, dump_num=1)
        files += sorted(str(p) for p in (tmp_path / "raw").glob(
            f"*{series}*"))
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=pre)
    fd.set_psd("chan1", np.full(nt, sigma**2 / FS), FS)
    cfg = {"trigger": {"chan1": {"run": True, "template_tag": "default",
                                 "threshold_sigma": 8.0,
                                 "pileup_window_msec": 0.2}}}
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump(cfg, open(cpath, "w"))
    return tmp_path, sorted(files), cpath, fd, nt, pre


def test_trigger_pipeline_nreaders_equal(trigger_setup):
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    tmp_path, files, cpath, fd, nt, pre = trigger_setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    df1 = tp.process(capacity=64)
    df3 = tp.process(capacity=64, nreaders=3)
    key = ["series_number", "event_number", "trigger_index"]
    a = df1.sort_values(key, ignore_index=True)
    b = df3.sort_values(key, ignore_index=True)
    assert len(a) == len(b) and len(a) > 0
    for col in ("trigger_index", "trigger_delta_chi2",
                "trigger_amplitude"):
        assert np.allclose(np.asarray(a[col], float),
                           np.asarray(b[col], float)), col


def test_trigger_nreaders_rejects_partial_runs(trigger_setup):
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    tmp_path, files, cpath, fd, nt, pre = trigger_setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    with pytest.raises(ValueError, match="nreaders"):
        tp.process(nevents=2, nreaders=2)
    with pytest.raises(ValueError, match="nreaders"):
        tp.process(nreaders=2, resume=True, lgc_save=True,
                   output_path=str(tmp_path / "nope"))


def test_feature_windowed_nreaders_identical(trigger_setup):
    from detprocess_jax.pipelines.features import FeatureProcessing
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    tmp_path, files, cpath, fd, nt, pre = trigger_setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    trig_df = tp.process(capacity=64)
    fcfg = {"feature": {"chan1": {"of1x1_nodelay": {"run": True},
                                  "baseline": {"run": True}}},
            "global": {"trace_length_samples": nt,
                       "pretrigger_length_samples": pre}}
    fpath = str(tmp_path / "f.yaml")
    yaml.safe_dump(fcfg, open(fpath, "w"))
    fp = FeatureProcessing(files, fpath, filter_data=fd,
                           trigger_dataframe=trig_df, verbose=False)
    df1 = fp.process(batch_size=7)                  # uneven chunks
    df3 = fp.process(batch_size=7, nreaders=3)
    # windowed mode preserves ROW ORDER exactly — frame equality, not
    # just set equality
    assert len(df1) == len(df3) and len(df1) > 0
    for col in df1.columns:
        a, b = df1[col], df3[col]
        try:
            af, bf = np.asarray(a, float), np.asarray(b, float)
        except (ValueError, TypeError):
            assert list(a) == list(b), col      # string columns
        else:
            assert np.allclose(af, bf, equal_nan=True), col


def test_stage_timer_reports_split(trigger_setup):
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    tmp_path, files, cpath, fd, nt, pre = trigger_setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    timer = StageTimer()
    tp.process(capacity=64, timer=timer)
    report = timer.report(log=False)
    assert {"read", "dispatch", "drain"} <= set(report)
    assert all(v["seconds"] >= 0 for v in report.values())


def test_trigger_async_dump_writes_land(trigger_setup, tmp_path):
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    _, files, cpath, fd, nt, pre = trigger_setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    out = str(tmp_path / "dumps")
    df = tp.process(capacity=64, lgc_save=True, output_path=out,
                    nb_events_per_dump=2, event_batch=2,
                    pipeline_depth=0)
    dumps = sorted(p for p in os.listdir(out) if p.endswith(".hdf5")
                   and "job_summary" not in p)
    assert len(dumps) >= 2                    # periodic dumps written
    rows = sum(len(tables.read_table(os.path.join(out, p)))
               for p in dumps)
    assert rows == len(df)


def test_windowed_read_coalescing_identical(tmp_path):
    """Dense windows coalesce into one full-event read + host slicing
    (_read_row_chunk, COALESCE_FRACTION); traces and admins must equal
    the per-window pread path exactly."""
    from detprocess_jax.pipelines.features import FeatureProcessing

    nt, pre = 512, 128
    L = 50_000
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T160000", FS,
                  ["chan1"],
                  detector_config={"chan1": {"close_loop_norm": 1.0}},
                  adc_conversion_factor=2e-9)
    rng = np.random.default_rng(11)
    w.write_dump(rng.standard_normal((2, 1, L)) * 1e-9, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=pre)
    fd.set_psd("chan1", np.full(nt, 1e-18), FS)
    cpath = str(tmp_path / "f.yaml")
    yaml.safe_dump({"feature": {"chan1": {"of1x1_nodelay": {"run": True}}},
                    "global": {"trace_length_samples": nt,
                               "pretrigger_length_samples": pre}},
                   open(cpath, "w"))
    md = RawReader(files).get_metadata(files[0])
    # 120 windows x 512 samples over a 50k trace: dense — coalesces
    idx, evs = [], []
    for ev in (1, 2):
        idx.extend(np.sort(rng.integers(pre + 1, L - nt, 120)))
        evs.extend([ev] * 120)
    rows = pd.DataFrame({"trigger_index": idx, "event_number": evs,
                         "series_number": md["series_num"],
                         "dump_number": 1})
    fp = FeatureProcessing(files, cpath, filter_data=fd,
                           trigger_dataframe=rows, verbose=False)
    fp._raw_reads = True
    recs = rows.to_dict("records")
    assert 240 * nt >= fp.COALESCE_FRACTION * L        # engages
    st_co, ad_co, nd_co = fp._read_row_chunk(fp._reader, recs)
    try:
        fp.COALESCE_FRACTION = 1e9                     # force per-window
        st_pw, ad_pw, nd_pw = fp._read_row_chunk(fp._reader, recs)
    finally:
        del fp.COALESCE_FRACTION                       # restore class attr
    assert nd_co == nd_pw == 0
    assert st_co.dtype == st_pw.dtype == np.int16      # raw codes kept
    assert np.array_equal(st_co, st_pw)
    assert ad_co is not None and len(ad_co) == len(ad_pw)
    for a, b in zip(ad_co, ad_pw):
        assert set(a) == set(b)
        for k in a:
            va, vb = a[k], b[k]
            if isinstance(va, np.ndarray):
                assert np.array_equal(va, vb), k
            else:
                assert va == vb, k


def test_channel_subset_upload_identical(tmp_path):
    """Trigger configs using a channel subset read+upload only those
    channels; outputs must equal the full-stack path exactly."""
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    nt, pre = 512, 128
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    rng = np.random.default_rng(21)
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T200000", FS,
                  ["chan1", "chan2", "chan3"], data_type="continuous",
                  detector_config={c: {"close_loop_norm": 2.0}
                                   for c in ("chan1", "chan2", "chan3")},
                  adc_conversion_factor=2e-9)
    traces = rng.standard_normal((2, 3, 50_000)) * 1e-9
    for ev in range(2):
        for p in (9000, 21000, 33000):
            traces[ev, 1, p - pre:p - pre + nt] += 50e-9 * tmpl
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    fd.set_template("chan2", tmpl, FS, pretrigger_length_samples=pre)
    fd.set_psd("chan2", np.full(nt, 1e-9**2 / FS), FS)
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump({"trigger": {"chan2": {
        "run": True, "template_tag": "default", "threshold_sigma": 8.0,
        "pileup_window_msec": 0.2}}}, open(cpath, "w"))
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    assert tp.CHANNEL_SUBSET_UPLOAD
    df_sub = tp.process(capacity=64)
    try:
        tp.CHANNEL_SUBSET_UPLOAD = False        # instance shadow
        df_full = tp.process(capacity=64)
    finally:
        del tp.CHANNEL_SUBSET_UPLOAD
    assert len(df_sub) == len(df_full) > 0
    for col in ("trigger_index", "trigger_delta_chi2",
                "trigger_amplitude"):
        assert np.allclose(np.asarray(df_sub[col], float),
                           np.asarray(df_full[col], float)), col


def _expand_to_full_stack(fp):
    """A/B harness: undo a feature pipeline's channel subsetting (lift
    mix matrices back onto the full raw axis, recompile)."""
    if fp._read_channel_idx is None:
        return fp
    idx = fp._read_channel_idx
    for g in fp._groups:
        if g.mix_matrix is not None and g.mix_matrix.size:
            full = np.zeros((g.mix_matrix.shape[0],
                             len(fp._available_channels)))
            full[:, idx] = g.mix_matrix
            g.mix_matrix = full
    fp._read_channel_idx = None
    fp._read_channels = None
    fp._compile()
    return fp


def _feature_subset_fixture(tmp_path, *, adc=True):
    from detprocess_jax.pipelines.features import FeatureProcessing

    nt, pre = 512, 128
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    rng = np.random.default_rng(31)
    kw = {}
    if adc:
        kw = dict(detector_config={c: {"close_loop_norm": 1.5 + i}
                                   for i, c in enumerate(
                                       ["chan1", "chan2", "chan3"])},
                  adc_conversion_factor=2e-9)
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T220000", FS,
                  ["chan1", "chan2", "chan3"], data_type="continuous",
                  nb_pretrigger_samples=pre, **kw)
    traces = rng.standard_normal((4, 3, nt)) * 1e-9
    traces[:, 1] += 40e-9 * tmpl
    traces[:, 2] += 20e-9 * tmpl
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    for c in ("chan1", "chan2", "chan3", "chan2+chan3"):
        fd.set_template(c, tmpl, FS, pretrigger_length_samples=pre)
        fd.set_psd(c, np.full(nt, 1e-9**2 / FS), FS)
    fcfg = {"feature": {
        "chan2": {"of1x1_nodelay": {"run": True},
                  "baseline": {"run": True}},
        "chan2+chan3": {"of1x1_nodelay": {"run": True}}},
        "global": {"trace_length_samples": nt,
                   "pretrigger_length_samples": pre}}
    fpath = str(tmp_path / "f.yaml")
    yaml.safe_dump(fcfg, open(fpath, "w"), sort_keys=False)
    return files, fpath, fd


def _frames_equal(a, b):
    assert len(a) == len(b) and len(a) > 0
    assert set(a.columns) == set(b.columns)
    for col in a.columns:
        try:
            av, bv = np.asarray(a[col], float), np.asarray(b[col], float)
        except (ValueError, TypeError):
            assert list(a[col]) == list(b[col]), col
        else:
            assert np.allclose(av, bv, rtol=1e-6, atol=0,
                               equal_nan=True), col


def test_feature_channel_subset_identical(tmp_path):
    """A feature config mixing chan2/chan3 of a 3-channel file reads
    only those channels; outputs equal the full-stack plan exactly
    (incl. compound +-combination and int16 ADC conversion)."""
    from detprocess_jax.pipelines.features import FeatureProcessing

    files, fpath, fd = _feature_subset_fixture(tmp_path)
    fp = FeatureProcessing(files, fpath, filter_data=fd, verbose=False)
    assert fp._read_channels == ["chan2", "chan3"]
    df_sub = fp.process(batch_size=4)
    fp_full = _expand_to_full_stack(
        FeatureProcessing(files, fpath, filter_data=fd, verbose=False))
    df_full = fp_full.process(batch_size=4)
    _frames_equal(df_sub, df_full)


def test_feature_channel_subset_salted_identical(tmp_path):
    """Salted runs (host AND device injectors) bridge the subset:
    results equal the full-stack plan, and salts on an UNREAD channel
    are harmless."""
    from detprocess_jax.pipelines.features import FeatureProcessing
    from detprocess_jax.pipelines.salting import Salting

    files, fpath, fd = _feature_subset_fixture(tmp_path, adc=False)
    md = RawReader(files).get_metadata(files[0])
    salt_df = pd.DataFrame({
        "salt_channel": ["chan2", "chan1", "chan3"],   # chan1 is unread
        "trigger_index": [128, 256, 300],   # chan2 salt AT the OF
                                            # pretrigger (nodelay sees
                                            # full amplitude)
        "salt_amplitude": [30e-9, 99e-9, 25e-9],
        "salt_energy_ev": [1.0, 1.0, 1.0],
        "series_number": [md["series_num"]] * 3,
        "event_number": [1, 2, 2],
        "dump_number": [1, 1, 1],
    })
    chans = ["chan1", "chan2", "chan3"]
    for device in (False, True):
        salting = Salting(fd, verbose=False)
        salting.set_dataframe(salt_df.copy())
        inj = (salting.make_device_injector(chans) if device
               else salting.make_injector(chans))
        fp = FeatureProcessing(files, fpath, filter_data=fd,
                               verbose=False)
        assert fp._read_channels == ["chan2", "chan3"]
        fp.set_salting(inj)
        df_sub = fp.process(batch_size=4)

        salting2 = Salting(fd, verbose=False)
        salting2.set_dataframe(salt_df.copy())
        inj2 = (salting2.make_device_injector(chans) if device
                else salting2.make_injector(chans))
        fp_full = _expand_to_full_stack(
            FeatureProcessing(files, fpath, filter_data=fd,
                              verbose=False))
        fp_full.set_salting(inj2)
        df_full = fp_full.process(batch_size=4)
        _frames_equal(df_sub, df_full)
        # the chan2 salt must actually appear in the recovered amp
        amp = np.asarray(df_sub["amp_of1x1_nodelay_chan2"], float)
        assert amp[0] > 60e-9                 # 40n pulse + 30n salt


def test_windowed_batches_stay_constant_size_across_drops(trigger_setup):
    """Dropped rows (out-of-bounds windows) must NOT shrink dispatch
    batches: every yielded batch except the last has exactly
    batch_size rows (a new [B, C, N] shape recompiles every group fn —
    seconds per shape)."""
    from detprocess_jax.pipelines.features import FeatureProcessing
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    tmp_path, files, cpath, fd, nt, pre = trigger_setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    trig_df = tp.process(capacity=64)
    # poison scattered rows: indices too close to the trace edge drop
    bad = trig_df.iloc[::4].copy()
    bad["trigger_index"] = 5                 # start < 0 after -pre
    poisoned = pd.concat([trig_df, bad]).sort_values(
        ["series_number", "event_number", "trigger_index"],
        ignore_index=True)
    fcfg = {"feature": {"chan1": {"of1x1_nodelay": {"run": True}}},
            "global": {"trace_length_samples": nt,
                       "pretrigger_length_samples": pre}}
    fpath = str(tmp_path / "f_drops.yaml")
    yaml.safe_dump(fcfg, open(fpath, "w"))
    fp = FeatureProcessing(files, fpath, filter_data=fd,
                           trigger_dataframe=poisoned, verbose=False)
    for nr in (1, 2):
        sizes = [b.shape[0] for b, _ in
                 fp._iter_trigger_batches(5, nreaders=nr)]
        assert sum(sizes) == len(trig_df)            # drops excluded
        assert all(s == 5 for s in sizes[:-1]), sizes  # constant B
        assert 0 < sizes[-1] <= 5
    # row ORDER preserved after repacking
    rows = [a["trigger_index"] for _, admins in
            fp._iter_trigger_batches(5) for a in admins]
    want = [int(r) for r in poisoned["trigger_index"] if r != 5]
    assert rows == want


def test_parallel_prefetcher_fails_fast(tmp_path):
    """A worker error aborts the stream promptly — not after the other
    subsets drain (hours on real datasets)."""
    import time

    class Boom:
        def read_next_event(self, channels=None, **kw):
            raise RuntimeError("bad subset")

    class Slow:
        def read_next_event(self, channels=None, **kw):
            time.sleep(0.05)
            return np.zeros((1, 8)), {"series_number": 1,
                                      "event_number": 1}

    pf = ParallelEventPrefetcher([Boom(), Slow()], depth=4)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="bad subset"):
        for _ in pf:
            pass
    assert time.monotonic() - t0 < 5.0     # Slow never finishes at all
    pf.close()


def test_parallel_prefetcher_closes_readers(tmp_path):
    files = _write_series(tmp_path, "I1_D20260820_T240000", nev=2)

    class Tracked(RawReader):
        closed = False

        def close(self):
            type(self).closed = True
            super().close()

    pf = ParallelEventPrefetcher([Tracked(files)], depth=4)
    list(pf)
    pf.close()
    assert Tracked.closed


def test_async_writer_never_writes_past_an_error(tmp_path):
    """Dumps queued behind a failed write are skipped, never written:
    on-disk dumps stay a gapless prefix (resume-scan safety)."""
    df = pd.DataFrame({"x": np.arange(3)})
    w = tables.AsyncWriter(depth=8)
    ok1 = str(tmp_path / "d1.hdf5")
    bad = str(tmp_path / "no_dir" / "d2.hdf5")
    ok2 = str(tmp_path / "d3.hdf5")
    w.write(df, ok1, fmt="hdf5")
    try:
        w.write(df, bad, fmt="hdf5")
        w.write(df, ok2, fmt="hdf5")  # may raise (race) — but must
        w.close()                     # NEVER hit the disk
        raised = False
    except Exception:
        raised = True
        try:
            w.close()
        except Exception:
            pass
    assert raised
    assert os.path.exists(ok1)
    assert not os.path.exists(ok2), "dump written past an earlier error"


@pytest.mark.parametrize("mode", ["plain", "edge", "residual"])
def test_fast_drain_identical_to_eventbuilder(tmp_path, mode):
    """The batched single-channel drain must equal the per-event
    EventBuilder path frame-for-frame: columns, ORDER, dtypes, values —
    including residual re-trigger and edge exclusion."""
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    nt, pre = 512, 128
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    rng = np.random.default_rng(41)
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T250000", FS,
                  ["chan1"], data_type="continuous",
                  nb_pretrigger_samples=pre)
    traces = rng.standard_normal((3, 1, 60_000)) * 1e-9
    for ev in range(3):
        for p in (6000, 18000, 18400, 33000, 57000):  # incl. pileup +
            traces[ev, 0, p - pre:p - pre + nt] += (   # near-edge
                (60e-9 if p != 18400 else 25e-9) * tmpl)
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=pre)
    fd.set_psd("chan1", np.full(nt, 1e-9**2 / FS), FS)
    tcfg = {"run": True, "template_tag": "default",
            "threshold_sigma": 8.0, "pileup_window_msec": 0.2}
    if mode == "edge":
        tcfg["edge_exclusion_msec"] = 3.0
    if mode == "residual":
        tcfg["run_residual"] = True
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump({"trigger": {"chan1": tcfg}}, open(cpath, "w"))
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    assert tp.FAST_DRAIN
    # the parametrized mode must actually ENGAGE (a dead config key
    # here once made "residual" silently test the plain path)
    tc = tp._channels[0]
    assert tc.run_residual == (mode == "residual")
    assert (tc.edge_exclusion_msec is not None) == (mode == "edge")
    df_fast = tp.process(capacity=64, event_batch=2)
    try:
        tp.FAST_DRAIN = False                  # instance shadow
        df_slow = tp.process(capacity=64, event_batch=2)
    finally:
        del tp.FAST_DRAIN
    assert len(df_fast) == len(df_slow) > 0
    assert list(df_fast.columns) == list(df_slow.columns)
    for col in df_slow.columns:
        a, b = df_fast[col], df_slow[col]
        assert a.dtype == b.dtype, (col, a.dtype, b.dtype)
        try:
            av, bv = np.asarray(a, float), np.asarray(b, float)
        except (ValueError, TypeError):
            assert list(a) == list(b), col
        else:
            np.testing.assert_allclose(av, bv, rtol=0, atol=0,
                                       err_msg=col)
