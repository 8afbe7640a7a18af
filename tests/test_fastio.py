"""pread fast path (io/fastio.py) — equality vs the h5py read path.

The raw-data reader serves contiguous event datasets through positioned
``preadv`` at the resolved file offset (3.6x h5py on this host, no
libhdf5 lock in prefetch threads); everything here pins the fast path
to h5py byte-for-byte and proves the fallback engages for storage it
cannot serve (chunked/compressed/compact/big-endian)."""

import os

import h5py
import numpy as np
import pytest

from detprocess_jax.io import fastio
from detprocess_jax.io.rawdata import RawReader, RawWriter

FS = 1.25e6


def _write_raw(tmp_path, name, *, int16=False, nev=3, nchan=2, nsamp=5000):
    rng = np.random.default_rng(7)
    amps = rng.standard_normal((nev, nchan, nsamp)) * 1e-8
    kw = {}
    if int16:
        kw["adc_conversion_factor"] = 2.0 ** -29
    w = RawWriter(str(tmp_path / name), "I1_D20260820_T040000", FS,
                  [f"c{i}" for i in range(nchan)], data_type="continuous",
                  detector_config={f"c{i}": {"close_loop_norm": 2.0}
                                   for i in range(nchan)}, **kw)
    w.write_dump(amps, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / name).glob("*.hdf5"))
    assert files
    return files


@pytest.mark.parametrize("int16", [False, True])
def test_full_read_matches_h5py(tmp_path, int16):
    files = _write_raw(tmp_path, f"full{int16}", int16=int16)
    fast = RawReader(files)
    tr_fast, admin = fast.read_next_event()
    # independent h5py read of the same dataset
    with h5py.File(files[0]) as f:
        ds = f["adc1/event_1"]
        raw = ds[...]
        cal = float(f["adc1"].attrs["adc_conversion_factor"])
    expected = raw.astype(np.float64) * (cal / 2.0)
    np.testing.assert_array_equal(tr_fast, expected)
    # the fast path actually engaged (dataset resolved, not fallback)
    assert any(v is not fastio._INELIGIBLE
               for v in fast._fast._entries.values())
    fast.close()


def test_raw_mode_returns_stored_codes(tmp_path):
    files = _write_raw(tmp_path, "rawmode", int16=True)
    r = RawReader(files)
    tr, admin = r.read_next_event(dtype=None, adctoamp=False)
    assert tr.dtype == np.int16
    assert tr.flags.writeable            # device upload path may pin it
    with h5py.File(files[0]) as f:
        np.testing.assert_array_equal(tr, f["adc1/event_1"][...])
    assert "adc_conv" in admin
    r.close()


@pytest.mark.parametrize("window", [(100, 700), (-50, 200), (4800, 900),
                                    (0, 5000), (2500, 0)])
def test_windowed_read_matches_h5py(tmp_path, window):
    files = _write_raw(tmp_path, "win", int16=True)
    r = RawReader(files)
    tr, _ = r.read_single_event(1, channels=["c1"], trace_window=window,
                                adctoamp=False, dtype=None)
    start, length = window
    start = max(0, int(start))
    with h5py.File(files[0]) as f:
        expected = f["adc1/event_1"][1:2, start:start + int(length)]
    np.testing.assert_array_equal(tr, expected)
    r.close()


def test_fallback_for_chunked_and_bigendian(tmp_path):
    path = str(tmp_path / "weird.h5")
    data = np.arange(60, dtype=np.int16).reshape(2, 30)
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=data, chunks=(1, 10))
        f.create_dataset("gz", data=data, chunks=(1, 10),
                         compression="gzip")
        f.create_dataset("be", data=data.astype(">i2"))
        f.create_dataset("contig", data=data)
    fr = fastio.FastReader()
    with h5py.File(path) as f:
        assert fr.resolve(path, f["chunked"]) is None
        assert fr.resolve(path, f["gz"]) is None
        assert fr.resolve(path, f["be"]) is None
        entry = fr.resolve(path, f["contig"])
        assert entry is not None
        np.testing.assert_array_equal(fr.read(entry), data)
        np.testing.assert_array_equal(fr.read(entry, (5, 10)),
                                      data[:, 5:15])
        # negative resolutions are cached too
        assert fr._entries[(path, "/chunked")] is fastio._INELIGIBLE
    fr.close()


def test_pipeline_reads_identical_with_and_without_fastio(tmp_path,
                                                          monkeypatch):
    """Force-ineligible fastio and compare full read_many_events output."""
    files = _write_raw(tmp_path, "pipe", int16=True, nev=4)
    r1 = RawReader(files)
    fast_tr, fast_admin = r1.read_many_events()
    r1.close()

    monkeypatch.setattr(fastio, "dataset_storage", lambda ds: None)
    r2 = RawReader(files)
    slow_tr, slow_admin = r2.read_many_events()
    r2.close()
    np.testing.assert_array_equal(fast_tr, slow_tr)
    assert len(fast_admin) == len(slow_admin)
    for a, b in zip(fast_admin, slow_admin):
        assert a == b


def test_fd_cache_eviction(tmp_path):
    files = []
    for i in range(5):
        files += _write_raw(tmp_path, f"ev{i}", nev=1, nsamp=100)
    fr = fastio.FastReader(max_fds=2)
    entries = []
    for path in files:
        with h5py.File(path) as f:
            entries.append((path, fr.resolve(path, f["adc1/event_1"])))
    for path, entry in entries * 2:      # revisit after eviction
        assert entry is not None
        arr = fr.read(entry)
        assert arr.shape[-1] == 100
    assert len(fr._all_fds) <= 2         # capped (single thread here)
    fr.close()
    assert not fr._all_fds
    # reads still work after close(): the generation bump invalidates
    # the thread cache and fds reopen on demand
    arr = fr.read(entries[0][1])
    assert arr.shape[-1] == 100
    fr.close()


def test_fd_eviction_never_races_concurrent_readers(tmp_path):
    """Thread-local fd caches: eviction churn in N threads over more
    files than max_fds must never close an fd another thread is reading
    on (the shared-cache design could EBADF — or silently read the
    WRONG file after fd-number reuse)."""
    import threading

    files, datas = [], []
    for i in range(6):
        fs = _write_raw(tmp_path, f"race{i}", nev=1, nsamp=400)
        files += fs
        with h5py.File(fs[0]) as f:
            datas.append(f["adc1/event_1"][...])
    fr = fastio.FastReader(max_fds=2)    # far fewer fds than files
    entries = []
    for path in files:
        with h5py.File(path) as f:
            entries.append(fr.resolve(path, f["adc1/event_1"]))
    assert all(e is not None for e in entries)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(200):
                i = int(rng.integers(len(entries)))
                arr = fr.read(entries[i])
                if not np.array_equal(arr, datas[i]):
                    errors.append(f"wrong bytes for file {i}")
                    return
        except Exception as exc:         # pragma: no cover - fail path
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fr.close()
    assert not errors, errors


def test_dead_thread_fds_are_reaped(tmp_path):
    """Fds owned by exited threads (each process() call spawns a fresh
    prefetch thread) are closed on the next _fd() call from any thread
    — a long-lived reader over many runs must not leak toward EMFILE."""
    import threading

    files = []
    for i in range(4):
        files += _write_raw(tmp_path, f"reap{i}", nev=1, nsamp=100)
    fr = fastio.FastReader(max_fds=8)
    entries = []
    for path in files:
        with h5py.File(path) as f:
            entries.append(fr.resolve(path, f["adc1/event_1"]))

    def worker():
        for e in entries:
            fr.read(e)

    for _ in range(5):                   # 5 generations of short-lived
        t = threading.Thread(target=worker)  # reader threads
        t.start()
        t.join()
    # before any reap trigger, dead threads' fds linger in the registry
    # (up to 4 per generation); one read from the main thread reaps them
    fr.read(entries[0])
    assert len(fr._all_fds) <= len(files) + 1, (
        f"dead-thread fds not reaped: {len(fr._all_fds)} open")
    # stale fd numbers must never be double-closed after close()
    fr.close()
    assert not fr._all_fds
    fr.read(entries[0])                  # reopen on demand still works
    fr.close()


def test_row_subset_read_matches_h5py(tmp_path):
    """rows= preads only the selected channel rows; combines with
    window= (channel-subset uploads read bytes ∝ channels USED)."""
    files = _write_raw(tmp_path, "rows", nev=1, nsamp=300, nchan=3)
    fr = fastio.FastReader()
    with h5py.File(files[0]) as f:
        ds = f["adc1/event_1"]
        want = ds[...]
        entry = fr.resolve(files[0], ds)
    assert entry is not None
    got = fr.read(entry, rows=[2, 0])
    assert got.shape == (2, 300)
    assert np.array_equal(got[0], want[2])
    assert np.array_equal(got[1], want[0])
    win = fr.read(entry, window=(50, 100), rows=[1])
    assert win.shape == (1, 100)
    assert np.array_equal(win[0], want[1, 50:150])
    fr.close()
