"""pread(2) fast path for contiguous, unfiltered HDF5 datasets.

Raw detector files (pytesdaq layout — reference reads them via
pytesio.H5Reader, processing_data.py:520-526) store each event as one
contiguous int16/float32 dataset.  h5py's generic read path tops out
around 0.6 GB/s per thread on these files (hyperslab selection
machinery + the global libhdf5 lock); reading the same bytes with a
plain ``pread`` at the dataset's file offset measures ~2.3 GB/s
single-threaded (measured on a development host).  This module
resolves ``(offset, shape, dtype)`` once per dataset through h5py's
metadata API and serves every subsequent read with ``os.preadv`` into
a preallocated writable buffer:

- **thread-safe**: ``preadv`` is a stateless positioned syscall (no
  shared seek pointer, no libhdf5 lock), so prefetch threads scale;
- **one copy total**: kernel page cache → destination buffer;
- **windowed reads** (trigger-dataframe-driven feature mode) become C
  tiny positioned reads instead of an h5py hyperslab per event.

Eligibility is checked once per dataset and cached; anything else
(chunked, compressed, compact, unallocated, big-endian, >2-D) falls
back to the ordinary h5py path in the caller:

    entry = fast.resolve(path, ds)      # h5py.Dataset, once
    arr = fast.read(entry, window)      # afterwards: no h5py involved
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

try:  # h5py is only needed at resolve time
    import h5py
    from h5py import h5d as _h5d
except ImportError:  # pragma: no cover - h5py is a hard dep elsewhere
    h5py = None
    _h5d = None

_INELIGIBLE = "ineligible"          # cached negative resolution


class FastDataset(NamedTuple):
    path: str
    offset: int                     # absolute file offset of element 0
    shape: Tuple[int, ...]
    dtype: np.dtype                 # native-endian


def dataset_storage(ds) -> Optional[Tuple[int, Tuple[int, ...], np.dtype]]:
    """(offset, shape, native dtype) when ``ds`` is contiguous,
    allocated, unfiltered and little-endian — else None."""
    try:
        plist = ds.id.get_create_plist()
        if plist.get_layout() != _h5d.CONTIGUOUS:
            return None
        if plist.get_nfilters() != 0:
            return None
        offset = ds.id.get_offset()
    except Exception:
        return None
    if offset is None:
        return None                 # storage not allocated yet
    dt = ds.dtype
    if dt.kind not in "iuf" or dt.byteorder == ">" or (
            dt.byteorder == "=" and sys.byteorder == "big"):
        return None                 # needs a byteswap — not worth it
    if len(ds.shape) > 2:
        return None
    return int(offset), tuple(int(s) for s in ds.shape), dt.newbyteorder("=")


class FastReader:
    """Per-RawReader pread engine with per-thread fd caches.

    File descriptors are opened read-only on first use and kept (capped
    at ``max_fds`` PER THREAD — each reader thread caches up to that
    many) — positioned reads never mutate them. Each thread owns its
    fds, so cache eviction can never close an fd another thread is
    mid-read on (see __init__). Fds owned by threads that have exited
    (each pipeline ``process()`` call spawns a fresh prefetch thread)
    are reaped on the next ``_fd()`` call from any thread, so repeated
    runs on a long-lived reader cannot accumulate fds toward EMFILE.
    """

    def __init__(self, max_fds: int = 128):
        self._max_fds = max_fds
        # fd caches are PER THREAD: a shared cache would let thread A's
        # eviction close an fd thread B is mid-pread on — EBADF at best,
        # and if the fd number is reused by a concurrent open, a silent
        # read of the WRONG file. With thread-local caches each fd has
        # exactly one user, so eviction can never race a read. A global
        # registry keeps every open fd reachable for close(); the
        # generation counter invalidates thread caches after close().
        # _thread_caches pairs each per-thread fd dict with a weakref to
        # its owner thread so dead threads' fds can be reaped.
        self._tls = threading.local()
        self._all_fds: set = set()
        self._gen = 0
        self._entries: Dict[Tuple[str, str], object] = {}
        self._lock = threading.Lock()
        self._thread_caches: list = []   # [(weakref(thread), fds_dict)]

    # -- resolution ------------------------------------------------------

    def resolve(self, path: str, ds) -> Optional[FastDataset]:
        """FastDataset for an h5py dataset, or None (h5py fallback).

        The (path, dataset-name) result is cached, including negative
        results, so the h5py metadata calls run once per dataset.
        """
        key = (path, ds.name)
        hit = self._entries.get(key)
        if hit is not None:
            return None if hit is _INELIGIBLE else hit
        storage = dataset_storage(ds)
        if storage is None:
            self._entries[key] = _INELIGIBLE
            return None
        entry = FastDataset(path, *storage)
        self._entries[key] = entry
        return entry

    # -- reading ---------------------------------------------------------

    def _reap_dead_threads_locked(self) -> None:
        """Close fds whose owner thread has exited (caller holds _lock).

        Only fds still registered in ``_all_fds`` are closed: after
        ``close()`` the registry is empty, so stale fd *numbers* left
        in dead threads' dicts (possibly reused by the OS) are never
        double-closed.
        """
        live = []
        for ref, fds in self._thread_caches:
            t = ref()
            if t is not None and t.is_alive():
                live.append((ref, fds))
                continue
            for fd in fds.values():
                if fd in self._all_fds:
                    self._all_fds.discard(fd)
                    try:
                        os.close(fd)
                    except OSError:
                        pass
        self._thread_caches = live

    def _fd(self, path: str) -> int:
        tls = self._tls
        if getattr(tls, "gen", None) != self._gen:
            import weakref
            tls.fds = {}                 # fresh cache (first use of this
            tls.gen = self._gen          # thread, or after close())
            with self._lock:
                self._thread_caches.append(
                    (weakref.ref(threading.current_thread()), tls.fds))
                self._reap_dead_threads_locked()
        fd = tls.fds.get(path)
        if fd is not None:
            return fd
        if len(tls.fds) >= self._max_fds:
            old_path, old_fd = next(iter(tls.fds.items()))
            del tls.fds[old_path]
            with self._lock:
                self._all_fds.discard(old_fd)
            os.close(old_fd)             # ours alone — no reader races
        fd = os.open(path, os.O_RDONLY)
        tls.fds[path] = fd
        with self._lock:
            self._all_fds.add(fd)
        return fd

    def read(self, entry: FastDataset,
             window: Optional[Tuple[int, int]] = None,
             rows=None) -> np.ndarray:
        """Read the whole dataset, or ``window=(start, length)`` sample
        columns of a [C, N] dataset (h5py ``ds[:, start:start+length]``
        semantics: negative start clamps to 0, overrun truncates at N).

        ``rows``: optional sequence of channel-row indices of a [C, N]
        dataset — only those rows are pread (rows are contiguous on
        disk), so channel-subset reads cost bytes proportional to the
        channels USED, not the channels stored. Combines with
        ``window``.
        """
        fd = self._fd(entry.path)
        itemsize = entry.dtype.itemsize
        if window is None and rows is None:
            out = np.empty(entry.shape, entry.dtype)
            self._pread_into(fd, out.reshape(-1).view(np.uint8),
                             entry.offset, path=entry.path)
            return out
        if len(entry.shape) != 2:
            raise ValueError("windowed/row-subset fast reads need a "
                             "[C, N] dataset")
        nchan, nsamp = entry.shape
        row_list = (list(range(nchan)) if rows is None
                    else [int(r) for r in rows])
        if window is None:
            start, width = 0, nsamp
        else:
            start, length = window
            start = max(0, int(start))
            stop = min(nsamp, start + max(0, int(length)))
            width = max(0, stop - start)
        out = np.empty((len(row_list), width), entry.dtype)
        row_bytes = nsamp * itemsize
        flat = out.view(np.uint8).reshape(len(row_list), -1)
        for i, c in enumerate(row_list):
            self._pread_into(
                fd, flat[i], entry.offset + c * row_bytes + start * itemsize,
                path=entry.path)
        return out

    @staticmethod
    def _pread_into(fd: int, buf: np.ndarray, offset: int,
                    path: str = "?") -> None:
        """Fill ``buf`` (uint8 view) from ``fd`` at ``offset``; loops on
        short reads (page-cache reads return full, disk may not)."""
        view = memoryview(buf)
        total = len(view)
        got = 0
        while got < total:
            n = os.preadv(fd, [view[got:]], offset + got)
            if n <= 0:
                raise IOError(
                    f"short read in raw file '{path}': wanted {total} "
                    f"bytes at {offset}, got {got} — truncated dump?")
            got += n

    def close(self) -> None:
        """Close every cached fd (all threads). Callers must have
        stopped concurrent readers first — same contract as closing an
        h5py file out from under a reader."""
        with self._lock:
            self._gen += 1               # invalidates per-thread caches
            fds, self._all_fds = self._all_fds, set()
            self._thread_caches = []     # stale fd numbers: never reap
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass

    def __del__(self):  # best-effort; explicit close() preferred
        try:
            self.close()
        except Exception:
            pass
