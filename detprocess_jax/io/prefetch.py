"""Background-thread event prefetching.

The replacement for the reference's synchronous
``H5Reader.read_next_event`` loop (processing_data.py:506-705, SURVEY.md
§2.2 "host-side async input pipeline"): a reader thread keeps a bounded
queue of (traces, admin) events filled while the device computes, so HDF5
decompression and disk latency overlap with dispatch instead of
serializing with it.

Used by TriggerProcessing / FeatureProcessing through
``prefetch_events(reader)``; salting injection stays on the consumer side
(it is cheap and must see the final admin dict).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence


_SENTINEL = object()


class EventPrefetcher:
    """Iterate (traces, admin) pairs read ahead by a daemon thread.

    Parameters
    ----------
    reader : RawReader (or anything with ``read_next_event``)
    depth : queue capacity in events; bounds host memory at
        depth × trace size.
    channels : optional channel subset forwarded to the reader.
    """

    def __init__(self, reader, depth: int = 32,
                 channels: Optional[Sequence[str]] = None,
                 dtype=None, raw: bool = False):
        self._reader = reader
        self._channels = channels
        self._dtype = dtype
        self._raw = raw
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                if self._raw:
                    # stored-dtype reads (int16 ADC codes stay int16);
                    # admin carries "adc_conv" for on-device conversion
                    kw = {"dtype": None, "adctoamp": False}
                else:
                    kw = ({} if self._dtype is None
                          else {"dtype": self._dtype})
                traces, admin = self._reader.read_next_event(
                    channels=self._channels, **kw)
                if traces is None:
                    break
                # block (rather than drop) when the consumer lags
                while not self._stop.is_set():
                    try:
                        self._queue.put((traces, admin), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:   # surfaced on the consumer side
            self._error = exc
        finally:
            # the sentinel must NEVER be dropped: a full queue while the
            # consumer is busy (e.g. minutes-long first jit compile) would
            # otherwise deadlock the consumer's blocking get() forever and
            # swallow any stored reader error. Keep retrying until it fits
            # or close() asks us to stop (close() drains the queue, so the
            # retry loop terminates then too).
            while not self._stop.is_set():
                try:
                    self._queue.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        # stays exhausted once the sentinel is seen — callers following
        # the RawReader contract may probe again after end-of-data
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def read_next_event(self, channels=None):
        """Drop-in for RawReader.read_next_event (returns (None, None)
        at end of data)."""
        try:
            return next(self)
        except StopIteration:
            return None, None

    def close(self):
        """Stop the reader thread and drain the queue."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class ParallelEventPrefetcher:
    """N reader threads over disjoint file subsets feeding one queue.

    The functional replacement for the reference's only intra-job
    parallelism — ``Pool.starmap`` over series with one worker per
    series subset (process/features.py:391-420,
    process/triggers.py:337-377). Here the workers are THREADS feeding
    one device pipeline instead of processes each running their own:
    the device is the shared expensive resource, so the right shape is
    N hosts-side feeders → one batched dispatch stream. Reads release
    the GIL (fastio pread / h5py IO), so reader threads scale with
    cores on production hosts; on a 1-core host they still overlap IO
    waits with compute.

    Event ORDER across subsets is nondeterministic (the reference's
    Pool workers also process series concurrently and write separate
    output series); per-event admin rows carry series/event numbers so
    downstream outputs stay correct. Same iterator /
    ``read_next_event`` protocol as :class:`EventPrefetcher`.

    Build the per-subset readers with ``RawReader.split(n)`` — each
    must own its file handles. The prefetcher takes OWNERSHIP of the
    readers: ``close()`` closes them (h5py handles + pread fds).

    A worker error aborts the stream PROMPTLY (an error marker rides
    the queue, matching EventPrefetcher's fail-fast semantics) instead
    of surfacing only after every other subset finishes.
    """

    _ERROR = object()

    def __init__(self, readers: Sequence, depth: int = 32,
                 channels: Optional[Sequence[str]] = None,
                 dtype=None, raw: bool = False):
        self._readers = list(readers)
        self._channels = channels
        self._dtype = dtype
        self._raw = raw
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._live = len(readers)
        self._live_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, args=(r,), daemon=True)
            for r in self._readers]
        for t in self._threads:
            t.start()

    def _put_marker(self, marker):
        while not self._stop.is_set():
            try:
                self._queue.put(marker, timeout=0.2)
                return
            except queue.Full:
                continue

    def _run(self, reader):
        failed = False
        try:
            while not self._stop.is_set():
                if self._raw:
                    kw = {"dtype": None, "adctoamp": False}
                else:
                    kw = ({} if self._dtype is None
                          else {"dtype": self._dtype})
                traces, admin = reader.read_next_event(
                    channels=self._channels, **kw)
                if traces is None:
                    break
                while not self._stop.is_set():
                    try:
                        self._queue.put((traces, admin), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:   # surfaced on the consumer side
            if self._error is None:
                self._error = exc
            failed = True
        finally:
            if failed:
                # fail FAST: the consumer must not process the other
                # subsets for hours before hearing about this
                self._put_marker(self._ERROR)
            with self._live_lock:
                self._live -= 1
                last = self._live == 0
            if last:
                # only the LAST worker posts the end sentinel — and
                # never drops it (see EventPrefetcher._run)
                self._put_marker(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._ERROR or item is _SENTINEL:
            self._done = True
            if self._error is not None:
                err = self._error
                self.close()           # stop surviving workers
                raise err
            raise StopIteration
        return item

    def read_next_event(self, channels=None):
        """Drop-in for RawReader.read_next_event (returns (None, None)
        at end of data)."""
        try:
            return next(self)
        except StopIteration:
            return None, None

    def close(self):
        """Stop all reader threads, drain the queue, close the owned
        readers. A reader whose thread failed to join (blocked >5 s in
        a single read — NFS stall etc.) is LEAKED rather than closed:
        closing h5py/pread handles under an active reader risks
        exceptions or worse in the C layer; the daemon thread exits
        with the process."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        leftover = []
        for t, r in zip(self._threads, self._readers):
            t.join(timeout=5.0)
            if t.is_alive():
                leftover.append(r)
                continue
            try:
                r.close()
            except Exception:
                pass
        self._readers = leftover


class OrderedChunkPrefetcher:
    """Run ``fn(worker_state, chunk)`` over a chunk list in N worker
    threads, yielding results in chunk ORDER.

    Used for trigger-dataframe windowed feature reads: the row order is
    the output row order (dump-level resume counts rows), so the
    parallel readers must not reorder batches. Chunks are assigned
    round-robin (chunk i → worker i % N) and each worker pushes its
    results in order onto its OWN bounded queue; the consumer
    round-robins across worker queues, which restores the global order
    with no reassembly buffer. ``None`` results (empty chunks) are
    yielded as-is so the caller can skip them.

    ``states`` supplies one private state object per worker (e.g. a
    RawReader clone) — workers never share file handles.
    """

    def __init__(self, fn, chunks: Sequence, states: Sequence,
                 depth: int = 2):
        self._fn = fn
        self._chunks = list(chunks)
        self._n = max(1, len(states))
        self._queues = [queue.Queue(maxsize=max(depth, 1))
                        for _ in range(self._n)]
        self._stop = threading.Event()
        self._errors: list = []
        self._threads = [
            threading.Thread(target=self._run, args=(w, states[w]),
                             daemon=True)
            for w in range(self._n)]
        for t in self._threads:
            t.start()

    def _run(self, w: int, state):
        q = self._queues[w]
        try:
            for i in range(w, len(self._chunks), self._n):
                if self._stop.is_set():
                    return
                result = self._fn(state, self._chunks[i])
                while not self._stop.is_set():
                    try:
                        q.put(result, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:
            self._errors.append(exc)
        finally:
            while not self._stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        nyield = 0
        try:
            while nyield < len(self._chunks):
                q = self._queues[nyield % self._n]
                item = q.get()
                if item is _SENTINEL:
                    # a worker with chunks still assigned only ends
                    # early on error
                    raise (self._errors[0] if self._errors else
                           RuntimeError("chunk reader ended early"))
                nyield += 1
                yield item
            if self._errors:
                raise self._errors[0]
        finally:
            # releases workers blocked pushing their end sentinels
            self.close()

    def close(self):
        self._stop.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5.0)


def prefetch_events(reader, depth: int = 32,
                    channels: Optional[Sequence[str]] = None,
                    dtype=None, raw: bool = False, nreaders: int = 1):
    """Wrap a RawReader in a background prefetcher. ``dtype`` forwards
    to ``read_next_event`` (None = the reader's float64 default);
    ``raw=True`` reads stored-dtype traces with no host ADC conversion
    (``adctoamp=False, dtype=None`` — see RawReader.read_next_event).

    ``nreaders > 1`` splits the reader's files across that many
    concurrent reader threads (``RawReader.split``) — the functional
    replacement for the reference's ``ncores`` Pool-over-series; event
    order across file subsets is then nondeterministic."""
    if nreaders > 1 and hasattr(reader, "split"):
        readers = reader.split(nreaders)
        if len(readers) > 1:
            return ParallelEventPrefetcher(
                readers, depth=depth, channels=channels, dtype=dtype,
                raw=raw)
    return EventPrefetcher(reader, depth=depth, channels=channels,
                           dtype=dtype, raw=raw)
