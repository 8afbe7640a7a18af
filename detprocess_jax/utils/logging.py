"""Structured logging + per-stage timing.

The reference prints ``INFO:``-prefixed progress with events/sec every 100
events (features.py:549-561, triggers.py:588-594) and has no formal
tracing (SURVEY.md §5). Here: a standard-library logger with the same
message conventions, a stage timer that reports throughput, and optional
JAX profiler hooks (``jax.profiler.trace``) for device-level traces.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional

logger = logging.getLogger("detprocess_jax")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class StageTimer:
    """Accumulates per-stage wall time and item counts.

    >>> timer = StageTimer()
    >>> with timer.stage("fft"):
    ...     ...
    >>> timer.add_items("fft", 1024)
    >>> timer.report()
    """

    def __init__(self):
        self._times: dict = {}
        self._items: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name] = (self._times.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def add_items(self, name: str, count: int):
        self._items[name] = self._items.get(name, 0) + count

    def add_seconds(self, name: str, seconds: float):
        """Accumulate measured time directly (for call sites where the
        ``stage`` context manager would force a re-indent)."""
        self._times[name] = self._times.get(name, 0.0) + seconds

    def report(self, log=True) -> dict:
        out = {}
        for name, t in self._times.items():
            entry = {"seconds": t}
            if name in self._items and t > 0:
                entry["items"] = self._items[name]
                entry["items_per_sec"] = self._items[name] / t
            out[name] = entry
            if log:
                rate = (f" ({entry['items_per_sec']:.0f} items/s)"
                        if "items_per_sec" in entry else "")
                logger.info(f"stage {name}: {t:.2f}s{rate}")
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """JAX profiler trace context (view with TensorBoard / xprof).

    No-op when log_dir is None.
    """
    if log_dir is None:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


def progress(total: int, every: int, t_start: float, what: str = "events"):
    """Reference-style progress print (features.py:549-561)."""
    if total % every == 0 and total > 0:
        dt = time.perf_counter() - t_start
        rate = total / dt if dt > 0 else 0.0
        logger.info(f"processed {total} {what} ({rate:.0f} {what}/s)")
