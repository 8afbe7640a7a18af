"""Feature/trigger table output: vaex-layout HDF5 and parquet.

The reference exports vaex dataframes to HDF5
(detprocess/process/features.py:609-616, triggers.py:644). Vaex's HDF5
layout is simple and we write it directly (no vaex dependency):

    /table/columns/{column}/data       1-D dataset per column

so files round-trip into vaex/detanalysis unchanged. Parquet output (via
pyarrow) is also provided — the more natural columnar format for modern
tooling.

File naming follows the reference convention
(features.py:1055-1072, triggers.py:871-891):
``{prefix}_{group}_{series}_F{dump:04d}.{ext}`` with prefixes ``feature_``,
``threshtrig_``, ``rand_``, ``salting_``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import pandas as pd


def write_vaex_hdf5(df: pd.DataFrame, path: str):
    """Write a dataframe in vaex's HDF5 column layout.

    Missing values in string/object columns (None / NaN) are written as
    empty bytes with a sibling boolean ``mask`` dataset (vaex's masked-
    column convention) — ``str(None)`` would silently turn missing
    provenance fields into the literal string "None" on disk."""
    import h5py
    with h5py.File(path, "w") as f:
        cols = f.require_group("table").require_group("columns")
        for name in df.columns:
            arr = df[name].to_numpy()
            g = cols.create_group(str(name))
            if arr.dtype == object or arr.dtype.kind in "OUT":
                missing = np.asarray(pd.isnull(arr))
                data = np.asarray(
                    [b"" if m else str(x).encode()
                     for x, m in zip(arr, missing)], dtype="S")
                g.create_dataset("data", data=data)
                if missing.any():
                    g.create_dataset("mask", data=missing)
            else:
                g.create_dataset("data", data=arr)


def read_vaex_hdf5(path: str) -> pd.DataFrame:
    import h5py
    with h5py.File(path, "r") as f:
        cols = f["table"]["columns"]
        data = {}
        for name in cols:
            arr = cols[name]["data"][...]
            if arr.dtype.kind == "S":
                # vectorized UTF-8 decode to match the writer's
                # str.encode() (astype(str) decodes ASCII and would
                # crash on any non-ASCII value the writer accepted;
                # a per-element Python loop costs seconds on
                # million-row production dumps)
                arr = np.char.decode(arr, "utf-8")
                if "mask" in cols[name]:
                    mask = cols[name]["mask"][...].astype(bool)
                    arr = arr.astype(object)
                    arr[mask] = None
            data[name] = arr
    return pd.DataFrame(data)


def write_parquet(df: pd.DataFrame, path: str):
    df.to_parquet(path)


def read_parquet(path: str) -> pd.DataFrame:
    return pd.read_parquet(path)


def output_file_name(output_dir: str, prefix: str, group_name: str,
                     series_name: str, dump_num: int,
                     ext: str = "hdf5") -> str:
    name = f"{prefix}_{group_name}_{series_name}_F{dump_num:04d}.{ext}"
    return os.path.join(output_dir, name)


ACCUMULATED_SUMMARY_KEYS = ("events", "triggers", "continuous_events",
                            "wall_sec", "livetime_sec")


def write_job_summary(output_dir: str, prefix: str, group_name: str,
                      series_name: str, summary: dict) -> str:
    """Write a per-series summary JSON next to the dumps
    (``{prefix}_{group}_{series}_summary.json``): throughput, livetime,
    counts, config digest — the machine-readable version of the
    reference's progress prints (process/features.py:549-561,
    triggers.py:588-594).

    Resumed runs write to the same path; count/time keys
    (:data:`ACCUMULATED_SUMMARY_KEYS`) are ACCUMULATED with the existing
    file so the summary always describes the whole series, with an
    ``invocations`` counter recording how many runs contributed.
    Returns the path."""
    import json

    path = os.path.join(
        output_dir, f"{prefix}_{group_name}_{series_name}_summary.json")

    prior = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f)
        except Exception:
            prior = {}
    for key in ACCUMULATED_SUMMARY_KEYS:
        if key in summary and isinstance(prior.get(key), (int, float)):
            summary[key] = type(summary[key])(summary[key] + prior[key])
    summary["invocations"] = int(prior.get("invocations", 0)) + 1
    # derived rate stays consistent with the accumulated totals
    wall = summary.get("wall_sec") or 0
    for count_key in ("events", "continuous_events"):
        if count_key in summary and wall:
            summary["events_per_sec"] = round(summary[count_key] / wall, 3)
            break

    def default(o):
        import numpy as _np
        if isinstance(o, (_np.integer,)):
            return int(o)
        if isinstance(o, (_np.floating,)):
            return float(o)
        return str(o)

    with open(path, "w") as f:
        json.dump(summary, f, indent=2, default=default)
    return path


def config_digest(config_dict) -> str:
    """Stable short hash of a (nested) config mapping for provenance.
    Non-string keys and arbitrary values are canonicalized to strings so
    any YAML-derived structure digests."""
    import hashlib
    import json

    def norm(o):
        if isinstance(o, dict):
            return {str(k): norm(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [norm(v) for v in o]
        if isinstance(o, (str, int, float, bool)) or o is None:
            return o
        return str(o)

    blob = json.dumps(norm(config_dict), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def write_table(df: pd.DataFrame, path: str, fmt: Optional[str] = None):
    """Dispatch on extension/format ('hdf5' vaex layout, or 'parquet')."""
    fmt = fmt or ("parquet" if path.endswith(".parquet") else "hdf5")
    if fmt == "hdf5":
        write_vaex_hdf5(df, path)
    elif fmt == "parquet":
        write_parquet(df, path)
    else:
        raise ValueError(f"unknown table format: {fmt}")


def read_table(path: str) -> pd.DataFrame:
    if path.endswith(".parquet"):
        return read_parquet(path)
    return read_vaex_hdf5(path)


def concat_tables(paths) -> pd.DataFrame:
    return pd.concat([read_table(p) for p in paths], ignore_index=True)


def count_rows(path: str) -> int:
    """Row count of a written table without loading the data (resume
    bookkeeping)."""
    if path.endswith(".parquet"):
        import pyarrow.parquet as pq
        return pq.ParquetFile(path).metadata.num_rows
    import h5py
    with h5py.File(path, "r") as f:
        cols = f["/table/columns"]
        for name in cols:
            return int(cols[name]["data"].shape[0])
    return 0


def build_prefix(base: str, processing_id=None, restricted: bool = False,
                 calib: bool = False) -> str:
    """Output-file prefix with provenance markers
    ([{processing_id}_]base[_restricted|_calib], reference
    features.py:1063-1070)."""
    prefix = f"{processing_id}_{base}" if processing_id else base
    if restricted:
        prefix += "_restricted"
    elif calib:
        prefix += "_calib"
    return prefix


class AsyncWriter:
    """Background-thread table writer: dump writes overlap device
    compute instead of stalling the dispatch loop.

    The reference's per-dump vaex exports run inline in each Pool
    worker (process/features.py:593-626); here one pipeline feeds the
    device, so a synchronous dump write stalls dispatch for the whole
    write. ``write()`` enqueues (bounded — at most ``depth`` dumps of
    frames held in memory) and returns; ``close()`` drains the queue
    and re-raises the first write error. Always close() (the pipelines
    do, in a finally) — dropped writes would silently lose dumps.
    """

    def __init__(self, depth: int = 2):
        import queue
        import threading

        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._sentinel = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._queue.get()
            if item is self._sentinel:
                return
            df, path, fmt = item
            try:
                if self._error is None:
                    write_table(df, path, fmt=fmt)
            except BaseException as exc:  # re-raised from close()
                self._error = exc

    def write(self, df: pd.DataFrame, path: str,
              fmt: Optional[str] = None):
        # fail fast on a dead writer — but NEVER clear _error here:
        # the worker's "skip all writes after the first error" gate
        # reads it, and clearing would let dumps queued behind the
        # failed one be written, leaving a dump-number GAP that a later
        # resume scan would silently step over (data loss). The error
        # stays set; close() re-raises it too (callers are aborting).
        if self._error is not None:
            raise self._error
        self._queue.put((df, path, fmt))

    def close(self):
        """Drain pending writes; re-raise the first write error.

        After an error NOTHING further was written (the worker skips
        every queued dump once _error is set), so on-disk dumps are
        always a gapless prefix — exactly what the pipelines' resume
        scan assumes."""
        if self._thread.is_alive():
            self._queue.put(self._sentinel)
            self._thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
