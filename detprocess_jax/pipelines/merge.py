"""Offline merging of per-channel feature dataframes by global timestamp.

Replacement for the reference example utility
(examples/trigger/merge_feature_files.py:1-206): feature dataframes
produced independently per channel (or per processing run) are merged into
one table by matching a global "spicestamp" timestamp within a merge
window; duplicate matches resolve to the trigger with the largest Δχ²
(merge_feature_files.py:32-75).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

from detprocess_jax.io import tables


_EVENT_CAP = 10**6          # max events per series
_TRACE_CAP = 10**9          # max samples per continuous trace


def spicestamp(df: pd.DataFrame, fs: float,
               series_rank: Optional[dict] = None) -> np.ndarray:
    """Unique per-trigger stamp for window merging.

    Primary form (the reference's composition from series/event digits +
    trigger_index, merge_feature_files.py:179-193): when the frame
    carries ``series_number``/``event_number``,

        stamp = (rank(series)·1e6 + event_number)·1e9 + trigger_index

    so a merge window in samples only ever compares triggers of the SAME
    continuous event — no rounding artifacts, no cross-event collisions.

    Fallback for foreign frames without series/event columns:
    ``event_time·fs + trigger_index``. NOTE this assumes event_time is
    the TRACE-START time; frames produced by this package's pipelines
    stamp event_time per trigger (trace start + trigger time) and always
    carry series/event columns, so they take the primary path.
    """
    if ("series_number" in df and "event_number" in df
            and "trigger_index" in df):
        series = df["series_number"].to_numpy()
        if series_rank is None:
            uniq = sorted(set(int(x) for x in series))
            series_rank = {s: i for i, s in enumerate(uniq)}
        rank = np.array([series_rank[int(x)] for x in series],
                        dtype=np.int64)
        event = df["event_number"].to_numpy(np.int64)
        tidx = df["trigger_index"].to_numpy(np.int64)
        return ((rank * _EVENT_CAP + event) * _TRACE_CAP
                + tidx).astype(np.float64)
    stamp = df["event_time"].to_numpy(dtype=np.float64) * fs
    if "trigger_index" in df:
        stamp = stamp + df["trigger_index"].to_numpy(dtype=np.float64)
    return stamp


def merge_feature_tables(
    frames: Sequence[pd.DataFrame],
    fs: float,
    merge_window_samples: int = 100,
    delta_chi2_column: Optional[str] = None,
) -> pd.DataFrame:
    """Merge feature tables on the global timestamp.

    Rows across tables whose stamps agree within ``merge_window_samples``
    are combined into one output row (columns united; later tables fill
    NaN columns of earlier ones). Grouping is transitive off the last
    record (like the reference's window chaining): a burst of triggers
    spaced under the window forms ONE group whose total span can exceed
    the window — size the window below half the minimum expected event
    separation.

    When several rows of the same table fall in one window, the best one
    wins: largest ``delta_chi2_column`` (default: first column containing
    'delta_chi2'); if only a plain 'chi2' column exists, the SMALLEST
    (best-fit) wins.
    """
    frames = [f.reset_index(drop=True) for f in frames if len(f)]
    if not frames:
        return pd.DataFrame()

    def chi2_col(df):
        if delta_chi2_column and delta_chi2_column in df:
            return delta_chi2_column, True
        for c in df.columns:
            if "delta_chi2" in c:
                return c, True
        for c in df.columns:
            if "chi2" in c:
                return c, False     # plain chi2: smaller is better
        return None, True

    # a shared series-rank map keeps stamps consistent across frames
    all_series = sorted({int(x) for df in frames
                         if "series_number" in df
                         for x in df["series_number"]})
    srank = {s: i for i, s in enumerate(all_series)} or None

    # collect (stamp, frame_idx, row_idx)
    records = []
    for fi, df in enumerate(frames):
        stamps = spicestamp(df, fs, series_rank=srank)
        for ri, s in enumerate(stamps):
            records.append((s, fi, ri))
    records.sort()

    # group by stamp proximity
    groups: List[List[tuple]] = []
    for rec in records:
        if groups and rec[0] - groups[-1][-1][0] <= merge_window_samples:
            groups[-1].append(rec)
        else:
            groups.append([rec])

    rows = []
    for group in groups:
        merged = {}
        # dedup within each frame by max delta chi2
        by_frame: dict = {}
        for s, fi, ri in group:
            by_frame.setdefault(fi, []).append(ri)
        for fi, ris in by_frame.items():
            df = frames[fi]
            if len(ris) > 1:
                col, larger_is_better = chi2_col(df)
                if col is not None:
                    vals = df[col].iloc[ris].to_numpy()
                    pick = (np.argmax(vals) if larger_is_better
                            else np.argmin(vals))
                    ris = [ris[int(pick)]]
                else:
                    ris = [ris[0]]
            row = df.iloc[ris[0]]
            for col, val in row.items():
                if col not in merged or pd.isna(merged[col]):
                    merged[col] = val
        merged["merge_nb_matched"] = len(by_frame)
        rows.append(merged)
    return pd.DataFrame(rows)


def merge_feature_files(paths: Sequence[str], fs: float,
                        merge_window_samples: int = 100,
                        output_path: Optional[str] = None) -> pd.DataFrame:
    """File-level wrapper: read tables, merge, optionally write."""
    frames = [tables.read_table(p) for p in paths]
    out = merge_feature_tables(frames, fs, merge_window_samples)
    if output_path:
        tables.write_table(out, output_path)
    return out
