"""Randoms acquisition: sample random trigger times from continuous data.

Replacement for the reference Randoms pipeline
(detprocess/process/randoms.py:174-788). Metadata-only — no traces are
read; the output is a trigger dataframe (``trigger_type = 3``,
randoms.py:620) that drives later windowed feature extraction or noise PSD
estimation.

Sampling semantics mirror randoms.py:432-482: a target ``random_rate`` (Hz)
maps to round(trace_length·rate) triggers per continuous event (min 1, with
an event subsampling fraction when rate·trace_length < 1); positions are
drawn without replacement from the edge-excluded, separation-reduced sample
space, then spread by the minimum separation.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import pandas as pd

from detprocess_jax.io import tables
from detprocess_jax.io.rawdata import open_reader
from detprocess_jax.utils.misc import create_series_name


class Randoms:
    """Random trigger-time sampler over continuous raw files."""

    def __init__(self, raw_files: Sequence[str] | str,
                 processing_id: Optional[str] = None,
                 facility: int = 1,
                 verbose: bool = True):
        self._reader = open_reader(raw_files)
        self._verbose = verbose
        self._facility = facility
        self._processing_id = processing_id
        self._output_group_path: Optional[str] = None

    # -- reference-parity accessors (process/randoms.py:149-172) --------
    @property
    def verbose(self) -> bool:
        return self._verbose

    @verbose.setter
    def verbose(self, value: bool):
        self._verbose = bool(value)

    def get_series_dict(self) -> dict:
        """{series_name: [files]} over the input continuous data
        (randoms.py:158-159)."""
        from detprocess_jax.io.rawdata import extract_series_name

        out: dict = {}
        for fname in self._reader.files:
            try:
                out.setdefault(extract_series_name(fname), []).append(fname)
            except ValueError:
                continue
        return out

    def _group_dir(self) -> str:
        """Directory of the raw GROUP. Handles both supported layouts:
        flat ``{group}/*.hdf5`` and nested ``{group}/{series}/*.hdf5``
        (the holding directory is named after the file's series → the
        group is one level up, matching RawData._build_file_map)."""
        from detprocess_jax.io.rawdata import extract_series_name

        d = os.path.dirname(os.path.abspath(self._reader.files[0]))
        try:
            if os.path.basename(d) == extract_series_name(
                    self._reader.files[0]):
                d = os.path.dirname(d)
        except ValueError:
            pass
        return d

    def get_base_path(self) -> str:
        """Parent of the raw group directory (randoms.py:161-162)."""
        return os.path.dirname(self._group_dir())

    def get_group_name(self) -> str:
        """Raw group = the directory holding the input files
        (randoms.py:164-165)."""
        return os.path.basename(self._group_dir())

    def get_output_path(self) -> Optional[str]:
        """Output group path of the last saved process() run
        (randoms.py:167-171)."""
        return self._output_group_path

    def process(self,
                random_rate: Optional[float] = None,
                nrandoms: Optional[int] = None,
                min_separation_msec: float = 100.0,
                edge_exclusion_msec: float = 50.0,
                restricted: bool = False,
                seed: Optional[int] = None,
                lgc_save: bool = False,
                output_path: Optional[str] = None,
                output_format: str = "hdf5",
                series_name: Optional[str] = None,
                group_name: str = "randoms",
                lgc_output: bool = True) -> Optional[pd.DataFrame]:
        """Sample random triggers. Provide ``random_rate`` (Hz) and/or
        ``nrandoms`` (cap on total count, applied by subsampling at the
        end, randoms.py:657-663)."""
        if random_rate is None and nrandoms is None:
            raise ValueError('"random_rate" or "nrandoms" required')

        rng = np.random.default_rng(seed)
        md = self._reader.get_metadata()
        fs = float(md["sample_rate"])
        nb_samples = int(md["nb_samples"])
        trace_length_sec = nb_samples / fs

        min_sep = int(np.ceil(fs * min_separation_msec * 1e-3))
        edge = int(np.ceil(fs * edge_exclusion_msec * 1e-3))

        if random_rate is not None:
            random_length_sec = 1.0 / random_rate
            per_event = max(
                int(round(trace_length_sec / random_length_sec)), 1)
            event_fraction = min(trace_length_sec / random_length_sec, 1.0)
        else:
            # spread requested count uniformly over the events (rounded up;
            # the final subsample enforces the exact count)
            per_event = max(
                -(-nrandoms // max(self._reader.total_events(), 1)), 1)
            event_fraction = 1.0

        nb_reduced = (nb_samples - 2 * edge - (per_event - 1) * min_sep)
        if nb_reduced <= per_event:
            # shrink the separation (then the edges) to fit the trace —
            # the defaults target multi-second continuous dumps
            margin = 4 * per_event
            min_sep = max((nb_samples - 2 * edge - margin)
                          // max(per_event - 1, 1), 0)
            nb_reduced = (nb_samples - 2 * edge
                          - (per_event - 1) * min_sep)
            if nb_reduced <= per_event:
                edge = max((nb_samples - margin
                            - (per_event - 1) * min_sep) // 2, 0)
                nb_reduced = (nb_samples - 2 * edge
                              - (per_event - 1) * min_sep)
            if nb_reduced <= per_event:
                raise ValueError(
                    f"trace too short for {per_event} randoms per event")
            if self._verbose:
                print(f"INFO: reduced randoms min separation to "
                      f"{min_sep / fs * 1e3:.1f} msec to fit the trace")

        rows = []
        trigger_id = 0
        current_time = None
        self._reader.rewind()
        while True:
            traces, admin = self._reader.read_next_event()
            if traces is None:
                break
            event_time = admin["event_time"]
            if current_time is None or event_time > current_time:
                current_time = event_time
            else:
                current_time += trace_length_sec

            if event_fraction < 1.0 and rng.random() > event_fraction:
                continue

            picks = np.sort(rng.choice(nb_reduced, size=per_event,
                                       replace=False))
            trigger_indices = picks + edge + (np.arange(per_event) * min_sep)

            for ti in trigger_indices:
                trigger_id += 1
                tt = ti / fs
                rows.append({
                    "series_number": admin["series_number"],
                    "event_number": admin["event_number"],
                    "dump_number": admin["dump_number"],
                    "event_time": int(round(current_time + tt)),
                    "trigger_index": int(ti),
                    "trigger_time": tt,
                    "trigger_type": 3,
                    "data_type": admin["data_type"],
                    "group_name": admin["group_name"],
                    "trigger_prod_id": trigger_id,
                    "randoms_min_separation_time": min_separation_msec * 1e-3,
                    "randoms_edge_exclusion_time": edge_exclusion_msec * 1e-3,
                    "processing_id": self._processing_id or "",
                })

        df = pd.DataFrame(rows)
        if nrandoms is not None and len(df) > nrandoms:
            df = df.sample(n=nrandoms, random_state=seed).sort_values(
                ["series_number", "event_number", "trigger_index"],
                ignore_index=True)

        if lgc_save and len(df):
            if output_path is None:
                raise ValueError("output_path required with lgc_save")
            os.makedirs(output_path, exist_ok=True)
            self._output_group_path = output_path
            out_series = series_name or create_series_name(self._facility)
            path = tables.output_file_name(
                output_path, "rand", group_name, out_series, 1,
                "parquet" if output_format == "parquet" else "hdf5")
            tables.write_table(df, path, fmt=output_format)
            tables.write_job_summary(
                output_path, "rand", group_name, out_series, {
                    "workload": "randoms",
                    "processing_id": self._processing_id,
                    "series_name": out_series,
                    "randoms": int(len(df)),
                    "random_rate_hz": random_rate,
                    "min_separation_msec": min_separation_msec,
                    "edge_exclusion_msec": edge_exclusion_msec,
                })
        return df if lgc_output else None

    def read_random_traces(self, df: pd.DataFrame, trace_length_samples: int,
                           pretrigger_length_samples: int,
                           channels: Optional[Sequence[str]] = None
                           ) -> np.ndarray:
        """Read the windowed traces for sampled randoms → [B, C, N]
        (the trace-fetch step of Noise._get_traces, core/noise.py:501-682)."""
        out = []
        files_by_event = {}
        for _, row in df.iterrows():
            start = int(row["trigger_index"]) - pretrigger_length_samples
            tr = self._reader.read_single_event(
                int(row["event_number"]),
                file_name=self._file_for(row),
                channels=channels,
                trace_window=(start, trace_length_samples))
            traces, _ = tr
            if traces.shape[-1] == trace_length_samples:
                out.append(traces)
        return np.stack(out) if out else np.zeros((0, 0, 0))

    def _file_for(self, row) -> str:
        for f in self._reader.files:
            md = self._reader.get_metadata(f)
            if (int(md.get("series_num", -1)) == int(row["series_number"])
                    and int(md.get("dump_num", -1)) == int(row["dump_number"])):
                return f
        return self._reader.files[0]
