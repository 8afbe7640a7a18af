"""Raw detector data IO: pytesdaq-format HDF5 reader/writer + group maps.

Host-side replacement for pytesio.H5Reader and the reference's RawData
directory scanner (detprocess/core/rawdata.py). The on-disk layout follows
the pytesdaq conventions the reference reads directly
(rawdata.py:287-303): one HDF5 file per dump with

    /adc1                        group
        attrs: nb_events, nb_samples, sample_rate, nb_channels,
               adc_conversion_factor (volts/bit), voltage_range, ...
        event_{k}  [C, N] datasets (int16 ADC codes or float amps),
            attrs: event_id, event_time, event_num, trigger_type, ...
    /detconfig1                  group — per-channel detector settings
        attrs: channel_list, tes_bias, output_gain, close_loop_norm, ...
    file attrs: series_name, series_num, dump_num, facility, data_type,
                data_purpose, group_name

Filenames: ``{prefix}_{series}_F{dump:04d}.hdf5`` with series
``I{fac}_D{yyyymmdd}_T{hhmmss}`` and prefixes cont_/calib_/iv_/didv_/
exttrig_/rand_/threshtrig_... (rawdata.py:443-548). "restricted" data carry
``_restricted`` in the prefix.

The reader returns traces in AMPS: ``amps = adc · cal / close_loop_norm``
where cal is the ADC volts-per-bit factor — for float-stored synthetic data
the conversion is the identity.
"""

from __future__ import annotations

import glob as globmod
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from detprocess_jax.io import fastio

SERIES_RE = re.compile(r"I(\d+)_D(\d{8})_T(\d{6})")

# filename classification patterns → data type
# (mirrors the trigger-type taxonomy of rawdata.py:400-548)
DATA_TYPES = {
    "cont": "continuous",
    "rand": "rand",
    "calib": "calib",
    "iv": "iv",
    "didv": "didv",
    "exttrig": "exttrig",
    "threshtrig": "threshtrig",
    "treshtrig": "threshtrig",
}


def _open_h5(fname: str):
    """h5py.File(fname, 'r') with the FILE NAMED in the failure — a bare
    h5py OSError ('unable to synchronously open file') leaves the
    operator grepping a multi-series run for which dump is corrupt."""
    import h5py
    try:
        return h5py.File(fname, "r")
    except OSError as e:
        raise OSError(
            f"cannot open raw file '{fname}': {e} — corrupt or "
            f"truncated dump?") from None


def extract_series_name(filename: str) -> str:
    m = SERIES_RE.search(os.path.basename(filename))
    if not m:
        raise ValueError(f"no series name in {filename}")
    return f"I{m.group(1)}_D{m.group(2)}_T{m.group(3)}"


def series_to_number(series_name: str) -> int:
    m = SERIES_RE.search(series_name)
    fac, day, tme = m.groups()
    return int(fac) * 10**14 + int(day) * 10**6 + int(tme)


def series_number_to_name(series_num: int) -> str:
    """Inverse of :func:`series_to_number` (pytesio's
    extract_series_name accepts either form; core/rawdata.py:205)."""
    series_num = int(series_num)
    fac, daytime = divmod(series_num, 10**14)
    day, tme = divmod(daytime, 10**6)
    return f"I{fac}_D{day:08d}_T{tme:06d}"


def _to_units(arr: np.ndarray, conv: np.ndarray, adctoamp: bool, dtype):
    """Stored event rows [C, N] → ``dtype``, in amps (× per-row ``conv``)
    when ``adctoamp``; ``dtype=None`` keeps the stored dtype (raw mode,
    which requires ``adctoamp=False``)."""
    if dtype is None:
        if adctoamp:
            raise ValueError(
                "dtype=None (stored-dtype raw mode) requires "
                "adctoamp=False — converting to amps needs a float "
                "dtype; pass e.g. dtype=np.float32")
        return arr                              # stored dtype, no copy
    traces = arr.astype(dtype)
    if adctoamp:
        traces = traces * conv[:, None].astype(dtype)
    return traces


class RawWriter:
    """Write pytesdaq-format raw files (used for synthetic data, salting
    output and tests)."""

    def __init__(self, path: str, series_name: str, sample_rate: float,
                 channels: Sequence[str], prefix: str = "cont",
                 facility: int = 1, group_name: str = "group",
                 data_type: str = "continuous", adc_name: str = "adc1",
                 nb_pretrigger_samples: Optional[int] = None,
                 detector_config: Optional[Dict[str, dict]] = None,
                 fridge_run: Optional[int] = None,
                 series_start_time: Optional[int] = None,
                 group_start_time: Optional[int] = None,
                 fridge_run_start_time: Optional[int] = None,
                 adc_conversion_factor: Optional[float] = None):
        self.path = path
        self.series_name = series_name
        self.sample_rate = float(sample_rate)
        self.channels = list(channels)
        self.prefix = prefix
        self.facility = facility
        self.group_name = group_name
        self.data_type = data_type
        self.adc_name = adc_name
        self.nb_pretrigger_samples = nb_pretrigger_samples
        self.detector_config = detector_config or {}
        self.fridge_run = fridge_run
        self.series_start_time = series_start_time
        self.group_start_time = group_start_time
        self.fridge_run_start_time = fridge_run_start_time
        # int16 ADC-code storage (real pytesdaq layout): traces are
        # quantized as codes = rint(amps · close_loop_norm / cal) with
        # cal = adc_conversion_factor (volts/bit) and per-channel
        # close_loop_norm from detector_config. Readers recover
        # amps = codes · cal / close_loop_norm — and pipelines can upload
        # the int16 codes and convert on device (half the bytes).
        self.adc_conversion_factor = adc_conversion_factor
        os.makedirs(path, exist_ok=True)

    def _channel_conv(self) -> np.ndarray:
        """Per-channel ADC→amps factor cal/close_loop_norm [C]."""
        cal = float(self.adc_conversion_factor)
        cln = np.array([
            float((self.detector_config.get(c) or {}).get(
                "close_loop_norm", 1.0)) or 1.0
            for c in self.channels])
        return cal / cln

    def file_name(self, dump_num: int) -> str:
        return os.path.join(
            self.path,
            f"{self.prefix}_{self.series_name}_F{dump_num:04d}.hdf5")

    def write_dump(self, traces: np.ndarray, dump_num: int = 1,
                   event_times: Optional[np.ndarray] = None,
                   trigger_types: Optional[np.ndarray] = None,
                   start_time: float = 0.0) -> str:
        """traces [nb_events, C, N] float amps. Returns the file path."""
        traces = np.asarray(traces)
        nb_events, nchan, nsamp = traces.shape
        if nchan != len(self.channels):
            raise ValueError(
                f"traces have {nchan} channels, writer configured with "
                f"{len(self.channels)}")
        fname = self.file_name(dump_num)
        import h5py
        with h5py.File(fname, "w") as f:
            f.attrs["series_name"] = self.series_name
            f.attrs["series_num"] = series_to_number(self.series_name)
            f.attrs["dump_num"] = dump_num
            f.attrs["facility"] = self.facility
            f.attrs["data_type"] = self.data_type
            f.attrs["data_purpose"] = self.data_type
            f.attrs["group_name"] = self.group_name
            f.attrs["daq_version"] = "detprocess_jax"
            for key in ("fridge_run", "series_start_time",
                        "group_start_time", "fridge_run_start_time"):
                val = getattr(self, key)
                if val is not None:
                    f.attrs[key] = int(val)
            g = f.create_group(self.adc_name)
            g.attrs["nb_events"] = nb_events
            g.attrs["nb_samples"] = nsamp
            g.attrs["nb_channels"] = nchan
            g.attrs["sample_rate"] = self.sample_rate
            if self.nb_pretrigger_samples is not None:
                g.attrs["nb_pretrigger_samples"] = int(
                    self.nb_pretrigger_samples)
            g.attrs["channel_list"] = self.channels
            if self.adc_conversion_factor is None:
                # float mode: cal=1, but readers ALWAYS recover
                # amps = stored·cal/close_loop_norm (real pytesdaq files
                # are ADC codes, the reader cannot distinguish), so store
                # amps·close_loop_norm for an exact round trip when the
                # detector_config carries a real close_loop_norm
                g.attrs["adc_conversion_factor"] = 1.0
                cln = np.array([
                    float((self.detector_config.get(c) or {}).get(
                        "close_loop_norm", 1.0)) or 1.0
                    for c in self.channels])
                stored = (traces * cln[None, :, None]).astype(np.float32)
            else:
                g.attrs["adc_conversion_factor"] = float(
                    self.adc_conversion_factor)
                conv = self._channel_conv()
                codes = np.rint(traces / conv[None, :, None])
                if np.abs(codes).max(initial=0) > np.iinfo(np.int16).max:
                    raise ValueError(
                        "int16 ADC overflow: max |code| "
                        f"{np.abs(codes).max():.0f} > 32767 — raise "
                        "adc_conversion_factor (volts/bit) or "
                        "close_loop_norm")
                stored = codes.astype(np.int16)
            g.attrs["dataset_prefix"] = "event_"
            for i in range(nb_events):
                ds = g.create_dataset(f"event_{i + 1}",
                                      data=stored[i])
                ds.attrs["event_id"] = i + 1
                ds.attrs["event_num"] = i + 1
                ds.attrs["event_time"] = (
                    start_time + (event_times[i] if event_times is not None
                                  else i * nsamp / self.sample_rate))
                ds.attrs["trigger_type"] = (
                    int(trigger_types[i]) if trigger_types is not None else 1)
            dc = f.create_group("detconfig1")
            dc.attrs["channel_list"] = self.channels
            for chan, cfg in self.detector_config.items():
                cg = dc.create_group(chan)
                for k, v in cfg.items():
                    cg.attrs[k] = v
        return fname


class RawReader:
    """Event reader over one or more pytesdaq-format files.

    Replaces pytesio.H5Reader usage (processing_data.py:100, :520-526):
    sequential `read_next_event`, random-access `read_single_event`
    (windowed reads for trigger-dataframe-driven feature extraction), and
    batched `read_many_events`.
    """

    def __init__(self, files: Sequence[str] | str, adc_name: str = "adc1"):
        if isinstance(files, str):
            files = [files]
        self.files = sorted(files)
        self.adc_name = adc_name
        self._file_idx = 0
        self._event_idx = 0
        self._h5 = None
        self._ra_file = None          # cached random-access handle
        self._ra_name = None
        self._ra_ds: Dict[int, object] = {}      # event dataset handles
        self._ra_fast: Dict[int, object] = {}    # resolved fast entries
        self._file_admin_cache: Dict[str, dict] = {}
        self._event_admin_cache: Dict[tuple, dict] = {}
        self._meta_cache: Dict[str, dict] = {}
        self._event_name_cache: Dict[str, dict] = {}
        self._fast = fastio.FastReader()

    def _event_dataset(self, f, fname: str, event_number: int):
        """Dataset for a given event NUMBER.

        Fast path assumes the pytesdaq ``event_{num}`` naming with
        file-local numbering (our RawWriter and common DAQ output). Real
        files may number events globally across dumps, so if the named
        dataset is absent or its ``event_num`` attribute disagrees, fall
        back to a lazily built per-file {event_num: dataset_name} map.
        """
        g = f[self.adc_name]
        name = f"event_{event_number}"
        if name in g:
            ds = g[name]
            if int(ds.attrs.get("event_num", event_number)) == int(
                    event_number):
                return ds
        emap = self._event_name_cache.get(fname)
        if emap is None:
            emap = {}
            for key in g:
                try:
                    emap[int(g[key].attrs.get("event_num", -1))] = key
                except (ValueError, TypeError):
                    continue
            self._event_name_cache[fname] = emap
        if int(event_number) not in emap:
            raise KeyError(
                f"no event with event_num={event_number} in {fname}")
        return g[emap[int(event_number)]]

    # -- metadata ------------------------------------------------------
    def get_metadata(self, file_name: Optional[str] = None) -> dict:
        file_name = file_name or self.files[0]
        if file_name in self._meta_cache:
            return self._meta_cache[file_name]
        with _open_h5(file_name) as f:
            g = f[self.adc_name]
            md = dict(f.attrs)
            md.update({k: g.attrs[k] for k in g.attrs})
            if "channel_list" in md:
                md["channel_list"] = [str(c) for c in md["channel_list"]]
            det = {}
            if "detconfig1" in f:
                dc = f["detconfig1"]
                for chan in dc:
                    det[chan] = dict(dc[chan].attrs)
            md["detector_config"] = det
        self._meta_cache[file_name] = md
        return md

    @property
    def raw_path(self):
        """Directory holding the raw files (one path when they share a
        directory, else the sorted unique list) — the reference exposes
        the equivalent via ProcessingData.get_raw_path
        (processing_data.py:500-503)."""
        dirs = sorted({os.path.dirname(os.path.abspath(f))
                       for f in self.files})
        return dirs[0] if len(dirs) == 1 else dirs

    @property
    def sample_rate(self) -> float:
        return float(self.get_metadata()["sample_rate"])

    @property
    def channels(self) -> List[str]:
        return list(self.get_metadata()["channel_list"])

    def nb_events(self, file_name: Optional[str] = None) -> int:
        return int(self.get_metadata(file_name)["nb_events"])

    def total_events(self) -> int:
        return sum(self.nb_events(f) for f in self.files)

    def split(self, n: int) -> List["RawReader"]:
        """N independent readers over disjoint subsets of this reader's
        files — the file-level analog of the reference's series split
        across Pool workers (process/features.py:1137-1171). Files are
        grouped by series and series round-robined across readers (so
        each reader walks whole series in order, like a Pool worker);
        when there are fewer series than readers the split falls back to
        round-robin over files. Returns at most ``min(n, len(files))``
        readers; each has its OWN h5py/fastio handles, so they are safe
        to drive from concurrent threads.
        """
        n = max(1, min(int(n), len(self.files)))
        if n == 1:
            return [RawReader(self.files, self.adc_name)]
        groups: Dict[str, List[str]] = {}
        for f in self.files:
            groups.setdefault(extract_series_name(os.path.basename(f)),
                              []).append(f)
        subsets: List[List[str]] = [[] for _ in range(n)]
        if len(groups) >= n:
            for i, k in enumerate(sorted(groups)):
                subsets[i % n].extend(groups[k])
        else:
            for i, f in enumerate(self.files):
                subsets[i % n].append(f)
        return [RawReader(s, self.adc_name) for s in subsets if s]

    # -- sequential reading --------------------------------------------
    def rewind(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        self._file_idx = 0
        self._event_idx = 0

    def close(self):
        if self._ra_file is not None:
            self._ra_file.close()
            self._ra_file = None
            self._ra_name = None
            self._ra_ds = {}
            self._ra_fast = {}
        self._fast.close()

    def read_next_event(self, channels: Optional[Sequence[str]] = None,
                        dtype=np.float64, adctoamp: bool = True):
        """Returns (traces [C, N] amps, admin dict) or (None, None) at end.

        ``dtype``: host dtype of the returned traces. float64 default
        (analysis pipelines compare against float64 goldens); the
        trigger pipeline requests float32 — its device math is float32
        anyway, and converting at read time halves the host copies and
        the stack before upload.

        ``adctoamp=False, dtype=None``: RAW mode — traces come back in
        the STORED dtype with no host conversion at all (int16 ADC codes
        for real pytesdaq data), and the admin dict carries the
        per-channel conversion factors as ``admin["adc_conv"]``
        (amps = stored · conv). Pipelines upload the codes and convert
        ON DEVICE: half the host→device bytes and one fewer host copy
        per event (the reference always converts on host via pytesio,
        processing_data.py:520-526)."""
        while True:
            if self._file_idx >= len(self.files):
                return None, None
            fname = self.files[self._file_idx]
            if self._h5 is None:
                self._h5 = _open_h5(fname)
            g = self._h5[self.adc_name]
            nev = int(g.attrs["nb_events"])
            if self._event_idx >= nev:
                self._h5.close()
                self._h5 = None
                self._file_idx += 1
                self._event_idx = 0
                continue
            self._event_idx += 1
            return self._read_event(self._h5, fname, self._event_idx,
                                    channels, dtype=dtype,
                                    adctoamp=adctoamp)

    def read_single_event(self, event_index: int,
                          file_name: Optional[str] = None,
                          channels: Optional[Sequence[str]] = None,
                          trace_window: Optional[tuple] = None,
                          adctoamp: bool = True,
                          dtype=np.float64):
        """Random access; ``trace_window=(start, length)`` reads a truncated
        window (trigger-dataframe-driven mode,
        processing_data.py:555-705). The file handle is cached across
        calls — trigger-driven reads hit the same dump thousands of
        times in a row."""
        fname = file_name or self.files[0]
        if self._ra_name != fname:
            if self._ra_file is not None:
                self._ra_file.close()
            self._ra_file = _open_h5(fname)
            self._ra_name = fname
            self._ra_ds = {}
            self._ra_fast = {}
        ds = self._ra_ds.get(event_index)
        if ds is None:
            ds = self._event_dataset(self._ra_file, fname, event_index)
            self._ra_ds[event_index] = ds
        # cache the RESOLVED fast entry per event: fastio.resolve keys on
        # ds.name, an h5py property costing ~3 µs per access — real at
        # trigger-driven rates of 1e5 windowed reads/s
        if event_index in self._ra_fast:
            fentry = self._ra_fast[event_index]
        else:
            fentry = self._fast.resolve(fname, ds)
            self._ra_fast[event_index] = fentry
        return self._read_event(self._ra_file, fname, event_index,
                                channels, trace_window, ds=ds,
                                adctoamp=adctoamp, dtype=dtype,
                                fentry=fentry, fentry_resolved=True)

    def read_many_events(self, nevents: Optional[int] = None,
                         channels: Optional[Sequence[str]] = None):
        """Read up to nevents across all files → (traces [B, C, N], admins)."""
        out, admins = [], []
        self.rewind()
        while nevents is None or len(out) < nevents:
            tr, admin = self.read_next_event(channels)
            if tr is None:
                break
            out.append(tr)
            admins.append(admin)
        self.rewind()
        if not out:
            return np.zeros((0, 0, 0)), []
        return np.stack(out), admins

    def _read_event(self, f, fname, event_index, channels,
                    trace_window=None, ds=None, adctoamp=True,
                    dtype=np.float64, fentry=None,
                    fentry_resolved=False):
        # per-file attr values are cached — HDF5 attribute reads cost
        # ~0.1-0.3 ms each and trigger-driven windowed reads hit the
        # same file/event thousands of times in a row
        fc = self._file_admin_cache.get(fname)
        if fc is None:
            g = f[self.adc_name]
            chan_list = [str(c) for c in g.attrs["channel_list"]]
            cal = float(g.attrs.get("adc_conversion_factor", 1.0))
            # per-channel ADC→amps conversion: amps = adc·cal/close_loop_norm
            # (close_loop_norm lives in /detconfig1/{chan}; 1.0 when absent
            # — synthetic data is stored in amps with cal=1)
            cln = np.ones(len(chan_list))
            if "detconfig1" in f:
                dc = f["detconfig1"]
                for i, ch in enumerate(chan_list):
                    if ch in dc:
                        cln[i] = float(dc[ch].attrs.get(
                            "close_loop_norm", 1.0)) or 1.0
            fc = {
                "chan_list": chan_list,
                "cal": cal,
                "conv": (cal / cln),
                "admin": {
                    "series_name": str(f.attrs.get("series_name", "")),
                    "series_number": int(f.attrs.get("series_num", 0)),
                    "dump_number": int(f.attrs.get("dump_num", 0)),
                    "group_name": str(f.attrs.get("group_name", "")),
                    "data_type": str(f.attrs.get("data_type", "")),
                    "file_name": fname,
                },
            }
            for key in ("fridge_run", "series_start_time",
                        "group_start_time", "fridge_run_start_time"):
                if key in f.attrs:
                    fc["admin"]["fridge_run_number" if key == "fridge_run"
                                else key] = int(f.attrs[key])
            self._file_admin_cache[fname] = fc
        if ds is None:
            # sequential path (read_next_event): event_index is the
            # file-local ORDINAL — access by pytesdaq position naming,
            # not by event_num (real files may number events globally)
            ds = f[self.adc_name][f"event_{event_index}"]
        # pread fast path: raw event datasets are contiguous int16/f32
        # blocks — positioned reads at the resolved file offset measure
        # ~3.6x h5py's hyperslab path and hold no libhdf5 lock, so
        # prefetch threads scale (io/fastio.py; falls back to h5py for
        # chunked/compressed/compact/big-endian storage)
        if not fentry_resolved:
            fentry = self._fast.resolve(fname, ds)
        idx = ([fc["chan_list"].index(c) for c in channels]
               if channels is not None else None)
        subset_done = False
        if fentry is not None:
            # channel-subset rows pread directly (rows are contiguous):
            # bytes read scale with channels USED, not stored
            arr = self._fast.read(fentry, trace_window, rows=idx)
            subset_done = idx is not None
        elif trace_window is not None:
            start, length = trace_window
            start = max(0, int(start))
            arr = ds[:, start:start + int(length)]
        else:
            arr = ds[...]
        # conv must match the rows actually present: on the row-subset
        # pread path arr already holds only idx rows
        traces = _to_units(arr, fc["conv"][np.asarray(idx)] if subset_done
                           else fc["conv"], adctoamp, dtype)
        if idx is not None and not subset_done:
            traces = traces[idx]
        ekey = (fname, event_index)
        ev = self._event_admin_cache.get(ekey)
        if ev is None:
            ev = {
                "event_id": int(ds.attrs.get("event_id", event_index)),
                "event_number": int(ds.attrs.get("event_num",
                                                 event_index)),
                "event_time": float(ds.attrs.get("event_time", 0.0)),
                "trigger_type": int(ds.attrs.get("trigger_type", 1)),
            }
            self._event_admin_cache[ekey] = ev
        admin = dict(fc["admin"])
        admin.update(ev)
        if not adctoamp:
            # raw mode: hand the caller the per-(selected-)channel
            # ADC→amps factors so the conversion can run ON DEVICE
            conv = fc["conv"]
            if channels is not None:
                conv = conv[idx]
            admin["adc_conv"] = conv.astype(np.float32)
        return traces, admin

    def get_detector_config(self, file_name: Optional[str] = None) -> dict:
        return self.get_metadata(file_name).get("detector_config", {})


def open_reader(raw_files):
    """A reader over ``raw_files``: a :class:`RawReader` for file paths,
    or the reader itself when one (e.g. an :class:`ArrayReader`) is
    passed."""
    if hasattr(raw_files, "read_single_event"):
        return raw_files
    return RawReader(raw_files)


class ArrayReader:
    """Continuous data already in host memory, read through the
    :class:`RawReader` interface the pipelines use — for data that never
    touch a pytesdaq file (a DAQ buffer, a simulation) and for machines
    without h5py. Pipelines take it in place of a raw-file list.

    ``dumps``: one [nb_events, C, N] array of amps per dump of one
    series. With ``adc_conversion_factor`` (volts/bit) the events are
    held as int16 ADC codes, exactly as :class:`RawWriter` stores them,
    so pipelines take the raw int16 upload path. Metadata and admin
    fields match what :class:`RawReader` returns for the same data
    written by :class:`RawWriter` (event times restart at 0 per dump).
    """

    def __init__(self, dumps: Sequence[np.ndarray], series_name: str,
                 sample_rate: float, channels: Sequence[str],
                 facility: int = 1, group_name: str = "group",
                 data_type: str = "continuous", adc_name: str = "adc1",
                 adc_conversion_factor: Optional[float] = None):
        self.adc_name = adc_name
        cal = (1.0 if adc_conversion_factor is None
               else float(adc_conversion_factor))
        self._conv = np.full(len(channels), cal)
        self._events: Dict[str, np.ndarray] = {}
        self._meta: Dict[str, dict] = {}
        for d, traces in enumerate(dumps, start=1):
            traces = np.asarray(traces)
            if adc_conversion_factor is None:
                stored = traces.astype(np.float32)
            else:
                codes = np.rint(traces / cal)
                if np.abs(codes).max(initial=0) > np.iinfo(np.int16).max:
                    raise ValueError("int16 ADC overflow — raise "
                                     "adc_conversion_factor")
                stored = codes.astype(np.int16)
            name = f"cont_{series_name}_F{d:04d}"
            self._events[name] = stored
            nev, nchan, nsamp = stored.shape
            self._meta[name] = {
                "series_name": series_name,
                "series_num": series_to_number(series_name),
                "dump_num": d, "facility": facility,
                "data_type": data_type, "data_purpose": data_type,
                "group_name": group_name, "nb_events": nev,
                "nb_samples": nsamp, "nb_channels": nchan,
                "sample_rate": float(sample_rate),
                "channel_list": list(channels),
                "adc_conversion_factor": cal, "dataset_prefix": "event_",
                "detector_config": {}}
        self.files = sorted(self._events)
        self.rewind()

    raw_path = "memory"

    def get_metadata(self, file_name: Optional[str] = None) -> dict:
        return self._meta[file_name or self.files[0]]

    def get_detector_config(self, file_name: Optional[str] = None) -> dict:
        return self.get_metadata(file_name)["detector_config"]

    @property
    def sample_rate(self) -> float:
        return float(self.get_metadata()["sample_rate"])

    @property
    def channels(self) -> List[str]:
        return list(self.get_metadata()["channel_list"])

    def nb_events(self, file_name: Optional[str] = None) -> int:
        return int(self.get_metadata(file_name)["nb_events"])

    def total_events(self) -> int:
        return sum(self.nb_events(f) for f in self.files)

    def split(self, n: int) -> List["ArrayReader"]:
        """This reader alone: the data are in memory already, and
        :meth:`read_single_event` keeps no state, so concurrent workers
        can share it."""
        return [self]

    def rewind(self):
        self._pos = (0, 0)

    def close(self):
        pass

    def read_next_event(self, channels: Optional[Sequence[str]] = None,
                        dtype=np.float64, adctoamp: bool = True):
        """(traces [C, N], admin) of the next event, or (None, None)."""
        fi, ei = self._pos
        while fi < len(self.files) and ei >= self.nb_events(self.files[fi]):
            fi, ei = fi + 1, 0
        if fi >= len(self.files):
            self._pos = (fi, ei)
            return None, None
        self._pos = (fi, ei + 1)
        return self.read_single_event(ei + 1, self.files[fi], channels,
                                      adctoamp=adctoamp, dtype=dtype)

    def read_single_event(self, event_index: int,
                          file_name: Optional[str] = None,
                          channels: Optional[Sequence[str]] = None,
                          trace_window: Optional[tuple] = None,
                          adctoamp: bool = True,
                          dtype=np.float64):
        """Event number ``event_index`` (1-based) of ``file_name``;
        ``trace_window=(start, length)`` cuts a window."""
        fname = file_name or self.files[0]
        md = self._meta[fname]
        arr = self._events[fname][int(event_index) - 1]
        conv = self._conv
        if channels is not None:
            idx = np.asarray([md["channel_list"].index(c) for c in channels])
            arr, conv = arr[idx], conv[idx]
        if trace_window is not None:
            start = max(0, int(trace_window[0]))
            arr = arr[:, start:start + int(trace_window[1])]
        admin = {"series_name": md["series_name"],
                 "series_number": md["series_num"],
                 "dump_number": md["dump_num"],
                 "group_name": md["group_name"],
                 "data_type": md["data_type"], "file_name": fname,
                 "event_id": int(event_index),
                 "event_number": int(event_index),
                 "event_time": (int(event_index) - 1) * md["nb_samples"]
                 / md["sample_rate"],
                 "trigger_type": 1}
        if not adctoamp:
            admin["adc_conv"] = conv.astype(np.float32)
        return _to_units(arr, conv, adctoamp, dtype), admin


class RawData:
    """Scan a raw group directory, classify files and build series maps
    (reference: detprocess/core/rawdata.py:400-548)."""

    def __init__(self, raw_path: str, data_type: str = "continuous",
                 series: Optional[Sequence[str]] = None,
                 restricted: bool = False):
        self.raw_path = raw_path
        self.data_type = data_type
        self.restricted = restricted
        self._series_filter = set(series) if series else None
        self._file_map: Dict[str, Dict[str, List[str]]] = {}
        self._build_file_map()

    def _classify(self, filename: str) -> Optional[str]:
        base = os.path.basename(filename)
        prefix = base.split("_I")[0]
        restricted = "restricted" in prefix
        if restricted != self.restricted:
            return None
        for key, dtype in DATA_TYPES.items():
            if prefix.startswith(key):
                return dtype
        return "unknown"

    def _build_file_map(self):
        files = sorted(globmod.glob(os.path.join(self.raw_path, "*.hdf5")))
        if not files:
            # also scan subdirectories (group directories)
            files = sorted(
                globmod.glob(os.path.join(self.raw_path, "*", "*.hdf5")))
        for afile in files:
            dtype = self._classify(afile)
            if dtype is None:
                continue
            try:
                series = extract_series_name(afile)
            except ValueError:
                continue
            if self._series_filter and series not in self._series_filter:
                continue
            self._file_map.setdefault(dtype, {}).setdefault(
                series, []).append(afile)

    # -- group identity accessors (reference core/rawdata.py:83-132) ----
    @property
    def verbose(self) -> bool:
        return getattr(self, "_verbose", True)

    def get_group_name(self) -> str:
        """Raw-data group = the scanned directory's base name."""
        return os.path.basename(os.path.normpath(self.raw_path))

    def get_base_path(self) -> str:
        return os.path.dirname(os.path.normpath(self.raw_path))

    def get_facility(self) -> Optional[int]:
        """Facility number from the first series name ('I{fac}_...')."""
        for dtype_map in self._file_map.values():
            for series in dtype_map:
                m = SERIES_RE.search(series)
                if m:
                    return int(m.group(1))
        return None

    def describe(self):
        """Print the group layout (core/rawdata.py:83-103)."""
        print(f"Raw data group: {self.get_group_name()}")
        print(f"Base path: {self.get_base_path()}")
        print("Number of series:")
        for dtype, series_map in sorted(self._file_map.items()):
            if not series_map:
                continue
            label = ("restricted " if self.restricted else "") + dtype
            print(f" - {label} data: {len(series_map)} series")

    def get_data_config(self, data_type: Optional[str] = None,
                        series: Optional[str] = None) -> dict:
        """Per-series metadata map {series: {'channel_list', 'overall',
        'detector_config'}} (core/rawdata.py:173-184)."""
        out = {}
        for ser, files in self.get_data_files(data_type, series).items():
            if not files:
                continue
            md = RawReader(files[0]).get_metadata()
            out[ser] = {
                "channel_list": list(md.get("channel_list", [])),
                "detector_config": md.get("detector_config", {}),
                "overall": {k: v for k, v in md.items()
                            if k not in ("detector_config",)},
            }
        return out

    def get_available_channels(self, data_type: Optional[str] = None,
                               series: Optional[str] = None) -> List[str]:
        """Channel list of the first available series
        (core/rawdata.py:134-151)."""
        for cfg in self.get_data_config(data_type, series).values():
            return list(cfg["channel_list"])
        return []

    def get_sample_rate(self, data_type: Optional[str] = None,
                        series: Optional[str] = None) -> float:
        """Sample rate of the first available series
        (core/rawdata.py:153-171)."""
        for cfg in self.get_data_config(data_type, series).values():
            return float(cfg["overall"]["sample_rate"])
        return float("nan")

    def get_traces(self, series_nums, event_nums, channels=None,
                   adctoamp: bool = True, include_metadata: bool = False):
        """Read specific events from specific series → [nevents, C, N]
        (core/rawdata.py:186-259). ``series_nums`` accepts numbers or
        'I.._D.._T..' names; events are resolved by their event_num
        attribute across each series' dumps."""
        if not isinstance(series_nums, (list, tuple, np.ndarray)):
            series_nums = [series_nums]
        if not isinstance(event_nums, (list, tuple, np.ndarray)):
            event_nums = [event_nums]
        if len(series_nums) == 1 and len(event_nums) > 1:
            series_nums = list(series_nums) * len(event_nums)
        if len(series_nums) != len(event_nums):
            raise ValueError("series_nums and event_nums must align")
        readers: Dict[str, RawReader] = {}
        traces, admins = [], []
        for ser, ev in zip(series_nums, event_nums):
            name = (ser if isinstance(ser, str)
                    else series_number_to_name(ser))
            reader = readers.get(name)
            if reader is None:
                files = []
                for dtype_map in self._file_map.values():
                    files.extend(dtype_map.get(name, []))
                if not files:
                    raise KeyError(f"series {name} not in this group")
                reader = RawReader(sorted(files))
                readers[name] = reader
            ev = int(ev)
            tr = admin = None
            for fname in reader.files:
                try:
                    tr, admin = reader.read_single_event(
                        ev, fname, channels=channels, adctoamp=adctoamp)
                    break
                except KeyError:
                    continue
            if tr is None:
                raise KeyError(f"event_num {ev} not found in series {name}")
            traces.append(tr)
            admins.append(admin)
        for reader in readers.values():
            reader.close()
        stacked = np.stack(traces) if traces else np.zeros((0, 0, 0))
        if include_metadata:
            return stacked, admins
        return stacked

    def get_series_list(self, data_type: Optional[str] = None) -> List[str]:
        dtype = data_type or self.data_type
        return sorted(self._file_map.get(dtype, {}).keys())

    def get_data_files(self, data_type: Optional[str] = None,
                       series: Optional[str] = None):
        dtype = data_type or self.data_type
        series_map = self._file_map.get(dtype, {})
        if series is not None:
            return {series: series_map.get(series, [])}
        return dict(series_map)

    def get_duration(self, series: Optional[str] = None,
                     data_type: Optional[str] = None,
                     include_nb_events: bool = False):
        """Total duration (rawdata.py:262-311)."""
        files_by_series = self.get_data_files(data_type, series)
        nb_events = 0
        nb_samples, sample_rate = None, None
        for flist in files_by_series.values():
            for afile in flist:
                with _open_h5(afile) as f:
                    g = f["adc1"]
                    nb_events += int(g.attrs.get(
                        "nb_events",
                        sum(1 for x in g.values()
                            if hasattr(x, "shape"))))
                    if nb_samples is None:
                        nb_samples = int(g.attrs["nb_samples"])
                        sample_rate = float(g.attrs["sample_rate"])
        duration = (nb_samples / sample_rate) * nb_events if nb_events else 0.0
        if include_nb_events:
            return duration, nb_events
        return duration
