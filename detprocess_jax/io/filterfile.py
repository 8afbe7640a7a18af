"""Filter-file store: tagged templates, PSDs/CSDs, dPdI, IV/dIdV results.

Equivalent of the reference FilterData + pytesio.FilterH5IO
(detprocess/core/filterdata.py:218-302, :604-633). The on-disk schema is
kept interoperable in spirit:

    /{channel}/{param}_{tag}            — dataset(s) for the value
    /{channel}/{param}_{tag}/_metadata  — attrs dict

Values may be:
- 1-D arrays with an index axis (stored as ``values`` + ``index`` datasets,
  the reference's pd.Series convention — e.g. ``template_default`` indexed
  by time, ``psd_default`` indexed by two-sided frequency)
- n-D arrays (e.g. ``csd_default`` [C, C, N])
- tabular data (dict of 1-D columns / pandas DataFrame)
- plain scalar dicts (fit results) stored as attrs

Naming follows the reference appendix (SURVEY.md): ``template_{tag}``,
``psd_{tag}``, ``csd_{tag}``, ``dpdi_{n}poles_{tag}``,
``ivsweep_data_{tag}``, ``ivsweep_results_{noise,didv}_{tag}``,
``didv_results_{n}poles_{kind}_{tag}``.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import pandas as pd

from detprocess_jax.utils import freq as frequtils


def _is_tabular(value) -> bool:
    return isinstance(value, (pd.DataFrame,)) or (
        isinstance(value, dict)
        and value
        and all(isinstance(v, (list, np.ndarray)) for v in value.values())
    )


def check_fs_consistent(fs_raw, metadata, what, channel, tag):
    """Raise if a filter-data item's stored sample_rate disagrees with
    the raw data's (reference processing_data.py:303-318 consistency
    checks) — a silent mismatch produces wrong physics, not an error.
    Shared by the trigger and feature pipelines so the check cannot
    drift between them."""
    got = (metadata or {}).get("sample_rate")
    if got and float(got) != float(fs_raw):
        raise ValueError(
            f"sample rate is not consistent between raw data "
            f"({float(fs_raw):g} Hz) and {what} ({float(got):g} Hz) "
            f"for channel {channel} (tag '{tag}')")


class FilterData:
    """In-memory tagged store + HDF5 persistence."""

    def __init__(self, verbose: bool = True):
        self._verbose = verbose
        self._filter_data: dict = {}

    # ------------------------------------------------------------------
    # generic access
    # ------------------------------------------------------------------
    @property
    def data(self) -> dict:
        return self._filter_data

    def channels(self):
        return list(self._filter_data.keys())

    # -- plotting delegates (reference FilterData plotters,
    # filterdata.py:1403-1604; implementations in utils.plotting) --------
    def plot_template(self, channels, tag="default", ax=None):
        from detprocess_jax.utils import plotting
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            ax = plotting.plot_template(self, chan, tag=tag, ax=ax)
        return ax

    def plot_psd(self, channels, tag="default", fold=True, ax=None):
        from detprocess_jax.utils import plotting
        return plotting.plot_psd(self, channels, tag=tag, fold=fold, ax=ax)

    def plot_csd(self, channels, tag="default", ax=None):
        from detprocess_jax.utils import plotting
        return plotting.plot_csd(self, channels, tag=tag, ax=ax)

    def plot_corrcoeff(self, channels, tag="default", lgcsmooth=True,
                       nwindow=7, ax=None):
        from detprocess_jax.utils import plotting
        return plotting.plot_corrcoeff(self, channels, tag=tag,
                                       lgcsmooth=lgcsmooth,
                                       nwindow=nwindow, ax=ax)

    def plot_ivsweep_offset(self, channel, tag="default", ax=None):
        from detprocess_jax.utils import plotting
        return plotting.plot_ivsweep_offset(self, channel, tag=tag, ax=ax)

    def describe(self, channels=None):
        """Print the store contents, grouped per channel with type,
        shape, and key metadata — sample rate, pretrigger, SC/normal
        point counts for sweep data (FilterData.describe,
        filterdata.py:50-177). ``channels`` filters by substring."""
        if isinstance(channels, str):
            channels = [channels]
        shown = [c for c in self._filter_data
                 if channels is None
                 or any(u in c for u in channels)]
        print(f"List of channels: {shown}")
        for chan in shown:
            params = self._filter_data[chan]
            print(f"\nChannel {chan}:")
            for name, val in params.items():
                if name.endswith("_metadata") or name.endswith("_inds"):
                    continue
                if isinstance(val, pd.Series):
                    kind = "pandas.Series"
                elif isinstance(val, pd.DataFrame):
                    kind = "pandas.DataFrame"
                elif isinstance(val, np.ndarray):
                    kind = f"{val.ndim}D numpy.array"
                else:
                    kind = type(val).__name__
                shape = getattr(val, "shape", None)
                msg = f" * {name}: {kind}"
                if shape is not None:
                    msg += f" {tuple(shape)}"
                md = params.get(name + "_metadata") or {}
                extras = []
                if "sample_rate" in md:
                    extras.append(f"fs={float(md['sample_rate']):g} Hz")
                if "nb_pretrigger_samples" in md:
                    extras.append(
                        f"pretrigger={int(md['nb_pretrigger_samples'])}")
                if (name.startswith("ivsweep_data")
                        and isinstance(val, pd.DataFrame)
                        and "state" in val.columns):
                    st = val["state"].astype(str)
                    extras.append(f"SC points={int((st == 'sc').sum())}")
                    extras.append(
                        f"normal points={int((st == 'normal').sum())}")
                if extras:
                    msg += "  [" + ", ".join(extras) + "]"
                print(msg)

    def _set(self, channel: str, name: str, value, metadata: Optional[dict],
             index=None):
        chan_dict = self._filter_data.setdefault(channel, {})
        if index is not None and isinstance(value, np.ndarray) and value.ndim == 1:
            value = pd.Series(value, index=index)
        chan_dict[name] = value
        md = copy.deepcopy(metadata) if metadata else {}
        md.setdefault("channel", channel)
        chan_dict[name + "_metadata"] = md

    def _get(self, channel: str, name: str, return_metadata: bool = False):
        if channel not in self._filter_data:
            raise KeyError(f"no data for channel {channel}")
        chan_dict = self._filter_data[channel]
        if name not in chan_dict:
            raise KeyError(f'no parameter "{name}" for channel {channel}')
        value = chan_dict[name]
        if return_metadata:
            return value, chan_dict.get(name + "_metadata", {})
        return value

    def has(self, channel: str, name: str) -> bool:
        return name in self._filter_data.get(channel, {})

    def clear_data(self, channels=None, tag=None):
        """Clear stored data (reference FilterData.clear_data,
        filterdata.py:179-213).

        - no arguments: clear everything
        - ``channels``: drop those channels entirely
        - ``channels`` + ``tag``: drop every parameter of those channels
          whose name contains ``tag`` (substring match, like the
          reference)
        """
        if channels is None and tag is not None:
            raise ValueError(
                'ERROR: "channels" argument needed when "tag" is provided')
        if channels is None:
            self._filter_data = {}
            return
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            if chan not in self._filter_data:
                continue
            if tag is None:
                self._filter_data.pop(chan)
            else:
                for key in list(self._filter_data[chan].keys()):
                    if tag in key:
                        self._filter_data[chan].pop(key)

    def set_data(self, data: dict, overwrite: bool = False):
        """Merge a raw ``{channel: {param: value}}`` dict into the store
        (reference FilterData.set_data, filterdata.py:248-272): existing
        parameters are kept unless ``overwrite``."""
        if not isinstance(data, dict):
            raise ValueError("ERROR: filter data should be a dictionary!")
        if not self._filter_data:
            self._filter_data.update(data)
            return
        for chan, params in data.items():
            if chan not in self._filter_data:
                self._filter_data[chan] = params
                continue
            for name, value in params.items():
                if overwrite or name not in self._filter_data[chan]:
                    self._filter_data[chan][name] = value

    # ------------------------------------------------------------------
    # templates
    # ------------------------------------------------------------------
    def set_template(self, channels, template: np.ndarray,
                     sample_rate: float,
                     pretrigger_length_samples: Optional[int] = None,
                     pretrigger_length_msec: Optional[float] = None,
                     tag: str = "default", metadata: Optional[dict] = None):
        """Store a time-domain template (filterdata.py:539-632 semantics).

        For multi-template channels pass [C, M, N] (or [M, N] for 1 channel);
        1-D arrays are single templates.
        """
        template = np.asarray(template)
        nbins = template.shape[-1]
        if pretrigger_length_samples is None:
            if pretrigger_length_msec is None:
                raise ValueError("pretrigger length required")
            pretrigger_length_samples = int(
                round(pretrigger_length_msec * 1e-3 * sample_rate))
        md = dict(metadata or {})
        md.update({
            "sample_rate": sample_rate,
            "nb_samples": nbins,
            "nb_pretrigger_samples": int(pretrigger_length_samples),
        })
        t = np.arange(nbins) / sample_rate
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            if template.ndim == 1:
                self._set(chan, f"template_{tag}", template.copy(), md, index=t)
            else:
                self._set(chan, f"template_{tag}", template.copy(), md)

    def get_template(self, channel, tag: str = "default",
                     return_metadata: bool = False):
        val, md = self._get(channel, f"template_{tag}", return_metadata=True)
        if isinstance(val, pd.Series):
            arr, time = val.to_numpy(), val.index.to_numpy()
        else:
            arr = np.asarray(val)
            fs = md.get("sample_rate")
            time = np.arange(arr.shape[-1]) / fs if fs else None
        if return_metadata:
            return arr, time, md
        return arr, time

    # ------------------------------------------------------------------
    # PSD / CSD
    # ------------------------------------------------------------------
    def set_psd(self, channels, psd: np.ndarray, sample_rate: float,
                tag: str = "default", metadata: Optional[dict] = None):
        """Store a TWO-SIDED PSD (the reference rejects folded PSDs,
        filterdata.py:674-676)."""
        psd = np.asarray(psd)
        n = psd.shape[-1]
        freqs = frequtils.fftfreq(n, sample_rate)
        md = dict(metadata or {})
        md.update({"sample_rate": sample_rate, "nb_samples": n})
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            self._set(chan, f"psd_{tag}", psd.copy(), md, index=freqs)

    def get_psd(self, channel, tag: str = "default", fold: bool = False,
                return_metadata: bool = False):
        val, md = self._get(channel, f"psd_{tag}", return_metadata=True)
        if isinstance(val, pd.Series):
            psd, freqs = val.to_numpy(), val.index.to_numpy()
        else:
            psd = np.asarray(val)
            fs = md.get("sample_rate")
            freqs = frequtils.fftfreq(psd.shape[-1], fs)
        if fold:
            fs = md.get("sample_rate",
                        frequtils.estimate_sampling_rate(freqs))
            freqs, psd = frequtils.fold_spectrum(psd, fs)
        if return_metadata:
            return psd, freqs, md
        return psd, freqs

    def set_csd(self, channels, csd: np.ndarray, sample_rate: float,
                tag: str = "default", metadata: Optional[dict] = None):
        """Store a two-sided CSD [C, C, N] for a compound channel
        'ch1|ch2|...' (filterdata.py:806-828)."""
        csd = np.asarray(csd)
        md = dict(metadata or {})
        md.update({"sample_rate": sample_rate, "nb_samples": csd.shape[-1]})
        chan = channels if isinstance(channels, str) else "|".join(channels)
        self._set(chan, f"csd_{tag}", csd.copy(), md)

    def get_csd(self, channel, tag: str = "default", fold: bool = False,
                return_metadata: bool = False):
        val, md = self._get(channel, f"csd_{tag}", return_metadata=True)
        csd = np.asarray(val)
        fs = md.get("sample_rate")
        freqs = frequtils.fftfreq(csd.shape[-1], fs) if fs else None
        if fold:
            freqs, csd = frequtils.fold_spectrum(csd, fs)
        if return_metadata:
            return csd, freqs, md
        return csd, freqs

    # ------------------------------------------------------------------
    # dPdI
    # ------------------------------------------------------------------
    def set_dpdi(self, channels, dpdi: np.ndarray, freqs: np.ndarray,
                 poles: int, tag: str = "default",
                 metadata: Optional[dict] = None):
        md = dict(metadata or {})
        md["poles"] = int(poles)
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            # complex values stored as a 2-column (re, im) series pair
            self._set(chan, f"dpdi_{poles}poles_{tag}",
                      np.asarray(dpdi), md)
            self._set(chan, f"dpdi_{poles}poles_{tag}_freqs",
                      np.asarray(freqs), md)

    def get_dpdi(self, channel, poles: int, tag: str = "default",
                 return_metadata: bool = False):
        dpdi, md = self._get(channel, f"dpdi_{poles}poles_{tag}",
                             return_metadata=True)
        freqs = self._get(channel, f"dpdi_{poles}poles_{tag}_freqs")
        if return_metadata:
            return np.asarray(dpdi), np.asarray(freqs), md
        return np.asarray(dpdi), np.asarray(freqs)

    # ------------------------------------------------------------------
    # IV sweep / dIdV results (tabular & dict payloads)
    # ------------------------------------------------------------------
    @property
    def verbose(self) -> bool:
        """Verbosity flag (reference FilterData property,
        filterdata.py:43-48)."""
        return self._verbose

    @verbose.setter
    def verbose(self, value: bool):
        self._verbose = bool(value)

    def set_ivsweep_data_from_dict(self, data_dict: dict,
                                   tag: str = "default"):
        """Store sweep dataframes from {channel: dataframe}
        (filterdata.py:968-976)."""
        for chan, df in data_dict.items():
            self.set_ivsweep_data(chan, df, tag=tag)

    def set_ivsweep_data(self, channel, df: pd.DataFrame,
                         tag: str = "default",
                         metadata: Optional[dict] = None):
        self._set(channel, f"ivsweep_data_{tag}", df, metadata)

    def get_ivsweep_data(self, channel, tag: str = "default"):
        return self._get(channel, f"ivsweep_data_{tag}")

    def set_ivsweep_results(self, channel, results: dict, measurement: str,
                            tag: str = "default",
                            metadata: Optional[dict] = None):
        self._set(channel, f"ivsweep_results_{measurement}_{tag}",
                  results, metadata)

    def get_ivsweep_results(self, channel, measurement: str,
                            tag: str = "default"):
        return self._get(channel, f"ivsweep_results_{measurement}_{tag}")

    def set_didv_results(self, channel, results: dict, poles: int,
                         tag: str = "default",
                         metadata: Optional[dict] = None):
        self._set(channel, f"didv_results_{poles}poles_{tag}",
                  results, metadata)

    def get_didv_results(self, channel, poles: int, tag: str = "default"):
        return self._get(channel, f"didv_results_{poles}poles_{tag}")

    def set_didv_dataframe(self, channel, dataframe: pd.DataFrame,
                           metadata: Optional[dict] = None,
                           tag: str = "default"):
        """Store a dIdV-processing dataframe under
        ``didv_processing_{tag}`` (filterdata.py:1296-1322)."""
        if not isinstance(dataframe, pd.DataFrame):
            raise ValueError("ERROR: Input is not a pandas DataFrame!")
        self._set(channel, f"didv_processing_{tag}", dataframe, metadata)

    def get_didv_dataframe(self, channel, tag: str = "default"):
        """Get the dIdV-processing dataframe (filterdata.py:1324-1347)."""
        return self._get(channel, f"didv_processing_{tag}")

    def set_noise_dataframe(self, channel, dataframe: pd.DataFrame,
                            metadata: Optional[dict] = None,
                            tag: str = "default"):
        """Store a noise-processing dataframe under
        ``noise_processing_{tag}`` (filterdata.py:1349-1377)."""
        if not isinstance(dataframe, pd.DataFrame):
            raise ValueError("ERROR: Input is not a pandas DataFrame!")
        self._set(channel, f"noise_processing_{tag}", dataframe, metadata)

    def get_noise_dataframe(self, channel, tag: str = "default"):
        """Get the noise-processing dataframe (filterdata.py:1379-1401)."""
        return self._get(channel, f"noise_processing_{tag}")

    # ------------------------------------------------------------------
    # HDF5 persistence
    # ------------------------------------------------------------------
    def save_hdf5(self, path: str, overwrite: bool = True):
        import h5py
        mode = "w" if overwrite else "a"
        with h5py.File(path, mode) as f:
            for chan, params in self._filter_data.items():
                cg = f.require_group(chan)
                for name, value in params.items():
                    if name.endswith("_metadata"):
                        continue
                    if name in cg:
                        del cg[name]
                    g = cg.create_group(name)
                    md = params.get(name + "_metadata", {}) or {}
                    self._write_value(g, value)
                    mg = g.create_group("_metadata")
                    for k, v in md.items():
                        if v is None:
                            continue
                        try:
                            mg.attrs[k] = v
                        except TypeError:
                            mg.attrs[k] = str(v)
        if self._verbose:
            print(f"INFO: filter data saved to {path}")

    def load_hdf5(self, path: str, overwrite: bool = False):
        import h5py
        with h5py.File(path, "r") as f:
            for chan in f:
                cg = f[chan]
                chan_dict = self._filter_data.setdefault(chan, {})
                for name in cg:
                    if not overwrite and name in chan_dict:
                        continue
                    g = cg[name]
                    chan_dict[name] = self._read_value(g)
                    md = {}
                    if "_metadata" in g:
                        md = dict(g["_metadata"].attrs)
                    chan_dict[name + "_metadata"] = md
        return self

    @staticmethod
    def _write_value(g: h5py.Group, value):
        if isinstance(value, pd.Series):
            g.attrs["__type__"] = "series"
            FilterData._write_array(g, "values", value.to_numpy())
            g.create_dataset("index", data=value.index.to_numpy())
        elif isinstance(value, pd.DataFrame):
            g.attrs["__type__"] = "dataframe"
            cols = g.create_group("columns")
            written = []
            for col in value.columns:
                arr = value[col].to_numpy()
                if arr.dtype == object:
                    # array-valued cells (e.g. per-bias-point PSDs in
                    # IV-sweep dataframes): pad-stack equal-width rows,
                    # NaN rows for missing entries; skip nested objects
                    rows = [np.asarray(v) for v in arr
                            if isinstance(v, np.ndarray)]
                    if rows and all(r.ndim == 1 for r in rows):
                        width = max(r.shape[0] for r in rows)
                        dt = (complex if any(np.iscomplexobj(r)
                                             for r in rows) else float)
                        stack = np.full((len(arr), width), np.nan,
                                        dtype=dt)
                        lengths = np.zeros(len(arr), dtype=np.int64)
                        for i, v in enumerate(arr):
                            if isinstance(v, np.ndarray):
                                stack[i, : v.shape[0]] = v
                                lengths[i] = v.shape[0]
                        sub = cols.create_group(str(col))
                        sub.attrs["__array_rows__"] = True
                        FilterData._write_array(sub, "stack", stack)
                        sub.create_dataset("lengths", data=lengths)
                        written.append(str(col))
                        continue
                    if not all(isinstance(v, (str, bytes, int, float,
                                              np.floating, np.integer,
                                              type(None), bool))
                               for v in arr):
                        continue      # unserializable (fit objects etc.)
                FilterData._write_array(cols, str(col), arr)
                written.append(str(col))
            g.attrs["__columns__"] = written
        elif isinstance(value, np.ndarray):
            g.attrs["__type__"] = "array"
            FilterData._write_array(g, "values", value)
        elif isinstance(value, dict):
            g.attrs["__type__"] = "dict"
            FilterData._write_dict(g.create_group("values"), value)
        else:
            g.attrs["__type__"] = "scalar"
            g.attrs["value"] = value

    @staticmethod
    def _write_dict(vg: h5py.Group, value: dict):
        """Dict payloads: scalars as attrs, arrays as datasets, nested
        dicts (e.g. didv_results['smallsignalparams']) as __subdict__
        groups so they roundtrip as real dicts."""
        for k, v in value.items():
            if isinstance(v, dict):
                sub = vg.create_group(str(k))
                sub.attrs["__subdict__"] = True
                FilterData._write_dict(sub, v)
            elif isinstance(v, (np.ndarray, list)):
                FilterData._write_array(vg, str(k), np.asarray(v))
            elif v is None:
                continue
            else:
                try:
                    vg.attrs[str(k)] = v
                except TypeError:
                    vg.attrs[str(k)] = str(v)

    @staticmethod
    def _read_dict(vg: h5py.Group) -> dict:
        import h5py
        out = dict(vg.attrs)
        out.pop("__subdict__", None)
        for k in vg:
            node = vg[k]
            if (isinstance(node, h5py.Group)
                    and node.attrs.get("__subdict__")):
                out[k] = FilterData._read_dict(node)
            else:
                out[k] = FilterData._read_array(node)
        return out

    @staticmethod
    def _write_array(parent, name, arr: np.ndarray):
        arr = np.asarray(arr)
        if arr.dtype == object:
            arr = np.asarray(["" if v is None else str(v)
                              for v in arr], dtype="S")
        if np.iscomplexobj(arr):
            # complex stored as re/im pair for h5 portability
            g = parent.create_group(name)
            g.attrs["__complex__"] = True
            g.create_dataset("re", data=arr.real)
            g.create_dataset("im", data=arr.imag)
        else:
            parent.create_dataset(name, data=arr)

    @staticmethod
    def _read_array(node):
        import h5py
        if isinstance(node, h5py.Group) and node.attrs.get("__complex__"):
            return node["re"][...] + 1j * node["im"][...]
        arr = node[...]
        if arr.dtype.kind == "S":
            arr = arr.astype(str)
        return arr

    @staticmethod
    def _read_value(g: h5py.Group):
        import h5py
        kind = g.attrs.get("__type__", "array")
        if kind == "series":
            return pd.Series(FilterData._read_array(g["values"]),
                             index=g["index"][...])
        if kind == "dataframe":
            cols = g.attrs["__columns__"]
            data = {}
            for c in cols:
                node = g["columns"][c]
                if (isinstance(node, h5py.Group)
                        and node.attrs.get("__array_rows__")):
                    stack = FilterData._read_array(node["stack"])
                    lengths = node["lengths"][...]
                    data[c] = [stack[i, : lengths[i]] if lengths[i] > 0
                               else None for i in range(len(lengths))]
                else:
                    data[c] = FilterData._read_array(node)
            return pd.DataFrame(data)
        if kind == "array":
            return FilterData._read_array(g["values"])
        if kind == "dict":
            return FilterData._read_dict(g["values"])
        if kind == "scalar":
            return g.attrs["value"]
        raise ValueError(f"unknown stored type: {kind}")
