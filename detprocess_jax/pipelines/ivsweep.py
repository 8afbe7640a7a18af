"""IV/dIdV sweep processing + analysis.

Replacement for the reference IVSweepProcessing (process/ivprocess.py) and
IVSweepAnalysis (core/ivsweep.py):

- **IVSweepProcessing**: per-bias-point raw processing — noise-type series
  give autocut PSDs + DC offsets; dIdV-type series give lock-in averages —
  with SC/normal state tagging by linearity of imeas vs ibias.
- **IVSweepAnalysis**: the bias analysis (models.ivbias IBIS), per-state
  dIdV fits (batched over bias points), noise modeling across the sweep,
  and energy-resolution vs %Rn.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawReader
from detprocess_jax.models import didv as didv_models
from detprocess_jax.models import ivbias
from detprocess_jax.ops import autocuts as cuts
from detprocess_jax.ops import lockin, spectral
from detprocess_jax.utils.misc import find_linear_segment

import jax.numpy as jnp


def discover_bias_points(raw_path: str, channel: str,
                         series: Optional[Sequence[str]] = None,
                         bias_tolerance_percent: float = 1.0) -> List[dict]:
    """Scan an IV/dIdV sweep raw group and build the bias-point map.

    Equivalent of IVSweepProcessing._get_file_list
    (process/ivprocess.py:678-916): series are classified iv (noise) vs
    didv by filename prefix, the per-series ``tes_bias`` is read from the
    detector config, and iv/didv series are matched by bias within a
    tolerance. Returns the ``bias_points`` list consumed by
    IVSweepProcessing.process.
    """
    from detprocess_jax.io.rawdata import RawData, RawReader

    points: dict = {}

    def scan(data_type, key):
        rd = RawData(raw_path, data_type=data_type, series=series)
        for s, files in rd.get_data_files().items():
            if not files:
                continue
            reader = RawReader(files)
            det = reader.get_detector_config(files[0])
            cfg = det.get(channel, {})
            if "tes_bias" not in cfg:
                continue
            bias = float(cfg["tes_bias"])
            # match an existing point within tolerance
            tol = abs(bias) * bias_tolerance_percent / 100.0 + 1e-15
            for b in points:
                if abs(b - bias) <= tol:
                    bias = b
                    break
            entry = points.setdefault(bias, {"tes_bias": bias,
                                             "noise_files": [],
                                             "didv_files": []})
            entry[key].extend(files)

    scan("iv", "noise_files")
    scan("noise", "noise_files")
    scan("didv", "didv_files")
    # normal-branch first (largest |bias|), matching the analysis ordering
    return [points[b] for b in sorted(points, key=abs, reverse=True)]


class IVSweepProcessing(FilterData):
    """Raw sweep processing (process/ivprocess.py:46-1003).

    The caller supplies, per bias point, the raw files for the noise and/or
    dIdV data (the reference discovers these by scanning file metadata for
    tes_bias changes; here the mapping can also be passed directly).
    """

    def __init__(self, verbose: bool = True):
        from detprocess_jax.utils import jaxcache
        jaxcache.enable()
        super().__init__(verbose=verbose)

    def process(self,
                channel: str,
                bias_points: Sequence[dict],
                sgfreq: Optional[float] = None,
                sgamp: Optional[float] = None,
                rsh: float = 5e-3,
                nsigma_cut: float = 2.5,
                tag: str = "default") -> pd.DataFrame:
        """Process a sweep for one channel.

        bias_points: list of dicts with keys
            ``tes_bias`` [A], and either/both
            ``noise_files`` (list of raw file paths) and
            ``didv_files`` (list of raw file paths).
        Returns (and stores) the per-bias-point dataframe
        (``ivsweep_data_{tag}``).
        """
        rows: List[dict] = []
        for bp in bias_points:
            row: dict = {"tes_bias": bp["tes_bias"]}
            if bp.get("noise_files"):
                reader = RawReader(bp["noise_files"])
                fs = reader.sample_rate
                ci = reader.channels.index(channel)
                traces, _ = reader.read_many_events()
                tr = traces[:, ci, :]
                mask = np.asarray(cuts.autocuts_noise(
                    jnp.asarray(tr), nsigma=nsigma_cut))
                if not mask.any():
                    raise ValueError(
                        f"autocuts rejected all {len(mask)} noise traces "
                        f"at tes_bias={bp.get('tes_bias')} — a NaN PSD/"
                        "offset would poison the whole sweep; loosen "
                        "nsigma_cut or inspect the data")
                kept = tr[mask]
                psd = np.asarray(spectral.welch_psd(jnp.asarray(kept), fs))
                row["psd"] = psd
                row["offset_noise"] = float(kept.mean())
                row["offset_noise_err"] = float(
                    kept.mean(axis=-1).std() / np.sqrt(max(len(kept), 1)))
                row["fs"] = fs
                row["avgtrace_noise"] = kept.mean(axis=0)
            if bp.get("didv_files"):
                if sgfreq is None or sgamp is None:
                    raise ValueError("sgfreq/sgamp required for dIdV data")
                reader = RawReader(bp["didv_files"])
                fs = reader.sample_rate
                ci = reader.channels.index(channel)
                traces, _ = reader.read_many_events()
                data = lockin.process_didv_traces(
                    traces[:, ci, :], fs, sgfreq, sgamp, rsh,
                    nsigma_cut=nsigma_cut)
                row["didv_freqs"] = data.freqs
                row["didv"] = data.didv
                row["didv_weights"] = data.weights
                row["offset_didv"] = data.offset
                row["offset_didv_err"] = data.offset_err
                row["sgfreq"] = sgfreq
                row["sgamp"] = sgamp
                row["fs"] = fs
            rows.append(row)

        # state tagging by linearity (ivprocess.py:291-315)
        df_rows = self._tag_states(rows)
        self._set(channel, f"ivsweep_data_{tag}", df_rows,
                  {"rsh": rsh, "channel": channel})
        return df_rows

    @staticmethod
    def _tag_states(rows: List[dict]) -> pd.DataFrame:
        bias = np.array([r["tes_bias"] for r in rows])
        offs = np.array([r.get("offset_noise", r.get("offset_didv", np.nan))
                         for r in rows])
        order = np.argsort(-np.abs(bias))   # normal branch first
        state = np.array(["transition"] * len(rows), dtype=object)
        x, y = np.abs(bias[order]), offs[order]
        # normal side
        lin_n = find_linear_segment(x, y)
        for idx in lin_n:
            state[order[idx]] = "normal"
        # SC side (reverse)
        lin_s = find_linear_segment(x[::-1], y[::-1])
        for idx in lin_s:
            state[order[::-1][idx]] = "sc"
        simple = []
        for r, s in zip(rows, state):
            rr = dict(r)
            rr["state"] = s
            simple.append(rr)
        return pd.DataFrame(simple)


class IVSweepAnalysis(FilterData):
    """Sweep analysis (core/ivsweep.py:53-2073)."""

    def __init__(self, verbose: bool = True):
        from detprocess_jax.utils import jaxcache
        jaxcache.enable()
        super().__init__(verbose=verbose)
        self._sweep_df: Dict[str, pd.DataFrame] = {}
        self._ibis: Dict[str, ivbias.IBISResult] = {}
        self._rsh: Dict[str, float] = {}
        self._rsh_err: Dict[str, float] = {}
        self._rp_user: Dict[str, float] = {}
        self._rp_user_err: Dict[str, float] = {}
        self._nnorm: Dict[str, int] = {}
        self._nsc: Dict[str, int] = {}
        self._tbath: Optional[float] = None
        self._tload_guess: Optional[float] = None
        self._tc: Dict[str, float] = {}
        self._gta: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def set_data_from_dataframe(self, channel: str, df: pd.DataFrame,
                                rsh: float = 5e-3):
        self._sweep_df[channel] = df.reset_index(drop=True)
        self._rsh[channel] = rsh

    def set_data_from_processing(self, channel: str,
                                 proc: IVSweepProcessing,
                                 tag: str = "default", rsh: float = 5e-3):
        self.set_data_from_dataframe(
            channel, proc._get(channel, f"ivsweep_data_{tag}"), rsh)

    def set_data_from_file(self, file_name: str, channel: str = None,
                           tag: str = "default", rsh: float = 5e-3):
        """Load sweep dataframe(s) from an ivsweep/filter HDF5 file
        (ivsweep.py:150-191)."""
        from detprocess_jax.io.filterfile import FilterData

        fd = FilterData(verbose=False).load_hdf5(file_name)
        channels = ([channel] if channel
                    else [c for c in fd.data
                          if f"ivsweep_data_{tag}" in fd.data[c]])
        if not channels:
            raise ValueError(
                f"no ivsweep_data_{tag} found in {file_name}")
        for chan in channels:
            md = fd.data[chan].get(f"ivsweep_data_{tag}_metadata") or {}
            self.set_data_from_dataframe(
                chan, fd._get(chan, f"ivsweep_data_{tag}"),
                rsh=float(md.get("rsh", rsh)))
        return self

    def set_nb_sc_normal_points(self, channel: str, nnorm: int, nsc: int):
        """Override automatic state counts (ivsweep.py:326-399)."""
        self._nnorm[channel] = nnorm
        self._nsc[channel] = nsc

    def set_data_from_dict(self, data_dict: Dict[str, pd.DataFrame],
                           rsh: float = 5e-3):
        """Set sweep data from {channel: dataframe} (ivsweep.py:192-212)."""
        for chan, df in data_dict.items():
            if not isinstance(df, pd.DataFrame):
                raise ValueError(
                    "ERROR: Unrecognized format. Dictionary item should "
                    "be a pandas dataframe!")
            self.set_data_from_dataframe(chan, df, rsh=rsh)
        return self

    def clear(self, channels=None):
        """Drop analysis state (and stored filter data) for some or all
        channels (ivsweep.py:93-104)."""
        if channels is None:
            self._sweep_df = {}
            self._ibis = {}
            self._nnorm = {}
            self._nsc = {}
        else:
            if isinstance(channels, str):
                channels = [channels]
            for chan in channels:
                for store in (self._sweep_df, self._ibis, self._nnorm,
                              self._nsc):
                    store.pop(chan, None)
        self.clear_data(channels)

    @staticmethod
    def _broadcast_per_channel(channels, name, val):
        """Reference list-broadcast semantics (ivsweep.py:254-276): a
        scalar applies to every channel; a list must match in length."""
        if val is None:
            return [None] * len(channels)
        if isinstance(val, (int, float)):
            val = [val]
        if len(val) == 1:
            val = list(val) * len(channels)
        if len(val) != len(channels):
            raise ValueError(
                f'ERROR: "{name}" list should have length = # channels')
        return list(val)

    def set_rshunt(self, channels, rshunt=None, rshunt_err=None):
        """Set Rshunt (and error) when absent from the raw data
        (ivsweep.py:243-283)."""
        if isinstance(channels, str):
            channels = [channels]
        rshunt = self._broadcast_per_channel(channels, "rshunt", rshunt)
        rshunt_err = self._broadcast_per_channel(channels, "rshunt_err",
                                                 rshunt_err)
        for chan, val, err in zip(channels, rshunt, rshunt_err):
            if val is not None:
                self._rsh[chan] = float(val)
            if err is not None:
                self._rsh_err[chan] = float(err)
        return self

    def set_rp(self, channels, rp=None, rp_err=None):
        """Set Rp directly for channels with no SC points
        (ivsweep.py:285-331); used as the analyze_sweep default."""
        if isinstance(channels, str):
            channels = [channels]
        rp = self._broadcast_per_channel(channels, "rp", rp)
        rp_err = self._broadcast_per_channel(channels, "rp_err", rp_err)
        for chan, val, err in zip(channels, rp, rp_err):
            if val is not None:
                self._rp_user[chan] = float(val)
            if err is not None:
                self._rp_user_err[chan] = float(err)
        return self

    def set_tbath(self, tbath: float):
        """Bath temperature default for analyze_noise (ivsweep.py:1200)."""
        self._tbath = float(tbath)

    def set_tload_guess(self, tload: float):
        """Load-temperature seed for analyze_noise (ivsweep.py:1207)."""
        self._tload_guess = float(tload)

    def set_tc(self, channel: str, tc: float):
        """Per-channel Tc default for analyze_noise (ivsweep.py:1215)."""
        self._tc[channel] = float(tc)

    def set_gta(self, channel: str, gta: float):
        """Per-channel TES-bath thermal conductance (ivsweep.py:1223)."""
        self._gta[channel] = float(gta)

    # -- reference-style result accessors ------------------------------
    def get_didv_objects(self, channel: str):
        """{tes_bias: per-point fit dict} for every sweep point that was
        dIdV-fitted (ivsweep.py:107-117; values are this package's fit
        result dicts, the native replacement for DIDVAnalysis objects)."""
        if channel not in self._sweep_df:
            return None
        df = self._sweep_df[channel]
        if "didv_fits" not in df.columns:
            return None
        out = {}
        for _, row in df.iterrows():
            fits = row.get("didv_fits")
            if isinstance(fits, dict) and fits:
                out[float(row["tes_bias"])] = fits
        return out or None

    def get_ibis_qetpy_object(self, channel: str):
        """The sweep-analysis result object (ivsweep.py:119-127). The
        native :class:`~detprocess_jax.models.ivbias.IBISResult` replaces
        qetpy's IBIS object (fields: rn/rp/ioffset + errors, per-point
        i0/r0/p0)."""
        return self._ibis.get(channel)

    def get_didv_summary(self, channel: str, tag: str = "default"):
        """Summary dict of the state-aware dIdV fits
        (ivsweep.py:129-137): the stored ivsweep_results 'didv'
        measurement (sc_didv_fit_rp, normal_didv_fit_rn, L medians...)."""
        try:
            return self.get_ivsweep_results(channel, "didv", tag=tag)
        except (KeyError, ValueError):
            return None

    def get_resolution_data(self, channel: str):
        """Per-bias-point energy-resolution table
        (ivsweep.py:139-146): {tes_bias: sigma_E} from
        calc_energy_resolution."""
        if channel not in self._sweep_df:
            return None
        df = self._sweep_df[channel]
        if "energy_resolution" not in df.columns:
            return None
        out = {float(b): float(s)
               for b, s in zip(df["tes_bias"], df["energy_resolution"])
               if np.isfinite(s)}
        return out or None

    # -- state-filtered fit drivers (ivsweep.py:829-928) ----------------
    def fit_didv_sc(self, channels=None, percent_rn_max: float = 0.05,
                    nb_points_max: int = 4, tag: str = "default",
                    **kwargs):
        """1-pole fits on the SC points only → Rp cross-check."""
        for chan in self._fit_channels(channels):
            self.analyze_didv(chan, tag=tag, enable_normal=False,
                              enable_transition=False,
                              sc_percent_rn_max=percent_rn_max,
                              nb_points_sc_max=nb_points_max, **kwargs)
        return self

    def fit_didv_normal(self, channels=None, percent_rn_min: float = 99.8,
                        nb_points_max: int = 4, tag: str = "default",
                        **kwargs):
        """1-pole fits on the normal points only → Rn cross-check."""
        for chan in self._fit_channels(channels):
            self.analyze_didv(chan, tag=tag, enable_sc=False,
                              enable_transition=False,
                              normal_percent_rn_min=percent_rn_min,
                              nb_points_normal_max=nb_points_max, **kwargs)
        return self

    def fit_didv_transition(self, channels=None,
                            percent_rn_min: float = 5.0,
                            percent_rn_max: float = 70.0,
                            poles=(2, 3), tag: str = "default", **kwargs):
        """2/3-pole fits + small-signal params on the transition points."""
        for chan in self._fit_channels(channels):
            self.analyze_didv(chan, poles=poles, tag=tag,
                              enable_sc=False, enable_normal=False,
                              transition_percent_rn_min=percent_rn_min,
                              transition_percent_rn_max=percent_rn_max,
                              **kwargs)
        return self

    def _fit_channels(self, channels):
        if channels is None:
            return list(self._sweep_df.keys())
        return [channels] if isinstance(channels, str) else list(channels)

    def plot_didv_summary(self, channel: str, poles: int = 3,
                          save_path: Optional[str] = None):
        """Small-signal parameters vs percent Rn across the transition
        points (ivsweep.py:929-1037)."""
        import matplotlib.pyplot as plt

        df = self._sweep_df[channel]
        cols = [f"didv_{poles}poles_{k}" for k in ("l", "beta", "tau0")]
        have = [c for c in cols if c in df.columns]
        if not have:
            print(f"ERROR: No dIdV analysis done for {channel}")
            return None
        fig, axes = plt.subplots(len(have), 1, sharex=True,
                                 figsize=(6, 2.2 * len(have)))
        if len(have) == 1:
            axes = [axes]
        x = df.get("percent_rn", df["tes_bias"])
        for ax, col in zip(axes, have):
            err = df.get(col + "_err")
            ax.errorbar(x, df[col], yerr=err, fmt="o", ms=4)
            ax.set_ylabel(col.split("_")[-1])
            ax.grid(alpha=0.3)
        axes[-1].set_xlabel("percent Rn" if "percent_rn" in df.columns
                            else "TES bias [A]")
        fig.suptitle(f"{channel} {poles}-pole dIdV summary")
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=120)
        return fig

    # ------------------------------------------------------------------
    def analyze_sweep(self, channel: str, offset_key: str = "offset_noise",
                      rp: Optional[float] = None,
                      tag: str = "default") -> pd.DataFrame:
        """IBIS bias analysis over the sweep (ivsweep.py:401-757)."""
        if rp is None:
            rp = self._rp_user.get(channel)
        df = self._sweep_df[channel].copy()
        df = df.sort_values("tes_bias", key=np.abs, ascending=False,
                            ignore_index=True)
        # dIdV-only bias points (discover_bias_points with no matching
        # noise series) carry NaN offsets — a single NaN in the linear
        # fits would poison rn/rp/ioffset and every derived column
        finite = np.isfinite(df[offset_key].to_numpy(dtype=float))
        if not finite.all():
            dropped = int((~finite).sum())
            if self._verbose:
                print(f"INFO: dropping {dropped} bias points without "
                      f"{offset_key} from the IBIS analysis")
            df = df[finite].reset_index(drop=True)
        if len(df) < 3:
            raise ValueError(
                f"only {len(df)} bias points with finite {offset_key}")
        ibias = df["tes_bias"].to_numpy(dtype=float)
        imeas = df[offset_key].to_numpy(dtype=float)
        err_key = offset_key + "_err"
        imeas_err = (df[err_key].to_numpy(dtype=float)
                     if err_key in df else None)

        nnorm = self._nnorm.get(channel, int((df["state"] == "normal").sum())
                                if "state" in df else 3)
        nsc = self._nsc.get(channel, int((df["state"] == "sc").sum())
                            if "state" in df else 3)
        nnorm = max(nnorm, 2)
        nsc = max(nsc, 0)

        res = ivbias.analyze_ibis(ibias, imeas, self._rsh[channel],
                                  nnorm=nnorm, nsc=nsc,
                                  imeas_err=imeas_err, rp=rp)
        self._ibis[channel] = res
        df["i0"] = res.i0
        df["i0_err"] = res.i0_err
        df["r0"] = res.r0
        df["r0_err"] = res.r0_err
        df["p0"] = res.p0
        df["p0_err"] = res.p0_err
        df["percent_rn"] = res.r0 / res.rn * 100.0
        self._sweep_df[channel] = df
        results = {
            "rn": res.rn, "rn_err": res.rn_err,
            "rp": res.rp, "rp_err": res.rp_err,
            "ioffset": res.ioffset, "ioffset_err": res.ioffset_err,
            "rshunt": self._rsh[channel],
            "nnorm": nnorm, "nsc": nsc,
        }
        self.set_ivsweep_results(channel, results, "noise", tag=tag)
        self.set_ivsweep_data(channel, df, tag=tag)
        return df

    def get_ibis(self, channel: str) -> ivbias.IBISResult:
        return self._ibis[channel]

    # ------------------------------------------------------------------
    def analyze_didv(self, channel: str, poles=(2, 3),
                     tag: str = "default",
                     enable_sc: bool = True,
                     enable_normal: bool = True,
                     enable_transition: bool = True,
                     nb_points_sc_max: int = 4,
                     nb_points_normal_max: int = 4,
                     sc_percent_rn_max: float = 0.05,
                     normal_percent_rn_min: float = 99.8,
                     transition_percent_rn_min: float = 5.0,
                     transition_percent_rn_max: float = 70.0) -> pd.DataFrame:
        """State-aware dIdV fits across the sweep (ivsweep.py:762-826,
        dispatch :1600-1799).

        Matches the reference semantics:

        - **SC points** (1-pole fit, :1684-1705, 1-pole case :1775-1780):
          the TES is a short (R0=0), so dVdI(0)=A=Rsh+Rp and
          ``Rp = A − Rsh``. Fitted points are the smallest-|bias| ones,
          up to ``nb_points_sc_max``; the summary carries mean/std across
          points plus the median inductance (:1995-2032).
        - **Normal points** (1-pole): dVdI(0)=A=Rsh+Rp+Rn, so
          ``Rn = A − Rsh − Rp_IV`` (the :1803-1805 subtraction); fitted
          points are the largest-|bias| ones, up to
          ``nb_points_normal_max``.
        - **Transition points** (2/3-pole, :1781-1799): full small-signal
          parameters with covariance errors, infinite-loop-gain bias
          params, and flattened ``didv_{p}poles_*`` dataframe columns
          (:1913-1965).

        The dIdV-derived Rp/Rn are cross-checked against the IBIS sweep
        values (:2035-2046 prints); a disagreement beyond 3σ (combined)
        *and* 10 % relative emits a loud warning. Results are stored in
        the ``ivsweep_results`` "didv" entry as ``sc_didv_fit_rp``,
        ``normal_didv_fit_rn``, ``{sc,normal}_didv_fit_L`` (:2010-2032).
        """
        df = self._sweep_df[channel]
        if "didv" not in df.columns:
            raise ValueError("no dIdV data in the sweep dataframe")
        rsh = self._rsh[channel]
        ibis = self._ibis.get(channel)
        rp_iv = ibis.rp if ibis is not None else 0.0

        def _state(row):
            if isinstance(row.get("state"), str):
                return row["state"]
            # fall back to percent_rn thresholds (reference filters,
            # ivsweep.py:1706-1723) when no linearity tagging is present
            prn = row.get("percent_rn", np.nan)
            if np.isfinite(prn):
                if prn < sc_percent_rn_max:
                    return "sc"
                if prn > normal_percent_rn_min:
                    return "normal"
            return "transition"

        def _has_didv(row):
            return isinstance(row.get("didv"), np.ndarray)

        # --- select fit points per state ---------------------------------
        idx_by_state = {"sc": [], "normal": [], "transition": []}
        for idx, row in df.iterrows():
            if _has_didv(row):
                idx_by_state[_state(row)].append(idx)
        absb = df["tes_bias"].abs()
        # SC: smallest |bias| first; normal: largest |bias| first
        sc_idx = sorted(idx_by_state["sc"],
                        key=lambda i: absb[i])[:nb_points_sc_max]
        norm_idx = sorted(idx_by_state["normal"], key=lambda i: absb[i],
                          reverse=True)[:nb_points_normal_max]
        trans_idx = []
        for i in sorted(idx_by_state["transition"], key=lambda i: absb[i],
                        reverse=True):
            prn = df.loc[i].get("percent_rn", np.nan)
            if (np.isfinite(prn)
                    and not (transition_percent_rn_min <= prn
                             <= transition_percent_rn_max)):
                continue
            trans_idx.append(i)

        df = df.copy()
        # seed from existing fits so partial (state-filtered) runs
        # accumulate rather than clobber the per-point fit dicts
        if "didv_fits" in df.columns:
            fits_col = [dict(v) if isinstance(v, dict) else {}
                        for v in df["didv_fits"]]
        else:
            fits_col = [{} for _ in range(len(df))]
        pos = {idx: k for k, idx in enumerate(df.index)}
        poles_list = [poles] if isinstance(poles, int) else list(poles)
        # merge into previously stored results so the state-filtered
        # drivers (fit_didv_sc / fit_didv_normal / fit_didv_transition)
        # accumulate instead of clobbering each other
        try:
            results_didv = dict(self.get_ivsweep_results(
                channel, "didv", tag=tag) or {})
        except (KeyError, ValueError):
            results_didv = {}
        results_didv.update({"rshunt": rsh, "rp": rp_iv})
        if ibis is not None:
            results_didv.update({"rn": ibis.rn, "rn_err": ibis.rn_err,
                                 "rp_err": ibis.rp_err})

        # --- 1-pole SC / normal fits -------------------------------------
        for data_type, indices, enabled in (("sc", sc_idx, enable_sc),
                                            ("normal", norm_idx,
                                             enable_normal)):
            if not enabled or not indices:
                continue
            rpn_list, rpn_err_list, l_list = [], [], []
            for i in indices:
                row = df.loc[i]
                fit = didv_models.fit_didv(
                    row["didv_freqs"], row["didv"], poles=1,
                    weights=row.get("didv_weights"))
                fits_col[pos[i]]["fit_1poles"] = fit
                a = float(fit.params[0])
                a_err = float(np.sqrt(max(fit.cov[0, 0], 0.0)))
                rpn = a - rsh - (rp_iv if data_type == "normal" else 0.0)
                rpn_list.append(rpn)
                rpn_err_list.append(a_err)
                l_list.append(float(fit.params[0] * fit.params[1]))
                df.loc[i, "didv_1poles_rtot"] = a
                df.loc[i, "didv_1poles_chi2"] = fit.cost
            fit_val = float(np.mean(rpn_list))
            # spread across points if several, else the fit error
            fit_err = (float(np.std(rpn_list)) if len(rpn_list) > 1
                       else rpn_err_list[0])
            fit_err = max(fit_err, float(np.mean(rpn_err_list)))
            name = "rp" if data_type == "sc" else "rn"
            results_didv[f"{data_type}_didv_fit_{name}"] = fit_val
            results_didv[f"{data_type}_didv_fit_{name}_err"] = fit_err
            results_didv[f"{data_type}_didv_fit_L"] = float(
                np.median(l_list))
            # cross-check vs IBIS (reference prints both, :2035-2046;
            # here a real disagreement warns loudly)
            if ibis is not None:
                iv_val = ibis.rp if data_type == "sc" else ibis.rn
                iv_err = ibis.rp_err if data_type == "sc" else ibis.rn_err
                sigma = float(np.hypot(fit_err, iv_err))
                dev = abs(fit_val - iv_val)
                if (dev > 3 * sigma
                        and dev > 0.1 * max(abs(iv_val), 1e-12)):
                    print(f"WARNING: {channel} {name} from "
                          f"{data_type} dIdV fit = {fit_val*1e3:.3f} mOhms "
                          f"disagrees with IV sweep "
                          f"{iv_val*1e3:.3f} ± {iv_err*1e3:.3f} mOhms "
                          f"({dev/max(sigma,1e-30):.1f}σ) — check Rshunt "
                          "or the SC/normal point selection")
                if self._verbose:
                    print(f"{channel} {name} from dIdV fit = "
                          f"{fit_val*1e3:.3f} ± {fit_err*1e3:.3f} mOhms; "
                          f"from IV sweep = {iv_val*1e3:.3f} ± "
                          f"{iv_err*1e3:.3f} mOhms")

        # --- 2/3-pole transition fits ------------------------------------
        if enable_transition:
            for i in trans_idx:
                row = df.loc[i]
                for p in poles_list:
                    if p == 1:
                        continue
                    fit = didv_models.fit_didv(
                        row["didv_freqs"], row["didv"], poles=p,
                        weights=row.get("didv_weights"))
                    fits_col[pos[i]][f"fit_{p}poles"] = fit
                    df.loc[i, f"didv_{p}poles_chi2"] = fit.cost
                    if "r0" not in row or not np.isfinite(row.get("r0",
                                                                  np.nan)):
                        continue
                    ssp = didv_models.smallsignal_with_errors(
                        fit, row["r0"], rsh + rp_iv)
                    fits_col[pos[i]][f"ssp_{p}poles"] = ssp
                    for key in ("l", "beta", "tau0", "L"):
                        df.loc[i, f"didv_{p}poles_{key}"] = ssp[key]
                        df.loc[i, f"didv_{p}poles_{key}_err"] = (
                            ssp[f"{key}_err"])
                    if p == 3:
                        df.loc[i, "didv_3poles_gratio"] = ssp["gratio"]
                    # infinite-loop-gain bias point (:1946-1965)
                    ilg = didv_models.biasparams_ilg(
                        fit.params, rsh + rp_iv, rsh,
                        float(row["tes_bias"]), poles=p)
                    for key in ("r0", "i0", "p0"):
                        df.loc[i, f"didv_{p}poles_{key}_infinite_lgain"] = (
                            ilg[key])

        df["didv_fits"] = fits_col
        self._sweep_df[channel] = df
        self.set_ivsweep_results(channel, results_didv, "didv", tag=tag)
        self.set_ivsweep_data(channel, df, tag=tag)
        return df

    def analyze_noise(self, channel: str, tc: Optional[float] = None,
                      tbath: Optional[float] = None,
                      tload_guess: Optional[float] = None,
                      poles: int = 2) -> dict:
        """Noise model across the sweep (ivsweep.py:1231-1599): SQUID+
        electronics noise averaged over the normal points, Tload from the
        SC points, then an Irwin–Hilton budget per transition point from
        that point's dIdV small-signal parameters + bias + measured PSD.

        Requires analyze_sweep + analyze_didv first. Returns
        {"squid_noise", "tload", "normal_fit", "budgets": {bias: budget}}
        and stores a "noise_budget" column in the sweep dataframe.
        """
        from detprocess_jax.pipelines.noisemodel import NoiseModel

        # stored defaults (set_tc/set_tbath/set_tload_guess,
        # ivsweep.py:1200-1230)
        tc = self._tc.get(channel) if tc is None else tc
        tbath = self._tbath if tbath is None else tbath
        if tload_guess is None:
            tload_guess = (self._tload_guess
                           if self._tload_guess is not None else 0.03)
        if tc is None or tbath is None:
            raise ValueError(
                f'tc/tbath required for channel {channel} — pass them or '
                'call set_tc/set_tbath first')

        df = self._sweep_df[channel]
        if "didv_fits" not in df.columns:
            raise ValueError('run "analyze_didv" first')
        if "psd" not in df.columns:
            raise ValueError(f"no PSD available for channel {channel} — "
                             "is it a dIdV-only sweep?")
        ibis = self._ibis[channel]
        rl = self._rsh[channel] + ibis.rp
        nm = NoiseModel(verbose=False)

        # normal points → SQUID noise (averaged over points)
        squid_list, normal_fit = [], None
        for _, row in df[df["state"] == "normal"].iterrows():
            if not isinstance(row.get("psd"), np.ndarray):
                continue
            n = len(row["psd"])
            freqs = np.fft.fftfreq(n, d=1.0 / row["fs"])
            normal_fit = nm.fit_normal_noise(
                channel, row["psd"], freqs, ibis.rn, rl, tc)
            squid_list.append(nm.calc_squid_noise(
                channel, row["psd"], freqs, ibis.rn, rl,
                normal_fit["L"], tc, tload_guess=tload_guess))
        squid = np.mean(squid_list, axis=0) if squid_list else None

        # SC points → Tload
        tload = tload_guess
        for _, row in df[df["state"] == "sc"].iterrows():
            if not isinstance(row.get("psd"), np.ndarray):
                continue
            n = len(row["psd"])
            freqs = np.fft.fftfreq(n, d=1.0 / row["fs"])
            tload = nm.fit_sc_noise(
                channel, row["psd"], freqs, rl,
                normal_fit["L"] if normal_fit else 4e-7,
                squiddc=(float(np.median(squid[freqs != 0]))
                         if squid is not None else None))

        # transition points → full budget
        budgets, col = {}, []
        for _, row in df.iterrows():
            fits = row.get("didv_fits")
            if (row.get("state") != "transition"
                    or not isinstance(fits, dict)
                    or f"ssp_{poles}poles" not in fits
                    or not isinstance(row.get("psd"), np.ndarray)):
                col.append(None)
                continue
            ssp = fits[f"ssp_{poles}poles"]
            n = len(row["psd"])
            freqs = np.fft.fftfreq(n, d=1.0 / row["fs"])
            pos = freqs > 0
            budget = nm.analyze_noise(
                channel, freqs[pos],
                {"beta": ssp["beta"], "l": ssp["l"], "L": ssp["L"],
                 "tau0": ssp["tau0"]},
                {"r0": row["r0"], "i0": row["i0"],
                 "rshunt": self._rsh[channel], "rp": ibis.rp,
                 "p0": row["p0"]},
                tc, tbath, tload=tload,
                gta=self._gta.get(channel),
                squiddc=(float(np.median(squid[freqs != 0]))
                         if squid is not None else None),
                psd_measured=row["psd"][pos])
            budgets[float(row["tes_bias"])] = budget
            col.append(budget)
        df = df.copy()
        df["noise_budget"] = col
        self._sweep_df[channel] = df
        return {"squid_noise": squid, "tload": tload,
                "normal_fit": normal_fit, "budgets": budgets}

    def calc_energy_resolution(self, channel: str, template: np.ndarray,
                               fs: float, poles: int = 2) -> pd.DataFrame:
        """σ_E per transition bias point using each point's dIdV fit + PSD
        (ivsweep.py:1040-1196)."""
        df = self._sweep_df[channel]
        sigmas = []
        n = len(template)
        freqs = np.fft.fftfreq(n, d=1.0 / fs)
        for _, row in df.iterrows():
            fits = row.get("didv_fits")
            if (not isinstance(fits, dict) or f"fit_{poles}poles" not in fits
                    or not isinstance(row.get("psd"), np.ndarray)
                    or row.get("state") != "transition"):
                sigmas.append(np.nan)
                continue
            fit = fits[f"fit_{poles}poles"]
            rl = self._rsh[channel] + (self._ibis[channel].rp
                                       if channel in self._ibis else 0.0)
            dpdi, _ = didv_models.dpdi_with_uncertainties(
                fit, freqs, row["i0"], row["r0"], rl)
            sigmas.append(didv_models.energy_resolution(
                template, row["psd"], dpdi, fs))
        df = self._sweep_df[channel].copy()
        df["energy_resolution"] = sigmas
        self._sweep_df[channel] = df
        return df
