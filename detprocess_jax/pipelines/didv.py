"""dIdV analysis driver: raw square-wave data → fits → TES parameters.

Replacement for the reference DIDVAnalysis (detprocess/core/didv.py):
process raw traces (cuts + lock-in), run 1/2/3-pole fits, derive
small-signal parameters with uncertainties, infinite-loop-gain bias
parameters, dPdI, and energy resolution; persist everything into the
FilterData store under the reference's key schema
(``didv_results_{poles}poles_{tag}``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawReader
from detprocess_jax.models import didv as didv_models
from detprocess_jax.ops import lockin


class DIDVAnalysis(FilterData):
    """Per-channel dIdV analysis (core/didv.py:63-1800)."""

    def __init__(self, verbose: bool = True):
        from detprocess_jax.utils import jaxcache
        jaxcache.enable()
        super().__init__(verbose=verbose)
        self._didv_data: Dict[str, lockin.DIDVData] = {}
        self._fits: Dict[str, Dict[int, didv_models.DIDVFit]] = {}
        self._bias_params: Dict[str, dict] = {}
        self._ssp: Dict[str, Dict[int, dict]] = {}
        self._ilg: Dict[str, Dict[int, dict]] = {}
        self._ivbor: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    def process_raw_data(self, channels: Sequence[str] | str,
                         raw_files, sgfreq: float, sgamp: float,
                         rsh: float, nsigma_cut: float = 2.5,
                         nevents: Optional[int] = None):
        """Read raw dIdV events, apply cuts, lock-in average
        (core/didv.py:159-206, :1521-1645)."""
        if isinstance(channels, str):
            channels = [channels]
        reader = RawReader(raw_files)
        fs = reader.sample_rate
        traces, _ = reader.read_many_events(nevents)
        chan_list = reader.channels
        for chan in channels:
            ci = chan_list.index(chan)
            data = lockin.process_didv_traces(
                traces[:, ci, :], fs, sgfreq, sgamp, rsh,
                nsigma_cut=nsigma_cut)
            self.set_processed_data(chan, data)
        return self

    def set_processed_data(self, channel: str, data: lockin.DIDVData):
        """Inject already-processed dIdV data (core/didv.py:207 —
        qetpy.didvinitfromdata equivalent)."""
        self._didv_data[channel] = data

    def get_didv_data(self, channel: str) -> lockin.DIDVData:
        return self._didv_data[channel]

    # ------------------------------------------------------------------
    def set_ivsweep_results(self, channel: str, results: dict,
                            iv_type: str = "noise", tag: str = "default"):
        """Attach IV-sweep results (i0/r0/p0/rp/rshunt) needed for the
        small-signal conversion (core/didv.py:239-303).

        Harmonized with the inherited FilterData accessor (``iv_type``
        plays the ``measurement`` role): the results are ALSO persisted
        into the store under ``ivsweep_results_{iv_type}_{tag}`` so
        save_hdf5/auto-save carries them, and 'noise' vs 'didv' results
        do not overwrite each other on disk.
        """
        self._bias_params[channel] = dict(results)
        FilterData.set_ivsweep_results(self, channel, dict(results),
                                       measurement=iv_type, tag=tag)
        return self

    def set_ivsweep_results_from_data(self, channel: str, results: dict,
                                      iv_type: str = "noise"):
        """Alias matching the reference API (core/didv.py:239)."""
        return self.set_ivsweep_results(channel, results, iv_type)

    def set_ivsweep_results_from_file(self, channel: str, file_name: str,
                                      iv_type: str = "noise",
                                      tag: str = "default"):
        """Load IV-sweep results for a channel from a filter/ivsweep
        HDF5 file (core/didv.py:303). Accepts per-bias-point results
        (picks the stored summary dict) written by IVSweepAnalysis."""
        from detprocess_jax.io.filterfile import FilterData

        fd = FilterData(verbose=False).load_hdf5(file_name)
        results = fd._get(channel, f"ivsweep_results_{iv_type}_{tag}")
        if isinstance(results, dict):
            self._bias_params[channel] = dict(results)
        else:
            raise ValueError(
                f"ivsweep_results_{iv_type}_{tag} for {channel} in "
                f"{file_name} is not a result dict")
        return self

    def dofit(self, channels: Sequence[str] | str, poles=(2, 3),
              nharmonics: Optional[int] = 200):
        """Fit the measured dIdV(f) with the requested pole models
        (core/didv.py:489-560)."""
        if isinstance(channels, str):
            channels = [channels]
        if isinstance(poles, int):
            poles = [poles]
        for chan in channels:
            data = self._didv_data[chan]
            nh = (len(data.freqs) if nharmonics is None
                  else min(nharmonics, len(data.freqs)))
            fits = self._fits.setdefault(chan, {})
            for p in poles:
                fits[p] = didv_models.fit_didv(
                    data.freqs[:nh], data.didv[:nh], poles=p,
                    weights=data.weights[:nh])
                tag = "default"
                self._set(chan, f"didv_results_{p}poles_fit_{tag}", {
                    "params": fits[p].params,
                    "cov": fits[p].cov,
                    "cost": fits[p].cost,
                    "poles": p,
                }, {"sgfreq": data.sgfreq, "sgamp": data.sgamp,
                    "rsh": data.rsh})
        self._maybe_auto_save()
        return self

    def get_fit(self, channel: str, poles: int) -> didv_models.DIDVFit:
        return self._fits[channel][poles]

    def dofit_prior(self, channels: Sequence[str] | str,
                    prior_mean, prior_cov, poles: int = 2,
                    nharmonics: Optional[int] = 200):
        """Prior-constrained fit (qetpy.DIDVPriors; core/didv.py:867-904)."""
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            data = self._didv_data[chan]
            nh = (len(data.freqs) if nharmonics is None
                  else min(nharmonics, len(data.freqs)))
            fit = didv_models.fit_didv_prior(
                data.freqs[:nh], data.didv[:nh], prior_mean, prior_cov,
                poles=poles, weights=data.weights[:nh])
            self._fits.setdefault(chan, {})[poles] = fit
            self._set(chan, f"didv_results_{poles}poles_priorfit_default",
                      {"params": fit.params, "cov": fit.cov,
                       "cost": fit.cost, "poles": poles}, None)
        return self

    def enable_auto_save(self, path: str):
        """Save the filter-data store after each analysis step
        (auto_save_hdf5 behavior, core/didv.py:1320-1408)."""
        self._auto_save_path = path

    def _maybe_auto_save(self):
        path = getattr(self, "_auto_save_path", None)
        if path:
            self.save_hdf5(path)

    # ------------------------------------------------------------------
    def calc_smallsignal_params(self, channels: Sequence[str] | str,
                                poles=(2, 3), tag: str = "default"):
        """Small-signal parameters + errors (core/didv.py:561-645).
        Requires IV-sweep bias results (r0, rp, rshunt)."""
        if isinstance(channels, str):
            channels = [channels]
        if isinstance(poles, int):
            poles = [poles]
        for chan in channels:
            bias = self._bias_params.get(chan)
            if bias is None:
                raise ValueError(
                    f"IV sweep results required for channel {chan} — call "
                    "set_ivsweep_results first")
            r0 = bias["r0"]
            rl = bias.get("rshunt", bias.get("rsh", 0.0)) + bias.get("rp",
                                                                     0.0)
            for p in poles:
                if p not in self._fits.get(chan, {}):
                    continue
                fit = self._fits[chan][p]
                ssp = didv_models.smallsignal_with_errors(fit, r0, rl)
                self._ssp.setdefault(chan, {})[p] = ssp
                light = {k: v for k, v in ssp.items() if k != "cov"}
                self._set(chan,
                          f"didv_results_{p}poles_smallsignalparams_{tag}",
                          light, {"r0": r0, "rl": rl})
        self._maybe_auto_save()
        return self

    def get_smallsignal_params(self, channel: str, poles: int) -> dict:
        return self._ssp[channel][poles]

    def calc_bias_params_infinite_loop_gain(self, channels, poles: int = 2,
                                            tag: str = "default"):
        """ILG bias point from the dIdV fit (core/didv.py:646-744)."""
        if isinstance(channels, str):
            channels = [channels]
        out = {}
        for chan in channels:
            bias = self._bias_params.get(chan, {})
            rsh = bias.get("rshunt", bias.get("rsh", 5e-3))
            rp = bias.get("rp", 0.0)
            ibias = bias.get("ibias", bias.get("tes_bias", 0.0))
            fit = self._fits[chan][poles]
            ilg = didv_models.biasparams_ilg(fit.params, rsh + rp, rsh,
                                            ibias, poles)
            self._set(chan, f"didv_results_{poles}poles_biasparams_{tag}",
                      ilg, {"method": "infinite_loop_gain"})
            self._ilg.setdefault(chan, {})[poles] = ilg
            out[chan] = ilg
        return out

    # ------------------------------------------------------------------
    def calc_dpdi(self, channels, freqs: np.ndarray, poles: int = 2,
                  tag: str = "default"):
        """dPdI(f) with uncertainties, stored as ``dpdi_{poles}poles_{tag}``
        (core/didv.py:745-797)."""
        if isinstance(channels, str):
            channels = [channels]
        out = {}
        for chan in channels:
            bias = self._bias_params[chan]
            fit = self._fits[chan][poles]
            r0 = bias["r0"]
            rl = (bias.get("rshunt", bias.get("rsh", 0.0))
                  + bias.get("rp", 0.0))
            i0 = bias["i0"]
            dpdi, dpdi_err = didv_models.dpdi_with_uncertainties(
                fit, freqs, i0, r0, rl)
            self.set_dpdi(chan, dpdi, np.asarray(freqs), poles, tag=tag)
            out[chan] = (dpdi, dpdi_err)
        return out

    def calc_energy_resolution(self, channel: str, template: np.ndarray,
                               psd: np.ndarray, fs: float,
                               poles: int = 2) -> float:
        """Baseline energy resolution using the stored dPdI
        (core/didv.py:798-866)."""
        dpdi, freqs = self.get_dpdi(channel, poles)
        if len(dpdi) != len(template):
            raise ValueError(
                f"dPdI length {len(dpdi)} != template length "
                f"{len(template)} — recompute dPdI on the template's "
                "frequency axis")
        return didv_models.energy_resolution(template, psd, dpdi, fs)

    # -- reference-parity surface (core/didv.py:57-160, :996-1320) ------
    def clear(self, channels=None):
        """Drop per-channel analysis state (core/didv.py:57-70)."""
        if channels is None:
            self._didv_data = {}
            self._fits = {}
            self._bias_params = {}
            self._ssp = {}
            self._ilg = {}
            self._ivbor = {}
            return
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            for store in (self._didv_data, self._fits, self._bias_params,
                          self._ssp, self._ilg, self._ivbor):
                store.pop(chan, None)

    def get_qetpy_object(self, channel: str):
        """The per-channel dIdV data/fit bundle (core/didv.py:117-127).
        The native :class:`~detprocess_jax.ops.lockin.DIDVData` replaces
        qetpy's DIDV object (fields: freqs, didv, weights, sgfreq,
        sgamp, rsh)."""
        if channel not in self._didv_data:
            raise ValueError(f'ERROR: No dIdV data available for '
                             f'channel "{channel}"!')
        return self._didv_data[channel]

    def get_fit_results(self, channel: str, poles: int,
                        verbose: bool = True) -> dict:
        """Assembled fit-result dict — params/cov/cost plus
        smallsignalparams / biasparams / biasparams_infinite_lgain when
        computed (core/didv.py:996-1013). Empty dict when the fit was
        never run."""
        fit = self._fits.get(channel, {}).get(poles)
        if fit is None:
            if self._verbose and verbose:
                print(f"WARNING: {channel}: No fit result found for "
                      f"poles {poles}! Returning empty dictionary.")
            return {}
        result = {"params": np.asarray(fit.params),
                  "cov": np.asarray(fit.cov),
                  "cost": float(fit.cost), "poles": int(poles)}
        ssp = self._ssp.get(channel, {}).get(poles)
        if ssp is not None:
            result["smallsignalparams"] = {k: v for k, v in ssp.items()
                                           if k != "cov"}
        bias = self._bias_params.get(channel)
        if bias is not None:
            result["biasparams"] = dict(bias)
        ilg = self._ilg.get(channel, {}).get(poles)
        if ilg is not None:
            result["biasparams_infinite_lgain"] = dict(ilg)
        return result

    def get_bias_params(self, channel: str, poles: int = 3) -> dict:
        """I0/R0/P0 bias parameters in use (core/didv.py:129-141)."""
        result = self.get_fit_results(channel, poles, verbose=False)
        if "biasparams" not in result:
            raise ValueError(f'ERROR: No bias parameters available for '
                             f'channel "{channel}"!')
        return result["biasparams"]

    def get_bias_params_infinite_loop_gain(self, channel: str,
                                           poles: int = 3) -> dict:
        """ILG bias point from calc_bias_params_infinite_loop_gain
        (core/didv.py:143-155)."""
        ilg = self._ilg.get(channel, {}).get(poles)
        if ilg is None:
            raise ValueError(
                f"ERROR: No bias parameters with infinite loop gain "
                f'available for channel "{channel}"!')
        return ilg

    def set_iv_bor_data(self, base_path: str, bor_series_number: int,
                        channel: str, files_per_set: int = 4):
        """Bias parameters from a beginning-of-run IV taken alongside
        continuous data (core/didv.py:385-485): groups of
        ``files_per_set`` 'iv_bor' dumps — normal points first, the
        transition point last — give mean currents + TES bias per point;
        a normal-branch line fit plus the transition point yields
        i0/r0/p0 (models.ivbias.biasparams_from_normal_iv). Requires
        rp/rshunt (set_ivsweep_results first)."""
        import glob as globmod

        from detprocess_jax.models import ivbias

        bias = self._bias_params.get(channel)
        if not bias or "rp" not in bias:
            raise ValueError('ERROR: Unable to find rp! Use '
                             '"set_ivsweep_results()" first')
        rsh = bias.get("rshunt", bias.get("rsh"))
        rl = rsh + bias["rp"]

        files = sorted(
            globmod.glob(os.path.join(base_path, "**", "*.hdf5"),
                         recursive=True))
        bor = [f for f in files if "iv_bor" in os.path.basename(f)]
        if not bor:
            raise ValueError(f"no iv_bor files under {base_path}")
        groups = [bor[i:i + files_per_set]
                  for i in range(0, len(bor), files_per_set)]
        group = groups[bor_series_number]
        *normal_files, trans_file = group

        def _point(fname):
            reader = RawReader(fname)
            traces, _ = reader.read_many_events(channels=[channel])
            det = reader.get_detector_config().get(channel, {})
            means = traces[:, 0, :].mean(axis=-1)
            return (float(means.mean()),
                    float(means.std() / np.sqrt(len(means))),
                    float(det.get("tes_bias", np.nan)))

        norm_avs, norm_errs, ibias_norms = zip(
            *[_point(f) for f in normal_files])
        trans_av, trans_err, ibias_trans = _point(trans_file)

        params = ivbias.biasparams_from_normal_iv(
            list(norm_avs), list(norm_errs), trans_av, trans_err,
            list(ibias_norms), ibias_trans, rl=rl, rsh=rsh)
        self._ivbor[channel] = params
        # feed the ssp path (the reference's stated purpose)
        self._bias_params[channel].update(
            {k: params[k] for k in ("i0", "r0", "p0", "i0_err", "r0_err",
                                    "p0_err", "ioffset", "rn", "ibias")})
        if self._verbose:
            print(f"INFO: {channel} bor-IV bias point: "
                  f"r0 = {params['r0']*1e3:.2f} mOhms, "
                  f"i0 = {params['i0']*1e6:.3f} muA, "
                  f"p0 = {params['p0']*1e15:.3f} fW")
        return params

    def compare_with_ivsweep(self, channel: str, poles: int = 3):
        """Side-by-side R0/I0/P0 comparison dataframe: dIdV-fit bias
        params (and their infinite-loop-gain variants) vs the IV-sweep
        values (core/didv.py:1143-1310)."""
        import pandas as pd

        result = self.get_fit_results(channel, poles, verbose=False)
        bias = result.get("biasparams")
        if bias is None:
            raise ValueError(f"no bias parameters for channel {channel}")
        ilg = result.get("biasparams_infinite_lgain", {})
        rows, labels = [], []
        for param, norm, label in (("r0", 1e3, "R0 [mOhms]"),
                                   ("i0", 1e6, "I0 [muAmps]"),
                                   ("p0", 1e15, "P0 [fWatts]")):
            row = {}
            if param in bias:
                row["IV sweep"] = "{:.3g} +/- {:.4g}".format(
                    bias[param] * norm,
                    bias.get(f"{param}_err", np.nan) * norm)
            if param in ilg:
                row["dIdV infinite loop gain"] = "{:.3g} +/- {:.4g}".format(
                    ilg[param] * norm, ilg.get(f"{param}_err", 0.0) * norm)
            rows.append(row)
            labels.append(label)
        return pd.DataFrame(rows, index=labels)

    def print_fit_result(self, channels=None, poles: int = 3):
        """Human-readable fit summary (core/didv.py:1085-1141)."""
        if channels is None:
            channels = list(self._fits.keys())
        elif isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            result = self.get_fit_results(chan, poles, verbose=False)
            if not result:
                print(f"{chan}: no {poles}-poles fit")
                continue
            print(f"{chan} {poles}-poles fit: cost = "
                  f"{result['cost']:.4g}")
            print(f"  params = {np.array2string(result['params'], precision=4)}")
            ssp = result.get("smallsignalparams")
            if ssp:
                for key in ("l", "beta", "tau0", "L"):
                    if key in ssp:
                        err = ssp.get(f"{key}_err", np.nan)
                        print(f"  {key} = {ssp[key]:.4g} +/- {err:.4g}")

    def plot_fit_result(self, channels=None, poles: int = 2,
                        save_path: Optional[str] = None):
        """Measured dIdV(f) vs the fitted model, real/imaginary parts
        (core/didv.py:1015-1083)."""
        import matplotlib.pyplot as plt

        if channels is None:
            channels = list(self._fits.keys())
        elif isinstance(channels, str):
            channels = [channels]
        figs = []
        for chan in channels:
            data = self._didv_data[chan]
            fit = self._fits[chan][poles]
            model = didv_models.didv_model(fit.params, data.freqs, poles)
            fig, axes = plt.subplots(2, 1, sharex=True, figsize=(6, 5))
            for ax, part, name in ((axes[0], np.real, "Re"),
                                   (axes[1], np.imag, "Im")):
                ax.semilogx(data.freqs, part(data.didv), ".", ms=3,
                            label="measured")
                ax.semilogx(data.freqs, part(model), "-", label="fit")
                ax.set_ylabel(f"{name} dIdV [1/Ohms]")
                ax.grid(alpha=0.3)
            axes[0].legend()
            axes[0].set_title(f"{chan} {poles}-poles dIdV fit")
            axes[1].set_xlabel("frequency [Hz]")
            fig.tight_layout()
            if save_path:
                fig.savefig(os.path.join(
                    save_path, f"didv_fit_{chan}_{poles}poles.png"),
                    dpi=120)
            figs.append(fig)
        return figs

    def save_didv_data(self, channels=None,
                       file_path_name: Optional[str] = None,
                       save_hdf5: bool = False):
        """Persist fit results for each fitted pole count into the
        filter-data store, optionally writing the HDF5 file
        (core/didv.py:1320-1408)."""
        if channels is None:
            channels = list(self._didv_data.keys())
        elif isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            if chan not in self._didv_data:
                raise ValueError(f"ERROR: No data found for channel "
                                 f"{chan}!")
            data = self._didv_data[chan]
            metadata = {"channel": chan, "sgfreq": data.sgfreq,
                        "sgamp": data.sgamp, "rsh": data.rsh}
            for p in sorted(self._fits.get(chan, {})):
                results = self.get_fit_results(chan, p, verbose=False)
                if results:
                    self.set_didv_results(chan, results, p,
                                          metadata=metadata)
        if save_hdf5:
            if file_path_name is None:
                raise ValueError("file_path_name required with save_hdf5")
            self.save_hdf5(file_path_name, overwrite=True)
        return self
