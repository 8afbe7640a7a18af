"""Salting: injection of simulated pulses into raw traces.

Replacement for the reference Salting core (detprocess/core/salting.py):
generate salt metadata — energies sampled from a dark-matter recoil PDF by
inverse-transform sampling (salting.py:192-287), times sampled like randoms
— and inject scaled templates into raw traces on the fly during triggering
or feature extraction (salting.py:479-621).

Energy → amplitude normalization: for a template normalized to unit peak,
``amplitude = energy / energy_norm`` where ``energy_norm`` is the
energy-per-unit-amplitude of the template. With a dPdI responsivity
available (models.didv), the proper normalization is
``∫ template_power dt`` with template_power = |irfft(dPdI·fft(template))|
(qetpy.get_energy_normalization equivalent); otherwise a user-provided
calibration (eV per amp) is used.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd

from detprocess_jax.io import tables
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.utils.misc import create_series_name


def sample_from_pdf(energies: np.ndarray, drde: np.ndarray, nsamples: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Inverse-transform sampling from a tabulated dR/dE spectrum
    (salting.py:192-287 sample_DMpdf equivalent).

    The CDF uses trapezoidal integration over the tabulated grid — DM
    spectra are conventionally log-spaced, and a plain cumsum of dR/dE
    values would weight by array index (uniform in log E), oversampling
    low energies by orders of magnitude.
    """
    energies = np.asarray(energies, float)
    drde = np.clip(np.asarray(drde, float), 0, None)
    if len(energies) < 2:
        raise ValueError("need at least two tabulated energies")
    cdf = np.concatenate(
        [[0.0],
         np.cumsum(0.5 * (drde[1:] + drde[:-1]) * np.diff(energies))])
    if cdf[-1] <= 0:
        raise ValueError("PDF has no positive weight")
    cdf = cdf / cdf[-1]
    u = rng.random(nsamples)
    return np.interp(u, cdf, energies)


def sample_pdf_function(function, xrange, nsamples: int,
                        rng: np.random.Generator,
                        npoints: int = 10000) -> np.ndarray:
    """Inverse-transform sampling from a callable 1-D PDF over ``xrange``
    (salting.py:192-249): trapezoidal CDF on an npoints grid, then
    interpolate the inverse CDF at uniform deviates."""
    x = np.linspace(xrange[0], xrange[1], num=npoints)
    pdf = np.clip(np.asarray(function(x), float), 0, None)
    cdf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(x))])
    if cdf[-1] <= 0:
        raise ValueError("PDF has no positive weight over xrange")
    cdf /= cdf[-1]
    return np.interp(rng.random(nsamples), cdf, x)


def load_dm_pdf_file(pdf_file: str) -> dict:
    """Load a pickled {mass_MeV: {"dmrate": callable}} spectrum dictionary
    (salting.py:326-338; written with cloudpickle since the rate models
    are closures)."""
    try:
        import cloudpickle as pickle_mod
    except ImportError:          # pragma: no cover - std pickle fallback
        import pickle as pickle_mod
    with open(pdf_file, "rb") as f:
        return pickle_mod.load(f)


class Salting:
    """Salt generation + on-the-fly injection."""

    def __init__(self, filter_data: FilterData | str,
                 verbose: bool = True):
        if isinstance(filter_data, str):
            filter_data = FilterData(verbose=verbose).load_hdf5(filter_data)
        self._filter_data = filter_data
        self._verbose = verbose
        self._df: Optional[pd.DataFrame] = None
        self._templates: Dict[str, np.ndarray] = {}
        self._pretriggers: Dict[str, int] = {}
        self._rawdata = None
        self._fs: Optional[float] = None
        self._dm_energies = np.array([])
        self._channel_energies: Optional[list] = None

    @property
    def dataframe(self) -> Optional[pd.DataFrame]:
        return self._df

    # -- reference-parity accessors (core/salting.py:106-290, :470-478) --
    def get_dataframe(self) -> Optional[pd.DataFrame]:
        """Salting metadata dataframe (salting.py:470)."""
        return self._df

    def clear_dataframe(self):
        """Drop the salting dataframe (salting.py:473)."""
        self._df = None
        self._df_by_event = None

    def get_injectiontimes(self) -> Optional[pd.DataFrame]:
        """Injection-time dataframe — same rows as the salting dataframe
        (salting.py:476, :145)."""
        return self._df

    def get_sample_rate(self) -> Optional[float]:
        """Sample rate of the raw data set via set_raw_data
        (salting.py:106)."""
        return self._fs

    def set_raw_data(self, raw_data, series=None, restricted: bool = False):
        """Attach the continuous raw data salts are injected into
        (salting.py:148-189): a group directory path or a RawData
        object; records the sample rate and lets generate_salt omit
        ``raw_files``."""
        from detprocess_jax.io.rawdata import RawData

        if isinstance(raw_data, str):
            raw_data = RawData(raw_data, data_type="continuous",
                               series=series, restricted=restricted)
        elif not isinstance(raw_data, RawData):
            raise ValueError("ERROR: raw data argument should be either "
                             "a directory or RawData object")
        elif raw_data.restricted != restricted:
            raise ValueError(
                f"ERROR: Unable to use RawData object. It needs "
                f"requirement restricted = {restricted}!")
        self._rawdata = raw_data
        self._fs = float(raw_data.get_sample_rate())
        if self._verbose:
            print("INFO: Data used for salting generation:")
            raw_data.describe()
        return self

    def _raw_files_from_store(self):
        if self._rawdata is None:
            raise ValueError(
                "no raw data — pass raw_files or call set_raw_data first")
        files = []
        for flist in self._rawdata.get_data_files().values():
            files.extend(flist)
        return sorted(files)

    def sample_DMpdf(self, function, xrange, nsamples: int = 1000,
                     npoints: int = 10000, normalize_cdf: bool = True,
                     seed: Optional[int] = None):
        """Inverse-transform sampling of an arbitrary dark-matter recoil
        PDF defined in keV (salting.py:192-252). Returns the sampled
        keV values and accumulates them (×1e3 → eV, the reference's
        convention) for later generate_salt calls."""
        del normalize_cdf  # CDF always normalized over xrange here
        rng = np.random.default_rng(seed)
        sampled = sample_pdf_function(function, xrange, nsamples, rng,
                                      npoints=npoints)
        self._dm_energies = np.append(self._dm_energies, sampled * 1e3)
        return sampled

    def get_DMenergies(self) -> np.ndarray:
        """Accumulated DM energies in eV (salting.py:254)."""
        return self._dm_energies

    def clear_DMenergies(self):
        self._dm_energies = np.array([])

    def channel_energy_split(self, mean: float = 0.5,
                             std_dev: float = 0.2, npairs: int = 10,
                             seed: Optional[int] = None) -> list:
        """Random per-channel energy-sharing pairs: Gaussian draws
        clipped to [0, 1] and normalized to sum to 1
        (salting.py:260-277)."""
        rng = np.random.default_rng(seed)
        splits = []
        for _ in range(npairs):
            pair = np.clip(rng.normal(loc=mean, scale=std_dev, size=2),
                           0.0, 1.0)
            if pair.sum() > 0:
                pair = pair / pair.sum()
            splits.append(pair)
        self._channel_energies = splits
        return splits

    def get_energy_perchannel(self):
        """Last channel_energy_split result (salting.py:279)."""
        return self._channel_energies

    @staticmethod
    def set_energy_splits_to1(energysplits: list) -> list:
        """Force every split fraction to 1 — full energy in every
        channel (salting.py:282-286)."""
        for sublist in energysplits:
            sublist[:] = [1] * len(sublist)
        return energysplits

    def set_dataframe(self, df: pd.DataFrame):
        """Load an existing salting dataframe (salting.py:447); templates
        are loaded per (channel, salt_template_tag) pair so re-injection
        uses the same pulse shapes the salts were generated with."""
        self._df = df
        self._df_by_event = None
        if "salt_template_tag" in df.columns:
            pairs = {(row["salt_channel"], row["salt_template_tag"])
                     for _, row in df.iterrows()}
            for chan, tag in pairs:
                self._load_template(chan, template_tag=tag)
        else:
            for chan in df["salt_channel"].unique():
                self._load_template(chan)

    def _load_template(self, chan, template_tag="default"):
        key = (chan, template_tag)
        if key not in self._templates:
            tmpl, _, md = self._filter_data.get_template(
                chan, tag=template_tag, return_metadata=True)
            self._templates[key] = np.asarray(tmpl)
            self._pretriggers[key] = int(
                md.get("nb_pretrigger_samples",
                       np.asarray(tmpl).shape[-1] // 2))

    def _template_for(self, chan, tag="default"):
        key = (chan, tag)
        if key not in self._templates:
            self._load_template(chan, template_tag=tag)
        return self._templates[key], self._pretriggers[key]

    # ------------------------------------------------------------------
    def generate_salt(self,
                      raw_files=None,
                      channels: Sequence[str] = (),
                      energies=None,
                      dm_pdf: Optional[tuple] = None,
                      pdf_file: Optional[str] = None,
                      pdf_xrange_kev: tuple = (1e-5, 1.0),
                      nsalt: int = 100,
                      energy_norm_ev_per_amp: float | dict | None = None,
                      dpdi_poles: int = 2,
                      dpdi_tag: str = "default",
                      channel_fractions: Optional[dict] = None,
                      template_tag: str = "default",
                      min_separation_msec: float = 100.0,
                      edge_exclusion_msec: float = 50.0,
                      coincident: bool = True,
                      seed: Optional[int] = None) -> pd.DataFrame:
        """Generate salt metadata over the continuous exposure.

        Parameters mirror the reference (salting.py:288-445): either a list
        of fixed ``energies`` (each repeated nsalt times) or a ``dm_pdf``
        (energies_eV, dRdE) tuple sampled nsalt times.
        ``channel_fractions`` splits each salt's energy across channels
        (default: equal split). ``coincident`` injects every salt into all
        channels at the same time.

        Energy→amplitude normalization: an explicit
        ``energy_norm_ev_per_amp`` (eV per unit template amplitude) wins;
        otherwise a dPdI stored in the filter file computes the physical
        normalization ∫ power-template dt in joules → eV
        (qetpy.get_energy_normalization, reference salting.py:367-380).
        """
        from detprocess_jax.pipelines.randoms import Randoms

        if raw_files is None:
            raw_files = self._raw_files_from_store()
        if not channels:
            raise ValueError("channels required")
        rng = np.random.default_rng(seed)
        for chan in channels:
            self._load_template(chan, template_tag)

        salt_masses = None
        if pdf_file is not None:
            if energies is not None:
                raise ValueError(
                    "pass either energies or a DM PDF file, not both")
            # {mass_MeV: {"dmrate": fn(E_keV)}} → nsalt samples per mass,
            # converted keV → eV (salting.py:326-338, :248-249)
            dists = load_dm_pdf_file(pdf_file)
            salt_energies, salt_masses = [], []
            for mass, data in dists.items():
                e = sample_pdf_function(data["dmrate"], pdf_xrange_kev,
                                        nsalt, rng) * 1e3
                salt_energies.extend(e)
                salt_masses.extend([mass] * nsalt)
            salt_energies = np.asarray(salt_energies)
            salt_masses = np.asarray(salt_masses)
        elif dm_pdf is not None:
            salt_energies = sample_from_pdf(dm_pdf[0], dm_pdf[1], nsalt, rng)
        elif energies is not None:
            energies = np.atleast_1d(energies)
            salt_energies = np.repeat(energies, nsalt)
        elif len(self._dm_energies):
            # accumulated sample_DMpdf draws (already eV)
            salt_energies = np.asarray(self._dm_energies)
        else:
            raise ValueError('"energies", "dm_pdf" or "pdf_file" required')
        ntot = len(salt_energies)

        # random times across the exposure (randoms machinery);
        # non-coincident salting draws independent times per channel
        nchan = len(channels)
        ntimes = ntot if coincident else ntot * nchan
        randoms = Randoms(raw_files, verbose=False)
        times_df = randoms.process(
            nrandoms=ntimes, min_separation_msec=min_separation_msec,
            edge_exclusion_msec=edge_exclusion_msec, seed=seed,
            lgc_output=True)
        if len(times_df) < ntimes:
            ntot = (len(times_df) if coincident
                    else len(times_df) // nchan)
            salt_energies = salt_energies[:ntot]

        fractions = channel_fractions or {
            c: 1.0 / len(channels) for c in channels}

        # per-channel eV-per-amp normalization
        EV_PER_JOULE = 6.241509074e18
        norms = {}
        for chan in channels:
            if isinstance(energy_norm_ev_per_amp, dict):
                norms[chan] = float(energy_norm_ev_per_amp[chan])
            elif energy_norm_ev_per_amp is not None:
                norms[chan] = float(energy_norm_ev_per_amp)
            else:
                from detprocess_jax.models import didv as didv_models
                try:
                    dpdi, dpdi_freqs = self._filter_data.get_dpdi(
                        chan, dpdi_poles, tag=dpdi_tag)
                except KeyError:
                    raise ValueError(
                        f"no energy_norm_ev_per_amp given and no "
                        f"dpdi_{dpdi_poles}poles_{dpdi_tag} in the filter "
                        f"file for channel {chan}")
                tmpl, _ = self._template_for(chan, template_tag)
                _, _, tmd = self._filter_data.get_template(
                    chan, tag=template_tag, return_metadata=True)
                fs = float(tmd.get("sample_rate", 1.25e6))
                # the stored dPdI may live on an arbitrary frequency grid
                # (didv.calc_dpdi takes caller-chosen freqs); the
                # energy normalization multiplies fft(template)·dPdI
                # bin-by-bin, so interpolate onto the template's
                # two-sided axis when the grids differ
                dpdi = np.asarray(dpdi)
                freqs_t = np.fft.fftfreq(tmpl.shape[-1], d=1.0 / fs)
                dpdi_freqs = (np.asarray(dpdi_freqs)
                              if dpdi_freqs is not None else None)
                if (dpdi_freqs is None
                        or len(dpdi) != len(freqs_t)
                        or not np.allclose(dpdi_freqs, freqs_t)):
                    if dpdi_freqs is None:
                        raise ValueError(
                            f"dPdI for {chan} has no frequency axis and "
                            f"does not match the template length")
                    order = np.argsort(dpdi_freqs)
                    dpdi = (np.interp(freqs_t, dpdi_freqs[order],
                                      dpdi.real[order])
                            + 1j * np.interp(freqs_t, dpdi_freqs[order],
                                             dpdi.imag[order]))
                joules = didv_models.energy_normalization(
                    tmpl, dpdi, fs)
                norms[chan] = abs(joules) * EV_PER_JOULE
        rows = []
        salt_id = 0
        for i in range(ntot):
            salt_id += 1
            for ci, chan in enumerate(channels):
                t = times_df.iloc[i if coincident else i * nchan + ci]
                frac = fractions.get(chan, 0.0)
                e_chan = salt_energies[i] * frac
                norm = norms[chan]
                rows.append({
                    "salt_id": salt_id,
                    **({"salt_dm_mass_mev": salt_masses[i]}
                       if salt_masses is not None else {}),
                    "salt_channel": chan,
                    "salt_energy_ev": e_chan,
                    "salt_amplitude": e_chan / norm,
                    "salt_template_tag": template_tag,
                    "trigger_index": int(t["trigger_index"]),
                    "trigger_time": t["trigger_time"],
                    "series_number": t["series_number"],
                    "event_number": t["event_number"],
                    "dump_number": t["dump_number"],
                    "trigger_type": 6,
                })
        self._df = pd.DataFrame(rows)
        self._df_by_event = None
        return self._df

    # ------------------------------------------------------------------
    def inject_raw_salt(self, traces: np.ndarray, admin: dict,
                        channel_list: Sequence[str],
                        window_start: int = 0) -> np.ndarray:
        """Add scaled templates into an event's traces
        (salting.py:479-621). Matches salts by (series, event);
        ``window_start`` shifts positions for windowed reads (the feature
        pipeline re-injects salts into triggered windows,
        processing_data.py:539-553, :613-640)."""
        if self._df is None or len(self._df) == 0:
            return traces
        by_event = getattr(self, "_df_by_event", None)
        if by_event is None:
            # one-time (series, event) index: the injector runs on the
            # per-event hot path of both pipelines
            by_event = {key: grp for key, grp in self._df.groupby(
                ["series_number", "event_number"], sort=False)}
            self._df_by_event = by_event
        sel = by_event.get((admin["series_number"],
                            admin["event_number"]))
        if sel is None or len(sel) == 0:
            return traces
        out = np.array(traces, copy=True)
        nb = out.shape[-1]
        for _, row in sel.iterrows():
            chan = row["salt_channel"]
            if chan not in channel_list:
                continue
            ci = channel_list.index(chan)
            tmpl, p = self._template_for(
                chan, row.get("salt_template_tag", "default"))
            start = int(row["trigger_index"]) - p - int(window_start)
            amp = row["salt_amplitude"]
            lo = max(start, 0)
            hi = min(start + tmpl.shape[-1], nb)
            if hi <= lo:
                continue
            out[ci, lo:hi] += amp * tmpl[lo - start: hi - start]
        return out

    def make_injector(self, channel_list: Sequence[str]):
        """Injector callable for TriggerProcessing/FeatureProcessing
        .set_salting."""
        def injector(traces, admin, window_start=0):
            return self.inject_raw_salt(traces, admin, channel_list,
                                        window_start=window_start)
        return injector

    def make_device_injector(self, channel_list: Sequence[str],
                             max_salts_per_event: int = 16):
        """ON-DEVICE injector for ``set_salting(..., device=True)``.

        The host injector converts every event to float64 and adds
        templates on the CPU; this one only PLANS on the host (tiny
        [E, K] index/amplitude arrays per batch) and the add runs on
        device after the ADC conversion — so salted runs keep the raw
        int16 upload path (half the host→device bytes)."""
        from detprocess_jax.ops.saltinject import DeviceInjector

        if self._df is None or len(self._df) == 0:
            raise ValueError("no salting dataframe — generate_salt or "
                             "set_dataframe first")
        return DeviceInjector(self._df, self._template_for, channel_list,
                              max_salts_per_event=max_salts_per_event)

    # ------------------------------------------------------------------
    def save(self, output_path: str, group_name: str = "salting",
             series_name: Optional[str] = None, facility: int = 1,
             output_format: str = "hdf5") -> str:
        os.makedirs(output_path, exist_ok=True)
        out_series = series_name or create_series_name(facility)
        path = tables.output_file_name(
            output_path, "salting", group_name, out_series, 1,
            "parquet" if output_format == "parquet" else "hdf5")
        tables.write_table(self._df, path, fmt=output_format)
        return path


def salt_efficiency(salt_df: pd.DataFrame, trigger_df: pd.DataFrame,
                    match_window_samples: int = 20,
                    energy_bins=None) -> pd.DataFrame:
    """Trigger efficiency vs injected energy from a salting run.

    The analysis step of the reference's saltchecks workflow
    (examples/salting/saltchecks.ipynb): a salt counts as recovered when
    the trigger output contains an entry in the same (series, event)
    within ``match_window_samples`` of the injection index.

    Returns a DataFrame with one row per energy bin:
    ``energy_lo_ev, energy_hi_ev, energy_mean_ev, n_injected,
    n_recovered, efficiency, efficiency_err`` (binomial error), plus a
    ``recovered`` boolean column is added to ``salt_df`` in place.
    """
    if not len(salt_df):
        raise ValueError("empty salting dataframe")
    recovered = np.zeros(len(salt_df), dtype=bool)
    if len(trigger_df):
        trig_by_ev = {}
        for _, t in trigger_df.iterrows():
            key = (t["series_number"], t["event_number"])
            trig_by_ev.setdefault(key, []).append(int(t["trigger_index"]))
        for i, (_, s) in enumerate(salt_df.iterrows()):
            key = (s["series_number"], s["event_number"])
            idxs = trig_by_ev.get(key)
            if idxs and any(abs(int(s["trigger_index"]) - j)
                            <= match_window_samples for j in idxs):
                recovered[i] = True
    salt_df["recovered"] = recovered

    e = salt_df["salt_energy_ev"].to_numpy()
    if energy_bins is None:
        lo, hi = float(e.min()), float(e.max())
        if lo == hi:
            energy_bins = np.array([lo * 0.999, hi * 1.001])
        else:
            energy_bins = np.linspace(lo, hi * (1 + 1e-9), 9)
    energy_bins = np.asarray(energy_bins, dtype=float)

    rows = []
    for blo, bhi in zip(energy_bins[:-1], energy_bins[1:]):
        m = (e >= blo) & (e < bhi)
        n = int(m.sum())
        k = int(recovered[m].sum())
        eff = k / n if n else np.nan
        err = (np.sqrt(eff * (1 - eff) / n) if n and 0 <= eff <= 1
               else np.nan)
        rows.append({"energy_lo_ev": blo, "energy_hi_ev": bhi,
                     "energy_mean_ev": float(e[m].mean()) if n else np.nan,
                     "n_injected": n, "n_recovered": k,
                     "efficiency": eff, "efficiency_err": err})
    return pd.DataFrame(rows)
