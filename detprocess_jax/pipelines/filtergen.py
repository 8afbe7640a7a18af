"""Filter-file generation pipeline: dIdV fits + noise PSD/CSD + templates.

Replacement for the reference FilterDataProcessing
(detprocess/process/filterprocess.py:40-2077): the beginning-of-run
standalone workload that classifies raw series (noise/dIdV), runs per-channel
dIdV fits (with optional IV-sweep inputs), estimates by-series and global
PSDs/CSDs, creates analytic templates from the YAML config, and saves one
filter file feeding triggering + feature extraction.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from detprocess_jax.config import YamlConfig
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawData, RawReader
from detprocess_jax.pipelines.didv import DIDVAnalysis
from detprocess_jax.pipelines.noise import Noise
from detprocess_jax.pipelines.template import Template
from detprocess_jax.utils.misc import create_series_name


class FilterDataProcessing:
    """Generate a filter file from raw data + YAML config sections
    (didv / noise / template)."""

    def __init__(self,
                 raw_path: Optional[str] = None,
                 noise_files: Optional[Sequence[str]] = None,
                 didv_files: Optional[Sequence[str]] = None,
                 config: YamlConfig | str | None = None,
                 series: Optional[Sequence[str]] = None,
                 facility: int = 1,
                 verbose: bool = True):
        from detprocess_jax.utils import jaxcache
        jaxcache.enable()   # compiled kernels persist across processes
        self._verbose = verbose
        self._facility = facility

        if raw_path is not None:
            rd_cont = RawData(raw_path, data_type="continuous",
                              series=series)
            rd_rand = RawData(raw_path, data_type="rand", series=series)
            rd_didv = RawData(raw_path, data_type="didv", series=series)
            rd_noise = RawData(raw_path, data_type="noise", series=series)
            series_map = (rd_cont.get_data_files()
                          or rd_rand.get_data_files()
                          or rd_noise.get_data_files())
            self._is_continuous = bool(rd_cont.get_data_files())
            noise_files = noise_files or self._flatten(series_map)
            didv_series_map = rd_didv.get_data_files()
            didv_files = didv_files or self._flatten(didv_series_map)
            self._noise_series_map = dict(series_map)
            self._didv_series_map = dict(didv_series_map)
        else:
            self._noise_series_map = (
                {"series": list(noise_files)} if noise_files else {})
            self._didv_series_map = (
                {"series": list(didv_files)} if didv_files else {})
            self._is_continuous = True
        self._noise_files = list(noise_files or [])
        self._didv_files = list(didv_files or [])

        files_for_channels = self._noise_files or self._didv_files
        if not files_for_channels:
            raise ValueError("no raw files found for filter generation")
        probe = RawReader(files_for_channels)
        self._available_channels = probe.channels
        self._fs = probe.sample_rate

        if isinstance(config, str):
            config = YamlConfig(config, self._available_channels,
                                sample_rate=self._fs)
        self._config = config

        self._filter_data = FilterData(verbose=verbose)

    @staticmethod
    def _flatten(series_map: Dict[str, List[str]]) -> List[str]:
        out: List[str] = []
        for files in series_map.values():
            out.extend(files)
        return sorted(out)

    @property
    def filter_data(self) -> FilterData:
        return self._filter_data

    # ------------------------------------------------------------------
    def check_config(self, processing_type: str) -> None:
        """Up-front validation with actionable errors
        (filterprocess.py:150-296 ``check_config``).

        ``processing_type`` ∈ {'didv', 'noise', 'template'}. Raises
        ValueError naming the missing data or config key; returns None
        when the corresponding branch can run.
        """
        if self._config is None:
            raise ValueError(
                "ERROR: processing config not found — pass config= "
                "(YamlConfig or yaml path) to FilterDataProcessing")

        if processing_type == "didv":
            if not self._didv_files:
                raise ValueError(
                    "ERROR: unable to process dIdV — no dIdV raw data "
                    "found (files with a 'didv_' prefix)")
            didv_cfg = self._config.get_config("didv")
            channels = didv_cfg.get("channels") or {}
            if not channels:
                raise ValueError(
                    "ERROR: input yaml file does not contain didv "
                    "processing configurations (a 'didv:' section with "
                    "channel blocks)")
            overall = didv_cfg.get("overall", {}) or {}
            for chan, ccfg in channels.items():
                if not isinstance(ccfg, dict):
                    continue
                for key in ("sgfreq", "sgamp"):
                    if ccfg.get(key, overall.get(key)) is None:
                        raise ValueError(
                            f'ERROR: "{key}" is required to process dIdV '
                            f"for channel {chan} (set it in the channel "
                            "block or in the didv section)")
                if not any(k in ccfg for k in ("ivsweep_file",
                                               "ivsweep_results",
                                               "ivsweep_data")):
                    raise ValueError(
                        f"ERROR: I0/R0 bias information required for "
                        f'channel {chan}: provide "ivsweep_file" (path) '
                        f'or "ivsweep_results" (dict with i0/r0/rp/'
                        f'rshunt) in its didv config'
                        " (filterprocess.py:186-191 semantics)")

        elif processing_type == "noise":
            if not self._noise_files:
                raise ValueError(
                    "ERROR: unable to process noise — no randoms or "
                    "continuous raw data found")
            noise_cfg = self._config.get_config("noise")
            overall = noise_cfg.get("overall", {}) or {}
            channels = noise_cfg.get("channels") or {}
            if self._is_continuous:
                has_overall_len = any(
                    k in overall for k in ("trace_length_samples",
                                           "trace_length_msec"))
                for chan, ccfg in channels.items():
                    if not isinstance(ccfg, dict):
                        continue
                    has_len = has_overall_len or any(
                        k in ccfg for k in ("trace_length_samples",
                                            "trace_length_msec"))
                    if not has_len and self._verbose:
                        print(f"INFO: no trace length configured for "
                              f"noise channel {chan} — full-trace "
                              "randoms geometry will be used")

        elif processing_type == "template":
            tmpl_cfg = self._config.get_config("template")
            channels = tmpl_cfg.get("channels") or {}
            if not channels:
                raise ValueError(
                    "ERROR: input yaml file does not contain template "
                    "generation configurations (a 'template:' section "
                    "with channel blocks)")
            for chan, ccfg in channels.items():
                if not isinstance(ccfg, dict):
                    continue
                tags = ccfg.get("template_tag_list")
                if tags is None:
                    # legacy single-template block: direct keys
                    if (not ccfg.get("from_average_pulses")
                            and ccfg.get("tau_r") is None
                            and ccfg.get("rise_time") is None):
                        raise ValueError(
                            f"ERROR: no template parameters for channel "
                            f'{chan}: provide "tau_r"/"tau_f1" (or '
                            f'"rise_time"/"fall_time_1"), a '
                            f'"template_tag_list", or '
                            f'"from_average_pulses: true"')
                    continue
                for tag in tags:
                    if tag not in ccfg:
                        raise ValueError(
                            f"ERROR: no configuration found for tag "
                            f"{tag}, channel {chan} (every entry of "
                            f'"template_tag_list" needs a matching '
                            "block)")
                    tcfg = ccfg[tag]
                    if tcfg.get("from_average_pulses"):
                        continue
                    if "template_poles" not in tcfg:
                        raise ValueError(
                            f'ERROR: no "template_poles" parameter for '
                            f"tag {tag}, channel {chan}")
                    missing = [k for k, alt in
                               (("amplitude_A", "A"),
                                ("rise_time", "tau_r"),
                                ("fall_time_1", "tau_f1"))
                               if k not in tcfg and alt not in tcfg]
                    if missing:
                        raise ValueError(
                            f"ERROR: missing template parameters "
                            f"{missing} for tag {tag}, channel {chan} "
                            "(filterprocess.py:283-296 requirements)")
        else:
            raise ValueError(
                f"unknown processing_type {processing_type!r} — expected "
                "'didv', 'noise', or 'template'")

    # ------------------------------------------------------------------
    def proces_didv(self, channels=None, **kwargs):
        """dIdV-only processing — the reference's (sic) alias
        (process/filterprocess.py:298-317)."""
        return self.process(channels=channels, enable_noise=False,
                            enable_template=False, enable_didv=True,
                            **kwargs)

    def proces_noise(self, channels=None, **kwargs):
        """Noise-only processing — the reference's (sic) alias
        (process/filterprocess.py:320-339)."""
        return self.process(channels=channels, enable_noise=True,
                            enable_template=False, enable_didv=False,
                            **kwargs)

    def process(self,
                channels: Optional[Sequence[str]] = None,
                enable_noise: bool = True,
                enable_template: bool = True,
                enable_didv: bool = True,
                nrandoms: Optional[int] = None,
                random_rate: Optional[float] = None,
                lgc_by_series: bool = False,
                lgc_save: bool = False,
                output_path: Optional[str] = None,
                file_name: Optional[str] = None,
                seed: Optional[int] = None) -> FilterData:
        channels = list(channels or self._available_channels)
        noise_cfg = (self._config.get_config("noise")
                     if self._config else {"overall": {}, "channels": {}})
        tmpl_cfg = (self._config.get_config("template")
                    if self._config else {"overall": {}, "channels": {}})
        didv_cfg = (self._config.get_config("didv")
                    if self._config else {"overall": {}, "channels": {}})

        # ---- noise PSDs (+CSD over all configured channels)
        if enable_noise and self._noise_files:
            noise = Noise(self._noise_files, verbose=self._verbose)
            noise._filter_data = self._filter_data.data
            overall = noise_cfg.get("overall", {}) or {}
            n = overall.get("trace_length_samples")
            p = overall.get("pretrigger_length_samples")
            noise.generate_randoms(
                random_rate=random_rate or overall.get("random_rate"),
                nrandoms=nrandoms or overall.get("nrandoms", 500),
                seed=seed)
            chan_sel = [c for c in channels
                        if not noise_cfg.get("channels")
                        or c in noise_cfg["channels"]]
            noise.calc_psd(chan_sel, trace_length_samples=n,
                           pretrigger_length_samples=p)
            if len(chan_sel) > 1:
                noise.calc_csd(chan_sel, trace_length_samples=n,
                               pretrigger_length_samples=p)
            if lgc_by_series and len(self._noise_series_map) > 1:
                # per-series PSDs tagged by series name for stability
                # monitoring (filterprocess.py:1050-1302 by-series branch)
                for sname, sfiles in self._noise_series_map.items():
                    ns = Noise(sorted(sfiles), verbose=False)
                    ns._filter_data = self._filter_data.data
                    ns.generate_randoms(
                        random_rate=random_rate
                        or overall.get("random_rate"),
                        nrandoms=nrandoms or overall.get("nrandoms", 500),
                        seed=seed)
                    ns.calc_psd(chan_sel, trace_length_samples=n,
                                pretrigger_length_samples=p, tag=sname)

        # ---- analytic / average-pulse templates from config
        if enable_template and tmpl_cfg.get("channels"):
            if self._config is not None:
                self.check_config("template")
            template = Template(verbose=self._verbose)
            template._filter_data = self._filter_data.data
            for chan, ccfg in tmpl_cfg["channels"].items():
                if not isinstance(ccfg, dict):
                    continue
                self._process_template(template, chan, ccfg)

        # ---- dIdV fits (per series → dataframe, + combined fit)
        if enable_didv and self._didv_files and didv_cfg.get("channels"):
            if self._config is not None:
                self.check_config("didv")
            self._process_didv(didv_cfg)

        if lgc_save:
            output_path = output_path or "."
            os.makedirs(output_path, exist_ok=True)
            name = file_name or (
                f"filter_{create_series_name(self._facility)}.hdf5")
            self._filter_data.save_hdf5(os.path.join(output_path, name))
        return self._filter_data

    # ------------------------------------------------------------------
    def _process_template(self, template: Template, chan: str,
                          ccfg: dict) -> None:
        """Create the configured templates for one channel
        (filterprocess.py:1414-1562 ``_process_template``).

        Supports three branches per tag: analytic n-pole
        (``create_template``), sum-of-two-poles when the amplitude/time
        parameters are lists (:1513-1533 ``create_template_sum_twopoles``),
        and average-pulse templates from raw events
        (``from_average_pulses: true`` → Template.calc_average_pulses,
        core/template.py:113-191).
        """
        tags = ccfg.get("template_tag_list")
        if tags is None:
            # legacy single-template block: direct keys on the channel
            if ccfg.get("from_average_pulses"):
                self._template_from_average(template, chan, ccfg,
                                            ccfg.get("tag", "default"))
                return
            template.create_template(
                chan, self._fs,
                trace_length_samples=ccfg.get("trace_length_samples"),
                trace_length_msec=ccfg.get("trace_length_msec"),
                pretrigger_length_samples=ccfg.get(
                    "pretrigger_length_samples"),
                pretrigger_length_msec=ccfg.get("pretrigger_length_msec"),
                A=ccfg.get("A", ccfg.get("amplitude_A", 1.0)),
                B=ccfg.get("B", ccfg.get("amplitude_B")),
                C=ccfg.get("C", ccfg.get("amplitude_C")),
                tau_r=ccfg.get("tau_r", ccfg.get("rise_time")),
                tau_f1=ccfg.get("tau_f1", ccfg.get("fall_time_1")),
                tau_f2=ccfg.get("tau_f2", ccfg.get("fall_time_2")),
                tau_f3=ccfg.get("tau_f3", ccfg.get("fall_time_3")),
                tag=ccfg.get("tag", "default"))
            return

        for tag in tags:
            tcfg = ccfg[tag]
            if tcfg.get("from_average_pulses"):
                self._template_from_average(template, chan, tcfg, tag)
                continue
            poles = int(tcfg["template_poles"])
            n = tcfg.get("trace_length_samples")
            if n is None and tcfg.get("trace_length_msec") is not None:
                n = int(round(tcfg["trace_length_msec"] * 1e-3 * self._fs))
            pre = tcfg.get("pretrigger_length_samples")
            if (pre is None
                    and tcfg.get("pretrigger_length_msec") is not None):
                pre = int(round(
                    tcfg["pretrigger_length_msec"] * 1e-3 * self._fs))
            lengths = dict(trace_length_samples=n,
                           pretrigger_length_samples=pre)

            def aslist(v):
                return v if isinstance(v, list) else [v]

            a = aslist(tcfg.get("amplitude_A", tcfg.get("A", 1.0)))
            rise = aslist(tcfg.get("rise_time", tcfg.get("tau_r")))
            fall1 = aslist(tcfg.get("fall_time_1", tcfg.get("tau_f1")))
            if poles == 2 and len(a) > 1:
                # sum of two-pole pulses (:1513-1533)
                template.create_template_sum_twopoles(
                    chan, a, rise, fall1, self._fs, tag=tag, **lengths)
            else:
                b = tcfg.get("amplitude_B", tcfg.get("B"))
                c = tcfg.get("amplitude_C", tcfg.get("C"))
                template.create_template(
                    chan, self._fs,
                    A=a[0], B=(aslist(b)[0] if b is not None else None),
                    C=(aslist(c)[0] if c is not None else None),
                    tau_r=rise[0], tau_f1=fall1[0],
                    tau_f2=tcfg.get("fall_time_2", tcfg.get("tau_f2")),
                    tau_f3=tcfg.get("fall_time_3", tcfg.get("tau_f3")),
                    tag=tag, **lengths)

    def _template_from_average(self, template: Template, chan: str,
                               tcfg: dict, tag: str) -> None:
        """Average-pulse template from raw events (the config-driven
        drive of Template.calc_average_pulses)."""
        files = tcfg.get("raw_files") or self._noise_files
        if not files:
            raise ValueError(
                f"ERROR: from_average_pulses for channel {chan} needs "
                'raw data — no noise/continuous files found and no '
                '"raw_files" given')
        reader = RawReader(files)
        ci = reader.channels.index(chan)
        traces, _ = reader.read_many_events(tcfg.get("nevents"))
        tr = traces[:, ci, :]
        n = tcfg.get("trace_length_samples") or tr.shape[-1]
        pre = tcfg.get("pretrigger_length_samples") or n // 2
        template.calc_average_pulses(chan, tr[:, :n], self._fs,
                                     pretrigger_length_samples=pre,
                                     tag=tag)

    # ------------------------------------------------------------------
    def _process_didv(self, didv_cfg: dict) -> None:
        """Per-channel, per-series dIdV fits with result dataframes
        (filterprocess.py:797-1047 ``_process_didv``).

        Every dIdV series is processed and fitted separately; one row
        per series goes into a dataframe (offsets, bias params,
        2/3-pole small-signal params with errors, χ², falltimes,
        infinite-loop-gain bias point) stored via
        ``FilterData.set_didv_dataframe``. The combined all-series fit
        is kept as the channel's ``didv_results_*`` entries (the filter
        file the trigger/feature workloads consume).
        """
        overall = didv_cfg.get("overall", {}) or {}
        for chan, ccfg in didv_cfg["channels"].items():
            if not isinstance(ccfg, dict):
                continue
            sgfreq = ccfg.get("sgfreq", overall.get("sgfreq"))
            sgamp = ccfg.get("sgamp", overall.get("sgamp"))
            rsh = ccfg.get("rshunt", overall.get("rshunt", 5e-3))
            poles_req = ccfg.get("poles", [2, 3])
            iv_results = ccfg.get("ivsweep_results",
                                  ccfg.get("ivsweep_data"))
            iv_file = ccfg.get("ivsweep_file")
            iv_type = ccfg.get("ivsweep_result_type", "noise")

            rows = []
            for sname, sfiles in sorted(self._didv_series_map.items()):
                didv_s = DIDVAnalysis(verbose=False)
                try:
                    didv_s.process_raw_data(chan, sorted(sfiles), sgfreq,
                                            sgamp, rsh)
                except (ValueError, KeyError) as err:
                    if self._verbose:
                        print(f"INFO: skipping dIdV series {sname} for "
                              f"{chan}: {err}")
                    continue
                didv_s.dofit(chan, poles=poles_req)
                if iv_file:
                    didv_s.set_ivsweep_results_from_file(
                        chan, iv_file, iv_type=iv_type)
                elif iv_results:
                    didv_s.set_ivsweep_results(chan, iv_results,
                                               iv_type=iv_type)
                didv_s.calc_smallsignal_params(chan, poles=poles_req)
                rows.append(self._didv_series_row(
                    didv_s, chan, sname, poles_req))

            if rows:
                import pandas as pd

                df = pd.DataFrame(rows)
                self._filter_data.set_didv_dataframe(
                    chan, df, metadata={"sgfreq": sgfreq, "sgamp": sgamp,
                                        "rshunt": rsh})
                if self._verbose:
                    print(f"INFO: {chan}: {len(df)} dIdV series fitted "
                          "→ didv_processing dataframe")

            # combined fit over all series (filter-file didv_results_*)
            didv = DIDVAnalysis(verbose=self._verbose)
            didv._filter_data = self._filter_data.data
            didv.process_raw_data(chan, self._didv_files, sgfreq, sgamp,
                                  rsh)
            didv.dofit(chan, poles=poles_req)
            if iv_file:
                didv.set_ivsweep_results_from_file(chan, iv_file,
                                                   iv_type=iv_type)
            elif iv_results:
                didv.set_ivsweep_results(chan, iv_results,
                                         iv_type=iv_type)
            if iv_file or iv_results:
                didv.calc_smallsignal_params(chan, poles=poles_req)
                didv.calc_bias_params_infinite_loop_gain(chan)

    @staticmethod
    def _didv_series_row(didv: DIDVAnalysis, chan: str, sname: str,
                         poles_req) -> dict:
        """One dataframe row per fitted series (the filterprocess.py
        :860-1047 output_dict columns, flattened)."""
        from detprocess_jax.models import didv as didv_models

        data = didv.get_didv_data(chan)
        row = {
            "series_name": sname,
            "offset_didv": data.offset,
            "offset_err_didv": data.offset_err,
            "fs": data.fs,
            "sgfreq": data.sgfreq,
            "sgamp": data.sgamp,
        }
        bias = didv._bias_params.get(chan, {})
        for key in ("rp", "rn", "rshunt", "i0", "i0_err", "r0", "r0_err",
                    "p0", "p0_err", "ibias"):
            row[key] = bias.get(key, np.nan)
        poles_list = ([poles_req] if isinstance(poles_req, int)
                      else list(poles_req))
        for p in poles_list:
            try:
                fit = didv.get_fit(chan, p)
            except KeyError:
                continue
            row[f"chi2_{p}poles_fit"] = fit.cost
            taus = didv_models.didv_falltimes(fit)
            row[f"tau+_{p}poles_fit"] = taus[0]
            row[f"tau-_{p}poles_fit"] = taus[1]
            row[f"tau3_{p}poles_fit"] = taus[2]
            ssp = didv._ssp.get(chan, {}).get(p)
            if ssp:
                for par in ("l", "L", "tau0", "beta", "gratio"):
                    if par in ssp:
                        row[f"{par}_{p}poles_fit"] = ssp[par]
                        row[f"{par}_err_{p}poles_fit"] = ssp.get(
                            f"{par}_err", np.nan)
            if bias.get("ibias") is not None and "rshunt" in bias:
                ilg = didv_models.biasparams_ilg(
                    fit.params, bias.get("rshunt", 0.0)
                    + bias.get("rp", 0.0), bias.get("rshunt", 0.0),
                    bias.get("ibias", 0.0), poles=p)
                for par in ("i0", "r0", "p0"):
                    row[f"{par}_{p}poles_infinite_lgain"] = ilg[par]
        return row
