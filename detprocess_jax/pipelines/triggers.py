"""Trigger-processing pipeline: continuous raw data → trigger dataframes.

Batched replacement for the reference TriggerProcessing + EventBuilder
(detprocess/process/triggers.py, core/eventbuilder.py). The per-event flow:

    continuous trace [C, L]
      → (optional) salt injection (scatter-add of scaled templates)
      → per trigger channel: jitted of_fir → Δχ² → threshold/pileup merge
        (+ optional residual re-trigger with saturation veto) on device
      → fixed-capacity TriggerSet compacted on host
      → EventBuilder: cross-channel coincidence merge, metadata columns
      → vaex-layout HDF5 / parquet dumps (``threshtrig_`` prefix)

Output column schema follows the reference (SURVEY.md appendix):
trigger_index/time/delta_chi2/amplitude[_i]/threshold_sigma/pileup_window/
type(=4)/channel + per-channel suffixed duplicates + admin columns.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from detprocess_jax.config import YamlConfig
from detprocess_jax.io import tables
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import open_reader
from detprocess_jax.ops import filterbank, saltinject, spectral
from detprocess_jax.ops import trigger as trig_ops
from detprocess_jax.utils import channels as chutils
from detprocess_jax.utils.misc import create_series_name


def get_trigger_template_info(trigger_config: dict,
                              filter_data: FilterData) -> dict:
    """Template length/pretrigger summary for deadtime estimates
    (detprocess/utils/utils.py:715-778 equivalent)."""
    info = {}
    pre_list, post_list = [], []
    for trig_chan, tcfg in trigger_config.get("channels", {}).items():
        if not tcfg.get("run", True):
            continue
        chan = tcfg.get("channel_name", trig_chan)
        template_tag = tcfg.get("template_tag", "default")
        _, _, md = filter_data.get_template(chan, tag=template_tag,
                                            return_metadata=True)
        fs = md["sample_rate"]
        pre = int(md["nb_pretrigger_samples"])
        nb = int(md["nb_samples"])
        post = nb - pre
        info[trig_chan] = {
            "nb_pretrigger_samples": pre,
            "nb_posttrigger_samples": post,
            "nb_samples": nb,
            "pretrigger_length_msec": 1e3 * pre / fs,
            "posttrigger_length_msec": 1e3 * post / fs,
            "trace_length_msec": 1e3 * nb / fs,
        }
        pre_list.append(1e3 * pre / fs)
        post_list.append(1e3 * post / fs)
    if pre_list:
        info["min_pretrigger_length_msec"] = min(pre_list)
        info["max_pretrigger_length_msec"] = max(pre_list)
        info["min_posttrigger_length_msec"] = min(post_list)
        info["max_posttrigger_length_msec"] = max(post_list)
        info["min_edge_exclusion"] = min(info["min_pretrigger_length_msec"],
                                         info["min_posttrigger_length_msec"])
        info["max_edge_exclusion"] = max(info["max_pretrigger_length_msec"],
                                         info["max_posttrigger_length_msec"])
    return info


class EventBuilder:
    """Collects per-channel triggers and merges cross-channel coincidences
    (core/eventbuilder.py:56-497)."""

    def __init__(self):
        self._event_df: Optional[pd.DataFrame] = None
        self._current_trigger_id = 0
        self._current_event_time = -np.inf
        self._current_nb_samples = None
        self._trigger_objects: Dict[str, object] = {}
        self._trigger_names: List[str] = []

    def clear_event(self):
        self._event_df = None
        self._trigger_names = []

    # -- reference-parity surface (core/eventbuilder.py:40-160) ---------
    def get_event_df(self) -> Optional[pd.DataFrame]:
        """Current event dataframe (eventbuilder.py:47-53)."""
        return self._event_df

    def add_trigger_object(self, trigger_name: str, trigger_object):
        """Register a per-channel trigger engine under a name
        (eventbuilder.py:56-79). Any object with a
        ``find_triggers(trace, thresh, **kwargs)`` method or a callable
        returning a trigger dataframe works."""
        if trigger_name in self._trigger_objects:
            raise ValueError(f'ERROR: Trigger object "{trigger_name}" '
                             "already stored!")
        self._trigger_objects[trigger_name] = trigger_object

    def get_trigger_object(self, trigger_name: str):
        """Look up a registered trigger engine (eventbuilder.py:80-92)."""
        if trigger_name not in self._trigger_objects:
            raise ValueError(f'ERROR: Trigger object "{trigger_name}" '
                             "does not exist!")
        return self._trigger_objects[trigger_name]

    def add_trigger_data(self, trigger_name: str,
                         trigger_data: pd.DataFrame):
        """Add one channel's trigger dataframe to the current event,
        enforcing one submission per channel (eventbuilder.py:94-125)."""
        if trigger_name in self._trigger_names:
            raise ValueError(f"ERROR: Trigger data for channel "
                             f"{trigger_name} already added!")
        self._trigger_names.append(trigger_name)
        self.add_triggers(trigger_data)

    def acquire_triggers(self, trigger_name: str, trace, thresh,
                         **kwargs):
        """Run a registered trigger engine on a trace and file its
        triggers into the current event (eventbuilder.py:126-160).
        The engine is either a callable ``fn(trace, thresh, **kwargs)``
        or exposes ``find_triggers(trace, thresh, **kwargs)``; it must
        return a trigger dataframe."""
        obj = self.get_trigger_object(trigger_name)
        if (hasattr(obj, "update_trace")
                and hasattr(obj, "get_trigger_data_df")):
            # OptimumFilterTrigger protocol (pipelines.oftrigger;
            # reference eventbuilder.py:126-160): filter the trace,
            # trigger on it, read back the dataframe
            obj.update_trace(trace=trace)
            obj.find_triggers(thresh, **kwargs)
            df = obj.get_trigger_data_df()
        else:
            runner = getattr(obj, "find_triggers", None) or obj
            if not callable(runner):
                raise ValueError(
                    f'ERROR: Trigger object "{trigger_name}" is not '
                    "runnable — expected a callable, a find_triggers "
                    "method, or the OptimumFilterTrigger protocol")
            df = runner(trace, thresh, **kwargs)
        self._current_nb_samples = np.asarray(trace).shape[-1]
        self.add_trigger_data(trigger_name, df)
        return df

    def add_triggers(self, trigger_df: pd.DataFrame):
        if trigger_df is None or len(trigger_df) == 0:
            return
        if self._event_df is None:
            self._event_df = trigger_df
        else:
            self._event_df = pd.concat([self._event_df, trigger_df],
                                       ignore_index=True)
        # stable sort: equal trigger_index rows keep channel-addition
        # order (the reference's default quicksort leaves tie order
        # unspecified; stable is a deterministic refinement that the
        # batched drain reproduces exactly)
        self._event_df = self._event_df.sort_values(
            "trigger_index", ignore_index=True, kind="stable")

    def build_event(self, event_metadata: Optional[dict] = None,
                    fs: Optional[float] = None,
                    coincident_window_msec: Optional[float] = None,
                    coincident_window_samples: Optional[int] = None,
                    nb_trigger_channels: Optional[int] = None,
                    trace_length_continuous_sec: Optional[float] = None
                    ) -> Optional[pd.DataFrame]:
        """Merge coincidences + attach event metadata; returns the event's
        trigger dataframe (or None)."""
        event_metadata = dict(event_metadata or {})
        if fs is None:
            fs = event_metadata.get("sample_rate")

        if trace_length_continuous_sec is None:
            nb = self._current_nb_samples or event_metadata.get("nb_samples")
            if nb is None or fs is None:
                raise ValueError(
                    '"trace_length_continuous_sec" argument required')
            trace_length_continuous_sec = nb / fs

        event_time_start = np.nan
        if "event_time" in event_metadata:
            t = event_metadata["event_time"]
            event_time_start = max(t, self._current_event_time)
            self._current_event_time = (event_time_start
                                        + trace_length_continuous_sec)

        if self._event_df is None or len(self._event_df) == 0:
            return None

        if nb_trigger_channels is None or nb_trigger_channels > 1:
            self._merge_coincident_triggers(
                fs=fs, coincident_window_msec=coincident_window_msec,
                coincident_window_samples=coincident_window_samples)

        df = self._event_df
        n = len(df)
        # metadata columns added in ONE concat — per-column __setitem__
        # costs a block-manager insert each (~12 per event, a measured
        # host hot spot in the warm pipeline)
        new: dict = {}
        for key in ("processing_id", "data_type", "group_name"):
            new[key] = str(event_metadata.get(key, "")) or None
        for key in ("series_number", "event_number", "dump_number",
                    "fridge_run_number"):
            new[key] = np.int64(event_metadata.get(key, -1))

        trigger_times = df["trigger_time"].to_numpy()
        if np.isfinite(event_time_start):
            event_times = np.int64(np.round(trigger_times
                                            + event_time_start))
        else:
            event_times = np.full(n, -1, dtype=np.int64)
        new["event_time"] = event_times
        # elapsed-time columns (eventbuilder.py:301-313): event time minus
        # the respective start stamps when provided
        for key in ("series_start_time", "group_start_time",
                    "fridge_run_start_time"):
            start = event_metadata.get(key)
            new[key] = (event_times - np.int64(start)
                        if start is not None
                        and np.isfinite(event_time_start)
                        else np.full(n, -1, dtype=np.int64))
        new["trigger_prod_id"] = (np.arange(n, dtype=np.int64)
                                  + self._current_trigger_id + 1)
        # one-pass concat for the genuinely new columns, overwrite-in-place
        # for any that already exist (a second build_event on the same
        # builder, or admin columns arriving with the trigger dataframe,
        # must replace rather than duplicate — reference overwrite
        # semantics, eventbuilder.py:261-313)
        fresh = {k: v for k, v in new.items() if k not in df.columns}
        if fresh:
            df = pd.concat([df, pd.DataFrame(fresh, index=df.index)], axis=1)
        for k, v in new.items():
            if k not in fresh:
                df[k] = v
        self._current_trigger_id = int(df["trigger_prod_id"].iloc[-1])
        self._event_df = df
        return df

    def set_current_nb_samples(self, nb):
        self._current_nb_samples = nb

    def _merge_coincident_triggers(self, fs=None,
                                   coincident_window_msec=None,
                                   coincident_window_samples=None):
        merge_window = 0
        if coincident_window_msec is not None:
            if fs is None:
                raise ValueError('sample rate "fs" needs to be provided')
            merge_window = int(coincident_window_msec * fs / 1000)
        elif coincident_window_samples is not None:
            merge_window = coincident_window_samples
        if merge_window == 0:
            return

        df = self._event_df.reset_index(drop=True)
        idx = df["trigger_index"].to_numpy()
        d = df["trigger_delta_chi2"].to_numpy()
        names = df["trigger_channel"].to_numpy()

        # ranges of consecutive triggers closer than the window
        close = np.diff(idx) < merge_window
        close = np.concatenate(([0], close, [0]))
        edges = np.abs(np.diff(close))
        ranges = np.where(edges == 1)[0].reshape(-1, 2)

        coincident_groups: List[np.ndarray] = []
        for lo, hi in ranges:
            inds = np.arange(lo, hi + 1)
            chans = names[inds]
            uniq = np.unique(chans)
            if len(uniq) == 1:
                continue  # single channel = pileup, not coincidence
            if len(uniq) == len(chans):
                coincident_groups.append(inds)
                continue
            # mixed pileup/coincidence: split greedily so each sub-group
            # has unique channels (eventbuilder.py:405-442)
            current_chans: List[str] = []
            current_inds: List[int] = []
            splits: List[List[int]] = []
            for c, i in zip(chans, inds):
                if c in current_chans:
                    splits.append(current_inds)
                    current_chans, current_inds = [], []
                current_chans.append(c)
                current_inds.append(int(i))
            if current_inds:
                splits.append(current_inds)
            for sub in splits:
                if len(sub) > 1:
                    coincident_groups.append(np.asarray(sub))

        rows_to_drop: List[int] = []
        for inds in coincident_groups:
            inds = np.asarray(inds)
            primary = int(inds[np.argmax(d[inds])])
            primary_chan = names[primary]
            for other in inds[inds != primary]:
                other = int(other)
                other_chan = str(names[other])
                # copy the other channel's suffixed columns into the
                # primary row
                for col in df.columns:
                    if other_chan in col and pd.notnull(df.at[other, col]):
                        df.at[primary, col] = df.at[other, col]
                rows_to_drop.append(other)

        if rows_to_drop:
            df = df.drop(rows_to_drop).reset_index(drop=True)
        self._event_df = df


@dataclass
class _TriggerChannel:
    name: str                 # trigger name (dataframe channel label)
    channel_name: str         # raw channel (possibly 'a|b' compound)
    chan_indices: List[int]   # raw channel rows
    kernel: trig_ops.TriggerKernel
    threshold_sigma: float
    pileup_window: int
    chi2_threshold: float
    run_residual: bool
    sat_amps: Optional[list]
    edge_exclusion_msec: Optional[float]
    positive_pulses: bool = True
    # Δχ²-subtraction convolution basis (built when run_residual):
    # the residual pass runs as spikes + one overlap-save FFT conv
    # (ops/trigger.residual_subtract_conv) instead of a serial K-loop
    residual_basis: Optional[trig_ops.ResidualBasis] = None
    # dynamic-pileup-window mode (reference oftrigger.py dynamic=True):
    # jax-traceable fn(running-max Δχ²) → merge window in samples; set
    # programmatically via set_dynamic_threshold (functions can't come
    # from YAML)
    dynamic_threshold_function: Optional[object] = None
    dynamic_candidate_capacity: int = 4096
    dynamic_premerge_window: Optional[int] = None


class TriggerProcessing:
    """End-to-end continuous-data triggering (process/triggers.py:56-947)."""

    def __init__(self,
                 raw_files: Sequence[str] | str,
                 config: YamlConfig | str,
                 filter_data: FilterData | str | None = None,
                 processing_id: Optional[str] = None,
                 restricted: bool = False,
                 calib: bool = False,
                 facility: int = 1,
                 verbose: bool = True,
                 auto_prewarm: bool = True):
        from detprocess_jax.utils import jaxcache
        jaxcache.enable()   # compiled kernels persist across processes
        self._verbose = verbose
        self._facility = facility
        self._processing_id = processing_id
        self._restricted = restricted
        self._calib = calib
        self._reader = open_reader(raw_files)
        self._fs = self._reader.sample_rate
        self._available_channels = self._reader.channels

        if isinstance(config, str):
            config = YamlConfig(config, self._available_channels,
                                sample_rate=self._fs)
        self._config = config
        self._trigger_config = config.get_config("trigger")

        if isinstance(filter_data, str):
            filter_data = FilterData(verbose=verbose).load_hdf5(filter_data)
        if filter_data is None:
            path = (self._trigger_config.get("overall", {}) or {}).get(
                "filter_file")
            if path:
                filter_data = FilterData(verbose=verbose).load_hdf5(path)
        self._filter_data = filter_data

        self._channels: List[_TriggerChannel] = []
        self._build_channels()
        self._salt_injector = None    # host injector (set_salting)
        self._device_injector = None  # device injector (set_salting)
        self._output_group_path: Optional[str] = None
        import threading
        self._fn_cache: dict = {}
        self._fn_lock = threading.Lock()
        self._prewarm_thread = None
        self._active_process_key = None   # (capacity, mesh) of a live
                                          # process() call, set there
        if auto_prewarm and os.environ.get(
                "DETPROC_AUTO_PREWARM", "1") != "0":
            self._start_auto_prewarm()

    def get_output_path(self) -> Optional[str]:
        """Output group path of the last saved process() run
        (process/triggers.py:221-226)."""
        return self._output_group_path

    # ------------------------------------------------------------------
    def set_salting(self, injector):
        """Attach a salting injector.

        Either a HOST injector — callable(trace [C, L], admin) → salted
        trace (``Salting.make_injector``; forces host-converted float64
        reads) — or a DEVICE injector
        (``Salting.make_device_injector(channel_list)``): the host only
        plans tiny [E, K] index/amplitude arrays per batch and the
        template add runs on device after the ADC conversion, so salted
        runs keep the raw int16 upload path."""
        from detprocess_jax.ops.saltinject import DeviceInjector

        if isinstance(injector, DeviceInjector):
            self._salt_injector = None
            self._device_injector = injector
        else:
            self._salt_injector = injector
            self._device_injector = None

    def set_dynamic_threshold(self, channel: str, window_fn,
                              candidate_capacity: int = 4096,
                              premerge_window: Optional[int] = None):
        """Enable the dynamic-pileup-window mode for one trigger channel
        (reference find_triggers(dynamic=True, dynamic_threshold_function=…),
        oftrigger.py:684-688): ``window_fn`` maps the running maximum Δχ²
        of the current group to a merge window in samples. It must be
        jax-traceable — the merge then runs on device as a lax.scan over
        the first ``candidate_capacity`` candidate units
        (ops.trigger.find_triggers_dynamic_kernel). By default candidates
        are pre-merged RUNS of above-threshold samples, which is exact
        only for a MONOTONIC NON-DECREASING ``window_fn`` (the usual
        bigger-pulses-merge-wider case); for a non-monotonic ``window_fn``
        you MUST pass ``premerge_window=0`` (sample-level candidates,
        exact for any function, but wide high-SNR Δχ² bumps then eat the
        capacity fast). If an event's candidate count exceeds the
        capacity the pipeline warns loudly (results past the cap are
        unreliable) — raise ``candidate_capacity``."""
        for tc in self._channels:
            if tc.name == channel or tc.channel_name == channel:
                tc.dynamic_threshold_function = window_fn
                tc.dynamic_candidate_capacity = candidate_capacity
                tc.dynamic_premerge_window = premerge_window
                return
        raise ValueError(f"no trigger channel named {channel}")

    def _build_channels(self):
        cfg = self._trigger_config["channels"]
        for trig_name, tcfg in cfg.items():
            chan = tcfg["channel_name"]
            template_tag = tcfg.get("template_tag", "default")
            csd_tag = tcfg.get("csd_tag", "default")
            chans, sep = chutils.split_channel_name(
                chan, self._available_channels)
            if sep == "|":
                template, _ = self._filter_data.get_template(
                    chan, tag=template_tag)
                csd, _, nmeta = self._filter_data.get_csd(
                    chan, tag=csd_tag, return_metadata=True)
            else:
                template, _ = self._filter_data.get_template(
                    chan, tag=template_tag)
                psd, _, nmeta = self._filter_data.get_psd(
                    chan, tag=csd_tag, return_metadata=True)
                csd = psd.astype(complex)
            _, _, tmeta = self._filter_data.get_template(
                chan, tag=template_tag, return_metadata=True)
            # raw/filter consistency checks (reference
            # processing_data.py:303-318): a silent fs or length
            # mismatch would produce wrong physics, not an error
            from detprocess_jax.io.filterfile import check_fs_consistent
            check_fs_consistent(self._fs, tmeta, "template", chan,
                                template_tag)
            check_fs_consistent(self._fs, nmeta, "csd/psd", chan,
                                csd_tag)
            tlen = int(np.atleast_1d(np.asarray(template)).shape[-1])
            clen = int(np.asarray(csd).shape[-1])
            if tlen != clen:
                raise ValueError(
                    f"number of samples is not consistent between "
                    f"template (={tlen}) and csd/psd (={clen}) for "
                    f"trigger channel {chan} (tags "
                    f"'{template_tag}'/'{csd_tag}')")
            pretrig = int(tcfg.get("pretrigger_length_samples")
                          or tmeta.get("nb_pretrigger_samples")
                          or np.atleast_1d(template).shape[-1] // 2)
            bank = filterbank.make_ofnxm_bank(
                np.asarray(template), np.asarray(csd), self._fs, pretrig,
                ignored_frequency_peaks=tcfg.get("ignored_frequency_peaks"),
                ignore_harmonics=tcfg.get("ignore_harmonics", False))
            kernel = trig_ops.make_trigger_kernel(bank)

            thresh = float(tcfg.get("threshold_sigma", 5.0))
            pileup_msec = tcfg.get("pileup_window_msec")
            pileup = (int(pileup_msec * self._fs / 1000)
                      if pileup_msec is not None
                      else int(tcfg.get("pileup_window_samples", 0)))
            run_residual = bool(tcfg.get("run_residual", False))
            missing = [c for c in chans
                       if c not in self._available_channels]
            if missing:
                raise ValueError(
                    f"trigger channel '{trig_name}' reads raw "
                    f"channel(s) {missing} not present in the raw "
                    f"data; available channels: "
                    f"{self._available_channels}")
            self._channels.append(_TriggerChannel(
                name=trig_name,
                channel_name=chan,
                chan_indices=[self._available_channels.index(c)
                              for c in chans],
                kernel=kernel,
                threshold_sigma=thresh,
                pileup_window=pileup,
                chi2_threshold=trig_ops.chi2_threshold(thresh, bank.ntmps),
                run_residual=run_residual,
                sat_amps=tcfg.get("saturation_amplitudes"),
                edge_exclusion_msec=tcfg.get("edge_exclusion_msec"),
                positive_pulses=bool(tcfg.get("positive_pulses", True)),
                residual_basis=(trig_ops.make_residual_basis(kernel)
                                if run_residual else None),
            ))

    # ------------------------------------------------------------------
    DEFAULT_CAPACITY = 4096       # process() default — what auto-prewarm
    DEFAULT_EVENT_BATCH = 8       # compiles ahead of the first dispatch

    def _channel_fn_cached(self, tc: _TriggerChannel, capacity: int,
                           mesh=None):
        """Compiled channel fn from the instance cache (build on miss).

        Caching on the instance matters twice over: rebuilding per
        process() call would give each call a fresh jit identity and
        force XLA recompilation (measured ~10 s on a 1-core host), and
        the auto-prewarm thread must land its compiles in the SAME
        cache the dispatch path reads. The key carries every tc field
        read at trace time, so mutating the config
        (set_dynamic_threshold) invalidates the entry."""
        key = (tc.name, capacity, tc.chi2_threshold,
               tc.pileup_window, tc.run_residual,
               tuple(tc.sat_amps) if tc.sat_amps is not None else None,
               tc.positive_pulses,
               # the function OBJECT (identity-hashed), not id():
               # holding it in the key keeps it alive, so a freed
               # address can never alias a new function into a stale
               # compiled entry
               tc.dynamic_threshold_function,
               tc.dynamic_candidate_capacity,
               tc.dynamic_premerge_window,
               mesh)
        with self._fn_lock:
            fn = self._fn_cache.get(key)
            if fn is None:
                fn = self._fn_cache[key] = self._make_channel_fn(
                    tc, capacity, mesh)
        return fn

    def _start_auto_prewarm(self):
        """Background compile of the default-shape channel kernels.

        The cold-start XLA compile (~minutes per config on the dev
        chip, ~15 s executable-cache load warm) previously started only
        at the first dispatch; --prewarm moved it off the critical path
        but was operator-opt-in. This starts it at CONSTRUCTION in a
        daemon thread: by the time the caller has loaded trigger
        dataframes / read the first batch, the default-shape kernels
        are compiled (or loading from the persistent cache) and the
        first dispatch is a cache hit. Best-effort: any failure just
        falls back to compile-at-first-dispatch. Skipped on the CPU
        backend (compiles are cheap; the suite constructs hundreds of
        pipelines). Opt out with auto_prewarm=False or
        DETPROC_AUTO_PREWARM=0."""
        import threading

        # read the trace length on THIS thread: the reader is not meant
        # for concurrent use with a process() that may start immediately
        try:
            l = int(self._reader.get_metadata()["nb_samples"])
        except Exception:
            return

        def _mismatched():
            # a process() running with NON-default capacity or a mesh
            # would not use these kernels — keeping on compiling them
            # only serializes with the real compile on the backend's
            # compile queue
            key = self._active_process_key
            return (key is not None
                    and key != (self.DEFAULT_CAPACITY, None))

        def work():
            try:
                if jax.default_backend() == "cpu":
                    return
                for tc in self._channels:
                    if _mismatched():
                        return
                    fn = self._channel_fn_cached(
                        tc, self.DEFAULT_CAPACITY, None)
                    dummy = jnp.zeros(
                        (self.DEFAULT_EVENT_BATCH,
                         len(tc.chan_indices), l), jnp.float32)
                    out = fn(dummy)
                    np.asarray(jax.tree.leaves(out)[0]).ravel()[:1]
            except Exception:
                pass    # prewarm is best-effort only

        self._prewarm_thread = threading.Thread(
            target=work, daemon=True, name="detproc-auto-prewarm")
        self._prewarm_thread.start()

    def _make_channel_fn(self, tc: _TriggerChannel, capacity: int,
                         mesh=None):
        kernel = tc.kernel

        def saturation(trace):
            if tc.sat_amps is None:
                return None
            lpf = spectral.lowpass_filter(trace, 50e3, kernel.fs)
            return trig_ops.saturation_mask(
                lpf, tc.sat_amps, kernel.nt // 4,
                positive_pulses=tc.positive_pulses)

        def run_one(trace):
            q_blocks, _ = trig_ops.of_fir_blocks(trace, kernel)
            iw = jnp.asarray(kernel.iw_matrix)
            # fast path: no dynamic mode and a tileable pileup window →
            # fused Δχ² + two-level tiled merge; the full amplitude
            # series a(t) is never materialized (see
            # find_triggers_tiled). The residual pass stays on this
            # path: subtraction is a spike scatter + one FFT convolution
            # (residual_subtract_conv) in the same block layout.
            if (tc.dynamic_threshold_function is None
                    and trig_ops._tile_size(tc.pileup_window) >= 8):
                dchi2_b = trig_ops.delta_chi2_from_q(q_blocks, iw)
                ts = trig_ops.find_triggers_tiled(
                    dchi2_b, q_blocks, tc.chi2_threshold,
                    tc.pileup_window, capacity, amps_transform=iw)
                if not tc.run_residual:
                    return ts, None
                resid_b = trig_ops.residual_subtract_conv(
                    dchi2_b, ts, kernel, tc.residual_basis,
                    saturation(trace))
                ts2 = trig_ops.find_triggers_tiled(
                    resid_b, q_blocks, tc.chi2_threshold,
                    tc.pileup_window, capacity, amps_transform=iw)
                return ts, ts2
            l = trace.shape[-1]
            # sub-tile pileup windows: flat segmented-scan path
            dchi2_b, amps_b = trig_ops.delta_chi2_blocks(q_blocks, iw)
            dchi2 = dchi2_b.reshape(-1)[:l]
            amps = amps_b.reshape(amps_b.shape[0], -1)[:, :l]
            ts = trig_ops.find_triggers_blocks(
                dchi2_b, amps_b, tc.chi2_threshold, tc.pileup_window,
                capacity)
            if tc.run_residual:
                resid = trig_ops.residual_subtract_conv(
                    dchi2, ts, kernel, tc.residual_basis,
                    saturation(trace))
                ts2 = trig_ops.find_triggers_kernel(
                    resid, amps, tc.chi2_threshold, tc.pileup_window,
                    capacity)
                return ts, ts2
            return ts, None

        def run_batch_dynamic(traces):
            # dynamic mode, batched: the FIR/Δχ² stage vmaps per event,
            # but the inherently sequential candidate walk runs ONCE
            # with a batch-shared early-exit counter — at realistic
            # trigger rates it stops after a few candidate blocks
            # instead of paying candidate_capacity scan steps per event
            # (ops.trigger.find_triggers_dynamic_batched)
            iw = jnp.asarray(kernel.iw_matrix)

            def pre(trace):
                q_blocks, _ = trig_ops.of_fir_blocks(trace, kernel)
                l = trace.shape[-1]
                dchi2 = trig_ops.delta_chi2_from_q(
                    q_blocks, iw).reshape(-1)[:l]
                q_flat = q_blocks.reshape(q_blocks.shape[0], -1)[:, :l]
                if tc.sat_amps is None:
                    return dchi2, q_flat
                return dchi2, q_flat, saturation(trace)

            outs = jax.vmap(pre)(traces)
            dchi2, q_flat = outs[0], outs[1]
            sat = outs[2] if tc.sat_amps is not None else None
            kw = dict(candidate_capacity=tc.dynamic_candidate_capacity,
                      amps_transform=iw,
                      premerge_window=tc.dynamic_premerge_window)
            ts = trig_ops.find_triggers_dynamic_batched(
                dchi2, q_flat, tc.chi2_threshold,
                tc.dynamic_threshold_function, capacity, **kw)
            if not tc.run_residual:
                return ts, None
            resid = jax.vmap(
                lambda d, t_, s: trig_ops.residual_subtract_conv(
                    d, t_, kernel, tc.residual_basis, s),
                in_axes=(0, 0, None if sat is None else 0),
            )(dchi2, ts, sat)
            # the residual pass must merge with the same dynamic window
            # as the primary pass
            ts2 = trig_ops.find_triggers_dynamic_batched(
                resid, q_flat, tc.chi2_threshold,
                tc.dynamic_threshold_function, capacity, **kw)
            return ts, ts2

        # batched over continuous events: [E, C, L] → TriggerSets with a
        # leading E axis (the reference loops events in Python,
        # triggers.py:559-834)
        batched = (run_batch_dynamic
                   if tc.dynamic_threshold_function is not None
                   else jax.vmap(run_one))
        if mesh is None:
            return jax.jit(batched)
        # SPMD over the mesh: events are independent, so the batch shards
        # along the events axis with no collectives (process() pads the
        # batch to a device-count multiple)
        from jax.sharding import PartitionSpec as P
        from detprocess_jax.parallel import mesh as pmesh
        spec = P(pmesh.EVENTS_AXIS)
        return jax.jit(jax.shard_map(batched, mesh=mesh, in_specs=spec,
                                     out_specs=spec))

    def _trigger_set_arrays(self, tc: _TriggerChannel, ts):
        """(indices, dchi2, amplitudes[m, k]) for a host TriggerSet —
        or (None, None, None) when empty. Emits the capacity/candidate
        warnings (shared by the per-event and batched drains)."""
        count = int(ts.count)
        total = int(getattr(ts, "count_total", count))
        if total > count:
            print(f"WARNING: trigger capacity truncated {tc.name}: "
                  f"{total} merged groups found, {count} kept — raise "
                  f"process(capacity=...)")
        if (ts.n_above is not None
                and int(ts.n_above) > tc.dynamic_candidate_capacity):
            print(f"WARNING: dynamic-trigger candidate capacity exceeded "
                  f"on {tc.name}: {int(ts.n_above)} candidate units "
                  f"(above-threshold samples, or pre-merged runs when "
                  f"the pre-merge engages) > "
                  f"{tc.dynamic_candidate_capacity} — triggers after the "
                  f"cap are unreliable; raise "
                  f"set_dynamic_threshold(candidate_capacity=...)")
        if count == 0:
            return None, None, None
        return (np.asarray(ts.indices)[:count],
                np.asarray(ts.dchi2)[:count],
                np.asarray(ts.amplitudes)[:, :count])

    def _trigger_set_to_df(self, tc: _TriggerChannel, ts, trigger_type=4
                           ) -> pd.DataFrame:
        idx, d, amps = self._trigger_set_arrays(tc, ts)
        if idx is None:
            return pd.DataFrame()
        count = len(idx)
        data = {
            "trigger_index": idx.astype(np.int64),
            "trigger_time": idx / self._fs,
            "trigger_delta_chi2": d.astype(np.float64),
            "trigger_threshold_sigma": np.full(count, tc.threshold_sigma),
            "trigger_pileup_window": np.full(count, tc.pileup_window,
                                             dtype=np.int64),
            "trigger_type": np.full(count, trigger_type, dtype=np.int64),
        }
        m = amps.shape[0]
        for i in range(m):
            data[f"trigger_amplitude_{i}"] = amps[i].astype(np.float64)
        if m == 1:
            data["trigger_amplitude"] = amps[0].astype(np.float64)
        data["trigger_channel"] = [tc.name] * count
        # per-channel suffixed duplicates (oftrigger.py:1029-1034) added
        # to the dict BEFORE construction: one DataFrame build instead of
        # 14 block-manager column inserts per event
        for col in list(data):
            data[f"{col}_{tc.name}"] = data[col]
        return pd.DataFrame(data)

    # ------------------------------------------------------------------
    # gate for the channel-subset read/upload fast path (tests force
    # it off for A/B equality)
    CHANNEL_SUBSET_UPLOAD = True
    # gate for the batched single-channel drain (tests force it off
    # for A/B equality against the per-event EventBuilder path)
    FAST_DRAIN = True

    def process(self,
                nevents: int = -1,
                capacity: int = 4096,
                event_batch: int = 8,
                pipeline_depth: int = 2,
                prefetch_depth: int = 16,
                lgc_save: bool = False,
                output_path: Optional[str] = None,
                output_format: str = "hdf5",
                series_name: Optional[str] = None,
                group_name: str = "trigger",
                coincident_window_msec: Optional[float] = None,
                coincident_window_samples: Optional[int] = None,
                nb_events_per_dump: Optional[int] = None,
                resume: bool = False,
                lgc_output: bool = True,
                mesh=None,
                nreaders: int = 1,
                timer=None) -> Optional[pd.DataFrame]:
        """Run continuous-data triggering.

        ``nreaders``: number of concurrent host reader threads, each
        owning a disjoint file subset (``RawReader.split``) — the
        functional replacement for the reference's ``ncores``
        Pool-over-series (process/triggers.py:337-377). Reads release
        the GIL (fastio pread), so readers scale with host cores.
        Event order across subsets is nondeterministic, so — like the
        reference (triggers.py:272-274) — ``nreaders > 1`` requires
        processing all events (``nevents=-1``) and no ``resume``.

        ``timer``: optional ``utils.logging.StageTimer`` accumulating
        the host/device wall-time split (read / stack / dispatch /
        drain / dump stages).

        ``nb_events_per_dump`` writes a trigger dump every N continuous
        events (default: one dump at the end). ``resume=True`` (with
        lgc_save) scans output_path for existing dumps, skips continuous
        events at or before the last processed (series, event) and
        continues the same output series + dump numbering.

        ``mesh``: an optional ``jax.sharding.Mesh`` (see
        ``parallel.mesh.make_mesh``) — each dispatch is then SPMD over
        the mesh's devices with the event batch sharded along
        ``parallel.mesh.EVENTS_AXIS`` (events are independent, so there
        are no collectives). Batches are padded to a multiple of the
        device count and the padding is dropped on the host. This
        replaces the reference's Pool-over-series with data parallelism
        over chips inside ONE pipeline instance; raise ``event_batch``
        so every device gets several events per dispatch.
        """
        if nreaders > 1 and (nevents >= 0 or resume):
            # unordered multi-reader events break nevents-truncation and
            # resume-skip determinism — same constraint as the
            # reference's ncores>1 (process/triggers.py:272-274)
            raise ValueError("nreaders > 1 requires processing all "
                             "events (nevents=-1) without resume")
        overall = self._trigger_config.get("overall", {}) or {}
        if coincident_window_msec is None:
            coincident_window_msec = overall.get("coincident_window_msec")
        if coincident_window_samples is None:
            coincident_window_samples = overall.get(
                "coincident_window_samples")

        # tell a still-running auto-prewarm thread what this call
        # actually needs: with a non-default capacity or a mesh, the
        # prewarm's default-shape compiles would only serialize with
        # the real ones on the backend compile queue
        self._active_process_key = (capacity, mesh)
        fns = {tc.name: self._channel_fn_cached(tc, capacity, mesh)
               for tc in self._channels}
        builder = EventBuilder()
        import time as _time

        t_start = _time.time()
        frames: List[pd.DataFrame] = []
        all_frames: List[pd.DataFrame] = []
        out_series = series_name or create_series_name(self._facility)
        if lgc_save:
            if output_path is None:
                raise ValueError("output_path required with lgc_save")
            os.makedirs(output_path, exist_ok=True)
            self._output_group_path = output_path

        self._reader.rewind()
        total = 0
        dump_num = 0
        resume_after = None         # (series_number, event_number)
        if lgc_save and resume:
            found = self._scan_resume(output_path, group_name,
                                      output_format)
            if found is not None:
                out_series, dump_num, resume_after = found
                if self._verbose:
                    print(f"INFO: resuming series {out_series} after "
                          f"series/event {resume_after} "
                          f"(dump {dump_num})")
        events_done = 0      # events drained through handle_event
        events_dumped = 0    # events covered by written dumps
        livetime = 0.0   # processed exposure minus edge exclusions
                         # (scripts/process.py:459-463 livetime accounting)
        max_edge = max((tc.edge_exclusion_msec or 0.0
                        for tc in self._channels), default=0.0)

        def handle_event(traces_np, admin, per_channel):
            nonlocal livetime
            event_sec = traces_np.shape[-1] / self._fs
            livetime += max(event_sec - 2 * max_edge * 1e-3, 0.0)
            builder.clear_event()
            builder.set_current_nb_samples(traces_np.shape[-1])
            for tc in self._channels:
                ts, ts2 = per_channel[tc.name]
                if ts2 is not None:
                    # dedup-merge first + residual pass
                    # (combine_trigger_data, oftrigger.py:262-321)
                    ts = trig_ops.combine_trigger_sets(ts, ts2)
                df = self._trigger_set_to_df(tc, ts)
                if tc.edge_exclusion_msec is not None and len(df):
                    tmin = tc.edge_exclusion_msec * 1e-3
                    tmax = traces_np.shape[-1] / self._fs - tmin
                    keep = ((df["trigger_time"] > tmin)
                            & (df["trigger_time"] < tmax))
                    df = df[keep].reset_index(drop=True)
                    df[f"trigger_edge_exclusion_time_{tc.name}"] = tmin
                    df[f"trigger_livetime_{tc.name}"] = livetime
                builder.add_triggers(df)

            meta = dict(admin)
            meta["sample_rate"] = self._fs
            meta["processing_id"] = self._processing_id or ""
            event_df = builder.build_event(
                event_metadata=meta, fs=self._fs,
                coincident_window_msec=coincident_window_msec,
                coincident_window_samples=coincident_window_samples,
                nb_trigger_channels=len(self._channels))
            if event_df is not None and len(event_df):
                frames.append(event_df.copy())

        def pack_sets(batch_sets):
            """Pack a batch of device TriggerSets into TWO device
            buffers (one int32, one float32) and START their host
            copies.

            The drain loop previously converted each field per EVENT —
            6 fields x sets x E events is ~100 device→host transfers per
            batch, each a device round trip. Separate int/float
            packs because the device runs without x64: int32 trigger
            indices do not fit exactly in float32 beyond 2^24-sample
            traces. Packing runs at DISPATCH time and the copies are
            issued async (copy_to_host_async where the backend supports
            it), so with pipeline_depth >= 1 the transfer round trips
            overlap the next batch's read/dispatch instead of stalling
            the drain.
            """
            int_fields = ("indices", "count", "count_total", "n_above")
            float_fields = ("dchi2", "amplitudes")
            ints, floats, specs = [], [], []
            ioff = foff = 0
            for name, pair in batch_sets.items():
                for si, t in enumerate(pair):
                    if t is None:
                        continue
                    for fname in int_fields + float_fields:
                        arr = getattr(t, fname)
                        if arr is None:
                            continue
                        shape = tuple(np.shape(arr))
                        size = int(np.prod(shape)) if shape else 1
                        if fname in int_fields:
                            ints.append(jnp.ravel(
                                jnp.asarray(arr)).astype(jnp.int32))
                            specs.append((name, si, fname, shape, "i",
                                          ioff, size))
                            ioff += size
                        else:
                            floats.append(jnp.ravel(
                                jnp.asarray(arr)).astype(jnp.float32))
                            specs.append((name, si, fname, shape, "f",
                                          foff, size))
                            foff += size
            ibuf = jnp.concatenate(ints) if ints else None
            fbuf = jnp.concatenate(floats) if floats else None
            for buf in (ibuf, fbuf):
                if buf is not None and hasattr(buf, "copy_to_host_async"):
                    try:
                        buf.copy_to_host_async()
                    except Exception:   # backend without async copies
                        pass
            names = {name: tuple(t is not None for t in pair)
                     for name, pair in batch_sets.items()}
            return ibuf, fbuf, specs, names

        def sets_to_host(packed_sets):
            """Finish the host copies started by pack_sets and rebuild
            per-channel host TriggerSets."""
            ibuf_d, fbuf_d, specs, names = packed_sets
            ibuf = (np.asarray(ibuf_d) if ibuf_d is not None
                    else np.zeros(0, np.int32))
            fbuf = (np.asarray(fbuf_d) if fbuf_d is not None
                    else np.zeros(0, np.float32))
            fields: dict = {}
            for name, si, fname, shape, kind, off, size in specs:
                buf = ibuf if kind == "i" else fbuf
                fields.setdefault((name, si), {})[fname] = (
                    buf[off:off + size].reshape(shape))
            out = {}
            for name, present in names.items():
                rebuilt = []
                for si, here in enumerate(present):
                    if not here:
                        rebuilt.append(None)
                        continue
                    fd = fields[(name, si)]
                    rebuilt.append(trig_ops.TriggerSet(
                        indices=fd["indices"], dchi2=fd["dchi2"],
                        amplitudes=fd["amplitudes"], count=fd["count"],
                        count_total=fd["count_total"],
                        n_above=fd.get("n_above")))
                out[name] = tuple(rebuilt)
            return out

        def ts_event_view(t, e):
            """Event-``e`` view of one HOST TriggerSet bundle — pure
            numpy slicing, no device traffic. Single owner of the
            field-slicing (used by both drains: a field added to
            TriggerSet must slice identically on both paths)."""
            if t is None:
                return None
            return trig_ops.TriggerSet(
                indices=t.indices[e], dchi2=t.dchi2[e],
                amplitudes=t.amplitudes[e], count=t.count[e],
                count_total=t.count_total[e],
                n_above=(t.n_above[e]
                         if t.n_above is not None else None))

        def slice_sets(batch_sets, e):
            """Per-event view of HOST TriggerSets (sets_to_host output)."""
            return {name: (ts_event_view(ts, e), ts_event_view(ts2, e))
                    for name, (ts, ts2) in batch_sets.items()}

        # batched + pipelined event processing: ``event_batch`` continuous
        # events per dispatch, ``pipeline_depth`` dispatches in flight;
        # a reader thread keeps ``prefetch_depth`` events decoded ahead so
        # HDF5 IO overlaps device compute (io.prefetch)
        # RAW (stored-dtype) reads when no salt injector: traces upload
        # in the stored dtype — int16 ADC codes for real pytesdaq data,
        # HALF the host→device bytes of float32 — and the ADC→amps
        # conversion runs on device, fused into the FIR chain (the
        # reference always converts on host, processing_data.py:520-526).
        # A HOST salting injector adds float64 templates on the host, so
        # that path keeps host-converted float64 reads; a DEVICE
        # injector (Salting.make_device_injector) only plans on the host
        # and keeps the raw path.
        raw_mode = self._salt_injector is None
        nchan_all = len(self._available_channels)
        salt_templates = (jnp.asarray(self._device_injector.templates)
                          if self._device_injector is not None else None)
        # CHANNEL-SUBSET reads + uploads: only the channels the trigger
        # config actually filters need to leave the file — production
        # raw files carry many channels while triggering uses a few, so
        # reading (and host→device uploading) the full stack wastes
        # bandwidth linearly in the unused-channel count. Salted runs
        # keep the full stack: the injectors index the FULL channel
        # list (Salting.make_injector / make_device_injector channel
        # lists are the caller's).
        read_channels = None
        chan_subidx = {tc.name: tc.chan_indices for tc in self._channels}
        if (self.CHANNEL_SUBSET_UPLOAD
                and self._salt_injector is None
                and self._device_injector is None):
            needed = sorted({int(i) for tc in self._channels
                             for i in tc.chan_indices})
            if len(needed) < nchan_all:
                read_channels = [self._available_channels[i]
                                 for i in needed]
                remap = {orig: pos for pos, orig in enumerate(needed)}
                chan_subidx = {tc.name: [remap[int(i)]
                                         for i in tc.chan_indices]
                               for tc in self._channels}
                nchan_all = len(needed)
        # nreaders > 1: concurrent reader threads over disjoint file
        # subsets (io.prefetch.ParallelEventPrefetcher) — the functional
        # replacement for the reference's ncores Pool-over-series
        if prefetch_depth > 0 or nreaders > 1:
            from detprocess_jax.io.prefetch import prefetch_events
            source = prefetch_events(
                self._reader, depth=max(prefetch_depth, 1),
                raw=raw_mode, dtype=None if raw_mode else np.float64,
                nreaders=nreaders, channels=read_channels)
            prefetching = True
        else:
            source = self._reader
            prefetching = False
        from contextlib import nullcontext
        stage = (timer.stage if timer is not None
                 else (lambda name: nullcontext()))
        # dump writes go through a background writer thread so table IO
        # overlaps device compute (tables.AsyncWriter)
        writer = tables.AsyncWriter() if lgc_save else None
        inflight = []

        # batched drain: a whole batch of events becomes ONE DataFrame
        # of numpy columns — per-event pandas construction measured
        # ~5 ms/event of pure host time. Multi-channel configs run the same path:
        # the cross-channel coincidence merge
        # (core/eventbuilder.py:336-497 semantics — diff-window ranges,
        # greedy unique-channel split, max-Δχ² primary, suffixed-column
        # substring copy) is applied to the numpy columns before the
        # frame is built. Output columns, order, dtypes, and
        # trigger_prod_id numbering are identical to the EventBuilder
        # path (equality-tested incl. residual mode, edge exclusion,
        # salted runs, and 3-channel coincidence).
        use_fast_drain = self.FAST_DRAIN
        merge_window = 0
        if coincident_window_msec is not None:
            merge_window = int(coincident_window_msec * self._fs / 1000)
        elif coincident_window_samples is not None:
            # keep the RAW value (no int()): the EventBuilder path
            # compares against it un-truncated, and a non-integer
            # window would otherwise merge differently on the two
            # paths (62 < 62.5 vs 62 < 62)
            merge_window = coincident_window_samples
        fast_state = {"event_time": -np.inf, "trigger_id": 0,
                      "col_order": [], "col_seen": set()}
        META_COLS = ("processing_id", "data_type", "group_name",
                     "series_number", "event_number", "dump_number",
                     "fridge_run_number", "event_time",
                     "series_start_time", "group_start_time",
                     "fridge_run_start_time", "trigger_prod_id")

        def _chan_base_cols(m):
            """One channel's UNSUFFIXED columns in _trigger_set_to_df
            order — the single owner of this list: the suffixed-column
            build and the column-order union both derive from it, so
            they cannot drift apart."""
            base = ["trigger_index", "trigger_time", "trigger_delta_chi2",
                    "trigger_threshold_sigma", "trigger_pileup_window",
                    "trigger_type"]
            base += [f"trigger_amplitude_{i}" for i in range(m)]
            if m == 1:
                base += ["trigger_amplitude"]
            base += ["trigger_channel"]
            return base

        def _chan_cols(tc, m):
            """One channel's contributed columns (base, suffixed
            duplicates, edge-exclusion tail)."""
            base = _chan_base_cols(m)
            out = base + [f"{b}_{tc.name}" for b in base]
            if tc.edge_exclusion_msec is not None:
                out += [f"trigger_edge_exclusion_time_{tc.name}",
                        f"trigger_livetime_{tc.name}"]
            return out

        def drain_fast(entry):
            nonlocal events_done, livetime
            btr, badm, packed_sets = entry
            fs = self._fs
            with stage("drain"):
                hsets = sets_to_host(packed_sets)
                E = len(btr)
                nb = btr[0].shape[-1]
                event_sec = nb / fs
                # per-event bookkeeping for ALL events (the event-time
                # chain advances whether or not the event triggered)
                ev_meta = []           # (admin, livetime_e, ev_start)
                for e in range(E):
                    livetime += max(event_sec - 2 * max_edge * 1e-3, 0.0)
                    admin = badm[e]
                    # event-time chain (EventBuilder.build_event):
                    # consecutive continuous events never overlap
                    t = admin.get("event_time")
                    if t is not None:
                        ev_start = max(t, fast_state["event_time"])
                        fast_state["event_time"] = ev_start + event_sec
                    else:
                        ev_start = np.nan
                    ev_meta.append((admin, livetime, ev_start))
                events_done += E

                # flatten each channel's per-event triggers (residual
                # combine order, edge-filtered) with owning-event ids
                chan_flat = []   # (ci, tc, ev[], idx[], d[], amps[m, k])
                present = np.zeros((E, len(self._channels)), bool)
                for ci, tc in enumerate(self._channels):
                    ts_b, ts2_b = hsets[tc.name]
                    evs, idxs, ds, ampss = [], [], [], []
                    for e in range(E):
                        ts = ts_event_view(ts_b, e)
                        ts2 = ts_event_view(ts2_b, e)
                        if ts2 is not None:
                            # dedup-merge first + residual pass
                            # (combine_trigger_data semantics)
                            ts = trig_ops.combine_trigger_sets(ts, ts2)
                        idx, d, amps = self._trigger_set_arrays(tc, ts)
                        if idx is None:
                            continue
                        if tc.edge_exclusion_msec is not None:
                            tmin = tc.edge_exclusion_msec * 1e-3
                            tmax = event_sec - tmin
                            tt = idx / fs
                            keep = (tt > tmin) & (tt < tmax)
                            idx, d = idx[keep], d[keep]
                            amps = amps[:, keep]
                            if len(idx) == 0:
                                continue
                        present[e, ci] = True
                        evs.append(np.full(len(idx), e, np.int64))
                        idxs.append(idx.astype(np.int64))
                        ds.append(d.astype(np.float64))
                        ampss.append(amps.astype(np.float64))
                    if evs:
                        chan_flat.append((
                            ci, tc, np.concatenate(evs),
                            np.concatenate(idxs), np.concatenate(ds),
                            np.concatenate(ampss, axis=1)))
                if not chan_flat:
                    return

                m_by_ci = {f[0]: f[5].shape[0] for f in chan_flat}
                max_m = max(m_by_ci.values())
                any_m1 = any(m == 1 for m in m_by_ci.values())
                # build every per-row array in channel-block (pre-sort)
                # layout, then apply ONE permutation to all of them —
                # residual combine order is not index-sorted, so partial
                # fills against post-sort positions would misalign
                ev_all = np.concatenate([f[2] for f in chan_flat])
                idx_all = np.concatenate([f[3] for f in chan_flat])
                d_all = np.concatenate([f[4] for f in chan_flat])
                rank_all = np.concatenate(
                    [np.full(len(f[2]), f[0], np.int64)
                     for f in chan_flat])
                names_all = np.concatenate(
                    [np.full(len(f[2]), f[1].name, object)
                     for f in chan_flat])
                thr = np.concatenate(
                    [np.full(len(f[2]), f[1].threshold_sigma)
                     for f in chan_flat])
                pw = np.concatenate(
                    [np.full(len(f[2]), f[1].pileup_window, np.int64)
                     for f in chan_flat])
                amp_blocks = []
                for ci, tc, evs, idxs, ds, amps in chan_flat:
                    pad = np.full((max_m, amps.shape[1]), np.nan)
                    pad[:amps.shape[0]] = amps
                    amp_blocks.append(pad)
                amp_cols = np.concatenate(amp_blocks, axis=1)
                amp1 = None
                if any_m1:
                    amp1 = np.concatenate(
                        [f[5][0] if f[5].shape[0] == 1
                         else np.full(len(f[2]), np.nan)
                         for f in chan_flat])
                # ONE stable sort by (event, trigger_index): equal-index
                # rows keep channel order — exactly what the iterated
                # stable sort_values in EventBuilder.add_triggers yields
                perm = np.argsort(ev_all * np.int64(nb + 1) + idx_all,
                                  kind="stable")
                ev_all, idx_all = ev_all[perm], idx_all[perm]
                d_all, rank_all = d_all[perm], rank_all[perm]
                names_all, thr, pw = names_all[perm], thr[perm], pw[perm]
                amp_cols = amp_cols[:, perm]
                if amp1 is not None:
                    amp1 = amp1[perm]
                n = len(idx_all)
                tt_all = idx_all / fs

                # --- trigger columns (pre-merge, pre-metadata) --------
                data: dict = {}
                pos = {ci: np.flatnonzero(rank_all == ci)
                       for ci in m_by_ci}
                lts = np.array([mt[1] for mt in ev_meta])
                data["trigger_index"] = idx_all
                data["trigger_time"] = tt_all
                data["trigger_delta_chi2"] = d_all
                data["trigger_threshold_sigma"] = thr
                data["trigger_pileup_window"] = pw
                data["trigger_type"] = np.full(n, 4, np.int64)
                for i in range(max_m):
                    data[f"trigger_amplitude_{i}"] = amp_cols[i]
                if amp1 is not None:
                    data["trigger_amplitude"] = amp1
                data["trigger_channel"] = names_all

                def _suffixed(base_vals, p):
                    """Channel-masked copy of a base column with pandas
                    concat promotion semantics: when other channels'
                    rows exist, ints promote to float64 + NaN and
                    object columns get NaN holes."""
                    if len(p) == n:
                        return base_vals.copy()
                    if base_vals.dtype == object:
                        out = np.full(n, np.nan, object)
                    else:
                        out = np.full(n, np.nan, np.float64)
                    out[p] = base_vals[p]
                    return out

                for ci, tc, evs, idxs, ds, amps in chan_flat:
                    p = pos[ci]
                    for b in _chan_base_cols(amps.shape[0]):
                        data[f"{b}_{tc.name}"] = _suffixed(data[b], p)
                    if tc.edge_exclusion_msec is not None:
                        col = np.full(n, np.nan)
                        col[p] = tc.edge_exclusion_msec * 1e-3
                        data[f"trigger_edge_exclusion_time_{tc.name}"] = col
                        lv = np.full(n, np.nan)
                        lv[p] = lts[ev_all[p]]
                        data[f"trigger_livetime_{tc.name}"] = lv

                # --- coincidence merge (eventbuilder.py:336-497) ------
                drop = np.zeros(n, bool)
                if (merge_window > 0 and len(self._channels) > 1
                        and n > 1):
                    close = ((np.diff(idx_all) < merge_window)
                             & (ev_all[1:] == ev_all[:-1]))
                    close = np.concatenate(
                        ([0], close.astype(np.int8), [0]))
                    ranges = np.flatnonzero(
                        np.abs(np.diff(close)) == 1).reshape(-1, 2)
                    cols = list(data)
                    # substring column-match rule (reference
                    # np.char.find >= 0), computed once per batch
                    match_cols = {tc.name: [c for c in cols
                                            if tc.name in c]
                                  for _, tc, *_ in chan_flat}
                    groups = []
                    for lo, hi in ranges:
                        inds = np.arange(lo, hi + 1)
                        chans = names_all[lo:hi + 1]
                        uniq = set(chans.tolist())
                        if len(uniq) == 1:
                            continue   # single channel = pileup
                        if len(uniq) == len(chans):
                            groups.append(inds)
                            continue
                        # mixed pileup/coincidence: split greedily so
                        # each sub-group has unique channels
                        cur_ch: set = set()
                        cur_i: list = []
                        splits = []
                        for c, i in zip(chans, inds):
                            if c in cur_ch:
                                splits.append(cur_i)
                                cur_ch, cur_i = set(), []
                            cur_ch.add(c)
                            cur_i.append(int(i))
                        if cur_i:
                            splits.append(cur_i)
                        for sub in splits:
                            if len(sub) > 1:
                                groups.append(np.asarray(sub))
                    for inds in groups:
                        inds = np.asarray(inds)
                        primary = int(inds[np.argmax(d_all[inds])])
                        for other in inds[inds != primary]:
                            other = int(other)
                            for cname in match_cols[
                                    str(names_all[other])]:
                                v = data[cname][other]
                                if v is None or v != v:   # notnull rule
                                    continue
                                data[cname][primary] = v
                            drop[other] = True
                if drop.any():
                    keep_r = ~drop
                    for c in list(data):
                        data[c] = data[c][keep_r]
                    ev_all = ev_all[keep_r]
                    n = len(ev_all)
                if n == 0:
                    return
                tt = data["trigger_time"]

                # --- metadata columns (build_event order) -------------
                counts = np.bincount(ev_all, minlength=E)
                counts_nz = counts[counts > 0]
                admins_nz = [ev_meta[e] for e in range(E)
                             if counts[e] > 0]

                def rep(vals, dtype=None):
                    arr = np.array(vals, dtype=dtype)
                    return np.repeat(arr, counts_nz)

                for key in ("processing_id", "data_type", "group_name"):
                    def meta_str(a):
                        if key == "processing_id":
                            return str(self._processing_id or "") or None
                        return str(a.get(key, "")) or None
                    data[key] = rep([meta_str(a)
                                     for a, _, _ in admins_nz], object)
                for key in ("series_number", "event_number",
                            "dump_number", "fridge_run_number"):
                    data[key] = rep([np.int64(a.get(key, -1))
                                     for a, _, _ in admins_nz], np.int64)
                starts = np.array([s for _, _, s in admins_nz])
                starts_rep = np.repeat(starts, counts_nz)
                finite = np.isfinite(starts_rep)
                event_times = np.where(
                    finite, np.round(tt + np.where(finite, starts_rep,
                                                   0.0)),
                    -1).astype(np.int64)
                data["event_time"] = event_times
                for key in ("series_start_time", "group_start_time",
                            "fridge_run_start_time"):
                    st = rep([np.int64(a.get(key, -1))
                              if a.get(key) is not None else np.int64(-1)
                              for a, _, _ in admins_nz], np.int64)
                    have = np.array([a.get(key) is not None
                                     for a, _, _ in admins_nz])
                    have_rep = np.repeat(have, counts_nz) & finite
                    data[key] = np.where(have_rep, event_times - st,
                                         -1).astype(np.int64)
                data["trigger_prod_id"] = (
                    np.arange(n, dtype=np.int64)
                    + fast_state["trigger_id"] + 1)
                fast_state["trigger_id"] += n

                # --- column order: replicate the EventBuilder path's
                # first-appearance union (per-event channel frames in
                # add order, then metadata; pd.concat appends unseen
                # columns of later frames at the end) -----------------
                order = fast_state["col_order"]
                seen = fast_state["col_seen"]
                for e in range(E):
                    got_any = False
                    for ci, tc in enumerate(self._channels):
                        if not present[e, ci]:
                            continue
                        got_any = True
                        for c in _chan_cols(tc, m_by_ci[ci]):
                            if c not in seen:
                                seen.add(c)
                                order.append(c)
                    if got_any:
                        for c in META_COLS:
                            if c not in seen:
                                seen.add(c)
                                order.append(c)
                frames.append(pd.DataFrame(
                    {c: data[c] for c in order if c in data}))

        def drain(entry):
            nonlocal events_done
            if use_fast_drain:
                drain_fast(entry)
                return
            btr, badm, bsets = entry
            with stage("drain"):
                hsets = sets_to_host(bsets)
                for e in range(len(btr)):
                    handle_event(btr[e], badm[e], slice_sets(hsets, e))
            events_done += len(btr)

        try:
            while nevents < 0 or total < nevents:
                batch_traces, batch_admins, batch_convs = [], [], []
                want = event_batch if nevents < 0 else min(
                    event_batch, nevents - total)
                with stage("read"):
                    for _ in range(want):
                        if prefetching:
                            traces, admin = source.read_next_event()
                        elif raw_mode:
                            traces, admin = source.read_next_event(
                                channels=read_channels, dtype=None,
                                adctoamp=False)
                        else:
                            traces, admin = source.read_next_event(
                                channels=read_channels,
                                dtype=np.float64)
                        if traces is None:
                            break
                        if resume_after is not None and (
                                admin["series_number"],
                                admin["event_number"]) <= resume_after:
                            continue
                        if self._salt_injector is not None:
                            traces = self._salt_injector(traces, admin)
                        conv = admin.pop("adc_conv", None)
                        batch_convs.append(
                            np.ones(nchan_all, np.float32) if conv is None
                            else np.asarray(conv, np.float32))
                        batch_traces.append(traces)
                        batch_admins.append(admin)
                if not batch_traces:
                    if resume_after is not None and traces is not None:
                        continue          # batch fully skipped, keep reading
                    break
                total += len(batch_traces)
                with stage("dispatch"):
                    host_stack = np.stack(batch_traces)
                    if not np.issubdtype(host_stack.dtype, np.integer):
                        # float-stored data uploads as float32 (as before);
                        # integer ADC codes upload AS STORED — half the bytes
                        host_stack = host_stack.astype(np.float32,
                                                       copy=False)
                    conv_stack = (np.stack(batch_convs) if raw_mode
                                  else None)
                    plan = (self._device_injector.plan(batch_admins)
                            if self._device_injector is not None else None)
                    if mesh is not None:
                        n_dev = mesh.devices.size
                        pad = (-len(batch_traces)) % n_dev
                        if pad:
                            # repeat the last event so E divides the device
                            # count; slice_sets below only reads e < len(btr)
                            def _padrep(a):
                                return np.concatenate(
                                    [a, np.repeat(a[-1:], pad, axis=0)])
                            host_stack = _padrep(host_stack)
                            if conv_stack is not None:
                                conv_stack = _padrep(conv_stack)
                            if plan is not None:
                                plan = type(plan)(*(_padrep(f)
                                                    for f in plan))
                        from jax.sharding import (NamedSharding,
                                                  PartitionSpec as P)
                        from detprocess_jax.parallel import mesh as pmesh
                        # device_put on the HOST array uploads each shard to
                        # its device directly; jnp.asarray first would stage
                        # the full batch on device 0 and reshard (double
                        # transfer)
                        sharding = NamedSharding(mesh,
                                                 P(pmesh.EVENTS_AXIS))
                        put = lambda a: jax.device_put(a, sharding)  # noqa: E731
                    else:
                        put = jnp.asarray
                    stacked = put(host_stack)
                    if conv_stack is not None:
                        # on-device ADC→amps conversion (one elementwise
                        # pass — what the float path's upload staging
                        # already cost)
                        stacked = saltinject.adc_convert(
                            stacked, put(conv_stack))
                    if plan is not None:
                        # on-device salt injection: K masked template adds
                        # per event (ops.saltinject); the host only built
                        # the plan
                        stacked = saltinject.inject_salts(
                            stacked, put(plan.idx), put(plan.chan),
                            put(plan.tid), put(plan.amp), salt_templates)
                    batch_sets = {}
                    for tc in self._channels:
                        sub = stacked[:, jnp.asarray(
                            chan_subidx[tc.name]), :]
                        batch_sets[tc.name] = fns[tc.name](sub)
                    packed_sets = pack_sets(batch_sets)
                inflight.append((batch_traces, batch_admins, packed_sets))
                while len(inflight) > max(pipeline_depth, 0):
                    drain(inflight.pop(0))
                if (lgc_save and nb_events_per_dump
                        and events_done - events_dumped
                        >= nb_events_per_dump
                        and frames):
                    with stage("dump"):
                        dump_num = self._write_dump(
                            frames, output_path, output_format,
                            out_series, group_name, dump_num,
                            writer=writer)
                    all_frames.extend(frames)
                    frames.clear()
                    events_dumped = events_done
                if self._verbose and total % 100 < event_batch:
                    # note: triggers from still-inflight dispatches are not
                    # counted yet — this is a progress line, not a total
                    ntrig = sum(len(f) for f in frames)
                    print(f"INFO: processed {total} continuous events "
                          f"({ntrig} triggers so far)")
            for entry in inflight:
                drain(entry)
            if lgc_save and frames:
                with stage("dump"):
                    dump_num = self._write_dump(
                        frames, output_path, output_format, out_series,
                        group_name, dump_num, writer=writer)
        except BaseException:
            if writer is not None:       # don't mask the original error
                try:
                    writer.close()
                except BaseException:
                    pass
            raise
        finally:
            if prefetching:
                source.close()
        if writer is not None:
            writer.close()       # drain async dump writes; surface errors

        all_frames.extend(frames)
        result = (pd.concat(all_frames, ignore_index=True)
                  if all_frames else pd.DataFrame())
        wall = _time.time() - t_start
        if self._verbose:
            print(f"INFO: processed {total} continuous events, "
                  f"{len(result)} triggers in {wall:.1f} s")
        if lgc_save and output_path is not None:
            tables.write_job_summary(
                output_path, self._trigger_prefix(), group_name,
                out_series, {
                    "workload": "trigger",
                    "processing_id": self._processing_id,
                    "series_name": out_series,
                    "continuous_events": int(total),
                    "triggers": int(len(result)),
                    "livetime_sec": float(livetime),
                    "wall_sec": round(wall, 3),
                    "events_per_sec": round(total / wall, 3) if wall else 0,
                    "dumps": int(dump_num),
                    "channels": [tc.name for tc in self._channels],
                    "thresholds_sigma": {tc.name: tc.threshold_sigma
                                         for tc in self._channels},
                    "config_digest": tables.config_digest(
                        self._trigger_config),
                    "restricted": self._restricted,
                    "calib": self._calib,
                })
        return result if lgc_output else None


    def _trigger_prefix(self) -> str:
        return tables.build_prefix("threshtrig", self._processing_id,
                                   self._restricted, self._calib)

    def _write_dump(self, frames, output_path, output_format, out_series,
                    group_name, dump_num, writer=None) -> int:
        df = pd.concat(frames, ignore_index=True)
        if not len(df):
            return dump_num
        dump_num += 1
        path = tables.output_file_name(
            output_path, self._trigger_prefix(), group_name, out_series,
            dump_num, "parquet" if output_format == "parquet" else "hdf5")
        if writer is not None:
            writer.write(df, path, fmt=output_format)   # async (overlaps
        else:                                           # device compute)
            tables.write_table(df, path, fmt=output_format)
        return dump_num

    def _scan_resume(self, output_path, group_name, output_format):
        """(series_name, last_dump, (series_number, event_number)) of the
        newest existing dump set, or None."""
        import glob
        import re

        prefix = self._trigger_prefix()
        ext = "parquet" if output_format == "parquet" else "hdf5"
        rx = re.compile(re.escape(prefix) + "_" + re.escape(group_name)
                        + r"_(.+)_F(\d+)\." + ext + "$")
        by_series: Dict[str, list] = {}
        for f in sorted(glob.glob(os.path.join(
                output_path, f"{prefix}_{group_name}_*.{ext}"))):
            m = rx.match(os.path.basename(f))
            if m:
                by_series.setdefault(m.group(1), []).append(
                    (int(m.group(2)), f))
        if not by_series:
            return None
        series = sorted(by_series)[-1]
        dumps = sorted(by_series[series])
        last = tables.read_table(dumps[-1][1])
        key = (int(last["series_number"].iloc[-1]),
               int(last["event_number"].iloc[-1]))
        return series, dumps[-1][0], key
