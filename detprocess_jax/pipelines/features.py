"""Feature-extraction pipeline: YAML config → compiled batched device plan →
feature tables.

Batched replacement for the reference FeatureProcessing
(detprocess/process/features.py). The reference loops events in Python,
dispatching per-event extractor calls (features.py:533-851); here the YAML
config is compiled ONCE into a static plan of jitted kernels that process a
whole event batch ``[B, C, N]`` per call:

1. **Plan compilation** (`_build_plan`): for every channel × algorithm,
   resolve windows (utils.windows), trace groups (nb_samples, pretrigger),
   bank slots, and output column names `{feature}_{algorithm}_{channel}`
   (features.py:842-846).
2. **Bank building**: templates/PSDs/CSDs are pulled from the filter file
   (io.filterfile.FilterData) into stacked OF banks
   (ops.filterbank) — the OFBase-cache equivalent
   (processing_data.py:155-418).
3. **Batched execution**: one jitted function per trace group computes all
   channel combinations (weighted +/- sums as a single matmul), one FFT per
   compound channel, then every algorithm as fused reductions.
4. **Output**: pandas tables in the reference's column/naming conventions,
   written as vaex-layout HDF5 or parquet dumps (io.tables).

Missing values use the framework sentinel -999999.0 (algorithms.py:112-115).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from detprocess_jax.config import YamlConfig
from detprocess_jax.io import tables
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import open_reader
from detprocess_jax.ops import (filterbank, of1x1, ofnxm, psdfeatures,
                                pulsefit, tracestats)
from detprocess_jax.ops import fft as dfft
from detprocess_jax.utils import channels as chutils
from detprocess_jax.utils import freq as frequtils
from detprocess_jax.utils import windows as winutils
from detprocess_jax.utils.misc import create_series_name

SENTINEL = -999999.0

OF_1X1_ALGORITHMS = ("of1x1_nodelay", "of1x1_unconstrained",
                     "of1x1_constrained")

#: constrained-OF windows at or below this many allowed delays use the
#: direct windowed DFT-matmul kernel instead of the full irfft. On an
#: NVIDIA H100 80GB HBM3 (700 W power limit), constrained fit only,
#: 8192 × 32768 float32: direct 3.22 ms vs irfft 4.86 ms at W = 100,
#: 15.9 vs 4.87 ms at W = 1024, 48.3 vs 4.91 ms at W = 4096 — the
#: matmul cost grows linearly in W and breaks even near W ≈ 220.
DIRECT_WINDOW_MAX = 200
OF_NXM_ALGORITHMS = ("ofnxm", "ofnxmx2")
PSD_ALGORITHMS = ("psd_amp", "psd_peaks", "phase")
TRACE_ALGORITHMS = ("baseline", "integral", "maximum", "minimum",
                    "energyabsorbed")


@dataclass
class AlgoSpec:
    """One channel × algorithm instance, fully static."""

    algorithm: str          # output name (may be a derived/variant name)
    base: str               # base algorithm (kernel selector)
    channel: str            # YAML channel key (possibly compound)
    feature_channel: str    # column suffix
    kwargs: dict
    window: tuple           # (min_index, max_index)
    slot: int = -1          # index into the group's 1x1 bank
    slot2: int = -1         # second slot (of1x2x2)
    nxm_key: str = ""       # key into the group's NxM banks
    chan_idx: int = -1      # compound-channel row in the group trace stack
    nxm_chan_idx: tuple = ()


@dataclass
class TraceGroup:
    """All work sharing one (nb_samples, nb_pretrigger) trace geometry."""

    nb_samples: int
    nb_pretrigger: int
    compound_channels: List[str] = field(default_factory=list)
    mix_matrix: Optional[np.ndarray] = None      # [n_compound, n_raw]
    specs: List[AlgoSpec] = field(default_factory=list)
    # spec index → (eval_idx, valid, cos_mat, sin_mat) for constrained
    # specs the plan dispatches onto the direct windowed-DFT kernels;
    # built in _make_group_fn, packed as device arrays by device_banks
    direct_windows: Dict[int, tuple] = field(default_factory=dict)
    bank_1x1: Optional[filterbank.OF1x1Bank] = None
    slot_keys: List[tuple] = field(default_factory=list)
    nxm_banks: Dict[str, filterbank.OFNxMBank] = field(default_factory=dict)
    of_pretrigger: Optional[int] = None   # template-metadata pretrigger
                                          # (processing_data.py:360-366)


class FeatureProcessing:
    """End-to-end feature extraction over raw event files."""

    def __init__(self,
                 raw_files: Sequence[str] | str,
                 config: YamlConfig | str,
                 filter_data: FilterData | str | None = None,
                 trigger_dataframe: Optional[pd.DataFrame | str] = None,
                 external_file: Optional[str] = None,
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

        # trigger-dataframe-driven mode: windowed reads around each trigger
        # (processing_data.py:555-705)
        if isinstance(trigger_dataframe, str):
            trigger_dataframe = tables.read_table(trigger_dataframe)
        self._trigger_df = trigger_dataframe
        self._trigger_geometry = None  # (nb_samples, pretrigger), set later

        if isinstance(config, str):
            config = YamlConfig(config, self._available_channels,
                                sample_rate=self._fs)
        self._config = config
        self._feature_config = config.get_config("feature")

        # external user extractors (features.py:1002-1029): a python module
        # providing EXTRACTORS = {name: fn}; fn(traces [B, N], fs=..., ...)
        # must be jax-traceable and return {feature_name: [B] array}
        self._ext_extractors = {}
        ext = external_file or (self._feature_config.get("overall", {})
                                or {}).get("external_file")
        if ext:
            self._ext_extractors = _load_external_extractors(ext)

        if isinstance(filter_data, str):
            fd = FilterData(verbose=verbose)
            fd.load_hdf5(filter_data)
            filter_data = fd
        if filter_data is None:
            path = (self._feature_config.get("overall", {}) or {}).get(
                "filter_file")
            if path:
                filter_data = FilterData(verbose=verbose).load_hdf5(path)
        self._filter_data = filter_data

        self._groups: List[TraceGroup] = []
        self._group_fns = []
        self._salt_injector = None
        self._device_injector = None
        self._build_plan()
        self._compile()
        self._prewarm_thread = None
        if auto_prewarm and os.environ.get(
                "DETPROC_AUTO_PREWARM", "1") != "0":
            self._start_auto_prewarm()

    DEFAULT_BATCH_SIZE = 256    # process() default — what auto-prewarm
                                # compiles ahead of the first dispatch

    def _start_auto_prewarm(self):
        """Background compile of the default-shape group kernels at
        construction (see TriggerProcessing._start_auto_prewarm for the
        rationale). The group fns are the SAME jit objects the dispatch
        path calls, so a default-batch process() hits the jit cache
        directly.

        Unlike the trigger pipeline's, the feature kernels load from the
        executable cache quickly, so a prewarm running CONCURRENTLY with
        process() would mostly steal host cycles from the feed thread.
        The thread therefore YIELDS as
        soon as process() begins: it uses only genuinely idle
        construction-to-process time (loading trigger dataframes,
        operator setup, earlier CLI chain workloads). Best-effort; CPU
        backend skipped; opt out with auto_prewarm=False or
        DETPROC_AUTO_PREWARM=0."""
        import threading

        try:
            # upload width: windowed reads cut the trigger geometry;
            # full-trace mode uploads whole raw events. Channel-subset
            # uploads shrink C the same way process() will.
            if self._trigger_df is not None:
                n_up = int(self._trigger_geometry[0])
            else:
                n_up = int(self._reader.get_metadata()["nb_samples"])
            chans = (self._read_channels if self._read_channels
                     is not None else self._available_channels)
            c_up = len(chans)
        except Exception:
            return

        self._prewarm_yield = False

        def work():
            try:
                if jax.default_backend() == "cpu":
                    return
                if self._prewarm_yield:
                    return
                banks = self.device_banks(np.float32)
                dummy = jnp.zeros((self.DEFAULT_BATCH_SIZE, c_up, n_up),
                                  jnp.float32)
                for fn, bank in zip(self._group_fns, banks):
                    if self._prewarm_yield:   # process() started — its
                        return                # dispatch compiles now
                    out = fn(dummy, bank)
                    leaves = jax.tree.leaves(out)
                    if leaves:
                        np.asarray(leaves[0]).ravel()[:1]
            except Exception:
                pass    # prewarm is best-effort only

        self._prewarm_thread = threading.Thread(
            target=work, daemon=True, name="detproc-auto-prewarm")
        self._prewarm_thread.start()

    def set_salting(self, injector):
        """Attach a salting injector: salts are re-injected into every
        trace read (full or trigger-windowed), mirroring the reference's
        on-the-fly injection (processing_data.py:539-553, :613-640).

        Either a HOST injector (``Salting.make_injector``) or a DEVICE
        injector (``Salting.make_device_injector(channel_list)``) — the
        latter plans tiny [B, K] arrays on the host and adds templates
        on device after the ADC conversion, keeping the raw int16
        upload path for float32 runs."""
        from detprocess_jax.ops.saltinject import DeviceInjector

        if isinstance(injector, DeviceInjector):
            self._salt_injector = None
            self._device_injector = injector
        else:
            self._salt_injector = injector
            self._device_injector = None

    # ------------------------------------------------------------------
    # ProcessingData-style accessors (the reference exposes these on its
    # ProcessingData event-access object, processing_data.py:130, :500,
    # :1230-1279; here event access is folded into this pipeline, so the
    # accessors live on it for migrating users)
    # ------------------------------------------------------------------
    def get_filter_data_inst(self):
        """The FilterData store in use (processing_data.py:130-131)."""
        return self._filter_data

    def get_raw_path(self):
        """Raw-data path(s) backing the reader (processing_data.py:500-503)."""
        return self._reader.raw_path

    def get_sample_rate(self):
        """Trace sampling rate in Hz (processing_data.py:1207-1227)."""
        return self._fs

    def get_nb_samples(self) -> int:
        """Raw-trace sample count from metadata (processing_data.py:1230),
        or the trigger-window length in trigger-dataframe mode."""
        return self._raw_nb_samples()

    def get_nb_pretrigger_samples(self) -> int:
        """Pretrigger sample count (processing_data.py:1253)."""
        return self._raw_pretrigger()

    # ------------------------------------------------------------------
    # plan compilation
    # ------------------------------------------------------------------
    def _raw_nb_samples(self) -> int:
        if self._trigger_geometry is not None:
            return self._trigger_geometry[0]
        md = self._reader.get_metadata()
        return int(md["nb_samples"])

    def _raw_pretrigger(self) -> int:
        if self._trigger_geometry is not None:
            return self._trigger_geometry[1]
        md = self._reader.get_metadata()
        if "nb_pretrigger_samples" in md:
            return int(md["nb_pretrigger_samples"])
        return int(md["nb_samples"]) // 2

    def _build_plan(self):
        channels_cfg = self._feature_config["channels"]
        weights_cfg = self._feature_config.get("weights", {}) or {}

        if self._trigger_df is not None:
            overall = self._feature_config.get("overall", {}) or {}
            n0 = overall.get("trace_length_samples")
            p0 = overall.get("pretrigger_length_samples")
            if n0 is None:
                # fall back to the largest per-algorithm length
                lengths = [ac.get("nb_samples")
                           for cc in channels_cfg.values()
                           if isinstance(cc, dict)
                           for ac in cc.values()
                           if isinstance(ac, dict) and ac.get("nb_samples")]
                if not lengths:
                    raise ValueError(
                        "trigger-dataframe mode requires a trace length "
                        "(global trace_length_samples or per-algorithm)")
                n0 = max(lengths)
            if p0 is None:
                p0 = n0 // 2
            self._trigger_geometry = (int(n0), int(p0))

        raw_n = self._raw_nb_samples()
        raw_pre = self._raw_pretrigger()

        groups: Dict[tuple, TraceGroup] = {}

        for chan, chan_config in channels_cfg.items():
            feature_channel = chan_config.get("feature_channel", chan)
            for algo, algo_config in chan_config.items():
                if not isinstance(algo_config, dict) or not algo_config.get(
                        "run"):
                    continue
                base = algo_config.get("base_algorithm", algo)
                nb_s = algo_config.get("nb_samples") or raw_n
                nb_p = algo_config.get("nb_pretrigger_samples")
                if nb_p is None:
                    nb_p = raw_pre if nb_s == raw_n else nb_s // 2
                key = (nb_s, nb_p)
                group = groups.setdefault(key, TraceGroup(nb_s, nb_p))

                kwargs = {k: v for k, v in algo_config.items() if k != "run"}
                if base in TRACE_ALGORITHMS:
                    lo, hi = winutils.extract_window_indices(
                        nb_s, nb_p, self._fs,
                        **{k: v for k, v in kwargs.items()
                           if k.startswith("window_") and k.endswith("_usec")})
                    # explicit index overrides (features.py:1243 semantics)
                    if kwargs.get("window_min_index") is not None:
                        lo = int(kwargs["window_min_index"])
                    if kwargs.get("window_max_index") is not None:
                        hi = int(kwargs["window_max_index"])
                    window = (lo, hi)
                else:
                    window = (kwargs.get("window_min_index") or 0,
                              kwargs.get("window_max_index") or nb_s - 1)

                spec = AlgoSpec(algorithm=algo, base=base, channel=chan,
                                feature_channel=feature_channel,
                                kwargs=kwargs, window=window)
                group.specs.append(spec)

        if self._trigger_df is not None and groups:
            # the read window must cover every group geometry around the
            # trigger point
            pre = max(g.nb_pretrigger for g in groups.values())
            post = max(g.nb_samples - g.nb_pretrigger
                       for g in groups.values())
            n0, p0 = self._trigger_geometry
            pre = max(pre, p0)
            post = max(post, n0 - p0)
            self._trigger_geometry = (pre + post, pre)

        # resolve compound channels & banks per group
        for key in sorted(groups.keys()):
            group = groups[key]
            self._resolve_group(group, weights_cfg)
            self._groups.append(group)

        # CHANNEL-SUBSET reads + uploads: the raw-channel axis is only
        # ever consumed through each group's mix matrix, so raw channels
        # with all-zero mix columns never influence any output — don't
        # read or upload them (production files carry many channels
        # while a feature config mixes a few). The plan is built on the
        # subset axis; salting injectors are bridged (host: zero-lift
        # wrapper in _inject_host; device: name-based plan.chan remap
        # with out-of-range drop in _remap_salt_plan).
        used = np.zeros(len(self._available_channels), bool)
        for g in self._groups:
            if g.mix_matrix is not None and g.mix_matrix.size:
                used |= (g.mix_matrix != 0).any(axis=0)
        used_idx = np.flatnonzero(used)
        if 0 < len(used_idx) < len(self._available_channels):
            self._read_channel_idx = used_idx
            self._read_channels = [self._available_channels[i]
                                   for i in used_idx]
            for g in self._groups:
                if g.mix_matrix is not None and g.mix_matrix.size:
                    g.mix_matrix = g.mix_matrix[:, used_idx]
        else:
            self._read_channel_idx = None
            self._read_channels = None

    def _resolve_group(self, group: TraceGroup, weights_cfg: dict):
        raw_channels = self._available_channels
        compound: List[str] = []
        mix_rows: List[np.ndarray] = []

        def compound_index(chan: str) -> int:
            if chan in compound:
                return compound.index(chan)
            chans, weights = chutils.channel_combination_weights(
                chan, raw_channels)
            missing = [c for c in chans if c not in raw_channels]
            if missing:
                raise ValueError(
                    f"feature channel '{chan}' reads raw channel(s) "
                    f"{missing} not present in the raw data; "
                    f"available channels: {raw_channels}")
            row = np.zeros(len(raw_channels))
            wcfg = weights_cfg.get(chan, {})
            for sub, w in zip(chans, weights):
                w_user = wcfg.get(f"weight_{sub}", 1.0)
                row[raw_channels.index(sub)] = w * w_user
            compound.append(chan)
            mix_rows.append(row)
            return len(compound) - 1

        def check_fs(chan: str, what: str, tag: str, md: dict):
            # shared raw/filter sample-rate consistency check
            # (io.filterfile.check_fs_consistent — one owner for both
            # pipelines)
            from detprocess_jax.io.filterfile import check_fs_consistent
            check_fs_consistent(self._fs, md, what, chan, tag)

        slot_keys: List[tuple] = []
        slot_templates: List[np.ndarray] = []
        slot_psds: List[np.ndarray] = []
        slot_notches: List[tuple] = []

        def bank_slot(chan: str, template_tag: str, csd_tag: str,
                      kwargs: dict) -> int:
            notch = tuple(np.atleast_1d(
                kwargs.get("ignored_frequency_peaks") or ()))
            harmonics = bool(kwargs.get("ignore_harmonics", False))
            integralnorm = bool(kwargs.get("integralnorm", False))
            coupling = str(kwargs.get("coupling", "AC")).upper()
            skey = (chan, template_tag, csd_tag, notch, harmonics,
                    integralnorm, coupling)
            if skey in slot_keys:
                return slot_keys.index(skey)
            template, _, tmeta = self._filter_data.get_template(
                chan, tag=template_tag, return_metadata=True)
            check_fs(chan, "template", template_tag, tmeta)
            template = np.atleast_2d(template)[0] if np.ndim(template) > 1 \
                else np.asarray(template)
            psd, _, pmeta = self._filter_data.get_psd(
                chan, tag=csd_tag, return_metadata=True)
            check_fs(chan, "psd", csd_tag, pmeta)
            tpre = tmeta.get("nb_pretrigger_samples")
            if tpre is not None:
                tpre = int(tpre)
                if (group.of_pretrigger is not None
                        and group.of_pretrigger != tpre):
                    raise ValueError(
                        f"inconsistent template pretriggers in trace group "
                        f"({group.of_pretrigger} vs {tpre}, channel {chan})")
                group.of_pretrigger = tpre
            if template.shape[-1] != group.nb_samples:
                raise ValueError(
                    f"template length {template.shape[-1]} != trace length "
                    f"{group.nb_samples} for channel {chan} "
                    f'(tag "{template_tag}")')
            if psd.shape[-1] != group.nb_samples:
                raise ValueError(
                    f"psd length {psd.shape[-1]} != trace length "
                    f"{group.nb_samples} for channel {chan} "
                    f'(tag "{csd_tag}")')
            slot_keys.append(skey)
            slot_templates.append(template)
            slot_psds.append(psd)
            slot_notches.append((notch, harmonics, integralnorm, coupling))
            return len(slot_keys) - 1

        for spec in group.specs:
            kwargs = spec.kwargs
            if spec.base in OF_1X1_ALGORITHMS:
                tag = kwargs.get("template_tag", "default")
                if tag is None:
                    raise ValueError(
                        f"template_tag required for {spec.algorithm} "
                        f"on channel {spec.channel}")
                csd_tag = kwargs.get("csd_tag", "default")
                spec.slot = bank_slot(spec.channel, tag, csd_tag, kwargs)
                spec.chan_idx = compound_index(spec.channel)
            elif spec.base == "of1x2x2":
                tag1 = kwargs.get("template_tag_1", "Scintillation")
                tag2 = kwargs.get("template_tag_2", "Evaporation")
                csd_tag = kwargs.get("csd_tag", "default")
                spec.slot = bank_slot(spec.channel, tag1, csd_tag, kwargs)
                spec.slot2 = bank_slot(spec.channel, tag2, csd_tag, kwargs)
                spec.chan_idx = compound_index(spec.channel)
            elif spec.base in OF_NXM_ALGORITHMS:
                tag = kwargs.get("template_tag")
                if tag is None:
                    raise ValueError(
                        f'Missing "template_tag" for channel {spec.channel},'
                        f' algorithm "{spec.algorithm}"')
                csd_tag = kwargs.get("csd_tag", "default")
                template, _, tmeta = self._filter_data.get_template(
                    spec.channel, tag=tag, return_metadata=True)
                check_fs(spec.channel, "template", tag, tmeta)
                csd, _, cmeta = self._filter_data.get_csd(
                    spec.channel, tag=csd_tag, return_metadata=True)
                check_fs(spec.channel, "csd", csd_tag, cmeta)
                nxm_pre = int(tmeta.get("nb_pretrigger_samples")
                              or group.nb_pretrigger)
                if group.of_pretrigger is None:
                    group.of_pretrigger = nxm_pre
                bank = filterbank.make_ofnxm_bank(
                    np.asarray(template), np.asarray(csd), self._fs,
                    nxm_pre,
                    ignored_frequency_peaks=kwargs.get(
                        "ignored_frequency_peaks"),
                    ignore_harmonics=kwargs.get("ignore_harmonics", False),
                    coupling=str(kwargs.get("coupling", "AC")))
                nxm_key = f"{spec.channel}::{spec.algorithm}"
                group.nxm_banks[nxm_key] = bank
                spec.nxm_key = nxm_key
                sub_chans, _ = chutils.split_channel_name(
                    spec.channel, self._available_channels, separator="|")
                spec.nxm_chan_idx = tuple(
                    compound_index(c) for c in sub_chans)
            elif (spec.base in PSD_ALGORITHMS
                  or spec.base in TRACE_ALGORITHMS
                  or spec.base == "rftau"
                  or spec.base in self._ext_extractors):
                spec.chan_idx = compound_index(spec.channel)
            else:
                raise ValueError(
                    f'Cannot find algorithm "{spec.base}" — check feature '
                    f"extractor exists (built-ins + external: "
                    f"{sorted(self._ext_extractors)})")

        group.compound_channels = compound
        group.mix_matrix = (np.stack(mix_rows)
                            if mix_rows else np.zeros((0, len(raw_channels))))
        group.slot_keys = slot_keys
        if slot_keys:
            # per-slot notch settings can differ → build per-slot banks and
            # stack (all share fs/length)
            banks = [filterbank.make_of1x1_bank(
                        slot_templates[i], slot_psds[i], self._fs,
                        group.nb_pretrigger,
                        integralnorm=slot_notches[i][2],
                        ignored_frequency_peaks=list(slot_notches[i][0]) or None,
                        ignore_harmonics=slot_notches[i][1],
                        coupling=slot_notches[i][3])
                     for i in range(len(slot_keys))]
            group.bank_1x1 = filterbank.OF1x1Bank(
                s_fft=np.concatenate([b.s_fft for b in banks]),
                denom_inv=np.concatenate([b.denom_inv for b in banks]),
                phi=np.concatenate([b.phi for b in banks]),
                norm=np.concatenate([b.norm for b in banks]),
                templates=np.concatenate([b.templates for b in banks]),
                psd=np.concatenate([b.psd for b in banks]),
                fs=self._fs, pretrigger=group.nb_pretrigger)

    # ------------------------------------------------------------------
    # kernel compilation
    # ------------------------------------------------------------------
    def _window_cut(self, traces, group: TraceGroup):
        """Cut the group's trace geometry out of the raw traces
        (processing_data.get_channel_trace truncation semantics)."""
        raw_n = self._raw_nb_samples()
        raw_pre = self._raw_pretrigger()
        if group.nb_samples == raw_n:
            if (raw_pre is not None
                    and group.nb_pretrigger != raw_pre):
                # same length but shifted trigger point is unsatisfiable —
                # silently proceeding would misplace every window/t0
                raise ValueError(
                    f"configured pretrigger {group.nb_pretrigger} != raw "
                    f"pretrigger {raw_pre} with full-length traces "
                    f"({raw_n} samples); set nb_samples to cut a window "
                    "or match the raw pretrigger")
            return traces
        start = raw_pre - group.nb_pretrigger
        if start < 0 or start + group.nb_samples > raw_n:
            raise ValueError(
                f"trace geometry ({group.nb_samples}, "
                f"{group.nb_pretrigger}) does not fit in raw trace "
                f"({raw_n}, {raw_pre})")
        return traces[..., start:start + group.nb_samples]

    def _compile(self):
        self._group_fns_raw = [self._make_group_fn(g)
                               for g in self._groups]
        self._group_fns = [jax.jit(f) for f in self._group_fns_raw]
        self._mesh_fns: dict = {}

    def _group_fns_for(self, mesh):
        """Per-batch dispatchers: plain jits, or (with a mesh) shard_maps
        over the events axis — features are per-event, so the batch
        shards with no collectives; banks are replicated via in_specs."""
        if mesh is None:
            return self._group_fns
        if mesh not in self._mesh_fns:
            from jax.sharding import PartitionSpec as P
            from detprocess_jax.parallel import mesh as pmesh
            ev = P(pmesh.EVENTS_AXIS)
            self._mesh_fns[mesh] = [
                jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(ev, P()),
                                      out_specs=ev))
                for f in self._group_fns_raw]
        return self._mesh_fns[mesh]

    def _make_group_fn(self, group: TraceGroup):
        fs = self._fs
        n = group.nb_samples
        pretrig = group.nb_pretrigger
        # OF delay alignment follows the template's own pretrigger when
        # the filter file provides one (processing_data.py:360-366)
        of_pretrig = (group.of_pretrigger
                      if group.of_pretrigger is not None else pretrig)
        mix = group.mix_matrix
        specs = list(group.specs)

        # static per-spec masks
        def window_mask_for(spec):
            wmin = spec.kwargs.get("window_min_index")
            wmax = spec.kwargs.get("window_max_index")
            usec_min = spec.kwargs.get("window_min_from_trig_usec")
            usec_max = spec.kwargs.get("window_max_from_trig_usec")
            if (wmin is None and wmax is None and usec_min is None
                    and usec_max is None):
                return None
            lo, hi = winutils.extract_window_indices(
                n, pretrig, fs,
                window_min_from_trig_usec=usec_min,
                window_max_from_trig_usec=usec_max)
            if wmin is not None:
                lo = int(wmin)
            if wmax is not None:
                hi = int(wmax)
            mask = np.zeros(n, dtype=bool)
            mask[lo:hi + 1] = True
            if spec.kwargs.get("lgc_outside_window", False):
                mask = ~mask
            if not mask.any():
                raise ValueError(
                    f"{spec.algorithm} on {spec.channel}: constrained "
                    f"delay window [{lo}, {hi}] with lgc_outside_window="
                    f"{bool(spec.kwargs.get('lgc_outside_window', False))}"
                    " selects no delays — fix window_min/max_index or "
                    "window_*_from_trig_usec in the processing config")
            return mask

        # every spectral consumer runs on the half spectrum: the 1x1 OF
        # chain and of1x2 (Hermitian products → irfft), and the
        # psd features (the folded PSD IS the non-negative bins). One
        # rfft per channel, half the transform work of a full FFT.
        needs_half = sorted({s.chan_idx for s in specs
                             if s.base in OF_1X1_ALGORITHMS
                             + ("of1x2x2",) + PSD_ALGORITHMS})
        # Direct windowed-DFT tables for narrow constrained windows,
        # built ONCE here so the [F, W] cos/sin matrices ride the banks
        # pytree as runtime device arrays (packed by device_banks from
        # group.direct_windows). Closed over inside fn they would become
        # HLO constants — 2·F·W·4 bytes of compile payload PER SPEC
        # (67 MB at W=512) that every compile has to hash.
        group.direct_windows.clear()
        # the direct windowed-DFT evaluation only pays when the full
        # delay series is NOT already being computed for the same OF
        # filter: if an unconstrained (or too-wide constrained) spec
        # shares the slot, XLA CSEs the inverse-chain q series across
        # specs and the masked argmax is nearly free — the direct
        # path's matmuls then only ADD time
        inverse_slots = set()
        inverse_nxm = set()
        for spec in specs:
            wm = (window_mask_for(spec)
                  if spec.base in ("of1x1_constrained", "ofnxm") else None)
            wide = wm is None or int(wm.sum()) > DIRECT_WINDOW_MAX
            if spec.base == "of1x1_unconstrained" or (
                    spec.base == "of1x1_constrained" and wide):
                inverse_slots.add(spec.slot)
            elif spec.base == "ofnxm" and wide:
                inverse_nxm.add(spec.nxm_key)
        for spec_i, spec in enumerate(specs):
            if spec.base == "of1x1_constrained":
                wmask = window_mask_for(spec)
                if (wmask is not None
                        and int(wmask.sum()) <= DIRECT_WINDOW_MAX
                        and spec.slot not in inverse_slots):
                    group.direct_windows[spec_i] = of1x1.prepare_delay_window(
                        wmask, of_pretrig, n, filterbank.half_bin_weights(n))
            elif spec.base == "ofnxm":
                wmask = window_mask_for(spec)
                if (wmask is not None
                        and int(wmask.sum()) <= DIRECT_WINDOW_MAX
                        and spec.nxm_key not in inverse_nxm):
                    group.direct_windows[spec_i] = of1x1.prepare_delay_window(
                        wmask, of_pretrig, n)

        def fn(raw_traces, banks):
            # compound-channel traces via one matmul (full float32
            # precision: the mix must be exact, see ops/fft.HIGHEST)
            traces = dfft.einsum("cr,brn->bcn",
                                 jnp.asarray(mix, raw_traces.dtype),
                                 self._window_cut(raw_traces, group))
            out = {}
            bank_h = (filterbank.device_bank_1x1_half(banks["b1x1"])
                      if "b1x1" in banks else None)
            vhalf = {}
            if needs_half:
                vh = of1x1.signal_rfft(traces[:, jnp.asarray(needs_half), :])
                for j, ci in enumerate(needs_half):
                    vhalf[ci] = vh[:, j, :]

            for spec_i, spec in enumerate(specs):
                name = spec.algorithm
                fc = spec.feature_channel
                kwargs = spec.kwargs
                if spec.base in OF_1X1_ALGORITHMS:
                    # half-spectrum fast path (ops/of1x1.py half kernels)
                    phi = bank_h.phi[spec.slot:spec.slot + 1]
                    s_fft = bank_h.s_fft[spec.slot:spec.slot + 1]
                    dinv = bank_h.denom_inv[spec.slot:spec.slot + 1]
                    norm = bank_h.norm[spec.slot:spec.slot + 1]
                    binw = bank_h.bin_w
                    lmask = jnp.asarray(of1x1.lowfreq_mask_half(
                        n, fs, spec.kwargs.get("lowchi2_fcutoff", 10000)))
                    vr = vhalf[spec.chan_idx][:, None, :]
                    if spec.base == "of1x1_nodelay":
                        r = of1x1.of1x1_nodelay_half(
                            vr, phi, norm, dinv, s_fft, binw, lmask, n=n)
                        out[f"amp_{name}_{fc}"] = r.amp[:, 0]
                        out[f"chi2_{name}_{fc}"] = r.chi2[:, 0]
                        out[f"lowchi2_{name}_{fc}"] = r.lowchi2[:, 0]
                    else:
                        wmask = (window_mask_for(spec)
                                 if spec.base == "of1x1_constrained" else None)
                        dw = group.direct_windows.get(spec_i)
                        if dw is not None:
                            # narrow window → direct windowed DFT matmul
                            # (skips the full [N] inverse-FFT chain;
                            # ops/of1x1.py::of1x1_windowed_direct_half);
                            # big cos/sin matrices arrive as device
                            # arrays through the banks pytree
                            eidx, valid = dw[0], dw[1]
                            cs = banks["dwin"][str(spec_i)]
                            r = of1x1.of1x1_windowed_direct_half(
                                vr, phi, norm, dinv, s_fft, binw,
                                of_pretrig, fs, eidx, valid,
                                cs["c"], cs["s"],
                                low_mask_h=lmask,
                                interpolate_t0=bool(
                                    kwargs.get("interpolate", False)),
                                n=n)
                        else:
                            r = of1x1.of1x1_withdelay_half(
                                vr, phi, norm, dinv, s_fft, binw,
                                of_pretrig, fs,
                                window_mask=wmask, low_mask_h=lmask,
                                interpolate_t0=bool(
                                    kwargs.get("interpolate", False)),
                                n=n)
                        out[f"amp_{name}_{fc}"] = r.amp[:, 0]
                        out[f"t0_{name}_{fc}"] = r.t0[:, 0]
                        out[f"chi2_{name}_{fc}"] = r.chi2[:, 0]
                        out[f"lowchi2_{name}_{fc}"] = r.lowchi2[:, 0]
                        if spec.base == "of1x1_constrained":
                            out[f"chi2nopulse_{name}_{fc}"] = r.chi2_nopulse[:, 0]
                            ampres = of1x1.energy_resolution(norm)[0]
                            out[f"ampres_{name}_{fc}"] = jnp.broadcast_to(
                                ampres, r.amp[:, 0].shape)
                            out[f"timeres_{name}_{fc}"] = (
                                of1x1.time_resolution_half(
                                    r.amp[:, 0], bank_h.s_fft[spec.slot],
                                    bank_h.denom_inv[spec.slot],
                                    bank_h.bin_w, n, fs))
                elif spec.base == "of1x2x2":
                    vr2 = vhalf[spec.chan_idx][:, None, :]
                    # optional Δ = t2 − t1 constraint (samples): bounds
                    # the joint scan to the physical pulse-2 delay range
                    # (O(N·|Δ|) instead of the O(N²) full circular scan)
                    dmin = spec.kwargs.get("delta_window_min_usec")
                    dmax = spec.kwargs.get("delta_window_max_usec")
                    if dmin is not None or dmax is not None:
                        if dmax is None:
                            raise ValueError(
                                f"{spec.algorithm} on {spec.channel}: "
                                "delta_window_max_usec required when "
                                "delta_window_min_usec is set")
                        lo = int(round((dmin if dmin is not None else
                                        -dmax) * 1e-6 * fs))
                        hi = int(round(dmax * 1e-6 * fs))
                        if hi < lo:
                            raise ValueError(
                                f"{spec.algorithm} on {spec.channel}: "
                                f"empty delta window [{lo}, {hi}] samples")
                        delta_window = np.arange(lo, hi + 1)
                    else:
                        delta_window = None
                    r = of1x1.of1x2_half(
                        vr2,
                        bank_h.phi[spec.slot:spec.slot + 1],
                        bank_h.norm[spec.slot:spec.slot + 1],
                        bank_h.phi[spec.slot2:spec.slot2 + 1],
                        bank_h.norm[spec.slot2:spec.slot2 + 1],
                        bank_h.s_fft[spec.slot2:spec.slot2 + 1],
                        bank_h.denom_inv[spec.slot:spec.slot + 1],
                        bank_h.bin_w,
                        of_pretrig, fs, n, delta_window=delta_window)
                    out[f"scintillation_amp_{name}_{fc}"] = r.amp1[:, 0]
                    out[f"evaporation_amp_{name}_{fc}"] = r.amp2[:, 0]
                    out[f"time_diff_{name}_{fc}"] = r.time_diff[:, 0]
                elif spec.base == "ofnxm":
                    nb = filterbank.device_bank_nxm(banks[spec.nxm_key])
                    sel = traces[:, jnp.asarray(list(spec.nxm_chan_idx)), :]
                    wmask = window_mask_for(spec)
                    dw = group.direct_windows.get(spec_i)
                    vfft = of1x1.signal_fft(sel)
                    r_nd = ofnxm.ofnxm_nodelay(vfft, nb.phi, nb.iw_matrix,
                                               nb.icsd, fs)
                    if dw is not None:
                        # narrow window → direct windowed DFT matmuls
                        # instead of M full inverse FFTs; cos/sin ride
                        # the banks pytree
                        eidx, valid = dw[0], dw[1]
                        cs = banks["dwin"][str(spec_i)]
                        r_wd = ofnxm.ofnxm_withdelay_direct(
                            vfft, nb.phi, nb.w_matrix, nb.iw_matrix,
                            nb.icsd, of_pretrig, fs, eidx, valid,
                            cs["c"], cs["s"],
                            interpolate_t0=bool(
                                kwargs.get("interpolate_t0", False)))
                    else:
                        r_wd = ofnxm.ofnxm_withdelay(
                            vfft, nb.phi, nb.w_matrix, nb.iw_matrix,
                            nb.icsd, of_pretrig, fs,
                            window_mask=wmask,
                            interpolate_t0=bool(
                                kwargs.get("interpolate_t0", False)))
                    m = r_nd.amps.shape[-1]
                    amp_names = kwargs.get("amplitude_names") or [
                        f"amp{i + 1}" for i in range(m)]
                    for i, an in enumerate(amp_names):
                        out[f"{an}_{name}_constrained_{fc}"] = r_wd.amps[:, i]
                        out[f"{an}_{name}_nodelay_{fc}"] = r_nd.amps[:, i]
                    out[f"chi2_{name}_constrained_{fc}"] = r_wd.chi2
                    out[f"t0_{name}_constrained_{fc}"] = r_wd.t0
                    out[f"chi2_{name}_nodelay_{fc}"] = r_nd.chi2
                elif spec.base == "ofnxmx2":
                    nb_bank = group.nxm_banks[spec.nxm_key]
                    dev = filterbank.device_bank_nxm(banks[spec.nxm_key])
                    sel = traces[:, jnp.asarray(list(spec.nxm_chan_idx)), :]
                    vfft = of1x1.signal_fft(sel)
                    gids = np.asarray(kwargs["template_group_ids"])
                    fit_window = np.asarray(kwargs["fit_window"])
                    w1 = np.zeros(n, bool)
                    w1[fit_window[0][0]:fit_window[0][1] + 1] = True
                    w2 = np.zeros(n, bool)
                    w2[fit_window[1][0]:fit_window[1][1] + 1] = True
                    (r, _) = ofnxm.ofnxmx2(vfft, dev.s_fft, dev.icsd, gids,
                                           w1, w2, of_pretrig, fs)
                    m = nb_bank.ntmps
                    amp_names = kwargs.get("amplitude_names") or [
                        f"amp{i + 1}" for i in range(m)]
                    for i, an in enumerate(amp_names):
                        out[f"{an}_{name}_{fc}"] = r.amps[:, i]
                    out[f"chi2_{name}_{fc}"] = r.chi2
                    out[f"delta_t_{name}_{fc}"] = r.deltat
                elif spec.base == "psd_amp":
                    freq_ranges, range_names = frequtils.cleanup_freq_ranges(
                        kwargs.get("f_lims", []))
                    freqs_fold = np.abs(
                        np.fft.fftfreq(n, 1 / fs)[: n // 2 + 1])[1:]
                    ind_ranges = frequtils.get_ind_freq_ranges(
                        freq_ranges, freqs_fold)
                    vals = psdfeatures.psd_amp_half(
                        vhalf[spec.chan_idx], fs, n, ind_ranges)
                    for i, rn in enumerate(range_names):
                        out[f"{name}_{rn}_{fc}"] = vals[:, i]
                elif spec.base in ("psd_peaks", "phase"):
                    freq_ranges, range_names = frequtils.cleanup_freq_ranges(
                        kwargs.get("f_lims", []))
                    freqs_fold = np.abs(
                        np.fft.fftfreq(n, 1 / fs)[: n // 2 + 1])[1:]
                    npeaks = int(kwargs.get("npeaks", 1))
                    min_sep = float(kwargs.get("min_separation_hz", 0.0))
                    df = fs / n
                    dist = int(np.ceil(min_sep / df)) if min_sep > 0 else 0
                    for (fr, rn) in zip(freq_ranges, range_names):
                        band = np.zeros(n // 2, dtype=bool)
                        flo = fr[0]
                        fhi = fr[1] if len(fr) == 2 else fr[0]
                        band[(freqs_fold >= flo) & (freqs_fold <= fhi)] = True
                        if not band.any():
                            band[np.argmin(np.abs(freqs_fold - flo))] = True
                        if spec.base == "psd_peaks":
                            fpk, apk, dc = psdfeatures.psd_peaks_half(
                                vhalf[spec.chan_idx], fs, n, band,
                                npeaks, dist)
                            for i in range(npeaks):
                                out[f"{name}_{rn}_amp_{i+1}_{fc}"] = apk[:, i]
                                out[f"{name}_{rn}_freq_{i+1}_{fc}"] = fpk[:, i]
                            out[f"{name}_dc_amp_{fc}"] = dc
                        else:
                            fpk, ppk = psdfeatures.phase_at_peaks_half(
                                vhalf[spec.chan_idx], fs, n, band,
                                npeaks, dist,
                                pretrigger=pretrig,
                                threshold_factor=float(
                                    kwargs.get("threshold_factor", 0.0)))
                            for i in range(npeaks):
                                out[f"{name}_{rn}_phase_{i+1}_{fc}"] = ppk[:, i]
                                out[f"{name}_{rn}_freq_{i+1}_{fc}"] = fpk[:, i]
                elif spec.base == "rftau":
                    tr = traces[:, spec.chan_idx, :]
                    r = pulsefit.rftau(
                        tr, fs,
                        rtau0=float(kwargs.get("rtau") or 30.0),
                        ftau0=float(kwargs.get("ftau") or 100.0),
                        t0_index=kwargs.get("t0"))
                    out[f"risetime_{name}_{fc}"] = r.risetime
                    out[f"falltime_{name}_{fc}"] = r.falltime
                    out[f"amplitud_{name}_{fc}"] = r.amplitude
                    out[f"chisq_{name}_{fc}"] = r.chisq
                elif spec.base in self._ext_extractors:
                    ext_fn = self._ext_extractors[spec.base]
                    tr = traces[:, spec.chan_idx, :]
                    ext_kwargs = {k: v for k, v in kwargs.items()
                                  if k not in ("base_algorithm",
                                               "feature_channel",
                                               "nb_samples",
                                               "nb_pretrigger_samples")}
                    res = ext_fn(tr, fs=fs,
                                 nb_pretrigger_samples=pretrig,
                                 **ext_kwargs)
                    for k, v in res.items():
                        out[f"{k}_{fc}"] = v
                elif spec.base in TRACE_ALGORITHMS:
                    tr = traces[:, spec.chan_idx, :]
                    lo, hi = spec.window
                    if spec.base == "baseline":
                        out[f"{name}_{fc}"] = tracestats.baseline(tr, lo, hi)
                    elif spec.base == "integral":
                        out[f"{name}_{fc}"] = tracestats.integral(tr, fs, lo,
                                                                  hi)
                    elif spec.base == "maximum":
                        out[f"{name}_{fc}"] = tracestats.maximum(tr, lo, hi)
                    elif spec.base == "minimum":
                        out[f"{name}_{fc}"] = tracestats.minimum(tr, lo, hi)
                    elif spec.base == "energyabsorbed":
                        out[f"{name}_{fc}"] = tracestats.energyabsorbed(
                            tr, fs, kwargs["vb"], kwargs["i0"], kwargs["rl"],
                            lo, hi)
            return out

        return fn

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _file_for_row(self, row) -> Optional[str]:
        index = getattr(self, "_file_index", None)
        if index is None:
            # (series_num, dump_num) -> path, built once — trigger
            # dataframes hold 1e5+ rows over 1e3+ dump files
            index = {}
            for f in self._reader.files:
                md = self._reader.get_metadata(f)
                key = (int(md.get("series_num", -1)),
                       int(md.get("dump_num", -1)))
                index.setdefault(key, f)
            self._file_index = index
        return index.get((int(row["series_number"]),
                          int(row["dump_number"])))

    def _inject_host(self, traces, admin, window_start=0):
        """Run the HOST salt injector on possibly channel-subset traces.

        Host injectors index the FULL channel stack (their channel_list
        is the caller's): lift the subset rows into a zero full stack,
        inject, take the rows back. Salts on unread channels land in
        discarded rows — they cannot influence any output (all-zero mix
        columns)."""
        if self._read_channel_idx is None:
            return self._salt_injector(traces, admin,
                                       window_start=window_start)
        full = np.zeros((len(self._available_channels),)
                        + traces.shape[1:],
                        np.result_type(traces.dtype, np.float64))
        full[self._read_channel_idx] = traces
        out = self._salt_injector(full, admin, window_start=window_start)
        return out[self._read_channel_idx]

    def _remap_salt_plan(self, plan):
        """Remap a DeviceInjector SaltPlan's channel indices onto the
        subset axis (name-based: the injector's channel_list is the
        caller's). Channels outside the subset map out of range —
        inject_salts adds with mode='drop', so those salts vanish
        (harmless: their mix columns are zero)."""
        if self._read_channel_idx is None or plan is None:
            return plan
        inj = self._device_injector
        cache = getattr(self, "_salt_remap_cache", None)
        if cache is None or cache[0] is not inj:
            lookup = {c: i for i, c in enumerate(self._read_channels)}
            arr = np.array([lookup.get(c, len(self._read_channels))
                            for c in inj.channel_list], np.int32)
            cache = self._salt_remap_cache = (inj, arr)
        return type(plan)(plan.idx, cache[1][plan.chan], plan.tid,
                          plan.amp)

    # coalesce per-window preads into ONE full-event read when the
    # chunk's windows cover at least this fraction of the event trace
    # (dense production triggering: 100s of 4k windows per 1.25 Ms
    # event → window bytes exceed the trace; one contiguous read +
    # host slicing beats per-window syscalls). Reference anchor: the
    # per-event hyperslab reads this replaces, processing_data.py:555-705.
    COALESCE_FRACTION = 0.5

    def _read_row_chunk(self, reader, rows):
        """Read one chunk of trigger rows with ``reader`` (any RawReader
        — workers pass their own clone) → (stack, admins, ndropped), or
        (None, None, ndropped) when every row dropped."""
        n, pre = self._trigger_geometry
        batch_traces, admins = [], []
        dropped = 0
        raw_reads = getattr(self, "_raw_reads", False)
        # count windows per (file, event) to pick coalesced full reads
        win_count: dict = {}
        for row in rows:
            fname = self._file_for_row(row)
            if fname is not None:
                key = (fname, int(row["event_number"]))
                win_count[key] = win_count.get(key, 0) + 1
        full_cache: dict = {}
        for row in rows:
            fname = self._file_for_row(row)
            if fname is None:
                dropped += 1
                continue
            start = int(row["trigger_index"]) - pre
            raw_n = self._nb_samples_for(fname)
            if start < 0 or start + n > raw_n:
                dropped += 1
                continue
            ev = int(row["event_number"])
            key = (fname, ev)
            kw = (dict(adctoamp=False, dtype=None) if raw_reads else {})
            if self._read_channels is not None:
                kw["channels"] = self._read_channels
            if win_count[key] * n >= self.COALESCE_FRACTION * raw_n:
                hit = full_cache.get(key)
                if hit is None:
                    hit = full_cache[key] = reader.read_single_event(
                        ev, file_name=fname, **kw)
                    if len(full_cache) > 2:     # bound host memory to a
                        for k in list(full_cache):  # few full traces
                            if k != key:
                                del full_cache[k]
                ftr, fadmin = hit
                traces = ftr[:, start:start + n]
                admin = dict(fadmin)
            else:
                traces, admin = reader.read_single_event(
                    ev, file_name=fname, trace_window=(start, n), **kw)
            if self._salt_injector is not None:
                traces = self._inject_host(traces, admin,
                                           window_start=start)
            admin = dict(admin)
            if self._device_injector is not None:
                # device re-injection needs the window offset
                # (process() pops this into the batch SaltPlan)
                admin["_window_start"] = start
            for col in ("trigger_index", "trigger_time",
                        "trigger_delta_chi2", "trigger_amplitude",
                        "trigger_type", "trigger_prod_id",
                        "trigger_channel"):
                if col in row and not pd.isna(row[col]):
                    admin[col] = row[col]
            batch_traces.append(traces)
            admins.append(admin)
        if not batch_traces:
            return None, None, dropped
        return np.stack(batch_traces), admins, dropped

    def _nb_samples_for(self, fname: str) -> int:
        cache = getattr(self, "_nb_samples_cache", None)
        if cache is None:
            cache = self._nb_samples_cache = {}
        got = cache.get(fname)
        if got is None:
            got = cache[fname] = int(
                self._reader.get_metadata(fname)["nb_samples"])
        return got

    def _iter_trigger_batches(self, batch_size: int,
                              nevents: int = -1, nreaders: int = 1):
        """Yield (raw [B, C, N], admins) batches of windowed reads around
        each trigger-dataframe row (processing_data.py:555-705);
        ``nevents`` > 0 caps the rows processed.

        ``nreaders > 1`` reads row chunks in that many worker threads
        (each with its own RawReader — file handles are never shared),
        yielding batches in row ORDER (io.prefetch.OrderedChunkPrefetcher)
        so dump contents and resume row counts are unchanged — the
        windowed-read analog of the reference's ncores Pool split."""
        df = self._trigger_df
        if nevents is not None and nevents > 0:
            df = df.iloc[:nevents]
        # plain dicts: pandas iterrows costs ~0.5 ms/row in Series scalar
        # lookups (measured ~25% of warm wall time at 1k rows)
        rows = df.to_dict("records")
        chunks = [rows[i:i + batch_size]
                  for i in range(0, len(rows), batch_size)]
        dropped = 0

        def chunk_results():
            nonlocal dropped
            if nreaders > 1 and len(chunks) > 1:
                from detprocess_jax.io.prefetch import (
                    OrderedChunkPrefetcher)

                # warm the shared caches BEFORE spawning workers (the
                # index and nb_samples lookups are then read-only dict
                # hits)
                for row in rows:
                    fname = self._file_for_row(row)
                    if fname is not None:
                        self._nb_samples_for(fname)
                nw = min(nreaders, len(chunks))
                workers = [self._reader.split(1)[0] for _ in range(nw)]
                pf = OrderedChunkPrefetcher(
                    lambda rd, chunk: self._read_row_chunk(rd, chunk),
                    chunks, workers, depth=2)
                try:
                    for stack, admins, nd in pf:
                        dropped += nd
                        if stack is not None:
                            yield stack, admins
                finally:
                    pf.close()
                    for w in workers:
                        w.close()
            else:
                for chunk in chunks:
                    stack, admins, nd = self._read_row_chunk(
                        self._reader, chunk)
                    dropped += nd
                    if stack is not None:
                        yield stack, admins

        # RE-PACK to constant batch_size across dropped rows: a short
        # stack has a new [B, C, N] shape, and every distinct B forces
        # a fresh XLA compile of all group fns (seconds per shape) —
        # scattered out-of-bounds windows
        # are routine in production, so drops must not leak into the
        # dispatch shape. Only the LAST batch may be short.
        pend_stacks: List[np.ndarray] = []
        pend_admins: List[dict] = []
        pend_n = 0
        for stack, admins in chunk_results():
            pend_stacks.append(stack)
            pend_admins.extend(admins)
            pend_n += stack.shape[0]
            while pend_n >= batch_size:
                buf = (pend_stacks[0] if len(pend_stacks) == 1
                       else np.concatenate(pend_stacks))
                yield buf[:batch_size], pend_admins[:batch_size]
                pend_stacks = ([buf[batch_size:]]
                               if pend_n > batch_size else [])
                pend_admins = pend_admins[batch_size:]
                pend_n -= batch_size
        if pend_n:
            yield (pend_stacks[0] if len(pend_stacks) == 1
                   else np.concatenate(pend_stacks)), pend_admins
        if dropped and self._verbose:
            print(f"INFO: dropped {dropped} triggers with out-of-bounds "
                  f"windows or unmatched files")

    def _iter_full_batches(self, batch_size: int, nevents: int,
                           prefetch_depth: int = 64, nreaders: int = 1):
        self._reader.rewind()
        raw = getattr(self, "_raw_reads", False)
        if prefetch_depth > 0 or nreaders > 1:
            from detprocess_jax.io.prefetch import prefetch_events
            source = prefetch_events(self._reader,
                                     depth=max(prefetch_depth, 1),
                                     raw=raw, nreaders=nreaders,
                                     channels=self._read_channels)
            prefetch_depth = max(prefetch_depth, 1)
        else:
            source = self._reader
        total = 0
        try:
            while nevents < 0 or total < nevents:
                batch_traces, admins = [], []
                want = batch_size if nevents < 0 else min(batch_size,
                                                          nevents - total)
                for _ in range(want):
                    if prefetch_depth > 0:
                        tr, admin = source.read_next_event()
                    elif not raw:
                        tr, admin = source.read_next_event(
                            channels=self._read_channels)
                    else:
                        tr, admin = source.read_next_event(
                            channels=self._read_channels,
                            dtype=None, adctoamp=False)
                    if tr is None:
                        break
                    if self._salt_injector is not None:
                        tr = self._inject_host(tr, admin)
                    batch_traces.append(tr)
                    admins.append(admin)
                if not batch_traces:
                    return
                total += len(batch_traces)
                yield np.stack(batch_traces), admins
        finally:
            if prefetch_depth > 0:
                source.close()

    def device_banks(self, real_dtype=np.float32):
        """Pack all group banks for device transfer (real-only pytrees)."""
        packed = []
        for group in self._groups:
            d = {}
            if group.bank_1x1 is not None:
                dev = group.bank_1x1.to_device(real_dtype)
                # every 1x1 consumer runs on the half-spectrum view now —
                # don't ship the [S, N] full-spectrum arrays to the
                # device (host↔device bandwidth + HBM for nothing)
                for key in ("phi", "s_fft", "denom_inv"):
                    dev.pop(key, None)
                d["b1x1"] = jax.tree.map(jnp.asarray, dev)
            for key, bank in group.nxm_banks.items():
                d[key] = jax.tree.map(jnp.asarray, bank.to_device(real_dtype))
            if group.direct_windows:
                # [F, W] cos/sin pairs for the direct windowed-DFT
                # kernels, as runtime arrays (NOT trace constants — see
                # _make_group_fn). Same real dtype as the banks so the
                # f64 CPU golden path keeps full precision.
                d["dwin"] = {
                    str(i): {"c": jnp.asarray(t[2].astype(real_dtype)),
                             "s": jnp.asarray(t[3].astype(real_dtype))}
                    for i, t in group.direct_windows.items()}
            packed.append(d)
        return packed

    def process(self,
                nevents: int = -1,
                batch_size: int = 256,
                dtype=np.float32,
                pipeline_depth: int = 4,
                lgc_save: bool = False,
                output_path: Optional[str] = None,
                output_format: str = "hdf5",
                series_name: Optional[str] = None,
                group_name: str = "features",
                nb_events_per_dump: Optional[int] = None,
                memory_limit: float | str | None = None,
                resume: bool = False,
                lgc_output: bool = True,
                mesh=None,
                nreaders: int = 1,
                timer=None) -> Optional[pd.DataFrame]:
        """Run feature extraction.

        ``nreaders``: concurrent host reader threads — the functional
        replacement for the reference's ``ncores`` Pool-over-series
        (process/features.py:391-420). In trigger-dataframe mode the
        readers split row chunks and yield IN ORDER (outputs and resume
        semantics unchanged); in full-trace mode they split files by
        series (``RawReader.split``), event order across subsets is then
        nondeterministic and — like the reference
        (features.py:320-322) — requires ``nevents=-1`` and no
        ``resume``.

        ``timer``: optional ``utils.logging.StageTimer`` accumulating
        the host/device wall-time split (read / dispatch / drain
        stages).

        ``mesh``: an optional ``jax.sharding.Mesh``
        (``parallel.mesh.make_mesh``) — each batch is then SPMD over the
        mesh's devices, sharded along ``parallel.mesh.EVENTS_AXIS``
        (features are per-event: no collectives; banks replicate).
        Batches are padded to a device-count multiple and trimmed on the
        host; raise ``batch_size`` so each device gets real work.

        Reads events in batches, executes the compiled plan on device, and
        assembles the feature table (with admin columns). With ``lgc_save``
        the table is written per dump to ``output_path``.

        ``pipeline_depth`` batches stay in flight before their results are
        pulled to host — device dispatch latency and compute overlap with
        the next batch's file reads (the reference pays neither: its loop
        is synchronous per event).

        ``resume=True`` (with lgc_save) scans ``output_path`` for existing
        dumps of this group, skips the events they already cover (event
        order is deterministic, one row per event) and continues the same
        output series and dump numbering — dump-level checkpoint/restart
        for long runs (the reference restarts whole series only,
        SURVEY.md §5).
        """
        import time as _time

        t_start = _time.time()
        # tell a still-running auto-prewarm thread to yield: from here
        # the dispatch path compiles what it needs, and on a 1-vCPU
        # host a racing prewarm only steals the feed thread's cycles
        self._prewarm_yield = True
        if (nreaders > 1 and self._trigger_df is None
                and (nevents >= 0 or resume)):
            # unordered multi-reader events break nevents-truncation and
            # resume-skip determinism — same constraint as the
            # reference's ncores>1 (process/features.py:320-322)
            raise ValueError("nreaders > 1 in full-trace mode requires "
                             "processing all events (nevents=-1) "
                             "without resume")
        banks = self.device_banks(np.float64 if dtype == np.float64
                                  else np.float32)
        frames: List[pd.DataFrame] = []
        state = {"total": 0, "dump": 0, "pending": [],
                 "dump_size": nb_events_per_dump,
                 "memory_limit": _parse_memory_limit(memory_limit)}
        out_series = series_name or create_series_name(self._facility)
        skip_events = 0
        if lgc_save:
            if output_path is None:
                raise ValueError("output_path required with lgc_save")
            os.makedirs(output_path, exist_ok=True)
            if resume:
                found = self._scan_resume(output_path, group_name,
                                          output_format)
                if found is not None:
                    out_series, skip_events, state["dump"] = found
                    if self._verbose:
                        print(f"INFO: resuming series {out_series} after "
                              f"{skip_events} events "
                              f"(dump {state['dump']})")

        # RAW (stored-dtype) reads when unsalted and computing in
        # float32: int16 ADC codes upload as stored — half the
        # host→device bytes — and the ADC→amps conversion runs on device
        # (admin["adc_conv"]). float64 runs keep host-converted reads
        # (they are the golden-precision path); salting injects float
        # templates on the host.
        self._raw_reads = (self._salt_injector is None
                           and np.dtype(dtype) == np.float32)
        batches = (self._iter_trigger_batches(batch_size, nevents,
                                              nreaders=nreaders)
                   if self._trigger_df is not None
                   else self._iter_full_batches(batch_size, nevents,
                                                nreaders=nreaders))
        if skip_events:
            batches = _skip_rows(batches, skip_events)
        from contextlib import nullcontext
        stage = (timer.stage if timer is not None
                 else (lambda name: nullcontext()))
        # dump writes ride a background writer thread (tables.AsyncWriter)
        # so table IO overlaps device compute; _flush_dump picks it up
        # from the state dict
        state["writer"] = tables.AsyncWriter() if lgc_save else None

        inflight: List[tuple] = []

        def emit(entry):
            keys, packed, extras, admins, nb = entry
            # ONE device→host transfer for all packed columns: per-column
            # np.asarray costs a device round trip each. [:nb] drops
            # mesh padding (every plan output is batch-leading).
            feats = {}
            if keys:
                arr = np.asarray(packed, np.float64)
                feats.update({k: arr[i][:nb] for i, k in enumerate(keys)})
            feats.update({k: np.asarray(v, np.float64)[:nb]
                          for k, v in extras.items()})
            state["total"] += nb
            self._emit_frame(feats, admins, nb, frames, state, lgc_save,
                             output_path, output_format, out_series,
                             group_name)

        group_fns = self._group_fns_for(mesh)
        salt_templates = (jnp.asarray(self._device_injector.templates)
                          if self._device_injector is not None else None)
        _batch_iter = iter(batches)

        def _next_batch():
            """One read step under the 'read' stage (host IO — with
            nreaders>1 most of it happens in the reader threads and this
            is just a queue pop)."""
            with stage("read"):
                return next(_batch_iter, None)

        try:
            while (_nb := _next_batch()) is not None:
                raw_np, admins = _nb
                _t_disp = _time.perf_counter()
                nb = raw_np.shape[0]
                convs = None
                if self._raw_reads:
                    convs = np.stack([
                        np.asarray(a.pop("adc_conv",
                                         np.ones(raw_np.shape[1])),
                                   np.float32)
                        for a in admins])
                plan = None
                if self._device_injector is not None:
                    starts = [a.pop("_window_start", 0) for a in admins]
                    plan = self._remap_salt_plan(
                        self._device_injector.plan(
                            admins, window_starts=starts))
                upload = raw_np
                if not np.issubdtype(upload.dtype, np.integer):
                    # float-stored data uploads as the compute dtype (as
                    # before); integer ADC codes upload AS STORED
                    upload = upload.astype(dtype, copy=False)
                if mesh is not None:
                    n_dev = mesh.devices.size
                    padn = (-nb) % n_dev
                    if padn:
                        # repeat the last event so B divides the device
                        # count; emit() trims back to nb
                        def _padrep(a):
                            return np.concatenate(
                                [a, np.repeat(a[-1:], padn, axis=0)])
                        upload = _padrep(upload)
                        if convs is not None:
                            convs = _padrep(convs)
                        if plan is not None:
                            plan = type(plan)(*(_padrep(f) for f in plan))
                    from jax.sharding import (NamedSharding,
                                              PartitionSpec as P)
                    from detprocess_jax.parallel import mesh as pmesh
                    # device_put on the HOST array uploads each shard to its
                    # device directly; jnp.asarray first would stage the full
                    # batch on device 0 and reshard (double transfer)
                    sharding = NamedSharding(mesh, P(pmesh.EVENTS_AXIS))
                    put = lambda a: jax.device_put(a, sharding)  # noqa: E731
                else:
                    put = jnp.asarray
                raw = put(upload)
                if convs is not None:
                    raw = _adc_convert(raw, put(convs))
                if plan is not None:
                    from detprocess_jax.ops import saltinject
                    raw = saltinject.inject_salts(
                        raw, put(plan.idx), put(plan.chan), put(plan.tid),
                        put(plan.amp), salt_templates)
                bp = raw_np.shape[0]
                dev_feats: Dict[str, jnp.ndarray] = {}
                for group_fn, bank in zip(group_fns, banks):
                    dev_feats.update(group_fn(raw, bank))
                # pack homogeneous [B] float columns into one [ncol, B] array
                pack = {k: v for k, v in dev_feats.items()
                        if getattr(v, "ndim", None) == 1 and v.shape[0] == bp
                        and jnp.issubdtype(v.dtype, jnp.floating)}
                extras = {k: v for k, v in dev_feats.items() if k not in pack}
                keys = list(pack)
                packed = None
                if keys:
                    ct = jnp.result_type(*(pack[k].dtype for k in keys))
                    packed = jnp.stack([pack[k].astype(ct) for k in keys])
                # start the host copies NOW: with pipeline_depth >= 1
                # the transfer round trips overlap the next batch's
                # reads/dispatch instead of stalling emit()
                for v in ([packed] if packed is not None else []) +                         list(extras.values()):
                    if hasattr(v, "copy_to_host_async"):
                        try:
                            v.copy_to_host_async()
                        except Exception:  # backend without async copies
                            pass
                inflight.append((keys, packed, extras, admins, nb))
                if timer is not None:
                    timer.add_seconds("dispatch",
                                      _time.perf_counter() - _t_disp)
                if len(inflight) > max(pipeline_depth, 0):
                    with stage("drain"):
                        emit(inflight.pop(0))
            with stage("drain"):
                for entry in inflight:
                    emit(entry)
        except BaseException:
            if state.get("writer") is not None:  # don't mask the error
                try:
                    state["writer"].close()
                except BaseException:
                    pass
                state["writer"] = None
            raise
        if lgc_save and state["pending"]:
            self._flush_dump(state, output_path, output_format,
                             out_series, group_name)
        if state.get("writer") is not None:
            state["writer"].close()   # drain async dump writes; surface
            state["writer"] = None    # errors before the job summary

        wall = _time.time() - t_start
        if self._verbose and state["total"]:
            print(f"INFO: processed {state['total']} events in "
                  f"{wall:.1f} s ({state['total']/max(wall, 1e-9):.0f} "
                  f"events/s)")
        if lgc_save and output_path is not None:
            tables.write_job_summary(
                output_path, self._output_prefix(), group_name,
                out_series, {
                    "workload": "feature",
                    "processing_id": self._processing_id,
                    "series_name": out_series,
                    "events": int(state["total"]),
                    "wall_sec": round(wall, 3),
                    "events_per_sec": (round(state["total"] / wall, 3)
                                       if wall else 0),
                    "dumps": int(state["dump"]),
                    "trigger_driven": self._trigger_df is not None,
                    "config_digest": tables.config_digest(
                        self._feature_config),
                    "restricted": self._restricted,
                    "calib": self._calib,
                })
        if not frames:
            return pd.DataFrame() if lgc_output else None
        result = pd.concat(frames, ignore_index=True)
        return result if lgc_output else None

    def _output_prefix(self) -> str:
        return tables.build_prefix("feature", self._processing_id,
                                   self._restricted, self._calib)

    def _scan_resume(self, output_path, group_name, output_format):
        """Find existing dumps: (series, rows_done, last_dump) or None."""
        import glob
        import re

        prefix = self._output_prefix()
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
        series = sorted(by_series)[-1]       # latest series name wins
        dumps = sorted(by_series[series])
        rows = sum(tables.count_rows(f) for _, f in dumps)
        return series, rows, dumps[-1][0]

    def _emit_frame(self, feats, admins, nb, frames, state, lgc_save,
                    output_path, output_format, out_series, group_name):
        frame = {}
        # admin columns (processing_data.py:774-887 conventions)
        for col in ("event_number", "event_id", "event_time",
                    "series_number", "dump_number", "trigger_type"):
            frame[col] = np.asarray([a.get(col, 0) for a in admins])
        # fridge-run / elapsed-time provenance (processing_data.py:774-887)
        if any("fridge_run_number" in a for a in admins):
            frame["fridge_run_number"] = np.asarray(
                [np.int64(a.get("fridge_run_number", -1)) for a in admins])
        for col in ("series_start_time", "group_start_time",
                    "fridge_run_start_time"):
            if any(col in a for a in admins):
                frame[col] = np.asarray(
                    [np.int64(np.round(a["event_time"] - a[col]))
                     if col in a else np.int64(-1) for a in admins])
        # trigger-mode carry-over columns
        if self._trigger_df is not None:
            for col in ("trigger_index", "trigger_time",
                        "trigger_delta_chi2", "trigger_amplitude",
                        "trigger_prod_id", "trigger_channel"):
                if any(col in a for a in admins):
                    frame[col] = [a.get(col, np.nan) for a in admins]
        frame["series_name"] = [a.get("series_name", "") for a in admins]
        frame["group_name"] = [a.get("group_name", "") for a in admins]
        frame["data_type"] = [a.get("data_type", "") for a in admins]
        frame["processing_id"] = [self._processing_id or ""] * nb
        # detector settings — PER ROW: a batch can straddle files/series
        # with different settings (metadata lookups hit the reader cache)
        dets = [self._reader.get_detector_config(a["file_name"])
                for a in admins]
        det_chans = {c for d in dets for c in d}
        for chan in det_chans:
            if any("tes_bias" in d.get(chan, {}) for d in dets):
                frame[f"tes_bias_{chan}"] = [
                    d.get(chan, {}).get("tes_bias", np.nan) for d in dets]
            if any("output_gain" in d.get(chan, {}) for d in dets):
                frame[f"output_gain_{chan}"] = [
                    d.get(chan, {}).get("output_gain", np.nan)
                    for d in dets]
        frame.update(feats)
        df = pd.DataFrame(frame)
        frames.append(df)
        if lgc_save:
            # dump sizing follows the reference's nb_events_per_dump
            # (features.py:593-626); default = one dump per batch
            state["pending"].append(df)
            size = state["dump_size"]
            mem = state["memory_limit"]
            pending_bytes = sum(int(d.memory_usage(deep=False).sum())
                                for d in state["pending"])
            if ((size is None and mem is None)
                    or (size is not None
                        and sum(len(d) for d in state["pending"]) >= size)
                    or (mem is not None and pending_bytes >= mem)):
                self._flush_dump(state, output_path, output_format,
                                 out_series, group_name)

    def _flush_dump(self, state, output_path, output_format, out_series,
                    group_name):
        if not state["pending"]:
            return
        df = (state["pending"][0] if len(state["pending"]) == 1
              else pd.concat(state["pending"], ignore_index=True))
        state["pending"] = []
        state["dump"] += 1
        path = tables.output_file_name(
            output_path, self._output_prefix(), group_name, out_series,
            state["dump"],
            "parquet" if output_format == "parquet" else "hdf5")
        writer = state.get("writer")
        if writer is not None:
            writer.write(df, path, fmt=output_format)   # async (overlaps
        else:                                           # device compute)
            tables.write_table(df, path, fmt=output_format)


def _adc_convert(raw, conv):
    from detprocess_jax.ops.saltinject import adc_convert

    return adc_convert(raw, conv)


def _parse_memory_limit(limit):
    """'2GB' / '500 MB' / bytes → bytes (reference memory_limit,
    features.py:283-380; humanfriendly equivalent)."""
    if limit is None:
        return None
    if isinstance(limit, (int, float)):
        return float(limit)
    txt = str(limit).strip().upper().replace(" ", "")
    for suffix, mult in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3), ("B", 1)):
        if txt.endswith(suffix):
            return float(txt[: -len(suffix)]) * mult
    return float(txt)


def _skip_rows(batches, skip: int):
    """Drop the first ``skip`` events from a batch iterator (resume)."""
    for traces, admins in batches:
        nb = len(admins)
        if skip >= nb:
            skip -= nb
            continue
        if skip:
            traces, admins = traces[skip:], admins[skip:]
            skip = 0
        yield traces, admins


def _load_external_extractors(path: str) -> dict:
    """Load user feature extractors from a python file
    (features.py:1002-1029 plug-in story, jax-traceable contract:
    module defines ``EXTRACTORS = {name: fn}`` with jax-traceable fns
    ``fn(traces [B, N], fs=..., nb_pretrigger_samples=..., **kwargs) ->
    {feature_name: [B] array}``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("detprocess_jax_ext",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if hasattr(module, "EXTRACTORS"):
        registry = dict(module.EXTRACTORS)
    else:
        registry = {name: fn for name, fn in vars(module).items()
                    if callable(fn) and not name.startswith("_")}
    builtin = (set(OF_1X1_ALGORITHMS) | set(OF_NXM_ALGORITHMS)
               | set(PSD_ALGORITHMS) | set(TRACE_ALGORITHMS) | {"rftau"})
    dupes = set(registry) & builtin
    if dupes:
        raise ValueError(
            f"external extractors duplicate built-in algorithms: {dupes} "
            "(features.py:1124-1128 duplicate rejection)")
    return registry
