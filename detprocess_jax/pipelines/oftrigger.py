"""Interactive object-level OF trigger — the notebook-facing counterpart
of the batched :class:`~detprocess_jax.pipelines.triggers.TriggerProcessing`
pipeline.

Reference parity: ``detprocess.core.oftrigger.OptimumFilterTrigger``
(core/oftrigger.py:324-1037) — a stateful single-trace trigger object
(``update_trace`` → ``find_triggers`` → ``get_trigger_data_df``) used
directly in notebooks and by the EventBuilder's ``acquire_triggers``
protocol. The heavy math (overlap-save FIR, Δχ², 50 kHz LPF) runs on
device through the same kernels as the pipeline (ops/trigger.py,
ops/spectral.py); the per-trace merge bookkeeping stays host-side numpy,
which for ONE interactive trace is exact, simple, and transfer-cheap.
Production batch triggering should use TriggerProcessing (vmapped,
on-device merge, mesh sharding).

Conventions (documented differences from the reference, same results):

- Trigger indices need no post-hoc ``pretrigger − N//2`` shift: the FIR
  kernel folds the shift in so q(T) peaks exactly at the trigger point
  (ops/trigger.py::make_trigger_kernel; alignment tested in
  test_trigger.py). The reference applies the shift after its
  'same'-mode convolution (oftrigger.py:464, :1005-1010).
- ``get_trigger_data_df`` returns a pandas DataFrame (the framework's
  table layer) rather than a vaex one.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import pandas as pd

import jax
import jax.numpy as jnp

from detprocess_jax.ops import filterbank, spectral
from detprocess_jax.ops import trigger as trig_ops


def _group_ranges_static(idx: np.ndarray, window: int):
    """Start/end positions (into ``idx``) of runs whose consecutive gaps
    are ≤ ``window`` (oftrigger.py:29-74 semantics)."""
    if len(idx) == 0:
        return np.zeros((0, 2), dtype=int)
    breaks = np.where(np.diff(idx) > window)[0] + 1
    starts = np.concatenate([[0], breaks])
    ends = np.concatenate([breaks, [len(idx)]])
    return np.stack([starts, ends], axis=1)


class OptimumFilterTrigger:
    """Time-domain optimal-filter trigger on one continuous trace
    (core/oftrigger.py:324-503).

    Parameters
    ----------
    trigger_channel : str | list of str
        Channel name(s); a list (or 'a|b') makes an NxM trigger.
    fs : float
        Sample rate (Hz).
    template : ndarray
        Pulse template(s): [C, M, S], or 1D/[1,S]/[S,1] for 1x1.
    noisecsd : ndarray
        Two-sided noise CSD [C, C, F] (or 1D/2D like ``template``) in
        A²/Hz.
    pretrigger_samples : int
        Template trigger-point sample.
    ignored_frequency_peaks : float | list of float, optional
        Frequencies notched out of the OF (nearest ± bins → ∞ CSD).
    ignore_harmonics : bool
        Also notch harmonics of each ignored peak.
    trigger_name : str, optional
        Label for output columns (default: the channel name).
    """

    def __init__(self, trigger_channel, fs, template, noisecsd,
                 pretrigger_samples,
                 ignored_frequency_peaks=None,
                 ignore_harmonics: bool = False,
                 trigger_name: Optional[str] = None):
        from detprocess_jax.utils import jaxcache
        jaxcache.enable()   # compiled kernels persist across processes
        self._fs = float(fs)
        self._pretrigger_samples = int(pretrigger_samples)
        if isinstance(trigger_channel, (list, tuple)):
            self._trigger_channel = "|".join(trigger_channel)
        else:
            self._trigger_channel = str(trigger_channel)
        name = (str(trigger_name) if trigger_name is not None
                else self._trigger_channel)
        self._trigger_name = name.replace("\0", "")

        # shape normalization/validation ([N]/[1,N]/[N,1] → [1,1,N],
        # ambiguous 2D rejected) is owned by make_ofnxm_bank's
        # _reshape_template_3d/_reshape_csd_3d
        self._bank = filterbank.make_ofnxm_bank(
            template, noisecsd, self._fs,
            self._pretrigger_samples,
            ignored_frequency_peaks=ignored_frequency_peaks,
            ignore_harmonics=ignore_harmonics)
        self._kernel = trig_ops.make_trigger_kernel(self._bank)

        self._n_channels = self._bank.nchans
        self._m_amplitudes = self._bank.ntmps
        self._nb_samples = self._bank.nbins
        self._posttrigger_samples = (self._nb_samples
                                     - self._pretrigger_samples)

        # time-domain filter for get_phi (DC zeroed first, :494-498)
        phi_fd = np.array(self._bank.phi)
        phi_fd[:, :, 0] = 0.0
        self._phi_td = np.fft.ifft(phi_fd, axis=2).real
        self._norm = float(np.dot(self._phi_td[0, 0],
                                  np.asarray(self._bank.templates)[0, 0]))
        self._resolution = np.asarray(self._bank.resolution)

        self.chi2_threshold: Optional[float] = None
        self._trigger_data: Optional[dict] = None
        self._raw_trace: Optional[np.ndarray] = None
        self._raw_trace_lpf_50khz: Optional[np.ndarray] = None
        self._filtered_trace: Optional[np.ndarray] = None
        self._delta_chi2_trace: Optional[np.ndarray] = None
        self._residual_delta_chi2_trace: Optional[np.ndarray] = None
        self._fns: dict = {}     # jitted device step per trace length

    # -- accessors (oftrigger.py:505-587) -------------------------------
    def get_filtered_trace(self):
        """Filtered amplitude trace a(t) [M, L] from the last
        update_trace."""
        return self._filtered_trace

    def get_filtered_delta_chi2(self):
        """Δχ²(t) [L] from the last update_trace."""
        return self._delta_chi2_trace

    def get_chi2_threshold(self):
        """χ² threshold used by the last find_triggers call."""
        return self.chi2_threshold

    def get_trigger_data(self):
        """Trigger dictionary keyed by trigger name."""
        return self._trigger_data

    def get_trigger_data_df(self) -> Optional[pd.DataFrame]:
        """Triggers as a pandas DataFrame (reference returns vaex)."""
        if self._trigger_data is None:
            return None
        data = self._trigger_data[self._trigger_name]
        return pd.DataFrame({k: np.asarray(v, dtype=object)
                             if v and isinstance(v[0], str)
                             else np.asarray(v)
                             for k, v in data.items()})

    def get_phi(self):
        """Time-domain optimal filter [C, M, S] (DC removed)."""
        return self._phi_td

    def get_norm(self):
        """OF normalization φ·s of the first (channel, template)."""
        return self._norm

    def get_resolution(self):
        """Expected amplitude resolution per template, √diag(W⁻¹)."""
        return self._resolution

    # -- trace update (oftrigger.py:588-672) -----------------------------
    def _device_step(self, length: int):
        fn = self._fns.get(length)
        if fn is None:
            kernel = self._kernel

            def run(trace):
                # no kernel-side edge zeroing: update_trace owns the
                # padding cut (one rule for both input modes)
                q = trig_ops.of_fir(trace, kernel,
                                    valid_range=(0, length))    # [M, L]
                iw = jnp.asarray(kernel.iw_matrix)
                dchi2, amps = trig_ops.delta_chi2(q, iw)
                lpf = spectral.lowpass_filter(trace, 50e3, kernel.fs)
                return amps, dchi2, lpf

            fn = jax.jit(run)
            self._fns[length] = fn
        return fn

    def update_trace(self, trace=None, filtered_trace=None,
                     padding: bool = True):
        """Filter a trace (device overlap-save FIR + Δχ²) or adopt an
        externally filtered one, storing the results for find_triggers.

        ``trace``: [C, L] (or 1D) raw trace in Amps. ``filtered_trace``:
        [M, L] pre-filtered amplitudes. ``padding`` zeroes Δχ² within a
        template length of each edge so padded samples never trigger.
        """
        if trace is None and filtered_trace is None:
            raise ValueError('ERROR: "trace" or "filtered_trace" '
                             "required!")

        if trace is not None:
            trace = np.atleast_2d(np.asarray(trace))
            if trace.shape[0] != self._n_channels:
                raise ValueError(
                    f'ERROR: "trace" has shape {trace.shape}, but this '
                    f"trigger has {self._n_channels} channel(s)")
            self._raw_trace = trace

        if filtered_trace is not None:
            filtered_trace = np.atleast_2d(np.asarray(filtered_trace))
            if filtered_trace.shape[0] != self._m_amplitudes:
                raise ValueError(
                    f'ERROR: "filtered_trace" has shape '
                    f"{filtered_trace.shape}, but this trigger has "
                    f"{self._m_amplitudes} amplitude(s)")
            self._filtered_trace = filtered_trace.astype(np.float64)
            # Δχ²(t) = a(t)ᵀ W a(t)
            w = np.asarray(self._bank.w_matrix)
            self._delta_chi2_trace = np.einsum(
                "iz,ij,jz->z", self._filtered_trace, w,
                self._filtered_trace).real
            if trace is not None:
                lpf = spectral.lowpass_filter(
                    jnp.asarray(trace, jnp.float32), 50e3, self._fs)
                self._raw_trace_lpf_50khz = np.asarray(lpf)
            else:
                # no raw trace for THIS filtered trace: a previous
                # trace's LPF must not drive the saturation veto
                # (without it the veto treats every trigger as
                # unsaturated; the reference requires the raw trace)
                self._raw_trace = None
                self._raw_trace_lpf_50khz = None
        else:
            step = self._device_step(trace.shape[-1])
            amps, dchi2, lpf = step(jnp.asarray(trace, jnp.float32))
            self._filtered_trace = np.asarray(amps, dtype=np.float64)
            self._delta_chi2_trace = np.asarray(dchi2, dtype=np.float64)
            self._raw_trace_lpf_50khz = np.asarray(lpf)

        if padding:
            # exact reference cut (oftrigger.py:674-679) on both input
            # modes; the device step computes unzeroed q so this is the
            # single owner of the padding rule
            cut = self._nb_samples
            self._delta_chi2_trace[:cut] = 0.0
            self._delta_chi2_trace[len(self._delta_chi2_trace)
                                   - cut + (cut + 1) % 2:] = 0.0

    # -- triggering (oftrigger.py:682-1037) ------------------------------
    def find_triggers_once(self, thresh,
                           pileup_window_msec=None,
                           pileup_window_samples=None,
                           dynamic: bool = False,
                           dynamic_threshold_function=None):
        """Single-pass threshold + pileup merge on the stored Δχ² trace;
        fills the trigger dictionary (one row per merged group, keeping
        the max-Δχ² sample)."""
        if self._delta_chi2_trace is None:
            raise ValueError('ERROR: Filtered trace not available. '
                             'Use "update_trace" first!')
        if dynamic and dynamic_threshold_function is None:
            raise ValueError("dynamic=True requires "
                             "dynamic_threshold_function")

        pileup_window = 0
        if pileup_window_msec is not None:
            pileup_window = int(pileup_window_msec * self._fs / 1000)
        elif pileup_window_samples is not None:
            pileup_window = int(pileup_window_samples)

        self.chi2_threshold = trig_ops.chi2_threshold(
            float(thresh), self._m_amplitudes)

        dchi2 = self._delta_chi2_trace
        if dynamic:
            # same host grouper the batched pipeline uses (single owner
            # of the amplitude-dependent-window semantics)
            winners, _, _ = trig_ops.find_triggers_dynamic(
                dchi2, self._filtered_trace, self.chi2_threshold,
                dynamic_threshold_function)
            winners = [int(w) for w in winners]
        else:
            above = np.where(dchi2 > self.chi2_threshold)[0]
            ranges = _group_ranges_static(above, pileup_window)
            winners = [int(above[st:en][np.argmax(dchi2[above[st:en]])])
                       for st, en in ranges]

        data: dict = {
            "trigger_delta_chi2": [], "trigger_time": [],
            "trigger_index": [], "trigger_pileup_window": [],
            "trigger_threshold_sigma": [], "trigger_type": []}
        for iamp in range(self._m_amplitudes):
            data[f"trigger_amplitude_{iamp}"] = []
        if self._m_amplitudes == 1:
            data["trigger_amplitude"] = []

        for win in winners:
            # q(T) already peaks at the trigger point (kernel-folded
            # shift) — no pretrigger−N//2 correction needed here
            data["trigger_index"].append(int(win))
            data["trigger_time"].append(win / self._fs)
            data["trigger_delta_chi2"].append(float(dchi2[win]))
            data["trigger_type"].append(4)
            for iamp in range(self._m_amplitudes):
                data[f"trigger_amplitude_{iamp}"].append(
                    float(self._filtered_trace[iamp][win]))
            if self._m_amplitudes == 1:
                data["trigger_amplitude"].append(
                    float(self._filtered_trace[0][win]))
            data["trigger_threshold_sigma"].append(float(thresh))
            data["trigger_pileup_window"].append(pileup_window)

        # always present (the reference adds it only when n > 0, which
        # gives zero-trigger results a different schema — deliberate
        # deviation so empty frames concat/groupby cleanly)
        n = len(data["trigger_index"])
        data["trigger_channel"] = [self._trigger_name] * n
        # per-channel suffixed duplicates share the reference layout
        out = dict(data)
        for key, val in data.items():
            out[f"{key}_{self._trigger_name}"] = val
        self._trigger_data = {self._trigger_name: out}

    def _is_saturated(self, trigger_index: int, sat_amps,
                      positive_pulses: bool) -> bool:
        half = self._nb_samples // 4
        lpf = self._raw_trace_lpf_50khz
        if lpf is None:
            return False
        lo = max(trigger_index - half, 0)
        hi = trigger_index + half
        for c in range(self._n_channels):
            seg = lpf[c, lo:hi]
            if positive_pulses:
                if np.any(seg > sat_amps[c]):
                    return True
            elif np.any(seg < -sat_amps[c]):
                return True
        return False

    def _subtract_trigger(self, trigger_index: int):
        """Subtract one trigger's best-fit Δχ² shape from the stored
        Δχ² trace, aligned so the shape's peak sits on the trigger
        (oftrigger.py:793-820). Uses the kernel's precomputed filter
        responses resp_ij(d) = (filter i ∗ template j)(d)."""
        amps = self._filtered_trace[:, trigger_index]
        # response lag axis is symmetric −(N−1)..(N−1)
        resp = np.asarray(self._kernel.response, dtype=np.float64)
        v = np.einsum("ijd,j->id", resp, amps)
        iw = np.asarray(self._kernel.iw_matrix, dtype=np.float64)
        w = np.asarray(self._bank.w_matrix, dtype=np.float64)
        fit = iw @ v
        shape = np.einsum("id,ij,jd->d", fit, w, fit).real
        j = int(np.argmax(shape))
        lo = trigger_index - j
        hi = lo + shape.shape[0]
        clo, chi = max(lo, 0), min(hi, len(self._delta_chi2_trace))
        self._delta_chi2_trace[clo:chi] -= shape[clo - lo:chi - lo]

    def find_triggers(self, thresh,
                      pileup_window_msec=None, pileup_window_samples=None,
                      positive_pulses: bool = True,
                      dynamic: bool = False,
                      dynamic_threshold_function=None,
                      residual: bool = False,
                      saturation_amplitudes_LPF_50kHz=None,
                      edge_exclusion_msec=None,
                      livetime=None,
                      return_trigger_data: bool = False):
        """Threshold trigger with optional residual re-trigger,
        saturation veto, and edge exclusion (oftrigger.py:682-888).

        With ``residual=True`` the best-fit Δχ² shape of every
        unsaturated first-pass trigger is subtracted and the residual is
        re-triggered; new (non-duplicate) triggers merge into the
        trigger dictionary. ``return_trigger_data=True`` returns
        (first_data, first_dchi2, second_data, second_dchi2).
        """
        ret = None
        if residual:
            if saturation_amplitudes_LPF_50kHz is None:
                # ∞ disables the veto for either polarity (the check is
                # seg > sat for positive pulses, seg < −sat for negative)
                saturation_amplitudes_LPF_50kHz = (
                    [np.inf] * self._n_channels)

            self.find_triggers_once(thresh, pileup_window_msec,
                                    pileup_window_samples, dynamic,
                                    dynamic_threshold_function)
            first = copy.deepcopy(self._trigger_data)
            first_idx = list(
                self._trigger_data[self._trigger_name]["trigger_index"])
            first_dchi2 = np.copy(self._delta_chi2_trace)

            for ti in first_idx:
                if self._is_saturated(ti, saturation_amplitudes_LPF_50kHz,
                                      positive_pulses):
                    continue
                self._subtract_trigger(ti)

            self.find_triggers_once(thresh, pileup_window_msec,
                                    pileup_window_samples, dynamic,
                                    dynamic_threshold_function)
            second = copy.deepcopy(self._trigger_data)
            second_idx = list(
                self._trigger_data[self._trigger_name]["trigger_index"])
            self._residual_delta_chi2_trace = np.copy(
                self._delta_chi2_trace)
            second_dchi2 = np.copy(self._delta_chi2_trace)
            self._delta_chi2_trace = first_dchi2

            self._trigger_data = combine_trigger_data(
                first, second, first_idx, second_idx)
            if return_trigger_data:
                ret = (first, first_dchi2, second, second_dchi2)
        else:
            self.find_triggers_once(thresh, pileup_window_msec,
                                    pileup_window_samples, dynamic,
                                    dynamic_threshold_function)

        if edge_exclusion_msec is not None:
            tmin = edge_exclusion_msec * 1e-3
            tmax = (self._filtered_trace.shape[-1] / self._fs) - tmin
            for chan, data in list(self._trigger_data.items()):
                times = data["trigger_time"]
                if len(times) == 0:
                    continue
                keep = [i for i, t in enumerate(times) if tmin < t < tmax]
                out = {k: [v[i] for i in keep] for k, v in data.items()}
                out[f"trigger_edge_exclusion_time_{chan}"] = [tmin] * len(
                    keep)
                if livetime is not None:
                    out[f"trigger_livetime_{chan}"] = [livetime] * len(
                        keep)
                self._trigger_data[chan] = out
        return ret


def combine_trigger_data(original_trigger_data, new_trigger_data,
                         original_triggers, new_triggers):
    """Merge two trigger dictionaries, appending only entries of
    ``new_triggers`` absent from ``original_triggers``
    (core/oftrigger.py:262-321; the TriggerSet analog is
    ops.trigger.combine_trigger_sets)."""
    unique = set(new_triggers) - set(original_triggers)
    name = next(iter(original_trigger_data))
    merged = copy.deepcopy(original_trigger_data[name])
    new_inner = new_trigger_data[name]
    take = [i for i, t in enumerate(new_triggers) if t in unique]
    n_orig = len(merged.get("trigger_index", ()))
    for key, vals in new_inner.items():
        if key not in merged:
            # column absent from the first pass (e.g. trigger_channel on
            # an empty pass): pad its first-pass rows so every column
            # stays row-aligned
            merged[key] = [None] * n_orig + [vals[i] for i in take]
            continue
        merged[key] = list(merged[key]) + [vals[i] for i in take]
    # ... and columns absent from the second pass pad symmetrically
    for key in merged:
        if key not in new_inner and len(merged[key]) == n_orig:
            merged[key] = list(merged[key]) + [None] * len(take)
    # suffixed duplicates must stay identical to their base columns
    for key in list(merged):
        base = key.removesuffix(f"_{name}")
        if base != key and base in merged:
            merged[key] = list(merged[base])
    return {name: merged}
