"""On-device salt injection.

The reference injects simulated pulses on the HOST, adding scaled
templates into each event's traces as it is read
(/root/reference/detprocess/core/salting.py:479-621, applied per event at
/root/reference/detprocess/process/processing_data.py:539-553). Here the
injection is a batched device op: per event, up to K salts are described
by (start index, channel, template id, amplitude) arrays and added with
one masked scatter — so salted runs keep the raw int16 upload path
(half the host→device bytes) and the host never touches the trace
bytes.

Out-of-range positions clip naturally (``mode="drop"``); unused slots
carry ``amp = 0``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def adc_convert(raw, conv):
    """On-device ADC→amps conversion: ``raw`` [B, C, N] in the stored
    dtype (int16 codes for real pytesdaq data), ``conv`` [B, C] the
    per-event/channel cal/close_loop_norm factors. One fused elementwise
    pass — exactly what the float path's upload staging already cost.
    Shared by the trigger and feature pipelines."""
    if not hasattr(adc_convert, "_fn"):
        adc_convert._fn = jax.jit(
            lambda r, c: r.astype(jnp.float32) * c[:, :, None])
    return adc_convert._fn(raw, conv)


class SaltPlan(NamedTuple):
    """Per-batch injection arrays (host-built, tiny).

    idx  [E, K] int32 — template start sample (t=0 of the template) in
                        trace coordinates; may be negative (clipped add)
    chan [E, K] int32 — channel index into the trace's channel axis
    tid  [E, K] int32 — row into the template stack
    amp  [E, K] f32   — template scale; 0 disables the slot
    """

    idx: np.ndarray
    chan: np.ndarray
    tid: np.ndarray
    amp: np.ndarray


def empty_plan(nevents: int, k: int) -> SaltPlan:
    return SaltPlan(np.zeros((nevents, k), np.int32),
                    np.zeros((nevents, k), np.int32),
                    np.zeros((nevents, k), np.int32),
                    np.zeros((nevents, k), np.float32))


def inject_salts(traces: jnp.ndarray, idx, chan, tid, amp,
                 templates: jnp.ndarray) -> jnp.ndarray:
    """Add ``amp[e,k] · templates[tid[e,k]]`` into channel ``chan[e,k]``
    of event ``e`` starting at sample ``idx[e,k]``.

    traces [E, C, N] float; templates [T, NT] float. K × NT scattered
    elements per event (K ≲ 16, NT ≲ 32k) — negligible against the
    trace bytes themselves.
    """
    if not hasattr(inject_salts, "_fn"):
        def _impl(traces, idx, chan, tid, amp, templates):
            nt = templates.shape[-1]

            def one(tr, idx_e, chan_e, tid_e, amp_e):
                pos = (idx_e[:, None]
                       + jnp.arange(nt, dtype=jnp.int32)[None, :])
                vals = amp_e[:, None] * templates[tid_e]     # [K, NT]
                return tr.at[chan_e[:, None], pos].add(
                    vals.astype(tr.dtype), mode="drop")

            return jax.vmap(one)(traces, idx, chan, tid, amp)

        inject_salts._fn = jax.jit(_impl)
    return inject_salts._fn(traces, idx, chan, tid, amp, templates)


class DeviceInjector:
    """Host-side planner + device templates for batched salt injection.

    Built by ``Salting.make_device_injector(channel_list)``; used by the
    pipelines: ``plan(admins, window_starts=)`` → SaltPlan for a batch,
    ``templates`` (device [T, NTmax] array, zero-padded rows) added via
    :func:`inject_salts` after the on-device ADC conversion.
    """

    def __init__(self, salt_df, template_lookup,
                 channel_list: Sequence[str],
                 max_salts_per_event: int = 16):
        self.channel_list = list(channel_list)
        self.k = int(max_salts_per_event)
        # template stack: one row per (channel, tag) pair in use
        pairs = []
        if "salt_template_tag" in salt_df.columns:
            pairs = sorted({(r, t) for r, t in zip(
                salt_df["salt_channel"], salt_df["salt_template_tag"])})
        else:
            pairs = sorted({(r, "default")
                            for r in salt_df["salt_channel"]})
        tmpls, pretrigs = [], {}
        self._tid = {}
        for i, (chan, tag) in enumerate(pairs):
            tmpl, p = template_lookup(chan, tag)
            tmpls.append(np.asarray(tmpl, np.float32))
            pretrigs[(chan, tag)] = int(p)
            self._tid[(chan, tag)] = i
        ntmax = max((t.shape[-1] for t in tmpls), default=1)
        stack = np.zeros((max(len(tmpls), 1), ntmax), np.float32)
        for i, t in enumerate(tmpls):
            stack[i, : t.shape[-1]] = t
        self.templates = stack
        self._pretrig = pretrigs
        # (series, event) -> list of row dicts (one-time index; the
        # planner runs on the batch hot path)
        self._by_event = {}
        for row in salt_df.to_dict("records"):
            key = (row["series_number"], row["event_number"])
            self._by_event.setdefault(key, []).append(row)

    def plan(self, admins, window_starts=None) -> SaltPlan:
        """Build the batch SaltPlan from the events' admin dicts.

        ``window_starts``: per-event trace-window offsets for windowed
        (trigger-dataframe) reads — positions shift by −start, matching
        the host injector's ``window_start``.
        """
        e = len(admins)
        p = empty_plan(e, self.k)
        overflow = 0
        for i, admin in enumerate(admins):
            rows = self._by_event.get((admin["series_number"],
                                       admin["event_number"]))
            if not rows:
                continue
            ws = 0 if window_starts is None else int(window_starts[i])
            slot = 0
            for row in rows:
                chan = row["salt_channel"]
                if chan not in self.channel_list:
                    continue
                if slot >= self.k:
                    overflow += 1
                    continue
                tag = row.get("salt_template_tag", "default")
                p.idx[i, slot] = (int(row["trigger_index"])
                                  - self._pretrig[(chan, tag)] - ws)
                p.chan[i, slot] = self.channel_list.index(chan)
                p.tid[i, slot] = self._tid[(chan, tag)]
                p.amp[i, slot] = row["salt_amplitude"]
                slot += 1
        if overflow:
            print(f"WARNING: {overflow} salts dropped — more than "
                  f"max_salts_per_event={self.k} in one event; raise "
                  f"make_device_injector(max_salts_per_event=...)")
        return p
