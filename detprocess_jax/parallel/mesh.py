"""Device-mesh sharding: SPMD event parallelism over accelerator devices.

This replaces the reference's only parallelism mechanism —
multiprocessing.Pool over data series (detprocess/process/features.py:391-420,
SURVEY.md §2.2) — with jax.sharding over a device mesh:

- the **events** axis shards event batches across chips (the Pool-split
  equivalent; results are exactly shard-count invariant because each event
  is independent),
- cross-device reductions (PSD/CSD averaging over noise randoms) run as
  ``psum`` collectives (NCCL over NVLink on a GPU host) — collectives the reference never needed because workers shared
  nothing and wrote disjoint files.

All helpers are backend-agnostic: they work identically on the GPUs of
one host and on a virtual CPU mesh (``--xla_force_host_platform_device_count``)
used in tests. The mesh is flat (1-D): the cards of a host are joined all
to all, so no axis layout beats another.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


EVENTS_AXIS = "events"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = EVENTS_AXIS) -> Mesh:
    """1-D mesh over (up to) all available devices.

    Asking for more devices than exist is an error, not a silent clamp —
    a run that reports success while under-sharded hides a real
    misconfiguration (e.g. ``--mesh-devices 8`` on a 2-chip host).
    """
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} JAX device(s) are available "
                f"({devices[0].platform}); for a virtual CPU mesh set "
                "XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices} before jax initializes")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_batch(mesh: Mesh, batch, axis_name: str = EVENTS_AXIS):
    """Place a host batch (leading axis = events) sharded across the mesh."""
    def put(x):
        spec = P(axis_name, *([None] * (np.ndim(x) - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, batch)


def replicate(mesh: Mesh, tree):
    """Replicate (e.g. filter banks) across the mesh."""
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree.map(put, tree)


def sharded_map(mesh: Mesh, fn, axis_name: str = EVENTS_AXIS):
    """shard_map wrapper: ``fn(local_batch, replicated_args)`` runs per
    shard; outputs are event-sharded. fn must be shape-polymorphic in the
    leading (event) axis."""
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis_name), P()), out_specs=P(axis_name))
    def wrapped(batch, args):
        return fn(batch, args)
    return wrapped


# jitted spectral fns keyed on (kind, mesh, fs, axis_name): jax.jit
# returns a FRESH callable each call, so without this cache every
# sharded_psd/sharded_csd invocation (e.g. one per channel in
# Noise.calc_psd(mesh=...)) would recompile identical XLA.
_SPECTRAL_CACHE: dict = {}


def sharded_psd(mesh: Mesh, fs: float, axis_name: str = EVENTS_AXIS):
    """Welch PSD over an event-sharded trace batch with a psum mean —
    the cross-chip version of Noise.calc_psd (core/noise.py:216-373).

    Returns a jitted fn(traces [B, N] sharded) -> two-sided PSD [N]
    (replicated). Cached per (mesh, fs, axis_name)."""
    key = ("psd", mesh, float(fs), axis_name)
    hit = _SPECTRAL_CACHE.get(key)
    if hit is not None:
        return hit
    from detprocess_jax.ops import spectral

    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis_name),
             out_specs=P())
    def _psd(local_traces):
        pxx = spectral.periodogram(local_traces, fs)
        local_sum = jnp.sum(pxx, axis=-2)
        total = jax.lax.psum(local_sum, axis_name)
        count = jax.lax.psum(
            jnp.asarray(local_traces.shape[-2], local_sum.dtype), axis_name)
        return total / count

    fn = jax.jit(_psd)
    _SPECTRAL_CACHE[key] = fn
    return fn


def sharded_csd(mesh: Mesh, fs: float, axis_name: str = EVENTS_AXIS):
    """CSD over an event-sharded [B, C, N] batch with psum averaging.

    The result is returned as a stacked (re, im) real array [C, C, N, 2]
    (the same real format as the bank pytrees, ops/filterbank.py).
    Cached per (mesh, fs, axis_name)."""
    key = ("csd", mesh, float(fs), axis_name)
    hit = _SPECTRAL_CACHE.get(key)
    if hit is not None:
        return hit
    from detprocess_jax.ops import fft as dfft

    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis_name),
             out_specs=P())
    def _csd(local_traces):
        n = local_traces.shape[-1]
        vfft = dfft.fft(local_traces, axis=-1)
        local = dfft.einsum("bik,bjk->ijk", vfft, jnp.conj(vfft))
        total = jax.lax.psum(local, axis_name)
        count = jax.lax.psum(
            jnp.asarray(local_traces.shape[0], jnp.float32), axis_name)
        csd = total / count.astype(total.dtype) / (n * fs)
        return jnp.stack([csd.real, csd.imag], axis=-1)

    fn = jax.jit(_csd)
    _SPECTRAL_CACHE[key] = fn
    return fn


def sharded_longtrace_trigger(mesh: Mesh, kernel, threshold: float,
                              pileup_window: int, capacity_per_shard: int,
                              axis_name: str = EVENTS_AXIS):
    """ONE long continuous trace time-sharded across the mesh with
    template-length halo exchange — the long-trace design addition of
    SURVEY.md §5 (the reference processes traces whole and scales only by
    series, oftrigger.py:659-664; no cross-worker trace splitting exists
    there).

    Pipeline per shard, inside one shard_map:

    1. **Halo exchange** (ppermute between neighbouring devices): q[T] depends on
       x[T−p … T−p+Nt−1], so each shard fetches the last ``p`` samples of
       its left neighbor and the first ``Nt−p`` of its right neighbor —
       halo = one template length total.
    2. Local overlap-save FIR + Δχ² on the extended trace; global trace
       edges (first/last Nt samples) zeroed exactly as the unsharded
       kernel does.
    3. :func:`ops.trigger.find_triggers_sharded`: segmented-scan carries
       crossing shard boundaries via tiny all_gathers, so pileup groups
       straddling boundaries merge exactly.

    Returns a jitted fn(trace [C, L] sharded on the time axis) →
    (indices [D·K], dchi2 [D·K], amplitudes [M, D·K], count [D]) with
    global indices; empty slots are −1. Output is shard-count invariant
    (== the unsharded kernel on the whole trace, tested in
    tests/test_longtrace_sharded.py). L must divide evenly by the shard
    count and the per-shard length by 256.
    """
    from detprocess_jax.ops import trigger as trig_ops

    iw = jnp.asarray(kernel.iw_matrix)
    n_shards = mesh.shape[axis_name]
    nt, p = kernel.nt, kernel.pretrigger
    m = kernel.iw_matrix.shape[0]

    @partial(jax.shard_map, mesh=mesh, in_specs=P(None, axis_name),
             out_specs=(P(axis_name), P(axis_name), P(None, axis_name),
                        P(axis_name)))
    def _trig(local):                                  # [C, Lloc]
        c, l_loc = local.shape
        if l_loc % 256 != 0:
            raise ValueError("per-shard trace length must divide by 256")
        if l_loc < nt:
            # the halo slices below would silently clamp and feed shards
            # truncated neighbor context, corrupting q near boundaries
            raise ValueError(
                f"per-shard length {l_loc} is smaller than the template "
                f"length {nt}; use fewer shards or longer traces")
        idx = jax.lax.axis_index(axis_name)
        t0 = (idx * l_loc).astype(jnp.int32)
        l_glob = n_shards * l_loc

        # halo exchange (missing links at global edges deliver zeros,
        # matching the unsharded kernel's zero padding)
        fwd_perm = [(i, i + 1) for i in range(n_shards - 1)]
        bwd_perm = [(i + 1, i) for i in range(n_shards - 1)]
        halo_l = max(p, 1)
        halo_r = max(nt - p, 1)
        left = jax.lax.ppermute(local[:, -halo_l:], axis_name, fwd_perm)
        right = jax.lax.ppermute(local[:, :halo_r], axis_name, bwd_perm)
        ext = jnp.concatenate([left, local, right], axis=-1)
        l_ext = l_loc + halo_l + halo_r

        q_ext, _ = trig_ops.of_fir_blocks(ext, kernel,
                                          valid_range=(0, l_ext))
        q_loc = q_ext.reshape(m, -1)[:, halo_l: halo_l + l_loc]
        # zero the GLOBAL trace edges (first/last Nt samples)
        tt = jnp.arange(l_loc, dtype=jnp.int32) + t0
        edge_ok = (tt >= nt) & (tt < l_glob - nt)
        q_loc = q_loc * edge_ok[None, :]

        qb = q_loc.reshape(m, l_loc // 256, 256)
        d, a = trig_ops.delta_chi2_blocks(qb, iw)
        ts = trig_ops.find_triggers_sharded(
            d, a, threshold, pileup_window, capacity_per_shard,
            t0, axis_name, n_shards)
        return (ts.indices, ts.dchi2, ts.amplitudes,
                ts.count.reshape(1))

    return jax.jit(_trig)


def merge_sharded_triggers(indices, dchi2, amplitudes):
    """Host-side assembly of sharded_longtrace_trigger output into one
    time-ordered trigger list (drops the −1 empty slots)."""
    indices = np.asarray(indices)
    keep = indices >= 0
    order = np.argsort(indices[keep], kind="stable")
    return (indices[keep][order], np.asarray(dchi2)[keep][order],
            np.asarray(amplitudes)[:, keep][:, order])


def sharded_trigger(mesh: Mesh, kernel, threshold: float,
                    pileup_window: int, capacity: int,
                    axis_name: str = EVENTS_AXIS):
    """Continuous-trace OF triggering sharded over the events axis — the
    multi-chip version of TriggerProcessing's per-event dispatch (the
    reference splits series across a multiprocessing Pool instead,
    process/triggers.py:337-377).

    Each chip runs the full FIR + Δχ² + pileup-merge kernel on its local
    events; no collectives are needed because continuous events are
    independent. Returns a jitted fn(traces [E, C, L] event-sharded) →
    (indices [E, K], dchi2 [E, K], amplitudes [E, M, K], count [E]),
    all event-sharded. Outputs are shard-count invariant.
    """
    from detprocess_jax.ops import trigger as trig_ops

    iw = jnp.asarray(kernel.iw_matrix)

    def _one(tr):
        qb, _ = trig_ops.of_fir_blocks(tr, kernel)
        d, a = trig_ops.delta_chi2_blocks(qb, iw)
        ts = trig_ops.find_triggers_blocks(d, a, threshold,
                                           pileup_window, capacity)
        return ts.indices, ts.dchi2, ts.amplitudes, ts.count

    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis_name),
             out_specs=P(axis_name))
    def _trig(local_traces):
        return jax.vmap(_one)(local_traces)

    return jax.jit(_trig)
