"""Continuous-trace optimal-filter trigger kernels.

Batched device replacement for the reference OptimumFilterTrigger
(detprocess/core/oftrigger.py:324-1037). The reference runs
scipy.signal.oaconvolve + einsum per continuous trace in Python
(oftrigger.py:659-672) and merges threshold crossings with a Python loop;
here everything runs on device with static shapes:

1. **FIR filter bank** (`of_fir`): overlap-save FFT convolution of the
   C-channel continuous trace with the M matched filters, giving the
   amplitude-numerator time series q [M, L].
2. **Δχ²(t) = q(t)ᵀ W⁻¹ q(t)** and amplitudes a(t) = W⁻¹ q(t)
   (oftrigger.py:666-672).
3. **Threshold + pileup merge** (`find_triggers_kernel`): above-threshold
   samples whose gaps are ≤ pileup_window merge into one trigger at the
   max-Δχ² sample (oftrigger.py:975-1019, _getchangeslessthanthresh) —
   implemented as a cummax-based segmented argmax with a fixed trigger
   capacity K (data-dependent counts become masks).
4. **Residual re-trigger** (`residual_subtract`): subtract each first-pass
   trigger's best-fit Δχ² response and re-threshold
   (oftrigger.py:752-842), with the 50 kHz-LPF saturation veto.

Time alignment: the matched filter is built so that a pulse whose *trigger
point* (template pretrigger sample) sits at continuous-trace index T puts
the Δχ² maximum exactly at index T — equivalent to the reference's
'same'-mode convolution plus its ``pretrigger − N//2`` index shift
(oftrigger.py:456, :1005).

χ² thresholds: a sigma-level ``thresh`` maps to a χ²_M threshold via
``gammainccinv(M/2, 2·norm.sf(thresh))·2`` for thresh < 25, else thresh²
(oftrigger.py:961-973) — computed on host (static).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy import special, stats

from detprocess_jax.ops import fft as dfft
from detprocess_jax.ops.filterbank import OFNxMBank, split_complex, join_complex

# every contraction at full float32 precision (see ops/fft.HIGHEST)
_einsum = dfft.einsum


# ---------------------------------------------------------------------------
# host precompute
# ---------------------------------------------------------------------------

def chi2_threshold(thresh_sigma: float, m_amplitudes: int) -> float:
    """Sigma-level → χ²_M threshold (oftrigger.py:961-973)."""
    if thresh_sigma < 25:
        sf = stats.norm.sf(thresh_sigma) * 2
        return float(special.gammainccinv(m_amplitudes / 2, sf) * 2)
    return float(thresh_sigma**2)


#: Default overlap-save ``block``: segments are FFT'd at the power of two
#: F ≥ max(block, 2·overlap). With the 32768-sample template on an
#: NVIDIA H100 80GB HBM3 (700 W power limit), F = 131072 ran the trigger
#: step on 10 Msamples in 0.690 ms against 0.749 ms at F = 65536 (median
#: of 3 interleaved runs each, 1.085×); F = 524288 did not finish
#: compiling in 4 minutes.
TRIGGER_BLOCK = 131072


class TriggerKernel(NamedTuple):
    """Host-side trigger precompute, transferable as real arrays."""

    g_fft: np.ndarray          # [C, M, F//2+1, 2] split re/im — half-spectrum
                               # rFFT of the linear matched filters, padded to F
    iw_matrix: np.ndarray      # [M, M]
    response: np.ndarray       # [M, M, 2·Nt-1] Δχ²-subtraction responses:
                               # response[i, j] = (filter_i ⋆ template_j)
    nt: int                    # template length
    pretrigger: int
    fs: float
    block: int                 # overlap-save valid samples per segment B
    fft_size: int              # F = B + overlap, overlap ≥ Nt − 1
    resolution: np.ndarray     # per-amplitude σ


def _fir_layout(g: np.ndarray, block: int, real_dtype):
    """Overlap-save FIR precompute for time-domain kernels g [C, M, Nt].

    Sizing: the FFT size F is a power of two ≥ ``block``; the
    inter-segment overlap H is Nt−1 rounded up to a multiple of 128,
    and each segment contributes B = F − H valid samples. A symmetric
    F = 2B split would FFT every sample twice; this wastes only H/F.

    Returns (g_fft split re/im, block B, fft_size F).
    """
    c, m, n = g.shape
    overlap = max(128 * int(np.ceil((n - 1) / 128)), 128)
    f_size = int(2 ** np.ceil(np.log2(max(block, 2 * overlap))))
    block = f_size - overlap
    g_pad = np.zeros((c, m, f_size))
    g_pad[..., :n] = g
    # half-spectrum: segments are real, so the FIR runs rfft→multiply→irfft
    # (half the FFT work and HBM traffic of the full complex path)
    g_fft = np.fft.rfft(g_pad, axis=-1)
    return split_complex(g_fft, real_dtype), block, f_size


def make_trigger_kernel(bank: OFNxMBank, block: int = TRIGGER_BLOCK,
                        real_dtype=np.float32) -> TriggerKernel:
    """Build the continuous-trigger kernel from an NxM OF bank.

    The linear matched filter for amplitude i, channel c is
    ``w[c,i,τ] = N·ifft(Phi[c,i])(τ mod N)`` re-rolled so τ is measured
    from the window start; convolution uses the flipped kernel.
    Overlap-save sizing and spectral layout: :func:`_fir_layout`.
    """
    c, m, n = bank.templates.shape
    p = bank.pretrigger
    # circular matched filter w(τ) = N·ifft(Phi). The linear FIR kernel is
    # h(j) = w((j−(N−1)) mod N), j ∈ [0, N), so that with y = conv(x, h)
    # the amplitude numerator is q(T) = y[T + N−1−pretrigger]: a pulse
    # whose trigger point sits at continuous index T peaks at q[T]
    # (equivalent to the reference's conv-with-phi_td + index shift,
    # oftrigger.py:659-664, :1005; alignment tested in test_trigger.py)
    w_circ = np.real(np.fft.ifft(bank.phi, axis=-1)) * n    # [C, M, N]
    g = np.roll(w_circ, n - 1, axis=-1)
    g_fft, block, f_size = _fir_layout(g, block, real_dtype)

    # Δχ² subtraction responses: filter i applied to a unit pulse of
    # template j, as a function of lag d around the pulse position:
    # resp_ij(d) = Re Σ_{c,k} Phi[c,i,k]·S̃[c,j,k]·e^{2πikd/N}  (circular);
    # stored on a symmetric lag axis −(N−1)..(N−1).
    cross = np.einsum("cik,cjk->ijk", bank.phi, bank.s_fft)
    resp_circ = np.real(np.fft.ifft(cross, axis=-1)) * n     # [M, M, N]
    resp = np.concatenate([resp_circ[..., -(n - 1):], resp_circ],
                          axis=-1)

    return TriggerKernel(
        g_fft=g_fft,
        iw_matrix=bank.iw_matrix.astype(real_dtype),
        response=resp.astype(real_dtype),
        nt=n, pretrigger=p, fs=bank.fs, block=block, fft_size=f_size,
        resolution=bank.resolution.astype(real_dtype),
    )


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def of_fir_blocks(trace: jnp.ndarray, kernel: TriggerKernel,
                  valid_range: Optional[tuple] = None):
    """Overlap-save FIR in 2-D block layout: trace [C, L] →
    (q_blocks [M, nb, B], nb·B ≥ L).

    The amplitude series q is returned as rows of ``block`` samples
    (row-major order = time order; q[T] = q_blocks[:, T//B, T%B], valid
    for T < L). Segments are a B-block plus the aligned head of the next
    block, glued by reshape+slice+concat (no gathers); FFT batch
    [C, nb, F].

    Edge samples (first/last Nt of the trace) are zeroed, mirroring the
    reference's padding cut (oftrigger.py:674-679). ``valid_range``
    overrides the zeroed span: q is kept for T in [lo, hi) — pass
    ``(0, l)`` when the trace already carries halo context on both ends
    (cross-shard long-trace mode, parallel/mesh.py).
    """
    c, l = trace.shape
    nt, p = kernel.nt, kernel.pretrigger
    b, f = kernel.block, kernel.fft_size

    # y = conv(x, h); q(T) = y[T + nt−1−p]. Shift the input left by
    # (p − (nt−1)) so that q(T) = conv(xshift)(T) directly: pad with
    # nt−1−p zeros... equivalently pad left with (nt−1) zeros and start
    # reading y at (nt−1−p). With segments of two B-blocks, the valid
    # conv outputs of segment i are y[i·B + j], j ∈ [0, B), taken at
    # in-segment offset (nt−1) + j... we fold the global shift into the
    # left padding: xpad[k] = x[k − pad_left + (nt−1−p)]… net left pad:
    pad_left = nt - 1 - (nt - 1 - p)         # = p
    nblocks = -(-l // b)
    pad_right = (nblocks + 1) * b - (pad_left + l)
    xpad = jnp.pad(trace, ((0, 0), (pad_left, max(pad_right, 0))))
    blocks = xpad[:, : (nblocks + 1) * b].reshape(c, nblocks + 1, b)
    # segment i = block i plus the first (F−B) samples of block i+1
    head = blocks[:, 1:, : f - b]
    segments = jnp.concatenate([blocks[:, :-1, :], head],
                               axis=-1)                       # [C, nb, F]
    # segments are real → half-spectrum rfft/irfft (half the FFT work
    # and memory traffic of the full complex path)
    g_fft = join_complex(jnp.asarray(kernel.g_fft))
    seg_fft = dfft.rfft(segments, axis=-1)                    # [C, nb, F/2+1]
    prod = _einsum("cbf,cmf->mbf", seg_fft, g_fft)
    y_seg = dfft.irfft(prod, f, axis=-1)                      # [M, nb, F]
    # valid outputs of segment i: y_global[i·B − pad_left + nt−1 + j]
    #                            = q[i·B + j − pad_left + nt−1 − (nt−1−p)]
    # with pad_left = p this is exactly q[i·B + j] for j ∈ [0, B)
    q_blocks = y_seg[..., nt - 1: nt - 1 + b]                 # [M, nb, B]

    # zero the trace edges (first/last nt samples) and the tail padding
    col = jnp.arange(b)[None, :]
    row = jnp.arange(nblocks)[:, None]
    tpos = row * b + col                                       # [nb, B]
    lo, hi = (nt, l - nt) if valid_range is None else valid_range
    valid = (tpos >= lo) & (tpos < min(hi, l))
    return q_blocks * valid[None, :, :], valid


def of_fir(trace: jnp.ndarray, kernel: TriggerKernel,
           valid_range=None) -> jnp.ndarray:
    """Overlap-save FIR: continuous trace [C, L] → q [M, L] (flat view of
    :func:`of_fir_blocks` — prefer the block form in device pipelines).
    ``valid_range`` is forwarded (``(0, L)`` disables the edge zeroing
    when the caller owns the padding cut)."""
    l = trace.shape[-1]
    q_blocks, _ = of_fir_blocks(trace, kernel, valid_range=valid_range)
    m = q_blocks.shape[0]
    return q_blocks.reshape(m, -1)[:, :l]


def delta_chi2(q: jnp.ndarray, iw_matrix: jnp.ndarray):
    """(Δχ²(t) [L], amplitudes a(t) [M, L]) from q [M, L]."""
    amps = _einsum("ij,jt->it", iw_matrix, q)
    dchi2 = _einsum("it,it->t", amps, q)
    return dchi2, amps


def delta_chi2_blocks(q_blocks: jnp.ndarray, iw_matrix: jnp.ndarray):
    """Block-layout version: q [M, R, B] → (Δχ² [R, B], amps [M, R, B])."""
    amps = _einsum("ij,jrb->irb", iw_matrix, q_blocks)
    dchi2 = _einsum("irb,irb->rb", amps, q_blocks)
    return dchi2, amps


def delta_chi2_from_q(q_blocks: jnp.ndarray, iw_matrix: jnp.ndarray):
    """Δχ²(t) = q(t)ᵀW⁻¹q(t) [R, B] WITHOUT materializing the amplitude
    series (pair with ``find_triggers_tiled(..., amps_transform=iw)``:
    amplitudes are reconstructed only at the ≤K winner samples)."""
    return _einsum("irb,ij,jrb->rb", q_blocks, iw_matrix, q_blocks)


class TriggerSet(NamedTuple):
    """Fixed-capacity trigger list (mask-compacted on host)."""

    indices: jnp.ndarray      # [K] int32, -1 = empty slot
    dchi2: jnp.ndarray        # [K]
    amplitudes: jnp.ndarray   # [M, K]
    count: jnp.ndarray        # scalar int32 — valid entries (≤ capacity)
    count_total: jnp.ndarray  # scalar int32 — merged groups found; if
                              # > count the capacity truncated the output
    n_above: Optional[jnp.ndarray] = None
                              # scalar int32 (dynamic kernel only):
                              # candidate units consumed — above-threshold
                              # SAMPLES with premerge_window=0, pre-merged
                              # RUNS of them when the pre-merge engages
                              # (the default); if it exceeds the kernel's
                              # candidate_capacity, later candidates were
                              # DROPPED and winners may be wrong — raise
                              # candidate_capacity


def _seg_cummax_rows(x: jnp.ndarray, reset: jnp.ndarray):
    """Segmented running max along rows of a 2-D array with cross-row
    carry (row-major global order): positions where ``reset`` is True
    start a new segment. Returns the prefix max within each segment.

    Implemented as a hand-rolled Hillis–Steele doubling scan: each step
    is a shifted elementwise max/where, which XLA fuses into a handful of
    full-bandwidth passes (lax.associative_scan with a (value, flag)
    tuple carrier lowers to a tree of dynamic-slice gathers instead).
    Combine is (m1,s1)⊕(m2,s2) = (s2 ? m2 : max(m1,m2), s1|s2) with
    identity (-inf, False).
    """
    neg = jnp.asarray(-jnp.inf, x.dtype)
    r, b = x.shape
    m, s = x, reset
    k = 1
    while k < b:
        m_sh = jnp.pad(m, ((0, 0), (k, 0)),
                       constant_values=-jnp.inf)[:, :b]
        s_sh = jnp.pad(s, ((0, 0), (k, 0)), constant_values=False)[:, :b]
        m = jnp.where(s, m, jnp.maximum(m, m_sh))
        s = s | s_sh
        k *= 2
    # cross-row carry over the R row-end states (tiny)
    mm, ss = m[:, -1], s[:, -1]
    k = 1
    while k < r:
        mm_sh = jnp.pad(mm, (k, 0), constant_values=-jnp.inf)[:r]
        ss_sh = jnp.pad(ss, (k, 0), constant_values=False)[:r]
        mm = jnp.where(ss, mm, jnp.maximum(mm, mm_sh))
        ss = ss | ss_sh
        k *= 2
    m_carry = jnp.concatenate([jnp.full((1,), neg, x.dtype), mm[:-1]])
    return jnp.where(s, m, jnp.maximum(m_carry[:, None], m))


def _prev_above_index(t: jnp.ndarray, above: jnp.ndarray):
    """Exclusive running max of above-sample indices (2-D, row-major).
    Hillis–Steele doubling (see _seg_cummax_rows for why not
    lax.associative_scan)."""
    r, b = t.shape
    m = jnp.where(above, t, -1)
    k = 1
    while k < b:
        m = jnp.maximum(m, jnp.pad(m, ((0, 0), (k, 0)),
                                   constant_values=-1)[:, :b])
        k *= 2
    ends = m[:, -1]
    k = 1
    while k < r:
        ends = jnp.maximum(ends, jnp.pad(ends, (k, 0),
                                         constant_values=-1)[:r])
        k *= 2
    carry = jnp.concatenate([jnp.full((1,), -1, t.dtype), ends[:-1]])
    incl = jnp.maximum(m, carry[:, None])
    # exclusive: shift right along the flattened (row-major) order; the
    # first element of each row inherits the previous rows' carry
    return jnp.concatenate([carry[:, None], incl[:, :-1]], axis=1)


def _retile_rows(dchi2: jnp.ndarray, amps: jnp.ndarray, tile: int = 256):
    """Reshape [R, B]/[M, R, B] to narrow ``tile``-sample rows (row-major
    flat order — and therefore global indices and merge semantics — are
    unchanged). Narrow rows cut the doubling-scan pass count to
    log2(tile) and shrink the per-row winner compaction."""
    m = amps.shape[0]
    r0, b0 = dchi2.shape
    if b0 > tile and (r0 * b0) % tile == 0:
        dchi2 = dchi2.reshape(r0 * b0 // tile, tile)
        amps = amps.reshape(m, r0 * b0 // tile, tile)
    return dchi2, amps


def _compact_winners(winner: jnp.ndarray, dchi2: jnp.ndarray,
                     amps: jnp.ndarray, threshold: float,
                     pileup_window: int, capacity: int,
                     winners_per_row: Optional[int], t_offset):
    """Compact the sparse winner flags [R, B] into a fixed-capacity,
    index-sorted list.

    Default path: winners of distinct merged groups are > pileup_window
    ≥ g−1 samples apart, so a per-group max+argmax over g ≤ window+1
    sample groups compacts exactly and is ~8× cheaper than lax.top_k.
    An explicit ``winners_per_row`` opts into the top-k path with that k
    (trading pathological dense-regime capacity for speed).

    Returns (indices, vals, amps_out, n_valid); ``t_offset`` shifts the
    reported indices to global coordinates (sharded path).
    """
    r, b = dchi2.shape
    m = amps.shape[0]
    row = jnp.arange(r, dtype=jnp.int32)[:, None]
    wd = jnp.where(winner, dchi2, -jnp.inf)
    g = 1 << int(np.floor(np.log2(max(pileup_window, 0) + 1)))
    g = min(g, b)
    if winners_per_row is None and g >= 32 and b % g == 0:
        ng = b // g
        wg = wd.reshape(r, ng, g)
        vals = jnp.max(wg, axis=-1)                       # [R, ng]
        loc = jnp.argmax(wg, axis=-1).astype(jnp.int32)
        cols = jnp.arange(ng, dtype=jnp.int32)[None, :] * g + loc
    else:
        if winners_per_row is None:
            winners_per_row = b // (max(pileup_window, 0) + 1) + 2
        kk = min(winners_per_row, b)
        vals, cols = jax.lax.top_k(wd, kk)                # [R, k]
    gidx = (row * b + cols).astype(jnp.int32) + t_offset
    ok = jnp.isfinite(vals) & (vals > threshold)
    amp_cand = jnp.take_along_axis(amps, cols[None, :, :], axis=-1)

    big = jnp.int32(np.iinfo(np.int32).max)
    flat_idx = jnp.where(ok, gidx, big).reshape(-1)
    flat_val = jnp.where(ok, vals, 0.0).reshape(-1)
    flat_amp = jnp.where(ok[None], amp_cand, 0.0).reshape(m, -1)
    order = jnp.argsort(flat_idx)[:capacity]
    sidx = flat_idx[order]
    valid = sidx < big
    return (jnp.where(valid, sidx, -1),
            jnp.where(valid, flat_val[order], 0.0),
            jnp.where(valid[None, :], flat_amp[:, order], 0.0),
            jnp.sum(valid.astype(jnp.int32)))


def _seg_cummax_1d(x: jnp.ndarray, reset: jnp.ndarray) -> jnp.ndarray:
    """Segmented inclusive prefix max on small 1-D summary arrays
    (Hillis–Steele doubling; arrays here are L/G elements — KBs, so the
    log2 passes cost nothing against HBM)."""
    n = x.shape[0]
    m, s = x, reset
    k = 1
    while k < n:
        m_sh = jnp.pad(m, (k, 0), constant_values=-jnp.inf)[:n]
        s_sh = jnp.pad(s, (k, 0), constant_values=False)[:n]
        m = jnp.where(s, m, jnp.maximum(m, m_sh))
        s = s | s_sh
        k *= 2
    return m


def _excl_runmax_1d(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive running max of a small 1-D int array (identity −1)."""
    n = x.shape[0]
    m = x
    k = 1
    while k < n:
        m = jnp.maximum(m, jnp.pad(m, (k, 0), constant_values=-1)[:n])
        k *= 2
    return jnp.concatenate([jnp.full((1,), -1, m.dtype), m[:-1]])


def _tile_size(pileup_window: int, cap: int = 2048) -> int:
    """Largest power-of-two tile G with G − 1 ≤ pileup_window (so all
    above-threshold samples inside one tile always merge)."""
    return min(1 << int(np.floor(np.log2(max(pileup_window, 0) + 1))), cap)


def find_triggers_tiled(dchi2: jnp.ndarray, amps: jnp.ndarray,
                        threshold: float, pileup_window: int,
                        capacity: int, t_offset=0,
                        amps_transform: Optional[jnp.ndarray] = None
                        ) -> TriggerSet:
    """Two-level tiled threshold + pileup merge — the bandwidth rewrite of
    the segmented scan.

    The flat-scan path (:func:`_seg_cummax_rows` et al.) re-reads the
    full [L]-sample arrays log2(256)=8 times for each of three doubling
    scans — ~3 GB of HBM traffic per 10 Msamples. This path exploits the
    merge radius: with tile size G = 2^⌊log2(window+1)⌋, any two
    above-threshold samples in the same G-tile are ≤ G−1 ≤ window apart
    and therefore ALWAYS in one merged group. One fused full-bandwidth
    pass over [L/G, G] then reduces each tile to a summary (max Δχ²,
    argmax, first/last above-sample index), and the entire segmented
    merge — gap chaining, group max, first-achiever winner — runs on the
    [L/G] summary vectors (KBs instead of MBs). HBM traffic drops to
    ~1 read of Δχ² + the [M] amplitude gather: ~10× less than the flat
    path.

    Semantics are identical to :func:`find_triggers_blocks`
    (oftrigger.py:29-74 merge, first-sample-achieving-max winner);
    the property test drives both paths against the numpy oracle.

    ``amps_transform`` (optional [M, M']): when given, ``amps`` is the
    RAW filter output q [M', R, B] and the per-trigger amplitudes are
    ``amps_transform @ q[:, winner]`` — the full [M, L] amplitude array
    a(t) = W⁻¹q(t) is then never materialized in HBM (only Δχ² and the
    K gathered columns), saving a full write+read of the trace-length
    amplitude series.
    """
    r0, b0 = dchi2.shape
    m = amps.shape[0]
    l = r0 * b0
    g = _tile_size(pileup_window)
    # pad (statically) to a tile multiple with below-threshold samples —
    # they can never go above threshold, so they never trigger or merge
    pad = (-l) % g
    d_flat = dchi2.reshape(-1)
    a_flat = amps.reshape(m, -1)
    if pad:
        d_flat = jnp.pad(d_flat, (0, pad), constant_values=-jnp.inf)
        a_flat = jnp.pad(a_flat, ((0, 0), (0, pad)))
    nt = (l + pad) // g
    d = d_flat.reshape(nt, g)
    a = a_flat.reshape(m, nt, g)

    # --- one fused pass: per-tile summaries -------------------------------
    col = jnp.arange(g, dtype=jnp.int32)[None, :]
    above = d > threshold
    d_eff = jnp.where(above, d, -jnp.inf)
    tile_max = jnp.max(d_eff, axis=-1)                        # [T]
    tile_arg = jnp.argmax(d_eff, axis=-1).astype(jnp.int32)   # [T]
    first_in = jnp.min(jnp.where(above, col, g), axis=-1)
    last_in = jnp.max(jnp.where(above, col, -1), axis=-1)
    has = last_in >= 0
    base = jnp.arange(nt, dtype=jnp.int32) * g
    first_idx = base + first_in
    last_idx = jnp.where(has, base + last_in, -1)

    # --- tile-level segmented merge (small arrays) ------------------------
    prev_last = _excl_runmax_1d(last_idx)
    start = has & ((prev_last < 0)
                   | (first_idx - prev_last > pileup_window))
    fwd = _seg_cummax_1d(tile_max, start)
    nxt_reset = jnp.concatenate([start[1:], jnp.ones((1,), bool)])
    bwd = jnp.flip(_seg_cummax_1d(jnp.flip(tile_max),
                                  jnp.flip(nxt_reset)))
    total = jnp.maximum(fwd, bwd)
    prevfwd = jnp.concatenate(
        [jnp.full((1,), -jnp.inf, fwd.dtype), fwd[:-1]])
    winner = has & (tile_max == total) & (start | (prevfwd < tile_max))
    count_total = jnp.sum(start.astype(jnp.int32))

    # --- candidate gather + fixed-capacity compaction ---------------------
    cand_idx = base + tile_arg + t_offset
    cand_amp = jnp.take_along_axis(
        a, tile_arg[None, :, None], axis=-1)[..., 0]          # [M, T]
    if amps_transform is not None:
        cand_amp = _einsum("ij,jt->it", jnp.asarray(amps_transform),
                           cand_amp)
    big = jnp.int32(np.iinfo(np.int32).max)
    flat_idx = jnp.where(winner, cand_idx, big)
    flat_val = jnp.where(winner, tile_max, 0.0)
    order = jnp.argsort(flat_idx)[:capacity]
    sidx = flat_idx[order]
    valid = sidx < big
    n_valid = jnp.sum(valid.astype(jnp.int32))
    return TriggerSet(
        indices=jnp.where(valid, sidx, -1),
        dchi2=jnp.where(valid, flat_val[order], 0.0),
        amplitudes=jnp.where(valid[None, :], cand_amp[:, order], 0.0),
        count=jnp.minimum(count_total, n_valid),
        count_total=count_total,
    )


def find_triggers_blocks(dchi2: jnp.ndarray, amps: jnp.ndarray,
                         threshold: float, pileup_window: int,
                         capacity: int,
                         winners_per_row: Optional[int] = None) -> TriggerSet:
    """Threshold + pileup merge on block-layout inputs, fixed capacity.

    dchi2 [R, B], amps [M, R, B] (row-major time order, t = r·B + b).
    Above-threshold samples with successive gaps ≤ pileup_window form one
    trigger at their max-Δχ² sample (_getchangeslessthanthresh semantics,
    oftrigger.py:29-74, :996-1019).

    Dispatch: when the pileup window admits tiles of ≥ 8 samples, the
    two-level tiled path (:func:`find_triggers_tiled`) runs in ~one HBM
    pass; otherwise the flat 2-D segmented-scan path below (parallel
    across 256-sample rows with cross-row carries).
    """
    g = _tile_size(pileup_window)
    if winners_per_row is None and g >= 8:
        return find_triggers_tiled(dchi2, amps, threshold, pileup_window,
                                   capacity)
    dchi2, amps = _retile_rows(dchi2, amps)
    r, b = dchi2.shape
    col = jnp.arange(b, dtype=jnp.int32)[None, :]
    row = jnp.arange(r, dtype=jnp.int32)[:, None]
    t = row * b + col

    above = dchi2 > threshold
    prev_excl = _prev_above_index(t, above)
    gap = t - prev_excl
    start = above & ((prev_excl < 0) | (gap > pileup_window))

    # segment = one merged trigger group, delimited by the start flags;
    # below-threshold samples inside/between groups carry -inf so they
    # never win and never affect the segment maxima
    d_eff = jnp.where(above, dchi2, -jnp.inf)
    fwd = _seg_cummax_rows(d_eff, start)
    # suffix max within segment: same scan on the time-reversed arrays
    # (reversed segment boundaries = original segment ENDS, i.e. the
    # element right before the next start)
    nxt_reset = jnp.concatenate(
        [start.reshape(-1)[1:], jnp.ones((1,), bool)]).reshape(r, b)
    rev = lambda a: jnp.flip(jnp.flip(a, axis=1), axis=0)
    bwd = rev(_seg_cummax_rows(rev(d_eff), rev(nxt_reset)))
    total = jnp.maximum(fwd, bwd)

    # first sample achieving the segment max
    prevfwd = jnp.concatenate(
        [jnp.full((1,), -jnp.inf, fwd.dtype),
         fwd.reshape(-1)[:-1]]).reshape(r, b)
    winner = above & (dchi2 == total) & (start | (prevfwd < dchi2))

    count_total = jnp.sum(start.astype(jnp.int32))

    idx_out, val_out, amp_out, n_valid = _compact_winners(
        winner, dchi2, amps, threshold, pileup_window, capacity,
        winners_per_row, jnp.int32(0))
    return TriggerSet(
        indices=idx_out,
        dchi2=val_out,
        amplitudes=amp_out,
        count=jnp.minimum(count_total, n_valid),
        count_total=count_total,
    )


def find_triggers_kernel(dchi2: jnp.ndarray, amps: jnp.ndarray,
                         threshold: float, pileup_window: int,
                         capacity: int,
                         winners_per_row: Optional[int] = None
                         ) -> TriggerSet:
    """Flat-input wrapper around :func:`find_triggers_blocks`
    (dchi2 [L], amps [M, L]); pads to a block multiple internally."""
    l = dchi2.shape[-1]
    b = 16384 if l >= 16384 else int(2 ** np.ceil(np.log2(max(l, 256))))
    pad = (-l) % b
    if pad:
        dchi2 = jnp.pad(dchi2, (0, pad), constant_values=-jnp.inf)
        amps = jnp.pad(amps, ((0, 0), (0, pad)))
    r = dchi2.shape[-1] // b
    return find_triggers_blocks(dchi2.reshape(r, b),
                                amps.reshape(amps.shape[0], r, b),
                                threshold, pileup_window, capacity,
                                winners_per_row=winners_per_row)


def find_triggers_sharded_tiled(dchi2: jnp.ndarray, amps: jnp.ndarray,
                                threshold: float, pileup_window: int,
                                capacity: int, t_offset, axis_name: str,
                                n_shards: int) -> TriggerSet:
    """Two-level tiled trigger merge on ONE time-shard of a long trace —
    the cross-shard counterpart of :func:`find_triggers_tiled`.

    Identical carry structure to :func:`find_triggers_sharded` (exclusive
    prefix max of last-above indices; (value, any-reset) combines for the
    forward/backward segmented maxima; ppermute of the right neighbour's
    first reset flag) but applied to L/G-element TILE summaries instead
    of full sample arrays: shards exchange the same handful of scalars
    while the per-shard work drops to one fused pass over the samples.
    Requires the shard length to be a multiple of the tile size G (true
    for power-of-two block layouts; the dispatcher checks).

    Winner-uniqueness argument is unchanged: every shard sees the same
    segment structure through the carries, and exactly one tile achieves
    a segment's maximum first (ties resolve to the earliest global
    position because in-tile argmax takes the first maximum and the
    first-achiever rule compares against the carried prefix max).
    """
    r, b = dchi2.shape
    m = amps.shape[0]
    l = r * b
    g = _tile_size(pileup_window)
    nt = l // g
    d = dchi2.reshape(nt, g)
    a = amps.reshape(m, nt, g)
    idx = jax.lax.axis_index(axis_name)
    neg = jnp.asarray(-jnp.inf, dchi2.dtype)

    # --- one fused pass: per-tile summaries (global indices) --------------
    col = jnp.arange(g, dtype=jnp.int32)[None, :]
    above = d > threshold
    d_eff = jnp.where(above, d, neg)
    tile_max = jnp.max(d_eff, axis=-1)                        # [T]
    tile_arg = jnp.argmax(d_eff, axis=-1).astype(jnp.int32)
    first_in = jnp.min(jnp.where(above, col, g), axis=-1)
    last_in = jnp.max(jnp.where(above, col, -1), axis=-1)
    has = last_in >= 0
    base = jnp.arange(nt, dtype=jnp.int32) * g + t_offset
    first_idx = base + first_in
    last_idx = jnp.where(has, base + last_in, -1)

    # --- cross-shard previous-above carry ---------------------------------
    local_prev = _excl_runmax_1d(last_idx)
    ga = jax.lax.all_gather(jnp.max(last_idx), axis_name)
    run = jax.lax.cummax(ga, axis=0)
    carry_prev = jnp.concatenate(
        [jnp.full((1,), -1, run.dtype), run[:-1]])[idx]
    prev_last = jnp.maximum(local_prev, carry_prev)
    start = has & ((prev_last < 0)
                   | (first_idx - prev_last > pileup_window))

    # --- forward segmented max with cross-shard carry ---------------------
    fwd = _seg_cummax_1d(tile_max, start)
    gm = jax.lax.all_gather(fwd[-1], axis_name)
    gs = jax.lax.all_gather(jnp.any(start), axis_name)
    cm = [neg]
    for i in range(n_shards - 1):
        cm.append(jnp.where(gs[i], gm[i], jnp.maximum(cm[-1], gm[i])))
    carry_m = jnp.stack(cm)[idx]
    before_first_start = jnp.cumsum(start.astype(jnp.int32)) == 0
    fwd = jnp.where(before_first_start, jnp.maximum(fwd, carry_m), fwd)

    # --- backward segmented max (resets at segment ends) ------------------
    from_right = jax.lax.ppermute(
        start[:1].astype(jnp.int32), axis_name,
        [(i + 1, i) for i in range(n_shards - 1)])
    last_next = jnp.where(idx == n_shards - 1, 1, from_right[0])
    nxt_reset = jnp.concatenate([start[1:], (last_next > 0)[None]])
    bwd_rev = _seg_cummax_1d(jnp.flip(tile_max), jnp.flip(nxt_reset))
    gmr = jax.lax.all_gather(bwd_rev[-1], axis_name)
    gsr = jax.lax.all_gather(jnp.any(nxt_reset), axis_name)
    cmr = [neg]
    for i in range(n_shards - 1, 0, -1):
        cmr.append(jnp.where(gsr[i], gmr[i], jnp.maximum(cmr[-1], gmr[i])))
    carry_mr = jnp.stack(cmr[::-1])[idx]
    before_first_rev = jnp.cumsum(
        jnp.flip(nxt_reset).astype(jnp.int32)) == 0
    bwd_rev = jnp.where(before_first_rev, jnp.maximum(bwd_rev, carry_mr),
                        bwd_rev)
    bwd = jnp.flip(bwd_rev)
    total = jnp.maximum(fwd, bwd)

    # --- first-achiever winner + per-shard compaction ---------------------
    prevfwd = jnp.concatenate([carry_m[None], fwd[:-1]])
    winner = has & (tile_max == total) & (start | (prevfwd < tile_max))
    count_total = jax.lax.psum(jnp.sum(start.astype(jnp.int32)),
                               axis_name)

    cand_idx = base + tile_arg
    cand_amp = jnp.take_along_axis(
        a, tile_arg[None, :, None], axis=-1)[..., 0]          # [M, T]
    big = jnp.int32(np.iinfo(np.int32).max)
    flat_idx = jnp.where(winner, cand_idx, big)
    flat_val = jnp.where(winner, tile_max, 0.0)
    order = jnp.argsort(flat_idx)[:capacity]
    sidx = flat_idx[order]
    valid = sidx < big
    return TriggerSet(
        indices=jnp.where(valid, sidx, -1),
        dchi2=jnp.where(valid, flat_val[order], 0.0),
        amplitudes=jnp.where(valid[None, :], cand_amp[:, order], 0.0),
        count=jnp.sum(valid.astype(jnp.int32)),
        count_total=count_total,
    )


def find_triggers_sharded(dchi2: jnp.ndarray, amps: jnp.ndarray,
                          threshold: float, pileup_window: int,
                          capacity: int, t_offset, axis_name: str,
                          n_shards: int) -> TriggerSet:
    """Exact trigger finding on ONE time-shard of a long continuous trace.

    Runs inside shard_map (parallel/mesh.py::sharded_longtrace_trigger):
    each shard holds dchi2 [R, B] / amps [M, R, B] for a contiguous global
    sample range starting at ``t_offset``. The segmented-scan carries that
    :func:`find_triggers_blocks` propagates across block rows are here
    *also* propagated across shards: per-shard scan end-states are
    all_gather-ed (a handful of scalars), combined into exclusive
    prefix/suffix carries with a static loop over the shard count, and
    applied to the positions before the shard's first segment boundary.
    Merged pileup groups straddling shard boundaries therefore resolve to
    exactly one winner globally — the output equals the unsharded kernel
    on the gathered trace (tests/test_longtrace_sharded.py). This is the
    long-trace sharding design addition of SURVEY.md §5 (the reference
    always processes traces whole, oftrigger.py:659-664); the halo = one
    template length, exchanged by the FIR wrapper.

    Indices are global int32 (traces < 2^31 samples). Winners are
    compacted per shard with ``capacity`` slots each.

    Dispatch: tileable pileup windows (G ≥ 8, shard length divisible)
    use the two-level tiled variant
    (:func:`find_triggers_sharded_tiled`) — same carries, one fused
    sample pass instead of three full doubling scans per shard.
    """
    g = _tile_size(pileup_window)
    if g >= 8 and (dchi2.shape[0] * dchi2.shape[1]) % g == 0:
        return find_triggers_sharded_tiled(
            dchi2, amps, threshold, pileup_window, capacity, t_offset,
            axis_name, n_shards)
    dchi2, amps = _retile_rows(dchi2, amps)
    r, b = dchi2.shape
    col = jnp.arange(b, dtype=jnp.int32)[None, :]
    row = jnp.arange(r, dtype=jnp.int32)[:, None]
    t = row * b + col + t_offset                       # GLOBAL indices
    idx = jax.lax.axis_index(axis_name)
    neg = jnp.asarray(-jnp.inf, dchi2.dtype)

    above = dchi2 > threshold
    prev_local = _prev_above_index(t, above)
    # cross-shard carry for "previous above-sample index": exclusive
    # prefix max of per-shard maxima
    local_max_above = jnp.max(jnp.where(above, t, -1))
    ga = jax.lax.all_gather(local_max_above, axis_name)          # [D]
    run = jax.lax.cummax(ga, axis=0)
    carry_prev = jnp.concatenate(
        [jnp.full((1,), -1, run.dtype), run[:-1]])[idx]
    prev_excl = jnp.where(prev_local < 0, carry_prev, prev_local)
    gap = t - prev_excl
    start = above & ((prev_excl < 0) | (gap > pileup_window))

    d_eff = jnp.where(above, dchi2, neg)
    fwd = _seg_cummax_rows(d_eff, start)
    # forward carry: exclusive prefix combine of (end value, any reset)
    gm = jax.lax.all_gather(fwd[-1, -1], axis_name)
    gs = jax.lax.all_gather(jnp.any(start), axis_name)
    cm = [neg]
    for i in range(n_shards - 1):
        cm.append(jnp.where(gs[i], gm[i], jnp.maximum(cm[-1], gm[i])))
    carry_m = jnp.stack(cm)[idx]
    # the carry applies to positions before the shard's first start flag
    cum_start = _seg_cummax_rows(start.astype(dchi2.dtype),
                                 jnp.zeros_like(start))
    fwd = jnp.where(cum_start > 0, fwd, jnp.maximum(fwd, carry_m))

    # segment ENDS: next global position's start flag; the last shard's
    # final position ends its segment by definition
    start_flat = start.reshape(-1)
    from_right = jax.lax.ppermute(
        start_flat[:1].astype(jnp.int32), axis_name,
        [(i + 1, i) for i in range(n_shards - 1)])
    last_next = jnp.where(idx == n_shards - 1, 1, from_right[0])
    nxt_reset = jnp.concatenate(
        [start_flat[1:], (last_next > 0)[None]]).reshape(r, b)

    rev = lambda a: jnp.flip(jnp.flip(a, axis=1), axis=0)
    bwd_rev = _seg_cummax_rows(rev(d_eff), rev(nxt_reset))
    gmr = jax.lax.all_gather(bwd_rev[-1, -1], axis_name)
    gsr = jax.lax.all_gather(jnp.any(nxt_reset), axis_name)
    cmr = [neg]
    for i in range(n_shards - 1, 0, -1):
        cmr.append(jnp.where(gsr[i], gmr[i], jnp.maximum(cmr[-1], gmr[i])))
    carry_mr = jnp.stack(cmr[::-1])[idx]
    cum_nxt_rev = _seg_cummax_rows(rev(nxt_reset).astype(dchi2.dtype),
                                   jnp.zeros_like(start))
    bwd_rev = jnp.where(cum_nxt_rev > 0, bwd_rev,
                        jnp.maximum(bwd_rev, carry_mr))
    bwd = rev(bwd_rev)
    total = jnp.maximum(fwd, bwd)

    # first-achiever rule: the previous global position's fwd value; for
    # the shard's first position that is the left shard's fixed end = the
    # exclusive forward carry
    prevfwd = jnp.concatenate(
        [carry_m[None], fwd.reshape(-1)[:-1]]).reshape(r, b)
    winner = above & (dchi2 == total) & (start | (prevfwd < dchi2))
    count_total = jax.lax.psum(jnp.sum(start.astype(jnp.int32)),
                               axis_name)

    # per-shard winner compaction (winners are globally unique, so shard
    # outputs concatenate without dedup)
    idx_out, val_out, amp_out, n_valid = _compact_winners(
        winner, dchi2, amps, threshold, pileup_window, capacity,
        None, t_offset)
    return TriggerSet(
        indices=idx_out,
        dchi2=val_out,
        amplitudes=amp_out,
        count=n_valid,
        count_total=count_total,
    )


def _compact_above(dchi2: jnp.ndarray, threshold: float,
                   candidate_capacity: int, tile: int = 512):
    """First-K above-threshold samples (index AND value) in time order.

    The obvious compaction (``jnp.sort`` of index-or-sentinel keys) costs
    a full [L]-element sort. This version is GATHER-FREE: per-tile above
    counts (one bandwidth pass), the tile of the s-th candidate by a
    broadcast compare-sum against the tiny [T] count prefix, tile rows
    fetched by a one-hot [K, T]×[T, G] matmul (0/1 values — exact at
    any precision; the value rows ride the HIGHEST-precision einsum,
    f32-exact), and the in-tile rank resolved by a row cumsum + one-hot
    select.

    Returns (cand_idx int32 [K] with sentinel l, cand_val [K] with
    sentinel −inf, valid bool [K], n_above int32).
    """
    l = dchi2.shape[-1]
    pad = (-l) % tile
    # pad with zeros, NOT -inf: the one-hot row fetch below is a matmul,
    # and 0 x (-inf) = NaN would poison every fetched row whose in-tile
    # column also exists in the final (padded) tile
    d = jnp.pad(dchi2, (0, pad)) if pad else dchi2
    d2 = d.reshape(-1, tile)                              # [T, G]
    at = d2 > threshold
    if pad:
        # mask the pad tail out of the above-mask (iota, no HBM pass)
        at = at & (jnp.arange(d.shape[-1]).reshape(-1, tile) < l)
    t = at.shape[0]
    cnt = jnp.sum(at, axis=-1, dtype=jnp.int32)           # [T] (tiny)
    ccum = jnp.cumsum(cnt)                                # inclusive
    n_above = ccum[-1]
    targets = jnp.arange(1, candidate_capacity + 1, dtype=jnp.int32)
    # tile of the s-th above sample: first t with ccum[t] ≥ s+1, i.e.
    # #(ccum < s+1) — a [K, T] broadcast compare, no searchsorted gathers
    t_idx = jnp.sum((ccum[None, :] < targets[:, None]).astype(jnp.int32),
                    axis=-1)
    t_idx = jnp.clip(t_idx, 0, t - 1)
    tiles = jnp.arange(t, dtype=jnp.int32)
    onehot_t = (t_idx[:, None] == tiles[None, :])         # [K, T]
    # above-count in tiles strictly before t_idx → 1-based in-tile rank
    before = jnp.sum(jnp.where(tiles[None, :] < t_idx[:, None],
                               cnt[None, :], 0), axis=-1)
    # counting arithmetic runs in f32 REGARDLESS of the data dtype:
    # bf16 cannot represent odd integers above 256, so a bf16 rank /
    # cumsum would match zero or multiple positions (silent corruption)
    cdt = jnp.float32
    rank = (targets - before).astype(cdt)
    oh = onehot_t.astype(cdt)
    rows_a = jnp.einsum("kt,tg->kg", oh, at.astype(cdt),
                        precision=jax.lax.Precision.DEFAULT)  # 0/1 exact
    rows_d = _einsum("kt,tg->kg", oh, d2)   # value upcast is exact
    rc = jnp.cumsum(rows_a, axis=-1)
    # the rank-th above sample in the row: first position that is above
    # AND whose running count equals rank (counts ≤ G are f32-exact)
    hit = (rc == rank[:, None]) & (rows_a > 0.5)
    pos = jnp.argmax(hit, axis=-1).astype(jnp.int32)
    cand_idx = t_idx * tile + pos
    cand_val = jnp.sum(jnp.where(hit, rows_d, 0.0),
                       axis=-1).astype(dchi2.dtype)
    valid = targets <= n_above
    return (jnp.where(valid, cand_idx, l),
            jnp.where(valid, cand_val, -jnp.inf), valid, n_above)


def _static_premerge_window(window_fn, threshold) -> int:
    """floor(window_fn(threshold)) when it is statically known, else 0.

    The pre-merge reduction below is only valid (and only buildable —
    the tile size is a shape) for a static minimum window; a traced
    threshold or a window_fn closing over traced values disables it.
    """
    if isinstance(threshold, jax.core.Tracer):
        return 0
    try:
        # escape any enclosing jit trace: ops on concrete values must
        # evaluate NOW (inside jit even constants stage as tracers);
        # pass an array, not a float — traceable window_fns may use
        # array methods (.clip etc.) the scan would also hand them
        with jax.ensure_compile_time_eval():
            w = window_fn(jnp.asarray(threshold))
        if isinstance(w, jax.core.Tracer):
            return 0       # window_fn closes over traced values
        return int(np.floor(float(w)))
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError, TypeError, ValueError,
            AttributeError):
        return 0


def _premerge_candidates(dchi2: jnp.ndarray, threshold: float, w0: int,
                         kpg: int):
    """Compress above-threshold samples into runs that PROVABLY merge.

    For a monotonic non-decreasing ``window_fn``, any two successive
    above-threshold samples with gap ≤ w0 = window_fn(threshold) always
    end up in one dynamic group: the running probe max is ≥ threshold,
    so the merge window is ≥ window_fn(threshold) ≥ gap. Pre-merging
    those runs (the STATIC merge with window w0) turns the dynamic
    scan's candidate units from samples into runs — a high-SNR pulse
    whose Δχ² bump is thousands of samples wide becomes ONE candidate,
    so ``candidate_capacity`` counts pulses, not samples.

    Per run the dynamic scan needs exactly: the first sample's index and
    value (the reference loop decides the boundary split at the run's
    FIRST sample), the last sample's index (the next boundary's gap),
    the run max (the carry update), and the first sample achieving that
    max (the winner). All five reduce tile-by-tile exactly like
    :func:`find_triggers_tiled`.

    Returns (first_idx, last_idx, first_val, max_v, win_idx, valid,
    n_runs) — [kpg] arrays in time order, sentinel l / −inf past
    ``n_runs``; runs beyond kpg are DROPPED (callers compare n_runs to
    the capacity).
    """
    l = dchi2.shape[-1]
    g = _tile_size(w0)
    pad = (-l) % g
    d_flat = (jnp.pad(dchi2, (0, pad), constant_values=-jnp.inf)
              if pad else dchi2)
    nt_ = (l + pad) // g
    d = d_flat.reshape(nt_, g)
    col = jnp.arange(g, dtype=jnp.int32)[None, :]
    above = d > threshold
    d_eff = jnp.where(above, d, -jnp.inf)
    tile_max = jnp.max(d_eff, axis=-1)                        # [T]
    tile_arg = jnp.argmax(d_eff, axis=-1).astype(jnp.int32)   # first max
    first_in = jnp.min(jnp.where(above, col, g), axis=-1)
    last_in = jnp.max(jnp.where(above, col, -1), axis=-1)
    has = last_in >= 0
    # value at the tile's first above sample (one-hot select, no gather)
    tile_first_val = jnp.sum(
        jnp.where(col == first_in[:, None], d_eff, 0.0), axis=-1)
    base = jnp.arange(nt_, dtype=jnp.int32) * g
    first_idx = base + first_in
    last_idx = jnp.where(has, base + last_in, -1)

    # tile-level static merge with window w0 (find_triggers_tiled form)
    prev_last = _excl_runmax_1d(last_idx)
    start = has & ((prev_last < 0) | (first_idx - prev_last > w0))
    gid = jnp.cumsum(start.astype(jnp.int32)) - 1
    n_runs = jnp.sum(start.astype(jnp.int32))
    ok = has & (gid >= 0) & (gid < kpg)
    seg = jnp.clip(gid, 0, kpg - 1)
    big = jnp.int32(np.iinfo(np.int32).max)
    tile_no = jnp.arange(nt_, dtype=jnp.int32)
    pg_max = jax.ops.segment_max(jnp.where(ok, tile_max, -jnp.inf), seg,
                                 num_segments=kpg)
    achieves = ok & (tile_max == pg_max[seg])
    wt = jax.ops.segment_min(jnp.where(achieves, tile_no, big), seg,
                             num_segments=kpg)
    ft = jax.ops.segment_min(jnp.where(ok, tile_no, big), seg,
                             num_segments=kpg)
    pg_last = jax.ops.segment_max(jnp.where(ok, last_idx, -1), seg,
                                  num_segments=kpg)
    valid = jnp.arange(kpg, dtype=jnp.int32) < n_runs
    wt_s = jnp.clip(wt, 0, nt_ - 1)
    ft_s = jnp.clip(ft, 0, nt_ - 1)
    pg_win = wt_s * g + tile_arg[wt_s]                    # [kpg] gathers
    pg_first = ft_s * g + first_in[ft_s]
    pg_first_val = tile_first_val[ft_s]
    neg = jnp.asarray(-jnp.inf, dchi2.dtype)
    return (jnp.where(valid, pg_first, l),
            jnp.where(valid, pg_last, l),
            jnp.where(valid, pg_first_val, neg),
            jnp.where(valid, pg_max, neg),
            jnp.where(valid, pg_win, l),
            valid, n_runs)


def find_triggers_dynamic_kernel(dchi2: jnp.ndarray, amps: jnp.ndarray,
                                 threshold: float, window_fn,
                                 capacity: int,
                                 candidate_capacity: int = 4096,
                                 amps_transform: Optional[jnp.ndarray]
                                 = None,
                                 premerge_window: Optional[int] = None):
    """Dynamic-pileup-window triggering ON DEVICE.

    Device counterpart of :func:`find_triggers_dynamic` (the reference's
    ``dynamic=True`` mode, oftrigger.py:78-142): the merge window
    between successive above-threshold samples is ``window_fn(m)`` of the
    running maximum Δχ² of the current group — including the candidate
    being considered, matching the reference loop. ``window_fn`` must be
    jax-traceable (scalar → scalar, in samples); use the host version
    for arbitrary Python callables.

    Structure (the round-3 rewrite; semantics unchanged, pinned by the
    host-oracle property test): candidate units compact WITHOUT a
    trace-length sort; the inherently sequential part — the split
    decisions — runs as a ``lax.scan`` whose carry is ONE scalar (the
    running group max; the previous candidate's index is data, not
    state) emitting a group-start flag per candidate; winners then come
    from a vectorized segmented max/first-achiever pass over the [K]
    candidate arrays. The scan length is ``candidate_capacity``, never
    the trace length.

    ``premerge_window``: for a MONOTONIC NON-DECREASING ``window_fn``
    (the reference's use case — wider windows for bigger pulses),
    successive above-threshold samples with gaps ≤ window_fn(threshold)
    provably always merge, so they compress EXACTLY into runs before the
    scan (:func:`_premerge_candidates`) and ``candidate_capacity``
    counts runs (≈ pulses), not samples — a high-SNR stream whose Δχ²
    bumps are thousands of samples wide no longer overflows the cap.
    Default ``None`` derives the run window from ``window_fn(threshold)``
    when that is statically known; pass ``0`` to force sample-level
    candidates (REQUIRED for a non-monotonic ``window_fn``), or an
    explicit int to override.

    ``amps_transform`` (optional [M, M']): when given, ``amps`` is the
    raw filter output q [M', L] and per-trigger amplitudes are
    ``amps_transform @ q[:, winners]`` — the trace-length amplitude
    series is never materialized (same contract as
    :func:`find_triggers_tiled`).

    Returns a :class:`TriggerSet`; ``count_total`` counts ALL merged
    groups (including those beyond ``capacity``), and ``n_above`` the
    candidate units consumed (above-threshold samples, or pre-merged
    runs when the pre-merge engages). **If n_above > candidate_capacity,
    later candidates were dropped and winners inside truncated groups
    can be wrong** — consumers must check and raise
    ``candidate_capacity`` (pipelines/triggers.py warns loudly).
    """
    l = dchi2.shape[-1]
    w0 = (_static_premerge_window(window_fn, threshold)
          if premerge_window is None else int(premerge_window))
    gaps, first_v, max_v, valid, win_idx, n_above = _dynamic_candidates(
        dchi2, threshold, w0, candidate_capacity)
    body = _dynamic_body(window_fn, dchi2.dtype)
    # NOTE: under jax.vmap, prefer find_triggers_dynamic_batched — it
    # early-exits the sequential walk with a batch-shared loop counter.
    # An early exit HERE (lax.while_loop per trace) batches into
    # per-lane gathers under vmap.
    neg = jnp.asarray(-jnp.inf, dchi2.dtype)
    _, starts = jax.lax.scan(body, neg, (gaps, first_v, max_v, valid),
                             unroll=8)
    return _dynamic_winners(starts, max_v, valid, win_idx, amps,
                            capacity, l, amps_transform, n_above)


def _dynamic_candidates(dchi2, threshold, w0, candidate_capacity):
    """Compact candidate units (pre-merged runs for w0 ≥ 8, else
    above-threshold samples) plus the gap of each unit's first sample to
    the previous unit's last sample."""
    if w0 >= 8:  # below 8 the run tiles degenerate; samples are as good
        (first_i, last_i, first_v, max_v, win_idx, valid,
         n_above) = _premerge_candidates(dchi2, threshold, w0,
                                         candidate_capacity)
    else:
        first_i, max_v, valid, n_above = _compact_above(
            dchi2, threshold, candidate_capacity)
        last_i = win_idx = first_i
        first_v = max_v
    # gap to the previous candidate's LAST sample; the first candidate
    # gets a gap no window can cover, so it always starts a group
    prev = jnp.concatenate([jnp.full((1,), jnp.int32(-(1 << 30))),
                            last_i[:-1]])
    gaps = (first_i - prev).astype(dchi2.dtype)
    return gaps, first_v, max_v, valid, win_idx, n_above


def _per_lane_window_fn(window_fn, dtype):
    """Lift a scalar→scalar ``window_fn`` to batched probes.

    The batched walk's running-max probe is [E]-shaped; calling a
    user function written against the documented scalar contract with
    it would break scalar-only primitives (``lax.cond`` raises on a
    batched predicate). Per-lane vmap keeps the contract; the
    ``+ 0·s`` term forces the output to depend on the lane input so
    constant-window functions (which return unbatched values) still
    batch. Elementwise functions lower to the same HLO either way.
    """
    def wf(m):
        if getattr(m, "ndim", 0) == 0:
            return window_fn(m)
        return jax.vmap(
            lambda s: jnp.asarray(window_fn(s), dtype) + 0 * s)(m)
    return wf


def _dynamic_body(window_fn, dtype):
    """Scan body for the sequential split walk: carry is ONE scalar per
    lane (the running group max); emits a group-start flag per unit."""
    def body(gmax, x):
        gap, fv, mv, ok = x
        # the reference loop decides each boundary at the unit's FIRST
        # sample with the window from the running max INCLUDING it
        # (oftrigger.py:_getchangeslessthandynamicthresh semantics);
        # the rest of the unit then merges unconditionally and only
        # lifts the carry to the unit max
        probe = jnp.maximum(gmax, fv)
        window = jnp.asarray(window_fn(probe), dtype)
        start = ok & (gap > window)
        neg_ = jnp.asarray(-jnp.inf, dtype)
        gmax = jnp.where(
            ok, jnp.maximum(jnp.where(start, neg_, gmax), mv), gmax)
        return gmax, start
    return body


def _dynamic_winners(starts, max_v, valid, win_idx, amps, capacity, l,
                     amps_transform, n_above):
    # winners per group, vectorized: group id = running start count;
    # group max via segment_max; winner = FIRST candidate achieving it
    # (matching the loop's strict-improvement update)
    gid = jnp.cumsum(starts.astype(jnp.int32)) - 1
    ngroups = jnp.sum(starts.astype(jnp.int32))
    in_cap = valid & (gid >= 0) & (gid < capacity)
    seg = jnp.clip(gid, 0, capacity - 1)
    val_m = jnp.where(in_cap, max_v, -jnp.inf)
    gmax_g = jax.ops.segment_max(val_m, seg, num_segments=capacity)
    big = jnp.int32(np.iinfo(np.int32).max)
    achieves = in_cap & (max_v == gmax_g[seg])
    win_i = jax.ops.segment_min(jnp.where(achieves, win_idx, big), seg,
                                num_segments=capacity)
    has_g = win_i < big
    buf_i = jnp.where(has_g, win_i, -1)
    buf_v = jnp.where(has_g, gmax_g, 0.0)
    nout = jnp.minimum(ngroups, jnp.int32(capacity))

    amp_cols = amps[:, jnp.clip(buf_i, 0, l - 1)]
    if amps_transform is not None:
        amp_cols = _einsum("ij,jk->ik", jnp.asarray(amps_transform),
                           amp_cols)
    amp_out = jnp.where(buf_i[None, :] >= 0, amp_cols, 0.0)
    return TriggerSet(indices=buf_i, dchi2=buf_v, amplitudes=amp_out,
                      count=nout, count_total=ngroups, n_above=n_above)


def find_triggers_dynamic_batched(dchi2: jnp.ndarray, amps: jnp.ndarray,
                                  threshold: float, window_fn,
                                  capacity: int,
                                  candidate_capacity: int = 4096,
                                  amps_transform: Optional[jnp.ndarray]
                                  = None,
                                  premerge_window: Optional[int] = None,
                                  block: int = 128):
    """Batched dynamic-window triggering with an early-exit walk.

    Equivalent to ``jax.vmap(find_triggers_dynamic_kernel)`` over a
    leading events axis, but the inherently sequential split-decision
    walk runs as ONE ``lax.while_loop`` whose loop counter is SHARED
    across the batch: it stops after ``ceil(max_e n_units / block)``
    blocks instead of always paying ``candidate_capacity`` steps, so at
    production trigger rates (candidates ≪ capacity) the walk all but
    vanishes. Exact — units at and beyond each lane's count carry
    ok=False, which emits start=False and leaves that lane's running max
    untouched, so never visiting them yields identical group starts
    (the flag buffer is initialized all-False). A per-lane early exit
    (while_loop under vmap) would lose: batching rewrites its dynamic
    slices into per-lane gathers, while the shared counter keeps them
    true dynamic-slice ops.

    ``dchi2``: [E, L]; ``amps``: [E, M', L]. Returns a TriggerSet of
    [E, ...]-shaped fields (the batched analog of the single-trace
    kernel's output).

    ``window_fn`` keeps the scalar→scalar contract of the single-trace
    kernel: the walk's probe is a [E] batch here, so the function is
    vmapped per lane (scalar-only primitives like ``lax.cond`` stay
    legal; elementwise functions lower to identical HLO).
    """
    e, l = dchi2.shape
    w0 = (_static_premerge_window(window_fn, threshold)
          if premerge_window is None else int(premerge_window))
    window_fn = _per_lane_window_fn(window_fn, dchi2.dtype)
    gaps, first_v, max_v, valid, win_idx, n_above = jax.vmap(
        lambda d: _dynamic_candidates(d, threshold, w0,
                                      candidate_capacity))(dchi2)
    kcap = int(gaps.shape[-1])
    blk = int(block)
    nb = -(-kcap // blk)
    pad = nb * blk - kcap
    neg = jnp.asarray(-jnp.inf, dchi2.dtype)

    def _pad(a, fill):
        if not pad:
            return a
        return jnp.concatenate(
            [a, jnp.full((e, pad), fill, a.dtype)], axis=-1)

    gaps_p = _pad(gaps, jnp.asarray(0, gaps.dtype))
    fv_p = _pad(first_v, neg)
    mv_p = _pad(max_v, neg)
    ok_p = _pad(valid, jnp.asarray(False))
    body = _dynamic_body(window_fn, dchi2.dtype)
    # n_above counts ALL units in each trace; only the first kcap were
    # kept, so the walk needs ceil(min(n_above, kcap)/blk) blocks
    n_used = jnp.minimum(n_above.astype(jnp.int32), jnp.int32(kcap))
    nb_need = jnp.max((n_used + (blk - 1)) // blk)

    def blk_cond(c):
        return c[0] < nb_need

    def blk_body(c):
        i, gmax, buf = c
        off = i * blk
        zero = jnp.zeros_like(off)
        xs = tuple(
            jnp.swapaxes(
                jax.lax.dynamic_slice(a, (zero, off), (e, blk)), 0, 1)
            for a in (gaps_p, fv_p, mv_p, ok_p))
        gmax, st = jax.lax.scan(body, gmax, xs, unroll=8)
        buf = jax.lax.dynamic_update_slice(
            buf, jnp.swapaxes(st, 0, 1), (zero, off))
        return (i + 1, gmax, buf)

    _, _, starts = jax.lax.while_loop(
        blk_cond, blk_body,
        (jnp.int32(0), jnp.full((e,), -jnp.inf, dchi2.dtype),
         jnp.zeros((e, nb * blk), bool)))
    starts = starts[:, :kcap]
    return jax.vmap(
        lambda s, mv, ok, wi, am, na: _dynamic_winners(
            s, mv, ok, wi, am, capacity, l, amps_transform, na)
    )(starts, max_v, valid, win_idx, amps, n_above)


def find_triggers_dynamic(dchi2: np.ndarray, amps: np.ndarray,
                          threshold: float, threshold_function,
                          capacity: int | None = None):
    """Host-side dynamic-pileup-window triggering.

    Equivalent of the reference's ``dynamic=True`` path
    (oftrigger.py:78-142, :982-985): the merge window between successive
    above-threshold samples is a user function of the running maximum
    amplitude in the current group — inherently sequential and
    user-code-driven, so it runs on host over the (compacted)
    above-threshold samples.

    Returns (indices, dchi2_values, amplitudes [M, K]).
    """
    dchi2 = np.asarray(dchi2)
    amps = np.asarray(amps)
    above = np.where(dchi2 > threshold)[0]
    if len(above) == 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0),
                np.zeros((amps.shape[0], 0)))
    starts = [0]
    current = 0
    for i in range(1, len(above)):
        window = threshold_function(
            float(np.max(dchi2[above[current: i + 1]])))
        if above[i] - above[i - 1] > window:
            starts.append(i)
            current = i
    starts.append(len(above))
    idx_out, d_out = [], []
    for a, b in zip(starts[:-1], starts[1:]):
        group = above[a:b]
        best = group[np.argmax(dchi2[group])]
        idx_out.append(best)
        d_out.append(dchi2[best])
        if capacity is not None and len(idx_out) >= capacity:
            break
    idx_out = np.asarray(idx_out, dtype=np.int64)
    return idx_out, np.asarray(d_out), amps[:, idx_out]


def shift_templates_to_match_chi2(fs: float, primary_template,
                                  secondary_templates, noisecsd,
                                  relative_amplitudes=None,
                                  block: int = 16384):
    """Shift secondary templates so the primary trigger peaks at the same
    time on all of them (oftrigger.py:146-259 equivalent).

    Runs the primary trigger kernel over each template rendered as a trace
    and rolls the secondaries by the Δχ²-peak offset. Returns
    (shifted_templates, shift_samples).
    """
    from detprocess_jax.ops.filterbank import (make_ofnxm_bank,
                                               _reshape_template_3d)

    primary = _reshape_template_3d(np.asarray(primary_template))
    c, m, n = primary.shape
    if relative_amplitudes is None:
        relative_amplitudes = np.ones(m)
    bank = make_ofnxm_bank(primary, np.asarray(noisecsd), fs, n // 2)
    kernel = make_trigger_kernel(bank, block=block, real_dtype=np.float64)

    def peak_time(template_3d):
        trace = np.einsum("cmn,m->cn", template_3d, relative_amplitudes)
        # embed in a longer trace so edge zeroing doesn't clip the pulse
        pad = np.zeros((c, 4 * n))
        pad[:, int(1.5 * n):int(2.5 * n)] = trace
        q = of_fir(jnp.asarray(pad), kernel)
        d, _ = delta_chi2(q, jnp.asarray(kernel.iw_matrix))
        return int(jnp.argmax(d))

    t_primary = peak_time(primary)
    shifted, shifts = [], np.zeros(len(secondary_templates), dtype=int)
    for i, sec in enumerate(secondary_templates):
        sec3 = _reshape_template_3d(np.asarray(sec))
        t_sec = peak_time(sec3)
        shifts[i] = t_primary - t_sec
        shifted.append(np.roll(sec3, shifts[i], axis=-1))
    return shifted, shifts


def saturation_mask(lpf_trace: jnp.ndarray, sat_amplitudes,
                    window: int, positive_pulses: bool = True) -> jnp.ndarray:
    """Per-sample saturation flag: any channel's LPF trace beyond its
    saturation amplitude within ±window samples (oftrigger.py:776-787)."""
    sat = jnp.asarray(sat_amplitudes)[:, None]
    over = (lpf_trace > sat) if positive_pulses else (lpf_trace < -sat)
    over_any = jnp.any(over, axis=0).astype(jnp.float32)
    # dilate with a running max over ±window
    dil = jax.lax.reduce_window(
        over_any, -jnp.inf, jax.lax.max,
        window_dimensions=(2 * window + 1,), window_strides=(1,),
        padding=((window, window),))
    return dil > 0


def combine_trigger_sets(first: TriggerSet,
                         second: TriggerSet) -> TriggerSet:
    """Merge a first-pass and a residual-pass TriggerSet without
    duplicating trigger indices (``combine_trigger_data`` semantics,
    reference core/oftrigger.py:262-321: original entries are all kept;
    entries of the new pass whose trigger index is not already present
    are appended in order).

    Host-side numpy — trigger sets are small fixed-capacity buffers and
    the merge feeds the host EventBuilder. The result's capacity is the
    sum of the input capacities, so nothing is truncated by the merge
    itself; ``count_total`` adds the unique new groups to the first
    pass's total so capacity-truncation reporting stays meaningful.
    """
    idx1 = np.asarray(first.indices)
    idx2 = np.asarray(second.indices)
    n1 = int(first.count)
    n2 = int(second.count)
    keep1 = idx1[:n1]
    new_mask = ~np.isin(idx2[:n2], keep1) & (idx2[:n2] >= 0)
    new_pos = np.flatnonzero(new_mask)
    n_new = len(new_pos)

    cap = idx1.shape[0] + idx2.shape[0]
    indices = np.full(cap, -1, dtype=idx1.dtype)
    indices[:n1] = keep1
    indices[n1:n1 + n_new] = idx2[:n2][new_pos]
    dchi2 = np.zeros(cap, dtype=np.asarray(first.dchi2).dtype)
    dchi2[:n1] = np.asarray(first.dchi2)[:n1]
    dchi2[n1:n1 + n_new] = np.asarray(second.dchi2)[:n2][new_pos]
    m = np.asarray(first.amplitudes).shape[0]
    amps = np.zeros((m, cap), dtype=np.asarray(first.amplitudes).dtype)
    amps[:, :n1] = np.asarray(first.amplitudes)[:, :n1]
    amps[:, n1:n1 + n_new] = np.asarray(second.amplitudes)[:, :n2][:, new_pos]

    # groups the second pass found but couldn't keep (its own capacity
    # truncation) are unknown-index and can't be deduped — count them as
    # new so the truncation stays visible in count_total
    trunc2 = int(second.count_total) - n2
    total = int(first.count_total) + n_new + max(trunc2, 0)
    n_above = None
    if first.n_above is not None or second.n_above is not None:
        n_above = np.int32(
            (0 if first.n_above is None else int(first.n_above))
            + (0 if second.n_above is None else int(second.n_above)))
    return TriggerSet(indices=indices, dchi2=dchi2, amplitudes=amps,
                      count=np.int32(n1 + n_new),
                      count_total=np.int32(total), n_above=n_above)



#: Drop-in alias using the reference's name (core/oftrigger.py:262).
combine_trigger_data = combine_trigger_sets

def residual_subtract(dchi2: jnp.ndarray, triggers: TriggerSet,
                      kernel: TriggerKernel,
                      saturated: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Subtract each trigger's best-fit Δχ² response from the Δχ² trace
    (oftrigger.py:789-817), skipping saturated triggers.

    The response of filter i to the best-fit pulse (amplitudes â at index
    T) is q_resp_i(t) = Σ_j response[i, j, (t−T) + Nt−1]·â_j; the
    subtracted trace is q_respᵀ W⁻¹ q_resp centered on its own argmax
    aligned to T.
    """
    nt = kernel.nt
    iw = jnp.asarray(kernel.iw_matrix)
    resp = jnp.asarray(kernel.response)                    # [M, M, 2Nt−1]
    l = dchi2.shape[-1]
    k = triggers.indices.shape[0]

    # per-trigger q response on the 2Nt−1 lag axis: [K, M, 2Nt−1]
    q_resp = _einsum("ijl,jk->kil", resp, triggers.amplitudes)
    d_resp = _einsum("kil,ij,kjl->kl", q_resp, iw, q_resp)     # [K, 2Nt−1]
    # align each response's peak to the trigger index
    peak = jnp.argmax(d_resp, axis=-1)                         # [K]

    valid = triggers.indices >= 0
    if saturated is not None:
        sat_at = saturated[jnp.clip(triggers.indices, 0)]
        valid = valid & ~sat_at
    start = triggers.indices - peak                            # [K]

    # sequential dynamic-slice read-modify-write per trigger instead of
    # one [K×(2Nt−1)] scatter-add; overlapping trigger responses still
    # accumulate correctly because the loop carries the updated trace. The trace is padded by one
    # response length on each side so every segment is in bounds.
    seg = d_resp.shape[-1]
    contrib = jnp.where(valid[:, None], d_resp, 0.0)
    out_pad = jnp.pad(dchi2, (seg, seg))
    start_pad = jnp.clip(start + seg, 0, l + seg)

    def body(kk, acc):
        s = start_pad[kk]
        cur = jax.lax.dynamic_slice(acc, (s,), (seg,))
        return jax.lax.dynamic_update_slice(acc, cur - contrib[kk], (s,))

    out_pad = jax.lax.fori_loop(0, k, body, out_pad)
    return out_pad[seg: seg + l]


class ResidualBasis(NamedTuple):
    """Fixed convolution basis for the residual re-trigger subtraction.

    The Δχ² shape subtracted for a trigger with best-fit amplitudes â is
    the bilinear form  d(t) = Σ_{j,j'} â_j·â_j'·G_{jj'}(t − start), with
    G_{jj'}(d) = Σ_{i,i'} resp[i,j,d]·W⁻¹[i,i']·resp[i',j',d] a FIXED
    basis of M(M+1)/2 kernels (symmetric pairs folded, off-diagonal
    doubled). The whole K-trigger subtraction is therefore K scalar
    spikes per pair + ONE overlap-save FFT convolution
    (:func:`residual_subtract_conv`) instead of a serial K-segment loop.
    """

    fir: TriggerKernel   # P-channel, single-output overlap-save FIR over
                         # the G basis (nt = 2Nt−1, pretrigger = nt−1 so
                         # of_fir_blocks returns the plain convolution)
    j1: np.ndarray       # [P] int32 template-pair indices, j1 ≤ j2
    j2: np.ndarray


def make_residual_basis(kernel: TriggerKernel,
                        block: Optional[int] = None) -> ResidualBasis:
    """Precompute the Δχ²-subtraction convolution basis for a trigger
    kernel (host side, once per channel).

    Default overlap-save sizing: the basis kernel is 2Nt−1 long, so a
    2×-overlap FFT would spend half its work on the overlap; F = 4×
    overlap wastes 25%."""
    resp = np.asarray(kernel.response, np.float64)          # [M, M, seg]
    iw = np.asarray(kernel.iw_matrix, np.float64)
    m, _, seg = resp.shape
    if block is None:
        overlap = max(128 * int(np.ceil((seg - 1) / 128)), 128)
        block = max(16384, 4 * overlap)
    gfull = np.einsum("abl,ac,cdl->bdl", resp, iw, resp)    # [M, M, seg]
    j1, j2 = np.triu_indices(m)
    basis = gfull[j1, j2] * np.where(j1 == j2, 1.0, 2.0)[:, None]
    real_dtype = np.asarray(kernel.response).dtype
    g_fft, blk, f_size = _fir_layout(basis[:, None, :], block, real_dtype)
    fir = TriggerKernel(
        g_fft=g_fft,
        iw_matrix=np.eye(1, dtype=real_dtype),
        response=np.zeros((1, 1, 1), real_dtype),
        nt=seg, pretrigger=seg - 1, fs=kernel.fs, block=blk,
        fft_size=f_size, resolution=np.ones(1, real_dtype))
    return ResidualBasis(fir=fir, j1=j1.astype(np.int32),
                         j2=j2.astype(np.int32))


def residual_subtract_conv(dchi2: jnp.ndarray, triggers: TriggerSet,
                           kernel: TriggerKernel, basis: ResidualBasis,
                           saturated: Optional[jnp.ndarray] = None
                           ) -> jnp.ndarray:
    """FFT-convolution residual subtraction — the fast default path.

    Mathematically identical to :func:`residual_subtract` (same
    responses, same peak alignment, same edge clipping), but instead of
    K sequential segment updates the subtraction runs as a sparse-
    impulse convolution over the fixed basis carried by ``basis`` (see
    :class:`ResidualBasis`): per basis pair, each valid trigger
    contributes one scalar spike â_j1·â_j2 at its aligned start, and one
    overlap-save FFT convolution pass produces the full subtraction
    trace. Cost is O(L·log F) with NO serial K-loop.

    The one semantic difference from the loop: FFT roundoff scatters
    ~eps × the largest subtraction peak over the whole trace instead of
    staying inside the touched segments (f32: ~1e-7·max Δχ²_subtracted —
    negligible against any physical threshold; the saturation veto
    removes the pathological huge-pulse case before subtraction).

    ``dchi2`` may be flat [L] or block-layout [R, B] (row-major time
    order); the result has the same layout.
    """
    shp = dchi2.shape
    d_flat = dchi2.reshape(-1)
    l = d_flat.shape[0]
    seg = kernel.response.shape[-1]                        # 2·Nt − 1
    resp = jnp.asarray(kernel.response)
    iw = jnp.asarray(kernel.iw_matrix)
    amps = triggers.amplitudes                             # [M, K]

    # peak alignment: argmax of each trigger's own response shape
    # (small: K × M² × seg flops)
    q_resp = _einsum("ijl,jk->kil", resp, amps)
    d_resp = _einsum("kil,ij,kjl->kl", q_resp, iw, q_resp)
    peak = jnp.argmax(d_resp, axis=-1).astype(jnp.int32)   # [K]

    valid = triggers.indices >= 0
    if saturated is not None:
        valid = valid & ~saturated[jnp.clip(triggers.indices, 0)]

    j1 = jnp.asarray(basis.j1)
    j2 = jnp.asarray(basis.j2)
    coeff = (amps[j1, :] * amps[j2, :]
             * valid[None, :].astype(d_flat.dtype))        # [P, K]
    # spike positions on a seg-left-padded axis so starts as low as
    # −(seg−1) (peak beyond the trigger index) stay in bounds; the final
    # slice drops out-of-trace contributions exactly like the loop path
    pos = jnp.clip(triggers.indices - peak + seg, 0, l + seg - 1)
    spikes = jnp.zeros((coeff.shape[0], l + seg), d_flat.dtype)
    spikes = spikes.at[:, pos].add(coeff)
    # basis.fir has pretrigger = nt−1 ⇒ q(T) = conv(spikes, G)(T); the
    # subtraction at trace index t is q(t + seg)
    qb, _ = of_fir_blocks(spikes, basis.fir, valid_range=(0, l + seg))
    sub = qb[0].reshape(-1)[seg: seg + l]
    return (d_flat - sub).reshape(shp)
