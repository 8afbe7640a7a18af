"""Batched NxM (multi-channel, multi-template) optimal-filter kernels.

Batched replacement for qetpy.OFnxm / OFnxmx2 as used by the reference's
multichannel extractors (detprocess/core/algorithms.py:24-274) and by the
continuous trigger (core/oftrigger.py). Consumes an OFNxMBank
(ops/filterbank.make_ofnxm_bank).

Math (conventions in ops/filterbank.py): for channel-stacked signal FFTs
ṽ [C, N] and bank quantities Phi [C, M, N] = J⁻¹s̃*/(N·fs), W [M, M]:

- ``q_m(d)  = Re Σ_{c,k} Phi[c,m,k] ṽ[c,k] e^{2πikd/N}``
- ``â(d)    = W⁻¹ q(d)``
- ``Δχ²(d)  = q(d)ᵀ W⁻¹ q(d)``  (≥ 0; χ²_M distributed on pure noise)
- ``χ²(d)   = χ²₀ − Δχ²(d)``,  ``χ²₀ = Σ_k ṽ† J⁻¹ ṽ / (N·fs)``

The Hermitian symmetry of the CSD makes the qetpy-style filter sum
Σ_c Phi·ṽ equal (after the ±k sum) to the textbook s̃†J⁻¹ṽ — both are
tested against an independent loop implementation.

NxMx2 ("two template groups with independent time shifts within windows") is
implemented as a masked 2-D delay scan over (d1, d2) pairs restricted to the
configured fit windows — see ofnxmx2().
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from detprocess_jax.ops import fft as dfft
from detprocess_jax.ops import of1x1


class OFNxMResult(NamedTuple):
    amps: jnp.ndarray   # [..., M]
    t0: jnp.ndarray     # [...]
    chi2: jnp.ndarray   # [...]


# every contraction at full float32 precision (see ops/fft.HIGHEST)
_einsum = dfft.einsum


def chi2_base_nxm(vfft: jnp.ndarray, icsd: jnp.ndarray, fs: float) -> jnp.ndarray:
    """χ²₀ = Σ_k ṽ† J⁻¹ ṽ / (N·fs). vfft [..., C, N]; icsd [N, C, C]."""
    n = vfft.shape[-1]
    tmp = _einsum("kab,...bk->...ak", icsd, vfft)
    return _einsum("...ak,...ak->...", jnp.conj(vfft), tmp).real / (n * fs)


def ofnxm_nodelay(
    vfft: jnp.ndarray,
    phi: jnp.ndarray,
    iw_matrix: jnp.ndarray,
    icsd: jnp.ndarray,
    fs: float,
) -> OFNxMResult:
    """No-delay NxM fit. vfft [..., C, N] -> amps [..., M]."""
    q = _einsum("cmk,...ck->...m", phi, vfft).real
    amps = _einsum("ij,...j->...i", iw_matrix, q)
    chi2_0 = chi2_base_nxm(vfft, icsd, fs)
    dchi2 = _einsum("...i,ij,...j->...", q, iw_matrix, q)
    chi2 = chi2_0 - dchi2
    t0 = jnp.zeros_like(chi2)
    return OFNxMResult(amps, t0, chi2)


def _q_timeseries(vfft: jnp.ndarray, phi: jnp.ndarray,
                  pretrigger: int) -> jnp.ndarray:
    """q_m(t) rolled to absolute trace indices: [..., M, N]."""
    n = vfft.shape[-1]
    integrand = _einsum("cmk,...ck->...mk", phi, vfft)
    q_t = dfft.ifft(integrand, axis=-1).real * n
    return jnp.roll(q_t, pretrigger, axis=-1)


def ofnxm_withdelay(
    vfft: jnp.ndarray,
    phi: jnp.ndarray,
    w_matrix: jnp.ndarray,
    iw_matrix: jnp.ndarray,
    icsd: jnp.ndarray,
    pretrigger: int,
    fs: float,
    window_mask: Optional[jnp.ndarray] = None,
    interpolate_t0: bool = False,
) -> OFNxMResult:
    """Delay-scan NxM fit, all M amplitudes sharing one shift d.

    Equivalent of OFnxm.get_fit_withdelay (core/algorithms.py:254-261).
    window_mask: static bool [N] over absolute trace indices.
    """
    n = vfft.shape[-1]
    q_scan = _q_timeseries(vfft, phi, pretrigger)            # abs order
    dchi2 = _einsum("...it,ij,...jt->...t", q_scan, iw_matrix, q_scan)
    pick = of1x1.pick_delay(dchi2, n, pretrigger,
                            window_mask=window_mask,
                            interpolate_t0=interpolate_t0)
    q_best = jnp.take_along_axis(
        q_scan, pick.idx[..., None, None], axis=-1)[..., 0]  # [..., M]
    amps = _einsum("ij,...j->...i", iw_matrix, q_best)
    chi2_0 = chi2_base_nxm(vfft, icsd, fs)
    gain = (pick.gain if interpolate_t0
            else _einsum("...i,...i->...", amps, q_best))
    return OFNxMResult(amps, pick.shift / fs, chi2_0 - gain)


def ofnxm_withdelay_direct(
    vfft: jnp.ndarray,
    phi: jnp.ndarray,
    w_matrix: jnp.ndarray,
    iw_matrix: jnp.ndarray,
    icsd: jnp.ndarray,
    pretrigger: int,
    fs: float,
    eval_idx, valid, cos_mat, sin_mat,
    interpolate_t0: bool = False,
) -> OFNxMResult:
    """Constrained NxM delay scan via direct windowed DFT matmuls.

    Numerically equal to ``ofnxm_withdelay(window_mask=...)`` but for a
    narrow window of W allowed delays it skips the M full inverse FFTs
    (``_q_timeseries``) and evaluates
    q_m(d) = Σ_k (φᵀṽ)_{m,k} e^{2πikd/N} only at the W window samples:
    two dense real [..M, N]×[N, W] matmuls (same pattern as
    ``of1x1_windowed_direct_half``; see ``of1x1.prepare_delay_window``
    with ``bin_w=None``).
    """
    integrand = _einsum("cmk,...ck->...mk", phi, vfft)
    cos_mat = jnp.asarray(cos_mat, vfft.real.dtype)
    sin_mat = jnp.asarray(sin_mat, vfft.real.dtype)
    qw = (jnp.matmul(integrand.real, cos_mat, precision=dfft.HIGHEST)
          - jnp.matmul(integrand.imag, sin_mat, precision=dfft.HIGHEST))
    # [..., M, W]
    dchi2 = _einsum("...iw,ij,...jw->...w", qw, iw_matrix, qw)
    masked = jnp.where(jnp.asarray(valid), dchi2, -jnp.inf)
    p = jnp.argmax(masked, axis=-1)
    q_best = jnp.take_along_axis(
        qw, p[..., None, None], axis=-1)[..., 0]             # [..., M]
    amps = _einsum("ij,...j->...i", iw_matrix, q_best)
    chi2_0 = chi2_base_nxm(vfft, icsd, fs)
    imax = jnp.take(jnp.asarray(eval_idx), p)
    shift = imax.astype(chi2_0.dtype) - pretrigger
    if interpolate_t0:
        # guard extension guarantees positions p±1 hold imax±1 (mod N) —
        # window-position indexing, so no %n wrap
        delta, gain = of1x1.parabola_refit(dchi2, p, p - 1, p + 1)
        shift = shift + delta
    else:
        gain = jnp.take_along_axis(dchi2, p[..., None], axis=-1)[..., 0]
    return OFNxMResult(amps, shift / fs, chi2_0 - gain)


# ---------------------------------------------------------------------------
# NxMx2: two template groups with independent time shifts
# ---------------------------------------------------------------------------

# Union-window width at or below which ofnxmx2 evaluates q via direct
# windowed DFT matmuls instead of M full inverse FFTs. Set to the 1x1
# break-even measured on the H100 (pipelines/features.DIRECT_WINDOW_MAX,
# W ≈ 220); the NxMx2 scan itself has not been measured on the card.
DIRECT_UNION_MAX = 200


class OFNxMx2Result(NamedTuple):
    amps: jnp.ndarray      # [..., M]
    deltat: jnp.ndarray    # [...] — t(group2) − t(group1), seconds
    chi2: jnp.ndarray      # [...]


def ofnxmx2(
    vfft: jnp.ndarray,
    s_fft: jnp.ndarray,          # [C, M, N]
    icsd: jnp.ndarray,           # [N, C, C]
    group_ids: np.ndarray,       # [M] static ints in {0, 1}
    window1: np.ndarray,         # static bool [N] allowed shifts for group 0
    window2: np.ndarray,         # static bool [N] allowed shifts for group 1
    pretrigger: int,
    fs: float,
):
    """NxMx2 optimal filter: template group 0 shifts by d1, group 1 by d2,
    amplitudes solved jointly at each (d1, d2) in the fit windows.

    Equivalent of qetpy.OFnxmx2 with set_time_constraints/calc_p_matrix
    (reference usage: processing_data.py:385-418, algorithms.py:24-138).

    For shifts (d1, d2) the shifted-template weight matrix is
    ``P_ij(d1,d2) = Re Σ_k s̃_i† J⁻¹ s̃_j e^{iω(d_gj − d_gi)}`` which only
    depends on Δ = d2 − d1; the amplitude estimator is
    ``â = P(Δ)⁻¹ q(d1, d2)`` with ``q_i = q-timeseries_i(d_gi)`` and
    ``Δχ²(d1,d2) = q† P(Δ)⁻¹ q``, maximized over the window product.

    To keep the scan O(N·W2) rather than O(N²), window2 is enumerated as a
    static index list (fit windows are short in practice).
    """
    n = vfft.shape[-1]
    m = s_fft.shape[1]
    g = np.asarray(group_ids)

    # per-template q values; phi = conj(J⁻¹s̃)
    # (NOT J⁻¹·conj(s̃) — see ops/filterbank.py make_ofnxm_bank)
    phi = jnp.conj(_einsum("kab,bmk->amk", icsd, s_fft)) / (n * fs)

    idx1 = np.where(np.asarray(window1))[0]
    idx2 = np.where(np.asarray(window2))[0]
    # q is only ever read at the fit-window shifts, so evaluate it ONLY
    # there: for short windows a direct windowed DFT matmul over the
    # union of windows replaces M full inverse FFTs (the same pattern as
    # of1x1_windowed_direct_half); wide windows keep the ifft time
    # series and gather from it
    idx_u = np.union1d(idx1, idx2)
    pos1 = jnp.asarray(np.searchsorted(idx_u, idx1))
    pos2 = jnp.asarray(np.searchsorted(idx_u, idx2))
    integrand = _einsum("cmk,...ck->...mk", phi, vfft)    # [..., M, N]
    if len(idx_u) <= DIRECT_UNION_MAX:
        kk = np.arange(n, dtype=np.float64)[:, None]
        dd = ((idx_u.astype(np.int64) - pretrigger) % n)[None, :]
        th = 2.0 * np.pi * kk * dd / n
        cos_m = jnp.asarray(np.cos(th), vfft.real.dtype)
        sin_m = jnp.asarray(np.sin(th), vfft.real.dtype)
        q_win = (jnp.matmul(integrand.real, cos_m, precision=dfft.HIGHEST)
                 - jnp.matmul(integrand.imag, sin_m, precision=dfft.HIGHEST))
    else:
        q_t = dfft.ifft(integrand, axis=-1).real * n
        q_abs = jnp.roll(q_t, pretrigger, axis=-1)           # [..., M, N]
        q_win = q_abs[..., jnp.asarray(idx_u)]               # [..., M, WU]

    # pairwise template overlap vs relative shift Δ (cross-group terms only):
    # R_ij(Δ) = Re Σ_k s̃_i† J⁻¹ s̃_j e^{2πikΔ/N} / (N·fs)  — via one ifft
    s_f = jnp.moveaxis(s_fft, -1, 0)                         # [N, C, M]
    js = _einsum("kab,kbm->kam", icsd, s_f)               # [N, C, M]
    cross_k = _einsum("kci,kcj->ijk", jnp.conj(s_f), js)  # [M, M, N]
    r_delta = dfft.ifft(cross_k, axis=-1).real * n / (n * fs)

    w1 = jnp.asarray(idx1)
    w2 = jnp.asarray(idx2)

    same_group = (g[:, None] == g[None, :])
    base_w = r_delta[..., 0]                                 # Δ=0 overlaps

    def solve_pair(i1, i2):
        # weight matrix for this (d1, d2): same-group entries at Δ=0,
        # cross-group at Δ = ±(d2−d1)
        d1, d2 = w1[i1], w2[i2]
        delta = (d2 - d1) % n
        # P_ij needs e^{−iω(d_gj − d_gi)}; r_delta(Δ) carries e^{+iωΔ}, so
        # entry (i,j) with g_i=0, g_j=1 (relative shift +Δ) uses r_delta(−Δ)
        r_m = r_delta[..., (n - delta) % n]
        r_p = r_delta[..., delta]
        gi = jnp.asarray(g)[:, None]
        gj = jnp.asarray(g)[None, :]
        p = jnp.where(jnp.asarray(same_group), base_w,
                      jnp.where(gi < gj, r_m, r_p))
        ip = jnp.linalg.inv(p)
        # q vector: template i evaluated at its group's shift (positions
        # into the union-window evaluation)
        pos_for = jnp.where(jnp.asarray(g) == 0, pos1[i1], pos2[i2])
        idx = jnp.broadcast_to(pos_for[:, None], q_win.shape[:-1] + (1,))
        q = jnp.take_along_axis(q_win, idx, axis=-1)[..., 0]
        amps = _einsum("ij,...j->...i", ip, q)
        dchi2 = _einsum("...i,ij,...j->...", q, ip, q)
        return amps, dchi2

    def scan_d2(i1):
        def body(i2):
            return solve_pair(i1, i2)
        amps, dchi2 = jax.vmap(body)(jnp.arange(len(idx2)))
        best = jnp.argmax(dchi2, axis=0)
        return (jnp.take_along_axis(
                    amps, best[None, ..., None], axis=0)[0],
                jnp.take_along_axis(dchi2, best[None, ...], axis=0)[0],
                w2[best])

    amps_all, dchi2_all, d2_all = jax.vmap(scan_d2)(
        jnp.arange(len(idx1)))                               # [W1, ...]
    best1 = jnp.argmax(dchi2_all, axis=0)
    amps = jnp.take_along_axis(amps_all, best1[None, ..., None], axis=0)[0]
    dchi2 = jnp.take_along_axis(dchi2_all, best1[None, ...], axis=0)[0]
    d2 = jnp.take_along_axis(d2_all, best1[None, ...], axis=0)[0]
    d1 = w1[best1]

    chi2_0 = chi2_base_nxm(vfft, icsd, fs)
    chi2 = chi2_0 - dchi2
    deltat = (d2 - d1).astype(chi2.dtype) / fs
    return OFNxMx2Result(amps, deltat, chi2), (d1, d2)
