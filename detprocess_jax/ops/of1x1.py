"""Batched single-channel optimal-filter kernels (1x1, and 1x2 two-template).

Batched replacement for qetpy.OF1x1/OF1x2 as used by the reference's
feature extractors (detprocess/core/algorithms.py:278-647). Where the
reference instantiates an OF object per event and channel inside a Python
loop, these kernels act on a whole batch of events at once:

    traces [B, S, N]  -(one batched FFT)->  vfft [B, S, N]
    -> nodelay / withdelay / constrained fits as fused reductions

with S = stacked (channel, template) slots from the filter bank
(ops/filterbank.make_of1x1_bank) and N = samples.

Optimal-filter math (standard matched-filter formalism; conventions in
ops/filterbank.py): for signal FFT ṽ and bank quantities (phi, norm,
denom_inv, s̃):

- ``q(d)     = Re Σ_k phi_k ṽ_k e^{2πikd/N}`` — amplitude numerator vs delay d
- ``amp(d)   = q(d) / norm``,  ``σ_amp = 1/sqrt(norm)``
- ``χ²(d)    = χ²₀ − q(d)²/norm``,  ``χ²₀ = Σ_k |ṽ_k|² denom_inv_k``
- low-frequency χ² restricted to ``|f| < fcutoff`` (and non-DC) with the
  fitted (amp, d) residual — matches OF1x1 ``lowchi2_fcutoff``.

Delay indexing: ifft index d is rolled by ``pretrigger`` so that absolute
trace index i corresponds to a pulse whose trigger point sits at sample i;
``t0 = (i − pretrigger)/fs`` (negative = earlier than the nominal trigger),
matching qetpy's t0 sign conventions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from detprocess_jax.ops import fft as dfft


def signal_fft(traces: jnp.ndarray) -> jnp.ndarray:
    """FFT of a batch of traces (the per-event precompute shared by all OF
    algorithms — replaces OFBase.update_signal(calc_fft=True),
    processing_data.py:763-772)."""
    return dfft.fft(traces, axis=-1)


def chi2_base(vfft: jnp.ndarray, denom_inv: jnp.ndarray) -> jnp.ndarray:
    """χ²₀ = Σ_k |ṽ|² / (N·fs·J) — the no-pulse chi-square."""
    return jnp.sum((vfft.real**2 + vfft.imag**2) * denom_inv, axis=-1)


def lowfreq_mask(n: int, fs: float, fcutoff: float) -> np.ndarray:
    """Static boolean mask [N]: |f| < fcutoff and not DC (host-side)."""
    f = np.fft.fftfreq(n, d=1.0 / fs)
    mask = np.abs(f) < fcutoff
    mask[0] = False
    return mask


def _residual_chi2(vfft, amp, shift, s_fft, denom_inv, mask):
    """χ² of (ṽ − amp·s̃·e^{−2πik·shift/N}) over masked bins.

    ``shift`` is the delay in samples (traced, can be 0); broadcasting:
    vfft [..., N], amp/shift [...]
    """
    n = vfft.shape[-1]
    k = jnp.arange(n)
    phase = jnp.exp(-2j * jnp.pi * k * shift[..., None] / n)
    resid = vfft - amp[..., None] * s_fft * phase
    return jnp.sum((resid.real**2 + resid.imag**2) * denom_inv * mask, axis=-1)


class OF1x1Result(NamedTuple):
    amp: jnp.ndarray
    t0: jnp.ndarray
    chi2: jnp.ndarray
    lowchi2: jnp.ndarray
    chi2_nopulse: jnp.ndarray


class DelayPick(NamedTuple):
    """Winner of a delay scan (:func:`pick_delay`)."""

    idx: jnp.ndarray    # winning sample index in the series' own order
    im1: jnp.ndarray    # (idx ± 1) % n — for quadratic amp refits
    ip1: jnp.ndarray
    delta: jnp.ndarray  # sub-sample offset (0.0 when not interpolating)
    gain: jnp.ndarray | None
    # Δχ² parabola apex at the winner — ONLY set when interpolating.
    # Without interpolation it is None ON PURPOSE: gathering the winner
    # value out of dchi2 would force XLA to materialize the whole Δχ²
    # series that otherwise fuses into the argmax reduction (measured
    # ~5% of the feature step at 32k) — callers recompute the winner's
    # gain from values they gather anyway (q_best²/norm, or the NxM
    # einsum output that is materialized regardless).
    shift: jnp.ndarray  # signed t0 in samples, including delta


def _take_last(x, i):
    return jnp.take_along_axis(x, i[..., None], axis=-1)[..., 0]


def pick_delay(dchi2: jnp.ndarray, n: int, pretrigger: int, *,
               window_mask=None,
               interpolate_t0: bool = False) -> DelayPick:
    """Winner selection shared by every delay-scan kernel (of1x1 full /
    half and the NxM analog): window masking, the Δχ² argmax, the
    index → signed-t0 rule, and the optional parabolic sub-sample refit
    of the χ² apex.

    ``dchi2`` [..., N]: the χ² gain series in ABSOLUTE trace order (the
    roll-by-pretrigger layout, where the winner index i maps to
    t0 = i − pretrigger). ``window_mask`` is the static boolean [N] over
    absolute trace indices.

    The refit fits a parabola through (Δχ² at idx−1, idx, idx+1);
    ``gain`` is its apex value, so callers form χ² = χ²₀ − gain in both
    modes, and amp refits reuse ``delta``/``im1``/``ip1``.
    """
    if window_mask is None:
        masked = dchi2
    else:
        masked = jnp.where(window_mask, dchi2, -jnp.inf)
    idx = jnp.argmax(masked, axis=-1)
    f = idx.astype(dchi2.dtype)
    shift = f - pretrigger
    im1 = (idx - 1) % n
    ip1 = (idx + 1) % n
    if not interpolate_t0:
        return DelayPick(idx, im1, ip1, jnp.zeros_like(f), None, shift)
    delta, gain = parabola_refit(dchi2, idx, im1, ip1)
    return DelayPick(idx, im1, ip1, delta, gain, shift + delta)


def parabola_refit(dchi2, idx, im1, ip1):
    """Parabolic apex of the Δχ² series through the winner and its two
    neighbor positions: returns (delta, gain) with delta ∈ [−1, 1] the
    sub-sample offset and gain the interpolated Δχ² maximum (callers
    form χ² = χ²₀ − gain)."""
    ym1 = -_take_last(dchi2, im1)
    y0 = -_take_last(dchi2, idx)
    yp1 = -_take_last(dchi2, ip1)
    denom = ym1 - 2.0 * y0 + yp1
    delta = jnp.where(jnp.abs(denom) > 0, 0.5 * (ym1 - yp1) / denom, 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    return delta, -(y0 - 0.25 * (ym1 - yp1) * delta)


def interp_amp(q: jnp.ndarray, norm, pick: DelayPick) -> jnp.ndarray:
    """Quadratic refit of the scalar amplitude a(d) = q(d)/norm at the
    winner's sub-sample offset (exactly a(idx) when delta == 0)."""
    amp = _take_last(q, pick.idx) / norm
    am1 = _take_last(q, pick.im1) / norm
    ap1 = _take_last(q, pick.ip1) / norm
    a_denom = am1 - 2.0 * amp + ap1
    return (amp + 0.5 * (ap1 - am1) * pick.delta
            + 0.5 * a_denom * pick.delta * pick.delta)


def of1x1_nodelay(
    vfft: jnp.ndarray,
    phi: jnp.ndarray,
    norm: jnp.ndarray,
    denom_inv: jnp.ndarray,
    s_fft: jnp.ndarray,
    low_mask: Optional[jnp.ndarray] = None,
) -> OF1x1Result:
    """No-delay OF fit (amplitude at the nominal trigger position).

    Equivalent of FeatureExtractors.of1x1_nodelay
    (core/algorithms.py:278-350). Shapes: vfft [..., S, N]; bank arrays
    [S, N] / [S]; results [..., S].
    """
    q = jnp.sum((phi * vfft).real, axis=-1)
    amp = q / norm
    c0 = chi2_base(vfft, denom_inv)
    chi2 = c0 - q * q / norm
    if low_mask is None:
        lowchi2 = jnp.full_like(chi2, -999999.0)
    else:
        zero = jnp.zeros_like(amp)
        lowchi2 = _residual_chi2(vfft, amp, zero, s_fft, denom_inv, low_mask)
    t0 = jnp.zeros_like(amp)
    return OF1x1Result(amp, t0, chi2, lowchi2, c0)


def of1x1_withdelay(
    vfft: jnp.ndarray,
    phi: jnp.ndarray,
    norm: jnp.ndarray,
    denom_inv: jnp.ndarray,
    s_fft: jnp.ndarray,
    pretrigger: int,
    fs: float,
    window_mask: Optional[jnp.ndarray] = None,
    low_mask: Optional[jnp.ndarray] = None,
    interpolate_t0: bool = False,
) -> OF1x1Result:
    """Delay-scan OF fit, optionally constrained to a window.

    Equivalent of of1x1_unconstrained / of1x1_constrained
    (core/algorithms.py:355-570). ``window_mask`` is a static boolean [N]
    over **absolute trace indices** (True = allowed); build it from
    utils.windows.extract_window_indices, inverting for
    ``lgc_outside_window``. ``interpolate_t0`` refines t0/amp with a
    parabolic fit around the discrete χ² minimum.
    """
    n = vfft.shape[-1]
    # amplitude numerator vs delay, rolled to absolute trace indices
    qt = dfft.ifft(phi * vfft, axis=-1).real * n          # [..., S, N]
    q_abs = jnp.roll(qt, pretrigger, axis=-1)
    c0 = chi2_base(vfft, denom_inv)                          # [..., S]
    dchi2 = q_abs * q_abs / norm[..., None]                  # [..., S, N]

    pick = pick_delay(dchi2, n, pretrigger,
                      window_mask=window_mask,
                      interpolate_t0=interpolate_t0)
    if interpolate_t0:
        chi2 = c0 - pick.gain
        amp = interp_amp(q_abs, norm, pick)
    else:
        q_best = _take_last(q_abs, pick.idx)
        amp = q_best / norm
        chi2 = c0 - q_best * q_best / norm
    shift = pick.shift
    t0 = shift / fs

    if low_mask is None:
        lowchi2 = jnp.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2(vfft, amp, shift, s_fft, denom_inv, low_mask)

    return OF1x1Result(amp, t0, chi2, lowchi2, c0)


# ---------------------------------------------------------------------------
# half-spectrum (rfft) fast path
#
# For real traces all OF sums over the two-sided spectrum reduce to sums
# over the N//2+1 non-negative bins with per-bin weights w = (1, 2, …, 2, 1)
# (bank.bin_w). One rfft replaces the full complex FFT and the delay scan
# uses one irfft — half the FFT work and memory traffic per event.
# Results are identical to the full kernels (tested).
# ---------------------------------------------------------------------------

def signal_rfft(traces: jnp.ndarray) -> jnp.ndarray:
    """Half-spectrum FFT of a batch of real traces → [..., N//2+1]."""
    return dfft.rfft(traces, axis=-1)


def chi2_base_half(vr, denom_inv_h, bin_w):
    p2 = vr.real**2 + vr.imag**2
    return jnp.sum(p2 * denom_inv_h * bin_w, axis=-1)


def _residual_chi2_half(vr, amp, shift, s_fft_h, denom_inv_h, bin_w, mask_h,
                        n):
    nh = vr.shape[-1]
    k = jnp.arange(nh)
    phase = jnp.exp(-2j * jnp.pi * k * shift[..., None] / n)
    resid = vr - amp[..., None] * s_fft_h * phase
    p2 = resid.real**2 + resid.imag**2
    return jnp.sum(p2 * denom_inv_h * bin_w * mask_h, axis=-1)


def lowfreq_mask_half(n: int, fs: float, fcutoff: float) -> np.ndarray:
    """Static boolean mask on the half axis: f < fcutoff, DC excluded."""
    f = np.fft.rfftfreq(n, d=1.0 / fs)
    mask = f < fcutoff
    mask[0] = False
    return mask


def of1x1_nodelay_half(vr, phi_h, norm, denom_inv_h, s_fft_h, bin_w,
                       low_mask_h=None, n=None) -> OF1x1Result:
    """Half-spectrum no-delay OF fit; numerically equal to of1x1_nodelay."""
    n = n if n is not None else 2 * (vr.shape[-1] - 1)
    q = jnp.sum((phi_h * vr).real * bin_w, axis=-1)
    amp = q / norm
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    chi2 = c0 - q * q / norm
    if low_mask_h is None:
        lowchi2 = jnp.full_like(chi2, -999999.0)
    else:
        zero = jnp.zeros_like(amp)
        lowchi2 = _residual_chi2_half(vr, amp, zero, s_fft_h, denom_inv_h,
                                      bin_w, low_mask_h, n)
    return OF1x1Result(amp, jnp.zeros_like(amp), chi2, lowchi2, c0)


def of1x1_withdelay_half(vr, phi_h, norm, denom_inv_h, s_fft_h, bin_w,
                         pretrigger: int, fs: float,
                         window_mask=None, low_mask_h=None,
                         interpolate_t0: bool = False,
                         n: Optional[int] = None) -> OF1x1Result:
    """Half-spectrum delay-scan OF fit; equal to of1x1_withdelay.

    The delay series is one irfft:
    q(d) = Σ_k∈full phi_k ṽ_k e^{2πikd/N} = N·irfft(phi_h·ṽ_h)(d).

    ``n``: the full trace length — required for ODD n (the default
    2·(nh−1) reconstruction only holds for even lengths).
    """
    nh = vr.shape[-1]
    n = n if n is not None else 2 * (nh - 1)
    prod = phi_h * vr
    qt = dfft.irfft(prod, n, axis=-1) * n                 # [..., S, N]
    q_abs = jnp.roll(qt, pretrigger, axis=-1)
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    dchi2 = q_abs * q_abs / norm[..., None]

    pick = pick_delay(dchi2, n, pretrigger,
                      window_mask=window_mask,
                      interpolate_t0=interpolate_t0)
    if interpolate_t0:
        chi2 = c0 - pick.gain
        amp = interp_amp(q_abs, norm, pick)
    else:
        q_best = _take_last(q_abs, pick.idx)
        amp = q_best / norm
        chi2 = c0 - q_best * q_best / norm
    shift = pick.shift
    t0 = shift / fs
    if low_mask_h is None:
        lowchi2 = jnp.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2_half(vr, amp, shift, s_fft_h, denom_inv_h,
                                      bin_w, low_mask_h, n)
    return OF1x1Result(amp, t0, chi2, lowchi2, c0)


def prepare_delay_window(window_mask: np.ndarray, pretrigger: int,
                         n: int, bin_w: Optional[np.ndarray] = None):
    """Host-side precompute for the direct windowed delay kernels
    (:func:`of1x1_windowed_direct_half`, ofnxm's direct variant).

    ``window_mask`` is the static boolean [N] over absolute trace indices
    (as passed to ``of1x1_withdelay_half``). Returns
    ``(eval_idx [W], valid [W], cos_mat [K, W], sin_mat [K, W])`` where
    each contiguous run of allowed indices is extended by one guard
    sample on each side (modulo N, matching the irfft path's
    ``(imin±1) % n`` interpolation neighbors); ``valid`` marks the
    interior (allowed) positions. With ``bin_w`` (half spectrum,
    K = N//2+1) the matrices carry the per-bin weights:
    q_abs[eval_idx] = Re(prod)@cos − Im(prod)@sin with prod = phi_h·ṽ_h.
    Without it they span the full spectrum (K = N, unit weights) for
    full-fft products (NxM path).
    """
    window_mask = np.asarray(window_mask, bool)
    if window_mask.shape[-1] != n:
        raise ValueError("window_mask length != n")
    idx = np.flatnonzero(window_mask)
    if idx.size == 0:
        raise ValueError("empty delay window")
    # contiguous runs → [guard, run..., guard]
    splits = np.flatnonzero(np.diff(idx) > 1) + 1
    eval_idx, valid = [], []
    for run in np.split(idx, splits):
        eval_idx.extend([(run[0] - 1) % n, *run, (run[-1] + 1) % n])
        valid.extend([False, *([True] * len(run)), False])
    eval_idx = np.asarray(eval_idx, np.int32)
    valid = np.asarray(valid, bool)
    nk = n if bin_w is None else len(bin_w)
    k = np.arange(nk, dtype=np.float64)[:, None]
    d = ((eval_idx.astype(np.int64) - pretrigger) % n)[None, :]
    theta = 2.0 * np.pi * k * d / n
    w = (np.ones((1, 1)) if bin_w is None
         else np.asarray(bin_w, np.float64)[:, None])
    return (eval_idx, valid,
            (np.cos(theta) * w), (np.sin(theta) * w))


def of1x1_windowed_direct_half(vr, phi_h, norm, denom_inv_h, s_fft_h,
                               bin_w, pretrigger: int, fs: float,
                               eval_idx, valid, cos_mat, sin_mat,
                               low_mask_h=None,
                               interpolate_t0: bool = False,
                               n: Optional[int] = None) -> OF1x1Result:
    """Constrained delay-scan OF via a direct windowed DFT matmul.

    Numerically equal to ``of1x1_withdelay_half(window_mask=...)`` but
    for a narrow window of W allowed delays it skips the full [N]-point
    inverse FFT (one irfft over [B, N] intermediates) and evaluates
    q(d) = Σ_k w_k Re(phi_k ṽ_k e^{2πikd/N}) only at the W window
    samples: two dense real [B, F]×[F, W] matmuls (the reference's
    constrained fit, core/algorithms.py:355-460, scans the full ifft
    output).

    Inputs from :func:`prepare_delay_window`; W is static.
    """
    nh = vr.shape[-1]
    n = n if n is not None else 2 * (nh - 1)
    prod = phi_h * vr
    cos_mat = jnp.asarray(cos_mat, vr.real.dtype)
    sin_mat = jnp.asarray(sin_mat, vr.real.dtype)
    qw = (jnp.matmul(prod.real, cos_mat, precision=dfft.HIGHEST)
          - jnp.matmul(prod.imag, sin_mat, precision=dfft.HIGHEST))  # [.., W]
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    dchi2 = qw * qw / norm[..., None]
    masked = jnp.where(jnp.asarray(valid), dchi2, -jnp.inf)
    p = jnp.argmax(masked, axis=-1)                           # [...]
    imin = jnp.take(jnp.asarray(eval_idx), p)                 # absolute
    t0_idx = imin.astype(qw.dtype) - pretrigger
    if interpolate_t0:
        # guard extension guarantees positions p±1 exist and hold the
        # absolute neighbors imin±1 (mod n) for every valid winner —
        # window-position indexing, so no %n wrap (pick_delay's job)
        delta, gain = parabola_refit(dchi2, p, p - 1, p + 1)
        pick = DelayPick(p, p - 1, p + 1, delta, gain, t0_idx + delta)
        amp = interp_amp(qw, norm, pick)
        chi2 = c0 - gain
        shift = pick.shift
    else:
        q_best = _take_last(qw, p)
        amp = q_best / norm
        chi2 = c0 - q_best * q_best / norm
        shift = t0_idx
    t0 = shift / fs
    if low_mask_h is None:
        lowchi2 = jnp.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2_half(vr, amp, shift, s_fft_h, denom_inv_h,
                                      bin_w, low_mask_h, n)
    return OF1x1Result(amp, t0, chi2, lowchi2, c0)


def energy_resolution(norm: jnp.ndarray) -> jnp.ndarray:
    """σ_amp = 1/sqrt(norm) — OF amplitude resolution
    (qetpy OF1x1.get_energy_resolution equivalent)."""
    return 1.0 / jnp.sqrt(norm)


def time_resolution(amp: jnp.ndarray, s_fft: jnp.ndarray,
                    denom_inv: jnp.ndarray, fs: float) -> jnp.ndarray:
    """σ_t0 = 1/sqrt(amp² · Σ_k ω_k² |s̃_k|² /(N·fs·J_k)).

    Curvature of χ²(t0) at the minimum (qetpy OF1x1.get_time_resolution
    equivalent, used by of1x1_constrained, core/algorithms.py:558).
    """
    n = s_fft.shape[-1]
    f = jnp.fft.fftfreq(n, d=1.0 / fs).astype(denom_inv.dtype)
    omega2 = (2.0 * jnp.pi * f) ** 2
    curv = jnp.sum(omega2 * (s_fft.real**2 + s_fft.imag**2) * denom_inv, axis=-1)
    return 1.0 / jnp.sqrt(amp * amp * curv)


def time_resolution_half(amp: jnp.ndarray, s_fft_h: jnp.ndarray,
                         denom_inv_h: jnp.ndarray, bin_w, n: int,
                         fs: float) -> jnp.ndarray:
    """Half-spectrum :func:`time_resolution`: the curvature sum is
    per-frequency with |mirror| = |bin|, so the N//2+1 bins with bin_w
    weights reproduce the full sum."""
    nh = s_fft_h.shape[-1]
    k = np.arange(nh)
    f = np.where(k <= n // 2, k, k - n) / n * fs
    omega2 = jnp.asarray((2.0 * np.pi * f) ** 2, denom_inv_h.dtype)
    curv = jnp.sum(omega2 * (s_fft_h.real**2 + s_fft_h.imag**2)
                   * denom_inv_h * bin_w, axis=-1)
    return 1.0 / jnp.sqrt(amp * amp * curv)


# ---------------------------------------------------------------------------
# OF 1x2: one channel, two templates with independent time shifts
# ---------------------------------------------------------------------------

class OF1x2Result(NamedTuple):
    amp1: jnp.ndarray
    amp2: jnp.ndarray
    t0_1: jnp.ndarray
    t0_2: jnp.ndarray
    time_diff: jnp.ndarray
    chi2: jnp.ndarray


def of1x2(
    vfft: jnp.ndarray,
    phi1: jnp.ndarray, norm1: jnp.ndarray, s_fft1: jnp.ndarray,
    phi2: jnp.ndarray, norm2: jnp.ndarray, s_fft2: jnp.ndarray,
    denom_inv: jnp.ndarray,
    pretrigger: int,
    fs: float,
    delta_window: Optional[np.ndarray] = None,
    delta_chunk: int = 8,
) -> OF1x2Result:
    """Joint two-template OF fit (scintillation + evaporation pulses).

    Equivalent of qetpy.OF1x2 as used by FeatureExtractors.of1x2x2
    (core/algorithms.py:572-647): both amplitudes and both delays are fit
    *jointly* — at each delay pair (d1, d2) the coupled 2x2 normal
    equations are solved in closed form and Δχ² is maximized over all
    pairs. (A greedy fit-subtract-fit biases both amplitudes whenever the
    pulses overlap; see tests/test_of1x2_joint.py.)

    Math: with per-template numerator series ``q_i(d) = Re Σ_k φ_i ṽ e^{iωd}``
    and noise-weighted template overlap ``ρ(Δ) = Re Σ_k φ₁ s̃₂ e^{iωΔ}``,
    the weight matrix at relative shift Δ = d2−d1 is
    ``W(Δ) = [[norm1, ρ(−Δ)], [ρ(−Δ), norm2]]``. For float32 safety the
    solve uses the normalized form — significances u_i = q_i/√norm_i and
    correlation c(Δ) = ρ(−Δ)/√(norm1·norm2):

        Δχ²(d1, Δ) = (u1² − 2c·u1·u2 + u2²) / (1 − c²)

    with u1 = u1(d1), u2 = u2(d1+Δ) (norm products ~1e42 overflow f32;
    u and c are O(SNR) and O(1)). The scan over Δ runs as a `lax.scan`
    over chunks of ``delta_chunk`` shifts, each chunk a vectorized pass
    over all d1 — O(N·|Δ|) work, O(chunk·B·N) memory.

    ``delta_window``: optional static int array of allowed Δ = d2−d1
    values in samples (e.g. ``np.arange(0, 500)`` for "second pulse after
    the first"); default scans all N circular shifts.
    """
    n = vfft.shape[-1]
    norm1 = jnp.asarray(norm1)
    norm2 = jnp.asarray(norm2)

    sq1 = jnp.sqrt(norm1)
    sq2 = jnp.sqrt(norm2)

    # per-template significance series u_i = q_i/√norm_i, rolled to
    # absolute trace indices; shapes [..., S, N] with S the bank slot
    # axis (S=1 in the pipeline)
    u1 = jnp.roll(dfft.ifft(phi1 * vfft, axis=-1).real * n,
                  pretrigger, axis=-1) / sq1[..., None]
    u2 = jnp.roll(dfft.ifft(phi2 * vfft, axis=-1).real * n,
                  pretrigger, axis=-1) / sq2[..., None]
    # c(Δ) = Re Σ_k φ1 s̃2 e^{+2πikΔ/N} / √(norm1·norm2) ∈ [−1, 1]
    c_all = (dfft.ifft(phi1 * s_fft2, axis=-1).real * n
             / (sq1 * sq2)[..., None])
    c0 = chi2_base(vfft, denom_inv)
    return _of1x2_core(u1, u2, c_all, sq1, sq2, c0, n, pretrigger, fs,
                       delta_window, delta_chunk, delay_order=False)


def of1x2_half(
    vr: jnp.ndarray,
    phi1_h: jnp.ndarray, norm1: jnp.ndarray,
    phi2_h: jnp.ndarray, norm2: jnp.ndarray,
    s_fft2_h: jnp.ndarray,
    denom_inv_h: jnp.ndarray,
    bin_w: jnp.ndarray,
    pretrigger: int,
    fs: float,
    n: int,
    delta_window: Optional[np.ndarray] = None,
    delta_chunk: int = 8,
) -> OF1x2Result:
    """Half-spectrum joint two-template OF fit; equal to :func:`of1x2`.

    Every spectral product here (φ_i·ṽ, φ₁·s̃₂) is Hermitian (real
    template, real trace, real noise PSD), so the q and overlap series
    come from irffts of the N//2+1 bins — half the transform work of
    :func:`of1x2`. The irfft output is in delay order; the pretrigger
    roll of :func:`of1x2` is folded into the final index conversion
    (delay_order=True core).
    """
    rdt = vr.real.dtype
    norm1 = jnp.asarray(norm1)
    norm2 = jnp.asarray(norm2)
    sq1 = jnp.sqrt(norm1)
    sq2 = jnp.sqrt(norm2)

    def inv(x):
        return dfft.irfft(x, n, axis=-1).astype(rdt)

    u1 = inv(phi1_h * vr) * n / sq1[..., None]           # delay order
    u2 = inv(phi2_h * vr) * n / sq2[..., None]
    c_all = inv(phi1_h * s_fft2_h) * n / (sq1 * sq2)[..., None]
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    return _of1x2_core(u1, u2, c_all, sq1, sq2, c0, n, pretrigger, fs,
                       delta_window, delta_chunk, delay_order=True)


def _of1x2_core(u1, u2, c_all, sq1, sq2, c0, n, pretrigger, fs,
                delta_window, delta_chunk, delay_order: bool):
    """Joint (d1, Δ) scan shared by :func:`of1x2` (absolute-index u
    series) and :func:`of1x2_half` (delay-ordered u series; the argmax
    index is converted to a t0 at the end). c_all is on the natural Δ
    axis in both cases."""
    rdt = u1.dtype

    # Δ values: ``signed`` carries the caller's branch (reported in
    # time_diff); ``deltas`` is the circular index used for rolling. For
    # the default full scan, shifts past n/2 are interpreted as negative.
    if delta_window is None:
        signed = np.arange(n, dtype=np.int64)
        signed = np.where(signed > n // 2, signed - n, signed)
    else:
        signed = np.asarray(delta_window, dtype=np.int64)
    deltas = (signed % n).astype(np.int32)
    signed = signed.astype(np.int32)
    # pad to a chunk multiple with repeats (duplicates can't win twice)
    chunk = max(1, min(int(delta_chunk), len(deltas)))
    pad = (-len(deltas)) % chunk
    if pad:
        deltas = np.concatenate([deltas, np.repeat(deltas[:1], pad)])
        signed = np.concatenate([signed, np.repeat(signed[:1], pad)])
    delta_blocks = jnp.asarray(deltas.reshape(-1, chunk))
    signed_blocks = jnp.asarray(signed.reshape(-1, chunk))

    neg_inf = jnp.asarray(-jnp.inf, rdt)
    batch_shape = u1.shape[:-1]

    def dchi2_for_delta(dl):
        # W12 carries e^{iω(d1−d2)} = e^{−iωΔ} → c evaluated at −Δ
        c = jnp.take(c_all, (n - dl) % n, axis=-1)           # [S]
        det = 1.0 - c * c                                    # [S]
        u2s = jnp.roll(u2, -dl, axis=-1)                     # [..., S, N]
        num = (u1 * u1 - 2.0 * c[..., None] * u1 * u2s + u2s * u2s)
        # degenerate W (templates coincide at this Δ): exclude
        ok = det > 1e-6
        safe = jnp.where(ok, det, 1.0)
        return jnp.where(ok[..., None], num / safe[..., None], neg_inf)

    def scan_body(carry, blocks):
        dls, sgs = blocks
        best_val, best_d1, best_dl, best_sg = carry
        vals = jax.vmap(dchi2_for_delta)(dls)                # [chunk, ..., N]
        cand_d1 = jnp.argmax(vals, axis=-1)                  # [chunk, ...]
        cand_val = jnp.max(vals, axis=-1)
        ci = jnp.argmax(cand_val, axis=0)                    # [...]
        cv = jnp.take_along_axis(cand_val, ci[None], axis=0)[0].astype(rdt)
        cd1 = jnp.take_along_axis(
            cand_d1, ci[None], axis=0)[0].astype(jnp.int32)
        cdl = dls[ci].astype(jnp.int32)
        csg = sgs[ci].astype(jnp.int32)
        upd = cv > best_val
        return (jnp.where(upd, cv, best_val),
                jnp.where(upd, cd1, best_d1),
                jnp.where(upd, cdl, best_dl),
                jnp.where(upd, csg, best_sg)), None

    init = (jnp.full(batch_shape, neg_inf, rdt),
            jnp.zeros(batch_shape, jnp.int32),
            jnp.zeros(batch_shape, jnp.int32),
            jnp.zeros(batch_shape, jnp.int32))
    (best_val, d1, dl, sg), _ = jax.lax.scan(
        scan_body, init, (delta_blocks, signed_blocks))

    # re-solve the 2x2 system at the winning (d1, Δ) in normalized form:
    # a1 = (u1 − c·u2)/(√norm1·(1−c²)), a2 = (u2 − c·u1)/(√norm2·(1−c²))
    d2 = (d1 + dl) % n
    u1b = jnp.take_along_axis(u1, d1[..., None], axis=-1)[..., 0]
    u2b = jnp.take_along_axis(u2, d2[..., None], axis=-1)[..., 0]
    idxr = (n - dl) % n                                      # [..., S]
    c = jnp.take_along_axis(
        jnp.broadcast_to(c_all, idxr.shape + (n,)),
        idxr[..., None], axis=-1)[..., 0]                    # [..., S]
    det = 1.0 - c * c
    det = jnp.where(jnp.abs(det) > 0, det, 1.0)
    amp1 = (u1b - c * u2b) / (sq1 * det)
    amp2 = (u2b - c * u1b) / (sq2 * det)

    chi2 = c0 - best_val

    if delay_order:
        # d1 is a delay index: absolute i = (d1 + pretrigger) mod n,
        # shift = i − pretrigger = d1 or d1 − n
        d_f = d1.astype(rdt)
        shift1 = jnp.where(d1 < n - pretrigger, d_f, d_f - n)
    else:
        shift1 = d1.astype(rdt) - pretrigger
    # d2 reported on the caller's branch: the signed Δ that won the scan
    shift2 = shift1 + sg.astype(rdt)
    t0_1 = shift1 / fs
    t0_2 = shift2 / fs
    return OF1x2Result(amp1, amp2, t0_1, t0_2, t0_2 - t0_1, chi2)
