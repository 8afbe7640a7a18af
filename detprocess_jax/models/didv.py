"""dIdV complex-admittance models, fits, and derived TES quantities.

Batched replacement for the QETpy DIDV stack the reference delegates to
(qetpy.DIDV / didvinitfromdata / converttotesvalues /
get_biasparams_ilg / get_dPdI_with_uncertainties / energy_resolution —
reference call sites: detprocess/core/didv.py:489-904, SURVEY.md §2.3).

Model (Irwin–Hilton small-signal TES theory, one- and two-block thermal):

    dVdI₁(ω) = A·(1 + iωτ₂)
    dVdI₂(ω) = A·(1 + iωτ₂) + B/(1 + iωτ₁)
    dVdI₃(ω) = A·(1 + iωτ₂) + B/(1 + iωτ₁ − C/(1 + iωτ₃))

with the standard parameter identifications (for known R0, Rl = Rsh+Rp):

    A  = Rl + R0(1+β)          τ₂ = L/A
    B  = R0·l·(2+β)/(1−l)      τ₁ = τ₀/(1−l)

Inversions:  β = (A−Rl)/R0 − 1,  l = B/(B + R0(2+β)),  L = A·τ₂,
τ₀ = τ₁(1−l); the 3-pole C/τ₃ give the two-block ratio gratio = C and
second time constant τ₃ (reported as-is, qetpy ssp_light convention).

Power-to-current responsivity (derived from the same linear system):

    dPdI(ω) = −I0·R0(2+β)·[1 + A(1+iωτ₂)·D(ω)/B]
    D₂(ω) = 1+iωτ₁,    D₃(ω) = 1+iωτ₁ − C/(1+iωτ₃)

Energy resolution:  σ_E = [∫ 4|p̃(f)|²/S_P(f) df]^(−1/2) with the
power-domain template p̃ = s̃·dPdI and power-referred noise
S_P = S_I·|dPdI|².

Parameter covariances propagate through every derived quantity with
jax.jacfwd — replacing QETpy's hand-written uncertainty formulas.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from detprocess_jax.ops import lm

KB = 1.380649e-23  # J/K


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def dvdi_1pole(params, freqs):
    a, tau2 = params
    return a * (1 + 2j * jnp.pi * freqs * tau2)


def dvdi_2pole(params, freqs):
    a, b, tau1, tau2 = params
    w = 2j * jnp.pi * freqs
    return a * (1 + w * tau2) + b / (1 + w * tau1)


def dvdi_3pole(params, freqs):
    a, b, c, tau1, tau2, tau3 = params
    w = 2j * jnp.pi * freqs
    return a * (1 + w * tau2) + b / (1 + w * tau1 - c / (1 + w * tau3))


DVDI_MODELS = {1: dvdi_1pole, 2: dvdi_2pole, 3: dvdi_3pole}
NPARAMS = {1: 2, 2: 4, 3: 6}


def didv_model(params, freqs, poles: int):
    return 1.0 / DVDI_MODELS[poles](params, freqs)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

class DIDVFit(NamedTuple):
    params: np.ndarray     # raw fit params (A, B, C, τ1, τ2, τ3 subset)
    cov: np.ndarray
    cost: float
    poles: int


def _didv_residual(poles):
    # data arrives as split (re, im) real arrays (the package's real
    # pytree format for complex data, see ops/filterbank.split_complex)
    def residual(params, freqs, data_re, data_im, weights):
        model = didv_model(params, freqs, poles)
        diff_re = (model.real - data_re) * weights
        diff_im = (model.imag - data_im) * weights
        return jnp.concatenate([diff_re, diff_im])
    return residual


def fit_didv_prior(freqs: np.ndarray, didv_meas: np.ndarray,
                   prior_mean: np.ndarray, prior_cov: np.ndarray,
                   poles: int = 2,
                   weights: Optional[np.ndarray] = None,
                   max_iter: int = 200) -> DIDVFit:
    """Prior-constrained dIdV fit (qetpy.DIDVPriors equivalent —
    reference use: core/didv.py:867-904, ``dofit_prior``).

    Gaussian priors on the raw parameters enter as extra residuals
    ``L⁻¹(p − p₀)`` with L the Cholesky factor of the prior covariance, so
    the LM cost is χ²_data/2 + ½(p−p₀)ᵀC⁻¹(p−p₀).
    """
    freqs = np.asarray(freqs)
    mask = freqs != 0
    prior_mean = np.asarray(prior_mean, dtype=float)
    chol = np.linalg.cholesky(np.asarray(prior_cov, dtype=float))
    chol_inv = np.linalg.inv(chol)

    base = _didv_residual(poles)

    def residual(params, f, d_re, d_im, w, mu, li):
        r = base(params, f, d_re, d_im, w)
        r_prior = li @ (params - mu)
        return jnp.concatenate([r, r_prior])

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        f = jnp.asarray(freqs[mask])
        d_host = np.asarray(didv_meas)[mask]
        d_re = jnp.asarray(np.ascontiguousarray(d_host.real))
        d_im = jnp.asarray(np.ascontiguousarray(d_host.imag))
        w = jnp.asarray((np.ones_like(freqs)
                         if weights is None else np.asarray(weights))[mask])
        res = lm.levenberg_marquardt(
            residual, jnp.asarray(prior_mean, f.dtype),
            args=(f, d_re, d_im, w, jnp.asarray(prior_mean, f.dtype),
                  jnp.asarray(chol_inv, f.dtype)),
            max_iter=max_iter)
    return DIDVFit(params=np.asarray(res.params), cov=np.asarray(res.cov),
                   cost=float(res.cost), poles=poles)


def guess_params(freqs, didv_meas, poles: int) -> list:
    """Data-driven initial guesses (several candidates — the dVdI surface
    has distinct ETF regimes: loop gain below/above 1 flips the signs of B
    and τ₁, so a multi-start is required, as in qetpy's staged guesses).
    """
    freqs = np.asarray(freqs)
    dvdi = 1.0 / np.asarray(didv_meas)
    order = np.argsort(np.abs(freqs))
    f_s = np.abs(freqs)[order]
    dv_s = dvdi[order]

    # dc value of dVdI → A + B
    dc = float(np.mean(dv_s[: max(len(f_s) // 50, 2)].real))
    # A from the mid/high-frequency real plateau (before ωτ₂ dominates)
    hi = dv_s[int(len(f_s) * 0.5): int(len(f_s) * 0.9)]
    a0 = float(np.median(hi.real)) if len(hi) else float(dv_s.real.mean())
    a0 = max(abs(a0), 1e-4)
    # τ₂ from the high-frequency imaginary slope: Im dVdI ≈ A·ωτ₂
    tail = slice(int(len(f_s) * 0.7), len(f_s))
    with np.errstate(divide="ignore", invalid="ignore"):
        tau2_est = np.median(
            dv_s[tail].imag / (2 * np.pi * f_s[tail] * a0))
    tau2_0 = float(abs(tau2_est)) if np.isfinite(tau2_est) else 1e-6
    tau2_0 = min(max(tau2_0, 1e-9), 1e-3)

    if poles == 1:
        return [np.array([a0, tau2_0]), np.array([abs(dc), tau2_0])]

    b0 = dc - a0
    tau1_scales = (1e-4, 1e-3, 1e-2)
    sign = np.sign(b0) if b0 != 0 else 1.0
    guesses = []
    for s in tau1_scales:
        if poles == 2:
            guesses.append(np.array([a0, b0, sign * s, tau2_0]))
            guesses.append(np.array([a0, -b0, -sign * s, tau2_0]))
        else:
            guesses.append(np.array([a0, b0, 0.2, sign * s, tau2_0,
                                     s / 10]))
            guesses.append(np.array([a0, b0 * 0.8, -0.2, sign * s, tau2_0,
                                     s / 10]))
    return guesses


def fit_didv(freqs: np.ndarray, didv_meas: np.ndarray,
             poles: int = 2,
             weights: Optional[np.ndarray] = None,
             guess: Optional[np.ndarray] = None,
             max_iter: int = 200) -> DIDVFit:
    """Fit the complex dIdV(f) data with the requested pole model.

    Only nonzero frequencies participate (DC carries the offset, handled
    separately — qetpy DIDV convention).
    """
    freqs = np.asarray(freqs)
    mask = freqs != 0
    if guess is not None:
        guesses = [np.asarray(guess)]
    else:
        guesses = guess_params(freqs[mask], np.asarray(didv_meas)[mask],
                               poles)
    residual = _didv_residual(poles)

    # analysis fits are tiny; run them on the host CPU device (there is
    # nothing to gain from the accelerator here)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        f = jnp.asarray(freqs[mask])
        d_host = np.asarray(didv_meas)[mask]
        d_re = jnp.asarray(np.ascontiguousarray(d_host.real))
        d_im = jnp.asarray(np.ascontiguousarray(d_host.imag))
        w = jnp.asarray((np.ones_like(freqs)
                         if weights is None else np.asarray(weights))[mask])
        dtype = f.dtype
        best = None
        for g in guesses:
            res = lm.levenberg_marquardt(
                residual, jnp.asarray(g, dtype), args=(f, d_re, d_im, w),
                max_iter=max_iter)
            if best is None or float(res.cost) < float(best.cost):
                best = res
    return DIDVFit(params=np.asarray(best.params), cov=np.asarray(best.cov),
                   cost=float(best.cost), poles=poles)


# ---------------------------------------------------------------------------
# small-signal parameters
# ---------------------------------------------------------------------------

def smallsignal_from_fit(params: jnp.ndarray, r0, rl, poles: int):
    """(A, B, [C], τ1, τ2, [τ3]) → dict of small-signal params (jittable)."""
    if poles == 1:
        a, tau2 = params[0], params[1]
        return {"rtot": a, "L": a * tau2}
    if poles == 2:
        a, b, tau1, tau2 = params[0], params[1], params[2], params[3]
    else:
        a, b, tau1, tau2 = params[0], params[1], params[3], params[4]
    beta = (a - rl) / r0 - 1.0
    l = b / (b + r0 * (2.0 + beta))
    ind = a * tau2
    tau0 = tau1 * (1.0 - l)
    out = {"beta": beta, "l": l, "L": ind, "tau0": tau0,
           "A": a, "B": b, "tau1": tau1, "tau2": tau2}
    if poles == 3:
        out["gratio"] = params[2]
        out["tau3"] = params[5]
    return out


def smallsignal_with_errors(fit: DIDVFit, r0: float, rl: float) -> dict:
    """Small-signal params + 1σ errors propagated from the fit covariance
    via the exact Jacobian (replaces qetpy hand-derived error formulas)."""
    keys_fn = lambda p: smallsignal_from_fit(p, r0, rl, fit.poles)
    vals = keys_fn(jnp.asarray(fit.params))
    names = list(vals.keys())

    def vector_fn(p):
        d = keys_fn(p)
        return jnp.stack([d[k] for k in names])

    jac = np.asarray(jax.jacfwd(vector_fn)(jnp.asarray(fit.params)))
    cov = jac @ fit.cov @ jac.T
    out = {k: float(vals[k]) for k in names}
    out.update({f"{k}_err": float(np.sqrt(max(cov[i, i], 0.0)))
                for i, k in enumerate(names)})
    out["cov"] = cov
    return out


def didv_falltimes(fit: DIDVFit) -> np.ndarray:
    """True dIdV pole time constants ("falltimes": τ₊, τ₋, τ₃ —
    qetpy convention, reported by the reference at
    core/ivsweep.py:1845-1851 and process/filterprocess.py:1013-1016).

    These are NOT the raw fit parameters τ₁/τ₂/τ₃ but the poles of the
    rational function dIdV(s) = 1/dVdI(s), s = iω: the roots of the
    dVdI numerator polynomial in s. For the 2-pole model

        dVdI·(1+sτ₁) = A τ₁τ₂ s² + A(τ₁+τ₂) s + (A+B)

    and for the 3-pole model (denominator D = (1+sτ₁)(1+sτ₃) − C)

        dVdI·D = A τ₂τ₁τ₃ s³ + A(τ₁τ₃ + τ₂(τ₁+τ₃)) s²
                 + [A(τ₁+τ₃+τ₂(1−C)) + Bτ₃] s + [A(1−C) + B].

    Each root s_i contributes exp(s_i t); the time constants are
    |1/Re s_i|, sorted ascending (τ₊ = fastest). Returns a length-3
    array (NaN-padded below 3 poles).
    """
    p = np.asarray(fit.params, dtype=float)
    if fit.poles == 1:
        return np.array([abs(p[1]), np.nan, np.nan])
    if fit.poles == 2:
        a, b, tau1, tau2 = p
        coeffs = [a * tau1 * tau2, a * (tau1 + tau2), a + b]
    else:
        a, b, c, tau1, tau2, tau3 = p
        coeffs = [a * tau2 * tau1 * tau3,
                  a * (tau1 * tau3 + tau2 * (tau1 + tau3)),
                  a * ((tau1 + tau3) + tau2 * (1.0 - c)) + b * tau3,
                  a * (1.0 - c) + b]
    roots = np.roots(coeffs)
    with np.errstate(divide="ignore"):
        taus = np.sort(np.abs(1.0 / np.real(roots)))
    out = np.full(3, np.nan)
    out[:len(taus)] = taus
    return out


def biasparams_ilg(fit_params, rl: float, rsh: float, ibias: float,
                   poles: int = 2) -> dict:
    """Infinite-loop-gain bias point (qetpy.get_biasparams_ilg,
    reference use: core/didv.py:646-744).

    In the l→∞ limit dVdI(0) → Rl − R0, so R0 = Rl − dVdI(0); the DC bias
    point follows from the shunt-divided bias current.
    """
    p = np.asarray(fit_params)
    if poles == 2:
        dvdi0 = p[0] + p[1]
    elif poles == 3:
        dvdi0 = p[0] + p[1] / (1.0 - p[2])
    else:
        dvdi0 = p[0]
    r0 = rl - dvdi0
    i0 = ibias * rsh / (r0 + rl)
    v0 = i0 * r0
    p0 = i0 * v0
    return {"r0": float(r0), "i0": float(i0), "v0": float(v0),
            "p0": float(p0)}


# ---------------------------------------------------------------------------
# dPdI and energy resolution
# ---------------------------------------------------------------------------

def dpdi_from_fit(params, freqs, i0: float, r0: float, rl: float,
                  poles: int = 2):
    """dPdI(ω) from the fit parameters (docstring derivation)."""
    w = 2j * jnp.pi * jnp.asarray(freqs)
    if poles == 2:
        a, b, tau1, tau2 = params[0], params[1], params[2], params[3]
        d = 1 + w * tau1
    elif poles == 3:
        a, b, c, tau1, tau2, tau3 = (params[0], params[1], params[2],
                                     params[3], params[4], params[5])
        d = 1 + w * tau1 - c / (1 + w * tau3)
    else:
        raise ValueError("dPdI requires a 2- or 3-pole fit")
    beta = (a - rl) / r0 - 1.0
    r0_2beta = r0 * (2.0 + beta)
    return -i0 * r0_2beta * (1.0 + a * (1 + w * tau2) * d / b)


def dpdi_with_uncertainties(fit: DIDVFit, freqs, i0: float, r0: float,
                            rl: float):
    """(dPdI [complex], σ|dPdI| [real]) with covariance propagation.
    Runs on the host CPU device (eager complex math)."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        f = jnp.asarray(np.asarray(freqs))

        def mag_fn(p):
            return jnp.abs(dpdi_from_fit(p, f, i0, r0, rl, fit.poles))

        dpdi = np.asarray(dpdi_from_fit(jnp.asarray(fit.params), f, i0, r0,
                                        rl, fit.poles))
        jac = np.asarray(jax.jacfwd(mag_fn)(jnp.asarray(fit.params)))
    var = np.einsum("fi,ij,fj->f", jac, fit.cov, jac)
    return dpdi, np.sqrt(np.clip(var, 0, None))


def convert_template_to_power(template: np.ndarray, dpdi: np.ndarray,
                              fs: float = None) -> np.ndarray:
    """Current-domain template → power-domain template via dPdI(f)
    (qetpy.convert_template_to_power equivalent).

    ``fs`` is accepted for call-site symmetry with the qetpy API but the
    bin-by-bin DFT product s̃·dPdI needs no sampling-rate normalization
    (fft/ifft factors cancel); ``dpdi`` must already be tabulated on the
    template's two-sided frequency axis.
    """
    s_fft = np.fft.fft(np.asarray(template))
    p_fft = s_fft * np.asarray(dpdi)
    return np.real(np.fft.ifft(p_fft))


def energy_resolution(template: np.ndarray, psd: np.ndarray,
                      dpdi: np.ndarray, fs: float) -> float:
    """Baseline optimal-filter energy resolution σ_E [J for SI inputs]
    (qetpy.utils.energy_resolution equivalent; reference use:
    core/didv.py:798-851).

    The current-domain template (unit peak) is converted to the power
    domain with dPdI; the OF amplitude resolution on the power pulse is

        σ_a = [ Σ_{k≠0} |p̃_k|² / S_P(f_k) · df ]^(−1/2)

    with p̃ the continuous-FT of the unit-amplitude power pulse [J] and
    S_P = S_I·|dPdI|² the two-sided power-referred noise [W²/Hz] (the sum
    runs over both ± frequencies — equal to the classic one-sided
    ∫4|p̃|²/S_P^folded form). The energy resolution is σ_E = σ_a·E₀ with
    E₀ = ∫p dt the energy per unit amplitude.
    """
    template = np.asarray(template, dtype=float)
    n = len(template)
    df = fs / n
    dpdi = np.asarray(dpdi)
    p_fft = np.fft.fft(template) * dpdi / fs   # continuous FT of power pulse
    s_p = np.asarray(psd) * np.abs(dpdi) ** 2
    mask = np.ones(n, dtype=bool)
    mask[0] = False
    denom = np.sum(np.abs(p_fft[mask]) ** 2 / s_p[mask]) * df
    sigma_a = 1.0 / np.sqrt(denom)
    e0 = abs(energy_normalization(template, dpdi, fs))
    return float(sigma_a * e0)


def energy_normalization(template: np.ndarray, dpdi: np.ndarray,
                         fs: float) -> float:
    """Energy per unit (current) amplitude of a template: the integral of
    the power-domain template (qetpy.get_energy_normalization —
    reference use: core/salting.py:373)."""
    power_template = convert_template_to_power(template, dpdi, fs)
    return float(np.trapezoid(power_template, dx=1.0 / fs))
