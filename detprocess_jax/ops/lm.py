"""Batched Levenberg–Marquardt least-squares in JAX.

Replaces the scipy/lmfit/iminuit fitting the reference delegates to QETpy
(dIdV 1/2/3-pole fits, noise-model fits, rftau pulse fits — SURVEY.md §2.3).
The batched angle: fits are *vmapped over batches* (bias points,
channels, events) — each individual problem is tiny, so batching is where
the win is (SURVEY.md §7 table).

Fixed-iteration trust-region LM with analytic Jacobians via jax.jacfwd:
- residual function r(params, *args) -> [nres] (real; complex models stack
  re/im — see ``complex_residuals``)
- damped normal equations solved with jnp.linalg.solve on (JᵀJ + λ·diag)
- λ adapted multiplicatively; all control flow is lax.while-free
  (fori_loop with accept/reject masking) so it jits and vmaps cleanly.


Reference role: replaces lmfit Model.fit (detprocess
core/noisemodel.py:617-634, :884-893), scipy curve_fit
(core/algorithms.py:1417 rftau) and qetpy's least-squares dIdV
fitting with one vmappable fixed-iteration implementation.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LMResult(NamedTuple):
    params: jnp.ndarray       # [P]
    cost: jnp.ndarray         # scalar — final ½·Σr²
    cov: jnp.ndarray          # [P, P] — covariance estimate (JᵀJ)⁻¹·s²
    niter: jnp.ndarray        # iterations actually accepted
    success: jnp.ndarray      # bool


def _cost(residual_fn, params, args):
    r = residual_fn(params, *args)
    return 0.5 * jnp.sum(r * r)


def levenberg_marquardt(
    residual_fn: Callable,
    x0: jnp.ndarray,
    args: tuple = (),
    max_iter: int = 50,
    lambda0: float = 1e-3,
    lambda_up: float = 10.0,
    lambda_down: float = 0.3,
) -> LMResult:
    """Minimize ½‖r(x)‖² from x0. All shapes static; vmap over x0/args for
    batched fits (fixed max_iter scan — no data-dependent early exit, the
    lambda damping simply stops accepting steps once converged).

    Parameters are internally rescaled by |x0| so strongly heterogeneous
    magnitudes (e.g. resistances ~0.1 Ω vs time constants ~1e-4 s) stay
    well-conditioned — important for float32 execution. Components whose
    initial guess is exactly 0 get unit scale (a tiny clip value would
    effectively freeze them).
    """
    scale = jnp.where(jnp.abs(x0) > 1e-30, jnp.abs(x0), 1.0)
    user_residual = residual_fn

    def residual_scaled(y, *a):
        return user_residual(y * scale, *a)

    residual_fn = residual_scaled
    x0 = x0 / scale

    jac_fn = jax.jacfwd(residual_fn)

    def step(state, _):
        x, lam, best_cost, accepted = state
        r = residual_fn(x, *args)
        jacm = jac_fn(x, *args)                        # [nres, P]
        g = jacm.T @ r                                 # gradient
        h = jacm.T @ jacm
        damped = h + lam * jnp.diag(jnp.clip(jnp.diag(h), 1e-14))
        delta = jnp.linalg.solve(
            damped + 1e-30 * jnp.eye(h.shape[0], dtype=h.dtype), -g)
        x_new = x + delta
        new_cost = _cost(residual_fn, x_new, args)
        improve = (new_cost < best_cost) & jnp.all(jnp.isfinite(x_new))
        x = jnp.where(improve, x_new, x)
        best_cost = jnp.where(improve, new_cost, best_cost)
        lam = jnp.where(improve, lam * lambda_down, lam * lambda_up)
        lam = jnp.clip(lam, 1e-12, 1e12)
        accepted = accepted + improve.astype(jnp.int32)
        return (x, lam, best_cost, accepted), None

    c0 = _cost(residual_fn, x0, args)
    init = (x0, jnp.asarray(lambda0, x0.dtype), c0, jnp.asarray(0))
    (x, lam, cost, accepted), _ = jax.lax.scan(step, init, None,
                                               length=max_iter)

    # covariance: (JᵀJ)⁻¹ · 2·cost/(nres − P), unscaled back to user params
    r = residual_fn(x, *args)
    jacm = jac_fn(x, *args)
    h = jacm.T @ jacm
    nres = r.shape[0]
    p = x.shape[0]
    dof = jnp.maximum(nres - p, 1)
    s2 = 2.0 * cost / dof
    cov_scaled = jnp.linalg.pinv(h) * s2
    cov = cov_scaled * scale[:, None] * scale[None, :]
    return LMResult(params=x * scale, cost=cost, cov=cov, niter=accepted,
                    success=jnp.isfinite(cost))


def complex_residuals(model_fn: Callable) -> Callable:
    """Wrap a complex-valued model into stacked re/im residuals.

    model_fn(params, x, data, weights) -> complex model values;
    the residual is weights·(model − data) split into (re, im).
    """
    def residual(params, x, data, weights):
        m = model_fn(params, x)
        diff = (m - data) * weights
        return jnp.concatenate([diff.real, diff.imag])
    return residual


def batched_lm(residual_fn: Callable, x0_batch: jnp.ndarray,
               args_batch: tuple, **kwargs) -> LMResult:
    """vmap LM over a leading batch axis of x0 and every element of args."""
    fn = partial(levenberg_marquardt, residual_fn, **kwargs)
    return jax.vmap(lambda x0, *a: fn(x0, args=a))(x0_batch, *args_batch)
