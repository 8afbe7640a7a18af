"""Batched time-domain pulse fits (rftau).

Device equivalent of FeatureExtractors.rftau
(detprocess/core/algorithms.py:1345-1430): RC-filter the trace, estimate
the baseline just before the pulse, then fit a two-pole pulse
``amp·(exp(−(t−t0)/ftau) − exp(−(t−t0)/rtau))`` over a window around the
nominal trigger, per event. The reference runs scipy.curve_fit per event in
Python; here the fit is a vmapped Levenberg–Marquardt over the whole batch.

Times are in SAMPLES (the reference's convention for rtau/ftau/t0).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from detprocess_jax.ops import lm, spectral

LOWER_WINDOW = 800    # samples before t0 (algorithms.py:1401)
UPPER_WINDOW = 1600   # samples after t0


class RFTauResult(NamedTuple):
    risetime: jnp.ndarray   # samples
    falltime: jnp.ndarray   # samples
    amplitude: jnp.ndarray  # max of the fitted pulse
    chisq: jnp.ndarray      # mean squared residual over the window


def _twopole(t, rtau, ftau, amp, t0):
    tp = t - t0
    pulse = amp * (jnp.exp(-tp / jnp.abs(ftau))
                   - jnp.exp(-tp / jnp.abs(rtau)))
    return jnp.where(tp > 0, jnp.maximum(pulse, 0.0), 0.0)


def rftau(traces: jnp.ndarray, fs: float,
          rtau0: float = 30.0, ftau0: float = 100.0,
          t0_index: int | None = None,
          rc_cutoff: float = 50e3,
          max_iter: int = 40) -> RFTauResult:
    """Fit rise/fall times on a batch [B, N]."""
    b, n = traces.shape
    if t0_index is None:
        t0_index = n // 2 - 10
    lw = min(LOWER_WINDOW, t0_index)
    uw = min(UPPER_WINDOW, n - t0_index)

    # RC low-pass (reference: 1-pole butter lfilter; we use the zero-phase
    # frequency-domain version shared with the trigger path)
    filtered = spectral.lowpass_filter(traces, rc_cutoff, fs, order=1)
    base = jnp.mean(filtered[:, t0_index - lw:t0_index], axis=-1,
                    keepdims=True)
    fb = filtered - base

    window = fb[:, t0_index - lw:t0_index + uw]
    t_win = jnp.arange(t0_index - lw, t0_index + uw, dtype=traces.dtype)
    amp0 = jnp.max(window, axis=-1)

    def residual(params, y):
        return _twopole(t_win, params[0], params[1], params[2],
                        params[3]) - y

    x0 = jnp.stack([
        jnp.full((b,), rtau0, traces.dtype),
        jnp.full((b,), ftau0, traces.dtype),
        amp0,
        jnp.full((b,), float(t0_index), traces.dtype),
    ], axis=-1)

    res = lm.batched_lm(residual, x0, (window,), max_iter=max_iter)
    params = res.params
    rtau_fit = jnp.abs(params[:, 0])
    ftau_fit = jnp.abs(params[:, 1])

    t_full = jnp.arange(n, dtype=traces.dtype)
    fitted = jax.vmap(
        lambda p: _twopole(t_full, p[0], p[1], p[2], p[3]))(params)
    amplitude = jnp.max(fitted, axis=-1)
    chisq = 2.0 * res.cost / (lw + uw)
    return RFTauResult(rtau_fit, ftau_fit, amplitude, chisq)
