"""dIdV square-wave lock-in processing.

Device equivalent of qetpy.DIDV.processtraces (reference call sites:
core/didv.py:1635-1645, process/ivprocess.py:606-661): average raw traces
over whole square-wave periods after quality cuts, then measure the complex
dIdV(f) as the ratio of the response FFT to the excitation FFT at the
square-wave's odd harmonics.

Conventions:
- ``sgfreq`` [Hz] square-wave frequency; the trace must hold an integer
  number of periods at ``fs`` (period_bins = fs/sgfreq).
- ``sgamp`` [A] is the peak-to-peak/2 amplitude of the bias-current square
  wave through the shunt; the voltage excitation is ``δV = sgamp·rsh``.
- The square-wave phase is estimated from the first harmonic of the mean
  response (qetpy estimates it by correlation).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from detprocess_jax.ops import autocuts as cuts


class DIDVData(NamedTuple):
    freqs: np.ndarray        # odd-harmonic frequencies [Hz]
    didv: np.ndarray         # complex dIdV at those frequencies [1/Ω]
    weights: np.ndarray      # per-frequency fit weights (1/σ)
    mean_period: np.ndarray  # period-folded mean response [A]
    offset: float            # DC current offset [A]
    offset_err: float
    fs: float
    sgfreq: float
    sgamp: float
    rsh: float
    nb_periods: int
    nb_traces_kept: int


def fold_periods(traces: np.ndarray, period_bins: int) -> np.ndarray:
    """[B, N] → [B·nper, period_bins] whole-period segments."""
    b, n = traces.shape
    nper = n // period_bins
    return traces[:, : nper * period_bins].reshape(b * nper, period_bins)


def process_didv_traces(traces: np.ndarray, fs: float, sgfreq: float,
                        sgamp: float, rsh: float,
                        nsigma_cut: float = 2.5,
                        apply_cuts: bool = True) -> DIDVData:
    """Lock-in average + dIdV(f) measurement from raw traces [B, N]."""
    traces = np.asarray(traces, dtype=np.float64)
    period_bins = int(round(fs / sgfreq))
    if abs(fs / sgfreq - period_bins) > 1e-6:
        raise ValueError(
            f"square-wave period ({fs/sgfreq:.3f} samples) must be an "
            f"integer number of samples")

    if apply_cuts and traces.shape[0] > 3:
        mask = np.asarray(cuts.autocuts_didv(jnp.asarray(traces),
                                             nsigma=nsigma_cut))
        if mask.sum() >= 2:
            traces = traces[mask]
    nkept = traces.shape[0]

    periods = fold_periods(traces, period_bins)
    mean_period = periods.mean(axis=0)
    offset = float(mean_period.mean())
    offset_err = float(periods.mean(axis=-1).std()
                       / np.sqrt(max(periods.shape[0], 1)))

    resp_fft = np.fft.fft(mean_period - offset)
    n = period_bins

    # ideal ±sgamp/2 square wave (current through the shunt → volts)
    t = np.arange(n)
    square = np.where(t < n // 2, 0.5, -0.5) * (sgamp * rsh)

    # Square-wave phase: the response switches at each edge through the
    # fast electrical time constant. Detect the edge with a box-difference
    # matched filter (mean of next W samples − mean of previous W), which
    # peaks at the step and gains √W in SNR over the raw derivative, then
    # refine to the largest single-sample step nearby. (Cross-correlation
    # with the square is biased by the slow thermal settling; the raw
    # derivative alone is too noisy.)
    w_box = max(min(32, n // 8), 1)
    kernel = np.concatenate([np.full(w_box, 1.0 / w_box),
                             np.full(w_box, -1.0 / w_box)])
    # circular correlation: edge score at position i uses samples
    # [i−W, i+W) around the candidate edge i
    pad = np.concatenate([mean_period, mean_period[: 2 * w_box]])
    score = np.correlate(pad, kernel[::-1], mode="valid")[: n]
    shift = (int(np.argmax(np.abs(score))) + w_box) % n
    square = np.roll(square, shift)
    sq_fft = np.fft.fft(square)

    # odd harmonics below Nyquist
    harmonics = np.arange(1, n // 2, 2)
    freqs = harmonics * sgfreq
    didv = resp_fft[harmonics] / sq_fft[harmonics]

    # per-harmonic uncertainty from the scatter across periods (needed for
    # the sign test below and returned as fit weights)
    per_fft = np.fft.fft(periods - periods.mean(axis=-1, keepdims=True),
                         axis=-1)
    scatter = np.std(per_fft[:, harmonics], axis=0) / np.sqrt(
        max(periods.shape[0], 1))
    denom = np.abs(sq_fft[harmonics])
    sigma = np.clip(np.abs(scatter) / np.clip(denom, 1e-30, None), 1e-30,
                    None)
    weights = 1.0 / sigma

    # The detected edge may be the opposite switching edge (half-period
    # ambiguity = a global sign flip at odd harmonics). Physically
    # Re dVdI → Rl+R0(1+β) > 0 once ωτ₁ ≳ 1; test a weighted mid-band
    # (low harmonics can have Re dVdI < 0 at high loop gain, the top ones
    # are noise-dominated).
    nh = len(didv)
    lo = max(3, nh // 60)
    hi = max(lo + 5, nh // 6)
    if lo >= nh:
        # very short square-wave periods give only a few odd harmonics —
        # fall back to every available harmonic for the sign test
        lo, hi = 0, nh
    band = slice(lo, min(hi, nh))
    re_dvdi = (1.0 / didv[band]).real
    if np.average(re_dvdi, weights=weights[band] ** 2) < 0:
        didv = -didv
        square = -square
        sq_fft = -sq_fft

    return DIDVData(freqs=freqs, didv=didv, weights=weights,
                    mean_period=mean_period, offset=offset,
                    offset_err=offset_err, fs=fs, sgfreq=sgfreq,
                    sgamp=sgamp, rsh=rsh,
                    nb_periods=periods.shape[0], nb_traces_kept=nkept)
