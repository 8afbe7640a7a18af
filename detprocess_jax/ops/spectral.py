"""Spectral device kernels: FFT helpers, Welch PSD/CSD estimation, spectrum
folding, zero-phase low-pass filtering.

Conventions (these are the QETpy conventions the reference relies on —
see SURVEY.md §2.3 and detprocess/core/noise.py:344-346):

- PSDs are **two-sided**, in units of A²/Hz, on the numpy ``fftfreq`` axis.
- ``psd = mean_over_traces |FFT(x)|²| / (N · fs)`` so that
  ``Var(x_t) = Σ_k psd_k · fs / N`` (Parseval).
- CSD: ``csd[i, j, k] = mean( FFT(x_i)_k · conj(FFT(x_j)_k) ) / (N · fs)`` —
  an [nchan, nchan, nfreq] Hermitian array per frequency.

All kernels are jit-friendly, batched, and dtype-polymorphic: float32 inputs
give complex64 FFTs (device path); float64 inputs (CPU golden tests) give
complex128.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from detprocess_jax.ops import fft as dfft


def fold_spectrum(psd: jnp.ndarray, n: int | None = None):
    """Fold a two-sided PSD (last axis) onto positive frequencies.

    Doubles all bins except DC (and Nyquist for even N). Device analog of
    detprocess_jax.utils.freq.fold_spectrum.
    """
    n = psd.shape[-1] if n is None else n
    nfold = n // 2 + 1
    folded = psd[..., :nfold]
    if n % 2 == 0:
        scale = jnp.concatenate(
            [jnp.ones((1,), psd.dtype),
             jnp.full((nfold - 2,), 2, psd.dtype),
             jnp.ones((1,), psd.dtype)]
        )
    else:
        scale = jnp.concatenate(
            [jnp.ones((1,), psd.dtype), jnp.full((nfold - 1,), 2, psd.dtype)]
        )
    return folded * scale


def periodogram(traces: jnp.ndarray, fs: float) -> jnp.ndarray:
    """Two-sided periodogram of each trace: |FFT|² / (N·fs). Shape preserved."""
    n = traces.shape[-1]
    vfft = dfft.fft(traces, axis=-1)
    return (jnp.abs(vfft) ** 2) / (n * fs)


def welch_psd(traces: jnp.ndarray, fs: float, window: str | None = None):
    """Average two-sided PSD over the leading (trace) axis.

    Parameters
    ----------
    traces : [ntraces, nsamples] (or [..., ntraces, nsamples])
    fs : sampling rate (Hz)
    window : None (boxcar, the QETpy default used by the reference at
        detprocess/core/noise.py:344) or 'hann'. Windowed estimates are
        normalized by the window power so white-noise levels are unbiased.

    Returns two-sided PSD with the trace axis reduced.
    """
    n = traces.shape[-1]
    if window == "hann":
        w = jnp.hanning(n).astype(traces.dtype)
        scale = 1.0 / jnp.mean(w**2)
        traces = traces * w
    elif window is None:
        scale = 1.0
    else:
        raise ValueError(f"unknown window: {window}")
    pxx = periodogram(traces, fs) * scale
    return jnp.mean(pxx, axis=-2)


def welch_csd(traces: jnp.ndarray, fs: float, window: str | None = None):
    """Cross-spectral density matrix averaged over traces.

    Parameters
    ----------
    traces : [ntraces, nchan, nsamples]

    Returns
    -------
    csd : [nchan, nchan, nsamples] complex, Hermitian in the channel axes:
        ``csd[i, j] = mean(FFT_i · conj(FFT_j)) / (N·fs)``.
    """
    n = traces.shape[-1]
    if window == "hann":
        w = jnp.hanning(n).astype(traces.dtype)
        scale = 1.0 / jnp.mean(w**2)
        traces = traces * w
    elif window is None:
        scale = 1.0
    else:
        raise ValueError(f"unknown window: {window}")
    vfft = dfft.fft(traces, axis=-1)  # [B, C, N]
    csd = dfft.einsum("bik,bjk->ijk", vfft, jnp.conj(vfft))
    return csd * (scale / (n * fs * traces.shape[0]))


@partial(jax.jit, static_argnames=("order",))
def lowpass_filter(traces: jnp.ndarray, cut_off_freq: float, fs: float,
                   order: int = 2) -> jnp.ndarray:
    """Zero-phase Butterworth low-pass via frequency-domain multiply.

    The reference uses qetpy.utils.lowpassfilter (scipy butter+filtfilt) for
    the 50 kHz saturation-veto trace (detprocess/core/oftrigger.py:627-633).
    filtfilt's transfer function is |H(f)|² with zero phase; we apply exactly
    that in the Fourier domain: gain = 1 / (1 + (f/fc)^(2·order)).
    This is circular rather than reflect-padded, which only differs near the
    trace edges (excluded from triggering anyway).
    """
    n = traces.shape[-1]
    # |k/n| is fs-free so the frequency grid stays static (fs and the
    # cutoff may be traced); |f|/fc = |k|/n · fs/fc
    kabs = np.abs(np.fft.fftfreq(n))                       # |k|/n, host
    gain = 1.0 / (1.0 + (jnp.asarray(kabs) * fs / cut_off_freq)
                  ** (2 * order))
    out = dfft.ifft(dfft.fft(traces, axis=-1) * gain, axis=-1)
    return jnp.real(out).astype(traces.dtype)
