"""Frequency-axis helpers: fold/unfold spectra, sampling-rate estimation,
frequency-range resolution.

These are host-side (numpy) utilities used at config/filter-file time; the
device kernels (detprocess_jax.ops) carry their own jnp equivalents where
needed. Behavior mirrors the QETpy/detprocess conventions used throughout the
reference (e.g. detprocess/core/algorithms.py:1016, utils/utils.py:437-556).
"""

from __future__ import annotations

import numpy as np


def fftfreq(n: int, fs: float) -> np.ndarray:
    """Two-sided FFT frequencies in Hz (numpy ordering)."""
    return np.fft.fftfreq(n, d=1.0 / fs)


def rfftfreq(n: int, fs: float) -> np.ndarray:
    return np.fft.rfftfreq(n, d=1.0 / fs)


def fold_spectrum(psd: np.ndarray, fs: float):
    """Fold a two-sided PSD onto positive frequencies.

    Power from negative frequencies is folded onto the matching positive
    bins (doubling all bins except DC and, for even N, Nyquist). Returns
    ``(freqs_folded, psd_folded)``. Matches qetpy.utils.fold_spectrum as used
    at detprocess/core/algorithms.py:1016.
    """
    psd = np.asarray(psd)
    n = psd.shape[-1]
    nfold = n // 2 + 1
    folded = np.array(psd[..., :nfold], copy=True)
    if n % 2 == 0:
        # double everything except DC and Nyquist
        folded[..., 1:-1] *= 2.0
    else:
        folded[..., 1:] *= 2.0
    freqs = np.abs(np.fft.fftfreq(n, d=1.0 / fs)[:nfold])
    return freqs, folded


def unfold_spectrum(psd_folded: np.ndarray, n: int):
    """Inverse of :func:`fold_spectrum` — rebuild the two-sided PSD.

    ``n`` is the original (two-sided) length.
    """
    psd_folded = np.asarray(psd_folded, dtype=float)
    nfold = n // 2 + 1
    if psd_folded.shape[-1] != nfold:
        raise ValueError(
            f"folded PSD length {psd_folded.shape[-1]} inconsistent with n={n}"
        )
    half = np.array(psd_folded, copy=True)
    if n % 2 == 0:
        half[..., 1:-1] /= 2.0
        negative = half[..., 1:-1][..., ::-1]
    else:
        half[..., 1:] /= 2.0
        negative = half[..., 1:][..., ::-1]
    return np.concatenate([half, negative], axis=-1)


def estimate_sampling_rate(freq_array: np.ndarray) -> float:
    """Estimate fs from a (one- or two-sided) frequency array.

    Mirrors detprocess/utils/utils.py:507-556.
    """
    freq_sorted = np.unique(np.sort(np.asarray(freq_array)))
    positive = freq_sorted[freq_sorted > 0]
    if positive.size == 0:
        raise ValueError("no positive frequencies; cannot infer sampling rate")
    df = positive[0]
    if freq_sorted[0] < 0:
        n = len(freq_array)
    else:
        n = 2 * (len(freq_array) - 1)
    return n * df


def cleanup_freq_ranges(f_lims):
    """Normalize a list of frequency limits into ranges + feature-name stubs.

    Mirrors detprocess/utils/utils.py:437-470 (used by psd_amp/psd_peaks).
    """
    if not isinstance(f_lims, list):
        f_lims = [f_lims]
    freq_ranges, range_names = [], []
    for freq_range in f_lims:
        if isinstance(freq_range, (int, float)):
            freq_range = [freq_range]
        f_low = abs(freq_range[0])
        if len(freq_range) == 2:
            f_high = abs(freq_range[1])
            if f_low > f_high:
                f_low, f_high = f_high, f_low
            name = f"{round(f_low)}_{round(f_high)}"
            if name not in range_names:
                freq_ranges.append([f_low, f_high])
                range_names.append(name)
        else:
            name = f"{round(f_low)}"
            if name not in range_names:
                freq_ranges.append([f_low])
                range_names.append(name)
    return freq_ranges, range_names


def get_ind_freq_ranges(freq_ranges, freqs):
    """Map frequency ranges to index ranges on a frequency axis.

    Mirrors detprocess/utils/utils.py:475-504.
    """
    freqs = np.asarray(freqs)
    idx_ranges = []
    for freq_range in freq_ranges:
        f_low = abs(freq_range[0])
        ind_low = int(np.argmin(np.abs(freqs - f_low)))
        ind_high = ind_low + 1
        if len(freq_range) == 2:
            ind_high = int(np.argmin(np.abs(freqs - abs(freq_range[1]))))
        if ind_low > ind_high:
            ind_low, ind_high = ind_high, ind_low
        if ind_low == ind_high:
            if ind_high < len(freqs) - 1:
                ind_high += 1
            elif ind_low > 0:
                ind_low -= 1
            else:
                raise ValueError("frequency range too narrow or outside bounds")
        idx_ranges.append([ind_low, ind_high])
    return idx_ranges
