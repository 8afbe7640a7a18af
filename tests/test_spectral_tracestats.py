"""Tests for spectral estimation and trace statistics kernels."""

import numpy as np
import jax.numpy as jnp

from detprocess_jax.ops import spectral, tracestats
from detprocess_jax.utils import freq as frequtils

from reference_impl import ref_welch_psd, ref_welch_csd, generate_noise

FS = 1.25e6
N = 2048


def test_welch_psd_matches_reference():
    rng = np.random.default_rng(0)
    traces = rng.standard_normal((64, N))
    psd = np.asarray(spectral.welch_psd(jnp.asarray(traces), FS))
    ref = ref_welch_psd(traces, FS)
    np.testing.assert_allclose(psd, ref, rtol=1e-10)


def test_welch_psd_white_noise_level():
    rng = np.random.default_rng(1)
    sigma = 3e-6
    traces = rng.standard_normal((512, N)) * sigma
    psd = np.asarray(spectral.welch_psd(jnp.asarray(traces), FS))
    # two-sided white PSD = sigma^2 / fs
    np.testing.assert_allclose(np.mean(psd), sigma**2 / FS, rtol=0.05)


def test_welch_csd_matches_reference_and_hermitian():
    rng = np.random.default_rng(2)
    traces = rng.standard_normal((32, 3, N))
    csd = np.asarray(spectral.welch_csd(jnp.asarray(traces), FS))
    ref = ref_welch_csd(traces, FS)
    np.testing.assert_allclose(csd, ref, rtol=1e-10)
    # Hermitian in channel axes
    np.testing.assert_allclose(csd, np.conj(np.swapaxes(csd, 0, 1)),
                               rtol=1e-10)
    # diagonal equals the per-channel PSD
    psd0 = np.asarray(spectral.welch_psd(jnp.asarray(traces[:, 0]), FS))
    np.testing.assert_allclose(np.real(csd[0, 0]), psd0, rtol=1e-10)


def test_fold_unfold_roundtrip():
    rng = np.random.default_rng(3)
    for n in (256, 255):
        two_sided = np.abs(rng.standard_normal(n)) + 0.1
        # make symmetric like a real PSD
        two_sided = (two_sided + two_sided[(-np.arange(n)) % n]) / 2
        freqs, folded = frequtils.fold_spectrum(two_sided, FS)
        rebuilt = frequtils.unfold_spectrum(folded, n)
        np.testing.assert_allclose(rebuilt, two_sided, rtol=1e-12)
        # device fold agrees with host fold
        dev = np.asarray(spectral.fold_spectrum(jnp.asarray(two_sided)))
        np.testing.assert_allclose(dev, folded, rtol=1e-12)


def test_fold_preserves_total_power():
    rng = np.random.default_rng(4)
    traces = rng.standard_normal((128, N))
    psd = np.asarray(spectral.welch_psd(jnp.asarray(traces), FS))
    _, folded = frequtils.fold_spectrum(psd, FS)
    np.testing.assert_allclose(np.sum(folded), np.sum(psd), rtol=1e-12)


def test_lowpass_filter_attenuation():
    # sine below cutoff passes, sine above cutoff is attenuated
    t = np.arange(N) / FS
    low = np.sin(2 * np.pi * 10e3 * t)
    high = np.sin(2 * np.pi * 300e3 * t)
    out_low = np.asarray(spectral.lowpass_filter(jnp.asarray(low), 50e3, FS))
    out_high = np.asarray(spectral.lowpass_filter(jnp.asarray(high), 50e3, FS))
    assert np.std(out_low) > 0.9 * np.std(low)
    assert np.std(out_high) < 0.1 * np.std(high)


def test_tracestats_match_numpy():
    rng = np.random.default_rng(5)
    traces = rng.standard_normal((16, N))
    jt = jnp.asarray(traces)
    wmin, wmax = 100, 1500

    np.testing.assert_allclose(
        np.asarray(tracestats.baseline(jt, wmin, wmax)),
        np.mean(traces[:, wmin:wmax], axis=-1), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(tracestats.integral(jt, FS, wmin, wmax)),
        np.trapezoid(traces[:, wmin:wmax], axis=-1) / FS,
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(tracestats.maximum(jt, wmin, wmax)),
        np.max(traces[:, wmin:wmax], axis=-1), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(tracestats.minimum(jt, wmin, wmax)),
        np.min(traces[:, wmin:wmax], axis=-1), rtol=1e-12)

    vb, i0, rl = 1e-6, 2e-7, 0.03
    base = traces[:, :wmin].mean(axis=-1, keepdims=True)
    i_trace = traces[:, wmin:wmax] - base
    p0 = i_trace * (vb - 2 * i0 * rl) - i_trace**2 * rl
    expected = np.trapezoid(p0, dx=1 / FS, axis=-1)
    np.testing.assert_allclose(
        np.asarray(tracestats.energyabsorbed(jt, FS, vb, i0, rl, wmin, wmax)),
        expected, rtol=1e-10)


def test_default_windows_match_reference_semantics():
    """Default max window excludes the final sample (algorithms.py:694-698)."""
    rng = np.random.default_rng(6)
    traces = rng.standard_normal((4, N))
    jt = jnp.asarray(traces)
    np.testing.assert_allclose(
        np.asarray(tracestats.baseline(jt)),
        np.mean(traces[:, 0:N - 1], axis=-1), rtol=1e-12)


def test_spectral_perm_path_matches_natural():
    """At production trace lengths (16k samples) the spectral kernels
    equal scipy's periodogram and numpy's FFT conventions exactly."""
    import scipy.signal

    n = 16384
    rng = np.random.default_rng(44)
    traces = rng.standard_normal((6, n))
    psd = np.asarray(spectral.welch_psd(jnp.asarray(traces), FS))
    f, ref = scipy.signal.periodogram(traces, FS, window="boxcar",
                                      nfft=n, detrend=False,
                                      return_onesided=False)
    np.testing.assert_allclose(psd, ref.mean(axis=0), rtol=1e-9)

    tr3 = rng.standard_normal((5, 2, n))
    csd = np.asarray(spectral.welch_csd(jnp.asarray(tr3), FS))
    vf = np.fft.fft(tr3, axis=-1)
    ref_csd = np.einsum("bik,bjk->ijk", vf, np.conj(vf)) / (5 * n * FS)
    np.testing.assert_allclose(csd, ref_csd, rtol=0,
                               atol=1e-9 * np.max(np.abs(ref_csd)))

    lp = np.asarray(spectral.lowpass_filter(jnp.asarray(traces), 50e3, FS,
                                            order=2))
    fr = np.fft.fftfreq(n, 1 / FS)
    gain = 1.0 / (1.0 + (np.abs(fr) / 50e3) ** 4)
    ref_lp = np.real(np.fft.ifft(np.fft.fft(traces, axis=-1) * gain,
                                 axis=-1))
    np.testing.assert_allclose(lp, ref_lp, atol=1e-9 * np.max(np.abs(ref_lp)))
