"""Golden tests for the 1x1 optimal-filter kernels.

Strategy (SURVEY.md §4): (1) exact agreement with an independent
loop-style numpy implementation in float64; (2) closed-form checks on white
noise (amplitude recovery, χ² distribution, resolution).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from detprocess_jax.models import pulse
from detprocess_jax.ops import filterbank, of1x1

from reference_impl import RefOF1x1, generate_noise

FS = 1.25e6
N = 4096
PRETRIG = 1024


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    # colored noise PSD: white + 1/f
    f = np.abs(np.fft.fftfreq(N, d=1.0 / FS))
    f[0] = f[1]
    psd = 1e-20 * (1.0 + 100.0 / f)
    traces = generate_noise(psd, FS, 32, rng)
    # inject pulses with known amplitudes at varying offsets
    amps = rng.uniform(0.5e-6, 5e-6, 32)
    offsets = rng.integers(-200, 200, 32)
    for i in range(32):
        traces[i] += amps[i] * np.roll(template, offsets[i])
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    return template, psd, traces, amps, offsets, bank


def test_nodelay_matches_reference(setup):
    template, psd, traces, _, _, bank = setup
    ref = RefOF1x1(template, psd, FS, PRETRIG)

    vfft = of1x1.signal_fft(jnp.asarray(traces)[:, None, :])
    low_mask = jnp.asarray(of1x1.lowfreq_mask(N, FS, 10000.0))
    res = of1x1.of1x1_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.norm),
                              jnp.asarray(bank.denom_inv),
                              jnp.asarray(bank.s_fft), low_mask)
    for i in range(traces.shape[0]):
        amp, chi2, lowchi2 = ref.fit_nodelay(traces[i], lowchi2_fcutoff=10000.0)
        np.testing.assert_allclose(float(res.amp[i, 0]), amp, rtol=1e-9)
        np.testing.assert_allclose(float(res.chi2[i, 0]), chi2, rtol=1e-9)
        np.testing.assert_allclose(float(res.lowchi2[i, 0]), lowchi2, rtol=1e-9)


def test_withdelay_matches_reference(setup):
    template, psd, traces, _, _, bank = setup
    ref = RefOF1x1(template, psd, FS, PRETRIG)

    vfft = of1x1.signal_fft(jnp.asarray(traces)[:, None, :])
    low_mask = jnp.asarray(of1x1.lowfreq_mask(N, FS, 10000.0))
    res = of1x1.of1x1_withdelay(
        vfft, jnp.asarray(bank.phi), jnp.asarray(bank.norm),
        jnp.asarray(bank.denom_inv), jnp.asarray(bank.s_fft),
        PRETRIG, FS, low_mask=low_mask)
    for i in range(traces.shape[0]):
        amp, t0, chi2, lowchi2 = ref.fit_withdelay(traces[i],
                                                   lowchi2_fcutoff=10000.0)
        np.testing.assert_allclose(float(res.amp[i, 0]), amp, rtol=1e-9)
        np.testing.assert_allclose(float(res.t0[i, 0]), t0, atol=1e-12)
        np.testing.assert_allclose(float(res.chi2[i, 0]), chi2, rtol=1e-9)
        np.testing.assert_allclose(float(res.lowchi2[i, 0]), lowchi2, rtol=1e-9)


def test_constrained_window(setup):
    template, psd, traces, _, _, bank = setup
    ref = RefOF1x1(template, psd, FS, PRETRIG)
    window = (PRETRIG - 50, PRETRIG + 50)

    mask = np.zeros(N, dtype=bool)
    mask[window[0]:window[1] + 1] = True
    vfft = of1x1.signal_fft(jnp.asarray(traces)[:, None, :])
    res = of1x1.of1x1_withdelay(
        vfft, jnp.asarray(bank.phi), jnp.asarray(bank.norm),
        jnp.asarray(bank.denom_inv), jnp.asarray(bank.s_fft),
        PRETRIG, FS, window_mask=jnp.asarray(mask))
    for i in range(traces.shape[0]):
        amp, t0, chi2, _ = ref.fit_withdelay(traces[i], window=window)
        np.testing.assert_allclose(float(res.amp[i, 0]), amp, rtol=1e-9)
        np.testing.assert_allclose(float(res.t0[i, 0]), t0, atol=1e-12)
        np.testing.assert_allclose(float(res.chi2[i, 0]), chi2, rtol=1e-9)


def test_noise_free_recovery():
    """Noise-free pulse: nodelay recovers the exact injected amplitude."""
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 1e-20)
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    a0 = 3.7e-6
    trace = a0 * template
    vfft = of1x1.signal_fft(jnp.asarray(trace)[None, None, :])
    res = of1x1.of1x1_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.norm),
                              jnp.asarray(bank.denom_inv),
                              jnp.asarray(bank.s_fft))
    # DC is excluded from the fit, so recovery is exact up to numerics
    np.testing.assert_allclose(float(res.amp[0, 0]), a0, rtol=1e-10)
    assert float(res.chi2[0, 0]) < 1e-12 * float(res.chi2_nopulse[0, 0]) + 1e-6


def test_delay_recovery():
    """Pulse shifted by a known offset: withdelay finds the right t0."""
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 1e-20)
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    offset = 137
    trace = 2e-6 * np.roll(template, offset)
    vfft = of1x1.signal_fft(jnp.asarray(trace)[None, None, :])
    res = of1x1.of1x1_withdelay(
        vfft, jnp.asarray(bank.phi), jnp.asarray(bank.norm),
        jnp.asarray(bank.denom_inv), jnp.asarray(bank.s_fft), PRETRIG, FS)
    np.testing.assert_allclose(float(res.t0[0, 0]), offset / FS, atol=1e-12)
    np.testing.assert_allclose(float(res.amp[0, 0]), 2e-6, rtol=1e-9)


def test_chi2_statistics():
    """On pure noise, χ²₀ ≈ N (dof) and fitted amp ~ N(0, 1/sqrt(norm))."""
    rng = np.random.default_rng(7)
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 4e-21)
    traces = generate_noise(psd, FS, 256, rng)
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    vfft = of1x1.signal_fft(jnp.asarray(traces)[:, None, :])
    res = of1x1.of1x1_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.norm),
                              jnp.asarray(bank.denom_inv),
                              jnp.asarray(bank.s_fft))
    chi2_mean = float(jnp.mean(res.chi2_nopulse))
    # χ²₀ sums N-1 bins (DC dropped), each |z|²/σ² with 1 dof per bin
    assert abs(chi2_mean / (N - 1) - 1.0) < 0.05
    sigma_expected = 1.0 / np.sqrt(bank.norm[0])
    amp_std = float(jnp.std(res.amp))
    assert abs(amp_std / sigma_expected - 1.0) < 0.2


def test_interpolate_t0_improves_subsample():
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 1e-20)
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    # build a sub-sample-shifted pulse in the frequency domain
    shift = 42.3
    k = np.fft.fftfreq(N) * N
    s_fft = np.fft.fft(template) * np.exp(-2j * np.pi * k * shift / N)
    trace = 1e-6 * np.real(np.fft.ifft(s_fft))
    vfft = of1x1.signal_fft(jnp.asarray(trace)[None, None, :])
    res = of1x1.of1x1_withdelay(
        vfft, jnp.asarray(bank.phi), jnp.asarray(bank.norm),
        jnp.asarray(bank.denom_inv), jnp.asarray(bank.s_fft), PRETRIG, FS,
        interpolate_t0=True)
    t0_samples = float(res.t0[0, 0]) * FS
    assert abs(t0_samples - shift) < 0.2  # sub-sample accuracy


def test_resolutions():
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 1e-20)
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    ampres = of1x1.energy_resolution(jnp.asarray(bank.norm))
    np.testing.assert_allclose(np.asarray(ampres),
                               1.0 / np.sqrt(bank.norm), rtol=1e-12)
    tres = of1x1.time_resolution(jnp.asarray([1e-6]),
                                 jnp.asarray(bank.s_fft),
                                 jnp.asarray(bank.denom_inv), FS)
    assert np.isfinite(float(tres[0])) and float(tres[0]) > 0


def test_coupling_dc_vs_ac():
    """coupling='DC' keeps the DC bin (qetpy OFBase coupling /
    processing_data.py:252-255): a baseline offset shifts the DC-coupled
    amplitude but leaves the AC-coupled one untouched."""
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 1e-20)
    bank_ac = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    bank_dc = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG,
                                         coupling="DC")
    assert bank_ac.denom_inv[0, 0] == 0.0
    assert bank_dc.denom_inv[0, 0] > 0.0
    assert bank_dc.norm[0] > bank_ac.norm[0]

    amp_true, offset = 2e-6, 5e-7
    trace = amp_true * template + offset
    vfft = of1x1.signal_fft(jnp.asarray(trace)[None, None, :])

    def amp(bank):
        res = of1x1.of1x1_nodelay(
            vfft, jnp.asarray(bank.phi), jnp.asarray(bank.norm),
            jnp.asarray(bank.denom_inv), jnp.asarray(bank.s_fft))
        return float(res.amp[0, 0])

    np.testing.assert_allclose(amp(bank_ac), amp_true, rtol=1e-10)
    assert abs(amp(bank_dc) - amp_true) > 100 * abs(amp(bank_ac) - amp_true)
    # and with no offset both agree exactly
    vfft0 = of1x1.signal_fft(
        jnp.asarray(amp_true * template)[None, None, :])
    res_dc = of1x1.of1x1_nodelay(
        vfft0, jnp.asarray(bank_dc.phi), jnp.asarray(bank_dc.norm),
        jnp.asarray(bank_dc.denom_inv), jnp.asarray(bank_dc.s_fft))
    np.testing.assert_allclose(float(res_dc.amp[0, 0]), amp_true,
                               rtol=1e-10)
