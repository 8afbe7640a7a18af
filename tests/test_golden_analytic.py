"""Independent parity evidence: closed-form golden cases.

Every other golden test in this suite compares against
tests/reference_impl.py — numpy code written *by this project*, so a
shared misconception would pass silently. The cases here are different:
the expected numbers come from textbook matched-filter theory, exact
DFT evaluation with Python Fractions (no FFT library at all), and known
noise statistics — sources this project did not author and cannot bias.

Matched-filter theory used (standard, e.g. Golwala thesis App. B /
Gatti & Manfredi):

- For signal x = a·s + n with white noise of variance σ², the optimal
  filter estimate is â = Σ s·x / Σ s² with σ_â = σ/√(Σ s²), and the
  bank norm is Σ|s̃|²/(N·fs·J) = Σ s²/σ² for two-sided J = σ²/fs.
- On pure (any) noise, χ²₀ = Σ_k |ṽ_k|²/(N·fs·J_k) has mean = number of
  unmasked bins (each bin contributes mean 1).
- A δ-function template turns the OF into a pure sample-picker:
  â(t₀) = x[t₀] for white noise.

Reference math being checked: qetpy OF1x1 as driven by
detprocess/core/algorithms.py:278-567 and qp.calc_psd at
detprocess/core/noise.py:344-346.
"""

from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest

from detprocess_jax.ops import filterbank, of1x1, spectral


FS = 1.0e6


# ---------------------------------------------------------------------------
# 1. exact small-N case evaluated with rational arithmetic (no FFT library)
# ---------------------------------------------------------------------------

def _dft_exact(x):
    """DFT of length-4 rational sequences, exact: the twiddles for N=4
    are ±1, ±i, so every bin is a rational complex number."""
    n = len(x)
    assert n == 4
    # W4^(jk) table for N=4: e^{-2πi jk/4} ∈ {1, -i, -1, i}
    w = {0: (1, 0), 1: (0, -1), 2: (-1, 0), 3: (0, 1)}
    out = []
    for k in range(4):
        re = Fraction(0)
        im = Fraction(0)
        for j in range(4):
            c, s = w[(j * k) % 4]
            re += x[j] * c
            im += x[j] * s
        out.append((re, im))
    return out


def test_of1x1_exact_rational_n4():
    """OF amplitude/χ² for N=4, computed fully by hand with Fractions.

    template s = [0, 1, 1/2, 1/4], trace v = [1/8, 2, 3/4, 1/2],
    white two-sided PSD J = 2/fs (noise variance 2).

    amp = Σ φ v / norm with φ_k = s̃*_k/(N·fs·J_k); for white J this
    reduces exactly to amp = (Σ s·v)/(Σ s²) by Parseval — evaluated
    both ways in exact arithmetic below.
    """
    s = [Fraction(0), Fraction(1), Fraction(1, 2), Fraction(1, 4)]
    v = [Fraction(1, 8), Fraction(2), Fraction(3, 4), Fraction(1, 2)]
    var = Fraction(2)

    # frequency-domain evaluation, exact
    sf = _dft_exact(s)
    vf = _dft_exact(v)
    n = 4
    # denom_inv = 1/(N·fs·J) = 1/(N·var) per bin (J = var/fs), DC zeroed
    q = Fraction(0)
    norm = Fraction(0)
    c0 = Fraction(0)
    for k in range(4):
        if k == 0:
            continue  # bank zeroes the DC bin
        di = Fraction(1, n * var)
        # Re(conj(sf)·vf)
        q += (sf[k][0] * vf[k][0] + sf[k][1] * vf[k][1]) * di
        norm += (sf[k][0] ** 2 + sf[k][1] ** 2) * di
        c0 += (vf[k][0] ** 2 + vf[k][1] ** 2) * di
    amp_exact = q / norm
    chi2_exact = c0 - q * q / norm

    # cross-check the rational result against time-domain matched filter
    # on mean-subtracted sequences (DC-zeroing ≡ mean subtraction)
    sm = sum(s) / 4
    vm = sum(v) / 4
    s0 = [si - sm for si in s]
    v0 = [vi - vm for vi in v]
    amp_td = (sum(a * b for a, b in zip(s0, v0))
              / sum(a * a for a in s0))
    assert amp_exact == amp_td

    psd = np.full(4, float(var) / FS)
    bank = filterbank.make_of1x1_bank(
        np.array([float(x) for x in s]), psd, FS, pretrigger=1)
    vfft = jnp.asarray(np.fft.fft(
        np.array([float(x) for x in v]))[None, None, :])
    res = of1x1.of1x1_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.norm),
                              jnp.asarray(bank.denom_inv),
                              jnp.asarray(bank.s_fft))
    np.testing.assert_allclose(float(res.amp[0, 0]), float(amp_exact),
                               rtol=1e-12)
    np.testing.assert_allclose(float(res.chi2[0, 0]), float(chi2_exact),
                               rtol=1e-12)
    np.testing.assert_allclose(float(res.chi2_nopulse[0, 0]), float(c0),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# 2. white-noise matched-filter statistics (textbook closed forms)
# ---------------------------------------------------------------------------

N = 4096
PRETRIG = 1024


@pytest.fixture(scope="module")
def white_bank():
    from detprocess_jax.models import pulse

    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    sigma = 3.0e-8
    psd = np.full(N, sigma**2 / FS)   # two-sided white PSD
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    return template, sigma, bank


def test_norm_equals_parseval_snr(white_bank):
    """norm = Σ s²/σ² for white noise (with the DC bin's contribution
    removed) — matched-filter theory, not this repo's code."""
    template, sigma, bank = white_bank
    s0 = template - template.mean()    # DC-zeroing ≡ mean subtraction
    expected = np.sum(s0**2) / sigma**2
    np.testing.assert_allclose(float(bank.norm[0]), expected, rtol=1e-10)


def test_amplitude_estimator_unbiased_and_efficient(white_bank):
    """⟨â⟩ = a, std(â) = 1/√norm on white noise (Monte Carlo, 4000
    events: the 1/√2M relative tolerance on the std is ~1.1%)."""
    template, sigma, bank = white_bank
    rng = np.random.default_rng(123)
    m = 4000
    a_true = 5e-6
    traces = rng.standard_normal((m, N)) * sigma + a_true * template
    vfft = jnp.asarray(np.fft.fft(traces, axis=-1)[:, None, :])
    res = of1x1.of1x1_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.norm),
                              jnp.asarray(bank.denom_inv),
                              jnp.asarray(bank.s_fft))
    amps = np.asarray(res.amp[:, 0])
    sig_amp = 1.0 / np.sqrt(float(bank.norm[0]))
    assert abs(amps.mean() - a_true) < 4 * sig_amp / np.sqrt(m)
    np.testing.assert_allclose(amps.std(ddof=1), sig_amp, rtol=0.05)


def test_chi2_statistics_on_pure_noise(white_bank):
    """χ²₀ mean = number of unmasked bins (N−1 with DC zeroed) and
    variance ≈ 2(N−1): ṽ_k/√(N fs J/2) are unit-variance Gaussians."""
    template, sigma, bank = white_bank
    rng = np.random.default_rng(7)
    m = 2000
    traces = rng.standard_normal((m, N)) * sigma
    vfft = jnp.asarray(np.fft.fft(traces, axis=-1)[:, None, :])
    c0 = np.asarray(of1x1.chi2_base(vfft, jnp.asarray(bank.denom_inv)))
    dof = N - 1
    assert abs(c0.mean() - dof) < 5 * np.sqrt(2.0 * dof / m)
    np.testing.assert_allclose(c0.var(ddof=1), 2.0 * dof, rtol=0.15)


def test_delta_template_is_sample_picker():
    """δ-function template + white noise: â(d) = x[d] − x̄ exactly
    (DC-zeroed matched filter on a delta picks the mean-subtracted
    sample), and the delay scan lands on the largest |deviation|."""
    sigma = 1.0
    psd = np.full(N, sigma**2 / FS)
    s = np.zeros(N)
    s[PRETRIG] = 1.0
    bank = filterbank.make_of1x1_bank(s, psd, FS, PRETRIG)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(N)
    j_big = int(np.argmax(np.abs(x - x.mean())))
    vfft = jnp.asarray(np.fft.fft(x)[None, None, :])
    res = of1x1.of1x1_withdelay(vfft, jnp.asarray(bank.phi),
                                jnp.asarray(bank.norm),
                                jnp.asarray(bank.denom_inv),
                                jnp.asarray(bank.s_fft), PRETRIG, FS)
    # amp should be the mean-subtracted winning sample, scaled by
    # norm = (1 - 1/N)/sigma² ... ratio checks both conventions at once
    expect = (x[j_big] - x.mean()) * 1.0 / (1.0 - 1.0 / N)
    np.testing.assert_allclose(float(res.amp[0, 0]), expect, rtol=1e-9)
    t0_idx = int(round(float(res.t0[0, 0]) * FS)) + PRETRIG
    assert t0_idx == j_big


# ---------------------------------------------------------------------------
# 3. Welch PSD closed forms
# ---------------------------------------------------------------------------

def test_psd_of_pure_sinusoid():
    """Two-sided PSD of A·cos(2πf_k t) at an exact bin k: the DFT puts
    A·N/2 at ±k, so PSD[±k] = |A·N/2|²/(N·fs) = A²N/(4fs), zero
    elsewhere. Pure Fourier identity."""
    n = 8192
    k = 37
    a = 3.3e-6
    t = np.arange(n)
    x = a * np.cos(2 * np.pi * k * t / n)
    psd = np.asarray(spectral.welch_psd(jnp.asarray(x[None, :]), FS))
    peak_expected = a**2 * n / (4 * FS)
    np.testing.assert_allclose(psd[k], peak_expected, rtol=1e-6)
    np.testing.assert_allclose(psd[n - k], peak_expected, rtol=1e-6)
    mask = np.ones(n, bool)
    mask[[k, n - k]] = False
    assert np.max(psd[mask]) < 1e-10 * peak_expected


def test_psd_white_noise_level_and_parseval():
    """White noise variance σ²: two-sided PSD level = σ²/fs, and the
    Welch estimate integrates back to the variance (Parseval)."""
    n = 4096
    sigma = 2.0e-7
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((800, n)) * sigma)
    psd = np.asarray(spectral.welch_psd(jnp.asarray(x), FS))
    np.testing.assert_allclose(psd.mean(), sigma**2 / FS, rtol=0.02)
    # Parseval per-trace: Σ PSD·fs/N == mean square
    np.testing.assert_allclose(psd.sum() * FS / n, sigma**2, rtol=0.02)


# ---------------------------------------------------------------------------
# 4. NxM closed forms
# ---------------------------------------------------------------------------

def test_nxm_diagonal_csd_decouples_to_1x1():
    """With a diagonal CSD, the NxM fit decouples channel-by-channel: for
    orthogonal per-channel templates the amplitudes equal the independent
    1x1 estimates — a structural identity of the weight matrix, not a
    property of this implementation."""
    from detprocess_jax.ops import ofnxm

    n = 512
    pre = 128
    from detprocess_jax.models import pulse as pl

    t1 = pl.make_template(FS, n, pre, A=1.0, tau_r=10e-6, tau_f1=50e-6)
    t2 = pl.make_template(FS, n, pre, A=1.0, tau_r=40e-6, tau_f1=300e-6)
    templates = np.zeros((2, 2, n))
    templates[0, 0] = t1          # template 0 lives on channel 0 only
    templates[1, 1] = t2          # template 1 on channel 1 only
    psd1, psd2 = 4e-18, 9e-18
    csd = np.zeros((2, 2, n), dtype=complex)
    csd[0, 0] = psd1
    csd[1, 1] = psd2

    bank = filterbank.make_ofnxm_bank(templates, csd, FS, pre)
    # cross-channel weight terms must vanish exactly
    assert abs(bank.w_matrix[0, 1]) <= 1e-10 * abs(bank.w_matrix[0, 0])

    rng = np.random.default_rng(3)
    a1t, a2t = 3e-6, 5e-6
    traces = np.stack([
        rng.standard_normal(n) * np.sqrt(psd1 * FS) + a1t * t1,
        rng.standard_normal(n) * np.sqrt(psd2 * FS) + a2t * t2,
    ])[None, :, :]
    vfft = jnp.asarray(np.fft.fft(traces, axis=-1))
    res = ofnxm.ofnxm_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.iw_matrix),
                              jnp.asarray(bank.icsd), FS)
    amps = np.asarray(res.amps[0])

    # independent 1x1 fits on each channel
    for ch, (tmpl, psd_v, a_true) in enumerate(
            [(t1, psd1, a1t), (t2, psd2, a2t)]):
        psd_arr = np.full(n, psd_v)
        b1 = filterbank.make_of1x1_bank(tmpl, psd_arr, FS, pre)
        v1 = jnp.asarray(np.fft.fft(traces[0, ch])[None, None, :])
        r1 = of1x1.of1x1_nodelay(v1, jnp.asarray(b1.phi),
                                 jnp.asarray(b1.norm),
                                 jnp.asarray(b1.denom_inv),
                                 jnp.asarray(b1.s_fft))
        np.testing.assert_allclose(amps[ch], float(r1.amp[0, 0]),
                                   rtol=1e-8)


def test_nxm_delta_chi2_distribution():
    """On pure noise, Δχ² = qᵀW⁻¹q at a fixed delay is χ²_M distributed:
    mean M, var 2M — textbook quadratic-form statistics."""
    from detprocess_jax.ops import ofnxm

    n = 1024
    pre = 256
    from detprocess_jax.models import pulse as pl

    templates = np.stack([
        pl.make_template(FS, n, pre, A=1.0, tau_r=10e-6, tau_f1=60e-6),
        pl.make_template(FS, n, pre, A=1.0, tau_r=30e-6, tau_f1=250e-6),
    ])[None, :, :]                                       # 1 channel, M=2
    psd_v = 4e-18
    csd = np.full((1, 1, n), psd_v, dtype=complex)
    bank = filterbank.make_ofnxm_bank(templates, csd, FS, pre)

    rng = np.random.default_rng(9)
    m_ev = 3000
    noise = rng.standard_normal((m_ev, 1, n)) * np.sqrt(psd_v * FS)
    vfft = jnp.asarray(np.fft.fft(noise, axis=-1))
    q = jnp.einsum("cmk,bck->bm", jnp.asarray(bank.phi), vfft).real
    dchi2 = np.asarray(jnp.einsum(
        "bi,ij,bj->b", q, jnp.asarray(bank.iw_matrix), q))
    m_amp = 2
    assert abs(dchi2.mean() - m_amp) < 5 * np.sqrt(2 * m_amp / m_ev)
    np.testing.assert_allclose(dchi2.var(ddof=1), 2 * m_amp, rtol=0.15)
