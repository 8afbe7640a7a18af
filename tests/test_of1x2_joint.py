"""Joint OF1x2: coupled two-template fit vs greedy subtract.

The reference's of1x2x2 extractor (detprocess/core/algorithms.py:572-647)
uses qetpy.OF1x2, which solves the coupled two-template system — both
amplitudes and delays fit jointly. A greedy fit-subtract-fit biases both
amplitudes whenever the pulses overlap: the first fit absorbs part of the
second pulse. These tests build exactly that overlapping-pulse scenario
and check the joint kernel recovers both amplitudes where greedy cannot,
plus exactness against a brute-force (d1, d2) grid solve.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from detprocess_jax.models import pulse
from detprocess_jax.ops import filterbank, of1x1


FS = 1.25e6
N = 1024
PRETRIG = N // 2


@pytest.fixture(scope="module")
def banks():
    # two overlapping template shapes: fast and slow fall times
    t1 = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=10e-6,
                             tau_f1=60e-6)
    t2 = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=30e-6,
                             tau_f1=400e-6)
    psd = np.full(N, 1e-16)
    psd[0] = np.inf
    b1 = filterbank.make_of1x1_bank(t1, psd, FS, PRETRIG)
    b2 = filterbank.make_of1x1_bank(t2, psd, FS, PRETRIG)
    return t1, t2, b1, b2


def _joint(vfft, b1, b2, **kw):
    return of1x1.of1x2(
        vfft,
        jnp.asarray(b1.phi), jnp.asarray(b1.norm), jnp.asarray(b1.s_fft),
        jnp.asarray(b2.phi), jnp.asarray(b2.norm), jnp.asarray(b2.s_fft),
        jnp.asarray(b1.denom_inv), PRETRIG, FS, **kw)


def _brute_force(trace, b1, b2, d1_range, d2_range):
    """Exact joint solve on a (d1, d2) grid with plain numpy."""
    v = np.fft.fft(trace)
    phi1, phi2 = b1.phi[0], b2.phi[0]
    s1, s2 = b1.s_fft[0], b2.s_fft[0]
    n1, n2 = float(b1.norm[0]), float(b2.norm[0])
    di = b1.denom_inv[0]
    k = np.arange(N)
    best = (-np.inf, None)
    for d1 in d1_range:
        for d2 in d2_range:
            s1d = d1 - PRETRIG
            s2d = d2 - PRETRIG
            q1 = np.real(np.sum(phi1 * v * np.exp(2j * np.pi * k * s1d / N)))
            q2 = np.real(np.sum(phi2 * v * np.exp(2j * np.pi * k * s2d / N)))
            r = np.real(np.sum(
                phi1 * s2 * np.exp(2j * np.pi * k * (s1d - s2d) / N)))
            det = n1 * n2 - r * r
            if det <= 1e-12 * n1 * n2:
                continue
            dchi2 = (n2 * q1**2 - 2 * r * q1 * q2 + n1 * q2**2) / det
            if dchi2 > best[0]:
                a1 = (n2 * q1 - r * q2) / det
                a2 = (n1 * q2 - r * q1) / det
                best = (dchi2, (a1, a2, d1, d2))
    return best[1]


def test_joint_matches_brute_force(banks):
    """Exactness: windowed joint scan == brute-force grid solve."""
    t1, t2, b1, b2 = banks
    rng = np.random.default_rng(11)
    amp1_true, amp2_true, sep = 3.0e-6, 2.0e-6, 40
    trace = (amp1_true * np.roll(t1, 0)
             + amp2_true * np.roll(t2, sep)
             + rng.standard_normal(N) * 1e-9)
    v = jnp.asarray(np.fft.fft(trace).reshape(1, 1, N))

    res = _joint(v, b1, b2, delta_window=np.arange(-64, 65))
    d1_range = range(PRETRIG - 4, PRETRIG + 5)
    d2_range = range(PRETRIG + sep - 8, PRETRIG + sep + 9)
    a1_bf, a2_bf, d1_bf, d2_bf = _brute_force(trace, b1, b2,
                                              d1_range, d2_range)

    assert np.isclose(float(res.amp1[0, 0]), a1_bf, rtol=1e-5)
    assert np.isclose(float(res.amp2[0, 0]), a2_bf, rtol=1e-5)
    t1_idx = float(res.t0_1[0, 0]) * FS + PRETRIG
    t2_idx = float(res.t0_2[0, 0]) * FS + PRETRIG
    assert abs(t1_idx - d1_bf) < 0.5
    assert abs(t2_idx - d2_bf) < 0.5


def test_joint_recovers_overlapping_amplitudes(banks):
    """Overlapping pulses: joint amplitudes unbiased; greedy is biased.

    Greedy bias reference: fitting template 1 alone on s = a1·s1 + a2·s2
    gives a1_greedy = a1 + a2·ρ/norm1 — off by the overlap fraction.
    """
    t1, t2, b1, b2 = banks
    amp1_true, amp2_true, sep = 2.0e-6, 1.5e-6, 25
    trace = amp1_true * t1 + amp2_true * np.roll(t2, sep)  # noiseless
    v = jnp.asarray(np.fft.fft(trace).reshape(1, 1, N))

    res = _joint(v, b1, b2, delta_window=np.arange(0, 128))
    a1 = float(res.amp1[0, 0])
    a2 = float(res.amp2[0, 0])
    assert np.isclose(a1, amp1_true, rtol=1e-3), a1
    assert np.isclose(a2, amp2_true, rtol=1e-3), a2
    # time difference recovered
    assert np.isclose(float(res.time_diff[0, 0]), sep / FS,
                      atol=1.0 / FS)

    # the greedy estimate is measurably biased on the same trace: the
    # single-template fit of template 1 at d1 absorbs overlap from pulse 2
    phi1, s2 = b1.phi[0], b2.s_fft[0]
    k = np.arange(N)
    rho = np.real(np.sum(phi1 * s2 * np.exp(-2j * np.pi * k * sep / N)))
    greedy_a1 = amp1_true + amp2_true * rho / float(b1.norm[0])
    bias = abs(greedy_a1 - amp1_true) / amp1_true
    assert bias > 0.02, (
        f"test setup too weak: greedy bias only {bias:.3%}")
    assert abs(a1 - amp1_true) / amp1_true < bias / 10


def test_joint_full_scan_default(banks):
    """Default (no delta_window) scans all circular shifts."""
    t1, t2, b1, b2 = banks
    amp1_true, amp2_true, sep = 1.0e-6, 0.8e-6, -37  # pulse 2 BEFORE pulse 1
    trace = amp1_true * t1 + amp2_true * np.roll(t2, sep)
    v = jnp.asarray(np.fft.fft(trace).reshape(1, 1, N))
    res = _joint(v, b1, b2)
    assert np.isclose(float(res.amp1[0, 0]), amp1_true, rtol=1e-3)
    assert np.isclose(float(res.amp2[0, 0]), amp2_true, rtol=1e-3)
    assert np.isclose(float(res.time_diff[0, 0]), sep / FS,
                      atol=1.0 / FS)


def test_joint_chi2_zero_on_noiseless(banks):
    """χ² of the exact two-pulse model is ~0 on a noiseless trace."""
    t1, t2, b1, b2 = banks
    trace = 2e-6 * t1 + 1e-6 * np.roll(t2, 50)
    v = jnp.asarray(np.fft.fft(trace).reshape(1, 1, N))
    res = _joint(v, b1, b2, delta_window=np.arange(0, 80))
    c0 = float(of1x1.chi2_base(v, jnp.asarray(b1.denom_inv))[0, 0])
    assert float(res.chi2[0, 0]) < 1e-6 * c0


def test_positive_window_beyond_half_n(banks):
    """An explicitly positive delta_window with values > n/2 must report
    time_diff on the caller's branch, not unwrap it to negative."""
    t1, t2, b1, b2 = banks
    sep = 600                      # > N/2 = 512
    trace = 2e-6 * t1 + 1.5e-6 * np.roll(t2, sep)
    v = jnp.asarray(np.fft.fft(trace).reshape(1, 1, N))
    res = _joint(v, b1, b2, delta_window=np.arange(0, 700))
    assert float(res.time_diff[0, 0]) * FS == pytest.approx(sep, abs=1.0)
    assert np.isclose(float(res.amp1[0, 0]), 2e-6, rtol=1e-3)
    assert np.isclose(float(res.amp2[0, 0]), 1.5e-6, rtol=1e-3)


def test_of1x2_half_equals_full(banks):
    """The half-spectrum joint kernel (Hermitian-product irffts,
    delay-order core) equals the full-spectrum kernel — at a small N and
    at a production-size N."""
    t1, t2, b1, b2 = banks
    rng = np.random.default_rng(3)
    traces = rng.standard_normal((4, N)) * 1e-8
    traces += 3e-6 * t1 + 2e-6 * np.roll(t2, 37)

    def run_pair(nlen, tt1, tt2, trc, window):
        psd = np.full(nlen, 1e-16)
        psd[0] = np.inf
        bb1 = filterbank.make_of1x1_bank(tt1, psd, FS, nlen // 2)
        bb2 = filterbank.make_of1x1_bank(tt2, psd, FS, nlen // 2)
        vfft = of1x1.signal_fft(jnp.asarray(trc)[:, None, :])
        full = of1x1.of1x2(
            vfft,
            jnp.asarray(bb1.phi), jnp.asarray(bb1.norm),
            jnp.asarray(bb1.s_fft),
            jnp.asarray(bb2.phi), jnp.asarray(bb2.norm),
            jnp.asarray(bb2.s_fft),
            jnp.asarray(bb1.denom_inv), nlen // 2, FS,
            delta_window=window)
        nh = nlen // 2 + 1
        bin_w = np.full(nh, 2.0)
        bin_w[0] = 1.0
        bin_w[-1] = 1.0
        sl = np.arange(nh)
        vr = of1x1.signal_rfft(jnp.asarray(trc)[:, None, :])
        half = of1x1.of1x2_half(
            vr,
            jnp.asarray(bb1.phi[:, sl]), jnp.asarray(bb1.norm),
            jnp.asarray(bb2.phi[:, sl]), jnp.asarray(bb2.norm),
            jnp.asarray(bb2.s_fft[:, sl]),
            jnp.asarray(bb1.denom_inv[:, sl]), jnp.asarray(bin_w[sl]),
            nlen // 2, FS, nlen, delta_window=window)
        for a, b in zip(full, half):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-8, atol=1e-20)

    run_pair(N, t1, t2, traces, np.arange(0, 80))
    n2 = 16384
    tt1 = pulse.make_template(FS, n2, n2 // 2, A=1.0, tau_r=10e-6,
                              tau_f1=60e-6)
    tt2 = pulse.make_template(FS, n2, n2 // 2, A=1.0, tau_r=30e-6,
                              tau_f1=400e-6)
    tr2 = rng.standard_normal((2, n2)) * 1e-8
    tr2 += 3e-6 * tt1 + 2e-6 * np.roll(tt2, 50)
    run_pair(n2, tt1, tt2, tr2, np.arange(0, 100))
