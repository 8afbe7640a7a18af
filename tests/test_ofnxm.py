"""Golden tests for NxM multichannel optimal-filter kernels."""

import numpy as np
import jax.numpy as jnp
import pytest

from detprocess_jax.models import pulse
from detprocess_jax.ops import filterbank, ofnxm, of1x1

from reference_impl import RefOFNxM, generate_correlated_noise

FS = 1.25e6
N = 1024
PRETRIG = 256
C, M = 2, 2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    # two channels, two templates (fast/slow)
    t_fast = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=10e-6,
                                 tau_f1=60e-6)
    t_slow = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                 tau_f1=300e-6)
    templates = np.zeros((C, M, N))
    templates[0, 0] = t_fast
    templates[1, 0] = 0.4 * t_fast
    templates[0, 1] = 0.3 * t_slow
    templates[1, 1] = t_slow

    # correlated noise CSD: white diagonals + mild correlation
    csd = np.zeros((C, C, N), dtype=complex)
    csd[0, 0] = 1e-20
    csd[1, 1] = 2e-20
    csd[0, 1] = 0.3e-20 * np.exp(1j * 0.2)
    csd[1, 0] = np.conj(csd[0, 1])

    traces = generate_correlated_noise(csd, FS, 16, rng)
    amps_true = rng.uniform(0.5e-6, 2e-6, (16, M))
    offsets = rng.integers(-40, 40, 16)
    for i in range(16):
        sig = np.einsum("cmn,m->cn", templates, amps_true[i])
        traces[i] += np.roll(sig, offsets[i], axis=-1)

    bank = filterbank.make_ofnxm_bank(templates, csd, FS, PRETRIG)
    ref = RefOFNxM(templates, csd, FS, PRETRIG)
    return templates, csd, traces, amps_true, offsets, bank, ref


def test_weight_matrix_matches_reference(setup):
    *_, bank, ref = setup
    np.testing.assert_allclose(bank.w_matrix, ref.w, rtol=1e-10)
    np.testing.assert_allclose(bank.iw_matrix, ref.iw, rtol=1e-10)


def test_nodelay_matches_reference(setup):
    _, _, traces, _, _, bank, ref = setup
    vfft = of1x1.signal_fft(jnp.asarray(traces))        # [B, C, N]
    res = ofnxm.ofnxm_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.iw_matrix),
                              jnp.asarray(bank.icsd), FS)
    for i in range(traces.shape[0]):
        amps, chi2 = ref.fit_nodelay(traces[i])
        np.testing.assert_allclose(np.asarray(res.amps[i]), amps, rtol=1e-8)
        np.testing.assert_allclose(float(res.chi2[i]), chi2, rtol=1e-8)


def test_withdelay_matches_reference(setup):
    _, _, traces, _, _, bank, ref = setup
    vfft = of1x1.signal_fft(jnp.asarray(traces))
    res = ofnxm.ofnxm_withdelay(vfft, jnp.asarray(bank.phi),
                                jnp.asarray(bank.w_matrix),
                                jnp.asarray(bank.iw_matrix),
                                jnp.asarray(bank.icsd), PRETRIG, FS)
    for i in range(traces.shape[0]):
        amps, t0, chi2 = ref.fit_withdelay(traces[i])
        np.testing.assert_allclose(np.asarray(res.amps[i]), amps, rtol=1e-8)
        np.testing.assert_allclose(float(res.t0[i]), t0, atol=1e-12)
        np.testing.assert_allclose(float(res.chi2[i]), chi2, rtol=1e-8)


def test_withdelay_direct_equals_masked(setup):
    """The direct windowed DFT-matmul NxM kernel must match the masked
    full-scan path exactly: contiguous and disjoint windows, with and
    without parabolic interpolation."""
    _, _, traces, _, _, bank, _ = setup
    n = traces.shape[-1]
    vfft = of1x1.signal_fft(jnp.asarray(traces))
    masks = []
    m1 = np.zeros(n, bool)
    m1[PRETRIG - 60:PRETRIG + 60] = True
    masks.append(m1)
    m2 = np.zeros(n, bool)
    m2[0:40] = True
    m2[PRETRIG:PRETRIG + 30] = True
    masks.append(m2)
    for mask in masks:
        for interp in (False, True):
            ref = ofnxm.ofnxm_withdelay(
                vfft, jnp.asarray(bank.phi), jnp.asarray(bank.w_matrix),
                jnp.asarray(bank.iw_matrix), jnp.asarray(bank.icsd),
                PRETRIG, FS, window_mask=jnp.asarray(mask),
                interpolate_t0=interp)
            eidx, valid, cmat, smat = of1x1.prepare_delay_window(
                mask, PRETRIG, n)
            got = ofnxm.ofnxm_withdelay_direct(
                vfft, jnp.asarray(bank.phi), jnp.asarray(bank.w_matrix),
                jnp.asarray(bank.iw_matrix), jnp.asarray(bank.icsd),
                PRETRIG, FS, eidx, valid, cmat, smat,
                interpolate_t0=interp)
            np.testing.assert_allclose(np.asarray(got.amps),
                                       np.asarray(ref.amps), rtol=1e-8)
            np.testing.assert_allclose(np.asarray(got.t0),
                                       np.asarray(ref.t0), rtol=0,
                                       atol=1e-9 / FS)
            np.testing.assert_allclose(np.asarray(got.chi2),
                                       np.asarray(ref.chi2), rtol=1e-8)


def test_withdelay_recovers_injection(setup):
    _, _, traces, amps_true, offsets, bank, _ = setup
    vfft = of1x1.signal_fft(jnp.asarray(traces))
    res = ofnxm.ofnxm_withdelay(vfft, jnp.asarray(bank.phi),
                                jnp.asarray(bank.w_matrix),
                                jnp.asarray(bank.iw_matrix),
                                jnp.asarray(bank.icsd), PRETRIG, FS)
    t0_samples = np.asarray(res.t0) * FS
    # most events: time found within 2 samples, amplitudes within 5 sigma
    sigma = bank.resolution
    ok_t = np.abs(t0_samples - offsets) <= 2
    assert np.mean(ok_t) > 0.8
    err = np.asarray(res.amps) - amps_true
    assert np.mean(np.abs(err[ok_t]) < 6 * sigma[None, :]) > 0.9


def test_chi2_statistics_nxm(setup):
    """On pure correlated noise, Δχ² at fixed t ~ χ²_M (mean ≈ M)."""
    templates, csd, *_ , bank, _ = setup
    rng = np.random.default_rng(5)
    noise = generate_correlated_noise(csd, FS, 128, rng)
    vfft = of1x1.signal_fft(jnp.asarray(noise))
    res = ofnxm.ofnxm_nodelay(vfft, jnp.asarray(bank.phi),
                              jnp.asarray(bank.iw_matrix),
                              jnp.asarray(bank.icsd), FS)
    q = np.einsum("cmk,bck->bm", bank.phi, np.fft.fft(noise, axis=-1)).real
    dchi2 = np.einsum("bi,ij,bj->b", q, bank.iw_matrix, q)
    assert abs(np.mean(dchi2) / M - 1.0) < 0.35


def test_single_channel_nxm_equals_1x1(setup):
    """NxM with C=M=1 must reproduce the 1x1 kernel exactly."""
    rng = np.random.default_rng(3)
    tmpl = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(N, 1e-20)
    trace = rng.standard_normal(N) * 1e-9 + 1.3e-6 * np.roll(tmpl, 17)

    bank1 = filterbank.make_of1x1_bank(tmpl, psd, FS, PRETRIG)
    bankn = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS, PRETRIG)

    vfft1 = of1x1.signal_fft(jnp.asarray(trace)[None, None, :])
    res1 = of1x1.of1x1_withdelay(vfft1, jnp.asarray(bank1.phi),
                                 jnp.asarray(bank1.norm),
                                 jnp.asarray(bank1.denom_inv),
                                 jnp.asarray(bank1.s_fft), PRETRIG, FS)
    vfftn = of1x1.signal_fft(jnp.asarray(trace)[None, None, :])
    resn = ofnxm.ofnxm_withdelay(vfftn, jnp.asarray(bankn.phi),
                                 jnp.asarray(bankn.w_matrix),
                                 jnp.asarray(bankn.iw_matrix),
                                 jnp.asarray(bankn.icsd), PRETRIG, FS)
    np.testing.assert_allclose(float(resn.amps[0, 0]), float(res1.amp[0, 0]),
                               rtol=1e-9)
    np.testing.assert_allclose(float(resn.t0[0]), float(res1.t0[0, 0]),
                               atol=1e-12)
    np.testing.assert_allclose(float(resn.chi2[0]), float(res1.chi2[0, 0]),
                               rtol=1e-9)


def test_ofnxmx2_two_pulse_separation():
    """NxMx2: two template groups at different times are both recovered."""
    rng = np.random.default_rng(9)
    t1 = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=10e-6, tau_f1=80e-6)
    t2 = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=30e-6, tau_f1=400e-6)
    templates = np.stack([t1, t2])[None, :, :]     # C=1, M=2
    csd = np.full((1, 1, N), 1e-20, dtype=complex)
    bank = filterbank.make_ofnxm_bank(templates, csd, FS, PRETRIG)

    d1_true, d2_true = -12, 23
    trace = (rng.standard_normal(N) * 1e-10
             + 2e-6 * np.roll(t1, d1_true)
             + 1e-6 * np.roll(t2, d2_true))[None, :]

    w1 = np.zeros(N, bool)
    w1[PRETRIG - 40: PRETRIG + 41] = True
    w2 = w1.copy()
    vfft = of1x1.signal_fft(jnp.asarray(trace)[None])   # [1, C, N]
    (res, (d1, d2)) = ofnxm.ofnxmx2(
        vfft, jnp.asarray(bank.s_fft), jnp.asarray(bank.icsd),
        np.array([0, 1]), w1, w2, PRETRIG, FS)
    assert int(d1[0]) == PRETRIG + d1_true
    assert int(d2[0]) == PRETRIG + d2_true
    np.testing.assert_allclose(float(res.deltat[0]),
                               (d2_true - d1_true) / FS, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.amps[0]), [2e-6, 1e-6],
                               rtol=1e-3)


def test_ofnxmx2_matches_brute_force_grid():
    """Exactness: the masked (d1, d2) window scan equals a direct numpy
    grid solve of the coupled system at every pair (amplitudes via the
    shifted-template weight-matrix inverse, winner by max delta-chi2)."""
    rng = np.random.default_rng(21)
    nn = 256
    pre = 64
    t1 = pulse.make_template(FS, nn, pre, A=1.0, tau_r=10e-6, tau_f1=60e-6)
    t2 = pulse.make_template(FS, nn, pre, A=1.0, tau_r=25e-6,
                             tau_f1=200e-6)
    templates = np.stack([t1, t2])[None, :, :]
    csd = np.full((1, 1, nn), 3e-20, dtype=complex)
    bank = filterbank.make_ofnxm_bank(templates, csd, FS, pre)

    trace = (rng.standard_normal(nn) * 2e-8
             + 3e-6 * np.roll(t1, -5) + 2e-6 * np.roll(t2, 11))[None, :]
    w1 = np.zeros(nn, bool)
    w1[pre - 8: pre + 9] = True
    w2 = np.zeros(nn, bool)
    w2[pre + 5: pre + 20] = True

    vfft = of1x1.signal_fft(jnp.asarray(trace)[None])
    (res, (d1, d2)) = ofnxm.ofnxmx2(
        vfft, jnp.asarray(bank.s_fft), jnp.asarray(bank.icsd),
        np.array([0, 1]), w1, w2, pre, FS)

    # brute force in plain numpy over the same windows
    v = np.fft.fft(trace[0])
    s = bank.s_fft[0]                      # [M, N]
    icsd = bank.icsd[:, 0, 0]              # [N] (C=1)
    k = np.arange(nn)
    phi = np.conj(s) * icsd[None, :] / (nn * FS)

    def q_at(m, d_abs):
        shift = d_abs - pre
        return np.real(np.sum(phi[m] * v * np.exp(
            2j * np.pi * k * shift / nn)))

    def overlap(i, j, di, dj):
        rel = (di - dj)
        return np.real(np.sum(
            phi[i] * s[j] * np.exp(2j * np.pi * k * rel / nn))) / FS * FS

    best = (-np.inf, None)
    for da in np.where(w1)[0]:
        for db in np.where(w2)[0]:
            p = np.empty((2, 2))
            p[0, 0] = overlap(0, 0, 0, 0)
            p[1, 1] = overlap(1, 1, 0, 0)
            p[0, 1] = overlap(0, 1, da - pre, db - pre)
            p[1, 0] = p[0, 1]
            q = np.array([q_at(0, da), q_at(1, db)])
            a = np.linalg.solve(p, q)
            dchi2 = q @ a
            if dchi2 > best[0]:
                best = (dchi2, (a, da, db))
    a_bf, da_bf, db_bf = best[1]

    assert int(d1[0]) == da_bf
    assert int(d2[0]) == db_bf
    np.testing.assert_allclose(np.asarray(res.amps[0]), a_bf, rtol=1e-8)


def test_ofnxmx2_direct_and_ifft_branches_agree(monkeypatch):
    """The windowed-direct DFT q-evaluation (union <= DIRECT_UNION_MAX)
    and the full-ifft gather must produce identical fits on the same
    input — forced by toggling the dispatch threshold."""
    rng = np.random.default_rng(33)
    nn, pre = 1024, 256
    t1 = pulse.make_template(FS, nn, pre, A=1.0, tau_r=10e-6, tau_f1=60e-6)
    t2 = pulse.make_template(FS, nn, pre, A=1.0, tau_r=25e-6,
                             tau_f1=200e-6)
    templates = np.stack([t1, t2])[None, :, :]
    csd = np.full((1, 1, nn), 3e-20, dtype=complex)
    bank = filterbank.make_ofnxm_bank(templates, csd, FS, pre)

    trace = (rng.standard_normal((3, nn)) * 2e-8
             + 3e-6 * np.roll(t1, -7) + 2e-6 * np.roll(t2, 14))
    w1 = np.zeros(nn, bool)
    w1[pre - 20: pre + 21] = True
    w2 = np.zeros(nn, bool)
    w2[pre: pre + 30] = True
    vfft = of1x1.signal_fft(jnp.asarray(trace)[:, None, :])

    outs = {}
    for label, thresh in (("direct", 512), ("ifft", 0)):
        monkeypatch.setattr(ofnxm, "DIRECT_UNION_MAX", thresh)
        (res, (d1, d2)) = ofnxm.ofnxmx2(
            vfft, jnp.asarray(bank.s_fft), jnp.asarray(bank.icsd),
            np.array([0, 1]), w1, w2, pre, FS)
        outs[label] = (np.asarray(res.amps), np.asarray(res.chi2),
                       np.asarray(d1), np.asarray(d2))

    np.testing.assert_array_equal(outs["direct"][2], outs["ifft"][2])
    np.testing.assert_array_equal(outs["direct"][3], outs["ifft"][3])
    np.testing.assert_allclose(outs["direct"][0], outs["ifft"][0],
                               rtol=1e-9)
    np.testing.assert_allclose(outs["direct"][1], outs["ifft"][1],
                               rtol=1e-9)


def test_exact_recovery_phase_correlated_csd():
    """phi must be conj(J⁻¹s̃): with a PHYSICAL CSD whose cross-channel
    terms carry frequency-dependent phase (estimated from time-shifted
    correlated noise), a noiseless exact-template event must be
    recovered exactly with χ² ≈ 0. The transposed form J⁻¹·conj(s̃)
    biased amplitudes by ~5% on this input (round-2 review finding)."""
    rng = np.random.default_rng(0)
    nn, pre = 512, 128
    t1 = pulse.make_template(FS, nn, pre, A=1.0, tau_r=10e-6, tau_f1=60e-6)
    t2 = pulse.make_template(FS, nn, pre, A=1.0, tau_r=25e-6,
                             tau_f1=200e-6)
    templates = np.zeros((2, 2, nn))
    templates[0, 0] = t1
    templates[1, 0] = 0.5 * t1
    templates[0, 1] = 0.2 * t2
    templates[1, 1] = t2

    nev = 4000
    w0 = rng.standard_normal((nev, nn))
    w1 = 0.6 * np.roll(w0, 3, axis=1) + 0.8 * rng.standard_normal(
        (nev, nn))
    v = np.fft.fft(np.stack([w0, w1], axis=1) * 1e-9, axis=-1)
    csd = np.einsum("bik,bjk->ijk", v, np.conj(v)) / nev / (nn * FS)
    assert np.abs(csd[0, 1, 16].imag) > 0.01 * np.abs(csd[0, 1, 16])

    bank = filterbank.make_ofnxm_bank(templates, csd, FS, pre)
    a_true = np.array([2.0e-6, -1.5e-6])
    trace = np.einsum("cmn,m->cn", templates, a_true)
    vf = of1x1.signal_fft(jnp.asarray(trace)[None])
    res = ofnxm.ofnxm_nodelay(vf, jnp.asarray(bank.phi),
                              jnp.asarray(bank.iw_matrix),
                              jnp.asarray(bank.icsd), FS)
    np.testing.assert_allclose(np.asarray(res.amps[0]), a_true, rtol=1e-8)
    c0 = float(ofnxm.chi2_base_nxm(vf, jnp.asarray(bank.icsd), FS)[0])
    assert abs(float(res.chi2[0])) < 1e-8 * c0

    # delay scan exact too
    vf2 = of1x1.signal_fft(jnp.asarray(np.roll(trace, 9, -1))[None])
    r2 = ofnxm.ofnxm_withdelay(vf2, jnp.asarray(bank.phi),
                               jnp.asarray(bank.w_matrix),
                               jnp.asarray(bank.iw_matrix),
                               jnp.asarray(bank.icsd), pre, FS)
    np.testing.assert_allclose(np.asarray(r2.amps[0]), a_true, rtol=1e-8)
    assert round(float(r2.t0[0]) * FS) == 9
