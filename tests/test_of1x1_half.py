"""Half-spectrum OF kernels must equal the full-spectrum kernels exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from detprocess_jax.models import pulse
from detprocess_jax.ops import filterbank, of1x1

FS = 1.25e6
N = 8192
PRETRIG = 2048


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    f = np.abs(np.fft.fftfreq(N, 1 / FS))
    f[0] = f[1]
    psd = 1e-20 * (1 + 100 / f)
    traces = rng.standard_normal((8, N)) * 1e-8
    traces += rng.uniform(1e-6, 3e-6, 8)[:, None] * np.stack(
        [np.roll(template, s) for s in rng.integers(-100, 100, 8)])
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    dev = jax.tree.map(jnp.asarray, bank.to_device(np.float64))
    return traces, bank, dev


def test_rfft_equals_fft_half(setup):
    traces, _, _ = setup
    vr = np.asarray(of1x1.signal_rfft(jnp.asarray(traces)))
    full = np.fft.fft(traces, axis=-1)
    np.testing.assert_allclose(vr, full[:, : N // 2 + 1], rtol=1e-10,
                               atol=1e-9 * np.max(np.abs(full)))


def test_nodelay_half_equals_full(setup):
    traces, bank, dev = setup
    bk = filterbank.device_bank_1x1(dev)
    bh = filterbank.device_bank_1x1_half(dev)
    vfft = of1x1.signal_fft(jnp.asarray(traces)[:, None, :])
    vr = of1x1.signal_rfft(jnp.asarray(traces)[:, None, :])
    lm_full = jnp.asarray(of1x1.lowfreq_mask(N, FS, 10000.0))
    lm_half = jnp.asarray(of1x1.lowfreq_mask_half(N, FS, 10000.0))
    full = of1x1.of1x1_nodelay(vfft, bk.phi, bk.norm, bk.denom_inv,
                               bk.s_fft, lm_full)
    half = of1x1.of1x1_nodelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                    bh.s_fft, bh.bin_w, lm_half, n=N)
    np.testing.assert_allclose(np.asarray(half.amp), np.asarray(full.amp),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(half.chi2), np.asarray(full.chi2),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(half.lowchi2),
                               np.asarray(full.lowchi2), rtol=1e-9)


def test_withdelay_half_equals_full(setup):
    traces, bank, dev = setup
    bk = filterbank.device_bank_1x1(dev)
    bh = filterbank.device_bank_1x1_half(dev)
    vfft = of1x1.signal_fft(jnp.asarray(traces)[:, None, :])
    vr = of1x1.signal_rfft(jnp.asarray(traces)[:, None, :])
    wmask = np.zeros(N, dtype=bool)
    wmask[PRETRIG - 200:PRETRIG + 200] = True
    for kwargs in ({}, {"window_mask": jnp.asarray(wmask)},
                   {"interpolate_t0": True}):
        full = of1x1.of1x1_withdelay(vfft, bk.phi, bk.norm, bk.denom_inv,
                                     bk.s_fft, PRETRIG, FS, **kwargs)
        half = of1x1.of1x1_withdelay_half(vr, bh.phi, bh.norm,
                                          bh.denom_inv, bh.s_fft, bh.bin_w,
                                          PRETRIG, FS, **kwargs)
        np.testing.assert_allclose(np.asarray(half.amp),
                                   np.asarray(full.amp), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(half.t0),
                                   np.asarray(full.t0), atol=1e-12)
        np.testing.assert_allclose(np.asarray(half.chi2),
                                   np.asarray(full.chi2), rtol=1e-9)


def test_windowed_direct_equals_masked_irfft(setup):
    """The direct windowed DFT-matmul kernel (round-3 perf path for
    narrow constrained windows) must match the masked irfft scan
    exactly: contiguous windows, outside-window (two runs, wrapping
    guards), low-frequency chi2, and parabolic interpolation."""
    traces, bank, dev = setup
    bh = filterbank.device_bank_1x1_half(dev)
    vr = of1x1.signal_rfft(jnp.asarray(traces)[:, None, :])
    lm_half = jnp.asarray(of1x1.lowfreq_mask_half(N, FS, 10000.0))
    binw_host = np.asarray(bh.bin_w, np.float64)

    masks = []
    wmask = np.zeros(N, dtype=bool)
    wmask[PRETRIG - 200:PRETRIG + 200] = True
    masks.append(wmask)
    # window touching the trace start (guard wraps modulo N)
    m2 = np.zeros(N, dtype=bool)
    m2[0:64] = True
    masks.append(m2)
    # two disjoint runs (lgc_outside_window shape)
    m3 = np.zeros(N, dtype=bool)
    m3[100:150] = True
    m3[5000:5030] = True
    masks.append(m3)

    for mask in masks:
        for interp in (False, True):
            ref = of1x1.of1x1_withdelay_half(
                vr, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w,
                PRETRIG, FS, window_mask=jnp.asarray(mask),
                low_mask_h=lm_half, interpolate_t0=interp, n=N)
            eidx, valid, cmat, smat = of1x1.prepare_delay_window(
                mask, PRETRIG, N, binw_host)
            got = of1x1.of1x1_windowed_direct_half(
                vr, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w,
                PRETRIG, FS, eidx, valid, cmat, smat,
                low_mask_h=lm_half, interpolate_t0=interp, n=N)
            np.testing.assert_allclose(np.asarray(got.amp),
                                       np.asarray(ref.amp), rtol=1e-9)
            np.testing.assert_allclose(np.asarray(got.t0),
                                       np.asarray(ref.t0), rtol=0,
                                       atol=1e-9 / FS)
            np.testing.assert_allclose(np.asarray(got.chi2),
                                       np.asarray(ref.chi2), rtol=1e-9)
            np.testing.assert_allclose(np.asarray(got.lowchi2),
                                       np.asarray(ref.lowchi2), rtol=1e-9)


def test_constrained_window_randomized():
    """Window-constrained delay fits exact vs the loop oracle across
    random geometries and windows."""
    import jax
    from detprocess_jax.models import pulse as pulse_mod
    from reference_impl import RefOF1x1, generate_noise

    rng = np.random.default_rng(11)
    for _ in range(4):
        n = int(2 ** rng.integers(9, 11))
        p = int(rng.integers(10, n - 10))
        tmpl = pulse_mod.make_template(FS, n, p, A=1.0, tau_r=15e-6,
                                       tau_f1=150e-6)
        f = np.abs(np.fft.fftfreq(n, 1 / FS))
        f[0] = f[1]
        psd = 1e-20 * (1 + rng.uniform(10, 200) / f)
        bank = filterbank.make_of1x1_bank(tmpl, psd, FS, p)
        ref = RefOF1x1(tmpl, psd, FS, p)
        traces = (generate_noise(psd, FS, 4, rng)
                  + rng.uniform(0.5e-6, 3e-6)
                  * np.roll(tmpl, int(rng.integers(-40, 40))))
        wlo = int(rng.integers(0, n - 20))
        whi = int(rng.integers(wlo + 5, n - 1))
        dev = jax.tree.map(jnp.asarray, bank.to_device(np.float64))
        bh = filterbank.device_bank_1x1_half(dev)
        vr = of1x1.signal_rfft(jnp.asarray(traces)[:, None, :])
        mask = np.zeros(n, bool)
        mask[wlo:whi + 1] = True
        res = of1x1.of1x1_withdelay_half(
            vr, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w, p, FS,
            window_mask=jnp.asarray(mask))
        for i in range(len(traces)):
            a_ref, _, c_ref, _ = ref.fit_withdelay(traces[i],
                                                   window=(wlo, whi))
            a = float(np.asarray(res.amp)[i, 0])
            c = float(np.asarray(res.chi2)[i, 0])
            assert abs(a - a_ref) < 1e-9 + 1e-6 * abs(a_ref)
            assert abs(c - c_ref) < 1e-6 * abs(c_ref) + 1e-6


def test_withdelay_half_odd_length():
    """Odd trace lengths: the half path must be told n explicitly (the
    2*(nh-1) reconstruction only holds for even n)."""
    import numpy as np
    from detprocess_jax.models import pulse as pl

    fs = 1.25e6
    n = 1025
    pre = 256
    tmpl = pl.make_template(fs, n, pre, A=1.0, tau_r=20e-6, tau_f1=200e-6)
    psd = np.full(n, 1e-18)
    bank = filterbank.make_of1x1_bank(tmpl, psd, fs, pre)
    rng = np.random.default_rng(0)
    tr = rng.standard_normal((4, n)) * 1e-8 + 2e-6 * np.roll(tmpl, 7)

    vf = of1x1.signal_fft(jnp.asarray(tr)[:, None, :])
    full = of1x1.of1x1_withdelay(vf, jnp.asarray(bank.phi),
                                 jnp.asarray(bank.norm),
                                 jnp.asarray(bank.denom_inv),
                                 jnp.asarray(bank.s_fft), pre, fs)
    dev = bank.to_device(np.float64)
    bh = filterbank.device_bank_1x1_half(
        {k: jnp.asarray(v) for k, v in dev.items()})
    vr = of1x1.signal_rfft(jnp.asarray(tr)[:, None, :])
    half = of1x1.of1x1_withdelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                      bh.s_fft, bh.bin_w, pre, fs, n=n)
    np.testing.assert_allclose(np.asarray(half.amp), np.asarray(full.amp),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(half.t0), np.asarray(full.t0),
                               atol=1e-12)
