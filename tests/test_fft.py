"""The FFT entry points (ops/fft.py) and the natural half-spectrum OF
chain built on them, against numpy and the float64 loop reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detprocess_jax.models import pulse
from detprocess_jax.ops import fft as dfft
from detprocess_jax.ops import filterbank, of1x1

from reference_impl import RefOF1x1

FS = 1.25e6

# powers of two, odd, prime (8191, 4099) and mixed-radix composite sizes:
# every length the transforms must handle without a special path
SIZES = (16, 255, 1024, 4096, 4099, 8191, 12000, 16384, 32768, 65536)


@pytest.mark.parametrize("n", SIZES)
def test_wrappers_match_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(np.asarray(dfft.fft(jnp.asarray(x))), ref,
                               rtol=0, atol=1e-9 * np.max(np.abs(ref)))
    ref_i = np.fft.ifft(x, axis=-1)
    np.testing.assert_allclose(np.asarray(dfft.ifft(jnp.asarray(x))), ref_i,
                               rtol=0, atol=1e-9 * np.max(np.abs(ref_i)))
    xr = x.real
    ref_r = np.fft.rfft(xr, axis=-1)
    r = dfft.rfft(jnp.asarray(xr))
    np.testing.assert_allclose(np.asarray(r), ref_r, rtol=0,
                               atol=1e-9 * np.max(np.abs(ref_r)))
    np.testing.assert_allclose(np.asarray(dfft.irfft(r, n)), xr, atol=1e-9)


def test_fft_axis_argument():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8192, 3))
    got = np.asarray(dfft.fft(jnp.asarray(x), axis=0))
    ref = np.fft.fft(x, axis=0)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-9 * np.max(np.abs(ref)))
    back = np.asarray(dfft.irfft(dfft.rfft(jnp.asarray(x), axis=0), 8192,
                                 axis=0))
    np.testing.assert_allclose(back, x, atol=1e-9)


def test_einsum_runs_at_highest_precision():
    """Every contraction helper pins HIGHEST: the GPU default is TF32."""
    a = jnp.ones((4, 8), jnp.float32)
    b = jnp.ones((8, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p, q: dfft.einsum("ij,jk->ik", p, q))(a, b)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec == (dfft.HIGHEST, dfft.HIGHEST), prec


@pytest.mark.parametrize("n", (255, 1000, 4097, 8191, 12000, 16384, 32768))
def test_natural_chain_matches_reference(n):
    """rfft → half-spectrum no-delay / delay-scan / constrained fits →
    irfft equals the per-event float64 loop reference at every length,
    odd and prime included."""
    pre = n // 2
    rng = np.random.default_rng(n + 1)
    template = pulse.make_template(FS, n, pre, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    f = np.abs(np.fft.fftfreq(n, 1 / FS))
    f[0] = f[1]
    psd = 1e-20 * (1 + 100 / f)
    shifts = rng.integers(-40, 40, 3)
    traces = rng.standard_normal((3, n)) * 1e-8 + np.stack(
        [a * np.roll(template, s)
         for a, s in zip(rng.uniform(1e-6, 3e-6, 3), shifts)])
    bank = filterbank.make_of1x1_bank(template, psd, FS, pre)
    bh = filterbank.device_bank_1x1_half(
        jax.tree.map(jnp.asarray, bank.to_device(np.float64)))
    vr = of1x1.signal_rfft(jnp.asarray(traces)[:, None, :])
    lm = jnp.asarray(of1x1.lowfreq_mask_half(n, FS, 10000.0))
    win = (pre - 50, pre + 50)
    wmask = np.zeros(n, bool)
    wmask[win[0]:win[1] + 1] = True
    nod = of1x1.of1x1_nodelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                   bh.s_fft, bh.bin_w, lm, n=n)
    unc = of1x1.of1x1_withdelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                     bh.s_fft, bh.bin_w, pre, FS,
                                     low_mask_h=lm, n=n)
    con = of1x1.of1x1_withdelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                     bh.s_fft, bh.bin_w, pre, FS,
                                     window_mask=jnp.asarray(wmask), n=n)
    ref = RefOF1x1(template, psd, FS, pre)
    for i, tr in enumerate(traces):
        a0, c0, l0 = ref.fit_nodelay(tr, lowchi2_fcutoff=10000.0)
        np.testing.assert_allclose(float(nod.amp[i, 0]), a0, rtol=1e-9)
        np.testing.assert_allclose(float(nod.chi2[i, 0]), c0, rtol=1e-9)
        np.testing.assert_allclose(float(nod.lowchi2[i, 0]), l0, rtol=1e-8)
        a1, t1, c1, l1 = ref.fit_withdelay(tr, lowchi2_fcutoff=10000.0)
        np.testing.assert_allclose(float(unc.amp[i, 0]), a1, rtol=1e-9)
        assert float(unc.t0[i, 0]) == pytest.approx(t1, abs=1e-12)
        np.testing.assert_allclose(float(unc.chi2[i, 0]), c1, rtol=1e-9)
        np.testing.assert_allclose(float(unc.lowchi2[i, 0]), l1, rtol=1e-8)
        a2, t2, c2, _ = ref.fit_withdelay(tr, window=win)
        np.testing.assert_allclose(float(con.amp[i, 0]), a2, rtol=1e-9)
        assert float(con.t0[i, 0]) == pytest.approx(t2, abs=1e-12)
        np.testing.assert_allclose(float(con.chi2[i, 0]), c2, rtol=1e-9)
