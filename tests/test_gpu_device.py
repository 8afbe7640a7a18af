"""On-device (NVIDIA GPU) regression tests — the ``gpu`` lane.

Run on a machine with a card:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_device.py

Everything else runs float64 CPU goldens; a device-only regression
(cuFFT float32 accuracy, a TF32 contraction that lost its explicit
precision, the complex split/join bank format) would otherwise surface
only as a silently wrong benchmark. These tests pin the core kernels on
the card with float32 tolerances. Without a GPU they skip (the ``gpu``
fixture in conftest.py decides, at run time).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reference_impl import RefOF1x1

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


FS = 1.25e6
N = 32768
PRETRIG = N // 2


@pytest.fixture(scope="module")
def bank_and_template():
    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank

    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 1e-16)
    psd[0] = np.inf
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    dev = jax.tree.map(jnp.asarray, bank.to_device(np.float32))
    return template, bank, dev


def test_fft_large_n_roundtrip_f32():
    """32k cuFFT rfft/irfft vs numpy, f32 tolerances."""
    from detprocess_jax.ops import fft as dfft

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, N)).astype(np.float32)
    ref = np.fft.fft(x)

    @jax.jit
    def rt(x):
        xf = dfft.rfft(x, axis=-1)
        back = dfft.irfft(xf, N, axis=-1)
        return jnp.stack([xf.real, xf.imag], 0), back

    (ri, back) = rt(jnp.asarray(x))
    got = np.asarray(ri[0]) + 1j * np.asarray(ri[1])
    scale = np.abs(ref).max()
    assert np.max(np.abs(got - ref[..., : N // 2 + 1])) < 2e-5 * scale
    np.testing.assert_allclose(np.asarray(back), x, atol=2e-6)


def test_natural_chain_matches_reference_on_device(bank_and_template):
    """The shipping float32 feature chain (cuFFT rfft → half-spectrum
    no-delay and delay-scan fits → irfft) against the float64 loop
    reference: rtol 1e-4 on amplitude; χ² to 1e-4 of itself plus 1e-5 of
    the no-pulse χ²₀ (χ² = χ²₀ − Δχ² cancels χ²₀'s leading digits); t0
    within one sample."""
    from detprocess_jax.ops import filterbank, of1x1

    template, bank, dev = bank_and_template
    rng = np.random.default_rng(8)
    shifts = rng.integers(-30, 30, 8)
    traces = (rng.standard_normal((8, N)) * 1e-8 + np.stack(
        [3e-6 * np.roll(template, s) for s in shifts])).astype(np.float32)

    @jax.jit
    def step(tr, dev):
        bh = filterbank.device_bank_1x1_half(dev)
        vr = of1x1.signal_rfft(tr[:, None, :])
        nd = of1x1.of1x1_nodelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                      bh.s_fft, bh.bin_w, n=N)
        wd = of1x1.of1x1_withdelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                        bh.s_fft, bh.bin_w, PRETRIG, FS)
        return nd.amp[:, 0], nd.chi2[:, 0], wd.amp[:, 0], wd.t0[:, 0], \
            wd.chi2[:, 0]

    na, nc, wa, wt, wc = map(np.asarray, step(jnp.asarray(traces), dev))
    psd = np.full(N, 1e-16)
    psd[0] = np.inf
    ref = RefOF1x1(template, psd, FS, PRETRIG)
    for i, tr in enumerate(traces.astype(np.float64)):
        a0, c0, _ = ref.fit_nodelay(tr)
        a1, t1, c1, _ = ref.fit_withdelay(tr)
        chi2_tol = 1e-5 * ref.chi2_nopulse(tr)
        np.testing.assert_allclose(na[i], a0, rtol=1e-4)
        np.testing.assert_allclose(nc[i], c0, rtol=1e-4, atol=chi2_tol)
        np.testing.assert_allclose(wa[i], a1, rtol=1e-4)
        np.testing.assert_allclose(wc[i], c1, rtol=1e-4, atol=chi2_tol)
        assert abs(wt[i] - t1) * FS <= 1.0


def test_of1x1_full_equals_half_on_device(bank_and_template):
    from detprocess_jax.ops import filterbank, of1x1

    template, bank, dev = bank_and_template
    rng = np.random.default_rng(1)
    traces = (rng.standard_normal((16, N)) * 1e-8
              + 3e-6 * template[None, :]).astype(np.float32)

    @jax.jit
    def both(tr, dev):
        bk = filterbank.device_bank_1x1(dev)
        bh = filterbank.device_bank_1x1_half(dev)
        vf = of1x1.signal_fft(tr[:, None, :])
        vr = of1x1.signal_rfft(tr[:, None, :])
        full = of1x1.of1x1_withdelay(vf, bk.phi, bk.norm, bk.denom_inv,
                                     bk.s_fft, PRETRIG, FS)
        half = of1x1.of1x1_withdelay_half(vr, bh.phi, bh.norm,
                                          bh.denom_inv, bh.s_fft,
                                          bh.bin_w, PRETRIG, FS)
        return full.amp, half.amp, full.chi2, half.chi2, half.t0

    fa, ha, fc, hc, t0 = map(np.asarray, both(jnp.asarray(traces), dev))
    np.testing.assert_allclose(ha, fa, rtol=1e-4)
    np.testing.assert_allclose(hc, fc, rtol=1e-3)
    # physics: amplitude recovered at f32 accuracy
    np.testing.assert_allclose(ha[:, 0], 3e-6, rtol=1e-3)
    assert np.all(np.abs(t0) < 2 / FS)


def test_welch_psd_white_level_on_device():
    from detprocess_jax.ops import spectral

    rng = np.random.default_rng(2)
    sigma = 1e-8
    x = (rng.standard_normal((64, 16384)) * sigma).astype(np.float32)
    psd = np.asarray(jax.jit(lambda t: spectral.welch_psd(t, FS))(
        jnp.asarray(x)))
    assert abs(psd[10:].mean() / (sigma**2 / FS) - 1.0) < 0.05


def test_trigger_finds_injected_pulses_on_device():
    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank, trigger as trig

    nt, pre = 4096, 1024
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(nt, 4e-18)
    bank = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS, pre)
    kernel = trig.make_trigger_kernel(bank)
    thr = trig.chi2_threshold(6.0, 1)
    iw = jnp.asarray(kernel.iw_matrix)

    rng = np.random.default_rng(3)
    l = 2**19
    x = (rng.standard_normal((1, l)) * np.sqrt(psd[0] * FS)).astype(
        np.float32)
    inj = list(range(40_000, l - 40_000, 61_337))
    for t0 in inj:
        x[0, t0 - pre: t0 - pre + nt] += 3e-6 * tmpl   # ~13 sigma_amp

    @jax.jit
    def step(x):
        qb, _ = trig.of_fir_blocks(x, kernel)
        d, a = trig.delta_chi2_blocks(qb, iw)
        return trig.find_triggers_blocks(d, a, thr, 125, 64)

    ts = step(jnp.asarray(x))
    cnt = int(np.asarray(ts.count))
    idx = np.asarray(ts.indices)[:cnt]
    for t0 in inj:
        assert any(abs(int(i) - t0) <= 10 for i in idx), t0
    assert cnt <= len(inj) + 2


def test_trigger_fused_tiled_on_device():
    """Fused trigger path on the card: Δχ² straight from q, tiled
    merge, amplitudes reconstructed at the winners only — must agree
    with the amps-materializing path bit-for-bit on indices."""
    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank, trigger as trig

    nt, pre = 4096, 1024
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(nt, 4e-18)
    bank = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS, pre)
    kernel = trig.make_trigger_kernel(bank)
    thr = trig.chi2_threshold(6.0, 1)
    iw = jnp.asarray(kernel.iw_matrix)

    rng = np.random.default_rng(5)
    l = 2**19
    x = (rng.standard_normal((1, l)) * np.sqrt(psd[0] * FS)).astype(
        np.float32)
    inj = list(range(40_000, l - 40_000, 61_337))
    for t0 in inj:
        x[0, t0 - pre: t0 - pre + nt] += 3e-6 * tmpl

    @jax.jit
    def fused(x):
        qb, _ = trig.of_fir_blocks(x, kernel)
        d = trig.delta_chi2_from_q(qb, iw)
        return trig.find_triggers_tiled(d, qb, thr, 125, 64,
                                        amps_transform=iw)

    @jax.jit
    def materialized(x):
        qb, _ = trig.of_fir_blocks(x, kernel)
        d, a = trig.delta_chi2_blocks(qb, iw)
        return trig.find_triggers_tiled(d, a, thr, 125, 64)

    ts_f = fused(jnp.asarray(x))
    ts_m = materialized(jnp.asarray(x))
    cnt = int(np.asarray(ts_f.count))
    assert cnt == int(np.asarray(ts_m.count))
    np.testing.assert_array_equal(np.asarray(ts_f.indices)[:cnt],
                                  np.asarray(ts_m.indices)[:cnt])
    np.testing.assert_allclose(np.asarray(ts_f.amplitudes)[:, :cnt],
                               np.asarray(ts_m.amplitudes)[:, :cnt],
                               rtol=2e-5)
    # every injection found; amplitudes near truth
    idx = np.asarray(ts_f.indices)[:cnt]
    amps = np.asarray(ts_f.amplitudes)[0, :cnt]
    for t0 in inj:
        k = int(np.argmin(np.abs(idx - t0)))
        assert abs(int(idx[k]) - t0) <= 10, t0
        # winner amplitude = unconstrained FIR value at the noisy argmax
        # (biased high by selection) — 20% window, exact fit is the
        # feature OF's job
        assert abs(amps[k] - 3e-6) / 3e-6 < 0.2, (t0, amps[k])


def test_residual_subtract_on_device():
    """The fori_loop dynamic-slice residual subtraction runs on the card
    and kills a clean trigger's Δχ² peak."""
    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank, trigger as trig

    nt, pre = 4096, 1024
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(nt, 4e-18)
    bank = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS, pre)
    kernel = trig.make_trigger_kernel(bank)
    thr = trig.chi2_threshold(6.0, 1)
    iw = jnp.asarray(kernel.iw_matrix)

    rng = np.random.default_rng(6)
    l = 2**18
    x = (rng.standard_normal((1, l)) * np.sqrt(psd[0] * FS)).astype(
        np.float32)
    t0 = l // 2
    x[0, t0 - pre: t0 - pre + nt] += 5e-6 * tmpl

    @jax.jit
    def step(x):
        qb, _ = trig.of_fir_blocks(x, kernel)
        d, a = trig.delta_chi2_blocks(qb, iw)
        dflat = d.reshape(-1)[: x.shape[-1]]
        ts = trig.find_triggers_kernel(
            dflat, a.reshape(a.shape[0], -1)[:, : x.shape[-1]],
            thr, 125, 16)
        resid = trig.residual_subtract(dflat, ts, kernel)
        return ts, dflat, resid

    ts, dflat, resid = step(jnp.asarray(x))
    cnt = int(np.asarray(ts.count))
    assert cnt >= 1
    # indices are sorted by position; pick the strongest trigger (a
    # 22 sigma pulse also raises sidelobe triggers near the main cluster)
    dv = np.asarray(ts.dchi2)[:cnt]
    i0 = int(np.asarray(ts.indices)[:cnt][int(np.argmax(dv))])
    assert abs(i0 - t0) <= 2
    assert float(np.asarray(resid[i0])) < 0.02 * float(
        np.asarray(dflat[i0]))


def test_residual_subtract_conv_on_device():
    """The spike+FFT-convolution subtraction (the pipeline default)
    matches the sequential loop on the card at f32 leakage scale."""
    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank, trigger as trig

    nt, pre = 4096, 1024
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(nt, 4e-18)
    bank = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS, pre)
    kernel = trig.make_trigger_kernel(bank)
    basis = trig.make_residual_basis(kernel)
    thr = trig.chi2_threshold(6.0, 1)
    iw = jnp.asarray(kernel.iw_matrix)

    rng = np.random.default_rng(6)
    l = 2**18
    x = (rng.standard_normal((1, l)) * np.sqrt(psd[0] * FS)).astype(
        np.float32)
    for t0 in (l // 2, l // 4):
        x[0, t0 - pre: t0 - pre + nt] += 5e-6 * tmpl

    @jax.jit
    def step(x):
        qb, _ = trig.of_fir_blocks(x, kernel)
        d = trig.delta_chi2_from_q(qb, iw)
        ts = trig.find_triggers_tiled(d, qb, thr, 125, 16,
                                      amps_transform=iw)
        dflat = d.reshape(-1)[: x.shape[-1]]
        loop = trig.residual_subtract(dflat, ts, kernel)
        conv = trig.residual_subtract_conv(d, ts, kernel, basis)
        return dflat, loop, conv.reshape(-1)[: x.shape[-1]]

    dflat, loop, conv = map(np.asarray, step(jnp.asarray(x)))
    # f32 FFT leakage scatters ~eps × the subtraction peak over the
    # trace (a few 1e-5 relative at this size)
    tol = 6e-5 * np.max(np.abs(loop - dflat))
    assert np.max(np.abs(conv - loop)) < tol
    # both paths kill the injected peaks
    i0 = l // 2
    assert abs(conv[i0]) < 0.02 * dflat[i0]


def test_autocuts_while_loop_on_device():
    from detprocess_jax.ops import autocuts

    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, 512)).astype(np.float32)
    x[5] *= 30.0
    mask = np.asarray(jax.jit(autocuts.autocuts_noise)(jnp.asarray(x)))
    assert not mask[5]
    assert mask.sum() > 200


def test_of1x2_joint_on_device(bank_and_template):
    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank, of1x1

    template, bank, dev = bank_and_template
    t2 = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=50e-6,
                             tau_f1=800e-6)
    psd = np.full(N, 1e-16)
    psd[0] = np.inf
    b2 = filterbank.make_of1x1_bank(t2, psd, FS, PRETRIG)
    dev2 = jax.tree.map(jnp.asarray, b2.to_device(np.float32))
    sep = 200
    tr = (np.random.default_rng(5).standard_normal((4, N)) * 1e-8
          + 5e-6 * template + 3e-6 * np.roll(t2, sep)).astype(np.float32)

    @jax.jit
    def step(tr, d1, d2):
        bk1 = filterbank.device_bank_1x1(d1)
        bk2 = filterbank.device_bank_1x1(d2)
        v = of1x1.signal_fft(tr[:, None, :])
        return of1x1.of1x2(v, bk1.phi, bk1.norm, bk1.s_fft,
                           bk2.phi, bk2.norm, bk2.s_fft, bk1.denom_inv,
                           PRETRIG, FS, delta_window=np.arange(0, 256))

    r = step(jnp.asarray(tr), dev, dev2)
    np.testing.assert_allclose(np.asarray(r.amp1)[:, 0], 5e-6, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(r.amp2)[:, 0], 3e-6, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(r.time_diff)[:, 0] * FS, sep,
                               atol=1.5)


def test_windowed_direct_equals_masked_on_device(bank_and_template):
    """The direct windowed DFT-matmul constrained OF (dispatched for
    windows <= DIRECT_WINDOW_MAX) matches the masked irfft scan on the
    card."""
    from detprocess_jax.ops import filterbank, of1x1

    template, bank, dev = bank_and_template

    wmask = np.zeros(N, bool)
    wmask[PRETRIG - 50:PRETRIG + 51] = True
    binw_host = filterbank.half_bin_weights(N)
    eidx, valid, cmat, smat = of1x1.prepare_delay_window(
        wmask, PRETRIG, N, binw_host)

    rng = np.random.default_rng(7)
    traces = (rng.standard_normal((8, N)) * 1e-8
              + 3e-6 * np.roll(template, 21)[None, :]).astype(np.float32)
    wmask_dev = jnp.asarray(wmask)

    @jax.jit
    def both(tr, dev, cm, sm):
        bh = filterbank.device_bank_1x1_half(dev)
        vr = of1x1.signal_rfft(tr[:, None, :])
        direct = of1x1.of1x1_windowed_direct_half(
            vr, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w,
            PRETRIG, FS, eidx, valid, cm, sm, n=N)
        masked = of1x1.of1x1_withdelay_half(
            vr, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w,
            PRETRIG, FS, window_mask=wmask_dev)
        return direct.amp, direct.t0, masked.amp, masked.t0

    da, dt0, ma, mt0 = map(np.asarray, both(
        jnp.asarray(traces), dev, jnp.asarray(cmat),
        jnp.asarray(smat)))
    np.testing.assert_allclose(da, ma, rtol=2e-4)
    np.testing.assert_allclose(dt0, mt0, atol=1e-9)
    np.testing.assert_allclose(da[:, 0], 3e-6, rtol=1e-3)
    assert np.all(np.abs(dt0 - 21 / FS) < 1.5 / FS)


def test_dynamic_batched_on_device():
    """The batch-shared early-exit dynamic-window walk
    (find_triggers_dynamic_batched) matches vmap of the single-trace
    kernel field-for-field on the card, with a constant window
    reproducing the static tiled merge's trigger indices."""
    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank, trigger as trig

    nt, pre = 4096, 1024
    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(nt, 4e-18)
    bank = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS, pre)
    kernel = trig.make_trigger_kernel(bank)
    thr = trig.chi2_threshold(6.0, 1)
    iw = jnp.asarray(kernel.iw_matrix)

    rng = np.random.default_rng(11)
    e, l = 3, 2**18
    x = (rng.standard_normal((e, 1, l)) * np.sqrt(psd[0] * FS)).astype(
        np.float32)
    inj = list(range(30_000, l - 30_000, 41_113))
    for ev in range(e):
        for t0 in inj:
            x[ev, 0, t0 - pre: t0 - pre + nt] += 3e-6 * tmpl

    def window_fn(m):
        return 125.0 + 0.0 * m          # constant == static merge

    def pre_stage(t):
        qb, _ = trig.of_fir_blocks(t, kernel)
        d = trig.delta_chi2_from_q(qb, iw).reshape(-1)[:l]
        q = qb.reshape(qb.shape[0], -1)[:, :l]
        return d, q

    @jax.jit
    def batched(x):
        d, q = jax.vmap(pre_stage)(x[:, 0:1])
        return trig.find_triggers_dynamic_batched(
            d, q, thr, window_fn, 64, candidate_capacity=1024,
            amps_transform=iw)

    @jax.jit
    def vmapped(x):
        d, q = jax.vmap(pre_stage)(x[:, 0:1])
        return jax.vmap(lambda dd, qq: trig.find_triggers_dynamic_kernel(
            dd, qq, thr, window_fn, 64, candidate_capacity=1024,
            amps_transform=iw))(d, q)

    @jax.jit
    def static(x):
        def one(t):
            qb, _ = trig.of_fir_blocks(t, kernel)
            d = trig.delta_chi2_from_q(qb, iw)
            return trig.find_triggers_tiled(d, qb, thr, 125, 64,
                                            amps_transform=iw)
        return jax.vmap(one)(x[:, 0:1])

    ts_b = batched(jnp.asarray(x))
    ts_v = vmapped(jnp.asarray(x))
    ts_s = static(jnp.asarray(x))
    for name in trig.TriggerSet._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ts_b, name)),
            np.asarray(getattr(ts_v, name)), err_msg=name)
    cnt_b = np.asarray(ts_b.count)
    cnt_s = np.asarray(ts_s.count)
    np.testing.assert_array_equal(cnt_b, cnt_s)
    for ev in range(e):
        np.testing.assert_array_equal(
            np.sort(np.asarray(ts_b.indices)[ev, :cnt_b[ev]]),
            np.sort(np.asarray(ts_s.indices)[ev, :cnt_s[ev]]))
        # every injection present (argmax of the noisy unconstrained
        # delta-chi2 lands within ~1 rise time of the injection point)
        idx = np.asarray(ts_b.indices)[ev, :cnt_b[ev]]
        for t0 in inj:
            assert np.any(np.abs(idx - t0) <= 30), (ev, t0)


def test_int16_convert_and_inject_on_device():
    """Staging path on the card: int16 codes upload as
    stored, ADC->amps conversion and salt injection run on device
    (ops.saltinject) — must match the host float math."""
    from detprocess_jax.ops import saltinject

    rng = np.random.default_rng(9)
    e, c, l, nt = 4, 2, 65536, 4096
    codes = np.rint(rng.standard_normal((e, c, l)) * 500).astype(np.int16)
    conv = np.array([2.0 ** -22, 2.0 ** -23], np.float32)
    convs = np.tile(conv, (e, 1))

    amps = np.asarray(saltinject.adc_convert(jnp.asarray(codes),
                                             jnp.asarray(convs)))
    np.testing.assert_array_equal(
        amps, codes.astype(np.float32) * conv[None, :, None])

    tmpl = np.zeros((1, nt), np.float32)
    tmpl[0, 100:1100] = 1.0
    idx = np.array([[100], [-500], [l - 600], [0]], np.int32)
    chan = np.array([[0], [1], [0], [1]], np.int32)
    tid = np.zeros((e, 1), np.int32)
    amp = np.array([[1e-5], [2e-5], [3e-5], [0.0]], np.float32)
    out = np.asarray(saltinject.inject_salts(
        jnp.asarray(amps), jnp.asarray(idx), jnp.asarray(chan),
        jnp.asarray(tid), jnp.asarray(amp), jnp.asarray(tmpl)))
    diff = out - amps
    # full add inside
    np.testing.assert_allclose(diff[0, 0, 200:1200], 1e-5, rtol=1e-4)
    # clipped head: template samples 500.. land at trace 0..
    np.testing.assert_allclose(diff[1, 1, 0:600], 2e-5, rtol=1e-4)
    assert np.all(diff[1, 0] == 0)
    # clipped tail
    np.testing.assert_allclose(diff[2, 0, l - 500:], 3e-5, rtol=1e-4)
    # amp=0 slot is a no-op
    assert np.all(diff[3] == 0)
