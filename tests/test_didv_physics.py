"""Tests for the TES physics layer: LM fits, dIdV models, lock-in
processing, IBIS, noise budget, dPdI, energy resolution."""

import numpy as np
import jax.numpy as jnp
import pytest

from detprocess_jax.ops import lm, lockin, of1x1, filterbank
from detprocess_jax.models import didv, ivbias, tesnoise, pulse


class TestLM:
    def test_exponential_fit(self):
        rng = np.random.default_rng(0)
        t = np.linspace(0, 10, 200)
        true = np.array([2.5, 1.7])

        def residual(p, t, y):
            return p[0] * jnp.exp(-t / p[1]) - y

        y = true[0] * np.exp(-t / true[1]) + rng.standard_normal(200) * 1e-3
        res = lm.levenberg_marquardt(residual, jnp.asarray([1.0, 1.0]),
                                     args=(jnp.asarray(t), jnp.asarray(y)))
        np.testing.assert_allclose(np.asarray(res.params), true, rtol=1e-2)
        # covariance: errors should be small and finite
        errs = np.sqrt(np.diag(np.asarray(res.cov)))
        assert np.all(np.isfinite(errs)) and np.all(errs < 0.1)

    def test_batched_fits(self):
        rng = np.random.default_rng(1)
        t = jnp.linspace(0, 10, 100)
        amps = np.array([1.0, 2.0, 3.0])
        taus = np.array([0.5, 1.0, 2.0])

        def residual(p, y):
            return p[0] * jnp.exp(-t / p[1]) - y

        ys = jnp.asarray(amps[:, None]
                         * np.exp(-np.asarray(t)[None, :] / taus[:, None]))
        x0 = jnp.ones((3, 2))
        res = lm.batched_lm(residual, x0, (ys,))
        np.testing.assert_allclose(np.asarray(res.params)[:, 0], amps,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(res.params)[:, 1], taus,
                                   rtol=1e-6)


# physical parameters of a plausible TES working point
R0, RL, BETA, LOOP, IND, TAU0 = 0.15, 0.02, 2.0, 10.0, 4e-7, 1e-3
A_TRUE = RL + R0 * (1 + BETA)
B_TRUE = R0 * LOOP * (2 + BETA) / (1 - LOOP)   # negative for l > 1
TAU1_TRUE = TAU0 / (1 - LOOP)
TAU2_TRUE = IND / A_TRUE
PARAMS2 = np.array([A_TRUE, B_TRUE, TAU1_TRUE, TAU2_TRUE])


class TestDIDVModels:
    def test_smallsignal_roundtrip(self):
        ssp = didv.smallsignal_from_fit(jnp.asarray(PARAMS2), R0, RL, 2)
        np.testing.assert_allclose(float(ssp["beta"]), BETA, rtol=1e-10)
        np.testing.assert_allclose(float(ssp["l"]), LOOP, rtol=1e-10)
        np.testing.assert_allclose(float(ssp["L"]), IND, rtol=1e-10)
        np.testing.assert_allclose(float(ssp["tau0"]), TAU0, rtol=1e-10)

    def test_dvdi_matches_irwin_hilton_matrix(self):
        """The 2-pole fit model must equal 1/dIdV from the electro-thermal
        matrix with the same physical parameters."""
        freqs = np.geomspace(1, 5e4, 40)
        p = tesnoise.TESParams(r0=R0, rl=RL, beta=BETA, l=LOOP, L=IND,
                               tau0=TAU0, G=1e-10, tc=0.04, tload=0.03,
                               tb=0.02, i0=1e-6)
        dvdi_matrix = 1.0 / tesnoise.didv(p, freqs)
        dvdi_model = np.asarray(didv.dvdi_2pole(jnp.asarray(PARAMS2),
                                                jnp.asarray(freqs)))
        np.testing.assert_allclose(dvdi_model, dvdi_matrix, rtol=1e-8)

    def test_fit_recovers_params(self):
        rng = np.random.default_rng(2)
        freqs = np.fft.fftfreq(2500, d=1 / 125000)[1:]  # skip DC
        data = np.asarray(didv.didv_model(jnp.asarray(PARAMS2),
                                          jnp.asarray(freqs), 2))
        noise = (rng.standard_normal(len(freqs))
                 + 1j * rng.standard_normal(len(freqs))) * 0.02 * np.abs(data)
        fit = didv.fit_didv(freqs, data + noise, poles=2)
        np.testing.assert_allclose(fit.params, PARAMS2, rtol=0.05)

    def test_smallsignal_errors_finite(self):
        freqs = np.geomspace(1, 5e4, 200)
        data = np.asarray(didv.didv_model(jnp.asarray(PARAMS2),
                                          jnp.asarray(freqs), 2))
        rng = np.random.default_rng(3)
        noise = (rng.standard_normal(200) + 1j * rng.standard_normal(200))
        fit = didv.fit_didv(freqs, data * (1 + 0.01 * noise), poles=2)
        ssp = didv.smallsignal_with_errors(fit, R0, RL)
        assert abs(ssp["beta"] - BETA) < 5 * max(ssp["beta_err"], 0.05)
        assert ssp["l_err"] > 0 and np.isfinite(ssp["l_err"])

    def test_biasparams_ilg(self):
        # dVdI(0) = A + B; r0_ilg = rl − dVdI(0) → consistency check
        out = didv.biasparams_ilg(PARAMS2, RL, rsh=5e-3, ibias=1e-4, poles=2)
        expected_r0 = RL - (A_TRUE + B_TRUE)
        np.testing.assert_allclose(out["r0"], expected_r0, rtol=1e-12)
        # finite-loop-gain deviation from R0 is exactly R0(2+β)/(l−1)
        expected_dev = R0 * (2 + BETA) / (LOOP - 1)
        np.testing.assert_allclose(abs(out["r0"] - R0), expected_dev,
                                   rtol=1e-10)

    def test_dpdi_consistent_with_matrix(self):
        """dPdI from fit params must equal 1/dIdP from the matrix."""
        freqs = np.geomspace(1, 5e4, 30)
        i0 = 2e-6
        g = R0 * i0**2 * LOOP and 1e-10  # G value consistent w/ tau0 choice
        p = tesnoise.TESParams(r0=R0, rl=RL, beta=BETA, l=LOOP, L=IND,
                               tau0=TAU0, G=1e-10, tc=0.04, tload=0.03,
                               tb=0.02, i0=i0)
        dpdi_matrix = 1.0 / tesnoise.didp(p, freqs)
        dpdi_fit = np.asarray(didv.dpdi_from_fit(
            jnp.asarray(PARAMS2), jnp.asarray(freqs), i0, R0, RL, 2))
        np.testing.assert_allclose(dpdi_fit, dpdi_matrix, rtol=1e-8)


class TestLockin:
    def test_didv_measurement_roundtrip(self):
        """Simulated square-wave response → measured dIdV matches truth."""
        rng = np.random.default_rng(4)
        fs, sgfreq = 1.25e6, 100.0
        sgamp, rsh = 1e-7, 5e-3
        nper = 20
        n = int(fs / sgfreq) * nper
        t = np.arange(n)
        period = int(fs / sgfreq)
        square_v = np.where((t % period) < period // 2, 0.5, -0.5) * (
            sgamp * rsh)
        sq_fft = np.fft.fft(square_v)
        freqs_full = np.fft.fftfreq(n, 1 / fs)
        didv_true_f = np.asarray(didv.didv_model(
            jnp.asarray(PARAMS2), jnp.asarray(freqs_full), 2))
        response = np.real(np.fft.ifft(didv_true_f * sq_fft))
        traces = (response[None, :]
                  + rng.standard_normal((24, n)) * 1e-9 + 3e-6)

        data = lockin.process_didv_traces(traces, fs, sgfreq, sgamp, rsh)
        np.testing.assert_allclose(data.offset, 3e-6, atol=1e-8)
        # compare measured dIdV with truth: tight at the first harmonics,
        # then within 6× the estimated per-harmonic uncertainty
        truth = np.asarray(didv.didv_model(jnp.asarray(PARAMS2),
                                           jnp.asarray(data.freqs), 2))
        np.testing.assert_allclose(data.didv[:8], truth[:8], rtol=0.02)
        resid = np.abs(data.didv[:100] - truth[:100])
        sigma = 1.0 / data.weights[:100]
        assert np.all(resid < np.maximum(6 * sigma, 0.02 * np.abs(truth[:100])))

        # and the full chain: fit the measured dIdV. τ₂ ≈ 1 sample here, so
        # its lever arm at ≤20 kHz harmonics is small — 15% is realistic.
        fit = didv.fit_didv(data.freqs[:200], data.didv[:200], poles=2,
                            guess=PARAMS2 * 1.3)
        np.testing.assert_allclose(fit.params[:3], PARAMS2[:3], rtol=0.05)
        np.testing.assert_allclose(fit.params[3], PARAMS2[3], rtol=0.15)


class TestIBIS:
    def test_sweep_recovery(self):
        rng = np.random.default_rng(5)
        rsh, rp, rn = 5e-3, 3e-3, 0.3
        ioffset = -2.1e-6
        # bias points: normal → transition → SC
        ibias = np.concatenate([
            np.linspace(300e-6, 200e-6, 4),       # normal
            np.linspace(150e-6, 50e-6, 5),        # transition
            np.linspace(5e-6, 1e-6, 3)])          # SC
        r0_true = np.concatenate([
            np.full(4, rn),
            np.linspace(0.2, 0.05, 5),
            np.zeros(3)])
        i0_true = ibias * rsh / (r0_true + rsh + rp)
        imeas = i0_true + ioffset + rng.standard_normal(12) * 1e-10

        res = ivbias.analyze_ibis(ibias, imeas, rsh, nnorm=4, nsc=3)
        np.testing.assert_allclose(res.rp, rp, rtol=0.01)
        np.testing.assert_allclose(res.rn, rn, rtol=0.01)
        np.testing.assert_allclose(res.ioffset, ioffset, atol=1e-9)
        np.testing.assert_allclose(res.r0[4:9], r0_true[4:9], rtol=0.01)
        np.testing.assert_allclose(res.i0, i0_true, rtol=0.01)
        p0_expected = i0_true**2 * r0_true
        np.testing.assert_allclose(res.p0[:9], p0_expected[:9], rtol=0.02)


class TestTESNoise:
    P = tesnoise.TESParams(r0=R0, rl=RL, beta=BETA, l=LOOP, L=IND,
                           tau0=TAU0, G=1e-10, tc=0.04, tload=0.03,
                           tb=0.02, i0=2e-6, squiddc=1e-12)

    def test_positive_components(self):
        freqs = np.geomspace(1, 1e5, 50)
        for fn in (tesnoise.s_ites, tesnoise.s_iload, tesnoise.s_itfn,
                   tesnoise.s_isquid):
            s = fn(self.P, freqs)
            assert np.all(s >= 0) and np.all(np.isfinite(s))

    def test_total_is_sum(self):
        freqs = np.geomspace(1, 1e5, 20)
        total = tesnoise.s_itot(self.P, freqs)
        parts = (tesnoise.s_ites(self.P, freqs)
                 + tesnoise.s_iload(self.P, freqs)
                 + tesnoise.s_itfn(self.P, freqs)
                 + tesnoise.s_isquid(self.P, freqs))
        np.testing.assert_allclose(total, parts, rtol=1e-12)

    def test_normal_state_limit(self):
        """With l=0, β=0, i0=0 the budget reduces to passive Johnson."""
        freqs = np.geomspace(1, 1e5, 30)
        p = self.P._replace(l=0.0, beta=0.0, i0=1e-30, squiddc=0.0)
        johnson = (tesnoise.s_ites(p, freqs) + tesnoise.s_iload(p, freqs))
        expected = tesnoise.s_i_normal(p.r0, p.rl, p.L, p.tc, p.tload, 0.0,
                                       freqs)
        np.testing.assert_allclose(johnson, expected, rtol=1e-9)

    def test_squid_extraction(self):
        freqs = np.geomspace(10, 1e5, 64)
        squid_true = 4e-12
        psd_n = tesnoise.s_i_normal(0.3, RL, IND, 0.04, 0.03, squid_true,
                                    freqs)
        squid = tesnoise.squid_noise_from_normal(psd_n, 0.3, RL, IND, 0.04,
                                                 0.03, freqs)
        np.testing.assert_allclose(squid, squid_true, rtol=1e-10)


class TestEnergyResolution:
    def test_flat_dpdi_reduces_to_current_of(self):
        """With constant dPdI = D, σ_E must equal σ_A·|D·∫s dt|."""
        fs, n, pretrig = 1.25e6, 4096, 1024
        tmpl = pulse.make_template(fs, n, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        psd = np.full(n, 1e-20)
        d_const = 7.3e-7
        dpdi = np.full(n, d_const, dtype=complex)

        sigma_e = didv.energy_resolution(tmpl, psd, dpdi, fs)
        bank = filterbank.make_of1x1_bank(tmpl, psd, fs, pretrig)
        sigma_a = 1.0 / np.sqrt(bank.norm[0])
        e0 = d_const * np.trapezoid(tmpl, dx=1 / fs)
        np.testing.assert_allclose(sigma_e, sigma_a * abs(e0), rtol=1e-6)

    def test_energy_normalization(self):
        fs, n = 1.25e6, 4096
        tmpl = pulse.make_template(fs, n, 1024, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        d_const = 2.0
        dpdi = np.full(n, d_const, dtype=complex)
        e0 = didv.energy_normalization(tmpl, dpdi, fs)
        np.testing.assert_allclose(e0, 2.0 * np.trapezoid(tmpl, dx=1 / fs),
                                   rtol=1e-10)
