"""Independent analytic goldens for the fit stack (dIdV / IBIS / noise
model) — VERDICT round-2 weak #3.

Every expected number here is computed IN THIS FILE from published
closed forms (Irwin & Hilton, "Transition-Edge Sensors", in *Cryogenic
Particle Detection*, Topics Appl. Phys. 99 (2005), §2: small-signal
theory eqs. 2.25-2.44, noise eqs. 2.57-2.66) or from exact elementary
algebra — never by calling the project's model code to produce the
expectation. A shared convention slip between ``models/didv.py`` /
``models/tesnoise.py`` and their tests cannot pass here.

Hand-derived quantities used below (one-block Irwin–Hilton model, loop
gain l ≡ ℒ_I, current sensitivity β, bias resistance R0, load Rl,
inductance L, thermal time τ0 = C/G):

- complex impedance seen by the bias loop (IH eq. 2.33/2.34):
      Z_TES(ω) = R0(1+β) + R0·l·(2+β) / ((1−l)(1+iωτ_I)),
      τ_I = τ0/(1−l)
      Z_circ(ω) = Rl + iωL + Z_TES(ω);    dIdV(ω) = 1/Z_circ(ω)
- electrical/thermal pole time constants (IH eq. 2.42-2.44):
      τ_el = L/(Rl + R0(1+β)),
      1/τ± = (1/τ_el + 1/τ_I)/2 ∓ ½√[(1/τ_el − 1/τ_I)² − 4R0·l(2+β)/(Lτ0)]
- DC transfer denominators (eliminating δT from the two coupled IH
  small-signal equations at ω=0 by hand):
      D ≡ Rl(1−l) + R0(1+β+l)
      dIdV(0) = (1−l)/D,   dIdP(0) = −l/(I0·D),   dPdI(0) = −I0·D/l
- DC noise densities (one-sided, 4kTR convention):
      S_I,tes(0)  = 4k_B·Tc·R0(1+2β) · (1/D)²      [TES Johnson: the
          voltage source drives the loop AND heats the TES; the two
          DC paths combine to exactly −1/D]
      S_I,load(0) = 4k_B·Tload·Rl · ((1−l)/D)²
      S_I,tfn(0)  = 4k_B·Tc²·G·F · (l/(I0·D))²
  and the power-referred TFN is white: S_P,tfn = 4k_B·Tc²·G·F at all ω.
"""

import numpy as np

from detprocess_jax.models import didv as didv_models
from detprocess_jax.models import ivbias, tesnoise

KB = 1.380649e-23

# hand-picked working point (exact binary fractions where convenient)
R0 = 0.125
RL = 0.03125
BETA = 2.0
LOOP = 10.0
IND = 2.5e-7
TAU0 = 1e-3
G = 1e-10
TC = 0.040
TLOAD = 0.030
TB = 0.020
I0 = 2e-6
N_EXP = 5.0

FREQS = np.array([1.0, 8.0, 64.0, 512.0, 4096.0, 32768.0])


def _ih_impedance(freqs):
    """Z_circ(ω) transcribed from IH eq. 2.33-2.34 — the golden."""
    w = 2j * np.pi * np.asarray(freqs)
    tau_i = TAU0 / (1.0 - LOOP)
    z_tes = (R0 * (1.0 + BETA)
             + R0 * LOOP * (2.0 + BETA) / ((1.0 - LOOP) * (1.0 + w * tau_i)))
    return RL + w * IND + z_tes


def _params():
    return tesnoise.TESParams(
        r0=R0, rl=RL, beta=BETA, l=LOOP, L=IND, tau0=TAU0, G=G, tc=TC,
        tload=TLOAD, tb=TB, i0=I0, squiddc=0.0, n=N_EXP)


# ---------------------------------------------------------------------------
# admittance: three independent formulations must agree exactly
# ---------------------------------------------------------------------------

def test_didv_matrix_matches_ih_closed_form():
    """models/tesnoise.py's 2×2 electro-thermal matrix vs the published
    impedance closed form, bin by bin at machine precision."""
    golden = 1.0 / _ih_impedance(FREQS)
    got = tesnoise.didv(_params(), FREQS)
    np.testing.assert_allclose(got, golden, rtol=1e-12)


def test_dvdi_2pole_parameterization_matches_ih():
    """models/didv.py's fit model with the IH-identified parameters
    A = Rl+R0(1+β), B = R0·l(2+β)/(1−l), τ₁ = τ0/(1−l), τ₂ = L/A
    reproduces the published impedance exactly."""
    a = RL + R0 * (1.0 + BETA)
    b = R0 * LOOP * (2.0 + BETA) / (1.0 - LOOP)
    tau1 = TAU0 / (1.0 - LOOP)
    tau2 = IND / a
    got = np.asarray(didv_models.dvdi_2pole(
        np.array([a, b, tau1, tau2]), FREQS))
    np.testing.assert_allclose(got, _ih_impedance(FREQS), rtol=1e-12)


def test_fit_recovers_hand_picked_truth():
    """Fit exact IH data (generated by THIS file's closed form) and
    check the small-signal inversion lands on the hand-picked inputs."""
    freqs = np.linspace(10.0, 5e4, 200)
    data = 1.0 / _ih_impedance(freqs)
    fit = didv_models.fit_didv(freqs, data, poles=2)
    ssp = didv_models.smallsignal_from_fit(
        np.asarray(fit.params), R0, RL, poles=2)
    np.testing.assert_allclose(float(ssp["beta"]), BETA, rtol=1e-6)
    np.testing.assert_allclose(float(ssp["l"]), LOOP, rtol=1e-6)
    np.testing.assert_allclose(float(ssp["L"]), IND, rtol=1e-6)
    np.testing.assert_allclose(float(ssp["tau0"]), TAU0, rtol=1e-6)


def test_falltimes_match_ih_eq_243():
    """didv_falltimes vs the published pole formula (IH eq. 2.42-2.44),
    hand-written here."""
    tau_el = IND / (RL + R0 * (1.0 + BETA))
    tau_i = TAU0 / (1.0 - LOOP)
    mean = 0.5 * (1.0 / tau_el + 1.0 / tau_i)
    disc = np.sqrt((1.0 / tau_el - 1.0 / tau_i) ** 2
                   - 4.0 * R0 * LOOP * (2.0 + BETA) / (IND * TAU0))
    tau_plus = 1.0 / (mean + 0.5 * disc)
    tau_minus = 1.0 / (mean - 0.5 * disc)
    golden = np.sort(np.abs([tau_plus, tau_minus]))

    a = RL + R0 * (1.0 + BETA)
    b = R0 * LOOP * (2.0 + BETA) / (1.0 - LOOP)
    fit = didv_models.DIDVFit(
        params=np.array([a, b, tau_i, IND / a]),
        cov=np.eye(4), cost=0.0, poles=2)
    got = didv_models.didv_falltimes(fit)
    np.testing.assert_allclose(got[:2], golden, rtol=1e-12)
    assert np.isnan(got[2])


# ---------------------------------------------------------------------------
# DC transfer + noise sum rules
# ---------------------------------------------------------------------------

def _d_denom():
    return RL * (1.0 - LOOP) + R0 * (1.0 + BETA + LOOP)


def test_dc_responsivities():
    d = _d_denom()
    p = _params()
    np.testing.assert_allclose(
        tesnoise.didv(p, [0.0])[0], (1.0 - LOOP) / d, rtol=1e-12)
    np.testing.assert_allclose(
        tesnoise.didp(p, [0.0])[0], -LOOP / (I0 * d), rtol=1e-12)


def test_dpdi_from_fit_dc_limit():
    """models/didv.py dPdI at ω=0 equals −I0·D/l (hand-derived above)."""
    a = RL + R0 * (1.0 + BETA)
    b = R0 * LOOP * (2.0 + BETA) / (1.0 - LOOP)
    tau1 = TAU0 / (1.0 - LOOP)
    params = np.array([a, b, tau1, IND / a])
    got = np.asarray(didv_models.dpdi_from_fit(
        params, np.array([0.0]), I0, R0, RL, poles=2))[0]
    np.testing.assert_allclose(got, -I0 * _d_denom() / LOOP, rtol=1e-12)


def test_dc_noise_closed_forms():
    """TES-Johnson / load-Johnson / TFN current noise at DC against the
    hand-derived 1/D² closed forms."""
    d = _d_denom()
    p = _params()
    f0 = [0.0]
    s_tes_golden = 4.0 * KB * TC * R0 * (1.0 + 2.0 * BETA) / d**2
    np.testing.assert_allclose(tesnoise.s_ites(p, f0)[0], s_tes_golden,
                               rtol=1e-12)
    s_load_golden = (4.0 * KB * TLOAD * RL * (1.0 - LOOP) ** 2 / d**2)
    np.testing.assert_allclose(tesnoise.s_iload(p, f0)[0], s_load_golden,
                               rtol=1e-12)
    f_tfn = ((TB / TC) ** (N_EXP + 1.0) + 1.0) / 2.0
    s_tfn_golden = (4.0 * KB * TC**2 * G * f_tfn
                    * (LOOP / (I0 * d)) ** 2)
    np.testing.assert_allclose(tesnoise.s_itfn(p, f0)[0], s_tfn_golden,
                               rtol=1e-12)


def test_tfn_white_in_power():
    """Sum rule: power-referred TFN is flat = 4k_B·Tc²·G·F at every
    frequency (the responsivity must cancel exactly)."""
    p = _params()
    f_tfn = ((TB / TC) ** (N_EXP + 1.0) + 1.0) / 2.0
    golden = 4.0 * KB * TC**2 * G * f_tfn
    s_p = tesnoise.current_to_power(tesnoise.s_itfn(p, FREQS), p, FREQS)
    np.testing.assert_allclose(s_p, golden, rtol=1e-10)


def test_johnson_high_frequency_limit():
    """ω→∞: the inductor dominates, ETF decouples, and both Johnson
    densities approach 4k_B·T·R/(ωL)²."""
    f_hi = np.array([1e9])
    w = 2 * np.pi * f_hi
    p = _params()
    np.testing.assert_allclose(
        tesnoise.s_ites(p, f_hi)[0],
        4 * KB * TC * R0 * (1 + 2 * BETA) / (w[0] * IND) ** 2, rtol=1e-3)
    np.testing.assert_allclose(
        tesnoise.s_iload(p, f_hi)[0],
        4 * KB * TLOAD * RL / (w[0] * IND) ** 2, rtol=1e-3)


# ---------------------------------------------------------------------------
# exact small-N IBIS
# ---------------------------------------------------------------------------

def test_ibis_exact_small_case():
    """5-point sweep with exact linear branches: every output of
    analyze_ibis has a closed form computed here by elementary circuit
    algebra (current divider: i0 = ibias·Rsh/(R0+Rsh+Rp))."""
    rsh, rp, rn = 0.005, 0.004, 0.25
    ioffset = -2e-6
    # normal, normal, transition, sc, sc — ordered normal→SC
    biases = np.array([400e-6, 300e-6, 100e-6, 4e-6, 2e-6])
    r0s = np.array([rn, rn, 0.1, 0.0, 0.0])
    imeas = biases * rsh / (r0s + rsh + rp) + ioffset

    res = ivbias.analyze_ibis(biases, imeas, rsh=rsh, nnorm=2, nsc=2,
                              imeas_err=np.full(5, 1e-12))
    np.testing.assert_allclose(res.rn, rn, rtol=1e-9)
    np.testing.assert_allclose(res.rp, rp, rtol=1e-9)
    np.testing.assert_allclose(res.ioffset, ioffset, rtol=1e-9)

    # per-point closed forms
    i0_golden = biases * rsh / (r0s + rsh + rp)
    v0_golden = (biases - i0_golden) * rsh - i0_golden * rp
    np.testing.assert_allclose(res.i0, i0_golden, rtol=1e-9)
    # SC points have v0 = 0 exactly; allow float roundoff there
    np.testing.assert_allclose(res.v0, v0_golden, rtol=1e-9, atol=1e-18)
    np.testing.assert_allclose(res.r0, v0_golden / i0_golden, rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(res.p0, v0_golden * i0_golden, rtol=1e-9,
                               atol=1e-24)
    # and v0/i0 reproduces the seeded r0 values exactly
    np.testing.assert_allclose(res.r0, r0s, atol=1e-9)
