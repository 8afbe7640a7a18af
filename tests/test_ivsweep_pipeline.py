"""End-to-end IV/dIdV sweep test: synthetic raw sweep data generated from a
physical TES model → processing → IBIS analysis → dIdV fits → noise model.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import didv as didv_models
from detprocess_jax.models import tesnoise
from detprocess_jax.pipelines.ivsweep import IVSweepProcessing, IVSweepAnalysis
from detprocess_jax.pipelines.noisemodel import NoiseModel
from detprocess_jax.pipelines.didv import DIDVAnalysis
from detprocess_jax.ops import lockin

FS = 1.25e6
RSH = 5e-3
RP = 4e-3
RN = 0.30
TC, TBATH, TLOAD = 0.040, 0.020, 0.030
SGFREQ, SGAMP = 100.0, 2e-8


def _tes_point(ibias, r0, beta=2.0, loop=10.0, ind=4e-7, tau0=1e-3):
    """Physical working point at a given bias."""
    rl = RSH + RP
    i0 = ibias * RSH / (r0 + rl) if r0 + rl > 0 else 0.0
    return tesnoise.TESParams(
        r0=r0, rl=rl, beta=beta, l=loop, L=ind, tau0=tau0,
        G=1e-10, tc=TC, tload=TLOAD, tb=TBATH, i0=i0, squiddc=1e-11)


def _noise_traces(params, n, nev, rng, ioffset):
    freqs = np.fft.fftfreq(n, 1 / FS)
    # s_itot is ONE-sided; the synthesized two-sided density is half
    psd = tesnoise.s_itot(params, np.where(freqs == 0, freqs[1], freqs))
    scale = np.sqrt(psd / 2.0 * FS * n)
    white = np.fft.fft(rng.standard_normal((nev, n)), axis=-1) / np.sqrt(n)
    return np.real(np.fft.ifft(white * scale, axis=-1)) + params.i0 + ioffset


def _didv_traces(params, nper, nev, rng, ioffset):
    period = int(FS / SGFREQ)
    n = period * nper
    t = np.arange(n)
    square_v = np.where((t % period) < period // 2, 0.5, -0.5) * (SGAMP * RSH)
    freqs = np.fft.fftfreq(n, 1 / FS)
    resp = tesnoise.didv(params, np.where(freqs == 0, freqs[1], freqs))
    resp_t = np.real(np.fft.ifft(resp * np.fft.fft(square_v)))
    noise = rng.standard_normal((nev, n)) * 2e-10
    return resp_t[None, :] + noise + params.i0 + ioffset


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    rng = np.random.default_rng(12)
    ioffset = -1.3e-6

    # bias points, normal → transition → SC
    biases = [400e-6, 350e-6, 300e-6,            # normal
              120e-6, 100e-6, 80e-6, 60e-6,     # transition
              4e-6, 2e-6, 1e-6]                 # SC
    r0s = [RN, RN, RN, 0.20, 0.15, 0.10, 0.06, 0.0, 0.0, 0.0]
    states = ["normal"] * 3 + ["transition"] * 4 + ["sc"] * 3

    bias_points = []
    n_noise = 8192
    for k, (ib, r0, st) in enumerate(zip(biases, r0s, states)):
        if st == "normal":
            p = _tes_point(ib, r0, beta=0.0, loop=0.0, tau0=1e-6)
        elif st == "sc":
            p = _tes_point(ib, r0, beta=0.0, loop=0.0, tau0=1e-6)
        else:
            p = _tes_point(ib, r0)
        ndir = root / f"noise_{k}"
        w = RawWriter(str(ndir), f"I1_D20260816_T17{k:02d}00", FS, ["chan1"],
                      prefix="iv", data_type="noise")
        w.write_dump(_noise_traces(p, n_noise, 20, rng, ioffset)[:, None, :],
                     dump_num=1)
        ddir = root / f"didv_{k}"
        w2 = RawWriter(str(ddir), f"I1_D20260816_T18{k:02d}00", FS,
                       ["chan1"], prefix="didv", data_type="didv")
        w2.write_dump(_didv_traces(p, 4, 8, rng, ioffset)[:, None, :],
                      dump_num=1)
        bias_points.append({
            "tes_bias": ib,
            "noise_files": sorted(str(f) for f in ndir.glob("*.hdf5")),
            "didv_files": sorted(str(f) for f in ddir.glob("*.hdf5")),
            "true_state": st, "true_r0": r0, "params": p,
        })
    return dict(root=root, bias_points=bias_points, ioffset=ioffset,
                r0s=r0s, states=states, biases=biases)


@pytest.fixture(scope="module")
def processed(sweep):
    proc = IVSweepProcessing(verbose=False)
    df = proc.process("chan1", sweep["bias_points"], sgfreq=SGFREQ,
                      sgamp=SGAMP, rsh=RSH)
    return proc, df


def test_processing_output(processed, sweep):
    _, df = processed
    assert len(df) == 10
    assert "psd" in df.columns and "didv" in df.columns
    # DC offsets recovered: imeas = i0 + ioffset
    for k, bp in enumerate(sweep["bias_points"]):
        expected = bp["params"].i0 + sweep["ioffset"]
        np.testing.assert_allclose(df["offset_noise"].iloc[k], expected,
                                   atol=5e-8)


def test_ibis_analysis(processed, sweep):
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    out = ana.analyze_sweep("chan1")
    ibis = ana.get_ibis("chan1")
    np.testing.assert_allclose(ibis.rp, RP, rtol=0.05)
    np.testing.assert_allclose(ibis.rn, RN, rtol=0.05)
    np.testing.assert_allclose(ibis.ioffset, sweep["ioffset"], atol=2e-8)
    # transition r0 recovered (sorted by |bias| desc → rows 3..6)
    got_r0 = out["r0"].to_numpy()[3:7]
    np.testing.assert_allclose(got_r0, [0.20, 0.15, 0.10, 0.06], rtol=0.05)


def test_didv_fits_across_sweep(processed, sweep):
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    ana.analyze_sweep("chan1")
    out = ana.analyze_didv("chan1", poles=2)
    # transition points carry small-signal params close to truth
    n_checked = 0
    for _, row in out.iterrows():
        if row["state"] != "transition" or not isinstance(
                row.get("didv_fits"), dict):
            continue
        ssp = row["didv_fits"].get("ssp_2poles")
        if ssp is None:
            continue
        n_checked += 1
        assert abs(ssp["beta"] - 2.0) < 0.5
        assert abs(ssp["l"] - 10.0) / 10.0 < 0.3
    assert n_checked >= 3


def test_state_aware_didv_fits(processed, sweep, capsys):
    """Reference parity (ivsweep.py:762-826, :1600-2046): SC and normal
    points get 1-pole fits whose Rp/Rn recover truth and cross-check
    against the IBIS sweep values; transition points carry flattened
    didv_{p}poles_* columns and infinite-loop-gain bias params."""
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    ana.analyze_sweep("chan1")
    out = ana.analyze_didv("chan1", poles=(2, 3))

    res = ana.get_ivsweep_results("chan1", "didv")
    # dIdV-derived Rp (SC 1-pole) and Rn (normal 1-pole) recover truth
    np.testing.assert_allclose(res["sc_didv_fit_rp"], RP, rtol=0.05)
    np.testing.assert_allclose(res["normal_didv_fit_rn"], RN, rtol=0.05)
    assert res["sc_didv_fit_rp_err"] >= 0
    assert res["normal_didv_fit_rn_err"] >= 0
    # the recovered inductance is physical
    assert 1e-8 < res["sc_didv_fit_L"] < 1e-5
    # 1-pole fits landed on SC/normal rows only
    for _, row in out.iterrows():
        fits = row["didv_fits"]
        if row["state"] in ("sc", "normal") and fits:
            assert "fit_1poles" in fits
            assert fits["fit_1poles"].poles == 1
        if row["state"] == "transition" and fits:
            assert "fit_1poles" not in fits
            assert "fit_2poles" in fits and "fit_3poles" in fits
    # flattened transition columns + ILG bias params
    trans = out[out["state"] == "transition"]
    assert np.isfinite(trans["didv_2poles_l"]).sum() >= 3
    assert np.isfinite(trans["didv_2poles_beta"]).sum() >= 3
    assert np.isfinite(trans["didv_2poles_r0_infinite_lgain"]).sum() >= 3
    # ILG r0 at finite loop gain: r0_ilg = Rl − dVdI(0) with
    # dVdI(0) = Rl + R0(1+β) + R0·l(2+β)/(1−l), so analytically
    # r0_ilg/r0 = l(2+β)/(l−1) − (1+β); for l=10, β=2 → 40/9 − 3 ≈ 1.444
    sel = np.isfinite(trans["didv_2poles_r0_infinite_lgain"])
    expected_ratio = 10.0 * 4.0 / 9.0 - 3.0
    np.testing.assert_allclose(
        trans.loc[sel, "didv_2poles_r0_infinite_lgain"]
        / trans.loc[sel, "r0"],
        expected_ratio, rtol=0.1)
    # no disagreement warning on a consistent sweep
    assert "WARNING" not in capsys.readouterr().out


def test_didv_ibis_disagreement_warns(processed, capsys):
    """Seed an inconsistent IBIS Rp and check the cross-check fires."""
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    ana.analyze_sweep("chan1")
    ibis = ana.get_ibis("chan1")
    ana._ibis["chan1"] = ibis._replace(rp=3 * RP, rp_err=1e-6)
    ana.analyze_didv("chan1", poles=2, enable_normal=False,
                     enable_transition=False)
    out = capsys.readouterr().out
    assert "WARNING" in out and "disagrees with IV sweep" in out


def test_energy_resolution_curve(processed, sweep):
    from detprocess_jax.models import pulse
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    ana.analyze_sweep("chan1")
    ana.analyze_didv("chan1", poles=2)
    tmpl = pulse.make_template(FS, 8192, 4096, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    out = ana.calc_energy_resolution("chan1", tmpl, FS, poles=2)
    sig = out["energy_resolution"].to_numpy()
    trans = out["state"] == "transition"
    assert np.isfinite(sig[trans.to_numpy()]).all()
    assert (sig[trans.to_numpy()] > 0).all()


def test_sweep_analyze_noise(processed, sweep):
    """Sweep-wide noise analysis (ivsweep.py:1231): Tload from SC points,
    SQUID from normal points, transition budgets match measured PSDs."""
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    ana.analyze_sweep("chan1")
    ana.analyze_didv("chan1", poles=2)
    out = ana.analyze_noise("chan1", tc=TC, tbath=TBATH,
                            tload_guess=TLOAD, poles=2)
    np.testing.assert_allclose(out["tload"], TLOAD, rtol=0.3)
    assert out["squid_noise"] is not None
    assert len(out["budgets"]) >= 3
    # each transition budget reproduces that point's measured PSD
    for bias, budget in out["budgets"].items():
        ratio = np.median(budget["s_itot"] / budget["s_imeas"])
        assert 0.6 < ratio < 1.6, (bias, ratio)
    sweep_df = ana._sweep_df["chan1"]
    assert "noise_budget" in sweep_df.columns


def test_noise_model_chain(processed, sweep):
    """SQUID extraction from normal PSD, Tload from SC PSD, then the
    transition budget approximately reproduces the measured PSD."""
    proc, df = processed
    nm = NoiseModel(verbose=False)
    n = 8192
    freqs = np.fft.fftfreq(n, 1 / FS)

    rl = RSH + RP
    psd_normal = df["psd"].iloc[0]
    squid = nm.calc_squid_noise("chan1", psd_normal, freqs, RN, rl, 4e-7,
                                TC, tload_guess=TLOAD)
    sq_level = np.median(squid[np.abs(freqs) > 1e3])
    np.testing.assert_allclose(sq_level, 1e-11, rtol=0.5)

    psd_sc = df["psd"].iloc[-1]
    tload = nm.fit_sc_noise("chan1", psd_sc, freqs, rl, 4e-7,
                            squiddc=float(sq_level))
    np.testing.assert_allclose(tload, TLOAD, rtol=0.2)

    # transition point budget vs measured PSD
    k = 4  # 100 uA point
    p_true = sweep["bias_points"][k]["params"]
    ssp = {"beta": p_true.beta, "l": p_true.l, "L": p_true.L,
           "tau0": p_true.tau0}
    bias = {"r0": p_true.r0, "i0": p_true.i0, "rshunt": RSH, "rp": RP,
            "p0": p_true.i0**2 * p_true.r0}
    budget = nm.analyze_noise("chan1", freqs[freqs > 0], ssp, bias, TC,
                              TBATH, gta=1e-10, squiddc=float(sq_level),
                              tload=tload)
    measured = df["psd"].iloc[k][freqs > 0]   # two-sided → fold
    ratio = budget["s_itot"] / (2.0 * measured)
    med = np.median(ratio)
    assert 0.7 < med < 1.4, med


def test_ibis_errors_finite_on_sc_branch():
    """Exact-partials error propagation: r0_err/p0_err stay finite on the
    SC branch (v0 ≈ 0), and an explicit rp carries zero uncertainty."""
    from detprocess_jax.models import ivbias

    rng = np.random.default_rng(0)
    rsh, rp, rn = 5e-3, 4e-3, 0.3
    biases = np.array([400e-6, 350e-6, 300e-6, 100e-6, 80e-6,
                       4e-6, 2e-6, 1e-6])
    r0s = np.array([rn, rn, rn, 0.15, 0.10, 0.0, 0.0, 0.0])
    imeas = biases * rsh / (r0s + rsh + rp) - 1.2e-6
    imeas += rng.standard_normal(len(imeas)) * 5e-10
    res = ivbias.analyze_ibis(biases, imeas, rsh=rsh, nnorm=3, nsc=3,
                              imeas_err=np.full(len(imeas), 5e-10))
    assert np.all(np.isfinite(res.r0_err))
    assert np.all(np.isfinite(res.p0_err))
    # SC points: r0 ≈ 0 with small finite error
    assert np.all(np.abs(res.r0[-3:]) < 5e-4)
    assert np.all(res.r0_err[-3:] < 0.05)

    res2 = ivbias.analyze_ibis(biases, imeas, rsh=rsh, nnorm=3, nsc=3,
                               rp=rp,
                               imeas_err=np.full(len(imeas), 5e-10))
    assert res2.rp == rp and res2.rp_err == 0.0
    assert np.all(np.isfinite(res2.r0_err))


def test_reference_accessor_surface(processed, sweep):
    """Reference-parity accessors (ivsweep.py:93-146, :192-331,
    :829-928, :1200-1230): dict setters, per-channel readout params,
    state-filtered fit drivers, and result getters."""
    from detprocess_jax.models import pulse
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    # dict-based data entry + rshunt/rp setters with list broadcast
    ana.set_data_from_dict({"chan1": df}, rsh=1e-3)
    ana.set_rshunt(["chan1"], rshunt=RSH, rshunt_err=1e-4)
    assert ana._rsh["chan1"] == RSH
    with pytest.raises(ValueError):
        ana.set_rshunt(["chan1"], rshunt=[1e-3, 2e-3])
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    ana.analyze_sweep("chan1")

    # state-filtered drivers populate the same summary as analyze_didv
    ana.fit_didv_sc("chan1")
    ana.fit_didv_normal("chan1")
    ana.fit_didv_transition("chan1", poles=2)
    summary = ana.get_didv_summary("chan1")
    assert summary is not None
    np.testing.assert_allclose(summary["sc_didv_fit_rp"], RP, rtol=0.15)
    np.testing.assert_allclose(summary["normal_didv_fit_rn"], RN,
                               rtol=0.15)

    # result-object getters
    objs = ana.get_didv_objects("chan1")
    assert objs and all(isinstance(v, dict) for v in objs.values())
    ibis = ana.get_ibis_qetpy_object("chan1")
    assert ibis is not None and abs(ibis.rn - RN) / RN < 0.05
    assert ana.get_ibis_qetpy_object("nope") is None

    # stored tc/tbath/tload defaults drive analyze_noise
    ana.set_tc("chan1", TC)
    ana.set_tbath(TBATH)
    ana.set_tload_guess(TLOAD)
    out = ana.analyze_noise("chan1", poles=2)
    assert len(out["budgets"]) >= 3
    with pytest.raises(ValueError):
        IVSweepAnalysis(verbose=False).analyze_noise("chan1")

    # resolution data getter
    tmpl = pulse.make_template(FS, 8192, 4096, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    ana.calc_energy_resolution("chan1", tmpl, FS, poles=2)
    res = ana.get_resolution_data("chan1")
    assert res and all(s > 0 for s in res.values())

    # clear drops analysis state and stored filter data
    ana.clear("chan1")
    assert "chan1" not in ana._sweep_df
    assert ana.get_didv_summary("chan1") is None


def test_set_rp_used_as_analyze_sweep_default(processed):
    """set_rp (ivsweep.py:285-331) feeds analyze_sweep when the sweep has
    no usable SC points."""
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    # drop the SC points entirely: rp must come from set_rp
    no_sc = df[df["state"] != "sc"].reset_index(drop=True)
    ana.set_data_from_dataframe("chan1", no_sc, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=0)
    ana.set_rp("chan1", rp=RP, rp_err=1e-4)
    ana.analyze_sweep("chan1")
    ibis = ana.get_ibis("chan1")
    np.testing.assert_allclose(ibis.rp, RP, rtol=1e-6)


def test_plot_didv_summary_smoke(processed, tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    proc, df = processed
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    ana.analyze_sweep("chan1")
    ana.analyze_didv("chan1", poles=2)
    fig = ana.plot_didv_summary("chan1", poles=2,
                                save_path=str(tmp_path / "didv.png"))
    assert fig is not None
    assert (tmp_path / "didv.png").exists()
