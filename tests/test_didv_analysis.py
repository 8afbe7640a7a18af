"""Tests for the DIDVAnalysis driver, Template builder, and FilterBuilder."""

import numpy as np
import pytest

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import tesnoise, pulse
from detprocess_jax.pipelines.didv import DIDVAnalysis
from detprocess_jax.pipelines.template import Template, FilterBuilder

FS = 1.25e6
RSH, RP = 5e-3, 4e-3
SGFREQ, SGAMP = 100.0, 2e-8
R0, BETA, LOOP, IND, TAU0 = 0.15, 2.0, 10.0, 4e-7, 1e-3


@pytest.fixture(scope="module")
def didv_raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("didvraw")
    rng = np.random.default_rng(3)
    rl = RSH + RP
    ibias = 100e-6
    i0 = ibias * RSH / (R0 + rl)
    p = tesnoise.TESParams(r0=R0, rl=rl, beta=BETA, l=LOOP, L=IND,
                           tau0=TAU0, G=1e-10, tc=0.04, tload=0.03,
                           tb=0.02, i0=i0, squiddc=1e-11)
    period = int(FS / SGFREQ)
    n = period * 4
    t = np.arange(n)
    square_v = np.where((t % period) < period // 2, 0.5, -0.5) * (SGAMP * RSH)
    freqs = np.fft.fftfreq(n, 1 / FS)
    resp = tesnoise.didv(p, np.where(freqs == 0, freqs[1], freqs))
    resp_t = np.real(np.fft.ifft(resp * np.fft.fft(square_v)))
    traces = (resp_t[None, :] + rng.standard_normal((12, n)) * 2e-10
              + i0)[:, None, :]
    w = RawWriter(str(root), "I1_D20260816_T190000", FS, ["chan1"],
                  prefix="didv", data_type="didv")
    w.write_dump(traces, dump_num=1)
    return dict(files=sorted(str(f) for f in root.glob("*.hdf5")),
                params=p, ibias=ibias, i0=i0)


def test_didv_analysis_chain(didv_raw, tmp_path):
    ana = DIDVAnalysis(verbose=False)
    ana.process_raw_data("chan1", didv_raw["files"], SGFREQ, SGAMP, RSH)
    ana.dofit("chan1", poles=2)
    fit = ana.get_fit("chan1", 2)
    p = didv_raw["params"]
    a_true = p.rl + p.r0 * (1 + p.beta)
    np.testing.assert_allclose(fit.params[0], a_true, rtol=0.05)

    ana.set_ivsweep_results("chan1", {
        "r0": R0, "rp": RP, "rshunt": RSH, "i0": didv_raw["i0"],
        "ibias": didv_raw["ibias"]})
    ana.calc_smallsignal_params("chan1", poles=2)
    ssp = ana.get_smallsignal_params("chan1", 2)
    assert abs(ssp["beta"] - BETA) < 0.5
    assert abs(ssp["l"] - LOOP) / LOOP < 0.3

    ilg = ana.calc_bias_params_infinite_loop_gain("chan1", poles=2)
    assert np.isfinite(ilg["chan1"]["r0"])

    n = 4096
    freqs = np.fft.fftfreq(n, 1 / FS)
    ana.calc_dpdi("chan1", freqs, poles=2)
    dpdi, f = ana.get_dpdi("chan1", 2)
    assert dpdi.shape == (n,)
    # energy resolution with a template+psd
    tmpl = pulse.make_template(FS, n, 1024, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(n, 1e-20)
    sig = ana.calc_energy_resolution("chan1", tmpl, psd, FS, poles=2)
    assert np.isfinite(sig) and sig > 0

    # persistence of fit results through the filter file
    path = str(tmp_path / "didv.h5")
    ana.save_hdf5(path)
    back = FilterData(verbose=False).load_hdf5(path)
    stored = back._get("chan1", "didv_results_2poles_fit_default")
    np.testing.assert_allclose(stored["params"], fit.params, rtol=1e-12)


class TestTemplate:
    def test_create_analytic(self):
        t = Template(verbose=False)
        tmpl = t.create_template("chan1", FS, trace_length_samples=2048,
                                 pretrigger_length_samples=512,
                                 tau_r=20e-6, tau_f1=200e-6)
        assert tmpl.shape == (2048,)
        np.testing.assert_allclose(tmpl.max(), 1.0)
        arr, time, md = t.get_template("chan1", return_metadata=True)
        assert md["nb_poles"] == 2
        # 3-pole
        t.create_template("chan1", FS, trace_length_samples=2048,
                          pretrigger_length_samples=512, A=1.0, B=0.3,
                          tau_r=20e-6, tau_f1=100e-6, tau_f2=500e-6,
                          tag="threepole")
        _, _, md3 = t.get_template("chan1", tag="threepole",
                                   return_metadata=True)
        assert md3["nb_poles"] == 3

    def test_average_pulse(self):
        rng = np.random.default_rng(1)
        tmpl = pulse.make_template(FS, 1024, 256, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
        traces = (3e-6 * tmpl[None, :]
                  + rng.standard_normal((200, 1024)) * 1e-8 + 5e-7)
        t = Template(verbose=False)
        avg = t.calc_average_pulses("chan1", traces, FS, 256)
        # unit peak, matches the true shape
        np.testing.assert_allclose(avg.max(), 1.0)
        np.testing.assert_allclose(avg[300:600], tmpl[300:600], atol=0.02)

    def test_fit_templates(self):
        t = Template(verbose=False)
        t.create_template("chan1", FS, trace_length_samples=2048,
                          pretrigger_length_samples=512,
                          tau_r=25e-6, tau_f1=300e-6)
        fit = t.fit_templates("chan1")
        np.testing.assert_allclose(fit["tau_r"], 25e-6, rtol=0.05)
        np.testing.assert_allclose(fit["tau_f"], 300e-6, rtol=0.05)

    def test_power_template(self):
        t = Template(verbose=False)
        t.create_template("chan1", FS, trace_length_samples=1024,
                          pretrigger_length_samples=256,
                          tau_r=20e-6, tau_f1=200e-6)
        dpdi = np.full(1024, 2.0, dtype=complex)
        power = t.calc_power_template("chan1", dpdi, FS)
        arr, _, md = t.get_template("chan1", tag="power",
                                    return_metadata=True)
        np.testing.assert_allclose(arr, power)


def test_filterbuilder_shared_store(tmp_path):
    fb = FilterBuilder(verbose=False)
    fb.template.create_template("chan1", FS, trace_length_samples=1024,
                                pretrigger_length_samples=256,
                                tau_r=20e-6, tau_f1=200e-6)
    # template visible through the shared store on the noise side
    arr, _ = fb.noise.get_template("chan1")
    assert arr.shape == (1024,)
    path = str(tmp_path / "fb.h5")
    fb.save_hdf5(path)
    back = FilterData(verbose=False).load_hdf5(path)
    arr2, _ = back.get_template("chan1")
    np.testing.assert_allclose(arr2, arr)


def test_didv_reference_surface(didv_raw, tmp_path, capsys):
    """Reference-parity getters/printers on DIDVAnalysis
    (core/didv.py:57-160, :996-1320)."""
    import matplotlib
    matplotlib.use("Agg")
    ana = DIDVAnalysis(verbose=False)
    ana.process_raw_data("chan1", didv_raw["files"], SGFREQ, SGAMP, RSH)
    # empty results before any fit
    assert ana.get_fit_results("chan1", 2, verbose=False) == {}
    ana.dofit("chan1", poles=2)
    ana.set_ivsweep_results("chan1", {
        "r0": R0, "rp": RP, "rshunt": RSH, "i0": didv_raw["i0"],
        "i0_err": 1e-9, "r0_err": 1e-3, "p0": didv_raw["i0"]**2 * R0,
        "p0_err": 1e-16, "ibias": didv_raw["ibias"]})
    ana.calc_smallsignal_params("chan1", poles=2)
    ana.calc_bias_params_infinite_loop_gain("chan1", poles=2)

    # assembled fit results
    res = ana.get_fit_results("chan1", 2)
    assert {"params", "cov", "cost", "smallsignalparams",
            "biasparams", "biasparams_infinite_lgain"} <= set(res)
    assert abs(res["smallsignalparams"]["beta"] - BETA) < 0.5

    # bias params getters
    bias = ana.get_bias_params("chan1", poles=2)
    assert bias["r0"] == R0
    ilg = ana.get_bias_params_infinite_loop_gain("chan1", poles=2)
    assert np.isfinite(ilg["r0"])
    with pytest.raises(ValueError):
        ana.get_bias_params_infinite_loop_gain("chan1", poles=3)

    # qetpy-object getter returns the native data bundle
    data = ana.get_qetpy_object("chan1")
    assert data is ana.get_didv_data("chan1")
    with pytest.raises(ValueError):
        ana.get_qetpy_object("nope")

    # comparison table + printer + plot
    cmp_df = ana.compare_with_ivsweep("chan1", poles=2)
    assert "R0 [mOhms]" in cmp_df.index
    assert "IV sweep" in cmp_df.columns
    ana.print_fit_result("chan1", poles=2)
    out = capsys.readouterr().out
    assert "2-poles fit" in out and "beta" in out
    figs = ana.plot_fit_result("chan1", poles=2, save_path=str(tmp_path))
    assert len(figs) == 1
    assert (tmp_path / "didv_fit_chan1_2poles.png").exists()

    # save_didv_data persists and reloads
    path = str(tmp_path / "didv.h5")
    ana.save_didv_data("chan1", file_path_name=path, save_hdf5=True)
    fd = FilterData(verbose=False).load_hdf5(path)
    stored = fd.get_didv_results("chan1", poles=2)
    np.testing.assert_allclose(stored["params"], res["params"])

    # clear drops everything
    ana.clear("chan1")
    assert ana.get_fit_results("chan1", 2, verbose=False) == {}
    with pytest.raises(KeyError):
        ana.get_didv_data("chan1")


def test_set_iv_bor_data(tmp_path):
    """Beginning-of-run IV (core/didv.py:385-485): normal-point line fit
    plus one transition point recover i0/r0/p0."""
    rng = np.random.default_rng(9)
    rl = RSH + RP
    rn = 0.3
    ioffset = 1.0e-6
    n = 4096
    root = tmp_path / "bor"
    r0_true = 0.1

    def write(fname_prefix, dump, ibias, imeas):
        w = RawWriter(str(root), "I1_D20260816_T200000", FS, ["chan1"],
                      prefix=fname_prefix,
                      data_type="continuous",
                      detector_config={"chan1": {"tes_bias": ibias,
                                                 "close_loop_norm": 1.0}})
        traces = (imeas
                  + rng.standard_normal((6, 1, n)) * 1e-10)
        w.write_dump(traces, dump_num=dump)

    ibias_norms = [200e-6, 180e-6, 160e-6]
    for k, ib in enumerate(ibias_norms):
        write(f"iv_bor_n{k}", k + 1, ib, ioffset + ib * RSH / (rn + rl))
    ib_t = 50e-6
    i0_true = ib_t * RSH / (r0_true + rl)
    write("iv_bor_trans", 9, ib_t, ioffset + i0_true)

    ana = DIDVAnalysis(verbose=False)
    ana._didv_data["chan1"] = object()  # bias-params-only path
    with pytest.raises(ValueError, match="rp"):
        ana.set_iv_bor_data(str(root), 0, "chan1")
    ana._bias_params["chan1"] = {"rp": RP, "rshunt": RSH}
    params = ana.set_iv_bor_data(str(root), 0, "chan1")
    np.testing.assert_allclose(params["i0"], i0_true, rtol=1e-3)
    np.testing.assert_allclose(params["r0"], r0_true, rtol=1e-2)
    np.testing.assert_allclose(params["rn"], rn, rtol=1e-2)
    np.testing.assert_allclose(params["ioffset"], ioffset, rtol=1e-3)
    # fed into the ssp path
    assert ana._bias_params["chan1"]["r0"] == params["r0"]
