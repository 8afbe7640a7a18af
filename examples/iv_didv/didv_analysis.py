"""dIdV analysis: raw square-wave data → lock-in → 2/3-pole fits →
small-signal params → infinite-loop-gain bias params → dPdI → σ_E.

Mirrors the reference's examples/iv_didv/didv_analysis.ipynb
(detprocess DIDVAnalysis: core/didv.py; fits in models/didv.py, batched
Levenberg–Marquardt in ops/lm.py).

Run:  python examples/iv_didv/didv_analysis.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np

from detprocess_jax import DIDVAnalysis
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import tesnoise, pulse

FS = 1.25e6
SGFREQ, SGAMP, RSH = 100.0, 2e-8, 5e-3


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="didv_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(3)

    # ---- synthesize raw dIdV data from a known TES model ---------------
    true = tesnoise.TESParams(r0=0.15, rl=9e-3, beta=2.0, l=10.0, L=4e-7,
                              tau0=1e-3, G=1e-10, tc=0.04, tload=0.03,
                              tb=0.02, i0=2e-6, squiddc=1e-11)
    period = int(FS / SGFREQ)
    n = period * 4
    t = np.arange(n)
    sq = np.where((t % period) < period // 2, 0.5, -0.5) * (SGAMP * RSH)
    freqs = np.fft.fftfreq(n, 1 / FS)
    resp = tesnoise.didv(true, np.where(freqs == 0, freqs[1], freqs))
    resp_t = np.real(np.fft.ifft(resp * np.fft.fft(sq)))
    traces = (resp_t[None, :] + rng.standard_normal((24, n)) * 2e-10
              + true.i0)[:, None, :]
    writer = RawWriter(os.path.join(out_dir, "didv"),
                       "I1_D20260816_T130000", FS, ["Mv2301"],
                       prefix="didv", data_type="didv")
    writer.write_dump(traces, dump_num=1)
    files = sorted(os.path.join(out_dir, "didv", f)
                   for f in os.listdir(os.path.join(out_dir, "didv")))

    # ---- analysis -------------------------------------------------------
    didv = DIDVAnalysis(verbose=True)
    # lock-in averaging over square-wave periods + autocuts
    didv.process_raw_data("Mv2301", files, sgfreq=SGFREQ, sgamp=SGAMP,
                          rsh=RSH)
    # 2- and 3-pole complex-admittance fits
    didv.dofit("Mv2301", poles=2)
    didv.dofit("Mv2301", poles=3)
    fit2 = didv.get_fit("Mv2301", 2)
    print(f"2-pole fit cost {fit2.cost:.3e}")

    # IV-sweep bias point (normally from IVSweepAnalysis results)
    didv.set_ivsweep_results("Mv2301", {"r0": 0.15, "rp": 4e-3,
                                        "rshunt": RSH, "i0": true.i0,
                                        "ibias": 100e-6})
    didv.calc_smallsignal_params("Mv2301", poles=2)
    ssp = didv.get_smallsignal_params("Mv2301", 2)
    print(f"beta = {ssp['beta']:.2f} ± {ssp['beta_err']:.2f} (true 2.0)")
    print(f"loop gain = {ssp['l']:.1f} ± {ssp['l_err']:.1f} (true 10.0)")
    print(f"tau0 = {ssp['tau0']*1e3:.2f} ms (true 1.00 ms)")

    # infinite-loop-gain bias params (didv.py:646-744)
    ilg = didv.calc_bias_params_infinite_loop_gain("Mv2301",
                                                   poles=2)["Mv2301"]
    print(f"ILG: r0 = {ilg['r0']:.3f} Ω, i0 = {ilg['i0']*1e6:.2f} µA")

    # dPdI responsivity on the pulse template's frequency axis, then the
    # baseline energy resolution σ_E = [∫ 4|s̃·dPdI|²/S_P df]^(−1/2)
    nt = 4096
    freqs_t = np.fft.fftfreq(nt, 1 / FS)
    dpdi, dpdi_err = didv.calc_dpdi("Mv2301", freqs_t, poles=2)["Mv2301"]
    k1 = np.argmin(np.abs(freqs_t - 1e3))
    print(f"|dPdI| at 1 kHz ≈ {np.abs(dpdi[k1]):.2e} V "
          f"(± {np.abs(dpdi_err[k1]):.1e})")

    tmpl = pulse.make_template(FS, nt, nt // 4, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(nt, 1e-21)
    sigma_e = didv.calc_energy_resolution("Mv2301", tmpl, psd, FS, poles=2)
    print(f"energy resolution σ_E ≈ {sigma_e:.2e} J "
          f"= {sigma_e / 1.602176634e-19:.2f} eV")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
