"""IV/dIdV sweep: raw bias-point data → IBIS analysis → per-point dIdV
fits → energy resolution vs bias.

Mirrors the reference's examples/iv_didv/compare_ivsweeps.ipynb flow
(detprocess IVSweepProcessing + IVSweepAnalysis: core/ivsweep.py,
process/ivprocess.py; IBIS in models/ivbias.py).

Run:  python examples/iv_didv/ivsweep_analysis.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np

from detprocess_jax import IVSweepProcessing, IVSweepAnalysis
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import tesnoise

FS = 1.25e6
SGFREQ, SGAMP, RSH = 100.0, 2e-8, 5e-3
RN, RP = 0.30, 4e-3
RL = RSH + RP
TC, TLOAD, TBATH = 0.040, 0.030, 0.020


def _point(ib, r0, beta=2.0, loop=10.0, tau0=1e-3):
    i0 = ib * RSH / (r0 + RL) if (r0 + RL) > 0 else 0.0
    return tesnoise.TESParams(r0=r0, rl=RL, beta=beta, l=loop, L=4e-7,
                              tau0=tau0, G=1e-10, tc=TC, tload=TLOAD,
                              tb=TBATH, i0=i0, squiddc=1e-11)


def _noise_traces(p, n, nev, rng):
    freqs = np.fft.fftfreq(n, 1 / FS)
    # s_itot is ONE-sided; synthesize with the two-sided density s/2
    psd = tesnoise.s_itot(p, np.where(freqs == 0, freqs[1], freqs))
    white = np.fft.fft(rng.standard_normal((nev, n)), axis=-1) / np.sqrt(n)
    return (np.real(np.fft.ifft(white * np.sqrt(psd / 2.0 * FS * n),
                                axis=-1))
            + p.i0)


def _didv_traces(p, nper, nev, rng):
    period = int(FS / SGFREQ)
    n = period * nper
    t = np.arange(n)
    sq = np.where((t % period) < period // 2, 0.5, -0.5) * (SGAMP * RSH)
    freqs = np.fft.fftfreq(n, 1 / FS)
    resp = tesnoise.didv(p, np.where(freqs == 0, freqs[1], freqs))
    resp_t = np.real(np.fft.ifft(resp * np.fft.fft(sq)))
    return resp_t[None, :] + rng.standard_normal((nev, n)) * 2e-10 + p.i0


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="ivsweep_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(12)

    # bias points: normal plateau → transition → superconducting
    biases = [400e-6, 350e-6, 300e-6, 120e-6, 100e-6, 80e-6, 60e-6,
              4e-6, 2e-6, 1e-6]
    r0s = [RN, RN, RN, 0.20, 0.15, 0.10, 0.06, 0.0, 0.0, 0.0]
    bias_points = []
    for k, (ib, r0) in enumerate(zip(biases, r0s)):
        flat = r0 in (RN, 0.0)
        p = _point(ib, r0, beta=0.0 if flat else 2.0,
                   loop=0.0 if flat else 10.0,
                   tau0=1e-6 if flat else 1e-3)
        nd = os.path.join(out_dir, f"noise_{k}")
        RawWriter(nd, f"I1_D20260816_T17{k:02d}00", FS, ["chan1"],
                  prefix="iv", data_type="noise").write_dump(
            _noise_traces(p, 8192, 20, rng)[:, None, :], dump_num=1)
        dd = os.path.join(out_dir, f"didv_{k}")
        RawWriter(dd, f"I1_D20260816_T18{k:02d}00", FS, ["chan1"],
                  prefix="didv", data_type="didv").write_dump(
            _didv_traces(p, 4, 8, rng)[:, None, :], dump_num=1)
        bias_points.append({
            "tes_bias": ib,
            "noise_files": sorted(os.path.join(nd, f)
                                  for f in os.listdir(nd)),
            "didv_files": sorted(os.path.join(dd, f)
                                 for f in os.listdir(dd)),
        })

    # ---- processing: per-bias-point autocuts, PSD, offsets, dIdV mean --
    proc = IVSweepProcessing(verbose=True)
    df = proc.process("chan1", bias_points, sgfreq=SGFREQ, sgamp=SGAMP,
                      rsh=RSH)
    print(f"processed {len(df)} bias points; "
          f"states: {df['state'].tolist()}")

    # ---- analysis: IBIS (i0/r0/p0 + offsets), per-point dIdV fits ------
    ana = IVSweepAnalysis(verbose=True)
    ana.set_data_from_dataframe("chan1", df, rsh=RSH)
    ana.set_nb_sc_normal_points("chan1", nnorm=3, nsc=3)
    out = ana.analyze_sweep("chan1")
    ibis = ana.get_ibis("chan1")
    print(f"IBIS: Rn = {ibis.rn*1e3:.1f} mΩ (true {RN*1e3:.0f}), "
          f"Rp = {ibis.rp*1e3:.2f} mΩ (true {RP*1e3:.1f})")
    print("r0 across transition:",
          np.round(out["r0"].to_numpy()[3:7], 3), "(true 0.2/0.15/0.1/0.06)")

    df2 = ana.analyze_didv("chan1", poles=(2,))
    loops = [e["ssp_2poles"]["l"]
             for e, st in zip(df2["didv_fits"], df2["state"])
             if st == "transition" and "ssp_2poles" in e]
    print(f"transition loop gains: {np.round(loops, 1)} (true 10.0)")
    # state-aware fits: SC/normal points get 1-pole fits whose dVdI(0)
    # yields Rp/Rn, cross-checked against IBIS (warns on disagreement)
    res = ana.get_ivsweep_results("chan1", "didv")
    print(f"dIdV-fit Rp = {res['sc_didv_fit_rp']*1e3:.2f} ± "
          f"{res['sc_didv_fit_rp_err']*1e3:.2f} mΩ; "
          f"Rn = {res['normal_didv_fit_rn']*1e3:.1f} ± "
          f"{res['normal_didv_fit_rn_err']*1e3:.1f} mΩ "
          f"(IBIS cross-check passed if no WARNING above)")
    ana.set_ivsweep_data("chan1", out)
    ana.save_hdf5(os.path.join(out_dir, "sweep_results.h5"))
    print(f"results → {out_dir}/sweep_results.h5")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
