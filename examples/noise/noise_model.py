"""TES noise modeling: SQUID noise from the normal state, Tload from the
SC state, and the full Irwin–Hilton noise budget in transition.

Mirrors the reference's examples/noise/noise_model.ipynb (detprocess
NoiseModel: core/noisemodel.py; physics in models/tesnoise.py).

Run:  python examples/noise/noise_model.py
"""

import numpy as np

from detprocess_jax import NoiseModel
from detprocess_jax.models import tesnoise

FS = 1.25e6
N = 8192
RN, RL, RP = 0.30, 9e-3, 4e-3
TC, TLOAD, TBATH = 0.040, 0.030, 0.020


def synth_psd(params, rng, nev=400):
    """Welch-like PSD estimate of synthetic traces drawn from the model."""
    freqs = np.fft.fftfreq(N, 1 / FS)
    f = np.where(freqs == 0, freqs[1], freqs)
    # s_itot is ONE-sided; synthesize with the two-sided density s/2
    psd_true = tesnoise.s_itot(params, f)
    scale = np.sqrt(psd_true / 2.0 * FS * N)
    white = np.fft.fft(rng.standard_normal((nev, N)), axis=-1) / np.sqrt(N)
    traces = np.real(np.fft.ifft(white * scale, axis=-1))
    vfft = np.fft.fft(traces, axis=-1)
    return np.mean(np.abs(vfft) ** 2, axis=0) / (N * FS), freqs


def main():
    rng = np.random.default_rng(7)

    normal = tesnoise.TESParams(r0=RN, rl=RL, beta=0.0, l=0.0, L=4e-7,
                                tau0=1e-6, G=1e-10, tc=TC, tload=TLOAD,
                                tb=TBATH, i0=0.5e-6, squiddc=1e-11)
    sc = tesnoise.TESParams(r0=0.0, rl=RL, beta=0.0, l=0.0, L=4e-7,
                            tau0=1e-6, G=1e-10, tc=TC, tload=TLOAD,
                            tb=TBATH, i0=5e-6, squiddc=1e-11)
    trans = tesnoise.TESParams(r0=0.15, rl=RL, beta=2.0, l=10.0, L=4e-7,
                               tau0=1e-3, G=1e-10, tc=TC, tload=TLOAD,
                               tb=TBATH, i0=2e-6, squiddc=1e-11)

    psd_normal, freqs = synth_psd(normal, rng)
    psd_sc, _ = synth_psd(sc, rng)
    psd_trans, _ = synth_psd(trans, rng)

    nm = NoiseModel(verbose=True)

    # 1. SQUID+electronics noise from the normal-state PSD
    squid = nm.calc_squid_noise("chan1", psd_normal, freqs, RN, RL, 4e-7,
                                tc=TC, tload_guess=TLOAD)
    print(f"SQUID noise floor ≈ {np.median(squid[freqs != 0]):.2e} A/√Hz")

    # 2. normal-state fit for (L, Tload, squid level), Rn held fixed
    fit_n = nm.fit_normal_noise("chan1", psd_normal, freqs, RN, RL, TC)
    print(f"normal fit: L = {fit_n['L']*1e9:.0f} nH, "
          f"Tload = {fit_n['tload']*1e3:.1f} mK")

    # 3. Tload from the SC-state PSD
    tload = nm.fit_sc_noise("chan1", psd_sc, freqs, RL, 4e-7)
    print(f"SC fit: Tload = {tload*1e3:.1f} mK (true {TLOAD*1e3:.1f} mK)")

    # 4. transition noise budget (s_ites / s_iload / s_itfn / s_isquid),
    # using small-signal params from a dIdV fit and the IV bias point
    ssp = {"beta": 2.0, "l": 10.0, "L": 4e-7, "tau0": 1e-3}
    bias = {"r0": 0.15, "rshunt": 5e-3, "rp": RL - 5e-3, "i0": 2e-6}
    out = nm.analyze_noise("chan1", freqs, ssp, bias, tc=TC, tbath=TBATH)
    for k in ("s_ites", "s_iload", "s_itfn", "s_isquid", "s_itot"):
        print(f"  {k}: median {np.median(out[k][freqs != 0]):.3e} A^2/Hz")
    # sanity: the budget total tracks the measured transition PSD
    m = np.abs(freqs) > 1e3
    ratio = np.median(2.0 * psd_trans[m] / out["s_itot"][m])
    print(f"measured/model transition PSD ratio ≈ {ratio:.2f}")
    return out


if __name__ == "__main__":
    main()
