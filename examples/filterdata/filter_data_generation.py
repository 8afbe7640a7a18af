"""Filter-file generation: analytic templates + PSDs/CSDs + dIdV results
in one tagged HDF5 store.

Mirrors the reference's examples/filterdata/filter_data_generation.ipynb
(detprocess FilterData + Template + FilterDataProcessing:
core/filterdata.py, core/template.py, process/filterprocess.py).

Run:  python examples/filterdata/filter_data_generation.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np

from detprocess_jax import FilterData, Template
from detprocess_jax.models import pulse

FS = 1.25e6
NT, PRETRIG = 4096, 1024


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="filterdata_")
    os.makedirs(out_dir, exist_ok=True)

    # ---- analytic templates (2/3-pole + sum of two-poles) --------------
    tm = Template(verbose=True)
    tm.create_template("Mv2301", FS, trace_length_samples=NT,
                       pretrigger_length_samples=PRETRIG,
                       tau_r=20e-6, tau_f1=200e-6)          # 2-pole
    tm.create_template("Mv2302", FS, trace_length_samples=NT,
                       pretrigger_length_samples=PRETRIG,
                       A=1.0, B=0.3, tau_r=20e-6, tau_f1=200e-6,
                       tau_f2=800e-6, tag="threepole")      # 3-pole
    tm.create_template_sum_twopoles(
        "Mv2301", amplitudes=[1.0, 0.4], rise_times=[20e-6, 50e-6],
        fall_times=[200e-6, 900e-6], sample_rate=FS,
        trace_length_samples=NT, pretrigger_length_samples=PRETRIG,
        tag="sum2p")

    # ---- PSDs / CSD ----------------------------------------------------
    freqs = np.abs(np.fft.fftfreq(NT, 1 / FS))
    freqs[0] = freqs[1]
    psd = 1e-20 * (1.0 + 100.0 / freqs)
    tm.set_psd(["Mv2301", "Mv2302"], psd, sample_rate=FS)
    csd = np.zeros((2, 2, NT), dtype=complex)
    csd[0, 0] = psd
    csd[1, 1] = 1.5 * psd
    csd[0, 1] = csd[1, 0] = 0.2 * psd
    tm.set_csd("Mv2301|Mv2302", csd, sample_rate=FS)

    # ---- dIdV results + dataframes (API tail) --------------------------
    tm.set_didv_results("Mv2301", {"tau+": 1.2e-4, "tau-": 3e-5,
                                   "chi2": 1.02}, poles=2)
    import pandas as pd
    tm.set_didv_dataframe("Mv2301",
                          pd.DataFrame({"tes_bias": [1e-4],
                                        "rp": [4e-3]}))

    # ---- persist, reload, inspect --------------------------------------
    path = os.path.join(out_dir, "filter.h5")
    tm.save_hdf5(path)
    fd = FilterData(verbose=False).load_hdf5(path)
    fd.describe()

    t1, time_axis = fd.get_template("Mv2301")
    t2, _ = fd.get_template("Mv2301", tag="sum2p")
    print(f"templates: default peak {t1.max():.3f}, "
          f"sum2p peak {t2.max():.3f}")
    got_csd, _ = fd.get_csd("Mv2301|Mv2302")
    assert got_csd.shape == (2, 2, NT)
    psd_f, f_f = fd.get_psd("Mv2301", fold=True)
    print(f"folded PSD: {len(f_f)} bins, "
          f"white level {psd_f[-100:].mean():.2e} A²/Hz")
    print(f"filter file → {path}")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
