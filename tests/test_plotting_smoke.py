"""Plotting API smoke tests (Agg backend): every public plotter renders
without error on small synthetic data. Mirrors the reference FilterData
plotters (detprocess/core/filterdata.py:1403-1604) and analysis plots.
"""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pandas as pd
import pytest

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.models import pulse, tesnoise
from detprocess_jax.utils import plotting


FS = 1.25e6
N = 512


@pytest.fixture(scope="module")
def fd():
    fd = FilterData(verbose=False)
    tmpl = pulse.make_template(FS, N, N // 4, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(N, 1e-18)
    fd.set_template("c1", tmpl, FS, pretrigger_length_samples=N // 4)
    fd.set_psd(["c1", "c2"], psd, FS)
    csd = np.zeros((2, 2, N), dtype=complex)
    csd[0, 0] = psd
    csd[1, 1] = psd
    csd[0, 1] = csd[1, 0] = 0.3 * psd
    fd.set_csd("c1|c2", csd, FS)
    fd.set_ivsweep_data("c1", pd.DataFrame({
        "tes_bias": np.linspace(1e-6, 1e-4, 8),
        "offset_noise": np.linspace(1e-7, 2e-6, 8),
        "offset_didv": np.linspace(1e-7, 2e-6, 8),
    }))
    return fd


def test_filterdata_plotters(fd):
    assert fd.plot_template("c1") is not None
    assert fd.plot_psd(["c1", "c2"]) is not None
    assert fd.plot_csd("c1|c2") is not None
    assert fd.plot_corrcoeff("c1|c2") is not None
    assert fd.plot_ivsweep_offset("c1") is not None


def test_noise_budget_and_didv_plots():
    params = tesnoise.TESParams(r0=0.15, rl=9e-3, beta=2.0, l=10.0,
                                L=4e-7, tau0=1e-3, G=1e-10, tc=0.04,
                                tload=0.03, tb=0.02, i0=2e-6,
                                squiddc=1e-11)
    freqs = np.fft.fftfreq(N, 1 / FS)
    f = np.where(freqs == 0, freqs[1], freqs)
    budget = {"freqs": freqs,
              "s_ites": tesnoise.s_ites(params, f),
              "s_iload": tesnoise.s_iload(params, f),
              "s_itfn": tesnoise.s_itfn(params, f),
              "s_isquid": tesnoise.s_isquid(params, f)}
    budget["s_itot"] = sum(budget[k] for k in
                           ("s_ites", "s_iload", "s_itfn", "s_isquid"))
    assert plotting.plot_noise_budget(budget) is not None

    sweep_df = pd.DataFrame({"tes_bias": np.linspace(1e-6, 1e-4, 6),
                             "r0": np.linspace(0.0, 0.3, 6),
                             "state": ["sc", "sc", "transition",
                                       "transition", "normal", "normal"]})
    assert plotting.plot_iv_sweep(sweep_df, x="tes_bias") is not None
