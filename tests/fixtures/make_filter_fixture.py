"""Generate a filter-file fixture with RAW h5py calls only.

This script deliberately does NOT import detprocess_jax: the fixture is
an independently-authored rendering of the documented filter-file layout
(reference: detprocess/core/filterdata.py:218-302, 604-633 — channel
groups holding ``{param}_{tag}`` entries; pd.Series payloads as
values+index; per-parameter ``_metadata``). tests/test_filterfile_interop.py
checks that FilterData.load_hdf5 reads this file and save_hdf5
round-trips it, so any accidental coupling between our writer and our
reader is caught.

Run from the repo root:  python tests/fixtures/make_filter_fixture.py
(regenerates tests/fixtures/filter_fixture.h5 deterministically)
"""

import os

import h5py
import numpy as np


FS = 1.25e6
N = 256


def main():
    path = os.path.join(os.path.dirname(__file__), "filter_fixture.h5")
    rng = np.random.default_rng(20260816)

    t = np.arange(N) / FS
    template = np.exp(-t / 200e-6) - np.exp(-t / 20e-6)
    template /= template.max()
    freqs = np.fft.fftfreq(N, d=1.0 / FS)
    psd = 1e-20 * (1.0 + 50.0 / np.maximum(np.abs(freqs), freqs[1]))
    csd = np.zeros((2, 2, N), dtype=complex)
    csd[0, 0] = psd
    csd[1, 1] = 2.0 * psd
    csd[0, 1] = 0.3 * psd * np.exp(0.7j)
    csd[1, 0] = np.conj(csd[0, 1])
    dpdi = (1.0 + 0.5j) * np.ones(N // 2 + 1) * 1e-7
    dpdi_f = np.fft.rfftfreq(N, d=1.0 / FS)

    with h5py.File(path, "w") as f:
        for chan in ("chanA", "chanB"):
            cg = f.create_group(chan)

            g = cg.create_group("template_default")
            g.attrs["__type__"] = "series"
            g.create_dataset("values", data=template)
            g.create_dataset("index", data=t)
            mg = g.create_group("_metadata")
            mg.attrs["channel"] = chan
            mg.attrs["sample_rate"] = FS
            mg.attrs["nb_samples"] = N
            mg.attrs["nb_pretrigger_samples"] = N // 4

            g = cg.create_group("psd_default")
            g.attrs["__type__"] = "series"
            g.create_dataset("values", data=psd)
            g.create_dataset("index", data=freqs)
            mg = g.create_group("_metadata")
            mg.attrs["channel"] = chan
            mg.attrs["sample_rate"] = FS
            mg.attrs["nb_samples"] = N

        # compound-channel CSD (complex → re/im pair)
        cc = f.create_group("chanA|chanB")
        g = cc.create_group("csd_default")
        g.attrs["__type__"] = "array"
        vg = g.create_group("values")
        vg.attrs["__complex__"] = True
        vg.create_dataset("re", data=csd.real)
        vg.create_dataset("im", data=csd.imag)
        mg = g.create_group("_metadata")
        mg.attrs["channel"] = "chanA|chanB"
        mg.attrs["sample_rate"] = FS
        mg.attrs["nb_samples"] = N

        # dPdI (complex series over rfft freqs, stored as array + freqs)
        ca = f["chanA"]
        g = ca.create_group("dpdi_2poles_default")
        g.attrs["__type__"] = "array"
        vg = g.create_group("values")
        vg.attrs["__complex__"] = True
        vg.create_dataset("re", data=dpdi.real)
        vg.create_dataset("im", data=dpdi.imag)
        mg = g.create_group("_metadata")
        mg.attrs["poles"] = 2
        g = ca.create_group("dpdi_2poles_default_freqs")
        g.attrs["__type__"] = "array"
        g.create_dataset("values", data=dpdi_f)
        g.create_group("_metadata")

        # dIdV fit results: scalar dict + array entry
        g = ca.create_group("didv_results_2poles_default")
        g.attrs["__type__"] = "dict"
        vg = g.create_group("values")
        vg.attrs["tau+"] = 1.2e-4
        vg.attrs["tau-"] = 3.0e-5
        vg.attrs["chi2"] = 1.05
        vg.create_dataset("cov", data=rng.standard_normal((4, 4)))
        mg = g.create_group("_metadata")
        mg.attrs["channel"] = "chanA"

        # IV-sweep dataframe: plain columns + one array-valued column
        g = f["chanB"].create_group("ivsweep_data_default")
        g.attrs["__type__"] = "dataframe"
        cols = g.create_group("columns")
        cols.create_dataset("tes_bias", data=np.linspace(0, 1e-4, 5))
        cols.create_dataset("state", data=np.array(
            [b"sc", b"sc", b"transition", b"normal", b"normal"]))
        sub = cols.create_group("avgtrace")
        sub.attrs["__array_rows__"] = True
        stack = np.full((5, 8), np.nan)
        lengths = np.zeros(5, dtype=np.int64)
        for i in range(5):
            stack[i, : 4 + i % 3] = rng.standard_normal(4 + i % 3)
            lengths[i] = 4 + i % 3
        sub.create_dataset("stack", data=stack)
        sub.create_dataset("lengths", data=lengths)
        g.attrs["__columns__"] = ["tes_bias", "state", "avgtrace"]
        g.create_group("_metadata")

    print(f"wrote {path}")


if __name__ == "__main__":
    main()
