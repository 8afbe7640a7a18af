"""Filter-file interop: reader vs an independently-authored fixture.

tests/fixtures/filter_fixture.h5 is generated by
tests/fixtures/make_filter_fixture.py with RAW h5py calls (no
detprocess_jax imports), rendering the documented layout of the
reference filter file (detprocess/core/filterdata.py:218-302, 604-633:
channel groups of ``{param}_{tag}`` entries, pd.Series as values+index,
per-parameter ``_metadata``). This breaks any accidental writer↔reader
coupling in io/filterfile.py. Also covers the FilterData API tail:
clear_data, set_data, didv/noise dataframe accessors
(filterdata.py:179-248, 1296-1401).
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from detprocess_jax.io.filterfile import FilterData


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "filter_fixture.h5")
FS = 1.25e6
N = 256


@pytest.fixture(scope="module")
def fixture_path(tmp_path_factory):
    if os.path.exists(FIXTURE):
        return FIXTURE
    # regenerate if the committed fixture is missing
    subprocess.run([sys.executable,
                    os.path.join(os.path.dirname(__file__), "fixtures",
                                 "make_filter_fixture.py")], check=True)
    return FIXTURE


@pytest.fixture(scope="module")
def fd(fixture_path):
    return FilterData(verbose=False).load_hdf5(fixture_path)


def test_reads_template_series(fd):
    arr, t, md = fd.get_template("chanA", return_metadata=True)
    assert arr.shape == (N,)
    assert np.isclose(arr.max(), 1.0)
    np.testing.assert_allclose(t, np.arange(N) / FS)
    assert md["sample_rate"] == FS
    assert md["nb_pretrigger_samples"] == N // 4


def test_reads_psd_and_fold(fd):
    psd, freqs = fd.get_psd("chanB")
    assert psd.shape == (N,)
    np.testing.assert_allclose(freqs, np.fft.fftfreq(N, d=1 / FS))
    psd_f, f_f = fd.get_psd("chanB", fold=True)
    assert len(f_f) == N // 2 + 1


def test_reads_complex_csd(fd):
    csd, freqs = fd.get_csd("chanA|chanB")
    assert csd.shape == (2, 2, N)
    assert np.iscomplexobj(csd)
    np.testing.assert_allclose(csd[1, 0], np.conj(csd[0, 1]))


def test_reads_dpdi_and_didv_results(fd):
    dpdi, freqs = fd.get_dpdi("chanA", poles=2)
    assert np.iscomplexobj(dpdi) and dpdi.shape == (N // 2 + 1,)
    res = fd.get_didv_results("chanA", poles=2)
    assert np.isclose(res["tau+"], 1.2e-4)
    assert res["cov"].shape == (4, 4)


def test_reads_dataframe_with_array_column(fd):
    df = fd.get_ivsweep_data("chanB")
    assert list(df["state"]) == ["sc", "sc", "transition", "normal",
                                 "normal"]
    assert df["avgtrace"][2].shape == (4 + 2 % 3,)


def test_roundtrip_preserves_everything(fd, tmp_path):
    out = str(tmp_path / "roundtrip.h5")
    fd.save_hdf5(out)
    fd2 = FilterData(verbose=False).load_hdf5(out)
    a1, _ = fd.get_template("chanA")
    a2, _ = fd2.get_template("chanA")
    np.testing.assert_array_equal(a1, a2)
    c1, _ = fd.get_csd("chanA|chanB")
    c2, _ = fd2.get_csd("chanA|chanB")
    np.testing.assert_array_equal(c1, c2)
    d1 = fd.get_ivsweep_data("chanB")
    d2 = fd2.get_ivsweep_data("chanB")
    np.testing.assert_array_equal(d1["tes_bias"], d2["tes_bias"])
    np.testing.assert_array_equal(d1["avgtrace"][3], d2["avgtrace"][3])
    r1 = fd.get_didv_results("chanA", poles=2)
    r2 = fd2.get_didv_results("chanA", poles=2)
    assert r1["tau+"] == r2["tau+"]
    np.testing.assert_array_equal(r1["cov"], r2["cov"])


# ---------------------------------------------------------------------------
# API tail: clear_data / set_data / didv & noise dataframes
# ---------------------------------------------------------------------------

def _small_store():
    fd = FilterData(verbose=False)
    fd.set_template("c1", np.arange(8.0), sample_rate=FS,
                    pretrigger_length_samples=4)
    fd.set_template("c2", np.arange(8.0), sample_rate=FS,
                    pretrigger_length_samples=4)
    fd.set_psd("c1", np.ones(8), sample_rate=FS)
    return fd


def test_clear_data_all():
    fd = _small_store()
    fd.clear_data()
    assert fd.data == {}


def test_clear_data_channel_and_tag():
    fd = _small_store()
    fd.clear_data("c2")
    assert "c2" not in fd.data and "c1" in fd.data
    # tag clears by substring, like the reference (filterdata.py:207-212)
    fd.clear_data("c1", tag="psd")
    assert not fd.has("c1", "psd_default")
    assert fd.has("c1", "template_default")
    with pytest.raises(ValueError):
        fd.clear_data(tag="default")


def test_set_data_merge_and_overwrite():
    fd = _small_store()
    incoming = {"c1": {"psd_default": pd.Series(np.full(8, 9.0))},
                "c3": {"template_default": pd.Series(np.ones(4))}}
    fd.set_data(incoming, overwrite=False)
    psd, _ = fd.get_psd("c1")
    np.testing.assert_array_equal(psd, np.ones(8))   # kept
    assert "c3" in fd.data                           # new channel added
    fd.set_data(incoming, overwrite=True)
    psd, _ = fd.get_psd("c1")
    np.testing.assert_array_equal(psd, np.full(8, 9.0))


def test_didv_noise_dataframe_accessors(tmp_path):
    fd = FilterData(verbose=False)
    df_didv = pd.DataFrame({"tes_bias": [1e-6, 2e-6],
                            "rp": [0.003, 0.003]})
    df_noise = pd.DataFrame({"tes_bias": [1e-6], "offset": [1e-8]})
    fd.set_didv_dataframe("c1", df_didv, tag="default",
                          metadata={"group": "g1"})
    fd.set_noise_dataframe("c1", df_noise)
    with pytest.raises(ValueError):
        fd.set_didv_dataframe("c1", {"not": "a dataframe"})
    with pytest.raises((KeyError, ValueError)):
        fd.get_didv_dataframe("missing")

    out = str(tmp_path / "proc.h5")
    fd.save_hdf5(out)
    fd2 = FilterData(verbose=False).load_hdf5(out)
    got = fd2.get_didv_dataframe("c1")
    np.testing.assert_array_equal(got["tes_bias"], df_didv["tes_bias"])
    got_n = fd2.get_noise_dataframe("c1")
    np.testing.assert_array_equal(got_n["offset"], df_noise["offset"])
