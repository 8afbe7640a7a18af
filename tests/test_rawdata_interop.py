"""Raw-data interop: read a pytesdaq-layout file authored by an
INDEPENDENT bare-h5py generator (tests/fixtures/make_raw_fixture.py,
which never imports this package) — proving RawReader/RawData against
the documented layout rather than against RawWriter."""

import os
import subprocess
import sys

import numpy as np
import pytest

from detprocess_jax.io.rawdata import RawData, RawReader

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "raw_fixture")
GEN = os.path.join(os.path.dirname(__file__), "fixtures",
                   "make_raw_fixture.py")

FS = 1.25e6
CAL = 2.5e-7
CLN = np.array([1.6e4, 2.4e4])
CHANNELS = ["Melange1pc1ch", "Melange4pc1ch"]
SERIES = "I2_D20260817_T101500"


@pytest.fixture(scope="module")
def fixture_files():
    if not os.path.isdir(FIXDIR):
        subprocess.run([sys.executable, GEN], check=True)
    files = sorted(os.path.join(FIXDIR, f) for f in os.listdir(FIXDIR)
                   if f.endswith(".hdf5"))
    adc = np.load(os.path.join(FIXDIR, "expected_adc.npy"))
    return files, adc


def test_metadata(fixture_files):
    files, adc = fixture_files
    reader = RawReader(files)
    md = reader.get_metadata()
    assert float(md["sample_rate"]) == FS
    assert md["channel_list"] == CHANNELS
    assert int(md["nb_events"]) == 3
    assert md["detector_config"][CHANNELS[0]]["close_loop_norm"] == CLN[0]
    assert reader.total_events() == 3


def test_sequential_read_and_conversion(fixture_files):
    files, adc = fixture_files
    reader = RawReader(files)
    traces, admins = reader.read_many_events()
    assert traces.shape == adc.shape
    # amps = adc · cal / close_loop_norm, per channel
    want = adc.astype(np.float64) * CAL / CLN[None, :, None]
    np.testing.assert_allclose(traces, want, rtol=1e-12)
    assert [a["event_number"] for a in admins] == [1, 2, 3]
    assert admins[0]["series_name"] == SERIES
    assert admins[0]["series_number"] == 2 * 10**14 + 20260817 * 10**6 \
        + 101500
    assert admins[0]["fridge_run_number"] == 12


def test_windowed_random_access(fixture_files):
    files, adc = fixture_files
    reader = RawReader(files)
    tr, admin = reader.read_single_event(2, files[0],
                                         trace_window=(100, 256))
    want = adc[1, :, 100:356].astype(np.float64) * CAL / CLN[:, None]
    np.testing.assert_allclose(tr, want, rtol=1e-12)
    assert admin["event_number"] == 2


def test_rawdata_group_scan(fixture_files):
    files, adc = fixture_files
    rd = RawData(FIXDIR)
    assert rd.get_series_list() == [SERIES]
    assert rd.get_facility() == 2
    assert rd.get_sample_rate() == FS
    assert rd.get_available_channels() == CHANNELS
    tr = rd.get_traces(SERIES, [3], channels=[CHANNELS[1]])
    want = adc[2, 1:2].astype(np.float64) * CAL / CLN[1]
    np.testing.assert_allclose(tr[0], want, rtol=1e-12)
    raw_counts = rd.get_traces(SERIES, [3], channels=[CHANNELS[1]],
                               adctoamp=False)
    np.testing.assert_allclose(raw_counts[0], adc[2, 1:2].astype(float))
