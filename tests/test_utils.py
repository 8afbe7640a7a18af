"""Tests for channel algebra, windowing, and frequency utilities."""

import numpy as np
import pytest

from detprocess_jax.utils import channels, windows, freq, misc


AVAILABLE = ["Mv2303", "Mv3112", "chanA", "chanB", "chanC"]


class TestSplitChannelName:
    def test_single(self):
        assert channels.split_channel_name("chanA", AVAILABLE) == (["chanA"], None)

    def test_all(self):
        assert channels.split_channel_name("all", AVAILABLE) == (["all"], None)

    def test_comma(self):
        lst, sep = channels.split_channel_name("chanA,chanB", AVAILABLE)
        assert lst == ["chanA", "chanB"] and sep == ","

    def test_pipe_order_matters(self):
        lst, sep = channels.split_channel_name("chanB|chanA", AVAILABLE)
        assert lst == ["chanB", "chanA"] and sep == "|"

    def test_plus(self):
        lst, sep = channels.split_channel_name("chanA+chanB", AVAILABLE)
        assert lst == ["chanA", "chanB"] and sep == "+"

    def test_minus(self):
        lst, sep = channels.split_channel_name("chanA-chanB", AVAILABLE)
        assert sorted(lst) == ["chanA", "chanB"] and sep == "-"

    def test_minus_requires_available(self):
        with pytest.raises(ValueError):
            channels.split_channel_name("chanA-chanB", separator="-")

    def test_unknown_channel(self):
        with pytest.raises(ValueError):
            channels.split_channel_name("chanA+chanX", AVAILABLE)

    def test_separator_split_no_available(self):
        lst, sep = channels.split_channel_name("x|y|z", separator="|")
        assert lst == ["x", "y", "z"] and sep == "|"


class TestCombinationWeights:
    def test_sum(self):
        chans, w = channels.channel_combination_weights("chanA+chanB", AVAILABLE)
        assert chans == ["chanA", "chanB"] and w == [1.0, 1.0]

    def test_difference(self):
        chans, w = channels.channel_combination_weights("chanA-chanB", AVAILABLE)
        assert chans == ["chanA", "chanB"] and w == [1.0, -1.0]

    def test_plain(self):
        chans, w = channels.channel_combination_weights("chanA", AVAILABLE)
        assert chans == ["chanA"] and w == [1.0]


class TestWindows:
    def test_defaults(self):
        lo, hi = windows.extract_window_indices(1000, 250, 1e6)
        assert (lo, hi) == (0, 999)

    def test_from_trig(self):
        lo, hi = windows.extract_window_indices(
            1000, 250, 1e6,
            window_min_from_trig_usec=-100, window_max_from_trig_usec=100)
        assert (lo, hi) == (150, 350)

    def test_from_start_and_end(self):
        lo, hi = windows.extract_window_indices(
            1000, 250, 1e6,
            window_min_from_start_usec=10, window_max_to_end_usec=20)
        assert (lo, hi) == (10, 1000 - 20 - 1)

    def test_clamping(self):
        lo, hi = windows.extract_window_indices(
            1000, 250, 1e6, window_min_from_trig_usec=-1e6)
        assert lo == 0

    def test_inverted_raises(self):
        with pytest.raises(ValueError):
            windows.extract_window_indices(
                1000, 250, 1e6,
                window_min_from_trig_usec=100,
                window_max_from_trig_usec=-100)


class TestFreq:
    def test_estimate_sampling_rate_two_sided(self):
        fs = 1.25e6
        freqs = np.fft.fftfreq(4096, d=1 / fs)
        assert abs(freq.estimate_sampling_rate(freqs) - fs) < 1e-6

    def test_estimate_sampling_rate_one_sided(self):
        fs = 1.25e6
        freqs = np.fft.rfftfreq(4096, d=1 / fs)
        assert abs(freq.estimate_sampling_rate(freqs) - fs) < 1e-6

    def test_cleanup_freq_ranges(self):
        ranges, names = freq.cleanup_freq_ranges([[65.0, 45.0], 120.0])
        assert ranges == [[45.0, 65.0], [120.0]]
        assert names == ["45_65", "120"]

    def test_get_ind_freq_ranges(self):
        freqs = np.arange(0, 1000, 10.0)
        idx = freq.get_ind_freq_ranges([[100.0, 200.0], [55.0]], freqs)
        assert idx[0] == [10, 20]
        assert idx[1][1] == idx[1][0] + 1


class TestMisc:
    def test_series_name(self):
        from datetime import datetime
        name = misc.create_series_name(1, datetime(2026, 8, 16, 3, 4, 5))
        assert name == "I1_D20260816_T030405"
        assert channels.series_name_to_number(name) == int("1" + "20260816" + "030405")

    def test_unique_list(self):
        assert misc.unique_list([3, 1, 3, 2, 1]) == [3, 1, 2]

    def test_hyphen_range(self):
        assert misc.hyphen_range("1-3,5") == [1, 2, 3, 5]

    def test_convert_to_seconds(self):
        assert misc.convert_to_seconds("90s") == 90
        assert misc.convert_to_seconds("2m") == 120
        assert misc.convert_to_seconds("1.5h") == 5400

    def test_find_linear_segment(self):
        x = np.arange(10.0)
        y = 2 * x + 1
        y[7:] += np.array([1.0, 2.0, 3.0])  # break linearity at 7
        idx = misc.find_linear_segment(x, y, tolerance=0.05)
        assert idx[:3] == [0, 1, 2]
        assert 7 not in idx or 8 not in idx


class TestPrefetch:
    def test_prefetch_matches_sequential(self, tmp_path):
        from detprocess_jax.io.rawdata import RawWriter, RawReader
        from detprocess_jax.io.prefetch import prefetch_events

        fs, l = 1.25e6, 20000
        rng = np.random.default_rng(0)
        traces = rng.standard_normal((5, 1, l)) * 1e-6
        RawWriter(str(tmp_path / "raw"), "I1_D20260816_T170000", fs,
                  ["ch"]).write_dump(traces, dump_num=1)
        files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))

        seq = []
        r = RawReader(files)
        while True:
            tr, admin = r.read_next_event()
            if tr is None:
                break
            seq.append((tr, admin["event_number"]))

        pf = prefetch_events(RawReader(files), depth=2)
        got = []
        while True:
            tr, admin = pf.read_next_event()
            if tr is None:
                break
            got.append((tr, admin["event_number"]))
        # probing again after end-of-data keeps returning (None, None)
        assert pf.read_next_event() == (None, None)
        assert pf.read_next_event() == (None, None)
        pf.close()

        assert len(got) == len(seq) == 5
        for (a, ea), (b, eb) in zip(got, seq):
            assert ea == eb
            np.testing.assert_array_equal(a, b)

    def test_prefetch_error_propagates(self):
        from detprocess_jax.io.prefetch import prefetch_events

        class BadReader:
            def read_next_event(self, channels=None):
                raise RuntimeError("disk on fire")

        pf = prefetch_events(BadReader(), depth=2)
        with pytest.raises(RuntimeError, match="disk on fire"):
            next(pf)
        pf.close()


def test_get_dataframe_series_list(tmp_path):
    from detprocess_jax.utils.misc import get_dataframe_series_list

    for name in ("feature_grp_I1_D20260816_T120000_F0001.hdf5",
                 "feature_grp_I1_D20260816_T120000_F0002.hdf5",
                 "threshtrig_grp_I2_D20260817_T010101_F0001.hdf5"):
        (tmp_path / name).write_bytes(b"")
    series = get_dataframe_series_list(str(tmp_path))
    assert series == ["I1_D20260816_T120000", "I2_D20260817_T010101"]
    with pytest.raises(ValueError):
        get_dataframe_series_list(str(tmp_path / "missing"))


def test_find_psd_peaks_host():
    from detprocess_jax.utils.misc import find_psd_peaks

    fs = 1.25e6
    n = 8192
    f = np.fft.rfftfreq(n, 1 / fs)
    psd = np.full(len(f), 1e-20)
    for fk, amp in ((20e3, 5e-18), (35e3, 3e-18), (60e3, 8e-18)):
        k = np.argmin(np.abs(f - fk))
        psd[k] = amp
    peaks = find_psd_peaks(f, psd, fmin=10e3, fmax=50e3, npeaks=2,
                           min_separation_hz=1e3)
    assert len(peaks) == 2
    assert abs(peaks[0]["freq"] - 20e3) < 200    # strongest in band
    assert abs(peaks[1]["freq"] - 35e3) < 200
    # out-of-band request returns the closest bin
    got = find_psd_peaks(f, psd, fmin=2 * f[-1], fmax=3 * f[-1])
    assert got[0]["index"] == len(f) - 1


def test_reader_applies_close_loop_norm(tmp_path):
    """amps = stored·cal/close_loop_norm: per-channel normalization from
    /detconfig1 (real pytesdaq data stores ADC codes). The float-mode
    writer stores amps·close_loop_norm so write_dump(amps) round-trips
    for any detector_config."""
    import h5py

    from detprocess_jax.io.rawdata import RawWriter, RawReader

    rng = np.random.default_rng(0)
    traces = rng.standard_normal((2, 2, 256))
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260817_T020000", 1.25e6,
                  ["c1", "c2"],
                  detector_config={"c1": {"close_loop_norm": 4.0},
                                   "c2": {"tes_bias": 1e-4}})
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    # the reader DIVIDES the stored values by close_loop_norm …
    with h5py.File(files[0], "r") as f:
        stored = f["adc1"]["event_1"][...]
    np.testing.assert_allclose(stored[0], traces[0, 0] * 4.0, rtol=1e-6)
    np.testing.assert_allclose(stored[1], traces[0, 1], rtol=1e-6)
    # … so reading returns the amps that were written, both channels
    r = RawReader(files)
    tr, admin = r.read_next_event()
    np.testing.assert_allclose(tr[0], traces[0, 0], rtol=1e-6)
    np.testing.assert_allclose(tr[1], traces[0, 1], rtol=1e-6)


def test_reader_resolves_global_event_numbers(tmp_path):
    """read_single_event finds events by event_num attribute even when
    dataset names use a different (file-local) ordinal — real pytesdaq
    dumps can number events globally across dumps."""
    import h5py
    from detprocess_jax.io.rawdata import RawWriter, RawReader

    rng = np.random.default_rng(1)
    traces = rng.standard_normal((3, 1, 128))
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260817_T021000", 1.25e6,
                  ["c1"])
    path = w.write_dump(traces, dump_num=2)
    # renumber events globally: dump 2 carries event_num 1001..1003
    with h5py.File(path, "a") as f:
        for k in range(1, 4):
            f["adc1"][f"event_{k}"].attrs["event_num"] = 1000 + k
    r = RawReader([path])
    tr, admin = r.read_single_event(1002, file_name=path)
    np.testing.assert_allclose(tr[0], traces[1, 0], rtol=1e-6)
    assert admin["event_number"] == 1002
    with pytest.raises(KeyError):
        r.read_single_event(9999, file_name=path)
