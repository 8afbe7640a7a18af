"""API-parity tail: accessors and small utilities that exist on the
reference classes (core/rawdata.py, core/noise.py, utils/utils.py,
utils/arg_utils.py) and that a migrating user will reach for."""

import numpy as np
import pytest

from detprocess_jax.io.rawdata import (
    RawData, RawWriter, series_to_number, series_number_to_name)
from detprocess_jax.utils.misc import build_range_str, hyphen_range, twopole

FS = 1.25e6
N = 4096
CHANNELS = ["chan1", "chan2"]


class TestSeriesNames:
    def test_roundtrip(self):
        for name in ("I1_D20260816_T160000", "I23_D20200101_T000001"):
            assert series_number_to_name(series_to_number(name)) == name

    def test_known_value(self):
        # I1_D20260816_T160000 -> 1*10^14 + 20260816*10^6 + 160000
        assert series_to_number("I1_D20260816_T160000") == 120260816160000
        assert series_number_to_name(120260816160000) == \
            "I1_D20260816_T160000"


class TestRangeStr:
    def test_compress_runs(self):
        assert build_range_str([1, 2, 3, 5]) == "1-3_5"
        assert build_range_str([7]) == "7"
        assert build_range_str([3, 1, 2]) == "1-3"

    def test_inverse_of_hyphen_range(self):
        vals = [1, 2, 3, 7, 9, 10]
        s = build_range_str(vals)
        assert hyphen_range(s.replace("_", ",")) == vals


class TestTwopole:
    def test_zero_before_t0_positive_after(self):
        t = np.linspace(0, 1e-2, 1000)
        p = twopole(t, rtau=1e-4, ftau=1e-3, amp0=1.0, t0=2e-3)
        assert (p[t < 2e-3] == 0).all()
        assert p[t > 2.5e-3][:100].max() > 0

    def test_falltime_error_trap(self):
        # ftau <= rtau must not produce a negative-everywhere pulse
        t = np.linspace(0, 1e-2, 1000)
        p = twopole(t, rtau=1e-3, ftau=1e-4, amp0=1.0, t0=1e-3)
        assert p.max() > 0


@pytest.fixture(scope="module")
def rawgroup(tmp_path_factory):
    root = tmp_path_factory.mktemp("apiparity") / "run12_group1"
    rng = np.random.default_rng(3)
    series = ["I1_D20260816_T160000", "I1_D20260816_T170000"]
    all_traces = {}
    for k, ser in enumerate(series):
        traces = rng.standard_normal((3, 2, N)) * 1e-6 + k * 1e-5
        w = RawWriter(str(root), ser, FS, CHANNELS,
                      data_type="continuous", group_name="run12_group1",
                      detector_config={
                          "chan1": {"close_loop_norm": 2.0},
                          "chan2": {"close_loop_norm": 4.0}})
        w.write_dump(traces, dump_num=1)
        all_traces[ser] = traces
    return dict(root=str(root), series=series, traces=all_traces)


class TestRawDataAccessors:
    def test_group_identity(self, rawgroup):
        import os
        rd = RawData(rawgroup["root"])
        assert rd.get_group_name() == "run12_group1"
        assert rd.get_base_path() == os.path.dirname(rawgroup["root"])
        assert rd.get_facility() == 1
        assert rd.verbose in (True, False)

    def test_sample_rate_and_channels(self, rawgroup):
        rd = RawData(rawgroup["root"])
        assert rd.get_sample_rate() == FS
        assert rd.get_available_channels() == CHANNELS

    def test_data_config(self, rawgroup):
        rd = RawData(rawgroup["root"])
        cfg = rd.get_data_config()
        assert set(cfg) == set(rawgroup["series"])
        one = cfg[rawgroup["series"][0]]
        assert one["channel_list"] == CHANNELS
        assert one["detector_config"]["chan1"]["close_loop_norm"] == 2.0
        assert float(one["overall"]["sample_rate"]) == FS

    def test_describe_smoke(self, rawgroup, capsys):
        RawData(rawgroup["root"]).describe()
        out = capsys.readouterr().out
        assert "run12_group1" in out and "continuous" in out

    def test_get_traces_by_series_number(self, rawgroup):
        rd = RawData(rawgroup["root"])
        ser = rawgroup["series"][1]
        snum = series_to_number(ser)
        tr = rd.get_traces([snum, snum], [1, 3])
        assert tr.shape == (2, 2, N)
        # write_dump(amps) → get_traces returns amps: the writer stores
        # amps·close_loop_norm (cal=1) so the reader's universal
        # amps = stored·cal/close_loop_norm round-trips exactly
        np.testing.assert_allclose(tr[0], rawgroup["traces"][ser][0],
                                   rtol=1e-6)

    def test_get_traces_broadcast_series_and_channels(self, rawgroup):
        rd = RawData(rawgroup["root"])
        ser = rawgroup["series"][0]
        tr, admins = rd.get_traces(ser, [1, 2], channels=["chan2"],
                                   include_metadata=True)
        assert tr.shape == (2, 1, N)
        assert [a["event_number"] for a in admins] == [1, 2]
        assert admins[0]["series_name"] == ser

    def test_get_traces_adc_counts(self, rawgroup):
        rd = RawData(rawgroup["root"])
        ser = rawgroup["series"][0]
        raw = rd.get_traces(ser, [1], adctoamp=False)
        amps = rd.get_traces(ser, [1], adctoamp=True)
        np.testing.assert_allclose(
            raw[0], amps[0] * np.array([[2.0], [4.0]]), rtol=1e-6)

    def test_get_traces_missing_event(self, rawgroup):
        rd = RawData(rawgroup["root"])
        with pytest.raises(KeyError):
            rd.get_traces(rawgroup["series"][0], [99])
        with pytest.raises(KeyError):
            rd.get_traces("I9_D20200101_T000000", [1])


class TestNoiseAccessors:
    def test_offset_and_fs(self, tmp_path):
        from detprocess_jax.pipelines.noise import Noise
        rng = np.random.default_rng(5)
        L = 50000
        traces = rng.standard_normal((4, 2, L)) * 2e-6 + 3e-5
        w = RawWriter(str(tmp_path / "raw"), "I1_D20260816_T160000", FS,
                      CHANNELS, data_type="continuous")
        w.write_dump(traces, dump_num=1)
        files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
        noise = Noise(files, verbose=False)
        assert noise.get_sample_rate() is None
        assert noise.get_offset("chan1") is None  # warns, returns None
        noise.generate_randoms(nrandoms=20, random_rate=200.0,
                               min_separation_msec=1.0,
                               edge_exclusion_msec=1.0, seed=7)
        noise.calc_psd(["chan1"], trace_length_samples=512,
                       nsigma_cut=10.0)
        assert noise.get_sample_rate() == FS
        off = noise.get_offset("chan1")
        assert off == pytest.approx(3e-5, rel=0.05)
        noise.clear_randoms()
        assert noise.get_sample_rate() is None
        assert noise.get_offset("chan1") is None
        # filter data survives clear_randoms
        assert noise.get_psd("chan1") is not None


class TestNoiseModelSetters:
    """Reference-parity NoiseModel surface (core/noisemodel.py:50-360,
    :695-746): external-result setters, stored defaults, state-slot PSDs,
    and the sim-slot getters."""

    def _ssp_bias(self):
        ssp = {"beta": 2.0, "l": 10.0, "L": 4e-7, "tau0": 1e-3}
        bias = {"r0": 0.1, "rp": 4e-3, "rshunt": 5e-3, "i0": 2e-6,
                "p0": 4e-13, "rn": 0.3}
        return ssp, bias

    def test_stored_defaults_drive_analyze_noise(self):
        from detprocess_jax.pipelines.noisemodel import NoiseModel
        nm = NoiseModel(verbose=False)
        ssp, bias = self._ssp_bias()
        nm.set_iv_didv_results_from_dict(
            "chan1", didv_results={"smallsignalparams": ssp}, poles=2,
            ivsweep_results=bias)
        nm.set_tc("chan1", 0.040)
        nm.set_tbath(0.020)
        freqs = np.linspace(100.0, 1e5, 200)
        budget = nm.analyze_noise("chan1", freqs)
        assert np.all(budget["s_itot"] > 0)
        # get_noise_data returns the sim transition slot
        sim = nm.get_noise_data("chan1", mode="transition")
        np.testing.assert_allclose(sim["s_itot"], budget["s_itot"])
        with pytest.raises(ValueError):
            nm.get_noise_data("chan1", mode="sc")
        with pytest.raises(ValueError):
            nm.get_noise_data("nope")
        with pytest.raises(ValueError):
            nm.get_noise_data()

    def test_missing_rn_rejected(self):
        from detprocess_jax.pipelines.noisemodel import NoiseModel
        nm = NoiseModel(verbose=False)
        ssp, _ = self._ssp_bias()
        with pytest.raises(ValueError, match="No Rn"):
            nm.set_iv_didv_results_from_dict(
                "chan1", didv_results={"smallsignalparams": ssp},
                ivsweep_results={"rp": 4e-3, "rshunt": 5e-3})

    def test_state_psd_slot_and_validation(self):
        from detprocess_jax.pipelines.noisemodel import NoiseModel
        nm = NoiseModel(verbose=False)
        n = 256
        psd = np.ones(n)
        freqs = np.fft.fftfreq(n, d=1.0 / FS)
        nm.set_psd("chan1", psd, freqs, "normal")
        assert "psd" in nm._noise_data["chan1"]["normal"]
        with pytest.raises(ValueError, match="folded"):
            nm.set_psd("chan1", psd[:128], np.abs(freqs[:128]), "sc")
        with pytest.raises(ValueError, match="state"):
            nm.set_psd("chan1", psd, freqs, "superduper")
        # state=None falls through to the FilterData tagged store
        nm.set_psd("chan1", psd, FS, tag="default")
        assert nm.get_psd("chan1") is not None
        # the parent's documented keyword form must keep working through
        # the override (regression: sample_rate passed twice)
        nm.set_psd("chan1", psd, sample_rate=FS, tag="kw")
        assert nm.get_psd("chan1", tag="kw") is not None

    def test_fit_results_setters(self):
        from detprocess_jax.pipelines.noisemodel import NoiseModel
        nm = NoiseModel(verbose=False)
        nm.set_normal_fit_results("chan1", squiddc=6e-12, squidpole=200.0,
                                  squidn=0.7)
        assert nm._noise_data["chan1"]["normal"]["fit"]["squidpole"] == 200.0
        with pytest.raises(ValueError):
            nm.set_normal_fit_results("chan1", squiddc=6e-12)
        nm.set_sc_fit_results("chan1", tload=0.03)
        assert nm.get_tload("chan1") == 0.03
        with pytest.raises(ValueError):
            nm.set_sc_fit_results("chan1")
        nm.set_inductance("chan1", 4e-7, "normal")
        with pytest.raises(ValueError):
            nm.set_inductance("chan1", 4e-7, "transition")

    def test_squid_noise_setter_feeds_analyze(self):
        from detprocess_jax.pipelines.noisemodel import NoiseModel
        nm = NoiseModel(verbose=False)
        ssp, bias = self._ssp_bias()
        freqs = np.linspace(100.0, 1e5, 200)
        squid = np.full(200, 25e-24)  # (5 pA/rtHz)^2
        nm.set_squid_noise("chan1", squid, freqs)
        budget = nm.analyze_noise("chan1", freqs, ssp, bias,
                                  tc=0.040, tbath=0.020)
        np.testing.assert_allclose(budget["s_isquid"], 25e-24, rtol=1e-6)
        sim_n = nm.get_noise_data("chan1", mode="normal")
        np.testing.assert_allclose(sim_n["s_isquid"], squid)

    def test_squid_fit_formula(self):
        from detprocess_jax.pipelines.noisemodel import NoiseModel
        freqs = np.array([100.0, 1000.0])
        out = NoiseModel.get_squid_noise_from_fit(freqs, 6e-12, 200.0, 0.7)
        want = (6e-12 * (1 + (200.0 / freqs) ** 0.7)) ** 2
        np.testing.assert_allclose(out, want)

    def test_roundtrip_through_file(self, tmp_path):
        from detprocess_jax.pipelines.noisemodel import NoiseModel
        ssp, bias = self._ssp_bias()
        nm = NoiseModel(verbose=False)
        nm.set_iv_didv_results_from_dict(
            "chan1", didv_results={"smallsignalparams": ssp}, poles=2,
            ivsweep_results=bias)
        path = str(tmp_path / "filter.h5")
        nm.save_hdf5(path)
        nm2 = NoiseModel(verbose=False)
        nm2.set_iv_didv_results_from_file(path, poles=2)
        assert nm2._noise_data["chan1"]["smallsignalparams"][
            "beta"] == pytest.approx(2.0)
        assert nm2._noise_data["chan1"]["biasparams"]["rn"] == \
            pytest.approx(0.3)


class TestEventBuilderSurface:
    """Reference EventBuilder surface (core/eventbuilder.py:40-160)."""

    def _mk_df(self, chan, indices):
        import pandas as pd
        return pd.DataFrame({
            "trigger_index": indices,
            "trigger_time": [i / FS for i in indices],
            "trigger_delta_chi2": [10.0] * len(indices),
            "trigger_channel": [chan] * len(indices),
        })

    def test_trigger_object_registry(self):
        from detprocess_jax.pipelines.triggers import EventBuilder
        eb = EventBuilder()
        obj = object()
        eb.add_trigger_object("chan1", obj)
        assert eb.get_trigger_object("chan1") is obj
        with pytest.raises(ValueError, match="already stored"):
            eb.add_trigger_object("chan1", obj)
        with pytest.raises(ValueError, match="does not exist"):
            eb.get_trigger_object("nope")

    def test_add_trigger_data_unique_per_channel(self):
        from detprocess_jax.pipelines.triggers import EventBuilder
        eb = EventBuilder()
        eb.add_trigger_data("chan1", self._mk_df("chan1", [100, 5000]))
        eb.add_trigger_data("chan2", self._mk_df("chan2", [900]))
        with pytest.raises(ValueError, match="already added"):
            eb.add_trigger_data("chan1", self._mk_df("chan1", [42]))
        df = eb.get_event_df()
        assert list(df["trigger_index"]) == [100, 900, 5000]
        eb.clear_event()
        assert eb.get_event_df() is None
        # after clear_event a channel can submit again
        eb.add_trigger_data("chan1", self._mk_df("chan1", [7]))

    def test_acquire_triggers_with_callable_engine(self):
        from detprocess_jax.pipelines.triggers import EventBuilder
        eb = EventBuilder()
        seen = {}

        def engine(trace, thresh, positive_pulses=True):
            seen["thresh"] = thresh
            return self._mk_df("chan1", [int(np.argmax(trace))])

        eb.add_trigger_object("chan1", engine)
        trace = np.zeros(4096)
        trace[1234] = 5.0
        out = eb.acquire_triggers("chan1", trace, 4.0,
                                  positive_pulses=True)
        assert seen["thresh"] == 4.0
        assert list(out["trigger_index"]) == [1234]
        assert eb._current_nb_samples == 4096
        assert list(eb.get_event_df()["trigger_index"]) == [1234]


class TestRandomsAccessors:
    def test_paths_and_series_dict(self, rawgroup):
        from detprocess_jax.pipelines.randoms import Randoms
        import glob, os
        files = sorted(glob.glob(os.path.join(rawgroup["root"], "*.hdf5")))
        r = Randoms(files, verbose=False)
        assert r.verbose is False
        r.verbose = True
        assert r.verbose is True
        sd = r.get_series_dict()
        assert set(sd) == set(rawgroup["series"])
        assert all(len(v) == 1 for v in sd.values())
        assert r.get_group_name() == "run12_group1"
        assert r.get_base_path() == os.path.dirname(rawgroup["root"])
        assert r.get_output_path() is None

    def test_paths_nested_series_layout(self, rawgroup, tmp_path):
        """{group}/{series}/*.hdf5 layout (the RawData._build_file_map
        fallback): the group is one level above the series directory
        (regression: the series dir was reported as the group)."""
        from detprocess_jax.pipelines.randoms import Randoms
        import glob, os, shutil
        group = tmp_path / "run13_group2"
        ser = rawgroup["series"][0]
        (group / ser).mkdir(parents=True)
        src = sorted(glob.glob(os.path.join(rawgroup["root"],
                                            f"*{ser}*.hdf5")))
        files = [shutil.copy(f, group / ser) for f in src]
        r = Randoms(files, verbose=False)
        assert r.get_group_name() == "run13_group2"
        assert r.get_base_path() == str(tmp_path)

    def test_output_path_recorded(self, rawgroup, tmp_path):
        from detprocess_jax.pipelines.randoms import Randoms
        import glob, os
        files = sorted(glob.glob(os.path.join(rawgroup["root"], "*.hdf5")))
        r = Randoms(files, verbose=False)
        out = str(tmp_path / "randout")
        r.process(nrandoms=5, min_separation_msec=0.1,
                  edge_exclusion_msec=0.1, seed=3, lgc_save=True,
                  output_path=out)
        assert r.get_output_path() == out


class TestFilterDataSurface:
    def test_verbose_property(self):
        from detprocess_jax.io.filterfile import FilterData
        fd = FilterData(verbose=False)
        assert fd.verbose is False
        fd.verbose = True
        assert fd.verbose is True

    def test_set_ivsweep_data_from_dict(self):
        import pandas as pd
        from detprocess_jax.io.filterfile import FilterData
        fd = FilterData(verbose=False)
        df1 = pd.DataFrame({"tes_bias": [1e-6, 2e-6]})
        fd.set_ivsweep_data_from_dict({"chan1": df1, "chan2": df1},
                                      tag="t0")
        got = fd.get_ivsweep_data("chan1", tag="t0")
        assert list(got["tes_bias"]) == [1e-6, 2e-6]


class TestTemplateSurface:
    def _template(self):
        from detprocess_jax.pipelines.template import Template
        t = Template(verbose=False)
        t.create_template("chan1", FS, trace_length_samples=1024,
                          pretrigger_length_samples=512, A=1.0,
                          tau_r=20e-6, tau_f1=200e-6)
        return t

    def test_get_template_in_current_raw_and_freq(self):
        t = self._template()
        cur = t.get_template_in_current("chan1", use_fit=False)
        assert cur.shape == (1024,)
        fr, md = t.get_template_in_current("chan1", use_fit=False,
                                           domain="freq",
                                           return_metadata=True)
        assert np.iscomplexobj(fr) and md["sample_rate"] == FS
        with pytest.raises(ValueError, match="domain"):
            t.get_template_in_current("chan1", domain="banana")

    def test_get_template_in_current_from_fit(self):
        t = self._template()
        fit = t.fit_templates("chan1")
        assert fit["tau_r"] == pytest.approx(20e-6, rel=0.1)
        smooth = t.get_template_in_current("chan1", use_fit=True)
        raw = t.get_template_in_current("chan1", use_fit=False)
        # fitted pulse tracks the analytic one closely
        assert np.corrcoef(smooth, raw)[0, 1] > 0.999

    def test_get_template_in_power(self):
        t = self._template()
        n = 1024
        freqs = np.fft.fftfreq(n, d=1.0 / FS)
        dpdi = np.full(n, 2.0 + 0j)
        p = t.get_template_in_power("chan1", dpdi=dpdi, use_fit=False)
        assert p.shape == (n,)
        assert np.isfinite(p).all()

    def test_clear_templates_only(self):
        t = self._template()
        t.set_psd("chan1", np.ones(1024), FS)
        t.clear("chan1")
        with pytest.raises((KeyError, ValueError)):
            t.get_template("chan1")
        assert t.get_psd("chan1") is not None
        t.clear(clear_filter_data=True)
        with pytest.raises((KeyError, ValueError)):
            t.get_psd("chan1")

    def test_qp_template_is_self(self):
        t = self._template()
        assert t.qp_template is t


class TestSaltingAccessors:
    def test_dm_sampling_and_splits(self):
        from detprocess_jax.pipelines.salting import Salting
        from detprocess_jax.io.filterfile import FilterData
        s = Salting(FilterData(verbose=False), verbose=False)
        assert s.get_dataframe() is None
        assert s.get_injectiontimes() is None
        assert s.get_sample_rate() is None
        assert len(s.get_DMenergies()) == 0

        sampled = s.sample_DMpdf(lambda x: np.exp(-x), (0.01, 1.0),
                                 nsamples=500, seed=11)
        assert sampled.shape == (500,)
        assert (sampled >= 0.01).all() and (sampled <= 1.0).all()
        # accumulated in eV (keV input × 1e3)
        acc = s.get_DMenergies()
        np.testing.assert_allclose(np.sort(acc), np.sort(sampled * 1e3))
        s.sample_DMpdf(lambda x: np.exp(-x), (0.01, 1.0), nsamples=100,
                       seed=12)
        assert len(s.get_DMenergies()) == 600
        s.clear_DMenergies()
        assert len(s.get_DMenergies()) == 0

        splits = s.channel_energy_split(npairs=50, seed=4)
        assert len(splits) == 50
        for pair in splits:
            assert pair.sum() == pytest.approx(1.0)
            assert (pair >= 0).all()
        assert s.get_energy_perchannel() is splits
        ones = Salting.set_energy_splits_to1(
            [list(p) for p in splits])
        assert all(all(v == 1 for v in p) for p in ones)

    def test_set_raw_data(self, rawgroup):
        from detprocess_jax.pipelines.salting import Salting
        from detprocess_jax.io.filterfile import FilterData
        from detprocess_jax.io.rawdata import RawData
        s = Salting(FilterData(verbose=False), verbose=False)
        s.set_raw_data(rawgroup["root"])
        assert s.get_sample_rate() == FS
        assert len(s._raw_files_from_store()) == 2
        with pytest.raises(ValueError, match="directory or RawData"):
            s.set_raw_data(12345)
        rd = RawData(rawgroup["root"])
        s2 = Salting(FilterData(verbose=False), verbose=False)
        s2.set_raw_data(rd)
        assert s2.get_sample_rate() == FS


class TestFiltergenAliases:
    def test_proces_aliases_dispatch(self, monkeypatch):
        from detprocess_jax.pipelines.filtergen import FilterDataProcessing
        calls = []

        def fake_process(self, channels=None, enable_noise=True,
                         enable_template=True, enable_didv=True, **kw):
            calls.append((enable_noise, enable_template, enable_didv))

        monkeypatch.setattr(FilterDataProcessing, "process", fake_process)
        proc = FilterDataProcessing.__new__(FilterDataProcessing)
        proc.proces_didv()
        proc.proces_noise()
        assert calls == [(False, False, True), (True, False, False)]
