"""Interactive OptimumFilterTrigger object (pipelines/oftrigger.py) —
reference core/oftrigger.py:324-1037 surface: update_trace →
find_triggers → get_trigger_data_df, residual re-trigger, saturation
veto, edge exclusion, EventBuilder integration."""

import numpy as np
import pandas as pd
import pytest

from detprocess_jax.models import pulse
from detprocess_jax.pipelines.oftrigger import (OptimumFilterTrigger,
                                                combine_trigger_data)
from detprocess_jax.pipelines.triggers import EventBuilder

FS = 1.25e6
NT = 1024
PRETRIG = 256
L = 50000


@pytest.fixture(scope="module")
def setup():
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    rng = np.random.default_rng(3)
    sigma = np.sqrt(psd[0] * FS)
    trace = rng.standard_normal(L) * sigma
    inj = [(12000, 4e-6), (30000, 2e-6)]
    for pos, amp in inj:
        trace[pos - PRETRIG:pos - PRETRIG + NT] += amp * tmpl
    return tmpl, psd, trace, inj


def make_trigger(tmpl, psd):
    return OptimumFilterTrigger("chan1", FS, tmpl, psd.astype(complex),
                                PRETRIG)


def test_update_and_find(setup):
    tmpl, psd, trace, inj = setup
    t = make_trigger(tmpl, psd)
    t.update_trace(trace=trace)

    assert t.get_filtered_trace().shape == (1, L)
    assert t.get_filtered_delta_chi2().shape == (L,)
    # padding zeroes the edges
    assert np.all(t.get_filtered_delta_chi2()[:NT] == 0.0)

    # 0.5 ms window: wide enough to merge the filter's anti-correlation
    # sidelobes into their parent pulse (the Δχ² threshold is
    # polarity-blind, exactly like the reference — oftrigger.py:977)
    t.find_triggers(5.0, pileup_window_msec=0.5)
    df = t.get_trigger_data_df()
    assert t.get_chi2_threshold() is not None
    assert len(df) == len(inj)
    idx = np.sort(df["trigger_index"].to_numpy())
    for (pos, amp), found in zip(inj, idx):
        # OF timing jitter at these SNRs is several samples (noiseless
        # alignment is proven exactly in test_trigger.py)
        assert abs(found - pos) <= 16
    # amplitudes recover truth; suffixed columns mirror base ones
    amps = df.sort_values("trigger_index")["trigger_amplitude"].to_numpy()
    # rtol accounts for max-pick selection bias: the kept sample is the
    # max-Δχ² one of the merged group, whose amplitude overshoots truth
    np.testing.assert_allclose(amps, [a for _, a in inj], rtol=0.3)
    np.testing.assert_array_equal(df["trigger_amplitude_chan1"],
                                  df["trigger_amplitude"])
    assert set(df["trigger_channel"]) == {"chan1"}


def test_accessors(setup):
    tmpl, psd, _, _ = setup
    t = make_trigger(tmpl, psd)
    assert t.get_phi().shape == (1, 1, NT)
    assert t.get_norm() > 0
    assert t.get_resolution().shape == (1,)
    # resolution consistent with the OF identity 1/sqrt(sum |s|^2/psd)
    assert 0 < t.get_resolution()[0] < 1e-6


def test_filtered_trace_input_matches_trace_input(setup):
    tmpl, psd, trace, _ = setup
    t1 = make_trigger(tmpl, psd)
    t1.update_trace(trace=trace)
    t2 = make_trigger(tmpl, psd)
    t2.update_trace(filtered_trace=t1.get_filtered_trace(), padding=True)
    np.testing.assert_allclose(t2.get_filtered_delta_chi2(),
                               t1.get_filtered_delta_chi2(),
                               rtol=1e-5, atol=1e-3)


def test_residual_retrigger_finds_pileup(setup):
    tmpl, psd, _, _ = setup
    rng = np.random.default_rng(9)
    sigma = np.sqrt(psd[0] * FS)
    trace = rng.standard_normal(L) * sigma
    # big pulse + small one INSIDE its merge window: one first-pass
    # trigger; the residual pass must reveal the second
    trace[20000 - PRETRIG:20000 - PRETRIG + NT] += 50e-6 * tmpl
    trace[20150 - PRETRIG:20150 - PRETRIG + NT] += 5e-6 * tmpl

    t = make_trigger(tmpl, psd)
    t.update_trace(trace=trace)
    ret = t.find_triggers(5.0, pileup_window_samples=400, residual=True,
                          return_trigger_data=True)
    first, first_dchi2, second, second_dchi2 = ret
    n_first = len(first["chan1"]["trigger_index"])
    df = t.get_trigger_data_df()
    assert len(df) > n_first        # residual added at least one
    # the residual pass reveals the hidden pulse's neighborhood; the
    # group max can sit tens of samples off (noise cross-terms
    # 2·a_pulse·W·a_noise survive the subtraction — same behavior as the
    # reference's subtract-and-retrigger, oftrigger.py:795-825)
    idx = df["trigger_index"].to_numpy()
    assert np.any(np.abs(idx - 20150) <= 64)
    # no duplicate indices after the combine
    assert len(set(idx.tolist())) == len(idx)
    # the stored delta-chi2 trace is restored to the FIRST pass's
    np.testing.assert_array_equal(t.get_filtered_delta_chi2(),
                                  first_dchi2)


def test_saturation_veto_skips_subtraction(setup):
    tmpl, psd, _, _ = setup
    rng = np.random.default_rng(10)
    sigma = np.sqrt(psd[0] * FS)
    trace = rng.standard_normal(L) * sigma
    trace[20000 - PRETRIG:20000 - PRETRIG + NT] += 50e-6 * tmpl
    trace[20150 - PRETRIG:20150 - PRETRIG + NT] += 5e-6 * tmpl

    t = make_trigger(tmpl, psd)
    t.update_trace(trace=trace)
    # saturation threshold below the big pulse: it is vetoed, nothing is
    # subtracted, and the residual pass finds nothing new
    t.find_triggers(5.0, pileup_window_samples=400, residual=True,
                    saturation_amplitudes_LPF_50kHz=[10e-6])
    df_veto = t.get_trigger_data_df()

    t2 = make_trigger(tmpl, psd)
    t2.update_trace(trace=trace)
    t2.find_triggers(5.0, pileup_window_samples=400, residual=False)
    df_once = t2.get_trigger_data_df()
    assert len(df_veto) == len(df_once)


def test_edge_exclusion_and_livetime(setup):
    tmpl, psd, trace, inj = setup
    t = make_trigger(tmpl, psd)
    t.update_trace(trace=trace)
    # exclude everything before 12 ms: drops the 12000-sample trigger
    # (9.6 ms) but keeps 30000 (24 ms)
    t.find_triggers(5.0, pileup_window_msec=0.5,
                    edge_exclusion_msec=12.0, livetime=3.5)
    df = t.get_trigger_data_df()
    assert len(df) == 1
    assert abs(int(df["trigger_index"].iloc[0]) - 30000) <= 16
    assert df["trigger_edge_exclusion_time_chan1"].iloc[0] == 12.0e-3
    assert df["trigger_livetime_chan1"].iloc[0] == 3.5


def test_dynamic_window_grouping(setup):
    tmpl, psd, trace, inj = setup
    t = make_trigger(tmpl, psd)
    t.update_trace(trace=trace)
    # huge dynamic window merges BOTH injected pulses into one trigger
    t.find_triggers_once(5.0, dynamic=True,
                         dynamic_threshold_function=lambda d: 1e9)
    assert len(t.get_trigger_data()["chan1"]["trigger_index"]) == 1
    # moderate window keeps the two pulses separate (but still merges
    # each pulse's anti-correlation sidelobes into it)
    t.find_triggers_once(5.0, dynamic=True,
                         dynamic_threshold_function=lambda d: 2000.0)
    assert len(t.get_trigger_data()["chan1"]["trigger_index"]) == 2


def test_eventbuilder_acquire_triggers(setup):
    tmpl, psd, trace, inj = setup
    builder = EventBuilder()
    builder.add_trigger_object(
        "chan1", OptimumFilterTrigger("chan1", FS, tmpl,
                                      psd.astype(complex), PRETRIG))
    df = builder.acquire_triggers("chan1", trace, 5.0,
                                  pileup_window_msec=0.5)
    assert len(df) == len(inj)
    out = builder.build_event({"event_time": 0.0, "series_number": 1},
                              fs=FS)
    assert len(out) == len(inj)
    assert "trigger_prod_id" in out.columns


def test_nxm_two_channel_trigger():
    """2-channel joint trigger (list channel → 'a|b' name, CSD [2,2,F]),
    incl. the residual + multi-channel saturation-veto path."""
    t1 = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                             tau_f1=200e-6)
    t2 = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=30e-6,
                             tau_f1=300e-6)
    tmpl = np.stack([t1[None, :], 0.8 * t2[None, :]], axis=0)  # [2,1,NT]
    csd = np.zeros((2, 2, NT), complex)
    csd[0, 0] = 4e-18
    csd[1, 1] = 6e-18
    rng = np.random.default_rng(5)
    n = 60000
    trace = np.stack([rng.standard_normal(n) * np.sqrt(4e-18 * FS),
                      rng.standard_normal(n) * np.sqrt(6e-18 * FS)])
    inj = [(20000, 8e-6), (45000, 6e-6)]
    for p, a in inj:
        trace[0, p - PRETRIG:p - PRETRIG + NT] += a * t1
        trace[1, p - PRETRIG:p - PRETRIG + NT] += 0.8 * a * t2

    t = OptimumFilterTrigger(["chA", "chB"], FS, tmpl, csd, PRETRIG)
    assert t._trigger_name == "chA|chB"
    t.update_trace(trace=trace)
    t.find_triggers(6.0, pileup_window_msec=0.5)
    df = t.get_trigger_data_df()
    assert len(df) == 2
    idx = np.sort(df["trigger_index"].to_numpy())
    for (p, a), got in zip(inj, idx):
        assert abs(got - p) <= 16
    amps = df.sort_values("trigger_index")["trigger_amplitude_0"]
    np.testing.assert_allclose(amps, [a for _, a in inj], rtol=0.1)
    # channel-shape validation
    with pytest.raises(ValueError, match="channel"):
        t.update_trace(trace=trace[:1])
    # residual re-trigger with a per-channel saturation veto runs and
    # keeps the two true triggers (possibly adding residual artifacts)
    t.update_trace(trace=trace)
    t.find_triggers(6.0, pileup_window_msec=0.5, residual=True,
                    saturation_amplitudes_LPF_50kHz=[1e-3, 1e-3])
    idx2 = t.get_trigger_data_df()["trigger_index"].to_numpy()
    for p, _ in inj:
        assert np.any(np.abs(idx2 - p) <= 16)
    assert len(set(idx2.tolist())) == len(idx2)


def test_combine_trigger_data_dedup():
    a = {"c": {"trigger_index": [5, 9], "trigger_time": [0.5, 0.9],
               "trigger_index_c": [5, 9], "trigger_time_c": [0.5, 0.9]}}
    b = {"c": {"trigger_index": [9, 14], "trigger_time": [0.9, 1.4],
               "trigger_index_c": [9, 14], "trigger_time_c": [0.9, 1.4]}}
    out = combine_trigger_data(a, b, [5, 9], [9, 14])["c"]
    assert out["trigger_index"] == [5, 9, 14]
    assert out["trigger_time"] == [0.5, 0.9, 1.4]
    assert out["trigger_index_c"] == out["trigger_index"]


def test_combine_trigger_data_asymmetric_columns():
    """Columns present in only one pass stay row-aligned (None-padded),
    so the merged dict is always DataFrame-constructible."""
    a = {"c": {"trigger_index": [5], "only_first": ["x"]}}
    b = {"c": {"trigger_index": [5, 14], "only_second": ["p", "q"]}}
    out = combine_trigger_data(a, b, [5], [5, 14])["c"]
    df = pd.DataFrame(out)      # must not raise ragged-length errors
    assert out["trigger_index"] == [5, 14]
    assert out["only_second"] == [None, "q"]
    assert out["only_first"] == ["x", None]
    assert len(df) == 2


def test_empty_result_schema_and_padding_flag(setup):
    tmpl, psd, _, _ = setup
    rng = np.random.default_rng(21)
    sigma = np.sqrt(psd[0] * FS)
    quiet = rng.standard_normal(8192) * sigma
    t = make_trigger(tmpl, psd)
    t.update_trace(trace=quiet)
    t.find_triggers(5.0, pileup_window_msec=0.1)
    df = t.get_trigger_data_df()
    # zero-trigger frames keep the full schema incl. trigger_channel
    assert len(df) == 0 and "trigger_channel" in df.columns

    # padding=False on the RAW-trace path: a pulse inside the first
    # template length is triggerable (padding=True suppresses it)
    edge = quiet.copy()
    edge[:NT - PRETRIG] += 30e-6 * tmpl[PRETRIG:]   # pulse peak at t=0
    t.update_trace(trace=edge, padding=False)
    t.find_triggers(5.0, pileup_window_msec=0.1)
    idx_nopad = t.get_trigger_data_df()["trigger_index"].to_numpy()
    assert np.any(idx_nopad < NT)
    t.update_trace(trace=edge, padding=True)
    t.find_triggers(5.0, pileup_window_msec=0.1)
    idx_pad = t.get_trigger_data_df()["trigger_index"].to_numpy()
    assert not np.any(idx_pad < NT)


def test_filtered_trace_input_clears_stale_lpf(setup):
    """A filtered_trace without its raw trace must not leave a previous
    trace's 50 kHz LPF driving the saturation veto."""
    tmpl, psd, trace, _ = setup
    t = make_trigger(tmpl, psd)
    t.update_trace(trace=trace)
    assert t._raw_trace_lpf_50khz is not None
    filt = t.get_filtered_trace()
    t.update_trace(filtered_trace=filt)
    assert t._raw_trace_lpf_50khz is None
    # veto treats triggers as unsaturated without a raw trace
    assert not t._is_saturated(12000, [1e-9], True)


def test_object_matches_batched_pipeline(setup, tmp_path):
    """Cross-implementation consistency: the interactive object's
    host-side merge and the batched pipeline's on-device tiled merge
    (find_triggers_tiled) must find the SAME triggers on the same trace
    — two independent merge implementations over one FIR kernel."""
    import yaml
    from detprocess_jax.io.filterfile import FilterData
    from detprocess_jax.io.rawdata import RawData, RawWriter
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    tmpl, psd, _, _ = setup
    rng = np.random.default_rng(33)
    sigma = np.sqrt(psd[0] * FS)
    n = 60000
    trace = rng.standard_normal((1, 1, n)) * sigma
    for pos, amp in [(15000, 30e-6), (30000, 10e-6), (45000, 50e-6),
                     (45300, 12e-6)]:     # last two merge (window 625)
        trace[0, 0, pos - PRETRIG:pos - PRETRIG + NT] += amp * tmpl

    raw_dir = tmp_path / "raw"
    RawWriter(str(raw_dir), "I1_D20260818_T090000", FS,
              ["chan1"]).write_dump(trace, dump_num=1)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", psd, FS)
    filter_path = str(tmp_path / "filter.h5")
    fd.save_hdf5(filter_path)
    config_path = str(tmp_path / "trig.yaml")
    with open(config_path, "w") as fh:
        yaml.safe_dump({"trigger": {
            "chan1": {"run": True, "template_tag": "default",
                      "threshold_sigma": 8.0,
                      "pileup_window_msec": 0.5}}}, fh)

    raw_files = sorted(str(p) for p in raw_dir.glob("*.hdf5"))
    df_pipe = TriggerProcessing(
        raw_files, config_path, filter_data=filter_path,
        verbose=False).process(capacity=64, lgc_save=False)

    # object on the identical trace (read back through the same IO)
    readback = RawData(str(raw_dir)).get_traces(
        "I1_D20260818_T090000", [1], channels=["chan1"])[0]
    t = make_trigger(tmpl, psd)
    t.update_trace(trace=readback)
    t.find_triggers(8.0, pileup_window_msec=0.5)
    df_obj = t.get_trigger_data_df()

    got_pipe = np.sort(df_pipe["trigger_index"].to_numpy())
    got_obj = np.sort(df_obj["trigger_index"].to_numpy())
    np.testing.assert_array_equal(got_pipe, got_obj)
    assert len(got_obj) == 3      # pileup pair merged into one
    np.testing.assert_allclose(
        np.sort(df_pipe["trigger_delta_chi2"].to_numpy()),
        np.sort(df_obj["trigger_delta_chi2"].to_numpy()),
        rtol=1e-5)


def test_input_shape_validation(setup):
    tmpl, psd, _, _ = setup
    with pytest.raises(ValueError, match="ambiguous|shaped"):
        OptimumFilterTrigger("c", FS, np.ones((4, 7)),
                             psd.astype(complex), PRETRIG)
    t = make_trigger(tmpl, psd)
    with pytest.raises(ValueError, match="required"):
        t.update_trace()
    with pytest.raises(ValueError, match="update_trace"):
        t.find_triggers_once(5.0)
