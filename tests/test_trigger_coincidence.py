"""Batched multi-channel coincidence drain vs the per-event EventBuilder.

The FAST_DRAIN path vectorizes the EventBuilder coincidence merge
(core/eventbuilder.py:336-497 semantics: diff-window ranges, greedy
unique-channel split, max-Δχ² primary, suffixed-column substring copy)
as numpy column ops, one DataFrame per batch. These tests pin it
frame-for-frame — columns, ORDER, dtypes, values — against the
per-event EventBuilder path on a 3-channel coincidence config in
plain / edge-exclusion / residual / salted modes, with the data built
to exercise every merge case:

  * pure coincidence (3 unique channels in one window)
  * single-channel pileup (no merge)
  * mixed pileup+coincidence (greedy unique-channel split)
  * primary selection on both sides (max Δχ² on chan1 vs chan2)
"""

import numpy as np
import pandas as pd
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.pipelines import triggers as trig_pipe
from detprocess_jax.pipelines.triggers import TriggerProcessing

FS = 1.25e6
NT, PRE = 512, 128
L = 60_000
CHANNELS = ["chan1", "chan2", "chan3"]


def _make_raw(root, rng, nev=3, int16=False):
    # amplitudes sit at ~9-13 matched-filter sigma (sigma_A ~ 1.4e-10
    # for this template/PSD) so the delta-chi2 runs stay a few tens of
    # samples wide — wide-SNR pulses would bridge runs and device-merge
    # the pileup structure away before the coincidence logic ever sees it
    tmpl = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                               tau_f1=60e-6)
    traces = rng.standard_normal((nev, 3, L)) * 1e-9

    def add(ev, ch, p, a):
        traces[ev, ch, p - PRE:p - PRE + NT] += a * tmpl

    for ev in range(nev):
        # pure 3-channel coincidence; chan1 biggest → chan1 primary
        add(ev, 0, 6000, 1.6e-9)
        add(ev, 1, 6020, 1.35e-9)
        add(ev, 2, 6040, 1.3e-9)
        # chan1-only pair outside the window (single channel → kept)
        add(ev, 0, 15000, 1.4e-9)
        add(ev, 0, 17000, 1.35e-9)
        # mixed pileup+coincidence: c1, c2, c1 in one range →
        # greedy unique-channel split; chan2 biggest → chan2 primary
        add(ev, 0, 24000, 1.45e-9)
        add(ev, 1, 24080, 1.9e-9)
        add(ev, 0, 24250, 1.4e-9)
        # 2-channel coincidence chan2/chan3, chan3 primary
        add(ev, 1, 33000, 1.4e-9)
        add(ev, 2, 33030, 1.9e-9)
        # isolated chan3
        add(ev, 2, 45000, 1.5e-9)
    kw = {}
    if int16:
        kw = dict(detector_config={c: {"close_loop_norm": 1.0}
                                   for c in CHANNELS},
                  adc_conversion_factor=2.0 ** -22)
    w = RawWriter(str(root / "raw"), "I1_D20260820_T250000", FS,
                  CHANNELS, data_type="continuous",
                  nb_pretrigger_samples=PRE, **kw)
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    for c in CHANNELS:
        fd.set_template(c, tmpl, FS, pretrigger_length_samples=PRE)
        fd.set_psd(c, np.full(NT, 1e-9 ** 2 / FS), FS)
    return files, fd, tmpl


def _config(tmp_path, mode):
    tcfg = {"run": True, "template_tag": "default",
            "threshold_sigma": 7.0,
            "pileup_window_msec": 0.04}         # 50 samples
    if mode == "edge":
        tcfg["edge_exclusion_msec"] = 3.0
    if mode == "residual":
        tcfg["run_residual"] = True
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump({"trigger": {c: dict(tcfg) for c in CHANNELS}},
                   open(cpath, "w"))
    return cpath


class _Tripwire(trig_pipe.EventBuilder):
    """EventBuilder that fails the test if the per-event path runs."""

    def add_triggers(self, trigger_df):
        raise AssertionError("per-event EventBuilder path engaged — "
                             "FAST_DRAIN did not handle this config")


def _assert_frames_equal(df_fast, df_slow):
    assert len(df_fast) == len(df_slow) > 0
    assert list(df_fast.columns) == list(df_slow.columns)
    pd.testing.assert_frame_equal(df_fast, df_slow, check_exact=True)


@pytest.mark.parametrize("mode", ["plain", "edge", "residual"])
def test_multichannel_coincidence_fast_drain(tmp_path, mode,
                                             monkeypatch):
    rng = np.random.default_rng(47)
    files, fd, _ = _make_raw(tmp_path, rng)
    cpath = _config(tmp_path, mode)
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    assert tp.FAST_DRAIN and len(tp._channels) == 3
    tc = tp._channels[0]
    assert tc.run_residual == (mode == "residual")
    assert (tc.edge_exclusion_msec is not None) == (mode == "edge")

    # fast run with the per-event path boobytrapped: proves engagement
    monkeypatch.setattr(trig_pipe, "EventBuilder", _Tripwire)
    df_fast = tp.process(capacity=64, event_batch=2,
                         coincident_window_msec=0.16)   # 200 samples
    monkeypatch.undo()
    try:
        tp.FAST_DRAIN = False
        df_slow = tp.process(capacity=64, event_batch=2,
                             coincident_window_msec=0.16)
    finally:
        del tp.FAST_DRAIN

    # the data must actually exercise cross-channel merges: merged
    # primary rows carry the other channel's suffixed values
    c1 = df_slow["trigger_channel"] == "chan1"
    assert (df_slow.loc[c1, "trigger_index_chan2"].notna()).any(), \
        "no chan2→chan1 merge happened — data does not cover the case"
    c2 = df_slow["trigger_channel"] == "chan2"
    assert (df_slow.loc[c2, "trigger_index_chan1"].notna()).any(), \
        "no chan1→chan2 merge happened"
    # the chan1-only pair outside the window survives as two rows
    idx1 = df_slow.loc[c1, "trigger_index"].to_numpy()
    assert ((np.abs(idx1 - 15000) < 60).sum() >= 1
            and (np.abs(idx1 - 17000) < 60).sum() >= 1)

    _assert_frames_equal(df_fast, df_slow)


def test_multichannel_salted_fast_drain(tmp_path, monkeypatch):
    """Salted 3-channel run (host injector → float64 path) — the
    coincident salts across channels merge, fast == slow."""
    from detprocess_jax.pipelines.salting import Salting

    rng = np.random.default_rng(53)
    files, fd, tmpl = _make_raw(tmp_path, rng, int16=True)
    cpath = _config(tmp_path, "plain")
    salting = Salting(fd, verbose=False)
    salting.generate_salt(
        files, CHANNELS, energies=[100.0], nsalt=4,
        energy_norm_ev_per_amp=2e6, seed=7,
        min_separation_msec=8.0, edge_exclusion_msec=4.0)
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    tp.set_salting(salting.make_injector(CHANNELS))
    monkeypatch.setattr(trig_pipe, "EventBuilder", _Tripwire)
    df_fast = tp.process(capacity=64, event_batch=2,
                         coincident_window_msec=0.16)
    monkeypatch.undo()
    try:
        tp.FAST_DRAIN = False
        df_slow = tp.process(capacity=64, event_batch=2,
                             coincident_window_msec=0.16)
    finally:
        del tp.FAST_DRAIN
    # coincident salts must produce cross-channel merges
    merged = 0
    for a in CHANNELS:
        rows = df_slow["trigger_channel"] == a
        for b in CHANNELS:
            if a != b:
                merged += int(df_slow.loc[
                    rows, f"trigger_index_{b}"].notna().sum())
    assert merged > 0, "salted run produced no coincidence merges"
    _assert_frames_equal(df_fast, df_slow)


def test_coincidence_window_zero_no_merge(tmp_path):
    """No coincident window configured → multi-channel rows all kept
    (merge disabled), fast == slow."""
    rng = np.random.default_rng(11)
    files, fd, _ = _make_raw(tmp_path, rng, nev=2)
    cpath = _config(tmp_path, "plain")
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    df_fast = tp.process(capacity=64, event_batch=2)
    try:
        tp.FAST_DRAIN = False
        df_slow = tp.process(capacity=64, event_batch=2)
    finally:
        del tp.FAST_DRAIN
    # every channel's rows survive: no merge means chan2's coincident
    # trigger is its own row
    assert (df_slow["trigger_channel"] == "chan2").sum() >= 4
    _assert_frames_equal(df_fast, df_slow)


def test_mixed_template_count_coincidence(tmp_path, monkeypatch):
    """An NxM compound trigger channel (M=2 amplitudes → NO unsuffixed
    'trigger_amplitude' column) coinciding with a 1-template channel
    exercises the drain's mixed-amplitude-slot logic: amplitude columns
    NaN-padded across channels, 'trigger_amplitude' present only for
    the m==1 channel's rows, and suffixed blocks per channel. Fast
    drain == EventBuilder frame-for-frame."""
    rng = np.random.default_rng(61)
    tmpl_a = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                                 tau_f1=60e-6)
    tmpl_b = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                                 tau_f1=150e-6)
    traces = rng.standard_normal((2, 3, L)) * 1e-9
    for ev in range(2):
        for p, a in ((9000, 1.8e-9), (30000, 1.6e-9)):
            traces[ev, 0, p - PRE:p - PRE + NT] += a * tmpl_a
            traces[ev, 1, p - PRE:p - PRE + NT] += 0.8 * a * tmpl_a
            q = p + 30
            traces[ev, 2, q - PRE:q - PRE + NT] += 1.5e-9 * tmpl_a
        traces[ev, 2, 45000 - PRE:45000 - PRE + NT] += 1.5e-9 * tmpl_a
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T250000", FS,
                  CHANNELS, data_type="continuous",
                  nb_pretrigger_samples=PRE)
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    # compound channel: 2 raw channels x 2 templates -> m = 2
    tm = np.stack([np.stack([tmpl_a, tmpl_b]),
                   np.stack([0.8 * tmpl_a, 0.8 * tmpl_b])])  # [C, M, N]
    fd.set_template("chan1|chan2", tm, FS,
                    pretrigger_length_samples=PRE)
    csd = np.zeros((2, 2, NT), complex)
    csd[0, 0] = csd[1, 1] = 1e-9 ** 2 / FS
    fd.set_csd(["chan1", "chan2"], csd, FS)
    fd.set_template("chan3", tmpl_a, FS, pretrigger_length_samples=PRE)
    fd.set_psd("chan3", np.full(NT, 1e-9 ** 2 / FS), FS)
    cfg = {"trigger": {
        "chan1|chan2": {"run": True, "template_tag": "default",
                        "threshold_sigma": 7.0,
                        "pileup_window_msec": 0.04},
        "chan3": {"run": True, "template_tag": "default",
                  "threshold_sigma": 7.0,
                  "pileup_window_msec": 0.04}}}
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump(cfg, open(cpath, "w"))
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    ms = sorted(tc.kernel.iw_matrix.shape[0] for tc in tp._channels)
    assert ms == [1, 2], ms           # mixed amplitude counts engaged
    monkeypatch.setattr(trig_pipe, "EventBuilder", _Tripwire)
    df_fast = tp.process(capacity=64, event_batch=2,
                         coincident_window_samples=200)
    monkeypatch.undo()
    try:
        tp.FAST_DRAIN = False
        df_slow = tp.process(capacity=64, event_batch=2,
                             coincident_window_samples=200)
    finally:
        del tp.FAST_DRAIN
    # cross-channel merges between the compound and plain channel
    merged = (df_slow["trigger_index_chan3"].notna()
              & (df_slow["trigger_channel"] == "chan1|chan2")).sum() \
        + (df_slow["trigger_index_chan1|chan2"].notna()
           & (df_slow["trigger_channel"] == "chan3")).sum()
    assert merged > 0, "no compound<->plain coincidence merges"
    # mixed amplitude-slot columns present as expected
    assert "trigger_amplitude_1" in df_slow.columns
    assert "trigger_amplitude" in df_slow.columns
    c3 = df_slow["trigger_channel"] == "chan3"
    assert df_slow.loc[c3, "trigger_amplitude_1"].isna().all()
    assert df_slow.loc[~c3, "trigger_amplitude"].isna().all()
    _assert_frames_equal(df_fast, df_slow)


def test_fractional_coincident_window_equality(tmp_path):
    """A NON-integer coincident_window_samples must merge identically on
    both drains (the fast path once int()-truncated it: 62 < 62.5 on
    the EventBuilder path vs 62 < 62 on the fast path)."""
    rng = np.random.default_rng(71)
    files, fd, _ = _make_raw(tmp_path, rng, nev=2)
    cpath = _config(tmp_path, "plain")
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    # 6001(c1) → 6019-ish(c2): gaps ~18-21; a window of 20.5 sits ON
    # the truncation boundary for some of the seeded gaps
    df_fast = tp.process(capacity=64, event_batch=2,
                         coincident_window_samples=20.5)
    try:
        tp.FAST_DRAIN = False
        df_slow = tp.process(capacity=64, event_batch=2,
                             coincident_window_samples=20.5)
    finally:
        del tp.FAST_DRAIN
    _assert_frames_equal(df_fast, df_slow)


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_randomized_coincidence_patterns(tmp_path, seed, monkeypatch):
    """Randomized pulse patterns (random channels, positions, amps,
    coincidence partners) — no structural expectations, just exact
    fast==slow frame equality. Stresses merge-range shapes the
    hand-built cases don't cover (chains, triples, near-window gaps,
    device-merged runs feeding the coincidence logic)."""
    rng = np.random.default_rng(seed)
    tmpl = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                               tau_f1=60e-6)
    traces = rng.standard_normal((3, 3, L)) * 1e-9

    def add(ev, ch, p, a):
        p = int(np.clip(p, PRE + 1, L - NT + PRE - 1))
        traces[ev, ch, p - PRE:p - PRE + NT] += a * tmpl

    for ev in range(3):
        for p in rng.integers(3000, L - 3000, size=10):
            ch = int(rng.integers(0, 3))
            add(ev, ch, p, rng.uniform(1.3e-9, 2.2e-9))
            if rng.random() < 0.6:     # coincidence partner nearby
                add(ev, (ch + int(rng.integers(1, 3))) % 3,
                    p + int(rng.integers(-150, 150)),
                    rng.uniform(1.3e-9, 2.2e-9))
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T250000", FS,
                  CHANNELS, data_type="continuous",
                  nb_pretrigger_samples=PRE)
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    for c in CHANNELS:
        fd.set_template(c, tmpl, FS, pretrigger_length_samples=PRE)
        fd.set_psd(c, np.full(NT, 1e-9 ** 2 / FS), FS)
    cpath = _config(tmp_path, "plain")
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    monkeypatch.setattr(trig_pipe, "EventBuilder", _Tripwire)
    df_fast = tp.process(capacity=128, event_batch=2,
                         coincident_window_samples=200)
    monkeypatch.undo()
    try:
        tp.FAST_DRAIN = False
        df_slow = tp.process(capacity=128, event_batch=2,
                             coincident_window_samples=200)
    finally:
        del tp.FAST_DRAIN
    assert len(df_slow) > 0
    _assert_frames_equal(df_fast, df_slow)


def test_coincidence_dumps_and_resume(tmp_path):
    """Multi-channel coincidence + periodic dumps + resume: an
    interrupted run continued with resume=True equals one uninterrupted
    run (minus the per-run prod-id counter) — the merged-row frames
    must survive the dump/resume cycle."""
    import os

    from detprocess_jax.io import tables

    rng = np.random.default_rng(83)
    files, fd, _ = _make_raw(tmp_path, rng, nev=4)
    cpath = _config(tmp_path, "plain")
    out_full = str(tmp_path / "full")
    out_part = str(tmp_path / "part")
    kw = dict(capacity=64, event_batch=1, lgc_save=True,
              nb_events_per_dump=1, coincident_window_samples=200)

    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    full = tp.process(output_path=out_full,
                      series_name="I1_D20260820_T280000", **kw)

    tp2 = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    tp2.process(nevents=2, output_path=out_part,
                series_name="I1_D20260820_T280000", **kw)
    tp3 = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    tp3.process(resume=True, output_path=out_part, **kw)

    def read_all(out):
        fs_ = sorted(f for f in os.listdir(out) if f.endswith(".hdf5"))
        return pd.concat([tables.read_table(os.path.join(out, f))
                          for f in fs_], ignore_index=True)

    a, b = read_all(out_part), read_all(out_full)
    assert len(a) == len(b) > 0
    cols = [c for c in b.columns if c != "trigger_prod_id"]
    sort = ["event_number", "trigger_index"]

    def norm(df):
        df = df[cols].sort_values(sort, kind="stable").reset_index(
            drop=True).astype(object)
        return df.where(pd.notnull(df), None)

    pd.testing.assert_frame_equal(norm(a), norm(b), check_exact=True)
    # merged coincidence rows survived the dump round trip
    assert b["trigger_index_chan2"].notna().any()
