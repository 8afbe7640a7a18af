"""The helpers of chip_smoke.py: the result line, the phase runner, the
reference comparison, the trigger-timing check, and the refusal to run
without a GPU. The GPU run itself happens on a machine with a card."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def test_contract_line_gpu():
    line = cs.contract_line({"platform": "gpu", "kind": "NVIDIA H100 80GB",
                             "count": 1})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB", "count": 1}}


def test_contract_line_refuses_cpu():
    with pytest.raises(ValueError):
        cs.contract_line({"platform": "cpu", "kind": "cpu", "count": 1})


def _py(code):
    return [sys.executable, "-c", code]


@pytest.mark.parametrize("rcs,failed", [
    ((0, 0, 0), None),
    ((0, 3, 0), "p1"),
    ((5, 0, 0), "p0"),
])
def test_run_phases_stops_at_first_failure(tmp_path, rcs, failed):
    marks = [tmp_path / f"ran{i}" for i in range(len(rcs))]
    phases = [(f"p{i}", _py(f"open({str(m)!r}, 'w'); "
                            f"raise SystemExit({rc})"))
              for i, (m, rc) in enumerate(zip(marks, rcs))]
    assert cs.run_phases(phases, timeout=60) == failed
    stop = len(rcs) if failed is None else int(failed[1:]) + 1
    assert [m.exists() for m in marks] == [i < stop
                                           for i in range(len(rcs))]


def test_run_phases_times_out(tmp_path):
    phases = [("slow", _py("import time; time.sleep(30)"))]
    assert cs.run_phases(phases, timeout=1) == "slow"


@pytest.mark.parametrize("col,have,want,ok", [
    ("amp_x", 1.00005, 1.0, True),
    ("amp_x", 1.0002, 1.0, False),
    ("chi2_x", 30000.0 + 2.0, 30000.0, True),      # 1e-5·χ²₀ = 10
    ("chi2_x", 30000.0 + 20.0, 30000.0, False),
    ("t0_x", 1.0 / cs.FS, 0.0, True),
    ("t0_x", 2.0 / cs.FS, 0.0, False),
    ("baseline_x", 1e-6 + 5e-12, 1e-6, True),      # scale 1e-6
    ("baseline_x", 1e-6 + 5e-11, 1e-6, False),
])
def test_compare_rows(col, have, want, ok):
    bad = cs.compare_rows({col: have}, {col: want}, scale=1e-6,
                          chi2_0=1e6)
    assert (not bad) == ok, bad


def test_check_triggers_within_one_sample():
    truth = np.array([[0, 1000, 1e-6], [1, 2000, 1e-6], [6, 500, 1e-6]])
    df = pd.DataFrame({"dump_number": [1, 1, 2],
                       "event_number": [1, 2, 1],
                       "trigger_index": [1001, 1999, 500]})
    assert cs.check_triggers(df, truth) == []
    df.loc[2, "trigger_index"] = 502
    bad = cs.check_triggers(df, truth)
    assert len(bad) == 1 and "event 6" in bad[0]


def test_feature_config_has_upstream_windows():
    feat = cs.feature_config()["feature"]
    assert feat["trace_length_samples"] == 32768
    assert feat["pretrigger_length_samples"] == 16384
    algs = feat[",".join(cs.CHANNELS)]
    assert set(algs) == {"of1x1_nodelay", "of1x1_unconstrained",
                         "of1x1_constrained", "baseline", "integral"}
    con = algs["of1x1_constrained"]
    assert (con["window_min_from_trig_usec"],
            con["window_max_from_trig_usec"]) == (-40.0, 40.0)


def test_no_gpu_exits_nonzero_without_result():
    env = dict(os.environ, PATH="/nonexistent")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_env_phase_fails_on_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                        "--phase", "env", "--workdir", str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not (tmp_path / "device.json").exists()


def test_small_chain_matches_reference(tmp_path, monkeypatch):
    """The synthesize → CLI chain → compare phases end to end at a small
    size on the CPU (the card runs the same code at full size)."""
    for name, val in (("NT", 2048), ("PRETRIG", 1024), ("EVENT_LEN", 200_000),
                      ("N_EVENTS", 2), ("SPACING", 3 * 2048),
                      ("FEATURE_BATCH", 16), ("N_COMPARE", 8)):
        monkeypatch.setattr(cs, name, val)
    cs.synthesize(str(tmp_path), 3, n_events=2, event_len=200_000)
    a = argparse.Namespace(workdir=str(tmp_path), seed=3, tag="warm")
    cs.phase_pipeline(a)
    cs.phase_compare(a)


def test_frame_diffs_mesh_rules():
    d1 = pd.DataFrame({"trigger_index": [10, 20],
                       "trigger_channel": ["a", None],
                       "amp_x": [1.0, 2.0], "t0_x": [0.0, 1e-6],
                       "chi2_x": [np.nan, 3.0]})
    assert cs.frame_diffs(d1, d1.copy())[0] == []
    d4 = d1.copy()
    d4["amp_x"] = [1.0, 2.0 + 1e-5]             # 5e-6 of scale: ok
    d4["t0_x"] = [1.0 / cs.FS, 1e-6]            # one sample: ok
    bad, worst = cs.frame_diffs(d1, d4)
    assert bad == [] and worst[0] == "amp_x"
    d4["trigger_index"] = [10, 21]              # a merge decision moved
    d4["amp_x"] = [1.0, 2.01]
    bad, _ = cs.frame_diffs(d1, d4)
    assert len(bad) == 2
