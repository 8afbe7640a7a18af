"""Two-process multi-node e2e: scripts/process_distributed.py in-suite.

Round-4 VERDICT item 6: the distributed driver was exercised only via
its series-split helpers. Here TWO spawned processes each take a
disjoint series slice (node_num 0/1 of 2), run the full CLI
trigger→feature chain into the SAME output group concurrently, and the
union of their dumps must equal the single-process run frame-for-frame
(modulo the per-run trigger_prod_id counter, which is asserted
sequential per node instead). Output series names must be node-unique
(reference features.py:502-504 node-offset convention) — concurrent
nodes launched the same second previously collided.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

from detprocess_jax import cli
from detprocess_jax.io import tables
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse

FS = 1.25e6
NT, PRE = 512, 128
L = 60_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "process_distributed.py")

WRAPPER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")   # plugin overrides the env var
sys.path.insert(0, sys.argv[1])
import importlib.util
spec = importlib.util.spec_from_file_location("process_distributed",
                                              sys.argv[2])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
sys.exit(mod.main(sys.argv[3:]))
"""


@pytest.fixture()
def setup(tmp_path):
    raw = tmp_path / "raw"
    rng = np.random.default_rng(29)
    tmpl = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                               tau_f1=60e-6)
    series_names = ["I1_D20260816_T230000", "I1_D20260816_T234500"]
    for k, sname in enumerate(series_names):
        traces = rng.standard_normal((2, 1, L)) * 1e-9
        for ev in range(2):
            for p in (9000 + 4000 * k, 30000, 48000):
                traces[ev, 0, p - PRE:p - PRE + NT] += 2.0e-9 * tmpl
        w = RawWriter(str(raw), sname, FS, ["chan1"], prefix="cont",
                      nb_pretrigger_samples=PRE)
        w.write_dump(traces, dump_num=1)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRE)
    fd.set_psd("chan1", np.full(NT, 1e-9 ** 2 / FS), FS)
    fpath = str(tmp_path / "filter.h5")
    fd.save_hdf5(fpath)
    config = {
        "filter_file": fpath,
        "trigger": {"chan1": {"run": True, "template_tag": "default",
                              "threshold_sigma": 7.0,
                              "pileup_window_msec": 0.1}},
        "feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRE,
            "chan1": {"of1x1_nodelay": {"run": True,
                                        "template_tag": "default"},
                      "baseline": {"run": True}}},
    }
    cpath = str(tmp_path / "process.yaml")
    yaml.safe_dump(config, open(cpath, "w"))
    return dict(raw=str(raw), cpath=cpath, fpath=fpath,
                series=series_names)


def _read_dumps(out, group):
    path = os.path.join(out, group)
    files = sorted(f for f in os.listdir(path) if f.endswith(".hdf5"))
    frames = [tables.read_table(os.path.join(path, f)) for f in files]
    return files, frames


def _norm(df, drop=("trigger_prod_id",)):
    df = df.drop(columns=[c for c in drop if c in df.columns])
    sort_cols = [c for c in ("series_number", "event_number",
                             "trigger_index") if c in df.columns]
    return (df.sort_values(sort_cols, kind="stable")
            .reset_index(drop=True))


def test_two_process_distributed_equals_single(setup, tmp_path):
    out_dist = str(tmp_path / "dist")
    out_single = str(tmp_path / "single")

    common = ["--raw_path", setup["raw"],
              "--processing_setup", setup["cpath"],
              "--filter_file", setup["fpath"],
              "--enable-trig", "--enable-feature", "--quiet"]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # one shared base series for the job, like the SLURM launcher —
    # per-node clocks would make node uniqueness depend on launch skew
    env["DETPROC_BASE_SERIES"] = "I1_D20260820_T270000"
    procs = []
    for node in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WRAPPER, REPO, SCRIPT,
             *common, "--output_group_path", out_dist,
             "--node_num", str(node), "--nb_nodes", "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]

    rc = cli.main(common + ["--output_group_path", out_single])
    assert rc == 0

    # ---- node-unique output naming ---------------------------------
    dist_files, dist_trig = _read_dumps(out_dist, "trigger")
    assert len(dist_files) == 2, dist_files
    out_series = {"I" + f.rsplit("_F", 1)[0].rsplit("_I", 1)[-1]
                  for f in dist_files}
    # base from DETPROC_BASE_SERIES + node_num offsets — exact, not
    # merely distinct (clock-derived bases collide under launch skew)
    assert out_series == {"I1_D20260820_T270000",
                          "I1_D20260820_T270001"}, \
        f"unexpected output series: {dist_files}"

    # ---- union of trigger dumps == single run ----------------------
    _, single_trig = _read_dumps(out_single, "trigger")
    dist_df = _norm(pd.concat(dist_trig, ignore_index=True))
    single_df = _norm(pd.concat(single_trig, ignore_index=True))
    assert len(dist_df) == len(single_df) > 0
    assert sorted(dist_df.columns) == sorted(single_df.columns)
    pd.testing.assert_frame_equal(
        dist_df[sorted(dist_df.columns)],
        single_df[sorted(single_df.columns)], check_exact=True)
    # prod ids are per-run counters: sequential from 1 within each node
    for df in dist_trig:
        ids = df["trigger_prod_id"].to_numpy()
        np.testing.assert_array_equal(ids, np.arange(1, len(ids) + 1))

    # ---- union of feature dumps == single run ----------------------
    _, dist_feat = _read_dumps(out_dist, "feature")
    _, single_feat = _read_dumps(out_single, "feature")
    dist_f = _norm(pd.concat(dist_feat, ignore_index=True))
    single_f = _norm(pd.concat(single_feat, ignore_index=True))
    assert len(dist_f) == len(single_f) > 0
    pd.testing.assert_frame_equal(
        dist_f[sorted(dist_f.columns)],
        single_f[sorted(single_f.columns)], check_exact=True)
