"""Tests for the CLI driver and the filter-generation pipeline."""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from detprocess_jax import cli
from detprocess_jax.io import tables
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.filtergen import FilterDataProcessing

FS = 1.25e6
NT = 2048
PRETRIG = 512
L = 100000


@pytest.fixture(scope="module")
def rawgroup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cligroup")
    raw = root / "raw"
    rng = np.random.default_rng(31)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((3, 1, L)) * sigma
    for ev, pos in enumerate([30000, 60000, 45000]):
        traces[ev, 0, pos - PRETRIG:pos - PRETRIG + NT] += 40e-6 * tmpl
    w = RawWriter(str(raw), "I1_D20260816_T230000", FS, ["chan1"],
                  prefix="cont")
    w.write_dump(traces, dump_num=1)

    # filter file (pre-made for trigger/feature chain)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", np.full(NT, sigma**2 / FS), FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)

    config = {
        "filter_file": fpath,
        "trigger": {"chan1": {"run": True, "template_tag": "default",
                              "threshold_sigma": 8.0,
                              "pileup_window_msec": 0.5}},
        "feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            "chan1": {"of1x1_nodelay": {"run": True,
                                        "template_tag": "default"},
                      "baseline": {"run": True}},
        },
        "noise": {},
        "template": {"chan1": {"run": True,
                               "trace_length_samples": NT,
                               "pretrigger_length_samples": PRETRIG,
                               "tau_r": 20e-6, "tau_f1": 200e-6}},
    }
    cpath = str(root / "process.yaml")
    yaml.safe_dump(config, open(cpath, "w"))
    return dict(root=root, raw=str(raw), cpath=cpath, fpath=fpath)


def test_cli_trigger_feature_chain(rawgroup, tmp_path):
    out = str(tmp_path / "processed")
    rc = cli.main([
        "--raw_path", rawgroup["raw"],
        "--processing_setup", rawgroup["cpath"],
        "--filter_file", rawgroup["fpath"],
        "--output_group_path", out,
        "--enable-trig", "--enable-feature",
    ])
    assert rc == 0
    trig_files = [f for f in os.listdir(os.path.join(out, "trigger"))
                  if f.endswith(".hdf5")]
    feat_files = [f for f in os.listdir(os.path.join(out, "feature"))
                  if f.endswith(".hdf5")]
    assert len(trig_files) == 1 and trig_files[0].startswith("threshtrig_")
    assert len(feat_files) >= 1 and feat_files[0].startswith("feature_")
    feat = tables.read_table(os.path.join(out, "feature", feat_files[0]))
    assert len(feat) == 3
    np.testing.assert_allclose(feat["amp_of1x1_nodelay_chan1"],
                               np.full(3, 40e-6), rtol=0.05)


def test_cli_randoms(rawgroup, tmp_path):
    out = str(tmp_path / "processed2")
    rc = cli.main([
        "--raw_path", rawgroup["raw"],
        "--output_group_path", out,
        "--enable-rand", "--nrandoms", "12", "--seed", "5",
    ])
    assert rc == 0
    rand_files = [f for f in os.listdir(os.path.join(out, "randoms"))
                  if f.endswith(".hdf5")]
    assert len(rand_files) == 1 and rand_files[0].startswith("rand_")
    df = tables.read_table(os.path.join(out, "randoms", rand_files[0]))
    assert len(df) == 12


def test_cli_missing_raw(tmp_path):
    rc = cli.main(["--raw_path", str(tmp_path / "nothing")])
    assert rc == 1


def test_filtergen_pipeline(rawgroup, tmp_path):
    proc = FilterDataProcessing(raw_path=rawgroup["raw"],
                                config=rawgroup["cpath"], verbose=False)
    fd = proc.process(nrandoms=30, seed=7, lgc_save=True,
                      output_path=str(tmp_path / "fd"))
    # PSD estimated and template created
    psd, freqs = fd.get_psd("chan1")
    assert psd.shape[-1] == L  # full-trace randoms geometry
    tmpl, _ = fd.get_template("chan1")
    assert tmpl.shape == (NT,)
    files = os.listdir(tmp_path / "fd")
    assert len(files) == 1 and files[0].startswith("filter_")


def test_filtergen_by_series(tmp_path):
    """lgc_by_series stores per-series PSDs tagged by series name
    (filterprocess.py:1050-1302 by-series branch)."""
    raw = tmp_path / "raw2"
    rng = np.random.default_rng(5)
    series_names = ["I1_D20260816_T231000", "I1_D20260816_T231500"]
    for k, sname in enumerate(series_names):
        traces = rng.standard_normal((2, 1, L)) * (2e-6 * (1 + k))
        w = RawWriter(str(raw), sname, FS, ["chan1"], prefix="cont")
        w.write_dump(traces, dump_num=1)
    cfg = {"noise": {"trace_length_samples": 2048,
                     "pretrigger_length_samples": 1024}}
    cpath = str(tmp_path / "c.yaml")
    yaml.safe_dump(cfg, open(cpath, "w"))
    proc = FilterDataProcessing(raw_path=str(raw), config=cpath,
                                verbose=False)
    fd = proc.process(nrandoms=20, seed=3, lgc_by_series=True,
                      enable_template=False, enable_didv=False)
    psd_all, _ = fd.get_psd("chan1")                 # global
    psd_s0, _ = fd.get_psd("chan1", tag=series_names[0])
    psd_s1, _ = fd.get_psd("chan1", tag=series_names[1])
    # second series has 2x the noise sigma → ~4x the PSD
    ratio = np.median(psd_s1[1:] / psd_s0[1:])
    assert 2.5 < ratio < 6.0, ratio


def test_cli_prewarm_compiles_without_saving(rawgroup, tmp_path):
    """--prewarm runs the enabled workloads through a few events to
    populate the persistent executable cache but writes NO output
    dumps (the production cold-start story: run once after a config
    change, then real runs start warm)."""
    # a fresh process: JAX sets its persistent cache up once per process,
    # so after earlier tests in this worker have compiled, pointing the
    # cache somewhere new in-process would write nothing
    cachedir = str(tmp_path / "xla")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cachedir,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    out = str(tmp_path / "processed")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([
        sys.executable, "-m", "detprocess_jax.cli",
        "--raw_path", rawgroup["raw"],
        "--processing_setup", rawgroup["cpath"],
        "--filter_file", rawgroup["fpath"],
        "--output_group_path", out,
        "--enable-trig", "--enable-feature", "--prewarm",
    ], cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    rc = r.returncode
    assert rc == 0, r.stderr[-2000:]
    for sub in ("trigger", "feature"):
        d = os.path.join(out, sub)
        dumps = [f for f in os.listdir(d)] if os.path.isdir(d) else []
        dumps = [f for f in dumps if not f.endswith("_summary.json")]
        assert not dumps, f"--prewarm wrote output dumps: {dumps}"
    # the executable cache holds compiled kernels for the real shapes
    entries = []
    for root, _dirs, files in os.walk(cachedir):
        entries.extend(files)
    assert entries, "prewarm populated no cache entries"


def test_cli_prewarm_skips_host_workloads(rawgroup, tmp_path,
                                          monkeypatch, capsys):
    """--prewarm disables salting/randoms/ivsweep/filter-gen (they have
    nothing to compile and would write real outputs) with a notice."""
    out = str(tmp_path / "processed")
    rc = cli.main([
        "--raw_path", rawgroup["raw"],
        "--processing_setup", rawgroup["cpath"],
        "--filter_file", rawgroup["fpath"],
        "--output_group_path", out,
        "--enable-rand", "--enable-trig", "--prewarm",
        "--random_rate", "10",
    ])
    assert rc == 0
    assert "prewarm skips --enable-rand" in capsys.readouterr().out
    assert not os.path.isdir(os.path.join(out, "randoms"))
    assert not os.path.isdir(os.path.join(out, "rand"))
