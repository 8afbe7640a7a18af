"""Pipeline-level SPMD: TriggerProcessing / FeatureProcessing with
``mesh=`` produce the same tables as the single-device path.

The mesh shards each dispatch's event batch over the devices
(parallel/mesh.py EVENTS_AXIS) — the user-facing replacement for the
reference's Pool-over-series (detprocess/process/triggers.py nb_cores
fan-out), running inside ONE pipeline instance. Tested on the virtual
8-device CPU mesh (tests/conftest.py), including batch sizes that do
NOT divide the device count (padding path).
"""

import numpy as np
import pandas as pd
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.parallel import mesh as pmesh
from detprocess_jax.pipelines.features import FeatureProcessing
from detprocess_jax.pipelines.triggers import TriggerProcessing

FS = 1.25e6
NT = 1024
PRETRIG = 256
L = 60000
NEV = 6          # deliberately not a multiple of 8 devices


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshpipe")
    rng = np.random.default_rng(11)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    sigma = np.sqrt(psd[0] * FS)

    traces = rng.standard_normal((NEV, 1, L)) * sigma
    for ev in range(NEV):
        for pos in (15000, 30000, 45000):
            start = pos + 37 * ev - PRETRIG
            traces[ev, 0, start:start + NT] += (18e-6 + 2e-6 * ev) * tmpl

    raw_dir = root / "raw"
    writer = RawWriter(str(raw_dir), "I1_D20260818_T090000", FS, ["chan1"],
                       data_type="continuous")
    writer.write_dump(traces, dump_num=1)

    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", psd, FS)

    tcfg = {"trigger": {"chan1": {"run": True, "template_tag": "default",
                                  "threshold_sigma": 8.0,
                                  "pileup_window_msec": 0.2}}}
    tpath = str(root / "trig.yaml")
    yaml.safe_dump(tcfg, open(tpath, "w"))

    fcfg = {"feature": {
        "trace_length_samples": NT,
        "pretrigger_length_samples": PRETRIG,
        "chan1": {
            "of1x1_nodelay": {"run": True, "template_tag": "default"},
            "of1x1_unconstrained": {"run": True,
                                    "template_tag": "default"},
            "baseline": {"run": True},
        }}}
    fpath = str(root / "feat.yaml")
    yaml.safe_dump(fcfg, open(fpath, "w"))

    raw_files = sorted(str(p) for p in raw_dir.glob("*.hdf5"))
    return dict(raw_files=raw_files, tpath=tpath, fpath=fpath, fd=fd)


def test_trigger_pipeline_mesh_equals_single(dataset):
    mesh = pmesh.make_mesh(8)
    proc = TriggerProcessing(dataset["raw_files"], dataset["tpath"],
                             filter_data=dataset["fd"], verbose=False)
    # event_batch=4 with 6 events: one full batch + one padded batch
    df_single = proc.process(capacity=64, event_batch=4)
    df_mesh = proc.process(capacity=64, event_batch=4, mesh=mesh)
    assert len(df_mesh) == len(df_single) > 0
    pd.testing.assert_frame_equal(
        df_mesh.reset_index(drop=True), df_single.reset_index(drop=True))


def test_feature_pipeline_mesh_equals_single(dataset):
    mesh = pmesh.make_mesh(8)
    tp = TriggerProcessing(dataset["raw_files"], dataset["tpath"],
                           filter_data=dataset["fd"], verbose=False)
    trig_df = tp.process(capacity=64)
    assert len(trig_df) > 0

    fp = FeatureProcessing(dataset["raw_files"], dataset["fpath"],
                           filter_data=dataset["fd"],
                           trigger_dataframe=trig_df, verbose=False)
    # batch_size=7 never divides 8: every batch takes the padding path
    df_single = fp.process(batch_size=7, dtype=np.float64)
    df_mesh = fp.process(batch_size=7, dtype=np.float64, mesh=mesh)
    assert len(df_mesh) == len(df_single) > 0
    assert list(df_mesh.columns) == list(df_single.columns)
    for col in df_single.columns:
        a, b = df_single[col].to_numpy(), df_mesh[col].to_numpy()
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0,
                                       err_msg=col)
        else:
            assert (a == b).all(), col


def test_cli_mesh_devices_chain(dataset, tmp_path):
    """--mesh-devices routes the CLI trigger+feature chain through the
    sharded pipeline path (virtual 8-device CPU mesh)."""
    import os
    from detprocess_jax import cli
    from detprocess_jax.io import tables

    raw_dir = os.path.dirname(dataset["raw_files"][0])
    fpath = str(tmp_path / "filter.h5")
    dataset["fd"].save_hdf5(fpath)
    # one YAML with trigger + feature sections (the CLI takes one setup)
    import yaml as _yaml
    cfg = {}
    cfg.update(_yaml.safe_load(open(dataset["tpath"])))
    cfg.update(_yaml.safe_load(open(dataset["fpath"])))
    cpath = str(tmp_path / "setup.yaml")
    _yaml.safe_dump(cfg, open(cpath, "w"))

    out = str(tmp_path / "processed")
    rc = cli.main([
        "--raw_path", raw_dir,
        "--processing_setup", cpath,
        "--filter_file", fpath,
        "--output_group_path", out,
        "--enable-trig", "--enable-feature",
        "--mesh-devices", "8", "--quiet",
    ])
    assert rc == 0
    feat_files = [f for f in os.listdir(os.path.join(out, "feature"))
                  if f.endswith(".hdf5")]
    assert feat_files
    feat = tables.read_table(os.path.join(out, "feature", feat_files[0]))
    assert len(feat) == 3 * NEV
    amps = feat["amp_of1x1_nodelay_chan1"].to_numpy()
    assert np.all((amps > 15e-6) & (amps < 32e-6))


def test_noise_mesh_equals_single(dataset):
    """Noise.calc_psd/calc_csd with mesh= (psum spectral mean over the
    virtual 8-device mesh, zero-padded batch) equal the single-device
    estimates."""
    from detprocess_jax.pipelines.noise import Noise

    mesh = pmesh.make_mesh(8)

    def build(mesh_arg):
        noise = Noise(dataset["raw_files"], verbose=False)
        noise.generate_randoms(random_rate=300.0, seed=4,
                               min_separation_msec=1.0,
                               edge_exclusion_msec=1.0)
        noise.calc_psd("chan1", trace_length_samples=NT,
                       pretrigger_length_samples=NT // 2,
                       dtype=np.float64, mesh=mesh_arg)
        noise.calc_csd(["chan1"], trace_length_samples=NT,
                       pretrigger_length_samples=NT // 2,
                       dtype=np.float64, mesh=mesh_arg)
        psd, _ = noise.get_psd("chan1")
        csd, _ = noise.get_csd("chan1")
        return psd, csd

    psd_s, csd_s = build(None)
    psd_m, csd_m = build(mesh)
    np.testing.assert_allclose(psd_m, psd_s, rtol=1e-9)
    np.testing.assert_allclose(csd_m, csd_s, rtol=1e-9)


def test_trigger_mesh_residual_mode(dataset):
    """mesh= composes with the residual re-trigger mode: the channel fn
    then returns a (primary, residual) TriggerSet pair through the
    shard_map, both event-sharded."""
    import yaml as _yaml
    mesh = pmesh.make_mesh(8)
    cfg = _yaml.safe_load(open(dataset["tpath"]))
    cfg["trigger"]["chan1"]["run_residual"] = True
    import tempfile, os
    tpath = os.path.join(tempfile.mkdtemp(), "trig_resid.yaml")
    _yaml.safe_dump(cfg, open(tpath, "w"))

    proc = TriggerProcessing(dataset["raw_files"], tpath,
                             filter_data=dataset["fd"], verbose=False)
    df_single = proc.process(capacity=64, event_batch=4)
    df_mesh = proc.process(capacity=64, event_batch=4, mesh=mesh)
    assert len(df_mesh) == len(df_single) > 0
    pd.testing.assert_frame_equal(
        df_mesh.reset_index(drop=True), df_single.reset_index(drop=True))
