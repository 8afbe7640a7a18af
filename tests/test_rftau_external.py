"""Tests for the batched rftau pulse fit and external plug-in extractors."""

import numpy as np
import jax.numpy as jnp
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.ops import pulsefit
from detprocess_jax.pipelines.features import FeatureProcessing

FS = 1.25e6
N = 4096
PRETRIG = 2048


def test_rftau_kernel_recovers_taus():
    rng = np.random.default_rng(0)
    rtau_true, ftau_true = 25.0, 250.0  # samples
    t = np.arange(N, dtype=float)
    t0 = PRETRIG - 10
    tp = t - t0
    tmpl = np.where(tp > 0,
                    np.exp(-tp / ftau_true) - np.exp(-tp / rtau_true), 0.0)
    amps = rng.uniform(1.0, 3.0, 8)
    traces = amps[:, None] * tmpl[None, :] + rng.standard_normal(
        (8, N)) * 1e-3
    res = pulsefit.rftau(jnp.asarray(traces), FS, rc_cutoff=FS / 2.1)
    # RC filter off (cutoff ~ Nyquist) → taus recovered tightly
    np.testing.assert_allclose(np.asarray(res.risetime),
                               np.full(8, rtau_true), rtol=0.1)
    np.testing.assert_allclose(np.asarray(res.falltime),
                               np.full(8, ftau_true), rtol=0.1)
    peak = np.max(amps[:, None] * tmpl[None, :], axis=-1)
    np.testing.assert_allclose(np.asarray(res.amplitude), peak, rtol=0.1)


@pytest.fixture(scope="module")
def pipeline_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ext")
    rng = np.random.default_rng(1)
    tmpl = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    traces = (2e-6 * tmpl[None, None, :]
              + rng.standard_normal((8, 1, N)) * 1e-9)
    w = RawWriter(str(root / "raw"), "I1_D20260816_T220000", FS, ["chan1"])
    w.write_dump(traces, dump_num=1)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", np.full(N, 1e-20), FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)

    ext_path = root / "my_extractors.py"
    ext_path.write_text(
        "import jax.numpy as jnp\n"
        "def rms(traces, fs=None, nb_pretrigger_samples=None, **kw):\n"
        "    return {'rms': jnp.sqrt(jnp.mean(traces**2, axis=-1))}\n"
        "EXTRACTORS = {'rms': rms}\n")

    config = {"chan1": {
        "rftau": {"run": True},
        "rms": {"run": True},
        "baseline": {"run": True},
    }}
    cpath = str(root / "cfg.yaml")
    yaml.safe_dump(config, open(cpath, "w"))
    raw_files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    return dict(raw_files=raw_files, cpath=cpath, fpath=fpath,
                ext_path=str(ext_path), traces=traces)


def test_pipeline_with_rftau_and_external(pipeline_data):
    proc = FeatureProcessing(pipeline_data["raw_files"],
                             pipeline_data["cpath"],
                             filter_data=pipeline_data["fpath"],
                             external_file=pipeline_data["ext_path"],
                             verbose=False)
    df = proc.process(batch_size=8, dtype=np.float64)
    assert "risetime_rftau_chan1" in df.columns
    assert "falltime_rftau_chan1" in df.columns
    assert "amplitud_rftau_chan1" in df.columns
    assert "rms_chan1" in df.columns
    # external feature matches direct computation
    expected_rms = np.sqrt(np.mean(pipeline_data["traces"][:, 0] ** 2,
                                   axis=-1))
    np.testing.assert_allclose(df["rms_chan1"], expected_rms, rtol=1e-6)
    # rftau fall time ≈ 200 µs = 250 samples
    assert np.all(np.abs(df["falltime_rftau_chan1"] - 250) < 50)


def test_duplicate_external_rejected(pipeline_data, tmp_path):
    bad = tmp_path / "bad_ext.py"
    bad.write_text("def baseline(traces, **kw):\n    return {}\n"
                   "EXTRACTORS = {'baseline': baseline}\n")
    with pytest.raises(ValueError, match="duplicate"):
        FeatureProcessing(pipeline_data["raw_files"],
                          pipeline_data["cpath"],
                          filter_data=pipeline_data["fpath"],
                          external_file=str(bad), verbose=False)
