"""ArrayReader (io/rawdata.py): in-memory continuous data read through the
RawReader interface. Pinned against RawReader on the same data written by
RawWriter, through the pipelines, and on an interpreter without h5py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import (ArrayReader, RawReader, RawWriter,
                                       open_reader)
from detprocess_jax.models import pulse

FS = 1.25e6
SERIES = "I1_D20261016_T090000"
CHANS = ["chanA", "chanB"]
NT, PRE, L = 1024, 256, 40000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dumps(seed=0):
    rng = np.random.default_rng(seed)
    tmpl = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    dumps = []
    for d in range(2):
        x = rng.standard_normal((3, 2, L)) * 2e-9
        for ev in range(3):
            for pos in (8000 + 100 * ev, 25000):
                x[ev, 0, pos - PRE:pos - PRE + NT] += 4e-7 * tmpl
                x[ev, 1, pos - PRE:pos - PRE + NT] += 3e-7 * tmpl
        dumps.append(x)
    return dumps, tmpl


def _both(tmp_path, cal):
    dumps, tmpl = _dumps()
    w = RawWriter(str(tmp_path / "raw"), SERIES, FS, CHANS,
                  adc_conversion_factor=cal)
    for d, x in enumerate(dumps, start=1):
        w.write_dump(x, dump_num=d)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    return (RawReader(files),
            ArrayReader(dumps, SERIES, FS, CHANS, adc_conversion_factor=cal),
            tmpl)


@pytest.mark.parametrize("cal", [None, 2e-11])
@pytest.mark.parametrize("mode", ["next", "raw", "window", "subset"])
def test_matches_raw_reader(tmp_path, cal, mode):
    raw, arr, _ = _both(tmp_path, cal)
    assert arr.channels == raw.channels
    assert arr.sample_rate == raw.sample_rate
    assert arr.total_events() == raw.total_events()
    for f_arr, f_raw in zip(arr.files, raw.files):
        for key in ("series_num", "dump_num", "nb_samples", "nb_events"):
            assert arr.get_metadata(f_arr)[key] == \
                raw.get_metadata(f_raw)[key]
    for k in range(raw.total_events()):
        if mode == "next":
            a = arr.read_next_event()
            b = raw.read_next_event()
        elif mode == "raw":
            a = arr.read_next_event(dtype=None, adctoamp=False)
            b = raw.read_next_event(dtype=None, adctoamp=False)
        else:
            fi, ev = divmod(k, 3)
            kw = ({"trace_window": (5000, 2048)} if mode == "window"
                  else {"channels": ["chanB"]})
            a = arr.read_single_event(ev + 1, arr.files[fi], **kw)
            b = raw.read_single_event(ev + 1, raw.files[fi], **kw)
        assert a[0].dtype == b[0].dtype
        np.testing.assert_array_equal(a[0], b[0])
        adm_a = {k: v for k, v in a[1].items() if k != "file_name"}
        adm_b = {k: v for k, v in b[1].items() if k != "file_name"}
        assert adm_a.keys() == adm_b.keys()
        for key in adm_a:
            np.testing.assert_array_equal(adm_a[key], adm_b[key])
    if mode in ("next", "raw"):
        assert arr.read_next_event() == (None, None)


def test_open_reader_passes_readers_through(tmp_path):
    raw, arr, _ = _both(tmp_path, None)
    assert open_reader(arr) is arr
    assert isinstance(open_reader(raw.files), RawReader)


def _config(tmp_path):
    cfg = {"trigger": {c: {"run": True, "template_tag": "default",
                           "threshold_sigma": 8.0,
                           "pileup_window_msec": 0.2} for c in CHANS},
           "feature": {"trace_length_samples": NT,
                       "pretrigger_length_samples": PRE,
                       ",".join(CHANS): {
                           "of1x1_nodelay": {"run": True},
                           "of1x1_unconstrained": {"run": True},
                           "baseline": {"run": True}}}}
    cfg["trigger"]["coincident_window_msec"] = 0.1
    path = str(tmp_path / "c.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _filter(tmpl):
    fd = FilterData(verbose=False)
    for c in CHANS:
        fd.set_template(c, tmpl, FS, pretrigger_length_samples=PRE)
        fd.set_psd(c, np.full(NT, 4e-18 * 1e-3), FS)
    return fd


def test_pipelines_on_arrays_equal_files(tmp_path):
    """TriggerProcessing → FeatureProcessing on an ArrayReader give the
    same tables as on the same data in raw files (int16 codes)."""
    from detprocess_jax.pipelines.features import FeatureProcessing
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    raw, arr, tmpl = _both(tmp_path, 2e-11)
    cfg, fd = _config(tmp_path), _filter(tmpl)
    out = {}
    for name, src in (("files", raw.files), ("arrays", arr)):
        tp = TriggerProcessing(src, cfg, filter_data=fd, verbose=False,
                               auto_prewarm=False)
        tdf = tp.process(capacity=32)
        fp = FeatureProcessing(src, cfg, filter_data=fd,
                               trigger_dataframe=tdf, verbose=False,
                               auto_prewarm=False)
        out[name] = (tdf, fp.process(batch_size=4))
    for a, b in zip(out["arrays"], out["files"]):
        assert len(a) == len(b) > 0
        cols = [c for c in b.columns if "file" not in c]
        for c in cols:
            np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy(),
                                          err_msg=c)


_NO_H5PY = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "h5py" or name.startswith("h5py."):
            raise ModuleNotFoundError("No module named 'h5py'")
sys.meta_path.insert(0, Block())
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from detprocess_jax.io.rawdata import ArrayReader
from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.features import FeatureProcessing
from detprocess_jax.pipelines.triggers import TriggerProcessing
import detprocess_jax.cli
fs, nt, pre, l = 1.25e6, 512, 128, 20000
tmpl = pulse.make_template(fs, nt, pre, A=1.0, tau_r=20e-6, tau_f1=200e-6)
x = np.random.default_rng(1).standard_normal((2, 1, l)) * 2e-9
x[:, 0, 9000 - pre:9000 - pre + nt] += 2e-8 * tmpl
arr = ArrayReader([x], "I1_D20261016_T090000", fs, ["c1"])
fd = FilterData(verbose=False)
fd.set_template("c1", tmpl, fs, pretrigger_length_samples=pre)
fd.set_psd("c1", np.full(nt, (2e-9) ** 2 / fs), fs)
cfg = sys.argv[1]
tdf = TriggerProcessing(arr, cfg, filter_data=fd, verbose=False,
                        auto_prewarm=False).process()
df = FeatureProcessing(arr, cfg, filter_data=fd, trigger_dataframe=tdf,
                       verbose=False, auto_prewarm=False).process(batch_size=2)
assert "h5py" not in sys.modules
print("rows", len(tdf), len(df))
"""


def test_device_path_runs_without_h5py(tmp_path):
    cfg = {"trigger": {"c1": {"run": True, "template_tag": "default",
                              "threshold_sigma": 8.0,
                              "pileup_window_msec": 1.0}},
           "feature": {"trace_length_samples": 512,
                       "pretrigger_length_samples": 128,
                       "c1": {"of1x1_nodelay": {"run": True}}}}
    path = str(tmp_path / "c.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _NO_H5PY, path], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    # one pulse per event, two events; features on every trigger
    assert "rows 2 2" in r.stdout, r.stdout
