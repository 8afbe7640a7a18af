"""Persistent XLA compilation cache (utils/jaxcache.py).

Pins the directory rule — ``JAX_COMPILATION_CACHE_DIR`` when set, else a
fixed path in the checkout, off by default on the CPU backend — and
proves that executables written by one process are HIT (not recompiled)
by the next.
"""

import os
import subprocess
import sys

import jax
import pytest

from detprocess_jax.utils import jaxcache


@pytest.fixture(autouse=True)
def _restore_config(monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("env,platform,expected", [
    (None, "cpu", None),
    (None, "gpu", "DEFAULT"),
    ("/data/xla", "cpu", "/data/xla"),
    ("/data/xla", "gpu", "/data/xla"),
])
def test_cache_dir_rule(monkeypatch, env, platform, expected):
    if env is not None:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    want = jaxcache.DEFAULT_DIR if expected == "DEFAULT" else expected
    assert jaxcache.cache_dir(platform) == want


def test_default_dir_is_fixed_in_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")


def test_env_dir_sets_nothing_else(monkeypatch, tmp_path):
    """With the env var set JAX reads it itself; enable() only reports
    it and leaves jax.config alone."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert jaxcache.enable() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_cpu_default_is_off():
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache._platform() == "cpu"
    assert jaxcache.enable() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_accelerator_default_sets_fixed_dir(monkeypatch, tmp_path):
    fixed = str(tmp_path / "fixed")
    monkeypatch.setattr(jaxcache, "DEFAULT_DIR", fixed)
    monkeypatch.setattr(jaxcache, "_platform", lambda: "gpu")
    assert jaxcache.enable() == fixed
    assert jax.config.jax_compilation_cache_dir == fixed
    assert os.path.isdir(fixed)
    assert jaxcache.enable() == fixed             # idempotent


def test_enable_thread_safe(monkeypatch, tmp_path):
    """Concurrent enable() calls agree (auto-prewarm threads and the
    caller's thread may construct pipelines at once)."""
    import threading

    fixed = str(tmp_path / "fixed")
    monkeypatch.setattr(jaxcache, "DEFAULT_DIR", fixed)
    monkeypatch.setattr(jaxcache, "_platform", lambda: "gpu")
    results = []

    def worker():
        results.append(jaxcache.enable())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert results == [fixed] * 8


def test_pipeline_constructor_enables(tmp_path, monkeypatch):
    """TriggerProcessing.__init__ turns the cache on (the user-facing
    path: construct a pipeline, get cached cold starts)."""
    import numpy as np
    import yaml

    from detprocess_jax.io.filterfile import FilterData
    from detprocess_jax.io.rawdata import RawWriter
    from detprocess_jax.models import pulse
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    fixed = str(tmp_path / "fixed")
    monkeypatch.setattr(jaxcache, "DEFAULT_DIR", fixed)
    monkeypatch.setattr(jaxcache, "_platform", lambda: "gpu")
    fs, nt, pre = 1.25e6, 256, 64
    tmpl = pulse.make_template(fs, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T110000", fs,
                  ["chan1"], data_type="continuous")
    w.write_dump(np.zeros((1, 1, 4096)), dump_num=1)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, fs, pretrigger_length_samples=pre)
    fd.set_psd("chan1", np.full(nt, 1e-18), fs)
    cfg = {"trigger": {"chan1": {"run": True, "template_tag": "default",
                                 "threshold_sigma": 8.0}}}
    cpath = str(tmp_path / "t.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(cfg, f)
    TriggerProcessing(sorted(str(p) for p in
                             (tmp_path / "raw").glob("*.hdf5")),
                      cpath, filter_data=fd, verbose=False,
                      auto_prewarm=False)
    assert jax.config.jax_compilation_cache_dir == fixed


_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
from detprocess_jax.utils import jaxcache
import os
assert jaxcache.enable() == os.environ["JAX_COMPILATION_CACHE_DIR"]
import jax.numpy as jnp, numpy as np
@jax.jit
def f(x):
    return jnp.tanh(x @ x.T).sum()
print(float(np.asarray(f(jnp.ones((64, 64), jnp.float32)))))
"""


def test_cross_process_cache_hit(tmp_path):
    """Process 1 compiles and writes entries; process 2 compiling the
    same function adds NO new entries (= persistent-cache hit, not a
    recompile — a miss would write, since the thresholds force it)."""
    cachedir = str(tmp_path / "xla")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cachedir,
               JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("XLA_FLAGS", None)

    def run():
        r = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        entries = []
        for root, _dirs, files in os.walk(cachedir):
            entries.extend(os.path.join(os.path.relpath(root, cachedir), f)
                           for f in files)
        return sorted(entries)

    entries1 = run()
    assert entries1, "first process wrote no cache entries"
    entries2 = run()
    assert entries2 == entries1, (
        "second process recompiled (new cache entries) instead of "
        "hitting the persistent cache")
