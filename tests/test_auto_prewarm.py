"""Auto-prewarm: background compile of trigger kernels at construction.

Round-4 VERDICT item 9: cold start previously paid the full XLA compile
at the first dispatch unless the operator remembered --prewarm. The
pipeline now starts a best-effort daemon thread at construction that
compiles the default-shape channel kernels into the SAME instance fn
cache the dispatch path reads, so the first real dispatch is a cache
hit. These tests pin the cache-sharing contract, the CPU-backend skip
(the suite builds hundreds of pipelines), and the opt-outs.
"""

import numpy as np
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.triggers import TriggerProcessing

FS = 1.25e6
NT, PRE = 512, 128
L = 16_384


@pytest.fixture()
def setup(tmp_path):
    rng = np.random.default_rng(3)
    tmpl = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                               tau_f1=60e-6)
    traces = rng.standard_normal((2, 1, L)) * 1e-9
    traces[:, 0, 5000 - PRE:5000 - PRE + NT] += 2e-9 * tmpl
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T250000", FS,
                  ["chan1"], data_type="continuous",
                  nb_pretrigger_samples=PRE)
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRE)
    fd.set_psd("chan1", np.full(NT, 1e-9 ** 2 / FS), FS)
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump({"trigger": {"chan1": {
        "run": True, "template_tag": "default",
        "threshold_sigma": 7.0, "pileup_window_msec": 0.04}}},
        open(cpath, "w"))
    return files, cpath, fd


def test_cpu_backend_skips_compile(setup):
    """On the CPU backend the prewarm thread exits without compiling
    anything — the suite constructs pipelines constantly."""
    files, cpath, fd = setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    assert tp._prewarm_thread is not None
    tp._prewarm_thread.join(timeout=60)
    assert not tp._prewarm_thread.is_alive()
    assert tp._fn_cache == {}


def test_opt_outs(setup, monkeypatch):
    files, cpath, fd = setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False,
                           auto_prewarm=False)
    assert tp._prewarm_thread is None
    monkeypatch.setenv("DETPROC_AUTO_PREWARM", "0")
    tp2 = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    assert tp2._prewarm_thread is None


def test_prewarm_lands_in_dispatch_cache(setup, monkeypatch):
    """On a non-CPU backend (simulated), the prewarm thread compiles the
    default-shape kernels into the instance cache, and a process() call
    with the default capacity reuses the SAME compiled fn object."""
    import jax

    files, cpath, fd = setup
    monkeypatch.setattr(jax, "default_backend", lambda: "prewarm-test")
    monkeypatch.setattr(TriggerProcessing, "DEFAULT_CAPACITY", 64)
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    assert tp._prewarm_thread is not None
    tp._prewarm_thread.join(timeout=300)
    assert not tp._prewarm_thread.is_alive()
    assert len(tp._fn_cache) == 1, "prewarm did not compile the kernel"
    fn_pre = next(iter(tp._fn_cache.values()))
    df = tp.process(capacity=64, event_batch=2)
    assert len(tp._fn_cache) == 1, "dispatch built a second fn"
    assert next(iter(tp._fn_cache.values())) is fn_pre
    assert len(df) >= 2          # the injected pulse still triggers


def test_prewarm_bails_on_capacity_mismatch(setup, monkeypatch):
    """A process() running with a non-default capacity (or a mesh) makes
    the default-shape prewarm useless — on the serialized backend
    compile queue it would only DELAY the real compile. The thread must
    bail without compiling."""
    import jax

    files, cpath, fd = setup
    monkeypatch.setattr(jax, "default_backend", lambda: "prewarm-test")
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False,
                           auto_prewarm=False)
    tp._active_process_key = (64, None)      # as a live process() sets
    tp._start_auto_prewarm()
    tp._prewarm_thread.join(timeout=60)
    assert not tp._prewarm_thread.is_alive()
    assert tp._fn_cache == {}, "prewarm compiled despite the mismatch"


def test_feature_prewarm_compiles_group_fns(setup, monkeypatch,
                                            tmp_path):
    """FeatureProcessing's prewarm thread (simulated non-CPU backend)
    executes the same jit'd group fns the dispatch path calls, at the
    default batch shape — the jit cache is warm before process()."""
    import jax

    from detprocess_jax.pipelines.features import FeatureProcessing

    files, cpath, fd = setup
    fcfg = {"feature": {"trace_length_samples": NT,
                        "pretrigger_length_samples": PRE,
                        "chan1": {"of1x1_nodelay": {"run": True},
                                  "baseline": {"run": True}}}}
    fpath = str(tmp_path / "f.yaml")
    yaml.safe_dump(fcfg, open(fpath, "w"))
    monkeypatch.setattr(jax, "default_backend", lambda: "prewarm-test")
    monkeypatch.setattr(FeatureProcessing, "DEFAULT_BATCH_SIZE", 4)
    fp = FeatureProcessing(files, fpath, filter_data=fd, verbose=False)
    assert fp._prewarm_thread is not None
    fp._prewarm_thread.join(timeout=300)
    assert not fp._prewarm_thread.is_alive()
    assert all(fn._cache_size() >= 1 for fn in fp._group_fns), \
        "prewarm did not compile the group fns"
    # CPU backend: skipped, nothing compiled at construction
    monkeypatch.undo()
    fp2 = FeatureProcessing(files, fpath, filter_data=fd, verbose=False)
    fp2._prewarm_thread.join(timeout=60)
    assert all(fn._cache_size() == 0 for fn in fp2._group_fns)


def test_prewarm_failure_is_silent(setup, monkeypatch):
    """A broken backend probe must not break construction or process()."""
    import jax

    files, cpath, fd = setup

    def boom():
        raise RuntimeError("backend exploded")

    monkeypatch.setattr(jax, "default_backend", boom)
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    tp._prewarm_thread.join(timeout=60)
    df = tp.process(capacity=64, event_batch=2)
    assert len(df) >= 2


def test_fn_cache_keys_on_premerge_window(setup):
    """Changing set_dynamic_threshold's premerge_window (same window
    fn!) must compile a FRESH kernel — the cache key once omitted it
    and silently reused the stale merge semantics."""
    import jax.numpy as jnp

    files, cpath, fd = setup
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False,
                           auto_prewarm=False)

    def window_fn(m):
        return 50.0 + 0.0 * jnp.sqrt(m)

    tp.set_dynamic_threshold("chan1", window_fn, premerge_window=None)
    tp.process(capacity=32, event_batch=2)
    assert len(tp._fn_cache) == 1
    tp.set_dynamic_threshold("chan1", window_fn, premerge_window=0)
    tp.process(capacity=32, event_batch=2)
    assert len(tp._fn_cache) == 2, \
        "premerge_window change reused the stale compiled kernel"
