"""Persistent XLA compilation cache for pipeline runs.

Cold-starting a pipeline pays the full XLA compile of every jitted
kernel, once per distinct (trace-length, capacity, channel-count)
configuration. JAX ships an on-disk executable cache keyed by HLO
fingerprint; with it, every process after the first loads compiled
kernels from disk, so repeated production runs (and the common
rerun-after-crash / rerun-next-series case) skip compilation. The
pipelines call :func:`enable` on construction.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX itself reads it and uses it;
  this module sets nothing else.
- otherwise a fixed directory inside the checkout, ``<repo>/.jax_cache``
  (the path is part of what makes a later process hit the cache, so it
  never moves).

On the CPU backend the default cache stays off: XLA:CPU persists
ahead-of-time executables whose embedded machine spec includes
compiler-tuning pseudo-features (``+prefer-no-scatter``,
``+prefer-no-gather``) that the load-time host-feature probe never
reports, so every reload logs ``cpu_aot_loader.cc`` feature-mismatch
errors. Setting ``JAX_COMPILATION_CACHE_DIR`` turns it on there too.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

#: the fixed default cache directory: ``.jax_cache`` at the checkout root
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_lock = threading.Lock()


def cache_dir(platform: str) -> Optional[str]:
    """The cache directory for a process on ``platform`` ("gpu", "cpu",
    ...): ``JAX_COMPILATION_CACHE_DIR`` when set, else
    :data:`DEFAULT_DIR` — except on the CPU, where the default is off
    (None)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return None if platform == "cpu" else DEFAULT_DIR


def _platform() -> str:
    """Platform of this process's default device ("gpu", "cpu", ...)."""
    import jax
    return jax.devices()[0].platform


def enable() -> Optional[str]:
    """Point JAX's persistent compilation cache at :func:`cache_dir` of
    this process's platform. Returns the directory in use, or None when
    the cache is off. Idempotent and thread-safe."""
    import jax

    with _lock:
        path = cache_dir(_platform())
        if path is None or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            return path        # off, or JAX already reads the env var
        if jax.config.jax_compilation_cache_dir != path:
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        return path
