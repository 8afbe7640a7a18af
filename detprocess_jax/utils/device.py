"""Which accelerator a measurement ran on.

Every benchmark result names its device, and a measurement that finds
no GPU fails instead of timing the CPU. :func:`gpu_board` reads the
board name and power limit from ``nvidia-smi`` without touching JAX, so
a parent process that must stay off the card can call it too.
"""

from __future__ import annotations

import subprocess


def gpu_board() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each ("NVIDIA H100 80GB HBM3, 700.00 W"). Raises RuntimeError
    when nvidia-smi is missing or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"nvidia-smi unavailable: {exc}") from exc
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def require_gpu() -> dict:
    """The device record of this JAX process — ``platform``,
    ``device_kind``, ``count`` — or RuntimeError when JAX's default
    device is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devs[0].platform!r}; this "
            "measurement runs only on an NVIDIA GPU")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
