"""Test configuration.

The suite runs on the CPU by default: JAX on a virtual 8-device CPU mesh
with float64, so multi-device sharding tests use the virtual devices and
numerics tests compare tight float64 goldens. This must run before jax
is imported anywhere in the test session.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and the ``gpu``
fixture, which skips them at run time when no card is present. On a
machine with a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_device.py
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def gpu():
    """Skip the requesting test unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU "
                    "(JAX_PLATFORMS=cuda python -m pytest -m gpu)")
