"""Two-process jax.distributed smoke test (VERDICT round-2 weak #4).

Spawns two CPU subprocesses with a local coordinator, builds the global
mesh through ``parallel.multihost.initialize``/``global_mesh``, and runs
one psum PSD over data sharded across the processes — proving the
multi-host entry points (multihost.py:55-74) actually work, not just
the series-split helpers.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2").strip()

from detprocess_jax.parallel import multihost
import jax

jax.config.update("jax_enable_x64", True)

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, len(jax.devices())   # 2 local x 2 procs

mesh = multihost.global_mesh()
assert mesh.devices.size == 4

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from detprocess_jax.parallel import mesh as pmesh

fs = 1.25e6
n = 256
nev_local = 4   # per device -> 16 global events
rng = np.random.default_rng(1234)           # same seed on both procs
all_traces = rng.standard_normal((16, n))

# build the globally-sharded array from per-process local shards
sharding = NamedSharding(mesh, P("events"))
local_dev = mesh.local_devices
per_dev = 16 // 4
local_arrays = []
for d in local_dev:
    # device order in the mesh defines the global slot
    slot = list(mesh.devices.flat).index(d)
    local_arrays.append(
        jax.device_put(all_traces[slot * per_dev:(slot + 1) * per_dev], d))
global_traces = jax.make_array_from_single_device_arrays(
    (16, n), sharding, local_arrays)

psd_fn = pmesh.sharded_psd(mesh, fs)
psd = np.asarray(jax.device_get(psd_fn(global_traces)))

# reference: plain single-process Welch mean over all 16 events
from detprocess_jax.ops import spectral
import jax.numpy as jnp2
ref = np.asarray(
    jnp.mean(spectral.periodogram(jnp.asarray(all_traces), fs), axis=-2))
np.testing.assert_allclose(psd, ref, rtol=1e-10)
print(f"WORKER{pid} OK")
"""


def test_two_process_psum_psd(tmp_path):
    # bounded internally: communicate(timeout=240) + kill — the
    # pytest-timeout plugin is not installed in this image

    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, str(worker_py), str(pid), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out:\n"
                    + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER{pid} OK" in out, out
