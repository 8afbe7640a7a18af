"""Long-trace triggering sharded across a device mesh with halo exchange.

A design addition over the reference (SURVEY.md §5): one
continuous trace is split across devices; the FIR exchanges one
template length of halo between neighbours and the pileup-merge scan
carries cross shard boundaries, so the output is exactly the unsharded
result.

Runs on every device JAX finds (the GPUs of the host); ``--cpu-mesh N``
runs it on N virtual CPU devices instead.

Run:  python examples/trigger/longtrace_sharded.py [--cpu-mesh 8]
"""

import os
import sys

# --cpu-mesh N: N virtual CPU devices instead of the machine's own
# devices (decided before jax is imported)
if "--cpu-mesh" in sys.argv:
    n_cpu = int(sys.argv[sys.argv.index("--cpu-mesh") + 1])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = " ".join(
        [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "host_platform_device_count" not in f]
        + [f"--xla_force_host_platform_device_count={n_cpu}"])

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from detprocess_jax.models import pulse                      # noqa: E402
from detprocess_jax.ops import filterbank, trigger as trig   # noqa: E402
from detprocess_jax.parallel import mesh as pmesh            # noqa: E402

FS = 1.25e6
NT, PRETRIG = 1024, 256


def main():
    n_shards = len(jax.devices())
    l_glob = n_shards * 131072                 # one ~1M-sample trace
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=10e-6,
                               tau_f1=100e-6)
    psd = np.full(NT, 4e-18)
    bank = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS,
                                      PRETRIG)
    kernel = trig.make_trigger_kernel(bank)
    thr = trig.chi2_threshold(6.0, 1)

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(l_glob) * np.sqrt(psd[0] * FS))
    inj = list(range(50_000, l_glob - 50_000, 97_003))
    # one pulse straddling the middle (a shard boundary for any even
    # shard count)
    inj.append(l_glob // 2 - NT // 3)
    for t0 in inj:
        x[t0 - PRETRIG:t0 - PRETRIG + NT] += 3e-6 * tmpl

    mesh = pmesh.make_mesh(n_shards)
    fn = pmesh.sharded_longtrace_trigger(mesh, kernel, thr,
                                         pileup_window=125,
                                         capacity_per_shard=128)
    xs = jax.device_put(
        jnp.asarray(x[None, :].astype(np.float32)),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, pmesh.EVENTS_AXIS)))
    idx, d, a, cnt = fn(xs)
    g_idx, g_d, g_a = pmesh.merge_sharded_triggers(idx, d, a)
    print(f"{len(g_idx)} triggers across {n_shards} shards "
          f"({len(inj)} injected)")
    boundary = inj[-1]
    hit = min(g_idx, key=lambda i: abs(i - boundary))
    print(f"boundary-straddling pulse at {boundary}: "
          f"found at {hit} (Δ = {hit - boundary})")
    assert abs(hit - boundary) <= 6
    return g_idx


if __name__ == "__main__":
    main()
