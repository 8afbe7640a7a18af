"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Asserts the reference's implicit invariant (SURVEY.md §4): results are
independent of how events are split across workers/chips.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from detprocess_jax.models import pulse
from detprocess_jax.ops import filterbank, of1x1, spectral
from detprocess_jax.parallel import mesh as pmesh

FS = 1.25e6
N = 1024
PRETRIG = 512


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_dryrun_multichip():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
    mod.dryrun_multichip(4)


def test_entry_compiles():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry2",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out["amp"])))


def test_sharded_psd_matches_single_device():
    rng = np.random.default_rng(0)
    traces = rng.standard_normal((32, N)).astype(np.float32)
    mesh = pmesh.make_mesh(8)
    psd_fn = pmesh.sharded_psd(mesh, FS)
    sharded = np.asarray(psd_fn(pmesh.shard_batch(mesh, jnp.asarray(traces))))
    single = np.asarray(spectral.welch_psd(jnp.asarray(traces), FS))
    np.testing.assert_allclose(sharded, single, rtol=1e-5)


def test_sharded_feature_step_shard_invariance():
    """OF results identical on 1, 2 and 8 shards."""
    rng = np.random.default_rng(1)
    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(N, 1e-20)
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    traces = (rng.standard_normal((16, N)) * 1e-9
              + 2e-6 * template[None, :]).astype(np.float32)

    def local_fn(local_traces, dev):
        bk = filterbank.device_bank_1x1(dev)
        vfft = of1x1.signal_fft(local_traces[:, None, :])
        wd = of1x1.of1x1_withdelay(vfft, bk.phi, bk.norm, bk.denom_inv,
                                   bk.s_fft, PRETRIG, FS)
        return wd.amp[:, 0]

    results = []
    for ndev in (1, 2, 8):
        mesh = pmesh.make_mesh(ndev)
        dev_bank = pmesh.replicate(
            mesh, jax.tree.map(jnp.asarray, bank.to_device(np.float32)))
        fn = jax.jit(pmesh.sharded_map(mesh, local_fn))
        out = fn(pmesh.shard_batch(mesh, jnp.asarray(traces)), dev_bank)
        results.append(np.asarray(out))
    # invariance holds to float32 roundoff (XLA reduction order differs
    # with the per-shard batch shape)
    np.testing.assert_allclose(results[0], results[1], rtol=1e-5)
    np.testing.assert_allclose(results[0], results[2], rtol=1e-5)


def test_sharded_csd():
    rng = np.random.default_rng(2)
    traces = rng.standard_normal((16, 2, N)).astype(np.float32)
    mesh = pmesh.make_mesh(8)
    csd_fn = pmesh.sharded_csd(mesh, FS)
    out = np.asarray(csd_fn(pmesh.shard_batch(mesh, jnp.asarray(traces))))
    csd = out[..., 0] + 1j * out[..., 1]
    single = np.asarray(spectral.welch_csd(jnp.asarray(
        traces.astype(np.float64)), FS))
    np.testing.assert_allclose(csd, single, rtol=1e-4, atol=1e-7)


def test_sharded_trigger_shard_invariance():
    """Continuous triggering sharded over events: identical trigger
    indices/amplitudes on 1- and 8-device meshes."""
    from detprocess_jax.ops import filterbank as fb, trigger as trig_ops

    rng = np.random.default_rng(7)
    nt, pretrig, l, e = 1024, 256, 65536, 8
    template = pulse.make_template(FS, nt, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    psd = np.full(nt, 4e-18)
    bank = fb.make_ofnxm_bank(template, psd.astype(complex), FS, pretrig)
    kernel = trig_ops.make_trigger_kernel(bank)
    thr = float(trig_ops.chi2_threshold(5.0, 1))

    traces = (rng.standard_normal((e, 1, l))
              * np.sqrt(psd[0] * FS)).astype(np.float32)
    # loud pulses at distinct spots per event
    for k in range(e):
        pos = 5000 + 7000 * k
        traces[k, 0, pos - pretrig:pos - pretrig + nt] += 1e-5 * template

    outs = {}
    for nd in (1, 8):
        mesh = pmesh.make_mesh(nd)
        fn = pmesh.sharded_trigger(mesh, kernel, thr, 125, 64)
        idx, dchi2, amps, count = fn(
            pmesh.shard_batch(mesh, jnp.asarray(traces)))
        outs[nd] = (np.asarray(idx), np.asarray(dchi2),
                    np.asarray(amps), np.asarray(count))
    np.testing.assert_array_equal(outs[1][0], outs[8][0])
    np.testing.assert_allclose(outs[1][1], outs[8][1], rtol=1e-6)
    np.testing.assert_allclose(outs[1][2], outs[8][2], rtol=1e-6)
    np.testing.assert_array_equal(outs[1][3], outs[8][3])
    # every injected pulse found near its position (trigger-time jitter
    # of a few samples is physical at this SNR/bandwidth; occasional
    # >5-sigma noise triggers are expected too, so match the nearest)
    idx, _, amps, count = outs[8]
    for k in range(e):
        c = int(count[k])
        assert c >= 1
        found = idx[k, :c]
        j = int(np.argmin(np.abs(found - (5000 + 7000 * k))))
        assert abs(int(found[j]) - (5000 + 7000 * k)) <= 5
        np.testing.assert_allclose(amps[k, 0, j], 1e-5, rtol=0.1)


def test_multihost_series_split_properties():
    """Multi-node series splitting: disjoint, complete, deterministic —
    the structural race-avoidance invariant the reference gets from
    unique output series per node (process/features.py:502-508)."""
    from detprocess_jax.parallel import multihost

    series = [f"I1_D20260816_T12{k:04d}" for k in range(23)]
    got = []
    for host in range(5):
        mine = multihost.split_series_for_host(series, host, 5)
        # deterministic
        assert mine == multihost.split_series_for_host(series, host, 5)
        got.extend(mine)
    assert sorted(got) == sorted(series)          # complete
    assert len(got) == len(set(got))              # disjoint

    # unique output series numbers per host
    nums = {multihost.output_series_num_for_host(7_000, h)
            for h in range(5)}
    assert len(nums) == 5


def test_sharded_psd_perm_longtrace():
    """Sharded PSD of long traces (16k samples) inside shard_map: the
    psum of per-shard periodogram sums equals the one-device Welch PSD."""
    from detprocess_jax.ops import spectral

    n = 16384
    mesh = pmesh.make_mesh()
    rng = np.random.default_rng(9)
    traces = rng.standard_normal((16, n)).astype(np.float32)
    psd_fn = pmesh.sharded_psd(mesh, FS)
    got = np.asarray(psd_fn(jnp.asarray(traces)))
    ref = np.asarray(spectral.welch_psd(jnp.asarray(traces), FS))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_sharded_spectral_fns_cached():
    """sharded_psd/sharded_csd return the SAME jitted callable for the
    same (mesh, fs): without the cache every per-channel call in
    Noise.calc_psd(mesh=...) recompiled identical XLA."""
    mesh = pmesh.make_mesh()
    assert pmesh.sharded_psd(mesh, FS) is pmesh.sharded_psd(mesh, FS)
    assert pmesh.sharded_csd(mesh, FS) is pmesh.sharded_csd(mesh, FS)
    assert pmesh.sharded_psd(mesh, FS) is not pmesh.sharded_psd(mesh,
                                                                2 * FS)


def test_make_mesh_rejects_overask():
    """Requesting more devices than exist must raise, not silently clamp
    (a --mesh-devices 8 run on a 2-chip host would otherwise report
    success while under-sharded)."""
    n = len(jax.devices())
    with pytest.raises(ValueError, match="only"):
        pmesh.make_mesh(n + 1)
