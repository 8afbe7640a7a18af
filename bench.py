"""Benchmark: of1x1 optimal-filter feature extraction events/sec on one GPU.

The step: of1x1 (nodelay + unconstrained delay scan) + baseline/integral
on synthetic 32768-sample TES pulse batches, the natural half-spectrum
chain the feature pipeline ships (rfft → per-bin fits → irfft). The
baseline is the reference's processing model — a single-CPU-core
per-event Python loop over the same float64 numpy math
(tests/reference_impl.py, standing in for detprocess+QETpy, which run
exactly such a loop: detprocess/process/features.py:533-851).

Measurement notes:
- Test traces are synthesized ON DEVICE (jax.random), so the number is
  the device step's rate, not the host→device link's.
- Batches are dispatched back to back and the window ends in
  ``jax.block_until_ready`` on every output.
- Without a GPU the script fails; it never times the CPU in its place.

Prints ONE JSON line:
    {"metric": ..., "value": events_per_sec, "unit": "events/s",
     "vs_baseline": speedup_vs_single_cpu_core, "physics": {...},
     "device": {"platform", "kind", "count"}, "board": nvidia-smi}
"""

import json
import os
import sys
import time

FS = 1.25e6
N = 32768
PRETRIG = N // 2
BATCH = 8192
NBATCH = 8
CPU_BASELINE_EVENTS = 24


def build_bank():
    import numpy as np

    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank

    template = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    f = np.abs(np.fft.fftfreq(N, 1 / FS))
    f[0] = f[1]
    psd = 1e-20 * (1.0 + 100.0 / f)
    bank = filterbank.make_of1x1_bank(template, psd, FS, PRETRIG)
    return template, psd, bank


def bench_device(bank, template):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from detprocess_jax.ops import filterbank, of1x1, tracestats

    dev_bank = jax.tree.map(jnp.asarray, bank.to_device(np.float32))
    tmpl_dev = jnp.asarray(template, jnp.float32)

    # two-sided PSD at rfft bins, for PSD-matched noise synthesis:
    # E|ñ_k|² = N·fs·J_k (numpy unnormalized-FFT convention, matching
    # denom_inv = 1/(N·fs·J) in the bank) → χ²/dof ~ 1 by construction
    psd_half = jnp.asarray(bank.psd[0][:N // 2 + 1], jnp.float32)
    half_scale = jnp.sqrt(psd_half * FS * N / 2.0)

    @jax.jit
    def make_batch(key):
        """Synthesize a batch on device: PSD-matched colored noise +
        random-amplitude pulses at the template position (t0 = 0)."""
        knoise, kamp = jax.random.split(key)
        z = jax.random.normal(knoise, (BATCH, 2, N // 2 + 1),
                              jnp.float32)
        nf = (z[:, 0] + 1j * z[:, 1]) * half_scale
        nf = nf.at[:, 0].set(0.0)                       # DC (notched)
        nf = nf.at[:, -1].set(z[:, 0, -1]               # real Nyquist
                              * half_scale[-1] * jnp.sqrt(2.0))
        noise = jnp.fft.irfft(nf, n=N)
        amps = jax.random.uniform(kamp, (BATCH,), jnp.float32,
                                  1e-6, 5e-6)
        return noise + amps[:, None] * tmpl_dev[None, :], amps

    @jax.jit
    def feature_step(traces, dev):
        bh = filterbank.device_bank_1x1_half(dev)
        vr = of1x1.signal_rfft(traces[:, None, :])
        wd = of1x1.of1x1_withdelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                        bh.s_fft, bh.bin_w, PRETRIG, FS)
        nod = of1x1.of1x1_nodelay_half(vr, bh.phi, bh.norm, bh.denom_inv,
                                       bh.s_fft, bh.bin_w, n=N)
        return (nod.amp[:, 0], nod.chi2[:, 0], wd.amp[:, 0], wd.t0[:, 0],
                wd.chi2[:, 0], tracestats.baseline(traces),
                tracestats.integral(traces, FS))

    keys = jax.random.split(jax.random.PRNGKey(0), NBATCH)
    batches = jax.block_until_ready([make_batch(k) for k in keys])
    # compile + warm up outside the window
    jax.block_until_ready(feature_step(batches[0][0], dev_bank))

    t0 = time.perf_counter()
    outs = jax.block_until_ready(
        [feature_step(tr, dev_bank) for tr, _ in batches])
    dt = time.perf_counter() - t0
    events_per_sec = BATCH * NBATCH / dt
    amps_rec = [np.asarray(o[2]) for o in outs]

    # correctness: recovered amplitudes match the injected ones to
    # within the matched-filter resolution
    sigma_amp = float(bank.resolution[0])        # 1/sqrt(norm)
    amps_true = np.asarray(batches[0][1])
    err = np.abs(amps_rec[0] - amps_true)
    if not np.all(err < max(1e-7, 8 * sigma_amp)):
        raise RuntimeError(f"benchmark correctness check failed: "
                           f"max amp error {err.max():.3e} "
                           f"(sigma_amp {sigma_amp:.3e})")

    # physics invariants on the SAME device outputs. Known-truth
    # injections: amps_true per event, t0_true = 0 (pulses sit at the
    # template position), and make_batch synthesizes noise MATCHED to the
    # bank's PSD → χ²/dof ~ 1 by construction. Reference anchor for the
    # invariant set: detprocess/process/features.py:533-851.
    truths = [np.asarray(b[1]) for b in batches]
    rel = np.concatenate([(r - t) / t
                          for r, t in zip(amps_rec, truths)])
    scatter_sigma = float(np.std(
        np.concatenate([r - t for r, t in zip(amps_rec, truths)]))
        / sigma_amp)
    chi2 = np.concatenate([np.asarray(o[4]) for o in outs])
    chi2_dof = float(np.mean(chi2) / (N - 2))
    t0s = np.concatenate([np.asarray(o[3]) for o in outs])
    t0_within_1 = float(np.mean(np.abs(t0s) * FS <= 1.0))
    physics = {
        "amp_bias": float(np.mean(rel)),
        "amp_scatter_sigma": scatter_sigma,
        "chi2_dof": chi2_dof,
        "t0_within_1": t0_within_1,
        "pass": bool(abs(float(np.mean(rel))) < 5e-3
                     and abs(chi2_dof - 1.0) < 0.05
                     and t0_within_1 > 0.99),
    }
    return events_per_sec, physics


def bench_cpu_baseline(template, psd):
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from reference_impl import RefOF1x1

    rng = np.random.default_rng(0)
    ref = RefOF1x1(template, psd, FS, PRETRIG)
    sub = (rng.standard_normal((CPU_BASELINE_EVENTS, N)) * 3e-9
           + 2e-6 * template[None, :])
    try:
        os.sched_setaffinity(0, {0})
    except (AttributeError, OSError):
        pass
    # best of 3 passes: the fastest CPU run gives the most conservative
    # speedup (the host is shared, single runs swing with contention)
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(len(sub)):
            ref.fit_nodelay(sub[i])
            ref.fit_withdelay(sub[i])
            np.mean(sub[i][: N - 1])
            np.trapezoid(sub[i][: N - 1]) / FS
        best_dt = min(best_dt, time.perf_counter() - t0)
    return len(sub) / best_dt


def main():
    from detprocess_jax.utils import device, jaxcache

    dev = device.require_gpu()
    board = device.gpu_board()
    jaxcache.enable()
    template, psd, bank = build_bank()
    events_per_sec, physics = bench_device(bank, template)
    cpu_rate = bench_cpu_baseline(template, psd)
    print(json.dumps({
        "metric": "of1x1 feature extraction (32k samples, nodelay+delay-scan"
                  "+trace stats)",
        "value": events_per_sec,
        "unit": "events/s",
        "vs_baseline": events_per_sec / cpu_rate,
        "physics": physics,
        "device": dev,
        "board": board,
    }), flush=True)


if __name__ == "__main__":
    main()
