"""Autocuts convergence semantics.

The reference delegates to qetpy.autocuts_* (detprocess/core/noise.py:331,
core/didv.py:1631), whose outlier loops iterate UNTIL CONVERGENCE. The
device implementation must do the same by default — a fixed pass count
silently changes the selection on heavy-tailed batches, which shifts
PSDs and dIdV fits downstream. These tests check:

1. the default mask is the exact fixed point of the clipping operator
   (one more pass changes nothing),
2. a heavy-tailed batch where few-pass clipping is NOT converged — the
   default keeps clipping until stable while niter=1 stops early,
3. equivalence with an independent numpy converge-until-done loop,
4. the fixed-iteration opt-in still works and matches once converged.
"""

import numpy as np
import jax.numpy as jnp

from detprocess_jax.ops import autocuts


def _numpy_reference_mask(metrics, nsigma):
    """Independent converge-until-done sigma clip, plain numpy."""
    mask = np.ones(len(metrics[0]), dtype=bool)
    for metric in metrics:
        while True:
            m = metric[mask].mean()
            s = metric[mask].std()
            keep = np.abs(metric - m) <= nsigma * s + 1e-30
            new = mask & keep
            if np.array_equal(new, mask):
                break
            mask = new
    return mask


def _metrics(x):
    n = x.shape[-1]
    k = max(n // 10, 1)
    return (x.std(axis=-1),
            x.max(axis=-1) - x.min(axis=-1),
            x[:, -k:].mean(axis=-1) - x[:, :k].mean(axis=-1),
            x.mean(axis=-1))


def _heavy_tailed_batch(rng, b=600, n=128):
    """Noise std drawn from a geometric cascade: each clipping pass
    removes one tier of outliers and thereby shrinks the std enough to
    expose the next tier — convergence needs many passes."""
    x = rng.standard_normal((b, n))
    scales = np.ones(b)
    tier = np.arange(b) % 40
    scales = 1.0 + 12.0 * (0.55 ** tier)       # 40 geometric tiers
    return x * scales[:, None]


def test_default_is_fixed_point():
    rng = np.random.default_rng(0)
    x = _heavy_tailed_batch(rng)
    mask = np.asarray(autocuts.autocuts_noise(jnp.asarray(x)))
    # applying every metric's clip once more must not change the mask
    m2 = mask.copy()
    for metric in _metrics(x):
        mm = m2.copy()
        mu = metric[mm].mean()
        sd = metric[mm].std()
        m2 = mm & (np.abs(metric - mu) <= 2.5 * sd + 1e-30)
    np.testing.assert_array_equal(mask, m2)


def test_fixed_iterations_not_converged_on_heavy_tails():
    rng = np.random.default_rng(1)
    x = _heavy_tailed_batch(rng)
    m_conv = np.asarray(autocuts.autocuts_noise(jnp.asarray(x)))
    m_1 = np.asarray(autocuts.autocuts_noise(jnp.asarray(x), niter=1))
    # the cascade construction must actually need more than one pass
    assert m_conv.sum() < m_1.sum(), (
        "test construction too weak: one pass already converged")


def test_matches_independent_numpy_loop():
    rng = np.random.default_rng(2)
    for batch in (_heavy_tailed_batch(rng),
                  rng.standard_normal((300, 64)),
                  rng.standard_normal((300, 64))
                  * (1 + 5.0 * (rng.random(300) < 0.05))[:, None]):
        ours = np.asarray(autocuts.autocuts_noise(jnp.asarray(batch)))
        ref = _numpy_reference_mask(_metrics(batch), 2.5)
        np.testing.assert_array_equal(ours, ref)


def test_fixed_opt_in_matches_when_converged():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, 64))   # well-behaved: converges fast
    m_conv = np.asarray(autocuts.autocuts_noise(jnp.asarray(x)))
    m_5 = np.asarray(autocuts.autocuts_noise(jnp.asarray(x), niter=5))
    np.testing.assert_array_equal(m_conv, m_5)


def test_didv_remove_mean_and_multichannel():
    rng = np.random.default_rng(4)
    n = 128
    wave = np.sin(2 * np.pi * np.arange(n) / 32)  # shared square-ish wave
    x = wave[None, :] * 5.0 + rng.standard_normal((200, n))
    x[7] += 40.0                                   # baseline jump
    mask = np.asarray(autocuts.autocuts_didv(jnp.asarray(x)))
    assert not mask[7] and mask.sum() > 150
    x3 = np.stack([x, x], axis=1)                 # [B, C, N]
    mask3 = np.asarray(autocuts.autocuts_didv(jnp.asarray(x3)))
    np.testing.assert_array_equal(mask3, mask)
