"""FFT entry points and the contraction precision for every device kernel.

Every transform in the package goes through ``jnp.fft``, which XLA lowers
to cuFFT on the GPU and to pocketfft/DUCC on the CPU (float64 golden
tests). Both run any length natively, so real traces take the plain
half-spectrum route: ``rfft`` → per-bin arithmetic → ``irfft``, with XLA
fusing the per-bin work around the library calls.

Reference role: stands in for every np.fft/scipy.fft call in the
reference and QETpy (e.g. qetpy OFBase FFTs, detprocess
core/oftrigger.py:659-672 oaconvolve internals).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: Precision of every float32 contraction on device data. The GPU's
#: DEFAULT runs float32 matmuls in TF32 (10 mantissa bits, ~1e-3
#: relative error), which is visible in OF amplitudes and delay argmaxes
#: against the float64 goldens; HIGHEST keeps full float32.
HIGHEST = jax.lax.Precision.HIGHEST


def fft(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Complex FFT along ``axis`` (unnormalized, numpy convention)."""
    return jnp.fft.fft(x, axis=axis)


def ifft(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Inverse complex FFT along ``axis`` (1/N normalization)."""
    return jnp.fft.ifft(x, axis=axis)


def rfft(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Real-input FFT: the N//2+1 non-negative-frequency bins."""
    return jnp.fft.rfft(x, axis=axis)


def irfft(x: jnp.ndarray, n: int, axis: int = -1) -> jnp.ndarray:
    """Inverse of :func:`rfft`, returning ``n`` real samples along
    ``axis`` (``n`` is required: odd lengths are not recoverable from
    the half spectrum alone)."""
    return jnp.fft.irfft(x, n=n, axis=axis)


def einsum(subs, *ops):
    """``jnp.einsum`` at :data:`HIGHEST` precision — use it for every
    contraction on float32 device data."""
    return jnp.einsum(subs, *ops, precision=HIGHEST)
