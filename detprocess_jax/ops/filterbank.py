"""Optimal-filter bank precomputation.

This is the batched replacement for QETpy's ``OFBase`` per-
(nb_samples, pretrigger, tag) object cache (reference:
detprocess/process/processing_data.py:275-418, core/oftrigger.py:467-499).
Instead of mutable per-event objects, all precomputation is done **once, on
host, in float64**, producing immutable stacked arrays; per-event work on
device is then a handful of batched FFTs + reductions.

Mathematical conventions (self-contained; derived from the standard optimal
filter formalism — see docs in ops/of1x1.py):

With two-sided noise PSD J(f_k) [A²/Hz] and unnormalized numpy FFTs
(ṽ = FFT(v), s̃ = FFT(s)), the variance of one noise FFT bin is
``E|FFT(n)_k|² = N·fs·J_k``.  Define:

- ``denom_inv_k = 1 / (N·fs·J_k)``   (zeroed at DC and at notched bins)
- ``phi_k       = conj(s̃_k) · denom_inv_k``          (the optimal filter)
- ``norm        = Σ_k Re(phi_k s̃_k)``               (= 1/σ_amp²)

NxM (multi-channel, multi-template) banks use the CSD matrix J_k [n×n]:

- ``Phi[:, i, k] = J_k⁻¹ s̃*[:, i, k] / (N·fs)``
- ``W[i, j]      = Re Σ_k s̃[:, i, k]† J_k⁻¹ s̃[:, j, k] / (N·fs)``

Frequency notching ("ignored_frequency_peaks" + harmonics,
processing_data.py:258-272) zeroes ``denom_inv`` at the nearest ± bins,
equivalent to setting the CSD to infinity there as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

try:  # device-side helpers (host precompute itself is numpy-only)
    import jax
    import jax.numpy as jnp
except ImportError:  # pragma: no cover
    jax = None


# ---------------------------------------------------------------------------
# host<->device complex marshalling
#
# Bank arrays cross the host↔device boundary as stacked (re, im) real
# arrays and are joined back into complex values *inside* jit: one real
# pytree format for every bank, whatever its dtype.
# ---------------------------------------------------------------------------

def split_complex(x: np.ndarray, real_dtype=np.float32) -> np.ndarray:
    """Host: complex [..., N] -> real [..., N, 2]."""
    return np.stack([x.real, x.imag], axis=-1).astype(real_dtype)


def join_complex(x) -> "jnp.ndarray":
    """Device (inside jit): real [..., N, 2] -> complex [..., N]."""
    return jax.lax.complex(x[..., 0], x[..., 1])


def half_bin_weights(n: int, dtype=np.float64) -> np.ndarray:
    """Per-bin weights [1, 2, …, 2, 1 (even n)] of length n//2+1 that make
    half-spectrum reductions equal the full-spectrum sum for Hermitian
    spectra (DC and — for even n — Nyquist appear once; every other bin
    represents a conjugate pair). Single owner of the rule: bank packing,
    the feature plan's direct-window kernels, and the benchmarks all
    build their weights here."""
    nh = n // 2 + 1
    w = np.full(nh, 2.0, dtype)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return w


# ---------------------------------------------------------------------------
# notching helpers
# ---------------------------------------------------------------------------

def notch_bin_mask(
    n: int,
    fs: float,
    ignored_frequency_peaks: Optional[Sequence[float]] = None,
    ignore_harmonics: bool = False,
    coupling: str = "AC",
) -> np.ndarray:
    """Boolean mask [n] — True where the frequency bin is KEPT.

    For each ignored frequency, the nearest positive- and negative-frequency
    bins are dropped; with ``ignore_harmonics``, every integer multiple up to
    Nyquist is dropped too. With ``coupling='AC'`` (default, matching qetpy
    OFBase / processing_data.py:252-255) DC is dropped; ``'DC'`` keeps it.
    """
    keep = np.ones(n, dtype=bool)
    if str(coupling).upper() != "DC":
        keep[0] = False
    if not ignored_frequency_peaks:
        return keep
    freqs = np.fft.fftfreq(n, d=1.0 / fs)
    nyq = fs / 2.0
    for f0 in ignored_frequency_peaks:
        f0 = abs(float(f0))
        if f0 <= 0:
            continue
        targets = [f0]
        if ignore_harmonics:
            k = 2
            while k * f0 <= nyq:
                targets.append(k * f0)
                k += 1
        for ft in targets:
            for sign in (1.0, -1.0):
                idx = int(np.argmin(np.abs(freqs - sign * ft)))
                keep[idx] = False
                # drop the mirror partner too: a spectral line in REAL
                # data lives at ±f, and an asymmetric drop (possible
                # when ft falls exactly between bins and the argmin
                # tie-breaks differently for ±ft) would break the
                # J(−f) = J(f)* symmetry every half-spectrum
                # kernel folds over
                keep[(n - idx) % n] = False
    return keep


# ---------------------------------------------------------------------------
# 1x1 bank
# ---------------------------------------------------------------------------

class OF1x1Bank(NamedTuple):
    """Stacked single-channel OF precompute over S (channel, template) slots.

    All arrays are host numpy float64/complex128; use :meth:`as_dtype` to get
    device-precision copies. N = nb_samples.
    """

    s_fft: np.ndarray      # [S, N] complex — FFT of templates
    denom_inv: np.ndarray  # [S, N] real — 1/(N·fs·J), 0 at DC/notched bins
    phi: np.ndarray        # [S, N] complex — conj(s_fft)·denom_inv
    norm: np.ndarray       # [S] real — Σ Re(phi·s_fft)
    templates: np.ndarray  # [S, N] real — time-domain templates (for salting etc.)
    psd: np.ndarray        # [S, N] real — two-sided PSDs
    fs: float
    pretrigger: int

    @property
    def nbins(self) -> int:
        return self.s_fft.shape[-1]

    @property
    def nslots(self) -> int:
        return self.s_fft.shape[0]

    @property
    def resolution(self) -> np.ndarray:
        """Expected amplitude resolution σ_A = 1/sqrt(norm) per slot."""
        return 1.0 / np.sqrt(self.norm)

    def as_dtype(self, real_dtype=np.float32):
        """Return a copy cast for device use (float32/complex64 by default)."""
        cplx = np.complex64 if real_dtype == np.float32 else np.complex128
        return OF1x1Bank(
            s_fft=self.s_fft.astype(cplx),
            denom_inv=self.denom_inv.astype(real_dtype),
            phi=self.phi.astype(cplx),
            norm=self.norm.astype(real_dtype),
            templates=self.templates.astype(real_dtype),
            psd=self.psd.astype(real_dtype),
            fs=self.fs,
            pretrigger=self.pretrigger,
        )

    def to_device(self, real_dtype=np.float32) -> dict:
        """Pack the bank into a real-only pytree for jit. Rejoin with
        :func:`device_bank_1x1` inside the jitted function.

        Includes half-spectrum (rfft) views — the hot kernels work on the
        N//2+1 non-negative-frequency bins with per-bin weights
        (1, 2, …, 2, 1) so only half the FFT work is done per event.
        """
        n = self.nbins
        nh = n // 2 + 1
        bin_w = half_bin_weights(n)
        return {
            "phi": split_complex(self.phi, real_dtype),
            "s_fft": split_complex(self.s_fft, real_dtype),
            "denom_inv": self.denom_inv.astype(real_dtype),
            "norm": self.norm.astype(real_dtype),
            "phi_h": split_complex(self.phi[:, :nh], real_dtype),
            "s_fft_h": split_complex(self.s_fft[:, :nh], real_dtype),
            "denom_inv_h": self.denom_inv[:, :nh].astype(real_dtype),
            "bin_w": bin_w.astype(real_dtype),
        }


def make_of1x1_bank(
    templates: np.ndarray,
    psds: np.ndarray,
    fs: float,
    pretrigger: int,
    integralnorm: bool = False,
    ignored_frequency_peaks: Optional[Sequence[float]] = None,
    ignore_harmonics: bool = False,
    coupling: str = "AC",
) -> OF1x1Bank:
    """Build a stacked 1x1 OF bank.

    Parameters
    ----------
    templates : [S, N] (or [N]) time-domain templates, peak-normalized.
    psds : [S, N] (or [N]) two-sided PSDs in A²/Hz. May contain inf (treated
        as a notch at that bin).
    integralnorm : normalize template FFT by its DC component so amplitudes
        come out in integral units (OFBase add_template option,
        processing_data.py:331-334).
    """
    templates = np.atleast_2d(np.asarray(templates, dtype=np.float64))
    psds = np.atleast_2d(np.asarray(psds, dtype=np.float64))
    if psds.shape != templates.shape:
        if psds.shape[0] == 1:
            psds = np.broadcast_to(psds, templates.shape).copy()
        elif templates.shape[0] == 1:
            templates = np.broadcast_to(templates, psds.shape).copy()
        else:
            raise ValueError(
                f"template shape {templates.shape} != psd shape {psds.shape}"
            )
    s, n = templates.shape

    s_fft = np.fft.fft(templates, axis=-1)
    if integralnorm:
        dc = s_fft[:, :1].real.copy()
        dc[dc == 0] = 1.0
        s_fft = s_fft / dc

    keep = notch_bin_mask(n, fs, ignored_frequency_peaks, ignore_harmonics,
                          coupling=coupling)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom_inv = 1.0 / (n * fs * psds)
    denom_inv[~np.isfinite(denom_inv)] = 0.0
    denom_inv *= keep[None, :]

    phi = np.conj(s_fft) * denom_inv
    norm = np.real(np.sum(phi * s_fft, axis=-1))

    return OF1x1Bank(
        s_fft=s_fft,
        denom_inv=denom_inv,
        phi=phi,
        norm=norm,
        templates=templates,
        psd=psds,
        fs=float(fs),
        pretrigger=int(pretrigger),
    )


# ---------------------------------------------------------------------------
# NxM bank (multi-channel, multi-template)
# ---------------------------------------------------------------------------

class OFNxMBank(NamedTuple):
    """Multi-channel (N chans) multi-template (M amps) OF precompute.

    Frequency-domain shapes use C = n channels, M = m templates, N = samples.
    """

    s_fft: np.ndarray      # [C, M, N] complex
    icsd: np.ndarray       # [N, C, C] complex — inverse CSD per frequency
                           # (zeroed at dropped bins)
    phi: np.ndarray        # [C, M, N] complex — (J⁻¹ s̃*)/(N·fs)
    w_matrix: np.ndarray   # [M, M] real — weight matrix W
    iw_matrix: np.ndarray  # [M, M] real — W⁻¹
    templates: np.ndarray  # [C, M, N] real
    csd: np.ndarray        # [C, C, N] complex two-sided CSD
    fs: float
    pretrigger: int

    @property
    def nbins(self) -> int:
        return self.s_fft.shape[-1]

    @property
    def nchans(self) -> int:
        return self.s_fft.shape[0]

    @property
    def ntmps(self) -> int:
        return self.s_fft.shape[1]

    @property
    def resolution(self) -> np.ndarray:
        """Expected amplitude resolutions sqrt(diag(W⁻¹)) — matches the
        trigger resolution definition (core/oftrigger.py:499)."""
        return np.sqrt(np.diag(self.iw_matrix))

    def to_device(self, real_dtype=np.float32) -> dict:
        """Real-only pytree for jit transfer; rejoin with device_bank_nxm."""
        return {
            "phi": split_complex(self.phi, real_dtype),
            "s_fft": split_complex(self.s_fft, real_dtype),
            "icsd": split_complex(self.icsd, real_dtype),
            "w_matrix": self.w_matrix.astype(real_dtype),
            "iw_matrix": self.iw_matrix.astype(real_dtype),
        }

    def as_dtype(self, real_dtype=np.float32):
        cplx = np.complex64 if real_dtype == np.float32 else np.complex128
        return OFNxMBank(
            s_fft=self.s_fft.astype(cplx),
            icsd=self.icsd.astype(cplx),
            phi=self.phi.astype(cplx),
            w_matrix=self.w_matrix.astype(real_dtype),
            iw_matrix=self.iw_matrix.astype(real_dtype),
            templates=self.templates.astype(real_dtype),
            csd=self.csd.astype(cplx),
            fs=self.fs,
            pretrigger=self.pretrigger,
        )


class DeviceBank1x1(NamedTuple):
    """Complex-joined 1x1 bank view, valid only inside a jitted function."""

    phi: "jnp.ndarray"
    s_fft: "jnp.ndarray"
    denom_inv: "jnp.ndarray"
    norm: "jnp.ndarray"


def device_bank_1x1(dev: dict) -> DeviceBank1x1:
    """Rejoin a to_device()-packed 1x1 bank into complex arrays (call inside
    jit)."""
    return DeviceBank1x1(
        phi=join_complex(dev["phi"]),
        s_fft=join_complex(dev["s_fft"]),
        denom_inv=dev["denom_inv"],
        norm=dev["norm"],
    )


class DeviceBank1x1Half(NamedTuple):
    """Half-spectrum (rfft) 1x1 bank view for the fast kernels."""

    phi: "jnp.ndarray"        # [S, N//2+1] complex
    s_fft: "jnp.ndarray"      # [S, N//2+1] complex
    denom_inv: "jnp.ndarray"  # [S, N//2+1]
    norm: "jnp.ndarray"       # [S]
    bin_w: "jnp.ndarray"      # [N//2+1] — 1 at DC/Nyquist, 2 elsewhere


def device_bank_1x1_half(dev: dict) -> DeviceBank1x1Half:
    return DeviceBank1x1Half(
        phi=join_complex(dev["phi_h"]),
        s_fft=join_complex(dev["s_fft_h"]),
        denom_inv=dev["denom_inv_h"],
        norm=dev["norm"],
        bin_w=dev["bin_w"],
    )


def _reshape_template_3d(template: np.ndarray) -> np.ndarray:
    """Accept [N], [1,N], [N,1], or [C,M,N] and return [C,M,N]
    (shape rules mirror core/oftrigger.py:410-427)."""
    template = np.asarray(template, dtype=np.float64)
    if template.ndim == 1:
        return template[None, None, :]
    if template.ndim == 2:
        if template.shape[0] == 1:
            return template[None, :, :].reshape(1, 1, -1)
        if template.shape[1] == 1:
            return template.T.reshape(1, 1, -1)
        raise ValueError(
            f"ambiguous 2D template shape {template.shape}; expected "
            "(C, M, samples), (samples,), (1, samples) or (samples, 1)"
        )
    if template.ndim == 3:
        return template
    raise ValueError(f"bad template ndim: {template.ndim}")


def _reshape_csd_3d(csd: np.ndarray) -> np.ndarray:
    """Accept [N], [1,N], [N,1], or [C,C,N] and return [C,C,N]."""
    csd = np.asarray(csd)
    if csd.ndim == 1:
        return csd[None, None, :].astype(np.complex128)
    if csd.ndim == 2:
        if csd.shape[0] == 1:
            return csd.reshape(1, 1, -1).astype(np.complex128)
        if csd.shape[1] == 1:
            return csd.T.reshape(1, 1, -1).astype(np.complex128)
        raise ValueError(f"ambiguous 2D csd shape {csd.shape}")
    if csd.ndim == 3:
        return csd.astype(np.complex128)
    raise ValueError(f"bad csd ndim: {csd.ndim}")


class DeviceBankNxM(NamedTuple):
    """Complex-joined NxM bank view, valid only inside a jitted function."""

    phi: "jnp.ndarray"
    s_fft: "jnp.ndarray"
    icsd: "jnp.ndarray"
    w_matrix: "jnp.ndarray"
    iw_matrix: "jnp.ndarray"


def device_bank_nxm(dev: dict) -> DeviceBankNxM:
    return DeviceBankNxM(
        phi=join_complex(dev["phi"]),
        s_fft=join_complex(dev["s_fft"]),
        icsd=join_complex(dev["icsd"]),
        w_matrix=dev["w_matrix"],
        iw_matrix=dev["iw_matrix"],
    )


def make_ofnxm_bank(
    template: np.ndarray,
    csd: np.ndarray,
    fs: float,
    pretrigger: int,
    ignored_frequency_peaks: Optional[Sequence[float]] = None,
    ignore_harmonics: bool = False,
    coupling: str = "AC",
) -> OFNxMBank:
    """Build an NxM optimal-filter bank from templates [C,M,N] and CSD [C,C,N].

    This is the precompute behind both the NxM feature extractors
    (core/algorithms.py:141-274) and the continuous-data trigger
    (core/oftrigger.py:467-499).
    """
    tmpl = _reshape_template_3d(template)
    csd3 = _reshape_csd_3d(csd)
    c, m, n = tmpl.shape
    if csd3.shape != (c, c, n):
        raise ValueError(f"csd shape {csd3.shape} != ({c},{c},{n})")

    s_fft = np.fft.fft(tmpl, axis=-1)  # [C, M, N]

    keep = notch_bin_mask(n, fs, ignored_frequency_peaks, ignore_harmonics,
                          coupling=coupling)

    # invert CSD per kept frequency; dropped bins get a zero inverse
    csd_f = np.moveaxis(csd3, -1, 0)  # [N, C, C]
    icsd = np.zeros_like(csd_f)
    kept_idx = np.where(keep)[0]
    icsd[kept_idx] = np.linalg.inv(csd_f[kept_idx])

    # phi[c, i, k] = conj(J_k⁻¹ s̃)[c, i] / (N·fs): the numerator
    # q_i = Σ_{c,k} phi[c,i,k]·ṽ[c,k] must equal s̃_i† J⁻¹ ṽ, which
    # requires the CONJUGATE of J⁻¹s̃ — J⁻¹·conj(s̃) transposes the
    # inverse CSD and biases amplitudes whenever the cross-channel terms
    # carry frequency-dependent phase (regression:
    # tests/test_ofnxm.py::test_exact_recovery_phase_correlated_csd)
    s_fft_f = np.moveaxis(s_fft, -1, 0)  # [N, C, M]
    phi_f = np.conj(np.einsum("kab,kbm->kam", icsd, s_fft_f)) / (n * fs)
    phi = np.moveaxis(phi_f, 0, -1)  # [C, M, N]

    # W[i, j] = Re Σ_k s̃[:, i, k]† J_k⁻¹ s̃[:, j, k] / (N·fs)
    w = np.real(np.einsum("kci,kcj->ij", np.conj(s_fft_f),
                          np.einsum("kab,kbm->kam", icsd, s_fft_f))) / (n * fs)
    iw = np.linalg.inv(w)

    return OFNxMBank(
        s_fft=s_fft,
        icsd=icsd,
        phi=phi,
        w_matrix=w,
        iw_matrix=iw,
        templates=tmpl,
        csd=csd3,
        fs=float(fs),
        pretrigger=int(pretrigger),
    )
