"""Independent, loop-style numpy implementation of the optimal-filter math.

This plays the role of the reference's QETpy numerics for golden tests (the
real QETpy is not installed here): written directly from the matched-filter
formulas, one event at a time, in float64 — deliberately *not* sharing code
with detprocess_jax so that agreement is meaningful. It is also used by
bench.py as the "single CPU core, per-event loop" baseline, standing in for
the reference's per-event processing path
(detprocess/process/features.py:533-851).
"""

from __future__ import annotations

import numpy as np


class RefOF1x1:
    """Per-event single-channel optimal filter (float64, one trace at a time)."""

    def __init__(self, template, psd, fs, pretrigger):
        self.n = len(template)
        self.fs = fs
        self.pretrigger = pretrigger
        self.s_fft = np.fft.fft(template)
        with np.errstate(divide="ignore"):
            self.denom_inv = 1.0 / (self.n * fs * np.asarray(psd, dtype=float))
        self.denom_inv[~np.isfinite(self.denom_inv)] = 0.0
        self.denom_inv[0] = 0.0
        self.phi = np.conj(self.s_fft) * self.denom_inv
        self.norm = np.real(np.sum(self.phi * self.s_fft))

    def chi2_nopulse(self, trace):
        v = np.fft.fft(trace)
        return float(np.sum(np.abs(v) ** 2 * self.denom_inv))

    def fit_nodelay(self, trace, lowchi2_fcutoff=None):
        v = np.fft.fft(trace)
        q = float(np.real(np.sum(self.phi * v)))
        amp = q / self.norm
        chi2 = self.chi2_nopulse(trace) - q * q / self.norm
        lowchi2 = None
        if lowchi2_fcutoff is not None:
            lowchi2 = self._lowchi2(v, amp, 0, lowchi2_fcutoff)
        return amp, chi2, lowchi2

    def fit_withdelay(self, trace, window=None, lowchi2_fcutoff=None):
        """window = (min_index, max_index) inclusive, absolute trace indices."""
        v = np.fft.fft(trace)
        qt = np.real(np.fft.ifft(self.phi * v)) * self.n
        q_abs = np.roll(qt, self.pretrigger)
        dchi2 = q_abs**2 / self.norm
        allowed = np.ones(self.n, dtype=bool)
        if window is not None:
            allowed[:] = False
            allowed[window[0] : window[1] + 1] = True
        i = int(np.argmax(np.where(allowed, dchi2, -np.inf)))
        amp = q_abs[i] / self.norm
        chi2 = self.chi2_nopulse(trace) - dchi2[i]
        t0 = (i - self.pretrigger) / self.fs
        lowchi2 = None
        if lowchi2_fcutoff is not None:
            lowchi2 = self._lowchi2(v, amp, i - self.pretrigger, lowchi2_fcutoff)
        return amp, t0, chi2, lowchi2

    def _lowchi2(self, v, amp, shift, fcutoff):
        f = np.fft.fftfreq(self.n, d=1.0 / self.fs)
        mask = np.abs(f) < fcutoff
        mask[0] = False
        k = np.arange(self.n)
        resid = v - amp * self.s_fft * np.exp(-2j * np.pi * k * shift / self.n)
        return float(np.sum(np.abs(resid) ** 2 * self.denom_inv * mask))


class RefOFNxM:
    """Per-event NxM optimal filter (loops over frequencies, float64)."""

    def __init__(self, templates, csd, fs, pretrigger):
        # templates [C, M, N]; csd [C, C, N]
        self.c, self.m, self.n = templates.shape
        self.fs = fs
        self.pretrigger = pretrigger
        self.s_fft = np.fft.fft(templates, axis=-1)
        self.icsd = np.zeros((self.n, self.c, self.c), dtype=complex)
        for k in range(1, self.n):
            self.icsd[k] = np.linalg.inv(csd[:, :, k])
        w = np.zeros((self.m, self.m))
        for k in range(1, self.n):
            sk = self.s_fft[:, :, k]  # [C, M]
            w += np.real(np.conj(sk).T @ self.icsd[k] @ sk)
        self.w = w / (self.n * fs)
        self.iw = np.linalg.inv(self.w)

    def fit_nodelay(self, traces):
        v = np.fft.fft(traces, axis=-1)  # [C, N]
        q = np.zeros(self.m)
        chi2_0 = 0.0
        for k in range(1, self.n):
            sk = self.s_fft[:, :, k]
            q += np.real(np.conj(sk).T @ self.icsd[k] @ v[:, k])
            chi2_0 += np.real(np.conj(v[:, k]) @ self.icsd[k] @ v[:, k])
        q /= self.n * self.fs
        chi2_0 /= self.n * self.fs
        amps = self.iw @ q
        chi2 = chi2_0 - q @ self.iw @ q
        return amps, chi2

    def fit_withdelay(self, traces, window=None):
        v = np.fft.fft(traces, axis=-1)
        chi2_0 = 0.0
        for k in range(1, self.n):
            chi2_0 += np.real(np.conj(v[:, k]) @ self.icsd[k] @ v[:, k])
        chi2_0 /= self.n * self.fs
        # q_i(d) via ifft
        integrand = np.zeros((self.m, self.n), dtype=complex)
        for k in range(1, self.n):
            sk = self.s_fft[:, :, k]
            integrand[:, k] = np.conj(sk).T @ self.icsd[k] @ v[:, k]
        q_t = np.real(np.fft.ifft(integrand, axis=-1)) * self.n / (self.n * self.fs)
        q_abs = np.roll(q_t, self.pretrigger, axis=-1)
        dchi2 = np.einsum("it,ij,jt->t", q_abs, self.iw, q_abs)
        allowed = np.ones(self.n, dtype=bool)
        if window is not None:
            allowed[:] = False
            allowed[window[0] : window[1] + 1] = True
        i = int(np.argmax(np.where(allowed, dchi2, -np.inf)))
        amps = self.iw @ q_abs[:, i]
        chi2 = chi2_0 - dchi2[i]
        t0 = (i - self.pretrigger) / self.fs
        return amps, t0, chi2


def ref_welch_psd(traces, fs):
    """Two-sided PSD, mean over traces (qetpy.calc_psd convention)."""
    n = traces.shape[-1]
    return np.mean(np.abs(np.fft.fft(traces, axis=-1)) ** 2, axis=0) / (n * fs)


def ref_welch_csd(traces, fs):
    """CSD [C, C, N] from traces [B, C, N]."""
    b, c, n = traces.shape
    v = np.fft.fft(traces, axis=-1)
    csd = np.einsum("bik,bjk->ijk", v, np.conj(v)) / b
    return csd / (n * fs)


def generate_noise(psd, fs, nevents, rng):
    """Generate stationary noise traces with a given two-sided PSD."""
    n = len(psd)
    scale = np.sqrt(np.asarray(psd) * fs * n)
    out = np.empty((nevents, n))
    for i in range(nevents):
        # white, Hermitian-symmetric unit spectrum (real input ensures ifft real)
        zf = np.fft.fft(rng.standard_normal(n)) / np.sqrt(n)
        out[i] = np.real(np.fft.ifft(zf * scale))
    return out


def generate_correlated_noise(csd, fs, nevents, rng):
    """Generate multi-channel noise with a given CSD [C, C, N]."""
    c, _, n = csd.shape
    # Cholesky per frequency (add tiny jitter for numerical safety)
    out = np.empty((nevents, c, n))
    chol = np.zeros((n, c, c), dtype=complex)
    for k in range(n):
        m = csd[:, :, k] + 1e-30 * np.eye(c)
        chol[k] = np.linalg.cholesky(m)
    for i in range(nevents):
        # white Hermitian-symmetric spectra per channel
        white = np.fft.fft(rng.standard_normal((c, n)), axis=-1)
        colored = np.einsum("kab,bk->ak", chol, white)
        out[i] = np.real(np.fft.ifft(colored * np.sqrt(fs), axis=-1))
    return out
