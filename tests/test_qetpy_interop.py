"""Interop vs the REAL QETpy package (CI-only; importorskip locally).

The suite's reference parity runs against a transcribed oracle
(tests/reference_impl.py) because qetpy is not installable in the
offline build environment. This module closes the loop where a network
exists (the CI qetpy-interop job): it compares the actual ``qetpy``
package — the exact library the reference delegates its math to — both
against the transcribed oracle (validating the transcription) and
against this package's kernels (validating the product). Call patterns
mirror the reference's usage exactly:

  * qp.calc_psd(traces, fs=..., folded_over=False)
      — detprocess/core/noise.py:344
  * qp.OFBase(fs) + add_template/set_csd/calc_phi/update_signal
      + qp.OF1x1(...).calc(...) + get_result_nodelay/withdelay
      — detprocess/process/processing_data.py:278-770,
        detprocess/core/algorithms.py:300-560
"""

import os
import sys

import numpy as np
import pytest

qp = pytest.importorskip("qetpy")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from reference_impl import RefOF1x1  # noqa: E402

FS = 1.25e6
N = 4096
PRE = 1024


def _template():
    t = np.arange(N) / FS
    rise, fall = 20e-6, 200e-6
    start = PRE / FS
    tt = np.clip(t - start, 0, None)
    pulse = (1 - np.exp(-tt / rise)) * np.exp(-tt / fall)
    pulse[t < start] = 0.0
    return pulse / pulse.max()


def _psd():
    f = np.abs(np.fft.fftfreq(N, 1 / FS))
    f[0] = f[1]
    return 1e-20 * (1.0 + 100.0 / f)


def test_calc_psd_matches_ours():
    """qp.calc_psd (two-sided, boxcar) == ops.spectral.welch_psd."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from detprocess_jax.ops import spectral

    rng = np.random.default_rng(5)
    traces = rng.standard_normal((24, N)) * 3e-9
    freqs_qp, psd_qp = qp.calc_psd(traces, fs=FS, folded_over=False)
    psd_ours = np.asarray(spectral.welch_psd(traces, FS))
    np.testing.assert_allclose(psd_ours, psd_qp, rtol=1e-9)


def _qetpy_of1x1(template, psd, trace):
    """Run the real qetpy OF exactly as the reference pipeline does."""
    of_base = qp.OFBase(FS, verbose=False)
    of_base.add_template("chan1", template, template_tag="default",
                         pretrigger_samples=PRE, overwrite=True)
    of_base.set_csd("chan1", psd)
    if of_base.phi("chan1", "default") is None:
        of_base.calc_phi("chan1", "default")
    of_base.update_signal("chan1", trace, calc_fft=True)
    OF = qp.OF1x1(of_base=of_base, channel="chan1",
                  template_tag="default")
    OF.calc(lgc_fit_withdelay=True, lgc_fit_nodelay=True,
            lowchi2_fcutoff=10000)
    nod = OF.get_result_nodelay()        # amp, t0, chi2, lowchi2
    wd = OF.get_result_withdelay()       # amp, t0, chi2, lowchi2
    return nod, wd


def test_of1x1_matches_qetpy():
    """Real qetpy OF1x1 == the transcribed oracle (which the rest of
    the suite pins this package's kernels against) on amp/t0/chi2 for
    both the nodelay and the unconstrained-delay fit."""
    template, psd = _template(), _psd()
    rng = np.random.default_rng(11)
    trace = rng.standard_normal(N) * 3e-9 + 2e-6 * np.roll(template, 7)
    nod, wd = _qetpy_of1x1(template, psd, trace)

    ref = RefOF1x1(template, psd, FS, PRE)
    amp0, chi20, low0 = ref.fit_nodelay(trace, lowchi2_fcutoff=10000)
    ampd, t0d, chi2d, lowd = ref.fit_withdelay(trace,
                                               lowchi2_fcutoff=10000)

    np.testing.assert_allclose(nod[0], amp0, rtol=1e-8)
    np.testing.assert_allclose(nod[2], chi20, rtol=1e-8)
    np.testing.assert_allclose(wd[0], ampd, rtol=1e-8)
    np.testing.assert_allclose(wd[1], t0d, rtol=0, atol=0.6 / FS)
    np.testing.assert_allclose(wd[2], chi2d, rtol=1e-8)
