"""Template builder + FilterBuilder facade.

Replacement for detprocess/core/template.py and core/filterbuilder.py:
analytic 2/3/4-pole template creation, average-pulse templates from events,
power-domain templates via dPdI, and a facade bundling Noise + Template +
DIDVAnalysis over one shared FilterData store.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.models import didv as didv_models
from detprocess_jax.models import pulse


class Template(FilterData):
    """Template creation/storage (core/template.py:30-447)."""

    def create_template(self, channels, sample_rate: float,
                        trace_length_samples: Optional[int] = None,
                        trace_length_msec: Optional[float] = None,
                        pretrigger_length_samples: Optional[int] = None,
                        pretrigger_length_msec: Optional[float] = None,
                        A: float = 1.0, B: Optional[float] = None,
                        C: Optional[float] = None,
                        tau_r: Optional[float] = None,
                        tau_f1: Optional[float] = None,
                        tau_f2: Optional[float] = None,
                        tau_f3: Optional[float] = None,
                        tag: str = "default"):
        """Analytic 2/3/4-pole template (core/template.py:327-401); pole
        count inferred from which of A/B/C are provided."""
        if trace_length_samples is None:
            if trace_length_msec is None:
                raise ValueError("trace length required")
            trace_length_samples = int(round(
                trace_length_msec * 1e-3 * sample_rate))
        if pretrigger_length_samples is None:
            if pretrigger_length_msec is None:
                raise ValueError("pretrigger length required")
            pretrigger_length_samples = int(round(
                pretrigger_length_msec * 1e-3 * sample_rate))
        if C is not None and B is None:
            raise ValueError(
                "C (4th-pole amplitude) requires B: pulse.make_template "
                "dispatches on B and would silently build a two-pole "
                "template while the metadata claimed more poles")
        template = pulse.make_template(
            sample_rate, trace_length_samples, pretrigger_length_samples,
            A=A, B=B, C=C, tau_r=tau_r, tau_f1=tau_f1, tau_f2=tau_f2,
            tau_f3=tau_f3)
        poles = 2 + (B is not None) + (C is not None)
        md = {"nb_poles": poles, "A": A, "tau_r": tau_r, "tau_f1": tau_f1}
        if B is not None:
            md.update({"B": B, "tau_f2": tau_f2})
        if C is not None:
            md.update({"C": C, "tau_f3": tau_f3})
        self.set_template(channels, template, sample_rate,
                          pretrigger_length_samples=pretrigger_length_samples,
                          tag=tag, metadata=md)
        return template

    def create_template_sum_twopoles(self, channels, amplitudes,
                                     rise_times, fall_times,
                                     sample_rate: float,
                                     trace_length_samples: int,
                                     pretrigger_length_samples: int,
                                     tag: str = "default"):
        """Sum-of-two-poles template (core/template.py:403-447)."""
        t = np.arange(trace_length_samples) / sample_rate
        t0 = pretrigger_length_samples / sample_rate
        template = pulse.make_template_sum_twopoles(
            t, amplitudes, rise_times, fall_times, t0=t0)
        self.set_template(channels, template, sample_rate,
                          pretrigger_length_samples=pretrigger_length_samples,
                          tag=tag,
                          metadata={"nb_sum_twopoles": len(amplitudes)})
        return template

    def calc_average_pulses(self, channels, traces: np.ndarray,
                            sample_rate: float,
                            pretrigger_length_samples: int,
                            normalize: bool = True,
                            tag: str = "default"):
        """Average-pulse template from selected events
        (core/template.py:113-191): baseline-subtracted mean, unit peak."""
        traces = np.asarray(traces, dtype=np.float64)
        base = traces[..., : pretrigger_length_samples // 2].mean(
            axis=-1, keepdims=True)
        avg = (traces - base).mean(axis=0)
        if normalize:
            peak = np.max(np.abs(avg), axis=-1, keepdims=True)
            peak[peak == 0] = 1.0
            avg = avg / peak
        if avg.ndim == 1:
            self.set_template(channels, avg, sample_rate,
                              pretrigger_length_samples=(
                                  pretrigger_length_samples), tag=tag)
        else:
            chans = [channels] if isinstance(channels, str) else channels
            for i, chan in enumerate(chans):
                self.set_template(chan, avg[i], sample_rate,
                                  pretrigger_length_samples=(
                                      pretrigger_length_samples), tag=tag)
        return avg

    def calc_power_template(self, channel: str, dpdi: np.ndarray,
                            sample_rate: float, tag: str = "default",
                            power_tag: str = "power"):
        """Current template → power-domain template via dPdI
        (core/template.py:192-254)."""
        tmpl, _, md = self.get_template(channel, tag=tag,
                                        return_metadata=True)
        power = didv_models.convert_template_to_power(tmpl, dpdi,
                                                      sample_rate)
        peak = np.max(np.abs(power))
        if peak > 0:
            power = power / peak
        self.set_template(channel, power, sample_rate,
                          pretrigger_length_samples=md[
                              "nb_pretrigger_samples"],
                          tag=power_tag, metadata={"domain": "power"})
        return power

    def fit_templates(self, channel: str, tag: str = "default",
                      fs: Optional[float] = None) -> dict:
        """Fit the stored template with a two-pole model
        (core/template.py:255-326) — returns (tau_r, tau_f, amplitude)."""
        import jax.numpy as jnp
        from detprocess_jax.ops import lm

        tmpl, time, md = self.get_template(channel, tag=tag,
                                           return_metadata=True)
        fs = fs or md.get("sample_rate")
        p = md.get("nb_pretrigger_samples", len(tmpl) // 2)
        t = np.arange(len(tmpl)) / fs
        t0 = p / fs

        def residual(params, t, y):
            tau_r, tau_f, amp = params
            tp = t - t0
            model = jnp.where(
                tp >= 0,
                amp * (jnp.exp(-tp / jnp.abs(tau_f))
                       - jnp.exp(-tp / jnp.abs(tau_r))), 0.0)
            return model - y

        res = lm.levenberg_marquardt(
            residual, jnp.asarray([20e-6, 200e-6, 1.0]),
            args=(jnp.asarray(t), jnp.asarray(tmpl)), max_iter=100)
        tau_r, tau_f, amp = np.abs(np.asarray(res.params))
        fit = {"tau_r": float(tau_r), "tau_f": float(tau_f),
               "amplitude": float(amp), "cost": float(res.cost)}
        # stored so get_template_in_current(use_fit=True) can rebuild the
        # smooth fitted pulse (core/template.py:255-298)
        self._set(channel, f"template_fit_{tag}", dict(fit), None)
        return fit

    # -- reference-parity surface (core/template.py:27-31, :299-323) ----
    def clear(self, channels=None, clear_filter_data: bool = False,
              tag: Optional[str] = None):
        """Drop stored templates (core/template.py:27-31). The
        reference's in-memory qetpy TemplateManager maps to the
        ``template_*`` entries of the filter-data store here;
        ``clear_filter_data`` additionally drops every other stored
        parameter (via clear_data)."""
        if clear_filter_data:
            self.clear_data(channels=channels, tag=tag)
            return
        chans = (list(self._filter_data) if channels is None
                 else [channels] if isinstance(channels, str)
                 else list(channels))
        for chan in chans:
            d = self._filter_data.get(chan)
            if not d:
                continue
            for key in list(d):
                if (key.startswith("template")
                        and (tag is None or tag in key)):
                    d.pop(key)

    def get_template_in_current(self, channels, use_fit: bool = True,
                                domain: str = "time",
                                return_metadata: bool = False,
                                tag: str = "default"):
        """Template(s) in TES-current units (core/template.py:299-306).
        ``use_fit`` rebuilds the smooth two-pole from a stored
        fit_templates result when available; ``domain='freq'`` returns
        the two-sided FFT."""
        chans = [channels] if isinstance(channels, str) else list(channels)
        out, mds = [], []
        for chan in chans:
            tmpl, _, md = self.get_template(chan, tag=tag,
                                            return_metadata=True)
            tmpl = np.asarray(tmpl)
            md = dict(md or {})
            if use_fit:
                try:
                    fit = self._get(chan, f"template_fit_{tag}")
                except (KeyError, ValueError):
                    fit = None
                if fit:
                    fs = float(md.get("sample_rate"))
                    p = int(md.get("nb_pretrigger_samples",
                                   len(tmpl) // 2))
                    t = np.arange(len(tmpl)) / fs - p / fs
                    tmpl = np.where(
                        t >= 0,
                        fit["amplitude"] * (np.exp(-t / fit["tau_f"])
                                            - np.exp(-t / fit["tau_r"])),
                        0.0)
                    md["from_fit"] = True
            if domain in ("freq", "fourier"):
                tmpl = np.fft.fft(tmpl)
            elif domain != "time":
                raise ValueError('domain should be "time" or "freq"')
            out.append(tmpl)
            mds.append(md)
        if isinstance(channels, str):
            out, mds = out[0], mds[0]
        if return_metadata:
            return out, mds
        return out

    def get_template_in_power(self, channels, dpdi=None, dpdi_freqs=None,
                              use_fit: bool = True, domain: str = "time",
                              return_metadata: bool = False,
                              tag: str = "default", dpdi_poles: int = 2,
                              dpdi_tag: str = "default"):
        """Template(s) converted to power via dPdI
        (core/template.py:308-319): pass ``dpdi`` explicitly or rely on
        the dPdI stored in the filter file."""
        chans = [channels] if isinstance(channels, str) else list(channels)
        out, mds = [], []
        for chan in chans:
            cur, md = self.get_template_in_current(
                chan, use_fit=use_fit, domain="time",
                return_metadata=True, tag=tag)
            fs = float(md.get("sample_rate"))
            chan_dpdi = dpdi
            if chan_dpdi is None:
                chan_dpdi, _ = self.get_dpdi(chan, dpdi_poles,
                                             tag=dpdi_tag)
            power = didv_models.convert_template_to_power(
                cur, np.asarray(chan_dpdi), fs)
            if domain in ("freq", "fourier"):
                power = np.fft.fft(power)
            elif domain != "time":
                raise ValueError('domain should be "time" or "freq"')
            out.append(power)
            mds.append(md)
        if isinstance(channels, str):
            out, mds = out[0], mds[0]
        if return_metadata:
            return out, mds
        return out

    @property
    def qp_template(self):
        """The template manager (core/template.py:321-323). There is no
        separate qetpy object in this package — the Template instance IS
        the manager; returned for drop-in attribute access."""
        return self


class FilterBuilder:
    """Facade over Noise + Template + DIDVAnalysis sharing one filter-data
    store (core/filterbuilder.py:7-82)."""

    def __init__(self, raw_files=None, verbose: bool = True):
        from detprocess_jax.pipelines.noise import Noise
        from detprocess_jax.pipelines.didv import DIDVAnalysis

        self.noise = Noise(raw_files, verbose=verbose)
        self.template = Template(verbose=verbose)
        self.didv = DIDVAnalysis(verbose=verbose)
        # share one underlying store
        shared = self.noise._filter_data
        self.template._filter_data = shared
        self.didv._filter_data = shared
        self._filter_data = shared

    def clear(self, channels=None, tag=None, clear_noise_state: bool = True,
              clear_template_state: bool = False,
              clear_didv_state: bool = True):
        """Clear the shared filter-data store and optionally the
        processors' transient state (core/filterbuilder.py:52-70)."""
        self.noise.clear_data(channels=channels, tag=tag)
        if clear_noise_state:
            self.noise.clear_randoms()
        if clear_template_state:
            self.template.clear(channels=channels, tag=tag)
        if clear_didv_state:
            self.didv.clear(channels=channels)

    def save_hdf5(self, path: str, overwrite: bool = True):
        self.noise.save_hdf5(path, overwrite=overwrite)

    def load_hdf5(self, path: str, overwrite: bool = False):
        self.noise.load_hdf5(path, overwrite=overwrite)
        return self

    def describe(self):
        self.noise.describe()
