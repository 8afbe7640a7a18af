"""Noise pipeline: PSD/CSD estimation from randoms → filter file.

Replacement for the reference Noise class (detprocess/core/noise.py):
sample randoms from continuous data (pipelines.randoms), read the windowed
traces, apply automated quality cuts (ops.autocuts), estimate two-sided
PSDs/CSDs on device (ops.spectral / parallel.mesh for multi-chip psum),
and store the results in a FilterData store.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np
import pandas as pd

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import open_reader
from detprocess_jax.ops import autocuts as cuts
from detprocess_jax.ops import spectral
from detprocess_jax.pipelines.randoms import Randoms


def _device_float_dtype(dtype):
    """float64 when x64 is enabled (CPU golden runs), else float32 —
    avoids jax's dtype truncation warning."""
    if dtype is not None:
        return dtype
    import jax
    return np.float64 if jax.config.jax_enable_x64 else np.float32


class Noise(FilterData):
    """PSD/CSD estimation driver (core/noise.py:52-970)."""

    def __init__(self, raw_files: Sequence[str] | str | None = None,
                 verbose: bool = True):
        from detprocess_jax.utils import jaxcache
        jaxcache.enable()
        super().__init__(verbose=verbose)
        self._raw_files = raw_files
        self._reader = (open_reader(raw_files) if raw_files is not None
                        else None)
        self._randoms_df: Optional[pd.DataFrame] = None
        self._traces: Optional[np.ndarray] = None
        self._trace_channels = None
        self._offset: dict = {}
        self._fs: Optional[float] = None

    # ------------------------------------------------------------------
    def set_randoms(self, randoms_df: pd.DataFrame):
        """Use an existing randoms dataframe (core/noise.py:91)."""
        self._randoms_df = randoms_df

    def clear_randoms(self):
        """Drop randoms + derived per-channel state, keep the filter-data
        store (core/noise.py:74-89)."""
        self._randoms_df = None
        self._traces = None
        self._trace_channels = None
        self._offset = {}
        self._fs = None

    def get_sample_rate(self) -> Optional[float]:
        """Sample rate in Hz; needs calc_psd/calc_csd first
        (core/noise.py:50-56)."""
        return self._fs

    def get_offset(self, channel: str) -> Optional[float]:
        """Per-channel DC offset computed during calc_psd — the average
        over kept randoms of each trace's median (core/noise.py:59-72,
        :349). None (with a warning) before calc_psd."""
        if channel not in self._offset:
            print(f"WARNING: No offset available for channel {channel}. "
                  "You need to calculate psd first! Returning None.")
            return None
        return self._offset[channel]

    def generate_randoms(self, random_rate: Optional[float] = None,
                         nrandoms: Optional[int] = None,
                         min_separation_msec: float = 100.0,
                         edge_exclusion_msec: float = 50.0,
                         seed: Optional[int] = None) -> pd.DataFrame:
        """Sample randoms from the continuous data (core/noise.py:152)."""
        if self._raw_files is None:
            raise ValueError("raw data required to generate randoms")
        randoms = Randoms(self._raw_files, verbose=self._verbose)
        self._randoms_df = randoms.process(
            random_rate=random_rate, nrandoms=nrandoms,
            min_separation_msec=min_separation_msec,
            edge_exclusion_msec=edge_exclusion_msec, seed=seed)
        return self._randoms_df

    def _get_traces(self, channels, trace_length_samples,
                    pretrigger_length_samples):
        if self._randoms_df is None:
            raise ValueError("no randoms available — call generate_randoms "
                             "or set_randoms first")
        randoms = Randoms(self._raw_files, verbose=False)
        traces = randoms.read_random_traces(
            self._randoms_df, trace_length_samples,
            pretrigger_length_samples, channels=channels)
        return traces

    # ------------------------------------------------------------------
    @staticmethod
    def _mesh_mean_spectrum(kind, kept, fs, window, mesh):
        """Cross-chip PSD/CSD mean via the parallel.mesh psum kernels.

        Zero rows pad the batch to a device-count multiple; zeros add
        nothing to the psum, so scaling the (padded-count) mean by
        padded/true restores the exact estimate. The window is applied
        host-side with its power normalization folded into the scale.
        """
        from detprocess_jax.parallel import mesh as pmesh

        scale = 1.0
        n = kept.shape[-1]
        if window == "hann":
            w = np.hanning(n)
            scale = float(1.0 / np.mean(w**2))
            kept = kept * jnp.asarray(w, kept.dtype)
        elif window is not None:
            raise ValueError(f"unknown window: {window}")
        b = kept.shape[0]
        padn = (-b) % mesh.devices.size
        if padn:
            kept = jnp.concatenate(
                [kept, jnp.zeros((padn,) + kept.shape[1:], kept.dtype)])
        scale *= (b + padn) / b
        sharded = pmesh.shard_batch(mesh, kept)
        if kind == "psd":
            return np.asarray(pmesh.sharded_psd(mesh, fs)(sharded)) * scale
        out = np.asarray(pmesh.sharded_csd(mesh, fs)(sharded)) * scale
        return out[..., 0] + 1j * out[..., 1]

    def calc_psd(self, channels: Sequence[str] | str,
                 trace_length_samples: Optional[int] = None,
                 pretrigger_length_samples: Optional[int] = None,
                 nsigma_cut: float = 2.5,
                 tag: str = "default",
                 window: Optional[str] = None,
                 dtype=None,
                 mesh=None):
        """Estimate per-channel two-sided PSDs from randoms with autocuts
        (core/noise.py:216-373) and store them (``psd_{tag}``).

        ``mesh``: optional jax Mesh — the kept randoms shard over the
        devices and the spectral mean reduces with one psum
        (parallel.mesh.sharded_psd)."""
        if isinstance(channels, str):
            channels = [channels]
        md = self._reader.get_metadata()
        fs = float(md["sample_rate"])
        n = trace_length_samples or int(md["nb_samples"])
        p = (pretrigger_length_samples
             if pretrigger_length_samples is not None else n // 2)

        # resolve +/- channel combinations into weighted trace sums
        # (reference Noise supports combined channels, core/noise.py:91-215)
        from detprocess_jax.utils import channels as chutils

        reader_channels = self._reader.channels
        combos = []
        for chan in channels:
            subs, weights = chutils.channel_combination_weights(
                chan, reader_channels)
            combos.append((chan, subs, weights))
        needed = sorted({s for _, subs, _ in combos for s in subs},
                        key=reader_channels.index)

        dtype = _device_float_dtype(dtype)
        traces = self._get_traces(needed, n, p)         # [B, C, N]
        if traces.size == 0:
            raise ValueError("no traces available for PSD estimation")
        for chan, subs, weights in combos:
            tr_np = sum(w * traces[:, needed.index(s), :]
                        for s, w in zip(subs, weights))
            tr = jnp.asarray(tr_np, dtype)
            mask = np.asarray(cuts.autocuts_noise(tr, nsigma=nsigma_cut))
            if not mask.any():
                raise ValueError(
                    f"autocuts rejected all {len(mask)} randoms for "
                    f"channel {chan} (nsigma_cut={nsigma_cut}) — a PSD "
                    "from zero traces would be all-NaN and poison every "
                    "downstream OF weight; loosen the cut or inspect the "
                    "data")
            kept = tr[jnp.asarray(np.where(mask)[0])]
            # per-channel DC offset: average over kept randoms of the
            # per-trace median (core/noise.py:349)
            self._offset[chan] = float(
                np.average(np.median(tr_np[mask], axis=-1)))
            self._fs = fs
            psd = (np.asarray(spectral.welch_psd(kept, fs, window=window))
                   if mesh is None
                   else self._mesh_mean_spectrum("psd", kept, fs, window,
                                                 mesh))
            self.set_psd(chan, psd, fs, tag=tag, metadata={
                "nb_randoms": int(mask.sum()),
                "nb_randoms_total": int(len(mask)),
                "nb_pretrigger_samples": p,
            })
        return self

    def calc_csd(self, channels: Sequence[str],
                 trace_length_samples: Optional[int] = None,
                 pretrigger_length_samples: Optional[int] = None,
                 nsigma_cut: float = 2.5,
                 tag: str = "default",
                 window: Optional[str] = None,
                 dtype=None,
                 mesh=None):
        """Estimate the CSD matrix for a channel list and store it under
        the compound channel 'c1|c2|...' (core/noise.py:374-500).

        ``mesh``: optional jax Mesh — randoms shard over the devices and
        the cross-spectral mean reduces with one psum
        (parallel.mesh.sharded_csd)."""
        md = self._reader.get_metadata()
        fs = float(md["sample_rate"])
        n = trace_length_samples or int(md["nb_samples"])
        p = (pretrigger_length_samples
             if pretrigger_length_samples is not None else n // 2)

        dtype = _device_float_dtype(dtype)
        traces = self._get_traces(list(channels), n, p)  # [B, C, N]
        if traces.size == 0:
            raise ValueError("no traces available for CSD estimation")
        tr = jnp.asarray(traces, dtype)
        mask = np.asarray(cuts.autocuts_noise(tr, nsigma=nsigma_cut))
        if not mask.any():
            raise ValueError(
                f"autocuts rejected all {len(mask)} randoms for CSD "
                f"estimation (nsigma_cut={nsigma_cut})")
        kept = tr[jnp.asarray(np.where(mask)[0])]
        self._fs = fs
        if mesh is None:
            csd = np.asarray(spectral.welch_csd(kept, fs, window=window))
        else:
            csd = self._mesh_mean_spectrum("csd", kept, fs, window, mesh)
        self.set_csd(list(channels), csd, fs, tag=tag, metadata={
            "nb_randoms": int(mask.sum()),
            "nb_randoms_total": int(len(mask)),
            "nb_pretrigger_samples": p,
        })
        return self
