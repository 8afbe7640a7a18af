"""Noise generation: randoms from continuous data → PSD / CSD → filter file.

Mirrors the reference's examples/noise/noise_generation.ipynb
(detprocess Noise: core/noise.py) on synthetic data. PSD/CSD estimation
runs on device (ops/spectral) with converge-until-done autocuts.

Run:  python examples/noise/noise_generation.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np

from detprocess_jax import Noise
from detprocess_jax.io.rawdata import RawWriter

FS = 1.25e6
NT, PRETRIG = 4096, 1024
L = 625_000
CHANNELS = ["Mv2301", "Mv2302"]


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="noise_gen_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    # synthetic continuous raw data: white noise + a few glitches the
    # autocuts should remove
    sigma = 2e-6
    traces = rng.standard_normal((2, len(CHANNELS), L)) * sigma
    traces[0, 0, 100_000:100_200] += 50e-6        # glitch
    writer = RawWriter(os.path.join(out_dir, "raw"),
                       "I1_D20260816_T120000", FS, CHANNELS)
    writer.write_dump(traces, dump_num=1)
    raw_files = sorted(os.path.join(out_dir, "raw", f)
                       for f in os.listdir(os.path.join(out_dir, "raw")))

    noise = Noise(raw_files, verbose=True)
    # sample random trigger times (metadata only, like process/randoms.py)
    noise.generate_randoms(random_rate=60.0, seed=1,
                           min_separation_msec=5.0,
                           edge_exclusion_msec=5.0)

    # per-channel PSDs (+ compound sum/difference channels) and the CSD
    noise.calc_psd(CHANNELS + ["Mv2301+Mv2302", "Mv2301-Mv2302"],
                   trace_length_samples=NT,
                   pretrigger_length_samples=PRETRIG)
    noise.calc_csd(CHANNELS, trace_length_samples=NT,
                   pretrigger_length_samples=PRETRIG)

    psd, freqs = noise.get_psd("Mv2301")
    level = psd[10:].mean()
    print(f"PSD flat level {level:.3e} A^2/Hz "
          f"(theory {sigma**2 / FS:.3e})")
    assert 0.8 < level / (sigma**2 / FS) < 1.2

    csd, _ = noise.get_csd("Mv2301|Mv2302")
    print(f"CSD shape {csd.shape} (2x2x{NT})")

    path = os.path.join(out_dir, "noise_filter.h5")
    noise.save_hdf5(path)
    noise.describe()
    print(f"filter file → {path}")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
