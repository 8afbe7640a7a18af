"""End-to-end demo: synthetic raw data → filter file → salting → trigger →
feature extraction → dIdV analysis, with plots.

Run:  python examples/end_to_end_demo.py [output_dir]

This exercises the same flow as the reference's example notebooks
(examples/processing, examples/trigger, examples/noise, examples/iv_didv in
spice-herald/detprocess) on purely synthetic data.
"""

import os
import sys
import tempfile

import numpy as np
import yaml

from detprocess_jax import FilterData, Salting, TriggerProcessing, \
    FeatureProcessing, Noise, DIDVAnalysis
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse, tesnoise
from detprocess_jax.utils import plotting

FS = 1.25e6
NT, PRETRIG = 4096, 1024
L = 625_000          # 0.5 s continuous events
CHANNELS = ["Mv2301", "Mv2302"]


def make_raw_group(root, rng):
    """Synthesize a continuous-data group with hidden physics pulses."""
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    positions = {(0, 0): 150_000, (0, 1): 420_000, (1, 0): 300_000}
    traces = rng.standard_normal((2, len(CHANNELS), L)) * sigma
    for (ev, ch), pos in positions.items():
        traces[ev, ch, pos - PRETRIG:pos - PRETRIG + NT] += 40e-6 * tmpl
    writer = RawWriter(os.path.join(root, "raw"), "I1_D20260816_T120000",
                       FS, CHANNELS,
                       detector_config={c: {"tes_bias": 1e-4,
                                            "output_gain": 10.0}
                                        for c in CHANNELS})
    writer.write_dump(traces, dump_num=1)
    files = sorted(os.path.join(root, "raw", f)
                   for f in os.listdir(os.path.join(root, "raw")))
    return files, tmpl, sigma, positions


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="detprocess_jax_demo_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    print(f"demo output → {out_dir}")

    raw_files, tmpl, sigma, positions = make_raw_group(out_dir, rng)

    # ---- 1. filter file: PSD from randoms + template -------------------
    noise = Noise(raw_files, verbose=False)
    noise.generate_randoms(random_rate=40.0, seed=1,
                           min_separation_msec=5.0, edge_exclusion_msec=5.0)
    noise.calc_psd(CHANNELS, trace_length_samples=NT,
                   pretrigger_length_samples=PRETRIG)
    noise.calc_csd(CHANNELS, trace_length_samples=NT,
                   pretrigger_length_samples=PRETRIG)
    for chan in CHANNELS:
        noise.set_template(chan, tmpl, FS,
                           pretrigger_length_samples=PRETRIG)
    filter_path = os.path.join(out_dir, "filter.h5")
    noise.save_hdf5(filter_path)
    print("filter file written")

    # ---- 2. salting -----------------------------------------------------
    salting = Salting(filter_path, verbose=False)
    salting.generate_salt(raw_files, ["Mv2301"], energies=[100.0], nsalt=4,
                          energy_norm_ev_per_amp=4e6,
                          channel_fractions={"Mv2301": 1.0}, seed=2,
                          min_separation_msec=60.0,
                          edge_exclusion_msec=20.0)
    print(f"{len(salting.dataframe)} salts generated")

    # ---- 3. trigger ------------------------------------------------------
    config = {
        "trigger": {
            "coincident_window_msec": 0.1,
            **{c: {"run": True, "template_tag": "default",
                   "threshold_sigma": 8.0, "pileup_window_msec": 0.5}
               for c in CHANNELS},
        },
        "feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            **{c: {"of1x1_nodelay": {"run": True,
                                     "template_tag": "default"},
                   "of1x1_constrained": {"run": True,
                                         "template_tag": "default",
                                         "window_min_from_trig_usec": -50.0,
                                         "window_max_from_trig_usec": 50.0},
                   "baseline": {"run": True},
                   "integral": {"run": True}}
               for c in CHANNELS},
        },
    }
    cfg_path = os.path.join(out_dir, "process.yaml")
    yaml.safe_dump(config, open(cfg_path, "w"))

    trig = TriggerProcessing(raw_files, cfg_path, filter_data=filter_path,
                             verbose=False)
    trig.set_salting(salting.make_injector(CHANNELS))
    trigger_df = trig.process(lgc_save=True,
                              output_path=os.path.join(out_dir, "trigger"))
    print(f"{len(trigger_df)} triggers found "
          f"(3 physics + {len(salting.dataframe)} salts expected)")

    # ---- 4. features on triggered windows -------------------------------
    feat = FeatureProcessing(raw_files, cfg_path, filter_data=filter_path,
                             trigger_dataframe=trigger_df, verbose=False)
    feat.set_salting(salting.make_injector(CHANNELS))
    features = feat.process(batch_size=16,
                            lgc_save=True,
                            output_path=os.path.join(out_dir, "feature"))
    amp_cols = [c for c in features.columns if c.startswith("amp_of1x1_n")]
    print("feature table:", len(features), "rows;",
          f"recovered amps ≈ {features[amp_cols[0]].median():.3e} A")

    # ---- 5. dIdV analysis on synthetic square-wave data ------------------
    rl = 9e-3
    params = tesnoise.TESParams(r0=0.15, rl=rl, beta=2.0, l=10.0, L=4e-7,
                                tau0=1e-3, G=1e-10, tc=0.04, tload=0.03,
                                tb=0.02, i0=2e-6, squiddc=1e-11)
    period = int(FS / 100.0)
    n = period * 4
    t = np.arange(n)
    sq = np.where((t % period) < period // 2, 0.5, -0.5) * (2e-8 * 5e-3)
    freqs_full = np.fft.fftfreq(n, 1 / FS)
    resp = tesnoise.didv(params, np.where(freqs_full == 0, freqs_full[1],
                                          freqs_full))
    resp_t = np.real(np.fft.ifft(resp * np.fft.fft(sq)))
    didv_traces = (resp_t[None, :]
                   + rng.standard_normal((12, n)) * 2e-10)[:, None, :]
    didv_writer = RawWriter(os.path.join(out_dir, "didv"),
                            "I1_D20260816_T130000", FS, ["Mv2301"],
                            prefix="didv", data_type="didv")
    didv_writer.write_dump(didv_traces, dump_num=1)
    didv_files = sorted(os.path.join(out_dir, "didv", f)
                        for f in os.listdir(os.path.join(out_dir, "didv")))

    didv = DIDVAnalysis(verbose=False)
    didv.process_raw_data("Mv2301", didv_files, sgfreq=100.0, sgamp=2e-8,
                          rsh=5e-3)
    didv.dofit("Mv2301", poles=2)
    didv.set_ivsweep_results("Mv2301", {"r0": 0.15, "rp": 4e-3,
                                        "rshunt": 5e-3, "i0": 2e-6})
    didv.calc_smallsignal_params("Mv2301", poles=2)
    ssp = didv.get_smallsignal_params("Mv2301", 2)
    print(f"dIdV fit: beta = {ssp['beta']:.2f} ± {ssp['beta_err']:.2f}, "
          f"loop gain = {ssp['l']:.1f} ± {ssp['l_err']:.1f}")

    # ---- 6. plots ---------------------------------------------------------
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    plotting.plot_psd(noise, CHANNELS, ax=axes[0])
    plotting.plot_template(noise, "Mv2301", ax=axes[1])
    plotting.plot_didv_fit(didv.get_didv_data("Mv2301"),
                           didv.get_fit("Mv2301", 2), ax=axes[2])
    fig.tight_layout()
    png = os.path.join(out_dir, "demo_plots.png")
    fig.savefig(png, dpi=110)
    print(f"plots saved to {png}")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
