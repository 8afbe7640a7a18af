"""Continuous-trace optimal-filter triggering + coincidence event building.

Mirrors the reference's examples/trigger/optimal_filter_trigger.ipynb and
event_builder.ipynb (detprocess OptimumFilterTrigger + EventBuilder:
core/oftrigger.py, core/eventbuilder.py) — here the FIR, Δχ² and pileup
merge run as one jitted device kernel over batches of continuous events
(ops/trigger.py), and the coincidence merge happens in
pipelines/triggers.py.

Run:  python examples/trigger/optimal_filter_trigger.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np
import yaml

from detprocess_jax import Noise, TriggerProcessing
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse

FS = 1.25e6
NT, PRETRIG = 4096, 1024
L = 625_000
CHANNELS = ["Mv2301", "Mv2302"]


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="trigger_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6

    # two continuous events; a coincident pair lands on both channels at
    # the same time (one physics event seen by two sensors) plus two
    # single-channel pulses and a pileup pair
    traces = rng.standard_normal((2, len(CHANNELS), L)) * sigma
    coincident_at = 200_000
    for ch in range(2):
        traces[0, ch, coincident_at - PRETRIG:
               coincident_at - PRETRIG + NT] += 50e-6 * tmpl
    traces[0, 0, 400_000 - PRETRIG:400_000 - PRETRIG + NT] += 40e-6 * tmpl
    traces[1, 1, 150_000 - PRETRIG:150_000 - PRETRIG + NT] += 45e-6 * tmpl
    # pileup pair within the merge window → ONE trigger at the larger
    traces[1, 0, 300_000 - PRETRIG:300_000 - PRETRIG + NT] += 30e-6 * tmpl
    traces[1, 0, 300_060 - PRETRIG:300_060 - PRETRIG + NT] += 60e-6 * tmpl

    RawWriter(os.path.join(out_dir, "raw"), "I1_D20260816_T120000", FS,
              CHANNELS).write_dump(traces, dump_num=1)
    raw_files = sorted(os.path.join(out_dir, "raw", f)
                       for f in os.listdir(os.path.join(out_dir, "raw")))

    # filter file: PSD from randoms + the trigger template
    noise = Noise(raw_files, verbose=False)
    noise.generate_randoms(random_rate=40.0, seed=1,
                           min_separation_msec=5.0,
                           edge_exclusion_msec=5.0)
    noise.calc_psd(CHANNELS, trace_length_samples=NT,
                   pretrigger_length_samples=PRETRIG)
    for c in CHANNELS:
        noise.set_template(c, tmpl, FS, pretrigger_length_samples=PRETRIG)
    filter_path = os.path.join(out_dir, "filter.h5")
    noise.save_hdf5(filter_path)

    config = {"trigger": {
        "coincident_window_msec": 0.05,
        **{c: {"run": True, "template_tag": "default",
               "threshold_sigma": 8.0, "pileup_window_msec": 0.5}
           for c in CHANNELS}}}
    cfg = os.path.join(out_dir, "trigger.yaml")
    yaml.safe_dump(config, open(cfg, "w"))

    trig = TriggerProcessing(raw_files, cfg, filter_data=filter_path,
                             verbose=True)
    df = trig.process(lgc_save=True,
                      output_path=os.path.join(out_dir, "trigger"))

    print(f"\n{len(df)} merged triggers")
    cols = ["trigger_index", "trigger_channel", "trigger_delta_chi2",
            "event_number"]
    print(df[cols].to_string(index=False))

    # the coincident pair merged into one event with both channels
    co = df[np.abs(df["trigger_index"] - coincident_at) < 10]
    assert len(co) == 1, "coincidence should merge to one event"
    # the pileup pair merged to ONE trigger (the combined Δχ² peak sits
    # between the two overlapping pulses)
    pu = df[np.abs(df["trigger_index"] - 300_030) < 100]
    assert len(pu) == 1
    print("\ncoincidence + pileup semantics verified")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
