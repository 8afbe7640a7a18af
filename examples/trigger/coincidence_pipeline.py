"""Multi-channel coincidence triggering through the production pipeline.

Mirrors the reference's coincidence-mode processing (core/
eventbuilder.py:336-497 merge semantics via process/triggers.py): three
trigger channels on one raw stream, a coincident-window merge, and the
merged dataframe with per-channel suffixed columns. The batched drain
(pipelines/triggers.py drain_fast) vectorizes the whole merge — this
example also runs the per-event EventBuilder path and checks the two
produce identical frames, the same equality the suite pins
(tests/test_trigger_coincidence.py).

Flow:

    synthetic 3-channel raw data, pulses coincident across channels
      → TriggerProcessing(process.yaml) with coincident_window_msec
      → one dataframe row per merged coincidence, primary = max Δχ²,
        other channels' values in their suffixed columns

Run:  python examples/trigger/coincidence_pipeline.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np
import pandas as pd
import yaml

from detprocess_jax import FilterData, TriggerProcessing
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse

FS = 1.25e6
NT, PRETRIG = 512, 128
L = 250_000
CHANNELS = ["Mv2301", "Mv2302", "Mv2303"]
SERIES = "I1_D20260820_T090000"


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="coincidence_")
    raw_dir = os.path.join(out_dir, "raw")

    # --- synthetic data: amplitudes at ~10 matched-filter sigma so the
    # delta-chi2 runs stay narrow (loud pulses device-merge into one
    # wide group before the coincidence logic sees them)
    rng = np.random.default_rng(7)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=60e-6)
    traces = rng.standard_normal((4, 3, L)) * 1e-9

    def add(ev, ch, p, a):
        traces[ev, ch, p - PRETRIG:p - PRETRIG + NT] += a * tmpl

    for ev in range(4):
        # a 3-channel coincidence (chan1 biggest → primary) ...
        add(ev, 0, 60_000, 1.6e-9)
        add(ev, 1, 60_020, 1.35e-9)
        add(ev, 2, 60_040, 1.3e-9)
        # ... a 2-channel one (chan3 primary) ...
        add(ev, 1, 140_000, 1.4e-9)
        add(ev, 2, 140_030, 1.9e-9)
        # ... and an isolated single-channel pulse (never merged)
        add(ev, 0, 200_000, 1.5e-9)
    w = RawWriter(raw_dir, SERIES, FS, CHANNELS,
                  data_type="continuous", nb_pretrigger_samples=PRETRIG)
    w.write_dump(traces, dump_num=1)
    raw_files = sorted(os.path.join(raw_dir, f)
                       for f in os.listdir(raw_dir)
                       if f.endswith(".hdf5"))

    fd = FilterData(verbose=False)
    for c in CHANNELS:
        fd.set_template(c, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(c, np.full(NT, 1e-9 ** 2 / FS), FS)

    cfg = {"trigger": {c: {"run": True, "template_tag": "default",
                           "threshold_sigma": 7.0,
                           "pileup_window_msec": 0.04,
                           # window merge: triggers on DIFFERENT
                           # channels closer than this become one row
                           "coincident_window_msec": 0.16}
                       for c in CHANNELS}}
    cpath = os.path.join(out_dir, "process.yaml")
    yaml.safe_dump(cfg, open(cpath, "w"))

    tp = TriggerProcessing(raw_files, cpath, filter_data=fd,
                           verbose=False)
    df = tp.process(capacity=64, coincident_window_msec=0.16)

    merged = df[df["trigger_index_" + CHANNELS[1]].notna()
                | df["trigger_index_" + CHANNELS[0]].notna()
                & (df["trigger_channel"] != CHANNELS[0])]
    print(f"{len(df)} trigger rows from 4 events; per-event:")
    cols = ["event_number", "trigger_index", "trigger_channel",
            "trigger_delta_chi2"] + \
        [f"trigger_index_{c}" for c in CHANNELS]
    print(df[cols].to_string(index=False))

    # the per-event EventBuilder path produces the identical frame
    try:
        tp.FAST_DRAIN = False
        df_slow = tp.process(capacity=64, coincident_window_msec=0.16)
    finally:
        del tp.FAST_DRAIN
    pd.testing.assert_frame_equal(df, df_slow, check_exact=True)
    print("batched drain == per-event EventBuilder: identical frames")

    # physics check: every event's 3-channel coincidence became ONE row
    g = df[np.abs(df["trigger_index"] - 60_000) < 100]
    assert len(g) == 4, g
    for c in CHANNELS:
        assert g[f"trigger_index_{c}"].notna().all(), c
    print("3-channel coincidences merged to one row per event: OK")
    return df


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
