"""Interactive event building: OptimumFilterTrigger + EventBuilder.

Mirrors the reference's examples/trigger/event_builder.ipynb
(detprocess EventBuilder + OptimumFilterTrigger: core/eventbuilder.py,
core/oftrigger.py) — the notebook-style flow on one continuous trace:

    raw data  → RawData.get_traces
    yaml      → YamlConfig.get_config('trigger')
    filter h5 → FilterData templates / PSDs
    per-channel OptimumFilterTrigger → EventBuilder.acquire_triggers
    EventBuilder.build_event → coincidence-merged trigger dataframe

The FIR + Δχ² run on device through ops/trigger.py; for batch
production use pipelines.triggers.TriggerProcessing instead (vmapped,
on-device merge, mesh sharding) — see optimal_filter_trigger.py.

Run:  python examples/trigger/event_builder.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np
import yaml

from detprocess_jax import (EventBuilder, FilterData, OptimumFilterTrigger,
                            YamlConfig)
from detprocess_jax.io.rawdata import RawData, RawWriter
from detprocess_jax.models import pulse

FS = 1.25e6
NT, PRETRIG = 4096, 1024
L = 625_000
CHANNELS = ["Mv2301", "Mv2302"]
SERIES = "I1_D20260818_T080000"


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="event_builder_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    # ---------------------------------------------------------- raw data
    # one continuous event; a coincident pair lands on both channels at
    # the same time plus one single-channel pulse per channel
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((1, len(CHANNELS), L)) * sigma
    coincident_at = 200_000
    for ch in range(len(CHANNELS)):
        traces[0, ch, coincident_at - PRETRIG:
               coincident_at - PRETRIG + NT] += 50e-6 * tmpl
    traces[0, 0, 400_000 - PRETRIG:400_000 - PRETRIG + NT] += 40e-6 * tmpl
    traces[0, 1, 520_000 - PRETRIG:520_000 - PRETRIG + NT] += 45e-6 * tmpl

    raw_dir = os.path.join(out_dir, "raw")
    RawWriter(raw_dir, SERIES, FS, CHANNELS).write_dump(traces, dump_num=1)

    rawdata = RawData(raw_dir)
    rawdata.describe()
    available_channels = rawdata.get_available_channels()
    sample_rate = rawdata.get_sample_rate()
    print(f"available channels: {available_channels}, fs={sample_rate}")

    # -------------------------------------------------------- filter file
    filter_file = os.path.join(out_dir, "filter.h5")
    fd = FilterData(verbose=False)
    fd.set_template(CHANNELS, tmpl, FS,
                    pretrigger_length_samples=PRETRIG)
    fd.set_psd(CHANNELS, np.full(NT, sigma**2 / FS), FS)
    fd.save_hdf5(filter_file, overwrite=True)

    # -------------------------------------------------------------- yaml
    yaml_file = os.path.join(out_dir, "trigger.yaml")
    with open(yaml_file, "w") as f:
        yaml.safe_dump({
            "filter_file": filter_file,
            "trigger": {
                "coincident_window_msec": 0.5,
                CHANNELS[0]: {"run": True, "template_tag": "default",
                              "threshold_sigma": 8.0,
                              "pileup_window_msec": 0.5},
                CHANNELS[1]: {"run": True, "template_tag": "default",
                              "threshold_sigma": 8.0,
                              "pileup_window_msec": 0.5},
            }}, f)
    trigger_config = YamlConfig(yaml_file, available_channels).get_config(
        "trigger")

    # ------------------------------------------------- interactive loop
    filterdata = FilterData()
    filterdata.load_hdf5(trigger_config["overall"]["filter_file"]
                         if "filter_file" in trigger_config["overall"]
                         else filter_file)

    event_traces, admins = rawdata.get_traces(
        SERIES, [1], channels=CHANNELS, include_metadata=True)
    trace, admin = event_traces[0], admins[0]

    builder = EventBuilder()
    for chan, cfg in trigger_config["channels"].items():
        template, _, md = filterdata.get_template(
            chan, tag=cfg.get("template_tag", "default"),
            return_metadata=True)
        psd, _ = filterdata.get_psd(chan)
        builder.add_trigger_object(chan, OptimumFilterTrigger(
            chan, sample_rate, template, psd.astype(complex),
            md["nb_pretrigger_samples"]))

        # rows of `trace` follow the channels= order passed to
        # get_traces (NOT the raw file's stored order)
        cidx = CHANNELS.index(chan)
        df = builder.acquire_triggers(
            chan, trace[cidx], cfg["threshold_sigma"],
            pileup_window_msec=cfg["pileup_window_msec"])
        print(f"{chan}: {len(df)} triggers at "
              f"{np.sort(df['trigger_index'].to_numpy()).tolist()}")

    # --------------------------------------------- coincidence merging
    merged = builder.build_event(
        admin, fs=sample_rate,
        coincident_window_msec=trigger_config["overall"][
            "coincident_window_msec"])
    merged = merged.sort_values("trigger_time").reset_index(drop=True)
    times_ms = (merged["trigger_time"].to_numpy() * 1e3).round(3)
    print(f"\nmerged events: {len(merged)} at {times_ms.tolist()} ms")
    print(merged[[c for c in ("trigger_index", "trigger_time",
                              "trigger_channel", "trigger_prod_id")
                  if c in merged.columns]])

    # 4 raw triggers (2 per channel) → 3 events: the coincident pair
    # collapses into one row
    assert len(merged) == 3, merged
    found = np.sort(merged["trigger_index"].to_numpy())
    for want, got in zip([coincident_at, 400_000, 520_000], found):
        assert abs(int(got) - want) <= 16, (want, got)
    print("\nEvent building OK: coincident pair merged into one event")
    return merged


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
