"""YAML-driven feature processing: trigger windows → batched OF features
with a user plug-in extractor.

Mirrors the reference's examples/processing tree (process_example.yaml +
features_user.py + test_reading_yaml.ipynb; detprocess
FeatureProcessing/YamlConfig: process/features.py, process/config.py).
Shows the YAML round trip: parse → plan compile → one jitted batch step
per (trace-length, pretrigger) group → feature table with the
reference's column conventions.

Run:  python examples/processing/feature_processing.py [output_dir]
"""

import os
import sys
import tempfile

import numpy as np
import yaml

from detprocess_jax import Noise, TriggerProcessing, FeatureProcessing
from detprocess_jax.config.yamlconfig import YamlConfig
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse

FS = 1.25e6
NT, PRETRIG = 4096, 1024
L = 625_000
CHANNELS = ["Mv2301", "Mv2302"]
HERE = os.path.dirname(os.path.abspath(__file__))


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="featproc_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    # ---- raw data + filter file ----------------------------------------
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((2, len(CHANNELS), L)) * sigma
    amps_true = {}
    for k, pos in enumerate((150_000, 300_000, 450_000)):
        a = (30 + 10 * k) * 1e-6
        traces[k % 2, k % 2, pos - PRETRIG:pos - PRETRIG + NT] += a * tmpl
        amps_true[pos] = a
    RawWriter(os.path.join(out_dir, "raw"), "I1_D20260816_T120000", FS,
              CHANNELS).write_dump(traces, dump_num=1)
    raw_files = sorted(os.path.join(out_dir, "raw", f)
                       for f in os.listdir(os.path.join(out_dir, "raw")))

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

    # ---- YAML config with built-ins + the user plug-in -----------------
    config = {
        "trigger": {
            "coincident_window_msec": 0.1,
            **{c: {"run": True, "template_tag": "default",
                   "threshold_sigma": 8.0, "pileup_window_msec": 0.5}
               for c in CHANNELS}},
        "feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            "external_file": os.path.join(HERE, "custom_extractor.py"),
            **{c: {"of1x1_nodelay": {"run": True,
                                     "template_tag": "default"},
                   "of1x1_unconstrained": {"run": True,
                                           "template_tag": "default"},
                   "baseline": {"run": True},
                   "integral": {"run": True},
                   "pulse_shape": {"run": True}}
               for c in CHANNELS}},
    }
    cfg_path = os.path.join(out_dir, "process.yaml")
    yaml.safe_dump(config, open(cfg_path, "w"))

    # the parsed view (YamlConfig mirrors process/config.py semantics)
    parsed = YamlConfig(cfg_path, CHANNELS, FS, verbose=False)
    feat_cfg = parsed.get_config("feature")["channels"]
    print("feature algorithms configured:",
          sorted({a for ch in feat_cfg.values()
                  for a, v in ch.items()
                  if isinstance(v, dict) and v.get("run")}))

    # ---- trigger, then features on the triggered windows ---------------
    trig = TriggerProcessing(raw_files, cfg_path, filter_data=filter_path,
                             verbose=False)
    trigger_df = trig.process()
    feat = FeatureProcessing(raw_files, cfg_path, filter_data=filter_path,
                             trigger_dataframe=trigger_df, verbose=False)
    features = feat.process(batch_size=16, lgc_save=True,
                            output_path=os.path.join(out_dir, "feature"))

    print(f"{len(features)} feature rows, "
          f"{len(features.columns)} columns")
    for _, row in features.iterrows():
        pos = int(row["trigger_index"])
        chan = row["trigger_channel"]
        amp = row.get(f"amp_of1x1_nodelay_{chan}", np.nan)
        if pos in amps_true:
            print(f"  pulse @ {pos} on {chan}: amp {amp:.2e} "
                  f"(true {amps_true[pos]:.2e})")
            assert abs(amp - amps_true[pos]) / amps_true[pos] < 0.05
    # plug-in columns present
    assert any(c.startswith("tail_fraction") for c in features.columns), \
        list(features.columns)
    print("plug-in extractor columns:",
          [c for c in features.columns if "tail" in c or "rise" in c])
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
