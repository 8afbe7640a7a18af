"""Config-compatibility pin: the full construct set of the reference's
annotated example config (/root/reference/examples/processing/
process_example.yaml — salting 1x1/NxM blocks, trigger algorithm blocks
with trigger_channel renames and saturation amplitudes, top-level
`global:` geometry inherited into per-channel algorithm blocks,
base_algorithm-derived variants, feature_channel renames, per-channel
weights on +/- combinations, NxM amplitude_names) must parse into the
structures the pipelines consume. The fixture below re-expresses every
construct with its own channels and values; it is the drop-in-config
guarantee a migrating user relies on (docs/MIGRATION.md).
"""
import os
import tempfile

import yaml

from detprocess_jax.config.yamlconfig import YamlConfig

FS = 1.25e6
CHANS = ["det1", "det2", "det3", "det4"]

CONFIG = {
    "filter_file": "/data/filter.h5",
    "didv_file": "/data/didv.h5",
    "salting": {
        "dm_pdf_file": "/data/dm_pdf.pkl",
        "energies": [5, 50],
        # 1x1 block
        "det1": {
            "template_tag": "default",
            "noise_tag": "default",          # obsolete key → csd_tag
            "collection_efficiency": 0.6,
            "dpdi_tag": "default",
            "dpdi_poles": 2,
        },
        # NxM block with per-channel lists
        "det1|det2": {
            "template_tag": "shared",
            "noise_tag": "default",
            "collection_efficiency": [0.5, 0.25],
            "dpdi_tag": ["default", "default"],
            "dpdi_poles": [2, 3],
        },
    },
    "trigger": {
        "coincident_window_msec": 0.2,
        "det1|det2": {
            "trigger_channel": "detLR",
            "of2x1_shared": {
                "run": True,
                "template_tag": "shared",
                "csd_tag": "default",
                "pileup_window_msec": 1.0,
                "threshold_sigma": 4.5,
                "run_residual": True,
                "sat_amps_50kHz": [2.0e-6],
            },
        },
    },
    # reference layout: feature geometry under a top-level `global:`
    # section, channel blocks at the TOP level (not under `feature:`)
    "global": {
        "trace_length_msec": 16,
        "pretrigger_length_msec": 8,
    },
    "det3": {
        "of1x1_nodelay": {
            "run": True,
            "lowchi2_fcutoff": 40000,
            "template_tag": "default",
            "csd_tag": "default",
        },
        "baseline": {
            "run": True,
            "window_min_from_start_usec": 0,
            "window_max_from_trig_usec": -1500,
        },
        # derived variant of a built-in extractor
        "baseline_end": {
            "run": True,
            "base_algorithm": "baseline",
            "window_min_from_trig_usec": 1500,
            "window_max_to_end_usec": 0,
        },
        # run: False blocks are dropped entirely
        "energyabsorbed": {
            "run": False,
            "i0": 80e-9,
            "rl": 9e-3,
            "vb": 180e-9,
        },
    },
    # ',' applies the same block to each channel
    "det1,det2": {
        "of1x1_constrained": {
            "run": True,
            "template_tag": "default",
            "window_min_from_trig_usec": -80,
            "window_max_from_trig_usec": 80,
        },
    },
    # weighted-sum channel with rename and per-channel weights
    "det1+det2": {
        "feature_channel": "detSum",
        "weight_det1": 0.8,
        "weight_det2": 1.2,
        "baseline": {"run": True},
    },
    # NxM feature block with amplitude names
    "det1|det2": {
        "feature_channel": "detLR",
        "of2x2_pair": {
            "run": True,
            "base_algorithm": "ofnxm",
            "amplitude_names": ["ampL", "ampR"],
            "window_min_from_trig_usec": -80,
            "window_max_from_trig_usec": 80,
            "template_tag": "shared",
            "csd_tag": "default",
        },
    },
}


def _parse():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cfg.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(CONFIG, f)
        yc = YamlConfig(path, available_channels=CHANS, sample_rate=FS)
        return yc.get_config()


def test_global_section_and_msec_conversion():
    cfg = _parse()
    feat = cfg["feature"]
    assert feat["overall"]["filter_file"] == "/data/filter.h5"
    assert feat["overall"]["didv_file"] == "/data/didv.h5"
    # 16 ms / 8 ms at 1.25 MHz → 20000 / 10000 samples, inherited into
    # every algorithm block
    nb, pre = 20000, 10000
    assert set(feat["traces_config"]) == {(nb, pre)}
    assert sorted(feat["traces_config"][(nb, pre)]) == ["det1", "det2",
                                                        "det3"]
    blk = feat["channels"]["det3"]["of1x1_nodelay"]
    assert blk["nb_samples"] == nb and blk["nb_pretrigger_samples"] == pre


def test_feature_constructs():
    feat = _parse()["feature"]
    chans = feat["channels"]
    # run: False dropped; base_algorithm variant kept with its windows
    det3 = chans["det3"]
    assert "energyabsorbed" not in det3
    assert det3["baseline_end"]["base_algorithm"] == "baseline"
    assert det3["baseline_end"]["window_max_to_end_usec"] == 0
    # ',' split into the two individual channels
    for ch in ("det1", "det2"):
        assert chans[ch]["of1x1_constrained"]["window_min_from_trig_usec"] == -80
    # '+' combination: rename + weights (also collected in feat["weights"])
    comb = chans["det1+det2"]
    assert comb["feature_channel"] == "detSum"
    assert feat["weights"]["det1+det2"] == {
        "weight_det1": 0.8, "weight_det2": 1.2}
    # '|' NxM block: amplitude names + base algorithm
    pair = chans["det1|det2"]["of2x2_pair"]
    assert pair["base_algorithm"] == "ofnxm"
    assert pair["amplitude_names"] == ["ampL", "ampR"]


def test_trigger_constructs():
    trig = _parse()["trigger"]
    assert trig["overall"]["coincident_window_msec"] == 0.2
    # algorithm block keyed by name + trigger_channel rename
    (key,) = trig["channels"].keys()
    blk = trig["channels"][key]
    assert blk["channel_name"] == "det1|det2"
    assert "detLR" in key
    assert blk["run_residual"] is True
    assert blk["sat_amps_50kHz"] == [2.0e-6]
    assert blk["pileup_window_msec"] == 1.0
    assert blk["threshold_sigma"] == 4.5


def test_salting_constructs():
    salt = _parse()["salting"]
    assert salt["overall"]["dm_pdf_file"] == "/data/dm_pdf.pkl"
    assert salt["overall"]["energies"] == [5, 50]
    one = salt["channels"]["det1"]
    # obsolete noise_tag migrated to csd_tag
    assert one["csd_tag"] == "default" and "noise_tag" not in one
    assert one["collection_efficiency"] == 0.6
    nxm = salt["channels"]["det1|det2"]
    assert nxm["collection_efficiency"] == [0.5, 0.25]
    assert nxm["dpdi_poles"] == [2, 3]
    assert sorted(salt["channel_list"]) == ["det1", "det2"]
