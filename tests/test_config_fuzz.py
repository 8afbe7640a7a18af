"""Config-compiler fuzz: plan compilation never silently drops an
enabled algorithm (round-4 VERDICT item 7).

The reference's YamlConfig semantics (process/config.py:409-641):
channel algebra (``,`` apply-to-each, ``+``/``-`` weighted combos,
``|`` multichannel, ``all`` expansion), msec↔samples trace-length
resolution with global→channel→algorithm inheritance, ``run:``
switches, ``disable:``, include files, base_algorithm variants. The
fuzzer builds randomized configs over that space and asserts the
parsed config keeps EXACTLY the enabled (channel, algorithm) pairs;
a smaller end-to-end leg compiles a FeatureProcessing plan per fuzzed
config and checks every enabled pair emits an output column.
"""

import os

import numpy as np
import pytest
import yaml

from detprocess_jax.config import YamlConfig
from detprocess_jax.config.yamlconfig import (
    convert_length_msec_to_samples)

FS = 1.25e6
CHANNELS = ["chan1", "chan2", "chan3"]
TRACE_ALGOS = ["baseline", "integral", "maximum", "minimum"]
OF_ALGOS = ["of1x1_nodelay", "of1x1_unconstrained"]


def _fuzz_config(rng):
    """(yaml_dict, expected {channel_key: set(algos)}, geometry)"""
    nt = int(rng.choice([512, 1024, 2048]))
    pre = nt // int(rng.choice([2, 4]))
    use_msec = bool(rng.integers(2))
    overall = {}
    if use_msec:
        overall["trace_length_msec"] = nt / FS * 1e3
        overall["pretrigger_length_msec"] = pre / FS * 1e3
        # the parser re-derives samples from msec — use ITS mapping as
        # the expectation (round-half semantics live there)
        nt = convert_length_msec_to_samples(nt / FS * 1e3, FS)
        pre = convert_length_msec_to_samples(pre / FS * 1e3, FS)
    else:
        overall["trace_length_samples"] = nt
        overall["pretrigger_length_samples"] = pre

    # channel keys: singles, ','-lists, '+'/'-' combos, 'all'
    n_keys = int(rng.integers(1, 4))
    keys = []
    pool = (CHANNELS
            + ["chan1,chan2", "chan2,chan3", "chan1+chan2",
               "chan1-chan3", "all"])
    for _ in range(n_keys):
        k = str(rng.choice(pool))
        if k not in keys:
            keys.append(k)

    cfg = {"feature": {"global": overall}}
    expected = {}
    for key in keys:
        block = {}
        # expansion key set: 'all' → every channel; ',' → each named
        # channel; '+'/'-' combos stay one compound key. A later yaml
        # key REPLACES an earlier expansion for the same channel — the
        # reference's new_channel_config[chan] = deepcopy(chan_dict)
        # overwrite (process/config.py:217-248), matched here.
        expand = (CHANNELS if key == "all"
                  else key.split(",") if "," in key else [key])
        algos = {}
        chan_disabled = bool(rng.random() < 0.15)
        for algo in TRACE_ALGOS + OF_ALGOS:
            if rng.random() < 0.5:
                continue
            run = bool(rng.random() < 0.8)
            ab = {"run": run}
            if algo in OF_ALGOS and rng.random() < 0.3:
                # algorithm-level length override (inheritance chain)
                ab["trace_length_samples"] = nt
                ab["pretrigger_length_samples"] = pre
            if rng.random() < 0.2:
                # named variant of a base algorithm
                # (reference features.py:728-730)
                name = f"{algo}_variant{int(rng.integers(10))}"
                ab["base_algorithm"] = algo
                algos[name] = (ab, run)
            else:
                algos[algo] = (ab, run)
        for name, (ab, run) in algos.items():
            block[name] = ab
        if chan_disabled:
            block["disable"] = True
        cfg["feature"][key] = block
        enabled = (set() if chan_disabled
                   else {n for n, (_, run) in algos.items() if run})
        for sub in expand:
            if chan_disabled:
                # disabled keys are skipped at expansion: an earlier
                # key's expansion for this channel SURVIVES
                continue
            expected[sub] = set(enabled)     # replace, not merge
    expected = {c: a for c, a in expected.items() if a}
    return cfg, expected, (nt, pre)


@pytest.mark.parametrize("seed", range(40))
def test_fuzzed_config_keeps_every_enabled_algorithm(tmp_path, seed):
    rng = np.random.default_rng(seed)
    cfg, expected, (nt, pre) = _fuzz_config(rng)
    path = str(tmp_path / f"fuzz{seed}.yaml")
    yaml.safe_dump(cfg, open(path, "w"), sort_keys=False)
    yc = YamlConfig(path, CHANNELS, sample_rate=FS)
    feat = yc.get_config("feature")
    got = {chan: {a for a, ac in cc.items()
                  if isinstance(ac, dict) and ac.get("run")}
           for chan, cc in feat["channels"].items()}
    got = {c: a for c, a in got.items() if a}
    assert got == expected, (
        f"seed {seed}: parsed algorithms differ\nconfig: {cfg}\n"
        f"got: {got}\nexpected: {expected}")
    # every kept algorithm resolved its geometry
    for chan, cc in feat["channels"].items():
        for algo, ac in cc.items():
            if isinstance(ac, dict) and ac.get("run"):
                assert ac["nb_samples"] == nt, (chan, algo)
                assert ac["nb_pretrigger_samples"] == pre, (chan, algo)


def test_fuzzed_include_files_merge(tmp_path):
    inc = {"feature": {"chan2": {"baseline": {"run": True}}},
           "global": {"trace_length_samples": 512,
                      "pretrigger_length_samples": 128}}
    inc_path = str(tmp_path / "inc.yaml")
    yaml.safe_dump(inc, open(inc_path, "w"))
    main = {"include": [inc_path]}
    path = str(tmp_path / "main.yaml")
    yaml.safe_dump(main, open(path, "w"))
    yc = YamlConfig(path, CHANNELS, sample_rate=FS)
    feat = yc.get_config("feature")
    assert "chan2" in feat["channels"]
    assert feat["channels"]["chan2"]["baseline"]["run"]


@pytest.mark.parametrize("seed", [1, 7, 13])
def test_fuzzed_config_compiles_and_emits_all_columns(tmp_path, seed):
    """End-to-end leg: the compiled feature plan emits at least one
    output column for EVERY enabled (channel, algorithm) pair — the
    reference semantics this pins is that nothing enabled is silently
    dropped between yaml and output (process/config.py:409-641 +
    features.py:747-846)."""
    from detprocess_jax.io.filterfile import FilterData
    from detprocess_jax.io.rawdata import RawWriter
    from detprocess_jax.models import pulse
    from detprocess_jax.pipelines.features import FeatureProcessing

    rng = np.random.default_rng(1000 + seed)
    cfg, expected, (nt, pre) = _fuzz_config(rng)
    if not expected:
        pytest.skip("fuzz draw enabled nothing")
    path = str(tmp_path / "fuzz.yaml")
    yaml.safe_dump(cfg, open(path, "w"), sort_keys=False)

    tmpl = pulse.make_template(FS, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T170000", FS,
                  CHANNELS, data_type="continuous",
                  nb_pretrigger_samples=pre)
    w.write_dump(rng.standard_normal((3, len(CHANNELS), nt)) * 1e-9,
                 dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    for chan in CHANNELS:
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=pre)
        fd.set_psd(chan, np.full(nt, 1e-18), FS)
    for key in expected:
        if "+" in key or "-" in key:       # compound combos need their
            fd.set_template(key, tmpl, FS,  # own template/psd entries
                            pretrigger_length_samples=pre)
            fd.set_psd(key, np.full(nt, 1e-18), FS)

    fp = FeatureProcessing(files, path, filter_data=fd, verbose=False)
    df = fp.process(batch_size=4)
    assert len(df) == 3
    cols = set(df.columns)
    for chan, algos in expected.items():
        cname = chan.replace(",", "")
        for algo in algos:
            hits = [c for c in cols
                    if c == f"{algo}_{cname}"          # trace stats
                    or c.endswith(f"_{algo}_{cname}")]  # {feature}_{algo}_{chan}
            assert hits, (f"seed {seed}: no output column for enabled "
                          f"{algo} on {chan}; columns: {sorted(cols)}")
