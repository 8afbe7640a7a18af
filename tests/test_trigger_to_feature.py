"""Full chain: continuous data → trigger → windowed feature extraction.

Mirrors the reference's production flow (scripts/process.py:709-784):
TriggerProcessing writes a trigger dataframe; FeatureProcessing reads
windowed traces around each trigger and runs the OF feature plan.
"""

import numpy as np
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.features import FeatureProcessing
from detprocess_jax.pipelines.triggers import TriggerProcessing

FS = 1.25e6
NT = 2048
PRETRIG = 512
L = 100000


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(21)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    sigma = np.sqrt(psd[0] * FS)

    positions = [[20000, 50000, 80000], [35000, 70000]]
    amps_true = {(0, 20000): 30e-6, (0, 50000): 45e-6, (0, 80000): 25e-6,
                 (1, 35000): 40e-6, (1, 70000): 35e-6}
    traces = rng.standard_normal((2, 1, L)) * sigma
    for ev, poss in enumerate(positions):
        for pos in poss:
            traces[ev, 0, pos - PRETRIG:pos - PRETRIG + NT] += (
                amps_true[(ev, pos)] * tmpl)

    w = RawWriter(str(root / "raw"), "I1_D20260816_T210000", FS, ["chan1"])
    w.write_dump(traces, dump_num=1)
    raw_files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))

    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", psd, FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)

    trig_cfg = {"trigger": {"chan1": {
        "run": True, "template_tag": "default", "threshold_sigma": 10.0,
        "pileup_window_msec": 0.5}}}
    tpath = str(root / "t.yaml")
    yaml.safe_dump(trig_cfg, open(tpath, "w"))

    feat_cfg = {
        "feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            "chan1": {
                "of1x1_nodelay": {"run": True, "template_tag": "default"},
                "of1x1_constrained": {"run": True, "template_tag": "default",
                                      "window_min_from_trig_usec": -40.0,
                                      "window_max_from_trig_usec": 40.0},
                "baseline": {"run": True},
            },
        },
    }
    cpath = str(root / "f.yaml")
    yaml.safe_dump(feat_cfg, open(cpath, "w"))

    return dict(raw_files=raw_files, fpath=fpath, tpath=tpath, cpath=cpath,
                amps_true=amps_true)


def test_trigger_then_feature(chain, tmp_path):
    tp = TriggerProcessing(chain["raw_files"], chain["tpath"],
                           filter_data=chain["fpath"], verbose=False)
    trig_df = tp.process(capacity=128, lgc_save=True,
                         output_path=str(tmp_path / "trig"))
    assert len(trig_df) == 5

    fp = FeatureProcessing(chain["raw_files"], chain["cpath"],
                           filter_data=chain["fpath"],
                           trigger_dataframe=trig_df, verbose=False)
    df = fp.process(batch_size=3, dtype=np.float64)
    assert len(df) == 5

    # features carry trigger columns
    for col in ("trigger_index", "trigger_time", "trigger_delta_chi2",
                "amp_of1x1_nodelay_chan1", "amp_of1x1_constrained_chan1",
                "t0_of1x1_constrained_chan1", "baseline_chan1"):
        assert col in df.columns, col

    # OF amplitudes on the triggered windows recover the injections
    amps_by_index = {}
    for (ev, pos), a in chain["amps_true"].items():
        amps_by_index[pos] = a
    for _, row in df.iterrows():
        ti = int(row["trigger_index"])
        best = min(amps_by_index, key=lambda p: abs(p - ti))
        assert abs(best - ti) <= 2
        np.testing.assert_allclose(row["amp_of1x1_nodelay_chan1"],
                                   amps_by_index[best], rtol=0.05)
        # t0 of the constrained fit is within the window
        assert abs(row["t0_of1x1_constrained_chan1"]) <= 40e-6 + 1e-9


def test_trigger_dataframe_from_file(chain, tmp_path):
    """Feature pipeline accepts the trigger dataframe as a file path."""
    tp = TriggerProcessing(chain["raw_files"], chain["tpath"],
                           filter_data=chain["fpath"], verbose=False)
    tp.process(capacity=128, lgc_save=True,
               output_path=str(tmp_path / "trig2"))
    trig_files = sorted((tmp_path / "trig2").glob("threshtrig_*.hdf5"))
    fp = FeatureProcessing(chain["raw_files"], chain["cpath"],
                           filter_data=chain["fpath"],
                           trigger_dataframe=str(trig_files[0]),
                           verbose=False)
    df = fp.process(batch_size=10, dtype=np.float64)
    assert len(df) == 5
