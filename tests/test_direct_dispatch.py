"""Direct-window dispatch is slot-aware.

The direct windowed-DFT kernel only pays when the full delay series is
NOT already being computed for the same OF filter: when an
unconstrained (or too-wide constrained) spec shares the slot, XLA CSEs
the inverse-chain q series across specs and the masked argmax is nearly
free — forcing the direct path there only ADDS an untangle + two
matmuls (measured on chip: 75.6k → 60.6k ev/s on the
unconstrained+constrained pair). These tests pin the plan-build rule
(pipelines/features.py direct_windows) and keep end-to-end coverage of
the direct kernels through a constrained-only config.
"""

import numpy as np
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.features import FeatureProcessing

from reference_impl import generate_noise

FS = 1.25e6
N = 4096
PRETRIG = 2048
NB = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("dwin")
    rng = np.random.default_rng(7)
    tmpl = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    f = np.abs(np.fft.fftfreq(N, 1 / FS))
    f[0] = f[1]
    psd = 1e-20 * (1 + 50 / f)
    amps = rng.uniform(1e-6, 4e-6, NB)
    offs = rng.integers(-10, 10, NB)
    traces = generate_noise(psd, FS, NB, rng)
    for i in range(NB):
        traces[i] += amps[i] * np.roll(tmpl, offs[i])
    raw_dir = root / "raw"
    writer = RawWriter(str(raw_dir), "I1_D20260818_T090000", FS, ["chan1"])
    writer.write_dump(traces[:, None, :], dump_num=1)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    # a second template tag → a DIFFERENT OF slot on the same channel
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG,
                    tag="alt")
    fd.set_psd("chan1", psd, FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    raw_files = sorted(str(p) for p in raw_dir.glob("*.hdf5"))
    return dict(root=root, raw_files=raw_files, fpath=fpath,
                amps=amps, offs=offs)


def _proc(dataset, chan_cfg, name):
    cfg = {"filter_file": dataset["fpath"], "chan1": chan_cfg}
    path = str(dataset["root"] / f"{name}.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return FeatureProcessing(dataset["raw_files"], path,
                             filter_data=dataset["fpath"], verbose=False)


NARROW = {"run": True, "template_tag": "default",
          "window_min_from_trig_usec": -40.0,
          "window_max_from_trig_usec": 40.0}


def test_constrained_only_uses_direct(dataset):
    proc = _proc(dataset, {"of1x1_constrained": dict(NARROW)}, "only")
    assert any(g.direct_windows for g in proc._groups)


def test_shared_slot_with_unconstrained_skips_direct(dataset):
    proc = _proc(dataset, {
        "of1x1_unconstrained": {"run": True, "template_tag": "default"},
        "of1x1_constrained": dict(NARROW)}, "shared")
    assert all(not g.direct_windows for g in proc._groups)


def test_wide_constrained_on_same_slot_skips_direct(dataset):
    proc = _proc(dataset, {
        "of1x1_wide": {"run": True, "base_algorithm": "of1x1_constrained",
                       "template_tag": "default",
                       "window_min_from_trig_usec": -1200.0,
                       "window_max_from_trig_usec": 1200.0},
        "of1x1_constrained": dict(NARROW)}, "wide")
    assert all(not g.direct_windows for g in proc._groups)


def test_different_slots_keep_direct(dataset):
    """An unconstrained spec on ANOTHER template tag (different OF slot)
    does not disable the direct path for the narrow spec."""
    proc = _proc(dataset, {
        "of1x1_unconstrained": {"run": True, "template_tag": "alt"},
        "of1x1_constrained": dict(NARROW)}, "slots")
    assert any(g.direct_windows for g in proc._groups)


def test_constrained_only_end_to_end(dataset):
    """Direct-kernel pipeline coverage (the shared-slot configs in the
    other e2e tests now take the masked path by design)."""
    proc = _proc(dataset, {"of1x1_constrained": dict(NARROW)}, "e2e")
    assert any(g.direct_windows for g in proc._groups)
    df = proc.process(batch_size=4)
    rec = df["amp_of1x1_constrained_chan1"].to_numpy()
    assert np.all(np.abs(rec / dataset["amps"] - 1.0) < 0.2)
    t0 = df["t0_of1x1_constrained_chan1"].to_numpy()
    assert np.all(np.abs(t0 * FS - dataset["offs"]) <= 1.5)
