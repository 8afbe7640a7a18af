"""Pipeline coverage for the remaining feature algorithms: of1x2x2,
ofnxmx2, psd_peaks, phase, energyabsorbed, base_algorithm variants,
weighted channel combinations."""

import numpy as np
import pytest
import yaml

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.pipelines.features import FeatureProcessing

FS = 1.25e6
N = 2048
PRETRIG = 512
CHANNELS = ["chan1", "chan2"]
NB = 6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cov")
    rng = np.random.default_rng(77)
    scint = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=10e-6,
                                tau_f1=60e-6)
    evap = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=30e-6,
                               tau_f1=400e-6)
    psd = np.full(N, 4e-18)
    sigma = np.sqrt(psd[0] * FS)

    # events: scintillation pulse at pretrigger + evaporation 40 samples
    # later, plus a 25 kHz line for psd_peaks/phase
    t = np.arange(N) / FS
    line = 5e-7 * np.sin(2 * np.pi * 25e3 * t + 0.7)
    traces = rng.standard_normal((NB, 2, N)) * sigma
    for ev in range(NB):
        traces[ev, 0] += 30e-6 * scint + 20e-6 * np.roll(evap, 40)
        traces[ev, 1] += line

    w = RawWriter(str(root / "raw"), "I1_D20260816_T250000", FS, CHANNELS)
    w.write_dump(traces, dump_num=1)

    fd = FilterData(verbose=False)
    for chan in CHANNELS:
        fd.set_psd(chan, psd, FS)
        fd.set_template(chan, scint, FS, pretrigger_length_samples=PRETRIG,
                        tag="Scintillation")
        fd.set_template(chan, evap, FS, pretrigger_length_samples=PRETRIG,
                        tag="Evaporation")
        fd.set_template(chan, scint, FS, pretrigger_length_samples=PRETRIG)
    # NxMx2 bank: 1 channel x 2 templates through the compound channel
    tmpl_nxm = np.stack([scint, evap])[None, :, :]
    csd = np.full((1, 1, N), psd[0], dtype=complex)
    fd.set_csd("chan1", csd, FS)
    fd.set_template("chan1", tmpl_nxm, FS,
                    pretrigger_length_samples=PRETRIG, tag="both")

    config = {
        "chan1": {
            "of1x2x2": {"run": True, "template_tag_1": "Scintillation",
                        "template_tag_2": "Evaporation"},
            "ofnxmx2": {"run": True, "template_tag": "both",
                        "template_group_ids": [0, 1],
                        "fit_window": [[PRETRIG - 30, PRETRIG + 30],
                                       [PRETRIG - 10, PRETRIG + 60]]},
            "energyabsorbed": {"run": True, "vb": 1e-6, "i0": 2e-7,
                               "rl": 0.03, "window_min_index": 100,
                               "window_max_index": 1800},
            "of_scint": {"run": True, "base_algorithm": "of1x1_nodelay",
                         "template_tag": "Scintillation"},
        },
        "chan2": {
            "psd_peaks": {"run": True, "f_lims": [[10e3, 50e3]],
                          "npeaks": 2, "min_separation_hz": 2000.0},
            "phase": {"run": True, "f_lims": [[10e3, 50e3]], "npeaks": 1},
        },
        "chan1-chan2": {
            "weight_chan1": 1.0,
            "weight_chan2": 2.0,
            "baseline": {"run": True},
        },
    }
    cpath = str(root / "cfg.yaml")
    yaml.safe_dump(config, open(cpath, "w"))
    raw_files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    return dict(raw_files=raw_files, cpath=cpath, fd=fd, traces=traces,
                scint=scint, evap=evap)


@pytest.fixture(scope="module")
def result(data):
    proc = FeatureProcessing(data["raw_files"], data["cpath"],
                             filter_data=data["fd"], verbose=False)
    return proc.process(batch_size=NB, dtype=np.float64)


def test_of1x2x2_columns(result):
    for col in ("scintillation_amp_of1x2x2_chan1",
                "evaporation_amp_of1x2x2_chan1",
                "time_diff_of1x2x2_chan1"):
        assert col in result.columns
    # The sequential (greedy) two-template fit absorbs part of the
    # overlapping second pulse into the first amplitude — expected for
    # OF1x2-style fitting; the joint ofnxmx2 below is the unbiased one.
    amp1 = result["scintillation_amp_of1x2x2_chan1"].to_numpy()
    assert np.all((amp1 > 25e-6) & (amp1 < 45e-6))


def test_ofnxmx2_columns(result):
    assert "amp1_ofnxmx2_chan1" in result.columns
    assert "amp2_ofnxmx2_chan1" in result.columns
    assert "delta_t_ofnxmx2_chan1" in result.columns
    np.testing.assert_allclose(result["amp1_ofnxmx2_chan1"], 30e-6,
                               rtol=0.1)
    np.testing.assert_allclose(result["amp2_ofnxmx2_chan1"], 20e-6,
                               rtol=0.15)
    np.testing.assert_allclose(result["delta_t_ofnxmx2_chan1"], 40 / FS,
                               atol=5 / FS)


def test_psd_peaks_finds_line(result):
    freqs = result["psd_peaks_10000_50000_freq_1_chan2"].to_numpy()
    np.testing.assert_allclose(freqs, 25e3, atol=FS / N + 1)
    amps = result["psd_peaks_10000_50000_amp_1_chan2"].to_numpy()
    assert (amps > 0).all()
    assert "psd_peaks_dc_amp_chan2" in result.columns


def test_phase_at_line(result):
    ph = result["phase_10000_50000_phase_1_chan2"].to_numpy()
    assert np.all(np.abs(ph) <= np.pi)
    # the injected line has a fixed phase → low scatter across events
    assert np.std(ph) < 0.5


def test_energyabsorbed(result, data):
    tr = data["traces"][:, 0, :]
    base = tr[:, :100].mean(axis=-1, keepdims=True)
    i_tr = tr[:, 100:1800] - base
    p0 = i_tr * (1e-6 - 2 * 2e-7 * 0.03) - i_tr**2 * 0.03
    expected = np.trapezoid(p0, dx=1 / FS, axis=-1)
    np.testing.assert_allclose(result["energyabsorbed_chan1"], expected,
                               rtol=1e-5)


def test_base_algorithm_variant(result):
    """Derived algorithm names keep their own output prefix
    (features.py:728-730)."""
    assert "amp_of_scint_chan1" in result.columns
    # nodelay scint fit on scint+overlapping evap absorbs part of the
    # second pulse (same bias as the reference's nodelay on pileup)
    amp = result["amp_of_scint_chan1"].to_numpy()
    assert np.all((amp > 28e-6) & (amp < 45e-6))


def test_weighted_difference_channel(result, data):
    """'chan1-chan2' with explicit weights = 1·chan1 − 2·chan2."""
    tr = data["traces"]
    combo = tr[:, 0] - 2.0 * tr[:, 1]
    expected = combo[:, :N - 1].mean(axis=-1)
    np.testing.assert_allclose(result["baseline_chan1-chan2"], expected,
                               rtol=1e-6)


def test_of1x2x2_delta_window_plumbed(data, result, tmp_path):
    """delta_window_*_usec YAML kwargs bound the joint of1x2x2 scan and
    reproduce the full-scan result (true separation 40 samples = 32 usec
    is inside the window)."""
    config = {"chan1": {"of1x2x2": {
        "run": True,
        "template_tag_1": "Scintillation",
        "template_tag_2": "Evaporation",
        "delta_window_min_usec": 0.0,
        "delta_window_max_usec": 100.0,
    }}}
    cpath = tmp_path / "dw.yaml"
    yaml.safe_dump(config, open(cpath, "w"))
    proc = FeatureProcessing(data["raw_files"], str(cpath),
                             filter_data=data["fd"], verbose=False)
    out = proc.process(batch_size=NB, dtype=np.float64)
    for col in ("scintillation_amp_of1x2x2_chan1",
                "evaporation_amp_of1x2x2_chan1",
                "time_diff_of1x2x2_chan1"):
        np.testing.assert_allclose(out[col].to_numpy(),
                                   result[col].to_numpy(), rtol=1e-10)
    assert np.all(out["time_diff_of1x2x2_chan1"].to_numpy() >= 0)


def test_empty_constrained_window_is_actionable(data, tmp_path):
    """A constrained-OF window that selects no delays must fail with a
    message naming the spec and channel (review finding: the direct-
    window dispatch previously crashed deep inside prepare_delay_window
    with no context)."""
    config = {"chan1": {"of1x1_constrained": {
        "run": True,
        "window_min_index": 0,
        "window_max_index": N - 1,
        "lgc_outside_window": True,     # inverts to all-False
    }}}
    cpath = tmp_path / "empty_win.yaml"
    yaml.safe_dump(config, open(cpath, "w"))
    # the direct-window tables are built at PLAN BUILD (constructor),
    # so the empty window fails before any processing starts
    with pytest.raises(ValueError, match="selects no delays.*of1x1_constrained|of1x1_constrained.*selects no delays"):
        FeatureProcessing(data["raw_files"], str(cpath),
                          filter_data=data["fd"], verbose=False)
