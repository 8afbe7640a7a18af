"""salt_efficiency: the saltchecks analysis as a library function."""

import numpy as np
import pandas as pd

from detprocess_jax.pipelines.salting import salt_efficiency


def _salts(energies, indices, series=1, event=1):
    return pd.DataFrame({
        "salt_id": np.arange(len(energies)),
        "salt_channel": ["c1"] * len(energies),
        "salt_energy_ev": energies,
        "trigger_index": indices,
        "series_number": [series] * len(energies),
        "event_number": [event] * len(energies),
        "dump_number": [1] * len(energies),
    })


def test_efficiency_counts_matches_and_misses():
    salts = _salts([100.0, 200.0, 300.0, 400.0],
                   [1000, 5000, 9000, 13000])
    # recover salts 1 and 3 (within window), miss 0 (wrong event) and 2
    trig = pd.DataFrame({
        "series_number": [1, 1, 2],
        "event_number": [1, 1, 1],
        "trigger_index": [5005, 13010, 1000],
    })
    out = salt_efficiency(salts, trig, match_window_samples=20,
                          energy_bins=[0.0, 250.0, 500.0])
    assert out["n_injected"].tolist() == [2, 2]
    assert out["n_recovered"].tolist() == [1, 1]
    np.testing.assert_allclose(out["efficiency"], [0.5, 0.5])


def test_efficiency_monotone_with_threshold_behavior():
    rng = np.random.default_rng(0)
    energies = rng.uniform(10, 1000, 400)
    indices = rng.integers(10_000, 600_000, 400)
    salts = _salts(energies, indices)
    # emulate a 50-eV threshold detector: recover iff energy > 50
    keep = energies > 50
    trig = pd.DataFrame({
        "series_number": np.ones(keep.sum(), dtype=int),
        "event_number": np.ones(keep.sum(), dtype=int),
        "trigger_index": indices[keep],
    })
    out = salt_efficiency(salts, trig, match_window_samples=2)
    effs = out["efficiency"].to_numpy()
    assert effs[-1] == 1.0
    assert effs[0] < 1.0
    # binomial errors populated where n > 0
    assert np.isfinite(out["efficiency_err"]).all()


def test_empty_triggers_zero_efficiency():
    salts = _salts([100.0, 200.0], [1000, 2000])
    out = salt_efficiency(salts, pd.DataFrame(), energy_bins=[0, 300])
    assert out["n_recovered"].sum() == 0
    assert out["efficiency"].iloc[0] == 0.0
