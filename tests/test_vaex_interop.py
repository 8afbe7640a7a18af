"""Real-vaex interop: files written by io.tables open in vaex itself.

The reference's downstream consumers read feature/trigger dumps with
vaex (process/features.py:609-616); our writer emits the same HDF5
column layout by hand (io/tables.py docstring). vaex is not a
dependency of this package, so these tests run only where it is
installed (CI-optional — round-4 VERDICT item 7): they open a produced
dump with ``vaex.open`` and compare every column, including string
columns, against the source dataframe.
"""

import numpy as np
import pandas as pd
import pytest

vaex = pytest.importorskip("vaex")

from detprocess_jax.io import tables  # noqa: E402


def test_vaex_opens_written_feature_table(tmp_path):
    df = pd.DataFrame({
        "amp_of1x1_nodelay_chan1": np.linspace(0, 1e-6, 7),
        "chi2_of1x1_nodelay_chan1": np.linspace(0.9, 1.1, 7),
        "event_number": np.arange(1, 8, dtype=np.int64),
        "series_name": ["I1_D20260820_T180000"] * 7,
        "trigger_channel": ["chan1"] * 7,
    })
    path = str(tmp_path / "feature_test_F0001.hdf5")
    tables.write_vaex_hdf5(df, path)
    vdf = vaex.open(path)
    assert len(vdf) == len(df)
    assert set(vdf.get_column_names()) == set(df.columns)
    for col in df.columns:
        got = vdf[col].to_numpy()
        want = df[col].to_numpy()
        if want.dtype == object:
            got = np.asarray([g.decode() if isinstance(g, bytes) else g
                              for g in got])
            assert list(got) == list(want), col
        else:
            assert np.allclose(got.astype(float),
                               want.astype(float)), col


def test_vaex_roundtrip_through_pipeline_dump(tmp_path):
    """A dump produced by the trigger pipeline opens in vaex and the
    physics columns agree with our own reader."""
    import yaml

    from detprocess_jax.io.filterfile import FilterData
    from detprocess_jax.io.rawdata import RawWriter
    from detprocess_jax.models import pulse
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    fs, nt, pre = 1.25e6, 512, 128
    tmpl = pulse.make_template(fs, nt, pre, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    rng = np.random.default_rng(5)
    traces = rng.standard_normal((2, 1, 50_000)) * 1e-9
    for ev in range(2):
        for p in (9000, 21000):
            traces[ev, 0, p - pre:p - pre + nt] += 50e-9 * tmpl
    w = RawWriter(str(tmp_path / "raw"), "I1_D20260820_T190000", fs,
                  ["chan1"], data_type="continuous")
    w.write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, fs, pretrigger_length_samples=pre)
    fd.set_psd("chan1", np.full(nt, 1e-9**2 / fs), fs)
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump({"trigger": {"chan1": {
        "run": True, "template_tag": "default", "threshold_sigma": 8.0,
        "pileup_window_msec": 0.2}}}, open(cpath, "w"))
    tp = TriggerProcessing(files, cpath, filter_data=fd, verbose=False)
    out = str(tmp_path / "out")
    df = tp.process(capacity=64, lgc_save=True, output_path=out)
    import os
    dumps = [os.path.join(out, p) for p in sorted(os.listdir(out))
             if p.endswith(".hdf5") and "job_summary" not in p]
    assert dumps
    vdf = vaex.open(dumps[0])
    ours = tables.read_table(dumps[0])
    assert len(vdf) == len(ours) == len(df)
    for col in ("trigger_index", "trigger_delta_chi2",
                "trigger_amplitude"):
        assert np.allclose(vdf[col].to_numpy(),
                           ours[col].to_numpy()), col
