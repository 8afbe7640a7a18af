"""Vaex-layout table interop, proven against independently-authored IO.

The reference exports trigger/feature dataframes with
``vaex.export_hdf5`` (process/features.py:609-616, triggers.py:644) and
downstream tools (vaex/detanalysis) read that layout:
``/table/columns/{name}/data`` 1-D datasets, strings as fixed-width
bytes. vaex itself is not installed here, so — like the filter-file
fixture — the check uses RAW h5py on both sides of the boundary:

- a fixture file written with plain h5py (no detprocess_jax imports)
  must read back through ``io.tables.read_vaex_hdf5``;
- a file written by ``io.tables.write_vaex_hdf5`` must parse with a
  plain-h5py reader implementing the documented layout.
"""

import h5py
import numpy as np
import pandas as pd

from detprocess_jax.io import tables


def _independent_write(path, columns):
    """The vaex on-disk layout, straight h5py."""
    with h5py.File(path, "w") as f:
        cols = f.create_group("table").create_group("columns")
        for name, arr in columns.items():
            g = cols.create_group(name)
            g.create_dataset("data", data=arr)


def _independent_read(path):
    out = {}
    with h5py.File(path, "r") as f:
        for name, g in f["table"]["columns"].items():
            arr = g["data"][...]
            if arr.dtype.kind == "S":
                arr = arr.astype(str)
            out[name] = arr
    return out


def test_reads_independent_vaex_file(tmp_path):
    path = str(tmp_path / "ext.h5")
    _independent_write(path, {
        "trigger_index": np.array([100, 2500, 90_000], dtype=np.int64),
        "trigger_delta_chi2": np.array([55.2, 301.0, 88.8]),
        "trigger_channel": np.array([b"Mv2301", b"Mv2302", b"Mv2301"]),
        "event_number": np.array([1, 1, 2], dtype=np.int32),
    })
    df = tables.read_vaex_hdf5(path)
    assert list(df["trigger_index"]) == [100, 2500, 90_000]
    assert list(df["trigger_channel"]) == ["Mv2301", "Mv2302", "Mv2301"]
    np.testing.assert_allclose(df["trigger_delta_chi2"],
                               [55.2, 301.0, 88.8])


def test_written_file_parses_independently(tmp_path):
    path = str(tmp_path / "ours.h5")
    df = pd.DataFrame({
        "amp_of1x1_nodelay_Mv2301": np.array([1.1e-6, 2.2e-6]),
        "series_number": np.array([120260816120000, 120260816120000],
                                  dtype=np.int64),
        "trigger_channel": ["Mv2301", "Mv2302"],
    })
    tables.write_vaex_hdf5(df, path)
    got = _independent_read(path)
    assert set(got) == set(df.columns)
    np.testing.assert_allclose(got["amp_of1x1_nodelay_Mv2301"],
                               df["amp_of1x1_nodelay_Mv2301"])
    assert got["series_number"].dtype == np.int64
    assert list(got["trigger_channel"]) == ["Mv2301", "Mv2302"]


def test_roundtrip_and_concat(tmp_path):
    p1 = str(tmp_path / "a.h5")
    p2 = str(tmp_path / "b.h5")
    d1 = pd.DataFrame({"x": [1.0, 2.0], "n": [1, 2]})
    d2 = pd.DataFrame({"x": [3.0], "n": [3]})
    tables.write_table(d1, p1)
    tables.write_table(d2, p2)
    cat = tables.concat_tables([p1, p2])
    assert list(cat["n"]) == [1, 2, 3]
    assert tables.count_rows(p1) == 2


def test_job_summary_accumulates_on_resume(tmp_path):
    """Resumed runs must not clobber the series summary: counts and
    times accumulate, invocations increments."""
    p1 = tables.write_job_summary(str(tmp_path), "threshtrig", "trigger",
                                  "S1", {"continuous_events": 100,
                                         "triggers": 7,
                                         "wall_sec": 10.0, "dumps": 2})
    import json
    s = json.load(open(p1))
    assert s["invocations"] == 1 and s["continuous_events"] == 100
    p2 = tables.write_job_summary(str(tmp_path), "threshtrig", "trigger",
                                  "S1", {"continuous_events": 20,
                                         "triggers": 3,
                                         "wall_sec": 2.0, "dumps": 3})
    s = json.load(open(p2))
    assert p1 == p2
    assert s["continuous_events"] == 120 and s["triggers"] == 10
    assert s["wall_sec"] == 12.0
    assert s["dumps"] == 3               # cumulative numbering, not summed
    assert s["invocations"] == 2
    assert s["events_per_sec"] == 10.0   # 120 / 12


def test_vaex_hdf5_utf8_and_missing_roundtrip(tmp_path):
    """Non-ASCII strings and missing values round-trip: the writer
    encodes UTF-8 (it once relied on numpy 'S' casting, which raised on
    non-ASCII) and the reader decodes UTF-8 (it once astype(str)'d,
    which is ASCII and crashed on what the writer accepted); None is
    preserved via the mask dataset, never the literal string 'None'."""
    import numpy as np
    import pandas as pd

    from detprocess_jax.io import tables

    df = pd.DataFrame({
        "s": np.array(["séries", None, "β-decay", "plain"], object),
        "x": np.arange(4),
    })
    p = str(tmp_path / "t.hdf5")
    tables.write_table(df, p)
    back = tables.read_table(p)
    vals = list(back["s"])
    assert vals[0] == "séries" and vals[2] == "β-decay" \
        and vals[3] == "plain"
    assert pd.isna(vals[1])          # missing, NOT the string "None"
    assert "None" not in {v for v in vals if not pd.isna(v)}
