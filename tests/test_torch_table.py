"""The port's columnar core against the JAX package's: the capacity rule,
pandas and numpy round-trips of every dtype (nulls included), tables
carried across from the reference, and the parquet/csv read paths.

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import datetime
import decimal

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_table, export_reference,
                                reference, torch_one_thread)  # noqa: F401


def _frames():
    """One frame per logical dtype of table/dtypes.py, with nulls."""
    n = 300
    r = np.random.default_rng(7)
    null = r.random(n) < 0.2
    frames = {}
    for name in ("int8", "int16", "int32", "int64", "uint8", "uint16",
                 "uint32", "uint64"):
        info = np.iinfo(name)
        vals = r.integers(info.min, info.max, n, dtype=name,
                          endpoint=True)
        ext = name.capitalize().replace("Uint", "UInt")
        frames[name] = pd.DataFrame({
            "plain": vals,
            "nullable": pd.array(np.where(null, None, vals).tolist(),
                                 dtype=ext),
        })
    for name in ("float32", "float64"):
        vals = r.normal(size=n).astype(name)
        vals[null] = np.nan
        vals[:2] = [-0.0, np.inf]
        frames[name] = pd.DataFrame({"f": vals})
    b = r.random(n) < 0.5
    frames["bool"] = pd.DataFrame({
        "plain": b,
        "nullable": pd.array(np.where(null, None, b).tolist(),
                             dtype="boolean"),
    })
    words = np.array(["kiwi", "apple", "", "zebra", "Äpfel", "b"])
    s = words[r.integers(0, len(words), n)].astype(object)
    s[null] = None
    frames["string"] = pd.DataFrame({"s": s, "full": words[r.integers(
        0, len(words), n)]})
    ns = r.integers(-3 * 10**18, 3 * 10**18, n).astype("datetime64[ns]")
    ns[null] = np.datetime64("NaT")
    frames["datetime64[ns]"] = pd.DataFrame({"t": ns})
    td = r.integers(-10**15, 10**15, n).astype("timedelta64[ns]")
    td[null] = np.timedelta64("NaT")
    frames["timedelta64[ns]"] = pd.DataFrame({"d": td})
    days = r.integers(-30000, 30000, n)
    dates = np.array([datetime.date(1970, 1, 1) + datetime.timedelta(int(d))
                      for d in days], dtype=object)
    dates[null] = None
    frames["date"] = pd.DataFrame({"d": dates})
    dec = np.array([decimal.Decimal(int(v)).scaleb(-2)
                    for v in r.integers(-10**9, 10**9, n)], dtype=object)
    dec[null] = None
    frames["decimal"] = pd.DataFrame({"m": dec})
    return frames


_FRAMES = _frames()


def _check_round_capacity():
    from bodo_tpu.table.table import round_capacity as ref_round
    from bodo_tpu_torch.table import round_capacity
    for n in (0, 1, 127, 128, 129, 20_000, 20_000_000):
        assert round_capacity(n) == ref_round(n)


def _check_pandas_round_trip(kind):
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.table import Table
    df = _FRAMES[kind]
    ref = RefTable.from_pandas(df)
    port = Table.from_pandas(df, device="cpu")
    assert_same_table(port, ref)
    pd.testing.assert_frame_equal(port.to_pandas(), ref.to_pandas(),
                                  obj=kind)


def _check_from_reference_arrays(kind):
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.table import from_reference_arrays
    ref = RefTable.from_pandas(_FRAMES[kind])
    port = from_reference_arrays(export_reference(ref), ref.nrows,
                                 device="cpu")
    assert_same_table(port, ref, check_vrange=True)
    pd.testing.assert_frame_equal(port.to_pandas(), ref.to_pandas(),
                                  obj=kind)


def _check_numpy_round_trip():
    from bodo_tpu_torch.table import Table
    arrays = {"i": np.arange(5, dtype=np.int16),
              "f": np.array([0.5, np.nan, 1, 2, 3]),
              "s": np.array(["b", "a", "b", "c", "a"]),
              "t": np.arange(5).astype("datetime64[D]")
              .astype("datetime64[ns]")}
    t = Table.from_numpy(arrays, device="cpu")
    assert t.capacity == 128 and t.nrows == 5
    out = t.to_numpy()
    np.testing.assert_array_equal(out["i"], arrays["i"])
    np.testing.assert_array_equal(out["f"], arrays["f"])
    assert out["s"].tolist() == arrays["s"].tolist()
    assert t.column("s").dictionary.tolist() == ["a", "b", "c"]
    np.testing.assert_array_equal(out["t"], arrays["t"])


def _io_frame():
    r = np.random.default_rng(3)
    n = 1000
    null = r.random(n) < 0.1
    ints = r.integers(-50, 50, n)
    return pd.DataFrame({
        "i": ints,
        "ni": pd.array(np.where(null, None, ints).tolist(), dtype="Int32"),
        "f": np.where(null, np.nan, r.normal(size=n)),
        "b": r.random(n) < 0.3,
        "s": np.where(null, None, np.array(["x", "yy", "z"])[
            r.integers(0, 3, n)]),
        "t": (np.datetime64("1969-06-01") + r.integers(0, 10**6, n)
              .astype("timedelta64[s]")).astype("datetime64[ns]"),
    })


def _check_read_parquet(tmp_path):
    from bodo_tpu.io import read_parquet as ref_read
    from bodo_tpu_torch.io import read_parquet
    path = str(tmp_path / "t.parquet")
    _io_frame().to_parquet(path, row_group_size=300)
    ref = ref_read(path)
    port = read_parquet(path, device="cpu")
    assert_same_table(port, ref, check_vrange=True)
    assert port.column("i").vrange is not None


def _check_read_csv_parse_dates(tmp_path):
    from bodo_tpu.io import read_csv as ref_read
    from bodo_tpu_torch.io import read_csv
    path = str(tmp_path / "t.csv")
    _io_frame().to_csv(path, index=False)
    ref = ref_read(path, parse_dates=["t"])
    port = read_csv(path, parse_dates=["t"], device="cpu")
    assert_same_table(port, ref, check_vrange=True)
    assert port.column("t").dtype.name == "datetime64[ns]"


def test_table_matches_reference(reference, tmp_path):
    _check_round_capacity()
    for kind in sorted(_FRAMES):  # every dtype of table/dtypes.py
        _check_pandas_round_trip(kind)
        _check_from_reference_arrays(kind)
    _check_numpy_round_trip()
    _check_read_parquet(tmp_path)
    _check_read_csv_parse_dates(tmp_path)
