"""relational.concat_tables (UNION ALL) of the port against bodo_tpu on the
same inputs, on a CPU mesh of 4 shards: REP + REP, 1D + 1D and REP + 1D
(the result is replicated, 1D inputs gathered in shard order); string
columns whose dictionaries differ between the inputs; nulls in one input
only (the other gets an all-valid mask); int32 + int64 and int64 +
float64 promotion; decimals of one scale (the largest precision kept)
and of mixed scales (descaled to float64); an empty input among others,
and only empty inputs; three inputs. Counts, capacities, dictionaries,
validity and data bit-identical (decimals descaled to float64 too: the
same division in both); the route (`concat_tables`) equal to the
reference's.

Then fault F9 (ROADMAP): columns of one datetime or timedelta type keep
their type in the port, where the reference relabels the physical
integers as int64; the physical values are held equal to the reference's
and the type pinned. One test runs every check (see tests/torch_parity.py
on why each test_torch_* file holds one test).
"""

import decimal

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_table,  # noqa: F401
                                port_routes_reset, reference,
                                reference_routes, to_port,
                                torch_one_thread)

SHARDS = 4


def _frame(r, n: int, words, nulls: bool, int_dtype=np.int64,
           f_dtype=np.float64):
    i = r.integers(-50, 50, n).astype(int_dtype)
    f = r.normal(size=n).astype(f_dtype)
    s = r.choice(words, n).astype(object)
    if nulls and n:
        s[r.random(n) < 0.3] = None
        i = pd.array(np.where(r.random(n) < 0.3, None, i),
                     dtype=pd.api.types.pandas_dtype(int_dtype).name
                     .capitalize())
    return pd.DataFrame({"i": i, "f": f, "s": s})


def _decimals(r, n: int, scale: int):
    q = decimal.Decimal(1).scaleb(-scale)
    vals = [decimal.Decimal(int(v)).scaleb(-scale).quantize(q)
            for v in r.integers(-10**5, 10**5, n)]
    return pd.DataFrame({"d": pd.Series(vals, dtype=object)})


def _check(frames, layouts=None):
    import bodo_tpu.relational as R
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR

    layouts = layouts or ["REP"] * len(frames)
    ref_in = []
    for df, lay in zip(frames, layouts):
        t = RefTable.from_pandas(df)
        ref_in.append(t.shard() if lay == "1D" else t)
    with reference_routes() as ref_routes:
        ref = R.concat_tables(ref_in)
    routes = port_routes_reset()
    port = PR.concat_tables([to_port(t) for t in ref_in])
    assert_same_table(port, ref)
    assert routes == ref_routes and routes["concat_tables"] == 1
    return port


def _check_f9():
    """Datetime and timedelta columns keep their type (F9)."""
    import bodo_tpu.relational as R
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR

    a = pd.DataFrame({"t": pd.to_datetime(["2024-01-01", "2024-02-01"]),
                      "d": pd.to_timedelta([5, 7], unit="s")})
    b = pd.DataFrame({"t": pd.to_datetime(["2024-03-01 10:00"]),
                      "d": pd.to_timedelta([9], unit="h")})
    ref_in = [RefTable.from_pandas(a), RefTable.from_pandas(b).shard()]
    ref = R.concat_tables(ref_in)
    port = PR.concat_tables([to_port(t) for t in ref_in])
    for name, want_ref, want_port in (("t", "int64", "datetime64[ns]"),
                                      ("d", "int64", "timedelta64[ns]")):
        assert ref.column(name).dtype.name == want_ref
        assert port.column(name).dtype.name == want_port
        np.testing.assert_array_equal(
            port.column(name).data.numpy()[:3],
            np.asarray(ref.column(name).data)[:3])
    got = port.to_pandas()
    np.testing.assert_array_equal(got["t"], pd.concat([a["t"], b["t"]]))


def test_concat_tables_matches_reference(reference):
    import jax
    import bodo_tpu
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    r = np.random.default_rng(7)
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    port_mesh = make_mesh(SHARDS, device="cpu")
    with bodo_tpu.use_mesh(ref_mesh), use_mesh(port_mesh):
        a = _frame(r, 700, ["aa", "bb", "cc"], nulls=False)
        b = _frame(r, 450, ["bb", "dd", "ee", "ff"], nulls=True)
        for lay in (["REP", "REP"], ["1D", "1D"], ["REP", "1D"],
                    ["1D", "REP"]):
            out = _check([a, b], lay)
            assert out.distribution == "REP" and out.nrows == 1150
        got = out.to_pandas()["s"]
        want = pd.concat([a["s"], b["s"]], ignore_index=True)
        np.testing.assert_array_equal(got.isna(), want.isna())
        np.testing.assert_array_equal(got[~got.isna()].astype(str),
                                      want[~want.isna()].astype(str))
        # int32 + int64, float32 + float64
        c = _frame(r, 300, ["zz"], nulls=True, int_dtype=np.int32,
                   f_dtype=np.float32)
        out = _check([c, a], ["1D", "REP"])
        assert out.column("i").dtype.name == "int64"
        assert out.column("f").dtype.name == "float64"
        # int + float in one column
        d = a.assign(i=a["i"].astype(np.float64) + 0.5)
        out = _check([a, d])
        assert out.column("i").dtype.name == "float64"
        # decimals: one scale (largest precision kept), mixed scales
        out = _check([_decimals(r, 200, 2), _decimals(r, 90, 2)],
                     ["1D", "REP"])
        assert out.column("d").dtype.name.startswith("decimal")
        out = _check([_decimals(r, 200, 2), _decimals(r, 90, 4)],
                     ["REP", "1D"])
        assert out.column("d").dtype.name == "float64"
        # decimal beside float64
        out = _check([_decimals(r, 60, 3),
                      pd.DataFrame({"d": r.normal(size=25)})])
        assert out.column("d").dtype.name == "float64"
        # empty inputs: one among others, and only empty ones
        e = b.iloc[:0]
        _check([e, a, e], ["REP", "1D", "1D"])
        _check([e, e], ["1D", "REP"])
        # three inputs, one with nulls
        _check([a, b, c], ["1D", "1D", "1D"])
        _check_f9()
