"""The port's lazy pandas frontend (bodo_tpu_torch.pandas_api) against
the JAX package's (bodo_tpu.pandas_api) and against pandas: the programs
of tests/test_frontend.py and tests/test_categorical_str.py that run on
ported plan and expression nodes, each run through both frontends on
the same seeded frames, REP and on a CPU mesh of 4 shards (sources of 64
rows or more sharded in both packages).

Port against reference: frames and Series equal (index, dtypes,
integers, strings, dates, nulls and row order exact; float64 within rtol
1e-12: sums in another order), scalars likewise; every plan the
frontends execute has the reference's optimized key(); both packages
take the same routes. Port against pandas: the reference tests'
comparisons (floats within rtol 1e-9).

The pandas fallback warns only where the API asks for it (describe);
everywhere else the fallback warning is an error. Last, every route the
port has not ported raises NotImplementedError naming its module or
node: the compiled UDF (RowUDF: Series.map(callable),
DataFrame.apply(axis=1)), the string nodes StrLen, StrHostFn, StrConcat,
StrCodes and DictMap's other kinds, the nested accessors and explode
(table/nested.py), `.ai`, the writers, read_json, read_iceberg,
read_csv(chunksize=...) and explain_analyze. One test runs every check
(see tests/torch_parity.py on why each test_torch_* file holds one
test)."""

import numpy as np
import pandas as pd
import pytest

from tests.conftest import make_df
from tests.torch_parity import (assert_same_result, frontend_meshes,
                                no_fallback, reference, run_frontends,
                                torch_one_thread)  # noqa: F401

SHARDS = 4
F64_RTOL = 1e-12
PANDAS_RTOL = 1e-9
SHARD_MIN_ROWS = 64


def _cmp_frames(got, exp, sort_by=None):
    """tests/test_frontend.py's comparison against pandas."""
    if sort_by:
        got = got.sort_values(sort_by).reset_index(drop=True)
        exp = exp.sort_values(sort_by).reset_index(drop=True)
    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp)
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype.kind in "fiu":
            np.testing.assert_allclose(g.to_numpy(dtype=float),
                                       e.to_numpy(dtype=float),
                                       rtol=PANDAS_RTOL, equal_nan=True,
                                       err_msg=c)
        else:
            assert [str(x) for x in g] == [str(x) for x in e], c


# ---- the programs: each returns (its results, pandas' expectations) -----

def _filter_mask_and_columns(fe):
    df = make_df(400, nulls=True)
    b = fe.bd.from_pandas(df, **fe.kw)
    got = b[b["a"] > 5][["a", "b"]].to_pandas()
    return got, df[df["a"] > 5][["a", "b"]].reset_index(drop=True)


def _setitem_assign_arith(fe):
    df = make_df(300)
    b = fe.bd.from_pandas(df, **fe.kw)
    b["e"] = b["a"] * 2 + b["d"]
    exp = df.copy()
    exp["e"] = exp["a"] * 2 + exp["d"]
    b2 = fe.bd.from_pandas(df, **fe.kw).assign(f=lambda x: x["b"] + 1.0)
    return ((b.to_pandas(), b2.to_pandas()["f"]),
            (exp, (df["b"] + 1.0).rename("f")))


def _merge_groupby_sort(fe):
    df = make_df(500)
    lookup = pd.DataFrame({"a": range(10), "w": np.arange(10) * 1.5})
    b = fe.bd.from_pandas(df, **fe.kw).merge(
        fe.bd.from_pandas(lookup, **fe.kw), on="a")
    g = b.groupby(["c"], as_index=False).agg(
        total=("w", "sum"), mu=("b", "mean"))
    exp = (df.merge(lookup, on="a").groupby("c", as_index=False)
           .agg(total=("w", "sum"), mu=("b", "mean"))
           .sort_values("c").reset_index(drop=True))
    return g.sort_values("c").to_pandas(), exp


def _groupby_as_index_and_size(fe):
    df = make_df(400)
    b = fe.bd.from_pandas(df, **fe.kw)
    return ((b.groupby("a")["b"].sum().to_pandas(), b.groupby("a").size()),
            (df.groupby("a")["b"].sum(), df.groupby("a").size()))


def _groupby_dict_agg(fe):
    df = make_df(400, nulls=True)
    got = (fe.bd.from_pandas(df, **fe.kw).groupby("a", as_index=False)
           .agg({"b": "sum", "d": "max"}).sort_values("a").to_pandas())
    exp = df.groupby("a", as_index=False).agg({"b": "sum", "d": "max"})
    return got, exp


def _series_reductions(fe):
    df = make_df(500, nulls=True)
    s = fe.bd.from_pandas(df, **fe.kw)["b"]
    e = fe.bd.from_pandas(df, **fe.kw)["e"]
    return ((float(s.sum()), float(s.mean()), float(s.std()),
             int(s.count()), int(e.count()), int(e.sum())),
            (df["b"].sum(), df["b"].mean(), df["b"].std(),
             df["b"].count(), df["e"].count(), int(df["e"].sum())))


def _series_value_counts_unique(fe):
    df = make_df(400)
    s = fe.bd.from_pandas(df, **fe.kw)["c"]
    return ((s.value_counts().sort_index(), sorted(s.unique()),
             s.nunique()),
            (df["c"].value_counts().sort_index(),
             sorted(df["c"].unique()), df["c"].nunique()))


def _str_and_dt_accessors(fe):
    df = pd.DataFrame({
        "s": ["apple", "banana", "cherry", "apricot"] * 25,
        "t": pd.date_range("2024-01-01", periods=100, freq="11h"),
    })
    b = fe.bd.from_pandas(df, **fe.kw)
    starts = b[b["s"].str.startswith("ap")].to_pandas()
    contains = len(b[b["s"].str.contains("an")])
    fields = b.assign(mo=b["t"].dt.month, hr=b["t"].dt.hour,
                      mi=b["t"].dt.minute, doy=b["t"].dt.dayofyear,
                      q=b["t"].dt.quarter, wk=b["t"].dt.week).to_pandas()
    exp = df.assign(mo=df["t"].dt.month, hr=df["t"].dt.hour,
                    mi=df["t"].dt.minute, doy=df["t"].dt.dayofyear,
                    q=df["t"].dt.quarter,
                    wk=df["t"].dt.isocalendar().week.astype(np.int64))
    return ((starts, contains, fields),
            (df[df["s"].str.startswith("ap")].reset_index(drop=True),
             int(df["s"].str.contains("an").sum()), exp))


def _series_eq_string_and_isin(fe):
    df = make_df(300)
    b = fe.bd.from_pandas(df, **fe.kw)
    return ((len(b[b["c"] == "x"]), len(b[b["c"].isin(["x", "w"])]),
             len(b[b["c"] != "x"])),
            (int((df["c"] == "x").sum()), int(df["c"].isin(["x", "w"]).sum()),
             int((df["c"] != "x").sum())))


def _map_dict(fe):
    df = make_df(200)
    b = fe.bd.from_pandas(df, **fe.kw)
    b["m"] = b["a"].map({i: i * 10.0 for i in range(10)})
    b["n"] = b["a"].map({1: 5, 2: 6}).fillna(4.0).astype("int32")
    exp = df.copy()
    exp["m"] = df["a"].map({i: i * 10.0 for i in range(10)})
    exp["n"] = df["a"].map({1: 5, 2: 6}).fillna(4.0).astype("int32")
    return b.to_pandas(), exp


def _drop_rename_head_dedup(fe):
    df = make_df(300)
    b = fe.bd.from_pandas(df, **fe.kw)
    dd = b[["a", "c"]].drop_duplicates()
    return ((list(b.drop(columns=["b"]).columns),
             list(b.rename(columns={"a": "A"}).columns), len(b.head(7)),
             len(dd), dd.sort_values(["a", "c"]).to_pandas()),
            (["a", "c", "d"], ["A", "b", "c", "d"], 7,
             len(df[["a", "c"]].drop_duplicates()),
             df[["a", "c"]].drop_duplicates().sort_values(["a", "c"])
             .reset_index(drop=True)))


def _fallback_warns(fe):
    df = make_df(100)
    b = fe.bd.from_pandas(df, **fe.kw)
    with pytest.warns(UserWarning, match="falling back"):
        res = b.describe()
    assert isinstance(res, pd.DataFrame)
    return res, df.describe()


def _read_parquet_column_pruning(fe, tmp_path):
    df = make_df(300)
    path = str(tmp_path / "t.parquet")
    df.to_parquet(path)
    g = fe.bd.read_parquet(path, **fe.kw).groupby("a", as_index=False).agg(
        s=("b", "sum"))
    scan = fe.optimize(g._plan)
    while scan.children:
        scan = scan.children[0]
    got = g.to_pandas().sort_values("a").reset_index(drop=True)
    exp = df.groupby("a", as_index=False).agg(s=("b", "sum"))
    return (sorted(scan.columns), got), (["a", "b"], exp)


def _filter_pushdown_through_projection(fe):
    df = make_df(300)
    b = fe.bd.from_pandas(df, **fe.kw)
    b["e"] = b["a"] * 2
    f = b[b["a"] > 3]
    plan = fe.optimize(f._plan)
    shape = (type(plan).__name__, type(plan.child).__name__)
    assert isinstance(plan, fe.L.Projection) and \
        isinstance(plan.child, fe.L.Filter)
    exp = df.assign(e=df["a"] * 2)[df["a"] > 3].reset_index(drop=True)
    return (shape, f.to_pandas()), (("Projection", "Filter"), exp)


def _concat(fe):
    a = pd.DataFrame({"x": [1, 2], "s": ["a", "b"]})
    b_ = pd.DataFrame({"x": [3, 4], "s": ["c", "a"]})
    out = fe.bd.concat([fe.bd.from_pandas(a, **fe.kw), b_]).to_pandas()
    return out, pd.concat([a, b_], ignore_index=True)


def _categorical_frame():
    r = np.random.default_rng(3)
    n = 300
    return pd.DataFrame({
        "s": r.choice(["apple", "banana", "cherry", "date", "elder"], n),
        "t": r.choice(["x-1", "y-22", "z-333", ""], n),
        "v": r.normal(size=n),
    })


def _categorical(fe):
    pdf = _categorical_frame()
    bdf = fe.bd.from_pandas(pdf, **fe.kw)
    cat = bdf["s"].astype("category").to_pandas()
    assert cat.dtype == "category"
    # the property's AttributeError sends the lookup to __getattr__, whose
    # pandas fallback warns, and pandas raises it again
    with pytest.raises(AttributeError), \
            pytest.warns(UserWarning, match="Series.cat: falling back"):
        bdf["v"].cat
    by = (bdf.groupby("s", as_index=False).agg(m=("v", "mean")).to_pandas()
          .sort_values("s").reset_index(drop=True))
    filtered = bdf[bdf["v"] > 0]["s"].astype("category").to_pandas()
    got = (cat, list(cat.cat.categories), list(bdf["s"].cat.categories),
           by, list(filtered))
    exp_cat = pdf["s"].astype("category")
    exp = (exp_cat, list(exp_cat.cat.categories),
           list(exp_cat.cat.categories),
           pdf.groupby("s", as_index=False).agg(m=("v", "mean"))
           .sort_values("s").reset_index(drop=True),
           list(pdf[pdf["v"] > 0]["s"].astype("category")))
    return got, exp


def _str_fullmatch_isin(fe):
    pdf = _categorical_frame()
    bdf = fe.bd.from_pandas(pdf, **fe.kw)
    return ((bdf["s"].str.fullmatch("[a-d]+").to_pandas(),
             bdf["s"].str.isin(["apple", "date"]).to_pandas()),
            (pdf["s"].str.fullmatch("[a-d]+"),
             pdf["s"].isin(["apple", "date"]).rename("s")))


def _check_against_pandas(name, got, exp):
    if isinstance(exp, pd.DataFrame):
        _cmp_frames(got, exp)
    elif isinstance(exp, pd.Series):
        # a groupby's result on 1D comes in shard order
        got, exp = got.sort_index(kind="stable"), exp.sort_index(kind="stable")
        assert list(got.index) == list(exp.index), name
        if exp.dtype.kind in "fiub":
            np.testing.assert_allclose(
                np.asarray(got, dtype=float), np.asarray(exp, dtype=float),
                rtol=PANDAS_RTOL, equal_nan=True, err_msg=name)
        else:
            assert [str(x) for x in got] == [str(x) for x in exp], name
    elif isinstance(exp, tuple):
        for i, (g, e) in enumerate(zip(got, exp)):
            _check_against_pandas(f"{name}[{i}]", g, e)
    elif isinstance(exp, (float, np.floating)):
        np.testing.assert_allclose(got, exp, rtol=PANDAS_RTOL, err_msg=name)
    else:
        assert got == exp, (name, got, exp)


def _check_programs(tmp_path, shards):
    programs = {
        "filter": _filter_mask_and_columns,
        "setitem": _setitem_assign_arith,
        "merge": _merge_groupby_sort,
        "as_index": _groupby_as_index_and_size,
        "dict_agg": _groupby_dict_agg,
        "reductions": _series_reductions,
        "value_counts": _series_value_counts_unique,
        "accessors": _str_and_dt_accessors,
        "eq_isin": _series_eq_string_and_isin,
        "map": _map_dict,
        "drop": _drop_rename_head_dedup,
        "fallback": _fallback_warns,
        "pruning": lambda fe: _read_parquet_column_pruning(fe, tmp_path),
        "pushdown": _filter_pushdown_through_projection,
        "concat": _concat,
        "categorical": _categorical,
        "fullmatch": _str_fullmatch_isin,
    }
    for name, prog in programs.items():
        label = f"{name} x{shards}"
        with frontend_meshes(shards, SHARD_MIN_ROWS):
            ref, port, _ = run_frontends(prog, label)
        assert_same_result(port[0], ref[0], F64_RTOL, label)
        _check_against_pandas(label, port[0], port[1])


def _check_unported_routes_raise(tmp_path):
    import bodo_tpu_torch.pandas_api as bd
    df = make_df(50)
    b = bd.from_pandas(df, device="cpu")
    s = bd.from_pandas(_categorical_frame(), device="cpu")["s"]
    path = str(tmp_path / "u.parquet")
    df.to_parquet(path)
    csv = str(tmp_path / "u.csv")
    df.to_csv(csv, index=False)
    cases = [
        ("RowUDF", lambda: b["a"].map(lambda x: x + 1)),
        ("RowUDF", lambda: b.apply(lambda r: r["a"] + r["d"], axis=1)),
        ("StrLen", lambda: s.str.len().to_pandas()),
        ("StrHostFn", lambda: s.str.find("an").to_pandas()),
        ("StrHostFn", lambda: s.str.count("[0-9]").to_pandas()),
        ("StrConcat", lambda: s.str.cat(s, sep="/").to_pandas()),
        ("StrCodes", lambda: s.cat.codes.to_pandas()),
        ("DictMap", lambda: s.str.pad(8, "left", "*").to_pandas()),
        ("table/nested", lambda: s.list),
        ("table/nested", lambda: s.struct),
        ("table/nested", lambda: s.str.split("a")),
        ("table/nested", lambda: b.explode("a")),
        ("ai/", lambda: s.ai),
        ("io/parquet", lambda: b.to_parquet(str(tmp_path / "o.pq"))),
        ("io/iceberg", lambda: b.to_iceberg(str(tmp_path / "ice"))),
        ("io/iceberg", lambda: bd.read_iceberg(str(tmp_path / "ice"))),
        ("io/json", lambda: bd.read_json(path)),
        ("io/csv", lambda: bd.read_csv(csv, chunksize=10)),
        ("io/csv", lambda: bd.read_csv(csv, iterator=True)),
        ("plan/explain", lambda: b.explain_analyze()),
    ]
    for module, call in cases:
        with pytest.raises(NotImplementedError, match=module):
            call()


def _check_devices(tmp_path):
    """A pandas frame merged or concatenated into a lazy one takes the
    lazy frame's device; lazy frames on two devices do not combine."""
    import torch
    import bodo_tpu_torch.pandas_api as bd
    from bodo_tpu_torch.pandas_api.frame import plan_device
    df = pd.DataFrame({"a": [1, 2, 3], "v": [0.5, 1.5, 2.5]})
    lazy = bd.from_pandas(df, device="cpu")
    assert plan_device(lazy.merge(df, on="a")._plan) == torch.device("cpu")
    assert plan_device(bd.concat([df, lazy])._plan) == torch.device("cpu")
    other = bd.from_pandas(df, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        lazy.merge(other, on="a")
    with pytest.raises(ValueError, match="different devices"):
        bd.concat([lazy, other])


def test_frontend_programs_match_reference_and_pandas(reference, tmp_path):
    with no_fallback():
        for shards in (1, SHARDS):
            _check_programs(tmp_path, shards)
    _check_unported_routes_raise(tmp_path)
    _check_devices(tmp_path)
