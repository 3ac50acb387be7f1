"""The index of the port's lazy pandas frontend (a column threaded through
the plan: set_index, reset_index, sort_index, filters and sorts that keep
it, groupby(as_index=True), the multi-index, drop=False, assignment to
the index's name, attribute access, groupby size naming) against the JAX
package's frontend and against pandas: the programs of
tests/test_index.py, each run through both frontends on the same seeded
frames, REP and on a CPU mesh of 4 shards (sources of 64 rows or more
sharded in both packages).

Port against reference: frames, Series and indexes equal (index values
and names, dtypes, row order exact; float64 within rtol 1e-12), the
same optimized plans and routes. Port against pandas: the reference
tests' comparisons (pandas.testing, dtypes not checked). A groupby's
rows come in shard order on 1D, so its results are compared to pandas
after sort_index, as tests/test_index.py does. The fallback warning is
an error throughout. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test)."""

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (assert_same_result, frontend_meshes,
                                no_fallback, reference, run_frontends,
                                torch_one_thread)  # noqa: F401

SHARDS = 4
F64_RTOL = 1e-12
SHARD_MIN_ROWS = 64


def _df(n=200, seed=0):
    r = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": r.integers(0, 8, n),
        "u": np.arange(n) * 3 + 1,
        "v": r.normal(size=n),
        "c": r.choice(["x", "yy", "zzz"], n),
    })


def _src(fe, df):
    return fe.bd.from_pandas(df, **fe.kw)


# ---- the programs: each returns [(result, pandas' expectation), ...] ----

def _set_index_roundtrip(fe):
    df = _df()
    return [(_src(fe, df).set_index("u").to_pandas(), df.set_index("u"))]


def _set_index_through_filter_sort(fe):
    df = _df()
    b = _src(fe, df).set_index("u")
    exp = df.set_index("u")
    return [(b[b["v"] > 0].sort_values("v").to_pandas(),
             exp[exp["v"] > 0].sort_values("v"))]


def _reset_index(fe):
    df = _df()
    b = _src(fe, df).set_index("u")
    exp = df.set_index("u").reset_index()
    return [(b.reset_index().to_pandas()[list(exp.columns)], exp),
            (b.reset_index(drop=True).to_pandas(),
             df.set_index("u").reset_index(drop=True))]


def _sort_index(fe):
    df = _df()
    b = _src(fe, df).set_index("u").sort_values("v")
    return [(b.sort_index().to_pandas(),
             df.set_index("u").sort_values("v").sort_index())]


def _string_index(fe):
    df = _df(50)
    return [(_src(fe, df).set_index("c").sort_values("u").to_pandas(),
             df.set_index("c").sort_values("u"))]


def _multi_index(fe):
    df = _df(100)
    return [(_src(fe, df).set_index(["k", "c"]).sort_values("u").to_pandas(),
             df.set_index(["k", "c"]).sort_values("u"))]


def _groupby_as_index_frame(fe):
    df = _df()
    got = _src(fe, df).groupby("k").agg(v_sum=("v", "sum"),
                                        v_mean=("v", "mean")).to_pandas()
    exp = df.groupby("k").agg(v_sum=("v", "sum"), v_mean=("v", "mean"))
    return [(got.sort_index(), exp.sort_index())]


def _groupby_as_index_series(fe):
    df = _df()
    got = _src(fe, df).groupby("k")["v"].sum().to_pandas()
    return [(got.sort_index(), df.groupby("k")["v"].sum().sort_index())]


def _groupby_as_index_multikey(fe):
    df = _df()
    got = _src(fe, df).groupby(["k", "c"]).agg(s=("v", "sum")).to_pandas()
    exp = df.groupby(["k", "c"]).agg(s=("v", "sum"))
    return [(got.sort_index(), exp.sort_index())]


def _groupby_result_reset_index(fe):
    df = _df()
    got = (_src(fe, df).groupby("k").agg(s=("v", "sum")).reset_index()
           .to_pandas())
    exp = df.groupby("k").agg(s=("v", "sum")).reset_index()
    return [(got.sort_values("k").reset_index(drop=True),
             exp.sort_values("k").reset_index(drop=True))]


def _groupby_series_sort_index_and_ops(fe):
    df = _df()
    s = _src(fe, df).groupby("k")["v"].mean()
    return [((s * 2).sort_index().to_pandas(),
             (df.groupby("k")["v"].mean() * 2).sort_index())]


def _column_selection_keeps_index(fe):
    df = _df()
    b = _src(fe, df).set_index("u")
    return [(b[["v", "k"]].to_pandas(), df.set_index("u")[["v", "k"]]),
            (b["v"].to_pandas(), df.set_index("u")["v"])]


def _index_excluded_from_columns(fe):
    b = _src(fe, _df()).set_index("u")
    with pytest.raises(KeyError):
        b["u"]
    return [("u" in list(b.columns), False)]


def _head_keeps_index(fe):
    df = _df()
    return [(_src(fe, df).set_index("u").head(7).to_pandas(),
             df.set_index("u").head(7))]


def _series_index_property(fe):
    df = _df(40)
    b = _src(fe, df).set_index("u")
    return [(list(b["v"].index), list(df.set_index("u")["v"].index))]


def _chained_set_index_drops_previous(fe):
    df = _df(60)
    exp = df.set_index("u").set_index("k")
    got = _src(fe, df).set_index("u").set_index("k").to_pandas()
    return [(got[list(exp.columns)], exp)]


def _set_index_drop_false(fe):
    df = _df(60)
    exp = df.set_index("u", drop=False)
    got = _src(fe, df).set_index("u", drop=False).to_pandas()
    return [(got[list(exp.columns)], exp)]


def _assign_to_index_name_keeps_index(fe):
    df = _df(60)
    b = _src(fe, df).set_index("u")
    b["u"] = b["v"] * 0 + 7.0
    exp = df.set_index("u")
    exp["u"] = 7.0
    return [(b.to_pandas()[list(exp.columns)], exp)]


def _attr_access_matches_getitem(fe):
    df = _df(60)
    b = _src(fe, df).set_index("u")
    with pytest.raises(AttributeError):
        b.u  # the index column is hidden on the attribute path too
    return [(b.v.to_pandas(), b["v"].to_pandas())]


def _groupby_size_naming(fe):
    df = _df(60)
    got = _src(fe, df).groupby("k")["v"].size()
    got_f = _src(fe, df).groupby("k").size()
    return [(got.sort_index(), df.groupby("k")["v"].size().sort_index()),
            (got_f.sort_index(), df.groupby("k").size().sort_index())]


PROGRAMS = {
    "set_index_roundtrip": _set_index_roundtrip,
    "through_filter_sort": _set_index_through_filter_sort,
    "reset_index": _reset_index,
    "sort_index": _sort_index,
    "string_index": _string_index,
    "multi_index": _multi_index,
    "as_index_frame": _groupby_as_index_frame,
    "as_index_series": _groupby_as_index_series,
    "as_index_multikey": _groupby_as_index_multikey,
    "result_reset_index": _groupby_result_reset_index,
    "series_sort_index_ops": _groupby_series_sort_index_and_ops,
    "selection_keeps_index": _column_selection_keeps_index,
    "index_not_a_column": _index_excluded_from_columns,
    "head_keeps_index": _head_keeps_index,
    "series_index": _series_index_property,
    "chained_set_index": _chained_set_index_drops_previous,
    "drop_false": _set_index_drop_false,
    "assign_to_index_name": _assign_to_index_name_keeps_index,
    "attr_access": _attr_access_matches_getitem,
    "size_naming": _groupby_size_naming,
}


def _vs_pandas(got, exp, label):
    if isinstance(exp, pd.DataFrame):
        pd.testing.assert_frame_equal(got, exp, check_dtype=False, obj=label)
    elif isinstance(exp, pd.Series):
        pd.testing.assert_series_equal(got, exp, check_dtype=False,
                                       obj=label)
    else:
        assert got == exp, label


def test_frontend_index_matches_reference_and_pandas(reference):
    assert len(PROGRAMS) == 20
    with no_fallback():
        for shards in (1, SHARDS):
            for name, prog in PROGRAMS.items():
                label = f"{name} x{shards}"
                with frontend_meshes(shards, SHARD_MIN_ROWS):
                    ref, port, _ = run_frontends(prog, label)
                for i, ((got, exp), (want, _)) in enumerate(zip(port, ref)):
                    assert_same_result(got, want, F64_RTOL, f"{label}[{i}]")
                    _vs_pandas(got, exp, f"{label}[{i}] vs pandas")
