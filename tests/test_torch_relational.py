"""The port's relational operators against bodo_tpu.relational on the same
tables: each groupby route (dense, packed, hashed, sort), the dense-LUT
join (LUTs of 182 and 9,999 slots, both through lut_gather), the cross
join, sort_table, assign_columns and filter_table — with the same routes
taken; a join without keys other than the cross join raises ValueError.

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (assert_same_table, port_routes_reset,
                                reference, reference_routes,
                                torch_one_thread)  # noqa: F401

AGGS = [("v", "count", "n"), ("v", "size", "sz"), ("v", "mean", "m"),
        ("v", "sum", "s"), ("w", "sum", "ws"), ("w", "mean", "wm")]


def _both(df):
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.table import Table
    return RefTable.from_pandas(df), Table.from_pandas(df, device="cpu")


def _values(r, n):
    v = r.gamma(2.0, 2.5, n)
    v[r.random(n) < 0.05] = np.nan
    w = pd.array(np.where(r.random(n) < 0.1, None,
                          r.integers(-100, 100, n)).tolist(), dtype="Int64")
    return v, w


def _check_groupby(df, keys, want_routes, aggs=AGGS):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    ref_t, port_t = _both(df)
    with reference_routes() as ref_routes:
        ref = R.groupby_agg(ref_t, keys, aggs)
    routes = port_routes_reset()
    port = PR.groupby_agg(port_t, keys, aggs)
    # f64 segment sums in another order than XLA's scatter-add
    assert_same_table(port, ref, float_rtol=1e-12)
    assert routes == ref_routes
    assert {k: v for k, v in routes.items() if v} == want_routes


def _check_groupby_dense_route():
    r = np.random.default_rng(0)
    n = 5000
    v, w = _values(r, n)
    df = pd.DataFrame({
        "k1": r.integers(0, 10, n),
        "k2": r.integers(0, 6, n).astype(np.int32),
        "k3": np.array(["a", "b", "c", "d", "e"])[r.integers(0, 5, n)],
        "v": v, "w": w})
    _check_groupby(df, ["k1", "k2", "k3"], {"groupby_dense": 1})


def _check_groupby_packed_then_hashed_route():
    r = np.random.default_rng(1)
    n = 5000
    v, w = _values(r, n)
    k1 = r.integers(0, 1000, n)
    df = pd.DataFrame({
        "k1": pd.array(np.where(r.random(n) < 0.05, None, k1).tolist(),
                       dtype="Int64"),
        "k2": r.integers(-500, 500, n),
        "v": v, "w": w})
    _check_groupby(df, ["k1", "k2"],
                   {"groupby_packed": 1, "groupby_hashed": 1})


def _check_groupby_hashed_route_float_keys():
    r = np.random.default_rng(2)
    n = 4000
    v, w = _values(r, n)
    k = r.normal(size=n).round(2) + 0.0  # no -0.0: see test_torch_ops
    k[r.random(n) < 0.05] = np.nan
    df = pd.DataFrame({"k": k, "v": v, "w": w})
    _check_groupby(df, ["k"], {"groupby_hashed": 1})


def _check_groupby_sort_route():
    from bodo_tpu.config import config as ref_config
    from bodo_tpu_torch.config import config
    r = np.random.default_rng(3)
    n = 3000
    v, w = _values(r, n)
    df = pd.DataFrame({"k": r.normal(size=n).round(1) + 0.0,
                       "j": r.integers(0, 3, n), "v": v, "w": w})
    ref_config.hash_groupby = False
    config.hash_groupby = False
    try:
        _check_groupby(df, ["k", "j"], {"groupby_sort": 1})
    finally:
        config.hash_groupby = True


def _join_frames(r, n_left, key_hi, n_right):
    left = pd.DataFrame({
        "key": pd.array(np.where(r.random(n_left) < 0.05, None,
                                 r.integers(-5, key_hi + 5, n_left))
                        .tolist(), dtype="Int64"),
        "x": r.normal(size=n_left),
        "tag": np.array(["p", "q"])[r.integers(0, 2, n_left)],
    })
    right = pd.DataFrame({
        "key": r.choice(key_hi, n_right, replace=False),
        "x": r.normal(size=n_right),
        "label": np.array(["u", "v", "w"])[r.integers(0, 3, n_right)],
    })
    return left, right


def _check_join_dense_route(how, key_hi, n_right):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    left, right = _join_frames(np.random.default_rng(4), 3000, key_hi,
                               n_right)
    rl, pl = _both(left)
    rr, pr = _both(right)
    with reference_routes() as ref_routes:
        ref = R.join_tables(rl, rr, ["key"], ["key"], how)
    routes = port_routes_reset()
    port = PR.join_tables(pl, pr, ["key"], ["key"], how)
    assert_same_table(port, ref)
    assert routes == ref_routes
    assert routes["join_dense"] == 1
    assert port.names == ["key", "x_x", "tag", "x_y", "label"]


def _check_join_keyless():
    """The cross join against the reference's; a keyless inner join
    raises ValueError (ROADMAP F6: the reference fails inside its sort
    join)."""
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    rl, left = _both(pd.DataFrame({"k": [1, 2, 3]}))
    rd, dup = _both(pd.DataFrame({"k": [1, 1], "y": [0, 1]}))
    assert_same_table(PR.join_tables(left, dup, [], [], "cross"),
                      R.join_tables(rl, rd, [], [], "cross"))
    with pytest.raises(ValueError, match="how='cross'"):
        PR.join_tables(left, dup, [], [], "inner")


def _sort_frame(r, n):
    f = r.normal(size=n).round(1) + 0.0
    f[r.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "a": pd.array(np.where(r.random(n) < 0.1, None,
                               r.integers(0, 7, n)).tolist(), dtype="Int32"),
        "b": np.array(["x", "y", "z"])[r.integers(0, 3, n)],
        "f": f,
        "row": np.arange(n),
    })


def _check_sort_table(by, ascending, na_last):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    rt, pt = _both(_sort_frame(np.random.default_rng(5), 2000))
    with reference_routes() as ref_routes:
        ref = R.sort_table(rt, by, ascending, na_last)
    routes = port_routes_reset()
    port = PR.sort_table(pt, by, ascending, na_last)
    assert_same_table(port, ref)
    assert routes == ref_routes


def _check_assign_and_filter():
    import bodo_tpu.relational as R
    from bodo_tpu.plan import expr as RE
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.plan import expr as E
    r = np.random.default_rng(6)
    n = 2000
    ts = (np.datetime64("1969-11-01") + r.integers(0, 10**7, n)
          .astype("timedelta64[s]")).astype("datetime64[ns]")
    df = pd.DataFrame({"t": ts, "p": r.gamma(0.5, 0.3, n).round(2),
                       "i": pd.array(np.where(r.random(n) < 0.1, None,
                                              r.integers(0, 30, n)).tolist(),
                                     dtype="Int64")})
    rt, pt = _both(df)

    def exprs(X):
        c = X.ColRef
        h = X.DtField("hour", c("t"))
        return {
            "date": X.DtField("date", c("t")),
            "month": X.DtField("month", c("t")),
            "hour": h,
            "wk": X.IsIn(X.DtField("dayofweek", c("t")), (0, 1, 2, 3, 4)),
            "wet": c("p") > 0.1,
            "b": X.Where(X.IsIn(h, (8, 9, 10)), X.Lit(3),
                         X.Where(c("i") >= 20, X.Lit(1), X.Lit(4))),
            "both": (c("i") < 10) | (c("p") == 0.0),
        }

    ref = R.assign_columns(rt, exprs(RE))
    port = PR.assign_columns(pt, exprs(E))
    assert_same_table(port, ref, check_vrange=True)
    pred = lambda X: (X.ColRef("i") >= 5) & (X.ColRef("p") <= 0.3)  # noqa
    ref_f = R.filter_table(ref, pred(RE))
    port_f = PR.filter_table(port, pred(E))
    assert_same_table(port_f, ref_f, check_vrange=True)


def test_relational_matches_reference(reference):
    _check_groupby_dense_route()
    _check_groupby_packed_then_hashed_route()
    _check_groupby_hashed_route_float_keys()
    _check_groupby_sort_route()
    for how in ("inner", "left"):
        # a LUT the kernel takes (182 < 4096 slots) and one beyond it
        for key_hi, n_right in ((200, 150), (10_000, 700)):
            _check_join_dense_route(how, key_hi, n_right)
    _check_join_keyless()
    for by, ascending, na_last in (
            (["a", "b"], None, True),          # packed int64 sort
            (["f", "a"], None, True),          # float key
            (["b", "f"], [False, True], True),
            (["a", "f"], [True, False], False)):
        _check_sort_table(by, ascending, na_last)
    _check_assign_and_filter()
