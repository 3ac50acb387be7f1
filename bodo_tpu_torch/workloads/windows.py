"""The window functions' workload: SQL OVER clauses over TPC-H, the
relational window calls on lineitem, and window_table on the taxi trips,
each with an oracle independent of the port.

`WINDOW_SQL` are eight analytic queries over the TPC-H frames of
workloads/tpch.gen_tpch: ranking (W1, W2, W7), running and moving
aggregates (W3, W4, W5), LAG/LEAD (W6), FIRST_VALUE over dictionary
codes and SUM(...) OVER () (W8). Every ORDER BY that decides a value
ends in the table's key, so every answer is unique, and each query
orders its rows by the key, so a result compares row for row. Their
oracle is sqlite (3.25 or later has window functions), run by
workloads/tpch.py's oracle process.

`RANK_SPECS` and `AGG_SPECS` are rank_window and agg_window calls on
lineitem (partitioned, global, OVER () and an ordered frame without a
partition key); their oracle is the REP result of the same call.

`TABLE_SPECS` are window_table's ops over the taxi trips in pickup
order; `table_oracle` computes them with pandas (cumprod, cummax,
cummin, rolling(w), shift, diff) and the running sum in extended
precision.

Float tolerances: a window sum of the port is the difference of two
prefixes of the whole sorted column (a Hillis-Steele scan, ops/
window.prefix_scan), so it agrees with a sequential sum within
PREFIX_ULPS * 2^-52 * sum(|x|) in absolute terms (`prefix_atol`), not
within a relative bound of the frame's own sum. A window mean is that
sum over the frame's row count, so its tolerance is prefix_atol over the
count (`frame_counts`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# the float prefixes' absolute tolerance, in units of 2^-52 * sum(|x|):
# each of two prefixes is within about (log2 n + 1) roundings of values
# no larger than the largest prefix of |x| (n <= 2^25 here: 26)
PREFIX_ULPS = 64
# cumprod: one rounding a product in either order, so n * 2^-52 relative

WINDOW_SQL = {
    "W1": (
        "SELECT l_orderkey, l_linenumber, ROW_NUMBER() OVER (PARTITION BY "
        "l_orderkey ORDER BY l_extendedprice DESC, l_linenumber) AS rn "
        "FROM lineitem ORDER BY l_orderkey, l_linenumber"),
    "W2": (
        "SELECT l_suppkey, SUM(l_quantity) AS qty, RANK() OVER (ORDER BY "
        "SUM(l_quantity) DESC) AS rk, DENSE_RANK() OVER (ORDER BY "
        "SUM(l_quantity) DESC) AS drk FROM lineitem GROUP BY l_suppkey "
        "ORDER BY l_suppkey"),
    "W3": (
        "SELECT o_orderkey, o_custkey, SUM(o_totalprice) OVER (PARTITION BY "
        "o_custkey ORDER BY o_orderdate, o_orderkey ROWS BETWEEN UNBOUNDED "
        "PRECEDING AND CURRENT ROW) AS running FROM orders "
        "ORDER BY o_orderkey"),
    "W4": (
        "SELECT l_orderkey, l_linenumber, AVG(l_extendedprice) OVER "
        "(PARTITION BY l_partkey ORDER BY l_shipdate, l_orderkey, "
        "l_linenumber ROWS BETWEEN 6 PRECEDING AND CURRENT ROW) AS mavg "
        "FROM lineitem ORDER BY l_orderkey, l_linenumber"),
    "W5": (
        "SELECT l_orderkey, l_linenumber, MAX(l_extendedprice) OVER "
        "(PARTITION BY l_suppkey ORDER BY l_shipdate, l_orderkey, "
        "l_linenumber ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS mx, "
        "MIN(l_shipdate) OVER (PARTITION BY l_orderkey) AS first_ship "
        "FROM lineitem ORDER BY l_orderkey, l_linenumber"),
    "W6": (
        "SELECT o_orderkey, LAG(o_orderdate, 1) OVER (PARTITION BY "
        "o_custkey ORDER BY o_orderdate, o_orderkey) AS prev_date, "
        "LEAD(o_totalprice, 2) OVER (PARTITION BY o_custkey ORDER BY "
        "o_orderdate, o_orderkey) AS next2 FROM orders ORDER BY o_orderkey"),
    "W7": (
        "SELECT o_orderkey, NTILE(100) OVER (ORDER BY o_totalprice, "
        "o_orderkey) AS pct, COUNT(*) OVER (PARTITION BY o_orderpriority "
        "ORDER BY o_orderdate) AS n_upto FROM orders ORDER BY o_orderkey"),
    "W8": (
        "SELECT l_orderkey, l_linenumber, FIRST_VALUE(l_shipmode) OVER "
        "(PARTITION BY l_orderkey ORDER BY l_shipdate, l_linenumber) AS "
        "first_mode, SUM(l_quantity) OVER () AS total_qty FROM lineitem "
        "ORDER BY l_orderkey, l_linenumber"),
}

# the float result columns that are window sums, by query: the column
# whose sum(|x|) scales their tolerance ((table, column))
SUM_SOURCES = {
    ("W3", "running"): ("orders", "o_totalprice"),
    ("W4", "mavg"): ("lineitem", "l_extendedprice"),
    ("W8", "total_qty"): ("lineitem", "l_quantity"),
    ("W2", "qty"): ("lineitem", "l_quantity"),
}


def prefix_atol(x) -> float:
    """The absolute tolerance of window sums over the float column `x`."""
    return PREFIX_ULPS * 2.0 ** -52 * float(
        np.nansum(np.abs(np.asarray(x, dtype=np.float64))))


def _sortable(a) -> np.ndarray:
    """A host column as an array np.lexsort orders: dates and times as
    their int64 ticks."""
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype.kind in "mM" else a


def frame_counts(part, order, preceding: int) -> np.ndarray:
    """The rows of each row's ROWS BETWEEN `preceding` PRECEDING AND
    CURRENT ROW frame, partitioned by the column `part` and ordered by
    the columns `order` (ascending, together unique): min(preceding + 1,
    the row's position in its partition + 1), in input row order."""
    perm = np.lexsort([_sortable(a) for a in order[::-1]]
                      + [_sortable(part)])
    p = _sortable(part)[perm]
    idx = np.arange(len(p))
    start = np.ones(len(p), dtype=bool)
    start[1:] = p[1:] != p[:-1]
    first = np.maximum.accumulate(np.where(start, idx, 0))
    out = np.empty(len(p), dtype=np.int64)
    out[perm] = np.minimum(idx - first + 1, preceding + 1)
    return out


def sql_atols(data) -> Dict[str, Dict[str, object]]:
    """{query: {column: absolute tolerance}} of WINDOW_SQL's window sums
    and means over the frames `data`: W4's moving average per row, in
    the result's order (l_orderkey, l_linenumber)."""
    out: Dict[str, Dict[str, object]] = {}
    for (q, col), (table, src) in SUM_SOURCES.items():
        out.setdefault(q, {})[col] = prefix_atol(data[table][src])
    part, order, preceding = MEAN_FRAMES["mavg"]
    li = data["lineitem"]
    counts = frame_counts(li[part].to_numpy(),
                          [li[c].to_numpy() for c in order], preceding)
    key = np.lexsort((li["l_linenumber"].to_numpy(),
                      li["l_orderkey"].to_numpy()))
    out["W4"]["mavg"] = out["W4"]["mavg"] / counts[key]
    return out


def check_window_sql(got, exp, atols: Dict[str, float], label: str) -> None:
    """A WINDOW_SQL result against sqlite's, row for row (both ordered by
    the table's key): the same row count; nulls in the same rows; dates
    (sqlite's 'YYYY-MM-DD' text parsed) and integers compared as int64,
    strings as objects, all exactly; floats within `atols[column]` in
    absolute terms where given (window sums and means; a number, or one
    a row), else exactly. Raises AssertionError."""
    import pandas as pd
    if len(got.columns) != len(exp.columns):
        raise AssertionError(f"{label}: columns {list(got.columns)} vs "
                             f"{list(exp.columns)}")
    if len(got) != len(exp):
        raise AssertionError(f"{label}: {len(got)} vs {len(exp)} rows")
    for gc, ec in zip(got.columns, exp.columns):
        g, e = got[gc].reset_index(drop=True), exp[ec].reset_index(drop=True)
        lab = f"{label} {gc}"
        gnull, enull = g.isna().to_numpy(), e.isna().to_numpy()
        if not np.array_equal(gnull, enull):
            raise AssertionError(f"{lab}: nulls differ in "
                                 f"{int((gnull != enull).sum())} rows")
        keep = ~gnull
        g, e = g[keep], e[keep]
        if g.dtype.kind == "M":
            gv = g.to_numpy("datetime64[ns]").view(np.int64)
            ev = pd.to_datetime(e, format="%Y-%m-%d").to_numpy(
                "datetime64[ns]").view(np.int64)
        elif g.dtype.kind == "f" or e.dtype.kind == "f":
            gv, ev = g.to_numpy(np.float64), e.to_numpy(np.float64)
            tol = np.asarray(atols.get(gc, 0.0), np.float64)
            tol = np.broadcast_to(tol[keep] if tol.ndim else tol, gv.shape)
            err = np.abs(gv - ev)
            if not (err <= tol).all():
                i = int(np.argmax(err - tol))
                raise AssertionError(f"{lab}: {gv[i]!r} vs {ev[i]!r} "
                                     f"(|diff| {err[i]!r} > {tol[i]!r})")
            continue
        elif g.dtype.kind in "iub":
            gv, ev = g.to_numpy(np.int64), e.to_numpy(np.int64)
        else:
            gv, ev = g.to_numpy(object), e.to_numpy(object)
        if not np.array_equal(gv, ev):
            i = int(np.argmax(gv != ev))
            raise AssertionError(f"{lab}: {gv[i]!r} vs {ev[i]!r}")


# ---------------------------------------------------------------------------
# the relational calls on lineitem: name -> (kind, partition_by,
# order_by, specs, ascending)
# ---------------------------------------------------------------------------

_LI_ORDER = ["l_shipdate", "l_orderkey", "l_linenumber"]
RANK_SPECS = {
    "rank partitioned (W1)": (
        ["l_orderkey"], ["l_extendedprice", "l_linenumber"],
        [("row_number", 0, "rn")], [False, True]),
    "rank global": (
        [], ["l_extendedprice", "l_orderkey", "l_linenumber"],
        [("rank", 0, "rk"), ("dense_rank", 0, "drk"),
         ("row_number", 0, "rn"), ("ntile", 100, "pct")], None),
}
AGG_SPECS = {
    "agg partitioned (W4)": (
        ["l_partkey"], _LI_ORDER,
        [("mean", "l_extendedprice", ("rows", -6, 0), 0, "mavg")], None),
    "agg partitioned (W5)": (
        ["l_suppkey"], _LI_ORDER,
        [("max", "l_extendedprice", ("rows", -3, 3), 0, "mx")], None),
    "agg partitioned (W5 all)": (
        ["l_orderkey"], [],
        [("min", "l_shipdate", ("all",), 0, "first_ship")], None),
    "agg OVER ()": (
        [], [],
        [("sum", "l_quantity", ("all",), 0, "total_qty"),
         ("mean", "l_extendedprice", ("all",), 0, "avg_price"),
         ("min", "l_shipdate", ("all",), 0, "first_day"),
         ("max", "l_extendedprice", ("all",), 0, "max_price"),
         ("count", "l_discount", ("all",), 0, "n")], None),
    "agg ordered, no partition": (
        [], ["l_orderkey", "l_linenumber"],
        [("sum", "l_quantity", ("rows", None, 0), 0, "running_qty"),
         ("lag", "l_shipmode", ("all",), 1, "prev_mode")], None),
}
# the float outputs of AGG_SPECS held to the REP result within
# prefix_atol of their source column (a 1D shard's prefixes and the
# reduce's partials add in another order): output -> source column
AGG_FLOAT_SOURCES = {"mavg": "l_extendedprice", "total_qty": "l_quantity",
                     "avg_price": "l_extendedprice",
                     "running_qty": "l_quantity"}
# the means among them, whose tolerance is over the frame's row count:
# output -> (partition column, order columns, rows preceding), or None
# for OVER () (every row whose value is not null)
MEAN_FRAMES = {"mavg": ("l_partkey", _LI_ORDER, 6), "avg_price": None}
# the routes each 1D call must take
RANK_ROUTES = {"rank partitioned (W1)": "rank_window_shuffle",
               "rank global": "rank_window_global"}
AGG_ROUTES = {"agg partitioned (W4)": "agg_window_shuffle",
              "agg partitioned (W5)": "agg_window_shuffle",
              "agg partitioned (W5 all)": "agg_window_shuffle",
              "agg OVER ()": "agg_window_broadcast",
              "agg ordered, no partition": "agg_window_gather"}


def run_call(R, t, name: str):
    """One RANK_SPECS or AGG_SPECS call on the table `t` through the
    relational module `R`."""
    if name in RANK_SPECS:
        pk, ob, specs, asc = RANK_SPECS[name]
        return R.rank_window(t, pk, ob, specs, ascending=asc)
    pk, ob, specs, asc = AGG_SPECS[name]
    return R.agg_window(t, pk, ob, specs, ascending=asc)


def agg_atols(cols, outs) -> Dict[str, object]:
    """{output: absolute tolerance} of the outputs `outs` that are in
    AGG_FLOAT_SOURCES, from lineitem's host columns `cols` in the table's
    row order: prefix_atol of the source, over the frame's row count for
    a mean (one a row for a moving frame)."""
    out = {}
    for o, src in AGG_FLOAT_SOURCES.items():
        if o not in outs:
            continue
        atol = prefix_atol(cols[src])
        if o in MEAN_FRAMES:
            frame = MEAN_FRAMES[o]
            if frame is None:
                atol /= max(int(np.count_nonzero(~np.isnan(
                    np.asarray(cols[src], np.float64)))), 1)
            else:
                part, order, preceding = frame
                atol = atol / frame_counts(cols[part],
                                           [cols[c] for c in order],
                                           preceding)
        out[o] = atol
    return out


def check_against_rep(got, want, atols: Dict[str, object],
                      label: str) -> None:
    """A 1D call's result (a dict of host arrays, shard order) against
    the REP call's: every column exactly (nulls in the same rows), but
    the window sums and means of `atols` within their absolute
    tolerance (a number, or one a row)."""
    import pandas as pd
    for name, w in want.items():
        g = got[name]
        lab = f"{label} {name}"
        if len(g) != len(w):
            raise AssertionError(f"{lab}: {len(g)} vs {len(w)} rows")
        gnull = pd.isna(pd.Series(g)).to_numpy()
        wnull = pd.isna(pd.Series(w)).to_numpy()
        if not np.array_equal(gnull, wnull):
            raise AssertionError(f"{lab}: nulls differ")
        gv, wv = np.asarray(g)[~gnull], np.asarray(w)[~wnull]
        if name in atols:
            tol = np.asarray(atols[name], np.float64)
            tol = tol[~wnull] if tol.ndim else tol
            err = np.abs(gv.astype(np.float64) - wv.astype(np.float64))
            if not (err <= tol).all():
                i = int(np.argmax(err - tol))
                raise AssertionError(f"{lab}: |diff| {err[i]!r} > "
                                     f"{np.broadcast_to(tol, err.shape)[i]!r}")
        elif not np.array_equal(gv, wv):
            raise AssertionError(f"{lab}: differs in "
                                 f"{int((gv != wv).sum())} rows")


# ---------------------------------------------------------------------------
# window_table on the taxi trips
# ---------------------------------------------------------------------------

# window_table specs over the trips in pickup order: (column, op, param,
# output)
TABLE_SPECS = (
    [("trip_miles", op, None, f"miles_{op}")
     for op in ("cumsum", "cummax", "cummin")]
    + [("near_one", "cumprod", None, "near_one_cumprod")]
    + [("trip_miles", f"rolling_{op}", w, f"miles_r{op}{w}")
       for w in (7, 1000) for op in ("sum", "mean", "min", "max", "count")]
    + [("trip_miles", "shift", 1, "miles_shift1"),
       ("trip_miles", "diff", 1, "miles_diff1")])


def near_one(trip_miles) -> np.ndarray:
    """The cumprod column: 1 + (miles - 5) * 2e-8, so a product over 20M
    rows stays near 1."""
    return 1.0 + (np.asarray(trip_miles, np.float64) - 5.0) * 2e-8


def accurate_cumsum(x: np.ndarray) -> np.ndarray:
    """The running sum of `x` accumulated in extended precision (numpy's
    longdouble, 64 mantissa bits or more) and rounded to float64 once:
    pandas' cumsum adds in float64 left to right, whose rounding errors
    grow with the row count (458 * 2^-52 * sum(|x|) at 4M gamma-
    distributed values on the CPU, against 1.4 for the port's prefix),
    so at 20M rows it is the oracle, not the port, that misses the
    prefix tolerance."""
    if np.finfo(np.longdouble).nmant < 63:
        raise RuntimeError("accurate_cumsum needs an extended longdouble")
    return np.cumsum(np.asarray(x, np.longdouble)).astype(np.float64)


def table_oracle(miles: np.ndarray, near: np.ndarray
                 ) -> Dict[str, np.ndarray]:
    """TABLE_SPECS by pandas on the columns in pickup order, the running
    sum accumulated in extended precision (`accurate_cumsum`)."""
    import pandas as pd
    s = pd.Series(miles)
    out = {"miles_cumsum": pd.Series(accurate_cumsum(miles)),
           "miles_cummax": s.cummax(),
           "miles_cummin": s.cummin(),
           "near_one_cumprod": pd.Series(near).cumprod(),
           "miles_shift1": s.shift(1), "miles_diff1": s.diff(1)}
    for w in (7, 1000):
        r = s.rolling(w)
        for op in ("sum", "mean", "min", "max", "count"):
            out[f"miles_r{op}{w}"] = getattr(r, op)()
    return {k: v.to_numpy(np.float64) for k, v in out.items()}


def table_tolerances(miles: np.ndarray, n: int) -> Dict[str, tuple]:
    """{output: (kind, value)} of TABLE_SPECS: the prefix sums and their
    differences ("abs", prefix_atol), the product ("rel", n * 2^-52),
    everything else exact."""
    atol = prefix_atol(miles)
    out = {}
    for _, op, _, name in TABLE_SPECS:
        if op in ("cumsum", "rolling_sum", "rolling_mean"):
            out[name] = ("abs", atol)
        elif op == "cumprod":
            out[name] = ("rel", n * 2.0 ** -52)
        else:
            out[name] = ("exact", 0.0)
    return out


def check_table(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                tols: Dict[str, tuple], label: str) -> None:
    """window_table's outputs against another run's (NaN in the same
    rows) within `tols`. Raises AssertionError."""
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        lab = f"{label} {name}"
        if len(g) != len(w) or not np.array_equal(np.isnan(g),
                                                  np.isnan(w)):
            raise AssertionError(f"{lab}: NaN rows or lengths differ")
        ok = ~np.isnan(w)
        kind, tol = tols[name]
        err = np.abs(g[ok] - w[ok])
        lim = tol * np.abs(w[ok]) if kind == "rel" else tol
        if not (err <= lim).all():
            raise AssertionError(f"{lab}: |diff| up to {err.max()!r} "
                                 f"({kind} tolerance {tol!r})")
