"""The aggregations on the taxi pipeline's joined table, and a pandas
oracle for them.

The table is the taxi pipeline's `m` (workloads/taxi.py `joined`: the
trips joined on the date with the weather, with the derived bool and
bucket columns), grouped by its six KEYS with the decomposable
aggregations of WIDE_AGGS over a float64, an int64 and a bool column,
or the holistic ones of HOLISTIC_AGGS (nunique of an int64 and a string
column, mode of an int64 and a float64 column, the median and two
quantiles of the float64 one), then sorted by the keys; `reduce` takes
the same aggregations over the whole table (the holistic ones with a
third quantile, HOLISTIC_REDUCE).

The oracle is pandas on the host, on the rows `taxi.numpy_joined` makes
with numpy alone (in the trips' row order, as the port's joins keep it):
a groupby on the keys' mixed-radix slot id (whose order is the keys'
order), `sort=True`; the holistic modes and grouped quantiles but the
median by numpy over one sort of (slot, value) (`holistic_oracle`).
pandas is imported when called.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from bodo_tpu_torch.workloads.taxi import KEYS, numpy_joined, slot_ids

MILES_OPS = ("min", "max", "first", "last", "sumnull", "var", "std", "var0",
             "std0", "skew", "kurt")
PU_OPS = ("min", "max", "prod")
WD_OPS = ("min", "max")
WIDE_AGGS = ([("trip_miles", op, f"miles_{op}") for op in MILES_OPS]
             + [("PULocationID", op, f"pu_{op}") for op in PU_OPS]
             + [("weekday", op, f"wd_{op}") for op in WD_OPS])
# the taxi pipeline's own spec
COUNT_MEAN_AGGS = [("hvfhs_license_num", "count", "trip_count"),
                   ("trip_miles", "mean", "avg_miles")]
HOLISTIC_AGGS = [("PULocationID", "nunique", "pu_nunique"),
                 ("hvfhs_license_num", "nunique", "license_nunique"),
                 ("PULocationID", "mode", "pu_mode"),
                 ("trip_miles", "mode", "miles_mode"),
                 ("trip_miles", "median", "miles_median"),
                 ("trip_miles", "quantile_0.1", "miles_q10"),
                 ("trip_miles", "quantile_0.9", "miles_q90")]
HOLISTIC_REDUCE = HOLISTIC_AGGS + [("trip_miles", "quantile_0.99",
                                    "miles_q99")]
# held exactly (the rest of the float results by RTOL or MOMENT_TOL)
EXACT_OPS = ("min", "max", "first", "last", "prod", "nunique", "mode")
MOMENT_OPS = ("skew", "kurt")


def groupby(m, aggs=WIDE_AGGS):
    """groupby_agg of `m` by KEYS with `aggs`, sorted by KEYS."""
    from bodo_tpu_torch import relational as R
    return R.sort_table(R.groupby_agg(m, KEYS, aggs), KEYS)


def reduce(m, aggs=WIDE_AGGS) -> Dict:
    """reduce_table of `m` with `aggs`."""
    from bodo_tpu_torch import relational as R
    return R.reduce_table(m, aggs)


def table_arrays(t) -> Dict[str, tuple]:
    """(data, valid or None) of each column's real rows as numpy (a 1D
    table's shards in shard order)."""
    g = t.gather() if t.distribution == "1D" else t
    n = g.nrows
    return {name: (c.data[:n].cpu().numpy(),
                   None if c.valid is None else c.valid[:n].cpu().numpy())
            for name, c in g.columns.items()}


def _pandas_op(s, op: str):
    """One aggregation of a pandas Series or SeriesGroupBy, pandas'
    semantics (ddof 1 for var/std, ddof 0 for var0/std0, SQL's sum)."""
    if op in ("var0", "std0"):
        return getattr(s, op[:3])(ddof=0)
    if op == "sumnull":
        return s.sum(min_count=1)
    return getattr(s, op)()


def _present_keys(present, los, sizes) -> Dict[str, np.ndarray]:
    """The six keys of the present slot ids, decoded from the mixed
    radix."""
    out: Dict[str, np.ndarray] = {}
    rem = present
    keys = []
    for size, lo in zip(reversed(sizes), reversed(los)):
        keys.append(rem % size + lo)
        rem = rem // size
    for name, k in zip(KEYS, keys[::-1]):
        out[name] = k
    return out


def pandas_oracle(trips: Dict[str, np.ndarray],
                  weather: Dict[str, np.ndarray]):
    """(groupby result as {name: array} sorted by the keys, reduce result
    as {name: scalar}) by pandas, from the generated arrays."""
    import pandas as pd
    cols, hit = numpy_joined(trips, weather)
    slot, los, sizes = slot_ids(cols)
    df = pd.DataFrame({"slot": slot, "trip_miles": trips["trip_miles"][hit],
                       "PULocationID": trips["PULocationID"][hit],
                       "weekday": cols[3].astype(bool)})
    g = df.groupby("slot", sort=True)
    out = _present_keys(g.size().index.to_numpy(), los, sizes)
    red = {}
    for col, op, name in WIDE_AGGS:
        out[name] = _pandas_op(g[col], op).to_numpy()
        s = df[col]
        if op in ("first", "last"):
            s = s.dropna()
            red[name] = s.iloc[0 if op == "first" else -1] if len(s) \
                else None
        else:
            red[name] = _pandas_op(s, op)
    return out, red


def _sorted_by_group(slot, v):
    """`v` in (slot, value) order by two stable argsorts: (the sorted
    values, their slots, each slot's first position and its count)."""
    o = np.argsort(v, kind="stable")
    o = o[np.argsort(slot[o], kind="stable")]
    s, x = slot[o], v[o]
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] != s[:-1]
    starts = np.flatnonzero(new)
    return x, s, starts, np.diff(np.append(starts, len(s)))


def _group_mode(x, s):
    """Each slot's most frequent value, the smallest on a tie, of values
    `x` sorted by (slot `s`, value): the first of the slot's longest
    runs of one value."""
    new = np.ones(len(s), dtype=bool)
    new[1:] = (s[1:] != s[:-1]) | (x[1:] != x[:-1])
    runs = np.flatnonzero(new)
    lens = np.diff(np.append(runs, len(s)))
    rs = s[runs]
    head = np.ones(len(rs), dtype=bool)
    head[1:] = rs[1:] != rs[:-1]
    heads = np.flatnonzero(head)
    best = np.maximum.reduceat(lens, heads)
    is_best = lens == np.repeat(best, np.diff(np.append(heads, len(rs))))
    idx = np.flatnonzero(is_best)
    first = np.ones(len(idx), dtype=bool)
    first[1:] = rs[idx[1:]] != rs[idx[:-1]]
    return x[runs[idx[first]]]


def _group_quantile(x, starts, counts, q: float):
    """Each slot's linearly interpolated quantile (numpy's and pandas'
    'linear' method) of values `x` sorted by (slot, value)."""
    pos = (counts - 1) * q
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    a, b = x[starts + lo], x[starts + hi]
    return a + (b - a) * (pos - lo)


def _q_of(op: str) -> float:
    return 0.5 if op == "median" else float(op[len("quantile_"):])


def holistic_oracle(trips: Dict[str, np.ndarray],
                    weather: Dict[str, np.ndarray]):
    """pandas_oracle's results for HOLISTIC_AGGS (by the keys) and
    HOLISTIC_REDUCE (over the whole table): nunique and the median by
    pandas; the mode and the other quantiles by numpy over one sort of
    (slot, value) a column (pandas' groupby quantile takes ~30 s a call
    at 20M rows). The license strings are counted by their characters'
    codes packed into an int64."""
    import pandas as pd
    cols, hit = numpy_joined(trips, weather)
    slot, los, sizes = slot_ids(cols)
    lic = trips["hvfhs_license_num"][hit]
    chars = lic.view(np.uint32).reshape(len(lic), -1).astype(np.int64)
    lic = (chars << (8 * np.arange(chars.shape[1]))).sum(1)
    df = pd.DataFrame({"slot": slot, "trip_miles": trips["trip_miles"][hit],
                       "PULocationID": trips["PULocationID"][hit],
                       "hvfhs_license_num": lic})
    g = df.groupby("slot", sort=True)
    out = _present_keys(g.size().index.to_numpy(), los, sizes)
    by_col = {c: _sorted_by_group(slot, df[c].to_numpy())
              for c in ("trip_miles", "PULocationID")}
    red = {}
    for col, op, name in HOLISTIC_REDUCE:
        if op == "nunique":
            out[name] = g[col].nunique().to_numpy()
            red[name] = df[col].nunique()
            continue
        x, s, starts, counts = by_col[col]
        if op == "mode":
            out[name] = _group_mode(x, s)
            red[name] = _group_mode(np.sort(x), np.zeros(len(x),
                                                         np.int64))[0]
            continue
        q = _q_of(op)
        out[name] = g[col].median().to_numpy() if op == "median" else \
            _group_quantile(x, starts, counts, q)
        red[name] = df[col].quantile(q)
    return {k: out[k] for k in KEYS + [n for _, _, n in HOLISTIC_AGGS]}, \
        red


def _close(got, want, op: str, rtol: float, moment_tol: float,
           label: str) -> None:
    got = np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "iub" or op in EXACT_OPS:
        # min/max of floats as values (-0.0 == 0.0)
        if not np.array_equal(got, want.astype(got.dtype)):
            bad = int(np.flatnonzero(got != want)[0]) if got.shape else 0
            raise AssertionError(f"{label} differs at row {bad}: "
                                 f"{got.flat[bad]!r} vs {want.flat[bad]!r}")
        return
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{label}: NaN where the oracle has none, or "
                             f"the other way round")
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok])
    if op in MOMENT_OPS:
        bad = err > moment_tol * (1 + np.abs(want[ok]))
    else:
        bad = err > rtol * np.abs(want[ok])
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"{label}: {got[ok][i]!r} vs {want[ok][i]!r}")


def check_groupby(arrays: Dict[str, tuple], want: Dict[str, np.ndarray],
                  rtol: float, moment_tol: float, label: str,
                  aggs=WIDE_AGGS) -> None:
    """The port's groupby result (`table_arrays`) with `aggs` against the
    oracle: the groups and keys equal; min, max, first, last, the integer
    product, nunique, mode and the bool results equal; every valid bit
    set (no group is empty); floats within `rtol`, skew and kurt within
    moment_tol * (1 + |x|), NaN where the oracle has NaN."""
    n = len(want[KEYS[0]])
    if len(arrays[KEYS[0]][0]) != n:
        raise AssertionError(f"{label}: {len(arrays[KEYS[0]][0])} groups, "
                             f"want {n}")
    for k in KEYS:  # time_bucket: codes into the sorted bucket names
        _close(arrays[k][0].astype(np.int64), want[k].astype(np.int64),
               "min", 0, 0, f"{label} {k}")
    for _, op, name in aggs:
        data, valid = arrays[name]
        if valid is not None and not valid.all():
            raise AssertionError(f"{label} {name}: a group without a value")
        _close(data, want[name], op, rtol, moment_tol, f"{label} {name}")


def check_reduce(got: Dict, want: Dict, rtol: float, moment_tol: float,
                 label: str, aggs=WIDE_AGGS) -> None:
    """reduce's scalars against the oracle's, by check_groupby's rules."""
    for _, op, name in aggs:
        _close(np.asarray([got[name]]), np.asarray([want[name]]), op, rtol,
               moment_tol, f"{label} {name}")
