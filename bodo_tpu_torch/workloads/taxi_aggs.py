"""The decomposable aggregations on the taxi pipeline's joined table, and
a pandas oracle for them.

The table is the taxi pipeline's `m` (workloads/taxi.py `joined`: the
trips joined on the date with the weather, with the derived bool and
bucket columns), grouped by its six KEYS with the aggregations of
WIDE_AGGS over a float64, an int64 and a bool column, then sorted by the
keys; `reduce` takes the same aggregations over the whole table.

The oracle is pandas on the host, on the rows `taxi.numpy_joined` makes
with numpy alone (in the trips' row order, as the port's joins keep it):
a groupby on the keys' mixed-radix slot id (whose order is the keys'
order), `sort=True`. pandas is imported when called.
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
# held exactly (the rest of the float results by RTOL or MOMENT_TOL)
EXACT_OPS = ("min", "max", "first", "last", "prod")
MOMENT_OPS = ("skew", "kurt")


def groupby(m, aggs=WIDE_AGGS):
    """groupby_agg of `m` by KEYS with `aggs`, sorted by KEYS."""
    from bodo_tpu_torch import relational as R
    return R.sort_table(R.groupby_agg(m, KEYS, aggs), KEYS)


def reduce(m) -> Dict:
    """reduce_table of `m` with WIDE_AGGS."""
    from bodo_tpu_torch import relational as R
    return R.reduce_table(m, WIDE_AGGS)


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
    present = g.size().index.to_numpy()
    out: Dict[str, np.ndarray] = {}
    rem = present
    keys = []
    for size, lo in zip(reversed(sizes), reversed(los)):
        keys.append(rem % size + lo)
        rem = rem // size
    for name, k in zip(KEYS, keys[::-1]):
        out[name] = k
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
                  rtol: float, moment_tol: float, label: str) -> None:
    """The port's groupby result (`table_arrays`) against the oracle: the
    groups and keys equal; min, max, first, last, the integer product and
    the bool results equal; every valid bit set (no group is empty);
    floats within `rtol`, skew and kurt within moment_tol * (1 + |x|),
    NaN where the oracle has NaN."""
    n = len(want[KEYS[0]])
    if len(arrays[KEYS[0]][0]) != n:
        raise AssertionError(f"{label}: {len(arrays[KEYS[0]][0])} groups, "
                             f"want {n}")
    for k in KEYS:  # time_bucket: codes into the sorted bucket names
        _close(arrays[k][0].astype(np.int64), want[k].astype(np.int64),
               "min", 0, 0, f"{label} {k}")
    for _, op, name in WIDE_AGGS:
        data, valid = arrays[name]
        if valid is not None and not valid.all():
            raise AssertionError(f"{label} {name}: a group without a value")
        _close(data, want[name], op, rtol, moment_tol, f"{label} {name}")


def check_reduce(got: Dict, want: Dict, rtol: float, moment_tol: float,
                 label: str) -> None:
    """reduce's scalars against the oracle's, by check_groupby's rules."""
    for _, op, name in WIDE_AGGS:
        _close(np.asarray([got[name]]), np.asarray([want[name]]), op, rtol,
               moment_tol, f"{label} {name}")
