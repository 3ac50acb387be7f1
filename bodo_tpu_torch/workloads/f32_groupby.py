"""The float32 groupby workload on the port: data generator, the two
pipelines and numpy oracles.

Two aggregates over float32 measures, the shape of sensor readings and
ML feature columns stored as float32:

  - dense: the JAX package's dense-accumulate probe, bench.py:1152-1213
    (`_fusion_pallas_probe`): keys k int64 in [0, 64), values x float32
    normal, y int64 in [0, 1000);

        t[y % 3 != 0]  ->  z = x + x (stays float32)
        ->  groupby k: sum(z), count(y)

    through the dense groupby (64 slots);
  - sparse: the hashed groupby of tests/test_hashtable.py:190-214
    (`test_hashed_groupby_mxu_route_interpret`): k drawn from 300
    distinct int64 keys in [-10^18, 10^18), v float32 normal;

        groupby k: sum(v), mean(v), count(v), size(v)

    through the hashed groupby (300 groups, a group space of 384).

Both take the f32 accumulate (`cuda_kernels.dense_accumulate`, the
groupby_sum kernel) while the table's capacity is at most 2^24 rows, the
gate of both callers (counts ride in f32). The sources run 5,000 and
100,000 rows; the configuration scales only the row count, to 2^24.

`gen_f32_arrays` makes the columns with numpy alone; `numpy_dense` and
`numpy_sparse` compute the results with numpy in float64, independent of
both packages, with each group's sum of |value| for the tolerance of
`check_against`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from bodo_tpu_torch import relational as R
from bodo_tpu_torch.plan.expr import ColRef, Lit
from bodo_tpu_torch.table.table import Table

N_DENSE_KEYS = 64
N_SPARSE_KEYS = 300
DENSE_AGGS = [("z", "sum", "z"), ("y", "count", "y")]
SPARSE_AGGS = [("v", "sum", "s"), ("v", "mean", "m"), ("v", "count", "c"),
               ("v", "size", "n")]
# |s - s64| <= SUM_TOL * sum(|x|) over a group's values: f32 sums in
# another order (atomics on the card) against the float64 sum
SUM_TOL = 1e-5

Arrays = Dict[str, np.ndarray]


def gen_f32_arrays(n_rows: int, seed: int = 0) -> Tuple[Arrays, Arrays]:
    """(dense, sparse) columns of `n_rows` rows each: dense k, x, y as
    the bench probe makes them, sparse k, v as the hashed test does."""
    rng = np.random.default_rng(seed)
    dense = {
        "k": rng.integers(0, N_DENSE_KEYS, n_rows).astype(np.int64),
        "x": rng.normal(size=n_rows).astype(np.float32),
        "y": rng.integers(0, 1000, n_rows).astype(np.int64),
    }
    keys = rng.integers(-10**18, 10**18, N_SPARSE_KEYS)
    sparse = {
        "k": keys[rng.integers(0, N_SPARSE_KEYS, n_rows)],
        "v": rng.normal(size=n_rows).astype(np.float32),
    }
    return dense, sparse


def _table(t, device) -> Table:
    return Table.from_numpy(t, device=device) if isinstance(t, dict) else t


def pipeline_dense(t, device=None) -> Table:
    """The dense query; `t` is a Table or a dict of numpy columns (put on
    `device`, CUDA by default). Returns (k, z, y) by k ascending."""
    t = _table(t, device)
    f = R.filter_table(t, ColRef("y") % Lit(3) != Lit(0))
    f = R.assign_columns(f, {"z": ColRef("x") + ColRef("x")})
    return R.groupby_agg(f, ["k"], DENSE_AGGS)


def pipeline_sparse(t, device=None) -> Table:
    """The sparse query; returns (k, s, m, c, n) by k ascending."""
    return R.groupby_agg(_table(t, device), ["k"], SPARSE_AGGS)


def _group_sums(key: np.ndarray, vals: np.ndarray):
    """(sorted distinct keys, float64 sums, counts, sums of |vals|)."""
    uk, inv = np.unique(key, return_inverse=True)
    v = vals.astype(np.float64)
    n = len(uk)
    return (uk, np.bincount(inv, weights=v, minlength=n),
            np.bincount(inv, minlength=n),
            np.bincount(inv, weights=np.abs(v), minlength=n))


def numpy_dense(d: Arrays) -> Arrays:
    """The dense query with numpy in float64: keys, sums and counts, and
    `abs_z`, each group's sum of |z|."""
    keep = d["y"] % 3 != 0
    z = d["x"][keep] + d["x"][keep]  # float32, exact
    k, s, cnt, a = _group_sums(d["k"][keep], z)
    return {"k": k, "z": s, "y": cnt.astype(np.int64), "abs_z": a}


def numpy_sparse(d: Arrays) -> Arrays:
    """The sparse query with numpy in float64, and `abs_v`, each group's
    sum of |v| (v has no NaN, so count == size)."""
    k, s, cnt, a = _group_sums(d["k"], d["v"])
    cnt = cnt.astype(np.int64)
    return {"k": k, "s": s, "m": s / cnt, "c": cnt, "n": cnt, "abs_v": a}


# float result -> (its oracle column of sums of |x|, the count it is a
# mean over, or None for a sum)
_FLOAT_OUT = {"z": ("abs_z", None), "s": ("abs_v", None),
              "m": ("abs_v", "c")}


def check_against(got: Arrays, want: Arrays) -> float:
    """Keys and counts exact; each sum within SUM_TOL * sum(|x|) of the
    float64 sum of its group, each mean within that bound over its count.
    Returns the largest |error| / bound seen."""
    assert set(got) == set(want) - {"abs_z", "abs_v"}, list(got)
    worst = 0.0
    for name in got:
        if name not in _FLOAT_OUT:
            np.testing.assert_array_equal(np.asarray(got[name], np.int64),
                                          want[name], err_msg=name)
            continue
        abs_name, per = _FLOAT_OUT[name]
        bound = SUM_TOL * want[abs_name]
        if per is not None:
            bound = bound / want[per]
        err = np.abs(np.asarray(got[name], np.float64) - want[name])
        if not np.all(err <= bound):
            raise AssertionError(f"{name}: {int(np.sum(err > bound))} "
                                 f"groups past {SUM_TOL} * sum(|x|)")
        worst = max(worst, float(np.max(err / np.maximum(bound, 1e-300))))
    return worst
