"""The rest of the 1D join family on the star and taxi data: four queries
and their numpy oracles.

  - `star_filtered_dim`: the star query (workloads/star_join.py) against
    the half of the dimension with g < 16, both row-sharded: a build
    side over `bcast_join_threshold` rows whose bytes fit the memory
    governor's broadcast share, so the governor promotes it to the
    broadcast join where the rows rule would shuffle it;
  - `skewed_fact`: the star's fact table with HOT_SHARE of its k values
    set to one dimension key (a hot foreign key: one customer, product
    or date owning a large part of a fact table), for the skew-split
    join; the query and its oracle are the star's own;
  - `union_pipeline`: the taxi trips split by pickup quarter into two
    row-sharded tables, each with its own string dictionaries and value
    bounds (`quarter_tables`),
    appended by `concat_tables` (UNION ALL), then the taxi pipeline's
    join, groupby and sort on the union (one file a quarter, read and
    unioned); its oracle is `taxi.numpy_pipeline` on the whole table;
  - `cross_pipeline`: the star dimension, row-sharded, x a replicated
    table of N_SCENARIOS scenario multipliers m (the cross join), then
    u = w * m and sum(u) by (g, scenario), sorted.

Data comes from the star and taxi generators with SEED; the oracles use
numpy alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bodo_tpu_torch import relational as R
from bodo_tpu_torch.plan.expr import ColRef, Lit
from bodo_tpu_torch.table.table import Column, Table
from bodo_tpu_torch.workloads import star_join as S
from bodo_tpu_torch.workloads import taxi as T

SEED = 0
HOT_SHARE = 0.4            # above config.aqe_skew_frac = 0.3
DIM_GROUPS_KEPT = 16       # star_filtered_dim keeps g < 16 of 32
N_SCENARIOS = 4
SCENARIO_M = np.array([0.9, 1.0, 1.1, 1.25])
QUARTER_SPLIT = np.datetime64("2024-04-01", "ns")  # Q1 | Q2 pickups
CROSS_OUT = ["g", "scenario", "s"]


# -- the star with a filtered dimension -------------------------------------

def star_filtered_dim(fact: Table, dim: Table) -> Table:
    """The star query against the dimension rows with g < 16; `fact` and
    `dim` are tables (1D under the active mesh for the 1D query)."""
    f = R.filter_table(fact, ColRef("y") % Lit(3) != Lit(0))
    d = R.filter_table(dim, ColRef("g") < Lit(DIM_GROUPS_KEPT))
    j = R.join_tables(f, d, ["k"], ["k"], "inner")
    j = R.assign_columns(j, {"u": ColRef("v") * ColRef("w")})
    out = R.groupby_agg(j, ["g"], [("u", "sum", "s"), ("v", "count", "c")])
    return R.sort_table(out, ["g"])


def numpy_star_filtered_dim(fact: Dict[str, np.ndarray],
                            dim: Dict[str, np.ndarray]
                            ) -> Dict[str, np.ndarray]:
    keep = dim["g"] < DIM_GROUPS_KEPT
    return S.numpy_pipeline(fact, {k: v[keep] for k, v in dim.items()})


# -- the skewed star ----------------------------------------------------------

def hot_key(dim: Dict[str, np.ndarray]) -> int:
    """The dimension key the skewed fact table repeats."""
    return int(dim["k"][len(dim["k"]) // 2])


def skewed_fact(fact: Dict[str, np.ndarray], dim: Dict[str, np.ndarray],
                seed: int = SEED) -> Dict[str, np.ndarray]:
    """The fact columns with HOT_SHARE of the rows' k set to `hot_key`;
    the other rows keep the generator's draw."""
    hot = np.random.default_rng(seed + 1).random(len(fact["k"])) < HOT_SHARE
    return {**fact, "k": np.where(hot, hot_key(dim), fact["k"])}


# -- the union ----------------------------------------------------------------

def quarter_tables(trips: Table) -> Tuple[Table, Table]:
    """The trips of each pickup quarter (Q1 before QUARTER_SPLIT, Q2
    from it) as their own table, as two files read apart give them: the
    string columns re-encoded onto a dictionary of their own values, the
    integer and timestamp columns with their own exact bounds."""
    split = int(QUARTER_SPLIT.astype(np.int64))
    out = []
    for pred in (ColRef("pickup_datetime") < Lit(split),
                 ColRef("pickup_datetime") >= Lit(split)):
        t = R.filter_table(trips, pred)
        cols = dict(t.columns)
        for name, c in t.columns.items():
            if c.dictionary is not None:
                present = torch.unique(c.data[:t.nrows])
                cols[name] = Column(
                    torch.searchsorted(present, c.data).to(torch.int32),
                    c.valid, c.dtype,
                    c.dictionary[present.cpu().numpy()])
        t = t.with_columns(cols)
        bounds = R._min_max(t, [n for n, c in cols.items()
                                if c.dtype.kind in ("i", "u", "dt")])
        for name, b in bounds.items():
            if b is not None:
                t.columns[name].vrange = (b[0], b[1], True)
        out.append(t)
    return tuple(out)


def union_pipeline(quarters, weather: Table) -> Table:
    """concat_tables of the quarters (replicated), then the taxi
    pipeline on the union."""
    return T._pipeline(R.concat_tables(list(quarters)), weather)


# -- the cross join -----------------------------------------------------------

def scenario_table(device=None) -> Table:
    return Table.from_numpy({"scenario": np.arange(N_SCENARIOS,
                                                   dtype=np.int64),
                             "m": SCENARIO_M}, device=device)


def cross_product(dim: Table, scenarios: Table) -> Table:
    return R.join_tables(dim, scenarios, [], [], "cross")


def cross_pipeline(product: Table) -> Table:
    """u = w * m, then sum(u) by (g, scenario), sorted by them."""
    j = R.assign_columns(product, {"u": ColRef("w") * ColRef("m")})
    out = R.groupby_agg(j, ["g", "scenario"], [("u", "sum", "s")])
    return R.sort_table(out, ["g", "scenario"])


def numpy_cross_rows(dim: Dict[str, np.ndarray], rows: np.ndarray
                     ) -> Dict[str, np.ndarray]:
    """Rows `rows` of the product in pandas' order (probe-major: row j
    is dimension row j // N_SCENARIOS with scenario j % N_SCENARIOS)."""
    d, sc = rows // N_SCENARIOS, rows % N_SCENARIOS
    return {"k": dim["k"][d], "g": dim["g"][d], "w": dim["w"][d],
            "scenario": sc.astype(np.int64), "m": SCENARIO_M[sc]}


def numpy_cross_pipeline(dim: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    n = len(dim["k"])
    g = np.repeat(dim["g"], N_SCENARIOS)
    sc = np.tile(np.arange(N_SCENARIOS), n)
    u = np.repeat(dim["w"], N_SCENARIOS) * SCENARIO_M[sc]
    slot = g * N_SCENARIOS + sc
    s = np.bincount(slot, weights=u, minlength=S.N_GROUPS * N_SCENARIOS)
    present = np.bincount(slot, minlength=len(s)) > 0
    ids = np.flatnonzero(present)
    return {"g": ids // N_SCENARIOS, "scenario": ids % N_SCENARIOS,
            "s": s[present]}


def check_cross(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                rtol: float) -> None:
    """g and scenario exact, s within `rtol`."""
    assert list(got) == CROSS_OUT, list(got)
    for name in ("g", "scenario"):
        np.testing.assert_array_equal(np.asarray(got[name], np.int64),
                                      want[name], err_msg=name)
    np.testing.assert_allclose(np.asarray(got["s"], np.float64), want["s"],
                               rtol=rtol, atol=0, err_msg="s")
