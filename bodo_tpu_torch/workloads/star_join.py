"""The star-schema hash-join workload on the port: data generator, the
pipeline and a numpy oracle.

The relational-layer counterpart of the JAX package's `--suite join`
benchmark (bench.py `bench_join`, its `run()`): a taxi-shaped
fact -> dimension pipeline in the TPC-H lineitem:orders shape, the
dimension a quarter of the fact table, its keys unique and sparse int64
(drawn from [0, 2^40), so the build side never fits the dense-LUT join
and the hash join runs):

    fact[y % 3 != 0]  ->  inner merge with dim on k  ->  u = v * w
    ->  groupby g (32 groups): sum(u), count(v)  ->  sort by g

`gen_star_arrays` makes the columns with numpy alone, by the benchmark's
recipe; `numpy_pipeline` computes the result with numpy alone,
independent of both packages.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from bodo_tpu_torch import relational as R
from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
from bodo_tpu_torch.plan.expr import ColRef, Lit
from bodo_tpu_torch.table.table import Table

N_GROUPS = 32
OUT = ["g", "s", "c"]


def gen_star_arrays(n_rows: int, seed: int = 0
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(fact, dim) columns: fact k, v, y of `n_rows` rows and dim k, g, w
    of max(2000, n_rows // 4) rows with unique sorted sparse keys."""
    nkeys = max(2_000, n_rows // 4)
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 40, nkeys * 2))[:nkeys]
    fact = {
        "k": rng.choice(keys, n_rows),
        "v": rng.normal(size=n_rows),
        "y": rng.integers(0, 1000, n_rows).astype(np.int64),
    }
    dim = {
        "k": keys,
        "g": (np.arange(len(keys)) % N_GROUPS).astype(np.int64),
        "w": rng.normal(size=len(keys)),
    }
    return fact, dim


def tables_from_arrays(fact: Dict[str, np.ndarray],
                       dim: Dict[str, np.ndarray], device=None
                       ) -> Tuple[Table, Table]:
    return (Table.from_numpy(fact, device=device),
            Table.from_numpy(dim, device=device))


def pipeline(fact, dim, device=None, shard: bool = False,
             n_shards: int = 4) -> Table:
    """The star query through the relational layer; `fact` and `dim` are
    Tables or dicts of numpy columns (put on `device`, CUDA by default).
    Returns the (g, s, c) table sorted by g.

    shard=True row-shards both tables over a mesh of `n_shards` shards on
    their device: the filtered fact table is not more than 4x the
    dimension, so the join is the shuffle join (both sides hashed to
    their key's shard), then the two-phase groupby and the sample sort;
    the result is a 1D table."""
    if isinstance(fact, dict):
        fact, dim = tables_from_arrays(fact, dim, device)
    if not shard:
        return _pipeline(fact, dim)
    with use_mesh(make_mesh(n_shards, fact.device)):
        return _pipeline(fact.shard(), dim.shard())


def _pipeline(fact: Table, dim: Table) -> Table:
    f = R.filter_table(fact, ColRef("y") % Lit(3) != Lit(0))
    j = R.join_tables(f, dim, ["k"], ["k"], "inner")
    j = R.assign_columns(j, {"u": ColRef("v") * ColRef("w")})
    out = R.groupby_agg(j, ["g"], [("u", "sum", "s"), ("v", "count", "c")])
    return R.sort_table(out, ["g"])


def numpy_pipeline(fact: Dict[str, np.ndarray],
                   dim: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The same query with numpy alone: the dim key of each kept fact row
    by binary search (of the fact keys in sorted order, which walks the
    dim keys once), sums and counts by bincount over g."""
    keep = fact["y"] % 3 != 0
    k, v = fact["k"][keep], fact["v"][keep]
    order = np.argsort(dim["k"], kind="stable")
    sk = dim["k"][order]
    ko = np.argsort(k, kind="stable")
    pos = np.empty(len(k), dtype=np.int64)
    pos[ko] = np.clip(np.searchsorted(sk, k[ko]), 0, len(sk) - 1)
    hit = sk[pos] == k
    row = order[pos[hit]]
    g, u, v = dim["g"][row], v[hit] * dim["w"][row], v[hit]
    counted = ~np.isnan(v)
    c = np.bincount(g[counted], minlength=N_GROUPS)
    s = np.bincount(g, weights=u, minlength=N_GROUPS)
    present = np.bincount(g, minlength=N_GROUPS) > 0
    return {"g": np.flatnonzero(present).astype(np.int64), "s": s[present],
            "c": c[present].astype(np.int64)}


def check_against(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                  rtol: float) -> None:
    """g and c exact, s within `rtol` (float64 sums in another order)."""
    assert list(got) == OUT, list(got)
    for name in ("g", "c"):
        np.testing.assert_array_equal(np.asarray(got[name], np.int64),
                                      want[name], err_msg=name)
    np.testing.assert_allclose(np.asarray(got["s"], np.float64), want["s"],
                               rtol=rtol, atol=0, err_msg="s")
