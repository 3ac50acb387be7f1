"""rank_window of the port against bodo_tpu on the same inputs:
row_number, rank, dense_rank, ntile and cumcount

  1. on a replicated table (one sorted pass): partitioned by an int64
     key with nulls, by a dictionary string with nulls and an int64 key,
     ordered by a float64 with ties, NaN and +-inf, descending and
     ascending, nulls last and first; with no ORDER BY; with no
     PARTITION BY; the ranks and cumcount against pandas' groupby;
  2. on a 1D table of 4 shards with partition keys (rowid, the hash
     shuffle through partition_rank, the sorted pass a shard, the sample
     sort on the position through range_partition);
  3. on a 1D table of 4 shards without partition keys (the global
     ranking: the sample sort on the order keys, the typed cross-shard
     tie detection, the exscans of the run heads and dense counts, the
     sample sort back), ordered by the float64 with ties, by the string
     with nulls (nulls tie with nulls), by two keys, and with no ORDER
     BY; and on a table with an empty middle shard.

Every output is an integer: bit-identical to the reference, with the
same layout (per-shard counts, capacity, row order), and the routes each
package takes counted equal (torch_parity.reference_routes). One test
runs every check (see tests/torch_parity.py on why each test_torch_*
file holds one test).
"""

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_table,  # noqa: F401
                                port_routes_reset, reference,
                                reference_routes, to_port,
                                torch_one_thread)

SHARDS = 4
SPECS = [("row_number", 0, "rn"), ("rank", 0, "rk"),
         ("dense_rank", 0, "dr"), ("ntile", 3, "nt3"),
         ("ntile", 7, "nt7"), ("cumcount", 0, "cc")]


def _frame(n: int, seed: int):
    r = np.random.default_rng(seed)
    g = r.integers(0, 12, n)
    gnull = r.random(n) < 0.08
    v = r.integers(0, 25, n).astype(np.float64)   # many ties
    v[r.random(n) < 0.05] = np.nan
    v[r.random(n) < 0.02] = np.inf
    v[r.random(n) < 0.02] = -np.inf
    s = r.choice(["ash", "birch", "cedar", "elm"], n).astype(object)
    s[r.random(n) < 0.1] = None
    return pd.DataFrame({
        "k": np.arange(n, dtype=np.int64),
        "g": pd.array(np.where(gnull, None, g), dtype="Int64"),
        "s": s, "v": v,
        "o": r.permutation(n).astype(np.int64),
        "u": r.random(n),
    })


def _check(ref_t, label: str, want_routes, *args, **kw):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    with reference_routes() as ref_routes:
        ref = R.rank_window(ref_t, *args, SPECS, **kw)
    routes = port_routes_reset()
    port = PR.rank_window(to_port(ref_t), *args, SPECS, **kw)
    assert routes == ref_routes, (label, routes, ref_routes)
    taken = {k: v for k, v in routes.items() if v}
    for route in want_routes:
        assert taken.get(route, 0) >= 1, (label, route, taken)
    assert_same_table(port, ref)
    return port


CASES = [
    # (label, partition_by, order_by, keyword arguments)
    ("by g, v desc, o", ["g"], ["v", "o"], {"ascending": [False, True]}),
    ("by s g, v nulls first", ["s", "g"], ["v"], {"na_last": False}),
    ("by g, no order", ["g"], [], {}),
    ("by s, o", ["s"], ["o"], {}),
]
GLOBAL_CASES = [
    ("global v", [], ["v"], {}),
    ("global v desc nulls first", [], ["v"],
     {"ascending": False, "na_last": False}),
    ("global s", [], ["s"], {}),
    ("global s v", [], ["s", "v"], {"ascending": [True, False]}),
    ("global no order", [], [], {}),
]


def test_rank_windows_match_reference(reference):
    import bodo_tpu
    import bodo_tpu.relational as R
    import jax
    from bodo_tpu.plan.expr import ColRef as c
    from bodo_tpu.plan.expr import Lit
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    df = _frame(1000, 0)
    # (on a replicated table both packages' sorted pass needs a key)
    for label, pk, ob, kw in CASES + GLOBAL_CASES[:-1]:
        _check(RefTable.from_pandas(df), f"REP {label}",
               ["rank_window_local"], pk, ob, **kw)
    # the partitioned ranks against pandas' groupby rank
    port = _check(RefTable.from_pandas(df), "REP pandas",
                  ["rank_window_local"], ["g"], ["o"]).to_pandas()
    g = df.groupby("g", dropna=False)["o"]
    np.testing.assert_array_equal(
        port["rk"], g.rank(method="min").astype(np.int64))
    np.testing.assert_array_equal(
        port["cc"], df.sort_values("o").groupby("g", dropna=False)
        .cumcount().sort_index())

    launches = {"partition_rank": 0, "range_partition": 0}
    origs = {k: getattr(CK, k) for k in launches}

    def counted(name):
        def fn(*a, **k):
            launches[name] += 1
            return origs[name](*a, **k)
        return fn

    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    try:
        for name in launches:
            setattr(CK, name, counted(name))
        with bodo_tpu.use_mesh(ref_mesh), \
                use_mesh(make_mesh(SHARDS, device="cpu")):
            t1 = RefTable.from_pandas(df).shard()
            assert list(t1.counts) == [256, 256, 256, 232]
            for label, pk, ob, kw in CASES:
                _check(t1, f"1D {label}", ["rank_window_shuffle"], pk, ob,
                       **kw)
            assert launches["partition_rank"] >= SHARDS, launches
            assert launches["range_partition"] >= 1, launches
            for label, pk, ob, kw in GLOBAL_CASES:
                _check(t1, f"1D {label}", ["rank_window_global"], pk, ob,
                       **kw)
            tf = R.filter_table(t1, (c("k") < Lit(256)) |
                                (c("k") >= Lit(512)))
            assert tf.counts[1] == 0, tf.counts
            for label, pk, ob, kw in (CASES[0], GLOBAL_CASES[0],
                                      GLOBAL_CASES[2]):
                _check(tf, f"1D empty shard {label}",
                       [], pk, ob, **kw)
    finally:
        for name, fn in origs.items():
            setattr(CK, name, fn)
