"""LISTAGG in the port against bodo_tpu on the same inputs: `listagg`,
`listagg:<sep>` and `listaggd[:<sep>]` (DISTINCT), each group's values
joined in the rows' order within the group, nulls skipped, finished on
the host after the native aggregations (`_groupby_agg_with_listagg`).

  1. groupby_agg on a REP table by one key and by an int and a string
     key: listagg alone (the `size` placeholder; the hashed route), then
     beside sum and mean (packed, then hashed), and beside nunique and
     mode (the sort route);
     string values with nulls, int64 values with nulls, a group whose
     values are all null (its string is null);
  2. the same on a 1D table of 4 shards (the two-phase groupby for the
     native part, the colocated groupby beside nunique; the result is
     gathered, REP);
  3. reduce_table with listagg, REP and 1D (the constant-key groupby);
  4. TPC-H's supplier (gen_tpch(n_orders=900)) through the SQL entry
     point: LISTAGG(s_name, '|') and LISTAGG(DISTINCT s_nationkey) by
     s_nationkey, against the reference's BodoSQLContext.

Every table equals the reference's: names, dtypes, capacity,
dictionaries, valid masks and strings exactly, float64 sums and means
within rtol 1e-12 (the same values summed in another order), and the
routes taken equal; the strings also equal pandas' own join of each
group's values. One test runs every check (see tests/torch_parity.py on
why each test_torch_* file holds one test).
"""

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_frame,  # noqa: F401
                                assert_same_table, fresh_observations,
                                port_routes_reset, reference,
                                reference_routes, to_port, torch_one_thread)

F64_RTOL = 1e-12
SHARDS = 4
LISTAGGS = [("s", "listagg", "s_all"), ("s", "listagg:|", "s_bar"),
            ("s", "listaggd", "s_set"), ("i", "listaggd:;", "i_set")]
NATIVE = [("f", "sum", "f_sum"), ("f", "mean", "f_mean")]
HOLISTIC = [("i", "nunique", "i_nunique"), ("s", "mode", "s_mode")]


def _frame(r, n: int):
    """Keys a (60 values 1,000,000,007 apart, and a 61st) and k
    (strings); values s (strings, 15% null), i (Int64, 15% null), f
    (float64). The 61st group has only nulls."""
    words = np.array(["ant", "bee", "cat", "dog", "eel", "fox"])
    a = np.append(r.integers(0, 60, n), [60, 60])
    s = words[r.integers(0, 6, n + 2)].astype(object)
    null = r.random(n + 2) < 0.15
    null[n:] = True
    s[null] = None
    i = pd.array(np.where(null, None, r.integers(0, 9, n + 2)),
                 dtype="Int64")
    # spread keys: no dense route
    return pd.DataFrame({"a": a.astype(np.int64) * 1_000_000_007,
                         "k": np.where(a % 3 == 0, "x", "y"),
                         "s": s, "i": i, "f": r.normal(size=n + 2)})


def _pandas_listagg(df, keys, col, sep, distinct):
    def cat(v):
        return sep.join(str(x) for x in (dict.fromkeys(v) if distinct
                                         else v))
    return df.dropna(subset=[col]).groupby(keys)[col].agg(cat)


def _check(ref_t, df, keys, aggs, label: str):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    port_t = to_port(ref_t)
    with reference_routes() as ref_routes:
        ref = R.groupby_agg(ref_t, keys, aggs)
    routes = port_routes_reset()
    port = PR.groupby_agg(port_t, keys, aggs)
    assert routes == ref_routes, (label, routes, ref_routes)
    assert_same_table(port, ref, F64_RTOL)
    got = port.to_pandas().set_index(keys)
    for c, op, o in aggs:
        if not op.startswith("listagg"):
            continue
        sep = op.split(":", 1)[1] if ":" in op else ","
        want = _pandas_listagg(df, keys, c, sep, op.startswith("listaggd"))
        g = got[o]
        assert g.isna().sum() == len(g) - len(want), (label, o)
        assert (g.loc[want.index] == want).all(), (label, o)
    return {k: v for k, v in routes.items() if v}


def _check_reduce(ref_t, label: str):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    aggs = [("s", "listagg:|", "s_bar"), ("i", "listaggd", "i_set"),
            ("f", "sum", "f_sum")]
    want = R.reduce_table(ref_t, aggs)
    got = PR.reduce_table(to_port(ref_t), aggs)
    assert list(got) == list(want), label
    assert got["s_bar"] == want["s_bar"] and \
        got["i_set"] == want["i_set"], label
    assert abs(got["f_sum"] - want["f_sum"]) <= \
        F64_RTOL * abs(want["f_sum"]), label
    return got


def _check_sql():
    import bodo_tpu.sql as ref_sql
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.workloads.tpch import gen_tpch
    data = {"supplier": gen_tpch(n_orders=900, seed=3)["supplier"]}
    sql = ("SELECT s_nationkey, LISTAGG(s_name, '|') AS names, "
           "LISTAGG(DISTINCT s_nationkey) AS nk FROM supplier "
           "GROUP BY s_nationkey")
    with fresh_observations():
        want = ref_sql.BodoSQLContext(data).sql(sql).to_pandas()
        got = BodoSQLContext(data, device="cpu").sql(sql).to_pandas()
    assert len(got) > 1
    assert_same_frame(got, want, 0.0, "sql supplier")
    sup = data["supplier"]
    exp = sup.groupby("s_nationkey")["s_name"].agg("|".join)
    names = got.set_index("s_nationkey")["names"].sort_index()
    assert names.tolist() == exp.sort_index().tolist()
    assert (got["nk"] == got["s_nationkey"].astype(str)).all()


def test_listagg_matches_reference(reference):
    import bodo_tpu
    import jax
    import bodo_tpu.plan.explain  # noqa: F401  (the SQL path's modules,
    import bodo_tpu.plan.physical  # noqa: F401  imported before the
    import bodo_tpu.runtime.elastic  # noqa: F401  scope's records)
    import bodo_tpu.runtime.stats_store  # noqa: F401
    import bodo_tpu.sql.plan_cache  # noqa: F401
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    r = np.random.default_rng(0)
    df = _frame(r, 3000)
    rep = RefTable.from_pandas(df)
    # 1. REP
    hashed = {"groupby_hashed": 1}
    packed = {"groupby_packed": 1, "groupby_hashed": 1}
    assert _check(rep, df, ["a"], LISTAGGS, "REP alone") == hashed
    assert _check(rep, df, ["a", "k"], LISTAGGS + NATIVE,
                  "REP native") == packed
    assert _check(rep, df, ["a"], LISTAGGS[:2] + HOLISTIC,
                  "REP holistic") == {"groupby_sort": 1}
    # 2. 1D
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    with bodo_tpu.use_mesh(ref_mesh), \
            use_mesh(make_mesh(SHARDS, device="cpu")):
        t1 = RefTable.from_pandas(df).shard()
        two_phase = {"groupby_sharded_hash": 1}
        assert _check(t1, df, ["a"], LISTAGGS, "1D alone") == two_phase
        assert _check(t1, df, ["a", "k"], LISTAGGS[1:] + NATIVE,
                      "1D native") == {"groupby_packed": 1, **two_phase}
        assert _check(t1, df, ["a"], LISTAGGS[:1] + HOLISTIC,
                      "1D holistic") == {"groupby_colocated": 1}
        # 3. reduce_table 1D
        _check_reduce(t1, "reduce 1D")
    got = _check_reduce(rep, "reduce REP")
    assert got["s_bar"] == "|".join(df["s"].dropna())
    # 4. SQL
    _check_sql()
