"""The port's SQL expressions against bodo_tpu's on small frames (a
200-row table with nulls in its string column, and a 60-row table of
keys): each LIKE form (equality, prefix, suffix, infix, the regular
expression of `_` and an inner `%`, NOT LIKE), SUBSTRING in a projection
(the host DictMap of assign_columns) and under IN, string IN and NOT
IN, `date ± interval` in days, months and years, EXTRACT(year) as a
group key, CASE over numbers and strings, LIMIT (head_table), an
uncorrelated scalar subquery, IN and NOT IN subqueries (the semi and
anti joins) and correlated EXISTS and NOT EXISTS. Each result equals
the reference's (columns, dtypes, values; float64 within rtol 1e-12),
with the same routes. Then the port's own route for a filter over a
cross join whose every disjunct requires t.k = u.k (TPC-H Q19's shape):
with the port's PRODUCT_MAX_ROWS set below the product's rows, the port
joins on the key (the dense-LUT join) instead of the constant key (the
hash join); the result equals the reference's, which builds the
product.

The executor's relational routes held to the reference's on REP and
on 1D tables (CPU meshes of 4 shards, uneven per-shard counts):
window_table's rowid op (the row id Q21's EXISTS decorrelation tags
rows with) and head_table (LIMIT gathers a 1D table first).

The file sources: the port's ReadParquet (a parquet path registered on
the context) and ReadCsv (a plan node) give the same result as the
frame they were written from. The port's plan cache, with its
directory set, writes a file of its own and serves the query from it.

Then what the port refuses: a DDL statement raises NotImplementedError,
and a context with device=None raises on a machine without CUDA. One
test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test).
"""

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (assert_same_frame, assert_same_table,
                                fresh_observations, port_routes_reset,
                                reference_routes, reference_state,
                                sql_records_digest, to_port,
                                torch_one_thread)  # noqa: F401

SHARDS = 4

QUERIES = [
    "select k, s from t where s like 'ab%' order by k",
    "select k, s from t where s like '%yz' order by k",
    "select k, s from t where s like '%cd%' order by k",
    "select k, s from t where s like 'a_c%' order by k",
    "select k, s from t where s like 'x%z%q' order by k",
    "select k, s from t where s like 'abc' order by k",
    "select k, s from t where s not like '%cd%' order by k",
    "select k, substring(s from 2 for 3) as sub from t order by k",
    "select k, upper(s) as up from t where lower(s) like '%xc%' order by k",
    "select k, s from t where substring(s from 1 for 2) in ('ab', 'xy') "
    "order by k",
    "select k, s from t where s in ('abc', 'xyzq', 'none') order by k",
    "select k, s from t where s not in ('abc', 'xyzq') order by k",
    "select k, d from t where d >= date '2020-01-01' + interval '1' month "
    "and d < date '2021-03-01' - interval '10' day order by k",
    "select k, d from t where d < date '2019-06-30' + interval '1' year "
    "order by k",
    "select extract(year from d) as y, count(*) as n, sum(x) as sx from t "
    "group by extract(year from d) order by y",
    "select k, case when x > 0 then x else 0 end as c, "
    "case when s = 'abc' then 1 when s like 'x%' then 2 else 3 end as c2 "
    "from t order by k",
    "select k, x from t order by x desc limit 7",
    "select k, x from t where x > (select avg(x) from t) order by k",
    "select k from t where k in (select k from u where name like 'n1%') "
    "order by k",
    "select k from t where k not in (select k from u) order by k",
    "select k from t where exists (select * from u where u.k = t.k "
    "and u.name <> 'n3') order by k",
    "select k from t where not exists (select * from u where u.k = t.k) "
    "order by k",
]


def _frames():
    r = np.random.default_rng(7)
    n = 200
    vocab = np.array(["abc", "abd", "xyz", "xyzq", "aXcd", "cdab", "qcdz",
                      "xaz_q", "ab"])
    s = vocab[r.integers(0, len(vocab), n)].astype(object)
    s[r.random(n) < 0.1] = None
    t = pd.DataFrame({
        "k": np.arange(n, dtype=np.int64),
        "s": s,
        "d": pd.Series((np.datetime64("2019-01-01") + r.integers(
            0, 900, n).astype("timedelta64[D]")).astype("datetime64[ns]")),
        "x": np.round(r.normal(size=n), 3),
    })
    u = pd.DataFrame({
        "k": r.choice(np.arange(0, 300, dtype=np.int64), 60, replace=False),
        "name": [f"n{i % 7}" for i in range(60)],
    })
    return {"t": t, "u": u}


def test_sql_exprs_match_reference(torch_one_thread, tmp_path,
                                   monkeypatch):
    import torch

    import bodo_tpu.plan.explain  # noqa: F401  (the SQL path's modules,
    import bodo_tpu.plan.physical  # noqa: F401  imported before the
    import bodo_tpu.runtime.elastic  # noqa: F401  digest is taken)
    import bodo_tpu.runtime.stats_store  # noqa: F401
    import bodo_tpu.sql as ref_sql
    import bodo_tpu.sql.plan_cache  # noqa: F401
    from bodo_tpu_torch.sql import BodoSQLContext

    frames = _frames()
    port_ctx = BodoSQLContext(frames, device="cpu")
    before = sql_records_digest()
    with reference_state(), fresh_observations():
        ref_ctx = ref_sql.BodoSQLContext(frames)
        for i, sql in enumerate(QUERIES):
            with reference_routes() as ref_routes:
                want = ref_ctx.sql(sql).to_pandas()
            routes = port_routes_reset()
            got = port_ctx.sql(sql).to_pandas()
            assert routes == ref_routes, sql
            assert len(want) > 0, sql
            assert_same_frame(got, want, 1e-12, f"query {i}: {sql}")
        _check_filtered_product(ref_ctx, port_ctx, monkeypatch)
    assert sql_records_digest() == before

    with reference_state():
        _check_rowid_and_head(frames["t"])

    _check_file_sources(frames["t"], port_ctx, tmp_path)
    _check_plan_cache(frames, tmp_path, monkeypatch)

    for ddl in ("create table v as select k from t", "drop table t",
                "describe t", "show tables"):
        with pytest.raises(NotImplementedError, match="DDL"):
            port_ctx.sql(ddl)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BodoSQLContext(frames)


def _check_filtered_product(ref_ctx, port_ctx, monkeypatch):
    from bodo_tpu_torch.plan import physical
    sql = ("select count(*) as n, sum(x) as sx from t, u where "
           "(t.k = u.k and u.name = 'n1') or (u.k = t.k and t.x > 0.5)")
    want = ref_ctx.sql(sql).to_pandas()
    # the product has 200 * 60 rows: built under the default limit,
    # joined on t.k = u.k over a limit below it
    for limit, route in ((physical.PRODUCT_MAX_ROWS, "join_rep_hash"),
                         (200 * 60 - 1, "join_dense")):
        monkeypatch.setattr(physical, "PRODUCT_MAX_ROWS", limit)
        routes = port_routes_reset()
        got = port_ctx.sql(sql).to_pandas()
        assert {k: v for k, v in routes.items() if v} == {route: 1}, limit
        assert int(got["n"].iloc[0]) > 0
        assert_same_frame(got, want, 1e-12, sql)
    monkeypatch.undo()


def _check_plan_cache(frames, tmp_path, monkeypatch):
    """With its directory set, the port's plan cache writes the first
    parse of a query to a file of its own name, holding the port's AST
    classes, and serves the second from it with the same result. Its
    environment variable is not the JAX package's."""
    import bodo_tpu.sql.plan_cache as ref_pc
    from bodo_tpu_torch.config import Config, config
    from bodo_tpu_torch.sql import BodoSQLContext, plan_cache
    monkeypatch.delenv("BODO_TPU_TORCH_SQL_PLAN_CACHE_DIR", raising=False)
    monkeypatch.setenv("BODO_TPU_SQL_PLAN_CACHE_DIR", str(tmp_path))
    assert Config().sql_plan_cache_dir == ""
    monkeypatch.setenv("BODO_TPU_TORCH_SQL_PLAN_CACHE_DIR", str(tmp_path))
    assert Config().sql_plan_cache_dir == str(tmp_path)
    ctx = BodoSQLContext(frames, device="cpu")
    sql = QUERIES[9]
    want = ctx.sql(sql).to_pandas()
    d = tmp_path / "plans"
    monkeypatch.setattr(config, "sql_plan_cache_dir", str(d))
    plan_cache.reset_stats()
    first = ctx.sql(sql).to_pandas()
    files = sorted(p.name for p in d.iterdir())
    second = ctx.sql(sql).to_pandas()
    monkeypatch.undo()
    assert plan_cache.stats() == {"hits": 1, "misses": 1}
    assert len(files) == 1 and files[0].startswith("bodo_tpu_torch-")
    assert files[0] != ref_pc._key(sql, ctx._schema_sig()) + ".pkl"
    data = (d / files[0]).read_bytes()
    assert b"bodo_tpu_torch.sql.parser" in data
    assert b"bodo_tpu.sql" not in data
    assert_same_frame(first, want, 0.0, sql)
    assert_same_frame(second, want, 0.0, sql)


def _check_file_sources(df, port_ctx, tmp_path):
    from bodo_tpu_torch.plan import logical as L
    df[["k", "s", "x"]].to_parquet(tmp_path / "t.parquet")
    df[["k", "x"]].to_csv(tmp_path / "t.csv", index=False)
    port_ctx.add_table("tp", str(tmp_path / "t.parquet"))
    port_ctx.add_table("tc", L.ReadCsv(str(tmp_path / "t.csv"),
                                       device="cpu"))
    for sql in ("select k, s, x from {} where x > 0 order by k",
                "select k, x from {} where k < 50 order by x desc"):
        if "s," in sql:
            srcs = ("tp",)
        else:
            srcs = ("tp", "tc")
        want = port_ctx.sql(sql.format("t")).to_pandas()
        for src in srcs:
            assert_same_frame(port_ctx.sql(sql.format(src)).to_pandas(),
                              want, 0.0, f"{src}: {sql}")


def _check_rowid_and_head(df):
    import jax

    import bodo_tpu
    import bodo_tpu.relational as R
    from bodo_tpu.plan.expr import ColRef
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    with bodo_tpu.use_mesh(ref_mesh), \
            use_mesh(make_mesh(SHARDS, device="cpu")):
        rep = RefTable.from_pandas(df)
        oned = R.filter_table(rep.shard(), ColRef("x") > 0.2)
        assert len(set(oned.counts.tolist())) > 1
        for ref_t in (rep, oned):
            port_t = to_port(ref_t)
            spec = [("k", "rowid", None, "rid")]
            assert_same_table(PR.window_table(port_t, spec),
                              R.window_table(ref_t, spec))
            for n in (0, 5, 1000):
                assert_same_table(PR.head_table(port_t, n),
                                  R.head_table(ref_t, n))
