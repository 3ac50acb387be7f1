"""The port's SQL front end and plan layer against bodo_tpu's: for each of
the 22 TPC-H query texts, parse (sql/parser.py), plan (sql/planner.py)
and optimize (plan/optimizer.py: filter pushdown, join reordering by
plan/stats.py estimates, column pruning) give a plan with the same
key() as the reference's, on the frames of gen_tpch(n_orders=900,
seed=3) registered on both contexts.

Two parts of a key are process-local and are compared in canonical
form: an in-memory source's key carries a counter id (FromPandas), so
ids are renumbered by first appearance and each source's pruned column
list and row count are compared beside; and the literal an uncorrelated
scalar subquery folds into (Q11, Q15, Q22, which both planners execute
while planning) is a float64 sum or mean, compared within rtol 1e-12.
Both contexts start with no stage observations, and the reference's SQL
records are unchanged after its scope. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test).
"""

import numpy as np

from tests.torch_parity import (fresh_observations, reference_state,
                                sql_records_digest,
                                torch_one_thread)  # noqa: F401


def _canonical(key, ids):
    """A plan key with FromPandas ids renumbered by first appearance."""
    if isinstance(key, tuple):
        if len(key) == 2 and key[0] == "from_pandas" and \
                isinstance(key[1], int):
            return ("from_pandas", ids.setdefault(key[1], len(ids)))
        return tuple(_canonical(k, ids) for k in key)
    return key


def _same(a, b, path="") -> None:
    """Structural equality; float literals within rtol 1e-12."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, (float, np.floating)) and \
            isinstance(b, (float, np.floating)):
        assert type(a) is type(b), path
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} vs {b!r}"


def _sources(node, out):
    """(canonical id, column names, rows) of every in-memory source."""
    if type(node).__name__ == "FromPandas":
        out.append((node._id, list(node.schema), node.table.nrows))
    for c in node.children:
        _sources(c, out)
    return out


def test_sql_plans_match_reference(torch_one_thread):
    import bodo_tpu.plan.explain  # noqa: F401  (the SQL path's modules,
    import bodo_tpu.plan.physical  # noqa: F401  imported before the
    import bodo_tpu.runtime.elastic  # noqa: F401  digest is taken)
    import bodo_tpu.runtime.stats_store  # noqa: F401
    import bodo_tpu.sql as ref_sql
    import bodo_tpu.sql.plan_cache  # noqa: F401
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.workloads.tpch import QUERIES, gen_tpch

    data = gen_tpch(n_orders=900, seed=3)
    port_ctx = BodoSQLContext(data, device="cpu")
    before = sql_records_digest()
    with reference_state(), fresh_observations():
        ref_ctx = ref_sql.BodoSQLContext(data)
        for q in sorted(QUERIES):
            want = ref_ctx.generate_plan(QUERIES[q])
            got = port_ctx.generate_plan(QUERIES[q])
            ref_ids, port_ids = {}, {}
            _same(_canonical(got.key(), port_ids),
                  _canonical(want.key(), ref_ids), f"Q{q}")
            assert [(port_ids[i], c, n) for i, c, n in _sources(got, [])] \
                == [(ref_ids[i], c, n) for i, c, n in _sources(want, [])], \
                f"Q{q}"
    assert sql_records_digest() == before
