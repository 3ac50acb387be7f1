"""The port's SQL entry point on TPC-H against bodo_tpu and sqlite.

gen_tpch(n_orders=900, seed=3), the size tests/test_tpch.py uses, from
the port's copy of the generator (equal to the reference's frames). Each
of the 22 queries runs through bodo_tpu_torch.sql.BodoSQLContext on the
CPU (parse, plan, optimize, execute), through bodo_tpu.sql.BodoSQLContext
and through the stdlib sqlite3. The port's result equals the
reference's (columns, dtypes, integers, strings, dates and nulls
exactly, float64 within rtol 1e-12: the same sums in another order),
with the same routes, and sqlite's after the normalization of
tests/test_tpch.py (floats within rtol 1e-9). All 22 run:
workloads/tpch.UNSUPPORTED, the queries that would raise
NotImplementedError naming their route (and run last, so the stage
observations that order the joins of every other query are the same in
both packages), is empty; Q16's COUNT(DISTINCT) takes the packed route
and the sort groupby's nunique in both packages.

The reference's SQL path records its stages in process state (its
stats store, plan cache counters, explain records, elastic registry and
result cache counters); the test fails if any of them differs after the
reference scope from before it. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test).
"""

import pandas as pd
import pytest

from tests.torch_parity import (assert_same_frame, fresh_observations,
                                port_routes_reset, reference_routes,
                                reference_state, sql_records_digest,
                                torch_one_thread)  # noqa: F401


def test_sql_tpch_matches_reference_and_sqlite(torch_one_thread):
    import bodo_tpu.plan.explain  # noqa: F401  (the SQL path's modules,
    import bodo_tpu.plan.physical  # noqa: F401  imported before the
    import bodo_tpu.runtime.elastic  # noqa: F401  digest is taken)
    import bodo_tpu.runtime.stats_store  # noqa: F401
    import bodo_tpu.sql as ref_sql
    import bodo_tpu.sql.plan_cache  # noqa: F401
    from bodo_tpu.workloads.tpch import gen_tpch as ref_gen_tpch
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.workloads.tpch import (QUERIES, UNSUPPORTED,
                                               check_against_sqlite,
                                               gen_tpch, sqlite_connection,
                                               to_sqlite)

    data = gen_tpch(n_orders=900, seed=3)
    ref_data = ref_gen_tpch(n_orders=900, seed=3)
    assert list(data) == list(ref_data)
    for name in data:
        pd.testing.assert_frame_equal(data[name], ref_data[name])
    conn = sqlite_connection(data)
    port_ctx = BodoSQLContext(data, device="cpu")

    before = sql_records_digest()
    with reference_state(), fresh_observations():
        ref_ctx = ref_sql.BodoSQLContext(data)
        for q in sorted(set(QUERIES) - set(UNSUPPORTED)):
            sql = QUERIES[q]
            with reference_routes() as ref_routes:
                want = ref_ctx.sql(sql).to_pandas()
            routes = port_routes_reset()
            got = port_ctx.sql(sql).to_pandas()
            assert routes == ref_routes, f"Q{q}"
            assert_same_frame(got, want, 1e-12, f"Q{q}")
            exp = pd.read_sql_query(to_sqlite(sql), conn)
            check_against_sqlite(got, exp, sql, rtol=1e-9, label=f"Q{q}")
        for q, route in sorted(UNSUPPORTED.items()):
            with pytest.raises(NotImplementedError, match=route):
                port_ctx.sql(QUERIES[q]).to_pandas()
    assert sql_records_digest() == before
    conn.close()
