"""The star-schema join slice on the port against the same relational calls
on bodo_tpu and against the port's numpy oracle, at 20,000 fact rows
(5,000 dimension rows with unique sparse keys, so the join takes the hash
join and the groupby the dense route in both packages).

The filtered and joined tables are bit-identical, rows in the same order.
In the result, g and c are bit-identical; s is a float64 segment sum,
which the port accumulates with index_add_ and the reference with XLA's
scatter-add: the same values, possibly summed in another order, hence
rtol=1e-12 rather than equality.

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import pandas as pd

from tests.torch_parity import (assert_same_table, port_routes_reset,
                                reference, reference_routes,
                                torch_one_thread)  # noqa: F401

N_ROWS = 20_000
SUM_RTOL = 1e-12


def _reference_pipeline(fact, dim):
    """The port's star pipeline, step by step, on the reference; returns
    (joined table, result)."""
    import bodo_tpu.relational as R
    from bodo_tpu.plan.expr import ColRef, Lit
    from bodo_tpu.table import Table
    ft = Table.from_pandas(pd.DataFrame(fact))
    dt_ = Table.from_pandas(pd.DataFrame(dim))
    f = R.filter_table(ft, ColRef("y") % Lit(3) != Lit(0))
    j = R.join_tables(f, dt_, ["k"], ["k"], "inner")
    j = R.assign_columns(j, {"u": ColRef("v") * ColRef("w")})
    out = R.groupby_agg(j, ["g"], [("u", "sum", "s"), ("v", "count", "c")])
    return j, R.sort_table(out, ["g"])


def test_star_join_slice_matches_reference(reference):
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.plan.expr import ColRef, Lit
    from bodo_tpu_torch.workloads import star_join as S
    fact, dim = S.gen_star_arrays(N_ROWS, seed=0)
    assert len(dim["k"]) == N_ROWS // 4
    with reference_routes() as ref_routes:
        ref_joined, ref = _reference_pipeline(fact, dim)
    routes = port_routes_reset()
    launches = dict(CK.launches)
    port = S.pipeline(fact, dim, device="cpu")
    assert CK.launches == launches  # CPU tables: plain versions only
    assert_same_table(port, ref, float_rtol=SUM_RTOL)
    assert routes == ref_routes
    assert {k: v for k, v in routes.items() if v} == {
        "join_hash": 1, "groupby_dense": 1, "sort_local": 1}
    assert port.nrows == S.N_GROUPS

    # the joined rows themselves, in order
    ft, dt_ = S.tables_from_arrays(fact, dim, device="cpu")
    joined = PR.assign_columns(
        PR.join_tables(PR.filter_table(ft, ColRef("y") % Lit(3) != Lit(0)),
                       dt_, ["k"], ["k"], "inner"),
        {"u": ColRef("v") * ColRef("w")})
    assert_same_table(joined, ref_joined, check_vrange=True)

    got = {n: port.column(n).data[:port.nrows].numpy() for n in port.names}
    S.check_against(got, S.numpy_pipeline(fact, dim), rtol=SUM_RTOL)
