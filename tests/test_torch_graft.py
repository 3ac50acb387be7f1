"""The 1D relational step of __graft_entry__.py:78-97 on the port against
the JAX package on CPU meshes of 2 and 4 shards: a per-shard filter, the
join (broadcast: the build side is under bcast_join_threshold), the
two-phase groupby of packed keys, the sample sort; each stage's table
compared with the reference's (per-shard counts, capacities and row
order bit-identical, float64 sums and means within rtol 1e-12), and the
routes each package took.

Then the same join with bcast_join_threshold at 0 in both packages, so
the shuffle join runs (both sides hashed to their key's shard): inner,
and on 4 shards also left and outer; and once against a build side with
repeated keys, whose output overflows its first capacity and is re-run
at the exact size. On 4 shards, a small left side, which the inner join
swaps to the build side and broadcasts.

Last, on 4 shards, the 1D routes that came after the graft step, each
where the reference takes it, held to the reference (tables and routes):
the skew-split join (a hot probe key), the colocated groupby (nunique,
an aggregation that does not decompose), the cross join and
concat_tables. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test)."""

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_table, both_configs,
                                port_routes_reset, reference,
                                reference_routes, to_port,
                                torch_one_thread)  # noqa: F401

F64_RTOL = 1e-12


def _frames(s):
    r = np.random.default_rng(1)
    n = 64 * 8 * s
    left = pd.DataFrame({"k": r.integers(0, 10, n), "v": r.normal(size=n),
                         "s": r.choice(["aa", "bb", "cc"], n)})
    right = pd.DataFrame({"k": np.arange(10), "w": np.arange(10) * 0.5})
    return left, right


def _run(R, c, tl, tr, how="inner"):
    t1 = R.filter_table(tl, c("v") > -1.0)
    t2 = R.join_tables(t1, tr, ["k"], ["k"], how)
    t3 = R.groupby_agg(t2, ["s", "k"], [("v", "sum", "v_sum"),
                                        ("w", "mean", "w_mean")])
    return t1, t2, t3, R.sort_table(t3, ["s", "k"])


def _check_graft_step(s, ref_mesh, how="inner", threshold=None,
                      right=None):
    import bodo_tpu
    import bodo_tpu.relational as R
    from bodo_tpu.plan.expr import ColRef as c
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.plan.expr import ColRef as pc

    left, right0 = _frames(s)
    right = right0 if right is None else right
    cfg = {} if threshold is None else {"bcast_join_threshold": threshold}
    with bodo_tpu.use_mesh(ref_mesh), both_configs(**cfg):
        tl = RefTable.from_pandas(left).shard()
        tr = RefTable.from_pandas(right).shard()
        with reference_routes() as ref_routes:
            ref = _run(R, c, tl, tr, how)
        routes = port_routes_reset()
        port = _run(PR, pc, to_port(tl), to_port(tr), how)
    for got, want in zip(port, ref):
        assert_same_table(got, want, float_rtol=F64_RTOL)
    assert routes == ref_routes
    return {k: v for k, v in routes.items() if v}


def _check_small_left_side(ref_mesh):
    """A small left side of an inner join is swapped to the build side and
    broadcast (the mirror of the broadcast decision)."""
    import bodo_tpu
    import bodo_tpu.relational as R
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR

    left, right = _frames(4)
    with bodo_tpu.use_mesh(ref_mesh):
        small = RefTable.from_pandas(right).shard()
        big = RefTable.from_pandas(left).shard()
        with reference_routes() as ref_routes:
            ref = R.join_tables(small, big, ["k"], ["k"], "inner")
    routes = port_routes_reset()
    port = PR.join_tables(to_port(small), to_port(big), ["k"], ["k"],
                          "inner")
    assert_same_table(port, ref)
    assert routes == ref_routes and routes["join_broadcast"] == 1
    assert port.names == ["k", "w", "v", "s"]


def _check_later_routes(s, ref_mesh, port_mesh):
    import bodo_tpu
    import bodo_tpu.relational as R
    from bodo_tpu.plan import adaptive as ref_aqe
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.parallel.mesh import use_mesh

    def same(call, route):
        with reference_routes() as ref_routes:
            ref = call(R)
        routes = port_routes_reset()
        port = call(PR, to_port)
        assert_same_table(port, ref)
        assert routes == ref_routes and routes[route] == 1, routes

    r = np.random.default_rng(5)
    n = 2000
    hot = pd.DataFrame({"k": np.where(r.random(n) < 0.5, 3,
                                      r.integers(0, 500, n)),
                        "v": r.normal(size=n)})
    build = pd.DataFrame({"k": np.arange(500), "w": r.normal(size=500)})
    with bodo_tpu.use_mesh(ref_mesh), use_mesh(port_mesh), \
            both_configs(aqe_skew_min_rows=1, bcast_join_threshold=100):
        tl = RefTable.from_pandas(hot).shard()
        tr = RefTable.from_pandas(build).shard()
        before = ref_aqe._counters["skew:split_join"]
        same(lambda M, f=lambda t: t: M.join_tables(
            f(tl), f(tr), ["k"], ["k"], "inner"), "join_skew_split")
        assert ref_aqe._counters["skew:split_join"] == before + 1
        same(lambda M, f=lambda t: t: M.groupby_agg(
            f(tl), ["k"], [("v", "nunique", "u")]), "groupby_colocated")
        same(lambda M, f=lambda t: t: M.join_tables(
            f(tl), f(tr), [], [], "cross"), "join_cross")
        same(lambda M, f=lambda t: t: M.concat_tables([f(tl), f(tl)]),
             "concat_tables")


def _count_calls(module, name):
    """Replace module.name by a wrapper that counts its calls."""
    orig = getattr(module, name)

    def counted(*a, **k):
        counted.calls += 1
        return orig(*a, **k)

    counted.calls = 0
    counted.orig = orig
    setattr(module, name, counted)
    return counted


def test_graft_step_matches_reference(reference):
    import jax
    import bodo_tpu
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    for s in (2, 4):
        ref_mesh = bodo_tpu.make_mesh(jax.devices()[:s])
        port_mesh = make_mesh(s, device="cpu")
        with use_mesh(port_mesh):
            assert _check_graft_step(s, ref_mesh) == {
                "join_broadcast": 1, "groupby_packed": 1,
                "groupby_sharded_hash": 1, "sort_sharded": 1}
            for how in ("inner", "left", "outer")[:3 if s == 4 else 1]:
                routes = _check_graft_step(s, ref_mesh, how, threshold=0)
                assert routes["join_shuffle"] == 1, (how, routes)
            dup = pd.DataFrame({"k": np.repeat(np.arange(10), 5),
                                "w": np.arange(50) * 0.25})
            exact_counts = _count_calls(PR, "join_count")
            try:
                routes = _check_graft_step(s, ref_mesh, threshold=0,
                                           right=dup)
            finally:
                PR.join_count = exact_counts.orig
            assert routes["join_shuffle"] == 1, routes
            assert exact_counts.calls == s  # the exact-size re-run
    with use_mesh(port_mesh):
        _check_small_left_side(ref_mesh)
    _check_later_routes(4, ref_mesh, port_mesh)
