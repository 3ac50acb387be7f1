"""The memory governor's budget (runtime/memory_governor.py) and the
broadcast decisions it drives (plan/adaptive.join_broadcast_decision,
should_demote_broadcast) against bodo_tpu, with the governor on in both
packages and the device probe pinned to the same bytes
(`pinned_budget`), on CPU meshes of 4 shards:

  1. the derived budget (headroom 0.15, then 0.3) and the operator slice
     (mem_op_fraction, clamped to [0.05, 1]) equal for probes of 0 to
     7 GiB; the port's own probe on the CPU (a quarter of host RAM split
     over the mesh's shards) re-derived when the mesh changes, and a
     device without a probe raising;
  2. table_device_bytes equal on REP and 1D tables with strings and
     nulls (counted on capacity);
  3. both decisions equal over a grid of budgets around the build's
     bytes (0, 1 byte, and 0.5 to 2 times the budget at which the build
     just fits aqe_bcast_frac of it), for a build under and over
     bcast_join_threshold, a probe more and less than 4 times the build,
     with AQE on and off, and on a mesh of 1 shard;
  4. 1D joins under the governor taking the reference's route (route
     spies) and giving the same table: a build over the rows threshold
     promoted to the broadcast join, a build under it demoted to the
     shuffle join, and a replicated build side sharded (demoted) before
     the shuffle join.

Budgets and bytes are integers and equal exactly; tables bit-identical.
One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test).
"""

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (assert_same_table, both_configs,  # noqa
                                pinned_budget, port_routes_reset,
                                reference, reference_routes, to_port,
                                torch_one_thread)

SHARDS = 4
GiB = 1 << 30


def _check_budget():
    import torch
    from bodo_tpu.runtime import memory_governor as ref_mg
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.runtime import memory_governor as port_mg

    for probe in (0, 1, 12_345, 7 * GiB):
        with pinned_budget(probe):
            ref_gov, port_gov = ref_mg.governor(), port_mg.governor()
            assert port_gov.derived_budget() == ref_gov.derived_budget() \
                == int(probe * 0.85)
            assert port_gov.operator_budget() == ref_gov.operator_budget()
            for frac in (0.01, 0.3, 2.0):
                with both_configs(mem_op_fraction=frac):
                    assert port_gov.operator_budget() == \
                        ref_gov.operator_budget()
            with both_configs(mem_headroom_frac=0.3):
                # the budget is re-derived only when the probe is reset
                ref_gov.set_probe_for_testing(probe)
                port_gov.set_probe_for_testing(probe)
                assert port_gov.derived_budget() == \
                    ref_gov.derived_budget() == int(probe * 0.7)
    # the port's own probe on the CPU: a quarter of host RAM a shard
    ram = port_mg._host_ram_bytes()
    port_mg.reset_governor()
    try:
        for s in (2, SHARDS):
            with use_mesh(make_mesh(s, device="cpu")):
                assert port_mg.governor().derived_budget() == \
                    int(int(ram * 0.25 / s) * 0.85)
        with pytest.raises(ValueError, match="no memory probe"):
            port_mg._probe_device_budget(torch.device("meta"), SHARDS)
    finally:
        port_mg.reset_governor()


def _frames(r, n_probe: int, n_build: int):
    probe = pd.DataFrame({"k": r.integers(0, n_build, n_probe),
                          "v": r.normal(size=n_probe)})
    build = pd.DataFrame({
        "k": np.arange(n_build),
        "w": np.where(r.random(n_build) < 0.1, np.nan,
                      r.normal(size=n_build)),
        "s": pd.array(np.where(r.random(n_build) < 0.2, None,
                               r.choice(["x", "y", "z"], n_build)),
                      dtype=object),
        "i": pd.array(np.where(r.random(n_build) < 0.2, None,
                               r.integers(0, 9, n_build)), dtype="Int32"),
    })
    return probe, build


def _check_bytes(tables):
    from bodo_tpu.runtime import memory_governor as ref_mg
    from bodo_tpu_torch.runtime import memory_governor as port_mg
    for t in tables:
        assert port_mg.table_device_bytes(to_port(t)) == \
            ref_mg.table_device_bytes(t)


def _check_decisions(probe, build, build_rep):
    """Both decisions of both packages under one budget."""
    from bodo_tpu.plan import adaptive as ref_aqe
    from bodo_tpu_torch.plan import adaptive as port_aqe
    pp, pb, pr = to_port(probe), to_port(build), to_port(build_rep)
    got = (port_aqe.join_broadcast_decision(pb, pp),
           port_aqe.join_broadcast_decision(pp, pb),
           port_aqe.should_demote_broadcast(pr))
    want = (ref_aqe.join_broadcast_decision(build, probe),
            ref_aqe.join_broadcast_decision(probe, build),
            ref_aqe.should_demote_broadcast(build_rep))
    assert got == want
    return got


def _check_grid(r, ref_mesh, port_mesh):
    import bodo_tpu
    from bodo_tpu.runtime import memory_governor as ref_mg
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.parallel.mesh import use_mesh

    seen = set()
    with bodo_tpu.use_mesh(ref_mesh), use_mesh(port_mesh):
        probe_df, build_df = _frames(r, 2000, 300)
        probe = RefTable.from_pandas(probe_df).shard()
        build_rep = RefTable.from_pandas(build_df)
        build = build_rep.shard()
        _check_bytes([probe, build, build_rep])
        nbytes = ref_mg.table_device_bytes(build)
        fit = nbytes / 0.05 / 0.85   # the probe at which the build fits
        probes = [0, 1] + [int(fit * f) for f in
                           (0.5, 0.98, 0.999, 1.0, 1.001, 1.02, 2.0)]
        for p in probes:
            with pinned_budget(p):
                for cfg in ({}, {"bcast_join_threshold": 100},
                            {"aqe": False}):
                    with both_configs(**cfg):
                        seen.add(_check_decisions(probe, build, build_rep))
        # a probe side not 4 times the build: never broadcast
        small = RefTable.from_pandas(probe_df.iloc[:1000]).shard()
        with pinned_budget(int(fit * 2)):
            assert _check_decisions(small, build, build_rep)[0] is False
    # one shard: nothing is demoted
    one_ref = bodo_tpu.make_mesh(ref_mesh.devices.flat[:1])
    from bodo_tpu_torch.parallel.mesh import make_mesh
    with bodo_tpu.use_mesh(one_ref), use_mesh(make_mesh(1, device="cpu")):
        with pinned_budget(1):
            from bodo_tpu.plan import adaptive as ref_aqe
            from bodo_tpu_torch.plan import adaptive as port_aqe
            assert port_aqe.should_demote_broadcast(to_port(build_rep)) \
                is ref_aqe.should_demote_broadcast(build_rep) is False
    # broadcast, shuffled with the replicated side demoted, and shuffled
    # with it kept
    assert {(True, False, False), (False, False, True),
            (False, False, False)} <= seen, seen


def _check_join(ref_mesh, port_mesh, probe_df, build_df, probe_bytes,
                cfg, rep_build=False):
    import bodo_tpu
    import bodo_tpu.relational as R
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.parallel.mesh import use_mesh

    with bodo_tpu.use_mesh(ref_mesh), use_mesh(port_mesh), \
            pinned_budget(probe_bytes), both_configs(**cfg):
        tl = RefTable.from_pandas(probe_df).shard()
        tr = RefTable.from_pandas(build_df)
        if not rep_build:
            tr = tr.shard()
        with reference_routes() as ref_routes:
            ref = R.join_tables(tl, tr, ["k"], ["k"], "inner")
        routes = port_routes_reset()
        port = PR.join_tables(to_port(tl), to_port(tr), ["k"], ["k"],
                              "inner")
    assert_same_table(port, ref)
    assert routes == ref_routes
    return {k: v for k, v in routes.items() if v}


def test_governor_matches_reference(reference):
    import jax
    import bodo_tpu
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    r = np.random.default_rng(17)
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    port_mesh = make_mesh(SHARDS, device="cpu")
    with use_mesh(port_mesh):
        _check_budget()
    _check_grid(r, ref_mesh, port_mesh)
    probe_df, build_df = _frames(r, 2000, 300)
    # over the rows threshold, under the byte budget: promoted
    assert _check_join(ref_mesh, port_mesh, probe_df, build_df, 8 * GiB,
                       {"bcast_join_threshold": 100}) == {
                           "join_broadcast": 1}
    # under the rows threshold, over the byte budget: demoted
    assert _check_join(ref_mesh, port_mesh, probe_df, build_df, 10_000,
                       {}) == {"join_shuffle": 1}
    # a replicated build side over the budget: sharded, then shuffled
    assert _check_join(ref_mesh, port_mesh, probe_df, build_df, 10_000,
                       {}, rep_build=True) == {"join_shuffle": 1}
    # the same replicated side within the budget stays broadcast
    assert _check_join(ref_mesh, port_mesh, probe_df, build_df, 8 * GiB,
                       {}, rep_build=True) == {"join_broadcast": 1}
