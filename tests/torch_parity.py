"""Parity harness for the tests of the PyTorch port (tests/test_torch_*.py).

The JAX package is the reference. These tests run it in the same process
as the other tests of the suite, so every call into it happens inside
the `reference` fixture, which saves and restores what the reference
keeps at process level:

  - bodo_tpu.ops.pallas_kernels: FORCE_INTERPRET, _runtime_disabled,
    trace_count, trace_counts (interpret-mode kernels bump the counts);
  - every bodo_tpu.config field, and the process environment that
    set_config exports to;
  - the active mesh, and the meshes bodo_tpu.parallel.shuffle keeps by
    key (_MESHES);
  - what the reference's 1D entry points record: the comm observatory
    (bodo_tpu.parallel.comm), the adaptive-execution counters and
    observations (bodo_tpu.plan.adaptive), the lockstep counters
    (bodo_tpu.analysis.lockstep) and the trace events
    (bodo_tpu.utils.tracing);
  - the codecs the reference's parquet `_plan_chunk` caches
    (bodo_tpu.io.device_decode._codec_cache). The decode tests call
    only its pure host functions, never its read route, whose footer,
    schema and program caches and io_pool counters later JAX tests
    read;
  - the streaming host-sync counts (bodo_tpu.plan.streaming.stream_stats),
    which its append_sharded bumps, and its memory governor
    (bodo_tpu.runtime.memory_governor._governor): a test that turns the
    governor on replaces it with a fresh one (`reset_governor`) before
    it pins a probe, and the fixture puts the old one back;
  - every field of the port's config, which is process state of the
    worker too;
  - what the reference's SQL path (BodoSQLContext.sql -> plan/physical
    execute) records, for each of its modules already imported: the
    stats store of observed stage cardinalities
    (bodo_tpu.runtime.stats_store._store: the scope gets a fresh
    in-memory store, and the old one is put back), the SQL plan cache's
    counters (bodo_tpu.sql.plan_cache._stats, _by_session), explain's
    query records (bodo_tpu.plan.explain._queries, _last_qid), elastic's
    stage registry (bodo_tpu.runtime.elastic._qseq, _QSTORE) and the
    semantic result cache's counters (the cache's _c, _sess and
    saved_wall_s). `sql_records_digest` fingerprints all of them, so a
    SQL test can check that none changed.

It also turns the reference's progcheck off (ROADMAP fault F1: progcheck
breaks on this tree's jax), and its fusion and fused-join caches off
(config.fusion, config.fusion_join): the reference's hash join would
otherwise keep its build table in `fusion_join._build_cache`, which
would outlive the test in the worker. Its SQL executor's result cache,
elastic stage registry and plan validation are off too
(config.result_cache, config.elastic, config.plan_validate): the first
two would keep results and checkpoints past the test, and the port has
none of the three (ROADMAP Queue 3, G2-G5). The memory governor is off in
both packages (config.mem_governor), so their broadcast decisions take
the rows-only rule unless a test pins a budget on both sides
(`pinned_budget`). Its comm accounting is off
(config.comm_accounting), whose metrics histograms have no way back.
Kernels run in interpret mode only through an explicit
`interpret=True`, never by flipping FORCE_INTERPRET. torch runs
on one intra-op thread in these tests, so they add no more CPU load than
any other test of the suite.

Data crosses between the packages as numpy arrays.

Each test_torch_* file holds one test that runs all of its checks.
pytest-xdist's `--dist loadfile` hands out files with the most tests
first, so one-test files go out after every file of the JAX suite (whose
only one-test files sort before them): they cannot shift which worker
runs which JAX test file, nor leave state behind for one.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import os
import sys
from typing import Dict

import numpy as np
import pytest


@pytest.fixture
def torch_one_thread():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _process_records():
    """The reference's process-level records that its 1D calls write, as
    (module, attribute, snapshot) triples."""
    from bodo_tpu.analysis import lockstep
    from bodo_tpu.io import device_decode
    from bodo_tpu.parallel import comm
    from bodo_tpu.parallel import shuffle
    from bodo_tpu.plan import adaptive, streaming
    from bodo_tpu.runtime import memory_governor
    from bodo_tpu.utils import tracing
    names = ((comm, ("_sites", "_last", "_seq")),
             (adaptive, ("_counters", "_observed", "_qerr")),
             (lockstep, ("_stats",)),
             (tracing, ("_events", "_agg", "_tids", "_query_meta",
                        "_dropped")),
             (shuffle, ("_MESHES",)),
             (device_decode, ("_codec_cache",)),
             (streaming, ("stream_stats",)),
             (memory_governor, ("_governor",)))
    # the meshes, the trace events and the codecs are held, not changed
    # in place; the governor object itself is put back
    shallow = ("_MESHES", "_events", "_codec_cache")

    def snap(name, obj):
        if name == "_governor":
            return obj
        return (copy.copy if name in shallow else copy.deepcopy)(obj)
    return [(mod, name, snap(name, getattr(mod, name)))
            for mod, attrs in names for name in attrs]


def _restore_records(saved) -> None:
    """Put the snapshots back into the objects the modules hold (other
    modules keep references to them), or rebind plain values."""
    for mod, name, snap in saved:
        cur = getattr(mod, name)
        if isinstance(cur, dict):
            cur.clear()
            cur.update(snap)
        elif hasattr(cur, "clear") and hasattr(cur, "extend"):
            cur.clear()
            cur.extend(snap)
        else:
            setattr(mod, name, snap)


# the reference's modules on its SQL path whose records the scope keeps
_SQL_MODULES = ("bodo_tpu.runtime.stats_store", "bodo_tpu.sql.plan_cache",
                "bodo_tpu.plan.explain", "bodo_tpu.runtime.elastic",
                "bodo_tpu.runtime.result_cache")


def _sql_records():
    """Snapshots of the SQL path's records, for each of its modules that
    is imported (a module imported later starts from nothing)."""
    mods = {n: sys.modules.get(n) for n in _SQL_MODULES}
    out = {}
    ss = mods["bodo_tpu.runtime.stats_store"]
    if ss is not None:
        out["stats_store"] = (ss, ss._store, ss._store_dir)
    pc = mods["bodo_tpu.sql.plan_cache"]
    if pc is not None:
        out["plan_cache"] = (pc, dict(pc._stats),
                             copy.deepcopy(pc._by_session))
    ex = mods["bodo_tpu.plan.explain"]
    if ex is not None:
        out["explain"] = (ex, copy.copy(ex._queries), ex._last_qid)
    el = mods["bodo_tpu.runtime.elastic"]
    if el is not None:
        out["elastic"] = (el, el._qseq, el._QSTORE,
                          dict(el._QSTORE._stats), el._QSTORE._bytes)
    rc = mods["bodo_tpu.runtime.result_cache"]
    if rc is not None and rc._cache is not None:
        c = rc._cache
        out["result_cache"] = (rc, c, dict(c._c), copy.deepcopy(c._sess),
                               c.saved_wall_s)
    return out


def _fresh_stats_store(saved) -> None:
    """A fresh in-memory stats store for the scope, bound to the current
    directory setting so get_store() keeps it."""
    if "stats_store" not in saved:
        return
    from bodo_tpu.config import config
    ss = saved["stats_store"][0]
    ss._store = ss.StatsStore(None)
    ss._store_dir = config.stats_store_dir


def _restore_sql_records(saved) -> None:
    if "stats_store" in saved:
        ss, store, store_dir = saved["stats_store"]
        ss._store, ss._store_dir = store, store_dir
    if "plan_cache" in saved:
        pc, stats, by_session = saved["plan_cache"]
        pc._stats.clear()
        pc._stats.update(stats)
        pc._by_session.clear()
        pc._by_session.update(by_session)
    if "explain" in saved:
        ex, queries, last = saved["explain"]
        ex._queries.clear()
        ex._queries.update(queries)
        ex._last_qid = last
    if "elastic" in saved:
        el, qseq, qstore, qstats, qbytes = saved["elastic"]
        el._qseq, el._QSTORE = qseq, qstore
        qstore._stats.clear()
        qstore._stats.update(qstats)
        qstore._bytes = qbytes
    if "result_cache" in saved:
        rc, c, counters, sess, saved_wall = saved["result_cache"]
        rc._cache = c
        c._c.clear()
        c._c.update(counters)
        c._sess.clear()
        c._sess.update(sess)
        c.saved_wall_s = saved_wall


def sql_records_digest() -> str:
    """Digest of the reference's SQL-path records (the stats store's
    identity and entries, the plan cache's counters, explain's query
    ids, elastic's sequence and store, the result cache's identity,
    entry count and counters); modules not imported count as absent."""
    parts = []
    for name in _SQL_MODULES:
        mod = sys.modules.get(name)
        if mod is None:
            parts.append((name, None))
        elif name.endswith("stats_store"):
            st = mod._store
            parts.append((name, id(st), mod._store_dir,
                          None if st is None else sorted(
                              (k, v["rows"], v["bytes"])
                              for k, v in st._data.items())))
        elif name.endswith("plan_cache"):
            parts.append((name, sorted(mod._stats.items()),
                          repr(sorted(mod._by_session.items()))))
        elif name.endswith("explain"):
            parts.append((name, list(mod._queries), mod._last_qid))
        elif name.endswith("elastic"):
            q = mod._QSTORE
            parts.append((name, mod._qseq, id(q), sorted(q._stats.items()),
                          q._bytes))
        else:
            c = mod._cache
            parts.append((name, id(c), None if c is None else (
                len(c._entries), sorted(c._c.items()),
                repr(sorted(c._sess.items())), c.saved_wall_s)))
    return hashlib.sha256(repr(parts).encode()).hexdigest()


@contextlib.contextmanager
def reference_state():
    from bodo_tpu.config import config
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu.parallel import mesh as mesh_mod
    from bodo_tpu_torch.config import config as port_config

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    port_cfg = {f.name: getattr(port_config, f.name)
                for f in dataclasses.fields(port_config)}
    env = dict(os.environ)
    pk = (PK.FORCE_INTERPRET, PK._runtime_disabled, PK.trace_count,
          dict(PK.trace_counts))
    mesh = mesh_mod._active_mesh
    records = _process_records()
    sql_records = _sql_records()
    _fresh_stats_store(sql_records)
    # attributes: nothing is exported to the environment
    config.progcheck = False
    config.fusion = False
    config.fusion_join = False
    config.mem_governor = False
    config.comm_accounting = False
    config.result_cache = False
    config.elastic = False
    config.plan_validate = False
    port_config.mem_governor = False
    try:
        yield
    finally:
        _restore_sql_records(sql_records)
        _restore_records(records)
        for k, v in cfg.items():
            setattr(config, k, v)
        for k, v in port_cfg.items():
            setattr(port_config, k, v)
        if dict(os.environ) != env:
            os.environ.clear()
            os.environ.update(env)
        (PK.FORCE_INTERPRET, PK._runtime_disabled, PK.trace_count) = pk[:3]
        PK.trace_counts.clear()
        PK.trace_counts.update(pk[3])
        mesh_mod.set_mesh(mesh)


@pytest.fixture
def reference(torch_one_thread):
    """Scope in which a test may call the JAX package."""
    with reference_state():
        yield


# route name (bodo_tpu_torch.relational.route_counts) -> (module, function)
# of the reference that takes that route
_REF_ROUTES = {
    "join_dense": ("bodo_tpu.relational", "_join_dense_try"),
    "join_hash": ("bodo_tpu.relational", "_join_hash_try"),
    "groupby_dense": ("bodo_tpu.relational", "_groupby_agg_dense"),
    "groupby_packed": ("bodo_tpu.relational", "_groupby_agg_packed"),
    "groupby_hashed": ("bodo_tpu.ops.groupby", "groupby_local_hashed"),
    "groupby_sort": ("bodo_tpu.relational", "groupby_local"),
    "sort_local": ("bodo_tpu.relational", "sort_local"),
    "join_broadcast": ("bodo_tpu.relational", "_join_broadcast"),
    "sort_sharded": ("bodo_tpu.relational", "sort_sharded"),
    "join_cross": ("bodo_tpu.relational", "_cross_join"),
    "join_skew_split": ("bodo_tpu.plan.adaptive", "try_skew_split_join"),
    "append_sharded": ("bodo_tpu.plan.streaming_sharded", "append_sharded"),
    "concat_tables": ("bodo_tpu.relational", "concat_tables"),
}


@contextlib.contextmanager
def reference_routes():
    """Count the routes the reference takes, under the port's route names.
    A route counts when it produced the result: a dense or hash join that
    found the build side unfit (None) and an unresolved hash groupby do
    not. `_join_rep` counts as join_rep_<method>, the method of its last
    join_local call (hash, or sort after a hash run that did not
    resolve). `_join_sharded` counts as join_shuffle when it is not the
    broadcast join's, and `groupby_sharded` as groupby_sharded_<method>,
    the method of its last partial stage. `_groupby_agg_colocated` counts
    as groupby_colocated and not as groupby_sort: its per-shard
    groupby_local runs inside a jitted shard_map body, where the spy sees
    it only when the program is traced. The windows: `_rank_window_exec`
    and `_agg_window_exec` count as rank_window_<how> and
    agg_window_<how>, <how> local on a replicated input and shuffle on a
    1D one; `_global_rank_sharded` as rank_window_global;
    `_broadcast_scalar_column` as agg_window_broadcast (once a column);
    an `agg_window` called inside `agg_window` (the gather of an ordered
    frame without partition keys) as agg_window_gather."""
    import importlib
    import bodo_tpu.parallel.shuffle as ref_shuffle
    import bodo_tpu.relational as ref_rel
    counts = {name: 0 for name in _REF_ROUTES}
    counts.update(join_rep_hash=0, join_rep_sort=0, join_shuffle=0,
                  groupby_sharded_hash=0, groupby_sharded_sort=0,
                  groupby_colocated=0, rank_window_local=0,
                  rank_window_shuffle=0, rank_window_global=0,
                  agg_window_local=0, agg_window_shuffle=0,
                  agg_window_broadcast=0, agg_window_gather=0)
    saved = []
    last_method = ["sort"]
    partial_method = ["sort"]

    def join_local_spy(*a, _orig=ref_rel.join_local, **k):
        last_method[0] = k.get("method", a[8] if len(a) > 8 else "sort")
        return _orig(*a, **k)

    def join_rep_spy(*a, _orig=ref_rel._join_rep, **k):
        out = _orig(*a, **k)
        counts[f"join_rep_{last_method[0]}"] += 1
        return out

    def join_sharded_spy(*a, _orig=ref_rel._join_sharded, **k):
        out = _orig(*a, **k)
        if not k.get("broadcast", a[6] if len(a) > 6 else False):
            counts["join_shuffle"] += 1
        return out

    def partial_spy(*a, _orig=ref_shuffle._build_groupby_partial, **k):
        partial_method[0] = k.get("method", a[3] if len(a) > 3 else "sort")
        return _orig(*a, **k)

    def groupby_sharded_spy(*a, _orig=ref_rel.groupby_sharded, **k):
        out = _orig(*a, **k)
        counts[f"groupby_sharded_{partial_method[0]}"] += 1
        return out

    def colocated_spy(*a, _orig=ref_rel._groupby_agg_colocated, **k):
        before = counts["groupby_sort"]
        out = _orig(*a, **k)
        counts["groupby_sort"] = before
        counts["groupby_colocated"] += 1
        return out

    def window_exec_spy(kind, orig):
        def spy(t, *a, **k):
            how = "shuffle" if t.distribution == "1D" else "local"
            counts[f"{kind}_window_{how}"] += 1
            return orig(t, *a, **k)
        return spy

    def counting_spy(route, orig):
        def spy(*a, **k):
            counts[route] += 1
            return orig(*a, **k)
        return spy

    agg_depth = [0]

    def agg_window_spy(*a, _orig=ref_rel.agg_window, **k):
        if agg_depth[0]:
            counts["agg_window_gather"] += 1
        agg_depth[0] += 1
        try:
            return _orig(*a, **k)
        finally:
            agg_depth[0] -= 1

    for mod, fname, spy in (
            (ref_rel, "_rank_window_exec",
             window_exec_spy("rank", ref_rel._rank_window_exec)),
            (ref_rel, "_agg_window_exec",
             window_exec_spy("agg", ref_rel._agg_window_exec)),
            (ref_rel, "_global_rank_sharded",
             counting_spy("rank_window_global",
                          ref_rel._global_rank_sharded)),
            (ref_rel, "_broadcast_scalar_column",
             counting_spy("agg_window_broadcast",
                          ref_rel._broadcast_scalar_column)),
            (ref_rel, "agg_window", agg_window_spy),
            (ref_rel, "join_local", join_local_spy),
            (ref_rel, "_groupby_agg_colocated", colocated_spy),
            (ref_rel, "_join_rep", join_rep_spy),
            (ref_rel, "_join_sharded", join_sharded_spy),
            (ref_shuffle, "_build_groupby_partial", partial_spy),
            (ref_rel, "groupby_sharded", groupby_sharded_spy)):
        saved.append((mod, fname, getattr(mod, fname)))
        setattr(mod, fname, spy)
    for route, (modname, fname) in _REF_ROUTES.items():
        mod = importlib.import_module(modname)
        orig = getattr(mod, fname)

        def spy(*a, _orig=orig, _route=route, **k):
            out = _orig(*a, **k)
            taken = out is not None
            if _route == "groupby_hashed":
                taken = not out[3]
            counts[_route] += int(taken)
            return out

        saved.append((mod, fname, orig))
        setattr(mod, fname, spy)
    try:
        yield counts
    finally:
        for mod, fname, orig in saved:
            setattr(mod, fname, orig)


@contextlib.contextmanager
def pinned_budget(probe_bytes: int):
    """The memory governor on in both packages, each a fresh governor
    whose device probe returns `probe_bytes` (a shard's bytes before
    headroom), so both derive the same budget. The port's governor is
    dropped afterwards; the `reference` fixture puts the reference's
    back."""
    from bodo_tpu.runtime import memory_governor as ref_mg
    from bodo_tpu_torch.runtime import memory_governor as port_mg
    ref_mg.reset_governor()
    port_mg.reset_governor()
    ref_mg.governor().set_probe_for_testing(int(probe_bytes))
    port_mg.governor().set_probe_for_testing(int(probe_bytes))
    try:
        with both_configs(mem_governor=True):
            yield
    finally:
        port_mg.reset_governor()
        ref_mg.reset_governor()


@contextlib.contextmanager
def both_configs(**kwargs):
    """Set config fields in both packages for a block, then put both back
    (the port's config is process state of the worker too)."""
    from bodo_tpu.config import config as ref_config
    from bodo_tpu_torch.config import config as port_config
    saved = [(c, k, getattr(c, k)) for c in (ref_config, port_config)
             for k in kwargs]
    for c, k, _ in saved:
        setattr(c, k, kwargs[k])
    try:
        yield
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


@contextlib.contextmanager
def fresh_observations():
    """Both packages' stage observations start empty for the block: the
    SQL planners and the join re-optimization order joins by them. The
    reference's (plan.adaptive._observed) is put back by the `reference`
    scope; the port's (plan.adaptive._observed and _store) is saved and
    put back here. The reference's stats store is already fresh in that
    scope."""
    from bodo_tpu.plan import adaptive as ref_adaptive
    from bodo_tpu_torch.plan import adaptive as port_adaptive
    ref_adaptive._observed.clear()
    saved = (dict(port_adaptive._observed), dict(port_adaptive._store))
    port_adaptive.reset()
    try:
        yield
    finally:
        port_adaptive.reset()
        port_adaptive._observed.update(saved[0])
        port_adaptive._store.update(saved[1])


def assert_same_frame(got, want, float_rtol: float, label: str = "") -> None:
    """Two result frames: the same columns and dtypes, integers, strings,
    dates and nulls equal, floats within `float_rtol` (NaN matching)."""
    import pandas as pd
    assert list(got.columns) == list(want.columns), label
    assert len(got) == len(want), label
    for c in want.columns:
        g, w = got[c], want[c]
        assert g.dtype == w.dtype, f"{label} {c}: {g.dtype} vs {w.dtype}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(),
                                       rtol=float_rtol, atol=0,
                                       equal_nan=True,
                                       err_msg=f"{label} {c}")
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True,
                                           obj=f"{label} {c}")


def port_routes_reset():
    from bodo_tpu_torch import relational as PR
    PR.reset_route_counts()
    return PR.route_counts


def export_reference(t) -> Dict[str, tuple]:
    """A reference Table's Column fields as numpy, for
    bodo_tpu_torch.table.from_reference_arrays: a 1D table's global
    arrays as they lie, shard by shard (its per-shard counts are
    `t.counts`; `to_port` passes both)."""
    return {n: (np.asarray(c.data),
                None if c.valid is None else np.asarray(c.valid),
                c.dtype.name, c.dictionary, c.vrange)
            for n, c in t.columns.items()}


def to_port(t, device="cpu"):
    """The port's Table of the same layout as the reference Table `t`
    (a 1D table keeps its shards and per-shard counts)."""
    from bodo_tpu_torch.table import from_reference_arrays
    return from_reference_arrays(export_reference(t), t.nrows,
                                 device=device, counts=t.counts)


def _live_rows(t) -> np.ndarray:
    """Positions of the real rows: every shard's, in shard order."""
    if t.counts is None:
        return np.arange(t.nrows)
    per = t.capacity // len(t.counts)
    return np.concatenate([np.arange(i * per, i * per + int(c))
                           for i, c in enumerate(t.counts)]
                          + [np.zeros(0, np.int64)])


def assert_same_table(port, ref, float_rtol: float = 0.0,
                      check_vrange: bool = False) -> None:
    """Column by column, the port's physical values against the
    reference's over the real rows: names, dtypes, distribution, per-shard
    counts, capacity, dictionaries and validity exactly; data
    bit-identical, floats within `float_rtol` (NaN matching NaN)."""
    assert port.nrows == ref.nrows
    assert port.names == ref.names
    assert port.distribution == ref.distribution
    if ref.counts is None:
        assert port.counts is None
    else:
        np.testing.assert_array_equal(port.counts, ref.counts)
    assert port.capacity == ref.capacity
    n = ref.nrows
    live = _live_rows(ref)
    for name in ref.names:
        pc, rc = port.column(name), ref.column(name)
        assert pc.dtype.name == rc.dtype.name, name
        if rc.dictionary is None:
            assert pc.dictionary is None, name
        else:
            np.testing.assert_array_equal(pc.dictionary, rc.dictionary,
                                          err_msg=name)
        assert (pc.valid is None) == (rc.valid is None), name
        if rc.valid is not None:
            np.testing.assert_array_equal(pc.valid.cpu().numpy()[live],
                                          np.asarray(rc.valid)[live],
                                          err_msg=name)
        got = pc.data.cpu().numpy()[live]
        want = np.asarray(rc.data)[live]
        assert len(want) == n
        if want.dtype.kind == "f" and float_rtol > 0:
            np.testing.assert_allclose(got, want, rtol=float_rtol, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
        if check_vrange:
            assert pc.vrange == rc.vrange, name
