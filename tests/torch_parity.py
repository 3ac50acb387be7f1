"""Parity harness for the tests of the PyTorch port (tests/test_torch_*.py).

The JAX package is the reference. These tests run it in the same process
as the other tests of the suite, so every call into it happens inside
the `reference` fixture, which saves and restores what the reference
keeps at process level:

  - bodo_tpu.ops.pallas_kernels: FORCE_INTERPRET, _runtime_disabled,
    trace_count, trace_counts (interpret-mode kernels bump the counts);
  - every bodo_tpu.config field, and the process environment that
    set_config exports to;
  - the active mesh.

It also turns the reference's progcheck off (ROADMAP fault F1: progcheck
breaks on this tree's jax), and its fusion and fused-join caches off
(config.fusion, config.fusion_join): the reference's hash join would
otherwise keep its build table in `fusion_join._build_cache`, which
would outlive the test in the worker. Kernels run in interpret mode only through an
explicit `interpret=True`, never by flipping FORCE_INTERPRET. torch runs
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
import dataclasses
import os
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


@contextlib.contextmanager
def reference_state():
    from bodo_tpu.config import config
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu.parallel import mesh as mesh_mod

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    env = dict(os.environ)
    pk = (PK.FORCE_INTERPRET, PK._runtime_disabled, PK.trace_count,
          dict(PK.trace_counts))
    mesh = mesh_mod._active_mesh
    # attributes: nothing is exported to the environment
    config.progcheck = False
    config.fusion = False
    config.fusion_join = False
    try:
        yield
    finally:
        for k, v in cfg.items():
            setattr(config, k, v)
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
}


@contextlib.contextmanager
def reference_routes():
    """Count the routes the reference takes, under the port's route names.
    A route counts when it produced the result: a dense or hash join that
    found the build side unfit (None) and an unresolved hash groupby do
    not. `_join_rep` counts as join_rep_<method>, the method of its last
    join_local call (hash, or sort after a hash run that did not
    resolve)."""
    import importlib
    import bodo_tpu.relational as ref_rel
    counts = {name: 0 for name in _REF_ROUTES}
    counts.update(join_rep_hash=0, join_rep_sort=0)
    saved = []
    last_method = ["sort"]

    def join_local_spy(*a, _orig=ref_rel.join_local, **k):
        last_method[0] = k.get("method", a[8] if len(a) > 8 else "sort")
        return _orig(*a, **k)

    def join_rep_spy(*a, _orig=ref_rel._join_rep, **k):
        out = _orig(*a, **k)
        counts[f"join_rep_{last_method[0]}"] += 1
        return out

    for fname, spy in (("join_local", join_local_spy),
                       ("_join_rep", join_rep_spy)):
        saved.append((ref_rel, fname, getattr(ref_rel, fname)))
        setattr(ref_rel, fname, spy)
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


def port_routes_reset():
    from bodo_tpu_torch import relational as PR
    PR.reset_route_counts()
    return PR.route_counts


def export_reference(t) -> Dict[str, tuple]:
    """A reference Table's Column fields as numpy, for
    bodo_tpu_torch.table.from_reference_arrays."""
    t = t.gather() if t.distribution == "1D" else t
    return {n: (np.asarray(c.data),
                None if c.valid is None else np.asarray(c.valid),
                c.dtype.name, c.dictionary, c.vrange)
            for n, c in t.columns.items()}


def assert_same_table(port, ref, float_rtol: float = 0.0,
                      check_vrange: bool = False) -> None:
    """Column by column, the port's physical values against the
    reference's over the real rows: names, dtypes, capacity, dictionaries
    and validity exactly; data bit-identical, floats within `float_rtol`
    (NaN matching NaN)."""
    assert port.nrows == ref.nrows
    assert port.names == ref.names
    assert port.capacity == ref.capacity
    n = ref.nrows
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
            np.testing.assert_array_equal(pc.valid[:n].cpu().numpy(),
                                          np.asarray(rc.valid)[:n],
                                          err_msg=name)
        got = pc.data[:n].cpu().numpy()
        want = np.asarray(rc.data)[:n]
        if want.dtype.kind == "f" and float_rtol > 0:
            np.testing.assert_allclose(got, want, rtol=float_rtol, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
        if check_vrange:
            assert pc.vrange == rc.vrange, name
