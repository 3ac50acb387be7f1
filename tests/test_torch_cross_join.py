"""The cross join of the port (relational._cross_join, ops/join.cross_local)
against bodo_tpu on the same inputs: join_tables(..., how="cross") on the
four layouts (REP x REP, 1D x REP, REP x 1D, where the right side is
gathered, and 1D x 1D) on CPU meshes of 2 and 4 shards; empty left,
right and both sides; overlapping column names with suffixes; nulls in
both sides (int, float and string columns). Row order (pandas' order,
probe-major), per-shard counts, capacities, dictionaries, validity and
data bit-identical; the route (`join_cross`) equal to the reference's.

Then fault F6 (ROADMAP): a join without keys other than the cross join
raises ValueError in the port, where the reference fails inside its sort
join; pinned, not held to the reference. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test).
"""

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (assert_same_table,  # noqa: F401
                                port_routes_reset, reference,
                                reference_routes, to_port,
                                torch_one_thread)


def _frames(r, nl: int, nr: int):
    left = pd.DataFrame({
        "a": r.integers(0, 100, nl).astype(np.int64),
        "x": np.where(r.random(nl) < 0.2, np.nan, r.normal(size=nl)),
        "s": pd.array(np.where(r.random(nl) < 0.2, None,
                               r.choice(["p", "q", "r"], nl)),
                      dtype=object),
    })
    right = pd.DataFrame({
        "a": pd.array(np.where(r.random(nr) < 0.3, None,
                               r.integers(0, 9, nr)), dtype="Int64"),
        "m": r.normal(size=nr),
        "s": r.choice(["u", "v"], nr),
    })
    return left, right


def _layouts(tl, tr):
    return {"REPxREP": (tl, tr), "1DxREP": (tl.shard(), tr),
            "REPx1D": (tl, tr.shard()), "1Dx1D": (tl.shard(), tr.shard())}


def _check(ref_mesh, port_mesh, left, right, suffixes=("_x", "_y")):
    import bodo_tpu
    import bodo_tpu.relational as R
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.parallel.mesh import use_mesh

    with bodo_tpu.use_mesh(ref_mesh), use_mesh(port_mesh):
        base = (RefTable.from_pandas(left), RefTable.from_pandas(right))
        for name, (tl, tr) in _layouts(*base).items():
            with reference_routes() as ref_routes:
                ref = R.join_tables(tl, tr, [], [], "cross", suffixes)
            routes = port_routes_reset()
            port = PR.join_tables(to_port(tl), to_port(tr), [], [], "cross",
                                  suffixes)
            assert_same_table(port, ref)
            assert routes == ref_routes, name
            assert routes["join_cross"] == 1, name
            assert port.nrows == len(left) * len(right), name
            want = "1D" if name.startswith("1D") else "REP"
            assert port.distribution == want, name
    return port


def _check_f6(port_mesh):
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.parallel.mesh import use_mesh
    from bodo_tpu_torch.table import Table

    left = pd.DataFrame({"a": np.arange(5)})
    right = pd.DataFrame({"b": np.arange(3)})
    with use_mesh(port_mesh):
        tl = Table.from_pandas(left, device="cpu")
        tr = Table.from_pandas(right, device="cpu")
        for how in ("inner", "left", "outer", "right"):
            for pair in ((tl, tr), (tl.shard(), tr.shard())):
                with pytest.raises(ValueError, match="how='cross'"):
                    PR.join_tables(*pair, [], [], how)


def test_cross_join_matches_reference(reference):
    import jax
    import bodo_tpu
    from bodo_tpu_torch.parallel.mesh import make_mesh

    r = np.random.default_rng(3)
    for s in (2, 4):
        ref_mesh = bodo_tpu.make_mesh(jax.devices()[:s])
        port_mesh = make_mesh(s, device="cpu")
        left, right = _frames(r, 301, 7)
        out = _check(ref_mesh, port_mesh, left, right)
        # pandas' order and suffixes on the overlapping names
        want = left.merge(right, how="cross")
        got = out.to_pandas()
        assert list(got.columns) == ["a_x", "x", "s_x", "a_y", "m", "s_y"]
        np.testing.assert_array_equal(got["a_x"], want["a_x"])
        np.testing.assert_array_equal(got["m"], want["m"])
        # empty sides
        for nl, nr in ((0, 5), (40, 0), (0, 0)):
            _check(ref_mesh, port_mesh, *_frames(r, nl, nr))
        # other suffixes, a one-row right side, more shards than left rows
        _check(ref_mesh, port_mesh, *_frames(r, 3, 1), ("_l", "_r"))
    _check_f6(port_mesh)
