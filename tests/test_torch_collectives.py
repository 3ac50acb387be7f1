"""The port's mesh collectives and 1D tables against the JAX package on a
CPU mesh of the same size, S in {2, 4}: each collective against its
reference inside `C.smap`, the host scatter/gather helpers, and
Table.shard / Table.gather of empty, 1-row and 1000-row tables (per-shard
counts, capacities and the global layout bit-identical). Integers are
bit-identical; float64 sums over shards are held to rtol 1e-12 (the same
values added in another order).

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (assert_same_table, reference,
                                torch_one_thread)  # noqa: F401

SHARDS = (2, 4)
# float64 sums over shards, added in another order (integers are exact)
F64_RTOL = 1e-12


def _meshes(s):
    import jax
    import bodo_tpu
    from bodo_tpu_torch.parallel.mesh import make_mesh
    return bodo_tpu.make_mesh(jax.devices()[:s]), make_mesh(s, device="cpu")


def _check_collectives(s):
    import jax.numpy as jnp
    import torch
    from jax.sharding import PartitionSpec as P
    from bodo_tpu.config import config
    from bodo_tpu.parallel import collectives as RC
    from bodo_tpu_torch.parallel import collectives as C

    ref_mesh, _ = _meshes(s)
    ax = config.data_axis
    r = np.random.default_rng(s)
    k = 6
    for x in (r.integers(-1000, 1000, s * k).astype(np.int64),
              r.normal(size=s * k)):
        xt = torch.from_numpy(x)
        per_shard = xt.reshape(s, k)
        for name, port_fn in (("dist_sum", C.dist_sum),
                              ("dist_max", C.dist_max),
                              ("dist_min", C.dist_min)):
            ref_fn = RC.smap(getattr(RC, name), in_specs=P(ax),
                             out_specs=P(ax), mesh=ref_mesh)
            want = np.asarray(ref_fn(jnp.asarray(x))).reshape(s, k)
            got = port_fn(per_shard).numpy()
            for i in range(s):  # every shard sees the reduction
                np.testing.assert_allclose(got, want[i], rtol=F64_RTOL,
                                           atol=0, err_msg=name)
        ref_fn = RC.smap(RC.dist_exscan_sum, in_specs=P(ax),
                         out_specs=P(ax), mesh=ref_mesh)
        np.testing.assert_allclose(
            C.dist_exscan_sum(per_shard).numpy().reshape(-1),
            np.asarray(ref_fn(jnp.asarray(x))), rtol=F64_RTOL, atol=0)
        ref_fn = RC.smap(RC.all_gather_rows, in_specs=P(ax),
                         out_specs=P(ax), mesh=ref_mesh)
        np.testing.assert_array_equal(C.all_gather_rows(xt, s).numpy(),
                                      np.asarray(ref_fn(jnp.asarray(x))))
    # all_to_all: each shard sends S blocks of C rows
    c = 3
    x = r.integers(0, 1 << 40, s * s * c).astype(np.int64)
    ref_fn = RC.smap(RC.all_to_all_rows, in_specs=P(ax), out_specs=P(ax),
                     mesh=ref_mesh)
    np.testing.assert_array_equal(
        C.all_to_all_rows(torch.from_numpy(x), s).numpy(),
        np.asarray(ref_fn(jnp.asarray(x))))


def _check_host_scatter_gather(s):
    import bodo_tpu
    from bodo_tpu.parallel import collectives as RC
    from bodo_tpu_torch.parallel import collectives as C

    ref_mesh, mesh = _meshes(s)
    r = np.random.default_rng(7)
    for n, cap in ((0, None), (1, None), (1000, None), (1000, 128)):
        arr = r.integers(0, 100, n).astype(np.int64)
        with bodo_tpu.use_mesh(ref_mesh):
            want, want_counts = RC.shard_host_array(arr, cap)
            want_back = RC.gather_host_rows(want, want_counts)
        got, counts = C.shard_host_array(arr, cap, mesh=mesh)
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(C.gather_host_rows(got, counts),
                                      want_back)
        np.testing.assert_array_equal(want_back, arr)


def _frame(n, seed):
    r = np.random.default_rng(seed)
    df = pd.DataFrame({
        "i": r.integers(-50, 50, n).astype(np.int64),
        "f": r.normal(size=n),
        "s": r.choice(["x", "yy", "zzz"], n),
        "n": pd.array(r.integers(0, 5, n), dtype="Int64"),
    })
    if n:
        df.loc[r.random(n) < 0.2, "n"] = pd.NA
    return df


def _check_shard_and_gather(s):
    import bodo_tpu
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.table import Table

    ref_mesh, mesh = _meshes(s)
    for n in (0, 1, 1000):
        df = _frame(n, n)
        with bodo_tpu.use_mesh(ref_mesh):
            ref = RefTable.from_pandas(df).shard()
            ref_back = ref.gather()
        port = Table.from_pandas(df, device="cpu").shard(mesh)
        assert port.num_shards == s
        assert port.shard_capacity == ref.shard_capacity
        assert_same_table(port, ref, check_vrange=True)
        # the padding past each shard's rows is zero, as in the reference
        for name in ref.names:
            np.testing.assert_array_equal(
                port.column(name).data.numpy(),
                np.asarray(ref.column(name).data), err_msg=name)
        np.testing.assert_array_equal(port.counts_device().numpy(),
                                      ref.counts)
        back = port.gather()
        assert_same_table(back, ref_back)
        pd.testing.assert_frame_equal(port.to_pandas(), ref.to_pandas())
        assert back.shard(mesh).counts.tolist() == port.counts.tolist()


def _check_mesh_rules():
    import torch
    from bodo_tpu_torch.parallel import mesh as M
    from bodo_tpu_torch.table import Table
    with pytest.raises(ValueError, match="at least one shard"):
        M.make_mesh(0, device="cpu")
    m = M.make_mesh(4, device="cpu")
    assert (m.n_shards, m.device) == (4, torch.device("cpu"))
    with M.use_mesh(m):
        assert M.get_mesh() is m and M.num_shards() == 4
    t = Table.from_numpy({"a": np.arange(3)}, device="cpu")
    with pytest.raises(ValueError, match="cannot be sharded"):
        t.shard(M.Mesh(2, torch.device("meta")))


def test_collectives_and_1d_tables_match_reference(reference):
    for s in SHARDS:
        _check_collectives(s)
        _check_host_scatter_gather(s)
        _check_shard_and_gather(s)
    _check_mesh_rules()
