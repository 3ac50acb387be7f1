"""The two-phase sharded groupby and the sample sort of the port against
the JAX package on CPU meshes of 2 and 4 shards:

  - `groupby_sharded` with count, size, sum and mean, by the hash and the
    sort partial stage, and on keys that all hash to shard 0, so on 4
    shards the combine's send buckets overflow and are grown (the x4
    retry; on 2 shards the first buckets take a whole shard);
  - `sort_sharded` ascending and descending, with null and NaN keys,
    na_last True and False, two keys, and on one repeated key, so every
    row goes to the last shard and on 4 shards the send buckets overflow
    and grow.

Keys, counts, group counts per shard and the gathered row order are
bit-identical; float64 sums and means are held to rtol 1e-12 (the same
values, summed in another order). One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test)."""

import numpy as np
import pandas as pd

from tests.torch_parity import (both_configs, reference, to_port,
                                torch_one_thread)  # noqa: F401

F64_RTOL = 1e-12


def _meshes(s):
    import jax
    import bodo_tpu
    from bodo_tpu_torch.parallel.mesh import make_mesh
    return bodo_tpu.make_mesh(jax.devices()[:s]), make_mesh(s, device="cpu")


def _live(counts, per):
    return np.concatenate([np.arange(i * per, i * per + int(c))
                           for i, c in enumerate(counts)])


def _same_arrays(got, want, counts, per, rtol=0.0):
    live = _live(counts, per)
    for (gd, gv), (wd, wv) in zip(got, want):
        assert (gv is None) == (wv is None)
        if wv is not None:
            np.testing.assert_array_equal(gv.numpy()[live],
                                          np.asarray(wv)[live])
        g, w = gd.numpy()[live], np.asarray(wd)[live]
        if w.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def _keys_to_shard0(s, n):
    """n distinct int64 keys whose hash sends them to shard 0."""
    import torch
    from bodo_tpu_torch.ops.hashing import dest_shard, hash_columns
    cand = torch.arange(50 * n * s, dtype=torch.int64)
    hit = dest_shard(hash_columns([(cand, None)]), s) == 0
    return cand[hit][:n].numpy()


def _groupby_frame(r, n, keys):
    v = r.normal(size=n)
    v[r.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "k": r.choice(keys, n),
        "k2": r.integers(0, 3, n).astype(np.int32),
        "v": v,
        "i": pd.array(np.where(r.random(n) < 0.1, None,
                               r.integers(0, 9, n)).tolist(),
                      dtype="Int64"),
    })


def _check_groupby_sharded(s):
    import bodo_tpu
    from bodo_tpu.parallel import shuffle as RS
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.parallel import shuffle as SH

    ref_mesh, mesh = _meshes(s)
    r = np.random.default_rng(s)
    specs = ("count", "size", "sum", "mean", "sum", "mean")
    cases = [(_groupby_frame(r, 3000, np.arange(400)), 2, "hash"),
             (_groupby_frame(r, 3000, np.arange(400)), 2, "sort"),
             (_groupby_frame(r, 6000, _keys_to_shard0(s, 700)), 1, "hash")]
    for df, nk, method in cases:
        with bodo_tpu.use_mesh(ref_mesh):
            ref_t = RefTable.from_pandas(df).shard()
        t = to_port(ref_t)
        names = ["k", "k2"][:nk] + ["v", "v", "v", "v", "i", "i"]
        arrays = t.arrays(names)
        ref_arrays = tuple((ref_t.column(c).data, ref_t.column(c).valid)
                           for c in names)
        combines = [0]
        orig = SH._groupby_combine

        def counted(*a, **k):
            combines[0] += 1
            return orig(*a, **k)

        SH._groupby_combine = counted
        try:
            with both_configs(hash_groupby=method == "hash"), \
                    bodo_tpu.use_mesh(ref_mesh):
                (rk, rv), rng, _ = RS.groupby_sharded(
                    ref_arrays, ref_t.counts_device(), nk, specs)
                (pk, pv), ng, ovf, got_method = SH.groupby_sharded(
                    arrays, t.counts, nk, specs, mesh=mesh)
        finally:
            SH._groupby_combine = orig
        assert got_method == method and not ovf.any()
        np.testing.assert_array_equal(ng, np.asarray(rng).reshape(-1))
        per = pk[0][0].shape[0] // s
        assert per == np.asarray(rk[0][0]).shape[0] // s
        _same_arrays(pk, rk, ng, per)
        _same_arrays(pv, rv, ng, per, rtol=F64_RTOL)
        # keys all sent to shard 0 overflow the first send buckets on 4
        # shards (on 2 the first buckets already take a whole shard)
        assert combines[0] == (2 if nk == 1 and s == 4 else 1), combines
        if nk == 1:
            assert ng[0] == ng.sum() == df["k"].nunique()


def _sort_frame(r, n):
    f = r.normal(size=n).round(1) + 0.0
    f[r.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "a": pd.array(np.where(r.random(n) < 0.1, None,
                               r.integers(0, 50, n)).tolist(), dtype="Int64"),
        "f": f,
        "row": np.arange(n),
    })


def _check_sort_sharded(s):
    import bodo_tpu
    from bodo_tpu.ops import sort as RSort
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.ops import sort as PSort

    ref_mesh, mesh = _meshes(s)
    r = np.random.default_rng(10 + s)
    skewed = pd.DataFrame({"a": np.full(3000, 7), "f": r.normal(size=3000),
                           "row": np.arange(3000)})
    cases = [(_sort_frame(r, 3000), ["a", "f", "row"], 1, (True,), True),
             (_sort_frame(r, 3000), ["f", "a", "row"], 1, (False,), True),
             (_sort_frame(r, 3000), ["a", "f", "row"], 2, (True, False),
              False),
             (skewed, ["a", "f", "row"], 1, (True,), True)]
    for df, order, nk, asc, na_last in cases:
        with bodo_tpu.use_mesh(ref_mesh):
            ref_t = RefTable.from_pandas(df).shard()
        t = to_port(ref_t)
        ref_arrays = tuple((ref_t.column(c).data, ref_t.column(c).valid)
                           for c in order)
        bodies = [0]
        orig = PSort._sort_sharded_body

        def counted(*a, **k):
            bodies[0] += 1
            return orig(*a, **k)

        PSort._sort_sharded_body = counted
        try:
            with bodo_tpu.use_mesh(ref_mesh):
                rout, rcnt = RSort.sort_sharded(
                    ref_arrays, ref_t.counts_device(), nk, asc, na_last)
            out, cnt = PSort.sort_sharded(t.arrays(order), t.counts, nk,
                                          asc, na_last, mesh=mesh)
        finally:
            PSort._sort_sharded_body = orig
        np.testing.assert_array_equal(cnt, np.asarray(rcnt).reshape(-1))
        per = out[0][0].shape[0] // s
        assert per == np.asarray(rout[0][0]).shape[0] // s
        _same_arrays(out, rout, cnt, per)
        # one repeated key sends every row to the last shard: on 4 shards
        # the first buckets overflow and grow
        skew = df is skewed
        assert bodies[0] == (2 if skew and s == 4 else 1), bodies
        if skew:
            assert cnt[-1] == 3000


def test_sharded_groupby_and_sort_match_reference(reference):
    for s in (2, 4):
        _check_groupby_sharded(s)
        _check_sort_sharded(s)
