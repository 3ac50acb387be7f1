"""The shuffle's partition steps on the port against the JAX package:

  - `partition_rank_plain` (the plain version of the partition_rank CUDA
    kernel) against the Pallas `_partition_rank_kernel` run with
    interpret=True and against the reference's sort route (the stable
    sort by bucket of bucket_rows), K in {1, 4, 130};
  - `range_partition_plain` against the Pallas `_range_partition_kernel`
    (interpret=True) and jnp.searchsorted over uint64, with the traps of
    unsigned order: keys with the top bit set, the padding key
    0xFFFFFFFFFFFFFFFF, splitters equal to keys, duplicated splitters,
    1 and 4095 splitters, and an all-padding shard's splitters; and its
    sequence form (S shards, one splitter row each, S in {1, 2, 4})
    against the per-shard plain calls concatenated and the Pallas kernel
    run on each shard;
  - `bucket_rows` and `shuffle_rows` against the reference's inside
    `C.smap` on CPU meshes of 2 and 4 shards, with a bucket capacity
    small enough to overflow.

Everything is integer and compared bit for bit. One test runs every
check (see tests/torch_parity.py on why each test_torch_* file holds one
test)."""

import numpy as np

from tests.torch_parity import reference, torch_one_thread  # noqa: F401

PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


def _ref_sort_route(dest, ok, k):
    """The reference's bucket_rows sort route (bodo_tpu/parallel/shuffle.py
    :73-79): in-bucket position after a stable sort by bucket."""
    d = np.where(ok, dest, k)
    perm = np.argsort(d, kind="stable")
    ds = d[perm]
    pos = np.arange(len(d))
    is_new = np.r_[True, ds[1:] != ds[:-1]] if len(d) else ds.astype(bool)
    start = np.maximum.accumulate(np.where(is_new, pos, 0))
    rank = np.empty(len(d), np.int64)
    rank[perm] = pos - start
    return (np.where(ok, rank, -1),
            np.bincount(d[ok], minlength=k)[:k])


def _check_partition_rank():
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(0)
    for n, k in ((1, 1), (1000, 1), (1000, 4), (3000, 4), (2500, 130)):
        dest = r.integers(0, k, n).astype(np.int32)
        ok = r.random(n) < 0.8
        rank, counts = CK.partition_rank_plain(torch.from_numpy(dest),
                                               torch.from_numpy(ok), k)
        assert rank.dtype == torch.int32 and counts.dtype == torch.int32
        want_rank, want_counts = PK._partition_rank_kernel(
            jnp.asarray(dest), jnp.asarray(ok), k, interpret=True)
        np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(want_counts))
        sort_rank, sort_counts = _ref_sort_route(dest, ok, k)
        np.testing.assert_array_equal(rank.numpy(), sort_rank)
        np.testing.assert_array_equal(counts.numpy(), sort_counts)
    # no rows; rows outside [0, K) take no part
    rank, counts = CK.partition_rank_plain(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.bool),
        3)
    assert rank.numel() == 0 and counts.tolist() == [0, 0, 0]
    rank, counts = CK.partition_rank_plain(
        torch.tensor([0, 3, -1, 0], dtype=torch.int32),
        torch.ones(4, dtype=torch.bool), 3)
    assert rank.tolist() == [0, -1, -1, 1] and counts.tolist() == [2, 0, 0]


def _u64_cases(r):
    """(keys, splitters) pairs as uint64, with the traps of the docstring."""
    top = np.uint64(1 << 63)
    keys = r.integers(0, 1 << 63, 1000, dtype=np.uint64)
    keys[::7] |= top                   # top bit set
    keys[::11] = PAD                   # padding rows
    keys[5::13] = keys[3::13][:len(keys[5::13])]
    cases = []
    for n_spl in (1, 3, 4095):
        spl = np.sort(r.choice(keys, n_spl))  # equal to keys
        cases.append((keys, spl))
    spl = np.sort(np.r_[keys[:2], keys[:2], keys[7], top, top])
    cases.append((keys, spl))          # duplicated splitters
    cases.append((keys, np.full(3, PAD)))  # all-padding shard: nvalid = 0
    cases.append((np.array([0, 1, top - np.uint64(1), top, PAD],
                           np.uint64),
                  np.array([1, top - np.uint64(1), top], np.uint64)))
    return cases


def _check_range_partition():
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(1)
    for keys, spl in _u64_cases(r):
        got = CK.range_partition_plain(torch.from_numpy(keys.view(np.int64)),
                                       torch.from_numpy(spl.view(np.int64)))
        assert got.dtype == torch.int32
        want = PK.range_partition(jnp.asarray(keys), jnp.asarray(spl),
                                  interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.searchsorted(
                jnp.asarray(spl), jnp.asarray(keys), side="right")))
    empty = CK.range_partition_plain(torch.tensor([0, -1]),
                                     torch.zeros(0, dtype=torch.int64))
    assert empty.tolist() == [0, 0]
    # the sequence form: S shards of one length, a row of splitters each
    (keys, _), = _u64_cases(r)[:1]
    n, n_spl = 250, 3
    for s in (1, 2, 4):
        shards = [keys[i * n:(i + 1) * n] for i in range(s)]
        rows = np.stack([np.sort(r.choice(keys, n_spl)) for _ in range(s)])
        if s > 1:
            rows[-1] = PAD                 # an all-padding shard's row
        tshards = [torch.from_numpy(k.view(np.int64)) for k in shards]
        trows = torch.from_numpy(rows.view(np.int64))
        got = CK.range_partition_plain(tshards, trows)
        assert got.dtype == torch.int32 and got.shape == (s * n,)
        per_shard = torch.cat([CK.range_partition_plain(k, row)
                               for k, row in zip(tshards, trows)])
        assert torch.equal(got, per_shard)
        assert torch.equal(CK.range_partition(tshards, trows), got)
        want = np.concatenate([np.asarray(PK.range_partition(
            jnp.asarray(k), jnp.asarray(row), interpret=True))
            for k, row in zip(shards, rows)])
        np.testing.assert_array_equal(got.numpy(), want)


def _shard_inputs(r, s, cap):
    """Per-shard destinations, counts and three columns (int64, float64,
    bool), the layout the reference's shuffle takes."""
    dest = r.integers(0, s, s * cap).astype(np.int32)
    counts = r.integers(0, cap + 1, s).astype(np.int64)
    counts[0] = cap
    cols = [r.integers(-(1 << 62), 1 << 62, s * cap).astype(np.int64),
            r.normal(size=s * cap), r.random(s * cap) < 0.5]
    return dest, counts, cols


def _check_bucket_and_shuffle(s):
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import PartitionSpec as P
    from bodo_tpu.config import config
    from bodo_tpu.parallel import collectives as RC
    from bodo_tpu.parallel import shuffle as RS
    from bodo_tpu_torch.parallel import shuffle as SH

    ax = config.data_axis
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:s]), (ax,))
    r = np.random.default_rng(s)
    cap = 256
    dest, counts, cols = _shard_inputs(r, s, cap)
    tdest = torch.from_numpy(dest)
    tcols = [torch.from_numpy(c) for c in cols]
    for bucket_cap in (cap, 128, 64):  # 64: some buckets overflow
        def body(d, arrs, cnt, bc=bucket_cap):
            packed, send, ovf = RS.bucket_rows(d, arrs, cnt[0], s, bc)
            return packed, send, ovf[None]
        ref = jax.jit(RC.smap(body, in_specs=(P(ax), P(ax), P(ax)),
                              out_specs=(P(ax), P(ax), P(ax)), mesh=mesh))
        r_packed, r_send, r_ovf = ref(jnp.asarray(dest),
                                      [jnp.asarray(c) for c in cols],
                                      jnp.asarray(counts))
        for i in range(s):
            sl = slice(i * cap, (i + 1) * cap)
            packed, send, ovf = SH.bucket_rows(
                tdest[sl], [c[sl] for c in tcols], int(counts[i]), s,
                bucket_cap)
            out = slice(i * s * bucket_cap, (i + 1) * s * bucket_cap)
            for got, want in zip(packed, r_packed):
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(want)[out])
            np.testing.assert_array_equal(
                send.numpy(), np.asarray(r_send)[i * s:(i + 1) * s])
            assert bool(ovf) == bool(np.asarray(r_ovf)[i])

        def sbody(d, arrs, cnt, bc=bucket_cap):
            out, c, ovf = RS.shuffle_rows(d, arrs, cnt[0], s, bc, ax)
            return out, c[None], ovf[None]
        ref = jax.jit(RC.smap(sbody, in_specs=(P(ax), P(ax), P(ax)),
                              out_specs=(P(ax), P(ax), P(ax)), mesh=mesh))
        r_out, r_cnt, r_ovf = ref(jnp.asarray(dest),
                                  [jnp.asarray(c) for c in cols],
                                  jnp.asarray(counts))
        out, cnt, ovf = SH.shuffle_rows(tdest, tcols, counts, s, bucket_cap)
        np.testing.assert_array_equal(cnt, np.asarray(r_cnt))
        np.testing.assert_array_equal(ovf, np.asarray(r_ovf))
        for got, want in zip(out, r_out):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if bucket_cap in (cap, 64):
            assert ovf.any() == (bucket_cap == 64)


def test_partition_steps_match_reference(reference):
    _check_partition_rank()
    _check_range_partition()
    for s in (2, 4):
        _check_bucket_and_shuffle(s)
