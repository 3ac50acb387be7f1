"""The `partition_rank` and `range_partition` CUDA kernels against their
plain versions on the card, bit for bit: partition_rank for N in {1, 31,
1000, 4099, 5,000,000, 5,000,067} rows and K in {1, 4, 32, 33, 4096}
buckets with rows not ok and buckets outside [0, K), views at odd element
offsets, no row ok, every row in one bucket and two calls back to back
(they share the kernel's look-back state); range_partition in its
one-tensor form at N = 5,000,000 for 1, 3 and 4095 splitters with keys
whose top bit is set, the padding key, splitters equal to keys and
duplicated, and an all-padding shard's splitters; and in its sequence
form for S in {1, 4, RANGE_MAX_SHARDS + 1} shards, n_spl in {1, 3, the
small form's bound and one more, 4095, 4096} and N in {1, 3, 4, 5,
885,504, 5,000,000} keys a shard, the shards contiguous and as views
off 16-byte alignment, and two calls back to back. Marked `cuda`: skips
without a GPU. It imports nothing of the test harness, so on the card's
machine it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_partition.py
"""

import numpy as np
import pytest

PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.mark.cuda
def test_partition_kernels_match_plain_on_gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel)")
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(0)
    dev = torch.device("cuda")

    def case(n, k, live=0.9, pad=0):
        dest = torch.from_numpy(r.integers(-1, k + 1, n + pad)
                                .astype(np.int32))
        return dest, torch.from_numpy(r.random(n + pad) < live)

    def launch(dest, ok, k):
        before = CK.launches["partition_rank"]
        got = CK.partition_rank(dest.to(dev), ok.to(dev), k)
        assert CK.launches["partition_rank"] == before + 1
        return got

    def hold(got, dest, ok, k):
        want = CK.partition_rank_plain(dest, ok, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0]), (dest.shape[0], k)
        assert torch.equal(got[1].cpu(), want[1]), (dest.shape[0], k)

    ks = (1, 4, 32, 33, 4096)
    for n in (1, 31, 1000, 4099, 5_000_000, 5_000_067):
        for k in ks:
            dest, ok = case(n, k)
            hold(launch(dest, ok, k), dest, ok, k)
    n = 5_000_067
    for k in (4, 33):
        dest, ok = case(n, k, pad=3)
        d, o = dest.to(dev)[1:n + 1], ok.to(dev)[3:n + 3]  # off alignment
        hold(CK.partition_rank(d, o, k), d.cpu(), o.cpu(), k)
        dest, ok = case(n, k, live=0.0)
        hold(launch(dest, ok, k), dest, ok, k)
    for k in ks:
        dest = torch.full((n,), k - 1, dtype=torch.int32)
        ok = torch.ones(n, dtype=torch.bool)
        hold(launch(dest, ok, k), dest, ok, k)
    for k in (4, 33, 4096):
        a, b = case(5_000_000, k), case(5_000_000 - 4099, k, live=0.5)
        got_a, got_b = launch(*a, k), launch(*b, k)  # no sync between
        hold(got_a, *a, k)
        hold(got_b, *b, k)
    n = 5_000_000
    top = np.uint64(1 << 63)
    keys = r.integers(0, 1 << 63, n, dtype=np.uint64)
    keys[::7] |= top
    keys[::11] = PAD
    for spl in [np.sort(r.choice(keys, m)) for m in (1, 3, 4095)] + [
            np.sort(np.r_[keys[:2], keys[:2], top, top]), np.full(3, PAD)]:
        pk = torch.from_numpy(keys.view(np.int64))
        sp = torch.from_numpy(spl.view(np.int64))
        want = CK.range_partition_plain(pk, sp)
        got = CK.range_partition(pk.to(dev), sp.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), len(spl)
    _check_range_partition_shards(torch, CK, dev)


def _check_range_partition_shards(torch, CK, dev):
    """The sequence form on the card against its plain version there."""
    g = torch.Generator(device=dev).manual_seed(1)
    small = max(m for m in range(CK.RANGE_MAX_SPLITTERS + 1)
                if CK.range_partition_form(m) == "small")
    assert CK.range_partition_form(small + 1) == "large"

    def keys(size):
        pool = torch.randint(-(1 << 63), (1 << 63) - 1, (size,), generator=g,
                             device=dev, dtype=torch.int64)
        pool[::11] = -1  # the padding key; half the rest have the top bit
        return pool

    def rows(shards, n_spl):
        out = []
        for j, k in enumerate(shards):
            pick = torch.randint(0, k.shape[0], (n_spl,), generator=g,
                                 device=dev)
            row = k[pick]  # equal to keys, duplicated when n_spl > N
            if j == 1:
                row = torch.full_like(row, -1)  # an all-padding shard
            out.append(CK._SIGN64 ^ torch.sort(row ^ CK._SIGN64).values)
        return torch.stack(out)

    def launch(shards, spl):
        before = CK.launches["range_partition"]
        got = CK.range_partition(shards, spl)
        assert CK.launches["range_partition"] == before + -(
            -len(shards) // CK.RANGE_MAX_SHARDS)
        return got

    def hold(got, shards, spl, label):
        want = CK.range_partition_plain(shards, spl)
        assert got.dtype == torch.int32 and got.shape == want.shape, label
        assert bool(torch.equal(got, want)), label

    for s in (1, 4, CK.RANGE_MAX_SHARDS + 1):
        for n in (1, 3, 4, 5, 885_504, 5_000_000):
            pool = keys(s * (n + 1) + 1)
            layouts = {"contiguous": [pool[j * n:(j + 1) * n]
                                      for j in range(s)],
                       "off alignment": [pool[1 + j * (n + 1):
                                              1 + j * (n + 1) + n]
                                         for j in range(s)]}
            for n_spl in (1, 3, small, small + 1, 4095, 4096):
                for layout, shards in layouts.items():
                    spl = rows(shards, n_spl)
                    hold(launch(shards, spl), shards, spl,
                         (s, n, n_spl, layout))
            del pool, layouts
    a, b = keys(4 * 885_504), keys(4 * 885_504 + 5)
    sa = [a[j * 885_504:(j + 1) * 885_504] for j in range(4)]
    sb = [b[5 + j * 885_504:5 + (j + 1) * 885_504] for j in range(4)]
    spa, spb = rows(sa, 3), rows(sb, 4095)
    got_a, got_b = launch(sa, spa), launch(sb, spb)  # no sync between
    hold(got_a, sa, spa, "back to back, first")
    hold(got_b, sb, spb, "back to back, second")
