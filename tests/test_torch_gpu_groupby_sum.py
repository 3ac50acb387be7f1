"""The `groupby_sum` CUDA kernel against the float64 sums on the card: N
in {1, 4099, 1,000,003} rows (tails of its 4-row loads), K in {1, 64,
4096} slots, C in {1, 4, 16} columns (every third a count), masked rows
and codes outside [0, K); codes, masks and values as views at odd element
offsets; columns that share masks or values, and a column equal to an
earlier one; two calls back to back.
Counts exact, sums within 1e-5 * sum(|x|) per slot: f32 atomics add in
another order on every call. Marked `cuda`: skips without a GPU. It
imports nothing of the test harness, so on the card's machine it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_groupby_sum.py
"""

import numpy as np
import pytest

SUM_TOL = 1e-5


@pytest.mark.cuda
def test_groupby_sum_kernel_within_f64_sums_on_gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel)")
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(0)
    dev = torch.device("cuda")

    def case(n, k, c):
        codes = r.integers(0, k, n).astype(np.int32)
        bad = r.random(n) < 0.03
        codes[bad] = np.where(r.random(int(bad.sum())) < 0.5, -1, k)
        cols = [None if j % 3 == 0 else
                (r.standard_normal(n) * 10.0 ** (j % 5 - 2)).astype(np.float32)
                for j in range(c)]
        masks = [r.random(n) < 0.8 for _ in range(c)]
        return codes, cols, masks

    def on_card(codes, cols, masks, lo=(0, 0, 0), n=None):
        n = len(codes) - lo[0] if n is None else n
        cd = torch.from_numpy(codes).to(dev)[lo[0]:lo[0] + n]
        cl = [None if v is None else
              torch.from_numpy(v).to(dev)[lo[1]:lo[1] + n] for v in cols]
        mk = [torch.from_numpy(m).to(dev)[lo[2]:lo[2] + n] for m in masks]
        return cd, cl, mk

    def hold(got, codes, cols, masks, k):
        got = got.cpu().double().numpy()
        for j, (v, m) in enumerate(zip(cols, masks)):
            live = m & (codes >= 0) & (codes < k)
            x = np.ones(len(codes)) if v is None else v.astype(np.float64)
            s64 = np.bincount(codes[live], x[live], minlength=k)
            a64 = np.bincount(codes[live], np.abs(x[live]), minlength=k)
            if v is None:
                assert np.array_equal(got[:, j], s64), (len(codes), k, j)
            else:
                assert np.all(np.abs(got[:, j] - s64) <= SUM_TOL * a64), \
                    (len(codes), k, j)

    for n in (1, 4099, 1_000_003):
        for k in (1, 64, 4096):
            for c in (1, 4, 16):
                codes, cols, masks = case(n, k, c)
                before = CK.launches["groupby_sum"]
                got = CK.groupby_sum(*on_card(codes, cols, masks), k)
                assert CK.launches["groupby_sum"] == before + 1
                hold(got, codes, cols, masks, k)
    n = 1_000_003
    for k, c in ((64, 4), (4096, 16)):
        codes, cols, masks = case(n + 3, k, c)
        got = CK.groupby_sum(*on_card(codes, cols, masks, (1, 2, 3), n), k)
        again = CK.groupby_sum(*on_card(codes, cols, masks, (1, 2, 3), n), k)
        view = (codes[1:n + 1], [None if v is None else v[2:n + 2]
                                 for v in cols], [m[3:n + 3] for m in masks])
        hold(got, *view, k)
        hold(again, *view, k)
        # column 1 counts what column 2 sums, column 3 repeats column 0,
        # column 4 sums column 2's values under column 0's mask
        z, m0, m1 = cols[1][:n], masks[0][:n], masks[1][:n]
        shared = (codes[:n], [None, None, z, None, z], [m0, m1, m1, m0, m0])
        cd, zd, m0d, m1d = (torch.from_numpy(a).to(dev)
                            for a in (codes[:n], z, m0, m1))
        got = CK.groupby_sum(cd, [None, None, zd, None, zd],
                             [m0d, m1d, m1d, m0d, m0d], k)
        hold(got, *shared, k)
