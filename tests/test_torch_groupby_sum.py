"""The f32 accumulate of the port against the JAX package:

  - `groupby_sum_plain` (the plain version of the groupby_sum CUDA
    kernel) and the port's `dense_accumulate` route against the Pallas
    `matmul_groupby_sum` and the reference's `dense_accumulate`, both run
    with interpret=True, on the same numpy inputs: N in {1, 513, 5000}
    rows, K in {1, 250, 4096} slots, C in {1, 4, 9} columns, masked rows
    and codes outside [0, K) (which add nothing: the reference's one-hot
    has no column for them, so its callers' pre-masked values are held
    to the same rows by zeroing them);
  - the port's gate `dense_accumulate_ok` against the reference's
    `dense_mxu_ok`, a pure function called directly, over capacities
    2^24 and 2^24 + 128, dtypes f16, f32, f64, int32 and int64 and ops
    sum, mean, count, size, min and var, one column and two.

Tolerance: counts (columns of ones) are exact. Sums are f32 in another
order (the TPU adds 512-row blocks on the MXU, the plain version row by
row), so each slot's sum is held against the float64 sum of its values
within 1e-5 * sum(|x|) over that slot.

The reference's kernel is reached only through an explicit
interpret=True, inside the `reference` fixture, never by setting
FORCE_INTERPRET (an interpret-mode trace would stay in the reference's
jit caches for later tests of the worker). One test runs every check
(see tests/torch_parity.py on why each test_torch_* file holds one
test)."""

import itertools

import numpy as np

from tests.torch_parity import reference, torch_one_thread  # noqa: F401

SUM_TOL = 1e-5
# (N, K, C)
CASES = tuple(itertools.product((1, 513, 5000), (1, 250, 4096), (1, 4, 9)))


def _inputs(r, n, k, c):
    """codes with some outside [0, K), c columns (every third one a ones
    column, a count) and their masks."""
    codes = r.integers(0, k, n).astype(np.int32)
    bad = r.random(n) < 0.05
    codes[bad] = np.where(r.random(int(bad.sum())) < 0.5, -1, k)
    cols = [np.ones(n, np.float32) if j % 3 == 0 else
            (r.normal(size=n) * 10.0 ** r.integers(-2, 3)).astype(np.float32)
            for j in range(c)]
    masks = [r.random(n) < 0.8 for _ in range(c)]
    return codes, cols, masks


def _oracle(codes, cols, masks, k):
    """float64 sums [K, C] and sums of |x| over the rows each slot adds."""
    inr = (codes >= 0) & (codes < k)
    s64 = np.zeros((k, len(cols)))
    a64 = np.zeros((k, len(cols)))
    for j, (v, m) in enumerate(zip(cols, masks)):
        sel = inr & m
        x = v[sel].astype(np.float64)
        s64[:, j] = np.bincount(codes[sel], weights=x, minlength=k)
        a64[:, j] = np.bincount(codes[sel], weights=np.abs(x), minlength=k)
    return s64, a64


def _hold(got, s64, a64, counts, label):
    got = np.asarray(got, np.float64)
    assert got.shape == s64.shape, (label, got.shape)
    err = np.abs(got - s64)
    assert np.all(err <= SUM_TOL * a64), (label, float(np.max(err)))
    np.testing.assert_array_equal(got[:, counts], s64[:, counts],
                                  err_msg=label)


def _check_kernel_function():
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    assert CK.MAX_MATMUL_SLOTS == PK.MAX_MATMUL_SLOTS
    r = np.random.default_rng(0)
    for n, k, c in CASES:
        codes, cols, masks = _inputs(r, n, k, c)
        s64, a64 = _oracle(codes, cols, masks, k)
        counts = [j for j in range(c) if j % 3 == 0]
        label = f"N={n} K={k} C={c}"
        tc = torch.from_numpy(codes)
        tcols = [torch.from_numpy(v) for v in cols]
        tmasks = [torch.from_numpy(m) for m in masks]
        plain = CK.groupby_sum_plain(tc, tcols, tmasks, k)
        assert plain.dtype == torch.float32
        _hold(plain.numpy(), s64, a64, counts, "plain " + label)
        # a ones column given as None is the same count
        ones = CK.groupby_sum_plain(
            tc, [None if j % 3 == 0 else v for j, v in enumerate(tcols)],
            tmasks, k)
        assert torch.equal(ones, plain), label
        port = CK.dense_accumulate(tc, tcols, tmasks, k)
        assert len(port) == c and all(p.shape == (k,) for p in port)
        _hold(torch.stack(port, 1).numpy(), s64, a64, counts,
              "dense_accumulate " + label)
        # the reference: its kernel takes pre-masked values and codes in
        # [0, K); rows whose code is outside add nothing
        inr = (codes >= 0) & (codes < k)
        vals = np.stack([np.where(m & inr, v, 0) for v, m in
                         zip(cols, masks)], 1).astype(np.float32)
        ref = PK.matmul_groupby_sum(jnp.asarray(np.where(inr, codes, 0)),
                                    jnp.asarray(vals), k, c,
                                    interpret=True)
        _hold(np.asarray(ref), s64, a64, counts, "reference " + label)
        ref_acc = PK.dense_accumulate(
            jnp.asarray(np.where(inr, codes, 0)),
            [jnp.asarray(v) for v in cols],
            [jnp.asarray(m & inr) for m in masks], k, interpret=True)
        _hold(np.stack([np.asarray(x) for x in ref_acc], 1), s64, a64,
              counts, "reference dense_accumulate " + label)
    # no rows: zeros
    z = CK.groupby_sum_plain(torch.zeros(0, dtype=torch.int32), [None],
                             [torch.zeros(0, dtype=torch.bool)], 5)
    assert z.shape == (5, 1) and not z.any()


def _check_gate():
    import torch
    from bodo_tpu.relational import dense_mxu_ok
    from bodo_tpu_torch.relational import dense_accumulate_ok
    dtypes = {np.float16: torch.float16, np.float32: torch.float32,
              np.float64: torch.float64, np.int32: torch.int32,
              np.int64: torch.int64}
    ops = ("sum", "mean", "count", "size", "min", "var")
    pairs = list(itertools.product(dtypes, ops))
    seen = set()
    for cap in (1 << 24, (1 << 24) + 128):
        for cols in [[p] for p in pairs] + list(zip(pairs, pairs[7:])):
            specs = tuple(op for _, op in cols)
            want = dense_mxu_ok(cap, [np.dtype(d) for d, _ in cols], specs)
            got = dense_accumulate_ok(cap, [dtypes[d] for d, _ in cols],
                                      specs)
            assert got == want, (cap, cols)
            seen.add(want)
    assert seen == {True, False}


def test_groupby_sum_against_reference(reference):
    _check_kernel_function()
    _check_gate()
