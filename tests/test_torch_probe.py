"""The probe walk of the hash join: the port's `hash_probe` on the CPU
(its plain version) against the TPU kernel it replaces, bodo_tpu's
`pallas_kernels.hash_probe` run through the Pallas interpreter,
bit-identical for T in {16, 1024, 4096} and 2 or 4 code columns, with
hits, near misses (one code differs), misses, rows that are not ok, and
a max_rounds=1 walk that leaves rows unresolved; and the port's
`probe_slots` against the reference's at T = 2^14 (its XLA loop), h and
step derived by each package. The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_gpu_probe.py, chip_smoke.py).

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import numpy as np

from tests.torch_parity import reference, torch_one_thread  # noqa: F401

_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _probe_inputs(r, T, n_codes, n_probe):
    """Build codes claimed into a T-slot table by the reference, and probe
    rows that hit, nearly hit (one code differs) or miss, some not ok."""
    import jax.numpy as jnp
    from bodo_tpu.ops import hashtable as RHT
    bcap = T // 2
    bcodes = r.integers(0, 1 << 63, (n_codes, bcap), dtype=np.uint64)
    bcodes[0] = r.integers(0, 2, bcap)  # a null-flag column, as joins have
    bcodes[:, bcap - 3:] = bcodes[:, :3]  # duplicate keys share one slot
    bok = r.random(bcap) < 0.9
    _slot, owner, _r, _un = RHT.claim_slots(
        tuple(jnp.asarray(c) for c in bcodes), jnp.asarray(bok), T)
    rows = r.integers(0, bcap, n_probe)
    pcodes = bcodes[:, rows].copy()
    kind = r.integers(0, 3, n_probe)
    col = r.integers(0, n_codes, n_probe)
    near = kind == 1
    pcodes[col[near], np.flatnonzero(near)] ^= np.uint64(1)
    far = kind == 2
    pcodes[:, far] = r.integers(0, 1 << 63, (n_codes, int(far.sum())),
                                dtype=np.uint64)
    ok = r.random(n_probe) < 0.85
    h = RHT.combine_hash(tuple(jnp.asarray(c) for c in pcodes))
    mask = np.uint64(T - 1)
    step = np.asarray((RHT._fmix64(h ^ _GOLD) | np.uint64(1)) & mask)
    h = np.asarray(h & mask)
    return bcodes, np.array(owner), pcodes, ok, h, step


def _check_hash_probe_matches_pallas(T, n_codes, max_rounds, seed,
                                     want_unresolved=None):
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(seed)
    bcodes, owner, pcodes, ok, h, step = _probe_inputs(r, T, n_codes, 500)
    want_idx, want_un = PK.hash_probe(
        tuple(jnp.asarray(c) for c in bcodes), jnp.asarray(owner),
        tuple(jnp.asarray(c) for c in pcodes), jnp.asarray(ok),
        jnp.asarray(h), jnp.asarray(step), T, max_rounds, interpret=True)

    def t64(a):
        return torch.from_numpy(np.array(a).view(np.int64))

    idx, un = CK.hash_probe(t64(bcodes), torch.from_numpy(owner),
                            t64(pcodes), torch.from_numpy(ok), t64(h),
                            t64(step), T, max_rounds)
    assert idx.dtype == torch.int32 and un.dim() == 0
    msg = f"T={T} n_codes={n_codes} max_rounds={max_rounds}"
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx),
                                  err_msg=msg)
    assert bool(un) == bool(want_un), msg
    hits = idx.numpy() >= 0
    assert hits.any() and (~hits & ok).any(), msg  # hits and misses
    assert (idx.numpy()[~ok] == -1).all(), msg
    if want_unresolved is not None:
        assert bool(un) == want_unresolved, msg


def _check_probe_slots_matches_reference():
    """T = 2^14 is above the Pallas kernel's 4096-slot gate, so the
    reference runs its XLA while loop."""
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import hashtable as RHT
    from bodo_tpu_torch.ops import hashtable as HT
    T = 1 << 14
    r = np.random.default_rng(7)
    bcodes, owner, pcodes, ok, _h, _s = _probe_inputs(r, T, 2, 5000)
    want_idx, want_un = RHT.probe_slots(
        tuple(jnp.asarray(c) for c in bcodes), jnp.asarray(owner),
        tuple(jnp.asarray(c) for c in pcodes), jnp.asarray(ok), T)
    idx, un = HT.probe_slots(
        tuple(torch.from_numpy(c.view(np.int64)) for c in bcodes),
        torch.from_numpy(owner),
        tuple(torch.from_numpy(c.view(np.int64)) for c in pcodes),
        torch.from_numpy(ok), T)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert bool(un) == bool(want_un) is False


def test_hash_probe_matches_reference(reference):
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    for T in (16, 1024, 4096):
        for n_codes in (2, 4):
            _check_hash_probe_matches_pallas(T, n_codes, 64, T + n_codes,
                                             want_unresolved=False)
    _check_hash_probe_matches_pallas(1024, 2, 1, 3, want_unresolved=True)
    _check_probe_slots_matches_reference()
    assert CK.launches == before  # the plain version launches nothing
