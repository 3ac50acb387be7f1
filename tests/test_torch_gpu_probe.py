"""The `hash_probe` CUDA kernel against its plain version on the card, in
each of its forms (slot rows in shared memory, slot rows in device
memory, the column walk) and across the boundaries between them: T in
{16, 512, 1024, 2048, 4096, 2^20} (the shared form holds T * row bytes
<= 32 KiB) with 1 to 8 code columns (16-, 32- and 64-byte slot rows,
and codes past the seventh), and T = 2^24 with 2 and 3 code columns
just below and at N = T/2 (where the rows form starts); hit, near-miss,
miss and not-ok rows, duplicate build keys sharing a slot, code columns
as rows of a contiguous tensor, as rows of a wider one at an odd offset
and as strided columns of a row-major one, max_rounds 0 and 1
(unresolved rows), and two calls back to back on different tables of
one T.
Marked `cuda`: skips without a GPU. It imports nothing of the test
harness, so on the card's machine it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_probe.py
"""

import numpy as np
import pytest


def _columns(codes, layout):
    """The rows of `codes` [k, m] as 1-D columns laid out three ways."""
    import torch
    k, m = codes.shape
    if layout == 0:
        return tuple(codes.contiguous())
    if layout == 1:
        wide = torch.zeros(k, m + 1, dtype=codes.dtype, device=codes.device)
        wide[:, 1:] = codes
        return tuple(wide[:, 1:])
    rows = torch.zeros(m, k + 1, dtype=codes.dtype, device=codes.device)
    rows[:, :k] = codes.T
    return tuple(rows[:, j] for j in range(k))


def _case(r, dev, T, n_codes, n, layout):
    import torch
    from bodo_tpu_torch.ops import hashtable as HT
    bcap = T // 2
    bcodes = torch.from_numpy(r.integers(
        -(1 << 63), (1 << 63) - 1, (n_codes, bcap), dtype=np.int64,
        endpoint=True)).to(dev)
    bcodes[0] = torch.from_numpy(r.integers(0, 2, bcap)).to(dev)
    bcodes[:, -3:] = bcodes[:, :3]  # duplicate keys share a slot
    bok = torch.from_numpy(r.random(bcap) < 0.9).to(dev)
    _slot, owner, _r, _un = HT.claim_slots(tuple(bcodes), bok, T)
    pcodes = bcodes[:, torch.from_numpy(
        r.integers(0, bcap, n)).to(dev)].clone()
    pcodes[int(r.integers(0, n_codes)), ::3] ^= 1  # near misses
    pcodes[:, 1::3] = torch.from_numpy(r.integers(
        0, 1 << 62, (n_codes, len(range(1, n, 3))))).to(dev)
    ok = torch.from_numpy(r.random(n) < 0.85).to(dev)
    mask = T - 1
    h = HT.combine_hash(tuple(pcodes))
    step = (HT._fmix64(h ^ HT._GOLD) | 1) & mask
    return (_columns(bcodes, layout), owner,
            _columns(pcodes, (layout + 1) % 3), ok, h & mask, step)


@pytest.mark.cuda
def test_hash_probe_kernel_matches_plain_on_gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel)")
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(0)
    dev = torch.device("cuda")
    forms = set()
    case = 0
    cases = [(T, n_codes, (1, 513, 3 * (T // 2) + 1))
             for T in (16, 512, 1024, 2048, 4096, 1 << 20)
             for n_codes in (1, 2, 3, 4, 7, 8)]
    cases += [(1 << 24, n_codes, ((1 << 23) - 1, 1 << 23))
              for n_codes in (2, 3)]
    for T, n_codes, sizes in cases:
        for n in sizes:
            args = _case(r, dev, T, n_codes, n, case % 3)
            case += 1
            forms.add(CK.hash_probe_form(n, T, n_codes))
            for rounds in (64, 1, 0):
                want_idx, want_un = CK.hash_probe_plain(*args, T, rounds)
                before = CK.launches["hash_probe"]
                idx, un = CK.hash_probe(*args, T, rounds)
                torch.cuda.synchronize()
                assert CK.launches["hash_probe"] == before + 1
                what = (T, n_codes, n, rounds)
                assert torch.equal(idx, want_idx), what
                assert bool(un) == bool(want_un), what
                if rounds == 0:
                    assert bool(un) == bool(args[3].any()), what
        # two tables of one T back to back, no sync between the calls
        calls = [_case(r, dev, T, n_codes, sizes[-1], 0) for _ in range(2)]
        got = [CK.hash_probe(*c, T, 64) for c in calls]
        for c, (idx, un) in zip(calls, got):
            want_idx, want_un = CK.hash_probe_plain(*c, T, 64)
            assert torch.equal(idx, want_idx), (T, n_codes)
            assert bool(un) == bool(want_un), (T, n_codes)
    assert forms == set(CK.HASH_PROBE_FORMS)
