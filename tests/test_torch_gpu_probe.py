"""The `hash_probe` CUDA kernel against its plain version on the card, for
T in {16, 4096, 2^20}, 1 to 5 code columns, hit, near-miss, miss and
not-ok rows, and a max_rounds=1 walk that leaves rows unresolved.
Marked `cuda`: skips without a GPU. It imports nothing of the test
harness, so on the card's machine it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_probe.py
"""

import numpy as np
import pytest


@pytest.mark.cuda
def test_hash_probe_kernel_matches_plain_on_gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel)")
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.ops import hashtable as HT
    r = np.random.default_rng(0)
    dev = torch.device("cuda")
    for T in (16, 4096, 1 << 20):
        for n_codes in (1, 2, 4, 5):
            bcap = T // 2
            bcodes = torch.from_numpy(r.integers(
                -(1 << 63), (1 << 63) - 1, (n_codes, bcap), dtype=np.int64,
                endpoint=True)).to(dev)
            bok = torch.from_numpy(r.random(bcap) < 0.9).to(dev)
            _slot, owner, _r, _un = HT.claim_slots(tuple(bcodes), bok, T)
            n = 3 * bcap + 1
            pcodes = bcodes[:, torch.from_numpy(
                r.integers(0, bcap, n)).to(dev)].clone()
            pcodes[int(r.integers(0, n_codes)), ::3] ^= 1  # near misses
            pcodes[:, 1::3] = torch.from_numpy(r.integers(
                0, 1 << 62, (n_codes, len(range(1, n, 3))))).to(dev)
            ok = torch.from_numpy(r.random(n) < 0.85).to(dev)
            mask = T - 1
            h = HT.combine_hash(tuple(pcodes))
            step = (HT._fmix64(h ^ HT._GOLD) | 1) & mask
            h = h & mask
            for rounds in (64, 1):
                args = (bcodes, owner, pcodes.contiguous(), ok, h, step, T,
                        rounds)
                want_idx, want_un = CK.hash_probe_plain(*args)
                before = CK.launches["hash_probe"]
                idx, un = CK.hash_probe(*args)
                torch.cuda.synchronize()
                assert CK.launches["hash_probe"] == before + 1
                assert torch.equal(idx, want_idx), (T, n_codes, rounds)
                assert bool(un) == bool(want_un), (T, n_codes, rounds)
                if rounds == 1 and T > 16:
                    assert bool(un)
