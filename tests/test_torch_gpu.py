"""CUDA kernels of the port against their plain versions on the card.
Marked `cuda`: skips without a GPU. It imports nothing of the test
harness, so on the card's machine, where JAX and tests/conftest.py's
imports are absent, it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py
"""

import numpy as np
import pytest


@pytest.mark.cuda
def test_lut_gather_kernel_matches_plain_on_gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel)")
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(0)
    for k in (1, 182, 4096):
        for n in (1, 511, 513, 1 << 20):
            codes = torch.from_numpy(r.integers(0, k, n).astype(np.int32))
            lut = torch.from_numpy(r.integers(-1, 1 << 30, k)
                                   .astype(np.int32))
            want = CK.lut_gather_plain(codes.cuda(), lut.cuda())
            before = CK.launches["lut_gather"]
            got = CK.lut_gather(codes.cuda(), lut.cuda())
            torch.cuda.synchronize()
            assert CK.launches["lut_gather"] == before + 1
            assert torch.equal(got, want)
