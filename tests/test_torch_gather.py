"""The LUT gather of the dense join probe: the CPU path of the port's
`lut_gather` (its plain version) against the TPU kernel it replaces,
bodo_tpu's `matmul_gather`, run through the Pallas interpreter, for
K in {1, 182, 4096} slots and ragged N. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import numpy as np

from tests.torch_parity import reference, torch_one_thread  # noqa: F401


def test_lut_gather_plain_matches_matmul_gather(reference):
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import pallas_kernels as PK
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    for k in (1, 182, 4096):
        for n in (1, 511, 513):
            r = np.random.default_rng(k * 1000 + n)
            codes = r.integers(0, k, n).astype(np.int32)
            # row indices and the -1 empty marker, as the join's LUT holds
            lut = r.integers(-1, 1 << 20, k).astype(np.int32)
            want = np.asarray(PK.matmul_gather(
                jnp.asarray(codes), jnp.asarray(lut), interpret=True))
            got = CK.lut_gather(torch.from_numpy(codes),
                                torch.from_numpy(lut))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"K={k} N={n}")
            np.testing.assert_array_equal(got.numpy(), lut[codes])
    assert CK.launches == before  # the plain version launches nothing
