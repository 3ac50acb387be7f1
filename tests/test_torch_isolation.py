"""The port stands alone: importing every module of bodo_tpu_torch pulls in
neither JAX nor the JAX package (nor pandas/pyarrow, which only its
readers and converters import when called); its entry points default to
CUDA and raise without it instead of running on the CPU; the CUDA kernel
wrapper never falls back to its plain version for a tensor that is not
on the CPU. One test runs every check (see tests/torch_parity.py on why
each test_torch_* file holds one test)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_parity import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import bodo_tpu_torch
mods = ["bodo_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    bodo_tpu_torch.__path__, "bodo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bodo_tpu", "pandas",
                                    "pyarrow"))
print("MODULES", len(mods))
print("FORBIDDEN", bad)
import torch
if not torch.cuda.is_available():
    from bodo_tpu_torch.workloads.taxi import pipeline
    from bodo_tpu_torch.table import Table
    import numpy as np
    for call in (lambda: pipeline(sys.argv[1], sys.argv[2]),
                 lambda: Table.from_numpy({"a": np.arange(3)})):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("ran without CUDA")
    print("NO_CUDA_RAISES")
"""


def _check_imports_no_jax_and_needs_cuda(tmp_path):
    pq, csv = tmp_path / "t.parquet", tmp_path / "w.csv"
    pq.write_bytes(b"")
    csv.write_text("DATE,PRCP\n2024-01-01,0.1\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _PROBE, str(pq), str(csv)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "FORBIDDEN []" in lines, res.stdout
    assert int(lines[0].split()[1]) >= 20  # every module was walked
    import torch
    if not torch.cuda.is_available():
        assert "NO_CUDA_RAISES" in lines, res.stdout


def _check_resolve_device_defaults_to_cuda():
    import torch
    from bodo_tpu_torch.config import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


def _check_lut_gather_never_falls_back_off_the_cpu():
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    before = dict(CK.launches)
    codes = torch.zeros(8, dtype=torch.int32, device="meta")
    lut = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        CK.lut_gather(codes, lut)
    with pytest.raises(ValueError, match="CUDA"):
        CK.lut_gather(torch.zeros(8, dtype=torch.int32), lut)
    assert CK.launches == before


def _check_kernel_build_is_lazy():
    """No kernel is built or loaded while the modules import: the build
    directory is keyed by source and flags, and nothing loaded it."""
    from bodo_tpu_torch.ops import cuda_kernels as CK
    assert CK._entry_fns == {} or all(
        CK.library_path(n).exists() for n in CK._entry_fns)
    path = CK.library_path("lut_gather")
    assert path.parent == REPO / "build"
    assert path.name.startswith("liblut_gather.") and path.suffix == ".so"


def test_port_stands_alone(torch_one_thread, tmp_path):
    _check_imports_no_jax_and_needs_cuda(tmp_path)
    _check_resolve_device_defaults_to_cuda()
    _check_lut_gather_never_falls_back_off_the_cpu()
    _check_kernel_build_is_lazy()
