"""Hand-written CUDA kernels of the port, their builds and their wrappers.

Counterpart of bodo_tpu/ops/pallas_kernels.py. Each kernel is a CUDA C++
source under bodo_tpu_torch/csrc/ with a plain C entry point, compiled by
`nvcc` for sm_90a into the checkout's build/ directory at first use and
bound with ctypes. Nothing here compiles or loads while the module is
imported.

Every kernel has a plain PyTorch version in this module with the same
result. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises — there is no fallback. Each
launch adds one to `launches[<kernel>]`, so a run can show which kernels
its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# kernel name -> CUDA source under csrc/
SOURCES = {"lut_gather": "lut_gather.cu"}
# kernel name -> (C entry point, ctypes argument types); pointers and the
# stream are c_void_p so ctypes passes them at full width
_ENTRIES = {
    "lut_gather": ("lut_gather_launch",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the reference's slot gate for the LUT gather (pallas_kernels.py:28
# MAX_MATMUL_SLOTS), kept so both packages dispatch alike; the LUT is
# staged in 16 KB of shared memory at this size. The reference's second
# bound (values below 2^24, an artifact of its f32 one-hot product) does
# not apply to a direct gather and is dropped.
MAX_LUT_SLOTS = 4096

# launches per kernel since the last reset_launches()
launches: Dict[str, int] = {name: 0 for name in SOURCES}
# nvcc's output (register and shared-memory use) per kernel built here
build_logs: Dict[str, str] = {}

_entry_fns: Dict[str, object] = {}  # name -> loaded ctypes function
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """Build output of kernel `name`, keyed by its source and flags."""
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (all by default) that are not built yet:
    one nvcc process per source, all started together. Raises with the
    compiler's output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def _entry(name: str):
    """The C entry point of kernel `name`, built and loaded on first use."""
    with _lock:
        fn = _entry_fns.get(name)
        if fn is None:
            symbol, argtypes = _ENTRIES[name]
            fn = getattr(ctypes.CDLL(str(build([name])[name])), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entry_fns[name] = fn
        return fn


# ---------------------------------------------------------------------------
# lut_gather: replaces pallas_kernels.py:171 _matmul_gather_kernel
# (route matmul_gather, :218)
# ---------------------------------------------------------------------------

def lut_gather_plain(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: lut[codes]."""
    return lut[codes.long()]


def lut_gather(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """out[i] = lut[codes[i]]: int32 codes in [0, K), int32 lut of
    1 <= K <= MAX_LUT_SLOTS entries. CPU tensors take the plain version;
    CUDA tensors launch the kernel (csrc/lut_gather.cu) or raise."""
    if codes.device.type == "cpu" and lut.device.type == "cpu":
        return lut_gather_plain(codes, lut)
    if not (codes.is_cuda and lut.is_cuda and codes.device == lut.device):
        raise ValueError(f"lut_gather: codes on {codes.device} and lut on "
                         f"{lut.device} must share one CUDA device")
    if codes.dtype != torch.int32 or lut.dtype != torch.int32:
        raise TypeError(f"lut_gather takes int32 codes and lut, got "
                        f"{codes.dtype} and {lut.dtype}")
    if codes.dim() != 1 or lut.dim() != 1:
        raise ValueError("lut_gather takes 1-D codes and lut")
    if not (codes.is_contiguous() and lut.is_contiguous()):
        raise ValueError("lut_gather takes contiguous codes and lut")
    k = lut.shape[0]
    if not 1 <= k <= MAX_LUT_SLOTS:
        raise ValueError(f"lut_gather: LUT of {k} slots outside "
                         f"[1, {MAX_LUT_SLOTS}]")
    out = torch.empty_like(codes)
    if codes.shape[0] == 0:
        return out
    fn = _entry("lut_gather")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(codes.data_ptr(), lut.data_ptr(), out.data_ptr(),
                codes.shape[0], k, stream)
    if rc != 0:
        raise RuntimeError(f"lut_gather launch failed: cudaError {rc}")
    launches["lut_gather"] += 1
    return out
