"""What holds the hybrid_expand kernel: its time on chunks like the taxi
read's at several bit widths, values a thread and threads a block.

    python -m bodo_tpu_torch.workloads.hybrid_expand_sweep

Run from the checkout root on a machine with one NVIDIA GPU and nvcc: it
takes chip_smoke.py's stream encoder, timer and byte count.
Each variant is csrc/hybrid_expand.cu with its kPerThread and kThreads
constants replaced, built into build/sweep/; each is held bit-identical
to the plain version before it is timed. A chunk is 53 pages of 20,000
values (the taxi read's largest chunk), in bit-packed runs of 40 per page
or mixed runs. Times are CUDA events around 50 launches queued behind a
spin kernel (batched) and the median of 20 calls timed one by one
(chip_smoke.device_ms); the bound is chip_smoke.hybrid_expand_bytes over
3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from bodo_tpu_torch.io import device_decode as DD
from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.workloads import profiling

VARIANTS = ((8, 256), (4, 256), (16, 256), (8, 128), (2, 256), (32, 128))
CHUNKS = ((2, "packed"), (17, "packed"), (8, "mixed"))
PAGES, PAGE_VALUES = 53, 20_000


def chunk(cs, rng, bw: int, kind: str, dev):
    """A staged chunk of PAGES pages: the kernel's tensor arguments."""
    streams, blobs, off = [], [], 0
    for _ in range(PAGES):
        stream, _ = cs.encode_hybrid(rng, PAGE_VALUES, 40, bw, kind)
        page = b"\x07" + stream  # the dictionary page's width byte
        rt = DD._parse_hybrid(page, 1, len(page), bw, PAGE_VALUES)
        page += bytes(-(-(len(page) + 8) // 8) * 8 - len(page))
        streams.append((PAGE_VALUES, off, off + len(page), bw, rt.starts,
                        rt.is_rle, rt.vals, rt.bits))
        blobs.append(page)
        off += len(page)
    buf = np.frombuffer(b"".join(blobs), np.uint8)
    return [torch.from_numpy(np.array(a)).to(dev)
            for a in (buf, *CK.hybrid_segments(streams))]


def build(per: int, threads: int):
    """The kernel with `per` values a thread and `threads` a block."""
    src = (CK.CSRC_DIR / CK.SOURCES["hybrid_expand"]).read_text()
    src = re.sub(r"kThreads = \d+;", f"kThreads = {threads};", src)
    src = re.sub(r"kPerThread = \d+;", f"kPerThread = {per};", src)
    if per != 8:  # the two 16-byte stores hold 8 values
        src = src.replace("i0 + kPerThread <= n && ", "false && ")
    out_dir = CK.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"hybrid_expand_{per}_{threads}.cu"
    cu.write_text(src)
    lib = cu.with_suffix(".so")
    done = subprocess.run([CK._nvcc(), *CK.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True,
                          timeout=600)
    if done.returncode:
        raise RuntimeError(done.stdout + done.stderr)
    regs = [ln.split(":")[-1].strip() for ln in done.stdout.splitlines()
            + done.stderr.splitlines() if "registers" in ln]
    fn = ctypes.CDLL(str(lib)).hybrid_expand_segments_launch
    fn.argtypes = CK._ENTRIES["hybrid_expand"][1]
    fn.restype = ctypes.c_int
    return fn, regs


def launch(fn, args, n: int):
    data, segs, starts, is_rle, vals, bits = args
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    rc = fn(data.data_ptr(), data.shape[0], segs.data_ptr(), segs.shape[0],
            starts.data_ptr(), is_rle.data_ptr(), vals.data_ptr(),
            bits.data_ptr(), starts.shape[0], out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def batched_ms(cs, fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cs.SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    import chip_smoke as cs
    dev = torch.device("cuda")
    print(profiling.card())
    rng = np.random.default_rng(cs.SEED + 7)
    n = PAGES * PAGE_VALUES
    chunks = {f"bw={bw} {kind}": chunk(cs, rng, bw, kind, dev)
              for bw, kind in CHUNKS}
    for per, threads in VARIANTS:
        fn, regs = build(per, threads)
        for name, args in chunks.items():
            want = CK.hybrid_expand_segments_plain(*args, n)
            if not torch.equal(launch(fn, args, n), want):
                raise AssertionError(f"{per}x{threads} differs on {name}")
            nbytes = cs.hybrid_expand_bytes(args[1], args[2], args[3],
                                            args[5])
            print(f"values_a_thread={per} threads={threads} {name} "
                  f"values={n}: batched_ms="
                  f"{batched_ms(cs, lambda: launch(fn, args, n)):.6f} "
                  f"per_call_ms="
                  f"{cs.device_ms(lambda: launch(fn, args, n)):.6f} "
                  f"bound_ms={nbytes / cs.HBM_BYTES_PER_S * 1e3:.6f} "
                  f"bit_identical=True {regs}")


if __name__ == "__main__":
    main()
