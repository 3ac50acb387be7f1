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

import numpy as np
import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# kernel name -> CUDA source under csrc/
SOURCES = {"lut_gather": "lut_gather.cu", "hash_probe": "hash_probe.cu",
           "partition_rank": "partition_rank.cu",
           "range_partition": "range_partition.cu",
           "hybrid_expand": "hybrid_expand.cu",
           "groupby_sum": "groupby_sum.cu"}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_U32 = ctypes.c_uint32
# kernel name -> (C entry point, ctypes argument types); pointers and the
# stream are c_void_p so ctypes passes them at full width
_ENTRIES = {
    "lut_gather": ("lut_gather_launch", [_P, _P, _P, _I64, _P]),
    # h, step, probe code pointers and strides, build code pointers and
    # strides, owner, ok, idx, flag, scratch, n, n_codes, T, max_rounds,
    # stream
    "hash_probe": ("hash_probe_launch",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I64, _I, _I64, _I, _P]),
    # dest, ok, rank, counts, look-back state, n, k, generation, stream
    "partition_rank": ("partition_rank_launch",
                       [_P, _P, _P, _P, _P, _I64, _I, _U32, _P]),
    # shard key pointers, splitter rows, out, n a shard, shards, n_spl,
    # stream
    "range_partition": ("range_partition_launch",
                        [_P, _P, _P, _I64, _I, _I, _P]),
    # data, nb, segs, n_segs, starts, is_rle, vals, bits, n_runs, out, n,
    # stream
    "hybrid_expand": ("hybrid_expand_segments_launch",
                      [_P, _I64, _P, _I, _P, _P, _P, _P, _I, _P, _I64, _P]),
    # codes, n, k, values pointers, mask pointers, c, out, stream
    "groupby_sum": ("groupby_sum_launch",
                    [_P, _I64, _I, _P, _P, _I, _P, _P]),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last reset_launches(); "dict_gather" counts
# the launches of lut_gather's kernel from the parquet decoder's
# dictionary remap, apart from its other call sites
launches: Dict[str, int] = {name: 0 for name in (*SOURCES, "dict_gather")}
# nvcc's output (register and shared-memory use) per kernel built here
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}  # name -> loaded library
_entry_fns: Dict[str, object] = {}  # name -> loaded ctypes function
_lock = threading.RLock()  # _entry holds it while _lib takes it again


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


def _lib(name: str) -> ctypes.CDLL:
    """The library of kernel `name`, built and loaded on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def _entry(name: str):
    """The C entry point of kernel `name`, built and loaded on first use."""
    with _lock:
        fn = _entry_fns.get(name)
        if fn is None:
            symbol, argtypes = _ENTRIES[name]
            fn = getattr(_lib(name), symbol)
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


def _on_one_cuda_device(name: str, tensors) -> torch.device:
    """The CUDA device all `tensors` share, else raise: a wrapper given
    tensors that are not all on the CPU launches its kernel or fails."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))} "
                         f"must share one CUDA device")
    return next(iter(devs))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous {dim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def _launch(name: str, dev: torch.device, *args,
            counter: Optional[str] = None) -> None:
    """Launch kernel `name` on the current stream of `dev` and count it
    under `counter` (the kernel's own name by default)."""
    fn = _entry(name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[counter or name] += 1


def lut_gather(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """out[i] = lut[codes[i]]: int32 codes in [0, K), int32 lut of K >= 1
    entries. CPU tensors take the plain version; CUDA tensors launch the
    kernel (csrc/lut_gather.cu) or raise.

    Every LUT the dense join admits (up to dense_join_max_slots = 2^22)
    goes through the kernel. The reference's 4096-slot gate
    (pallas_kernels.py:28, applied at relational.py:1404-1406) chose
    between its one-hot MXU kernel and XLA's gather, two spellings of
    one function; it was the MXU's limit, not Hopper's."""
    return _lut_gather(codes, lut, "lut_gather")


def dict_gather(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The parquet decoder's string-dictionary rank remap lut[codes]
    (the reference's `dict_gather` route, pallas_kernels.py:633, called
    from io/device_decode.py:1187): lut_gather's kernel, with its
    launches counted as launches["dict_gather"]."""
    return _lut_gather(codes, lut, "dict_gather")


def _lut_gather(codes: torch.Tensor, lut: torch.Tensor,
                counter: str) -> torch.Tensor:
    if codes.device.type == "cpu" and lut.device.type == "cpu":
        return lut_gather_plain(codes, lut)
    dev = _on_one_cuda_device(counter, (codes, lut))
    _check(f"{counter} codes", codes, torch.int32, 1)
    _check(f"{counter} lut", lut, torch.int32, 1)
    k = lut.shape[0]
    if not 1 <= k < 2 ** 31:
        raise ValueError(f"{counter}: LUT of {k} slots")
    out = torch.empty_like(codes)
    if codes.shape[0] == 0:
        return out
    _launch("lut_gather", dev, codes.data_ptr(), lut.data_ptr(),
            out.data_ptr(), codes.shape[0], counter=counter)
    return out


# ---------------------------------------------------------------------------
# hash_probe: replaces pallas_kernels.py:299 _hash_probe_kernel
# (route hash_probe, :397, reached from hashtable.probe_slots)
# ---------------------------------------------------------------------------

# code columns a hash_probe launch takes (csrc/hash_probe.cu kMaxCodes)
HASH_PROBE_MAX_CODES = 64
# hash_probe_form's values: how the kernel walks a call (csrc/hash_probe.cu)
HASH_PROBE_FORMS = ("columns", "shared", "rows")


def hash_probe_plain(build_codes, owner: torch.Tensor, probe_codes,
                     ok: torch.Tensor, h: torch.Tensor, step: torch.Tensor,
                     T: int, max_rounds: int):
    """Plain PyTorch version of the kernel: the JAX package's lock-step
    probe loop (bodo_tpu/ops/hashtable.py:248-269). Each round every
    still-walking row reads owner[(h + r*step) & (T-1)]: an empty slot is
    a miss, an owner whose codes all equal the row's is a hit."""
    mask = T - 1
    idx = torch.full(ok.shape, -1, dtype=torch.int32, device=ok.device)
    active = ok.clone()
    r = 0
    while r < max_rounds and bool(active.any()):
        o = owner[(h + r * step) & mask]
        osafe = o.clamp(min=0).to(torch.int64)
        eq = o >= 0
        for bc, pc in zip(build_codes, probe_codes):
            eq = eq & (bc[osafe] == pc)
        hit = active & eq
        idx = torch.where(hit, o, idx)
        active = active & ~hit & (o >= 0)
        r += 1
    return idx, active.any()


def hash_probe(build_codes, owner: torch.Tensor, probe_codes,
               ok: torch.Tensor, h: torch.Tensor, step: torch.Tensor, T: int,
               max_rounds: int):
    """Open-addressing probe of `ok` rows into a claim table of T slots.

    build_codes: a sequence of n_codes int64 [bcap] columns (a
    [n_codes, bcap] tensor iterates as one), owner int32 [T] (build row
    per slot, -1 empty), probe_codes: n_codes int64 [N] columns, ok bool
    [N], h and step int64 [N] (the uint64 double-hash start and odd step,
    already reduced mod T). A column may be any 1-D view: the kernel
    takes each column's pointer and stride. Returns (idx int32 [N]: the
    build row with equal codes, else -1; unresolved: a 0-d bool tensor,
    True when some ok row was still walking after `max_rounds`). CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/hash_probe.cu) or raise. Nothing syncs with the host."""
    build_codes, probe_codes = tuple(build_codes), tuple(probe_codes)
    given = (*build_codes, owner, *probe_codes, ok, h, step)
    if all(t.device.type == "cpu" for t in given):
        return hash_probe_plain(build_codes, owner, probe_codes, ok, h,
                                step, T, max_rounds)
    dev = _on_one_cuda_device("hash_probe", given)
    call, idx, flag, _scratch = _hash_probe_call(
        build_codes, owner, probe_codes, ok, h, step, T, max_rounds, dev)
    if call is not None:
        _launch("hash_probe", dev, *call)
    return idx, flag[0] != 0


def _hash_probe_call(build_codes, owner, probe_codes, ok, h, step, T: int,
                     max_rounds: int, dev):
    """Check a CUDA call of hash_probe and make its outputs and scratch.
    Returns (the C entry's arguments but the stream, or None when there
    is no row; idx; flag; the scratch for the rows form's slot rows, or
    None). The launch goes on the current stream, so the allocator hands
    the scratch to no other work before the launch has run."""
    n_codes = len(probe_codes)
    if len(build_codes) != n_codes or \
            not 1 <= n_codes <= HASH_PROBE_MAX_CODES:
        raise ValueError(f"hash_probe: {len(build_codes)} build and "
                         f"{n_codes} probe code columns (1 to "
                         f"{HASH_PROBE_MAX_CODES})")
    for c in (*build_codes, *probe_codes):
        if c.dtype != torch.int64 or c.dim() != 1:
            raise TypeError(f"hash_probe takes 1-D int64 code columns, "
                            f"got {c.dtype} {tuple(c.shape)}")
    _check("hash_probe owner", owner, torch.int32, 1)
    _check("hash_probe ok", ok, torch.bool, 1)
    _check("hash_probe h", h, torch.int64, 1)
    _check("hash_probe step", step, torch.int64, 1)
    n = ok.shape[0]
    if len({c.shape[0] for c in build_codes}) != 1:
        raise ValueError("hash_probe: build code columns differ in length")
    if not (h.shape[0] == step.shape[0] == n
            and all(c.shape[0] == n for c in probe_codes)):
        raise ValueError("hash_probe: ok, h, step and probe codes differ "
                         "in length")
    if T < 16 or T & (T - 1) or owner.shape[0] != T:
        raise ValueError(f"hash_probe: T={T} must be a power of two >= 16 "
                         f"and the owner table's length "
                         f"({owner.shape[0]})")
    if not 0 <= max_rounds < 2 ** 31:
        raise ValueError(f"hash_probe: max_rounds={max_rounds}")
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if not n:
        return None, idx, flag, None
    size = _lib("hash_probe").hash_probe_scratch_bytes
    size.argtypes = [_I64, _I64, _I]
    size.restype = ctypes.c_int64
    nbytes = size(n, T, n_codes)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    call = (h.data_ptr(), step.data_ptr(),
            (_P * n_codes)(*(c.data_ptr() for c in probe_codes)),
            (_I64 * n_codes)(*(c.stride(0) for c in probe_codes)),
            (_P * n_codes)(*(c.data_ptr() for c in build_codes)),
            (_I64 * n_codes)(*(c.stride(0) for c in build_codes)),
            owner.data_ptr(), ok.data_ptr(), idx.data_ptr(),
            flag.data_ptr(), None if scratch is None else scratch.data_ptr(),
            n, n_codes, T, max_rounds)
    return call, idx, flag, scratch


def hash_probe_form(n: int, T: int, n_codes: int) -> str:
    """How the hash_probe kernel walks a call of n probe rows into T slots
    with n_codes code columns: "columns", "shared" or "rows" (the fixed
    rule in csrc/hash_probe.cu's header)."""
    fn = _lib("hash_probe").hash_probe_form
    fn.argtypes = [_I64, _I64, _I]
    fn.restype = ctypes.c_int
    return HASH_PROBE_FORMS[fn(n, T, n_codes)]


# ---------------------------------------------------------------------------
# partition_rank: replaces pallas_kernels.py:432 _partition_rank_kernel
# (route partition_rank, :509, reached from parallel/shuffle.bucket_rows)
# ---------------------------------------------------------------------------

# the kernel's K > 8 form keeps 20 B of shared memory a bucket
PARTITION_MAX_BUCKETS = 4096
_GEN_LIMIT = 256  # the kernel's packed words keep 8 bits of generation

# (device index, stream) -> [look-back state, last generation]: the kernel
# claims tiles from a counter in the state and publishes each tile's
# counts there, tagged with the call's generation, so no call clears it;
# calls on one stream run in order and never share words
_rank_states: Dict[tuple, list] = {}


def partition_rank_plain(dest: torch.Tensor, ok: torch.Tensor,
                         num_buckets: int):
    """Plain PyTorch version of the kernel: the JAX package's sort route
    of bucket_rows (bodo_tpu/parallel/shuffle.py:73-79). A stable sort by
    bucket puts each bucket's rows together in row order; a row's rank is
    its position minus its bucket's first position."""
    k = num_buckets
    n = dest.shape[0]
    live = ok & (dest >= 0) & (dest < k)
    counts = torch.zeros(k + 1, dtype=torch.int32, device=dest.device)
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dest.device), \
            counts[:k]
    key = torch.where(live, dest.to(torch.int64), k)
    order = torch.sort(key, stable=True).indices
    ks = key[order]
    pos = torch.arange(n, device=dest.device)
    is_new = (ks != torch.roll(ks, 1)) | (pos == 0)
    start = torch.cummax(torch.where(is_new, pos, 0), 0).values
    rank = torch.empty(n, dtype=torch.int32, device=dest.device)
    rank[order] = (pos - start).to(torch.int32)
    counts.index_add_(0, key, torch.ones_like(rank))
    return torch.where(live, rank, -1), counts[:k]


def partition_rank(dest: torch.Tensor, ok: torch.Tensor, num_buckets: int):
    """Each ok row's stable rank inside its bucket `dest` (rows in row
    order), and the ok rows of each bucket: int32 dest [N], bool ok [N],
    K = num_buckets -> (rank int32 [N], -1 where a row is not ok or its
    bucket is outside [0, K); counts int32 [K]). CPU tensors take the
    plain version; CUDA tensors launch the kernel
    (csrc/partition_rank.cu) or raise.

    The reference gates its kernel to N < 2^24 rows (pallas_kernels.py
    :518-519), the exactness limit of the TPU's f32 ranks; the CUDA
    kernel counts in int32, so the port drops that gate, as it dropped
    lut_gather's. Either way the result is the same: the reference's
    sort route and its partition_rank route pack rows identically."""
    if dest.device.type == "cpu" and ok.device.type == "cpu":
        return partition_rank_plain(dest, ok, num_buckets)
    dev = _on_one_cuda_device("partition_rank", (dest, ok))
    _check("partition_rank dest", dest, torch.int32, 1)
    _check("partition_rank ok", ok, torch.bool, 1)
    k = num_buckets
    n = dest.shape[0]
    if ok.shape[0] != n:
        raise ValueError("partition_rank: dest and ok differ in length")
    if not 1 <= k <= PARTITION_MAX_BUCKETS:
        raise ValueError(f"partition_rank: {k} buckets (the kernel takes "
                         f"1 to {PARTITION_MAX_BUCKETS})")
    if n >= 2 ** 31:
        raise ValueError(f"partition_rank: {n} rows overflow int32 ranks")
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    if not n:
        return rank, torch.zeros(k, dtype=torch.int32, device=dev)
    counts = torch.empty(k, dtype=torch.int32, device=dev)  # all written
    state, gen = _partition_rank_state(dev, n, k)
    _launch("partition_rank", dev, dest.data_ptr(), ok.data_ptr(),
            rank.data_ptr(), counts.data_ptr(), state.data_ptr(), n, k, gen)
    return rank, counts


def _partition_rank_state(dev: torch.device, n: int, k: int):
    """The look-back state of the current stream of `dev`, with at least
    the words a call at (n, k) needs, and the call's new generation (1 to
    255). The state is zeroed when it is allocated (grown to a power of
    two) and when the generation wraps: once in 255 calls."""
    fn = _lib("partition_rank").partition_rank_state_words
    fn.argtypes = [_I64, _I]
    fn.restype = ctypes.c_int64
    words = fn(n, k)
    with torch.cuda.device(dev), _lock:
        key = (dev.index, torch.cuda.current_stream().cuda_stream)
        entry = _rank_states.get(key)
        if entry is None or entry[0].numel() < words:
            size = 1 << (words - 1).bit_length()
            entry = _rank_states[key] = [
                torch.zeros(size, dtype=torch.int64, device=dev), 0]
        elif entry[1] + 1 >= _GEN_LIMIT:
            entry[0].zero_()
            entry[1] = 0
        entry[1] += 1
        return entry[0], entry[1]


# ---------------------------------------------------------------------------
# range_partition: replaces pallas_kernels.py:654 _range_partition_kernel
# (route range_partition, :701, reached from ops/sort.py's sample sort)
# ---------------------------------------------------------------------------

# the kernel's large form stages a shard's splitters in shared memory
RANGE_MAX_SPLITTERS = 4096
# shards a launch takes (csrc/range_partition.cu kMaxShards)
RANGE_MAX_SHARDS = 16
# range_partition_form's values (csrc/range_partition.cu)
RANGE_FORMS = ("small", "large")
_SIGN64 = -(1 << 63)


def _searchsorted_u64(pk: torch.Tensor, splitters: torch.Tensor):
    """torch.searchsorted on the uint64 bits held in int64, with the sign
    bit flipped so that torch's signed order is the unsigned order."""
    return torch.searchsorted((splitters ^ _SIGN64).contiguous(),
                              (pk ^ _SIGN64).contiguous(),
                              right=True).to(torch.int32)


def range_partition_plain(pk, splitters: torch.Tensor):
    """Plain PyTorch version of the kernel: for one key tensor and 1-D
    splitters, torch.searchsorted on the uint64 bits; for a sequence of S
    key tensors and [S, n_spl] splitters, that for each shard with its
    row, the results concatenated."""
    if isinstance(pk, torch.Tensor):
        return _searchsorted_u64(pk, splitters)
    pks = tuple(pk)
    if not pks or splitters.dim() != 2 or splitters.shape[0] != len(pks):
        raise ValueError(f"range_partition: {len(pks)} shards need "
                         f"[{len(pks)}, n_spl] splitters, got "
                         f"{tuple(splitters.shape)}")
    return torch.cat([_searchsorted_u64(p, row)
                      for p, row in zip(pks, splitters)])


def range_partition(pk, splitters: torch.Tensor):
    """searchsorted(splitters, pk, side='right') over uint64 keys held in
    int64 tensors: the number of splitters <= each key, as int32.

    pk is one key tensor [N] with 1-D splitters [n_spl], or a sequence of
    S key tensors (the shards of a sample-sort pass, each N keys long,
    any 1-D view) with [S, n_spl] splitters, shard i's row i. Each row is
    sorted ascending as unsigned 64-bit integers, n_spl <= 4096. Returns
    the S * N destinations, shard after shard. CPU tensors take the plain
    version; CUDA tensors launch the kernel (csrc/range_partition.cu) or
    raise: one launch for every RANGE_MAX_SHARDS shards."""
    pks = (pk,) if isinstance(pk, torch.Tensor) else tuple(pk)
    if all(t.device.type == "cpu" for t in (*pks, splitters)):
        return range_partition_plain(pk, splitters)
    dev = _on_one_cuda_device("range_partition", (*pks, splitters))
    if isinstance(pk, torch.Tensor):
        _check("range_partition splitters", splitters, torch.int64, 1)
        spl = splitters.view(1, -1)
    else:
        _check("range_partition splitters", splitters, torch.int64, 2)
        spl = splitters
    s, n_spl = spl.shape
    if not pks or s != len(pks):
        raise ValueError(f"range_partition: {len(pks)} shards, {s} "
                         f"splitter rows")
    if n_spl > RANGE_MAX_SPLITTERS:
        raise ValueError(f"range_partition: {n_spl} splitters (the kernel "
                         f"takes at most {RANGE_MAX_SPLITTERS})")
    for p in pks:
        _check("range_partition pk", p, torch.int64, 1)
        if p.data_ptr() % 8:
            raise ValueError("range_partition: keys off 8-byte alignment")
    n = pks[0].shape[0]
    if any(p.shape[0] != n for p in pks):
        raise ValueError(f"range_partition: shards of "
                         f"{sorted({p.shape[0] for p in pks})} keys (the "
                         f"kernel takes shards of one length)")
    out = torch.empty(s * n, dtype=torch.int32, device=dev)
    if n:
        for a in range(0, s, RANGE_MAX_SHARDS):
            group = pks[a:a + RANGE_MAX_SHARDS]
            _launch("range_partition", dev,
                    (_P * len(group))(*(p.data_ptr() for p in group)),
                    spl[a].data_ptr(), out[a * n:].data_ptr(), n,
                    len(group), n_spl)
    return out


def range_partition_form(n_spl: int) -> str:
    """The form the kernel takes for n_spl splitters: "small" (each lane
    counts the row through the read-only path) or "large" (the row staged
    in shared memory, a binary search), by the rule in
    csrc/range_partition.cu's header."""
    fn = _lib("range_partition").range_partition_form
    fn.argtypes = [_I]
    fn.restype = ctypes.c_int
    return RANGE_FORMS[fn(n_spl)]


# ---------------------------------------------------------------------------
# hybrid_expand: replaces pallas_kernels.py:536 _hybrid_expand_kernel
# (route hybrid_expand, :615, reached from io/device_decode's page decode)
# ---------------------------------------------------------------------------

HYBRID_MAX_BITWIDTH = 24  # the 4-byte window of the bit extractor
# columns of a segment table row (csrc/hybrid_expand.cu)
SEG_BASE, SEG_N, SEG_LO, SEG_HI, SEG_BW, SEG_RUN_LO, SEG_RUN_HI = range(7)
SEG_FIELDS = 7


def hybrid_expand_plain(data: torch.Tensor, starts: torch.Tensor,
                        is_rle: torch.Tensor, vals: torch.Tensor,
                        bits: torch.Tensor, bw: int,
                        n_bucket: int) -> torch.Tensor:
    """Plain PyTorch version of one page of the kernel: the JAX package's
    XLA body (bodo_tpu/io/device_decode.py:486-525). The owning run of
    each output index comes from scattering each run's index at its start
    and a running max (sentinel starts past n_bucket drop); RLE runs give
    their value, bit-packed runs bw bits read little-endian through a
    window of ceil((7 + bw) / 8) bytes, byte indices clipped to the
    page."""
    dev = data.device
    i = torch.arange(n_bucket, dtype=torch.int64, device=dev)
    n_runs = starts.shape[0]
    st = starts.long()
    owner = torch.zeros(n_bucket + 1, dtype=torch.int64, device=dev)
    owner.scatter_reduce_(
        0, torch.where((st >= 0) & (st < n_bucket), st, n_bucket),
        torch.arange(n_runs, dtype=torch.int64, device=dev), "amax")
    r = torch.cummax(owner[:n_bucket], 0).values
    rv = torch.where(is_rle, vals, -1)[r]
    if bw > 0:
        bp = (bits.long() - st * bw)[r] + i * bw
        byte0 = bp >> 3
        nb = data.shape[0]
        w = torch.zeros(n_bucket, dtype=torch.int64, device=dev)
        for k in range((bw + 14) // 8):
            w |= data[(byte0 + k).clamp(0, nb - 1)].long() << (8 * k)
        packed = ((w >> (bp & 7)) & ((1 << bw) - 1)).to(torch.int32)
    else:
        packed = torch.zeros(n_bucket, dtype=torch.int32, device=dev)
    return torch.where(rv >= 0, rv, packed)


def hybrid_expand_segments_plain(data: torch.Tensor, segs: torch.Tensor,
                                 starts: torch.Tensor, is_rle: torch.Tensor,
                                 vals: torch.Tensor, bits: torch.Tensor,
                                 n_total: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: for each segment, the plain
    version of its page (`hybrid_expand_plain` over the page bytes
    data[lo:hi] and its runs, rebased to the page) written at its output
    base. Outputs no segment covers, and the outputs of a segment without
    runs, are 0."""
    out = torch.zeros(n_total, dtype=torch.int32, device=data.device)
    for base, n, lo, hi, bw, run_lo, run_hi in segs.tolist():
        if n == 0 or run_lo >= run_hi:
            continue
        runs = slice(run_lo, run_hi)
        out[base:base + n] = hybrid_expand_plain(
            data[lo:hi], starts[runs] - base, is_rle[runs], vals[runs],
            bits[runs] - 8 * lo, bw, n)
    return out


def hybrid_segments(streams):
    """The host tables of one hybrid_expand_segments launch. `streams`
    lists each segment, a hybrid stream of one page, in output order, as
    (n_out, lo, hi, bw, starts, is_rle, vals, bits): its output count,
    its page's byte window [lo, hi) in the staged buffer, its bit width
    and its run table as the page's run-header walk gives it (starts
    from the stream's first output, int64 bits from bit 0 of the page).
    Outputs are dense: a segment's base is the sum of the counts before
    it. Returns numpy (segs int64 [S, 7], starts int32, is_rle bool,
    vals int32, bits int64), the run tables concatenated with starts
    rebased to each segment's base and bits to absolute bit offsets in
    the staged buffer. Raises ValueError on a table the kernel does not
    take."""
    segs = np.zeros((len(streams), SEG_FIELDS), np.int64)
    parts = ([], [], [], [])
    base = n_runs = 0
    for s, (n, lo, hi, bw, st, rle, vv, bb) in enumerate(streams):
        k = len(st)
        if not (n >= 0 and 0 <= lo <= hi and 0 <= bw <= HYBRID_MAX_BITWIDTH
                and len(rle) == len(vv) == len(bb) == k):
            raise ValueError(f"hybrid segment {s}: n={n} bytes [{lo}, "
                             f"{hi}) bw={bw} with {k} runs")
        if k and (hi == lo or st[0] < 0 or np.any(np.diff(st) < 0)):
            raise ValueError(f"hybrid segment {s}: starts must be "
                             f"nonnegative and nondecreasing, over a "
                             f"page of at least one byte")
        segs[s] = (base, n, lo, hi, bw, n_runs, n_runs + k)
        parts[0].append(np.asarray(st, np.int64) + base)
        parts[1].append(np.asarray(rle, bool))
        parts[2].append(np.asarray(vv, np.int32))
        parts[3].append(np.asarray(bb, np.int64) + 8 * lo)
        base += n
        n_runs += k
    starts, is_rle, vals, bits = (
        np.concatenate(p) if p else np.zeros(0, t)
        for p, t in zip(parts, (np.int64, bool, np.int32, np.int64)))
    if base >= 2 ** 31 or n_runs >= 2 ** 31 or \
            (n_runs and starts.max() >= 2 ** 31):
        raise ValueError(f"hybrid segments: {base} outputs, {n_runs} runs")
    return segs, starts.astype(np.int32), is_rle, vals, bits


def hybrid_expand_segments(data: torch.Tensor, segs: torch.Tensor,
                           starts: torch.Tensor, is_rle: torch.Tensor,
                           vals: torch.Tensor, bits: torch.Tensor,
                           n_total: int) -> torch.Tensor:
    """Expand every hybrid stream of a column chunk in one launch into
    int32 [n_total] values: uint8 staged bytes data [nb] (every page of
    the chunk), the segment table int64 segs [S, 7] and the run tables
    starts int32, is_rle bool, vals int32, bits int64 [n_runs], as
    `hybrid_segments` makes them. Segment s's outputs are
    [segs[s, 0], segs[s, 0] + segs[s, 1]), each what the plain version of
    its page gives. CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/hybrid_expand.cu) or raise. Nothing syncs
    with the host: the table's contract (dense bases, starts
    nondecreasing within a segment, widths 0-24) is checked where
    `hybrid_segments` builds it, and the kernel clamps every window and
    run range to the buffers it was given.

    The reference gates its kernel to <= 2048 runs and n_bucket, nb * 8
    below 2^24 (pallas_kernels.py:624-626), the f32 exactness of its MXU
    search; the CUDA kernel searches in int32 and offsets bits in int64,
    so the port drops that gate, as it dropped lut_gather's. The
    reference's kernel and its XLA body give the same integers, so the
    result does not change."""
    args = (data, segs, starts, is_rle, vals, bits)
    if all(t.device.type == "cpu" for t in args):
        return hybrid_expand_segments_plain(*args, n_total)
    dev = _on_one_cuda_device("hybrid_expand", args)
    _check("hybrid_expand data", data, torch.uint8, 1)
    _check("hybrid_expand segs", segs, torch.int64, 2)
    _check("hybrid_expand starts", starts, torch.int32, 1)
    _check("hybrid_expand is_rle", is_rle, torch.bool, 1)
    _check("hybrid_expand vals", vals, torch.int32, 1)
    _check("hybrid_expand bits", bits, torch.int64, 1)
    n_runs = starts.shape[0]
    if not (is_rle.shape[0] == vals.shape[0] == bits.shape[0] == n_runs):
        raise ValueError("hybrid_expand: run tables differ in length")
    n_segs = segs.shape[0]
    if segs.shape[1] != SEG_FIELDS or not 0 <= n_segs < 2 ** 31:
        raise ValueError(f"hybrid_expand: a segment table of shape "
                         f"{tuple(segs.shape)}")
    if not 0 <= n_total < 2 ** 31 or n_runs >= 2 ** 31 or \
            data.shape[0] < 1:
        raise ValueError(f"hybrid_expand: {n_total} outputs, {n_runs} "
                         f"runs over {data.shape[0]} staged bytes")
    out = torch.empty(n_total, dtype=torch.int32, device=dev)
    if n_total and not n_segs:
        return out.zero_()
    if n_total:
        _launch("hybrid_expand", dev, data.data_ptr(), data.shape[0],
                segs.data_ptr(), n_segs, starts.data_ptr(),
                is_rle.data_ptr(), vals.data_ptr(), bits.data_ptr(), n_runs,
                out.data_ptr(), n_total)
    return out


def hybrid_expand(data: torch.Tensor, starts: torch.Tensor,
                  is_rle: torch.Tensor, vals: torch.Tensor,
                  bits: torch.Tensor, bw: int, n_bucket: int) -> torch.Tensor:
    """Expand one page's parquet RLE/bit-packed hybrid runs into int32
    [n_bucket] values: uint8 page bytes data [nb], run tables starts
    int32 (nondecreasing; padding runs may carry a start past n_bucket),
    is_rle bool, vals int32, bits int64 (bit offset of a bit-packed run's
    first value), all [n_runs], and the bit width 0 <= bw <= 24. CPU
    tensors take the plain version; CUDA tensors launch the kernel as one
    segment (the whole output, the whole page, every run) or raise."""
    args = (data, starts, is_rle, vals, bits)
    if all(t.device.type == "cpu" for t in args):
        return hybrid_expand_plain(*args, bw, n_bucket)
    dev = _on_one_cuda_device("hybrid_expand", args)
    n_runs = starts.shape[0]
    if not 1 <= n_runs < 2 ** 31 or data.shape[0] < 1:
        raise ValueError(f"hybrid_expand: {n_runs} runs over "
                         f"{data.shape[0]} page bytes")
    if not 0 <= bw <= HYBRID_MAX_BITWIDTH:
        raise ValueError(f"hybrid_expand: bit width {bw}")
    seg = torch.tensor([[0, n_bucket, 0, data.shape[0], bw, 0, n_runs]],
                       dtype=torch.int64).to(dev)
    return hybrid_expand_segments(data, seg, starts, is_rle, vals, bits,
                                  n_bucket)


# ---------------------------------------------------------------------------
# groupby_sum: replaces pallas_kernels.py:92 matmul_groupby_sum
# (route dense_accumulate, :257, reached from the dense groupby's tail and
# the hashed groupby's _hashed_agg)
# ---------------------------------------------------------------------------

# the slot limit of the reference's accumulate (pallas_kernels.py:28
# MAX_MATMUL_SLOTS): its callers' gates, which the port keeps so that both
# packages take the same route; the kernel's private histogram of 4096
# slots is 16 KB a column of shared memory
MAX_MATMUL_SLOTS = 4096


def groupby_sum_plain(codes: torch.Tensor, cols, masks,
                      n_slots: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: for each column an f32
    index_add_ of its masked values (1.0 for a column given as None),
    rows whose code is outside [0, n_slots) dropped."""
    k = n_slots
    idx = torch.where((codes >= 0) & (codes < k), codes.long(), k)
    out = torch.zeros(k, len(masks), dtype=torch.float32,
                      device=codes.device)
    for c, (v, m) in enumerate(zip(cols, masks)):
        x = m.to(torch.float32) if v is None else \
            torch.where(m, v.to(torch.float32), 0.0)
        acc = torch.zeros(k + 1, dtype=torch.float32, device=codes.device)
        out[:, c] = acc.index_add_(0, idx, x)[:k]
    return out


def groupby_sum(codes: torch.Tensor, cols, masks,
                n_slots: int) -> torch.Tensor:
    """Per-slot f32 sums: int32 codes [N], for each of C columns an f32
    values tensor [N] (None: a column of ones, i.e. a count) and a bool
    mask [N], K = n_slots <= 4096 -> f32 [K, C], out[k, c] the sum of
    column c over the rows with code k and mask c set. Codes outside
    [0, K) add nothing. CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/groupby_sum.cu) or raise."""
    cols, masks = list(cols), list(masks)
    given = [codes, *masks, *(v for v in cols if v is not None)]
    if all(t.device.type == "cpu" for t in given):
        return groupby_sum_plain(codes, cols, masks, n_slots)
    dev = _on_one_cuda_device("groupby_sum", given)
    _check("groupby_sum codes", codes, torch.int32, 1)
    n, k, c = codes.shape[0], n_slots, len(masks)
    if len(cols) != c or c < 1:
        raise ValueError(f"groupby_sum: {len(cols)} value columns and {c} "
                         f"masks")
    for v, m in zip(cols, masks):
        _check("groupby_sum mask", m, torch.bool, 1)
        if v is not None:
            _check("groupby_sum values", v, torch.float32, 1)
        if m.shape[0] != n or (v is not None and v.shape[0] != n):
            raise ValueError("groupby_sum: codes, values and masks differ "
                             "in length")
    if not 1 <= k <= MAX_MATMUL_SLOTS:
        raise ValueError(f"groupby_sum: {k} slots (the kernel takes 1 to "
                         f"{MAX_MATMUL_SLOTS})")
    out = torch.zeros(k, c, dtype=torch.float32, device=dev)
    if n:
        vals = (_P * c)(*(None if v is None else v.data_ptr() for v in cols))
        oks = (_P * c)(*(m.data_ptr() for m in masks))
        _launch("groupby_sum", dev, codes.data_ptr(), n, k, vals, oks, c,
                out.data_ptr())
    return out


def groupby_sum_tile_cols(n_slots: int, n_cols: int) -> int:
    """Columns a launch of the groupby_sum kernel takes at `n_slots` slots
    on the current CUDA device (the host entry launches the kernel once
    per tile of that many columns), as its launcher computes it."""
    fn = _lib("groupby_sum").groupby_sum_tile_cols
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_int
    width = fn(n_slots, n_cols)
    if width < 1:
        raise RuntimeError(f"groupby_sum_tile_cols: cudaError {-width}")
    return width


def dense_accumulate(codes: torch.Tensor, cols, ok_masks,
                     n_slots: int):
    """Sum each (column, mask) pair into `n_slots` dense slots by code
    (the reference's route of the same name, pallas_kernels.py:257): one
    groupby_sum over all columns. A column is cast to f32 (None: ones,
    a count). Returns a list of f32 [n_slots] tensors aligned with
    `cols`."""
    cols = [None if v is None else v.to(torch.float32).contiguous()
            for v in cols]
    sums = groupby_sum(codes.to(torch.int32).contiguous(), cols,
                       [m.contiguous() for m in ok_masks], n_slots)
    return [sums[:, i] for i in range(len(cols))]
