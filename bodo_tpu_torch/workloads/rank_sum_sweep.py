"""What holds the partition_rank, groupby_sum and range_partition
kernels: their times at their main paths' shapes over rows a thread and
threads a block.

    python -m bodo_tpu_torch.workloads.rank_sum_sweep \
        [--kernels partition_rank groupby_sum range_partition]

Run from the checkout root on a machine with one NVIDIA GPU and nvcc: it
takes chip_smoke.py's timer, float64 sums and tolerance. Each variant is
the kernel's source under csrc/ with its constants replaced, built into
build/sweep/ (one nvcc per variant, all started together); each is held
against the plain version (partition_rank bit for bit, groupby_sum within
1e-5 * sum(|x|) of the float64 sums, counts exact) before it is timed.

- partition_rank: one shard of the 1D taxi path's bucket_rows, N =
  5,000,064 rows, K = 4, 46% of the rows live and the rest in bucket K;
  kSteps (128-row steps a warp: 4 * kSteps rows a thread) x kThreads,
  and the default constants without the look-back or without the rank
  stores (where the time goes).
- groupby_sum: the f32 dense query's call, N = 2^24, K = 64, C = 4 (the
  present count, a count and a sum of one column under its mask, and a
  count under the present mask again: one value column, two masks);
  kRows (rows a thread a step) x kThreads x kMaxCopies (histogram
  copies); each also with every mask unset (the code and mask loads
  alone).
- range_partition: S = 1 and 4 shards of N = 2^16 to 2^24 random keys
  a shard (a tenth of them the padding key) with n_spl in {1, 3, 7, 63,
  4095} splitters a row drawn from the keys, and the 1D taxi path's
  pass (S = 4, N = 885,504, 3 splitters) and one shard of it;
  kSmallKeys (keys a thread in the small form) x kThreads, kLargeKeys
  (in the large form), the small form's bound kSmallMax (64 and 128
  take 63 splitters in the small form), the waves of resident blocks
  (kSmallWaves 1 and 2: persistent blocks over contiguous tiles, the
  next tile's keys loaded first; kLargeWaves 0: a block a tile, and 2),
  and the large form's staged row as 64-bit words (kSplitWords 0)
  instead of high and low halves. A copy of the keys (16 B a key) is
  timed beside each shape as the streaming yardstick.

Times are chip_smoke.device_ms: the median of 20 calls queued behind a
spin kernel; the bound is the bytes the call must move over 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.workloads import profiling

# (kSteps, kThreads) of partition_rank's K <= 8 form
RANK_VARIANTS = ((4, 512), (2, 512), (4, 256), (8, 256), (2, 1024),
                 (8, 128))
# where partition_rank's time goes at its default constants: each a
# replacement in its source, timed beside the full kernel; they leave
# ranks wrong or unwritten, so they are not held against the plain
# version
RANK_PROBES = {
    "no look-back (tile bases 0)": (
        "int part[kSmallK] = {};\n    {",
        "int part[kSmallK] = {};\n    if (0) {"),
    "no rank stores": (
        "      store4(rank, first + 128 * s, n, rk);",
        "      if (rk[0] == -2) store4(rank, first + 128 * s, n, rk);"),
}
# (kRows, kThreads, kMaxCopies) of groupby_sum
SUM_VARIANTS = ((4, 512, 32), (4, 512, 1), (4, 512, 8), (4, 512, 16),
                (8, 512, 32), (4, 256, 32), (8, 256, 32), (4, 1024, 32))
RANK_ROWS, RANK_LIVE, RANK_K = 5_000_064, 0.4635, 4
SUM_ROWS, SUM_K, SUM_LIVE = 1 << 24, 64, 0.666
# range_partition: (kSmallKeys, kThreads), then other constants from the
# source's defaults
RANGE_VARIANTS = [{"kSmallKeys": k, "kThreads": t} for k in (2, 4, 8)
                  for t in (128, 256, 512)] + [
    {"kLargeKeys": 4}, {"kLargeKeys": 8}, {"kSmallMax": 64},
    {"kSmallMax": 128}, {"kSmallWaves": 1}, {"kSmallWaves": 2},
    {"kLargeWaves": 0}, {"kLargeWaves": 2}, {"kSplitWords": 0}]
RANGE_ROWS = (1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24)
RANGE_SPLITTERS = (1, 3, 7, 63, 4095)
PASS_ROWS = 885_504  # a shard of the 1D taxi path's sample sort


def _variant_source(name: str, consts: dict, replace=None) -> str:
    src = (CK.CSRC_DIR / CK.SOURCES[name]).read_text()
    for const, value in consts.items():
        src, hits = re.subn(rf"constexpr int {const} = -?\d+;",
                            f"constexpr int {const} = {value};", src)
        if hits != 1:
            raise RuntimeError(f"{name}: {const} found {hits} times")
    if replace is not None:
        if src.count(replace[0]) != 1:
            raise RuntimeError(f"{name}: {replace[0]!r} not found once")
        src = src.replace(*replace)
    return src


def build_all(variants):
    """Compile every (name, tag, consts, replacement or None) variant,
    all nvcc processes started together. Returns {tag: (library,
    register lines)}."""
    out_dir = CK.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = []
    for name, tag, consts, replace in variants:
        cu = out_dir / f"{tag}.cu"
        cu.write_text(_variant_source(name, consts, replace))
        lib = cu.with_suffix(".so")
        proc = subprocess.Popen([CK._nvcc(), *CK.NVCC_FLAGS, "-o", str(lib),
                                 str(cu)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((tag, proc, lib))
    built, failed = {}, []
    for tag, proc, lib in running:  # every build ends before a raise
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            failed.append(f"{tag}: nvcc exit {proc.returncode}\n{log}")
            continue
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        built[tag] = (ctypes.CDLL(str(lib)), regs)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class RankVariant:
    """A partition_rank build with its own look-back state."""

    def __init__(self, lib: ctypes.CDLL, n: int, k: int, dev):
        self.fn = lib.partition_rank_launch
        self.fn.argtypes = CK._ENTRIES["partition_rank"][1]
        self.fn.restype = ctypes.c_int
        words = lib.partition_rank_state_words
        words.argtypes = [CK._I64, CK._I]
        words.restype = ctypes.c_int64
        self.state = torch.zeros(words(n, k), dtype=torch.int64, device=dev)
        self.gen = 0

    def __call__(self, dest, ok, k: int):
        n = dest.shape[0]
        rank = torch.empty(n, dtype=torch.int32, device=dest.device)
        counts = torch.empty(k, dtype=torch.int32, device=dest.device)
        if self.gen == 255:  # the kernel's 8-bit generation wraps
            self.state.zero_()
            self.gen = 0
        self.gen += 1
        rc = self.fn(dest.data_ptr(), ok.data_ptr(), rank.data_ptr(),
                     counts.data_ptr(), self.state.data_ptr(), n, k,
                     self.gen, _stream())
        if rc:
            raise RuntimeError(f"partition_rank launch failed: {rc}")
        return rank, counts


def sum_launcher(lib: ctypes.CDLL):
    fn = lib.groupby_sum_launch
    fn.argtypes = CK._ENTRIES["groupby_sum"][1]
    fn.restype = ctypes.c_int

    def call(codes, cols, masks, k: int):
        c = len(masks)
        out = torch.zeros(k, c, dtype=torch.float32, device=codes.device)
        vals = (CK._P * c)(*(None if v is None else v.data_ptr()
                             for v in cols))
        oks = (CK._P * c)(*(m.data_ptr() for m in masks))
        rc = fn(codes.data_ptr(), codes.shape[0], k, vals, oks, c,
                out.data_ptr(), _stream())
        if rc:
            raise RuntimeError(f"groupby_sum launch failed: {rc}")
        return out
    return call


def range_launcher(lib: ctypes.CDLL):
    fn = lib.range_partition_launch
    fn.argtypes = CK._ENTRIES["range_partition"][1]
    fn.restype = ctypes.c_int

    def call(pks, spl):
        s, n = len(pks), pks[0].shape[0]
        out = torch.empty(s * n, dtype=torch.int32, device=spl.device)
        rc = fn((CK._P * s)(*(p.data_ptr() for p in pks)), spl.data_ptr(),
                out.data_ptr(), n, s, spl.shape[1], _stream())
        if rc:
            raise RuntimeError(f"range_partition launch failed: {rc}")
        return out
    return call


def _tag(consts: dict) -> str:
    return "range_" + "_".join(f"{k}{v}" for k, v in consts.items())


def sweep_range_partition(cs, dev) -> None:
    built = build_all([("range_partition", _tag(c), c, None)
                       for c in RANGE_VARIANTS])
    for c in RANGE_VARIANTS:
        print(f"range_partition {c}: {built[_tag(c)][1]}")
    fns = {_tag(c): range_launcher(built[_tag(c)][0])
           for c in RANGE_VARIANTS}
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 10)
    shapes = [(s, n, m) for s in (1, 4) for n in RANGE_ROWS
              for m in RANGE_SPLITTERS]
    shapes += [(4, PASS_ROWS, 3), (1, PASS_ROWS, 3)]
    best = []
    for s, n, m in shapes:
        pool = torch.randint(-(1 << 63), (1 << 63) - 1, (s * n,),
                             generator=g, device=dev, dtype=torch.int64)
        pool[::10] = -1
        pks = [pool[j * n:(j + 1) * n] for j in range(s)]
        spl = cs.range_rows(g, pks, m)
        want = CK.range_partition_plain(pks, spl)
        bound = cs.range_bound_ms(s, n, m)
        copy = torch.empty_like(pool)
        copy_ms = cs.device_ms(lambda: copy.copy_(pool))
        times = {}
        for c in RANGE_VARIANTS:
            fn = fns[_tag(c)]
            got = fn(pks, spl)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"range_partition {c} differs at "
                                     f"S={s} N={n} n_spl={m}")
            times[_tag(c)] = cs.device_ms(lambda: fn(pks, spl))
        line = " ".join(f"{t[6:]}={ms:.6f}" for t, ms in times.items())
        print(f"range_partition S={s} N={n} n_spl={m} bound_ms={bound:.6f} "
              f"copy_ms={copy_ms:.6f}: {line}")
        tag = min(times, key=times.get)
        best.append((s, n, m, tag, times[tag], bound))
        del pool, pks, spl, want, copy
    for s, n, m, tag, ms, bound in best:
        print(f"range_partition best S={s} N={n} n_spl={m}: {tag[6:]} "
              f"{ms:.6f} ms ({bound / ms:.1%} of the bound)")


def main() -> None:
    import argparse
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=[
        "partition_rank", "groupby_sum", "range_partition"])
    kernels = ap.parse_args().kernels
    dev = torch.device("cuda")
    print(profiling.card())
    if "range_partition" in kernels:
        sweep_range_partition(cs, dev)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    if "partition_rank" in kernels:
        sweep_partition_rank(cs, dev, g)
    if "groupby_sum" in kernels:
        sweep_groupby_sum(cs, dev, g)


def sweep_partition_rank(cs, dev, g) -> None:
    probes = list(RANK_PROBES.items())
    built = build_all(
        [("partition_rank", f"rank_{s}x{t}", {"kSteps": s, "kThreads": t},
          None) for s, t in RANK_VARIANTS]
        + [("partition_rank", f"rank_probe{j}", {}, rep)
           for j, (_, rep) in enumerate(probes)])
    live = torch.rand(RANK_ROWS, generator=g, device=dev) < RANK_LIVE
    dest = torch.where(live, torch.randint(0, RANK_K, (RANK_ROWS,),
                                           generator=g, device=dev),
                       RANK_K).to(torch.int32)
    want = CK.partition_rank_plain(dest, live, RANK_K)
    bound = (9 * RANK_ROWS + 4 * RANK_K) / cs.HBM_BYTES_PER_S * 1e3
    copy_out = torch.empty_like(dest)
    copy_ms = cs.device_ms(lambda: copy_out.copy_(dest))
    print(f"partition_rank yardstick: a copy of the buckets (8 B a row) "
          f"{copy_ms:.6f} ms, 9 B a row at its rate "
          f"{copy_ms * 9 / 8:.6f} ms")
    runs = [(f"steps={s} rows_a_thread={4 * s} threads={t}",
             f"rank_{s}x{t}", True) for s, t in RANK_VARIANTS]
    runs += [(f"default constants, {label}", f"rank_probe{j}", False)
             for j, (label, _) in enumerate(probes)]
    for label, tag, checked in runs:
        lib, regs = built[tag]
        fn = RankVariant(lib, RANK_ROWS, RANK_K, dev)
        got = fn(dest, live, RANK_K)
        got2 = fn(dest, live, RANK_K)
        torch.cuda.synchronize()
        for r in (got, got2) if checked else ():
            if not (torch.equal(r[0], want[0]) and torch.equal(r[1],
                                                               want[1])):
                raise AssertionError(f"partition_rank {label} differs")
        ms = cs.device_ms(lambda: fn(dest, live, RANK_K))
        print(f"partition_rank {label} N={RANK_ROWS} K={RANK_K} "
              f"ok_rows={int(live.sum())}: kernel_ms={ms:.6f} "
              f"bound_ms={bound:.6f} ({bound / ms:.1%} of the bound) "
              f"bit_identical={checked or 'not held'} {regs}")


def sweep_groupby_sum(cs, dev, g) -> None:
    built = build_all([("groupby_sum", f"sum_{r}x{t}x{c}",
                        {"kRows": r, "kThreads": t, "kMaxCopies": c}, None)
                       for r, t, c in SUM_VARIANTS])
    codes = torch.randint(0, SUM_K, (SUM_ROWS,), generator=g, device=dev,
                          dtype=torch.int32)
    present = torch.rand(SUM_ROWS, generator=g, device=dev) < SUM_LIVE
    ok = present.clone()
    z = torch.randn(SUM_ROWS, generator=g, device=dev)
    args = (codes, [None, None, z, None], [present, ok, ok, present], SUM_K)
    unset = [torch.zeros_like(present), torch.zeros_like(ok)]
    off = (codes, args[1], [unset[0], unset[1], unset[1], unset[0]], SUM_K)
    s64, a64 = cs.groupby_sums64(*args)
    nbytes = cs.groupby_sum_bytes(*args)
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    for r, t, c in SUM_VARIANTS:
        lib, regs = built[f"sum_{r}x{t}x{c}"]
        fn = sum_launcher(lib)
        got = fn(*args)
        torch.cuda.synchronize()
        worst = cs.hold_groupby_sum(got, s64, a64, args[1], f"{r}x{t}x{c}")
        ms = cs.device_ms(lambda: fn(*args))
        loads_ms = cs.device_ms(lambda: fn(*off))
        print(f"groupby_sum rows_a_thread={r} threads={t} copies<={c} "
              f"N={SUM_ROWS} K={SUM_K} C=4: kernel_ms={ms:.6f} "
              f"masks_unset_ms={loads_ms:.6f} bound_ms={bound:.6f} "
              f"({bound / ms:.1%} of the bound) max |err| / "
              f"(1e-5 * sum|x|) {worst:.6f} registers "
              f"{[int(re.findall(r'Used (\d+) reg', x)[0]) for x in regs]}")


if __name__ == "__main__":
    main()
