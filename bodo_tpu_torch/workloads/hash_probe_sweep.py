"""What holds the hash_probe kernel: its time on the star join's call
over forms, slot-row layouts, walks a thread and threads a block.

    python -m bodo_tpu_torch.workloads.hash_probe_sweep

Run from the checkout root on a machine with one NVIDIA GPU and nvcc: it
takes chip_smoke.py's timer and the star path's own call (the star
pipeline at 20,000,000 fact and 5,000,000 dimension rows, its hash_probe
call captured: T = 2^24, 2 code columns). Each variant is
csrc/hash_probe.cu with constants replaced, built into build/sweep/ (one
nvcc per variant, all started together); each is held bit-identical to
the plain version before it is timed, except the diagnostic variants
("not held").

- forms on the star call: rows (the rule's choice there), columns (the
  walk over the owner table and the column-major build codes), and the
  columns walk over build-row-ordered code rows (a [bcap, n_codes] copy
  of the build codes, one 16-byte row a build row: two sectors a round;
  the copy, torch.stack, is timed apart as that layout's build);
- the rows form over kWalks (probe rows a thread walks together, their
  round's loads issued together) x kThreads;
- the rows form's row build: one 16-byte quad a thread (the kernel's),
  or a thread storing its whole row;
- where the time goes: the row build alone and the walk alone (the
  phase entry), owner reads only (the columns walk with its compares
  dropped: one owner read an ok row), the rows walk without its code
  compares, the row build without its code gathers;
- the rule's crossovers: the columns against the rows form, each a whole
  call, on the first N rows of the star call, N = T/32 .. T; and on
  tables of 2^20 to 2^24 slots with 1, 2 or 4 code columns (0.3 T build
  rows, N = T probe rows of chip_smoke's mix: hits, near misses,
  misses, 15% not ok), where the owner table and the build columns
  leave the L2.

Times are chip_smoke.device_ms: the median of 20 calls queued behind a
spin kernel. The bound is chip_smoke's: the bytes the walk must read
(each input it needs once, the owner and code sectors it touches once)
over 3.35 TB/s.
"""

from __future__ import annotations

import re

import torch

from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.workloads import profiling
from bodo_tpu_torch.workloads.rank_sum_sweep import build_all

# (kWalks, kThreads) of the rows form
WALK_VARIANTS = ((1, 256), (2, 256), (4, 256), (1, 128), (1, 512),
                 (2, 128))
# tables of the columns-against-rows comparison over table sizes
TABLE_SIZES = (1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24)
# diagnostic variants: (tag, forced form, replacement in the source)
PROBES = {
    "owner reads only (columns walk, compares dropped)": (
        "probe_owner", 0,
        ("      if (j0 + t < W && j0 + t < n_codes) eq &= b[t] == "
         "key[j0 + t];",
         "      if (t < 0) eq &= b[t] == key[j0 + t];")),
    "rows walk without code compares": (
        "probe_nocmp", 2,
        ("          for (int j = 0; j < W; ++j) eq &= row[k].word(j + 1) == "
         "key[k][j];",
         "          for (int j = 0; j < 0; ++j) eq &= row[k].word(j + 1) == "
         "key[k][j];")),
    "rows form without code gathers in the row build": (
        "probe_nogather", 2,
        ("  return (o >= 0 && wi - 1 < n_codes) ? code(b, wi - 1, o) : 0ull;",
         "  return 0ull;")),
}
# the row build with a thread storing its whole row (kQ 16-byte stores a
# row-width apart, each half a 32-byte sector at a 32-byte row) in place
# of one quad a thread
ROW_STORES = (
    "    rows[q] = row_quad((int)(q % kQ), __ldg(owner + q / kQ), b, "
    "n_codes);",
    "    if (q < T) {\n"
    "      const int32_t o = __ldg(owner + q);\n"
    "      for (int k = 0; k < kQ; ++k)\n"
    "        rows[q * kQ + k] = row_quad(k, o, b, n_codes);\n"
    "    }")


class Variant:
    """A hash_probe build, called with the wrapper's own arguments and, for
    a form the rule would not pick, scratch sized by this build."""

    def __init__(self, lib):
        args = CK._ENTRIES["hash_probe"][1]
        self.fn = lib.hash_probe_launch
        self.fn.argtypes, self.fn.restype = args, CK._I
        self.phase_fn = lib.hash_probe_phase_launch
        self.phase_fn.argtypes = [*args[:-1], CK._I, CK._P]
        self.phase_fn.restype = CK._I
        self.size = lib.hash_probe_scratch_bytes
        self.size.argtypes = [CK._I64, CK._I64, CK._I, CK._I64]
        self.size.restype = CK._I64
        self.form_fn = lib.hash_probe_form
        self.form_fn.argtypes = [CK._I64, CK._I64, CK._I]
        self.form_fn.restype = CK._I

    def prepare(self, args):
        bcodes, owner, pcodes, ok, h, step, T, rounds = args
        call, idx, flag, scratch = CK._hash_probe_call(
            tuple(bcodes), owner, tuple(pcodes), ok, h, step, T, rounds,
            ok.device)
        n, n_codes = ok.shape[0], len(pcodes)
        nbytes = self.size(n, T, n_codes, bcodes[0].shape[0])
        if nbytes and (scratch is None or scratch.numel() < nbytes):
            scratch = torch.empty(nbytes, dtype=torch.uint8,
                                  device=ok.device)
            call = (*call[:10], scratch.data_ptr(), *call[11:])
        return call, idx, flag, scratch

    def form(self, args) -> str:
        return CK.HASH_PROBE_FORMS[self.form_fn(
            args[3].shape[0], args[6], len(args[2]))]

    def __call__(self, args):
        call, idx, flag, _scratch = self.prepare(args)
        rc = self.fn(*call, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"hash_probe variant launch failed: {rc}")
        return idx, flag[0] != 0


def star_call():
    """The hash_probe call of one star pipeline run at chip_smoke's size."""
    import chip_smoke as cs
    from bodo_tpu_torch.workloads import star_join as S
    fact_np, dim_np = S.gen_star_arrays(cs.STAR_ROWS, seed=cs.SEED)
    fact, dim = S.tables_from_arrays(fact_np, dim_np)
    with cs._Capture("hash_probe") as probe:
        S.pipeline(fact, dim)
    return probe.calls[0]


def main() -> None:
    import chip_smoke as cs
    print(profiling.card())
    variants = [("hash_probe", f"probe_{w}x{t}",
                 {"kWalks": w, "kThreads": t}, None)
                for w, t in WALK_VARIANTS]
    variants += [("hash_probe", "probe_columns", {"kForceForm": 0}, None),
                 ("hash_probe", "probe_rows", {"kForceForm": 2}, None)]
    variants += [("hash_probe", tag, {"kForceForm": f}, rep)
                 for tag, f, rep in PROBES.values()]
    variants += [("hash_probe", "build_rowwise", {"kForceForm": 2},
                  ROW_STORES)]
    built = build_all(variants)
    libs = {tag: (Variant(lib), regs) for tag, (lib, regs) in built.items()}

    args = star_call()
    bcodes, owner, pcodes, ok, h, step, T, rounds = args
    n, n_codes = ok.shape[0], len(pcodes)
    want = CK.hash_probe_plain(*args)
    streamed, n_rounds, compares, owner_sectors, code_sectors = \
        cs.probe_walk(*args)
    bound = ((streamed + 32 * owner_sectors + 32 * code_sectors)
             / cs.HBM_BYTES_PER_S * 1e3)
    shape = (f"T={T} N={n} ok_rows={int(ok.sum())} n_codes={n_codes} "
             f"mean_rounds={n_rounds / max(int(ok.sum()), 1):.6f}")
    print(f"hash_probe sweep on the star call: {shape} "
          f"bound_ms={bound:.6f}")

    def hold(fn, a, label):
        idx, un = fn(a)
        torch.cuda.synchronize()
        w = want if a is args else CK.hash_probe_plain(*a)
        if not (torch.equal(idx, w[0]) and bool(un) == bool(w[1])):
            raise AssertionError(f"hash_probe {label} differs from its "
                                 f"plain version")

    def report(label, ms, regs, held=True):
        used = [int(x) for r in regs for x in re.findall(r"Used (\d+) reg", r)]
        print(f"hash_probe {label}: kernel_ms={ms:.6f} bound_ms="
              f"{bound:.6f} ({bound / ms:.1%} of the bound) "
              f"bit_identical={held or 'not held'} registers {used}")

    for w, t in WALK_VARIANTS:
        fn, regs = libs[f"probe_{w}x{t}"]
        hold(fn, args, f"walks={w} threads={t}")
        report(f"{fn.form(args)} form walks={w} threads={t}",
               cs.device_ms(lambda: fn(args)), regs)

    cols, cregs = libs["probe_columns"]
    hold(cols, args, "columns form")
    report("columns form (owner table + column-major codes)",
           cs.device_ms(lambda: cols(args)), cregs)
    aos = torch.stack(tuple(bcodes), 1).contiguous()
    stack_ms = cs.device_ms(lambda: torch.stack(tuple(bcodes), 1))
    row_args = (tuple(aos[:, j] for j in range(n_codes)), *args[1:])
    hold(cols, row_args, "columns form over build-row-ordered codes")
    aos_ms = cs.device_ms(lambda: cols(row_args))
    report(f"columns form over build-row-ordered code rows ([bcap, "
           f"n_codes], their copy torch.stack {stack_ms:.6f} ms not "
           f"included; with it {aos_ms + stack_ms:.6f})", aos_ms, cregs)
    del aos, row_args

    stream = torch.cuda.current_stream().cuda_stream

    def phases(fn, label):
        call, _idx, _flag, scratch = fn.prepare(args)
        for phase, what in ((1, "row build alone"), (2, "walk alone")):
            ms = cs.device_ms(lambda: fn.phase_fn(*call, phase, stream))
            print(f"hash_probe rows form ({label}), {what}: kernel_ms="
                  f"{ms:.6f} (scratch {scratch.numel()} bytes)")

    phases(libs["probe_rows"][0], "one 16-byte quad a thread")
    fn, regs = libs["build_rowwise"]
    hold(fn, args, "rows form, a thread storing its whole row")
    report("rows form, row build with a thread storing its whole row",
           cs.device_ms(lambda: fn(args)), regs)
    phases(fn, "a thread storing its whole row")
    for label, (tag, _f, _r) in PROBES.items():
        fn, regs = libs[tag]
        report(label, cs.device_ms(lambda: fn(args)), regs, held=False)
    phases(libs["probe_nogather"][0], "no code gathers")

    rows_fn, rregs = libs["probe_rows"]
    for div in (32, 16, 8, 4, 2, 1):
        m = min(T // div, n)
        sub = (bcodes, owner, tuple(c[:m] for c in pcodes), ok[:m], h[:m],
               step[:m], T, rounds)
        hold(cols, sub, f"columns form N={m}")
        hold(rows_fn, sub, f"rows form N={m}")
        c_ms = cs.device_ms(lambda: cols(sub))
        r_ms = cs.device_ms(lambda: rows_fn(sub))
        print(f"hash_probe crossover N={m} (T/{div}) T={T}: columns_ms="
              f"{c_ms:.6f} rows_ms={r_ms:.6f} rule="
              f"{CK.hash_probe_form(m, T, n_codes)}")
    del want, sub

    # the columns against the rows form over table sizes, N = T probe
    # rows (chip_smoke's mix), 0.3 T build rows
    g = torch.Generator(device=ok.device).manual_seed(cs.SEED + 2)
    for T in TABLE_SIZES:
        for n_codes in (1, 2, 4):
            bcodes, owner = cs._probe_case(ok.device, g, T, n_codes,
                                           int(0.3 * T))
            pcodes, pok, ph, pstep = cs._probe_rows(ok.device, g, bcodes, T,
                                                    T)
            sub = (bcodes, owner, pcodes, pok, ph, pstep, T, rounds)
            hold(cols, sub, f"columns form T={T} n_codes={n_codes}")
            hold(rows_fn, sub, f"rows form T={T} n_codes={n_codes}")
            c_ms = cs.device_ms(lambda: cols(sub))
            r_ms = cs.device_ms(lambda: rows_fn(sub))
            print(f"hash_probe table size T={T} n_codes={n_codes} N={T} "
                  f"build_rows={int(0.3 * T)}: columns_ms={c_ms:.6f} "
                  f"rows_ms={r_ms:.6f} rule="
                  f"{CK.hash_probe_form(T, T, n_codes)}")
            del bcodes, owner, pcodes, pok, ph, pstep, sub


if __name__ == "__main__":
    main()
