"""The range_partition kernel of this checkout against another checkout's,
on every call the 1D paths make and at chip_smoke.py's check size.

    python -m bodo_tpu_torch.workloads.range_partition_ab --other DIR

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive` into a directory that
.gitignore lists). Its ops/cuda_kernels.py is loaded under another name
and builds its own csrc/range_partition.cu into DIR/build. Run from this
checkout's root on a machine with one NVIDIA GPU and nvcc.

The calls are captured from one run of each 1D path at chip_smoke.py's
sizes: the taxi pipeline and the star join with shard=True (the sample
sort's pass, one call over its 4 shards). The other checkout's wrapper
takes one shard a call, so it runs as the sort called it before: a call
a shard, then torch.cat (one shard: the call alone). On each call both
are held bit-identical to this checkout's plain version, then timed in
turns (other, this, this, other) with chip_smoke.device_ms, warm and
with the L2 flushed before each call, beside torch.searchsorted batched
over the shards. Then one shard of the taxi pass alone, and 5,000,000
random keys with 1, 3 and 4095 splitters, the same way.
"""

from __future__ import annotations

import argparse

import torch

from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.workloads import profiling
from bodo_tpu_torch.workloads.hash_probe_ab import load_other


def path_calls():
    """{path: the range_partition calls of one run} at chip_smoke's
    sizes."""
    import chip_smoke as cs
    from bodo_tpu_torch.workloads import star_join as S
    from bodo_tpu_torch.workloads import taxi as TX
    out = {}
    trips, weather = TX.tables_from_arrays(*TX.gen_taxi_arrays(
        cs.MAIN_ROWS, seed=cs.SEED))
    with cs._Capture("range_partition") as rp:
        TX.pipeline(trips, weather, shard=True, n_shards=cs.SHARDS)
    out["taxi 1D"] = rp.calls
    del trips, weather
    fact, dim = S.tables_from_arrays(*S.gen_star_arrays(cs.STAR_ROWS,
                                                        seed=cs.SEED))
    with cs._Capture("range_partition") as rp:
        S.pipeline(fact, dim, shard=True, n_shards=cs.SHARDS)
    out["star 1D"] = rp.calls
    return out


def compare(other, pks, spl, label: str) -> None:
    """Hold both kernels on one call, then time them in turns."""
    import chip_smoke as cs
    pks = tuple(pks)
    rows = [spl[j] for j in range(len(pks))]
    want = CK.range_partition_plain(pks, spl)

    def theirs():
        if len(pks) == 1:  # one shard: the call alone, no concatenation
            return other.range_partition(pks[0], rows[0])
        return torch.cat([other.range_partition(p, r)
                          for p, r in zip(pks, rows)])

    def ours():
        return CK.range_partition(pks, spl)

    flipped_pk = torch.stack([p ^ CK._SIGN64 for p in pks])
    flipped_spl = (spl ^ CK._SIGN64).contiguous()

    def library():
        return torch.searchsorted(flipped_spl, flipped_pk, right=True,
                                  out_int32=True)

    got = (theirs(), ours())
    torch.cuda.synchronize()
    if not all(torch.equal(g, want) for g in got):
        raise AssertionError(f"{label}: a kernel differs from the plain "
                             f"version")
    s, n, n_spl = len(pks), pks[0].shape[0], spl.shape[1]
    bound = cs.range_bound_ms(s, n, n_spl)
    for flush in (False, True):
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            fn = theirs if side == "other" else ours
            times[side].append(cs.device_ms(fn, flush=flush))
        lib_ms = cs.device_ms(library, flush=flush)
        best = min(times["this"])
        print(f"range_partition {label} S={s} N={n} a shard n_spl={n_spl} "
              f"{'flushed' if flush else 'warm'}: bit_identical=True "
              f"other_ms (a launch a shard + torch.cat)={times['other']} "
              f"this_ms (one launch)={times['this']} "
              f"searchsorted_ms={lib_ms:.6f} bound_ms={bound:.6f} "
              f"({bound / best:.1%} of it)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    args = ap.parse_args()
    import chip_smoke as cs
    from pathlib import Path
    print(profiling.card())
    other = load_other(Path(args.other).resolve())
    other.build(["range_partition"])
    calls = path_calls()
    for path, found in calls.items():
        for j, (pks, spl) in enumerate(found):
            compare(other, pks, spl, f"{path} call {j + 1} of {len(found)}")
    pks, spl = calls["taxi 1D"][0]
    compare(other, tuple(pks)[:1], spl[:1], "one shard of the taxi 1D call")
    del calls
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    pk = torch.randint(-(1 << 63), (1 << 63) - 1, (cs.SHARD_ROWS,),
                       generator=g, device=dev, dtype=torch.int64)
    for m in (1, cs.SHARDS - 1, 4095):
        compare(other, [pk], cs.range_rows(g, [pk], m), "random keys")


if __name__ == "__main__":
    main()
