"""The hash_probe kernel of this checkout against another checkout's, on
every call the main paths make.

    python -m bodo_tpu_torch.workloads.hash_probe_ab --other DIR

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive` into a directory that
.gitignore lists). Its ops/cuda_kernels.py is loaded under another name
and builds its own csrc/hash_probe.cu into DIR/build. Run from this
checkout's root on a machine with one NVIDIA GPU and nvcc.

The calls are captured from one run of each path at chip_smoke.py's
sizes: the star join (REP), the star join with shard=True (the shuffle
join's calls, one a shard) and the taxi pipeline with shard=True (the
broadcast join's calls, one a shard). On each call both kernels are held
bit-identical to this checkout's plain version, then timed in turns
(other, this, this, other) with chip_smoke.device_ms. The other
checkout's wrapper takes the code columns stacked ([n_codes, N]
tensors, as it was called before they were passed as columns); the
stacks are made before the timing, and their copy is timed apart.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import torch

from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.workloads import profiling


def load_other(root: Path):
    """The other checkout's cuda_kernels module."""
    path = root / "bodo_tpu_torch" / "ops" / "cuda_kernels.py"
    spec = importlib.util.spec_from_file_location("other_cuda_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_calls():
    """{path: the hash_probe calls of one run} at chip_smoke's sizes."""
    import chip_smoke as cs
    from bodo_tpu_torch.workloads import star_join as S
    from bodo_tpu_torch.workloads import taxi as TX
    out = {}
    fact, dim = S.tables_from_arrays(*S.gen_star_arrays(cs.STAR_ROWS,
                                                        seed=cs.SEED))
    with cs._Capture("hash_probe") as probe:
        S.pipeline(fact, dim)
    out["star"] = probe.calls
    with cs._Capture("hash_probe") as probe:
        S.pipeline(fact, dim, shard=True, n_shards=cs.SHARDS)
    out["star 1D"] = probe.calls
    del fact, dim
    trips, weather = TX.tables_from_arrays(*TX.gen_taxi_arrays(
        cs.MAIN_ROWS, seed=cs.SEED))
    with cs._Capture("hash_probe") as probe:
        TX.pipeline(trips, weather, shard=True, n_shards=cs.SHARDS)
    out["taxi 1D"] = probe.calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args()
    import chip_smoke as cs
    print(profiling.card())
    other = load_other(args.other.resolve())
    other.build(["hash_probe"])
    for path, calls in path_calls().items():
        for j, call in enumerate(calls):
            bcodes, owner, pcodes, ok, h, step, T, rounds = call
            stacked = (torch.stack(tuple(bcodes)), owner,
                       torch.stack(tuple(pcodes)), ok, h, step, T, rounds)
            want = CK.hash_probe_plain(*call)
            got = (other.hash_probe(*stacked), CK.hash_probe(*call))
            torch.cuda.synchronize()
            same = all(torch.equal(g[0], want[0])
                       and bool(g[1]) == bool(want[1]) for g in got)
            if not same:
                raise AssertionError(f"{path} call {j + 1}: a kernel "
                                     f"differs from the plain version")
            times = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                fn = ((lambda: other.hash_probe(*stacked)) if side == "other"
                      else (lambda: CK.hash_probe(*call)))
                times[side].append(cs.device_ms(fn))
            stack_ms = cs.device_ms(
                lambda: (torch.stack(tuple(bcodes)),
                         torch.stack(tuple(pcodes))))
            n, n_codes = ok.shape[0], len(pcodes)
            print(f"hash_probe {path} call {j + 1} of {len(calls)}: N={n} "
                  f"T={T} n_codes={n_codes} form="
                  f"{CK.hash_probe_form(n, T, n_codes)} bit_identical=True "
                  f"other_ms={times['other']} this_ms={times['this']} "
                  f"stack_ms={stack_ms:.6f}")
            del stacked, want, got


if __name__ == "__main__":
    main()
