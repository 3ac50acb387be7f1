"""Where the time of the aggregations on the taxi pipeline's joined table
goes on one GPU.

    python -m bodo_tpu_torch.workloads.taxi_aggs_profile [--rows N]
        [--seed S] [--shards N] [--out build/taxi_aggs_profile.json]

Builds the joined table (workloads/taxi.py `joined`; on a mesh of
`--shards` shards of the card when N >= 2), then for each stage —
groupby_agg with taxi_aggs.WIDE_AGGS, with the pipeline's count/mean
spec, and reduce_table with WIDE_AGGS — runs it once to warm up, times
`--reps` runs on the host clock with a device synchronize around each,
and traces one more with torch.profiler for the device time by operator
and kernel and the device's busy share. Needs a CUDA device; prints a
summary and writes the numbers as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the trips over this many shards (0: REP)")
    ap.add_argument("--out", default="build/taxi_aggs_profile.json")
    args = ap.parse_args()

    import torch

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import profiling as P
    from bodo_tpu_torch.workloads import taxi as T
    from bodo_tpu_torch.workloads import taxi_aggs as A

    if not torch.cuda.is_available():
        raise SystemExit("taxi_aggs_profile needs a CUDA device")
    trips, weather = T.tables_from_arrays(
        *T.gen_taxi_arrays(args.rows, seed=args.seed))
    shard = args.shards >= 2
    mesh = use_mesh(make_mesh(args.shards, trips.device)) if shard \
        else contextlib.nullcontext()
    result = {"card": P.card(), "rows": args.rows, "seed": args.seed,
              "shards": args.shards, "stages": {}}
    print(f"card: {result['card']}")
    with mesh:
        m = T.joined(trips.shard() if shard else trips, weather)
        for name, run in (
                ("groupby_agg wide", lambda: R.groupby_agg(m, T.KEYS,
                                                           A.WIDE_AGGS)),
                ("groupby_agg count/mean",
                 lambda: R.groupby_agg(m, T.KEYS, A.COUNT_MEAN_AGGS)),
                ("reduce_table wide", lambda: A.reduce(m))):
            run()  # warm-up
            walls = P.wall_times(run, args.reps)
            torch.cuda.reset_peak_memory_stats()
            traced = P.trace(run)
            stage = {"wall_s": walls, "wall_s_median": statistics.median(
                walls), "max_memory_allocated":
                torch.cuda.max_memory_allocated(), **traced}
            result["stages"][name] = stage
            print(f"== {name}: wall s median {stage['wall_s_median']:.6f} "
                  f"(all {walls}); traced {traced['traced_wall_s']:.6f} s, "
                  f"device {traced['device_ms']:.3f} ms (busy "
                  f"{traced['device_busy_share']:.3f}); peak "
                  f"{stage['max_memory_allocated']} B")
            for r in traced["top_ops_device_ms"][:8]:
                print(f"  {r['ms']:10.3f} ms  x{r['calls']:<5} {r['op']}")
            for r in traced["top_kernels_ms"][:5]:
                print(f"  {r['ms']:10.3f} ms  x{r['calls']:<5} "
                      f"{r['kernel'][:90]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
