"""Where the time of the NYC-taxi pipeline goes on one GPU.

    python -m bodo_tpu_torch.workloads.taxi_profile [--rows N] [--seed S]
        [--shards N] [--out build/taxi_profile.json]

Runs the pipeline once to warm up, then (1) times each relational stage
on the host clock with a device synchronize around it, over `--reps`
runs, and (2) traces one more run with torch.profiler for the device
time by kernel and the device's busy share of the run. `--shards N`
(N >= 2) runs the 1D pipeline (shard=True) on a mesh of N shards of the
card, and also times the shard copy, the parts of the sharded groupby
and sort, the shuffles and each CUDA kernel. Needs a CUDA device; prints
a summary and writes the numbers as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

_STAGES = ("assign_columns", "join_tables", "assign_categorical",
           "groupby_agg", "sort_table")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shards", type=int, default=0,
                    help="run shard=True on this many shards (0: REP)")
    ap.add_argument("--out", default="build/taxi_profile.json")
    args = ap.parse_args()

    import torch

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.ops import hashtable as HT
    from bodo_tpu_torch.ops import sort as SO
    from bodo_tpu_torch.parallel import shuffle as SH
    from bodo_tpu_torch.table.table import Table
    from bodo_tpu_torch.workloads import profiling as P
    from bodo_tpu_torch.workloads import taxi as T

    if not torch.cuda.is_available():
        raise SystemExit("taxi_profile needs a CUDA device")
    card = P.card()
    trips, weather = T.tables_from_arrays(
        *T.gen_taxi_arrays(args.rows, seed=args.seed))

    shard = args.shards >= 2

    def run():
        return T.pipeline(trips, weather, shard=shard,
                          n_shards=max(args.shards, 1))

    stages = [(R, n) for n in _STAGES]
    substages = []
    if shard:
        stages.append((Table, "shard"))
        substages = [
            (SH, "_groupby_partial", "groupby: partial stage"),
            (SH, "_groupby_combine", "groupby: shuffle + combine"),
            (SO, "_sort_sharded_body", "sort: sample sort"),
            (SH, "shuffle_rows", "shuffle_rows (groupby and sort)"),
            (HT, "claim_slots", "hash claim (claim_slots)"),
            (CK, "hash_probe", "kernel hash_probe"),
            (CK, "partition_rank", "kernel partition_rank"),
            (CK, "range_partition", "kernel range_partition")]
    run()  # warm-up: allocator, library handles
    walls = P.wall_times(run, args.reps)
    stages = P.stage_means(run, args.reps, stages, substages)
    result = {"card": card, "rows": args.rows, "seed": args.seed,
              "shards": args.shards,
              "pipeline_wall_s": walls,
              "pipeline_wall_s_median": statistics.median(walls),
              "stage_wall_s": stages, **P.trace(run)}
    if shard:
        result["range_partition_launches_per_pass"] = \
            range_launches_per_pass(run, CK, SO)
    P.report(result)
    if shard:
        print(f"range_partition launches a sample-sort pass: "
              f"{result['range_partition_launches_per_pass']}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


def range_launches_per_pass(run, CK, SO) -> float:
    """range_partition's kernel launches over the sample sort's passes in
    one more run (a pass is a call of ops/sort._sort_sharded_body)."""
    passes = [0]
    body = SO._sort_sharded_body

    def counted(*a, **k):
        passes[0] += 1
        return body(*a, **k)
    SO._sort_sharded_body = counted
    CK.reset_launches()
    try:
        run()
    finally:
        SO._sort_sharded_body = body
    return CK.launches["range_partition"] / max(passes[0], 1)


if __name__ == "__main__":
    main()
