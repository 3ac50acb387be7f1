"""Where the time of the star-schema join goes on one GPU.

    python -m bodo_tpu_torch.workloads.star_profile [--rows N] [--seed S]
        [--out build/star_profile.json]

Runs the star pipeline (workloads/star_join.py) at `--rows` fact rows
once to warm up, then (1) times each relational stage — filter_table,
join_tables, assign_columns, groupby_agg, sort_table — on the host clock
with a device synchronize around it, over `--reps` runs, and inside the
join its hash build (claim_slots) and its probe (probe_slots, the
hash_probe kernel); (2) traces one more run with torch.profiler for the
device time by operator and by kernel and the device's busy share. Needs
a CUDA device; prints a summary and writes the numbers as JSON to
`--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

_STAGES = ("filter_table", "join_tables", "assign_columns", "groupby_agg",
           "sort_table")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/star_profile.json")
    args = ap.parse_args()

    import torch

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import hashtable as HT
    from bodo_tpu_torch.workloads import profiling as P
    from bodo_tpu_torch.workloads import star_join as S

    if not torch.cuda.is_available():
        raise SystemExit("star_profile needs a CUDA device")
    card = P.card()
    fact, dim = S.tables_from_arrays(*S.gen_star_arrays(args.rows,
                                                        seed=args.seed))

    def run():
        return S.pipeline(fact, dim)

    run()  # warm-up: allocator, library handles
    walls = P.wall_times(run, args.reps)
    stages = P.stage_means(
        run, args.reps, [(R, n) for n in _STAGES],
        [(HT, "claim_slots", "join: hash build (claim_slots)"),
         (HT, "probe_slots", "join: probe (probe_slots)")])
    result = {"card": card, "rows": args.rows, "dim_rows": dim.nrows,
              "seed": args.seed, "pipeline_wall_s": walls,
              "pipeline_wall_s_median": statistics.median(walls),
              "stage_wall_s": stages, **P.trace(run)}
    P.report(result)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
