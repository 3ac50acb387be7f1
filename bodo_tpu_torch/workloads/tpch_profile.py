"""Where the time of each TPC-H query goes on one GPU.

    python -m bodo_tpu_torch.workloads.tpch_profile [--n-orders N]
        [--seed S] [--reps R] [--queries 1,3,...] [--out F.json]

Registers gen_tpch(n_orders=N, seed=S) (scale factor 1 by default) on a
BodoSQLContext on the card and, for each query the port runs
(workloads/tpch.UNSUPPORTED left out), after one warm-up run: (1) the
synchronized wall of `--reps` runs of ctx.sql(q).to_pandas(); (2) over
`--reps` more runs, the planning (ctx.sql: parse, plan, and the scalar
subqueries it executes) and each relational stage the executor calls,
each on the host clock with a device synchronize around it; the rest of
the wall is the optimizer, the executor's own work and the host decode
of the result; (3) one traced run under torch.profiler: the device time
by operator and kernel and the device's busy share. Needs a CUDA device;
prints a line per query and writes every number to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

_STAGES = ("filter_table", "join_tables", "assign_columns", "groupby_agg",
           "reduce_table", "sort_table", "head_table", "window_table")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-orders", type=int, default=1_500_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--queries", default="")
    ap.add_argument("--out", default="build/tpch_profile.json")
    args = ap.parse_args()

    import torch

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.workloads import profiling as P
    from bodo_tpu_torch.workloads import tpch as TP

    if not torch.cuda.is_available():
        raise SystemExit("tpch_profile needs a CUDA device")
    card = P.card()
    ctx = BodoSQLContext(TP.gen_tpch(n_orders=args.n_orders,
                                     seed=args.seed))
    wanted = ([int(q) for q in args.queries.split(",")] if args.queries
              else sorted(TP.QUERIES))
    stages = [(R, n) for n in _STAGES] + [(ctx, "sql")]
    result = {"card": card, "n_orders": args.n_orders, "seed": args.seed,
              "queries": {}}
    print(f"card: {card}")
    for q in wanted:
        if q in TP.UNSUPPORTED:
            continue
        sql = TP.QUERIES[q]

        def run():
            return ctx.sql(sql).to_pandas()

        run()  # warm-up
        walls = P.wall_times(run, args.reps)
        spent = P.stage_means(run, args.reps, stages, [])
        spent["plan"] = spent.pop("sql")
        rec = {"wall_s": walls, "wall_s_median": statistics.median(walls),
               "stage_wall_s": spent, **P.trace(run)}
        rec["other_s"] = rec["wall_s_median"] - sum(spent.values())
        result["queries"][q] = rec
        top = ", ".join(f"{n} {s * 1e3:.1f}" for n, s in
                        sorted(spent.items(), key=lambda kv: -kv[1])[:4])
        ops = ", ".join(f"{r['op']} {r['ms']:.1f}"
                        for r in rec["top_ops_device_ms"][:3])
        print(f"Q{q}: wall {rec['wall_s_median']:.4f} s, busy "
              f"{rec['device_busy_share']:.3f}; ms: {top}, other "
              f"{rec['other_s'] * 1e3:.1f}; device ms: {ops}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
