"""Where the time of the 1D join family's queries goes on one GPU.

    python -m bodo_tpu_torch.workloads.join_family_profile [--rows N]
        [--shards S] [--reps R] [--out build/join_family_profile.json]

Runs the queries of workloads/join_family.py on `--shards` shards at
`--rows` star fact rows (the dimension a quarter) and as many taxi trip
rows: the skewed star with the skew split and with it off, the star
against the half dimension with the memory governor on (broadcast) and
off (shuffle), the quarter union with the taxi pipeline, the cross join
with its groupby. For each, after a warm-up run: the median wall of
`--reps` runs, the synchronized wall of each relational stage and of the
join's parts (the skew split, the shuffle join, the key shuffle, the
hash build and probe, the append, concat_tables, the cross join), and
one run under torch.profiler (device time by operator and kernel, the
device's busy share). Needs a CUDA device; prints a summary and writes
the numbers as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

_STAGES = ("filter_table", "join_tables", "assign_columns", "groupby_agg",
           "sort_table", "concat_tables")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/join_family_profile.json")
    args = ap.parse_args()

    import torch

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.ops import hashtable as HT
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.plan import adaptive
    from bodo_tpu_torch.plan import streaming_sharded as SS
    from bodo_tpu_torch.workloads import join_family as JF
    from bodo_tpu_torch.workloads import profiling as P
    from bodo_tpu_torch.workloads import star_join as S
    from bodo_tpu_torch.workloads import taxi as T

    if not torch.cuda.is_available():
        raise SystemExit("join_family_profile needs a CUDA device")
    card = P.card()
    fact_np, dim_np = S.gen_star_arrays(args.rows, seed=JF.SEED)
    fact, dim = S.tables_from_arrays(fact_np, dim_np)
    skew = S.tables_from_arrays(JF.skewed_fact(fact_np, dim_np), dim_np)[0]
    del fact_np
    trips, weather = T.tables_from_arrays(
        *T.gen_taxi_arrays(args.rows, seed=JF.SEED))
    substages = [
        (adaptive, "try_skew_split_join", "join: skew split"),
        (R, "_join_sharded", "join: _join_sharded"),
        (R, "shuffle_by_key", "join: shuffle_by_key"),
        (HT, "claim_slots", "join: hash build (claim_slots)"),
        (HT, "probe_slots", "join: probe (probe_slots)"),
        (SS, "append_sharded", "join: append_sharded"),
        (R, "_cross_join", "join: _cross_join")]

    def setting(**fields):
        saved = {k: getattr(config, k) for k in fields}

        def enter():
            for k, v in fields.items():
                setattr(config, k, v)

        def leave():
            for k, v in saved.items():
                setattr(config, k, v)
        return enter, leave

    results = {}
    with use_mesh(make_mesh(args.shards, fact.device)):
        fact1, dim1, skew1 = fact.shard(), dim.shard(), skew.shard()
        quarters = [q.shard() for q in JF.quarter_tables(trips)]
        scen = JF.scenario_table(fact.device)
        queries = (
            ("star skewed, split", lambda: S._pipeline(skew1, dim1),
             setting(mem_governor=False)),
            ("star skewed, no split", lambda: S._pipeline(skew1, dim1),
             setting(mem_governor=False, aqe_skew_min_rows=1 << 62)),
            ("star half dimension, governor on (broadcast)",
             lambda: JF.star_filtered_dim(fact1, dim1),
             setting(mem_governor=True)),
            ("star half dimension, governor off (shuffle)",
             lambda: JF.star_filtered_dim(fact1, dim1),
             setting(mem_governor=False)),
            ("union of the quarters, taxi pipeline",
             lambda: JF.union_pipeline(quarters, weather), setting()),
            ("cross join, groupby", lambda: JF.cross_pipeline(
                JF.cross_product(dim1, scen)), setting()))
        for label, run, (enter, leave) in queries:
            enter()
            try:
                R.reset_route_counts()
                run()  # warm-up: allocator, library handles
                routes = {k: v for k, v in R.route_counts.items() if v}
                walls = P.wall_times(run, args.reps)
                stages = P.stage_means(run, args.reps,
                                       [(R, n) for n in _STAGES], substages)
                res = {"card": card, "rows": args.rows,
                       "shards": args.shards, "routes": routes,
                       "pipeline_wall_s": walls,
                       "pipeline_wall_s_median": statistics.median(walls),
                       "stage_wall_s": {k: v for k, v in stages.items()
                                        if v},
                       **P.trace(run)}
            finally:
                leave()
            print(f"== {label}: routes {routes}")
            P.report(res)
            results[label] = res
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
