"""Where the time of the window functions goes on one GPU.

    python -m bodo_tpu_torch.workloads.windows_profile [--n-orders N]
        [--taxi-rows N] [--seed S] [--reps R] [--shards S]
        [--out build/windows_profile.json]

Three groups of runs, each warmed up once, then timed over `--reps`
runs on the host clock with a device synchronize around each, its
stages and substages timed over `--reps` more (profiling.stage_means:
each call synchronized; a substage's time is also part of its stage's),
and one run traced with torch.profiler for the device time by operator
and kernel and the device's busy share:

  1. workloads/windows.WINDOW_SQL through BodoSQLContext.sql(q)
     .to_pandas() on gen_tpch(n_orders=N) (scale factor 1 by default);
     stages: planning (ctx.sql), rank_window, agg_window, groupby_agg,
     sort_table; substages: the sorted pass (ops/window._sorted_segments),
     the float prefixes (prefix_scan), the sparse tables
     (_minmax_sparse_table);
  2. RANK_SPECS and AGG_SPECS on lineitem on a mesh of `--shards` shards
     of the card; stages: rank_window, agg_window; substages: rowid
     (window_table), shuffle_by_key, the per-shard pass
     (_rank_window_exec, _agg_window_exec), the sample sort back
     (sort_table), reduce_table, the global ranking;
  3. window_table with TABLE_SPECS on the taxi trips (`--taxi-rows`) in
     pickup order, REP and on the shards; substage prefix_scan.

Needs a CUDA device; prints a line per run and writes every number to
`--out` as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics


def _profile(run, reps: int, stages, substages) -> dict:
    import torch

    from bodo_tpu_torch.workloads import profiling as P
    run()  # warm-up
    walls = P.wall_times(run, reps)
    spent = P.stage_means(run, reps, stages, substages)
    torch.cuda.reset_peak_memory_stats()
    traced = P.trace(run)
    rec = {"wall_s": walls, "wall_s_median": statistics.median(walls),
           "stage_wall_s": spent,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **traced}
    return rec


def _line(name: str, rec: dict) -> str:
    top = ", ".join(f"{n} {s * 1e3:.1f}" for n, s in
                    sorted(rec["stage_wall_s"].items(),
                           key=lambda kv: -kv[1]) if s > 0)
    ops = ", ".join(f"{r['op']} {r['ms']:.1f}"
                    for r in rec["top_ops_device_ms"][:4])
    return (f"{name}: wall {rec['wall_s_median']:.4f} s, busy "
            f"{rec['device_busy_share']:.3f}, peak "
            f"{rec['max_memory_allocated'] / 1e9:.2f} GB; ms: {top}; "
            f"device ms: {ops}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-orders", type=int, default=1_500_000)
    ap.add_argument("--taxi-rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--out", default="build/windows_profile.json")
    args = ap.parse_args()

    import torch

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import window as W
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.table import dtypes as dt
    from bodo_tpu_torch.table.table import Column
    from bodo_tpu_torch.workloads import profiling as P
    from bodo_tpu_torch.workloads import taxi as T
    from bodo_tpu_torch.workloads import tpch as TP
    from bodo_tpu_torch.workloads import windows as WN

    if not torch.cuda.is_available():
        raise SystemExit("windows_profile needs a CUDA device")
    card = P.card()
    print(f"card: {card}")
    result = {"card": card, "n_orders": args.n_orders,
              "taxi_rows": args.taxi_rows, "seed": args.seed,
              "shards": args.shards, "sql": {}, "calls": {}, "table": {}}
    window_subs = [(W, "_sorted_segments", "sorted pass"),
                   (W, "prefix_scan", "prefix_scan"),
                   (W, "_minmax_sparse_table", "sparse table")]

    ctx = BodoSQLContext(TP.gen_tpch(n_orders=args.n_orders,
                                     seed=args.seed))
    sql_stages = [(R, "rank_window"), (R, "agg_window"),
                  (R, "groupby_agg"), (R, "sort_table"), (ctx, "sql")]
    for q, sql in WN.WINDOW_SQL.items():
        rec = _profile(lambda: ctx.sql(sql).to_pandas(), args.reps,
                       sql_stages, window_subs)
        rec["stage_wall_s"]["plan"] = rec["stage_wall_s"].pop("sql")
        rec["other_s"] = rec["wall_s_median"] - sum(
            rec["stage_wall_s"][n] for n in ("rank_window", "agg_window",
                                             "groupby_agg", "sort_table",
                                             "plan"))
        result["sql"][q] = rec
        print(_line(q, rec) + f"; other {rec['other_s'] * 1e3:.1f} ms")

    lineitem = ctx._tables["lineitem"].table
    call_stages = [(R, "rank_window"), (R, "agg_window")]
    call_subs = [(R, "window_table", "rowid"),
                 (R, "shuffle_by_key", "shuffle_by_key"),
                 (R, "_rank_window_exec", "rank pass"),
                 (R, "_agg_window_exec", "agg pass"),
                 (R, "sort_table", "sort_table"),
                 (R, "reduce_table", "reduce_table"),
                 (R, "_global_rank_sharded", "global rank")] + window_subs
    with use_mesh(make_mesh(args.shards, lineitem.device)):
        for name, spec in list(WN.RANK_SPECS.items()) + \
                list(WN.AGG_SPECS.items()):
            vals = [s[1] for s in spec[2]] if name in WN.AGG_SPECS else []
            cols = list(dict.fromkeys(spec[0] + spec[1] + vals))
            t = lineitem.select(cols).shard()
            rec = _profile(lambda: WN.run_call(R, t, name), args.reps,
                           call_stages, call_subs)
            result["calls"][name] = rec
            print(_line(f"1D {name}", rec))
    del ctx, lineitem

    trips, _ = T.tables_from_arrays(*T.gen_taxi_arrays(args.taxi_rows,
                                                       seed=args.seed))
    src = R.sort_table(trips.select(["pickup_datetime", "trip_miles"]),
                       ["pickup_datetime"])
    src.columns["near_one"] = Column(
        1.0 + (src.column("trip_miles").data - 5.0) * 2e-8, None,
        dt.FLOAT64)
    del trips
    for label, shard in (("REP", False), ("1D", True)):
        mesh = use_mesh(make_mesh(args.shards, src.device)) if shard \
            else contextlib.nullcontext()
        with mesh:
            t = src.shard() if shard else src
            rec = _profile(lambda: R.window_table(t, WN.TABLE_SPECS),
                           args.reps, [(R, "window_table")],
                           [(W, "prefix_scan", "prefix_scan")])
        result["table"][label] = rec
        print(_line(f"window_table {label}", rec))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
