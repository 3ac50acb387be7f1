"""Where the time of the NYC-taxi pipeline goes on one GPU.

    python -m bodo_tpu_torch.workloads.taxi_profile [--rows N] [--seed S]
        [--out build/taxi_profile.json]

Runs the pipeline once to warm up, then (1) times each relational stage
on the host clock with a device synchronize around it, over `--reps`
runs, and (2) traces one more run with torch.profiler for the device
time by kernel and the device's busy share of the run. Needs a CUDA
device; prints a summary and writes the numbers as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from collections import defaultdict

_STAGES = ("assign_columns", "join_tables", "assign_categorical",
           "groupby_agg", "sort_table")


def _stage_timer(R, spent):
    """Wrap the relational entry points so each outermost call adds its
    synchronized wall time to `spent[name]`."""
    import torch
    depth = [0]
    originals = {n: getattr(R, n) for n in _STAGES}

    def wrap(name, fn):
        def timed(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
        return timed

    for n, fn in originals.items():
        setattr(R, n, wrap(n, fn))
    return originals


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/taxi_profile.json")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.workloads import taxi as T

    if not torch.cuda.is_available():
        raise SystemExit("taxi_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    trips, weather = T.tables_from_arrays(
        *T.gen_taxi_arrays(args.rows, seed=args.seed))
    T.pipeline(trips, weather)  # warm-up: allocator, library handles

    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.pipeline(trips, weather)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    spent = defaultdict(float)
    originals = _stage_timer(R, spent)
    try:
        for _ in range(args.reps):
            T.pipeline(trips, weather)
    finally:
        for n, fn in originals.items():
            setattr(R, n, fn)
    stages = {n: spent[n] / args.reps for n in _STAGES}

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.pipeline(trips, weather)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    # device-side rows (kernels, memcpy, memset) carry the device time;
    # the aten operators that launched them repeat it, so count them apart
    kernels, ops = [], []
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        row = (e.key, e.self_device_time_total / 1e3, e.count)
        (kernels if e.device_type == DeviceType.CUDA else ops).append(row)
    kernels.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)

    result = {
        "card": card, "rows": args.rows, "seed": args.seed,
        "pipeline_wall_s": walls, "pipeline_wall_s_median":
            statistics.median(walls),
        "stage_wall_s": stages,
        "traced_wall_s": traced_wall, "device_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / traced_wall,
        "top_ops_device_ms": [{"op": k, "ms": ms, "calls": c}
                              for k, ms, c in ops[:25]],
        "top_kernels_ms": [{"kernel": k[:200], "ms": ms, "calls": c}
                           for k, ms, c in kernels[:25]],
    }
    print(f"card: {card}")
    print(f"pipeline wall s (median of {args.reps}): "
          f"{result['pipeline_wall_s_median']:.6f}  all: {walls}")
    for n, s in stages.items():
        print(f"  stage {n}: {s:.6f} s")
    print(f"traced run: wall {traced_wall:.6f} s, device busy "
          f"{device_ms:.3f} ms ({result['device_busy_share']:.3f})")
    print("device time by operator:")
    for r in result["top_ops_device_ms"][:15]:
        print(f"  {r['ms']:10.3f} ms  x{r['calls']:<5} {r['op']}")
    print("device time by kernel:")
    for r in result["top_kernels_ms"][:10]:
        print(f"  {r['ms']:10.3f} ms  x{r['calls']:<5} {r['kernel'][:100]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
