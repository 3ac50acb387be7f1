"""Where the time of a pipeline goes on one GPU: the machinery the
workload profiles (taxi_profile.py, star_profile.py) share.

`stage_timer` wraps relational entry points so each call adds its
synchronized wall time to a stage; `trace` runs the pipeline once under
torch.profiler for the device time by operator and by kernel and the
device's busy share; `card` names the GPU and its power limit. All of it
needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, List, Sequence, Tuple


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def wall_times(run: Callable[[], object], reps: int) -> List[float]:
    """Synchronized host-clock wall of `reps` runs."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def stage_timer(stages: Sequence[Tuple[object, str]],
                substages: Sequence[Tuple[object, str, str]],
                spent: Dict[str, float]) -> Callable[[], None]:
    """Wrap `module.name` for each stage so its outermost call adds its
    synchronized wall time to `spent[name]`; a stage called inside another
    stage counts toward the outer one only. Each (module, name, label)
    substage is timed into `spent[label]` whenever it runs, also inside a
    stage (its time is then part of that stage's too). Returns a function
    that restores the originals."""
    import torch
    depth = [0]
    originals = []

    def wrap(fn, label, shared):
        own = [0]

        def timed(*a, **k):
            counter = depth if shared else own
            if counter[0]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counter[0] += 1
            try:
                return fn(*a, **k)
            finally:
                counter[0] -= 1
                torch.cuda.synchronize()
                spent[label] += time.perf_counter() - t0
        return timed

    targets = [(m, n, n, True) for m, n in stages] + \
        [(m, n, label, False) for m, n, label in substages]
    for module, name, label, shared in targets:
        fn = getattr(module, name)
        originals.append((module, name, fn))
        setattr(module, name, wrap(fn, label, shared))

    def restore():
        for module, name, fn in reversed(originals):
            setattr(module, name, fn)
    return restore


def stage_means(run: Callable[[], object], reps: int, stages, substages
                ) -> Dict[str, float]:
    """Mean synchronized wall seconds per stage and substage over `reps`
    runs."""
    from collections import defaultdict
    spent: Dict[str, float] = defaultdict(float)
    restore = stage_timer(stages, substages, spent)
    try:
        for _ in range(reps):
            run()
    finally:
        restore()
    names = [n for _, n in stages] + [label for _, _, label in substages]
    return {n: spent[n] / reps for n in names}


# symbols of the port's own CUDA kernels (bodo_tpu_torch/csrc)
PORT_KERNELS = ("lut_gather_kernel", "hash_probe_build_rows",
                "hash_probe_walk", "rank_small", "rank_general",
                "range_partition_small", "range_partition_large",
                "hybrid_expand_kernel",
                "groupby_sum_tile")


def trace(run: Callable[[], object]) -> dict:
    """One run under torch.profiler: its wall, the device time by operator
    and by kernel (the port's own kernels listed apart), and the device's
    busy share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    return {
        "traced_wall_s": traced_wall, "device_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / traced_wall,
        "top_ops_device_ms": [{"op": k, "ms": ms, "calls": c}
                              for k, ms, c in ops[:25]],
        "top_kernels_ms": [{"kernel": k[:200], "ms": ms, "calls": c}
                           for k, ms, c in kernels[:25]],
        "port_kernels_ms": [{"kernel": k[:200], "ms": ms, "calls": c}
                            for k, ms, c in kernels
                            if any(p in k for p in PORT_KERNELS)],
    }


def report(result: dict) -> None:
    """Print a profile's summary."""
    walls = result["pipeline_wall_s"]
    print(f"card: {result['card']}")
    print(f"pipeline wall s (median of {len(walls)}): "
          f"{statistics.median(walls):.6f}  all: {walls}")
    for n, s in result["stage_wall_s"].items():
        print(f"  stage {n}: {s:.6f} s")
    print(f"traced run: wall {result['traced_wall_s']:.6f} s, device busy "
          f"{result['device_ms']:.3f} ms "
          f"({result['device_busy_share']:.3f})")
    print("device time by operator:")
    for r in result["top_ops_device_ms"][:15]:
        print(f"  {r['ms']:10.3f} ms  x{r['calls']:<5} {r['op']}")
    print("device time by kernel:")
    for r in result["top_kernels_ms"][:10]:
        print(f"  {r['ms']:10.3f} ms  x{r['calls']:<5} {r['kernel'][:100]}")
    print("device time of the port's CUDA kernels:")
    for r in result["port_kernels_ms"]:
        print(f"  {r['ms']:10.3f} ms  x{r['calls']:<5} {r['kernel'][:100]}")
