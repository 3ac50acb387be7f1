#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bodo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from bodo_tpu_torch/csrc (one nvcc
per source, all started together), then:

  1. holds each kernel against its plain PyTorch version on the card
     (bit-identical for lut_gather) and times both, and the PyTorch call
     that computes the same function, at the shape the main path gives it;
  2. drives the main path — the NYC-taxi relational pipeline at
     20,000,000 trip rows (about one month of NYC HVFHV trips), made from
     seed 0 — with the route and launch counts set to 0 just before it
     and read just after, and checks the result against the numpy oracle
     (keys and counts exact, avg_miles within rtol 1e-9: float64 sums
     accumulated with atomics, in another order);
  3. runs the same pipeline at 20,000 rows, which takes the packed/hashed
     groupby route, against the oracle.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing any result. The last line is one JSON object
naming the device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

MAIN_ROWS = 20_000_000
SMALL_ROWS = 20_000
SEED = 0
AVG_RTOL = 1e-9
# H100 SXM device-memory bandwidth (NVIDIA data sheet), for bound_ms
HBM_BYTES_PER_S = 3.35e12


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of `fn`, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_lut_gather(dev):
    """Phase 1 for lut_gather: bit-identity at every shape, times at the
    main path's shape (K=182 date slots, N=20M probe rows)."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0
    for k in (1, 182, 4096):
        lut = torch.randint(-1, 1 << 30, (k,), generator=g, device=dev,
                            dtype=torch.int32)
        for n in (1, 511, 513, MAIN_ROWS):
            codes = torch.randint(0, k, (n,), generator=g, device=dev,
                                  dtype=torch.int32)
            got = CK.lut_gather(codes, lut)
            want = CK.lut_gather_plain(codes, lut)
            torch.cuda.synchronize()
            diff = int((got.long() - want.long()).abs().max())
            same = bool(torch.equal(got, want))
            print(f"lut_gather K={k} N={n}: bit_identical={same} "
                  f"max_abs_diff={diff}")
            if not same:
                raise AssertionError(f"lut_gather differs from its plain "
                                     f"version at K={k} N={n}")
            worst = max(worst, diff)
    k, n = 182, MAIN_ROWS
    lut = torch.randint(-1, n, (k,), generator=g, device=dev,
                        dtype=torch.int32)
    codes = torch.randint(0, k, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    kernel_ms = time_ms(lambda: CK.lut_gather(codes, lut))
    plain_ms = time_ms(lambda: CK.lut_gather_plain(codes, lut))
    library_ms = time_ms(lambda: lut[codes])
    kernel_ms_again = time_ms(lambda: CK.lut_gather(codes, lut))
    nbytes = 4 * n + 4 * n + 4 * k  # codes read, output written, LUT read
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"lut_gather timing K={k} N={n}: kernel_ms={kernel_ms:.6f} "
          f"(again {kernel_ms_again:.6f}) plain_ms={plain_ms:.6f} "
          f"library_ms(lut[codes])={library_ms:.6f} bound_ms={bound_ms:.6f} "
          f"({nbytes} bytes at {HBM_BYTES_PER_S / 1e12} TB/s)")
    return {"name": "lut_gather", "route": "cuda",
            "source": "bodo_tpu_torch/csrc/lut_gather.cu",
            "replaces": "bodo_tpu/ops/pallas_kernels.py:171",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def run_taxi(n_rows: int, want_routes, label: str):
    """Drive the main path at `n_rows` with the counts reset just before
    and read just after; check it against the numpy oracle. Returns the
    kernel launch counts of that run."""
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.workloads import taxi as T

    t0 = time.perf_counter()
    trips_np, weather_np = T.gen_taxi_arrays(n_rows, seed=SEED)
    trips, weather = T.tables_from_arrays(trips_np, weather_np)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    R.reset_route_counts()
    CK.reset_launches()
    t0 = time.perf_counter()
    out = T.pipeline(trips, weather)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    routes = dict(R.route_counts)
    launches = dict(CK.launches)
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    T.pipeline(trips, weather)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    got = out.to_numpy()
    t0 = time.perf_counter()
    oracle = T.numpy_pipeline(trips_np, weather_np)
    oracle_s = time.perf_counter() - t0
    T.check_against(got, oracle, rtol=AVG_RTOL)
    print(f"{label}: rows={n_rows} groups={out.nrows} setup_s={setup_s:.3f} "
          f"pipeline_s={wall_s:.4f} pipeline_warm_s={warm_s:.4f} "
          f"max_memory_allocated={peak} numpy_oracle_s={oracle_s:.3f}")
    print(f"{label}: route_counts={routes} kernel_launches={launches}")
    print(f"{label}: matches the numpy oracle (keys and trip_count exact, "
          f"avg_miles rtol={AVG_RTOL})")
    missing = [r for r in want_routes if routes.get(r, 0) < 1]
    if missing:
        raise AssertionError(f"{label}: routes {missing} not taken")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from bodo_tpu_torch.ops import cuda_kernels as CK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    CK.build()
    print(f"build: {sorted(CK.SOURCES)} in {time.perf_counter() - t0:.2f}s")
    for name, log in sorted(CK.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "error" in line:
                print(f"build {name}: {line.strip()}")

    kernels = [check_lut_gather(dev)]
    launches = run_taxi(MAIN_ROWS, ("join_dense", "groupby_dense"),
                        "main path")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the "
                                 f"main path")
    run_taxi(SMALL_ROWS, ("join_dense", "groupby_hashed"), "small")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{f: k[f] for f in order}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
