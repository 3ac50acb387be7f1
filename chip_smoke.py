#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bodo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from bodo_tpu_torch/csrc (one nvcc
per source, all started together), then:

  1. holds each kernel against its plain PyTorch version on the card,
     bit-identical: lut_gather for LUTs of 1 to 2^22 slots (every size
     the dense join admits), hash_probe in each of its forms (slot rows
     in shared memory, slot rows in device memory, the column walk) and
     across their boundaries: tables of 16 to 2^24 slots, 1 to 8 code
     columns, 1 to 20,000,000 probe rows, hit, near-miss, miss and
     not-ok rows, duplicate build keys, code columns as contiguous rows,
     rows at an odd offset and strided columns, max_rounds 0 and 1 (the
     unresolved flag) and two tables back to back; partition_rank for N in {1, 31, 1000, 4099, 5,000,000,
     5,000,067} rows and K in {1, 4, 32, 33, 4096} buckets, views at odd
     offsets, no row ok, one bucket, two calls back to back;
     range_partition at N = 5,000,000 for 1, 3
     and 4095 splitters, with keys whose top bit is set, the padding
     key, splitters equal to keys or duplicated, and an all-padding
     shard's splitters, then in its sequence form (all shards of a pass
     in one launch) for S in {1, 4, 17} shards, n_spl in {1, 3, the
     small form's bound and one more, 4095, 4096} and N in {1, 3, 4, 5,
     885,504, 5,000,000} keys a shard, the shards contiguous and off
     16-byte alignment, and two calls back to back; hybrid_expand one
     page at a time on RLE-only, bit-packed-only and mixed streams of 1,
     100 and 20,000 values at bit widths 0, 1, 2, 8, 17 and 24 with run
     tables of 40 and 4,096 runs, over the whole padded output, and a
     chunk at a time on random chunks of 1 to 200 segments at widths 0,
     1, 2, 8, 15-18 and 24, one staged past 256 MiB (bit offsets past
     2^31); groupby_sum at N in
     {0, 1, 1000, 4099, 1,000,003, 2^24} rows, K in {1, 64, 4096} slots
     and C in {1, 4, 16} columns (K = 4096, C = 16 in two column tiles)
     with masked rows and codes outside [0, K), then views at odd
     offsets, shared masks and values, two calls back to back, the
     kernel and its plain version each against the float64 sums (counts
     exact, sums within 1e-5 * sum(|x|) per slot); and times
     lut_gather, its plain version and the PyTorch call that computes
     the same function;
  2. drives the main paths, each with the route and launch counts set to
     0 just before it and read just after:
     - the NYC-taxi relational pipeline at 20,000,000 trip rows (about
       one month of NYC HVFHV trips), through the dense-LUT join
       (lut_gather) and the dense groupby, against its numpy oracle (keys
       and counts exact, avg_miles within rtol 1e-9: float64 sums in
       another order);
     - the taxi read: the 20,000,000-row trips file as gen_taxi_data
       writes it (pandas' to_parquet with pyarrow's defaults: 20 row
       groups, snappy, dictionary pages with the fall-back to PLAIN),
       read by read_parquet through the device decode route
       (hybrid_expand once a column chunk over all its dictionary-index
       pages, at least once and at most once a chunk that has them,
       lut_gather as dict_gather once a row group for the string column),
       every column on the device, bit-identical to the arrays' table; the
       pipeline from that file against the numpy oracle and, row for row,
       the REP run; hybrid_expand is then held against its plain version
       and timed on the read's largest chunk, and on one bw = 8 page of
       20,000 values as one segment;
     - the lazy pandas frontend on the same files, with its pandas
       fallback warning an error (run_frontend_taxi,
       run_frontend_breadth): workloads/taxi.frontend_pipeline (the
       reference benchmark's dataframe flavour) cold, warm, traced and
       once more to capture its kernel calls, REP (the dense-LUT merge:
       lut_gather; the read: hybrid_expand, dict_gather; the dense
       groupby) and on 4 shards of the card (the broadcast join:
       hash_probe; the two-phase groupby: partition_rank), against the
       numpy oracle and, bit for bit, the relational pipeline on the
       same file (its routes, less its sort; its wall beside the
       frontend's); then workloads/frontend.program (groupby
       aggregations with nunique and median, the groupby windows, the
       Series windows, value_counts, nlargest, drop_duplicates,
       pivot_table, melt, set_index/sort_index/head, a left merge with a
       from_pandas dimension) REP and on 4 shards (the sample sort:
       range_partition) against pandas; lut_gather held and timed on
       the frontend merge's call, dict_gather and hybrid_expand on the
       calls of the frontend's own read (its pruned columns), and
       partition_rank and hash_probe on the 1D frontend taxi run's
       calls, range_partition on the 1D sort_index's call;
     - the star-schema join at 20,000,000 fact and 5,000,000 dimension
       rows (bench.py's --suite join shape, about one month of TPC-H
       SF10 lineitem against its orders), through the hash join
       (hash_probe) and the dense groupby, against its numpy oracle (g
       and c exact, s within rtol 1e-9); hash_probe is then held
       against its plain version and timed on the inputs a run gave it,
       the whole call twice and its row build and walk apart;
     - the four join kinds (inner, left, right, outer) of the dimension
       against the fact table at 2,000,000 fact rows, whose duplicate
       keys send them through the sort join by hash gids, each against a
       numpy oracle by row multiset;
     - the taxi pipeline with shard=True (the JAX package's default) at
       20,000,000 rows on 4 shards of the card: the broadcast join
       (hash_probe on each shard), the two-phase sharded groupby
       (partition_rank in its shuffle), the sample sort (range_partition,
       then partition_rank), against the numpy oracle and row for row
       against the REP run's result; partition_rank and hash_probe are
       then held against their plain versions and timed on each of the
       run's calls;
     - the star join with shard=True on 4 shards, on the REP phase's
       tables, with the memory governor off (so it times the same calls
       whatever the card's free memory): the shuffle join
       (partition_rank on the 20M-row fact table's shards), against the
       numpy oracle; hash_probe is then held and timed on each of the
       run's calls (one a shard);
     - range_partition held against its plain version on every call of
       the two 1D paths (one launch a sample-sort pass), and timed there
       beside a call a shard with torch.cat (the contract it replaced)
       and torch.searchsorted, warm and with the L2 flushed; then on one
       shard of the taxi pass and on 5,000,000 random keys with 1, 3 and
       4095 splitters;
     - the f32 groupby at 2^24 = 16,777,216 rows (workloads/f32_groupby:
       bench.py's dense-accumulate probe and test_hashtable's hashed
       frame, scaled): the dense query (filter, x + x, the dense groupby
       of 64 slots) and the sparse query (the hashed groupby of 300
       int64 keys), each through groupby_sum, against the float64 numpy
       oracle (keys and counts exact, sums within 1e-5 * sum(|x|) per
       group, means within it over the count), cold and warm, with a
       traced dense run; groupby_sum is then held against its plain
       version and the float64 sums and timed on the dense run's inputs,
       beside one index_add_ of the same sums;
     - the decomposable aggregations on the taxi pipeline's joined
       table at 20,000,000 rows (workloads/taxi_aggs.py), REP (the
       dense-LUT join, lut_gather once; the dense groupby) and then 1D on
       4 shards (the broadcast join, the two-phase sharded groupby, the
       sample sort): min, max, first, last, sumnull, var, std, var0,
       std0, skew and kurt of trip_miles (float64), min, max and prod of
       PULocationID (int64), min and max of weekday (bool), grouped by
       the six keys and then sorted by them, and the same over the whole
       table through reduce_table, each against pandas on the host
       (keys, min, max, first, last, prod and the bool results equal;
       sumnull, var and std within rtol 1e-9; skew and kurt within
       1e-7 * (1 + |x|)); then the warm stage time of groupby_agg for
       this spec and for the pipeline's count/mean spec, and of
       reduce_table, each the median of 5 runs;
     - the holistic aggregations on the same joined table at 20,000,000
       rows (workloads/taxi_aggs.py HOLISTIC_AGGS), REP (the six keys
       packed, then the sort groupby) and then 1D on 4 shards (the
       colocated groupby: one hash shuffle, partition_rank once a
       shard, then the sort groupby a shard): nunique of PULocationID
       and of the string hvfhs_license_num, mode of PULocationID and of
       trip_miles, the median and the 0.1 and 0.9 quantiles of
       trip_miles, grouped by the six keys and then sorted by them, and
       the same with the 0.99 quantile over the whole table through
       reduce_table (on 1D every row goes to one shard), each against
       numpy and pandas on the host (keys, nunique and mode exact,
       quantiles within rtol 1e-14), with each stage's synchronized
       time, peak memory, routes and launches, and the warm times of
       groupby_agg and reduce_table (median of 5);
     - the rest of the 1D join family (workloads/join_family.py), each
       against its numpy oracle, with its wall and warm time (median of
       5), peak memory, routes and launches: the union of the taxi
       trips split by pickup quarter into two 1D tables with their own
       dictionaries (concat_tables, then the taxi pipeline on the
       union; lut_gather); the star join with shard=True under the
       memory governor (its budget a shard, the build's bytes and the
       broadcast decision printed: the shuffle join, since the filtered
       fact table is not 4 times the dimension), then against the half
       of the dimension with g < 16 (2.5M rows, over
       bcast_join_threshold: promoted to the broadcast join by the
       governor, shuffled with it off); the star join on a fact table
       whose key is one dimension key in 40% of the rows, governor off
       (the skew split: join_skew_split, the hot rows' broadcast join,
       the cold rows' shuffle join, append_sharded; hash_probe and
       partition_rank), beside the same query with the split off; the
       1D cross join of the 5M-row dimension with 4 scenario rows (20M
       rows, the first and last 1,000 held exactly to pandas' order),
       then u = w * m summed by (g, scenario) (partition_rank,
       range_partition);
     every float64 path above (the taxi paths, the taxi read's
     pipeline, the star paths, the aggregations, the join family, the
     join matrix) must
     launch groupby_sum zero times: the reference's gates refuse f64
     sums and means and any aggregation but sum, count, size and mean;
  3. runs the taxi pipeline at 20,000 rows, which takes the packed/hashed
     groupby route, against the oracle;
  4. runs TPC-H at scale factor 1 through the port's SQL entry point
     (run_tpch): gen_tpch(n_orders=1,500,000, seed=0), about 6.0M
     lineitem rows, registered on a BodoSQLContext on the card; each of
     the 22 queries through ctx.sql(q).to_pandas(), cold then warm, with
     the route and launch counts set to 0 just before the cold run and
     read just after, held against sqlite on the same data (computed in
     a process of its own while the frames are generated and
     registered: row counts, integers, strings, dates and the ORDER BY
     row order exact, float64 sums and means unrounded within rtol
     1e-9); all 22 must match, Q16's COUNT(DISTINCT) through the sort
     groupby's nunique among them, and lut_gather or hash_probe must
     launch in the phase; then two queries of the holistic aggregations
     over the same frames, cold and warm, against pandas (sqlite has no
     median, mode or ordered LISTAGG): COUNT(DISTINCT l_suppkey),
     MEDIAN(l_extendedprice) and MODE(l_quantity) of lineitem by
     l_returnflag and l_linestatus, and LISTAGG(s_name, '|') with
     LISTAGG(DISTINCT s_nationkey) of supplier by s_nationkey (counts,
     modes and strings exact, medians within rtol 1e-14);
  5. runs the window functions over the same frames (run_windows): the
     eight OVER queries of workloads/windows.WINDOW_SQL (ROW_NUMBER over
     1.5M partitions, RANK and DENSE_RANK over a GROUP BY, a running
     SUM, a moving AVG, MAX over a two-sided frame with MIN over whole
     partitions, LAG and LEAD, NTILE with COUNT(*) over a RANGE frame,
     FIRST_VALUE of a string with SUM(...) OVER ()), cold then warm,
     the two bit-identical and both held row for row to sqlite (computed
     by 4 worker processes of the oracle's process beside its 22
     queries; integers, strings, dates and nulls exact, window sums
     within 64 * 2^-52 * sum(|x|), window means within that over their
     frame's row count);
     then the rank_window and agg_window calls of workloads/windows on
     lineitem, REP and on 4 shards (the shuffle and the sample sort:
     partition_rank and range_partition, whose launches join the
     kernels line as window_1d_launches; the global ranking; OVER ()
     through reduce_table; the gather of an ordered frame without a
     partition key), 1D held to REP; each partition_rank and
     range_partition call of one more 1D run of W1's call (lineitem's
     shards: the shuffle's and the sort back's) held to its kernel's
     plain version and timed, on the kernels line as window_1d_calls;
     then window_table on the taxi
     trips' 20,000,000 rows in pickup order (run_window_table;
     workloads/windows.TABLE_SPECS): cumsum, cummax, cummin, cumprod of
     a column near 1, rolling sum, mean, min, max and count with w = 7
     and w = 1000, shift and diff, REP and on 4 shards (the carries and
     the multi-hop halos), each against pandas on the same arrays (the
     running sum accumulated in extended precision) and 1D against REP
     (min, max, counts, shift and diff exact; prefix sums within 64 *
     2^-52 * sum(|x|), the product within n * 2^-52 relative). The
     sqlite results are checked last, so this work runs while the
     oracle computes them.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing any result. The last line is one JSON object
naming the device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

MAIN_ROWS = 20_000_000
SMALL_ROWS = 20_000
STAR_ROWS = 20_000_000     # fact rows; the dimension has a quarter
MATRIX_ROWS = 2_000_000
PROBE_ROWS = 13_333_333    # fact rows the star query's filter keeps
SHARDS = 4                 # shards of the 1D phases' mesh on the card
SHARD_ROWS = 5_000_000     # rows of one shard of the 20M-row tables
SEED = 0
AVG_RTOL = 1e-9
# H100 SXM device-memory bandwidth (NVIDIA data sheet), for bound_ms
HBM_BYTES_PER_S = 3.35e12
# the spin that holds the card while a timing loop is queued (~50 ms)
SPIN_CYCLES = 100_000_000
# written between calls timed with the L2 flushed (5x the H100's 50 MB L2)
L2_FLUSH_BYTES = 256 << 20
# the taxi trips file: pyarrow's default layout, as gen_taxi_data writes it
READ_ROW_GROUPS = 20       # 1,048,576-row row groups of 20M rows
# the f32 groupby: the largest capacity whose counts the f32 accumulate's
# gate admits (2^24, a multiple of the capacity rounding)
F32_ROWS = 1 << 24
SUM_TOL_TEXT = "1e-5 * sum(|x|) per slot"
# the aggregation phase against pandas: float64 sums and moments in
# another order and by another algorithm (pandas' Welford)
AGG_RTOL = 1e-9            # sumnull, var, std, var0, std0: relative
MOMENT_TOL = 1e-7          # skew, kurt: |delta| <= MOMENT_TOL * (1 + |x|)
HOLISTIC_RTOL = 1e-14      # medians and quantiles against pandas / numpy
STAGE_REPS = 5             # warm stage times: the median of 5 runs
# TPC-H at scale factor 1 (workloads/tpch.gen_tpch): 1.5M orders
TPCH_ORDERS = 1_500_000
TPCH_RTOL = 1e-9           # float64 sums and means against sqlite


def device_ms(fn, reps: int = 20, warmup: int = 3,
              flush: bool = False) -> float:
    """Median device time of one call of `fn` over `reps` calls, by CUDA
    events around each call. A spin kernel holds the card while the host
    queues the calls, so the calls run back to back and the events time
    the device, not the Python wrapper between launches (most of a call
    that runs for microseconds). A call that syncs with the host inside
    (the plain hash_probe's loop) is timed with its syncs. With `flush`,
    a buffer of L2_FLUSH_BYTES is written before each call, outside the
    events, so each call finds its inputs in device memory and not in
    the 50 MB L2."""
    import torch
    buf = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
           if flush else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in zip(starts, ends):
        if buf is not None:
            buf.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def check_lut_gather(dev):
    """Phase 1 for lut_gather: bit-identity at every shape, times at the
    main path's shape (K=182 date slots, N=20M probe rows)."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0
    # up to 2^22 slots, the largest LUT the dense join admits
    for k in (1, 182, 4096, 50_000, 65_536, 1 << 22):
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
    rows = {}
    # the taxi date join's shape first (the kernel line's numbers), then
    # the largest LUT the dense join admits
    for k in (182, 1 << 22):
        n = MAIN_ROWS
        lut = torch.randint(-1, n, (k,), generator=g, device=dev,
                            dtype=torch.int32)
        codes = torch.randint(0, k, (n,), generator=g, device=dev,
                              dtype=torch.int32)
        kernel_ms = device_ms(lambda: CK.lut_gather(codes, lut))
        plain_ms = device_ms(lambda: CK.lut_gather_plain(codes, lut))
        library_ms = device_ms(lambda: lut[codes])
        kernel_ms_again = device_ms(lambda: CK.lut_gather(codes, lut))
        nbytes = 4 * n + 4 * n + 4 * k  # codes read, output written, LUT
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"lut_gather timing K={k} N={n}: kernel_ms={kernel_ms:.6f} "
              f"(again {kernel_ms_again:.6f}) plain_ms={plain_ms:.6f} "
              f"library_ms(lut[codes])={library_ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({nbytes} bytes at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s)")
        rows[k] = (kernel_ms, plain_ms, bound_ms, library_ms)
        del lut, codes
    kernel_ms, plain_ms, bound_ms, library_ms = rows[182]
    return {"name": "lut_gather", "route": "cuda",
            "source": "bodo_tpu_torch/csrc/lut_gather.cu",
            "replaces": "bodo_tpu/ops/pallas_kernels.py:171",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def _columns(codes, layout: int):
    """The rows of `codes` [n_codes, m] as code columns laid out one of
    three ways: 0 rows of a contiguous tensor; 1 rows of a wider tensor
    from its second column (8 bytes past 16-byte alignment); 2 columns
    of a row-major [m, n_codes + 1] tensor (element stride n_codes + 1)."""
    import torch
    k, m = codes.shape
    if layout == 0:
        return tuple(codes.contiguous())
    if layout == 1:
        wide = torch.zeros(k, m + 1, dtype=codes.dtype, device=codes.device)
        wide[:, 1:] = codes
        return tuple(wide[:, 1:])
    rows = torch.zeros(m, k + 1, dtype=codes.dtype, device=codes.device)
    rows[:, :k] = codes.T
    return tuple(rows[:, j] for j in range(k))


def _probe_case(dev, g, T: int, n_codes: int, bcap: int, layout: int = 0):
    """Build codes (a 0/1 null-flag column, like a join's, then random
    64-bit codes; the last 3 rows repeat the first 3, so duplicate keys
    share a slot as in the hash-gid join) claimed into a T-slot table by
    the port's claim_slots. Returns (build code columns in `layout`,
    owner)."""
    import torch
    from bodo_tpu_torch.ops import hashtable as HT
    bcodes = torch.randint(-(1 << 62), 1 << 62, (n_codes, bcap),
                           generator=g, device=dev, dtype=torch.int64)
    bcodes[0] = torch.randint(0, 2, (bcap,), generator=g, device=dev)
    if bcap > 6:
        bcodes[:, -3:] = bcodes[:, :3]
    bok = torch.rand(bcap, generator=g, device=dev) < 0.9
    _slot, owner, _r, unresolved = HT.claim_slots(tuple(bcodes), bok, T)
    assert not unresolved
    return _columns(bcodes, layout), owner


def _probe_rows(dev, g, bcodes, n: int, T: int, layout: int = 0):
    """n probe rows: a third hit a build key, a third differ from one in
    one code (near miss), a third are random (miss); 15% are not ok.
    Returns (probe code columns in `layout`, ok, h, step) as probe_slots
    makes them."""
    import torch
    from bodo_tpu_torch.ops import hashtable as HT
    n_codes, bcap = len(bcodes), bcodes[0].shape[0]
    rows = torch.randint(0, bcap, (n,), generator=g, device=dev)
    pcodes = torch.stack([c[rows] for c in bcodes])
    kind = torch.arange(n, device=dev) % 3
    pcodes[n_codes - 1] ^= (kind == 1).to(torch.int64)
    rnd = torch.randint(-(1 << 62), 1 << 62, (n_codes, n), generator=g,
                        device=dev, dtype=torch.int64)
    pcodes = torch.where(kind == 2, rnd, pcodes)
    ok = torch.rand(n, generator=g, device=dev) < 0.85
    h = HT.combine_hash(tuple(pcodes))
    step = (HT._fmix64(h ^ HT._GOLD) | 1) & (T - 1)
    return _columns(pcodes, layout), ok, h & (T - 1), step


def _hold_probe(args, label: str, unresolved=None):
    """hash_probe on `args` bit-identical to its plain version (and its
    unresolved flag equal to `unresolved` where given), else raise."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    idx, un = CK.hash_probe(*args)
    want_idx, want_un = CK.hash_probe_plain(*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(idx, want_idx)) and bool(un) == bool(want_un)
    ok = args[3]
    print(f"hash_probe {label}: bit_identical={same} "
          f"hits={int((idx >= 0).sum())} ok_rows={int(ok.sum())} "
          f"unresolved={bool(un)} (plain {bool(want_un)})")
    if not same or (unresolved is not None and bool(un) != unresolved):
        raise AssertionError(f"hash_probe differs from its plain version "
                             f"or its unresolved flag is wrong ({label})")


# (T, build rows) of the hash_probe cases: every form of the kernel and
# the boundaries between them (its shared form holds T * row bytes <= 32
# KiB: T <= 2048 at 1 code column, 1024 at 2-3, 512 at 4-7; its rows form
# takes 2 or 3 code columns at T >= 2^24 and N >= T/2), a table of 2^20
# slots and the star join's table
PROBE_TABLES = ((16, 8), (512, 256), (1024, 512), (2048, 1024),
                (4096, 2048), (1 << 20, 1 << 19), (1 << 24, STAR_ROWS // 4))
PROBE_CODES = (1, 2, 3, 4, 7, 8)


def check_hash_probe(dev):
    """Phase 1 for hash_probe: bit-identity with its plain version for
    every (T, n_codes, N) case, code columns laid out three ways; then,
    in each form, max_rounds 0 and 1 (the unresolved flag raised and
    equal to the plain version's) and two calls back to back on
    different tables of one T."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.ops import hashtable as HT

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    forms = set()
    case = 0
    for T, bcap in PROBE_TABLES:
        for n_codes in PROBE_CODES:
            layout = case % 3
            case += 1
            bcodes, owner = _probe_case(dev, g, T, n_codes, bcap, layout)
            for n in (1, 511, 513, PROBE_ROWS, STAR_ROWS):
                pcodes, ok, h, step = _probe_rows(dev, g, bcodes, n, T,
                                                  (layout + 1) % 3)
                form = CK.hash_probe_form(n, T, n_codes)
                forms.add(form)
                _hold_probe((bcodes, owner, pcodes, ok, h, step, T,
                             HT.MAX_ROUNDS),
                            f"T={T} n_codes={n_codes} N={n} form={form} "
                            f"layouts={layout},{(layout + 1) % 3}",
                            unresolved=False)
                del pcodes, ok, h, step
            del bcodes, owner
    # max_rounds 0 and 1, and two tables back to back, in each form
    for T, bcap, n in ((512, 256, 4099), (1 << 20, 1 << 19, 4099),
                       (1 << 24, STAR_ROWS // 4, 1 << 23)):
        form = CK.hash_probe_form(n, T, 2)
        forms.add(form)
        tables = [_probe_case(dev, g, T, 2, bcap) for _ in range(2)]
        calls = [(b, o, *_probe_rows(dev, g, b, n, T)) for b, o in tables]
        for rounds in (0, 1):
            _hold_probe((*calls[0], T, rounds),
                        f"T={T} N={n} form={form} max_rounds={rounds}",
                        unresolved=True)
        got = [CK.hash_probe(*c, T, HT.MAX_ROUNDS) for c in calls]
        want = [CK.hash_probe_plain(*c, T, HT.MAX_ROUNDS) for c in calls]
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a[0], b[0])) and bool(a[1]) == bool(b[1])
                   for a, b in zip(got, want))
        print(f"hash_probe T={T} N={n} form={form}: two tables back to "
              f"back bit_identical={same}")
        if not same:
            raise AssertionError(f"hash_probe's back-to-back calls differ "
                                 f"from its plain version at T={T}")
    if forms != set(CK.HASH_PROBE_FORMS):
        raise AssertionError(f"hash_probe cases reached the forms {forms}")


def probe_walk(bcodes, owner, pcodes, ok, h, step, T: int, max_rounds: int):
    """What the probe walk of these inputs must read: on an owned slot,
    code column j only while the columns before it were equal. Returns
    (bytes streamed: ok and idx for every row, h and step for each ok
    row, a row's code j once the walk compares it; rounds walked; code
    comparisons; distinct 32-byte sectors of the owner table; distinct
    32-byte sectors of the build code columns)."""
    import torch
    mask = T - 1
    n_codes, n = len(pcodes), ok.shape[0]
    active = ok.clone()
    rounds = compares = 0
    compared = [torch.zeros_like(ok) for _ in range(n_codes)]
    slots, owners = [], [[] for _ in range(n_codes)]
    r = 0
    while r < max_rounds and bool(active.any()):
        p = (h + r * step) & mask
        o = owner[p]
        rounds += int(active.sum())
        slots.append(p[active])
        osafe = o.clamp(min=0).to(torch.int64)
        eq = active & (o >= 0)
        for j in range(n_codes):
            compares += int(eq.sum())
            compared[j] |= eq
            owners[j].append(osafe[eq])
            eq = eq & (bcodes[j][osafe] == pcodes[j])
        active = active & ~eq & (o >= 0)
        r += 1
    streamed = (5 * n + 16 * int(ok.sum())
                + 8 * sum(int(c.sum()) for c in compared))
    owner_sectors = torch.unique(torch.cat(slots) // 8).numel()  # 4 B each
    code_sectors = sum(torch.unique(torch.cat(o) // 4).numel()  # 8 B each
                       for o in owners)
    return streamed, rounds, compares, owner_sectors, code_sectors


def probe_bound(args):
    """hash_probe's bound on `args`: every input the walks need read once
    (the streamed bytes and each owner and code sector the walks touch)
    over the card's memory rate. Returns (bound ms, bytes, probe_walk's
    counts)."""
    counts = probe_walk(*args)
    streamed, _rounds, _compares, owner_sectors, code_sectors = counts
    nbytes = streamed + 32 * owner_sectors + 32 * code_sectors
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, counts


def probe_phase_ms(args):
    """Device ms of the rows form's two launches, each alone through the
    kernel's phase entry (a measurement, so no launch is counted):
    (row build, walk)."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    fn = CK._lib("hash_probe").hash_probe_phase_launch
    fn.argtypes = [*CK._ENTRIES["hash_probe"][1][:-1], CK._I, CK._P]
    fn.restype = CK._I
    call, _idx, _flag, _scratch = CK._hash_probe_call(*args, args[3].device)
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for phase in (1, 2):
        if fn(*call, phase, stream):
            raise RuntimeError(f"hash_probe phase {phase} launch failed")
        times.append(device_ms(lambda: fn(*call, phase, stream)))
    return tuple(times)


def time_hash_probe(args):
    """Hold hash_probe against its plain version on the inputs the star
    path gave it, time both there (the kernel's whole call twice, and its
    row build and walk apart), and compute its bound from what this
    run's walk reads."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    bcodes, owner, pcodes, ok, h, step, T, max_rounds = args
    n_codes, n = len(pcodes), ok.shape[0]
    form = CK.hash_probe_form(n, T, n_codes)
    idx, un = CK.hash_probe(*args)
    want_idx, want_un = CK.hash_probe_plain(*args)
    torch.cuda.synchronize()
    err = int((idx.long() - want_idx.long()).abs().max())
    same = bool(torch.equal(idx, want_idx)) and bool(un) == bool(want_un)
    print(f"hash_probe (star path's call) T={T} N={n} n_codes={n_codes} "
          f"form={form}: bit_identical={same} max_abs_diff={err} "
          f"unresolved={bool(un)} (plain {bool(want_un)})")
    if not same:
        raise AssertionError("hash_probe differs from its plain version on "
                             "the star path's inputs")
    del idx, want_idx
    kernel_ms = device_ms(lambda: CK.hash_probe(*args))
    plain_ms = device_ms(lambda: CK.hash_probe_plain(*args), reps=5)
    kernel_ms_again = device_ms(lambda: CK.hash_probe(*args))
    build_ms, walk_ms = probe_phase_ms(args)
    bound_ms, nbytes, counts = probe_bound(args)
    streamed, rounds, compares, owner_sectors, code_sectors = counts
    n_ok = int(ok.sum())
    # the random-access model of the column walk: one sector per owner
    # read and per code read
    sector_bytes = streamed + 32 * rounds + 32 * compares
    print(f"hash_probe timing (star path's call) T={T} N={n} ok_rows={n_ok} "
          f"n_codes={n_codes} form={form}: kernel_ms={kernel_ms:.6f} "
          f"(again {kernel_ms_again:.6f}; row build {build_ms:.6f} + walk "
          f"{walk_ms:.6f} launched apart) plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6f} ({nbytes} bytes: {streamed} streamed, "
          f"{owner_sectors} owner and {code_sectors} code sectors) "
          f"mean_rounds={rounds / max(n_ok, 1):.6f} "
          f"code_compares_per_row={compares / max(n_ok, 1):.6f} "
          f"column_walk_sector_bound_ms="
          f"{sector_bytes / HBM_BYTES_PER_S * 1e3:.6f} "
          f"({sector_bytes} bytes); library_ms=null (no single PyTorch "
          f"call probes a hash table)")
    return {"name": "hash_probe", "route": "cuda",
            "source": "bodo_tpu_torch/csrc/hash_probe.cu",
            "replaces": "bodo_tpu/ops/pallas_kernels.py:299",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "form": form, "ms_again": kernel_ms_again, "build_ms": build_ms,
            "walk_ms": walk_ms}


def time_probe_calls(calls, label: str):
    """Hold hash_probe against its plain version on each call a path made
    and time the kernel on each at its own shape. Returns one entry a
    call: N, T, n_codes, form, ms, bound_ms."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    rows = []
    for j, args in enumerate(calls):
        n, T, n_codes = args[3].shape[0], args[6], len(args[2])
        form = CK.hash_probe_form(n, T, n_codes)
        what = (f"({label}'s call {j + 1} of {len(calls)}) N={n} T={T} "
                f"n_codes={n_codes} form={form}")
        _hold_probe(args, what)
        ms = device_ms(lambda: CK.hash_probe(*args))
        bound_ms = probe_bound(args)[0]
        print(f"hash_probe timing {what}: kernel_ms={ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_ms / ms:.1%} of the bound)")
        rows.append({"N": n, "T": T, "n_codes": n_codes, "form": form,
                     "ms": ms, "bound_ms": bound_ms})
    torch.cuda.synchronize()
    print(f"hash_probe on the {label}: {len(calls)} calls, sum of kernel "
          f"ms {sum(r['ms'] for r in rows):.6f} against sum of bound ms "
          f"{sum(r['bound_ms'] for r in rows):.6f}")
    return rows


def _hold_partition_rank(dest, ok, k: int, got, label: str) -> None:
    """partition_rank's result `got` bit-identical to its plain version."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    want_rank, want_counts = CK.partition_rank_plain(dest, ok, k)
    torch.cuda.synchronize()
    same = (bool(torch.equal(got[0], want_rank))
            and bool(torch.equal(got[1], want_counts)))
    print(f"partition_rank {label} N={dest.shape[0]} K={k}: "
          f"bit_identical={same} ok_rows={int(ok.sum())}")
    if not same:
        raise AssertionError(f"partition_rank differs from its plain "
                             f"version: {label} N={dest.shape[0]} K={k}")


def check_partition_rank(dev):
    """Phase 1 for partition_rank: bit-identity with its plain version
    for N in {1, 31, 1000, 4099, 5,000,000, 5,000,067} rows (tails of the
    4-row loads and of the tiles) and K in {1, 4, 32, 33, 4096} (both
    forms of the in-warp rank), buckets outside [0, K) and rows not ok;
    views at odd element offsets; no row ok; every row in one bucket;
    two calls back to back, which share the look-back state."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK

    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def case(n: int, k: int, live: float = 0.9):
        dest = torch.randint(-1, k + 1, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        ok = torch.rand(n, generator=g, device=dev) < live
        return dest, ok

    ks = (1, SHARDS, 32, 33, CK.PARTITION_MAX_BUCKETS)
    for n in (1, 31, 1000, 4099, SHARD_ROWS, SHARD_ROWS + 67):
        for k in ks:
            dest, ok = case(n, k)
            _hold_partition_rank(dest, ok, k, CK.partition_rank(dest, ok, k),
                                 "random")
    n = SHARD_ROWS + 67
    for k in (SHARDS, 33):
        dest, ok = case(n + 3, k)
        d, o = dest[1:n + 1], ok[3:n + 3]  # 4 and 3 bytes off alignment
        _hold_partition_rank(d, o, k, CK.partition_rank(d, o, k),
                             "views at element offsets 1 and 3")
        dest, ok = case(n, k, live=0.0)
        _hold_partition_rank(dest, ok, k, CK.partition_rank(dest, ok, k),
                             "no row ok")
    for k in ks:
        dest = torch.full((n,), k - 1, device=dev, dtype=torch.int32)
        ok = torch.ones(n, device=dev, dtype=torch.bool)
        _hold_partition_rank(dest, ok, k, CK.partition_rank(dest, ok, k),
                             "every row in one bucket")
    for k in (SHARDS, 33, CK.PARTITION_MAX_BUCKETS):
        a, b = case(SHARD_ROWS, k), case(SHARD_ROWS - 4099, k, live=0.5)
        got_a = CK.partition_rank(*a, k)  # no sync between the two
        got_b = CK.partition_rank(*b, k)
        _hold_partition_rank(*a, k, got_a, "back to back, first")
        _hold_partition_rank(*b, k, got_b, "back to back, second")


def check_range_partition(dev):
    """Phase 1 for range_partition: bit-identity with its plain version on
    uint64 keys (held in int64) with the traps of unsigned order, in the
    one-tensor form, then in the sequence form."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    top = -(1 << 63)  # 0x8000000000000000
    pk = torch.randint(0, 1 << 62, (SHARD_ROWS,), generator=g, device=dev,
                       dtype=torch.int64)
    pk[::7] |= top          # top bit set
    pk[::11] = -1           # the padding key 0xFFFFFFFFFFFFFFFF
    cases = []
    for n_spl in (1, SHARDS - 1, CK.RANGE_MAX_SPLITTERS - 1):
        pick = torch.randint(0, SHARD_ROWS, (n_spl,), generator=g,
                             device=dev)
        cases.append((f"{n_spl} splitters equal to keys", pk[pick]))
    cases.append(("duplicated splitters",
                  torch.cat([pk[:2], pk[:2], pk[7:8]])))
    cases.append(("all-padding shard", torch.full((SHARDS - 1,), -1,
                                                  device=dev)))
    for label, spl in cases:
        spl = CK._SIGN64 ^ torch.sort(spl ^ CK._SIGN64).values  # unsigned
        got = CK.range_partition(pk, spl.contiguous())
        want = CK.range_partition_plain(pk, spl)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        print(f"range_partition N={SHARD_ROWS} {label}: "
              f"bit_identical={same}")
        if not same:
            raise AssertionError(f"range_partition differs from its plain "
                                 f"version ({label})")
    check_range_partition_shards(dev, g)


def range_rows(g, shards, n_spl: int):
    """One sorted splitter row a shard, drawn from its keys (equal to
    keys, duplicated where n_spl exceeds them); the second shard's row is
    all padding keys, as an empty shard's samples make it."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    out = []
    for j, k in enumerate(shards):
        pick = torch.randint(0, k.shape[0], (n_spl,), generator=g,
                             device=k.device)
        row = torch.full((n_spl,), -1, device=k.device) if j == 1 \
            else k[pick]
        out.append(CK._SIGN64 ^ torch.sort(row ^ CK._SIGN64).values)
    return torch.stack(out)


RANGE_SHARD_ROWS = (1, 3, 4, 5, 885_504, SHARD_ROWS)


def check_range_partition_shards(dev, g):
    """range_partition's sequence form (one launch over up to
    RANGE_MAX_SHARDS shards, each with its splitter row): bit-identity
    with its plain version for S in {1, SHARDS, RANGE_MAX_SHARDS + 1}
    shards, n_spl in {1, 3, the small form's bound and one more, 4095,
    4096} and N in RANGE_SHARD_ROWS keys a shard, the shards contiguous
    and as views off 16-byte alignment; one launch for every
    RANGE_MAX_SHARDS shards; two calls back to back."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    small = max(m for m in range(CK.RANGE_MAX_SPLITTERS + 1)
                if CK.range_partition_form(m) == "small")

    def hold(shards, spl, got, label):
        want = CK.range_partition_plain(shards, spl)
        torch.cuda.synchronize()
        if not bool(torch.equal(got, want)):
            raise AssertionError(f"range_partition differs from its plain "
                                 f"version ({label})")

    spls = (1, 3, small, small + 1, 4095, CK.RANGE_MAX_SPLITTERS)
    for s in (1, SHARDS, CK.RANGE_MAX_SHARDS + 1):
        for n in RANGE_SHARD_ROWS:
            pool = torch.randint(-(1 << 63), (1 << 63) - 1,
                                 (s * (n + 1) + 1,), generator=g,
                                 device=dev, dtype=torch.int64)
            pool[::11] = -1  # padding keys; half the rest have the top bit
            layouts = {
                "contiguous": [pool[j * n:(j + 1) * n] for j in range(s)],
                "off 16-byte alignment": [
                    pool[1 + j * (n + 1):1 + j * (n + 1) + n]
                    for j in range(s)]}
            for n_spl in spls:
                for layout, shards in layouts.items():
                    spl = range_rows(g, shards, n_spl)
                    before = CK.launches["range_partition"]
                    got = CK.range_partition(shards, spl)
                    want_launches = -(-s // CK.RANGE_MAX_SHARDS)
                    if CK.launches["range_partition"] - before != \
                            want_launches:
                        raise AssertionError(f"range_partition: S={s} "
                                             f"took {want_launches} "
                                             f"launches")
                    hold(shards, spl, got, f"S={s} N={n} n_spl={n_spl} "
                         f"{layout}")
            print(f"range_partition S={s} N={n} (launches a call "
                  f"{-(-s // CK.RANGE_MAX_SHARDS)}) n_spl={list(spls)} "
                  f"(small form up to {small}), contiguous and off "
                  f"16-byte alignment: bit_identical=True")
            del pool, layouts
    n = 885_504
    a = torch.randint(-(1 << 63), (1 << 63) - 1, (SHARDS * n + 5,),
                      generator=g, device=dev, dtype=torch.int64)
    sa = [a[j * n:(j + 1) * n] for j in range(SHARDS)]
    sb = [a[5 + j * n:5 + (j + 1) * n] for j in range(SHARDS)]
    spa, spb = range_rows(g, sa, SHARDS - 1), range_rows(g, sb, 4095)
    got_a = CK.range_partition(sa, spa)  # no sync between the two
    got_b = CK.range_partition(sb, spb)
    hold(sa, spa, got_a, "back to back, first")
    hold(sb, spb, got_b, "back to back, second")
    print(f"range_partition two calls back to back (S={SHARDS} N={n}, "
          f"n_spl 3 and 4095): bit_identical=True")


class _Capture:
    """Record the arguments of every call of <module>.<name> (CK by
    default) while active."""

    def __init__(self, name: str, module=None):
        if module is None:
            from bodo_tpu_torch.ops import cuda_kernels as module
        self.ck, self.name, self.calls = module, name, []
        self.orig = getattr(module, name)

    def __enter__(self):
        def keep(*args):
            self.calls.append(args)
            return self.orig(*args)
        setattr(self.ck, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.ck, self.name, self.orig)


def time_partition_rank(calls, label: str = "1D taxi path"):
    """Hold partition_rank against its plain version on each call a path
    (the 1D taxi path by default) made, and time the kernel on each; the
    plain version on the largest. Returns the largest call's row, with
    the whole path's launches x kernel ms beside launches x bound ms."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    path_ms = path_bound_ms = 0.0
    err = 0
    for j, (dest, ok, k) in enumerate(calls):
        got = CK.partition_rank(dest, ok, k)
        want = CK.partition_rank_plain(dest, ok, k)
        torch.cuda.synchronize()
        err = max(err, int((got[0].long() - want[0].long()).abs().max()),
                  int((got[1].long() - want[1].long()).abs().max()))
        same = (bool(torch.equal(got[0], want[0]))
                and bool(torch.equal(got[1], want[1])))
        n = dest.shape[0]
        ms = device_ms(lambda: CK.partition_rank(dest, ok, k))
        nbytes = 9 * n + 4 * k  # dest and ok read, rank written; counts
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        path_ms += ms
        path_bound_ms += bound_ms
        print(f"partition_rank ({label}'s call {j + 1} of "
              f"{len(calls)}) N={n} K={k} ok_rows={int(ok.sum())}: "
              f"bit_identical={same} kernel_ms={ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_ms / ms:.1%} of the bound)")
        if not same:
            raise AssertionError(f"partition_rank differs from its plain "
                                 f"version on the {label}'s call {j + 1}")
    print(f"partition_rank on the {label}: {len(calls)} launches, "
          f"sum of kernel ms {path_ms:.6f} against sum of bound ms "
          f"{path_bound_ms:.6f}")
    args = max(calls, key=lambda c: c[0].shape[0])
    dest, ok, k = args
    kernel_ms = device_ms(lambda: CK.partition_rank(*args))
    plain_ms = device_ms(lambda: CK.partition_rank_plain(*args))
    kernel_ms_again = device_ms(lambda: CK.partition_rank(*args))
    n = dest.shape[0]
    nbytes = 9 * n + 4 * k
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"partition_rank timing ({label}) N={n} K={k}: "
          f"kernel_ms={kernel_ms:.6f} "
          f"(again {kernel_ms_again:.6f}) plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6f} ({nbytes} bytes at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); library_ms=null (no single "
          f"PyTorch call gives a stable in-bucket rank)")
    return {"name": "partition_rank", "route": "cuda",
            "source": "bodo_tpu_torch/csrc/partition_rank.cu",
            "replaces": "bodo_tpu/ops/pallas_kernels.py:432",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "N": n, "K": k, "path_ms": path_ms,
            "path_bound_ms": path_bound_ms}


def range_bound_ms(s: int, n: int, n_spl: int) -> float:
    """The least time of a range_partition call: S * N keys read (8 B)
    and destinations written (4 B), S rows of splitters read, over the
    card's memory rate."""
    return (12 * s * n + 8 * s * n_spl) / HBM_BYTES_PER_S * 1e3


def time_range_call(pks, spl, label: str) -> dict:
    """Hold one range_partition call against its plain version and time
    it: the one launch, the contract it replaced (a call a shard, then
    torch.cat), torch.searchsorted on the same keys (batched over the
    shards; keys and rows sign-flipped and stacked once beforehand, so
    its signed order is the unsigned order), warm and with the L2
    flushed; the plain version warm."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    pks = tuple(pks)
    got = CK.range_partition(pks, spl)
    want = CK.range_partition_plain(pks, spl)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not bool(torch.equal(got, want)):
        raise AssertionError(f"range_partition differs from its plain "
                             f"version on {label}")
    s, n, n_spl = len(pks), pks[0].shape[0], spl.shape[1]
    rows = [spl[j] for j in range(s)]
    flipped_pk = torch.stack([p ^ CK._SIGN64 for p in pks])
    flipped_spl = (spl ^ CK._SIGN64).contiguous()

    def one():
        return CK.range_partition(pks, spl)

    def per_shard():
        return torch.cat([CK.range_partition(p, r)
                          for p, r in zip(pks, rows)])

    def library():
        return torch.searchsorted(flipped_spl, flipped_pk, right=True,
                                  out_int32=True)

    t = {"ms": device_ms(one), "per_shard_ms": device_ms(per_shard),
         "library_ms": device_ms(library),
         "flushed_ms": device_ms(one, flush=True),
         "per_shard_flushed_ms": device_ms(per_shard, flush=True),
         "library_flushed_ms": device_ms(library, flush=True),
         "plain_ms": device_ms(lambda: CK.range_partition_plain(pks, spl)),
         "ms_again": device_ms(one)}
    bound = range_bound_ms(s, n, n_spl)
    print(f"range_partition {label} S={s} N={n} a shard n_spl={n_spl} "
          f"form={CK.range_partition_form(n_spl)}: bit_identical=True "
          f"max_abs_diff={err}; one launch {t['ms']:.6f} (again "
          f"{t['ms_again']:.6f}) ms, flushed {t['flushed_ms']:.6f}; a "
          f"call a shard + torch.cat {t['per_shard_ms']:.6f}, flushed "
          f"{t['per_shard_flushed_ms']:.6f}; torch.searchsorted "
          f"{t['library_ms']:.6f}, flushed {t['library_flushed_ms']:.6f}; "
          f"plain {t['plain_ms']:.6f}; bound_ms={bound:.6f} "
          f"({bound / t['ms']:.1%} of it warm, "
          f"{bound / t['flushed_ms']:.1%} flushed)")
    return {"S": s, "N": n, "n_spl": n_spl, "max_abs_err": err,
            "bound_ms": bound, **t}


def time_range_calls(calls, label: str):
    """time_range_call on each captured call of a path."""
    return [time_range_call(*call, f"({label} call {j + 1} of "
                                   f"{len(calls)})")
            for j, call in enumerate(calls)]


def time_range_partition(calls, dev):
    """Hold range_partition against its plain version on every call the
    1D taxi path made and time each (time_range_call); then one shard of
    its first call alone, and SHARD_ROWS random keys with 1, 3 and 4095
    splitters. Returns the first call's row."""
    import torch
    timed = time_range_calls(calls, "1D taxi path")
    pks, spl = calls[0]
    shard = time_range_call(pks[:1], spl[:1], "(one shard of the 1D taxi "
                                               "path's call)")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    pk = torch.randint(-(1 << 63), (1 << 63) - 1, (SHARD_ROWS,),
                       generator=g, device=dev, dtype=torch.int64)
    wide = [time_range_call([pk], range_rows(g, [pk], m), "(random keys)")
            for m in (1, SHARDS - 1, 4095)]
    row = timed[0]
    return {"name": "range_partition", "route": "cuda",
            "source": "bodo_tpu_torch/csrc/range_partition.cu",
            "replaces": "bodo_tpu/ops/pallas_kernels.py:654",
            "max_abs_err": max(c["max_abs_err"] for c in timed),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row["library_ms"], "taxi_1d_calls": timed,
            "one_shard": shard, "random_keys": wide}


def encode_hybrid(rng, n: int, n_runs: int, bw: int, kind: str):
    """A parquet RLE/bit-packed hybrid stream of `n` values in `n_runs`
    runs (fewer when `n` is too small for them) of bit width `bw`:
    'rle' runs only, 'packed' runs only (lengths in groups of 8) or
    'mixed' (alternating). Returns (stream bytes, the values it holds)."""
    import numpy as np
    vbw = (bw + 7) // 8
    kinds = {"rle": ["rle"], "packed": ["packed"],
             "mixed": ["rle", "packed"]}[kind]
    out = bytearray()
    values = []

    def uvarint(v):
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return

    left, k = n, 0
    while left > 0:
        runs_left = max(n_runs - k, 1)
        ln = max(1, left // runs_left) if k < n_runs - 1 else left
        if kinds[k % len(kinds)] == "rle":
            v = int(rng.integers(0, 1 << bw)) if bw else 0
            uvarint(ln << 1)
            out += v.to_bytes(vbw, "little")
            values.append(np.full(ln, v, np.int64))
        else:
            groups = -(-ln // 8)
            vals = rng.integers(0, 1 << bw, groups * 8) if bw else \
                np.zeros(groups * 8, np.int64)
            uvarint(groups << 1 | 1)
            planes = (vals[:, None] >> np.arange(bw)) & 1
            out += np.packbits(planes.reshape(-1).astype(np.uint8),
                               bitorder="little").tobytes()
            values.append(vals)
            ln = groups * 8  # a bit-packed run holds whole groups
        left -= ln
        k += 1
    return bytes(out), np.concatenate(values)[:n]


HYBRID_WIDTHS = (0, 1, 2, 8, 15, 16, 17, 18, 24)


def hybrid_chunk(rng, n_segs: int, gap_at: int = -1, gap: int = 0):
    """A column chunk of `n_segs` random hybrid segments staged in one
    buffer as the decode stages them, each page at an offset that is not
    a multiple of 8 between bytes that no value may read (0xA5): a
    header prefix, the stream (RLE, bit-packed, mixed, or a page without
    hybrid values: no runs), its last byte cut off now and then, zero
    padding; 0-, 1- and up to 3,000-value segments at the widths above.
    `gap` bytes of 0xA5 go before segment `gap_at`. Returns (buffer, the
    hybrid_segments streams, each segment's values where the cut lost
    none, else None)."""
    import numpy as np
    from bodo_tpu_torch.io import device_decode as DD
    pages, streams, truths, off = [], [], [], 5
    for s in range(n_segs):
        if s == gap_at:
            off += gap
        off += int(rng.integers(1, 8))
        off += off % 8 == 0
        n = int(rng.choice([0, 1, int(rng.integers(2, 3001))],
                           p=[0.1, 0.1, 0.8]))
        bw = int(rng.choice(HYBRID_WIDTHS))
        kind = str(rng.choice(["rle", "packed", "mixed", "none"],
                              p=[0.25, 0.3, 0.4, 0.05]))
        prefix = rng.integers(0, 256, int(rng.integers(0, 6)),
                              dtype=np.uint8).tobytes()
        stream, values = encode_hybrid(
            rng, n, int(rng.integers(1, 60)), bw,
            "mixed" if kind == "none" else kind) if n else (b"", [])
        page = prefix + stream + b"\x00"
        rt = DD._parse_hybrid(page, len(prefix), len(page) - 1, bw, n)
        runs = [rt.starts, rt.is_rle, rt.vals, rt.bits]
        truth = np.asarray(values, np.int64)
        if kind == "none":
            runs = [a[:0] for a in runs]
            truth = np.zeros(n, np.int64)
        cut = int(rng.random() < 0.15 and kind == "packed" and n > 0)
        if cut:
            truth = None
        page = page[:len(page) - 1 - cut] + bytes(int(rng.integers(0, 9)))
        if not page:
            page = b"\x00"
        pages.append((off, page))
        streams.append((n, off, off + len(page), bw, *runs))
        truths.append(truth)
        off += len(page)
    buf = np.full(off + 13, 0xA5, np.uint8)
    for at, page in pages:
        buf[at:at + len(page)] = np.frombuffer(page, np.uint8)
    return buf, streams, truths


def check_hybrid_expand(dev):
    """Phase 1 for hybrid_expand: bit-identity with its plain version.
    One page at a time (the per-page entry, a one-segment launch): RLE-
    only, bit-packed-only and mixed streams of 1, 100 and 20,000 values
    at bit widths 0, 1, 2, 8, 17 and 24, parsed into run tables padded to
    40 and 4,096 runs, over the whole padded output. A chunk in one
    launch (hybrid_expand_segments): random chunks of 1 to 200 segments
    at widths 0, 1, 2, 8, 15-18 and 24 (hybrid_chunk), one of them
    staged past 256 MiB so that bit offsets pass 2^31."""
    import numpy as np
    import torch
    from bodo_tpu_torch.io import device_decode as DD
    from bodo_tpu_torch.ops import cuda_kernels as CK

    rng = np.random.default_rng(SEED + 5)
    for bw in (0, 1, 2, 8, 17, 24):
        cases = 0
        for kind in ("rle", "packed", "mixed"):
            for n in (1, 100, 20_000):
                for table in (40, 4096):
                    stream, values = encode_hybrid(rng, n, table, bw, kind)
                    rt = DD._parse_hybrid(stream, 0, len(stream), bw, n)
                    n_bucket = DD._bucket(n, 128)
                    k = len(rt.starts)
                    padded = [np.concatenate([a, np.full(table - k, v,
                                                         a.dtype)])
                              for a, v in ((rt.starts, n_bucket + 1),
                                           (rt.is_rle, False),
                                           (rt.vals, 0), (rt.bits, 0))]
                    data = np.zeros(DD._bucket(len(stream) + 4, 4096),
                                    np.uint8)
                    data[:len(stream)] = np.frombuffer(stream, np.uint8)
                    args = [torch.from_numpy(a).to(dev)
                            for a in (data, *padded)]
                    got = CK.hybrid_expand(*args, bw, n_bucket)
                    want = CK.hybrid_expand_plain(*args, bw, n_bucket)
                    torch.cuda.synchronize()
                    ok = bool(torch.equal(got, want)) and np.array_equal(
                        got[:n].cpu().numpy(), values)
                    if not ok:
                        raise AssertionError(
                            f"hybrid_expand differs from its plain version "
                            f"or the stream at bw={bw} {kind} n={n} "
                            f"runs={k}/{table}")
                    cases += 1
        print(f"hybrid_expand bw={bw}: bit_identical=True on {cases} "
              f"pages (rle, packed and mixed; 1, 100 and 20000 values; "
              f"run tables of 40 and 4096), every output of the padded "
              f"n_bucket compared, the values equal to the stream's")
    big = 257 << 20  # bytes before the last segments: bits past 2^31
    for n_segs, gap_at in ((1, -1), (2, -1), (7, -1), (50, -1), (200, -1),
                           (200, -1), (200, -1), (120, 100)):
        buf, streams, truths = hybrid_chunk(rng, n_segs, gap_at,
                                            big if gap_at >= 0 else 0)
        tables = CK.hybrid_segments(streams)
        segs = tables[0]
        n_total = int(segs[:, CK.SEG_N].sum())
        args = [torch.from_numpy(a).to(dev) for a in (buf, *tables)]
        before = CK.launches["hybrid_expand"]
        got = CK.hybrid_expand_segments(*args, n_total)
        want = CK.hybrid_expand_segments_plain(*args, n_total)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        host = got.cpu().numpy()
        for s, truth in enumerate(truths):
            base, n = int(segs[s, CK.SEG_BASE]), int(segs[s, CK.SEG_N])
            if truth is not None and not np.array_equal(
                    host[base:base + n], truth):
                same = False
        widths = sorted({int(w) for w in segs[:, CK.SEG_BW]})
        print(f"hybrid_expand chunk: segments={n_segs} values={n_total} "
              f"runs={len(tables[1])} staged_bytes={buf.shape[0]} "
              f"widths={widths} max_bit_offset="
              f"{int(tables[4].max()) if len(tables[4]) else 0}: "
              f"bit_identical={same} launches="
              f"{CK.launches['hybrid_expand'] - before}")
        if not same:
            raise AssertionError(f"hybrid_expand_segments differs from its "
                                 f"plain version or the streams "
                                 f"({n_segs} segments)")
        del args, got, want


def _groupby_sum_case(g, dev, n: int, k: int, c: int):
    """codes in [0, K) with 3% outside (-1 or K), C columns (every third
    a count: values None) at several scales, masks with 20% unset."""
    import torch
    codes = torch.randint(0, k, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    bad = torch.rand(n, generator=g, device=dev) < 0.03
    low = torch.rand(n, generator=g, device=dev) < 0.5
    codes = torch.where(bad, torch.where(low, -1, k), codes).to(torch.int32)
    cols = [None if j % 3 == 0 else
            torch.randn(n, generator=g, device=dev) * 10.0 ** (j % 5 - 2)
            for j in range(c)]
    masks = [torch.rand(n, generator=g, device=dev) < 0.8 for _ in range(c)]
    return codes, cols, masks


def groupby_sums64(codes, cols, masks, k: int):
    """float64 sums [K, C] of what groupby_sum adds, and each slot's sum of
    |x| (the tolerance's scale)."""
    import torch
    idx = torch.where((codes >= 0) & (codes < k), codes.long(), k)
    sums, absums = [], []
    for v, m in zip(cols, masks):
        x = m.double() if v is None else torch.where(m, v.double(), 0.0)
        z = torch.zeros(k + 1, dtype=torch.float64, device=codes.device)
        sums.append(z.index_add(0, idx, x)[:k])
        absums.append(z.index_add(0, idx, x.abs())[:k])
    return torch.stack(sums, 1), torch.stack(absums, 1)


def hold_groupby_sum(got, s64, a64, cols, label: str) -> float:
    """Counts (columns given None) exactly equal to the float64 count,
    every sum within SUM_TOL * sum(|x|) of the float64 sum. Returns the
    largest |got - s64| / (SUM_TOL * sum(|x|))."""
    import torch
    from bodo_tpu_torch.workloads.f32_groupby import SUM_TOL
    err = (got.double() - s64).abs()
    bound = SUM_TOL * a64
    over = err > bound
    counts = [j for j, v in enumerate(cols) if v is None]
    exact = bool(torch.equal(got[:, counts].double(), s64[:, counts]))
    if bool(over.any()) or not exact:
        raise AssertionError(f"groupby_sum {label}: counts exact={exact}, "
                             f"{int(over.sum())} sums past the bound, max "
                             f"|err| {float(err.max())}")
    ratio = err / torch.where(bound > 0, bound, 1.0)
    return float(ratio.max()) if ratio.numel() else 0.0


def check_groupby_sum(dev):
    """Phase 1 for groupby_sum: at N in {0, 1, 1000, 4099, 1,000,003,
    2^24} rows (tails of the 4-row loads), K in {1, 64, 4096} slots and C
    in {1, 4, 16} columns, with masked rows and codes outside [0, K), the
    kernel and its plain version each against the float64 sums (counts
    exact, sums within SUM_TOL * sum(|x|) per slot); K = 4096 with C = 16
    takes more than one column tile. Then codes, masks and values as
    views at odd element offsets, columns that share masks and values,
    and two calls back to back, each against the float64 sums."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    for n in (0, 1, 1000, 4099, 1_000_003, F32_ROWS):
        for k in (1, 64, CK.MAX_MATMUL_SLOTS):
            for c in (1, 4, 16):
                codes, cols, masks = _groupby_sum_case(g, dev, n, k, c)
                got = CK.groupby_sum(codes, cols, masks, k)
                plain = CK.groupby_sum_plain(codes, cols, masks, k)
                s64, a64 = groupby_sums64(codes, cols, masks, k)
                torch.cuda.synchronize()
                label = f"N={n} K={k} C={c}"
                worst = hold_groupby_sum(got, s64, a64, cols, label)
                worst_plain = hold_groupby_sum(plain, s64, a64, cols,
                                               "plain " + label)
                width = CK.groupby_sum_tile_cols(k, c)
                tiles = -(-c // width)
                diff = float((got - plain).abs().max()) if n else 0.0
                print(f"groupby_sum {label}: column_tiles={tiles} "
                      f"(width {width}) counts_exact=True; |err| / "
                      f"({SUM_TOL_TEXT}) max kernel {worst:.6f}, plain "
                      f"{worst_plain:.6f}; max |kernel - plain| {diff}")
                if (k, c) == (CK.MAX_MATMUL_SLOTS, 16) and tiles < 2:
                    raise AssertionError("groupby_sum: K=4096 C=16 took "
                                         "one column tile")
                del codes, cols, masks, got, plain, s64, a64
    n = 1_000_003
    for k, c in ((64, 4), (CK.MAX_MATMUL_SLOTS, 16)):
        codes, cols, masks = _groupby_sum_case(g, dev, n + 3, k, c)
        # views 1, 2 and 3 elements off the 16-byte alignment
        views = (codes[1:n + 1],
                 [None if v is None else v[2:n + 2] for v in cols],
                 [m[3:n + 3] for m in masks])
        # the dense plan's sharing: column 1 counts what column 2 sums,
        # column 3 repeats column 0, column 4 sums column 2's values
        # under column 0's mask
        z, m0, m1 = cols[1][:n], masks[0][:n], masks[1][:n]
        shared = (codes[:n], [None, None, z, None, z], [m0, m1, m1, m0, m0])
        for label, (cd, cl, mk) in (("views at element offsets 1-3", views),
                                    ("shared masks and values", shared)):
            got = CK.groupby_sum(cd, cl, mk, k)
            s64, a64 = groupby_sums64(cd, cl, mk, k)
            torch.cuda.synchronize()
            worst = hold_groupby_sum(got, s64, a64, cl,
                                     f"{label} N={n} K={k}")
            print(f"groupby_sum {label} N={n} K={k} C={len(mk)}: counts "
                  f"exact, max |err| / ({SUM_TOL_TEXT}) {worst:.6f}")
        first = CK.groupby_sum(*views, k)  # no sync between the two
        second = CK.groupby_sum(*views, k)
        s64, a64 = groupby_sums64(*views, k)
        torch.cuda.synchronize()
        for j, got in enumerate((first, second)):
            worst = hold_groupby_sum(got, s64, a64, views[1],
                                     f"back to back {j + 1} N={n} K={k}")
            print(f"groupby_sum back to back, call {j + 1}, N={n} K={k} "
                  f"C={c}: counts exact, max |err| / ({SUM_TOL_TEXT}) "
                  f"{worst:.6f}")
        del codes, cols, masks, views, shared, first, second, z, m0, m1


def groupby_sum_bytes(codes, cols, masks, k: int) -> int:
    """The bytes groupby_sum must move: the codes, each distinct value
    column and each distinct mask read once, the [K, C] sums written
    once."""
    n = codes.shape[0]
    vals = {v.data_ptr() for v in cols if v is not None}
    oks = {m.data_ptr() for m in masks}
    return 4 * n + 4 * n * len(vals) + n * len(oks) + 4 * k * len(masks)


def time_groupby_sum(args):
    """Hold groupby_sum against its plain version and the float64 sums on
    the inputs the f32 dense path gave it, and time both there, with one
    index_add_ of the same [K, C] sums (values stacked and masked
    beforehand) as the library call."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    codes, cols, masks, k = args
    got = CK.groupby_sum(*args)
    plain = CK.groupby_sum_plain(*args)
    s64, a64 = groupby_sums64(codes, cols, masks, k)
    torch.cuda.synchronize()
    worst = hold_groupby_sum(got, s64, a64, cols, "(f32 dense path's call)")
    hold_groupby_sum(plain, s64, a64, cols, "plain (f32 dense path's call)")
    err = float((got - plain).abs().max())
    n, c = codes.shape[0], len(masks)
    print(f"groupby_sum (f32 dense path's call) N={n} K={k} C={c} "
          f"value_columns={sum(v is not None for v in cols)} "
          f"live_rows={int(masks[0].sum())}: counts exact, sums within "
          f"{SUM_TOL_TEXT} (max ratio {worst:.6f}); max |kernel - plain| "
          f"{err}")
    stacked = torch.stack([m.float() if v is None else torch.where(m, v, 0.0)
                           for v, m in zip(cols, masks)], 1)
    idx = codes.long()
    if not bool(((idx >= 0) & (idx < k)).all()):
        raise AssertionError("groupby_sum: the dense path's codes leave "
                             "[0, K)")
    kernel_ms = device_ms(lambda: CK.groupby_sum(*args))
    plain_ms = device_ms(lambda: CK.groupby_sum_plain(*args))
    library_ms = device_ms(lambda: torch.zeros(
        k, c, device=codes.device).index_add_(0, idx, stacked))
    kernel_ms_again = device_ms(lambda: CK.groupby_sum(*args))
    # where the kernel's time goes: the same rows with every mask unset
    # (code and mask loads only: no value loads, no atomics), and with
    # the codes spread over 4096 slots (the same atomics on 64 times as
    # many addresses)
    off = [torch.zeros_like(m) for m in masks]
    loads_ms = device_ms(lambda: CK.groupby_sum(codes, cols, off, k))
    wide = CK.MAX_MATMUL_SLOTS
    spread = codes * (wide // k) + torch.randint(
        0, wide // k, codes.shape, device=codes.device, dtype=torch.int32)
    spread_ms = device_ms(lambda: CK.groupby_sum(spread, cols, masks, wide))
    print(f"groupby_sum where the time goes N={n}: masks all unset (code "
          f"and mask loads only) {loads_ms:.6f} ms; codes spread over "
          f"K={wide} slots {spread_ms:.6f} ms")
    del off, spread
    nbytes = groupby_sum_bytes(codes, cols, masks, k)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    stacked_bytes = 4 * n + 4 * n * c + 4 * k * c
    print(f"groupby_sum timing N={n} K={k} C={c}: kernel_ms={kernel_ms:.6f} "
          f"(again {kernel_ms_again:.6f}) plain_ms={plain_ms:.6f} "
          f"library_ms(index_add_ of the stacked [N, C] values)="
          f"{library_ms:.6f} bound_ms={bound_ms:.6f} ({nbytes} bytes at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s: codes, distinct value columns "
          f"and masks, sums; a stacked [N, C] interface would move "
          f"{stacked_bytes} bytes, "
          f"{stacked_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms)")
    return {"name": "groupby_sum", "route": "cuda",
            "source": "bodo_tpu_torch/csrc/groupby_sum.cu",
            "replaces": "bodo_tpu/ops/pallas_kernels.py:92",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def no_f32_accumulate(launches, label: str) -> None:
    """The float64 paths: the reference's gates refuse f64 sums and means
    (and slot spaces over 4096), so groupby_sum must not run."""
    if launches["groupby_sum"] != 0:
        raise AssertionError(f"{label}: groupby_sum launched "
                             f"{launches['groupby_sum']} times on a float64 "
                             f"path")


def run_f32_groupby():
    """The f32 groupby at F32_ROWS rows: the dense query (filter, x + x,
    the dense groupby of 64 slots) and the sparse query (the hashed
    groupby of 300 int64 keys), each with the counts reset just before
    and read just after, cold and warm, against the float64 numpy oracle
    (keys and counts exact, sums per SUM_TOL); a traced dense run.
    Returns (the launches of the dense and the sparse run, the arguments
    of the groupby_sum call of a later dense run)."""
    import numpy as np
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.table.table import Table
    from bodo_tpu_torch.workloads import f32_groupby as F
    from bodo_tpu_torch.workloads import profiling

    t0 = time.perf_counter()
    dense_np, sparse_np = F.gen_f32_arrays(F32_ROWS, seed=SEED)
    dense = Table.from_numpy(dense_np)
    sparse = Table.from_numpy(sparse_np)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    phases = (("f32 dense", dense, dense_np, F.pipeline_dense, F.numpy_dense,
               "groupby_dense"),
              ("f32 sparse", sparse, sparse_np, F.pipeline_sparse,
               F.numpy_sparse, "groupby_hashed"))
    launches = {}
    for label, table, arrays, pipeline, numpy_fn, route in phases:
        torch.cuda.reset_peak_memory_stats()
        R.reset_route_counts()
        CK.reset_launches()
        t0 = time.perf_counter()
        out = pipeline(table)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        routes = {k: v for k, v in R.route_counts.items() if v}
        launches[label] = dict(CK.launches)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        pipeline(table)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = numpy_fn(arrays)
        oracle_s = time.perf_counter() - t0
        worst = F.check_against(out.to_numpy(), want)
        print(f"{label}: rows={table.nrows} capacity={table.capacity} "
              f"groups={out.nrows} setup_s={setup_s:.3f} "
              f"pipeline_s={wall_s:.4f} pipeline_warm_s={warm_s:.4f} "
              f"max_memory_allocated={peak} numpy_oracle_s={oracle_s:.3f}")
        print(f"{label}: route_counts={routes} "
              f"kernel_launches={launches[label]}")
        print(f"{label}: matches the float64 numpy oracle (keys and counts "
              f"exact, sums within {SUM_TOL_TEXT}, means within it over "
              f"the count; max ratio {worst:.6f})")
        if routes.get(route, 0) != 1 or launches[label]["groupby_sum"] < 1:
            raise AssertionError(f"{label}: route {route} or groupby_sum not "
                                 f"taken: {routes} {launches[label]}")
        if out.nrows != len(np.unique(arrays["k"])):
            raise AssertionError(f"{label}: {out.nrows} groups")
        del out
    tr = profiling.trace(lambda: F.pipeline_dense(dense))
    print(f"f32 dense (traced): traced_wall_s={tr['traced_wall_s']:.4f} "
          f"device_ms={tr['device_ms']:.3f} "
          f"device_busy_share={tr['device_busy_share']:.4f}")
    for r in tr["top_ops_device_ms"][:8]:
        print(f"f32 dense (traced): operator {r['ms']:.3f} ms x{r['calls']} "
              f"{r['op'][:100]}")
    for r in tr["top_kernels_ms"][:8]:
        print(f"f32 dense (traced): device {r['ms']:.3f} ms x{r['calls']} "
              f"{r['kernel'][:100]}")
    with _Capture("groupby_sum") as acc:
        F.pipeline_dense(dense)
    return launches["f32 dense"], launches["f32 sparse"], acc.calls[0]


def run_taxi_read(trips, weather, rep_got, oracle, data_dir: str):
    """The taxi read: write the 20M-row trips file as gen_taxi_data does
    (pandas' to_parquet with pyarrow's defaults) into `data_dir`, with
    its weather csv, read it through read_parquet's device route with
    the counts reset just before and read just after, and hold the table
    bit-identical to the arrays' table; then the pipeline from that file
    against the numpy oracle and, row for row, the REP run. Returns
    (kernel launches of the cold read, the arguments of every
    hybrid_expand_segments call of a later read: one a chunk that has
    dictionary-index pages, the trips file's and the csv's paths)."""
    import numpy as np
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.io import device_decode as DD
    from bodo_tpu_torch.io import parquet as P
    from bodo_tpu_torch.io.parquet import footer_metadata, read_parquet
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.workloads import profiling
    from bodo_tpu_torch.workloads import taxi as T

    path, csv = f"{data_dir}/trips.parquet", f"{data_dir}/weather.csv"
    t0 = time.perf_counter()
    T.gen_taxi_data(MAIN_ROWS, path, csv, seed=SEED)
    encode_s = time.perf_counter() - t0
    md = footer_metadata(path)
    codecs = sorted({c.compression for g in md.row_groups
                     for c in g.columns})
    if md.num_row_groups != READ_ROW_GROUPS:
        raise AssertionError(f"taxi read: {md.num_row_groups} row "
                             f"groups, want {READ_ROW_GROUPS}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DD.reset_decode_counts()
    CK.reset_launches()
    t0 = time.perf_counter()
    got = read_parquet(path)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = dict(DD.decode_counts)
    launches = dict(CK.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"taxi read: rows={got.nrows} row_groups={md.num_row_groups} "
          f"codecs={codecs} file_bytes={os.path.getsize(path)} "
          f"encode_s={encode_s:.3f} decode_s={decode_s:.4f} "
          f"max_memory_allocated={peak}")
    print(f"taxi read: decode_counts={counts} kernel_launches={launches}")
    want_cols = len(got.names) * md.num_row_groups
    if counts["host_decode_cols"] or \
            counts["device_decode_cols"] != want_cols:
        raise AssertionError(f"taxi read: not every column decoded on "
                             f"the device: {counts}")
    # a chunk has dictionary-index pages where it has a dictionary
    # page; the file has no nulls, so no definition-level launches
    dict_chunks = sum(c.dictionary_page_offset is not None
                      for g in md.row_groups for c in g.columns)
    print(f"taxi read: hybrid_expand launches="
          f"{launches['hybrid_expand']} (one a chunk with dictionary-"
          f"index pages: {dict_chunks} of {want_cols} chunks; "
          f"{counts['pages_dict']} dictionary-index pages)")
    if not 1 <= launches["hybrid_expand"] <= dict_chunks or \
            launches["dict_gather"] != md.num_row_groups:
        raise AssertionError(f"taxi read: hybrid_expand or dict_gather "
                             f"launches {launches}, {dict_chunks} "
                             f"chunks with dictionary pages")
    if got.names != trips.names or got.nrows != trips.nrows or \
            got.capacity != trips.capacity:
        raise AssertionError(f"taxi read: {got} vs the arrays' {trips}")
    for name in trips.names:
        a, b = got.column(name), trips.column(name)
        same = (a.dtype is b.dtype and a.valid is None
                and b.valid is None and a.vrange == b.vrange
                and bool(torch.equal(a.data[:got.nrows],
                                     b.data[:got.nrows])))
        if b.dictionary is not None:
            same = same and np.array_equal(a.dictionary, b.dictionary)
        if not same:
            raise AssertionError(f"taxi read: column {name} differs "
                                 f"from the arrays' table")
    print("taxi read: bit-identical to the arrays' table (data, no "
          "masks, dictionaries; vranges are the footer's min/max, "
          "equal to the arrays')")
    del got

    t0 = time.perf_counter()
    read_parquet(path)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with _Capture("hybrid_expand_segments") as expand:
        tr = profiling.trace(lambda: read_parquet(path))
    device_calls = sum(r["calls"] for r in tr["top_kernels_ms"])
    print(f"taxi read: decode_warm_s={warm_s:.4f} "
          f"traced_wall_s={tr['traced_wall_s']:.4f} "
          f"device_ms={tr['device_ms']:.3f} "
          f"device_busy_share={tr['device_busy_share']:.4f} "
          f"device_calls(top 25 rows)={device_calls}")
    for r in tr["port_kernels_ms"]:
        print(f"taxi read (traced): port kernel {r['ms']:.3f} ms "
              f"x{r['calls']} {r['kernel'][:100]}")
    for r in tr["top_kernels_ms"][:10]:
        print(f"taxi read: device {r['ms']:.3f} ms x{r['calls']} "
              f"{r['kernel'][:100]}")
    for r in tr["top_ops_device_ms"][:12]:
        print(f"taxi read: operator {r['ms']:.3f} ms x{r['calls']} "
              f"{r['op'][:100]}")
    # where the read's wall goes, each stage and substage synchronized
    # (the syncs add to the total)
    spent = profiling.stage_means(
        lambda: read_parquet(path), 1,
        [(P, "footer_metadata"), (DD, "fetch_row_group"),
         (DD, "decode_row_group"), (DD, "concat_tables_rep")],
        [(P, "_raw_range", "raw range reads"),
         (DD, "_decompress", "page decompression"),
         (DD, "_parse_hybrid", "run-header walks"),
         (DD, "_stage_chunk", "chunk staging (host)"),
         (DD._Staging, "to", "staging copy to the device"),
         (DD, "_run_chunk_program", "chunk decodes"),
         (CK, "dict_gather", "dict_gather")])
    print("taxi read: stages (s, synchronized host clock, one read): "
          + ", ".join(f"{k} {v:.4f}" for k, v in spent.items()))
    # the host route on the same file: pyarrow's decode and the copy
    # to the card, which the device route replaces as the default
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        host = P._read_host([path], None, "cuda")
        torch.cuda.synchronize()
        print(f"taxi read: host route (pyarrow decode + copy to the "
              f"device, no footer ranges) {run} "
              f"s={time.perf_counter() - t0:.4f}")
        del host

    R.reset_route_counts()
    CK.reset_launches()
    t0 = time.perf_counter()
    out = T.pipeline(path, weather)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    routes = {k: v for k, v in R.route_counts.items() if v}
    file_launches = dict(CK.launches)
    res = out.to_numpy()
    T.check_against(res, oracle, rtol=AVG_RTOL)
    T.check_against(res, rep_got, rtol=AVG_RTOL)
    print(f"taxi read -> pipeline: groups={out.nrows} wall_s={wall_s:.4f} "
          f"(read included) route_counts={routes} "
          f"kernel_launches={file_launches}")
    print(f"taxi read -> pipeline: matches the numpy oracle (avg_miles "
          f"rtol={AVG_RTOL}) and, row for row, the REP run from arrays")
    if file_launches["hybrid_expand"] < 1 or \
            file_launches["dict_gather"] != READ_ROW_GROUPS or \
            file_launches["lut_gather"] < 1:
        raise AssertionError(f"taxi read -> pipeline: launches "
                             f"{file_launches}")
    no_f32_accumulate(file_launches, "taxi read -> pipeline")
    return launches, expand.calls, path, csv


def hybrid_expand_bytes(segs, starts, is_rle, bits) -> int:
    """The bytes hybrid_expand must move for a chunk: each segment's row
    of the table (56 B), the run fields (17 B) of each run that owns a
    value, the page bytes that the bit-packed runs' values occupy (the
    staged padding and the neighbouring pages' bytes are none of them)
    and the int32 outputs, each once."""
    import numpy as np
    segs = segs.cpu().numpy()
    st_all = starts.cpu().numpy().astype(np.int64)
    rle_all, bits_all = is_rle.cpu().numpy(), bits.cpu().numpy()
    runs = page = 0
    for base, n, lo, hi, bw, run_lo, run_hi in segs.tolist():
        st = st_all[run_lo:run_hi] - base
        live = st < n
        runs += int(live.sum())
        if bw == 0 or not len(st):
            continue
        ends = np.append(st[1:], n).clip(max=n)
        packed = live & ~rle_all[run_lo:run_hi]
        first = bits_all[run_lo:run_hi][packed]
        last = first + (ends[packed] - st[packed]) * bw
        covered = np.zeros(hi - lo, bool)
        for a, b in zip((first >> 3) - lo, ((last + 7) >> 3) - lo):
            covered[max(a, 0):min(b, hi - lo)] = True
        page += int(covered.sum())
    return 56 * len(segs) + 17 * runs + page + 4 * int(segs[:, 1].sum())


def time_hybrid_expand(calls, label: str = "taxi read",
                       one_page: bool = True):
    """Hold hybrid_expand_segments against its plain version on the
    read's largest chunk (`calls`: the arguments of each chunk launch of
    a read) and time both there, beside its bound; then, with
    `one_page`, time the read's first bw = 8 page of 20,000 values as
    one segment (the kernel, and the per-page entry, which copies its
    one-row table first)."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK

    args = max(calls, key=lambda a: (a[-1], a[1].shape[0]))
    data, segs, starts, is_rle, vals, bits, n_total = args
    got = CK.hybrid_expand_segments(*args)
    want = CK.hybrid_expand_segments_plain(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"hybrid_expand differs from its plain "
                             f"version on the {label}'s largest chunk")
    kernel_ms = device_ms(lambda: CK.hybrid_expand_segments(*args))
    plain_ms = device_ms(lambda: CK.hybrid_expand_segments_plain(*args))
    kernel_ms_again = device_ms(lambda: CK.hybrid_expand_segments(*args))
    nbytes = hybrid_expand_bytes(segs, starts, is_rle, bits)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    table = segs.cpu().tolist()
    widths = sorted({row[CK.SEG_BW] for row in table})
    print(f"hybrid_expand timing ({label}'s largest chunk, of "
          f"{len(calls)} chunk launches) "
          f"segments={len(table)} values={n_total} runs={starts.shape[0]} "
          f"widths={widths} staged_bytes={data.shape[0]}: "
          f"bit_identical=True kernel_ms={kernel_ms:.6f} (again "
          f"{kernel_ms_again:.6f}) plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6f} ({nbytes} bytes at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); library_ms=null (no single "
          f"PyTorch call expands parquet hybrid runs)")
    row = {"name": "hybrid_expand", "route": "cuda",
           "source": "bodo_tpu_torch/csrc/hybrid_expand.cu",
           "replaces": "bodo_tpu/ops/pallas_kernels.py:536",
           "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
           "chunk_segments": len(table), "chunk_values": n_total}
    if not one_page:
        return row
    found = [(a, row) for a in calls for row in a[1].cpu().tolist()
             if row[CK.SEG_BW] == 8 and row[CK.SEG_N] == 20_000]
    if not found:
        print("hybrid_expand timing: no bw=8 page of 20000 values in the "
              "read; the one-segment time was not measured")
        return row
    (data, segs, starts, is_rle, vals, bits, n_total), \
        (base, n, lo, hi, bw, run_lo, run_hi) = found[0]
    runs = slice(run_lo, run_hi)
    page = (data[lo:hi], (starts[runs] - base).contiguous(),
            is_rle[runs], vals[runs], (bits[runs] - 8 * lo).contiguous(),
            bw, n)
    got = CK.hybrid_expand(*page)
    chunk = CK.hybrid_expand_segments_plain(data, segs, starts, is_rle,
                                            vals, bits, n_total)
    if not torch.equal(got, chunk[base:base + n]):
        raise AssertionError("hybrid_expand's one-segment launch differs "
                             "from the chunk's plain version")
    # the kernel on one segment, its table already on the card (the
    # per-page entry copies its one-row table from the host first, which
    # syncs the host with the card, so it is timed apart)
    one = torch.tensor([[0, n, 0, hi - lo, bw, 0, run_hi - run_lo]],
                       dtype=torch.int64, device=data.device)
    single = (page[0], one, *page[1:5], n)
    page_ms = device_ms(lambda: CK.hybrid_expand_segments(*single))
    page_plain_ms = device_ms(lambda: CK.hybrid_expand_plain(*page))
    entry_ms = device_ms(lambda: CK.hybrid_expand(*page))
    page_bytes = hybrid_expand_bytes(one, *page[1:3], page[4])
    page_bound_ms = page_bytes / HBM_BYTES_PER_S * 1e3
    print(f"hybrid_expand timing (one page as one segment) bw={bw} "
          f"n_values={n} runs={run_hi - run_lo}: bit_identical=True "
          f"kernel_ms={page_ms:.6f} plain_ms={page_plain_ms:.6f} "
          f"bound_ms={page_bound_ms:.7f} ({page_bytes} bytes); the "
          f"per-page entry with its table copy {entry_ms:.6f} ms")
    row.update(page_ms=page_ms, page_plain_ms=page_plain_ms,
               page_bound_ms=page_bound_ms)
    return row


def run_star():
    """Drive the star join at STAR_ROWS fact rows with the counts reset
    just before and read just after; check it against the numpy oracle.
    Returns (kernel launch counts of that run, the arguments of the
    hash_probe launch of a later run, for timing; the tables, arrays and
    oracle, for the 1D phase)."""
    import numpy as np
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.workloads import star_join as S

    t0 = time.perf_counter()
    fact_np, dim_np = S.gen_star_arrays(STAR_ROWS, seed=SEED)
    fact, dim = S.tables_from_arrays(fact_np, dim_np)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    R.reset_route_counts()
    CK.reset_launches()
    t0 = time.perf_counter()
    out = S.pipeline(fact, dim)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    routes = dict(R.route_counts)
    launches = dict(CK.launches)
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    S.pipeline(fact, dim)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    got = {n: out.column(n).data[:out.nrows].cpu().numpy()
           for n in out.names}
    t0 = time.perf_counter()
    oracle = S.numpy_pipeline(fact_np, dim_np)
    oracle_s = time.perf_counter() - t0
    S.check_against(got, oracle, rtol=AVG_RTOL)
    n_probe = int(np.count_nonzero(fact_np["y"] % 3 != 0))
    print(f"star path: fact_rows={STAR_ROWS} dim_rows={len(dim_np['k'])} "
          f"probe_rows={n_probe} groups={out.nrows} setup_s={setup_s:.3f} "
          f"pipeline_s={wall_s:.4f} pipeline_warm_s={warm_s:.4f} "
          f"max_memory_allocated={peak} numpy_oracle_s={oracle_s:.3f}")
    print(f"star path: route_counts={routes} kernel_launches={launches}")
    print(f"star path: matches the numpy oracle (g and c exact, s "
          f"rtol={AVG_RTOL})")
    missing = [r for r in ("join_hash", "groupby_dense") if routes[r] < 1]
    if missing or launches["hash_probe"] < 1:
        raise AssertionError(f"star path: routes {missing} not taken or "
                             f"hash_probe not launched: {launches}")
    no_f32_accumulate(launches, "star path")

    # one more run, keeping the inputs of its hash_probe launch
    with _Capture("hash_probe") as probe:
        S.pipeline(fact, dim)
    return launches, probe.calls[0], (fact, dim, oracle, fact_np, dim_np)


def run_star_1d(fact, dim, oracle):
    """Drive the star join with shard=True on SHARDS shards of the card,
    on the REP phase's tables, with the memory governor off (the JAX
    package's BODO_TPU_MEM_GOVERNOR=0), so the phase times the same
    calls whatever the card's free memory: the shuffle join (both sides
    hashed to their key's shard, partition_rank on every shard), the
    sharded groupby and sort (range_partition); check it against the
    numpy oracle. Returns the arguments of every hash_probe and every
    range_partition call of a later run, for timing."""
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.workloads import star_join as S

    torch.cuda.reset_peak_memory_stats()
    R.reset_route_counts()
    CK.reset_launches()
    t0 = time.perf_counter()
    out = S.pipeline(fact, dim, shard=True, n_shards=SHARDS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    routes = {k: v for k, v in R.route_counts.items() if v}
    launches = dict(CK.launches)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    S.pipeline(fact, dim, shard=True, n_shards=SHARDS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    S.check_against(out.to_numpy(), oracle, rtol=AVG_RTOL)
    print(f"star path 1D (mem_governor off): shards={SHARDS} "
          f"groups={out.nrows} shard_groups={out.counts.tolist()} "
          f"pipeline_s={wall_s:.4f} pipeline_warm_s={warm_s:.4f} "
          f"max_memory_allocated={peak}")
    print(f"star path 1D: route_counts={routes} kernel_launches={launches}")
    print(f"star path 1D: matches the numpy oracle (g and c exact, s "
          f"rtol={AVG_RTOL})")
    if routes.get("join_shuffle", 0) < 1 or launches["partition_rank"] < 1 \
            or launches["hash_probe"] < 1 or launches["range_partition"] < 1:
        raise AssertionError(f"star path 1D: shuffle join or its kernels "
                             f"not taken: {routes} {launches}")
    no_f32_accumulate(launches, "star path 1D")
    # one more run, keeping the inputs of its hash_probe and
    # range_partition launches
    with _Capture("hash_probe") as probe, \
            _Capture("range_partition") as rp:
        S.pipeline(fact, dim, shard=True, n_shards=SHARDS)
    range_launches_per_pass(launches, rp.calls, "star path 1D")
    return probe.calls, rp.calls


def _rows_matrix(cols):
    """Rows of (data, valid) columns as one float64 matrix, NaN where a
    value is null, sorted lexicographically (row multiset order)."""
    import numpy as np
    mat = np.stack([np.where(v, d.astype(np.float64), np.nan)
                    for d, v in cols], axis=1)
    return mat[np.lexsort(mat.T[::-1])]


def _join_oracle(dim, fact, how):
    """join_tables(dim, fact, ["k"], ["k"], how) rows, k g w v y, with
    numpy: every (dim, fact) pair of equal keys, then the unmatched rows
    of the side(s) the join keeps."""
    import numpy as np
    order = np.argsort(dim["k"], kind="stable")
    sk = dim["k"][order]
    pos = np.clip(np.searchsorted(sk, fact["k"]), 0, len(sk) - 1)
    hit = sk[pos] == fact["k"]
    d = order[pos[hit]]
    ones = np.ones(int(hit.sum()), bool)
    cols = [(fact["k"][hit], ones), (dim["g"][d], ones), (dim["w"][d], ones),
            (fact["v"][hit], ones), (fact["y"][hit], ones)]
    parts = [cols]
    if how in ("left", "outer"):
        lone = np.ones(len(dim["k"]), bool)
        lone[d] = False
        n = int(lone.sum())
        t, f = np.ones(n, bool), np.zeros(n, bool)
        parts.append([(dim["k"][lone], t), (dim["g"][lone], t),
                      (dim["w"][lone], t), (np.zeros(n), f),
                      (np.zeros(n), f)])
    if how in ("right", "outer"):
        n = int((~hit).sum())
        t, f = np.ones(n, bool), np.zeros(n, bool)
        parts.append([(fact["k"][~hit], t), (np.zeros(n), f),
                      (np.zeros(n), f), (fact["v"][~hit], t),
                      (fact["y"][~hit], t)])
    return _rows_matrix([
        (np.concatenate([p[i][0] for p in parts]),
         np.concatenate([p[i][1] for p in parts])) for i in range(5)])


def run_join_matrix():
    """The four join kinds of the dimension (probe) against the fact table
    (build, duplicate keys) at MATRIX_ROWS fact rows, each with the counts
    reset just before and read just after, against the numpy oracle by
    row multiset. The right join swaps the sides, so its build side is
    the dimension, whose unique keys take the hash join."""
    import numpy as np
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.workloads import star_join as S

    fact_np, dim_np = S.gen_star_arrays(MATRIX_ROWS, seed=SEED + 2)
    fact, dim = S.tables_from_arrays(fact_np, dim_np)
    want_route = {"inner": "join_rep_hash", "left": "join_rep_hash",
                  "right": "join_hash", "outer": "join_rep_hash"}
    for how, route in want_route.items():
        R.reset_route_counts()
        CK.reset_launches()
        t0 = time.perf_counter()
        out = R.join_tables(dim, fact, ["k"], ["k"], how)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        routes = {k: v for k, v in R.route_counts.items() if v}
        launches = dict(CK.launches)
        assert out.names == ["k", "g", "w", "v", "y"], out.names
        n = out.nrows
        got = _rows_matrix([
            (out.column(c).data[:n].cpu().numpy(),
             np.ones(n, bool) if out.column(c).valid is None
             else out.column(c).valid[:n].cpu().numpy())
            for c in out.names])
        want = _join_oracle(dim_np, fact_np, how)
        np.testing.assert_array_equal(got, want, err_msg=how)
        print(f"join matrix {how}: rows={n} wall_s={wall_s:.4f} "
              f"routes={routes} kernel_launches={launches}: matches the "
              f"numpy oracle (row multiset)")
        if routes != {route: 1} or launches["hash_probe"] < 1:
            raise AssertionError(f"join matrix {how}: routes {routes}, "
                                 f"launches {launches}")
        no_f32_accumulate(launches, f"join matrix {how}")


def run_taxi(n_rows: int, want_routes, label: str):
    """Drive the main path at `n_rows` with the counts reset just before
    and read just after; check it against the numpy oracle. Returns the
    kernel launch counts of that run, and (the tables, the result, the
    oracle) for the 1D phase."""
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
    no_f32_accumulate(launches, label)
    return launches, (trips, weather, got, oracle)


def run_taxi_1d(trips, weather, rep_got, oracle):
    """Drive the taxi path with shard=True at the REP phase's size on
    SHARDS shards, with the counts reset just before and read just
    after; check it against the numpy oracle and, row for row, against
    the REP run's result. Returns (kernel launch counts of that run, the
    arguments of every partition_rank, range_partition and hash_probe
    call of a later run, for timing)."""
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.workloads import taxi as T

    def run():
        return T.pipeline(trips, weather, shard=True, n_shards=SHARDS)

    torch.cuda.reset_peak_memory_stats()
    R.reset_route_counts()
    CK.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    routes = {k: v for k, v in R.route_counts.items() if v}
    launches = dict(CK.launches)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    got = out.to_numpy()
    T.check_against(got, oracle, rtol=AVG_RTOL)
    T.check_against(got, rep_got, rtol=AVG_RTOL)
    print(f"main path 1D: rows={trips.nrows} shards={SHARDS} "
          f"groups={out.nrows} shard_groups={out.counts.tolist()} "
          f"pipeline_s={wall_s:.4f} pipeline_warm_s={warm_s:.4f} "
          f"max_memory_allocated={peak}")
    print(f"main path 1D: route_counts={routes} kernel_launches={launches}")
    print(f"main path 1D: matches the numpy oracle and, row for row, the "
          f"REP run (keys and trip_count exact, avg_miles rtol={AVG_RTOL})")
    want = {"join_broadcast": 1, "groupby_packed": 1,
            "groupby_sharded_hash": 1, "sort_sharded": 1}
    if routes != want:
        raise AssertionError(f"main path 1D: routes {routes}, want {want}")
    for k in ("hash_probe", "partition_rank", "range_partition"):
        if launches[k] < 1:
            raise AssertionError(f"main path 1D: {k} not launched")
    no_f32_accumulate(launches, "main path 1D")
    with _Capture("partition_rank") as pr, \
            _Capture("range_partition") as rp, _Capture("hash_probe") as hp:
        run()
    range_launches_per_pass(launches, rp.calls, "main path 1D")
    if len(pr.calls) != launches["partition_rank"]:
        raise AssertionError(f"main path 1D: {len(pr.calls)} partition_rank "
                             f"calls in a later run, "
                             f"{launches['partition_rank']} in the first")
    if len(hp.calls) != launches["hash_probe"]:
        raise AssertionError(f"main path 1D: {len(hp.calls)} hash_probe "
                             f"calls in a later run, "
                             f"{launches['hash_probe']} in the first")
    return launches, pr.calls, rp.calls, hp.calls


def run_aggregations(trips, weather):
    """The decomposable aggregations on the taxi pipeline's joined table
    (workloads/taxi_aggs.py) at the REP phase's size: for REP and then 1D
    on SHARDS shards, with the route and launch counts set to 0 just
    before and read just after, the join, the groupby by the six keys
    with WIDE_AGGS (then sorted by them) and reduce_table with the same
    aggregations, each held to the pandas oracle; then the warm stage
    time of groupby_agg for WIDE_AGGS and for the pipeline's count/mean
    spec, and of reduce_table."""
    import contextlib

    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import taxi as T
    from bodo_tpu_torch.workloads import taxi_aggs as A

    t0 = time.perf_counter()
    want, want_red = A.pandas_oracle(*T.gen_taxi_arrays(MAIN_ROWS,
                                                        seed=SEED))
    print(f"aggregations: pandas oracle {time.perf_counter() - t0:.3f}s, "
          f"{len(want[T.KEYS[0]])} groups")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def warm_ms(fn):
        return statistics.median(timed(fn)[1] for _ in range(STAGE_REPS)) \
            * 1e3

    for label, shard in (("aggregations REP", False),
                         ("aggregations 1D", True)):
        mesh = use_mesh(make_mesh(SHARDS, trips.device)) if shard \
            else contextlib.nullcontext()
        with mesh:
            src = trips.shard() if shard else trips
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            R.reset_route_counts()
            CK.reset_launches()
            m, join_s = timed(lambda: T.joined(src, weather))
            out, groupby_s = timed(lambda: A.groupby(m))
            red, reduce_s = timed(lambda: A.reduce(m))
            routes = {k: v for k, v in R.route_counts.items() if v}
            launches = dict(CK.launches)
            peak = torch.cuda.max_memory_allocated()
            A.check_groupby(A.table_arrays(out), want, AGG_RTOL, MOMENT_TOL,
                            label)
            A.check_reduce(red, want_red, AGG_RTOL, MOMENT_TOL, label)
            wide_ms = warm_ms(lambda: R.groupby_agg(m, T.KEYS, A.WIDE_AGGS))
            cm_ms = warm_ms(lambda: R.groupby_agg(m, T.KEYS,
                                                  A.COUNT_MEAN_AGGS))
            red_ms = warm_ms(lambda: A.reduce(m))
        print(f"{label}: rows={m.nrows} groups={out.nrows} join_s="
              f"{join_s:.4f} groupby_sort_s={groupby_s:.4f} reduce_s="
              f"{reduce_s:.4f} (first run) max_memory_allocated={peak}")
        print(f"{label}: groupby_agg warm ms (median of {STAGE_REPS}): "
              f"wide spec {wide_ms:.3f}, count/mean spec {cm_ms:.3f}; "
              f"reduce_table {red_ms:.3f}")
        print(f"{label}: route_counts={routes} kernel_launches={launches}")
        print(f"{label}: groupby and reduce_table match the pandas oracle "
              f"(keys, min, max, first, last, prod and bool results equal; "
              f"sumnull/var/std rtol={AGG_RTOL}; skew/kurt |delta| <= "
              f"{MOMENT_TOL} * (1 + |x|))")
        no_f32_accumulate(launches, label)
        if shard:
            want_routes = ("join_broadcast", "groupby_sharded_hash",
                           "sort_sharded")
            for k in ("hash_probe", "partition_rank", "range_partition"):
                if launches[k] < 1:
                    raise AssertionError(f"{label}: {k} not launched")
        else:
            want_routes = ("join_dense", "groupby_dense", "sort_local")
            if launches["lut_gather"] != 1:
                raise AssertionError(f"{label}: {launches['lut_gather']} "
                                     f"lut_gather launches, want 1")
        missing = [r for r in want_routes if routes.get(r, 0) < 1]
        if missing:
            raise AssertionError(f"{label}: routes {missing} not taken")
        del m, out, src


def run_holistic(trips, weather):
    """The holistic aggregations on the taxi pipeline's joined table
    (workloads/taxi_aggs.py HOLISTIC_AGGS, HOLISTIC_REDUCE) at the REP
    phase's size, REP and then 1D on SHARDS shards: the join, the groupby
    by the six keys (then sorted by them) and reduce_table, each driven
    once with the route and launch counts set to 0 just before and read
    just after, its synchronized time and peak memory printed, and held
    to the numpy/pandas oracle (nunique and mode exact, the median and
    quantiles within HOLISTIC_RTOL); then the colocated groupby_agg alone
    on 1D, whose hash shuffle must launch partition_rank once a shard;
    then the warm times (median of STAGE_REPS) of groupby_agg and
    reduce_table. Returns the colocated groupby's launches."""
    import contextlib

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import taxi as T
    from bodo_tpu_torch.workloads import taxi_aggs as A

    t0 = time.perf_counter()
    want, want_red = A.holistic_oracle(*T.gen_taxi_arrays(MAIN_ROWS,
                                                          seed=SEED))
    print(f"holistic: numpy/pandas oracle {time.perf_counter() - t0:.3f}s,"
          f" {len(want[T.KEYS[0]])} groups")
    colocated = None
    for label, shard in (("holistic REP", False), ("holistic 1D", True)):
        mesh = use_mesh(make_mesh(SHARDS, trips.device)) if shard \
            else contextlib.nullcontext()
        with mesh:
            src = trips.shard() if shard else trips
            m, join_s, _, _, _ = _drive(lambda: T.joined(src, weather))
            out, gb_s, gb_routes, gb_launches, gb_peak = _drive(
                lambda: A.groupby(m, A.HOLISTIC_AGGS))
            red, red_s, red_routes, red_launches, red_peak = _drive(
                lambda: A.reduce(m, A.HOLISTIC_REDUCE))
            A.check_groupby(A.table_arrays(out), want, HOLISTIC_RTOL, 0.0,
                            label, A.HOLISTIC_AGGS)
            A.check_reduce(red, want_red, HOLISTIC_RTOL, 0.0, label,
                           A.HOLISTIC_REDUCE)
            print(f"{label}: rows={m.nrows} groups={out.nrows} join_s="
                  f"{join_s:.4f} groupby_sort_s={gb_s:.4f} "
                  f"groupby_max_memory_allocated={gb_peak} reduce_s="
                  f"{red_s:.4f} reduce_max_memory_allocated={red_peak} "
                  f"(first runs, synchronized)")
            print(f"{label}: groupby+sort route_counts={gb_routes} "
                  f"kernel_launches={gb_launches}")
            print(f"{label}: reduce_table route_counts={red_routes} "
                  f"kernel_launches={red_launches}")
            # REP: the six keys packed, then the sort groupby; the reduce's
            # one constant key: the sort groupby; 1D: colocated
            for routes, what, want_routes in (
                    (gb_routes, "groupby", ("groupby_packed", "groupby_sort")),
                    (red_routes, "reduce_table", ("groupby_sort",))):
                if shard:
                    want_routes = ("groupby_colocated",)
                missing = [r for r in want_routes if routes.get(r, 0) < 1]
                if missing:
                    raise AssertionError(f"{label} {what}: routes "
                                         f"{missing} not taken")
            no_f32_accumulate(gb_launches, label)
            no_f32_accumulate(red_launches, label)
            if shard:
                _, coloc_s, coloc_routes, colocated, coloc_peak = _drive(
                    lambda: R.groupby_agg(m, T.KEYS, A.HOLISTIC_AGGS))
                print(f"{label}: groupby_agg alone: s={coloc_s:.4f} "
                      f"max_memory_allocated={coloc_peak} route_counts="
                      f"{coloc_routes} kernel_launches={colocated}")
                if coloc_routes != {"groupby_colocated": 1} or \
                        colocated["partition_rank"] != SHARDS:
                    raise AssertionError(
                        f"{label}: the colocated groupby took "
                        f"{coloc_routes} with {colocated['partition_rank']}"
                        f" partition_rank launches, want {SHARDS}")
            gb_ms = _warm_s(lambda: R.groupby_agg(m, T.KEYS,
                                                  A.HOLISTIC_AGGS)) * 1e3
            red_ms = _warm_s(lambda: A.reduce(m, A.HOLISTIC_REDUCE)) * 1e3
        print(f"{label}: warm ms (median of {STAGE_REPS}): groupby_agg "
              f"{gb_ms:.3f}, reduce_table {red_ms:.3f}")
        print(f"{label}: groupby and reduce_table match the oracle "
              f"(keys, nunique and mode exact; median and quantiles "
              f"rtol={HOLISTIC_RTOL})")
        del m, out, src
    return colocated


class _PortConfig:
    """Set fields of the port's config for a block, then put them back."""

    def __init__(self, **fields):
        self.fields, self.saved = fields, {}

    def __enter__(self):
        from bodo_tpu_torch.config import config
        for k, v in self.fields.items():
            self.saved[k] = getattr(config, k)
            setattr(config, k, v)

    def __exit__(self, *exc):
        from bodo_tpu_torch.config import config
        for k, v in self.saved.items():
            setattr(config, k, v)


def _drive(fn):
    """Run `fn` once with the route and launch counts set to 0 just
    before and read just after. Returns (its result, wall seconds, the
    routes taken, the kernel launches, max_memory_allocated)."""
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    R.reset_route_counts()
    CK.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    routes = {k: v for k, v in R.route_counts.items() if v}
    return (out, wall_s, routes, dict(CK.launches),
            torch.cuda.max_memory_allocated())


def _warm_s(fn) -> float:
    """Median wall seconds of STAGE_REPS further runs of `fn`."""
    import torch
    times = []
    for _ in range(STAGE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _report(label, wall_s, warm_s, peak, routes, launches, want_routes,
            want_launches, extra: str = "") -> None:
    """Print a phase's numbers; raise unless every route of `want_routes`
    and every kernel of `want_launches` ran in the driven run."""
    print(f"{label}: pipeline_s={wall_s:.4f} pipeline_warm_s={warm_s:.4f} "
          f"(median of {STAGE_REPS}) max_memory_allocated={peak}{extra}")
    print(f"{label}: route_counts={routes} kernel_launches={launches}")
    missing = [r for r in want_routes if routes.get(r, 0) < 1]
    missing += [k for k in want_launches if launches[k] < 1]
    if missing:
        raise AssertionError(f"{label}: {missing} not taken or launched")
    no_f32_accumulate(launches, label)


def run_star_governor(fact, dim, oracle, fact_np, dim_np):
    """The star join with shard=True under the reference's defaults (the
    memory governor on): the governor's budget a shard, the build's
    bytes and the decision printed; then the star against the half of
    the dimension with g < 16 (workloads/join_family.star_filtered_dim),
    a build over bcast_join_threshold rows that fits the budget's
    broadcast share: promoted to the broadcast join under the governor,
    shuffled with it off. Each run against its numpy oracle."""
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.plan import adaptive
    from bodo_tpu_torch.plan.expr import ColRef, Lit
    from bodo_tpu_torch.runtime.memory_governor import (governor,
                                                        table_device_bytes)
    from bodo_tpu_torch.workloads import join_family as JF
    from bodo_tpu_torch.workloads import star_join as S

    if not config.mem_governor:
        raise AssertionError("the governor phase needs the default "
                             "config.mem_governor = True")
    with use_mesh(make_mesh(SHARDS, fact.device)):
        fact1, dim1 = fact.shard(), dim.shard()
        budget = governor().derived_budget()
        share = config.aqe_bcast_frac * budget
        f1 = R.filter_table(fact1, ColRef("y") % Lit(3) != Lit(0))
        d1 = R.filter_table(dim1, ColRef("g") < Lit(JF.DIM_GROUPS_KEPT))
        for label, build, query, want in (
                ("star 1D governor", dim1, lambda: S._pipeline(fact1, dim1),
                 oracle),
                ("star 1D governor, dimension g < 16", d1,
                 lambda: JF.star_filtered_dim(fact1, dim1),
                 JF.numpy_star_filtered_dim(fact_np, dim_np))):
            nbytes = table_device_bytes(build)
            decision = adaptive.join_broadcast_decision(build, f1)
            rows_rule = (build.nrows <= config.bcast_join_threshold
                         and f1.nrows > 4 * build.nrows)
            out, wall_s, routes, launches, peak = _drive(query)
            S.check_against(out.to_numpy(), want, rtol=AVG_RTOL)
            warm = _warm_s(query)
            route = "join_broadcast" if decision else "join_shuffle"
            print(f"{label}: budget a shard={budget} bytes (probe at "
                  f"first use x {1 - config.mem_headroom_frac:g}), "
                  f"broadcast share={share:.0f} bytes; build rows="
                  f"{build.nrows} bytes={nbytes}, probe rows={f1.nrows}; "
                  f"decision={route} (rows-only rule: "
                  f"{'broadcast' if rows_rule else 'shuffle'}); matches "
                  f"the numpy oracle (g and c exact, s rtol={AVG_RTOL})")
            _report(label, wall_s, warm, peak, routes, launches, (route,),
                    ("hash_probe", "partition_rank", "range_partition"))
            if routes.get("join_broadcast" if not decision
                          else "join_shuffle", 0):
                raise AssertionError(f"{label}: both join routes ran")
        if not decision:
            raise AssertionError("the filtered dimension's bytes do not fit "
                                 "the governor's broadcast share")
        with _PortConfig(mem_governor=False):
            out, wall_s, routes, launches, peak = _drive(
                lambda: JF.star_filtered_dim(fact1, dim1))
            warm = _warm_s(lambda: JF.star_filtered_dim(fact1, dim1))
        _report("star 1D governor off, dimension g < 16", wall_s, warm,
                peak, routes, launches,
                ("join_broadcast" if rows_rule else "join_shuffle",),
                ("hash_probe", "partition_rank"))
        del fact1, dim1, f1, d1, out


def run_skewed_star(dim, fact_np, dim_np):
    """The star join with shard=True on the fact table with HOT_SHARE of
    its keys set to one dimension key (workloads/join_family.skewed_fact)
    and the governor off: the skew split (the hot rows broadcast-joined,
    the cold rows shuffle-joined, the halves appended shard by shard),
    against the numpy oracle; then the same query with the split off
    (aqe_skew_min_rows past the rows), for its time."""
    import numpy as np
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import join_family as JF
    from bodo_tpu_torch.workloads import star_join as S

    t0 = time.perf_counter()
    skew_np = JF.skewed_fact(fact_np, dim_np)
    fact = S.tables_from_arrays(skew_np, dim_np)[0]
    want = S.numpy_pipeline(skew_np, dim_np)
    setup_s = time.perf_counter() - t0
    hot = float(np.mean(skew_np["k"] == JF.hot_key(dim_np)))
    with use_mesh(make_mesh(SHARDS, fact.device)), \
            _PortConfig(mem_governor=False):
        fact1, dim1 = fact.shard(), dim.shard()
        out, wall_s, routes, launches, peak = _drive(
            lambda: S._pipeline(fact1, dim1))
        S.check_against(out.to_numpy(), want, rtol=AVG_RTOL)
        warm = _warm_s(lambda: S._pipeline(fact1, dim1))
        _report("star 1D skewed", wall_s, warm, peak, routes, launches,
                ("join_skew_split", "append_sharded", "join_broadcast",
                 "join_shuffle"),
                ("hash_probe", "partition_rank", "range_partition"),
                f" hot key share={hot:.4f} setup_s={setup_s:.3f}")
        print(f"star 1D skewed: matches the numpy oracle (g and c exact, s "
              f"rtol={AVG_RTOL})")
        with _PortConfig(aqe_skew_min_rows=1 << 62):
            out, wall_s, routes, launches, peak = _drive(
                lambda: S._pipeline(fact1, dim1))
            S.check_against(out.to_numpy(), want, rtol=AVG_RTOL)
            warm = _warm_s(lambda: S._pipeline(fact1, dim1))
        _report("star 1D skewed, no split", wall_s, warm, peak, routes,
                launches, ("join_shuffle",), ("hash_probe",
                                              "partition_rank"))
        del fact1, dim1, out


def run_union(trips, weather, rep_got, oracle):
    """UNION ALL of the taxi trips split by pickup quarter into two 1D
    tables on SHARDS shards, each with its own dictionaries and bounds
    (workloads/join_family.quarter_tables), through concat_tables, then
    the taxi pipeline on the (replicated) union, against the numpy
    oracle of the whole table and, row for row, the REP run."""
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import join_family as JF
    from bodo_tpu_torch.workloads import taxi as T

    t0 = time.perf_counter()
    quarters = JF.quarter_tables(trips)
    sizes = [q.nrows for q in quarters]
    with use_mesh(make_mesh(SHARDS, weather.device)):
        parts = [q.shard() for q in quarters]
        del quarters
        setup_s = time.perf_counter() - t0
        dicts = [p.column("hvfhs_license_num").dictionary for p in parts]
        out, wall_s, routes, launches, peak = _drive(
            lambda: JF.union_pipeline(parts, weather))
        got = out.to_numpy()
        T.check_against(got, oracle, rtol=AVG_RTOL)
        T.check_against(got, rep_got, rtol=AVG_RTOL)
        warm = _warm_s(lambda: JF.union_pipeline(parts, weather))
        concat_ms = _warm_s(lambda: R.concat_tables(parts)) * 1e3
    _report("union", wall_s, warm, peak, routes, launches,
            ("concat_tables", "join_dense", "sort_local"),
            ("lut_gather",),
            f" quarters={sizes} shards={SHARDS} setup_s={setup_s:.3f} "
            f"concat_tables warm ms={concat_ms:.3f} (median of "
            f"{STAGE_REPS}); dictionaries apart: {dicts[0] is not dicts[1]}")
    print(f"union: matches the numpy oracle of the whole table and, row "
          f"for row, the REP run (keys and trip_count exact, avg_miles "
          f"rtol={AVG_RTOL})")


def run_cross(dim, dim_np):
    """The star dimension on SHARDS shards x the replicated scenario
    table (workloads/join_family.cross_product, the 1D cross join): its
    first and last 1,000 rows held exactly to pandas' order; then
    u = w * m summed by (g, scenario) and sorted, against the numpy
    oracle."""
    import numpy as np
    import torch
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import join_family as JF

    scen = JF.scenario_table(dim.device)
    want = JF.numpy_cross_pipeline(dim_np)
    with use_mesh(make_mesh(SHARDS, dim.device)):
        dim1 = dim.shard()
        prod, cross_s, routes, _, cross_peak = _drive(
            lambda: JF.cross_product(dim1, scen))
        if routes != {"join_cross": 1} or prod.distribution != "1D" or \
                prod.nrows != len(dim_np["k"]) * JF.N_SCENARIOS:
            raise AssertionError(f"cross join: {routes} {prod}")
        per, counts = prod.shard_capacity, prod.counts
        n = prod.nrows
        for rows, pos in ((np.arange(1000), np.arange(1000)),
                          (np.arange(n - 1000, n),
                           (len(counts) - 1) * per + counts[-1] - 1000
                           + np.arange(1000))):
            exp = JF.numpy_cross_rows(dim_np, rows)
            idx = torch.as_tensor(pos, device=dim.device)
            for name, col in exp.items():
                got = prod.column(name).data[idx].cpu().numpy()
                if not np.array_equal(got, col):
                    raise AssertionError(f"cross join: column {name} of "
                                         f"rows {rows[0]}.. differs")
        cross_warm = _warm_s(lambda: JF.cross_product(dim1, scen))
        del prod
        out, wall_s, routes, launches, peak = _drive(
            lambda: JF.cross_pipeline(JF.cross_product(dim1, scen)))
        got = out.to_numpy()
        JF.check_cross(got, want, rtol=AVG_RTOL)
        warm = _warm_s(lambda: JF.cross_pipeline(
            JF.cross_product(dim1, scen)))
    _report("cross join", wall_s, warm, peak, routes, launches,
            ("join_cross", "groupby_sharded_hash", "sort_sharded"),
            ("partition_rank", "range_partition"),
            f" rows={n} ({len(dim_np['k'])} x {JF.N_SCENARIOS}) "
            f"product_s={cross_s:.4f} product_warm_s={cross_warm:.4f} "
            f"product_max_memory_allocated={cross_peak}")
    print(f"cross join: first and last 1,000 rows equal pandas' order; "
          f"sum(u) by (g, scenario) matches the numpy oracle (keys exact, "
          f"s rtol={AVG_RTOL})")



def start_tpch_oracle(tmp: str):
    """Start the sqlite oracle of the TPC-H phase in a process of its own
    (workloads/tpch.sqlite_results: the same frames from the same seed,
    loaded into a database file with its join keys indexed, the 22
    queries on 6 threads and workloads/windows.WINDOW_SQL in 4 processes
    beside them), so it runs while the phase generates and registers its
    frames; no timed phase runs beside it. Returns (the process, the path
    the TPC-H results are pickled to; the window queries' go beside it,
    tpch.windows_oracle_path)."""
    out = os.path.join(tmp, "tpch_oracle.pkl")
    with open(os.path.join(tmp, "tpch_oracle.err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bodo_tpu_torch.workloads.tpch",
             "--n-orders", str(TPCH_ORDERS), "--seed", str(SEED),
             "--db", os.path.join(tmp, "tpch.db"), "--out", out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=err)
    return proc, out


def wait_for_oracle(proc, path: str, timeout: float = 900.0):
    """Wait until the oracle's process has written `path` (it writes the
    TPC-H results, then the window queries' results); raise if the
    process ends without it. Returns the unpickled object and the
    seconds waited."""
    import pickle
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            with open(os.path.join(os.path.dirname(path),
                                   "tpch_oracle.err")) as f:
                raise RuntimeError(f"sqlite oracle ended (rc "
                                   f"{proc.returncode}) without {path}:\n"
                                   f"{f.read()[-4000:]}")
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"sqlite oracle: no {path} in {timeout} s")
        time.sleep(0.5)
    with open(path, "rb") as f:
        return pickle.load(f), time.perf_counter() - t0


def run_tpch(tmp: str, procs: list):
    """TPC-H at scale factor 1 through the port's SQL entry point: the
    eight frames of gen_tpch(n_orders=TPCH_ORDERS, seed=SEED) registered
    on a BodoSQLContext on the card (strings as dictionary codes on the
    card, their dictionaries on the host), each query run cold and then
    warm through ctx.sql(q).to_pandas() with the route and launch counts
    set to 0 just before the cold run and read just after, and held
    against sqlite on the same data (tpch.check_against_sqlite: row
    counts, integers, strings, dates and the ORDER BY row order exact,
    float64 within TPCH_RTOL); all 22 must match (tpch.UNSUPPORTED is
    empty). Then HOLISTIC_SQL, the holistic aggregations through SQL
    (COUNT(DISTINCT), MEDIAN, MODE, LISTAGG), cold and warm, against
    pandas on the same frames (sqlite has no median, mode or ordered
    LISTAGG). The oracle's process is started first and appended to
    `procs`; it goes on to the window queries (run_windows). Returns (the
    launches of the phase by kernel, Q16's launches, the context, the
    window sums' tolerances over its frames (windows.sql_atols), the
    oracle's process and the path of its window results)."""
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.workloads import tpch as TP

    oracle = start_tpch_oracle(tmp)
    procs.append(oracle[0])
    t0 = time.perf_counter()
    data = TP.gen_tpch(n_orders=TPCH_ORDERS, seed=SEED)
    gen_s = time.perf_counter() - t0
    rows = {n: len(df) for n, df in data.items()}
    t0 = time.perf_counter()
    ctx = BodoSQLContext(data, device="cuda")
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    holistic_want = holistic_sql_oracle(data)
    from bodo_tpu_torch.workloads import windows as WN
    window_atols = WN.sql_atols(data)
    del data
    dev_bytes = torch.cuda.memory_allocated()
    print(f"tpch SF1: rows={rows} gen_s={gen_s:.3f} "
          f"register_s={register_s:.3f} memory_allocated={dev_bytes}")

    ref, waited = wait_for_oracle(*oracle)
    print(f"tpch SF1 sqlite oracle (its own process, 6 threads, join keys "
          f"indexed): gen_s={ref['gen_s']:.3f} load_s={ref['load_s']:.3f} "
          f"wall_s={ref['wall_s']:.3f}, waited {waited:.3f}"
          f" s for it; query_s=" + json.dumps(
              {q: round(v, 3) for q, v in sorted(ref["query_s"].items())}))

    total = {k: 0 for k in CK.launches}
    by_query = {}
    ran = 0
    for q in sorted(TP.QUERIES):
        sql = TP.QUERIES[q]
        got, cold_s, routes, launches, peak = _drive(
            lambda: ctx.sql(sql).to_pandas())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.sql(sql).to_pandas()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        TP.check_against_sqlite(got, ref["results"][q], sql, TPCH_RTOL,
                                f"tpch Q{q}")
        for k, v in launches.items():
            total[k] += v
        by_query[q] = launches
        ran += 1
        print(f"tpch Q{q}: rows={len(got)} cold_s={cold_s:.4f} "
              f"warm_s={warm_s:.4f} max_memory_allocated={peak} "
              f"routes={routes} kernel_launches="
              f"{ {k: v for k, v in launches.items() if v} } "
              f"matches sqlite")
    if ran != len(TP.QUERIES):
        raise AssertionError(f"tpch: only {ran} queries ran")
    if total["lut_gather"] + total["hash_probe"] < 1:
        raise AssertionError("tpch: no lut_gather or hash_probe launch")
    print(f"tpch SF1: {ran} of {len(TP.QUERIES)} queries match sqlite "
          f"(floats unrounded, rtol={TPCH_RTOL}); kernel launches over "
          f"the phase {total}")
    for name, (keys, sql) in HOLISTIC_SQL.items():
        got, cold_s, routes, launches, peak = _drive(
            lambda: ctx.sql(sql).to_pandas())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.sql(sql).to_pandas()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        check_holistic_sql(got, holistic_want[name], keys, f"tpch {name}")
        print(f"tpch {name}: rows={len(got)} cold_s={cold_s:.4f} "
              f"warm_s={warm_s:.4f} max_memory_allocated={peak} "
              f"routes={routes} kernel_launches="
              f"{ {k: v for k, v in launches.items() if v} } matches "
              f"pandas (counts, modes and strings exact, medians "
              f"rtol={HOLISTIC_RTOL})")
    return (total, by_query[16], ctx, window_atols, oracle[0],
            TP.windows_oracle_path(oracle[1]))


# the holistic aggregations through SQL over the TPC-H SF1 frames, held
# to pandas on the same frames: name -> (the GROUP BY keys, the query)
HOLISTIC_SQL = {
    "lineitem holistic": (["l_returnflag", "l_linestatus"], (
        "SELECT l_returnflag, l_linestatus, COUNT(DISTINCT l_suppkey) AS "
        "n_supp, MEDIAN(l_extendedprice) AS med_price, MODE(l_quantity) "
        "AS mode_qty FROM lineitem GROUP BY l_returnflag, l_linestatus")),
    "supplier listagg": (["s_nationkey"], (
        "SELECT s_nationkey, LISTAGG(s_name, '|') AS names, "
        "LISTAGG(DISTINCT s_nationkey) AS nation FROM supplier "
        "GROUP BY s_nationkey")),
}


def holistic_sql_oracle(data):
    """HOLISTIC_SQL's results by pandas on the frames `data` (a group's
    mode: the smallest of its most frequent values; LISTAGG: the
    group's values in the frame's row order), sorted by the keys."""
    g = data["lineitem"].groupby(HOLISTIC_SQL["lineitem holistic"][0],
                                 sort=True)
    lineitem = g.agg(n_supp=("l_suppkey", "nunique"),
                     med_price=("l_extendedprice", "median"),
                     mode_qty=("l_quantity",
                               lambda s: min(s.mode()))).reset_index()
    gs = data["supplier"].groupby(HOLISTIC_SQL["supplier listagg"][0],
                                  sort=True)
    supplier = gs.agg(names=("s_name", "|".join),
                      nation=("s_nationkey",
                              lambda s: ",".join(dict.fromkeys(
                                  str(x) for x in s)))).reset_index()
    return {"lineitem holistic": lineitem, "supplier listagg": supplier}


def check_holistic_sql(got, want, keys, label: str) -> None:
    """A HOLISTIC_SQL result against holistic_sql_oracle's, its rows
    sorted by the `keys`: the same rows and columns; integers, modes and
    strings equal; medians within HOLISTIC_RTOL."""
    import numpy as np
    got = got.sort_values(keys).reset_index(drop=True)
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        raise AssertionError(f"{label}: {list(got.columns)} x {len(got)} "
                             f"rows, want {list(want.columns)} x "
                             f"{len(want)}")
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if c == "med_price":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64),
                                       rtol=HOLISTIC_RTOL, atol=0,
                                       err_msg=f"{label} {c}")
        elif not np.array_equal(g.astype(object), w.astype(object)):
            raise AssertionError(f"{label} {c}: {g[:5]!r} vs {w[:5]!r}")


def _host_columns(t, names):
    """The named columns of a table (a 1D one gathered) as host arrays."""
    g = t.gather() if t.distribution == "1D" else t
    return {n: g.columns[n].to_numpy(g.nrows) for n in names}


def run_windows(ctx, atols, proc, oracle_path: str, trips):
    """The window functions on the card, after run_tpch, on its context
    (TPC-H SF1: lineitem 5,999,086 rows, orders 1,500,000):

    (a) each of workloads/windows.WINDOW_SQL (W1-W8) through
        ctx.sql(q).to_pandas(), cold with the route and launch counts
        set to 0 just before and read just after, then warm; the two
        results bit-identical; both held row for row to sqlite, whose
        results worker processes of the oracle's process compute beside
        the 22 TPC-H queries (integers, strings, dates and nulls exact,
        window sums within workloads/windows.prefix_atol of their
        column);
    (b) RANK_SPECS and AGG_SPECS, the rank_window and agg_window calls on
        lineitem (its key, order and value columns), REP and then 1D on
        SHARDS shards of the card: the partitioned routes (rowid, the
        hash shuffle through partition_rank, the sorted pass a shard,
        the sample sort through range_partition), the global ranking,
        OVER () through reduce_table and an ordered frame without a
        partition key (gathered); each 1D result held to the REP one
        (exact, but the window sums within prefix_atol and the means
        within it over their frame's row count); then, on one more 1D
        run of W1's call, each partition_rank call of its shuffle and
        each range_partition call of its sort back held to the kernel's
        plain version and timed, at the window path's own shapes;
    (c) window_table on the taxi `trips` (run_window_table).

    The results of (a) are held to sqlite last, so (b) and (c) run while
    the oracle's process computes them. Each run prints its cold and
    warm wall, peak memory, routes, launches and rows. Returns the
    launches of the 1D runs of (b), the partition_rank row of W1's calls
    (time_partition_rank) and the range_partition rows
    (time_range_calls)."""
    import numpy as np
    import pandas as pd
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import windows as WN

    got_sql = {}
    for q, sql in WN.WINDOW_SQL.items():
        got, cold_s, routes, launches, peak = _drive(
            lambda: ctx.sql(sql).to_pandas())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = ctx.sql(sql).to_pandas()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        pd.testing.assert_frame_equal(got, again, check_exact=True,
                                      obj=f"windows {q} cold vs warm")
        got_sql[q] = got
        print(f"windows {q}: rows={len(got)} cold_s={cold_s:.4f} "
              f"warm_s={warm_s:.4f} max_memory_allocated={peak} "
              f"routes={routes} kernel_launches="
              f"{ {k: v for k, v in launches.items() if v} } cold and "
              f"warm bit-identical")

    lineitem = ctx._tables["lineitem"].table
    li_cols = _host_columns(lineitem, [
        "l_partkey", "l_shipdate", "l_orderkey", "l_linenumber",
        "l_extendedprice", "l_quantity"])
    total = {k: 0 for k in CK.launches}
    kernel_calls = None
    calls = [(n, spec) for n, spec in list(WN.RANK_SPECS.items())
             + list(WN.AGG_SPECS.items())]
    for name, spec in calls:
        pk, ob = spec[0], spec[1]
        vals = [s[1] for s in spec[2]] if name in WN.AGG_SPECS else []
        cols = list(dict.fromkeys(pk + ob + vals))
        outs = [s[-1] for s in spec[2]]
        src = lineitem.select(cols)
        rep, rep_s, rep_routes, _, rep_peak = _drive(
            lambda: WN.run_call(R, src, name))
        want = _host_columns(rep, outs)
        with use_mesh(make_mesh(SHARDS, src.device)):
            sharded = src.shard()
            out, cold_s, routes, launches, peak = _drive(
                lambda: WN.run_call(R, sharded, name))
            warm_s = _warm_s(lambda: WN.run_call(R, sharded, name))
            if name == "rank partitioned (W1)":
                with _Capture("partition_rank") as pr, \
                        _Capture("range_partition") as rp:
                    WN.run_call(R, sharded, name)
                kernel_calls = (pr.calls, rp.calls)
        route = {**WN.RANK_ROUTES, **WN.AGG_ROUTES}[name]
        if routes.get(route, 0) < 1:
            raise AssertionError(f"windows 1D {name}: {routes}, want "
                                 f"{route}")
        WN.check_against_rep(_host_columns(out, outs), want,
                             WN.agg_atols(li_cols, outs),
                             f"windows 1D {name}")
        for k, v in launches.items():
            total[k] += v
        print(f"windows {name}: rows={lineitem.nrows} REP_s={rep_s:.4f} "
              f"REP max_memory_allocated={rep_peak} routes={rep_routes}; "
              f"1D on {SHARDS} shards cold_s={cold_s:.4f} warm_s={warm_s:.4f}"
              f" (median of {STAGE_REPS}) max_memory_allocated={peak} "
              f"routes={routes} kernel_launches="
              f"{ {k: v for k, v in launches.items() if v} } matches REP")
    for k in ("partition_rank", "range_partition"):
        if total[k] < 1:
            raise AssertionError(f"windows 1D: {k} not launched")
    no_f32_accumulate(total, "windows 1D")
    print(f"windows 1D: kernel launches over the calls {total}")
    del lineitem, src, li_cols
    rank_calls, range_calls = kernel_calls
    if not rank_calls or not range_calls:
        raise AssertionError(f"windows 1D W1: {len(rank_calls)} "
                             f"partition_rank and {len(range_calls)} "
                             f"range_partition calls")
    rank_row = time_partition_rank(rank_calls, "1D window path (W1)")
    range_rows = time_range_calls(range_calls, "1D window path (W1)")
    del kernel_calls, rank_calls, range_calls

    run_window_table(trips)
    ref, waited = wait_for_oracle(proc, oracle_path)
    print(f"windows sqlite oracle (4 worker processes of the TPC-H "
          f"oracle's process): wall_s={ref['wall_s']:.3f} since it started, "
          f"waited {waited:.3f} s for it; query_s=" + json.dumps(
              {q: round(v, 3) for q, v in sorted(ref["query_s"].items())}))
    t0 = time.perf_counter()
    for q, got in got_sql.items():
        WN.check_window_sql(got, ref["results"][q], atols.get(q, {}),
                            f"windows {q}")
    largest = {q: {c: float(np.max(a)) for c, a in cols.items()}
               for q, cols in atols.items()}
    print(f"windows: W1-W8 match sqlite row for row (integers, strings, "
          f"dates and nulls exact; window sums within "
          f"{WN.PREFIX_ULPS} * 2^-52 * sum(|x|): "
          f"{largest}; W4's mavg within that over its frame's row "
          f"count), checked in "
          f"{time.perf_counter() - t0:.3f} s")
    return total, rank_row, range_rows


def run_window_table(trips):
    """window_table on the taxi trips (the REP phases' 20,000,000 rows)
    in pickup order (sort_table, stable): workloads/windows.TABLE_SPECS
    (cumsum, cummax, cummin of trip_miles, cumprod of a column near 1,
    rolling sum, mean, min, max and count with w = 7 and w = 1000, shift
    and diff), REP and then on SHARDS shards of the sorted table (the
    carries and the multi-hop halos), each held to pandas on the same
    arrays, and the 1D result to the REP one (exact, but the prefix sums
    within prefix_atol and the product within n * 2^-52 relative). Prints
    the synchronized wall, warm wall, peak memory and rows."""
    import contextlib

    import numpy as np
    import torch
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.table.table import Column
    from bodo_tpu_torch.table import dtypes as dt
    from bodo_tpu_torch.workloads import taxi as T
    from bodo_tpu_torch.workloads import windows as WN

    t0 = time.perf_counter()
    trips_np, _ = T.gen_taxi_arrays(MAIN_ROWS, seed=SEED)
    order = np.argsort(trips_np["pickup_datetime"], kind="stable")
    miles = trips_np["trip_miles"][order]
    near = WN.near_one(miles)
    want = WN.table_oracle(miles, near)
    del trips_np
    print(f"window_table: pandas oracle {time.perf_counter() - t0:.3f}s "
          f"on {len(miles)} rows")
    src = R.sort_table(trips.select(["pickup_datetime", "trip_miles"]),
                       ["pickup_datetime"])
    src.columns["near_one"] = Column(
        1.0 + (src.column("trip_miles").data - 5.0) * 2e-8, None,
        dt.FLOAT64)
    outs = [o for *_, o in WN.TABLE_SPECS]
    tols = WN.table_tolerances(miles, len(miles))
    results = {}
    for label, shard in (("REP", False), ("1D", True)):
        mesh = use_mesh(make_mesh(SHARDS, src.device)) if shard \
            else contextlib.nullcontext()
        with mesh:
            t = src.shard() if shard else src
            out, wall_s, _, _, peak = _drive(
                lambda: R.window_table(t, WN.TABLE_SPECS))
            warm_s = _warm_s(lambda: R.window_table(t, WN.TABLE_SPECS))
        got = _host_columns(out, outs)
        WN.check_table(got, want, tols, f"window_table {label} vs pandas")
        results[label] = got
        print(f"window_table {label}: rows={out.nrows} "
              f"shards={out.num_shards} specs={len(WN.TABLE_SPECS)} "
              f"pipeline_s={wall_s:.4f} pipeline_warm_s={warm_s:.4f} "
              f"(median of {STAGE_REPS}) max_memory_allocated={peak} "
              f"matches pandas")
        del out
    WN.check_table(results["1D"], results["REP"], tols,
                   "window_table 1D vs REP")
    print(f"window_table: 1D matches REP; tolerances {tols}")
    torch.cuda.synchronize()


FALLBACK_WARNING = ".*falling back to pandas"


class _NoFallback:
    """A warnings scope in which the pandas frontend's fallback warning
    is an error: no path of the frontend phases may fall back. The
    warning has no switch (utils/logging.warn_fallback), so every
    fallback raises here."""

    def __enter__(self):
        import warnings
        self.scope = warnings.catch_warnings()
        self.scope.__enter__()
        warnings.filterwarnings("error", message=FALLBACK_WARNING)

    def __exit__(self, *exc):
        return self.scope.__exit__(*exc)


def _mesh_or_rep(shards: int):
    """A mesh of `shards` shards of the card as the active mesh, or
    nothing for 1 (REP)."""
    import contextlib
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    if shards == 1:
        return contextlib.nullcontext()
    return use_mesh(make_mesh(shards, "cuda"))


def time_lut_calls(calls, label: str, entry: str = "lut_gather"):
    """Hold lut_gather against its plain version on each call a path made
    through `entry` (lut_gather, or dict_gather: the same kernel) and
    time it there beside the plain version, lut[codes] and its bound.
    Returns one row a call."""
    import torch
    from bodo_tpu_torch.ops import cuda_kernels as CK
    gather = getattr(CK, entry)
    rows = []
    for j, (codes, lut) in enumerate(calls):
        got = gather(codes, lut)
        want = CK.lut_gather_plain(codes, lut)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        if not bool(torch.equal(got, want)):
            raise AssertionError(f"{entry} differs from its plain "
                                 f"version on the {label}'s call {j + 1}")
        n, k = codes.shape[0], lut.shape[0]
        t = {"ms": device_ms(lambda: gather(codes, lut)),
             "plain_ms": device_ms(lambda: CK.lut_gather_plain(codes, lut)),
             "library_ms": device_ms(lambda: lut[codes])}
        nbytes = 4 * n + 4 * n + 4 * k  # codes read, output written, LUT
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{entry} ({label}'s call {j + 1} of {len(calls)}) N={n} "
              f"K={k}: bit_identical=True kernel_ms={t['ms']:.6f} "
              f"plain_ms={t['plain_ms']:.6f} library_ms(lut[codes])="
              f"{t['library_ms']:.6f} bound_ms={bound:.6f} "
              f"({bound / t['ms']:.1%} of the bound)")
        rows.append({"N": n, "K": k, "max_abs_err": err, "bound_ms": bound,
                     **t})
    return rows


def run_frontend_taxi(path: str, csv: str, trips, weather, oracle):
    """The taxi pipeline through the lazy pandas frontend
    (workloads/taxi.frontend_pipeline) on the 20,000,000-row trips file
    and its weather csv, REP and then on SHARDS shards of the card (the
    trips sharded by the plan executor's scan policy, the weather
    replicated), with the fallback warning an error:

      - a cold run with the route and launch counts set to 0 just before
        and read just after, then a warm run, the two equal; a traced run
        (the device's busy share); a run that captures the kernel calls;
      - the result held to the numpy oracle (keys and trip_count exact,
        avg_miles within AVG_RTOL) and to the relational pipeline on the
        same file (workloads/taxi.pipeline, timed beside it: the
        frontend's overhead) bit for bit (the same groupby over the same
        joined rows);
      - the routes: the relational pipeline's, without its sort (REP:
        join_dense, groupby_dense); the launches: lut_gather (the merge's
        dense-LUT probe), hybrid_expand and dict_gather (the read) on
        REP; hash_probe (the broadcast join) and partition_rank (the
        two-phase groupby) on 1D.

    Returns ({"REP": launches, "1D": launches}, the captured calls of
    lut_gather, hybrid_expand_segments and dict_gather of the REP run and
    of partition_rank and hash_probe of the 1D run)."""
    import contextlib

    import pandas as pd
    from bodo_tpu_torch.workloads import profiling
    from bodo_tpu_torch.workloads import taxi as T

    def front():
        return T.frontend_pipeline(path, csv)

    out = {}
    calls = {}
    for label, shards in (("REP", 1), ("1D", SHARDS)):
        lab = f"frontend taxi {label}"
        with _mesh_or_rep(shards), _NoFallback():
            got, cold_s, routes, launches, cold_peak = _drive(front)
            again, warm_s, _, _, warm_peak = _drive(front)
            tr = profiling.trace(front)
            names = ("lut_gather", "hybrid_expand_segments",
                     "dict_gather") if shards == 1 else \
                ("partition_rank", "hash_probe")
            with contextlib.ExitStack() as stack:
                caps = {k: stack.enter_context(_Capture(k)) for k in names}
                front()
            calls.update({k: c.calls for k, c in caps.items()})
        pd.testing.assert_frame_equal(got, again, check_exact=True,
                                      obj=f"{lab} cold vs warm")
        got_np = {k: got[k].to_numpy() for k in got.columns}
        T.check_against(got_np, oracle, rtol=AVG_RTOL)

        def rel():
            return T.pipeline(path, csv, shard=shards > 1, n_shards=SHARDS)

        rel_out, rel_cold_s, rel_routes, _, rel_peak = _drive(rel)
        _, rel_warm_s, _, _, _ = _drive(rel)
        _, rel_pandas_s, _, _, _ = _drive(lambda: rel().to_pandas())
        T.check_against(got_np, rel_out.to_numpy(), rtol=0.0)
        want_routes = {k: v for k, v in rel_routes.items()
                       if not k.startswith("sort_")}
        print(f"{lab}: rows={MAIN_ROWS} groups={len(got)} shards={shards} "
              f"cold_s={cold_s:.4f} warm_s={warm_s:.4f} "
              f"max_memory_allocated cold={cold_peak} warm={warm_peak} "
              f"traced_wall_s={tr['traced_wall_s']:.4f} "
              f"device_ms={tr['device_ms']:.3f} "
              f"device_busy_share={tr['device_busy_share']:.4f}")
        print(f"{lab}: relational pipeline on the same file cold_s="
              f"{rel_cold_s:.4f} warm_s={rel_warm_s:.4f} (+ to_pandas "
              f"{rel_pandas_s:.4f}) max_memory_allocated={rel_peak} "
              f"routes={rel_routes}; frontend warm / relational warm = "
              f"{warm_s / rel_warm_s:.3f}, / relational + to_pandas = "
              f"{warm_s / rel_pandas_s:.3f}")
        for r in tr["top_ops_device_ms"][:6]:
            print(f"{lab} (traced): operator {r['ms']:.3f} ms x{r['calls']} "
                  f"{r['op'][:90]}")
        print(f"{lab}: route_counts={routes} kernel_launches="
              f"{ {k: v for k, v in launches.items() if v} }")
        print(f"{lab}: matches the numpy oracle (keys and trip_count exact, "
              f"avg_miles rtol={AVG_RTOL}) and the relational pipeline "
              f"bit for bit; cold and warm equal; no pandas fallback")
        if routes != want_routes:
            raise AssertionError(f"{lab}: routes {routes}, the relational "
                                 f"pipeline's {want_routes}")
        if shards == 1 and not (routes.get("join_dense") and
                                routes.get("groupby_dense")):
            raise AssertionError(f"{lab}: routes {routes}")
        want = ("lut_gather", "hybrid_expand", "dict_gather") \
            if shards == 1 else ("hash_probe", "partition_rank",
                                 "hybrid_expand", "dict_gather")
        for k in want:
            if launches[k] < 1:
                raise AssertionError(f"{lab}: {k} not launched")
        no_f32_accumulate(launches, lab)
        out[label] = launches
        del got, again, rel_out
    return out, calls


def run_frontend_breadth(path: str):
    """workloads/frontend.program (groupby aggregations with nunique and
    median, the groupby windows, the Series windows, value_counts,
    nlargest, drop_duplicates, pivot_table, melt, set_index/sort_index/
    head, a left merge with a from_pandas dimension) on the 20,000,000-row
    trips file, REP and on SHARDS shards of the card, each run with the
    route and launch counts set to 0 just before and read just after,
    held to workloads/frontend.pandas_program on the same file
    (workloads/frontend.check: exact, floats within AVG_RTOL, the window
    sums within prefix_atol); the fallback warning an error. Returns
    ({"REP": launches, "1D": launches}, the range_partition calls of the
    1D sort_index of the program, captured on one more run of it)."""
    import bodo_tpu_torch.pandas_api as bd
    from bodo_tpu_torch.workloads import frontend as FE

    zones = FE.dimension_frame(SEED)
    t0 = time.perf_counter()
    want = FE.pandas_program(path, zones)
    print(f"frontend breadth: pandas oracle {time.perf_counter() - t0:.3f}s "
          f"on {MAIN_ROWS} rows")
    out = {}
    range_calls = []
    for label, shards in (("REP", 1), ("1D", SHARDS)):
        lab = f"frontend breadth {label}"
        with _mesh_or_rep(shards), _NoFallback():
            got, wall_s, routes, launches, peak = _drive(
                lambda: FE.program(bd, path, zones))
            if shards > 1:
                with _Capture("range_partition") as rp:
                    bd.read_parquet(path).set_index("trip_miles") \
                        .sort_index().head(10).to_pandas()
                range_calls = rp.calls
        FE.check(got, want, AVG_RTOL, lab)
        print(f"{lab}: rows={MAIN_ROWS} results={len(got)} shards={shards} "
              f"wall_s={wall_s:.4f} max_memory_allocated={peak}")
        print(f"{lab}: route_counts={routes} kernel_launches="
              f"{ {k: v for k, v in launches.items() if v} }")
        print(f"{lab}: matches pandas ({sorted(got)}; floats rtol="
              f"{AVG_RTOL}, window sums within prefix_atol); no pandas "
              f"fallback")
        no_f32_accumulate(launches, lab)
        out[label] = launches
        del got
    if out["1D"]["range_partition"] < 1 or not range_calls:
        raise AssertionError(f"frontend breadth 1D: range_partition "
                             f"launches {out['1D']['range_partition']}, "
                             f"{len(range_calls)} captured calls")
    return out, range_calls


def range_launches_per_pass(launches, calls, label: str) -> None:
    """One range_partition call, and so one launch, a sample-sort pass:
    the calls of a later run (as many as its passes) against the first
    run's launches."""
    from bodo_tpu_torch.ops import cuda_kernels as CK
    if not calls or launches["range_partition"] != len(calls) or any(
            len(pks) > CK.RANGE_MAX_SHARDS for pks, _ in calls):
        raise AssertionError(f"{label}: {launches['range_partition']} "
                             f"range_partition launches, {len(calls)} "
                             f"calls")
    print(f"{label}: range_partition {launches['range_partition']} "
          f"launch(es) in {len(calls)} sample-sort pass(es) over "
          f"{[len(pks) for pks, _ in calls]} shards: 1 launch a pass")


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

    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tpch_")
    procs = []
    try:
        return _main(CK, dev, tmp, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def _main(CK, dev, tmp: str, procs: list) -> int:
    import torch
    t0 = time.perf_counter()
    CK.build()
    print(f"build: {sorted(CK.SOURCES)} in {time.perf_counter() - t0:.2f}s")
    for name, log in sorted(CK.build_logs.items()):
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem", "error")):
                print(f"build {name}: {line.strip()}")

    lut = check_lut_gather(dev)
    check_hash_probe(dev)
    check_partition_rank(dev)
    check_range_partition(dev)
    check_hybrid_expand(dev)
    check_groupby_sum(dev)
    # each main path launches its kernels: lut_gather on the taxi path,
    # hybrid_expand and lut_gather (as dict_gather) on the taxi read,
    # hash_probe on the star path, partition_rank and range_partition on
    # the 1D taxi path
    taxi_launches, taxi_run = run_taxi(MAIN_ROWS, ("join_dense",
                                                   "groupby_dense"),
                                       "main path")
    lut["launches"] = taxi_launches["lut_gather"]
    read_launches, expand_calls, trips_path, weather_path = \
        run_taxi_read(*taxi_run, tmp)
    lut["dict_gather_launches"] = read_launches["dict_gather"]
    expand = time_hybrid_expand(expand_calls)
    expand["launches"] = read_launches["hybrid_expand"]
    del expand_calls
    # the pandas frontend on the same files: its kernels' calls held to
    # their plain versions and timed at the frontend's shapes
    front, front_calls = run_frontend_taxi(
        trips_path, weather_path, *taxi_run[:2], taxi_run[3])
    lut["frontend_launches"] = front["REP"]["lut_gather"]
    lut["frontend_dict_gather_launches"] = front["REP"]["dict_gather"]
    lut["frontend_calls"] = time_lut_calls(front_calls["lut_gather"],
                                           "frontend taxi merge")
    lut["frontend_dict_gather_calls"] = time_lut_calls(
        front_calls["dict_gather"], "frontend taxi read", "dict_gather")
    lut["max_abs_err"] = max(lut["max_abs_err"], *(
        c["max_abs_err"] for c in lut["frontend_calls"]
        + lut["frontend_dict_gather_calls"]))
    expand["frontend_launches"] = front["REP"]["hybrid_expand"]
    front_expand = time_hybrid_expand(
        front_calls["hybrid_expand_segments"], "frontend taxi read",
        one_page=False)
    expand["frontend_call"] = {
        f: front_expand[f] for f in ("chunk_segments", "chunk_values",
                                     "max_abs_err", "ms", "plain_ms",
                                     "bound_ms")}
    expand["max_abs_err"] = max(expand["max_abs_err"],
                                front_expand["max_abs_err"])
    front_rank = time_partition_rank(front_calls["partition_rank"],
                                     "1D frontend taxi")
    front_probes = time_probe_calls(front_calls["hash_probe"],
                                    "1D frontend taxi")
    del front_calls
    breadth, breadth_ranges = run_frontend_breadth(trips_path)
    front_ranges = time_range_calls(breadth_ranges,
                                    "1D frontend sort_index")
    del breadth_ranges
    star_launches, probe_args, star_run = run_star()
    probe = time_hash_probe(probe_args)
    probe["launches"] = star_launches["hash_probe"]
    del probe_args
    oned_launches, rank_calls, range_calls, oned_probes = \
        run_taxi_1d(*taxi_run)
    run_aggregations(*taxi_run[:2])
    colocated = run_holistic(*taxi_run[:2])
    run_union(*taxi_run)
    trips = taxi_run[0]
    del taxi_run
    rank = time_partition_rank(rank_calls)
    rank["launches"] = oned_launches["partition_rank"]
    rank["colocated_launches"] = colocated["partition_rank"]
    part = time_range_partition(range_calls, dev)
    part["launches"] = oned_launches["range_partition"]
    probe["taxi_1d_launches"] = oned_launches["hash_probe"]
    probe["frontend_1d_launches"] = front["1D"]["hash_probe"]
    probe["frontend_breadth_1d_launches"] = breadth["1D"]["hash_probe"]
    lut["frontend_breadth_launches"] = breadth["REP"]["lut_gather"]
    probe["frontend_1d_calls"] = front_probes
    rank["frontend_1d_launches"] = front["1D"]["partition_rank"]
    rank["frontend_breadth_1d_launches"] = breadth["1D"]["partition_rank"]
    rank["frontend_1d_calls"] = {
        f: front_rank[f] for f in ("N", "K", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "path_ms",
                                   "path_bound_ms")}
    rank["max_abs_err"] = max(rank["max_abs_err"], front_rank["max_abs_err"])
    part["frontend_breadth_1d_launches"] = breadth["1D"]["range_partition"]
    part["frontend_1d_calls"] = front_ranges
    part["max_abs_err"] = max(part["max_abs_err"], *(
        c["max_abs_err"] for c in front_ranges))
    probe["taxi_1d_calls"] = time_probe_calls(oned_probes,
                                              "1D taxi path")
    del rank_calls, range_calls, oned_probes
    with _PortConfig(mem_governor=False):
        star_probes, star_ranges = run_star_1d(*star_run[:3])
    run_star_governor(*star_run)
    run_skewed_star(*star_run[1:2], *star_run[3:])
    run_cross(star_run[1], star_run[4])
    del star_run
    probe["star_1d_calls"] = time_probe_calls(star_probes, "1D star path")
    part["star_1d_calls"] = time_range_calls(star_ranges, "1D star path")
    part["max_abs_err"] = max(part["max_abs_err"], *(
        c["max_abs_err"] for c in part["star_1d_calls"]))
    del star_probes, star_ranges
    dense_launches, sparse_launches, acc_args = run_f32_groupby()
    acc = time_groupby_sum(acc_args)
    acc["launches"] = dense_launches["groupby_sum"]
    acc["hashed_launches"] = sparse_launches["groupby_sum"]
    del acc_args
    kernels = [lut, probe, rank, part, expand, acc]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its "
                                 f"main path")
    run_join_matrix()
    run_taxi(SMALL_ROWS, ("join_dense", "groupby_hashed"), "small")
    tpch, q16, ctx, window_atols, oracle_proc, windows_path = \
        run_tpch(tmp, procs)
    windows, window_rank, window_ranges = run_windows(
        ctx, window_atols, oracle_proc, windows_path, trips)
    del ctx, trips
    rank["window_1d_launches"] = windows["partition_rank"]
    rank["window_1d_calls"] = {
        f: window_rank[f] for f in ("N", "K", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "path_ms",
                                    "path_bound_ms")}
    rank["max_abs_err"] = max(rank["max_abs_err"], window_rank["max_abs_err"])
    part["window_1d_launches"] = windows["range_partition"]
    part["window_1d_calls"] = window_ranges
    part["max_abs_err"] = max(part["max_abs_err"], *(
        c["max_abs_err"] for c in window_ranges))
    lut["tpch_launches"] = tpch["lut_gather"]
    probe["tpch_launches"] = tpch["hash_probe"]
    lut["tpch_q16_launches"] = q16["lut_gather"]
    probe["tpch_q16_launches"] = q16["hash_probe"]

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [
        {**{f: k[f] for f in order},
         **{f: v for f, v in k.items() if f not in order}}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
