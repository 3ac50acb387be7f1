"""The NYC-taxi-shaped workload on the port: data generators, the pipeline
and a numpy oracle.

Counterpart of bodo_tpu/workloads/taxi.py (which mirrors the reference
benchmark get_monthly_travels_weather, benchmarks/nyc_taxi/bodo/
nyc_taxi_precipitation.py): csv + parquet read, datetime fields, inner
merge on date, derived bool/bucket columns, a 6-key groupby with
count + mean, a multi-key sort.

`gen_taxi_data` writes the same files as the JAX package's generator
(pandas, imported when called); `gen_taxi_arrays` makes the same columns
as numpy arrays without pandas. `numpy_pipeline` computes the result
with numpy alone, independent of both packages.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

TIME_BUCKETS = ["morning", "midday", "afternoon", "evening", "other"]
KEYS = ["PULocationID", "DOLocationID", "month", "weekday",
        "date_with_precipitation", "time_bucket"]
_NS_PER_DAY = 86_400_000_000_000
_NS_PER_HOUR = 3_600_000_000_000


def gen_taxi_arrays(n_rows: int, seed: int = 0
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(trips, weather) columns as numpy arrays: the values `gen_taxi_data`
    writes for the same seed, with DATE already parsed to datetime64[ns]
    as read_csv(parse_dates=["DATE"]) gives it."""
    r = np.random.default_rng(seed)
    start = np.datetime64("2024-01-01T00:00:00")
    pickup = start + r.integers(0, 180 * 24 * 3600, n_rows).astype(
        "timedelta64[s]")
    trips = {
        "hvfhs_license_num": r.choice(["HV0002", "HV0003", "HV0004",
                                       "HV0005"], n_rows),
        "PULocationID": r.integers(1, 180, n_rows).astype(np.int64),
        "DOLocationID": r.integers(1, 180, n_rows).astype(np.int64),
        "trip_miles": (r.gamma(2.0, 2.5, n_rows)).astype(np.float64),
        "pickup_datetime": pickup.astype("datetime64[ns]"),
    }
    dates = np.arange(np.datetime64("2024-01-01"),
                      np.datetime64("2024-07-01")).astype("datetime64[ns]")
    weather = {
        "DATE": dates,
        "PRCP": np.round(np.random.default_rng(seed + 1)
                         .gamma(0.5, 0.3, len(dates)), 2),
    }
    return trips, weather


def gen_taxi_data(n_rows: int, out_parquet: str, out_csv: str,
                  seed: int = 0):
    """Write trips (parquet) and weather (csv) files; returns the pandas
    frames written."""
    import pandas as pd

    trips, weather = gen_taxi_arrays(n_rows, seed)
    df = pd.DataFrame({k: pd.Series(v) for k, v in trips.items()})
    df.to_parquet(out_parquet)
    wdf = pd.DataFrame({
        "DATE": pd.DatetimeIndex(weather["DATE"]).strftime("%Y-%m-%d"),
        "PRCP": weather["PRCP"],
    })
    wdf.to_csv(out_csv, index=False)
    return df, wdf


def tables_from_arrays(trips: Dict[str, np.ndarray],
                       weather: Dict[str, np.ndarray], device=None):
    """Port Tables from generated arrays, with the exact value bounds the
    parquet/csv readers would attach to integer and timestamp columns."""
    from bodo_tpu_torch.table.table import Table

    out = []
    for arrays in (trips, weather):
        t = Table.from_numpy(arrays, device=device)
        for name, a in arrays.items():
            if a.dtype.kind in "iuM" and len(a):
                phys = a.view(np.int64) if a.dtype.kind == "M" else a
                t.columns[name].vrange = (int(phys.min()), int(phys.max()),
                                          True)
        out.append(t)
    return tuple(out)


def pipeline(trips, weather, device=None, shard: bool = False,
             n_shards: int = 4):
    """The workload on the port. `trips`/`weather` are file paths (parquet
    / csv, read onto `device`, CUDA by default) or port Tables. Returns
    a Table sorted by the six keys.

    shard=True is the JAX package's default (`bodo_tpu_pipeline(...,
    shard=True)`): the trips are row-sharded over a mesh of `n_shards`
    shards on their device, the weather stays replicated, so the join is
    a broadcast join, the groupby the two-phase sharded groupby and the
    sort the sample sort; the result is a 1D table."""
    from bodo_tpu_torch.io import read_csv, read_parquet
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    if isinstance(weather, (str, os.PathLike)):
        weather = read_csv(weather, parse_dates=["DATE"], device=device)
    if isinstance(trips, (str, os.PathLike)):
        trips = read_parquet(trips, device=device)
    if not shard:
        return _pipeline(trips, weather)
    with use_mesh(make_mesh(n_shards, trips.device)):
        return _pipeline(trips.shard(), weather)


def _pipeline(trips, weather):
    from bodo_tpu_torch import relational as R

    out = R.groupby_agg(joined(trips, weather), KEYS, [
        ("hvfhs_license_num", "count", "trip_count"),
        ("trip_miles", "mean", "avg_miles"),
    ])
    return R.sort_table(out, KEYS)


def joined(trips, weather):
    """The pipeline's table before its groupby: the trips with their
    datetime fields, joined on the date with the weather, with the
    derived bool and bucket columns (the six KEYS among them). `trips`
    and `weather` are port Tables; a 1D `trips` gives a 1D table (call
    it under the mesh `trips` is sharded over)."""
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.plan.expr import ColRef as c, DtField, IsIn, Lit, Where

    weather = R.assign_columns(weather, {
        "date": DtField("date", c("DATE")),
        "precipitation": c("PRCP"),
    }).select(["date", "precipitation"])

    trips = R.assign_columns(trips, {
        "date": DtField("date", c("pickup_datetime")),
        "month": DtField("month", c("pickup_datetime")),
        "hour": DtField("hour", c("pickup_datetime")),
        "weekday": IsIn(DtField("dayofweek", c("pickup_datetime")),
                        (0, 1, 2, 3, 4)),
    })

    m = R.join_tables(trips, weather, ["date"], ["date"], "inner")
    m = R.assign_columns(m, {
        "date_with_precipitation": c("precipitation") > 0.1,
    })
    code = R.category_code
    h = c("hour")
    bucket_codes = Where(
        IsIn(h, (8, 9, 10)), Lit(code(TIME_BUCKETS, "morning")),
        Where(IsIn(h, (11, 12, 13, 14, 15)), Lit(code(TIME_BUCKETS, "midday")),
              Where(IsIn(h, (16, 17, 18)), Lit(code(TIME_BUCKETS, "afternoon")),
                    Where(IsIn(h, (19, 20, 21)),
                          Lit(code(TIME_BUCKETS, "evening")),
                          Lit(code(TIME_BUCKETS, "other"))))))
    return R.assign_categorical(m, "time_bucket", bucket_codes,
                                TIME_BUCKETS)


def numpy_joined(trips: Dict[str, np.ndarray],
                 weather: Dict[str, np.ndarray]):
    """`joined` in numpy alone (arrays as `gen_taxi_arrays` returns them),
    in the trips' row order: (the six keys as int64 arrays, time_bucket
    as its code in the sorted bucket names; the trips' rows kept by the
    inner join as a bool mask)."""
    ns = trips["pickup_datetime"].view(np.int64)
    day = ns // _NS_PER_DAY
    month = (trips["pickup_datetime"].astype("datetime64[M]")
             .astype(np.int64) % 12 + 1)
    hour = (ns - day * _NS_PER_DAY) // _NS_PER_HOUR
    weekday = (day + 3) % 7 < 5
    # inner join on the day: weather days are unique
    wday = weather["DATE"].view(np.int64) // _NS_PER_DAY
    order = np.argsort(wday)
    pos = np.clip(np.searchsorted(wday[order], day), 0, len(wday) - 1)
    hit = wday[order][pos] == day
    prcp = weather["PRCP"][order][pos]
    names = np.array(sorted(TIME_BUCKETS))
    hour_bucket = np.full(24, int(np.searchsorted(names, "other")))
    for hours, b in (((8, 9, 10), "morning"), ((11, 12, 13, 14, 15), "midday"),
                     ((16, 17, 18), "afternoon"), ((19, 20, 21), "evening")):
        hour_bucket[list(hours)] = int(np.searchsorted(names, b))
    cols = [trips["PULocationID"][hit], trips["DOLocationID"][hit],
            month[hit], weekday[hit].astype(np.int64),
            (prcp[hit] > 0.1).astype(np.int64), hour_bucket[hour[hit]]]
    return cols, hit


def slot_ids(cols):
    """The mixed-radix slot id of each row's keys (first key most
    significant, so slot order is the keys' lexicographic order), with
    the (lo, size) of each key."""
    los = [int(k.min()) if len(k) else 0 for k in cols]
    sizes = [int(k.max()) - lo + 1 if len(k) else 1
             for k, lo in zip(cols, los)]
    slot = np.zeros(len(cols[0]), dtype=np.int64)
    for k, lo, size in zip(cols, los, sizes):
        slot = slot * size + (k - lo)
    return slot, los, sizes


def numpy_pipeline(trips: Dict[str, np.ndarray],
                   weather: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The workload in numpy alone (arrays as `gen_taxi_arrays` returns
    them): the groupby is a bincount over the mixed-radix slot id of the
    six keys, the final order an np.lexsort of the keys."""
    cols, hit = numpy_joined(trips, weather)
    slot, los, sizes = slot_ids(cols)
    names = np.array(sorted(TIME_BUCKETS))
    n_slots = int(np.prod(sizes))
    count = np.bincount(slot, minlength=n_slots)
    miles = np.bincount(slot, weights=trips["trip_miles"][hit],
                        minlength=n_slots)
    present = np.flatnonzero(count)
    keys = []
    rem = present
    for size, lo in zip(reversed(sizes), reversed(los)):
        keys.append(rem % size + lo)
        rem = rem // size
    keys = keys[::-1]
    perm = np.lexsort(keys[::-1])  # np.lexsort: last key is the primary
    out = {
        "PULocationID": keys[0][perm],
        "DOLocationID": keys[1][perm],
        "month": keys[2][perm],
        "weekday": keys[3][perm].astype(bool),
        "date_with_precipitation": keys[4][perm].astype(bool),
        "time_bucket": names[keys[5][perm]].astype(object),
        "trip_count": count[present][perm],
        "avg_miles": (miles[present] / count[present])[perm],
    }
    return out


def check_against(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                  rtol: float) -> None:
    """Raise AssertionError unless `got` has `want`'s rows: keys and
    trip_count exactly, avg_miles within `rtol`."""
    n = len(want["trip_count"])
    if len(got["trip_count"]) != n:
        raise AssertionError(f"{len(got['trip_count'])} groups, want {n}")
    for k in KEYS + ["trip_count"]:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k == "time_bucket":
            g, w = g.astype(str), w.astype(str)
        if not np.array_equal(g, w):
            bad = int(np.flatnonzero(g != w)[0])
            raise AssertionError(f"{k} differs at row {bad}: "
                                 f"{g[bad]!r} vs {w[bad]!r}")
    np.testing.assert_allclose(np.asarray(got["avg_miles"], np.float64),
                               np.asarray(want["avg_miles"], np.float64),
                               rtol=rtol, atol=0)
