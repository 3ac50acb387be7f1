"""A second program through the lazy pandas frontend, over the taxi trips
file, with its pandas oracle.

`program` covers the frontend's breadth beyond the taxi pipeline: a
groupby with sum, mean, min, max, nunique and median; the groupby
windows rank, cumcount, transform("mean") and shift; Series.cumsum,
rolling(7).mean(), shift and diff assigned back to the frame;
value_counts, nlargest, drop_duplicates and pivot_table; a melt of two
columns; set_index, sort_index and head; a how='left' merge with a small
dimension frame built by from_pandas. It takes the frontend module as an
argument (`bd`, with `src_kw` passed to its read_parquet and
from_pandas, e.g. {"device": "cpu"}), so one text drives this package's
frontend and any other with the same API.

`pandas_program` computes the same results with pandas on the same file.
Both return {name: pandas DataFrame or Series} in a comparable form
(`normalize`); `check` holds one against the other: keys, codes, counts
and row order exact; float sums and means within `rtol`; the running
sum and the rolling mean within workloads/windows.prefix_atol, the
group means within it over the group's row count.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

ZONES = 60          # rows of the dimension frame: every third pickup zone
BOROUGHS = ("Bronx", "Brooklyn", "EWR", "Manhattan", "Queens",
            "Staten Island")

# the outputs whose values are window sums, by their source column
WINDOW_SUMS = {"cumsum": "miles_cumsum", "rolling": "miles_r7"}


def dimension_frame(seed: int = 0):
    """The small dimension frame of the left merge: a borough and a fare
    factor for every third pickup zone (1, 4, ..., 178)."""
    import pandas as pd
    r = np.random.default_rng(seed + 7)
    return pd.DataFrame({
        "PULocationID": np.arange(1, 180, 3, dtype=np.int64)[:ZONES],
        "borough": r.choice(list(BOROUGHS), ZONES),
        "fare_factor": np.round(r.uniform(0.5, 2.0, ZONES), 3),
    })


def program(bd, trips_path: str, zones, src_kw=None) -> Dict[str, object]:
    """The program through the frontend module `bd`; every result
    materialized to pandas."""
    kw = dict(src_kw or {})
    trips = bd.read_parquet(trips_path, **kw)
    out = {}
    out["agg"] = trips.groupby("PULocationID", as_index=False).agg(
        trips=("trip_miles", "count"), miles_sum=("trip_miles", "sum"),
        miles_mean=("trip_miles", "mean"), miles_min=("trip_miles", "min"),
        miles_max=("trip_miles", "max"),
        dropoffs=("DOLocationID", "nunique"),
        miles_median=("trip_miles", "median")
    ).sort_values("PULocationID").to_pandas()

    by_zone = trips.groupby("PULocationID")
    out["rank"] = by_zone["DOLocationID"].rank(method="min").to_pandas()
    out["cumcount"] = by_zone.cumcount().to_pandas()
    out["transform_mean"] = by_zone["trip_miles"].transform(
        "mean").to_pandas()
    out["group_shift"] = by_zone["trip_miles"].shift(1).to_pandas()

    w = bd.read_parquet(trips_path, **kw)[["PULocationID", "trip_miles"]]
    w["miles_cumsum"] = w["trip_miles"].cumsum()
    w["miles_r7"] = w["trip_miles"].rolling(7).mean()
    w["miles_shift"] = w["trip_miles"].shift(1)
    w["miles_diff"] = w["trip_miles"].diff(1)
    out["series_windows"] = w.to_pandas()

    out["value_counts"] = trips["hvfhs_license_num"].value_counts()
    out["nlargest"] = trips["trip_miles"].nlargest(5)
    out["drop_duplicates"] = trips[["PULocationID", "hvfhs_license_num"]] \
        .drop_duplicates().sort_values(
            ["PULocationID", "hvfhs_license_num"]).to_pandas()
    trips["month"] = trips["pickup_datetime"].dt.month
    out["pivot"] = trips.pivot_table(values="trip_miles",
                                     index="hvfhs_license_num",
                                     columns="month", aggfunc="mean")
    g = trips.groupby("PULocationID", as_index=False).agg(
        miles_sum=("trip_miles", "sum"), miles_mean=("trip_miles", "mean")
    ).sort_values("PULocationID")
    out["melt"] = g.melt(id_vars=["PULocationID"],
                         value_vars=["miles_sum", "miles_mean"]).to_pandas()
    out["sorted_index"] = trips.set_index("trip_miles").sort_index() \
        .head(10).to_pandas()

    m = trips.merge(bd.from_pandas(zones, **kw), on="PULocationID",
                    how="left")
    m["adj_miles"] = m["trip_miles"] * m["fare_factor"].fillna(1.0)
    out["left_merge"] = m.groupby("DOLocationID", as_index=False).agg(
        adj_miles=("adj_miles", "sum"), zoned=("borough", "count"),
        trips=("trip_miles", "count")
    ).sort_values("DOLocationID").to_pandas()
    return normalize(out)


def pandas_program(trips_path: str, zones) -> Dict[str, object]:
    """The same program in pandas (the running sum in extended precision,
    workloads/windows.accurate_cumsum)."""
    import pandas as pd

    from bodo_tpu_torch.workloads.windows import accurate_cumsum
    trips = pd.read_parquet(trips_path)
    out = {}
    out["agg"] = trips.groupby("PULocationID", as_index=False).agg(
        trips=("trip_miles", "count"), miles_sum=("trip_miles", "sum"),
        miles_mean=("trip_miles", "mean"), miles_min=("trip_miles", "min"),
        miles_max=("trip_miles", "max"),
        dropoffs=("DOLocationID", "nunique"),
        miles_median=("trip_miles", "median"))

    by_zone = trips.groupby("PULocationID")
    out["rank"] = by_zone["DOLocationID"].rank(method="min")
    out["cumcount"] = by_zone.cumcount()
    out["transform_mean"] = by_zone["trip_miles"].transform("mean")
    out["group_shift"] = by_zone["trip_miles"].shift(1)

    w = trips[["PULocationID", "trip_miles"]].copy()
    w["miles_cumsum"] = accurate_cumsum(w["trip_miles"].to_numpy())
    w["miles_r7"] = w["trip_miles"].rolling(7).mean()
    w["miles_shift"] = w["trip_miles"].shift(1)
    w["miles_diff"] = w["trip_miles"].diff(1)
    out["series_windows"] = w

    out["value_counts"] = trips["hvfhs_license_num"].value_counts()
    out["nlargest"] = trips["trip_miles"].nlargest(5)
    out["drop_duplicates"] = trips[["PULocationID", "hvfhs_license_num"]] \
        .drop_duplicates().sort_values(["PULocationID", "hvfhs_license_num"])
    trips["month"] = trips["pickup_datetime"].dt.month
    out["pivot"] = trips.pivot_table(values="trip_miles",
                                     index="hvfhs_license_num",
                                     columns="month", aggfunc="mean")
    g = trips.groupby("PULocationID", as_index=False).agg(
        miles_sum=("trip_miles", "sum"), miles_mean=("trip_miles", "mean"))
    out["melt"] = g.melt(id_vars=["PULocationID"],
                         value_vars=["miles_sum", "miles_mean"])
    out["sorted_index"] = trips.set_index("trip_miles").sort_index() \
        .head(10)

    m = trips.merge(zones, on="PULocationID", how="left")
    m["adj_miles"] = m["trip_miles"] * m["fare_factor"].fillna(1.0)
    out["left_merge"] = m.groupby("DOLocationID", as_index=False).agg(
        adj_miles=("adj_miles", "sum"), zoned=("borough", "count"),
        trips=("trip_miles", "count"))
    return normalize(out)


def normalize(out: Dict[str, object]) -> Dict[str, object]:
    """Results in a comparable form: each Series named by its result
    (the frontend names a window by its op, pandas by its column), the
    ranks as float64 (pandas' rank dtype), the value counts sorted by
    their index, nlargest's values alone (pandas keeps the original row
    labels, the frontend numbers the rows), and a fresh RangeIndex but
    where the index carries the result (pivot, sorted_index,
    value_counts)."""
    import pandas as pd
    res = {}
    for k, v in out.items():
        if k == "value_counts":
            v = v.sort_index()
            v = pd.Series(v.to_numpy(np.int64),
                          index=pd.Index(v.index.astype(str),
                                         name=v.index.name))
        elif k in ("nlargest", "rank"):
            v = pd.Series(v.to_numpy(np.float64))
        elif k not in ("pivot", "sorted_index"):
            v = v.reset_index(drop=True)
        if isinstance(v, pd.Series):
            v = v.rename(k)
        res[k] = v
    return res


def check(got: Dict[str, object], want: Dict[str, object], rtol: float,
          label: str) -> None:
    """Hold the frontend's results `got` to `want` (pandas_program or
    another run): the same names, shapes and columns; integers, bools,
    strings, dates and NaN positions exact; floats within `rtol`, the
    window sums (WINDOW_SUMS) within prefix_atol of trip_miles, the group
    means within it over their group's row count. Raises
    AssertionError."""
    import pandas as pd

    from bodo_tpu_torch.workloads.windows import prefix_atol
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: results {sorted(got)} vs "
                             f"{sorted(want)}")
    miles = want["series_windows"]["trip_miles"].to_numpy(np.float64)
    atol = prefix_atol(miles)
    counts = want["agg"].set_index("PULocationID")["trips"]
    zone = want["series_windows"]["PULocationID"].to_numpy()
    group_atol = atol / counts.reindex(zone).to_numpy(np.float64)
    for name in sorted(want):
        g, w = got[name], want[name]
        lab = f"{label} {name}"
        if isinstance(w, pd.Series):
            g, w = g.to_frame(), w.to_frame()
        if list(g.columns.astype(str)) != list(w.columns.astype(str)) or \
                g.shape != w.shape:
            raise AssertionError(f"{lab}: columns/shape "
                                 f"{list(g.columns)} {g.shape} vs "
                                 f"{list(w.columns)} {w.shape}")
        if not g.index.equals(w.index):
            raise AssertionError(f"{lab}: index differs")
        for j, c in enumerate(w.columns):
            gv, wv = g.iloc[:, j], w.iloc[:, j]
            if wv.dtype.kind != "f":
                gv = gv.to_numpy()
                wv = wv.to_numpy()
                if wv.dtype.kind in "iub":
                    gv = gv.astype(wv.dtype)
                if not np.array_equal(gv.astype(str), wv.astype(str)):
                    bad = int(np.flatnonzero(gv.astype(str)
                                             != wv.astype(str))[0])
                    raise AssertionError(f"{lab} {c}: row {bad} "
                                         f"{gv[bad]!r} vs {wv[bad]!r}")
                continue
            gv = gv.to_numpy(np.float64)
            wv = wv.to_numpy(np.float64)
            if not np.array_equal(np.isnan(gv), np.isnan(wv)):
                raise AssertionError(f"{lab} {c}: NaN rows differ")
            ok = ~np.isnan(wv)
            err = np.abs(gv[ok] - wv[ok])
            if c in WINDOW_SUMS.values():
                lim = np.full(err.shape, atol)
            elif name == "transform_mean":
                lim = group_atol[ok]
            else:
                lim = rtol * np.abs(wv[ok])
            if np.any(err > lim):
                bad = int(np.argmax(err - lim))
                raise AssertionError(f"{lab} {c}: |delta| {err[bad]:.3e} "
                                     f"over {lim[bad]:.3e}")
