"""Datetime field extraction (int64 ns ticks -> civil fields).

Counterpart of bodo_tpu/ops/datetime.py for the fields the relational
path uses. Branch-free integer arithmetic with floor division, so
timestamps before 1970 land on the right day.
"""

from __future__ import annotations

import torch

NS_PER_DAY = 86_400_000_000_000
NS_PER_HOUR = 3_600_000_000_000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def days_from_ns(ns):
    """Days since 1970-01-01 (floor division: correct before the epoch)."""
    return _fdiv(ns.to(torch.int64), NS_PER_DAY)


def _civil(days):
    """(year, month, day) from days since the epoch; branch-free."""
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def year(ns):
    return _civil(days_from_ns(ns))[0]


def month(ns):
    return _civil(days_from_ns(ns))[1]


def day(ns):
    return _civil(days_from_ns(ns))[2]


def hour(ns):
    tod = ns.to(torch.int64) - days_from_ns(ns) * NS_PER_DAY
    return _fdiv(tod, NS_PER_HOUR)


def dayofweek(ns):
    """Monday=0 (pandas convention); 1970-01-01 was a Thursday (=3)."""
    return torch.remainder(days_from_ns(ns) + 3, 7)


def date(ns):
    """Date as int32 days since the epoch (the DATE physical repr)."""
    return days_from_ns(ns).to(torch.int32)


FIELDS = {
    "year": year, "month": month, "day": day, "hour": hour,
    "dayofweek": dayofweek, "weekday": dayofweek, "date": date,
}
