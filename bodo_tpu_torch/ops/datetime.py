"""Datetime field extraction (int64 ns ticks -> civil fields).

Counterpart of bodo_tpu/ops/datetime.py for the fields the relational
path and the pandas frontend's `.dt` accessor use. Branch-free integer
arithmetic with floor division, so timestamps before 1970 land on the
right day.
"""

from __future__ import annotations

import torch

NS_PER_DAY = 86_400_000_000_000
NS_PER_HOUR = 3_600_000_000_000
NS_PER_MIN = 60_000_000_000
NS_PER_SEC = 1_000_000_000


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


def minute(ns):
    tod = ns.to(torch.int64) - days_from_ns(ns) * NS_PER_DAY
    return _fdiv(torch.remainder(tod, NS_PER_HOUR), NS_PER_MIN)


def second(ns):
    tod = ns.to(torch.int64) - days_from_ns(ns) * NS_PER_DAY
    return _fdiv(torch.remainder(tod, NS_PER_MIN), NS_PER_SEC)


def dayofweek(ns):
    """Monday=0 (pandas convention); 1970-01-01 was a Thursday (=3)."""
    return torch.remainder(days_from_ns(ns) + 3, 7)


def date(ns):
    """Date as int32 days since the epoch (the DATE physical repr)."""
    return days_from_ns(ns).to(torch.int32)


def _days_from_civil(y, m, d):
    """Days since the epoch of civil date (y, m, d); branch-free."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def dayofyear(ns):
    days = days_from_ns(ns)
    y, _, _ = _civil(days)
    one = torch.ones_like(y)
    return days - _days_from_civil(y, one, one) + 1


def quarter(ns):
    return _fdiv(month(ns) - 1, 3) + 1


def week(ns):
    """ISO 8601 week number (1-53): the week of the date's Thursday."""
    thu = days_from_ns(ns) - dayofweek(ns) + 3
    y, _, _ = _civil(thu)
    one = torch.ones_like(y)
    return _fdiv(thu - _days_from_civil(y, one, one), 7) + 1


FIELDS = {
    "year": year, "month": month, "day": day, "hour": hour,
    "minute": minute, "second": second, "dayofweek": dayofweek,
    "weekday": dayofweek, "dayofyear": dayofyear, "quarter": quarter,
    "date": date, "week": week, "weekofyear": week,
}
