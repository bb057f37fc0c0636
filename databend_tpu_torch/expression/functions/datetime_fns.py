"""Date/time functions (reference: src/query/functions/src/scalars/datetime.rs).

Dates are int32 days since epoch; timestamps int64 microseconds since epoch.
"""

from __future__ import annotations

import datetime as _dt
import time

import numpy as np

from ...errors import SemanticError
from ...types import (Date, Int64, String, Timestamp, UInt8, UInt16,
                      UInt32, UInt64)
from ..column import StringData
from .registry import scalar_function

_US = 1_000_000


def _res(name, n, ret):
    def resolve(arg_types):
        if len(arg_types) != n:
            raise SemanticError(f"{name} expects {n} args")
        return ret
    return resolve

def _flex_date(s: str) -> _dt.date:
    """fromisoformat + tolerant fallback: single-digit month/day and
    slash separators ('2024-9-1', '2024/09/01') parse like the
    reference's date parser."""
    try:
        return _dt.date.fromisoformat(s[:10].strip())
    except ValueError:
        import re as _re
        m = _re.match(r"\s*(\d{1,4})[-/](\d{1,2})[-/](\d{1,2})", s)
        if not m:
            raise
        return _dt.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))


def _flex_datetime(s: str) -> _dt.datetime:
    try:
        return _dt.datetime.fromisoformat(s.strip())
    except ValueError:
        import re as _re
        m = _re.match(r"\s*(\d{1,4})[-/](\d{1,2})[-/](\d{1,2})"
                      r"(?:[ T](\d{1,2}):(\d{1,2})(?::(\d{1,2})"
                      r"(?:\.(\d+))?)?)?", s)
        if not m:
            raise
        frac = (m.group(7) or "0").ljust(6, "0")[:6]
        return _dt.datetime(int(m.group(1)), int(m.group(2)),
                            int(m.group(3)), int(m.group(4) or 0),
                            int(m.group(5) or 0), int(m.group(6) or 0),
                            int(frac))


@scalar_function("now", _res("now", 0, Timestamp), aliases=["current_timestamp"])
def _now(n_rows=None, **kw):
    return np.full(n_rows, int(time.time() * _US), np.int64)


@scalar_function("today", _res("today", 0, Date), aliases=["current_date"])
def _today(n_rows=None, **kw):
    return np.full(n_rows, int(time.time() // 86400), np.int32)


def _res_1or2(name, ret):
    def resolve(arg_types):
        if len(arg_types) not in (1, 2):
            raise SemanticError(f"{name} expects 1 or 2 args")
        return ret
    return resolve


@scalar_function("to_date", _res_1or2("to_date", Date))
def _to_date(a, fmt=None, arg_types=None, **kw):
    if fmt is not None:
        # to_date(s, '%Y%m%d'): strptime-style parse (reference
        # to_date with format)
        f = fmt.to_pylist()[0] if isinstance(fmt, StringData) \
            else str(np.asarray(fmt).ravel()[0])
        out = []
        for s in (a.to_pylist() if isinstance(a, StringData)
                  else [str(x) for x in np.asarray(a).tolist()]):
            try:
                d = _dt.datetime.strptime(s or "", f).date()
            except ValueError:
                from ...errors import BadDataValueType
                raise BadDataValueType(
                    f"cannot parse {s!r} with format {f!r}")
            out.append((d - _dt.date(1970, 1, 1)).days)
        return np.array(out, np.int32)
    t = arg_types[0].remove_nullable()
    if isinstance(a, StringData):
        out = []
        for s in a.to_pylist():
            try:
                d = _flex_date(s) if s else _dt.date(1970, 1, 1)
            except ValueError as ex:
                from ...errors import BadDataValueType
                raise BadDataValueType(f"to_date: {ex}: {s!r}")
            out.append((d - _dt.date(1970, 1, 1)).days)
        return np.array(out, np.int32)
    if t == Timestamp:
        return (np.asarray(a, np.int64) // (86400 * _US)).astype(np.int32)
    return np.asarray(a).astype(np.int32)


@scalar_function("to_timestamp", _res("to_timestamp", 1, Timestamp),
                 aliases=["to_datetime", "to_timestamp_tz"])
def _to_timestamp(a, arg_types=None, **kw):
    t = arg_types[0].remove_nullable()
    if isinstance(a, StringData):
        out = []
        for s in a.to_pylist():
            if not s:
                out.append(0)
                continue
            try:
                dt = _flex_datetime(s)
            except ValueError as ex:
                from ...errors import BadDataValueType
                raise BadDataValueType(f"to_timestamp: {ex}: {s!r}")
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            out.append(int(dt.timestamp() * _US))
        return np.array(out, np.int64)
    if t == Date:
        return np.asarray(a, np.int64) * 86400 * _US
    return np.asarray(a).astype(np.int64)


def _days_array(a, arg_types):
    t = arg_types[0].remove_nullable()
    if t == Timestamp:
        return (np.asarray(a, np.int64) // (86400 * _US)).astype(np.int64)
    return np.asarray(a, np.int64)


def _civil(a, arg_types):
    days = _days_array(a, arg_types)
    # vectorized civil-from-days (Howard Hinnant's algorithm)
    z = days + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = np.where(m <= 2, y + 1, y)
    return y.astype(np.int64), m.astype(np.int64), d.astype(np.int64)


@scalar_function("to_year", _res("to_year", 1, UInt16), aliases=["year"])
def _to_year(a, arg_types=None, **kw):
    y, _, _ = _civil(a, arg_types)
    return y.astype(np.uint16)


@scalar_function("to_month", _res("to_month", 1, UInt8), aliases=["month"])
def _to_month(a, arg_types=None, **kw):
    _, m, _ = _civil(a, arg_types)
    return m.astype(np.uint8)


@scalar_function("to_day_of_month", _res("to_day_of_month", 1, UInt8), aliases=["day", "to_day"])
def _to_day(a, arg_types=None, **kw):
    _, _, d = _civil(a, arg_types)
    return d.astype(np.uint8)


@scalar_function("to_day_of_week", _res("to_day_of_week", 1, UInt8), aliases=["dayofweek"])
def _to_dow(a, arg_types=None, **kw):
    days = _days_array(a, arg_types)
    return (((days + 3) % 7) + 1).astype(np.uint8)  # 1=Monday..7=Sunday


@scalar_function("to_yyyymm", _res("to_yyyymm", 1, UInt32))
def _to_yyyymm(a, arg_types=None, **kw):
    y, m, _ = _civil(a, arg_types)
    return (y * 100 + m).astype(np.uint32)


@scalar_function("to_yyyymmdd", _res("to_yyyymmdd", 1, UInt32))
def _to_yyyymmdd(a, arg_types=None, **kw):
    y, m, d = _civil(a, arg_types)
    return (y * 10000 + m * 100 + d).astype(np.uint32)


@scalar_function("to_yyyymmddhhmmss",
                 _res("to_yyyymmddhhmmss", 1, UInt64))
def _to_yyyymmddhhmmss(a, arg_types=None, **kw):
    y, m, d = _civil(a, arg_types)
    t = arg_types[0].remove_nullable()
    if t == Date:
        secs = np.zeros(len(y), np.int64)
    else:
        secs = np.asarray(a, np.int64) // _US % 86400
    ymd = y * 10000 + m * 100 + d
    return (ymd.astype(np.uint64) * 1000000
            + (secs // 3600) * 10000 + (secs % 3600 // 60) * 100
            + secs % 60)


@scalar_function("to_unix_timestamp", _res("to_unix_timestamp", 1, Int64))
def _to_unix(a, arg_types=None, **kw):
    t = arg_types[0].remove_nullable()
    if t == Date:
        return np.asarray(a, np.int64) * 86400
    return np.asarray(a, np.int64) // _US


def _res_date_trunc(arg_types):
    if len(arg_types) != 2:
        raise SemanticError("date_trunc expects (unit, date/timestamp)")
    return arg_types[1].remove_nullable()


@scalar_function("date_trunc", _res_date_trunc)
def _date_trunc(unit, a, arg_types=None, **kw):
    """DATE_TRUNC('minute'|'hour'|..., expr) — reference
    scalars/datetime.rs date_trunc/to_start_of_* family."""
    u = (unit.get(0) if isinstance(unit, StringData) else str(unit)).lower()
    t = arg_types[1].remove_nullable()
    arr = np.asarray(a, np.int64)
    if t == Date:
        if u in ("second", "minute", "hour", "day"):
            return arr.astype(np.int32)  # sub-day units: identity on DATE
        if u == "week":  # Monday start (epoch day 4 = first Monday)
            return ((arr - 4) // 7 * 7 + 4).astype(np.int32)
        y, m, _d = _civil(arr, [Date])
        if u == "month":
            first = _days_from_civil(y, m, np.ones_like(m))
        elif u == "quarter":
            qm = (m - 1) // 3 * 3 + 1
            first = _days_from_civil(y, qm, np.ones_like(m))
        elif u == "year":
            first = _days_from_civil(y, np.ones_like(m), np.ones_like(m))
        else:
            raise SemanticError(f"date_trunc: unknown unit {u!r}")
        return first.astype(np.int32)
    us = {"second": _US, "minute": 60 * _US, "hour": 3600 * _US,
          "day": 86400 * _US}.get(u)
    if us is not None:
        return arr // us * us
    if u == "week":
        day = arr // (86400 * _US)
        return ((day - 4) // 7 * 7 + 4) * 86400 * _US
    y, m, _d = _civil(arr, [Timestamp])
    if u == "month":
        first = _days_from_civil(y, m, np.ones_like(m))
    elif u == "quarter":
        qm = (m - 1) // 3 * 3 + 1
        first = _days_from_civil(y, qm, np.ones_like(m))
    elif u == "year":
        first = _days_from_civil(y, np.ones_like(m), np.ones_like(m))
    else:
        raise SemanticError(f"date_trunc: unknown unit {u!r}")
    return first * 86400 * _US


def _days_from_civil(y, m, d):
    """Inverse of _civil (Howard Hinnant's days_from_civil), vectorized."""
    y = y - (m <= 2)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    mp = np.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


@scalar_function("date_format", _res("date_format", 2, String), aliases=["to_char"])
def _date_format(a, fmt, arg_types=None, **kw):
    t = arg_types[0].remove_nullable()
    fmts = fmt.to_pylist() if isinstance(fmt, StringData) else [str(fmt)] * len(a)
    out = []
    arr = np.asarray(a, np.int64)
    for v, f in zip(arr.tolist(), fmts):
        if t == Date:
            dt = _dt.datetime(1970, 1, 1) + _dt.timedelta(days=int(v))
        else:
            dt = _dt.datetime.fromtimestamp(v / _US, _dt.timezone.utc)
        out.append(dt.strftime(f))
    return StringData.from_pylist(out)


# ---- date arithmetic (reference: scalars/datetime.rs add_* family) ---------

def _res_same_as_first(name):
    def resolve(arg_types):
        if len(arg_types) != 2:
            raise SemanticError(f"{name} expects 2 args")
        return arg_types[0].remove_nullable()
    return resolve


def _add_fixed(a, n, arg_types, unit_us: int):
    """Add a fixed-duration unit (days/hours/minutes/seconds)."""
    t = arg_types[0].remove_nullable()
    n = np.asarray(n, np.int64)
    if t == Date:
        if unit_us % (86400 * _US) == 0:
            return (np.asarray(a, np.int64)
                    + n * (unit_us // (86400 * _US))).astype(np.int32)
        # sub-day add on a date promotes through microseconds, then floors
        us = np.asarray(a, np.int64) * 86400 * _US + n * unit_us
        return (us // (86400 * _US)).astype(np.int32)
    return np.asarray(a, np.int64) + n * unit_us


def _add_months_impl(a, n, arg_types):
    t = arg_types[0].remove_nullable()
    days = (np.asarray(a, np.int64) if t == Date
            else np.asarray(a, np.int64) // (86400 * _US))
    rem_us = (np.zeros_like(days) if t == Date
              else np.asarray(a, np.int64) - days * 86400 * _US)
    n = np.asarray(n, np.int64)
    if n.ndim == 0:
        n = np.full_like(days, int(n))
    out = np.empty_like(days)
    epoch = _dt.date(1970, 1, 1)
    for i in range(len(days)):
        d = epoch + _dt.timedelta(days=int(days[i]))
        total = d.year * 12 + (d.month - 1) + int(n[i])
        y, m = divmod(total, 12)
        # clamp day-of-month (reference: add_months clamps to month end)
        for dom in (d.day, 30, 29, 28):
            try:
                nd = _dt.date(y, m + 1, dom)
                break
            except ValueError:
                continue
        out[i] = (nd - epoch).days
    if t == Date:
        return out.astype(np.int32)
    return out * 86400 * _US + rem_us


@scalar_function("add_days", _res_same_as_first("add_days"))
def _add_days(a, n, arg_types=None, **kw):
    return _add_fixed(a, n, arg_types, 86400 * _US)


@scalar_function("subtract_days", _res_same_as_first("subtract_days"))
def _sub_days(a, n, arg_types=None, **kw):
    return _add_fixed(a, -np.asarray(n, np.int64), arg_types, 86400 * _US)


@scalar_function("add_hours", _res_same_as_first("add_hours"))
def _add_hours(a, n, arg_types=None, **kw):
    return _add_fixed(a, n, arg_types, 3600 * _US)


@scalar_function("add_minutes", _res_same_as_first("add_minutes"))
def _add_minutes(a, n, arg_types=None, **kw):
    return _add_fixed(a, n, arg_types, 60 * _US)


@scalar_function("add_seconds", _res_same_as_first("add_seconds"))
def _add_seconds(a, n, arg_types=None, **kw):
    return _add_fixed(a, n, arg_types, _US)


@scalar_function("add_months", _res_same_as_first("add_months"))
def _add_months(a, n, arg_types=None, **kw):
    return _add_months_impl(a, n, arg_types)


@scalar_function("subtract_months", _res_same_as_first("subtract_months"))
def _sub_months(a, n, arg_types=None, **kw):
    return _add_months_impl(a, -np.asarray(n, np.int64), arg_types)


@scalar_function("add_years", _res_same_as_first("add_years"))
def _add_years(a, n, arg_types=None, **kw):
    return _add_months_impl(a, 12 * np.asarray(n, np.int64), arg_types)


@scalar_function("subtract_years", _res_same_as_first("subtract_years"))
def _sub_years(a, n, arg_types=None, **kw):
    return _add_months_impl(a, -12 * np.asarray(n, np.int64), arg_types)


def _date_diff_resolver(name):
    def resolve(arg_types):
        if len(arg_types) not in (2, 3):
            raise SemanticError(f"{name} expects 2 or 3 args")
        return Int64
    return resolve


@scalar_function("date_diff", _date_diff_resolver("date_diff"),
                 aliases=["datediff"])
def _date_diff(*args, arg_types=None, **kw):
    """date_diff(a, b) = a - b in days (MySQL) or
    date_diff('unit', start, end) = end - start in units (reference)."""
    def to_us(x, t):
        t = t.remove_nullable()
        if t == Date:
            return np.asarray(x, np.int64) * 86400 * _US
        return np.asarray(x, np.int64)

    if len(args) == 2:
        return (to_us(args[0], arg_types[0])
                - to_us(args[1], arg_types[1])) // (86400 * _US)
    unit_col = args[0]
    unit = (unit_col.get(0) if hasattr(unit_col, "get")
            else str(np.asarray(unit_col).ravel()[0])).lower().rstrip("s")
    delta = to_us(args[2], arg_types[2]) - to_us(args[1], arg_types[1])
    scale = {"second": _US, "minute": 60 * _US, "hour": 3600 * _US,
             "day": 86400 * _US, "week": 7 * 86400 * _US}.get(unit)
    if scale is not None:
        return delta // scale
    if unit in ("month", "quarter", "year"):
        import datetime as _dt
        epoch = _dt.date(1970, 1, 1)
        def months(us):
            out = np.empty(len(us), np.int64)
            for i, u in enumerate(us.tolist()):
                d = epoch + _dt.timedelta(seconds=u // _US)
                out[i] = d.year * 12 + d.month
            return out
        m = months(to_us(args[2], arg_types[2])) - months(to_us(args[1], arg_types[1]))
        return m // {"month": 1, "quarter": 3, "year": 12}[unit]
    raise SemanticError(f"date_diff: unknown unit {unit!r}")


@scalar_function("date_add", _res("date_add", 2, Date), aliases=["date_sub_neg"])
def _date_add(a, n, arg_types=None, **kw):
    return np.asarray(a, np.int64) + np.asarray(n, np.int64)


@scalar_function("date_sub", _res("date_sub", 2, Date))
def _date_sub(a, n, arg_types=None, **kw):
    return np.asarray(a, np.int64) - np.asarray(n, np.int64)


@scalar_function("to_hour", _res("to_hour", 1, UInt8), aliases=["hour"])
def _to_hour(a, arg_types=None, **kw):
    t = arg_types[0].remove_nullable()
    us = (np.asarray(a, np.int64) * 86400 * _US if t == Date
          else np.asarray(a, np.int64))
    return ((us // (3600 * _US)) % 24).astype(np.uint8)


@scalar_function("to_minute", _res("to_minute", 1, UInt8), aliases=["minute"])
def _to_minute(a, arg_types=None, **kw):
    t = arg_types[0].remove_nullable()
    us = (np.asarray(a, np.int64) * 86400 * _US if t == Date
          else np.asarray(a, np.int64))
    return ((us // (60 * _US)) % 60).astype(np.uint8)


@scalar_function("to_second", _res("to_second", 1, UInt8), aliases=["second"])
def _to_second(a, arg_types=None, **kw):
    t = arg_types[0].remove_nullable()
    us = (np.asarray(a, np.int64) * 86400 * _US if t == Date
          else np.asarray(a, np.int64))
    return ((us // _US) % 60).astype(np.uint8)
