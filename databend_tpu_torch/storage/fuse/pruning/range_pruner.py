"""Range (zone-map) pruning: can a predicate possibly match a block?

Analog of the reference's ``RangeIndex::should_keep``
(reference: src/query/storages/common/index/src/range_index.rs:65) —
tri-state interval evaluation of the bound predicate against per-block
min/max statistics. Conservative: anything not understood is "maybe".
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, Optional

from ....expression.expr import (BoundColumn, CastExpr, Constant, Func,
                                 ScalarExpr)
from ..statistics import ColumnStats


class PruneResult(Enum):
    ALWAYS = "always"   # predicate true for every row
    NEVER = "never"     # predicate true for no row -> prune the block
    MAYBE = "maybe"


_NEG = {"eq": "eq", "noteq": "noteq", "lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte"}


def _unwrap_cast(e: ScalarExpr) -> ScalarExpr:
    """Unwrap casts, folding string date/timestamp constants to their
    numeric (days / microseconds) value so they compare against int
    zone-map stats."""
    if not isinstance(e, CastExpr):
        return e
    inner = e.arg
    if isinstance(inner, Constant) and isinstance(inner.value, str):
        from ....types.datatype import DateType, TimestampType
        dst = e.dtype.remove_nullable()
        try:
            import datetime as _dt
            if isinstance(dst, DateType):
                days = (_dt.date.fromisoformat(inner.value[:10])
                        - _dt.date(1970, 1, 1)).days
                return Constant(days, dst)
            if isinstance(dst, TimestampType):
                ts = _dt.datetime.fromisoformat(inner.value).replace(
                    tzinfo=_dt.timezone.utc)
                return Constant(int(ts.timestamp() * 1_000_000), dst)
        except ValueError:
            return inner
    return inner


def _col_const(fn: Func):
    """Normalize (col CMP const) / (const CMP col) -> (col, const, cmp)."""
    a, b = fn.args[0], fn.args[1]
    a = _unwrap_cast(a)
    b = _unwrap_cast(b)
    if isinstance(a, BoundColumn) and isinstance(b, Constant):
        return a, b, fn.name
    if isinstance(a, Constant) and isinstance(b, BoundColumn):
        return b, a, _NEG[fn.name]
    return None


def range_should_keep(expr: Optional[ScalarExpr],
                      stats: Dict[str, ColumnStats]) -> bool:
    """False only when the predicate provably matches no row."""
    if expr is None:
        return True
    return _eval(expr, stats) != PruneResult.NEVER


def _eval(e: ScalarExpr, stats: Dict[str, ColumnStats]) -> PruneResult:
    if isinstance(e, Constant):
        if e.value is None or e.value is False:
            return PruneResult.NEVER
        if e.value is True:
            return PruneResult.ALWAYS
        return PruneResult.MAYBE
    if not isinstance(e, Func):
        return PruneResult.MAYBE
    if e.name == "and":
        results = [_eval(a, stats) for a in e.args]
        if PruneResult.NEVER in results:
            return PruneResult.NEVER
        if all(r == PruneResult.ALWAYS for r in results):
            return PruneResult.ALWAYS
        return PruneResult.MAYBE
    if e.name == "or":
        results = [_eval(a, stats) for a in e.args]
        if PruneResult.ALWAYS in results:
            return PruneResult.ALWAYS
        if all(r == PruneResult.NEVER for r in results):
            return PruneResult.NEVER
        return PruneResult.MAYBE
    if e.name == "not":
        r = _eval(e.args[0], stats)
        if r == PruneResult.ALWAYS:
            return PruneResult.NEVER
        if r == PruneResult.NEVER:
            return PruneResult.ALWAYS
        return PruneResult.MAYBE
    if e.name in _NEG:
        nc = _col_const(e)
        if nc is None:
            return PruneResult.MAYBE
        col, const, cmp = nc
        st = stats.get(col.name)
        if st is None or st.min is None or const.value is None:
            return PruneResult.MAYBE
        return _eval_cmp(cmp, st, const.value)
    if e.name == "like":
        nc = _col_const(e)
        if nc is None:
            return PruneResult.MAYBE
        col, const, _ = nc
        st = stats.get(col.name)
        if st is None or st.min is None or not isinstance(const.value, str):
            return PruneResult.MAYBE
        prefix = _like_prefix(const.value)
        if not prefix:
            return PruneResult.MAYBE
        # rows can only match if [min, max] overlaps [prefix, prefix~)
        hi = prefix + "￿"
        if str(st.max) < prefix or str(st.min) > hi:
            return PruneResult.NEVER
        return PruneResult.MAYBE
    return PruneResult.MAYBE


def _like_prefix(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c in "%_":
            break
        if c == "\\" and i + 1 < len(pattern):
            out.append(pattern[i + 1])
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _eval_cmp(cmp: str, st: ColumnStats, v) -> PruneResult:
    try:
        mn, mx = st.min, st.max
        if isinstance(v, str) != isinstance(mn, str):
            if isinstance(mn, str):
                return PruneResult.MAYBE
            try:
                v = float(v) if not isinstance(v, (int, float, bool)) else v
            except (ValueError, TypeError):
                return PruneResult.MAYBE
        if cmp == "eq":
            if v < mn or v > mx:
                return PruneResult.NEVER
            if mn == mx == v and st.null_count == 0:
                return PruneResult.ALWAYS
            return PruneResult.MAYBE
        if cmp == "noteq":
            if mn == mx == v:
                return PruneResult.NEVER
            if v < mn or v > mx:
                return PruneResult.ALWAYS if st.null_count == 0 else PruneResult.MAYBE
            return PruneResult.MAYBE
        if cmp == "lt":
            if mn >= v:
                return PruneResult.NEVER
            if mx < v and st.null_count == 0:
                return PruneResult.ALWAYS
            return PruneResult.MAYBE
        if cmp == "lte":
            if mn > v:
                return PruneResult.NEVER
            if mx <= v and st.null_count == 0:
                return PruneResult.ALWAYS
            return PruneResult.MAYBE
        if cmp == "gt":
            if mx <= v:
                return PruneResult.NEVER
            if mn > v and st.null_count == 0:
                return PruneResult.ALWAYS
            return PruneResult.MAYBE
        if cmp == "gte":
            if mx < v:
                return PruneResult.NEVER
            if mn >= v and st.null_count == 0:
                return PruneResult.ALWAYS
            return PruneResult.MAYBE
    except TypeError:
        return PruneResult.MAYBE
    return PruneResult.MAYBE
