"""Aggregate functions (reference: src/query/functions/src/aggregates/, 37 files).

Vectorized grouped accumulation: every aggregate consumes
``(group_ids [N], num_groups, payload, validity)`` and updates a dense
per-group state — the segmented-reduction analog of the reference's
per-group hashtable states. Works for both hash aggregation (group_ids
from a group-by hash) and global aggregation (all zeros).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

import numpy as np

from ...errors import SemanticError, UnknownFunction
from ...types import (Boolean, DataType, DecimalType, Float64, Int64,
                      NumberType, String, UInt64)
from ..column import Column, StringData


class AggregateFunction:
    name: str = ""

    def __init__(self, arg_types: List[DataType], distinct: bool = False):
        self.arg_types = arg_types
        self.distinct = distinct

    def return_type(self) -> DataType:
        raise NotImplementedError

    def init_state(self, num_groups: int):
        raise NotImplementedError

    def update(self, state, group_ids: np.ndarray, payload, validity: Optional[np.ndarray]):
        raise NotImplementedError

    def merge(self, s1, s2):
        """Merge two equal-num_groups states (for parallel partials)."""
        raise NotImplementedError

    def finalize(self, state, num_groups: int) -> Column:
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _mask(group_ids, payload, validity):
        if validity is None:
            return group_ids, payload
        keep = validity
        return group_ids[keep], payload[keep] if payload is not None else None


class CountAgg(AggregateFunction):
    name = "count"

    def return_type(self):
        return UInt64

    def init_state(self, num_groups):
        return np.zeros(num_groups, np.int64)

    def update(self, state, group_ids, payload, validity):
        gids = group_ids if validity is None else group_ids[validity]
        np.add.at(state, gids, 1)

    def merge(self, s1, s2):
        return s1 + s2

    def finalize(self, state, num_groups):
        return Column.from_numpy(state.astype(np.uint64))


class SumAgg(AggregateFunction):
    name = "sum"

    def _decimal_type(self):
        from ...types import DecimalType
        t = self.arg_types[0].remove_nullable() if self.arg_types else None
        return t if isinstance(t, DecimalType) else None

    def return_type(self):
        t = self.arg_types[0].remove_nullable()
        if not t.is_numeric() and t != Boolean:
            raise SemanticError(f"sum expects numeric, got {t}")
        dt = self._decimal_type()
        if dt is not None:
            # sum keeps 64-bit decimals, widens 128-bit to DECIMAL(38,s)
            # and 256-bit to DECIMAL(76,s); enable_decimal_sum_widening
            # widens 128-bit straight to 76 (reference decimal sum types
            # + settings_default.rs:1297)
            if dt.precision <= 18:
                return dt
            if dt.precision <= 38:
                widen = False
                try:
                    from ...utils.current import current_session
                    s = current_session()
                    widen = bool(s and s.settings.get(
                        "enable_decimal_sum_widening"))
                except Exception:
                    pass
                return DecimalType(76 if widen else 38, dt.scale)
            return DecimalType(76, dt.scale)
        if isinstance(t, NumberType) and t.is_float():
            return Float64
        return Int64 if t != Boolean else UInt64

    def init_state(self, num_groups):
        if self._decimal_type() is not None:
            import decimal
            return [[decimal.Decimal(0)] * num_groups,
                    np.zeros(num_groups, np.int64)]
        return [np.zeros(num_groups, np.float64),
                np.zeros(num_groups, np.int64)]

    def update(self, state, group_ids, payload, validity):
        if self._decimal_type() is not None:
            acc = state[0]
            vals = payload.tolist()
            for i, g in enumerate(group_ids.tolist()):
                if validity is not None and not validity[i]:
                    continue
                acc[g] += vals[i]
                state[1][g] += 1
            return
        gids, p = self._mask(group_ids, np.asarray(payload, np.float64), validity)
        state[0] += np.bincount(gids, weights=p, minlength=len(state[0]))
        np.add.at(state[1], gids, 1)

    def merge(self, s1, s2):
        return [s1[0] + s2[0] if not isinstance(s1[0], list)
                else [a + b for a, b in zip(s1[0], s2[0])],
                s1[1] + s2[1]]

    def finalize(self, state, num_groups):
        # SQL: SUM over zero rows is NULL (reference aggregate semantics)
        rt = self.return_type()
        counts = state[1]
        validity = np.asarray(counts) > 0
        if self._decimal_type() is not None:
            vals = [v if ok else None
                    for v, ok in zip(state[0], validity.tolist())]
            import decimal as _dec
            rti = rt.remove_nullable()
            limit = _dec.Decimal(10) ** (rti.precision - rti.scale)
            for v in vals:
                if v is not None and abs(v) >= limit:
                    from ...errors import BadArguments
                    raise BadArguments(
                        f"Decimal overflow: sum exceeds {rt.sql_name()}")
            return Column.from_pylist(vals, rt.wrap_nullable())
        payload = state[0].astype(rt.numpy_dtype())
        return Column(rt.wrap_nullable(), payload,
                      None if validity.all() else validity)


class AvgAgg(AggregateFunction):
    name = "avg"

    def _decimal_type(self):
        t = self.arg_types[0].remove_nullable() if self.arg_types else None
        return t if isinstance(t, DecimalType) else None

    def return_type(self):
        dt = self._decimal_type()
        if dt is not None:
            # reference: avg(Decimal(p, s)) is DECIMAL(38|76, s+5)
            return DecimalType(38 if dt.precision <= 38 else 76,
                               min(dt.scale + 5, 36))
        return Float64

    def init_state(self, num_groups):
        if self._decimal_type() is not None:
            import decimal
            return [[decimal.Decimal(0)] * num_groups,
                    np.zeros(num_groups, np.int64)]
        return [np.zeros(num_groups, np.float64), np.zeros(num_groups, np.int64)]

    def update(self, state, group_ids, payload, validity):
        if self._decimal_type() is not None:
            acc = state[0]
            vals = payload.tolist()
            for i, g in enumerate(group_ids.tolist()):
                if validity is not None and not validity[i]:
                    continue
                acc[g] += vals[i]
                state[1][g] += 1
            return
        gids, p = self._mask(group_ids, np.asarray(payload, np.float64), validity)
        state[0] += np.bincount(gids, weights=p, minlength=len(state[0]))
        np.add.at(state[1], gids, 1)

    def merge(self, s1, s2):
        return [s1[0] + s2[0] if not isinstance(s1[0], list)
                else [a + b for a, b in zip(s1[0], s2[0])],
                s1[1] + s2[1]]

    def finalize(self, state, num_groups):
        sums, counts = state
        if self._decimal_type() is not None:
            import decimal
            rt = self.return_type()
            q = rt.quantum()
            with decimal.localcontext() as dctx:
                dctx.prec = max(rt.precision + rt.scale + 4, 80)
                vals = [None if c == 0
                        else (s / c).quantize(
                            q, rounding=decimal.ROUND_HALF_UP)
                        for s, c in zip(sums, counts.tolist())]
            return Column.from_pylist(vals, rt.wrap_nullable())
        with np.errstate(invalid="ignore", divide="ignore"):
            out = sums / counts
        validity = counts > 0
        return Column(Float64.wrap_nullable(), np.where(validity, out, 0.0),
                      None if validity.all() else validity)


class _MinMaxAgg(AggregateFunction):
    _is_min = True

    def return_type(self):
        return self.arg_types[0].remove_nullable()

    def _py_path(self):
        from ...types import DecimalType
        t = self.arg_types[0].remove_nullable()
        return t == String or isinstance(t, DecimalType)

    def init_state(self, num_groups):
        if self._py_path():
            return [[None] * num_groups]
        fill = np.inf if self._is_min else -np.inf
        return [np.full(num_groups, fill, np.float64), np.zeros(num_groups, np.bool_)]

    def update(self, state, group_ids, payload, validity):
        if self._py_path():
            if isinstance(payload, StringData):
                codes = payload.codes()
                if codes is not None and len(codes):
                    # rank path: decode + order UNIQUE values only, then a
                    # C-level minimum.at over int ranks; the per-group
                    # merge loop runs over groups, not rows
                    g = np.asarray(group_ids, np.int64)
                    codes_all = codes
                    if validity is not None:
                        keep = np.asarray(validity, bool)
                        g, codes = g[keep], codes[keep]
                    if not len(g):
                        return
                    n_u = int(codes.max()) + 1
                    # representative ORIGINAL row per code (same code =
                    # same bytes, so a null row's representative is fine
                    # for codes that also occur valid); zero-init so
                    # codes seen only in null rows don't leave garbage
                    rep = np.zeros(n_u, np.int64)
                    m = codes_all < n_u
                    rep[codes_all[m][::-1]] = np.flatnonzero(m)[::-1]
                    uniq = [payload.get(int(i)) for i in rep]
                    order = np.argsort(np.array(uniq, object))
                    rank = np.empty(n_u, np.int64)
                    rank[order] = np.arange(n_u)
                    best = state[0]
                    nb = len(best)
                    br = np.full(nb, n_u if self._is_min else -1, np.int64)
                    op = np.minimum if self._is_min else np.maximum
                    op.at(br, g, rank[codes])
                    by_rank = np.array(uniq, object)[order]
                    hit = np.nonzero((br < n_u) if self._is_min
                                     else (br >= 0))[0]
                    for gi in hit.tolist():
                        v = by_rank[br[gi]]
                        if best[gi] is None or \
                                (v < best[gi] if self._is_min
                                 else v > best[gi]):
                            best[gi] = v
                    return
            vals = payload.to_pylist() if isinstance(payload, StringData) else list(payload)
            best = state[0]
            for i, g in enumerate(group_ids.tolist()):
                if validity is not None and not validity[i]:
                    continue
                v = vals[i]
                if best[g] is None or (v < best[g] if self._is_min else v > best[g]):
                    best[g] = v
            return
        gids, p = self._mask(group_ids, np.asarray(payload, np.float64), validity)
        op = np.minimum if self._is_min else np.maximum
        op.at(state[0], gids, p)
        state[1][gids] = True

    def merge(self, s1, s2):
        if self._py_path():
            out = []
            for a, b in zip(s1[0], s2[0]):
                if a is None:
                    out.append(b)
                elif b is None:
                    out.append(a)
                else:
                    out.append(min(a, b) if self._is_min else max(a, b))
            return [out]
        op = np.minimum if self._is_min else np.maximum
        return [op(s1[0], s2[0]), s1[1] | s2[1]]

    def finalize(self, state, num_groups):
        t = self.arg_types[0].remove_nullable()
        if self._py_path():
            return Column.from_pylist(state[0], t.wrap_nullable())
        vals, seen = state
        col_vals = np.where(seen, vals, 0.0).astype(t.numpy_dtype())
        return Column(t.wrap_nullable(), col_vals, None if seen.all() else seen)


class MinAgg(_MinMaxAgg):
    name = "min"
    _is_min = True


class MaxAgg(_MinMaxAgg):
    name = "max"
    _is_min = False


def _uniq_pairs(g: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Unique (g, v) rows via lexsort (np.unique(axis=0) sorts void views
    and is an order of magnitude slower)."""
    order = np.lexsort((vals, g))
    gs, vs = g[order], vals[order]
    keep = np.ones(len(gs), np.bool_)
    keep[1:] = (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1])
    return np.stack([gs[keep], vs[keep]], axis=1)


def _uniq_pairs_hashed(g: np.ndarray, vals: np.ndarray,
                       num_groups: int) -> np.ndarray:
    """Unique (g, v) rows via hash-based pack+unique: O(n) pandas
    hashtable instead of an O(n log n) lexsort — ~20x at 1M rows. Values
    with a small range pack directly (one hash pass); wide ranges
    factorize first; overflow falls back to the lexsort."""
    import pandas as pd
    if len(vals) == 0:
        return np.empty((0, 2), np.int64)
    ng = max(int(num_groups), 1)
    vmin = int(vals.min())
    span = int(vals.max()) - vmin + 1
    if span < (1 << 62) // ng:
        packed = g * span + (vals - vmin)
        uniq = pd.unique(packed)
        return np.stack([uniq // span, uniq % span + vmin], axis=1)
    vcodes, vu = pd.factorize(vals)
    nv = len(vu) + 1
    if ng < (1 << 62) // nv:
        packed = g * nv + vcodes
        uniq = pd.unique(packed)
        return np.stack([uniq // nv, np.asarray(vu)[uniq % nv]], axis=1)
    return _uniq_pairs(g, vals)


class CountDistinctAgg(AggregateFunction):
    name = "count_distinct"

    def return_type(self):
        return UInt64

    def init_state(self, num_groups):
        # numeric payloads: per-block-deduped (group, value) pair chunks,
        # one global np.unique at finalize (reference: distinct via the
        # group hashtable). other payloads: per-group python sets.
        return {"n": num_groups, "chunks": [],
                "sets": [set() for _ in range(num_groups)]}

    def update(self, state, group_ids, payload, validity):
        import pandas as pd
        g = np.asarray(group_ids, np.int64)
        if not isinstance(payload, StringData):
            arr = np.asarray(payload)
            if arr.dtype.kind in "iub":
                vals = arr.astype(np.int64, copy=False)
                if validity is not None:
                    keep = np.asarray(validity, bool)
                    g, vals = g[keep], vals[keep]
                if len(g):
                    state["chunks"].append(
                        _uniq_pairs_hashed(g, vals, state["n"]))
                return
        # strings / floats: factorize to codes, unique pairs, set-insert
        if isinstance(payload, StringData):
            codes, lookup = pd.factorize(payload.as_object_array())
        else:
            codes, lookup = pd.factorize(np.asarray(payload))
        codes = codes.astype(np.int64, copy=False)
        if validity is not None:
            keep = np.asarray(validity, bool)
            g, codes = g[keep], codes[keep]
        ok = codes >= 0  # factorize NA sentinel: NULLs don't count
        if not ok.all():
            g, codes = g[ok], codes[ok]
        if len(g) == 0:
            return
        base = int(codes.max()) + 2
        uniq = np.unique(g * base + codes)
        vals_list = lookup.tolist()
        sets = state["sets"]
        for p in uniq.tolist():
            sets[p // base].add(vals_list[p % base])

    def merge(self, s1, s2):
        return {"n": max(s1["n"], s2["n"]),
                "chunks": s1["chunks"] + s2["chunks"],
                "sets": [a | b for a, b in zip(s1["sets"], s2["sets"])]}

    def finalize(self, state, num_groups):
        counts = np.array([len(s) for s in state["sets"]], np.uint64)
        chunks = state["chunks"]
        if len(chunks) == 1:
            # single update call (the vectorized one-run aggregate path):
            # pairs are already unique — just count per group
            counts = counts + np.bincount(
                chunks[0][:, 0],
                minlength=num_groups).astype(np.uint64)[:num_groups]
        elif chunks:
            allp = np.concatenate(chunks, axis=0)
            uniq = _uniq_pairs_hashed(allp[:, 0], allp[:, 1], num_groups)
            counts = counts + np.bincount(
                uniq[:, 0], minlength=num_groups).astype(np.uint64)[:num_groups]
        return Column.from_numpy(counts)


class AnyAgg(AggregateFunction):
    name = "any"

    def return_type(self):
        return self.arg_types[0].remove_nullable()

    def init_state(self, num_groups):
        return [[None] * num_groups]

    def update(self, state, group_ids, payload, validity):
        vals = payload.to_pylist() if isinstance(payload, StringData) else payload.tolist()
        for i, g in enumerate(group_ids.tolist()):
            if validity is not None and not validity[i]:
                continue
            if state[0][g] is None:
                state[0][g] = vals[i]

    def merge(self, s1, s2):
        return [[a if a is not None else b for a, b in zip(s1[0], s2[0])]]

    def finalize(self, state, num_groups):
        return Column.from_pylist(state[0], self.return_type().wrap_nullable())


class _VarianceAgg(AggregateFunction):
    """Welford-free sum/sumsq variance (population or sample)."""

    _sample = False

    def return_type(self):
        return Float64

    def init_state(self, num_groups):
        return [np.zeros(num_groups, np.float64), np.zeros(num_groups, np.float64),
                np.zeros(num_groups, np.int64)]

    def update(self, state, group_ids, payload, validity):
        gids, p = self._mask(group_ids, np.asarray(payload, np.float64), validity)
        state[0] += np.bincount(gids, weights=p, minlength=len(state[0]))
        state[1] += np.bincount(gids, weights=p * p, minlength=len(state[1]))
        np.add.at(state[2], gids, 1)

    def merge(self, s1, s2):
        return [s1[0] + s2[0], s1[1] + s2[1], s1[2] + s2[2]]

    def _var(self, state):
        s, ss, n = state
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = s / n
            var = np.maximum(ss / n - mean * mean, 0.0)
            if self._sample:
                var = var * n / np.maximum(n - 1, 1)
        return var, n

    def finalize(self, state, num_groups):
        var, n = self._var(state)
        valid = n > (1 if self._sample else 0)
        return Column(Float64.wrap_nullable(), np.where(valid, var, 0.0),
                      None if valid.all() else valid)


class VarPopAgg(_VarianceAgg):
    name = "var_pop"


class VarSampAgg(_VarianceAgg):
    name = "var_samp"
    _sample = True


class _StddevAgg(_VarianceAgg):
    def finalize(self, state, num_groups):
        var, n = self._var(state)
        valid = n > (1 if self._sample else 0)
        return Column(Float64.wrap_nullable(), np.where(valid, np.sqrt(var), 0.0),
                      None if valid.all() else valid)


class StddevPopAgg(_StddevAgg):
    name = "stddev_pop"


class StddevSampAgg(_StddevAgg):
    name = "stddev_samp"
    _sample = True


class StringAggAgg(AggregateFunction):
    """string_agg(x [, sep]) / group_concat; DISTINCT dedups values while
    preserving first-seen order (reference aggregate_string_agg.rs)."""

    name = "string_agg"
    multi_arg = True

    def return_type(self):
        return String

    def init_state(self, num_groups):
        return {"vals": [[] for _ in range(num_groups)], "sep": ","}

    def _append(self, state, group_ids, payload, validity):
        vals = payload.to_pylist() if isinstance(payload, StringData) \
            else [str(v) for v in payload.tolist()]
        for i, g in enumerate(group_ids.tolist()):
            if validity is not None and not validity[i]:
                continue
            state["vals"][g].append(vals[i])

    def update(self, state, group_ids, payload, validity):
        self._append(state, group_ids, payload, validity)

    def update_multi(self, state, group_ids, cols):
        if len(cols) > 1 and len(cols[1]):
            sep = cols[1].data
            state["sep"] = (sep.get(0) if isinstance(sep, StringData)
                            else str(sep[0] if hasattr(sep, "__getitem__")
                                     else sep))
        self._append(state, group_ids, cols[0].data, cols[0].validity)

    def merge(self, s1, s2):
        return {"vals": [a + b for a, b in zip(s1["vals"], s2["vals"])],
                "sep": s2["sep"] if s1["sep"] == "," else s1["sep"]}

    def finalize(self, state, num_groups):
        sep = state["sep"]
        if self.distinct:
            out = [sep.join(dict.fromkeys(v)) for v in state["vals"]]
        else:
            out = [sep.join(v) for v in state["vals"]]
        return Column.from_pylist(out, String)


class MedianAgg(AggregateFunction):
    """median / quantile (exact, buffered per group — reference:
    aggregates/aggregate_quantile_*.rs family)."""
    name = "median"
    _q = 0.5

    def return_type(self):
        return Float64

    def init_state(self, num_groups):
        return [[[] for _ in range(num_groups)]]

    def update(self, state, group_ids, payload, validity):
        vals = np.asarray(payload, np.float64)
        for i, g in enumerate(group_ids.tolist()):
            if validity is not None and not validity[i]:
                continue
            state[0][g].append(vals[i])

    def finalize(self, state, num_groups):
        out = np.zeros(num_groups, np.float64)
        valid = np.ones(num_groups, np.bool_)
        for g, buf in enumerate(state[0]):
            if buf:
                out[g] = float(np.quantile(np.asarray(buf), self._q))
            else:
                valid[g] = False
        return Column(Float64.wrap_nullable(), out,
                      None if valid.all() else valid)


class Quantile25Agg(MedianAgg):
    name = "quantile_25"
    _q = 0.25


class Quantile75Agg(MedianAgg):
    name = "quantile_75"
    _q = 0.75


class Quantile90Agg(MedianAgg):
    name = "quantile_90"
    _q = 0.9


class Quantile99Agg(MedianAgg):
    name = "quantile_99"
    _q = 0.99


class ArrayAggAgg(AggregateFunction):
    name = "array_agg"

    def return_type(self):
        from ...types import ArrayType, Float64 as _F
        inner = self.arg_types[0].remove_nullable() if self.arg_types else _F
        from ...types import ArrayType
        return ArrayType(inner)

    def init_state(self, num_groups):
        return [[[] for _ in range(num_groups)]]

    def update(self, state, group_ids, payload, validity):
        vals = payload.to_pylist() if isinstance(payload, StringData) \
            else payload.tolist()
        for i, g in enumerate(group_ids.tolist()):
            if validity is not None and not validity[i]:
                continue
            state[0][g].append(vals[i])

    def finalize(self, state, num_groups):
        return Column.from_pylist(state[0], self.return_type())


class _MomentsAgg(AggregateFunction):
    """Central-moment aggregates from raw power sums (reference:
    aggregates/aggregate_kurtosis.rs, aggregate_skewness.rs)."""

    def return_type(self):
        return Float64

    def init_state(self, num_groups):
        return [np.zeros(num_groups, np.float64) for _ in range(4)] + \
            [np.zeros(num_groups, np.int64)]

    def update(self, state, group_ids, payload, validity):
        gids, p = self._mask(group_ids, np.asarray(payload, np.float64), validity)
        acc = p.copy()
        for i in range(4):
            state[i] += np.bincount(gids, weights=acc, minlength=len(state[i]))
            acc *= p
        np.add.at(state[4], gids, 1)

    def merge(self, s1, s2):
        return [a + b for a, b in zip(s1, s2)]

    def _moments(self, state):
        s1, s2, s3, s4, n = state
        with np.errstate(invalid="ignore", divide="ignore"):
            m = s1 / n
            m2 = s2 / n - m ** 2
            m3 = s3 / n - 3 * m * s2 / n + 2 * m ** 3
            m4 = (s4 / n - 4 * m * s3 / n + 6 * m ** 2 * s2 / n - 3 * m ** 4)
        return m2, m3, m4, n


class SkewnessAgg(_MomentsAgg):
    name = "skewness"

    def finalize(self, state, num_groups):
        m2, m3, m4, n = self._moments(state)
        valid = (n >= 2) & (m2 > 0)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = m3 / np.power(np.maximum(m2, 1e-300), 1.5)
        return Column(Float64.wrap_nullable(), np.where(valid, out, 0.0),
                      None if valid.all() else valid)


class KurtosisAgg(_MomentsAgg):
    name = "kurtosis"

    def finalize(self, state, num_groups):
        m2, m3, m4, n = self._moments(state)
        valid = (n >= 2) & (m2 > 0)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = m4 / np.maximum(m2 * m2, 1e-300) - 3.0
        return Column(Float64.wrap_nullable(), np.where(valid, out, 0.0),
                      None if valid.all() else valid)


class _CovarAgg(AggregateFunction):
    """covar_pop/covar_samp/corr over two numeric columns (reference:
    aggregates/aggregate_covariance.rs)."""

    multi_arg = True
    _sample = False
    _corr = False

    def return_type(self):
        return Float64

    def init_state(self, num_groups):
        # sums: x, y, xy, xx, yy, n
        return [np.zeros(num_groups, np.float64) for _ in range(5)] + \
            [np.zeros(num_groups, np.int64)]

    def update_multi(self, state, group_ids, cols):
        x = np.asarray(cols[0].data, np.float64)
        y = np.asarray(cols[1].data, np.float64)
        ok = np.ones(len(x), np.bool_)
        if cols[0].validity is not None:
            ok &= cols[0].validity
        if cols[1].validity is not None:
            ok &= cols[1].validity
        gids = group_ids[ok]
        x, y = x[ok], y[ok]
        g = len(state[0])
        state[0] += np.bincount(gids, weights=x, minlength=g)
        state[1] += np.bincount(gids, weights=y, minlength=g)
        state[2] += np.bincount(gids, weights=x * y, minlength=g)
        state[3] += np.bincount(gids, weights=x * x, minlength=g)
        state[4] += np.bincount(gids, weights=y * y, minlength=g)
        np.add.at(state[5], gids, 1)

    def merge(self, s1, s2):
        return [a + b for a, b in zip(s1, s2)]

    def finalize(self, state, num_groups):
        sx, sy, sxy, sxx, syy, n = state
        with np.errstate(invalid="ignore", divide="ignore"):
            cov = sxy / n - (sx / n) * (sy / n)
            if self._corr:
                vx = sxx / n - (sx / n) ** 2
                vy = syy / n - (sy / n) ** 2
                out = cov / np.sqrt(np.maximum(vx * vy, 1e-300))
                valid = (n >= 1) & (vx > 0) & (vy > 0)
            elif self._sample:
                out = cov * n / np.maximum(n - 1, 1)
                valid = n >= 2
            else:
                out = cov
                valid = n >= 1
        return Column(Float64.wrap_nullable(), np.where(valid, out, 0.0),
                      None if valid.all() else valid)


class CovarPopAgg(_CovarAgg):
    name = "covar_pop"


class CovarSampAgg(_CovarAgg):
    name = "covar_samp"
    _sample = True


class CorrAgg(_CovarAgg):
    name = "corr"
    _corr = True


class _ArgMinMaxAgg(AggregateFunction):
    """arg_min(value, key) / arg_max(value, key): the value of the row
    where key is extremal (reference: aggregates/aggregate_arg_min_max.rs)."""

    multi_arg = True
    _max = False

    def return_type(self):
        return self.arg_types[0].remove_nullable()

    def init_state(self, num_groups):
        # best key per group + chosen value per group
        fill = -np.inf if self._max else np.inf
        return [np.full(num_groups, fill, np.float64), [None] * num_groups]

    def update_multi(self, state, group_ids, cols):
        vals = cols[0].to_pylist()
        keys = np.asarray(cols[1].data, np.float64)
        ok = np.ones(len(keys), np.bool_)
        if cols[0].validity is not None:
            ok &= cols[0].validity
        if cols[1].validity is not None:
            ok &= cols[1].validity
        best, chosen = state
        # per-group vectorized extremum of this batch, then compare-swap
        for i in np.nonzero(ok)[0].tolist():
            g = group_ids[i]
            k = keys[i]
            if (k > best[g]) if self._max else (k < best[g]):
                best[g] = k
                chosen[g] = vals[i]

    def merge(self, s1, s2):
        best = s1[0].copy()
        chosen = list(s1[1])
        take = (s2[0] > s1[0]) if self._max else (s2[0] < s1[0])
        for g in np.nonzero(take)[0].tolist():
            best[g] = s2[0][g]
            chosen[g] = s2[1][g]
        return [best, chosen]

    def finalize(self, state, num_groups):
        return Column.from_pylist(state[1],
                                  self.return_type().wrap_nullable())


class ArgMinAgg(_ArgMinMaxAgg):
    name = "arg_min"


class ArgMaxAgg(_ArgMinMaxAgg):
    name = "arg_max"
    _max = True


class _IfCombinator(AggregateFunction):
    """*_if combinators: sum_if(x, cond) etc. (reference: the IF
    combinator in aggregates/aggregator_common.rs)."""

    multi_arg = True
    _inner_cls: Optional[Type[AggregateFunction]] = None

    def __init__(self, arg_types, distinct=False):
        super().__init__(arg_types, distinct)
        self._inner = self._inner_cls(arg_types[:1] if arg_types else [],
                                      distinct)

    def return_type(self):
        return self._inner.return_type()

    def init_state(self, num_groups):
        return self._inner.init_state(num_groups)

    def update_multi(self, state, group_ids, cols):
        cond_col = cols[-1]
        cond = np.asarray(cond_col.data, np.bool_)
        if cond_col.validity is not None:
            cond = cond & cond_col.validity
        gids = group_ids[cond]
        if len(cols) == 1 or cols[0] is cond_col:
            self._inner.update(state, gids, None, None)
            return
        val = cols[0]
        data = val.data[cond] if isinstance(val.data, np.ndarray) \
            else val.take(np.nonzero(cond)[0]).data
        validity = None if val.validity is None else val.validity[cond]
        self._inner.update(state, gids, data, validity)

    def merge(self, s1, s2):
        return self._inner.merge(s1, s2)

    def finalize(self, state, num_groups):
        return self._inner.finalize(state, num_groups)


class CountIfAgg(_IfCombinator):
    name = "count_if"
    _inner_cls = CountAgg


class SumIfAgg(_IfCombinator):
    name = "sum_if"
    _inner_cls = SumAgg


class AvgIfAgg(_IfCombinator):
    name = "avg_if"
    _inner_cls = AvgAgg


class MinIfAgg(_IfCombinator):
    name = "min_if"
    _inner_cls = MinAgg


class MaxIfAgg(_IfCombinator):
    name = "max_if"
    _inner_cls = MaxAgg


class BoolAndAgg(AggregateFunction):
    name = "bool_and"
    _or = False

    def return_type(self):
        return Boolean

    def init_state(self, num_groups):
        return [np.full(num_groups, not self._or, np.bool_),
                np.zeros(num_groups, np.bool_)]  # (acc, seen)

    def update(self, state, group_ids, payload, validity):
        gids, p = self._mask(group_ids, np.asarray(payload, np.bool_), validity)
        acc, seen = state
        if self._or:
            np.logical_or.at(acc, gids, p)
        else:
            np.logical_and.at(acc, gids, p)
        seen[gids] = True

    def merge(self, s1, s2):
        op = np.logical_or if self._or else np.logical_and
        return [op(s1[0], s2[0]), s1[1] | s2[1]]

    def finalize(self, state, num_groups):
        acc, seen = state
        return Column(Boolean.wrap_nullable(), acc,
                      None if seen.all() else seen)


class BoolOrAgg(BoolAndAgg):
    name = "bool_or"
    _or = True


class _GroupBitAgg(AggregateFunction):
    _op = "or"

    def return_type(self):
        return UInt64

    def init_state(self, num_groups):
        init = {"and": np.uint64(2**64 - 1), "or": np.uint64(0),
                "xor": np.uint64(0)}[self._op]
        return np.full(num_groups, init, np.uint64)

    def update(self, state, group_ids, payload, validity):
        gids, p = self._mask(group_ids,
                             np.asarray(payload).astype(np.uint64), validity)
        ufunc = {"and": np.bitwise_and, "or": np.bitwise_or,
                 "xor": np.bitwise_xor}[self._op]
        ufunc.at(state, gids, p)

    def merge(self, s1, s2):
        ufunc = {"and": np.bitwise_and, "or": np.bitwise_or,
                 "xor": np.bitwise_xor}[self._op]
        return ufunc(s1, s2)

    def finalize(self, state, num_groups):
        return Column.from_numpy(state, UInt64)


class GroupBitAndAgg(_GroupBitAgg):
    name = "group_bit_and"
    _op = "and"


class GroupBitOrAgg(_GroupBitAgg):
    name = "group_bit_or"
    _op = "or"


class GroupBitXorAgg(_GroupBitAgg):
    name = "group_bit_xor"
    _op = "xor"


class HistogramAgg(AggregateFunction):
    """histogram(x): equi-height buckets as a JSON string (reference:
    aggregates/aggregate_histogram.rs — returns bucket list)."""

    name = "histogram"
    _buckets = 8

    def return_type(self):
        return String

    def init_state(self, num_groups):
        return [[[] for _ in range(num_groups)]]

    def update(self, state, group_ids, payload, validity):
        vals = np.asarray(payload, np.float64)
        for i, g in enumerate(group_ids.tolist()):
            if validity is not None and not validity[i]:
                continue
            state[0][g].append(vals[i])

    def merge(self, s1, s2):
        return [[a + b for a, b in zip(s1[0], s2[0])]]

    def finalize(self, state, num_groups):
        import json as _json
        out = []
        for buf in state[0]:
            if not buf:
                out.append(None)
                continue
            arr = np.sort(np.asarray(buf))
            nb = min(self._buckets, len(arr))
            edges = np.quantile(arr, np.linspace(0, 1, nb + 1))
            buckets = []
            for b in range(nb):
                lo, hi = float(edges[b]), float(edges[b + 1])
                cnt = int(np.count_nonzero((arr >= lo) & (
                    arr <= hi if b == nb - 1 else arr < hi)))
                buckets.append({"lower": lo, "upper": hi, "count": cnt})
            out.append(_json.dumps(buckets))
        return Column.from_pylist(out, String.wrap_nullable())


class RetentionAgg(AggregateFunction):
    """retention(cond1, cond2, ...): per group, [c1, c1&c2, c1&c3, ...]
    (reference: aggregates/aggregate_retention.rs)."""

    multi_arg = True

    name = "retention"

    def return_type(self):
        from ...types import ArrayType, UInt8
        return ArrayType(UInt8)

    def init_state(self, num_groups):
        return [np.zeros((num_groups, max(len(self.arg_types), 1)), np.bool_)]

    def update_multi(self, state, group_ids, cols):
        acc = state[0]
        for j, c in enumerate(cols):
            v = np.asarray(c.data, np.bool_)
            if c.validity is not None:
                v = v & c.validity
            np.logical_or.at(acc[:, j], group_ids[v], True)

    def merge(self, s1, s2):
        return [s1[0] | s2[0]]

    def finalize(self, state, num_groups):
        acc = state[0]
        first = acc[:, :1]
        rows = (acc & first).astype(np.uint8)
        rows[:, 0] = acc[:, 0].astype(np.uint8)
        return Column.from_pylist([r.tolist() for r in rows],
                                  self.return_type())


AGGREGATE_FUNCTIONS: Dict[str, Type[AggregateFunction]] = {
    "skewness": SkewnessAgg,
    "kurtosis": KurtosisAgg,
    "covar_pop": CovarPopAgg,
    "covar_samp": CovarSampAgg,
    "corr": CorrAgg,
    "arg_min": ArgMinAgg,
    "arg_max": ArgMaxAgg,
    "count_if": CountIfAgg,
    "sum_if": SumIfAgg,
    "avg_if": AvgIfAgg,
    "min_if": MinIfAgg,
    "max_if": MaxIfAgg,
    "bool_and": BoolAndAgg,
    "every": BoolAndAgg,
    "bool_or": BoolOrAgg,
    "group_bit_and": GroupBitAndAgg,
    "group_bit_or": GroupBitOrAgg,
    "group_bit_xor": GroupBitXorAgg,
    "histogram": HistogramAgg,
    "retention": RetentionAgg,
    "median": MedianAgg,
    "quantile": MedianAgg,
    "quantile_25": Quantile25Agg,
    "quantile_75": Quantile75Agg,
    "quantile_90": Quantile90Agg,
    "quantile_99": Quantile99Agg,
    "array_agg": ArrayAggAgg,
    "list": ArrayAggAgg,
    "count": CountAgg,
    "sum": SumAgg,
    "avg": AvgAgg,
    "min": MinAgg,
    "max": MaxAgg,
    "any": AnyAgg,
    "count_distinct": CountDistinctAgg,
    "approx_count_distinct": CountDistinctAgg,
    "var_pop": VarPopAgg,
    "variance": VarPopAgg,
    "var_samp": VarSampAgg,
    "stddev_pop": StddevPopAgg,
    "stddev": StddevPopAgg,
    "std": StddevPopAgg,
    "stddev_samp": StddevSampAgg,
    "string_agg": StringAggAgg,
    "group_concat": StringAggAgg,
    "listagg": StringAggAgg,
}


def is_aggregate_function(name: str) -> bool:
    return name.lower() in AGGREGATE_FUNCTIONS


class _DistinctCombinator(AggregateFunction):
    """agg(DISTINCT x): dedup (group, value) pairs, then replay into the
    inner aggregate at finalize (reference: the DISTINCT combinator,
    aggregates/aggregate_combinator_distinct.rs)."""

    def __init__(self, inner: AggregateFunction):
        self._inner = inner
        self.arg_types = inner.arg_types
        self.name = inner.name + "_distinct"
        self.distinct = True

    def return_type(self):
        return self._inner.return_type()

    def init_state(self, num_groups):
        return {"n": num_groups, "g": [], "v": [], "obj": set()}

    def update(self, state, group_ids, payload, validity):
        g = np.asarray(group_ids, np.int64)
        if not isinstance(payload, StringData):
            arr = np.asarray(payload)
            if arr.dtype.kind in "iufb":
                if validity is not None:
                    keep = np.asarray(validity, bool)
                    g, arr = g[keep], arr[keep]
                if len(g):
                    order = np.lexsort((arr, g))
                    gs, vs = g[order], arr[order]
                    k = np.ones(len(gs), np.bool_)
                    k[1:] = (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1])
                    state["g"].append(gs[k])
                    state["v"].append(vs[k])
                return
        vals = payload.to_pylist() if isinstance(payload, StringData) \
            else np.asarray(payload).tolist()
        for i, gid in enumerate(g.tolist()):
            if validity is not None and not validity[i]:
                continue
            state["obj"].add((gid, vals[i]))

    def merge(self, s1, s2):
        return {"n": max(s1["n"], s2["n"]), "g": s1["g"] + s2["g"],
                "v": s1["v"] + s2["v"], "obj": s1["obj"] | s2["obj"]}

    def finalize(self, state, num_groups):
        inner_state = self._inner.init_state(num_groups)
        if state["g"]:
            g = np.concatenate(state["g"])
            v = np.concatenate(state["v"])
            order = np.lexsort((v, g))
            gs, vs = g[order], v[order]
            k = np.ones(len(gs), np.bool_)
            k[1:] = (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1])
            self._inner.update(inner_state, gs[k], vs[k], None)
        if state["obj"]:
            pairs = sorted(state["obj"], key=lambda t: t[0])
            gids = np.array([p[0] for p in pairs], np.int64)
            vals = np.array([p[1] for p in pairs], dtype=object)
            self._inner.update(inner_state, gids, vals, None)
        return self._inner.finalize(inner_state, num_groups)


def create_aggregate(name: str, arg_types: List[DataType],
                     distinct: bool = False) -> AggregateFunction:
    key = name.lower()
    if key == "count" and distinct:
        key = "count_distinct"
        distinct = False
    if key not in AGGREGATE_FUNCTIONS:
        raise UnknownFunction(f"unknown aggregate function {name!r}")
    fn = AGGREGATE_FUNCTIONS[key](arg_types, distinct)
    if distinct and not getattr(fn, "multi_arg", False) \
            and key not in ("count_distinct", "min", "max", "any",
                            "bool_and", "bool_or"):
        return _DistinctCombinator(fn)
    return fn
