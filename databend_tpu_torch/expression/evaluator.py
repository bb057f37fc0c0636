"""Expression evaluator: ScalarExpr over DataBlock -> Column.

Analog of the reference's ``Evaluator``
(reference: src/query/expression/src/evaluator.rs). Vectorized numpy on the
host; vector-distance kernels inside expressions route to jitted TPU ops for
large blocks (see functions/vector_fns.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..errors import BadDataValueType, SemanticError
from ..types import (ArrayType, Boolean, DataType, Date, Float64, Int64,
                     NullType, NumberType, String, StringType, Timestamp,
                     VectorType)
from .block import DataBlock
from .column import Column, StringData
from .expr import BoundColumn, CaseExpr, CastExpr, Constant, Func, ScalarExpr
from .functions import registry


class Evaluator:
    def __init__(self, block: DataBlock):
        self.block = block

    def run(self, expr: ScalarExpr) -> Column:
        n = self.block.num_rows
        if isinstance(expr, BoundColumn):
            return self.block.column(expr.name)
        if isinstance(expr, Constant):
            return constant_column(expr.value, expr.dtype, n)
        from .expr import DictGet, SequenceNext
        if isinstance(expr, SequenceNext):  # volatile: before const folding
            vals = expr.allocator(n)
            return Column(expr.dtype.remove_nullable(),
                          vals.astype(expr.dtype.remove_nullable().numpy_dtype()))
        if isinstance(expr, DictGet):
            key_col = self.run(expr.key)
            keys = key_col.to_pylist()
            vals = [expr.mapping.get(k) for k in keys]
            return Column.from_pylist(vals, expr.dtype)
        # constant folding: a column-free subtree evaluates once on one row
        # and broadcasts (reference: constant folding in the evaluator /
        # optimizer), instead of materializing n copies of the constant
        if n > 1 and _is_column_free(expr):
            one = Evaluator(DataBlock([], [], 1)).run(expr)
            return constant_column(one.get(0), one.dtype, n)
        if isinstance(expr, CastExpr):
            return cast_column(self.run(expr.arg), expr.dtype, expr.is_try)
        if isinstance(expr, CaseExpr):
            return self._run_case(expr)
        from .expr import ArrayLambda
        if isinstance(expr, ArrayLambda):
            return self._run_array_lambda(expr)
        if isinstance(expr, Func):
            return self._run_func(expr)
        raise SemanticError(f"cannot evaluate {type(expr).__name__}")

    def _run_func(self, expr: Func) -> Column:
        if expr.name in ("and", "or") and len(expr.args) == 2 \
            and not (isinstance(expr.args[1], (Constant, BoundColumn))
                     or _is_column_free(expr.args[1])):
            return self._run_logical(expr)
        fn = registry.get(expr.name)
        if expr.name == "in_set" and len(expr.args) == 2 \
                and isinstance(expr.args[1], Constant):
            # the kernel reads the constant IN-list from row 0 only —
            # build it once instead of physically broadcasting a 150k-key
            # list to every input row (TPC-H q18/q20 IN-subquery folds)
            args = [self.run(expr.args[0]),
                    constant_column(expr.args[1].value,
                                    expr.args[1].dtype, 1)]
        else:
            args = [self.run(a) for a in expr.args]
        n = self.block.num_rows
        arg_types = [a.dtype for a in args]
        if fn.null_policy == "custom":
            payloads = [a.data for a in args]
            validities = [a.validity for a in args]
            payload, validity = fn.kernel(payloads, validities,
                                          arg_types=arg_types, n_rows=n)
            return Column(expr.dtype.remove_nullable(), payload, validity)
        # propagate: AND of validities, kernel sees payloads only
        validity = None
        for a in args:
            if a.validity is not None:
                validity = a.validity if validity is None else (validity & a.validity)
        payload = fn.kernel(*[a.data for a in args], arg_types=arg_types,
                            out_dtype=expr.dtype.remove_nullable(), n_rows=n)
        return Column(expr.dtype.remove_nullable(), payload,
                      validity.copy() if validity is not None else None)

    def _run_array_lambda(self, expr) -> Column:
        """Evaluate array_map/filter/fold/count/any/all: flatten every
        row's elements into ONE element block (outer columns repeated per
        element so closures resolve), run the lambda body vectorized over
        it, then regroup per row (reference: array lambda kernels)."""
        import json as _json
        from ..types import VariantType
        arr_col = self.run(expr.arr)
        lists = arr_col.to_pylist()
        is_variant = isinstance(expr.arr.dtype.remove_nullable(),
                                VariantType)
        parsed = []
        for x in lists:
            if is_variant and isinstance(x, (str, bytes)):
                try:
                    x = _json.loads(x)
                except Exception:
                    x = None
            parsed.append(x if isinstance(x, (list, tuple)) else None)
        n = self.block.num_rows

        if expr.kind == "fold":
            init_col = self.run(expr.init)
            accs = init_col.to_pylist()
            out = []
            acc_t = init_col.dtype.wrap_nullable()
            for i, xs in enumerate(parsed):
                if xs is None:
                    out.append(None)
                    continue
                acc = accs[i]
                row = self.block.slice(i, i + 1)
                for v in xs:
                    b = DataBlock(
                        row.names + list(expr.param_cols),
                        row.columns + [
                            Column.from_pylist([acc], acc_t),
                            Column.from_pylist([v], expr.elem_dtype)],
                        1)
                    acc = Evaluator(b).run(expr.body).get(0)
                out.append(acc)
            return Column.from_pylist(out, expr.dtype)

        counts = np.array([len(x) if x is not None else 0 for x in parsed],
                          np.int64)
        idx = np.repeat(np.arange(n, dtype=np.int64), counts)
        elems = [v for x in parsed if x is not None for v in x]
        if is_variant:
            elems = [None if v is None else
                     _json.dumps(v, separators=(",", ":"), default=str)
                     for v in elems]
        base = self.block.take(idx) if len(idx) else DataBlock(
            self.block.names, [c.slice(0, 0) for c in self.block.columns], 0)
        eb = DataBlock(base.names + [expr.param_cols[0]],
                       base.columns + [Column.from_pylist(elems,
                                                          expr.elem_dtype)],
                       len(elems))
        res = Evaluator(eb).run(expr.body).to_pylist() if len(elems) \
            else []
        # regroup by row
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        out = []
        for i, xs in enumerate(parsed):
            if xs is None:
                out.append(None)
                continue
            seg = res[offs[i]:offs[i + 1]]
            if expr.kind == "map":
                out.append(list(seg))
            elif expr.kind == "filter":
                out.append([v for v, keep in zip(xs, seg) if keep])
            elif expr.kind == "count":
                out.append(sum(1 for s in seg if s))
            elif expr.kind == "any":
                out.append(any(bool(s) for s in seg))
            else:  # all
                out.append(all(bool(s) for s in seg))
        if expr.kind == "filter" and is_variant:
            out = [None if x is None else
                   _json.dumps(x, separators=(",", ":"), default=str)
                   for x in out]
        return Column.from_pylist(out, expr.dtype)

    def _run_logical(self, expr: Func) -> Column:
        """Short-circuit AND/OR: the right side only ever sees the rows
        the left side did not decide (reference filter selectivity —
        `a = 1 AND cast(b AS int) > 2` must not raise on rows where
        a != 1), with standard three-valued NULL semantics."""
        n = self.block.num_rows
        a = self.run(expr.args[0])
        ad = np.asarray(a.data, np.bool_)
        a_valid = a.validity if a.validity is not None \
            else np.ones(n, np.bool_)
        a_true = ad & a_valid
        a_false = ~ad & a_valid
        # rows the left side already decides
        decided = a_false if expr.name == "and" else a_true
        b_true = np.zeros(n, np.bool_)
        b_false = np.zeros(n, np.bool_)
        need = ~decided
        if need.any():
            if need.all():
                b = self.run(expr.args[1])
            else:
                sub = Evaluator(self.block.filter(need)).run(expr.args[1])
                pos = np.cumsum(need) - 1
                b = sub.take(np.where(need, pos, 0))
            bd = np.asarray(b.data, np.bool_)
            b_valid = b.validity if b.validity is not None \
                else np.ones(n, np.bool_)
            b_true = bd & b_valid & need
            b_false = ~bd & b_valid & need
        if expr.name == "and":
            data = a_true & b_true
            valid = a_false | b_false | (a_true & b_true)
        else:
            data = a_true | b_true
            valid = a_true | b_true | (a_false & b_false)
        return Column(Boolean, data, None if valid.all() else valid)

    def _run_case(self, expr: CaseExpr) -> Column:
        """CASE with masked branch evaluation: each THEN/ELSE expression
        only ever sees the rows its guard selects (reference if_then_else
        selection-vector semantics) — `CASE WHEN d > 0 THEN x/d END` must
        not raise for rows where d = 0."""
        n = self.block.num_rows
        target = expr.dtype
        acc = Column(target.remove_nullable(),
                     constant_column(None, target.wrap_nullable(), n).data,
                     np.zeros(n, np.bool_))
        decided = np.zeros(n, np.bool_)
        for cond_e, res_e in zip(expr.conditions, expr.results):
            cond = self.run(cond_e)
            mask = np.asarray(cond.data, np.bool_).copy()
            if cond.validity is not None:
                mask &= cond.validity
            mask &= ~decided
            if not mask.any():
                continue
            acc = self._case_fill(acc, mask, res_e, target)
            decided |= mask
        if expr.else_result is not None and not decided.all():
            acc = self._case_fill(acc, ~decided, expr.else_result, target)
        return acc

    def _case_fill(self, acc: Column, mask: np.ndarray, res_e,
                   target) -> Column:
        """acc[mask] = eval(res_e) over only the masked rows."""
        if mask.all():
            return cast_column(self.run(res_e), target, False)
        sub = Evaluator(self.block.filter(mask)).run(res_e)
        sub = cast_column(sub, target, False)
        pos = np.cumsum(mask) - 1          # row -> its index within sub
        up = sub.take(np.where(mask, pos, 0))
        return _select_columns(mask, up, acc)


def _select_columns(mask: np.ndarray, a: Column, b: Column) -> Column:
    """where(mask, a, b) preserving validity."""
    va = a.validity if a.validity is not None else np.ones(len(mask), np.bool_)
    vb = b.validity if b.validity is not None else np.ones(len(mask), np.bool_)
    validity = np.where(mask, va, vb)
    if isinstance(a.data, StringData) or isinstance(b.data, StringData):
        al, bl = a.to_pylist(), b.to_pylist()
        vals = [x if m else y for m, x, y in zip(mask, al, bl)]
        payload = StringData.from_pylist(vals)
    elif isinstance(a.data, np.ndarray) and a.data.ndim == 2:
        payload = np.where(mask[:, None], a.data, b.data)
    elif isinstance(a.data, tuple):
        vals = [x if m else y for m, x, y in zip(mask, a.to_pylist(), b.to_pylist())]
        return Column.from_pylist(vals, a.dtype.wrap_nullable() if not validity.all() else a.dtype)
    else:
        payload = np.where(mask, a.data, b.data)
    return Column(a.dtype.remove_nullable(), payload,
                  None if validity.all() else validity)


def constant_column(value, dtype: DataType, n: int) -> Column:
    from ..types import GeometryType as _GT
    from ..types import VariantType as _VarT
    inner = dtype.remove_nullable()
    if value is None:
        string_like = isinstance(inner, (StringType, _VarT, _GT))
        z = np.zeros(n, inner.numpy_dtype()) if not (string_like or isinstance(inner, ArrayType)) \
            else (StringData.from_pylist([""] * n) if string_like
                  else (np.zeros(n + 1, np.int64), Column.from_pylist([], Int64)))
        if isinstance(inner, VectorType):
            z = np.zeros((n, inner.dim), inner.numpy_dtype())
        return Column(inner, z, np.zeros(n, np.bool_))
    if isinstance(inner, StringType):
        return Column(inner, StringData.constant(str(value), n))
    if isinstance(inner, VectorType):
        row = np.asarray(value, dtype=inner.numpy_dtype())
        if row.shape != (inner.dim,):
            raise BadDataValueType(f"vector constant dim {row.shape} != {inner.dim}")
        return Column(inner, np.broadcast_to(row, (n, inner.dim)).copy())
    if isinstance(inner, ArrayType):
        return Column.from_pylist([value] * n, inner)
    from ..types import MapType as _MT, TupleType as _TT
    if isinstance(inner, (_MT, _TT)):
        return Column.from_pylist([value] * n, inner)
    arr = np.full(n, value, dtype=inner.numpy_dtype())
    return Column(inner, arr)


def infer_literal_type(value) -> DataType:
    if value is None:
        return NullType()
    if isinstance(value, bool):
        return Boolean
    if isinstance(value, int):
        return Int64
    if isinstance(value, float):
        return Float64
    if isinstance(value, str):
        return String
    if isinstance(value, dict):
        from ..types import MapType as _MT
        kt = infer_literal_type(next(iter(value))) if value else String
        vt = infer_literal_type(next(iter(value.values()))) if value \
            else String
        return _MT(kt, vt)
    if isinstance(value, tuple):
        from ..types import TupleType as _TT
        return _TT(tuple(infer_literal_type(v) for v in value))
    if isinstance(value, (list, tuple)):
        if value and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in value):
            return ArrayType(Float64)
        return ArrayType(infer_literal_type(value[0]) if value else Int64)
    raise BadDataValueType(f"cannot infer literal type of {value!r}")


def cast_column(col: Column, target: DataType, is_try: bool) -> Column:
    src = col.dtype.remove_nullable()
    dst = target.remove_nullable()
    validity = col.validity
    if src == dst:
        if target.is_nullable() and validity is None:
            return Column(dst, col.data, np.ones(len(col), np.bool_))
        return Column(dst, col.data, validity)
    n = len(col)

    def out(payload, extra_valid: Optional[np.ndarray] = None):
        v = validity
        if extra_valid is not None:
            v = extra_valid if v is None else (v & extra_valid)
            if v.all():
                v = None
        return Column(dst, payload, v)

    # decimal casts (exact python Decimal payloads)
    from ..types import DecimalType
    if isinstance(dst, DecimalType):
        import decimal
        quantum = dst.quantum()
        if isinstance(src, StringType):
            vals = col.data.to_pylist()
        elif isinstance(src, (NumberType, DecimalType)) or src == Boolean:
            vals = col.data.tolist()
        else:
            raise BadDataValueType(f"cannot cast {src} to {dst}")
        payload = np.empty(n, object)
        ok = np.ones(n, np.bool_)
        with decimal.localcontext() as dctx:
            dctx.prec = max(dst.precision + dst.scale + 4, 80)
            for i, v in enumerate(vals):
                if validity is not None and not validity[i]:
                    payload[i] = decimal.Decimal(0)
                    continue
                try:
                    d = decimal.Decimal(str(v)).quantize(
                        quantum, rounding=decimal.ROUND_HALF_UP)
                    if len(d.as_tuple().digits) > dst.precision:
                        raise decimal.InvalidOperation("Decimal overflow")
                    payload[i] = d
                except (decimal.InvalidOperation, ValueError, TypeError):
                    if not is_try:
                        raise BadDataValueType(
                            f"cannot cast {v!r} to {dst}")
                    payload[i] = decimal.Decimal(0)
                    ok[i] = False
        return out(payload, ok if not ok.all() else None)
    if isinstance(src, DecimalType):
        if isinstance(dst, NumberType):
            arr = np.asarray([float(v) for v in col.data.tolist()],
                             np.float64)
            return out(arr.astype(dst.numpy_dtype()))
        # decimal -> string handled by the generic string arm below

    # numeric <-> numeric / bool
    if (isinstance(src, NumberType) or src == Boolean or src in (Date, Timestamp)) and \
       (isinstance(dst, NumberType) or dst == Boolean or dst in (Date, Timestamp)):
        return out(col.data.astype(dst.numpy_dtype()))
    # string -> numeric
    if isinstance(src, StringType) and isinstance(dst, NumberType):
        vals = col.data.to_pylist()
        payload = np.zeros(n, dst.numpy_dtype())
        ok = np.ones(n, np.bool_)
        for i, s in enumerate(vals):
            if validity is not None and not validity[i]:
                continue
            try:
                payload[i] = float(s) if dst.is_float() else int(float(s))
            except (ValueError, TypeError):
                if not is_try:
                    raise BadDataValueType(f"cannot cast {s!r} to {dst}")
                ok[i] = False
        return out(payload, ok if not ok.all() else None)
    # string -> boolean
    if isinstance(src, StringType) and dst == Boolean:
        vals = [s.strip().lower() in ("1", "true", "t", "yes") for s in col.data.to_pylist()]
        return out(np.asarray(vals, np.bool_))
    # variant -> string: JSON strings unquote, other values keep their
    # canonical text; JSON null -> NULL (reference to_string(variant))
    from ..types import VariantType as _VTs
    if isinstance(src, _VTs) and isinstance(dst, StringType):
        import json as _json
        vals = col.to_pylist()
        texts = []
        ok = np.ones(n, np.bool_)
        for i, s in enumerate(vals):
            if s is None:
                texts.append("")
                ok[i] = False
                continue
            try:
                v = _json.loads(s) if isinstance(s, (str, bytes)) else s
            except (ValueError, TypeError):
                v = s
            if v is None:
                texts.append("")
                ok[i] = False
            elif isinstance(v, str):
                texts.append(v)
            else:
                texts.append(s if isinstance(s, str) else _to_str(v))
        return out(StringData.from_pylist(texts), ok if not ok.all() else None)
    # anything -> string
    if isinstance(dst, StringType):
        if src in (Date, Timestamp):
            import datetime as _dt
            ep_d = _dt.date(1970, 1, 1)
            ep_t = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
            vals = np.asarray(col.data, np.int64)
            if src == Date:
                texts = [str(ep_d + _dt.timedelta(days=int(v)))
                         for v in vals]
            else:
                texts = [(ep_t + _dt.timedelta(microseconds=int(v)))
                         .strftime("%Y-%m-%d %H:%M:%S.%f") for v in vals]
            return out(StringData.from_pylist(texts))
        return out(StringData.from_pylist([_to_str(v) for v in col.to_pylist()]))
    # string -> date/timestamp (TRY_CAST of malformed text -> NULL,
    # plain CAST raises a typed error — reference cast semantics)
    if isinstance(src, StringType) and dst in (Date, Timestamp):
        import datetime as _dt
        epoch = _dt.date(1970, 1, 1)
        vals = col.data.to_pylist()
        payload = np.zeros(n, dst.numpy_dtype())
        ok = np.ones(n, np.bool_)
        for i, s in enumerate(vals):
            if validity is not None and not validity[i]:
                continue
            try:
                if str(s).startswith("0000-00-00"):
                    payload[i] = 0  # zero date maps to the epoch
                elif dst == Date:
                    payload[i] = (_dt.date.fromisoformat(str(s)[:10])
                                  - epoch).days
                else:
                    ts = _dt.datetime.fromisoformat(str(s))
                    if ts.tzinfo is None:
                        ts = ts.replace(tzinfo=_dt.timezone.utc)
                    payload[i] = int(ts.timestamp() * 1_000_000)
            except (ValueError, TypeError):
                if not is_try:
                    raise BadDataValueType(f"cannot cast {s!r} to {dst}")
                ok[i] = False
        return out(payload, ok if not ok.all() else None)
    # array -> vector (INSERT [..] INTO VECTOR(n))
    if isinstance(src, ArrayType) and isinstance(dst, VectorType):
        lists = col.to_pylist()
        payload = np.zeros((n, dst.dim), dst.numpy_dtype())
        ok = np.ones(n, np.bool_)
        for i, v in enumerate(lists):
            if v is None:
                ok[i] = False
                continue
            a = np.asarray(v, dtype=dst.numpy_dtype())
            if a.shape != (dst.dim,):
                if is_try:
                    ok[i] = False
                    continue
                raise BadDataValueType(
                    f"cannot cast array of length {a.shape[0]} to VECTOR({dst.dim})")
            payload[i] = a
        return out(payload, ok if not ok.all() else None)
    # vector -> array
    if isinstance(src, VectorType) and isinstance(dst, ArrayType):
        return Column.from_pylist([row.tolist() for row in col.data],
                                  target if target.is_nullable() else dst)
    # variant -> number/boolean (JSON scalar coercion)
    from ..types import VariantType as _VT
    if isinstance(src, _VT) and (isinstance(dst, NumberType)
                                 or dst == Boolean):
        import json as _json
        vals = col.to_pylist()
        payload = np.zeros(n, dst.numpy_dtype())
        ok = np.ones(n, np.bool_)
        for i, s in enumerate(vals):
            if validity is not None and not validity[i]:
                continue
            try:
                v = _json.loads(s) if isinstance(s, (str, bytes)) else s
                if v is None or isinstance(v, (list, dict)):
                    raise ValueError(v)
                if dst == Boolean:
                    payload[i] = bool(v)
                elif dst.is_float():
                    payload[i] = float(v)
                else:
                    payload[i] = int(float(v))
            except (ValueError, TypeError):
                if not is_try:
                    raise BadDataValueType(f"cannot cast {s!r} to {dst}")
                ok[i] = False
        return out(payload, ok if not ok.all() else None)
    if isinstance(src, NullType):
        return constant_column(None, dst.wrap_nullable(), n)
    # number/boolean/string -> variant: JSON-encode each scalar
    # (reference: to_variant / implicit ::VARIANT casts)
    from ..types import TupleType as _TT
    if isinstance(dst, _VT) and isinstance(src, _TT):
        # tuple -> variant: JSON object keyed by the tuple field names
        import json as _json
        names = src.names or tuple(str(i + 1)
                                   for i in range(len(src.fields)))
        texts = [None if v is None
                 else _json.dumps(dict(zip(names, v)), default=str,
                                  separators=(",", ":"),
                                  ensure_ascii=False)
                 for v in col.to_pylist()]
        return Column.from_pylist(texts, target if target.is_nullable()
                                   else dst)
    if isinstance(dst, _VT) and (isinstance(src, NumberType)
                                 or src == Boolean or src == String):
        import json as _json
        vals = col.to_pylist()
        if src == String:
            # string -> variant PARSES the text as (lenient) JSON
            # ('"a"'::VARIANT is the string a, not a re-quoted literal)
            from .functions.variant_fns import _lenient_json
            texts = []
            for v in vals:
                if v is None:
                    texts.append(None)
                    continue
                try:
                    parsed = _json.loads(v)
                except (ValueError, TypeError):
                    try:
                        parsed = _lenient_json(v)
                    except (ValueError, TypeError):
                        parsed = v  # not JSON: a JSON string value
                texts.append(_json.dumps(parsed, separators=(",", ":"),
                                         ensure_ascii=False))
        else:
            texts = [None if v is None
                     else _json.dumps(v if not isinstance(v, (np.integer,
                                                              np.floating,
                                                              np.bool_))
                                      else v.item(), separators=(",", ":"),
                                      ensure_ascii=False)
                     for v in vals]
        return Column.from_pylist(texts, target if target.is_nullable()
                                   else dst)
    # a statically impossible cast is a type error (reference raises
    # SemanticError 1065), unlike per-value cast failures (1010)
    from ..errors import SemanticError
    raise SemanticError(f"unsupported cast {src} -> {dst}")


def _to_str(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    if isinstance(v, (list, np.ndarray)):
        return "[" + ",".join(_to_str(x) for x in v) + "]"
    return str(v)


def _is_column_free(e: ScalarExpr) -> bool:
    """True when no BoundColumn (and no per-row volatile fn) appears."""
    from .expr import ArrayLambda as _AL, BoundColumn as _BC, Func as _F
    for x in e.walk():
        if isinstance(x, _BC):
            return False
        if isinstance(x, _F) and x.name in ("rand", "random", "uuid",
                                            "gen_random_uuid"):
            return False
        if isinstance(x, _AL):
            # the body may close over outer columns (they are not in
            # children(), which feeds column-pruning walks)
            for b in x.body.walk():
                if isinstance(b, _BC) and b.name not in x.param_cols:
                    return False
    return True
