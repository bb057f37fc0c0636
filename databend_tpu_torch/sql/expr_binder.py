"""Expression binder: AST Expr -> typed ScalarExpr.

Analog of the reference's TypeChecker (reference:
src/query/sql/src/planner/semantic/type_check/mod.rs). Operator tokens map
to registry function names; literal types are inferred; implicit casts are
inserted for mixed-type comparisons and function argument coercion.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..errors import SemanticError, UnknownColumn, UnknownFunction
from ..expression.evaluator import infer_literal_type
from ..expression.expr import (BoundColumn, CaseExpr, CastExpr, Constant,
                               Func, ScalarExpr)
from ..expression.functions import registry
from ..expression.functions.aggregates import is_aggregate_function
from ..types import (ArrayType, Boolean, DataType, Float64, NullType,
                     NumberType, String, StringType, VectorType,
                     common_super_type, parse_type_name)
from . import ast as A

_BINOP_FN = {
    "+": "plus", "-": "minus", "*": "multiply", "/": "divide", "%": "modulo",
    "&": "bit_and", "|": "bit_or", "^": "pow", "#": "bit_xor",
    "<<": "bit_shift_left", ">>": "bit_shift_right", "DIV": "div",
    "//": "div",
    "=": "eq", "==": "eq", "!=": "noteq", "<>": "noteq", "<": "lt",
    "<=": "lte", ">": "gt", ">=": "gte", "<=>": "eq_null_safe",
    "AND": "and", "OR": "or", "XOR": "xor",
    "LIKE": "like", "ILIKE": "ilike", "REGEXP": "regexp", "RLIKE": "regexp",
    "||": "concat",
    "->": "json_get", "->>": "json_get_text",
}

_CMP_FNS = {"eq", "noteq", "lt", "lte", "gt", "gte"}


def _fold_const(expr):
    """Evaluate a column-free expression to a Constant (map/tuple
    literals with cast'd elements: {'k': 'v'::string})."""
    if isinstance(expr, Constant):
        return expr
    try:
        from ..expression.evaluator import Evaluator, _is_column_free
        if not _is_column_free(expr):
            return expr
        from ..expression import Column as _C, DataBlock as _DB
        import numpy as _np
        blk = _DB(["__one"], [_C.from_numpy(_np.zeros(1, _np.int8))], 1)
        col = Evaluator(blk).run(expr)
        return Constant(col.get(0), col.dtype)
    except Exception:
        return expr


def _fold_negate(arg):
    """-<numeric constant> folds to a literal with the minimal signed
    type (reference: unary minus constant-folds before type inference,
    so typeof(-to_uint32(1)) is TINYINT). Casts over constants unwrap."""
    from ..types import Int8, Int16, Int32, Int64
    from ..types.datatype import NumberType
    e = arg
    while isinstance(e, CastExpr) \
            and isinstance(e.dtype.remove_nullable(), NumberType):
        e = e.arg
    if not isinstance(e, Constant) or isinstance(e.value, bool) \
            or not isinstance(e.value, (int, float)):
        return None
    inner = arg.dtype.remove_nullable()
    if not isinstance(inner, NumberType):
        return None
    v = -e.value
    if isinstance(v, float) or inner.kind.startswith("f"):
        return Constant(-float(e.value), inner if inner.kind.startswith("f")
                        else Float64)
    for kind, ty in (("i8", Int8), ("i16", Int16), ("i32", Int32)):
        lo = -(1 << (int(kind[1:]) - 1))
        if lo <= v < -lo:
            return Constant(int(v), ty)
    return Constant(int(v), Int64)

# to_<type>(x) cast-sugar family (reference: to_* conversion functions);
# resolved lazily to avoid import-order issues
def _build_to_cast():
    from ..types import (Boolean, Date, Float32, Float64, Int8, Int16, Int32,
                         Int64, String, Timestamp, UInt8, UInt16, UInt32,
                         UInt64, Variant)
    return {
        "to_variant": Variant,
        "to_int8": Int8, "to_int16": Int16, "to_int32": Int32,
        "to_int64": Int64, "to_uint8": UInt8, "to_uint16": UInt16,
        "to_uint32": UInt32, "to_uint64": UInt64, "to_float32": Float32,
        "to_float64": Float64, "to_boolean": Boolean, "to_text": String,
        "to_varchar": String,
    }


_TO_CAST = _build_to_cast()


class BindContext:
    """Column scope: ordered (name, dtype, table-alias, output_name) tuples.

    ``output_name`` is the physical column name in the operator's output
    block — it differs from ``name`` when a join has the same column name
    on both sides (disambiguated as ``alias.name``)."""

    def __init__(self):
        self.columns: List[tuple] = []  # (name, dtype, table, out_name)
        # JOIN ... USING(c): out_names excluded from SELECT * expansion
        # (the using column appears once) and the preferred out_name an
        # unqualified reference to `c` resolves to (the kept side)
        self.star_hidden: set = set()
        self.using_pref: dict = {}
        # (db, table) pairs addressable as db.table.column (un-aliased
        # base tables only)
        self.db_quals: set = set()
        # variant virtual columns of the scanned base table (EE):
        # (alias, source_col, path_tuple) -> (vc_name, scan_plan)
        # — populated by the binder when the snapshot registers extracted
        # paths (reference binder/virtual_column.rs rewrite); single-table
        # scans only (joins fall back to plain get())
        self.virtual_map: dict = {}

    def add(self, name: str, dtype: DataType, table: Optional[str] = None,
            out_name: Optional[str] = None):
        self.columns.append((name, dtype, table, out_name or name))

    def has(self, name: str, table: Optional[str] = None) -> bool:
        try:
            self.resolve(name, table)
            return True
        except Exception:
            return False

    def resolve(self, name: str, table: Optional[str] = None) -> BoundColumn:
        if name.startswith("$") and name[1:].isdigit():
            # positional column reference $k / t.$k (reference
            # bind_context.rs:626 column-position resolution)
            k = int(name[1:])
            cols = [c for c in self.columns
                    if (table is None or (c[2] or "").lower()
                        == table.lower()) and c[3] not in self.star_hidden]
            if not (1 <= k <= len(cols)):
                raise SemanticError(f"column position {k} doesn't exist")
            n, t, tb, on = cols[k - 1]
            return BoundColumn(on, t, tb)
        matches = [
            (n, t, tb, on) for (n, t, tb, on) in self.columns
            if (n.lower() == name.lower() or on.lower() == name.lower())
            and (table is None or (tb or "").lower() == table.lower())
        ]
        if not matches:
            # reference bind error: SemanticError 1065 "column x doesn't
            # exist" (bind_context.rs:599); UnknownColumn 1058 stays for
            # physical block lookups
            raise SemanticError(f"column {name} doesn't exist")
        if len(matches) > 1 and table is None \
                and name.lower() in self.using_pref:
            pref = self.using_pref[name.lower()]
            matches = [m for m in matches if m[3] == pref] or matches
        if len(matches) > 1 and table is None:
            tables = {tb for (_, _, tb, _) in matches}
            if len(tables) > 1:
                raise SemanticError(f"ambiguous column {name!r} (in {sorted(t or '?' for t in tables)})")
        n, t, tb, on = matches[0]
        return BoundColumn(on, t, tb)


class ExprBinder:
    def __init__(self, ctx: BindContext,
                 aggregate_handler: Optional[Callable] = None,
                 window_handler: Optional[Callable] = None):
        self.ctx = ctx
        # planner hook: called for aggregate FunctionCalls, returns a ScalarExpr
        self.aggregate_handler = aggregate_handler
        # planner hook: called for FunctionCalls with an OVER (...) clause
        self.window_handler = window_handler

    def bind(self, e: A.Expr) -> ScalarExpr:
        if isinstance(e, A.Literal):
            return Constant(e.value, infer_literal_type(e.value))
        if isinstance(e, A.ColumnRef):
            db = getattr(e, "database", None)
            if db is not None and (db.lower(), (e.table or "").lower()) \
                    not in self.ctx.db_quals:
                # db.table.column is valid only for the un-aliased table
                # itself (reference: an alias hides the qualified name)
                raise SemanticError(f"column {e.name} doesn't exist")
            return self.ctx.resolve(e.name, e.table)
        if isinstance(e, A.BinaryOp):
            return self._bind_binary(e)
        if isinstance(e, A.UnaryOp):
            if e.op == "NOT":
                return self._func("not", [self.bind(e.operand)])
            if e.op == "-":
                arg = self.bind(e.operand)
                folded = _fold_negate(arg)
                if folded is not None:
                    return folded
                return self._func("negate", [arg])
            return self.bind(e.operand)  # unary +
        if isinstance(e, A.FunctionCall):
            return self._bind_function(e)
        if isinstance(e, A.Cast):
            arg = self.bind(e.expr)
            return CastExpr(arg, parse_type_name(e.type_name), e.is_try)
        if isinstance(e, A.Case):
            return self._bind_case(e)
        if isinstance(e, A.InList):
            return self._bind_in_list(e)
        if isinstance(e, A.Between):
            x = self.bind(e.expr)
            xl, lo = self._coerce_comparison(x, self.bind(e.low))
            xh, hi = self._coerce_comparison(x, self.bind(e.high))
            low = self._func("gte", [xl, lo])
            high = self._func("lte", [xh, hi])
            both = self._func("and", [low, high])
            return self._func("not", [both]) if e.negated else both
        if isinstance(e, A.IsNull):
            return self._func("is_not_null" if e.negated else "is_null", [self.bind(e.expr)])
        if isinstance(e, A.MapAccess):
            from ..types import MapType, TupleType
            vc = self._try_virtual_column(e)
            if vc is not None:
                return vc
            base = self.bind(e.expr)
            key = self.bind(e.key)
            bt = base.dtype.remove_nullable()
            if isinstance(bt, ArrayType):
                fn = "array_get"
            elif isinstance(bt, MapType):
                fn = "map_get"
            elif isinstance(bt, TupleType):
                if not isinstance(key, Constant) \
                        or not isinstance(key.value, int):
                    raise SemanticError("tuple access needs a constant"
                                        " 1-based index")
                idx = int(key.value)
                fields = bt.fields
                if not 1 <= idx <= len(fields):
                    raise SemanticError(f"tuple index {idx} out of range")
                ret = fields[idx - 1].wrap_nullable()
                return Func("tuple_get", [base, Constant(idx, key.dtype)],
                            ret)
            else:
                fn = "get"
            return self._func(fn, [base, key])
        if isinstance(e, A.MapExpr):
            from ..types import MapType
            keys = [_fold_const(self.bind(k)) for k in e.keys]
            vals = [_fold_const(self.bind(v)) for v in e.values]
            if all(isinstance(x, Constant) for x in keys + vals):
                d = {k.value: v.value for k, v in zip(keys, vals)}
                kt = keys[0].dtype.remove_nullable() if keys else String
                vt = vals[0].dtype.remove_nullable() if vals else String
                for v in vals[1:]:
                    vt = common_super_type(vt, v.dtype.remove_nullable()) \
                        or vt
                return Constant(d, MapType(kt, vt))
            raise SemanticError(
                "non-constant map construction: use map(keys, values)")
        if isinstance(e, A.Tuple_):
            from ..types import TupleType
            items = [self.bind(x) for x in e.items]
            if all(isinstance(x, Constant) for x in items):
                return Constant(tuple(x.value for x in items),
                                TupleType(tuple(x.dtype for x in items)))
            raise SemanticError("tuple expressions are not supported here")
        if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists)):
            raise SemanticError("subquery must be handled by the planner")
        if isinstance(e, A.Star):
            raise SemanticError("'*' is not valid here")
        raise SemanticError(f"cannot bind expression {type(e).__name__}")

    def _try_virtual_column(self, e: "A.MapAccess") -> Optional[BoundColumn]:
        """Rewrite a constant-key map-access chain over a scanned variant
        column to its materialized virtual column (EE; reference
        binder/virtual_column.rs). The stored sidecar holds the leaf as
        VARIANT, so the substitution is exact for get() semantics."""
        if not self.ctx.virtual_map:
            return None
        path: List[str] = []
        node = e
        while isinstance(node, A.MapAccess):
            if not isinstance(node.key, A.Literal) \
                    or not isinstance(node.key.value, str):
                return None
            path.append(node.key.value)
            node = node.expr
        if not isinstance(node, A.ColumnRef):
            return None
        try:
            base = self.ctx.resolve(node.name, node.table)
        except Exception:
            return None
        path.reverse()
        key = ((base.table or "").lower(), base.name.lower(), tuple(path))
        hit = self.ctx.virtual_map.get(key)
        if hit is None:
            return None
        vc_name, scan = hit
        if vc_name not in scan.virtual_columns:
            scan.virtual_columns.append(vc_name)
        from ..types import Variant
        return BoundColumn(vc_name, Variant.wrap_nullable(), base.table)

    # ------------------------------------------------------------------ parts
    def _func(self, name: str, args: List[ScalarExpr]) -> Func:
        fn = registry.get(name)
        ret = fn.resolve([a.dtype for a in args])
        if any(a.dtype.is_nullable() for a in args) and fn.null_policy == "propagate":
            ret = ret.wrap_nullable()
        return Func(name, args, ret)

    def _bind_binary(self, e: A.BinaryOp) -> ScalarExpr:
        name = _BINOP_FN.get(e.op)
        if name is None:
            raise SemanticError(f"unsupported operator {e.op!r}")
        # date/timestamp +/- INTERVAL -> add_<unit>s (reference: interval
        # arithmetic lowered in the type checker)
        if e.op in ("+", "-"):
            iv = _as_interval(e.right)
            if iv is not None:
                n, unit = iv
                if e.op == "-":
                    n = -n
                return self._bind_interval_add(self.bind(e.left), n, unit)
            iv = _as_interval(e.left)
            if iv is not None and e.op == "+":
                n, unit = iv
                return self._bind_interval_add(self.bind(e.right), n, unit)
        left = self.bind(e.left)
        right = self.bind(e.right)
        if name not in ("and", "or", "xor", "eq_null_safe") \
                and (isinstance(left.dtype.remove_nullable(), NullType)
                     or isinstance(right.dtype.remove_nullable(),
                                   NullType)):
            # NULL literal operand: the operator is NULL-typed NULL
            # (reference: NULL + 1 is NULL of type NULL)
            return Constant(None, NullType())
        if name in ("plus", "minus"):
            # DATE ± <int> = date shifted by days (reference: date + 5 is
            # DATEADD(day, ...); TPC-DS q72 `d1.d_date + 5`)
            from ..types import Int32
            date_t = parse_type_name("DATE")
            lt = left.dtype.remove_nullable()
            rt = right.dtype.remove_nullable()
            if lt == date_t and rt.is_numeric():
                nullable = left.dtype.is_nullable() or right.dtype.is_nullable()
                days = self._func(
                    name, [CastExpr(left, Int32.wrap_nullable()
                                    if left.dtype.is_nullable() else Int32,
                                    False), right])
                return CastExpr(days, date_t.wrap_nullable()
                                if nullable else date_t, False)
            if name == "plus" and rt == date_t and lt.is_numeric():
                return self._bind_binary(A.BinaryOp("+", e.right, e.left))
        if name in ("plus", "minus", "multiply", "divide", "div", "modulo",
                    "pow"):
            # '333' + 4 coerces the string to the numeric side's family
            # (reference: string literals coerce in arithmetic)
            from ..types import Int64
            from ..types.datatype import StringType as _ST
            lt = left.dtype.remove_nullable()
            rt = right.dtype.remove_nullable()
            for a, b, bt in ((0, right, rt), (1, left, lt)):
                s = left if a == 0 else right
                st = lt if a == 0 else rt
                if isinstance(st, _ST) and bt.is_numeric():
                    target = Float64 if bt.kind.startswith("f") else Int64
                    cast = CastExpr(s, target.wrap_nullable()
                                    if s.dtype.is_nullable() else target,
                                    False)
                    if a == 0:
                        left = cast
                    else:
                        right = cast
        if name in _CMP_FNS:
            left, right = self._coerce_comparison(left, right)
        if name == "concat":
            left = self._ensure_string(left)
            right = self._ensure_string(right)
        return self._func(name, [left, right])

    def _coerce_comparison(self, a: ScalarExpr, b: ScalarExpr):
        ta, tb = a.dtype.remove_nullable(), b.dtype.remove_nullable()
        if isinstance(ta, StringType) and tb.is_numeric():
            a = CastExpr(a, Float64.wrap_nullable() if a.dtype.is_nullable() else Float64, False)
        elif isinstance(tb, StringType) and ta.is_numeric():
            b = CastExpr(b, Float64.wrap_nullable() if b.dtype.is_nullable() else Float64, False)
        elif ta in (parse_type_name("DATE"), parse_type_name("TIMESTAMP")) and isinstance(tb, StringType):
            b = CastExpr(b, ta, False)
        elif tb in (parse_type_name("DATE"), parse_type_name("TIMESTAMP")) and isinstance(ta, StringType):
            a = CastExpr(a, tb, False)
        else:
            # variant vs scalar: coerce the VARIANT side to the scalar's
            # type with TRY semantics (reference jsonb comparisons:
            # v['a'] = 2 compares numerically, v['c'] = 'y' by the
            # unquoted string; non-coercible JSON -> NULL -> no match)
            from ..types import VariantType
            for x, tx, other_t in ((a, ta, tb), (b, tb, ta)):
                if not isinstance(tx, VariantType) \
                        or isinstance(other_t, VariantType):
                    continue
                if other_t.is_numeric() or other_t == Boolean:
                    cast_to = Float64.wrap_nullable()
                elif isinstance(other_t, StringType):
                    cast_to = String.wrap_nullable()
                else:
                    continue
                if x is a:
                    a = CastExpr(a, cast_to, True)
                else:
                    b = CastExpr(b, cast_to, True)
        return a, b

    def _bind_interval_add(self, base: ScalarExpr, n: int, unit: str) -> Func:
        unit_fns = {"day": ("add_days", 1), "week": ("add_days", 7),
                    "month": ("add_months", 1), "quarter": ("add_months", 3),
                    "year": ("add_years", 1), "hour": ("add_hours", 1),
                    "minute": ("add_minutes", 1), "second": ("add_seconds", 1)}
        u = unit.lower().rstrip("s")
        if u not in unit_fns:
            raise SemanticError(f"unsupported interval unit {unit!r}")
        fn, scale = unit_fns[u]
        from ..types import Int64 as _I64
        return self._func(fn, [base, Constant(n * scale, _I64)])

    def _ensure_string(self, x: ScalarExpr) -> ScalarExpr:
        if isinstance(x.dtype.remove_nullable(), StringType):
            return x
        return CastExpr(x, String.wrap_nullable() if x.dtype.is_nullable() else String, False)

    def _bind_function(self, e: A.FunctionCall) -> ScalarExpr:
        name = e.name.lower()
        if e.window is not None:
            if self.window_handler is None:
                raise SemanticError(f"window function {name}() not allowed here")
            return self.window_handler(e)
        if is_aggregate_function(name):
            if self.aggregate_handler is None:
                raise SemanticError(f"aggregate function {name}() not allowed here")
            return self.aggregate_handler(e)
        if name in ("if", "iff") and len(e.args) >= 3 \
                and len(e.args) % 2 == 1:
            # lower if(c1,v1,...,else) to CASE so branches evaluate
            # lazily per selected row (reference if_then_else selection
            # vectors: `if(d=0, 0, x/d)` must not raise on d=0 rows)
            conds = [self.bind(a) for a in e.args[0:-1:2]]
            results = [self.bind(a) for a in e.args[1:-1:2]]
            els = self.bind(e.args[-1])
            rt = results[0].dtype
            for r in results[1:]:
                rt = common_super_type(rt, r.dtype)
            rt = common_super_type(rt, els.dtype)
            return CaseExpr(conds, results, els, rt)
        if name == "decode" and len(e.args) >= 3:
            # Oracle-style decode(x, v1, r1, ..., [default]) with
            # NULL-safe match (NULL matches NULL) — reference
            # conditional family
            x = self.bind(e.args[0])
            rest = e.args[1:]
            has_default = len(rest) % 2 == 1
            pairs = rest[:-1] if has_default else rest
            conds, results = [], []
            for i in range(0, len(pairs), 2):
                v = self.bind(pairs[i])
                a, b = self._coerce_comparison(x, v)
                conds.append(self._func("eq_null_safe", [a, b]))
                results.append(self.bind(pairs[i + 1]))
            els = self.bind(rest[-1]) if has_default else None
            rt = results[0].dtype
            for r in results[1:]:
                rt = common_super_type(rt, r.dtype)
            if els is not None:
                rt = common_super_type(rt, els.dtype)
            else:
                rt = rt.wrap_nullable()
            return CaseExpr(conds, results, els, rt)
        if name == "nextval":
            return self._bind_nextval(e)
        if name == "dict_get":
            return self._bind_dict_get(e)
        if name in _TO_CAST and len(e.args) == 1:
            # to_int64(x) etc. are cast sugar (reference to_* functions)
            return CastExpr(self.bind(e.args[0]), _TO_CAST[name], False)
        if name.startswith("try_") and name[4:] in _TO_CAST \
                and len(e.args) == 1:
            return CastExpr(self.bind(e.args[0]),
                            _TO_CAST[name[4:]].wrap_nullable(), True)
        if name == "typeof" and len(e.args) == 1:
            arg = self.bind(e.args[0])
            return Constant(arg.dtype.sql_name(), String)
        if name in _ARRAY_LAMBDA_FNS:
            return self._bind_array_lambda(name, e)
        if name == "getvariable" and len(e.args) == 1 \
                and isinstance(e.args[0], A.Literal):
            from ..utils.current import current_session
            s = current_session()
            v = (getattr(s, "variables", {}) or {}).get(
                str(e.args[0].value).lower()) if s else None
            if v is None:
                return Constant(None, NullType())
            return Constant(v, infer_literal_type(v))
        if name == "last_query_id" and len(e.args) <= 1:
            from ..utils.current import current_session
            s = current_session()
            ids = getattr(s, "_last_query_ids", None) if s else None
            n = -1
            if e.args:
                c = self.bind(e.args[0])
                if not isinstance(c, Constant):
                    raise SemanticError("last_query_id expects a constant")
                n = int(c.value)
            if not ids or abs(n) > len(ids):
                return Constant(None, String.wrap_nullable())
            return Constant(ids[n if n < 0 else n - 1], String)
        if name in ("current_user", "current_role", "current_database",
                    "database", "version", "connection_id",
                    "current_catalog") and not e.args:
            return self._bind_session_constant(name)
        if name == "array":
            args = [self.bind(a) for a in e.args]
            if all(isinstance(a, Constant) for a in args):
                vals = [a.value for a in args]
                return Constant(vals, infer_literal_type(vals))
            raise SemanticError("non-constant array construction not yet supported")
        if not registry.contains(name):
            raise UnknownFunction(f"unknown function {name!r}")
        args = [self.bind(a) for a in e.args]
        # vector distance fns: coerce a constant array arg to the vector's dim
        if name in ("cosine_distance", "l1_distance", "l2_distance", "inner_product"):
            args = self._coerce_vector_args(args, name)
        return self._func(name, args)

    def _bind_session_constant(self, name: str) -> ScalarExpr:
        """current_user()/current_role()/database()/version() — session
        state folded to constants at bind time (reference: type checker
        resolves these against the session)."""
        from ..types import String
        from ..utils.current import current_session
        s = current_session()
        if s is None:
            raise SemanticError(f"{name}() requires a session context")
        if name == "current_user":
            v = getattr(s.current_user, "name", "root")
        elif name == "current_role":
            roles = getattr(s.current_user, "roles", None) or []
            v = roles[0] if roles else (
                "account_admin" if getattr(s.current_user, "name", "") == "root"
                else "public")
        elif name in ("current_database", "database"):
            v = s.current_database
        elif name == "connection_id":
            v = str(id(s))
        elif name == "current_catalog":
            v = "default"
        else:
            from ..version import __version__
            v = f"databend_tpu v{__version__}"
        return Constant(v, String)

    def _bind_dict_get(self, e: A.FunctionCall) -> ScalarExpr:
        """dict_get(dict_name, 'attr', key) — reference: dictionary lookup
        lowered as an async function in the binder."""
        from ..expression.expr import DictGet
        from ..types import parse_type_name
        from ..utils.current import current_session
        s = current_session()
        if s is None:
            raise SemanticError("dict_get() requires a session context")
        if len(e.args) != 3:
            raise SemanticError("dict_get expects (dict, 'attr', key)")
        d_ast, attr_ast, key_ast = e.args
        if isinstance(d_ast, A.ColumnRef) and d_ast.table is None:
            dname = d_ast.name
        elif isinstance(d_ast, A.Literal) and isinstance(d_ast.value, str):
            dname = d_ast.value
        else:
            raise SemanticError("dict_get expects a dictionary name")
        if not (isinstance(attr_ast, A.Literal) and isinstance(attr_ast.value, str)):
            raise SemanticError("dict_get attribute must be a string literal")
        attr = attr_ast.value
        info = s.dictionaries.get(dname)
        mapping = s.dictionaries.load_mapping(dname, attr)
        a_type = next(t for n, t in info.columns if n.lower() == attr.lower())
        dtype = parse_type_name(a_type).wrap_nullable()
        return DictGet(dname, attr, self.bind(key_ast), mapping, dtype)

    def _bind_nextval(self, e: A.FunctionCall) -> ScalarExpr:
        """nextval(seq) — lowered against the current session's sequence
        manager (reference: async nextval in the type checker)."""
        from ..expression.expr import SequenceNext
        from ..types import UInt64
        from ..utils.current import current_session
        s = current_session()
        if s is None:
            raise SemanticError("nextval() requires a session context")
        if len(e.args) != 1:
            raise SemanticError("nextval expects one sequence name")
        a = e.args[0]
        if isinstance(a, A.ColumnRef) and a.table is None:
            seq = a.name
        elif isinstance(a, A.Literal) and isinstance(a.value, str):
            seq = a.value
        else:
            raise SemanticError("nextval expects a sequence name")
        mgr = s.sequences
        mgr.get(seq)  # existence check at bind time
        return SequenceNext(seq, lambda n, _m=mgr, _s=seq: _m.next_block(_s, n),
                            UInt64)

    def _coerce_vector_args(self, args: List[ScalarExpr], name: str) -> List[ScalarExpr]:
        if len(args) != 2:
            raise SemanticError(f"{name} expects 2 args")
        types = [a.dtype.remove_nullable() for a in args]
        vec = next((t for t in types if isinstance(t, VectorType)), None)
        if vec is None:
            return args
        out = []
        for a, t in zip(args, types):
            if isinstance(t, ArrayType):
                if isinstance(a, Constant) and isinstance(a.value, (list, tuple)) \
                        and len(a.value) != vec.dim:
                    raise SemanticError(
                        f"{name}: vector dims differ ({vec.dim} vs {len(a.value)})")
                out.append(CastExpr(a, VectorType(vec.dim, vec.element), False))
            else:
                out.append(a)
        return out

    def _bind_case(self, e: A.Case) -> CaseExpr:
        conditions = []
        if e.operand is not None:
            op = self.bind(e.operand)
            for c in e.conditions:
                rhs = self.bind(c)
                op2, rhs = self._coerce_comparison(op, rhs)
                conditions.append(self._func("eq", [op2, rhs]))
        else:
            conditions = [self.bind(c) for c in e.conditions]
        results = [self.bind(r) for r in e.results]
        else_result = self.bind(e.else_result) if e.else_result is not None else None
        # result type: common super type of all branches
        rt = results[0].dtype
        for r in results[1:]:
            rt = common_super_type(rt, r.dtype)
        if else_result is not None:
            rt = common_super_type(rt, else_result.dtype)
        else:
            rt = rt.wrap_nullable()
        return CaseExpr(conditions, results, else_result, rt)

    def _fold_bool(self, op: str, clauses: list) -> ScalarExpr:
        """Balanced OR/AND tree: keeps huge IN lists within evaluator
        recursion depth (log2(n) instead of n)."""
        while len(clauses) > 1:
            nxt = []
            for i in range(0, len(clauses), 2):
                if i + 1 < len(clauses):
                    nxt.append(self._func(op, [clauses[i], clauses[i + 1]]))
                else:
                    nxt.append(clauses[i])
            clauses = nxt
        return clauses[0]

    def _bind_in_list(self, e: A.InList) -> ScalarExpr:
        if isinstance(e.expr, A.Tuple_):
            # (a, b) IN ((x, y), ...) — row-tuple membership unrolls to
            # OR of per-entry AND equalities (the reference lowers the
            # tuple in-list to `contains`, PR #12647)
            xs = [self.bind(x) for x in e.expr.items]
            rows = []
            for item in e.items:
                if isinstance(item, A.Tuple_):
                    vals = [self.bind(v) for v in item.items]
                elif isinstance(item, A.Literal) \
                        and isinstance(item.value, tuple):
                    vals = [Constant(v, infer_literal_type(v))
                            for v in item.value]
                else:
                    raise SemanticError(
                        "tuple IN list expects tuple entries")
                if len(vals) != len(xs):
                    raise SemanticError(
                        f"tuple IN entry arity {len(vals)} != {len(xs)}")
                eqs = []
                for xi, v in zip(xs, vals):
                    a, b = self._coerce_comparison(xi, v)
                    eqs.append(self._func("eq", [a, b]))
                rows.append(self._fold_bool("and", eqs))
            acc = self._fold_bool("or", rows)
            return self._func("not", [acc]) if e.negated else acc
        x = self.bind(e.expr)
        clauses = []
        for item in e.items:
            rhs = self.bind(item)
            xi, rhs = self._coerce_comparison(x, rhs)
            clauses.append(self._func("eq", [xi, rhs]))
        acc = self._fold_bool("or", clauses)
        return self._func("not", [acc]) if e.negated else acc


def _as_interval(e) -> "Optional[tuple]":
    """(n, unit) when the AST node is INTERVAL 'n' unit, else None."""
    if isinstance(e, A.FunctionCall) and e.name.lower() == "interval" \
            and len(e.args) == 2 and isinstance(e.args[0], A.Literal) \
            and isinstance(e.args[1], A.Literal):
        try:
            return int(str(e.args[0].value)), str(e.args[1].value)
        except ValueError:
            return None
    return None


# higher-order array functions -> (kind, lambda-arg position)
_ARRAY_LAMBDA_FNS = {
    "array_map": ("map", 1), "array_transform": ("map", 1),
    "array_apply": ("map", 1),
    "array_filter": ("filter", 1),
    "array_fold": ("fold", 2), "array_reduce": ("fold", 2),
    "array_count": ("count", 1),
    "array_any": ("any", 1), "array_all": ("all", 1),
}

_LAMBDA_DEPTH = [0]


def _lambda_param_names(left: A.Expr):
    if isinstance(left, A.ColumnRef) and left.table is None:
        return [left.name]
    if isinstance(left, A.Tuple_) and all(
            isinstance(x, A.ColumnRef) and x.table is None
            for x in left.items):
        return [x.name for x in left.items]
    return None


def _lambda_parts(e: A.Expr):
    """`x -> body` / `(a, b) -> body` parsed as BinaryOp('->', ...).

    `->` binds tighter than comparison operators, so `x -> x % 2 = 0`
    parses as `(x -> x % 2) = 0` — walk the leftmost operator chain to
    find the `->` node and splice its right side back into the tree."""
    if isinstance(e, A.BinaryOp) and e.op == "->":
        params = _lambda_param_names(e.left)
        if params is not None:
            return params, e.right
    node, parent = e, None
    while isinstance(node, A.BinaryOp) and node.op != "->":
        parent, node = node, node.left
    if isinstance(node, A.BinaryOp) and node.op == "->" \
            and parent is not None:
        params = _lambda_param_names(node.left)
        if params is not None:
            parent.left = node.right
            return params, e
    return None, None


def _bind_array_lambda(self, name: str, e: A.FunctionCall):
    from ..expression.expr import ArrayLambda
    from ..types import Int64 as _Int64
    from ..types import UInt64 as _UInt64
    from ..types import VariantType
    kind, lam_pos = _ARRAY_LAMBDA_FNS[name]
    want_args = lam_pos + 1
    if len(e.args) != want_args:
        raise SemanticError(f"{name} expects {want_args} arguments")
    params, body_ast = _lambda_parts(e.args[lam_pos])
    if params is None:
        raise SemanticError(f"{name} expects a lambda like x -> expr")
    n_params = 2 if kind == "fold" else 1
    if len(params) != n_params:
        raise SemanticError(f"{name} lambda takes {n_params} parameter(s)")
    arr = self.bind(e.args[0])
    arr_t = arr.dtype.remove_nullable()
    if isinstance(arr_t, ArrayType):
        elem_t = arr_t.inner.wrap_nullable()
    elif isinstance(arr_t, VariantType):
        elem_t = VariantType().wrap_nullable()
    else:
        raise SemanticError(f"{name} expects an array, got"
                            f" {arr.dtype.sql_name()}")
    init = self.bind(e.args[1]) if kind == "fold" else None
    depth = _LAMBDA_DEPTH[0]
    _LAMBDA_DEPTH[0] += 1
    try:
        inner_ctx = BindContext()
        param_cols = []
        if kind == "fold":
            pc = f"__lam{depth}_{params[0]}"
            inner_ctx.add(params[0], init.dtype.wrap_nullable(), None, pc)
            param_cols.append(pc)
            pc = f"__lam{depth}_{params[1]}"
            inner_ctx.add(params[1], elem_t, None, pc)
            param_cols.append(pc)
        else:
            pc = f"__lam{depth}_{params[0]}"
            inner_ctx.add(params[0], elem_t, None, pc)
            param_cols.append(pc)
        pset = {p.lower() for p in params}
        for (cn, ct, ctb, con) in self.ctx.columns:
            if cn.lower() not in pset:  # lambda params shadow outer names
                inner_ctx.add(cn, ct, ctb, con)
        body = ExprBinder(inner_ctx).bind(body_ast)
    finally:
        _LAMBDA_DEPTH[0] -= 1
    nullable = arr.dtype.is_nullable()
    if kind == "map":
        out_t = ArrayType(body.dtype.remove_nullable())
    elif kind == "filter":
        out_t = arr_t
    elif kind == "count":
        out_t = _UInt64
    elif kind in ("any", "all"):
        out_t = Boolean
    else:  # fold
        out_t = common_super_type(init.dtype, body.dtype) or body.dtype
    if nullable:
        out_t = out_t.wrap_nullable()
    return ArrayLambda(kind, arr, list(params), param_cols, body, elem_t,
                       init, out_t)


ExprBinder._bind_array_lambda = _bind_array_lambda
