"""Plan fragmenter of the port: the host halves.

The reference compiles ``Sort(limit) -> [Project] -> [HAVING] ->
Aggregate`` into one device program over the mesh. What runs before any
mesh check is host code and is copied here: the plan matching
(``match_agg_topn``, ``_spec_key``, ``_compile_having``) and the aggregate
layout the standalone distributed aggregate shares (``device_agg_plan``,
``device_agg_values``, ``finalize_device_agg``). The device halves (the
psum and shuffle programs, ``sharded_grouped_agg_topn``) wait for the mesh
(ROADMAP.md item 11b): ``AggTopNFragment.execute`` returns None without a
mesh, as the reference does, and the executor's host path answers.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# HAVING comparisons the device 3VL code knows (the reference's _CMP keys)
_CMP = ("eq", "noteq", "lt", "lte", "gt", "gte")


class AggTopNFragment:
    """A matched fused fragment; ``execute()`` returns the final DataBlock
    or None when the runtime bails (no mesh: always, in the port)."""

    def __init__(self, sort_plan, project, having, agg, ops, spec, key,
                 hcode):
        self.sort_plan = sort_plan
        self.project = project
        self.having = having
        self.agg = agg
        self.ops = ops
        self.spec = spec
        self.key = key
        self.hcode = hcode

    def execute(self):
        from .mesh import get_default_mesh

        if get_default_mesh() is None:
            return None
        raise NotImplementedError(
            "the fused aggregate + top-n device program is not ported to "
            "databend_tpu_torch (ROADMAP.md item 11b: mesh and exchanges)")


def match_agg_topn(sort_plan) -> Optional[AggTopNFragment]:
    """Static match of the fusible fragment under a distributed
    Sort(limit): see module docstring. Returns None when any piece cannot
    compile to the device program (the standalone operators / host path
    take over)."""
    from ..expression.expr import BoundColumn
    from ..sql.plans import AggregatePlan, FilterPlan, ProjectPlan

    if sort_plan.limit is None or len(sort_plan.items) != 1:
        return None
    node = sort_plan.child
    project = None
    mapping = {}
    if isinstance(node, ProjectPlan):
        for name, e in node.items:
            if not isinstance(e, BoundColumn):
                return None
            mapping[name] = e.name
        project = node
        node = node.child
    having = None
    if isinstance(node, FilterPlan):
        having = node
        node = node.child
    if not isinstance(node, AggregatePlan) or not node.keys:
        return None
    agg = node
    if not agg.distributed:
        return None
    plan_ = device_agg_plan(agg.aggs)
    if plan_ is None:
        return None
    ops, spec = plan_
    agg_names = [n for n, _, _ in agg.aggs]
    target = sort_plan.items[0].name
    src = mapping.get(target, target) if project is not None else target
    if src not in agg_names:
        return None
    key = _spec_key(spec[agg_names.index(src)])
    if key is None:
        return None
    hcode = None
    if having is not None:
        hcode = _compile_having(having.expr, agg_names, spec)
        if hcode is None:
            return None
    return AggTopNFragment(sort_plan, project, having, agg, ops, spec,
                           key, hcode)


def _spec_key(entry):
    kind, idxs, nn = entry
    if kind == "avg":
        return ("avg", idxs[0], idxs[1])
    if kind in ("count", "sum", "min", "max"):
        return ("col", idxs[0], nn)
    return None


def _compile_having(expr, agg_names, spec):
    """Compile a HAVING predicate over aggregate outputs + numeric
    constants into the device 3VL code, or None if out of scope."""
    from ..expression.expr import BoundColumn, Constant, Func

    def value(e):
        if isinstance(e, Constant):
            if not isinstance(e.value, (int, float, bool, np.number)):
                return None
            return ("const", float(e.value))
        if isinstance(e, BoundColumn) and e.name in agg_names:
            k = _spec_key(spec[agg_names.index(e.name)])
            return ("leaf", k) if k is not None else None
        return None

    def pred(e):
        if not isinstance(e, Func):
            return None
        if e.name in ("and", "or"):
            a, b = pred(e.args[0]), pred(e.args[1])
            return (e.name, a, b) if a is not None and b is not None \
                else None
        if e.name == "not":
            a = pred(e.args[0])
            return ("not", a) if a is not None else None
        if e.name in _CMP:
            a, b = value(e.args[0]), value(e.args[1])
            return (e.name, a, b) if a is not None and b is not None \
                else None
        return None

    return pred(expr)


# --------------------------------------------------------------------------
# shared device-aggregate compilation (also used by the standalone
# distributed aggregate in pipeline/executor.py)
#
# spec per agg: (kind, op_indices, nn_idx) where nn_idx points at the
# hidden non-null-count column appended for nullable sum/min/max args
# (SQL: SUM/MIN/MAX over an all-NULL group is NULL, not the identity).


def device_agg_plan(aggs):
    """Static eligibility + op layout for a device grouped aggregation.
    Returns (ops, spec) or None (unsupported function / DISTINCT /
    multi-arg / non-numeric argument)."""
    ops: List[str] = []
    spec = []
    for name, fn, arg_exprs in aggs:
        if getattr(fn, "distinct", False):
            return None
        if arg_exprs and len(arg_exprs) != 1:
            return None
        nullable = False
        if arg_exprs:
            dt = arg_exprs[0].dtype
            nullable = dt.is_nullable()
            if not dt.remove_nullable().is_numeric():
                return None
        nm = fn.name
        if nm == "count":
            spec.append(("count", [len(ops)], -1))
            ops.append("sum")
        elif nm in ("sum", "min", "max"):
            j = len(ops)
            ops.append(nm if nm != "sum" else "sum")
            nn = -1
            if nullable:
                nn = len(ops)
                ops.append("sum")  # non-null count
            spec.append((nm, [j], nn))
        elif nm == "avg":
            j = len(ops)
            ops.extend(["sum", "sum"])
            spec.append(("avg", [j, j + 1], j + 1))
        elif nm in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
            # moments layout: sum(v), sum(v^2), count (reference:
            # aggregate_unary.rs variance states)
            j = len(ops)
            ops.extend(["sum", "sum", "sum"])
            spec.append((nm, [j, j + 1, j + 2], j + 2))
        else:
            return None
    return ops, spec


def device_agg_values(aggs, spec, ops, arg_cols_all, n_rows: int
                      ) -> np.ndarray:
    """Build the [n_rows, len(ops)] value matrix for the device programs
    from the evaluated (concatenated) argument columns."""
    vals = np.zeros((n_rows, len(ops)), np.float64)
    for ai, (name, fn, _) in enumerate(aggs):
        kind, idxs, nn = spec[ai]
        ac = arg_cols_all[ai]
        arg = ac[0] if ac else None
        if kind == "count":
            if arg is not None and arg.validity is not None:
                vals[:, idxs[0]] = arg.validity.astype(np.float64)
            else:
                vals[:, idxs[0]] = 1.0
            continue
        v = arg.data.astype(np.float64)
        ok = arg.validity
        if kind == "avg":
            vals[:, idxs[0]] = v if ok is None else np.where(ok, v, 0.0)
            vals[:, idxs[1]] = 1.0 if ok is None else ok.astype(np.float64)
            continue
        if kind in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
            vv = v if ok is None else np.where(ok, v, 0.0)
            vals[:, idxs[0]] = vv
            vals[:, idxs[1]] = vv * vv
            vals[:, idxs[2]] = 1.0 if ok is None else ok.astype(np.float64)
            continue
        if ok is not None:
            fill = 0.0 if kind == "sum" else (
                np.inf if kind == "min" else -np.inf)
            v = np.where(ok, v, fill)
        vals[:, idxs[0]] = v
        if nn >= 0 and kind != "avg":
            vals[:, nn] = 1.0 if ok is None else ok.astype(np.float64)
    return vals


def finalize_device_agg(aggs, spec, merged) -> list:
    """Turn merged device aggregate rows back into typed output columns
    (NULL for empty-input SUM/MIN/MAX/AVG groups via the hidden non-null
    counts)."""
    from ..expression import Column

    out_cols = []
    for ai, (name, fn, _) in enumerate(aggs):
        kind, idxs, nn = spec[ai]
        rt = fn.return_type()
        if kind == "count":
            out_cols.append(Column.from_pylist(
                [int(round(v)) for v in merged[:, idxs[0]]], rt))
            continue
        if kind == "avg":
            sums = merged[:, idxs[0]]
            cnts = merged[:, idxs[1]]
            vals = [None if c == 0 else s / c for s, c in zip(sums, cnts)]
            out_cols.append(Column.from_pylist(vals, rt.wrap_nullable()))
            continue
        if kind in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
            sums = merged[:, idxs[0]]
            sqs = merged[:, idxs[1]]
            cnts = np.round(merged[:, idxs[2]])
            vals = []
            need = 2 if kind.endswith("_samp") else 1
            for s, ss, c in zip(sums, sqs, cnts):
                if c < need:
                    vals.append(None)
                    continue
                if kind.endswith("_samp"):
                    var = (ss - s * s / c) / (c - 1)
                else:
                    var = ss / c - (s / c) ** 2
                var = max(float(var), 0.0)  # f32 rounding can dip below 0
                vals.append(float(np.sqrt(var))
                            if kind.startswith("stddev") else var)
            out_cols.append(Column.from_pylist(vals, rt.wrap_nullable()))
            continue
        col = merged[:, idxs[0]]
        nulls = merged[:, nn] == 0 if nn >= 0 else np.zeros(len(col), bool)
        vals = []
        for v, isnull in zip(col, nulls):
            if isnull or (kind in ("min", "max") and not np.isfinite(v)):
                vals.append(None)
            elif rt.remove_nullable().is_integer():
                vals.append(int(round(v)))
            else:
                vals.append(float(v))
        out_cols.append(Column.from_pylist(vals, rt.wrap_nullable()))
    return out_cols
