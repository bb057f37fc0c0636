"""Device finalize fusion on torch: HAVING / ORDER BY ... LIMIT k applied
ON the [K, G] aggregate grid before it leaves the card (port of
``databend_tpu/pipeline/device_fusion.py``).

The scan-agg engines (device_scan_agg) produce one stacked [K, G] int32
grid per chunk. Without fusion, finalize pulls the whole grid to the
host — at G in the millions (GROUP BY l_orderkey families: TPC-H
q3/q10/q18) that is tens of MB over the host<->device link and a
host-side decode of every group, while the query itself only wants the
top-k rows of `ORDER BY <agg> DESC LIMIT k` or the handful of groups
surviving `HAVING sum(x) > c`. The reference streams the same shapes
through TransformSortMergeLimit's bounded heap (src/query/pipeline/
transforms/src/processors/transforms/sorts/sort_merge_limit.rs:33) and
evaluates HAVING inside the pipeline; the device equivalent is to
finish the query ON the grid:

* exact big-int ORDER BY over base-256 limb sums — the accumulated
  limbs are carry-normalized into digit words on the device and sorted
  lexicographically (no f64, no precision loss; DESC = negate limbs
  before normalizing);
* group-key sort items ride per-entry ORDER-RANK LUTs over the grid
  codes (rank of the decoded value, NULL slot ranked per the engine's
  NULL-largest convention);
* HAVING comparisons against constants become exact integer word
  comparisons (the constant is scaled by the sum's decimal scale with
  Fraction arithmetic, so float thresholds stay exact);
* one lexicographic sort over (having_ok, item words..., slot id) and a
  gather return ONLY [K, k] — a few hundred bytes instead of tens of MB.
  The reference's ``lax.sort`` over several int32 keys has no torch form:
  stable ``torch.sort`` passes from the last key to the first give the
  same order, which the slot id, the last key, makes total.

The HAVING-only shape (no LIMIT — e.g. the q18 `IN (... HAVING ...)`
subquery) pulls one scalar match count first, then gathers a
power-of-two padded count of groups, as the reference does.

The planning half (``plan_fusion``) runs on the host and raises
``_Bail`` for what it cannot do exactly; ``run_fusion`` is the device
half: it uploads the LUTs with ``backend.to_device``, returns numpy only
through ``backend.to_numpy``, and raises on a gather its LUTs cannot
serve (torch has no fill mode for an index past the end).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import backend

from ..expression.expr import BoundColumn, Constant, Func
from .device_scan_agg import _Bail, _value_limb_count, _value_scale


@dataclass
class Fusion:
    """What the plan nodes above the Aggregate want applied to the grid.
    ``order`` names and ``having`` columns refer to the AGGREGATE's
    output names (group keys + agg outputs)."""
    having: Optional[Any] = None                 # ScalarExpr
    order: List[Tuple[str, bool, Optional[bool]]] = field(
        default_factory=list)                    # (name, asc, nulls_first)
    limit: Optional[int] = None


@dataclass
class _FusionPlan:
    ir: tuple            # hashable device-program spec
    luts: List[np.ndarray]
    G: int
    limit: Optional[int]


# --------------------------------------------------------- row-layout map


def _agg_row_map(main_irs, rows_per_limb: int):
    """Mirror of device_scan_agg's flat-output combine layout:
    row 0 = keep-counts, then per agg its rows."""
    row = 1
    out = []
    for a in main_irs:
        kind = a[0]
        if kind in ("count_star", "count"):
            out.append(("count", row, 0, None))
            row += 1
        elif kind in ("sum", "avg"):
            nl = _value_limb_count(a[1])
            out.append((kind, row, nl, _value_scale(a[1])))
            row += 1 + nl * rows_per_limb
        else:  # min / max: one codes row
            out.append((kind, row, 0, None))
            row += 1
    return out, row


def _sum_limb_rows(entry, rows_per_limb: int):
    """(valid_row, ((lo_row, hi_row|-1), ...)) for a sum/avg map entry."""
    _, row, nl, _ = entry
    valid_row = row
    limb_rows = []
    r = row + 1
    for _ in range(nl):
        if rows_per_limb == 2:
            limb_rows.append((r, r + 1))
            r += 2
        else:
            limb_rows.append((r, -1))
            r += 1
    return valid_row, tuple(limb_rows)


# ------------------------------------------------------------ HAVING spec


def _having_conjuncts(expr) -> List[Any]:
    if isinstance(expr, Func) and expr.name == "and":
        out = []
        for a in expr.args:
            out += _having_conjuncts(a)
        return out
    return [expr]


_CMP = {"gt", "gte", "lt", "lte", "eq", "neq"}
_FLIP = {"gt": "lt", "gte": "lte", "lt": "gt", "lte": "gte",
         "eq": "eq", "neq": "neq"}


def _int_bound(op: str, cval, scale: int) -> Tuple[str, Optional[int]]:
    """value/scale OP cval  ->  value_int OP' T with integer T (exact).
    Returns (op', T); op' in {ge, le, eq, true, false}."""
    from fractions import Fraction
    if isinstance(cval, bool) or cval is None:
        raise _Bail("non-numeric HAVING constant")
    if isinstance(cval, float):
        if cval != cval or cval in (float("inf"), float("-inf")):
            raise _Bail("non-finite HAVING constant")
        t = Fraction(cval) * scale
    elif isinstance(cval, (int, np.integer)):
        t = Fraction(int(cval)) * scale
    else:
        try:
            t = Fraction(str(cval)) * scale
        except Exception:
            raise _Bail("unsupported HAVING constant type")
    is_int = t.denominator == 1
    fl = t.numerator // t.denominator          # floor
    ce = -((-t.numerator) // t.denominator)    # ceil
    if op == "gt":
        return "ge", fl + 1
    if op == "gte":
        return "ge", ce
    if op == "lt":
        return "le", ce - 1
    if op == "lte":
        return "le", fl
    if op == "eq":
        return ("eq", fl) if is_int else ("false", None)
    if op == "neq":
        return ("ne", fl) if is_int else ("true", None)
    raise _Bail(f"HAVING op {op}")


def _f64_bounds(op: str, cval: float, scale: int) -> List[Tuple[str, Any]]:
    """value OP cval for a float constant, where value is what the route
    finalizes the sum to, the float64 ``T / scale`` of the exact integer sum
    T, and what a host filter over the unfused route compares: the bounds
    on T, as (op', T) conjuncts with op' in {ge, le, eq, ne, true, false}.

    The reference compares the exact decimal instead (``_int_bound``), so a
    constant that is itself the float64 of such a decimal (TPC-H q15's
    ``total_revenue = (select max(total_revenue) ...)``) never equals the
    sum it came from, and the fused HAVING drops the row the unfused route
    keeps. Rounding is monotonic, so each compare is a threshold on T."""
    from fractions import Fraction
    if cval != cval or abs(cval) > 1e300:
        raise _Bail("non-finite or huge HAVING constant")

    def t_min(v: float) -> int:
        """The least integer T with float64(T / scale) >= v."""
        ulp = Fraction(math.ulp(v))
        lo = math.floor((Fraction(v) - ulp) * scale) - 1   # T / scale < v
        hi = math.ceil((Fraction(v) + ulp) * scale) + 1    # T / scale > v
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if mid / scale >= v:
                hi = mid
            else:
                lo = mid
        return hi

    ge, gt = t_min(cval), t_min(math.nextafter(cval, math.inf))
    if op == "gte":
        return [("ge", ge)]
    if op == "gt":
        return [("ge", gt)]
    if op == "lt":
        return [("le", ge - 1)]
    if op == "lte":
        return [("le", gt - 1)]
    if op == "eq":
        if ge > gt - 1:
            return [("false", None)]
        return [("eq", ge)] if ge == gt - 1 else [("ge", ge),
                                                  ("le", gt - 1)]
    if op == "neq":
        if ge > gt - 1:
            return [("true", None)]
        if ge == gt - 1:
            return [("ne", ge)]
        raise _Bail("HAVING <> a float that several sums round to")
    raise _Bail(f"HAVING op {op}")


def _const_words(T: int, J: int) -> Optional[Tuple[int, ...]]:
    """T as (c_top, d_{J-1}, ..., d_0) matching the device's normalized
    digits; None when c_top overflows i32 (resolve statically)."""
    digits = [(T >> (8 * j)) & 255 for j in range(J)]
    c_top = T >> (8 * J)
    if not (-(1 << 31) <= c_top < (1 << 31)):
        return None
    return (int(c_top),) + tuple(int(d) for d in reversed(digits))


# -------------------------------------------------------------- planning


def plan_fusion(plan, fusion: Fusion, group, decodes, main_irs,
                rows_per_limb: int, G: int) -> _FusionPlan:
    """Resolve the fusion request against the engine's grid layout.
    Raises device_scan_agg._Bail (via this module's _Bail) when any
    piece cannot run exactly on device."""
    agg_names = [n for n, _, _ in plan.aggs]
    key_names = [n for n, _ in plan.keys]
    amap, K = _agg_row_map(main_irs, rows_per_limb)

    sizes = tuple(size + 1 for _, size, _, _ in group)
    strides = []
    s = 1
    for sz in reversed(sizes):
        strides.append(s)
        s *= sz
    strides = tuple(reversed(strides))   # stride of entry i in the gid

    luts: List[np.ndarray] = []

    def key_item_ir(kpos: int, asc: bool, nulls_first: Optional[bool]):
        """Order words for group key ``kpos``: rank LUT over the entry's
        codes (or the code itself when the decode is already sorted)."""
        for e, dec in enumerate(decodes):
            for (key_pos, values, vmask) in dec:
                if key_pos != kpos:
                    continue
                size = sizes[e] - 1   # entry size (codes 0..size-1 + NULL)
                nf = nulls_first if nulls_first is not None else False
                if not isinstance(values, np.ndarray):
                    values = np.asarray(values)
                if values.dtype.kind in "iufMm" and vmask is None \
                        and len(values) == size \
                        and (len(values) < 2
                             or bool((values[1:] >= values[:-1]).all())):
                    # sorted identity decode: the code IS the rank
                    return ("key", e, -1, -1, asc, nf), None
                if len(values) != size:
                    raise _Bail("decode length mismatch")
                # rank LUT (+ NULL slot appended at code == size)
                if values.dtype.kind in "iufMm":
                    _, inv = np.unique(values, return_inverse=True)
                else:
                    try:
                        _, inv = np.unique(values.astype(object).astype(str)
                                           if values.dtype == object
                                           else values, return_inverse=True)
                    except TypeError:
                        raise _Bail("un-orderable sort key values")
                word = np.concatenate(
                    [inv.astype(np.int32), np.zeros(1, np.int32)])
                nl = np.zeros(size + 1, np.bool_)
                if vmask is not None:
                    nl[:size] = vmask
                nl[size] = True
                li = len(luts)
                luts.append(word)
                luts.append(nl)
                return ("key", e, li, li + 1, asc, nf), None
        raise _Bail("sort key is not a grid key")

    order_irs: List[tuple] = []
    for (name, asc, nulls_first) in fusion.order:
        if name in agg_names:
            i = agg_names.index(name)
            kind = amap[i][0]
            if kind == "count":
                order_irs.append(("count", amap[i][1], asc))
            elif kind == "sum":
                valid_row, limb_rows = _sum_limb_rows(amap[i],
                                                      rows_per_limb)
                nf = nulls_first if nulls_first is not None else False
                order_irs.append(("sum", valid_row, limb_rows, asc, nf))
            else:
                raise _Bail(f"ORDER BY over {kind} aggregate")
        elif name in key_names:
            ir, _ = key_item_ir(key_names.index(name), asc, nulls_first)
            order_irs.append(ir)
        else:
            raise _Bail(f"sort key {name!r} not in aggregate output")

    having_irs: List[tuple] = []
    if fusion.having is not None:
        for c in _having_conjuncts(fusion.having):
            if not (isinstance(c, Func) and c.name in _CMP
                    and len(c.args) == 2):
                raise _Bail("unsupported HAVING shape")
            a, b = c.args
            op = c.name
            if isinstance(a, Constant) and isinstance(b, BoundColumn):
                a, b, op = b, a, _FLIP[op]
            if not (isinstance(a, BoundColumn) and isinstance(b, Constant)):
                raise _Bail("HAVING must compare a column to a constant")
            if a.name not in agg_names:
                raise _Bail("HAVING over a non-aggregate column")
            i = agg_names.index(a.name)
            kind = amap[i][0]
            if kind == "count":
                op2, T = _int_bound(op, b.value, 1)
                if op2 in ("true", "false"):
                    having_irs.append((op2,))
                    continue
                # counts are i32 and non-negative
                if T > (1 << 31) - 1:
                    having_irs.append(
                        ("false",) if op2 in ("ge", "eq") else ("true",))
                elif T < 0:
                    having_irs.append(
                        ("true",) if op2 in ("ge", "ne") else ("false",))
                else:
                    having_irs.append(("cnt_cmp", op2, amap[i][1], int(T)))
            elif kind == "sum":
                scale = amap[i][3]
                bounds = _f64_bounds(op, b.value, scale) \
                    if isinstance(b.value, float) \
                    else [_int_bound(op, b.value, scale)]
                valid_row, limb_rows = _sum_limb_rows(amap[i],
                                                      rows_per_limb)
                for op2, T in bounds:
                    if op2 in ("true", "false"):
                        having_irs.append((op2,))
                        continue
                    words = _const_words(T, len(limb_rows))
                    if words is None:
                        # |T| beyond any representable sum: resolve
                        # statically
                        pos = T > 0
                        if op2 == "ge":
                            having_irs.append(("false",) if pos
                                              else ("true",))
                        elif op2 == "le":
                            having_irs.append(("true",) if pos
                                              else ("false",))
                        elif op2 == "eq":
                            having_irs.append(("false",))
                        else:
                            having_irs.append(("true",))
                        continue
                    having_irs.append(("sum_cmp", op2, valid_row,
                                       limb_rows, words))
            else:
                raise _Bail(f"HAVING over {kind} aggregate")

    ir = (G, K, tuple(order_irs), tuple(having_irs))
    return _FusionPlan(ir, luts, G, fusion.limit)


# --------------------------------------------------------- device program


def _digits(limbs):
    """Carry-normalize signed base-256 limb sums into digits in [0, 256)
    plus a signed top carry (all int32, exact)."""
    carry = torch.zeros_like(limbs[0])
    digits = []
    for l in limbs:
        t = l + carry
        c = torch.div(t, 256, rounding_mode="floor")
        digits.append(t - c * 256)
        carry = c
    return carry, digits  # value = carry*256^J + sum digits[j]*256^j


def _sum_limbs(stacked, limb_rows, neg: bool):
    out = []
    for (lo, hi) in limb_rows:
        l = stacked[lo]
        if hi >= 0:
            l = l + 128 * stacked[hi]
        out.append(-l if neg else l)
    return out


def _lex_cmp(words, const_words):
    """(value > T, value == T) via most-significant-first word compare."""
    gt = None
    eq = None
    for w, t in zip(words, const_words):
        wg = w > t
        we = w == t
        if gt is None:
            gt, eq = wg, we
        else:
            gt = gt | (eq & wg)
            eq = eq & we
    return gt, eq


def _build_count(ir: tuple, n_luts: int):
    def fn(stacked, *luts):
        return torch.sum(_ok_mask(ir, stacked, luts).to(torch.int32))

    return fn


def _ok_mask(ir, stacked, luts):
    G, K, order_irs, having_irs = ir
    ok = stacked[0] > 0
    for h in having_irs:
        kind = h[0]
        if kind == "true":
            continue
        if kind == "false":
            ok = torch.zeros_like(ok)
        elif kind == "cnt_cmp":
            _, op2, row, T = h
            v = stacked[row]
            if op2 == "ge":
                ok = ok & (v >= T)
            elif op2 == "le":
                ok = ok & (v <= T)
            elif op2 == "eq":
                ok = ok & (v == T)
            else:
                ok = ok & (v != T)
        else:  # sum_cmp
            _, op2, valid_row, limb_rows, words_c = h
            limbs = _sum_limbs(stacked, limb_rows, False)
            carry, digits = _digits(limbs)
            words = [carry] + digits[::-1]
            gt, eq = _lex_cmp(words, words_c)
            if op2 == "ge":
                m = gt | eq
            elif op2 == "le":
                m = ~gt
            elif op2 == "eq":
                m = eq
            else:
                m = ~eq
            ok = ok & m & (stacked[valid_row] > 0)  # NULL sum -> false
    return ok


def _flag(isnull, nulls_first: bool):
    return torch.where(isnull, 0 if nulls_first else 1,
                       1 if nulls_first else 0).to(torch.int32)


def _lex_order(keys):
    """The slot order of ``lax.sort(keys + (slot,), num_keys=len(keys)+1)``:
    stable sorts from the last key to the first, starting from the slot
    order itself."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm.to(torch.int32)


def _build_topk(ir: tuple, n_luts: int, kpad: int):
    G, K, order_irs, having_irs = ir

    def fn2(stacked, *luts):
        ok = _ok_mask(ir, stacked, luts)
        keys: List[Any] = [torch.where(ok, 0, 1).to(torch.int32)]
        slot = torch.arange(G, dtype=torch.int32, device=stacked.device)
        for o in order_irs:
            kind = o[0]
            if kind == "count":
                _, row, asc = o
                keys.append(stacked[row] if asc else -stacked[row])
            elif kind == "sum":
                _, valid_row, limb_rows, asc, nf = o
                keys.append(_flag(stacked[valid_row] == 0, nf))
                limbs = _sum_limbs(stacked, limb_rows, not asc)
                carry, digits = _digits(limbs)
                keys.append(carry)
                keys.extend(digits[::-1])
            else:  # ("key", stride, size, wl, nl, asc, nf)
                _, stride, size, wl, nl, asc, nf = o
                code = torch.remainder(
                    torch.div(slot, stride, rounding_mode="floor"), size + 1)
                if wl >= 0:   # LUTs of size + 1 entries (_check_gathers)
                    word = luts[wl][code]
                    isnull = luts[nl][code]
                else:
                    word = code
                    isnull = code == size
                keys.append(_flag(isnull, nf))
                word = torch.where(isnull, 0, word)
                keys.append(word if asc else -word)
        top = _lex_order(keys)[:kpad]
        return top, ok[top], stacked[:, top]

    return fn2


def _check_gathers(ir: tuple, luts, shape) -> None:
    """Every gather of the device program stays inside its source: a key
    item's codes run over [0, size], so its two LUTs need size + 1 entries,
    and the selected slots index a [K, G] grid."""
    G, K, order_irs, _ = ir
    if tuple(shape) != (K, G):
        raise ValueError(f"fusion grid {tuple(shape)} is not [{K}, {G}]")
    for o in order_irs:
        if o[0] == "key" and o[3] >= 0:
            size = o[2]
            for li in (o[3], o[4]):
                if len(luts[li]) != size + 1:
                    raise ValueError(
                        f"fusion LUT {li} has {len(luts[li])} entries for"
                        f" codes 0..{size}")


# ------------------------------------------------------------- execution


def run_fusion(fp: _FusionPlan, stacked_dev, group) -> Tuple[np.ndarray,
                                                             List[Any]]:
    """Execute the fused finalize; returns (slot ids, flat rows) with
    only the selected groups, in final order."""
    G, K, order_irs, having_irs = fp.ir
    # rewrite key items (entry index -> stride/size) now that the group
    # layout is known
    sizes = [size + 1 for _, size, _, _ in group]
    strides = []
    s = 1
    for sz in reversed(sizes):
        strides.append(s)
        s *= sz
    strides = list(reversed(strides))
    order2 = []
    for o in order_irs:
        if o[0] == "key":
            _, e, wl, nl, asc, nf = o
            order2.append(("key", strides[e], sizes[e] - 1, wl, nl,
                           asc, nf))
        else:
            order2.append(o)
    ir2 = (G, K, tuple(order2), tuple(having_irs))
    _check_gathers(ir2, fp.luts, stacked_dev.shape)

    luts_dev = [backend.to_device(l) for l in fp.luts]
    if fp.limit is not None:
        kpad = max(1, min(int(fp.limit), G))
    else:
        cnt = int(backend.to_numpy(
            _build_count(ir2, len(luts_dev))(stacked_dev, *luts_dev)))
        if cnt <= 0:
            return np.zeros(0, np.int64), [np.zeros(0, np.int64)
                                           for _ in range(K)]
        kpad = 1
        while kpad < cnt:
            kpad <<= 1
        kpad = min(kpad, G)
    fn = _build_topk(ir2, len(luts_dev), kpad)
    top, mask, rows = fn(stacked_dev, *luts_dev)
    top, mask, rows = backend.to_numpy([top, mask.to(torch.int32), rows])
    sel = mask.astype(bool)
    top = top[sel].astype(np.int64)
    flat = [r[sel] for r in rows.astype(np.int64)]
    return top, flat
