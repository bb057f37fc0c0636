"""Extended VARIANT (JSON) functions: is_*/as_* families, path access,
constructors, object/array operations.

Reference: src/query/functions/src/scalars/variant.rs (jsonb-backed,
~60 registrations). Values are canonical JSON text; kernels parse per
row on the host — VARIANTs never enter device programs.
"""

from __future__ import annotations

import json

import numpy as np

from ...types import Boolean, Float64, Int64, String, UInt64, Variant
from ..column import StringData
from .registry import scalar_function
from .variant_fns import _texts, _variant_resolver


def _loads(t):
    try:
        return json.loads(t), True
    except (ValueError, TypeError):
        return None, False


def _reg(name, fn, n_args=1, ret=Variant, aliases=()):
    """Register an n-ary JSON kernel. ``fn`` gets parsed python values
    (first arg parsed from JSON; later args raw text/numbers) and returns
    a python value (re-encoded for Variant returns) or None -> NULL."""

    @scalar_function(name, _variant_resolver(name, n_args, ret),
                     null_policy="custom", aliases=list(aliases))
    def _k(payloads, validities, arg_types, n_rows):
        firsts = _texts(payloads[0])
        rest = [(_texts(p) if isinstance(p, StringData)
                 else np.asarray(p).tolist()) for p in payloads[1:]]
        out, valid = [], np.ones(n_rows, np.bool_)
        for i in range(n_rows):
            if any(v is not None and not v[i] for v in validities):
                out.append(None)
                valid[i] = False
                continue
            v, ok = _loads(firsts[i])
            if not ok:
                out.append(None)
                valid[i] = False
                continue
            r = fn(v, *[c[i] for c in rest])
            if r is None:
                out.append(None)
                valid[i] = False
            else:
                out.append(r)
        if ret is Variant:
            payload = StringData.from_pylist(
                ["" if v is None else json.dumps(v, separators=(",", ":")) for v in out])
        elif ret is String:
            payload = StringData.from_pylist(
                ["" if v is None else str(v) for v in out])
        elif ret is Boolean:
            payload = np.array([bool(v) for v in out], np.bool_)
        else:
            payload = np.array([0 if v is None else v for v in out],
                               ret.numpy_dtype())
        return payload, (None if valid.all() else valid)
    return _k


class _Json:  # marker for fn results already being python JSON values
    pass


# ---- type predicates (is_*) -------------------------------------------------
_reg("is_object", lambda v: isinstance(v, dict), ret=Boolean)
_reg("is_array", lambda v: isinstance(v, list), ret=Boolean)
_reg("is_string", lambda v: isinstance(v, str), ret=Boolean)
_reg("is_boolean", lambda v: isinstance(v, bool), ret=Boolean)
_reg("is_integer", lambda v: isinstance(v, int) and not isinstance(v, bool),
     ret=Boolean)
_reg("is_float", lambda v: isinstance(v, float), ret=Boolean,
     aliases=["is_double", "is_real"])
_reg("is_null_value", lambda v: v is None, ret=Boolean)


# ---- casts (as_*): NULL when the variant is a different kind ---------------
_reg("as_string", lambda v: v if isinstance(v, str) else None, ret=String)
_reg("as_integer", lambda v: v if isinstance(v, int)
     and not isinstance(v, bool) else None, ret=Int64)
_reg("as_float", lambda v: float(v) if isinstance(v, (int, float))
     and not isinstance(v, bool) else None, ret=Float64,
     aliases=["as_double"])
_reg("as_boolean", lambda v: v if isinstance(v, bool) else None, ret=Boolean)
_reg("as_array", lambda v: v if isinstance(v, list) else None)
_reg("as_object", lambda v: v if isinstance(v, dict) else None)


# ---- structure --------------------------------------------------------------
_reg("object_keys", lambda v: sorted(v.keys())
     if isinstance(v, dict) else None, aliases=["json_object_keys"])
_reg("json_strip_nulls", lambda v: {k: x for k, x in v.items()
                                    if x is not None}
     if isinstance(v, dict) else v)
_reg("json_pretty", lambda v: json.dumps(v, indent=2, sort_keys=False),
     ret=String)
_reg("check_json", lambda v: None, ret=String)  # valid JSON -> NULL message


def _get_path(v, path):
    """get_path(v, 'a.b[0]') / json_extract_path_text — dotted+indexed."""
    cur = v
    token = ""
    parts = []
    i = 0
    p = str(path)
    while i < len(p):
        c = p[i]
        if c == ".":
            if token:
                parts.append(token)
                token = ""
        elif c == "[":
            if token:
                parts.append(token)
                token = ""
            j = p.index("]", i)
            parts.append(int(p[i + 1:j]))
            i = j
        else:
            token += c
        i += 1
    if token:
        parts.append(token)
    for part in parts:
        if isinstance(part, int):
            if not isinstance(cur, list) or not -len(cur) <= part < len(cur):
                return None
            cur = cur[part]
        else:
            if not isinstance(cur, dict) or part not in cur:
                return None
            cur = cur[part]
    return cur


_reg("get_path", _get_path, n_args=2)
_reg("json_extract_path_text",
     lambda v, p: (lambda r: None if r is None
                   else (r if isinstance(r, str) else json.dumps(r, separators=(",", ":"))))(
         _get_path(v, p)),
     n_args=2, ret=String)
_reg("get_ignore_case",
     lambda v, k: next((x for kk, x in v.items()
                        if kk.lower() == str(k).lower()), None)
     if isinstance(v, dict) else None, n_args=2)


def _contains(a, b_text):
    b, ok = _loads(b_text)
    if not ok:
        return None
    if isinstance(a, dict) and isinstance(b, dict):
        return all(k in a and a[k] == v for k, v in b.items())
    if isinstance(a, list):
        if isinstance(b, list):
            return all(x in a for x in b)
        return b in a
    return a == b


_reg("json_contains_in_left", _contains, n_args=2, ret=Boolean)
_reg("json_contains_in_right", lambda a, b_text: _contains(
    _loads(b_text)[0], json.dumps(a, separators=(",", ":"))), n_args=2, ret=Boolean)


# ---- variant array operations ----------------------------------------------
def _arr(fn):
    return lambda v, *a: fn(v, *a) if isinstance(v, list) else None


def _parse_arg(x):
    v, ok = _loads(x) if isinstance(x, str) else (x, True)
    return v if ok else x


_reg("array_append", _arr(lambda v, x: v + [_parse_arg(x)]), n_args=2)
_reg("array_prepend", _arr(lambda v, x: [_parse_arg(x)] + v), n_args=2)
_reg("array_compact", _arr(lambda v: [x for x in v if x is not None]))
_reg("array_reverse", _arr(lambda v: v[::-1]))
_reg("array_distinct", _arr(lambda v: list(dict.fromkeys(
    json.dumps(x, separators=(",", ":")) for x in v)) and [json.loads(s) for s in dict.fromkeys(
        json.dumps(x, separators=(",", ":")) for x in v)]), aliases=["array_unique_values"])
_reg("array_flatten", _arr(lambda v: [y for x in v
                                      for y in (x if isinstance(x, list)
                                                else [x])]))
_reg("array_indexof", _arr(lambda v, x: (v.index(_parse_arg(x)) + 1)
                           if _parse_arg(x) in v else 0),
     n_args=2, ret=UInt64)
_reg("array_remove", _arr(lambda v, x: [y for y in v
                                        if y != _parse_arg(x)]), n_args=2)
_reg("array_remove_first", _arr(lambda v: v[1:]))
_reg("array_remove_last", _arr(lambda v: v[:-1]))
_reg("array_concat_variant",
     lambda a, b_text: (a + _loads(b_text)[0])
     if isinstance(a, list) and isinstance(_loads(b_text)[0], list) else None,
     n_args=2)


def _set_op(op):
    def fn(a, b_text):
        b, ok = _loads(b_text)
        if not isinstance(a, list) or not isinstance(b, list):
            return None
        bs = [json.dumps(x, separators=(",", ":")) for x in b]
        if op == "except":
            return [x for x in a if json.dumps(x, separators=(",", ":")) not in bs]
        if op == "intersection":
            seen = set()
            out = []
            for x in a:
                s = json.dumps(x, separators=(",", ":"))
                if s in bs and s not in seen:
                    seen.add(s)
                    out.append(x)
            return out
        return any(json.dumps(x, separators=(",", ":")) in bs for x in a)  # overlap
    return fn


_reg("array_except", _set_op("except"), n_args=2)
_reg("array_intersection", _set_op("intersection"), n_args=2)
_reg("array_overlap", _set_op("overlap"), n_args=2, ret=Boolean)


# ---- constructors (variadic; bound over raw args) ---------------------------
@scalar_function("json_object", lambda ts: Variant, null_policy="custom",
                 aliases=["object_construct"])
def _json_object(payloads, validities, arg_types, n_rows):
    cols = [_texts(p) if isinstance(p, StringData)
            else np.asarray(p).tolist() for p in payloads]
    out = []
    for i in range(n_rows):
        obj = {}
        for j in range(0, len(cols) - 1, 2):
            k = str(cols[j][i])
            v = cols[j + 1][i]
            if isinstance(v, str):
                parsed, ok = _loads(v)
                v = parsed if ok else v
            if isinstance(v, float) and v.is_integer():
                v = int(v)
            obj[k] = v
        out.append(json.dumps(obj, separators=(",", ":")))
    return StringData.from_pylist(out), None


@scalar_function("json_array", lambda ts: Variant, null_policy="custom",
                 aliases=["array_construct_variant"])
def _json_array(payloads, validities, arg_types, n_rows):
    cols = [_texts(p) if isinstance(p, StringData)
            else np.asarray(p).tolist() for p in payloads]
    out = []
    for i in range(n_rows):
        arr = []
        for c in cols:
            v = c[i]
            if isinstance(v, str):
                parsed, ok = _loads(v)
                v = parsed if ok else v
            if isinstance(v, float) and v.is_integer():
                v = int(v)
            arr.append(v)
        out.append(json.dumps(arr, separators=(",", ":")))
    return StringData.from_pylist(out), None


def _jsonpath_eval(doc, path):
    """Tiny jsonpath subset: $.a.b, $.a[*], $.a[2], $[*].b (reference:
    jsonb path query functions in scalars/variant.rs)."""
    import re as _re
    if not path.startswith("$"):
        return []
    cur = [doc]
    for tok in _re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\*|\d+)\]",
                           path[1:]):
        key, idx = tok
        nxt = []
        for d in cur:
            if key:
                if isinstance(d, dict) and key in d:
                    nxt.append(d[key])
            elif idx == "*":
                if isinstance(d, list):
                    nxt.extend(d)
            else:
                i = int(idx)
                if isinstance(d, list) and i < len(d):
                    nxt.append(d[i])
        cur = nxt
    return cur


_reg("json_path_query_array", _arr(lambda v, p: _jsonpath_eval(v, str(p))),
     n_args=2)
_reg("json_path_query_first",
     lambda v, p: (_jsonpath_eval(v, str(p)) or [None])[0], n_args=2)
_reg("json_path_exists", lambda v, p: bool(_jsonpath_eval(v, str(p))),
     n_args=2, ret=Boolean)
_reg("json_path_match", lambda v, p: bool(_jsonpath_eval(v, str(p))),
     n_args=2, ret=Boolean)


def _jpq_rows(v, p):
    # json_path_query returns a SET of matches; as a scalar column we
    # return the match list (parity shim: full srf form is FLATTEN-able)
    return _jsonpath_eval(v, str(p))


_reg("json_path_query", _jpq_rows, n_args=2)
