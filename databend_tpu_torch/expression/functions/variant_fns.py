"""VARIANT (JSON) scalar functions.

Reference: the jsonb-backed variant function family
(src/query/functions/src/scalars/variant.rs): parse_json, get (`->`),
get_string (`->>`), json_typeof, json_array_length, etc. Values are
canonical JSON text in StringData payloads (host-side; never on device).
"""

from __future__ import annotations

import json

import numpy as np

from ...errors import BadDataValueType, SemanticError
from ...types import Int64, String, Variant, VariantType
from ..column import StringData
from .registry import scalar_function


def _texts(payload):
    if isinstance(payload, StringData):
        return payload.to_pylist()
    from ..column import Column as _Col
    if isinstance(payload, tuple) and len(payload) == 2 \
            and isinstance(payload[1], _Col):
        # typed ARRAY column (CSR: offsets + values): rebuild rows as JSON
        offs = np.asarray(payload[0])
        vals = payload[1].to_pylist()
        return [json.dumps(vals[offs[i]:offs[i + 1]], default=str, separators=(",", ":"), ensure_ascii=False)
                for i in range(len(offs) - 1)]
    if isinstance(payload, np.ndarray) and payload.dtype == object:
        return [json.dumps(v, default=str, separators=(",", ":"), ensure_ascii=False)
                if isinstance(v, (list, tuple, dict)) else str(v)
                for v in payload]
    return [str(v) for v in payload.tolist()]


def _variant_resolver(name, n, ret):
    def resolve(arg_types):
        if len(arg_types) != n:
            raise SemanticError(f"{name} expects {n} args")
        return ret.wrap_nullable()
    return resolve


def _lenient_json(text: str):
    """Tolerant JSON in the reference's jsonb dialect: unquoted object
    keys, single-quoted strings, hex numbers (incl. hex fractions),
    '+1'/'1.'/'.2'/leading zeros, elided array elements -> null,
    case-insensitive null/true/false, nan/infinity -> null, arbitrary-
    precision integers preserved. Raises ValueError on hard errors."""
    s = text
    n = len(s)
    i = 0

    def ws(j):
        while j < n and s[j] in " \t\r\n":
            j += 1
        return j

    def ident_char(c):
        return c.isalnum() or c in "_$" or ord(c) > 127

    def parse_word(j):
        k = j
        while k < n and (ident_char(s[k]) or s[k] in "+-."):
            k += 1
        w = s[j:k].lower().lstrip("+-")
        if w in ("null", "nan", "infinity", "inf"):
            return None, k
        if w == "true":
            return True, k
        if w == "false":
            return False, k
        raise ValueError(f"bad token at {j}")

    def parse_number(j):
        k = j
        if k < n and s[k] in "+-":
            k += 1
        neg = s[j] == "-"
        if k + 1 < n and s[k] == "0" and s[k + 1] in "xX":
            k += 2
        else:
            while k < n and (s[k].isdigit() or s[k] in ".eE"
                             or (s[k] in "+-" and s[k - 1] in "eE")):
                k += 1
            body = s[j:k].lstrip("+")
            if body in ("", "-", "+"):
                raise ValueError(f"bad number at {j}")
            if "." in body or "e" in body.lower():
                frac = body.rstrip(".")
                if frac.startswith("."):
                    frac = "0" + frac
                elif frac.startswith("-."):
                    frac = "-0" + frac[1:]
                v = float(frac)
                return (int(v) if v == int(v) and "." in body
                        and body.rstrip(".") == body[:-1] else v), k
            return int(body), k
        # hex (optionally fractional: 0xABC.DEF)
        h = k
        while k < n and (s[k] in "0123456789abcdefABCDEF"):
            k += 1
        ipart = int(s[h:k] or "0", 16)
        if k < n and s[k] == ".":
            k += 1
            f = k
            while k < n and s[k] in "0123456789abcdefABCDEF":
                k += 1
            fdigits = s[f:k]
            val = ipart + int(fdigits or "0", 16) / (16 ** len(fdigits))
            return (-val if neg else val), k
        return (-ipart if neg else ipart), k

    def parse_string(j):
        q = s[j]
        j += 1
        out = []
        while j < n:
            c = s[j]
            if c == "\\":
                if j + 1 >= n:
                    raise ValueError("unterminated escape")
                e = s[j + 1]
                mapped = {"n": "\n", "t": "\t", "r": "\r", "b": "\b",
                          "f": "\f", "/": "/", "\\": "\\", '"': '"',
                          "'": "'"}.get(e)
                if e == "u":
                    out.append(chr(int(s[j + 2:j + 6], 16)))
                    j += 6
                    continue
                out.append(mapped if mapped is not None else e)
                j += 2
                continue
            if c == q:
                return "".join(out), j + 1
            out.append(c)
            j += 1
        raise ValueError("unterminated string")

    def parse_value(j):
        j = ws(j)
        if j >= n:
            raise ValueError("empty value")
        c = s[j]
        if c == "{":
            obj = {}
            j = ws(j + 1)
            if j < n and s[j] == "}":
                return obj, j + 1
            while True:
                j = ws(j)
                if j >= n:
                    raise ValueError("unterminated object")
                if s[j] in "\"'":
                    key, j = parse_string(j)
                else:
                    k0 = j
                    while j < n and ident_char(s[j]):
                        j += 1
                    if j == k0:
                        raise ValueError(f"bad object key at {j}")
                    key = s[k0:j]
                j = ws(j)
                if j >= n or s[j] != ":":
                    raise ValueError("expected ':' in object")
                v, j = parse_value(j + 1)
                obj[key] = v
                j = ws(j)
                if j < n and s[j] == ",":
                    j += 1
                    continue
                if j < n and s[j] == "}":
                    return obj, j + 1
                raise ValueError("unterminated object")
        if c == "[":
            arr = []
            j += 1
            pending = True  # an elided element before ',' or ']' is null
            while True:
                j = ws(j)
                if j >= n:
                    raise ValueError("unterminated array")
                if s[j] == "]":
                    if pending and arr:
                        arr.append(None)
                    return arr, j + 1
                if s[j] == ",":
                    if pending:
                        arr.append(None)  # elided element
                    j += 1
                    pending = True
                    continue
                v, j = parse_value(j)
                arr.append(v)
                pending = False
                j = ws(j)
                if j < n and s[j] == ",":
                    j += 1
                    pending = True
                    continue
                if j < n and s[j] == "]":
                    return arr, j + 1
                raise ValueError("unterminated array")
        if c in "\"'":
            return parse_string(j)
        if c.isdigit() or c in "+-.":
            nxt = s[j + 1] if j + 1 < n else ""
            w = s[j:j + 10].lower().lstrip("+-")
            if w.startswith(("inf", "nan")):
                return parse_word(j)
            if c in "+-" and not (nxt.isdigit() or nxt == "."):
                return parse_word(j)
            return parse_number(j)
        return parse_word(j)

    i = ws(i)
    if i >= n:
        return None
    v, i = parse_value(i)
    i = ws(i)
    if i != n:
        raise ValueError(f"trailing characters at {i}")
    return v


@scalar_function("parse_json", _variant_resolver("parse_json", 1, Variant),
                 null_policy="custom")
def _parse_json(payloads, validities, arg_types, n_rows):
    from ...errors import BadArguments
    texts = _texts(payloads[0])
    v0 = validities[0]
    out, valid = [], np.ones(n_rows, np.bool_)
    for i, t in enumerate(texts):
        if t is None or (v0 is not None and not v0[i]):
            out.append("")
            valid[i] = False
            continue
        try:
            v = json.loads(t)
        except (ValueError, TypeError):
            try:
                v = _lenient_json(t)
            except (ValueError, TypeError):
                # reference error class: 1006 BadArguments
                raise BadArguments(f"parse_json: invalid JSON {t[:60]!r}")
        out.append(json.dumps(v, separators=(",", ":"),
                              ensure_ascii=False))
    return StringData.from_pylist(out), (None if valid.all() else valid)


@scalar_function("try_parse_json",
                 _variant_resolver("try_parse_json", 1, Variant),
                 null_policy="custom")
def _try_parse_json(payloads, validities, arg_types, n_rows):
    texts = _texts(payloads[0])
    v0 = validities[0]
    out, valid = [], np.ones(n_rows, np.bool_)
    for i, t in enumerate(texts):
        ok = t is not None and (v0 is None or v0[i])
        if ok:
            try:
                out.append(json.dumps(json.loads(t), separators=(",", ":"), ensure_ascii=False))
                continue
            except (ValueError, TypeError):
                pass
        out.append("")
        valid[i] = False
    return StringData.from_pylist(out), (None if valid.all() else valid)


def _get_impl(payloads, validities, n_rows, as_text: bool):
    docs = _texts(payloads[0])
    keys = payloads[1]
    key_list = (_texts(keys) if isinstance(keys, StringData)
                else keys.tolist())
    v0, v1 = validities
    out, valid = [], np.ones(n_rows, np.bool_)
    for i in range(n_rows):
        if (v0 is not None and not v0[i]) or (v1 is not None and not v1[i]):
            out.append("")
            valid[i] = False
            continue
        try:
            doc = json.loads(docs[i])
        except (ValueError, TypeError):
            out.append("")
            valid[i] = False
            continue
        k = key_list[i]
        val = None
        if isinstance(doc, dict) and isinstance(k, str):
            val = doc.get(k)
            found = k in doc
        elif isinstance(doc, list) and not isinstance(k, str):
            ki = int(k)
            found = -len(doc) <= ki < len(doc)
            val = doc[ki] if found else None
        else:
            found = False
        if not found:
            out.append("")
            valid[i] = False
            continue
        if as_text:
            out.append(val if isinstance(val, str) else json.dumps(val, separators=(",", ":"), ensure_ascii=False))
        else:
            out.append(json.dumps(val, separators=(",", ":"), ensure_ascii=False))
    return StringData.from_pylist(out), (None if valid.all() else valid)


@scalar_function("json_get", _variant_resolver("json_get", 2, Variant),
                 null_policy="custom", aliases=["get"])
def _json_get(payloads, validities, arg_types, n_rows):
    return _get_impl(payloads, validities, n_rows, as_text=False)


@scalar_function("json_get_text",
                 _variant_resolver("json_get_text", 2, String),
                 null_policy="custom", aliases=["get_string"])
def _json_get_text(payloads, validities, arg_types, n_rows):
    return _get_impl(payloads, validities, n_rows, as_text=True)


@scalar_function("json_typeof", _variant_resolver("json_typeof", 1, String),
                 null_policy="custom")
def _json_typeof(payloads, validities, arg_types, n_rows):
    texts = _texts(payloads[0])
    v0 = validities[0]
    names = {dict: "object", list: "array", str: "string", bool: "boolean",
             int: "number", float: "number", type(None): "null"}
    out, valid = [], np.ones(n_rows, np.bool_)
    for i, t in enumerate(texts):
        if t is None or (v0 is not None and not v0[i]):
            out.append("")
            valid[i] = False
            continue
        try:
            out.append(names[type(json.loads(t))])
        except (ValueError, TypeError, KeyError):
            out.append("")
            valid[i] = False
    return StringData.from_pylist(out), (None if valid.all() else valid)


@scalar_function("json_array_length",
                 _variant_resolver("json_array_length", 1, Int64),
                 null_policy="custom")
def _json_array_length(payloads, validities, arg_types, n_rows):
    texts = _texts(payloads[0])
    v0 = validities[0]
    out = np.zeros(n_rows, np.int64)
    valid = np.ones(n_rows, np.bool_)
    for i, t in enumerate(texts):
        ok = t is not None and (v0 is None or v0[i])
        doc = None
        if ok:
            try:
                doc = json.loads(t)
            except (ValueError, TypeError):
                doc = None
        if isinstance(doc, list):
            out[i] = len(doc)
        else:
            valid[i] = False
    return out, (None if valid.all() else valid)
