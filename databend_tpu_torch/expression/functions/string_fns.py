"""String scalar functions (reference: src/query/functions/src/scalars/string.rs)."""

from __future__ import annotations

import numpy as np

from ...errors import SemanticError
from ...types import Boolean, Int64, String, StringType, UInt64
from ..column import StringData
from .registry import scalar_function


def _as_list(payload):
    if isinstance(payload, StringData):
        return payload.to_pylist()
    return [str(v) for v in payload.tolist()]


def _str_resolver(name, n_min, n_max=None, ret=String):
    n_max = n_max or n_min

    def resolve(arg_types):
        if not (n_min <= len(arg_types) <= n_max):
            raise SemanticError(f"{name} expects {n_min}..{n_max} args")
        return ret
    return resolve


def _register_map(name, fn, aliases=(), byte_table=None):
    """Per-row python map with an optional ASCII byte-table fast path:
    when the column is pure ASCII, case mapping is ONE 256-entry table
    gather over the whole byte buffer (no decode, offsets reused)."""
    @scalar_function(name, _str_resolver(name, 1), aliases=list(aliases))
    def _k(a, **kw):
        if byte_table is not None and isinstance(a, StringData) \
                and len(a) >= 1024 and a.is_ascii():
            return StringData(a.offsets, byte_table[a.data])
        return StringData.from_pylist([fn(v) for v in _as_list(a)])
    return _k


_UPPER_TABLE = np.arange(256, dtype=np.uint8)
_UPPER_TABLE[ord("a"): ord("z") + 1] -= 32
_LOWER_TABLE = np.arange(256, dtype=np.uint8)
_LOWER_TABLE[ord("A"): ord("Z") + 1] += 32

_register_map("upper", str.upper, aliases=["ucase"], byte_table=_UPPER_TABLE)
_register_map("lower", str.lower, aliases=["lcase"], byte_table=_LOWER_TABLE)
_register_map("trim", str.strip)
_register_map("ltrim", str.lstrip)
_register_map("rtrim", str.rstrip)
_register_map("reverse", lambda s: s[::-1])


@scalar_function("length", _str_resolver("length", 1, ret=UInt64), aliases=["char_length", "character_length"])
def _length(a, **kw):
    if isinstance(a, StringData):
        # bytes length straight off offsets (no decode)
        return (a.offsets[1:] - a.offsets[:-1]).astype(np.uint64)
    return np.array([len(str(v)) for v in a.tolist()], np.uint64)


@scalar_function("concat", _str_resolver("concat", 1, 99))
def _concat(*args, **kw):
    lists = [_as_list(a) for a in args]
    return StringData.from_pylist(["".join(parts) for parts in zip(*lists)])


@scalar_function("concat_ws", _str_resolver("concat_ws", 2, 99))
def _concat_ws(sep, *args, **kw):
    seps = _as_list(sep)
    lists = [_as_list(a) for a in args]
    return StringData.from_pylist([s.join(parts) for s, *parts in zip(seps, *lists)])


@scalar_function("substr", _str_resolver("substr", 2, 3), aliases=["substring", "mid"])
def _substr(a, start, length=None, **kw):
    starts = np.asarray(start).astype(np.int64)
    lens = None if length is None else np.asarray(length).astype(np.int64)
    if isinstance(a, StringData) and a.is_ascii():
        # byte == char for ASCII: vectorized bounds + one native slice
        # copy (no per-row Python)
        from ... import native
        n = len(a)
        row_len = a.offsets[1:] - a.offsets[:-1]
        sv = starts if starts.ndim else np.full(n, int(starts), np.int64)
        begin = np.where(sv > 0, sv - 1,
                         np.where(sv < 0, np.maximum(row_len + sv, 0), 0))
        begin = np.minimum(begin, row_len)
        if lens is None:
            out_len = row_len - begin
        else:
            lv = lens if lens.ndim else np.full(n, int(lens), np.int64)
            out_len = np.minimum(np.maximum(lv, 0), row_len - begin)
        res = native.copy_slices(a.data, a.offsets[:-1] + begin, out_len)
        if res is not None:
            return StringData(res[0], res[1])
    vals = _as_list(a)
    out = []
    for i, v in enumerate(vals):
        s = int(starts[i] if starts.ndim else starts)
        # SQL 1-based; negative counts from the end
        if s > 0:
            begin = s - 1
        elif s < 0:
            begin = max(len(v) + s, 0)
        else:
            begin = 0
        if lens is None:
            out.append(v[begin:])
        else:
            ln = int(lens[i] if lens.ndim else lens)
            out.append(v[begin: begin + max(ln, 0)])
    return StringData.from_pylist(out)


@scalar_function("replace", _str_resolver("replace", 3))
def _replace(a, from_, to, **kw):
    return StringData.from_pylist(
        [v.replace(f, t) for v, f, t in zip(_as_list(a), _as_list(from_), _as_list(to))])


@scalar_function("split", _str_resolver("split", 2))
def _split(a, sep, **kw):
    # returns ARRAY(STRING) encoded as object ndarray of lists
    return np.array([v.split(s) if s else [v] for v, s in zip(_as_list(a), _as_list(sep))],
                    dtype=object)


@scalar_function("position", _str_resolver("position", 2, ret=UInt64), aliases=["locate"])
def _position(sub, a, **kw):
    return np.array([v.find(s) + 1 for s, v in zip(_as_list(sub), _as_list(a))], np.uint64)


@scalar_function("instr", _str_resolver("instr", 2, ret=UInt64))
def _instr(a, sub, **kw):
    """MySQL arg order: instr(str, substr)."""
    return np.array([v.find(s) + 1 for v, s in zip(_as_list(a), _as_list(sub))], np.uint64)


@scalar_function("left", _str_resolver("left", 2))
def _left(a, n, **kw):
    ns = np.asarray(n).astype(np.int64)
    return StringData.from_pylist([v[: max(int(k), 0)] for v, k in zip(_as_list(a), ns)])


@scalar_function("right", _str_resolver("right", 2))
def _right(a, n, **kw):
    ns = np.asarray(n).astype(np.int64)
    return StringData.from_pylist([v[-int(k):] if int(k) > 0 else "" for v, k in zip(_as_list(a), ns)])


@scalar_function("lpad", _str_resolver("lpad", 3))
def _lpad(a, n, pad, **kw):
    ns = np.asarray(n).astype(np.int64)
    out = []
    for v, k, p in zip(_as_list(a), ns, _as_list(pad)):
        k = int(k)
        if len(v) >= k:
            out.append(v[:k])
        else:
            fill = (p * k)[: k - len(v)] if p else ""
            out.append(fill + v)
    return StringData.from_pylist(out)


@scalar_function("rpad", _str_resolver("rpad", 3))
def _rpad(a, n, pad, **kw):
    ns = np.asarray(n).astype(np.int64)
    out = []
    for v, k, p in zip(_as_list(a), ns, _as_list(pad)):
        k = int(k)
        if len(v) >= k:
            out.append(v[:k])
        else:
            fill = (p * k)[: k - len(v)] if p else ""
            out.append(v + fill)
    return StringData.from_pylist(out)


@scalar_function("repeat", _str_resolver("repeat", 2))
def _repeat(a, n, **kw):
    ns = np.asarray(n).astype(np.int64)
    return StringData.from_pylist([v * max(int(k), 0) for v, k in zip(_as_list(a), ns)])


@scalar_function("starts_with", _str_resolver("starts_with", 2, ret=Boolean))
def _starts_with(a, prefix, **kw):
    return np.array([v.startswith(p) for v, p in zip(_as_list(a), _as_list(prefix))], np.bool_)


@scalar_function("ends_with", _str_resolver("ends_with", 2, ret=Boolean))
def _ends_with(a, suffix, **kw):
    return np.array([v.endswith(p) for v, p in zip(_as_list(a), _as_list(suffix))], np.bool_)


@scalar_function("to_string", _str_resolver("to_string", 1))
def _to_string(a, arg_types=None, **kw):
    if isinstance(a, StringData):
        return a
    return StringData.from_pylist([_fmt(v) for v in a.tolist()])


def _fmt(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return str(v)
