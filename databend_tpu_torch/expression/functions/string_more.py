"""Extended string functions: codecs, regexp, edit distances, padding.

Reference: src/query/functions/src/scalars/{string.rs,string_multi_args.rs}.
Host-side per-row kernels — strings never enter device programs.
"""

from __future__ import annotations

import base64
import binascii
import fnmatch
import re

import numpy as np

from ...errors import BadDataValueType, SemanticError
from ...types import Boolean, Float64, Int64, String, UInt64, UInt8
from ..column import StringData
from .registry import scalar_function
from .string_fns import _as_list, _str_resolver


def _register_row(name, fn, n_args=1, ret=String, aliases=()):
    """Register an n-ary per-row string kernel returning `ret`."""

    @scalar_function(name, _str_resolver(name, n_args, ret=ret),
                     aliases=list(aliases))
    def _k(*args, n_rows=None, **kw):
        cols = [_as_list(a) if isinstance(a, StringData)
                else np.asarray(a).tolist() for a in args[:n_args]]
        vals = [fn(*row) for row in zip(*cols)] if cols else [fn()] * n_rows
        if ret is String:
            return StringData.from_pylist([str(v) for v in vals])
        return np.array(vals, ret.numpy_dtype())
    return _k


# ---- character codecs -------------------------------------------------------

_register_row("ascii", lambda s: ord(s[0]) if s else 0, ret=UInt8)
_register_row("ord", lambda s: ord(s[0]) if s else 0, ret=UInt64)
_register_row("bit_length", lambda s: 8 * len(s.encode()), ret=UInt64)
_register_row("octet_length", lambda s: len(s.encode()), ret=UInt64)
_register_row("quote", lambda s: s.replace("\\", "\\\\").replace("'", "\\'"))
_register_row("space", lambda n: " " * max(int(n), 0))


@scalar_function("char", _str_resolver("char", 1, 99), aliases=["chr"])
def _char(*args, **kw):
    cols = [np.asarray(a).tolist() for a in args]
    return StringData.from_pylist(
        ["".join(chr(int(c) % 256) for c in row) for row in zip(*cols)])


_register_row("to_hex", lambda s: s.encode().hex(), ret=String, aliases=["hex"])
_register_row("to_base64", lambda s: base64.b64encode(s.encode()).decode())


def _from_hex(s):
    try:
        return bytes.fromhex(s).decode("utf-8", "replace")
    except ValueError:
        raise BadDataValueType(f"from_hex: invalid hex {s[:40]!r}")


def _from_base64(s):
    try:
        return base64.b64decode(s, validate=True).decode("utf-8", "replace")
    except (binascii.Error, ValueError):
        raise BadDataValueType(f"from_base64: invalid base64 {s[:40]!r}")


_register_row("from_hex", _from_hex, aliases=["unhex"])
_register_row("from_base64", _from_base64)


def _register_try(name, fn):
    @scalar_function(f"try_{name}", _str_resolver(f"try_{name}", 1,
                     ret=String.wrap_nullable()), null_policy="custom")
    def _k(payloads, validities, arg_types, n_rows):
        texts = _as_list(payloads[0])
        v0 = validities[0]
        out, valid = [], np.ones(n_rows, np.bool_)
        for i, t in enumerate(texts):
            ok = v0 is None or v0[i]
            if ok:
                try:
                    out.append(fn(t))
                    continue
                except Exception:
                    pass
            out.append("")
            valid[i] = False
        return StringData.from_pylist(out), (None if valid.all() else valid)
    return _k


_register_try("from_hex", _from_hex)
_register_try("from_base64", _from_base64)


# ---- structural edits -------------------------------------------------------

def _translate(s, frm, to):
    table = {ord(f): (to[i] if i < len(to) else None)
             for i, f in enumerate(frm)}
    return s.translate(table)


_register_row("translate", _translate, n_args=3)


def _insert(s, pos, length, sub):
    p = int(pos)
    if p < 1 or p > len(s):
        return s
    return s[: p - 1] + sub + s[p - 1 + max(int(length), 0):]


_register_row("insert", _insert, n_args=4)
_register_row("strcmp", lambda a, b: (a > b) - (a < b), n_args=2, ret=Int64)


def _split_part(s, sep, n):
    if not sep:
        return s if int(n) in (1, -1) else ""
    parts = s.split(sep)
    i = int(n)
    if i > 0:
        return parts[i - 1] if i <= len(parts) else ""
    if i < 0:
        return parts[i] if -i <= len(parts) else ""
    return ""


_register_row("split_part", _split_part, n_args=3)


def _substring_index(s, sep, n):
    n = int(n)
    if not sep or n == 0:
        return ""
    parts = s.split(sep)
    if n > 0:
        return sep.join(parts[:n])
    return sep.join(parts[n:])


_register_row("substring_index", _substring_index, n_args=3)


# trim variants with an explicit trim-character set
_register_row("trim_both", lambda s, c: s.strip(c) if c else s, n_args=2)
_register_row("trim_leading", lambda s, c: s.lstrip(c) if c else s, n_args=2)
_register_row("trim_trailing", lambda s, c: s.rstrip(c) if c else s, n_args=2)


_SOUNDEX = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
            **{c: "3" for c in "DT"}, "L": "4",
            **{c: "5" for c in "MN"}, "R": "6"}


def _soundex(s):
    s = "".join(c for c in s.upper() if c.isalpha())
    if not s:
        return ""
    out, prev = s[0], _SOUNDEX.get(s[0], "")
    for c in s[1:]:
        code = _SOUNDEX.get(c, "")
        if code and code != prev:
            out += code
            if len(out) == 4:
                break
        if c not in "HW":
            prev = code
    return out.ljust(4, "0")


_register_row("soundex", _soundex)


def _levenshtein(a, b):
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


_register_row("editdistance", _levenshtein, n_args=2, ret=UInt64,
              aliases=["levenshtein"])


def _jaro_winkler(a, b):
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    window = max(len(a), len(b)) // 2 - 1
    ma = [False] * len(a)
    mb = [False] * len(b)
    matches = 0
    for i, ca in enumerate(a):
        lo, hi = max(0, i - window), min(len(b), i + window + 1)
        for j in range(lo, hi):
            if not mb[j] and b[j] == ca:
                ma[i] = mb[j] = True
                matches += 1
                break
    if not matches:
        return 0.0
    t = 0
    k = 0
    for i in range(len(a)):
        if ma[i]:
            while not mb[k]:
                k += 1
            if a[i] != b[k]:
                t += 1
            k += 1
    jaro = (matches / len(a) + matches / len(b)
            + (matches - t / 2) / matches) / 3
    prefix = 0
    for ca, cb in zip(a[:4], b[:4]):
        if ca != cb:
            break
        prefix += 1
    return jaro + prefix * 0.1 * (1 - jaro)


_register_row("jaro_winkler", _jaro_winkler, n_args=2, ret=Float64)
_register_row("glob", lambda s, pat: fnmatch.fnmatchcase(s, pat),
              n_args=2, ret=Boolean)


# ---- LIKE families ----------------------------------------------------------

def _like_to_re(pat, flags=0):
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "\\" and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("(?s)^" + "".join(out) + "$", flags)


def _any_matcher(name, flags):
    @scalar_function(name, _str_resolver(name, 2, 99, ret=Boolean))
    def _k(a, *pats, **kw):
        vals = _as_list(a)
        pat_cols = [_as_list(p) for p in pats]
        out = np.zeros(len(vals), np.bool_)
        cache = {}
        for i, v in enumerate(vals):
            for col in pat_cols:
                p = col[i]
                rx = cache.get((p, flags))
                if rx is None:
                    rx = cache[(p, flags)] = _like_to_re(p, flags)
                if rx.match(v):
                    out[i] = True
                    break
        return out
    return _k


_any_matcher("like_any", 0)
_any_matcher("ilike_any", re.IGNORECASE)


# ---- regexp family ----------------------------------------------------------

def _rx(pat, cache):
    r = cache.get(pat)
    if r is None:
        try:
            r = cache[pat] = re.compile(pat)
        except re.error as e:
            raise BadDataValueType(f"invalid regexp {pat!r}: {e}")
    return r


@scalar_function("regexp_like", _str_resolver("regexp_like", 2, 3, ret=Boolean))
def _regexp_like(a, pat, flags=None, **kw):
    p0 = _const_str(pat)
    if flags is None and p0 is not None:
        codes, uniq = _dict_uniques(a)
        if len(uniq) < max(len(codes) // 2, 2):
            rx = _rx(p0, {})
            hit = np.array([rx.search(v) is not None for v in uniq],
                           np.bool_)
            return hit[codes]
    vals, pats = _as_list(a), _as_list(pat)
    fl = _as_list(flags) if flags is not None else [""] * len(vals)
    cache = {}
    out = np.zeros(len(vals), np.bool_)
    for i, (v, p, f) in enumerate(zip(vals, pats, fl)):
        if "i" in f:
            p = "(?i)" + p
        out[i] = _rx(p, cache).search(v) is not None
    return out


def _const_str(x):
    """The broadcast literal behind a constant StringData, else None."""
    if isinstance(x, StringData):
        return getattr(x, "_const_value", None)
    return None


def _dict_uniques(a):
    """(codes, unique_values) over a string payload — the dictionary-
    execution trick: run an expensive per-row function over DISTINCT
    values only, then fan results back out with one vectorized take.
    Uses the native byte-level factorizer when available (no per-row
    decode at all: only the uniques get decoded)."""
    import pandas as pd
    if isinstance(a, StringData):
        codes = a.codes()
        if codes is not None:
            n_u = int(codes.max()) + 1 if len(codes) else 0
            rep = np.empty(n_u, np.int64)
            rep[codes[::-1]] = np.arange(len(codes) - 1, -1, -1)
            return codes, [a.get(int(i)) for i in rep]
        arr = a.as_object_array()
    else:
        arr = np.asarray(_as_list(a), object)
    codes, uniq = pd.factorize(arr)
    return codes, uniq.tolist()


@scalar_function("regexp_replace", _str_resolver("regexp_replace", 3, 6))
def _regexp_replace(a, pat, rep, pos=None, occ=None, flags=None, **kw):
    p0, r0 = _const_str(pat), _const_str(rep)
    if pos is None and occ is None and flags is None \
            and p0 is not None and r0 is not None:
        codes, uniq = _dict_uniques(a)
        if len(uniq) < max(len(codes) // 2, 2):
            rx = _rx(p0, {})
            mapped = StringData.from_pylist([rx.sub(r0, v) for v in uniq])
            return mapped.take(codes)
    vals, pats, reps = _as_list(a), _as_list(pat), _as_list(rep)
    n = len(vals)
    poss = np.asarray(pos).tolist() if pos is not None else [1] * n
    occs = np.asarray(occ).tolist() if occ is not None else [0] * n
    cache = {}
    out = []
    for v, p, r, s, o in zip(vals, pats, reps, poss, occs):
        rx = _rx(p, cache)
        s = max(int(s), 1) - 1
        # MySQL-style backrefs \\1 -> re's \1 are already compatible
        head, tail = v[:s], v[s:]
        o = int(o)
        if o <= 0:
            tail = rx.sub(r, tail)
        else:
            # replace only the o-th occurrence
            cnt = 0

            def _one(m):
                nonlocal cnt
                cnt += 1
                return m.expand(r) if cnt == o else m.group(0)
            tail = rx.sub(_one, tail)
        out.append(head + tail)
    return StringData.from_pylist(out)


@scalar_function("regexp_substr", _str_resolver("regexp_substr", 2, 4,
                 ret=String.wrap_nullable()), null_policy="custom")
def _regexp_substr(payloads, validities, arg_types, n_rows):
    vals = _as_list(payloads[0])
    pats = _as_list(payloads[1])
    poss = (np.asarray(payloads[2]).tolist() if len(payloads) > 2
            else [1] * n_rows)
    occs = (np.asarray(payloads[3]).tolist() if len(payloads) > 3
            else [1] * n_rows)
    cache = {}
    out, valid = [], np.ones(n_rows, np.bool_)
    for i in range(n_rows):
        if any(v is not None and not v[i] for v in validities):
            out.append("")
            valid[i] = False
            continue
        rx = _rx(pats[i], cache)
        s = max(int(poss[i]), 1) - 1
        ms = list(rx.finditer(vals[i][s:]))
        o = int(occs[i])
        if 1 <= o <= len(ms):
            out.append(ms[o - 1].group(0))
        else:
            out.append("")
            valid[i] = False
    return StringData.from_pylist(out), (None if valid.all() else valid)


@scalar_function("regexp_instr", _str_resolver("regexp_instr", 2, 4, ret=UInt64))
def _regexp_instr(a, pat, pos=None, occ=None, **kw):
    vals, pats = _as_list(a), _as_list(pat)
    n = len(vals)
    poss = np.asarray(pos).tolist() if pos is not None else [1] * n
    occs = np.asarray(occ).tolist() if occ is not None else [1] * n
    cache = {}
    out = np.zeros(n, np.uint64)
    for i in range(n):
        rx = _rx(pats[i], cache)
        s = max(int(poss[i]), 1) - 1
        ms = list(rx.finditer(vals[i][s:]))
        o = int(occs[i])
        if 1 <= o <= len(ms):
            out[i] = ms[o - 1].start() + s + 1
    return out


@scalar_function("regexp_extract", _str_resolver("regexp_extract", 2, 3))
def _regexp_extract(a, pat, group=None, **kw):
    vals, pats = _as_list(a), _as_list(pat)
    groups = (np.asarray(group).tolist() if group is not None
              else [1] * len(vals))
    cache = {}
    out = []
    for v, p, g in zip(vals, pats, groups):
        m = _rx(p, cache).search(v)
        g = int(g)
        if m and 0 <= g <= m.re.groups:
            out.append(m.group(g) or "")
        else:
            out.append("")
    return StringData.from_pylist(out)
