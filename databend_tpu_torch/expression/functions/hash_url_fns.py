"""Hash, URL, and IP scalar functions.

Reference: src/query/functions/src/scalars/{hash.rs,string.rs} (md5/sha/
siphash/xxhash/city64), URL functions (domain/path/protocol/...), and the
inet/ip family. Host-side per-row kernels over strings.
"""

from __future__ import annotations

import hashlib
import ipaddress
import urllib.parse

import numpy as np

from ...errors import BadDataValueType
from ...types import Boolean, String, UInt32, UInt64
from ..column import StringData
from .registry import scalar_function
from .string_fns import _as_list, _str_resolver
from .string_more import _register_row


# ---- hashes ----------------------------------------------------------------
_register_row("md5", lambda s: hashlib.md5(s.encode()).hexdigest())
_register_row("sha", lambda s: hashlib.sha1(s.encode()).hexdigest(),
              aliases=["sha1"])
_register_row("sha2", lambda s, bits: getattr(
    hashlib, f"sha{int(bits) or 256}")(s.encode()).hexdigest(), n_args=2)
_register_row("blake3", lambda s: hashlib.blake2b(  # blake2b stand-in
    s.encode(), digest_size=32).hexdigest())


def _xxhash64(s: str) -> int:
    """xxhash64 (seed 0) — the real algorithm, pure python."""
    P1, P2, P3, P4, P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                          0x27D4EB2F165667C5)
    M = (1 << 64) - 1
    data = s.encode()
    n = len(data)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def round_(acc, lane):
        return rotl((acc + lane * P2) & M, 31) * P1 & M

    i = 0
    if n >= 32:
        v1, v2, v3, v4 = ((P1 + P2) & M, P2, 0, (-P1) & M)
        while i + 32 <= n:
            v1 = round_(v1, int.from_bytes(data[i:i + 8], "little"))
            v2 = round_(v2, int.from_bytes(data[i + 8:i + 16], "little"))
            v3 = round_(v3, int.from_bytes(data[i + 16:i + 24], "little"))
            v4 = round_(v4, int.from_bytes(data[i + 24:i + 32], "little"))
            i += 32
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            h = ((h ^ round_(0, v)) * P1 + P4) & M
    else:
        h = (P5) & M
    h = (h + n) & M
    while i + 8 <= n:
        h = (rotl(h ^ round_(0, int.from_bytes(data[i:i + 8], "little")), 27)
             * P1 + P4) & M
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ int.from_bytes(data[i:i + 4], "little") * P1, 23)
             * P2 + P3) & M
        i += 4
    while i < n:
        h = (rotl(h ^ data[i] * P5, 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = h * P2 & M
    h ^= h >> 29
    h = h * P3 & M
    h ^= h >> 32
    return h


_register_row("xxhash64", _xxhash64, ret=UInt64)
_register_row("xxhash32", lambda s: _xxhash64(s) & 0xFFFFFFFF, ret=UInt32)
_register_row("siphash64", lambda s: int.from_bytes(
    hashlib.blake2b(s.encode(), digest_size=8).digest(), "little"),
    ret=UInt64, aliases=["siphash"])
_register_row("city64withseed", lambda s, seed: int.from_bytes(
    hashlib.blake2b(s.encode(), digest_size=8,
                    salt=int(seed).to_bytes(8, "little")).digest(), "little"),
    n_args=2, ret=UInt64)


# ---- URL functions ---------------------------------------------------------
def _u(s):
    return urllib.parse.urlsplit(s if "://" in s else "//" + s)


_register_row("protocol", lambda s: _u(s).scheme)
_register_row("domain", lambda s: _u(s).hostname or "")
_register_row("domain_without_www",
              lambda s: (_u(s).hostname or "").removeprefix("www."),
              aliases=["domainwithoutwww"])
_register_row("port", lambda s: _u(s).port or 0, ret=UInt32)
_register_row("path", lambda s: _u(s).path)
_register_row("query_string", lambda s: _u(s).query, aliases=["query_params"])
_register_row("fragment", lambda s: _u(s).fragment)
_register_row("top_level_domain",
              lambda s: (_u(s).hostname or "").rsplit(".", 1)[-1]
              if "." in (_u(s).hostname or "") else "")
_register_row("url_decode", lambda s: urllib.parse.unquote(s))
_register_row("url_encode", lambda s: urllib.parse.quote(s, safe=""))


@scalar_function("extract_url_parameter",
                 _str_resolver("extract_url_parameter", 2))
def _extract_url_parameter(a, name, **kw):
    out = []
    for s, n in zip(_as_list(a), _as_list(name)):
        qs = urllib.parse.parse_qs(_u(s).query)
        out.append(qs.get(n, [""])[0])
    return StringData.from_pylist(out)


# ---- IP functions ----------------------------------------------------------
def _ipv4_to_num(s):
    try:
        return int(ipaddress.IPv4Address(s.strip()))
    except Exception:
        raise BadDataValueType(f"invalid IPv4 {s[:30]!r}")


_register_row("ipv4_string_to_num", _ipv4_to_num, ret=UInt32,
              aliases=["inet_aton"])
_register_row("ipv4_num_to_string",
              lambda n: str(ipaddress.IPv4Address(int(n))),
              aliases=["inet_ntoa"])


@scalar_function("try_ipv4_string_to_num",
                 _str_resolver("try_ipv4_string_to_num", 1,
                               ret=UInt32.wrap_nullable()),
                 null_policy="custom", aliases=["try_inet_aton"])
def _try_aton(payloads, validities, arg_types, n_rows):
    vals = _as_list(payloads[0])
    v0 = validities[0]
    out = np.zeros(n_rows, np.uint32)
    valid = np.ones(n_rows, np.bool_)
    for i, s in enumerate(vals):
        if v0 is not None and not v0[i]:
            valid[i] = False
            continue
        try:
            out[i] = int(ipaddress.IPv4Address(s.strip()))
        except Exception:
            valid[i] = False
    return out, (None if valid.all() else valid)


@scalar_function("ip_in_cidr", _str_resolver("ip_in_cidr", 2, ret=Boolean))
def _ip_in_cidr(a, cidr, **kw):
    out = np.zeros(len(_as_list(a)), np.bool_)
    for i, (s, c) in enumerate(zip(_as_list(a), _as_list(cidr))):
        try:
            out[i] = (ipaddress.ip_address(s.strip())
                      in ipaddress.ip_network(c.strip(), strict=False))
        except Exception:
            out[i] = False
    return out
