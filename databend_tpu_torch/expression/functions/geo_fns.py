"""Geometry scalar functions (WKT-backed).

Reference: the geometry function family (src/query/functions/src/scalars/
geometry.rs, geozero-backed). Honest subset: POINT construction/accessors,
euclidean st_distance, WKT round-trip, bbox containment (the predicate the
spatial index prunes on) and haversine distance for (lon, lat) points.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

import numpy as np

from ...errors import BadDataValueType, SemanticError
from ...types import Boolean, Float64, Geometry, String
from ..column import StringData
from .registry import scalar_function

_POINT_RE = re.compile(
    r"^\s*POINT\s*\(\s*(-?[0-9.eE+]+)\s+(-?[0-9.eE+]+)\s*\)\s*$", re.I)


def parse_point(wkt: Optional[str]) -> Optional[Tuple[float, float]]:
    if wkt is None:
        return None
    m = _POINT_RE.match(wkt)
    if m is None:
        return None
    return float(m.group(1)), float(m.group(2))


def _texts(payload):
    if isinstance(payload, StringData):
        return payload.to_pylist()
    return [str(v) for v in payload.tolist()]


def _geo_resolver(name, n, ret):
    def resolve(arg_types):
        if len(arg_types) != n:
            raise SemanticError(f"{name} expects {n} args")
        return ret.wrap_nullable() if ret is not Geometry else ret
    return resolve


@scalar_function("st_makepoint", _geo_resolver("st_makepoint", 2, Geometry),
                 aliases=["st_point"])
def _st_makepoint(x, y, **kw):
    xs = np.asarray(x, np.float64)
    ys = np.asarray(y, np.float64)
    return StringData.from_pylist(
        [f"POINT({a:.10g} {b:.10g})" for a, b in zip(xs.tolist(), ys.tolist())])


def _coord_kernel(idx):
    def kernel(payloads, validities, arg_types, n_rows):
        out = np.zeros(n_rows, np.float64)
        valid = np.ones(n_rows, np.bool_)
        v0 = validities[0]
        for i, w in enumerate(_texts(payloads[0])):
            if v0 is not None and not v0[i]:
                valid[i] = False
                continue
            p = parse_point(w)
            if p is None:
                valid[i] = False
            else:
                out[i] = p[idx]
        return out, (None if valid.all() else valid)
    return kernel


scalar_function("st_x", _geo_resolver("st_x", 1, Float64),
                null_policy="custom")(_coord_kernel(0))
scalar_function("st_y", _geo_resolver("st_y", 1, Float64),
                null_policy="custom")(_coord_kernel(1))


@scalar_function("st_aswkt", _geo_resolver("st_aswkt", 1, String),
                 aliases=["st_astext"])
def _st_aswkt(g, **kw):
    return StringData.from_pylist(_texts(g))


@scalar_function("st_geometryfromwkt",
                 _geo_resolver("st_geometryfromwkt", 1, Geometry),
                 aliases=["st_geomfromtext", "to_geometry"])
def _st_fromwkt(s, **kw):
    return StringData.from_pylist([t.strip() for t in _texts(s)])


@scalar_function("st_distance", _geo_resolver("st_distance", 2, Float64),
                 null_policy="custom")
def _st_distance(payloads, validities, arg_types, n_rows):
    from .. import geometry as G
    a = _texts(payloads[0])
    b = _texts(payloads[1])
    va, vb = validities
    out = np.zeros(n_rows, np.float64)
    valid = np.ones(n_rows, np.bool_)
    for i in range(n_rows):
        if (va is not None and not va[i]) or (vb is not None and not vb[i]):
            valid[i] = False
            continue
        pa_, pb_ = parse_point(a[i]), parse_point(b[i])
        if pa_ is not None and pb_ is not None:  # fast path: two points
            out[i] = math.hypot(pa_[0] - pb_[0], pa_[1] - pb_[1])
            continue
        try:
            ka, ca = G.parse_wkt(a[i])
            kb, cb = G.parse_wkt(b[i])
            out[i] = G.distance(ka, ca, kb, cb)
        except Exception:
            valid[i] = False
    return out, (None if valid.all() else valid)


# ---- general geometry kinds (expression/geometry.py core) -----------------
def _geo_unary(name, fn, ret, aliases=()):
    """Register geom -> scalar via the WKT core; invalid WKT -> NULL."""
    from .. import geometry as G

    @scalar_function(name, _geo_resolver(name, 1, ret),
                     null_policy="custom", aliases=list(aliases))
    def _k(payloads, validities, arg_types, n_rows):
        v0 = validities[0]
        texts = _texts(payloads[0])
        vals = []
        valid = np.ones(n_rows, np.bool_)
        for i in range(n_rows):
            if v0 is not None and not v0[i]:
                vals.append(None)
                valid[i] = False
                continue
            try:
                vals.append(fn(G, *G.parse_wkt(texts[i])))
            except Exception:
                vals.append(None)
                valid[i] = False
        if ret is String or ret is Geometry:
            payload = StringData.from_pylist([v or "" for v in vals])
        else:
            payload = np.array([v if v is not None else 0 for v in vals],
                               ret.numpy_dtype())
        return payload, (None if valid.all() else valid)
    return _k


_geo_unary("st_geometrytype", lambda G, k, c: k, String)
_geo_unary("st_npoints", lambda G, k, c: G.npoints(k, c), Float64,
           aliases=["st_numpoints"])
_geo_unary("st_dimension", lambda G, k, c: G.dimension(k, c), Float64)
_geo_unary("st_length", lambda G, k, c: G.length(k, c)
           if k in ("LINESTRING", "MULTILINESTRING", "GEOMETRYCOLLECTION")
           else 0.0, Float64)
_geo_unary("st_perimeter", lambda G, k, c: G.length(k, c)
           if k in ("POLYGON", "MULTIPOLYGON") else 0.0, Float64)
_geo_unary("st_area", lambda G, k, c: G.area(k, c), Float64)
_geo_unary("st_centroid",
           lambda G, k, c: G.to_wkt("POINT", G.centroid(k, c)), Geometry)
_geo_unary("st_xmin", lambda G, k, c: G.bbox(k, c)[0], Float64)
_geo_unary("st_ymin", lambda G, k, c: G.bbox(k, c)[1], Float64)
_geo_unary("st_xmax", lambda G, k, c: G.bbox(k, c)[2], Float64)
_geo_unary("st_ymax", lambda G, k, c: G.bbox(k, c)[3], Float64)


def _geo_binary_pred(name, fn, aliases=()):
    from .. import geometry as G

    @scalar_function(name, _geo_resolver(name, 2, Boolean),
                     null_policy="custom", aliases=list(aliases))
    def _k(payloads, validities, arg_types, n_rows):
        va, vb = validities
        a = _texts(payloads[0])
        b = _texts(payloads[1])
        out = np.zeros(n_rows, np.bool_)
        valid = np.ones(n_rows, np.bool_)
        for i in range(n_rows):
            if (va is not None and not va[i]) or (vb is not None and not vb[i]):
                valid[i] = False
                continue
            try:
                ka, ca = G.parse_wkt(a[i])
                kb, cb = G.parse_wkt(b[i])
                out[i] = fn(G, ka, ca, kb, cb)
            except Exception:
                valid[i] = False
        return out, (None if valid.all() else valid)
    return _k


_geo_binary_pred("st_contains", lambda G, ka, ca, kb, cb: G.contains(ka, ca, kb, cb))
_geo_binary_pred("st_within", lambda G, ka, ca, kb, cb: G.contains(kb, cb, ka, ca))
_geo_binary_pred("st_intersects",
                 lambda G, ka, ca, kb, cb: G.intersects(ka, ca, kb, cb))


@scalar_function("st_makeline", _geo_resolver("st_makeline", 2, Geometry))
def _st_makeline(a, b, **kw):
    from .. import geometry as G
    out = []
    for wa, wb in zip(_texts(a), _texts(b)):
        ka, ca = G.parse_wkt(wa)
        kb, cb = G.parse_wkt(wb)
        pts = list(G._iter_points(ka, ca)) + list(G._iter_points(kb, cb))
        out.append(G.to_wkt("LINESTRING", pts))
    return StringData.from_pylist(out)


@scalar_function("st_makepolygon", _geo_resolver("st_makepolygon", 1, Geometry),
                 aliases=["st_polygon"])
def _st_makepolygon(a, **kw):
    from .. import geometry as G
    out = []
    for w in _texts(a):
        k, c = G.parse_wkt(w)
        if k != "LINESTRING" or len(c) < 3:
            raise BadDataValueType(
                "st_makepolygon expects a closed LINESTRING")
        ring = c if c[0] == c[-1] else c + [c[0]]
        out.append(G.to_wkt("POLYGON", [ring]))
    return StringData.from_pylist(out)


@scalar_function("haversine", _geo_resolver("haversine", 4, Float64))
def _haversine(lat1, lon1, lat2, lon2, **kw):
    r = 6371.0088  # mean earth radius, km
    p1 = np.radians(np.asarray(lat1, np.float64))
    p2 = np.radians(np.asarray(lat2, np.float64))
    dp = p2 - p1
    dl = np.radians(np.asarray(lon2, np.float64)) - np.radians(np.asarray(lon1, np.float64))
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * r * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


@scalar_function("st_within_bbox", _geo_resolver("st_within_bbox", 5, Boolean),
                 null_policy="custom")
def _st_within_bbox(payloads, validities, arg_types, n_rows):
    """st_within_bbox(geom, xmin, ymin, xmax, ymax) — the predicate the
    spatial block pruner answers from per-block bboxes."""
    from .. import geometry as G
    texts = _texts(payloads[0])
    bounds = [np.asarray(p, np.float64) for p in payloads[1:]]
    v0 = validities[0]
    out = np.zeros(n_rows, np.bool_)
    valid = np.ones(n_rows, np.bool_)
    for i in range(n_rows):
        if v0 is not None and not v0[i]:
            valid[i] = False
            continue
        p = parse_point(texts[i])
        if p is not None:
            b = (p[0], p[1], p[0], p[1])
        else:
            try:
                b = G.bbox(*G.parse_wkt(texts[i]))
            except Exception:
                b = None
        if b is None:
            valid[i] = False
            continue
        out[i] = (bounds[0][i] <= b[0] and b[2] <= bounds[2][i]
                  and bounds[1][i] <= b[1] and b[3] <= bounds[3][i])
    return out, (None if valid.all() else valid)
