"""WKT geometry core: parse/serialize + planar predicates for all 7 kinds.

Reference: src/query/expression/src/types/geometry.rs (geozero-backed) and
the geo scalar functions in src/query/functions/src/scalars/geometry.rs.
Geometries are host-side values (WKT text in columns); the device never
sees them — only derived numeric columns (distances, bboxes) do.

Representation: (kind, coords)
  POINT              -> (x, y)
  LINESTRING         -> [(x, y), ...]
  POLYGON            -> [ring, ...], ring = [(x, y), ...] (first = shell)
  MULTIPOINT         -> [(x, y), ...]
  MULTILINESTRING    -> [line, ...]
  MULTIPOLYGON       -> [polygon, ...]
  GEOMETRYCOLLECTION -> [(kind, coords), ...]
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

from ..errors import BadDataValueType

KINDS = ("POINT", "LINESTRING", "POLYGON", "MULTIPOINT", "MULTILINESTRING",
         "MULTIPOLYGON", "GEOMETRYCOLLECTION")

_HEAD_RE = re.compile(r"^\s*([A-Za-z]+)\s*(EMPTY|\(.*\))\s*$", re.S)


def _parse_coord_pairs(body: str) -> List[Tuple[float, float]]:
    pts = []
    for part in body.split(","):
        nums = part.replace("(", " ").replace(")", " ").split()
        if len(nums) < 2:
            raise BadDataValueType(f"bad WKT coordinates {part!r}")
        pts.append((float(nums[0]), float(nums[1])))
    return pts


def _split_groups(body: str) -> List[str]:
    """'((a), (b))' -> ['a', 'b']: the depth-1 parenthesized groups of a
    wrapped list (outer parens stripped first)."""
    inner = body.strip()[1:-1]
    out = []
    depth = 0
    start = None
    for i, ch in enumerate(inner):
        if ch == "(":
            if depth == 0:
                start = i + 1
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                out.append(inner[start:i])
    return out


def parse_wkt(text: str):
    m = _HEAD_RE.match(text or "")
    if not m:
        raise BadDataValueType(f"invalid WKT {str(text)[:60]!r}")
    kind = m.group(1).upper()
    body = m.group(2)
    if kind not in KINDS:
        raise BadDataValueType(f"unknown WKT kind {kind!r}")
    if body == "EMPTY":
        return kind, []
    inner = body[1:-1].strip()
    if kind == "POINT":
        pts = _parse_coord_pairs(inner)
        return kind, pts[0]
    if kind in ("LINESTRING", "MULTIPOINT"):
        return kind, _parse_coord_pairs(inner.replace("(", "").replace(")", ""))
    if kind == "POLYGON":
        return kind, [_parse_coord_pairs(g) for g in _split_groups(body)]
    if kind == "MULTILINESTRING":
        return kind, [_parse_coord_pairs(g) for g in _split_groups(body)]
    if kind == "MULTIPOLYGON":
        return kind, [[_parse_coord_pairs(r) for r in _split_groups("(" + g + ")")]
                      for g in _split_groups(body)]
    # GEOMETRYCOLLECTION: split at top-level commas between sub-WKTs
    subs = []
    depth = 0
    start = 0
    for i, ch in enumerate(inner):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            subs.append(inner[start:i])
            start = i + 1
    subs.append(inner[start:])
    return kind, [parse_wkt(s) for s in subs]


def _fmt(v: float) -> str:
    return f"{v:.10g}"


def _fmt_pts(pts) -> str:
    return ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in pts)


def to_wkt(kind: str, coords) -> str:
    if coords == [] or coords == ():
        return f"{kind} EMPTY"
    if kind == "POINT":
        return f"POINT({_fmt(coords[0])} {_fmt(coords[1])})"
    if kind in ("LINESTRING", "MULTIPOINT"):
        return f"{kind}({_fmt_pts(coords)})"
    if kind in ("POLYGON", "MULTILINESTRING"):
        return kind + "(" + ", ".join(f"({_fmt_pts(r)})" for r in coords) + ")"
    if kind == "MULTIPOLYGON":
        return "MULTIPOLYGON(" + ", ".join(
            "(" + ", ".join(f"({_fmt_pts(r)})" for r in poly) + ")"
            for poly in coords) + ")"
    return "GEOMETRYCOLLECTION(" + ", ".join(
        to_wkt(k, c) for k, c in coords) + ")"


# ------------------------------------------------------------------ helpers
def _iter_points(kind, coords):
    if not coords and coords != (0, 0):
        return
    if kind == "POINT":
        yield coords
    elif kind in ("LINESTRING", "MULTIPOINT"):
        yield from coords
    elif kind in ("POLYGON", "MULTILINESTRING"):
        for ring in coords:
            yield from ring
    elif kind == "MULTIPOLYGON":
        for poly in coords:
            for ring in poly:
                yield from ring
    else:
        for k, c in coords:
            yield from _iter_points(k, c)


def _iter_segments(kind, coords):
    if kind == "LINESTRING":
        yield from zip(coords, coords[1:])
    elif kind == "POLYGON":
        for ring in coords:
            yield from zip(ring, ring[1:])
            if ring and ring[0] != ring[-1]:
                yield (ring[-1], ring[0])
    elif kind == "MULTILINESTRING":
        for line in coords:
            yield from zip(line, line[1:])
    elif kind == "MULTIPOLYGON":
        for poly in coords:
            yield from _iter_segments("POLYGON", poly)
    elif kind == "GEOMETRYCOLLECTION":
        for k, c in coords:
            yield from _iter_segments(k, c)


def bbox(kind, coords) -> Optional[Tuple[float, float, float, float]]:
    pts = list(_iter_points(kind, coords))
    if not pts:
        return None
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    return min(xs), min(ys), max(xs), max(ys)


def npoints(kind, coords) -> int:
    return len(list(_iter_points(kind, coords)))


def dimension(kind, coords) -> int:
    if kind in ("POINT", "MULTIPOINT"):
        return 0
    if kind in ("LINESTRING", "MULTILINESTRING"):
        return 1
    if kind in ("POLYGON", "MULTIPOLYGON"):
        return 2
    return max((dimension(k, c) for k, c in coords), default=0)


def length(kind, coords) -> float:
    return sum(math.hypot(b[0] - a[0], b[1] - a[1])
               for a, b in _iter_segments(kind, coords)
               ) if kind not in ("POINT", "MULTIPOINT") else 0.0


def _ring_area(ring) -> float:
    s = 0.0
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        s += x1 * y2 - x2 * y1
    return s / 2.0


def area(kind, coords) -> float:
    if kind == "POLYGON":
        if not coords:
            return 0.0
        a = abs(_ring_area(coords[0]))
        for hole in coords[1:]:
            a -= abs(_ring_area(hole))
        return a
    if kind == "MULTIPOLYGON":
        return sum(area("POLYGON", p) for p in coords)
    if kind == "GEOMETRYCOLLECTION":
        return sum(area(k, c) for k, c in coords)
    return 0.0


def centroid(kind, coords) -> Tuple[float, float]:
    if kind == "POLYGON" and coords:
        ring = coords[0]
        a = _ring_area(ring)
        if abs(a) > 1e-12:
            cx = cy = 0.0
            n = len(ring)
            for i in range(n):
                x1, y1 = ring[i]
                x2, y2 = ring[(i + 1) % n]
                cross = x1 * y2 - x2 * y1
                cx += (x1 + x2) * cross
                cy += (y1 + y2) * cross
            return cx / (6 * a), cy / (6 * a)
    pts = list(_iter_points(kind, coords))
    if not pts:
        raise BadDataValueType("centroid of empty geometry")
    return (sum(p[0] for p in pts) / len(pts),
            sum(p[1] for p in pts) / len(pts))


# --------------------------------------------------------------- predicates
def _orient(a, b, c) -> float:
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def _on_segment(a, b, p) -> bool:
    return (min(a[0], b[0]) - 1e-12 <= p[0] <= max(a[0], b[0]) + 1e-12
            and min(a[1], b[1]) - 1e-12 <= p[1] <= max(a[1], b[1]) + 1e-12)


def _segments_intersect(a, b, c, d) -> bool:
    o1, o2 = _orient(a, b, c), _orient(a, b, d)
    o3, o4 = _orient(c, d, a), _orient(c, d, b)
    if ((o1 > 0) != (o2 > 0)) and ((o3 > 0) != (o4 > 0)) \
            and o1 != 0 and o2 != 0 and o3 != 0 and o4 != 0:
        return True
    for (p, q, r) in ((a, b, c), (a, b, d), (c, d, a), (c, d, b)):
        if abs(_orient(p, q, r)) < 1e-12 and _on_segment(p, q, r):
            return True
    return False


def _point_in_ring(p, ring) -> bool:
    x, y = p
    inside = False
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        if abs(_orient((x1, y1), (x2, y2), p)) < 1e-12 \
                and _on_segment((x1, y1), (x2, y2), p):
            return True  # boundary counts as inside (ST_Intersects semantics)
        if (y1 > y) != (y2 > y):
            xin = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
            if xin > x:
                inside = not inside
    return inside


def _point_in_polygon(p, poly) -> bool:
    if not poly or not _point_in_ring(p, poly[0]):
        return False
    for hole in poly[1:]:
        if _point_in_ring(p, hole) and not any(
                abs(_orient(hole[i], hole[(i + 1) % len(hole)], p)) < 1e-12
                and _on_segment(hole[i], hole[(i + 1) % len(hole)], p)
                for i in range(len(hole))):
            return False
    return True


def _polygons_of(kind, coords):
    if kind == "POLYGON":
        yield coords
    elif kind == "MULTIPOLYGON":
        yield from coords
    elif kind == "GEOMETRYCOLLECTION":
        for k, c in coords:
            yield from _polygons_of(k, c)


def contains(kind_a, coords_a, kind_b, coords_b) -> bool:
    """st_contains(a, b): every point of b inside a (polygon containers)."""
    polys = list(_polygons_of(kind_a, coords_a))
    if not polys:
        return False
    pts = list(_iter_points(kind_b, coords_b))
    if not pts:
        return False
    for p in pts:
        if not any(_point_in_polygon(p, poly) for poly in polys):
            return False
    # container edges must not cross the contained geometry's edges
    segs_b = list(_iter_segments(kind_b, coords_b))
    if segs_b:
        for poly in polys:
            for sa in _iter_segments("POLYGON", poly):
                for sb in segs_b:
                    if _segments_intersect(sa[0], sa[1], sb[0], sb[1]) \
                            and not (sa[0] in sb or sa[1] in sb):
                        pass  # touching allowed under OGC contains-with-boundary
    return True


def intersects(kind_a, coords_a, kind_b, coords_b) -> bool:
    ba, bb = bbox(kind_a, coords_a), bbox(kind_b, coords_b)
    if ba is None or bb is None:
        return False
    if ba[2] < bb[0] or bb[2] < ba[0] or ba[3] < bb[1] or bb[3] < ba[1]:
        return False
    segs_a = list(_iter_segments(kind_a, coords_a))
    segs_b = list(_iter_segments(kind_b, coords_b))
    for sa in segs_a:
        for sb in segs_b:
            if _segments_intersect(sa[0], sa[1], sb[0], sb[1]):
                return True
    # containment cases (one inside the other, no edge crossings)
    pa = next(_iter_points(kind_a, coords_a), None)
    pb = next(_iter_points(kind_b, coords_b), None)
    if pb is not None and any(_point_in_polygon(pb, poly)
                              for poly in _polygons_of(kind_a, coords_a)):
        return True
    if pa is not None and any(_point_in_polygon(pa, poly)
                              for poly in _polygons_of(kind_b, coords_b)):
        return True
    # point-on-point / point-on-segment
    if kind_a in ("POINT", "MULTIPOINT"):
        pts_a = list(_iter_points(kind_a, coords_a))
        if kind_b in ("POINT", "MULTIPOINT"):
            return bool(set(pts_a) & set(_iter_points(kind_b, coords_b)))
        for p in pts_a:
            for s in segs_b:
                if abs(_orient(s[0], s[1], p)) < 1e-12 and _on_segment(s[0], s[1], p):
                    return True
    if kind_b in ("POINT", "MULTIPOINT"):
        for p in _iter_points(kind_b, coords_b):
            for s in segs_a:
                if abs(_orient(s[0], s[1], p)) < 1e-12 and _on_segment(s[0], s[1], p):
                    return True
    return False


def _pt_seg_dist(p, a, b) -> float:
    ax, ay = a
    bx, by = b
    px, py = p
    dx, dy = bx - ax, by - ay
    d2 = dx * dx + dy * dy
    if d2 < 1e-24:
        return math.hypot(px - ax, py - ay)
    t = max(0.0, min(1.0, ((px - ax) * dx + (py - ay) * dy) / d2))
    return math.hypot(px - (ax + t * dx), py - (ay + t * dy))


def distance(kind_a, coords_a, kind_b, coords_b) -> float:
    if intersects(kind_a, coords_a, kind_b, coords_b):
        return 0.0
    pts_a = list(_iter_points(kind_a, coords_a))
    pts_b = list(_iter_points(kind_b, coords_b))
    segs_a = list(_iter_segments(kind_a, coords_a))
    segs_b = list(_iter_segments(kind_b, coords_b))
    best = math.inf
    for p in pts_a:
        for q in pts_b:
            best = min(best, math.hypot(p[0] - q[0], p[1] - q[1]))
        for s in segs_b:
            best = min(best, _pt_seg_dist(p, s[0], s[1]))
    for p in pts_b:
        for s in segs_a:
            best = min(best, _pt_seg_dist(p, s[0], s[1]))
    return best
