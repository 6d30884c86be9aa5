"""Planar geometry for geo_shape fields and queries (counterpart of
``elasticsearch_tpu/utils/geometry.py``, copied but for its imports).

Shapes stay on the host as geometry objects; a segment keeps a dense
``[nd_pad, 4]`` bbox table of each doc's shapes (``Segment.
shape_column``), which the ``geo_shape`` query stages on the segment's
device for its prefilter, and the exact planar predicates of this module
decide the candidates on the host. Coordinates are lon/lat degrees on a
planar approximation; a circle becomes a 32-gon. ``parse_shape`` reads
GeoJSON (``point`` .. ``geometrycollection``, ``envelope``, ``circle``
with a ``radius``) and WKT. The distance-unit table (``_parse_radius``)
also serves the ``geo_distance`` query and the ``_geo_distance`` sort.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    MapperParsingException,
)

EARTH_RADIUS_M = 6371008.7714
CIRCLE_SIDES = 32


# ---------------------------------------------------------------------------
# primitives (planar, lon/lat degrees)
# ---------------------------------------------------------------------------


def _seg_intersect(p1, p2, p3, p4) -> bool:
    """Proper + collinear-overlap segment intersection."""

    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(v) < 1e-12:
            return 0
        return 1 if v > 0 else -1

    def on_seg(a, b, c):
        return (min(a[0], b[0]) - 1e-12 <= c[0] <= max(a[0], b[0]) + 1e-12
                and min(a[1], b[1]) - 1e-12 <= c[1] <= max(a[1], b[1]) + 1e-12)

    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    if o1 != o2 and o3 != o4:
        return True
    if o1 == 0 and on_seg(p1, p2, p3):
        return True
    if o2 == 0 and on_seg(p1, p2, p4):
        return True
    if o3 == 0 and on_seg(p3, p4, p1):
        return True
    if o4 == 0 and on_seg(p3, p4, p2):
        return True
    return False


def _point_in_ring(pt, ring: Sequence[Tuple[float, float]]) -> bool:
    """Ray casting; boundary counts as inside (tolerance 1e-12)."""
    x, y = pt
    inside = False
    n = len(ring)
    for i in range(n - 1):
        x1, y1 = ring[i]
        x2, y2 = ring[i + 1]
        # boundary check
        if _seg_intersect((x1, y1), (x2, y2), (x, y), (x, y)):
            return True
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
            if x < xin:
                inside = not inside
    return inside


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


class Shape:
    kind = "shape"

    def bbox(self) -> Tuple[float, float, float, float]:
        """(min_lon, min_lat, max_lon, max_lat)."""
        raise NotImplementedError

    # decomposition every shape provides: points / segments / rings
    def points(self) -> List[Tuple[float, float]]:
        return []

    def segments(self) -> List[Tuple[Tuple[float, float], Tuple[float, float]]]:
        return []

    def rings(self) -> List["Polygon"]:
        """Filled areas as simple polygons (shells with holes)."""
        return []

    def contains_point(self, pt) -> bool:
        return any(poly._contains_point(pt) for poly in self.rings())

    # -- relations ----------------------------------------------------

    def intersects(self, other: "Shape") -> bool:
        ba, bb = self.bbox(), other.bbox()
        if ba[0] > bb[2] or bb[0] > ba[2] or ba[1] > bb[3] or bb[1] > ba[3]:
            return False
        # any point of one inside the other's area
        pts_a, pts_b = self.points(), other.points()
        segs_a, segs_b = self.segments(), other.segments()
        for pt in pts_a:
            if other.contains_point(pt):
                return True
        for pt in pts_b:
            if self.contains_point(pt):
                return True
        # point-on-point / point-on-edge (points and lines have no filled
        # area, so contains_point can't see them)
        for pa in pts_a:
            for pb in pts_b:
                if abs(pa[0] - pb[0]) < 1e-12 and abs(pa[1] - pb[1]) < 1e-12:
                    return True
        for pt in pts_a:
            for sb in segs_b:
                if _seg_intersect(sb[0], sb[1], pt, pt):
                    return True
        for pt in pts_b:
            for sa in segs_a:
                if _seg_intersect(sa[0], sa[1], pt, pt):
                    return True
        # any edge crossing
        for sa in segs_a:
            for sb in segs_b:
                if _seg_intersect(sa[0], sa[1], sb[0], sb[1]):
                    return True
        # area containment without vertex containment is covered by the
        # point checks above (first vertex of the contained shape)
        return False

    def within(self, other: "Shape") -> bool:
        """Every point of self inside other's filled area: all vertices
        AND all edge midpoints inside (grid-precision approximation of
        full boundary containment, adequate at the reference's
        prefix-tree quantization)."""
        pts = self.points()
        if not pts:
            return False
        for pt in pts:
            if not other.contains_point(pt):
                return False
        for sa in self.segments():
            mid = ((sa[0][0] + sa[1][0]) / 2.0, (sa[0][1] + sa[1][1]) / 2.0)
            if not other.contains_point(mid):
                return False
        return True

    def contains(self, other: "Shape") -> bool:
        return other.within(self)

    def disjoint(self, other: "Shape") -> bool:
        return not self.intersects(other)

    def relate(self, other: "Shape", relation: str) -> bool:
        if relation == "intersects":
            return self.intersects(other)
        if relation == "disjoint":
            return self.disjoint(other)
        if relation == "within":
            return self.within(other)
        if relation == "contains":
            return self.contains(other)
        raise IllegalArgumentException(f"Unknown shape relation [{relation}]")


class Point(Shape):
    kind = "point"

    def __init__(self, lon: float, lat: float):
        self.lon, self.lat = float(lon), float(lat)

    def bbox(self):
        return (self.lon, self.lat, self.lon, self.lat)

    def points(self):
        return [(self.lon, self.lat)]


class MultiPoint(Shape):
    kind = "multipoint"

    def __init__(self, pts):
        self.pts = [(float(x), float(y)) for x, y in pts]
        if not self.pts:
            raise MapperParsingException("multipoint requires coordinates")

    def bbox(self):
        xs = [p[0] for p in self.pts]
        ys = [p[1] for p in self.pts]
        return (min(xs), min(ys), max(xs), max(ys))

    def points(self):
        return list(self.pts)


class LineString(Shape):
    kind = "linestring"

    def __init__(self, pts):
        self.pts = [(float(x), float(y)) for x, y in pts]
        if len(self.pts) < 2:
            raise MapperParsingException(
                "linestring requires at least 2 points")

    def bbox(self):
        xs = [p[0] for p in self.pts]
        ys = [p[1] for p in self.pts]
        return (min(xs), min(ys), max(xs), max(ys))

    def points(self):
        return list(self.pts)

    def segments(self):
        return list(zip(self.pts[:-1], self.pts[1:]))


class MultiLineString(Shape):
    kind = "multilinestring"

    def __init__(self, lines):
        self.lines = [LineString(l) for l in lines]

    def bbox(self):
        bs = [l.bbox() for l in self.lines]
        return (min(b[0] for b in bs), min(b[1] for b in bs),
                max(b[2] for b in bs), max(b[3] for b in bs))

    def points(self):
        return [p for l in self.lines for p in l.points()]

    def segments(self):
        return [s for l in self.lines for s in l.segments()]


class Polygon(Shape):
    kind = "polygon"

    def __init__(self, shell, holes=()):
        self.shell = [(float(x), float(y)) for x, y in shell]
        if len(self.shell) < 4:
            raise MapperParsingException(
                "polygon shell requires at least 4 points (closed ring)")
        if self.shell[0] != self.shell[-1]:
            raise MapperParsingException("polygon ring must be closed")
        self.holes = [[(float(x), float(y)) for x, y in h] for h in holes]
        for h in self.holes:
            if len(h) < 4 or h[0] != h[-1]:
                raise MapperParsingException("polygon hole must be a closed ring")

    def bbox(self):
        xs = [p[0] for p in self.shell]
        ys = [p[1] for p in self.shell]
        return (min(xs), min(ys), max(xs), max(ys))

    def points(self):
        return self.shell[:-1]

    def segments(self):
        segs = list(zip(self.shell[:-1], self.shell[1:]))
        for h in self.holes:
            segs.extend(zip(h[:-1], h[1:]))
        return segs

    def rings(self):
        return [self]

    def _contains_point(self, pt) -> bool:
        if not _point_in_ring(pt, self.shell):
            return False
        for h in self.holes:
            # inside a hole = outside, unless on the hole's boundary
            if _point_in_ring(pt, h):
                on_boundary = any(
                    _seg_intersect(a, b, pt, pt)
                    for a, b in zip(h[:-1], h[1:]))
                if not on_boundary:
                    return False
        return True


class MultiPolygon(Shape):
    kind = "multipolygon"

    def __init__(self, polys):
        self.polys = [p if isinstance(p, Polygon) else Polygon(p[0], p[1:])
                      for p in polys]

    def bbox(self):
        bs = [p.bbox() for p in self.polys]
        return (min(b[0] for b in bs), min(b[1] for b in bs),
                max(b[2] for b in bs), max(b[3] for b in bs))

    def points(self):
        return [pt for p in self.polys for pt in p.points()]

    def segments(self):
        return [s for p in self.polys for s in p.segments()]

    def rings(self):
        return list(self.polys)


def envelope(top_left, bottom_right) -> Polygon:
    """GeoJSON-style envelope: [[minLon, maxLat], [maxLon, minLat]]."""
    min_lon, max_lat = float(top_left[0]), float(top_left[1])
    max_lon, min_lat = float(bottom_right[0]), float(bottom_right[1])
    return Polygon([(min_lon, min_lat), (max_lon, min_lat),
                    (max_lon, max_lat), (min_lon, max_lat),
                    (min_lon, min_lat)])


def circle(center, radius_m: float) -> Polygon:
    """Circle approximated as a CIRCLE_SIDES-gon (planar degrees)."""
    lon, lat = float(center[0]), float(center[1])
    dlat = math.degrees(radius_m / EARTH_RADIUS_M)
    dlon = dlat / max(math.cos(math.radians(lat)), 1e-6)
    pts = []
    for i in range(CIRCLE_SIDES):
        a = 2.0 * math.pi * i / CIRCLE_SIDES
        pts.append((lon + dlon * math.cos(a), lat + dlat * math.sin(a)))
    pts.append(pts[0])
    return Polygon(pts)


class GeometryCollection(Shape):
    kind = "geometrycollection"

    def __init__(self, shapes: List[Shape]):
        self.shapes = shapes
        if not shapes:
            raise MapperParsingException("geometrycollection requires shapes")

    def bbox(self):
        bs = [s.bbox() for s in self.shapes]
        return (min(b[0] for b in bs), min(b[1] for b in bs),
                max(b[2] for b in bs), max(b[3] for b in bs))

    def points(self):
        return [p for s in self.shapes for p in s.points()]

    def segments(self):
        return [seg for s in self.shapes for seg in s.segments()]

    def rings(self):
        return [r for s in self.shapes for r in s.rings()]


# ---------------------------------------------------------------------------
# parsing: GeoJSON + WKT
# ---------------------------------------------------------------------------

_DISTANCE_UNITS = {
    "m": 1.0, "meters": 1.0, "km": 1000.0, "kilometers": 1000.0,
    "mi": 1609.344, "miles": 1609.344, "yd": 0.9144, "ft": 0.3048,
    "in": 0.0254, "cm": 0.01, "mm": 0.001, "nmi": 1852.0, "nm": 1852.0,
}


def _parse_radius(value) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    for unit in sorted(_DISTANCE_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return float(s[: -len(unit)]) * _DISTANCE_UNITS[unit]
    return float(s)


def parse_geojson(obj: dict) -> Shape:
    if not isinstance(obj, dict) or "type" not in obj:
        raise MapperParsingException(f"failed to parse geo_shape [{obj!r}]")
    t = str(obj["type"]).lower()
    coords = obj.get("coordinates")
    try:
        if t == "point":
            return Point(coords[0], coords[1])
        if t == "multipoint":
            return MultiPoint(coords)
        if t == "linestring":
            return LineString(coords)
        if t == "multilinestring":
            return MultiLineString(coords)
        if t == "polygon":
            return Polygon(coords[0], coords[1:])
        if t == "multipolygon":
            return MultiPolygon([(p[0], *p[1:]) for p in coords])
        if t == "envelope":
            return envelope(coords[0], coords[1])
        if t == "circle":
            if "radius" not in obj:
                raise MapperParsingException(
                    "circle geo_shape requires a [radius]")
            return circle(coords, _parse_radius(obj["radius"]))
        if t == "geometrycollection":
            return GeometryCollection(
                [parse_geojson(g) for g in obj.get("geometries", [])])
    except MapperParsingException:
        raise
    except Exception as e:
        raise MapperParsingException(
            f"failed to parse geo_shape [{t}]: {e}") from e
    raise MapperParsingException(f"unknown geo_shape type [{obj['type']}]")


def _wkt_coords(body: str) -> List[Tuple[float, float]]:
    out = []
    for pair in body.split(","):
        parts = pair.split()
        out.append((float(parts[0]), float(parts[1])))
    return out


def parse_wkt(text: str) -> Shape:
    """WKT subset: POINT, LINESTRING, POLYGON, MULTIPOINT, MULTILINESTRING,
    MULTIPOLYGON, ENVELOPE (BBOX), GEOMETRYCOLLECTION
    (common/geo/parsers/GeoWKTParser.java)."""
    s = text.strip()
    m = s.upper()
    try:
        if m.startswith("POINT"):
            inner = s[s.index("(") + 1: s.rindex(")")]
            return Point(*(_wkt_coords(inner)[0]))
        if m.startswith("MULTIPOINT"):
            inner = s[s.index("(") + 1: s.rindex(")")].replace("(", "").replace(")", "")
            return MultiPoint(_wkt_coords(inner))
        if m.startswith("LINESTRING"):
            inner = s[s.index("(") + 1: s.rindex(")")]
            return LineString(_wkt_coords(inner))
        if m.startswith("MULTILINESTRING"):
            inner = s[s.index("(") + 1: s.rindex(")")]
            lines = [_wkt_coords(part) for part in _split_rings(inner)]
            return MultiLineString(lines)
        if m.startswith("MULTIPOLYGON"):
            inner = s[s.index("(") + 1: s.rindex(")")]
            polys = []
            for poly_body in _split_groups(inner):
                rings = [_wkt_coords(r) for r in _split_rings(poly_body)]
                polys.append((rings[0], *rings[1:]))
            return MultiPolygon(polys)
        if m.startswith("POLYGON"):
            inner = s[s.index("(") + 1: s.rindex(")")]
            rings = [_wkt_coords(r) for r in _split_rings(inner)]
            return Polygon(rings[0], rings[1:])
        if m.startswith("ENVELOPE") or m.startswith("BBOX"):
            inner = s[s.index("(") + 1: s.rindex(")")]
            # ENVELOPE(minLon, maxLon, maxLat, minLat) — WKT order
            a = [float(x) for x in inner.split(",")]
            return envelope((a[0], a[2]), (a[1], a[3]))
        if m.startswith("GEOMETRYCOLLECTION"):
            inner = s[s.index("(") + 1: s.rindex(")")]
            return GeometryCollection(
                [parse_wkt(part) for part in _split_top_level(inner)])
    except MapperParsingException:
        raise
    except Exception as e:
        raise MapperParsingException(f"failed to parse WKT [{text}]: {e}") from e
    raise MapperParsingException(f"unknown WKT shape [{text}]")


def _split_rings(body: str) -> List[str]:
    """Split '(...),(...)' into ring bodies."""
    out, depth, start = [], 0, None
    for i, c in enumerate(body):
        if c == "(":
            if depth == 0:
                start = i + 1
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                out.append(body[start:i])
    return out


def _split_groups(body: str) -> List[str]:
    """Split '((..),(..)),((..))' into polygon bodies (depth-1 groups)."""
    out, depth, start = [], 0, None
    for i, c in enumerate(body):
        if c == "(":
            depth += 1
            if depth == 1:
                start = i + 1
        elif c == ")":
            if depth == 1:
                out.append(body[start:i])
            depth -= 1
    return out


def _split_top_level(body: str) -> List[str]:
    """Split a GEOMETRYCOLLECTION body on top-level commas."""
    out, depth, start = [], 0, 0
    for i, c in enumerate(body):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "," and depth == 0:
            out.append(body[start:i])
            start = i + 1
    out.append(body[start:])
    return [p for p in (x.strip() for x in out) if p]


def parse_shape(value) -> Shape:
    if isinstance(value, str):
        return parse_wkt(value)
    return parse_geojson(value)


def _coords_bbox(points) -> Tuple[float, float, float, float]:
    xs, ys = zip(*((float(p[0]), float(p[1])) for p in points))
    return (min(xs), min(ys), max(xs), max(ys))


def shape_bbox(value) -> Tuple[float, float, float, float]:
    """``parse_shape(value).bbox()`` without building the shape for the
    GeoJSON kinds whose box is their coordinates' (a point, a line, a
    polygon's shell, their multi forms); any other value is parsed. The
    value was validated when its document was indexed."""
    if isinstance(value, dict):
        t = str(value.get("type", "")).lower()
        coords = value.get("coordinates")
        if t == "point":
            x, y = float(coords[0]), float(coords[1])
            return (x, y, x, y)
        if t in ("linestring", "multipoint"):
            return _coords_bbox(coords)
        if t == "polygon":
            return _coords_bbox(coords[0])
        if t == "multilinestring":
            return _coords_bbox([p for line in coords for p in line])
        if t == "multipolygon":
            return _coords_bbox([p for poly in coords for p in poly[0]])
    return parse_shape(value).bbox()
