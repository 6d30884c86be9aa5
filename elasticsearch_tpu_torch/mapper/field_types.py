"""Field types: JSON value -> indexable terms + columnar doc values.

Counterpart of ``elasticsearch_tpu/mapper/field_types.py``, cut to the
types the port serves: ``text`` (``fielddata`` too), ``keyword``, the
numbers (``long``, ``integer``, ``short``, ``byte``, ``double``,
``float``, ``half_float``, ``scaled_float``), ``date``, ``boolean``,
``ip``, ``geo_point``, the range family (``integer_range``,
``long_range``, ``float_range``, ``double_range``, ``date_range``,
``ip_range``), ``token_count``, ``binary``, ``murmur3`` and
``dense_vector`` and ``join`` (``JoinFieldType``: a relation name and a
parent id, two ordinal columns), ``geo_shape`` (the raw GeoJSON or WKT
kept a doc, validated at index time), ``percolator`` (a stored query,
kept in ``_source`` only) and ``completion`` (its inputs an ordinal
column, its weight ``<field>#weight`` and each context
``<field>#ctx.<name>``, a geo context as 12-character geohashes).
``nested`` is an object path, compiled by the mapper. Any other type
raises the JAX package's "No handler for type" error.

Numeric doc values are float64, as in the JAX package (x64 is on there): a
``date`` is its epoch milliseconds (UTC), a ``boolean`` 1.0 or 0.0, a
``half_float`` its float64 value (no float16 rounding, as in JAX). An
``ip`` is an ordinal column of formatted addresses (``format_ip``); a
range value two aligned numeric columns ``<f>#lo`` and ``<f>#hi``; a
geo point a ``GeoColumn`` (``index/segment.py``).
"""

from __future__ import annotations

import base64
import datetime as _dt
import ipaddress
import math
from typing import Any, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    MapperParsingException,
)

_INT_RANGES = {
    "long": (-(2**63), 2**63 - 1),
    "integer": (-(2**31), 2**31 - 1),
    "short": (-(2**15), 2**15 - 1),
    "byte": (-(2**7), 2**7 - 1),
}


def parse_date(value: Any, formats: Optional[List[str]] = None) -> int:
    """Parse a date value to epoch milliseconds (UTC): the formats given
    (``||``-separated in the mapping), else ISO-8601
    (``strict_date_optional_time``) or epoch_millis, as the JAX package
    does."""
    if isinstance(value, bool):
        raise MapperParsingException(f"failed to parse date field [{value}]")
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if formats:
        for fmt in formats:
            if fmt == "epoch_millis":
                try:
                    return int(s)
                except ValueError:
                    continue
            if fmt == "epoch_second":
                try:
                    return int(s) * 1000
                except ValueError:
                    continue
            try:
                dt = _dt.datetime.strptime(s, _java_to_strptime(fmt))
                return _to_millis(dt)
            except ValueError:
                continue
        raise MapperParsingException(
            f"failed to parse date field [{s}] with format [{'||'.join(formats)}]"
        )
    try:
        return int(s)
    except ValueError:
        pass
    try:
        iso = s.replace("Z", "+00:00")
        if len(iso) == 10:  # yyyy-MM-dd
            dt = _dt.datetime.fromisoformat(iso + "T00:00:00+00:00")
        else:
            dt = _dt.datetime.fromisoformat(iso)
        return _to_millis(dt)
    except ValueError:
        raise MapperParsingException(f"failed to parse date field [{s}]") from None


def _to_millis(dt: _dt.datetime) -> int:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


_JAVA_FMT = {
    "yyyy": "%Y", "MM": "%m", "dd": "%d", "HH": "%H", "mm": "%M", "ss": "%S",
}


def _java_to_strptime(fmt: str) -> str:
    out = fmt
    for j, p in _JAVA_FMT.items():
        out = out.replace(j, p)
    return out


def format_epoch_millis(millis: int) -> str:
    dt = _dt.datetime.fromtimestamp(millis / 1000.0, tz=_dt.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def parse_ip(value: Any) -> int:
    """An address as an exact int: IPv4 mapped into the IPv6 space
    (``::ffff:a.b.c.d``), as Lucene's 16-byte encoding orders them."""
    try:
        addr = ipaddress.ip_address(str(value))
    except ValueError:
        raise MapperParsingException(
            f"'{value}' is not an IP string literal.") from None
    if isinstance(addr, ipaddress.IPv4Address):
        addr = ipaddress.IPv6Address(f"::ffff:{addr}")
    return int(addr)


def format_ip(value: int) -> str:
    addr = ipaddress.IPv6Address(int(value))
    v4 = addr.ipv4_mapped
    return str(v4) if v4 is not None else str(addr)


class FieldType:
    """Base field type; mirrors the mapping parameters (index, doc_values,
    boost, null_value)."""

    type_name = "object"
    has_doc_values = True
    # doc values kept as ordinals against a sorted term list (a sort on
    # the field compares strings)
    ordinal_doc_values = False

    def __init__(self, name: str, params: Optional[dict] = None):
        self.name = name
        self.params = dict(params or {})
        self.index = self.params.get("index", True)
        self.doc_values = self.params.get("doc_values", self.has_doc_values)
        self.boost = float(self.params.get("boost", 1.0))
        self.null_value = self.params.get("null_value")

    def index_terms(self, value: Any, analyzers) -> List[str]:
        raise NotImplementedError

    def doc_value(self, value: Any):
        raise NotImplementedError

    def term_for_query(self, value: Any, analyzers) -> str:
        return str(value)

    def numeric_for_query(self, value: Any) -> float:
        raise IllegalArgumentException(
            f"Field [{self.name}] of type [{self.type_name}] does not support numeric queries"
        )


class TextFieldType(FieldType):
    type_name = "text"
    has_doc_values = False

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.analyzer = self.params.get("analyzer", "standard")
        self.search_analyzer = self.params.get("search_analyzer", self.analyzer)
        # fielddata: the analyzed tokens also land in an ordinal column at
        # seal (a text field without it builds one from its postings when
        # an aggregation first asks, search/aggregations.py)
        self.fielddata = bool(self.params.get("fielddata", False))
        # per-field similarity name, resolved by the index's
        # SimilarityService (BM25 unless the mapping or index names another)
        self.similarity_name = self.params.get("similarity")

    def index_terms(self, value, analyzers):
        return analyzers.get(self.analyzer).analyze(str(value))

    def doc_value(self, value):
        return None

    def term_for_query(self, value, analyzers):
        toks = analyzers.get(self.search_analyzer).analyze(str(value))
        return toks[0] if toks else ""

    def query_terms(self, value, analyzers):
        return analyzers.get(self.search_analyzer).analyze(str(value))


class KeywordFieldType(FieldType):
    type_name = "keyword"
    ordinal_doc_values = True

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.ignore_above = int(self.params.get("ignore_above", 2**31 - 1))
        self.normalizer = self.params.get("normalizer")

    def _normalize(self, s: str) -> str:
        if self.normalizer == "lowercase":
            return s.lower()
        return s

    def index_terms(self, value, analyzers):
        s = str(value)
        if len(s) > self.ignore_above:
            return []
        return [self._normalize(s)]

    def doc_value(self, value):
        s = str(value)
        if len(s) > self.ignore_above:
            return None
        return self._normalize(s)

    def term_for_query(self, value, analyzers):
        return self._normalize(str(value))


class NumberFieldType(FieldType):
    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.coerce = bool(self.params.get("coerce", True))

    def _parse(self, value):
        if isinstance(value, bool):
            raise MapperParsingException(
                f"failed to parse field [{self.name}] of type [{self.type_name}]: "
                f"booleans are not numbers"
            )
        try:
            if isinstance(value, str) and not self.coerce:
                raise ValueError(value)
            f = float(value)
        except (TypeError, ValueError):
            raise MapperParsingException(
                f"failed to parse field [{self.name}] of type [{self.type_name}] "
                f"value [{value}]"
            ) from None
        if math.isnan(f) or math.isinf(f):
            raise MapperParsingException(
                f"failed to parse field [{self.name}]: non-finite value"
            )
        return f

    def index_terms(self, value, analyzers):
        # numeric term/range queries run against the doc-value column
        return []

    def numeric_for_query(self, value):
        return self._parse(value)


class IntegerLikeFieldType(NumberFieldType):
    def doc_value(self, value):
        f = self._parse(value)
        i = int(f)
        if not self.coerce and f != i:
            raise MapperParsingException(
                f"failed to parse field [{self.name}]: [{value}] has a decimal part"
            )
        lo, hi = _INT_RANGES[self.type_name]
        if not (lo <= i <= hi):
            raise MapperParsingException(
                f"failed to parse field [{self.name}]: value [{value}] is out of "
                f"range for type [{self.type_name}]"
            )
        return float(i)


class LongFieldType(IntegerLikeFieldType):
    type_name = "long"


class IntegerFieldType(IntegerLikeFieldType):
    type_name = "integer"


class ShortFieldType(IntegerLikeFieldType):
    type_name = "short"


class ByteFieldType(IntegerLikeFieldType):
    type_name = "byte"


class DoubleFieldType(NumberFieldType):
    type_name = "double"

    def doc_value(self, value):
        return self._parse(value)


class FloatFieldType(DoubleFieldType):
    type_name = "float"


class HalfFloatFieldType(DoubleFieldType):
    type_name = "half_float"


class ScaledFloatFieldType(NumberFieldType):
    type_name = "scaled_float"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        if "scaling_factor" not in self.params:
            raise MapperParsingException(
                f"Field [{name}] misses required parameter [scaling_factor]")
        self.scaling_factor = float(self.params["scaling_factor"])

    def doc_value(self, value):
        # kept scaled and rounded: round(value * factor) / factor
        return (float(round(self._parse(value) * self.scaling_factor))
                / self.scaling_factor)

    def numeric_for_query(self, value):
        return self._parse(value)


class DateFieldType(FieldType):
    type_name = "date"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        fmt = self.params.get("format")
        self.formats = fmt.split("||") if isinstance(fmt, str) else None

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return float(parse_date(value, self.formats))

    def numeric_for_query(self, value):
        return float(parse_date(value, self.formats))


class BooleanFieldType(FieldType):
    type_name = "boolean"

    def _parse(self, value) -> bool:
        if isinstance(value, bool):
            return value
        s = str(value)
        if s == "true":
            return True
        if s == "false":
            return False
        raise MapperParsingException(
            f"Failed to parse value [{value}] as only [true] or [false] are allowed."
        )

    def index_terms(self, value, analyzers):
        return ["T" if self._parse(value) else "F"]

    def doc_value(self, value):
        return 1.0 if self._parse(value) else 0.0

    def term_for_query(self, value, analyzers):
        return "T" if self._parse(value) else "F"

    def numeric_for_query(self, value):
        return 1.0 if self._parse(value) else 0.0


class IpFieldType(FieldType):
    """ip: the formatted address as a term and an ordinal doc value; the
    queries compare ``parse_ip`` ints (search/query_dsl.py)."""

    type_name = "ip"
    ordinal_doc_values = True

    def index_terms(self, value, analyzers):
        return [format_ip(parse_ip(value))]

    def doc_value(self, value):
        return format_ip(parse_ip(value))

    def term_for_query(self, value, analyzers):
        return format_ip(parse_ip(value))


class GeoPointFieldType(FieldType):
    """geo_point: each value a (lat, lon) pair in the segment's geo column;
    the distance, box and polygon filters are vector math over it."""

    type_name = "geo_point"

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return self.parse_point(value)

    @staticmethod
    def parse_point(value):
        """An object ``{"lat", "lon"}``, a GeoJSON ``[lon, lat]`` pair or a
        ``"lat,lon"`` string -> (lat, lon), bounds checked."""
        if isinstance(value, dict):
            lat, lon = value.get("lat"), value.get("lon")
        elif isinstance(value, (list, tuple)) and len(value) == 2:
            lon, lat = value
        elif isinstance(value, str):
            parts = value.split(",")
            if len(parts) != 2:
                raise MapperParsingException(
                    f"failed to parse geo_point [{value}]")
            lat, lon = float(parts[0]), float(parts[1])
        else:
            raise MapperParsingException(f"failed to parse geo_point [{value}]")
        lat, lon = float(lat), float(lon)
        if not (-90.0 <= lat <= 90.0) or not (-180.0 <= lon <= 180.0):
            raise MapperParsingException(
                f"illegal latitude/longitude value [{lat}, {lon}]")
        return (lat, lon)


class RangeFieldType(FieldType):
    """The range family: a value is a {gte, gt, lte, lt} object, kept as an
    inclusive (lo, hi) float pair in two aligned numeric columns
    (``<field>#lo``, ``<field>#hi``), so the intersects, contains and
    within relations are elementwise comparisons. An open side is
    +-inf."""

    has_doc_values = True

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.coerce = bool(self.params.get("coerce", True))

    def _bound(self, v):
        raise NotImplementedError

    # the exclusive-bound step: one float64 ulp (whole units for the
    # integer and date ranges)
    def _next_up(self, v: float) -> float:
        return math.nextafter(v, math.inf)

    def _next_down(self, v: float) -> float:
        return math.nextafter(v, -math.inf)

    def parse_range(self, value) -> tuple:
        """-> (lo, hi), the inclusive float bounds."""
        if not isinstance(value, dict):
            raise MapperParsingException(
                f"error parsing field [{self.name}], expected an object but "
                f"got [{value!r}]")
        lo, hi = -math.inf, math.inf
        for k, v in value.items():
            if k == "gte":
                lo = self._bound(v)
            elif k == "gt":
                lo = self._next_up(self._bound(v))
            elif k == "lte":
                hi = self._bound(v)
            elif k == "lt":
                hi = self._next_down(self._bound(v))
            else:
                raise MapperParsingException(
                    f"error parsing field [{self.name}], unknown range "
                    f"parameter [{k}]")
        return lo, hi

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return None

    def numeric_for_query(self, value):
        return self._bound(value)


class IntegerRangeFieldType(RangeFieldType):
    type_name = "integer_range"

    def _bound(self, v):
        return float(int(float(v)))

    def _next_up(self, v):
        return v + 1.0

    def _next_down(self, v):
        return v - 1.0


class LongRangeFieldType(IntegerRangeFieldType):
    type_name = "long_range"


class FloatRangeFieldType(RangeFieldType):
    type_name = "float_range"

    def _bound(self, v):
        return float(v)


class DoubleRangeFieldType(FloatRangeFieldType):
    type_name = "double_range"


class DateRangeFieldType(RangeFieldType):
    type_name = "date_range"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        fmt = self.params.get("format")
        self.formats = fmt.split("||") if isinstance(fmt, str) else None

    def _bound(self, v):
        return float(parse_date(v, self.formats))

    def _next_up(self, v):  # one millisecond
        return v + 1.0

    def _next_down(self, v):
        return v - 1.0


class IpRangeFieldType(RangeFieldType):
    type_name = "ip_range"

    def _bound(self, v):
        return float(parse_ip(v))

    # exclusive bounds step one float64 ulp (the base class's): a +1 step
    # is below the ulp at IPv6 magnitudes and would turn gt into gte

    def parse_range(self, value):
        # the CIDR shorthand "10.0.0.0/8"
        if isinstance(value, str) and "/" in value:
            net = ipaddress.ip_network(value, strict=False)
            lo = net.network_address
            hi = net.broadcast_address
            if isinstance(lo, ipaddress.IPv4Address):
                lo = ipaddress.IPv6Address(f"::ffff:{lo}")
                hi = ipaddress.IPv6Address(f"::ffff:{hi}")
            return float(int(lo)), float(int(hi))
        return super().parse_range(value)


class TokenCountFieldType(NumberFieldType):
    """token_count: the analyzed token count as a numeric doc value, so
    term and range queries run against the column."""

    type_name = "token_count"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.analyzer = self.params.get("analyzer", "standard")

    def doc_value(self, value):  # counted by count_tokens at parse time
        return None

    def count_tokens(self, value, analyzers) -> float:
        return float(len(analyzers.get(self.analyzer).analyze(str(value))))


class BinaryFieldType(FieldType):
    """binary: a base64 payload, not searchable; with ``doc_values`` the
    string lands in an ordinal column."""

    type_name = "binary"
    has_doc_values = False
    ordinal_doc_values = True

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        if not self.doc_values:
            return None
        s = str(value)
        try:
            base64.b64decode(s, validate=True)
        except Exception:
            raise MapperParsingException(
                f"failed to parse field [{self.name}]: invalid base64") from None
        return s


class Murmur3FieldType(NumberFieldType):
    """murmur3: the value's murmur3 hash as a numeric doc value, so a
    cardinality aggregation skips hashing at query time."""

    type_name = "murmur3"

    def doc_value(self, value):
        from elasticsearch_tpu_torch.utils.murmur3 import murmur3_32

        return float(murmur3_32(str(value).encode("utf-8")))


class DenseVectorFieldType(FieldType):
    """dense_vector: one fixed-dimension float embedding per document.
    The values are neither inverted-index terms nor scalar doc values: they
    land in a per-segment ``[nd_pad, dims]`` column on the bf16 grid
    (``index/segment.VectorColumn``), scored by the kNN kernel. The
    ``similarity`` mapping parameter picks the metric."""

    type_name = "dense_vector"
    has_doc_values = False

    SIMILARITIES = ("cosine", "dot_product")

    def __init__(self, name, params=None):
        super().__init__(name, params)
        dims = self.params.get("dims")
        if dims is None:
            raise MapperParsingException(
                f"Field [{name}] of type [dense_vector] misses required "
                f"parameter [dims]")
        try:
            self.dims = int(dims)
        except (TypeError, ValueError):
            raise MapperParsingException(
                f"Field [{name}]: [dims] must be an integer, got "
                f"[{dims!r}]") from None
        if self.dims < 1:
            raise MapperParsingException(
                f"Field [{name}]: [dims] must be a positive integer, got "
                f"[{self.dims}]")
        self.similarity = self.params.get("similarity", "cosine")
        if self.similarity not in self.SIMILARITIES:
            raise MapperParsingException(
                f"Field [{name}]: unknown [similarity] "
                f"[{self.similarity}]; expected one of "
                f"{list(self.SIMILARITIES)}")

    def parse_vector(self, value) -> List[float]:
        """One document's vector: a list of exactly ``dims`` finite
        numbers; anything else is a 400 at index time."""
        if not isinstance(value, (list, tuple)):
            raise MapperParsingException(
                f"failed to parse field [{self.name}] of type "
                f"[dense_vector]: expected an array of {self.dims} "
                f"numbers, got [{value!r}]")
        if len(value) != self.dims:
            raise MapperParsingException(
                f"failed to parse field [{self.name}]: the [dims] of the "
                f"vector [{len(value)}] does not match the mapping "
                f"[{self.dims}]")
        out = []
        for v in value:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise MapperParsingException(
                    f"failed to parse field [{self.name}] of type "
                    f"[dense_vector]: non-numeric element [{v!r}]")
            f = float(v)
            if math.isnan(f) or math.isinf(f):
                raise MapperParsingException(
                    f"failed to parse field [{self.name}]: non-finite "
                    f"vector element")
            out.append(f)
        return out

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return None


class JoinFieldType(FieldType):
    """join (ParentJoinFieldMapper): the index's one relation field,
    declaring parent -> child relations. A doc's value is its relation
    name (a parent) or ``{"name": ..., "parent": id}`` (a child). The name
    is an inverted-index term and an ordinal column ``<field>``; the
    parent id an ordinal column ``<field>#parent``. A child must live on
    its parent's shard (the index checks its routing)."""

    type_name = "join"
    ordinal_doc_values = True

    def __init__(self, name, params=None):
        super().__init__(name, params)
        rel = self.params.get("relations") or {}
        # parent -> [children]
        self.relations: dict = {
            p: (c if isinstance(c, list) else [c]) for p, c in rel.items()}
        self._parent_of = {c: p for p, cs in self.relations.items()
                           for c in cs}

    def parent_of(self, child_name: str) -> Optional[str]:
        return self._parent_of.get(child_name)

    def is_parent(self, name: str) -> bool:
        return name in self.relations

    def valid_relation(self, name: str) -> bool:
        return name in self.relations or name in self._parent_of

    def parse_join(self, value) -> tuple:
        """-> (relation name, parent id or None)."""
        if isinstance(value, str):
            name, parent = value, None
        elif isinstance(value, dict):
            name = value.get("name")
            parent = value.get("parent")
        else:
            raise MapperParsingException(
                f"failed to parse join field [{self.name}] value [{value!r}]")
        if not self.valid_relation(name):
            raise MapperParsingException(
                f"unknown join name [{name}] for field [{self.name}]")
        if name in self._parent_of and parent is None:
            raise MapperParsingException(
                f"[parent] is missing for join field [{self.name}]")
        if (name in self.relations and name not in self._parent_of
                and parent is not None):
            raise MapperParsingException(
                f"[parent] is specified but the join name [{name}] is a "
                f"parent")
        return str(name), (str(parent) if parent is not None else None)

    def index_terms(self, value, analyzers):
        name, _ = self.parse_join(value)
        return [name]

    def doc_value(self, value):
        return None  # DocumentMapper._index_single fills both columns


class PercolatorFieldType(FieldType):
    """percolator: a stored query DSL object for inverse search. The query
    lives in ``_source``; the ``percolate`` query runs every stored query
    against a one-doc segment of the candidate document."""

    type_name = "percolator"
    has_doc_values = False

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return None


class CompletionFieldType(FieldType):
    """completion: autocomplete inputs in the field's sorted ordinal
    column, the weight in a parallel ``<field>#weight`` numeric column,
    context values in ``<field>#ctx.<name>`` ordinal columns."""

    type_name = "completion"
    ordinal_doc_values = True

    def __init__(self, name, params=None):
        super().__init__(name, params)
        # [{"name": ..., "type": "category" | "geo", "precision": int}]
        self.contexts = {c["name"]: c for c in self.params.get("contexts", [])}

    def parse_completion(self, value):
        """-> (inputs: [str], weight: float, contexts: {name: [str]}); a
        geo context value encodes to a 12-character geohash."""
        if isinstance(value, str):
            return [value], 1.0, {}
        if isinstance(value, list):
            return [str(v) for v in value], 1.0, {}
        if isinstance(value, dict):
            inputs = value.get("input", [])
            inputs = [inputs] if isinstance(inputs, str) else [str(v) for v in inputs]
            ctx_out = {}
            for cname, cvals in (value.get("contexts") or {}).items():
                cdef = self.contexts.get(cname)
                if cdef is None:
                    raise MapperParsingException(
                        f"context [{cname}] is not defined on completion "
                        f"field [{self.name}]")
                if not isinstance(cvals, list):
                    cvals = [cvals]
                if cdef.get("type", "category") == "geo":
                    from elasticsearch_tpu_torch.utils.geohash import encode

                    encoded = []
                    for p in cvals:
                        try:
                            if isinstance(p, dict):
                                encoded.append(
                                    encode(float(p["lat"]), float(p["lon"]), 12))
                            elif isinstance(p, str) and "," in p:
                                lat, lon = p.split(",", 1)
                                encoded.append(
                                    encode(float(lat), float(lon), 12))
                            else:  # a raw geohash
                                encoded.append(str(p))
                        except (KeyError, TypeError, ValueError) as e:
                            raise MapperParsingException(
                                f"failed to parse geo context [{cname}] of "
                                f"completion field [{self.name}]: {p!r}"
                            ) from e
                    ctx_out[cname] = encoded
                else:
                    ctx_out[cname] = [str(c) for c in cvals]
            return inputs, float(value.get("weight", 1.0)), ctx_out
        raise MapperParsingException(
            f"failed to parse completion field [{self.name}] value [{value!r}]"
        )

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return None


class GeoShapeFieldType(FieldType):
    """geo_shape: GeoJSON or WKT geometries kept per doc on the host, with
    a dense bbox table for the query's prefilter (``utils/geometry.py``)."""

    type_name = "geo_shape"
    has_doc_values = False

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return None

    def parse_shape_value(self, value):
        """Validate at index time; the raw value is stored and its
        geometry built when a query first reads the segment's column."""
        from elasticsearch_tpu_torch.utils.geometry import parse_shape

        parse_shape(value)  # raises MapperParsingException on bad input
        return value


FIELD_TYPES = {
    t.type_name: t
    for t in [TextFieldType, KeywordFieldType, LongFieldType,
              IntegerFieldType, ShortFieldType, ByteFieldType,
              DoubleFieldType, FloatFieldType, HalfFloatFieldType,
              ScaledFloatFieldType, DateFieldType, BooleanFieldType,
              IpFieldType, GeoPointFieldType, IntegerRangeFieldType,
              LongRangeFieldType, FloatRangeFieldType, DoubleRangeFieldType,
              DateRangeFieldType, IpRangeFieldType, TokenCountFieldType,
              BinaryFieldType, Murmur3FieldType, DenseVectorFieldType,
              JoinFieldType, GeoShapeFieldType, CompletionFieldType,
              PercolatorFieldType]
}


def join_field_of(mapper_service) -> Optional[JoinFieldType]:
    """The index's one join field, if mapped."""
    for ft in mapper_service.mapper.fields.values():
        if isinstance(ft, JoinFieldType):
            return ft
    return None


def create_field_type(name: str, params: dict) -> FieldType:
    typ = params.get("type")
    if typ is None and "properties" in params:
        typ = "object"
    cls = FIELD_TYPES.get(typ)
    if cls is None:
        raise MapperParsingException(
            f"No handler for type [{typ}] declared on field [{name}]"
        )
    return cls(name, params)
