"""Field types: JSON value -> indexable terms + columnar doc values.

Counterpart of ``elasticsearch_tpu/mapper/field_types.py``, cut to the
types the port serves: ``text``, ``keyword``, ``long``, ``integer``,
``double`` (and ``float``, which dynamic mapping picks for JSON floats),
``date``, ``boolean`` and ``dense_vector``.
Any other type raises the JAX package's "No handler for type" error.
Numeric doc values are float64, as in the JAX package (x64 is on there): a
``date`` is its epoch milliseconds (UTC), a ``boolean`` 1.0 or 0.0.
"""

from __future__ import annotations

import datetime as _dt
import math
from typing import Any, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    MapperParsingException,
)

_INT_RANGES = {
    "long": (-(2**63), 2**63 - 1),
    "integer": (-(2**31), 2**31 - 1),
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
        if self.params.get("fielddata"):
            raise MapperParsingException(
                f"Field [{name}]: [fielddata] on text fields is not supported "
                f"by the PyTorch port yet")
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


class DoubleFieldType(NumberFieldType):
    type_name = "double"

    def doc_value(self, value):
        return self._parse(value)


class FloatFieldType(DoubleFieldType):
    type_name = "float"


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


FIELD_TYPES = {
    t.type_name: t
    for t in [TextFieldType, KeywordFieldType, LongFieldType,
              IntegerFieldType, DoubleFieldType, FloatFieldType,
              DateFieldType, BooleanFieldType, DenseVectorFieldType]
}


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
