"""Field types: JSON value -> indexable terms + columnar doc values.

Counterpart of ``elasticsearch_tpu/mapper/field_types.py``, cut to the
types this slice serves: ``text``, ``keyword``, ``long``, ``integer``,
``double`` (and ``float``, which dynamic mapping picks for JSON floats).
Any other type raises the JAX package's "No handler for type" error.
Numeric doc values are float64, as in the JAX package (x64 is on there).
"""

from __future__ import annotations

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


class FieldType:
    """Base field type; mirrors the mapping parameters (index, doc_values,
    boost, null_value)."""

    type_name = "object"
    has_doc_values = True

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
        # per-field similarity name (only the default BM25 is ported)
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


FIELD_TYPES = {
    t.type_name: t
    for t in [TextFieldType, KeywordFieldType, LongFieldType,
              IntegerFieldType, DoubleFieldType, FloatFieldType]
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
