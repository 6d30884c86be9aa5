"""Mapping (schema) service and document parsing.

Counterpart of ``elasticsearch_tpu/mapper/mapping.py``: a mapping is a tree
of properties; parsing a JSON doc produces inverted-index terms and doc
values per field, and possibly a dynamic mapping update. Dynamic mapping
follows 6.x: a string becomes ``text`` with a ``.keyword`` sub-field (an
ISO-8601 date string ``date``), an int ``long``, a float ``float``, a bool
``boolean``. A ``dense_vector`` field takes one whole
vector per document (``ParsedDocument.vector_values``), its ``dims``
bounded by ``index.mapping.dense_vector.max_dims`` at mapping compile.
A ``geo_point`` value lands in ``geo_values`` as (lat, lon), a range
value in ``range_values`` as its inclusive (lo, hi) bounds, a
``token_count`` as its token count among the numeric values, and a text
field with ``fielddata`` adds its analyzed tokens to the string values.
One document's analysis is memoized by (analyzer, text): a text field,
its fielddata and a ``token_count`` multi-field over the same value
analyze it once.
A ``nested`` path makes each of its objects a sub-document of its own
(``ParsedDocument.nested``, nested-in-nested too), its fields keyed by
their full path; ``include_in_parent`` / ``include_in_root`` also copy
the object's flat fields onto the enclosing document. A ``join`` value
fills the relation's ordinal column ``<field>`` and, for a child, the
parent id's ``<field>#parent``. A legacy ``_parent`` meta field names the
parent type (``MapperService.parent_type``). A ``geo_shape`` value
lands in ``shape_values`` as given (validated); a ``completion`` value's
inputs, weight and contexts become the ordinal column ``<field>``, the
numeric ``<field>#weight`` and the ordinal ``<field>#ctx.<name>``; a
``percolator`` value stays in ``_source`` only. ``{"_size": {"enabled":
true}}`` indexes the source's byte count, ``len(json.dumps(source,
separators=(",", ":"), default=str))``, as the long field ``_size``.
"""

from __future__ import annotations

import copy
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    MapperParsingException,
)
from elasticsearch_tpu_torch.mapper.field_types import (
    CompletionFieldType,
    DenseVectorFieldType,
    FieldType,
    GeoPointFieldType,
    GeoShapeFieldType,
    JoinFieldType,
    LongFieldType,
    RangeFieldType,
    TextFieldType,
    TokenCountFieldType,
    create_field_type,
)

class _DocAnalyzers:
    """The index's analyzers with one document's analysis memoized by
    (analyzer, text): analysis is deterministic, so a value analyzed
    again (fielddata, a token_count multi-field) gets the same tokens."""

    __slots__ = ("_registry", "_memo")

    def __init__(self, registry, memo: dict):
        self._registry = registry
        self._memo = memo

    def get(self, name):
        return _MemoAnalyzer(self._registry.get(name), name, self._memo)


class _MemoAnalyzer:
    __slots__ = ("_analyzer", "_name", "_memo")

    def __init__(self, analyzer, name, memo: dict):
        self._analyzer = analyzer
        self._name = name
        self._memo = memo

    def analyze(self, text):
        key = (self._name, text)
        toks = self._memo.get(key)
        if toks is None:
            toks = self._memo[key] = self._analyzer.analyze(text)
        return toks

    def __getattr__(self, attr):
        return getattr(self._analyzer, attr)


_ISO_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?(Z|[+-]\d{2}:?\d{2})?)?$")


@dataclass
class ParsedDocument:
    """Output of parsing one JSON document."""

    doc_id: str
    source: dict
    routing: Optional[str]
    # field name -> list of index terms (inverted index input)
    terms: Dict[str, List[str]] = field(default_factory=dict)
    # field name -> list of numeric doc values (float) — multi-valued allowed
    numeric_values: Dict[str, List[float]] = field(default_factory=dict)
    # field name -> list of string doc values (ordinal columns)
    string_values: Dict[str, List[str]] = field(default_factory=dict)
    # geo points: field -> [(lat, lon)]
    geo_values: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    # geo shapes: field -> raw GeoJSON dicts / WKT strings
    shape_values: Dict[str, List[Any]] = field(default_factory=dict)
    # range fields: field -> [(lo, hi)], inclusive float bounds
    range_values: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    # dense vectors: field -> ONE [dims] float list per doc (a second
    # vector for the same field in one document is a 400)
    vector_values: Dict[str, List[float]] = field(default_factory=dict)
    mapping_update: Optional[dict] = None
    # nested path -> one sub-document a nested object, in source order
    nested: Dict[str, List["ParsedDocument"]] = field(default_factory=dict)
    # (analyzer, text) -> tokens while the document parses
    analysis_memo: dict = field(default_factory=dict, repr=False,
                                compare=False)


class DocumentMapper:
    """A compiled mapping for one index: flat field-path -> FieldType."""

    def __init__(self, mapping: dict, analyzers: AnalysisRegistry,
                 total_fields_limit: int = 1000,
                 dense_vector_max_dims: int = 1024):
        self.mapping = mapping
        self.analyzers = analyzers
        self.total_fields_limit = total_fields_limit
        # index.mapping.dense_vector.max_dims, checked at mapping compile
        self.dense_vector_max_dims = dense_vector_max_dims
        self.fields: Dict[str, FieldType] = {}
        self._object_paths: set = set()
        # nested object paths ("type": "nested") -> their mapping params
        self.nested_paths: Dict[str, dict] = {}
        # the _size meta field: the source's byte count as a long field
        self.size_enabled = bool((mapping.get("_size") or {}).get("enabled"))
        if self.size_enabled:
            self.fields["_size"] = LongFieldType("_size", {})
        self._compile("", mapping.get("properties", {}))
        if len(self.fields) > total_fields_limit:
            raise IllegalArgumentException(
                f"Limit of total fields [{total_fields_limit}] in index has been exceeded"
            )

    def _compile(self, prefix: str, properties: dict) -> None:
        for name, params in properties.items():
            path = f"{prefix}{name}"
            if params.get("type") == "nested":
                self._object_paths.add(path)
                self.nested_paths[path] = params
                self._compile(path + ".", params.get("properties", {}))
                continue
            if "properties" in params and "type" not in params:
                self._object_paths.add(path)
                self._compile(path + ".", params["properties"])
                continue
            ft = create_field_type(path, params)
            self._check_vector_dims(ft)
            self.fields[path] = ft
            for sub_name, sub_params in (params.get("fields") or {}).items():
                sub_path = f"{path}.{sub_name}"
                if (sub_params or {}).get("type") == "dense_vector":
                    # a multi-field gets the parent's values one element
                    # at a time, which can never carry a whole vector
                    raise MapperParsingException(
                        f"Field [{sub_path}]: [dense_vector] cannot be "
                        f"used in multi-fields")
                self.fields[sub_path] = create_field_type(sub_path, sub_params)

    def _check_vector_dims(self, ft: FieldType) -> None:
        if (isinstance(ft, DenseVectorFieldType)
                and ft.dims > self.dense_vector_max_dims):
            raise IllegalArgumentException(
                f"The number of dimensions for field [{ft.name}] "
                f"[{ft.dims}] exceeds "
                f"[index.mapping.dense_vector.max_dims] "
                f"[{self.dense_vector_max_dims}]")

    def field_type(self, path: str) -> Optional[FieldType]:
        return self.fields.get(path)

    def simple_match_to_fields(self, pattern: str) -> List[str]:
        """Expand a field pattern ('*', 'user.*') to concrete field names."""
        if "*" not in pattern:
            return [pattern] if pattern in self.fields else []
        rx = re.compile("^" + re.escape(pattern).replace(r"\*", ".*") + "$")
        return sorted(f for f in self.fields if rx.match(f))

    def parse(self, doc_id: str, source: dict, routing: Optional[str] = None,
              dynamic: str = "true") -> ParsedDocument:
        out = ParsedDocument(doc_id=doc_id, source=source, routing=routing)
        new_props: dict = {}
        self._parse_object("", source, out, self.mapping.get("properties", {}),
                           new_props, dynamic)
        if new_props:
            out.mapping_update = {"properties": new_props}
        if self.size_enabled:
            out.numeric_values["_size"] = [float(len(json.dumps(
                source, separators=(",", ":"), default=str)))]
        return out

    def _parse_object(self, prefix: str, obj: dict, out: ParsedDocument,
                      props: dict, new_props: dict, dynamic: str) -> None:
        if not isinstance(obj, dict):
            raise MapperParsingException(
                f"object mapping for [{prefix.rstrip('.')}] tried to parse field as "
                "object, but found a concrete value"
            )
        for key, value in obj.items():
            path = f"{prefix}{key}"
            if value is None:
                self._index_null(path, out)
                continue
            if path in self.nested_paths:
                self._parse_nested(path, key, value, out, props, new_props,
                                   dynamic)
                continue
            ft = self.fields.get(path)
            if ft is None and path in self._object_paths and not isinstance(value, dict):
                raise MapperParsingException(
                    f"object mapping for [{path}] tried to parse field [{key}] as "
                    "object, but found a concrete value"
                )
            if ft is None and path in self._object_paths and isinstance(value, dict):
                sub = props.get(key, {}).get("properties", {})
                sub_new = new_props.setdefault(key, {"properties": {}})["properties"] \
                    if dynamic == "true" else {}
                self._parse_object(path + ".", value, out, sub, sub_new, dynamic)
                if dynamic == "true" and not sub_new:
                    new_props.pop(key, None)
                continue
            if ft is None:
                if isinstance(value, dict):
                    if dynamic == "strict":
                        raise MapperParsingException(
                            f"mapping set to strict, dynamic introduction of [{key}] "
                            f"within [{prefix.rstrip('.') or '_doc'}] is not allowed"
                        )
                    if dynamic == "false":
                        continue
                    sub_new = new_props.setdefault(key, {"properties": {}})["properties"]
                    self._object_paths.add(path)
                    self._parse_object(path + ".", value, out, {}, sub_new, dynamic)
                    continue
                if dynamic == "strict":
                    raise MapperParsingException(
                        f"mapping set to strict, dynamic introduction of [{key}] "
                        f"within [{prefix.rstrip('.') or '_doc'}] is not allowed"
                    )
                if dynamic == "false":
                    continue
                sample = value[0] if isinstance(value, list) and value else value
                if sample is None:
                    continue
                params = self._dynamic_type_for(sample)
                ft = create_field_type(path, params)
                self.fields[path] = ft
                if len(self.fields) > self.total_fields_limit:
                    raise IllegalArgumentException(
                        f"Limit of total fields [{self.total_fields_limit}] in index "
                        "has been exceeded"
                    )
                new_props[key] = params
                if params.get("type") == "text":
                    kw_path = f"{path}.keyword"
                    self.fields[kw_path] = create_field_type(
                        kw_path, {"type": "keyword", "ignore_above": 256}
                    )
            self._index_value(ft, value, out)

    def _parse_nested(self, path: str, key: str, value: Any,
                      out: ParsedDocument, props: dict, new_props: dict,
                      dynamic: str) -> None:
        """Each object under a nested path becomes its own sub-document,
        its fields keyed by full path; a null element is skipped."""
        objs = value if isinstance(value, list) else [value]
        sub_props = props.get(key, {}).get("properties", {})
        params_n = self.nested_paths[path]
        sub_new = (
            new_props.setdefault(key, {"type": "nested", "properties": {}})
            ["properties"] if dynamic == "true" else {})
        for obj in objs:
            if obj is None:
                continue
            if not isinstance(obj, dict):
                raise MapperParsingException(
                    f"object mapping for [{path}] tried to parse field "
                    f"[{key}] as object, but found a concrete value")
            sub = ParsedDocument(doc_id=out.doc_id, source=obj, routing=None)
            self._parse_object(path + ".", obj, sub, sub_props, sub_new,
                               dynamic)
            out.nested.setdefault(path, []).append(sub)
            if params_n.get("include_in_parent") or params_n.get(
                    "include_in_root"):
                # the object's flat fields onto the enclosing doc, but not
                # its inner nested docs (``sub`` carries those)
                inc = ParsedDocument(doc_id=out.doc_id, source=obj,
                                     routing=None)
                self._parse_object(path + ".", obj, inc, sub_props,
                                   sub_new if dynamic == "true" else {},
                                   dynamic)
                for store in ("terms", "numeric_values", "string_values",
                              "geo_values", "range_values", "shape_values"):
                    for f, vals in getattr(inc, store).items():
                        getattr(out, store).setdefault(f, []).extend(vals)
                for f, vec in inc.vector_values.items():
                    # one vector a field a doc: two objects carrying the
                    # same dense_vector path cannot both flatten
                    if f in out.vector_values:
                        raise MapperParsingException(
                            f"Field [{f}] of type [dense_vector] doesn't "
                            f"support indexing multiple values for the "
                            f"same field in one document")
                    out.vector_values[f] = vec
        if dynamic == "true" and not sub_new:
            new_props.pop(key, None)

    def _dynamic_type_for(self, sample: Any) -> dict:
        """Dynamic mapping rules (DocumentParser.createBuilderFromFieldType)."""
        if isinstance(sample, bool):
            return {"type": "boolean"}
        if isinstance(sample, int):
            return {"type": "long"}
        if isinstance(sample, float):
            return {"type": "float"}
        if isinstance(sample, str):
            if _ISO_DATE_RE.match(sample):
                return {"type": "date"}
            return {
                "type": "text",
                "fields": {"keyword": {"type": "keyword", "ignore_above": 256}},
            }
        raise MapperParsingException(f"cannot infer mapping for value [{sample!r}]")

    def _index_null(self, path: str, out: ParsedDocument) -> None:
        ft = self.fields.get(path)
        if ft is not None and ft.null_value is not None:
            self._index_value(ft, ft.null_value, out)

    def _index_value(self, ft: FieldType, value: Any, out: ParsedDocument) -> None:
        if isinstance(ft, DenseVectorFieldType):
            # the whole array is one value, never split into elements
            if ft.name in out.vector_values:
                raise MapperParsingException(
                    f"Field [{ft.name}] of type [dense_vector] doesn't "
                    f"support indexing multiple values for the same "
                    f"field in one document")
            out.vector_values[ft.name] = ft.parse_vector(value)
            return
        values = value if isinstance(value, list) else [value]
        for v in values:
            if v is None:
                if ft.null_value is not None:
                    v = ft.null_value
                else:
                    continue
            self._index_single(ft, v, out)
        # multi-fields (e.g. text + .keyword) get the same values
        for sub_name in (ft.params.get("fields") or {}):
            sub_ft = self.fields.get(f"{ft.name}.{sub_name}")
            if sub_ft is not None:
                for v in values:
                    if v is not None:
                        self._index_single(sub_ft, v, out)

    def _index_single(self, ft: FieldType, v: Any, out: ParsedDocument) -> None:
        analyzers = _DocAnalyzers(self.analyzers, out.analysis_memo)
        if isinstance(ft, GeoPointFieldType):
            out.geo_values.setdefault(ft.name, []).append(ft.parse_point(v))
            return
        if isinstance(ft, GeoShapeFieldType):
            out.shape_values.setdefault(ft.name, []).append(
                ft.parse_shape_value(v))
            return
        if isinstance(ft, JoinFieldType):
            name, parent = ft.parse_join(v)
            out.terms.setdefault(ft.name, []).append(name)
            out.string_values.setdefault(ft.name, []).append(name)
            if parent is not None:
                out.string_values.setdefault(f"{ft.name}#parent",
                                             []).append(parent)
            return
        if isinstance(ft, RangeFieldType):
            out.range_values.setdefault(ft.name, []).append(ft.parse_range(v))
            return
        if isinstance(ft, TokenCountFieldType):
            out.numeric_values.setdefault(ft.name, []).append(
                ft.count_tokens(v, analyzers))
            return
        if isinstance(ft, CompletionFieldType):
            inputs, weight, ctxs = ft.parse_completion(v)
            out.string_values.setdefault(ft.name, []).extend(inputs)
            out.numeric_values.setdefault(f"{ft.name}#weight", []).append(
                weight)
            for cname, cvals in ctxs.items():
                out.string_values.setdefault(
                    f"{ft.name}#ctx.{cname}", []).extend(cvals)
            return
        if ft.index:
            terms = ft.index_terms(v, analyzers)
            if terms:
                out.terms.setdefault(ft.name, []).extend(terms)
        if ft.doc_values:
            dv = ft.doc_value(v)
            if dv is None:
                pass
            elif isinstance(dv, str):
                out.string_values.setdefault(ft.name, []).append(dv)
            else:
                out.numeric_values.setdefault(ft.name, []).append(float(dv))
        elif isinstance(ft, TextFieldType) and ft.fielddata:
            # text fielddata: the terms double as string values for the
            # aggregations
            out.string_values.setdefault(ft.name, []).extend(
                ft.index_terms(v, analyzers))


class MapperService:
    """Per-index mapping holder with merge semantics (MapperService.merge):
    merging an incompatible type change fails; new fields extend the tree."""

    def __init__(self, analyzers: AnalysisRegistry, mapping: Optional[dict] = None,
                 total_fields_limit: int = 1000, similarity_service=None,
                 dense_vector_max_dims: int = 1024):
        self.analyzers = analyzers
        self.total_fields_limit = total_fields_limit
        self.dense_vector_max_dims = dense_vector_max_dims
        if similarity_service is None:
            from elasticsearch_tpu_torch.index.similarity import SimilarityService
            similarity_service = SimilarityService()
        self.similarity_service = similarity_service
        self._mapping = copy.deepcopy(mapping) if mapping else {"properties": {}}
        self._mapper = DocumentMapper(self._mapping, analyzers, total_fields_limit,
                                      dense_vector_max_dims)
        self._validate_similarities()

    def _validate_similarities(self) -> None:
        for ft in self._mapper.fields.values():
            sim_name = getattr(ft, "similarity_name", None)
            if sim_name is not None:
                self.similarity_service.get(sim_name)  # raises on unknown

    @property
    def mapper(self) -> DocumentMapper:
        return self._mapper

    @property
    def dynamic(self) -> str:
        return str(self._mapping.get("dynamic", "true")).lower()

    @property
    def parent_type(self) -> Optional[str]:
        """The legacy ``_parent`` meta field's type: a single-doc op on
        the index then needs ``parent`` or ``routing``."""
        return (self._mapping.get("_parent") or {}).get("type")

    def mapping_dict(self) -> dict:
        return copy.deepcopy(self._mapping)

    def mapping_equals(self, other: dict) -> bool:
        """Whether the current mapping equals ``other`` (no copy)."""
        return self._mapping == other

    def field_type(self, path: str) -> Optional[FieldType]:
        return self._mapper.field_type(path)

    def merge(self, new_mapping: dict) -> None:
        merged = copy.deepcopy(self._mapping)
        self._merge_props(
            merged.setdefault("properties", {}),
            copy.deepcopy(new_mapping.get("properties", {})),
            "",
        )
        for meta_key in ("dynamic", "_size"):
            if meta_key in new_mapping:
                merged[meta_key] = new_mapping[meta_key]
        self._mapper = DocumentMapper(merged, self.analyzers, self.total_fields_limit,
                                      self.dense_vector_max_dims)
        self._mapping = merged
        self._validate_similarities()

    def _merge_props(self, base: dict, incoming: dict, prefix: str) -> None:
        for name, params in incoming.items():
            path = f"{prefix}{name}"
            if name not in base:
                base[name] = params
                continue
            existing = base[name]
            existing_type = existing.get("type", "object" if "properties" in existing else None)
            incoming_type = params.get("type", "object" if "properties" in params else None)
            if existing_type != incoming_type:
                raise IllegalArgumentException(
                    f"mapper [{path}] of different type, current_type [{existing_type}], "
                    f"merged_type [{incoming_type}]"
                )
            if "properties" in params:
                self._merge_props(
                    existing.setdefault("properties", {}), params["properties"], path + "."
                )
            else:
                for k, v in params.items():
                    if k in ("type", "properties"):
                        continue
                    if k == "fields":
                        existing.setdefault("fields", {}).update(v)
                    else:
                        existing[k] = v

    def parse_document(self, doc_id: str, source: dict,
                       routing: Optional[str] = None) -> ParsedDocument:
        parsed = self._mapper.parse(doc_id, source, routing, dynamic=self.dynamic)
        if parsed.mapping_update:
            self.merge(parsed.mapping_update)
        return parsed
