"""Mapping (schema) service and document parsing.

Counterpart of ``elasticsearch_tpu/mapper/mapping.py``: a mapping is a tree
of properties; parsing a JSON doc produces inverted-index terms and doc
values per field, and possibly a dynamic mapping update. Dynamic mapping
follows 6.x: a string becomes ``text`` with a ``.keyword`` sub-field, an
int ``long``, a float ``float``. Nested objects, dates, booleans and the
other field types are later slices and raise.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    MapperParsingException,
)
from elasticsearch_tpu_torch.mapper.field_types import (
    FieldType,
    create_field_type,
)

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
    mapping_update: Optional[dict] = None


class DocumentMapper:
    """A compiled mapping for one index: flat field-path -> FieldType."""

    def __init__(self, mapping: dict, analyzers: AnalysisRegistry,
                 total_fields_limit: int = 1000):
        self.mapping = mapping
        self.analyzers = analyzers
        self.total_fields_limit = total_fields_limit
        self.fields: Dict[str, FieldType] = {}
        self._object_paths: set = set()
        self._compile("", mapping.get("properties", {}))
        if len(self.fields) > total_fields_limit:
            raise IllegalArgumentException(
                f"Limit of total fields [{total_fields_limit}] in index has been exceeded"
            )

    def _compile(self, prefix: str, properties: dict) -> None:
        for name, params in properties.items():
            path = f"{prefix}{name}"
            if "properties" in params and "type" not in params:
                self._object_paths.add(path)
                self._compile(path + ".", params["properties"])
                continue
            self.fields[path] = create_field_type(path, params)
            for sub_name, sub_params in (params.get("fields") or {}).items():
                sub_path = f"{path}.{sub_name}"
                self.fields[sub_path] = create_field_type(sub_path, sub_params)

    def field_type(self, path: str) -> Optional[FieldType]:
        return self.fields.get(path)

    def parse(self, doc_id: str, source: dict, routing: Optional[str] = None,
              dynamic: str = "true") -> ParsedDocument:
        out = ParsedDocument(doc_id=doc_id, source=source, routing=routing)
        new_props: dict = {}
        self._parse_object("", source, out, self.mapping.get("properties", {}),
                           new_props, dynamic)
        if new_props:
            out.mapping_update = {"properties": new_props}
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
        if ft.index:
            terms = ft.index_terms(v, self.analyzers)
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


class MapperService:
    """Per-index mapping holder with merge semantics (MapperService.merge):
    merging an incompatible type change fails; new fields extend the tree."""

    def __init__(self, analyzers: AnalysisRegistry, mapping: Optional[dict] = None,
                 total_fields_limit: int = 1000, similarity_service=None):
        self.analyzers = analyzers
        self.total_fields_limit = total_fields_limit
        if similarity_service is None:
            from elasticsearch_tpu_torch.index.similarity import SimilarityService
            similarity_service = SimilarityService()
        self.similarity_service = similarity_service
        self._mapping = copy.deepcopy(mapping) if mapping else {"properties": {}}
        self._mapper = DocumentMapper(self._mapping, analyzers, total_fields_limit)
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

    def mapping_dict(self) -> dict:
        return copy.deepcopy(self._mapping)

    def field_type(self, path: str) -> Optional[FieldType]:
        return self._mapper.field_type(path)

    def merge(self, new_mapping: dict) -> None:
        merged = copy.deepcopy(self._mapping)
        self._merge_props(
            merged.setdefault("properties", {}),
            copy.deepcopy(new_mapping.get("properties", {})),
            "",
        )
        if "dynamic" in new_mapping:
            merged["dynamic"] = new_mapping["dynamic"]
        self._mapper = DocumentMapper(merged, self.analyzers, self.total_fields_limit)
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
