"""Node: the in-process server API.

Counterpart of ``elasticsearch_tpu/node.py``, cut to this slice's entry
points: ``create_index``, ``index_doc``, ``bulk``, ``refresh``,
``get_doc``, ``delete_doc`` and ``search`` over one index (through the
index's micro-batcher and mesh plane; ``search.batch.*``,
``search.knn.*`` and ``search.pallas.*`` node settings pass to every
index, the last being the postings codec's node default and block-max
pruning). A search body may
carry a top-level ``knn`` section: alone it is a vector search, beside
``query`` a hybrid one (``IndexService._search_hybrid``). ``Node()`` runs
on ``cuda`` and raises without a GPU; ``Node(device="cpu")`` runs the
kernels' plain versions and exists for tests. Nothing is kept on disk (the
translog, store, REST layer and cluster state are later slices).
"""

from __future__ import annotations

import time
import uuid as _uuid
from typing import Dict, List, Optional

from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.errors import (
    ActionRequestValidationException,
    ElasticsearchTpuException,
    IllegalArgumentException,
    IndexAlreadyExistsException,
    IndexNotFoundException,
)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService

MAPPING_TOP_LEVEL_KEYS = {
    "properties", "dynamic", "dynamic_templates", "_source", "_meta",
    "_routing", "_all", "_field_names", "_size", "_parent",
    "date_detection", "numeric_detection", "dynamic_date_formats",
}


def _unwrap_typed_mapping(mappings):
    """6.x typed mapping form: {"my_type": {...}} wraps the real mapping in
    a single custom type name. Returns (mapping, type_name)."""
    if isinstance(mappings, dict) and len(mappings) == 1:
        (key, inner), = mappings.items()
        if (key not in MAPPING_TOP_LEVEL_KEYS and isinstance(inner, dict)
                and (not inner or set(inner) & MAPPING_TOP_LEVEL_KEYS)):
            return inner, key
    return mappings, "_doc"


class Node:
    def __init__(self, settings: Settings = Settings.EMPTY, device="cuda"):
        self.settings = settings
        self.device = resolve_device(device)
        self.indices: Dict[str, IndexService] = {}

    # ------------------------------------------------------------------
    # Index APIs
    # ------------------------------------------------------------------

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        body = body or {}
        if not name or name != name.lower() or name.startswith(("_", "-", "+")):
            raise IllegalArgumentException(f"Invalid index name [{name}]")
        if name in self.indices:
            raise IndexAlreadyExistsException(name)
        unknown = sorted(set(body) - {"settings", "mappings"})
        if unknown:
            raise IllegalArgumentException(
                f"create-index sections {unknown} are not supported by the "
                f"PyTorch port yet")
        settings = Settings.from_dict(body.get("settings") or {}).with_index_prefix()
        # node-level micro-batching, kNN, postings-codec and pruning config
        # (search.batch.*, search.knn.*, search.pallas.*, node scope) seeds
        # each index at the lowest precedence; the index's own settings
        # (index.search.pallas.postings_codec,
        # index.mapping.dense_vector.max_dims, ...) come with the body
        for prefix in ("search.batch.", "search.knn.", "search.pallas."):
            settings = self.settings.filtered_by_prefix(prefix).merged_with(
                settings)
        mappings, _doc_type = _unwrap_typed_mapping(body.get("mappings") or {})
        self.indices[name] = IndexService(name, settings, mappings,
                                          device=self.device)
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def index_service(self, name: str, auto_create: bool = False) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            if not auto_create:
                raise IndexNotFoundException(name)
            self.create_index(name)
            svc = self.indices[name]
        return svc

    def refresh(self, index: str) -> dict:
        svc = self.index_service(index)
        svc.refresh()
        n = svc.num_shards
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    # ------------------------------------------------------------------
    # Document APIs
    # ------------------------------------------------------------------

    def index_doc(self, index: str, doc_id: Optional[str], source: dict,
                  routing: Optional[str] = None, refresh=None, **kw) -> dict:
        if doc_id is not None:
            if doc_id == "":
                raise IllegalArgumentException(
                    "if _id is specified it must not be empty")
            if len(doc_id.encode("utf-8")) > 512:
                raise ActionRequestValidationException(
                    f"Validation Failed: 1: id is too long, must be no "
                    f"longer than 512 bytes but was: "
                    f"{len(doc_id.encode('utf-8'))};")
        svc = self.index_service(index, auto_create=True)
        if doc_id is None:
            doc_id = _uuid.uuid4().hex[:20]
            kw.setdefault("op_type", "create")
        r = svc.index_doc(doc_id, source, routing, **kw)
        self._maybe_refresh(svc, refresh, doc_id, routing)
        return r

    def _maybe_refresh(self, svc: IndexService, refresh, doc_id, routing) -> None:
        """refresh=true refreshes only the written shard."""
        if refresh in (True, "true", ""):
            svc.shards[svc._route(doc_id, routing)].refresh()
        elif refresh not in (None, False, "false"):
            raise IllegalArgumentException(
                f"refresh [{refresh}] is not supported by the PyTorch port yet")

    def get_doc(self, index: str, doc_id: str, routing=None,
                realtime=True) -> dict:
        svc = self.index_service(index)
        g = svc.get_doc(doc_id, routing, realtime=realtime)
        out = {"_index": svc.name, "_type": "_doc", "_id": doc_id,
               "found": g.found}
        if g.found:
            out["_version"] = g.version
            out["_seq_no"] = g.seqno
            out["_source"] = g.source
            if g.routing is not None:
                out["_routing"] = g.routing
        return out

    def delete_doc(self, index: str, doc_id: str, routing=None, refresh=None,
                   **kw) -> dict:
        svc = self.index_service(index)
        r = svc.delete_doc(doc_id, routing, **kw)
        self._maybe_refresh(svc, refresh, doc_id, routing)
        return r

    def bulk(self, operations: List[tuple], refresh=None) -> dict:
        """operations: list of (action, meta, source_or_None)."""
        t0 = time.monotonic()
        items = []
        errors = False
        touched = set()
        for action, meta, source in operations:
            index = meta.get("_index")
            doc_id = meta.get("_id")
            routing = meta.get("routing") or meta.get("_routing")
            try:
                if action == "index":
                    r = self.index_doc(index, doc_id, source, routing)
                    status = 201 if r.get("result") == "created" else 200
                elif action == "create":
                    r = self.index_doc(index, doc_id, source, routing,
                                       op_type="create")
                    status = 201
                elif action == "delete":
                    r = self.delete_doc(index, doc_id, routing)
                    status = 200 if r.get("found") else 404
                else:
                    raise ActionRequestValidationException(
                        f"Malformed action/metadata line, expected one of "
                        f"[create, delete, index] but found [{action}]")
                touched.add(r.get("_index", index))
                item = {action: {**{k: v for k, v in r.items() if k != "found"},
                                 "status": status}}
            except ElasticsearchTpuException as e:  # per-item failure
                errors = True
                item = {action: {"_index": index, "_id": doc_id,
                                 "status": e.status_code,
                                 "error": e.to_dict()["error"]}}
            items.append(item)
        if refresh in (True, "true", ""):
            for name in touched:
                if name in self.indices:
                    self.indices[name].refresh()
        return {"took": int((time.monotonic() - t0) * 1000),
                "errors": errors, "items": items}

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def search(self, index: str, body: Optional[dict] = None) -> dict:
        if "," in index or "*" in index or index == "_all":
            raise IllegalArgumentException(
                "multi-index search is not supported by the PyTorch port yet")
        return self.index_service(index).search(body or {})
