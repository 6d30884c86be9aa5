"""Node: the in-process server API.

Counterpart of ``elasticsearch_tpu/node.py``, cut to this slice's entry
points: ``create_index``, ``delete_index``, ``index_doc``, ``bulk``
(index, create, update and delete lines), ``refresh``, ``get_doc``,
``mget``, ``delete_doc``, ``update_doc``, ``search`` (one index through
the index's micro-batcher and mesh plane; names, wildcards, comma lists
and ``_all`` through ``resolve_search_indices``; ``search.batch.*``,
``search.knn.*``, ``search.pallas.*`` and ``search.aggs.*`` node settings
pass to every index: ``search.pallas.*`` is the postings codec's node
default and block-max pruning, ``search.aggs.fused`` the fused
aggregations), ``msearch`` (each entry served serially through ``search``,
an index pattern in its header too) and ``health``.

A search gets one ``SearchDeadline`` (its ``timeout``, else
``search.default_search_timeout``) and the node's
``search.default_allow_partial_results`` when it leaves
``allow_partial_search_results`` unset. An expression naming more than
one index is served by ``_multi_index_search``: a per-shard fan-out over
every index on the host rung, with per-shard failure isolation and the
deadline, the hits merged by score or by sort (each with its ``_index``),
collapse and aggregations over every index's views. A search body may carry a top-level ``knn`` section: alone it
is a vector search, beside ``query`` a hybrid one
(``IndexService._search_hybrid``). The node owns the named thread pools
(``common/thread_pool.py``) that the REST layer runs handlers on:
``rest.http_server.HttpServer(node, port=...)`` serves the
Elasticsearch-compatible HTTP API over it.

The node configures the process-wide memory breakers
(``indices.breaker.*``, ``node.breaker_service``: the REST in-flight
breaker and the aggregations' request breaker read it), the device-memory
ledger's budget (``search.memory.hbm_budget_bytes``) and the staging
retry (``search.staging.retry.*``) from its settings at startup.

``Node()`` runs on ``cuda`` and raises without a GPU;
``Node(device="cpu")`` runs the kernels' plain versions and exists for
tests.

``Node(settings, data_path=..., device=...)`` (or a ``path.data``
setting) is durable, in the JAX package's layout: each index keeps
``<data_path>/indices/<name>/_meta.json`` (its settings, mapping and
aliases) and one translog and store a shard under it. Opening a node over
an existing data path recovers every index before it returns, and a
recovered index stages its segments on the node's device lazily, as a
new one does. ``flush``, ``synced_flush`` and ``force_merge`` take an
index expression; ``close`` synced-flushes every index of a durable node
before it releases them, so the next open replays nothing. Without a data
path nothing is kept on disk (no translog either). There is no cluster
state beside the ``indices`` dict, so no aliases or templates: a
``_meta.json``'s ``aliases`` are kept as read and written back
unchanged, and the JAX package's ``_state/`` directory is left unread.

Scroll is point in time, as in the JAX package: ``search(index, body,
scroll="1m")`` pins every shard's segment set and live masks
(``PinnedSegmentView``) of every index the expression names before the
first page, and every page reads that snapshot. The ordered result is a lazily extended prefix
(``_extend_pit_entries``): each extension re-queries the pinned views
with a geometrically growing top-k and appends the refs it has not
served, so pages neither skip nor repeat a doc, across ties too.
``scroll`` serves the next page, ``clear_scroll`` drops contexts (ids or
``_all``), and a keep-alive reaper thread drops expired ones on time;
``close`` stops and joins it. Dropping a context frees its pinned live
tensors. The JAX package's cursor scroll serves cross-cluster search
only, and the port has no remote clusters.
"""

from __future__ import annotations

import fnmatch
import json
import os
import shutil
import threading
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
    InvalidIndexNameException,
    ResourceNotFoundException,
)
from elasticsearch_tpu_torch.common.breaker import configure_breaker_service
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import (
    PATH_DATA,
    SEARCH_ALLOW_PARTIAL_RESULTS,
    SEARCH_MEMORY_HBM_BUDGET,
    SEARCH_STAGING_RETRY_BACKOFF_MS,
    SEARCH_STAGING_RETRY_MAX_ATTEMPTS,
    Settings,
    parse_time_value,
)
from elasticsearch_tpu_torch.common.staging import configure_staging_retry
from elasticsearch_tpu_torch.common.thread_pool import ThreadPool
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.index.seqno import check_active_shards

_INVALID_INDEX_CHARS = set(' "*\\<>|,/?#')

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


def _pins_of(pinned: Dict[tuple, list], name: str) -> Dict[int, list]:
    """One index's pinned views, {shard: [views]}, out of a scroll's
    {(index, shard): [views]}."""
    return {sid: views for (n, sid), views in pinned.items() if n == name}


class Node:
    def __init__(self, settings: Settings = Settings.EMPTY,
                 data_path: Optional[str] = None, device="cuda"):
        self.settings = settings
        self.device = resolve_device(device)
        self.data_path = data_path or PATH_DATA.get(settings)
        self.persistent_path = (data_path is not None
                                or settings.get("path.data") is not None)
        self.node_id = _uuid.uuid4().hex[:20]
        self.node_name = settings.get_str("node.name", "node-0")
        self.cluster_name = settings.get_str("cluster.name",
                                             "elasticsearch-tpu")
        self.indices: Dict[str, IndexService] = {}
        # named bounded executors: the REST layer runs handler work on the
        # action's pool, and a full queue rejects with 429.
        # search.queue.size bounds the search pool's queue, as in
        # elasticsearch_tpu/node.py. Workers start on the first submit.
        self.thread_pool = ThreadPool(overrides={
            "search": {"queue_size": settings.get_int(
                "search.queue.size", 1000)}})
        # the hierarchical memory breakers (indices.breaker.*): one
        # process-wide accounting, this node's limits
        self.breaker_service = configure_breaker_service(settings)
        # the device staging budget: over it, stagings LRU-evict, then the
        # mesh plane demotes to the host rung (never a 429 or a 5xx)
        memory_accountant().set_budget(SEARCH_MEMORY_HBM_BUDGET.get(settings))
        configure_staging_retry(
            max_attempts=SEARCH_STAGING_RETRY_MAX_ATTEMPTS.get(settings),
            backoff_ms=SEARCH_STAGING_RETRY_BACKOFF_MS.get(settings))
        # open scroll contexts: each pins its segment views (and their
        # device live tensors) until cleared or expired
        self.scrolls: Dict[str, dict] = {}
        self._scroll_lock = threading.Lock()
        # the keep-alive reaper frees expired contexts on time, not only
        # when another scroll request arrives
        self._reaper_stop = threading.Event()
        self._reaper = threading.Thread(
            target=self._reap_expired_scrolls_loop,
            name=f"scroll-reaper[{self.node_name}]", daemon=True)
        self._reaper.start()
        if self.persistent_path:
            self._recover_indices_from_disk()

    def close(self) -> None:
        """Stop and join the scroll reaper and drop every scroll context;
        synced-flush every index of a durable node (its metadata first),
        so a restart replays nothing; then stop the thread pools and
        release every index's device memory."""
        self._reaper_stop.set()
        self._reaper.join()
        with self._scroll_lock:
            self.scrolls.clear()
        if self.persistent_path:
            for name in list(self.indices):
                self._persist_index_meta(name)
                self.indices[name].synced_flush()
        self.thread_pool.shutdown()
        for name in list(self.indices):
            self.indices.pop(name).close()

    # ------------------------------------------------------------------
    # Data path (the gateway: per-index metadata and shard recovery)
    # ------------------------------------------------------------------

    def _index_data_path(self, name: str) -> Optional[str]:
        if not self.persistent_path:
            return None
        return os.path.join(self.data_path, "indices", name)

    def _recover_indices_from_disk(self) -> None:
        """Open every index under ``<data_path>/indices`` that has a
        ``_meta.json``; each shard recovers from its store and translog
        (``IndexService``)."""
        root = os.path.join(self.data_path, "indices")
        if not os.path.isdir(root):
            return
        for name in sorted(os.listdir(root)):
            meta_path = os.path.join(root, name, "_meta.json")
            if not os.path.exists(meta_path):
                continue
            with open(meta_path, encoding="utf-8") as f:
                meta = json.load(f)
            svc = IndexService(name, Settings(meta.get("settings", {})),
                               meta.get("mappings"), device=self.device,
                               data_path=self._index_data_path(name))
            svc.aliases = meta.get("aliases", {})
            self.indices[name] = svc
            # replayed ops may have grown the mapping
            self._maybe_update_mapping_meta(svc)

    def _persist_index_meta(self, name: str) -> None:
        """Write ``_meta.json`` atomically: the index's settings, its
        current mapping and the aliases it was opened with."""
        svc = self.indices.get(name)
        if not self.persistent_path or svc is None:
            return
        path = self._index_data_path(name)
        os.makedirs(path, exist_ok=True)
        mapping = svc.mapping_dict()
        tmp = os.path.join(path, "_meta.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"settings": svc.settings.as_dict(),
                       "mappings": mapping,
                       "aliases": svc.aliases}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, "_meta.json"))
        svc.persisted_mapping = mapping

    def _maybe_update_mapping_meta(self, svc: IndexService) -> None:
        """A write that grew the mapping (dynamic fields) rewrites the
        index's ``_meta.json``."""
        if (self.persistent_path
                and not svc.mapper_service.mapping_equals(
                    svc.persisted_mapping)):
            self._persist_index_meta(svc.name)

    # ------------------------------------------------------------------
    # Index APIs
    # ------------------------------------------------------------------

    @staticmethod
    def _validate_index_name(name: str) -> None:
        if not name or name != name.lower():
            raise InvalidIndexNameException(name, "must be lowercase")
        if name.startswith(("_", "-", "+")):
            raise InvalidIndexNameException(
                name, "must not start with '_', '-', or '+'")
        if any(c in _INVALID_INDEX_CHARS for c in name):
            raise InvalidIndexNameException(
                name, "must not contain special characters")

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        body = body or {}
        self._validate_index_name(name)
        if name in self.indices:
            raise IndexAlreadyExistsException(name)
        unknown = sorted(set(body) - {"settings", "mappings"})
        if unknown:
            raise IllegalArgumentException(
                f"create-index sections {unknown} are not supported by the "
                f"PyTorch port yet")
        settings = Settings.from_dict(body.get("settings") or {}).with_index_prefix()
        # node-level micro-batching, kNN, postings-codec, pruning and
        # fused-aggregation config (search.batch.*, search.knn.*,
        # search.pallas.*, search.aggs.*, node scope) seeds each index at
        # the lowest precedence; the index's own settings
        # (index.search.pallas.postings_codec, index.search.aggs.fused,
        # index.mapping.dense_vector.max_dims, ...) come with the body
        for prefix in ("search.batch.", "search.knn.", "search.pallas.",
                       "search.aggs."):
            settings = self.settings.filtered_by_prefix(prefix).merged_with(
                settings)
        mappings, doc_type = _unwrap_typed_mapping(body.get("mappings") or {})
        svc = IndexService(name, settings, mappings, device=self.device,
                           data_path=self._index_data_path(name))
        svc.doc_type = doc_type
        self.indices[name] = svc
        # written at creation, so that an index survives a crash before
        # its first flush
        self._persist_index_meta(name)
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def resolve_index_names(self, expression: Optional[str]) -> List[str]:
        """Index-name expressions: names, wildcards, comma lists, ``_all``
        (the JAX package's ``ClusterState.resolve_index_names``, without
        aliases: the port has none). A missing concrete name raises 404;
        a wildcard may match nothing."""
        if expression in ("_all", "*", "", None):
            return sorted(self.indices)
        out: List[str] = []
        for part in str(expression).split(","):
            part = part.strip()
            if not part:
                continue
            if "*" in part:
                out.extend(n for n in sorted(self.indices)
                           if fnmatch.fnmatchcase(n, part))
            elif part in self.indices:
                out.append(part)
            else:
                raise IndexNotFoundException(part)
        return list(dict.fromkeys(out))

    def delete_index(self, expression: str, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True) -> dict:
        """Delete concrete indices, wildcards or ``_all``
        (``elasticsearch_tpu/node.py``'s ``delete_index`` without
        aliases). Each deleted index is closed: its device memory is
        released before the call returns."""
        names = []
        for p in str(expression).split(","):
            if not p:
                continue
            if "*" in p or p == "_all":
                pat = "*" if p == "_all" else p
                matched = [n for n in sorted(self.indices)
                           if fnmatch.fnmatchcase(n, pat)]
                if not matched and not allow_no_indices:
                    # a dead wildcard fails the whole request before any
                    # deletion
                    raise IndexNotFoundException(p)
                names.extend(matched)
            else:
                try:
                    names.extend(self.resolve_index_names(p))
                except IndexNotFoundException:
                    if not ignore_unavailable:
                        raise
        names = list(dict.fromkeys(names))
        if not names and not allow_no_indices:
            raise IndexNotFoundException(str(expression))
        for name in names:
            svc = self.indices.pop(name, None)
            if svc is not None:
                svc.close()
            path = self._index_data_path(name)
            if path is not None and os.path.exists(path):
                shutil.rmtree(path)
        return {"acknowledged": True}

    def index_metadata(self, name: str) -> dict:
        """One index's ``GET /{index}`` entry: its create-time settings
        (nested), its current mapping, aliases (none) and state."""
        svc = self.index_service(name)
        return {"settings": svc.settings.as_nested_dict(),
                "mappings": {"_doc": svc.mapping_dict()},
                "aliases": {}, "state": "open"}

    def index_settings(self, name: str) -> Dict[str, object]:
        """One index's flat settings with the defaults ``GET _settings``
        shows (shard and replica counts, uuid)."""
        svc = self.index_service(name)
        settings = svc.settings.as_dict()
        settings.setdefault("index.number_of_shards", svc.num_shards)
        settings.setdefault("index.number_of_replicas", svc.num_replicas)
        settings.setdefault("index.uuid", svc.uuid)
        return settings

    def index_mapping(self, name: str) -> dict:
        """One index's ``{type: mapping}`` (the 6.x typed shape)."""
        svc = self.index_service(name)
        return {svc.doc_type: svc.mapping_dict()}

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

    def flush(self, expression: Optional[str] = "_all") -> dict:
        """Flush each index the expression names: refresh, commit, trim
        the translog."""
        names = self.resolve_index_names(expression)
        for name in names:
            self.indices[name].flush()
        n = sum(self.indices[x].num_shards for x in names)
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    def synced_flush(self, expression: Optional[str] = "_all") -> dict:
        """Flush with a synced-flush marker, in the per-index shape of
        ``_flush/synced``."""
        out = {"_shards": {"total": 0, "successful": 0, "failed": 0}}
        for name in self.resolve_index_names(expression):
            self.indices[name].synced_flush()
            n = self.indices[name].num_shards
            out["_shards"]["total"] += n
            out["_shards"]["successful"] += n
            out[name] = {"total": n, "successful": n, "failed": 0}
        return out

    def force_merge(self, expression: Optional[str] = "_all") -> dict:
        """Merge each shard of each named index into one segment."""
        names = self.resolve_index_names(expression)
        for name in names:
            self.indices[name].force_merge()
        n = sum(self.indices[x].num_shards for x in names)
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    # ------------------------------------------------------------------
    # Document APIs
    # ------------------------------------------------------------------

    def index_doc(self, index: str, doc_id: Optional[str], source: dict,
                  routing: Optional[str] = None, refresh=None,
                  wait_for_active_shards=None, **kw) -> dict:
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
        if wait_for_active_shards is not None:
            # one node: each shard has its primary active and no replica
            check_active_shards(wait_for_active_shards, 1,
                                1 + svc.num_replicas, f"[{svc.name}]")
        if doc_id is None:
            doc_id = _uuid.uuid4().hex[:20]
            kw.setdefault("op_type", "create")
        r = svc.index_doc(doc_id, source, routing, **kw)
        self._maybe_refresh(svc, refresh, doc_id, routing)
        self._maybe_update_mapping_meta(svc)
        return r

    def _maybe_refresh(self, svc: IndexService, refresh, doc_id, routing) -> None:
        """refresh=true refreshes only the written shard."""
        if refresh in (True, "true", ""):
            svc.shards[svc._route(doc_id, routing)].refresh()
        elif refresh not in (None, False, "false"):
            raise IllegalArgumentException(
                f"refresh [{refresh}] is not supported by the PyTorch port yet")

    def get_doc(self, index: str, doc_id: str, routing=None,
                realtime=True, refresh=None) -> dict:
        svc = self.index_service(index)
        if refresh in (True, "true", ""):
            # GET ?refresh=true refreshes the index before reading
            svc.refresh()
        g = svc.get_doc(doc_id, routing, realtime=realtime)
        out = {"_index": svc.name, "_type": "_doc", "_id": doc_id,
               "found": g.found}
        if g.found:
            out["_version"] = g.version
            out["_seq_no"] = g.seqno
            out["_source"] = g.source
            # the stored routing (a parent-only write stores the parent as
            # routing), else the request's
            if g.routing is not None:
                out["_routing"] = g.routing
            elif routing is not None:
                out["_routing"] = routing
        return out

    def delete_doc(self, index: str, doc_id: str, routing=None, refresh=None,
                   **kw) -> dict:
        svc = self.index_service(index)
        r = svc.delete_doc(doc_id, routing, **kw)
        self._maybe_refresh(svc, refresh, doc_id, routing)
        return r

    def update_doc(self, index: str, doc_id: str, body: dict, routing=None,
                   refresh=None, version=None) -> dict:
        """The update API (``IndexService.update_doc``); an upsert
        creates a missing index as every other write does."""
        auto = "upsert" in (body or {}) or (body or {}).get("doc_as_upsert")
        svc = self.index_service(index, auto_create=bool(auto))
        r = svc.update_doc(doc_id, body, routing, version=version)
        self._maybe_refresh(svc, refresh, doc_id, routing)
        self._maybe_update_mapping_meta(svc)
        return r

    def mget(self, body: dict, default_index: Optional[str] = None,
             default_type: Optional[str] = None, realtime: bool = True,
             refresh=None, stored_fields=None) -> dict:
        """Multi-get: ``docs`` (each with its ``_index``, ``_type``,
        ``routing`` or legacy ``parent``, ``stored_fields`` and
        ``_source``) or ``ids`` against the default index. A bad item
        fails the whole request (MultiGetRequest.validate); a missing
        index is that item's error."""
        specs = body.get("docs")
        if specs is None and "ids" in body:
            specs = [{"_id": i} for i in body["ids"]]
        problems = []
        if not specs:
            problems.append("no documents to get")
        for spec in specs or []:
            if "_id" not in spec:
                problems.append("id is missing")
            if spec.get("_index", default_index) is None:
                problems.append("index is missing")
        if problems:
            raise ActionRequestValidationException(
                "Validation Failed: " + " ".join(
                    f"{i + 1}: {p};" for i, p in enumerate(problems)))
        docs = []
        for spec in specs:
            index = spec.get("_index", default_index)
            try:
                docs.append(self._mget_item(spec, index, default_type,
                                            realtime, refresh,
                                            stored_fields))
            except IndexNotFoundException:
                docs.append({
                    "_index": index, "_id": str(spec["_id"]),
                    "_type": spec.get("_type", default_type) or "_doc",
                    "error": {"type": "index_not_found_exception",
                              "reason": f"no such index [{index}]"},
                })
        return {"docs": docs}

    def _mget_item(self, spec: dict, index: str, default_type, realtime,
                   refresh, stored_fields) -> dict:
        from elasticsearch_tpu_torch.search.service import (
            _parse_source_spec,
            filter_source,
        )

        routing = spec.get("routing", spec.get("_routing"))
        if routing is None:
            # the legacy _parent: the parent id routes the doc
            routing = spec.get("parent", spec.get("_parent"))
        if routing is not None:
            routing = str(routing)
        d = self.get_doc(index, str(spec["_id"]), routing,
                         realtime=realtime, refresh=refresh)
        svc = self.indices.get(index)
        stored = (spec.get("stored_fields") or spec.get("fields")
                  or stored_fields)
        if isinstance(stored, str):
            # a single field name or a comma list
            stored = [f for f in stored.split(",") if f]
        if d.get("found") and stored and svc is not None:
            if "_parent" in stored:
                p = svc.parents.get(str(spec["_id"]))
                if p is not None:
                    d["_parent"] = p
            src = d.get("_source") or {}
            fields = {}
            for f in stored:
                if f in ("_source", "_parent", "_routing"):
                    continue
                ft = svc.mapper_service.field_type(f)
                if (ft is None or not ft.params.get("store", False)
                        or f not in src):
                    continue
                v = src[f]
                fields[f] = v if isinstance(v, list) else [v]
            if fields:
                d["fields"] = fields
            if "_source" not in stored:
                d.pop("_source", None)
        if d.get("found") and "_source" in spec:
            # per-doc source filtering (FetchSourceContext)
            inc, exc, enabled = _parse_source_spec(spec["_source"])
            if not enabled:
                d.pop("_source", None)
            elif "_source" in d:
                d["_source"] = filter_source(d["_source"], inc, exc)
        want_type = spec.get("_type", default_type)
        d["_type"] = want_type or "_doc"
        if want_type not in (None, "_all", "_doc"):
            # a typed request matches only the index's own type
            actual = getattr(svc, "doc_type", "_doc") or "_doc"
            if want_type != actual:
                d = {"_index": index, "_type": want_type,
                     "_id": str(spec["_id"]), "found": False}
        return d

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
            parent = meta.get("parent") or meta.get("_parent")
            if parent is not None:
                parent = str(parent)
                if routing is None:
                    # the legacy _parent: the parent id routes the doc
                    routing = parent
            try:
                if action == "index":
                    r = self.index_doc(index, doc_id, source, routing,
                                       parent=parent)
                    status = 201 if r.get("result") == "created" else 200
                elif action == "create":
                    r = self.index_doc(index, doc_id, source, routing,
                                       op_type="create", parent=parent)
                    status = 201
                elif action == "update":
                    r = self.update_doc(index, doc_id, source, routing)
                    status = 200
                    if parent is not None and r.get("_id"):
                        # the legacy _parent of an update line, as the
                        # index and create lines record theirs
                        self.indices[index].parents[str(r["_id"])] = parent
                elif action == "delete":
                    r = self.delete_doc(index, doc_id, routing)
                    status = 200 if r.get("found") else 404
                else:
                    raise ActionRequestValidationException(
                        f"Malformed action/metadata line, expected one of "
                        f"[create, delete, index, update] but found "
                        f"[{action}]")
                touched.add(r.get("_index", index))
                item = {action: {**{k: v for k, v in r.items() if k != "found"},
                                 "status": status}}
            except Exception as e:  # noqa: BLE001 — a per-item failure
                errors = True
                if isinstance(e, ElasticsearchTpuException):
                    err, status = e.to_dict()["error"], e.status_code
                else:
                    # a script's own fault (the JAX package's shape)
                    err = {"type": type(e).__name__, "reason": str(e)}
                    status = 500
                item = {action: {"_index": index, "_id": doc_id,
                                 "status": status, "error": err}}
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

    def resolve_search_indices(self, expression: Optional[str]
                               ) -> List[IndexService]:
        """The indices a search expression names: names, wildcards, comma
        lists and ``_all`` (``resolve_index_names``; the port has no
        closed indices and no aliases yet, so a wildcard skips none)."""
        return [self.indices[n]
                for n in self.resolve_index_names(expression or "_all")]

    def search(self, index: str, body: Optional[dict] = None,
               scroll: Optional[str] = None) -> dict:
        """A search over an index expression; ``scroll`` (a keep-alive
        such as "1m") opens a point-in-time scroll and the response
        carries its ``_scroll_id``. One index goes through its own planes;
        more go through ``_multi_index_search``."""
        from elasticsearch_tpu_torch.search.cancellation import (
            SearchDeadline,
            parse_search_timeout,
        )

        svcs = self.resolve_search_indices(index)
        body = body or {}
        if scroll and body.get("collapse"):
            raise IllegalArgumentException(
                "cannot use `collapse` in a scroll context")
        if scroll and int(body.get("from", 0) or 0):
            # paging within a scroll is the scroll itself: an offset would
            # desync the pages
            raise IllegalArgumentException(
                "using [from] is not allowed in a scroll context")
        # pin every shard's segment set and live masks before the first
        # page, so every page (this one too) reads the same snapshot
        pinned = self._pin_scroll_segments(svcs) if scroll else None
        if ("allow_partial_search_results" not in body
                and not SEARCH_ALLOW_PARTIAL_RESULTS.get(self.settings)):
            body = dict(body)
            body["allow_partial_search_results"] = False
        deadline = SearchDeadline(parse_search_timeout(body, self.settings))
        if len(svcs) == 1:
            svc = svcs[0]
            resp = svc.search(
                body, pinned_segments=(_pins_of(pinned, svc.name)
                                       if pinned else None),
                deadline=deadline)
        else:
            resp = self._multi_index_search(svcs, body, pinned=pinned,
                                            deadline=deadline)
        if scroll:
            resp["_scroll_id"] = self._open_pit_scroll(svcs, body, resp,
                                                       scroll, pinned)
        return resp

    def _multi_index_search(self, svcs: List[IndexService], body: dict,
                            pinned=None, deadline=None) -> dict:
        """A search over several indices on the host rung: every shard of
        every index runs its query phase (failure isolation and the
        deadline as on one index's host rung), the refs merge like one
        index's shards (ties by index name, shard, doc), each index's
        window fetches with its own ``_index``, and the aggregations
        reduce over every index's views. ``pinned``: {(index, shard):
        [views]} of an open scroll."""
        from elasticsearch_tpu_torch.common.errors import (
            SearchPhaseExecutionException,
            TaskCancelledException,
        )
        from elasticsearch_tpu_torch.index.index_service import (
            _is_request_error,
        )
        from elasticsearch_tpu_torch.search.aggregations import (
            parse_aggs,
            run_aggregations,
        )
        from elasticsearch_tpu_torch.search.cancellation import (
            TimeExceededException,
        )
        from elasticsearch_tpu_torch.search.service import (
            allow_partial_results,
            check_body,
            collapse_refs,
            expand_collapsed_hits,
            fetch_hits,
            merge_refs,
            normalize_sort,
            shard_failure_entry,
            validate_collapse,
        )

        t0 = time.monotonic()
        check_body(body)
        from_ = int(body.get("from", 0) or 0)
        size = int(body.get("size")) if body.get("size") is not None else 10
        k = from_ + size
        sort_spec = normalize_sort(body.get("sort"))
        collapse_body = body.get("collapse") or {}
        collapse_field = validate_collapse(body)
        all_refs = []
        total = 0
        max_score = None
        views = []
        n_shards = 0
        n_ok = 0
        failures = []
        timed_out = False
        for svc in svcs:
            svc_pins = _pins_of(pinned, svc.name) if pinned else None
            for sid in sorted(svc.shards):
                n_shards += 1
                if timed_out or (deadline is not None and deadline.expired):
                    # the finished shards stand; the rest are skipped
                    timed_out = True
                    if deadline is not None:
                        deadline.timed_out = True
                    continue
                try:
                    res = svc.shards[sid].searcher.query(
                        body, size_hint=max(k, 1),
                        segments=(svc_pins.get(sid, [])
                                  if svc_pins is not None else None),
                        deadline=deadline)
                except TaskCancelledException:
                    raise
                except TimeExceededException:
                    timed_out = True
                    continue
                except Exception as e:  # noqa: BLE001 — per-shard isolation
                    if _is_request_error(e):
                        raise  # a 4xx keeps its own status
                    failures.append(shard_failure_entry(svc.name, sid, e))
                    continue
                n_ok += 1
                timed_out = timed_out or res.timed_out
                total += res.total_hits
                if res.max_score is not None:
                    max_score = (res.max_score if max_score is None
                                 else max(max_score, res.max_score))
                for ref in res.refs:
                    ref.shard_id = (svc.name, ref.shard_id)
                    all_refs.append(ref)
                views.extend(res.agg_views)
        if failures and n_ok == 0 and not timed_out:
            raise SearchPhaseExecutionException(
                "query", "all shards failed", failures)
        if not allow_partial_results(body) and (failures or timed_out):
            raise SearchPhaseExecutionException(
                "query",
                "Partial shards failure"
                + (" (request timed out)" if timed_out else ""),
                failures)
        shard_map = {(svc.name, sid): shard for svc in svcs
                     for sid, shard in svc.shards.items()}
        if collapse_field:
            refs = merge_refs(all_refs, sort_spec, len(all_refs))
            refs = collapse_refs(refs, collapse_field)
            refs = refs[from_: from_ + size]
        else:
            refs = merge_refs(all_refs, sort_spec,
                              max(k, 0))[from_: from_ + size]
        by_index: Dict[str, list] = {}
        for ref in refs:
            by_index.setdefault(ref.shard_id[0], []).append(ref)
        ordered_hits = {}
        for idx_name, idx_refs in by_index.items():
            sub_shards = {r.shard_id: shard_map[r.shard_id] for r in idx_refs}
            # the refs carry (index, shard) ids here, as the pinned views'
            # keys do
            for ref, hit in zip(idx_refs,
                                fetch_hits(idx_refs, sub_shards, body,
                                           idx_name,
                                           pinned_segments=pinned)):
                ordered_hits[id(ref)] = hit
        hits = [ordered_hits[id(r)] for r in refs if id(r) in ordered_hits]
        if collapse_field:
            expand_collapsed_hits(
                hits, refs, collapse_body, body,
                lambda sub: self._multi_index_search(svcs, sub,
                                                     deadline=deadline))
        resp = {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": timed_out,
            "_shards": {"total": n_shards,
                        "successful": n_shards - len(failures),
                        "skipped": 0,
                        "failed": len(failures)},
            "hits": {"total": total, "max_score": max_score, "hits": hits},
        }
        if failures:
            resp["_shards"]["failures"] = failures
        agg_specs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        if agg_specs:
            resp["aggregations"] = run_aggregations(agg_specs, views)
        return resp

    # ------------------------------------------------------------------
    # Scroll: point-in-time contexts
    # ------------------------------------------------------------------

    @staticmethod
    def _pin_scroll_segments(svcs: List[IndexService]
                             ) -> Dict[tuple, list]:
        """{(index, shard): [PinnedSegmentView]} of every index."""
        from elasticsearch_tpu_torch.index.segment import PinnedSegmentView

        return {(svc.name, sid): [
            PinnedSegmentView(seg)
            for seg in svc.shards[sid].engine.searchable_segments()]
            for svc in svcs for sid in sorted(svc.shards)}

    def _reap_expired_scrolls(self) -> int:
        now = time.time()
        with self._scroll_lock:
            expired = [sid for sid, ctx in self.scrolls.items()
                       if ctx["expire_at"] < now]
            for sid in expired:
                del self.scrolls[sid]
        return len(expired)

    def _reap_expired_scrolls_loop(self, interval: float = 5.0) -> None:
        while not self._reaper_stop.wait(interval):
            self._reap_expired_scrolls()

    def _register_scroll(self, ctx: dict, keep_alive: str) -> str:
        scroll_id = _uuid.uuid4().hex
        now = time.time()
        ctx["expire_at"] = now + parse_time_value(keep_alive or "5m",
                                                  "scroll")
        with self._scroll_lock:
            # opening a scroll also sweeps the expired contexts
            for sid in [sid for sid, c in self.scrolls.items()
                        if c["expire_at"] < now]:
                del self.scrolls[sid]
            self.scrolls[scroll_id] = ctx
        return scroll_id

    def _open_pit_scroll(self, svcs: List[IndexService], body: dict,
                         first_resp: dict, keep_alive: str,
                         pinned: Dict[tuple, list]) -> str:
        """Register a context whose ordered result is a lazily extended
        prefix over the pinned snapshot of every index: opening a size-10
        scroll over a large index materializes only the first pages' refs.
        The first page is served from that same prefix, so page boundaries
        never skip or repeat across ties."""
        size = int(body.get("size")) if body.get("size") is not None else 10
        size = max(size, 0)
        # the aggregations came with the first page; the prefix needs only
        # the ordered refs
        q_body = {key: v for key, v in body.items()
                  if key not in ("aggs", "aggregations")}
        nd_total = sum(v.live_doc_count for views in pinned.values()
                       for v in views)
        ctx = {
            "indices": [svc.name for svc in svcs],
            "entries": [],        # the materialized ordered prefix
            "seen": set(),        # identities of the materialized refs
            "nd_total": nd_total,
            "last_target": 0,
            "exhausted": nd_total == 0,
            "lock": threading.Lock(),  # one pager of this scroll at a time
            "pos": size,
            "body": dict(body),
            "q_body": q_body,
            "pinned": pinned,
            "total": first_resp["hits"]["total"],
            "max_score": first_resp["hits"]["max_score"],
        }
        self._extend_pit_entries(ctx, size)
        first_resp["hits"]["hits"] = self._fetch_scroll_page(
            ctx, ctx["entries"][:size])
        return self._register_scroll(ctx, keep_alive)

    def _extend_pit_entries(self, ctx: dict, upto: int) -> None:
        """Grow the prefix to cover [0, upto): each round re-queries every
        pinned shard of every index with a geometrically larger top-k and
        appends the unseen refs in merged order (identity: index, shard,
        segment, local doc), so the re-query work stays O(final depth); a
        drained target marks the context exhausted."""
        from elasticsearch_tpu_torch.search.service import (
            merge_refs,
            normalize_sort,
        )

        sort_spec = normalize_sort(ctx["q_body"].get("sort"))
        while len(ctx["entries"]) < upto and not ctx["exhausted"]:
            target = min(ctx["nd_total"],
                         max(upto, 2 * ctx["last_target"], 32))
            per_ref = []
            for name in ctx["indices"]:
                svc = self.indices.get(name)
                if svc is None:
                    continue  # a deleted index's docs drop
                for sid in sorted(svc.shards):
                    views = ctx["pinned"].get((name, sid), [])
                    nd = sum(v.live_doc_count for v in views)
                    if nd == 0:
                        continue
                    res = svc.shards[sid].searcher.query(
                        dict(ctx["q_body"]), size_hint=min(target, nd),
                        segments=views)
                    per_ref.extend((name, r) for r in res.refs)
            index_of = {id(r): name for name, r in per_ref}
            merged = merge_refs([r for _n, r in per_ref], sort_spec, target)
            for r in merged:
                name = index_of[id(r)]
                key = (name, r.shard_id, r.segment_name, r.local_doc)
                if key in ctx["seen"]:
                    continue
                ctx["seen"].add(key)
                ctx["entries"].append((name, r))
            if target >= ctx["nd_total"] or len(merged) < target:
                ctx["exhausted"] = True
            ctx["last_target"] = target

    def _fetch_scroll_page(self, ctx: dict, entries: list) -> List[dict]:
        from elasticsearch_tpu_torch.search.service import fetch_hits

        by_index: Dict[str, list] = {}
        for name, ref in entries:
            by_index.setdefault(name, []).append(ref)
        ordered = {}
        for name, refs in by_index.items():
            svc = self.indices.get(name)
            if svc is None:
                continue  # the index was deleted mid-scroll
            hits = fetch_hits(refs, svc.shards, ctx["body"], name,
                              pinned_segments=_pins_of(ctx["pinned"], name))
            for ref, hit in zip(refs, hits):
                ordered[id(ref)] = hit
        return [ordered[id(r)] for _n, r in entries if id(r) in ordered]

    def scroll(self, scroll_id: str, keep_alive: Optional[str] = None) -> dict:
        """The next page of an open scroll; ``keep_alive`` extends it."""
        with self._scroll_lock:
            ctx = self.scrolls.get(scroll_id)
            if ctx is None or ctx["expire_at"] < time.time():
                self.scrolls.pop(scroll_id, None)
                raise ResourceNotFoundException(
                    f"No search context found for id [{scroll_id}]")
        t0 = time.monotonic()
        size = (int(ctx["body"].get("size"))
                if ctx["body"].get("size") is not None else 10)
        size = max(size, 0)
        # extension re-queries the pinned views outside the node's lock;
        # the context's own lock serializes the pagers of this scroll
        with ctx["lock"]:
            pos = ctx["pos"]
            self._extend_pit_entries(ctx, pos + size)
            page = ctx["entries"][pos: pos + size]
            ctx["pos"] = pos + len(page)
        if keep_alive:
            with self._scroll_lock:
                ctx["expire_at"] = time.time() + parse_time_value(
                    keep_alive, "scroll")
        hits = self._fetch_scroll_page(ctx, page)
        return {
            "_scroll_id": scroll_id,
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": False,
            "hits": {"total": ctx["total"], "max_score": ctx["max_score"],
                     "hits": hits},
        }

    def clear_scroll(self, scroll_ids: List[str]) -> dict:
        """Drop scroll contexts by id, or every one with ``["_all"]``."""
        with self._scroll_lock:
            if scroll_ids == ["_all"]:
                n = len(self.scrolls)
                self.scrolls.clear()
            else:
                n = sum(self.scrolls.pop(sid, None) is not None
                        for sid in scroll_ids)
        return {"succeeded": True, "num_freed": n}

    def msearch(self, searches: List[tuple]) -> dict:
        """searches: list of (header, body), each served serially through
        ``search`` (the header's index expression, ``_all`` by default);
        a failed entry answers with its error body."""
        responses = []
        for header, body in searches:
            try:
                responses.append(self.search(header.get("index", "_all"), body))
            except ElasticsearchTpuException as e:
                responses.append(e.to_dict())
            except Exception as e:  # noqa: BLE001 — one entry's fault
                responses.append({"error": {"type": type(e).__name__,
                                            "reason": str(e)}, "status": 500})
        return {"responses": responses}

    # ------------------------------------------------------------------
    # Cluster APIs
    # ------------------------------------------------------------------

    def health(self) -> dict:
        """_cluster/health on one node: every primary active, no replica
        assignable, so yellow unless every index has 0 replicas."""
        n_shards = sum(s.num_shards for s in self.indices.values())
        unassigned = sum(s.num_shards * s.num_replicas
                         for s in self.indices.values())
        total = n_shards + unassigned
        return {
            "cluster_name": self.cluster_name,
            "status": "green" if unassigned == 0 else "yellow",
            "timed_out": False,
            "number_of_nodes": 1,
            "number_of_data_nodes": 1,
            "active_primary_shards": n_shards,
            "active_shards": n_shards,
            "relocating_shards": 0,
            "initializing_shards": 0,
            "unassigned_shards": unassigned,
            "delayed_unassigned_shards": 0,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number": (
                100.0 * n_shards / total if total else 100.0),
        }
