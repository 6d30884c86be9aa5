"""Node: the in-process server API.

Counterpart of ``elasticsearch_tpu/node.py``, cut to this slice's entry
points: ``create_index``, ``delete_index``, ``close_index``,
``open_index``, ``index_doc``, ``bulk`` (index, create, update and delete
lines), ``refresh``, ``get_doc``, ``mget``, ``delete_doc``,
``update_doc``, ``search`` (one index through the index's micro-batcher
and mesh plane; names, aliases, wildcards, comma lists and ``_all``
through ``resolve_search_indices``; ``search.batch.*``, ``search.knn.*``,
``search.pallas.*`` and ``search.aggs.*`` node settings pass to every
index: ``search.pallas.*`` is the postings codec's node default and
block-max pruning, ``search.aggs.fused`` the fused aggregations),
``msearch`` (each entry served serially through ``search``, an index
pattern in its header too) and ``health``.

Cluster metadata lives in a ``ClusterState`` behind a ``ClusterService``
(``cluster/state.py``): each index's settings, mapping, aliases and
open/close state, the index templates (applied at create time, lowest
``order`` first), the persistent and transient cluster settings, and the
stored scripts (``search/templates.py`` renders search templates from
them). ``put_cluster_settings`` keeps the JAX package's explicitness
contract: while a cluster value of a dynamic knob is set it overrides
every index's own (``IndexService.*_override``), and clearing it with a
null hands control back; the HBM budget, the staging retry and the
search pool's queue follow the node's settings again once cleared.
``update_index_settings`` changes an index's dynamic settings in place
(a new ``index.refresh_interval`` restarts its scheduled refresh). An
alias's ``filter`` and ``search_routing`` are stored and shown, and a
search through the alias ignores both, as the JAX package's does
(ROADMAP C19).

A write's ``refresh=true`` refreshes the written shard; ``wait_for``
blocks until the index's scheduled refresh has made it visible, and
forces a refresh where the schedule is off (``-1``).

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
aliases) and one translog and store a shard under it, and
``<data_path>/_state/global-meta.json`` holds the global metadata (the
templates, the persistent cluster settings, the stored scripts, and the
ingest pipelines and snapshot repositories, which the port reads back
and writes again unchanged), rewritten atomically on every change of
it. Opening a node over an existing data path recovers the global
metadata, then every index, before it returns; a recovered index stages
its segments on the node's device lazily, as a new one does. ``flush``,
``synced_flush`` and ``force_merge`` take an index expression; ``close``
synced-flushes every index of a durable node before it releases them, so
the next open replays nothing. Without a data path nothing is kept on
disk (no translog either).

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

A ``geo_shape`` query's ``indexed_shape`` is inlined by ``search``
before any shard sees it (``_rewrite_indexed_shapes``, the referenced
document's shape at ``path``, ``shape`` by default); a missing document
is a 404. ``clear_cache`` serves ``_cache/clear``.

``drain`` (``POST /_nodes/_local/_drain``) stops every index's admission
(new searches answer 503 with ``Retry-After``, queued ones are shed the
same way), waits up to ``search.drain.deadline`` for the searches in
flight, then synced-flushes a durable node's indices; ``undrain`` ends
it, an index created meanwhile joins it, and ``close`` drains first.
``hot_threads`` samples each thread's CPU time and stack. The variant
registry (``common/compile_cache.py``) lives under
``search.compile.cache_path``, else beside a durable node's store, and a
durable node replays its recorded bodies on a background thread at start
(``search.compile.warm_on_start``; ``close`` joins it). ``node_stats``
merges the indices' ``search`` blocks (the phase histograms, admission)
beside the process-wide ``memory``, ``compile`` and ``integrity`` blocks.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
import re
import shutil
import threading
import time
import uuid as _uuid
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.cluster.state import (
    ClusterService,
    ClusterState,
    DiscoveryNode,
    IndexMetadata,
    cluster_health,
)
from elasticsearch_tpu_torch.common import compile_cache as cc
from elasticsearch_tpu_torch.common import monitor
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
    CLUSTER_NAME,
    INDEX_SCRUB_INTERVAL,
    INDEX_STAGING_COMPACT_THRESHOLD,
    INDEX_STAGING_DELTA_ENABLED,
    NODE_NAME,
    PATH_DATA,
    SEARCH_AGGS_FUSED,
    SEARCH_ALLOW_PARTIAL_RESULTS,
    SEARCH_BATCH_ENABLED,
    SEARCH_BATCH_MAX_QUERIES,
    SEARCH_BATCH_WINDOW_MS,
    SEARCH_COMPILE_CACHE_PATH,
    SEARCH_COMPILE_WARM_ON_START,
    SEARCH_KNN_ENABLED,
    SEARCH_KNN_TILE_SUB,
    SEARCH_MEMORY_HBM_BUDGET,
    SEARCH_PALLAS_PRUNING_ENABLED,
    SEARCH_PALLAS_PRUNING_PROBE_TILES,
    SEARCH_QUEUE_SIZE,
    SEARCH_STAGING_RETRY_BACKOFF_MS,
    SEARCH_STAGING_RETRY_MAX_ATTEMPTS,
    SEARCH_TELEMETRY_ENABLED,
    Settings,
    cluster_settings,
    index_scoped_settings,
    parse_byte_size,
    parse_time_value,
)
from elasticsearch_tpu_torch.common.staging import configure_staging_retry
from elasticsearch_tpu_torch.common.thread_pool import ThreadPool
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.index.seqno import check_active_shards
from elasticsearch_tpu_torch.ingest.pipeline import IngestService
from elasticsearch_tpu_torch.snapshots.service import SnapshotsService
from elasticsearch_tpu_torch.tasks.task_manager import TaskManager
from elasticsearch_tpu_torch.version import __version__

_INVALID_INDEX_CHARS = set(' "*\\<>|,/?#')
_node_log = logging.getLogger("elasticsearch_tpu_torch.node")

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
        self.node_name = NODE_NAME.get(settings)
        self.cluster_name = CLUSTER_NAME.get(settings)
        self.start_time = time.time()
        self._closed = False
        # the registries PUT _cluster/settings and PUT /{index}/_settings
        # go through
        self.cluster_settings = cluster_settings()
        self.index_scoped_settings = index_scoped_settings()
        self.indices: Dict[str, IndexService] = {}

        # the micro-batching knobs reach every live batcher on a cluster
        # settings update
        def batchers(apply):
            def consume(value):
                for svc in self.indices.values():
                    apply(svc._batcher, value)
            return consume

        self.cluster_settings.add_settings_update_consumer(
            SEARCH_BATCH_ENABLED,
            batchers(lambda b, v: setattr(b, "enabled", bool(v))))
        self.cluster_settings.add_settings_update_consumer(
            SEARCH_BATCH_WINDOW_MS,
            batchers(lambda b, v: setattr(b, "window_s", float(v) / 1000.0)))
        self.cluster_settings.add_settings_update_consumer(
            SEARCH_BATCH_MAX_QUERIES,
            batchers(lambda b, v: setattr(b, "max_queries", int(v))))
        self.cluster_service = ClusterService(ClusterState(
            self.cluster_name,
            nodes={self.node_id: DiscoveryNode(self.node_id, self.node_name,
                                               "127.0.0.1:9300")},
            master_node_id=self.node_id))
        # named bounded executors: the REST layer runs handler work on the
        # action's pool, and a full queue rejects with 429.
        # search.queue.size bounds the search pool's queue, as in
        # elasticsearch_tpu/node.py. Workers start on the first submit.
        self.thread_pool = ThreadPool(overrides={
            "search": {"queue_size": SEARCH_QUEUE_SIZE.get(settings)}})
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
        self.tasks = TaskManager(self.node_id)
        self.ingest = IngestService(self)
        self.snapshots = SnapshotsService(self)
        # the drain: set while the node refuses new searches
        self._draining = False
        # the variant registry: under search.compile.cache_path, else
        # beside the store; the process's registry follows the last node
        # constructed
        cache_path = SEARCH_COMPILE_CACHE_PATH.get(settings)
        if cache_path:
            cc.configure_compile_cache(cache_path)
        elif self.persistent_path:
            cc.set_variant_registry(cc.VariantRegistry(os.path.join(
                self.data_path, "_state", cc.REGISTRY_FILE)))
        self._warm_thread: Optional[threading.Thread] = None
        if self.persistent_path:
            # the global metadata first, then each index; from then on the
            # applier keeps the global file current
            self._recover_global_meta()
            self.cluster_service.add_applier(self._persist_global_meta)
            self._recover_indices_from_disk()
            if SEARCH_COMPILE_WARM_ON_START.get(settings):
                self._start_compile_warming()

    def close(self) -> None:
        """Stop and join the scroll reaper and drop every scroll context;
        drain (new searches refused, queued ones shed, those in flight
        finished, then every index of a durable node synced-flushed with
        its metadata, so a restart replays nothing); join the warm
        thread; then stop the thread pools and release every index's
        device memory and its threads."""
        if self._closed:
            return
        self._closed = True
        self._reaper_stop.set()
        self._reaper.join()
        with self._scroll_lock:
            self.scrolls.clear()
        self.drain()
        if self._warm_thread is not None:
            self._warm_thread.join()
        self.thread_pool.shutdown()
        self.snapshots.close()
        for name in list(self.indices):
            self.indices.pop(name).close()

    # ------------------------------------------------------------------
    # Data path (the gateway: global metadata, per-index metadata and
    # shard recovery)
    # ------------------------------------------------------------------

    def _index_data_path(self, name: str) -> Optional[str]:
        if not self.persistent_path:
            return None
        return os.path.join(self.data_path, "indices", name)

    @staticmethod
    def _global_meta_slice(state: ClusterState) -> dict:
        """What a full restart brings back besides the indices; transient
        settings are not kept."""
        return {
            "templates": state.templates,
            "persistent_settings": state.persistent_settings.as_nested_dict(),
            "stored_scripts": state.stored_scripts,
            "ingest_pipelines": state.ingest_pipelines,
            "repositories": state.repositories,
        }

    def _persist_global_meta(self, old: ClusterState,
                             new: ClusterState) -> None:
        """Cluster-state applier: rewrite ``_state/global-meta.json``
        atomically (a temporary file, fsync, rename) when the global slice
        changed."""
        payload = self._global_meta_slice(new)
        if old is not None and self._global_meta_slice(old) == payload:
            return
        state_dir = os.path.join(self.data_path, "_state")
        os.makedirs(state_dir, exist_ok=True)
        tmp = os.path.join(state_dir, "global-meta.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(state_dir, "global-meta.json"))

    def _recover_global_meta(self) -> None:
        """Restore the global slice through the normal write paths: the
        persistent settings through ``put_cluster_settings`` (so their
        consumers fire) and each repository through
        ``SnapshotsService.put_repository`` (so its object is built); the
        templates, stored scripts and ingest pipelines come back as
        read."""
        path = os.path.join(self.data_path, "_state", "global-meta.json")
        if not os.path.exists(path):
            return
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if data.get("persistent_settings"):
            self.put_cluster_settings(
                {"persistent": data["persistent_settings"]})

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            new.templates.update(data.get("templates") or {})
            new.stored_scripts.update(data.get("stored_scripts") or {})
            new.ingest_pipelines.update(data.get("ingest_pipelines") or {})
            return new

        self.cluster_service.submit_state_update_task(
            "recover global metadata", update)
        for name, body in (data.get("repositories") or {}).items():
            try:
                self.snapshots.put_repository(name, body)
            except Exception:  # noqa: BLE001 — e.g. an unknown type
                # an unregisterable repository does not block the boot
                # (as in the JAX package): a snapshot into it fails with
                # repository-missing at use time
                pass

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
            settings = Settings(meta.get("settings", {}))
            svc = IndexService(name, settings, meta.get("mappings"),
                               device=self.device,
                               data_path=self._index_data_path(name))
            self.indices[name] = svc
            self._apply_cluster_overrides(svc)

            def update(state: ClusterState, name=name, settings=settings,
                       svc=svc, meta=meta) -> ClusterState:
                new = state.copy()
                new.indices[name] = IndexMetadata(
                    name, settings, meta.get("mappings") or {},
                    meta.get("aliases", {}),
                    creation_date=svc.creation_date)
                return new

            self.cluster_service.submit_state_update_task(
                f"recover [{name}]", update)
            # the mapping as written; replayed ops may have grown it
            self._maybe_update_mapping_meta(name)

    def _persist_index_meta(self, name: str) -> None:
        """Write ``_meta.json`` atomically: the index's settings, its
        current mapping and its aliases."""
        md = self.cluster_service.state.indices.get(name)
        svc = self.indices.get(name)
        if not self.persistent_path or md is None or svc is None:
            return
        path = self._index_data_path(name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "_meta.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"settings": md.settings.as_dict(),
                       "mappings": svc.mapping_dict(),
                       "aliases": md.aliases}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, "_meta.json"))

    def _maybe_update_mapping_meta(self, index: str) -> None:
        """A write that grew the mapping (dynamic fields) updates the
        index's metadata in the cluster state and rewrites its
        ``_meta.json``."""
        svc = self.indices.get(index)
        md = self.cluster_service.state.indices.get(index)
        if svc is None or md is None or svc.mapper_service.mapping_equals(
                md.mappings):
            return

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            new.indices[index].mappings = svc.mapping_dict()
            new.indices[index].version += 1
            return new

        self.cluster_service.submit_state_update_task(
            f"update-mapping [{index}]", update)
        self._persist_index_meta(index)

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

    def _committed_cluster_settings(self) -> Settings:
        state = self.cluster_service.state
        return state.persistent_settings.merged_with(state.transient_settings)

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        body = body or {}
        self._validate_index_name(name)
        state = self.cluster_service.state
        if name in self.indices or any(
                name in md.aliases for md in state.indices.values()):
            raise IndexAlreadyExistsException(name)
        unknown = sorted(set(body) - {"settings", "mappings", "aliases"})
        if unknown:
            raise IllegalArgumentException(
                f"create-index sections {unknown} are not supported by the "
                f"PyTorch port yet")
        settings = Settings.from_dict(
            body.get("settings") or {}).with_index_prefix()
        mappings, doc_type = _unwrap_typed_mapping(body.get("mappings") or {})
        aliases = {a: (spec or {})
                   for a, spec in (body.get("aliases") or {}).items()}
        # the matching templates, lowest order first; the body wins
        merged_settings = Settings.EMPTY
        merged_mappings: dict = {}
        for t in sorted((t for t in state.templates.values()
                         if _template_matches(t, name)),
                        key=lambda t: t.get("order", 0)):
            merged_settings = merged_settings.merged_with(Settings.from_dict(
                t.get("settings") or {}).with_index_prefix())
            t_map = t.get("mappings") or {}
            if "_doc" in t_map:
                t_map = t_map["_doc"]
            _merge_mapping_dicts(merged_mappings, t_map)
            for a, spec in (t.get("aliases") or {}).items():
                aliases.setdefault(a, spec or {})
        merged_settings = merged_settings.merged_with(settings)
        _merge_mapping_dicts(merged_mappings, mappings)
        # the node's settings of the cluster-dynamic families seed each
        # index at the lowest precedence, with the live cluster settings
        # over them (an index created after PUT _cluster/settings follows
        # the live value); the index's own settings
        # (index.search.pallas.postings_codec, index.search.aggs.fused,
        # ...) come with the body and the templates
        committed = self._committed_cluster_settings()
        for prefix in ("search.batch.", "search.pallas.", "search.knn.",
                       "search.aggs.", "search.telemetry.", "search.queue.",
                       "search.admission.", "search.drain.",
                       "index.staging."):
            merged_settings = self.settings.filtered_by_prefix(
                prefix).merged_with(committed.filtered_by_prefix(
                    prefix)).merged_with(merged_settings)
        self.index_scoped_settings.validate(merged_settings,
                                            allow_unknown=True)
        svc = IndexService(name, merged_settings, merged_mappings,
                           device=self.device,
                           data_path=self._index_data_path(name))
        svc.doc_type = doc_type
        self._apply_cluster_overrides(svc)
        if self._draining:
            # an index created while the node drains joins the drain
            svc.admission.begin_drain()
        self.indices[name] = svc

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            new.indices[name] = IndexMetadata(
                name, merged_settings, svc.mapping_dict(), aliases,
                creation_date=svc.creation_date)
            return new

        self.cluster_service.submit_state_update_task(
            f"create-index [{name}]", update)
        # written at creation, so that an index survives a crash before
        # its first flush
        self._persist_index_meta(name)
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def resolve_index_names(self, expression: Optional[str]) -> List[str]:
        """Index-name expressions: names, aliases, wildcards over names and
        aliases, comma lists, ``_all`` (``ClusterState.
        resolve_index_names``). A missing concrete name raises 404; a
        wildcard may match nothing."""
        return self.cluster_service.state.resolve_index_names(expression)

    def delete_index(self, expression: str, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True) -> dict:
        """Delete concrete indices, wildcards or ``_all``. An alias is
        refused (skipped with ``ignore_unavailable``), and a wildcard
        expands over index names only. Each deleted index is closed: its
        refresh thread joined and its device memory released before the
        call returns."""
        state = self.cluster_service.state
        alias_parts = set()
        for part in str(expression).split(","):
            for md in state.indices.values():
                if part and part in md.aliases:
                    if ignore_unavailable:
                        alias_parts.add(part)
                        break
                    raise IllegalArgumentException(
                        f"The provided expression [{part}] matches an "
                        f"alias, specify the corresponding concrete "
                        f"indices instead.")
        names = []
        for p in str(expression).split(","):
            if not p or p in alias_parts:
                continue
            if "*" in p or p == "_all":
                pat = "*" if p == "_all" else p
                matched = [n for n in state.indices
                           if fnmatch.fnmatchcase(n, pat)]
                if not matched and not allow_no_indices:
                    # a dead wildcard fails the whole request before any
                    # deletion
                    raise IndexNotFoundException(p)
                names.extend(matched)
            else:
                try:
                    names.extend(state.resolve_index_names(p))
                except IndexNotFoundException:
                    if not ignore_unavailable:
                        raise
        names = list(dict.fromkeys(names))
        if not names:
            if not allow_no_indices:
                raise IndexNotFoundException(str(expression))
            return {"acknowledged": True}
        for name in names:
            svc = self.indices.pop(name, None)
            if svc is not None:
                svc.close()
            path = self._index_data_path(name)
            if path is not None and os.path.exists(path):
                shutil.rmtree(path)

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            for name in names:
                new.indices.pop(name, None)
            return new

        self.cluster_service.submit_state_update_task(
            f"delete-index {names}", update)
        return {"acknowledged": True}

    def _set_index_state(self, expression: str, value: str) -> dict:
        names = self.resolve_index_names(expression)

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            for n in names:
                new.indices[n].state = value
            return new

        self.cluster_service.submit_state_update_task(
            f"{value}-index {names}", update)
        return {"acknowledged": True}

    def close_index(self, expression: str) -> dict:
        """Mark the named indices closed: a search by name is a 400 and a
        wildcard skips them. The index keeps its shards and staging, as in
        the JAX package."""
        return self._set_index_state(expression, "close")

    def open_index(self, expression: str) -> dict:
        return self._set_index_state(expression, "open")

    def index_metadata(self, name: str) -> dict:
        """One index's ``GET /{index}`` entry: its settings (nested), its
        current mapping, its aliases and its state."""
        md = self.cluster_service.state.index_metadata(name)
        svc = self.indices[name]
        return {"settings": md.settings.as_nested_dict(),
                "mappings": {"_doc": svc.mapping_dict()},
                "aliases": md.aliases, "state": md.state}

    def index_settings(self, name: str) -> Dict[str, object]:
        """One index's flat settings with the defaults ``GET _settings``
        shows (shard and replica counts, uuid)."""
        md = self.cluster_service.state.index_metadata(name)
        settings = md.settings.as_dict()
        settings.setdefault("index.number_of_shards", md.num_shards)
        settings.setdefault("index.number_of_replicas", md.num_replicas)
        settings.setdefault("index.uuid", self.indices[name].uuid)
        return settings

    def index_mapping(self, name: str) -> dict:
        """One index's ``{type: mapping}`` (the 6.x typed shape)."""
        svc = self.indices[name]
        return {svc.doc_type: svc.mapping_dict()}

    def index_service(self, name: str, auto_create: bool = False) -> IndexService:
        """The index a write or a single-index request names: by name, or
        the first index an alias points at; a closed index is a 400."""
        state = self.cluster_service.state
        if name in self.indices:
            md = state.indices.get(name)
            if md is not None and md.state == "close":
                raise IllegalArgumentException(f"index [{name}] is closed")
            return self.indices[name]
        for idx_name, md in state.indices.items():
            if name in md.aliases:
                return self.indices[idx_name]
        if not auto_create:
            raise IndexNotFoundException(name)
        self.create_index(name)
        return self.indices[name]

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
                  pipeline: Optional[str] = None,
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
        if pipeline:
            source = self.ingest.run_pipeline(pipeline, source, doc_id, index)
            if source is None:  # the pipeline dropped the doc
                return {"_index": index, "_id": doc_id, "result": "noop"}
        if doc_id is None:
            doc_id = _uuid.uuid4().hex[:20]
            kw.setdefault("op_type", "create")
        r = svc.index_doc(doc_id, source, routing, **kw)
        self._maybe_refresh(svc, refresh, doc_id, routing)
        self._maybe_update_mapping_meta(svc.name)
        return r

    def _maybe_refresh(self, svc: IndexService, refresh, doc_id, routing) -> None:
        """A write's refresh policy: ``true`` refreshes only the written
        shard (another shard's buffered deletes stay invisible);
        ``wait_for`` blocks until the scheduled refresh has made every
        shard's pending ops visible, forcing a refresh where the schedule
        is off or a shard has not refreshed within twice its interval."""
        if refresh in (True, "true", ""):
            svc.shards[svc._route(doc_id, routing)].refresh()
        elif refresh == "wait_for":
            interval = svc.refresh_interval
            if not interval or interval <= 0:
                svc.shards[svc._route(doc_id, routing)].refresh()
                return
            events = []
            for shard in svc.shards.values():
                ev = threading.Event()
                shard.engine.add_refresh_listener(ev.set)
                events.append(ev)
            for ev in events:
                if not ev.wait(interval * 2 + 0.5):
                    svc.refresh()
                    break

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
        self._maybe_update_mapping_meta(svc.name)
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

    def bulk(self, operations: List[tuple], refresh=None,
             pipeline: Optional[str] = None) -> dict:
        """operations: list of (action, meta, source_or_None). ``pipeline``
        runs on every index and create line whose meta names none of its
        own (a doc the pipeline drops is a ``noop`` item)."""
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
            item_pipeline = meta.get("pipeline", pipeline)
            try:
                if action == "index":
                    r = self.index_doc(index, doc_id, source, routing,
                                       pipeline=item_pipeline, parent=parent)
                    status = 201 if r.get("result") == "created" else 200
                elif action == "create":
                    r = self.index_doc(index, doc_id, source, routing,
                                       op_type="create",
                                       pipeline=item_pipeline, parent=parent)
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
        if refresh in (True, "true", "", "wait_for"):
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
        """The open indices a search expression names: names, aliases,
        wildcards, comma lists and ``_all``. A wildcard skips a closed
        index; a closed index named (or reached through an alias) is a
        400."""
        state = self.cluster_service.state
        out: List[IndexService] = []
        seen = set()
        parts = [p for p in str(expression or "_all").split(",") if p] \
            or ["_all"]
        for part in parts:
            wildcard = "*" in part or part == "_all"
            for n in state.resolve_index_names(part):
                if n in seen:
                    continue
                if state.indices[n].state != "open":
                    if wildcard:
                        continue
                    raise IllegalArgumentException(
                        f"closed index [{n}] - IndexClosedException")
                seen.add(n)
                out.append(self.indices[n])
        return out

    def clear_cache(self, expression: str = "_all") -> None:
        """``POST [/{index}]/_cache/clear``: every searched index drops its
        segments' staged doc-value columns (restaged on next use), as the
        JAX package's route does, and its request cache, which the JAX
        package's route keeps (ROADMAP C20)."""
        for svc in self.resolve_search_indices(expression):
            svc.request_cache.clear()
            for shard in svc.shards.values():
                for seg in shard.engine.segments:
                    seg.clear_column_cache()

    def _rewrite_indexed_shapes(self, body: dict) -> dict:
        """The coordinator's rewrite of a ``geo_shape`` query's
        ``indexed_shape`` (``{"index", "id", "path": "shape"}``): the
        referenced document's shape is fetched and inlined before any
        shard sees the query."""
        if "indexed_shape" not in json.dumps(body.get("query") or {}):
            return body
        import copy as _copy

        body = _copy.deepcopy(body)

        def walk(obj):
            if isinstance(obj, dict):
                gs = obj.get("geo_shape")
                if isinstance(gs, dict):
                    for spec in gs.values():
                        if isinstance(spec, dict) and "indexed_shape" in spec:
                            ref = spec.pop("indexed_shape")
                            if (not isinstance(ref, dict) or "index" not in ref
                                    or "id" not in ref):
                                raise IllegalArgumentException(
                                    "[indexed_shape] requires index and id")
                            g = self.get_doc(ref["index"], ref["id"])
                            if not g.get("found"):
                                raise ResourceNotFoundException(
                                    f"indexed document [{ref['index']}/"
                                    f"{ref['id']}] not found")
                            val = g["_source"]
                            path = str(ref.get("path", "shape"))
                            for part in path.split("."):
                                if not isinstance(val, dict) or part not in val:
                                    raise IllegalArgumentException(
                                        f"field [{path}] not found in indexed "
                                        f"document [{ref['index']}/"
                                        f"{ref['id']}]")
                                val = val[part]
                            spec["shape"] = val
                for v in obj.values():
                    walk(v)
            elif isinstance(obj, list):
                for v in obj:
                    walk(v)

        walk(body.get("query"))
        return body

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
        body = self._rewrite_indexed_shapes(body or {})
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
        # the registered task trips the deadline's checkpoints when
        # _tasks/{id}/_cancel sets its flag
        task = self.tasks.register("indices:data/read/search",
                                   f"search [{index}]")
        deadline = SearchDeadline(parse_search_timeout(body, self.settings),
                                  task)
        try:
            if len(svcs) == 1:
                svc = svcs[0]
                resp = svc.search(
                    body, pinned_segments=(_pins_of(pinned, svc.name)
                                           if pinned else None),
                    deadline=deadline)
            else:
                resp = self._multi_index_search(svcs, body, pinned=pinned,
                                                deadline=deadline)
        finally:
            self.tasks.unregister(task)
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
        """_cluster/health on one node: every primary of an open index
        active, no replica assignable, so yellow unless every open index
        has 0 replicas."""
        return cluster_health(self.cluster_service.state)

    def cluster_stats(self) -> dict:
        state = self.cluster_service.state
        return {
            "cluster_name": state.cluster_name,
            "status": self.health()["status"],
            "indices": {
                "count": len(self.indices),
                "docs": {"count": sum(s.num_docs()
                                      for s in self.indices.values())},
                "shards": {"total": sum(s.num_shards
                                        for s in self.indices.values())},
            },
            "nodes": {
                "count": {"total": 1, "data": 1, "master": 1, "ingest": 1},
                "versions": [__version__],
            },
        }

    def node_info(self) -> dict:
        return {
            "cluster_name": self.cluster_service.state.cluster_name,
            "nodes": {self.node_id: {
                "name": self.node_name,
                "version": __version__,
                "roles": ["master", "data", "ingest"],
                "settings": self.settings.as_nested_dict(),
                "plugins": [],
                "http": {"publish_address": getattr(
                    self, "http_publish_address", None)},
            }},
        }

    def node_stats(self) -> dict:
        """The node's stats: docs, the per-index ``search`` blocks merged
        into one (the phase histograms, the plane and admission counters)
        with the node-wide device-memory ledger as its ``memory`` and the
        process-wide ``compile`` and ``integrity`` blocks, the OS, process
        and filesystem probes, the thread pools and the breakers. The JAX
        package's ``transport`` section waits for its module."""
        from elasticsearch_tpu_torch.common.integrity import integrity_service
        from elasticsearch_tpu_torch.search.telemetry import merge_phase_stats

        search = merge_phase_stats(
            [svc.search_stats() for svc in self.indices.values()])
        # the ledger, the compile plane and the integrity counters are
        # process resources: their node-wide views, not sums
        search["memory"] = memory_accountant().stats(None)
        search["compile"] = cc.compile_stats().stats()
        search["integrity"] = integrity_service().stats(None)
        return {
            "cluster_name": self.cluster_service.state.cluster_name,
            "nodes": {self.node_id: {
                "name": self.node_name,
                "indices": {
                    "docs": {"count": sum(s.num_docs()
                                          for s in self.indices.values())},
                    "search": search,
                },
                "jvm": {"uptime_in_millis": int(
                    (time.time() - self.start_time) * 1000)},
                "os": monitor.os_stats(),
                "process": monitor.process_stats(),
                "fs": monitor.fs_stats(
                    self.data_path if self.persistent_path else "."),
                "thread_pool": self.thread_pool.stats(),
                "breakers": self.breaker_service.stats(),
            }},
        }

    def put_template(self, name: str, body: dict) -> dict:
        body = dict(body)
        body.setdefault("index_patterns", body.pop("template", None) or [])
        if isinstance(body["index_patterns"], str):
            body["index_patterns"] = [body["index_patterns"]]

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            new.templates[name] = body
            return new

        self.cluster_service.submit_state_update_task(
            f"put-template [{name}]", update)
        return {"acknowledged": True}

    def delete_template(self, name: str) -> dict:
        if name not in self.cluster_service.state.templates:
            raise ResourceNotFoundException(f"index_template [{name}] missing")

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            new.templates.pop(name, None)
            return new

        self.cluster_service.submit_state_update_task(
            f"delete-template [{name}]", update)
        return {"acknowledged": True}

    def update_aliases(self, actions: List[dict]) -> dict:
        """``add`` and ``remove`` actions over index expressions, applied
        as one state update; an alias keeps its ``filter`` and routing
        (stored, not applied by a search: ROADMAP C19)."""
        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            for action in actions:
                ((verb, spec),) = action.items()
                indices = spec.get("indices") or [spec.get("index")]
                aliases = spec.get("aliases") or [spec.get("alias")]
                for idx_expr in indices:
                    for idx in new.resolve_index_names(idx_expr):
                        for alias in aliases:
                            if verb == "add":
                                new.indices[idx].aliases[alias] = {
                                    k: spec[k] for k in (
                                        "filter", "routing", "index_routing",
                                        "search_routing") if k in spec}
                            elif verb == "remove":
                                new.indices[idx].aliases.pop(alias, None)
                            else:
                                raise IllegalArgumentException(
                                    f"[aliases] unknown action [{verb}]")
            return new

        old = self.cluster_service.state
        new = self.cluster_service.submit_state_update_task(
            "update-aliases", update)
        for name, md in new.indices.items():
            if md.aliases != old.indices[name].aliases:
                self._persist_index_meta(name)
        return {"acknowledged": True}

    def put_cluster_settings(self, body: dict) -> dict:
        """Merge ``persistent`` and ``transient`` settings (a null clears
        a key), fire the update consumers, then sync every knob that
        follows the explicitness contract: the cluster value while one is
        set, else the index's own settings (the per-index overrides) or
        the node's (the budget, the staging retry, the search queue)."""
        persistent = Settings.from_dict(body.get("persistent") or {})
        transient = Settings.from_dict(body.get("transient") or {})

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            old_merged = state.persistent_settings.merged_with(
                state.transient_settings)
            new.persistent_settings = state.persistent_settings.merged_with(
                persistent)
            new.transient_settings = state.transient_settings.merged_with(
                transient)
            self.cluster_settings.apply_settings(
                old_merged, new.persistent_settings.merged_with(
                    new.transient_settings))
            return new

        self.cluster_service.submit_state_update_task("update-settings", update)
        state = self.cluster_service.state
        for svc in self.indices.values():
            self._apply_cluster_overrides(svc)
        committed = self._committed_cluster_settings()

        def source(setting):
            return (committed if committed.get(setting.key) is not None
                    else self.settings)

        self.thread_pool.executor("search").resize_queue(
            SEARCH_QUEUE_SIZE.get(source(SEARCH_QUEUE_SIZE)))
        # lowering the budget evicts at once
        memory_accountant().set_budget(SEARCH_MEMORY_HBM_BUDGET.get(
            source(SEARCH_MEMORY_HBM_BUDGET)))
        configure_staging_retry(
            max_attempts=SEARCH_STAGING_RETRY_MAX_ATTEMPTS.get(
                source(SEARCH_STAGING_RETRY_MAX_ATTEMPTS)),
            backoff_ms=SEARCH_STAGING_RETRY_BACKOFF_MS.get(
                source(SEARCH_STAGING_RETRY_BACKOFF_MS)))
        return {
            "acknowledged": True,
            "persistent": state.persistent_settings.as_nested_dict(),
            "transient": state.transient_settings.as_nested_dict(),
        }

    def _apply_cluster_overrides(self, svc: IndexService) -> None:
        """Set (or clear back to None) each cluster-level override of a
        dynamic index knob on ``svc`` from the committed cluster
        settings."""
        committed = self._committed_cluster_settings()
        for setting, attr in (
                (SEARCH_PALLAS_PRUNING_ENABLED, "pruning_enabled_override"),
                (SEARCH_PALLAS_PRUNING_PROBE_TILES, "pruning_probe_override"),
                (SEARCH_KNN_ENABLED, "knn_enabled_override"),
                (SEARCH_KNN_TILE_SUB, "knn_tile_sub_override"),
                (SEARCH_AGGS_FUSED, "aggs_fused_override"),
                (SEARCH_TELEMETRY_ENABLED, "telemetry_enabled_override"),
                (INDEX_SCRUB_INTERVAL, "scrub_interval_override"),
                (INDEX_STAGING_DELTA_ENABLED,
                 "staging_delta_enabled_override"),
                (INDEX_STAGING_COMPACT_THRESHOLD,
                 "staging_compact_threshold_override")):
            explicit = committed.get(setting.key) is not None
            setattr(svc, attr, setting.get(committed) if explicit else None)
        # the admission knobs (search.queue.*, search.admission.*,
        # search.drain.*, search.batch.max_window_ms): the controller
        # takes the explicit cluster keys as overrides and reads its
        # config live
        svc.admission.set_cluster_overrides(committed)

    def update_index_settings(self, expression: str, body: dict) -> dict:
        """``PUT /{index}/_settings``: only registered dynamic settings;
        each named index takes the update in place."""
        normalized = Settings.from_dict(
            body.get("settings", body) or {}).with_index_prefix()
        self.index_scoped_settings.validate_dynamic_update(normalized)
        names = self.resolve_index_names(expression)

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            for n in names:
                md = new.indices[n]
                md.settings = md.settings.merged_with(normalized)
                md.version += 1
            return new

        self.cluster_service.submit_state_update_task(
            "update-index-settings", update)
        for n in names:
            self.indices[n].update_settings(normalized)
            self._persist_index_meta(n)
        return {"acknowledged": True}

    def put_mapping(self, index: str, mapping: dict) -> dict:
        """``PUT /{index}/_mapping``: merge new fields into the index's
        mapping (a conflicting type is a 400)."""
        svc = self.index_service(index)
        svc.put_mapping(mapping)
        self._maybe_update_mapping_meta(svc.name)
        return {"acknowledged": True}

    def put_stored_script(self, script_id: str, body: dict) -> dict:
        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            new.stored_scripts[script_id] = body.get("script", body)
            return new

        self.cluster_service.submit_state_update_task(
            f"put-script [{script_id}]", update)
        return {"acknowledged": True}

    def get_stored_script(self, script_id: str) -> dict:
        script = self.cluster_service.state.stored_scripts.get(script_id)
        if script is None:
            raise ResourceNotFoundException(
                f"unable to find script [{script_id}]")
        return {"_id": script_id, "found": True, "script": script}

    def delete_stored_script(self, script_id: str) -> dict:
        self.get_stored_script(script_id)  # 404 if missing

        def update(state: ClusterState) -> ClusterState:
            new = state.copy()
            new.stored_scripts.pop(script_id, None)
            return new

        self.cluster_service.submit_state_update_task("delete-script", update)
        return {"acknowledged": True}

    # ------------------------------------------------------------------
    # Index admin: term vectors, rollover, shrink
    # ------------------------------------------------------------------

    def termvectors(self, index: str, doc_id: str,
                    fields: Optional[List[str]] = None) -> dict:
        """One doc's terms per field, each with its frequency, document
        frequency and positions, and the field's statistics, read from
        the segment that holds the doc (after a refresh of its shard)."""
        svc = self.index_service(index)
        shard = svc.shards[svc._route(doc_id)]
        shard.refresh()
        term_vectors: Dict[str, dict] = {}
        found = False
        for seg in shard.engine.searchable_segments():
            local = seg.id_to_doc().get(doc_id)
            if local is None or not seg.live[local]:
                continue
            found = True
            by_field: Dict[str, dict] = {}
            for tid, positions in seg.positions.doc_terms(local).items():
                fname, token = seg.term_keys[tid].split("\x1f", 1)
                if fields and fname not in fields:
                    continue
                f = by_field.setdefault(fname, {"terms": {}})
                f["terms"][token] = {
                    "term_freq": int(len(positions)),
                    "doc_freq": int(seg.term_doc_freq[tid]),
                    "tokens": [{"position": int(p)} for p in positions],
                }
            for fname, f in by_field.items():
                st = seg.field_stats.get(fname, {})
                f["field_statistics"] = {
                    "sum_ttf": st.get("sum_ttf", 0),
                    "doc_count": st.get("doc_count", 0),
                }
                term_vectors[fname] = f
            break
        return {"_index": svc.name, "_id": doc_id, "found": found,
                "term_vectors": term_vectors}

    def rollover(self, alias: str, body: Optional[dict] = None) -> dict:
        """When a condition is met (``max_docs``, ``max_age``,
        ``max_size``; none given is met), create the next index of the
        series (``new_index``, else the source's ``-NNNNNN`` suffix plus
        one, else ``-000002``) and move the alias to it. ``dry_run``
        evaluates and moves nothing."""
        body = body or {}
        state = self.cluster_service.state
        sources = [n for n, md in state.indices.items() if alias in md.aliases]
        if len(sources) != 1:
            raise IllegalArgumentException(
                f"source alias [{alias}] must point to exactly one index, "
                f"found {sources}")
        source = sources[0]
        m = re.search(r"-(\d+)$", source)
        if body.get("new_index"):
            target = body["new_index"]
        elif m:
            target = f"{source[:m.start()]}-{int(m.group(1)) + 1:06d}"
        else:
            target = f"{source}-000002"
        svc = self.indices[source]
        conditions = body.get("conditions") or {}
        results = {}
        met = not conditions
        if "max_docs" in conditions:
            ok = svc.num_docs() >= int(conditions["max_docs"])
            results[f"[max_docs: {conditions['max_docs']}]"] = ok
            met = met or ok
        if "max_age" in conditions:
            age = time.time() - svc.creation_date / 1000.0
            ok = age >= parse_time_value(conditions["max_age"], "max_age")
            results[f"[max_age: {conditions['max_age']}]"] = ok
            met = met or ok
        if "max_size" in conditions:
            size = sum(s.stats()["segments"]["memory_in_bytes"]
                       for s in svc.shards.values())
            ok = size >= parse_byte_size(conditions["max_size"], "max_size")
            results[f"[max_size: {conditions['max_size']}]"] = ok
            met = met or ok
        resp = {
            "old_index": source,
            "new_index": target,
            "rolled_over": False,
            "dry_run": bool(body.get("dry_run", False)),
            "conditions": results,
            "acknowledged": False,
            "shards_acknowledged": False,
        }
        if not met or body.get("dry_run"):
            return resp
        self.create_index(target, {k: v for k, v in body.items()
                                   if k in ("settings", "mappings",
                                            "aliases")})
        self.update_aliases([
            {"remove": {"index": source, "alias": alias}},
            {"add": {"index": target, "alias": alias}},
        ])
        resp.update({"rolled_over": True, "acknowledged": True,
                     "shards_acknowledged": True})
        return resp

    def shrink_index(self, source: str, target: str,
                     body: Optional[dict] = None) -> dict:
        """Re-partition an index into fewer shards (a divisor of its
        count): a new index with the source's mapping, the shard count
        pinned in its settings (the index default is 5), and every live
        doc re-routed into it from the stored sources."""
        body = body or {}
        svc = self.index_service(source)
        settings = dict(body.get("settings") or {})
        target_shards = int(Settings.from_dict(settings).with_index_prefix()
                            .get("index.number_of_shards", 1))
        settings.setdefault("index.number_of_shards", target_shards)
        if svc.num_shards % target_shards != 0:
            raise IllegalArgumentException(
                f"the number of source shards [{svc.num_shards}] must be a "
                f"multiple of [{target_shards}]")
        svc.refresh()
        self.create_index(target, {
            "settings": settings,
            "mappings": svc.mapping_dict(),
            "aliases": body.get("aliases") or {},
        })
        tgt = self.indices[target]
        for shard in svc.shards.values():
            for seg in shard.engine.searchable_segments():
                for local in np.flatnonzero(seg.live[: seg.num_docs]):
                    tgt.index_doc(seg.doc_ids[local], seg.sources[local],
                                  seg.routings[local])
        tgt.refresh()
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": target}


    # ------------------------------------------------------------------
    # Hot threads, the drain and the warm replay
    # ------------------------------------------------------------------

    HOT_THREADS_INTERVAL_S = 0.05

    @staticmethod
    def _thread_cpu_seconds() -> dict:
        """{thread ident: CPU seconds} from ``/proc/self/task``, for the
        threads of the ``threading`` module; {} where it cannot be read."""
        out = {}
        try:
            tick = os.sysconf("SC_CLK_TCK")
        except (ValueError, OSError, AttributeError):
            return out
        for th in threading.enumerate():
            tid = getattr(th, "native_id", None)
            if tid is None:
                continue
            try:
                with open(f"/proc/self/task/{tid}/stat", "rb") as f:
                    # the name may hold spaces and parens: split after the
                    # closing paren; utime and stime are then fields 11, 12
                    parts = f.read().rpartition(b")")[2].split()
                out[th.ident] = (int(parts[11]) + int(parts[12])) / tick
            except (OSError, IndexError, ValueError):
                continue
        return out

    def hot_threads(self) -> str:
        """``_nodes/hot_threads``: each thread's CPU share over a short
        interval (two CPU-time samples around a sleep), its name and its
        stack, busiest first; a waiter on a lock shows 0% with the
        acquire frame on top."""
        import sys
        import traceback

        interval = self.HOT_THREADS_INTERVAL_S
        cpu0 = self._thread_cpu_seconds()
        time.sleep(interval)
        cpu1 = self._thread_cpu_seconds()
        frames = sys._current_frames()
        rows = []
        known = set()
        for th in threading.enumerate():
            cpu = max(cpu1.get(th.ident, 0.0) - cpu0.get(th.ident, 0.0),
                      0.0)
            rows.append((cpu, th.ident, th.name, th.daemon))
            known.add(th.ident)
        # threads running Python that the threading module never saw
        for ident in frames.keys() - known:
            rows.append((0.0, ident, "<non-threading>", False))
        rows.sort(key=lambda r: (-r[0], r[2]))
        out = [
            f"::: {{{self.node_name}}}{{{self.node_id}}}",
            f"   Hot threads sampled over {interval * 1000:.0f}ms, "
            f"{len(rows)} live threads, busiest first:",
        ]
        for cpu, ident, name, daemon in rows:
            pct = cpu / interval * 100.0 if interval else 0.0
            flags = " (daemon)" if daemon else ""
            out.append(
                f"\n   {pct:6.1f}% ({cpu * 1000:.1f}ms out of "
                f"{interval * 1000:.0f}ms) cpu usage by thread id "
                f"[{ident}] '{name}'{flags}:")
            frame = frames.get(ident)
            if frame is None:
                out.append("     <no stack available>")
                continue
            out.extend("     " + line.rstrip("\n") for line in
                       traceback.format_stack(frame, limit=12))
        return "\n".join(out)

    def _start_compile_warming(self) -> None:
        """Replay every recovered index's recorded warm specs on a
        background thread (``IndexService.warm_compile_variants``): the
        boot never waits for it, and a query finds the variants warm."""
        targets = [svc for svc in self.indices.values()
                   if cc.variant_registry().warm_entries(svc.name)]
        if not targets:
            return

        def warm():
            for svc in targets:
                svc.warm_compile_variants()

        self._warm_thread = threading.Thread(
            target=warm, daemon=True,
            name=f"compile-warm[{self.node_name}]")
        self._warm_thread.start()

    def _drain_deadline_s(self) -> float:
        committed = self._committed_cluster_settings()
        source = (committed if committed.get("search.drain.deadline")
                  is not None else self.settings)
        v = source.get_time("search.drain.deadline", 30.0)
        return float(v) if v is not None else 30.0

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Enter the drain (``POST /_nodes/_local/_drain``): every index's
        admission stops admitting (a clean 503 with Retry-After; queued
        searches shed the same way), the searches in flight finish within
        ``search.drain.deadline``, then every index of a durable node is
        synced-flushed with its metadata, so a restart replays nothing.
        Idempotent; ``undrain`` ends it. Returns the drain's report."""
        t0 = time.monotonic()
        deadline_s = (self._drain_deadline_s() if deadline_s is None
                      else float(deadline_s))
        self._draining = True
        shed = 0
        for svc in self.indices.values():
            shed += svc.admission.begin_drain()
        deadline_at = time.monotonic() + deadline_s
        drained = True
        for svc in self.indices.values():
            remaining = max(deadline_at - time.monotonic(), 0.0)
            drained = svc.admission.await_drained(remaining) and drained
        # after the searches in flight finished: the commit covers every
        # acknowledged op
        if self.persistent_path:
            for name in list(self.indices):
                self._persist_index_meta(name)
                try:
                    self.indices[name].synced_flush()
                except Exception:  # noqa: BLE001 — a failed flush does not
                    # block the drain; the translog replay covers it
                    _node_log.warning("[%s] synced flush in the drain "
                                      "failed", name, exc_info=True)
        return {
            "draining": True,
            "drained": drained,
            "queued_shed": shed,
            "in_flight_remaining": sum(
                svc.admission.in_flight for svc in self.indices.values()),
            "took_ms": int((time.monotonic() - t0) * 1000),
        }

    def undrain(self) -> dict:
        """End a drain (``DELETE /_nodes/_local/_drain``): every index
        admits again."""
        self._draining = False
        for svc in self.indices.values():
            svc.admission.end_drain()
        return {"draining": False}

def _template_matches(template: dict, index_name: str) -> bool:
    patterns = template.get("index_patterns") or []
    if isinstance(patterns, str):
        patterns = [patterns]
    return any(fnmatch.fnmatchcase(index_name, p) for p in patterns)


def _merge_mapping_dicts(base: dict, incoming: dict) -> None:
    for k, v in incoming.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge_mapping_dicts(base[k], v)
        else:
            base[k] = v
