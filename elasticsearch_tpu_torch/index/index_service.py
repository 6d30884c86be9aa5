"""IndexService: one index = N shards + mapping + routing + search fan-out.

Counterpart of ``elasticsearch_tpu/index/index_service.py``. Docs route to
shards by murmur3 of their id (or routing). A search goes:

1. through the cross-query micro-batcher (``search.batch.*``): a lone
   query runs at once; a concurrent burst of compatible queries runs as
   one ``search_batch``;
2. ``_search_uncached``: the mesh plane first (``index.search.mesh``):
   all (shard, segment) pairs as one stacked program on the device when
   they fit ``index.search.mesh.max_slots_per_device`` slots (one
   device); then the host rung: the ``_can_match`` prefilter, the query
   phase shard by shard, the merge of the shards' top-k (by score or by
   the request's sort values), collapse (every candidate kept, then cut
   to k groups, each expanded with its ``inner_hits``), the
   aggregations over every shard's segment views, and fetch. A response
   with ``terminate_after`` says ``terminated_early``.

The host rung isolates each shard: a shard whose query phase raises
becomes a ``_shards.failures`` entry (``shard_failure_entry``), a request
error (a 4xx) and a cancellation raise, a corrupt store quarantines its
shard, and "all shards failed" is raised only when no shard answered and
none timed out. A request's ``SearchDeadline`` (``search/cancellation.py``;
``Node.search`` makes one, and so does ``search`` for a direct caller's
``timeout``) threads through the batcher, the mesh plane and each shard:
an expired one answers what finished with ``timed_out: true``, or, with
``allow_partial_search_results: false``, raises
``SearchPhaseExecutionException``, as a failure does. A ``profile``d
request carries a ``QueryTracer`` through whichever plane serves it and
``_finish_query_response`` attaches its ``plane``, ``phases`` and
``annotations`` (the host rung adds a tree a segment); profiling moves no
request off its plane. ``track_total_hits`` is outside the pruned path's
keys, so such a request counts every tile.

``search(body, pinned_segments=...)`` is a scroll's page: the query
phase reads the scroll's pinned segment views on the host rung,
bypassing the micro-batcher, the mesh plane and ``_can_match``.

A ``knn`` section alone is a pure vector search, normalized into the
``knn`` query clause: a plain top-k vector search goes to the mesh
plane's kNN rung (kernel 3), anything else (a filter, a boost, one shard)
to the host rung. With ``query`` beside it, the request is hybrid
(``_search_hybrid``): each side runs its own plane ladder, then reciprocal
rank fusion (``rank: {rrf: ...}``) or convex score fusion.

``search_batch`` splits pure-kNN members off onto one batched kernel-3
launch (``IndexMeshSearch.query_knn_batch``); the others take two rungs:
the mesh plane's batched fused top-k launch, or for agg-carrying members
its batched dense agg launch with fused aggregations
(``IndexMeshSearch.query_batch``), else one batched dense launch per
segment (``_host_batch_scores``) feeding each member's host pipeline
through score caches; members neither rung can share run serially.
Unlike the JAX package, ``_host_batch_scores`` catches nothing around the
batched launch: a kernel fault raises instead of re-serving the members
serially.

Every response carries the plane that served it in ``"_plane"``
(``mesh_pallas``, ``mesh`` or ``host``) and ``hits.total`` as a plain
int (the 6.x shape). A response whose query phase ran the block-max pruned
program (``search.pallas.pruning.enabled``) carries ``"_pruned":
{"tiles_scored", "tiles_pruned", "total_relation": "gte"}``: its total
counts matches in scored tiles only, and the REST layer renders it as
``{"value", "relation": "gte"}`` (``rest/handlers._render_total_hits``).
``close`` releases the index's device memory (``Node.delete_index``) and
its device-memory ledger (``release_index``).

With a ``data_path`` each shard keeps its translog and store under
``<data_path>/<shard id>``, and an index opened over an existing one
recovers each shard from its store and translog (``recover_from_store``)
before it serves. A shard whose store fails verification, or carries a
corruption marker, is quarantined: the marker is written, its device
arrays are released, and every search fails it into
``_shards.failures`` from the host rung (the mesh plane cannot report a
shard's failure, so it stands aside while any shard is quarantined);
the other shards answer. ``flush``, ``synced_flush`` and ``force_merge``
run on every shard.

A join child (a ``join`` field value with a ``parent``) must be routed
to its parent's shard: on a multi-shard index one without ``routing`` is
a 400, on one shard the parent id routes it (``_check_join_routing``).
A legacy ``_parent`` value (``index_doc(..., parent=)``) rides with the
doc into the translog and the segment; ``parents`` maps each doc id to it
for ``stored_fields=_parent`` and is rebuilt from the shards at open.

``update_doc`` is the update API (a partial ``doc`` merge, upserts, a
painless script over a deep copy of ``ctx._source`` with ``ctx.op``, the
internal version check); it writes through ``index_doc`` or
``delete_doc``.

Compaction (``index.staging.compact.threshold``): after a delta commit the
mesh plane calls ``maybe_compact_async``, which starts one background
``compact_now`` pass (single flight, never on the query path) when a
staged slot's tombstone density or the slot fragmentation reaches the
threshold; the pass force-merges the dense or fragmented shards and
restages a compact generation; a drain aborts it between shards.

Admission control (``search/admission.py``): ``search`` takes an
admission slot before any staging or launch (``_search_dispatch``): an
overflow is the 429 with ``Retry-After``, a drain the 503, a deadline
that expires while queued answers its timed-out partial result unrun,
and the brownout ladder shapes what runs (forced pruning, shed
``rescore``, shed aggregations and suggesters, marked ``_degraded``; a
``_degraded`` answer never enters the request cache). The batcher's
window is admission's adaptive one. Telemetry: every request carries a
tracer (``NULL_TRACER`` under ``search.telemetry.enabled: false``)
annotated with its X-Opaque-Id; ``_finish_query_response`` drains it
into ``telemetry`` (``search.phases``), records a mesh-served body as a
warm spec (``warm_compile_variants`` replays them under
``compile_cache.warming()``) and writes the mesh plane's slowlog line
(``index.search.slowlog.threshold.query.*``; the host rung's shards
write their own). The scrubber (``index.scrub.interval``, off by
default; ``scrub_now``) checks every committed segment's checksums and
every staged base table's digest: a corrupt store is quarantined with
``site="scrub"``, a drifted staging released and restaged with the
``scrub`` reason.

The shard request cache (``index/request_cache.py``,
``index.requests.cache.enable``, ``index.requests.cache.size_in_bytes``):
``search`` answers a cacheable (``size: 0``) request from the cache when
its body and every shard's visibility epoch match an entry, launching
nothing; a complete miss (not timed out, no shard failure) is stored.
``stats`` reports its counters under ``request_cache``. A ``suggest``
section runs ``search/suggest.run_suggest`` over every shard's searchable
segments beside the query phase, on whichever plane served it. An index
sort (``index.sort.*``, validated by ``index/index_sort.parse_index_sort``
at creation) reaches every shard's engine.

The scheduled refresh: a thread refreshes every shard each
``index.refresh_interval`` (1 s by default, none at -1; a failed refresh
is logged and the timer goes on); ``update_settings`` restarts it on a
new interval, and ``close`` stops and joins it. The ``*_override``
attributes hold the cluster-level values of the dynamic pruning, kNN,
fused-aggregation and delta-staging knobs while ``PUT
_cluster/settings`` sets them (``Node.put_cluster_settings``); the mesh
plane reads them first. ``stats`` gives the ``_stats`` sections.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common import compile_cache as cc
from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.integrity import integrity_service
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.errors import (
    DocumentMissingException,
    ElasticsearchTpuException,
    IllegalArgumentException,
    SearchPhaseExecutionException,
    TaskCancelledException,
    VersionConflictEngineException,
)
from elasticsearch_tpu_torch.common.settings import (
    INDEX_MAPPING_DENSE_VECTOR_MAX_DIMS,
    INDEX_NUMBER_OF_REPLICAS,
    INDEX_MAX_SLICES_PER_SCROLL,
    INDEX_NUMBER_OF_SHARDS,
    INDEX_REFRESH_INTERVAL,
    INDEX_SCRUB_INTERVAL,
    INDEX_SEARCH_MESH,
    INDEX_SEARCH_MESH_MAX_SLOTS,
    INDEX_SEARCH_MESH_PLANE,
    INDEX_SEARCH_PALLAS_POSTINGS_CODEC,
    INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN,
    INDEX_STAGING_COMPACT_THRESHOLD,
    INDEX_STAGING_DELTA_ENABLED,
    INDEX_TRANSLOG_DURABILITY,
    SEARCH_BATCH_ENABLED,
    SEARCH_BATCH_MAX_QUERIES,
    SEARCH_BATCH_WINDOW_MS,
    SEARCH_KNN_ENABLED,
    SEARCH_KNN_TILE_SUB,
    SEARCH_PALLAS_POSTINGS_CODEC,
    SEARCH_PALLAS_PRUNING_ENABLED,
    SEARCH_PALLAS_PRUNING_PROBE_TILES,
    SEARCH_TELEMETRY_ENABLED,
    Settings,
)
from elasticsearch_tpu_torch.index.index_sort import parse_index_sort
from elasticsearch_tpu_torch.index.request_cache import (
    RequestCache,
    cacheable,
    shard_epoch,
)
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.index.similarity import SimilarityService
from elasticsearch_tpu_torch.index.store import CorruptIndexException
from elasticsearch_tpu_torch.mapper.field_types import join_field_of
from elasticsearch_tpu_torch.mapper.mapping import MapperService
from elasticsearch_tpu_torch.script.expression import compile_script
from elasticsearch_tpu_torch.script.painless import execute_update_script
from elasticsearch_tpu_torch.search.admission import (
    SearchAdmissionController,
    forced_pruning,
    scoped_forced_pruning,
)
from elasticsearch_tpu_torch.search.aggregations import parse_aggs, run_aggregations
from elasticsearch_tpu_torch.search.suggest import run_suggest
from elasticsearch_tpu_torch.search.batching import (
    BatchStats,
    MicroBatcher,
    batchable_body,
    knn_batch_spec,
)
from elasticsearch_tpu_torch.search.cancellation import (
    SearchDeadline,
    TimeExceededException,
    parse_search_timeout,
)
from elasticsearch_tpu_torch.search.service import (
    allow_partial_results,
    check_body,
    collapse_refs,
    emit_search_slowlog,
    expand_collapsed_hits,
    expired_queue_response,
    fetch_hits,
    merge_refs,
    normalize_sort,
    shard_failure_entry,
    slowlog_threshold,
)
from elasticsearch_tpu_torch.search.telemetry import (
    NULL_TRACER,
    SearchTelemetry,
    get_opaque_id,
    scoped_opaque_id,
)
from elasticsearch_tpu_torch.testing.disruption import on_query_begin
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for

_refresh_log = logging.getLogger("elasticsearch_tpu_torch.index.refresh")
_scrub_log = logging.getLogger("elasticsearch_tpu_torch.index.scrub")


class IndexService:
    def __init__(self, name: str, settings: Settings = Settings.EMPTY,
                 mapping: Optional[dict] = None, device="cuda",
                 data_path: Optional[str] = None):
        self.name = name
        self.settings = settings
        self.device = resolve_device(device)
        self.num_shards = INDEX_NUMBER_OF_SHARDS.get(settings)
        self.num_replicas = INDEX_NUMBER_OF_REPLICAS.get(settings)
        self.creation_date = int(time.time() * 1000)
        self.uuid = f"{name}-{self.creation_date:x}"
        # the 6.x type name responses echo: the create body's typed
        # mapping names it, else the first typed-path write (REST)
        self.doc_type = "_doc"
        # the mesh plane's settings are read when it first serves; parse
        # them now so a bad value fails index creation
        for setting in (INDEX_SEARCH_MESH_MAX_SLOTS, INDEX_SEARCH_MESH_PLANE,
                        INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN,
                        SEARCH_KNN_ENABLED, SEARCH_KNN_TILE_SUB,
                        SEARCH_PALLAS_PRUNING_ENABLED,
                        SEARCH_PALLAS_PRUNING_PROBE_TILES,
                        INDEX_STAGING_DELTA_ENABLED,
                        INDEX_STAGING_COMPACT_THRESHOLD,
                        INDEX_MAX_SLICES_PER_SCROLL):
            setting.get(settings)
        # the scheduled refresh's period in seconds; <= 0: none
        self.refresh_interval = INDEX_REFRESH_INTERVAL.get(settings)
        # the _stats counters of index-level calls (a scheduled refresh
        # goes to the shards and counts in their engines only)
        self._stats_lock = threading.Lock()
        self._get_total = 0
        self._refresh_total = 0
        self._flush_total = 0
        # cluster-level overrides of dynamic index settings (Node's
        # put_cluster_settings sets them while the cluster setting is
        # explicitly set, and clears them back to None): the index's own
        # settings win while one is None
        self.pruning_enabled_override: Optional[bool] = None
        self.pruning_probe_override: Optional[int] = None
        self.knn_enabled_override: Optional[bool] = None
        self.knn_tile_sub_override: Optional[int] = None
        self.aggs_fused_override: Optional[bool] = None
        self.staging_delta_enabled_override: Optional[bool] = None
        self.staging_compact_threshold_override: Optional[float] = None
        self.analyzers = AnalysisRegistry(settings)
        self.mapper_service = MapperService(
            self.analyzers, mapping,
            similarity_service=SimilarityService(settings),
            dense_vector_max_dims=INDEX_MAPPING_DENSE_VECTOR_MAX_DIMS.get(
                settings))
        self.data_path = data_path
        # index.sort.*: validated against the mapping now, applied by
        # every builder at seal
        self.index_sort = parse_index_sort(settings, self.mapper_service)
        # the shard request cache: size 0 responses against the shards'
        # visibility epochs
        self._request_cache_enabled = settings.get_bool(
            "index.requests.cache.enable", True)
        self.request_cache = RequestCache(max_bytes=settings.get_int(
            "index.requests.cache.size_in_bytes", 8 * 1024 * 1024))
        durability = INDEX_TRANSLOG_DURABILITY.get(settings)
        # the search slowlog's thresholds (seconds; negative or unset:
        # off): each shard's host-rung line and the index's mesh-plane line
        slow_warn = settings.get_time(
            "index.search.slowlog.threshold.query.warn")
        slow_info = settings.get_time(
            "index.search.slowlog.threshold.query.info")
        self._slowlog_warn_s = slowlog_threshold(slow_warn)
        self._slowlog_info_s = slowlog_threshold(slow_info)
        # the postings codec of the tile kernel's staging: the index's
        # preference ("default" follows the node's search.pallas.
        # postings_codec), stamped on each segment by its engine
        self.postings_codec = INDEX_SEARCH_PALLAS_POSTINGS_CODEC.get(settings)
        self.postings_codec_default = SEARCH_PALLAS_POSTINGS_CODEC.get(
            settings)
        # the mesh data plane (parallel/plan_exec.IndexMeshSearch), staged
        # on the first eligible search
        self._mesh_enabled = INDEX_SEARCH_MESH.get(settings)
        self._mesh_search = None
        # the plane is created once: threads racing an index's first
        # searches must share one instance (and its counters)
        self._mesh_lock = threading.Lock()
        # background compaction: single flight; close stops it
        self._compact_lock = threading.Lock()
        self._closing = False
        self.shards: Dict[int, IndexShard] = {}
        # ops replayed from each shard's translog when it recovered
        self.recovered_ops: Dict[int, int] = {}
        for sid in range(self.num_shards):
            shard = IndexShard(
                name, sid, self.mapper_service, device=self.device,
                data_path=(os.path.join(data_path, str(sid))
                           if data_path else None),
                durability=durability, index_sort=self.index_sort,
                slowlog_warn_s=slow_warn, slowlog_info_s=slow_info)
            shard.engine.postings_codec = self.postings_codec
            shard.engine.postings_codec_default = self.postings_codec_default
            # slice resolution is shard-count aware (SliceBuilder)
            shard.searcher.num_shards = self.num_shards
            shard.searcher.max_slices = INDEX_MAX_SLICES_PER_SCROLL.get(
                settings)
            self.shards[sid] = shard
        # the shards with disk state recover: their committed segments
        # load (read, checksums verified) on a thread a shard, the rest of
        # each recovery (tombstones, the translog replay) in shard order
        # a corrupt or marked store quarantines its shard instead of
        # failing the index's open: its searches fail into
        # _shards.failures, never as empty hits
        recovering = []
        for sid, shard in sorted(self.shards.items()):
            try:
                if not shard.has_disk_state():
                    shard.start_fresh()
                    continue
            except CorruptIndexException as e:
                self._quarantine_shard(sid, e, site="load")
                continue
            recovering.append(sid)
        with ThreadPoolExecutor(max_workers=max(len(recovering), 1)) as pool:
            loads = {sid: pool.submit(self.shards[sid].engine.store
                                      .load_segments, self.device)
                     for sid in recovering}
            for sid in recovering:
                try:
                    self.recovered_ops[sid] = self.shards[
                        sid].recover_from_store(segments=loads[sid].result())
                except CorruptIndexException as e:
                    self._quarantine_shard(sid, e, site="load")
        # legacy _parent values: doc id -> parent id (stored_fields
        # [_parent]); they persist with each doc and are rebuilt here
        self.parents: Dict[str, str] = {}
        self._rebuild_parents()
        self.host_query_total = 0
        self.batch_stats = BatchStats()
        self._batcher = MicroBatcher(
            window_s=SEARCH_BATCH_WINDOW_MS.get(settings) / 1000.0,
            max_queries=SEARCH_BATCH_MAX_QUERIES.get(settings),
            enabled=SEARCH_BATCH_ENABLED.get(settings),
            stats=self.batch_stats)
        # phase telemetry: every request's spans drain into the
        # per-plane x per-phase histograms; search.telemetry.enabled is
        # the kill switch (the cluster-level override first)
        self.telemetry = SearchTelemetry()
        self.telemetry_enabled_override: Optional[bool] = None
        # admission control in front of every search's staging and
        # launches; it also sizes the batcher's adaptive window
        self.admission = SearchAdmissionController(name, settings)
        self._batcher.window_fn = (
            lambda: self.admission.effective_batch_window_s(
                self._batcher.window_s))
        self._batcher.annotate = self._annotate_batch_member
        self._refresh_stop: Optional[threading.Event] = None
        self._refresh_thread: Optional[threading.Thread] = None
        self._start_refresh_timer()
        # the store and device scrubber (index.scrub.interval, off by
        # default): one thread that polls idle while the interval is off,
        # so turning it on needs no thread lifecycle
        self.scrub_interval_override: Optional[float] = None
        self._scrub_stop = threading.Event()
        self._scrub_thread = threading.Thread(
            target=self._scrub_loop, daemon=True, name=f"scrub[{name}]")
        self._scrub_thread.start()

    # ------------------------------------------------------------------
    # The scheduled refresh and dynamic settings
    # ------------------------------------------------------------------

    def _start_refresh_timer(self) -> None:
        """Refresh every shard each ``index.refresh_interval`` on a
        thread of its own (none at -1); a failed refresh is logged and
        the timer goes on."""
        interval = self.refresh_interval
        if interval is None or interval <= 0:
            return
        stop = threading.Event()

        def refresh_loop():
            while not stop.wait(interval):
                for shard in list(self.shards.values()):
                    try:
                        shard.refresh()
                    except Exception:  # noqa: BLE001 — the timer goes on
                        _refresh_log.warning(
                            "[%s][%s] scheduled refresh failed", self.name,
                            shard.shard_id, exc_info=True)

        self._refresh_stop = stop
        self._refresh_thread = threading.Thread(
            target=refresh_loop, daemon=True, name=f"refresh[{self.name}]")
        self._refresh_thread.start()

    def _stop_refresh_timer(self) -> None:
        """Stop the scheduled refresh and join its thread."""
        if self._refresh_stop is None:
            return
        self._refresh_stop.set()
        self._refresh_thread.join()
        self._refresh_stop = self._refresh_thread = None

    def update_settings(self, update: Settings) -> None:
        """Apply a dynamic update of the index's settings (validated by
        the node): the merged settings serve every later request; a new
        ``index.refresh_interval`` restarts the timer, and
        ``index.max_slices_per_scroll`` reaches the shards' searchers. The
        write responses' replica count stays as created, as in the JAX
        package (the cluster state's metadata holds the new one)."""
        self.settings = self.settings.merged_with(update)
        self._slowlog_warn_s = slowlog_threshold(self.settings.get_time(
            "index.search.slowlog.threshold.query.warn"))
        self._slowlog_info_s = slowlog_threshold(self.settings.get_time(
            "index.search.slowlog.threshold.query.info"))
        for shard in self.shards.values():
            shard.searcher.max_slices = INDEX_MAX_SLICES_PER_SCROLL.get(
                self.settings)
            shard.searcher.slowlog_warn_s = self._slowlog_warn_s
            shard.searcher.slowlog_info_s = self._slowlog_info_s
        if INDEX_REFRESH_INTERVAL.key in update:
            self._stop_refresh_timer()
            self.refresh_interval = INDEX_REFRESH_INTERVAL.get(self.settings)
            if not self._closing:
                self._start_refresh_timer()

    def put_mapping(self, mapping: dict) -> None:
        """Merge new fields into the mapping (``PUT /{index}/_mapping``);
        a conflicting type is a 400."""
        self.mapper_service.merge(mapping)

    # ------------------------------------------------------------------
    # Routing + document ops
    # ------------------------------------------------------------------

    def _rebuild_parents(self) -> None:
        """The _parent registry from recovered shard state: the sealed
        segments' live docs and the translog-replayed buffer."""
        for shard in self.shards.values():
            eng = shard.engine
            for seg in eng.segments:
                for local, p in enumerate(seg.parents):
                    if p is not None and seg.live[local]:
                        self.parents[str(seg.doc_ids[local])] = str(p)
            for local, p in enumerate(eng.buffer.parents):
                if p is not None and local not in eng._buffer_deletes:
                    self.parents[str(eng.buffer.doc_ids[local])] = str(p)

    def _route(self, doc_id: str, routing: Optional[str] = None) -> int:
        return shard_id_for(routing if routing is not None else doc_id,
                            self.num_shards)

    def index_doc(self, doc_id: str, source: dict, routing: Optional[str] = None,
                  parent: Optional[str] = None, **kw) -> dict:
        routing = self._check_join_routing(doc_id, source, routing)
        r = self.shards[self._route(doc_id, routing)].index_doc(
            doc_id, source, routing, parent=parent, **kw)
        if parent is not None:
            self.parents[str(doc_id)] = str(parent)
        return r

    def _check_join_routing(self, doc_id: str, source: dict,
                            routing: Optional[str]) -> Optional[str]:
        """A join child lives on its parent's shard: on a multi-shard
        index a child without routing is refused; on one shard the
        routing defaults to the parent id."""
        jf = join_field_of(self.mapper_service)
        if jf is None:
            return routing
        value = source.get(jf.name)
        if not isinstance(value, (str, dict)):
            return routing
        try:
            _name, parent = jf.parse_join(value)
        except Exception:  # noqa: BLE001 — the mapper reports it, in context
            return routing
        if parent is None:
            return routing
        if routing is None:
            if self.num_shards > 1:
                raise IllegalArgumentException(
                    f"[routing] is missing for join field [{jf.name}]: "
                    f"child document [{doc_id}] must be routed to its "
                    f"parent's shard")
            routing = parent
        return routing

    def get_doc(self, doc_id: str, routing: Optional[str] = None,
                realtime: bool = True):
        with self._stats_lock:
            self._get_total += 1
        return self.shards[self._route(doc_id, routing)].get_doc(
            doc_id, realtime=realtime)

    def delete_doc(self, doc_id: str, routing: Optional[str] = None, **kw) -> dict:
        return self.shards[self._route(doc_id, routing)].delete_doc(doc_id, **kw)

    def update_doc(self, doc_id: str, body: dict, routing: Optional[str] = None,
                   version: Optional[int] = None) -> dict:
        """The update API (action/update/TransportUpdateAction): a partial
        ``doc`` merge (``detect_noop``), ``upsert``, ``doc_as_upsert``
        and ``scripted_upsert``; a scripted update runs painless over
        ``ctx._source`` with ``ctx.op`` (``none`` / ``noop`` / ``delete``).
        ``version``: the internal optimistic-concurrency check against
        the doc's current version. Every write goes through ``index_doc``
        or ``delete_doc``, so an update takes the join routing check, the
        translog and the staging an index op takes."""
        shard = self.shards[self._route(doc_id, routing)]
        existing = shard.get_doc(doc_id)
        if version is not None and existing.found \
                and existing.version != version:
            raise VersionConflictEngineException(
                doc_id, existing.version, version)
        if not existing.found:
            if body.get("doc_as_upsert") and "doc" in body:
                return self.index_doc(doc_id, body["doc"], routing)
            if "upsert" in body:
                if "script" in body and body.get("scripted_upsert"):
                    return self._scripted_update(
                        doc_id, body, dict(body["upsert"]), routing,
                        version=0)
                return self.index_doc(doc_id, body["upsert"], routing)
            raise DocumentMissingException(self.name, doc_id)
        if "script" in body:
            # a deep copy: the engine hands out the stored source itself,
            # and a script that mutates a nested object and then sets
            # ctx.op = 'none' must leave the stored doc untouched
            return self._scripted_update(
                doc_id, body, copy.deepcopy(existing.source), routing,
                version=existing.version)
        if "doc" in body:
            merged = _deep_merge(dict(existing.source), body["doc"])
            if merged == existing.source and body.get("detect_noop", True):
                return {"_index": self.name, "_id": doc_id,
                        "_version": existing.version, "result": "noop"}
            return self.index_doc(doc_id, merged, routing)
        raise DocumentMissingException(self.name, doc_id)

    def _scripted_update(self, doc_id: str, body: dict, source: dict,
                         routing: Optional[str], version: int) -> dict:
        spec = body["script"]
        script = compile_script(spec)
        if not hasattr(script, "run"):
            raise IllegalArgumentException(
                "update scripts must be painless (the numeric expression "
                "engine has no ctx mutation surface)")
        params = (spec.get("params") if isinstance(spec, dict) else None) or {}
        new_source, op = execute_update_script(
            script, source, params,
            doc_meta={"_index": self.name, "_id": doc_id,
                      "_version": version})
        if op == "none":
            return {"_index": self.name, "_id": doc_id,
                    "_version": version, "result": "noop"}
        if op == "delete":
            return self.delete_doc(doc_id, routing=routing)
        return self.index_doc(doc_id, new_source, routing)

    def refresh(self) -> None:
        with self._stats_lock:
            self._refresh_total += 1
        for shard in self.shards.values():
            shard.refresh()

    def _healthy_shards(self) -> List[IndexShard]:
        """The shards a flush or merge may commit: a quarantined shard
        loaded nothing, and a commit of its empty segment set would delete
        the bytes its marker holds for a re-recovery."""
        return [s for _sid, s in sorted(self.shards.items())
                if not s.store_corrupted]

    def _each_healthy_shard(self, fn) -> Dict[int, object]:
        """``fn(shard)`` on every healthy shard, a thread a shard (a
        shard's flush writes and fsyncs its own store and translog);
        {shard_id: result}; the first failure raises."""
        shards = self._healthy_shards()
        with ThreadPoolExecutor(max_workers=max(len(shards), 1)) as pool:
            return dict(zip([s.shard_id for s in shards],
                            pool.map(fn, shards)))

    def flush(self) -> None:
        with self._stats_lock:
            self._flush_total += 1
        self._each_healthy_shard(IndexShard.flush)

    def synced_flush(self) -> Dict[int, str]:
        """Flush with a synced-flush marker on every healthy shard;
        returns {shard_id: sync_id}."""
        with self._stats_lock:
            self._flush_total += 1
        return self._each_healthy_shard(IndexShard.synced_flush)

    def force_merge(self) -> None:
        for shard in self._healthy_shards():
            shard.force_merge()

    def _quarantine_shard(self, sid: int, exc: Exception,
                          site: str = "query") -> None:
        """Quarantine a corrupt shard copy: write the store's corruption
        marker (once; the first cause wins), flag the shard, and release
        its device arrays and the mesh plane's staging."""
        shard = self.shards[sid]
        store = shard.engine.store
        integ = integrity_service()
        integ.record_corruption(self.name, sid, site, str(exc))
        already = store.is_corrupted()
        marker = store.mark_corrupted(str(exc), site=site)
        if not already:
            integ.record_marker(self.name, sid, marker, action="marked")
        shard.store_corrupted = True
        for seg in shard.engine.segments:
            seg.release_device()
        if self._mesh_search is not None:
            self._mesh_search._drop_staging()

    def unquarantine_shard(self, sid: int) -> None:
        """A verified byte set replaced the quarantined copy: clear its
        markers and flag (the only way out of quarantine; a load never
        calls it)."""
        shard = self.shards[sid]
        store = shard.engine.store
        for marker in store.corruption_markers():
            integrity_service().record_marker(self.name, sid, marker,
                                              action="cleared")
        store.clear_corruption_markers()
        shard.store_corrupted = False

    # ------------------------------------------------------------------
    # The store and device scrubber
    # ------------------------------------------------------------------

    def _scrub_effective_interval(self) -> Optional[float]:
        """The cluster-level override while one is set, else
        ``index.scrub.interval``; None or <= 0 is off."""
        if self.scrub_interval_override is not None:
            return self.scrub_interval_override
        return INDEX_SCRUB_INTERVAL.get(self.settings)

    def _scrub_loop(self) -> None:
        while True:
            iv = self._scrub_effective_interval()
            if self._scrub_stop.wait(iv if iv is not None and iv > 0
                                     else 5.0):
                return
            iv = self._scrub_effective_interval()
            if iv is None or iv <= 0:
                continue  # off (or turned off while waiting)
            try:
                self.scrub_now()
            except Exception:  # noqa: BLE001 — the loop goes on
                _scrub_log.warning("[%s] scrub pass failed", self.name,
                                   exc_info=True)

    def scrub_now(self) -> dict:
        """One scrub pass (the thread's body; tests call it directly).
        For each healthy shard:

        - the disk: every committed segment's checksums again, nested
          sub-segments too (sealed files never change, so a mismatch is
          corruption at rest): the shard is quarantined, ``site="scrub"``;
        - the card: each staged base table (``block_docs``,
          ``block_tfs``, ``norms``) copied back and hashed against the
          host truth cast to the staged dtype (the staging made the same
          cast, so a clean table matches bit for bit): a drift releases
          the segment's staging, whose restage the ledger records with
          the ``scrub`` reason, and counts; drifted bytes never serve.

        Returns {bytes_verified, checksum_failures, drift}."""
        bytes_verified = 0
        checksum_failures = 0
        drift = 0
        for sid, shard in sorted(self.shards.items()):
            store = shard.engine.store
            if shard.store_corrupted or (store is not None
                                         and store.is_corrupted()):
                continue  # quarantined: healed, not verified again
            commit = (store.read_commit() if store is not None else None) \
                or {}
            for seg_name in commit.get("segments", []):
                try:
                    bytes_verified += store.verify_segment(seg_name)
                except CorruptIndexException as e:
                    checksum_failures += 1
                    self._quarantine_shard(sid, e, site="scrub")
                    break
                except OSError:
                    continue  # raced a merge's or a commit's cleanup
            if shard.store_corrupted:
                continue
            for seg in list(shard.engine.segments):
                dev = seg._device
                if not dev:
                    continue
                for key, host in (("block_docs", seg.block_docs),
                                  ("block_tfs", seg.block_tfs),
                                  ("norms", seg.norms)):
                    staged = dev.get(key)
                    if staged is None:
                        continue
                    dev_np = staged.cpu().numpy()
                    bytes_verified += int(dev_np.nbytes)
                    host_np = np.asarray(host).astype(dev_np.dtype,
                                                      copy=False)
                    if (hashlib.sha256(dev_np.tobytes()).digest()
                            != hashlib.sha256(host_np.tobytes()).digest()):
                        drift += 1
                        integrity_service().record_scrub_drift(
                            self.name, sid, seg.name, key)
                        # the restage adopts host truth again, recorded
                        # with the scrub reason
                        seg.stage_reason_initial = "scrub"
                        seg.release_device()
                        break
        integrity_service().record_scrub_run(bytes_verified)
        return {"bytes_verified": bytes_verified,
                "checksum_failures": checksum_failures, "drift": drift}

    def _mesh_allowed(self) -> bool:
        """The mesh plane serves every shard as one program and cannot
        report one shard's failure: it stands aside while a shard is
        quarantined."""
        return self._mesh_enabled and not any(
            s.store_corrupted for s in self.shards.values())

    def num_docs(self) -> int:
        return sum(s.num_docs for s in self.shards.values())

    def mapping_dict(self) -> dict:
        return self.mapper_service.mapping_dict()

    def close(self) -> None:
        """Release what the index holds on its device (the counterpart of
        ``elasticsearch_tpu/index/index_service.py``'s ``close``): the
        micro-batcher stops forming groups, the mesh plane drops its
        staging, and every shard's segments drop their device arrays
        and kernel tables. The card's memory is the state this index
        keeps: a delete that left it staged would leak it."""
        self._batcher.enabled = False
        self._mesh_enabled = False
        self._closing = True
        self._stop_refresh_timer()
        self._scrub_stop.set()
        self._scrub_thread.join()
        # queued searches wake with a clean rejection: none hangs on a
        # closing index
        self.admission.shutdown()
        # a compaction pass in flight finishes its shard and stops
        with self._compact_lock:
            pass
        if self._mesh_search is not None:
            self._mesh_search._drop_staging()
        for shard in self.shards.values():
            shard.close()
        # the ledger backstop: whatever the structured releases left
        memory_accountant().release_index(self.name)

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def search(self, body: Optional[dict] = None,
               pinned_segments: Optional[Dict[int, list]] = None,
               deadline: Optional[SearchDeadline] = None,
               task=None) -> dict:
        """pinned_segments: {shard_id: [PinnedSegmentView]} of an open
        scroll: the query phase reads those views and bypasses the
        micro-batcher, the mesh plane and can_match (all keyed to the
        live segment set).
        deadline: the coordinator's ``SearchDeadline``; a direct caller's
        ``timeout`` or ``task`` (a registered ``tasks.task_manager.Task``)
        gets its own. Expiry degrades to the partial result with
        ``timed_out: true``; a cancelled task raises
        ``TaskCancelledException`` at the next checkpoint."""
        t0 = time.monotonic()
        body = body or {}
        if deadline is None and (body.get("timeout") is not None
                                  or task is not None):
            deadline = SearchDeadline(parse_search_timeout(body), task)
        cache_key = None
        if (self._request_cache_enabled and pinned_segments is None
                and cacheable(body)):
            epochs = [shard_epoch(self.shards[sid])
                      for sid in sorted(self.shards)]
            cache_key = RequestCache.key_for(body, epochs)
            if cache_key is not None:
                cached = self.request_cache.get(cache_key)
                if cached is not None:
                    cached["took"] = int((time.monotonic() - t0) * 1000)
                    return cached
        resp = self._search_dispatch(body, pinned_segments, deadline)
        if (cache_key is not None and not resp.get("timed_out")
                and not resp["_shards"].get("failed")
                and not resp.get("_degraded")):
            # neither a partial nor a browned-out answer enters the cache:
            # once the pressure drains the same body answers in full
            self.request_cache.put(cache_key, resp)
        return resp

    def _search_dispatch(self, body: dict,
                         pinned_segments: Optional[Dict[int, list]] = None,
                         deadline: Optional[SearchDeadline] = None) -> dict:
        """Admission control's choke point: every search takes an
        admission slot here, before any staging or launch. An overflow
        raises the 429; a deadline that expired while queued answers its
        timed-out partial result without running; an admitted search runs
        shaped by the brownout ladder (forced pruning, shed rescore, shed
        aggregations and suggesters), its answer marked ``_degraded``."""
        token = self.admission.acquire(deadline=deadline)
        if token.shed_expired:
            if deadline is not None:
                deadline.timed_out = True
            return expired_queue_response(self.name, len(self.shards), body)
        try:
            shaped, degraded = self.admission.apply_brownout(body, token)
            with scoped_forced_pruning(token):
                resp = self._admitted_dispatch(shaped, pinned_segments,
                                               deadline)
            if degraded:
                resp["_degraded"] = degraded
            return resp
        finally:
            self.admission.release(token)

    def _admitted_dispatch(self, body: dict,
                           pinned_segments: Optional[Dict[int, list]] = None,
                           deadline: Optional[SearchDeadline] = None
                           ) -> dict:
        """Route the query phase through the cross-query micro-batcher
        when eligible: a concurrent burst of compatible queries shares one
        batched kernel launch; a lone query runs at once. A batch item is
        (body, deadline, tracer, X-Opaque-Id), so each member keeps its
        own: the batch runs on its leader's thread."""
        tracer = self._tracer()
        if (not self._batcher.enabled or pinned_segments is not None
                or not batchable_body(body)):
            return self._search_uncached(body,
                                         pinned_segments=pinned_segments,
                                         deadline=deadline, tracer=tracer)
        # requests admitted with and without forced pruning never share a
        # batch: the batch prunes by its leader's token
        return self._batcher.run(
            (self.name, forced_pruning()),
            (body, deadline, tracer, get_opaque_id()),
            single_fn=lambda it: self._search_uncached(
                it[0], deadline=it[1], tracer=it[2]),
            batch_fn=lambda items: self.search_batch(
                [it[0] for it in items], [it[1] for it in items],
                [it[2] for it in items], [it[3] for it in items]))

    def _telemetry_enabled(self) -> bool:
        """``search.telemetry.enabled``: the cluster-level override while
        one is set, else the index's settings."""
        if self.telemetry_enabled_override is not None:
            return bool(self.telemetry_enabled_override)
        return SEARCH_TELEMETRY_ENABLED.get(self.settings)

    def _tracer(self):
        """One request's tracer (``NULL_TRACER`` while telemetry is off),
        annotated with the request's X-Opaque-Id, so the id survives the
        batch leader's thread."""
        tracer = self.telemetry.tracer(self._telemetry_enabled())
        oid = get_opaque_id()
        if oid:
            tracer.annotate("opaque_id", oid)
        return tracer

    @staticmethod
    def _annotate_batch_member(item, wait_s: float, batch_size: int,
                               member_index: int) -> None:
        """The batcher's hook: a member's collection-window wait on its
        tracer. The launch sites own ``batch_size``: a member that falls
        to serial execution claims no batch shape."""
        tracer = item[2]
        if tracer.enabled:
            tracer.annotate("batch_window_wait_ms",
                            round(wait_s * 1000.0, 3))

    def _mesh_plane(self):
        ms = self._mesh_search
        if ms is None:
            with self._mesh_lock:
                if self._mesh_search is None:
                    from elasticsearch_tpu_torch.parallel.plan_exec import (
                        IndexMeshSearch,
                    )

                    self._mesh_search = IndexMeshSearch(self)
                ms = self._mesh_search
        return ms

    # ------------------------------------------------------------------
    # Background slot compaction
    # ------------------------------------------------------------------

    def _compact_threshold(self) -> float:
        """``index.staging.compact.threshold``, the cluster-level override
        first; <= 0 turns compaction off."""
        if self.staging_compact_threshold_override is not None:
            return float(self.staging_compact_threshold_override)
        return float(INDEX_STAGING_COMPACT_THRESHOLD.get(self.settings))

    def _compaction_due(self) -> bool:
        """A staged slot's tombstone density, or the slot fragmentation,
        reached the threshold (host counters only, no device work)."""
        threshold = self._compact_threshold()
        if threshold <= 0:
            return False
        ms = self._mesh_search
        stats = ms.staging_slot_stats() if ms is not None else None
        if not stats or not stats["slots"]:
            return False
        if any(s["tombstone_density"] >= threshold for s in stats["slots"]):
            return True
        # fragmentation: occupied slots beyond what the live docs need
        occupied = len(stats["slots"])
        needed = max(1, -(-sum(s["live"] for s in stats["slots"])
                          // max(max(s["docs"] for s in stats["slots"]), 1)))
        return occupied > needed and (
            (occupied - needed) / occupied >= threshold)

    def maybe_compact_async(self) -> bool:
        """The delta-commit hook (the mesh plane calls it, possibly under
        its stage lock): decide cheaply, then run the pass on a background
        thread, never on the query path. True when a pass started."""
        if (self._closing or self.admission.draining
                or not self._compaction_due()):
            return False
        if self._compact_lock.locked():
            return False  # single flight: a pass is already running
        threading.Thread(target=self.compact_now, daemon=True,
                         name=f"compact[{self.name}]").start()
        return True

    def compact_now(self) -> dict:
        """One synchronous compaction pass (the background thread's body;
        tests call it directly): force-merge the tombstone-dense and the
        fragmented shards (expunging deletes), then restage a fresh
        generation with fresh slot headroom and release the old one.
        Single flight through ``_compact_lock``. A ``close`` or a drain
        that begins mid-pass aborts it between shards, leaving a
        consistent (merely uncompacted) staging."""
        if not self._compact_lock.acquire(blocking=False):
            return {"ran": False, "reason": "already_running"}
        try:
            if self._closing:
                return {"ran": False, "reason": "closing"}
            if self.admission.draining:
                return {"ran": False, "reason": "draining"}
            threshold = self._compact_threshold()
            merged_shards = []
            for sid, shard in sorted(self.shards.items()):
                if self._closing:
                    return {"ran": False, "reason": "closing",
                            "merged_shards": merged_shards}
                if self.admission.draining:
                    return {"ran": False, "reason": "draining",
                            "merged_shards": merged_shards}
                if shard.store_corrupted:
                    continue
                eng = shard.engine
                total = sum(int(s.num_docs) for s in eng.segments)
                live = sum(int(s.live_doc_count) for s in eng.segments)
                dense = (total > 0 and threshold > 0
                         and (total - live) / total >= threshold)
                frag = len(eng.segments) > 1
                if dense or frag:
                    eng.force_merge(stage_reason="compaction")
                    merged_shards.append(sid)
            if self._closing:
                return {"ran": False, "reason": "closing",
                        "merged_shards": merged_shards}
            ms = self._mesh_search
            restaged = (ms.restage_for_compaction()
                        if ms is not None else False)
            if ms is not None:
                ms.note_compaction_run()
            return {"ran": True, "merged_shards": merged_shards,
                    "restaged": bool(restaged)}
        finally:
            self._compact_lock.release()

    @staticmethod
    def _window(body: dict):
        from_ = int(body.get("from", 0) or 0)
        size = int(body.get("size")) if body.get("size") is not None else 10
        return from_, size

    def _finish_query_response(self, resp: dict, body: dict, tracer,
                               plane: str, t0: float) -> dict:
        """One choke point for a query's observability, whatever plane
        served it: the tracer drains into the phase histograms, a
        mesh-served body joins the warm variants, a profiled request gets
        its plane, phase spans and annotations (beside the host rung's
        per-segment trees), and a mesh-served query its slowlog line (the
        host rung's shards log their own)."""
        self.telemetry.record_query(plane, tracer)
        self._record_warm_variant("search", [body], plane)
        if plane != "host":
            emit_search_slowlog(self._slowlog_warn_s, self._slowlog_info_s,
                                time.monotonic() - t0, "index", self.name,
                                plane, tracer, body)
        if body.get("profile"):
            prof = resp.setdefault("profile", {"shards": []})
            prof["plane"] = plane
            prof["phases"] = tracer.spans()
            prof["annotations"] = tracer.annotations()
        return resp

    def _mesh_response(self, body: dict, out: dict, t0: float,
                       tracer=NULL_TRACER, demux: bool = False) -> dict:
        """A response from the mesh plane's query-phase result + the host
        fetch phase. ``demux``: the result is a batch member's share."""
        t_demux = tracer.start("batch_demux") if demux else None
        from_, size = self._window(body)
        refs = out["refs"]
        refs_window = refs[from_: from_ + size] if size >= 0 else refs[from_:]
        if t_demux is not None:
            tracer.stop("batch_demux", t_demux)
        t_fetch = tracer.start("fetch")
        hits = fetch_hits(refs_window, self.shards, body, self.name)
        tracer.stop("fetch", t_fetch)
        n = len(self.shards)
        resp = {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": False,
            "_plane": out["plane"],
            "_shards": {"total": n, "successful": n, "skipped": 0,
                        "failed": 0},
            "hits": {"total": out["total"], "max_score": out["max_score"],
                     "hits": hits},
        }
        if out.get("terminated_early") is not None:
            resp["terminated_early"] = bool(out["terminated_early"])
        if out.get("pruned") is not None:
            # block-max pruned scoring served the query phase: the tile
            # economy and the gte-total marker, beside _plane
            resp["_pruned"] = out["pruned"]
        if out.get("aggregations") is not None:
            resp["aggregations"] = out["aggregations"]
        if body.get("suggest"):
            resp["suggest"] = run_suggest(body["suggest"], self.shards,
                                          self.mapper_service)
        return self._finish_query_response(resp, body, tracer, out["plane"],
                                           t0)

    def _try_mesh_search(self, body: dict, k: int, deadline=None,
                         tracer=NULL_TRACER) -> Optional[dict]:
        """Mesh query phase + host fetch phase. None = ineligible."""
        t0 = time.monotonic()
        out = self._mesh_plane().query(body, max(k, 1), deadline=deadline,
                                       tracer=tracer)
        if out is None:
            return None
        return self._mesh_response(body, out, t0, tracer)

    def _try_mesh_knn(self, body: dict, spec: dict, k: int, deadline=None,
                      tracer=NULL_TRACER) -> Optional[dict]:
        """kNN query phase on the mesh plane's kNN rung (kernel 3) + host
        fetch phase. None = ineligible (the caller runs the host rung)."""
        t0 = time.monotonic()
        out = self._mesh_plane().query_knn(spec, max(k, 1), deadline=deadline,
                                           stats=body.get("stats"),
                                           tracer=tracer)
        if out is None:
            return None
        # assembled as a batch member's (the kNN rung serves Q == 1 as a
        # batch of one), as in the JAX package
        return self._mesh_response(body, out, t0, tracer, demux=True)

    def _search_uncached(self, body: dict,
                         score_caches: Optional[dict] = None,
                         skip_mesh: bool = False,
                         pinned_segments: Optional[Dict[int, list]] = None,
                         deadline: Optional[SearchDeadline] = None,
                         tracer=None) -> dict:
        """score_caches: {(shard_id, segment_name): (scores, matched)} from
        a batched kernel launch (search_batch); cached segments skip plan
        execution. skip_mesh: the query already went through the batch's
        plane ladder. pinned_segments: a scroll's views (host rung only).
        deadline: checkpointed through the planes; expiry gives the
        partial result with ``timed_out``. tracer: the request's phase
        spans (a profiled request's), whichever plane serves.

        Per-shard failure isolation on the host rung: a request error
        (4xx) raises with its own status, a cancellation raises, an
        expired deadline stops the fan-out, a corrupt store quarantines
        its shard, and anything else becomes a ``_shards.failures``
        entry. "all shards failed" is raised only when no shard answered
        and none timed out; ``allow_partial_search_results: false`` turns
        a failure or a timeout into a ``SearchPhaseExecutionException``."""
        if tracer is None:
            tracer = self._tracer()
        t0 = time.monotonic()
        body = body or {}
        # fault injection at dispatch (EvictionStormScheme forces the
        # ledger's evictor here, under real query load)
        on_query_begin(self.name)
        if body.get("knn") is not None:
            # the top-level knn section: alone, a pure vector search (the
            # knn query clause); beside ``query``, hybrid ranking
            if not isinstance(body["knn"], dict):
                raise IllegalArgumentException(
                    "[knn] must be an object with [field] and "
                    "[query_vector]")
            if body.get("query") is not None:
                return self._search_hybrid(body, deadline=deadline)
            body = dict(body)
            spec = body.pop("knn")
            if body.pop("rank", None) is not None:
                raise IllegalArgumentException(
                    "[rank] requires both [query] and [knn] sections")
            body["query"] = {"knn": spec}
            if body.get("size") is None and spec.get("k") is not None:
                body["size"] = int(spec["k"])
        check_body(body)
        from_, size = self._window(body)
        k = from_ + size
        sort_spec = normalize_sort(body.get("sort"))
        allow_partial = allow_partial_results(body)
        timed_out = False
        # a pinned (scroll) search stays on the host rung: the mesh plane
        # stages the live segment set
        if (self._mesh_allowed() and not skip_mesh
                and pinned_segments is None):
            try:
                knn_clause = _pure_knn_mesh_clause(body)
                if knn_clause is not None:
                    resp = self._try_mesh_knn(body, knn_clause, k,
                                              deadline=deadline,
                                              tracer=tracer)
                else:
                    resp = self._try_mesh_search(body, k, deadline=deadline,
                                                 tracer=tracer)
            except TimeExceededException:
                # the deadline expired inside the mesh plane (before a
                # launch): the host loop below stops at once and reports
                # the empty partial result
                resp = None
                timed_out = True
            if resp is not None:
                return resp
        self.host_query_total += 1
        shard_ids = sorted(self.shards)
        # can_match prefilter: shards whose doc-value bounds cannot
        # satisfy a pure range query skip the query phase, keeping at
        # least one so a real query phase shapes the response
        skipped = 0
        active_ids = []
        for sid in shard_ids:
            # a pinned search bypasses can_match: its bounds come from the
            # live segment set, not the pinned views
            if (pinned_segments is None
                    and not _can_match(self.shards[sid], body)):
                skipped += 1
                continue
            active_ids.append(sid)
        if not active_ids and shard_ids:
            active_ids = [shard_ids[0]]
            skipped -= 1
        shard_results = []
        failures = []
        for sid in active_ids:
            if timed_out or (deadline is not None and deadline.expired):
                # the finished shards stand; the fan-out stops
                timed_out = True
                if deadline is not None:
                    deadline.timed_out = True
                break
            try:
                if self.shards[sid].store_corrupted:
                    # a quarantined shard fails into _shards.failures,
                    # never as silently empty hits
                    raise CorruptIndexException(
                        f"shard [{self.name}][{sid}] store is marked "
                        f"corrupted — awaiting re-recovery from a healthy "
                        f"copy")
                shard_cache = None
                if score_caches:
                    shard_cache = {name: pair for (s, name), pair
                                   in score_caches.items() if s == sid}
                shard_results.append(self.shards[sid].searcher.query(
                    body, size_hint=max(k, 1), score_cache=shard_cache,
                    segments=(pinned_segments.get(sid, [])
                              if pinned_segments is not None else None),
                    deadline=deadline, tracer=tracer))
            except TaskCancelledException:
                raise
            except TimeExceededException:
                timed_out = True
                break
            except Exception as e:  # noqa: BLE001 — per-shard isolation
                if _is_request_error(e):
                    # deterministic on every shard: its own 4xx status
                    raise
                if (isinstance(e, CorruptIndexException)
                        and not self.shards[sid].store_corrupted):
                    # first found on the query path: quarantine the copy
                    self._quarantine_shard(sid, e, site="query")
                failures.append(shard_failure_entry(self.name, sid, e))
        timed_out = timed_out or any(r.timed_out for r in shard_results)
        if failures and not shard_results and not timed_out:
            raise SearchPhaseExecutionException(
                "query", "all shards failed", failures)
        if not allow_partial and (failures or timed_out):
            raise SearchPhaseExecutionException(
                "query",
                "Partial shards failure"
                + (" (request timed out)" if timed_out else ""),
                failures)
        total = sum(r.total_hits for r in shard_results)
        max_score = None
        for r in shard_results:
            if r.max_score is not None:
                max_score = r.max_score if max_score is None else max(max_score, r.max_score)
        collapse_body = body.get("collapse") or {}
        collapse_field = collapse_body.get("field")
        # collapse keeps every candidate, then cuts to k groups
        merge_k = 0 if collapse_field else max(k, 0)
        t_merge = tracer.start("merge")
        all_refs = [ref for r in shard_results for ref in r.refs]
        refs = merge_refs(all_refs, sort_spec, merge_k or len(all_refs))
        if collapse_field:
            refs = collapse_refs(refs, collapse_field)[: max(k, 0)]
        refs_window = refs[from_: from_ + size] if size >= 0 else refs[from_:]
        tracer.stop("merge", t_merge)

        aggregations = None
        agg_specs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        if agg_specs:
            t_agg = tracer.start("aggregate")
            views = [v for r in shard_results for v in r.agg_views]
            aggregations = run_aggregations(agg_specs, views)
            tracer.stop("aggregate", t_agg)

        t_fetch = tracer.start("fetch")
        hits = fetch_hits(refs_window, self.shards, body, self.name,
                          pinned_segments=pinned_segments)
        tracer.stop("fetch", t_fetch)
        if collapse_field:
            expand_collapsed_hits(
                hits, refs_window, collapse_body, body,
                lambda sub: self.search(sub, deadline=deadline))
        resp = {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": timed_out,
            "_plane": "host",
            "_shards": {
                # shards the deadline cut before they ran count successful
                "total": len(shard_ids),
                "successful": len(shard_ids) - len(failures),
                "skipped": skipped,
                "failed": len(failures),
            },
            "hits": {
                "total": total,
                "max_score": max_score,
                "hits": hits,
            },
        }
        if failures:
            resp["_shards"]["failures"] = failures
        if any(r.terminated_early is not None for r in shard_results):
            resp["terminated_early"] = any(
                bool(r.terminated_early) for r in shard_results)
        if aggregations is not None:
            resp["aggregations"] = aggregations
        if body.get("profile"):
            resp["profile"] = {"shards": [
                s for r in shard_results for s in (r.profile or [])]}
        if body.get("suggest"):
            resp["suggest"] = run_suggest(body["suggest"], self.shards,
                                          self.mapper_service)
        return self._finish_query_response(resp, body, tracer, "host", t0)

    def _search_hybrid(self, body: dict, deadline=None) -> dict:
        """Hybrid ranking: the lexical ``query`` and the ``knn`` section
        each retrieve a top-``window`` list through their own plane ladder,
        then fuse:

        - ``rank: {rrf: {...}}``: reciprocal rank fusion, score = sum over
          the sides of 1 / (rank_constant + rank);
        - default: convex score fusion, score = lexical score + knn boost *
          knn score, where only the knn side's ``k`` nearest count.

        The fused total is a lower bound (the union's exact count is not
        computed), marked ``_total_relation: "gte"``; ``_hybrid`` names
        each side's plane and the fusion."""
        t0 = time.monotonic()
        spec = body["knn"]
        if not isinstance(spec, dict) or "field" not in spec \
                or "query_vector" not in spec:
            raise IllegalArgumentException(
                "[knn] must be an object with [field] and [query_vector]")
        rank = body.get("rank")
        rrf = None
        if rank is not None:
            if not isinstance(rank, dict) or set(rank) != {"rrf"}:
                raise IllegalArgumentException(
                    "[rank] supports exactly one method: [rrf]")
            rrf = dict(rank.get("rrf") or {})
            unknown = set(rrf) - {"rank_constant", "window_size",
                                  "rank_window_size"}
            if unknown:
                raise IllegalArgumentException(
                    f"[rrf] unknown parameter(s) {sorted(unknown)}")
            if "window_size" not in rrf and "rank_window_size" in rrf:
                rrf["window_size"] = rrf["rank_window_size"]
            if int(rrf.get("rank_constant", 60)) < 1:
                raise IllegalArgumentException(
                    "[rank_constant] must be >= 1")
            if int(rrf.get("window_size", 1)) < 1:
                raise IllegalArgumentException(
                    "[window_size] must be >= 1")
        from_, size = self._window(body)
        k = max(from_ + size, 1)
        knn_k = int(spec.get("k", 10) or 10)
        window = max(k, knn_k)
        if rrf is not None:
            window = max(window, int(rrf.get("window_size", window)))
        rank_constant = int(rrf.get("rank_constant", 60)) if rrf else 60
        knn_boost = float(spec.get("boost", 1.0))

        # the knn side fetches with the lexical side's fetch options, so a
        # hit found only by the vector ranking shows the same fields
        passthrough = ("timeout", "allow_partial_search_results", "stats",
                       "_source", "docvalue_fields", "stored_fields",
                       "script_fields", "highlight", "version")
        lex_body = {key: v for key, v in body.items()
                    if key not in ("knn", "rank", "from", "size")}
        lex_body["size"] = window
        knn_body = {"query": {"knn": {key: v for key, v in spec.items()
                                      if key != "boost"}},
                    "size": window}
        for key in passthrough:
            if key in body:
                knn_body[key] = body[key]
        lex_resp = self._search_uncached(lex_body, deadline=deadline)
        knn_resp = self._search_uncached(knn_body, deadline=deadline)

        def ranked(resp):
            return {h["_id"]: (i + 1, h)
                    for i, h in enumerate(resp["hits"]["hits"])}

        lex_hits, knn_hits = ranked(lex_resp), ranked(knn_resp)
        if rrf is None:
            # only the k global nearest neighbors add a vector score
            knn_hits = {doc_id: (r, h) for doc_id, (r, h)
                        in knn_hits.items() if r <= knn_k}
        fused = []
        for doc_id in set(lex_hits) | set(knn_hits):
            lex_rank, lex_hit = lex_hits.get(doc_id, (None, None))
            knn_rank, knn_hit = knn_hits.get(doc_id, (None, None))
            if rrf is not None:
                score = sum(1.0 / (rank_constant + r)
                            for r in (lex_rank, knn_rank) if r is not None)
            else:
                score = ((lex_hit["_score"] or 0.0)
                         if lex_hit is not None else 0.0) \
                    + knn_boost * ((knn_hit["_score"] or 0.0)
                                   if knn_hit is not None else 0.0)
            hit = dict(lex_hit if lex_hit is not None else knn_hit)
            hit["_score"] = float(score)
            hit.pop("sort", None)
            fused.append(hit)
        fused.sort(key=lambda h: (-h["_score"], h["_id"]))
        page = fused[from_: from_ + size] if size >= 0 else fused[from_:]

        # both sides query the same shards: merge the failure sets by shard
        shards = dict(lex_resp["_shards"])
        seen = set()
        failures = []
        for f in (list(lex_resp["_shards"].get("failures") or [])
                  + list(knn_resp["_shards"].get("failures") or [])):
            key = (f.get("index"), f.get("shard"))
            if key not in seen:
                seen.add(key)
                failures.append(f)
        shards["failed"] = len(failures)
        shards["successful"] = max(
            int(shards.get("total", len(self.shards))) - len(failures), 0)
        shards.pop("failures", None)
        if failures:
            shards["failures"] = failures
        total = max(int(lex_resp["hits"]["total"]),
                    int(knn_resp["hits"]["total"]))
        resp = {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": bool(lex_resp.get("timed_out")
                              or knn_resp.get("timed_out")),
            "_plane": knn_resp.get("_plane", "host"),
            "_hybrid": {"lexical_plane": lex_resp.get("_plane", "host"),
                        "knn_plane": knn_resp.get("_plane", "host"),
                        "fusion": "rrf" if rrf is not None else "convex"},
            "_total_relation": "gte",
            "_shards": shards,
            "hits": {"total": total,
                     "max_score": (page[0]["_score"] if page else None),
                     "hits": page},
        }
        # aggregations and suggestions are computed by the lexical side,
        # whose window query saw the full matched set
        for key in ("aggregations", "suggest"):
            if key in lex_resp:
                resp[key] = lex_resp[key]
        return resp

    # ------------------------------------------------------------------
    # Cross-query micro-batching
    # ------------------------------------------------------------------

    def search_batch(self, bodies: List[dict],
                     deadlines: Optional[list] = None,
                     tracers: Optional[list] = None,
                     oids: Optional[list] = None) -> list:
        """Execute Q concurrent search requests as one micro-batch.

        Returns one entry per member: the response dict, or the exception
        that member alone should raise. ``deadlines``, ``tracers`` and
        ``oids`` (X-Opaque-Ids): each member's own (None for a direct
        caller: a fresh tracer a member, the caller's id); every member's
        answer is built under its own id. Rungs, as in the JAX package:
        0. a member whose deadline expired (or whose task was cancelled)
           before dispatch leaves the batch alone: it gets its partial
           result (or its error) and the others are served;
        1. mesh_pallas: one batched fused top-k launch per slot inside the
           mesh program (IndexMeshSearch.query_batch);
        2. host: one batched dense launch per segment feeds each member's
           per-query pipeline via score caches;
        3. members neither rung can share execute serially."""
        n = len(bodies)
        deadlines = list(deadlines) if deadlines else [None] * n
        tracers = (list(tracers) if tracers
                   else [self._tracer() for _ in bodies])
        oids = list(oids) if oids else [get_opaque_id()] * n
        results: list = [None] * n
        live: List[int] = []
        for i, body in enumerate(bodies):
            dl = deadlines[i]
            if dl is not None:
                try:
                    dl.checkpoint()
                except TaskCancelledException as e:
                    results[i] = e
                    continue
                except TimeExceededException:
                    # expired before dispatch: its serial path meets the
                    # same checkpoint and answers the partial result
                    results[i] = self._batch_member_single(
                        body, dl, tracer=tracers[i], oid=oids[i])
                    continue
            if not batchable_body(body):
                results[i] = self._batch_member_single(
                    body, dl, tracer=tracers[i], oid=oids[i])
                continue
            live.append(i)
        # pure-kNN members split off onto one batched kernel-3 launch;
        # members it cannot serve run their serial pipeline one by one
        knn_live = [i for i in live if knn_batch_spec(bodies[i])]
        if knn_live:
            live = [i for i in live if i not in set(knn_live)]
            self._dispatch_knn_batch(bodies, deadlines, tracers, oids,
                                     knn_live, results)
        if len(live) < 2:
            for i in live:
                results[i] = self._batch_member_single(
                    bodies[i], deadlines[i], tracer=tracers[i], oid=oids[i])
            return results
        live_bodies = [bodies[i] for i in live]
        mesh_out = None
        if self._mesh_allowed() and len(self.shards) >= 2:
            mesh_out = self._mesh_plane().query_batch(
                live_bodies, tracers=[tracers[i] for i in live])
        if mesh_out is not None:
            for j, i in enumerate(live):
                results[i] = self._batch_member_response(
                    bodies[i], mesh_out[j], tracers[i], oids[i])
            self.batch_stats.note_batch(len(live))
            # the burst's shape joins the warm variants: the batched
            # launch is another variant than the serial one
            self._record_warm_variant("search_batch", live_bodies,
                                      "mesh_pallas")
            return results
        caches, launches = self._host_batch_scores(live_bodies)
        # count only the members that shared a launch
        shared = sum(1 for c in caches if c)
        member_idx = 0
        for j, i in enumerate(live):
            if caches[j] and tracers[i].enabled:
                tracers[i].annotate("batch_size", shared)
                tracers[i].annotate("batch_member_index", member_idx)
            member_idx += bool(caches[j])
            results[i] = self._batch_member_single(
                bodies[i], deadlines[i], score_caches=caches[j] or None,
                skip_mesh=bool(caches[j]), tracer=tracers[i], oid=oids[i])
        if launches and shared:
            self.batch_stats.note_batch(shared)
        return results

    @staticmethod
    def _knn_member_body(body) -> dict:
        """The serial path's top-level-knn size normalization (size
        defaults to the spec's k), applied to a batch member, so a request
        returns the same hits whether or not it shared a batch."""
        body = dict(body or {})
        spec = body.get("knn")
        if (isinstance(spec, dict) and body.get("query") is None
                and body.get("size") is None
                and spec.get("k") is not None):
            body["size"] = int(spec["k"])
        return body

    def _dispatch_knn_batch(self, bodies, deadlines, tracers, oids,
                            knn_live, results) -> None:
        """Serve a burst of pure-kNN members: one batched kernel-3 launch
        when they target one field and the mesh plane serves them, else
        each member's serial pipeline. Fills ``results`` in place."""
        norm_bodies = {i: self._knn_member_body(bodies[i])
                       for i in knn_live}
        shared = []
        for i in knn_live:
            try:
                check_body({key: v for key, v in norm_bodies[i].items()
                            if key != "knn"})
                shared.append(i)
            except IllegalArgumentException:
                # an unsupported request key: the serial path raises the
                # member's own error
                results[i] = self._batch_member_single(
                    bodies[i], deadlines[i], tracer=tracers[i], oid=oids[i])
        specs = [knn_batch_spec(bodies[i]) for i in shared]
        ks = []
        for i in shared:
            from_, size = self._window(norm_bodies[i])
            ks.append(max(from_ + size, 1))
        mesh_out = None
        if (self._mesh_allowed() and len(self.shards) >= 2
                and len(shared) >= 2
                and len({str(s.get("field")) for s in specs}) == 1):
            mesh_out = self._mesh_plane().query_knn_batch(
                specs, ks, stats=[norm_bodies[i].get("stats")
                                  for i in shared],
                tracers=[tracers[i] for i in shared])
        if mesh_out is not None:
            for j, i in enumerate(shared):
                results[i] = self._batch_member_response(
                    norm_bodies[i], mesh_out[j], tracers[i], oids[i])
            self.batch_stats.note_batch(len(shared))
            self._record_warm_variant(
                "search_batch", [bodies[i] for i in shared], "mesh_pallas")
            return
        for i in shared:
            results[i] = self._batch_member_single(
                bodies[i], deadlines[i], tracer=tracers[i], oid=oids[i])

    def _batch_member_response(self, body, out, tracer, oid):
        """A member's answer from its share of a batched mesh launch,
        built under its own X-Opaque-Id; a fetch error is that member's
        result, never its peers'."""
        with scoped_opaque_id(oid):
            try:
                return self._mesh_response(body, out, time.monotonic(),
                                           tracer, demux=True)
            except Exception as e:  # noqa: BLE001 — per-member isolation
                return e

    def _batch_member_single(self, body, deadline=None, score_caches=None,
                             skip_mesh=False, tracer=None, oid=None):
        """One member's serial execution inside a batch, under its own
        X-Opaque-Id: an exception is that member's result (raised in its
        own caller), never its peers'."""
        with scoped_opaque_id(oid):
            try:
                return self._search_uncached(
                    body, score_caches=score_caches, skip_mesh=skip_mesh,
                    deadline=deadline, tracer=tracer)
            except Exception as e:  # noqa: BLE001 — per-member isolation
                return e

    # ------------------------------------------------------------------
    # The warm variants (common/compile_cache.py)
    # ------------------------------------------------------------------

    def _record_warm_variant(self, kind: str, bodies: List[dict],
                             plane: str) -> None:
        """Record a mesh-served body (or burst) as a replayable warm spec,
        once a shape (``body_skeleton``): the next process replays it
        before its first user request. A warm replay records nothing."""
        if plane not in ("mesh_pallas", "mesh") or not bodies:
            return
        if cc.in_warming():
            return
        try:
            # the steady state: the variant is known, one skeleton hash
            # and one dict probe
            key = (kind + "|" + str(min(len(bodies), 16)) + "|"
                   + "|".join(sorted({cc.body_skeleton(b)
                                      for b in bodies[:16]})))
            registry = cc.variant_registry()
            if registry.has_warm(self.name, key):
                return
            clean = [{k: v for k, v in (b or {}).items()
                      if k not in ("profile", "preference")}
                     for b in bodies[:16]]
            json.dumps(clean)  # only JSON-serializable bodies persist
            registry.record_warm(self.name, key,
                                 {"kind": kind, "bodies": clean})
        except (TypeError, ValueError):
            pass  # an unserializable body: this variant is not warmable

    def warm_compile_variants(self) -> int:
        """Replay this index's recorded warm specs under
        ``compile_cache.warming()``: the staging and each variant's first
        launch land in ``programs_warmed_total``, off the query path. The
        node runs it on a background thread at start; returns how many
        specs replayed cleanly (a stale one, a deleted field say, warms
        nothing)."""
        warmed = 0
        for spec in cc.variant_registry().warm_entries(self.name):
            bodies = [dict(b) for b in spec.get("bodies") or []]
            if not bodies:
                continue
            try:
                with cc.warming():
                    if spec.get("kind") == "search_batch":
                        self.search_batch(bodies)
                    else:
                        for body in bodies:
                            self._search_uncached(body)
                warmed += 1
            except Exception:  # noqa: BLE001 — warming never fails the
                continue  # node
        return warmed

    def _host_batch_scores(self, bodies: List[dict]):
        """Per-segment batched kernel launches for the host rung.

        Returns ([per-member {(shard_id, seg_name): (scores, matched)}],
        n_launches). A member whose plan on a segment is not one
        kernel-scored disjunction gets no cache entry there and executes
        that segment serially. The launch itself is not guarded: a kernel
        fault raises."""
        from elasticsearch_tpu_torch.search.batching import (
            batched_segment_scores,
            counts_safe_for_union,
        )
        from elasticsearch_tpu_torch.search.plan import PallasScoreTermsNode
        from elasticsearch_tpu_torch.search.query_dsl import parse_query

        caches: List[dict] = [dict() for _ in bodies]
        launches = 0
        qbs = []
        for body in bodies:
            try:
                qbs.append(parse_query(body.get("query")))
            except Exception:  # noqa: BLE001 — a parse error surfaces with
                # its own status when the member executes serially
                qbs.append(None)
        for sid in sorted(self.shards):
            shard = self.shards[sid]
            ctx = shard.searcher.ctx
            for seg in shard.engine.searchable_segments():
                if seg.num_docs == 0:
                    continue
                plans = []
                for qb in qbs:
                    node = None
                    if qb is not None:
                        try:
                            p = qb.to_plan(ctx, seg)
                        except Exception:  # noqa: BLE001 — the serial path
                            p = None  # owns this member's error shape
                        if (isinstance(p, PallasScoreTermsNode)
                                and getattr(p, "_host_lanes", None)
                                and counts_safe_for_union(p)):
                            node = p
                    plans.append(node)
                idxs = [i for i, p in enumerate(plans) if p is not None]
                if len(idxs) < 2:
                    continue  # nothing to share on this segment
                outs = batched_segment_scores(seg, [plans[i] for i in idxs])
                if outs is None:
                    continue
                launches += 1
                for j, i in enumerate(idxs):
                    caches[i][(sid, seg.name)] = outs[j]
        return caches, launches

    def search_stats(self) -> dict:
        """Which plane served the queries, the mesh plane's health, the
        pruned scoring's tile economy, the postings codec and the posting
        bytes staged, the fused aggregations and the host reduce's
        fallbacks by reason, the staging lifecycle's counters (rebuilds,
        delta appends, tombstone updates, compaction passes), the
        batcher's counters, the ``admission`` block, the telemetry's
        ``phases`` block, the ``memory`` block (the index's device-memory
        ledger: bytes by kind, restage amplification, the event rings and
        the budget's and retries' counters), and the process-wide
        ``compile`` and ``integrity`` blocks."""
        from elasticsearch_tpu_torch.parallel.plan_exec import PlaneHealth

        ms = self._mesh_search
        executor = ms._executor if ms else None
        # every searchable segment's staged kernel posting tables, each
        # codec once (the mesh plane reads these; it stages none of its own)
        segs = {id(seg): seg for shard in self.shards.values()
                for seg in shard.engine.searchable_segments()}
        planes = {
            "mesh_query_total": ms.query_total if ms else 0,
            "mesh_pallas_query_total": ms.pallas_query_total if ms else 0,
            "knn_query_total": ms.knn_query_total if ms else 0,
            "mesh_batched_launch_total": ms.batched_launch_total if ms else 0,
            "mesh_restage_total": ms.restage_total if ms else 0,
            "delta_restage_total": ms.delta_restage_total if ms else 0,
            "tombstone_update_total": (ms.tombstone_update_total
                                       if ms else 0),
            "compaction_runs_total": ms.compaction_runs_total if ms else 0,
            "pruned_query_total": ms.pruned_query_total if ms else 0,
            "tiles_scored_total": ms.tiles_scored_total if ms else 0,
            "tiles_pruned_total": ms.tiles_pruned_total if ms else 0,
            "postings_codec": (executor.postings_codec
                               if executor is not None else None),
            "postings_bytes_staged": sum(
                seg.postings_bytes_staged() for seg in segs.values()),
            "agg_fused_query_total": ms.agg_fused_query_total if ms else 0,
            "agg_host_fallback_total": (ms.agg_host_fallback_total
                                        if ms else 0),
            "agg_host_fallback_by_reason": (
                dict(ms.agg_host_fallback_by_reason) if ms else {}),
            "agg_host_mask_bytes_total": (ms.host_mask_bytes_total
                                          if ms else 0),
            "host_query_total": self.host_query_total,
            "decisions": dict(ms.decisions) if ms else {},
            **(ms.plane_health.stats() if ms else PlaneHealth().stats()),
        }
        return {"planes": planes, "batch": self.batch_stats.as_dict(),
                "admission": self.admission.stats_dict(),
                "phases": self.telemetry.phases_dict(),
                "memory": memory_accountant().stats(self.name),
                "compile": cc.compile_stats().stats(),
                "integrity": integrity_service().stats(self.name)}

    def stats(self) -> dict:
        """The ``_stats`` sections (the JAX package's ``IndexService.stats``):
        every section present, so a metric filter can subset; a counter
        the port does not keep (times, merges, warmers, the query cache it
        has no module for) reports zero."""
        shard_stats = {sid: s.stats() for sid, s in self.shards.items()}

        def total(section, key):
            return sum(s[section][key] for s in shard_stats.values())

        index_total = total("indexing", "index_total")
        delete_total = total("indexing", "delete_total")
        mem_bytes = total("segments", "memory_in_bytes")
        fielddata_bytes = sum(
            sum(seg.breaker_charges.values())
            for sh in self.shards.values()
            for seg in sh.engine.searchable_segments())
        groups: Dict[str, dict] = {}
        for st in shard_stats.values():
            for g, gs in (st["search"].get("groups") or {}).items():
                agg = groups.setdefault(g, {k: 0 for k in gs})
                for k, v in gs.items():
                    agg[k] += v
        search = {"open_contexts": 0,
                  "query_total": total("search", "query_total"),
                  **self.search_stats()}
        if groups:
            search["groups"] = groups
        totals = {
            "docs": {"count": self.num_docs(), "deleted": 0},
            "store": {"size_in_bytes": mem_bytes,
                      "throttle_time_in_millis": 0},
            "indexing": {
                "index_total": index_total, "index_time_in_millis": 0,
                "delete_total": delete_total, "index_failed": 0,
                "types": {self.doc_type or "_doc": {
                    "index_total": index_total, "index_time_in_millis": 0,
                    "delete_total": delete_total}},
            },
            "get": {"total": self._get_total, "time_in_millis": 0,
                    "exists_total": 0, "missing_total": 0, "current": 0},
            "search": search,
            "merges": {"current": 0, "current_docs": 0, "total": 0,
                       "total_time_in_millis": 0, "total_docs": 0},
            "refresh": {"total": self._refresh_total,
                        "total_time_in_millis": 0, "listeners": 0},
            "flush": {"total": self._flush_total,
                      "total_time_in_millis": 0},
            "warmer": {"current": 0, "total": 0, "total_time_in_millis": 0},
            "query_cache": {"memory_size_in_bytes": 0, "total_count": 0,
                            "hit_count": 0, "miss_count": 0,
                            "cache_count": 0, "evictions": 0},
            "fielddata": {"memory_size_in_bytes": fielddata_bytes,
                          "evictions": 0},
            "completion": {"size_in_bytes": 0},
            "segments": {"count": total("segments", "count"),
                         "memory_in_bytes": mem_bytes},
            "translog": {"operations": total("translog", "operations"),
                         "size_in_bytes": total("translog",
                                                "size_in_bytes")},
            "recovery": {"current_as_source": 0, "current_as_target": 0,
                         "throttle_time_in_millis": 0},
            "request_cache": self.request_cache.stats(),
        }
        return {"primaries": totals, "total": totals, "shards": shard_stats}


def _deep_merge(base: dict, patch: dict) -> dict:
    for key, value in patch.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            base[key] = _deep_merge(dict(base[key]), value)
        else:
            base[key] = value
    return base


def _is_request_error(exc: Exception) -> bool:
    """A 4xx engine exception: a request validation error (a malformed
    query, an unmapped field, a bad argument) that every shard would raise
    alike; it keeps its own status instead of becoming a shard
    failure."""
    return (isinstance(exc, ElasticsearchTpuException)
            and exc.status_code < 500)


def _pure_knn_mesh_clause(body: dict) -> Optional[dict]:
    """The knn spec when this request is a plain top-k vector search that
    the mesh kNN rung serves whole, else None: the sole knn clause (the
    normalized form) under the rules it shares with the batched dispatch
    (``batching.knn_batch_spec``), so the two paths cannot drift."""
    q = body.get("query")
    if not (isinstance(q, dict) and set(q) == {"knn"}):
        return None
    return knn_batch_spec(body)


def _can_match(shard, body: dict) -> bool:
    """Shard-level rewrite of a PURE range query against the shard's
    doc-value bounds (the reference's canMatch phase). Conservative:
    anything but a bare numeric range query matches."""
    query = (body or {}).get("query")
    if not isinstance(query, dict) or set(query) != {"range"}:
        return True
    (field, cond), = query["range"].items()
    if not isinstance(cond, dict):
        return True
    lo = cond.get("gte", cond.get("gt"))
    hi = cond.get("lte", cond.get("lt"))
    if not all(isinstance(v, (int, float)) or v is None for v in (lo, hi)):
        return True  # dates/strings need parsing context; don't prefilter
    any_col = False
    for seg in shard.engine.searchable_segments():
        col = seg.numeric_columns.get(field)
        if col is None or col.count == 0:
            continue
        any_col = True
        seg_min = float(col.min_value[seg.live[: seg.nd_pad]].min()) \
            if seg.live[: seg.num_docs].any() else float("inf")
        seg_max = float(col.max_value[seg.live[: seg.nd_pad]].max()) \
            if seg.live[: seg.num_docs].any() else float("-inf")
        if (lo is None or seg_max >= lo) and (hi is None or seg_min <= hi):
            return True
    # no doc values for the field on this shard: match, conservatively
    return not any_col
