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
   phase shard by shard, the merge of the shards' top-k, the
   aggregations over every shard's segment views, and fetch.

``search_batch`` has two rungs: the mesh plane's batched fused top-k
launch (``IndexMeshSearch.query_batch``), else one batched dense launch
per segment (``_host_batch_scores``) feeding each member's host pipeline
through score caches; members neither rung can share run serially.
Unlike the JAX package, ``_host_batch_scores`` catches nothing around the
batched launch: a kernel fault raises instead of re-serving the members
serially.

Every response carries the plane that served it in ``"_plane"``
(``mesh_pallas``, ``mesh`` or ``host``) and ``hits.total`` as a plain
int (the 6.x shape). The request cache, admission control, scrubbing,
compaction and telemetry are later slices.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.settings import (
    INDEX_NUMBER_OF_SHARDS,
    INDEX_SEARCH_MESH,
    INDEX_SEARCH_MESH_MAX_SLOTS,
    INDEX_SEARCH_MESH_PLANE,
    INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN,
    SEARCH_BATCH_ENABLED,
    SEARCH_BATCH_MAX_QUERIES,
    SEARCH_BATCH_WINDOW_MS,
    Settings,
)
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.index.similarity import SimilarityService
from elasticsearch_tpu_torch.mapper.mapping import MapperService
from elasticsearch_tpu_torch.search.aggregations import parse_aggs, run_aggregations
from elasticsearch_tpu_torch.search.batching import (
    BatchStats,
    MicroBatcher,
    batchable_body,
)
from elasticsearch_tpu_torch.search.service import (
    check_body,
    fetch_hits,
    merge_refs,
)
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for


class IndexService:
    def __init__(self, name: str, settings: Settings = Settings.EMPTY,
                 mapping: Optional[dict] = None, device="cuda"):
        self.name = name
        self.settings = settings
        self.device = resolve_device(device)
        self.num_shards = INDEX_NUMBER_OF_SHARDS.get(settings)
        # the mesh plane's settings are read when it first serves; parse
        # them now so a bad value fails index creation
        for setting in (INDEX_SEARCH_MESH_MAX_SLOTS, INDEX_SEARCH_MESH_PLANE,
                        INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN):
            setting.get(settings)
        self.analyzers = AnalysisRegistry(settings)
        self.mapper_service = MapperService(
            self.analyzers, mapping,
            similarity_service=SimilarityService(settings))
        self.shards: Dict[int, IndexShard] = {
            sid: IndexShard(name, sid, self.mapper_service, device=self.device)
            for sid in range(self.num_shards)
        }
        # the mesh data plane (parallel/plan_exec.IndexMeshSearch), staged
        # on the first eligible search
        self._mesh_enabled = INDEX_SEARCH_MESH.get(settings)
        self._mesh_search = None
        self.host_query_total = 0
        self.batch_stats = BatchStats()
        self._batcher = MicroBatcher(
            window_s=SEARCH_BATCH_WINDOW_MS.get(settings) / 1000.0,
            max_queries=SEARCH_BATCH_MAX_QUERIES.get(settings),
            enabled=SEARCH_BATCH_ENABLED.get(settings),
            stats=self.batch_stats)

    # ------------------------------------------------------------------
    # Routing + document ops
    # ------------------------------------------------------------------

    def _route(self, doc_id: str, routing: Optional[str] = None) -> int:
        return shard_id_for(routing if routing is not None else doc_id,
                            self.num_shards)

    def index_doc(self, doc_id: str, source: dict, routing: Optional[str] = None,
                  **kw) -> dict:
        return self.shards[self._route(doc_id, routing)].index_doc(
            doc_id, source, routing, **kw)

    def get_doc(self, doc_id: str, routing: Optional[str] = None,
                realtime: bool = True):
        return self.shards[self._route(doc_id, routing)].get_doc(
            doc_id, realtime=realtime)

    def delete_doc(self, doc_id: str, routing: Optional[str] = None, **kw) -> dict:
        return self.shards[self._route(doc_id, routing)].delete_doc(doc_id, **kw)

    def refresh(self) -> None:
        for shard in self.shards.values():
            shard.refresh()

    def num_docs(self) -> int:
        return sum(s.num_docs for s in self.shards.values())

    def mapping_dict(self) -> dict:
        return self.mapper_service.mapping_dict()

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def search(self, body: Optional[dict] = None) -> dict:
        return self._admitted_dispatch(body or {})

    def _admitted_dispatch(self, body: dict) -> dict:
        """Route the query phase through the cross-query micro-batcher
        when eligible: a concurrent burst of compatible queries shares one
        batched kernel launch; a lone query runs at once."""
        if not self._batcher.enabled or not batchable_body(body):
            return self._search_uncached(body)
        return self._batcher.run(self.name, body,
                                 single_fn=self._search_uncached,
                                 batch_fn=self.search_batch)

    def _mesh_plane(self):
        if self._mesh_search is None:
            from elasticsearch_tpu_torch.parallel.plan_exec import (
                IndexMeshSearch,
            )

            self._mesh_search = IndexMeshSearch(self)
        return self._mesh_search

    @staticmethod
    def _window(body: dict):
        from_ = int(body.get("from", 0) or 0)
        size = int(body.get("size")) if body.get("size") is not None else 10
        return from_, size

    def _mesh_response(self, body: dict, out: dict, t0: float) -> dict:
        """A response from the mesh plane's query-phase result + the host
        fetch phase."""
        from_, size = self._window(body)
        refs = out["refs"]
        refs_window = refs[from_: from_ + size] if size >= 0 else refs[from_:]
        hits = fetch_hits(refs_window, self.shards, body, self.name)
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
        if out.get("aggregations") is not None:
            resp["aggregations"] = out["aggregations"]
        return resp

    def _try_mesh_search(self, body: dict, k: int) -> Optional[dict]:
        """Mesh query phase + host fetch phase. None = ineligible."""
        t0 = time.monotonic()
        out = self._mesh_plane().query(body, max(k, 1))
        if out is None:
            return None
        return self._mesh_response(body, out, t0)

    def _search_uncached(self, body: dict,
                         score_caches: Optional[dict] = None,
                         skip_mesh: bool = False) -> dict:
        """score_caches: {(shard_id, segment_name): (scores, matched)} from
        a batched kernel launch (search_batch); cached segments skip plan
        execution. skip_mesh: the query already went through the batch's
        plane ladder."""
        t0 = time.monotonic()
        body = body or {}
        check_body(body)
        from_, size = self._window(body)
        k = from_ + size
        if self._mesh_enabled and not skip_mesh:
            resp = self._try_mesh_search(body, k)
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
            if not _can_match(self.shards[sid], body):
                skipped += 1
                continue
            active_ids.append(sid)
        if not active_ids and shard_ids:
            active_ids = [shard_ids[0]]
            skipped -= 1
        shard_results = []
        for sid in active_ids:
            shard_cache = None
            if score_caches:
                shard_cache = {name: pair for (s, name), pair
                               in score_caches.items() if s == sid}
            shard_results.append(self.shards[sid].searcher.query(
                body, size_hint=max(k, 1), score_cache=shard_cache))
        total = sum(r.total_hits for r in shard_results)
        max_score = None
        for r in shard_results:
            if r.max_score is not None:
                max_score = r.max_score if max_score is None else max(max_score, r.max_score)
        all_refs = [ref for r in shard_results for ref in r.refs]
        refs = merge_refs(all_refs, max(k, 0) or len(all_refs))
        refs_window = refs[from_: from_ + size] if size >= 0 else refs[from_:]

        aggregations = None
        agg_specs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        if agg_specs:
            views = [v for r in shard_results for v in r.agg_views]
            aggregations = run_aggregations(agg_specs, views)

        hits = fetch_hits(refs_window, self.shards, body, self.name)
        resp = {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": False,
            "_plane": "host",
            "_shards": {
                "total": len(shard_ids),
                "successful": len(shard_ids),
                "skipped": skipped,
                "failed": 0,
            },
            "hits": {
                "total": total,
                "max_score": max_score,
                "hits": hits,
            },
        }
        if aggregations is not None:
            resp["aggregations"] = aggregations
        return resp

    # ------------------------------------------------------------------
    # Cross-query micro-batching
    # ------------------------------------------------------------------

    def search_batch(self, bodies: List[dict]) -> list:
        """Execute Q concurrent search requests as one micro-batch.

        Returns one entry per member: the response dict, or the exception
        that member alone should raise. Rungs, as in the JAX package:
        1. mesh_pallas: one batched fused top-k launch per slot inside the
           mesh program (IndexMeshSearch.query_batch);
        2. host: one batched dense launch per segment feeds each member's
           per-query pipeline via score caches;
        3. members neither rung can share execute serially."""
        n = len(bodies)
        results: list = [None] * n
        live: List[int] = []
        for i, body in enumerate(bodies):
            if not batchable_body(body):
                results[i] = self._batch_member_single(body)
                continue
            live.append(i)
        if len(live) < 2:
            for i in live:
                results[i] = self._batch_member_single(bodies[i])
            return results
        live_bodies = [bodies[i] for i in live]
        mesh_out = None
        if self._mesh_enabled and len(self.shards) >= 2:
            mesh_out = self._mesh_plane().query_batch(live_bodies)
        if mesh_out is not None:
            for j, i in enumerate(live):
                try:
                    results[i] = self._mesh_response(
                        bodies[i], mesh_out[j], time.monotonic())
                except Exception as e:  # noqa: BLE001 — per-member fetch
                    results[i] = e  # isolation: raised in its own caller
            self.batch_stats.note_batch(len(live))
            return results
        caches, launches = self._host_batch_scores(live_bodies)
        # count only the members that shared a launch
        shared = sum(1 for c in caches if c)
        for j, i in enumerate(live):
            results[i] = self._batch_member_single(
                bodies[i], score_caches=caches[j] or None,
                skip_mesh=bool(caches[j]))
        if launches and shared:
            self.batch_stats.note_batch(shared)
        return results

    def _batch_member_single(self, body, score_caches=None, skip_mesh=False):
        """One member's serial execution inside a batch: an exception is
        that member's result (raised in its own caller), never its
        peers'."""
        try:
            return self._search_uncached(body, score_caches=score_caches,
                                         skip_mesh=skip_mesh)
        except Exception as e:  # noqa: BLE001 — per-member isolation
            return e

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
        """Which plane served the queries, the mesh plane's health, and
        the batcher's counters."""
        from elasticsearch_tpu_torch.parallel.plan_exec import PlaneHealth

        ms = self._mesh_search
        planes = {
            "mesh_query_total": ms.query_total if ms else 0,
            "mesh_pallas_query_total": ms.pallas_query_total if ms else 0,
            "mesh_batched_launch_total": ms.batched_launch_total if ms else 0,
            "mesh_restage_total": ms.restage_total if ms else 0,
            "host_query_total": self.host_query_total,
            "decisions": dict(ms.decisions) if ms else {},
            **(ms.plane_health.stats() if ms else PlaneHealth().stats()),
        }
        return {"planes": planes, "batch": self.batch_stats.as_dict()}


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
