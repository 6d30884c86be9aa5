"""Per-shard search execution + cross-shard merge + fetch.

Counterpart of ``elasticsearch_tpu/search/service.py``:

- ``ShardSearcher.query(source)`` runs the query phase on one shard: plan
  -> device execution per segment (or a score vector from a batched
  launch, ``score_cache``) -> copy of the dense scores and mask to the
  host (as the JAX host rung does) -> live, ``min_score``, ``slice``,
  [agg view], ``post_filter`` -> top-k selection by score or by the
  request's sort keys (``search_after`` cuts before it) -> the
  ``rescore`` window per segment; then the shard's merge, ``collapse``
  and ``terminate_after``. Returns a ``ShardQueryResult`` of doc refs.
  ``segments=`` searches a scroll's pinned views instead of the engine's
  current segment set.
- ``merge_refs`` is the coordinator's global top-k by score or by sort
  values; ``collapse_refs`` / ``expand_collapsed_hits`` are field
  collapsing; ``fetch_hits`` materializes hits (``_source`` filtering,
  version, each hit's ``sort`` array, ``highlight``).

Sort keys, the missing fills and the string sentinels, ``search_after``,
``resolve_slice``, rescore, collapse and the plain and unified
highlighters follow the JAX package line for line. A ``_geo_distance``
sort is a float64 haversine on the host (``_geo_distance_sort_values``,
the 6371008.7714 m radius), a doc without the field +inf in either
order. A sort on a numeric field under a nested path reduces each doc's
objects with min (asc) or max (desc) (``_nested_sort_values``). The
fetch phase answers the ``inner_hits`` of nested and join clauses
(``collect_inner_hits``, the builders parsed once a shard), nested ones
with ``_nested.field`` and ``offset``. ``stored_fields: "_none_"``
drops ``_source`` (any other value keeps it, as in the JAX package) and
``docvalue_fields`` answers numeric columns as float64 values and
ordinal columns as terms (with the ``.keyword`` fallback).

``emit_search_slowlog`` writes the one search slowlog line (took, scope,
plane, the request's X-Opaque-Id, the top phase spans, the source) at
``index.search.slowlog.threshold.query.{warn,info}``: each shard's
query phase on the host rung writes its own, the index writes the mesh
plane's. ``expired_queue_response`` is the answer of a search shed by
admission before it ran.

The query phase checkpoints the request's ``SearchDeadline`` before each
segment: an expired deadline stops the scan and the shard answers what
its finished segments found, ``timed_out``. ``profile`` adds a tree a
segment (the plan's node types, its ``engine``, and a breakdown of
``build_plan``, ``execute_program`` (to the scores on the host, so the
device work is in it) and ``select_topk``); a ``QueryTracer`` collects
the request's phase spans. ``stats`` counts the query against each named
group. ``allow_partial_results`` and ``shard_failure_entry`` serve the
coordinators' per-shard failure isolation. ``script_fields`` compile
once a request and evaluate once a hit on the host: a painless script
over the hit's typed doc values (keyword strings stay strings), a numeric
one over ``doc_values_for``, ``_score`` bound to the hit's score (0.0
under a sort). A ``suggest`` section is read by the index's
coordinator (``search/suggest.py``); the shard query phase ignores it.

Index-sort early termination: on an index with ``index.sort.*`` whose
query sort is a prefix of the index sort (``index/index_sort.
query_sort_matches_index_sort``, no ``search_after``), each segment's
doc order is its sort order, so the selection takes the first k matching
docs in doc order (their sort values still read for the merge); the
total stays exact and the shard reports ``terminated_early`` when more
than k docs matched.
"""

from __future__ import annotations

import bisect
import fnmatch
import logging
import math
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuException,
    IllegalArgumentException,
    ParsingException,
    QueryPhaseExecutionException,
    SearchPhaseExecutionException,
    es_type_name,
)
from elasticsearch_tpu_torch.index.index_sort import (
    query_sort_matches_index_sort,
)
from elasticsearch_tpu_torch.mapper.field_types import (
    GeoPointFieldType,
    TextFieldType,
)
from elasticsearch_tpu_torch.ops.scoring import select_topk
from elasticsearch_tpu_torch.script.expression import (
    compile_script,
    doc_values_for,
)
from elasticsearch_tpu_torch.script.painless import (
    DocMap,
    segment_doc_resolver,
)
from elasticsearch_tpu_torch.search import plan as P
from elasticsearch_tpu_torch.search.aggregations import (
    SegmentView,
    parse_aggs,
)
from elasticsearch_tpu_torch.search.query_dsl import (
    ShardQueryContext,
    collect_inner_hits,
    parse_distance,
    parse_query,
)
from elasticsearch_tpu_torch.search.telemetry import get_opaque_id
from elasticsearch_tpu_torch.utils.murmur3 import hash_slice_ids

# request-body keys the port serves; anything else raises
SUPPORTED_BODY_KEYS = {"query", "from", "size", "aggs", "aggregations",
                       "_source", "min_score", "post_filter", "version",
                       "sort", "search_after", "slice", "rescore",
                       "terminate_after", "collapse", "highlight",
                       "stored_fields", "docvalue_fields", "script_fields",
                       "track_total_hits", "timeout",
                       "allow_partial_search_results", "profile", "stats",
                       "suggest"}


def check_body(body: dict) -> None:
    unsupported = sorted(set(body) - SUPPORTED_BODY_KEYS)
    if unsupported:
        raise IllegalArgumentException(
            f"search request parameters {unsupported} are not supported by "
            f"the PyTorch port yet")


@dataclass
class DocRef:
    """A hit before fetch: which shard/segment/local doc + ranking keys.
    ``segment`` is the segment the query phase read, when it knows it: a
    background compaction may retire it from the engine before the fetch,
    and its host arrays still answer (a scroll's pinned view, for its
    pages)."""

    shard_id: int
    segment_name: str
    local_doc: int
    score: float
    segment: Any = None
    sort_values: Tuple = ()
    collapse_value: Any = None


@dataclass
class ShardQueryResult:
    shard_id: int
    total_hits: int
    refs: List[DocRef]
    max_score: Optional[float] = None
    agg_views: List[SegmentView] = field(default_factory=list)
    # per-segment profile trees when "profile": true
    profile: Optional[List[dict]] = None
    # set (true/false) only when terminate_after was requested
    terminated_early: Optional[bool] = None
    # the deadline expired mid-scan: refs and total cover only the
    # segments finished before the cut
    timed_out: bool = False


def _plan_uses_kernel(node) -> bool:
    if isinstance(node, P.PallasScoreTermsNode):
        return True
    return any(_plan_uses_kernel(c) for c in node.children())


def _mark_fused(tree: dict) -> None:
    """The child nodes of a plan carry structure only: the root's
    breakdown owns the measured time."""
    tree["time_in_nanos"] = 0
    tree["breakdown"] = {"fused_into_parent_program": 0}
    for child in tree.get("children", []):
        _mark_fused(child)


def _engine_name(used_kernel: bool, device) -> str:
    """The route that scored a segment, for the profile: the hand-written
    tile kernel on the card, its plain version on the CPU, or the scatter
    program."""
    if not used_kernel:
        return "torch_scatter"
    return ("cuda_tile_kernel" if device.type == "cuda"
            else "plain_tile_kernel")


_slow_logger = logging.getLogger(
    "elasticsearch_tpu_torch.index.search.slowlog")


def _request_opaque_id(tracer=None) -> Optional[str]:
    """The request's X-Opaque-Id: the tracer's annotation where it carries
    one (a batch member's, across the leader's thread), else the REST
    layer's contextvar."""
    if tracer is not None:
        oid = getattr(tracer, "_annotations", {}).get("opaque_id")
        if oid:
            return str(oid)
    return get_opaque_id()


def emit_search_slowlog(warn_s, info_s, took_s: float, scope: str,
                        scope_id, plane: str, tracer, source) -> None:
    """The one search slowlog line: a shard's host-rung line and an
    index's mesh-plane line differ only in their scope. Thresholds in
    seconds, None off; warn wins over info."""
    warn = warn_s is not None and took_s >= warn_s
    info = not warn and info_s is not None and took_s >= info_s
    if not (warn or info):
        return
    log = _slow_logger.warning if warn else _slow_logger.info
    log("took[%dms], %s[%s], plane[%s], id[%s], phases[%s], source[%s]",
        int(took_s * 1000), scope, scope_id, plane,
        _request_opaque_id(tracer) or "",
        tracer.top_phases() if tracer is not None else "",
        str(source)[:512])


def slowlog_threshold(value) -> Optional[float]:
    """A slowlog threshold in seconds; a negative one (or none) is off."""
    return value if value is not None and value >= 0 else None


def expired_queue_response(index_name: str, n_shards: int,
                           body: dict) -> dict:
    """The answer of a search whose deadline expired while it was queued
    for admission: shed before any staging or launch, it answers the
    timed-out partial result the first checkpoint would give (every
    shard successful, none ran), marked ``_degraded: ["expired_in_queue"]``;
    ``allow_partial_search_results: false`` raises instead."""
    if not allow_partial_results(body):
        raise SearchPhaseExecutionException(
            "query",
            "Partial shards failure (request timed out in the search "
            "admission queue)", [])
    return {
        "took": 0,
        "timed_out": True,
        "_plane": "none",
        "_degraded": ["expired_in_queue"],
        "_shards": {"total": n_shards, "successful": n_shards,
                    "skipped": 0, "failed": 0},
        "hits": {"total": 0, "max_score": None, "hits": []},
    }


class ShardSearcher:
    """Query-phase execution for one shard."""

    def __init__(self, shard_id: int, engine, mapper_service,
                 index_name: str = "", slowlog_warn_s=None,
                 slowlog_info_s=None):
        self.shard_id = shard_id
        self.index_name = index_name
        # the search slowlog's thresholds in seconds (None: off)
        self.slowlog_warn_s = slowlog_threshold(slowlog_warn_s)
        self.slowlog_info_s = slowlog_threshold(slowlog_info_s)
        self.engine = engine
        self.mapper_service = mapper_service
        self.ctx = ShardQueryContext(mapper_service, engine)
        # slice resolution is shard-count aware (the owner sets both)
        self.num_shards = 1
        self.max_slices = 1024
        self.query_total = 0
        # which engine scored each segment: the tile kernel or the scatter
        self.kernel_segments_total = 0
        self.scatter_segments_total = 0
        # the dense [nd1] scores + mask copy to the host, per segment
        # (after the device finished the plan); the mesh plane keeps its
        # top-k on the device instead
        self.host_copy_seconds = 0.0
        self.host_copy_bytes = 0
        self.host_copy_segments = 0
        # the counters take concurrent searches (host threads and the mesh
        # and batch leaders all attribute per-shard stats here)
        self._stats_lock = threading.Lock()
        # per-group search stats ("stats": ["grp"] in a request body)
        self.group_stats: Dict[str, dict] = {}

    def record_query_groups(self, groups) -> None:
        """Count one query against each requested stats group (the host
        rung and the mesh plane both call it)."""
        with self._stats_lock:
            for g in groups or []:
                gs = self.group_stats.setdefault(str(g), {
                    "query_total": 0, "query_time_in_millis": 0,
                    "fetch_total": 0, "fetch_time_in_millis": 0})
                gs["query_total"] += 1

    def note_query(self, groups=None) -> None:
        """Attribute one query the mesh plane served to this shard: the
        mesh runs every shard as one program, and the per-shard stats stay
        true."""
        with self._stats_lock:
            self.query_total += 1
        self.record_query_groups(groups)

    def query(self, source: dict, size_hint: Optional[int] = None,
              segments=None, score_cache: Optional[Dict[str, Tuple]] = None,
              deadline=None, tracer=None) -> ShardQueryResult:
        """segments: an explicit segment list (a scroll's pinned views);
        None searches the engine's current segments.
        score_cache: {segment_name: (scores [nd1] f32, matched [nd1]
        bool)} on the segment's device, from a cross-query batched kernel
        launch (search/batching.py): a cached segment skips plan execution
        and feeds the same downstream pipeline (a profiled request runs its
        own plans, so its tree times them).
        deadline: the request's ``SearchDeadline``, checkpointed before
        each segment: an expired one stops the scan and the result holds
        the finished segments with ``timed_out``.
        tracer: the request's ``QueryTracer`` (phase spans)."""
        from elasticsearch_tpu_torch.search.cancellation import (
            TimeExceededException,
        )
        from elasticsearch_tpu_torch.search.telemetry import NULL_TRACER
        from elasticsearch_tpu_torch.testing.disruption import (
            on_shard_search,
        )

        if tracer is None:
            tracer = NULL_TRACER
        t_query = time.monotonic()
        with self._stats_lock:
            self.query_total += 1
        # query-path fault injection (SearchDelayScheme, SearchFailScheme)
        on_shard_search(self.index_name, self.shard_id)
        source = source or {}
        check_body(source)
        self.record_query_groups(source.get("stats"))
        t_parse = tracer.start("parse_rewrite")
        from_ = int(source.get("from", 0) or 0)
        size = int(source.get("size", 10) if source.get("size") is not None else 10)
        k = size_hint if size_hint is not None else from_ + size
        k = max(k, 1)
        qb = parse_query(source.get("query"))
        post_qb = parse_query(source["post_filter"]) if source.get("post_filter") else None
        min_score = source.get("min_score")
        sort_spec = normalize_sort(source.get("sort"))
        search_after = source.get("search_after")
        # shard-level collapse: every group's shard-best must reach the
        # coordinator, so selection is uncapped and collapsed to k groups
        collapse_field = validate_collapse(source)
        slice_spec = source.get("slice")
        rescore_specs = _normalize_rescore(source.get("rescore"))
        k_select = k
        if rescore_specs:
            k_select = max(k, max(r["window_size"] for r in rescore_specs))
        agg_specs = parse_aggs(source.get("aggs") or source.get("aggregations"))
        profile = bool(source.get("profile", False))
        # index-sort early termination: doc order is sort order in every
        # segment of a sorted index
        index_sorted = (search_after is None
                        and query_sort_matches_index_sort(
                            sort_spec, getattr(self.engine, "index_sort",
                                               None),
                            mapper_service=self.mapper_service))
        tracer.stop("parse_rewrite", t_parse)

        refs: List[DocRef] = []
        total = 0
        max_score = None
        agg_views: List[SegmentView] = []
        profile_shards: List[dict] = []
        timed_out = False
        for seg in (segments if segments is not None
                    else self.engine.searchable_segments()):
            if deadline is not None:
                try:
                    deadline.checkpoint()
                except TimeExceededException:
                    # the finished segments stand; the scan stops here
                    timed_out = True
                    break
            t_seg = time.monotonic()
            t_stage = tracer.start("staging")
            dev = seg.device_arrays()
            tracer.stop("staging", t_stage)
            cached = (score_cache.get(seg.name)
                      if score_cache and not profile else None)
            t_kernel = None
            if cached is not None:
                # scored by a batched launch shared with the other members
                # of this query's micro-batch
                scores_d, matched_d = cached
                with self._stats_lock:
                    self.kernel_segments_total += 1
                t_build = time.monotonic()
            else:
                t_plan = tracer.start("plan_build")
                node = qb.to_plan(self.ctx, seg)
                tracer.stop("plan_build", t_plan)
                used_kernel = _plan_uses_kernel(node)
                with self._stats_lock:
                    if used_kernel:
                        self.kernel_segments_total += 1
                    else:
                        self.scatter_segments_total += 1
                t_build = time.monotonic()
                t_kernel = tracer.start("kernel")
                scores_d, matched_d = P.execute(dev, node)
            # the copy waits for the device: the kernel span and
            # execute_program end with the scores on the host
            scores, matched = self._to_host(seg.device, scores_d, matched_d)
            if t_kernel is not None:
                tracer.stop("kernel", t_kernel)
            t_exec = time.monotonic()
            live1 = np.concatenate([seg.live, np.zeros(1, bool)])
            matched = matched & live1
            if min_score is not None:
                matched = matched & (scores >= float(min_score))
            if slice_spec is not None:
                resolved = resolve_slice(
                    dict(slice_spec, _limit=self.max_slices),
                    self.shard_id, self.num_shards)
                if resolved == "skip":
                    matched = np.zeros_like(matched)
                elif resolved is not None:
                    matched = matched & slice_mask(
                        seg, int(resolved["id"]), int(resolved["max"]))
            if agg_specs:
                agg_views.append(SegmentView(seg, matched.copy(), self.ctx,
                                             scores))
            if post_qb is not None:
                _, post_m = P.execute(dev, post_qb.to_plan(self.ctx, seg))
                matched = matched & post_m.cpu().numpy()
            total += int(matched[: seg.num_docs].sum())
            t_merge = tracer.start("merge")
            if collapse_field:
                seg_refs = self._select_all(seg, scores, matched, sort_spec)
            else:
                seg_refs = self._select(seg, scores, matched, sort_spec,
                                        search_after, k_select,
                                        index_sorted=index_sorted)
            if rescore_specs and sort_spec is None:
                seg_refs = self._rescore(seg, dev, seg_refs, rescore_specs)
            tracer.stop("merge", t_merge)
            refs.extend(seg_refs)
            if seg_refs and sort_spec is None:
                m = max(r.score for r in seg_refs)
                max_score = m if max_score is None else max(max_score, m)
            if profile:
                profile_shards.append(self._profile_entry(
                    seg, node, used_kernel, source, t_seg, t_build, t_exec))
        t_merge = tracer.start("merge")
        if collapse_field:
            refs = merge_refs(refs, sort_spec, len(refs))
            refs = collapse_refs(refs, collapse_field)[:k]
        else:
            refs = merge_refs(refs, sort_spec,
                              k_select if rescore_specs else k)
        tracer.stop("merge", t_merge)
        if rescore_specs and sort_spec is None:
            refs.sort(key=lambda r: (-r.score, r.local_doc))
            refs = refs[:k]
            if refs:
                max_score = refs[0].score
        terminate_after = source.get("terminate_after")
        terminated_early = None
        if terminate_after:
            # the scan is exhaustive: cap the reported total and say
            # whether the cap was reached (the observable contract)
            terminated_early = total >= int(terminate_after)
            total = min(total, int(terminate_after))
        elif index_sorted and total > k:
            # the first k docs of each segment were taken in doc order;
            # the total is still exact
            terminated_early = True
        emit_search_slowlog(self.slowlog_warn_s, self.slowlog_info_s,
                            time.monotonic() - t_query, "shard",
                            self.shard_id, "host", tracer, source)
        return ShardQueryResult(
            self.shard_id, total, refs, max_score, agg_views,
            profile=profile_shards if profile else None,
            terminated_early=terminated_early, timed_out=timed_out)

    def _profile_entry(self, seg, node, used_kernel: bool, source: dict,
                       t_seg: float, t_build: float, t_exec: float) -> dict:
        """One segment's profile: the plan tree (children fused into the
        root), which engine scored it, and the root's breakdown."""
        t_end = time.monotonic()
        tree = node.describe()
        for child in tree.get("children", []):
            _mark_fused(child)
        tree.update({
            "engine": _engine_name(used_kernel, seg.device),
            "description": str(source.get("query", {"match_all": {}})),
            "time_in_nanos": int((t_exec - t_build) * 1e9),
            "breakdown": {
                "build_plan": int((t_build - t_seg) * 1e9),
                "execute_program": int((t_exec - t_build) * 1e9),
                "select_topk": int((t_end - t_exec) * 1e9),
            },
        })
        return {
            "id": f"[{self.shard_id}][{seg.name}]",
            "plane": "host",
            "searches": [{
                "query": [tree],
                "collector": [{
                    "name": "TopKSelector",
                    "reason": "search_top_hits",
                    "time_in_nanos": int((t_end - t_exec) * 1e9),
                }],
            }],
        }

    def _to_host(self, device, scores_d, matched_d):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        scores = scores_d.cpu().numpy()
        matched = matched_d.cpu().numpy()
        self.host_copy_seconds += time.perf_counter() - t0
        self.host_copy_bytes += scores.nbytes + matched.nbytes
        self.host_copy_segments += 1
        return scores, matched

    def _rescore(self, seg, dev, seg_refs: List[DocRef],
                 rescore_specs: List[dict]) -> List[DocRef]:
        """QueryRescorer: re-rank the top-window hits by combining the
        original score with the rescore query's score. The window applies
        per segment, as on the JAX host rung."""
        for spec in rescore_specs:
            window = spec["window_size"]
            rqb = parse_query(spec["rescore_query"])
            r_scores = P.execute(dev, rqb.to_plan(self.ctx, seg))[0]
            r_scores = r_scores.cpu().numpy()
            qw, rqw = spec["query_weight"], spec["rescore_query_weight"]
            mode = spec["score_mode"]
            for ref in seg_refs[:window]:
                rs = float(r_scores[ref.local_doc])
                base = ref.score * qw
                resc = rs * rqw
                if mode == "total":
                    ref.score = base + resc
                elif mode == "multiply":
                    ref.score = base * rs if rs else base
                elif mode == "avg":
                    ref.score = (base + resc) / 2.0
                elif mode == "max":
                    ref.score = max(base, resc)
                elif mode == "min":
                    ref.score = min(base, resc)
                ref.sort_values = (ref.score,)
        seg_refs.sort(key=lambda r: (-r.score, r.local_doc))
        return seg_refs

    def _select_all(self, seg, scores, matched, sort_spec) -> List[DocRef]:
        """Uncapped selection of every matching doc, ordered by the
        request's sort: collapse needs the full candidate set so no
        group's best doc is cut by a top-k window (search_after is
        refused with collapse upstream)."""
        live_matched = matched[: seg.nd_pad] & seg.live
        idx = np.flatnonzero(live_matched)
        if sort_spec is None:
            out = [DocRef(self.shard_id, seg.name, int(d), float(scores[d]),
                          seg, (float(scores[d]),)) for d in idx]
            out.sort(key=lambda r: (-r.score, r.local_doc))
            return out
        _keys, all_key_arrays = self._sort_keys(seg, scores, sort_spec)
        out = [DocRef(self.shard_id, seg.name, int(d), float(scores[d]), seg,
                      tuple(arr[d] for arr in all_key_arrays)) for d in idx]
        sort_refs(out, sort_spec)
        return out

    def _select(self, seg, scores, matched, sort_spec, search_after,
                k, index_sorted: bool = False) -> List[DocRef]:
        if index_sorted and sort_spec is not None:
            # doc order is sort order: the first k matching docs, their
            # sort values read for the cross-segment merge
            idx = np.flatnonzero(matched[: seg.nd_pad] & seg.live)[:k]
            _, all_key_arrays = self._sort_keys(seg, scores, sort_spec)
            return [DocRef(self.shard_id, seg.name, int(d), float(scores[d]),
                           seg, tuple(arr[d] for arr in all_key_arrays))
                    for d in idx]
        if sort_spec is None:
            # relevance: top-k by score on the host copy, ties by
            # ascending doc id
            if search_after is not None:
                cutoff = float(search_after[0])
                matched = matched & (scores < cutoff)
            top_scores, top_docs = select_topk(
                torch.from_numpy(scores), torch.from_numpy(matched),
                torch.ones(matched.shape, dtype=torch.bool), int(k))
            out = []
            for sc, d in zip(top_scores.tolist(), top_docs.tolist()):
                if sc == -np.inf:
                    break
                out.append(DocRef(self.shard_id, seg.name, int(d), float(sc),
                                  seg, (float(sc),)))
            return out
        # field sort: the primary key selects, the full sort tuple orders
        keys, all_key_arrays = self._sort_keys(seg, scores, sort_spec)
        primary = keys[0]
        if search_after is not None:
            matched = matched & _search_after_mask(all_key_arrays, sort_spec,
                                                   search_after)
        masked = np.where(matched[: seg.nd_pad] & seg.live, primary, -np.inf)
        kk = min(k, masked.size)
        idx = (np.argpartition(-masked, kk - 1)[:kk] if kk < masked.size
               else np.arange(masked.size))
        out = []
        for d in idx:
            d = int(d)
            if masked[d] == -np.inf:
                continue
            sv = tuple(arr[d] for arr in all_key_arrays)
            out.append(DocRef(self.shard_id, seg.name, d, float(scores[d]),
                              seg, sv))
        sort_refs(out, sort_spec)
        return out[:k]

    def _sort_keys(self, seg, scores, sort_spec):
        """(oriented key arrays [nd_pad], raw per-field value arrays for
        each hit's sort values)."""
        raw_arrays = []
        oriented = []
        for field_name, order, missing in sort_spec:
            if field_name == "_score":
                raw = scores[: seg.nd_pad].astype(np.float64)
            elif field_name == "_doc":
                raw = np.arange(seg.nd_pad, dtype=np.float64)
            elif field_name == "_geo_distance":
                raw = _geo_distance_sort_values(seg, missing)
            else:
                col = seg.numeric_columns.get(field_name)
                nested_raw = (None if col is not None else
                              _nested_sort_values(seg, field_name, order,
                                                  missing))
                if col is not None:
                    base = col.min_value if order == "asc" else col.max_value
                    fill = _missing_fill(missing, order)
                    raw = np.where(col.exists, base, fill)
                elif nested_raw is not None:
                    raw = nested_raw
                else:
                    ocol = (seg.ordinal_columns.get(field_name)
                            or seg.ordinal_columns.get(f"{field_name}.keyword"))
                    ft = self.mapper_service.field_type(field_name)
                    string_typed = (ocol is not None or (
                        ft is not None
                        and getattr(ft, "ordinal_doc_values", False)))
                    if not string_typed:
                        # numeric or unmapped: a float fill (a custom
                        # missing must be a number here)
                        fill = _missing_fill(missing, order)
                        raw = np.full(seg.nd_pad, fill, dtype=np.float64)
                    elif ocol is None:
                        # a keyword field with no column in this segment:
                        # every doc is missing, and the values stay
                        # strings so the merge never mixes floats into a
                        # string sort
                        sfill = _missing_fill_str(missing, order)
                        raw = np.full(seg.nd_pad, sfill, dtype=object)
                        fillf = (np.inf if sfill == _STR_SENTINEL_HIGH
                                 else -np.inf)
                        key = fillf if order == "desc" else -fillf
                        oriented.append(np.full(
                            seg.nd_pad, float(np.clip(key, -1e300, 1e300))))
                        raw_arrays.append(raw)
                        continue
                    else:
                        # ordinals order the selection inside the segment
                        # (local ordinal order is string order), but the
                        # merge across segments compares the strings. A
                        # custom string missing ranks at its bisect
                        # position between ordinals.
                        if missing in (None, "_last", "_first"):
                            fill = _missing_fill(missing, order)
                        else:
                            pos = bisect.bisect_left(ocol.terms, str(missing))
                            fill = pos - 0.5
                        ord_key = np.where(
                            ocol.exists, ocol.first_ord.astype(np.float64),
                            fill)
                        sfill = _missing_fill_str(missing, order)
                        cache_key = (f"sortstr.{field_name}.{order}."
                                     f"{missing!r}")
                        raw = seg.host_cache.get(cache_key)
                        if raw is None:
                            terms_arr = np.asarray(ocol.terms + [sfill],
                                                   dtype=object)
                            raw = terms_arr[np.where(
                                ocol.exists, ocol.first_ord,
                                len(ocol.terms))]
                            seg.host_cache[cache_key] = raw
                        raw_arrays.append(raw)
                        oriented.append(np.clip(
                            ord_key if order == "desc" else -ord_key,
                            -1e300, 1e300))
                        continue
            raw_arrays.append(raw)
            # clamp the +-inf missing fills to large finite sentinels: -inf
            # in the oriented key is reserved for "not matched", and a
            # missing doc in an asc sort must still be selectable
            oriented.append(np.clip(raw if order == "desc" else -raw,
                                    -1e300, 1e300))
        return oriented, raw_arrays


def _geo_distance_sort_values(seg, spec: dict) -> np.ndarray:
    """Each doc's arc distance to the reference point(s) in ``unit_m``
    units: float64 haversine with the 6371008.7714 m radius, each stored
    point's least distance over the reference points, reduced over a
    doc's points by ``mode`` (min, max, sum, avg); a doc without the
    field +inf."""
    col = seg.geo_columns.get(spec["field"])
    mode = spec.get("mode", "min")
    out = np.full(seg.nd_pad, np.inf, dtype=np.float64)
    if col is not None:
        n = col.count
        lat = np.radians(col.lat[:n].astype(np.float64))
        lon = np.radians(col.lon[:n].astype(np.float64))
        per_val = np.full(n, np.inf, dtype=np.float64)
        for plat, plon in spec["points"]:
            plat_r, plon_r = np.radians(plat), np.radians(plon)
            a = (np.sin((lat - plat_r) / 2.0) ** 2
                 + np.cos(lat) * np.cos(plat_r)
                 * np.sin((lon - plon_r) / 2.0) ** 2)
            d = 2.0 * 6371008.7714 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
            per_val = np.minimum(per_val, d)
        docs = col.flat_docs[:n]
        if mode == "min":
            np.minimum.at(out, docs, per_val)
        elif mode == "max":
            neg = np.full(seg.nd_pad, -np.inf, dtype=np.float64)
            np.maximum.at(neg, docs, per_val)
            out = np.where(np.isfinite(neg), neg, np.inf)
        else:  # sum, avg
            tot = np.zeros(seg.nd_pad, dtype=np.float64)
            cnt = np.zeros(seg.nd_pad, dtype=np.float64)
            np.add.at(tot, docs, per_val)
            np.add.at(cnt, docs, 1.0)
            vals = tot / np.maximum(cnt, 1.0) if mode == "avg" else tot
            out = np.where(cnt > 0, vals, np.inf)
    return out / float(spec["unit_m"])


def _nested_sort_values(seg, field_name: str, order: str, missing):
    """The sort key of a numeric field under a nested path: each doc's
    objects' values reduced with min (asc) or max (desc), the default
    mode; the path is the field's prefix (``nested_path`` and ``nested``
    are accepted and implied). None when the field is not under a nested
    path of the segment."""
    for path, nctx in seg.nested.items():
        if not field_name.startswith(path + "."):
            continue
        ncol = nctx.segment.numeric_columns.get(field_name)
        if ncol is None:
            return None
        n = nctx.parent_of.shape[0]
        fill = _missing_fill(missing, order)
        vals = (ncol.min_value if order == "asc" else ncol.max_value)[:n]
        sel = ncol.exists[:n] & nctx.segment.live[:n]
        out = np.full(seg.nd_pad, np.inf if order == "asc" else -np.inf,
                      dtype=np.float64)
        if order == "asc":
            np.minimum.at(out, nctx.parent_of[sel], vals[sel])
        else:
            np.maximum.at(out, nctx.parent_of[sel], vals[sel])
        has = np.zeros(seg.nd_pad, dtype=bool)
        has[nctx.parent_of[sel]] = True
        return np.where(has, out, fill)
    return None


def slice_mask(seg, sid: int, smax: int) -> np.ndarray:
    """Docs of ``seg`` in slice ``sid`` of ``smax``: ``hash_slice_id(_id)
    % smax == sid`` (floorMod), ``[nd_pad + 1]`` bool, cached on the
    segment's host with the ids' hashes (the mesh plane's slice column
    reads the same cache)."""
    key = f"slice.{smax}.{sid}"
    mask = seg.host_cache.get(key)
    if mask is None:
        hashes = seg.host_cache.get("slice.hash")
        if hashes is None:
            hashes = seg.host_cache["slice.hash"] = hash_slice_ids(
                seg.doc_ids)
        mask = np.zeros(seg.nd_pad + 1, dtype=bool)
        mask[: len(hashes)] = hashes % smax == sid
        seg.host_cache[key] = mask
    return mask


def _sort_value_out(v):
    """Sort value -> response form: the missing fills (infinite floats,
    the string sentinels) render as null."""
    if isinstance(v, str):
        return None if v in (_STR_SENTINEL_HIGH, _STR_SENTINEL_LOW) else v
    return v if not np.isinf(v) else None


def _missing_fill(missing, order) -> float:
    if missing in (None, "_last"):
        return -np.inf if order == "desc" else np.inf
    if missing == "_first":
        return np.inf if order == "desc" else -np.inf
    return float(missing)


# string-sort missing sentinels: HIGH sorts after every practical term,
# LOW (a NUL) before; both render as null in the sort values
_STR_SENTINEL_HIGH = "\U0010ffff\U0010ffff\U0010ffff\U0010ffff"
_STR_SENTINEL_LOW = "\x00"


def _missing_fill_str(missing, order) -> str:
    if missing in (None, "_last"):
        # "_last" is the end of the result order: largest for asc,
        # smallest for desc
        return _STR_SENTINEL_HIGH if order == "asc" else _STR_SENTINEL_LOW
    if missing == "_first":
        return _STR_SENTINEL_LOW if order == "asc" else _STR_SENTINEL_HIGH
    return str(missing)


def multi_pass_sort(items, sort_spec, values_of, tiebreak=None):
    """Stable multi-pass sort over per-field sort values: strings cannot
    be negated for desc and per-segment ordinals are no merge keys, so
    the list is sorted once a field, least significant first, relying on
    stability. A tiebreak key, when given, runs first. Mixed value types
    within one field (string against number) are a request error."""
    if tiebreak is not None:
        items.sort(key=tiebreak)
    try:
        for i in reversed(range(len(sort_spec))):
            _f, order, _m = sort_spec[i]
            items.sort(key=lambda x, i=i: values_of(x)[i],
                       reverse=order == "desc")
    except TypeError:
        raise IllegalArgumentException(
            "can't sort across indices mapping the sort field to "
            "different types (string vs numeric)") from None


def sort_refs(refs: List[DocRef], sort_spec, with_shard: bool = False) -> None:
    multi_pass_sort(
        refs, sort_spec, lambda r: r.sort_values,
        tiebreak=(lambda r: (r.shard_id, r.local_doc)) if with_shard
        else (lambda r: r.local_doc))


def _search_after_mask(key_arrays, sort_spec, after_values) -> np.ndarray:
    """Strict lexicographic 'after' filter over full sort tuples."""
    n = key_arrays[0].shape[0]
    gt = np.zeros(n, dtype=bool)
    eq = np.ones(n, dtype=bool)
    for arr, (_fname, order, missing), after in zip(key_arrays, sort_spec,
                                                    after_values):
        # a null cursor value is a missing doc's sort key (fetch renders
        # the fill as null): map it back to the fill
        if arr.dtype == object:  # keyword sort: string comparisons
            a = (_missing_fill_str(missing, order) if after is None
                 else str(after))
        elif isinstance(missing, dict):
            # _geo_distance: the missing slot carries the geo spec, and a
            # doc without a point fills +inf in either order
            a = np.inf if after is None else float(after)
        else:
            a = (_missing_fill(missing, order)
                 if after is None else float(after))
        if order == "desc":
            gt |= eq & (arr < a)
        else:
            gt |= eq & (arr > a)
        eq &= arr == a
    return np.concatenate([gt, np.zeros(1, dtype=bool)])


def resolve_slice(spec: dict, shard_id: int, num_shards: int):
    """SliceBuilder.toFilter's shard-aware slice resolution. Returns
    "skip" (this shard is not in the slice), None (the whole shard is)
    or {"id", "max"} (a doc-hash partition inside the shard). Regimes: one
    shard, a plain doc hash; max >= shards, shards round-robin over the
    slices with a partition inside; max < shards, whole shards grouped a
    slice."""
    sid, smax = int(spec["id"]), int(spec["max"])
    if smax <= 1:
        raise IllegalArgumentException("max must be greater than 1")
    if sid < 0 or sid >= smax:
        raise IllegalArgumentException(
            f"id must be in [0, {smax}), got {sid}")
    limit = int(spec.get("_limit", 1024))
    if smax > limit:
        raise QueryPhaseExecutionException(
            f"The number of slices [{smax}] is too large. It must be "
            f"less than [{limit}]. This limit can be set by changing "
            f"the [index.max_slices_per_scroll] index level setting.")
    if num_shards == 1:
        return {"id": sid, "max": smax}
    if smax >= num_shards:
        target = sid % num_shards
        if target != shard_id:
            return "skip"
        n_in_shard = smax // num_shards + (
            1 if smax % num_shards > target else 0)
        if n_in_shard == 1:
            return None
        return {"id": sid // num_shards, "max": n_in_shard}
    return None if shard_id % smax == sid else "skip"


def _normalize_rescore(body) -> List[dict]:
    """rescore body -> [{window_size, rescore_query, weights, mode}]."""
    if body is None:
        return []
    specs = body if isinstance(body, list) else [body]
    out = []
    for spec in specs:
        q = spec.get("query") or {}
        out.append({
            "window_size": int(spec.get("window_size", 10)),
            "rescore_query": q.get("rescore_query"),
            "query_weight": float(q.get("query_weight", 1.0)),
            "rescore_query_weight": float(q.get("rescore_query_weight", 1.0)),
            "score_mode": q.get("score_mode", "total"),
        })
    return out


def collapse_refs(refs: List[DocRef], field_name: str) -> List[DocRef]:
    """Field collapsing: keep the best hit a distinct field value (a doc's
    first numeric value, else its first keyword term, else the null
    group), in result order."""
    seen = set()
    out = []
    for ref in refs:
        seg, d = ref.segment, ref.local_doc
        value = None
        col = seg.numeric_columns.get(field_name)
        ocol = (seg.ordinal_columns.get(field_name)
                or seg.ordinal_columns.get(f"{field_name}.keyword"))
        if col is not None and col.exists[d]:
            value = float(col.first_value[d])
        elif ocol is not None and ocol.exists[d]:
            value = ocol.terms[ocol.first_ord[d]]
        if value in seen:
            continue
        seen.add(value)
        ref.collapse_value = value
        out.append(ref)
    return out


def expand_collapsed_hits(hits: List[dict], refs: List[DocRef],
                          collapse_body: dict, body: dict, search_fn) -> None:
    """ExpandSearchPhase: put the collapse value in each hit's fields and,
    when the collapse declares ``inner_hits``, run one group search (the
    original query AND the group's value) a top hit a spec through
    ``search_fn(sub_body) -> response``."""
    field_name = collapse_body["field"]
    specs = collapse_body.get("inner_hits")
    if isinstance(specs, dict):
        specs = [specs]
    if specs:
        names = [spec.get("name", field_name) for spec in specs]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise IllegalArgumentException(
                f"[inner_hits] already contains an entry for key "
                f"[{dupes.pop()}]")
    orig_query = body.get("query") or {"match_all": {}}
    for hit, ref in zip(hits, refs):
        value = ref.collapse_value
        hit.setdefault("fields", {})[field_name] = [value]
        if not specs:
            continue
        if value is None:
            group_filter = {"bool": {"must_not": [
                {"exists": {"field": field_name}}]}}
        else:
            group_filter = {"term": {field_name: value}}
        for spec in specs:
            name = spec.get("name", field_name)
            sub = {
                "query": {"bool": {"must": [orig_query],
                                   "filter": [group_filter]}},
                "from": int(spec.get("from", 0)),
                # InnerHitBuilder's default size
                "size": int(spec.get("size", 3)),
            }
            for key in ("sort", "_source", "docvalue_fields", "script_fields",
                        "stored_fields", "version", "highlight"):
                if key in spec:
                    sub[key] = spec[key]
            hit.setdefault("inner_hits", {})[name] = {
                "hits": search_fn(sub)["hits"]}


def validate_collapse(body: dict) -> Optional[str]:
    """Body-shape validation for collapse before any shard runs. Returns
    the collapse field or None."""
    collapse_field = (body.get("collapse") or {}).get("field")
    if collapse_field and body.get("search_after") is not None:
        raise IllegalArgumentException(
            "cannot use `collapse` in conjunction with `search_after`")
    if collapse_field and body.get("rescore"):
        raise IllegalArgumentException(
            "cannot use `collapse` in conjunction with `rescore`")
    return collapse_field


def normalize_sort(sort_body) -> Optional[List[Tuple[str, str, Any]]]:
    """-> [(field, order, missing)], or None for relevance (a lone
    ``_score`` sort included). A ``_geo_distance`` entry carries its spec
    (field, points, ``unit_m``, mode) in the missing slot. A nested sort's
    ``nested_path`` / ``nested`` are implied by the field's path."""
    if sort_body is None:
        return None
    if not isinstance(sort_body, list):
        sort_body = [sort_body]
    out = []
    for entry in sort_body:
        if isinstance(entry, str):
            if entry == "_score":
                out.append(("_score", "desc", None))
            else:
                out.append((entry, "asc", None))
        elif isinstance(entry, dict):
            ((fname, spec),) = entry.items()
            if fname == "_geo_distance":
                out.append(("_geo_distance",) + _geo_sort_spec(spec))
                continue
            if isinstance(spec, str):
                out.append((fname, spec, None))
            else:
                out.append((
                    fname,
                    spec.get("order", "desc" if fname == "_score" else "asc"),
                    spec.get("missing"),
                ))
        else:
            raise ParsingException(f"malformed sort entry {entry!r}")
    if len(out) == 1 and out[0][0] == "_score":
        return None  # plain relevance
    return out


def _geo_sort_spec(spec: dict) -> tuple:
    """A ``_geo_distance`` sort entry -> (order, geo spec): ``order``,
    ``unit``, ``mode`` (min for asc, max for desc by default; sum and avg
    too), one or several points; the distance type, validation and nested
    keys are accepted and ignored."""
    params = dict(spec)
    order = params.pop("order", "asc")
    unit = params.pop("unit", "m")
    mode = params.pop("mode", "min" if order == "asc" else "max")
    if mode not in ("min", "max", "sum", "avg"):
        raise ParsingException(
            f"Unsupported sort mode [{mode}] for [_geo_distance]")
    for k in ("distance_type", "validation_method", "ignore_unmapped",
              "nested_path", "nested"):
        params.pop(k, None)
    if len(params) != 1:
        raise ParsingException(
            "[_geo_distance] sort requires exactly one field")
    ((gfield, pts),) = params.items()
    if not isinstance(pts, list) or (
            pts and isinstance(pts[0], (int, float))):
        pts = [pts]
    return order, {"field": gfield,
                   "points": [GeoPointFieldType.parse_point(p) for p in pts],
                   "unit_m": parse_distance(f"1{unit}"), "mode": mode}


def allow_partial_results(body: dict) -> bool:
    """The request's ``allow_partial_search_results``. ``Node.search``
    sets the node default (``search.default_allow_partial_results``) when
    the request leaves it unset; a direct caller defaults to true."""
    v = (body or {}).get("allow_partial_search_results")
    if v is None:
        return True
    if isinstance(v, str):
        return v.lower() != "false"
    return bool(v)


def shard_failure_entry(index: str, shard_id, exc: Exception,
                        node: Optional[str] = None) -> dict:
    """One ``_shards.failures`` entry (ShardSearchFailure's shape): the
    shard's exception with its type and reason, so a partial response
    says which shard failed and why."""
    if isinstance(exc, ElasticsearchTpuException):
        reason = {"type": exc.error_type, "reason": exc.reason}
    else:
        reason = {"type": es_type_name(type(exc).__name__),
                  "reason": str(exc)}
    entry = {"shard": shard_id, "index": index, "reason": reason}
    if node is not None:
        entry["node"] = node
    return entry


def merge_refs(refs: List[DocRef], sort_spec, k: int) -> List[DocRef]:
    """Coordinator-side top-k merge (SearchPhaseController.sortDocs): by
    score, or by sort values; ties by (shard, doc)."""
    if sort_spec is None:
        refs.sort(key=lambda r: (-r.score, r.shard_id, r.local_doc))
    else:
        sort_refs(refs, sort_spec, with_shard=True)
    return refs[:k]


# ---------------------------------------------------------------------------
# Fetch phase
# ---------------------------------------------------------------------------


def filter_source(source: dict, includes: List[str], excludes: List[str]) -> dict:
    """_source filtering (FetchSourceSubPhase semantics): a pattern
    matching a path or any of its ancestors covers the subtree."""

    def ancestor_match(path: str, patterns: List[str]) -> bool:
        parts = path.split(".")
        for i in range(1, len(parts) + 1):
            prefix = ".".join(parts[:i])
            if any(fnmatch.fnmatchcase(prefix, p) for p in patterns):
                return True
        return False

    def walk(obj: dict, prefix: str) -> dict:
        out = {}
        for key, value in obj.items():
            path = f"{prefix}{key}"
            if excludes and ancestor_match(path, excludes):
                continue
            if isinstance(value, dict):
                child = walk(value, path + ".")
                if child:
                    out[key] = child
            elif isinstance(value, list) and value and all(
                isinstance(x, dict) for x in value
            ):
                items = [walk(x, path + ".") for x in value]
                items = [x for x in items if x]
                if items:
                    out[key] = items
            else:
                if includes and not ancestor_match(path, includes):
                    continue
                out[key] = value
        return out

    return walk(source, "")


def _parse_source_spec(spec):
    """-> (includes, excludes, enabled)."""
    if spec is True or spec is None:
        return [], [], True
    if spec is False:
        return [], [], False
    if isinstance(spec, str):
        return [spec], [], True
    if isinstance(spec, list):
        return list(spec), [], True
    if isinstance(spec, dict):
        return (
            list(spec.get("includes") or spec.get("include") or []),
            list(spec.get("excludes") or spec.get("exclude") or []),
            True,
        )
    raise ParsingException(f"unsupported _source spec {spec!r}")


_HL_PRE = "<em>"
_HL_POST = "</em>"
_SENTENCE_BREAK = re.compile(r"(?<=[.!?])\s+|\n+")


def highlight_fields(source: dict, mapper_service, query_terms: Dict[str, set],
                     highlight_body: dict) -> Dict[str, List[str]]:
    """The highlight sub-phase, one highlighter a field by ``type``:
    "unified" (the default) scores sentence passages by unique-term
    coverage with log tf saturation, takes the top passages and wraps
    their matches; "plain" cuts token-window fragments around matches."""
    out = {}
    fields_spec = highlight_body.get("fields", {})
    pre = (highlight_body.get("pre_tags") or [_HL_PRE])[0]
    post = (highlight_body.get("post_tags") or [_HL_POST])[0]
    require_match = highlight_body.get("require_field_match", True)
    default_type = highlight_body.get("type", "unified")
    all_terms = set().union(*query_terms.values()) if query_terms else set()
    for fname, fspec in fields_spec.items():
        fspec = fspec or {}
        fragment_size = int(fspec.get("fragment_size", 100))
        n_frags = int(fspec.get("number_of_fragments", 5))
        hl_type = fspec.get("type", default_type)
        order = fspec.get("order", highlight_body.get("order", "none"))
        for resolved in (mapper_service.mapper.simple_match_to_fields(fname)
                         or [fname]):
            value = _source_value(source, resolved)
            if value is None:
                continue
            text = value if isinstance(value, str) else str(value)
            ft = mapper_service.field_type(resolved)
            analyzer_name = (ft.analyzer if isinstance(ft, TextFieldType)
                             else "keyword")
            analyzer = mapper_service.analyzers.get(analyzer_name)
            terms = query_terms.get(resolved, set()) if require_match else all_terms
            if not terms:
                continue
            spans = [(s, e, tok) for tok, s, e in analyzer.analyze_tokens(text)
                     if tok in terms]
            if not spans:
                continue
            if hl_type == "plain":
                fragments = _build_fragments(
                    text, [(s, e) for s, e, _ in spans], fragment_size,
                    n_frags, pre, post)
            else:
                fragments = _unified_fragments(
                    text, spans, fragment_size, n_frags, pre, post, order)
            if fragments:
                out[resolved] = fragments
    return out


def _split_passages(text: str, max_len: int) -> List[tuple]:
    """Sentence-bounded passages [(start, end)], long sentences split at
    word boundaries near ``max_len`` (a BreakIterator stand-in)."""
    bounds = []
    start = 0
    for m in _SENTENCE_BREAK.finditer(text):
        bounds.append((start, m.start()))
        start = m.end()
    if start < len(text):
        bounds.append((start, len(text)))
    out = []
    for s, e in bounds:
        while e - s > max_len * 2:
            cut = text.rfind(" ", s, s + max_len)
            if cut <= s:
                cut = s + max_len
            out.append((s, cut))
            s = cut + 1
        if e > s:
            out.append((s, e))
    return out


def _unified_fragments(text, spans, fragment_size, n_frags, pre, post,
                       order) -> List[str]:
    """The unified highlighter: score each sentence passage by its unique
    terms with log tf saturation (PassageScorer), keep the top passages
    and wrap their matches."""
    passages = _split_passages(text, fragment_size)
    scored = []
    for idx, (ps, pe) in enumerate(passages):
        inside = [(s, e) for s, e, _tok in spans if s >= ps and e <= pe]
        if not inside:
            continue
        tfs: Dict[str, int] = {}
        for s, e, tok in spans:
            if s >= ps and e <= pe:
                tfs[tok] = tfs.get(tok, 0) + 1
        score = sum(1.0 + math.log1p(tf) for tf in tfs.values())
        scored.append((score, idx, ps, pe, inside))
    if not scored:
        return []
    scored.sort(key=lambda t: (-t[0], t[1]))
    chosen = scored[:n_frags]
    if order != "score":
        chosen.sort(key=lambda t: t[1])  # document order (the default)
    fragments = []
    for _score, _idx, ps, pe, inside in chosen:
        frag = []
        pos = ps
        for a, b in sorted(inside):
            frag.append(text[pos:a])
            frag.append(pre + text[a:b] + post)
            pos = b
        frag.append(text[pos:pe])
        fragments.append("".join(frag))
    return fragments


def _source_value(source: dict, path: str):
    node = source
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _build_fragments(text, spans, fragment_size, n_frags, pre, post):
    """The plain highlighter: a ``fragment_size`` window around each
    match, one a window, matches wrapped."""
    spans = sorted(spans)
    fragments = []
    used = set()
    for s, e in spans:
        frag_start = max(0, s - fragment_size // 2)
        frag_id = frag_start // max(fragment_size, 1)
        if frag_id in used:
            continue
        used.add(frag_id)
        frag_end = min(len(text), frag_start + fragment_size)
        in_frag = [(a, b) for a, b in spans if a >= frag_start and b <= frag_end]
        frag = []
        pos = frag_start
        for a, b in in_frag:
            frag.append(text[pos:a])
            frag.append(pre + text[a:b] + post)
            pos = b
        frag.append(text[pos:frag_end])
        fragments.append("".join(frag))
        if len(fragments) >= n_frags:
            break
    return fragments


def extract_query_terms(qb, ctx, terms: Optional[Dict[str, set]] = None
                        ) -> Dict[str, set]:
    """(field -> tokens) of a builder tree, for highlighting: the match,
    phrase, term, terms and multi_match leaves under bool, constant_score,
    dis_max and function_score (the JAX package's set)."""
    from elasticsearch_tpu_torch.search import query_dsl as Q

    if terms is None:
        terms = {}

    def add(field_name, toks):
        terms.setdefault(field_name, set()).update(toks)

    if isinstance(qb, Q.MatchQueryBuilder):
        ft = ctx.field_type(qb.field)
        if isinstance(ft, TextFieldType):
            add(qb.field, ft.query_terms(qb.query, ctx.analyzers))
        else:
            add(qb.field, [str(qb.query)])
    elif isinstance(qb, Q.MatchPhraseQueryBuilder):
        ft = ctx.field_type(qb.field)
        if isinstance(ft, TextFieldType):
            add(qb.field, ft.query_terms(qb.query, ctx.analyzers))
    elif isinstance(qb, Q.TermQueryBuilder):
        add(qb.field, [str(qb.value)])
    elif isinstance(qb, Q.TermsQueryBuilder):
        add(qb.field, [str(v) for v in qb.values])
    elif isinstance(qb, Q.MultiMatchQueryBuilder):
        for f in qb.fields:
            name = f.split("^")[0]
            for resolved in (ctx.mapper_service.mapper.simple_match_to_fields(
                    name) or [name]):
                ft = ctx.field_type(resolved)
                if isinstance(ft, TextFieldType):
                    add(resolved, ft.query_terms(qb.query, ctx.analyzers))
    elif isinstance(qb, Q.BoolQueryBuilder):
        for sub in qb.must + qb.should + qb.filter:
            extract_query_terms(sub, ctx, terms)
    elif isinstance(qb, Q.ConstantScoreQueryBuilder):
        extract_query_terms(qb.filter, ctx, terms)
    elif isinstance(qb, Q.DisMaxQueryBuilder):
        for sub in qb.queries:
            extract_query_terms(sub, ctx, terms)
    elif isinstance(qb, Q.FunctionScoreQueryBuilder):
        extract_query_terms(qb.query, ctx, terms)
    return terms


def fetch_hits(refs: List[DocRef], shards: Dict[int, Any], source_body: dict,
               index_name: str,
               pinned_segments: Optional[Dict[int, list]] = None
               ) -> List[dict]:
    """Fetch phase: materialize hits from doc refs.

    shards: shard_id -> object with .engine and .mapper_service.
    pinned_segments: {shard_id: [segment views]} of an open scroll: refs
    of a pinned query phase fetch from those views (a merge may have
    dropped the segment from the engine since)."""
    source_body = source_body or {}
    includes, excludes, enabled = _parse_source_spec(
        source_body.get("_source", True))
    # "_none_" drops _source; any other stored_fields value keeps it (the
    # JAX package's contract)
    enabled = enabled and source_body.get("stored_fields") != "_none_"
    docvalue_fields = source_body.get("docvalue_fields") or []
    want_version = bool(source_body.get("version", False))
    highlight_body = source_body.get("highlight")
    sort_spec = normalize_sort(source_body.get("sort"))
    compiled_scripts = _compile_script_fields(
        source_body.get("script_fields") or {})
    query_terms: Dict[str, set] = {}
    # builders with inner_hits, one set a shard (the child or nested pass
    # runs once a shard a request, not once a hit)
    has_inner_hits = bool(source_body.get("query") and collect_inner_hits(
        parse_query(source_body["query"])))
    inner_hits_cache: Dict[int, Tuple] = {}
    hits = []
    for ref in refs:
        shard = shards[ref.shard_id]
        seg = None
        if pinned_segments is not None:
            seg = next((s for s in pinned_segments.get(ref.shard_id, [])
                        if s.name == ref.segment_name), None)
        if seg is None:
            seg = next((s for s in shard.engine.segments
                        if s.name == ref.segment_name), ref.segment)
        if seg is None:
            continue
        d = ref.local_doc
        hit = {
            "_index": index_name,
            "_type": "_doc",
            "_id": seg.doc_ids[d],
            "_score": None if sort_spec is not None else ref.score,
        }
        if enabled:
            src = seg.sources[d]
            if includes or excludes:
                src = filter_source(src, includes, excludes)
            hit["_source"] = src
        if want_version:
            hit["_version"] = int(seg.versions[d])
        if docvalue_fields:
            fields_out = _docvalue_fields(seg, d, docvalue_fields)
            if fields_out:
                hit["fields"] = fields_out
        if compiled_scripts:
            fields_out = hit.setdefault("fields", {})
            for fname, (script, sparams) in compiled_scripts.items():
                fields_out[fname] = [_script_field_value(
                    script, sparams, seg, d, ref.score or 0.0)]
        if sort_spec is not None:
            hit["sort"] = [_sort_value_out(v) for v in ref.sort_values]
        if highlight_body:
            if not query_terms:
                query_terms = extract_query_terms(
                    parse_query(source_body.get("query")),
                    ShardQueryContext(shard.mapper_service))
            hl = highlight_fields(seg.sources[d], shard.mapper_service,
                                  query_terms, highlight_body)
            if hl:
                hit["highlight"] = hl
        if has_inner_hits:
            if ref.shard_id not in inner_hits_cache:
                inner_hits_cache[ref.shard_id] = (
                    ShardQueryContext(shard.mapper_service, shard.engine),
                    collect_inner_hits(parse_query(source_body["query"])))
            ih_ctx, ih_builders = inner_hits_cache[ref.shard_id]
            ih_out = {}
            for b in ih_builders:
                name, payload = b.inner_hits_for(ih_ctx, seg, d, index_name)
                ih_out[name] = payload
            if ih_out:
                hit["inner_hits"] = ih_out
        hits.append(hit)
    return hits


def _compile_script_fields(script_fields: dict) -> Dict[str, tuple]:
    """{name: (compiled script, params)}: each script compiled once a
    request."""
    out = {}
    for fname, spec in script_fields.items():
        sc = spec.get("script", spec)
        out[fname] = (compile_script(sc),
                      (sc.get("params") if isinstance(sc, dict) else None)
                      or {})
    return out


def _script_field_value(script, params: dict, seg, d: int, score: float):
    """One hit's script field: a painless script runs over the doc's
    typed values (strings stay strings), the expression engine over its
    numbers."""
    if hasattr(script, "run"):
        return script.run({"doc": DocMap(segment_doc_resolver(seg, d)),
                           "params": dict(params), "_score": score})
    return script.execute(doc_values_for(seg, d, script.doc_fields), params,
                          score)


def _docvalue_fields(seg, d: int, specs) -> Dict[str, list]:
    """A hit's ``docvalue_fields``: a numeric column's values as float64
    (in column order), else an ordinal column's terms (the field or its
    ``.keyword`` subfield); a field the doc lacks is left out. A spec is
    a name or ``{"field": name, "format": ...}`` (the format is read past,
    as in the JAX package)."""
    out: Dict[str, list] = {}
    for fspec in specs:
        fname = fspec if isinstance(fspec, str) else fspec.get("field")
        col = seg.numeric_columns.get(fname)
        if col is not None and col.exists[d]:
            sel = col.flat_docs[: col.count] == d
            out[fname] = [float(v) for v in col.flat_values[: col.count][sel]]
            continue
        ocol = (seg.ordinal_columns.get(fname)
                or seg.ordinal_columns.get(f"{fname}.keyword"))
        if ocol is not None and ocol.exists[d]:
            sel = ocol.flat_docs[: ocol.count] == d
            out[fname] = [ocol.terms[o]
                          for o in ocol.flat_ords[: ocol.count][sel]]
    return out
