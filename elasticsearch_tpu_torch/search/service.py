"""Per-shard search execution + cross-shard merge + fetch.

Counterpart of ``elasticsearch_tpu/search/service.py``:

- ``ShardSearcher.query(source)`` runs the query phase on one shard: plan
  -> device execution per segment -> copy of the dense scores and mask to
  the host (as the JAX host rung does) -> top-k selection -> agg views;
  returns a ``ShardQueryResult`` of doc refs.
- ``merge_refs`` is the coordinator's global top-k; ``fetch_hits``
  materializes hits (``_source`` filtering, version).

Relevance order only: sort, search_after, rescore, collapse, slice,
profile, scroll, highlight and suggest are later slices, and a request
carrying one raises.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
)
from elasticsearch_tpu_torch.ops.scoring import select_topk
from elasticsearch_tpu_torch.search import plan as P
from elasticsearch_tpu_torch.search.aggregations import (
    SegmentView,
    parse_aggs,
)
from elasticsearch_tpu_torch.search.query_dsl import (
    ShardQueryContext,
    parse_query,
)

# request-body keys this slice serves; anything else raises
SUPPORTED_BODY_KEYS = {"query", "from", "size", "aggs", "aggregations",
                       "_source", "min_score", "post_filter", "version"}


def check_body(body: dict) -> None:
    unsupported = sorted(set(body) - SUPPORTED_BODY_KEYS)
    if unsupported:
        raise IllegalArgumentException(
            f"search request parameters {unsupported} are not supported by "
            f"the PyTorch port yet")


@dataclass
class DocRef:
    """A hit before fetch: which shard/segment/local doc + ranking keys."""

    shard_id: int
    segment_name: str
    local_doc: int
    score: float


@dataclass
class ShardQueryResult:
    shard_id: int
    total_hits: int
    refs: List[DocRef]
    max_score: Optional[float] = None
    agg_views: List[SegmentView] = field(default_factory=list)


def _plan_uses_kernel(node) -> bool:
    if isinstance(node, P.PallasScoreTermsNode):
        return True
    return any(_plan_uses_kernel(c) for c in node.children())


class ShardSearcher:
    """Query-phase execution for one shard."""

    def __init__(self, shard_id: int, engine, mapper_service,
                 index_name: str = ""):
        self.shard_id = shard_id
        self.index_name = index_name
        self.engine = engine
        self.mapper_service = mapper_service
        self.ctx = ShardQueryContext(mapper_service)
        self.query_total = 0
        # which engine scored each segment: the tile kernel or the scatter
        self.kernel_segments_total = 0
        self.scatter_segments_total = 0
        # the dense [nd1] scores + mask copy to the host, per segment
        # (after the device finished the plan): what the top-k variant of
        # the tile kernel, a later slice, exists to remove
        self.host_copy_seconds = 0.0
        self.host_copy_bytes = 0
        self.host_copy_segments = 0

    def query(self, source: dict, size_hint: Optional[int] = None,
              segments=None) -> ShardQueryResult:
        self.query_total += 1
        source = source or {}
        check_body(source)
        from_ = int(source.get("from", 0) or 0)
        size = int(source.get("size", 10) if source.get("size") is not None else 10)
        k = size_hint if size_hint is not None else from_ + size
        k = max(k, 1)
        qb = parse_query(source.get("query"))
        post_qb = parse_query(source["post_filter"]) if source.get("post_filter") else None
        min_score = source.get("min_score")
        agg_specs = parse_aggs(source.get("aggs") or source.get("aggregations"))

        refs: List[DocRef] = []
        total = 0
        max_score = None
        agg_views: List[SegmentView] = []
        for seg in (segments if segments is not None
                    else self.engine.searchable_segments()):
            dev = seg.device_arrays()
            node = qb.to_plan(self.ctx, seg)
            if _plan_uses_kernel(node):
                self.kernel_segments_total += 1
            else:
                self.scatter_segments_total += 1
            scores_d, matched_d = P.execute(dev, node)
            scores, matched = self._to_host(seg.device, scores_d, matched_d)
            live1 = np.concatenate([seg.live, np.zeros(1, bool)])
            matched = matched & live1
            if min_score is not None:
                matched = matched & (scores >= float(min_score))
            if agg_specs:
                agg_views.append(SegmentView(seg, matched.copy()))
            if post_qb is not None:
                _, post_m = P.execute(dev, post_qb.to_plan(self.ctx, seg))
                matched = matched & post_m.cpu().numpy()
            total += int(matched[: seg.num_docs].sum())
            seg_refs = self._select(seg, scores, matched, k)
            refs.extend(seg_refs)
            if seg_refs:
                m = max(r.score for r in seg_refs)
                max_score = m if max_score is None else max(max_score, m)
        refs = merge_refs(refs, k)
        return ShardQueryResult(self.shard_id, total, refs, max_score, agg_views)

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

    def _select(self, seg, scores, matched, k) -> List[DocRef]:
        """Relevance top-k on the host copy, ties by ascending doc id."""
        s = torch.from_numpy(scores)
        m = torch.from_numpy(matched)
        top_scores, top_docs = select_topk(s, m, torch.ones_like(m), int(k))
        out = []
        for sc, d in zip(top_scores.tolist(), top_docs.tolist()):
            if sc == -np.inf:
                break
            out.append(DocRef(self.shard_id, seg.name, int(d), float(sc)))
        return out


def merge_refs(refs: List[DocRef], k: int) -> List[DocRef]:
    """Coordinator-side top-k merge (SearchPhaseController.sortDocs)."""
    refs.sort(key=lambda r: (-r.score, r.shard_id, r.local_doc))
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


def fetch_hits(refs: List[DocRef], shards: Dict[int, Any], source_body: dict,
               index_name: str) -> List[dict]:
    """Fetch phase: materialize hits from doc refs.
    shards: shard_id -> object with .engine."""
    source_body = source_body or {}
    includes, excludes, enabled = _parse_source_spec(
        source_body.get("_source", True))
    want_version = bool(source_body.get("version", False))
    hits = []
    for ref in refs:
        shard = shards[ref.shard_id]
        seg = next((s for s in shard.engine.segments
                    if s.name == ref.segment_name), None)
        if seg is None:
            continue
        d = ref.local_doc
        hit = {
            "_index": index_name,
            "_type": "_doc",
            "_id": seg.doc_ids[d],
            "_score": ref.score,
        }
        if enabled:
            src = seg.sources[d]
            if includes or excludes:
                src = filter_source(src, includes, excludes)
            hit["_source"] = src
        if want_version:
            hit["_version"] = int(seg.versions[d])
        hits.append(hit)
    return hits
