"""IndexService: one index = N shards + mapping + routing + search fan-out.

Counterpart of ``elasticsearch_tpu/index/index_service.py``, cut to the
host rung: docs route to shards by murmur3 of their id (or routing), and
a search runs the query phase shard by shard, merges the shards' top-k,
runs the aggregations over every shard's segment views and fetches the
hits. The response carries ``"_plane": "host"`` and ``hits.total`` as a
plain int (the 6.x shape). The mesh plane, the micro-batcher, the request
cache, admission control, scrubbing and compaction are later slices.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.settings import (
    INDEX_NUMBER_OF_SHARDS,
    Settings,
)
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.index.similarity import SimilarityService
from elasticsearch_tpu_torch.mapper.mapping import MapperService
from elasticsearch_tpu_torch.search.aggregations import parse_aggs, run_aggregations
from elasticsearch_tpu_torch.search.service import fetch_hits, merge_refs
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for


class IndexService:
    def __init__(self, name: str, settings: Settings = Settings.EMPTY,
                 mapping: Optional[dict] = None, device="cuda"):
        self.name = name
        self.settings = settings
        self.device = resolve_device(device)
        self.num_shards = INDEX_NUMBER_OF_SHARDS.get(settings)
        self.analyzers = AnalysisRegistry(settings)
        self.mapper_service = MapperService(
            self.analyzers, mapping,
            similarity_service=SimilarityService(settings))
        self.shards: Dict[int, IndexShard] = {
            sid: IndexShard(name, sid, self.mapper_service, device=self.device)
            for sid in range(self.num_shards)
        }

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
    # Search (the host rung)
    # ------------------------------------------------------------------

    def search(self, body: Optional[dict] = None) -> dict:
        t0 = time.monotonic()
        body = body or {}
        from_ = int(body.get("from", 0) or 0)
        size = int(body.get("size")) if body.get("size") is not None else 10
        k = from_ + size
        shard_ids = sorted(self.shards)
        shard_results = [
            self.shards[sid].searcher.query(body, size_hint=max(k, 1))
            for sid in shard_ids
        ]
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
                "skipped": 0,
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
