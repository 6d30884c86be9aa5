"""IndexShard: one shard's write entry points and its searcher.

Counterpart of ``elasticsearch_tpu/index/shard.py``, cut to an in-memory
primary: the engine, the ShardSearcher, and the document ops. Recovery,
operation permits, primary terms and the slow logs are later slices.
"""

from __future__ import annotations

from typing import Optional

from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.search.service import ShardSearcher


class IndexShard:
    def __init__(self, index_name: str, shard_id: int, mapper_service,
                 device="cuda"):
        self.index_name = index_name
        self.shard_id = shard_id
        self.mapper_service = mapper_service
        self.engine = Engine(f"{index_name}[{shard_id}]", mapper_service,
                             segment_prefix=f"{index_name}_{shard_id}_seg",
                             device=device)
        self.searcher = ShardSearcher(shard_id, self.engine, mapper_service,
                                      index_name=index_name)

    def index_doc(self, doc_id: str, source: dict, routing: Optional[str] = None,
                  version: Optional[int] = None, op_type: str = "index") -> dict:
        r = self.engine.index(doc_id, source, routing, version, op_type)
        r["_index"] = self.index_name
        r["_shard"] = self.shard_id
        return r

    def delete_doc(self, doc_id: str, version: Optional[int] = None) -> dict:
        r = self.engine.delete(doc_id, version)
        r["_index"] = self.index_name
        return r

    def get_doc(self, doc_id: str, realtime: bool = True):
        return self.engine.get(doc_id, realtime=realtime)

    def refresh(self) -> bool:
        return self.engine.refresh()

    @property
    def num_docs(self) -> int:
        return self.engine.num_docs
