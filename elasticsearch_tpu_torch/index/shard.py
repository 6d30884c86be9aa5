"""IndexShard: one shard's lifecycle, write entry points and searcher.

Counterpart of ``elasticsearch_tpu/index/shard.py``, cut to one primary:
the shard states (CREATED -> RECOVERING -> STARTED), the
engine, the ShardSearcher, the document ops (write responses carry
primary term 1: nothing fails over), flush, synced flush, force merge and
recovery from the store.

With a ``data_path`` the shard keeps its translog in
``<data_path>/translog`` and its store in ``<data_path>/index``: the JAX
package's layout, so either package opens the other's shard. Without one
it keeps nothing on disk (the JAX package opens a translog in a temporary
directory there; nothing on one node reads it back). Operation permits,
the slow logs and the ``_cat/recovery`` rows are later slices.
"""

from __future__ import annotations

import base64
import os
from typing import Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.index.engine import Engine, VersionEntry
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.search.service import ShardSearcher

# the one primary never fails over, so its term stays the first
PRIMARY_TERM = 1


class ShardState:
    CREATED = "CREATED"
    RECOVERING = "RECOVERING"
    STARTED = "STARTED"
    CLOSED = "CLOSED"


class IndexShard:
    def __init__(self, index_name: str, shard_id: int, mapper_service,
                 device="cuda", data_path: Optional[str] = None,
                 durability: str = Translog.DURABILITY_REQUEST):
        self.index_name = index_name
        self.shard_id = shard_id
        self.mapper_service = mapper_service
        self.data_path = data_path
        self.state = ShardState.CREATED
        translog = store = None
        if data_path:
            os.makedirs(data_path, exist_ok=True)
            translog = Translog(os.path.join(data_path, "translog"),
                                durability)
            store = Store(os.path.join(data_path, "index"))
        self.engine = Engine(f"{index_name}[{shard_id}]", mapper_service,
                             segment_prefix=f"{index_name}_{shard_id}_seg",
                             device=device, translog=translog, store=store)
        # the device-memory ledger attributes the segments' stagings here
        self.engine.index_name = index_name
        self.searcher = ShardSearcher(shard_id, self.engine, mapper_service,
                                      index_name=index_name)
        # set when the store carries a corruption marker: the query path
        # fails the shard into _shards.failures
        self.store_corrupted = False

    # ------------------------------------------------------------------
    # Recovery (store + translog replay)
    # ------------------------------------------------------------------

    def has_disk_state(self) -> bool:
        """A commit point or a translog checkpoint to recover from."""
        return self.data_path is not None and (
            self.engine.store.read_commit() is not None
            or os.path.exists(os.path.join(
                self.data_path, "translog", "translog.ckp")))

    def recover_from_store(self) -> int:
        """Load the committed segments (checksums verified), rebuild the
        version map from their live docs, re-adopt the commit's delete
        tombstones, then replay the translog's uncommitted
        ops. Returns the ops replayed. Raises ``CorruptIndexException``
        for a store that fails verification."""
        self.state = ShardState.RECOVERING
        engine = self.engine
        segments = engine.store.load_segments(engine.device)
        engine.segments = segments
        # advance the segment-name counter past every recovered name: a
        # later seal reusing one would skip writing its segment at the
        # next commit and overwrite the old one's live mask
        for seg in segments:
            tail = seg.name.rsplit("_", 1)[-1]
            if tail.isdigit():
                engine._segment_counter = max(engine._segment_counter,
                                              int(tail))
        if engine.buffer.num_docs == 0:
            engine.buffer = engine._new_builder()
        commit = engine.store.read_commit() or {}
        doc_terms = commit.get("doc_terms", {})
        max_seq = -1
        for seg in segments:
            for local, doc_id in enumerate(seg.doc_ids):
                if seg.live[local]:
                    engine.version_map[doc_id] = VersionEntry(
                        int(seg.versions[local]), int(seg.seqnos[local]),
                        seg.name, local, term=doc_terms.get(doc_id, 1))
            if seg.num_docs:
                max_seq = max(max_seq, int(seg.seqnos.max()))
        # without the tombstones a replayed older op could resurrect a
        # deleted doc
        for doc_id, t in commit.get("tombstones", {}).items():
            engine.version_map[doc_id] = VersionEntry(
                t["version"], t["seq_no"], None, -1, deleted=True,
                term=t.get("term", 1))
            max_seq = max(max_seq, t["seq_no"])
        if max_seq >= 0:
            engine.note_external_seqno(max_seq)
        replayed = engine.recover_from_translog()
        self.state = ShardState.STARTED
        return replayed

    def start_fresh(self) -> None:
        self.state = ShardState.STARTED

    def _ensure_started(self) -> None:
        if self.state != ShardState.STARTED:
            raise IllegalArgumentException(
                f"shard [{self.index_name}][{self.shard_id}] is not started "
                f"(state: {self.state})")

    # ------------------------------------------------------------------
    # Write ops
    # ------------------------------------------------------------------

    def index_doc(self, doc_id: str, source: dict, routing: Optional[str] = None,
                  version: Optional[int] = None, op_type: str = "index",
                  parent: Optional[str] = None) -> dict:
        self._ensure_started()
        r = self.engine.index(doc_id, source, routing, version, op_type,
                              parent=parent)
        r["_index"] = self.index_name
        r["_shard"] = self.shard_id
        r["_primary_term"] = PRIMARY_TERM
        return r

    def delete_doc(self, doc_id: str, version: Optional[int] = None) -> dict:
        self._ensure_started()
        r = self.engine.delete(doc_id, version)
        r["_index"] = self.index_name
        r["_primary_term"] = PRIMARY_TERM
        return r

    def get_doc(self, doc_id: str, realtime: bool = True):
        self._ensure_started()
        return self.engine.get(doc_id, realtime=realtime)

    def refresh(self) -> bool:
        return self.engine.refresh()

    def flush(self) -> None:
        self.engine.flush()

    def synced_flush(self) -> str:
        return self.engine.synced_flush()

    def force_merge(self) -> None:
        self.engine.force_merge()

    # ------------------------------------------------------------------

    @property
    def num_docs(self) -> int:
        return self.engine.num_docs

    def seq_no_stats(self) -> dict:
        """max_seq_no / local_checkpoint / global_checkpoint: a lone
        primary's global checkpoint is its local checkpoint."""
        return {
            "max_seq_no": self.engine.max_seqno,
            "local_checkpoint": self.engine.local_checkpoint,
            "global_checkpoint": self.engine.local_checkpoint,
        }

    def stats(self) -> dict:
        """The engine's counters with the searcher's, the routing state
        and the seqno stats (the JAX package's ``IndexShard.stats``; a
        shard without a data path reports an empty translog)."""
        s = self.engine.stats()
        if s["translog"] is None:
            s["translog"] = {"operations": 0, "size_in_bytes": 0,
                             "uncommitted_operations": 0}
        searcher = self.searcher
        s["search"] = {
            "query_total": searcher.query_total,
            "planes": {
                "kernel_segments_total": searcher.kernel_segments_total,
                "scatter_segments_total": searcher.scatter_segments_total,
            },
        }
        if searcher.group_stats:
            s["search"]["groups"] = {g: dict(v) for g, v
                                     in searcher.group_stats.items()}
        s["routing"] = {"state": self.state, "primary": True}
        s["seq_no"] = self.seq_no_stats()
        # the commit identity: stable per (shard, translog generation)
        gen = s["translog"].get("generation", 0)
        s["commit"] = {
            "id": base64.b64encode(
                f"{self.index_name}/{self.shard_id}/{gen}".encode()).decode(),
            "generation": gen,
            "user_data": {},
            "num_docs": s["docs"]["count"],
        }
        return s

    def close(self) -> None:
        self.engine.close()
        self.state = ShardState.CLOSED
