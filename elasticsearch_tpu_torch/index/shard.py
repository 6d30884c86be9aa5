"""IndexShard: one shard copy's lifecycle, write entry points and searcher.

Counterpart of ``elasticsearch_tpu/index/shard.py``: the shard states
(CREATED -> RECOVERING -> STARTED -> CLOSED), the
engine, the ShardSearcher, the document ops under operation permits and
the copy's primary term, the indexing slowlog, flush, synced flush,
force merge and recovery from the store. A copy is a primary or a
replica (``primary``); the cluster (``cluster/multinode.py``) fences
writes with ``acquire_primary_permit``, promotes a replica with
``promote_to_primary`` (a drain, then the master's term) and sets
``checkpoints`` (a ``GlobalCheckpointTracker``) on a replicated primary.

With a ``data_path`` the shard keeps its translog in
``<data_path>/translog`` and its store in ``<data_path>/index``: the JAX
package's layout, so either package opens the other's shard. Without one
it keeps nothing on disk (the JAX package opens a translog and a store in
a temporary directory there; nothing on one node reads it back, and a
snapshot of such a shard writes its segments straight into the
repository, ``snapshots/service.py``). A ``ClusterNode`` gives each shard
it hosts a data path (under a temporary directory of its own when it has
none), since peer recovery ships the source's committed files.
``restore_from_snapshot`` installs a snapshot's copy of a shard store. A
cold recovery from the store records a ``store`` row of
``_cat/recovery`` (``index/recovery_progress.record_recovery_progress``).
"""

from __future__ import annotations

import base64
import logging
import os
import shutil
import threading
import time
from contextlib import contextmanager
from typing import Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.index.engine import Engine, VersionEntry
from elasticsearch_tpu_torch.index.recovery_progress import (
    record_recovery_progress,
)
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.search.service import ShardSearcher

_indexing_slow_logger = logging.getLogger(
    "elasticsearch_tpu_torch.index.indexing.slowlog")


class ShardState:
    CREATED = "CREATED"
    RECOVERING = "RECOVERING"
    STARTED = "STARTED"
    CLOSED = "CLOSED"


class ShardNotPrimaryException(IllegalArgumentException):
    """The copy is not (any longer) the primary for the operation."""


class OperationPermits:
    """IndexShardOperationPermits analog: counted operation permits with a
    blocking drain. Writers hold a permit across the engine op; a
    primary-term bump or a relocation handoff calls ``block_and_drain``
    (new acquisitions park, in-flight ones finish) and runs its critical
    section against a quiesced shard."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active = 0
        self._blocked = False
        # reentrancy: a thread holding a permit (the replication layer
        # around shard.index_doc, which takes its own) must not park
        # behind a drain it would itself block
        self._local = threading.local()

    @property
    def active(self) -> int:
        return self._active

    @contextmanager
    def acquire(self, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        depth = getattr(self._local, "depth", 0)
        with self._cond:
            while self._blocked and depth == 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise IllegalArgumentException(
                        "timed out waiting for operation permit "
                        "(shard is draining)")
                self._cond.wait(remaining)
            self._active += 1
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            with self._cond:
                self._active -= 1
                self._cond.notify_all()

    @contextmanager
    def block_and_drain(self, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._blocked:  # one drain at a time
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise IllegalArgumentException(
                        "timed out waiting for a concurrent drain")
                self._cond.wait(remaining)
            self._blocked = True
            try:
                while self._active > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise IllegalArgumentException(
                            "timed out draining in-flight operations")
                    self._cond.wait(remaining)
            except BaseException:
                self._blocked = False
                self._cond.notify_all()
                raise
        try:
            yield
        finally:
            with self._cond:
                self._blocked = False
                self._cond.notify_all()


class IndexShard:
    def __init__(self, index_name: str, shard_id: int, mapper_service,
                 device="cuda", data_path: Optional[str] = None,
                 durability: str = Translog.DURABILITY_REQUEST,
                 index_sort=None, slowlog_warn_s=None, slowlog_info_s=None,
                 primary: bool = True, indexing_slowlog_warn_s=None,
                 indexing_slowlog_info_s=None,
                 indexing_slowlog_source_chars: int = 1000):
        self.index_name = index_name
        self.shard_id = shard_id
        self.mapper_service = mapper_service
        self.data_path = data_path
        self.state = ShardState.CREATED
        self.primary = primary
        # the copy's primary term: bumped by a promotion (the master's
        # term) and learned by replicas from the publish and the writes
        self.primary_term = 1
        self.permits = OperationPermits()
        # the primary's GlobalCheckpointTracker (the cluster sets it on a
        # replicated primary; None: a single copy)
        self.checkpoints = None
        # the indexing slowlog's thresholds in seconds (negative: off)
        self.indexing_slowlog_warn_s = (
            indexing_slowlog_warn_s if indexing_slowlog_warn_s is not None
            and indexing_slowlog_warn_s >= 0 else None)
        self.indexing_slowlog_info_s = (
            indexing_slowlog_info_s if indexing_slowlog_info_s is not None
            and indexing_slowlog_info_s >= 0 else None)
        self.indexing_slowlog_source_chars = indexing_slowlog_source_chars
        translog = store = None
        if data_path:
            os.makedirs(data_path, exist_ok=True)
            translog = Translog(os.path.join(data_path, "translog"),
                                durability)
            store = Store(os.path.join(data_path, "index"))
        self.engine = Engine(f"{index_name}[{shard_id}]", mapper_service,
                             segment_prefix=f"{index_name}_{shard_id}_seg",
                             device=device, translog=translog, store=store,
                             index_sort=index_sort)
        # the device-memory ledger attributes the segments' stagings here
        self.engine.index_name = index_name
        self.searcher = ShardSearcher(shard_id, self.engine, mapper_service,
                                      index_name=index_name,
                                      slowlog_warn_s=slowlog_warn_s,
                                      slowlog_info_s=slowlog_info_s)
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

    def recover_from_store(self, store: Optional[Store] = None,
                           segments: Optional[list] = None) -> int:
        """Load the committed segments (checksums verified), defer their
        live docs' version-map entries to the map's first read, re-adopt
        the commit's delete tombstones, then replay the translog's
        uncommitted ops. Returns the ops replayed. Raises
        ``CorruptIndexException`` for a store that fails verification.
        ``store``: another store to load from (a snapshot's shard
        directory, for a shard that has no store of its own);
        ``segments``: the committed segments, loaded already. A cold boot
        (the shard still CREATED) records a ``store`` row of
        ``_cat/recovery``; peer recovery re-enters here to install the
        shipped files and owns its own ``peer`` row."""
        boot = self.state == ShardState.CREATED
        self.state = ShardState.RECOVERING
        engine = self.engine
        store = store if store is not None else engine.store
        if segments is None:
            segments = store.load_segments(engine.device)
        engine.segments = segments
        # a loaded segment may reuse a name the engine held before (a
        # restore): the request cache's epoch moves
        engine.visibility_epoch += 1
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
        commit = store.read_commit() or {}
        doc_terms = commit.get("doc_terms", {})
        max_seq = -1
        for seg in segments:
            # the ledger owner before any staging (a peer-recovered copy
            # may stage before its first search)
            engine._stamp_owner(seg)
            # the live docs enter the version map on its first read
            engine.defer_version_entries(seg, doc_terms)
            if seg.num_docs:
                max_seq = max(max_seq, int(seg.seqnos.max()))
        # without the tombstones a replayed older op could resurrect a
        # deleted doc
        for doc_id, t in commit.get("tombstones", {}).items():
            engine.put_version(doc_id, VersionEntry(
                t["version"], t["seq_no"], None, -1, deleted=True,
                term=t.get("term", 1)))
            max_seq = max(max_seq, t["seq_no"])
        if max_seq >= 0:
            engine.note_external_seqno(max_seq)
        replayed = engine.recover_from_translog()
        if boot:
            # a drained shutdown's synced flush makes ``replayed`` zero
            now_ms = int(time.time() * 1000)
            record_recovery_progress(
                self.index_name, self.shard_id, f"store[{self.shard_id}]",
                source=None, type="store", stage="done", start_ms=now_ms,
                stop_ms=now_ms, files_total=len(segments),
                files_recovered=len(segments), bytes_total=0,
                bytes_recovered=0, ops_total=replayed,
                ops_recovered=replayed)
        self.state = ShardState.STARTED
        return replayed

    def restore_from_snapshot(self, directory: str) -> None:
        """Replace the shard's contents with a snapshot's copy of a shard
        store: the current segments (their device arrays released) and
        version map are dropped, then the shard recovers from the copy.
        A shard with a store of its own takes the files into it first; a
        store-less shard reads the snapshot's directory in place."""
        engine = self.engine
        with engine._lock:
            for seg in engine.segments:
                seg.release_breaker_charges()
                seg.release_device()
            engine.segments = []
            engine.version_map = {}
        if engine.store is None:
            self.recover_from_store(Store(directory))
            return
        dst = engine.store.directory
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(directory, dst)
        self.recover_from_store()

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

    @contextmanager
    def acquire_primary_permit(self, op_term: Optional[int] = None,
                               timeout: float = 30.0):
        """The primary-term-fenced operation permit
        (IndexShard.acquirePrimaryOperationPermit). ``op_term``: the term
        the coordinator routed the op under; one older than this copy's
        raced a promotion and is refused. None: a local op under the
        current term. The permit is taken FIRST and primary and term are
        checked under it, so a promotion or handoff cannot flip them
        while the op waits."""
        with self.permits.acquire(timeout=timeout):
            if not self.primary:
                raise ShardNotPrimaryException(
                    f"shard [{self.index_name}][{self.shard_id}] is not a "
                    f"primary")
            if op_term is not None and op_term < self.primary_term:
                raise ShardNotPrimaryException(
                    f"operation primary term [{op_term}] is too old "
                    f"(current [{self.primary_term}])")
            yield

    def promote_to_primary(self, new_term: int) -> None:
        """Replica promotion: drain the in-flight ops, then take the
        master's term, so everything after the barrier runs under it."""
        with self.permits.block_and_drain():
            self.primary = True
            self.primary_term = max(self.primary_term, new_term)

    @contextmanager
    def relocation_handoff(self):
        """Primary relocation handoff: quiesce the shard, run the
        handoff, then refuse further primary ops here."""
        with self.permits.block_and_drain():
            yield
            self.primary = False

    def index_doc(self, doc_id: str, source: dict, routing: Optional[str] = None,
                  version: Optional[int] = None, op_type: str = "index",
                  parent: Optional[str] = None) -> dict:
        self._ensure_started()
        t0 = time.monotonic()
        with self.permits.acquire():
            r = self.engine.index(doc_id, source, routing, version, op_type,
                                  primary_term=self.primary_term,
                                  parent=parent)
        self._maybe_indexing_slowlog(time.monotonic() - t0, doc_id, source)
        r["_index"] = self.index_name
        r["_shard"] = self.shard_id
        r["_primary_term"] = self.primary_term
        return r

    def _maybe_indexing_slowlog(self, took_s: float, doc_id: str,
                                source: dict) -> None:
        """The indexing slowlog: per-index warn / info thresholds, the
        source cut to ``index.indexing.slowlog.source`` chars."""
        warn = self.indexing_slowlog_warn_s
        info = self.indexing_slowlog_info_s
        level = None
        if warn is not None and took_s >= warn:
            level = _indexing_slow_logger.warning
        elif info is not None and took_s >= info:
            level = _indexing_slow_logger.info
        if level is not None:
            level("took[%dms], shard[[%s][%s]], id[%s], source[%s]",
                  int(took_s * 1000), self.index_name, self.shard_id,
                  doc_id, str(source)[: self.indexing_slowlog_source_chars])

    def delete_doc(self, doc_id: str, version: Optional[int] = None,
                   seqno: Optional[int] = None) -> dict:
        self._ensure_started()
        with self.permits.acquire():
            r = self.engine.delete(doc_id, version, seqno,
                                   primary_term=self.primary_term)
        r["_index"] = self.index_name
        r["_primary_term"] = self.primary_term
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
        """max_seq_no / local_checkpoint / global_checkpoint: a single
        copy's global checkpoint is its local checkpoint; a replicated
        primary's tracker (``checkpoints``) owns it, and a replica's is
        the one the primary last sent it."""
        tracker = self.checkpoints
        if tracker is not None:
            gcp = tracker.global_checkpoint
        elif self.primary:
            gcp = self.engine.local_checkpoint
        else:
            gcp = self.engine.global_checkpoint
        return {
            "max_seq_no": self.engine.max_seqno,
            "local_checkpoint": self.engine.local_checkpoint,
            "global_checkpoint": gcp,
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
        s["routing"] = {"state": self.state, "primary": self.primary}
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
        self.state = ShardState.CLOSED
        self.engine.close()
