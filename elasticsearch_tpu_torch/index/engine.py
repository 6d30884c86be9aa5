"""The per-shard write engine: buffer + segments + version map + translog.

Counterpart of ``elasticsearch_tpu/index/engine.py`` (InternalEngine with
Lucene's IndexWriter replaced by the block-packing ``SegmentBuilder``):

- ``index()``: version-check against the version map, assign a seqno,
  buffer the doc, append the op to the translog.
- ``refresh()``: seal the buffer into an immutable Segment on the
  engine's device and apply buffered deletes — searches see only sealed
  segments.
- ``flush()``: refresh, write a commit point to the store, then trim the
  translog; ``synced_flush()`` stamps the commit with a sync id, so a
  restart over it replays nothing.
- ``force_merge()``: rebuild the live docs into one segment (their
  positions come from the analyzer again, under the new doc ids, and
  their nested sub-segments from their sources; the legacy ``_parent``
  values carry over); the retired segments return their device bytes to
  the ledger.
- ``add_refresh_listener()``: a callable fired by the refresh that makes
  the pending ops visible (``refresh=wait_for``).
- ``index_sort``: the index sort spec each sealed segment's docs are
  permuted by; a seal's ``seal_doc_remap`` re-homes the version map's and
  the buffered deletes' local docs.
- ``visibility_epoch``: moves at every refresh that changes what a search
  sees (new docs or applied deletes), the request cache's reader identity
  beside the segment names and the write counters.
- ``recover_from_translog()``: replay the uncommitted ops after a restart
  (the seqno staleness guard makes a replay idempotent).
- updates/deletes tombstone the old doc; against a sealed segment the
  tombstone becomes search-visible at the next refresh.
- realtime GET reads unrefreshed docs straight from the buffer.

An engine without a translog and a store (a ``Node`` without a data
path) keeps nothing on disk: flush refreshes and counts, and there is
nothing to replay. The JAX package opens a translog in a temporary
directory for such a shard; nothing on one node reads it back.
"""

from __future__ import annotations

import itertools

import threading
import uuid as _uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.errors import VersionConflictEngineException
from elasticsearch_tpu_torch.index.segment import Segment, SegmentBuilder
from elasticsearch_tpu_torch.index.translog import Translog, TranslogOp


@dataclass(slots=True)
class VersionEntry:
    version: int
    seqno: int
    # where the doc lives: segment name, or None while still in the buffer
    segment: Optional[str]
    local_doc: int
    deleted: bool = False
    # primary term of the op that produced this entry: equal-seqno ties
    # in the staleness guard break by term
    term: int = 1


@dataclass
class GetResult:
    found: bool
    doc_id: str
    source: Optional[dict] = None
    version: int = -1
    seqno: int = -1
    routing: Optional[str] = None


class Engine:
    def __init__(self, shard_id, mapper_service, segment_prefix: str = "seg",
                 device="cuda", translog: Optional[Translog] = None,
                 store=None, index_sort=None):
        self.shard_id = shard_id
        self.mapper_service = mapper_service
        self.device = resolve_device(device)
        # the write-ahead log and the store (index/store.py), or None for
        # an engine that keeps nothing on disk
        self.translog = translog
        self.store = store
        self._segment_prefix = segment_prefix
        self._segment_counter = 0
        # index.sort.* spec, applied by every builder at seal
        self.index_sort = index_sort
        self.segments: List[Segment] = []
        self.buffer = self._new_builder()
        self._buffer_deletes: set = set()
        # deletes against sealed segments, applied at the next refresh
        self._pending_seg_deletes: List[tuple] = []
        self._version_map: Dict[str, VersionEntry] = {}
        # sealed segments whose live docs enter the version map on its
        # first read (adopt_segment, store recovery): a search never reads
        # it, so building a quarter million entries a segment waits for
        # the first write, get or commit
        self._deferred_entries: List[tuple] = []
        self._seqno = -1
        self._local_checkpoint = -1
        self._lock = threading.RLock()
        self.refresh_count = 0
        self.flush_count = 0
        self.indexing_total = 0
        self.delete_total = 0
        # moves at every refresh that changes the searchable view (the
        # request cache's epoch: a delete-only refresh keeps the segment
        # names and the write counters)
        self.visibility_epoch = 0
        # refresh=wait_for: callables fired by the refresh that makes the
        # pending ops visible
        self._refresh_listeners: List = []
        # postings-codec preference stamped on each searchable segment
        # (IndexService sets both from the index settings)
        self.postings_codec: Optional[str] = None
        self.postings_codec_default: Optional[str] = None
        # the index the device-memory ledger attributes stagings to
        # (IndexShard sets it)
        self.index_name: Optional[str] = None

    @property
    def version_map(self) -> Dict[str, VersionEntry]:
        """Doc id -> its latest ``VersionEntry``; the deferred segments'
        entries are built first, in the order they were deferred, so the
        map reads as if each had been built at once."""
        if self._deferred_entries:
            with self._lock:
                # the list empties only once the map is whole: a reader
                # that finds it empty finds every entry
                for seg, lives, terms in self._deferred_entries:
                    at = lives.tolist()
                    self._version_map.update(zip(
                        map(seg.doc_ids.__getitem__, at),
                        map(VersionEntry, seg.versions[lives].tolist(),
                            seg.seqnos[lives].tolist(),
                            itertools.repeat(seg.name), at,
                            itertools.repeat(False),
                            (map(terms.get, map(seg.doc_ids.__getitem__, at),
                                 itertools.repeat(1))
                             if terms else itertools.repeat(1)))))
                self._deferred_entries = []
        return self._version_map

    @version_map.setter
    def version_map(self, value: Dict[str, VersionEntry]) -> None:
        with self._lock:
            self._deferred_entries = []
            self._version_map = value

    def defer_version_entries(self, seg: Segment,
                              terms: Optional[Dict[str, int]] = None) -> None:
        """Enter ``seg``'s live docs into the version map on its first
        read (their lives taken now), each with its primary term from
        ``terms`` (default 1)."""
        with self._lock:
            self._deferred_entries.append(
                (seg, np.flatnonzero(seg.live[: seg.num_docs]), terms))

    def _stamp_owner(self, seg: Segment) -> None:
        """The ledger owner of a segment and of its nested sub-segments."""
        if self.index_name is not None and seg.owner_index != self.index_name:
            seg.owner_index = self.index_name
            for nctx in seg.nested.values():
                self._stamp_owner(nctx.segment)

    def _new_builder(self) -> SegmentBuilder:
        self._segment_counter += 1
        return SegmentBuilder(f"{self._segment_prefix}_{self._segment_counter}",
                              device=self.device, index_sort=self.index_sort)

    def _next_seqno(self) -> int:
        self._seqno += 1
        self._local_checkpoint = self._seqno  # single writer: contiguous
        return self._seqno

    @property
    def max_seqno(self) -> int:
        return self._seqno

    @property
    def local_checkpoint(self) -> int:
        return self._local_checkpoint

    def note_external_seqno(self, seqno: int) -> None:
        """An op that carries its seqno (translog replay, recovery)."""
        self._seqno = max(self._seqno, seqno)
        self._local_checkpoint = self._seqno

    def _stale(self, existing: Optional[VersionEntry], seqno: Optional[int],
               primary_term: int) -> bool:
        """A replayed op older than what the version map holds for its id
        (a newer op, or a delete tombstone, already applied): skipped.
        Equal seqnos break by primary term."""
        return (seqno is not None and existing is not None
                and (existing.seqno > seqno
                     or (existing.seqno == seqno
                         and existing.term >= primary_term)))

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def index(self, doc_id: str, source: dict, routing: Optional[str] = None,
              version: Optional[int] = None, op_type: str = "index",
              seqno: Optional[int] = None, add_to_translog: bool = True,
              replicated_version: Optional[int] = None,
              primary_term: int = 1, parent: Optional[str] = None) -> dict:
        """Index one document (create or update). Returns
        {_id, _version, _seq_no, result: created|updated|noop}.
        ``parent``: the doc's legacy _parent value, kept with it in the
        translog and the segment.

        ``seqno`` and ``replicated_version``: a replayed op keeps the
        seqno and version it was assigned, with no version check; one
        that is stale against the version map is a no-op."""
        with self._lock:
            existing = self.version_map.get(doc_id)
            if self._stale(existing, seqno, primary_term):
                self.note_external_seqno(seqno)
                return {"_id": doc_id, "_version": existing.version,
                        "_seq_no": seqno, "result": "noop"}
            current_version = (
                existing.version if existing and not existing.deleted else 0)
            if op_type == "create" and existing is not None and not existing.deleted:
                raise VersionConflictEngineException(doc_id, current_version, 0)
            if version is not None and current_version != version:
                raise VersionConflictEngineException(doc_id, current_version, version)
            new_version = (replicated_version if replicated_version is not None
                           else current_version + 1)
            # the seqno is taken before parsing, as in the JAX package: a
            # document that fails to parse still uses one up
            if seqno is None:
                seqno = self._next_seqno()
            else:
                self.note_external_seqno(seqno)
            parsed = self.mapper_service.parse_document(doc_id, source, routing)
            created = existing is None or existing.deleted
            if existing is not None and not existing.deleted:
                self._tombstone(existing)
            local_doc = self.buffer.add_document(parsed, seqno, new_version,
                                                 parent=parent)
            self.version_map[doc_id] = VersionEntry(
                new_version, seqno, None, local_doc, term=primary_term)
            if add_to_translog and self.translog is not None:
                self.translog.add(TranslogOp(
                    TranslogOp.INDEX, seqno, doc_id, source, routing,
                    new_version, primary_term, parent=parent))
            self.indexing_total += 1
            return {
                "_id": doc_id,
                "_version": new_version,
                "_seq_no": seqno,
                "result": "created" if created else "updated",
            }

    def delete(self, doc_id: str, version: Optional[int] = None,
               seqno: Optional[int] = None, add_to_translog: bool = True,
               replicated_version: Optional[int] = None,
               primary_term: int = 1) -> dict:
        with self._lock:
            existing = self.version_map.get(doc_id)
            if self._stale(existing, seqno, primary_term):
                self.note_external_seqno(seqno)
                return {"_id": doc_id, "_version": existing.version,
                        "_seq_no": seqno, "result": "noop",
                        "found": not existing.deleted}
            found = existing is not None and not existing.deleted
            current_version = existing.version if found else 0
            if version is not None and current_version != version:
                raise VersionConflictEngineException(
                    doc_id, current_version, version)
            if seqno is None:
                seqno = self._next_seqno()
            else:
                self.note_external_seqno(seqno)
            new_version = (replicated_version if replicated_version is not None
                           else current_version + 1)
            if found:
                self._tombstone(existing)
                self.version_map[doc_id] = VersionEntry(
                    new_version, seqno, existing.segment, existing.local_doc,
                    deleted=True, term=primary_term)
            else:
                # a tombstone even for a missing doc: the staleness guard
                # needs it to refuse an older index op replayed after it
                self.version_map[doc_id] = VersionEntry(
                    new_version, seqno, None, -1, deleted=True,
                    term=primary_term)
            if add_to_translog and self.translog is not None:
                self.translog.add(TranslogOp(
                    TranslogOp.DELETE, seqno, doc_id, version=new_version,
                    primary_term=primary_term))
            self.delete_total += 1
            return {
                "_id": doc_id,
                "_version": new_version,
                "_seq_no": seqno,
                "result": "deleted" if found else "not_found",
                "found": found,
            }

    def _tombstone(self, entry: VersionEntry) -> None:
        if entry.segment is None:
            self._buffer_deletes.add(entry.local_doc)
        else:
            self._pending_seg_deletes.append((entry.segment, entry.local_doc))

    def adopt_segment(self, seg: Segment) -> None:
        """Add a sealed segment built elsewhere (``Segment.from_arrays``),
        the way store recovery adopts a loaded segment: it becomes
        searchable at once, and its live docs enter the version map on
        the map's first read."""
        if seg.device != self.device:
            raise ValueError(
                f"segment [{seg.name}] lives on {seg.device}, the engine on "
                f"{self.device}")
        with self._lock:
            self._stamp_owner(seg)
            self.defer_version_entries(seg)
            if seg.num_docs:
                self.note_external_seqno(int(seg.seqnos.max()))
            self.segments.append(seg)

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def get(self, doc_id: str, realtime: bool = True) -> GetResult:
        with self._lock:
            entry = self.version_map.get(doc_id)
            if entry is None or entry.deleted:
                return GetResult(False, doc_id)
            if entry.segment is None:
                if not realtime:
                    return GetResult(False, doc_id)
                return GetResult(
                    True, doc_id,
                    source=self.buffer.sources[entry.local_doc],
                    version=entry.version, seqno=entry.seqno,
                    routing=self.buffer.routings[entry.local_doc])
            for seg in self.segments:
                if seg.name == entry.segment:
                    return GetResult(
                        True, doc_id, source=seg.sources[entry.local_doc],
                        version=entry.version, seqno=entry.seqno,
                        routing=seg.routings[entry.local_doc])
            return GetResult(False, doc_id)

    def searchable_segments(self) -> List[Segment]:
        with self._lock:
            segs = [s for s in self.segments
                    if s.live_doc_count > 0 or s.num_docs == 0]
            for s in segs:
                # stamped before any lazy staging runs
                self._stamp_owner(s)
            if self.postings_codec is not None:
                for s in segs:
                    # the index's postings-codec preference
                    # (index.search.pallas.postings_codec, and the node's
                    # search.pallas.postings_codec behind "default"),
                    # consulted when the segment stages its kernel tables:
                    # a changed setting reaches segments staged after it
                    s.postings_codec = self.postings_codec
                    s.postings_codec_default = self.postings_codec_default
            return segs

    @property
    def num_docs(self) -> int:
        """Live, searchable doc count (excludes the unrefreshed buffer)."""
        return sum(s.live_doc_count for s in self.segments)

    def stats(self) -> dict:
        """Doc, write, refresh, flush, segment, translog and seqno
        counters (the JAX engine's ``stats``; the translog's is None
        without a data path)."""
        with self._lock:
            return {
                "docs": {"count": self.num_docs,
                         "buffered": (self.buffer.num_docs
                                      - len(self._buffer_deletes))},
                "indexing": {"index_total": self.indexing_total,
                             "delete_total": self.delete_total},
                "refresh": {"total": self.refresh_count},
                "flush": {"total": self.flush_count},
                "segments": {"count": len(self.segments),
                             "memory_in_bytes": sum(
                                 s.memory_bytes() for s in self.segments)},
                "translog": (self.translog.stats()
                             if self.translog is not None else None),
                "seq_no": {"max_seq_no": self.max_seqno,
                           "local_checkpoint": self.local_checkpoint},
            }

    def close(self) -> None:
        """Release every segment's device arrays and fielddata breaker
        bytes (the index closed) and sync and close the translog."""
        with self._lock:
            for seg in self.segments:
                seg.release_breaker_charges()
                seg.release_device()
            if self.translog is not None:
                self.translog.close()

    # ------------------------------------------------------------------
    # Refresh
    # ------------------------------------------------------------------

    def refresh(self) -> bool:
        """Seal the buffer into a searchable segment and apply buffered
        sealed-segment deletes (the NRT reader swap)."""
        with self._lock:
            self.refresh_count += 1
            applied_deletes = bool(self._pending_seg_deletes)
            if applied_deletes:
                by_seg: Dict[str, list] = {}
                for seg_name, local in self._pending_seg_deletes:
                    by_seg.setdefault(seg_name, []).append(local)
                for seg in self.segments:
                    locals_ = by_seg.get(seg.name)
                    if locals_:
                        seg.delete_docs(np.asarray(locals_, dtype=np.int64))
                self._pending_seg_deletes = []
            if self.buffer.num_docs == 0:
                if applied_deletes:
                    self.visibility_epoch += 1
                    self._fire_refresh_listeners()
                return applied_deletes
            seg = self.buffer.seal()
            self._stamp_owner(seg)
            # an index sort permuted the docs at seal: the buffered deletes
            # and the version map hold pre-seal local docs
            remap = self.buffer.seal_doc_remap
            for local_doc in self._buffer_deletes:
                seg.delete_doc(int(remap[local_doc]) if remap is not None
                               else local_doc)
            for entry in self.version_map.values():
                if entry.segment is None and entry.local_doc >= 0:
                    entry.segment = seg.name
                    if remap is not None:
                        entry.local_doc = int(remap[entry.local_doc])
            self.segments.append(seg)
            self.buffer = self._new_builder()
            self._buffer_deletes = set()
            self.visibility_epoch += 1
            self._fire_refresh_listeners()
            return True

    def _fire_refresh_listeners(self) -> None:
        for listener in self._refresh_listeners:
            listener()
        self._refresh_listeners = []

    def add_refresh_listener(self, listener) -> None:
        """``refresh=wait_for``: fire ``listener`` once the pending ops are
        visible, at once when nothing is pending (neither buffered docs
        nor deletes against sealed segments), else at the next refresh."""
        with self._lock:
            if self.buffer.num_docs == 0 and not self._pending_seg_deletes:
                listener()
            else:
                self._refresh_listeners.append(listener)

    # ------------------------------------------------------------------
    # Flush / merge / translog replay
    # ------------------------------------------------------------------

    def flush(self, sync_id: Optional[str] = None) -> None:
        """Refresh, write a commit point covering every op, then trim the
        translog (InternalEngine.flush). ``sync_id`` stamps the commit
        with a synced-flush marker."""
        with self._lock:
            self.refresh()
            if self.store is not None:
                self.store.commit(self.segments, self.max_seqno,
                                  self.version_map, sync_id=sync_id)
            if self.translog is not None:
                self.translog.mark_committed(self.max_seqno)
                self.translog.roll_generation()
            self.flush_count += 1

    def synced_flush(self) -> str:
        """Flush with a fresh synced-flush marker: the commit then covers
        every acked op, and a restart over it replays no translog op."""
        sync_id = _uuid.uuid4().hex
        self.flush(sync_id=sync_id)
        return sync_id

    def force_merge(self, stage_reason: str = "refresh") -> None:
        """Rebuild the live docs into one segment from their stored
        sources (expunges deletes). The retired segments drop their
        device arrays and ledger bytes; the merged one stages lazily, and
        ``stage_reason`` classifies its first staging in the ledger's
        event ring ("refresh", or "compaction" for the compaction pass):
        it restages the retired segments' corpus."""
        with self._lock:
            self.refresh()
            builder = self._new_builder()
            for seg in self.segments:
                for local in np.flatnonzero(seg.live[: seg.num_docs]):
                    local = int(local)
                    doc_id = seg.doc_ids[local]
                    parsed = self.mapper_service.parse_document(
                        doc_id, seg.sources[local], seg.routings[local])
                    seqno = int(seg.seqnos[local])
                    version = int(seg.versions[local])
                    new_local = builder.add_document(
                        parsed, seqno, version, parent=seg.parents[local])
                    old = self.version_map.get(doc_id)
                    self.version_map[doc_id] = VersionEntry(
                        version, seqno, builder.name, new_local,
                        term=old.term if old is not None else 1)
            merged = builder.seal()
            remap = builder.seal_doc_remap
            if remap is not None:
                for entry in self.version_map.values():
                    if entry.segment == builder.name:
                        entry.local_doc = int(remap[entry.local_doc])
            for old_seg in self.segments:
                old_seg.release_breaker_charges()
                old_seg.release_device()
            def mark_restage(seg: Segment) -> None:
                seg.stage_reason_initial = stage_reason
                for nctx in seg.nested.values():
                    mark_restage(nctx.segment)

            mark_restage(merged)
            self._stamp_owner(merged)
            self.segments = [merged] if merged.num_docs else []

    def recover_from_translog(self) -> int:
        """Replay the uncommitted translog ops (engine open after a
        restart or a crash); returns how many were replayed."""
        if self.translog is None:
            return 0
        ops = self.translog.uncommitted_ops()
        for op in ops:
            if op.op_type == TranslogOp.INDEX:
                self.index(op.doc_id, op.source, op.routing, seqno=op.seqno,
                           add_to_translog=False,
                           replicated_version=op.version,
                           primary_term=op.primary_term, parent=op.parent)
            elif op.op_type == TranslogOp.DELETE:
                self.delete(op.doc_id, seqno=op.seqno, add_to_translog=False,
                            replicated_version=op.version,
                            primary_term=op.primary_term)
        if ops:
            self.refresh()
        return len(ops)
