"""The per-shard write engine: buffer + segments + version map, in memory.

Counterpart of ``elasticsearch_tpu/index/engine.py`` (InternalEngine with
Lucene's IndexWriter replaced by the block-packing ``SegmentBuilder``):

- ``index()``: version-check against the version map, assign a seqno,
  buffer the doc.
- ``refresh()``: seal the buffer into an immutable Segment on the
  engine's device and apply buffered deletes — searches see only sealed
  segments.
- updates/deletes tombstone the old doc; against a sealed segment the
  tombstone becomes search-visible at the next refresh.
- realtime GET reads unrefreshed docs straight from the buffer.

The translog, the store and flush are later slices (the JAX ``Node()``
without ``data_path`` keeps nothing on disk either).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.errors import VersionConflictEngineException
from elasticsearch_tpu_torch.index.segment import Segment, SegmentBuilder


@dataclass
class VersionEntry:
    version: int
    seqno: int
    # where the doc lives: segment name, or None while still in the buffer
    segment: Optional[str]
    local_doc: int
    deleted: bool = False


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
                 device="cuda"):
        self.shard_id = shard_id
        self.mapper_service = mapper_service
        self.device = resolve_device(device)
        self._segment_prefix = segment_prefix
        self._segment_counter = 0
        self.segments: List[Segment] = []
        self.buffer = self._new_builder()
        self._buffer_deletes: set = set()
        # deletes against sealed segments, applied at the next refresh
        self._pending_seg_deletes: List[tuple] = []
        self.version_map: Dict[str, VersionEntry] = {}
        self._seqno = -1
        self._lock = threading.RLock()
        self.refresh_count = 0
        # postings-codec preference stamped on each searchable segment
        # (IndexService sets both from the index settings)
        self.postings_codec: Optional[str] = None
        self.postings_codec_default: Optional[str] = None

    def _new_builder(self) -> SegmentBuilder:
        self._segment_counter += 1
        return SegmentBuilder(f"{self._segment_prefix}_{self._segment_counter}",
                              device=self.device)

    def _next_seqno(self) -> int:
        self._seqno += 1
        return self._seqno

    @property
    def max_seqno(self) -> int:
        return self._seqno

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def index(self, doc_id: str, source: dict, routing: Optional[str] = None,
              version: Optional[int] = None, op_type: str = "index") -> dict:
        """Index one document (create or update). Returns
        {_id, _version, _seq_no, result: created|updated}."""
        with self._lock:
            existing = self.version_map.get(doc_id)
            current_version = (
                existing.version if existing and not existing.deleted else 0)
            if op_type == "create" and existing is not None and not existing.deleted:
                raise VersionConflictEngineException(doc_id, current_version, 0)
            if version is not None and current_version != version:
                raise VersionConflictEngineException(doc_id, current_version, version)
            new_version = current_version + 1
            # the seqno is taken before parsing, as in the JAX package: a
            # document that fails to parse still uses one up
            seqno = self._next_seqno()
            parsed = self.mapper_service.parse_document(doc_id, source, routing)
            created = existing is None or existing.deleted
            if existing is not None and not existing.deleted:
                self._tombstone(existing)
            local_doc = self.buffer.add_document(parsed, seqno, new_version)
            self.version_map[doc_id] = VersionEntry(
                new_version, seqno, None, local_doc)
            return {
                "_id": doc_id,
                "_version": new_version,
                "_seq_no": seqno,
                "result": "created" if created else "updated",
            }

    def delete(self, doc_id: str, version: Optional[int] = None) -> dict:
        with self._lock:
            existing = self.version_map.get(doc_id)
            found = existing is not None and not existing.deleted
            current_version = existing.version if found else 0
            if version is not None and current_version != version:
                raise VersionConflictEngineException(
                    doc_id, current_version, version)
            seqno = self._next_seqno()
            new_version = current_version + 1
            if found:
                self._tombstone(existing)
                self.version_map[doc_id] = VersionEntry(
                    new_version, seqno, existing.segment, existing.local_doc,
                    deleted=True)
            else:
                self.version_map[doc_id] = VersionEntry(
                    new_version, seqno, None, -1, deleted=True)
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
        the way store recovery adopts a loaded segment: its live docs
        enter the version map and it becomes searchable at once."""
        if seg.device != self.device:
            raise ValueError(
                f"segment [{seg.name}] lives on {seg.device}, the engine on "
                f"{self.device}")
        with self._lock:
            for local in np.flatnonzero(seg.live[: seg.num_docs]):
                local = int(local)
                self.version_map[seg.doc_ids[local]] = VersionEntry(
                    int(seg.versions[local]), int(seg.seqnos[local]),
                    seg.name, local)
            if seg.num_docs:
                self._seqno = max(self._seqno, int(seg.seqnos.max()))
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

    def close(self) -> None:
        """Release every segment's device arrays (the index closed)."""
        with self._lock:
            for seg in self.segments:
                seg.release_device()

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
                return applied_deletes
            seg = self.buffer.seal()
            for local_doc in self._buffer_deletes:
                seg.delete_doc(local_doc)
            for entry in self.version_map.values():
                if entry.segment is None and entry.local_doc >= 0:
                    entry.segment = seg.name
            self.segments.append(seg)
            self.buffer = self._new_builder()
            self._buffer_deletes = set()
            return True
