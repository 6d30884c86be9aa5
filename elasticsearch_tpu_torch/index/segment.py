"""Immutable block-packed segments, staged as tensors on one device.

Counterpart of ``elasticsearch_tpu/index/segment.py``:

- Postings are block-packed dense arrays: every term's postings are padded
  to multiples of BLOCK=128 docs in one ``[n_blocks, 128]`` int32 matrix
  (``block_docs``, padding = nd_pad) with tfs beside it.
- Norms are exact float32 per-field doc-length columns
  (``[n_norm_fields, nd_pad + 1]``, last column 1).
- Doc values are columnar: numerics as float64 CSR (value, doc) pairs,
  keywords as ordinal CSR against a sorted per-field term list.
- Dense vectors are one ``[nd_pad, dims]`` column per field, rounded to
  the bf16 grid once at seal (``VectorColumn``).
- Geo points are float32 (lat, lon) CSR columns (``GeoColumn``); a range
  field is two aligned numeric columns ``<f>#lo`` / ``<f>#hi``.
- Geo shapes stay raw a doc (``shapes``: field -> {doc: [GeoJSON / WKT]});
  ``shape_column`` builds on first use a float64 ``[nd_pad, 4]`` bbox
  table (NaN where a doc has none), which the ``geo_shape`` query stages
  on the device for its prefilter, and parses a doc's shapes into
  geometry objects when a query first reads them (its candidates).
- Stored fields (_source) stay on the host.

``device_arrays()`` stages the query tables on the segment's device once:
the base tables (postings, norms, live masks) and the tile-scoring
kernel's tables in the segment's postings codec (raw: padded docs and
per-posting BM25 norm factors; packed: one bit-packed word a posting),
with the live mask in tile layout. The codec follows the preference its
engine stamps (``postings_codec``, the index setting, and
``postings_codec_default``, the node's), resolved against the segment's
doc space (``tile_scoring.resolve_postings_codec``). ``ensure_vector_staged`` stages a vector field's bf16
embeddings (and the cosine inverse norms) on first use.

Every staged tensor registers in the device-memory ledger
(``common/memory.py``) under the segment's scope (``ledger_scope``) and
the index that owns it (``owner_index``, stamped by the engine): the base
postings (``postings_raw``), norms (``scale_norm``), every live-mask
layout (``live_mask``), the kernel posting tables in each codec staged
(``postings_raw`` / ``postings_packed``) with their block bounds
(``bound_tables``: host arrays, counted as the JAX package counts them),
the embeddings and inverse norms (``embeddings`` / ``scale_norm``) and
doc-value columns (``doc_values``). The scope is evictable: over the HBM
budget the accountant drops the segment's stagings, which restage lazily.
Each staging runs its transfer group through ``common/staging.run_staged``
(transient faults retry, the fault-injection hook sits just before the
transfers) and publishes only after every transfer landed; a terminal
fault raises to the caller (the port has no scatter engine to fall back
to). ``release_device`` returns the scope's bytes.

``positions`` holds each term's positions per doc (``{term_id: {doc:
int32 array}}``, the analyzer's token index), as the JAX segment keeps
them for phrase queries; the store writes and reads them. A phrase query
reads one term's run at a time (``SegmentPositions.term_run``).
``term_ttf`` (a term's total frequency, for the DFR, IB and LM
similarities) sums its tf blocks on first use, cached per term.

``nested`` maps each nested path to a ``NestedContext``: the path's
objects as a sub-segment of their own (a ``Segment``, with its own
ledger scope under the same owner, staged when a nested clause first
runs on it) and ``parent_of`` / ``offset_of``, each object's enclosing
doc and its index in the doc's array. Deleting a doc tombstones its
objects at every level (``delete_docs``); ``release_device`` and
``release_breaker_charges`` recurse. ``parents`` holds each doc's legacy
``_parent`` value.

An index sort (``index.sort.*``, ``index/index_sort.py``) permutes the
builder's docs at seal (``SegmentBuilder(index_sort=...)``): doc order is
then sort order in every array, and ``seal_doc_remap`` maps each
pre-seal local doc to its sealed one for the engine's version map and
buffered deletes.

``PinnedSegmentView`` is a scroll's point-in-time view of a segment: the
segment's immutable tensors, its own frozen live mask and live tensors,
and pinned views of its nested sub-segments.

``breaker_charges`` holds the fielddata breaker bytes charged for what an
aggregation built on the segment's host (text fielddata);
``release_breaker_charges`` gives them back when the segment is dropped
(a merge retires it, its shard closes, its index is deleted).
"""

from __future__ import annotations

import bisect
import itertools
import json
import threading
import time as _time
from array import array
from collections import Counter
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.memory import (
    KIND_BOUND_TABLES,
    KIND_DOC_VALUES,
    KIND_EMBEDDINGS,
    KIND_LIVE_MASK,
    KIND_POSTINGS_RAW,
    KIND_SCALE_NORM,
    memory_accountant,
)
from elasticsearch_tpu_torch.common.staging import run_staged
from elasticsearch_tpu_torch.ops import knn_scoring as knn
from elasticsearch_tpu_torch.ops import tile_scoring as tsc

BLOCK = 128  # posting block width

# Field-name separator in composite term keys ("field\x1ftoken").
FIELD_SEP = "\x1f"


def next_pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


@dataclass
class NumericColumn:
    """CSR numeric doc values + dense sort columns (host numpy)."""

    flat_values: np.ndarray  # [n_vals] float64, padded with 0
    flat_docs: np.ndarray  # [n_vals] int32, padded with sentinel doc
    first_value: np.ndarray  # [nd_pad] float64 (first value per doc, 0 if missing)
    min_value: np.ndarray  # [nd_pad] float64
    max_value: np.ndarray  # [nd_pad] float64
    exists: np.ndarray  # [nd_pad] bool
    count: int  # real number of values


@dataclass
class OrdinalColumn:
    """String doc values as ordinals against a sorted term list."""

    terms: List[str]  # sorted unique values; ordinal = index
    flat_ords: np.ndarray  # [n_vals] int32
    flat_docs: np.ndarray  # [n_vals] int32
    first_ord: np.ndarray  # [nd_pad] int32, -1 if missing
    exists: np.ndarray  # [nd_pad] bool
    count: int

    def ord_of(self, term: str) -> int:
        i = bisect.bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return -1

    def ord_range(self, lo: Optional[str], hi: Optional[str],
                  include_lo: bool, include_hi: bool) -> Tuple[int, int]:
        """[lo_ord, hi_ord) half-open ordinal range for a term range query."""
        lo_ord = 0
        if lo is not None:
            lo_ord = (bisect.bisect_left(self.terms, lo) if include_lo
                      else bisect.bisect_right(self.terms, lo))
        hi_ord = len(self.terms)
        if hi is not None:
            hi_ord = (bisect.bisect_right(self.terms, hi) if include_hi
                      else bisect.bisect_left(self.terms, hi))
        return lo_ord, hi_ord


@dataclass
class GeoColumn:
    """Geo-point doc values: float32 (lat, lon) pairs in CSR, padded to a
    power of two with the sentinel doc, plus each doc's first point."""

    lat: np.ndarray  # [n_vals] float32, padded with 0
    lon: np.ndarray  # [n_vals] float32, padded with 0
    flat_docs: np.ndarray  # [n_vals] int32, padded with the sentinel doc
    first_lat: np.ndarray  # [nd_pad] float32
    first_lon: np.ndarray  # [nd_pad] float32
    exists: np.ndarray  # [nd_pad] bool
    count: int


@dataclass
class VectorColumn:
    """Dense-vector doc values: one fixed-dimension embedding per doc.
    ``vectors`` is the host mirror on the bf16 grid, kept as f32 (what the
    device stages as bf16 and the kNN kernel decodes)."""

    vectors: np.ndarray  # [nd_pad, dims] f32, bf16-grid values, 0 = missing
    exists: np.ndarray  # [nd_pad] bool
    dims: int
    count: int  # docs carrying a vector


@dataclass
class NestedContext:
    """A nested path's sub-segment and its join to the enclosing docs: the
    nested objects are the rows of a segment of their own (columns keyed
    by full path), ``parent_of`` points each at its enclosing doc, and a
    nested clause joins by a scatter over it."""

    segment: "Segment"
    parent_of: np.ndarray  # [n_objs] int32 local doc in the enclosing segment
    offset_of: np.ndarray  # [n_objs] int32 index within the parent's array


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class SegmentPositions(Mapping):
    """A segment's phrase positions, ``{term_id: {doc: int32 array}}``,
    read a term at a time from what the segment was made of: a sealed
    segment's three flat int32 columns sorted by (term, doc, position)
    (``from_flat``), or a store's ``positions.json`` bytes as read
    (``from_json_bytes``, parsed on the first access). ``term_run(tid)``
    slices one term's (docs, positions) run out of the flat columns with a
    ``np.searchsorted`` on the term column, and ``tid in`` / ``[tid]``
    build that term's nested form alone, cached per term: a phrase query
    decodes the two or three terms it reads, never the whole segment.
    ``json_bytes`` gives the store's form without building the nested
    arrays (a loaded segment's bytes as they were read)."""

    # the int64 phrase keys kept per segment (the hottest terms of recent
    # phrases)
    KEYS_CACHE_BYTES = 64 << 20

    def __init__(self, flat=None, text: Optional[bytes] = None):
        self._flat = flat
        self._text = text
        self._raw: Optional[dict] = None
        self._terms: Dict[int, Dict[int, np.ndarray]] = {}
        self._runs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._keys: Dict[int, np.ndarray] = {}
        self._keys_bytes = 0
        self._tids: Optional[List[int]] = None

    @classmethod
    def from_flat(cls, tids: np.ndarray, docs: np.ndarray,
                  at: np.ndarray) -> "SegmentPositions":
        return cls(flat=(np.asarray(tids, np.int32),
                         np.asarray(docs, np.int32),
                         np.asarray(at, np.int32)))

    @classmethod
    def from_json_bytes(cls, text: bytes) -> "SegmentPositions":
        return cls(text=text)

    @classmethod
    def from_mapping(cls, positions: Mapping) -> "SegmentPositions":
        """From ``{term_id: {doc: positions}}``: the flat columns, sorted
        by (term, doc, position)."""
        tids, docs, at = [], [], []
        for tid, per_doc in sorted((int(t), d) for t, d in positions.items()):
            for doc, pos in sorted((int(d), p) for d, p in per_doc.items()):
                pos = np.sort(np.asarray(pos, np.int32))
                tids.append(np.full(len(pos), tid, np.int32))
                docs.append(np.full(len(pos), doc, np.int32))
                at.append(pos)
        if not at:
            return cls.from_flat(*(np.zeros(0, np.int32),) * 3)
        return cls.from_flat(np.concatenate(tids), np.concatenate(docs),
                             np.concatenate(at))

    def term_run(self, tid: int) -> Tuple[np.ndarray, np.ndarray]:
        """One term's (docs, positions) int32 columns, sorted by (doc,
        position); empty when the term has no positions."""
        tid = int(tid)
        run = self._runs.get(tid)
        if run is None:
            if self._flat is not None:
                tids, docs, at = self._flat
                # needles of the column's dtype: int64 needles would make
                # numpy convert the whole column on every call
                lo, hi = np.searchsorted(
                    tids, np.asarray([tid, tid + 1], tids.dtype))
                run = (docs[lo:hi], at[lo:hi])
            else:
                per_doc = self.json_dict().get(str(tid), {}) \
                    if self._text is not None else {}
                keys = sorted(per_doc, key=int)
                lens = [len(per_doc[k]) for k in keys]
                run = (np.repeat(np.asarray([int(k) for k in keys], np.int32),
                                 lens),
                       np.asarray([p for k in keys for p in per_doc[k]],
                                  np.int32))
            self._runs[tid] = run
        return run

    def term_keys(self, tid: int) -> np.ndarray:
        """One term's positions as int64 keys ``doc << 32 | position``,
        ascending: what a phrase intersection searches. The keys of the
        terms read last are kept, up to ``KEYS_CACHE_BYTES``."""
        tid = int(tid)
        keys = self._keys.pop(tid, None)
        if keys is None:
            docs, at = self.term_run(tid)
            keys = (docs.astype(np.int64) << 32) | at.astype(np.int64)
            self._keys_bytes += keys.nbytes
            while self._keys and self._keys_bytes > self.KEYS_CACHE_BYTES:
                self._keys_bytes -= self._keys.pop(
                    next(iter(self._keys))).nbytes
        self._keys[tid] = keys  # the newest last
        return keys

    def _term(self, tid: int) -> Dict[int, np.ndarray]:
        nested = self._terms.get(tid)
        if nested is None:
            docs, at = self.term_run(tid)
            nested = {}
            if len(docs):
                cut = np.flatnonzero(docs[1:] != docs[:-1]) + 1
                starts = np.concatenate([[0], cut]).tolist()
                ends = np.append(cut, len(docs)).tolist()
                nested = {d: at[lo:hi] for d, lo, hi in
                          zip(docs[starts].tolist(), starts, ends)}
            self._terms[tid] = nested
        return nested

    def doc_terms(self, doc: int) -> Dict[int, np.ndarray]:
        """``{term_id: positions}`` of one doc (a term vector), term ids
        ascending: one mask over the flat doc column, or a walk of the
        store's form."""
        if self._flat is not None:
            tids, docs, at = self._flat
            sel = np.flatnonzero(docs == doc)
            out: Dict[int, np.ndarray] = {}
            for tid in np.unique(tids[sel]).tolist():
                out[tid] = at[sel[tids[sel] == tid]]
            return out
        if self._text is None:
            return {}
        key = str(int(doc))
        return {int(t): np.asarray(per_doc[key], np.int32)
                for t, per_doc in sorted(self.json_dict().items(),
                                         key=lambda kv: int(kv[0]))
                if key in per_doc}

    def term_ids(self) -> List[int]:
        """The term ids that hold positions, ascending."""
        if self._tids is None:
            if self._flat is not None:
                self._tids = np.unique(self._flat[0]).tolist()
            elif self._text is not None:
                self._tids = sorted(int(t) for t in self.json_dict())
            else:
                self._tids = []
        return self._tids

    def json_bytes(self) -> bytes:
        """The store's ``positions.json`` bytes."""
        if self._text is not None:
            return self._text
        # json.dumps, not json.dump: one pass of the C encoder
        return json.dumps(self.json_dict()).encode("utf-8")

    def json_dict(self) -> dict:
        """``{str(term_id): {str(doc): [positions]}}``, the store's form."""
        if self._text is not None:
            if self._raw is None:
                self._raw = json.loads(self._text)
            return self._raw
        tids, docs, at = self._flat
        if not len(tids):
            return {}
        # one (term, doc) run a group, one term run a dict: built with
        # C-level maps and zips, no Python statement a (term, doc)
        cut = np.flatnonzero((tids[1:] != tids[:-1])
                             | (docs[1:] != docs[:-1])) + 1
        starts = np.concatenate([[0], cut])
        ends = np.append(cut, len(tids))
        at_l = at.tolist()
        runs = list(map(at_l.__getitem__, map(slice, starts.tolist(),
                                              ends.tolist())))
        doc_keys = list(map(str, docs[starts].tolist()))
        g_tids = tids[starts]
        tcut = np.flatnonzero(g_tids[1:] != g_tids[:-1]) + 1
        t_lo = np.concatenate([[0], tcut]).tolist()
        t_hi = np.append(tcut, len(g_tids)).tolist()
        return {str(int(g_tids[lo])): dict(zip(doc_keys[lo:hi], runs[lo:hi]))
                for lo, hi in zip(t_lo, t_hi)}

    def __getitem__(self, tid):
        nested = self._term(int(tid))
        if not nested:
            raise KeyError(tid)
        return nested

    def __iter__(self):
        return iter(self.term_ids())

    def __len__(self):
        return len(self.term_ids())


def tensor_bytes(t: torch.Tensor) -> int:
    """A staged tensor's bytes as the ledger counts them."""
    return int(t.numel() * t.element_size())


# generation-unique ledger scopes: a segment name can come back (a store
# reload), its staging history must not
_LEDGER_SEQ = itertools.count(1)


class _ParsedShapes:
    """doc -> its parsed geo shapes, each doc's parsed on first read (a
    query's exact relation reads only its prefilter's candidates)."""

    def __init__(self, per_doc: Dict[int, list]):
        self._raw = per_doc
        self._parsed: Dict[int, list] = {}

    def __getitem__(self, doc: int) -> list:
        gs = self._parsed.get(doc)
        if gs is None:
            from elasticsearch_tpu_torch.utils.geometry import parse_shape

            gs = self._parsed[doc] = [parse_shape(v) for v in self._raw[doc]]
        return gs


class Segment:
    """An immutable sealed segment: host numpy arrays, staged once to
    ``device`` by ``device_arrays()``."""

    def __init__(
        self,
        name: str,
        num_docs: int,
        doc_ids: Sequence[str],
        sources: Sequence[dict],
        routings: Sequence[Optional[str]],
        seqnos: np.ndarray,
        versions: np.ndarray,
        term_keys: List[str],
        term_block_start: np.ndarray,
        term_block_count: np.ndarray,
        term_doc_freq: np.ndarray,
        block_docs: np.ndarray,
        block_tfs: np.ndarray,
        field_stats: Dict[str, dict],
        field_norm_idx: Dict[str, int],
        norms: np.ndarray,
        numeric_columns: Dict[str, NumericColumn],
        ordinal_columns: Dict[str, OrdinalColumn],
        vector_columns: Optional[Dict[str, VectorColumn]] = None,
        device="cuda",
        exists_masks: Optional[Dict[str, np.ndarray]] = None,
        positions: Optional[Mapping] = None,
        geo_columns: Optional[Dict[str, GeoColumn]] = None,
        nested: Optional[Dict[str, NestedContext]] = None,
        parents: Optional[Sequence[Optional[str]]] = None,
        shapes: Optional[Dict[str, Dict[int, list]]] = None,
    ):
        self.name = name
        self.num_docs = num_docs
        self.nd_pad = next_pow2(max(num_docs, 1))
        self.doc_ids = doc_ids
        self.sources = sources
        self.routings = routings
        # the legacy _parent value of each doc (None: no parent)
        self.parents = (list(parents) if parents is not None
                        else [None] * num_docs)
        # nested path -> NestedContext (nested-in-nested paths too, each
        # joined to this segment's docs)
        self.nested: Dict[str, NestedContext] = dict(nested or {})
        self.seqnos = seqnos
        self.versions = versions
        self.term_keys = term_keys
        self.term_block_start = term_block_start
        self.term_block_count = term_block_count
        self.term_doc_freq = term_doc_freq
        self.block_docs = block_docs  # [n_blocks, BLOCK] int32, pad = nd_pad
        self.block_tfs = block_tfs  # [n_blocks, BLOCK] float32
        self.field_stats = field_stats  # field -> {"doc_count", "sum_ttf"}
        self.field_norm_idx = field_norm_idx  # text field -> norms row
        self.norms = norms  # [n_norm_fields, nd_pad + 1] float32
        self.numeric_columns = numeric_columns
        self.ordinal_columns = ordinal_columns
        self.vector_columns = vector_columns or {}
        self.geo_columns = geo_columns or {}
        # geo_shape field -> {doc: [raw GeoJSON / WKT]}; the geometry and
        # bbox table build on first use (shape_column)
        self.shapes: Dict[str, Dict[int, list]] = shapes or {}
        self._shape_cols: Dict[str, dict] = {}
        # fielddata breaker bytes charged for host structures built on this
        # segment (key -> bytes), released with the segment
        self.breaker_charges: Dict[str, int] = {}
        # term_id -> {local_doc: int32 positions}, for phrase queries
        self.positions = (positions if isinstance(positions, SegmentPositions)
                          else SegmentPositions.from_mapping(positions or {}))
        self.device = resolve_device(device)
        self.live = np.ones(self.nd_pad, dtype=bool)
        self.live[num_docs:] = False
        self._id_to_doc: Optional[Dict[str, int]] = None
        self._ttf_cache: Dict[int, int] = {}
        self._field_tokens: Dict[str, List[str]] = {}
        # a store load hands the masks it read; a sealed segment derives
        # them on first use (exists_masks)
        self._exists_masks: Optional[Dict[str, np.ndarray]] = exists_masks
        self._device: Optional[dict] = None
        # doc-value columns staged on demand (key -> tensor)
        self.dev_cache: Dict[str, Any] = {}
        # host arrays derived from the immutable columns on demand (slice
        # masks, keyword sort strings)
        self.host_cache: Dict[str, Any] = {}
        self.kernel_geom: Optional[tsc.TileGeometry] = None
        # codec -> the tile kernel's posting tables on the device, and the
        # per-block frac max of what that codec decodes
        self._kernel_tables: Dict[str, dict] = {}
        self._kernel_bfmax: Dict[str, np.ndarray] = {}
        self.kernel_bmin: Optional[np.ndarray] = None
        self.kernel_bmax: Optional[np.ndarray] = None
        # the segment's own codec and its tables' bytes and bounds, set
        # when they stage
        self.kernel_codec: Optional[str] = None
        self.kernel_postings_bytes = 0
        self.kernel_bfmax: Optional[np.ndarray] = None
        # the postings-codec preference its engine stamps
        self.postings_codec: Optional[str] = None
        self.postings_codec_default: Optional[str] = None
        self._stage_lock = threading.Lock()
        # the device-memory ledger's owner and scope; a merge product's
        # first staging is a restage of the retired segments' corpus
        # ("refresh", or "compaction" for the compaction pass)
        self.owner_index: Optional[str] = None
        self.ledger_scope = f"{name}@{next(_LEDGER_SEQ)}"
        self.stage_reason_initial = "initial"

    @classmethod
    def from_arrays(cls, name: str, *, term_keys, term_block_start,
                    term_block_count, term_doc_freq, block_docs, block_tfs,
                    norms, live, field_stats, field_norm_idx, doc_ids,
                    sources, numeric_columns=None, ordinal_columns=None,
                    vector_columns=None, geo_columns=None, routings=None,
                    seqnos=None, versions=None, exists_masks=None,
                    positions=None, nested=None, parents=None,
                    shapes=None, device="cuda") -> "Segment":
        """Build a segment from plain host arrays — the fields a store load
        hands the JAX ``Segment`` — staged later on ``device``.
        ``numeric_columns`` / ``ordinal_columns`` / ``vector_columns`` /
        ``geo_columns`` map a field to a dict of the column's arrays (the
        dataclass fields);
        vectors are taken as they are (already on the bf16 grid).
        ``exists_masks`` (field -> [nd_pad] bool) are the masks a store
        holds; without them they are derived from the columns.
        ``positions`` is a ``SegmentPositions`` or the three flat int32
        columns ``(term_ids, docs, positions)`` sorted by (term, doc,
        position), both taken as they are, or a mapping of a term id to
        ``{doc: positions}``. ``nested`` maps a nested path to the keyword
        arguments of its sub-segment's ``from_arrays`` plus ``parent_of``
        and ``offset_of`` (int32, one entry an object); ``parents`` is each
        doc's legacy ``_parent`` value; ``shapes`` maps a geo_shape field
        to ``{doc: [raw values]}``."""
        n = len(doc_ids)
        seg = cls(
            name=name, num_docs=n, doc_ids=doc_ids, sources=sources,
            routings=routings if routings is not None else [None] * n,
            seqnos=(np.asarray(seqnos, np.int64) if seqnos is not None
                    else np.zeros(n, np.int64)),
            versions=(np.asarray(versions, np.int64) if versions is not None
                      else np.ones(n, np.int64)),
            term_keys=list(term_keys),
            term_block_start=np.asarray(term_block_start, np.int32),
            term_block_count=np.asarray(term_block_count, np.int32),
            term_doc_freq=np.asarray(term_doc_freq, np.int32),
            block_docs=np.asarray(block_docs, np.int32),
            block_tfs=np.asarray(block_tfs, np.float32),
            field_stats={f: dict(s) for f, s in field_stats.items()},
            field_norm_idx=dict(field_norm_idx),
            norms=np.asarray(norms, np.float32),
            numeric_columns={f: NumericColumn(**c) for f, c in
                             (numeric_columns or {}).items()},
            ordinal_columns={f: OrdinalColumn(**c) for f, c in
                             (ordinal_columns or {}).items()},
            vector_columns={f: VectorColumn(**c) for f, c in
                            (vector_columns or {}).items()},
            geo_columns={f: GeoColumn(**c) for f, c in
                         (geo_columns or {}).items()},
            device=device,
            exists_masks=({f: np.asarray(m, bool)
                           for f, m in exists_masks.items()}
                          if exists_masks is not None else None),
            positions=(SegmentPositions.from_flat(*positions)
                       if isinstance(positions, (tuple, list)) else positions),
            parents=parents,
            shapes={f: {int(d): list(v) for d, v in per_doc.items()}
                    for f, per_doc in (shapes or {}).items()},
        )
        for path, sub in (nested or {}).items():
            sub = dict(sub)
            parent_of = np.asarray(sub.pop("parent_of"), np.int32)
            offset_of = np.asarray(sub.pop("offset_of"), np.int32)
            seg.nested[path] = NestedContext(
                cls.from_arrays(f"{name}#{path}", device=device, **sub),
                parent_of, offset_of)
        live = np.asarray(live, bool)
        seg.live[: min(len(live), seg.nd_pad)] = live[: seg.nd_pad]
        return seg

    # ------------------------------------------------------------------

    @property
    def live_doc_count(self) -> int:
        return int(self.live[: self.num_docs].sum())

    def id_to_doc(self) -> Dict[str, int]:
        if self._id_to_doc is None:
            self._id_to_doc = {i: d for d, i in enumerate(self.doc_ids)}
        return self._id_to_doc

    def delete_doc(self, local_doc: int) -> None:
        self.delete_docs(np.asarray([local_doc], dtype=np.int64))

    def delete_docs(self, locals_: np.ndarray) -> None:
        """Tombstone docs and restage every live-mask layout (live, live1,
        and each staged tile layout) if the segment is staged: each
        replacement is built first and published by swapping its dict
        entry, and the ledger records a ``delete_invalidation``."""
        if locals_.size == 0:
            return
        self.live[locals_] = False
        for nctx in self.nested.values():
            # nested objects die with their doc, at every level
            nctx.segment.delete_docs(
                np.flatnonzero(np.isin(nctx.parent_of, locals_)))
        dev = self._device
        if dev is None:
            return
        with self._stage_lock:
            t0 = _time.monotonic()
            dev["live"] = _to_device(self.live, self.device)
            dev["live1"] = _to_device(
                np.concatenate([self.live, np.zeros(1, dtype=bool)]),
                self.device)
            for key in [k for k in dev if k.startswith("k_live_t")]:
                sub = (self.kernel_geom.tile_sub if key == "k_live_t"
                       else int(key.rsplit("_", 1)[1]))
                dev[key] = self._build_live_t_device(sub)
            # the logical change is one tombstone bit a doc; the restaged
            # bytes are every dependent mask layout
            memory_accountant().note_logical_change(
                self._owner(), int(locals_.size))
            self._account_live_masks(
                dev, "delete_invalidation",
                duration_ms=(_time.monotonic() - t0) * 1000.0)

    def terms_for_field(self, field_name: str) -> List[Tuple[str, int]]:
        """All (token, term_id) of a field, in sorted token order."""
        prefix = f"{field_name}{FIELD_SEP}"
        lo = bisect.bisect_left(self.term_keys, prefix)
        hi = bisect.bisect_left(self.term_keys, prefix + "\uffff")
        return [(self.term_keys[i][len(prefix):], i) for i in range(lo, hi)]

    def field_tokens(self, field_name: str) -> List[str]:
        """A field's tokens in sorted order, cached: the term dictionary a
        multi-term query (prefix, wildcard, regexp, fuzzy) expands
        against."""
        toks = self._field_tokens.get(field_name)
        if toks is None:
            toks = self._field_tokens[field_name] = [
                t for t, _ in self.terms_for_field(field_name)]
        return toks

    def term_ttf(self, tid: int) -> int:
        """Total term frequency (the sum of the term's tfs), the collection
        statistic of the DFR, IB and LM similarities: summed from the tf
        blocks on first use, cached per term."""
        hit = self._ttf_cache.get(tid)
        if hit is None:
            start = int(self.term_block_start[tid])
            cnt = int(self.term_block_count[tid])
            hit = self._ttf_cache[tid] = int(
                self.block_tfs[start:start + cnt].sum())
        return hit

    @property
    def exists_masks(self) -> Dict[str, np.ndarray]:
        """field -> [nd_pad] bool: the docs that hold a value of the field
        (the JAX package's ``exists_masks``, built at seal from the fields
        each doc indexed): a term of it (its norms row counts the doc's
        tokens) or a doc value, vector or geo point; a range field's two
        columns give one mask under the field's name. The masks a store
        load read, or derived once from the columns."""
        masks = self._exists_masks
        if masks is None:
            masks = {}
            for f, i in self.field_norm_idx.items():
                masks[f] = self.norms[i, : self.nd_pad] > 0
            for cols in (self.numeric_columns, self.ordinal_columns,
                         self.vector_columns, self.geo_columns):
                for f, col in cols.items():
                    if f.endswith(("#lo", "#hi")):
                        f = f[:-3]
                    masks[f] = (masks[f] | col.exists if f in masks
                                else col.exists.copy())
            for f, per_doc in self.shapes.items():
                m = np.zeros(self.nd_pad, bool)
                m[list(per_doc)] = True
                masks[f] = masks[f] | m if f in masks else m
            self._exists_masks = masks
        return masks

    def shape_column(self, field_name: str) -> Optional[dict]:
        """A geo_shape field's column, built on first use: ``geoms`` (doc
        -> its parsed shapes, each doc parsed when first read), ``bbox``
        (float64 ``[nd_pad, 4]``: min_lon, min_lat, max_lon, max_lat of
        each doc's shapes together, NaN for a doc without one) and
        ``exists`` (``[nd_pad]`` bool). None when no doc of the segment
        holds the field."""
        per_doc = self.shapes.get(field_name)
        if not per_doc:
            return None
        col = self._shape_cols.get(field_name)
        if col is None:
            from elasticsearch_tpu_torch.utils.geometry import shape_bbox

            bbox = np.full((self.nd_pad, 4), np.nan, np.float64)
            exists = np.zeros(self.nd_pad, bool)
            for doc, vals in per_doc.items():
                bs = [shape_bbox(v) for v in vals]
                bbox[doc] = (min(b[0] for b in bs), min(b[1] for b in bs),
                             max(b[2] for b in bs), max(b[3] for b in bs))
                exists[doc] = True
            col = self._shape_cols[field_name] = {
                "geoms": _ParsedShapes(per_doc), "bbox": bbox,
                "exists": exists}
        return col

    def term_id(self, field_name: str, token: str) -> int:
        key = f"{field_name}{FIELD_SEP}{token}"
        i = bisect.bisect_left(self.term_keys, key)
        if i < len(self.term_keys) and self.term_keys[i] == key:
            return i
        return -1

    def field_avgdl(self, field_name: str) -> float:
        st = self.field_stats.get(field_name)
        if not st or st["doc_count"] == 0:
            return 1.0
        return max(st["sum_ttf"] / st["doc_count"], 1.0)

    # ------------------------------------------------------------------
    # Device staging
    # ------------------------------------------------------------------

    def _owner(self) -> str:
        return self.owner_index or "_unassigned"

    def _account(self, kind: str, table: str, nbytes: int,
                 reason: str = "initial", duration_ms: float = 0.0) -> None:
        """Register one staged table group under the segment's scope (one
        LRU-evictable scope for the whole segment)."""
        if reason == "initial":
            reason = self.stage_reason_initial
        memory_accountant().register(
            self._owner(), self.ledger_scope, kind, table, int(nbytes),
            reason=reason, duration_ms=duration_ms, plane="host",
            evict=self._evict_staging)

    def _account_live_masks(self, dev: dict, reason: str,
                            duration_ms: float = 0.0) -> None:
        """(Re-)register every staged live-mask layout, one ledger entry
        each."""
        for key, t in list(dev.items()):
            if key in ("live", "live1") or key.startswith("k_live_t"):
                self._account(KIND_LIVE_MASK, key, tensor_bytes(t),
                              reason=reason, duration_ms=duration_ms)

    def device_arrays(self) -> dict:
        """Stage postings, norms, live masks and the tile-scoring kernel's
        tables on the segment's device (cached)."""
        dev = self._device
        if dev is None:
            tables = self.kernel_tables()
            with self._stage_lock:
                dev = self._device
                if dev is None:
                    # the dict this staging made: an eviction may drop
                    # ``_device`` at once, and this caller still holds it
                    dev = run_staged(
                        lambda: self._stage_base_arrays(tables),
                        index=self._owner(), kind=KIND_POSTINGS_RAW,
                        plane="host")
        else:
            memory_accountant().touch(self._owner(), self.ledger_scope)
        return dev

    def kernel_tables(self, codec: Optional[str] = None) -> dict:
        """The tile kernel's posting tables on the device in ``codec``:
        ``k_docs`` and ``k_frac`` (raw, ``pad_segment_blocks``) or
        ``k_packed`` (packed, ``pack_segment_blocks``). Without ``codec``,
        the segment's own, resolved from its stamp once and set as
        ``kernel_codec`` with ``kernel_postings_bytes`` and
        ``kernel_bfmax`` (``block_frac_max`` over the frac that codec
        decodes: the dequantized one when packed). Each codec stages once
        and is shared by the host rung and the mesh plane; the mesh plane
        asks for another codec only when its stacked doc space demotes it
        to raw. Sets ``kernel_bmin`` / ``kernel_bmax``."""
        own = codec is None
        if own:
            codec = self.kernel_codec or tsc.resolve_postings_codec(
                self.postings_codec, self.nd_pad,
                self.postings_codec_default)
        tables = self._kernel_tables.get(codec)
        if tables is None or (own and self.kernel_codec is None):
            with self._stage_lock:
                tables = self._kernel_tables.get(codec)
                restaged = tables is None
                if restaged:
                    tables = self._stage_kernel_tables(codec)
                if own and (restaged or self.kernel_codec is None):
                    self.kernel_postings_bytes = sum(
                        tensor_bytes(t) for t in tables.values())
                    self.kernel_bfmax = self._kernel_bfmax[codec]
                    self.kernel_codec = codec
        return tables

    def _stage_kernel_tables(self, codec: str) -> dict:
        """One codec's posting tables (caller holds ``_stage_lock``): one
        staging attempt, retried on a transient fault."""
        kind = f"postings_{codec}"
        # a mandatory reservation (the host rung scores through these
        # tables): it may LRU-evict colder scopes, a denial never blocks it
        memory_accountant().try_reserve(
            self._owner(), self.block_docs.nbytes + self.block_tfs.nbytes,
            exclude_scope=self.ledger_scope, mandatory=True)
        return run_staged(lambda: self._stage_kernel_attempt(codec, kind),
                          index=self._owner(), kind=kind, plane="host")

    def _stage_kernel_attempt(self, codec: str, kind: str) -> dict:
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        t0 = _time.monotonic()
        frac = self._block_frac()
        bmin, bmax = self.kernel_bmin, self.kernel_bmax
        if bmin is None:
            bmin, bmax = tsc.block_min_max(
                self.block_docs, self.block_tfs, self.nd_pad)
        on_device_staging(self._owner(), kind, "k_postings")
        if codec == "packed":
            q = tsc.quantize_frac(frac)
            tables = {"k_packed": _to_device(tsc.pack_segment_blocks(
                self.block_docs, frac, self.nd_pad, q=q), self.device)}
            bfmax = tsc.block_frac_max(tsc.dequantize_frac(q))
        else:
            dp, fp = tsc.pad_segment_blocks(self.block_docs, frac, self.nd_pad)
            tables = {"k_docs": _to_device(dp, self.device),
                      "k_frac": _to_device(fp, self.device)}
            bfmax = tsc.block_frac_max(frac)
        # publish after every transfer landed; the bounds register with
        # the scope's first codec
        first_bounds = not self._kernel_tables
        self.kernel_bmin, self.kernel_bmax = bmin, bmax
        self._kernel_bfmax[codec] = bfmax
        self._kernel_tables[codec] = tables
        self._account(kind, f"k_postings.{codec}",
                      sum(tensor_bytes(t) for t in tables.values()),
                      duration_ms=(_time.monotonic() - t0) * 1000.0)
        if first_bounds:
            self._account(KIND_BOUND_TABLES, "k_bounds",
                          int(bmin.nbytes + bmax.nbytes))
        return tables

    def kernel_bfmax_for(self, codec: str) -> np.ndarray:
        """The per-block frac max of ``codec``'s tables (staged first)."""
        self.kernel_tables(codec)
        return self._kernel_bfmax[codec]

    def postings_bytes_staged(self) -> int:
        """Bytes of the kernel posting tables staged, over every codec."""
        return sum(t.numel() * t.element_size()
                   for tables in list(self._kernel_tables.values())
                   for t in tables.values())

    def _stage_base_arrays(self, tables: dict) -> dict:
        """One staging attempt of the base tables (caller holds
        ``_stage_lock``): every transfer first, then publish and
        register. Returns the staged dict."""
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        t0 = _time.monotonic()
        live1 = np.concatenate([self.live, np.zeros(1, dtype=bool)])
        on_device_staging(self._owner(), KIND_POSTINGS_RAW, "base_postings")
        staged = {
            "block_docs": _to_device(self.block_docs, self.device),
            "block_tfs": _to_device(self.block_tfs, self.device),
            "norms": _to_device(self.norms, self.device),
            "live": _to_device(self.live, self.device),
            "live1": _to_device(live1, self.device),
        }
        geom = tsc.tile_geometry(self.nd_pad)
        on_device_staging(self._owner(), KIND_LIVE_MASK, "k_live_t")
        staged["k_live_t"] = self._build_live_t_device(geom.tile_sub)
        staged.update(tables)
        self.kernel_geom = geom
        self._device = staged
        dur = (_time.monotonic() - t0) * 1000.0
        self._account(KIND_POSTINGS_RAW, "base_postings",
                      tensor_bytes(staged["block_docs"])
                      + tensor_bytes(staged["block_tfs"]), duration_ms=dur)
        self._account(KIND_SCALE_NORM, "norms", tensor_bytes(staged["norms"]))
        self._account_live_masks(staged, "initial", duration_ms=dur)
        return staged

    def _build_live_t_device(self, sub: int) -> torch.Tensor:
        return _to_device(tsc.build_live_t(
            self.live.astype(np.float32), tsc.tile_geometry(self.nd_pad, sub)),
            self.device)

    def kernel_live_t_for(self, sub: int) -> str:
        """Stage the live mask in the tile layout of a non-default
        tile_sub (queries with a dense term shrink the tile; see the
        geometry ladder in query_dsl) and return its device-dict key."""
        key = f"k_live_t_{sub}"
        dev = self.device_arrays()
        with self._stage_lock:
            if key not in dev:
                t0 = _time.monotonic()
                dev[key] = self._build_live_t_device(sub)
                # the same mask in a new layout: a geometry change
                self._account(KIND_LIVE_MASK, key, tensor_bytes(dev[key]),
                              reason="geometry_change",
                              duration_ms=(_time.monotonic() - t0) * 1000.0)
        return key

    def _block_frac(self) -> np.ndarray:
        """Per-posting BM25 norm factors, per field (a block belongs to
        exactly one term and thus one field)."""
        frac = np.zeros_like(self.block_tfs)
        for field, row in self.field_norm_idx.items():
            prefix = f"{field}{FIELD_SEP}"
            lo = bisect.bisect_left(self.term_keys, prefix)
            hi = bisect.bisect_left(self.term_keys, prefix + "￿")
            if lo >= hi:
                continue
            b0 = int(self.term_block_start[lo])
            b1 = int(self.term_block_start[hi - 1]
                     + self.term_block_count[hi - 1])
            frac[b0:b1] = tsc.compute_block_frac(
                self.block_docs[b0:b1], self.block_tfs[b0:b1],
                self.norms[row], self.field_avgdl(field))
        return frac

    def ensure_vector_staged(self, field: str, metric: str = "cosine"):
        """Stage a dense_vector field's kNN arrays on the device (once) and
        return their device-dict keys (emb bf16 [nd_pad, d_pad], the
        inverse norms f32 [nd_pad] — staged for cosine only — and exists1
        bool [nd_pad + 1]) and d_pad, or None when no doc of this segment
        carries the field. Deletes ride the live mask, so the arrays never
        restage."""
        col = self.vector_columns.get(field)
        if col is None:
            return None
        emb_key = f"k_vec_{field}"
        norm_key = f"k_vecnorm_{field}"
        exists_key = f"k_vecexists_{field}"
        dev = self.device_arrays()
        with self._stage_lock:
            if emb_key not in dev:
                d_pad = knn.pad_dims(col.dims)
                # a mandatory reservation: the host kNN rung reads these
                memory_accountant().try_reserve(
                    self._owner(), self.nd_pad * d_pad * 2,
                    exclude_scope=self.ledger_scope, mandatory=True)
                run_staged(lambda: self._stage_vector_attempt(
                    dev, col, d_pad, emb_key, exists_key),
                    index=self._owner(), kind=KIND_EMBEDDINGS, plane="host")
            if metric == "cosine" and norm_key not in dev:
                run_staged(lambda: self._stage_norm_attempt(
                    dev, col, norm_key), index=self._owner(),
                    kind=KIND_SCALE_NORM, plane="host")
        return emb_key, norm_key, exists_key, int(dev[emb_key].shape[1])

    def _stage_vector_attempt(self, dev: dict, col, d_pad: int,
                              emb_key: str, exists_key: str) -> None:
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        t0 = _time.monotonic()
        emb = torch.zeros((self.nd_pad, d_pad), dtype=torch.bfloat16)
        # the host mirror is on the bf16 grid: the cast is exact
        emb[:, : col.dims] = torch.from_numpy(
            np.ascontiguousarray(col.vectors, np.float32))
        exists1 = np.zeros(self.nd_pad + 1, bool)
        exists1[: self.nd_pad] = col.exists
        on_device_staging(self._owner(), KIND_EMBEDDINGS, emb_key)
        exists_t = _to_device(exists1, self.device)
        emb_t = emb.to(self.device)
        # publish the embeddings last: a reader that finds them finds
        # their mask too
        dev[exists_key] = exists_t
        dev[emb_key] = emb_t
        dur = (_time.monotonic() - t0) * 1000.0
        self._account(KIND_EMBEDDINGS, emb_key, tensor_bytes(emb_t),
                      duration_ms=dur)
        self._account(KIND_LIVE_MASK, exists_key, tensor_bytes(exists_t),
                      duration_ms=dur)

    def _stage_norm_attempt(self, dev: dict, col, norm_key: str) -> None:
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        inv = knn.vector_scale_column(col.vectors, "cosine")[:, 0]
        on_device_staging(self._owner(), KIND_SCALE_NORM, norm_key)
        dev[norm_key] = _to_device(inv, self.device)
        self._account(KIND_SCALE_NORM, norm_key, tensor_bytes(dev[norm_key]))

    def device_column(self, key: str, build) -> torch.Tensor:
        """Cached device staging of a doc-value array (build() -> numpy),
        registered as ``doc_values``."""
        cache = self.dev_cache
        hit = cache.get(key)
        if hit is None:
            with self._stage_lock:
                hit = cache.get(key)
                if hit is None:
                    hit = run_staged(
                        lambda: self._stage_column_attempt(cache, key, build),
                        index=self._owner(), kind=KIND_DOC_VALUES,
                        plane="host")
        return hit

    def _stage_column_attempt(self, cache: dict, key: str,
                              build) -> torch.Tensor:
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        t0 = _time.monotonic()
        arr = build()
        on_device_staging(self._owner(), KIND_DOC_VALUES, f"col:{key}")
        t = cache[key] = _to_device(arr, self.device)
        self._account(KIND_DOC_VALUES, f"col:{key}", tensor_bytes(t),
                      duration_ms=(_time.monotonic() - t0) * 1000.0)
        return t

    def clear_column_cache(self) -> int:
        """Drop the staged doc-value columns (``dev_cache``) and their
        ledger bytes, its nested sub-segments' too (``_cache/clear``); a
        query restages what it reads. Returns the bytes released."""
        with self._stage_lock:
            keys, self.dev_cache = list(self.dev_cache), {}
        freed = memory_accountant().release_tables(
            self._owner(), self.ledger_scope, [f"col:{k}" for k in keys])
        for nctx in self.nested.values():
            freed += nctx.segment.clear_column_cache()
        return freed

    def _evict_staging(self) -> None:
        """The ledger's eviction callback (run under the accountant's
        lock, so it takes no segment lock; plain rebinds): drop every
        staged tensor and return the scope. The host-side facts of the
        staging (its codec and block bounds) stay for concurrent readers.
        An in-flight query keeps the tensors it holds until it drops them;
        the next use restages."""
        self._device = None
        self._kernel_tables = {}
        self.dev_cache = {}
        self.kernel_postings_bytes = 0
        memory_accountant().release_scope(self._owner(), self.ledger_scope)

    def release_device(self) -> None:
        """Drop every device array this segment staged (postings, norms,
        live masks, kernel tables, doc-value and vector columns) and
        return its ledger bytes: the index that owns it closed, or a merge
        retired it. The host arrays stay; a later search would stage them
        again."""
        with self._stage_lock:
            self._device = None
            self._kernel_tables = {}
            self._kernel_bfmax = {}
            self.dev_cache = {}
            self.kernel_codec = None
            self.kernel_postings_bytes = 0
            self.kernel_bfmax = None
            memory_accountant().release_scope(self._owner(),
                                              self.ledger_scope)
        for nctx in self.nested.values():
            nctx.segment.release_device()

    def release_base_arrays(self) -> None:
        """Drop the host rung's base tables (postings, norms, live masks)
        and return their ledger bytes, keeping the kernel tables and the
        columns another plane staged: what a one-off scan staged on a
        segment whose base tables were not staged before it."""
        with self._stage_lock:
            dev, self._device = self._device, None
            if not dev:
                return
            tables = ["base_postings", "norms"] + [
                key for key in dev
                if key in ("live", "live1") or key.startswith("k_live_t")]
            memory_accountant().release_tables(self._owner(),
                                               self.ledger_scope, tables)

    def release_breaker_charges(self) -> None:
        """The segment is dropped (a merge replaced it, its shard closed):
        give its fielddata breaker bytes back (its nested sub-segments'
        too)."""
        for nctx in self.nested.values():
            nctx.segment.release_breaker_charges()
        if not self.breaker_charges:
            return
        from elasticsearch_tpu_torch.common.breaker import (
            CircuitBreaker,
            breaker_service,
        )

        total = sum(self.breaker_charges.values())
        self.breaker_charges.clear()
        breaker_service().get_breaker(
            CircuitBreaker.FIELDDATA).add_without_breaking(-total)

    def memory_bytes(self) -> int:
        """Host bytes of the segment's postings, norms and doc-value
        columns, as the JAX package's ``Segment.memory_bytes`` counts
        them (``_cat/indices`` store size)."""
        total = self.block_docs.nbytes + self.block_tfs.nbytes + self.norms.nbytes
        for c in self.numeric_columns.values():
            total += c.flat_values.nbytes + c.flat_docs.nbytes + c.first_value.nbytes
        for c in self.ordinal_columns.values():
            total += c.flat_ords.nbytes + c.flat_docs.nbytes + c.first_ord.nbytes
        for c in self.vector_columns.values():
            # device staging is bf16: half the host mirror's f32 bytes
            total += c.vectors.nbytes // 2 + c.exists.nbytes
        return total

    def stats(self) -> dict:
        """One ``_segments`` entry (the JAX package's ``Segment.stats``)."""
        return {
            "name": self.name,
            "num_docs": self.num_docs,
            "deleted_docs": self.num_docs - self.live_doc_count,
            "num_terms": len(self.term_keys),
            "num_posting_blocks": int(self.block_docs.shape[0]),
            "memory_in_bytes": self.memory_bytes(),
        }

    def staged_bytes(self) -> int:
        """Bytes this segment holds on its device."""
        tensors = {id(t): t for t in (
            *(self._device or {}).values(),
            *(t for tables in list(self._kernel_tables.values())
              for t in tables.values()),
            *self.dev_cache.values())}
        return sum(t.numel() * t.element_size() for t in tensors.values())


class PinnedSegmentView:
    """A point-in-time view of a sealed segment, for a scroll (the JAX
    package's ``PinnedSegmentView``). It shares every immutable staged
    tensor (postings, norms, kernel tables, doc values, embeddings) with
    the segment, but freezes ``live`` when it is built: deletes and
    updates rewrite ``Segment.live`` in place and merges swap the
    engine's segment list, yet the scroll keeps seeing exactly the docs
    visible when it opened. The view stages its own ``live``, ``live1``
    and ``k_live_t[_sub]`` tensors from the frozen mask, so the tile
    kernel reads the pinned live tiles, never the segment's current ones.
    A segment a merge retired (its staging released) is not restaged: the
    view keeps serving the tensors it captured. Dropping the view
    (``clear_scroll``, keep-alive expiry) frees what only it holds; its
    own tensors are not in the device-memory ledger. Its nested contexts
    are views of the same kind over the sub-segments, frozen at the same
    moment, so a nested clause pages the snapshot too."""

    def __init__(self, seg: "Segment"):
        self._seg = seg
        self.live = seg.live.copy()
        self.nested = {path: NestedContext(PinnedSegmentView(nctx.segment),
                                           nctx.parent_of, nctx.offset_of)
                       for path, nctx in seg.nested.items()}
        self._pin_device: dict = {}
        # device_arrays() returns the same dict every call and grows it in
        # place: a plan built after a caller captured it reads its
        # live_key from that dict
        self._merged: dict = {}
        self._codec: Optional[str] = None
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._seg, name)

    @property
    def live_doc_count(self) -> int:
        return int(self.live[: self._seg.num_docs].sum())

    @property
    def kernel_codec(self) -> Optional[str]:
        """The codec of the kernel tables the view captured (a retired
        segment forgets its own)."""
        return self._codec if self._codec is not None \
            else self._seg.kernel_codec

    def device_arrays(self) -> dict:
        seg = self._seg
        with self._lock:
            if not self._merged or seg._device is not None:
                base = seg.device_arrays()
                self._codec = seg.kernel_codec
                # shared immutable tables from the segment; every live
                # layout (the segment restages them on deletes) only from
                # the pin
                for key, val in base.items():
                    if key in ("live", "live1") or key.startswith("k_live_t"):
                        continue
                    self._merged[key] = val
            if "live1" not in self._pin_device:
                live1 = np.concatenate([self.live, np.zeros(1, dtype=bool)])
                self._pin_device["live"] = _to_device(self.live, seg.device)
                self._pin_device["live1"] = _to_device(live1, seg.device)
                self._pin_device["k_live_t"] = self._pinned_live_t(
                    seg.kernel_geom.tile_sub)
            self._merged.update(self._pin_device)
            return self._merged

    def kernel_live_t_for(self, sub: int) -> str:
        key = f"k_live_t_{sub}"
        self.device_arrays()
        with self._lock:
            if key not in self._pin_device:
                self._pin_device[key] = self._pinned_live_t(sub)
                self._merged[key] = self._pin_device[key]
        return key

    def ensure_vector_staged(self, field: str, metric: str = "cosine"):
        """Vector stagings are immutable, so the view shares the
        segment's, copied into the view's dict (a plan built after a
        caller captured it reads from there)."""
        keys = self._seg.ensure_vector_staged(field, metric)
        if keys is not None:
            base = self._seg.device_arrays()
            with self._lock:
                for key in keys[:3]:
                    if key in base:
                        self._merged[key] = base[key]
        return keys

    def _pinned_live_t(self, sub: int) -> torch.Tensor:
        seg = self._seg
        return _to_device(tsc.build_live_t(
            self.live.astype(np.float32), tsc.tile_geometry(seg.nd_pad, sub)),
            seg.device)


class SegmentBuilder:
    """Accumulates parsed documents, seals into a Segment (the in-memory
    indexing buffer; ``seal()`` is the flush to a segment)."""

    def __init__(self, name: str, device="cuda", index_sort=None):
        self.name = name
        self.device = resolve_device(device)
        # the index sort spec [(field, order, missing, mode)], applied as a
        # doc permutation at seal; the old -> new doc map of the last seal
        self.index_sort = index_sort
        self.seal_doc_remap: Optional[np.ndarray] = None
        self.doc_ids: List[str] = []
        self.sources: List[dict] = []
        self.routings: List[Optional[str]] = []
        self.parents: List[Optional[str]] = []
        self.seqnos: List[int] = []
        self.versions: List[int] = []
        # nested path -> {"builder": SegmentBuilder, "parent_of": [...],
        # "offset_of": [...], "per_parent": {doc: objects so far}}
        self.nested_builders: Dict[str, dict] = {}
        # term_key -> list[(doc, tf)] — appended in doc order
        self.postings: Dict[str, List[Tuple[int, int]]] = {}
        # field -> {doc: token_count}
        self.field_lengths: Dict[str, Dict[int, int]] = {}
        self.numeric_values: Dict[str, List[Tuple[int, float]]] = {}
        self.string_values: Dict[str, List[Tuple[int, str]]] = {}
        # dense_vector field -> {doc: [dims] float list}, and dims per field
        self.vector_values: Dict[str, Dict[int, list]] = {}
        self.vector_dims: Dict[str, int] = {}
        # geo_point field -> [(doc, lat, lon)]
        self.geo_values: Dict[str, List[Tuple[int, float, float]]] = {}
        # geo_shape field -> {doc: [raw GeoJSON / WKT values]}
        self.shape_values: Dict[str, Dict[int, list]] = {}
        # each token's index in its field's analyzed token list, as the JAX
        # builder records them: flat (term key id, doc, position) columns
        self._pos_keys: Dict[str, int] = {}
        self._pos_tok_kid: Dict[str, Dict[str, int]] = {}
        self._pos_kid = array("i")
        self._pos_doc = array("i")
        self._pos_at = array("i")

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    def add_document(self, parsed, seqno: int, version: int = 1,
                     parent: Optional[str] = None) -> int:
        """parsed: mapper.ParsedDocument; ``parent``: its legacy _parent
        value. Returns the local doc id."""
        doc = len(self.doc_ids)
        self.doc_ids.append(parsed.doc_id)
        self.sources.append(parsed.source)
        self.routings.append(parsed.routing)
        self.parents.append(parent)
        self.seqnos.append(seqno)
        self.versions.append(version)
        for field_name, tokens in parsed.terms.items():
            self.field_lengths.setdefault(field_name, {})[doc] = len(tokens)
            counts = Counter(tokens)  # first-seen order, as the dict loop
            tok_kid = self._pos_tok_kid.setdefault(field_name, {})
            for tok, tf in counts.items():
                key = f"{field_name}{FIELD_SEP}{tok}"
                self.postings.setdefault(key, []).append((doc, tf))
                if tok not in tok_kid:
                    tok_kid[tok] = self._pos_keys.setdefault(
                        key, len(self._pos_keys))
            # every token's (term, doc, position)
            self._pos_kid.extend(map(tok_kid.__getitem__, tokens))
            self._pos_doc.extend(itertools.repeat(doc, len(tokens)))
            self._pos_at.extend(range(len(tokens)))
        for field_name, vals in parsed.numeric_values.items():
            self.numeric_values.setdefault(field_name, []).extend(
                (doc, v) for v in vals)
        for field_name, vals in parsed.string_values.items():
            self.string_values.setdefault(field_name, []).extend(
                (doc, v) for v in vals)
        for field_name, vec in parsed.vector_values.items():
            self.vector_values.setdefault(field_name, {})[doc] = vec
            self.vector_dims[field_name] = len(vec)
        for field_name, pts in parsed.geo_values.items():
            self.geo_values.setdefault(field_name, []).extend(
                (doc, lat, lon) for lat, lon in pts)
        for field_name, vals in parsed.shape_values.items():
            self.shape_values.setdefault(field_name, {}).setdefault(
                doc, []).extend(vals)
        for field_name, pairs in parsed.range_values.items():
            # two aligned numeric columns: both appended once a value, in
            # the same order (the seal's doc sort is stable)
            self.numeric_values.setdefault(f"{field_name}#lo", []).extend(
                (doc, lo) for lo, _ in pairs)
            self.numeric_values.setdefault(f"{field_name}#hi", []).extend(
                (doc, hi) for _, hi in pairs)
        self._add_nested(parsed.nested, doc)
        return doc

    def _add_nested(self, nested: dict, root_doc: int) -> None:
        """Each nested path's objects into that path's sub-builder, joined
        to ``root_doc``. An object's own nested objects go into its
        sub-builder (joined to the object) and, flattened, into this
        builder's entry for the inner path (joined to ``root_doc``), so an
        inner path answers at the root as well."""
        for path, subdocs in nested.items():
            entry = self.nested_builders.get(path)
            if entry is None:
                entry = self.nested_builders[path] = {
                    "builder": SegmentBuilder(f"{self.name}#{path}",
                                              device=self.device),
                    "parent_of": [], "offset_of": [], "per_parent": {}}
            for sub in subdocs:
                offset = entry["per_parent"].get(root_doc, 0)
                entry["per_parent"][root_doc] = offset + 1
                entry["builder"].add_document(sub, seqno=-1)
                entry["parent_of"].append(root_doc)
                entry["offset_of"].append(offset)
                if sub.nested:
                    self._add_nested(sub.nested, root_doc)

    def _remap_docs(self, perm: np.ndarray) -> np.ndarray:
        """Reorder the docs by ``perm`` (new position -> old doc) and
        rewrite every doc reference (postings, positions, lengths, doc
        values, vectors, points, shapes, nested parents) so doc order is
        the sort order. Returns the old -> new map."""
        inv = np.empty(len(perm), np.int64)
        inv[perm] = np.arange(len(perm))
        order = perm.tolist()
        new = inv.tolist()

        def reorder(lst):
            return [lst[p] for p in order]

        self.doc_ids = reorder(self.doc_ids)
        self.sources = reorder(self.sources)
        self.routings = reorder(self.routings)
        self.parents = reorder(self.parents)
        self.seqnos = reorder(self.seqnos)
        self.versions = reorder(self.versions)
        self.postings = {k: sorted((new[d], tf) for d, tf in plist)
                         for k, plist in self.postings.items()}
        self._pos_doc = array("i", inv[np.frombuffer(
            self._pos_doc, np.int32)].astype(np.int32).tobytes())
        self.field_lengths = {
            f: {new[d]: ln for d, ln in per_doc.items()}
            for f, per_doc in self.field_lengths.items()}
        # the seal's stable doc sort keeps each doc's value order (and the
        # #lo / #hi alignment)
        for store in (self.numeric_values, self.string_values):
            for f, vals in store.items():
                store[f] = [(new[d],) + tuple(rest) for d, *rest in vals]
        for f, vals in self.geo_values.items():
            self.geo_values[f] = [(new[d], lat, lon) for d, lat, lon in vals]
        self.shape_values = {
            f: {new[d]: vals for d, vals in per_doc.items()}
            for f, per_doc in self.shape_values.items()}
        self.vector_values = {
            f: {new[d]: vec for d, vec in per_doc.items()}
            for f, per_doc in self.vector_values.items()}
        for entry in self.nested_builders.values():
            entry["parent_of"] = [new[d] for d in entry["parent_of"]]
        return inv

    def seal(self) -> Segment:
        self.seal_doc_remap = None
        if self.index_sort and self.num_docs > 1:
            from elasticsearch_tpu_torch.index.index_sort import (
                index_sort_permutation,
            )

            perm = index_sort_permutation(self, self.index_sort)
            if perm is not None:
                self.seal_doc_remap = self._remap_docs(perm)
        nd = self.num_docs
        nd_pad = next_pow2(max(nd, 1))
        term_keys = sorted(self.postings.keys())

        # --- block-pack postings: each term's (doc, tf) list in order, from
        # its first block on, one scatter for all terms ---
        n_terms = len(term_keys)
        plists = [self.postings[key] for key in term_keys]
        df = np.fromiter(map(len, plists), np.int64, n_terms)
        nblocks = (df + BLOCK - 1) // BLOCK
        term_doc_freq = df.astype(np.int32)
        term_block_count = nblocks.astype(np.int32)
        term_block_start = (np.cumsum(nblocks) - nblocks).astype(np.int32)
        total_blocks = max(int(nblocks.sum()), 1)
        flat = np.fromiter(itertools.chain.from_iterable(
            itertools.chain.from_iterable(plists)), np.int64,
            2 * int(df.sum())).reshape(-1, 2)
        within = (np.arange(len(flat), dtype=np.int64)
                  - np.repeat(np.cumsum(df) - df, df))
        rows = np.repeat(term_block_start.astype(np.int64), df) \
            + within // BLOCK
        lanes = within % BLOCK
        block_docs = np.full((total_blocks, BLOCK), nd_pad, dtype=np.int32)
        block_tfs = np.zeros((total_blocks, BLOCK), dtype=np.float32)
        block_docs[rows, lanes] = flat[:, 0]
        block_tfs[rows, lanes] = flat[:, 1]

        # --- norms (per text field doc-length columns) ---
        field_norm_idx = {f: i for i, f in enumerate(sorted(self.field_lengths))}
        norms = np.ones((max(len(field_norm_idx), 1), nd_pad + 1), dtype=np.float32)
        field_stats: Dict[str, dict] = {}
        for f, idx in field_norm_idx.items():
            lengths = self.field_lengths[f]
            col = np.zeros(nd_pad + 1, dtype=np.float32)
            for doc, ln in lengths.items():
                col[doc] = ln
            col[nd_pad] = 1.0
            norms[idx] = col
            field_stats[f] = {
                "doc_count": len(lengths),
                "sum_ttf": int(sum(lengths.values())),
            }

        # --- numeric columns ---
        numeric_columns = {}
        for f, pairs in self.numeric_values.items():
            pairs.sort(key=lambda p: p[0])
            n_vals = len(pairs)
            cap = next_pow2(max(n_vals, 1))
            flat_docs = np.full(cap, nd_pad, dtype=np.int32)
            flat_values = np.zeros(cap, dtype=np.float64)
            first_value = np.zeros(nd_pad, dtype=np.float64)
            min_value = np.full(nd_pad, np.inf, dtype=np.float64)
            max_value = np.full(nd_pad, -np.inf, dtype=np.float64)
            exists = np.zeros(nd_pad, dtype=bool)
            for i, (doc, v) in enumerate(pairs):
                flat_docs[i] = doc
                flat_values[i] = v
                if not exists[doc]:
                    first_value[doc] = v
                exists[doc] = True
                min_value[doc] = min(min_value[doc], v)
                max_value[doc] = max(max_value[doc], v)
            numeric_columns[f] = NumericColumn(
                flat_values, flat_docs, first_value, min_value, max_value,
                exists, n_vals)

        # --- ordinal (string) columns ---
        ordinal_columns = {}
        for f, pairs in self.string_values.items():
            # SortedSetDocValues: a doc holds each distinct value once
            pairs = sorted(set(pairs))
            terms = sorted({v for _, v in pairs})
            ord_map = {t: i for i, t in enumerate(terms)}
            n_vals = len(pairs)
            cap = next_pow2(max(n_vals, 1))
            flat_docs = np.full(cap, nd_pad, dtype=np.int32)
            flat_ords = np.zeros(cap, dtype=np.int32)
            first_ord = np.full(nd_pad, -1, dtype=np.int32)
            exists = np.zeros(nd_pad, dtype=bool)
            for i, (doc, v) in enumerate(pairs):
                flat_docs[i] = doc
                flat_ords[i] = ord_map[v]
                if first_ord[doc] < 0:
                    first_ord[doc] = ord_map[v]
                exists[doc] = True
            ordinal_columns[f] = OrdinalColumn(
                terms, flat_ords, flat_docs, first_ord, exists, n_vals)

        # --- dense_vector columns ---
        vector_columns = {}
        for f, per_doc in self.vector_values.items():
            dims = self.vector_dims[f]
            vecs = np.zeros((nd_pad, dims), np.float32)
            exists = np.zeros(nd_pad, dtype=bool)
            for doc, vec in per_doc.items():
                vecs[doc] = vec
                exists[doc] = True
            # rounded to the bf16 grid once: the host mirror, the oracle
            # and the device staging see the same values
            vector_columns[f] = VectorColumn(
                knn.bf16_round(vecs), exists, dims, len(per_doc))

        geo_columns = {}
        for f, triples in self.geo_values.items():
            arr = np.asarray(triples, np.float64).reshape(len(triples), 3)
            geo_columns[f] = build_geo_column(
                arr[:, 0].astype(np.int32), arr[:, 1], arr[:, 2], nd_pad)

        key_tid = np.zeros(max(len(self._pos_keys), 1), np.int32)
        term_ids = {key: tid for tid, key in enumerate(term_keys)}
        for key, kid in self._pos_keys.items():
            key_tid[kid] = term_ids[key]
        tids = key_tid[np.frombuffer(self._pos_kid, np.int32)]
        pdocs = np.frombuffer(self._pos_doc, np.int32)
        pat = np.frombuffer(self._pos_at, np.int32)
        order = np.lexsort((pat, pdocs, tids))
        positions = SegmentPositions.from_flat(tids[order], pdocs[order],
                                               pat[order])

        nested = {
            path: NestedContext(
                entry["builder"].seal(),
                np.asarray(entry["parent_of"], dtype=np.int32),
                np.asarray(entry["offset_of"], dtype=np.int32))
            for path, entry in self.nested_builders.items()}

        return Segment(
            name=self.name,
            num_docs=nd,
            doc_ids=list(self.doc_ids),
            sources=list(self.sources),
            routings=list(self.routings),
            parents=list(self.parents),
            nested=nested,
            seqnos=np.asarray(self.seqnos, dtype=np.int64),
            versions=np.asarray(self.versions, dtype=np.int64),
            term_keys=term_keys,
            term_block_start=term_block_start,
            term_block_count=term_block_count,
            term_doc_freq=term_doc_freq,
            block_docs=block_docs,
            block_tfs=block_tfs,
            field_stats=field_stats,
            field_norm_idx=field_norm_idx,
            norms=norms,
            numeric_columns=numeric_columns,
            ordinal_columns=ordinal_columns,
            vector_columns=vector_columns,
            device=self.device,
            positions=positions,
            geo_columns=geo_columns,
            shapes={f: dict(per_doc)
                    for f, per_doc in self.shape_values.items()},
        )


def build_geo_column(docs, lat, lon, nd_pad: int) -> GeoColumn:
    """A ``GeoColumn`` from each value's doc, lat and lon, sorted stably
    by doc: float32 values, the flat arrays padded to a power of two with
    the sentinel doc, each doc's first point."""
    order = np.argsort(docs, kind="stable")
    docs = np.asarray(docs, np.int32)[order]
    n_vals = len(docs)
    cap = next_pow2(max(n_vals, 1))
    flat_docs = np.full(cap, nd_pad, dtype=np.int32)
    flat_lat = np.zeros(cap, dtype=np.float32)
    flat_lon = np.zeros(cap, dtype=np.float32)
    flat_docs[:n_vals] = docs
    flat_lat[:n_vals] = np.asarray(lat)[order]
    flat_lon[:n_vals] = np.asarray(lon)[order]
    first_lat = np.zeros(nd_pad, dtype=np.float32)
    first_lon = np.zeros(nd_pad, dtype=np.float32)
    exists = np.zeros(nd_pad, dtype=bool)
    first = np.ones(n_vals, dtype=bool)
    first[1:] = docs[1:] != docs[:-1]
    first_lat[docs[first]] = flat_lat[:n_vals][first]
    first_lon[docs[first]] = flat_lon[:n_vals][first]
    exists[docs] = True
    return GeoColumn(flat_lat, flat_lon, flat_docs, first_lat, first_lon,
                     exists, n_vals)
