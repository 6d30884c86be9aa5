"""Immutable block-packed segments, staged as tensors on one device.

Counterpart of ``elasticsearch_tpu/index/segment.py``:

- Postings are block-packed dense arrays: every term's postings are padded
  to multiples of BLOCK=128 docs in one ``[n_blocks, 128]`` int32 matrix
  (``block_docs``, padding = nd_pad) with tfs beside it.
- Norms are exact float32 per-field doc-length columns
  (``[n_norm_fields, nd_pad + 1]``, last column 1).
- Doc values are columnar: numerics as float64 CSR (value, doc) pairs,
  keywords as ordinal CSR against a sorted per-field term list.
- Stored fields (_source) stay on the host.

``device_arrays()`` stages the query tables on the segment's device once:
the base tables (postings, norms, live masks) and the tile-scoring
kernel's tables (padded docs, per-posting BM25 norm factors, the live mask
in tile layout). A staging failure raises; there is no fallback engine.
The memory ledger, staging retries and fault-injection hooks of the JAX
package are later slices.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.device import resolve_device
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


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


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
        device="cuda",
    ):
        self.name = name
        self.num_docs = num_docs
        self.nd_pad = next_pow2(max(num_docs, 1))
        self.doc_ids = doc_ids
        self.sources = sources
        self.routings = routings
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
        self.device = resolve_device(device)
        self.live = np.ones(self.nd_pad, dtype=bool)
        self.live[num_docs:] = False
        self._id_to_doc: Optional[Dict[str, int]] = None
        self._device: Optional[dict] = None
        # doc-value columns staged on demand (key -> tensor)
        self.dev_cache: Dict[str, Any] = {}
        self.kernel_geom: Optional[tsc.TileGeometry] = None
        self._stage_lock = threading.Lock()

    @classmethod
    def from_arrays(cls, name: str, *, term_keys, term_block_start,
                    term_block_count, term_doc_freq, block_docs, block_tfs,
                    norms, live, field_stats, field_norm_idx, doc_ids,
                    sources, numeric_columns=None, ordinal_columns=None,
                    routings=None, seqnos=None, versions=None,
                    device="cuda") -> "Segment":
        """Build a segment from plain host arrays — the fields a store load
        hands the JAX ``Segment`` — staged later on ``device``.
        ``numeric_columns`` / ``ordinal_columns`` map a field to a dict of
        the column's arrays (the dataclass fields)."""
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
            device=device,
        )
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
        and each staged tile layout) if the segment is staged."""
        if locals_.size == 0:
            return
        self.live[locals_] = False
        dev = self._device
        if dev is None:
            return
        with self._stage_lock:
            dev["live"] = _to_device(self.live, self.device)
            dev["live1"] = _to_device(
                np.concatenate([self.live, np.zeros(1, dtype=bool)]),
                self.device)
            for key in [k for k in dev if k.startswith("k_live_t")]:
                sub = (self.kernel_geom.tile_sub if key == "k_live_t"
                       else int(key.rsplit("_", 1)[1]))
                dev[key] = self._build_live_t_device(sub)

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

    def device_arrays(self) -> dict:
        """Stage postings, norms, live masks and the tile-scoring kernel's
        tables on the segment's device (cached)."""
        dev = self._device
        if dev is None:
            with self._stage_lock:
                if self._device is None:
                    staged = self._stage_base_arrays()
                    self._stage_kernel_arrays(staged)
                    self._device = staged
                dev = self._device
        return dev

    def _stage_base_arrays(self) -> dict:
        live1 = np.concatenate([self.live, np.zeros(1, dtype=bool)])
        return {
            "block_docs": _to_device(self.block_docs, self.device),
            "block_tfs": _to_device(self.block_tfs, self.device),
            "norms": _to_device(self.norms, self.device),
            "live": _to_device(self.live, self.device),
            "live1": _to_device(live1, self.device),
        }

    def _stage_kernel_arrays(self, dev: dict) -> None:
        geom = tsc.tile_geometry(self.nd_pad)
        frac = self._block_frac()
        bmin, bmax = tsc.block_min_max(self.block_docs, self.block_tfs,
                                       self.nd_pad)
        dp, fp = tsc.pad_segment_blocks(self.block_docs, frac, self.nd_pad)
        dev["k_docs"] = _to_device(dp, self.device)
        dev["k_frac"] = _to_device(fp, self.device)
        dev["k_live_t"] = _to_device(
            tsc.build_live_t(self.live.astype(np.float32), geom), self.device)
        self.kernel_postings_bytes = int(dp.nbytes + fp.nbytes)
        self.kernel_bmin = bmin
        self.kernel_bmax = bmax
        self.kernel_codec = "raw"
        self.kernel_geom = geom

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
                dev[key] = self._build_live_t_device(sub)
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

    def device_column(self, key: str, build) -> torch.Tensor:
        """Cached device staging of a doc-value array (build() -> numpy)."""
        hit = self.dev_cache.get(key)
        if hit is None:
            with self._stage_lock:
                hit = self.dev_cache.get(key)
                if hit is None:
                    hit = self.dev_cache[key] = _to_device(build(), self.device)
        return hit

    def staged_bytes(self) -> int:
        """Bytes this segment holds on its device."""
        tensors = list((self._device or {}).values()) + list(
            self.dev_cache.values())
        return sum(t.numel() * t.element_size() for t in tensors)


class SegmentBuilder:
    """Accumulates parsed documents, seals into a Segment (the in-memory
    indexing buffer; ``seal()`` is the flush to a segment)."""

    def __init__(self, name: str, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.doc_ids: List[str] = []
        self.sources: List[dict] = []
        self.routings: List[Optional[str]] = []
        self.seqnos: List[int] = []
        self.versions: List[int] = []
        # term_key -> list[(doc, tf)] — appended in doc order
        self.postings: Dict[str, List[Tuple[int, int]]] = {}
        # field -> {doc: token_count}
        self.field_lengths: Dict[str, Dict[int, int]] = {}
        self.numeric_values: Dict[str, List[Tuple[int, float]]] = {}
        self.string_values: Dict[str, List[Tuple[int, str]]] = {}

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    def add_document(self, parsed, seqno: int, version: int = 1) -> int:
        """parsed: mapper.ParsedDocument. Returns the local doc id."""
        doc = len(self.doc_ids)
        self.doc_ids.append(parsed.doc_id)
        self.sources.append(parsed.source)
        self.routings.append(parsed.routing)
        self.seqnos.append(seqno)
        self.versions.append(version)
        for field_name, tokens in parsed.terms.items():
            self.field_lengths.setdefault(field_name, {})[doc] = len(tokens)
            counts: Dict[str, int] = {}
            for tok in tokens:
                counts[tok] = counts.get(tok, 0) + 1
            for tok, tf in counts.items():
                key = f"{field_name}{FIELD_SEP}{tok}"
                self.postings.setdefault(key, []).append((doc, tf))
        for field_name, vals in parsed.numeric_values.items():
            self.numeric_values.setdefault(field_name, []).extend(
                (doc, v) for v in vals)
        for field_name, vals in parsed.string_values.items():
            self.string_values.setdefault(field_name, []).extend(
                (doc, v) for v in vals)
        return doc

    def seal(self) -> Segment:
        nd = self.num_docs
        nd_pad = next_pow2(max(nd, 1))
        term_keys = sorted(self.postings.keys())

        # --- block-pack postings ---
        n_terms = len(term_keys)
        term_block_start = np.zeros(n_terms, dtype=np.int32)
        term_block_count = np.zeros(n_terms, dtype=np.int32)
        term_doc_freq = np.zeros(n_terms, dtype=np.int32)
        total_blocks = sum(
            (len(p) + BLOCK - 1) // BLOCK for p in self.postings.values())
        total_blocks = max(total_blocks, 1)
        block_docs = np.full((total_blocks, BLOCK), nd_pad, dtype=np.int32)
        block_tfs = np.zeros((total_blocks, BLOCK), dtype=np.float32)
        b = 0
        for tid, key in enumerate(term_keys):
            plist = self.postings[key]
            term_doc_freq[tid] = len(plist)
            term_block_start[tid] = b
            nblocks = (len(plist) + BLOCK - 1) // BLOCK
            term_block_count[tid] = nblocks
            docs = np.fromiter((d for d, _ in plist), dtype=np.int32,
                               count=len(plist))
            tfs = np.fromiter((t for _, t in plist), dtype=np.float32,
                              count=len(plist))
            for i in range(nblocks):
                chunk = docs[i * BLOCK: (i + 1) * BLOCK]
                block_docs[b, : len(chunk)] = chunk
                block_tfs[b, : len(chunk)] = tfs[i * BLOCK: (i + 1) * BLOCK]
                b += 1

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

        return Segment(
            name=self.name,
            num_docs=nd,
            doc_ids=list(self.doc_ids),
            sources=list(self.sources),
            routings=list(self.routings),
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
            device=self.device,
        )
