"""Global ordinals: one ordinal space across a shard's segments.

Counterpart of ``elasticsearch_tpu/index/global_ordinals.py`` (Lucene's
``OrdinalMap``): built lazily per field over the current segment set and
cached until that set changes, so cross-segment terms aggregation merges
integer count arrays instead of string dictionaries.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np


class GlobalOrdinals:
    __slots__ = ("field", "terms", "_seg_maps")

    def __init__(self, field: str, terms: List[str],
                 seg_maps: Dict[int, np.ndarray]):
        self.field = field
        self.terms = terms  # global sorted unique terms; global ord = index
        self._seg_maps = seg_maps  # id(segment) -> [n_local_ords] int32

    def seg_map(self, segment) -> np.ndarray:
        return self._seg_maps[id(segment)]

    def fold_counts(self, segment, local_counts: np.ndarray,
                    out: np.ndarray) -> None:
        """Add one segment's per-local-ordinal counts into the global
        array. Local ords map to distinct global ords, so a plain fancy-
        indexed add is exact."""
        m = self.seg_map(segment)
        out[m] += local_counts[: len(m)]


_CACHE_MAX = 64
_cache: Dict[Tuple, tuple] = {}
_cache_lock = threading.Lock()


def _ordinal_column(segment, field: str):
    return (segment.ordinal_columns.get(field)
            or segment.ordinal_columns.get(f"{field}.keyword"))


def global_ordinals(segments: Sequence, field: str,
                    columns: Sequence = None) -> GlobalOrdinals:
    """Build (or fetch cached) global ordinals for a field over a segment
    set. The cache key includes each segment's identity; an entry dies
    with its segments (ids are reused after free)."""
    key = (field, tuple((s.name, id(s)) for s in segments))
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            return hit[0]
    per_seg: List[Tuple[object, List[str]]] = []
    for i, seg in enumerate(segments):
        ocol = (columns[i] if columns is not None
                else _ordinal_column(seg, field))
        per_seg.append((seg, ocol.terms if ocol is not None else []))
    all_terms = sorted(set().union(*[t for _, t in per_seg])) \
        if per_seg else []
    terms_arr = np.asarray(all_terms, dtype=object)
    seg_maps: Dict[int, np.ndarray] = {}
    for seg, terms in per_seg:
        if terms:
            seg_maps[id(seg)] = np.searchsorted(
                terms_arr, np.asarray(terms, dtype=object)).astype(np.int32)
        else:
            seg_maps[id(seg)] = np.zeros(0, np.int32)
    built = GlobalOrdinals(field, all_terms, seg_maps)

    def _evict(_ref, _key=key):
        with _cache_lock:
            _cache.pop(_key, None)

    refs = [weakref.ref(seg, _evict) for seg in segments]
    with _cache_lock:
        if len(_cache) >= _CACHE_MAX:
            _cache.pop(next(iter(_cache)))
        _cache[key] = (built, refs)
    return built
