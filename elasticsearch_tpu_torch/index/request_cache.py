"""The shard request cache (counterpart of
``elasticsearch_tpu/index/request_cache.py``, copied).

The cached unit is the index-level reduced response of a ``size: 0``
request (``cacheable``: no profile, scroll or search_after), keyed by the
request body and every shard's visibility epoch (``shard_epoch``: the
searchable segments' names, the engine's indexing and delete counters and
its ``visibility_epoch``, which a delete-only refresh moves). An empty
refresh keeps the epoch, and the entry, valid. Entries are LRU-evicted by
an approximate byte budget (``index.requests.cache.size_in_bytes``); a hit
returns a deep copy, so a caller may patch its ``took``. A hit launches
nothing on the device.
"""

from __future__ import annotations

import json
import sys
import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple


def _approx_bytes(obj: Any) -> int:
    """Cheap recursive size estimate for a JSON-like response tree."""
    size = sys.getsizeof(obj)
    if isinstance(obj, dict):
        for k, v in obj.items():
            size += _approx_bytes(k) + _approx_bytes(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            size += _approx_bytes(v)
    return size


class RequestCache:
    """LRU response cache with hit/miss/eviction stats."""

    def __init__(self, max_bytes: int = 8 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[str, Tuple[dict, int]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def key_for(body: dict, epochs) -> Optional[str]:
        """Canonical cache key, or None when the request isn't cacheable
        as JSON (e.g. non-serializable values from an internal caller —
        no default= fallback: stringified object reprs would make
        never-matching or, worse, colliding keys)."""
        try:
            return json.dumps({"body": body, "epochs": epochs},
                              sort_keys=True)
        except (TypeError, ValueError):
            return None

    def get(self, key: str) -> Optional[dict]:
        """Returns a deep copy of the cached response (callers mutate
        responses — e.g. patching `took`)."""
        import copy

        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            value = hit[0]
        return copy.deepcopy(value)

    def put(self, key: str, value: dict) -> None:
        """Stores a deep copy (taken only after the size check passes, so
        oversized responses cost no copy)."""
        import copy

        size = _approx_bytes(value)
        if size > self.max_bytes:
            return  # a single oversized response never enters the cache
        value = copy.deepcopy(value)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, size)
            self._bytes += size
            while self._bytes > self.max_bytes and self._entries:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._bytes -= evicted
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "memory_size_in_bytes": self._bytes,
                "entries": len(self._entries),
                "evictions": self.evictions,
                "hit_count": self.hits,
                "miss_count": self.misses,
            }


def cacheable(body: dict) -> bool:
    """The reference's default policy (IndicesRequestCache + the
    canCache checks in IndicesService.canCache): only hit-less requests
    (size == 0 — aggs/counts), never profiled or scrolled searches,
    never search_after/scroll cursors."""
    if body.get("profile"):
        return False
    if body.get("scroll") or body.get("search_after"):
        return False
    size = body.get("size", 10)
    try:
        return int(size) == 0
    except (TypeError, ValueError):
        return False


def shard_epoch(shard) -> tuple:
    """Visibility epoch of one shard: sealed-segment identity + write
    counters. Segment names change on every refresh-with-new-docs /
    merge; the delete counter covers explicit tombstones, and the
    indexing counter covers in-place updates (re-indexing an existing id
    kills the old copy's live-mask slot immediately, before any refresh,
    so writes must invalidate even though the buffered new doc isn't
    searchable yet)."""
    eng = shard.engine
    # visibility_epoch moves on delete-only refreshes, whose segment
    # names and write counters are unchanged (buffered NRT deletes)
    return (tuple(s.name for s in eng.searchable_segments()),
            eng.indexing_total, eng.delete_total,
            eng.visibility_epoch)
