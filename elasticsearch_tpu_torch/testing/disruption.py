"""Query-path and device-staging fault injection.

The slice of ``elasticsearch_tpu/testing/disruption.py`` that the port's
search path needs: a process-global registry of query-path schemes and
two hooks. ``on_shard_search`` runs at the start of every shard's query
phase on the host rung (``ShardSearcher.query``): ``SearchDelayScheme``
stalls a shard (the straggler that trips a ``timeout``) and
``SearchFailScheme`` makes it raise (a ``_shards.failures`` entry).
``on_device_staging`` runs just before every device staging site's
transfer group: ``StagingFailScheme`` makes the Nth matching staging
raise a transient or a deterministic fault. The mesh plane runs every
shard as one program and calls ``on_shard_search`` for none of them;
``on_mesh_plane`` runs before each plane attempt of a serial mesh query,
just ahead of its deadline checkpoint, and ``MeshPlaneDelayScheme``
stalls it there (a search held on the mesh plane, for a cancel). The
transport, plane and launch schemes of the JAX module are not ported.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

_SEARCH_SCHEMES: list = []


class ShardSearchScheme:
    """Base for query-path schemes. ``indices`` and ``shards`` filter the
    (index, shard) query phases the scheme touches (None = any)."""

    def __init__(self, indices: Optional[Iterable[str]] = None,
                 shards: Optional[Iterable[int]] = None):
        self.indices = set(indices) if indices else None
        self.shards = set(shards) if shards is not None else None
        self.hits = 0

    def install(self) -> "ShardSearchScheme":
        _SEARCH_SCHEMES.append(self)
        return self

    def remove(self) -> None:
        if self in _SEARCH_SCHEMES:
            _SEARCH_SCHEMES.remove(self)

    def applies(self, index: str, shard_id) -> bool:
        if self.indices is not None and index not in self.indices:
            return False
        if self.shards is not None and shard_id not in self.shards:
            return False
        return True

    def on_search(self, index: str, shard_id: int) -> None:
        """Effect hook for a shard's query phase on the host rung."""

    def on_plane(self, index: str, plane: str) -> None:
        """Effect hook for a serial mesh query's plane attempt
        (``mesh_pallas`` or ``mesh``), before its deadline checkpoint."""

    def on_staging(self, index: str, kind: str, table: str) -> None:
        """Effect hook for a device staging boundary: called right before
        a staging site's transfer group with the ledger kind
        (postings_raw / postings_packed / live_mask / embeddings /
        scale_norm / mesh_slot_tables / doc_values) and the table name."""


def clear_search_disruptions() -> None:
    del _SEARCH_SCHEMES[:]


def on_shard_search(index: str, shard_id: int) -> None:
    """Called by ``ShardSearcher.query`` before its segments run; runs
    every installed matching scheme in installation order."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.applies(index, shard_id):
            scheme.on_search(index, shard_id)


def on_mesh_plane(index: str, plane: str) -> None:
    """Called by ``IndexMeshSearch.query`` before each plane attempt."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.indices is None or index in scheme.indices:
            scheme.on_plane(index, plane)


def on_device_staging(index: str, kind: str, table: str) -> None:
    """Called by every device staging site (segment stagings, the mesh
    executor's slot tables, kernel and kNN planes, delta appends,
    tombstones and doc-value columns) immediately before its transfer
    group, inside the site's retry loop, so a retried attempt consults
    the schemes again."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.indices is None or index in scheme.indices:
            scheme.on_staging(index, kind, table)


class StagingFailScheme(ShardSearchScheme):
    """A device staging boundary faults: the Nth matching staging raises,
    selected by ledger kind and by error class.

    ``kinds``: the ledger kinds to match (``postings`` matches both
    ``postings_raw`` and ``postings_packed``); None = any.
    ``nth``: skip the first nth-1 matching calls.
    ``times``: raise on at most this many calls, then go inert (None =
    every matching call while installed).
    ``transient``: raise :class:`TransientDeviceError` (retried); False
    raises ``ValueError`` (deterministic: the plane demotes and is
    quarantined at once, never retried)."""

    def __init__(self, kinds=None, nth: int = 1,
                 times: Optional[int] = None, transient: bool = True,
                 **filters):
        super().__init__(**filters)
        self.kinds = set(kinds) if kinds else None
        self.nth = max(1, int(nth))
        self.times = times
        self.transient = bool(transient)
        self.calls = 0
        self._lock = threading.Lock()

    def _kind_matches(self, kind: str) -> bool:
        if self.kinds is None:
            return True
        return kind in self.kinds or (
            "postings" in self.kinds and kind.startswith("postings"))

    def on_staging(self, index, kind, table) -> None:
        if not self._kind_matches(kind):
            return
        with self._lock:
            self.calls += 1
            if self.calls < self.nth:
                return
            if self.times is not None and self.hits >= self.times:
                return
            self.hits += 1
        if self.transient:
            from elasticsearch_tpu_torch.common.staging import (
                TransientDeviceError,
            )

            raise TransientDeviceError(
                f"[{index}] CUDA out of memory staging [{kind}/{table}] "
                f"(injected transient)")
        raise ValueError(
            f"[{index}] shape error staging [{kind}/{table}] "
            f"(injected deterministic)")


class SearchDelayScheme(ShardSearchScheme):
    """Every matching shard query phase stalls ``seconds`` before it runs:
    the straggler shard that drives a ``timeout`` deterministically (its
    first segment checkpoint finds the deadline expired)."""

    def __init__(self, seconds: float, **filters):
        super().__init__(**filters)
        self.seconds = float(seconds)

    def on_search(self, index, shard_id) -> None:
        import time

        self.hits += 1
        time.sleep(self.seconds)


class SearchFailScheme(ShardSearchScheme):
    """Every matching shard query phase raises: a ``_shards.failures``
    entry with ``_shards.failed``, never a 500, unless
    ``allow_partial_search_results`` is false or every shard fails."""

    def __init__(self, exception: Optional[Exception] = None, **filters):
        super().__init__(**filters)
        self.exception = exception

    def on_search(self, index, shard_id) -> None:
        self.hits += 1
        if self.exception is not None:
            raise self.exception
        raise RuntimeError(
            f"[{index}][{shard_id}] query phase failed (injected)")


class MeshPlaneDelayScheme(ShardSearchScheme):
    """Every matching mesh plane attempt stalls ``seconds`` before its
    deadline checkpoint: a request held on the mesh plane, so a cancel
    (or a deadline) lands on that checkpoint before any launch."""

    def __init__(self, seconds: float, **filters):
        super().__init__(**filters)
        self.seconds = float(seconds)

    def on_plane(self, index, plane) -> None:
        import time

        self.hits += 1
        time.sleep(self.seconds)
