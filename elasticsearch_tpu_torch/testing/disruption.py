"""Device-staging fault injection.

The slice of ``elasticsearch_tpu/testing/disruption.py`` that the staging
lifecycle needs: a process-global registry of query-path schemes, the
``on_device_staging`` hook that every device staging site calls just
before its transfer group, and ``StagingFailScheme``, which makes the Nth
matching staging raise a transient or a deterministic fault. The
transport, plane and launch schemes of the JAX module are not ported.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

_SEARCH_SCHEMES: list = []


class ShardSearchScheme:
    """Base for query-path schemes. ``indices`` filters the indices the
    scheme touches (None = any)."""

    def __init__(self, indices: Optional[Iterable[str]] = None):
        self.indices = set(indices) if indices else None
        self.hits = 0

    def install(self) -> "ShardSearchScheme":
        _SEARCH_SCHEMES.append(self)
        return self

    def remove(self) -> None:
        if self in _SEARCH_SCHEMES:
            _SEARCH_SCHEMES.remove(self)

    def on_staging(self, index: str, kind: str, table: str) -> None:
        """Effect hook for a device staging boundary: called right before
        a staging site's transfer group with the ledger kind
        (postings_raw / postings_packed / live_mask / embeddings /
        scale_norm / mesh_slot_tables / doc_values) and the table name."""


def clear_search_disruptions() -> None:
    del _SEARCH_SCHEMES[:]


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
