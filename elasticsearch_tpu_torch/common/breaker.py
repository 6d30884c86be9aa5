"""Hierarchical memory circuit breakers.

Counterpart of ``elasticsearch_tpu/common/breaker.py`` (the reference's
``HierarchyCircuitBreakerService`` and ``ChildMemoryCircuitBreaker``):
child breakers (request, fielddata, in-flight, accounting) account bytes,
the parent trips when the host children's sum crosses its limit, and a
trip surfaces as ``CircuitBreakingException`` (HTTP 429).

The accounted resources are host memory for query-time structures (the
aggregation request estimate, in-flight REST bodies) and, through the
``accounting`` child, the device bytes of the staging ledger
(``common/memory.py``). The accounting child mirrors a different
physical resource (the card's memory, bounded by its own budget), so the
parent leaves it out of its sum.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from elasticsearch_tpu_torch.common.errors import CircuitBreakingException


class CircuitBreaker:
    PARENT = "parent"
    REQUEST = "request"
    FIELDDATA = "fielddata"
    IN_FLIGHT_REQUESTS = "in_flight_requests"
    ACCOUNTING = "accounting"

    def __init__(self, name: str, limit_bytes: int, overhead: float = 1.0,
                 parent: Optional["CircuitBreaker"] = None):
        self.name = name
        self.limit_bytes = limit_bytes
        self.overhead = overhead
        self.parent = parent
        self._used = 0
        self._trip_count = 0
        self._lock = threading.Lock()

    @property
    def used_bytes(self) -> int:
        return self._used

    @property
    def trip_count(self) -> int:
        return self._trip_count

    def add_estimate_bytes_and_maybe_break(self, bytes_: int, label: str = "") -> int:
        with self._lock:
            new_used = self._used + bytes_
            estimate = int(new_used * self.overhead)
            if bytes_ > 0 and self.limit_bytes > 0 and estimate > self.limit_bytes:
                self._trip_count += 1
                raise CircuitBreakingException(
                    f"[{self.name}] Data too large, data for [{label}] would be "
                    f"[{estimate}/{estimate}b], which is larger than the limit of "
                    f"[{self.limit_bytes}b]",
                    bytes_wanted=estimate,
                    byte_limit=self.limit_bytes,
                )
            self._used = new_used
        if self.parent is not None:
            try:
                self.parent.check_parent(label)
            except CircuitBreakingException:
                with self._lock:
                    self._used -= bytes_
                raise
        return self._used

    def add_without_breaking(self, bytes_: int) -> int:
        with self._lock:
            self._used += bytes_
            return self._used

    def check_parent(self, label: str) -> None:
        # parent looks at the sum of its children (tracked by the service)
        pass

    def stats(self) -> dict:
        return {
            "limit_size_in_bytes": self.limit_bytes,
            "estimated_size_in_bytes": self._used,
            "overhead": self.overhead,
            "tripped": self._trip_count,
        }


class ParentBreaker(CircuitBreaker):
    def __init__(self, limit_bytes: int, children: Dict[str, CircuitBreaker]):
        super().__init__(CircuitBreaker.PARENT, limit_bytes)
        self.children = children

    def check_parent(self, label: str) -> None:
        # the accounting child mirrors the device-memory ledger
        # (common/memory.py), a different physical resource than the host
        # working set this parent bounds; its own budget enforces it by
        # LRU eviction and plane demotion, never a 429, so it must not eat
        # the host children's headroom here
        total = sum(c.used_bytes for name, c in self.children.items()
                    if name != CircuitBreaker.ACCOUNTING)
        if self.limit_bytes > 0 and total > self.limit_bytes:
            with self._lock:
                self._trip_count += 1
            raise CircuitBreakingException(
                f"[parent] Data too large, data for [{label}] would be [{total}b], "
                f"which is larger than the limit of [{self.limit_bytes}b]",
                bytes_wanted=total,
                byte_limit=self.limit_bytes,
            )


class CircuitBreakerService:
    """Builds the breaker hierarchy from settings and hands out children."""

    def __init__(self, total_limit: int = 0, request_limit: int = 0,
                 fielddata_limit: int = 0):
        children: Dict[str, CircuitBreaker] = {}
        self.parent = ParentBreaker(total_limit, children)
        for name, limit in (
            (CircuitBreaker.REQUEST, request_limit),
            (CircuitBreaker.FIELDDATA, fielddata_limit),
            (CircuitBreaker.IN_FLIGHT_REQUESTS, total_limit),
            (CircuitBreaker.ACCOUNTING, 0),
        ):
            children[name] = CircuitBreaker(name, limit, parent=self.parent)
        self._children = children

    def get_breaker(self, name: str) -> CircuitBreaker:
        if name == CircuitBreaker.PARENT:
            return self.parent
        return self._children[name]

    def stats(self) -> dict:
        out = {name: b.stats() for name, b in self._children.items()}
        out[CircuitBreaker.PARENT] = self.parent.stats()
        return out


# ---------------------------------------------------------------------------
# Process-level service (the node configures it from settings at startup;
# library code reaches it through breaker_service())
# ---------------------------------------------------------------------------

_service: Optional[CircuitBreakerService] = None
_service_lock = threading.Lock()

# default budget when no settings configure one: the reference defaults to
# percentages of the JVM heap; here an absolute working-set budget (the
# defaults of common/settings.py's BREAKER_* settings)
_DEFAULT_TOTAL = 1_500_000_000


def breaker_service() -> CircuitBreakerService:
    global _service
    with _service_lock:
        if _service is None:
            _service = CircuitBreakerService(
                total_limit=_DEFAULT_TOTAL,
                request_limit=int(_DEFAULT_TOTAL * 0.6),
                fielddata_limit=int(_DEFAULT_TOTAL * 0.6),
            )
        return _service


def configure_breaker_service(settings) -> CircuitBreakerService:
    """Node startup: (re)configure the hierarchy's limits from the
    ``indices.breaker.*`` settings. The service object and its accounted
    bytes survive: in-process nodes share one process-wide accounting
    (the last configuration wins on limits), because replacing the object
    would forget every byte the running searches already accounted."""
    from elasticsearch_tpu_torch.common.settings import (
        BREAKER_FIELDDATA_LIMIT,
        BREAKER_REQUEST_LIMIT,
        BREAKER_TOTAL_LIMIT,
    )

    total = BREAKER_TOTAL_LIMIT.get(settings)
    # an unset child limit follows 60% of the total, as in the JAX package
    request = (BREAKER_REQUEST_LIMIT.get(settings)
               if settings.get(BREAKER_REQUEST_LIMIT.key) is not None
               else int(total * 0.6))
    fielddata = (BREAKER_FIELDDATA_LIMIT.get(settings)
                 if settings.get(BREAKER_FIELDDATA_LIMIT.key) is not None
                 else int(total * 0.6))
    svc = breaker_service()
    svc.parent.limit_bytes = total
    svc.get_breaker(CircuitBreaker.REQUEST).limit_bytes = request
    svc.get_breaker(CircuitBreaker.FIELDDATA).limit_bytes = fielddata
    svc.get_breaker(CircuitBreaker.IN_FLIGHT_REQUESTS).limit_bytes = total
    return svc
