"""IntegrityService: the corruption-detection ledger (the event part).

Counterpart of ``elasticsearch_tpu/common/integrity.py``, cut to what the
snapshot service reports through: ``record_corruption`` counts one
detection by the site that caught it (``snapshot`` when a create finds a
store marked corrupted, ``restore`` when a repository blob fails its
manifest digest) and appends an event to a bounded ring; ``stats`` reads
the counters; ``integrity_service()`` is the process-wide singleton. The
JAX module's scrubber counters and marker events wait for the store and
device-digest scrubber (ROADMAP A.5).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

# where the bad bytes were caught (the per-site axis of the counters)
SITES = ("load", "recovery", "restore", "query", "scrub", "snapshot")


class IntegrityService:
    """Process-wide corruption ledger (thread-safe)."""

    MAX_EVENTS = 128

    def __init__(self):
        self._lock = threading.Lock()
        self.corruption_detected_total = 0
        self._by_site: Dict[str, int] = {site: 0 for site in SITES}
        self.events: List[dict] = []
        self.events_dropped = 0

    def record_corruption(self, index: str, shard: int, site: str,
                          reason: str) -> None:
        """One detected corruption, counted at detection, before any
        side effect of it runs."""
        assert site in SITES, site
        with self._lock:
            self.corruption_detected_total += 1
            self._by_site[site] += 1
            self.events.append({
                "action": "detected", "index": index or "_unknown",
                "shard": int(shard), "site": site,
                "reason": str(reason)[:200],
                "timestamp_ms": int(time.time() * 1000),
            })
            if len(self.events) > self.MAX_EVENTS:
                del self.events[0]
                self.events_dropped += 1

    def stats(self, index: Optional[str] = None) -> dict:
        """The counters (node-wide: a detection on a deleted index stays
        counted) and the events, of one index or all."""
        with self._lock:
            return {
                "corruption_detected_total": self.corruption_detected_total,
                "corruption_detected_by_site": dict(self._by_site),
                "events": [e for e in self.events
                           if index is None or e["index"] == index],
                "events_dropped": self.events_dropped,
            }


_service: Optional[IntegrityService] = None
_service_lock = threading.Lock()


def integrity_service() -> IntegrityService:
    global _service
    with _service_lock:
        if _service is None:
            _service = IntegrityService()
        return _service
