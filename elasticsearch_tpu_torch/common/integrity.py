"""IntegrityService: the corruption-detection ledger.

Counterpart of ``elasticsearch_tpu/common/integrity.py``. Every site that
catches bad bytes counts them here: ``record_corruption`` counts one
detection by its site (``load`` and ``query`` when a shard's store fails
verification, ``scrub`` when the scrubber's disk pass does, ``snapshot``
when a create finds a store marked corrupted, ``restore`` when a
repository blob fails its manifest digest); ``record_marker`` counts a
``corrupted_*`` marker's lifecycle (``marked`` by a quarantine,
``cleared`` by a verified re-recovery); ``record_scrub_run`` and
``record_scrub_drift`` count the scrubber's passes, the bytes it verified
and the staged tables whose digest drifted from host truth. The events go
to a bounded ring. ``stats`` is the ``search.integrity`` block of
``_stats`` (counters node-wide, the events of one index or all);
``integrity_service()`` is the process-wide singleton.
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
        self.scrub_runs_total = 0
        self.scrub_bytes_verified_total = 0
        self.scrub_drift_total = 0
        self.markers_written_total = 0
        self.markers_cleared_total = 0
        self.marker_events: List[dict] = []
        self.events_dropped = 0

    def _push(self, event: dict) -> None:
        self.marker_events.append(event)
        if len(self.marker_events) > self.MAX_EVENTS:
            del self.marker_events[0]
            self.events_dropped += 1

    def record_corruption(self, index: str, shard: int, site: str,
                          reason: str) -> None:
        """One detected corruption, counted at detection, before any
        side effect of it runs."""
        assert site in SITES, site
        with self._lock:
            self.corruption_detected_total += 1
            self._by_site[site] += 1
            self._push({
                "action": "detected", "index": index or "_unknown",
                "shard": int(shard), "site": site,
                "reason": str(reason)[:200],
                "timestamp_ms": int(time.time() * 1000),
            })

    def record_marker(self, index: str, shard: int, marker: dict, *,
                      action: str = "marked") -> None:
        """A ``corrupted_*`` marker's lifecycle event: ``marked`` when a
        quarantine wrote it, ``cleared`` when a verified re-recovery
        replaced the bytes."""
        assert action in ("marked", "cleared"), action
        with self._lock:
            if action == "marked":
                self.markers_written_total += 1
            else:
                self.markers_cleared_total += 1
            self._push({
                "action": action, "index": index or "_unknown",
                "shard": int(shard),
                "site": str(marker.get("site", "load")),
                "reason": str(marker.get("reason", ""))[:200],
                "marker": str(marker.get("marker", "")),
                "timestamp_ms": int(time.time() * 1000),
            })

    def record_scrub_run(self, nbytes_verified: int) -> None:
        with self._lock:
            self.scrub_runs_total += 1
            self.scrub_bytes_verified_total += max(0, int(nbytes_verified))

    def record_scrub_drift(self, index: str, shard: int, scope: str,
                           kind: str) -> None:
        """A staged table's digest drifted from host truth: its staging
        was released (the restage's reason is ``scrub``), and the drifted
        bytes never served."""
        with self._lock:
            self.scrub_drift_total += 1
            self._push({
                "action": "drift", "index": index or "_unknown",
                "shard": int(shard), "site": "scrub",
                "reason": f"device staging drift [{scope}/{kind}]",
                "timestamp_ms": int(time.time() * 1000),
            })

    def stats(self, index: Optional[str] = None) -> dict:
        """The counters (node-wide: a detection on a deleted index stays
        counted) and the events, of one index or all."""
        with self._lock:
            return {
                "corruption_detected_total": self.corruption_detected_total,
                "corruption_detected_by_site": dict(self._by_site),
                "scrub_runs_total": self.scrub_runs_total,
                "scrub_bytes_verified_total": self.scrub_bytes_verified_total,
                "scrub_drift_total": self.scrub_drift_total,
                "markers_written_total": self.markers_written_total,
                "markers_cleared_total": self.markers_cleared_total,
                "marker_events": [e for e in self.marker_events
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
