"""Adaptive replica selection: rank shard copies by observed performance.

Counterpart of ``elasticsearch_tpu/cluster/response_collector.py``,
copied whole. Role model: ``ResponseCollectorService`` (reference:
core/src/main/java/org/elasticsearch/node/ResponseCollectorService.java) —
the coordinator keeps an EWMA of each node's response time (and queue
size) and ranks copies so reads route to the historically fastest copy
instead of always primary-first (the C3 algorithm, simplified here to the
latency term: queue sizes don't exist in the in-process transport).
"""

from __future__ import annotations

import threading
from typing import Dict, List

ALPHA = 0.3  # EWMA smoothing (reference: QueueResizingEsThreadPoolExecutor)


class ResponseCollectorService:
    def __init__(self):
        self._ewma: Dict[str, float] = {}
        self._outstanding: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add_response_time(self, node_id: str, seconds: float) -> None:
        with self._lock:
            prev = self._ewma.get(node_id)
            self._ewma[node_id] = (seconds if prev is None
                                   else ALPHA * seconds + (1 - ALPHA) * prev)

    def on_send(self, node_id: str) -> None:
        with self._lock:
            self._outstanding[node_id] = self._outstanding.get(node_id, 0) + 1

    def on_complete(self, node_id: str) -> None:
        with self._lock:
            n = self._outstanding.get(node_id, 1)
            self._outstanding[node_id] = max(0, n - 1)

    def on_failure(self, node_id: str, seconds: float = 0.0) -> None:
        """A failed or timed-out request PENALIZES the node's rank:
        double its EWMA (floored at the observed wasted time and 100ms)
        so a node that keeps timing out stops being preferred — but is
        never rewarded with a better rank by an instant connection
        error. Successes recover the rank through the normal EWMA."""
        with self._lock:
            prev = self._ewma.get(node_id, 0.0)
            self._ewma[node_id] = max(prev * 2.0, float(seconds), 0.1)

    def rank(self, node_id: str) -> float:
        """Lower is better. Unknown nodes rank best so they get probed
        (the reference seeds unknown nodes optimistically)."""
        with self._lock:
            ewma = self._ewma.get(node_id, 0.0)
            return ewma * (1.0 + self._outstanding.get(node_id, 0))

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"avg_response_time_ns": int(v * 1e9),
                        "outstanding": self._outstanding.get(n, 0)}
                    for n, v in self._ewma.items()}

    def order_copies(self, copies: List, tiebreak_primary_first: bool = True) -> List:
        """Order shard copies by rank; ties keep primary first (stable)."""
        return sorted(copies, key=lambda c: (
            self.rank(c.node_id),
            (not c.primary) if tiebreak_primary_first else 0,
            c.node_id,
        ))
