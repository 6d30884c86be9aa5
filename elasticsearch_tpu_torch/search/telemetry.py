"""Phase spans of one query, for the ``profile`` section.

Counterpart of the ``QueryTracer`` part of
``elasticsearch_tpu/search/telemetry.py``. ``QueryTracer`` accumulates
host-clock spans over a fixed phase taxonomy (``PHASES``): one
accumulator a phase and a capped ring of detail records, so a shard of
many segments records at most one accumulator a phase. ``NULL_TRACER``
is the shared no-op tracer that an unprofiled request carries, so call
sites stay unconditional and add nothing to it.

On the card the device runs behind the host: a span that closes before a
device sync times only the launch. The places that open a ``kernel``
span close it after the scores reach the host (the host rung's copy, the
mesh program's synchronize), so the span holds the device work. The
per-index histograms, the slowlog and the opaque id of the JAX module
wait for the rest of the telemetry port.
"""

from __future__ import annotations

import time
from typing import Dict, List

# The phase taxonomy, in output order:
#   parse_rewrite  query DSL parse and coordinator rewrites
#   plan_build     per-shard plan and kernel lane tables
#   staging        host-to-device staging of plan arrays and slot tables
#   kernel         device program dispatch to its output on the host
#   merge          top-k merge and DocRef assembly
#   aggregate      aggregation reduce outside the device program
#   batch_demux    a micro-batch member's share of the batched result
#   fetch          the fetch phase (_source, highlight, sort values)
PHASES = ("parse_rewrite", "plan_build", "staging", "kernel", "merge",
          "aggregate", "batch_demux", "fetch")

_now_ns = time.monotonic_ns


class QueryTracer:
    """Span tracer for one query. Not thread-safe: a query's phases run
    on one thread."""

    MAX_SPANS = 32
    __slots__ = ("enabled", "_acc", "_counts", "_ring", "ring_dropped",
                 "_annotations")

    def __init__(self):
        self.enabled = True
        self._acc: Dict[str, int] = {}      # phase -> accumulated ns
        self._counts: Dict[str, int] = {}   # phase -> span count
        self._ring: List[tuple] = []        # capped detail records
        self.ring_dropped = 0
        self._annotations: Dict[str, object] = {}

    def start(self, phase: str) -> int:
        return _now_ns()

    def stop(self, phase: str, t0: int) -> None:
        dur = _now_ns() - t0
        self._acc[phase] = self._acc.get(phase, 0) + dur
        self._counts[phase] = self._counts.get(phase, 0) + 1
        if len(self._ring) < self.MAX_SPANS:
            self._ring.append((phase, dur))
        else:
            self.ring_dropped += 1

    def annotate(self, key: str, value) -> None:
        self._annotations[key] = value

    def merge_from(self, other: "QueryTracer") -> None:
        """Fold a shared (batch) tracer's accumulators into this one."""
        for phase, ns in other._acc.items():
            self._acc[phase] = self._acc.get(phase, 0) + ns
            self._counts[phase] = (self._counts.get(phase, 0)
                                   + other._counts.get(phase, 1))
        self._annotations.update(other._annotations)

    def spans(self) -> List[dict]:
        """Per-phase accumulated spans in taxonomy order (the profile's
        ``phases`` array)."""
        out = []
        for phase in PHASES:
            if phase in self._acc:
                out.append({"phase": phase,
                            "time_in_nanos": int(self._acc[phase]),
                            "count": int(self._counts.get(phase, 1))})
        return out

    def annotations(self) -> dict:
        out = dict(self._annotations)
        if self.ring_dropped:
            out["spans_dropped"] = self.ring_dropped
        return out

    def top_phases(self, n: int = 3) -> str:
        """``kernel:0.52ms, staging:0.11ms, merge:0.03ms``."""
        items = sorted(self._acc.items(), key=lambda kv: -kv[1])[:n]
        return ", ".join(f"{p}:{ns / 1e6:.2f}ms" for p, ns in items)


class _NullTracer:
    """Disabled tracer: every method a no-op, one shared instance."""

    __slots__ = ()
    enabled = False
    ring_dropped = 0

    def start(self, phase: str) -> int:
        return 0

    def stop(self, phase: str, t0: int) -> None:
        pass

    def annotate(self, key: str, value) -> None:
        pass

    def merge_from(self, other) -> None:
        pass

    def spans(self) -> List[dict]:
        return []

    def annotations(self) -> dict:
        return {}

    def top_phases(self, n: int = 3) -> str:
        return ""


NULL_TRACER = _NullTracer()


def tracer_for(body) -> object:
    """A ``QueryTracer`` for a profiled request, else ``NULL_TRACER``: an
    unprofiled request records nothing."""
    return QueryTracer() if (body or {}).get("profile") else NULL_TRACER
