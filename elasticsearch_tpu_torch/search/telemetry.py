"""Phase-attributed query telemetry.

Counterpart of ``elasticsearch_tpu/search/telemetry.py``. Three pieces:

- ``QueryTracer`` accumulates host-clock spans of one query over a fixed
  phase taxonomy (``PHASES``): one accumulator a phase and a capped ring
  of detail records, so a shard of many segments records at most one
  accumulator a phase. ``NULL_TRACER`` is the shared no-op tracer a
  request carries while ``search.telemetry.enabled`` is off, so call
  sites stay unconditional.
- ``SearchTelemetry``, the per-index registry the tracers drain into:
  per-plane x per-phase log2 latency histograms, launch-level counters
  (``add_counters``, once a launch, never once a member) and the plane
  ladder's decisions with their reasons (``note_decision``). It is the
  ``search.phases`` block of ``_stats``; ``merge_phase_stats`` merges the
  per-index ``search`` blocks for ``_nodes/stats``.
- The ``X-Opaque-Id`` context: the REST layer stamps the request header
  into a contextvar; tasks, slowlog lines, admission's tenant and the
  profile read it back (``get_opaque_id``); ``scoped_opaque_id`` stamps a
  batch member's id for a block and restores the leader's on every exit.

On the card the device runs behind the host: a span that closes before a
device sync times only the launch. The places that open a ``kernel``
span close it after the scores reach the host (the host rung's copy, the
mesh program's synchronize), so the span holds the device work.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, List, Optional

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
    _acc: Dict[str, int] = {}
    _annotations: Dict[str, object] = {}

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


def _bucket_label(ns: int) -> str:
    """log2 latency bucket: a duration in [2^(k-1), 2^k) microseconds
    lands in ``le_2^k`` (``le_1`` below a microsecond)."""
    us = ns // 1000
    return f"le_{1 << max(us, 1).bit_length()}" if us > 0 else "le_1"


class SearchTelemetry:
    """Per-index phase telemetry (thread-safe counters): the ``search.
    phases`` block of ``_stats``, merged across indices into
    ``_nodes/stats``."""

    def __init__(self):
        self._lock = threading.Lock()
        # (plane, phase) -> {bucket_label: count}
        self._hist: Dict[tuple, Dict[str, int]] = {}
        self.counters: Dict[str, int] = {}
        self.decisions: Dict[str, int] = {}
        self.queries_recorded = 0

    def tracer(self, enabled: bool = True):
        return QueryTracer() if enabled else NULL_TRACER

    def record_query(self, plane: str, tracer) -> None:
        """Fold one finished query's spans into the per-plane x per-phase
        histograms."""
        if not getattr(tracer, "enabled", False):
            return
        with self._lock:
            self.queries_recorded += 1
            for phase, ns in tracer._acc.items():
                h = self._hist.setdefault((plane, phase), {})
                b = _bucket_label(ns)
                h[b] = h.get(b, 0) + 1

    def add_counters(self, mapping: Dict[str, int]) -> None:
        """Fold launch-level totals (tiles, bytes) in once a launch: a
        batched launch does not multiply them by its members."""
        with self._lock:
            for key, n in mapping.items():
                total = key if key.endswith("_total") else key + "_total"
                self.counters[total] = self.counters.get(total, 0) + int(n)

    def note_decision(self, plane: str, reason: str, n: int = 1) -> None:
        """The plane ladder's decision counter (``mesh_pallas.served``,
        ``host.unsupported_body``, ...), counted per query: a batched
        launch's decision counts once a member (``n``). A query that
        descends the ladder may record more than one."""
        key = f"{plane}.{reason}"
        with self._lock:
            self.decisions[key] = self.decisions.get(key, 0) + int(n)

    def phases_dict(self) -> dict:
        with self._lock:
            hist: Dict[str, Dict[str, dict]] = {}
            for (plane, phase), buckets in self._hist.items():
                hist.setdefault(plane, {})[phase] = {
                    b: c for b, c in sorted(
                        buckets.items(),
                        key=lambda kv: int(kv[0].split("_")[1]))}
            return {
                "taxonomy": list(PHASES),
                "queries_recorded": self.queries_recorded,
                "histogram_us": hist,
                "counters": dict(self.counters),
                "decisions": dict(sorted(self.decisions.items())),
            }


def merge_phase_stats(blocks: List[dict]) -> dict:
    """Merge per-index ``search`` stats blocks into one node-level block
    for ``_nodes/stats``: numbers sum, booleans or, lists concatenate
    unless equal, strings keep the first non-null value."""

    def merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = merge(out[k], v) if k in out else v
            return out
        if isinstance(a, bool) or isinstance(b, bool):
            return a or b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a + b
        if isinstance(a, list) and isinstance(b, list):
            return a if a == b else a + b
        return a if a is not None else b

    out: dict = {}
    for block in blocks:
        out = merge(out, block) if out else dict(block)
    return out


# ---------------------------------------------------------------------------
# The X-Opaque-Id request context
# ---------------------------------------------------------------------------

_OPAQUE_ID: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "es_tpu_torch_x_opaque_id", default=None)


def set_opaque_id(value: Optional[str]) -> None:
    _OPAQUE_ID.set(value if value else None)


def get_opaque_id() -> Optional[str]:
    return _OPAQUE_ID.get()


@contextlib.contextmanager
def scoped_opaque_id(value: Optional[str]):
    """Stamp a batch member's X-Opaque-Id for the block and restore the
    previous (the leader's) id on every exit path."""
    prev = _OPAQUE_ID.get()
    _OPAQUE_ID.set(value if value else None)
    try:
        yield
    finally:
        _OPAQUE_ID.set(prev)
