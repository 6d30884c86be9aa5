"""DeviceMemoryAccountant: the exact device-memory ledger.

Counterpart of ``elasticsearch_tpu/common/memory.py`` (the reference
accounts segment memory through the "accounting" breaker child and
throttles against a budget). The scarce resource is the card's memory:
posting tables, live masks, bf16 embeddings, stacked mesh slot tables and
doc-value columns, each staged lazily by a staging site on the query
path. A table's bytes are its tensors' ``numel() * element_size()``.

Three pieces:

- the ledger: an exact byte map ``(index, scope, kind, table) -> bytes``;
  the scope is the staging owner (a segment, or one mesh executor
  generation ``mesh#N``) and the kind one of ``KINDS``. Every register
  and release mirrors its delta into the breakers' ``accounting`` child.
  Per-kind sums always equal the total.
- staging lifecycle events: each (re)stage appends ``{index, segment,
  kind, bytes, duration_ms, reason}`` to a bounded ring (reason in
  ``REASONS``), and the accountant derives the restage amplification,
  bytes restaged over bytes logically changed.
- the budget: ``search.memory.hbm_budget_bytes`` (0 = unlimited). An
  over-budget reservation first LRU-evicts the coldest evictable scopes
  (segment stagings and mesh generations, which restage lazily), then
  denies: the caller demotes to the next plane rung with decision reason
  ``hbm_budget``. Queries degrade; they never fail for it.

The ledger is a process singleton of the port's own
(``memory_accountant()``); it never shares state with the JAX package's.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# Table kinds (the per-kind axis of the ledger; the staged_bytes keys of
# search_stats()["memory"]). Every staging site maps its tensors onto these.
KIND_POSTINGS_RAW = "postings_raw"
KIND_POSTINGS_PACKED = "postings_packed"
KIND_LIVE_MASK = "live_mask"
KIND_BOUND_TABLES = "bound_tables"
KIND_EMBEDDINGS = "embeddings"
KIND_SCALE_NORM = "scale_norm"
KIND_MESH_SLOT_TABLES = "mesh_slot_tables"
KIND_DOC_VALUES = "doc_values"

KINDS = (KIND_POSTINGS_RAW, KIND_POSTINGS_PACKED, KIND_LIVE_MASK,
         KIND_BOUND_TABLES, KIND_EMBEDDINGS, KIND_SCALE_NORM,
         KIND_MESH_SLOT_TABLES, KIND_DOC_VALUES)

# Staging lifecycle reasons:
#   initial             first staging of this table (counts as bytes
#                       logically changed, not as restaged bytes)
#   refresh             the segment set changed (new/retired segments)
#                       and dependent tables restaged
#   delete_invalidation a delete mutated the live mask / invalidated a
#                       staged table
#   geometry_change     the collective geometry (slot packing, tile
#                       sublane ladder) changed shape
#   probe               re-staged on demand after an eviction or a
#                       quarantine probe
#   scrub               a background scrubber found device/host digest
#                       drift and invalidated the staging (the JAX
#                       package's; the port has no scrubber yet)
#   delta_append        an incremental refresh staged ONLY the new
#                       segments' tables into free slots of the live
#                       mesh generation — the delta bytes
#                       count as restaged AND logically changed, so a
#                       pure-append refresh drives amplification to ~1
#   tombstone           a delete updated only the affected slots'
#                       live-mask columns in place (kNN exists∧live and
#                       fused-agg matched masks included)
#   compaction          the background compaction pass merged sparse
#                       slots into fresh ones and released the old
#                       generation (index.staging.compact.threshold)
REASONS = ("initial", "refresh", "delete_invalidation", "geometry_change",
           "probe", "scrub", "delta_append", "tombstone", "compaction")


class _Entry:
    __slots__ = ("bytes", "stage_count")

    def __init__(self):
        self.bytes = 0
        self.stage_count = 0


class DeviceMemoryAccountant:
    """Process-wide device-staging ledger (thread-safe, re-entrant:
    eviction callbacks release through the same lock)."""

    MAX_EVENTS = 128
    MAX_RELEASED_SCOPES = 4096

    def __init__(self):
        self._lock = threading.RLock()
        # (index, scope, kind, table) -> _Entry
        self._entries: Dict[Tuple[str, str, str, str], _Entry] = {}
        # (index, scope) -> last-use monotonic timestamp (LRU axis)
        self._scope_used: Dict[Tuple[str, str], float] = {}
        # (index, scope) -> eviction callback (drops the scope's staged
        # arrays so they lazily restage on next use); scopes without one
        # are not evictable (released only by their owner's lifecycle)
        self._scope_evict: Dict[Tuple[str, str], Callable[[], None]] = {}
        # scopes ever released: a re-register into one is a restage
        # ("probe"), not an "initial". Scope-level (not per-table) and
        # BOUNDED — segment/executor scope names are generation-unique,
        # so an unbounded set would grow forever under refresh/merge
        # churn; overflow drops the oldest (a long-evicted scope that
        # restages after 4096 later releases misclassifies as initial —
        # benign stat drift, not a leak). Cleared with release_index.
        self._released: Dict[Tuple[str, str], None] = {}
        self._total = 0
        self.staging_events: List[dict] = []
        self.eviction_events: List[dict] = []
        self.events_dropped = 0
        self.evictions_total = 0
        self.evicted_bytes_total = 0
        self.budget_denials_total = 0
        # device-staging fault model: classified terminal faults + the
        # bounded-retry counter, with a bounded event ring so operators
        # can join a plane demotion to the staging fault that caused it
        self.staging_retries_total = 0
        self.staging_faults_transient_total = 0
        self.staging_faults_deterministic_total = 0
        self.staging_fault_events: List[dict] = []
        # per-index restage-amplification inputs
        self._restaged: Dict[str, int] = {}
        self._logical: Dict[str, int] = {}
        # 0 = unlimited (the default: single-user tools and tests must
        # never trip a budget they didn't configure)
        self.budget_bytes = 0

    # -- breaker mirror -------------------------------------------------

    @staticmethod
    def _accounting_breaker():
        from elasticsearch_tpu_torch.common.breaker import (
            CircuitBreaker,
            breaker_service,
        )

        return breaker_service().get_breaker(CircuitBreaker.ACCOUNTING)

    def _mirror(self, delta: int) -> None:
        if delta:
            # never raises: budget enforcement is LRU-evict + plane
            # demotion (hbm_budget), not a 429
            self._accounting_breaker().add_without_breaking(delta)

    # -- ledger ---------------------------------------------------------

    def register(self, index: str, scope: str, kind: str, table: str,
                 nbytes: int, *, reason: str = "initial",
                 duration_ms: float = 0.0, plane: str = "host",
                 evict: Optional[Callable[[], None]] = None,
                 quiet: bool = False,
                 amplify_bytes: Optional[int] = None) -> None:
        """Record ``table`` (one staged array group) as holding
        ``nbytes`` of device memory. Re-registering the same key
        REPLACES its bytes (a restage, not a leak). ``quiet`` skips the
        event ring and amplification counters — for accumulator-style
        caches that re-register per increment (the ub-column cache).

        ``amplify_bytes`` decouples ledger truth from amplification
        truth for DELTA restages: a tombstone or slot append
        replaces a whole device array (the ledger must hold its full
        ``nbytes``) while only the changed slot ROWS were actually
        restaged — those row bytes feed the amplification counters and
        the event ring. ``delta_append`` rows count as restaged AND
        logically changed (new data arriving IS the logical change), so
        a pure-append refresh reports amplification ~1."""
        assert kind in KINDS, kind
        assert reason in REASONS, reason
        index = index or "_unassigned"
        key = (index, scope, kind, table)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _Entry()
                if (reason == "initial"
                        and (index, scope) in self._released):
                    reason = "probe"  # restaged after an eviction/release
            elif reason == "initial":
                # an in-place replacement of live bytes is a restage even
                # when the call site didn't classify it
                reason = "probe"
            delta = int(nbytes) - entry.bytes
            entry.bytes = int(nbytes)
            entry.stage_count += 1
            self._total += delta
            self._scope_used[(index, scope)] = time.monotonic()
            if evict is not None:
                self._scope_evict[(index, scope)] = evict
            if not quiet:
                amp = int(nbytes if amplify_bytes is None
                          else amplify_bytes)
                if reason == "initial":
                    self._logical[index] = (self._logical.get(index, 0)
                                            + amp)
                else:
                    self._restaged[index] = (self._restaged.get(index, 0)
                                             + amp)
                    if reason == "delta_append":
                        # the appended rows are new data: they grow the
                        # logical denominator too, keeping the ratio ~1
                        # for a clean append
                        self._logical[index] = (
                            self._logical.get(index, 0) + amp)
                self._push(self.staging_events, {
                    "index": index, "segment": scope, "kind": kind,
                    "table": table, "bytes": amp,
                    "duration_ms": round(float(duration_ms), 3),
                    "reason": reason, "plane": plane,
                    "timestamp_ms": int(time.time() * 1000),
                })
            self._mirror(delta)

    def _push(self, ring: List[dict], event: dict) -> None:
        ring.append(event)
        if len(ring) > self.MAX_EVENTS:
            del ring[0]
            self.events_dropped += 1

    def set_evict(self, index: str, scope: str,
                  evict: Callable[[], None]) -> None:
        """Arm (or re-arm) a scope's eviction callback AFTER its owner
        fully installed the staged generation. Registering the callback
        during construction would let the budget evict a half-built
        generation while the owner still points at the previous one —
        releasing the wrong scope (see MeshPlanExecutor.make_evictable).
        No-op for a scope with no live ledger entries."""
        with self._lock:
            key = (index or "_unassigned", scope)
            if any(k[0] == key[0] and k[1] == key[1]
                   for k in self._entries):
                self._scope_evict[key] = evict

    def touch(self, index: str, scope: str) -> None:
        """LRU hint: the scope's staged tables served a query."""
        with self._lock:
            key = (index or "_unassigned", scope)
            if key in self._scope_used:
                self._scope_used[key] = time.monotonic()

    def note_logical_change(self, index: str, nbytes: int) -> None:
        """Record bytes of data that LOGICALLY changed (docs indexed,
        live-mask bits flipped) — the denominator of restage
        amplification."""
        with self._lock:
            self._logical[index] = self._logical.get(index, 0) + int(nbytes)

    def note_staging_retry(self, index: str, kind: str) -> None:
        """One transient staging fault absorbed by the bounded-retry
        loop (common/staging.run_staged) — the attempt will re-run."""
        with self._lock:
            self.staging_retries_total += 1

    def note_staging_fault(self, index: str, kind: str, *,
                           transient: bool, retries: int = 0,
                           plane: str = "host",
                           error: str = "") -> None:
        """A TERMINAL staging fault (transient with retries exhausted,
        or deterministic): the caller rolled back its partial staging
        and is demoting the plane ladder — record it so
        ``search_stats()["memory"]`` can tell device pressure from a broken
        staging site."""
        with self._lock:
            if transient:
                self.staging_faults_transient_total += 1
            else:
                self.staging_faults_deterministic_total += 1
            self._push(self.staging_fault_events, {
                "index": index or "_unassigned", "kind": kind,
                "classification": ("transient" if transient
                                   else "deterministic"),
                "retries": int(retries), "plane": plane,
                "error": str(error)[:200],
                "timestamp_ms": int(time.time() * 1000),
            })

    def force_evict(self, scopes: int = 1) -> int:
        """Evict the N coldest evictable scopes regardless of budget (the
        lever tests use to drive the restage-after-eviction paths
        deterministically). Returns bytes evicted."""
        freed = 0
        with self._lock:
            for _ in range(max(0, int(scopes))):
                before = self.evictions_total
                freed += self._evict_locked(1)  # 1 byte => one scope
                if self.evictions_total == before:
                    break  # nothing evictable left
        return freed

    def release_scope(self, index: str, scope: str) -> int:
        """Release every table of one staging owner (segment retirement,
        executor rebuild, eviction). Returns the bytes released."""
        index = index or "_unassigned"
        with self._lock:
            keys = [k for k in self._entries
                    if k[0] == index and k[1] == scope]
            freed = 0
            for k in keys:
                freed += self._entries.pop(k).bytes
            self._scope_used.pop((index, scope), None)
            self._scope_evict.pop((index, scope), None)
            if keys:
                # remember the scope so a later restage classifies as
                # "probe" (bounded, recency-ordered — see _released)
                self._released.pop((index, scope), None)
                self._released[(index, scope)] = None
                while len(self._released) > self.MAX_RELEASED_SCOPES:
                    self._released.pop(next(iter(self._released)))
            self._total -= freed
            self._mirror(-freed)
            return freed

    def release_tables(self, index: str, scope: str,
                       tables: List[str]) -> int:
        """Release some tables of one scope (derived columns its owner
        dropped); the scope stays. Returns the bytes released."""
        index = index or "_unassigned"
        names = set(tables)
        with self._lock:
            keys = [k for k in self._entries
                    if k[0] == index and k[1] == scope and k[3] in names]
            freed = sum(self._entries.pop(k).bytes for k in keys)
            self._total -= freed
            self._mirror(-freed)
            return freed

    def release_index(self, index: str) -> int:
        """Index close/delete: release everything it still holds (the
        structured per-scope releases should have run already — this is
        the ledger-exactness backstop) and forget its restage history."""
        index = index or "_unassigned"
        with self._lock:
            for scope in {k[1] for k in self._entries if k[0] == index}:
                self.release_scope(index, scope)
            self._released = {k: None for k in self._released
                              if k[0] != index}
            self._restaged.pop(index, None)
            self._logical.pop(index, None)
            return 0

    # -- budget ---------------------------------------------------------

    def set_budget(self, nbytes: Optional[int]) -> None:
        """Dynamic budget update (search.memory.hbm_budget_bytes).
        Lowering the budget evicts immediately; the accounting breaker's
        limit mirrors it so _nodes/stats breakers shows the real bound."""
        self.budget_bytes = int(nbytes or 0)
        self._accounting_breaker().limit_bytes = self.budget_bytes
        if self.budget_bytes > 0:
            self.enforce_budget()

    def enforce_budget(self) -> int:
        """Evict coldest evictable scopes until the ledger fits the
        budget. Returns bytes evicted."""
        if self.budget_bytes <= 0:
            return 0
        with self._lock:
            return self._evict_locked(self._total - self.budget_bytes)

    def try_reserve(self, index: str, nbytes: int,
                    exclude_scope: Optional[str] = None,
                    mandatory: bool = False) -> bool:
        """Budget gate for a staging site about to allocate ``nbytes``.
        True = proceed. False = over budget even after LRU eviction —
        the caller must demote to the next plane rung (ladder reason
        ``hbm_budget``), never error. ``exclude_scope`` protects the
        scope being staged from evicting itself. ``mandatory`` marks a
        pressure-valve reservation the caller proceeds with regardless
        (host-rung tables the byte-parity contract needs): it still
        LRU-evicts to make room but an over-budget outcome is not a
        denial — ``budget_denials_total`` counts only real demotions."""
        if self.budget_bytes <= 0 or nbytes <= 0:
            return True
        index = index or "_unassigned"
        with self._lock:
            need = self._total + int(nbytes) - self.budget_bytes
            if need > 0:
                self._evict_locked(need, exclude=(index, exclude_scope))
            if self._total + int(nbytes) <= self.budget_bytes:
                return True
            if not mandatory:
                self.budget_denials_total += 1
            return False

    def _evict_locked(self, need: int,
                      exclude: Optional[Tuple[str, str]] = None) -> int:
        if need <= 0:
            return 0
        candidates = sorted(
            ((used, key) for key, used in self._scope_used.items()
             if key in self._scope_evict and key != exclude),
            key=lambda kv: kv[0])
        freed = 0
        for _used, (index, scope) in candidates:
            if freed >= need:
                break
            cb = self._scope_evict.get((index, scope))
            before = sum(e.bytes for k, e in self._entries.items()
                         if k[0] == index and k[1] == scope)
            try:
                if cb is not None:
                    cb()  # owner drops its arrays + releases its scope
            except Exception:  # noqa: BLE001 — eviction must terminate
                pass
            # idempotent backstop: the callback should have released
            self.release_scope(index, scope)
            freed += before
            self.evictions_total += 1
            self.evicted_bytes_total += before
            self._push(self.eviction_events, {
                "index": index, "segment": scope, "bytes": before,
                "timestamp_ms": int(time.time() * 1000),
            })
        return freed

    # -- export ---------------------------------------------------------

    def staged_bytes(self, index: Optional[str] = None) -> int:
        with self._lock:
            if index is None:
                return self._total
            return sum(e.bytes for k, e in self._entries.items()
                       if k[0] == index)

    def staged_bytes_by_kind(self, index: Optional[str] = None) -> dict:
        """Per-kind staged bytes. Sums EXACTLY to the ledger total for
        the same filter (the invariant of search_stats()["memory"])."""
        with self._lock:
            out = {kind: 0 for kind in KINDS}
            for (idx, _scope, kind, _table), e in self._entries.items():
                if index is None or idx == index:
                    out[kind] += e.bytes
            return out

    def stats(self, index: Optional[str] = None) -> dict:
        """The ``search.memory`` stats block (per index, or node-wide
        with ``index=None``). Event rings and eviction/denial counters
        are node-global (the budget is a node resource); byte sums and
        amplification are filtered."""
        with self._lock:
            by_kind = self.staged_bytes_by_kind(index)
            if index is None:
                restaged = sum(self._restaged.values())
                logical = sum(self._logical.values())
                staging = list(self.staging_events)
                evictions = list(self.eviction_events)
                faults = list(self.staging_fault_events)
            else:
                restaged = self._restaged.get(index, 0)
                logical = self._logical.get(index, 0)
                staging = [e for e in self.staging_events
                           if e["index"] == index]
                evictions = [e for e in self.eviction_events
                             if e["index"] == index]
                faults = [e for e in self.staging_fault_events
                          if e["index"] == index]
            return {
                "hbm_budget_bytes": self.budget_bytes,
                "staged_bytes_total": sum(by_kind.values()),
                "staged_bytes": by_kind,
                "restaged_bytes_total": restaged,
                "bytes_logically_changed_total": logical,
                "restage_amplification": (
                    round(restaged / logical, 4) if logical else None),
                "staging_events": staging,
                "eviction_events": evictions,
                "events_dropped": self.events_dropped,
                "evictions_total": self.evictions_total,
                "evicted_bytes_total": self.evicted_bytes_total,
                "budget_denials_total": self.budget_denials_total,
                # classified staging-fault model: retry/fault counters are
                # node-global like the eviction counters; the event
                # ring filters per index
                "staging_retries_total": self.staging_retries_total,
                "staging_faults_transient_total":
                    self.staging_faults_transient_total,
                "staging_faults_deterministic_total":
                    self.staging_faults_deterministic_total,
                "staging_fault_events": faults,
            }

    def table(self) -> List[dict]:
        """Per-(index, scope, kind) rows for the _cat/staging endpoint,
        hottest first."""
        with self._lock:
            now = time.monotonic()
            rows: Dict[Tuple[str, str, str], dict] = {}
            for (index, scope, kind, _table), e in self._entries.items():
                row = rows.setdefault((index, scope, kind), {
                    "index": index, "segment": scope, "kind": kind,
                    "bytes": 0, "tables": 0, "stage_count": 0,
                })
                row["bytes"] += e.bytes
                row["tables"] += 1
                row["stage_count"] += e.stage_count
            for key, row in rows.items():
                used = self._scope_used.get((key[0], key[1]))
                row["idle_s"] = (round(now - used, 3)
                                 if used is not None else None)
                row["evictable"] = (key[0], key[1]) in self._scope_evict
            return sorted(rows.values(),
                          key=lambda r: (r["idle_s"] is None,
                                         r["idle_s"] or 0.0))


# ---------------------------------------------------------------------------
# Process-level singleton (node startup configures the budget; staging
# sites reach it through memory_accountant())
# ---------------------------------------------------------------------------

_accountant: Optional[DeviceMemoryAccountant] = None
_accountant_lock = threading.Lock()


def memory_accountant() -> DeviceMemoryAccountant:
    global _accountant
    # lock-free fast path: this accessor sits on the per-query hot path
    # (every register/touch/reserve) — only the first call ever needs
    # the lock (assignment is atomic under the GIL)
    acct = _accountant
    if acct is not None:
        return acct
    with _accountant_lock:
        if _accountant is None:
            _accountant = DeviceMemoryAccountant()
        return _accountant
