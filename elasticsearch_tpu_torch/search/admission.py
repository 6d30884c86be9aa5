"""Search admission control, the brownout ladder and the drain.

Counterpart of ``elasticsearch_tpu/search/admission.py``. One
``SearchAdmissionController`` an index, consulted by
``IndexService.search`` before any staging or launch work:

- a bounded admission queue (``search.queue.size``) in front of at most
  ``search.admission.max_concurrent`` searches in flight; an overflow is
  the clean 429 ``es_rejected_execution_exception`` with a
  ``Retry-After`` computed from the observed drain rate, never a timeout
  or a 5xx;
- per-tenant fairness: the tenant is the request's ``X-Opaque-Id``; the
  queue drains by weighted deficit round robin
  (``search.admission.weights``, ``tenant:weight,...``), and a tenant
  under its fair slice of a full queue displaces the newest entry of the
  tenant most over its slice;
- a deadline that expires while its entry is queued is shed before
  execution and answers the timed-out partial result;
- the brownout ladder: at queue-pressure thresholds
  (``search.admission.brownout.*``) an admitted request is forced onto
  the block-max pruned kernel (1e; the request carries its token's
  decision to the mesh plane through ``scoped_forced_pruning``, so the
  marker and the pruning agree), then loses its ``rescore``, then its
  aggregations and suggesters; each step marks the answer
  ``_degraded`` and counts, and the ladder steps back down as the queue
  drains;
- the adaptive micro-batch window (``effective_batch_window_s``): it
  widens with queue pressure up to ``search.batch.max_window_ms``;
- the drain: ``begin_drain`` refuses new searches with a 503 and
  ``Retry-After`` (``search.drain.deadline``), sheds the queued ones the
  same way, and ``await_drained`` waits for those in flight.

Every ``acquire`` ends in exactly one of admitted, rejected or
expired in queue, so the counters partition what was offered.
``testing/disruption.QueuePressureScheme`` pins synthetic occupancy,
withholds slots or slows the drain for deterministic overload tests.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (
    EsRejectedExecutionException,
    NodeDrainingException,
)

# tenant bucket for requests without an X-Opaque-Id header
DEFAULT_TENANT = "_anonymous"
# per-tenant accounting is bounded: an adversarial client minting a new
# opaque id per request must not grow the stats block without bound —
# tenants past the cap account under the shared overflow bucket (their
# queries still admit; only the ACCOUNTING coarsens)
MAX_TRACKED_TENANTS = 64
OVERFLOW_TENANT = "_other"

# brownout ladder steps, in escalation order (docs/OVERLOAD.md):
#   1 forced_pruned — force block-max pruned / gte-totals eligibility
#   2 shed_rescore  — drop the rescore phase
#   3 shed_features — drop aggs/aggregations/suggest
# step 4 (reject) is the queue-overflow 429, not a body transform
BROWNOUT_STEPS = ("forced_pruned", "shed_rescore", "shed_features")

# nested-search guard: collapse expansion / hybrid sides re-enter
# IndexService.search while the outer query already holds an admission
# slot — re-admitting would self-deadlock at max_concurrent=1. The
# contextvar survives the MicroBatcher's same-thread member execution.
_IN_ADMITTED_QUERY: contextvars.ContextVar[int] = contextvars.ContextVar(
    "es_tpu_torch_in_admitted_query", default=0)

# brownout step 1 as the admitted request's token decided it: the mesh
# plane's ``_pruning_config`` reads this, not the live level, so the
# ``forced_pruned`` marker and the pruning always agree even when the
# level moves between admission and launch (the JAX package reads the
# live level at launch). Nested searches keep their outer request's.
_FORCED_PRUNING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "es_tpu_torch_forced_pruning", default=False)


def forced_pruning() -> bool:
    """True inside a request admitted under brownout step 1."""
    return _FORCED_PRUNING.get()


@contextlib.contextmanager
def scoped_forced_pruning(token: "AdmissionToken"):
    """Carry ``token``'s step-1 decision through the block (a nested
    search's no-op token keeps the outer request's)."""
    if token.noop:
        yield
        return
    cv = _FORCED_PRUNING.set(bool(token.steps[0]))
    try:
        yield
    finally:
        _FORCED_PRUNING.reset(cv)


class _Entry:
    __slots__ = ("tenant", "deadline", "event", "state", "enqueued_at")

    def __init__(self, tenant: str, deadline):
        self.tenant = tenant
        self.deadline = deadline
        self.event = threading.Event()
        self.state = "queued"  # queued -> admitted | shed | closed
        self.enqueued_at = time.monotonic()


class AdmissionToken:
    """One admitted (or bypassed) query's handle: carries the brownout
    steps active at admission time and the release bookkeeping."""

    __slots__ = ("tenant", "steps", "shed_expired", "noop", "_cv_token",
                 "released")

    def __init__(self, tenant: str, steps=(False, False, False),
                 shed_expired: bool = False, noop: bool = False):
        self.tenant = tenant
        self.steps = steps
        self.shed_expired = shed_expired
        self.noop = noop
        self._cv_token = None
        self.released = False


def rejection(index_name: str, capacity: int, queued: int,
              retry_after_s: float) -> EsRejectedExecutionException:
    """The reference-shaped 429: ``type`` es_rejected_execution_exception
    and a ``reason`` naming the queue capacity. ``retry_after_s`` rides
    as an attribute (NOT body metadata) — the REST layer renders it as
    the ``Retry-After`` header, keeping the body byte-shape clean."""
    exc = EsRejectedExecutionException(
        f"rejected execution of search request on [{index_name}]: "
        f"search admission queue capacity [{capacity}] is full "
        f"(queued [{queued}])")
    exc.retry_after_s = float(retry_after_s)
    return exc


def drain_rejection(index_name: str,
                    retry_after_s: float) -> NodeDrainingException:
    """The graceful-drain 503: the node is restarting, so route around
    it and retry after the drain deadline. ``retry_after_s`` rides as an
    attribute and the REST layer renders the ``Retry-After`` header,
    exactly like the 429 rejections."""
    exc = NodeDrainingException(
        f"rejected execution of search request on [{index_name}]: "
        f"node is draining for shutdown/rollout")
    exc.retry_after_s = float(retry_after_s)
    return exc


class SearchAdmissionController:
    """Bounded admission queue + DRR fairness + brownout ladder for one
    index's query path.

    Thread-safe; consulted once per top-level search dispatch. Config is
    read live from the index's ``Settings`` map with explicitly-set
    cluster overrides winning (``set_cluster_overrides`` — the same
    explicitness contract as search.pallas.pruning.*)."""

    _OVERRIDE_PREFIXES = ("search.queue.", "search.admission.",
                          "search.drain.",
                          "search.batch.max_window_ms")

    def __init__(self, index_name: str, settings=None):
        self.index_name = index_name
        self._settings = settings
        self._overrides = None  # Settings of explicit cluster values
        self._lock = threading.Lock()
        self._shut = False
        # graceful drain: while True, new acquires get the
        # clean 503 + Retry-After and queued entries were shed; in-flight
        # queries finish (await_drained) before the node flushes/closes
        self._draining = False
        self.drain_rejected_total = 0
        # signaled whenever in_flight reaches 0 (the drain waiter's cue)
        self._idle = threading.Condition(self._lock)
        # per-tenant FIFO queues + the weighted-round-robin cursor
        self._queues: Dict[str, deque] = {}
        self._rr_order: List[str] = []
        self._rr_ptr = 0
        self._turn_served = 0
        self.in_flight = 0
        self._queued_total = 0
        # completion timestamps ring: the observed drain rate behind the
        # computed Retry-After
        self._completions: deque = deque(maxlen=64)
        # counters (exported as the _stats `search.admission` block)
        self.admitted_total = 0
        self.rejected_total = 0
        self.expired_in_queue_total = 0
        self.brownout_counts = {step: 0 for step in BROWNOUT_STEPS}
        self._level = 0
        self._steps = (False, False, False)
        self._transitions = {"enter": {}, "exit": {}}
        self._weights: Dict[str, int] = {}
        self._weights_spec: Optional[str] = None
        self._last_retry_after_s = 0.0
        # tenant -> {admitted_total, rejected_total, expired_in_queue
        #            _total, in_flight, queued}
        self._tenants: Dict[str, Dict[str, int]] = {}
        # bounded admission-order ring (tests assert DRR interleaving)
        self.admission_log: deque = deque(maxlen=256)

    # -- configuration -------------------------------------------------

    def set_cluster_overrides(self, committed) -> None:
        """Install the committed cluster settings' EXPLICIT overload
        keys as overrides (cleared keys revert to the index's own
        Settings — the value-only update consumers can't see
        explicitness, so put_cluster_settings syncs this whole map)."""
        data = {}
        for key in committed.keys():
            if any(key.startswith(p) or key == p
                   for p in self._OVERRIDE_PREFIXES):
                data[key] = committed.get(key)
        from elasticsearch_tpu_torch.common.settings import Settings

        self._overrides = Settings(data) if data else None

    def _cfg(self, getter: str, key: str, default):
        for source in (self._overrides, self._settings):
            if source is not None and source.get(key) is not None:
                return getattr(source, getter)(key, default)
        return default

    def _enabled(self) -> bool:
        return bool(self._cfg("get_bool", "search.admission.enabled", True))

    def _queue_size(self) -> int:
        return max(1, int(self._cfg("get_int", "search.queue.size", 1000)))

    def _max_concurrent(self) -> int:
        v = int(self._cfg("get_int", "search.admission.max_concurrent", 0))
        if v > 0:
            return v
        # auto: mirror the search threadpool's sizing, floored so small
        # hosts don't throttle below the micro-batcher's q_batch
        import os

        cores = os.cpu_count() or 4
        return max(16, 3 * cores // 2 + 1)

    def _weight(self, tenant: str) -> int:
        spec = self._cfg("get_str", "search.admission.weights", "") or ""
        if spec != self._weights_spec:
            # parse once per spec value — the dequeue loop consults
            # weights under the controller lock on the query hot path
            parsed: Dict[str, int] = {}
            for part in spec.split(","):
                if ":" in part:
                    name, _, w = part.strip().rpartition(":")
                    try:
                        parsed[name] = max(1, int(w))
                    except ValueError:
                        parsed[name] = 1
            self._weights = parsed
            self._weights_spec = spec
        return self._weights.get(tenant, 1)

    def _thresholds(self) -> Tuple[float, float, float]:
        return (
            float(self._cfg("get_float",
                            "search.admission.brownout.pruned_threshold",
                            0.25)),
            float(self._cfg("get_float",
                            "search.admission.brownout.rescore_threshold",
                            0.5)),
            float(self._cfg("get_float",
                            "search.admission.brownout.features_threshold",
                            0.75)),
        )

    # -- pressure / brownout -------------------------------------------

    def _synthetic_pressure(self, count_hit: bool = True):
        from elasticsearch_tpu_torch.testing.disruption import queue_pressure

        return queue_pressure(self.index_name, count_hit=count_hit)

    def _pressure_locked(self, occupancy: int) -> float:
        return (self._queued_total + occupancy) / float(self._queue_size())

    def _active_steps(self, pressure: float):
        """Each ladder step activates against ITS OWN threshold — an
        operator may disable one step (threshold > 1) without skewing
        the others. With the default ordered thresholds this reduces to
        the classic monotonic ladder."""
        t1, t2, t3 = self._thresholds()
        return (pressure >= t1, pressure >= t2, pressure >= t3)

    def _update_level_locked(self, occupancy: int) -> int:
        steps = self._active_steps(self._pressure_locked(occupancy))
        self._steps = steps
        new = sum(steps)
        old = self._level
        if new != old:
            lo, hi = sorted((old, new))
            for step in range(lo + 1, hi + 1):
                bucket = "enter" if new > old else "exit"
                t = self._transitions[bucket]
                t[str(step)] = t.get(str(step), 0) + 1
            self._level = new
        return new

    @property
    def brownout_level(self) -> int:
        return self._level

    def apply_brownout(self, body: dict, token) -> Tuple[dict, List[str]]:
        """Shape an admitted request per the token's active brownout
        steps: returns (possibly-stripped body, degraded markers).
        Counts each applied step per reason."""
        steps = token.steps if token is not None else (False,) * 3
        if not any(steps):
            return body, []
        degraded = []
        out = body

        def shed(step: str, marker: str) -> None:
            degraded.append(marker)
            with self._lock:
                self.brownout_counts[step] += 1

        if steps[0]:
            # step 1: pruned/gte-totals eligibility is forced through
            # scoped_forced_pruning (plan_exec._pruning_config); the
            # marker records the response ran under the forced mode
            shed("forced_pruned", "forced_pruned")
        if steps[1] and "rescore" in (out or {}):
            out = {k: v for k, v in out.items() if k != "rescore"}
            shed("shed_rescore", "rescore")
        if steps[2]:
            stripped = [k for k in ("aggs", "aggregations", "suggest")
                        if k in (out or {})]
            if stripped:
                out = {k: v for k, v in out.items() if k not in stripped}
                for key in stripped:
                    shed("shed_features", key)
        return out, degraded

    def effective_batch_window_s(self, base_s: float) -> float:
        """Adaptive micro-batch window: widens linearly with queue
        pressure from the configured base up to
        ``search.batch.max_window_ms``, trading p50 for throughput
        under load (docs/BATCHING.md). Unloaded indices keep the base
        window — the zero-added-latency contract is untouched."""
        if not self._enabled():
            return base_s
        max_s = float(self._cfg("get_float", "search.batch.max_window_ms",
                                5.0)) / 1000.0
        if max_s <= base_s:
            return base_s
        occupancy, _blocked, _delay = self._synthetic_pressure(
            count_hit=False)
        with self._lock:
            pressure = min(1.0, self._pressure_locked(occupancy))
        return base_s + (max_s - base_s) * pressure

    # -- admit / release -----------------------------------------------

    def _tenant_bucket(self, tenant: str) -> Dict[str, int]:
        b = self._tenants.get(tenant)
        if b is None:
            if (len(self._tenants) >= MAX_TRACKED_TENANTS
                    and tenant != OVERFLOW_TENANT):
                return self._tenant_bucket(OVERFLOW_TENANT)
            b = {"admitted_total": 0, "rejected_total": 0,
                 "expired_in_queue_total": 0, "in_flight": 0, "queued": 0}
            self._tenants[tenant] = b
        return b

    def _drain_rate_locked(self) -> float:
        """Completions per second over the recent completion ring."""
        now = time.monotonic()
        recent = [t for t in self._completions if now - t <= 5.0]
        if len(recent) < 2:
            return 0.0
        span = max(now - recent[0], 1e-6)
        return len(recent) / span

    def _retry_after_locked(self, occupancy: int) -> float:
        """Seconds until the queue has plausibly drained one slot for
        this client — the shared drain-rate estimator the thread-pool
        rejections use, so both 429 sources stay consistent."""
        from elasticsearch_tpu_torch.common.thread_pool import (
            estimate_retry_after,
        )

        ra = estimate_retry_after(self._completions,
                                  self._queued_total + occupancy + 1)
        self._last_retry_after_s = ra
        return ra

    def acquire(self, deadline=None, tenant: Optional[str] = None):
        """Admit one search dispatch. Returns an :class:`AdmissionToken`
        (``shed_expired`` set when the entry's deadline expired while
        queued — the caller serves the partial timed-out response
        WITHOUT executing), or raises the 429 rejection on overflow.
        Every call must be paired with ``release`` via try/finally."""
        if _IN_ADMITTED_QUERY.get():
            return AdmissionToken(DEFAULT_TENANT, noop=True)
        if tenant is None:
            from elasticsearch_tpu_torch.search.telemetry import get_opaque_id

            tenant = get_opaque_id() or DEFAULT_TENANT
        if self._draining:
            # the drain: stop admitting — the
            # clean 503 + Retry-After, counted into the exact
            # admitted/rejected/expired partition (rejected side).
            # Checked BEFORE the enabled kill switch: disabling
            # admission must not void the drain contract (with the
            # switch off, in-flight work is untracked and await_drained
            # cannot wait for it — but new arrivals still get the 503)
            with self._lock:
                if self._draining:
                    self.rejected_total += 1
                    self.drain_rejected_total += 1
                    self._tenant_bucket(tenant)["rejected_total"] += 1
                    raise drain_rejection(self.index_name,
                                          self._drain_deadline_s())
        if not self._enabled():
            return AdmissionToken(DEFAULT_TENANT, noop=True)
        occupancy, blocked, _delay = self._synthetic_pressure()
        entry = None
        with self._lock:
            if self._draining:
                # re-check under the lock: a drain may have begun
                # between the fast check above and here
                self.rejected_total += 1
                self.drain_rejected_total += 1
                self._tenant_bucket(tenant)["rejected_total"] += 1
                raise drain_rejection(self.index_name,
                                      self._drain_deadline_s())
            limit = max(0, self._max_concurrent() - blocked)
            self._update_level_locked(occupancy)
            # opportunistic drain: queued entries stranded by a since-
            # raised limit (a removed QueuePressureScheme) admit here
            # instead of waiting for the next release
            self._dequeue_locked(blocked)
            if (self.in_flight < limit and self._queued_total == 0
                    and not self._shut):
                return self._grant_locked(tenant)
            if (self._queued_total + occupancy >= self._queue_size()
                    or self._shut):
                # fair-share queue displacement: the overflow check is
                # otherwise tenant-blind — a hot tenant's many clients
                # win the race to ENQUEUE and a light tenant would see
                # only 429s even though DRR would serve it. When the
                # arriving tenant sits under its fair slice of the
                # queue, the most-over-slice tenant's NEWEST entry is
                # displaced (it gets the clean 429 + Retry-After); the
                # light tenant takes the slot. Converges to at most a
                # fair slice per tenant under sustained contention.
                if self._shut or not self._displace_for_locked(tenant):
                    self.rejected_total += 1
                    self._tenant_bucket(tenant)["rejected_total"] += 1
                    raise rejection(self.index_name, self._queue_size(),
                                    self._queued_total,
                                    self._retry_after_locked(occupancy))
            entry = _Entry(tenant, deadline)
            q = self._queues.get(tenant)
            if q is None:
                q = deque()
                self._queues[tenant] = q
                self._rr_order.append(tenant)
            q.append(entry)
            self._queued_total += 1
            self._tenant_bucket(tenant)["queued"] += 1
        return self._wait(entry)

    def _grant_locked(self, tenant: str) -> AdmissionToken:
        self.in_flight += 1
        self.admitted_total += 1
        b = self._tenant_bucket(tenant)
        b["admitted_total"] += 1
        b["in_flight"] += 1
        self.admission_log.append(tenant)
        token = AdmissionToken(tenant, steps=self._steps)
        token._cv_token = _IN_ADMITTED_QUERY.set(1)
        return token

    def _wait(self, entry: _Entry) -> AdmissionToken:
        while True:
            timeout = None
            if entry.deadline is not None \
                    and entry.deadline.expires_at is not None:
                timeout = max(entry.deadline.expires_at - time.monotonic(),
                              0.0) + 0.005
            fired = entry.event.wait(timeout)
            with self._lock:
                if entry.state == "admitted":
                    # the dequeuer already did the grant bookkeeping;
                    # build the caller-side token here
                    token = AdmissionToken(entry.tenant,
                                           steps=self._steps)
                    token._cv_token = _IN_ADMITTED_QUERY.set(1)
                    return token
                if entry.state in ("shed", "closed", "displaced",
                                   "draining"):
                    if entry.state == "draining":
                        # the node began draining while this entry was
                        # queued: its clean 503 (counted by begin_drain)
                        raise drain_rejection(self.index_name,
                                              self._drain_deadline_s())
                    if entry.state in ("closed", "displaced"):
                        # displacement/shutdown: this entry's clean 429
                        # (already counted by the displacer)
                        raise rejection(
                            self.index_name, self._queue_size(),
                            self._queued_total,
                            self._last_retry_after_s or 1.0)
                    return AdmissionToken(entry.tenant, shed_expired=True)
                if not fired and entry.deadline is not None \
                        and entry.deadline.expired:
                    # self-wake on an expired deadline while still
                    # queued: shed pre-execution (no dequeuer needed)
                    self._remove_queued_locked(entry)
                    self._shed_locked(entry)
                    return AdmissionToken(entry.tenant, shed_expired=True)

    def _displace_for_locked(self, tenant: str) -> bool:
        """Try to free one queue slot for ``tenant`` by rejecting the
        newest queued entry of the tenant holding the most slots. Only
        fires when the arriver is UNDER its fair slice and the victim
        is OVER it (strictly above the arriver too, so displacement
        always reduces imbalance and cannot thrash between equals)."""
        if not self._queues:
            return False
        # the REAL queue depth, not the stats bucket: past the tenant-
        # tracking cap a tenant's counters accrue under _other, which
        # would read as 0 here and let an over-slice tenant keep
        # displacing others
        my_queued = len(self._queues.get(tenant, ()))
        n_active = len(self._queues) + (0 if tenant in self._queues
                                        else 1)
        fair_slice = max(1, self._queue_size() // max(1, n_active))
        if my_queued >= fair_slice:
            return False
        victim_tenant = max(self._queues, key=lambda t: len(self._queues[t]))
        victim_q = self._queues[victim_tenant]
        if len(victim_q) <= max(fair_slice, my_queued + 1):
            return False
        entry = victim_q.pop()  # newest: least sunk queue time
        self._queued_total -= 1
        self._tenant_bucket(victim_tenant)["queued"] -= 1
        if not victim_q:
            self._retire_tenant_locked(victim_tenant)
        entry.state = "displaced"
        self.rejected_total += 1
        self._tenant_bucket(victim_tenant)["rejected_total"] += 1
        entry.event.set()
        return True

    def _remove_queued_locked(self, entry: _Entry) -> None:
        q = self._queues.get(entry.tenant)
        if q is not None and entry in q:
            q.remove(entry)
            self._queued_total -= 1
            self._tenant_bucket(entry.tenant)["queued"] -= 1
            if not q:
                self._retire_tenant_locked(entry.tenant)

    def _retire_tenant_locked(self, tenant: str) -> None:
        self._queues.pop(tenant, None)
        if tenant in self._rr_order:
            idx = self._rr_order.index(tenant)
            self._rr_order.remove(tenant)
            if idx < self._rr_ptr:
                self._rr_ptr -= 1
            if self._rr_ptr >= len(self._rr_order):
                self._rr_ptr = 0
                self._turn_served = 0

    def _shed_locked(self, entry: _Entry) -> None:
        entry.state = "shed"
        self.expired_in_queue_total += 1
        self._tenant_bucket(entry.tenant)["expired_in_queue_total"] += 1
        entry.event.set()

    def _next_entry_locked(self) -> Optional[_Entry]:
        """Weighted round-robin pop: each tenant's turn serves up to its
        weight entries before the cursor advances — the deficit-round-
        robin schedule for unit-cost work items."""
        while self._rr_order:
            if self._rr_ptr >= len(self._rr_order):
                self._rr_ptr = 0
                self._turn_served = 0
            tenant = self._rr_order[self._rr_ptr]
            q = self._queues.get(tenant)
            if not q:
                self._retire_tenant_locked(tenant)
                self._turn_served = 0
                continue
            if self._turn_served >= self._weight(tenant):
                self._rr_ptr += 1
                self._turn_served = 0
                continue
            self._turn_served += 1
            entry = q.popleft()
            self._queued_total -= 1
            self._tenant_bucket(tenant)["queued"] -= 1
            if not q:
                self._retire_tenant_locked(tenant)
                self._turn_served = 0
            return entry
        return None

    def _dequeue_locked(self, blocked: int) -> None:
        limit = max(0, self._max_concurrent() - blocked)
        while self.in_flight < limit:
            entry = self._next_entry_locked()
            if entry is None:
                return
            if entry.deadline is not None and entry.deadline.expired:
                # shed BEFORE execution: the expired entry never
                # reaches staging/launch work
                self._shed_locked(entry)
                continue
            entry.state = "admitted"
            self.in_flight += 1
            self.admitted_total += 1
            b = self._tenant_bucket(entry.tenant)
            b["admitted_total"] += 1
            b["in_flight"] += 1
            self.admission_log.append(entry.tenant)
            entry.event.set()

    def release(self, token) -> None:
        if token is None or token.noop or token.shed_expired \
                or token.released:
            if token is not None and not token.released \
                    and token._cv_token is not None:
                _IN_ADMITTED_QUERY.reset(token._cv_token)
                token._cv_token = None
            if token is not None:
                token.released = True
            return
        token.released = True
        if token._cv_token is not None:
            _IN_ADMITTED_QUERY.reset(token._cv_token)
            token._cv_token = None
        occupancy, blocked, delay = self._synthetic_pressure(
            count_hit=False)
        if delay > 0:
            time.sleep(delay)  # QueuePressureScheme: slowed drain
        with self._lock:
            self.in_flight -= 1
            b = self._tenant_bucket(token.tenant)
            b["in_flight"] -= 1
            self._completions.append(time.monotonic())
            self._dequeue_locked(blocked)
            self._update_level_locked(occupancy)
            if self.in_flight == 0:
                self._idle.notify_all()  # drain waiters (await_drained)

    def refresh_level(self) -> int:
        """Recompute the brownout level from current pressure (queued +
        synthetic occupancy) without admitting anything — the consult
        point for tests and for pressure sources outside the
        acquire/release cycle."""
        occupancy, _blocked, _delay = self._synthetic_pressure(
            count_hit=False)
        with self._lock:
            return self._update_level_locked(occupancy)

    # -- graceful drain -------------------------------------------------

    def _drain_deadline_s(self) -> float:
        v = self._cfg("get_time", "search.drain.deadline", 30.0)
        return float(v) if v is not None else 30.0

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> int:
        """Enter the draining state: new acquires get the clean 503 +
        Retry-After, every QUEUED entry is shed with the same contract
        (counted — no silent drops), and in-flight queries keep their
        slots until they finish (``await_drained``). Returns how many
        queued entries were shed. Idempotent."""
        with self._lock:
            if self._draining:
                return 0
            self._draining = True
            shed = 0
            for q in self._queues.values():
                for entry in q:
                    entry.state = "draining"
                    self.rejected_total += 1
                    self.drain_rejected_total += 1
                    self._tenant_bucket(entry.tenant)["rejected_total"] += 1
                    entry.event.set()
                    shed += 1
            self._queues.clear()
            self._rr_order = []
            self._queued_total = 0
            for b in self._tenants.values():
                b["queued"] = 0
            return shed

    def await_drained(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every in-flight search released its slot (True)
        or the drain deadline passed (False — the caller proceeds with
        shutdown anyway; stragglers fail their shard the normal way)."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self._drain_deadline_s())
        with self._idle:
            while self.in_flight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return True

    def end_drain(self) -> None:
        """Cancel a drain (rollout aborted): the node admits again."""
        with self._lock:
            self._draining = False

    def shutdown(self) -> None:
        """Index close: wake every queued waiter with a clean rejection
        (pool-shutdown semantics — nobody hangs on a closed index)."""
        with self._lock:
            self._shut = True
            for q in self._queues.values():
                for entry in q:
                    entry.state = "closed"
                    # counted here so admitted+rejected+expired still
                    # partitions offered exactly through a close
                    self.rejected_total += 1
                    self._tenant_bucket(entry.tenant)["rejected_total"] \
                        += 1
                    entry.event.set()
            self._queues.clear()
            self._rr_order = []
            self._queued_total = 0
            for b in self._tenants.values():
                b["queued"] = 0

    # -- stats ----------------------------------------------------------

    def stats_dict(self) -> dict:
        """The ``search.admission`` stats block (docs/OBSERVABILITY.md).
        Every key documented; the ``tenants`` subtree is keyed by
        client-chosen X-Opaque-Id values (cardinality-capped)."""
        with self._lock:
            return {
                "queue_capacity": self._queue_size(),
                "queued": self._queued_total,
                "in_flight": self.in_flight,
                "admitted_total": self.admitted_total,
                "rejected_total": self.rejected_total,
                "expired_in_queue_total": self.expired_in_queue_total,
                "draining": self._draining,
                "drain_rejected_total": self.drain_rejected_total,
                "brownout_level": self._level,
                "brownout": {f"{step}_total": n for step, n
                             in self.brownout_counts.items()},
                "brownout_transitions": {
                    k: dict(v) for k, v in self._transitions.items()},
                "retry_after_s": round(self._last_retry_after_s, 3),
                "drain_rate_qps": round(self._drain_rate_locked(), 3),
                "tenants": {t: dict(b)
                            for t, b in sorted(self._tenants.items())},
            }

