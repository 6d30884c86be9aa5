"""In-process node-to-node transport with fault injection.

Counterpart of ``elasticsearch_tpu/transport/local.py``, copied but for
its imports. Role model: ``TransportService``/``TcpTransport`` for the
request/handler contract, and the test framework's
``MockTransportService`` + ``NetworkDisruption`` for programmable faults.
The transport carries the control plane of the in-process cluster
(``cluster/multinode.py``): cluster-state publish and the shard-level
requests between nodes. Requests are synchronous in-process calls;
payloads are JSON-able dicts (round-tripped through JSON in strict mode),
so no tensor crosses the hub.

- ``send_request`` takes a per-attempt ``timeout``: the delivery runs on a
  worker thread and the caller gives up with
  ``ReceiveTimeoutTransportException`` when the deadline passes, so an
  unresponsive peer cannot hang a coordination path.
- ``RetryPolicy`` is the ``RetryableAction`` analog: exponential backoff
  between attempts, a retryable-exception classification
  (connection-level failures and backpressure retry; remote handler
  failures do not), and an optional overall deadline.
- ``ConnectionHealth`` counts consecutive per-node failures and fast-fails
  (``ConnectTransportException``) to a node past the threshold inside a
  short quarantine window. ``TransportHub.heal`` / ``clear_disruptions``
  reset it.
- ``TransportHub`` hosts pluggable ``DisruptionScheme``s
  (``testing/disruption.py``): delay, seeded drop, one-way partition,
  unresponsive node, action blackhole, applied per delivery outside the
  hub lock.
- ``aggregate_transport_stats`` sums every live service's counters: the
  ``transport`` block of ``_nodes/stats``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Set, Tuple

from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException,
    ConnectTransportException,
    ElasticsearchTpuException,
    EsRejectedExecutionException,
    NodeNotConnectedException,
    ReceiveTimeoutTransportException,
)

logger = logging.getLogger("elasticsearch_tpu_torch.transport")

# every TransportService created in this process (weakly held): the
# resilience counters (retries, send timeouts, ConnectionHealth
# fast-fails) that _nodes/stats aggregates
_ALL_TRANSPORTS: "weakref.WeakSet" = weakref.WeakSet()
# guards registry mutation vs the stats snapshot: a node starting up
# concurrently with GET /_nodes/stats would otherwise race the WeakSet
# iteration ("Set changed size during iteration" -> 500)
_ALL_TRANSPORTS_LOCK = threading.Lock()


def aggregate_transport_stats() -> Dict[str, int]:
    """Process-wide transport resilience counters, summed over every
    live TransportService (the in-process hub spawns one per node; a
    single-node REST process reports zeros). Exported as the
    ``transport`` block of ``_nodes/stats``."""
    out: Dict[str, int] = {
        "services": 0, "requests_sent": 0, "retries": 0, "timeouts": 0,
        "fast_fails": 0, "failures": 0,
    }
    with _ALL_TRANSPORTS_LOCK:
        services = list(_ALL_TRANSPORTS)
    for svc in services:
        out["services"] += 1
        with svc._stats_lock:
            for key, v in svc.stats.items():
                out[key] = out.get(key, 0) + v
    return out


class RemoteActionException(ElasticsearchTpuException):
    """Wraps a failure raised by a remote handler."""

    status_code = 500


# connection-level trouble and backpressure are worth retrying; a handler
# that executed and failed (RemoteActionException etc.) is not — the op may
# have applied (RetryableAction.shouldRetry draws the same line)
DEFAULT_RETRYABLE = (
    NodeNotConnectedException,
    EsRejectedExecutionException,
    CircuitBreakingException,
)


class RetryPolicy:
    """``RetryableAction`` analog: exponential backoff between attempts.

    ``initial_backoff`` doubles (``backoff_multiplier``) per attempt up to
    ``max_backoff``; ``overall_timeout`` (optional) bounds the whole retry
    loop including backoff sleeps. ``retryable`` is the exception
    classification — only instances of these classes re-attempt.
    """

    def __init__(self, max_attempts: int = 3, initial_backoff: float = 0.05,
                 backoff_multiplier: float = 2.0, max_backoff: float = 2.0,
                 overall_timeout: Optional[float] = None,
                 retryable: Tuple[type, ...] = DEFAULT_RETRYABLE):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.initial_backoff = float(initial_backoff)
        self.backoff_multiplier = float(backoff_multiplier)
        self.max_backoff = float(max_backoff)
        self.overall_timeout = overall_timeout
        self.retryable = tuple(retryable)

    def is_retryable(self, exc: BaseException) -> bool:
        # a fast-fail never hit the wire: retrying it inside the same
        # send would just spin on the tracker — let the caller's own
        # failover/backoff handle it
        if isinstance(exc, ConnectTransportException):
            return False
        return isinstance(exc, self.retryable)

    def backoff(self, attempt: int) -> float:
        """Backoff before attempt ``attempt + 1`` (0-based)."""
        return min(self.max_backoff,
                   self.initial_backoff * (self.backoff_multiplier ** attempt))

    def derive(self, **overrides) -> "RetryPolicy":
        """Copy of this policy with some fields overridden — keeps
        derived policies in sync when RetryPolicy grows a field."""
        base = dict(max_attempts=self.max_attempts,
                    initial_backoff=self.initial_backoff,
                    backoff_multiplier=self.backoff_multiplier,
                    max_backoff=self.max_backoff,
                    overall_timeout=self.overall_timeout,
                    retryable=self.retryable)
        base.update(overrides)
        return RetryPolicy(**base)


class ConnectionHealth:
    """Per-node connection health with fast-fail (circuit-breaker shape).

    After ``failure_threshold`` consecutive failures the breaker OPENS
    for ``quarantine_s``: sends inside the window fast-fail with
    ``ConnectTransportException`` without touching the wire. At expiry
    the state fully resets — the next sends go to the wire and a fresh
    run of consecutive failures is needed to re-open. (The window is
    anchored at open time, NOT at the last failure: re-arming on every
    failed probe would starve a lossy-but-alive link — a 30% drop rate
    must degrade throughput, not permanently open the breaker.) A dead
    node still fast-fails for most of every window because its re-probes
    fail instantly and re-open the breaker.
    """

    def __init__(self, failure_threshold: int = 3, quarantine_s: float = 1.0):
        self.failure_threshold = int(failure_threshold)
        self.quarantine_s = float(quarantine_s)
        self._lock = threading.Lock()
        # node -> [consecutive_failures, breaker_open_monotonic]
        self._state: Dict[str, list] = {}

    def should_fast_fail(self, node: str) -> bool:
        with self._lock:
            st = self._state.get(node)
            if st is None or st[0] < self.failure_threshold:
                return False
            if time.monotonic() - st[1] >= self.quarantine_s:
                self._state.pop(node, None)  # expiry: full reset
                return False
            return True

    def on_success(self, node: str) -> None:
        with self._lock:
            self._state.pop(node, None)

    def on_failure(self, node: str) -> None:
        with self._lock:
            st = self._state.setdefault(node, [0, 0.0])
            st[0] += 1
            if st[0] <= self.failure_threshold:
                # the open timestamp freezes when the breaker trips; late
                # wire failures (in-flight when it tripped) don't extend
                # the window
                st[1] = time.monotonic()

    def failures(self, node: str) -> int:
        with self._lock:
            st = self._state.get(node)
            return st[0] if st else 0

    def reset(self, node: Optional[str] = None) -> None:
        with self._lock:
            if node is None:
                self._state.clear()
            else:
                self._state.pop(node, None)


class TransportHub:
    """The shared 'network': node registry + disruption rules."""

    def __init__(self, strict_serialization: bool = False):
        self._nodes: Dict[str, "TransportService"] = {}
        self._disconnected: Set[Tuple[str, str]] = set()
        self._delays: Dict[Tuple[str, str], float] = {}
        self._disruptions: list = []  # DisruptionScheme instances
        self._lock = threading.Lock()
        self.strict_serialization = strict_serialization
        self.requests_log: list = []  # (src, dst, action) — CapturingTransport

    def register(self, service: "TransportService") -> None:
        with self._lock:
            self._nodes[service.node_id] = service

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def nodes(self) -> Dict[str, "TransportService"]:
        with self._lock:
            return dict(self._nodes)

    # --- disruption schemes (NetworkDisruption behaviors) ---

    def disconnect(self, a: str, b: Optional[str] = None) -> None:
        """Break a<->b, or isolate `a` from everyone."""
        with self._lock:
            targets = [b] if b else [n for n in self._nodes if n != a]
            for t in targets:
                self._disconnected.add((a, t))
                self._disconnected.add((t, a))

    def heal(self, a: Optional[str] = None) -> None:
        with self._lock:
            if a is None:
                self._disconnected.clear()
                self._delays.clear()
            else:
                self._disconnected = {
                    (x, y) for x, y in self._disconnected if a not in (x, y)
                }
        self._reset_health(a)

    def add_disruption(self, scheme) -> None:
        """Install a ``DisruptionScheme`` (testing/disruption.py); applied
        to every subsequent delivery until removed."""
        with self._lock:
            if scheme not in self._disruptions:
                self._disruptions.append(scheme)

    def remove_disruption(self, scheme) -> None:
        with self._lock:
            if scheme in self._disruptions:
                self._disruptions.remove(scheme)
        self._reset_health(None)

    def clear_disruptions(self) -> None:
        with self._lock:
            self._disruptions.clear()
        self._reset_health(None)

    def _reset_health(self, node: Optional[str]) -> None:
        """The network just changed shape: forget learned per-node health
        so healed links are usable immediately (tests rely on heal() being
        deterministic, not racing a quarantine window). Healing ``node``
        clears every link touching it: its entry in every peer's tracker
        AND everything in its own."""
        for svc in self.nodes().values():
            if node is None or svc.node_id == node:
                svc.connection_health.reset()
            else:
                svc.connection_health.reset(node)

    def add_delay(self, a: str, b: str, seconds: float) -> None:
        with self._lock:
            self._delays[(a, b)] = seconds

    def deliver(self, src: str, dst: str, action: str, payload: Any) -> Any:
        with self._lock:
            if (src, dst) in self._disconnected:
                raise NodeNotConnectedException(
                    f"[{dst}] disconnected from [{src}]"
                )
            service = self._nodes.get(dst)
            delay = self._delays.get((src, dst), 0.0)
            schemes = [s for s in self._disruptions
                       if s.applies(src, dst, action)]
            self.requests_log.append((src, dst, action))
        # disruption effects run OUTSIDE the hub lock: a scheme may sleep
        # (delay / unresponsive node) and must not stall unrelated links
        for scheme in schemes:
            scheme.disrupt(src, dst, action)
        if service is None:
            raise NodeNotConnectedException(f"node [{dst}] is not in the cluster")
        if delay:
            time.sleep(delay)
        if self.strict_serialization:
            payload = json.loads(json.dumps(payload))
        return service.handle(action, payload, src)


class TransportService:
    def __init__(self, node_id: str, hub: TransportHub,
                 health: Optional[ConnectionHealth] = None):
        self.node_id = node_id
        self.hub = hub
        self._handlers: Dict[str, Callable[[Any, str], Any]] = {}
        self.connection_health = health or ConnectionHealth()
        # observability: retries/timeouts/fast-fails must be visible in
        # stats so disruption tests can assert the resilient path actually
        # exercised (the reference exposes the same through TransportStats)
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "requests_sent": 0, "retries": 0, "timeouts": 0,
            "fast_fails": 0, "failures": 0,
        }
        hub.register(self)
        with _ALL_TRANSPORTS_LOCK:
            _ALL_TRANSPORTS.add(self)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def register_handler(self, action: str, handler: Callable[[Any, str], Any]) -> None:
        """handler(payload, source_node_id) -> response."""
        self._handlers[action] = handler

    def handle(self, action: str, payload: Any, src: str) -> Any:
        handler = self._handlers.get(action)
        if handler is None:
            raise RemoteActionException(
                f"node [{self.node_id}] has no handler for action [{action}]"
            )
        return handler(payload, src)

    # ------------------------------------------------------------------

    def _deliver(self, target: str, action: str, payload: Any,
                 timeout: Optional[float]) -> Any:
        """One delivery attempt; with a timeout the call runs on a worker
        thread and is abandoned at the deadline (the late response is
        dropped, exactly like a real network)."""
        if timeout is None:
            return self.hub.deliver(self.node_id, target, action, payload)
        box: Dict[str, Any] = {}
        done = threading.Event()

        def run():
            try:
                box["value"] = self.hub.deliver(
                    self.node_id, target, action, payload)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["error"] = e
            finally:
                done.set()

        threading.Thread(target=run, daemon=True,
                         name=f"transport[{self.node_id}->{target}]").start()
        if not done.wait(timeout):
            self._bump("timeouts")
            raise ReceiveTimeoutTransportException(
                f"[{target}][{action}] request timed out after {timeout}s")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def send_request(self, target: str, action: str, payload: Any,
                     timeout: Optional[float] = None,
                     retry: Optional[RetryPolicy] = None) -> Any:
        """Send ``action`` to ``target``.

        ``timeout``: per-attempt deadline (seconds); None = wait forever
        (the pre-resilience behavior, kept for local same-thread calls).
        ``retry``: a RetryPolicy; None = single attempt.
        """
        if target == self.node_id:
            # local fast path: same-thread dispatch keeps RLock
            # reentrancy for nested master-service updates
            return self.handle(action, payload, self.node_id)
        if self.connection_health.should_fast_fail(target):
            self._bump("fast_fails")
            raise ConnectTransportException(
                f"[{target}] fast-fail: node is quarantined after "
                f"{self.connection_health.failures(target)} consecutive "
                f"failures")
        attempts = retry.max_attempts if retry else 1
        deadline = None
        if retry is not None and retry.overall_timeout is not None:
            deadline = time.monotonic() + retry.overall_timeout
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            self._bump("requests_sent")
            try:
                resp = self._deliver(target, action, payload, timeout)
                self.connection_health.on_success(target)
                return resp
            except Exception as e:  # noqa: BLE001 — classified below
                last = e
                if isinstance(e, NodeNotConnectedException):
                    self.connection_health.on_failure(target)
                self._bump("failures")
                if retry is None or not retry.is_retryable(e):
                    raise
                if attempt + 1 >= attempts:
                    raise
                pause = retry.backoff(attempt)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise
                    pause = min(pause, remaining)
                self._bump("retries")
                logger.info(
                    "retrying [%s] to [%s] after %s (attempt %d/%d, "
                    "backoff %.3fs)", action, target,
                    type(e).__name__, attempt + 1, attempts, pause)
                time.sleep(pause)
        raise last  # pragma: no cover — loop always returns or raises

    def close(self) -> None:
        self.hub.unregister(self.node_id)
