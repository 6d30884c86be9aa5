"""Named bounded executors with rejection: the node's thread pools.

Counterpart of ``elasticsearch_tpu/common/thread_pool.py``: fixed pools
per workload class (search, write, get, management, generic) with bounded
queues, and ``EsRejectedExecutionException`` when a queue is full, which
the REST layer answers with HTTP 429 and a ``Retry-After`` header. The
bounded queue is the backpressure: a node drowning in search traffic
rejects new work instead of queueing without bound.

Pool sizing follows the reference's formulas scaled to this process:
search = 3*cores/2+1 with queue 1000, write = cores with queue 200,
get = cores with queue 1000, management/generic = small pools.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.common.errors import EsRejectedExecutionException


@dataclass
class PoolStats:
    threads: int
    queue_size: int
    active: int = 0
    queue: int = 0
    rejected: int = 0
    completed: int = 0

    def as_dict(self) -> dict:
        return {
            "threads": self.threads,
            "queue_size": self.queue_size,
            "active": self.active,
            "queue": self.queue,
            "rejected": self.rejected,
            "completed": self.completed,
        }


_STOP = object()  # worker shutdown sentinel


def estimate_retry_after(completions, waiting: int) -> float:
    """Seconds until ``waiting`` work items have plausibly drained one
    slot, from a ring of recent completion timestamps (monotonic
    seconds): the Retry-After a 429 carries, clamped [1, 30] and
    defaulting to 1s without enough signal."""
    now = time.monotonic()
    recent = [t for t in completions if now - t <= 5.0]
    if len(recent) < 2:
        return 1.0
    rate = len(recent) / max(now - recent[0], 1e-6)
    return min(max(waiting / rate, 1.0), 30.0)


def retry_after_header_value(seconds: float) -> str:
    """Integral-seconds Retry-After (RFC 7231 delay-seconds form),
    rounded UP so a client honoring it never retries early (a copy of
    ``elasticsearch_tpu/search/admission.py``'s)."""
    return str(max(1, int(math.ceil(float(seconds)))))


class _Executor:
    """Fixed worker pool over a bounded queue (EsThreadPoolExecutor).
    Workers start lazily on the first submit and block on the queue (no
    idle polling); shutdown completes queued futures with a rejection so
    no caller hangs forever."""

    def __init__(self, name: str, threads: int, queue_size: int):
        self.name = name
        self.threads = threads
        self.queue_size = queue_size
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._lock = threading.Lock()
        self._active = 0
        self._rejected = 0
        self._completed = 0
        self._shut = False
        self._workers: list = []
        # recent completion timestamps: the observed drain rate behind
        # the Retry-After a rejection carries, so a client backs off in
        # proportion to the real overload instead of a fixed guess
        self._completions: deque = deque(maxlen=64)

    def _ensure_workers(self) -> None:
        with self._lock:
            if self._workers or self._shut:
                return
            self._workers = [
                threading.Thread(target=self._worker, daemon=True,
                                 name=f"estpu[{self.name}][{i}]")
                for i in range(self.threads)
            ]
            for w in self._workers:
                w.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            fn, future = item
            with self._lock:
                self._active += 1
            try:
                future.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                future.set_exception(e)
            finally:
                with self._lock:
                    self._active -= 1
                    self._completed += 1
                    self._completions.append(time.monotonic())

    def submit(self, fn: Callable[[], Any]) -> Future:
        """Enqueue; raises EsRejectedExecutionException when the bounded
        queue is full (the backpressure signal). The shut-check and the
        enqueue happen under the pool lock so a concurrent shutdown can
        never strand a task behind the stop sentinels (which would hang
        its caller forever)."""
        self._ensure_workers()
        future: Future = Future()
        with self._lock:
            if self._shut:
                raise EsRejectedExecutionException(
                    f"rejected execution on [{self.name}]: pool is shut "
                    f"down")
            try:
                self._queue.put_nowait((fn, future))
            except queue.Full:
                self._rejected += 1
                exc = EsRejectedExecutionException(
                    f"rejected execution on [{self.name}]: queue capacity "
                    f"[{self.queue_size}] is full")
                exc.retry_after_s = estimate_retry_after(
                    self._completions, self._queue.qsize())
                raise exc from None
        return future

    def resize_queue(self, queue_size: int) -> None:
        """A dynamic queue bound (``search.queue.size``): the stdlib queue
        checks ``maxsize`` at each put, so changing it under the queue's
        mutex bounds every later submit; queued work is never dropped by
        a shrink."""
        queue_size = max(1, int(queue_size))
        with self._queue.mutex:
            self._queue.maxsize = queue_size
            self._queue.not_full.notify_all()
        self.queue_size = queue_size

    def stats(self) -> PoolStats:
        with self._lock:
            return PoolStats(
                threads=self.threads, queue_size=self.queue_size,
                active=self._active, queue=self._queue.qsize(),
                rejected=self._rejected, completed=self._completed)

    def shutdown(self) -> None:
        with self._lock:
            self._shut = True  # submits are locked out from here on
            started = len(self._workers)
            # fail queued-but-unstarted work so blocked callers wake up
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    item[1].set_exception(EsRejectedExecutionException(
                        f"[{self.name}] shut down before execution"))
        # sentinels outside the lock: workers may need to drain a few
        # before capacity frees when threads > queue_size
        for _ in range(started):
            self._queue.put(_STOP)


class ThreadPool:
    """The node's named executors (ThreadPool.Names)."""

    def __init__(self, cores: Optional[int] = None,
                 overrides: Optional[Dict[str, dict]] = None):
        cores = cores or os.cpu_count() or 4
        spec = {
            # the reference's sizing formulas (ThreadPool.java halfProc etc.)
            "search": {"threads": 3 * cores // 2 + 1, "queue_size": 1000},
            "write": {"threads": cores, "queue_size": 200},
            "get": {"threads": cores, "queue_size": 1000},
            "management": {"threads": max(2, cores // 2),
                           "queue_size": 100},
            "generic": {"threads": max(4, cores), "queue_size": 500},
        }
        for name, over in (overrides or {}).items():
            spec.setdefault(name, {"threads": 2, "queue_size": 100})
            spec[name].update(over)
        self.executors: Dict[str, _Executor] = {
            name: _Executor(name, **cfg) for name, cfg in spec.items()
        }

    def executor(self, name: str) -> _Executor:
        return self.executors.get(name) or self.executors["generic"]

    def submit(self, name: str, fn: Callable[[], Any]) -> Future:
        return self.executor(name).submit(fn)

    def run(self, name: str, fn: Callable[[], Any],
            timeout: Optional[float] = None):
        """Submit + wait: the REST dispatch pattern (handler work runs on
        the action's executor; the IO thread blocks for the response)."""
        return self.submit(name, fn).result(timeout)

    def stats(self) -> dict:
        return {name: ex.stats().as_dict()
                for name, ex in sorted(self.executors.items())}

    def shutdown(self) -> None:
        for ex in self.executors.values():
            ex.shutdown()
