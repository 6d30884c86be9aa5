"""Search deadlines and cooperative cancellation checkpoints.

Counterpart of ``elasticsearch_tpu/search/cancellation.py``. One
``SearchDeadline`` is made a search request (``Node.search``, or
``IndexService.search`` for a direct caller with a ``timeout``) and
threaded through the coordinator's fan-out, each shard's query phase and
the mesh plane's ladder. Execution calls ``checkpoint()`` between units
of work (shards, segments, staging steps, before a launch):

- a cancelled task raises ``TaskCancelledException`` (a clean request
  error);
- an expired deadline raises ``TimeExceededException``, an internal
  signal that the nearest partial-result boundary turns into
  ``timed_out: true`` with the hits gathered so far.

A checkpoint never falls between a launch and the read of its output, so
an expired or cancelled request leaves no device work in flight.
``Node.search`` registers an ``indices:data/read/search`` task
(``tasks/task_manager.py``) and hands it to the deadline, so
``_tasks/{id}/_cancel`` trips the same checkpoints.
"""

from __future__ import annotations

import time
from typing import Optional


class TimeExceededException(Exception):
    """Internal: the search deadline expired. Never reaches a client: the
    catcher returns the partial result with ``timed_out: true``."""


class SearchDeadline:
    """Deadline and cancellation checkpoints for one search request.

    ``timeout_s``: None (or <= 0) is no time bound. ``task``: an object
    whose ``ensure_not_cancelled()`` trips the same checkpoints. The
    object is shared by the request's shards, so ``timed_out`` records
    whether any checkpoint expired (the response's top-level flag)."""

    def __init__(self, timeout_s: Optional[float] = None, task=None):
        self.expires_at = (time.monotonic() + timeout_s
                           if timeout_s is not None and timeout_s > 0
                           else None)
        self.task = task
        self.timed_out = False
        self.checkpoints = 0

    @property
    def expired(self) -> bool:
        return (self.expires_at is not None
                and time.monotonic() >= self.expires_at)

    def checkpoint(self) -> None:
        """Between-units check: raises ``TaskCancelledException`` (a
        cancel wins over the timeout) or ``TimeExceededException``."""
        self.checkpoints += 1
        if self.task is not None:
            self.task.ensure_not_cancelled()
        if self.expired:
            self.timed_out = True
            raise TimeExceededException()


def parse_search_timeout(body: dict, settings=None) -> Optional[float]:
    """A request's query-phase timeout in seconds: the ``timeout`` value
    ("50ms", "2s", a bare number of milliseconds) or the node's
    ``search.default_search_timeout``; None is unbounded."""
    from elasticsearch_tpu_torch.common.settings import parse_time_value

    raw = (body or {}).get("timeout")
    if raw is not None:
        if isinstance(raw, (int, float)) and not isinstance(raw, bool):
            return float(raw) / 1000.0  # a bare number is millis
        return parse_time_value(raw, "timeout")
    if settings is not None:
        from elasticsearch_tpu_torch.common.settings import (
            SEARCH_DEFAULT_TIMEOUT,
        )

        return SEARCH_DEFAULT_TIMEOUT.get(settings)
    return None
