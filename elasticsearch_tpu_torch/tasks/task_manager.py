"""Task management: the registry of running operations, with cancellation.

Counterpart of ``elasticsearch_tpu/tasks/task_manager.py`` (a copy but for
its imports). Every search (``indices:data/read/search``) and every
reindex, update by query and delete by query registers a ``Task`` for as
long as it runs; ``_tasks`` lists them, ``_tasks/{id}`` reads one and
``_tasks/{id}/_cancel`` sets its flag. A search's ``SearchDeadline``
holds its task, so a cancel trips the next checkpoint of the request
(``search/cancellation.py``); a by-query run checks its task between
batches. Task ids are ``node_id:number``, as in the JAX package.

A task registered without ``headers`` carries the request's
``X-Opaque-Id`` (``search/telemetry.get_opaque_id``), as in the JAX
package.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Dict, Optional

from elasticsearch_tpu_torch.common.errors import (
    ResourceNotFoundException,
    TaskCancelledException,
)


class Task:
    def __init__(self, task_id: int, node_id: str, action: str,
                 description: str, cancellable: bool = True,
                 parent: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        self.task_id = task_id
        self.node_id = node_id
        self.action = action
        self.description = description
        self.cancellable = cancellable
        self.parent = parent
        self.headers = {k: v for k, v in (headers or {}).items()
                        if v is not None}
        self.start_time = time.time()
        self._cancelled = threading.Event()
        self.cancel_reason: Optional[str] = None
        # mutable progress (a by-query run's counts after each batch)
        self.status: Dict = {}

    @property
    def id_string(self) -> str:
        return f"{self.node_id}:{self.task_id}"

    def cancel(self, reason: str = "by user request") -> None:
        self.cancel_reason = reason
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def ensure_not_cancelled(self) -> None:
        if self.cancelled:
            raise TaskCancelledException(
                f"task cancelled [{self.cancel_reason}]")

    def to_dict(self) -> dict:
        return {
            "node": self.node_id,
            "id": self.task_id,
            "type": "transport",
            "action": self.action,
            "description": self.description,
            "start_time_in_millis": int(self.start_time * 1000),
            "running_time_in_nanos": int((time.time() - self.start_time)
                                         * 1e9),
            "cancellable": self.cancellable,
            "status": self.status or None,
            "headers": dict(self.headers),
            **({"parent_task_id": self.parent} if self.parent else {}),
        }


class TaskManager:
    def __init__(self, node_id: str):
        self.node_id = node_id
        self._tasks: Dict[int, Task] = {}
        self._counter = 0
        self._lock = threading.Lock()

    def register(self, action: str, description: str,
                 cancellable: bool = True, parent: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None) -> Task:
        if headers is None:
            # the request's X-Opaque-Id, off the REST layer's context
            from elasticsearch_tpu_torch.search.telemetry import (
                get_opaque_id,
            )

            oid = get_opaque_id()
            headers = {"X-Opaque-Id": oid} if oid else None
        with self._lock:
            self._counter += 1
            task = Task(self._counter, self.node_id, action, description,
                        cancellable, parent, headers=headers)
            self._tasks[self._counter] = task
            return task

    def unregister(self, task: Task) -> None:
        with self._lock:
            self._tasks.pop(task.task_id, None)

    def get(self, task_id: str) -> Task:
        num = int(task_id.split(":")[-1])
        task = self._tasks.get(num)
        if task is None:
            raise ResourceNotFoundException(
                f"task [{task_id}] isn't running and hasn't stored its "
                f"results")
        return task

    def cancel(self, task_id: str, reason: str = "by user request") -> Task:
        task = self.get(task_id)
        if not task.cancellable:
            raise ResourceNotFoundException(
                f"task [{task_id}] is not cancellable")
        task.cancel(reason)
        return task

    def list_tasks(self, actions: Optional[str] = None) -> dict:
        with self._lock:
            tasks = {
                t.id_string: t.to_dict()
                for t in self._tasks.values()
                if actions is None or any(
                    fnmatch.fnmatchcase(t.action, pat)
                    for pat in str(actions).split(","))
            }
        return {"nodes": {self.node_id: {"tasks": tasks}}}
