"""Deprecation logging with response-header propagation.

Counterpart of ``elasticsearch_tpu/common/deprecation.py``: a deprecated
usage is logged once per process per unique message, and attached to the
current HTTP response as an RFC 7234 ``Warning`` header (code 299)
through a request-scoped collector.
"""

from __future__ import annotations

import contextvars
import logging
import threading
from typing import List, Optional

_logger = logging.getLogger("elasticsearch_tpu_torch.deprecation")
_seen: set = set()
_seen_lock = threading.Lock()
# a ContextVar (not threading.local): the REST dispatcher copies its
# context into the thread-pool worker that runs the handler, and the
# copied context carries the SAME collector list across that hop
_warnings_var: "contextvars.ContextVar[Optional[list]]" = \
    contextvars.ContextVar("estpu_torch_request_warnings", default=None)


def begin_request() -> None:
    """Reset the current request's warning collector (called by the REST
    dispatcher at the start of each request)."""
    _warnings_var.set([])


def collect_warnings() -> List[str]:
    """Drain the warnings recorded during the current request."""
    out = list(_warnings_var.get() or [])
    _warnings_var.set([])
    return out


def warning_header_value(message: str) -> str:
    """RFC 7234 warn-code 299 header value; the warn-agent names this
    server."""
    return f'299 elasticsearch_tpu_torch "{message}"'


class DeprecationLogger:
    def __init__(self, name: str = "deprecation"):
        self._name = name

    def deprecated(self, message: str) -> None:
        with _seen_lock:
            if message not in _seen:
                _seen.add(message)
                _logger.warning("[%s] %s", self._name, message)
        warnings = _warnings_var.get()
        if warnings is not None and message not in warnings:
            warnings.append(message)
