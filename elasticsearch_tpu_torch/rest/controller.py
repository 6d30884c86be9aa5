"""REST controller: route registry + dispatch.

Counterpart of ``elasticsearch_tpu/rest/controller.py`` (the reference's
``RestController``). Routes use the reference's path-template syntax;
handlers take (node, request) and return (status, payload). The most
specific route (most literal segments) wins; a path that matches only
under another method answers 405, and no match at all answers 400 "no
handler found". Handler work runs on the node's named thread pool for the
route (``_executor_for``), where a full queue rejects with 429 and a
``Retry-After`` header. Errors map to status codes through the exception
taxonomy (``common/errors.py``), in the reference's
``{"error": {...}, "status": N}`` shape.
"""

from __future__ import annotations

import contextvars
import json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import unquote

from elasticsearch_tpu_torch.common.deprecation import begin_request
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuException,
    ParsingException,
)
from elasticsearch_tpu_torch.common.thread_pool import retry_after_header_value
from elasticsearch_tpu_torch.common.xcontent import XContentParseError, parse
from elasticsearch_tpu_torch.rest import handlers
from elasticsearch_tpu_torch.search.telemetry import set_opaque_id

Handler = Callable[..., Tuple[int, Any]]

# response-header side channel (the deprecation Warning-collector
# pattern): dispatch seeds a mutable dict per request; anything on the
# request path may set a header (Retry-After on 429 rejections); the HTTP
# front door drains it into the response
_resp_headers_var: "contextvars.ContextVar[Optional[dict]]" = \
    contextvars.ContextVar("estpu_torch_response_headers", default=None)


def begin_response_headers() -> None:
    _resp_headers_var.set({})


def set_response_header(name: str, value: str) -> None:
    headers = _resp_headers_var.get()
    if headers is not None:
        headers[name] = value


def collect_response_headers() -> Dict[str, str]:
    out = dict(_resp_headers_var.get() or {})
    _resp_headers_var.set({})
    return out


def header_value(headers: Optional[Dict[str, str]], name: str,
                 default=None):
    """A request header by name, case-insensitively."""
    lowered = name.lower()
    for k, v in (headers or {}).items():
        if k.lower() == lowered:
            return v
    return default


class RestRequest:
    def __init__(self, method: str, path: str, params: Dict[str, str],
                 body: Optional[bytes], content_type: Optional[str] = None):
        self.method = method
        self.path = path
        self.params = params  # query params + path params merged
        self.raw_body = body or b""
        self.content_type = content_type

    def json_body(self, default=None):
        """Parse the structured request body: despite the name, JSON,
        YAML and CBOR all parse here (Content-Type first, sniffing
        second)."""
        if not self.raw_body.strip():
            return default
        try:
            return parse(self.raw_body, self.content_type)
        except XContentParseError as e:
            raise ParsingException(f"request body is not valid: {e}") from e

    def ndjson_lines(self) -> List[dict]:
        out = []
        for line in self.raw_body.split(b"\n"):
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise ParsingException(
                        f"Malformed content, found invalid json line: {e}"
                    ) from e
        return out

    def param(self, name: str, default=None):
        return self.params.get(name, default)

    def bool_param(self, name: str, default=False) -> bool:
        v = self.params.get(name)
        if v is None:
            return default
        return v in ("", "true", True)


class Route:
    _PARAM_RE = re.compile(r"\{(\w+)\}")

    def __init__(self, method: str, pattern: str, handler: Handler):
        self.method = method
        self.pattern = pattern
        self.handler = handler
        regex = "^"
        for part in pattern.strip("/").split("/"):
            m = self._PARAM_RE.fullmatch(part)
            if m:
                if m.group(1) == "index":
                    # index names cannot start with '_', which keeps API
                    # endpoints from being swallowed by /{index} routes;
                    # `_all` is the one legal underscore expression in
                    # index position (/_all/_refresh etc.)
                    regex += f"/(?P<{m.group(1)}>_all|[^_/][^/]*)"
                else:
                    regex += f"/(?P<{m.group(1)}>[^/]+)"
            else:
                regex += "/" + re.escape(part)
        regex += "$"
        self.regex = re.compile(regex)
        # literal segments score higher for route priority
        self.specificity = sum(
            1 for p in pattern.strip("/").split("/") if not self._PARAM_RE.fullmatch(p)
        )

    def match(self, path: str) -> Optional[Dict[str, str]]:
        m = self.regex.match("/" + path.strip("/"))
        if m is None:
            return None
        return m.groupdict()


_SEARCH_MARKERS = ("_search", "_count", "_msearch", "_explain",
                   "_validate", "_field_caps", "_suggest", "_percolate")
_GET_MARKERS = ("_doc", "_mget", "_source", "_termvectors")


def _executor_for(method: str, pattern: str) -> str:
    """Route -> named pool, mirroring the per-action executor choices of
    the reference's transport actions (ThreadPool.Names)."""
    if any(m in pattern for m in _SEARCH_MARKERS):
        return "search"
    if "_bulk" in pattern or "_update" in pattern:
        return "write"
    if any(m in pattern for m in _GET_MARKERS):
        return "get" if method in ("GET", "HEAD") else "write"
    if "{type}/{id}" in pattern or pattern.endswith("/{id}"):
        return "get" if method in ("GET", "HEAD") else "write"
    return "management"


class RestController:
    def __init__(self, node):
        self.node = node
        self.routes: List[Route] = []
        handlers.register_all(self)

    def register(self, method: str, pattern: str, handler: Handler) -> None:
        self.routes.append(Route(method, pattern, handler))
        self.routes.sort(key=lambda r: -r.specificity)

    def dispatch(self, method: str, path: str, query: Dict[str, str],
                 body: Optional[bytes],
                 content_type: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, Any]:
        begin_request()  # per-request Warning-header collector
        begin_response_headers()  # Retry-After on a 429 or a 503
        # X-Opaque-Id rides the request's context (copied into the
        # executor thread below): tasks, slowlog lines, admission's
        # tenant and the profile read it back
        set_opaque_id(header_value(headers, "x-opaque-id"))
        path = unquote(path.split("?")[0])
        for route in self.routes:
            if route.method != method:
                continue
            path_params = route.match(path)
            if path_params is None:
                continue
            params = dict(query)
            params.update(path_params)
            req = RestRequest(method, path, params, body, content_type)
            inflight = None
            reserved = False
            if body and hasattr(self.node, "breaker_service"):
                # in-flight requests breaker: the buffered request body
                # counts against memory until the response is built
                inflight = self.node.breaker_service.get_breaker(
                    "in_flight_requests")
            try:
                if inflight is not None:
                    inflight.add_estimate_bytes_and_maybe_break(
                        len(body), "<http_request>")
                    # only a successful reservation may be released
                    reserved = True
                # run handler work on the action's named executor; the
                # copied contextvars context carries the request's
                # warning and response-header collectors across the hop
                ctx = contextvars.copy_context()
                return self.node.thread_pool.run(
                    _executor_for(method, route.pattern),
                    lambda: ctx.run(route.handler, self.node, req))
            except ElasticsearchTpuException as e:
                # a rejection carrying a drain-rate-derived retry_after_s
                # renders it as the Retry-After header (never in the
                # reference-shaped error body)
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    set_response_header(
                        "Retry-After", retry_after_header_value(retry_after))
                return e.status_code, e.to_dict()
            except Exception as e:  # noqa: BLE001 — uncaught -> 500
                return 500, {
                    "error": {"type": type(e).__name__, "reason": str(e)},
                    "status": 500,
                }
            finally:
                if reserved:
                    inflight.add_without_breaking(-len(body))
        # path matched under another method -> 405
        allowed = sorted({r.method for r in self.routes
                          if r.match(path) is not None})
        if allowed:
            return 405, {
                "error": f"Incorrect HTTP method for uri [{path}] and method "
                         f"[{method}], allowed: {allowed}",
                "status": 405,
            }
        return 400, {
            "error": {
                "type": "illegal_argument_exception",
                "reason": f"no handler found for uri [{path}] and method [{method}]",
            },
            "status": 400,
        }
