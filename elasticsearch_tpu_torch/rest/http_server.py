"""HTTP server: the Elasticsearch-compatible front door.

Counterpart of ``elasticsearch_tpu/rest/http_server.py``: a threading
HTTP/1.1 server (keep-alive; one thread per connection) in front of
``RestController``. Bodies are negotiated by ``common/xcontent.py`` (JSON,
YAML, CBOR; ``?pretty`` indents JSON); the cat API answers text/plain
unless ``?format=json``. ``X-Opaque-Id`` reaches the controller (the
request's context: tasks, slowlog, admission's tenant) and is echoed
back; deprecation warnings leave as ``Warning`` headers, and a 429 or a
drain's 503 carries ``Retry-After``.
``port=0`` binds an ephemeral port (``HttpServer.port`` says which).

    node = Node(device="cuda")
    server = HttpServer(node, port=9200)
    server.start()
    ...
    server.stop()
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from elasticsearch_tpu_torch.common.deprecation import (
    collect_warnings,
    warning_header_value,
)
from elasticsearch_tpu_torch.common.xcontent import response_format, serialize
from elasticsearch_tpu_torch.rest.controller import (
    RestController,
    collect_response_headers,
)


class _Handler(BaseHTTPRequestHandler):
    controller: RestController = None  # set by HttpServer
    protocol_version = "HTTP/1.1"
    # the headers and the body leave in two writes: with Nagle's algorithm
    # on, the body waits for the client's delayed ACK of the headers
    # (~40 ms on Linux) on every keep-alive response
    disable_nagle_algorithm = True

    def _handle(self, method: str) -> None:
        parsed = urlparse(self.path)
        query = dict(parse_qsl(parsed.query, keep_blank_values=True))
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        status, payload = self.controller.dispatch(
            method, parsed.path, query, body,
            content_type=self.headers.get("Content-Type"),
            headers=dict(self.headers.items()))
        warnings = collect_warnings()
        if isinstance(payload, str):
            data = payload.encode("utf-8")
            ctype = "text/plain; charset=UTF-8"
        else:
            fmt = response_format(query, self.headers.get("Accept"))
            data, ctype = serialize(payload, fmt, pretty="pretty" in query)
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        # the client's correlation id goes back unchanged
        opaque = self.headers.get("X-Opaque-Id")
        if opaque:
            self.send_header("X-Opaque-Id", opaque)
        for name, value in collect_response_headers().items():
            self.send_header(name, value)
        for w in warnings:
            self.send_header("Warning", warning_header_value(w))
        self.end_headers()
        if method != "HEAD":
            self.wfile.write(data)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_DELETE(self):
        self._handle("DELETE")

    def do_HEAD(self):
        self._handle("HEAD")

    def log_message(self, fmt, *args):  # quiet by default
        pass


class _Server(ThreadingHTTPServer):
    # a burst of clients connecting at once must not overflow the listen
    # backlog (socketserver's default is 5)
    request_queue_size = 128


class HttpServer:
    def __init__(self, node, host: str = "127.0.0.1", port: int = 9200):
        self.node = node
        self.controller = RestController(node)
        node.rest_controller = self.controller
        handler = type("BoundHandler", (_Handler,), {"controller": self.controller})
        self.server = _Server((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="estpu-torch-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
