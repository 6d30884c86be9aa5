"""Two nodes side by side for the cluster-metadata parity tests.

``NodePair`` holds a JAX ``Node`` (Pallas kernels in interpret mode,
``ES_TPU_PALLAS=interpret``) and a port ``Node(device="cpu")``, each
behind its own ``RestController``, and sends one request to both:
``same`` asserts the statuses equal and the bodies equal after
``normalize`` (drops ``took``, ``_plane``, uuids and creation dates,
puts ``<node>`` in place of each node's random id), with floats within
rtol 1e-5 and hits compared per tie group as in ``test_torch_rest``.
``close`` closes both nodes, so no refresh thread, staging or pool of
either package outlives a test.
"""

import json
import os

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.rest.controller import RestController as JController
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController
from test_torch_rest import assert_same_body

VOLATILE = {"took", "_plane", "uuid", "index.uuid", "cluster_uuid",
            "creation_date", "index.creation_date"}


def normalize(obj, node_id):
    """``obj`` without the volatile keys, with ``node_id`` (in keys and
    string values) replaced by ``<node>``."""
    if isinstance(obj, dict):
        return {("<node>" if k == node_id else k): normalize(v, node_id)
                for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [normalize(v, node_id) for v in obj]
    if isinstance(obj, str) and node_id in obj:
        return obj.replace(node_id, "<node>")
    return obj


class NodePair:
    def __init__(self, settings=None, data_paths=(None, None)):
        self._pallas_env = os.environ.get("ES_TPU_PALLAS")
        os.environ["ES_TPU_PALLAS"] = "interpret"
        settings = dict(settings or {})
        self.j = JNode(JSettings(settings), data_path=data_paths[0])
        self.t = Node(Settings(settings), data_path=data_paths[1],
                      device="cpu")
        self.jc = JController(self.j)
        self.tc = RestController(self.t)
        self.j.rest_controller = self.jc
        self.t.rest_controller = self.tc

    def call(self, method, path, body=None, params=None):
        """((jax status, body), (port status, body)), each normalized."""
        if body is None:
            raw = b""
        elif isinstance(body, bytes):
            raw = body
        else:
            raw = json.dumps(body).encode()
        query = {k: str(v) for k, v in (params or {}).items()}
        ctype = ("application/x-ndjson" if path.endswith("_bulk")
                 else "application/json")
        js, jb = self.jc.dispatch(method, path, dict(query), raw, ctype)
        ts, tb = self.tc.dispatch(method, path, dict(query), raw, ctype)
        return ((js, normalize(jb, self.j.node_id)),
                (ts, normalize(tb, self.t.node_id)))

    def same(self, method, path, body=None, params=None, status=None):
        """Send to both; the statuses and bodies must agree. Returns the
        port's body."""
        (js, jb), (ts, tb) = self.call(method, path, body, params)
        assert js == ts, (method, path, js, jb, ts, tb)
        if status is not None:
            assert ts == status, (method, path, ts, tb)
        assert_same_body(jb, tb, f"{method} {path}")
        return tb

    def both(self, fn):
        """Run ``fn(node)`` on each node; (jax result, port result)."""
        return fn(self.j), fn(self.t)

    def close(self):
        try:
            self.j.close()
        finally:
            self.t.close()
            if self._pallas_env is None:
                os.environ.pop("ES_TPU_PALLAS", None)
            else:
                os.environ["ES_TPU_PALLAS"] = self._pallas_env
