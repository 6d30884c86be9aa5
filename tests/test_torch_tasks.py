"""The task registry and ``_tasks/{id}/_cancel`` on the port, against the
JAX package.

Mirrors tests/test_search_fault_tolerance.py's ``TestCancellation`` on
both of the port's planes: the host rung (``index.search.mesh: false``,
held by ``SearchDelayScheme`` in a shard's query phase) and the one-device
mesh plane (3 shards, held by ``MeshPlaneDelayScheme`` before the plane
attempt's checkpoint). The JAX package serves the same index on its host
rung, held by its own ``SearchDelayScheme``. A running search is listed
under ``indices:data/read/search`` with the JAX task's keys, a cancel
(in process or over REST) makes it raise ``task_cancelled_exception``
(400) with the JAX reason, the finished task is unregistered, an
uncancelled search answers as the JAX one does, and a cancelled one
launches nothing and leaves the device-memory ledger where it was.
"""

import threading
import time

import pytest

from elasticsearch_tpu.common.errors import (
    TaskCancelledException as JTaskCancelled,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.rest.controller import RestController as JRest
from elasticsearch_tpu.testing import disruption as jdis
from elasticsearch_tpu_torch.common.errors import TaskCancelledException
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.testing import disruption as tdis

MAPPING = {"properties": {"body": {"type": "text", "analyzer": "whitespace"}}}
PLANES = ("host", "mesh")


@pytest.fixture(autouse=True)
def _interpret_and_clean(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    yield
    jdis.clear_search_disruptions()
    tdis.clear_search_disruptions()


def _seed(node, mesh: bool):
    node.create_index("cx", {
        "settings": {"index": {"number_of_shards": 3,
                               "search": {"mesh": mesh},
                               "refresh_interval": -1}},
        "mappings": MAPPING,
    })
    for d in range(30):
        node.index_doc("cx", str(d), {"body": f"w{d % 5} w1"})
    node.indices["cx"].refresh()


@pytest.fixture()
def jnode():
    n = JNode(JSettings({"node.name": "cx-node"}))
    _seed(n, mesh=False)
    yield n
    n.close()


@pytest.fixture(params=PLANES)
def tnode(request):
    n = Node(Settings({"node.name": "cx-node"}), device="cpu")
    _seed(n, mesh=request.param == "mesh")
    n.plane = request.param
    # warm the plane, so the held search stages nothing new
    r = n.search("cx", {"query": {"match": {"body": "w1"}}})
    assert r.get("_plane", "host") == ("host" if n.plane == "host"
                                       else "mesh_pallas")
    yield n
    n.close()


def _hold(node, seconds=0.5):
    if getattr(node, "plane", "host") == "mesh":
        tdis.MeshPlaneDelayScheme(seconds, indices=["cx"]).install()
    elif isinstance(node, Node):
        tdis.SearchDelayScheme(seconds, indices=["cx"]).install()
    else:
        jdis.SearchDelayScheme(seconds, indices=["cx"]).install()


def _start_search(node, errs, done):
    def run():
        try:
            done.append(node.search("cx", {"query": {"match": {"body": "w1"}}}))
        except Exception as e:  # noqa: BLE001 — collected for asserts
            errs.append(e)
    t = threading.Thread(target=run)
    t.start()
    return t


def _wait_for_task(node, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        entries = node.tasks.list_tasks(
            actions="*search*")["nodes"][node.node_id]["tasks"]
        if entries:
            return next(iter(entries))
        time.sleep(0.005)
    raise AssertionError("search task never appeared in _tasks")


def _cancel_running(node, cancel):
    """Hold a search, cancel its task with ``cancel(node, task_id)``;
    (error, the listed entry, cancel's result)."""
    _hold(node)
    errs, done = [], []
    t = _start_search(node, errs, done)
    task_id = _wait_for_task(node)
    entry = node.tasks.list_tasks(
        actions="*search*")["nodes"][node.node_id]["tasks"][task_id]
    out = cancel(node, task_id)
    t.join(timeout=10)
    assert not t.is_alive()
    assert done == [], "cancelled search returned a response"
    assert len(errs) == 1
    return errs[0], entry, out


def test_running_search_listed_and_cancellable(tnode, jnode):
    def cancel(node, task_id):
        return node.tasks.cancel(task_id, "test cancel")

    err, entry, _ = _cancel_running(tnode, cancel)
    jerr, jentry, _ = _cancel_running(jnode, cancel)
    assert isinstance(jerr, JTaskCancelled)
    assert isinstance(err, TaskCancelledException)
    assert err.reason == jerr.reason
    assert "test cancel" in err.reason
    assert set(entry) == set(jentry)
    for key in ("action", "type", "cancellable", "status", "headers"):
        assert entry[key] == jentry[key], key
    assert entry["action"] == "indices:data/read/search"
    assert entry["description"] == "search [cx]"
    # the finished task is unregistered
    assert not tnode.tasks.list_tasks(
        actions="*search*")["nodes"][tnode.node_id]["tasks"]


def test_cancel_via_rest(tnode, jnode):
    def cancel(rc):
        def go(node, task_id):
            status, payload = rc.dispatch(
                "POST", f"/_tasks/{task_id}/_cancel", {}, b"")
            assert status == 200
            assert task_id in payload["nodes"][node.node_id]["tasks"]
            return payload
        return go

    err, _, _ = _cancel_running(tnode, cancel(RestController(tnode)))
    jerr, _, _ = _cancel_running(jnode, cancel(JRest(jnode)))
    assert err.to_dict() == jerr.to_dict()
    assert err.to_dict()["error"]["type"] == "task_cancelled_exception"
    assert err.status_code == jerr.status_code == 400
    # the search itself over REST answers the same 400 body
    rc = RestController(tnode)
    _hold(tnode)
    out = []
    t = threading.Thread(target=lambda: out.append(rc.dispatch(
        "POST", "/cx/_search", {},
        b'{"query": {"match": {"body": "w1"}}}')))
    t.start()
    task_id = _wait_for_task(tnode)
    tnode.tasks.cancel(task_id)
    t.join(timeout=10)
    status, body = out[0]
    assert status == 400
    assert body["error"]["type"] == "task_cancelled_exception"
    assert body["error"]["reason"] == "task cancelled [by user request]"


def test_uncancelled_search_unaffected(tnode, jnode):
    body = {"query": {"match": {"body": "w1"}}, "size": 30}
    r, jr = tnode.search("cx", body), jnode.search("cx", body)
    assert r["hits"]["total"] == jr["hits"]["total"] == 30
    assert r["timed_out"] is jr["timed_out"] is False
    assert sorted(h["_id"] for h in r["hits"]["hits"]) == \
        sorted(h["_id"] for h in jr["hits"]["hits"])
    assert not tnode.tasks.list_tasks()["nodes"][tnode.node_id]["tasks"]


def test_cancelled_search_launches_nothing_and_keeps_the_ledger(tnode):
    svc = tnode.indices["cx"]
    acct = memory_accountant()
    before = acct.staged_bytes("cx")
    host_before = svc.host_query_total
    mesh = svc._mesh_search
    mesh_before = mesh.query_total if mesh is not None else 0
    err, _, _ = _cancel_running(
        tnode, lambda n, tid: n.tasks.cancel(tid))
    assert isinstance(err, TaskCancelledException)
    # the held checkpoint comes before any launch of the plane
    if tnode.plane == "mesh":
        assert svc._mesh_search.query_total == mesh_before
        assert svc.host_query_total == host_before
    assert acct.staged_bytes("cx") == before
    # the next search answers as before
    assert tnode.search("cx", {"query": {"match": {"body": "w1"}}})[
        "hits"]["total"] == 30


def test_index_service_search_takes_a_task(tnode):
    """A direct ``IndexService.search`` caller's task gets a deadline of
    its own: a cancelled task stops the search at its first checkpoint on
    either plane."""
    task = tnode.tasks.register("indices:data/read/search", "direct")
    task.cancel("direct cancel")
    try:
        with pytest.raises(TaskCancelledException, match="direct cancel"):
            tnode.indices["cx"].search(
                {"query": {"match": {"body": "w1"}}}, task=task)
    finally:
        tnode.tasks.unregister(task)
    assert tnode.indices["cx"].search(
        {"query": {"match": {"body": "w1"}}})["hits"]["total"] == 30
