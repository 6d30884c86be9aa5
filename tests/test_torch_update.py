"""The update API, bulk ``update`` and ``mget`` on the port, against the
JAX package.

Each case sends the same writes and reads to a JAX ``Node`` and a port
``Node(device="cpu")`` and holds the answers equal (every key but
``took``), errors by class, message and status:

- ``update_doc``: a partial ``doc`` merge (nested objects merge deep,
  ``detect_noop``), ``doc_as_upsert``, ``upsert``, ``scripted_upsert``, a
  painless script over ``ctx._source`` with ``ctx.op`` ``none``, ``noop``
  and ``delete`` and an invalid op, an expression-only script, the
  internal ``version`` check (409), a missing doc (404) and index, a
  script that mutates a nested object and then sets ``ctx.op = 'none'``
  (the stored source is untouched), ``refresh``, an upsert that creates
  its index, and a join child updated with its routing;
- ``bulk`` with ``update`` lines (and the legacy ``parent``);
- ``mget``: the ``docs`` and ``ids`` forms, routing and the legacy
  ``_parent``, ``stored_fields``, per-doc ``_source``, typed requests, a
  missing index as an item error, whole-request validation;
- the same forms over HTTP against the JAX server (statuses and bodies);
- an update survives a restart: the port's node reopened over its data
  path replays the updates from the translog, as the JAX node does.
"""

import json

import pytest

from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.rest.http_server import HttpServer as JHttpServer
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.http_server import HttpServer
from test_torch_rest import assert_same_body, call, ndjson, strip
from test_torch_search_fault_tolerance import same

MAPPING = {"_doc": {"properties": {
    "title": {"type": "text"},
    "tag": {"type": "keyword", "store": True},
    "n": {"type": "long"},
    "obj": {"properties": {"inner": {"type": "long"},
                           "label": {"type": "keyword"}}},
}}}


def _docs(n=24):
    return [(str(d), {"title": f"doc {d} w{d % 3}", "tag": f"t{d % 4}",
                      "n": d, "obj": {"inner": d % 5, "label": f"l{d}"}})
            for d in range(n)]


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        d = e.to_dict() if hasattr(e, "to_dict") else {}
        return ("raise", type(e).__name__, str(e), d.get("status"))


class Nodes:
    def __init__(self, tmp=None, shards=2, mapping=MAPPING, name="u"):
        self.j = JNode(data_path=str(tmp / "j") if tmp else None)
        self.t = Node(data_path=str(tmp / "t") if tmp else None,
                      device="cpu")
        self.name = name
        body = {"settings": {"number_of_shards": shards,
                             "refresh_interval": "-1"},
                "mappings": mapping}
        self.j.create_index(name, json.loads(json.dumps(body)))
        self.t.create_index(name, json.loads(json.dumps(body)))

    def both(self, fn):
        """``fn(node)`` on both nodes: equal outcomes."""
        want, got = outcome(lambda: fn(self.j)), outcome(lambda: fn(self.t))
        assert got[0] == want[0], (got, want)
        if want[0] == "ok":
            same(want[1], got[1])
        else:
            assert got[1:] == want[1:]
        return got

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture()
def nodes(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    n = Nodes()
    ops = [("index", {"_index": "u", "_id": i}, s) for i, s in _docs()]
    n.both(lambda x: x.bulk(ops, refresh=True)["errors"])
    yield n
    n.close()


def get(n, doc_id, **kw):
    return lambda x: x.get_doc(n.name, doc_id, **kw)


UPDATES = [
    ("merge", "3", {"doc": {"n": 300, "extra": "x"}}),
    ("merge_nested", "4", {"doc": {"obj": {"label": "changed"}}}),
    ("merge_noop", "5", {"doc": {"n": 5}}),
    ("merge_no_detect_noop", "5", {"doc": {"n": 5}, "detect_noop": False}),
    ("doc_as_upsert_missing", "new1", {"doc": {"n": 1}, "doc_as_upsert": True}),
    ("doc_as_upsert_existing", "6", {"doc": {"n": 66}, "doc_as_upsert": True}),
    ("upsert_missing", "new2", {"doc": {"n": 1}, "upsert": {"n": 0}}),
    ("upsert_existing", "7", {"doc": {"n": 77}, "upsert": {"n": 0}}),
    ("scripted_upsert", "new3", {"scripted_upsert": True, "upsert": {"n": 0},
                                 "script": {"source": "ctx._source.n += 5"}}),
    ("script_upsert_unscripted", "new4", {"upsert": {"n": 9},
                                          "script": "ctx._source.n += 5"}),
    ("script", "8", {"script": {
        "source": "ctx._source.n += params.by; "
                  "ctx._source.tags = ['updated']",
        "params": {"by": 10}}}),
    ("script_none", "9", {"script": {"source": "ctx.op = 'none'"}}),
    ("script_noop", "9", {"script": "ctx.op = 'noop'"}),
    ("script_delete", "10", {"script": {
        "source": "if (ctx._source.n == 10) { ctx.op = 'delete' }"}}),
    ("script_bad_op", "11", {"script": "ctx.op = 'explode'"}),
    ("script_expression_only", "11", {"script": "doc['n'].value * 2"}),
    ("script_runtime_error", "11", {"script": "ctx._source.missing.x = 1"}),
    ("script_meta", "12", {"script": "ctx._source.seen = ctx._id + "
                                     "'@' + ctx._version"}),
    ("missing_doc", "nope", {"doc": {"n": 1}}),
    ("missing_doc_script", "nope", {"script": "ctx._source.n = 1"}),
    ("empty_body", "13", {}),
]


@pytest.mark.parametrize("name,doc_id,body", UPDATES,
                         ids=[u[0] for u in UPDATES])
def test_update_like_jax(nodes, name, doc_id, body):
    nodes.both(lambda x: x.update_doc("u", doc_id, json.loads(
        json.dumps(body))))
    nodes.both(get(nodes, doc_id))
    nodes.both(lambda x: x.indices["u"].refresh())
    nodes.both(lambda x: x.search("u", {"query": {"ids": {
        "values": [doc_id]}}}))


def test_version_check_like_jax(nodes):
    r = nodes.both(lambda x: x.update_doc("u", "2", {"doc": {"n": 1}},
                                          version=1))
    assert r[1]["_version"] == 2
    r = nodes.both(lambda x: x.update_doc("u", "2", {"doc": {"n": 2}},
                                          version=1))
    assert r[1] == "VersionConflictEngineException" and r[3] == 409
    # the check reads the current version: an upsert of a missing doc
    # passes whatever it says
    nodes.both(lambda x: x.update_doc("u", "fresh", {
        "doc": {"n": 1}, "doc_as_upsert": True}, version=7))


def test_noop_script_cannot_corrupt_live_source(nodes):
    """A script that mutates a nested object and then sets ctx.op =
    'none' leaves the stored doc untouched (a deep copy), in the buffer
    and in a sealed segment."""
    nodes.both(lambda x: x.index_doc("u", "nested1", {"obj": {"inner": 1},
                                                      "n": 0}))
    for _ in range(2):
        before = nodes.both(get(nodes, "nested1"))[1]
        nodes.both(lambda x: x.update_doc("u", "nested1", {"script": {
            "source": "ctx._source.obj.inner = 999; ctx.op = 'none'"}}))
        after = nodes.both(get(nodes, "nested1"))[1]
        assert after == before and after["_source"]["obj"]["inner"] == 1
        nodes.both(lambda x: x.indices["u"].refresh())


def test_refresh_and_index_auto_create_like_jax(nodes):
    nodes.both(lambda x: x.update_doc("u", "1", {"doc": {"title": "zzz"}},
                                      refresh=True))
    r = nodes.both(lambda x: x.search("u", {"query": {"match": {
        "title": "zzz"}}}))
    assert r[1]["hits"]["total"] == 1
    r = nodes.both(lambda x: x.update_doc("made", "1", {"doc": {"n": 1}}))
    assert r[1] == "IndexNotFoundException" and r[3] == 404
    nodes.both(lambda x: x.update_doc("made", "1", {
        "doc": {"n": 1}, "doc_as_upsert": True}, refresh=True))
    nodes.both(lambda x: x.indices["made"].mapping_dict())
    nodes.both(lambda x: x.search("made", {}))


def test_bulk_update_like_jax(nodes):
    ops = [
        ("update", {"_index": "u", "_id": "1"}, {"doc": {"n": 101}}),
        ("update", {"_index": "u", "_id": "2"},
         {"script": {"source": "ctx._source.n *= params.k",
                     "params": {"k": 3}}}),
        ("update", {"_index": "u", "_id": "missing"}, {"doc": {"n": 1}}),
        ("update", {"_index": "u", "_id": "up1"},
         {"doc": {"n": 5}, "doc_as_upsert": True}),
        ("update", {"_index": "u", "_id": "up2"},
         {"upsert": {"n": 0}, "script": "ctx._source.n += 1",
          "scripted_upsert": True}),
        ("update", {"_index": "u", "_id": "3"}, {"script": "ctx.op = 'delete'"}),
        ("update", {"_index": "u", "_id": "4"}, {"script": "ctx.op = 'boom'"}),
        ("update", {"_index": "u", "_id": "5"}, {"doc": {"n": 5}}),
        ("update", {"_index": "u", "_id": "6", "parent": "p6"},
         {"doc": {"n": 60}}),
        ("index", {"_index": "u", "_id": "7"}, {"n": 70}),
        ("update", {"_index": "u", "_id": "7"}, {"doc": {"m": 1}}),
        ("frob", {"_index": "u", "_id": "8"}, None),
    ]
    r = nodes.both(lambda x: x.bulk(json.loads(json.dumps(ops)),
                                    refresh=True))
    assert r[1]["errors"]
    statuses = [next(iter(it.values()))["status"] for it in r[1]["items"]]
    assert statuses[:9] == [200, 200, 404, 200, 200, 200, 400, 200, 200]
    for doc_id in ("1", "2", "3", "6", "7", "up1", "up2"):
        nodes.both(get(nodes, doc_id))
    nodes.both(lambda x: x.mget({"docs": [{"_id": "6", "stored_fields": [
        "_parent", "_source"]}]}, "u"))
    nodes.both(lambda x: x.search("u", {"size": 30, "sort": [{"n": "asc"}],
                                        "query": {"match_all": {}}}))


MGETS = [
    ("docs", {"docs": [{"_index": "u", "_id": "1"}, {"_index": "u", "_id": "2"},
                       {"_index": "u", "_id": "nope"}]}, None),
    ("ids", {"ids": ["3", "4", "nope"]}, "u"),
    ("missing_index", {"docs": [{"_index": "zz", "_id": "1"},
                                {"_index": "u", "_id": "1"}]}, None),
    ("routing", {"docs": [{"_index": "u", "_id": "5", "routing": "r5"},
                          {"_index": "u", "_id": "5", "_routing": "x"}]}, None),
    ("stored_fields", {"docs": [{"_id": "1", "stored_fields": ["tag"]},
                                {"_id": "2", "stored_fields": "tag,_source"},
                                {"_id": "3", "fields": ["n"]}]}, "u"),
    ("source_filter", {"docs": [
        {"_id": "1", "_source": False}, {"_id": "2", "_source": ["n"]},
        {"_id": "3", "_source": {"includes": ["obj.*"], "excludes": [
            "obj.label"]}}]}, "u"),
    ("typed", {"docs": [{"_id": "1", "_type": "_doc"},
                        {"_id": "2", "_type": "other"},
                        {"_id": "3", "_type": "_all"}]}, "u"),
    ("empty", {}, "u"),
    ("no_id", {"docs": [{"_index": "u"}, {"_id": "1"}]}, None),
]


@pytest.mark.parametrize("name,body,index", MGETS,
                         ids=[m[0] for m in MGETS])
def test_mget_like_jax(nodes, name, body, index):
    nodes.both(lambda x: x.mget(json.loads(json.dumps(body)), index))


def test_mget_equals_the_gets_merged(nodes):
    ids = [str(i) for i in range(0, 24, 3)] + ["nope"]
    r = nodes.both(lambda x: x.mget({"ids": ids}, "u"))[1]
    for doc, doc_id in zip(r["docs"], ids):
        assert doc == nodes.t.get_doc("u", doc_id)


def test_mget_options_like_jax(nodes):
    nodes.both(lambda x: x.index_doc("u", "rt", {"n": 1}))
    for kw in ({"realtime": False}, {"realtime": True},
               {"refresh": "true"}, {"stored_fields": ["tag"]}):
        nodes.both(lambda x: x.mget({"ids": ["rt", "1"]}, "u", **kw))


def test_legacy_parent_mget_like_jax(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    n = Nodes(mapping={"question": {}, "answer": {
        "_parent": {"type": "question"}}}, name="lp")
    try:
        n.both(lambda x: x.index_doc("lp", "q1", {"t": "q"}))
        n.both(lambda x: x.index_doc("lp", "a1", {"t": "a"}, routing="q1",
                                     parent="q1"))
        n.both(lambda x: x.update_doc("lp", "a1", {"doc": {"t": "a2"}},
                                      routing="q1"))
        n.both(lambda x: x.mget({"docs": [
            {"_id": "a1", "parent": "q1", "stored_fields": ["_parent"]},
            {"_id": "a1", "_parent": "q1"}, {"_id": "q1"}]}, "lp"))
    finally:
        n.close()


def test_join_child_updated_with_routing(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    mapping = {"_doc": {"properties": {
        "qa": {"type": "join", "relations": {"question": "answer"}},
        "text": {"type": "text"}, "votes": {"type": "long"}}}}
    n = Nodes(mapping=mapping, shards=3, name="jq")
    try:
        n.both(lambda x: x.index_doc("jq", "q1", {"qa": "question",
                                                  "text": "why"}))
        n.both(lambda x: x.index_doc("jq", "a1", {
            "qa": {"name": "answer", "parent": "q1"}, "text": "because",
            "votes": 1}, routing="q1"))
        # with its routing: found, merged, the join value kept
        n.both(lambda x: x.update_doc("jq", "a1", {"doc": {"votes": 2}},
                                      routing="q1", refresh=True))
        n.both(lambda x: x.update_doc("jq", "a1", {
            "script": "ctx._source.votes += 10"}, routing="q1",
            refresh=True))
        # an upsert of a child without routing is the join check's 400
        n.both(lambda x: x.update_doc("jq", "a2", {
            "doc": {"qa": {"name": "answer", "parent": "q1"}},
            "doc_as_upsert": True}))
        n.both(get(n, "a1", routing="q1"))
        n.both(lambda x: x.search("jq", {"query": {"has_child": {
            "type": "answer", "query": {"range": {"votes": {"gte": 12}}}}}}))
    finally:
        n.close()


def test_update_survives_a_restart(tmp_path, monkeypatch):
    """Updates acknowledged by a node that is then dropped without a
    close (no flush since the bulk) replay from the translog: the port's
    node reopened over its data path reads the updated sources and
    versions that both packages answered before the crash. (The JAX
    node reopened over its own path has no index at all: it writes an
    index's ``_meta.json`` only on a mapping update or a close, and this
    index's mapping was complete at creation; C16.)"""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    n = Nodes(tmp=tmp_path)
    ops = [("index", {"_index": "u", "_id": i}, s) for i, s in _docs(12)]
    n.both(lambda x: x.bulk(ops))
    n.both(lambda x: x.indices["u"].flush())
    n.both(lambda x: x.update_doc("u", "1", {"doc": {"n": 1000}}))
    n.both(lambda x: x.update_doc("u", "2", {"script": {
        "source": "ctx._source.n += params.d", "params": {"d": 7}}}))
    n.both(lambda x: x.update_doc("u", "3", {"script": "ctx.op = 'delete'"}))
    n.both(lambda x: x.update_doc("u", "new", {"doc": {"n": 1},
                                              "doc_as_upsert": True}))
    n.both(lambda x: x.bulk([("update", {"_index": "u", "_id": "4"},
                              {"doc": {"obj": {"inner": 44}}})]))
    ids = ("1", "2", "3", "4", "new")
    want = {d: n.both(get(n, d))[1] for d in ids}
    # reopen beside the nodes, which are dropped without a close: the
    # translog holds the updates
    j2 = JNode(data_path=str(tmp_path / "j"))
    t2 = Node(data_path=str(tmp_path / "t"), device="cpu")
    try:
        assert "u" not in j2.indices  # C16
        assert sum(t2.indices["u"].recovered_ops.values()) == 5
        for d in ids:
            same(want[d], t2.get_doc("u", d))
        assert want["1"]["_version"] == 2
        assert want["2"]["_source"]["n"] == 9
        assert not want["3"]["found"]
        assert want["4"]["_source"]["obj"] == {"inner": 44, "label": "l4"}
        assert want["new"]["_version"] == 1
    finally:
        j2.close()
        t2.close()
        n.close()


# --- over HTTP -------------------------------------------------------------


@pytest.fixture()
def servers(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(), Node(device="cpu")
    js, ts = JHttpServer(jn, port=0), HttpServer(tn, port=0)
    js.start()
    ts.start()
    try:
        yield jn, tn, js.port, ts.port
    finally:
        js.stop()
        ts.stop()
        jn.close()
        tn.close()


def both_http(servers, method, path, body=None, ctype="application/json"):
    _jn, _tn, jport, tport = servers
    js, _jh, jb = call(jport, method, path, body, ctype)
    ts, _th, tb = call(tport, method, path, body, ctype)
    assert js == ts, (method, path, js, ts, jb, tb)
    assert_same_body(strip(jb), strip(tb), f"{method} {path}")
    return ts, tb


def test_update_and_mget_over_rest_like_jax(servers):
    both_http(servers, "PUT", "/r", {
        "settings": {"number_of_shards": 2, "refresh_interval": "-1"},
        "mappings": MAPPING})
    lines = []
    for doc_id, src in _docs(10):
        lines += [{"index": {"_index": "r", "_id": doc_id}}, src]
    both_http(servers, "POST", "/_bulk?refresh=true", ndjson(lines),
              "application/x-ndjson")
    for method, path, body, status in (
            ("POST", "/r/_update/1", {"doc": {"n": 100}}, 200),
            ("POST", "/r/_update/1", {"doc": {"n": 100}}, 200),
            ("POST", "/r/_doc/2/_update", {"script": "ctx._source.n += 1"},
             200),
            ("POST", "/r/_update/3?refresh=true", {"doc": {"tag": "x"}}, 200),
            ("POST", "/r/_update/4?_source=true", {"doc": {"n": 4}}, 200),
            ("POST", "/r/_update/4?_source=n,tag", {"doc": {"n": 44}}, 200),
            ("POST", "/r/_update/5?fields=n,tag", {"doc": {"n": 55}}, 200),
            ("POST", "/r/_update/6?version=1", {"doc": {"n": 66}}, 200),
            ("POST", "/r/_update/6?version=1", {"doc": {"n": 67}}, 409),
            ("POST", "/r/_update/6?version=2&version_type=external",
             {"doc": {"n": 68}}, 400),
            ("POST", "/r/_update/7?routing=x", {"doc": {"n": 1},
                                                "doc_as_upsert": True}, 200),
            ("POST", "/r/_update/nope", {"doc": {"n": 1}}, 404),
            ("POST", "/r/_update/8", {"script": "ctx.op = 'delete'"}, 200),
            ("POST", "/r/_update/9", {"script": "ctx.op = 'frob'"}, 400),
            ("POST", "/nowhere/_update/1", {"doc": {"n": 1}}, 404),
            ("POST", "/auto/_update/1", {"upsert": {"n": 1}}, 201),
            ("POST", "/r/_mget", {"ids": ["1", "2", "nope"]}, 200),
            ("GET", "/r/_mget", {"ids": ["1"]}, 405),  # no such route
            ("POST", "/_mget", {"docs": [{"_index": "r", "_id": "1"},
                                         {"_index": "nowhere", "_id": "1"}]},
             200),
            ("POST", "/r/_mget?stored_fields=tag", {"ids": ["1", "3"]}, 200),
            ("POST", "/r/_mget?realtime=false", {"ids": ["1"]}, 200),
            ("POST", "/r/_mget?refresh=true", {"ids": ["1", "7"]}, 200),
            ("POST", "/r/_doc/_mget", {"ids": ["2"]}, 200),
            ("GET", "/r/other/_mget", {"ids": ["2"]}, 200),
            ("GET", "/_mget", {}, 400),
            ("GET", "/_mget", {"docs": [{"_id": "1"}]}, 400)):
        st, _ = both_http(servers, method, path, body)
        if status != 201:  # (an upsert's status: the index's own result)
            assert st == status, (path, st)
    both_http(servers, "POST", "/_bulk?refresh=true", ndjson([
        {"update": {"_index": "r", "_id": "1"}}, {"doc": {"n": 1}},
        {"update": {"_index": "r", "_id": "2", "_retry_on_conflict": 1}},
        {"script": {"source": "ctx._source.n += params.a",
                    "params": {"a": 2}}},
        {"update": {"_index": "r", "_id": "nope"}}, {"doc": {"n": 1}},
        {"update": {"_index": "r", "_id": "u1"}},
        {"doc": {"n": 1}, "doc_as_upsert": True}]), "application/x-ndjson")
    both_http(servers, "POST", "/r/_mget", {"ids": ["1", "2", "u1", "nope"]})
    both_http(servers, "POST", "/r/_search", {"query": {"match_all": {}},
                                              "sort": [{"n": "asc"}],
                                              "size": 20})
