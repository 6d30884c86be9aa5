"""Reindex, update by query and delete by query on the port, against the
JAX package.

Each case seeds the same documents (numpy, from a seed) into a JAX node
(tile kernel in interpret mode) and a port node (``device="cpu"``), runs
the same by-query call on both and holds the port's response to the JAX
one but for ``took``, then the resulting indices' contents. The source is
a 3-shard index on the port's mesh plane or on its host rung
(``index.search.mesh: false``); every index pins
``index.refresh_interval: -1``. Mirrors tests/test_painless.py's three
by-query script cases and tests/test_scroll_pit.py's point-in-time
reindex, and covers ``ctx.op`` of each kind, ``max_docs``, ``op_type:
create`` conflicts, ``dest.pipeline``, the REST routes, the task with its
status while a run goes on, and the device-memory ledger after a run.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index import reindex as jrx
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.index import reindex as trx
from torch_pair import NodePair

WORDS = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "kappa"]
MAPPING = {"properties": {
    "title": {"type": "text"},
    "n": {"type": "integer"},
    "kind": {"type": "keyword"},
}}


def _docs(seed=7, count=60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        words = rng.choice(WORDS, size=int(rng.integers(2, 5)))
        out.append((f"d{i}", {"title": " ".join(words),
                              "n": int(rng.integers(0, 100)),
                              "kind": "odd" if i % 2 else "even"}))
    return out


def _create(node, name, mesh=True, shards=3):
    # slot headroom: each write-back refresh adds a segment a shard; no
    # compaction pass, which would merge the deletes away between two
    # answers that are compared
    node.create_index(name, {
        "settings": {"index": {"number_of_shards": shards,
                               "refresh_interval": -1,
                               "search": {"mesh": mesh},
                               "search.mesh.max_slots_per_device": 12,
                               "staging.compact.threshold": 1.0}},
        "mappings": MAPPING})


@pytest.fixture(params=["mesh", "host"])
def pair(request):
    p = NodePair()
    for node in (p.j, p.t):
        _create(node, "src", mesh=request.param == "mesh")
        node.bulk([("index", {"_index": "src", "_id": i}, src)
                   for i, src in _docs()], refresh=True)
    p.plane = request.param
    yield p
    p.close()


def _strip(resp):
    return {k: v for k, v in resp.items() if k != "took"}


def _contents(node, index):
    node.indices[index].refresh()
    r = node.search(index, {"query": {"match_all": {}}, "size": 1000})
    return sorted((h["_id"], h["_source"]) for h in r["hits"]["hits"])


def _both(pair, fn):
    jr, tr = fn(jrx, pair.j), fn(trx, pair.t)
    assert _strip(tr) == _strip(jr)
    return tr


def test_reindex_plain_and_by_query(pair):
    out = _both(pair, lambda m, n: m.reindex(n, {
        "source": {"index": "src", "query": {"match": {"title": "alpha"}}},
        "dest": {"index": "dst"}}))
    assert out["created"] > 0
    assert _contents(pair.t, "dst") == _contents(pair.j, "dst")
    # the destination answers the source's query with the same ids
    q = {"query": {"match": {"title": "alpha"}}, "size": 100}
    ids = sorted(h["_id"] for h in pair.t.search("src", q)["hits"]["hits"])
    assert sorted(h["_id"] for h in
                  pair.t.search("dst", q)["hits"]["hits"]) == ids


def test_reindex_with_script(pair):
    out = _both(pair, lambda m, n: m.reindex(n, {
        "source": {"index": "src"},
        "dest": {"index": "dst"},
        "script": {"source": "if (ctx._source.kind == 'odd') "
                             "{ ctx.op = 'none' } "
                             "else { ctx._source.copied = true }"}}))
    assert out["created"] == 30 and out["noops"] == 30
    got = _contents(pair.t, "dst")
    assert got == _contents(pair.j, "dst")
    assert all(src["copied"] is True for _, src in got)


def test_update_by_query_with_script(pair):
    out = _both(pair, lambda m, n: m.update_by_query(n, "src", {
        "query": {"term": {"kind": "odd"}},
        "script": {"source": "ctx._source.n += params.by",
                   "params": {"by": 100}}}))
    assert out["updated"] == 30 and out["noops"] == 0
    assert _contents(pair.t, "src") == _contents(pair.j, "src")
    assert pair.t.get_doc("src", "d1")["_source"]["n"] >= 100
    assert pair.t.get_doc("src", "d0")["_source"]["n"] < 100


def test_update_by_query_ctx_op(pair):
    out = _both(pair, lambda m, n: m.update_by_query(n, "src", {
        "script": {"source": """
            if (ctx._source.n < 20) { ctx.op = 'delete' }
            else if (ctx._source.kind == 'odd') { ctx.op = 'noop' }
            else { ctx._source.touched = true }
        """}}))
    assert out["deleted"] > 0 and out["noops"] > 0 and out["updated"] > 0
    assert _contents(pair.t, "src") == _contents(pair.j, "src")


def test_update_by_query_without_script_keeps_docs(pair):
    _both(pair, lambda m, n: m.update_by_query(n, "src", {
        "query": {"match": {"title": "beta"}}}))
    assert _contents(pair.t, "src") == _contents(pair.j, "src")


def test_delete_by_query(pair):
    out = _both(pair, lambda m, n: m.delete_by_query(n, "src", {
        "query": {"match": {"title": "gamma"}}}))
    assert out["deleted"] == out["total"] > 0
    assert _contents(pair.t, "src") == _contents(pair.j, "src")
    q = {"query": {"match": {"title": "gamma"}}}
    assert pair.t.search("src", q)["hits"]["total"] == 0


def test_delete_by_query_requires_a_query(pair):
    for m, n in ((jrx, pair.j), (trx, pair.t)):
        with pytest.raises(Exception) as ei:
            m.delete_by_query(n, "src", {})
        assert "requires a query" in str(ei.value)


@pytest.mark.parametrize("max_docs", [1, 7, 1000])
def test_reindex_max_docs(pair, max_docs):
    out = _both(pair, lambda m, n: m.reindex(n, {
        "max_docs": max_docs, "source": {"index": "src", "size": 5},
        "dest": {"index": "dst"}}))
    assert out["total"] == min(max_docs, 60)
    assert _contents(pair.t, "dst") == _contents(pair.j, "dst")


def test_reindex_op_type_create_conflicts(pair):
    for node in (pair.j, pair.t):
        _create(node, "dst", mesh=False, shards=1)
        node.index_doc("dst", "d0", {"title": "already", "n": -1,
                                     "kind": "x"})
        node.index_doc("dst", "d2", {"title": "already", "n": -1,
                                     "kind": "x"})
    out = _both(pair, lambda m, n: m.reindex(n, {
        "source": {"index": "src"},
        "dest": {"index": "dst", "op_type": "create"}}))
    assert len(out["failures"]) == 2
    assert out["failures"][0]["type"] == "version_conflict_engine_exception"
    assert _contents(pair.t, "dst") == _contents(pair.j, "dst")


def test_script_ctx_op_create_and_index_routing(pair):
    for node in (pair.j, pair.t):
        _create(node, "dst", mesh=False, shards=1)
        node.index_doc("dst", "d4", {"title": "kept", "n": 0, "kind": "x"})
    out = _both(pair, lambda m, n: m.reindex(n, {
        "source": {"index": "src"},
        "dest": {"index": "dst"},
        "script": {"source": """
            if (ctx._source.kind == 'odd') { ctx._index = 'dst-odd' }
            else { ctx.op = 'create' }
        """}}))
    assert len(out["failures"]) == 1
    for name in ("dst", "dst-odd"):
        assert _contents(pair.t, name) == _contents(pair.j, name)


def test_script_ctx_op_delete_removes_from_dest(pair):
    for node in (pair.j, pair.t):
        _create(node, "dst", mesh=False, shards=1)
        for i in range(6):
            node.index_doc("dst", f"d{i}", {"title": "x", "n": i,
                                            "kind": "x"})
    out = _both(pair, lambda m, n: m.reindex(n, {
        "source": {"index": "src"},
        "dest": {"index": "dst"},
        "script": {"source": "if (ctx._source.kind == 'even') "
                             "{ ctx.op = 'delete' }"}}))
    assert out["deleted"] == 3
    assert _contents(pair.t, "dst") == _contents(pair.j, "dst")


def test_bad_script_op_raises_like_jax(pair):
    errs = []
    for m, n in ((jrx, pair.j), (trx, pair.t)):
        with pytest.raises(Exception) as ei:
            m.update_by_query(n, "src", {"script": {
                "source": "ctx.op = 'explode'"}})
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    assert "not allowed" in errs[1]


def test_dest_pipeline(pair):
    for node in (pair.j, pair.t):
        node.ingest.put_pipeline("tag", {"processors": [
            {"set": {"field": "tagged", "value": "{{kind}}"}},
            {"uppercase": {"field": "kind"}}]})
    _both(pair, lambda m, n: m.reindex(n, {
        "source": {"index": "src", "query": {"term": {"kind": "even"}}},
        "dest": {"index": "dst", "pipeline": "tag"}}))
    got = _contents(pair.t, "dst")
    assert got == _contents(pair.j, "dst")
    assert got and all(s["tagged"] == "even" and s["kind"] == "EVEN"
                       for _, s in got)


def test_rest_routes_answer_like_jax(pair):
    pair.same("POST", "/_reindex", {
        "source": {"index": "src", "query": {"match": {"title": "omega"}}},
        "dest": {"index": "copy"}}, status=200)
    pair.same("POST", "/src/_update_by_query", {
        "query": {"term": {"kind": "even"}},
        "script": {"source": "ctx._source.n = 0"}}, status=200)
    pair.same("POST", "/src/_delete_by_query", {
        "query": {"match": {"title": "kappa"}}}, status=200)
    pair.same("POST", "/src/_delete_by_query", {}, status=400)
    pair.same("POST", "/src/_search", {
        "query": {"match_all": {}}, "size": 100,
        "sort": [{"n": "asc"}, "_doc"]}, status=200)
    pair.same("POST", "/copy/_search", {
        "query": {"match_all": {}}, "size": 100, "sort": ["_doc"]},
        status=200)


def test_point_in_time_under_concurrent_writes(pair):
    """A reindex over a source that takes writes between its batches
    copies exactly the docs visible at its start, at their values then
    (tests/test_scroll_pit.py's case, in both packages)."""
    def interfering(mod, node):
        orig = mod._scan_batches

        def scan(n, expr, query, batch_size, *rest):
            step = 0
            for batch in orig(n, expr, query, batch_size, *rest):
                yield batch
                node.index_doc("src", f"new{step}", {"title": "new",
                                                     "n": 500 + step,
                                                     "kind": "new"})
                node.index_doc("src", f"d{step % 60}", {"title": "upd",
                                                        "n": 900,
                                                        "kind": "updated"})
                node.delete_doc("src", f"d{(step + 7) % 60}")
                node.indices["src"].refresh()
                step += 1
        return orig, scan

    before = _contents(pair.t, "src")
    for mod, node in ((jrx, pair.j), (trx, pair.t)):
        orig, scan = interfering(mod, node)
        mod._scan_batches = scan
        try:
            out = mod.reindex(node, {"source": {"index": "src", "size": 5},
                                     "dest": {"index": "dst"}})
        finally:
            mod._scan_batches = orig
        assert out["created"] == 60 and not out["failures"]
    got = _contents(pair.t, "dst")
    assert got == _contents(pair.j, "dst") == before


def test_task_is_listed_with_its_status_while_running(pair):
    node = pair.t
    seen = []
    orig = trx._scan_batches

    def scan(n, expr, query, batch_size, *rest):
        for batch in orig(n, expr, query, batch_size, *rest):
            yield batch
            seen.append(node.tasks.list_tasks(actions="*reindex*"))

    trx._scan_batches = scan
    try:
        trx.reindex(node, {"source": {"index": "src", "size": 10},
                           "dest": {"index": "dst"}})
    finally:
        trx._scan_batches = orig
    tasks = seen[-1]["nodes"][node.node_id]["tasks"]
    (entry,) = tasks.values()
    assert entry["action"] == "indices:data/write/reindex"
    assert entry["description"] == "reindex from [src] to [dst]"
    assert entry["status"]["total"] == 60
    assert entry["status"]["created"] == 60
    assert not node.tasks.list_tasks()["nodes"][node.node_id]["tasks"]


def test_cancelled_by_query_run_stops_between_batches(pair, monkeypatch):
    node = pair.t
    monkeypatch.setattr(trx, "DEFAULT_BATCH", 10)
    orig = trx._scan_batches

    def scan(n, expr, query, batch_size, *rest):
        for i, batch in enumerate(orig(n, expr, query, batch_size, *rest)):
            if i == 1:
                tid = next(iter(node.tasks.list_tasks(
                    actions="*byquery*")["nodes"][node.node_id]["tasks"]))
                node.tasks.cancel(tid)
            yield batch

    trx._scan_batches = scan
    try:
        with pytest.raises(Exception) as ei:
            trx.delete_by_query(node, "src", {"query": {"match_all": {}}})
    finally:
        trx._scan_batches = orig
    assert type(ei.value).__name__ == "TaskCancelledException"
    # the first batch was deleted, the rest never reached
    node.indices["src"].refresh()
    assert node.search("src", {"size": 0})["hits"]["total"] == 50
    assert node.tasks.list_tasks()["nodes"][node.node_id]["tasks"] == {}


def test_scan_leaves_the_ledger_where_it_was(pair):
    node = pair.t
    node.search("src", {"query": {"match": {"title": "alpha"}}})
    acct = memory_accountant()
    before = acct.staged_bytes("src")
    trx.update_by_query(node, "src", {"query": {"match": {"title": "delta"}},
                                      "script": {"source": "ctx.op = 'noop'"}})
    assert acct.staged_bytes("src") == before
    assert not [k for k in acct._entries if k[1].startswith("scan#")]


def test_first_answer_after_by_query_writes_equals_a_fresh_staging(pair):
    """The answer after update and delete by query (the delta append and
    tombstone paths on the mesh plane) equals the same index's answer
    after its staging is dropped and built again."""
    node = pair.t
    svc = node.indices["src"]
    body = {"query": {"match": {"title": "alpha beta"}}, "size": 20}
    node.search("src", body)
    trx.update_by_query(node, "src", {
        "query": {"match": {"title": "sigma"}},
        "script": {"source": "ctx._source.title += ' alpha'"}})
    trx.delete_by_query(node, "src", {"query": {"term": {"kind": "odd"}}})
    after = node.search("src", body)
    assert after.get("_plane", "host") == ("host" if pair.plane == "host"
                                           else "mesh_pallas")
    if svc._mesh_search is not None:
        svc._mesh_search._drop_staging()
    fresh = node.search("src", body)
    assert after["hits"]["total"] == fresh["hits"]["total"]
    assert [h["_id"] for h in after["hits"]["hits"]] == \
        [h["_id"] for h in fresh["hits"]["hits"]]
    assert [h["_score"] for h in after["hits"]["hits"]] == \
        [h["_score"] for h in fresh["hits"]["hits"]]
    # and the JAX package's after the same calls
    jrx.update_by_query(pair.j, "src", {
        "query": {"match": {"title": "sigma"}},
        "script": {"source": "ctx._source.title += ' alpha'"}})
    jrx.delete_by_query(pair.j, "src", {"query": {"term": {"kind": "odd"}}})
    jr = pair.j.search("src", body)
    assert jr["hits"]["total"] == after["hits"]["total"]
    np.testing.assert_allclose(
        sorted(h["_score"] for h in jr["hits"]["hits"]),
        sorted(h["_score"] for h in after["hits"]["hits"]), rtol=1e-5)
