"""Search over several indices on the port, against the JAX package.

A JAX ``Node`` (tile kernel in interpret mode, ``ES_TPU_PALLAS=interpret``)
and a port ``Node(device="cpu")`` hold the same three indices: ``logs-a``
(2 shards) and ``logs-b`` (3 shards, with a field ``logs-a`` lacks) and
``other`` (1 shard). Both are asked the same searches over comma lists,
wildcards and ``_all``, and ``_msearch`` with Kibana 6.x Discover's own
body over ``logs-*``; the port's answer must equal the JAX one (every key
but ``took``, scores within rtol 1e-5), collapse and aggregations across
indices included. A scroll opened over two indices pages exactly its
snapshot while both indices take writes, deletes and refreshes, page for
page as the JAX one does. Both nodes are closed by every fixture.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    IndexNotFoundException as JIndexNotFound,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.rest.controller import RestController as JRest
from elasticsearch_tpu_torch.common.errors import IndexNotFoundException
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController
from test_torch_search_fault_tolerance import same

T0 = 1_600_000_000_000
HOUR = 3_600_000

INDICES = {
    "logs-a": (2, {"properties": {
        "title": {"type": "text"}, "host": {"type": "keyword"},
        "ts": {"type": "date"}, "bytes": {"type": "long"}}}),
    "logs-b": (3, {"properties": {
        "title": {"type": "text"}, "host": {"type": "keyword"},
        "ts": {"type": "date"}, "bytes": {"type": "long"},
        "status": {"type": "integer"}}}),
    "other": (1, {"properties": {
        "title": {"type": "text"}, "host": {"type": "keyword"}}}),
}


def _docs(name, n, seed):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(9)]
    out = []
    for d in range(n):
        src = {"title": " ".join(rng.choice(words, rng.randint(2, 7))),
               "host": f"h{rng.randint(4)}"}
        if name != "other":
            src["ts"] = int(T0 + rng.randint(0, 48) * HOUR
                            + rng.randint(0, 60) * 60_000)
            src["bytes"] = int(rng.randint(0, 5000))
        if name == "logs-b":
            src["status"] = int(rng.choice([200, 404, 500]))
        out.append((f"{name}-{d}", src))
    return out


@pytest.fixture(scope="module")
def nodes():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(JSettings.EMPTY), Node(device="cpu")
    for seed, (name, (shards, mapping)) in enumerate(INDICES.items()):
        docs = _docs(name, 60, seed)
        for n in (jn, tn):
            n.create_index(name, {"settings": {"number_of_shards": shards},
                                  "mappings": mapping})
            for doc_id, src in docs:
                n.index_doc(name, doc_id, src)
            n.indices[name].refresh()
    yield jn, tn
    jn.close()
    tn.close()
    mp.undo()


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


def both(nodes, expression, body):
    jn, tn = nodes
    jr, tr = jn.search(expression, dict(body)), tn.search(expression,
                                                         dict(body))
    same(jr, tr)
    return tr


MATCH = {"match": {"title": "w1 w3"}}


@pytest.mark.parametrize("expression", [
    "logs-a,logs-b", "logs-*", "_all", "*", "logs-a,other", "logs-b,logs-b",
    "logs-*,other",
])
def test_expressions(nodes, expression):
    r = both(nodes, expression, {"query": MATCH, "size": 25})
    names = nodes[1].resolve_index_names(expression)
    # one index keeps its own planes; more are the host fan-out
    assert ("_plane" in r) == (len(names) == 1)
    assert {h["_index"] for h in r["hits"]["hits"]} <= set(names)
    assert r["_shards"]["total"] == sum(INDICES[n][0] for n in names)


def test_one_index_through_a_wildcard_keeps_its_planes(nodes):
    r = both(nodes, "oth*", {"query": MATCH})
    assert r["_plane"] == "host"  # one shard


def test_sorted_and_paged(nodes):
    for body in ({"query": MATCH, "sort": [{"ts": "desc"}], "size": 7,
                  "from": 5},
                 {"query": {"match_all": {}},
                  "sort": [{"bytes": {"order": "asc", "missing": "_first"}},
                           {"host": "desc"}], "size": 30},
                 {"query": MATCH, "size": 10, "from": 10}):
        both(nodes, "logs-*,other", body)


def test_a_missing_name_and_an_empty_wildcard(nodes):
    jn, tn = nodes
    with pytest.raises(JIndexNotFound):
        jn.search("logs-a,nope", {})
    with pytest.raises(IndexNotFoundException):
        tn.search("logs-a,nope", {})
    r = both(nodes, "zzz*", {"query": MATCH})
    assert r["hits"]["total"] == 0 and r["_shards"]["total"] == 0


def test_aggregations_across_indices(nodes):
    r = both(nodes, "logs-*,other", {"size": 0, "aggs": {
        "hosts": {"terms": {"field": "host"},
                  "aggs": {"b": {"avg": {"field": "bytes"}}}},
        "status": {"terms": {"field": "status"}},
        "per_hour": {"date_histogram": {"field": "ts", "interval": "6h"}},
        "bytes": {"stats": {"field": "bytes"}}}})
    assert sum(b["doc_count"] for b in r["aggregations"]["hosts"]["buckets"]) \
        == 180


def test_collapse_across_indices(nodes):
    r = both(nodes, "logs-*", {"query": MATCH, "size": 6,
                               "collapse": {"field": "host", "inner_hits": {
                                   "name": "top", "size": 2}}})
    keys = [h["fields"]["host"][0] for h in r["hits"]["hits"]]
    assert len(keys) == len(set(keys))


DISCOVER = {
    "version": True, "size": 50,
    "sort": [{"ts": {"order": "desc", "unmapped_type": "boolean"}}],
    "_source": {"excludes": []},
    "aggs": {"2": {"date_histogram": {"field": "ts", "interval": "3h",
                                      "min_doc_count": 1}}},
    "stored_fields": ["*"], "script_fields": {}, "docvalue_fields": ["ts"],
    "query": {"bool": {"must": [
        {"match": {"title": "w2 w5"}},
        {"range": {"ts": {"gte": T0 + 6 * HOUR, "lte": T0 + 40 * HOUR,
                          "format": "epoch_millis"}}}],
        "filter": [], "should": [], "must_not": []}},
    "highlight": {"pre_tags": ["@kibana-highlighted-field@"],
                  "post_tags": ["@/kibana-highlighted-field@"],
                  "fields": {"*": {}}, "fragment_size": 2147483647},
}


def test_msearch_with_discovers_body(nodes):
    jn, tn = nodes
    searches = [({"index": "logs-*", "ignore_unavailable": True},
                 DISCOVER),
                ({"index": "logs-a"}, DISCOVER),
                ({}, {"query": MATCH, "size": 3})]
    jr = jn.msearch([(dict(h), dict(b)) for h, b in searches])
    tr = tn.msearch([(dict(h), dict(b)) for h, b in searches])
    same(jr, tr)
    multi, single = tr["responses"][0], tr["responses"][1]
    assert multi["_shards"]["failed"] == 0 and not multi["timed_out"]
    hits = multi["hits"]["hits"]
    assert hits and all("_version" in h and h["fields"]["ts"]
                        and "highlight" in h for h in hits)
    ts = [h["sort"][0] for h in hits]
    assert ts == sorted(ts, reverse=True)
    # the merged answer is the single-index answers merged
    b = tn.search("logs-b", dict(DISCOVER))
    assert multi["hits"]["total"] == (single["hits"]["total"]
                                      + b["hits"]["total"])
    merged = sorted(single["hits"]["hits"] + b["hits"]["hits"],
                    key=lambda h: (-h["sort"][0], h["_index"]))
    assert [(h["_index"], h["_id"]) for h in hits] == [
        (h["_index"], h["_id"]) for h in merged[: len(hits)]]


def test_msearch_over_rest(nodes):
    jn, tn = nodes
    import json
    lines = [{"index": "logs-*"}, {"query": MATCH, "size": 4},
             {"index": "_all"}, {"query": MATCH, "size": 4,
                                 "track_total_hits": True}]
    payload = ("\n".join(json.dumps(x) for x in lines) + "\n").encode()
    args = ("POST", "/_msearch", {}, payload, "application/x-ndjson")
    js, jp = JRest(jn).dispatch(*args)
    ts, tp = RestController(tn).dispatch(*args)
    assert ts == js == 200
    same(jp, tp)
    assert tp["responses"][1]["hits"]["total"]["relation"] == "eq"


def test_scroll_across_two_indices_under_writes():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(JSettings.EMPTY), Node(device="cpu")
    try:
        for seed, name in enumerate(("sa", "sb")):
            docs = _docs("logs-a", 40, seed + 7)
            for n in (jn, tn):
                n.create_index(name, {"settings": {"number_of_shards": 2},
                                      "mappings": INDICES["logs-a"][1]})
                for doc_id, src in docs:
                    n.index_doc(name, doc_id, src)
                n.indices[name].refresh()
        for bi, body in enumerate((
                {"query": MATCH, "size": 7},
                {"query": {"match_all": {}}, "size": 9,
                 "sort": [{"ts": "asc"}]})):
            jf = jn.search("sa,sb", dict(body), scroll="1m")
            tf = tn.search("sa,sb", dict(body), scroll="1m")
            pages_j, pages_t = [jf], [tf]
            step = 0
            written = set()
            while pages_t[-1]["hits"]["hits"]:
                # writes, deletes and refreshes between the pages
                doc_id = f"new{bi}-{len(written)}"
                written.add(doc_id)
                for n in (jn, tn):
                    n.index_doc("sa", doc_id,
                                {"title": "w1 w3 w1", "ts": T0, "bytes": 1})
                    n.delete_doc("sb", f"logs-a-{bi * 20 + step}")
                    for name in ("sa", "sb"):
                        n.indices[name].refresh()
                pages_j.append(jn.scroll(jf["_scroll_id"]))
                pages_t.append(tn.scroll(tf["_scroll_id"]))
                step += 1
            assert len(pages_t) == len(pages_j)
            for pj, pt in zip(pages_j, pages_t):
                same({k: v for k, v in pj.items() if k != "_scroll_id"},
                     {k: v for k, v in pt.items() if k != "_scroll_id"})
            seen = [(h["_index"], h["_id"]) for p in pages_t
                    for h in p["hits"]["hits"]]
            assert len(seen) == len(set(seen)) == tf["hits"]["total"]
            assert not any(i in written for _x, i in seen)
            for n, f in ((jn, jf), (tn, tf)):
                n.clear_scroll([f["_scroll_id"]])
    finally:
        jn.close()
        tn.close()
        mp.undo()
