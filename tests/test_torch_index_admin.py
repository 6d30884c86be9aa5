"""Term vectors, rollover, shrink and ``_field_caps`` on the port, against
the JAX package.

Mirrors tests/test_misc_apis.py's termvectors, missing doc, rollover,
dry run and shrink cases over REST on a JAX and a port node side by side
(``NodePair``: statuses and bodies equal but for ``took`` and uuids), and
holds ``_field_caps`` equal to the JAX package's over several indices and
index expressions. Every index pins ``index.refresh_interval: -1``.
"""

import numpy as np
import pytest

from torch_pair import NodePair


@pytest.fixture()
def pair():
    p = NodePair()
    yield p
    p.close()


def test_termvectors(pair):
    pair.same("PUT", "/idx", {"settings": {"refresh_interval": -1}},
              status=200)
    pair.same("PUT", "/idx/_doc/1", {"body": "quick quick fox",
                                     "title": "the fox"},
              params={"refresh": "true"}, status=201)
    pair.same("PUT", "/idx/_doc/2", {"body": "lazy fox"},
              params={"refresh": "true"}, status=201)
    r = pair.same("GET", "/idx/_termvectors/1", status=200)
    assert r["found"]
    terms = r["term_vectors"]["body"]["terms"]
    assert terms["quick"]["term_freq"] == 2
    assert [t["position"] for t in terms["quick"]["tokens"]] == [0, 1]
    # per segment: doc 2 was refreshed into a segment of its own
    assert terms["fox"]["doc_freq"] == 1
    r = pair.same("GET", "/idx/_termvectors/1", params={"fields": "title"},
                  status=200)
    assert set(r["term_vectors"]) == {"title"}
    pair.same("POST", "/idx/_termvectors/2", {"fields": ["body"]},
              status=200)
    pair.same("GET", "/idx/_doc/1/_termvectors", status=200)


def test_termvectors_missing_doc(pair):
    pair.same("PUT", "/idx/_doc/1", {"a": "x"}, params={"refresh": "true"},
              status=201)
    r = pair.same("GET", "/idx/_termvectors/404", status=200)
    assert not r["found"]
    pair.same("GET", "/nope/_termvectors/1", status=404)


def test_termvectors_after_an_update_and_a_merge(pair):
    """The live copy of a doc is read, from whichever segment holds it."""
    for n in (pair.j, pair.t):
        n.create_index("tv", {"settings": {"number_of_shards": 1,
                                           "refresh_interval": -1}})
        n.index_doc("tv", "1", {"body": "alpha beta"}, refresh=True)
        n.index_doc("tv", "2", {"body": "beta gamma gamma"}, refresh=True)
        n.index_doc("tv", "1", {"body": "delta alpha alpha"}, refresh=True)
    pair.same("GET", "/tv/_termvectors/1", status=200)
    pair.same("POST", "/tv/_forcemerge", status=200)
    pair.same("GET", "/tv/_termvectors/2", status=200)


def test_rollover_by_docs(pair):
    pair.same("PUT", "/logs-000001", {"aliases": {"logs": {}},
                                      "settings": {"refresh_interval": -1}},
              status=200)
    for i in range(3):
        pair.same("PUT", f"/logs/_doc/{i}", {"n": i},
                  params={"refresh": "true"}, status=201)
    r = pair.same("POST", "/logs/_rollover",
                  {"conditions": {"max_docs": 100}}, status=200)
    assert not r["rolled_over"]
    r = pair.same("POST", "/logs/_rollover",
                  {"conditions": {"max_docs": 2}}, status=200)
    assert r["rolled_over"] and r["new_index"] == "logs-000002"
    pair.same("PUT", "/logs/_doc/x", {"n": 9}, params={"refresh": "true"},
              status=201)
    sr = pair.same("POST", "/logs-000002/_search", {}, status=200)
    assert sr["hits"]["total"] == 1
    pair.same("GET", "/_alias/logs", status=200)


def test_rollover_dry_run(pair):
    pair.same("PUT", "/logs-000001", {"aliases": {"logs": {}}}, status=200)
    r = pair.same("POST", "/logs/_rollover",
                  {"conditions": {"max_docs": 0}},
                  params={"dry_run": ""}, status=200)
    assert not r["rolled_over"] and r["dry_run"]
    pair.same("GET", "/_alias/logs", status=200)
    pair.same("HEAD", "/logs-000002", status=404)


def test_rollover_named_and_by_age_and_size(pair):
    pair.same("PUT", "/app", {"aliases": {"w": {}}}, status=200)
    pair.same("PUT", "/app/_doc/1", {"msg": "x" * 50},
              params={"refresh": "true"}, status=201)
    r = pair.same("POST", "/w/_rollover", {"conditions": {
        "max_age": "7d", "max_size": "5gb"}}, status=200)
    assert not r["rolled_over"]
    r = pair.same("POST", "/w/_rollover", {"conditions": {
        "max_age": "0ms"}}, status=200)
    assert r["new_index"] == "app-000002"
    r = pair.same("POST", "/w/_rollover/app-next", {
        "conditions": {"max_docs": 0, "max_size": "1b"},
        "settings": {"number_of_shards": 2}}, status=200)
    assert r["rolled_over"] and r["new_index"] == "app-next"
    s = pair.same("GET", "/app-next/_settings", status=200)
    assert s["app-next"]["settings"]["index"]["number_of_shards"] == "2"
    pair.same("POST", "/w/_rollover", {}, status=200)
    pair.same("PUT", "/other", {"aliases": {"two": {}}}, status=200)
    pair.same("PUT", "/other2", {"aliases": {"two": {}}}, status=200)
    pair.same("POST", "/two/_rollover", {}, status=400)


def test_shrink_to_one_shard(pair):
    pair.same("PUT", "/big", {"settings": {"index": {
        "number_of_shards": 4, "refresh_interval": -1}}}, status=200)
    rng = np.random.default_rng(11)
    for i in range(40):
        pair.same("PUT", f"/big/_doc/{i}", {
            "n": int(rng.integers(0, 100)),
            "w": " ".join(rng.choice(["a", "b", "c", "d"], size=3))},
            status=201)
    pair.same("DELETE", "/big/_doc/3", status=200)
    pair.same("POST", "/big/_refresh", status=200)
    r = pair.same("POST", "/big/_shrink/small", {"settings": {"index": {
        "number_of_shards": 1}}}, status=200)
    assert r["acknowledged"]
    sr = pair.same("POST", "/small/_search", {"size": 0}, status=200)
    assert sr["hits"]["total"] == 39
    assert sr["_shards"]["total"] == 1
    for body in ({"query": {"match": {"w": "a b"}}, "size": 50},
                 {"query": {"range": {"n": {"gte": 50}}}, "size": 50,
                  "sort": ["n", "_id"]}):
        big, small = (pair.t.search(i, body) for i in ("big", "small"))
        assert small["hits"]["total"] == big["hits"]["total"]
        assert sorted(h["_id"] for h in small["hits"]["hits"]) == \
            sorted(h["_id"] for h in big["hits"]["hits"])
        pair.same("POST", "/small/_search", body, status=200)
    pair.same("PUT", "/big/_shrink/three", {"settings": {
        "index.number_of_shards": 3}}, status=400)


def test_field_caps_like_jax(pair):
    pair.same("PUT", "/logs-a", {"mappings": {"_doc": {"properties": {
        "msg": {"type": "text"}, "n": {"type": "long"},
        "host": {"type": "keyword"}, "t": {"type": "date"},
        "geo": {"type": "geo_point"}, "ip": {"type": "ip"},
        "body": {"type": "text", "fielddata": True},
        "hidden": {"type": "keyword", "index": False},
        "nodv": {"type": "keyword", "doc_values": False}}}}}, status=200)
    pair.same("PUT", "/logs-b", {"mappings": {"_doc": {"properties": {
        "msg": {"type": "keyword"}, "n": {"type": "integer"},
        "extra": {"type": "boolean"}}}}}, status=200)
    pair.same("PUT", "/other", {"mappings": {"_doc": {"properties": {
        "x": {"type": "double"}}}}}, status=200)
    for method in ("GET", "POST"):
        pair.same(method, "/_field_caps", params={"fields": "*"},
                  status=200)
        pair.same(method, "/logs-*/_field_caps", params={"fields": "*"},
                  status=200)
    pair.same("GET", "/logs-a,other/_field_caps",
              params={"fields": "msg,x,n"}, status=200)
    pair.same("POST", "/logs-*/_field_caps", {"fields": ["m*", "n"]},
              status=200)
    r = pair.same("GET", "/logs-*/_field_caps", params={"fields": "msg"},
                  status=200)
    assert set(r["fields"]["msg"]) == {"text", "keyword"}
    pair.same("GET", "/missing/_field_caps", params={"fields": "*"},
              status=404)
