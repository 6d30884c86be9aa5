"""Parity of the shard request cache with the JAX package.

Mirrors tests/test_request_cache.py (10 cases): a repeated ``size: 0``
request hits, a write invalidates at its refresh (an update, a delete,
new docs), an empty refresh keeps the entry, requests with hits and
profiled requests are never cached, ``index.requests.cache.enable:
false``, the ``_stats`` section and the byte-bounded LRU. Each case runs
on a JAX ``Node`` and a port ``Node(device="cpu")``: the answers (but
``took``) and the cache's counters equal.

Added: a hit returns the miss's hits and aggregations, and runs nothing
(no plane serves it: the mesh plane's and the host rung's counters stay
put); every kind of visible change moves ``shard_epoch`` (a refresh with
new docs, a delete, a re-index of an existing id, a delete-only refresh)
and an empty refresh does not; both ``_cache/clear`` routes answer as the
JAX package's; and ROADMAP C20: the port's ``_cache/clear`` empties the
request cache, where the JAX package's keeps it.
"""

import copy

import pytest

from elasticsearch_tpu.index.request_cache import RequestCache as JCache
from elasticsearch_tpu.index.request_cache import shard_epoch as jepoch
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu_torch.index.request_cache import (
    RequestCache,
    cacheable,
    shard_epoch,
)
from elasticsearch_tpu_torch.node import Node
from torch_pair import NodePair


def make_nodes(shards=1):
    nodes = (JNode(), Node(device="cpu"))
    for node in nodes:
        node.create_index("logs", {
            "settings": {"number_of_shards": shards,
                         "refresh_interval": "-1"},
            "mappings": {"_doc": {"properties": {
                "host": {"type": "keyword"},
                "msg": {"type": "text"},
            }}}})
        for i in range(40):
            node.index_doc("logs", str(i), {
                "host": f"web-{i % 4}", "msg": f"event {i}"},
                refresh=(i == 39))
    return nodes


@pytest.fixture()
def nodes():
    made = []

    def make(shards=1):
        pair = make_nodes(shards)
        made.extend(pair)
        return pair

    yield make
    for node in made:
        node.close()


AGG_BODY = {
    "query": {"match": {"msg": "event"}},
    "size": 0,
    "aggs": {"hosts": {"terms": {"field": "host"}}},
}


def cache_stats(node):
    return node.indices["logs"].request_cache.stats()


def no_took(resp):
    resp = copy.deepcopy(resp)
    resp.pop("took", None)
    resp.pop("_plane", None)
    return resp


def both(pair, body, index="logs"):
    jr = pair[0].search(index, copy.deepcopy(body))
    tr = pair[1].search(index, copy.deepcopy(body))
    assert no_took(jr) == no_took(tr)
    return tr


def same_counts(pair):
    js, ts = cache_stats(pair[0]), cache_stats(pair[1])
    for key in ("hit_count", "miss_count", "evictions", "entries"):
        assert js[key] == ts[key], (key, js, ts)
    return ts


class TestRequestCache:
    def test_repeat_agg_request_hits(self, nodes):
        pair = nodes()
        r1 = both(pair, AGG_BODY)
        s = same_counts(pair)
        assert s["miss_count"] == 1 and s["hit_count"] == 0
        r2 = both(pair, AGG_BODY)
        s = same_counts(pair)
        assert s["hit_count"] == 1
        assert r2["hits"]["total"] == r1["hits"]["total"] == 40
        assert r2["aggregations"] == r1["aggregations"]
        assert s["entries"] == 1 and s["memory_size_in_bytes"] > 0

    def test_write_invalidates_before_refresh(self, nodes):
        pair = nodes()
        both(pair, AGG_BODY)
        for node in pair:
            node.index_doc("logs", "7", {"host": "web-9", "msg": "changed"})
        r = both(pair, AGG_BODY)
        assert r["hits"]["total"] == 40  # the reader is unchanged
        for node in pair:
            node.indices["logs"].refresh()
        r = both(pair, AGG_BODY)
        assert r["hits"]["total"] == 39

    def test_delete_invalidates(self, nodes):
        pair = nodes()
        both(pair, AGG_BODY)
        for node in pair:
            node.delete_doc("logs", "3", refresh=True)
        r = both(pair, AGG_BODY)
        assert r["hits"]["total"] == 39
        assert same_counts(pair)["hit_count"] == 0

    def test_refresh_with_new_docs_invalidates(self, nodes):
        pair = nodes()
        both(pair, AGG_BODY)
        for node in pair:
            node.index_doc("logs", "new", {"host": "web-0",
                                           "msg": "event new"},
                           refresh=True)
        r = both(pair, AGG_BODY)
        assert r["hits"]["total"] == 41
        assert same_counts(pair)["hit_count"] == 0

    def test_empty_refresh_keeps_cache_valid(self, nodes):
        pair = nodes()
        both(pair, AGG_BODY)
        for node in pair:
            node.indices["logs"].refresh()
        both(pair, AGG_BODY)
        assert same_counts(pair)["hit_count"] == 1

    def test_hit_requests_never_cached(self, nodes):
        pair = nodes()
        body = {"query": {"match": {"msg": "event"}}, "size": 5}
        both(pair, body)
        both(pair, body)
        s = same_counts(pair)
        assert s["hit_count"] == 0 and s["miss_count"] == 0

    def test_profile_not_cached(self, nodes):
        pair = nodes()
        body = dict(AGG_BODY, profile=True)
        for node in pair:
            node.search("logs", dict(body))
            node.search("logs", dict(body))
        assert same_counts(pair)["hit_count"] == 0

    def test_cache_disabled_by_setting(self):
        for node in (JNode(), Node(device="cpu")):
            try:
                node.create_index("quiet", {
                    "settings": {"index": {"requests": {"cache": {
                        "enable": False}}}},
                    "mappings": {"_doc": {"properties": {
                        "msg": {"type": "text"}}}}})
                node.index_doc("quiet", "1", {"msg": "hello"}, refresh=True)
                body = {"query": {"match_all": {}}, "size": 0}
                node.search("quiet", body)
                node.search("quiet", body)
                s = node.indices["quiet"].request_cache.stats()
                assert s["miss_count"] == 0 and s["hit_count"] == 0
            finally:
                node.close()

    def test_stats_exposed_in_index_stats(self, nodes):
        pair = nodes()
        both(pair, AGG_BODY)
        both(pair, AGG_BODY)
        js = pair[0].indices["logs"].stats()["total"]["request_cache"]
        ts = pair[1].indices["logs"].stats()["total"]["request_cache"]
        assert ts == js
        assert ts["hit_count"] == 1 and ts["miss_count"] == 1

    def test_lru_eviction_by_bytes(self):
        out = []
        for cls in (JCache, RequestCache):
            cache = cls(max_bytes=3000)
            for i in range(50):
                cache.put(f"k{i}", {"payload": "x" * 100, "i": i})
            s = cache.stats()
            assert s["evictions"] > 0
            assert s["memory_size_in_bytes"] <= 3000
            assert cache.get("k49") is not None
            assert cache.get("k0") is None
            out.append(cache.stats())
        assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Added: hits run nothing, the epoch, _cache/clear
# ---------------------------------------------------------------------------


def _plane_counters(svc):
    planes = svc.search_stats()["planes"]
    return (svc.host_query_total, planes.get("query_total"),
            planes.get("agg_fused_query_total"))


@pytest.mark.parametrize("shards", [1, 3])
def test_a_hit_returns_the_miss_and_runs_nothing(nodes, monkeypatch, shards):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    pair = nodes(shards)
    body = {"size": 0, "query": {"match": {"msg": "event"}},
            "aggs": {"hosts": {"terms": {"field": "host"}},
                     "n": {"value_count": {"field": "host"}}}}
    miss = pair[1].search("logs", copy.deepcopy(body))
    svc = pair[1].indices["logs"]
    before = _plane_counters(svc)
    hit = pair[1].search("logs", copy.deepcopy(body))
    assert _plane_counters(svc) == before
    assert hit["hits"] == miss["hits"]
    assert hit["aggregations"] == miss["aggregations"]
    assert hit["_plane"] == miss["_plane"]
    assert cache_stats(pair[1])["hit_count"] == 1
    # a hit is a copy: patching it leaves the entry as it was
    hit["aggregations"]["hosts"]["buckets"].clear()
    again = pair[1].search("logs", copy.deepcopy(body))
    assert again["aggregations"] == miss["aggregations"]


def test_every_visible_change_moves_the_epoch(nodes):
    pair = nodes(shards=1)

    def epochs():
        return (jepoch(pair[0].indices["logs"].shards[0]),
                shard_epoch(pair[1].indices["logs"].shards[0]))

    def moved(before, after):
        return [a != b for a, b in zip(before, after)]

    e0 = epochs()
    for node in pair:
        node.indices["logs"].refresh()  # nothing new
    assert moved(e0, epochs()) == [False, False]
    steps = [
        lambda n: n.index_doc("logs", "x", {"host": "web-1", "msg": "x"},
                              refresh=True),
        lambda n: n.delete_doc("logs", "x", refresh=True),
        lambda n: n.index_doc("logs", "5", {"host": "web-2", "msg": "re"},
                              refresh=True),
    ]
    for step in steps:
        e = epochs()
        for node in pair:
            step(node)
        assert moved(e, epochs()) == [True, True]
    # a delete-only refresh: the segment names stay, the write counters
    # moved at the delete itself; the refresh moves visibility_epoch
    for node in pair:
        node.delete_doc("logs", "6")
    e = epochs()
    for node in pair:
        node.indices["logs"].refresh()
    after = epochs()
    assert moved(e, after) == [True, True]
    assert e[1][:3] == after[1][:3] and e[1][3] != after[1][3]


def test_cache_clear_routes_answer_as_jax_and_c20():
    """Both routes answer the JAX package's body. The port's clear also
    empties the request cache (Elasticsearch clears it by default); the
    JAX package's keeps it (ROADMAP C20)."""
    pair = NodePair()
    try:
        for node in (pair.j, pair.t):
            node.create_index("logs", {"settings": {
                "number_of_shards": 2, "refresh_interval": "-1"}})
            for i in range(10):
                node.index_doc("logs", str(i), {"host": f"h{i % 3}", "n": i})
            node.indices["logs"].refresh()
        body = {"size": 0, "aggs": {"h": {"terms": {"field": "host.keyword"}}}}
        pair.same("POST", "/logs/_search", body)
        pair.same("POST", "/logs/_search", body)
        assert cache_stats(pair.j)["entries"] == \
            cache_stats(pair.t)["entries"] == 1
        cleared = pair.same("POST", "/logs/_cache/clear", status=200)
        assert cleared == {"_shards": {"total": 0, "successful": 0,
                                       "failed": 0}}
        pair.same("POST", "/_cache/clear", status=200)
        # C20: the JAX package keeps its entry, the port's cache is empty
        assert cache_stats(pair.j)["entries"] == 1
        assert cache_stats(pair.t)["entries"] == 0
        # the staged doc-value columns went, as in the JAX package
        for node in (pair.j, pair.t):
            assert all(not seg.dev_cache
                       for sh in node.indices["logs"].shards.values()
                       for seg in sh.engine.segments)
        # the answer after a clear is the same
        pair.same("POST", "/logs/_search", body)
    finally:
        pair.close()


def test_cacheable_policy_is_the_jax_one():
    from elasticsearch_tpu.index.request_cache import cacheable as jc

    for body in ({"size": 0}, {}, {"size": "0"}, {"size": 0, "profile": True},
                 {"size": 0, "scroll": "1m"}, {"size": 0, "search_after": [1]},
                 {"size": "x"}, {"size": 10}):
        assert cacheable(body) == jc(body), body
    assert RequestCache.key_for({"a": object()}, []) is None
    assert RequestCache.key_for({"a": 1}, [1]) == JCache.key_for({"a": 1}, [1])
