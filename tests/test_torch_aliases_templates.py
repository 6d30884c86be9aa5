"""Aliases, index templates and open/close: the port against the JAX
package.

Every request goes to a JAX ``Node`` and a port ``Node(device="cpu")``
through their REST controllers (``torch_pair.NodePair``); statuses and
bodies must be equal after dropping ``took``, ``_plane``, uuids and
creation dates, scores within rtol 1e-5. The documents come from a seeded
numpy generator. Mirrors ``tests/test_rest.py``'s ``test_aliases_actions``,
``test_templates`` and ``test_open_close``, and pins ROADMAP C19: an
alias's ``filter`` and ``search_routing`` are stored and shown, and a
search through the alias ignores both in both packages.
"""

import json

import numpy as np
import pytest

from torch_pair import NodePair

WORDS = ["alpha", "beta", "gamma", "delta", "omega"]
MAPPING = {"properties": {"msg": {"type": "text"}, "k": {"type": "keyword"},
                          "n": {"type": "long"}}}


def seeded_docs(seed, n):
    rng = np.random.default_rng(seed)
    return [{"msg": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 5)))),
             "k": str(rng.choice(["a", "b", "c"])),
             "n": int(rng.integers(0, 100))} for _ in range(n)]


@pytest.fixture()
def pair():
    p = NodePair()
    yield p
    p.close()


def fill(pair, index, docs, start=0):
    lines = []
    for i, d in enumerate(docs):
        lines.append({"index": {"_index": index, "_id": str(start + i)}})
        lines.append(d)
    body = "".join(json.dumps(x) + "\n" for x in lines).encode()
    pair.same("POST", "/_bulk", body, params={"refresh": "true"})


def make_index(pair, name, shards=2, extra=None):
    body = {"settings": {"number_of_shards": shards,
                         "refresh_interval": "-1"},
            "mappings": MAPPING}
    body.update(extra or {})
    pair.same("PUT", f"/{name}", body)


SEARCHES = [
    {"query": {"match": {"msg": "alpha gamma"}}, "size": 5},
    {"query": {"match_all": {}}, "size": 0,
     "aggs": {"k": {"terms": {"field": "k"}}}},
    {"query": {"range": {"n": {"gte": 30}}}, "sort": [{"n": "asc"}],
     "size": 4},
]


class TestAliases:
    def test_aliases_actions(self, pair):
        make_index(pair, "idx1")
        make_index(pair, "idx2")
        pair.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "idx1", "alias": "both"}},
            {"add": {"index": "idx2", "alias": "both"}}]})
        r = pair.same("GET", "/_alias/both")
        assert set(r) == {"idx1", "idx2"}
        pair.same("POST", "/_aliases", {"actions": [
            {"remove": {"index": "idx1", "alias": "both"}}]})
        assert set(pair.same("GET", "/_alias/both")) == {"idx2"}

    @pytest.mark.parametrize("path", [
        "/_alias", "/_alias/a1", "/_alias/a*", "/idx1/_alias",
        "/idx1/_alias/a2", "/_alias/a1,nope", "/_alias/nope", "/i*/_alias"])
    def test_get_alias_forms(self, pair, path):
        make_index(pair, "idx1")
        make_index(pair, "idx2")
        pair.same("PUT", "/idx1/_alias/a1")
        pair.same("PUT", "/idx2/_alias/a1", {"routing": "1"})
        pair.same("PUT", "/idx1/_alias/a2", {"filter": {"term": {"k": "a"}},
                                             "search_routing": "2"})
        pair.same("GET", path)

    @pytest.mark.parametrize("path,found", [
        ("/_alias/a1", 200), ("/idx2/_alias/a1", 404), ("/_alias/zz", 404),
        ("/idx1/_alias/a1", 200)])
    def test_head_alias(self, pair, path, found):
        make_index(pair, "idx1")
        make_index(pair, "idx2")
        pair.same("PUT", "/idx1/_alias/a1")
        pair.same("HEAD", path, status=found)

    def test_delete_alias_and_cat(self, pair):
        make_index(pair, "idx1")
        make_index(pair, "idx2")
        pair.same("POST", "/_aliases", {"actions": [
            {"add": {"indices": ["idx1", "idx2"], "aliases": ["x", "y"]}},
            {"add": {"index": "idx2", "alias": "z", "routing": "3",
                     "filter": {"term": {"k": "b"}}}}]})
        pair.same("GET", "/_cat/aliases", params={"v": "true", "s": "alias"})
        pair.same("GET", "/_cat/aliases", params={"format": "json"})
        pair.same("DELETE", "/idx1/_alias/x")
        pair.same("GET", "/_alias")
        pair.same("POST", "/_aliases", {"actions": [{"bogus": {
            "index": "idx1", "alias": "q"}}]}, status=400)

    def test_create_with_aliases_and_name_clash(self, pair):
        make_index(pair, "idx1", extra={"aliases": {"al": {}, "al2": {
            "filter": {"term": {"k": "a"}}}}})
        pair.same("GET", "/idx1")
        pair.same("PUT", "/al", status=400)
        pair.same("GET", "/al/_settings")

    @pytest.mark.parametrize("seed", [0, 1])
    def test_search_through_alias(self, pair, seed):
        make_index(pair, "logs-a")
        make_index(pair, "logs-b", shards=3)
        fill(pair, "logs-a", seeded_docs(seed, 30))
        fill(pair, "logs-b", seeded_docs(seed + 100, 25), start=100)
        pair.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-*", "alias": "logs"}},
            {"add": {"index": "logs-a", "alias": "one"}}]})
        for expr in ("logs", "one", "logs-*", "logs-a,logs-b", "one,logs-b"):
            for body in SEARCHES:
                pair.same("POST", f"/{expr}/_search", body)
            pair.same("GET", f"/{expr}/_count")
        # a write through a one-index alias lands in its index
        pair.same("PUT", "/one/_doc/w1", {"msg": "omega", "k": "c", "n": 1},
                  params={"refresh": "true"})
        pair.same("GET", "/logs-a/_doc/w1")

    def test_filtered_routed_alias_is_not_applied(self, pair):
        """ROADMAP C19: 6 docs on 2 shards, an alias whose filter matches
        3 of them and whose search_routing names one shard: both packages
        answer all 6 through the alias, as through the index."""
        make_index(pair, "c19")
        fill(pair, "c19", [{"msg": "alpha", "k": "a" if i < 3 else "b",
                            "n": i} for i in range(6)])
        pair.same("POST", "/_aliases", {"actions": [{"add": {
            "index": "c19", "alias": "fa", "filter": {"term": {"k": "a"}},
            "search_routing": "1"}}]})
        r = pair.same("POST", "/fa/_search", {"query": {"match_all": {}}})
        assert r["hits"]["total"] == 6
        r = pair.same("POST", "/c19/_search", {"query": {"match_all": {}}})
        assert r["hits"]["total"] == 6

    def test_delete_index_alias_rules(self, pair):
        make_index(pair, "d1")
        make_index(pair, "d2")
        pair.same("PUT", "/d1/_alias/da")
        pair.same("DELETE", "/da", status=400)
        pair.same("DELETE", "/da", params={"ignore_unavailable": "true"})
        pair.same("DELETE", "/d*")
        pair.same("GET", "/_alias")
        pair.same("GET", "/_cat/indices", params={"format": "json"})


class TestTemplates:
    def test_templates(self, pair):
        pair.same("PUT", "/_template/logs", {
            "index_patterns": ["logs-*"],
            "settings": {"index": {"number_of_shards": 2}},
            "mappings": {"properties": {"@timestamp": {"type": "date"}}}})
        pair.same("PUT", "/logs-2017.01/_doc/1",
                  {"@timestamp": "2017-01-01", "msg": "x"})
        r = pair.same("GET", "/logs-2017.01")
        assert r["logs-2017.01"]["settings"]["index"]["number_of_shards"] == 2
        pair.same("HEAD", "/_template/logs", status=200)
        pair.same("DELETE", "/_template/logs")
        pair.same("HEAD", "/_template/logs", status=404)
        pair.same("DELETE", "/_template/logs", status=404)

    def test_order_aliases_and_body_precedence(self, pair):
        pair.same("PUT", "/_template/base", {
            "index_patterns": "app-*", "order": 0,
            "settings": {"number_of_shards": 4, "refresh_interval": "-1",
                         "number_of_replicas": 0},
            "mappings": {"_doc": {"properties": {"a": {"type": "keyword"}}}},
            "aliases": {"app": {}, "app-r": {"routing": "1"}}})
        pair.same("PUT", "/_template/over", {
            "index_patterns": ["app-x*"], "order": 5, "version": 3,
            "settings": {"number_of_shards": 2},
            "mappings": {"properties": {"b": {"type": "long"}}}})
        pair.same("PUT", "/app-x1", {"settings": {"number_of_replicas": 1}})
        pair.same("PUT", "/app-y1")
        pair.same("GET", "/app-x1")
        pair.same("GET", "/app-y1/_settings", params={"flat_settings": "true"})
        pair.same("GET", "/_template")
        pair.same("GET", "/_template/o*", params={"flat_settings": "true"})
        pair.same("GET", "/_template/zz", status=404)
        pair.same("GET", "/_cat/templates", params={"v": "true", "s": "name"})
        pair.same("GET", "/_cat/templates/ba*", params={"format": "json"})
        pair.same("PUT", "/_template/base", {"index_patterns": ["q"]},
                  params={"create": "true"}, status=400)
        pair.same("GET", "/_alias/app")
        fill(pair, "app-x1", seeded_docs(3, 12))
        pair.same("POST", "/app/_search", SEARCHES[0])


class TestOpenClose:
    def test_open_close(self, pair):
        pair.same("PUT", "/idx/_doc/1", {"a": 1})
        pair.same("POST", "/idx/_close")
        pair.same("POST", "/idx/_search", {}, status=400)
        pair.same("GET", "/_cat/indices", params={"h": "index,status",
                                                  "format": "json"})
        pair.same("GET", "/_cluster/health")
        pair.same("POST", "/idx/_open")
        pair.same("POST", "/idx/_refresh")
        r = pair.same("POST", "/idx/_search", {})
        assert r["hits"]["total"] == 1

    def test_wildcard_skips_closed(self, pair):
        make_index(pair, "logs-a")
        make_index(pair, "logs-b")
        fill(pair, "logs-a", seeded_docs(5, 10))
        fill(pair, "logs-b", seeded_docs(6, 10), start=50)
        pair.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-b", "alias": "lb"}}]})
        before = pair.same("POST", "/logs-*/_search", SEARCHES[0])
        pair.same("POST", "/logs-b/_close")
        r = pair.same("POST", "/logs-*/_search", SEARCHES[0])
        assert r["_shards"]["total"] == 2
        pair.same("POST", "/logs-b/_search", SEARCHES[0], status=400)
        pair.same("POST", "/lb/_search", SEARCHES[0], status=400)
        pair.same("PUT", "/logs-b/_doc/9", {"msg": "x"}, status=400)
        pair.same("POST", "/logs-b/_open")
        after = pair.same("POST", "/logs-*/_search", SEARCHES[0])
        assert after["hits"] == before["hits"]
