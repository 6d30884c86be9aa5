"""The scheduled refresh and ``refresh=wait_for``: the port against the
JAX package (ROADMAP C18).

- C18: at the default ``index.refresh_interval`` (1 s), a document indexed
  without a refresh becomes visible to a search within 2.5 s in both
  packages; the port once never refreshed on its own.
- The engine's refresh listeners fire as the JAX engine's do: at once when
  nothing is pending, else at the refresh that makes the buffered docs or
  the buffered deletes against sealed segments visible.
- ``refresh=wait_for`` on index, create, update, delete and bulk, over
  REST, at ``1s`` and at ``-1`` (where it forces a refresh): each write is
  visible to the next search, and the statuses and bodies equal the JAX
  package's.
- A dynamic ``index.refresh_interval`` restarts the port's timer; closing
  or deleting the index joins its thread; a failed scheduled refresh is
  logged and the timer goes on.

Every node of either package is closed by its test.
"""

import json
import logging
import threading
import time

import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from torch_pair import NodePair

MAPPING = {"properties": {"msg": {"type": "text"}, "k": {"type": "keyword"}}}


@pytest.fixture()
def pair():
    p = NodePair()
    yield p
    p.close()


def _hits(node, index, query):
    return node.search(index, {"query": query})["hits"]["total"]


class TestScheduledRefresh:
    def test_c18_default_interval_makes_a_write_visible(self, pair):
        """Default settings, no explicit refresh: both packages find the
        doc within 2.5 s."""
        for node in (pair.j, pair.t):
            node.create_index("c18", {"mappings": MAPPING})
            node.index_doc("c18", "1", {"msg": "hello world", "k": "a"})
        assert pair.t.indices["c18"].refresh_interval == 1.0
        found = {}
        deadline = time.monotonic() + 2.5
        while time.monotonic() < deadline and len(found) < 2:
            for name, node in (("jax", pair.j), ("port", pair.t)):
                if name not in found and _hits(
                        node, "c18", {"match": {"msg": "hello"}}) == 1:
                    found[name] = True
            time.sleep(0.05)
        assert found == {"jax": True, "port": True}

    def test_minus_one_turns_it_off(self, pair):
        for node in (pair.j, pair.t):
            node.create_index("off", {"settings": {"refresh_interval": "-1"},
                                      "mappings": MAPPING})
            node.index_doc("off", "1", {"msg": "hello"})
        assert pair.t.indices["off"]._refresh_thread is None
        time.sleep(1.2)
        assert [_hits(n, "off", {"match_all": {}})
                for n in (pair.j, pair.t)] == [0, 0]

    def test_dynamic_interval_restarts_the_timer(self):
        node = Node(device="cpu")
        try:
            node.create_index("dyn", {"settings": {"refresh_interval": "-1",
                                                   "number_of_shards": 2},
                                      "mappings": MAPPING})
            svc = node.indices["dyn"]
            assert svc._refresh_thread is None
            node.update_index_settings("dyn", {"index": {
                "refresh_interval": "100ms"}})
            assert svc.refresh_interval == 0.1
            first = svc._refresh_thread
            assert first is not None and first.is_alive()
            node.index_doc("dyn", "1", {"msg": "late"})
            deadline = time.monotonic() + 2.0
            while (_hits(node, "dyn", {"match": {"msg": "late"}}) != 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert _hits(node, "dyn", {"match": {"msg": "late"}}) == 1
            node.update_index_settings("dyn", {"index": {
                "refresh_interval": "1s"}})
            assert not first.is_alive()
            assert svc._refresh_thread is not first
            node.update_index_settings("dyn", {"index": {
                "refresh_interval": "-1"}})
            assert svc._refresh_thread is None
        finally:
            node.close()

    def test_close_and_delete_join_the_thread(self):
        node = Node(device="cpu")
        try:
            for name in ("a", "b"):
                node.create_index(name, {"mappings": MAPPING})
            ta = node.indices["a"]._refresh_thread
            tb = node.indices["b"]._refresh_thread
            assert ta.is_alive() and tb.is_alive()
            node.delete_index("a")
            assert not ta.is_alive()
        finally:
            node.close()
        assert not tb.is_alive()

    def test_failed_refresh_is_logged_and_the_timer_goes_on(self, caplog):
        svc = IndexService("flaky", Settings({
            "index.number_of_shards": 1, "index.refresh_interval": "50ms"}),
            MAPPING, device="cpu")
        try:
            shard = svc.shards[0]
            real = shard.refresh
            calls = []

            def flaky():
                calls.append(1)
                if len(calls) == 1:
                    raise RuntimeError("injected refresh fault")
                return real()

            shard.refresh = flaky
            svc.index_doc("1", {"msg": "x"})
            with caplog.at_level(logging.WARNING,
                                 "elasticsearch_tpu_torch.index.refresh"):
                deadline = time.monotonic() + 2.0
                while (svc.search({"query": {"match_all": {}}})["hits"][
                        "total"] != 1 and time.monotonic() < deadline):
                    time.sleep(0.02)
            assert svc.search({"query": {"match_all": {}}})["hits"][
                "total"] == 1
            assert any("scheduled refresh failed" in r.getMessage()
                       for r in caplog.records)
        finally:
            svc.close()
        assert not svc._refresh_thread


class TestRefreshListeners:
    @pytest.mark.parametrize("case", ["idle", "buffered", "sealed_delete",
                                      "buffered_delete"])
    def test_listener_fires_like_jax(self, case):
        settings = {"index.number_of_shards": 1, "index.refresh_interval": -1}
        jidx = JIndex("lj", JSettings(settings), mapping=MAPPING)
        tidx = IndexService("lt", Settings(settings), MAPPING, device="cpu")
        fired = []
        try:
            for svc in (jidx, tidx):
                engine = svc.shards[0].engine
                got = []
                if case in ("sealed_delete", "buffered_delete"):
                    svc.index_doc("1", {"msg": "a"})
                    if case == "sealed_delete":
                        engine.refresh()
                if case == "buffered":
                    svc.index_doc("2", {"msg": "b"})
                if case in ("sealed_delete", "buffered_delete"):
                    svc.delete_doc("1")
                engine.add_refresh_listener(lambda g=got: g.append("fired"))
                before = list(got)
                engine.refresh()
                fired.append((before, list(got)))
        finally:
            jidx.close()
            tidx.close()
        assert fired[0] == fired[1]
        if case == "idle":
            assert fired[1] == (["fired"], ["fired"])
        else:
            assert fired[1] == ([], ["fired"])


WRITES = {
    "index": ("PUT", "/w/_doc/9", {"msg": "fresh", "k": "z"}),
    "create": ("PUT", "/w/_create/9", {"msg": "fresh", "k": "z"}),
    "update": ("POST", "/w/_update/1", {"doc": {"msg": "fresh"}}),
    "delete": ("DELETE", "/w/_doc/1", None),
    "bulk": ("POST", "/_bulk", (json.dumps({"index": {"_index": "w",
                                                      "_id": "9"}})
                                + "\n" + json.dumps({"msg": "fresh"})
                                + "\n").encode()),
}


@pytest.mark.parametrize("interval", ["1s", "-1"])
@pytest.mark.parametrize("op", sorted(WRITES))
def test_wait_for_makes_the_write_visible(pair, op, interval):
    pair.same("PUT", "/w", {"settings": {"number_of_shards": 2,
                                         "refresh_interval": interval},
                            "mappings": MAPPING})
    pair.same("PUT", "/w/_doc/1", {"msg": "old", "k": "a"},
              params={"refresh": "true"})
    method, path, body = WRITES[op]
    t0 = time.monotonic()
    pair.same(method, path, body, params={"refresh": "wait_for"})
    waited = time.monotonic() - t0
    r = pair.same("POST", "/w/_search", {"query": {"match_all": {}},
                                         "sort": [{"_id": "asc"}]})
    want = {"delete": 0, "update": 1}.get(op, 2)
    assert r["hits"]["total"] == want
    if op == "update":
        assert r["hits"]["hits"][0]["_source"]["msg"] == "fresh"
    # two nodes, each waiting at most twice its interval and a half
    assert waited < (2 * (2 * 1.0 + 0.5) if interval == "1s" else 2.0)


def test_wait_for_from_threads(pair):
    """Concurrent wait_for writes on the port each return once visible."""
    node = pair.t
    node.create_index("wt", {"settings": {"number_of_shards": 3,
                                          "refresh_interval": "200ms"},
                             "mappings": MAPPING})
    errors = []

    def write(i):
        try:
            node.index_doc("wt", str(i), {"msg": f"m{i}"},
                           refresh="wait_for")
            if node.get_doc("wt", str(i))["found"] is not True:
                errors.append(i)
            if _hits(node, "wt", {"ids": {"values": [str(i)]}}) != 1:
                errors.append(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert not errors
    assert _hits(node, "wt", {"match_all": {}}) == 8
