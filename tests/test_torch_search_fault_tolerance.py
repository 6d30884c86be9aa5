"""Per-shard failure isolation, partial results and timeouts on the port,
against the JAX package.

Mirrors tests/test_search_fault_tolerance.py's ``TestShardFailureIsolation``,
``TestSearchViaNodeAndRest`` (without the task cases) and ``TestTimeout``:
each case builds the same index in a JAX ``IndexService`` or ``Node`` (tile
kernel in interpret mode, ``ES_TPU_PALLAS=interpret``) and in a port one
(``device="cpu"``), installs the same shard-search scheme in both packages'
registries (``SearchFailScheme``, ``SearchDelayScheme``), sends both the
same request and holds the port's answer to the JAX one: every key but
``took`` equal, scores within rtol 1e-5; an error must be the same class
name with the same reason and failed shards. The JAX tests' expectations are
checked on the port's answer too. Also ROADMAP C14's two inputs: a shard
whose query phase raises, and a slice count over the index's limit. Every
case closes what it opens.
"""

import time

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    QueryPhaseExecutionException as JQueryPhaseExecution,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.rest.controller import RestController as JRest
from elasticsearch_tpu.testing import disruption as jdis
from elasticsearch_tpu_torch.common.errors import (
    QueryPhaseExecutionException,
    SearchPhaseExecutionException,
)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.testing import disruption as tdis

RTOL = 1e-5

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
}}


@pytest.fixture(autouse=True)
def _interpret_and_clean(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    yield
    jdis.clear_search_disruptions()
    tdis.clear_search_disruptions()


def same(a, b, where="resp"):
    """Equal but ``took``; floats within RTOL."""
    if isinstance(a, dict):
        keys = set(a) - {"took"}
        assert keys == set(b) - {"took"}, (where, sorted(a), sorted(b))
        for k in keys:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=where)
    else:
        assert a == b, (where, a, b)


def both_raise(jcall, tcall):
    """Both calls raise: the same class name, reason and failed shards."""
    with pytest.raises(Exception) as je:
        jcall()
    with pytest.raises(Exception) as te:
        tcall()
    assert type(te.value).__name__ == type(je.value).__name__
    jd, td = je.value.to_dict(), te.value.to_dict()
    same(jd, td, "error")
    return te.value


class Pair:
    """``make_index`` of the JAX test in both packages: 30 docs over
    ``shards`` shards, the mesh plane off."""

    def __init__(self, name="ftol", shards=3, extra=None):
        settings = {"index.number_of_shards": shards,
                    "index.search.mesh": False,
                    "index.refresh_interval": -1}
        settings.update(extra or {})
        self.j = JIndex(name, JSettings({
            **settings, "index.requests.cache.enable": False}),
            mapping=MAPPING)
        self.t = IndexService(name, Settings(settings), mapping=MAPPING,
                              device="cpu")
        for d in range(30):
            for svc in (self.j, self.t):
                svc.index_doc(str(d), {"body": f"w{d % 5} w1", "n": d})
        self.j.refresh()
        self.t.refresh()

    def install(self, scheme, *args, **kw):
        """The same scheme in both packages; returns the port's."""
        getattr(jdis, scheme)(*args, **kw).install()
        return getattr(tdis, scheme)(*args, **kw).install()

    def search(self, body):
        jr, tr = self.j.search(dict(body)), self.t.search(dict(body))
        same(jr, tr)
        return tr

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture()
def idx():
    p = Pair()
    yield p
    p.close()


class TestShardFailureIsolation:
    def test_one_failed_shard_degrades_to_partial(self, idx):
        body = {"query": {"match": {"body": "w1"}}, "size": 30}
        baseline = idx.search(body)
        assert baseline["_shards"]["failed"] == 0
        fail = idx.install("SearchFailScheme", indices=["ftol"], shards=[1])
        r = idx.search(body)
        assert fail.hits == 1
        assert r["_shards"]["failed"] == 1
        assert r["_shards"]["successful"] == 2
        entry = r["_shards"]["failures"][0]
        assert entry["shard"] == 1 and entry["index"] == "ftol"
        assert "injected" in entry["reason"]["reason"]
        assert entry["reason"]["type"] == "runtime_error"
        assert 0 < r["hits"]["total"] < baseline["hits"]["total"]
        shard1_ids = {str(d) for d in range(30)
                      if idx.t._route(str(d)) == 1}
        got_ids = {h["_id"] for h in r["hits"]["hits"]}
        assert not got_ids & shard1_ids
        assert got_ids == {h["_id"] for h in baseline["hits"]["hits"]
                           if h["_id"] not in shard1_ids}

    def test_typed_failure_reason(self, idx):
        jdis.SearchFailScheme(JQueryPhaseExecution("shard blew up"),
                              indices=["ftol"], shards=[0]).install()
        tdis.SearchFailScheme(QueryPhaseExecutionException("shard blew up"),
                              indices=["ftol"], shards=[0]).install()
        r = idx.search({"query": {"match_all": {}}})
        reason = r["_shards"]["failures"][0]["reason"]
        assert reason["type"] == "query_phase_execution_exception"
        assert reason["reason"] == "shard blew up"

    def test_allow_partial_false_raises(self, idx):
        idx.install("SearchFailScheme", indices=["ftol"], shards=[1])
        body = {"query": {"match_all": {}},
                "allow_partial_search_results": False}
        err = both_raise(lambda: idx.j.search(dict(body)),
                         lambda: idx.t.search(dict(body)))
        assert isinstance(err, SearchPhaseExecutionException)
        failed = err.to_dict()["error"]["failed_shards"]
        assert [f["shard"] for f in failed] == [1]

    def test_all_shards_failed_raises(self, idx):
        idx.install("SearchFailScheme", indices=["ftol"])
        body = {"query": {"match_all": {}}}
        err = both_raise(lambda: idx.j.search(dict(body)),
                         lambda: idx.t.search(dict(body)))
        assert isinstance(err, SearchPhaseExecutionException)
        assert "all shards failed" in err.reason
        assert len(err.shard_failures) == 3

    def test_failed_response_not_cached(self, idx):
        # a size 0 body (request-cache eligible in the JAX package): the
        # partial answer is not served again once the fault is gone
        body = {"query": {"match": {"body": "w1"}}, "size": 0}
        fail = idx.install("SearchFailScheme", indices=["ftol"], shards=[1])
        r1 = idx.search(body)
        assert r1["_shards"]["failed"] == 1
        fail.remove()
        jdis.clear_search_disruptions()
        r2 = idx.search(body)
        assert r2["_shards"]["failed"] == 0
        assert r2["hits"]["total"] == 30


class TestSearchViaNodeAndRest:
    @pytest.fixture()
    def nodes(self):
        jn = JNode(JSettings({"node.name": "ft-node"}))
        tn = Node(Settings({"node.name": "ft-node"}), device="cpu")
        for n in (jn, tn):
            n.create_index("ftr", {
                "settings": {"index": {"number_of_shards": 3,
                                       "search": {"mesh": False},
                                       "refresh_interval": -1}},
                "mappings": MAPPING,
            })
            for d in range(30):
                n.index_doc("ftr", str(d), {"body": f"w{d % 5} w1", "n": d})
            n.indices["ftr"].refresh()
        yield jn, tn
        jn.close()
        tn.close()

    def test_rest_partial_is_200_with_failed_shards(self, nodes):
        jn, tn = nodes
        jdis.SearchFailScheme(indices=["ftr"], shards=[2]).install()
        tdis.SearchFailScheme(indices=["ftr"], shards=[2]).install()
        args = ("GET", "/ftr/_search", {}, b'{"query": {"match_all": {}}}')
        js, jp = JRest(jn).dispatch(*args)
        ts, tp = RestController(tn).dispatch(*args)
        assert ts == js == 200
        same(jp, tp)
        assert tp["_shards"]["failed"] == 1
        assert tp["_shards"]["failures"][0]["shard"] == 2

    def test_rest_allow_partial_false_param(self, nodes):
        jn, tn = nodes
        jdis.SearchFailScheme(indices=["ftr"], shards=[2]).install()
        tdis.SearchFailScheme(indices=["ftr"], shards=[2]).install()
        args = ("GET", "/ftr/_search",
                {"allow_partial_search_results": "false"},
                b'{"query": {"match_all": {}}}')
        js, jp = JRest(jn).dispatch(*args)
        ts, tp = RestController(tn).dispatch(*args)
        assert ts == js == 500
        same(jp, tp)
        assert tp["error"]["type"] == "search_phase_execution_exception"

    def test_default_allow_partial_setting(self):
        settings = {"search.default_allow_partial_results": False}
        jn, tn = JNode(JSettings(settings)), Node(Settings(settings),
                                                  device="cpu")
        try:
            for n in (jn, tn):
                n.create_index("strict", {
                    "settings": {"index": {"number_of_shards": 2,
                                           "search": {"mesh": False},
                                           "refresh_interval": -1}}})
                n.index_doc("strict", "1", {"body": "x"})
                n.indices["strict"].refresh()
            jdis.SearchFailScheme(indices=["strict"], shards=[0]).install()
            tdis.SearchFailScheme(indices=["strict"], shards=[0]).install()
            body = {"query": {"match_all": {}}}
            err = both_raise(lambda: jn.search("strict", dict(body)),
                             lambda: tn.search("strict", dict(body)))
            assert isinstance(err, SearchPhaseExecutionException)
            assert "Partial shards failure" in err.reason
        finally:
            jn.close()
            tn.close()

    def test_multi_index_fanout_isolates_failures(self, nodes):
        jn, tn = nodes
        for n in (jn, tn):
            n.create_index("ftr2", {
                "settings": {"index": {"number_of_shards": 2,
                                       "search": {"mesh": False},
                                       "refresh_interval": -1}},
                "mappings": MAPPING,
            })
            for d in range(10):
                n.index_doc("ftr2", f"b{d}", {"body": "w1"})
            n.indices["ftr2"].refresh()
        jdis.SearchFailScheme(indices=["ftr2"], shards=[0]).install()
        tdis.SearchFailScheme(indices=["ftr2"], shards=[0]).install()
        body = {"query": {"match": {"body": "w1"}}, "size": 50}
        jr = jn.search("ftr,ftr2", dict(body))
        r = tn.search("ftr,ftr2", dict(body))
        same(jr, r)
        assert r["_shards"]["total"] == 5
        assert r["_shards"]["failed"] == 1
        assert r["_shards"]["failures"][0]["index"] == "ftr2"
        assert sum(h["_index"] == "ftr" for h in r["hits"]["hits"]) == 30


class TestTimeout:
    def test_timeout_returns_partial_with_flag(self, idx):
        # shard 0 completes; the straggler trips the deadline at its first
        # segment checkpoint; shard 2 never runs
        idx.install("SearchDelayScheme", 0.3, indices=["ftol"], shards=[1])
        body = {"query": {"match": {"body": "w1"}}, "size": 30,
                "timeout": "50ms"}
        jr = idx.j.search(dict(body))
        t0 = time.monotonic()
        r = idx.t.search(dict(body))
        took = time.monotonic() - t0
        same(jr, r)
        assert r["timed_out"] is True
        assert r["_shards"]["failed"] == 0
        shard0_ids = {str(d) for d in range(30) if idx.t._route(str(d)) == 0}
        assert {h["_id"] for h in r["hits"]["hits"]} >= shard0_ids
        # one 0.3 s stall, not two
        assert took < 0.9, took

    def test_no_timeout_by_default(self, idx):
        idx.install("SearchDelayScheme", 0.05, indices=["ftol"])
        r = idx.search({"query": {"match": {"body": "w1"}}, "size": 30})
        assert r["timed_out"] is False
        assert r["hits"]["total"] == 30

    def test_timeout_with_partial_disallowed_raises(self, idx):
        idx.install("SearchDelayScheme", 0.2, indices=["ftol"], shards=[0])
        body = {"query": {"match_all": {}}, "timeout": "20ms",
                "allow_partial_search_results": False}
        err = both_raise(lambda: idx.j.search(dict(body)),
                         lambda: idx.t.search(dict(body)))
        assert "timed out" in err.reason

    def test_batch_member_with_an_expired_deadline_is_cut_alone(self, idx):
        from elasticsearch_tpu.search.cancellation import (
            SearchDeadline as JSearchDeadline,
        )
        from elasticsearch_tpu_torch.search.cancellation import (
            SearchDeadline,
        )

        bodies = [{"query": {"match": {"body": f"w{i}"}}, "size": 30}
                  for i in range(4)]
        out = {}
        for pkg, svc, deadline in (("j", idx.j, JSearchDeadline),
                                   ("t", idx.t, SearchDeadline)):
            expired = deadline(1e-9)
            time.sleep(0.001)
            out[pkg] = svc.search_batch([dict(b) for b in bodies],
                                        [None, expired, None, None])
        for jr, tr in zip(out["j"], out["t"]):
            same(jr, tr)
        got = out["t"]
        assert got[1]["timed_out"] is True and got[1]["hits"]["total"] == 0
        for i in (0, 2, 3):
            assert got[i]["timed_out"] is False
            same(idx.t.search(dict(bodies[i])), got[i])

    def test_default_search_timeout_setting(self):
        settings = {"search.default_search_timeout": "30ms"}
        jn, tn = JNode(JSettings(settings)), Node(Settings(settings),
                                                  device="cpu")
        try:
            for n in (jn, tn):
                n.create_index("deft", {
                    "settings": {"index": {"number_of_shards": 2,
                                           "search": {"mesh": False},
                                           "refresh_interval": -1}}})
                for d in range(8):
                    n.index_doc("deft", str(d), {"body": "w1"})
                n.indices["deft"].refresh()
            jdis.SearchDelayScheme(0.15, indices=["deft"]).install()
            tdis.SearchDelayScheme(0.15, indices=["deft"]).install()
            body = {"query": {"match_all": {}}}
            jr = jn.search("deft", dict(body))
            r = tn.search("deft", dict(body))
            same(jr, r)
            assert r["timed_out"] is True
        finally:
            jn.close()
            tn.close()


class TestC14:
    """ROADMAP C14: one failing shard used to fail the whole request on
    the port's host rung."""

    def test_raising_shard_becomes_a_failure_entry(self):
        settings = {"index.number_of_shards": 2, "index.refresh_interval": -1}
        j = JIndex("c14", JSettings({**settings,
                                     "index.requests.cache.enable": False}))
        t = IndexService("c14", Settings(settings), device="cpu")
        try:
            for svc in (j, t):
                for d in range(8):
                    svc.index_doc(str(d), {"t": "hello"})
                svc.refresh()

                def boom(*_a, **_kw):
                    raise RuntimeError("injected device fault")

                svc.shards[1].searcher.query = boom
            body = {"query": {"match": {"t": "hello"}}}
            jr = j._search_uncached(dict(body), skip_mesh=True)
            r = t._search_uncached(dict(body), skip_mesh=True)
            same(jr, r)
            assert r["_shards"]["failed"] == 1
            assert r["_shards"]["failures"][0]["reason"] == {
                "type": "runtime_error", "reason": "injected device fault"}
            assert r["hits"]["total"] == sum(
                t._route(str(d)) == 0 for d in range(8))
        finally:
            j.close()
            t.close()

    def test_slice_over_the_limit_fails_every_shard(self):
        settings = {"index.number_of_shards": 2, "index.refresh_interval": -1,
                    "index.max_slices_per_scroll": 4}
        j = JIndex("c14s", JSettings({**settings,
                                      "index.requests.cache.enable": False}))
        t = IndexService("c14s", Settings(settings), device="cpu")
        try:
            for svc in (j, t):
                for d in range(8):
                    svc.index_doc(str(d), {"t": "hello"})
                svc.refresh()
            body = {"query": {"match_all": {}},
                    "slice": {"id": 0, "max": 5}}
            err = both_raise(
                lambda: j._search_uncached(dict(body), skip_mesh=True),
                lambda: t._search_uncached(dict(body), skip_mesh=True))
            assert isinstance(err, SearchPhaseExecutionException)
            assert err.reason == "all shards failed"
            assert [f["shard"] for f in err.shard_failures] == [0, 1]
            assert all("too large" in f["reason"]["reason"]
                       for f in err.shard_failures)
        finally:
            j.close()
            t.close()
