"""Search admission control and the drain of the port against the JAX
package.

Mirrors ``tests/test_admission.py``, the drain half of
``tests/test_rollout.py`` (``TestAdmissionDrain``,
``TestNodeDrainAndWarmRestart``) and the drain case of
``tests/test_delta_staging.py::TestCompaction``. Each scenario runs on a
JAX ``IndexService`` and on a port one over the same documents, and the
outcomes (admission order, counters, statuses and error bodies, the
brownout's markers, the answers) must agree exactly, scores within rtol
1e-5.

Queueing is made deterministic instead of raced: a ``Gate`` scheme holds
the one admitted search in its shard's query phase, each later arrival
is started only after the previous one is seen queued, then the gate
opens. Threaded cases wait on events and barriers and join with a time
limit.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from elasticsearch_tpu.common import errors as jerr
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.rest import controller as jctl
from elasticsearch_tpu.search import telemetry as jtel
from elasticsearch_tpu.testing import disruption as jdis
from elasticsearch_tpu_torch.common import errors as terr
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest import controller as tctl
from elasticsearch_tpu_torch.search import telemetry as ttel
from elasticsearch_tpu_torch.testing import disruption as tdis
from torch_pair import NodePair

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
}}
QUERY = {"query": {"match": {"body": "common"}}, "size": 5}
JOIN_S = 60.0

PKGS = {
    "jax": SimpleNamespace(
        name="jax", dis=jdis, tel=jtel, err=jerr, ctl=jctl, Node=JNode,
        index=lambda name, s, path=None: JIndex(
            name, JSettings(s), mapping=MAPPING, data_path=path),
        node=lambda s=None, path=None: JNode(JSettings(s or {}),
                                             data_path=path)),
    "port": SimpleNamespace(
        name="port", dis=tdis, tel=ttel, err=terr, ctl=tctl, Node=Node,
        index=lambda name, s, path=None: IndexService(
            name, Settings(s), mapping=MAPPING, device="cpu",
            data_path=path),
        node=lambda s=None, path=None: Node(Settings(s or {}),
                                            data_path=path, device="cpu")),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    yield
    for pkg in PKGS.values():
        pkg.dis.clear_search_disruptions()
        pkg.tel.set_opaque_id(None)


def build(pkg, name="adm", shards=2, **extra):
    """The host rung (mesh off): the gate holds a search in its shard's
    query phase, where admission has already admitted it."""
    settings = {"index.number_of_shards": shards,
                "index.search.mesh": False,
                "index.refresh_interval": -1, **extra}
    idx = pkg.index(name, settings)
    for d in range(12):
        idx.index_doc(str(d), {"body": f"w{d % 3} common", "n": d})
    idx.refresh()
    idx.search(dict(QUERY))
    return idx


def both(fn):
    """fn(pkg) on each package; (jax result, port result)."""
    return fn(PKGS["jax"]), fn(PKGS["port"])


def until(pred, what="condition"):
    """Wait for shared state another thread moves (event waits, bounded:
    no bare sleep)."""
    tick = threading.Event()
    deadline = time.monotonic() + JOIN_S
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        tick.wait(0.002)


def join_all(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


class Held:
    """One search held in its first shard query by a gate, so the one
    admission slot (``max_concurrent: 1``) stays taken; ``arrive`` queues
    a tenant's search behind it, ``open`` releases the gate and joins
    every thread."""

    def __init__(self, pkg, idx, index="adm"):
        self.pkg, self.idx = pkg, idx
        self.entered, self.release = threading.Event(), threading.Event()
        self.threads, self.out = [], []
        held = self

        class Gate(pkg.dis.ShardSearchScheme):
            def on_search(self, index, shard_id):
                self.hits += 1
                if self.hits == 1:
                    held.entered.set()
                    assert held.release.wait(JOIN_S)

        self.gate = Gate(indices=[index]).install()
        self._start("holder", dict(QUERY))
        assert self.entered.wait(JOIN_S)

    def _start(self, tenant, body):
        def run():
            self.pkg.tel.set_opaque_id(tenant)
            try:
                r = self.idx.search(body)
                self.out.append((tenant, "ok", r))
            except self.pkg.err.EsRejectedExecutionException as e:
                self.out.append((tenant, "429", e))
            except Exception as e:  # noqa: BLE001 — asserted by callers
                self.out.append((tenant, type(e).__name__, e))

        t = threading.Thread(target=run)
        self.threads.append(t)
        t.start()
        return t

    def arrive(self, tenant, body=None, expect="queued"):
        """Start one search; wait until it is queued (or has answered,
        for an arrival that is turned away at once)."""
        adm = self.idx.admission
        queued, answered = adm._queued_total, len(self.out)
        t = self._start(tenant, dict(body or QUERY))
        if expect == "queued":
            until(lambda: adm._queued_total > queued, "a queued entry")
        else:
            until(lambda: len(self.out) > answered, "an answer")
        return t

    def open(self):
        self.release.set()
        join_all(self.threads)
        self.gate.remove()
        return self.out


class TestBoundedAdmission:
    def test_queue_full_rejects_429_with_retry_after(self):
        def run(pkg):
            idx = build(pkg, **{"search.admission.max_concurrent": 1,
                                "search.queue.size": 2})
            try:
                held = Held(pkg, idx)
                held.arrive("a")
                held.arrive("a")
                held.arrive("a", expect="answered")
                out = held.open()
                rej = [e for _t, kind, e in out if kind == "429"]
                assert len(rej) == 1 and rej[0].retry_after_s >= 1.0
                return (sorted(kind for _t, kind, _e in out),
                        rej[0].status_code, rej[0].to_dict(),
                        idx.admission.stats_dict()["rejected_total"])
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert t[0] == ["429", "ok", "ok", "ok"]
        err = t[2]["error"]
        assert err["type"] == "es_rejected_execution_exception"
        assert "queue capacity [2]" in err["reason"]

    def test_rest_429_contract_and_retry_after_header(self):
        pair = NodePair()
        try:
            pair.same("PUT", "/ridx/_doc/1", {"body": "hello"},
                      params={"refresh": "true"})
            for pkg in PKGS.values():
                pkg.dis.QueuePressureScheme(occupancy=2000,
                                            block_slots=10_000,
                                            indices=["ridx"]).install()
            q = {"query": {"match": {"body": "hello"}}}
            headers = []
            for ctl, mod in ((pair.jc, jctl), (pair.tc, tctl)):
                st, body = ctl.dispatch("POST", "/ridx/_search", {},
                                        b'{"query": {"match": '
                                        b'{"body": "hello"}}}',
                                        "application/json")
                headers.append(mod.collect_response_headers())
                assert st == 429
                assert body["error"]["type"] == \
                    "es_rejected_execution_exception"
                assert "retry_after_s" not in body["error"]
            assert all(int(h["Retry-After"]) >= 1 for h in headers)
            for pkg in PKGS.values():
                pkg.dis.clear_search_disruptions()
            pair.same("POST", "/ridx/_search", q, status=200)
        finally:
            pair.close()

    def test_msearch_rejects_per_entry_peers_unaffected(self):
        pair = NodePair()
        try:
            for name in ("hot", "cold"):
                pair.same("PUT", f"/{name}/_doc/1", {"body": "hello"},
                          params={"refresh": "true"})
            for pkg in PKGS.values():
                pkg.dis.QueuePressureScheme(occupancy=2000,
                                            block_slots=10_000,
                                            indices=["hot"]).install()
            body = (b'{"index": "hot"}\n'
                    b'{"query": {"match": {"body": "hello"}}}\n'
                    b'{"index": "cold"}\n'
                    b'{"query": {"match": {"body": "hello"}}}\n')
            out = pair.same("POST", "/_msearch", body, status=200)
            assert out["responses"][0]["status"] == 429
            assert out["responses"][1]["hits"]["total"] == 1
        finally:
            pair.close()

    def test_bulk_path_untouched_under_pressure(self):
        pair = NodePair()
        try:
            pair.same("PUT", "/bidx/_doc/1", {"body": "x"})
            for pkg in PKGS.values():
                pkg.dis.QueuePressureScheme(occupancy=2000,
                                            block_slots=10_000,
                                            indices=["bidx"]).install()
            out = pair.same("POST", "/_bulk",
                            b'{"index": {"_index": "bidx", "_id": "2"}}\n'
                            b'{"body": "y"}\n', status=200)
            assert out["errors"] is False
        finally:
            pair.close()


class TestTenantFairness:
    def _log(self, pkg, arrivals, **settings):
        idx = build(pkg, **{"search.admission.max_concurrent": 1,
                            "search.queue.size": 100, **settings})
        try:
            held = Held(pkg, idx)
            for tenant in arrivals:
                held.arrive(tenant)
            out = held.open()
            assert all(kind == "ok" for _t, kind, _e in out)
            return (list(idx.admission.admission_log),
                    idx.admission.stats_dict()["tenants"])
        finally:
            idx.close()

    def test_drr_keeps_light_tenant_interleaved(self):
        arrivals = ["hot"] * 8 + ["light"] * 3
        j, t = both(lambda pkg: self._log(pkg, arrivals))
        assert t == j
        log = t[0][2:]  # the warm-up search and the holder
        # equal weights: the light tenant alternates with the hot flood
        assert log[:6] == ["hot", "light"] * 3

    def test_weighted_tenant_gets_proportional_share(self):
        arrivals = ["vip"] * 9 + ["std"] * 3
        j, t = both(lambda pkg: self._log(
            pkg, arrivals, **{"search.admission.weights": "vip:3"}))
        assert t == j
        log, tenants = t
        assert tenants["vip"]["admitted_total"] == 9
        assert tenants["std"]["admitted_total"] == 3
        assert log[2:10] == ["vip"] * 3 + ["std"] + ["vip"] * 3 + ["std"]


class TestQueueDisplacement:
    def test_hot_tenant_cannot_monopolize_the_queue(self):
        def run(pkg):
            idx = build(pkg, **{"search.admission.max_concurrent": 1,
                                "search.queue.size": 4})
            try:
                held = Held(pkg, idx)
                for _ in range(4):
                    held.arrive("hot")
                held.arrive("hot", expect="answered")   # over its slice
                held.arrive("light", expect="answered")  # displaces one
                out = held.open()
                stats = idx.admission.stats_dict()["tenants"]
                return (sorted((tn, kind) for tn, kind, _e in out),
                        {tn: (b["admitted_total"], b["rejected_total"])
                         for tn, b in stats.items()})
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert ("light", "ok") in t[0]
        assert t[1]["hot"][1] == 2 and t[1]["light"] == (1, 0)


class TestBrownoutLadder:
    AGG_BODY = {"query": {"match": {"body": "common"}}, "size": 3,
                "aggs": {"by": {"terms": {"field": "n"}}},
                "suggest": {"s": {"text": "comon",
                                  "term": {"field": "body"}}}}

    def test_steps_fire_in_order_and_recover_in_reverse(self):
        def run(pkg):
            idx = build(pkg, **{"search.queue.size": 100})
            try:
                levels = []
                for occ in (0, 30, 60, 90, 90, 60, 30, 0):
                    qp = pkg.dis.QueuePressureScheme(
                        occupancy=occ, indices=["adm"]).install()
                    levels.append(idx.admission.refresh_level())
                    qp.remove()
                return levels, idx.admission.stats_dict()[
                    "brownout_transitions"]
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert t[0] == [0, 1, 2, 3, 3, 2, 1, 0]
        assert t[1] == {"enter": {"1": 1, "2": 1, "3": 1},
                        "exit": {"1": 1, "2": 1, "3": 1}}

    def test_sheds_rescore_then_features_marked_and_counted(self):
        def run(pkg):
            idx = build(pkg, **{"search.queue.size": 100})
            try:
                body = dict(self.AGG_BODY)
                body["rescore"] = {"window_size": 5, "query": {
                    "rescore_query": {"match": {"body": "w1"}}}}
                out = []
                for occ in (60, 90):
                    qp = pkg.dis.QueuePressureScheme(
                        occupancy=occ, indices=["adm"]).install()
                    r = idx.search(dict(body))
                    qp.remove()
                    out.append((r["_degraded"], "aggregations" in r,
                                "suggest" in r,
                                [h["_id"] for h in r["hits"]["hits"]]))
                return out, idx.admission.stats_dict()["brownout"]
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        (d2, aggs2, sug2, _), (d3, aggs3, sug3, _) = t[0]
        assert d2 == ["forced_pruned", "rescore"] and aggs2 and sug2
        assert set(d3) >= {"rescore", "aggs", "suggest"}
        assert not aggs3 and not sug3
        assert t[1] == {"forced_pruned_total": 2, "shed_rescore_total": 2,
                        "shed_features_total": 2}

    def test_degraded_answer_never_enters_request_cache(self):
        body = {"size": 0, "query": {"match": {"body": "common"}},
                "aggs": {"by": {"terms": {"field": "n"}}}}

        def run(pkg):
            idx = build(pkg, **{"search.queue.size": 100})
            try:
                oracle = idx.search(dict(body))  # a miss, then cached
                idx.request_cache.clear()
                qp = pkg.dis.QueuePressureScheme(
                    occupancy=90, indices=["adm"]).install()
                degraded = idx.search(dict(body))
                entries_degraded = idx.request_cache.stats()["entries"]
                qp.remove()
                idx.admission.refresh_level()
                healed = idx.search(dict(body))
                again = idx.search(dict(body))  # served by the cache
                rc = idx.request_cache.stats()
                return (degraded["_degraded"], "aggregations" in degraded,
                        entries_degraded, healed.get("_degraded"),
                        healed["aggregations"] == oracle["aggregations"],
                        again["aggregations"] == oracle["aggregations"],
                        rc["entries"], rc["hit_count"])
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert "aggs" in t[0] and t[1] is False
        assert t[2] == 0          # the browned-out answer was not cached
        assert t[3] is None and t[4] and t[5]
        assert t[6] == 1 and t[7] >= 1

    def test_brownout_forces_pruning_on_the_mesh(self):
        def run(pkg):
            idx = build(pkg, shards=3, **{
                "search.queue.size": 100, "index.search.mesh": True,
                "index.search.mesh.max_slots_per_device": 16,
                "index.search.pallas.postings_codec": "packed",
                "search.pallas.pruning.probe_tiles": 2})
            try:
                for d in range(12, 2400):
                    idx.index_doc(str(d), {"body": f"w{d % 7} common x{d}",
                                           "n": d})
                idx.refresh()
                body = {"query": {"match": {"body": "w1 w2"}}, "size": 5}
                plain = idx.search(dict(body))
                enabled0 = idx._mesh_search._pruning_config()[0]
                qp = pkg.dis.QueuePressureScheme(
                    occupancy=30, indices=["adm"]).install()
                idx.admission.refresh_level()
                enabled1 = idx._mesh_search._pruning_config()[0]
                forced = idx.search(dict(body))
                qp.remove()
                idx.admission.refresh_level()
                enabled2 = idx._mesh_search._pruning_config()[0]
                return (enabled0, enabled1, enabled2, plain.get("_pruned"),
                        forced["_plane"], forced["_degraded"],
                        forced.get("_pruned"),
                        [(h["_id"], h["_score"])
                         for h in forced["hits"]["hits"]],
                        [(h["_id"], h["_score"])
                         for h in plain["hits"]["hits"]])
            finally:
                idx.close()

        j, t = both(run)
        assert t[3:7] == j[3:7]
        # JAX reads the live level outside a request too; the port forces
        # pruning only for a request its admission token browned out
        assert j[:3] == (False, True, False) and t[:3] == (False,) * 3
        assert t[3] is None
        assert t[4] == "mesh_pallas" and t[5] == ["forced_pruned"]
        assert t[6]["total_relation"] == "gte"
        for got, want in ((t[7], j[7]), (t[8], j[8])):
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], rtol=1e-5)


    @pytest.mark.parametrize("move", ["drops", "rises"])
    def test_marker_and_pruning_follow_the_admission_token(self, move):
        """The brownout level moves between admission and the launch
        (a scheme at the dispatch's ``on_query_begin`` installs or removes
        the pressure): the port prunes exactly the answer it marked, by
        the request's token; the JAX package reads the live level at the
        launch, so its marker and its pruning disagree."""
        def run(pkg):
            idx = build(pkg, shards=3, **{
                "search.queue.size": 100, "index.search.mesh": True,
                "index.search.mesh.max_slots_per_device": 16,
                "index.search.pallas.postings_codec": "packed",
                "search.pallas.pruning.probe_tiles": 2})
            qp = pkg.dis.QueuePressureScheme(occupancy=30,
                                             indices=["adm"])

            class Flip(pkg.dis.ShardSearchScheme):
                def on_query(self, index):
                    self.hits += 1
                    if move == "drops":
                        qp.remove()
                    else:
                        qp.install()
                    idx.admission.refresh_level()

            try:
                for d in range(12, 2400):
                    idx.index_doc(str(d), {"body": f"w{d % 7} common x{d}",
                                           "n": d})
                idx.refresh()
                body = {"query": {"match": {"body": "w1 w2"}}, "size": 5}
                plain = idx.search(dict(body))
                if move == "drops":
                    qp.install()
                idx.admission.refresh_level()
                flip = Flip(indices=["adm"]).install()
                r = idx.search(dict(body))
                flip.remove()
                qp.remove()
                idx.admission.refresh_level()
                return (r.get("_degraded"), r.get("_pruned") is not None,
                        flip.hits, r["_plane"],
                        [(h["_id"], h["_score"]) for h in r["hits"]["hits"]],
                        [(h["_id"], h["_score"])
                         for h in plain["hits"]["hits"]])
            finally:
                idx.close()

        j, t = both(run)
        marked = move == "drops"
        assert t[2] == j[2] == 1 and t[3] == j[3] == "mesh_pallas"
        assert t[:2] == ((["forced_pruned"] if marked else None), marked)
        assert j[:2] == ((["forced_pruned"] if marked else None),
                         not marked)
        for got in (t[4], j[4]):
            assert [i for i, _ in got] == [i for i, _ in t[5]]
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in t[5]], rtol=1e-5)


class TestAdaptiveBatchWindow:
    def test_window_widens_with_pressure_and_narrows_back(self):
        def run(pkg):
            idx = build(pkg, **{"search.queue.size": 100,
                                "search.batch.window_ms": 0.2})
            try:
                base = idx._batcher.window_s
                out = [idx.admission.effective_batch_window_s(base)]
                for occ in (50, 1000):
                    qp = pkg.dis.QueuePressureScheme(
                        occupancy=occ, indices=["adm"]).install()
                    out.append(idx.admission.effective_batch_window_s(base))
                    out.append(idx._batcher.window_fn())
                    qp.remove()
                out.append(idx.admission.effective_batch_window_s(base))
                return out
            finally:
                idx.close()

        j, t = both(run)
        np.testing.assert_allclose(t, j)
        assert t[0] == pytest.approx(0.0002) == t[-1]
        assert 0.0002 < t[1] < 0.005 and t[1] == t[2]
        assert t[3] == pytest.approx(0.005)


class TestExpiredQueueShedding:
    def test_deadline_expired_entry_shed_before_execution(self):
        def run(pkg):
            idx = build(pkg, shards=1, **{
                "search.admission.max_concurrent": 1,
                "search.queue.size": 10})
            try:
                held = Held(pkg, idx)
                t = held.arrive("late", dict(QUERY, timeout="50ms"))
                t.join(JOIN_S)  # shed on its own deadline, while queued
                shard_runs = held.gate.hits
                out = held.open()
                resp = [r for tn, _k, r in out if tn == "late"][0]
                stats = idx.admission.stats_dict()
                return (resp, shard_runs, stats["expired_in_queue_total"],
                        stats["admitted_total"])
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        resp = dict(t[0])
        resp.pop("took")
        assert resp["timed_out"] is True and resp["hits"]["hits"] == []
        assert resp["_degraded"] == ["expired_in_queue"]
        assert t[1:] == (1, 1, 2)

    def test_expired_shed_honors_allow_partial_false(self):
        def run(pkg):
            idx = build(pkg, **{"search.admission.max_concurrent": 1,
                                "search.queue.size": 10})
            try:
                held = Held(pkg, idx)
                held.arrive("late", dict(
                    QUERY, timeout="50ms",
                    allow_partial_search_results=False)).join(JOIN_S)
                out = held.open()
                return [(tn, kind, e.status_code if kind != "ok" else 200)
                        for tn, kind, e in sorted(out, key=lambda o: o[0])]
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert t[1] == ("late", "SearchPhaseExecutionException", 500)


class TestExactCountersUnderBurst:
    def test_admitted_rejected_expired_partition_offered(self):
        def run(pkg):
            idx = build(pkg, **{"search.admission.max_concurrent": 2,
                                "search.queue.size": 6})
            base = idx.admission.stats_dict()
            slow = pkg.dis.SearchDelayScheme(0.02, indices=["adm"]).install()
            counts = [dict(ok=0, rej=0) for _ in range(6)]
            go = threading.Barrier(6)

            def client(tid):
                pkg.tel.set_opaque_id(f"tenant{tid % 3}")
                go.wait(JOIN_S)
                for i in range(4):
                    body = dict(QUERY)
                    if (tid + i) % 5 == 0:
                        body["timeout"] = "30ms"
                    try:
                        r = idx.search(body)
                        assert not r["_shards"]["failed"]
                        counts[tid]["ok"] += 1
                    except pkg.err.EsRejectedExecutionException:
                        counts[tid]["rej"] += 1

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(6)]
            try:
                for th in threads:
                    th.start()
                join_all(threads)
            finally:
                slow.remove()
            stats = idx.admission.stats_dict()
            idx.close()
            ok = sum(c["ok"] for c in counts)
            rej = sum(c["rej"] for c in counts)
            d = {k: stats[k] - base[k] for k in (
                "admitted_total", "expired_in_queue_total", "rejected_total")}
            tenants = stats["tenants"]
            return (ok + rej,
                    d["admitted_total"] + d["expired_in_queue_total"] == ok,
                    d["rejected_total"] == rej,
                    stats["in_flight"], stats["queued"],
                    sum(b["admitted_total"] for b in tenants.values())
                    == stats["admitted_total"],
                    sum(b["rejected_total"] for b in tenants.values())
                    == stats["rejected_total"])

        j, t = both(run)
        assert t == j == (24, True, True, 0, 0, True, True)


class TestAdmissionConfig:
    def test_dynamic_cluster_override_and_explicit_clear(self):
        def run(pkg):
            node = pkg.node({"cluster.name": "adm-dyn"})
            try:
                node.create_index("dyn", {"settings": {
                    "number_of_shards": 1}})
                adm = node.indices["dyn"].admission
                out = [adm._queue_size()]
                node.put_cluster_settings({"transient": {
                    "search.queue.size": 7,
                    "search.admission.max_concurrent": 3}})
                out += [adm._queue_size(), adm._max_concurrent()]
                node.create_index("dyn2", {"settings": {
                    "number_of_shards": 1}})
                out.append(node.indices["dyn2"].admission._queue_size())
                node.put_cluster_settings({"transient": {
                    "search.queue.size": None,
                    "search.admission.max_concurrent": None}})
                out.append(adm._queue_size())
                return out
            finally:
                node.close()

        j, t = both(run)
        assert t == j == [1000, 7, 3, 7, 1000]

    def test_rest_search_pool_sized_from_queue_setting(self):
        def run(pkg):
            node = pkg.node({"search.queue.size": 123})
            try:
                pool = node.thread_pool.executor("search")
                out = [pool.queue_size]
                node.put_cluster_settings({"transient": {
                    "search.queue.size": 77}})
                out.append(pool.queue_size)
                node.put_cluster_settings({"transient": {
                    "search.queue.size": None}})
                out.append(pool.queue_size)
                return out
            finally:
                node.close()

        j, t = both(run)
        assert t == j == [123, 77, 123]

    def test_disabled_admission_is_inert(self):
        def run(pkg):
            idx = build(pkg, **{"search.admission.enabled": False,
                                "search.admission.max_concurrent": 1,
                                "search.queue.size": 1})
            qp = pkg.dis.QueuePressureScheme(
                occupancy=2000, block_slots=10_000,
                indices=["adm"]).install()
            try:
                r = idx.search(dict(QUERY))
                return ([h["_id"] for h in r["hits"]["hits"]],
                        "_degraded" in r,
                        idx.admission.stats_dict()["rejected_total"])
            finally:
                qp.remove()
                idx.close()

        j, t = both(run)
        assert t == j and t[0] and t[1:] == (False, 0)

    def test_stats_block_shape_and_node_merge(self):
        def run(pkg):
            idx = build(pkg)
            try:
                block = idx.search_stats()["admission"]
                merged = pkg.tel.merge_phase_stats(
                    [idx.search_stats(), idx.search_stats()])
                return (sorted(block), block["admitted_total"],
                        merged["admission"]["admitted_total"],
                        sorted(block["tenants"]))
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert t[1] == 1 and t[2] == 2 and t[3] == ["_anonymous"]


class TestAdmissionDrain:
    def test_drain_rejects_new_and_sheds_queued_with_exact_counters(self):
        def run(pkg):
            idx = build(pkg, "drain1", **{
                "search.admission.max_concurrent": 1,
                "search.queue.size": 8})
            adm = idx.admission
            try:
                hold = adm.acquire(tenant="holder")
                results = []

                def queued():
                    try:
                        adm.release(adm.acquire(tenant="queued"))
                        results.append("admitted")
                    except pkg.err.NodeDrainingException as e:
                        results.append(("draining", e.retry_after_s,
                                        e.status_code))

                t = threading.Thread(target=queued)
                t.start()
                until(lambda: adm._queued_total == 1, "the queued entry")
                base = adm.stats_dict()
                shed = adm.begin_drain()
                join_all([t])
                late = []

                def late_arrival():
                    try:
                        adm.acquire(tenant="late")
                        late.append("admitted")
                    except pkg.err.NodeDrainingException:
                        late.append("draining")

                t2 = threading.Thread(target=late_arrival)
                t2.start()
                join_all([t2])
                stats = adm.stats_dict()
                busy = adm.await_drained(0.05)
                adm.release(hold)
                drained = adm.await_drained(JOIN_S)
                adm.end_drain()
                adm.release(adm.acquire(tenant="resumed"))
                return (shed, results, late, stats["draining"],
                        stats["drain_rejected_total"],
                        stats["rejected_total"] - base["rejected_total"],
                        busy, drained, adm.stats_dict()["draining"])
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert t == (1, [("draining", 30.0, 503)], ["draining"], True, 2,
                     2, False, True, False)

    def test_draining_search_returns_503_with_retry_after(self):
        def run(pkg):
            idx = build(pkg, "drain2")
            try:
                idx.admission.begin_drain()
                with pytest.raises(pkg.err.NodeDrainingException) as ei:
                    idx.search(dict(QUERY))
                err = (ei.value.status_code, ei.value.retry_after_s,
                       ei.value.to_dict())
                idx.admission.end_drain()
                return err, idx.search(dict(QUERY))["hits"]["total"]
            finally:
                idx.close()

        j, t = both(run)
        assert t == j
        assert t[0][0] == 503 and t[0][1] == 30.0 and t[1] == 12
        assert t[0][2]["error"]["type"] == "node_draining_exception"

    def test_drain_rejects_even_with_admission_disabled(self):
        def run(pkg):
            idx = build(pkg, "drain4", **{"search.admission.enabled": False})
            try:
                idx.admission.begin_drain()
                with pytest.raises(pkg.err.NodeDrainingException):
                    idx.search(dict(QUERY))
                return idx.admission.stats_dict()["drain_rejected_total"]
            finally:
                idx.close()

        assert both(run) == (1, 1)

    def test_nested_queries_of_admitted_search_survive_drain(self):
        def run(pkg):
            idx = build(pkg, "drain3")
            adm = idx.admission
            try:
                outer = adm.acquire(tenant="outer")
                adm.begin_drain()
                nested = adm.acquire(tenant="outer")
                noop = nested.noop
                adm.release(nested)
                adm.release(outer)
                return noop, adm.await_drained(JOIN_S)
            finally:
                idx.close()

        assert both(run) == ((True, True), (True, True))

    def test_compaction_aborts_when_a_drain_begins(self):
        def run(pkg):
            idx = build(pkg, "cpdrain", shards=3, **{
                "index.search.mesh": True,
                "index.staging.compact.threshold": 0.2,
                "index.search.mesh.max_slots_per_device": 16})
            try:
                idx.search(dict(QUERY))
                idx.admission.begin_drain()
                out = [idx.compact_now(), idx.maybe_compact_async()]
                with idx._compact_lock:
                    out.append(idx.compact_now())
                idx.admission.end_drain()
                return out
            finally:
                idx.close()

        j, t = both(run)
        assert t == j == [{"ran": False, "reason": "draining"}, False,
                          {"ran": False, "reason": "already_running"}]


class TestNodeDrain:
    def test_index_created_while_node_drains_joins_the_drain(self):
        def run(pkg):
            node = pkg.node()
            try:
                node.create_index("pre", {"settings": {
                    "number_of_shards": 1, "index.refresh_interval": -1}})
                report = node.drain()
                node.index_doc("straggler", "1", {"f": 1})
                draining = node.indices["straggler"].admission.draining
                with pytest.raises(pkg.err.NodeDrainingException):
                    node.search("straggler", {"query": {"match_all": {}}})
                node.undrain()
                return (draining, report["drained"], report["queued_shed"],
                        node.search("straggler", {})["hits"]["total"])
            finally:
                node.close()

        j, t = both(run)
        assert t == j == (True, True, 0, 0)

    def test_node_close_does_not_strand_inflight_search(self, tmp_path):
        def run(pkg):
            node = pkg.node(path=str(tmp_path / pkg.name))
            # the host rung, where the gate holds the shard query
            node.create_index("inflight", {"settings": {
                "index.number_of_shards": 2, "index.refresh_interval": -1,
                "index.search.mesh": False}})
            for d in range(6):
                node.index_doc("inflight", str(d), {"body": "w0 common"})
            node.indices["inflight"].refresh()
            adm = node.indices["inflight"].admission
            entered, release = threading.Event(), threading.Event()

            class Gate(pkg.dis.ShardSearchScheme):
                def on_search(self, index, shard_id):
                    entered.set()
                    assert release.wait(JOIN_S)

            gate = Gate(indices=["inflight"]).install()
            out = {}

            def search():
                try:
                    out["resp"] = node.search(
                        "inflight", {"query": {"match": {"body": "common"}}})
                except Exception as e:  # noqa: BLE001 — asserted below
                    out["error"] = e

            t = threading.Thread(target=search)
            closer = threading.Thread(target=node.close)
            try:
                t.start()
                assert entered.wait(JOIN_S)
                closer.start()  # drains first: waits for the search
                until(lambda: adm.draining, "the drain")
                release.set()
                join_all([t, closer])
            finally:
                release.set()
                gate.remove()
            assert "error" not in out, out.get("error")
            return out["resp"]["hits"]["total"]

        assert both(run) == (6, 6)

    def test_drained_restart_is_ops_free_and_byte_identical(self, tmp_path):
        probe = {"query": {"match": {"body": "common"}}, "size": 10}

        def run(pkg):
            path = str(tmp_path / pkg.name)
            node = pkg.node(path=path)
            node.create_index("warmidx", {"settings": {
                "index.number_of_shards": 2, "index.refresh_interval": -1}})
            for d in range(10):
                node.index_doc("warmidx", str(d), {"body": f"w{d % 3} common"})
            node.indices["warmidx"].refresh()
            want = [(h["_id"], h["_score"]) for h in
                    node.search("warmidx", dict(probe))["hits"]["hits"]]
            report = node.drain()
            synced = [(getattr(s.engine, "last_sync_id", None)
                       or (s.engine.store.read_commit() or {}).get(
                           "sync_id")) is not None
                      for s in node.indices["warmidx"].shards.values()]
            node.close()
            node2 = pkg.node(path=path)
            try:
                got = [(h["_id"], h["_score"]) for h in
                       node2.search("warmidx", dict(probe))["hits"]["hits"]]
                replayed = getattr(node2.indices["warmidx"],
                                   "recovered_ops", None)
                return report["drained"], synced, want, got, replayed
            finally:
                node2.close()

        j, t = both(run)
        assert t[0] is True and t[1] == [True, True]
        assert t[2] == t[3]
        assert [i for i, _ in t[3]] == [i for i, _ in j[3]]
        np.testing.assert_allclose([s for _, s in t[3]],
                                   [s for _, s in j[3]], rtol=1e-5)
        assert t[4] == {0: 0, 1: 0}

    def test_drain_and_undrain_over_rest(self):
        pair = NodePair()
        try:
            pair.same("PUT", "/restdrain", {"settings": {
                "number_of_shards": 1, "index.refresh_interval": -1}})
            (js, jb), (ts, tb) = pair.call("POST", "/_nodes/_local/_drain")
            assert js == ts == 200
            for b in (jb, tb):
                b.pop("took_ms")
            assert tb == jb == {"draining": True, "drained": True,
                                "queued_shed": 0, "in_flight_remaining": 0}
            assert pair.t.indices["restdrain"].admission.draining
            (js, jb), (ts, tb) = pair.call("POST", "/restdrain/_search",
                                           {"query": {"match_all": {}}})
            assert js == ts == 503 and tb == jb
            pair.same("DELETE", "/_nodes/_local/_drain", status=200)
            assert not pair.t.indices["restdrain"].admission.draining
            pair.same("POST", "/restdrain/_search",
                      {"query": {"match_all": {}}}, status=200)
        finally:
            pair.close()
