"""Phase telemetry of the port against the JAX package.

Mirrors ``tests/test_observability.py``, ``tests/test_observability_
registry.py`` and the search-slowlog cases of
``tests/test_deprecation_slowlog.py``: the same documents go into a JAX
``IndexService`` (the tile kernel in interpret mode) and a port one on
the CPU, the same requests go to both, and the plane, the profile's
phases and annotations, the ``search.phases`` counters and decisions, the
slowlog lines and the X-Opaque-Id join must agree; ids, totals and
counters exactly, scores within rtol 1e-5. Threaded cases wait on events
and barriers and join with a time limit.
"""

import logging
import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.search import telemetry as jtel
from elasticsearch_tpu.testing import disruption as jdis
from elasticsearch_tpu_torch.common.settings import (
    Settings,
    cluster_settings,
)
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.search import telemetry as ttel
from elasticsearch_tpu_torch.search.batching import MicroBatcher
from elasticsearch_tpu_torch.testing import disruption as tdis
from torch_pair import NodePair

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
    "emb": {"type": "dense_vector", "dims": 8, "similarity": "cosine"},
}}
JOIN_S = 60.0
SLOWLOG = {"jax": "elasticsearch_tpu.index.search.slowlog",
           "port": "elasticsearch_tpu_torch.index.search.slowlog"}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    yield
    jdis.clear_search_disruptions()
    tdis.clear_search_disruptions()
    jtel.set_opaque_id(None)
    ttel.set_opaque_id(None)


def docs(n_docs, seed=0):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(12)]
    out = []
    for d in range(n_docs):
        toks = [vocab[rng.randint(len(vocab))]
                for _ in range(rng.randint(3, 9))]
        out.append((str(d), {"body": " ".join(toks), "n": d,
                             "emb": rng.randn(8).round(4).tolist()}))
    return out


class Pair:
    """One index in each package over the same documents."""

    def __init__(self, name, n_shards=2, n_docs=80, **extra):
        settings = {"index.number_of_shards": n_shards,
                    "index.refresh_interval": -1, **extra}
        self.j = JIndex(name, JSettings(settings), mapping=MAPPING)
        self.t = IndexService(name, Settings(settings), mapping=MAPPING,
                              device="cpu")
        for doc_id, src in docs(n_docs):
            self.j.index_doc(doc_id, src)
            self.t.index_doc(doc_id, src)
        self.j.refresh()
        self.t.refresh()

    def both(self, fn):
        return fn(self.j), fn(self.t)

    def close(self):
        try:
            self.j.close()
        finally:
            self.t.close()


@pytest.fixture()
def make_pair():
    made = []

    def make(*a, **kw):
        p = Pair(*a, **kw)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


def hits(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def same_hits(jr, tr):
    jh, th = hits(jr), hits(tr)
    assert [i for i, _ in th] == [i for i, _ in jh], (jh, th)
    np.testing.assert_allclose([s for _, s in th], [s for _, s in jh],
                               rtol=1e-5)
    assert tr["hits"]["total"] == jr["hits"]["total"]


def run_threads(targets):
    threads = [threading.Thread(target=fn) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


class TestPlaneTruthfulProfile:
    def test_mesh_pallas_profile_reports_plane_and_phases(self, make_pair):
        p = make_pair("obsprof")
        body = {"query": {"match": {"body": "t0 t1"}}, "size": 5}
        jp, tp = p.both(lambda i: i.search(dict(body)))
        jf, tf = p.both(lambda i: i.search(dict(body, profile=True)))
        for plain, prof in ((jp, jf), (tp, tf)):
            assert plain["_plane"] == prof["_plane"] == "mesh_pallas"
            assert hits(prof) == hits(plain)
            assert prof["profile"]["plane"] == "mesh_pallas"
            assert prof["profile"]["shards"] == []
        same_hits(jf, tf)
        names = {s["phase"] for s in tf["profile"]["phases"]}
        assert names == {s["phase"] for s in jf["profile"]["phases"]}
        assert {"staging", "kernel", "merge"} <= names

    def test_pruned_profile_reports_tile_economy(self, make_pair):
        p = make_pair("obspruned", n_docs=600, **{
            "index.search.pallas.postings_codec": "packed",
            "search.pallas.pruning.enabled": True,
            "search.pallas.pruning.probe_tiles": 2})
        body = {"query": {"match": {"body": "t0 t3 t7"}}, "size": 5}
        jr, tr = p.both(lambda i: i.search(dict(body, profile=True)))
        same_hits(jr, tr)
        assert tr["_pruned"] == jr["_pruned"]
        ja, ta = jr["profile"]["annotations"], tr["profile"]["annotations"]
        for key in ("tiles_scored", "tiles_pruned"):
            assert ta[key] == ja[key] > 0
        for key in ("postings_bytes_streamed", "postings_bytes_skipped"):
            assert ta[key] > 0 and ja[key] > 0
        jc, tc = p.both(lambda i: i.search_stats()["phases"]["counters"])
        assert set(tc) == set(jc)
        for key in ("tiles_scored_total", "tiles_pruned_total"):
            assert tc[key] == jc[key]

    def test_batched_member_profile_reports_batch_shape(self, make_pair):
        p = make_pair("obsbatch")
        burst = [{"query": {"match": {"body": f"t{i}"}}, "size": 4,
                  "profile": True} for i in range(3)]
        jo, to = p.both(lambda i: i.search_batch([dict(b) for b in burst]))
        for j, (jr, tr) in enumerate(zip(jo, to)):
            assert tr["_plane"] == jr["_plane"] == "mesh_pallas"
            same_hits(jr, tr)
            for out in (jr, tr):
                ann = out["profile"]["annotations"]
                assert ann["batch_size"] == 3
                assert ann["batch_member_index"] == j

    def test_host_profile_keeps_segment_tree_plus_phases(self, make_pair):
        p = make_pair("obshost", n_shards=1)
        body = {"query": {"match": {"body": "t1"}}, "size": 5,
                "profile": True}
        jr, tr = p.both(lambda i: i.search(dict(body)))
        same_hits(jr, tr)
        for r in (jr, tr):
            assert r["_plane"] == "host"
            assert r["profile"]["plane"] == "host"
            assert r["profile"]["shards"]
            assert {s["phase"] for s in r["profile"]["phases"]} >= {
                "kernel", "merge"}


class TestSlowlogAndOpaqueId:
    def test_opaque_id_joins_slowlog_and_profile(self, make_pair, caplog):
        p = make_pair("obsoid", n_shards=1, **{
            "index.search.slowlog.threshold.query.warn": "0s"})
        body = {"query": {"match": {"body": "t1"}}, "size": 3,
                "profile": True}
        lines = {}
        for pkg, idx, tel in (("jax", p.j, jtel), ("port", p.t, ttel)):
            tel.set_opaque_id("client-7")
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger=SLOWLOG[pkg]):
                r = idx.search(dict(body))
            tel.set_opaque_id(None)
            assert r["profile"]["annotations"]["opaque_id"] == "client-7"
            lines[pkg] = [rec.getMessage() for rec in caplog.records
                          if rec.name == SLOWLOG[pkg]]
        assert len(lines["port"]) == len(lines["jax"]) == 1
        for line in lines["port"]:
            assert "shard[0]" in line and "id[client-7]" in line
            assert "plane[host]" in line and "phases[kernel:" in line

    def test_mesh_plane_line_is_index_scoped(self, make_pair, caplog):
        p = make_pair("obsmesh", **{
            "index.search.slowlog.threshold.query.info": "0ms"})
        body = {"query": {"match": {"body": "t2"}}, "size": 3}
        lines = {}
        for pkg, idx in (("jax", p.j), ("port", p.t)):
            caplog.clear()
            with caplog.at_level(logging.INFO, logger=SLOWLOG[pkg]):
                assert idx.search(dict(body))["_plane"] == "mesh_pallas"
            lines[pkg] = [rec for rec in caplog.records
                          if rec.name == SLOWLOG[pkg]]
        assert len(lines["port"]) == len(lines["jax"]) == 1
        rec = lines["port"][0]
        assert rec.levelno == logging.INFO
        assert "index[obsmesh]" in rec.getMessage()
        assert "plane[mesh_pallas]" in rec.getMessage()

    def test_negative_threshold_disables(self, make_pair, caplog):
        p = make_pair("obsneg", n_shards=1, **{
            "index.search.slowlog.threshold.query.warn": "-1"})
        for pkg, idx in (("jax", p.j), ("port", p.t)):
            caplog.clear()
            with caplog.at_level(logging.INFO, logger=SLOWLOG[pkg]):
                idx.search({"query": {"match": {"body": "t1"}}})
            assert not [r for r in caplog.records
                        if r.name == SLOWLOG[pkg]]

    def test_batch_member_slowlog_keeps_own_opaque_id(self, make_pair,
                                                       caplog):
        p = make_pair("obsoidbatch", **{
            "search.telemetry.enabled": False,
            "index.search.slowlog.threshold.query.warn": "0s"})
        bodies = [{"query": {"match": {"body": f"t{i}"}}, "size": 3}
                  for i in range(3)]
        for pkg, idx, tel in (("jax", p.j, jtel), ("port", p.t, ttel)):
            tel.set_opaque_id("leader-client")
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger=SLOWLOG[pkg]):
                out = idx.search_batch(
                    [dict(b) for b in bodies],
                    oids=[f"client-{i}" for i in range(3)])
            assert all(isinstance(r, dict) for r in out)
            lines = [rec.getMessage() for rec in caplog.records
                     if rec.name == SLOWLOG[pkg]]
            assert len(lines) == 3, (pkg, lines)
            for i in range(3):
                assert any(f"id[client-{i}]" in ln for ln in lines)
            assert not any("id[leader-client]" in ln for ln in lines)
            assert tel.get_opaque_id() == "leader-client"
            tel.set_opaque_id(None)

    def test_rest_header_reaches_task_and_profile(self):
        pair = NodePair()
        try:
            pair.same("PUT", "/oid", {"settings": {"number_of_shards": 1}})
            pair.same("PUT", "/oid/_doc/1", {"body": "hello"},
                      params={"refresh": "true"})
            body = b'{"query": {"match": {"body": "hello"}}, "profile": true}'
            out = []
            for ctl in (pair.jc, pair.tc):
                st, b = ctl.dispatch("POST", "/oid/_search", {}, body,
                                     "application/json",
                                     headers={"x-opaque-id": "abc"})
                assert st == 200
                out.append(b["profile"]["annotations"]["opaque_id"])
            assert out == ["abc", "abc"]
            # the next request without the header carries none
            st, b = pair.tc.dispatch("POST", "/oid/_search", {}, body,
                                     "application/json")
            assert "opaque_id" not in b["profile"]["annotations"]
        finally:
            pair.close()


class TestCountersUnderConcurrency:
    def test_mixed_burst_counts_consistently(self, make_pair):
        p = make_pair("obsconc", n_docs=100, **{
            "search.batch.max_queries": 4})
        qv = [0.1] * 8
        lex = [{"query": {"match": {"body": f"t{i % 6}"}}, "size": 3}
               for i in range(8)]
        knn = [{"knn": {"field": "emb", "query_vector": qv, "k": 3}}
               for _ in range(4)]
        serial = [{"query": {"match": {"body": f"t{i}"}}, "size": 3,
                   "sort": [{"n": "desc"}]} for i in range(2)]
        bodies = lex + knn + serial

        def burst(idx, host_attr):
            idx.search(dict(lex[0]))
            idx.search(dict(knn[0]))
            base = (idx.telemetry.queries_recorded,
                    idx._mesh_search.query_total,
                    idx._mesh_search.knn_query_total,
                    getattr(idx, host_attr))
            errors = []
            go = threading.Barrier(len(bodies))

            def worker(b):
                go.wait(JOIN_S)
                try:
                    assert isinstance(idx.search(dict(b)), dict)
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

            run_threads([lambda b=b: worker(b) for b in bodies])
            assert not errors, errors
            mesh = idx._mesh_search
            bstats = idx.batch_stats.as_dict()
            return {
                "recorded": idx.telemetry.queries_recorded - base[0],
                "served": (mesh.query_total - base[1]
                           + getattr(idx, host_attr) - base[3]),
                "knn": mesh.knn_query_total - base[2],
                "hist_ok": bstats["batched_query_total"] == sum(
                    int(size) * c for size, c
                    in bstats["batch_size_histogram"].items()),
            }

        want = {"recorded": len(bodies), "served": len(bodies),
                "knn": len(knn), "hist_ok": True}
        assert burst(p.j, "_host_query_total") == want
        assert burst(p.t, "host_query_total") == want


class TestTracerAndRegistry:
    def test_span_ring_capped_and_accumulators_bounded(self):
        out = []
        for mod in (jtel, ttel):
            tr = mod.QueryTracer()
            for _ in range(10_000):
                tr.stop("kernel", tr.start("kernel"))
            out.append((len(tr._ring), tr.ring_dropped,
                        [s["count"] for s in tr.spans()],
                        tr.annotations()))
        assert out[1] == out[0]
        assert out[1][0] == ttel.QueryTracer.MAX_SPANS

    def test_null_tracer_is_inert(self):
        for mod in (jtel, ttel):
            null = mod.NULL_TRACER
            null.stop("kernel", null.start("kernel"))
            null.annotate("x", 1)
            assert null.spans() == [] and null.annotations() == {}
            tel = mod.SearchTelemetry()
            tel.record_query("host", null)
            assert tel.queries_recorded == 0

    def test_registry_histograms_counters_decisions(self):
        blocks = []
        for mod in (jtel, ttel):
            tel = mod.SearchTelemetry()
            tr = mod.QueryTracer()
            tr._acc.update({"kernel": 3_000, "merge": 500, "fetch": 70_000})
            tel.record_query("mesh_pallas", tr)
            tel.record_query("mesh_pallas", tr)
            tel.add_counters({"tiles_scored": 4, "x_total": 2})
            tel.note_decision("host", "single_shard", 3)
            tel.note_decision("mesh_pallas", "served")
            blocks.append(tel.phases_dict())
        assert blocks[1] == blocks[0]
        assert blocks[1]["histogram_us"]["mesh_pallas"]["kernel"] == {
            "le_4": 2}

    def test_merge_phase_stats_sums_histograms(self):
        a = {"query_total": 2,
             "phases": {"taxonomy": list(ttel.PHASES), "queries_recorded": 2,
                        "histogram_us": {"host": {"kernel": {"le_8": 2}}},
                        "counters": {"x_total": 1}, "decisions": {}}}
        b = {"query_total": 3,
             "phases": {"taxonomy": list(ttel.PHASES), "queries_recorded": 3,
                        "histogram_us": {"host": {"kernel": {"le_8": 1,
                                                             "le_16": 4}}},
                        "counters": {"x_total": 2}, "decisions": {}}}
        got = ttel.merge_phase_stats([a, b])
        assert got == jtel.merge_phase_stats([a, b])
        assert got["phases"]["histogram_us"]["host"]["kernel"] == {
            "le_8": 3, "le_16": 4}

    def test_kill_switch_registered_and_honored(self, make_pair):
        reg = cluster_settings()._settings
        assert reg["search.telemetry.enabled"].dynamic
        p = make_pair("obskill", n_shards=1,
                      **{"search.telemetry.enabled": False})
        body = {"query": {"match": {"body": "t1"}}, "size": 3}
        assert p.t._tracer() is ttel.NULL_TRACER
        for idx in (p.j, p.t):
            idx.search(dict(body))
            phases = idx.search_stats()["phases"]
            assert phases["queries_recorded"] == 0
            assert phases["histogram_us"] == {}
            idx.telemetry_enabled_override = True
            idx.search(dict(body))
            assert idx.search_stats()["phases"]["queries_recorded"] == 1

    def test_phases_block_matches_jax(self, make_pair):
        p = make_pair("obsblock", **{"search.batch.enabled": False})
        bodies = [{"query": {"match": {"body": "t1 t2"}}, "size": 3},
                  {"query": {"match": {"body": "t3"}}, "size": 0,
                   "aggs": {"n": {"terms": {"field": "n"}}}},
                  {"knn": {"field": "emb", "query_vector": [0.3] * 8,
                           "k": 4}},
                  {"query": {"match": {"body": "t4"}},
                   "collapse": {"field": "n"}}]
        for b in bodies:
            jr, tr = p.both(lambda i: i.search(dict(b)))
            same_hits(jr, tr)
        jb, tb = p.both(lambda i: i.search_stats()["phases"])
        assert tb["queries_recorded"] == jb["queries_recorded"] == 4
        assert tb["taxonomy"] == jb["taxonomy"]
        assert tb["decisions"] == jb["decisions"]

        def counts(hist):
            return {(plane, phase): sum(b.values())
                    for plane, per in hist.items()
                    for phase, b in per.items()}

        assert counts(tb["histogram_us"]) == counts(jb["histogram_us"])


class TestBatchWindowAnnotations:
    def test_microbatcher_annotate_hook(self):
        mb = MicroBatcher(window_s=30.0, max_queries=2)
        seen = {}
        mb.annotate = (lambda item, wait_s, size, idx:
                       seen.setdefault(item, (wait_s, size, idx)))
        entered, release = threading.Event(), threading.Event()
        results = {}

        def first_single(x):
            entered.set()
            assert release.wait(JOIN_S)
            return ("single", x)

        def run(i):
            results[i] = mb.run(
                "k", i, single_fn=first_single if i == 0 else
                (lambda x: ("single", x)),
                batch_fn=lambda items: [("batch", x) for x in items])

        t0 = threading.Thread(target=run, args=(0,))
        t0.start()
        assert entered.wait(JOIN_S)
        # a search is in flight: the next two form one group, sealed
        # when the second joins
        run_threads([lambda: run(1), lambda: run(2)])
        release.set()
        t0.join(JOIN_S)
        assert results == {0: ("single", 0), 1: ("batch", 1),
                           2: ("batch", 2)}
        assert sorted(seen) == [1, 2]
        for wait_s, size, idx in seen.values():
            assert wait_s >= 0.0 and size == 2 and 0 <= idx < 2
        assert mb.stats.as_dict()["batch_window_effective_ms"] == 30000.0

    def test_window_wait_lands_in_profile_annotations(self, make_pair):
        p = make_pair("obswait", n_shards=1, **{
            "index.search.mesh": False, "search.batch.window_ms": 30000,
            "search.batch.max_queries": 2})
        for idx, dis in ((p.j, jdis), (p.t, tdis)):
            entered, release = threading.Event(), threading.Event()

            class Gate(dis.ShardSearchScheme):
                def on_search(self, index, shard_id):
                    self.hits += 1
                    if self.hits == 1:
                        entered.set()
                        assert release.wait(JOIN_S)

            gate = Gate(indices=["obswait"]).install()
            results = {}

            def search(i):
                results[i] = idx.search(
                    {"query": {"match": {"body": f"t{i}"}}, "size": 3,
                     "profile": True})

            t0 = threading.Thread(target=search, args=(0,))
            t0.start()
            assert entered.wait(JOIN_S)
            run_threads([lambda: search(1), lambda: search(2)])
            release.set()
            t0.join(JOIN_S)
            gate.remove()
            waits = [results[i]["profile"]["annotations"].get(
                "batch_window_wait_ms") for i in (0, 1, 2)]
            assert waits[0] is None
            assert all(w is not None and w >= 0.0 for w in waits[1:])


class TestQuarantineEvents:
    def test_fault_records_timestamped_event(self, make_pair):
        p = make_pair("obsquar")
        body = {"query": {"match": {"body": "t1"}}, "size": 3}
        out = []
        for idx, dis in ((p.j, jdis), (p.t, tdis)):
            assert idx.search(dict(body))["_plane"] == "mesh_pallas"
            before_ms = int(time.time() * 1000)
            scheme = dis.PlaneFailScheme(planes=["mesh_pallas"],
                                         indices=["obsquar"]).install()
            r = idx.search(dict(body))
            scheme.remove()
            stats = idx.search_stats()
            ev = stats["planes"]["quarantine_events"][-1]
            assert ev["plane"] == "mesh_pallas"
            assert ev["timestamp_ms"] >= before_ms and ev["cooldown_s"] > 0
            out.append((r["_plane"], hits(r), scheme.hits,
                        stats["phases"]["decisions"].get(
                            "mesh_pallas.fault")))
        assert out[1][0] == out[0][0] != "mesh_pallas"
        assert [i for i, _ in out[1][1]] == [i for i, _ in out[0][1]]
        assert out[1][2:] == out[0][2:] == (1, 1)


class TestStatsExport:
    def test_blocks_match_jax_and_are_documented(self, make_pair):
        import os

        doc_path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "docs", "OBSERVABILITY.md")
        with open(doc_path, encoding="utf-8") as f:
            doc = f.read()
        p = make_pair("obslint")
        p.both(lambda i: i.search({"query": {"match": {"body": "t1"}}}))
        jb, tb = p.both(lambda i: i.search_stats())
        for block in ("admission", "phases", "compile", "integrity"):
            assert set(tb[block]) == set(jb[block]), block
            for key in tb[block]:
                assert key in doc, (block, key)
        assert set(tb["admission"]["brownout"]) == set(
            jb["admission"]["brownout"])
        assert "batch_window_effective_ms" in tb["batch"]

    def test_node_stats_and_hot_threads(self):
        pair = NodePair()
        try:
            pair.same("PUT", "/ns", {"settings": {"number_of_shards": 2}})
            pair.same("POST", "/_bulk", b"".join(
                b'{"index":{"_index":"ns","_id":"%d"}}\n'
                b'{"body":"w%d common"}\n' % (i, i % 3) for i in range(9)),
                params={"refresh": "true"})
            for q in ("common", "w1", "w2"):
                pair.same("POST", "/ns/_search",
                          {"query": {"match": {"body": q}}})
            (js, jb), (ts, tb) = pair.call("GET", "/_nodes/stats")
            assert js == ts == 200
            jsrch = next(iter(jb["nodes"].values()))["indices"]["search"]
            tsrch = next(iter(tb["nodes"].values()))["indices"]["search"]
            for block in ("phases", "admission", "compile", "integrity"):
                assert set(tsrch[block]) == set(jsrch[block]), block
            assert (tsrch["phases"]["queries_recorded"]
                    == jsrch["phases"]["queries_recorded"] == 3)
            assert (tsrch["admission"]["admitted_total"]
                    == jsrch["admission"]["admitted_total"] == 3)
            (js, jb), (ts, tb) = pair.call("GET", "/_stats")
            assert (tb["indices"]["ns"]["total"]["search"]["phases"]
                    ["decisions"] == jb["indices"]["ns"]["total"]["search"]
                    ["phases"]["decisions"])
            for path in ("/_nodes/hot_threads", "/_nodes/x/hot_threads"):
                (js, jb), (ts, tb) = pair.call("GET", path)
                assert js == ts == 200
                for text in (jb, tb):
                    assert "Hot threads sampled over 50ms" in text
        finally:
            pair.close()
