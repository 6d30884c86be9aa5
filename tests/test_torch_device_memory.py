"""The port's device-memory ledger (``common/memory.py``), mirroring the
JAX package's ``tests/test_device_memory.py``.

The same register, release, touch and reserve steps run through both
packages' ``DeviceMemoryAccountant`` and must leave the same ledger: the
same bytes by kind (their sum is the total), the same lifecycle events
(kinds and reasons, in order), the same amplification, evictions and
denials. Over whole indices: every staging site registers, the kinds and
reasons of the same steps match the JAX package's, an over-budget mesh
staging demotes to the host rung (reason ``hbm_budget``) with the hits
the mesh plane gave, the restage after the budget clears is a ``probe``,
and ``close`` returns the index's ledger bytes to 0 exactly (the process
ledger ends with no more bytes than it began with). Each JAX index
made here is closed, and the JAX package's ledger ends no larger than it
began.
"""

import threading

import numpy as np
import pytest

from elasticsearch_tpu.common import memory as jmemory
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common import memory as tmemory
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from test_torch_search import assert_same_hits

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
}}


@pytest.fixture(autouse=True)
def _jax_ledger_kept(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    before = jmemory.memory_accountant().staged_bytes()
    yield
    memory_accountant().set_budget(0)
    # no JAX staging outlives the test (other files' JAX indices may
    # release theirs meanwhile, so the total may only shrink)
    assert jmemory.memory_accountant().staged_bytes() <= before


@pytest.fixture()
def ledger_leak_check():
    """The process ledger holds no more bytes after the test than before
    it (each test also checks its own indices at 0 bytes). Other test
    files' indices may hold evictable stagings that a budget or an
    eviction here drops, so the total may only shrink."""
    acct = memory_accountant()
    base = acct.staged_bytes()
    yield acct
    assert acct.staged_bytes() <= base, (
        f"device-memory ledger leaked: {acct.staged_bytes()} > {base}")


def _view(acct):
    """The ledger's comparable state (timestamps and durations out)."""
    st = acct.stats()
    drop = ("timestamp_ms", "duration_ms")
    for key in ("staging_events", "eviction_events", "staging_fault_events"):
        st[key] = [{k: v for k, v in e.items() if k not in drop}
                   for e in st[key]]
    return st


def _evictor(log, name):
    return lambda: log.append(name)


def _steps_kinds(a, log):
    a.register("i", "s1", "postings_raw", "t1", 100)
    a.register("i", "s1", "live_mask", "t2", 30)
    a.register("i", "s2", "scale_norm", "t3", 7)
    log.append(a.staged_bytes_by_kind())


def _steps_restage(a, log):
    a.register("i", "s", "postings_raw", "t", 100)
    a.register("i", "s", "postings_raw", "t", 60, reason="refresh")
    a.register("i", "s", "postings_raw", "t", 60)  # in place: a probe
    a.release_scope("i", "s")
    a.register("i", "s", "postings_raw", "t", 100)  # after release: probe
    a.register("i", "s2", "doc_values", "c", 64, quiet=True)


def _steps_amplification(a, log):
    a.register("i", "s", "postings_raw", "t", 1000)
    a.register("i", "s", "postings_raw", "t", 1000,
               reason="delete_invalidation")
    a.note_logical_change("i", 100)
    a.register("i", "m", "mesh_slot_tables", "seg_stacked", 5000,
               reason="delta_append", amplify_bytes=800)
    a.register("i", "m", "live_mask", "k_live_t", 4096, reason="tombstone",
               amplify_bytes=512)
    log.append(a.stats("i")["restage_amplification"])
    a.release_index("i")
    a.register("i", "s", "postings_raw", "t", 50)  # initial again


def _steps_ring(a, log):
    for i in range(a.MAX_EVENTS + 10):
        a.register("i", "s", "postings_raw", f"t{i}", 1)


def _steps_lru(a, log):
    for name in ("cold", "warm", "hot"):
        a.register("i", name, "postings_raw", "t", 100,
                   evict=_evictor(log, name))
    a.touch("i", "warm")
    a.touch("i", "hot")
    a.budget_bytes = 300
    log.append(a.try_reserve("i", 100))  # evicts cold only
    a.budget_bytes = 0


def _steps_denial(a, log):
    a.register("i", "pinned", "postings_raw", "t", 90)
    a.register("i", "me", "live_mask", "t", 5, evict=_evictor(log, "me"))
    a.budget_bytes = 100
    log.append(a.try_reserve("i", 50, exclude_scope="me"))
    log.append(a.try_reserve("i", 50, exclude_scope="me", mandatory=True))
    log.append(a.try_reserve("i", 1))
    a.budget_bytes = 0
    log.append(a.try_reserve("i", 10 ** 15))


def _steps_faults(a, log):
    a.note_staging_retry("i", "postings_raw")
    a.note_staging_fault("i", "live_mask", transient=False, retries=0,
                         plane="mesh", error="ValueError: x")
    a.note_staging_fault("i", "embeddings", transient=True, retries=2)


STEPS = {f.__name__[len("_steps_"):]: f for f in (
    _steps_kinds, _steps_restage, _steps_amplification, _steps_ring,
    _steps_lru, _steps_denial, _steps_faults)}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_same_ledger_as_jax(name):
    out = []
    for mod in (jmemory, tmemory):
        acct = mod.DeviceMemoryAccountant()
        log = []
        STEPS[name](acct, log)
        out.append((log, _view(acct), acct.staged_bytes(),
                    acct.staged_bytes_by_kind()))
        assert acct.staged_bytes() == sum(acct.staged_bytes_by_kind().values())
        for index in {k[0] for k in acct._entries}:
            acct.release_index(index)  # the breaker mirrors balance
        assert acct.staged_bytes() == 0
    assert out[1] == out[0]


def test_kinds_and_reasons_follow_the_jax_order():
    assert tmemory.KINDS == jmemory.KINDS
    assert tmemory.REASONS == jmemory.REASONS


def test_set_budget_evicts_and_mirrors_the_accounting_limit():
    acct = tmemory.DeviceMemoryAccountant()
    breaker = acct._accounting_breaker()
    prev = breaker.limit_bytes
    try:
        acct.register("i", "s", "postings_raw", "t", 500,
                      evict=lambda: None)
        used = breaker.used_bytes
        acct.set_budget(200)
        assert breaker.limit_bytes == 200
        assert acct.staged_bytes() == 0  # over budget: evicted at once
        assert breaker.used_bytes == used - 500
        assert acct.evictions_total == 1
    finally:
        acct.set_budget(0)
        breaker.limit_bytes = prev


def _mk_pair(name, shards=2, docs=40, extra=None):
    """A port index and a JAX one over the same seeded documents."""
    settings = {"index.number_of_shards": shards,
                "index.refresh_interval": -1, **(extra or {})}
    t = IndexService(name, Settings(settings), mapping=MAPPING, device="cpu")
    j = JIndex(name, JSettings({
        **settings, "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=MAPPING)
    j._mesh_search = JMesh(j, mesh=shard_mesh(1))
    rng = np.random.RandomState(11)
    vocab = [f"w{i}" for i in range(8)]
    for d in range(docs):
        src = {"body": " ".join(vocab[rng.randint(len(vocab))]
                                for _ in range(6)), "n": d}
        t.index_doc(str(d), src)
        j.index_doc(str(d), src)
    t.refresh()
    j.refresh()
    return t, j


class TestServiceLeakCheck:
    def test_close_returns_to_baseline(self, ledger_leak_check):
        acct = ledger_leak_check
        t, j = _mk_pair("tdmleak")
        try:
            r = t.search({"query": {"match": {"body": "w1"}}, "size": 5})
            assert r["_plane"] == "mesh_pallas"
            assert acct.staged_bytes("tdmleak") > 0
            st = t.search_stats()["memory"]
            assert (st["staged_bytes_total"]
                    == sum(st["staged_bytes"].values()) > 0)
            by_kind = st["staged_bytes"]
            assert by_kind["mesh_slot_tables"] > 0
            assert by_kind["postings_raw"] + by_kind["postings_packed"] > 0
            assert by_kind["live_mask"] > 0
        finally:
            t.close()
            j.close()
        assert acct.staged_bytes("tdmleak") == 0

    def test_same_kinds_and_reasons_as_jax_on_the_same_steps(self):
        """One shard (the host rung in both packages): index, search,
        delete, merge. The lifecycle events give the same (kind, reason)
        pairs."""
        t, j = _mk_pair("tdmsteps", shards=1)
        try:
            for idx in (t, j):
                idx.search({"query": {"match": {"body": "w1"}}, "size": 5})
                idx.delete_doc("3")
                idx.refresh()
                idx.search({"query": {"match": {"body": "w2"}}, "size": 5})
                for d in range(100, 110):
                    idx.index_doc(str(d), {"body": "w1 w2", "n": d})
                idx.refresh()
                idx.force_merge()
                idx.search({"query": {"match": {"body": "w1"}}, "size": 5})

            def pairs(st):
                return {(e["kind"], e["reason"])
                        for e in st["staging_events"]}

            tst = memory_accountant().stats("tdmsteps")
            jst = jmemory.memory_accountant().stats("tdmsteps")
            assert pairs(tst) == pairs(jst)
            assert {"delete_invalidation", "refresh"} <= {
                reason for _k, reason in pairs(tst)}
            kinds = {k for k, v in tst["staged_bytes"].items() if v}
            assert kinds == {k for k, v in jst["staged_bytes"].items() if v}
        finally:
            t.close()
            j.close()

    def test_mesh_lifecycle_matches_jax_with_delta_staging_on(self):
        """Three shards on one device with slot headroom, delta staging on
        in both packages: initial staging, fused aggs, a refresh append,
        a delete, a budget eviction and its probe restage, a compaction.
        Each step gives the same plane, hits, generation scope and
        (kind, reason) pairs in both, and the tombstone and append rows
        the same bytes. One difference is by design: the port keeps each
        segment's kernel posting, bound and vector tables in the
        segment's own scope (one copy, segment-local row windows) where
        the JAX package stacks a copy into every generation. So those
        kinds are absent from the port's generation scopes and staged in
        its segments' scopes in the same step (after an append with the
        segment's ``initial``, where JAX's generation says
        ``delta_append``); the segment scopes also hold the base tables
        an append builds its rows from, whose live masks a delete
        restages (``delete_invalidation``). And the port stages the fused
        aggregations' doc-value columns over the occupied slots only, the
        JAX package over every slot of the generation, dead ones too."""
        name = "tdmdelta"
        settings = {"index.number_of_shards": 3,
                    "index.refresh_interval": -1,
                    "index.staging.delta.enabled": True,
                    "index.staging.compact.threshold": 0.0,
                    "index.search.mesh.max_slots_per_device": 16}
        mapping = {"properties": {
            **MAPPING["properties"], "tag": {"type": "keyword"},
            "emb": {"type": "dense_vector", "dims": 8,
                    "similarity": "cosine"}}}
        t = IndexService(name, Settings(settings), mapping=mapping,
                         device="cpu")
        j = JIndex(name, JSettings({**settings,
                                    "index.requests.cache.enable": False}),
                   mapping=mapping)
        j._mesh_search = JMesh(j, mesh=shard_mesh(1))
        rng = np.random.RandomState(23)
        vecs = rng.randn(64, 8).astype(np.float32)

        def doc(d):
            return {"body": f"w{d % 5} common", "n": d % 17,
                    "tag": ["red", "green", "blue"][d % 3],
                    "emb": vecs[d].tolist()}

        match = {"query": {"match": {"body": "common"}}, "size": 8}
        aggs = {"query": {"match": {"body": "w1 w2"}}, "size": 4,
                "aggs": {"tags": {"terms": {"field": "tag"}},
                         "s": {"sum": {"field": "n"}}}}
        knn = {"knn": {"field": "emb", "query_vector": vecs[0].tolist(),
                       "k": 6, "num_candidates": 40}, "size": 6}
        seg_kinds = {"postings_raw", "postings_packed", "bound_tables",
                     "embeddings", "scale_norm"}
        jacct = jmemory.memory_accountant()
        tacct = memory_accountant()
        jbudget = jacct.budget_bytes

        def fill(lo, hi):
            def run(idx):
                for d in range(lo, hi):
                    idx.index_doc(str(d), doc(d))
                idx.refresh()
            return run

        def delete(idx):
            for d in (3, 17, 30, 50):
                idx.delete_doc(str(d))
            idx.refresh()

        def searches(idx):
            return [idx.search(dict(b)) for b in (match, aggs, knn)]

        def over_budget(idx):
            acct = tacct if idx is t else jacct
            acct.set_budget(1)
            try:
                return [idx.search(dict(match))]
            finally:
                acct.set_budget(0)

        def compact(idx):
            idx._compact_threshold = lambda: 0.01
            out = idx.compact_now()
            assert out["ran"] is True, out
            return searches(idx)

        steps = [("initial", fill(0, 48)), ("initial", searches),
                 ("append", fill(48, 64)), ("append", searches),
                 ("tombstone", delete), ("tombstone", searches),
                 ("budget", over_budget), ("probe", searches),
                 ("compaction", compact)]

        def pushed(acct):
            # the ring is bounded: count what left it too
            return acct.events_dropped + len(acct.staging_events)

        def since(acct, n0):
            n = pushed(acct) - n0
            assert n <= acct.MAX_EVENTS  # the step's events all held
            ring = list(acct.staging_events)
            return [e for e in ring[len(ring) - n:] if e["index"] == name]

        def gen(events):
            return {(e["kind"], e["reason"]) for e in events
                    if e["segment"].startswith("mesh#")}

        def rows(events, reason):
            return sorted((e["kind"], e["table"], e["bytes"]) for e in events
                          if e["segment"].startswith("mesh#")
                          and e["reason"] == reason
                          and e["kind"] not in seg_kinds)

        def ledger(acct, scale=(1, 1)):
            """The generation rows; doc-value bytes times scale[0] over
            scale[1] (the occupied slots over all). The generation
            counters are the process's, so a scope is known by its rank."""
            scopes = sorted({r["segment"] for r in acct.table()
                             if r["index"] == name
                             and r["segment"].startswith("mesh#")},
                            key=lambda sc: int(sc[len("mesh#"):]))
            return sorted((scopes.index(r["segment"]), r["kind"],
                           r["bytes"] * scale[0] // scale[1]
                           if r["kind"] == "doc_values" else r["bytes"])
                          for r in acct.table()
                          if r["index"] == name
                          and r["segment"].startswith("mesh#")
                          and r["kind"] not in seg_kinds)

        try:
            seen = set()
            for step, run in steps:
                got = {}
                for idx, acct in ((t, tacct), (j, jacct)):
                    n0, st0 = pushed(acct), acct.stats(name)
                    out = run(idx) or []
                    st1 = acct.stats(name)
                    if step == "append" and out:
                        # the append's restage amplification: about 1
                        d_log = (st1["bytes_logically_changed_total"]
                                 - st0["bytes_logically_changed_total"])
                        assert 0 < (st1["restaged_bytes_total"]
                                    - st0["restaged_bytes_total"]
                                    ) <= 1.5 * d_log, idx
                    got[idx is t] = (out, since(acct, n0))
                (t_out, t_ev), (j_out, j_ev) = got[True], got[False]
                for tr, jr in zip(t_out, j_out):
                    assert tr["_plane"] == jr["_plane"], step
                    assert_same_hits(jr, tr)
                    assert tr.get("aggregations") == jr.get("aggregations")
                assert gen(t_ev) == {(k, r) for k, r in gen(j_ev)
                                     if k not in seg_kinds}, step
                # what the JAX generation stacks, the port staged in the
                # segments' scopes in the same step
                assert ({k for k, _r in gen(j_ev) if k in seg_kinds}
                        <= {e["kind"] for e in t_ev
                            if not e["segment"].startswith("mesh#")}), step
                for reason in ("tombstone", "delta_append"):
                    assert rows(t_ev, reason) == rows(j_ev, reason), step
                ex = t._mesh_search and t._mesh_search._executor
                occupied = ((ex.n_occupied, ex.n_slots) if ex is not None
                            else (1, 1))
                assert ledger(tacct) == ledger(jacct, occupied), step
                seen |= {r for _k, r in gen(t_ev)}
            assert {"initial", "delta_append", "tombstone", "probe",
                    "compaction"} <= seen, seen
            assert t_out[0]["_plane"] == "mesh_pallas"
            # the budget step demoted both to the host rung
            assert (t.search_stats()["planes"]["decisions"]["host.hbm_budget"]
                    == j.telemetry.decisions["host.hbm_budget"] == 1)
            ms = t._mesh_search
            assert (ms.delta_restage_total, ms.tombstone_update_total) == (
                j._mesh_search.delta_restage_total,
                j._mesh_search.tombstone_update_total) == (1, 1)
        finally:
            tacct.set_budget(0)
            jacct.set_budget(jbudget)
            t.close()
            j.close()
        assert tacct.staged_bytes(name) == 0

    def test_force_merge_restage_cycle(self, ledger_leak_check):
        acct = ledger_leak_check
        t, j = _mk_pair("tdmmerge", shards=1)
        j.close()
        try:
            for d in range(100, 120):
                t.index_doc(str(d), {"body": "w1 w2", "n": d})
            t.refresh()
            t.search({"query": {"match": {"body": "w1"}}, "size": 5})
            assert acct.staged_bytes("tdmmerge") > 0
            t.force_merge()
            n_before = len(acct.stats("tdmmerge")["staging_events"])
            t.search({"query": {"match": {"body": "w1"}}, "size": 5})
            post = acct.stats("tdmmerge")["staging_events"][n_before:]
            # the merge product restages the retired segments' corpus
            assert any(e["reason"] == "refresh" for e in post), post
            st = t.search_stats()["memory"]
            assert st["staged_bytes_total"] == sum(st["staged_bytes"].values())
        finally:
            t.close()
        assert acct.staged_bytes("tdmmerge") == 0

    def test_doc_values_kind_populated_and_leak_free(self, ledger_leak_check):
        acct = ledger_leak_check
        t, j = _mk_pair("tdmdv")
        body = {"query": {"match": {"body": "w1"}}, "size": 5,
                "aggs": {"s": {"sum": {"field": "n"}}}}
        try:
            got = t.search(dict(body))
            assert got["_plane"] == "mesh_pallas"
            assert got["aggregations"] == j.search(dict(body))["aggregations"]
            st = acct.stats("tdmdv")
            assert st["staged_bytes"]["doc_values"] > 0
            assert [e for e in st["staging_events"]
                    if e["kind"] == "doc_values"]
            t.force_merge()
            t.refresh()
            assert t.search(dict(body))["aggregations"] == got["aggregations"]
            assert acct.stats("tdmdv")["staged_bytes"]["doc_values"] > 0
            # eviction drops the columns with their generation's scope; the
            # next query restages them
            assert acct.force_evict(scopes=8) > 0
            assert t.search(dict(body))["aggregations"] == got["aggregations"]
            st3 = acct.stats("tdmdv")
            assert (st3["staged_bytes_total"]
                    == sum(st3["staged_bytes"].values()))
            assert st3["staged_bytes"]["doc_values"] > 0
        finally:
            t.close()
            j.close()
        assert acct.staged_bytes("tdmdv") == 0


class TestBudgetDemotion:
    def test_over_budget_demotes_with_identical_hits(self, ledger_leak_check):
        acct = ledger_leak_check
        t, j = _mk_pair("tdmbudget")
        body = {"query": {"match": {"body": "w1 w3"}}, "size": 6}
        try:
            baseline = t.search(dict(body))
            assert baseline["_plane"] == "mesh_pallas"
            evictions = acct.evictions_total
            denials = acct.budget_denials_total
            acct.set_budget(1)
            assert acct.evictions_total > evictions
            degraded = t.search(dict(body))
            assert degraded["_plane"] == "host"
            assert_same_hits(baseline, degraded)
            assert_same_hits(j.search(dict(body)), degraded)
            decisions = t.search_stats()["planes"]["decisions"]
            assert decisions.get("host.hbm_budget", 0) >= 1, decisions
            assert acct.budget_denials_total > denials
            acct.set_budget(0)
            recovered = t.search(dict(body))
            assert recovered["_plane"] == "mesh_pallas"
            assert ([(h["_id"], h["_score"])
                     for h in recovered["hits"]["hits"]]
                    == [(h["_id"], h["_score"])
                        for h in baseline["hits"]["hits"]])
            assert any(e["reason"] == "probe" and
                       e["kind"] == "mesh_slot_tables"
                       for e in acct.stats("tdmbudget")["staging_events"])
        finally:
            acct.set_budget(0)
            t.close()
            j.close()

    def test_node_sets_the_budget_from_its_settings(self):
        from elasticsearch_tpu_torch.node import Node

        node = Node(Settings({"search.memory.hbm_budget_bytes": "1mb"}),
                    device="cpu")
        try:
            assert memory_accountant().budget_bytes == 1024 * 1024
            assert node.breaker_service.get_breaker(
                "accounting").limit_bytes == 1024 * 1024
        finally:
            node.close()
            memory_accountant().set_budget(0)


def test_ledger_consistent_under_concurrent_stage_evict_and_query():
    acct = memory_accountant()
    base = acct.staged_bytes()
    t, j = _mk_pair("tdmconc", shards=3, docs=60)
    j.close()
    body = {"query": {"match": {"body": "w1 w2"}}, "size": 6}
    want = t.search(dict(body))
    stop = threading.Event()
    errors = []

    def querier():
        try:
            while not stop.is_set():
                got = t.search(dict(body))
                assert got["hits"]["total"] == want["hits"]["total"]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def churner():
        try:
            while not stop.is_set():
                acct.set_budget(1)
                acct.set_budget(0)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=querier) for _ in range(3)]
    threads.append(threading.Thread(target=churner))
    for th in threads:
        th.start()
    try:
        import time

        time.sleep(1.0)
    finally:
        stop.set()
        for th in threads:
            th.join(30)
        acct.set_budget(0)
    try:
        assert not errors, errors
        assert not any(th.is_alive() for th in threads)
        assert acct.staged_bytes() == sum(acct.staged_bytes_by_kind().values())
        got = t.search(dict(body))
        assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
            [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]
    finally:
        t.close()
    assert acct.staged_bytes("tdmconc") == 0
    assert acct.staged_bytes() <= base  # the budget may evict others
