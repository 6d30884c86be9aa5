"""Delta staging of the port's mesh plane, mirroring the JAX package's
``tests/test_delta_staging.py``.

A refresh that adds segments stages only them into free slots of the live
generation (ledger reason ``delta_append``, restage amplification about
1); a delete rewrites only its slot's live rows (reason ``tombstone``);
a compaction pass merges the sparse shards and restages a compact
generation (reason ``compaction``) off the query path. An appended or
tombstoned generation answers byte for byte as a full rebuild of the same
segments does (hits, scores, fused aggregations, kNN), on every rung, and
the ledger returns to its baseline exactly across append, tombstone and
compaction; a fault mid-delta leaves the pre-attempt ledger exact.
Against the JAX package (the same seeded documents, its plane on a
one-device mesh with delta staging off): ids, totals and aggregations
exactly, scores within rtol 1e-5.

Left out until the port has their modules: the cluster-settings override
of ``index.staging.*`` (``PUT _cluster/settings``) and the compaction
pass's drain abort (admission control).
"""

import threading

import numpy as np
import pytest

from elasticsearch_tpu.common.memory import memory_accountant as jaccountant
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.testing.disruption import (
    StagingFailScheme,
    clear_search_disruptions,
)
from test_torch_search import assert_same_hits

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
    "tag": {"type": "keyword"},
}}

DIMS = 16

KNN_MAPPING = {"properties": {
    "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
    "body": {"type": "text", "analyzer": "whitespace"},
}}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    jbytes = jaccountant().staged_bytes()
    clear_search_disruptions()
    yield
    clear_search_disruptions()
    # no JAX staging outlives the test (other files' JAX indices may
    # release theirs meanwhile, so the total may only shrink)
    assert jaccountant().staged_bytes() <= jbytes


def _doc(d):
    return {"body": f"w{d % 5} common", "n": d % 17,
            "tag": ["red", "green", "blue"][d % 3]}


def build_index(name, mesh=True, delta=True, compact=0.0, shards=3,
                mapping=None, **extra):
    """compact=0 turns background compaction off, so the tests observe
    the delta generations themselves."""
    settings = {"index.number_of_shards": shards,
                "index.refresh_interval": -1,
                "index.search.mesh": mesh,
                "index.staging.delta.enabled": delta,
                "index.staging.compact.threshold": compact,
                # one device: room for several refreshes' segments
                "index.search.mesh.max_slots_per_device": 16}
    settings.update(extra)
    return IndexService(name, Settings(settings), mapping=mapping or MAPPING,
                        device="cpu")


def _fill(idx, lo, hi, doc=_doc):
    for d in range(lo, hi):
        idx.index_doc(str(d), doc(d))
    idx.refresh()


def assert_identical(got, want):
    """Byte for byte: ids, scores, totals, aggregations."""
    assert got["hits"]["total"] == want["hits"]["total"]
    assert ([(h["_id"], h["_score"]) for h in got["hits"]["hits"]]
            == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])
    assert got.get("aggregations") == want.get("aggregations")


def _mesh_rows(name):
    return sorted((r["segment"], r["kind"], r["bytes"], r["tables"])
                  for r in memory_accountant().table()
                  if r["index"] == name and r["segment"].startswith("mesh#"))


MATCH = {"query": {"match": {"body": "common"}}, "size": 5}


class TestDeltaAppend:
    def test_pure_append_keeps_generation_and_amp_1(self):
        idx = build_index("tda-amp")
        try:
            _fill(idx, 0, 48)
            assert idx.search(dict(MATCH))["_plane"] == "mesh_pallas"
            ms = idx._mesh_search
            acc = memory_accountant()
            st0 = acc.stats("tda-amp")
            scope0 = ms._executor.scope
            free0 = ms._executor.free_slots()
            assert free0 >= idx.num_shards  # headroom for one refresh
            _fill(idx, 48, 64)
            r = idx.search(dict(MATCH))
            assert r["_plane"] == "mesh_pallas"
            assert r["hits"]["total"] == 64
            assert ms.delta_restage_total == 1
            assert ms.restage_total == 1
            assert ms._executor.scope != scope0
            assert ms._executor.free_slots() == free0 - idx.num_shards
            st1 = acc.stats("tda-amp")
            d_rest = (st1["restaged_bytes_total"]
                      - st0["restaged_bytes_total"])
            d_log = (st1["bytes_logically_changed_total"]
                     - st0["bytes_logically_changed_total"])
            assert d_log > 0
            assert d_rest / d_log <= 1.5, (d_rest, d_log)
            reasons = {e["reason"] for e in st1["staging_events"]
                       if e not in st0["staging_events"]}
            assert "delta_append" in reasons
            # the old generation's scope returned its bytes
            assert not [r for r in acc.table()
                        if r["index"] == "tda-amp" and r["segment"] == scope0]
        finally:
            idx.close()

    def test_append_slots_exhausted_falls_back_to_rebuild(self):
        # 2 shards, 6 slots at most: the first generation stages 2 slots
        # and 2 of headroom, the first refresh appends into them, and the
        # second finds no free slot and rebuilds
        idx = build_index("tda-fallback", shards=2,
                          **{"index.search.mesh.max_slots_per_device": 6})
        full = build_index("tda-fallback-f", shards=2, delta=False,
                           **{"index.search.mesh.max_slots_per_device": 6})
        try:
            for i in (idx, full):
                _fill(i, 0, 24)
            idx.search(dict(MATCH))
            ms = idx._mesh_search
            assert ms._executor.n_slots == 4
            for lo in (24, 36):
                for i in (idx, full):
                    _fill(i, lo, lo + 12)
                r = idx.search(dict(MATCH))
                assert r["_plane"] == "mesh_pallas"
                assert_identical(r, full.search(dict(MATCH)))
            assert r["hits"]["total"] == 48
            assert ms.delta_restage_total == 1
            assert ms.restage_total == 2
            assert ms._executor.n_slots == 6
        finally:
            idx.close()
            full.close()

    def test_delta_disabled_setting_forces_rebuild(self):
        idx = build_index("tda-off", delta=False)
        try:
            _fill(idx, 0, 48)
            idx.search(dict(MATCH))
            ms = idx._mesh_search
            scope0 = ms._executor.scope
            assert ms._executor.free_slots() == 0  # no headroom staged
            _fill(idx, 48, 64)
            r = idx.search(dict(MATCH))
            assert r["hits"]["total"] == 64
            assert ms.delta_restage_total == 0
            assert ms.restage_total == 2
            assert ms._executor.scope != scope0
        finally:
            idx.close()


class TestTombstone:
    def test_delete_updates_only_live_mask_in_place(self):
        idx = build_index("tts-mask")
        try:
            _fill(idx, 0, 48)
            idx.search(dict(MATCH))
            ms = idx._mesh_search
            scope0 = ms._executor.scope
            acc = memory_accountant()
            n_before = len(acc.stats("tts-mask")["staging_events"])
            idx.delete_doc("7")
            idx.refresh()
            r = idx.search({"query": {"match": {"body": "common"}},
                            "size": 48})
            assert r["hits"]["total"] == 47
            assert "7" not in [h["_id"] for h in r["hits"]["hits"]]
            assert ms._executor.scope == scope0  # the same generation
            assert ms.tombstone_update_total == 1
            assert ms.restage_total == 1
            new = acc.stats("tts-mask")["staging_events"][n_before:]
            mesh_events = [e for e in new if e["reason"] == "tombstone"]
            assert mesh_events, new
            assert all(e["kind"] in ("live_mask", "mesh_slot_tables")
                       for e in mesh_events)
            # only one slot's rows restaged
            ex = ms._executor
            row = {"seg_stacked": ex.nd1,
                   "k_live_t": ex._seg_staged["k_live_t"][0].numel() * 4}
            for e in mesh_events:
                assert e["bytes"] == row[e["table"]], e
        finally:
            idx.close()

    def test_tombstone_density_visible_in_slot_stats(self):
        idx = build_index("tts-density", shards=2)
        try:
            _fill(idx, 0, 20)
            idx.search(dict(MATCH))
            ms = idx._mesh_search
            for d in range(5):
                idx.delete_doc(str(d))
            idx.refresh()
            idx.search(dict(MATCH))
            stats = ms.staging_slot_stats()
            assert stats["free_slots"] >= 1
            assert stats["free_slots_per_device"] >= 1
            assert sum(s["docs"] - s["live"] for s in stats["slots"]) == 5
            assert any(s["tombstone_density"] > 0 for s in stats["slots"])
        finally:
            idx.close()


def _jax_index(name, mapping=MAPPING, shards=3):
    j = JIndex(name, JSettings({
        "index.number_of_shards": shards, "index.refresh_interval": -1,
        "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=mapping)
    j._mesh_search = JMesh(j, mesh=shard_mesh(1))
    return j


class TestDeltaVsFullParity:
    PROBE = {"query": {"match": {"body": "common"}}, "size": 3}

    def _run_interleaved(self, idx):
        """Index, delete, refresh and search, the same on every index; the
        searches between the steps keep a generation staged, so the delta
        index runs its append and tombstone paths."""
        _fill(idx, 0, 48)
        idx.search(dict(self.PROBE))
        for d in (3, 17, 30):
            idx.delete_doc(str(d))
        idx.refresh()
        idx.search(dict(self.PROBE))
        _fill(idx, 48, 60)
        idx.search(dict(self.PROBE))
        for d in (48, 5):
            idx.delete_doc(str(d))
        idx.refresh()
        idx.search(dict(self.PROBE))
        _fill(idx, 60, 72)

    BODIES = [
        {"query": {"match": {"body": "common"}}, "size": 30},
        {"query": {"match": {"body": "w1 w2"}}, "size": 20,
         "aggs": {"tags": {"terms": {"field": "tag"}},
                  "hist": {"histogram": {"field": "n", "interval": 5}},
                  "st": {"stats": {"field": "n"}}}},
        {"query": {"match": {"body": "w3 common"}}, "size": 10,
         "aggs": {"mx": {"max": {"field": "n"}}}},
    ]

    def test_hits_scores_and_aggs_byte_identical_every_rung(self):
        delta = build_index("tpar-delta")
        full = build_index("tpar-full", delta=False)
        host = build_index("tpar-host", mesh=False)
        jidx = _jax_index("tpar-jax")
        try:
            for idx in (delta, full, host, jidx):
                self._run_interleaved(idx)
            for body in self.BODIES:
                got = delta.search(dict(body))
                assert got["_plane"] == "mesh_pallas", got["_plane"]
                assert_identical(got, full.search(dict(body)))
                assert_identical(got, host.search(dict(body)))
                want = jidx.search(dict(body))
                assert_same_hits(want, got)
                assert got.get("aggregations") == want.get("aggregations")
            # the batched rung over the appended generation, too
            burst = [dict(b) for b in self.BODIES]
            for g, f in zip(delta.search_batch([dict(b) for b in burst]),
                            full.search_batch([dict(b) for b in burst])):
                assert g["_plane"] == "mesh_pallas"
                assert_identical(g, f)
            assert delta._mesh_search.delta_restage_total >= 1
            assert delta._mesh_search.tombstone_update_total >= 1
            assert full._mesh_search.delta_restage_total == 0
        finally:
            for idx in (delta, full, host, jidx):
                idx.close()

    def test_knn_byte_identical_after_append_and_delete(self):
        rng = np.random.RandomState(7)
        vecs = rng.randn(72, DIMS).astype(np.float32)

        def doc(d):
            return {"emb": vecs[d].tolist(), "body": f"t{d % 3}"}

        delta = build_index("tknn-delta", mapping=KNN_MAPPING)
        full = build_index("tknn-full", delta=False, mapping=KNN_MAPPING)
        jidx = _jax_index("tknn-jax", mapping=KNN_MAPPING)
        body = {"knn": {"field": "emb", "query_vector": vecs[0].tolist(),
                        "k": 10, "num_candidates": 50}, "size": 10}
        try:
            for idx in (delta, full, jidx):
                _fill(idx, 0, 48, doc)
                idx.search(dict(body))  # stage the kNN plane
                _fill(idx, 48, 64, doc)
                idx.search(dict(body))  # an append with the plane staged
                idx.delete_doc("9")
                idx.refresh()
                idx.search(dict(body))  # a tombstone of the kNN mask
                _fill(idx, 64, 72, doc)
            got = delta.search(dict(body))
            assert got["_plane"] == "mesh_pallas"
            assert_identical(got, full.search(dict(body)))
            assert_same_hits(jidx.search(dict(body)), got)
            assert "9" not in [h["_id"] for h in got["hits"]["hits"]]
            ms = delta._mesh_search
            # one append fills the headroom; the third refresh rebuilds
            assert ms.delta_restage_total == 1
            assert ms.tombstone_update_total >= 1
        finally:
            for idx in (delta, full, jidx):
                idx.close()


class TestCompaction:
    def test_compact_merges_sparse_slots_and_releases_old_generation(self):
        idx = build_index("tcp-run", compact=0.0)
        try:
            _fill(idx, 0, 48)
            idx.search(dict(MATCH))
            ms = idx._mesh_search
            scope0 = ms._executor.scope
            for d in range(0, 12):
                idx.delete_doc(str(d))
            idx.refresh()
            idx.search(dict(MATCH))
            # any shard with a tombstone is dense at this threshold
            idx._compact_threshold = lambda: 0.01
            out = idx.compact_now()
            assert out["ran"] is True, out
            assert out["merged_shards"], out
            assert out["restaged"] is True
            assert ms.compaction_runs_total == 1
            assert ms._executor.scope != scope0
            assert not [r for r in memory_accountant().table()
                        if r["index"] == "tcp-run"
                        and r["segment"] == scope0]
            events = memory_accountant().stats("tcp-run")["staging_events"]
            assert any(e["reason"] == "compaction" for e in events)
            r = idx.search({"query": {"match": {"body": "common"}},
                            "size": 48})
            assert r["hits"]["total"] == 36
            stats = ms.staging_slot_stats()
            assert all(s["tombstone_density"] == 0.0 for s in stats["slots"])
        finally:
            idx.close()

    def test_compaction_single_flight(self):
        idx = build_index("tcp-single", compact=0.2)
        try:
            _fill(idx, 0, 24)
            idx.search(dict(MATCH))
            with idx._compact_lock:
                assert idx.compact_now() == {
                    "ran": False, "reason": "already_running"}
                for d in range(0, 24, 2):
                    idx.delete_doc(str(d))
                idx.refresh()
                assert idx._compaction_due()
                assert idx.maybe_compact_async() is False
            idx.close()
            assert idx.compact_now() == {"ran": False, "reason": "closing"}
        finally:
            idx.close()

    def test_compact_noop_below_threshold(self):
        idx = build_index("tcp-noop", compact=0.9)
        try:
            _fill(idx, 0, 24)
            idx.search(dict(MATCH))
            assert idx.maybe_compact_async() is False
        finally:
            idx.close()


class TestLedgerExactness:
    def test_leak_free_across_append_tombstone_compact_cycle(self):
        acc = memory_accountant()
        base = acc.stats()["staged_bytes_total"]
        idx = build_index("tlg-cycle", compact=0.2)
        try:
            _fill(idx, 0, 48)
            idx.search(dict(MATCH))
            _fill(idx, 48, 60)  # delta append
            idx.search(dict(MATCH))
            for d in range(20):
                idx.delete_doc(str(d))  # tombstone, then compaction
            idx.refresh()
            idx.search(dict(MATCH))
            idx.compact_now()
            r = idx.search(dict(MATCH))
            assert r["hits"]["total"] == 40
            assert acc.stats("tlg-cycle")["staged_bytes_total"] > 0
        finally:
            idx.close()
        assert acc.stats()["staged_bytes_total"] == base
        assert acc.stats("tlg-cycle")["staged_bytes_total"] == 0

    def test_mid_delta_fault_restores_exact_pre_attempt_ledger(self):
        idx = build_index("tlg-fault")
        try:
            _fill(idx, 0, 48)
            idx.search(dict(MATCH))
            ms = idx._mesh_search
            scope0 = ms._executor.scope
            snapshot = _mesh_rows("tlg-fault")
            scheme = StagingFailScheme(kinds=["mesh_slot_tables"],
                                       transient=False, times=1,
                                       indices=["tlg-fault"]).install()
            _fill(idx, 48, 60)
            r = idx.search(dict(MATCH))
            assert scheme.hits == 1
            assert r["hits"]["total"] == 60
            assert r["_plane"] != "mesh_pallas"
            assert _mesh_rows("tlg-fault") == snapshot
            assert ms._executor is not None
            assert ms._executor.scope == scope0
            assert ms.delta_restage_total == 0
            assert (idx.search_stats()["planes"]["decisions"]
                    .get("host.staging_fault", 0) >= 1)
        finally:
            idx.close()

    def test_mid_tombstone_fault_restores_exact_pre_attempt_ledger(self):
        idx = build_index("tlg-tfault")
        try:
            _fill(idx, 0, 48)
            idx.search(dict(MATCH))
            ms = idx._mesh_search
            snapshot = _mesh_rows("tlg-tfault")
            live_before = ms._executor._seg_staged["live1"]
            StagingFailScheme(kinds=["live_mask"], transient=False, times=1,
                              indices=["tlg-tfault"]).install()
            idx.delete_doc("3")
            idx.refresh()
            r = idx.search(dict(MATCH))
            assert r["hits"]["total"] == 47  # the host rung serves truth
            assert _mesh_rows("tlg-tfault") == snapshot
            assert ms.tombstone_update_total == 0
            # nothing published: the generation keeps its old masks
            assert ms._executor._seg_staged["live1"] is live_before
        finally:
            idx.close()


class TestSettingsPlumbing:
    def test_counters_exported_in_search_stats(self):
        idx = build_index("tst-exp")
        try:
            _fill(idx, 0, 24)
            idx.search(dict(MATCH))
            _fill(idx, 24, 30)
            idx.delete_doc("1")
            idx.refresh()
            idx.search(dict(MATCH))
            stats = idx.search_stats()
            planes = stats["planes"]
            assert planes["delta_restage_total"] == 1
            assert planes["tombstone_update_total"] == 1
            assert planes["compaction_runs_total"] == 0
            mem = stats["memory"]
            assert (mem["staged_bytes_total"]
                    == sum(mem["staged_bytes"].values()) > 0)
        finally:
            idx.close()

    def test_cat_staging_shows_slot_columns(self):
        from elasticsearch_tpu_torch.node import Node
        from elasticsearch_tpu_torch.rest.controller import RestController

        node = Node(device="cpu")
        ctrl = RestController(node)
        try:
            node.create_index("cat-d", {"settings": {"index": {
                "number_of_shards": 2, "refresh_interval": -1}},
                "mappings": {"_doc": MAPPING}})
            svc = node.indices["cat-d"]
            _fill(svc, 0, 24)
            for d in range(3):
                svc.delete_doc(str(d))
            svc.refresh()
            svc.search(dict(MATCH))
            status, out = ctrl.dispatch("GET", "/_cat/staging",
                                        {"v": "true"}, None)
            assert status == 200
            lines = out.splitlines()
            header = lines[0].split()
            assert header[:4] == ["index", "segment", "kind", "bytes"]
            assert "free_slots_per_dev" in header
            assert "tombstone_density" in header
            scope = svc._mesh_search._executor.scope
            assert any(f"{scope}/slot0" in line for line in lines)
            assert any("cat-d" in line and "mesh_slot_tables" in line
                       and line.split()[7] == "*" for line in lines)
            status, rows = ctrl.dispatch("GET", "/_cat/staging",
                                         {"format": "json"}, None)
            assert status == 200
            slot_rows = [r for r in rows if r["kind"] == "slot"]
            assert sum(float(r["tombstone_density"]) > 0
                       for r in slot_rows) >= 1
        finally:
            node.close()


def test_replaced_generations_free_without_the_cycle_collector():
    """A generation the append, the rebuild or the close replaces frees as
    soon as nothing holds it (its eviction callback holds it weakly)."""
    import gc
    import weakref

    idx = build_index("tfree")
    gc.disable()
    try:
        _fill(idx, 0, 24)
        idx.search(dict(MATCH))
        first = weakref.ref(idx._mesh_search._executor)
        _fill(idx, 24, 36)  # an append replaces the first generation
        idx.search(dict(MATCH))
        assert idx._mesh_search.delta_restage_total == 1
        assert first() is None
        second = weakref.ref(idx._mesh_search._executor)
        idx.close()
        assert second() is None
    finally:
        gc.enable()
        idx.close()


def test_concurrent_queries_see_one_generation_per_change():
    """Queries racing an append and a delete all answer from a complete
    generation: every response equals one of the two legal answers."""
    idx = build_index("tconc")
    try:
        _fill(idx, 0, 48)
        before = idx.search({"query": {"match": {"body": "common"}},
                             "size": 60})
        _fill(idx, 48, 60)
        got = []

        def worker():
            got.append(idx.search({"query": {"match": {"body": "common"}},
                                   "size": 60}))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert len(got) == 8
        assert {r["hits"]["total"] for r in got} == {60}
        assert before["hits"]["total"] == 48
        assert idx._mesh_search.delta_restage_total == 1
    finally:
        idx.close()


def test_tombstones_racing_a_query_leave_its_masks_whole(monkeypatch):
    """A delete on every shard is published as tombstones on the
    generation a query is running on, between the query's first slot and
    its second. The query reads one snapshot of the live masks from its
    start: its total is the count before the deletes and equals its hit
    count; the next query sees every delete."""
    from elasticsearch_tpu_torch.search import plan as P

    idx = build_index("ttear")
    body = {"query": {"match": {"body": "common"}}, "size": 60,
            "aggs": {"mx": {"max": {"field": "n"}}}}
    try:
        _fill(idx, 0, 48)
        first = idx.search(dict(body))
        assert first["_plane"] == "mesh_pallas"
        assert first["hits"]["total"] == 48
        ms = idx._mesh_search
        executor = ms._executor
        victims = [seg.doc_ids[0] for _sid, seg in executor.pairs]
        assert len(victims) == idx.num_shards

        def tombstone():
            for d in victims:
                idx.delete_doc(d)
            idx.refresh()
            assert ms._ensure_staged() is executor  # tombstoned in place

        real = P.execute
        calls = []

        def racing(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:  # the racing query's first slot
                th = threading.Thread(target=tombstone)
                th.start()
                th.join(60)
                assert not th.is_alive()
            return real(*args, **kwargs)

        monkeypatch.setattr(P, "execute", racing)
        raced = idx.search(dict(body))
        monkeypatch.setattr(P, "execute", real)
        assert ms.tombstone_update_total == 1
        assert raced["_plane"] == "mesh_pallas"
        assert raced["hits"]["total"] == len(raced["hits"]["hits"]) == 48
        after = idx.search(dict(body))
        assert after["hits"]["total"] == len(after["hits"]["hits"]) == 45
        assert not {h["_id"] for h in after["hits"]["hits"]} & set(victims)
    finally:
        idx.close()
