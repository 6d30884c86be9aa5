"""The store and device scrubber of the port against the JAX package.

Mirrors ``tests/test_corruption.py`` without ``TestClusterHealOutcomes``
(the cluster's re-recovery is not ported) and without its snapshot cases
(``tests/test_torch_snapshots.py`` holds those): the corruption marker's
lifecycle, the scrubber's disk pass over every corruption kind of
``StoreCorruptionScheme``, its device pass over every staged table kind
(``block_docs``, ``block_tfs``, ``norms`` copied back and hashed against
host truth), the partial answer of a quarantined shard, the
``index.scrub.interval`` knob and thread, and the ``integrity`` block of
``_stats`` and ``_cat/shards``' integrity column. Each case runs on a JAX
``IndexService`` and a port one over the same documents; reports,
counters and answers must agree exactly, scores within rtol 1e-5.
"""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import (
    SearchPhaseExecutionException as JSearchPhaseExecutionException,
)
from elasticsearch_tpu.common.integrity import integrity_service as jinteg
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index import store as jstore
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.testing import disruption as jdis
from elasticsearch_tpu_torch.common.errors import (
    SearchPhaseExecutionException,
)
from elasticsearch_tpu_torch.common.integrity import integrity_service
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index import store as tstore
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.testing import disruption as tdis
from torch_pair import NodePair

MAPPING = {"properties": {"body": {"type": "text"},
                          "n": {"type": "integer"}}}
JOIN_S = 60.0


def _jax_stage(seg, key, arr):
    import jax.numpy as jnp

    seg._device[key] = jnp.asarray(arr)


def _port_stage(seg, key, arr):
    seg._device[key] = torch.from_numpy(arr)


PKGS = (
    SimpleNamespace(
        name="jax", integ=jinteg, store=jstore, dis=jdis,
        phase_exc=JSearchPhaseExecutionException, stage=_jax_stage,
        load=lambda store: store.load_segments(),
        read=lambda store, name: store.read_segment(name),
        index=lambda name, s, path: JIndex(name, JSettings(s),
                                           mapping=MAPPING, data_path=path),
        node=lambda: JNode(JSettings({}))),
    SimpleNamespace(
        name="port", integ=integrity_service, store=tstore, dis=tdis,
        phase_exc=SearchPhaseExecutionException, stage=_port_stage,
        load=lambda store: store.load_segments("cpu"),
        read=lambda store, name: store.read_segment(name, "cpu"),
        index=lambda name, s, path: IndexService(
            name, Settings(s), mapping=MAPPING, device="cpu",
            data_path=path),
        node=lambda: Node(Settings({}), device="cpu")),
)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


def run_both(fn):
    return tuple(fn(pkg) for pkg in PKGS)


def mk_service(pkg, tmp_path, name="cx", shards=1, docs=20, **extra):
    svc = pkg.index(name, {"index.number_of_shards": shards,
                           "index.search.mesh": False,
                           "index.refresh_interval": -1, **extra},
                    str(tmp_path / pkg.name / name))
    for i in range(docs):
        svc.index_doc(str(i), {"body": f"alpha common doc{i}", "n": i})
    svc.refresh()
    svc.flush()
    return svc


def delta(before, after, key, site=None):
    if site is not None:
        return (after["corruption_detected_by_site"].get(site, 0)
                - before["corruption_detected_by_site"].get(site, 0))
    return after[key] - before[key]


def ranked(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def same_ranked(a, b):
    assert [i for i, _ in a] == [i for i, _ in b], (a, b)
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                               rtol=1e-5)


class TestMarkerLifecycle:
    def test_written_once_first_cause_wins(self, tmp_path):
        def run(pkg):
            store = pkg.store.Store(str(tmp_path / pkg.name))
            first = store.mark_corrupted("cause A", site="load")
            second = store.mark_corrupted("cause B", site="query")
            markers = store.corruption_markers()
            return (second["marker"] == first["marker"], len(markers),
                    markers[0]["reason"], markers[0]["site"],
                    markers[0]["marker"].startswith(pkg.store.MARKER_PREFIX))

        assert run_both(run) == ((True, 1, "cause A", "load", True),) * 2

    def test_marker_blocks_load_and_read(self, tmp_path):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, "mb", docs=8)
            try:
                store = svc.shards[0].engine.store
                names = (store.read_commit() or {}).get("segments", [])
                assert names
                store.mark_corrupted("bit rot", site="scrub")
                with pytest.raises(pkg.store.CorruptIndexException):
                    pkg.load(store)
                with pytest.raises(pkg.store.CorruptIndexException):
                    pkg.read(store, names[0])
                return len(names)
            finally:
                svc.close()

        j, t = run_both(run)
        assert t == j == 1

    def test_torn_marker_still_counts(self, tmp_path):
        def run(pkg):
            store = pkg.store.Store(str(tmp_path / pkg.name))
            name = pkg.store.MARKER_PREFIX + "torn.json"
            with open(os.path.join(store.directory, name), "w",
                      encoding="utf-8") as f:
                f.write('{"reason": "trunc')
            with pytest.raises(pkg.store.CorruptIndexException):
                store._check_not_corrupted()
            return store.is_corrupted(), store.corruption_markers()

        j, t = run_both(run)
        assert t == j == (True, [{"marker": "corrupted_torn.json"}])

    def test_clear_reopens_the_store(self, tmp_path):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, "cl", docs=8)
            try:
                store = svc.shards[0].engine.store
                store.mark_corrupted("transient", site="load")
                out = [store.is_corrupted(),
                       store.clear_corruption_markers(),
                       store.is_corrupted()]
                out.append(sum(s.num_docs for s in pkg.load(store)))
                return out
            finally:
                svc.close()

        j, t = run_both(run)
        assert t == j == [True, 1, False, 8]

    def test_marker_survives_later_commits(self, tmp_path):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, "gc", docs=8)
            try:
                store = svc.shards[0].engine.store
                marker = store.mark_corrupted("at-rest rot", site="scrub")
                for i in range(8, 16):
                    svc.index_doc(str(i), {"body": f"beta {i}", "n": i})
                svc.refresh()
                svc.flush()
                return ([m["marker"] for m in store.corruption_markers()]
                        == [marker["marker"]])
            finally:
                svc.close()

        assert run_both(run) == (True, True)

    def test_unquarantine_is_the_only_exit(self, tmp_path):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, "uq", docs=8)
            try:
                before = pkg.integ().stats()
                svc._quarantine_shard(
                    0, pkg.store.CorruptIndexException("injected"),
                    site="query")
                shard = svc.shards[0]
                held = (shard.store_corrupted,
                        shard.engine.store.is_corrupted())
                svc.unquarantine_shard(0)
                after = pkg.integ().stats()
                events = [e["action"] for e in after["marker_events"]
                          if e["index"] == "uq"][-3:]
                return (held, shard.store_corrupted,
                        shard.engine.store.is_corrupted(),
                        delta(before, after, "markers_written_total"),
                        delta(before, after, "markers_cleared_total"),
                        delta(before, after, None, "query"), events)
            finally:
                svc.close()

        j, t = run_both(run)
        assert t == j == ((True, True), False, False, 1, 1, 1,
                          ["detected", "marked", "cleared"])


class TestScrubAtRest:
    @pytest.mark.parametrize("kind", ["bitflip", "truncate",
                                      "torn_checksums", "missing_checksums"])
    def test_each_kind_detected_and_quarantined(self, tmp_path, kind):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, f"ar_{kind}"[:14], shards=2,
                             docs=24)
            try:
                store = svc.shards[0].engine.store
                pkg.dis.StoreCorruptionScheme(kind, seed=11).corrupt_store(
                    store)
                before = pkg.integ().stats()
                rep = svc.scrub_now()
                after = pkg.integ().stats()
                rep2 = svc.scrub_now()
                final = pkg.integ().stats()
                return (rep["checksum_failures"], rep["drift"],
                        svc.shards[0].store_corrupted, store.is_corrupted(),
                        delta(before, after, None, "scrub"),
                        delta(before, after, "markers_written_total"),
                        all(not s._device
                            for s in svc.shards[0].engine.segments),
                        rep2["checksum_failures"],
                        delta(after, final, "corruption_detected_total"),
                        delta(before, after, "scrub_runs_total"))
            finally:
                svc.close()

        j, t = run_both(run)
        assert t == j == (1, 0, True, True, 1, 1, True, 0, 0, 1)

    def test_clean_pass_verifies_every_committed_byte(self, tmp_path):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, "clean", shards=2, docs=24)
            try:
                before = pkg.integ().stats()
                rep = svc.scrub_now()
                after = pkg.integ().stats()
                disk = 0
                for sh in svc.shards.values():
                    store = sh.engine.store
                    for name in store.read_commit()["segments"]:
                        disk += store.verify_segment(name)
                return (rep["checksum_failures"], rep["drift"],
                        rep["bytes_verified"] == disk > 0,
                        delta(before, after, "scrub_bytes_verified_total")
                        == disk)
            finally:
                svc.close()

        j, t = run_both(run)
        assert t == j == (0, 0, True, True)


class TestScrubDeviceDrift:
    @pytest.mark.parametrize("key", ["block_docs", "block_tfs", "norms"])
    def test_each_staged_table_kind(self, tmp_path, key):
        probe = {"query": {"match": {"body": "alpha"}}}

        def run(pkg):
            svc = mk_service(pkg, tmp_path, f"dr_{key[:7]}", docs=16)
            try:
                want = ranked(svc._search_uncached(dict(probe),
                                                   skip_mesh=True))
                seg = next(s for sh in svc.shards.values()
                           for s in sh.engine.segments if s._device)
                drifted = np.array(seg._device[key]).copy()
                drifted.flat[0] += 1
                pkg.stage(seg, key, drifted)
                before = pkg.integ().stats()
                rep = svc.scrub_now()
                after = pkg.integ().stats()
                got = ranked(svc._search_uncached(dict(probe),
                                                  skip_mesh=True))
                ev = [e for e in after["marker_events"]
                      if e["index"] == svc.name][-1]
                return (rep["drift"], rep["checksum_failures"],
                        delta(before, after, "scrub_drift_total"),
                        delta(before, after, "scrub_runs_total"),
                        delta(before, after, "scrub_bytes_verified_total")
                        > 0,
                        delta(before, after, "corruption_detected_total"),
                        svc.shards[0].store_corrupted,
                        seg.stage_reason_initial, (ev["action"], ev["site"],
                                                   ev["reason"]),
                        want, got)
            finally:
                svc.close()

        j, t = run_both(run)
        assert t[:9] == j[:9]
        assert t[:8] == (1, 0, 1, 1, True, 0, False, "scrub")
        assert t[8][:2] == ("drift", "scrub") and key in t[8][2]
        same_ranked(t[9], j[9])
        assert t[10] == t[9]  # host truth adopted again

    def test_restage_after_drift_is_recorded_with_the_scrub_reason(
            self, tmp_path):
        svc = mk_service(PKGS[1], tmp_path, "drreason", docs=16)
        try:
            from elasticsearch_tpu_torch.common.memory import (
                memory_accountant,
            )

            probe = {"query": {"match": {"body": "alpha"}}}
            svc.search(dict(probe))
            seg = svc.shards[0].engine.segments[0]
            # a copy: on the CPU the staged tensor may share the host array
            drifted = seg._device["block_docs"].clone()
            drifted[0, 0] += 1
            seg._device["block_docs"] = drifted
            assert svc.scrub_now()["drift"] == 1
            svc.search(dict(probe))
            reasons = [e["reason"] for e in memory_accountant().stats(
                "drreason")["staging_events"]]
            assert "scrub" in reasons
        finally:
            svc.close()


def _always_corrupt(exc):
    def query(*_a, **_k):
        raise exc("injected: torn posting block")
    return query


class TestQueryPartialContract:
    def test_corrupt_shard_becomes_failures_entry(self, tmp_path):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, "qp", shards=2, docs=24)
            try:
                svc.shards[0].searcher.query = _always_corrupt(
                    pkg.store.CorruptIndexException)
                before = pkg.integ().stats()
                r = svc.search({"query": {"match": {"body": "alpha"}}})
                after = pkg.integ().stats()
                r2 = svc.search({"query": {"match": {"body": "alpha"}}})
                final = pkg.integ().stats()
                return (r["_shards"], ranked(r), svc.shards[0].store_corrupted,
                        svc.shards[0].engine.store.is_corrupted(),
                        delta(before, after, "corruption_detected_total"),
                        delta(before, after, None, "query"),
                        r2["_shards"]["failed"],
                        delta(after, final, "corruption_detected_total"))
            finally:
                svc.close()

        j, t = run_both(run)
        assert t[2:] == j[2:] == (True, True, 1, 1, 1, 0)
        same_ranked(t[1], j[1])
        assert t[0]["failed"] == j[0]["failed"] == 1
        assert t[0]["successful"] == j[0]["successful"] == 1
        assert "corrupt" in str(t[0]["failures"]).lower()

    @pytest.mark.parametrize("shards,extra", [
        (1, {}), (2, {"allow_partial_search_results": False})])
    def test_no_partial_answer_raises(self, tmp_path, shards, extra):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, f"qp{shards}", shards=shards,
                             docs=24)
            try:
                svc.shards[0].searcher.query = _always_corrupt(
                    pkg.store.CorruptIndexException)
                with pytest.raises(pkg.phase_exc) as ei:
                    svc.search({"query": {"match": {"body": "alpha"}},
                                **extra})
                return ei.value.status_code
            finally:
                svc.close()

        j, t = run_both(run)
        assert t == j


class TestScrubIntervalKnob:
    def test_dynamic_update_and_cluster_override(self):
        def run(pkg):
            node = pkg.node()
            try:
                node.create_index("si", {"settings": {"number_of_shards": 1},
                                         "mappings": MAPPING})
                svc = node.indices["si"]
                out = [svc._scrub_effective_interval()]
                node.update_index_settings(
                    "si", {"index.scrub.interval": "30s"})
                out.append(svc._scrub_effective_interval())
                node.put_cluster_settings(
                    {"persistent": {"index.scrub.interval": "5s"}})
                out += [svc.scrub_interval_override,
                        svc._scrub_effective_interval()]
                node.put_cluster_settings(
                    {"persistent": {"index.scrub.interval": None}})
                out += [svc.scrub_interval_override,
                        svc._scrub_effective_interval()]
                return out
            finally:
                node.close()

        assert run_both(run) == ([None, 30.0, 5.0, 5.0, None, 30.0],) * 2

    def test_the_thread_scrubs_on_its_interval(self, tmp_path):
        def run(pkg):
            svc = mk_service(pkg, tmp_path, "tick", docs=8,
                             **{"index.scrub.interval": "20ms"})
            try:
                integ = pkg.integ()
                runs0 = integ.stats()["scrub_runs_total"]
                tick = threading.Event()
                deadline = time.monotonic() + JOIN_S
                while integ.stats()["scrub_runs_total"] < runs0 + 2:
                    assert time.monotonic() < deadline
                    tick.wait(0.005)
                return True
            finally:
                svc.close()

        assert run_both(run) == (True, True)
        # the port's close joined its thread
        svc = mk_service(PKGS[1], tmp_path, "tick2", docs=2)
        svc.close()
        assert not svc._scrub_thread.is_alive()


class TestOperatorSurfaces:
    def test_cat_shards_integrity_column_and_stats_block(self, tmp_path):
        pair = NodePair(data_paths=(str(tmp_path / "j"), str(tmp_path / "t")))
        try:
            pair.same("PUT", "/rx", {"settings": {"number_of_shards": 2},
                                     "mappings": {"_doc": MAPPING}})
            pair.same("POST", "/_bulk", b"".join(
                b'{"index":{"_index":"rx","_id":"%d"}}\n'
                b'{"body":"alpha %d","n":%d}\n' % (i, i, i)
                for i in range(10)), params={"refresh": "true"})
            texts = []
            for node in (pair.j, pair.t):
                node.indices["rx"].flush()
                node.indices["rx"].shards[0].engine.store.mark_corrupted(
                    "bit rot", site="scrub")
            (js, jb), (ts, tb) = pair.call("GET", "/_cat/shards",
                                           params={"h": "shard,integrity"})
            assert js == ts == 200
            for text in (jb, tb):
                rows = sorted(line.split() for line in text.splitlines())
                texts.append([(r[0], r[1].startswith("corrupted_"))
                              for r in rows])
            assert texts[1] == texts[0] == [("0", True), ("1", False)]
            (js, jb), (ts, tb) = pair.call("GET", "/rx/_stats")
            jblk = jb["indices"]["rx"]["total"]["search"]["integrity"]
            tblk = tb["indices"]["rx"]["total"]["search"]["integrity"]
            assert set(tblk) == set(jblk)
            assert set(tblk["corruption_detected_by_site"]) == set(
                jblk["corruption_detected_by_site"])
        finally:
            pair.close()
