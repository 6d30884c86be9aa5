"""The device fault schemes of the port against the JAX package.

Mirrors ``TestKernelLaunchFail``, ``TestEvictionStorm`` and
``TestSingleFlightProbe`` of ``tests/test_device_faults.py`` and the
plane-quarantine cases of ``tests/test_search_fault_tolerance.py``. The
same documents go to a JAX ``IndexService`` (the tile kernel in interpret
mode) and a port one on the CPU; a scheme is installed in each package's
registry, and the served plane, the answers, the scheme's hits and the
plane-health counters (failures by plane and reason, probes, the
quarantined planes) must agree exactly, scores within rtol 1e-5.

A cooldown is ended by moving the plane's quarantine deadline to the
past (``PlaneHealth._quarantined_until``), never by sleeping it out; the
concurrent burst waits on a barrier and joins with a time limit.
"""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from elasticsearch_tpu.common.memory import memory_accountant as jmem
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.testing import disruption as jdis
from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.common.memory import memory_accountant as tmem
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError
from elasticsearch_tpu_torch.testing import disruption as tdis
from test_torch_rest import assert_same_body
from torch_pair import NodePair

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "vec": {"type": "dense_vector", "dims": 8},
    "n": {"type": "integer"},
}}
BODY = {"query": {"match": {"body": "w1"}}, "size": 5}
JOIN_S = 60.0
PKGS = (
    SimpleNamespace(name="jax", dis=jdis, mem=jmem,
                    index=lambda n, s: JIndex(n, JSettings(s),
                                              mapping=MAPPING)),
    SimpleNamespace(name="port", dis=tdis, mem=tmem,
                    index=lambda n, s: IndexService(
                        n, Settings(s), mapping=MAPPING, device="cpu")),
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    for pkg in PKGS:
        pkg.dis.clear_search_disruptions()
    yield
    for pkg in PKGS:
        pkg.dis.clear_search_disruptions()


def make_index(pkg, name, shards=3, cooldown="60s", plane="pallas",
               docs=30, **extra):
    idx = pkg.index(name, {
        "index.number_of_shards": shards,
        "index.search.mesh.plane": plane,
        "index.search.plane_quarantine.cooldown": cooldown,
        "index.search.mesh.max_slots_per_device": 16,
        "index.refresh_interval": -1, **extra})
    for d in range(docs):
        idx.index_doc(str(d), {"body": f"w{d % 5} common x{d % 11}",
                               "n": d,
                               "vec": [float((d + j) % 7) for j in
                                       range(8)]})
    idx.refresh()
    return idx


def run_both(fn):
    """fn(pkg) on each package, the index closed after; (jax, port)."""
    return tuple(fn(pkg) for pkg in PKGS)


def ranked(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def same_ranked(a, b):
    assert [i for i, _ in a] == [i for i, _ in b], (a, b)
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                               rtol=1e-5)


def health(idx):
    planes = idx.search_stats()["planes"]
    return {k: planes[k] for k in ("plane_failures_total",
                                   "plane_failures_by_reason",
                                   "plane_probes_total",
                                   "plane_quarantined")}


def end_cooldown(idx, plane="mesh_pallas"):
    h = idx._mesh_search.plane_health
    with h._lock:
        h._quarantined_until[plane] = time.monotonic() - 1.0


class TestKernelLaunchFail:
    """The port's scheme raises ``KernelError`` on a kernel rung, as a
    real launch failure does: the request fails and no rung serves in the
    kernel's place, where the JAX package's scheme (a plane fault)
    quarantines mesh_pallas and serves from the host rung. The next
    request, with the scheme spent, is served by the kernel and holds the
    JAX package's answer."""

    CASES = {
        "mesh_pallas": (BODY, {}),
        "knn": ({"knn": {"field": "vec", "query_vector": [1.0] * 8,
                         "k": 5}}, {}),
        "pruned": ({"query": {"match": {"body": "w1 x3"}}, "size": 5},
                   {"search.pallas.pruning.enabled": True,
                    "search.pallas.pruning.probe_tiles": 2}),
    }

    @pytest.mark.parametrize("rung", sorted(CASES))
    def test_rung_selective_fault_raises_kernel_error(self, rung):
        body, extra = self.CASES[rung]
        docs = 2400 if rung == "pruned" else 30

        def run(pkg):
            idx = make_index(pkg, f"dfl_{rung}", docs=docs, **extra)
            try:
                idx._search_uncached(dict(body), skip_mesh=True)
                before = idx.search(dict(body))
                # a launch of another rung is untouched
                other = pkg.dis.KernelLaunchFailScheme(
                    rungs=("batched",), indices=[idx.name]).install()
                scheme = pkg.dis.KernelLaunchFailScheme(
                    rungs=(rung,), times=1, indices=[idx.name]).install()
                try:
                    r = idx.search(dict(body))
                except Exception as e:  # noqa: BLE001 — the port's fault
                    r = e
                faulted = health(idx)
                after = idx.search(dict(body))
                other.remove()
                return (before["_plane"], before.get("_pruned") is not None,
                        r, ranked(before), ranked(after), after["_plane"],
                        scheme.hits, other.hits, faulted)
            finally:
                idx.close()

        j, t = run_both(run)
        # JAX: a plane fault, quarantined, served from the host rung
        assert j[:2] == t[:2] == ("mesh_pallas", rung == "pruned")
        assert j[2]["_plane"] == "host" and j[6:8] == (1, 0)
        assert j[8]["plane_failures_by_reason"] == {"kernel_fault": 1}
        assert j[8]["plane_quarantined"] == ["mesh_pallas"]
        # the port: the launch failure reaches the caller as a 500
        assert isinstance(t[2], KernelError) and t[6:8] == (1, 0)
        assert not isinstance(t[2], ElasticsearchTpuException)
        assert t[8]["plane_failures_total"].get("mesh_pallas", 0) == 0
        assert t[8]["plane_quarantined"] == []
        # nothing was benched: the kernel serves the next request
        assert t[5] == "mesh_pallas"
        same_ranked(t[3], j[3])
        same_ranked(t[4], t[3])
        same_ranked(t[4], ranked(j[2]))

    def test_scatter_launch_fault_quarantines(self):
        """The scatter rung launches no hand-written kernel: its launch
        fault is a plane fault in both packages."""
        def run(pkg):
            idx = make_index(pkg, "dflmesh", plane="scatter")
            try:
                idx._search_uncached(dict(BODY), skip_mesh=True)
                before = idx.search(dict(BODY))
                scheme = pkg.dis.KernelLaunchFailScheme(
                    rungs=("mesh",), times=1, indices=["dflmesh"]).install()
                r = idx.search(dict(BODY))
                return (before["_plane"], r["_plane"], ranked(r),
                        r["hits"]["total"], scheme.hits, health(idx))
            finally:
                idx.close()

        j, t = run_both(run)
        assert t[:2] == j[:2] == ("mesh", "host")
        assert t[3:] == j[3:]
        same_ranked(t[2], j[2])
        assert t[4] == 1 and t[5]["plane_quarantined"] == ["mesh"]
        assert t[5]["plane_failures_by_reason"] == {"kernel_fault": 1}

    def test_batched_launch_fault_fails_every_member(self):
        burst = [{"query": {"match": {"body": f"w{i}"}}, "size": 4}
                 for i in range(3)]

        def run(pkg):
            idx = make_index(pkg, "dflbatch")
            try:
                want = [ranked(idx.search(dict(b))) for b in burst]
                scheme = pkg.dis.KernelLaunchFailScheme(
                    rungs=("batched",), times=1,
                    indices=["dflbatch"]).install()
                try:
                    out = idx.search_batch([dict(b) for b in burst])
                except Exception as e:  # noqa: BLE001 — the port's fault
                    out = e
                faulted = health(idx)
                again = idx.search_batch([dict(b) for b in burst])
                return (out, want, scheme.hits, faulted,
                        [(r["_plane"], ranked(r)) for r in again])
            finally:
                idx.close()

        j, t = run_both(run)
        assert j[2] == t[2] == 1
        assert j[3]["plane_failures_total"]["mesh_pallas"] == 1
        for got, want in zip(j[0], j[1]):
            same_ranked(ranked(got), want)
        # the port: the launch failure fails the batch (the micro-batcher
        # hands it to every member), nothing benched
        assert isinstance(t[0], KernelError)
        assert t[3]["plane_failures_total"].get("mesh_pallas", 0) == 0
        assert t[3]["plane_quarantined"] == []
        for (plane, got), want, jwant in zip(t[4], t[1], j[1]):
            assert plane == "mesh_pallas"
            same_ranked(got, want)
            same_ranked(got, jwant)

    def test_kernel_launch_fault_answers_500_over_rest(self):
        """Over REST the port's launch failure answers a 500 and the next
        request is served by the kernel (the JAX node serves both)."""
        pair = NodePair()
        try:
            pair.same("PUT", "/dflrest", {
                "settings": {"number_of_shards": 3,
                             "index.search.mesh.plane": "pallas"},
                "mappings": {"_doc": MAPPING}}, status=200)
            for d in range(20):
                pair.same("PUT", f"/dflrest/_doc/{d}",
                          {"body": f"w{d % 5} common"})
            pair.same("POST", "/dflrest/_refresh")
            want = pair.same("POST", "/dflrest/_search", dict(BODY),
                             status=200)
            assert want["_shards"]["failed"] == 0
            schemes = [pkg.dis.KernelLaunchFailScheme(
                rungs=("mesh_pallas",), times=1,
                indices=["dflrest"]).install() for pkg in PKGS]
            (js, jb), (ts, tb) = pair.call("POST", "/dflrest/_search",
                                           dict(BODY))
            assert js == 200 and ts == 500, (js, ts, tb)
            assert tb["status"] == 500
            assert "kernel launch [mesh_pallas] fault" in json.dumps(tb)
            assert [s.hits for s in schemes] == [1, 1]
            assert pair.t.indices["dflrest"].search_stats()["planes"][
                "plane_quarantined"] == []
            again = pair.same("POST", "/dflrest/_search", dict(BODY),
                              status=200)
            assert_same_body(jb, again, "the port after its fault")
            assert_same_body(want, again, "the port before and after")
        finally:
            pair.close()


class TestPlaneQuarantine:
    def test_pallas_fault_serves_from_mesh_rung(self):
        def run(pkg):
            idx = make_index(pkg, "pqpal", plane="auto")
            try:
                assert idx.search(dict(BODY))["_plane"] == "mesh_pallas"
                pkg.dis.PlaneFailScheme(planes=("mesh_pallas",),
                                        indices=["pqpal"]).install()
                r = idx.search(dict(BODY))
                return r["_plane"], ranked(r), health(idx)
            finally:
                idx.close()

        j, t = run_both(run)
        assert t[0] == j[0] == "mesh" and t[2] == j[2]
        same_ranked(t[1], j[1])
        assert t[2]["plane_quarantined"] == ["mesh_pallas"]

    def test_mesh_fault_quarantines_then_recovers(self):
        def run(pkg):
            idx = make_index(pkg, "pqmesh", plane="scatter")
            try:
                idx._search_uncached(dict(BODY), skip_mesh=True)
                planes = [idx.search(dict(BODY))["_plane"]]
                scheme = pkg.dis.PlaneFailScheme(
                    planes=("mesh",), indices=["pqmesh"]).install()
                r = idx.search(dict(BODY))
                planes.append(r["_plane"])
                benched = health(idx)
                scheme.remove()
                # still benched inside the cooldown: no re-paid fault
                planes.append(idx.search(dict(BODY, size=6))["_plane"])
                end_cooldown(idx, "mesh")
                planes.append(idx.search(dict(BODY, size=7))["_plane"])
                return planes, r["hits"]["total"], benched, health(idx)
            finally:
                idx.close()

        j, t = run_both(run)
        assert t == j
        assert t[0] == ["mesh", "host", "host", "mesh"] and t[1] == 6
        assert t[2]["plane_failures_total"]["mesh"] == 1
        assert t[2]["plane_quarantined"] == ["mesh"]
        assert t[3]["plane_quarantined"] == []

    def test_pallas_pref_quarantine_skips_scatter(self):
        def run(pkg):
            idx = make_index(pkg, "pqpin")
            try:
                planes = [idx.search(dict(BODY))["_plane"]]
                pkg.dis.PlaneFailScheme(planes=("mesh_pallas",),
                                        indices=["pqpin"]).install()
                r = idx.search(dict(BODY))
                planes.append(r["_plane"])
                pkg.dis.clear_search_disruptions()
                planes.append(idx.search(dict(BODY, size=6))["_plane"])
                return planes, r["hits"]["total"]
            finally:
                idx.close()

        j, t = run_both(run)
        assert t == j == (["mesh_pallas", "host", "host"], 6)

    def test_fault_decisions_and_events_match_jax(self):
        def run(pkg):
            idx = make_index(pkg, "pqdec", plane="auto")
            try:
                idx.search(dict(BODY))
                pkg.dis.PlaneFailScheme(planes=("mesh_pallas", "mesh"),
                                        indices=["pqdec"]).install()
                idx.search(dict(BODY))
                stats = idx.search_stats()
                events = stats["planes"]["quarantine_events"]
                return (stats["phases"]["decisions"],
                        [(e["plane"], e["reason"]) for e in events])
            finally:
                idx.close()

        j, t = run_both(run)
        assert t == j
        assert t[0]["mesh_pallas.fault"] == 1 and t[0]["mesh.fault"] == 1
        assert t[1] == [("mesh_pallas", "kernel_fault"),
                        ("mesh", "kernel_fault")]


class TestEvictionStorm:
    def test_forced_eviction_restages_byte_identically(self):
        def run(pkg):
            idx = make_index(pkg, "dfstorm")
            try:
                baseline = idx.search(dict(BODY))
                acct = pkg.mem()
                ev_before = acct.evictions_total
                scheme = pkg.dis.EvictionStormScheme(
                    period=1, indices=["dfstorm"]).install()
                stormed = idx.search(dict(BODY))
                evicted = acct.evictions_total > ev_before
                scheme.remove()
                after = idx.search(dict(BODY))
                return (baseline["_plane"], ranked(baseline),
                        stormed["_plane"], stormed["_shards"]["failed"],
                        ranked(stormed), ranked(after), evicted,
                        scheme.hits, scheme.calls, scheme.evicted_bytes > 0)
            finally:
                idx.close()

        j, t = run_both(run)
        for k in (0, 2, 3, 6, 7, 8, 9):
            assert t[k] == j[k], k
        assert t[0] == "mesh_pallas" and t[3] == 0
        assert t[6] and t[7] == t[8] == 1 and t[9]
        for got, jgot in ((t[1], j[1]), (t[4], j[4]), (t[5], j[5])):
            same_ranked(got, jgot)
        assert t[4] == t[1] and t[5] == t[1]

    def test_period_skips_queries(self):
        def run(pkg):
            idx = make_index(pkg, "dfperiod")
            try:
                scheme = pkg.dis.EvictionStormScheme(
                    period=3, indices=["dfperiod"]).install()
                for i in range(7):
                    idx.search(dict(BODY, size=i + 1))
                return scheme.calls, scheme.hits
            finally:
                idx.close()

        assert run_both(run) == ((7, 2), (7, 2))


class TestSingleFlightProbe:
    def test_one_probe_for_concurrent_burst(self):
        def run(pkg):
            idx = make_index(pkg, "dfprobe")
            try:
                idx._search_uncached(dict(BODY), skip_mesh=True)
                assert idx.search(dict(BODY))["_plane"] == "mesh_pallas"
                scheme = pkg.dis.PlaneFailScheme(
                    planes=("mesh_pallas",), indices=["dfprobe"]).install()
                assert idx.search(dict(BODY))["_plane"] == "host"
                h = idx._mesh_search.plane_health
                end_cooldown(idx)
                n = 6
                go = threading.Barrier(n)
                results, errors = [], []

                def worker():
                    go.wait(JOIN_S)
                    try:
                        results.append(idx._search_uncached(dict(BODY)))
                    except Exception as e:  # noqa: BLE001 — asserted
                        errors.append(e)

                threads = [threading.Thread(target=worker)
                           for _ in range(n)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(JOIN_S)
                assert not any(th.is_alive() for th in threads)
                assert not errors, errors
                burst = (sorted(r["_plane"] for r in results),
                         {r["hits"]["total"] for r in results},
                         scheme.hits, h.failures_total["mesh_pallas"],
                         h.probes_total)
                scheme.remove()
                end_cooldown(idx)
                healed = idx.search(dict(BODY))["_plane"]
                return burst, healed, h.quarantined(), health(idx)[
                    "plane_probes_total"]
            finally:
                idx.close()

        j, t = run_both(run)
        assert t == j
        assert t[0] == (["host"] * 6, {6}, 2, 2, 1)
        assert t[1:] == ("mesh_pallas", [], 2)

    def test_probe_released_when_plane_bails_cleanly(self):
        def run(pkg):
            idx = make_index(pkg, "dfrel")
            try:
                assert idx.search(dict(BODY))["_plane"] == "mesh_pallas"
                ms = idx._mesh_search
                ms.plane_health.record_failure("mesh_pallas")
                end_cooldown(idx)
                # the staging is benched too: the admitted probe bails
                # before any launch and hands its admission back
                ms._staging_fault_until = time.monotonic() + 60.0
                bailed = idx.search(dict(BODY))["_plane"]
                ms._staging_fault_until = 0.0
                return bailed, idx.search(dict(BODY))["_plane"]
            finally:
                idx.close()

        j, t = run_both(run)
        assert t == j == ("host", "mesh_pallas")
