"""The port's device-staging fault model (``common/staging.py``,
``testing/disruption.py``), mirroring the JAX package's
``tests/test_device_faults.py``.

A staging fault classifies transient (retried with bounded backoff) or
deterministic (the plane demotes at once and is quarantined with reason
``staging_fault``); a ``KernelError`` is no staging fault and raises
untouched. A fault at each staging boundary (the mesh slot tables, the
posting tables, the live masks, the embeddings, the doc-value columns)
leaves the device-memory ledger exactly as it was before the attempt, and
the index serves from the host rung and heals onto the mesh plane after
the cooldown; after a fault exactly one query of a concurrent burst
probes the restage. The JAX classification table holds for the inputs
both packages share; the port adds the CUDA allocator's shapes.

Left out until the port has a cluster settings API: the dynamic
``PUT _cluster/settings`` override of ``search.staging.retry.*``.
"""

import threading
import time

import pytest
import torch

from elasticsearch_tpu.common.staging import (
    TransientDeviceError as JTransientDeviceError,
)
from elasticsearch_tpu.common.staging import (
    classify_staging_fault as jclassify,
)
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import (
    SEARCH_STAGING_RETRY_MAX_ATTEMPTS,
    Settings,
)
from elasticsearch_tpu_torch.common.staging import (
    StagingBail,
    TransientDeviceError,
    classify_staging_fault,
    configure_staging_retry,
    run_staged,
    staging_retry_config,
)
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError
from elasticsearch_tpu_torch.testing.disruption import (
    StagingFailScheme,
    clear_search_disruptions,
)

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "vec": {"type": "dense_vector", "dims": 16},
    "n": {"type": "integer"},
    "tag": {"type": "keyword"},
}}


@pytest.fixture(autouse=True)
def _clean_schemes():
    clear_search_disruptions()
    yield
    clear_search_disruptions()
    configure_staging_retry(max_attempts=3, backoff_ms=10.0)


def make_index(name, shards=3, cooldown="150ms", plane="pallas",
               vectors=False, docs=30):
    idx = IndexService(name, Settings({
        "index.number_of_shards": shards,
        "index.search.mesh.plane": plane,
        "index.search.plane_quarantine.cooldown": cooldown,
        "index.refresh_interval": -1,
    }), mapping=MAPPING, device="cpu")
    for d in range(docs):
        doc = {"body": f"w{d % 5} common", "n": d,
               "tag": ["a", "b", "c"][d % 3]}
        if vectors:
            doc["vec"] = [float((d + j) % 7) for j in range(16)]
        idx.index_doc(str(d), doc)
    idx.refresh()
    return idx


def _snapshot(name):
    return memory_accountant().staged_bytes_by_kind(name)


BODY = {"query": {"match": {"body": "w1"}}, "size": 5}


# the JAX package's table (shared inputs) and the CUDA shapes the port adds
SHARED = [
    (lambda: TransientDeviceError("x"), "transient"),
    (lambda: MemoryError(), "transient"),
    (lambda: RuntimeError("RESOURCE_EXHAUSTED: out of memory while "
                          "allocating"), "transient"),
    (lambda: RuntimeError("transfer to device failed"), "transient"),
    (lambda: ValueError("bad shape"), "deterministic"),
    (lambda: TypeError("x"), "deterministic"),
    (lambda: RuntimeError("Mosaic lowering failed"), "deterministic"),
]
CUDA = [
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB"), "transient"),
    (lambda: RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"),
     "transient"),
    (lambda: RuntimeError("CUDA error: out of memory"), "transient"),
    (lambda: RuntimeError("CUDA error: an illegal memory access was "
                          "encountered"), "deterministic"),
    (lambda: RuntimeError("expected scalar type Float but found Half"),
     "deterministic"),
    (lambda: IndexError("index 9 is out of bounds"), "deterministic"),
]


@pytest.mark.parametrize("i", range(len(SHARED)))
def test_classification_matches_jax(i):
    make, want = SHARED[i]
    exc = make()
    assert classify_staging_fault(exc) == want
    jexc = (JTransientDeviceError(str(exc))
            if isinstance(exc, TransientDeviceError) else exc)
    assert jclassify(jexc) == want


@pytest.mark.parametrize("i", range(len(CUDA)))
def test_classification_of_cuda_shapes(i):
    make, want = CUDA[i]
    assert classify_staging_fault(make()) == want


class TestRunStaged:
    def test_transient_retries_then_succeeds(self):
        attempts = []

        def fn():
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("CUDA out of memory. Tried to allocate")
            return "ok"

        before = memory_accountant().staging_retries_total
        configure_staging_retry(max_attempts=3, backoff_ms=0.0)
        assert run_staged(fn, index="t", kind="postings_raw") == "ok"
        assert len(attempts) == 3
        assert memory_accountant().staging_retries_total == before + 2

    def test_transient_exhaustion_records_fault(self):
        acct = memory_accountant()
        before = acct.staging_faults_transient_total

        def fn():
            raise TransientDeviceError("RESOURCE_EXHAUSTED")

        configure_staging_retry(max_attempts=2, backoff_ms=0.0)
        with pytest.raises(TransientDeviceError):
            run_staged(fn, index="t", kind="postings_raw")
        assert acct.staging_faults_transient_total == before + 1
        ev = acct.staging_fault_events[-1]
        assert ev["classification"] == "transient"
        assert ev["retries"] == 1
        assert ev["kind"] == "postings_raw"

    def test_deterministic_never_retries(self):
        acct = memory_accountant()
        attempts = []
        before = acct.staging_faults_deterministic_total

        def fn():
            attempts.append(1)
            raise ValueError("shape")

        configure_staging_retry(max_attempts=5, backoff_ms=0.0)
        with pytest.raises(ValueError):
            run_staged(fn, index="t", kind="live_mask")
        assert len(attempts) == 1
        assert acct.staging_faults_deterministic_total == before + 1

    @pytest.mark.parametrize("exc", [KernelError("nvcc failed"),
                                     StagingBail("structural")])
    def test_kernel_error_and_bail_pass_through_unrecorded(self, exc):
        acct = memory_accountant()
        counts = (acct.staging_retries_total,
                  acct.staging_faults_transient_total,
                  acct.staging_faults_deterministic_total)
        attempts = []

        def fn():
            attempts.append(1)
            raise exc

        configure_staging_retry(max_attempts=5, backoff_ms=0.0)
        with pytest.raises(type(exc)):
            run_staged(fn, index="t", kind="postings_raw")
        assert len(attempts) == 1
        assert (acct.staging_retries_total,
                acct.staging_faults_transient_total,
                acct.staging_faults_deterministic_total) == counts

    def test_configure_sets_keeps_and_clamps(self):
        configure_staging_retry(max_attempts=5, backoff_ms=2.5)
        assert staging_retry_config() == (5, 2.5)
        configure_staging_retry(backoff_ms=1.0)  # None leaves a knob
        assert staging_retry_config() == (5, 1.0)
        configure_staging_retry(max_attempts=0, backoff_ms=-1.0)
        assert staging_retry_config() == (1, 0.0)  # clamped

    def test_node_seeds_the_process_config(self):
        from elasticsearch_tpu_torch.node import Node

        node = Node(Settings({"search.staging.retry.max_attempts": 4,
                              "search.staging.retry.backoff_ms": 5.0}),
                    device="cpu")
        try:
            assert staging_retry_config() == (4, 5.0)
        finally:
            node.close()

    def test_rejects_out_of_range(self):
        with pytest.raises(IllegalArgumentException):
            SEARCH_STAGING_RETRY_MAX_ATTEMPTS.get(
                Settings({"search.staging.retry.max_attempts": 0}))


def test_transient_retry_absorbs_the_fault():
    """A transient staging fault under the retry budget is invisible to
    the ladder: the query serves from the mesh plane, first try."""
    idx = make_index("tsretry")
    try:
        scheme = StagingFailScheme(kinds=["mesh_slot_tables"],
                                   transient=True, times=2,
                                   indices=["tsretry"]).install()
        retries = memory_accountant().staging_retries_total
        r = idx.search(dict(BODY))
        assert r["_plane"] == "mesh_pallas", r["_plane"]
        assert scheme.hits == 2
        assert memory_accountant().staging_retries_total == retries + 2
        planes = idx.search_stats()["planes"]
        assert planes["plane_failures_total"]["mesh_pallas"] == 0
    finally:
        idx.close()


class TestStagingLeakFreedom:
    """A deterministic fault at each boundary rolls the ledger back to the
    pre-attempt bytes exactly, demotes with reason staging_fault, and the
    index heals onto the mesh plane once the fault clears."""

    def _heal(self, idx, t_fault, body):
        time.sleep(max(0.0, t_fault + 0.25 - time.monotonic()))
        r = idx.search(dict(body, size=6))
        assert r["_plane"] == "mesh_pallas", r["_plane"]

    def test_mesh_slot_tables_boundary(self):
        idx = make_index("tsslot")
        try:
            idx._search_uncached(dict(BODY), skip_mesh=True)  # host warm
            snap = _snapshot("tsslot")
            scheme = StagingFailScheme(kinds=["mesh_slot_tables"],
                                       transient=False,
                                       indices=["tsslot"]).install()
            t_fault = time.monotonic()
            r = idx.search(dict(BODY))
            assert scheme.hits == 1
            assert r["_plane"] == "host"
            assert r["_shards"]["failed"] == 0
            assert _snapshot("tsslot") == snap  # nothing registered
            planes = idx.search_stats()["planes"]
            assert planes["plane_failures_by_reason"]["staging_fault"] == 1
            assert planes["decisions"]["host.staging_fault"] >= 1
            scheme.remove()
            self._heal(idx, t_fault, BODY)
            assert _snapshot("tsslot")["mesh_slot_tables"] > 0
        finally:
            idx.close()
        assert sum(_snapshot("tsslot").values()) == 0

    def test_postings_boundary(self):
        # the mesh's kernel plane reads the segments' own posting tables:
        # a fault staging one leaves the plane unstaged and the ledger as
        # it was
        idx = make_index("tspost")
        try:
            ms = idx._mesh_plane()
            ex = ms._ensure_staged()
            snap = _snapshot("tspost")
            scheme = StagingFailScheme(kinds=["postings"], transient=False,
                                       indices=["tspost"]).install()
            assert ex.ensure_kernel() is None
            assert ex.kernel_denied_reason == "staging_fault"
            assert scheme.hits == 1
            assert ex._kernel is None and "k_live_t" not in ex._seg_staged
            assert _snapshot("tspost") == snap
            scheme.remove()
            assert ex.ensure_kernel() is not None
            after = _snapshot("tspost")
            assert after["postings_raw"] > snap["postings_raw"]
            assert after["live_mask"] > snap["live_mask"]
        finally:
            idx.close()

    def test_live_mask_boundary(self):
        idx = make_index("tslive")
        try:
            idx._search_uncached(dict(BODY), skip_mesh=True)  # host warm
            snap = _snapshot("tslive")
            scheme = StagingFailScheme(kinds=["live_mask"], transient=False,
                                       indices=["tslive"]).install()
            t_fault = time.monotonic()
            r = idx.search(dict(BODY))
            assert scheme.hits >= 1
            assert r["_plane"] == "host"
            assert r["_shards"]["failed"] == 0
            after = _snapshot("tslive")
            assert after["live_mask"] == snap["live_mask"]
            ex = idx._mesh_search._executor
            assert ex._kernel is None and "k_live_t" not in ex._seg_staged
            assert any(k.endswith(".staging_fault") for k in
                       idx.search_stats()["planes"]["decisions"])
            scheme.remove()
            self._heal(idx, t_fault, BODY)
        finally:
            idx.close()

    def test_embeddings_boundary(self):
        idx = make_index("tsemb", vectors=True)
        body = {"knn": {"field": "vec", "query_vector": [1.0] * 16,
                        "k": 5}}
        try:
            # the segments' base tables staged (a lexical host query); the
            # embeddings not yet
            idx._search_uncached(dict(BODY), skip_mesh=True)
            ex = idx._mesh_plane()._ensure_staged()
            snap = _snapshot("tsemb")
            scheme = StagingFailScheme(kinds=["embeddings"], transient=False,
                                       indices=["tsemb"]).install()
            assert ex.ensure_knn("vec", 16, "cosine") is None
            assert ex.kernel_denied_reason == "staging_fault"
            assert scheme.hits == 1
            assert ex._knn.get("vec") is None
            after = _snapshot("tsemb")
            assert after["embeddings"] == snap["embeddings"]
            assert after["live_mask"] == snap["live_mask"]
            scheme.remove()
            r = idx.search(dict(body))
            assert r["_plane"] == "mesh_pallas", r["_plane"]
            assert _snapshot("tsemb")["embeddings"] > snap["embeddings"]
        finally:
            idx.close()

    def test_doc_values_boundary(self):
        idx = make_index("tsdv", shards=2)
        body = {"query": {"match": {"body": "w1"}}, "size": 5,
                "aggs": {"tags": {"terms": {"field": "tag"}},
                         "st": {"stats": {"field": "n"}}}}
        try:
            idx.search(dict(BODY))  # stage the generation
            ms = idx._mesh_search
            scope = ms._executor.scope
            snap = _snapshot("tsdv")

            def mesh_rows():
                return sorted((r["segment"], r["kind"], r["bytes"])
                              for r in memory_accountant().table()
                              if r["index"] == "tsdv"
                              and r["segment"] == scope)

            rows = mesh_rows()
            StagingFailScheme(kinds=["doc_values"], transient=False, times=1,
                              indices=["tsdv"]).install()
            faulted = idx.search(dict(body))
            assert faulted["_plane"] == "mesh_pallas"  # the query serves
            assert ms.agg_host_fallback_by_reason == {"staging_fault": 1}
            # the generation's scope registered nothing (the host reduce
            # stages its own segment columns, legitimately)
            assert mesh_rows() == rows
            assert not any(k.startswith("maggs.")
                           for k in ms._executor._seg_staged)
            clear_search_disruptions()
            # a transient fault is absorbed by the retry
            scheme = StagingFailScheme(kinds=["doc_values"], transient=True,
                                       times=1, indices=["tsdv"]).install()
            fused = idx.search(dict(body))
            assert scheme.hits == 1
            assert ms.agg_fused_query_total == 1
            assert fused["aggregations"] == faulted["aggregations"]
            assert _snapshot("tsdv")["doc_values"] > snap["doc_values"]
        finally:
            idx.close()


def test_one_probe_for_a_concurrent_burst():
    """After the staging's cooldown, a concurrent burst makes exactly one
    restage attempt; its peers serve the host rung."""
    idx = make_index("tsprobe", cooldown="200ms")
    try:
        idx._search_uncached(dict(BODY), skip_mesh=True)  # host warm
        scheme = StagingFailScheme(kinds=["mesh_slot_tables"],
                                   transient=False,
                                   indices=["tsprobe"]).install()
        t_fault = time.monotonic()
        assert idx.search(dict(BODY))["_plane"] == "host"
        assert scheme.hits == 1
        health = idx._mesh_search.plane_health
        time.sleep(max(0.0, t_fault + 0.3 - time.monotonic()))
        n = 6
        barrier = threading.Barrier(n)
        results, errors = [], []

        def worker():
            barrier.wait()
            try:
                results.append(idx._search_uncached(dict(BODY)))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        assert all(r["_plane"] == "host" for r in results)
        assert len({r["hits"]["total"] for r in results}) == 1
        assert scheme.hits == 2, scheme.hits  # one probe for the burst
        assert health.failures_by_reason["staging_fault"] == 2
        scheme.remove()
        time.sleep(0.3)
        assert idx.search(dict(BODY))["_plane"] == "mesh_pallas"
    finally:
        idx.close()
