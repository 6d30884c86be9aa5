"""The fused doc-values plane on the port's one-device mesh plane, against
the JAX package's and against the port's own host reduce.

Three indices take the same seeded documents: a JAX ``IndexService`` on a
one-device mesh (tile kernel in interpret mode, ``ES_TPU_PALLAS=
interpret``; ``search.aggs.fused`` left on, unlike tests/test_torch_mesh.py;
delta staging off on all three, so a delete rebuilds each generation), a
port ``IndexService(device="cpu")``, and a port index with
``index.search.aggs.fused: false`` (the host reduce over the program's
per-slot views). Every fused aggregation must equal both byte for byte
(the fused plane's counts, digit sums and min/max pairs are exact, so the
response dicts compare with ``==``); ``agg_fused_query_total`` and
``agg_host_fallback_by_reason`` must equal the JAX package's on the same
requests. Hits compare as tests/test_torch_mesh.py does (scores within
rtol 1e-5 of JAX's, bit for bit within the port). Mirrors the cases of
tests/test_fused_aggs.py the port can have (not brownout, quarantine of
the fused launch, or the memory ledger, whose modules are not ported).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from test_torch_search import assert_same_hits

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
    "price": {"type": "double"},
    "ts": {"type": "date"},
    "tag": {"type": "keyword"},
    "tags": {"type": "keyword"},
}}

EPOCH = 1500000000000  # ~2017-07-14, epoch millis


@pytest.fixture(autouse=True)
def _interpret_kernel(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


def _docs(n_docs, seed=0):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(12)]
    tags = ["red", "green", "blue", "teal"]
    out = []
    for d in range(n_docs):
        toks = [vocab[rng.randint(len(vocab))]
                for _ in range(rng.randint(3, 9))]
        out.append((str(d), {
            "body": " ".join(toks),
            "n": d % 17,
            "price": (d % 5) + 0.25,  # non-integer: sum falls back
            "ts": EPOCH + (d % 7) * 3600_000,
            "tag": tags[d % 4],
        }))
    return out


class Trio:
    """The JAX mesh index, the port's and the port's host-reduce twin,
    over the same documents and refreshes."""

    def __init__(self, name, n_shards=2, n_docs=90, refreshes=1,
                 extra=None):
        common = {"index.number_of_shards": n_shards,
                  "index.refresh_interval": -1, **(extra or {})}
        self.j = JIndex(name, JSettings({
            **common, "index.staging.delta.enabled": False,
            "index.requests.cache.enable": False}), mapping=MAPPING)
        # the port serves one device: give the JAX plane a one-device mesh
        self.j._mesh_search = JMesh(self.j, mesh=shard_mesh(1))
        # the port's index mirrors the JAX one's staging (delta off): its
        # deletes rebuild the generation, as the JAX plane's do
        self.t = IndexService(name, Settings({
            **common, "index.staging.delta.enabled": False}), mapping=MAPPING,
                              device="cpu")
        self.h = IndexService(name, Settings({
            **common, "index.search.aggs.fused": "false",
            "index.staging.delta.enabled": False}),
            mapping=MAPPING, device="cpu")
        docs = _docs(n_docs)
        per = n_docs // refreshes
        for r in range(refreshes):
            for doc_id, src in docs[r * per:(r + 1) * per]:
                self.index(doc_id, src)
            self.refresh()

    def each(self):
        return (self.j, self.t, self.h)

    def index(self, doc_id, src):
        for idx in self.each():
            idx.index_doc(doc_id, src)

    def refresh(self):
        for idx in self.each():
            idx.refresh()

    def delete(self, doc_id):
        for idx in self.each():
            assert idx.delete_doc(doc_id)["result"] == "deleted"

    def search(self, body):
        return tuple(idx.search(dict(body)) for idx in self.each())

    def counters(self):
        jm, tm = self.j._mesh_search, self.t._mesh_search
        return ((jm.agg_fused_query_total,
                 dict(jm.agg_host_fallback_by_reason)),
                (tm.agg_fused_query_total,
                 dict(tm.agg_host_fallback_by_reason)))

    def close(self):
        for idx in self.each():
            idx.close()


@pytest.fixture()
def trio():
    made = []

    def make(name, **kw):
        t = Trio(name, **kw)
        made.append(t)
        return t

    yield make
    for t in made:
        t.close()


ALL_FUSED_AGGS = {
    "tags": {"terms": {"field": "tag"}},
    "top2": {"terms": {"field": "tag", "size": 2}},
    "bykey": {"terms": {"field": "tag", "order": {"_key": "asc"}}},
    "hist": {"histogram": {"field": "n", "interval": 5}},
    "hoff": {"histogram": {"field": "n", "interval": 4, "offset": 1}},
    "hmin0": {"histogram": {"field": "n", "interval": 3,
                            "min_doc_count": 0}},
    "dh": {"date_histogram": {"field": "ts", "interval": "1h"}},
    "dhf": {"date_histogram": {"field": "ts", "fixed_interval": "2h",
                               "offset": 1800_000, "min_doc_count": 1}},
    "st": {"stats": {"field": "n"}},
    "mn": {"min": {"field": "n"}},
    "mx": {"max": {"field": "n"}},
    "sm": {"sum": {"field": "n"}},
    "av": {"avg": {"field": "n"}},
    "vc": {"value_count": {"field": "n"}},
    "dmn": {"min": {"field": "ts"}},  # epoch-ms ints: hi/lo split path
    "dsm": {"sum": {"field": "ts"}},  # the digit reconstruction
    "empty_terms": {"terms": {"field": "nosuch"}},
    "empty_stats": {"stats": {"field": "nosuch"}},
}


def assert_parity(got, want, want_plane="mesh_pallas", exact=False):
    assert got["_plane"] == want["_plane"] == want_plane, (
        got["_plane"], want["_plane"])
    if exact:
        assert ([(h["_id"], h["_score"]) for h in got["hits"]["hits"]]
                == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])
        assert got["hits"]["total"] == want["hits"]["total"]
    else:
        assert_same_hits(want, got)
    assert got.get("aggregations") == want.get("aggregations"), (
        got.get("aggregations"), want.get("aggregations"))


def test_every_fused_type_byte_identical(trio):
    t3 = trio("fap")
    body = {"query": {"match": {"body": "t0 t1"}}, "size": 5,
            "aggs": dict(ALL_FUSED_AGGS)}
    jr, tr, hr = t3.search(body)
    assert_parity(tr, jr)
    assert_parity(tr, hr, exact=True)
    assert t3.counters() == ((1, {}), (1, {}))
    assert t3.h._mesh_search.agg_host_fallback_by_reason == {"disabled": 1}
    planes = t3.t.search_stats()["planes"]
    assert planes["agg_fused_query_total"] == 1
    assert planes["agg_host_mask_bytes_total"] == 0
    assert t3.h.search_stats()["planes"]["agg_host_mask_bytes_total"] > 0
    # the doc-value columns staged with the executor, and the partials'
    # layout: n_agg_outputs tensors, each with a leading slot axis
    ex = t3.t._mesh_search._executor
    assert {k for k in ex._seg_staged if k.startswith("maggs.")} >= {
        "maggs.ord.tag", "maggs.num.n.ex", "maggs.num.n.dig",
        "maggs.num.ts.mm"}
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.fused_aggs import (
        emit_agg_partials,
        n_agg_outputs,
        resolve_fused_aggs,
    )

    plan, reason = resolve_fused_aggs(parse_aggs(ALL_FUSED_AGGS), ex)
    assert reason is None
    # one row an occupied slot (a generation's headroom slots hold none)
    mask = torch.zeros((ex.n_occupied, ex.nd1), dtype=torch.bool)
    mask[:, :5] = True
    outs = emit_agg_partials(plan.statics, ex._seg_staged, mask)
    assert len(outs) == n_agg_outputs(plan.statics) == 24
    assert all(o.shape[0] == ex.n_occupied for o in outs)


@pytest.mark.parametrize("size", [0, 7])
def test_dashboard_size_zero_and_hits(trio, size):
    t3 = trio(f"fdash{size}")
    body = {"query": {"match": {"body": "t2 t3 t4"}}, "size": size,
            "aggs": {"tags": {"terms": {"field": "tag"}},
                     "dh": {"date_histogram": {"field": "ts",
                                               "interval": "1d"}},
                     "h": {"histogram": {"field": "n", "interval": 5}},
                     "st": {"stats": {"field": "n"}},
                     "a": {"avg": {"field": "ts"}},
                     "c": {"value_count": {"field": "tag"}}}}
    jr, tr, hr = t3.search(body)
    assert_parity(tr, jr)
    assert_parity(tr, hr, exact=True)
    # value_count on a keyword keeps the host reduce (ordinal values)
    assert t3.counters() == ((0, {"field_ineligible": 1}),
                             (0, {"field_ineligible": 1}))


def test_multi_segment_slots(trio):
    # 2 shards x 2 refreshes = 4 (shard, segment) slots on one device
    t3 = trio("fpk", n_docs=100, refreshes=2)
    n_pairs = sum(1 for sid in t3.t.shards
                  for seg in t3.t.shards[sid].engine.searchable_segments()
                  if seg.num_docs > 0)
    assert n_pairs == 4
    body = {"query": {"match": {"body": "t1 t2"}}, "size": 6,
            "aggs": {"tags": {"terms": {"field": "tag"}},
                     "st": {"stats": {"field": "n"}},
                     "dh": {"date_histogram": {
                         "field": "ts", "interval": "1h"}}}}
    jr, tr, hr = t3.search(body)
    assert_parity(tr, jr)
    assert_parity(tr, hr, exact=True)
    assert t3.counters() == ((1, {}), (1, {}))


def test_deletes_excluded_on_device(trio):
    t3 = trio("fdel")
    body = {"query": {"match": {"body": "t0 t1 t2"}}, "size": 5,
            "aggs": {"tags": {"terms": {"field": "tag"}},
                     "sm": {"sum": {"field": "n"}},
                     "vc": {"value_count": {"field": "n"}}}}
    before = t3.search(body)[1]["aggregations"]
    for d in range(0, 90, 3):
        t3.delete(str(d))
    t3.refresh()
    jr, tr, hr = t3.search(body)
    assert_parity(tr, jr)
    assert_parity(tr, hr, exact=True)
    assert tr["aggregations"] != before
    assert t3.counters() == ((2, {}), (2, {}))


def test_batched_members_one_launch_and_isolation(trio):
    t3 = trio("fbat")
    burst = [
        {"query": {"match": {"body": "t0 t1"}}, "size": 5,
         "aggs": {"tags": {"terms": {"field": "tag"}}}},
        {"query": {"match": {"body": "t2"}}, "size": 4,
         "aggs": {"st": {"stats": {"field": "n"}},
                  "dh": {"date_histogram": {"field": "ts",
                                            "interval": "1h"}}}},
        {"query": {"match": {"body": "t3 t4"}}, "size": 6},
        {"query": {"match": {"body": "t1 t5"}}, "size": 5,
         "aggs": {"h": {"histogram": {"field": "n", "interval": 4}}}},
    ]
    jout = t3.j.search_batch([dict(b) for b in burst])
    tout = t3.t.search_batch([dict(b) for b in burst])
    tm = t3.t._mesh_search
    assert tm.batched_launch_total == 1
    assert tm.decisions.get("mesh_pallas.served_batched") == len(burst)
    for b, jr, tr in zip(burst, jout, tout):
        assert isinstance(tr, dict), tr
        assert_parity(tr, jr)
        # a member equals its serial response, and no member sees another
        # member's aggregations
        assert_parity(tr, t3.t.search(dict(b)), exact=True)
        assert ("aggregations" in tr) == ("aggs" in b)
    assert t3.j._mesh_search.agg_fused_query_total == 3
    # 3 batched members, then 3 serial repeats
    assert tm.agg_fused_query_total == 6
    assert tm.agg_host_fallback_total == 0


def test_ineligible_agg_member_demotes_batch_not_peers(trio):
    t3 = trio("fbad")
    burst = [
        {"query": {"match": {"body": "t0"}}, "size": 4,
         "aggs": {"tags": {"terms": {"field": "tag"}}}},
        # sub-aggs: outside the fused envelope. The batch goes to the host
        # rung; every member still serves correctly
        {"query": {"match": {"body": "t1"}}, "size": 4,
         "aggs": {"tags": {"terms": {"field": "tag"},
                           "aggs": {"m": {"max": {"field": "n"}}}}}},
    ]
    jout = t3.j.search_batch([dict(b) for b in burst])
    tout = t3.t.search_batch([dict(b) for b in burst])
    for b, jr, tr in zip(burst, jout, tout):
        assert isinstance(tr, dict), tr
        assert tr["_plane"] == jr["_plane"]
        assert tr["hits"]["total"] == jr["hits"]["total"]
        assert tr["aggregations"] == jr["aggregations"]
    assert t3.t._mesh_search.batched_launch_total == 0
    assert t3.counters()[1] == t3.counters()[0]
    assert t3.counters()[1][1].get("sub_aggs", 0) >= 1


FALLBACKS = [
    ({"tags": {"terms": {"field": "tag"},
               "aggs": {"m": {"max": {"field": "n"}}}}}, "sub_aggs"),
    ({"mv": {"terms": {"field": "tags"}}}, "multi_valued"),
    ({"p": {"sum": {"field": "price"}}}, "values_not_fusable"),
    ({"cal": {"date_histogram": {"field": "ts", "interval": "month"}}},
     "unsupported_params"),
    ({"card": {"cardinality": {"field": "tag"}}}, "unsupported_agg"),
    ({"pc": {"percentiles": {"field": "n"}}}, "unsupported_agg"),
    ({"r": {"range": {"field": "n", "ranges": [{"to": 5}]}}},
     "unsupported_agg"),
    ({"t": {"terms": {"field": "tag", "shard_size": 3}}},
     "unsupported_params"),
    ({"t": {"terms": {"field": "n"}}}, "field_ineligible"),
    ({"h": {"histogram": {"field": "n", "interval": 0.001}}},
     "bucket_range"),
    ({"h": {"date_histogram": {"field": "ts", "interval": "1s"}}},
     "bucket_range"),
    ({"h": {"histogram": {"field": "n", "interval": 5}},
      "d": {"derivative": {"buckets_path": "h>_count"}}}, "unsupported_agg"),
]


def test_fallback_reasons_counted_like_jax_and_results_exact(trio):
    t3 = trio("ffb")
    # multi-valued keyword: a doc with two tags
    t3.index("mv", {"body": "t0 t1", "n": 1, "price": 1.5, "ts": EPOCH,
                    "tags": ["red", "blue"]})
    t3.refresh()
    for aggs, reason in FALLBACKS:
        body = {"query": {"match": {"body": "t0 t1"}}, "size": 4,
                "aggs": aggs}
        jr, tr, hr = t3.search(body)
        assert tr["aggregations"] == jr["aggregations"] == hr["aggregations"]
        (jf, jby), (tf, tby) = t3.counters()
        assert tby == jby and tby.get(reason), (reason, tby, jby)
    assert t3.counters()[1][0] == t3.counters()[0][0] == 0


def test_disabled_by_setting_falls_back_identically(trio):
    t3 = trio("foff", extra={"index.search.aggs.fused": "false"})
    body = {"query": {"match": {"body": "t0"}}, "size": 4,
            "aggs": {"tags": {"terms": {"field": "tag"}}}}
    jr, tr, hr = t3.search(body)
    assert_parity(tr, jr)
    assert t3.counters() == ((0, {"disabled": 1}), (0, {"disabled": 1}))


def test_node_setting_seeds_the_index():
    from elasticsearch_tpu_torch.node import Node

    node = Node(Settings({"search.aggs.fused": False}), device="cpu")
    try:
        node.create_index("n1", {"settings": {"number_of_shards": 2}})
        node.create_index("n2", {"settings": {
            "number_of_shards": 2, "search": {"aggs": {"fused": True}}}})
        for name in ("n1", "n2"):
            node.index_doc(name, "1", {"t": "a b", "k": "x"})
            node.refresh(name)
            node.search(name, {"query": {"match": {"t": "a"}},
                               "aggs": {"k": {"terms": {"field": "k"}}}})
        p1 = node.indices["n1"].search_stats()["planes"]
        p2 = node.indices["n2"].search_stats()["planes"]
        assert p1["agg_host_fallback_by_reason"] == {"disabled": 1}
        assert p2["agg_fused_query_total"] == 1
    finally:
        node.close()


def test_agg_queries_never_prune(trio):
    extra = {"search.pallas.pruning.enabled": True,
             "search.pallas.pruning.probe_tiles": 2}
    t3 = trio("fpx", n_docs=600, extra=extra)
    plain = t3.t.search({"query": {"match": {"body": "t1"}}, "size": 5})
    assert "_pruned" in plain, "the agg-less twin serves pruned"
    body = {"query": {"match": {"body": "t1"}}, "size": 5,
            "aggs": {"tags": {"terms": {"field": "tag"}},
                     "sm": {"sum": {"field": "n"}}}}
    jr, tr, hr = t3.search(body)
    # aggs force the exhaustive path: exact totals, no pruned marker
    assert "_pruned" not in tr
    assert_parity(tr, jr)
    assert_parity(tr, hr, exact=True)
    burst = [dict(body), {"query": {"match": {"body": "t2"}}, "size": 3,
                          "aggs": {"h": {"histogram": {"field": "n",
                                                       "interval": 2}}}}]
    for b, got in zip(burst, t3.t.search_batch([dict(b) for b in burst])):
        assert "_pruned" not in got
        assert_parity(got, t3.t.search(dict(b)), exact=True)
    assert t3.t._mesh_search.pruned_query_total == 1  # the plain query


def test_kernel_fault_on_fused_rung_raises(trio, monkeypatch):
    from elasticsearch_tpu_torch.ops import segment_sum
    from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError

    t3 = trio("fkern")

    def broken(*args, **kwargs):
        raise KernelError("segment_sum kernel launch failed: CUDA error 700")

    monkeypatch.setattr(segment_sum, "segment_counts_sums", broken)
    body = {"query": {"match": {"body": "t0"}}, "size": 4,
            "aggs": {"tags": {"terms": {"field": "tag"}}}}
    with pytest.raises(KernelError):
        t3.t.search(dict(body))
    with pytest.raises(KernelError):
        t3.t.search_batch([dict(body), dict(body, size=3)])
    planes = t3.t.search_stats()["planes"]
    assert planes["plane_failures_total"] == {"mesh_pallas": 0, "mesh": 0}
    assert planes["agg_host_fallback_total"] == 0


def test_staging_error_raises_and_publishes_nothing(trio, monkeypatch):
    """A doc-value staging fault: a deterministic one publishes nothing and
    demotes the aggregations (not the query) to the host reduce with
    reason staging_fault; a transient one (a transfer error) is retried
    and the columns publish once. Both answer as the JAX package does."""
    import torch

    from elasticsearch_tpu_torch.common.memory import memory_accountant

    t3 = trio("fstage")
    body = {"query": {"match": {"body": "t0"}}, "size": 4,
            "aggs": {"tags": {"terms": {"field": "tag"}},
                     "st": {"stats": {"field": "n"}}}}
    t3.t.search({"query": {"match": {"body": "t0"}}})  # stage the executor
    ex = t3.t._mesh_search._executor
    real = torch.Tensor.to

    def failing_to(exc):
        calls = []

        def to(self, *args, **kwargs):
            calls.append(1)
            if len(calls) == 2:  # the second column's transfer
                raise exc
            return real(self, *args, **kwargs)

        return to

    acct = memory_accountant()
    faults = acct.staging_faults_deterministic_total
    monkeypatch.setattr(torch.Tensor, "to",
                        failing_to(ValueError("bad column shape")))
    tr = t3.t.search(dict(body))
    monkeypatch.setattr(torch.Tensor, "to", real)
    assert not any(k.startswith("maggs.") for k in ex._seg_staged)
    assert t3.t._mesh_search.agg_host_fallback_by_reason == {
        "staging_fault": 1}
    assert acct.staging_faults_deterministic_total == faults + 1
    jr = t3.j.search(dict(body))
    assert_parity(tr, jr)

    retries = acct.staging_retries_total
    monkeypatch.setattr(torch.Tensor, "to",
                        failing_to(RuntimeError("device transfer failed")))
    tr = t3.t.search(dict(body))
    monkeypatch.setattr(torch.Tensor, "to", real)
    assert acct.staging_retries_total == retries + 1
    assert any(k.startswith("maggs.") for k in ex._seg_staged)
    assert t3.t._mesh_search.agg_fused_query_total == 1
    assert_parity(tr, jr)


def test_concurrent_first_queries_stage_once_and_agree(trio):
    """Threads race to stage the same doc-value columns and to count the
    fused queries: every response equals the serial one, the columns stage
    once, and the counters lose no update."""
    import sys
    import threading

    t3 = trio("fconc")
    bodies = [{"query": {"match": {"body": f"t{i % 5} t{(i + 3) % 7}"}},
               "size": 3, "aggs": {"tags": {"terms": {"field": "tag"}},
                                   "st": {"stats": {"field": "n"}},
                                   "dh": {"date_histogram": {
                                       "field": "ts", "interval": "1h"}}}}
              for i in range(24)]
    want = [t3.h.search(dict(b)) for b in bodies]
    got = [None] * len(bodies)
    start = threading.Barrier(len(bodies))

    def worker(i):
        start.wait()
        got[i] = t3.t.search(dict(bodies[i]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120.0)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    for g, w in zip(got, want):
        assert g["aggregations"] == w["aggregations"]
        assert g["hits"]["total"] == w["hits"]["total"]
    ms = t3.t._mesh_search
    assert ms.agg_fused_query_total == len(bodies)
    assert ms.agg_host_fallback_total == 0
    cols = [k for k in ms._executor._seg_staged if k.startswith("maggs.")]
    assert len(cols) == len(set(cols)) == 5  # ord.tag, hist.ts, n.{ex,mm,dig}


def test_racing_first_queries_build_one_mesh_plane(trio, monkeypatch):
    """The mesh plane of an index is created once, under a lock: a sleep
    inside ``IndexMeshSearch.__init__`` widens the window in which 24
    threads race an index's first aggregation queries, and exactly one
    instance is built, which counts all 24 fused queries."""
    import threading
    import time

    from elasticsearch_tpu_torch.parallel import plan_exec

    t3 = trio("frace")
    bodies = [{"query": {"match": {"body": f"t{i % 5} t{(i + 3) % 7}"}},
               "size": 3, "aggs": {"tags": {"terms": {"field": "tag"}},
                                   "st": {"stats": {"field": "n"}}}}
              for i in range(24)]
    want = [t3.h.search(dict(b)) for b in bodies]
    assert t3.t._mesh_search is None
    built = []
    real_init = plan_exec.IndexMeshSearch.__init__

    def slow_init(self, index_service):
        built.append(self)
        time.sleep(0.002)
        real_init(self, index_service)

    monkeypatch.setattr(plan_exec.IndexMeshSearch, "__init__", slow_init)
    got = [None] * len(bodies)
    start = threading.Barrier(len(bodies))

    def worker(i):
        start.wait()
        got[i] = t3.t.search(dict(bodies[i]))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120.0)
        assert not th.is_alive()
    assert len(built) == 1
    assert t3.t._mesh_search is built[0]
    for g, w in zip(got, want):
        assert g["aggregations"] == w["aggregations"]
    assert t3.t._mesh_search.agg_fused_query_total == 24


def test_closed_generation_frees_without_a_cycle_collection():
    """A fused metric staged its columns through a builder that closes
    over the generation: that closure must not be a reference cycle, or a
    replaced or closed generation keeps its staged tensors until the next
    cycle collection (the card's memory stays allocated after a close)."""
    import gc
    import weakref

    svc = IndexService("free", Settings({"index.number_of_shards": 3,
                                         "index.refresh_interval": -1}),
                       mapping=MAPPING, device="cpu")
    for doc_id, src in _docs(60):
        svc.index_doc(doc_id, src)
    svc.refresh()
    gc.collect()
    gc.disable()
    try:
        r = svc.search({"size": 0, "aggs": {
            "s": {"stats": {"field": "n"}}, "m": {"min": {"field": "n"}}}})
        assert r["aggregations"]["s"]["count"] == 60
        planes = svc.search_stats()["planes"]
        assert planes["agg_fused_query_total"] == 1
        generation = weakref.ref(svc._mesh_search._executor)
        assert any(k.startswith("maggs.num.n")
                   for k in generation()._seg_staged)
        svc.close()
        assert generation() is None
    finally:
        gc.enable()
