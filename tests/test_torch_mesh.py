"""Parity of the port's one-device mesh plane and micro-batch rungs with
the JAX package.

A JAX ``IndexService`` (tile kernel in interpret mode,
``ES_TPU_PALLAS=interpret``; a one-device mesh; ``search.aggs.fused:
false`` and ``index.staging.delta.enabled: false``) and a port
``IndexService(device="cpu")`` (delta staging on, its default) take the
same seeded documents. Responses must agree: ``_plane`` and ``_shards``
exactly, totals and aggregation buckets exactly, ids exactly except among
hits whose scores tie within rtol 1e-5, scores within rtol 1e-5 (the JAX
kernel's bf16 split, about 2^-17 relative). Inside the port, a batched
member's scores equal its serial response's bit for bit.
"""

import numpy as np
import pytest

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
    "tag": {"type": "keyword"},
}}


def seeded_docs(n_docs, seed=3):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(40)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    tags = ["red", "green", "blue", "gold"]
    return [(str(d), {"body": " ".join(rng.choice(vocab, rng.randint(3, 12),
                                                  p=p)),
                      "n": d, "tag": tags[int(rng.zipf(1.8)) % 4]})
            for d in range(n_docs)]


def build_pair(n_shards, n_docs):
    common = {"index.number_of_shards": n_shards,
              "index.refresh_interval": -1}
    jidx = JIndex(f"mesh-{n_shards}", JSettings({
        **common, "search.aggs.fused": False,
        "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=MAPPING)
    # the port serves one device: give the JAX plane a one-device mesh
    jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(f"mesh-{n_shards}", Settings(common),
                        mapping=MAPPING, device="cpu")
    for doc_id, src in seeded_docs(n_docs):
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


@pytest.fixture(scope="module")
def pair3():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = build_pair(3, 240)
    yield jidx, tidx
    jidx.close()
    mp.undo()


SERIAL = {
    "match": ({"query": {"match": {"body": "t3 t8 t15"}}, "size": 10},
              "mesh_pallas"),
    "match_dense_term": ({"query": {"match": {"body": "t0 t1"}},
                          "size": 30}, "mesh_pallas"),
    "match_and": ({"query": {"match": {"body": {
        "query": "t1 t4", "operator": "and"}}}, "size": 20}, "mesh_pallas"),
    "match_msm": ({"query": {"match": {"body": {
        "query": "t2 t5 t9 t12", "minimum_should_match": 2}}}, "size": 20},
        "mesh_pallas"),
    "bool": ({"query": {"bool": {
        "must": [{"match": {"body": "t2 t6"}}],
        "filter": [{"term": {"tag": "red"}},
                   {"range": {"n": {"gte": 30, "lt": 200}}}]}},
        "size": 20}, "mesh_pallas"),
    "bool_should_must_not": ({"query": {"bool": {
        "should": [{"match": {"body": "t7"}}, {"match": {"body": "t11"}}],
        "must_not": [{"terms": {"tag": ["blue", "gold"]}}]}},
        "size": 20}, "mesh_pallas"),
    "terms_agg": ({"size": 0, "query": {"match": {"body": "t1 t3"}},
                   "aggs": {"tags": {"terms": {"field": "tag"}},
                            "ns": {"terms": {"field": "n", "size": 3}}}},
                  "mesh_pallas"),
    "min_score_post_filter": ({"query": {"match": {"body": "t0 t5"}},
                               "min_score": 1.5,
                               "post_filter": {"term": {"tag": "green"}},
                               "size": 15}, "mesh_pallas"),
    "missing_term": ({"query": {"match": {"body": "nosuchterm"}}},
                     "mesh_pallas"),
    "zero_boost": ({"query": {"term": {"body": {"value": "t4", "boost": 0.0}}},
                    "size": 15}, "mesh"),
    "range": ({"query": {"range": {"n": {"gte": 100, "lte": 180}}},
               "size": 5}, "mesh"),
}


def compare(jr, tr, plane=None):
    assert tr["_plane"] == jr["_plane"]
    if plane is not None:
        assert tr["_plane"] == plane
    assert tr["_shards"] == jr["_shards"]
    assert isinstance(tr["hits"]["total"], int)
    assert_same_hits(jr, tr)
    assert jr.get("aggregations") == tr.get("aggregations")


@pytest.mark.parametrize("name", sorted(SERIAL))
def test_serial_same_response_and_plane(pair3, name):
    jidx, tidx = pair3
    body, plane = SERIAL[name]
    compare(jidx.search(dict(body)), tidx.search(dict(body)), plane)


# batch mixes: plain matches (the mesh_pallas rung), then heterogeneous
# members (aggs, min_score, minimum_should_match: the host rung)
BATCHES = {
    "mesh_rung": [
        {"query": {"match": {"body": "t0 t1"}}, "size": 5},
        {"query": {"match": {"body": "t1 t2"}}, "size": 3},
        {"query": {"match": {"body": "t3"}}, "size": 6},
        {"query": {"match": {"body": "t9 t0 t17"}}, "size": 12},
        {"query": {"match": {"body": "t22 t35"}}},
    ],
    "host_rung": [
        {"query": {"match": {"body": "t0 t1"}}, "size": 5},
        {"query": {"match": {"body": "t1"}}, "size": 3},
        {"query": {"match": {"body": "t2 t3 t4"}}, "size": 7,
         "min_score": 0.1},
        {"query": {"match": {"body": "t0 t5"}}, "size": 4,
         "aggs": {"tags": {"terms": {"field": "tag"}}}},
        {"query": {"match": {"body": {"query": "t0 t1 t2",
                                      "minimum_should_match": 2}}},
         "size": 5},
        {"query": {"bool": {"must": [{"match": {"body": "t6"}}]}},
         "size": 5},
    ],
}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_search_batch_same_per_member(pair3, name):
    jidx, tidx = pair3
    bodies = BATCHES[name]
    jout = jidx.search_batch([dict(b) for b in bodies])
    tout = tidx.search_batch([dict(b) for b in bodies])
    for body, jr, tr in zip(bodies, jout, tout):
        assert isinstance(tr, dict), tr
        compare(jr, tr)
    if name == "mesh_rung":
        assert all(r["_plane"] == "mesh_pallas" for r in tout)
        assert tidx._mesh_search.batched_launch_total >= 1
    else:
        assert tout[0]["_plane"] == "host"
        assert tout[-1]["_plane"] == "mesh_pallas"  # not shareable: serial
    assert tidx.batch_stats.as_dict()["batched_query_total"] > 0


def test_batched_member_scores_bit_equal_to_serial(pair3):
    _, tidx = pair3
    bodies = BATCHES["mesh_rung"]
    out = tidx.search_batch([dict(b) for b in bodies])
    for body, got in zip(bodies, out):
        want = tidx.search(dict(body))
        assert got["_plane"] == want["_plane"] == "mesh_pallas"
        assert got["hits"]["total"] == want["hits"]["total"]
        assert ([(h["_id"], h["_score"]) for h in got["hits"]["hits"]]
                == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])


def test_same_after_deletes_and_refresh(pair3):
    jidx, tidx = pair3
    restaged = tidx._mesh_search.restage_total
    tombstoned = tidx._mesh_search.tombstone_update_total
    rng = np.random.RandomState(9)
    for d in sorted(rng.choice(240, 30, replace=False)):
        assert (jidx.delete_doc(str(d))["result"]
                == tidx.delete_doc(str(d))["result"] == "deleted")
    jidx.refresh()
    tidx.refresh()
    for name in ("match", "match_msm", "bool", "terms_agg", "zero_boost"):
        body, plane = SERIAL[name]
        compare(jidx.search(dict(body)), tidx.search(dict(body)), plane)
    bodies = BATCHES["mesh_rung"]
    for jr, tr in zip(jidx.search_batch([dict(b) for b in bodies]),
                      tidx.search_batch([dict(b) for b in bodies])):
        compare(jr, tr, "mesh_pallas")
    # the deletes reached the staging once, as a tombstone update of the
    # live rows (delta staging), not a rebuild
    assert tidx._mesh_search.tombstone_update_total == tombstoned + 1
    assert tidx._mesh_search.restage_total == restaged
    stats = tidx.search_stats()["planes"]
    assert stats["plane_failures_total"] == {"mesh_pallas": 0, "mesh": 0}


def test_five_shards_serve_from_host_on_both():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = build_pair(5, 120)
    try:
        for body in (SERIAL["match"][0], SERIAL["terms_agg"][0]):
            compare(jidx.search(dict(body)), tidx.search(dict(body)), "host")
        bodies = BATCHES["mesh_rung"][:3]
        for jr, tr in zip(jidx.search_batch([dict(b) for b in bodies]),
                          tidx.search_batch([dict(b) for b in bodies])):
            compare(jr, tr, "host")
        assert tidx._mesh_search.decisions.get(
            "host.staging_unavailable", 0) > 0
    finally:
        jidx.close()
        mp.undo()


def port_index(n_shards, n_docs):
    tidx = IndexService(f"port-{n_shards}", Settings({
        "index.number_of_shards": n_shards, "index.refresh_interval": -1}),
        mapping=MAPPING, device="cpu")
    for doc_id, src in seeded_docs(n_docs):
        tidx.index_doc(doc_id, src)
    tidx.refresh()
    return tidx


@pytest.mark.parametrize("how", ["serial", "batch"])
def test_kernel_fault_raises_and_benches_no_plane(monkeypatch, how):
    """A kernel that fails to build or launch raises to the caller: no
    other rung serves in its place and no plane is quarantined."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError

    tidx = port_index(3, 120)

    def broken(*args, **kwargs):
        raise KernelError("tile_scoring kernel launch failed: CUDA error 700")

    monkeypatch.setattr(tsc, "score_tiles", broken)
    bodies = [dict(b) for b in BATCHES["mesh_rung"]]
    with pytest.raises(KernelError):
        if how == "serial":
            tidx.search(bodies[0])
        else:
            tidx.search_batch(bodies)
    planes = tidx.search_stats()["planes"]
    assert planes["plane_failures_total"] == {"mesh_pallas": 0, "mesh": 0}
    assert planes["plane_quarantined"] == []


def test_other_plane_fault_still_benches_the_plane(monkeypatch):
    """Any other exception inside the kernel plane keeps the JAX
    semantics: the plane is benched and the next rung serves, visibly."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc

    tidx = port_index(3, 120)
    want = tidx.search(dict(SERIAL["match"][0]))

    def broken(*args, **kwargs):
        raise RuntimeError("staged table went missing")

    monkeypatch.setattr(tsc, "score_tiles", broken)
    got = tidx.search(dict(SERIAL["match"][0]))
    assert got["_plane"] == "mesh"
    assert got["hits"]["total"] == want["hits"]["total"]
    planes = tidx.search_stats()["planes"]
    assert planes["plane_failures_total"]["mesh_pallas"] == 1
    assert planes["plane_quarantined"] == ["mesh_pallas"]


def test_mesh_slots_read_the_segments_own_kernel_tables():
    """The kernel plane stages the shared geometry's live masks only: each
    slot's posting tables are its segment's, with no stacked copy."""
    tidx = port_index(3, 120)
    assert tidx.search(dict(SERIAL["match"][0]))["_plane"] == "mesh_pallas"
    executor = tidx._mesh_search._executor
    assert not {"k_docs", "k_frac"} & set(executor._seg_staged)
    for i, seg in enumerate(executor.segments):
        slot = executor._slot(i)
        assert slot["k_docs"] is seg.kernel_tables()["k_docs"]
        assert slot["k_frac"] is seg.kernel_tables()["k_frac"]
        assert slot["k_live_t"].shape[0] == (
            executor._kernel["geom"].n_tiles * 128)


def test_stack_plans_pads_dense_columns_like_jax():
    """The "dense" pad kind (exists / ids masks, function_score factor
    columns): each slot's [nd1] column zero-filled to the stacked nd1
    rows, as the JAX package stacks it."""
    import torch

    from elasticsearch_tpu.parallel.plan_exec import stack_plans as jstack
    from elasticsearch_tpu.search import plan as JP
    from elasticsearch_tpu_torch.parallel.plan_exec import stack_plans
    from elasticsearch_tpu_torch.search import plan as P

    rng = np.random.RandomState(2)
    pads = [64, 128, 32]
    masks = [rng.rand(n + 1) < 0.4 for n in pads]
    cols = [rng.rand(n + 1).astype(np.float32) for n in pads]

    def plans(m):
        return [m.FunctionScoreNode(
            m.ConstantScoreNode(m.DenseMaskNode(mask, "ids"), 2.0), [col],
            1.5, "sum") for mask, col in zip(masks, cols)]

    got = stack_plans(plans(P), pads, 129, 4, torch.device("cpu"))
    want = jstack(plans(JP), pads, 129, 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        # a scalar stacks as [n_slots, 1] in the port, [n_slots] in JAX
        np.testing.assert_array_equal(g.numpy().reshape(w.shape), w)
        assert g.numpy().dtype == w.dtype


def test_exists_and_ids_serve_from_the_mesh_plane(pair3):
    jidx, tidx = pair3
    for body, plane in (({"query": {"exists": {"field": "tag"}}, "size": 30},
                         "mesh"),
                        ({"query": {"bool": {
                            "must": [{"match": {"body": "t2"}}],
                            "filter": [{"exists": {"field": "body"}}]}},
                          "size": 30}, "mesh_pallas"),
                        ({"query": {"function_score": {
                            "query": {"match": {"body": "t1 t5"}},
                            "functions": [{"random_score": {"seed": 3}}]}},
                          "size": 30}, "mesh_pallas")):
        compare(jidx.search(dict(body)), tidx.search(dict(body)), plane)
    stats = tidx.search_stats()["planes"]
    assert stats["plane_failures_total"] == {"mesh_pallas": 0, "mesh": 0}
