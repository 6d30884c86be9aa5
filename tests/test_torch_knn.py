"""Parity of the port's dense-vector plane (mapper, segment column, the
``knn`` query, its host and mesh rungs, the batched kNN rung of
``search_batch``, hybrid fusion) with the JAX package.

A JAX ``IndexService`` (kernels in interpret mode, ``ES_TPU_PALLAS=
interpret``; a one-device mesh, as tests/test_torch_mesh.py sets it) and a
port ``IndexService(device="cpu")`` take the same seeded documents: a
cosine field of 20 dims and a dot_product field of 200, some docs without
a vector, unequal shards (routing skews one shard, so the smaller slots
have fewer rows than the shared geometry). ``_plane``, ``_shards``,
totals and ids must agree exactly, except among hits whose scores tie
within the tolerance; scores agree within ``1e-6 + 1e-6 * sum_j |x_j *
q_j| * scale`` per hit (the f32 reordering bound; the BM25 side of a
convex fusion adds the tile kernel's rtol 1e-5). Inside the port, a
batched member equals its serial response bit for bit.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common import errors as jerr
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.ops import pallas_knn as jkn
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common import errors as terr
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService

RTOL_BM25 = 1e-5
MAPPING = {"properties": {
    "emb": {"type": "dense_vector", "dims": 20, "similarity": "cosine"},
    "dot": {"type": "dense_vector", "dims": 200,
            "similarity": "dot_product"},
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
}}
N_DOCS = 90


def seeded_docs(seed=5):
    rng = np.random.RandomState(seed)
    emb = rng.randn(N_DOCS, 20).astype(np.float32)
    dot = (rng.randn(N_DOCS, 200) * 0.3).astype(np.float32)
    docs = []
    for d in range(N_DOCS):
        src = {"body": f"t{d % 7} t{d % 3} t{d % 11}", "n": d}
        if d % 11:
            src["emb"] = emb[d].tolist()
        if d % 9:
            src["dot"] = dot[d].tolist()
        # the first 40 docs share one routing value: one large shard
        docs.append((str(d), src, "a" if d < 40 else None))
    return docs, {"emb": jkn.bf16_round(emb), "dot": jkn.bf16_round(dot)}


def build_pair(n_shards):
    common = {"index.number_of_shards": n_shards,
              "index.refresh_interval": -1}
    jidx = JIndex(f"knn-{n_shards}", JSettings({
        **common, "search.aggs.fused": False,
        "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=MAPPING)
    jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(f"knn-{n_shards}", Settings(common),
                        mapping=MAPPING, device="cpu")
    docs, vecs = seeded_docs()
    for doc_id, src, routing in docs:
        jidx.index_doc(doc_id, src, routing=routing)
        tidx.index_doc(doc_id, src, routing=routing)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx, vecs


@pytest.fixture(scope="module")
def pairs():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    built = {n: build_pair(n) for n in (1, 3)}
    yield built
    for jidx, tidx, _vecs in built.values():
        jidx.close()
        tidx.close()
    mp.undo()


def qvec(field, seed):
    rng = np.random.RandomState(100 + seed)
    return (rng.randn(20 if field == "emb" else 200) *
            (1.0 if field == "emb" else 0.3)).astype(np.float32).tolist()


def hit_tol(vecs, field, q, doc_id):
    x = vecs[field][int(doc_id)].astype(np.float64)
    metric = MAPPING["properties"][field]["similarity"]
    qn = jkn.normalize_query(np.asarray(q, np.float32), metric, len(x))
    s = np.abs(x * qn).sum()
    if metric == "cosine":
        n = np.linalg.norm(x)
        s = s / n if n > 0 else 0.0
    return 1e-6 + 1e-6 * s


def assert_same_knn_hits(jr, tr, tols):
    """tols: per JAX hit, the absolute score tolerance."""
    assert tr["hits"]["total"] == jr["hits"]["total"]
    jh, th = jr["hits"]["hits"], tr["hits"]["hits"]
    assert len(jh) == len(th)
    js = np.array([h["_score"] for h in jh], np.float64)
    ts = np.array([h["_score"] for h in th], np.float64)
    tol = np.asarray(tols, np.float64)
    assert np.all(np.abs(ts - js) <= tol), (ts, js)
    i = 0
    while i < len(jh):
        j = i + 1
        while j < len(jh) and abs(js[j] - js[i]) <= max(tol[i], tol[j]):
            j += 1
        assert {h["_id"] for h in jh[i:j]} == {h["_id"] for h in th[i:j]}
        for a, b in zip(jh[i:j], th[i:j]):
            if j - i == 1:
                assert a["_source"] == b["_source"]
        i = j
    if jr["hits"]["max_score"] is None:
        assert tr["hits"]["max_score"] is None
    else:
        assert abs(tr["hits"]["max_score"] - jr["hits"]["max_score"]) \
            <= tol[0]


def compare(jr, tr, vecs, field, q, plane, extra_rtol=0.0):
    assert tr["_plane"] == jr["_plane"] == plane
    assert tr["_shards"] == jr["_shards"]
    assert isinstance(tr["hits"]["total"], int)
    tols = [hit_tol(vecs, field, q, h["_id"])
            + extra_rtol * abs(h["_score"]) for h in jr["hits"]["hits"]]
    assert_same_knn_hits(jr, tr, tols)


def knn_requests(field):
    q0, q1, q2 = qvec(field, 0), qvec(field, 1), qvec(field, 2)
    return {
        "top_level": ({"knn": {"field": field, "query_vector": q0,
                               "k": 5}}, q0),
        "top_level_size_from": ({"knn": {"field": field, "query_vector": q1,
                                         "k": 12, "num_candidates": 50},
                                 "size": 6, "from": 3}, q1),
        "clause": ({"query": {"knn": {"field": field, "query_vector": q2,
                                      "k": 7}}, "size": 9}, q2),
        "filtered": ({"knn": {"field": field, "query_vector": q0, "k": 6,
                              "filter": {"match": {"body": "t1"}}}}, q0),
        "boosted_clause": ({"query": {"knn": {
            "field": field, "query_vector": q1, "boost": 2.0}},
            "size": 8}, q1),
    }


def plane_of(name, n_shards):
    if n_shards == 1 or name in ("filtered", "boosted_clause"):
        return "host"
    return "mesh_pallas"


@pytest.mark.parametrize("field", ["emb", "dot"])
@pytest.mark.parametrize("name", sorted(knn_requests("emb")))
@pytest.mark.parametrize("n_shards", [1, 3])
def test_knn_same_response_and_plane(pairs, n_shards, name, field):
    jidx, tidx, vecs = pairs[n_shards]
    body, q = knn_requests(field)[name]
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    scale = 2.0 if name == "boosted_clause" else 1.0
    tols = [scale * hit_tol(vecs, field, q, h["_id"])
            for h in jr["hits"]["hits"]]
    assert tr["_plane"] == jr["_plane"] == plane_of(name, n_shards)
    assert tr["_shards"] == jr["_shards"]
    assert_same_knn_hits(jr, tr, tols)


HYBRID = {
    "rrf": {"query": {"match": {"body": "t2 t5"}},
            "knn": {"field": "emb", "query_vector": qvec("emb", 3), "k": 8},
            "rank": {"rrf": {"rank_constant": 20, "window_size": 15}},
            "size": 10},
    "rrf_rank_window_size": {
        "query": {"match": {"body": "t1"}},
        "knn": {"field": "dot", "query_vector": qvec("dot", 4), "k": 5},
        "rank": {"rrf": {"rank_window_size": 12}}, "size": 6, "from": 2},
    "convex_boost": {"query": {"match": {"body": "t3 t6"}},
                     "knn": {"field": "emb", "query_vector": qvec("emb", 5),
                             "k": 6, "boost": 2.5},
                     "size": 12},
}


@pytest.mark.parametrize("name", sorted(HYBRID))
@pytest.mark.parametrize("n_shards", [1, 3])
def test_hybrid_same_response(pairs, n_shards, name):
    jidx, tidx, vecs = pairs[n_shards]
    body = HYBRID[name]
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    plane = "host" if n_shards == 1 else "mesh_pallas"
    assert tr["_hybrid"] == jr["_hybrid"] == {
        "lexical_plane": plane, "knn_plane": plane,
        "fusion": "convex" if name.startswith("convex") else "rrf"}
    assert tr["_plane"] == jr["_plane"]
    assert tr["_total_relation"] == jr["_total_relation"] == "gte"
    assert tr["_shards"] == jr["_shards"]
    if name.startswith("rrf"):
        # fused scores are a function of the two rank lists: exact
        assert [(h["_id"], h["_score"]) for h in tr["hits"]["hits"]] == \
            [(h["_id"], h["_score"]) for h in jr["hits"]["hits"]]
        assert tr["hits"]["total"] == jr["hits"]["total"]
    else:
        field, q = body["knn"]["field"], body["knn"]["query_vector"]
        tols = [2.5 * hit_tol(vecs, field, q, h["_id"])
                + RTOL_BM25 * abs(h["_score"]) for h in jr["hits"]["hits"]]
        assert_same_knn_hits(jr, tr, tols)


def batch_bodies(field):
    return [{"knn": {"field": field, "query_vector": qvec(field, 10 + i),
                     "k": 4 + i}} for i in range(3)]


@pytest.mark.parametrize("field", ["emb", "dot"])
def test_search_batch_of_three_same_per_member(pairs, field):
    jidx, tidx, vecs = pairs[3]
    bodies = batch_bodies(field)
    jout = jidx.search_batch([dict(b) for b in bodies])
    tout = tidx.search_batch([dict(b) for b in bodies])
    for body, jr, tr in zip(bodies, jout, tout):
        assert isinstance(tr, dict), tr
        compare(jr, tr, vecs, field, body["knn"]["query_vector"],
                "mesh_pallas")
    assert tidx._mesh_search.decisions.get(
        "mesh_pallas.knn_served_batched", 0) >= 3
    assert tidx.search_stats()["planes"]["knn_query_total"] >= 3


def test_batched_member_bit_equal_to_serial(pairs):
    _jidx, tidx, _vecs = pairs[3]
    bodies = batch_bodies("emb") + [{"query": {"match": {"body": "t1"}}}]
    out = tidx.search_batch([dict(b) for b in bodies])
    for body, got in zip(bodies, out):
        want = tidx.search(dict(body))
        assert got["_plane"] == want["_plane"] == "mesh_pallas"
        assert got["hits"]["total"] == want["hits"]["total"]
        assert ([(h["_id"], h["_score"]) for h in got["hits"]["hits"]]
                == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])


def test_knn_disabled_serves_host_on_both():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    common = {"index.number_of_shards": 3, "index.refresh_interval": -1,
              "search.knn.enabled": False}
    jidx = JIndex("knn-off", JSettings({
        **common, "search.aggs.fused": False,
        "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=MAPPING)
    jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService("knn-off", Settings(common), mapping=MAPPING,
                        device="cpu")
    try:
        docs, vecs = seeded_docs()
        for doc_id, src, routing in docs[:50]:
            jidx.index_doc(doc_id, src, routing=routing)
            tidx.index_doc(doc_id, src, routing=routing)
        jidx.refresh()
        tidx.refresh()
        body, q = knn_requests("emb")["top_level"]
        compare(jidx.search(dict(body)), tidx.search(dict(body)), vecs,
                "emb", q, "host")
        assert tidx._mesh_search.decisions.get("host.knn_disabled") == 1
    finally:
        jidx.close()
        tidx.close()
        mp.undo()


def test_same_after_deletes(pairs):
    for n_shards in (1, 3):
        jidx, tidx, vecs = pairs[n_shards]
        for d in ("0", "4", "17", "45", "46", "88"):
            assert (jidx.delete_doc(d, routing="a" if int(d) < 40 else None)
                    ["result"] == tidx.delete_doc(
                        d, routing="a" if int(d) < 40 else None)["result"]
                    == "deleted")
        jidx.refresh()
        tidx.refresh()
        for field in ("emb", "dot"):
            for name, (body, q) in knn_requests(field).items():
                jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
                compare(jr, tr, vecs, field, q, plane_of(name, n_shards),
                        extra_rtol=1e-6 if name == "boosted_clause" else 0)
                assert not {"0", "4", "17", "45"} & {
                    h["_id"] for h in tr["hits"]["hits"]}
        if n_shards == 3:
            bodies = batch_bodies("emb")
            for body, jr, tr in zip(
                    bodies, jidx.search_batch([dict(b) for b in bodies]),
                    tidx.search_batch([dict(b) for b in bodies])):
                compare(jr, tr, vecs, "emb", body["knn"]["query_vector"],
                        "mesh_pallas")
            planes = tidx.search_stats()["planes"]
            assert planes["plane_failures_total"] == {"mesh_pallas": 0,
                                                      "mesh": 0}


BAD_MAPPINGS = {
    "missing_dims": {"v": {"type": "dense_vector"}},
    "non_integer_dims": {"v": {"type": "dense_vector", "dims": "many"}},
    "zero_dims": {"v": {"type": "dense_vector", "dims": 0}},
    "unknown_similarity": {"v": {"type": "dense_vector", "dims": 3,
                                 "similarity": "l2_norm"}},
    "max_dims": {"v": {"type": "dense_vector", "dims": 2000}},
    "multi_field": {"t": {"type": "text", "fields": {
        "v": {"type": "dense_vector", "dims": 3}}}},
}


@pytest.mark.parametrize("name", sorted(BAD_MAPPINGS))
def test_bad_mapping_rejected_like_jax(name):
    mapping = {"properties": BAD_MAPPINGS[name]}
    with pytest.raises(jerr.ElasticsearchTpuException) as je:
        JIndex(f"bad-{name}", JSettings({"index.number_of_shards": 1}),
               mapping=mapping).close()
    with pytest.raises(terr.ElasticsearchTpuException) as te:
        IndexService(f"bad-{name}", Settings({"index.number_of_shards": 1}),
                     mapping=mapping, device="cpu")
    assert type(te.value).__name__ == type(je.value).__name__
    assert te.value.status_code == je.value.status_code == 400
    assert str(te.value) == str(je.value)


def test_max_dims_setting_raises_the_bound():
    mapping = {"properties": {"v": {"type": "dense_vector", "dims": 2000}}}
    svc = IndexService("wide", Settings({
        "index.number_of_shards": 1,
        "index.mapping.dense_vector.max_dims": 2048}), mapping=mapping,
        device="cpu")
    try:
        assert svc.mapper_service.field_type("v").dims == 2000
    finally:
        svc.close()


BAD_DOCS = {
    "wrong_length": {"v": [1.0, 2.0]},
    "nan": {"v": [1.0, float("nan"), 2.0]},
    "inf": {"v": [1.0, float("inf"), 2.0]},
    "not_a_list": {"v": 3.0},
    "non_numeric": {"v": [1.0, "x", 2.0]},
    "boolean": {"v": [1.0, True, 2.0]},
}


@pytest.mark.parametrize("name", sorted(BAD_DOCS))
def test_bad_vector_doc_rejected_like_jax(name):
    mapping = {"properties": {"v": {"type": "dense_vector", "dims": 3}}}
    jidx = JIndex(f"baddoc-{name}", JSettings({"index.number_of_shards": 1}),
                  mapping=mapping)
    tidx = IndexService(f"baddoc-{name}", Settings({
        "index.number_of_shards": 1}), mapping=mapping, device="cpu")
    try:
        with pytest.raises(jerr.ElasticsearchTpuException) as je:
            jidx.index_doc("1", BAD_DOCS[name])
        with pytest.raises(terr.ElasticsearchTpuException) as te:
            tidx.index_doc("1", BAD_DOCS[name])
        assert type(te.value).__name__ == type(je.value).__name__
        assert te.value.status_code == je.value.status_code == 400
        assert str(te.value) == str(je.value)
    finally:
        jidx.close()
        tidx.close()


BAD_REQUESTS = {
    "rank_without_query": {"knn": {"field": "emb",
                                   "query_vector": [0.0] * 20},
                           "rank": {"rrf": {}}},
    "knn_not_object": {"knn": [1, 2]},
    "wrong_query_length": {"knn": {"field": "emb",
                                   "query_vector": [0.0] * 3}},
    "nan_query": {"query": {"knn": {"field": "emb",
                                    "query_vector": [float("nan")] * 20}}},
    "unknown_param": {"query": {"knn": {"field": "emb",
                                        "query_vector": [0.0] * 20,
                                        "similarity_boost": 2}}},
    "not_a_vector_field": {"query": {"knn": {"field": "body",
                                             "query_vector": [0.0] * 20}}},
    "rrf_unknown_knob": {"query": {"match": {"body": "t1"}},
                         "knn": {"field": "emb",
                                 "query_vector": [0.0] * 20},
                         "rank": {"rrf": {"rank_constnat": 5}}},
    "rrf_bad_constant": {"query": {"match": {"body": "t1"}},
                         "knn": {"field": "emb",
                                 "query_vector": [0.0] * 20},
                         "rank": {"rrf": {"rank_constant": 0}}},
}


@pytest.mark.parametrize("name", sorted(BAD_REQUESTS))
def test_bad_request_400_like_jax(pairs, name):
    jidx, tidx, _vecs = pairs[3]
    body = BAD_REQUESTS[name]
    with pytest.raises(jerr.ElasticsearchTpuException) as je:
        jidx.search(dict(body))
    with pytest.raises(terr.ElasticsearchTpuException) as te:
        tidx.search(dict(body))
    assert type(te.value).__name__ == type(je.value).__name__
    assert te.value.status_code == je.value.status_code == 400
    assert str(te.value) == str(je.value)


SHAPES = {
    "top_level": {"knn": {"field": "emb", "query_vector": [1.0]}},
    "top_level_size": {"knn": {"field": "emb", "query_vector": [1.0]},
                       "size": 3, "from": 1, "_source": False},
    "clause": {"query": {"knn": {"field": "emb", "query_vector": [1.0]}}},
    "filtered": {"knn": {"field": "emb", "query_vector": [1.0],
                         "filter": {"term": {"n": 1}}}},
    "boosted": {"knn": {"field": "emb", "query_vector": [1.0],
                        "boost": 2.0}},
    "unknown_param": {"knn": {"field": "emb", "query_vector": [1.0],
                              "oops": 1}},
    "hybrid": {"query": {"match": {"body": "t1"}},
               "knn": {"field": "emb", "query_vector": [1.0]}},
    "with_aggs": {"knn": {"field": "emb", "query_vector": [1.0]},
                  "aggs": {"n": {"terms": {"field": "n"}}}},
    "clause_in_bool": {"query": {"bool": {"must": [{"knn": {
        "field": "emb", "query_vector": [1.0]}}]}}},
    "lexical": {"query": {"match": {"body": "t1"}}},
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_batch_eligibility_equals_jax(name):
    from elasticsearch_tpu.search import batching as jb
    from elasticsearch_tpu_torch.search import batching as tb

    body = SHAPES[name]
    assert tb.batchable_body(body) == jb.batchable_body(body)
    assert tb.knn_batch_spec(body) == jb.knn_batch_spec(body)


def test_node_seeds_knn_settings_and_validates_them():
    from elasticsearch_tpu_torch.node import Node

    node = Node(Settings({"search.knn.enabled": False}), device="cpu")
    bad = Node(Settings({"search.knn.tile_sub": 12}), device="cpu")
    try:
        node.create_index("v", {"settings": {"number_of_shards": 3,
                                             "refresh_interval": "-1"},
                                "mappings": {"_doc": MAPPING}})
        docs, _vecs = seeded_docs()
        node.bulk([("index", {"_index": "v", "_id": d, "routing": r}, src)
                   for d, src, r in docs], refresh=True)
        r = node.search("v", {"knn": {"field": "emb",
                                      "query_vector": qvec("emb", 0)}})
        assert r["_plane"] == "host" and len(r["hits"]["hits"]) == 10
        with pytest.raises(terr.IllegalArgumentException):
            bad.create_index("w", {})
    finally:
        node.close()
        bad.close()


def test_threaded_knn_burst_through_node_equals_serial():
    from elasticsearch_tpu_torch.node import Node

    node = Node(Settings({"search.batch.window_ms": 150.0}), device="cpu")
    try:
        _threaded_knn_burst(node)
    finally:
        node.close()


def _threaded_knn_burst(node):
    import threading

    # a fixed segment layout: no scheduled refresh between the serial
    # answers and the burst
    node.create_index("v", {"settings": {"number_of_shards": 3,
                                         "refresh_interval": "-1"},
                            "mappings": {"_doc": MAPPING}})
    docs, _vecs = seeded_docs()
    node.bulk([("index", {"_index": "v", "_id": d, "routing": r}, src)
               for d, src, r in docs], refresh=True)
    bodies = [{"knn": {"field": "emb", "query_vector": qvec("emb", 20 + i),
                       "k": 6}} for i in range(6)]
    serial = [node.search("v", dict(b)) for b in bodies]
    start = threading.Barrier(len(bodies))
    got = {}

    def worker(i):
        start.wait()
        got[i] = node.search("v", dict(bodies[i]))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    for i, want in enumerate(serial):
        assert ([(h["_id"], h["_score"]) for h in got[i]["hits"]["hits"]]
                == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])
        assert got[i]["hits"]["total"] == want["hits"]["total"]
    decisions = node.indices["v"]._mesh_search.decisions
    assert decisions.get("mesh_pallas.knn_served_batched", 0) >= 2


def test_nested_include_in_parent_vector_searchable():
    """A vector under an ``include_in_parent`` nested path flattens onto
    its root doc and answers a kNN query there, as in the JAX package
    (tests/test_knn.py); two objects carrying the same vector path are
    the JAX package's 400."""
    mapping = {"properties": {"obj": {
        "type": "nested", "include_in_parent": True,
        "properties": {"emb": {"type": "dense_vector", "dims": 4}}}}}
    settings = {"index.number_of_shards": 1, "index.refresh_interval": -1}
    jidx = JIndex("nestv", JSettings({**settings,
                                      "index.requests.cache.enable": False}),
                  mapping=mapping)
    tidx = IndexService("nestv", Settings(settings), mapping=mapping,
                        device="cpu")
    try:
        for idx in (jidx, tidx):
            idx.index_doc("a", {"obj": [{"emb": [1.0, 0.0, 0.0, 0.0]}]})
            idx.index_doc("b", {"obj": [{"emb": [0.6, 0.8, 0.0, 0.0]}]})
            idx.refresh()
        body = {"query": {"knn": {"field": "obj.emb",
                                  "query_vector": [1.0, 0.0, 0.0, 0.0]}}}
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        assert [h["_id"] for h in tr["hits"]["hits"]] == ["a", "b"]
        assert ([h["_id"] for h in tr["hits"]["hits"]]
                == [h["_id"] for h in jr["hits"]["hits"]])
        np.testing.assert_allclose(
            [h["_score"] for h in tr["hits"]["hits"]],
            [h["_score"] for h in jr["hits"]["hits"]], rtol=RTOL_BM25)
        seg, = tidx.shards[0].engine.segments
        assert seg.vector_columns["obj.emb"].count == 2
        assert seg.nested["obj"].segment.vector_columns["obj.emb"].count == 2
        bad = {"obj": [{"emb": [1, 0, 0, 0]}, {"emb": [0, 1, 0, 0]}]}
        with pytest.raises(jerr.MapperParsingException) as je:
            jidx.index_doc("c", bad)
        with pytest.raises(terr.MapperParsingException) as te:
            tidx.index_doc("c", bad)
        assert str(te.value) == str(je.value)
        assert te.value.status_code == 400
    finally:
        jidx.close()
        tidx.close()
