"""``profile``, ``_explain`` and ``_validate/query`` on the port, against
the JAX package.

Each case feeds the same documents to a JAX index or node (tile kernel in
interpret mode, ``ES_TPU_PALLAS=interpret``; a one-device mesh where the
mesh plane serves) and to a port one (``device="cpu"``):

- ``profile``: the hits equal the unprofiled request's on the same plane
  (profiling never moves a request off its plane), and the profile
  section has the JAX keys: ``plane``, the ``phases`` (the same phase
  names; times are the host clock's and differ), ``annotations`` and, on
  the host rung, one tree a segment whose node types, children and
  breakdown keys equal the JAX ones, with the port's own ``engine`` name;
- ``_explain`` on its four routes, with ``?q=`` and the ``_source``
  parameters: the answer equals the JAX one (the summary description
  names the port's program), its value is the hit's ``_score`` bit for
  bit, and the per-term BM25 details equal the JAX ones within rtol 1e-5;
- ``_validate/query`` answers valid and invalid (with ``?explain``) as
  the JAX package does.

Every fixture closes what it opens.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu.rest.controller import RestController as JRest
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController
from test_torch_search_fault_tolerance import same

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "tag": {"type": "keyword"},
    "n": {"type": "integer"},
    "emb": {"type": "dense_vector", "dims": 8, "similarity": "cosine"},
}}


def _docs(n_docs=80, seed=0):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(12)]
    out = []
    for d in range(n_docs):
        toks = [vocab[rng.randint(len(vocab))]
                for _ in range(rng.randint(3, 9))]
        out.append((str(d), {"body": " ".join(toks), "n": d,
                             "tag": f"g{d % 3}",
                             "emb": rng.randn(8).round(3).tolist()}))
    return out


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


def _pair(name, shards, extra=None):
    common = {"index.number_of_shards": shards, "index.refresh_interval": -1,
              **(extra or {})}
    j = JIndex(name, JSettings({**common, "search.aggs.fused": False,
                                "index.staging.delta.enabled": False,
                                "index.requests.cache.enable": False}),
               mapping=MAPPING)
    j._mesh_search = JMesh(j, mesh=shard_mesh(1))
    t = IndexService(name, Settings(common), mapping=MAPPING, device="cpu")
    for doc_id, src in _docs():
        j.index_doc(doc_id, src)
        t.index_doc(doc_id, src)
    j.refresh()
    t.refresh()
    return j, t


@pytest.fixture(scope="module", params=[
    ("mesh", 2, {}), ("host", 1, {}),
    ("pruned", 2, {"search.pallas.pruning.enabled": True,
                   "search.pallas.pruning.probe_tiles": 2,
                   "index.search.pallas.postings_codec": "packed"})],
    ids=["mesh", "host", "pruned"])
def pair(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    name, shards, extra = request.param
    j, t = _pair(f"pe-{name}", shards, extra)
    yield name, j, t
    j.close()
    t.close()
    mp.undo()


def hits_of(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def tree_shape(tree):
    """A profile tree's node types and breakdown keys, recursively."""
    return {"type": tree["type"], "breakdown": sorted(tree["breakdown"]),
            "children": [tree_shape(c) for c in tree.get("children", [])]}


BODIES = {
    "match": {"query": {"match": {"body": "t0 t1"}}, "size": 5},
    "bool": {"query": {"bool": {"must": [{"match": {"body": "t3"}}],
                                "filter": [{"range": {"n": {"gte": 10}}}]}},
             "size": 5},
    "agg": {"query": {"match": {"body": "t2"}}, "size": 3,
            "aggs": {"g": {"terms": {"field": "tag"}}}},
    "knn": {"knn": {"field": "emb", "query_vector": [0.5] * 8, "k": 4}},
}


@pytest.mark.parametrize("kind", sorted(BODIES))
def test_profile_keeps_the_plane_and_the_hits(pair, kind):
    name, j, t = pair
    body = BODIES[kind]
    plain = t.search(dict(body))
    prof = t.search(dict(body, profile=True))
    jprof = j.search(dict(body, profile=True))
    assert prof["_plane"] == plain["_plane"] == jprof["_plane"]
    assert hits_of(prof) == hits_of(plain)
    same({k: v for k, v in jprof.items() if k != "profile"},
         {k: v for k, v in prof.items() if k != "profile"})
    p, jp = prof["profile"], jprof["profile"]
    assert set(p) == set(jp) == {"shards", "plane", "phases", "annotations"}
    assert p["plane"] == jp["plane"] == prof["_plane"]
    assert {s["phase"] for s in p["phases"]} == {
        s["phase"] for s in jp["phases"]}
    assert all(s["time_in_nanos"] >= 0 and s["count"] >= 1
               for s in p["phases"])
    assert [s["id"] for s in p["shards"]] == [s["id"] for s in jp["shards"]]
    for s, js in zip(p["shards"], jp["shards"]):
        assert s["plane"] == js["plane"] == "host"
        (q,), (jq,) = s["searches"][0]["query"], js["searches"][0]["query"]
        assert tree_shape(q) == tree_shape(jq)
        assert q["engine"] == {"pallas_tile_kernel": "plain_tile_kernel",
                               "xla_scatter": "torch_scatter"}[jq["engine"]]
        assert q["description"] == jq["description"]
        assert s["searches"][0]["collector"][0]["name"] == "TopKSelector"
    if name == "host":
        assert p["shards"]
    if name == "pruned" and "_pruned" in prof:
        for key in ("tiles_scored", "tiles_pruned", "batch_size",
                    "batch_member_index"):
            assert p["annotations"][key] == jp["annotations"][key]


def test_a_profiled_burst_member(pair):
    name, j, t = pair
    burst = [{"query": {"match": {"body": f"t{i}"}}, "size": 4,
              "profile": True} for i in range(3)]
    out = t.search_batch([dict(b) for b in burst])
    jout = j.search_batch([dict(b) for b in burst])
    for q, (got, jgot) in enumerate(zip(out, jout)):
        assert got["_plane"] == jgot["_plane"]
        assert hits_of(got) == hits_of(t.search(
            {k: v for k, v in burst[q].items() if k != "profile"}))
        assert got["profile"]["phases"]
        for key in ("batch_size", "batch_member_index"):
            assert (got["profile"]["annotations"].get(key)
                    == jgot["profile"]["annotations"].get(key))


@pytest.fixture(scope="module")
def nodes():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(JSettings.EMPTY), Node(device="cpu")
    for n in (jn, tn):
        for name, shards in (("ex", 2), ("ex1", 1)):
            n.create_index(name, {"settings": {"number_of_shards": shards},
                                  "mappings": {"doc": MAPPING}})
            for doc_id, src in _docs(40, seed=5):
                n.index_doc(name, doc_id, src)
            n.indices[name].refresh()
    jn.indices["ex"]._mesh_search = JMesh(jn.indices["ex"],
                                          mesh=shard_mesh(1))
    yield jn, tn
    jn.close()
    tn.close()
    mp.undo()


def _port_summary(out):
    """The JAX summary names its TPU program; the port's its own."""
    exp = out.get("explanation") if isinstance(out, dict) else None
    if exp and exp.get("description") == "score via the fused query program":
        exp["description"] = "score via the fused TPU query program"
    return out


def both_rest(nodes, method, path, params=None, body=None):
    jn, tn = nodes
    raw = json.dumps(body).encode() if body is not None else None
    js, jp = JRest(jn).dispatch(method, path, dict(params or {}), raw)
    ts, tp = RestController(tn).dispatch(method, path, dict(params or {}),
                                         raw)
    assert ts == js, (ts, js, tp, jp)
    same(jp, _port_summary(tp))
    return ts, tp


ROUTES = ["/{index}/doc/{id}/_explain", "/{index}/_explain/{id}"]


@pytest.mark.parametrize("index", ["ex", "ex1"])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("method", ["GET", "POST"])
def test_explain_the_top_hits(nodes, index, route, method):
    jn, tn = nodes
    query = {"match": {"body": "t1 t4"}}
    top = tn.search(index, {"query": query, "size": 10})
    assert top["hits"]["hits"]
    for h in top["hits"]["hits"]:
        st, out = both_rest(nodes, method,
                            route.format(index=index, id=h["_id"]),
                            body={"query": query})
        assert st == 200 and out["matched"] is True
        # the same float the search gave, bit for bit
        assert out["explanation"]["value"] == h["_score"]
        assert out["explanation"]["description"] == "sum of:"
        assert len(out["explanation"]["details"]) >= 1


@pytest.mark.parametrize("route", ROUTES)
def test_explain_a_miss_q_and_source_params(nodes, route):
    jn, tn = nodes
    r = tn.search("ex", {"query": {"match": {"body": "t2"}}, "size": 40})
    hit_ids = {h["_id"] for h in r["hits"]["hits"]}
    miss = next(str(d) for d in range(40) if str(d) not in hit_ids)
    st, out = both_rest(nodes, "GET", route.format(index="ex", id=miss),
                        body={"query": {"match": {"body": "t2"}}})
    assert out["matched"] is False and out["explanation"]["value"] == 0.0
    hit = sorted(hit_ids)[0]
    st, out = both_rest(nodes, "GET", route.format(index="ex", id=hit),
                        params={"q": "body:t2", "_source": "n,tag"})
    assert out["matched"] is True and set(out["get"]["_source"]) == {"n",
                                                                     "tag"}
    # a query without term lanes keeps the summary
    both_rest(nodes, "GET", route.format(index="ex", id=hit),
              params={"_source_excludes": "emb"},
              body={"query": {"range": {"n": {"gte": 0}}}})
    # a bare query object at the top level is a 400
    st, _out = both_rest(nodes, "GET", route.format(index="ex", id=hit),
                         body={"match": {"body": "t2"}})
    assert st == 400


@pytest.mark.parametrize("body,params", [
    ({"query": {"match": {"body": "t1"}}}, {}),
    ({"query": {"bool": {"must": [{"term": {"tag": "g1"}}]}}}, {}),
    ({"query": {"no_such_query": {"body": "t1"}}}, {}),
    ({"query": {"no_such_query": {"body": "t1"}}}, {"explain": "true"}),
    ({"query": {"match": {"body": "t1"}}}, {"explain": "true"}),
])
@pytest.mark.parametrize("method", ["GET", "POST"])
def test_validate_query(nodes, body, params, method):
    st, out = both_rest(nodes, method, "/ex/_validate/query", params, body)
    assert st == 200
    assert out["valid"] == ("no_such_query" not in json.dumps(body))
