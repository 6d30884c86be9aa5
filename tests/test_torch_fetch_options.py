"""The fetch options and the request keys of the search-request remainder
on the port, against the JAX package.

Each case feeds the same documents to a JAX index or node (tile kernel in
interpret mode, ``ES_TPU_PALLAS=interpret``; a one-device mesh where the
mesh plane serves) and to a port one (``device="cpu"``), sends both the
same request and holds the port's answer to the JAX one (every key but
``took`` equal, scores within rtol 1e-5): ``stored_fields`` (``"_none_"``
drops ``_source``, any other value keeps it), ``docvalue_fields`` (numeric
columns as float64 values, ordinal columns as terms, the ``.keyword``
fallback, the object form), an empty ``script_fields``,
``track_total_hits`` in the body and as a REST parameter (on the pruned
mesh plane too, where it asks for the exact total), and the ``stats``
groups each shard counts on both planes. Every case closes what it opens.
"""

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
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "ts": {"type": "date"},
    "score": {"type": "double"},
}}


def _docs(n=40):
    out = []
    for d in range(n):
        src = {"title": f"w{d % 4} w{d % 7} common", "tag": f"t{d % 3}",
               "n": d, "ts": 1_600_000_000_000 + d * 3_600_000,
               # a dynamically mapped string: text with a keyword subfield
               "note": f"note {d % 2}"}
        if d % 5:
            src["score"] = [d * 0.5, d * 0.25]  # two values, column order
        out.append((str(d), src))
    return out


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


class Pair:
    def __init__(self, name, shards=2, mesh=True, extra=None):
        common = {"index.number_of_shards": shards,
                  "index.refresh_interval": -1,
                  "index.search.mesh": mesh, **(extra or {})}
        self.j = JIndex(name, JSettings({
            **common, "search.aggs.fused": False,
            "index.staging.delta.enabled": False,
            "index.requests.cache.enable": False}), mapping=MAPPING)
        if mesh:
            # the port serves one device: give the JAX plane one too
            self.j._mesh_search = JMesh(self.j, mesh=shard_mesh(1))
        self.t = IndexService(name, Settings(common), mapping=MAPPING,
                              device="cpu")
        for doc_id, src in _docs():
            self.j.index_doc(doc_id, src)
            self.t.index_doc(doc_id, src)
        self.j.refresh()
        self.t.refresh()

    def search(self, body):
        jr, tr = self.j.search(dict(body)), self.t.search(dict(body))
        same(jr, tr)
        return tr

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture(scope="module", params=["host", "mesh"])
def pair(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    p = Pair(f"fo-{request.param}", mesh=request.param == "mesh")
    yield p
    p.close()
    mp.undo()


MATCH = {"match": {"title": "w1 common"}}


@pytest.mark.parametrize("stored", ["_none_", ["*"], "title", []])
def test_stored_fields(pair, stored):
    r = pair.search({"query": MATCH, "size": 5, "stored_fields": stored})
    assert r["hits"]["hits"]
    has_source = all("_source" in h for h in r["hits"]["hits"])
    assert has_source == (stored != "_none_")
    assert all("_source" not in h for h in r["hits"]["hits"]) == (
        stored == "_none_")


@pytest.mark.parametrize("fields", [
    ["n", "tag"],
    ["ts", "score"],
    ["note"],                                   # the .keyword fallback
    [{"field": "n", "format": "use_field_mapping"}, "missing_field"],
])
def test_docvalue_fields(pair, fields):
    r = pair.search({"query": MATCH, "size": 8, "docvalue_fields": fields})
    hits = r["hits"]["hits"]
    assert hits
    for h in hits:
        d = int(h["_id"])
        f = h.get("fields", {})
        if "n" in f:
            assert f["n"] == [float(d)]
        if "tag" in f:
            assert f["tag"] == [f"t{d % 3}"]
        if "score" in fields:
            assert ("score" in f) == bool(d % 5)
        assert "missing_field" not in f
    if fields == ["note"]:
        assert all(h["fields"]["note"] == [f"note {int(h['_id']) % 2}"]
                   for h in hits)


def test_docvalue_fields_with_stored_fields_none(pair):
    r = pair.search({"query": MATCH, "size": 3, "stored_fields": "_none_",
                     "docvalue_fields": ["n"], "_source": False})
    assert all(set(h) >= {"_id", "fields"} and "_source" not in h
               for h in r["hits"]["hits"])


def test_empty_script_fields(pair):
    r = pair.search({"query": MATCH, "size": 4, "script_fields": {},
                     "stored_fields": ["*"], "docvalue_fields": ["ts"]})
    assert all(h["fields"]["ts"] for h in r["hits"]["hits"])


def test_script_fields_with_a_script_is_refused(pair):
    """Refused until ``script/`` was ported: now the values equal the JAX
    package's."""
    body = {"query": MATCH, "script_fields": {
        "twice": {"script": {"source": "doc['n'].value * 2"}}}}
    r = pair.search(body)
    assert all(h["fields"]["twice"] == [2.0 * int(h["_id"])]
               for h in r["hits"]["hits"])


def test_track_total_hits_in_the_body(pair):
    for tth in (True, 5, False):
        r = pair.search({"query": MATCH, "size": 2, "track_total_hits": tth})
        assert isinstance(r["hits"]["total"], int)


def test_stats_groups(pair):
    before_t = [dict(s.searcher.group_stats) for s in pair.t.shards.values()]
    for body in ({"query": MATCH, "stats": ["dash", "ui"]},
                 {"query": {"match_all": {}}, "stats": ["dash"]},
                 {"query": MATCH, "size": 0, "stats": ["ui"],
                  "aggs": {"t": {"terms": {"field": "tag"}}}}):
        pair.search(body)
    for sid in sorted(pair.t.shards):
        jg = pair.j.shards[sid].searcher.group_stats
        tg = pair.t.shards[sid].searcher.group_stats
        assert tg == jg, (sid, tg, jg)
        assert tg != before_t[sid]


@pytest.fixture(scope="module")
def nodes():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(JSettings.EMPTY), Node(device="cpu")
    for n in (jn, tn):
        n.create_index("fr", {"settings": {"number_of_shards": 1},
                              "mappings": MAPPING})
        for doc_id, src in _docs(12):
            n.index_doc("fr", doc_id, src)
        n.indices["fr"].refresh()
    yield jn, tn
    jn.close()
    tn.close()
    mp.undo()


@pytest.mark.parametrize("params", [
    {"track_total_hits": "true"}, {"track_total_hits": "7"},
    {"track_total_hits": "false"}, {},
])
def test_track_total_hits_as_a_rest_parameter(nodes, params):
    jn, tn = nodes
    args = ("GET", "/fr/_search", params, b'{"query": {"match_all": {}}}')
    js, jp = JRest(jn).dispatch(*args)
    ts, tp = RestController(tn).dispatch(*args)
    assert ts == js == 200
    same(jp, tp)
    opted = params.get("track_total_hits") in ("true", "7")
    assert tp["hits"]["total"] == ({"value": 12, "relation": "eq"}
                                   if opted else 12)


PRUNE = {"search.pallas.pruning.enabled": True,
         "search.pallas.pruning.probe_tiles": 2,
         "index.search.pallas.postings_codec": "packed"}


def test_track_total_hits_runs_the_pruned_path_exhaustively():
    from test_torch_pruned import build_pair

    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = build_pair("fo-prune", **PRUNE)
    try:
        body = {"query": {"match": {"body": "t0 t3 t7"}}, "size": 10}
        pruned = tidx.search(dict(body))
        assert pruned["_pruned"]["total_relation"] == "gte"
        exact = tidx.search({**body, "size": 0})
        jr = jidx.search(dict(body, track_total_hits=True))
        tr = tidx.search(dict(body, track_total_hits=True))
        same(jr, tr)
        assert tr["_plane"] == "mesh_pallas" and "_pruned" not in tr
        assert tr["hits"]["total"] == exact["hits"]["total"]
        assert pruned["hits"]["total"] <= tr["hits"]["total"]
        assert [h["_id"] for h in tr["hits"]["hits"]] == [
            h["_id"] for h in pruned["hits"]["hits"]]
    finally:
        jidx.close()
        tidx.close()
        mp.undo()
