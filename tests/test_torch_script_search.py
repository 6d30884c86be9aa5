"""The script query, ``script_fields`` and ``scripted_metric`` on the port,
against the JAX package.

Mirrors ``tests/test_geo_script.py``'s ``TestScriptQuery``, the
``script_fields`` tests of ``tests/test_search_features.py`` and the
search half of ``tests/test_painless.py``'s ``TestContexts``, and adds
``scripted_metric`` with and without a reduce script. Each case feeds the
same documents to a JAX index and a port one (``device="cpu"``), on the
host rung (``index.search.mesh: false``) and on the mesh plane (the JAX
plane on a one-device mesh, its tile kernel in interpret mode), and holds
the port's answer to the JAX one: every key but ``took`` equal (the
plane, ids, totals, script field values, the metric), scores within rtol
1e-5; on the mesh plane the ladder's decision counters and the fused
aggregations' fallback reasons equal too. A failing script raises the
same class with the same message in both. A burst of script requests
through ``search_batch`` answers as the same requests one at a time.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from test_torch_search_fault_tolerance import same

MAPPING = {"properties": {
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "price": {"type": "double"},
    "population": {"type": "long"},
    "area": {"type": "double"},
}}


def _docs(n=48, seed=4):
    rng = np.random.RandomState(seed)
    out = []
    for d in range(n):
        src = {"title": f"w{d % 4} w{d % 7} common", "tag": f"t{d % 3}",
               "population": int(rng.randint(1_000, 900_000)),
               "area": float(np.round(rng.rand() * 300 + 20, 2))}
        if d % 6:
            src["n"] = d
        if d % 5:
            src["price"] = float(np.round(rng.rand() * 40, 3))
        out.append((str(d), src))
    return out


class Pair:
    def __init__(self, name, mesh):
        common = {"index.number_of_shards": 2,
                  "index.refresh_interval": -1, "index.search.mesh": mesh}
        self.j = JIndex(name, JSettings({
            **common, "index.requests.cache.enable": False}),
            mapping=MAPPING)
        if mesh:
            # the port serves one device: give the JAX plane one too
            self.j._mesh_search = JMesh(self.j, mesh=shard_mesh(1))
        self.t = IndexService(name, Settings(common), mapping=MAPPING,
                              device="cpu")
        self.mesh = mesh
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
    p = Pair(f"scr-{request.param}", mesh=request.param == "mesh")
    yield p
    p.close()
    mp.undo()


MATCH = {"match": {"title": "w1 common"}}


def script(source, **params):
    return {"script": {"source": source, **({"params": params}
                                            if params else {})}}


QUERIES = {
    # test_geo_script.py TestScriptQuery
    "density_filter": {"script": script(
        "doc['population'].value / doc['area'].value > 3000")},
    "with_params": {"script": script(
        "doc['population'].value > params.threshold", threshold=500000)},
    "in_bool_filter": {"bool": {
        "must": [{"term": {"tag": "t1"}}],
        "filter": [{"script": {"script": "doc['area'].value < 100"}}]}},
    "division_by_missing_field": {"script": script(
        "1 / doc['absent'].value > 0")},
    # the forms phase 20 of chip_smoke.py drives
    "under_match": {"bool": {"must": [MATCH], "filter": [
        {"script": script("doc['n'].value > params.t", t=20)}]}},
    "length": {"script": script("doc['price'].length > 0")},
    "absent_divisor": {"script": script(
        "doc['n'].value / doc['absent'].value > 1")},
    "constant_true": {"script": script("2 > 1")},
    "constant_false": {"script": script("0")},
    "scalar_zero_division": {"script": script("params.a / 0", a=1)},
    "boosted": {"bool": {"must": [MATCH], "should": [
        {"script": {"script": "doc['n'].value > 30", "boost": 2.5}}]}},
    # test_painless.py TestContexts.test_script_query_painless
    "painless": {"bool": {"filter": [{"script": script(
        "if (doc['n'].size() == 0) { return false } "
        "def v = doc['n'].value; return v % 3 == 0")}]}},
    "painless_params": {"script": script(
        "if (doc['population'].size() == 0) { return false } "
        "def y = doc['population'].value; return y > params.lo && "
        "y < params.hi", lo=100000, hi=400000)},
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_script_query_like_jax(pair, name):
    jm = pair.j._mesh_search if pair.mesh else None
    tm = pair.t._mesh_plane() if pair.mesh else None
    jd0 = dict(pair.j.telemetry.decisions) if jm else {}
    td0 = dict(tm.decisions) if tm else {}
    r = pair.search({"query": QUERIES[name], "size": 50})
    if not pair.mesh:
        assert r["_plane"] == "host"
        return
    delta = lambda d, d0: {k: v - d0.get(k, 0) for k, v in d.items()  # noqa
                           if v != d0.get(k, 0)}
    assert delta(tm.decisions, td0) == delta(
        dict(pair.j.telemetry.decisions), jd0)


def test_script_query_totals(pair):
    """The totals are the numpy counts over the source values."""
    docs = dict(_docs())
    r = pair.search({"query": QUERIES["with_params"], "size": 0})
    assert r["hits"]["total"] == sum(
        s["population"] > 500000 for s in docs.values())
    r = pair.search({"query": QUERIES["division_by_missing_field"],
                     "size": 0})
    assert r["hits"]["total"] == len(docs)
    r = pair.search({"query": QUERIES["constant_false"], "size": 0})
    assert r["hits"]["total"] == 0


@pytest.fixture(params=["host", "mesh"])
def fresh(request, monkeypatch):
    """A pair of its own: a failing request benches the JAX mesh plane
    (C15), which would move the module pair's later answers."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    p = Pair(f"scr-err-{request.param}", mesh=request.param == "mesh")
    yield p
    p.close()


@pytest.mark.parametrize("source,at_run_time", [
    ("__import__('os').system('id')", True),
    ("doc['tag'].value.startsWith('t')", True),
    ("def x = ", False),   # a compile error, before any plane
])
def test_script_query_errors_like_jax(fresh, source, at_run_time):
    """A failing script raises the JAX package's class and message. On
    the mesh plane the JAX package then benches the plane for the
    cooldown and serves the next request from the host rung; the port
    raises the request error without a plane fault and stays on the mesh
    plane (C15)."""
    body = {"query": {"script": script(source)}}
    with pytest.raises(Exception) as je:
        fresh.j.search(dict(body))
    with pytest.raises(Exception) as te:
        fresh.t.search(dict(body))
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)
    after = {"query": MATCH, "size": 5}
    jr, tr = fresh.j.search(dict(after)), fresh.t.search(dict(after))
    if fresh.mesh and at_run_time:
        assert (jr["_plane"], tr["_plane"]) == ("host", "mesh_pallas")
        tr = dict(tr, _plane="host")
    same(jr, tr)


SCRIPT_FIELDS = {
    # test_search_features.py TestScriptFields
    "arithmetic": {"pop2": script("doc['population'].value * 2"),
                   "with_params": script("doc['population'].value + "
                                         "params.bonus", bonus=5)},
    "score": {"s": script("_score * 10 + doc['n'].value")},
    "missing_values": {"p": script("doc['price'].value + doc['price'].length"),
                       "z": script("doc['absent'].value")},
    # test_painless.py TestContexts.test_script_fields_painless_strings
    "painless_strings": {"label": script(
        "return doc['tag'].value.toUpperCase() + '-' + (int) doc['n'].value")},
    "painless_params": {"l": script("return params.p + doc['tag'].value",
                                    p="tag:")},
    "non_numeric_params": {"c": script("params.label", label="x")},
}


@pytest.mark.parametrize("sort", [None, [{"population": "asc"}]])
@pytest.mark.parametrize("name", sorted(SCRIPT_FIELDS))
def test_script_fields_like_jax(pair, name, sort):
    body = {"query": MATCH, "size": 12, "script_fields": SCRIPT_FIELDS[name]}
    if sort is not None:
        body["sort"] = sort
    if name == "painless_strings":
        body["query"] = {"bool": {"must": [MATCH], "filter": [
            {"exists": {"field": "n"}}]}}
    r = pair.search(body)
    assert r["hits"]["hits"]
    assert all(set(h["fields"]) == set(SCRIPT_FIELDS[name])
               for h in r["hits"]["hits"])


def test_script_fields_reject_non_numeric_like_jax(fresh):
    body = {"query": {"match_all": {}}, "script_fields": {
        "bad": {"script": {"source": "__import__('os')"}}}}
    with pytest.raises(Exception) as je:
        fresh.j.search(dict(body))
    with pytest.raises(Exception) as te:
        fresh.t.search(dict(body))
    assert type(te.value).__name__ == type(je.value).__name__ \
        == "ScriptException"


METRICS = {
    "sum_twice": {"map_script": "doc['n'].value * 2"},
    "with_reduce": {"map_script": "doc['n'].value * 2",
                    "reduce_script": "params._agg / 2 + params.k",
                    "params": {"k": 1}},
    "real_values": {"map_script": "doc['price'].value * 1.1 + "
                                  "doc['area'].value / 3"},
    "comparison": {"map_script": "doc['price'].value > 20"},
    "constant": {"map_script": "1"},
    "scalar_zero_division": {"map_script": "params.a / 0",
                             "params": {"a": 1}},
    "painless_map": {"map_script": {"source": "if (doc['n'].size() == 0) "
                                              "{ return 0 } return "
                                              "doc['n'].value % 4"}},
}


@pytest.mark.parametrize("query", [None, MATCH])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_scripted_metric_like_jax(pair, name, query):
    body = {"size": 0, "aggs": {"m": {"scripted_metric": METRICS[name]},
                                "t": {"terms": {"field": "tag"}}}}
    if query is not None:
        body["query"] = query
    jm = pair.j._mesh_search if pair.mesh else None
    tm = pair.t._mesh_plane() if pair.mesh else None
    ja0 = dict(jm.agg_host_fallback_by_reason) if jm else {}
    ta0 = dict(tm.agg_host_fallback_by_reason) if tm else {}
    jr, tr = pair.j.search(dict(body)), pair.t.search(dict(body))
    jv, tv = jr["aggregations"]["m"]["value"], tr["aggregations"]["m"]["value"]
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    same(dict(jr, aggregations=None), dict(tr, aggregations=None))
    assert tr["aggregations"]["t"] == jr["aggregations"]["t"]
    if name in ("sum_twice", "constant", "comparison"):
        assert tv == jv  # integral values: exact
    if name == "sum_twice":
        docs = dict(_docs())
        want = sum(2 * s["n"] for d, s in docs.items() if "n" in s and (
            query is None or "w1" in s["title"].split()
            or "common" in s["title"].split()))
        assert tv == float(want)
    if pair.mesh:
        delta = {k: v - ta0.get(k, 0) for k, v in
                 tm.agg_host_fallback_by_reason.items()
                 if v != ta0.get(k, 0)}
        assert delta == {k: v - ja0.get(k, 0) for k, v in
                         jm.agg_host_fallback_by_reason.items()
                         if v != ja0.get(k, 0)}
        assert delta == {"unsupported_agg": 1}


def test_scripted_metric_requires_map_script(fresh):
    body = {"size": 0, "aggs": {"m": {"scripted_metric": {}}}}
    with pytest.raises(Exception) as je:
        fresh.j.search(dict(body))
    with pytest.raises(Exception) as te:
        fresh.t.search(dict(body))
    assert (type(te.value).__name__, str(te.value)) == (
        type(je.value).__name__, str(je.value))


def test_burst_answers_as_serial(pair):
    """A batched burst whose members carry a script query or
    script_fields answers as the same requests sent one at a time (and as
    the JAX package)."""
    bodies = [
        {"query": MATCH, "size": 5, "script_fields": SCRIPT_FIELDS["score"]},
        {"query": QUERIES["under_match"], "size": 5},
        {"query": {"bool": {"must": [{"match": {"title": "w2"}}],
                            "filter": [{"exists": {"field": "n"}}]}},
         "size": 5, "script_fields": SCRIPT_FIELDS["painless_strings"]},
        {"query": QUERIES["with_params"], "size": 5},
    ]
    serial = [pair.search(b) for b in bodies]
    burst = pair.t.search_batch([dict(b) for b in bodies])
    for want, got in zip(serial, burst):
        same(want, got)
