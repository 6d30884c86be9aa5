"""End-to-end parity: the JAX ``Node`` and the port's ``Node(device="cpu")``.

Both take the same seeded documents into a 5-shard index and serve the
same requests. The JAX index runs with ``index.search.mesh: false`` so it
serves from the host rung, with its Pallas kernels in interpret mode
(``ES_TPU_PALLAS=interpret``, as tests/test_corruption.py sets it). Ids,
totals and aggregation buckets must agree exactly; scores within rtol
1e-5 (the JAX kernel's bf16 split, ~2^-17 relative). Hits whose scores
tie within that tolerance are compared as sets; otherwise order is exact
(ties by shard, then ascending doc id, in both packages).
"""

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
)
from elasticsearch_tpu_torch.node import Node

RTOL = 1e-5
N_DOCS = 400
MAPPING = {"_doc": {"properties": {
    "title": {"type": "text"},
    "venue": {"type": "keyword"},
    "year": {"type": "long"},
}}}


def seeded_docs(seed=11):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(120)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = []
    for i in range(N_DOCS):
        n = int(np.clip(rng.lognormal(np.log(12), 0.4), 2, 60))
        docs.append((f"doc-{i}", {
            "title": " ".join(rng.choice(vocab, n, p=p)),
            "venue": f"venue{int(rng.zipf(1.6)) % 15}",
            "year": int(1995 + rng.randint(25)),
        }))
    return docs


REQUESTS = {
    "match_or": {"query": {"match": {"title": "w3 w17 w40"}}},
    "match_and": {"query": {"match": {"title": {"query": "w1 w5",
                                                 "operator": "and"}}}},
    "match_msm": {"query": {"match": {"title": {
        "query": "w2 w9 w30 w61", "minimum_should_match": 2}}}},
    "match_dense_term": {"query": {"match": {"title": "w0 w1 w2"}}},
    "bool_filtered": {"query": {"bool": {
        "must": [{"match": {"title": "w4 w8"}}],
        "filter": [{"term": {"venue": "venue1"}},
                   {"range": {"year": {"gte": 2000, "lt": 2015}}}]}}},
    "bool_should_must_not": {"query": {"bool": {
        "should": [{"match": {"title": "w6"}}, {"match": {"title": "w11"}}],
        "must_not": [{"terms": {"venue": ["venue2", "venue3"]}}]}}},
    "term_keyword": {"query": {"term": {"venue": "venue4"}}},
    "term_zero_boost": {"query": {"term": {"title": {"value": "w7",
                                                     "boost": 0.0}}}},
    "range_year": {"query": {"range": {"year": {"gt": 2003, "lte": 2010}}}},
    "constant_score": {"query": {"constant_score": {
        "filter": {"match": {"title": "w12"}}, "boost": 2.5}}},
    "match_all": {"query": {"match_all": {}}},
    "terms_agg": {"size": 0, "query": {"match": {"title": "w2 w3"}},
                  "aggs": {"v": {"terms": {"field": "venue", "size": 5}},
                           "y": {"terms": {"field": "year", "size": 4}}}},
}


@pytest.fixture(scope="module")
def nodes():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    body = {"settings": {"number_of_shards": 5, "refresh_interval": "-1"},
            "mappings": MAPPING}
    jn, tn = JNode(), Node(device="cpu")
    jn.create_index("idx", {**body, "settings": {
        **body["settings"], "search": {"mesh": False},
        "requests": {"cache": {"enable": False}}}})
    tn.create_index("idx", body)
    ops = [("index", {"_index": "idx", "_id": i}, d) for i, d in seeded_docs()]
    assert not jn.bulk(ops, refresh=True)["errors"]
    assert not tn.bulk(ops, refresh=True)["errors"]
    yield jn, tn
    jn.close()
    tn.close()
    mp.undo()


def assert_same_hits(jr, tr):
    assert jr["hits"]["total"] == tr["hits"]["total"]
    jh, th = jr["hits"]["hits"], tr["hits"]["hits"]
    assert len(jh) == len(th)
    js = np.array([h["_score"] for h in jh], np.float64)
    ts = np.array([h["_score"] for h in th], np.float64)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=1e-7)
    # group runs of scores tied within tolerance; compare ids per group
    i = 0
    while i < len(jh):
        j = i + 1
        while j < len(jh) and abs(js[j] - js[i]) <= RTOL * abs(js[i]) + 1e-7:
            j += 1
        assert {h["_id"] for h in jh[i:j]} == {h["_id"] for h in th[i:j]}
        if j - i == 1:
            assert jh[i]["_source"] == th[i]["_source"]
        i = j
    if jr["hits"]["max_score"] is None:
        assert tr["hits"]["max_score"] is None
    else:
        np.testing.assert_allclose(tr["hits"]["max_score"],
                                   jr["hits"]["max_score"], rtol=RTOL)


def run_request(nodes, name):
    jn, tn = nodes
    body = dict(REQUESTS[name])
    if "size" not in body:
        body["size"] = N_DOCS  # every hit: no cut-off inside a tie group
    jr, tr = jn.search("idx", body), tn.search("idx", body)
    assert tr["_plane"] == jr["_plane"] == "host"
    assert tr["_shards"] == jr["_shards"]
    assert isinstance(tr["hits"]["total"], int)
    assert_same_hits(jr, tr)
    assert jr.get("aggregations") == tr.get("aggregations")
    return jr, tr


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_same_response_before_deletes(nodes, name):
    run_request(nodes, name)


def test_same_top10_and_paging(nodes):
    jn, tn = nodes
    for body in ({"query": {"match": {"title": "w3 w17 w40"}}},
                 {"query": {"match": {"title": "w3 w17"}}, "from": 5,
                  "size": 7, "_source": ["venue"]}):
        jr, tr = jn.search("idx", body), tn.search("idx", body)
        assert jr["hits"]["total"] == tr["hits"]["total"]
        np.testing.assert_allclose(
            [h["_score"] for h in tr["hits"]["hits"]],
            [h["_score"] for h in jr["hits"]["hits"]], rtol=RTOL)
        assert all(set(h["_source"]) <= set(body.get("_source") or h["_source"])
                   for h in tr["hits"]["hits"])


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_same_response_after_deletes(nodes, name):
    jn, tn = nodes
    if tn.get_doc("idx", "doc-0")["found"]:
        rng = np.random.RandomState(5)
        for i in [0] + sorted(rng.choice(np.arange(1, N_DOCS), 40, replace=False)):
            jr = jn.delete_doc("idx", f"doc-{i}")
            tr = tn.delete_doc("idx", f"doc-{i}")
            assert jr["result"] == tr["result"] == "deleted"
        jn.indices["idx"].refresh()
        tn.refresh("idx")
        assert not tn.get_doc("idx", "doc-0")["found"]
    run_request(nodes, name)


def test_documents_and_routing(nodes):
    jn, tn = nodes
    for i in (1, 2, 399):
        jd, td = jn.get_doc("idx", f"doc-{i}"), tn.get_doc("idx", f"doc-{i}")
        for key in ("found", "_source", "_version"):
            assert jd.get(key) == td.get(key)
    js = jn.indices["idx"]
    ts = tn.indices["idx"]
    for i in range(50):
        assert js._route(f"doc-{i}") == ts._route(f"doc-{i}")
    assert [s.num_docs for _, s in sorted(ts.shards.items())] == \
        [s.num_docs for _, s in sorted(js.shards.items())]
    # both packages scored through their tile kernels (and the zero-boost
    # term through the scatter node)
    assert sum(s.searcher.pallas_segments_total for s in js.shards.values()) > 0
    assert sum(s.searcher.kernel_segments_total for s in ts.shards.values()) > 0
    assert sum(s.searcher.scatter_segments_total for s in ts.shards.values()) > 0


def test_unported_requests_raise(nodes):
    """An unknown query type raises; the span and geo_shape queries and
    suggest (the field-type and query remainder), scripted_metric and
    script_fields (ported with ``script/``) answer as the JAX package."""
    jn, tn = nodes
    with pytest.raises(ParsingException):
        tn.search("idx", {"query": {"span_bogus": {"title": "w1"}}})
    body = {"query": {"span_term": {"title": "w1"}}}
    jr, tr = jn.search("idx", dict(body)), tn.search("idx", dict(body))
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert [h["_id"] for h in tr["hits"]["hits"]] == \
        [h["_id"] for h in jr["hits"]["hits"]]
    body = {"query": {"geo_shape": {"loc": {"shape": {
        "type": "point", "coordinates": [0.0, 0.0]}}}}}
    with pytest.raises(Exception) as je:
        jn.search("idx", dict(body))
    with pytest.raises(Exception) as te:
        tn.search("idx", dict(body))
    assert (type(te.value).__name__, str(te.value)) == \
        (type(je.value).__name__, str(je.value))
    body = {"size": 0, "aggs": {"n": {"scripted_metric": {
        "map_script": "1"}}}}
    assert (tn.search("idx", dict(body))["aggregations"]
            == jn.search("idx", dict(body))["aggregations"])
    body = {"query": {"match_all": {}},
            "suggest": {"s": {"text": "w1", "term": {"field": "title"}}}}
    assert (tn.search("idx", dict(body))["suggest"]
            == jn.search("idx", dict(body))["suggest"])
    body = {"query": {"match_all": {}}, "sort": [{"year": "asc"}],
            "script_fields": {"y": {"script": {"source": "doc['year'].value"}}}}
    jr, tr = jn.search("idx", dict(body)), tn.search("idx", dict(body))
    assert ([h["fields"] for h in tr["hits"]["hits"]]
            == [h["fields"] for h in jr["hits"]["hits"]])


def test_can_match_skips_shards_like_jax():
    """A pure range query skips the shards whose doc-value bounds cannot
    match (the JAX package's ``_can_match``), keeping at least one."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    body = {"settings": {"number_of_shards": 5, "refresh_interval": "-1"},
            "mappings": MAPPING}
    jn, tn = JNode(), Node(device="cpu")
    try:
        # (the JAX test process has 8 virtual devices, so its mesh plane
        # would take a 5-shard index; the port's one device cannot)
        jn.create_index("yr", {**body, "settings": {
            **body["settings"], "search": {"mesh": False},
            "requests": {"cache": {"enable": False}}}})
        tn.create_index("yr", body)
        ops = [("index", {"_index": "yr", "_id": str(i)},
                {"title": f"w{i}", "year": 1990 + i}) for i in range(12)]
        assert not jn.bulk(ops, refresh=True)["errors"]
        assert not tn.bulk(ops, refresh=True)["errors"]
        for q in ({"range": {"year": {"gte": 2000}}},
                  {"range": {"year": {"gte": 2050}}},
                  {"range": {"year": {"lt": 1991}}}):
            jr = jn.search("yr", {"query": q})
            tr = tn.search("yr", {"query": q})
            assert tr["_plane"] == jr["_plane"] == "host"
            assert tr["_shards"] == jr["_shards"]
            assert tr["hits"]["total"] == jr["hits"]["total"]
        jr = jn.search("yr", {"query": {"range": {"year": {"gte": 2000}}}})
        assert jr["_shards"]["skipped"] == 3
    finally:
        jn.close()
        tn.close()
        mp.undo()
