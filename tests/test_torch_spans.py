"""Parity of the span queries and the ``type`` query with the JAX package.

Mirrors tests/test_spans.py (14 cases): ``span_term``, ``span_near``
(ordered, unordered, slop), ``span_first``, ``span_or``, ``span_not``,
``span_containing``, ``span_within``, ``span_multi`` (and its refusal of
a non-multi-term query), a span in a bool, and a non-span clause
refused. Each case runs on a JAX ``IndexService`` and a port
``IndexService(device="cpu")`` over the same documents: ids and totals
exact, scores rtol 1e-5, the same error for a refused body.

Added: ``field_masking_span``, ``span_not`` with ``dist`` and ``post``,
seeded texts under every span kind against the JAX package, a span
clause beside a ``match`` on the one-device mesh plane (JAX with
``ES_TPU_PALLAS=interpret``) and alone there, spans over a segment the
port loaded from a JAX-written store, and ``type`` answered as
``match_all``.
"""

import os

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import ParsingException as JPE
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService

RTOL = 1e-5

DOCS = {
    "1": "the quick brown fox jumps over the lazy dog",
    "2": "the brown quick fox sleeps",
    "3": "quick thinking saved the brown bear",
    "4": "a fox and a dog",
}


def make_pair(name, docs, shards=1, mesh=False, data_paths=(None, None)):
    common = {"index.number_of_shards": shards, "index.refresh_interval": -1}
    if not mesh:
        common["index.search.mesh"] = False
    jidx = JIndex(name, JSettings({**common, "search.aggs.fused": False,
                                   "index.staging.delta.enabled": False}),
                  data_path=data_paths[0])
    if mesh:
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common), device="cpu",
                        data_path=data_paths[1])
    for doc_id, src in docs:
        for idx in (jidx, tidx):
            idx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


def assert_same(jr, tr):
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert [h["_id"] for h in tr["hits"]["hits"]] == \
        [h["_id"] for h in jr["hits"]["hits"]]
    for a, b in zip(jr["hits"]["hits"], tr["hits"]["hits"]):
        np.testing.assert_allclose(b["_score"], a["_score"], rtol=RTOL)


def hit_ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


@pytest.fixture(scope="module")
def idx():
    pair = make_pair("spans", [(i, {"body": t}) for i, t in DOCS.items()])
    yield pair
    for p in pair:
        p.close()


def search(pair, query, size=10):
    body = {"query": query, "size": size}
    jr, tr = pair[0].search(dict(body)), pair[1].search(dict(body))
    assert_same(jr, tr)
    return tr


def both_refuse(pair, query):
    with pytest.raises(JPE) as je:
        pair[0].search({"query": query})
    with pytest.raises(ParsingException) as te:
        pair[1].search({"query": query})
    assert str(te.value) == str(je.value)


def st(term):
    return {"span_term": {"body": term}}


class TestSpanTerm:
    def test_span_term(self, idx):
        assert hit_ids(search(idx, st("fox"))) == ["1", "2", "4"]

    def test_span_term_scores_like_term(self, idx):
        r = search(idx, {"span_term": {"body": {"value": "fox",
                                                "boost": 2.0}}})
        assert all(h["_score"] > 0 for h in r["hits"]["hits"])


class TestSpanNear:
    def test_in_order_adjacent(self, idx):
        r = search(idx, {"span_near": {"clauses": [st("quick"), st("brown")],
                                       "slop": 0, "in_order": True}})
        assert hit_ids(r) == ["1"]

    def test_unordered(self, idx):
        r = search(idx, {"span_near": {"clauses": [st("quick"), st("brown")],
                                       "slop": 0, "in_order": False}})
        assert hit_ids(r) == ["1", "2"]

    def test_slop(self, idx):
        r = search(idx, {"span_near": {"clauses": [st("quick"), st("brown")],
                                       "slop": 3, "in_order": True}})
        assert hit_ids(r) == ["1", "3"]


class TestSpanFirst:
    def test_span_first(self, idx):
        r = search(idx, {"span_first": {"match": st("quick"), "end": 2}})
        assert hit_ids(r) == ["1", "3"]
        r = search(idx, {"span_first": {"match": st("quick"), "end": 1}})
        assert hit_ids(r) == ["3"]


class TestSpanOrNot:
    def test_span_or(self, idx):
        r = search(idx, {"span_or": {"clauses": [st("bear"), st("dog")]}})
        assert hit_ids(r) == ["1", "3", "4"]

    def test_span_not(self, idx):
        r = search(idx, {"span_not": {"include": st("fox"),
                                      "exclude": st("brown"), "pre": 1}})
        assert hit_ids(r) == ["2", "4"]

    def test_span_not_dist_and_post(self, idx):
        for spec in ({"dist": 1}, {"post": 2}, {"pre": 0, "post": 0}):
            search(idx, {"span_not": {"include": st("quick"),
                                      "exclude": st("fox"), **spec}})


class TestSpanContainingWithin:
    BIG = {"span_near": {"clauses": [st("quick"), st("fox")],
                         "slop": 1, "in_order": True}}

    def test_span_containing(self, idx):
        r = search(idx, {"span_containing": {"little": st("brown"),
                                             "big": self.BIG}})
        assert hit_ids(r) == ["1"]

    def test_span_within(self, idx):
        r = search(idx, {"span_within": {"little": st("brown"),
                                         "big": self.BIG}})
        assert hit_ids(r) == ["1"]


class TestSpanMulti:
    def test_span_multi_prefix(self, idx):
        r = search(idx, {"span_near": {"clauses": [
            {"span_multi": {"match": {"prefix": {"body": "qui"}}}},
            st("brown")], "slop": 0, "in_order": True}})
        assert hit_ids(r) == ["1"]

    @pytest.mark.parametrize("inner", [
        {"wildcard": {"body": "b*n"}}, {"regexp": {"body": "d.g"}},
        {"fuzzy": {"body": "foz"}}])
    def test_span_multi_kinds(self, idx, inner):
        search(idx, {"span_multi": {"match": inner}})

    def test_span_multi_rejects_match(self, idx):
        both_refuse(idx, {"span_multi": {"match": {"match": {
            "body": "quick"}}}})


class TestSpanCompose:
    def test_span_inside_bool(self, idx):
        r = search(idx, {"bool": {
            "must": [{"span_near": {"clauses": [st("quick"), st("brown")],
                                    "slop": 0, "in_order": True}}],
            "must_not": [{"term": {"body": "bear"}}]}})
        assert hit_ids(r) == ["1"]

    def test_non_span_in_clauses_rejected(self, idx):
        both_refuse(idx, {"span_near": {"clauses": [
            {"term": {"body": "quick"}}], "slop": 0}})

    def test_field_masking_span(self, idx):
        search(idx, {"span_near": {"clauses": [
            st("lazy"),
            {"field_masking_span": {"query": st("dog"), "field": "body"}}],
            "slop": 0, "in_order": True}})

    def test_type_query_is_match_all(self, idx):
        r = search(idx, {"type": {"value": "_doc"}})
        assert r["hits"]["total"] == 4
        search(idx, {"bool": {"filter": [{"type": {"value": "_doc"}}],
                              "must": [st("fox")]}})


# ---------------------------------------------------------------------------
# Seeded texts, the mesh plane, a JAX-written store
# ---------------------------------------------------------------------------


def seeded_texts(n, seed, vocab=14):
    rng = np.random.RandomState(seed)
    words = [f"t{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [(f"s{i}", {"body": " ".join(rng.choice(words, rng.randint(3, 14),
                                                   p=p))})
            for i in range(n)]


def span_kinds():
    near = {"span_near": {"clauses": [st("t1"), st("t2")], "slop": 2,
                          "in_order": True}}
    return [
        st("t3"),
        {"span_multi": {"match": {"prefix": {"body": "t1"}}}},
        {"span_or": {"clauses": [st("t5"), st("t6")]}},
        near,
        {"span_near": {"clauses": [st("t0"), st("t4"), st("t2")],
                       "slop": 4, "in_order": False}},
        {"span_first": {"match": st("t0"), "end": 3}},
        {"span_not": {"include": st("t0"), "exclude": st("t1"),
                      "dist": 1}},
        {"span_containing": {"little": st("t0"), "big": near}},
        {"span_within": {"little": st("t0"), "big": {
            "span_near": {"clauses": [st("t1"), st("t2")], "slop": 5,
                          "in_order": False}}}},
        {"field_masking_span": {"query": st("t7"), "field": "body"}},
    ]


@pytest.mark.parametrize("kind", range(10))
def test_seeded_span_kinds_equal_jax(kind):
    pair = make_pair("seeded", seeded_texts(200, seed=kind), shards=2)
    try:
        search(pair, span_kinds()[kind], size=30)
    finally:
        for p in pair:
            p.close()


def test_spans_beside_a_match_on_the_mesh_plane(monkeypatch):
    """A span clause in a bool beside a match stacks on the kernel plane
    (one PhraseScoreNode a slot) as in the JAX package, and alone on the
    scatter plane; the host rung answers the same."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    docs = seeded_texts(240, seed=40)
    mesh = make_pair("spanmesh", docs, shards=3, mesh=True)
    host = make_pair("spanhost", docs, shards=3)
    try:
        for q in span_kinds()[:5]:
            body = {"bool": {"must": [{"match": {"body": "t3 t8"}}, q]}}
            tr = search(mesh, body, size=20)
            assert tr["_plane"] == "mesh_pallas"
            hr = search(host, body, size=20)
            assert [h["_id"] for h in hr["hits"]["hits"]] == \
                [h["_id"] for h in tr["hits"]["hits"]]
        tr = search(mesh, st("t3"), size=20)
        assert tr["_plane"] == "mesh"
    finally:
        for p in mesh + host:
            p.close()


def test_spans_over_a_jax_written_store(tmp_data_dir):
    docs = seeded_texts(120, seed=50)
    jpath = os.path.join(tmp_data_dir, "jspans")
    s = {"index.number_of_shards": 1, "index.refresh_interval": -1,
         "index.search.mesh": False}
    jidx = JIndex("jspans", JSettings({**s, "search.aggs.fused": False}),
                  data_path=jpath)
    for doc_id, src in docs:
        jidx.index_doc(doc_id, src)
    jidx.flush()
    try:
        tidx = IndexService("jspans", Settings(s), data_path=jpath,
                            device="cpu")
        try:
            for q in span_kinds():
                body = {"query": q, "size": 25}
                assert_same(jidx.search(dict(body)), tidx.search(dict(body)))
        finally:
            tidx.close()
    finally:
        jidx.close()
