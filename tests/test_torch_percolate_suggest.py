"""Parity of the suggesters, the percolator, the completion field and the
``_size`` field with the JAX package.

Mirrors tests/test_suggest.py (7 cases: the term suggester's corrections,
a correct word, frequency ranking; the phrase suggester; completion by
weight, no match, several inputs), the percolate case of
tests/test_misc_apis.py, and the 8 ``_size`` / phrase / completion cases
of tests/test_ingest_plugins.py (``_size`` in a range, a sort and a
``max``; ``_size`` off by default; the bigram model; completion category
and geo contexts, a context boost, an unknown context refused at query
time and an undefined one at index time). Each case runs on a JAX index
and a port ``device="cpu"`` one over the same documents: suggestions,
ids, totals and aggregations exact, scores rtol 1e-5.

Added: seeded misspellings under the term and phrase suggesters, seeded
stored queries (``match``, ``bool`` with a ``range``, ``term``) under
``percolate`` against the JAX package and a plain Python evaluation, a
malformed stored query that never matches, ``suggest`` beside a match on
the one-device mesh plane and in a hybrid request, and the completion
field's columns written to a store and read back.
"""

import copy
import os

import numpy as np
import pytest

from elasticsearch_tpu.client import Client as JClient
from elasticsearch_tpu.common.errors import (
    MapperParsingException as JMPE,
)
from elasticsearch_tpu.common.errors import ParsingException as JPE
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.errors import (
    MapperParsingException,
    ParsingException,
)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController

RTOL = 1e-5


def make_pair(name, mapping, docs, shards=1, mesh=False, settings=None,
              data_paths=(None, None)):
    common = {"index.number_of_shards": shards, "index.refresh_interval": -1,
              **(settings or {})}
    if not mesh:
        common["index.search.mesh"] = False
    jidx = JIndex(name, JSettings({**common, "search.aggs.fused": False,
                                   "index.staging.delta.enabled": False}),
                  mapping=mapping, data_path=data_paths[0])
    if mesh:
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common), mapping=mapping,
                        device="cpu", data_path=data_paths[1])
    for doc_id, src in docs:
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


def close_pair(pair):
    for idx in pair:
        idx.close()


def assert_same(jr, tr):
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert [h["_id"] for h in tr["hits"]["hits"]] == \
        [h["_id"] for h in jr["hits"]["hits"]]
    for a, b in zip(jr["hits"]["hits"], tr["hits"]["hits"]):
        if a["_score"] is None:
            assert b["_score"] is None
        else:
            np.testing.assert_allclose(b["_score"], a["_score"], rtol=RTOL)
    assert tr.get("suggest") == jr.get("suggest")
    assert tr.get("aggregations") == jr.get("aggregations")


def both(pair, body):
    jr = pair[0].search(copy.deepcopy(body))
    tr = pair[1].search(copy.deepcopy(body))
    assert_same(jr, tr)
    return tr


# ---------------------------------------------------------------------------
# tests/test_suggest.py
# ---------------------------------------------------------------------------

SUGGEST_MAPPING = {"properties": {"body": {"type": "text"},
                                  "suggest": {"type": "completion"}}}
SUGGEST_DOCS = [
    ("0", {"body": "the quick brown fox",
           "suggest": {"input": ["quick fox"], "weight": 10}}),
    ("1", {"body": "quick silver lining",
           "suggest": {"input": ["quick silver", "silver"], "weight": 5}}),
    ("2", {"body": "brown bears fishing", "suggest": "brown bears"}),
    ("3", {"body": "the quick brown dog"}),
]


@pytest.fixture(scope="module")
def idx():
    pair = make_pair("s", SUGGEST_MAPPING, SUGGEST_DOCS)
    yield pair
    close_pair(pair)


class TestTermSuggester:
    def test_misspelling_corrected(self, idx):
        r = both(idx, {"size": 0, "suggest": {
            "fix": {"text": "quik browm", "term": {"field": "body"}}}})
        sug = r["suggest"]["fix"]
        assert sug[0]["text"] == "quik"
        assert sug[0]["options"][0]["text"] == "quick"
        assert sug[1]["options"][0]["text"] == "brown"

    def test_correct_word_no_options(self, idx):
        r = both(idx, {"size": 0, "suggest": {
            "fix": {"text": "quick", "term": {"field": "body"}}}})
        assert r["suggest"]["fix"][0]["options"] == []

    def test_freq_ranking(self, idx):
        r = both(idx, {"size": 0, "suggest": {
            "fix": {"text": "quickk", "term": {"field": "body"}}}})
        opts = r["suggest"]["fix"][0]["options"]
        assert opts[0]["text"] == "quick" and opts[0]["freq"] == 3


class TestPhraseSuggester:
    def test_phrase_correction(self, idx):
        r = both(idx, {"size": 0, "suggest": {
            "p": {"text": "quik brown", "phrase": {"field": "body"}}}})
        options = r["suggest"]["p"][0]["options"]
        assert options and options[0]["text"] == "quick brown"


class TestCompletionSuggester:
    def test_prefix_completion_weight_order(self, idx):
        r = both(idx, {"size": 0, "suggest": {
            "ac": {"prefix": "quick", "completion": {"field": "suggest"}}}})
        opts = r["suggest"]["ac"][0]["options"]
        assert [o["text"] for o in opts] == ["quick fox", "quick silver"]
        assert opts[0]["_id"] == "0"

    def test_no_match(self, idx):
        r = both(idx, {"size": 0, "suggest": {
            "ac": {"prefix": "zzz", "completion": {"field": "suggest"}}}})
        assert r["suggest"]["ac"][0]["options"] == []

    def test_multiple_inputs(self, idx):
        r = both(idx, {"size": 0, "suggest": {
            "ac": {"prefix": "sil", "completion": {"field": "suggest"}}}})
        assert [o["text"] for o in r["suggest"]["ac"][0]["options"]] == \
            ["silver"]

    def test_global_text_skip_duplicates_and_unknown_kind(self, idx):
        both(idx, {"size": 0, "suggest": {
            "text": "quick",
            "ac": {"completion": {"field": "suggest",
                                  "skip_duplicates": True, "size": 1}},
            "t": {"term": {"field": "body", "size": 1}}}})
        body = {"suggest": {"x": {"text": "a", "nope": {"field": "body"}}}}
        with pytest.raises(JPE) as je:
            idx[0].search(copy.deepcopy(body))
        with pytest.raises(ParsingException) as te:
            idx[1].search(copy.deepcopy(body))
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# tests/test_misc_apis.py: percolate
# ---------------------------------------------------------------------------


class TestPercolate:
    def test_percolate_matches_stored_queries(self):
        """Through the JAX client and the port's REST controller."""
        jnode, tnode = JNode(JSettings.EMPTY), Node(device="cpu")
        try:
            jc = JClient(jnode)
            tc = RestController(tnode)
            body = {"mappings": {"properties": {
                "query": {"type": "percolator"}, "body": {"type": "text"}}}}
            assert jc.perform("PUT", "/queries", body=body)[0] == 200
            tnode.create_index("queries", body)
            stored = [("q1", {"query": {"match": {"body": "fox"}}}),
                      ("q2", {"query": {"match": {"body": "turtle"}}}),
                      ("q3", {"query": {"range": {"price": {"gte": 100}}}})]
            for doc_id, src in stored:
                jc.index("queries", doc_id, src)
                tnode.index_doc("queries", doc_id, src)
            jc.perform("POST", "/queries/_refresh")
            tnode.indices["queries"].refresh()
            q = {"query": {"percolate": {
                "field": "query",
                "document": {"body": "a quick fox jumped", "price": 150}}}}
            _, jr = jc.search("queries", copy.deepcopy(q))
            import json

            st, tr = tc.dispatch("POST", "/queries/_search", {},
                                 json.dumps(q).encode(), "application/json")
            assert st == 200
            assert {h["_id"] for h in tr["hits"]["hits"]} == \
                {h["_id"] for h in jr["hits"]["hits"]} == {"q1", "q3"}
        finally:
            jnode.close()
            tnode.close()


# ---------------------------------------------------------------------------
# tests/test_ingest_plugins.py: _size, the bigram model, completion contexts
# ---------------------------------------------------------------------------


class TestSizeField:
    def test_size_indexed_and_queryable(self):
        pair = make_pair("sz", {"_size": {"enabled": True},
                                "properties": {"t": {"type": "text"}}},
                         [("small", {"t": "x"}), ("big", {"t": "y" * 500})])
        try:
            r = both(pair, {"query": {"range": {"_size": {"gt": 100}}}})
            assert [h["_id"] for h in r["hits"]["hits"]] == ["big"]
            r = both(pair, {"query": {"match_all": {}},
                            "sort": [{"_size": "desc"}]})
            assert [h["_id"] for h in r["hits"]["hits"]] == ["big", "small"]
            assert [h["sort"] for h in r["hits"]["hits"]] == \
                [h["sort"] for h in pair[0].search({
                    "query": {"match_all": {}},
                    "sort": [{"_size": "desc"}]})["hits"]["hits"]]
            r = both(pair, {"size": 0, "aggs": {"sz": {"max": {
                "field": "_size"}}}})
            assert r["aggregations"]["sz"]["value"] > 500
        finally:
            close_pair(pair)

    def test_disabled_by_default(self):
        pair = make_pair("sz2", None, [("1", {"t": "x"})])
        try:
            r = both(pair, {"query": {"exists": {"field": "_size"}}})
            assert r["hits"]["total"] == 0
        finally:
            close_pair(pair)


class TestPhraseBigram:
    def test_bigram_ranks_corpus_collocation_first(self):
        docs = [(f"a{i}", {"body": "nobel prize winners list"})
                for i in range(5)]
        docs += [(f"b{i}", {"body": "a noble act of kindness"})
                 for i in range(8)]
        pair = make_pair("p", {"properties": {"body": {"type": "text"}}},
                         docs)
        try:
            r = both(pair, {"suggest": {"fix": {
                "text": "nobl prize", "phrase": {"field": "body"}}}})
            options = r["suggest"]["fix"][0]["options"]
            assert options and options[0]["text"] == "nobel prize"
        finally:
            close_pair(pair)


CTX_MAPPING = {"properties": {"suggest": {
    "type": "completion",
    "contexts": [{"name": "place", "type": "category"},
                 {"name": "loc", "type": "geo", "precision": 4}]}}}
CTX_DOCS = [
    ("1", {"suggest": {"input": ["timmy's", "timmy house"], "weight": 10,
                       "contexts": {"place": ["cafe"],
                                    "loc": [{"lat": 43.662,
                                             "lon": -79.38}]}}}),
    ("2", {"suggest": {"input": ["timber mart"], "weight": 5,
                       "contexts": {"place": ["shop"],
                                    "loc": [{"lat": 48.85, "lon": 2.35}]}}}),
]


@pytest.fixture()
def ctx_pair():
    pair = make_pair("c", CTX_MAPPING, CTX_DOCS)
    yield pair
    close_pair(pair)


class TestCompletionContexts:
    def test_category_context_filters(self, ctx_pair):
        r = both(ctx_pair, {"suggest": {"s": {
            "prefix": "tim", "completion": {
                "field": "suggest", "contexts": {"place": ["cafe"]}}}}})
        texts = [o["text"] for o in r["suggest"]["s"][0]["options"]]
        assert "timmy's" in texts and "timber mart" not in texts

    def test_category_boost(self, ctx_pair):
        r = both(ctx_pair, {"suggest": {"s": {
            "prefix": "tim", "completion": {
                "field": "suggest", "contexts": {"place": [
                    {"context": "shop", "boost": 10},
                    {"context": "cafe"}]}}}}})
        assert r["suggest"]["s"][0]["options"][0]["text"] == "timber mart"

    def test_geo_context(self, ctx_pair):
        r = both(ctx_pair, {"suggest": {"s": {
            "prefix": "tim", "completion": {
                "field": "suggest", "contexts": {"loc": [
                    {"context": {"lat": 43.66, "lon": -79.39},
                     "precision": 4}]}}}}})
        texts = [o["text"] for o in r["suggest"]["s"][0]["options"]]
        assert texts and all("timmy" in t for t in texts)

    def test_unknown_context_rejected(self, ctx_pair):
        body = {"suggest": {"s": {"prefix": "tim", "completion": {
            "field": "suggest", "contexts": {"nope": ["x"]}}}}}
        with pytest.raises(JPE) as je:
            ctx_pair[0].search(copy.deepcopy(body))
        with pytest.raises(ParsingException) as te:
            ctx_pair[1].search(copy.deepcopy(body))
        assert str(te.value) == str(je.value)

    def test_undefined_context_rejected_at_index_time(self, ctx_pair):
        doc = {"suggest": {"input": ["x"], "contexts": {"undefined": ["y"]}}}
        with pytest.raises(JMPE) as je:
            ctx_pair[0].index_doc("bad", doc)
        with pytest.raises(MapperParsingException) as te:
            ctx_pair[1].index_doc("bad", doc)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# Added: seeded suggesters and stored queries, the mesh plane, a store
# ---------------------------------------------------------------------------

WORDS = ["protein", "kinase", "cell", "signal", "receptor", "binding",
         "membrane", "transport", "expression", "regulation", "pathway",
         "mutation"]


def seeded_titles(n, seed):
    rng = np.random.RandomState(seed)
    return [(f"t{i}", {"title": " ".join(rng.choice(WORDS, rng.randint(3, 9))),
                       "year": int(rng.randint(1990, 2024)),
                       "venue": str(rng.choice(["nature", "cell", "plos"]))})
            for i in range(n)]


def misspell(word, rng):
    i = rng.randint(len(word))
    op = rng.randint(3)
    if op == 0:
        return word[:i] + word[i + 1:]
    if op == 1:
        return word[:i] + "x" + word[i + 1:]
    return word[:i] + word[i] + word[i:]


TITLE_MAPPING = {"properties": {"title": {"type": "text"},
                                "year": {"type": "long"},
                                "venue": {"type": "keyword"},
                                "q": {"type": "percolator"}}}


def test_seeded_misspellings_equal_jax():
    rng = np.random.RandomState(3)
    pair = make_pair("pmcs", TITLE_MAPPING, seeded_titles(300, seed=2),
                     shards=2)
    try:
        for _ in range(6):
            words = list(rng.choice(WORDS, 3))
            text = " ".join(misspell(w, rng) if rng.rand() < 0.6 else w
                            for w in words)
            both(pair, {"size": 0, "suggest": {
                "t": {"text": text, "term": {"field": "title"}},
                "p": {"text": text, "phrase": {"field": "title",
                                               "max_errors": 2}}}})
    finally:
        close_pair(pair)


def stored_queries(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            q = {"match": {"title": " ".join(rng.choice(WORDS, 2))}}
        elif kind == 1:
            q = {"bool": {"must": [{"match": {"title": str(
                rng.choice(WORDS))}}],
                "filter": [{"range": {"year": {
                    "gte": int(rng.randint(1990, 2024))}}}]}}
        else:
            q = {"term": {"venue": str(rng.choice(["nature", "cell",
                                                   "plos"]))}}
        out.append((f"r{i}", {"q": q}))
    return out


def plain_match(q, doc):
    """A plain Python evaluation of the three stored query kinds."""
    words = set(doc["title"].split())
    if "match" in q:
        return bool(words & set(q["match"]["title"].split()))
    if "term" in q:
        return doc["venue"] == q["term"]["venue"]
    must = q["bool"]["must"][0]["match"]["title"]
    return (must in words
            and doc["year"] >= q["bool"]["filter"][0]["range"]["year"]["gte"])


def test_seeded_stored_queries_percolate_like_jax_and_plain_python():
    stored = stored_queries(90, seed=8)
    stored.append(("broken", {"q": {"no_such_query": {}}}))
    pair = make_pair("alerts", TITLE_MAPPING, stored)
    try:
        for _, doc in seeded_titles(6, seed=9):
            r = both(pair, {"query": {"percolate": {
                "field": "q", "document": doc}}, "size": 100})
            want = {doc_id for doc_id, src in stored
                    if doc_id != "broken" and plain_match(src["q"], doc)}
            assert {h["_id"] for h in r["hits"]["hits"]} == want
    finally:
        close_pair(pair)


def test_suggest_on_the_mesh_plane_and_in_a_hybrid(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    docs = seeded_titles(200, seed=12)
    pair = make_pair("sugmesh", {"properties": {
        "title": {"type": "text"}, "year": {"type": "long"},
        "venue": {"type": "keyword"},
        "emb": {"type": "dense_vector", "dims": 3,
                "similarity": "cosine"}}},
        [(d, dict(s, emb=[float(len(s["title"]) % 7) + 1.0, 1.0,
                          float(s["year"] % 5)])) for d, s in docs],
        shards=3, mesh=True)
    try:
        sug = {"t": {"text": "protien kinse", "term": {"field": "title"}},
               "p": {"text": "protein kinse", "phrase": {"field": "title"}}}
        r = both(pair, {"query": {"match": {"title": "kinase cell"}},
                        "suggest": sug, "size": 5})
        assert r["_plane"] == "mesh_pallas" and r["suggest"]["t"]
        r = both(pair, {"query": {"match": {"title": "signal"}},
                        "knn": {"field": "emb", "query_vector": [1, 2, 3],
                                "k": 5}, "suggest": sug, "size": 5})
        assert r["suggest"]["p"][0]["options"]
    finally:
        close_pair(pair)


def test_percolate_on_the_mesh_plane(monkeypatch):
    """percolate beside a match on a 2-shard mesh index: the plane and the
    hits the JAX package gives."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    stored = [(d, dict(s, title="protein cell", year=2000, venue="cell"))
              for d, s in stored_queries(40, seed=13)]
    pair = make_pair("percmesh", TITLE_MAPPING, stored, shards=2, mesh=True)
    try:
        doc = {"title": "protein kinase signal", "year": 2020,
               "venue": "nature"}
        both(pair, {"query": {"bool": {
            "must": [{"match": {"title": "protein"}}],
            "filter": [{"percolate": {"field": "q", "document": doc}}]}},
            "size": 50})
    finally:
        close_pair(pair)


def test_a_fault_running_a_stored_query_is_no_silent_miss(monkeypatch):
    """A stored query that does not parse never matches, as in the JAX
    package; a fault while a parsed stored query runs (on the card: a
    CUDA error, out of memory) surfaces instead of reading as a stored
    query that does not match."""
    from elasticsearch_tpu_torch.common.errors import (
        SearchPhaseExecutionException,
    )
    from elasticsearch_tpu_torch.search import plan as P

    svc = IndexService("percfault", Settings({
        "index.number_of_shards": 1, "index.refresh_interval": -1}),
        mapping=TITLE_MAPPING, device="cpu")
    try:
        svc.index_doc("ok", {"q": {"match": {"title": "protein"}}})
        svc.index_doc("bad", {"q": {"no_such_query": {"title": "x"}}})
        for i in range(6):  # the shard's segment: 8 docs padded
            svc.index_doc(f"other{i}", {"q": {"term": {"venue": f"v{i}"}}})
        svc.refresh()
        body = {"query": {"percolate": {
            "field": "q", "document": {"title": "protein kinase"}}}}
        r = svc.search(copy.deepcopy(body))
        assert [h["_id"] for h in r["hits"]["hits"]] == ["ok"]
        real = P.execute

        def faulty(dev, node):
            # the candidate's one-doc segment, not the shard's
            if len(dev["live"]) <= 2:
                raise RuntimeError("CUDA error: an illegal memory access")
            return real(dev, node)

        monkeypatch.setattr(P, "execute", faulty)
        # the shard's failure, not an empty answer
        with pytest.raises(SearchPhaseExecutionException) as err:
            svc.search(copy.deepcopy(body))
        assert "illegal memory access" in str(err.value.shard_failures)
    finally:
        svc.close()


def test_completion_and_size_columns_survive_a_store(tmp_data_dir):
    mapping = {"_size": {"enabled": True}, **CTX_MAPPING}
    paths = (os.path.join(tmp_data_dir, "j"), os.path.join(tmp_data_dir, "t"))
    pair = make_pair("cs", mapping, CTX_DOCS, data_paths=paths)
    for idx in pair:
        idx.flush()
    close_pair(pair)
    pair = make_pair("cs", mapping, [], data_paths=paths)
    try:
        both(pair, {"suggest": {"s": {"prefix": "tim", "completion": {
            "field": "suggest", "contexts": {"place": ["cafe", "shop"]}}}}})
        r = both(pair, {"query": {"match_all": {}},
                        "sort": [{"_size": "asc"}]})
        assert r["hits"]["total"] == 2
        # the port reads the JAX package's store too
        t2 = IndexService("cs", Settings({"index.number_of_shards": 1,
                                          "index.search.mesh": False}),
                          mapping=mapping, device="cpu", data_path=paths[0])
        try:
            assert_same(pair[0].search({"query": {"range": {"_size": {
                "gt": 10}}}}), t2.search({"query": {"range": {"_size": {
                    "gt": 10}}}}))
        finally:
            t2.close()
    finally:
        close_pair(pair)
