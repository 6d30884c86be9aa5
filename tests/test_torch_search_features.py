"""Rescore, collapse, slice and highlight on the port, against the JAX
package.

Mirrors tests/test_search_features.py's cases for them: each case feeds
the same documents to a JAX ``IndexService`` (tile kernel in interpret
mode, ``ES_TPU_PALLAS=interpret``; the mesh plane off, as one shard has
it anyway) and a port ``IndexService(device="cpu")``, asks both the same
request and holds the port's response to the JAX one: every key but
``took`` equal, scores within rtol 1e-5, ids in order. The expectations
of the JAX tests are checked on the port's answer too. Every case closes
both indices.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    IllegalArgumentException as JIllegalArgument,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.search.service import (
    _build_fragments,
    _split_passages,
    _unified_fragments,
)

RTOL = 1e-5


class Pair:
    """A JAX and a port index holding the same docs."""

    def __init__(self, name, docs, shards=1, mapping=None):
        common = {"index.number_of_shards": shards,
                  "index.refresh_interval": -1, "index.search.mesh": False}
        self.j = JIndex(name, JSettings({
            **common, "index.requests.cache.enable": False}),
            mapping=mapping)
        self.t = IndexService(name, Settings(common), mapping=mapping,
                              device="cpu")
        for doc_id, src in docs:
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


def same(a, b, where="resp"):
    """Equal but ``took``; floats within RTOL."""
    if isinstance(a, dict):
        keys = set(a) - {"took"}
        assert keys == set(b) - {"took"}, (where, sorted(a), sorted(b))
        for k in keys:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=where)
    else:
        assert a == b, (where, a, b)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


@pytest.fixture()
def idx():
    docs = [("0", {"body": "alpha beta", "popularity": 1}),
            ("1", {"body": "alpha", "popularity": 100}),
            ("2", {"body": "alpha beta gamma", "popularity": 10}),
            ("3", {"body": "beta", "popularity": 50})]
    p = Pair("f", docs)
    yield p
    p.close()


def ids(r):
    return [h["_id"] for h in r["hits"]["hits"]]


@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
def test_rescore_total_and_modes(idx, mode):
    r = idx.search({
        "query": {"match": {"body": "alpha"}},
        "rescore": {"window_size": 10, "query": {
            "rescore_query": {"match": {"body": "beta"}},
            "query_weight": 1.0, "rescore_query_weight": 10.0,
            "score_mode": mode}}})
    assert set(ids(r)) == {"0", "1", "2"}
    if mode == "total":
        # the beta-matching alpha docs rank first
        assert set(ids(r)[:2]) == {"0", "2"}


def test_rescore_function_score_window(idx):
    r = idx.search({
        "query": {"match": {"body": "alpha"}},
        "rescore": {"window_size": 2, "query": {
            "rescore_query": {"function_score": {
                "query": {"match_all": {}},
                "field_value_factor": {"field": "popularity",
                                       "factor": 1.0},
                "boost_mode": "replace"}},
            "query_weight": 0.0, "rescore_query_weight": 1.0}}})
    # only the top 2 by BM25 took the popularity score
    assert len(ids(r)) == 3


def test_chained_rescorers(idx):
    idx.search({
        "query": {"match": {"body": "alpha"}},
        "rescore": [
            {"window_size": 3, "query": {
                "rescore_query": {"match": {"body": "beta"}}}},
            {"window_size": 1, "query": {
                "rescore_query": {"match": {"body": "gamma"}},
                "score_mode": "multiply"}}]})


def group_docs(rows):
    return [(str(i), {"group": g, "n": n, "t": "x"})
            for i, (g, n) in enumerate(rows)]


def test_collapse_keeps_best_per_group():
    p = Pair("c", group_docs([("g1", 1), ("g1", 9), ("g2", 5), ("g2", 3),
                              ("g3", 7)]), shards=2)
    try:
        r = p.search({"query": {"match": {"t": "x"}},
                      "collapse": {"field": "group"},
                      "sort": [{"n": "desc"}]})
        assert ids(r) == ["1", "4", "2"]
        # a numeric collapse key
        r = p.search({"query": {"match": {"t": "x"}},
                      "collapse": {"field": "n"}, "size": 3,
                      "sort": [{"n": "asc"}]})
        assert [h["fields"]["n"] for h in r["hits"]["hits"]] == [
            [1.0], [3.0], [5.0]]
    finally:
        p.close()


def test_collapse_inner_hits_expansion():
    p = Pair("c2", group_docs([("g1", 1), ("g1", 9), ("g1", 4), ("g2", 5),
                               ("g2", 3)]), shards=2)
    try:
        r = p.search({
            "query": {"match": {"t": "x"}},
            "collapse": {"field": "group", "inner_hits": {
                "name": "group_docs", "size": 2, "sort": [{"n": "desc"}]}},
            "sort": [{"n": "desc"}]})
        hits = r["hits"]["hits"]
        assert [h["_id"] for h in hits] == ["1", "3"]
        assert hits[0]["fields"]["group"] == ["g1"]
        ih = hits[0]["inner_hits"]["group_docs"]["hits"]
        assert ih["total"] == 3
        assert [h["_id"] for h in ih["hits"]] == ["1", "2"]
        ih2 = hits[1]["inner_hits"]["group_docs"]["hits"]
        assert ih2["total"] == 2
        assert [h["_id"] for h in ih2["hits"]] == ["3", "4"]
        # relevance-ranked collapse with default inner hits
        p.search({"query": {"match": {"t": "x"}},
                  "collapse": {"field": "group", "inner_hits": {}}})
    finally:
        p.close()


def test_collapse_multiple_inner_hits_and_missing_group():
    p = Pair("c3", [("a", {"group": "g1", "n": 2, "t": "x"}),
                    ("b", {"n": 8, "t": "x"}),
                    ("c", {"n": 6, "t": "x"})],
             mapping={"properties": {"group": {"type": "keyword"},
                                     "n": {"type": "long"},
                                     "t": {"type": "text"}}})
    try:
        r = p.search({
            "query": {"match": {"t": "x"}},
            "collapse": {"field": "group", "inner_hits": [
                {"name": "most", "size": 1, "sort": [{"n": "desc"}]},
                {"name": "least", "size": 1, "sort": [{"n": "asc"}]}]},
            "sort": [{"n": "desc"}]})
        hits = r["hits"]["hits"]
        assert [h["_id"] for h in hits] == ["b", "a"]
        assert hits[0]["fields"]["group"] == [None]
        assert [h["_id"] for h in
                hits[0]["inner_hits"]["most"]["hits"]["hits"]] == ["b"]
        assert [h["_id"] for h in
                hits[0]["inner_hits"]["least"]["hits"]["hits"]] == ["c"]
    finally:
        p.close()


def test_collapse_sees_groups_beyond_topk_window():
    docs = ([(f"a{i}", {"group": "g1", "n": 20 - i, "t": "x"})
             for i in range(20)]
            + [(f"b{i}", {"group": "g2", "n": -i, "t": "x"})
               for i in range(10)])
    p = Pair("c6", docs)
    try:
        r = p.search({"query": {"match": {"t": "x"}},
                      "collapse": {"field": "group"},
                      "sort": [{"n": "desc"}], "size": 10})
        assert [h["fields"]["group"][0] for h in r["hits"]["hits"]] == [
            "g1", "g2"]
    finally:
        p.close()


def test_collapse_rejections():
    p = Pair("c7", [("a", {"group": "g", "n": 1})])
    try:
        for body in ({"collapse": {"field": "group", "inner_hits": [
                {"size": 1}, {"size": 2}]}},
                {"collapse": {"field": "group"}, "sort": [{"n": "asc"}],
                 "search_after": [0]},
                {"collapse": {"field": "group"},
                 "rescore": {"query": {"rescore_query": {
                     "match_all": {}}}}}):
            with pytest.raises(JIllegalArgument) as je:
                p.j.search(dict(body))
            with pytest.raises(IllegalArgumentException) as te:
                p.t.search(dict(body))
            assert str(te.value) == str(je.value)
    finally:
        p.close()


def test_sliced_scan_partitions(idx):
    seen = set()
    for sid in range(3):
        got = set(ids(idx.search({"query": {"match_all": {}},
                                  "slice": {"id": sid, "max": 3},
                                  "size": 10})))
        assert not seen & got
        seen |= got
    assert seen == {"0", "1", "2", "3"}


def test_slice_over_the_limit_raises():
    """A slice count over index.max_slices_per_scroll fails the query phase
    of every shard: both packages raise "all shards failed" with one
    failure entry a shard (ROADMAP C14)."""
    from elasticsearch_tpu.common.errors import (
        SearchPhaseExecutionException as JSearchPhaseExecution,
    )
    from elasticsearch_tpu_torch.common.errors import (
        SearchPhaseExecutionException,
    )

    common = {"index.number_of_shards": 2, "index.max_slices_per_scroll": 4,
              "index.search.mesh": False}
    j = JIndex("sl", JSettings({**common,
                                "index.requests.cache.enable": False}))
    t = IndexService("sl", Settings(common), device="cpu")
    try:
        for svc in (j, t):
            for d in range(4):
                svc.index_doc(str(d), {"n": d})
            svc.refresh()
        body = {"query": {"match_all": {}}, "slice": {"id": 0, "max": 5}}
        with pytest.raises(JSearchPhaseExecution) as je:
            j.search(dict(body))
        with pytest.raises(SearchPhaseExecutionException,
                           match="all shards failed") as te:
            t.search(dict(body))
        same(je.value.to_dict(), te.value.to_dict(), "error")
        failed = te.value.to_dict()["error"]["failed_shards"]
        assert [f["shard"] for f in failed] == [0, 1]
        assert all("too large" in f["reason"]["reason"] for f in failed)
    finally:
        j.close()
        t.close()


STORY = ("The quick brown fox jumps over the lazy dog. "
         "Nothing interesting happens in this sentence at all. "
         "Another fox appears and the fox runs away quickly. "
         "The end of the story arrives without any animals.")


@pytest.fixture()
def hl():
    p = Pair("hl", [("1", {"body": STORY, "tag": "fox",
                           "title": "A fox story"}),
                    ("2", {"body": "no animals here. just text.",
                           "title": "Plain"})],
             mapping={"properties": {"body": {"type": "text"},
                                     "title": {"type": "text"},
                                     "tag": {"type": "keyword"}}})
    yield p
    p.close()


def test_passages_are_sentence_bounded_and_scored(hl):
    r = hl.search({"query": {"match": {"body": "fox"}},
                   "highlight": {"fields": {"body": {
                       "number_of_fragments": 2}}}})
    frags = r["hits"]["hits"][0]["highlight"]["body"]
    assert len(frags) == 2
    assert frags[0].startswith("The quick brown")
    assert "<em>fox</em>" in frags[0] and "<em>fox</em>" in frags[1]
    assert all("Nothing interesting" not in f for f in frags)


def test_score_order_puts_best_passage_first(hl):
    r = hl.search({"query": {"match": {"body": "fox"}},
                   "highlight": {"order": "score", "fields": {"body": {
                       "number_of_fragments": 2}}}})
    assert r["hits"]["hits"][0]["highlight"]["body"][0].count(
        "<em>fox</em>") == 2


@pytest.mark.parametrize("body", [
    {"query": {"match": {"body": "fox"}},
     "highlight": {"fields": {"body": {"type": "plain"}}}},
    {"query": {"match": {"body": "fox dog"}},
     "highlight": {"type": "plain", "pre_tags": ["["], "post_tags": ["]"],
                   "fields": {"body": {"fragment_size": 20,
                                       "number_of_fragments": 3}}}},
    {"query": {"bool": {"must": [{"match": {"body": "fox"}}],
                        "should": [{"term": {"tag": "fox"}}]}},
     "highlight": {"fields": {"*": {}}, "require_field_match": False}},
    {"query": {"multi_match": {"query": "fox story",
                               "fields": ["body", "title^2"]}},
     "highlight": {"fields": {"body": {}, "title": {}}}},
    {"query": {"dis_max": {"queries": [
        {"match_phrase": {"body": "lazy dog"}},
        {"constant_score": {"filter": {"terms": {"tag": ["fox"]}}}}]}},
     "highlight": {"fields": {"body": {}, "tag": {}}}},
    {"query": {"function_score": {"query": {"match": {"title": "plain"}},
                                  "boost_mode": "multiply"}},
     "highlight": {"fields": {"title": {}, "body": {}}}},
])
def test_highlighters_equal_jax(hl, body):
    r = hl.search(dict(body, sort=[{"_doc": "asc"}]))
    assert any("highlight" in h for h in r["hits"]["hits"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fragment_builders_equal_jax(seed):
    """The passage splitter and both fragment builders on random texts
    (long sentences, matches at the edges) equal the JAX package's."""
    from elasticsearch_tpu.search import service as jsvc

    rng = np.random.RandomState(seed)
    words = ["fox", "dog", "a", "the", "quick", "lazy", "x" * 40]
    toks = rng.choice(words, 120)
    text = ""
    spans = []
    for i, tok in enumerate(toks):
        if i and rng.rand() < 0.1:
            text += ". "
        elif i:
            text += " "
        if tok == "fox":
            spans.append((len(text), len(text) + 3, "fox"))
        text += tok
    for size in (10, 50, 100):
        assert _split_passages(text, size) == jsvc._split_passages(text, size)
        for order in ("none", "score"):
            assert (_unified_fragments(text, spans, size, 3, "<", ">", order)
                    == jsvc._unified_fragments(text, spans, size, 3, "<",
                                               ">", order))
        pairs = [(s, e) for s, e, _ in spans]
        assert (_build_fragments(text, pairs, size, 4, "<", ">")
                == jsvc._build_fragments(text, pairs, size, 4, "<", ">"))
