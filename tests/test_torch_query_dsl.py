"""Parity of the query DSL beyond ``match`` with the JAX package.

The same numpy-seeded documents (two text fields, ``title`` under BM25
and ``abstract`` under an LM-Dirichlet similarity and missing from some
docs, a keyword ``venue``, a long ``year``) go into a 3-shard JAX
``IndexService`` (tile kernel in interpret mode, ``ES_TPU_PALLAS=
interpret``) and a 3-shard port ``IndexService(device="cpu")``, once on
the host rung (``index.search.mesh: false``) and once on the mesh plane
(the JAX index with a one-device mesh and ``search.aggs.fused: false``,
as tests/test_torch_mesh.py builds it). Every request answers equally:
``_plane`` and ``_shards`` exactly, totals, ids and buckets exactly (ids
up to ties within rtol 1e-5), scores within rtol 1e-5. The cases mirror
the query cases of tests/test_search.py, plus ``match_phrase_prefix``,
slop and ``random_score``.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import ParsingException as JParsing
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu.search import query_dsl as JQ
from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.search import query_dsl as Q
from test_torch_mesh import compare

N_DOCS = 300
MAPPING = {"properties": {
    "title": {"type": "text"},
    "abstract": {"type": "text", "similarity": "lm"},
    "venue": {"type": "keyword"},
    "year": {"type": "long"},
}}
SIM = {"index.similarity.lm.type": "LMDirichlet",
       "index.similarity.lm.mu": 50}


def seeded_docs(n_docs=N_DOCS, seed=12):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(40)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = []
    for d in range(n_docs):
        src = {"title": " ".join(rng.choice(vocab, rng.randint(3, 14), p=p)),
               "venue": f"v{int(rng.zipf(1.7)) % 9}",
               "year": int(1990 + rng.randint(30))}
        if rng.rand() >= 0.1:  # abstract missing on about 10% of docs
            src["abstract"] = " ".join(rng.choice(vocab, rng.randint(4, 20),
                                                  p=p))
        docs.append((f"d{d}", src))
    return docs


def build_pair(mesh: bool):
    common = {"index.number_of_shards": 3, "index.refresh_interval": -1,
              **SIM}
    if not mesh:
        common["index.search.mesh"] = False
    name = "qdsl-mesh" if mesh else "qdsl-host"
    jidx = JIndex(name, JSettings({
        **common, "search.aggs.fused": False,
        "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=MAPPING)
    if mesh:
        # the port serves one device: give the JAX plane a one-device mesh
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common), mapping=MAPPING,
                        device="cpu")
    for doc_id, src in seeded_docs():
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


@pytest.fixture(scope="module", params=["host", "mesh"])
def pair(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = build_pair(request.param == "mesh")
    yield request.param, jidx, tidx
    jidx.close()
    tidx.close()
    mp.undo()


CASES = {
    "match_phrase": {"match_phrase": {"title": "w0 w1"}},
    "match_phrase_none": {"match_phrase": {"title": "w1 w0 w39"}},
    "match_phrase_slop": {"match_phrase": {"title": {"query": "w2 w0",
                                                     "slop": 2}}},
    "match_phrase_lm": {"match_phrase": {"abstract": "w0 w2"}},
    "match_phrase_prefix": {"match_phrase_prefix": {"title": "w0 w1"}},
    "match_phrase_prefix_one": {"match_phrase_prefix": {"title": "w3"}},
    "multi_match_best": {"multi_match": {
        "query": "w3 w7", "fields": ["title^2", "abstract"],
        "tie_breaker": 0.3}},
    "multi_match_most": {"multi_match": {
        "query": "w5 w9", "fields": ["title", "abstract"],
        "type": "most_fields"}},
    "multi_match_pattern": {"multi_match": {"query": "w4",
                                            "fields": ["ti*", "abs*^1.5"]}},
    "exists": {"exists": {"field": "abstract"}},
    "ids": {"ids": {"values": ["d3", "d17", "d250", "nope"]}},
    "term_id": {"term": {"_id": "d42"}},
    "prefix": {"prefix": {"title": "w1"}},
    "wildcard": {"wildcard": {"title": "w?5*"}},
    "regexp": {"regexp": {"title": "w[0-2][0-9]"}},
    "regexp_keyword": {"regexp": {"venue": "v[1-3]"}},
    "fuzzy": {"fuzzy": {"title": {"value": "w12", "fuzziness": 1}}},
    "dis_max": {"dis_max": {"queries": [
        {"match": {"title": "w6"}}, {"match": {"abstract": "w6 w8"}}],
        "tie_breaker": 0.2}},
    "function_score_fvf": {"function_score": {
        "query": {"match": {"title": "w2 w4"}},
        "field_value_factor": {"field": "year", "modifier": "log1p",
                               "factor": 0.01},
        "boost_mode": "sum"}},
    "function_score_replace": {"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "year", "factor": 1.0},
        "boost_mode": "replace"}},
    "function_score_random": {"function_score": {
        "query": {"match": {"title": "w1"}},
        "functions": [{"random_score": {"seed": 7}}, {"weight": 2.5}]}},
    "query_string": {"query_string": {
        "query": "title:(w5 OR w6) AND NOT abstract:w7"}},
    "query_string_phrase": {"query_string": {"query": '"w0 w1" w9'}},
    "query_string_default_fields": {"query_string": {"query": "w11"}},
    "query_string_and": {"query_string": {"query": "w0 w3",
                                          "default_field": "title",
                                          "default_operator": "and"}},
    "simple_query_string": {"simple_query_string": {"query": "+w2 -w3"}},
    "more_like_this": {"more_like_this": {
        "fields": ["title", "abstract"], "like": [{"_id": "d5"}],
        "min_term_freq": 1, "minimum_should_match": "10%"}},
    "more_like_this_text": {"more_like_this": {
        "fields": ["title"], "like": "w3 w3 w8 w8 w13",
        "min_term_freq": 1}},
}


# the plane each package serves these from on the mesh index: the
# clauses whose plan skeleton agrees on every slot stay on the mesh (its
# kernel rung where a BM25 disjunction scores)
MESH_PLANES = {"multi_match_best": "mesh_pallas", "dis_max": "mesh_pallas",
               "prefix": "mesh_pallas", "exists": "mesh",
               "function_score_fvf": "mesh_pallas"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_response_and_plane(pair, name):
    plane, jidx, tidx = pair
    body = {"query": CASES[name], "size": N_DOCS}
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    compare(jr, tr)
    if plane == "host":
        assert tr["_plane"] == "host"
    elif name in MESH_PLANES:
        assert tr["_plane"] == MESH_PLANES[name]


def test_terms_agg_under_multi_match(pair):
    _, jidx, tidx = pair
    body = {"size": 5, "query": CASES["multi_match_best"],
            "aggs": {"v": {"terms": {"field": "venue"}}}}
    compare(jidx.search(dict(body)), tidx.search(dict(body)))


def test_unknown_query_rejected(pair):
    _, jidx, tidx = pair
    for q in ({"bogus_query": {}},
              {"function_score": {"query": {"match_all": {}},
                                  "script_score": {"script": "1"}}}):
        with pytest.raises(JParsing):
            jidx.search({"query": q})
        with pytest.raises(ParsingException):
            tidx.search({"query": q})
    # the span family answers as the JAX package's since its slice
    body = {"query": {"span_term": {"title": "w1"}}}
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert [h["_id"] for h in tr["hits"]["hits"]] == \
        [h["_id"] for h in jr["hits"]["hits"]]
    assert tr["hits"]["total"] == jr["hits"]["total"] > 0


def _runs_from(per_doc_positions):
    """A term's (docs, positions, keys), as ``SegmentPositions`` gives
    them."""
    docs = np.repeat(np.arange(len(per_doc_positions), dtype=np.int32),
                     [len(p) for p in per_doc_positions])
    pos = np.concatenate([np.sort(np.asarray(p, np.int32))
                          for p in per_doc_positions])
    return docs, pos, (docs.astype(np.int64) << 32) | pos


@pytest.mark.parametrize("slop", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", ["2", "3", "3_skewed", "a_b_a", "a_a"])
def test_phrase_freqs_equal_the_per_doc_rule(slop, shape):
    """The vectorized intersection gives the JAX package's per-doc
    ``_phrase_freq`` exactly, the greedy sloppy count included, whichever
    term's run is the shortest and with a term repeated."""
    rng = np.random.RandomState(slop * 7 + len(shape))
    n_docs = 200
    n_terms = 2 if shape in ("2", "a_a") else 3
    per_term = []
    for t in range(n_terms):
        most = 3 if (shape == "3_skewed" and t == 2) else 6
        per_term.append([np.unique(rng.randint(0, 30, rng.randint(0, most)))
                         for _ in range(n_docs)])
    if shape == "a_b_a":
        per_term[2] = per_term[0]
    elif shape == "a_a":
        per_term[1] = per_term[0]
    runs = [_runs_from(t) for t in per_term]
    docs, freqs = Q.phrase_freqs(runs, slop)
    want = {}
    for d in range(n_docs):
        lists = [per_term[t][d] for t in range(n_terms)]
        if all(len(x) for x in lists):
            f = JQ._phrase_freq([np.asarray(x, np.int32) for x in lists],
                                slop)
            if f:
                want[d] = f
    assert dict(zip(docs.tolist(), freqs.tolist())) == want
    assert docs.dtype == np.int32 and np.all(np.diff(docs) > 0)



def test_fuzzy_expansions_equal_the_dp():
    rng = np.random.RandomState(4)
    alphabet = list("abcde")
    tokens = sorted({"".join(rng.choice(alphabet, rng.randint(1, 8)))
                     for _ in range(600)})
    for value in ("abcd", "ba", "eeeee", "a"):
        for k in (0, 1, 2):
            got = Q._levenshtein_leq_many(tokens, value, k)
            want = [JQ._levenshtein_leq(t, value, k) for t in tokens]
            assert got.tolist() == want, (value, k)
