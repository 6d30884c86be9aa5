"""Parity of the port's similarities with the JAX package's.

Mirrors tests/test_similarity.py: every similarity's lane parameters
equal the JAX package's exactly over a grid of term statistics; each
kind's contribution formula (``emit_contrib`` on tensors) equals the JAX
one within rtol 1e-5; a search on a field under each similarity (and
under ``index.similarity.default.type``) gives the same ids exactly and
scores within rtol 1e-5, on the host rung and on the mesh plane; the
service parses the same settings and rejects the same errors.
"""

import math

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import IllegalArgumentException as JIAE
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index import similarity as JS
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index import similarity as TS
from elasticsearch_tpu_torch.index.index_service import IndexService
from test_torch_mesh import compare

# one similarity a name: every kind and parameter form of the service
SIMS = {
    "bm25_custom": {"type": "BM25", "k1": 1.8, "b": 0.3},
    "len_blind": {"type": "BM25", "b": 0.0},
    "classic": {"type": "classic"},
    "boolean": {"type": "boolean"},
    "lmd": {"type": "LMDirichlet", "mu": 100},
    "lmj": {"type": "LMJelinekMercer", "lambda": 0.5},
    "dfr_g_l_h2": {"type": "DFR", "basic_model": "g", "after_effect": "l",
                   "normalization": "h2", "normalization.h2.c": 2.0},
    "dfr_if_b_h1": {"type": "DFR", "basic_model": "if", "after_effect": "b",
                    "normalization": "h1"},
    "dfr_in_no_z": {"type": "DFR", "basic_model": "in", "after_effect": "no",
                    "normalization": "z", "normalization.z.z": 0.5},
    "dfr_ine_l_no": {"type": "DFR", "basic_model": "ine",
                     "after_effect": "l", "normalization": "no"},
    "ib_ll_df_h2": {"type": "IB", "distribution": "ll", "lambda": "df",
                    "normalization": "h2"},
    "ib_spl_df_h1": {"type": "IB", "distribution": "spl", "lambda": "df",
                     "normalization": "h1", "normalization.h1.c": 1.5},
    # lambda ttf exceeds 1 on a term more frequent than the docs: the SPL
    # formula then gives NaN in both packages (tested on the host rung)
    "ib_spl_ttf_h1": {"type": "IB", "distribution": "spl", "lambda": "ttf",
                      "normalization": "h1", "normalization.h1.c": 1.5},
    "ib_ll_ttf_z": {"type": "IB", "distribution": "ll", "lambda": "ttf",
                    "normalization": "z"},
}


def sim_settings(names=SIMS):
    return {f"index.similarity.{n}.{k}": v
            for n in names for k, v in SIMS[n].items()}


def services():
    flat = sim_settings()
    return JS.SimilarityService(JSettings(flat)), \
        TS.SimilarityService(Settings(flat))


STATS = [dict(df=df, ttf=ttf, doc_count=n, sum_ttf=t, avgdl=a, boost=bo)
         for df, ttf, n, t, a, bo in (
             (1, 1, 10, 80, 8.0, 1.0), (3, 7, 40, 500, 12.5, 2.0),
             (40, 90, 40, 500, 12.5, 0.5), (250, 1200, 1000, 9000, 9.0, 1.0),
             (7, 7, 7, 7, 1.0, 3.0))]


@pytest.mark.parametrize("name", sorted(SIMS) + ["BM25", "classic",
                                                 "boolean"])
def test_lane_params_equal(name):
    jsvc, tsvc = services()
    jsim, tsim = jsvc.get(name), tsvc.get(name)
    assert type(tsim).__name__ == type(jsim).__name__
    assert tsim.needs_ttf == jsim.needs_ttf
    for st in STATS:
        assert tsim.lane_params(dict(st)) == jsim.lane_params(dict(st))


def test_emit_contrib_each_kind_within_rtol():
    import jax.numpy as jnp

    jsvc, tsvc = services()
    rng = np.random.RandomState(3)
    tf = rng.randint(1, 9, (4, 128)).astype(np.float32)
    dl = (tf + rng.randint(0, 60, (4, 128))).astype(np.float32)
    kinds = set()
    for name in sorted(SIMS) + ["BM25"]:
        for st in STATS:
            kind, w, p1, p2, p3 = jsvc.get(name).lane_params(dict(st))
            kinds.add(kind)
            args = [np.full((4, 1), v, np.float32)
                    for v in (w, st["avgdl"], p1, p2, p3)]
            want = np.asarray(JS.emit_contrib(
                kind, jnp.asarray(tf), jnp.asarray(dl), jnp.asarray(args[0]),
                *(jnp.asarray(a) for a in args[1:])))
            got = TS.emit_contrib(
                kind, torch.from_numpy(tf), torch.from_numpy(dl),
                *(torch.from_numpy(a) for a in args)).numpy()
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {kind} {st}")
    assert len(kinds) == 12
    assert TS.STRICTLY_POSITIVE_KINDS == JS.STRICTLY_POSITIVE_KINDS
    with pytest.raises(IllegalArgumentException):
        TS.emit_contrib("nope", torch.ones(1), torch.ones(1), 1.0, 1.0, 1.0,
                        1.0, 0.0)


def test_service_builtins_custom_and_default():
    tsvc = TS.SimilarityService()
    assert isinstance(tsvc.get("BM25"), TS.BM25Similarity)
    assert isinstance(tsvc.get("classic"), TS.ClassicSimilarity)
    assert isinstance(tsvc.get("boolean"), TS.BooleanSimilarity)
    assert isinstance(tsvc.get(None), TS.BM25Similarity)
    _, tsvc = services()
    assert (tsvc.get("bm25_custom").k1, tsvc.get("bm25_custom").b) == (1.8, 0.3)
    dfr = tsvc.get("dfr_if_b_h1")
    assert (dfr.basic_model, dfr.after_effect, dfr.normalization) == \
        ("if", "b", "h1")
    assert tsvc.get("dfr_g_l_h2").c == 2.0
    assert tsvc.get("ib_spl_df_h1").distribution == "spl"
    assert tsvc.get("lmd").mu == 100.0 and tsvc.get("lmj").lam == 0.5
    over = TS.SimilarityService(Settings({
        "index.similarity.default.type": "boolean"}))
    assert isinstance(over.get(None), TS.BooleanSimilarity)


@pytest.mark.parametrize("build", [
    lambda m: m.SimilarityService(None).get("missing"),
    lambda m: m.DFRSimilarity(basic_model="zz"),
    lambda m: m.DFRSimilarity(after_effect="zz"),
    lambda m: m.DFRSimilarity(normalization="zz"),
    lambda m: m.IBSimilarity(distribution="zz"),
    lambda m: m.IBSimilarity(lam="zz"),
    lambda m: m.LMJelinekMercerSimilarity(lam=0.0),
], ids=["name", "dfr_model", "dfr_effect", "dfr_norm", "ib_dist",
        "ib_lambda", "lmj_lambda"])
def test_same_errors(build):
    with pytest.raises(JIAE) as jerr:
        build(JS)
    with pytest.raises(IllegalArgumentException) as terr:
        build(TS)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("flat", [{"index.similarity.x.type": "nope"},
                                  {"index.similarity.x.mu": 3}])
def test_bad_settings_raise_the_same_error(flat):
    with pytest.raises(JIAE) as jerr:
        JS.SimilarityService(JSettings(flat))
    with pytest.raises(IllegalArgumentException) as terr:
        TS.SimilarityService(Settings(flat))
    assert str(terr.value) == str(jerr.value)


def test_unknown_field_similarity_rejected_at_mapping_time():
    mapping = {"properties": {"body": {"type": "text",
                                       "similarity": "typo_name"}}}
    with pytest.raises(JIAE):
        JIndex("s", JSettings({}), mapping=mapping)
    with pytest.raises(IllegalArgumentException):
        IndexService("s", Settings({}), mapping=mapping, device="cpu")


# ----------------------------------------------------------------------
# Searches on a field under each similarity
# ----------------------------------------------------------------------

FIELDS = sorted(SIMS) + ["plain"]  # "plain": the index default
NAN_FIELD = "ib_spl_ttf_h1"


def sim_docs(n=240, seed=8):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(30)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = []
    for d in range(n):
        text = " ".join(rng.choice(vocab, rng.randint(2, 25), p=p))
        docs.append((str(d), {f: text for f in FIELDS}))
    return docs


def build_pair(mesh, default=None):
    props = {f: {"type": "text", "analyzer": "whitespace"} for f in FIELDS}
    for f in SIMS:
        props[f]["similarity"] = f
    common = {"index.number_of_shards": 3, "index.refresh_interval": -1,
              **sim_settings()}
    if default is not None:
        common["index.similarity.default.type"] = default
    if not mesh:
        common["index.search.mesh"] = False
    name = f"sim-{mesh}-{default}"
    jidx = JIndex(name, JSettings({**common, "search.aggs.fused": False,
                                   "index.staging.delta.enabled": False,
                                   "index.requests.cache.enable": False}),
                  mapping={"properties": props})
    if mesh:
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common),
                        mapping={"properties": props}, device="cpu")
    for doc_id, src in sim_docs():
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


@pytest.mark.parametrize("field", [f for f in FIELDS if f != NAN_FIELD])
def test_search_under_each_similarity(pair, field):
    plane, jidx, tidx = pair
    for query in ({"match": {field: "w0 w3 w11"}},
                  {"match": {field: {"query": "w1 w2", "operator": "and"}}},
                  {"match_phrase": {field: "w0 w1"}}):
        body = {"query": query, "size": 300}
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        compare(jr, tr)
        assert tr["hits"]["total"] > 0
        if plane == "host":
            assert tr["_plane"] == "host"


def test_nan_scores_never_hit_on_the_host_rung(pair):
    """IB SPL with lambda ttf above 1 scores NaN: the docs count in the
    total and never come back as hits, as in the JAX package's host
    rung (its mesh plane returns them; the port's does not)."""
    plane, jidx, tidx = pair
    body = {"query": {"match": {NAN_FIELD: "w0 w3 w11"}}, "size": 300}
    tr = tidx.search(dict(body))
    assert all(np.isfinite(h["_score"]) for h in tr["hits"]["hits"])
    assert tr["hits"]["total"] > len(tr["hits"]["hits"]) > 0
    if plane == "host":
        compare(jidx.search(dict(body)), tr, "host")


def test_mixed_similarities_in_one_disjunction(pair):
    """A multi_match and a bool over fields of different kinds: kernel
    and scatter children side by side, and the multi-kind scatter node."""
    _, jidx, tidx = pair
    for query in ({"multi_match": {"query": "w2 w5", "type": "most_fields",
                                   "fields": ["plain", "lmd", "boolean"]}},
                  {"multi_match": {"query": "w4", "tie_breaker": 0.4,
                                   "fields": ["plain^2", "dfr_g_l_h2",
                                              "ib_ll_df_h2"]}},
                  {"more_like_this": {"fields": ["plain", "classic", "lmj"],
                                      "like": "w1 w1 w6 w6 w9",
                                      "min_term_freq": 1}}):
        body = {"query": query, "size": 300}
        compare(jidx.search(dict(body)), tidx.search(dict(body)))


def test_default_type_honoured():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = build_pair(False, default="boolean")
    try:
        body = {"query": {"match": {"plain": "w0 w7"}}, "size": 300}
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        compare(jr, tr, "host")
        # boolean: one point a matched term
        assert {h["_score"] for h in tr["hits"]["hits"]} <= {1.0, 2.0}
    finally:
        jidx.close()
        tidx.close()
        mp.undo()


def test_bm25_default_is_exact_lucene():
    idx = IndexService("b", Settings({"index.number_of_shards": 1}),
                       mapping={"properties": {"body": {
                           "type": "text", "analyzer": "whitespace"}}},
                       device="cpu")
    for i, d in enumerate(["fox fox fox jumps",
                           "fox jumps over the lazy dog near the river bank "
                           "in the morning light", "dog sleeps",
                           "quick brown fox"]):
        idx.index_doc(str(i + 1), {"body": d})
    idx.refresh()
    r = idx.search({"query": {"match": {"body": "fox"}}})
    s = {h["_id"]: h["_score"] for h in r["hits"]["hits"]}
    n, df = 4, 3
    idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
    avgdl = (4 + 14 + 2 + 3) / 4.0
    expected = idf * 3.0 * 2.2 / (3.0 + 1.2 * (1 - 0.75 + 0.75 * 4.0 / avgdl))
    assert s["1"] == pytest.approx(expected, rel=1e-5)
    idx.close()
