"""Parity of sort and paging with the JAX package.

The same numpy-seeded documents (a ``title`` text field, a ``venue``
keyword missing on some docs, a ``citations`` long missing on some docs
with heavy ties, an f32-exact ``price``, a ``ts`` date over one year that
f32 cannot hold exactly) go into a 3-shard JAX ``IndexService`` (tile
kernel in interpret mode, ``ES_TPU_PALLAS=interpret``) and a 3-shard port
``IndexService(device="cpu")``, once on the host rung (``index.search.
mesh: false``) and once on the mesh plane (the JAX index with a
one-device mesh, as tests/test_torch_mesh.py builds it). Every request
answers equally: ``_plane``, ids in order, each hit's ``sort`` array,
totals and ``terminated_early`` exactly, scores within rtol 1e-5 (ids in
order too: the port's top-k keeps the JAX tie order). The cases mirror
tests/test_search.py's sort and pagination tests, tests/test_plan_exec.py's
mesh sort and feature tests and tests/test_property_random.py's
search_after walks, plus the mesh plane's own decisions: which sorts it
serves, why it declines the rest, the keyword vocabulary after a delta
append, and the pruned shortcut a sorted body never takes.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.parallel.plan_exec import IndexMeshSearch

RTOL = 1e-5
N_DOCS = 240
MAPPING = {"properties": {
    "title": {"type": "text"},
    "venue": {"type": "keyword"},
    "citations": {"type": "long"},
    "price": {"type": "float"},
    "ts": {"type": "date"},
    "uid": {"type": "keyword"},
}}
YEAR_START_MS = 1672531200000  # 2023-01-01


def seeded_docs(n_docs=N_DOCS, seed=3, prefix="d"):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(20)]
    docs = []
    for d in range(n_docs):
        src = {"title": " ".join(rng.choice(vocab, rng.randint(3, 10))),
               "price": float(rng.randint(0, 400)) * 0.25,
               "ts": int(YEAR_START_MS + rng.randint(0, 365 * 86400) * 1000),
               "uid": f"{prefix}{d:04d}"}
        if rng.rand() > 0.1:
            src["venue"] = f"v{rng.randint(12):02d}"
        if rng.rand() > 0.1:
            src["citations"] = int(rng.zipf(1.6) % 50)
        docs.append((f"{prefix}{d}", src))
    return docs


def build_pair(mesh: bool, name: str = "srt", shards: int = 3,
               settings=None):
    common = {"index.number_of_shards": shards, "index.refresh_interval": -1,
              **(settings or {})}
    if not mesh:
        common["index.search.mesh"] = False
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


def assert_same(jr, tr, where="", score_sort=False):
    """Plane, totals, terminated_early, ids in order, sort arrays (a
    ``_score`` entry within rtol when ``score_sort``, else exact), scores
    (rtol), sources and highlights."""
    assert tr["_plane"] == jr["_plane"], where
    assert tr["hits"]["total"] == jr["hits"]["total"], where
    assert tr.get("terminated_early") == jr.get("terminated_early"), where
    jh, th = jr["hits"]["hits"], tr["hits"]["hits"]
    assert [h["_id"] for h in th] == [h["_id"] for h in jh], where
    if score_sort:
        for a, b in zip(jh, th):
            assert len(a["sort"]) == len(b["sort"]), where
            for x, y in zip(a["sort"], b["sort"]):
                if isinstance(x, float) and isinstance(y, float):
                    np.testing.assert_allclose(y, x, rtol=RTOL, err_msg=where)
                else:
                    assert x == y, where
    else:
        assert ([h.get("sort") for h in th]
                == [h.get("sort") for h in jh]), where
    for a, b in zip(jh, th):
        if a["_score"] is None:
            assert b["_score"] is None, where
        else:
            np.testing.assert_allclose(b["_score"], a["_score"], rtol=RTOL,
                                       err_msg=where)
        assert b.get("highlight") == a.get("highlight"), where
        assert b["_source"] == a["_source"], where
    if jr["hits"]["max_score"] is None:
        assert tr["hits"]["max_score"] is None, where
    else:
        np.testing.assert_allclose(tr["hits"]["max_score"],
                                   jr["hits"]["max_score"], rtol=RTOL)


SORTS = {
    "numeric_desc": [{"citations": "desc"}],
    "numeric_asc": [{"citations": {"order": "asc"}}],
    "missing_first": [{"citations": {"order": "asc", "missing": "_first"}}],
    "missing_last_desc": [{"citations": {"order": "desc",
                                         "missing": "_last"}}],
    "missing_number": [{"citations": {"order": "asc", "missing": 7}}],
    "float_desc": [{"price": {"order": "desc"}}],
    "keyword_asc": [{"venue": "asc"}],
    "keyword_desc_missing_first": [{"venue": {"order": "desc",
                                              "missing": "_first"}}],
    "keyword_custom_missing": [{"venue": {"order": "asc",
                                          "missing": "v05x"}}],
    "doc": ["_doc"],
    "date_desc": [{"ts": "desc"}],
    "multi_field": [{"venue": "asc"}, {"citations": "desc"}],
    "score_then_field": ["_score", {"price": "asc"}],
    "unmapped_numeric_missing": [{"nope": {"order": "asc", "missing": 3}}],
}
QUERIES = {
    "all": {"match_all": {}},
    "match": {"match": {"title": "w1 w2"}},
}


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("sort", sorted(SORTS))
def test_sort_parity(pair, sort, query):
    _, jidx, tidx = pair
    body = {"query": QUERIES[query], "sort": SORTS[sort], "size": 40}
    assert_same(jidx.search(dict(body)), tidx.search(dict(body)),
                f"{sort}/{query}", score_sort="_score" in str(SORTS[sort]))


def test_sort_from_size_and_relevance_sort(pair):
    _, jidx, tidx = pair
    for body in ({"query": {"match_all": {}}, "sort": [{"price": "desc"}],
                  "from": 5, "size": 7},
                 {"query": {"match": {"title": "w3"}}, "sort": "_score",
                  "size": 12},
                 {"query": {"match": {"title": "w3"}},
                  "sort": [{"_score": {"order": "desc"}}], "size": 5},
                 {"query": {"match_all": {}}, "sort": [{"citations": "desc"}],
                  "size": 0}):
        assert_same(jidx.search(dict(body)), tidx.search(dict(body)),
                    str(body))


def walk_search_after(idx, body, page):
    seen, after, pages = [], None, 0
    for _ in range(200):
        b = dict(body, size=page)
        if after is not None:
            b["search_after"] = after
        hits = idx.search(b)["hits"]["hits"]
        if not hits:
            break
        pages += 1
        seen.extend((h["_id"], h["sort"]) for h in hits)
        after = hits[-1]["sort"]
    return seen, pages


@pytest.mark.parametrize("sort", [
    [{"price": "desc"}],
    [{"citations": {"order": "asc", "missing": "_last"}}, {"uid": "asc"}],
    [{"venue": "asc"}, {"uid": "asc"}],
    [{"venue": {"order": "desc", "missing": "_first"}}, {"uid": "desc"}],
])
def test_search_after_walks_every_hit_once(pair, sort):
    """Pages of 9 joined equal one request for every hit (ids and sort
    values), on both packages."""
    _, jidx, tidx = pair
    body = {"query": {"match": {"title": "w1 w4"}}, "sort": sort}
    whole = tidx.search(dict(body, size=N_DOCS))
    want = [(h["_id"], h["sort"]) for h in whole["hits"]["hits"]]
    got, pages = walk_search_after(tidx, body, 9)
    jgot, _ = walk_search_after(jidx, body, 9)
    assert got == want == jgot
    assert pages > 3
    assert len({i for i, _ in got}) == whole["hits"]["total"]


def test_search_after_each_page(pair):
    """Every page of a numeric, a keyword and a relevance walk answers
    equally, page by page (the mesh plane cuts in oriented-key space)."""
    _, jidx, tidx = pair
    for base in ({"query": {"match_all": {}},
                  "sort": [{"price": {"order": "desc"}}], "size": 10},
                 {"query": {"match_all": {}},
                  "sort": [{"venue": {"order": "asc"}}], "size": 12},
                 {"query": {"match": {"title": "w3 w5"}}, "size": 5}):
        jr, tr = jidx.search(dict(base)), tidx.search(dict(base))
        assert_same(jr, tr, str(base))
        for _ in range(3):
            last = jr["hits"]["hits"][-1]
            cursor = last["sort"] if "sort" in last else [last["_score"]]
            page = dict(base, search_after=cursor)
            jr, tr = jidx.search(dict(page)), tidx.search(dict(page))
            assert_same(jr, tr, str(page))
            if not jr["hits"]["hits"]:
                break


@pytest.mark.parametrize("smax", [2, 3, 4, 7])
def test_slice_partition(pair, smax):
    """Slices are disjoint, their union is every hit, each equal to the
    JAX package's (a hash of the _id term bytes)."""
    _, jidx, tidx = pair
    union = set()
    for i in range(smax):
        body = {"query": {"match_all": {}},
                "slice": {"id": i, "max": smax}, "size": N_DOCS}
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        assert_same(jr, tr, f"slice {i}/{smax}")
        ids = {h["_id"] for h in tr["hits"]["hits"]}
        assert not ids & union
        union |= ids
    assert len(union) == N_DOCS


def test_slice_with_sort_and_bad_slice(pair):
    _, jidx, tidx = pair
    body = {"query": {"match": {"title": "w2"}}, "sort": [{"price": "asc"}],
            "slice": {"id": 1, "max": 5}, "size": 30}
    assert_same(jidx.search(dict(body)), tidx.search(dict(body)))
    from elasticsearch_tpu_torch.common.errors import (
        IllegalArgumentException,
    )

    with pytest.raises(IllegalArgumentException, match="max must be"):
        tidx.search({"query": {"match_all": {}},
                     "slice": {"id": 0, "max": 1}})


@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
def test_rescore_modes(pair, mode):
    _, jidx, tidx = pair
    body = {
        "query": {"match": {"title": "w1"}},
        "rescore": {"window_size": 6, "query": {
            "rescore_query": {"match": {"title": "w4"}},
            "query_weight": 0.7, "rescore_query_weight": 1.3,
            "score_mode": mode}},
        "size": 8,
    }
    assert_same(jidx.search(dict(body)), tidx.search(dict(body)), mode)


@pytest.mark.parametrize("terminate_after", [1, 5, 1000])
def test_terminate_after(pair, terminate_after):
    _, jidx, tidx = pair
    body = {"query": {"match": {"title": "w2"}},
            "terminate_after": terminate_after, "size": 5}
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert_same(jr, tr)
    assert tr["terminated_early"] is (terminate_after < 1000)


def test_terminate_after_multi_segment_shards():
    """terminate_after caps per shard while a mesh slot holds one segment:
    with two segments a shard the slots' counts group by shard first."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = build_pair(True, name="srt-ta", settings={
        "index.search.mesh.max_slots_per_device": 8})
    try:
        for idx in (jidx, tidx):  # a second refresh: a second segment
            for d in range(100, 130):
                idx.index_doc(f"x{d}", {"title": "w2 w2 w2",
                                        "citations": d, "price": d * 1.0})
            idx.refresh()
        body = {"query": {"match": {"title": "w2"}}, "terminate_after": 4,
                "size": 5}
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        assert_same(jr, tr)
        assert tr["terminated_early"] is True
        assert tr["_plane"] != "host"
    finally:
        jidx.close()
        tidx.close()
        mp.undo()


def test_mesh_decisions_equal_jax(pair):
    """Single-field f32-exact and keyword sorts serve on the mesh; dates
    over a year, multi-field sorts, custom string missing and collapse
    take the host rung with the JAX package's reasons."""
    mode, jidx, tidx = pair
    if mode != "mesh":
        pytest.skip("mesh decisions only")
    ms = tidx._mesh_plane()
    cases = [
        ([{"citations": "desc"}], None),
        ([{"venue": "asc"}], None),
        (["_doc"], None),
        ([{"price": {"order": "asc", "missing": 1.5}}], None),
        ([{"ts": "desc"}], "host.sort_ineligible"),
        ([{"venue": "asc"}, {"citations": "desc"}], "host.sort_ineligible"),
        ([{"venue": {"order": "asc", "missing": "abc"}}],
         "host.sort_ineligible"),
        ([{"price": {"order": "asc", "missing": 0.1}}],
         "host.sort_ineligible"),
    ]
    for sort, reason in cases:
        before = dict(ms.decisions)
        body = {"query": {"match_all": {}}, "sort": sort, "size": 3}
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        assert tr["_plane"] == jr["_plane"]
        assert (tr["_plane"] == "host") == (reason is not None), sort
        if reason is not None:
            assert ms.decisions.get(reason, 0) == before.get(reason, 0) + 1
    before = ms.decisions.get("host.unsupported_body", 0)
    body = {"query": {"match": {"title": "w1"}}, "size": 4,
            "collapse": {"field": "venue"}}
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert tr["_plane"] == jr["_plane"] == "host"
    assert ms.decisions["host.unsupported_body"] == before + 1
    before = ms.decisions.get("host.feature_ineligible", 0)
    body = {"query": {"match_all": {}}, "sort": [{"price": "desc"}],
            "search_after": [0.1], "size": 4}
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert_same(jr, tr)
    assert tr["_plane"] == "host"
    assert ms.decisions["host.feature_ineligible"] == before + 1


def test_sort_columns_in_the_ledger(pair):
    """A mesh sort stages its key and raw columns under ``doc_values``, a
    slice its mask under ``mesh_slot_tables``; a tombstone drops both and
    the next request restages them."""
    mode, jidx, tidx = pair
    if mode != "mesh":
        pytest.skip("mesh staging only")
    from elasticsearch_tpu_torch.common.memory import memory_accountant

    tidx.search({"query": {"match_all": {}}, "sort": [{"price": "desc"}]})
    tidx.search({"query": {"match_all": {}}, "slice": {"id": 0, "max": 2}})
    ex = tidx._mesh_search._executor
    names = [k for k in ex._seg_staged if k.startswith(("msort.", "mslice."))]
    assert any(n.startswith("msort.price.desc") for n in names)
    assert any(n.startswith("mslice.2.0.3") for n in names)
    tables = {(kind, table) for (_i, scope, kind, table)
              in memory_accountant()._entries if scope == ex.scope}
    assert ("doc_values", "msort.price.desc._last") in tables
    assert ("mesh_slot_tables", "mslice.2.0.3") in tables


def keyword_delta_pair():
    common = {"index.number_of_shards": 2, "index.refresh_interval": -1,
              "index.search.mesh.max_slots_per_device": 8}
    tidx = IndexService("srt-delta", Settings(common), mapping=MAPPING,
                        device="cpu")
    ref = IndexService("srt-delta-h", Settings(
        {**common, "index.search.mesh": False}), mapping=MAPPING,
        device="cpu")
    jidx = JIndex("srt-delta-j", JSettings({
        **common, "search.aggs.fused": False,
        "index.requests.cache.enable": False}), mapping=MAPPING)
    jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    return jidx, tidx, ref


def test_keyword_sort_after_delta_append_ranks_by_new_vocabulary():
    """A refresh that appends a segment drops the staged sort columns: the
    keyword sort after it ranks by the union vocabulary that includes the
    new segment's terms (a stale one would rank them all missing)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx, ref = keyword_delta_pair()
    try:
        for idx in (jidx, tidx, ref):
            for doc_id, src in seeded_docs(60, seed=4):
                idx.index_doc(doc_id, src)
            idx.refresh()
        body = {"query": {"match_all": {}}, "sort": [{"venue": "asc"}],
                "size": 20}
        first = tidx.search(dict(body))
        assert first["_plane"] == "mesh"
        ms = tidx._mesh_search
        appends = ms.delta_restage_total
        for idx in (jidx, tidx, ref):
            for d, venue in enumerate(("a0", "a1", "zz", "v03b")):
                idx.index_doc(f"n{d}", {"title": "w1", "venue": venue,
                                        "uid": f"n{d}"})
            idx.refresh()
        for b in (body, {**body, "sort": [{"venue": "desc"}]},
                  {**body, "search_after": ["a1"]}):
            tr, hr, jr = (tidx.search(dict(b)), ref.search(dict(b)),
                          jidx.search(dict(b)))
            assert tr["_plane"] == "mesh"
            assert ms.delta_restage_total == appends + 1
            for other in (hr, jr):
                assert ([h["_id"] for h in tr["hits"]["hits"]]
                        == [h["_id"] for h in other["hits"]["hits"]])
                assert ([h["sort"] for h in tr["hits"]["hits"]]
                        == [h["sort"] for h in other["hits"]["hits"]])
        top = tidx.search(dict(body))["hits"]["hits"]
        assert [h["sort"] for h in top[:2]] == [["a0"], ["a1"]]
        # a tombstone drops the staged sort columns; the next sorted
        # request restages them and still answers like the host rung
        tombstones = ms.tombstone_update_total
        for idx in (jidx, tidx, ref):
            idx.delete_doc("n0")
            idx.refresh()
        tidx.search({"query": {"match_all": {}}, "size": 1})
        assert ms.tombstone_update_total == tombstones + 1
        assert not [k for k in ms._executor._seg_staged
                    if k.startswith("msort.")]
        tr, hr = tidx.search(dict(body)), ref.search(dict(body))
        assert tr["_plane"] == "mesh"
        assert ([(h["_id"], h["sort"]) for h in tr["hits"]["hits"]]
                == [(h["_id"], h["sort"]) for h in hr["hits"]["hits"]])
        assert tr["hits"]["hits"][0]["sort"] == ["a1"]
    finally:
        for idx in (jidx, tidx, ref):
            idx.close()
        mp.undo()


def test_sorted_body_never_takes_the_pruned_shortcut():
    """With block-max pruning on, a plain match is served pruned (a gte
    total), but a body carrying a sort, search_after, slice, rescore or
    terminate_after runs the exhaustive program: exact totals."""
    assert not (IndexMeshSearch.BATCHABLE_KEYS & {
        "sort", "search_after", "slice", "rescore", "terminate_after",
        "collapse", "highlight"})
    common = {"index.number_of_shards": 2, "index.refresh_interval": -1,
              "search.pallas.pruning.enabled": True,
              "search.pallas.pruning.probe_tiles": 2}
    tidx = IndexService("srt-prune", Settings(common), mapping=MAPPING,
                        device="cpu")
    try:
        # enough tiles a shard for the probe pass (2 x probe_tiles)
        for doc_id, src in seeded_docs(1200):
            tidx.index_doc(doc_id, src)
        tidx.refresh()
        q = {"match": {"title": "w1 w2"}}
        plain = tidx.search({"query": q, "size": 3})
        assert plain.get("_pruned") is not None
        exact = tidx.search({"query": q, "size": 3, "min_score": 0.0})[
            "hits"]["total"]
        for extra in ({"sort": [{"price": "desc"}]},
                      {"search_after": [100.0]},
                      {"slice": {"id": 0, "max": 2}},
                      {"terminate_after": 10 ** 6},
                      {"rescore": {"window_size": 5, "query": {
                          "rescore_query": {"match": {"title": "w3"}}}}}):
            r = tidx.search({"query": q, "size": 3, **extra})
            assert "_pruned" not in r, extra
            assert r["_plane"] != "host", extra
            if "slice" not in extra:
                assert r["hits"]["total"] == exact, extra
    finally:
        tidx.close()


@pytest.mark.parametrize("seed", [7, 23])
def test_keyword_sort_merges_by_string_across_shards(seed):
    """Per-segment ordinals are never merge keys: a keyword sort over
    three shards comes back in string order, and its search_after walk
    loses and repeats nothing (tests/test_property_random.py)."""
    rng = np.random.RandomState(seed)
    tags = ["red", "green", "blue", "black", "white"]
    tidx = IndexService(f"kws{seed}", Settings({
        "index.number_of_shards": 3, "index.refresh_interval": -1}),
        mapping={"properties": {"tag": {"type": "keyword"},
                                "uid": {"type": "keyword"},
                                "n": {"type": "integer"}}}, device="cpu")
    try:
        for i in range(80):
            doc = {"tag": str(rng.choice(tags)), "uid": f"{i:04d}"}
            if rng.random() < 0.85:
                doc["n"] = int(rng.randint(0, 100))
            tidx.index_doc(str(i), doc)
        tidx.refresh()
        r = tidx.search({"query": {"match_all": {}},
                         "sort": [{"tag": "asc"}, {"uid": "asc"}],
                         "size": 80})
        got = [h["_source"]["tag"] for h in r["hits"]["hits"]]
        assert got == sorted(got)
        assert [h["sort"][0] for h in r["hits"]["hits"]] == got
        for sort in ([{"tag": "asc"}, {"uid": "asc"}],
                     [{"n": {"order": "asc", "missing": "_last"}},
                      {"uid": "asc"}]):
            seen, _ = walk_search_after(
                tidx, {"query": {"match_all": {}}, "sort": sort}, 9)
            ids = [i for i, _ in seen]
            assert len(ids) == len(set(ids)) == 80
    finally:
        tidx.close()


def test_geo_and_nested_sorts_raise():
    from elasticsearch_tpu_torch.common.errors import ParsingException
    from elasticsearch_tpu_torch.search.service import normalize_sort

    from elasticsearch_tpu.search.service import normalize_sort as jnormalize

    # a _geo_distance sort is ported: its spec rides in the missing slot,
    # as in the JAX package
    for spec in ({"loc": [0, 0]},
                 {"loc": [{"lat": 1, "lon": 2}, "3,4"], "order": "desc",
                  "unit": "km", "mode": "avg", "distance_type": "arc"}):
        assert normalize_sort([{"_geo_distance": dict(spec)}]) == \
            jnormalize([{"_geo_distance": dict(spec)}])
    # a nested sort is ported: its path is implied by the field's
    for entry in ({"a.b": {"order": "asc", "nested_path": "a"}},
                  {"a.b": {"order": "desc", "nested": {"path": "a"}}}):
        assert normalize_sort([entry]) == jnormalize([entry])
    # a malformed geo sort still raises
    with pytest.raises(ParsingException, match="exactly one field"):
        normalize_sort([{"a": "asc"}, {"_geo_distance": {}}])
    assert normalize_sort("_score") is None
    assert normalize_sort([{"x": "desc"}]) == [("x", "desc", None)]


@pytest.mark.parametrize("ids", [
    [str(i) for i in range(300)],
    [f"d{i}" for i in range(300)],
    ["AAAA", "x-y_z", "_-", "héllo wörld", "ab" * 33, "q", "QUJD", "0",
     "007", "s0p123", "-1", "w" * 7],
])
def test_slice_hash_equals_jax(ids):
    """The vectorized slice hash equals the JAX package's per id."""
    from elasticsearch_tpu.utils.murmur3 import hash_slice_id as jhash
    from elasticsearch_tpu_torch.utils.murmur3 import (
        hash_slice_id,
        hash_slice_ids,
    )

    want = [jhash(i) for i in ids]
    assert [hash_slice_id(i) for i in ids] == want
    assert hash_slice_ids(ids).tolist() == want


@pytest.mark.parametrize("seed", range(6))
def test_top_k_on_ties_equals_a_stable_two_key_sort(seed):
    """The mesh plane's top-k over a sort key column full of ties: the k
    largest by value, ties to the lower index (lax.top_k's order), -0.0
    tied with +0.0, NaN last as -inf, rows batched."""
    import torch

    from elasticsearch_tpu_torch.ops.scoring import top_k

    rng = np.random.RandomState(seed)
    levels = np.array([0.0, -0.0, 1.0, 7.0, -3e38, 3e38, -np.inf, np.inf,
                       np.nan, 2.5], np.float32)
    rows = rng.choice(levels[: 3 + seed], size=(3, 700)).astype(np.float32)
    rows[:, ::7] = rng.randn(3, 100).astype(np.float32)
    for k in (1, 10, 100, 700, 900):
        vals, idx = top_k(torch.from_numpy(rows), k)
        for r in range(3):
            key = np.where(np.isnan(rows[r]), -np.inf, rows[r]) + 0.0
            order = np.lexsort((np.arange(700), -key))[: min(k, 700)]
            assert idx[r].tolist() == order.tolist()
            assert np.array_equal(vals[r].numpy(), np.where(
                np.isnan(rows[r]), -np.inf, rows[r])[order])
