"""Parity of index sorting and its early termination with the JAX package.

Mirrors tests/test_index_sort.py (19 cases): the ``index.sort.*``
validation errors, the sealed doc order (desc, a secondary key, missing
values, keywords), get / update / delete through the seal's remap, a
force merge, and the early-termination contract (``terminated_early``
with an exact total; not for a mismatched order, missing placement or a
multi-valued keyword under ``desc``). Each case runs on a JAX
``IndexService`` and a port ``IndexService(device="cpu")`` over the same
documents: doc order, ids, sort values, totals and ``terminated_early``
exact.

Added: seeded documents (multi-valued numbers and keywords, missing
values, dates) under several sort specs against the JAX package, the
mesh plane declining a sorted index (``index_sorted``) as the JAX mesh
does, and ``chip_smoke.index_sorted_fields`` (the route ``chip_smoke.py``
builds logs-sorted by: a sealed segment's arrays permuted by the port's
``index_sort_permutation``) against ``SegmentBuilder(index_sort=...)
.seal`` on a small corpus: every array equal and the same hits and
aggregations.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    IllegalArgumentException as JIAE,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index import index_sort as isort
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.mapper.mapping import MapperService

RTOL = 1e-5

MAPPING = {"properties": {
    "rank": {"type": "long"},
    "name": {"type": "keyword"},
    "body": {"type": "text"},
}}


class Pair:
    """A JAX and a port index over the same settings; every write goes
    to both."""

    def __init__(self, sort_settings, mapping=None, shards=1, mesh=False):
        base = {"index.number_of_shards": shards,
                "index.refresh_interval": -1}
        if not mesh:
            base["index.search.mesh"] = False
        base.update(sort_settings)
        mapping = mapping or MAPPING
        self.j = JIndex("sorted", JSettings({
            **base, "search.aggs.fused": False,
            "index.requests.cache.enable": False}), mapping=mapping)
        if mesh:
            self.j._mesh_search = JMesh(self.j, mesh=shard_mesh(1))
        self.t = IndexService("sorted", Settings(base), mapping=mapping,
                              device="cpu")

    def index(self, doc_id, src):
        self.j.index_doc(doc_id, src)
        self.t.index_doc(doc_id, src)

    def delete(self, doc_id):
        self.j.delete_doc(doc_id)
        self.t.delete_doc(doc_id)

    def refresh(self):
        self.j.refresh()
        self.t.refresh()

    def doc_order(self, shard=0):
        jo = [seg.doc_ids for seg in self.j.shards[shard].engine.segments]
        to = [list(seg.doc_ids)
              for seg in self.t.shards[shard].engine.segments]
        assert jo == to
        return to

    def search(self, body):
        jr, tr = self.j.search(dict(body)), self.t.search(dict(body))
        assert_same(jr, tr)
        return tr

    def close(self):
        self.j.close()
        self.t.close()


def assert_same(jr, tr):
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert tr.get("terminated_early") == jr.get("terminated_early")
    assert [h["_id"] for h in tr["hits"]["hits"]] == \
        [h["_id"] for h in jr["hits"]["hits"]]
    assert [h.get("sort") for h in tr["hits"]["hits"]] == \
        [h.get("sort") for h in jr["hits"]["hits"]]
    for a, b in zip(jr["hits"]["hits"], tr["hits"]["hits"]):
        if a["_score"] is None:
            assert b["_score"] is None
        else:
            np.testing.assert_allclose(b["_score"], a["_score"], rtol=RTOL)


def both_raise(sort_settings, match, mapping=None):
    base = {"index.number_of_shards": 1}
    base.update(sort_settings)
    with pytest.raises(JIAE, match=match) as je:
        JIndex("bad", JSettings(base), mapping=mapping or MAPPING)
    with pytest.raises(IllegalArgumentException, match=match) as te:
        IndexService("bad", Settings(base), mapping=mapping or MAPPING,
                     device="cpu")
    assert str(te.value) == str(je.value)


@pytest.fixture()
def pairs():
    made = []

    def make(sort_settings, **kw):
        p = Pair(sort_settings, **kw)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


class TestValidation:
    def test_unknown_field_rejected(self):
        both_raise({"index.sort.field": ["nope"]}, "unknown index sort field")

    def test_text_field_rejected(self):
        both_raise({"index.sort.field": ["body"]}, "invalid index sort field")

    def test_nested_field_rejected(self):
        both_raise({"index.sort.field": ["user.age"]}, "nested",
                   mapping={"properties": {"user": {
                       "type": "nested",
                       "properties": {"age": {"type": "long"}}}}})

    def test_bad_order_rejected(self):
        both_raise({"index.sort.field": ["rank"],
                    "index.sort.order": ["sideways"]}, "Illegal sort order")

    def test_bad_missing_rejected(self):
        both_raise({"index.sort.field": ["rank"],
                    "index.sort.missing": ["zero"]}, "Illegal missing value")

    def test_option_lists_must_match_the_fields(self):
        both_raise({"index.sort.field": ["rank", "name"],
                    "index.sort.order": ["desc"]}, "must match")


class TestSortedSegments:
    def test_docs_stored_in_sort_order(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        for doc_id, rank in [("a", 30), ("b", 10), ("c", 20)]:
            p.index(doc_id, {"rank": rank, "name": doc_id})
        p.refresh()
        assert p.doc_order() == [["b", "c", "a"]]

    def test_desc_and_secondary_key(self, pairs):
        p = pairs({"index.sort.field": ["rank", "name"],
                   "index.sort.order": ["desc", "asc"]})
        for doc_id, rank in [("x", 1), ("y", 2), ("z", 2)]:
            p.index(doc_id, {"rank": rank, "name": doc_id})
        p.refresh()
        assert p.doc_order() == [["y", "z", "x"]]

    def test_keyword_sort_with_missing_last(self, pairs):
        p = pairs({"index.sort.field": ["name"]})
        p.index("1", {"name": "beta", "rank": 1})
        p.index("2", {"rank": 2})  # missing name -> last
        p.index("3", {"name": "alpha", "rank": 3})
        p.refresh()
        assert p.doc_order() == [["3", "1", "2"]]

    def test_get_update_delete_survive_permutation(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        p.index("a", {"rank": 5, "name": "first"})
        p.index("b", {"rank": 1, "name": "second"})
        p.index("c", {"rank": 3, "name": "third"})
        p.delete("c")
        p.refresh()
        for idx in (p.j, p.t):
            g = idx.get_doc("a")
            assert g.found and g.source["name"] == "first"
            assert idx.get_doc("c").found is False
        assert p.search({"query": {"match_all": {}}})["hits"]["total"] == 2
        p.index("a", {"rank": 5, "name": "updated"})
        p.refresh()
        for idx in (p.j, p.t):
            assert idx.get_doc("a").source["name"] == "updated"
        assert p.search({"query": {"match_all": {}}})["hits"]["total"] == 2

    def test_force_merge_keeps_sort(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        p.index("a", {"rank": 9})
        p.refresh()
        p.index("b", {"rank": 2})
        p.refresh()
        p.j.shards[0].engine.force_merge()
        p.t.shards[0].engine.force_merge()
        assert p.doc_order() == [["b", "a"]]
        assert p.j.get_doc("a").found and p.t.get_doc("a").found


class TestEarlyTermination:
    def test_sorted_query_terminates_early(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        for i in range(20):
            p.index(str(i), {"rank": (i * 7) % 20, "name": f"n{i}"})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 5,
                      "sort": [{"rank": "asc"}]})
        assert [h["sort"][0] for h in r["hits"]["hits"]] == [0, 1, 2, 3, 4]
        assert r["hits"]["total"] == 20
        assert r.get("terminated_early") is True

    def test_prefix_of_index_sort_qualifies(self, pairs):
        p = pairs({"index.sort.field": ["rank", "name"],
                   "index.sort.order": ["desc", "asc"]})
        for i in range(10):
            p.index(str(i), {"rank": i, "name": f"n{i}"})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 3,
                      "sort": [{"rank": "desc"}]})
        assert [h["sort"][0] for h in r["hits"]["hits"]] == [9, 8, 7]
        assert r.get("terminated_early") is True

    def test_mismatched_sort_not_early_terminated(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        for i in range(10):
            p.index(str(i), {"rank": i, "name": f"n{i}"})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 3,
                      "sort": [{"rank": "desc"}]})
        assert [h["sort"][0] for h in r["hits"]["hits"]] == [9, 8, 7]
        assert r.get("terminated_early") is None

    def test_small_result_not_marked_terminated(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        p.index("1", {"rank": 1})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 10,
                      "sort": [{"rank": "asc"}]})
        assert r.get("terminated_early") is None

    def test_doc_values_disabled_rejected(self):
        both_raise({"index.sort.field": ["rank"]}, "docvalues not found",
                   mapping={"properties": {
                       "rank": {"type": "long", "doc_values": False}}})

    def test_missing_mismatch_not_early_terminated(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        p.index("a", {"rank": 10})
        p.index("b", {"name": "no-rank"})
        p.index("c", {"rank": 20})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 2,
                      "sort": [{"rank": {"order": "asc",
                                         "missing": "_first"}}]})
        assert [h["_id"] for h in r["hits"]["hits"]] == ["b", "a"]
        assert r.get("terminated_early") is None

    def test_keyword_desc_multivalue_not_early_terminated(self, pairs):
        p = pairs({"index.sort.field": ["name"],
                   "index.sort.order": ["desc"]})
        p.index("d1", {"name": ["a", "z"]})
        p.index("d2", {"name": "m"})
        p.index("d3", {"name": "b"})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 2,
                      "sort": [{"name": "desc"}]})
        assert r.get("terminated_early") is None

    def test_keyword_asc_multivalue_uses_min_value(self, pairs):
        p = pairs({"index.sort.field": ["name"]})
        p.index("d1", {"name": ["z", "a"]})
        p.index("d2", {"name": "b"})
        p.index("d3", {"name": "c"})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 2,
                      "sort": [{"name": "asc"}]})
        assert [h["_id"] for h in r["hits"]["hits"]] == ["d1", "d2"]
        assert r.get("terminated_early") is True

    def test_multi_segment_results_merge_correctly(self, pairs):
        p = pairs({"index.sort.field": ["rank"]})
        for i, rank in enumerate([5, 3, 9]):
            p.index(f"a{i}", {"rank": rank})
        p.refresh()
        for i, rank in enumerate([4, 1, 8]):
            p.index(f"b{i}", {"rank": rank})
        p.refresh()
        r = p.search({"query": {"match_all": {}}, "size": 4,
                      "sort": [{"rank": "asc"}]})
        assert [h["sort"][0] for h in r["hits"]["hits"]] == [1, 3, 4, 5]


# ---------------------------------------------------------------------------
# Seeded documents, the mesh plane, and sorting a sealed segment
# ---------------------------------------------------------------------------

SEEDED_MAPPING = {"properties": {
    "rank": {"type": "long"},
    "score": {"type": "double"},
    "name": {"type": "keyword"},
    "ts": {"type": "date"},
    "body": {"type": "text"},
    "loc": {"type": "geo_point"},
}}


def seeded_docs(n, seed):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(12)]
    docs = []
    for i in range(n):
        src = {"body": " ".join(rng.choice(words, rng.randint(1, 8)))}
        if rng.rand() < 0.85:
            k = rng.randint(1, 3)
            vals = [int(v) for v in rng.randint(0, 30, k)]
            src["rank"] = vals if k > 1 else vals[0]
        if rng.rand() < 0.8:
            src["score"] = float(np.round(rng.randn() * 10, 2))
        if rng.rand() < 0.8:
            k = rng.randint(1, 3)
            vals = [str(v) for v in rng.choice(list("abcdefgh"), k)]
            src["name"] = vals if k > 1 else vals[0]
        if rng.rand() < 0.9:
            src["ts"] = int(1_600_000_000_000 + rng.randint(0, 50) * 60_000)
        if rng.rand() < 0.5:
            src["loc"] = {"lat": float(rng.uniform(-60, 60)),
                          "lon": float(rng.uniform(-170, 170))}
        docs.append((f"d{i}", src))
    return docs


SPECS = [
    {"index.sort.field": ["ts"], "index.sort.order": ["desc"]},
    {"index.sort.field": ["rank", "name"],
     "index.sort.order": ["asc", "desc"],
     "index.sort.missing": ["_first", "_last"]},
    {"index.sort.field": ["name", "score"],
     "index.sort.mode": ["max", "min"]},
]


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_seeded_docs_sort_and_terminate_like_jax(pairs, spec):
    p = pairs(SPECS[spec], mapping=SEEDED_MAPPING, shards=2)
    docs = seeded_docs(160, seed=spec)
    for doc_id, src in docs[:100]:
        p.index(doc_id, src)
    p.refresh()
    for doc_id, src in docs[100:]:
        p.index(doc_id, src)
    p.delete("d7")
    p.refresh()
    p.doc_order(0)
    p.doc_order(1)
    first = SPECS[spec]["index.sort.field"][0]
    order = (SPECS[spec].get("index.sort.order") or ["asc"])[0]
    missing = (SPECS[spec].get("index.sort.missing") or ["_last"])[0]
    for body in (
            {"query": {"match_all": {}}, "size": 7,
             "sort": [{first: {"order": order, "missing": missing}}]},
            {"query": {"match": {"body": "w1 w2"}}, "size": 5,
             "sort": [{first: {"order": order, "missing": missing}}]},
            {"query": {"match": {"body": "w3"}}, "size": 6},
            {"query": {"range": {"rank": {"gte": 10}}}, "size": 4,
             "sort": [{first: order}]}):
        p.search(body)


def test_the_mesh_plane_declines_a_sorted_index(pairs, monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    p = pairs({"index.sort.field": ["ts"], "index.sort.order": ["desc"]},
              mapping=SEEDED_MAPPING, shards=2, mesh=True)
    for doc_id, src in seeded_docs(80, seed=5):
        p.index(doc_id, src)
    p.refresh()
    r = p.search({"query": {"match": {"body": "w1"}}, "size": 5,
                  "sort": [{"ts": "desc"}]})
    assert r["_plane"] == "host" and r.get("terminated_early") is True
    r = p.search({"query": {"match": {"body": "w1"}}, "size": 5})
    assert r["_plane"] == "host"
    decisions = p.t.search_stats()["planes"]["decisions"]
    assert decisions.get("host.index_sorted", 0) >= 2


# phase 12's doc-values form without its geo field: the fields
# chip_smoke.index_sorted_fields permutes
DV_MAPPING = {"properties": {
    f: t for f, t in SEEDED_MAPPING["properties"].items() if f != "loc"}}


@functools.lru_cache(maxsize=None)
def chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dv_docs(n, seed):
    return [(d, {k: v for k, v in src.items() if k != "loc"})
            for d, src in seeded_docs(n, seed)]


def _sealed(docs, spec=None, mapping=DV_MAPPING):
    ms = MapperService(AnalysisRegistry(), mapping)
    b = SegmentBuilder("s", device="cpu", index_sort=spec)
    for i, (doc_id, src) in enumerate(docs):
        b.add_document(ms.parse_document(doc_id, src), i, 1)
    return b.seal()


def _route(seg, sort_spec):
    """chip_smoke.py's logs-sorted route: a sealed segment's arrays (its
    positions left out: phase 12's segments hold none) permuted by
    ``index_sorted_fields`` into a new segment."""
    import torch

    from elasticsearch_tpu_torch.index.segment import Segment

    cs = chip_smoke()
    fields = dict(cs._segment_fields(seg), positions=None)
    return Segment.from_arrays("sorted", device="cpu",
                               **cs.index_sorted_fields(
                                   torch, isort, fields, sort_spec, "cpu"))


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_index_sorted_fields_equal_sorting_at_seal(spec):
    from elasticsearch_tpu_torch.common.settings import Settings as S

    docs = dv_docs(150, seed=30 + spec)
    ms = MapperService(AnalysisRegistry(), DV_MAPPING)
    sort_spec = isort.parse_index_sort(S(SPECS[spec]), ms)
    want = _sealed(docs, sort_spec)
    got = _route(_sealed(docs), sort_spec)
    assert list(got.doc_ids) == list(want.doc_ids)
    assert list(got.sources) == list(want.sources)
    for name in ("seqnos", "versions", "block_docs", "block_tfs", "norms",
                 "term_block_start", "term_block_count", "term_doc_freq",
                 "live"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for cols in ("numeric_columns", "ordinal_columns"):
        g, w = getattr(got, cols), getattr(want, cols)
        assert sorted(g) == sorted(w)
        for f in w:
            for k, v in vars(w[f]).items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(
                        vars(g[f])[k], v, err_msg=f"{cols}.{f}.{k}")
                else:
                    assert vars(g[f])[k] == v, (cols, f, k)
    for f, m in want.exists_masks.items():
        np.testing.assert_array_equal(got.exists_masks[f], m, err_msg=f)
    # and the permuted segment answers as the sealed one on a sorted index
    sort_settings = {"index.number_of_shards": 1,
                     "index.refresh_interval": -1, **SPECS[spec]}
    a = IndexService("adopt", Settings(sort_settings),
                     mapping=DV_MAPPING, device="cpu")
    b = IndexService("seal", Settings(sort_settings),
                     mapping=DV_MAPPING, device="cpu")
    try:
        a.shards[0].engine.adopt_segment(_route(_sealed(docs), sort_spec))
        for doc_id, src in docs:
            b.index_doc(doc_id, src)
        b.refresh()
        assert list(a.shards[0].engine.segments[0].doc_ids) == \
            list(b.shards[0].engine.segments[0].doc_ids)
        first = SPECS[spec]["index.sort.field"][0]
        order = (SPECS[spec].get("index.sort.order") or ["asc"])[0]
        for body in ({"query": {"match": {"body": "w4 w5"}}, "size": 9,
                      "sort": [{first: order}]},
                     {"query": {"match": {"body": "w2"}}, "size": 5},
                     {"query": {"match_all": {}}, "size": 0, "aggs": {
                         "n": {"terms": {"field": "name"}},
                         "r": {"stats": {"field": "rank"}}}}):
            ra, rb = a.search(dict(body)), b.search(dict(body))
            assert ra["hits"]["total"] == rb["hits"]["total"]
            assert ra.get("terminated_early") == rb.get("terminated_early")
            assert [(h["_id"], h.get("sort")) for h in ra["hits"]["hits"]] \
                == [(h["_id"], h.get("sort")) for h in rb["hits"]["hits"]]
            assert ra.get("aggregations") == rb.get("aggregations")
        # a get and a delete hit the right doc after the permutation
        assert a.get_doc("d3").source == dict(docs)["d3"]
        a.delete_doc("d3")
        a.refresh()
        assert a.search({"query": {"ids": {"values": ["d3"]}}})[
            "hits"]["total"] == 0
    finally:
        a.close()
        b.close()


def test_index_sorted_fields_leave_the_arrays_as_they_were():
    """The same sealed segment's arrays serve an unsorted index and the
    sorted one (logs-a and logs-sorted in a chip run): the permutation
    copies what it changes; fields it cannot permute are refused."""
    import torch

    from elasticsearch_tpu_torch.common.settings import Settings as S

    docs = dv_docs(80, seed=60)
    seg = _sealed(docs)
    before = {k: getattr(seg, k).copy() for k in
              ("block_docs", "block_tfs", "norms", "live")}
    cols = {f: {k: v.copy() for k, v in vars(c).items()
                if isinstance(v, np.ndarray)}
            for f, c in seg.numeric_columns.items()}
    ms = MapperService(AnalysisRegistry(), DV_MAPPING)
    spec = isort.parse_index_sort(S(SPECS[0]), ms)
    out = _route(seg, spec)
    assert out is not seg
    assert list(out.doc_ids) != list(seg.doc_ids)
    for k, v in before.items():
        np.testing.assert_array_equal(getattr(seg, k), v, err_msg=k)
    for f, arrays in cols.items():
        for k, v in arrays.items():
            np.testing.assert_array_equal(
                vars(seg.numeric_columns[f])[k], v, err_msg=f"{f}.{k}")
    assert list(seg.doc_ids) == [d for d, _ in docs]
    with pytest.raises(ValueError, match="positions"):
        chip_smoke().index_sorted_fields(
            torch, isort, chip_smoke()._segment_fields(seg), spec, "cpu")
    with pytest.raises(ValueError, match="geo_columns"):
        chip_smoke().index_sorted_fields(
            torch, isort, dict(chip_smoke()._segment_fields(
                _sealed(seeded_docs(20, 61), mapping=SEEDED_MAPPING)),
                positions=None), spec, "cpu")
