"""Parity of nested documents with the JAX package.

Every case of tests/test_nested.py runs on a JAX ``IndexService`` and on
a port ``IndexService(device="cpu")`` fed the same documents: the same
request answers equally in both (``_plane``, totals, ids in order, sort
arrays, inner hits with their ``_nested`` offsets and buckets exactly,
scores within rtol 1e-5), and the JAX test's own assertions hold on the
port's answer. Errors raise the same class with the same message. Beyond
those cases: a 3-shard pair with the JAX plane on a one-device mesh
(``ES_TPU_PALLAS=interpret``), where a nested clause alone, under a
``match``, with matches in one shard only, a nested sort and the nested
aggregations take the JAX package's plane with the same decision
counters; a nested delta append on the mesh plane; and a scroll over a
nested query, whose pages are the snapshot at open. Every test closes
both index services.
"""

import glob
import os

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import ElasticsearchTpuException as JErr
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuException,
    MapperParsingException,
    SearchPhaseExecutionException,
)
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.index.segment import PinnedSegmentView
from elasticsearch_tpu_torch.index.store import MARKER_PREFIX
from elasticsearch_tpu_torch.node import Node

RTOL = 1e-5
JAX_ONLY = {"index.requests.cache.enable": False}

USERS_MAPPING = {"properties": {
    "group": {"type": "keyword"},
    "user": {"type": "nested", "properties": {
        "first": {"type": "text"},
        "last": {"type": "text", "fields": {"keyword": {"type": "keyword"}}},
        "age": {"type": "long"}}}}}
USERS_DOCS = [
    ("1", {"group": "fans", "user": [
        {"first": "John", "last": "Smith", "age": 34},
        {"first": "Alice", "last": "White", "age": 28}]}),
    ("2", {"group": "fans", "user": [
        {"first": "John", "last": "White", "age": 46}]}),
    ("3", {"group": "owners"}),
]
DEEP_MAPPING = {"properties": {"driver": {
    "type": "nested",
    "properties": {
        "last_name": {"type": "text"},
        "vehicle": {"type": "nested", "properties": {
            "make": {"type": "text"}, "model": {"type": "text"}}}}}}}
DEEP_DOCS = [
    ("1", {"driver": {"last_name": "McQueen", "vehicle": [
        {"make": "Powell", "model": "Canyonero"},
        {"make": "Miller", "model": "Meteor"}]}}),
    ("2", {"driver": {"last_name": "Hudson", "vehicle": [
        {"make": "Mifune", "model": "Mach Five"},
        {"make": "Miller", "model": "Meteor"}]}}),
]


def hit_ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


class Pair:
    """A JAX and a port index service over the same settings, mapping and
    writes."""

    def __init__(self, name, mapping, docs=(), shards=1, tmp=None,
                 settings=None, jax_mesh=False):
        common = {"index.number_of_shards": shards,
                  "index.refresh_interval": -1, **(settings or {})}
        self.args = (name, mapping, common, tmp)
        self.j = JIndex(name, JSettings({**common, **JAX_ONLY}),
                        mapping=mapping,
                        data_path=str(tmp / "j") if tmp else None)
        if jax_mesh:
            # the port serves one device: give the JAX plane a one-device
            # mesh
            self.j._mesh_search = JMesh(self.j, mesh=shard_mesh(1))
        self.t = IndexService(name, Settings(common), mapping=mapping,
                              device="cpu",
                              data_path=str(tmp / "t") if tmp else None)
        for doc_id, src in docs:
            self.index(doc_id, src)
        self.refresh()

    def index(self, doc_id, src, **kw):
        self.j.index_doc(doc_id, src, **kw)
        self.t.index_doc(doc_id, src, **kw)

    def refresh(self):
        self.j.refresh()
        self.t.refresh()

    def search(self, body):
        jr = self.j.search(dict(body))
        tr = self.t.search(dict(body))
        same_response(jr, tr)
        return tr

    def errors(self, body):
        """Both raise: the same class name, status and message."""
        with pytest.raises(JErr) as je:
            self.j.search(dict(body))
        with pytest.raises(ElasticsearchTpuException) as te:
            self.t.search(dict(body))
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)
        assert te.value.status_code == je.value.status_code
        return te.value

    def close(self):
        self.j.close()
        self.t.close()


def same_value(a, b, path=""):
    """Equal structure; ``_score`` / ``max_score`` within rtol, the rest
    exact."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            if k in ("_score", "max_score") and a[k] is not None:
                assert b[k] is not None, path + k
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL,
                                           err_msg=path + k)
            else:
                same_value(a[k], b[k], f"{path}{k}.")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for x, y in zip(a, b):
            same_value(x, y, path)
    else:
        assert a == b, (path, a, b)


def same_response(jr, tr):
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert tr["_shards"] == jr["_shards"]
    same_value({"hits": jr["hits"]["hits"],
                "max_score": jr["hits"]["max_score"],
                "aggregations": jr.get("aggregations")},
               {"hits": tr["hits"]["hits"],
                "max_score": tr["hits"]["max_score"],
                "aggregations": tr.get("aggregations")})


@pytest.fixture()
def users(tmp_path):
    p = Pair("users", USERS_MAPPING, USERS_DOCS, tmp=tmp_path)
    yield p
    p.close()


@pytest.fixture()
def deep(tmp_path):
    p = Pair("deep", DEEP_MAPPING, DEEP_DOCS, tmp=tmp_path)
    yield p
    p.close()


JOHN_WHITE = {"query": {"nested": {"path": "user", "query": {"bool": {
    "must": [{"match": {"user.first": "john"}},
             {"match": {"user.last": "white"}}]}}}}}


class TestNestedQuery:
    def test_no_cross_object_leakage(self, users):
        assert hit_ids(users.search(JOHN_WHITE)) == ["2"]

    def test_same_object_match(self, users):
        q = {"query": {"nested": {"path": "user", "query": {"bool": {
            "must": [{"match": {"user.first": "john"}},
                     {"match": {"user.last": "smith"}}]}}}}}
        assert hit_ids(users.search(q)) == ["1"]

    def test_single_clause_matches_any_object(self, users):
        q = {"query": {"nested": {"path": "user",
                                  "query": {"match": {"user.first": "john"}}}}}
        assert hit_ids(users.search(q)) == ["1", "2"]

    def test_range_on_nested_numeric(self, users):
        q = {"query": {"nested": {"path": "user", "query": {
            "range": {"user.age": {"gte": 40}}}}}}
        assert hit_ids(users.search(q)) == ["2"]

    def test_score_modes(self, users):
        base = {"path": "user", "query": {"match": {"user.first": "john"}}}
        scores = {}
        for mode in ("avg", "sum", "min", "max", "none"):
            resp = users.search(
                {"query": {"nested": dict(base, score_mode=mode)}})
            scores[mode] = {h["_id"]: h["_score"]
                            for h in resp["hits"]["hits"]}
        assert scores["avg"]["1"] == pytest.approx(scores["sum"]["1"])
        assert scores["min"]["2"] == pytest.approx(scores["max"]["2"])
        assert scores["none"]["1"] == 0.0

    def test_sum_vs_max_multi_object(self, tmp_path):
        p = Pair("m", {"properties": {"c": {
            "type": "nested", "properties": {"t": {"type": "text"}}}}},
            [("x", {"c": [{"t": "apple"}, {"t": "apple"}]})], tmp=tmp_path)
        try:
            def q(m):
                return {"query": {"nested": {
                    "path": "c", "query": {"match": {"c.t": "apple"}},
                    "score_mode": m}}}
            s_sum = p.search(q("sum"))["hits"]["hits"][0]["_score"]
            s_max = p.search(q("max"))["hits"]["hits"][0]["_score"]
            s_avg = p.search(q("avg"))["hits"]["hits"][0]["_score"]
            assert s_sum == pytest.approx(2 * s_max)
            assert s_avg == pytest.approx(s_max)
        finally:
            p.close()

    def test_unmapped_path_raises(self, users):
        users.errors({"query": {"nested": {
            "path": "nope", "query": {"match_all": {}}}}})

    def test_ignore_unmapped(self, users):
        resp = users.search({"query": {"nested": {
            "path": "nope", "query": {"match_all": {}},
            "ignore_unmapped": True}}})
        assert resp["hits"]["total"] == 0

    def test_nested_fields_not_searchable_at_root(self, users):
        resp = users.search({"query": {"match": {"user.first": "john"}}})
        assert resp["hits"]["total"] == 0

    def test_in_bool_with_root_filter(self, users):
        q = {"query": {"bool": {
            "must": [{"nested": {"path": "user", "query": {
                "match": {"user.first": "john"}}}}],
            "filter": [{"term": {"group": "fans"}}]}}}
        assert hit_ids(users.search(q)) == ["1", "2"]

    def test_delete_parent_removes_nested(self, users):
        users.j.delete_doc("2")
        users.t.delete_doc("2")
        users.refresh()
        assert hit_ids(users.search(JOHN_WHITE)) == []
        # every object of the deleted doc is dead in the sub-segment
        seg, = users.t.shards[0].engine.segments
        nctx = seg.nested["user"]
        doc2 = seg.id_to_doc()["2"]
        objs = np.flatnonzero(nctx.parent_of == doc2)
        assert objs.size == 1 and not nctx.segment.live[objs].any()


def join_pair(tmp_path, name, mapping, docs):
    return Pair(name, mapping, docs, tmp=tmp_path)


class TestInnerHits:
    def test_nested_inner_hits(self, users):
        resp = users.search({"query": {"nested": {
            "path": "user", "query": {"match": {"user.first": "john"}},
            "inner_hits": {}}}})
        by_id = {h["_id"]: h for h in resp["hits"]["hits"]}
        ih = by_id["1"]["inner_hits"]["user"]["hits"]
        assert ih["total"] == 1
        assert ih["hits"][0]["_nested"] == {"field": "user", "offset": 0}
        assert ih["hits"][0]["_source"]["first"] == "John"

    def test_inner_hits_size_and_name(self, users):
        resp = users.search({"query": {"nested": {
            "path": "user", "query": {"match_all": {}},
            "inner_hits": {"name": "members", "size": 1}}}})
        by_id = {h["_id"]: h for h in resp["hits"]["hits"]}
        ih = by_id["1"]["inner_hits"]["members"]["hits"]
        assert ih["total"] == 2
        assert len(ih["hits"]) == 1

    def test_has_child_inner_hits(self, tmp_path):
        p = join_pair(tmp_path, "qa", {"properties": {
            "j": {"type": "join", "relations": {"q": "a"}},
            "body": {"type": "text"}}}, [
            ("q1", {"j": "q"}),
            ("a1", {"j": {"name": "a", "parent": "q1"},
                    "body": "good answer"}),
            ("a2", {"j": {"name": "a", "parent": "q1"},
                    "body": "bad reply"})])
        try:
            resp = p.search({"query": {"has_child": {
                "type": "a", "query": {"match": {"body": "answer"}},
                "inner_hits": {}}}})
            assert hit_ids(resp) == ["q1"]
            ih = resp["hits"]["hits"][0]["inner_hits"]["a"]["hits"]
            assert ih["total"] == 1
            assert ih["hits"][0]["_id"] == "a1"
        finally:
            p.close()

    def test_has_parent_inner_hits(self, tmp_path):
        p = join_pair(tmp_path, "qa2", {"properties": {
            "j": {"type": "join", "relations": {"q": "a"}},
            "title": {"type": "text"}}}, [
            ("q1", {"j": "q", "title": "trains"}),
            ("a1", {"j": {"name": "a", "parent": "q1"}})])
        try:
            resp = p.search({"query": {"has_parent": {
                "parent_type": "q", "query": {"match": {"title": "trains"}},
                "inner_hits": {}}}})
            assert hit_ids(resp) == ["a1"]
            ih = resp["hits"]["hits"][0]["inner_hits"]["q"]["hits"]
            assert ih["hits"][0]["_id"] == "q1"
        finally:
            p.close()


class TestNestedAggs:
    def test_nested_agg_counts_objects(self, users):
        resp = users.search({"size": 0, "aggs": {
            "u": {"nested": {"path": "user"},
                  "aggs": {"min_age": {"min": {"field": "user.age"}}}}}})
        agg = resp["aggregations"]["u"]
        assert agg["doc_count"] == 3
        assert agg["min_age"]["value"] == 28.0

    def test_nested_agg_respects_query(self, users):
        resp = users.search({
            "size": 0, "query": {"term": {"group": "fans"}},
            "aggs": {"u": {"nested": {"path": "user"}, "aggs": {
                "avg_age": {"avg": {"field": "user.age"}}}}}})
        agg = resp["aggregations"]["u"]
        assert agg["doc_count"] == 3
        assert agg["avg_age"]["value"] == pytest.approx((34 + 28 + 46) / 3)

    def test_reverse_nested(self, users):
        resp = users.search({"size": 0, "aggs": {"u": {
            "nested": {"path": "user"},
            "aggs": {"johns": {
                "filter": {"match": {"user.first": "john"}},
                "aggs": {"back": {
                    "reverse_nested": {},
                    "aggs": {"groups": {"terms": {"field": "group"}}}}}}}}}})
        johns = resp["aggregations"]["u"]["johns"]
        assert johns["doc_count"] == 2
        back = johns["back"]
        assert back["doc_count"] == 2
        assert {b["key"]: b["doc_count"]
                for b in back["groups"]["buckets"]} == {"fans": 2}

    def test_reverse_nested_outside_nested_fails(self, users):
        users.errors({"size": 0, "aggs": {
            "bad": {"reverse_nested": {}, "aggs": {}}}})

    def test_nested_terms_agg(self, users):
        resp = users.search({"size": 0, "aggs": {"u": {
            "nested": {"path": "user"},
            "aggs": {"lasts": {"terms": {"field": "user.last.keyword"}}}}}})
        buckets = {b["key"]: b["doc_count"]
                   for b in resp["aggregations"]["u"]["lasts"]["buckets"]}
        assert buckets == {"White": 2, "Smith": 1}


class TestNestedSort:
    def test_sort_asc_by_nested_min(self, users):
        resp = users.search({
            "query": {"nested": {"path": "user", "query": {
                "exists": {"field": "user.age"}}}},
            "sort": [{"user.age": {"order": "asc"}}]})
        assert [h["_id"] for h in resp["hits"]["hits"]] == ["1", "2"]

    def test_sort_desc_by_nested_max(self, users):
        resp = users.search({
            "query": {"nested": {"path": "user", "query": {
                "exists": {"field": "user.age"}}}},
            "sort": [{"user.age": {"order": "desc",
                                   "nested_path": "user"}}]})
        assert [h["_id"] for h in resp["hits"]["hits"]] == ["2", "1"]


P_MAPPING = {"properties": {"c": {"type": "nested", "properties": {
    "t": {"type": "text"}, "n": {"type": "long"}}}}}


class TestNestedPersistence:
    def test_flush_and_reopen(self, tmp_path):
        p = Pair("p", P_MAPPING, [
            ("1", {"c": [{"t": "alpha", "n": 1}, {"t": "beta", "n": 2}]}),
            ("2", {"c": [{"t": "alpha beta", "n": 3}]})], tmp=tmp_path)
        p.j.flush()
        p.t.flush()
        p.close()
        # each package reopens its own data path and the other's
        for j_dir, t_dir in (("j", "t"), ("t", "j")):
            j2 = JIndex("p", JSettings({"index.number_of_shards": 1,
                                        **JAX_ONLY}),
                        mapping=P_MAPPING, data_path=str(tmp_path / j_dir))
            t2 = IndexService("p", Settings({"index.number_of_shards": 1}),
                              mapping=P_MAPPING, device="cpu",
                              data_path=str(tmp_path / t_dir))
            try:
                q = {"query": {"nested": {"path": "c", "query": {"bool": {
                    "must": [{"match": {"c.t": "alpha"}},
                             {"match": {"c.t": "beta"}}]}}}}}
                jr, tr = j2.search(dict(q)), t2.search(dict(q))
                same_response(jr, tr)
                assert hit_ids(tr) == ["2"]
                body = {"size": 0, "aggs": {"cc": {
                    "nested": {"path": "c"},
                    "aggs": {"s": {"sum": {"field": "c.n"}}}}}}
                jr, tr = j2.search(dict(body)), t2.search(dict(body))
                same_response(jr, tr)
                assert tr["aggregations"]["cc"]["s"]["value"] == 6.0
            finally:
                j2.close()
                t2.close()

    def test_force_merge_preserves_nested(self, users):
        users.index("4", {"group": "fans", "user": [
            {"first": "Zoe", "last": "Smith", "age": 20}]})
        users.refresh()
        users.j.force_merge()
        users.t.force_merge()
        q = {"query": {"nested": {"path": "user", "query": {"bool": {
            "must": [{"match": {"user.first": "zoe"}},
                     {"match": {"user.last": "smith"}}]}}}}}
        assert hit_ids(users.search(q)) == ["4"]
        seg, = users.t.shards[0].engine.segments
        assert seg.nested["user"].segment.num_docs == 4


class TestNestedInNested:
    def test_query_two_levels(self, deep):
        q = {"query": {"nested": {"path": "driver", "query": {"nested": {
            "path": "driver.vehicle",
            "query": {"bool": {"must": [
                {"match": {"driver.vehicle.make": "powell"}},
                {"match": {"driver.vehicle.model": "canyonero"}}]}}}}}}}
        assert hit_ids(deep.search(q)) == ["1"]

    def test_query_inner_path_directly(self, deep):
        q = {"query": {"nested": {
            "path": "driver.vehicle",
            "query": {"match": {"driver.vehicle.make": "mifune"}}}}}
        assert hit_ids(deep.search(q)) == ["2"]

    def test_nested_agg_in_nested_agg(self, deep):
        resp = deep.search({"size": 0, "aggs": {"d": {
            "nested": {"path": "driver"},
            "aggs": {"v": {"nested": {"path": "driver.vehicle"}}}}}})
        assert resp["aggregations"]["d"]["doc_count"] == 2
        assert resp["aggregations"]["d"]["v"]["doc_count"] == 4

    def test_root_level_inner_path_agg(self, deep):
        resp = deep.search({"size": 0, "aggs": {"v": {
            "nested": {"path": "driver.vehicle"}}}})
        assert resp["aggregations"]["v"]["doc_count"] == 4


class TestNestedParsing:
    def test_null_array_element_skipped(self, tmp_path):
        p = Pair("n", {"properties": {"c": {
            "type": "nested", "properties": {"t": {"type": "text"}}}}},
            [("1", {"c": [None, {"t": "kept"}]})], tmp=tmp_path)
        try:
            assert hit_ids(p.search({"query": {"nested": {
                "path": "c", "query": {"match": {"c.t": "kept"}}}}})) == ["1"]
            resp = p.search({"size": 0, "aggs": {"cc": {
                "nested": {"path": "c"}}}})
            assert resp["aggregations"]["cc"]["doc_count"] == 1
        finally:
            p.close()

    def test_include_in_parent_no_double_count_inner(self, tmp_path):
        p = Pair("i", {"properties": {"a": {
            "type": "nested", "include_in_parent": True,
            "properties": {
                "x": {"type": "text"},
                "b": {"type": "nested",
                      "properties": {"y": {"type": "text"}}}}}}},
            [("1", {"a": [{"x": "v", "b": [{"y": "w"}]}]})], tmp=tmp_path)
        try:
            resp = p.search({"size": 0, "aggs": {"bb": {
                "nested": {"path": "a.b"}}}})
            assert resp["aggregations"]["bb"]["doc_count"] == 1
            resp = p.search({"query": {"nested": {
                "path": "a.b", "query": {"match": {"a.b.y": "w"}},
                "score_mode": "sum", "inner_hits": {}}}})
            ih = resp["hits"]["hits"][0]["inner_hits"]["a.b"]["hits"]
            assert ih["total"] == 1
            # the flattened copy reached the root, the inner docs did not
            assert hit_ids(p.search({"query": {"match": {"a.x": "v"}}})) \
                == ["1"]
        finally:
            p.close()


class TestNestedCorruptionDetection:
    def test_parent_of_corruption_detected(self, tmp_path):
        """A flipped byte in a nested sub-segment's parent_of.npy fails its
        checksum: each package quarantines the shard when it reopens
        either package's data path, and every search fails."""
        p = Pair("c", {"properties": {"c": {
            "type": "nested", "properties": {"t": {"type": "text"}}}}},
            [("1", {"c": [{"t": "alpha"}]})], tmp=tmp_path)
        p.j.flush()
        p.t.flush()
        p.close()
        for sub in ("j", "t"):
            (target,) = glob.glob(os.path.join(
                str(tmp_path / sub), "**", "parent_of.npy"), recursive=True)
            with open(target, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                byte = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([byte[0] ^ 0xFF]))
        for sub in ("j", "t"):
            reopened = IndexService(
                "c", Settings({"index.number_of_shards": 1}), device="cpu",
                data_path=str(tmp_path / sub))
            try:
                assert reopened.shards[0].store_corrupted
                assert reopened.shards[0].engine.store.corruption_markers()
                assert any(f.startswith(MARKER_PREFIX) for f in os.listdir(
                    os.path.join(str(tmp_path / sub), "0", "index")))
                with pytest.raises(SearchPhaseExecutionException):
                    reopened.search({"query": {"match_all": {}}})
            finally:
                reopened.close()


class TestIncludeInRoot:
    def test_include_in_root_copies_fields(self, tmp_path):
        p = Pair("r", {"properties": {"c": {
            "type": "nested", "include_in_root": True,
            "properties": {"t": {"type": "text"}}}}},
            [("1", {"c": [{"t": "hello"}]})], tmp=tmp_path)
        try:
            assert hit_ids(p.search({"query": {"match": {
                "c.t": "hello"}}})) == ["1"]
            assert hit_ids(p.search({"query": {"nested": {
                "path": "c", "query": {"match": {"c.t": "hello"}}}}})) \
                == ["1"]
        finally:
            p.close()


# ---------------------------------------------------------------------------
# Beyond tests/test_nested.py: the mesh plane, deletes, scroll
# ---------------------------------------------------------------------------

QA_MAPPING = {"properties": {
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"},
        "date": {"type": "long"},
        "body": {"type": "text"}}}}}


def qa_docs(n=90, seed=5, prefix="q"):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(12)]
    docs = []
    for d in range(n):
        src = {"title": " ".join(rng.choice(vocab, rng.randint(2, 7))),
               "tag": f"t{rng.randint(6)}"}
        k = int(rng.randint(0, 5))
        if k:
            src["answers"] = [
                {"user": f"u{int(rng.zipf(1.6)) % 15}",
                 "date": int(1000 + rng.randint(0, 400)),
                 "body": " ".join(rng.choice(vocab, rng.randint(1, 5)))}
                for _ in range(k)]
        docs.append((f"{prefix}{d}", src))
    return docs


@pytest.fixture(scope="module", params=["host", "mesh"])
def qa(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    mesh = request.param == "mesh"
    # one object of one doc (so one shard's slot) holds the user "UNIQUE"
    docs = qa_docs() + [("qu", {"title": "w1", "answers": [
        {"user": "UNIQUE", "date": 1200, "body": "w0"}]})]
    p = Pair("qa-" + request.param, QA_MAPPING, docs, shards=3,
             settings=({} if mesh else {"index.search.mesh": False}),
             jax_mesh=mesh)
    yield request.param, p
    p.close()
    mp.undo()


NESTED_USER = {"nested": {"path": "answers", "query": {"bool": {
    "must": [{"term": {"answers.user": "u1"}}],
    "filter": [{"range": {"answers.date": {"gte": 1100}}}]}}}}
MESH_CASES = {
    "alone": {"query": NESTED_USER, "size": 20},
    "under_match": {"query": {"bool": {
        "must": [{"match": {"title": "w1 w3"}}],
        "should": [NESTED_USER]}}, "size": 20},
    "inner_match_sum": {"query": {"nested": {
        "path": "answers", "score_mode": "sum",
        "query": {"match": {"answers.body": "w2 w5"}}}}, "size": 20},
    "one_shard_only": {"query": {"nested": {"path": "answers", "query": {
        "term": {"answers.user": "UNIQUE"}}}}},
    "inner_hits": {"query": {"nested": {
        "path": "answers", "query": {"match": {"answers.body": "w4"}},
        "inner_hits": {"size": 2}}}, "size": 10},
    "nested_sort": {"query": {"match": {"title": "w1 w2"}},
                    "sort": [{"answers.date": {"order": "desc",
                                               "mode": "max"}}],
                    "size": 15},
    "nested_agg": {"size": 0, "query": {"match": {"title": "w1"}},
                   "aggs": {"a": {"nested": {"path": "answers"}, "aggs": {
                       "users": {"terms": {"field": "answers.user"},
                                 "aggs": {"back": {"reverse_nested": {},
                                                   "aggs": {"tags": {
                                                       "terms": {
                                                           "field": "tag"}}}}}},
                       "h": {"histogram": {"field": "answers.date",
                                           "interval": 100}}}}}},
}


def jax_decisions(jidx) -> dict:
    """The JAX plane ladder's decision counters, keyed as the port keys
    them (``plane.reason``)."""
    return dict(jidx.telemetry.decisions)


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_planes_and_decisions_equal_jax(qa, name):
    """Each request answers as the JAX package's does, on the same plane
    with the same decision counters (mesh: nested alone on ``mesh``, under
    a match on ``mesh_pallas``, a MatchNone slot beside a DenseScore slot
    ``shape_mismatch`` then ``host.no_mesh_plane``, a nested sort
    ``host.sort_ineligible``, nested aggregations reduced on the host by
    ``unsupported_agg``)."""
    mode, p = qa
    jm = p.j._mesh_search if mode == "mesh" else None
    tm = p.t._mesh_plane() if mode == "mesh" else None
    jd0 = jax_decisions(p.j) if jm else {}
    td0 = dict(tm.decisions) if tm else {}
    ja0 = dict(jm.agg_host_fallback_by_reason) if jm else {}
    ta0 = dict(tm.agg_host_fallback_by_reason) if tm else {}
    tr = p.search(MESH_CASES[name])
    if mode == "host":
        assert tr["_plane"] == "host"
        return
    delta = lambda d, d0: {k: v - d0.get(k, 0) for k, v in d.items()  # noqa
                           if v != d0.get(k, 0)}
    assert delta(tm.decisions, td0) == delta(jax_decisions(p.j), jd0)
    assert (delta(tm.agg_host_fallback_by_reason, ta0)
            == delta(jm.agg_host_fallback_by_reason, ja0))
    expected = {"alone": "mesh", "under_match": "mesh_pallas",
                "one_shard_only": "host", "nested_sort": "host",
                "nested_agg": "mesh_pallas"}
    if name in expected:
        assert tr["_plane"] == expected[name], name
    if name == "nested_sort":
        assert delta(tm.decisions, td0) == {"host.sort_ineligible": 1}
    if name == "one_shard_only":
        assert delta(tm.decisions, td0).get("host.no_mesh_plane") == 1


def test_nested_delete_and_delta_append_on_the_mesh(tmp_path, monkeypatch):
    """On the mesh plane: deleting docs drops exactly their objects from a
    nested count (the staged sub-segment live masks restage), a delta
    append brings its own sub-segments, and both answer as the JAX host
    rung does; the sub-segments stage under their own ledger scopes, owned
    by the index, and ``close`` returns every byte."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    p = Pair("qad", QA_MAPPING, qa_docs(60, seed=8), shards=2,
             settings={"index.search.mesh.max_slots_per_device": 8})
    try:
        body = {"query": {"nested": {"path": "answers", "query": {
            "range": {"answers.date": {"gte": 1000}}}}}, "size": 0,
            "aggs": {"a": {"nested": {"path": "answers"}}}}
        r0 = p.search(body)
        assert r0["_plane"] == "mesh"
        acct = memory_accountant()
        segs = [s for sh in p.t.shards.values()
                for s in sh.engine.segments]
        subs = [s.nested["answers"].segment for s in segs]
        assert all(sub.owner_index == "qad" for sub in subs)
        # each sub-segment staged under its own scope of the index
        scopes = {k[1] for k in acct._entries if k[0] == "qad"}
        assert all(sub.ledger_scope in scopes for sub in subs)
        victims = [d for d, src in qa_docs(60, seed=8)[:10]]
        objs = sum(len(src.get("answers", []))
                   for _d, src in qa_docs(60, seed=8)[:10])
        for d in victims:
            p.j.delete_doc(d)
            p.t.delete_doc(d)
        p.refresh()
        r1 = p.search(body)
        assert (r0["aggregations"]["a"]["doc_count"]
                - r1["aggregations"]["a"]["doc_count"]) == objs
        for doc_id, src in qa_docs(20, seed=9, prefix="n"):
            p.index(doc_id, src)
        p.refresh()
        p.search(body)
        assert p.t._mesh_plane().delta_restage_total >= 1
    finally:
        p.close()
    assert memory_accountant().staged_bytes("qad") == 0


def test_scroll_over_a_nested_query_pages_the_snapshot():
    """A scroll pins the nested sub-segments with their docs: deletes
    after the open change nothing in its pages, which equal the JAX
    scroll's (taken with no writes in between)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(JSettings.EMPTY), Node(device="cpu")
    try:
        for n in (jn, tn):
            n.create_index("s", {"settings": {"number_of_shards": 2},
                                 "mappings": QA_MAPPING})
            for doc_id, src in qa_docs(50, seed=3):
                n.index_doc("s", doc_id, src)
            n.indices["s"].refresh()
        body = {"query": {"nested": {"path": "answers", "query": {
            "range": {"answers.date": {"gte": 1150}}},
            "inner_hits": {"size": 1}}}, "sort": ["_doc"], "size": 4}

        def drain(node, first, mutate=None):
            pages = [first]
            sid = first["_scroll_id"]
            if mutate:
                mutate()
            while True:
                page = node.scroll(sid)
                if not page["hits"]["hits"]:
                    return pages
                pages.append(page)

        jpages = drain(jn, jn.search("s", dict(body), scroll="1m"))

        def delete_some():
            for doc_id, _src in qa_docs(50, seed=3)[::3]:
                tn.delete_doc("s", doc_id)
            tn.indices["s"].refresh()

        tfirst = tn.search("s", dict(body), scroll="1m")
        views = [v for vs in tn.scrolls[tfirst["_scroll_id"]]["pinned"]
                 .values() for v in vs]
        assert views
        tpages = drain(tn, tfirst, delete_some)
        assert len(tpages) == len(jpages)
        for a, b in zip(jpages, tpages):
            same_value([(h["_id"], h.get("sort"), h.get("inner_hits"))
                        for h in a["hits"]["hits"]],
                       [(h["_id"], h.get("sort"), h.get("inner_hits"))
                        for h in b["hits"]["hits"]])
        for v in views:
            assert isinstance(v, PinnedSegmentView)
            assert isinstance(v.nested["answers"].segment, PinnedSegmentView)
    finally:
        jn.close()
        tn.close()
        mp.undo()


def test_nested_mapping_errors_equal_jax():
    """A concrete value under a nested path and two flattened vectors on
    one root are the JAX package's 400s."""
    from elasticsearch_tpu.common.errors import (
        MapperParsingException as JMapperParsing,
    )

    mapping = {"properties": {"obj": {
        "type": "nested", "include_in_parent": True,
        "properties": {"emb": {"type": "dense_vector", "dims": 2},
                       "k": {"type": "keyword"}}}}}
    p = Pair("errs", mapping)
    try:
        for src in ({"obj": "scalar"}, {"obj": [{"k": "a"}, 7]},
                    {"obj": [{"emb": [1, 0]}, {"emb": [0, 1]}]}):
            with pytest.raises(JMapperParsing) as je:
                p.j.index_doc("x", src)
            with pytest.raises(MapperParsingException) as te:
                p.t.index_doc("x", src)
            assert str(te.value) == str(je.value)
            assert te.value.status_code == 400
    finally:
        p.close()
