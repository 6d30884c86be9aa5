"""Parity of the parent-join field with the JAX package.

Every case of tests/test_parent_join.py, and the two join inner-hits
cases of tests/test_nested.py, runs on a JAX ``IndexService`` and a port
``IndexService(device="cpu")`` fed the same documents: the same request
answers equally (``_plane``, totals, ids in order, inner hits and
buckets exactly, scores within rtol 1e-5), the JAX test's own assertions
hold on the port's answer, and errors raise the same class with the same
message.

On a multi-shard index the port's join answers are the JAX host rung's
on every plane. The JAX mesh plane differs there (ROADMAP C13): its
``has_child`` / ``has_parent`` builder memoizes the first shard's pass and
reuses it for every slot, so a match outside the first shard is lost.
``test_c13_join_outside_the_first_shard`` pins this side by side over 2
shards: the JAX mesh's ``total 0``, the JAX host rung's answer, and the
port's equal answer on its mesh index and on its host twin.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import ElasticsearchTpuException as JErr
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for
from test_torch_nested import same_response

JAX_ONLY = {"index.requests.cache.enable": False}

QA_MAPPING = {"properties": {
    "my_join": {"type": "join", "relations": {"question": "answer"}},
    "title": {"type": "text"},
    "body": {"type": "text"},
    "votes": {"type": "long"},
}}
QA_DOCS = [
    ("q1", {"my_join": "question", "title": "how to train a dog"}),
    ("q2", {"my_join": "question", "title": "how to cook rice"}),
    ("q3", {"my_join": "question", "title": "unanswered question"}),
    ("a1", {"my_join": {"name": "answer", "parent": "q1"},
            "body": "use positive reinforcement", "votes": 5}),
    ("a2", {"my_join": {"name": "answer", "parent": "q1"},
            "body": "daily training with treats", "votes": 2}),
    ("a3", {"my_join": {"name": "answer", "parent": "q2"},
            "body": "use a rice cooker", "votes": 9}),
]


def hit_ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


def as_index(resp, name, plane="host"):
    """A response as if index ``name`` on ``plane`` had answered: the
    comparison with another index's answer."""
    def walk(x):
        if isinstance(x, dict):
            return {k: (name if k == "_index" else walk(v))
                    for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x
    return dict(walk(resp), _plane=plane)


class Pair:
    def __init__(self, name, mapping, shards=1, settings=None,
                 jax_mesh=False):
        common = {"index.number_of_shards": shards,
                  "index.refresh_interval": -1, **(settings or {})}
        self.j = JIndex(name, JSettings({**common, **JAX_ONLY}),
                        mapping=mapping)
        if jax_mesh:
            self.j._mesh_search = JMesh(self.j, mesh=shard_mesh(1))
        self.t = IndexService(name, Settings(common), mapping=mapping,
                              device="cpu")

    def index(self, doc_id, src, **kw):
        jr = self.j.index_doc(doc_id, src, **kw)
        tr = self.t.index_doc(doc_id, src, **kw)
        assert tr["result"] == jr["result"]
        return tr

    def index_errors(self, doc_id, src, **kw):
        with pytest.raises(JErr) as je:
            self.j.index_doc(doc_id, src, **kw)
        with pytest.raises(ElasticsearchTpuException) as te:
            self.t.index_doc(doc_id, src, **kw)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)
        assert te.value.status_code == je.value.status_code == 400

    def refresh(self):
        self.j.refresh()
        self.t.refresh()

    def search(self, body):
        jr = self.j.search(dict(body))
        tr = self.t.search(dict(body))
        same_response(jr, tr)
        return tr

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture()
def qa():
    p = Pair("qa", QA_MAPPING)
    for doc_id, src in QA_DOCS:
        p.index(doc_id, src)
    p.refresh()
    yield p
    p.close()


VOTES = {"function_score": {"query": {"match_all": {}},
                            "field_value_factor": {"field": "votes"},
                            "boost_mode": "replace"}}


class TestJoinField:
    def test_term_query_on_relation(self, qa):
        assert hit_ids(qa.search({"query": {"term": {
            "my_join": "question"}}})) == ["q1", "q2", "q3"]
        assert hit_ids(qa.search({"query": {"term": {
            "my_join": "answer"}}})) == ["a1", "a2", "a3"]

    def test_child_requires_parent(self, qa):
        qa.index_errors("bad", {"my_join": "answer"})

    def test_unknown_relation_rejected(self, qa):
        qa.index_errors("bad", {"my_join": "comment"})

    def test_parent_with_parent_param_rejected(self, qa):
        qa.index_errors("bad", {"my_join": {"name": "question",
                                            "parent": "q1"}})


class TestHasChild:
    def test_basic(self, qa):
        assert hit_ids(qa.search({"query": {"has_child": {
            "type": "answer", "query": {"match": {"body": "training"}}}}})) \
            == ["q1"]

    def test_all_children(self, qa):
        assert hit_ids(qa.search({"query": {"has_child": {
            "type": "answer", "query": {"match_all": {}}}}})) == ["q1", "q2"]

    def test_min_children(self, qa):
        assert hit_ids(qa.search({"query": {"has_child": {
            "type": "answer", "query": {"match_all": {}},
            "min_children": 2}}})) == ["q1"]

    def test_max_children(self, qa):
        assert hit_ids(qa.search({"query": {"has_child": {
            "type": "answer", "query": {"match_all": {}},
            "max_children": 1}}})) == ["q2"]

    def test_score_mode_sum(self, qa):
        resp = qa.search({"query": {"has_child": {
            "type": "answer", "query": VOTES, "score_mode": "sum"}}})
        by_id = {h["_id"]: h["_score"] for h in resp["hits"]["hits"]}
        assert by_id["q1"] == pytest.approx(7.0)
        assert by_id["q2"] == pytest.approx(9.0)
        assert resp["hits"]["hits"][0]["_id"] == "q2"

    def test_score_mode_max_min_avg(self, qa):
        for mode, expected_q1 in (("max", 5.0), ("min", 2.0), ("avg", 3.5)):
            resp = qa.search({"query": {"has_child": {
                "type": "answer", "query": VOTES, "score_mode": mode}}})
            by_id = {h["_id"]: h["_score"] for h in resp["hits"]["hits"]}
            assert by_id["q1"] == pytest.approx(expected_q1), mode


class TestHasParent:
    def test_basic(self, qa):
        assert hit_ids(qa.search({"query": {"has_parent": {
            "parent_type": "question",
            "query": {"match": {"title": "dog"}}}}})) == ["a1", "a2"]

    def test_score_true(self, qa):
        resp = qa.search({"query": {"has_parent": {
            "parent_type": "question", "query": {"match": {"title": "dog"}},
            "score": True}}})
        scores = [h["_score"] for h in resp["hits"]["hits"]]
        assert all(s > 0 for s in scores)
        assert scores[0] == scores[1]


class TestParentId:
    def test_parent_id(self, qa):
        assert hit_ids(qa.search({"query": {"parent_id": {
            "type": "answer", "id": "q1"}}})) == ["a1", "a2"]
        assert hit_ids(qa.search({"query": {"parent_id": {
            "type": "answer", "id": "q3"}}})) == []


class TestChildrenAgg:
    def test_children_agg(self, qa):
        resp = qa.search({
            "size": 0, "query": {"match": {"title": "dog"}},
            "aggs": {"answers": {
                "children": {"type": "answer"},
                "aggs": {"total_votes": {"sum": {"field": "votes"}}}}}})
        agg = resp["aggregations"]["answers"]
        assert agg["doc_count"] == 2
        assert agg["total_votes"]["value"] == pytest.approx(7.0)

    def test_children_under_terms(self, qa):
        resp = qa.search({"size": 0, "aggs": {"questions": {
            "terms": {"field": "my_join"},
            "aggs": {"kids": {"children": {"type": "answer"}}}}}})
        buckets = {b["key"]: b for b in
                   resp["aggregations"]["questions"]["buckets"]}
        assert buckets["question"]["kids"]["doc_count"] == 3

    def test_multishard_child_requires_routing(self):
        p = Pair("qa3", {"properties": {
            "j": {"type": "join", "relations": {"p": "c"}}}}, shards=3)
        try:
            p.index("p1", {"j": "p"})
            p.index_errors("c1", {"j": {"name": "c", "parent": "p1"}})
            p.index("c1", {"j": {"name": "c", "parent": "p1"}},
                    routing="p1")
            p.refresh()
            assert hit_ids(p.search({"query": {"has_child": {
                "type": "c", "query": {"match_all": {}}}}})) == ["p1"]
        finally:
            p.close()

    def test_cross_segment_join(self):
        p = Pair("qa2", {"properties": {
            "j": {"type": "join", "relations": {"p": "c"}}}})
        try:
            p.index("p1", {"j": "p"})
            p.refresh()
            p.index("c1", {"j": {"name": "c", "parent": "p1"}})
            p.refresh()
            assert len(p.t.shards[0].engine.segments) == 2
            assert hit_ids(p.search({"query": {"has_child": {
                "type": "c", "query": {"match_all": {}}}}})) == ["p1"]
            assert hit_ids(p.search({"query": {"has_parent": {
                "parent_type": "p", "query": {"match_all": {}}}}})) \
                == ["c1"]
        finally:
            p.close()


class TestJoinInnerHits:
    """tests/test_nested.py's two join inner-hits cases."""

    def test_has_child_inner_hits(self):
        p = Pair("qa", {"properties": {
            "j": {"type": "join", "relations": {"q": "a"}},
            "body": {"type": "text"}}})
        try:
            p.index("q1", {"j": "q"})
            p.index("a1", {"j": {"name": "a", "parent": "q1"},
                           "body": "good answer"})
            p.index("a2", {"j": {"name": "a", "parent": "q1"},
                           "body": "bad reply"})
            p.refresh()
            resp = p.search({"query": {"has_child": {
                "type": "a", "query": {"match": {"body": "answer"}},
                "inner_hits": {}}}})
            assert hit_ids(resp) == ["q1"]
            ih = resp["hits"]["hits"][0]["inner_hits"]["a"]["hits"]
            assert ih["total"] == 1 and ih["hits"][0]["_id"] == "a1"
        finally:
            p.close()

    def test_has_parent_inner_hits(self):
        p = Pair("qa2", {"properties": {
            "j": {"type": "join", "relations": {"q": "a"}},
            "title": {"type": "text"}}})
        try:
            p.index("q1", {"j": "q", "title": "trains"})
            p.index("a1", {"j": {"name": "a", "parent": "q1"}})
            p.refresh()
            resp = p.search({"query": {"has_parent": {
                "parent_type": "q", "query": {"match": {"title": "trains"}},
                "inner_hits": {}}}})
            assert hit_ids(resp) == ["a1"]
            ih = resp["hits"]["hits"][0]["inner_hits"]["q"]["hits"]
            assert ih["hits"][0]["_id"] == "q1"
        finally:
            p.close()


# ---------------------------------------------------------------------------
# A seeded multi-shard corpus: every score mode, inner hits, the
# children aggregation, against the JAX host rung
# ---------------------------------------------------------------------------


def seeded_qa(n_q=40, seed=7):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(10)]
    docs = []
    for q in range(n_q):
        docs.append((f"q{q}", {"my_join": "question",
                               "title": " ".join(rng.choice(vocab, 4))}, None))
        for a in range(int(rng.randint(0, 5))):
            docs.append((f"a{q}_{a}", {
                "my_join": {"name": "answer", "parent": f"q{q}"},
                "body": " ".join(rng.choice(vocab, int(rng.randint(1, 6)))),
                "votes": int(rng.randint(0, 20))}, f"q{q}"))
    return docs


@pytest.fixture(scope="module")
def joined():
    """The JAX host rung (the reference answer) and the port on its host
    rung and on its mesh plane, 3 shards, children routed to parents,
    refreshed twice so a shard holds two segments."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    common = {"index.number_of_shards": 3, "index.refresh_interval": -1}
    jh = JIndex("jh", JSettings({**common, "index.search.mesh": False,
                                 **JAX_ONLY}), mapping=QA_MAPPING)
    th = IndexService("th", Settings({**common, "index.search.mesh": False}),
                      mapping=QA_MAPPING, device="cpu")
    tm = IndexService("tm", Settings({
        **common, "index.search.mesh.max_slots_per_device": 8}),
        mapping=QA_MAPPING, device="cpu")
    docs = seeded_qa()
    for i, (doc_id, src, routing) in enumerate(docs):
        for idx in (jh, th, tm):
            idx.index_doc(doc_id, src, routing=routing)
        if i == len(docs) // 2:
            for idx in (jh, th, tm):
                idx.refresh()
    for idx in (jh, th, tm):
        idx.refresh()
    yield jh, th, tm
    for idx in (jh, th, tm):
        idx.close()
    mp.undo()


JOIN_CASES = {
    **{f"has_child_{m}": {"query": {"has_child": {
        "type": "answer", "score_mode": m,
        "query": {"match": {"body": "w1 w4"}}}}, "size": 30}
       for m in ("none", "min", "max", "sum", "avg")},
    "has_child_votes_sum_min2": {"query": {"has_child": {
        "type": "answer", "score_mode": "sum", "min_children": 2,
        "max_children": 3, "query": VOTES, "inner_hits": {"size": 2}}},
        "size": 30},
    "has_parent_score": {"query": {"has_parent": {
        "parent_type": "question", "score": True,
        "query": {"match": {"title": "w2 w7"}},
        "inner_hits": {}}}, "size": 40},
    "has_parent_under_match": {"query": {"bool": {
        "must": [{"match": {"body": "w3"}}],
        "filter": [{"has_parent": {"parent_type": "question",
                                   "query": {"match": {"title": "w5"}}}}]}},
        "size": 40},
    "parent_id": {"query": {"parent_id": {"type": "answer", "id": "q3"}}},
    "children_agg": {"size": 0, "query": {"match": {"title": "w0 w9"}},
                     "aggs": {"a": {"children": {"type": "answer"}, "aggs": {
                         "v": {"sum": {"field": "votes"}},
                         "t": {"terms": {"field": "votes", "size": 5}}}}}},
}


@pytest.mark.parametrize("name", sorted(JOIN_CASES))
def test_join_answers_equal_the_jax_host_rung(joined, name):
    """On both of the port's planes every join request answers as the JAX
    host rung does (the plane aside)."""
    jh, th, tm = joined
    body = JOIN_CASES[name]
    jr = jh.search(dict(body))
    same_response(as_index(jr, "th"), as_index(th.search(dict(body)), "th"))
    # the mesh plane breaks score ties by slot: the whole result, in
    # (score, id) order, is the JAX host rung's
    body = dict(body, size=500)
    jr = as_index(jh.search(dict(body)), "tm")
    tr = as_index(tm.search(dict(body)), "tm")
    for r in (jr, tr):
        r["hits"]["hits"].sort(key=lambda h: (-(h["_score"] or 0),
                                              h["_id"]))
    same_response(jr, tr)


def test_c13_join_outside_the_first_shard():
    """ROADMAP C13 pinned: 10 questions and 10 answers over 2 shards, each
    answer routed to its question. For each answer's unique word the JAX
    host rung answers ``has_child`` with its question and ``has_parent``
    with the answer; the JAX mesh answers ``total 0`` for every answer
    outside the first shard; the port answers as the JAX host rung on its
    mesh index and on its host twin."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    mapping = {"properties": {
        "j": {"type": "join", "relations": {"question": "answer"}},
        "title": {"type": "text"}, "body": {"type": "text"}}}
    common = {"index.number_of_shards": 2, "index.refresh_interval": -1}
    jm = JIndex("c13m", JSettings({**common, **JAX_ONLY}), mapping=mapping)
    jm._mesh_search = JMesh(jm, mesh=shard_mesh(1))
    jh = JIndex("c13h", JSettings({**common, "index.search.mesh": False,
                                   **JAX_ONLY}), mapping=mapping)
    tm = IndexService("c13m", Settings(common), mapping=mapping,
                      device="cpu")
    th = IndexService("c13h", Settings({**common,
                                        "index.search.mesh": False}),
                      mapping=mapping, device="cpu")
    every = (jm, jh, tm, th)
    try:
        for i in range(10):
            for idx in every:
                idx.index_doc(f"q{i}", {"j": "question",
                                        "title": f"topic{i} common"})
                idx.index_doc(f"a{i}", {"j": {"name": "answer",
                                              "parent": f"q{i}"},
                                        "body": f"uniq{i} common"},
                              routing=f"q{i}")
        for idx in every:
            idx.refresh()
        outside = 0
        planes = {}
        for i in range(10):
            second = shard_id_for(f"q{i}", 2) == 1
            outside += second
            for body, want in (
                    ({"query": {"has_child": {
                        "type": "answer",
                        "query": {"match": {"body": f"uniq{i}"}}}}},
                     f"q{i}"),
                    ({"query": {"has_parent": {
                        "parent_type": "question",
                        "query": {"match": {"title": f"topic{i}"}}}}},
                     f"a{i}")):
                rj_host = jh.search(dict(body))
                assert hit_ids(rj_host) == [want]
                rj_mesh = jm.search(dict(body))
                if second:
                    # the JAX mesh loses it (C13)
                    assert rj_mesh["hits"]["total"] == 0
                    assert rj_mesh["_plane"] in ("mesh", "mesh_pallas")
                for idx in (tm, th):
                    tr = idx.search(dict(body))
                    same_response(as_index(rj_host, idx.name),
                                  as_index(tr, idx.name))
                    planes.setdefault(idx.name, set()).add(tr["_plane"])
        assert outside > 0
        # the port's mesh index sent each single-shard join to the host
        # rung (a MatchNone slot beside a DenseScore slot)
        assert planes == {"c13m": {"host"}, "c13h": {"host"}}
        ms = tm._mesh_plane()
        assert ms.decisions.get("mesh.shape_mismatch", 0) > 0
    finally:
        for idx in every:
            idx.close()
        mp.undo()
