"""Parity of text fielddata with the JAX package.

A ``terms`` or ``significant_terms`` aggregation on a text field reads an
ordinal column built from the field's postings the first time an
aggregation asks (the JAX package's ``_text_fielddata``). The port's build
is vectorized; its column must equal the JAX one array for array, its
buckets the JAX buckets across segments and shards (mirroring
tests/test_aggs_extended.py's significant terms on text), and its breaker
behaviour the JAX one (tests/test_breakers.py's fielddata case): the
estimate is charged before the build, a low limit trips with the JAX
message, and the bytes come back when a merge retires the segment, the
index closes or is deleted. On the mesh plane the fused aggregations
decline text fielddata with ``field_ineligible``.
"""

import re

import numpy as np
import pytest

from elasticsearch_tpu.common.breaker import (
    configure_breaker_service as jconfigure_breakers,
)
from elasticsearch_tpu.common.errors import ElasticsearchTpuException
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu.search.aggregations import (
    _text_fielddata as jtext_fielddata,
)
from elasticsearch_tpu_torch.common.breaker import (
    CircuitBreaker,
    breaker_service,
    configure_breaker_service,
)
from elasticsearch_tpu_torch.common.errors import CircuitBreakingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.aggregations import _text_fielddata

MAPPING = {"properties": {
    "body": {"type": "text"},
    "topic": {"type": "keyword"},
    "n": {"type": "long"},
}}


@pytest.fixture(autouse=True)
def _restore_breakers():
    yield
    configure_breaker_service(Settings.EMPTY)
    jconfigure_breakers(JSettings.EMPTY)


def fielddata_bytes() -> int:
    return breaker_service().get_breaker(CircuitBreaker.FIELDDATA).used_bytes


def seeded_docs(n=300, seed=4, prefix="d"):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i:03d}" for i in range(180)]
    docs = []
    for d in range(n):
        words = rng.choice(vocab, rng.randint(1, 14), p=None)
        src = {"topic": ["crime", "news", "sport"][d % 3], "n": int(d % 7)}
        if d % 23:
            src["body"] = " ".join(words)
        if d % 3 == 0:
            src["body"] = src.get("body", "") + " theft"
        docs.append((f"{prefix}{d}", src))
    return docs


def make_pair(name, shards=3, mesh=False, refresh_every=None):
    common = {"index.number_of_shards": shards, "index.refresh_interval": -1,
              "index.staging.delta.enabled": False,
              "index.search.mesh.max_slots_per_device": 16}
    if not mesh:
        common["index.search.mesh"] = False
    jidx = JIndex(name, JSettings({**common,
                                   "index.requests.cache.enable": False}),
                  mapping=MAPPING)
    if mesh:
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common), mapping=MAPPING,
                        device="cpu")
    for i, (doc_id, src) in enumerate(seeded_docs()):
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
        if refresh_every and i % refresh_every == refresh_every - 1:
            jidx.refresh()
            tidx.refresh()
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


@pytest.fixture(scope="module", params=["host", "mesh"])
def pair(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    # several segments a shard: the terms merge folds global ordinals
    jidx, tidx = make_pair(f"fd{request.param}", mesh=request.param == "mesh",
                           refresh_every=70)
    yield request.param, jidx, tidx
    jidx.close()
    tidx.close()
    mp.undo()


AGGS = [
    {"t": {"terms": {"field": "body"}}},
    {"t": {"terms": {"field": "body", "size": 5, "order": {"_key": "asc"}}}},
    {"t": {"terms": {"field": "body", "min_doc_count": 3, "size": 40}}},
    {"t": {"terms": {"field": "body"}, "aggs": {
        "s": {"stats": {"field": "n"}}}}},
    {"c": {"cardinality": {"field": "body"}}},
    {"s": {"significant_terms": {"field": "body", "min_doc_count": 2}}},
]


@pytest.mark.parametrize("case", range(len(AGGS)))
@pytest.mark.parametrize("query", [None, {"match": {"body": "t001 t002"}},
                                   {"term": {"topic": "crime"}}])
def test_terms_on_text_equal_jax(pair, case, query):
    _mode, jidx, tidx = pair
    body = {"size": 0, "aggs": AGGS[case]}
    if query is not None:
        body["query"] = query
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert tr["aggregations"] == jr["aggregations"]


def test_significant_terms_finds_theft(pair):
    _mode, jidx, tidx = pair
    body = {"size": 0, "query": {"term": {"topic": "crime"}},
            "aggs": {"sig": {"significant_terms": {
                "field": "body", "min_doc_count": 2}}}}
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert tr["aggregations"] == jr["aggregations"]
    assert tr["aggregations"]["sig"]["buckets"][0]["key"] == "theft"


def test_built_column_equals_jax_array_for_array(pair):
    _mode, jidx, tidx = pair
    for sid in range(3):
        jsegs = jidx.shards[sid].engine.segments
        tsegs = tidx.shards[sid].engine.segments
        assert len(jsegs) == len(tsegs) > 1
        for js, ts in zip(jsegs, tsegs):
            jc = jtext_fielddata(js, "body")
            tc = _text_fielddata(ts, "body")
            assert tc.terms == jc.terms
            assert tc.count == jc.count
            for k in ("flat_ords", "flat_docs", "first_ord", "exists"):
                a, b = getattr(jc, k), getattr(tc, k)
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            assert ts.breaker_charges == js.breaker_charges
    assert _text_fielddata(tsegs[0], "topic.nope") is None


def test_fused_plane_declines_text_fielddata():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = make_pair("fdfused", mesh=True)
    try:
        ms = tidx._mesh_plane()
        jms = jidx._mesh_search
        before = ms.agg_host_fallback_by_reason.get("field_ineligible", 0)
        jbefore = jms.agg_host_fallback_by_reason.get("field_ineligible", 0)
        body = {"size": 0, "aggs": {"t": {"terms": {"field": "body"}}}}
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        assert tr["aggregations"] == jr["aggregations"]
        assert tr["_plane"] == jr["_plane"]
        assert ms.agg_host_fallback_by_reason["field_ineligible"] \
            == before + 1
        assert jms.agg_host_fallback_by_reason["field_ineligible"] \
            == jbefore + 1
        # a keyword terms stays fused on both
        body = {"size": 0, "aggs": {"t": {"terms": {"field": "topic"}}}}
        fused = ms.agg_fused_query_total
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        assert tr["aggregations"] == jr["aggregations"]
        assert ms.agg_fused_query_total == fused + 1
    finally:
        jidx.close()
        tidx.close()
        mp.undo()


def make_nodes(**breaker_settings):
    """The tests/test_breakers.py node: 50 docs, a text ``tag``."""
    body = {"settings": {"number_of_shards": 1},
            "mappings": {"_doc": {"properties": {
                "tag": {"type": "text"}, "msg": {"type": "text"}}}}}
    jn = JNode(JSettings.from_dict(breaker_settings) if breaker_settings
               else JSettings.EMPTY)
    tn = Node(Settings.from_dict(breaker_settings) if breaker_settings
              else Settings.EMPTY, device="cpu")
    for n in (jn, tn):
        n.create_index("logs", body)
        for i in range(50):
            n.index_doc("logs", str(i), {"tag": f"t{i % 5}",
                                         "msg": f"event {i}"},
                        refresh=(i == 49))
    return jn, tn


TAG_AGG = {"size": 0, "aggs": {"tags": {"terms": {"field": "tag"}}}}


def test_fielddata_breaker_accounts_text_fielddata():
    jn, tn = make_nodes()
    try:
        jbreaker = jn.breaker_service.get_breaker("fielddata")
        before, jbefore = fielddata_bytes(), jbreaker.used_bytes
        jr = jn.search("logs", dict(TAG_AGG))
        tr = tn.search("logs", dict(TAG_AGG))
        assert tr["aggregations"] == jr["aggregations"]
        after = fielddata_bytes()
        # 50 postings * 8 + 64 docs * 5: charged once, kept while cached
        assert after - before == jbreaker.used_bytes - jbefore \
            == 50 * 8 + 64 * 5
        tn.search("logs", dict(TAG_AGG))
        assert fielddata_bytes() == after
    finally:
        jn.delete_index("logs")
        tn.delete_index("logs")
        tn.close()
    assert fielddata_bytes() == before


def test_low_fielddata_limit_trips_before_the_build():
    jn, tn = make_nodes(**{"indices.breaker.fielddata.limit": "300b"})
    try:
        with pytest.raises(ElasticsearchTpuException) as je:
            jn.search("logs", dict(TAG_AGG))
        used = fielddata_bytes()
        with pytest.raises(CircuitBreakingException) as te:
            tn.search("logs", dict(TAG_AGG))
        # the JAX message, over the process's own accounted bytes (other
        # tests' open indices may hold charges in either package)
        want = used + 50 * 8 + 64 * 5
        assert str(te.value) == (
            f"[fielddata] Data too large, data for [fielddata [tag]] would "
            f"be [{want}/{want}b], which is larger than the limit of [300b]")
        assert re.sub(r"\d+", "N", str(te.value)) == \
            re.sub(r"\d+", "N", str(je.value))
        assert te.value.status_code == 429
        assert "[fielddata] Data too large" in str(te.value)
        # nothing was built or charged
        seg = tn.indices["logs"].shards[0].engine.segments[0]
        assert seg.breaker_charges == {}
        assert "fielddata.tag" not in seg.host_cache
    finally:
        jn.delete_index("logs")
        tn.delete_index("logs")
        tn.close()


@pytest.mark.parametrize("release", ["merge", "close", "delete"])
def test_charges_return_on_merge_close_and_delete(release):
    tn = Node(device="cpu")
    # other open indices of this module hold their own charges
    base = fielddata_bytes()
    try:
        tn.create_index("rel", {"settings": {"number_of_shards": 2,
                                             "refresh_interval": "-1"},
                                "mappings": {"_doc": MAPPING}})
        for i, (doc_id, src) in enumerate(seeded_docs(120)):
            tn.index_doc("rel", doc_id, src)
            if i % 40 == 39:
                tn.refresh("rel")
        tn.refresh("rel")
        body = {"size": 0, "aggs": {"t": {"terms": {"field": "body"}}}}
        first = tn.search("rel", dict(body))
        svc = tn.indices["rel"]
        segs = [s for sh in svc.shards.values() for s in sh.engine.segments]
        charged = sum(sum(s.breaker_charges.values()) for s in segs)
        assert charged > 0 and fielddata_bytes() == base + charged
        if release == "merge":
            tn.force_merge("rel")
            assert fielddata_bytes() == base
            # the merged segments build (and charge) again on demand
            assert tn.search("rel", dict(body))["aggregations"] \
                == first["aggregations"]
            merged = [s for sh in svc.shards.values()
                      for s in sh.engine.segments]
            assert fielddata_bytes() - base == sum(
                sum(s.breaker_charges.values()) for s in merged) > 0
            tn.delete_index("rel")
        elif release == "close":
            svc.close()
            tn.indices.pop("rel")
        else:
            tn.delete_index("rel")
        assert fielddata_bytes() == base
    finally:
        tn.close()
