"""Parity of the port's aggregation framework with the JAX package's.

A JAX ``Node`` (host rung: ``search.mesh: false``, its Pallas kernels in
interpret mode, ``ES_TPU_PALLAS=interpret``) and the port's
``Node(device="cpu")`` (5 shards: more (shard, segment) pairs than the
one-device mesh plane takes, so the host rung too) index the same seeded
documents: ISO and epoch dates, a date with a ``format``, booleans, a
field missing on some docs and multi-valued keyword and long fields.
Every aggregation type the port serves, with sub-aggregations and
embedded and sibling pipelines, must give the JAX package's response:
buckets, counts, keys and ``key_as_string`` exactly, metric values
exactly (both reduce in f64 numpy over the same values in the same
order), and ``top_hits`` scores within rtol 1e-5 (the kernels' BM25
scores; ids exact except among hits tied within it). Percentiles are
checked across the sampling threshold (more than 100,000 matched values a
segment). The date and boolean mapper and date queries are checked too.
"""

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu_torch.common.errors import (
    MapperParsingException,
    ParsingException,
)
from elasticsearch_tpu_torch.node import Node

RTOL = 1e-5
N_DOCS = 300
DAY = 86_400_000
EPOCH = 1_577_836_800_000  # 2020-01-01T00:00:00Z
MAPPING = {"_doc": {"properties": {
    "title": {"type": "text"},
    "venue": {"type": "keyword"},
    "tags": {"type": "keyword"},
    "year": {"type": "long"},
    "price": {"type": "double"},
    "ts": {"type": "date"},
    "d2": {"type": "date", "format": "yyyy/MM/dd||epoch_millis"},
    "flag": {"type": "boolean"},
    "cit": {"type": "long"},
    "nums": {"type": "long"},
}}}


def seeded_docs(seed=21):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(30)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = []
    for i in range(N_DOCS):
        ms = EPOCH + int(rng.randint(0, 200)) * DAY + int(rng.randint(0, 24)) * 3_600_000
        src = {
            "title": " ".join(rng.choice(vocab, rng.randint(2, 9), p=p)),
            "venue": f"v{int(rng.zipf(1.5)) % 9}",
            "tags": [f"t{j}" for j in sorted(set(rng.randint(0, 6, rng.randint(1, 4))))],
            "year": int(1990 + rng.randint(30)),
            "price": float(rng.randint(0, 400)) / 4,
            # ISO strings, epoch millis and date-only strings
            "ts": (ms if i % 5 == 0 else
                   np.datetime_as_string(np.datetime64(ms, "ms")) + "Z"),
            "d2": f"{2019 + i % 3}/{1 + i % 12:02d}/{1 + i % 28:02d}",
            "flag": bool(rng.rand() > 0.4),
            "nums": [int(x) for x in rng.randint(0, 50, rng.randint(1, 4))],
        }
        if i % 10 != 3:
            src["cit"] = int(rng.randint(0, 500))
        if i % 17 == 0:
            src["extra_day"] = "2021-02-03"  # a dynamic date field
        docs.append((f"doc-{i}", src))
    return docs


def _make_nodes(name, body, docs):
    jn, tn = JNode(), Node(device="cpu")
    jn.create_index(name, {**body, "settings": {
        **body["settings"], "search": {"mesh": False},
        "requests": {"cache": {"enable": False}}}})
    tn.create_index(name, body)
    ops = [("index", {"_index": name, "_id": i}, d) for i, d in docs]
    assert not jn.bulk(ops, refresh=True)["errors"]
    assert not tn.bulk(ops, refresh=True)["errors"]
    return jn, tn


@pytest.fixture(scope="module")
def nodes():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = _make_nodes("aggs", {
        "settings": {"number_of_shards": 5, "refresh_interval": "-1"},
        "mappings": MAPPING}, seeded_docs())
    yield jn, tn
    jn.close()
    tn.close()
    mp.undo()


Q = {"match": {"title": "w0 w1 w3"}}

AGGS = {
    # --- metrics ---
    "metrics_year": {a: {a: {"field": "year"}} for a in (
        "min", "max", "sum", "avg", "stats", "extended_stats", "value_count")},
    "metrics_price": {a: {a: {"field": "price"}} for a in (
        "sum", "avg", "stats", "extended_stats")},
    "metrics_date": {"mn": {"min": {"field": "ts"}},
                     "st": {"stats": {"field": "ts"}}},
    "metrics_missing_param": {"a": {"avg": {"field": "cit", "missing": 7}},
                              "s": {"stats": {"field": "cit"}}},
    "metrics_keyword_ordinals": {"m": {"max": {"field": "venue"}}},
    "metrics_boolean": {"a": {"avg": {"field": "flag"}}},
    "metrics_multi_valued": {"s": {"extended_stats": {"field": "nums"}}},
    "cardinality": {"cv": {"cardinality": {"field": "venue"}},
                    "cy": {"cardinality": {"field": "year"}},
                    "ct": {"cardinality": {"field": "tags"}},
                    "cp": {"cardinality": {"field": "price",
                                           "precision_threshold": 10}},
                    "cx": {"cardinality": {"field": "nosuch"}}},
    "percentiles": {"p": {"percentiles": {"field": "price"}},
                    "q": {"percentiles": {"field": "ts",
                                          "percents": [10, 50, 99.9]}},
                    "e": {"percentiles": {"field": "nosuch"}}},
    "top_hits": {"th": {"top_hits": {"size": 4}}},
    "matrix_stats": {"ms": {"matrix_stats": {"fields": ["year", "price"]}}},
    # --- buckets ---
    "terms_keyword": {"v": {"terms": {"field": "venue", "size": 4}},
                      "k": {"terms": {"field": "venue",
                                      "order": {"_key": "desc"}}},
                      "c": {"terms": {"field": "venue",
                                      "order": {"_count": "asc"}}}},
    "terms_multi_valued": {"t": {"terms": {"field": "tags"}},
                           "n": {"terms": {"field": "nums", "size": 5}}},
    "terms_numeric_and_date": {"y": {"terms": {"field": "year", "size": 6}},
                               "p": {"terms": {"field": "price", "size": 3}},
                               "d": {"terms": {"field": "d2", "size": 3}}},
    "terms_sub_aggs": {"v": {"terms": {"field": "venue"}, "aggs": {
        "avg_year": {"avg": {"field": "year"}},
        "tags": {"terms": {"field": "tags", "size": 2}},
        "dh": {"date_histogram": {"field": "ts", "interval": "month"}}}}},
    "histogram": {"h": {"histogram": {"field": "price", "interval": 7.5}},
                  "o": {"histogram": {"field": "year", "interval": 4,
                                      "offset": 1, "min_doc_count": 0}},
                  "m": {"histogram": {"field": "cit", "interval": 50,
                                      "min_doc_count": 3}}},
    "histogram_sub_aggs": {"h": {"histogram": {
        "field": "year", "interval": 5, "min_doc_count": 0}, "aggs": {
            "s": {"sum": {"field": "price"}},
            "v": {"terms": {"field": "venue", "size": 2}}}}},
    "date_histogram_fixed": {
        "d": {"date_histogram": {"field": "ts", "interval": "1d"}},
        "w": {"date_histogram": {"field": "ts", "fixed_interval": "7d",
                                 "offset": 3_600_000}},
        "h": {"date_histogram": {"field": "ts", "interval": "12h",
                                 "min_doc_count": 1}}},
    "date_histogram_calendar": {
        "m": {"date_histogram": {"field": "ts", "calendar_interval": "month"}},
        "q": {"date_histogram": {"field": "ts", "interval": "quarter"}},
        "w": {"date_histogram": {"field": "ts", "interval": "week"}},
        "y": {"date_histogram": {"field": "d2", "interval": "year"}}},
    "date_histogram_sub_aggs": {"m": {"date_histogram": {
        "field": "ts", "interval": "month"}, "aggs": {
            "st": {"stats": {"field": "price"}},
            "c": {"cardinality": {"field": "venue"}}}}},
    "range": {"r": {"range": {"field": "price", "ranges": [
        {"to": 20}, {"from": 20, "to": 60.5}, {"from": 60.5},
        {"key": "mid", "from": 30, "to": 70}]}, "aggs": {
            "y": {"avg": {"field": "year"}}}}},
    "date_range": {"r": {"date_range": {"field": "ts", "ranges": [
        {"to": "2020-03-01"}, {"from": "2020-03-01", "to": "2020-05-15T12:00:00Z"},
        {"key": "late", "from": EPOCH + 150 * DAY}]}, "aggs": {
            "v": {"terms": {"field": "venue", "size": 2}}}}},
    "filter_filters": {
        "f": {"filter": {"term": {"venue": "v1"}}, "aggs": {
            "p": {"avg": {"field": "price"}}}},
        "fs": {"filters": {"filters": {
            "old": {"range": {"year": {"lt": 2000}}},
            "flagged": {"term": {"flag": True}},
            "march": {"range": {"ts": {"gte": "2020-03-01",
                                       "lt": "2020-04-01"}}}}}, "aggs": {
            "c": {"value_count": {"field": "cit"}}}},
        "fl": {"filters": {"filters": [{"match": {"title": "w2"}},
                                       {"terms": {"tags": ["t1", "t4"]}}]}}},
    "global_missing": {
        "g": {"global": {}, "aggs": {"v": {"terms": {"field": "venue"}}}},
        "m": {"missing": {"field": "cit"}, "aggs": {
            "y": {"stats": {"field": "year"}}}},
        "mx": {"missing": {"field": "extra_day"}},
        "mn": {"missing": {"field": "nosuch"}}},
    "significant_terms": {"s": {"significant_terms": {
        "field": "venue", "min_doc_count": 2}, "aggs": {
            "y": {"max": {"field": "year"}}}}},
    "adjacency_matrix": {"a": {"adjacency_matrix": {"filters": {
        "x": {"term": {"venue": "v1"}},
        "y": {"range": {"price": {"gte": 50}}},
        "z": {"term": {"flag": False}}}}, "aggs": {
            "p": {"sum": {"field": "price"}}}}},
    # --- pipelines ---
    "pipelines_embedded": {"m": {"date_histogram": {
        "field": "ts", "interval": "month"}, "aggs": {
            "s": {"sum": {"field": "price"}},
            "c": {"avg": {"field": "year"}},
            "d": {"derivative": {"buckets_path": "s"}},
            "cs": {"cumulative_sum": {"buckets_path": "s"}},
            "sd": {"serial_diff": {"buckets_path": "s", "lag": 2}},
            "ma": {"moving_avg": {"buckets_path": "s", "window": 3}},
            "ml": {"moving_avg": {"buckets_path": "s", "model": "linear"}},
            "me": {"moving_avg": {"buckets_path": "c", "model": "ewma",
                                  "settings": {"alpha": 0.5}}},
            "mh": {"moving_avg": {"buckets_path": "s", "model": "holt",
                                  "predict": 2}},
            "bs": {"bucket_script": {
                "buckets_path": {"a": "s", "b": "_count"},
                "script": "params.a / params.b"}}}}},
    "pipelines_holt_winters": {"h": {"histogram": {
        "field": "year", "interval": 2}, "aggs": {
            "s": {"sum": {"field": "price"}},
            "hw": {"moving_avg": {"buckets_path": "s", "window": 8,
                                  "model": "holt_winters", "predict": 3,
                                  "settings": {"period": 2, "type": "mult"}}},
            "ha": {"moving_avg": {"buckets_path": "s", "window": 8,
                                  "model": "holt_winters",
                                  "settings": {"period": 3}}}}}},
    "pipelines_selector_sort": {"v": {"terms": {"field": "venue"}, "aggs": {
        "p": {"avg": {"field": "price"}},
        "sel": {"bucket_selector": {"buckets_path": {"n": "_count"},
                                    "script": "params.n > 20"}},
        "srt": {"bucket_sort": {"sort": [{"p": {"order": "desc"}}],
                                "size": 3}}}}},
    "pipelines_siblings": {
        "m": {"date_histogram": {"field": "ts", "interval": "month"},
              "aggs": {"s": {"sum": {"field": "price"}}}},
        "v": {"terms": {"field": "venue"}, "aggs": {
            "st": {"stats": {"field": "year"}}}},
        "avg_m": {"avg_bucket": {"buckets_path": "m>s"}},
        "sum_m": {"sum_bucket": {"buckets_path": "m>s"}},
        "min_m": {"min_bucket": {"buckets_path": "m>_count"}},
        "max_v": {"max_bucket": {"buckets_path": "v>st.avg"}},
        "st_m": {"stats_bucket": {"buckets_path": "m>s"}}},
    "sampler": {
        "s": {"sampler": {"shard_size": 20}, "aggs": {
            "v": {"terms": {"field": "venue"}}}},
        "d": {"diversified_sampler": {"shard_size": 20, "field": "venue",
                                      "max_docs_per_value": 2}, "aggs": {
            "y": {"terms": {"field": "year", "size": 3}}}}},
}

# the query each request runs under (aggregations see the matched docs)
QUERIES = {
    "sampler": {"constant_score": {"filter": {"range": {"year": {
        "gte": 1995}}}}},
    "significant_terms": {"match": {"title": "w5 w6"}},
}


def assert_same_aggs(j, t, path="aggs"):
    """Exact equality, except top_hits hits (scores within RTOL, ids exact
    except among hits tied within it)."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), (path, j, t)
        if "hits" in j and isinstance(j["hits"], list):
            jh, th = j["hits"], t["hits"]
            assert len(jh) == len(th), path
            js = np.array([h["_score"] for h in jh])
            ts = np.array([h["_score"] for h in th])
            np.testing.assert_allclose(ts, js, rtol=RTOL)
            i = 0
            while i < len(jh):
                k = i + 1
                while k < len(jh) and abs(js[k] - js[i]) <= RTOL * js[i]:
                    k += 1
                if k < len(jh) or k - i == 1:  # a tie cut by size: skip
                    assert ({h["_id"] for h in jh[i:k]}
                            == {h["_id"] for h in th[i:k]}), path
                i = k
            assert {k: v for k, v in j.items() if k != "hits"} == \
                {k: v for k, v in t.items() if k != "hits"}, path
            return
        for key in j:
            assert_same_aggs(j[key], t[key], f"{path}.{key}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(j) == len(t), (path, j, t)
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same_aggs(a, b, f"{path}[{i}]")
    else:
        assert type(j) is type(t) and (j == t or (j != j and t != t)), \
            (path, j, t)


@pytest.mark.parametrize("name", sorted(AGGS))
def test_same_aggregations(nodes, name):
    jn, tn = nodes
    body = {"size": 0, "query": QUERIES.get(name, Q), "aggs": AGGS[name]}
    jr, tr = jn.search("aggs", body), tn.search("aggs", body)
    assert jr["_plane"] == tr["_plane"] == "host"
    assert jr["hits"]["total"] == tr["hits"]["total"]
    assert_same_aggs(jr["aggregations"], tr["aggregations"])


def test_same_aggregations_match_all(nodes):
    jn, tn = nodes
    body = {"size": 0, "aggs": {**AGGS["date_histogram_calendar"],
                                **AGGS["global_missing"]}}
    jr, tr = jn.search("aggs", body), tn.search("aggs", body)
    assert_same_aggs(jr["aggregations"], tr["aggregations"])


DATE_QUERIES = {
    "range_iso": {"range": {"ts": {"gte": "2020-03-01", "lt": "2020-04-01T00:00:00Z"}}},
    "range_epoch": {"range": {"ts": {"gt": EPOCH + 30 * DAY,
                                     "lte": EPOCH + 60 * DAY}}},
    "range_formatted": {"range": {"d2": {"gte": "2020/02/01",
                                         "lt": "2020/06/30"}}},
    "range_dynamic_date": {"range": {"extra_day": {"gte": "2021-01-01"}}},
    "term_date": {"term": {"d2": "2019/01/01"}},
    "terms_date": {"terms": {"d2": ["2019/01/01", "2020/02/02"]}},
    "term_boolean": {"term": {"flag": True}},
    "match_boolean": {"match": {"flag": "false"}},
    "range_boolean": {"range": {"flag": {"gte": True}}},
    "bool_mixed": {"bool": {"must": [{"match": {"title": "w1 w2"}}],
                            "filter": [{"range": {"ts": {"lt": "2020-05-01"}}},
                                       {"term": {"flag": False}}]}},
}


@pytest.mark.parametrize("name", sorted(DATE_QUERIES))
def test_date_and_boolean_queries(nodes, name):
    from test_torch_search import assert_same_hits

    jn, tn = nodes
    body = {"query": DATE_QUERIES[name], "size": N_DOCS}
    jr, tr = jn.search("aggs", body), tn.search("aggs", body)
    assert jr["hits"]["total"] == tr["hits"]["total"] > 0
    assert_same_hits(jr, tr)


def test_date_and_boolean_mapping(nodes):
    jn, tn = nodes
    jm = jn.indices["aggs"].mapping_dict()
    tm = tn.indices["aggs"].mapping_dict()
    assert tm["properties"]["extra_day"] == jm["properties"]["extra_day"] \
        == {"type": "date"}
    for node in (jn, tn):
        node.create_index("dyn", {"settings": {"number_of_shards": 1}})
    try:
        doc = {"when": "2021-05-06T07:08:09Z", "ok": True, "n": 1}
        jn.index_doc("dyn", "1", doc)
        tn.index_doc("dyn", "1", doc)
        assert (tn.indices["dyn"].mapping_dict()
                == jn.indices["dyn"].mapping_dict())
        assert tn.indices["dyn"].mapping_dict()["properties"]["ok"] == {
            "type": "boolean"}
        for bad in ({"ok": "yes"}, {"when": "not a date"}):
            with pytest.raises(Exception) as je:
                jn.index_doc("dyn", "2", bad)
            with pytest.raises(MapperParsingException) as te:
                tn.index_doc("dyn", "2", bad)
            assert type(je.value).__name__ == type(te.value).__name__
    finally:
        jn.delete_index("dyn")
        tn.delete_index("dyn")


def test_unported_aggregations_raise(nodes):
    """A reverse_nested outside a nested raises as in the JAX package;
    scripted_metric (ported with ``script/``), nested (a path the index
    lacks) and children (no join field) answer as the JAX package
    does."""
    jn, tn = nodes
    with pytest.raises(ParsingException):
        tn.search("aggs", {"size": 0, "aggs": {"r": {"reverse_nested": {}}}})
    for aggs in ({"n": {"nested": {"path": "x"}}},
                 {"s": {"scripted_metric": {"map_script": "1"}}},
                 {"v": {"terms": {"field": "venue"},
                        "aggs": {"c": {"children": {"type": "x"}}}}}):
        body = {"size": 0, "aggs": aggs}
        assert (tn.search("aggs", dict(body))["aggregations"]
                == jn.search("aggs", dict(body))["aggregations"])


@pytest.fixture(scope="module")
def sample_nodes():
    """One segment holding more than 100,000 values of a multi-valued
    field: the percentiles partial draws its sample there."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    rng = np.random.RandomState(31)
    docs = [(str(i), {"v": [float(x) for x in np.round(rng.randn(64) * 400) / 4],
                      "k": f"k{i % 3}"}) for i in range(1700)]
    jn, tn = _make_nodes("big", {"settings": {"number_of_shards": 1,
                                              "refresh_interval": "-1"},
                                 "mappings": {"_doc": {"properties": {
                                     "v": {"type": "double"},
                                     "k": {"type": "keyword"}}}}}, docs)
    yield jn, tn
    jn.close()
    tn.close()
    mp.undo()


@pytest.mark.parametrize("query", [None, {"term": {"k": "k1"}}])
def test_percentiles_across_the_sampling_threshold(sample_nodes, query):
    jn, tn = sample_nodes
    body = {"size": 0, "aggs": {
        "p": {"percentiles": {"field": "v", "percents": [1, 25, 50, 99]}},
        "s": {"stats": {"field": "v"}}}}
    if query is not None:
        body["query"] = query
    jr, tr = jn.search("big", body), tn.search("big", body)
    n = tr["aggregations"]["s"]["count"]
    assert (n > 100_000) == (query is None)
    assert_same_aggs(jr["aggregations"], tr["aggregations"])
