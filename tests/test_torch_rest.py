"""REST parity: the JAX package's ``HttpServer`` and the port's, over HTTP.

Both servers start on ephemeral ports on 127.0.0.1: the JAX ``Node`` with
its Pallas kernels in interpret mode (``ES_TPU_PALLAS=interpret``), the
port's ``Node(device="cpu")``. One script of requests (index admin, a
seeded ``_bulk`` with one bad line, document CRUD, ``_search`` with the
``test_torch_search`` bodies and URI parameters, ``_count``,
``_msearch``, cat and cluster APIs, and the error answers) goes to both.
Status codes and bodies must be equal, except ``took``, ``_plane``, the
index uuids (``uuid``, ``index.uuid``, ``cluster_uuid``) and auto-generated ids; scores
within rtol 1e-5 and ids per tie group, as in ``test_torch_search``. Every fixture stops its
servers and closes its nodes, so no JAX staging outlives the module.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu.common.thread_pool import ThreadPool as JThreadPool
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.rest import handlers as jhandlers
from elasticsearch_tpu.rest.http_server import HttpServer as JHttpServer
from elasticsearch_tpu_torch.common.thread_pool import ThreadPool
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest import handlers
from elasticsearch_tpu_torch.rest.http_server import HttpServer
from test_torch_search import N_DOCS, REQUESTS, RTOL, seeded_docs

# a typed 6.x mapping: responses echo the custom type name
MAPPING = {"paper": {"properties": {
    "title": {"type": "text"},
    "venue": {"type": "keyword"},
    "year": {"type": "long"},
}}}
INDEX_BODY = {"settings": {"number_of_shards": 5, "refresh_interval": "-1",
                           "search": {"mesh": False},
                           "requests": {"cache": {"enable": False}}},
              "mappings": MAPPING}
# keys that differ by construction: timings, the serving plane, uuids
VOLATILE = {"took", "_plane", "uuid", "index.uuid", "cluster_uuid"}


def call(port, method, path, body=None, ctype="application/json",
         headers=None):
    """One HTTP request -> (status, response headers, decoded body)."""
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    hdrs = dict(headers or {})
    if body is not None:
        hdrs["Content-Type"] = ctype
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        got_headers = {k: resp.getheader(k) for k in
                       ("Content-Type", "Warning", "Retry-After",
                        "X-Opaque-Id")}
    finally:
        conn.close()
    if raw and (got_headers["Content-Type"] or "").startswith(
            "application/json"):
        return resp.status, got_headers, json.loads(raw)
    return resp.status, got_headers, raw.decode()


def strip(obj):
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def assert_same_hits(jhits, thits, where):
    """Scores within RTOL; ids equal per run of scores tied within RTOL
    (order inside a tie may differ); then hit by hit on every other
    key."""
    js = np.array([h["_score"] for h in jhits], np.float64)
    ts = np.array([h["_score"] for h in thits], np.float64)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=1e-7, err_msg=where)
    i = 0
    while i < len(jhits):
        j = i + 1
        while j < len(jhits) and abs(js[j] - js[i]) <= RTOL * abs(js[i]) + 1e-7:
            j += 1
        assert ({h["_id"] for h in jhits[i:j]}
                == {h["_id"] for h in thits[i:j]}), where
        i = j
    by_id = {h["_id"]: h for h in thits}
    for h in jhits:
        assert_same_body({k: v for k, v in h.items() if k != "_score"},
                         {k: v for k, v in by_id[h["_id"]].items()
                          if k != "_score"}, f"{where}[{h['_id']}]")


def assert_same_body(jb, tb, where=""):
    """Equal after ``strip``, with floats within RTOL; a hits list
    compares through ``assert_same_hits``."""
    if isinstance(jb, dict) and isinstance(tb, dict):
        assert set(jb) == set(tb), (where, sorted(jb), sorted(tb))
        for k in jb:
            if (k == "hits" and isinstance(jb[k], list)
                    and isinstance(tb[k], list)):
                assert len(jb[k]) == len(tb[k]), where
                assert_same_hits(jb[k], tb[k], f"{where}.hits")
            else:
                assert_same_body(jb[k], tb[k], f"{where}.{k}")
    elif isinstance(jb, list) and isinstance(tb, list):
        assert len(jb) == len(tb), where
        for i, (a, b) in enumerate(zip(jb, tb)):
            assert_same_body(a, b, f"{where}[{i}]")
    elif isinstance(jb, float) and isinstance(tb, float):
        np.testing.assert_allclose(tb, jb, rtol=RTOL, err_msg=where)
    else:
        assert jb == tb, (where, jb, tb)


@pytest.fixture(scope="module")
def servers():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(), Node(device="cpu")
    js, ts = JHttpServer(jn, port=0), HttpServer(tn, port=0)
    js.start()
    ts.start()
    try:
        yield jn, tn, js.port, ts.port
    finally:
        js.stop()
        ts.stop()
        jn.close()
        tn.close()
        mp.undo()


def both(servers, method, path, body=None, ctype="application/json",
         status=None):
    """Send one request to both servers; statuses and bodies must
    agree."""
    _jn, _tn, jport, tport = servers
    js, jh, jb = call(jport, method, path, body, ctype)
    ts, th, tb = call(tport, method, path, body, ctype)
    assert js == ts, (method, path, js, ts, jb, tb)
    if status is not None:
        assert ts == status, (method, path, ts, tb)
    assert_same_body(strip(jb), strip(tb), f"{method} {path}")
    return tb, th, jh


def ndjson(lines):
    return ("\n".join(json.dumps(x) for x in lines) + "\n").encode()


@pytest.fixture(scope="module")
def loaded(servers):
    """The script's write half: create, bulk with one bad line, refresh."""
    both(servers, "PUT", "/idx", INDEX_BODY, status=200)
    lines = []
    for i, src in seeded_docs():
        lines += [{"index": {"_index": "idx", "_id": i}}, src]
    lines += [{"create": {"_index": "idx", "_id": "bad-1"}},
              {"title": "w1 w2", "year": "not-a-year"},
              {"delete": {"_index": "idx", "_id": "never-indexed"}},
              {"create": {"_index": "idx", "_id": "doc-0"}}, {"title": "dup"}]
    r, _, _ = both(servers, "POST", "/_bulk?refresh=false", ndjson(lines),
                   "application/x-ndjson", status=200)
    assert r["errors"] is True
    statuses = [next(iter(it.values()))["status"] for it in r["items"]]
    assert statuses[-3:] == [400, 404, 409]
    assert r["items"][-3]["create"]["error"]["type"] == \
        "mapper_parsing_exception"
    both(servers, "POST", "/idx/_refresh", status=200)
    return servers


def test_root(servers):
    _jn, tn, jport, tport = servers
    js, _, jb = call(jport, "GET", "/")
    ts, _, tb = call(tport, "GET", "/")
    assert js == ts == 200
    for b in (jb, tb):
        b.pop("tagline")
        b.pop("cluster_uuid")
    assert jb["version"].pop("build_flavor") == "tpu"
    assert tb["version"].pop("build_flavor") == "torch-cpu"
    assert jb == tb
    assert call(tport, "HEAD", "/")[0] == call(jport, "HEAD", "/")[0] == 200


def test_index_admin(loaded):
    both(loaded, "GET", "/idx", status=200)
    both(loaded, "HEAD", "/idx", status=200)
    both(loaded, "HEAD", "/nope", status=404)
    both(loaded, "GET", "/idx/_mapping", status=200)
    both(loaded, "GET", "/idx/_mapping/paper", status=200)
    both(loaded, "GET", "/idx/_settings", status=200)
    both(loaded, "GET", "/idx/_settings?flat_settings=true", status=200)
    both(loaded, "PUT", "/idx", INDEX_BODY, status=400)
    both(loaded, "PUT", "/Bad", {}, status=400)
    both(loaded, "GET", "/idx*/_mapping", status=200)


def test_documents(loaded):
    both(loaded, "GET", "/idx/_doc/doc-7", status=200)
    both(loaded, "GET", "/idx/paper/doc-7", status=200)
    both(loaded, "GET", "/idx/_doc/doc-7?_source=venue,year", status=200)
    both(loaded, "GET", "/idx/_doc/doc-7?_source=false", status=200)
    both(loaded, "GET", "/idx/_doc/doc-7?_source_excludes=title",
         status=200)
    both(loaded, "GET", "/idx/_source/doc-7", status=200)
    both(loaded, "HEAD", "/idx/_doc/doc-7", status=200)
    both(loaded, "HEAD", "/idx/_doc/missing", status=404)
    both(loaded, "GET", "/idx/_doc/missing", status=404)
    both(loaded, "GET", "/idx/_doc/bad-1", status=404)
    both(loaded, "GET", "/nope/_doc/doc-7", status=404)
    both(loaded, "GET", "/idx/_doc/doc-7?version=2", status=409)
    # writes: a version conflict, a create over an existing doc, typed
    # paths (with the deprecation warning), routing, refresh
    both(loaded, "PUT", "/idx/_doc/doc-8?version=3", {"title": "x"},
         status=409)
    both(loaded, "PUT", "/idx/_create/doc-8", {"title": "x"}, status=409)
    _, th, jh = both(loaded, "PUT", "/idx/paper/extra-1",
                     {"title": "w3 extra", "venue": "venue1", "year": 2001},
                     status=201)
    for h in (th, jh):
        assert "specifying a custom type" in h["Warning"]
    both(loaded, "PUT", "/idx/_doc/extra-1?version=1",
         {"title": "w3 extra again", "venue": "venue1", "year": 2002},
         status=200)
    both(loaded, "PUT", "/idx/_doc/extra-2?routing=r7&refresh=true",
         {"title": "w5 routed", "venue": "venue2", "year": 2003},
         status=201)
    both(loaded, "GET", "/idx/_doc/extra-2?routing=r7", status=200)
    both(loaded, "POST", "/idx/_doc/extra-3/_create",
         {"title": "w6", "venue": "venue3", "year": 2004}, status=201)
    both(loaded, "DELETE", "/idx/_doc/extra-3", status=200)
    both(loaded, "DELETE", "/idx/_doc/extra-3", status=404)
    both(loaded, "DELETE", "/idx/_doc/extra-1?version=9", status=409)
    # an auto-generated id, in an index of its own (one shard)
    both(loaded, "PUT", "/auto", {"settings": {"number_of_shards": 1}},
         status=200)
    _jn, _tn, jport, tport = loaded
    ids = []
    for port in (jport, tport):
        st, _, r = call(port, "POST", "/auto/_doc", {"title": "auto"})
        assert st == 201
        ids.append(r.pop("_id"))
        assert len(ids[-1]) == 20
    assert ids[0] != ids[1]
    both(loaded, "POST", "/_refresh", status=200)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_search(loaded, name):
    body = dict(REQUESTS[name])
    body.setdefault("size", N_DOCS + 10)
    both(loaded, "POST", "/idx/_search", body, status=200)
    both(loaded, "POST", "/idx/paper/_search", body, status=200)


def test_search_dates_and_aggregations(servers):
    """Dates, booleans and the aggregation framework over HTTP: dynamic
    date mapping, ``key_as_string``, a ``date_range`` with string bounds,
    ``typed_keys`` (both servers ignore it), a ``nested`` aggregation on a
    path that is not nested (both answer an empty bucket), and an
    unported aggregation's 400."""
    both(servers, "PUT", "/ev", {"settings": {"number_of_shards": 2,
                                              "refresh_interval": "-1"}},
         status=200)
    lines = []
    for i in range(40):
        lines += [{"index": {"_index": "ev", "_id": str(i)}},
                  {"when": f"2021-0{1 + i % 3}-{1 + i % 27:02d}T0{i % 9}:00:00Z",
                   "ok": i % 4 == 0, "n": i % 7}]
    both(servers, "POST", "/_bulk?refresh=true", ndjson(lines),
         "application/x-ndjson", status=200)
    both(servers, "GET", "/ev/_mapping", status=200)
    aggs = {"size": 0, "query": {"range": {"when": {"gte": "2021-01-15"}}},
            "aggs": {"m": {"date_histogram": {"field": "when",
                                              "interval": "month"},
                           "aggs": {"s": {"sum": {"field": "n"}},
                                    "d": {"derivative": {
                                        "buckets_path": "s"}}}},
                     "r": {"date_range": {"field": "when", "ranges": [
                         {"to": "2021-02-01"}, {"from": "2021-02-01"}]}},
                     "b": {"avg": {"field": "ok"}},
                     "c": {"cardinality": {"field": "n"}}}}
    both(servers, "POST", "/ev/_search", aggs, status=200)
    both(servers, "POST", "/ev/_search?typed_keys=true", aggs, status=200)
    both(servers, "POST", "/ev/_search", {"aggs": {"x": {"no_such": {}}}},
         status=400)
    both(servers, "POST", "/ev/_search", {
        "size": 0, "aggs": {"g": {"nested": {"path": "when"}}}}, status=200)
    both(servers, "POST", "/ev/_search", {
        "aggs": {"g": {"scripted_metric": {"map_script": "1"}}}}, status=200)
    both(servers, "DELETE", "/ev", status=200)


def test_search_uri_params(loaded):
    q = {"query": {"match": {"title": "w3 w17"}}}
    both(loaded, "GET", "/idx/_search?size=7&from=3", q, status=200)
    both(loaded, "GET", "/idx/_search?size=5&sort=_score", q, status=200)
    both(loaded, "GET", "/idx/_search?size=5&sort=_score:desc", q,
         status=200)
    both(loaded, "GET", "/idx/_search?_source=venue&size=4", q, status=200)
    both(loaded, "GET", "/idx/_search?_source=false&size=4", q, status=200)
    both(loaded, "GET", "/idx/_search", status=200)


def test_count_and_msearch(loaded):
    both(loaded, "POST", "/idx/_count", REQUESTS["match_or"], status=200)
    both(loaded, "GET", "/idx/_count", status=200)
    lines = []
    for name in ("match_or", "bool_filtered", "terms_agg"):
        lines += [{"index": "idx"}, REQUESTS[name]]
    lines += [{"index": "nope"}, {"query": {"match_all": {}}},
              {}, {"query": {"bogus": {}}}]
    r, _, _ = both(loaded, "POST", "/idx/_msearch", ndjson(lines),
                   "application/x-ndjson", status=200)
    assert [x.get("status", 200) for x in r["responses"]] == \
        [200, 200, 200, 404, 400]


def test_uri_search_q_on_search_and_count(loaded):
    """``?q=`` is a query_string query, with ``df``, ``default_operator``,
    ``analyzer`` and ``lenient``, on ``_search`` and on ``_count``."""
    for path in ("/idx/_search?q=title:w3&size=50",
                 "/idx/_search?q=w3%20w17&default_operator=AND&size=50",
                 "/idx/_search?q=w5&df=title&size=50",
                 "/idx/_search?q=%22w0%20w1%22&df=title&size=50",
                 "/idx/_search?q=W2&df=title&analyzer=whitespace",
                 "/idx/_search?q=year:abc&lenient=true",
                 "/idx/_count?q=title:w3",
                 "/idx/_count?q=venue:venue1%20AND%20title:w2"):
        both(loaded, "GET", path, status=200)
    both(loaded, "GET", "/idx/_search?q=year:abc")


SORT_BODIES = {
    "sort_year": {"query": {"match": {"title": "w3"}},
                  "sort": [{"year": "desc"}, {"venue": "asc"}], "size": 9},
    "search_after": {"query": {"match": {"title": "w3"}},
                     "sort": [{"year": "desc"}, {"venue": "asc"}],
                     "search_after": [2010, "venue3"], "size": 9},
    "keyword_missing": {"query": {"match_all": {}}, "size": 12,
                        "sort": [{"venue": {"order": "desc",
                                            "missing": "_first"}}]},
    "slice": {"query": {"match_all": {}}, "slice": {"id": 1, "max": 3},
              "size": 20},
    "rescore": {"query": {"match": {"title": "w3 w5"}}, "size": 6,
                "rescore": {"window_size": 4, "query": {
                    "rescore_query": {"match": {"title": "w7"}},
                    "score_mode": "max"}}},
    "terminate_after": {"query": {"match": {"title": "w2"}},
                        "terminate_after": 3},
    "collapse": {"query": {"match": {"title": "w1"}}, "size": 4,
                 "collapse": {"field": "venue", "inner_hits": {
                     "name": "v", "size": 2, "sort": [{"year": "asc"}]}}},
    "highlight": {"query": {"match": {"title": "w1 w4"}}, "size": 3,
                  "highlight": {"fields": {"title": {}}}},
}


@pytest.mark.parametrize("name", sorted(SORT_BODIES))
def test_search_sort_and_paging_bodies(loaded, name):
    both(loaded, "POST", "/idx/_search", SORT_BODIES[name], status=200)


def test_scroll_routes(loaded):
    """``?scroll=`` opens a scroll; the four next-page routes (POST and
    GET, id in the body or the path) page through it; the two DELETE
    routes clear one id, a list, or every context; an unknown id is a 404.
    Each page equals the JAX server's (the scroll ids differ)."""
    _jn, _tn, jport, tport = loaded
    body = {"query": {"match": {"title": "w1"}}, "size": 7,
            "sort": [{"year": "desc"}, {"venue": "asc"}]}
    pages = {}
    for key, port in (("jax", jport), ("port", tport)):
        st, _, first = call(port, "POST", "/idx/_search?scroll=1m", body)
        assert st == 200
        sid = first.pop("_scroll_id")
        got = [first]
        for method, path, b in (
                ("POST", "/_search/scroll", {"scroll": "1m",
                                             "scroll_id": sid}),
                ("GET", f"/_search/scroll/{sid}?scroll=1m", None),
                ("POST", f"/_search/scroll/{sid}", None),
                ("GET", "/_search/scroll", {"scroll_id": sid})):
            st, _, page = call(port, method, path, b)
            assert st == 200, (path, page)
            assert page.pop("_scroll_id") == sid
            got.append(page)
        st, _, second = call(port, "GET", "/idx/_search?scroll=1m&size=3")
        sid2 = second.pop("_scroll_id")
        got.append(second)
        got.append(call(port, "DELETE", f"/_search/scroll/{sid}")[::2])
        got.append(call(port, "DELETE", f"/_search/scroll/{sid}")[::2])
        st, _, err = call(port, "GET", f"/_search/scroll/{sid}")
        assert sid in err["error"]["reason"]
        err["error"]["reason"] = err["error"]["reason"].replace(sid, "<id>")
        got.append((st, err))
        got.append(call(port, "DELETE", "/_search/scroll",
                        {"scroll_id": [sid2]})[::2])
        call(port, "POST", "/idx/_search?scroll=1m", body)
        got.append(call(port, "DELETE", "/_search/scroll")[::2])
        pages[key] = got
    assert len(pages["port"]) == len(pages["jax"])
    for i, (jp, tp) in enumerate(zip(pages["jax"], pages["port"])):
        assert_same_body(strip(jp), strip(tp), f"scroll step {i}")
    ids = [h["_id"] for p in pages["port"][:5] for h in p["hits"]["hits"]]
    assert len(ids) == len(set(ids)) == 35
    assert [p[0] for p in pages["port"][6:]] == [200, 404, 404, 200, 200]


def test_cat_and_cluster(loaded):
    both(loaded, "GET", "/_cat/indices?format=json", status=200)
    both(loaded, "GET", "/_cat/indices/idx?format=json&h=index,docs.count",
         status=200)
    both(loaded, "GET", "/_cat/indices?v&h=index,pri,rep,docs.count",
         status=200)
    both(loaded, "GET", "/_cat/health?format=json&ts=false", status=200)
    both(loaded, "GET", "/_cluster/health", status=200)
    _jn, _tn, jport, tport = loaded
    counts = [call(p, "GET", "/_cat/count/idx?format=json")[2][0]["count"]
              for p in (jport, tport)]
    assert counts[0] == counts[1] > 0
    both(loaded, "POST", "/_analyze",
         {"text": "Hello W3 world", "analyzer": "standard"}, status=200)
    both(loaded, "POST", "/idx/_analyze", {"text": "Hello W3",
                                           "field": "title"}, status=200)


def test_errors(loaded):
    both(loaded, "GET", "/nope/_search", status=404)
    both(loaded, "POST", "/idx/_search", {"query": {"bogus": {}}},
         status=400)
    both(loaded, "POST", "/idx/_search", b"{not json", status=400)
    both(loaded, "DELETE", "/_search", status=405)
    both(loaded, "GET", "/_foo/bar/baz/qux", status=400)
    both(loaded, "POST", "/_bulk", b"", "application/x-ndjson", status=400)


def test_flush_synced_flush_and_forcemerge(loaded):
    for method, path in (("POST", "/idx/_flush"), ("GET", "/idx/_flush"),
                         ("POST", "/_flush"), ("POST", "/idx/_flush/synced"),
                         ("POST", "/_flush/synced"),
                         ("GET", "/idx/_flush/synced"),
                         ("POST", "/idx/_forcemerge"),
                         ("POST", "/_forcemerge")):
        both(loaded, method, path, status=200)
    for path in ("/nope/_flush", "/nope/_flush/synced", "/nope/_forcemerge"):
        both(loaded, "POST", path, status=404)
    # both packages merged their shards alike: the answers still agree
    both(loaded, "POST", "/idx/_search",
         {"query": {"match": {"title": "w3 w17"}}, "size": 50}, status=200)
    _jn, tn, _, _ = loaded
    assert all(len(s.engine.segments) <= 1
               for s in tn.indices["idx"].shards.values())


def test_wait_for_active_shards(loaded):
    # one node: each shard's primary is its one active copy, and idx has
    # one replica that cannot be assigned
    both(loaded, "PUT", "/idx/_doc/w1?wait_for_active_shards=2",
         {"title": "w1"}, status=503)
    both(loaded, "PUT", "/idx/_doc/w1?wait_for_active_shards=all",
         {"title": "w1"}, status=503)
    both(loaded, "POST", "/idx/_doc?wait_for_active_shards=3",
         {"title": "w1"}, status=503)
    both(loaded, "PUT", "/idx/_doc/w1?wait_for_active_shards=many",
         {"title": "w1"}, status=400)
    both(loaded, "PUT", "/idx/_doc/w1?wait_for_active_shards=1",
         {"title": "w1"}, status=201)
    both(loaded, "GET", "/idx/_doc/w1?wait_for_active_shards=2",
         status=200)


def test_delete_index_last(loaded):
    both(loaded, "DELETE", "/auto", status=200)
    both(loaded, "DELETE", "/nope", status=404)
    both(loaded, "DELETE", "/nope?ignore_unavailable=true", status=200)
    both(loaded, "DELETE", "/idx", status=200)
    both(loaded, "GET", "/idx/_search", status=404)
    both(loaded, "GET", "/_cat/indices?format=json", status=200)


def test_route_table_equals_jax():
    class Recorder:
        def __init__(self):
            self.pairs = []

        def register(self, method, pattern, _handler):
            self.pairs.append((method, pattern))

    want, got = Recorder(), Recorder()
    jhandlers.register_all(want)
    handlers.register_all(got)
    assert got.pairs == want.pairs
    assert len(got.pairs) > 200


def test_unported_route_answers_400():
    tn = Node(device="cpu")
    srv = HttpServer(tn, port=0)
    srv.start()
    try:
        tn.create_index("i", {"settings": {"number_of_shards": 1}})
        for method, path in (("POST", "/_cluster/reroute"),
                             ("GET", "/_remote/info"),
                             ("GET", "/_cat/plugins")):
            st, _, b = call(srv.port, method, path, {})
            assert st == 400, (path, b)
            assert b["error"]["type"] == "illegal_argument_exception"
            assert "not supported by the PyTorch port yet" in \
                b["error"]["reason"], (path, b)
        # ported since: track_total_hits, _explain, _all search and
        # _cache/clear answer
        for method, path in (("GET", "/i/_search?track_total_hits=true"),
                             ("GET", "/i/_explain/1"),
                             ("GET", "/_search"),
                             ("POST", "/_cache/clear"),
                             ("POST", "/i/_cache/clear")):
            st, _, b = call(srv.port, method, path, {})
            assert st == 200, (path, b)
        # ported since: _update and _mget (a missing doc is a 404, an
        # empty mget a validation error) and a bulk update line
        st, _, b = call(srv.port, "POST", "/i/_update/1", {"doc": {"a": 1}})
        assert st == 404 and b["error"]["type"] == "document_missing_exception"
        st, _, b = call(srv.port, "GET", "/_mget", {})
        assert st == 400 and \
            b["error"]["type"] == "action_request_validation_exception"
        st, _, b = call(srv.port, "POST", "/_bulk", ndjson([
            {"update": {"_index": "i", "_id": "1"}}, {"doc": {"a": 1}}]),
            "application/x-ndjson")
        assert st == 200 and b["errors"]
        assert b["items"][0]["update"]["status"] == 404
        st, h, _ = call(srv.port, "GET", "/", headers={"X-Opaque-Id": "c7"})
        assert st == 200 and h["X-Opaque-Id"] == "c7"
        # ported since: hot threads (text) and the drain and undrain
        st, h, b = call(srv.port, "GET", "/_nodes/hot_threads")
        assert st == 200 and h["Content-Type"].startswith("text/plain")
        assert "Hot threads sampled" in b
        st, _, b = call(srv.port, "POST", "/_nodes/_local/_drain")
        assert st == 200 and b["draining"] and b["drained"]
        st, _, b = call(srv.port, "DELETE", "/_nodes/_local/_drain")
        assert st == 200 and b == {"draining": False}
        # ported since: the cluster metadata (a missing stored script is a
        # 404, the node's stats a 200)
        st, _, b = call(srv.port, "GET", "/_scripts/s1", {})
        assert st == 404 and b["error"]["type"] == \
            "resource_not_found_exception"
        st, _, b = call(srv.port, "GET", "/_nodes/stats", {})
        assert st == 200 and len(b["nodes"]) == 1
    finally:
        srv.stop()
        tn.close()


def test_full_search_queue_answers_429_like_jax():
    """A search pool of 1 thread and queue 1: with the thread busy and
    one request queued, a third concurrent request gets 429, in the JAX
    package's body shape, with a Retry-After header."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(), Node(device="cpu")
    out = {}
    servers_ = []
    try:
        for key, node, pool_cls in (("jax", jn, JThreadPool),
                                    ("torch", tn, ThreadPool)):
            node.thread_pool.shutdown()
            node.thread_pool = pool_cls(
                overrides={"search": {"threads": 1, "queue_size": 1}})
            srv = (JHttpServer if key == "jax" else HttpServer)(node, port=0)
            srv.start()
            servers_.append(srv)
            release = threading.Event()
            busy = node.thread_pool.submit("search", release.wait)
            pool = node.thread_pool.executor("search")
            for _ in range(3000):  # until the one worker holds it
                if pool.stats().active == 1:
                    break
                time.sleep(0.01)
            queued = node.thread_pool.submit("search", lambda: None)
            try:
                out[key] = call(srv.port, "GET", "/_search")
            finally:
                release.set()
                busy.result(timeout=30)
                queued.result(timeout=30)
    finally:
        for srv in servers_:
            srv.stop()
        jn.close()
        tn.close()
        mp.undo()
    (js, jh, jb), (ts, th, tb) = out["jax"], out["torch"]
    assert js == ts == 429
    assert tb == jb
    assert tb["error"]["type"] == "es_rejected_execution_exception"
    assert th["Retry-After"] == jh["Retry-After"] == "1"


def test_delete_index_releases_staging():
    """``delete_index`` closes the index: every segment's device arrays
    and kernel tables and the mesh plane's staging are dropped while the
    index service and its segments are still referenced, so no staged
    tensor outlives the delete."""
    import gc
    import weakref

    tn = Node(device="cpu")
    try:
        tn.create_index("m", {"settings": {"number_of_shards": 2},
                              "mappings": MAPPING})
        ops = [("index", {"_index": "m", "_id": i}, d)
               for i, d in seeded_docs()[:120]]
        assert not tn.bulk(ops, refresh=True)["errors"]
        r = tn.search("m", {"query": {"match": {"title": "w3 w17"}},
                            "aggs": {"v": {"terms": {"field": "venue"}}}})
        assert r["_plane"] == "mesh_pallas"
        # a host reduce (the sub-aggregation keeps it off the fused plane)
        # stages the segments' doc-value columns too
        r = tn.search("m", {"query": {"match": {"title": "w3 w17"}},
                            "aggs": {"v": {"terms": {"field": "venue"},
                                           "aggs": {"y": {"cardinality": {
                                               "field": "year"}}}}}})
        assert r["_plane"] == "mesh_pallas"
        svc = tn.indices["m"]
        segs = [seg for sh in svc.shards.values() for seg in sh.engine.segments]
        executor = svc._mesh_search._executor
        staged = [t for seg in segs for t in seg.device_arrays().values()]
        staged += [t for seg in segs for tables in seg._kernel_tables.values()
                   for t in tables.values()]
        staged += [t for seg in segs for t in seg.dev_cache.values()]
        staged += list(executor._seg_staged.values())
        assert any(seg.dev_cache for seg in segs)
        assert any(k.startswith("maggs.") for k in executor._seg_staged)
        refs = [weakref.ref(t) for t in staged]
        del staged, r
        assert tn.delete_index("m") == {"acknowledged": True}
        gc.collect()
        assert [ref for ref in refs if ref() is not None] == []
        assert svc._mesh_search._executor is None
        assert not svc._batcher.enabled
        assert all(seg.staged_bytes() == 0 for seg in segs)
        with pytest.raises(Exception, match="no such index"):
            tn.search("m", {})
    finally:
        tn.close()


def test_thread_pool_rejects_and_shuts_down_like_jax():
    """A full queue raises the 429 exception with a Retry-After estimate;
    shutdown fails queued work instead of stranding its caller; stats
    count the rejection."""
    for pool_cls in (ThreadPool, JThreadPool):
        pool = pool_cls(overrides={"search": {"threads": 1,
                                              "queue_size": 1}})
        release = threading.Event()
        busy = pool.submit("search", release.wait)
        ex = pool.executor("search")
        for _ in range(3000):
            if ex.stats().active == 1:
                break
            time.sleep(0.01)
        queued = pool.submit("search", lambda: 7)
        with pytest.raises(Exception) as info:
            pool.submit("search", lambda: None)
        assert info.value.status_code == 429
        assert 1.0 <= info.value.retry_after_s <= 30.0
        assert pool.stats()["search"]["rejected"] == 1
        release.set()
        assert busy.result(timeout=30) is True
        assert queued.result(timeout=30) == 7
        blocker = threading.Event()
        pool.submit("write", blocker.wait)
        pool.shutdown()
        blocker.set()
        with pytest.raises(Exception) as info:
            pool.submit("search", lambda: None)
        assert info.value.status_code == 429


@pytest.mark.parametrize("resp,body", [
    ({"hits": {"total": 9}}, {}),
    ({"hits": {"total": 9}, "_pruned": {"tiles_scored": 3,
                                        "tiles_pruned": 5,
                                        "total_relation": "gte"}}, {}),
    ({"hits": {"total": 9}, "_total_relation": "gte"}, {}),
    ({"hits": {"total": 9}}, {"track_total_hits": True}),
    ({"hits": {"total": 9}}, {"track_total_hits": 100}),
    ({"hits": {"total": 9}}, {"track_total_hits": False}),
    ({"hits": {"total": {"value": 9, "relation": "eq"}}}, {}),
    ({"error": {"type": "x"}, "status": 404}, {}),
])
def test_render_total_hits_same_as_jax(resp, body):
    """Pruned and hybrid totals render as {"value", "relation": "gte"};
    an explicit track_total_hits renders the object form too."""
    want = json.loads(json.dumps(resp))
    got = json.loads(json.dumps(resp))
    jhandlers._render_total_hits(want, body)
    handlers._render_total_hits(got, body)
    assert got == want
    if "_pruned" in resp or "_total_relation" in resp:
        assert got["hits"]["total"] == {"value": 9, "relation": "gte"}


# ---------------------------------------------------------------------------
# The legacy _parent field: the parent parameter, its registry across a
# restart (tests/test_gateway.py's TestParentRegistryRestart)
# ---------------------------------------------------------------------------


def _durable_pair(tmp_path):
    """A JAX and a port node over their own data paths, each behind its
    HTTP server: (jn, tn, jport, tport, stop)."""
    jn = JNode(data_path=str(tmp_path / "j"))
    tn = Node(data_path=str(tmp_path / "t"), device="cpu")
    js, ts = JHttpServer(jn, port=0), HttpServer(tn, port=0)
    js.start()
    ts.start()

    def stop():
        js.stop()
        ts.stop()
        jn.close()
        tn.close()
    return jn, tn, js.port, ts.port, stop


def test_parents_survive_flush_restart(tmp_path):
    jn, tn, _jp, _tp, stop = _durable_pair(tmp_path)
    try:
        for n in (jn, tn):
            n.create_index("join", {"settings": {"index": {
                "number_of_shards": 2}}})
            n.index_doc("join", "c1", {"k": "v1"}, routing="p1",
                        parent="p1")
            n.index_doc("join", "c2", {"k": "v2"}, routing="p2",
                        parent="p2")
            n.index_doc("join", "plain", {"k": "v3"})
            n.indices["join"].flush()
            # one more child after the flush: back through the translog
            n.index_doc("join", "c3", {"k": "v4"}, routing="p3",
                        parent="p3")
    finally:
        stop()
    jn, tn, _jp, _tp, stop = _durable_pair(tmp_path)
    try:
        want = {"c1": "p1", "c2": "p2", "c3": "p3"}
        assert jn.indices["join"].parents == want
        assert tn.indices["join"].parents == want
    finally:
        stop()


def test_parent_surfaces_in_stored_fields_after_restart(tmp_path):
    """``PUT ?parent=`` routes by the parent; after a flush and a restart
    ``GET ?stored_fields=_parent`` still returns it, in both servers."""
    jn, tn, jport, tport, stop = _durable_pair(tmp_path)
    pair = (jn, tn, jport, tport)
    try:
        both(pair, "PUT", "/pidx/_doc/child?parent=par-7", {"msg": "x"},
             status=201)
        jn.indices["pidx"].flush()
        tn.indices["pidx"].flush()
    finally:
        stop()
    jn, tn, jport, tport, stop = _durable_pair(tmp_path)
    pair = (jn, tn, jport, tport)
    try:
        r, _, _ = both(pair, "GET", "/pidx/_doc/child?stored_fields=_parent"
                       "&routing=par-7", status=200)
        assert r["_parent"] == "par-7" and "_source" not in r
        r, _, _ = both(pair, "GET", "/pidx/_doc/child?stored_fields="
                       "_source,_parent&parent=par-7", status=200)
        assert r["_parent"] == "par-7" and r["_source"] == {"msg": "x"}
    finally:
        stop()


def test_deleted_child_drops_from_rebuilt_registry(tmp_path):
    jn, tn, _jp, _tp, stop = _durable_pair(tmp_path)
    try:
        for n in (jn, tn):
            n.create_index("join2", {})
            n.index_doc("join2", "c1", {"k": "v"}, routing="p1", parent="p1")
            n.index_doc("join2", "c2", {"k": "v"}, routing="p1", parent="p1")
            n.indices["join2"].refresh()
            n.delete_doc("join2", "c2", routing="p1")
            n.indices["join2"].refresh()
            n.indices["join2"].flush()
    finally:
        stop()
    jn, tn, _jp, _tp, stop = _durable_pair(tmp_path)
    try:
        assert jn.indices["join2"].parents == {"c1": "p1"}
        assert tn.indices["join2"].parents == {"c1": "p1"}
    finally:
        stop()


def test_parent_mapped_index_requires_routing(tmp_path):
    """A ``_parent``-mapped type needs ``parent`` or ``routing`` on every
    single-doc op (400 ``routing_missing_exception``); ``parent`` routes
    the doc; ``_bulk`` takes ``parent`` in the action line."""
    jn, tn, jport, tport, stop = _durable_pair(tmp_path)
    pair = (jn, tn, jport, tport)
    try:
        both(pair, "PUT", "/legacy", {"settings": {"number_of_shards": 3},
                                      "mappings": {"answer": {
                                          "_parent": {"type": "question"},
                                          "properties": {
                                              "t": {"type": "text"}}}}},
             status=200)
        r, _, _ = both(pair, "PUT", "/legacy/answer/a1", {"t": "x"},
                       status=400)
        assert r["error"]["type"] == "routing_missing_exception"
        both(pair, "PUT", "/legacy/answer/a1?parent=q1", {"t": "x"},
             status=201)
        both(pair, "GET", "/legacy/answer/a1", status=400)
        r, _, _ = both(pair, "GET", "/legacy/answer/a1?parent=q1",
                       status=200)
        assert r["_routing"] == "q1"
        lines = [{"index": {"_index": "legacy", "_id": "a2",
                            "parent": "q2"}}, {"t": "y"},
                 {"index": {"_index": "legacy", "_id": "a3",
                            "_parent": "q2", "routing": "q2"}}, {"t": "z"}]
        r, _, _ = both(pair, "POST", "/_bulk?refresh=true", ndjson(lines),
                       "application/x-ndjson", status=200)
        assert r["errors"] is False
        assert tn.indices["legacy"].parents == jn.indices["legacy"].parents \
            == {"a1": "q1", "a2": "q2", "a3": "q2"}
    finally:
        stop()
