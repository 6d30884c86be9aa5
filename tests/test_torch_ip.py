"""The ip field: the port answers ``term`` and ``range`` as Elasticsearch
does, where the JAX package matches nothing (ROADMAP C12).

The JAX package keeps an ip field's doc values as an ordinal column of
formatted addresses, but its ``term`` and ``range`` builders read a
numeric column an ip field never has, so both answer ``total 0``. The
port resolves them through the ordinal column (each segment's vocabulary
mapped once through ``parse_ip`` to exact ints, IPv6 never in float64).
These tests state that one deviation side by side: the JAX answer is
empty, the port's equals a numpy oracle over the sources. ``terms``
aggregations and ``exists`` on ip already agree with the JAX package and
are held equal to it.
"""

import ipaddress

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.errors import MapperParsingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService

MAPPING = {"properties": {"ip": {"type": "ip"}, "title": {"type": "text"}}}


def addresses(n=60, seed=8):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if rng.rand() < 0.75:
            out.append(f"10.{rng.randint(0, 3)}.{rng.randint(0, 256)}."
                       f"{rng.randint(0, 256)}")
        else:
            out.append(str(ipaddress.IPv6Address(
                (0x20010db8 << 96) | (int(rng.randint(0, 4)) << 64)
                | int(rng.randint(0, 2 ** 31)))))
    return out


def seeded_docs(n=200, seed=8):
    rng = np.random.RandomState(seed)
    pool = addresses()
    docs = []
    for d in range(n):
        src = {"title": f"w{d % 4} x"}
        k = rng.choice([0, 1, 1, 1, 2])
        if k:
            vals = [pool[int(i)] for i in rng.randint(0, len(pool), k)]
            src["ip"] = vals if k > 1 else vals[0]
        docs.append((f"d{d}", src))
    return docs


def oracle(docs, pred):
    """The docs holding an address that satisfies ``pred`` (exact ints)."""
    out = []
    for doc_id, src in docs:
        vals = src.get("ip")
        vals = vals if isinstance(vals, list) else [vals] if vals else []
        if any(pred(int(ipaddress.ip_address(v))
                    if ":" in v else
                    int(ipaddress.IPv6Address(f"::ffff:{v}")))
               for v in vals):
            out.append(doc_id)
    return sorted(out)


def v6int(s):
    a = ipaddress.ip_address(s)
    return int(a) if a.version == 6 else int(
        ipaddress.IPv6Address(f"::ffff:{a}"))


@pytest.fixture(scope="module", params=["host", "mesh"])
def pair(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    mesh = request.param == "mesh"
    common = {"index.number_of_shards": 3, "index.refresh_interval": -1}
    if not mesh:
        common["index.search.mesh"] = False
    jidx = JIndex("ips", JSettings({**common,
                                    "index.requests.cache.enable": False}),
                  mapping=MAPPING)
    if mesh:
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService("ips", Settings(common), mapping=MAPPING,
                        device="cpu")
    docs = seeded_docs()
    for doc_id, src in docs:
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    yield request.param, jidx, tidx, docs
    jidx.close()
    tidx.close()
    mp.undo()


def ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


def cases(docs):
    first_v4 = next(v for _d, s in docs for v in
                    (s.get("ip") if isinstance(s.get("ip"), list)
                     else [s.get("ip")]) if v and ":" not in v)
    first_v6 = next(v for _d, s in docs for v in
                    (s.get("ip") if isinstance(s.get("ip"), list)
                     else [s.get("ip")]) if v and ":" in v)
    net16 = ipaddress.ip_network("10.1.0.0/16")
    net_v6 = ipaddress.ip_network("2001:db8:0:2::/64")
    v16 = (v6int(str(net16.network_address)),
           v6int(str(net16.broadcast_address)))
    return [
        ({"term": {"ip": first_v4}}, lambda v: v == v6int(first_v4)),
        ({"term": {"ip": first_v6}}, lambda v: v == v6int(first_v6)),
        # the ipv4-mapped spelling of the same address
        ({"term": {"ip": f"::ffff:{first_v4}"}},
         lambda v: v == v6int(first_v4)),
        ({"term": {"ip": "10.1.0.0/16"}}, lambda v: v16[0] <= v <= v16[1]),
        ({"term": {"ip": str(net_v6)}},
         lambda v: v6int(str(net_v6.network_address)) <= v
         <= v6int(str(net_v6.broadcast_address))),
        ({"range": {"ip": {"gte": "10.1.0.0", "lte": "10.1.255.255"}}},
         lambda v: v16[0] <= v <= v16[1]),
        ({"range": {"ip": {"gt": "10.0.128.0", "lt": "10.2.0.5"}}},
         lambda v: v6int("10.0.128.0") < v < v6int("10.2.0.5")),
        ({"range": {"ip": {"gte": "2001:db8:0:1::"}}},
         lambda v: v >= v6int("2001:db8:0:1::")),
        ({"range": {"ip": {"lt": "2001:db8::8000:0"}}},
         lambda v: v < v6int("2001:db8::8000:0")),
        # IPv6 bounds one apart: float64 would merge them
        ({"range": {"ip": {"gt": first_v6, "lte": first_v6}}},
         lambda v: False),
    ]


@pytest.mark.parametrize("case", range(10))
def test_term_and_range_answer_the_oracle_where_jax_finds_nothing(pair, case):
    mode, jidx, tidx, docs = pair
    query, pred = cases(docs)[case]
    want = oracle(docs, pred)
    for body in ({"query": query, "size": 300},
                 {"query": {"bool": {"must": {"match": {"title": "w1"}},
                                     "filter": query}}, "size": 300}):
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        # the JAX package (C12): a numeric column an ip field never has
        assert jr["hits"]["total"] == 0
        got = ids(tr)
        if "match" in str(body["query"]):
            want_b = sorted(set(want) & {d for d, s in docs
                                         if s["title"].startswith("w1")})
            assert got == want_b
        else:
            assert got == want
        assert tr["hits"]["total"] == len(got)
    if case in (0, 3, 5):
        assert want, "the case must match some docs"


def test_a_malformed_address_is_a_400_in_the_port(pair):
    """The JAX package returns no hit before it parses the value; the
    port parses it, so a malformed address is a mapper error (400), as
    in Elasticsearch."""
    _mode, jidx, tidx, _docs = pair
    for q in ({"term": {"ip": "10.1.0.300"}},
              {"range": {"ip": {"gte": "not-an-ip"}}}):
        assert jidx.search({"query": q})["hits"]["total"] == 0
        with pytest.raises(MapperParsingException,
                           match="is not an IP string literal"):
            tidx.search({"query": q})


@pytest.mark.parametrize("body", [
    {"size": 0, "aggs": {"a": {"terms": {"field": "ip", "size": 100}}}},
    {"size": 0, "query": {"match": {"title": "w2"}},
     "aggs": {"a": {"terms": {"field": "ip", "size": 7}}}},
    {"size": 0, "aggs": {"c": {"cardinality": {"field": "ip"}}}},
    {"query": {"exists": {"field": "ip"}}, "size": 300},
    {"query": {"terms": {"ip": ["10.0.0.1", "2001:db8::1"]}}, "size": 300},
])
def test_aggregations_and_exists_equal_jax(pair, body):
    _mode, jidx, tidx, _docs = pair
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert ids(tr) == ids(jr)
    assert tr.get("aggregations") == jr.get("aggregations")
