"""Parity of geo points with the JAX package: queries, sort, aggregations.

Mirrors tests/test_geo_script.py's ``TestGeoPolygon``, ``TestGeoDistanceSort``,
``TestGeoSortModes`` and ``TestSearchAfterNullSort`` (the ``script`` query
waits for ``script/``) and tests/test_aggs_extended.py's ``TestGeoAggs``:
each case runs on a JAX ``IndexService`` and a port ``IndexService(device=
"cpu")`` holding the same documents, and ids, sort values, bounds,
centroids (their bits) and buckets must be equal.

Added: ``geo_distance`` and ``geo_bounding_box`` under a ``match`` on the
one-device mesh plane and the host rung against the JAX package (plane,
ids, totals exact, scores rtol 1e-5, the mesh's decisions), a
``_geo_distance`` sort taking the host rung with ``sort_ineligible``, a
delta append of geo docs, and the vectorized geohash against the scalar
one. The distance filter is float32 in both packages, whose ``sin`` /
``asin`` may differ in the last bit: docs whose float64 distance lies
within 1e-5 of the radius (relative) are left out of the id comparison
and counted; every other doc must agree.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import ElasticsearchTpuException
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu.utils import geohash as jgeohash
from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.utils import geohash as tgeohash

RTOL = 1e-5


def hit_ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


def make_pair(name, mapping, docs, shards=1, mesh=False, settings=None):
    common = {"index.number_of_shards": shards, "index.refresh_interval": -1,
              **(settings or {})}
    if not mesh:
        common["index.search.mesh"] = False
    jidx = JIndex(name, JSettings({
        **common, "search.aggs.fused": False,
        "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=mapping)
    if mesh:
        # the port serves one device: give the JAX plane a one-device mesh
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common), mapping=mapping, device="cpu")
    for doc_id, src in docs:
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


def close_pair(pair):
    for idx in pair:
        idx.close()


def both(pair, body):
    return pair[0].search(dict(body)), pair[1].search(dict(body))


CITY_MAPPING = {"properties": {
    "name": {"type": "keyword"},
    "location": {"type": "geo_point"},
    "population": {"type": "long"},
    "area": {"type": "double"},
}}
CITY_DOCS = [
    ("ams", {"name": "Amsterdam", "population": 850000, "area": 219.0,
             "location": {"lat": 52.37, "lon": 4.90}}),
    ("utr", {"name": "Utrecht", "population": 350000, "area": 99.0,
             "location": {"lat": 52.09, "lon": 5.12}}),
    ("ant", {"name": "Antwerp", "population": 520000, "area": 204.0,
             "location": {"lat": 51.22, "lon": 4.40}}),
    ("noloc", {"name": "Nowhere", "population": 10, "area": 1.0}),
]


@pytest.fixture(scope="module")
def cities():
    pair = make_pair("cities", CITY_MAPPING, CITY_DOCS)
    yield pair
    close_pair(pair)


def assert_same(jr, tr):
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert hit_ids(tr) == hit_ids(jr)
    assert [h.get("sort") for h in tr["hits"]["hits"]] == \
        [h.get("sort") for h in jr["hits"]["hits"]]
    for a, b in zip(jr["hits"]["hits"], tr["hits"]["hits"]):
        if a["_score"] is None:
            assert b["_score"] is None
        else:
            np.testing.assert_allclose(b["_score"], a["_score"], rtol=RTOL)


class TestGeoPolygon:
    def test_polygon_contains(self, cities):
        jr, tr = both(cities, {"query": {"geo_polygon": {"location": {
            "points": [{"lat": 53.6, "lon": 3.5}, {"lat": 53.6, "lon": 7.2},
                       {"lat": 51.6, "lon": 5.3}]}}}})
        assert_same(jr, tr)
        assert sorted(hit_ids(tr)) == ["ams", "utr"]

    def test_polygon_lon_lat_arrays(self, cities):
        jr, tr = both(cities, {"query": {"geo_polygon": {"location": {
            "points": [[3.5, 53.6], [7.2, 53.6], [5.3, 51.6]]}}}})
        assert_same(jr, tr)
        assert sorted(hit_ids(tr)) == ["ams", "utr"]

    def test_too_few_points(self, cities):
        body = {"query": {"geo_polygon": {"location": {"points": [
            {"lat": 1, "lon": 1}, {"lat": 2, "lon": 2}]}}}}
        with pytest.raises(ElasticsearchTpuException) as je:
            cities[0].search(dict(body))
        with pytest.raises(ParsingException) as te:
            cities[1].search(dict(body))
        assert str(te.value) == str(je.value)


class TestGeoDistanceSort:
    def test_sort_by_distance_from_amsterdam(self, cities):
        jr, tr = both(cities, {
            "query": {"exists": {"field": "location"}},
            "sort": [{"_geo_distance": {
                "location": {"lat": 52.37, "lon": 4.90},
                "order": "asc", "unit": "km"}}]})
        assert_same(jr, tr)
        assert hit_ids(tr) == ["ams", "utr", "ant"]
        sorts = [h["sort"][0] for h in tr["hits"]["hits"]]
        assert sorts[0] == pytest.approx(0.0, abs=1e-3)
        assert 30 < sorts[1] < 40 and 120 < sorts[2] < 140

    def test_missing_location_sorts_last(self, cities):
        jr, tr = both(cities, {"sort": [{"_geo_distance": {
            "location": [4.90, 52.37], "order": "asc", "unit": "km"}}]})
        assert_same(jr, tr)
        assert hit_ids(tr)[-1] == "noloc"

    def test_multi_point_min(self, cities):
        jr, tr = both(cities, {
            "query": {"exists": {"field": "location"}},
            "sort": [{"_geo_distance": {
                "location": [{"lat": 52.37, "lon": 4.90},
                             {"lat": 51.22, "lon": 4.40}],
                "order": "asc", "unit": "m"}}]})
        assert_same(jr, tr)
        by_id = {h["_id"]: h["sort"][0] for h in tr["hits"]["hits"]}
        assert by_id["ams"] == pytest.approx(0.0, abs=1.0)
        assert by_id["ant"] == pytest.approx(0.0, abs=1.0)


@pytest.fixture(scope="module")
def multi():
    pair = make_pair("multi", {"properties": {"loc": {"type": "geo_point"}}},
                     [("near_far", {"loc": [{"lat": 1.0, "lon": 0.0},
                                            {"lat": 10.0, "lon": 0.0}]}),
                      ("mid", {"loc": {"lat": 5.0, "lon": 0.0}})])
    yield pair
    close_pair(pair)


class TestGeoSortModes:
    def test_desc_defaults_to_max(self, multi):
        jr, tr = both(multi, {"sort": [{"_geo_distance": {
            "loc": {"lat": 0.0, "lon": 0.0}, "order": "desc", "unit": "km"}}]})
        assert_same(jr, tr)
        assert hit_ids(tr) == ["near_far", "mid"]
        assert tr["hits"]["hits"][0]["sort"][0] > 1000

    def test_explicit_mode_min(self, multi):
        jr, tr = both(multi, {"sort": [{"_geo_distance": {
            "loc": {"lat": 0.0, "lon": 0.0}, "order": "desc", "unit": "km",
            "mode": "min"}}]})
        assert_same(jr, tr)
        assert hit_ids(tr) == ["mid", "near_far"]

    def test_mode_avg(self, multi):
        jr, tr = both(multi, {"sort": [{"_geo_distance": {
            "loc": {"lat": 0.0, "lon": 0.0}, "order": "asc", "unit": "km",
            "mode": "avg"}}]})
        assert_same(jr, tr)
        by_id = {h["_id"]: h["sort"][0] for h in tr["hits"]["hits"]}
        assert by_id["near_far"] == pytest.approx((111.2 + 1111.95) / 2,
                                                  rel=0.02)

    @pytest.mark.parametrize("mode", ["sum", "bogus"])
    def test_sum_and_an_unknown_mode(self, multi, mode):
        body = {"sort": [{"_geo_distance": {
            "loc": {"lat": 0.0, "lon": 0.0}, "mode": mode,
            "distance_type": "arc", "ignore_unmapped": True}}]}
        if mode == "bogus":
            with pytest.raises(ElasticsearchTpuException) as je:
                multi[0].search(dict(body))
            with pytest.raises(ParsingException) as te:
                multi[1].search(dict(body))
            assert str(te.value) == str(je.value)
            return
        assert_same(*both(multi, body))


class TestSearchAfterNullSort:
    def test_null_cursor_pages_past_missing(self, cities):
        sort = [{"_geo_distance": {
            "location": [4.90, 52.37], "order": "asc", "unit": "km"}}]
        jr, tr = both(cities, {"sort": sort, "size": 3})
        assert_same(jr, tr)
        assert hit_ids(tr) == ["ams", "utr", "ant"]
        last = tr["hits"]["hits"][-1]["sort"]
        jr2, tr2 = both(cities, {"sort": sort, "search_after": last,
                                 "size": 3})
        assert_same(jr2, tr2)
        assert hit_ids(tr2) == ["noloc"]
        assert tr2["hits"]["hits"][0]["sort"] == [None]
        jr3, tr3 = both(cities, {"sort": sort, "search_after": [None],
                                 "size": 3})
        assert_same(jr3, tr3)
        assert hit_ids(tr3) == []


AGG_MAPPING = {"properties": {
    "loc": {"type": "geo_point"},
    "topic": {"type": "keyword"},
    "body": {"type": "text"},
}}
AGG_DOCS = [(str(i), d) for i, d in enumerate([
    {"body": "report of theft downtown", "topic": "crime",
     "loc": {"lat": 40.0, "lon": -74.0}},
    {"body": "theft at the market", "topic": "crime",
     "loc": {"lat": 40.1, "lon": -74.1}},
    {"body": "theft suspect arrested", "topic": "crime",
     "loc": {"lat": 40.2, "lon": -74.2}},
    {"body": "local bakery opens doors", "topic": "news",
     "loc": {"lat": 50.0, "lon": 8.0}},
    {"body": "city council votes on budget", "topic": "news",
     "loc": {"lat": 50.1, "lon": 8.1}},
    {"body": "weather sunny all week", "topic": "news",
     "loc": {"lat": 50.2, "lon": 8.2}},
])]


@pytest.fixture(scope="module")
def aggs_pair():
    pair = make_pair("ext", AGG_MAPPING, AGG_DOCS)
    yield pair
    close_pair(pair)


class TestGeoAggs:
    def test_geo_bounds(self, aggs_pair):
        jr, tr = both(aggs_pair, {"size": 0, "aggs": {
            "b": {"geo_bounds": {"field": "loc"}}}})
        assert tr["aggregations"] == jr["aggregations"]
        bounds = tr["aggregations"]["b"]["bounds"]
        assert bounds["top_left"]["lat"] == pytest.approx(50.2)
        assert bounds["top_left"]["lon"] == pytest.approx(-74.2)
        assert bounds["bottom_right"]["lat"] == pytest.approx(40.0)
        assert bounds["bottom_right"]["lon"] == pytest.approx(8.2)

    def test_geo_centroid(self, aggs_pair):
        jr, tr = both(aggs_pair, {"size": 0,
                                  "query": {"term": {"topic": "crime"}},
                                  "aggs": {"c": {"geo_centroid": {
                                      "field": "loc"}}}})
        assert tr["aggregations"] == jr["aggregations"]
        c = tr["aggregations"]["c"]
        assert c["count"] == 3
        assert c["location"]["lat"] == pytest.approx(40.1, abs=1e-4)

    def test_geohash_grid(self, aggs_pair):
        jr, tr = both(aggs_pair, {"size": 0, "aggs": {"g": {"geohash_grid": {
            "field": "loc", "precision": 2}}}})
        assert tr["aggregations"] == jr["aggregations"]
        buckets = {b["key"]: b["doc_count"]
                   for b in tr["aggregations"]["g"]["buckets"]}
        assert sum(buckets.values()) == 6 and len(buckets) == 2

    def test_geohash_roundtrip(self):
        h = tgeohash.encode(48.8566, 2.3522, 7)
        assert h == jgeohash.encode(48.8566, 2.3522, 7)
        lat, lon = tgeohash.decode(h)
        assert (lat, lon) == jgeohash.decode(h)
        assert lat == pytest.approx(48.8566, abs=0.01)
        assert lon == pytest.approx(2.3522, abs=0.01)


def test_geo_aggs_on_seeded_points_equal_jax(monkeypatch):
    """Bounds, centroid bits and every geohash_grid precision over
    seeded multi-point docs on three shards, under a filter and over
    every doc; geo aggregations never take the fused plane."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    rng = np.random.RandomState(11)
    docs = []
    for i in range(300):
        k = rng.choice([0, 1, 1, 1, 2])
        pts = [{"lat": float(rng.uniform(-89, 89)),
                "lon": float(rng.uniform(-179, 179))} for _ in range(k)]
        src = {"topic": ["a", "b", "c"][i % 3], "body": f"w{i % 7} x"}
        if pts:
            src["loc"] = pts if k > 1 else pts[0]
        docs.append((f"p{i}", src))
    pair = make_pair("geoagg", AGG_MAPPING, docs, shards=3, mesh=True)
    try:
        for query in ({"match_all": {}}, {"match": {"body": "w3"}}):
            for aggs in ({"b": {"geo_bounds": {"field": "loc"}}},
                         {"c": {"geo_centroid": {"field": "loc"}}},
                         *({"g": {"geohash_grid": {"field": "loc",
                                                   "precision": p}}}
                           for p in (1, 3, 5, 8))):
                body = {"size": 0, "query": query, "aggs": aggs}
                jr, tr = both(pair, body)
                assert tr["aggregations"] == jr["aggregations"], aggs
                assert tr["_plane"] == jr["_plane"]
        ms = pair[1]._mesh_plane()
        assert ms.agg_host_fallback_by_reason.get("unsupported_agg", 0) >= 1
    finally:
        close_pair(pair)


def test_vectorized_geohash_equals_the_scalar_one():
    rng = np.random.RandomState(2024)
    lat = rng.uniform(-90, 90, 100_000)
    lon = rng.uniform(-180, 180, 100_000)
    # the cell edges and the poles
    lat[:8] = [90.0, -90.0, 0.0, 45.0, -45.0, 22.5, 89.99999, -0.0]
    lon[:8] = [180.0, -180.0, 0.0, 90.0, -90.0, 45.0, 179.99999, -0.0]
    lat[-50000:] = lat[-50000:].astype(np.float32)  # the stored values
    lon[-50000:] = lon[-50000:].astype(np.float32)
    for precision in (1, 5, 7, 12):
        # points exactly on the cells' edges (the bisection's midpoints)
        lon_bits, lat_bits = (5 * precision + 1) // 2, 5 * precision // 2
        lon[8:1008] = -180 + rng.randint(0, 1 << lon_bits, 1000) * (
            360.0 / (1 << lon_bits))
        lat[1008:2008] = -90 + rng.randint(0, 1 << lat_bits, 1000) * (
            180.0 / (1 << lat_bits))
        got = tgeohash.encode_many(lat, lon, precision)
        want = [jgeohash.encode(a, b, precision)
                for a, b in zip(lat.tolist(), lon.tolist())]
        assert got == want, precision


# ---------------------------------------------------------------------------
# Filters under a match: the mesh plane and the host rung against JAX
# ---------------------------------------------------------------------------

FILTER_MAPPING = {"properties": {
    "title": {"type": "text"},
    "loc": {"type": "geo_point"},
}}


def filter_docs(n=240, seed=9, prefix="g"):
    rng = np.random.RandomState(seed)
    centres = [(52.0, 5.0), (40.7, -74.0), (-33.9, 151.2), (65.0, 179.5),
               (64.0, -179.5)]
    docs = []
    for d in range(n):
        src = {"title": " ".join(f"w{int(x)}" for x in
                                 rng.randint(0, 12, rng.randint(2, 7)))}
        k = rng.choice([0, 1, 1, 1, 2])
        pts = []
        for _ in range(k):
            c = centres[rng.randint(len(centres))]
            pts.append({"lat": float(np.clip(c[0] + rng.randn() * 2, -90, 90)),
                        "lon": float((c[1] + rng.randn() * 2 + 180) % 360
                                     - 180)})
        if pts:
            src["loc"] = pts if k > 1 else pts[0]
        docs.append((f"{prefix}{d}", src))
    return docs


GEO_FILTERS = [
    ({"geo_distance": {"distance": "200km",
                       "loc": {"lat": 52.0, "lon": 5.0}}},
     (52.0, 5.0, 200_000.0)),
    ({"geo_distance": {"distance": 1000000,
                       "loc": "40.7,-74.0"}}, (40.7, -74.0, 1e6)),
    ({"geo_bounding_box": {"loc": {"top_left": {"lat": 55, "lon": 2},
                                   "bottom_right": {"lat": 38, "lon": 8}}}},
     None),
    # crosses the antimeridian
    ({"geo_bounding_box": {"loc": {"top_left": [175.0, 70.0],
                                   "bottom_right": [-175.0, 60.0]}}}, None),
    ({"geo_polygon": {"loc": {"points": [[0, 45], [10, 45], [10, 58],
                                         [0, 58], [5, 51]]}}}, None),
]


def band_ids(docs, center):
    """Docs with a point whose float64 distance lies within 1e-5 of the
    radius (relative)."""
    if center is None:
        return set()
    clat, clon, radius = center
    out = set()
    for doc_id, src in docs:
        pts = src.get("loc")
        pts = pts if isinstance(pts, list) else [pts] if pts else []
        for p in pts:
            la, lo = np.float32(p["lat"]), np.float32(p["lon"])
            d = _hav64(la, lo, clat, clon)
            if abs(d - radius) <= 1e-5 * radius:
                out.add(doc_id)
    return out


def _hav64(lat1, lon1, lat2, lon2):
    r1, r2 = np.radians(float(lat1)), np.radians(float(lat2))
    a = (np.sin((r2 - r1) / 2) ** 2 + np.cos(r1) * np.cos(r2)
         * np.sin(np.radians(float(lon2) - float(lon1)) / 2) ** 2)
    return 2 * 6371008.8 * np.arcsin(np.sqrt(a))


@pytest.fixture(scope="module", params=["host", "mesh"])
def geo_pair(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    docs = filter_docs()
    pair = make_pair("geof", FILTER_MAPPING, docs, shards=3,
                     mesh=request.param == "mesh")
    yield request.param, pair, docs
    close_pair(pair)
    mp.undo()


@pytest.mark.parametrize("case", range(len(GEO_FILTERS)))
def test_geo_filters_under_match_equal_jax(geo_pair, case):
    mode, pair, docs = geo_pair
    flt, center = GEO_FILTERS[case]
    band = band_ids(docs, center)
    for body in ({"query": {"bool": {"must": {"match": {"title": "w1 w2"}},
                                     "filter": flt}}, "size": 20},
                 {"query": {"bool": {"filter": flt}}, "size": 300},
                 {"query": flt, "size": 300}):
        jr, tr = both(pair, body)
        assert tr["_plane"] == jr["_plane"]
        if mode == "mesh":
            assert tr["_plane"] in ("mesh", "mesh_pallas")
        if not band:
            assert_same(jr, tr)
        else:
            keep = [h["_id"] for h in jr["hits"]["hits"] if h["_id"] not in band]
            assert keep == [h["_id"] for h in tr["hits"]["hits"]
                            if h["_id"] not in band]


def test_geo_sort_takes_the_host_rung_on_the_mesh():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    pair = make_pair("geos", FILTER_MAPPING, filter_docs(), shards=3,
                     mesh=True)
    try:
        ms = pair[1]._mesh_plane()
        before = ms.decisions.get("host.sort_ineligible", 0)
        body = {"query": {"match": {"title": "w3"}}, "size": 15,
                "sort": [{"_geo_distance": {"loc": {"lat": 50, "lon": 0},
                                            "order": "desc"}}]}
        jr, tr = both(pair, body)
        assert_same(jr, tr)
        assert tr["_plane"] == "host"
        assert ms.decisions["host.sort_ineligible"] == before + 1
        # the filters stay on the mesh
        jr, tr = both(pair, {"query": {"bool": {
            "must": {"match": {"title": "w3"}},
            "filter": GEO_FILTERS[0][0]}}})
        assert tr["_plane"] == jr["_plane"] != "host"
    finally:
        close_pair(pair)
        mp.undo()


def test_geo_delta_append_queries_again():
    """Geo docs appended by a refresh join the generation as a delta:
    the appended slots bring their own geo columns and the answers equal
    a JAX index holding every doc."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    docs = filter_docs(200)
    more = filter_docs(80, seed=10, prefix="h")
    settings = {"index.staging.delta.enabled": True,
                "index.staging.compact.threshold": 0.0,
                "index.search.mesh.max_slots_per_device": 16}
    tidx = IndexService("gda", Settings({
        "index.number_of_shards": 3, "index.refresh_interval": -1,
        **settings}), mapping=FILTER_MAPPING, device="cpu")
    jidx = JIndex("gda", JSettings({
        "index.number_of_shards": 3, "index.refresh_interval": -1,
        "index.search.mesh": False, "index.requests.cache.enable": False}),
        mapping=FILTER_MAPPING)
    try:
        for doc_id, src in docs:
            tidx.index_doc(doc_id, src)
            jidx.index_doc(doc_id, src)
        tidx.refresh()
        jidx.refresh()
        body = {"query": {"bool": {"must": {"match": {"title": "w1 w4"}},
                                   "filter": GEO_FILTERS[0][0]}},
                "size": 50}
        assert tidx.search(dict(body))["_plane"] != "host"
        ms = tidx._mesh_search
        for doc_id, src in more:
            tidx.index_doc(doc_id, src)
            jidx.index_doc(doc_id, src)
        tidx.refresh()
        jidx.refresh()
        for flt, _c in GEO_FILTERS:
            b = {"query": {"bool": {"must": {"match": {"title": "w1 w4"}},
                                    "filter": flt}}, "size": 50}
            tr, jr = tidx.search(dict(b)), jidx.search(dict(b))
            assert tr["_plane"] != "host"
            assert tr["hits"]["total"] == jr["hits"]["total"]
            assert hit_ids(tr) == hit_ids(jr)
        assert ms.delta_restage_total == 1
        assert any(i.startswith("h") for i in hit_ids(tidx.search(
            {"query": GEO_FILTERS[0][0], "size": 300})))
    finally:
        tidx.close()
        jidx.close()
        mp.undo()
