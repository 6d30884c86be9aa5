"""Parity of geo_shape with the JAX package: geometry, mapping, the query.

Mirrors tests/test_geo_shape.py (20 cases): the planar geometry of
``utils/geometry.py`` (each case runs on both modules and their answers
must be equal), the ``geo_shape`` query's four relations, WKT, unmapped
fields, multi-valued docs, a bool filter, ``indexed_shape`` through a
``Node``, and a flush and reload. Each query case runs on a JAX
``IndexService`` and a port ``IndexService(device="cpu")`` holding the
same documents: ids and totals exact, scores rtol 1e-5.

Added: seeded shapes in the mix of Rally's ``geoshape`` track (60%
linestrings of 2-16 vertices, 30% polygons of 4-32 vertices, some with a
hole, 10% points) under every relation against the JAX package and a
numpy bbox oracle for the prefilter; a JAX-written store holding shapes
that the port opens and answers alike; and a ``geo_shape`` filter beside
a ``match`` on the one-device mesh plane (JAX with
``ES_TPU_PALLAS=interpret``), where a slot without shapes keeps the
plan's skeleton.
"""

import math
import os

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    MapperParsingException as JMapperParsingException,
)
from elasticsearch_tpu.common.errors import QueryShardException as JQSE
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu.utils import geometry as JG
from elasticsearch_tpu_torch.common.errors import (
    MapperParsingException,
    ParsingException,
    QueryShardException,
    ResourceNotFoundException,
)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils import geometry as TG

RTOL = 1e-5

MAPPING = {"properties": {"area": {"type": "geo_shape"},
                          "name": {"type": "keyword"},
                          "title": {"type": "text"}}}


def hit_ids(resp):
    return {h["_id"] for h in resp["hits"]["hits"]}


def make_pair(name, docs, shards=1, mesh=False, mapping=MAPPING,
              data_paths=(None, None)):
    common = {"index.number_of_shards": shards, "index.refresh_interval": -1}
    if not mesh:
        common["index.search.mesh"] = False
    jidx = JIndex(name, JSettings({**common, "search.aggs.fused": False,
                                   "index.staging.delta.enabled": False}),
                  mapping=mapping, data_path=data_paths[0])
    if mesh:
        # the port serves one device: give the JAX plane a one-device mesh
        jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common), mapping=mapping,
                        device="cpu", data_path=data_paths[1])
    for doc in docs:
        doc_id, src, routing = (doc + (None,))[:3]
        jidx.index_doc(doc_id, src, routing=routing)
        tidx.index_doc(doc_id, src, routing=routing)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


def close_pair(pair):
    for idx in pair:
        idx.close()


def assert_same(jr, tr):
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert [h["_id"] for h in tr["hits"]["hits"]] == \
        [h["_id"] for h in jr["hits"]["hits"]]
    for a, b in zip(jr["hits"]["hits"], tr["hits"]["hits"]):
        np.testing.assert_allclose(b["_score"], a["_score"], rtol=RTOL)


def both(pair, body):
    jr, tr = pair[0].search(dict(body)), pair[1].search(dict(body))
    assert_same(jr, tr)
    return tr


# ---------------------------------------------------------------------------
# Geometry: each case on both modules
# ---------------------------------------------------------------------------


class TestGeometry:
    @pytest.mark.parametrize("G", [JG, TG], ids=["jax", "port"])
    def test_point_in_polygon(self, G):
        sq = G.Polygon([(0, 0), (10, 0), (10, 10), (0, 10), (0, 0)])
        assert sq.contains_point((5, 5))
        assert sq.contains_point((0, 5))  # the boundary counts
        assert not sq.contains_point((11, 5))

    def test_polygon_with_hole(self):
        out = []
        for G in (JG, TG):
            donut = G.Polygon(
                [(0, 0), (10, 0), (10, 10), (0, 10), (0, 0)],
                holes=[[(4, 4), (6, 4), (6, 6), (4, 6), (4, 4)]])
            out.append([donut.contains_point(p)
                        for p in [(1, 1), (5, 5), (4, 5), (6, 6)]])
        assert out[0] == out[1]
        assert out[1][:2] == [True, False]

    def test_relations(self):
        out = []
        for G in (JG, TG):
            a = G.Polygon([(0, 0), (4, 0), (4, 4), (0, 4), (0, 0)])
            b = G.Polygon([(1, 1), (2, 1), (2, 2), (1, 2), (1, 1)])
            c = G.Polygon([(10, 10), (12, 10), (12, 12), (10, 12), (10, 10)])
            line = G.LineString([(-1, 2), (5, 2)])
            out.append([b.within(a), a.contains(b), a.intersects(b),
                        a.intersects(c), a.disjoint(c), line.intersects(a),
                        line.within(a)])
        assert out[0] == out[1] == [True, True, True, False, True, True,
                                    False]

    def test_wkt_roundtrip(self):
        for G in (JG, TG):
            p = G.parse_wkt("POINT (30 10)")
            assert (p.lon, p.lat) == (30.0, 10.0)
            poly = G.parse_wkt("POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))")
            assert poly.contains_point((5, 5))
            mp = G.parse_wkt("MULTIPOLYGON (((0 0, 2 0, 2 2, 0 2, 0 0)), "
                             "((5 5, 7 5, 7 7, 5 7, 5 5)))")
            assert mp.contains_point((1, 1)) and mp.contains_point((6, 6))
            env = G.parse_wkt("ENVELOPE (0, 10, 10, 0)")
            assert env.contains_point((5, 5))
            gc = G.parse_wkt("GEOMETRYCOLLECTION (POINT (1 1), "
                             "LINESTRING (0 0, 3 3))")
            assert gc.bbox() == (0.0, 0.0, 3.0, 3.0)
        assert TG.parse_wkt("MULTILINESTRING ((0 0, 1 1), (2 2, 3 5))").bbox() \
            == JG.parse_wkt("MULTILINESTRING ((0 0, 1 1), (2 2, 3 5))").bbox()

    @pytest.mark.parametrize("bad", [
        {"type": "blob", "coordinates": []},
        {"type": "polygon", "coordinates": [[[0, 0], [1, 1], [0, 0]]]},
        {"no": "type"},
        {"type": "circle", "coordinates": [0, 0]},
    ])
    def test_geojson_parse_errors(self, bad):
        with pytest.raises(JMapperParsingException) as je:
            JG.parse_geojson(bad)
        with pytest.raises(MapperParsingException) as te:
            TG.parse_geojson(bad)
        assert str(te.value) == str(je.value)

    def test_point_to_point_and_point_on_line_intersect(self):
        out = []
        for G in (JG, TG):
            p = G.Point(5, 5)
            line = G.LineString([(0, 5), (10, 5)])
            out.append([p.intersects(G.Point(5, 5)),
                        p.intersects(G.Point(5, 6)), p.intersects(line),
                        line.intersects(p), G.Point(5, 6).intersects(line)])
        assert out[0] == out[1] == [True, False, True, True, False]

    def test_circle_approximation(self):
        jc = JG.circle((0.0, 0.0), 111_000)
        tc = TG.circle((0.0, 0.0), 111_000)
        assert tc.shell == jc.shell  # the same 32-gon, bit for bit
        assert tc.contains_point((0.0, 0.9))
        assert not tc.contains_point((0.0, 1.2))
        assert TG._parse_radius("2km") == JG._parse_radius("2km") == 2000.0


# ---------------------------------------------------------------------------
# The query, against the JAX package
# ---------------------------------------------------------------------------

PLACES = [
    ("sq_small", {"name": "small", "area": {
        "type": "polygon",
        "coordinates": [[[1, 1], [2, 1], [2, 2], [1, 2], [1, 1]]]}}),
    ("sq_big", {"name": "big", "area": {
        "type": "polygon",
        "coordinates": [[[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]]]}}),
    ("far_pt", {"name": "far", "area": {
        "type": "point", "coordinates": [50, 50]}}),
    ("line", {"name": "line", "area": "LINESTRING (0 5, 20 5)"}),
]


@pytest.fixture()
def places():
    pair = make_pair("places", PLACES)
    yield pair
    close_pair(pair)


class TestGeoShapeQuery:
    QUERY_SQUARE = {"type": "envelope", "coordinates": [[0.5, 3.5], [3.5, 0.5]]}

    def test_intersects_default(self, places):
        r = both(places, {"query": {"geo_shape": {"area": {
            "shape": self.QUERY_SQUARE}}}})
        assert hit_ids(r) == {"sq_small", "sq_big"}

    def test_within(self, places):
        r = both(places, {"query": {"geo_shape": {"area": {
            "shape": {"type": "envelope", "coordinates": [[0, 10], [10, 0]]},
            "relation": "within"}}}})
        assert hit_ids(r) == {"sq_small", "sq_big"}
        r = both(places, {"query": {"geo_shape": {"area": {
            "shape": self.QUERY_SQUARE, "relation": "within"}}}})
        assert hit_ids(r) == {"sq_small"}

    def test_contains(self, places):
        r = both(places, {"query": {"geo_shape": {"area": {
            "shape": {"type": "point", "coordinates": [1.5, 1.5]},
            "relation": "contains"}}}})
        assert hit_ids(r) == {"sq_small", "sq_big"}

    def test_disjoint(self, places):
        r = both(places, {"query": {"geo_shape": {"area": {
            "shape": self.QUERY_SQUARE, "relation": "disjoint"}}}})
        assert hit_ids(r) == {"far_pt", "line"}

    def test_wkt_query_shape(self, places):
        r = both(places, {"query": {"geo_shape": {"area": {
            "shape": "POLYGON ((45 45, 55 45, 55 55, 45 55, 45 45))"}}}})
        assert hit_ids(r) == {"far_pt"}

    def test_unmapped_field(self, places):
        body = {"query": {"geo_shape": {"nope": {
            "shape": self.QUERY_SQUARE}}}}
        with pytest.raises(JQSE) as je:
            places[0].search(dict(body))
        with pytest.raises(QueryShardException) as te:
            places[1].search(dict(body))
        assert str(te.value) == str(je.value)
        r = both(places, {"query": {"geo_shape": {
            "nope": {"shape": self.QUERY_SQUARE}, "ignore_unmapped": True}}})
        assert r["hits"]["total"] == 0

    def test_within_multivalue_combined_bbox(self, places):
        # one shape inside, one far away: WITHIN still matches
        for idx in places:
            idx.index_doc("multi", {"area": [
                {"type": "point", "coordinates": [1.5, 1.5]},
                {"type": "point", "coordinates": [80, 80]}]})
            idx.refresh()
        r = both(places, {"query": {"geo_shape": {"area": {
            "shape": self.QUERY_SQUARE, "relation": "within"}}}})
        assert "multi" in hit_ids(r)

    def test_query_without_shape_rejected(self, places):
        body = {"query": {"geo_shape": {"area": {"relation": "within"}}}}
        with pytest.raises(Exception) as je:
            places[0].search(dict(body))
        with pytest.raises(ParsingException) as te:
            places[1].search(dict(body))
        assert str(te.value) == str(je.value)

    def test_bad_shape_value_rejected_at_index_time(self, places):
        bad = {"area": {"type": "polygon", "coordinates": [[[0, 0]]]}}
        with pytest.raises(JMapperParsingException) as je:
            places[0].index_doc("bad", bad)
        with pytest.raises(MapperParsingException) as te:
            places[1].index_doc("bad", bad)
        assert str(te.value) == str(je.value)

    def test_bool_filter_combination(self, places):
        r = both(places, {"query": {"bool": {
            "must": [{"match_all": {}}],
            "filter": [{"geo_shape": {"area": {"shape": self.QUERY_SQUARE}}},
                       {"term": {"name": "big"}}]}}})
        assert hit_ids(r) == {"sq_big"}

    def test_exists_and_source_of_a_shape_field(self, places):
        r = both(places, {"query": {"exists": {"field": "area"}},
                          "size": 10})
        assert r["hits"]["total"] == 4
        assert {h["_id"]: h["_source"] for h in r["hits"]["hits"]} == \
            dict(PLACES)


def _node_pair():
    return JNode(), Node(device="cpu")


class TestIndexedShape:
    def test_indexed_shape_rewrite(self):
        answers = []
        for node in _node_pair():
            try:
                node.create_index("shapes", {"mappings": {"properties": {
                    "footprint": {"type": "geo_shape"}}}})
                node.create_index("places", {"mappings": {"properties": {
                    "area": {"type": "geo_shape"}}}})
                node.index_doc("shapes", "zone", {"footprint": {
                    "type": "envelope", "coordinates": [[0, 10], [10, 0]]}})
                node.index_doc("places", "inside", {"area": {
                    "type": "point", "coordinates": [5, 5]}})
                node.index_doc("places", "outside", {"area": {
                    "type": "point", "coordinates": [50, 50]}})
                for svc in node.indices.values():
                    svc.refresh()
                r = node.search("places", {"query": {"geo_shape": {"area": {
                    "indexed_shape": {"index": "shapes", "id": "zone",
                                      "path": "footprint"},
                    "relation": "within"}}}})
                answers.append(hit_ids(r))
            finally:
                node.close()
        assert answers[0] == answers[1] == {"inside"}

    def test_missing_indexed_shape_errors(self):
        msgs = []
        for node in _node_pair():
            try:
                node.create_index("places", {"mappings": {"properties": {
                    "area": {"type": "geo_shape"}}}})
                node.index_doc("places", "x", {"area": {
                    "type": "point", "coordinates": [1, 1]}})
                node.indices["places"].refresh()
                with pytest.raises(Exception) as e:
                    node.search("places", {"query": {"geo_shape": {"area": {
                        "indexed_shape": {"index": "places", "id": "nope"}}}}})
                msgs.append((type(e.value).__name__, str(e.value)))
            finally:
                node.close()
        assert msgs[1][0] == ResourceNotFoundException.__name__
        assert msgs[0] == msgs[1]


class TestPersistence:
    def test_shapes_survive_flush_and_reload(self, tmp_data_dir):
        path = os.path.join(tmp_data_dir, "geo")
        mapping = {"properties": {"area": {"type": "geo_shape"}}}
        idx = IndexService("geo", Settings({"index.number_of_shards": 1}),
                           mapping=mapping, data_path=path, device="cpu")
        idx.index_doc("a", {"area": {"type": "point", "coordinates": [5, 5]}})
        idx.refresh()
        idx.flush()
        idx.close()
        idx2 = IndexService("geo", Settings({"index.number_of_shards": 1}),
                            mapping=mapping, data_path=path, device="cpu")
        try:
            r = idx2.search({"query": {"geo_shape": {"area": {
                "shape": {"type": "envelope",
                          "coordinates": [[0, 10], [10, 0]]}}}}})
            assert hit_ids(r) == {"a"}
        finally:
            idx2.close()

    def test_jax_written_store_with_shapes_opens_in_the_port(
            self, tmp_data_dir):
        """The JAX package writes shapes into the store's meta.json; the
        port opens that store (its shape data included) and answers every
        relation as the JAX index does."""
        docs = rally_docs(300, seed=4)
        jpath = os.path.join(tmp_data_dir, "jgeo")
        s = {"index.number_of_shards": 2, "index.refresh_interval": -1,
             "index.search.mesh": False}
        jidx = JIndex("jgeo", JSettings({**s, "search.aggs.fused": False}),
                      mapping=MAPPING, data_path=jpath)
        for doc_id, src in docs:
            jidx.index_doc(doc_id, src)
        jidx.flush()
        try:
            tidx = IndexService("jgeo", Settings(s), mapping=MAPPING,
                                data_path=jpath, device="cpu")
            try:
                assert tidx.num_docs() == len(docs)
                segs = [seg for sh in tidx.shards.values()
                        for seg in sh.engine.segments]
                assert sum(len(seg.shapes.get("area", {}))
                           for seg in segs) == sum(
                               "area" in src for _, src in docs)
                for body in rally_queries():
                    jr = jidx.search(dict(body))
                    tr = tidx.search(dict(body))
                    assert_same(jr, tr)
                # a segment the port writes, read by the JAX package
                tidx.index_doc("extra", {"area": {
                    "type": "point", "coordinates": [70.5, 70.5]}})
                tidx.flush()
            finally:
                tidx.close()
        finally:
            jidx.close()
        jidx2 = JIndex("jgeo", JSettings({**s, "search.aggs.fused": False}),
                       mapping=MAPPING, data_path=jpath)
        try:
            assert jidx2.search({"query": {"exists": {"field": "area"}},
                                 "size": 0})["hits"]["total"] == 1 + sum(
                                     "area" in src for _, src in docs)
            r = jidx2.search({"query": {"geo_shape": {"area": {"shape": {
                "type": "envelope", "coordinates": [[70, 71], [71, 70]]}}}}})
            assert hit_ids(r) == {"extra"}
        finally:
            jidx2.close()


# ---------------------------------------------------------------------------
# Seeded shapes in the Rally geoshape mix, against JAX and a bbox oracle
# ---------------------------------------------------------------------------


def rally_shape(rng):
    """One shape in the mix of Rally's geoshape track (OpenStreetMap):
    60% linestrings of 2-16 vertices, 30% polygons of 4-32 vertices (one
    in four with a hole), 10% points; within a 40 x 40 degree box."""
    kind = rng.rand()
    cx, cy = rng.uniform(-20, 20), rng.uniform(-20, 20)
    if kind < 0.6:
        n = rng.randint(2, 17)
        pts = np.cumsum(rng.randn(n, 2) * 0.3, axis=0) + (cx, cy)
        return {"type": "linestring",
                "coordinates": [[round(x, 4), round(y, 4)] for x, y in pts]}
    if kind < 0.9:
        n = rng.randint(3, 32)
        ang = np.sort(rng.uniform(0, 2 * math.pi, n))
        r = rng.uniform(0.2, 1.5) * rng.uniform(0.7, 1.0, n)
        shell = [[round(cx + a * math.cos(t), 4), round(cy + a * math.sin(t), 4)]
                 for a, t in zip(r, ang)]
        rings = [shell + [shell[0]]]
        if rng.rand() < 0.25:
            h = 0.1 * float(r.min())
            hole = [[round(cx - h, 4), round(cy - h, 4)],
                    [round(cx + h, 4), round(cy - h, 4)],
                    [round(cx + h, 4), round(cy + h, 4)],
                    [round(cx - h, 4), round(cy - h, 4)]]
            rings.append(hole)
        return {"type": "polygon", "coordinates": rings}
    return {"type": "point", "coordinates": [round(cx, 4), round(cy, 4)]}


def rally_docs(n, seed, prefix="s"):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        src = {"title": " ".join(f"w{int(x)}" for x in
                                 rng.randint(0, 8, rng.randint(2, 6)))}
        if rng.rand() < 0.9:
            src["area"] = rally_shape(rng)
        docs.append((f"{prefix}{i}", src))
    return docs


def rally_queries():
    env = {"type": "envelope", "coordinates": [[-6.0, 6.0], [6.0, -6.0]]}
    poly = {"type": "polygon", "coordinates": [[
        [-8, -3], [2, -9], [9, 1], [1, 8], [-8, -3]]]}
    pt = {"type": "point", "coordinates": [0.5, 0.5]}
    out = []
    for shape in (env, poly, pt):
        for rel in ("intersects", "within", "contains", "disjoint"):
            out.append({"query": {"geo_shape": {"area": {
                "shape": shape, "relation": rel}}}, "size": 400})
    return out


def _bbox_of(src):
    g = TG.parse_shape(src["area"])
    return g.bbox()


def test_seeded_rally_shapes_equal_jax_and_the_bbox_oracle():
    docs = rally_docs(400, seed=11)
    pair = make_pair("rally", docs, shards=2)
    try:
        for body in rally_queries():
            tr = both(pair, body)
            spec = body["query"]["geo_shape"]["area"]
            qb = TG.parse_shape(spec["shape"]).bbox()
            got = hit_ids(tr)
            # the prefilter's oracle: a hit's bbox overlaps the query's
            # (intersects, within), covers it (contains), or it is not
            # necessarily so (disjoint: every bbox miss is a hit)
            for doc_id, src in docs:
                if "area" not in src:
                    assert doc_id not in got
                    continue
                b = _bbox_of(src)
                overlap = not (b[0] > qb[2] or qb[0] > b[2]
                               or b[1] > qb[3] or qb[1] > b[3])
                if spec["relation"] in ("intersects", "within"):
                    assert overlap or doc_id not in got
                elif spec["relation"] == "contains":
                    covers = (b[0] <= qb[0] and b[1] <= qb[1]
                              and b[2] >= qb[2] and b[3] >= qb[3])
                    assert covers or doc_id not in got
                else:
                    assert overlap or doc_id in got
    finally:
        close_pair(pair)


def test_geo_shape_beside_a_match_on_the_mesh_plane(monkeypatch):
    """A geo_shape filter in a bool beside a match: on a 3-shard index the
    plan stacks (one skeleton; the shard whose segment holds no shape
    gives an all-false mask) and the kernel plane serves, as in the JAX
    package; the host rung gives the same answers."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    docs = rally_docs(150, seed=21)
    # one shard's docs carry no shape: route by id to find them
    no_shape = [(f"n{i}", {"title": "w1 w2 w3"}) for i in range(30)]
    pair = make_pair("meshshape", docs + no_shape, shards=3, mesh=True)
    host = make_pair("hostshape", docs + no_shape, shards=3)
    try:
        for q in rally_queries()[:8]:
            flt = q["query"]
            body = {"query": {"bool": {"must": [{"match": {"title": "w1 w2"}}],
                                       "filter": [flt]}}, "size": 50}
            tr = both(pair, body)
            assert tr["_plane"] == "mesh_pallas"
            hr = both(host, body)
            assert hr["_plane"] == "host"
            assert [h["_id"] for h in hr["hits"]["hits"]] == \
                [h["_id"] for h in tr["hits"]["hits"]]
        # alone, the mask clause stacks on the scatter plane
        tr = both(pair, rally_queries()[0])
        assert tr["_plane"] == "mesh"
    finally:
        close_pair(pair)
        close_pair(host)


def test_a_slot_without_shapes_stacks_an_all_false_mask(monkeypatch):
    """Every doc of one shard lacks the field: its slot's mask is all
    false (not MatchNone), so the request stays on the mesh plane."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for

    routes = {}
    for r in (f"r{i}" for i in range(64)):
        routes.setdefault(shard_id_for(r, 2), r)
    docs = [(f"a{i}", {"title": "w1", "area": {
        "type": "point", "coordinates": [i * 0.1, 0.0]}}, routes[0])
        for i in range(4)]
    docs += [(f"b{i}", {"title": "w1"}, routes[1]) for i in range(40)]
    pair = make_pair("someshapes", docs, shards=2, mesh=True)
    try:
        assert not any(seg.shapes for seg in
                       pair[1].shards[1].engine.segments)
        body = {"query": {"bool": {"must": [{"match": {"title": "w1"}}],
                                   "filter": [{"geo_shape": {"area": {
                                       "shape": {"type": "envelope",
                                                 "coordinates": [[-1, 1],
                                                                 [1, -1]]}}}}]}},
                "size": 10}
        tr = both(pair, body)
        assert tr["_plane"] == "mesh_pallas"
        assert hit_ids(tr) == {f"a{i}" for i in range(4)}
    finally:
        close_pair(pair)


@pytest.mark.parametrize("value", [
    {"type": "Point", "coordinates": [3, -4.5]},
    {"type": "linestring", "coordinates": [[0, 1], [5, -2], [2, 8]]},
    {"type": "multipoint", "coordinates": [[1, 1], [-3, 2]]},
    {"type": "polygon", "coordinates": [
        [[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]],
        [[20, 20], [30, 20], [30, 30], [20, 20]]]},
    {"type": "multilinestring", "coordinates": [[[0, 0], [1, 1]],
                                                [[5, -5], [6, 7]]]},
    {"type": "multipolygon", "coordinates": [
        [[[0, 0], [2, 0], [2, 2], [0, 0]]],
        [[[5, 5], [7, 5], [7, 9], [5, 5]]]]},
    {"type": "envelope", "coordinates": [[-3, 4], [5, -6]]},
    {"type": "circle", "coordinates": [1, 2], "radius": "50km"},
    {"type": "geometrycollection", "geometries": [
        {"type": "point", "coordinates": [9, 9]},
        {"type": "linestring", "coordinates": [[0, 0], [1, 3]]}]},
    "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
])
def test_the_bbox_table_reads_the_coordinates_as_the_shapes_do(value):
    """``shape_bbox`` (the column's fast path, no shape built) equals the
    JAX package's ``parse_shape(value).bbox()``, for every kind."""
    assert TG.shape_bbox(value) == JG.parse_shape(value).bbox()


def test_the_bbox_table_of_seeded_shapes_equals_the_parsed_ones():
    for _, src in rally_docs(300, seed=70):
        if "area" in src:
            assert TG.shape_bbox(src["area"]) == \
                JG.parse_shape(src["area"]).bbox()
