"""Parity of the port's field types with the JAX package's.

Mirrors tests/test_field_types_extended.py (the range family, token_count,
binary and murmur3; each case runs on a JAX ``IndexService`` and a port
``IndexService(device="cpu")`` with the same documents and must give the
same ids, or the same error type), tests/test_mapper.py's ``parse_ip`` /
``format_ip`` and full-document parse cases, and the parsing of the
scalar types the port adds (short, byte, half_float, scaled_float): the
accepted forms give the same doc values, out-of-range and malformed
values the same ``MapperParsingException`` message.
"""

import numpy as np
import pytest

from elasticsearch_tpu.analysis.analyzers import AnalysisRegistry as JAnalysis
from elasticsearch_tpu.common.errors import (
    MapperParsingException as JMapperParsingException,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.mapper import field_types as jft
from elasticsearch_tpu.mapper.mapping import MapperService as JMapper
from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import MapperParsingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.mapper import field_types as tft
from elasticsearch_tpu_torch.mapper.mapping import MapperService


def hit_ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


def make_pair(name, mapping, docs):
    """A one-shard JAX index and a port index holding ``docs``."""
    jidx = JIndex(name, JSettings({"index.number_of_shards": 1,
                                   "index.requests.cache.enable": False}))
    jidx.put_mapping(mapping)
    tidx = IndexService(name, Settings({"index.number_of_shards": 1}),
                        mapping=mapping, device="cpu")
    for doc_id, src in docs:
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


def same_ids(pair, body):
    jidx, tidx = pair
    jr, tr = jidx.search(body), tidx.search(body)
    assert tr["_plane"] == jr["_plane"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert hit_ids(tr) == hit_ids(jr)
    return hit_ids(tr)


RANGE_MAPPING = {"properties": {
    "age_range": {"type": "integer_range"},
    "temp": {"type": "float_range"},
    "window": {"type": "date_range"},
    "net": {"type": "ip_range"},
}}
RANGE_DOCS = [
    ("1", {"age_range": {"gte": 10, "lte": 20}}),
    ("2", {"age_range": {"gt": 20, "lt": 30}}),  # (20,30) -> [21,29]
    ("3", {"age_range": {"gte": 5, "lte": 50}}),
    ("4", {"temp": {"gte": 1.5, "lte": 2.5}}),
    ("5", {"window": {"gte": "2017-01-01", "lte": "2017-06-30"}}),
    ("6", {"net": "10.0.0.0/8"}),
]


@pytest.fixture(scope="module")
def ranges():
    pair = make_pair("ranges", RANGE_MAPPING, RANGE_DOCS)
    yield pair
    for idx in pair:
        idx.close()


class TestRangeFields:
    def test_term_point_containment(self, ranges):
        assert same_ids(ranges, {"query": {"term": {"age_range": 15}}}) \
            == ["1", "3"]
        assert same_ids(ranges, {"query": {"term": {"age_range": 25}}}) \
            == ["2", "3"]

    def test_exclusive_bounds(self, ranges):
        assert same_ids(ranges, {"query": {"term": {"age_range": 20}}}) \
            == ["1", "3"]

    def test_range_intersects_default(self, ranges):
        assert same_ids(ranges, {"query": {"range": {
            "age_range": {"gte": 18, "lte": 22}}}}) == ["1", "2", "3"]

    def test_range_within(self, ranges):
        assert same_ids(ranges, {"query": {"range": {"age_range": {
            "gte": 9, "lte": 35, "relation": "within"}}}}) == ["1", "2"]

    def test_range_contains(self, ranges):
        assert same_ids(ranges, {"query": {"range": {"age_range": {
            "gte": 12, "lte": 18, "relation": "contains"}}}}) == ["1", "3"]

    def test_float_range(self, ranges):
        assert same_ids(ranges, {"query": {"term": {"temp": 2.0}}}) == ["4"]
        assert same_ids(ranges, {"query": {"term": {"temp": 3.0}}}) == []

    def test_date_range(self, ranges):
        assert same_ids(ranges, {"query": {"term": {
            "window": "2017-03-01"}}}) == ["5"]
        assert same_ids(ranges, {"query": {"range": {"window": {
            "gte": "2017-06-01", "lte": "2017-12-31"}}}}) == ["5"]

    def test_ip_range_cidr(self, ranges):
        assert same_ids(ranges, {"query": {"term": {"net": "10.1.2.3"}}}) \
            == ["6"]
        assert same_ids(ranges, {"query": {"term": {"net": "11.0.0.1"}}}) \
            == []

    def test_exists_on_range(self, ranges):
        assert same_ids(ranges, {"query": {"exists": {
            "field": "age_range"}}}) == ["1", "2", "3"]

    def test_malformed_range_rejected(self, ranges):
        jidx, tidx = ranges
        for bad in ({"age_range": {"bogus": 1}}, {"age_range": 17}):
            with pytest.raises(JMapperParsingException) as je:
                jidx.index_doc("x", bad)
            with pytest.raises(MapperParsingException) as te:
                tidx.index_doc("x", bad)
            assert str(te.value) == str(je.value)


def test_token_count_subfield():
    pair = make_pair("tc", {"properties": {"name": {
        "type": "text",
        "fields": {"length": {"type": "token_count", "analyzer": "standard"}},
    }}}, [("1", {"name": "John Smith"}),
          ("2", {"name": "Rachel Alice Williams"})])
    try:
        assert same_ids(pair, {"query": {"term": {"name.length": 3}}}) \
            == ["2"]
        assert same_ids(pair, {"query": {"range": {
            "name.length": {"lte": 2}}}}) == ["1"]
    finally:
        for idx in pair:
            idx.close()


def test_binary_stored_not_searchable():
    pair = make_pair("bin", {"properties": {"blob": {"type": "binary"}}},
                     [("1", {"blob": "U29tZSBiaW5hcnkgYmxvYg=="})])
    try:
        jr, tr = (idx.search({"query": {"match_all": {}}}) for idx in pair)
        assert tr["hits"]["hits"][0]["_source"] == \
            jr["hits"]["hits"][0]["_source"] == {
                "blob": "U29tZSBiaW5hcnkgYmxvYg=="}
    finally:
        for idx in pair:
            idx.close()


def test_binary_invalid_base64():
    mapping = {"properties": {"blob": {"type": "binary", "doc_values": True}}}
    pair = make_pair("bin2", mapping, [])
    try:
        with pytest.raises(JMapperParsingException) as je:
            pair[0].index_doc("1", {"blob": "not!!base64&&"})
        with pytest.raises(MapperParsingException) as te:
            pair[1].index_doc("1", {"blob": "not!!base64&&"})
        assert str(te.value) == str(je.value)
    finally:
        for idx in pair:
            idx.close()


def test_murmur3_cardinality():
    pair = make_pair("m3", {"properties": {"tag": {
        "type": "keyword", "fields": {"hash": {"type": "murmur3"}}}}},
        [(str(i), {"tag": t}) for i, t in
         enumerate(["a", "b", "a", "c", "b", "a"])])
    try:
        body = {"size": 0,
                "aggs": {"distinct": {"cardinality": {"field": "tag.hash"}}}}
        jr, tr = (idx.search(body) for idx in pair)
        assert tr["aggregations"] == jr["aggregations"]
        assert tr["aggregations"]["distinct"]["value"] == 3
    finally:
        for idx in pair:
            idx.close()


def test_ip_parse_and_format():
    for mod in (jft, tft):
        assert mod.format_ip(mod.parse_ip("192.168.1.1")) == "192.168.1.1"
        assert mod.format_ip(mod.parse_ip("::1")) == "::1"
        assert mod.parse_ip("10.0.0.2") > mod.parse_ip("10.0.0.1")
    for v in ("10.0.0.1", "::ffff:10.0.0.1", "2001:db8::ff00:42:8329",
              "FE80::1", "0.0.0.0", "255.255.255.255"):
        assert tft.parse_ip(v) == jft.parse_ip(v)
        assert tft.format_ip(tft.parse_ip(v)) == jft.format_ip(jft.parse_ip(v))
    with pytest.raises(JMapperParsingException) as je:
        jft.parse_ip("not-an-ip")
    with pytest.raises(MapperParsingException) as te:
        tft.parse_ip("not-an-ip")
    assert str(te.value) == str(je.value)


FULL_MAPPING = {"properties": {
    "title": {"type": "text", "fielddata": True,
              "fields": {"raw": {"type": "keyword"},
                         "length": {"type": "token_count"}}},
    "views": {"type": "long"},
    "n_short": {"type": "short"},
    "n_byte": {"type": "byte"},
    "half": {"type": "half_float"},
    "price": {"type": "scaled_float", "scaling_factor": 100},
    "addr": {"type": "ip"},
    "loc": {"type": "geo_point"},
    "span": {"type": "long_range"},
    "when": {"type": "date_range", "format": "dd/MM/yyyy"},
    "blob": {"type": "binary", "doc_values": True},
    "hash": {"type": "murmur3"},
}}


def parsed_fields(parsed):
    return {k: getattr(parsed, k) for k in (
        "terms", "numeric_values", "string_values", "geo_values",
        "range_values")}


@pytest.mark.parametrize("src", [
    {"title": "The Quick Fox", "views": 42, "n_short": -32768,
     "n_byte": 127, "half": 0.1, "price": 1.23456, "addr": "192.168.0.1",
     "loc": {"lat": 52.37, "lon": 4.9}, "span": {"gte": 3, "lt": 9},
     "when": {"gt": "01/02/2017", "lte": "03/04/2017"},
     "blob": "aGVsbG8=", "hash": "abc"},
    {"title": ["two values", "here"], "addr": ["::1", "10.0.0.7"],
     "loc": ["41.12,-71.34", {"lat": -90, "lon": 180}],
     "span": [{"gte": 1}, {"lte": -4}], "price": "19.999",
     "n_short": "12", "half": 3},
])
def test_parse_full_doc(src):
    """The same document parses to the same terms and values in both
    packages, for every new type and each accepted input form."""
    jm = JMapper(JAnalysis(), FULL_MAPPING)
    tm = MapperService(AnalysisRegistry(), FULL_MAPPING)
    assert parsed_fields(tm.parse_document("1", src)) == \
        parsed_fields(jm.parse_document("1", src))


@pytest.mark.parametrize("field,value", [
    ("n_short", 32768), ("n_short", -32769), ("n_byte", 128),
    ("n_byte", -129), ("n_byte", "x"), ("n_short", True), ("half", "nan"),
    ("price", "cheap"), ("views", 2 ** 63), ("addr", "300.1.1.1"),
    ("addr", "not-an-ip"), ("loc", {"lat": 91, "lon": 0}),
    ("loc", {"lat": 0, "lon": -181}), ("loc", "1,2,3"), ("loc", 7),
    ("span", {"gte": 1, "from": 2}), ("span", 5),
    ("when", {"gte": "2017-01-01"}), ("blob", "no*base64"),
])
def test_bad_values_give_the_same_error(field, value):
    jm = JMapper(JAnalysis(), FULL_MAPPING)
    tm = MapperService(AnalysisRegistry(), FULL_MAPPING)
    with pytest.raises(JMapperParsingException) as je:
        jm.parse_document("1", {field: value})
    with pytest.raises(MapperParsingException) as te:
        tm.parse_document("1", {field: value})
    assert str(te.value) == str(je.value)


def test_scaled_float_needs_its_factor():
    with pytest.raises(JMapperParsingException) as je:
        JMapper(JAnalysis(), {"properties": {"p": {"type": "scaled_float"}}})
    with pytest.raises(MapperParsingException) as te:
        MapperService(AnalysisRegistry(),
                      {"properties": {"p": {"type": "scaled_float"}}})
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("typ", ["geo_shape", "percolator", "completion"])
def test_types_of_later_slices_still_raise(typ):
    """The three types of the field-type remainder map since that slice
    (a document parses into the JAX package's values); an unknown type
    still raises "No handler for type"."""
    value = {"geo_shape": {"type": "point", "coordinates": [1.0, 2.0]},
             "percolator": {"match": {"t": "x"}},
             "completion": {"input": ["ab", "ac"], "weight": 3}}[typ]
    mapping = {"properties": {"f": {"type": typ}}}
    got = MapperService(AnalysisRegistry(), mapping).parse_document(
        "1", {"f": value})
    want = JMapper(JAnalysis(), mapping).parse_document("1", {"f": value})
    for store in ("terms", "numeric_values", "string_values",
                  "shape_values"):
        assert getattr(got, store) == getattr(want, store), store
    with pytest.raises(MapperParsingException, match="No handler for type"):
        MapperService(AnalysisRegistry(),
                      {"properties": {"f": {"type": f"{typ}_x"}}})


def test_field_type_table_covers_the_jax_scalar_types():
    assert set(tft.FIELD_TYPES) == set(jft.FIELD_TYPES)


@pytest.mark.parametrize("value", [
    "question", {"name": "answer", "parent": "q1"}, "comment",
    {"name": "answer"}, {"name": "question", "parent": "q1"}, 7,
    {"name": "answer", "parent": 42}])
def test_join_field_parses_like_jax(value):
    """The join field's relation name and parent id, and its four 400s,
    as the JAX package parses them (the join field joined the types in
    the nested and join slice)."""
    params = {"type": "join", "relations": {"question": ["answer"]}}
    jf = jft.create_field_type("qa", params)
    tf = tft.create_field_type("qa", params)
    try:
        want = jf.parse_join(value)
    except Exception as e:  # noqa: BLE001 — the JAX message to match
        with pytest.raises(MapperParsingException) as te:
            tf.parse_join(value)
        assert str(te.value) == str(e)
        return
    assert tf.parse_join(value) == want
    assert tf.index_terms(value, None) == jf.index_terms(value, None)


def test_scalar_doc_values_equal_jax():
    rng = np.random.RandomState(5)
    for typ, params in (("short", {}), ("byte", {}), ("half_float", {}),
                        ("scaled_float", {"scaling_factor": 10}),
                        ("scaled_float", {"scaling_factor": 0.5})):
        jf = jft.create_field_type("f", {"type": typ, **params})
        tf = tft.create_field_type("f", {"type": typ, **params})
        for v in rng.uniform(-100, 100, 50).tolist() + [0, -0.0, "7", 1e-9]:
            assert tf.doc_value(v) == jf.doc_value(v)
            assert tf.numeric_for_query(v) == jf.numeric_for_query(v)
