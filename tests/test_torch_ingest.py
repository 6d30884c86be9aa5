"""Ingest pipelines on the port, against the JAX package.

Every processor runs through ``_ingest/pipeline/_simulate`` on both
packages with the same pipeline and documents, and the outputs must be
equal (a failing processor's error too, by type and reason). Then the
geoip and user_agent cases of tests/test_ingest_plugins.py (its other
eight cases, the ``_size`` field and the phrase and completion
suggesters, are in tests/test_torch_percolate_suggest.py), the pipeline CRUD
routes, ``?pipeline=`` on a single index request and on ``_bulk``
(request-level and per item, a dropped doc a ``noop``), and pipelines
surviving a restart through a durable node's global ``_state``.
"""

import pytest

from elasticsearch_tpu_torch.node import Node
from torch_pair import NodePair

CHROME_UA = ("Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
             "(KHTML, like Gecko) Chrome/70.0.3538.77 Safari/537.36")

NGINX_LINE = ('81.2.69.145 - alice [17/10/2023:13:55:36] "GET /a/b?c=1 '
              'HTTP/1.1" 404 1234 "-" "' + CHROME_UA + '"')

PROCESSOR_CASES = {
    "set": ([{"set": {"field": "a.b", "value": "{{x}}-y"}}], {"x": 1}),
    "set_no_override": ([{"set": {"field": "x", "value": 9,
                                  "override": False}}], {"x": 1}),
    "remove": ([{"remove": {"field": ["x", "y"]}}], {"x": 1, "y": 2, "z": 3}),
    "remove_missing": ([{"remove": {"field": "q"}}], {"x": 1}),
    "remove_ignore_missing": ([{"remove": {"field": "q",
                                           "ignore_missing": True}}],
                              {"x": 1}),
    "rename": ([{"rename": {"field": "x", "target_field": "n.y"}}],
               {"x": 1}),
    "rename_missing": ([{"rename": {"field": "q", "target_field": "y"}}],
                       {"x": 1}),
    "convert": ([{"convert": {"field": "a", "type": "integer"}},
                 {"convert": {"field": "b", "type": "float"}},
                 {"convert": {"field": "c", "type": "boolean"}},
                 {"convert": {"field": "d", "type": "auto",
                              "target_field": "e"}},
                 {"convert": {"field": "f", "type": "string"}}],
                {"a": "12", "b": "1.5", "c": "TRUE", "d": "3.25", "f": 7}),
    "convert_bad": ([{"convert": {"field": "a", "type": "integer"}}],
                    {"a": "x"}),
    "case": ([{"lowercase": {"field": "a"}},
              {"uppercase": {"field": "b", "target_field": "c"}}],
             {"a": "MiXeD", "b": "up"}),
    "trim_split_join": ([{"trim": {"field": "a"}},
                         {"split": {"field": "a", "separator": ","}},
                         {"join": {"field": "a", "separator": "|",
                                   "target_field": "b"}}],
                        {"a": "  x,y,z  "}),
    "gsub": ([{"gsub": {"field": "a", "pattern": "[0-9]",
                        "replacement": "#"}}], {"a": "a1b22"}),
    "append": ([{"append": {"field": "tags", "value": ["{{x}}", "b"]}},
                {"append": {"field": "one", "value": "z"}}],
               {"x": "a", "one": "y"}),
    "json": ([{"json": {"field": "raw", "target_field": "parsed"}},
              {"json": {"field": "root", "add_to_root": True}}],
             {"raw": '{"k": [1, 2]}', "root": '{"r": true}'}),
    "json_bad": ([{"json": {"field": "raw"}}], {"raw": "{nope"}),
    "kv": ([{"kv": {"field": "m", "field_split": "&", "value_split": "=",
                    "target_field": "q"}}], {"m": "a=1&b=2&c"}),
    "date": ([{"date": {"field": "t", "formats": ["dd/MM/yyyy:HH:mm:ss"]}},
              {"date": {"field": "u", "formats": ["UNIX"],
                        "target_field": "u2"}},
              {"date": {"field": "i", "target_field": "i2"}}],
             {"t": "17/10/2023:13:55:36", "u": "1700000000",
              "i": "2023-10-17T01:02:03Z"}),
    "date_bad": ([{"date": {"field": "t", "formats": ["yyyy"]}}],
                 {"t": "not a date"}),
    "fail": ([{"fail": {"message": "bad {{x}}"}}], {"x": "doc"}),
    "drop": ([{"set": {"field": "a", "value": 1}}, {"drop": {}},
              {"set": {"field": "b", "value": 2}}], {"x": 1}),
    "dot_expander": ([{"dot_expander": {"field": "a.b"}}], {"a.b": 1}),
    "grok": ([{"grok": {"field": "message", "patterns": [
        '%{IP:client.ip} - %{USERNAME:user} \\[%{DATA:time}\\] '
        '"%{HTTPMETHOD:method} %{NOTSPACE:url} HTTP/%{NUMBER:version}" '
        '%{INT:status:int} %{NUMBER:bytes:float} "%{DATA:referrer}" '
        '"%{DATA:agent}"']}}], {"message": NGINX_LINE}),
    "grok_no_match": ([{"grok": {"field": "m", "patterns": ["%{INT:n}x"]}}],
                      {"m": "abc"}),
    "script": ([{"script": {"source": "ctx.n = ctx.a * params.k; "
                                      "ctx._index = 'other'",
                            "params": {"k": 3}}}], {"a": 2}),
    "on_failure_processor": ([{"rename": {
        "field": "q", "target_field": "y",
        "on_failure": [{"set": {"field": "err",
                                "value": "{{_ingest.on_failure_message}}"}}]}}],
        {"x": 1}),
    "on_failure_pipeline": ([{"fail": {"message": "boom"}}], {"x": 1}),
    "ignore_failure": ([{"convert": {"field": "a", "type": "integer",
                                     "ignore_failure": True}},
                        {"set": {"field": "after", "value": True}}],
                       {"a": "x"}),
    "geoip": ([{"geoip": {"field": "ip"}}], {"ip": "1.1.1.1"}),
    "user_agent": ([{"user_agent": {"field": "agent"}}],
                   {"agent": CHROME_UA}),
    "nginx": ([
        {"grok": {"field": "message", "patterns": [
            '%{IP:source.ip} - %{DATA:user.name} \\[%{DATA:nginx.time}\\] '
            '"%{WORD:http.method} %{DATA:url.original} HTTP/%{NUMBER:'
            'http.version}" %{NUMBER:http.status} %{NUMBER:http.bytes} '
            '"%{DATA:http.referrer}" "%{DATA:user_agent.original}"']}},
        {"date": {"field": "nginx.time",
                  "formats": ["dd/MM/yyyy:HH:mm:ss"]}},
        {"geoip": {"field": "source.ip", "target_field": "source.geo"}},
        {"user_agent": {"field": "user_agent.original"}},
        {"convert": {"field": "http.status", "type": "integer"}},
        {"convert": {"field": "http.bytes", "type": "long"}},
        {"remove": {"field": ["message", "nginx.time"]}}],
        {"message": NGINX_LINE}),
}


@pytest.fixture()
def pair():
    p = NodePair()
    yield p
    p.close()


@pytest.mark.parametrize("case", sorted(PROCESSOR_CASES))
def test_every_processor_simulates_like_jax(pair, case):
    processors, doc = PROCESSOR_CASES[case]
    pipeline = {"description": case, "processors": processors}
    if case == "on_failure_pipeline":
        pipeline["on_failure"] = [{"set": {"field": "handled",
                                           "value": True}}]
    out = pair.same("POST", "/_ingest/pipeline/_simulate", {
        "pipeline": pipeline,
        "docs": [{"_index": "i", "_id": "1", "_source": doc}]}, status=200)
    assert len(out["docs"]) == 1


class TestGeoIp:
    """tests/test_ingest_plugins.py's geoip cases, in both packages."""

    def _run(self, pair, processor, doc, expect_error=False):
        outs = []
        for node in (pair.j, pair.t):
            node.ingest.put_pipeline("geo", {"processors": [
                {"geoip": processor}]})
            if expect_error:
                with pytest.raises(Exception) as ei:
                    node.index_doc("logs", "1", doc, pipeline="geo")
                outs.append(str(ei.value))
            else:
                node.index_doc("logs", "1", doc, pipeline="geo")
                outs.append(node.get_doc("logs", "1")["_source"])
        assert outs[0] == outs[1]
        return outs[1]

    def test_lookup_and_properties(self, pair):
        src = self._run(pair, {"field": "ip"}, {"ip": "8.8.8.8"})
        assert src["geoip"]["country_iso_code"] == "US"
        assert src["geoip"]["city_name"] == "Mountain View"
        assert src["geoip"]["location"] == {"lat": 37.386, "lon": -122.0838}

    def test_target_field_and_selected_properties(self, pair):
        src = self._run(pair, {"field": "ip", "target_field": "geo",
                               "properties": ["country_iso_code"]},
                        {"ip": "81.2.69.145"})
        assert src["geo"] == {"country_iso_code": "GB"}

    def test_unresolvable_ip_adds_nothing(self, pair):
        src = self._run(pair, {"field": "ip"}, {"ip": "10.0.0.1"})
        assert "geoip" not in src

    def test_ipv6(self, pair):
        src = self._run(pair, {"field": "ip"}, {"ip": "2001:4860:4860::8888"})
        assert src["geoip"]["country_iso_code"] == "US"

    def test_bad_ip_fails(self, pair):
        reason = self._run(pair, {"field": "ip"}, {"ip": "not-an-ip"},
                           expect_error=True)
        assert "not an IP string" in reason

    def test_missing_field_with_ignore_missing(self, pair):
        src = self._run(pair, {"field": "ip", "ignore_missing": True},
                        {"msg": "no ip"})
        assert src == {"msg": "no ip"}

    def test_database_file(self, pair, tmp_path):
        db = tmp_path / "db.json"
        db.write_text('[{"cidr": "192.0.2.0/24", "country_iso_code": "ZZ",'
                      ' "city_name": "Docs"}]')
        src = self._run(pair, {"field": "ip", "database_file": str(db)},
                        {"ip": "192.0.2.7"})
        assert src["geoip"] == {"country_iso_code": "ZZ",
                                "city_name": "Docs"}


class TestUserAgent:
    def _run(self, pair, processor, doc, field):
        outs = []
        for node in (pair.j, pair.t):
            node.ingest.put_pipeline("ua", {"processors": [
                {"user_agent": processor}]})
            node.index_doc("logs", "1", doc, pipeline="ua")
            outs.append(node.get_doc("logs", "1")["_source"][field])
        assert outs[0] == outs[1]
        return outs[1]

    def test_chrome_on_windows(self, pair):
        ua = self._run(pair, {"field": "agent"}, {"agent": CHROME_UA},
                       "user_agent")
        assert ua["name"] == "Chrome" and ua["major"] == "70"
        assert ua["os"]["name"] == "Windows 10"

    def test_curl(self, pair):
        ua = self._run(pair, {"field": "agent", "target_field": "ua"},
                       {"agent": "curl/7.54.0"}, "ua")
        assert ua["name"] == "curl" and ua["version"] == "7.54"

    def test_unknown_agent(self, pair):
        ua = self._run(pair, {"field": "agent"}, {"agent": "my-bot-thing"},
                       "user_agent")
        assert ua["name"] == "Other"


PIPE = {"description": "tags docs", "processors": [
    {"set": {"field": "tagged", "value": "{{kind}}"}},
    {"script": {"source": "if (ctx.kind == 'skip') { ctx.dropme = true }"}},
]}


def test_pipeline_crud_like_jax(pair):
    pair.same("PUT", "/_ingest/pipeline/p1", PIPE, status=200)
    pair.same("PUT", "/_ingest/pipeline/p2", {"processors": [
        {"lowercase": {"field": "kind"}}]}, status=200)
    pair.same("GET", "/_ingest/pipeline", status=200)
    pair.same("GET", "/_ingest/pipeline/p1", status=200)
    pair.same("GET", "/_ingest/pipeline/nope", status=404)
    pair.same("PUT", "/_ingest/pipeline/bad", {"processors": [
        {"frobnicate": {}}]}, status=400)
    pair.same("POST", "/_ingest/pipeline/p1/_simulate", {
        "docs": [{"_source": {"kind": "a"}}, {"_source": {"kind": "skip"}}]},
        status=200)
    pair.same("GET", "/_ingest/pipeline/_simulate", {
        "id": "p2", "docs": [{"_source": {"kind": "AbC"}}]}, status=200)
    pair.same("DELETE", "/_ingest/pipeline/p2", status=200)
    pair.same("DELETE", "/_ingest/pipeline/p2", status=404)
    pair.same("GET", "/_ingest/pipeline", status=200)


def test_pipeline_on_index_and_bulk_like_jax(pair):
    pair.same("PUT", "/_ingest/pipeline/tag", {"processors": [
        {"set": {"field": "tagged", "value": "{{kind}}"}}]}, status=200)
    pair.same("PUT", "/_ingest/pipeline/dropper", {"processors": [
        {"drop": {}}]}, status=200)
    pair.same("PUT", "/_ingest/pipeline/upper", {"processors": [
        {"uppercase": {"field": "kind"}}]}, status=200)
    pair.same("PUT", "/logs", {"settings": {"number_of_shards": 2,
                                            "refresh_interval": -1}},
              status=200)
    pair.same("PUT", "/logs/_doc/1", {"kind": "a"},
              params={"pipeline": "tag"}, status=201)
    pair.same("PUT", "/logs/_doc/2", {"kind": "b"},
              params={"pipeline": "dropper"}, status=200)
    pair.same("PUT", "/logs/_doc/3", {"kind": "c"},
              params={"pipeline": "missing"}, status=400)
    bulk = (b'{"index":{"_index":"logs","_id":"4"}}\n{"kind":"d"}\n'
            b'{"index":{"_index":"logs","_id":"5","pipeline":"upper"}}\n'
            b'{"kind":"e"}\n'
            b'{"create":{"_index":"logs","_id":"6","pipeline":"dropper"}}\n'
            b'{"kind":"f"}\n'
            b'{"index":{"_index":"logs","_id":"7","pipeline":"nope"}}\n'
            b'{"kind":"g"}\n')
    out = pair.same("POST", "/_bulk", bulk, params={"pipeline": "tag"},
                    status=200)
    assert [next(iter(i.values()))["status"] for i in out["items"]] == \
        [201, 201, 201, 400]
    pair.same("POST", "/logs/_refresh", status=200)
    found = pair.same("POST", "/logs/_search", {
        "query": {"match_all": {}}, "sort": ["_id"], "size": 10},
        status=200)
    assert [h["_source"] for h in found["hits"]["hits"]] == [
        {"kind": "a", "tagged": "a"}, {"kind": "d", "tagged": "d"},
        {"kind": "E"}]


def test_simulated_output_equals_what_is_indexed(pair):
    processors, doc = PROCESSOR_CASES["nginx"]
    node = pair.t
    node.ingest.put_pipeline("nginx", {"processors": processors})
    sim = node.ingest.simulate({"id": "nginx", "docs": [{"_source": doc}]})
    node.bulk([("index", {"_index": "web", "_id": "1"}, doc)],
              refresh=True, pipeline="nginx")
    assert node.get_doc("web", "1")["_source"] == \
        sim["docs"][0]["doc"]["_source"]


def test_pipelines_survive_a_restart(tmp_path):
    d = str(tmp_path / "data")
    node = Node(data_path=d, device="cpu")
    try:
        node.ingest.put_pipeline("keep", PIPE)
        node.ingest.put_pipeline("gone", PIPE)
        node.ingest.delete_pipeline("gone")
    finally:
        node.close()
    node = Node(data_path=d, device="cpu")
    try:
        assert node.ingest.get_pipeline() == {"keep": PIPE}
        node.index_doc("i", "1", {"kind": "x"}, pipeline="keep")
        assert node.get_doc("i", "1")["_source"]["tagged"] == "x"
    finally:
        node.close()
