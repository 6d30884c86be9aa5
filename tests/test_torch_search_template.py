"""Stored scripts and search templates: the port against the JAX package.

``_scripts`` CRUD, ``_search/template`` (inline and stored, with and
without an index in the path) and ``_render/template`` go to a JAX
``Node`` and a port ``Node(device="cpu")`` through their REST
controllers (``torch_pair.NodePair``); statuses and bodies must be equal,
scores within rtol 1e-5. A rendered template's hits must also equal the
plain body's. The documents come from a seeded numpy generator. Mirrors
``tests/test_misc_apis.py``'s ``test_inline_template``,
``test_stored_template``, ``test_render`` and ``test_tojson``, and
``tests/test_rest.py``'s ``test_scripts_crud``.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.search.templates import (
    render_template as jrender_template,
)
from elasticsearch_tpu_torch.search.templates import render_template
from torch_pair import NodePair

COLORS = ["red", "blue", "green", "amber"]


@pytest.fixture()
def pair():
    p = NodePair()
    p.same("PUT", "/idx", {"settings": {"number_of_shards": 2,
                                        "refresh_interval": "-1"},
                           "mappings": {"properties": {
                               "color": {"type": "keyword"},
                               "text": {"type": "text"},
                               "n": {"type": "long"}}}})
    rng = np.random.default_rng(11)
    lines = []
    for i in range(40):
        lines += [{"index": {"_index": "idx", "_id": str(i)}},
                  {"color": str(rng.choice(COLORS)),
                   "text": " ".join(rng.choice(COLORS, size=3)),
                   "n": int(rng.integers(0, 10))}]
    p.same("POST", "/_bulk",
           "".join(json.dumps(x) + "\n" for x in lines).encode(),
           params={"refresh": "true"})
    yield p
    p.close()


def test_scripts_crud(pair):
    pair.same("PUT", "/_scripts/myscript", {
        "script": {"lang": "painless", "source": "params.x * 2"}})
    r = pair.same("GET", "/_scripts/myscript")
    assert r["found"] and r["script"]["source"] == "params.x * 2"
    pair.same("DELETE", "/_scripts/myscript")
    pair.same("GET", "/_scripts/myscript", status=404)
    pair.same("DELETE", "/_scripts/myscript", status=404)


def test_inline_template(pair):
    r = pair.same("POST", "/idx/_search/template", {
        "source": {"query": {"term": {"color": "{{c}}"}}},
        "params": {"c": "red"}})
    plain = pair.same("POST", "/idx/_search",
                      {"query": {"term": {"color": "red"}}})
    assert r["hits"] == plain["hits"]


def test_stored_template(pair):
    pair.same("PUT", "/_scripts/tmpl1", {"script": {
        "lang": "mustache",
        "source": '{"query": {"range": {"n": {"gte": {{min}}}}}}'}})
    r = pair.same("POST", "/idx/_search/template",
                  {"id": "tmpl1", "params": {"min": 3}})
    plain = pair.same("POST", "/idx/_search",
                      {"query": {"range": {"n": {"gte": 3}}}})
    assert r["hits"] == plain["hits"]
    pair.same("POST", "/idx/_search/template", {"id": "nope"}, status=404)
    pair.same("POST", "/idx/_search/template", {"params": {}}, status=400)


@pytest.mark.parametrize("word", ["red", "blue amber", "green"])
def test_stored_match_template_by_id_and_inline(pair, word):
    source = {"query": {"match": {"text": "{{q}}"}}, "size": "{{size}}"}
    pair.same("PUT", "/_scripts/q", {"script": {"lang": "mustache",
                                                "source": source}})
    by_id = pair.same("GET", "/_search/template",
                      {"id": "q", "params": {"q": word, "size": 7}})
    inline = pair.same("POST", "/idx/_search/template",
                       {"source": source, "params": {"q": word, "size": 7}})
    plain = pair.same("POST", "/idx/_search",
                      {"query": {"match": {"text": word}}, "size": 7})
    assert by_id["hits"] == inline["hits"] == plain["hits"]


@pytest.mark.parametrize("body", [
    {"source": {"query": {"match": {"f": "{{v}}"}}}, "params": {"v": "x y"}},
    {"source": '{"query": {"terms": {"tag": {{#toJson}}tags{{/toJson}}}}}',
     "params": {"tags": ["a", "b"]}},
    {"source": '{"size": {{n}}, "from": {{missing}}0}', "params": {"n": 3}},
    {"source": {"query": {"term": {"a.b": "{{deep.key}}"}}},
     "params": {"deep": {"key": 5}}},
    {"inline": "{\"query\": {{q}} }", "params": {"q": {"match_all": {}}}},
    {"source": "{not json {{x}}", "params": {"x": 1}}])
def test_render(pair, body):
    pair.same("POST", "/_render/template", body)


def test_render_stored(pair):
    pair.same("PUT", "/_scripts/r", {"script": {
        "lang": "mustache", "source": {"query": {"match": {
            "text": "{{q}}"}}}}})
    r = pair.same("GET", "/_render/template", {"id": "r",
                                               "params": {"q": "red"}})
    assert r["template_output"] == {"query": {"match": {"text": "red"}}}


@pytest.mark.parametrize("seed", range(6))
def test_render_template_agrees(seed):
    """Seeded templates and params through both renderers."""
    rng = np.random.default_rng(seed)
    params = {f"p{i}": (str(rng.choice(COLORS)) if i % 2
                        else int(rng.integers(0, 99))) for i in range(4)}
    params["lst"] = [str(c) for c in rng.choice(COLORS, size=2)]
    template = json.dumps({"query": {"bool": {"should": [
        {"term": {"color": "{{p1}}"}}, {"range": {"n": {"gte": "{{p0}}"}}},
        {"match": {"text": "{{p3}} {{nope}}"}}]}},
        "size": "{{p2}}"}).replace('"{{p0}}"', "{{p0}}").replace(
        '"{{p2}}"', "{{p2}}")
    template = template[:-1] + ', "x": {{#toJson}}lst{{/toJson}}}'
    assert render_template(template, params) == jrender_template(
        template, params)
