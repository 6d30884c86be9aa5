"""Parity of the port's analysis chain with the JAX package's.

Mirrors tests/test_analysis.py: the same texts go through a JAX
``AnalysisRegistry`` and the port's, built from the same settings, and
give the same tokens and offsets (exactly); the same unknown components
raise the same errors. An index with a custom analyzer (html_strip,
standard, lowercase, stop, the stemmer) and the ``english`` analyzer
answers ``match``, ``match_phrase`` (over removed stopwords: positions
are renumbered without gaps in both) and ``query_string`` equally.
"""

import numpy as np
import pytest

from elasticsearch_tpu.analysis import analyzers as J
from elasticsearch_tpu.common.errors import IllegalArgumentException as JIAE
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu_torch.analysis import analyzers as T
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from test_torch_mesh import compare

TEXTS = [
    "The QUICK brown-fox, 42!",
    "abc 123 Def",
    "Foo Bar",
    "New York",
    "the quick fox",
    "the running dogs jumped over cities quickly",
    "<p>hello <b>world</b></p> & friends",
    "Crème brûlée à la carte",
    "  spaced   out\ttabs\nlines  ",
    "",
    "repeat repeat Repeat unique",
    "edge_cases__with_underscores and-dashes",
]
BUILTINS = ["standard", "simple", "whitespace", "keyword", "stop",
            "english", "snowball"]

CUSTOM = {"index": {"analysis": {
    "char_filter": {
        "my_map": {"type": "mapping", "mappings": ["& => and", "ü => ue"]},
        "digits": {"type": "pattern_replace", "pattern": "[0-9]+",
                   "replacement": "#"},
        "strip": {"type": "html_strip"},
    },
    "tokenizer": {
        "grams": {"type": "edge_ngram", "min_gram": 2, "max_gram": 4},
        "tri": {"type": "ngram", "min_gram": 2, "max_gram": 3},
        "commas": {"type": "pattern", "pattern": ",\\s*"},
        "ws": {"type": "whitespace"},
    },
    "filter": {
        "my_stop": {"type": "stop", "stopwords": ["a", "the", "and"]},
        "en_stop": {"type": "stop", "stopwords": "_english_"},
        "len": {"type": "length", "min": 3, "max": 6},
        "cut": {"type": "truncate", "length": 4},
        "sh": {"type": "shingle", "min_shingle_size": 2,
               "max_shingle_size": 3, "output_unigrams": False},
        "folded": {"type": "asciifolding"},
    },
    "analyzer": {
        "my_an": {"type": "custom", "tokenizer": "standard",
                  "char_filter": ["my_map"],
                  "filter": ["lowercase", "my_stop"]},
        "ac": {"tokenizer": "grams", "filter": ["lowercase"]},
        "tri": {"tokenizer": "tri", "filter": ["uppercase"]},
        "csv": {"tokenizer": "commas", "filter": ["trim", "unique"]},
        "html": {"tokenizer": "standard", "char_filter": ["strip", "digits"],
                 "filter": ["lowercase", "en_stop", "porter_stem"]},
        "chain": {"tokenizer": "ws",
                  "filter": ["folded", "lowercase", "len", "cut",
                             "reverse"]},
        "shingles": {"tokenizer": "standard",
                     "filter": ["lowercase", "sh"]},
        "alias": {"type": "english"},
    },
}}}
CUSTOM_NAMES = sorted(CUSTOM["index"]["analysis"]["analyzer"])


def registries(settings=None):
    if settings is None:
        return J.AnalysisRegistry(), T.AnalysisRegistry()
    return (J.AnalysisRegistry(JSettings.from_dict(settings)),
            T.AnalysisRegistry(Settings.from_dict(settings)))


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_tokens_and_offsets_equal(name):
    jreg, treg = registries()
    for text in TEXTS:
        assert (treg.get(name).analyze_tokens(text)
                == jreg.get(name).analyze_tokens(text)), (name, text)


@pytest.mark.parametrize("name", CUSTOM_NAMES)
def test_custom_tokens_and_offsets_equal(name):
    jreg, treg = registries(CUSTOM)
    for text in TEXTS + ["a, b,c ,  d, a", "Search", "Füße & Ärger 2024"]:
        assert (treg.get(name).analyze_tokens(text)
                == jreg.get(name).analyze_tokens(text)), (name, text)
    assert treg.default().name == jreg.default().name == "standard"


def test_components_equal():
    for lo, hi, edge in ((2, 3, False), (1, 3, True), (1, 1, False)):
        assert (T.make_ngram_tokenizer(lo, hi, edge)("abcd")
                == J.make_ngram_tokenizer(lo, hi, edge)("abcd"))
    toks = [("quick", 0, 5), ("brown", 6, 11), ("fox", 12, 15)]
    assert T.make_shingle_filter(2, 2)(toks) == J.make_shingle_filter(2, 2)(toks)
    assert (T.html_strip_char_filter("<p>hello <b>world</b></p>")
            == J.html_strip_char_filter("<p>hello <b>world</b></p>"))
    for w in ("dogs", "cities", "running", "hopped", "quickly", "sses",
              "caresses", "ponies", "is", "agreed", "fuzzing"):
        assert T.porter_light_stem(w) == J.porter_light_stem(w), w
    assert T.ENGLISH_STOP_WORDS == J.ENGLISH_STOP_WORDS


@pytest.mark.parametrize("analysis", [
    {"analyzer": {"bad": {"tokenizer": "standard", "filter": ["nope"]}}},
    {"analyzer": {"bad": {"tokenizer": "nope"}}},
    {"analyzer": {"bad": {"tokenizer": "standard", "char_filter": ["x"]}}},
    {"filter": {"f": {"type": "nope"}}},
    {"tokenizer": {"t": {"type": "nope"}}},
    {"char_filter": {"c": {"type": "nope"}}},
    {"char_filter": {"c": {"type": "mapping", "mappings": ["no arrow"]}}},
])
def test_unknown_components_raise_the_same_error(analysis):
    settings = {"index": {"analysis": analysis}}
    with pytest.raises(JIAE) as jerr:
        J.AnalysisRegistry(JSettings.from_dict(settings))
    with pytest.raises(IllegalArgumentException) as terr:
        T.AnalysisRegistry(Settings.from_dict(settings))
    assert str(terr.value) == str(jerr.value)


def test_unknown_analyzer_raises_the_same_error():
    jreg, treg = registries()
    with pytest.raises(JIAE) as jerr:
        jreg.get("nope")
    with pytest.raises(IllegalArgumentException) as terr:
        treg.get("nope")
    assert str(terr.value) == str(jerr.value)


INDEX_ANALYSIS = {"analysis": {
    "filter": {"en_stop": {"type": "stop", "stopwords": "_english_"}},
    "analyzer": {"prose": {"type": "custom", "tokenizer": "standard",
                           "char_filter": ["html_strip"],
                           "filter": ["lowercase", "en_stop", "stemmer"]}},
}}
INDEX_MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "prose"},
    "summary": {"type": "text", "analyzer": "english"},
}}
WORDS = ["the", "running", "dogs", "of", "a", "city", "jumped", "over",
         "<b>lazy</b>", "foxes", "and", "cats", "quickly", "is", "river"]


def analysis_docs(n=120, seed=5):
    rng = np.random.RandomState(seed)
    return [(str(d), {"body": " ".join(rng.choice(WORDS, rng.randint(3, 12))),
                      "summary": " ".join(rng.choice(WORDS,
                                                     rng.randint(2, 8)))})
            for d in range(n)]


@pytest.fixture(scope="module")
def analyzed_pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    flat = {"index.number_of_shards": 2, "index.refresh_interval": -1,
            "index.search.mesh": False}
    jset = JSettings.from_dict({"index": INDEX_ANALYSIS}).merged_with(
        JSettings(flat))
    tset = Settings.from_dict({"index": INDEX_ANALYSIS}).merged_with(
        Settings(flat))
    jidx = JIndex("an", jset, mapping=INDEX_MAPPING)
    tidx = IndexService("an", tset, mapping=INDEX_MAPPING, device="cpu")
    for doc_id, src in analysis_docs():
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    yield jidx, tidx
    jidx.close()
    tidx.close()
    mp.undo()


@pytest.mark.parametrize("query", [
    {"match": {"body": "Running DOGS"}},
    {"match": {"summary": "the cities jumped"}},
    {"match_phrase": {"body": "running dogs"}},
    {"match_phrase": {"body": "dogs of the city"}},
    {"match_phrase": {"summary": "lazy foxes"}},
    {"match_phrase": {"body": {"query": "jumped cats", "slop": 2}}},
    {"query_string": {"query": "body:jumping AND summary:\"lazy fox\""}},
])
def test_custom_analyzed_index_answers_equally(analyzed_pair, query):
    jidx, tidx = analyzed_pair
    body = {"query": query, "size": 200}
    compare(jidx.search(dict(body)), tidx.search(dict(body)), "host")
