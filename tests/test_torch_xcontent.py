"""XContent parity: the port's ``common/xcontent.py`` against the JAX
package's on the same seeded objects.

CBOR encodings must be equal byte for byte and decode back to the object;
content-type negotiation (``type_from_media``, ``sniff_type``,
``response_format``) must give the same answers; the module must import
without PyYAML.
"""

import functools
import importlib
import sys

import numpy as np
import pytest

from elasticsearch_tpu.common import xcontent as jx
from elasticsearch_tpu_torch.common import xcontent as tx


@functools.lru_cache(maxsize=1)
def seeded_objects(seed=3, n=40):
    """JSON-model objects with every CBOR head width: small and 64-bit
    ints both signs, floats, text (with non-ASCII), bytes, bool, null,
    nested maps and arrays."""
    rng = np.random.RandomState(seed)
    ints = [0, 1, 23, 24, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 63, -1, -24, -25, -257, -(2 ** 33), 2 ** 64, -(2 ** 64) - 1]

    def leaf():
        kind = rng.randint(7)
        if kind == 0:
            return ints[rng.randint(len(ints))]
        if kind == 1:
            return float(rng.standard_normal() * 10 ** rng.randint(-5, 6))
        if kind == 2:
            return "".join(rng.choice(list("abcé漢 \n\"")) for _ in range(
                rng.randint(0, 40)))
        if kind == 3:
            return bytes(rng.randint(0, 256, rng.randint(0, 30)).tolist())
        return [True, False, None, 1.5][kind - 3]

    def value(depth):
        if depth > 2 or rng.rand() < 0.4:
            return leaf()
        if rng.rand() < 0.5:
            return [value(depth + 1) for _ in range(rng.randint(0, 12))]
        return {f"k{i}": value(depth + 1) for i in range(rng.randint(0, 12))}

    return [value(0) for _ in range(n)]


@pytest.mark.parametrize("i", range(40))
def test_cbor_bytes_equal_jax(i):
    obj = seeded_objects()[i]
    enc = tx.cbor_encode(obj)
    assert enc == jx.cbor_encode(obj)
    dec = tx.cbor_decode(enc)
    assert dec == jx.cbor_decode(enc)
    assert dec == degraded(obj)


def degraded(obj):
    """What a CBOR round trip gives back: integers past 64 bits become
    strings, tuples lists; everything else is unchanged."""
    if isinstance(obj, bool) or obj is None:
        return obj
    if isinstance(obj, int):
        return str(obj) if obj >= 1 << 64 or obj < -(1 << 64) else obj
    if isinstance(obj, (list, tuple)):
        return [degraded(v) for v in obj]
    if isinstance(obj, dict):
        return {k: degraded(v) for k, v in obj.items()}
    return obj


def test_cbor_search_response_round_trip():
    resp = {"took": 3, "timed_out": False, "_shards": {"total": 5},
            "hits": {"total": {"value": 17, "relation": "gte"},
                     "max_score": 1.25,
                     "hits": [{"_id": "d1", "_score": 1.25,
                               "_source": {"title": "w1 w2", "year": 2001}}]}}
    for fmt in (tx.CBOR, tx.JSON):
        data, ctype = tx.serialize(resp, fmt)
        assert (data, ctype) == jx.serialize(resp, fmt)
        assert tx.parse(data, ctype) == resp
    with pytest.raises(tx.XContentParseError):
        tx.cbor_decode(tx.cbor_encode(resp)[:-1])
    with pytest.raises(tx.XContentParseError):
        tx.cbor_decode(tx.cbor_encode(resp) + b"\x00")


@pytest.mark.parametrize("media", [
    None, "", "application/json", "application/json; charset=UTF-8",
    "application/x-ndjson", "text/json", "application/yaml", "text/yaml",
    "application/x-yaml", "application/cbor", "text/plain",
    "text/plain, application/cbor;q=0.5", "APPLICATION/JSON",
    "application/smile"])
def test_type_from_media_same_as_jax(media):
    assert tx.type_from_media(media) == jx.type_from_media(media)


@pytest.mark.parametrize("body", [
    b"{}", b"  \n {\"a\": 1}", b"[1]", b"\"s\"", b"---\na: 1\n",
    tx.cbor_encode({"a": 1}), tx.cbor_encode([1, 2]), b"", b"x",
    b" " * 40 + b"{}"])
def test_sniff_type_same_as_jax(body):
    assert tx.sniff_type(body) == jx.sniff_type(body)


@pytest.mark.parametrize("params,accept", [
    ({}, None), ({"format": "yaml"}, None), ({"format": "CBOR"}, None),
    ({"format": "txt"}, "application/cbor"), ({}, "application/yaml"),
    ({}, "text/html, application/cbor"), ({"format": ""}, None)])
def test_response_format_same_as_jax(params, accept):
    assert tx.response_format(params, accept) == \
        jx.response_format(params, accept)


def test_import_without_yaml(monkeypatch):
    """The machine with the card has no PyYAML: importing the module and
    serving JSON and CBOR must not need it."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.delitem(sys.modules, "elasticsearch_tpu_torch.common.xcontent")
    mod = importlib.import_module("elasticsearch_tpu_torch.common.xcontent")
    assert mod.parse(b'{"a": 1}') == {"a": 1}
    assert mod.cbor_decode(mod.serialize({"a": [1]}, mod.CBOR)[0]) == \
        {"a": [1]}
    with pytest.raises(mod.XContentParseError):
        mod.parse(b"---\na: 1\n")
