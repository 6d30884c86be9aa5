"""XContent: request and response body formats (JSON, YAML, CBOR).

Counterpart of ``elasticsearch_tpu/common/xcontent.py``: the format is
negotiated from the Content-Type header, with first-bytes sniffing as the
fallback, and a response renders per ``?format=`` or the Accept header.
SMILE is omitted; CBOR is a self-contained RFC 7049 subset codec covering
the JSON data model (maps, arrays, text, ints, floats, bool, null, byte
strings). ``yaml`` is imported only where a YAML body is parsed or
rendered, so the module imports without PyYAML.
"""

from __future__ import annotations

import functools
import json
import struct
from typing import Any, Optional, Tuple

JSON = "json"
YAML = "yaml"
CBOR = "cbor"

MIME = {
    JSON: "application/json; charset=UTF-8",
    YAML: "application/yaml",
    CBOR: "application/cbor",
}


class XContentParseError(ValueError):
    pass


def type_from_media(media: Optional[str]) -> Optional[str]:
    """Content-Type / Accept header -> format name (None = unknown).
    Accept lists ("a/b, c/d;q=0.5") resolve to the first recognized
    media type."""
    if not media:
        return None
    for part in media.split(","):
        m = part.split(";")[0].strip().lower()
        if m in ("application/json", "application/x-ndjson", "text/json"):
            return JSON
        if m in ("application/yaml", "text/yaml", "application/x-yaml"):
            return YAML
        if m == "application/cbor":
            return CBOR
    return None


def sniff_type(body: bytes) -> str:
    """First-bytes detection (XContentFactory.xContentType)."""
    i = 0
    while i < min(len(body), 32) and body[i] in b" \t\r\n":
        i += 1
    head = body[i:]
    if head[:1] in (b"{", b"[", b'"'):
        return JSON
    if head[:3] == b"---":
        return YAML
    if body[:1] and (body[0] >> 5) in (4, 5):  # CBOR array/map major types
        return CBOR
    return JSON


def parse(body: bytes, content_type: Optional[str] = None) -> Any:
    fmt = type_from_media(content_type) or sniff_type(body)
    try:
        if fmt == JSON:
            return json.loads(body)
        if fmt == YAML:
            import yaml

            return yaml.safe_load(body)
        return cbor_decode(body)
    except XContentParseError:
        raise
    except Exception as e:  # noqa: BLE001 — normalized parse error
        raise XContentParseError(f"not valid {fmt}: {e}") from e


@functools.lru_cache(maxsize=1)
def _lenient_dumper():
    """A SafeDumper under which objects outside the YAML-native model
    degrade to strings, matching json.dumps(default=str) and the CBOR
    encoder's fallback: a response value must never crash the
    serialization path."""
    import yaml

    class _LenientDumper(yaml.SafeDumper):
        pass

    _LenientDumper.add_representer(
        bytes, lambda d, v: d.represent_str(v.decode("utf-8", "replace")))
    _LenientDumper.add_multi_representer(
        object, lambda d, v: d.represent_str(str(v)))
    return _LenientDumper


def serialize(obj: Any, fmt: str, pretty: bool = False) -> Tuple[bytes, str]:
    if fmt == YAML:
        import yaml

        return (yaml.dump(obj, Dumper=_lenient_dumper(),
                          default_flow_style=False,
                          sort_keys=False).encode("utf-8"), MIME[YAML])
    if fmt == CBOR:
        return cbor_encode(obj), MIME[CBOR]
    return (json.dumps(obj, indent=2 if pretty else None,
                       default=str).encode("utf-8"), MIME[JSON])


def response_format(params: dict, accept: Optional[str]) -> str:
    fmt = (params.get("format") or "").lower()
    if fmt in (JSON, YAML, CBOR):
        return fmt
    return type_from_media(accept) or JSON


# ----------------------------------------------------------------------
# Minimal CBOR (RFC 7049 subset: the JSON data model + byte strings)
# ----------------------------------------------------------------------


def _enc_head(major: int, value: int) -> bytes:
    if value < 24:
        return bytes([(major << 5) | value])
    if value < 1 << 8:
        return bytes([(major << 5) | 24, value])
    if value < 1 << 16:
        return bytes([(major << 5) | 25]) + value.to_bytes(2, "big")
    if value < 1 << 32:
        return bytes([(major << 5) | 26]) + value.to_bytes(4, "big")
    return bytes([(major << 5) | 27]) + value.to_bytes(8, "big")


def cbor_encode(obj: Any) -> bytes:
    out = bytearray()
    _encode_into(obj, out)
    return bytes(out)


def _encode_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int):
        if obj >= 1 << 64 or obj < -(1 << 64):
            # beyond CBOR's 64-bit heads: degrade to a string like every
            # other unencodable (bignum tags add little for a search API)
            _encode_into(str(obj), out)
        elif obj >= 0:
            out += _enc_head(0, obj)
        else:
            out += _enc_head(1, -1 - obj)
    elif isinstance(obj, float):
        out.append(0xFB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, bytes):
        out += _enc_head(2, len(obj))
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _enc_head(3, len(raw))
        out += raw
    elif isinstance(obj, (list, tuple)):
        out += _enc_head(4, len(obj))
        for item in obj:
            _encode_into(item, out)
    elif isinstance(obj, dict):
        out += _enc_head(5, len(obj))
        for k, v in obj.items():
            _encode_into(str(k), out)
            _encode_into(v, out)
    else:
        _encode_into(str(obj), out)  # objects degrade to strings like json


def cbor_decode(data: bytes) -> Any:
    obj, pos = _decode_at(data, 0)
    if pos != len(data):
        raise XContentParseError(
            f"trailing bytes after CBOR value ({len(data) - pos})")
    return obj


def _decode_at(data: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(data):
        raise XContentParseError("truncated CBOR")
    initial = data[pos]
    major, info = initial >> 5, initial & 0x1F
    pos += 1
    if major == 7:
        if initial == 0xF6 or initial == 0xF7:  # null / undefined
            return None, pos
        if initial == 0xF5:
            return True, pos
        if initial == 0xF4:
            return False, pos
        if initial == 0xFB:
            return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
        if initial == 0xFA:
            return struct.unpack(">f", data[pos:pos + 4])[0], pos + 4
        raise XContentParseError(f"unsupported simple value {initial:#x}")
    if info < 24:
        length = info
    elif info == 24:
        length = data[pos]
        pos += 1
    elif info == 25:
        length = int.from_bytes(data[pos:pos + 2], "big")
        pos += 2
    elif info == 26:
        length = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4
    elif info == 27:
        length = int.from_bytes(data[pos:pos + 8], "big")
        pos += 8
    else:
        raise XContentParseError(
            f"indefinite-length CBOR not supported (major {major})")
    if major == 0:
        return length, pos
    if major == 1:
        return -1 - length, pos
    if major in (2, 3):
        if pos + length > len(data):
            raise XContentParseError("truncated CBOR string")
        raw = data[pos:pos + length]
        return (raw if major == 2 else raw.decode("utf-8")), pos + length
    if major == 4:
        items = []
        for _ in range(length):
            item, pos = _decode_at(data, pos)
            items.append(item)
        return items, pos
    if major == 5:
        out = {}
        for _ in range(length):
            k, pos = _decode_at(data, pos)
            v, pos = _decode_at(data, pos)
            out[k] = v
        return out, pos
    # major 6: semantic tag — skip the tag, decode the payload
    return _decode_at(data, pos)
