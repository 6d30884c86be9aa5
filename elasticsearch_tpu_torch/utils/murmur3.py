"""MurmurHash3 x86 32-bit — the document routing hash.

Counterpart of ``elasticsearch_tpu/utils/murmur3.py``. BM25 statistics are
per shard, so a doc must land on the same shard as in the JAX package for
scores to agree: the routing string is hashed as UTF-16LE code units
(``Murmur3HashFunction``) and the shard is floorMod(hash, num_shards).
``hash_slice_id`` is the sliced search's doc partition hash, over the
binary ``_id`` term encoding (``encode_id``), so a slice holds the same
docs as in the JAX package; ``hash_slice_ids`` hashes a segment's ids as
arrays.
"""

from __future__ import annotations

import base64

import numpy as np

_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32, returns signed 32-bit int (Java parity)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = seed & _M32
    nblocks = len(data) // 4
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 4: i * 4 + 4], "little")
        k1 = (k1 * c1) & _M32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _M32
        h1 ^= k1
        h1 = _rotl32(h1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _M32
    tail = data[nblocks * 4:]
    k1 = 0
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * c1) & _M32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _M32
        h1 ^= k1
    h1 ^= len(data)
    h1 = _fmix32(h1)
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


def hash_routing(routing: str) -> int:
    return murmur3_32(routing.encode("utf-16-le"))


def shard_id_for(routing: str, num_shards: int) -> int:
    """floorMod(murmur3(routing), num_shards)."""
    return hash_routing(routing) % num_shards  # Python % is floorMod


def encode_id(doc_id: str) -> bytes:
    """The binary ``_id`` term encoding (``Uid.encodeId``): positive
    numeric ids pack two digits a byte behind a 0xfe marker, URL-base64
    ids decode to their raw bytes (0xfd escape when ambiguous), anything
    else is 0xff + UTF-8."""
    if not doc_id:
        raise ValueError("Ids can't be empty")
    if doc_id.isascii() and doc_id.isdigit():
        out = bytearray([0xFE])
        for i in range(0, len(doc_id), 2):
            b1 = ord(doc_id[i]) - ord("0")
            b2 = (ord(doc_id[i + 1]) - ord("0")
                  if i + 1 < len(doc_id) else 0x0F)
            out.append((b1 << 4) | b2)
        return bytes(out)
    if _is_url_base64_without_padding(doc_id):
        raw = base64.urlsafe_b64decode(doc_id + "=" * (-len(doc_id) % 4))
        if raw and raw[0] >= 0xFD:
            return bytes([0xFD]) + raw
        return raw
    return bytes([0xFF]) + doc_id.encode("utf-8")


def _is_url_base64_without_padding(doc_id: str) -> bool:
    n = len(doc_id)
    if n % 4 == 1:
        return False
    if n % 4 == 2 and doc_id[-1] not in "AQgw":
        return False
    if n % 4 == 3 and doc_id[-1] not in "AEIMQUYcgkosw048":
        return False
    return all(c.isascii() and (c.isalnum() or c in "-_") for c in doc_id)


def hash_slice_id(doc_id: str) -> int:
    """The slice partition hash (``TermsSliceQuery``): murmur3_x86_32 over
    the encoded ``_id`` bytes with the fixed seed 7919; floorMod against
    the slice ``max`` picks the slice."""
    return murmur3_32(encode_id(doc_id), seed=7919)


def _murmur3_32_same_length(rows: np.ndarray, seed: int) -> np.ndarray:
    """``murmur3_32`` of n byte strings of one length: ``rows`` is
    [n, length] uint8; returns the signed 32-bit hashes, int64."""
    n, length = rows.shape
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    h1 = np.full(n, seed & _M32, np.uint32)
    nblocks = length // 4
    with np.errstate(over="ignore"):
        if nblocks:
            blocks = np.ascontiguousarray(rows[:, : nblocks * 4]).view(
                "<u4").reshape(n, nblocks)
            for i in range(nblocks):
                k1 = rotl(blocks[:, i] * c1, 15) * c2
                h1 = rotl(h1 ^ k1, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        tail = rows[:, nblocks * 4:].astype(np.uint32)
        if tail.shape[1]:
            k1 = np.zeros(n, np.uint32)
            for j in reversed(range(tail.shape[1])):
                k1 ^= tail[:, j] << np.uint32(8 * j)
            h1 ^= rotl(k1 * c1, 15) * c2
        h1 ^= np.uint32(length)
        h1 ^= h1 >> np.uint32(16)
        h1 *= np.uint32(0x85EBCA6B)
        h1 ^= h1 >> np.uint32(13)
        h1 *= np.uint32(0xC2B2AE35)
        h1 ^= h1 >> np.uint32(16)
    return h1.view(np.int32).astype(np.int64)


def hash_slice_ids(doc_ids) -> np.ndarray:
    """``hash_slice_id`` of every id, vectorized: the encoded ids group by
    length and each group hashes as one array (int64, signed 32-bit
    values)."""
    encoded = [encode_id(i) for i in doc_ids]
    out = np.zeros(len(encoded), np.int64)
    by_len: dict = {}
    for pos, e in enumerate(encoded):
        by_len.setdefault(len(e), []).append(pos)
    for length, where in by_len.items():
        rows = np.frombuffer(b"".join(encoded[p] for p in where),
                             np.uint8).reshape(len(where), length)
        out[where] = _murmur3_32_same_length(rows, 7919)
    return out
