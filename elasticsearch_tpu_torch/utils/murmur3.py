"""MurmurHash3 x86 32-bit — the document routing hash.

Counterpart of ``elasticsearch_tpu/utils/murmur3.py``. BM25 statistics are
per shard, so a doc must land on the same shard as in the JAX package for
scores to agree: the routing string is hashed as UTF-16LE code units
(``Murmur3HashFunction``) and the shard is floorMod(hash, num_shards).
"""

from __future__ import annotations

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
