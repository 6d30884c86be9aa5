"""Geohash encoding (the reference's ``GeoHashUtils``).

Counterpart of ``elasticsearch_tpu/utils/geohash.py``: ``encode`` and
``decode`` as they are there, plus ``encode_cells`` / ``encode_many`` for
``geohash_grid``: each coordinate's cell of the bisection from one
division, checked against the cell's edges (the bisection's midpoints,
each an exact float64) so that every cell equals the scalar ``encode``'s,
then the longitude and latitude bits interleaved. Over a million points
that is a few numpy passes instead of a Python loop a point.
"""

from __future__ import annotations

import numpy as np

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def encode(lat: float, lon: float, precision: int = 5) -> str:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    out = []
    bit = 0
    ch = 0
    even = True
    while len(out) < precision:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                ch = (ch << 1) | 1
                lon_lo = mid
            else:
                ch <<= 1
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                ch = (ch << 1) | 1
                lat_lo = mid
            else:
                ch <<= 1
                lat_hi = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_BASE32[ch])
            bit = 0
            ch = 0
    return "".join(out)


def decode(geohash: str):
    """-> (lat, lon) of the cell center."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for c in geohash:
        cd = _BASE32.index(c)
        for shift in range(4, -1, -1):
            bit = (cd >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return ((lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2)


def _cell_index(x: np.ndarray, lo: float, span: float, bits: int) -> np.ndarray:
    """The bisection's cell of each value: the ``idx`` with lo + idx * w
    <= x < lo + (idx + 1) * w (w = span / 2**bits), the last cell taking
    x == lo + span and a NaN cell 0, as ``encode``'s ``>=`` tests give
    them. An estimate from one division, then exact checks against the
    cell's dyadic edges (every edge is a float64 exactly)."""
    n = 1 << bits
    w = span / n
    with np.errstate(invalid="ignore"):
        idx = np.floor((x - lo) / w)
    idx = np.clip(np.nan_to_num(idx, nan=0.0), 0, n - 1).astype(np.int64)
    with np.errstate(invalid="ignore"):
        idx -= x < lo + idx * w
        idx += x >= lo + (idx + 1) * w
    return np.clip(idx, 0, n - 1)


def _spread(v: np.ndarray) -> np.ndarray:
    """The bits of ``v`` (up to 32) moved to the even bit positions."""
    x = v.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                        (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                        (1, 0x5555555555555555)):
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def encode_cells(lat, lon, precision: int = 5) -> np.ndarray:
    """The geohash cells of many points as int64 codes, 5 bits a
    character, first character highest: equal to ``encode``'s bisection
    cell for cell (the longitude takes the first bit of every pair)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    n_bits = 5 * precision
    lon_bits, lat_bits = (n_bits + 1) // 2, n_bits // 2
    ilon = _spread(_cell_index(lon, -180.0, 360.0, lon_bits))
    ilat = _spread(_cell_index(lat, -90.0, 180.0, lat_bits))
    if n_bits % 2:
        code = ilon | (ilat << np.uint64(1))
    else:
        code = (ilon << np.uint64(1)) | ilat
    return code.astype(np.int64)


_BASE32_BYTES = np.frombuffer(_BASE32.encode("ascii"), np.uint8)


def cell_strings(codes, precision: int) -> list:
    """``encode_cells`` codes as their geohash strings, vectorized."""
    codes = np.asarray(codes, np.int64)
    shifts = 5 * (precision - 1 - np.arange(precision, dtype=np.int64))
    chars = _BASE32_BYTES[(codes[:, None] >> shifts) & 31]
    return np.ascontiguousarray(chars).view(f"S{precision}").ravel() \
        .astype(str).tolist()


def encode_many(lat, lon, precision: int = 5) -> list:
    """``[encode(la, lo, precision) for la, lo in zip(lat, lon)]``,
    vectorized."""
    return cell_strings(encode_cells(lat, lon, precision), precision)
