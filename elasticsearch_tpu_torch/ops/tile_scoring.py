"""Tile scoring: the BM25 scoring hot loop.

Counterpart of ``elasticsearch_tpu/ops/pallas_scoring.py``. The doc space
is split into tiles of ``W = sub * 128`` docs. For each tile and each query
term lane ``j``, the lane's covering run of posting rows
``[row_lo[t, j], row_hi[t, j])`` is walked and every valid posting (doc
inside the tile, ``frac > 0``) adds ``w_j * frac`` into the tile's
accumulator; the output is ``acc * live`` (and, with counts, the number of
lanes that matched each doc), in the JAX kernel's transposed tile layout
``[n_tiles * 128, sub]``: the doc at local index ``s * 128 + lane`` of tile
``t`` sits at row ``t * 128 + lane``, column ``s``.

The host helpers (tile geometry, padding, per-posting BM25 norm factors,
block ranges, the per-(tile, lane) row tables and the geometry ladder's
constraints) are copied from the JAX package as numpy, so both packages
take the same path for the same query.

Variants of ``score_tiles`` (the JAX signature and output shapes):

- dense (``dense=True``), ``q_batch=1`` or ``Q > 1``: scores (and match
  counts) per doc; with ``Q > 1`` the row tables cover the UNION of Q
  queries' lanes (``build_tile_tables_batched``) and ``weights`` is
  ``[Q, t_pad]``, a zero weight killing that lane for that query;
- fused per-tile top-k (``dense=False``, the default, as in JAX), any
  ``q_batch``: per tile and query the ``k`` best (score, doc) pairs and the
  hit count;
- either form over the packed codec (``codec="packed"``): one i32 word a
  posting, ``doc << 12 | frac_q``, passed as ``docs_padded`` with
  ``frac_padded`` None (``pack_segment_blocks``), decoded with a logical
  shift, a mask and ``frac_q * PACK_FRAC_SCALE`` in f32;
- the top-k form over a tile subset (``tile_ids``, block-max pruning):
  the row tables arrive gathered in subset order, the outputs hold one row
  per subset entry, and a row whose windows are all empty gives empty
  candidates (what an empty tile gives) without work.

``score_tiles`` dispatches on the tensors' device: a CPU tensor runs the
plain PyTorch version (``score_tiles_plain``); a CUDA tensor launches the
hand-written kernel in ``csrc/tile_scoring.cu`` or raises. Both kernels'
split of a launch into blocks (a band of each tile's columns and a group
of queries a block) is planned here, so that the CPU tests reach it:
``dense_band_plan`` for the dense forms, ``topk_cluster_plan`` for the
top-k forms (and for kernel 3), whose bands of one tile form one
thread-block cluster. Both add each
query's lanes in one canonical order (ascending first posting row, see
``canonical_lane_order``) with the same f32 multiply and add, so they agree
bit for bit, and a batched member equals its ``q_batch=1`` result bit for
bit (except a member naming one posting run twice with different weights:
the union merges the two lanes, as in the JAX package).

``score_tiles_pruned`` is block-max pruned top-k scoring: a probe pass
over the highest-bound tiles (``plan_pruned_tiles``) sets each query's
threshold, the rest tiles whose bound cannot reach it are zeroed on the
device, and a rest pass scores the others; nothing crosses to the host
between the passes.

``merge_tile_topk`` / ``merge_tile_topk_batched`` merge the per-tile
candidates with ``lax.top_k``'s tie order (lower flat index first), which
``torch.topk`` does not promise, through ``scoring.top_k``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_kernels
from elasticsearch_tpu_torch.ops.scoring import B, K1, top_k

LANE = 128
DEFAULT_TILE_SUB = 128
# segment block arrays carry this many sentinel rows after the last real
# row; build_tile_tables keeps every covering window at most CB_MAX // 2
# rows (the JAX kernel's DMA-window bound, kept so both packages take the
# same geometry ladder for the same query)
CB_MAX = 128


def next_pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class TileGeometry(NamedTuple):
    """Static tiling of one segment's doc space."""

    nd_pad: int  # padded doc count (power of two)
    tile_sub: int  # sublanes per tile
    n_tiles: int

    @property
    def tile_w(self) -> int:
        return self.tile_sub * LANE


def tile_geometry(nd_pad: int, tile_sub: int = DEFAULT_TILE_SUB) -> TileGeometry:
    """W = tile_sub*128 docs per tile, shrinking for small segments so
    n_tiles >= 1 and W <= nd_pad; the doc space is floored at 128."""
    nd_pad = max(nd_pad, LANE)
    if nd_pad & (nd_pad - 1) or tile_sub & (tile_sub - 1):
        raise ValueError(
            f"nd_pad={nd_pad} and tile_sub={tile_sub} must be powers of two "
            f"(otherwise tail docs would fall outside every tile)")
    w = tile_sub * LANE
    while w > nd_pad and w > LANE:
        w //= 2
    sub = w // LANE
    n_tiles = max(nd_pad // w, 1)
    if n_tiles * sub * LANE != nd_pad:
        raise ValueError(f"tiles do not cover nd_pad={nd_pad}")
    return TileGeometry(nd_pad=nd_pad, tile_sub=sub, n_tiles=n_tiles)


def pad_segment_blocks(
    block_docs: np.ndarray, block_frac: np.ndarray, sentinel: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Append CB_MAX sentinel rows (sentinel docs fail every tile's range
    check and carry frac 0)."""
    pad_docs = np.full((CB_MAX, LANE), sentinel, dtype=np.int32)
    pad_frac = np.zeros((CB_MAX, LANE), dtype=np.float32)
    return (
        np.concatenate([block_docs.astype(np.int32), pad_docs]),
        np.concatenate([block_frac.astype(np.float32), pad_frac]),
    )


# ----------------------------------------------------------------------
# The packed postings codec: one i32 word a posting,
#
#     word = (doc << PACK_FRAC_BITS) | frac_q        (frac_q in [1, 4095])
#
# half the posting bytes of the raw (doc i32, frac f32) pair. BM25's frac
# = tf (k1 + 1) / (tf + k1 norm) lies strictly below k1 + 1, so frac
# quantizes linearly over (0, k1 + 1) with a static scale; frac_q == 0 is
# the invalid / padding marker (the raw codec's frac > 0 rule), so real
# postings clamp to frac_q >= 1. |dequant(q) - frac| <= PACK_FRAC_SCALE / 2.
# Doc ids keep 20 bits: a doc space above 2^20 stays raw. A doc at or
# above 2^19 sets the sign bit of its word, so the decode shifts
# logically.
# ----------------------------------------------------------------------

PACK_FRAC_BITS = 12
PACK_FRAC_MASK = (1 << PACK_FRAC_BITS) - 1
PACK_MAX_FRAC = float(K1) + 1.0  # strict upper bound of BM25 frac
PACK_FRAC_SCALE = PACK_MAX_FRAC / PACK_FRAC_MASK
# doc ids must fit the remaining bits (sentinels store doc 0 + frac_q 0)
PACKED_DOC_CAP = 1 << (32 - PACK_FRAC_BITS)


def packed_codec_ok(nd_pad: int) -> bool:
    """Real doc ids are < nd_pad, so any nd_pad <= 2^20 fits the packed
    word (the 1M-doc corpus is exactly the boundary)."""
    return nd_pad <= PACKED_DOC_CAP


def quantize_frac(frac: np.ndarray) -> np.ndarray:
    """frac f32 -> 12-bit code; 0 stays 0 (invalid marker), real postings
    clamp to [1, PACK_FRAC_MASK] so frac > 0 survives the round trip."""
    q = np.rint(frac / np.float32(PACK_FRAC_SCALE)).astype(np.int64)
    q = np.clip(q, 1, PACK_FRAC_MASK)
    return np.where(frac > 0.0, q, 0).astype(np.int32)


def dequantize_frac(q: np.ndarray) -> np.ndarray:
    """The exact f32 values the packed decode produces (the oracle for
    packed parity)."""
    return (q.astype(np.float32) * np.float32(PACK_FRAC_SCALE)).astype(
        np.float32)


def pack_segment_blocks(block_docs: np.ndarray, block_frac: np.ndarray,
                        sentinel: int,
                        q: Optional[np.ndarray] = None) -> np.ndarray:
    """Bit-pack (docs, frac) into one padded i32 word array, the packed
    form of pad_segment_blocks: CB_MAX all-zero rows after the last real
    row (word 0 decodes to frac 0 = invalid). ``q``: a precomputed
    quantize_frac(block_frac), for callers that also need the codes."""
    if not packed_codec_ok(int(sentinel)):
        raise ValueError(
            f"doc space {sentinel} exceeds the packed codec's "
            f"{32 - PACK_FRAC_BITS}-bit doc capacity")
    if q is None:
        q = quantize_frac(block_frac.astype(np.float32))
    docs = np.where(q > 0, block_docs, 0).astype(np.int64)
    words = ((docs.astype(np.uint32) << PACK_FRAC_BITS)
             | q.astype(np.uint32)).view(np.int32)
    pad = np.zeros((CB_MAX, LANE), dtype=np.int32)
    return np.concatenate([words, pad])


def resolve_postings_codec(pref, nd_pad: int,
                           node_default: Optional[str] = "raw") -> str:
    """Effective codec of a staging: the explicit preference (the index
    setting or the caller), else the node's ``search.pallas.postings_codec``
    (``node_default``, which the JAX package reads from an environment
    variable its ``Node`` exports); an unknown value is raw, and packed
    demotes to raw when the doc space exceeds the packed word's doc
    capacity."""
    codec = pref
    if codec in (None, "default"):
        codec = node_default or "raw"
    if codec not in ("raw", "packed"):
        codec = "raw"
    if codec == "packed" and not packed_codec_ok(nd_pad):
        codec = "raw"
    return codec


def compute_block_frac(
    block_docs: np.ndarray,
    block_tfs: np.ndarray,
    doc_len: np.ndarray,  # [>= nd_pad (+1)] float32 per-doc field length
    avgdl: float,
    k1: float = K1,
    b: float = B,
) -> np.ndarray:
    """Per-posting BM25 norm factor (everything except idf*boost):
    tf*(k1+1) / (tf + k1*(1-b+b*len/avgdl)); padding (tf == 0) gets 0."""
    tf = block_tfs.astype(np.float32)
    dl = doc_len[np.minimum(block_docs, len(doc_len) - 1)].astype(np.float32)
    denom = tf + k1 * (1.0 - b + b * dl / max(avgdl, 1e-9))
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(tf > 0.0, tf * (k1 + 1.0) / denom, 0.0)
    return frac.astype(np.float32)


def block_min_max(block_docs: np.ndarray, block_tfs: np.ndarray,
                  sentinel: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block [min_doc, max_doc] over real postings (tf > 0)."""
    real = block_tfs > 0.0
    bmin = np.where(real, block_docs, sentinel).min(axis=1).astype(np.int64)
    bmax = np.where(real, block_docs, -1).max(axis=1).astype(np.int64)
    return bmin, bmax


class QueryLane(NamedTuple):
    """One scoring lane: a term's posting run and its weight."""

    block_start: int  # first block row of the term in the segment
    block_count: int
    weight: float  # idf * boost (0 disables the lane)


def build_tile_tables(
    lanes: Sequence[QueryLane],
    bmin: np.ndarray,
    bmax: np.ndarray,
    geom: TileGeometry,
    t_pad: Optional[int] = None,
    cb: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Per (tile, lane) the block-row window [row_lo, row_hi) covering the
    tile's doc range, padded to t_pad lanes. Returns (row_lo, row_hi
    [n_tiles, t_pad] i32, weights [1, t_pad] f32, cb); raises ValueError
    when a window exceeds CB_MAX // 2 rows (the geometry ladder then
    retries with smaller tiles)."""
    w = geom.tile_w
    n_tiles = geom.n_tiles
    t_pad = t_pad or next_pow2(max(len(lanes), 1))
    row_lo = np.zeros((n_tiles, t_pad), dtype=np.int32)
    row_hi = np.zeros((n_tiles, t_pad), dtype=np.int32)
    weights = np.zeros((1, t_pad), dtype=np.float32)
    tile_lo = np.arange(n_tiles, dtype=np.int64) * w
    need = 1
    for j, lane in enumerate(lanes):
        s, c = lane.block_start, lane.block_count
        if c <= 0 or lane.weight == 0.0:
            continue
        tb_min = bmin[s: s + c]
        tb_max = bmax[s: s + c]
        if c > 1 and (np.any(np.diff(tb_min) < 0)
                      or np.any(np.diff(tb_max) < 0)):
            raise ValueError(
                f"lane {j}: per-block doc ranges not sorted (empty mid-run "
                f"block or unsorted postings) — coverage would be silently "
                f"wrong")
        first = np.searchsorted(tb_max, tile_lo, side="left")
        end = np.searchsorted(tb_min, tile_lo + w, side="left")
        end = np.maximum(end, first)
        row_lo[:, j] = s + first
        row_hi[:, j] = s + end
        weights[0, j] = lane.weight
        cov = int((end - first).max()) if c else 0
        need = max(need, cov)
    cb_req = next_pow2(max(need, 8))
    if cb_req > CB_MAX // 2:
        raise ValueError(
            f"per-tile covering window of {need} blocks exceeds the kernel "
            f"bound {CB_MAX // 2}; use a smaller tile_sub")
    if cb is not None:
        if cb < cb_req:
            raise ValueError(f"cb={cb} too small, need {cb_req}")
        if cb > CB_MAX // 2 or cb & (cb - 1):
            raise ValueError(
                f"cb={cb} must be a power of two <= {CB_MAX // 2}")
        cb_req = cb
    return row_lo, row_hi, weights, cb_req


def build_live_t(live: np.ndarray, geom: TileGeometry) -> np.ndarray:
    """Live mask [>= nd_pad] bool/float -> the transposed tile layout
    [n_tiles * 128, sub] f32."""
    sub, n_tiles = geom.tile_sub, geom.n_tiles
    flat = np.zeros(geom.nd_pad, np.float32)
    flat[: len(live)] = live[: geom.nd_pad].astype(np.float32)
    return np.ascontiguousarray(
        flat.reshape(n_tiles, sub, LANE).transpose(0, 2, 1)
    ).reshape(n_tiles * LANE, sub)


def dense_to_flat(dense: torch.Tensor, sub: int) -> torch.Tensor:
    """Tile layout [n_tiles*128, sub] -> [nd_pad] in natural doc order
    (doc = tile*W + s*128 + lane)."""
    n_tiles = dense.shape[0] // LANE
    return dense.reshape(n_tiles, LANE, sub).transpose(1, 2).reshape(-1)


def flat_to_dense(flat: torch.Tensor, sub: int) -> torch.Tensor:
    """Inverse of dense_to_flat."""
    n_tiles = flat.shape[0] // (sub * LANE)
    return flat.reshape(n_tiles, sub, LANE).transpose(1, 2).reshape(
        n_tiles * LANE, sub).contiguous()


def reference_scores(
    block_docs: np.ndarray,
    block_frac: np.ndarray,
    lanes: Sequence[QueryLane],
    nd_pad: int,
) -> np.ndarray:
    """Dense scores via host scatter-add — the numpy oracle."""
    scores = np.zeros(nd_pad, np.float32)
    for lane in lanes:
        if lane.block_count <= 0 or lane.weight == 0.0:
            continue
        rows = slice(lane.block_start, lane.block_start + lane.block_count)
        docs = block_docs[rows].ravel()
        frac = block_frac[rows].ravel()
        real = (frac > 0) & (docs < nd_pad)
        np.add.at(scores, docs[real], np.float32(lane.weight) * frac[real])
    return scores


# ----------------------------------------------------------------------
# Cross-query batching: the union of Q queries' lanes
# ----------------------------------------------------------------------


def union_query_lanes(
    lane_sets: Sequence[Sequence[QueryLane]],
) -> Tuple[List[QueryLane], np.ndarray]:
    """Merge Q per-query lane sets into one union lane set plus a
    per-query weight matrix: a query takes part in union lane j iff
    weights[q, j] > 0. Lanes are keyed by their posting run (block_start,
    block_count), so two queries naming the same term share one lane (and
    one read of its posting rows)."""
    union: List[QueryLane] = []
    index: dict = {}
    rows: List[dict] = []
    for lanes in lane_sets:
        row: dict = {}
        for lane in lanes:
            if lane.block_count <= 0 or lane.weight <= 0.0:
                continue
            key = (lane.block_start, lane.block_count)
            j = index.get(key)
            if j is None:
                j = len(union)
                index[key] = j
                # coverage is built with weight 1.0: the union lane is
                # live whenever any member uses it
                union.append(QueryLane(lane.block_start, lane.block_count,
                                       1.0))
            row[j] = row.get(j, 0.0) + float(lane.weight)
        rows.append(row)
    t_pad = next_pow2(max(len(union), 1))
    weights = np.zeros((len(lane_sets), t_pad), dtype=np.float32)
    for q, row in enumerate(rows):
        for j, w in row.items():
            weights[q, j] = w
    return union, weights


def build_tile_tables_batched(
    lane_sets: Sequence[Sequence[QueryLane]],
    bmin: np.ndarray,
    bmax: np.ndarray,
    geom: TileGeometry,
    t_pad: Optional[int] = None,
    cb: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Batched form of build_tile_tables: one shared (row_lo, row_hi)
    covering the union of Q queries' lanes plus a [Q, t_pad] weight matrix
    (zero = lane dead for that query). Raises ValueError like the
    single-query form when the union's covering window exceeds the bound
    at this tile size."""
    union, weights = union_query_lanes(lane_sets)
    t_pad = max(t_pad or 0, weights.shape[1])
    row_lo, row_hi, _w1, cb_req = build_tile_tables(
        union, bmin, bmax, geom, t_pad=t_pad, cb=cb)
    if weights.shape[1] < t_pad:
        weights = np.concatenate(
            [weights,
             np.zeros((weights.shape[0], t_pad - weights.shape[1]),
                      np.float32)], axis=1)
    return row_lo, row_hi, weights, cb_req


# ----------------------------------------------------------------------
# Block-max pruning: per-(tile, lane) upper-bound impacts
# ----------------------------------------------------------------------


def block_frac_max(block_frac: np.ndarray) -> np.ndarray:
    """Per-block max posting impact factor [n_blocks] f32, the block-max
    metadata of WAND / MaxScore.

    The max runs over every real posting whatever the live mask: deletes
    change ``Segment.live`` after staging, and a bound that kept a deleted
    doc is only too high (it scores a tile it could skip, never skips one
    it needs). For the packed codec pass the DEQUANTIZED frac: rounding
    can lift a posting up to half a step above its raw value, and the
    bound must dominate what the kernel decodes."""
    return block_frac.max(axis=1).astype(np.float32)


def tile_lane_ub(row_lo: np.ndarray, row_hi: np.ndarray,
                 bfmax: np.ndarray) -> np.ndarray:
    """Per-(tile, lane) upper-bound frac over the tile's covering block
    window [row_lo, row_hi): a superset of the tile's real postings, so its
    max bounds any in-tile posting's frac. [n_tiles, t_pad] f32, 0 for
    empty windows and dead lanes."""
    n_tiles, t_pad = row_lo.shape
    out = np.zeros((n_tiles, t_pad), np.float32)
    n_blocks = len(bfmax)
    for j in range(t_pad):
        lo = row_lo[:, j].astype(np.int64)
        hi = row_hi[:, j].astype(np.int64)
        wmax = int((hi - lo).max()) if n_tiles else 0
        if wmax <= 0:
            continue
        idx = lo[:, None] + np.arange(wmax)[None, :]
        valid = idx < hi[:, None]
        vals = np.where(valid,
                        bfmax[np.minimum(idx, n_blocks - 1)], 0.0)
        out[:, j] = vals.max(axis=1)
    return out


def plan_pruned_tiles(row_lo: np.ndarray, row_hi: np.ndarray,
                      weights: np.ndarray, bfmax: np.ndarray,
                      probe_tiles: int = 8,
                      ub: Optional[np.ndarray] = None) -> Optional[dict]:
    """Host half of block-max pruned scoring: order the tiles by their
    summed block-max score bound and split them into a PROBE set (scored
    unconditionally, it sets the running top-k threshold) and a REST set
    (scored only if its bound can still reach the threshold, decided on
    the device by score_tiles_pruned). None when there are too few tiles
    to prune (callers run the exhaustive kernel).

    ``weights`` is the [Q, t_pad] weight matrix; bounds[t, q] = sum_j
    w[q, j] * ub[t, j] bounds any doc's score for query q in tile t. ``ub``
    passes precomputed (cached) per-(tile, lane) bounds."""
    n_tiles = row_lo.shape[0]
    probe = max(1, min(int(probe_tiles), n_tiles))
    if n_tiles - probe <= 0:
        return None
    if ub is None:
        ub = tile_lane_ub(row_lo, row_hi, bfmax)
    bounds = (ub @ weights.T).astype(np.float32)  # [n_tiles, Q]
    order = np.argsort(-bounds.max(axis=1), kind="stable").astype(np.int32)
    sel_p, sel_r = order[:probe], order[probe:]
    return {
        "tid_probe": sel_p,
        "rl_probe": np.ascontiguousarray(row_lo[sel_p]),
        "rh_probe": np.ascontiguousarray(row_hi[sel_p]),
        "tid_rest": sel_r,
        "rl_rest": np.ascontiguousarray(row_lo[sel_r]),
        "rh_rest": np.ascontiguousarray(row_hi[sel_r]),
        "bounds_rest": np.ascontiguousarray(bounds[sel_r]),
        "n_tiles": n_tiles,
    }


# ----------------------------------------------------------------------
# The dense kernel's launch plan (csrc/tile_scoring.cu)
# ----------------------------------------------------------------------

H100_SMS = 132
H100_SM_SHARED_BYTES = 228 * 1024  # shared memory of one H100 SM
BLOCK_RESERVED_SMEM = 1024  # shared memory the card keeps per resident block
DENSE_MAX_GROUP = 32  # queries a block holds: one bit each in a lane mask
DENSE_MIN_BLOCKS = 2 * H100_SMS  # a launch fills the card with two an SM


class BandPlan(NamedTuple):
    """How the dense kernel splits a launch: each block owns a band of
    ``band_sub`` columns (``band_sub * 128`` consecutive local docs) of one
    tile's ``[128, sub]`` output block and a group of ``group`` queries."""

    band_sub: int  # S, a power of two dividing sub
    group: int  # G; the last group of a launch may hold fewer
    smem: int  # dynamic shared bytes of one block
    blocks: int  # grid size: n_tiles * (sub / S) * ceil(Q / G)


def band_pad(band_sub: int) -> int:
    """Floats padding each 128-doc accumulator row of a band, so the
    scatter and the 16-byte epilogue are free of bank conflicts."""
    if band_sub < 4:
        return 0
    return 32 // band_sub if band_sub <= 32 else 1


def dense_band_smem(band_sub: int, group: int, t_pad: int,
                    with_counts: bool) -> int:
    """Dynamic shared bytes of one dense block, as the C entry point
    computes them (``dense_smem_words``): the band's mask slice, G
    accumulators (twice with counts), G weight rows, the lane tables."""
    acc = group * band_sub * (LANE + band_pad(band_sub))
    words = (band_sub * LANE + acc * (2 if with_counts else 1)
             + group * t_pad + 8 * t_pad + 3)
    return 4 * words


def dense_band_plan(sub: int, q_batch: int, with_counts: bool, t_pad: int,
                    smem_bytes: int = H100_SM_SHARED_BYTES, *,
                    n_tiles: int = 1) -> BandPlan:
    """Pick (S, G) for a dense launch of ``n_tiles`` tiles of ``sub``
    columns. ``smem_bytes`` is one SM's shared memory.

    A block's shared memory is sized for four blocks an SM (the kernel's
    register bound), else for two. A block walks every lane its queries
    weight with a barrier between lanes, so a wide band pays for its
    lanes once over many docs: S is the widest band (at least min(4,
    sub) columns, below which the epilogue is scalar) that fits with some
    G and still gives DENSE_MIN_BLOCKS blocks, else the
    narrowest that fits. G is then as many queries as fit beside that
    band (at most DENSE_MAX_GROUP, in near-equal groups, the last one
    ragged). S drops under min(4, sub) only when nothing else fits;
    raises ValueError when not even S = 1, G = 1 fits two blocks an SM."""
    q_batch = max(1, int(q_batch))
    sizes = []
    s = sub
    while s >= 1:
        sizes.append(s)  # widest first
        s //= 2

    def widest_group(s, per_block):
        # the largest near-equal group that fits beside a band of s
        for n_groups in range(-(-q_batch // DENSE_MAX_GROUP), q_batch + 1):
            group = -(-q_batch // n_groups)
            if dense_band_smem(s, group, t_pad, with_counts) <= per_block:
                return group
        return 0

    def fitting(narrowest, per_block):
        out = []
        for s in sizes:
            group = widest_group(s, per_block) if s >= narrowest else 0
            if group:
                out.append((s, group))
        return out

    fits = []
    for per_sm in (4, 2):
        per_block = smem_bytes // per_sm - BLOCK_RESERVED_SMEM
        fits = fitting(min(4, sub), per_block)
        if fits:
            break
    if not fits:
        fits = fitting(1, per_block)
    if not fits:
        raise ValueError(
            f"{smem_bytes} bytes of shared memory an SM hold no dense block "
            f"(sub={sub}, t_pad={t_pad}, with_counts={with_counts})")

    def blocks(s, group):
        return n_tiles * (sub // s) * -(-q_batch // group)

    reach = [sg for sg in fits if blocks(*sg) >= DENSE_MIN_BLOCKS]
    s, group = reach[0] if reach else fits[-1]
    return BandPlan(s, group, dense_band_smem(s, group, t_pad, with_counts),
                    blocks(s, group))


@functools.lru_cache(maxsize=1024)
def _launch_plan(sub: int, q_batch: int, with_counts: bool, t_pad: int,
                 n_tiles: int) -> BandPlan:
    # a launch's plan depends on its shapes alone: planned once per shape
    return dense_band_plan(sub, q_batch, with_counts, t_pad, n_tiles=n_tiles)


# ----------------------------------------------------------------------
# The fused top-k kernels' launch plan (csrc/block_topk.cuh, the top-k
# kernel of csrc/tile_scoring.cu and kernel 3 in csrc/knn_scoring.cu)
# ----------------------------------------------------------------------

TOPK_CLUSTERS = (1, 2, 4, 8, 16)  # 16 needs the non-portable cluster size
TOPK_MAX_GROUP = {"tile": 4, "knn": 16}  # queries a CTA holds
# the most candidates rank 0 of a cluster merges per query (C * k)
TOPK_MERGE_CANDIDATES = 512
H100_BLOCK_SMEM_OPTIN = 232448  # the most one H100 block may opt into
SELECT_THREADS = 256
SELECT_WARPS = SELECT_THREADS // 32
WARP_K = 32  # the largest k the selection's warp path takes
# the selection's scratch: a 256-bin histogram, two warp-sum rows and 16
# scalars (block_topk.cuh kSelectWords)
SELECT_WORDS = 256 + 2 * SELECT_WARPS + 16
# kernel 3's ring: 2 stages of 256 rows by 64 bf16 columns, each row padded
# by 8 bf16 (knn_scoring.cu kRingWords)
KNN_RING_WORDS = 2 * 256 * (64 + 8) // 2


class TopkPlan(NamedTuple):
    """How a fused top-k launch splits: each tile's docs into ``cluster``
    bands of ``band_docs`` (one CTA each, the bands of a tile one
    thread-block cluster), and the queries into groups of ``group``."""

    cluster: int  # C, a power of two <= 16
    group: int  # G; the last group of a launch may hold fewer
    band_docs: int  # D = W / C
    smem: int  # dynamic shared bytes of one CTA
    blocks: int  # grid size: n_tiles * ceil(Q / G) * C


def _align4(words: int) -> int:
    return (words + 3) & ~3


def topk_select_smem(cluster: int, group: int, k: int,
                     band_docs: int) -> int:
    """Shared bytes of the selection (``topk_select_words``), k' = min(k,
    band docs): rank 0's gather buffer of G * C * k' 64-bit candidates
    (clusters only); for k' <= WARP_K the queries' lists and the warps'
    segment lists and scratch, WARP_K 64-bit words each (G + 4 * 8 of
    them), else
    one list of next_pow2(k') u32 indices;
    the scratch; a list count and hit count per query and per (query,
    rank)."""
    kp = min(k, band_docs)
    gather = 2 * group * cluster * kp if cluster > 1 else 0
    lists = (2 * WARP_K * (group + 4 * SELECT_WARPS) if kp <= WARP_K
             else next_pow2(kp))
    return 4 * (_align4(gather) + _align4(lists)
                + _align4(SELECT_WORDS + 2 * group + 2 * group * cluster))


def topk_tile_smem(cluster: int, group: int, k: int, sub: int,
                   t_pad: int) -> int:
    """Shared bytes of one top-k tile CTA (``topk_smem_words``): the
    selection's, then a dense band block's without counts."""
    s = sub // cluster
    return (topk_select_smem(cluster, group, k, s * LANE)
            + dense_band_smem(s, group, t_pad, False))


def topk_knn_smem(cluster: int, group: int, k: int, sub: int,
                  d_pad: int) -> int:
    """Shared bytes of one kernel-3 CTA (``knn_smem_words``): the
    selection's, the ring, the group's query rows and its keys."""
    d = sub * LANE // cluster
    return (topk_select_smem(cluster, group, k, d)
            + 4 * (KNN_RING_WORDS + group * d_pad + group * d))


def topk_cluster_plan(kind: str, sub: int, q_batch: int, k: int,
                      n_tiles: int, *, t_pad: int = 0, d_pad: int = LANE,
                      smem_bytes: int = H100_SM_SHARED_BYTES,
                      schedulable=None,
                      clusters: Sequence[int] = TOPK_CLUSTERS) -> TopkPlan:
    """Pick (C, G) for a fused top-k launch of ``n_tiles`` tiles of ``sub``
    columns: ``kind`` "tile" (the top-k tile kernel, ``t_pad`` lanes) or
    "knn" (kernel 3, ``d_pad`` dims). ``smem_bytes`` is one SM's shared
    memory; ``schedulable(C, G, smem)``, where given, says whether the
    device can schedule such a cluster (``cudaOccupancyMaxActiveClusters``
    on the card); ``clusters`` the sizes it may pick from.

    - A cluster of C > 1 bands is allowed while each band keeps at most
      half its docs (k <= D / 2: above that the merge would take in as
      many candidates as the tile has docs) and rank 0 merges at most
      TOPK_MERGE_CANDIDATES (C * k), so C shrinks as k grows, down to C =
      1 at k = W, where one CTA holds the whole tile. C <= sub keeps a
      band at 128 docs or more.
    - G is as many queries as fit (at most TOPK_MAX_GROUP[kind], in
      near-equal groups, the last one ragged): each group reads the tile's
      postings or embedding rows once. Shared memory is sized for two
      CTAs an SM, else for one (at most what a block may opt into).
    - C is the smallest allowed size that gives one CTA an SM (132), else
      the largest that fits.

    Raises ValueError when nothing fits."""
    if kind not in TOPK_MAX_GROUP:
        raise ValueError(f"unknown top-k kernel [{kind}]")
    q_batch = max(1, int(q_batch))
    w = sub * LANE
    k = max(1, min(int(k), w))
    clusters = [c for c in clusters
                if c in TOPK_CLUSTERS and c <= sub
                and (c == 1 or (k <= (w // c) // 2
                                and c * k <= TOPK_MERGE_CANDIDATES))]

    def smem(c, g):
        if kind == "tile":
            return topk_tile_smem(c, g, k, sub, t_pad)
        return topk_knn_smem(c, g, k, sub, d_pad)

    first = -(-q_batch // TOPK_MAX_GROUP[kind])
    for n_groups in range(first, q_batch + 1):
        g = -(-q_batch // n_groups)
        for per_sm in (2, 1):
            budget = min(smem_bytes // per_sm - BLOCK_RESERVED_SMEM,
                         H100_BLOCK_SMEM_OPTIN)
            fits = [c for c in clusters if smem(c, g) <= budget
                    and (schedulable is None or schedulable(c, g, smem(c, g)))]
            if not fits:
                continue
            groups = -(-q_batch // g)
            reach = [c for c in fits if n_tiles * groups * c >= H100_SMS]
            c = reach[0] if reach else fits[-1]
            return TopkPlan(c, g, w // c, smem(c, g), n_tiles * groups * c)
    raise ValueError(
        f"no fused top-k plan fits {smem_bytes} bytes of shared memory an SM "
        f"(kind={kind}, sub={sub}, q_batch={q_batch}, k={k}, t_pad={t_pad}, "
        f"d_pad={d_pad})")


@functools.lru_cache(maxsize=1024)
def _topk_launch_plan(kind: str, sub: int, q_batch: int, k: int,
                      n_tiles: int, width: int, packed: bool, device: int,
                      clusters: Tuple[int, ...]) -> TopkPlan:
    # planned once per shape and device; the card says which clusters it
    # can schedule (width: t_pad for the tile kernel, d_pad for kernel 3)
    lib = cuda_kernels.library()
    n = ctypes.c_int(0)

    def schedulable(c, g, _smem):
        with torch.cuda.device(device):
            if kind == "tile":
                rc = lib.estpu_tile_topk_max_clusters(
                    sub, width, k, c, g, int(packed), ctypes.byref(n))
            else:
                rc = lib.estpu_knn_max_clusters(sub, width, k, c, g,
                                                ctypes.byref(n))
        cuda_kernels.check(rc, f"{kind} top-k occupancy")
        return n.value > 0

    kw = {"t_pad": width} if kind == "tile" else {"d_pad": width}
    return topk_cluster_plan(kind, sub, q_batch, k, n_tiles,
                             schedulable=schedulable, clusters=clusters, **kw)


def topk_launch_plan(kind: str, sub: int, q_batch: int, k: int, n_tiles: int,
                     width: int, packed: bool, device,
                     clusters: Sequence[int] = TOPK_CLUSTERS) -> TopkPlan:
    """The plan a launch on ``device`` takes (cached per shape): raises
    KernelError when the card can schedule none."""
    try:
        return _topk_launch_plan(kind, sub, q_batch, k, n_tiles, width,
                                 packed, torch.device(device).index or 0,
                                 tuple(clusters))
    except ValueError as e:
        raise cuda_kernels.KernelError(str(e)) from e


# ----------------------------------------------------------------------
# The kernels, their plain versions and the wrapper
# ----------------------------------------------------------------------


def _check_inputs(docs_padded, frac_padded, live_t, row_lo, row_hi,
                  weights, t_pad: int, sub: int, q_batch: int, codec: str,
                  tile_ids) -> None:
    if codec not in ("raw", "packed"):
        raise ValueError(f"unknown postings codec [{codec}]")
    tensors = {"docs_padded": docs_padded, "live_t": live_t,
               "row_lo": row_lo, "row_hi": row_hi, "weights": weights}
    want = {"docs_padded": torch.int32, "live_t": torch.float32,
            "row_lo": torch.int32, "row_hi": torch.int32,
            "weights": torch.float32}
    if codec == "raw":
        tensors["frac_padded"] = frac_padded
        want["frac_padded"] = torch.float32
    elif frac_padded is not None:
        raise ValueError("the packed codec takes frac_padded=None (the "
                         "words carry the quantized frac)")
    if tile_ids is not None:
        tensors["tile_ids"] = tile_ids
        want["tile_ids"] = torch.int32
    dev = docs_padded.device if isinstance(docs_padded, torch.Tensor) \
        else None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, docs_padded on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
    if docs_padded.dim() != 2 or docs_padded.shape[1] != LANE:
        raise ValueError(f"docs_padded must be [rows, {LANE}]")
    if codec == "raw" and frac_padded.shape != docs_padded.shape:
        raise ValueError("frac_padded must match docs_padded's shape")
    n_tiles = row_lo.shape[0]
    if row_lo.shape != (n_tiles, t_pad) or row_hi.shape != (n_tiles, t_pad):
        raise ValueError(f"row tables must be [n_tiles, {t_pad}]")
    if weights.shape != (q_batch, t_pad):
        raise ValueError(f"weights must be [q_batch={q_batch}, {t_pad}]")
    if tile_ids is None:
        if live_t.shape != (n_tiles * LANE, sub):
            raise ValueError(f"live_t must be [{n_tiles * LANE}, {sub}]")
    else:
        if tile_ids.shape != (n_tiles,):
            raise ValueError(f"tile_ids must be [{n_tiles}], one a table row")
        if live_t.dim() != 2 or live_t.shape[1] != sub \
                or live_t.shape[0] % LANE:
            raise ValueError(f"live_t must be [n_tiles * {LANE}, {sub}]")


def canonical_lane_order(row_lo, row_hi) -> List[int]:
    """Lanes with rows, in ascending order of their first posting row
    (stable). Different terms own disjoint posting-row runs, so this is
    also each tile's order of its non-empty windows: the order in which the
    kernels add a query's lanes, whatever the lanes' table positions."""
    big = torch.iinfo(torch.int32).max
    key = torch.where(row_hi > row_lo, row_lo,
                      torch.full_like(row_lo, big)).amin(dim=0)
    order = torch.sort(key.cpu(), stable=True).indices.tolist()
    keys = key.cpu().tolist()
    return [j for j in order if keys[j] != big]


def _decode(docs_padded, frac_padded, rows):
    """Posting rows -> (docs int64, frac f32); frac_padded None is the
    packed codec: doc = word >>> 12 (logical), frac = (word & 0xFFF) *
    PACK_FRAC_SCALE in f32, the kernel's decode."""
    if frac_padded is None:
        word = docs_padded[rows]
        docs = (word.long() & 0xFFFFFFFF) >> PACK_FRAC_BITS
        scale = torch.tensor(np.float32(PACK_FRAC_SCALE))
        return docs, (word & PACK_FRAC_MASK).float() * scale
    return docs_padded[rows].long(), frac_padded[rows]


def _lane_postings(docs_padded, frac_padded, row_lo, row_hi, j: int,
                   w: int, base):
    """Lane j's valid postings over every table row (doc inside the row's
    tile [base, base + w), frac > 0): (accumulator positions row * w +
    local, frac f32)."""
    dev = docs_padded.device
    n_tiles = row_lo.shape[0]
    lens = (row_hi[:, j] - row_lo[:, j]).clamp(min=0).long()
    total = int(lens.sum())
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    rows = (row_lo[tile_of, j].long()
            + torch.arange(total, device=dev) - first[tile_of])
    docs, frac = _decode(docs_padded, frac_padded, rows)
    local = docs - base[tile_of][:, None]
    valid = (local >= 0) & (local < w) & (frac > 0.0)
    pos = local + (tile_of * w)[:, None]
    return pos[valid], frac[valid]


def _accumulate_plain(docs_padded, frac_padded, row_lo, row_hi, weights,
                      w: int, with_counts: bool, base=None):
    """Per-query accumulators [Q, n_rows * w], table row by table row in
    natural doc order (``base``: each row's first doc, row * w by
    default): for each lane in canonical order and each query with a
    nonzero weight, ``acc[doc] += w_q * frac`` through
    ``index_put_(accumulate=True)``. Within a lane the postings hit
    distinct docs, so each doc sees one f32 multiply and one f32 add per
    lane, exactly as in the kernels; counts are added where w_q > 0."""
    n_tiles = row_lo.shape[0]
    q_batch = weights.shape[0]
    dev = docs_padded.device
    if base is None:
        base = torch.arange(n_tiles, device=dev) * w
    acc = torch.zeros((q_batch, n_tiles * w), dtype=torch.float32, device=dev)
    cnt = torch.zeros_like(acc) if with_counts else None
    w_host = weights.cpu().tolist()
    for j in canonical_lane_order(row_lo, row_hi):
        live_q = [q for q in range(q_batch) if w_host[q][j] != 0.0]
        if not live_q:
            continue
        hit, frac = _lane_postings(docs_padded, frac_padded, row_lo, row_hi,
                                   j, w, base)
        for q in live_q:
            acc[q].index_put_((hit,), weights[q, j] * frac, accumulate=True)
            if with_counts and w_host[q][j] > 0.0:
                cnt[q].index_put_((hit,), torch.ones_like(frac),
                                  accumulate=True)
    return acc, cnt


def score_tiles_plain(docs_padded, frac_padded, live_t, row_lo, row_hi,
                      weights, *, sub: int, with_counts: bool = False,
                      q_batch: int = 1):
    """Plain PyTorch version of the dense kernels: (scores,) or (scores,
    counts), each [n_tiles*128, sub] f32 for q_batch 1 and
    [q_batch, n_tiles*128, sub] otherwise, live-masked. ``frac_padded``
    None reads ``docs_padded`` as packed words."""
    w = sub * LANE
    acc, cnt = _accumulate_plain(docs_padded, frac_padded, row_lo, row_hi,
                                 weights, w, with_counts)
    live = dense_to_flat(live_t, sub) > 0.0
    zero = torch.zeros_like(acc)

    def layout(x):
        x = torch.where(live, x, zero)
        out = torch.stack([flat_to_dense(row, sub) for row in x])
        return out[0] if q_batch == 1 else out

    outs = (layout(acc),)
    if with_counts:
        outs += (layout(cnt),)
    return outs


def score_tiles_topk_plain(docs_padded, frac_padded, live_t, row_lo, row_hi,
                           weights, *, sub: int, k: int, tile_ids=None):
    """Plain PyTorch version of the fused top-k kernel: per tile and query,
    matched = acc > 0 & live, the hit count, and the top ``k`` by (score
    descending, local doc ascending: a stable sort), empty slots -inf / -1.
    With ``tile_ids`` the table rows score those tiles (the subset's doc
    bases and live rows); a row with no window gives what an empty tile
    gives. ``frac_padded`` None reads packed words. Returns (tile_scores
    [n_rows, Q, k] f32, tile_docs [n_rows, Q, k] i32, tile_hits
    [n_rows, Q, 1] f32)."""
    w = sub * LANE
    n_tiles = row_lo.shape[0]
    q_batch = weights.shape[0]
    dev = docs_padded.device
    if tile_ids is None:
        base = torch.arange(n_tiles, device=dev) * w
    else:
        base = tile_ids.long() * w
        live_t = live_t.reshape(-1, LANE, sub)[tile_ids.long()].reshape(
            n_tiles * LANE, sub)
    acc, _ = _accumulate_plain(docs_padded, frac_padded, row_lo, row_hi,
                               weights, w, False, base)
    live = dense_to_flat(live_t, sub) > 0.0
    matched = (acc > 0.0) & live
    hits = matched.reshape(q_batch, n_tiles, w).sum(dim=2).float()
    masked = torch.where(matched, acc, torch.full_like(acc, float("-inf")))
    vals, idx = torch.sort(masked.reshape(q_batch, n_tiles, w), dim=2,
                           descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    docs = torch.where(vals == float("-inf"), torch.full_like(idx, -1),
                       idx + base[None, :, None]).to(torch.int32)
    return (vals.permute(1, 0, 2).contiguous(),
            docs.permute(1, 0, 2).contiguous(),
            hits.t().contiguous()[..., None])


def _score_tiles_cuda(docs_padded, frac_padded, live_t, row_lo, row_hi,
                      weights, *, sub: int, with_counts: bool, dense: bool,
                      q_batch: int, k: int, codec: str, tile_ids):
    lib = cuda_kernels.library()
    n_tiles, t_pad = row_lo.shape
    dev = docs_padded.device
    packed = codec == "packed"
    suffix = "_packed" if packed else ""
    common = (docs_padded.data_ptr(),
              None if packed else frac_padded.data_ptr(),
              live_t.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(),
              weights.data_ptr())
    scale = float(np.float32(PACK_FRAC_SCALE))
    # both kernels read postings and the mask 16 bytes at a time
    for what, t in (("docs_padded", docs_padded),
                    ("frac_padded", frac_padded), ("live_t", live_t)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary")
    if dense:
        plan = _launch_plan(sub, q_batch, with_counts, t_pad, n_tiles)
        shape = ((n_tiles * LANE, sub) if q_batch == 1
                 else (q_batch, n_tiles * LANE, sub))
        scores = torch.empty(shape, dtype=torch.float32, device=dev)
        counts = torch.empty_like(scores) if with_counts else None
        rc = lib.estpu_tile_scoring_dense(
            *common, scores.data_ptr(),
            counts.data_ptr() if with_counts else None,
            n_tiles, t_pad, sub, docs_padded.shape[0], q_batch,
            plan.band_sub, plan.group, int(packed), scale,
            cuda_kernels.stream_ptr(dev))
        name = ("tile_scoring" if q_batch == 1
                else "tile_scoring_batched") + suffix
        cuda_kernels.check(rc, name)
        cuda_kernels.note_launch(name)
        return (scores, counts) if with_counts else (scores,)
    tile_scores = torch.empty((n_tiles, q_batch, k), dtype=torch.float32,
                              device=dev)
    tile_docs = torch.empty((n_tiles, q_batch, k), dtype=torch.int32,
                            device=dev)
    tile_hits = torch.empty((n_tiles, q_batch, 1), dtype=torch.float32,
                            device=dev)
    plan = topk_launch_plan("tile", sub, q_batch, k, n_tiles, t_pad, packed,
                            dev)
    rc = lib.estpu_tile_scoring_topk(
        *common, None if tile_ids is None else tile_ids.data_ptr(),
        tile_scores.data_ptr(), tile_docs.data_ptr(), tile_hits.data_ptr(),
        n_tiles, t_pad, sub, docs_padded.shape[0], q_batch, k, plan.cluster,
        plan.group, int(packed), scale, cuda_kernels.stream_ptr(dev))
    name = ("tile_scoring_topk" + ("" if tile_ids is None else "_sel")
            + suffix)
    cuda_kernels.check(rc, name)
    cuda_kernels.note_launch(name)
    return tile_scores, tile_docs, tile_hits


def score_tiles(
    docs_padded,  # [n_blocks + CB_MAX, 128] i32 (pad_segment_blocks);
    # codec="packed": the packed words (pack_segment_blocks)
    frac_padded,  # [n_blocks + CB_MAX, 128] f32; codec="packed": None
    live_t,  # [n_tiles * 128, sub] f32 (1.0 = live; build_live_t)
    row_lo,  # [n_tiles, t_pad] i32 (tile_ids: [n_sel, t_pad], gathered)
    row_hi,  # [n_tiles, t_pad] i32
    weights,  # [q_batch, t_pad] f32
    *,
    t_pad: int,
    cb: int,
    sub: int,
    k: int = 10,
    dense: bool = False,
    with_counts: bool = False,
    tiles_per_step: int = 1,
    q_batch: int = 1,
    codec: str = "raw",
    tile_ids=None,  # [n_sel] i32: score only these tiles; top-k only
):
    """Score a segment's tiles; the JAX ``score_tiles`` signature.

    top-k (dense=False): (tile_scores [n_tiles, q_batch, k'] f32,
    tile_docs [n_tiles, q_batch, k'] i32 (-1 = empty), tile_hits
    [n_tiles, q_batch, 1] f32), k' = min(k, sub*128).
    dense: (scores,) or, with_counts, (scores, counts), each
    [n_tiles*128, sub] f32, with a leading [q_batch] axis when q_batch > 1.
    codec="packed" reads the packed words in ``docs_padded`` (frac_padded
    None). ``tile_ids`` scores a tile subset (top-k only): the row tables
    are gathered in subset order and the outputs have one row per subset
    entry. ``cb`` and ``tiles_per_step`` are TPU DMA knobs that do not
    change the outputs; they are accepted and ignored.

    On the card every form splits each tile into bands (the dense forms
    by ``dense_band_plan``, the top-k form by ``topk_cluster_plan``, a
    tile's bands one thread-block cluster) and a band reads only the rows
    whose first postings can reach it, so a lane's postings must ascend by
    doc across and within its rows, as every staging packs them;
    docs_padded, frac_padded and live_t must start on 16-byte
    boundaries."""
    del cb, tiles_per_step
    if tile_ids is not None and (dense or with_counts):
        # dense and match-count consumers need every tile's output
        raise ValueError(
            "tile-subset scoring serves the fused top-k variant only")
    q_batch = max(1, int(q_batch))
    k = min(int(k), sub * LANE)
    _check_inputs(docs_padded, frac_padded, live_t, row_lo, row_hi,
                  weights, t_pad, sub, q_batch, codec, tile_ids)
    if docs_padded.device.type == "cpu":
        frac = frac_padded if codec == "raw" else None
        if dense:
            return score_tiles_plain(docs_padded, frac, live_t, row_lo,
                                     row_hi, weights, sub=sub,
                                     with_counts=with_counts,
                                     q_batch=q_batch)
        return score_tiles_topk_plain(docs_padded, frac, live_t, row_lo,
                                      row_hi, weights, sub=sub, k=k,
                                      tile_ids=tile_ids)
    if docs_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {docs_padded.device}")
    return _score_tiles_cuda(docs_padded, frac_padded, live_t, row_lo,
                             row_hi, weights, sub=sub,
                             with_counts=with_counts, dense=dense,
                             q_batch=q_batch, k=k, codec=codec,
                             tile_ids=tile_ids)


def score_tiles_pruned(
    docs_padded,  # raw: padded docs; packed: the packed words
    frac_padded,  # raw: padded frac; packed: None
    live_t,
    rl_probe, rh_probe, tid_probe,  # plan_pruned_tiles outputs
    rl_rest, rh_rest, tid_rest,
    bounds_rest,  # [n_rest, q_batch] f32 per-(tile, query) score bounds
    weights,  # [q_batch, t_pad] f32
    *,
    t_pad: int,
    cb: int,
    sub: int,
    k: int = 10,
    q_batch: int = 1,
    q_real: Optional[int] = None,
    codec: str = "raw",
    tiles_per_step: int = 1,
):
    """Block-max pruned top-k scoring, every step enqueued on the device
    with no host round trip between the passes (a host-side threshold
    exchange would cost a sync per query):

    1. PROBE pass: score the ``probe`` highest-bound tiles (ordered on the
       host by plan_pruned_tiles); the k-th best candidate score per query
       is its threshold theta_q, a lower bound on the final k-th score
       (the pool only grows). It is read with ``torch.topk`` over the
       probe candidates: the k-th value needs no tie order.
    2. Gate: a rest tile survives iff some real member's bound reaches its
       threshold (bounds[t, q] >= theta_q). The others get their row
       tables zeroed with ``torch.where``; the sel-mode kernel skips them.
    3. REST pass over the masked tiles; both passes' pools merge per query
       (probe pool first, the JAX pool order that decides ties).

    No true top-k doc is ever skipped: a pruned tile's bound bounds each of
    its docs' scores and lies strictly below theta_q <= the final k-th
    score. ``hits`` counts matches in scored tiles only, a lower bound.
    ``q_real``: the leading rows of ``weights`` that are real members; the
    padding rows get theta = +inf and keep no tile alive. Returns (top_s
    [Q, k'], top_d [Q, k'], hits [Q] i32, tiles_scored i32 scalar), all on
    the device."""
    if q_real is None:
        q_real = q_batch
    kw = dict(t_pad=t_pad, cb=cb, sub=sub, k=k, tiles_per_step=tiles_per_step,
              q_batch=q_batch, codec=codec, dense=False)
    ts1, td1, th1 = score_tiles(
        docs_padded, frac_padded, live_t, rl_probe, rh_probe, weights,
        tile_ids=tid_probe, **kw)
    theta = probe_threshold([ts1], k, q_batch, q_real)
    survive = (bounds_rest >= theta[None, :]).any(dim=1)  # [n_rest]
    rl2, rh2, tid2 = gate_rows(survive, rl_rest, rh_rest, tid_rest)
    ts2, td2, th2 = score_tiles(
        docs_padded, frac_padded, live_t, rl2, rh2, weights,
        tile_ids=tid2, **kw)
    s1, d1, h1 = merge_tile_topk_batched(ts1, td1, th1, k)
    s2, d2, h2 = merge_tile_topk_batched(ts2, td2, th2, k)
    pool_s = torch.cat([s1, s2], dim=1)
    pool_d = torch.cat([d1, d2], dim=1)
    top_s, top_i = top_k(pool_s, min(k, pool_s.shape[1]))
    top_d = torch.gather(pool_d, 1, top_i)
    tiles_scored = (survive.sum(dtype=torch.int32)
                    + int(tid_probe.shape[0]))
    return top_s, top_d, h1 + h2, tiles_scored


def gate_rows(survive, row_lo, row_hi, tile_ids):
    """Zero the table rows (and tile ids) of the rest tiles that do not
    survive, on the device: the sel-mode kernel skips a row whose windows
    are all empty."""
    keep = survive[:, None]
    return (torch.where(keep, row_lo, torch.zeros_like(row_lo)),
            torch.where(keep, row_hi, torch.zeros_like(row_hi)),
            torch.where(survive, tile_ids, torch.zeros_like(tile_ids)))


def probe_threshold(tile_scores: Sequence[torch.Tensor], k: int,
                    q_batch: int, q_real: int) -> torch.Tensor:
    """theta [Q] f32 from probe-pass candidates (each [n_tiles, Q, k']): the
    k-th best score per query over all of them, -inf when they hold fewer
    than k slots, +inf for padding members (q >= q_real). Equal to the
    k-th score of the merged probe pool, computed without a host sync."""
    pool = torch.cat([t.transpose(0, 1).reshape(q_batch, -1)
                      for t in tile_scores], dim=1)
    dev = pool.device
    if pool.shape[1] >= k:
        kth = torch.topk(pool, k, dim=1, sorted=True).values[:, k - 1]
    else:
        kth = torch.full((q_batch,), float("-inf"), dtype=torch.float32,
                         device=dev)
    real = torch.arange(q_batch, device=dev) < q_real
    return torch.where(real, kth, torch.full_like(kth, float("inf")))


def merge_tile_topk(tile_scores, tile_docs, tile_hits, k: int):
    """Merge per-tile candidates: global top-k by score and the total live
    hit count (int32)."""
    flat_s = tile_scores.reshape(-1)
    flat_d = tile_docs.reshape(-1)
    top_s, top_i = top_k(flat_s, min(k, flat_s.shape[0]))
    return top_s, flat_d[top_i], tile_hits.sum().to(torch.int32)


def merge_tile_topk_batched(tile_scores, tile_docs, tile_hits, k: int):
    """Per-query merge of a batched top-k launch: tile_scores/tile_docs
    [n_tiles, Q, k_in]; returns (top_s [Q, k'], top_d [Q, k'], hits [Q]
    i32) with k' = min(k, n_tiles * k_in)."""
    n_tiles, q, _ = tile_scores.shape
    flat_s = tile_scores.transpose(0, 1).reshape(q, -1)
    flat_d = tile_docs.transpose(0, 1).reshape(q, -1)
    top_s, top_i = top_k(flat_s, min(k, flat_s.shape[1]))
    top_d = torch.gather(flat_d, 1, top_i)
    hits = tile_hits.reshape(n_tiles, q).sum(dim=0).to(torch.int32)
    return top_s, top_d, hits
