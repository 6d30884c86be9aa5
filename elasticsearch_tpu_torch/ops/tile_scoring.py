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
- fused per-tile top-k (``dense=False``), any ``q_batch``: per tile and
  query the ``k`` best (score, doc) pairs and the hit count.

``score_tiles`` dispatches on the tensors' device: a CPU tensor runs the
plain PyTorch version (``score_tiles_plain``); a CUDA tensor launches the
hand-written kernel in ``csrc/tile_scoring.cu`` or raises. Both add each
query's lanes in one canonical order (ascending first posting row, see
``canonical_lane_order``) with the same f32 multiply and add, so they agree
bit for bit, and a batched member equals its ``q_batch=1`` result bit for
bit (except a member naming one posting run twice with different weights:
the union merges the two lanes, as in the JAX package). The packed codec
and tile subsets (block-max pruning) are later slices and raise.

``merge_tile_topk`` / ``merge_tile_topk_batched`` merge the per-tile
candidates with ``lax.top_k``'s tie order (lower flat index first), which
``torch.topk`` does not promise, through ``scoring.top_k``.
"""

from __future__ import annotations

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
# The kernels, their plain versions and the wrapper
# ----------------------------------------------------------------------


def _check_inputs(docs_padded, frac_padded, live_t, row_lo, row_hi,
                  weights, t_pad: int, sub: int, q_batch: int) -> None:
    tensors = {"docs_padded": docs_padded, "frac_padded": frac_padded,
               "live_t": live_t, "row_lo": row_lo, "row_hi": row_hi,
               "weights": weights}
    dev = docs_padded.device
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, docs_padded on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, want in (("docs_padded", torch.int32),
                       ("frac_padded", torch.float32),
                       ("live_t", torch.float32), ("row_lo", torch.int32),
                       ("row_hi", torch.int32), ("weights", torch.float32)):
        if tensors[name].dtype != want:
            raise TypeError(f"{name} must be {want}, got {tensors[name].dtype}")
    if docs_padded.dim() != 2 or docs_padded.shape[1] != LANE:
        raise ValueError(f"docs_padded must be [rows, {LANE}]")
    if frac_padded.shape != docs_padded.shape:
        raise ValueError("frac_padded must match docs_padded's shape")
    n_tiles = row_lo.shape[0]
    if row_lo.shape != (n_tiles, t_pad) or row_hi.shape != (n_tiles, t_pad):
        raise ValueError(f"row tables must be [n_tiles, {t_pad}]")
    if weights.shape != (q_batch, t_pad):
        raise ValueError(f"weights must be [q_batch={q_batch}, {t_pad}]")
    if live_t.shape != (n_tiles * LANE, sub):
        raise ValueError(f"live_t must be [{n_tiles * LANE}, {sub}]")


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


def _lane_postings(docs_padded, frac_padded, row_lo, row_hi, j: int,
                   w: int):
    """Lane j's valid postings over every tile (doc inside the tile,
    frac > 0): (docs int64, frac f32)."""
    dev = docs_padded.device
    n_tiles = row_lo.shape[0]
    lens = (row_hi[:, j] - row_lo[:, j]).clamp(min=0).long()
    total = int(lens.sum())
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    rows = (row_lo[tile_of, j].long()
            + torch.arange(total, device=dev) - first[tile_of])
    docs = docs_padded[rows].long()
    frac = frac_padded[rows]
    local = docs - (tile_of * w)[:, None]
    valid = (local >= 0) & (local < w) & (frac > 0.0)
    return docs[valid], frac[valid]


def _accumulate_plain(docs_padded, frac_padded, row_lo, row_hi, weights,
                      w: int, with_counts: bool):
    """Per-query accumulators [Q, n_tiles * w] in natural doc order: for
    each lane in canonical order and each query with a nonzero weight,
    ``acc[doc] += w_q * frac`` through ``index_put_(accumulate=True)``.
    Within a lane the postings hit distinct docs, so each doc sees one f32
    multiply and one f32 add per lane, exactly as in the kernels; counts
    are added where w_q > 0."""
    n_tiles = row_lo.shape[0]
    q_batch = weights.shape[0]
    dev = docs_padded.device
    acc = torch.zeros((q_batch, n_tiles * w), dtype=torch.float32, device=dev)
    cnt = torch.zeros_like(acc) if with_counts else None
    w_host = weights.cpu().tolist()
    for j in canonical_lane_order(row_lo, row_hi):
        live_q = [q for q in range(q_batch) if w_host[q][j] != 0.0]
        if not live_q:
            continue
        hit, frac = _lane_postings(docs_padded, frac_padded, row_lo, row_hi,
                                   j, w)
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
    [q_batch, n_tiles*128, sub] otherwise, live-masked."""
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
                           weights, *, sub: int, k: int):
    """Plain PyTorch version of the fused top-k kernel: per tile and query,
    matched = acc > 0 & live, the hit count, and the top ``k`` by (score
    descending, local doc ascending: a stable sort), empty slots -inf / -1.
    Returns (tile_scores [n_tiles, Q, k] f32, tile_docs [n_tiles, Q, k]
    i32, tile_hits [n_tiles, Q, 1] f32)."""
    w = sub * LANE
    n_tiles = row_lo.shape[0]
    q_batch = weights.shape[0]
    acc, _ = _accumulate_plain(docs_padded, frac_padded, row_lo, row_hi,
                               weights, w, False)
    live = dense_to_flat(live_t, sub) > 0.0
    matched = (acc > 0.0) & live
    hits = matched.reshape(q_batch, n_tiles, w).sum(dim=2).float()
    masked = torch.where(matched, acc, torch.full_like(acc, float("-inf")))
    vals, idx = torch.sort(masked.reshape(q_batch, n_tiles, w), dim=2,
                           descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    base = (torch.arange(n_tiles, device=acc.device) * w)[None, :, None]
    docs = torch.where(vals == float("-inf"), torch.full_like(idx, -1),
                       idx + base).to(torch.int32)
    return (vals.permute(1, 0, 2).contiguous(),
            docs.permute(1, 0, 2).contiguous(),
            hits.t().contiguous()[..., None])


def _score_tiles_cuda(docs_padded, frac_padded, live_t, row_lo, row_hi,
                      weights, *, sub: int, with_counts: bool, dense: bool,
                      q_batch: int, k: int):
    lib = cuda_kernels.library()
    n_tiles, t_pad = row_lo.shape
    dev = docs_padded.device
    common = (docs_padded.data_ptr(), frac_padded.data_ptr(),
              live_t.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(),
              weights.data_ptr())
    if dense:
        shape = ((n_tiles * LANE, sub) if q_batch == 1
                 else (q_batch, n_tiles * LANE, sub))
        scores = torch.empty(shape, dtype=torch.float32, device=dev)
        counts = torch.empty_like(scores) if with_counts else None
        rc = lib.estpu_tile_scoring_dense(
            *common, scores.data_ptr(),
            counts.data_ptr() if with_counts else None,
            n_tiles, t_pad, sub, docs_padded.shape[0], q_batch,
            cuda_kernels.stream_ptr(dev))
        name = "tile_scoring" if q_batch == 1 else "tile_scoring_batched"
        cuda_kernels.check(rc, name)
        cuda_kernels.note_launch(name)
        return (scores, counts) if with_counts else (scores,)
    tile_scores = torch.empty((n_tiles, q_batch, k), dtype=torch.float32,
                              device=dev)
    tile_docs = torch.empty((n_tiles, q_batch, k), dtype=torch.int32,
                            device=dev)
    tile_hits = torch.empty((n_tiles, q_batch, 1), dtype=torch.float32,
                            device=dev)
    rc = lib.estpu_tile_scoring_topk(
        *common, tile_scores.data_ptr(), tile_docs.data_ptr(),
        tile_hits.data_ptr(), n_tiles, t_pad, sub, docs_padded.shape[0],
        q_batch, k, cuda_kernels.stream_ptr(dev))
    cuda_kernels.check(rc, "tile_scoring_topk")
    cuda_kernels.note_launch("tile_scoring_topk")
    return tile_scores, tile_docs, tile_hits


def score_tiles(
    docs_padded,  # [n_blocks + CB_MAX, 128] i32 (pad_segment_blocks)
    frac_padded,  # [n_blocks + CB_MAX, 128] f32
    live_t,  # [n_tiles * 128, sub] f32 (1.0 = live; build_live_t)
    row_lo,  # [n_tiles, t_pad] i32
    row_hi,  # [n_tiles, t_pad] i32
    weights,  # [q_batch, t_pad] f32
    *,
    t_pad: int,
    cb: int,
    sub: int,
    k: int = 10,
    dense: bool = True,
    with_counts: bool = False,
    tiles_per_step: int = 1,
    q_batch: int = 1,
    codec: str = "raw",
    tile_ids=None,
):
    """Score a segment's tiles; the JAX ``score_tiles`` signature.

    dense: (scores,) or, with_counts, (scores, counts), each
    [n_tiles*128, sub] f32, with a leading [q_batch] axis when q_batch > 1.
    top-k (dense=False): (tile_scores [n_tiles, q_batch, k'] f32,
    tile_docs [n_tiles, q_batch, k'] i32 (-1 = empty), tile_hits
    [n_tiles, q_batch, 1] f32), k' = min(k, sub*128); with_counts does not
    apply there. ``cb`` and ``tiles_per_step`` are TPU DMA knobs that do
    not change the outputs; they are accepted and ignored."""
    del cb, tiles_per_step
    if codec != "raw" or tile_ids is not None:
        raise NotImplementedError(
            "the packed codec and tile-subset (pruned) scoring are not "
            "ported yet")
    q_batch = max(1, int(q_batch))
    k = min(int(k), sub * LANE)
    _check_inputs(docs_padded, frac_padded, live_t, row_lo, row_hi,
                  weights, t_pad, sub, q_batch)
    if docs_padded.device.type == "cpu":
        if dense:
            return score_tiles_plain(docs_padded, frac_padded, live_t,
                                     row_lo, row_hi, weights, sub=sub,
                                     with_counts=with_counts,
                                     q_batch=q_batch)
        return score_tiles_topk_plain(docs_padded, frac_padded, live_t,
                                      row_lo, row_hi, weights, sub=sub, k=k)
    if docs_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {docs_padded.device}")
    return _score_tiles_cuda(docs_padded, frac_padded, live_t, row_lo,
                             row_hi, weights, sub=sub,
                             with_counts=with_counts, dense=dense,
                             q_batch=q_batch, k=k)


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
