"""Tile scoring: the BM25 scoring hot loop, dense variant.

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

``score_tiles`` dispatches on the tensors' device: a CPU tensor runs the
plain PyTorch version (``score_tiles_plain``); a CUDA tensor launches the
hand-written kernel in ``csrc/tile_scoring.cu`` or raises. Both make the
same f32 adds in the same lane order, so they agree bit for bit. Only the
raw codec, ``q_batch=1`` and the dense variant are ported; the packed
codec, batching, the fused top-k and tile subsets are later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_kernels
from elasticsearch_tpu_torch.ops.scoring import B, K1

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
# The kernel, its plain version and the wrapper
# ----------------------------------------------------------------------


def _check_inputs(docs_padded, frac_padded, live_t, row_lo, row_hi,
                  weights, t_pad: int, sub: int) -> None:
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
    if weights.shape != (1, t_pad):
        raise ValueError(f"weights must be [1, {t_pad}] (q_batch=1)")
    if live_t.shape != (n_tiles * LANE, sub):
        raise ValueError(f"live_t must be [{n_tiles * LANE}, {sub}]")


def score_tiles_plain(docs_padded, frac_padded, live_t, row_lo, row_hi,
                      weights, *, sub: int, with_counts: bool = False):
    """Plain PyTorch version of the dense kernel: the same per-lane adds in
    the same lane order, ``acc[doc] += w * frac`` through
    ``index_put_(accumulate=True)``. Within a lane the postings hit
    distinct docs, so each doc sees one f32 multiply and one f32 add per
    lane, exactly as in the kernel."""
    n_tiles, t_pad = row_lo.shape
    w = sub * LANE
    dev = docs_padded.device
    acc = torch.zeros(n_tiles * w, dtype=torch.float32, device=dev)
    cnt = torch.zeros_like(acc) if with_counts else None
    tiles = torch.arange(n_tiles, device=dev)
    for j in range(t_pad):
        lens = (row_hi[:, j] - row_lo[:, j]).clamp(min=0).long()
        total = int(lens.sum())
        if total == 0:
            continue
        tile_of = torch.repeat_interleave(tiles, lens)
        first = torch.cumsum(lens, 0) - lens
        rows = (row_lo[tile_of, j].long()
                + torch.arange(total, device=dev) - first[tile_of])
        docs = docs_padded[rows].long()
        frac = frac_padded[rows]
        local = docs - (tile_of * w)[:, None]
        valid = (local >= 0) & (local < w) & (frac > 0.0)
        hit = docs[valid]
        acc.index_put_((hit,), weights[0, j] * frac[valid], accumulate=True)
        if with_counts:
            cnt.index_put_((hit,), torch.ones_like(frac[valid]),
                           accumulate=True)
    live = dense_to_flat(live_t, sub) > 0.0
    zero = torch.zeros_like(acc)
    outs = (flat_to_dense(torch.where(live, acc, zero), sub),)
    if with_counts:
        outs += (flat_to_dense(torch.where(live, cnt, zero), sub),)
    return outs


def _score_tiles_cuda(docs_padded, frac_padded, live_t, row_lo, row_hi,
                      weights, *, sub: int, with_counts: bool):
    lib = cuda_kernels.library()
    n_tiles, t_pad = row_lo.shape
    dev = docs_padded.device
    scores = torch.empty((n_tiles * LANE, sub), dtype=torch.float32,
                         device=dev)
    counts = torch.empty_like(scores) if with_counts else None
    rc = lib.estpu_tile_scoring_dense(
        docs_padded.data_ptr(), frac_padded.data_ptr(), live_t.data_ptr(),
        row_lo.data_ptr(), row_hi.data_ptr(), weights.data_ptr(),
        scores.data_ptr(), counts.data_ptr() if with_counts else None,
        n_tiles, t_pad, sub, docs_padded.shape[0],
        cuda_kernels.stream_ptr(dev))
    cuda_kernels.check(rc, "tile_scoring")
    cuda_kernels.note_launch("tile_scoring")
    return (scores, counts) if with_counts else (scores,)


def score_tiles(
    docs_padded,  # [n_blocks + CB_MAX, 128] i32 (pad_segment_blocks)
    frac_padded,  # [n_blocks + CB_MAX, 128] f32
    live_t,  # [n_tiles * 128, sub] f32 (1.0 = live; build_live_t)
    row_lo,  # [n_tiles, t_pad] i32
    row_hi,  # [n_tiles, t_pad] i32
    weights,  # [1, t_pad] f32
    *,
    t_pad: int,
    cb: int,
    sub: int,
    dense: bool = True,
    with_counts: bool = False,
    tiles_per_step: int = 1,
    q_batch: int = 1,
    codec: str = "raw",
):
    """Score a segment's tiles; the JAX ``score_tiles`` signature (dense
    variant). Returns (scores [n_tiles*128, sub] f32,) or, with_counts,
    (scores, counts). ``cb`` and ``tiles_per_step`` are TPU DMA knobs that
    do not change the outputs; they are accepted and ignored."""
    del cb, tiles_per_step
    if not dense or q_batch != 1 or codec != "raw":
        raise NotImplementedError(
            "only the dense, raw-codec, q_batch=1 tile-scoring variant is "
            "ported (top-k, packed, batched and tile-subset variants are "
            "later slices)")
    _check_inputs(docs_padded, frac_padded, live_t, row_lo, row_hi,
                  weights, t_pad, sub)
    if docs_padded.device.type == "cpu":
        return score_tiles_plain(docs_padded, frac_padded, live_t, row_lo,
                                 row_hi, weights, sub=sub,
                                 with_counts=with_counts)
    if docs_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {docs_padded.device}")
    return _score_tiles_cuda(docs_padded, frac_padded, live_t, row_lo,
                             row_hi, weights, sub=sub,
                             with_counts=with_counts)
