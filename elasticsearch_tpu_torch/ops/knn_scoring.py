"""Dense-vector (kNN) scoring: kernel 3 and its host helpers.

Counterpart of ``elasticsearch_tpu/ops/pallas_knn.py``. The doc space is
split into tiles of ``W = sub * 128`` docs. For each tile and query the
kernel scores every doc

    s = ((dot(x, q) * scale) * 0.5) + 0.5

with ``x`` the doc's bf16 embedding read as f32, ``q`` the f32 query (unit
length for cosine, ``normalize_query``) and ``scale`` the doc's inverse
norm for cosine (``vector_scale_column``; dot_product has none). A doc at
or beyond ``n_rows``, or with ``mask <= 0`` (deleted, or without a vector),
scores ``-inf``. Each (tile, query) then keeps its ``k`` best (score
descending, doc ascending); empty slots are (``-inf``, ``-1``). Outputs are
``[n_tiles, Q, k]`` (the layout of kernel 1c; ``merge_knn_topk`` pools
them tile-major per query, the JAX package's pool order).

``knn_score_tiles`` dispatches on the tensors' device: a CPU tensor runs
the plain PyTorch version (``knn_score_tiles_plain``); a CUDA tensor
launches the hand-written kernel in ``csrc/knn_scoring.cu`` or raises;
``tile_scoring.topk_cluster_plan`` splits the launch (each tile's docs into
a cluster of bands, the queries into groups that read each embedding row
once).
Both sum ``x_j * q_j`` over ``j`` in ascending order, each product and
each sum rounded to f32 on its own, then apply the scale, the ``* 0.5``
and the ``+ 0.5`` one rounding at a time, so they agree bit for bit.
Against the JAX kernel (an f32 dot at ``Precision.HIGHEST`` in XLA's own
order) scores agree within ``1e-6 + 1e-6 * sum_j |x_j * q_j|``.

The host helpers (dims padding, tile size, bf16 rounding, the metric's
scale column, query normalization, the numpy oracle) are copied from the
JAX package as numpy; ``bf16_round`` rounds through ``torch.bfloat16``
(round to nearest even, as ``ml_dtypes`` does).

``host_knn_scores`` is the host rung's product (``plan.KnnScoreNode``):
one f32 matrix-vector product per query, which the JAX package leaves to
XLA outside any Pallas kernel; here it is ``torch.matmul`` over row chunks
converted from bf16 into one reused f32 buffer, with TF32 off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_kernels
from elasticsearch_tpu_torch.ops.scoring import top_k
from elasticsearch_tpu_torch.ops import tile_scoring

LANE = 128
NEG_INF = float("-inf")

# default tile: 8192 docs
DEFAULT_KNN_SUB = 64
# the JAX kernel's VMEM budget for the f32-converted embedding block;
# knn_tile_sub shrinks the tile for high dims so both packages take the
# same tile geometry (on the card the block is never materialized)
KNN_TILE_F32_BUDGET = 8 * 1024 * 1024
VALID_KNN_SUBS = (8, 16, 32, 64, 128)
# the widest query row the kernel keeps in shared memory
MAX_D_PAD = 1024
# floats converted from bf16 at a time by host_knn_scores (32 MB of f32)
HOST_CHUNK_F32 = 8 << 20
# rows the plain version scores at a time (bounds its temporaries)
PLAIN_CHUNK_ROWS = 1 << 16


def pad_dims(dims: int) -> int:
    """Embedding columns pad to a lane multiple (zeros never change a
    dot)."""
    return max(((int(dims) + LANE - 1) // LANE) * LANE, LANE)


def knn_tile_sub(nd_pad: int, d_pad: int,
                 pref: int = DEFAULT_KNN_SUB) -> int:
    """Tile sublane count for a kNN launch: the preference (the
    ``search.knn.tile_sub`` setting), shrunk until the f32-converted tile
    fits the JAX kernel's budget, floored at 8. ``tile_geometry`` shrinks
    further for small doc spaces."""
    sub = pref if pref in VALID_KNN_SUBS else DEFAULT_KNN_SUB
    while sub > 8 and sub * LANE * d_pad * 4 > KNN_TILE_F32_BUDGET:
        sub //= 2
    return sub


def knn_geometry(nd_pad: int, d_pad: int, pref: int = DEFAULT_KNN_SUB):
    """TileGeometry of a kNN launch over an ``nd_pad`` doc space."""
    from elasticsearch_tpu_torch.ops.tile_scoring import tile_geometry

    return tile_geometry(max(nd_pad, LANE), knn_tile_sub(nd_pad, d_pad, pref))


def bf16_round(vectors) -> np.ndarray:
    """Round an f32 host matrix to the bf16 grid (what the device stores
    and the kernel decodes) and return it as f32: the host mirror that the
    oracle scores."""
    x = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32))
    return x.to(torch.bfloat16).to(torch.float32).numpy()


def vector_scale_column(vectors_f32: np.ndarray, metric: str) -> np.ndarray:
    """Per-doc score scale [nd_pad, 1] f32: 1/|x| for cosine (a zero-norm
    doc scales to 0 and scores 0.5), ones for dot_product."""
    if metric == "cosine":
        norms = np.linalg.norm(vectors_f32.astype(np.float32), axis=1)
        with np.errstate(divide="ignore"):
            inv = np.where(norms > 0.0, 1.0 / norms, 0.0)
        return inv.astype(np.float32).reshape(-1, 1)
    return np.ones((vectors_f32.shape[0], 1), np.float32)


def normalize_query(qvec, metric: str, d_pad: int) -> np.ndarray:
    """The query row for the kernel and the oracle: f32, zero-padded to
    ``d_pad``; cosine also divides by |q| (a zero query stays zero)."""
    q = np.zeros(d_pad, np.float32)
    v = np.asarray(qvec, np.float32)
    q[: v.shape[0]] = v
    if metric == "cosine":
        n = float(np.linalg.norm(v))
        if n > 0.0:
            q[: v.shape[0]] = v / n
    return q


def reference_knn_scores(vectors_f32: np.ndarray, qvec,
                         metric: str = "cosine",
                         scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact f32 scores over the bf16-rounded host mirror (the oracle).
    ``qvec`` is the raw user vector."""
    qvec = np.asarray(qvec, np.float32)
    q = normalize_query(qvec, metric, max(vectors_f32.shape[1],
                                          qvec.shape[0]))
    s = vectors_f32.astype(np.float32) @ q[: vectors_f32.shape[1]]
    if scale is None:
        scale = vector_scale_column(vectors_f32, metric)
    return (s * scale[:, 0] * np.float32(0.5)
            + np.float32(0.5)).astype(np.float32)


def reference_knn_topk(vectors_f32: np.ndarray, mask: np.ndarray, qvec,
                       k: int, metric: str = "cosine"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k (scores, doc ids) over live vector docs."""
    s = reference_knn_scores(vectors_f32, qvec, metric)
    masked = np.where(mask[: len(s)], s, -np.inf)
    k = min(k, len(masked))
    idx = np.argpartition(-masked, k - 1)[:k] if k < len(masked) \
        else np.arange(len(masked))
    idx = idx[np.argsort(-masked[idx], kind="stable")]
    return masked[idx], idx


# ----------------------------------------------------------------------
# Kernel 3, its plain version and the wrapper
# ----------------------------------------------------------------------


def _check_inputs(emb, scale, mask, qvecs, sub: int, q_batch: int,
                  n_rows: int) -> int:
    """Validates the operands; returns n_tiles."""
    dev = emb.device
    for name, t, dtype in (("emb", emb, torch.bfloat16),
                           ("scale", scale, torch.float32),
                           ("mask", mask, torch.float32),
                           ("qvecs", qvecs, torch.float32)):
        if t is None and name == "scale":
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, emb on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if emb.dim() != 2:
        raise ValueError("emb must be [rows, d_pad]")
    d_pad = emb.shape[1]
    if d_pad % 8 or d_pad > MAX_D_PAD:
        raise ValueError(f"d_pad={d_pad} must be a multiple of 8 and at "
                         f"most {MAX_D_PAD}")
    if qvecs.shape != (q_batch, d_pad):
        raise ValueError(f"qvecs must be [q_batch={q_batch}, {d_pad}]")
    if not 0 <= n_rows <= emb.shape[0]:
        raise ValueError(f"n_rows={n_rows} outside [0, {emb.shape[0]}]")
    if scale is not None and scale.numel() < n_rows:
        raise ValueError(f"scale has {scale.numel()} rows, need {n_rows}")
    w = sub * LANE
    if sub < 1 or sub & (sub - 1):
        raise ValueError(f"sub={sub} must be a power of two")
    if mask.numel() == 0 or mask.numel() % w:
        raise ValueError(f"mask has {mask.numel()} entries, not a multiple "
                         f"of the tile {w}")
    return mask.numel() // w


def knn_score_tiles_plain(emb, scale, mask, qvecs, *, sub: int, k: int,
                          n_rows: int):
    """Plain PyTorch version of kernel 3: the same products and sums in
    the same order (rows in chunks of ``PLAIN_CHUNK_ROWS``, which changes
    no per-doc arithmetic), then per (tile, query) the top ``k`` by (score
    descending, local doc ascending). Returns (tile_scores [n_tiles, Q,
    k] f32, tile_docs [n_tiles, Q, k] i32, -1 = empty)."""
    w = sub * LANE
    n_tiles = mask.numel() // w
    q_batch, d_pad = qvecs.shape
    dev = emb.device
    total = n_tiles * w
    rows = min(n_rows, total)
    scores = torch.full((total, q_batch), NEG_INF, dtype=torch.float32,
                        device=dev)
    q_t = qvecs.t().contiguous()  # [d_pad, Q]
    live = mask.reshape(-1) > 0.0
    for lo in range(0, rows, PLAIN_CHUNK_ROWS):
        hi = min(lo + PLAIN_CHUNK_ROWS, rows)
        x_t = emb[lo:hi].to(torch.float32).t().contiguous()  # [d_pad, R]
        acc = torch.zeros((hi - lo, q_batch), dtype=torch.float32,
                          device=dev)
        for j in range(d_pad):
            acc = torch.add(acc, torch.mul(x_t[j][:, None], q_t[j][None, :]))
        if scale is not None:
            acc = torch.mul(acc, scale.reshape(-1)[lo:hi, None])
        acc = torch.add(torch.mul(acc, 0.5), 0.5)
        scores[lo:hi] = torch.where(live[lo:hi, None], acc,
                                    torch.full_like(acc, NEG_INF))
    k = min(int(k), w)
    per_tile = scores.reshape(n_tiles, w, q_batch).permute(0, 2, 1)
    vals, idx = top_k(per_tile, k)
    base = (torch.arange(n_tiles, device=dev) * w)[:, None, None]
    docs = torch.where(vals == NEG_INF, torch.full_like(idx, -1),
                       idx + base).to(torch.int32)
    return vals.contiguous(), docs.contiguous()


def _knn_score_tiles_cuda(emb, scale, mask, qvecs, *, sub: int, k: int,
                          q_batch: int, n_rows: int, n_tiles: int):
    lib = cuda_kernels.library()
    dev = emb.device
    if emb.data_ptr() % 16:
        raise ValueError("emb must start on a 16-byte boundary")
    tile_scores = torch.empty((n_tiles, q_batch, k), dtype=torch.float32,
                              device=dev)
    tile_docs = torch.empty((n_tiles, q_batch, k), dtype=torch.int32,
                            device=dev)
    plan = tile_scoring.topk_launch_plan("knn", sub, q_batch, k, n_tiles,
                                         emb.shape[1], False, dev)
    rc = lib.estpu_knn_score_tiles(
        emb.data_ptr(), scale.data_ptr() if scale is not None else None,
        mask.data_ptr(), qvecs.data_ptr(), tile_scores.data_ptr(),
        tile_docs.data_ptr(), n_tiles, sub, emb.shape[1], n_rows, q_batch, k,
        plan.cluster, plan.group, cuda_kernels.stream_ptr(dev))
    cuda_kernels.check(rc, "knn_scoring")
    cuda_kernels.note_launch("knn_scoring")
    return tile_scores, tile_docs


def knn_score_tiles(
    emb,  # [rows, d_pad] bf16: the segment's staged embeddings
    scale,  # [>= n_rows] f32 inverse norms (cosine), or None (dot_product)
    mask,  # [n_tiles * W] f32: 1.0 = live and has a vector
    qvecs,  # [q_batch, d_pad] f32 (normalize_query rows)
    *,
    sub: int,
    k: int = 10,
    q_batch: int = 1,
    n_rows: Optional[int] = None,
):
    """Score the tiles of one doc space for a batch of queries; the JAX
    ``knn_score_tiles`` with the staged arrays of one segment. Only the
    first ``n_rows`` (default: all) rows of ``emb`` are read; docs at or
    beyond it are dead. Returns (tile_scores [n_tiles, q_batch, k'] f32,
    tile_docs [n_tiles, q_batch, k'] i32, -1 = empty), k' = min(k,
    sub * 128)."""
    q_batch = max(1, int(q_batch))
    n_rows = emb.shape[0] if n_rows is None else int(n_rows)
    if scale is not None:
        scale = scale.reshape(-1)
    mask = mask.reshape(-1)
    n_tiles = _check_inputs(emb, scale, mask, qvecs, sub, q_batch, n_rows)
    k = min(int(k), sub * LANE)
    if emb.device.type == "cpu":
        return knn_score_tiles_plain(emb, scale, mask, qvecs, sub=sub, k=k,
                                     n_rows=n_rows)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    return _knn_score_tiles_cuda(emb, scale, mask, qvecs, sub=sub, k=k,
                                 q_batch=q_batch, n_rows=n_rows,
                                 n_tiles=n_tiles)


def merge_knn_topk(tile_scores, tile_docs, k: int):
    """Merge per-tile candidates per query: tile_scores/tile_docs
    [n_tiles, Q, kk]; the pool of each query is tile-major (the JAX
    package's order, which decides ties: lower pool index first). Returns
    (top_s [Q, k'], top_d [Q, k'] i32), k' = min(k, n_tiles * kk)."""
    n_tiles, q, _ = tile_scores.shape
    pool_s = tile_scores.transpose(0, 1).reshape(q, -1)
    pool_d = tile_docs.transpose(0, 1).reshape(q, -1)
    top_s, top_i = top_k(pool_s, min(int(k), pool_s.shape[1]))
    return top_s, torch.gather(pool_d, 1, top_i)


def host_knn_scores(emb, qvec) -> torch.Tensor:
    """The host rung's product: ``emb.float() @ qvec`` ([rows] f32) for a
    bf16 ``emb`` [rows, d_pad] and an f32 ``qvec`` [d_pad], converting
    row chunks into one reused f32 buffer (never the whole matrix). TF32
    must be off: it keeps about three decimal digits."""
    if emb.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set: the kNN host "
            "rung needs full float32 products")
    rows, d_pad = emb.shape
    out = torch.empty(rows, dtype=torch.float32, device=emb.device)
    chunk = max(1, min(rows, HOST_CHUNK_F32 // d_pad))
    buf = torch.empty((chunk, d_pad), dtype=torch.float32, device=emb.device)
    q = qvec.reshape(-1).to(torch.float32)
    for lo in range(0, rows, chunk):
        hi = min(lo + chunk, rows)
        part = buf[: hi - lo]
        part.copy_(emb[lo:hi])
        torch.matmul(part, q, out=out[lo:hi])
    return out
