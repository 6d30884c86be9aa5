"""Query execution plans: a query tree run eagerly on one segment's tensors.

Counterpart of ``elasticsearch_tpu/search/plan.py``. The JAX package traces
the tree once into one jitted XLA program; PyTorch runs eagerly, so
``execute`` simply walks the tree. Every node emits ``(scores f32[nd1],
matched bool[nd1])`` with ``nd1 = nd_pad + 1``, the trailing slot a
sentinel that collects padding writes.

Nodes ported: ScoreTermsNode (scatter scoring under any similarity),
PallasScoreTermsNode (the tile-scoring kernel; the name is kept so the
counterpart is easy to find), KnnScoreNode (dense-vector similarity, the
kNN host rung), PhraseScoreNode (host-verified phrase frequencies scored
on the device), MatchAllNode, MatchNoneNode, NumericRangeNode,
NumericTermsNode, OrdTermsNode, OrdRangeNode, OrdSetNode (ip term and
range), RangePairNode (range
fields), GeoDistanceNode and GeoBoxNode (geo points), DenseMaskNode
(exists, ids, geo_polygon), BoolNode, ConstantScoreNode, BoostNode,
DisMaxNode, FunctionScoreNode and DenseScoreNode (the scores and mask a
nested or join clause folded on the host).

For the mesh plane (parallel/plan_exec.py) every node declares how its
arrays pad when per-segment plans of one query are stacked
(``pad_kinds``) and which static attributes must agree across them
(``trace_statics``); a stacked plan then runs per slot through the same
``emit``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from elasticsearch_tpu_torch.ops.scoring import B, K1


class PlanNode:
    """Base: subclasses define emit(ctx) and arrays()."""

    def emit(self, ctx: "EmitCtx"):
        raise NotImplementedError

    def arrays(self) -> List:
        return []

    def children(self) -> List["PlanNode"]:
        return []

    def flat_arrays(self) -> List:
        out = list(self.arrays())
        for c in self.children():
            out.extend(c.flat_arrays())
        return out

    def pad_kinds(self) -> List[str]:
        """How each entry of arrays() pads when per-segment plans for the
        same query are stacked (parallel/plan_exec.stack_plans). Kinds:
          "s"  scalar, stacked to [n_slots], never padded
          "z"  pad with 0 / False
          "o"  pad with 1 (divisors: avgdl, similarity params)
          "n"  pad with nan (value columns: nan compares False)
          "m1" pad with -1 (ordinal ids; -1 never matches a real ord)
          "d"  doc-id array: pad with the stacked sentinel doc (nd1-1,
               dead in live1) and re-point the segment's own sentinel
          "k"  kernel tables: stacked verbatim, shapes must agree
          "dense" a dense [nd1, ...] column: zero-filled to the stacked
               nd1 rows
          "x"  not stackable: the stacked mesh program cannot run the plan
        """
        return ["z"] * len(self.arrays())

    def flat_pad_kinds(self) -> List[str]:
        out = list(self.pad_kinds())
        for c in self.children():
            out.extend(c.flat_pad_kinds())
        return out

    def trace_statics(self) -> tuple:
        """Static (non-array) attributes ``emit`` reads from ``self``.
        Per-segment plans of one query stack onto one template only when
        these agree; array lengths may differ (they pad)."""
        return ()

    def describe(self) -> dict:
        """The profile tree: the node's type, its statics and its
        children. A plan runs as one pass over the segment, so only the
        root's breakdown carries measured time."""
        return {
            "type": type(self).__name__,
            "description": f"{type(self).__name__}{list(self.trace_statics())}",
            "children": [c.describe() for c in self.children()],
        }


def _on_device(x, device: torch.device):
    """Plan arrays arrive as numpy arrays, numpy scalars or tensors:
    arrays become tensors on the segment's device, scalars Python
    numbers."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, np.generic):
        return x.item()
    return x


class EmitCtx:
    """Carries the segment's device tensors + the flat plan-array iterator."""

    def __init__(self, seg_arrays: dict, plan_arrays: List):
        self.seg = seg_arrays
        self.device = seg_arrays["norms"].device
        self._arrays = plan_arrays
        self._pos = 0

    def take(self, n: int) -> List:
        out = self._arrays[self._pos: self._pos + n]
        self._pos += n
        return [_on_device(x, self.device) for x in out]

    @property
    def nd1(self) -> int:
        return self.seg["norms"].shape[1]

    def zeros_f(self):
        return torch.zeros(self.nd1, dtype=torch.float32, device=self.device)

    def zeros_b(self):
        return torch.zeros(self.nd1, dtype=torch.bool, device=self.device)

    def mark(self, flat_docs, cond):
        """matched[d] = any(cond over d's values) — the ``.at[].max``
        scatter of the JAX package, through an int32 count."""
        hits = torch.zeros(self.nd1, dtype=torch.int32, device=self.device)
        hits.index_add_(0, flat_docs.long(), cond.to(torch.int32))
        return hits > 0


def _where(mask, values, fill=0.0):
    if not isinstance(values, torch.Tensor):
        values = torch.full(mask.shape, float(values), dtype=torch.float32,
                            device=mask.device)
    return torch.where(mask, values, torch.full_like(values, fill))


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


class ScoreTermsNode(PlanNode):
    """Weighted disjunction of term posting blocks with per-lane similarity
    scoring (BM25 by default) and a minimum-distinct-match threshold, by
    scatter-add. Taken for lane sets the tile kernel does not serve: a
    zero weight, a similarity other than BM25, or BM25 with other
    constants than the default ``k1`` / ``b``.

    Each posting-block lane carries its similarity's host-folded constants
    (weight and p1..p3, see index/similarity.py) and the index of its kind
    in ``kinds`` (``q_kinds``); ``emit`` runs the formula of each distinct
    kind, so a plain BM25 query runs the BM25 arithmetic alone."""

    def __init__(self, q_blocks, q_weights, q_norm_rows, q_avgdl, q_valid,
                 min_match, k1: float = K1, b: float = B,
                 q_p1=None, q_p2=None, q_p3=None, q_kinds=None,
                 kinds: tuple = ("bm25",)):
        from elasticsearch_tpu_torch.index.similarity import (
            STRICTLY_POSITIVE_KINDS,
        )

        n = len(q_blocks)
        self.q_blocks = q_blocks
        self.q_weights = q_weights
        self.q_norm_rows = q_norm_rows
        self.q_avgdl = q_avgdl
        self.q_valid = q_valid
        self.min_match = np.float32(min_match)
        # default lane params reproduce classic BM25(k1, b)
        self.q_p1 = q_p1 if q_p1 is not None else np.full(n, k1, np.float32)
        self.q_p2 = q_p2 if q_p2 is not None else np.full(n, b, np.float32)
        self.q_p3 = q_p3 if q_p3 is not None else np.zeros(n, np.float32)
        self.q_kinds = (q_kinds if q_kinds is not None
                        else np.zeros(n, np.int32))
        self.kinds = tuple(kinds)
        # single-scatter fast path: "matched == score > 0" holds for a
        # plain disjunction with every live weight strictly positive and
        # every similarity in play strictly positive on a match
        self._fast = (
            bool(min_match <= 1)
            and bool((np.asarray(q_weights)[np.asarray(q_valid)] > 0).all())
            and all(k in STRICTLY_POSITIVE_KINDS for k in self.kinds))

    def arrays(self):
        return [self.q_blocks, self.q_weights, self.q_norm_rows, self.q_avgdl,
                self.q_valid, self.min_match, self.q_p1, self.q_p2, self.q_p3,
                self.q_kinds]

    def pad_kinds(self):
        return ["z", "z", "z", "o", "z", "s", "o", "o", "z", "z"]

    def trace_statics(self):
        return (self.kinds, self._fast)

    def emit(self, ctx):
        from elasticsearch_tpu_torch.index.similarity import emit_contrib

        (q_blocks, q_weights, q_norm_rows, q_avgdl, q_valid, min_match,
         q_p1, q_p2, q_p3, q_kinds) = ctx.take(10)
        q_blocks = q_blocks.long()
        docs = ctx.seg["block_docs"][q_blocks].long()
        tfs = ctx.seg["block_tfs"][q_blocks]
        norms = ctx.seg["norms"]
        nd1 = norms.shape[1]
        flat_idx = (q_norm_rows.long()[:, None] * nd1 + docs).reshape(-1)
        doc_len = norms.reshape(-1)[flat_idx].reshape(docs.shape)
        matched = (tfs > 0.0) & q_valid[:, None]
        w = q_weights[:, None]
        avgdl = q_avgdl[:, None]
        p1, p2, p3 = q_p1[:, None], q_p2[:, None], q_p3[:, None]
        if len(self.kinds) == 1:
            contrib = emit_contrib(self.kinds[0], tfs, doc_len, w, avgdl,
                                   p1, p2, p3)
        else:
            contrib = torch.zeros_like(tfs)
            for i, kind in enumerate(self.kinds):
                lane = (q_kinds == i)[:, None]
                val = emit_contrib(kind, tfs, doc_len, w, avgdl, p1, p2, p3)
                contrib = contrib + _where(lane, val)
        contrib = _where(matched, contrib)
        scores = ctx.zeros_f().index_add_(0, docs.reshape(-1),
                                          contrib.reshape(-1))
        if self._fast:
            return scores, scores > 0.0
        counts = ctx.zeros_f().index_add_(0, docs.reshape(-1),
                                          matched.reshape(-1).float())
        return scores, counts >= min_match


class PallasScoreTermsNode(PlanNode):
    """BM25 disjunction scored by the tile-scoring kernel
    (ops/tile_scoring.py) — the CUDA kernel on a GPU segment, its plain
    version on a CPU one. Chosen by score_terms_node when every lane is
    default-constant BM25 with a positive weight; carries the per-(tile,
    lane) covering-row tables built host-side (and, on the host rung, the
    lane list in ``_host_lanes``, which the micro-batcher unions).

    Mesh form: ``mesh_deferred`` builds the node with the segment's lane
    set but no tables; the mesh executor's ``harmonize_kernel_nodes``
    calls ``finalize_mesh`` with the geometry shared by every slot, so the
    stacked tables have one shape.

    ``codec``: the postings codec of the tables ``emit`` reads, the
    segment's own on the host rung and the executor's on the mesh
    ("packed" reads ``k_packed``, else ``k_docs`` / ``k_frac``)."""

    def __init__(self, row_lo, row_hi, kweights, min_match, *, cb: int,
                 sub: int, live_key: str = "k_live_t", codec: str = "raw"):
        self.row_lo = row_lo  # [n_tiles, t_pad] i32
        self.row_hi = row_hi
        self.kweights = kweights  # [1, t_pad] f32
        self.min_match = np.float32(min_match)
        self.cb = cb
        self.sub = sub
        self.t_pad = int(row_lo.shape[1])
        self.n_tiles = int(row_lo.shape[0])
        self.with_counts = min_match > 1
        # live-mask layout key in the segment device dict: the geometry
        # ladder stages per-sub variants for dense-term queries
        self.live_key = live_key
        self.codec = codec
        self._mesh_lanes = None
        self._mesh_bmin = None
        self._mesh_bmax = None

    @classmethod
    def mesh_deferred(cls, lanes, bmin, bmax, min_match, *,
                      codec: str = "raw") -> "PallasScoreTermsNode":
        """Node for the mesh plane with table building deferred: lanes are
        segment-local, but the table geometry (tile count, t_pad, cb, sub)
        must be uniform over the stacked segment set and is only known once
        every slot's plan exists. ``bmin``/``bmax`` are the segment's
        per-block doc ranges."""
        self = cls.__new__(cls)
        self.row_lo = self.row_hi = self.kweights = None
        self.min_match = np.float32(min_match)
        self.cb = self.sub = self.t_pad = self.n_tiles = None
        self.with_counts = min_match > 1
        self.live_key = "k_live_t"
        self.codec = codec
        self._mesh_lanes = list(lanes)
        self._mesh_bmin = bmin
        self._mesh_bmax = bmax
        return self

    def finalize_mesh(self, row_lo, row_hi, kweights, *, cb: int, sub: int,
                      live_key: str) -> None:
        self.row_lo = row_lo
        self.row_hi = row_hi
        self.kweights = kweights
        self.cb = cb
        self.sub = sub
        self.t_pad = int(row_lo.shape[1])
        self.n_tiles = int(row_lo.shape[0])
        self.live_key = live_key

    def trace_statics(self):
        return (self.cb, self.sub, self.t_pad, self.with_counts,
                self.live_key, self.codec)

    def arrays(self):
        if self.row_lo is None:
            # a mesh_deferred node escaped harmonization: callers treat
            # this as "no plan form"
            raise NotImplementedError(
                "mesh kernel node used before finalize_mesh")
        return [self.row_lo, self.row_hi, self.kweights, self.min_match]

    def pad_kinds(self):
        return ["k", "k", "k", "s"]

    def emit(self, ctx):
        from elasticsearch_tpu_torch.ops import tile_scoring as tsc

        row_lo, row_hi, kweights, min_match = ctx.take(4)
        if self.codec == "packed":
            corpus = (ctx.seg["k_packed"], None)
        else:
            corpus = (ctx.seg["k_docs"], ctx.seg["k_frac"])
        outs = tsc.score_tiles(
            corpus[0], corpus[1], ctx.seg[self.live_key],
            row_lo, row_hi, kweights,
            t_pad=self.t_pad, cb=self.cb, sub=self.sub,
            dense=True, with_counts=self.with_counts, codec=self.codec)
        nd = ctx.nd1 - 1
        tail = torch.zeros(1, dtype=torch.float32, device=ctx.device)
        scores = torch.cat([tsc.dense_to_flat(outs[0], self.sub)[:nd], tail])
        if self.with_counts:
            counts = torch.cat([tsc.dense_to_flat(outs[1], self.sub)[:nd],
                                tail])
            return scores, counts >= min_match
        return scores, scores > 0.0


class KnnScoreNode(PlanNode):
    """Dense-vector similarity scoring against a segment's staged
    embeddings: the host rung of the kNN plane ladder (the mesh_pallas rung
    runs kernel 3, ops/knn_scoring.py).

    score = (dot(x, q) * scale) * 0.5 + 0.5, with q pre-normalized for
    cosine and scale the staged inverse norm (none for dot_product). Every
    live doc carrying the field matches. The product is an f32
    ``torch.matmul`` (``knn_scoring.host_knn_scores``), as the JAX package
    leaves it to XLA: it sums in another order than the kernel, so the two
    rungs agree in ids and within ``1e-6 + 1e-6 * sum_j |x_j * q_j|``, not
    bit for bit.

    The embeddings are segment-local device state (the ``ctx.seg`` keys
    of ``Segment.ensure_vector_staged``), not plan arrays, so the node
    cannot stack onto a mesh template (pad kind "x"): the generic mesh
    program mismatches cleanly and the kNN rung of the mesh plane
    (``IndexMeshSearch.query_knn``) owns the distributed form."""

    def __init__(self, field: str, qvec, metric: str, boost: float,
                 emb_key: str, norm_key: str, exists_key: str):
        self.field = field
        self.qvec = qvec  # [1, d_pad] f32 (normalize_query row)
        self.metric = metric
        self.boost = np.float32(boost)
        self.emb_key = emb_key
        self.norm_key = norm_key
        self.exists_key = exists_key

    def trace_statics(self):
        return (self.field, self.metric, self.emb_key)

    def arrays(self):
        return [self.qvec, self.boost]

    def pad_kinds(self):
        return ["x", "s"]

    def emit(self, ctx):
        from elasticsearch_tpu_torch.ops.knn_scoring import host_knn_scores

        qvec, boost = ctx.take(2)
        s = host_knn_scores(ctx.seg[self.emb_key], qvec)
        if self.metric == "cosine":
            s = s * ctx.seg[self.norm_key]
        s = s * 0.5 + 0.5
        scores = torch.cat([s, torch.zeros(1, dtype=torch.float32,
                                           device=ctx.device)])
        matched = ctx.seg[self.exists_key]
        return _where(matched, scores * boost), matched


class PhraseScoreNode(PlanNode):
    """Phrase matches verified on the host (position intersection) and
    scored by the field's similarity over the phrase frequency: the
    ``match_phrase`` semantics. ``docs`` / ``freqs`` are [K]-padded (doc =
    the segment's sentinel, freq = 0)."""

    def __init__(self, docs, freqs, weight, norm_row, avgdl,
                 k1: float = K1, b: float = B, kind: str = "bm25",
                 p1=None, p2=None, p3=0.0):
        self.docs = docs
        self.freqs = freqs
        self.weight = np.float32(weight)
        self.norm_row = int(norm_row)
        self.avgdl = np.float32(avgdl)
        self.kind = kind
        # default params reproduce classic BM25(k1, b)
        self.p1 = np.float32(k1 if p1 is None else p1)
        self.p2 = np.float32(b if p2 is None else p2)
        self.p3 = np.float32(p3)

    def trace_statics(self):
        return (self.norm_row, self.kind)

    def arrays(self):
        return [self.docs, self.freqs, self.weight, self.avgdl,
                self.p1, self.p2, self.p3]

    def pad_kinds(self):
        return ["d", "z", "s", "s", "s", "s", "s"]

    def emit(self, ctx):
        from elasticsearch_tpu_torch.index.similarity import emit_contrib

        docs, freqs, *scalars = ctx.take(7)
        # the per-phrase constants as f32 scalars, as the JAX node's
        weight, avgdl, p1, p2, p3 = (
            torch.as_tensor(x, dtype=torch.float32, device=ctx.device)
            for x in scalars)
        docs = docs.long()
        doc_len = ctx.seg["norms"][self.norm_row][docs]
        matched_v = freqs > 0
        contrib = _where(matched_v, emit_contrib(
            self.kind, freqs, doc_len, weight, avgdl, p1, p2, p3))
        scores = ctx.zeros_f().index_add_(0, docs, contrib)
        return scores, ctx.mark(docs, matched_v)


class MatchAllNode(PlanNode):
    def __init__(self, boost: float = 1.0):
        self.boost = np.float32(boost)

    def arrays(self):
        return [self.boost]

    def pad_kinds(self):
        return ["s"]

    def emit(self, ctx):
        (boost,) = ctx.take(1)
        matched = ctx.seg["live1"]
        return _where(matched, boost), matched


class MatchNoneNode(PlanNode):

    def emit(self, ctx):
        return ctx.zeros_f(), ctx.zeros_b()


class NumericRangeNode(PlanNode):
    def __init__(self, flat_docs, flat_values, lo: float, hi: float):
        self.flat_docs = flat_docs
        self.flat_values = flat_values
        self.lo = np.float64(lo)
        self.hi = np.float64(hi)

    def arrays(self):
        return [self.flat_docs, self.flat_values, self.lo, self.hi]

    def pad_kinds(self):
        return ["d", "n", "s", "s"]

    def emit(self, ctx):
        flat_docs, flat_values, lo, hi = ctx.take(4)
        cond = (flat_values >= lo) & (flat_values <= hi)
        return ctx.zeros_f(), ctx.mark(flat_docs, cond)


class NumericTermsNode(PlanNode):
    def __init__(self, flat_docs, flat_values, values):
        self.flat_docs = flat_docs
        self.flat_values = flat_values
        self.values = values  # [K] f64 padded with nan

    def arrays(self):
        return [self.flat_docs, self.flat_values, self.values]

    def pad_kinds(self):
        return ["d", "n", "n"]

    def emit(self, ctx):
        flat_docs, flat_values, values = ctx.take(3)
        cond = (flat_values[:, None] == values[None, :]).any(dim=1)
        return ctx.zeros_f(), ctx.mark(flat_docs, cond)


class OrdTermsNode(PlanNode):
    def __init__(self, flat_docs, flat_ords, ords):
        self.flat_docs = flat_docs
        self.flat_ords = flat_ords
        self.ords = ords  # [K] int32 padded with -1

    def arrays(self):
        return [self.flat_docs, self.flat_ords, self.ords]

    def pad_kinds(self):
        return ["d", "m1", "m1"]

    def emit(self, ctx):
        flat_docs, flat_ords, ords = ctx.take(3)
        cond = (flat_ords[:, None] == ords[None, :]).any(dim=1)
        return ctx.zeros_f(), ctx.mark(flat_docs, cond)


class OrdRangeNode(PlanNode):
    def __init__(self, flat_docs, flat_ords, lo_ord: int, hi_ord: int):
        self.flat_docs = flat_docs
        self.flat_ords = flat_ords
        self.lo_ord = np.int32(lo_ord)
        self.hi_ord = np.int32(hi_ord)

    def arrays(self):
        return [self.flat_docs, self.flat_ords, self.lo_ord, self.hi_ord]

    def pad_kinds(self):
        return ["d", "m1", "s", "s"]

    def emit(self, ctx):
        flat_docs, flat_ords, lo, hi = ctx.take(4)
        cond = (flat_ords >= lo) & (flat_ords < hi)
        return ctx.zeros_f(), ctx.mark(flat_docs, cond)


class OrdSetNode(PlanNode):
    """Docs holding an ordinal of a set given as a per-ordinal bool table
    (the ip term and range queries: the set is any subset of a
    vocabulary sorted as strings, so no ordinal range holds it)."""

    def __init__(self, flat_docs, flat_ords, table):
        self.flat_docs = flat_docs
        self.flat_ords = flat_ords
        self.table = table  # [n_ords_pad] bool, padded with False

    def arrays(self):
        return [self.flat_docs, self.flat_ords, self.table]

    def pad_kinds(self):
        return ["d", "m1", "z"]

    def emit(self, ctx):
        flat_docs, flat_ords, table = ctx.take(3)
        cond = table[flat_ords.clamp(min=0).long()] & (flat_ords >= 0)
        return ctx.zeros_f(), ctx.mark(flat_docs, cond)


class RangePairNode(PlanNode):
    """A query on a range field: each value is an inclusive (lo, hi) pair
    in the aligned ``#lo`` / ``#hi`` columns, and the relation picks the
    test against the query interval [q_lo, q_hi] (float64)."""

    def __init__(self, flat_docs, lo_vals, hi_vals, q_lo: float, q_hi: float,
                 relation: str = "intersects"):
        self.flat_docs = flat_docs
        self.lo_vals = lo_vals
        self.hi_vals = hi_vals
        self.q_lo = np.float64(q_lo)
        self.q_hi = np.float64(q_hi)
        self.relation = relation

    def trace_statics(self):
        return (self.relation,)

    def arrays(self):
        return [self.flat_docs, self.lo_vals, self.hi_vals, self.q_lo,
                self.q_hi]

    def pad_kinds(self):
        return ["d", "n", "n", "s", "s"]

    def emit(self, ctx):
        flat_docs, lo_vals, hi_vals, q_lo, q_hi = ctx.take(5)
        if self.relation == "within":
            cond = (lo_vals >= q_lo) & (hi_vals <= q_hi)
        elif self.relation == "contains":
            cond = (lo_vals <= q_lo) & (hi_vals >= q_hi)
        else:  # intersects
            cond = (lo_vals <= q_hi) & (hi_vals >= q_lo)
        return ctx.zeros_f(), ctx.mark(flat_docs, cond)


EARTH_RADIUS_M = 6371008.8
_DEG_TO_RAD = np.float32(np.pi / 180)


def haversine_distance_m(lat1, lon1, lat2, lon2):
    """Great-circle distance in meters, float32 throughout, in the JAX
    package's order of operations (``ops/masks.py``): radians as a
    multiply by f32(pi / 180), then the haversine with the 6371008.8 m
    radius."""
    rl1, rl2 = lat1 * _DEG_TO_RAD, lat2 * _DEG_TO_RAD
    dlat = rl2 - rl1
    dlon = (lon2 - lon1) * _DEG_TO_RAD
    s_lat = torch.sin(dlat / 2)
    s_lon = torch.sin(dlon / 2)
    a = s_lat * s_lat + torch.cos(rl1) * torch.cos(rl2) * (s_lon * s_lon)
    return 2 * EARTH_RADIUS_M * torch.asin(torch.sqrt(a))


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class GeoDistanceNode(PlanNode):
    """Docs with a point within ``radius_m`` of the center (float32)."""

    def __init__(self, flat_docs, lat, lon, center_lat, center_lon, radius_m):
        self.flat_docs = flat_docs
        self.lat = lat
        self.lon = lon
        self.center_lat = np.float32(center_lat)
        self.center_lon = np.float32(center_lon)
        self.radius_m = np.float32(radius_m)

    def arrays(self):
        return [self.flat_docs, self.lat, self.lon, self.center_lat,
                self.center_lon, self.radius_m]

    def pad_kinds(self):
        return ["d", "z", "z", "s", "s", "s"]

    def emit(self, ctx):
        flat_docs, lat, lon, clat, clon, radius = ctx.take(6)
        d = haversine_distance_m(lat, lon, _f32(clat, ctx.device),
                                 _f32(clon, ctx.device))
        return ctx.zeros_f(), ctx.mark(flat_docs,
                                       d <= _f32(radius, ctx.device))


class GeoBoxNode(PlanNode):
    """Docs with a point inside the box [top, left, bottom, right]
    (float32; a box whose left lies east of its right crosses the
    antimeridian)."""

    def __init__(self, flat_docs, lat, lon, top, left, bottom, right):
        self.flat_docs = flat_docs
        self.lat = lat
        self.lon = lon
        self.box = np.asarray([top, left, bottom, right], dtype=np.float32)

    def arrays(self):
        return [self.flat_docs, self.lat, self.lon, self.box]

    def pad_kinds(self):
        return ["d", "z", "z", "z"]

    def emit(self, ctx):
        flat_docs, lat, lon, box = ctx.take(4)
        top, left, bottom, right = box[0], box[1], box[2], box[3]
        in_lat = (lat <= top) & (lat >= bottom)
        crosses = left > right
        in_lon = torch.where(crosses, (lon >= left) | (lon <= right),
                             (lon >= left) & (lon <= right))
        return ctx.zeros_f(), ctx.mark(flat_docs, in_lat & in_lon)


class DenseMaskNode(PlanNode):
    """A precomputed [nd1] bool mask (the exists, ids and geo_polygon
    queries)."""

    def __init__(self, mask, label: str = "mask"):
        self.mask = mask
        self.label = label

    def arrays(self):
        return [self.mask]

    def pad_kinds(self):
        return ["dense"]

    def emit(self, ctx):
        (mask,) = ctx.take(1)
        return ctx.zeros_f(), mask


class DenseScoreNode(PlanNode):
    """Precomputed dense [nd1] f32 scores and bool mask: a nested clause's
    objects or a join clause's other side, folded onto this segment's
    docs on the host."""

    def __init__(self, scores, mask, label: str = "join"):
        self.scores = scores
        self.mask = mask
        self.label = label

    def arrays(self):
        return [self.scores, self.mask]

    def pad_kinds(self):
        return ["dense", "dense"]

    def emit(self, ctx):
        scores, mask = ctx.take(2)
        return _where(mask, scores.to(torch.float32)), mask


# ---------------------------------------------------------------------------
# Combiners
# ---------------------------------------------------------------------------


class BoolNode(PlanNode):
    """BooleanQuery semantics: score = sum of matching scoring clauses;
    filters gate without scoring; should needs ``min_should_match``."""

    def __init__(self, must: List[PlanNode], filter_: List[PlanNode],
                 should: List[PlanNode], must_not: List[PlanNode],
                 min_should_match: int, boost: float = 1.0):
        self.must = must
        self.filter = filter_
        self.should = should
        self.must_not = must_not
        self.msm = np.float32(min_should_match)
        self.boost = np.float32(boost)

    def children(self):
        return self.must + self.filter + self.should + self.must_not

    def arrays(self):
        return [self.msm, self.boost]

    def pad_kinds(self):
        return ["s", "s"]

    def emit(self, ctx):
        msm, boost = ctx.take(2)
        matched = ctx.seg["live1"]
        scores = ctx.zeros_f()
        for c in self.must:
            s, m = c.emit(ctx)
            scores = scores + s
            matched = matched & m
        for c in self.filter:
            _, m = c.emit(ctx)
            matched = matched & m
        if self.should:
            s_count = ctx.zeros_f()
            for c in self.should:
                s, m = c.emit(ctx)
                scores = scores + _where(m, s)
                s_count = s_count + m.float()
            matched = matched & (s_count >= msm)
        for c in self.must_not:
            _, m = c.emit(ctx)
            matched = matched & ~m
        return _where(matched, scores * boost), matched


class ConstantScoreNode(PlanNode):
    def __init__(self, child: PlanNode, boost: float = 1.0):
        self.child = child
        self.boost = np.float32(boost)

    def children(self):
        return [self.child]

    def arrays(self):
        return [self.boost]

    def pad_kinds(self):
        return ["s"]

    def emit(self, ctx):
        (boost,) = ctx.take(1)
        _, m = self.child.emit(ctx)
        return _where(m, boost), m


class BoostNode(PlanNode):
    def __init__(self, child: PlanNode, boost: float):
        self.child = child
        self.boost = np.float32(boost)

    def children(self):
        return [self.child]

    def arrays(self):
        return [self.boost]

    def pad_kinds(self):
        return ["s"]

    def emit(self, ctx):
        (boost,) = ctx.take(1)
        s, m = self.child.emit(ctx)
        return s * boost, m


class DisMaxNode(PlanNode):
    """dis_max: the best child score plus ``tie_breaker`` times the sum of
    the others; matched when any child matched."""

    def __init__(self, nodes: List[PlanNode], tie_breaker: float = 0.0):
        self.nodes = nodes
        self.tie_breaker = np.float32(tie_breaker)

    def children(self):
        return self.nodes

    def arrays(self):
        return [self.tie_breaker]

    def pad_kinds(self):
        return ["s"]

    def emit(self, ctx):
        (tie,) = ctx.take(1)
        best = None
        total = ctx.zeros_f()
        matched = ctx.zeros_b()
        for c in self.nodes:
            s, m = c.emit(ctx)
            s = _where(m, s)
            best = s if best is None else torch.maximum(best, s)
            total = total + s
            matched = matched | m
        tie = torch.as_tensor(tie, dtype=torch.float32, device=ctx.device)
        return best + tie * (total - best), matched


class FunctionScoreNode(PlanNode):
    """function_score: the child's score combined with a function value,
    ``weight`` times each factor column in turn ([nd1] f32 columns:
    field_value_factor, random_score), by ``boost_mode``."""

    MODES = ("multiply", "replace", "sum", "avg", "max", "min")

    def __init__(self, child: PlanNode, factor_columns: List, weight: float,
                 boost_mode: str = "multiply"):
        self.child = child
        self.factor_columns = factor_columns
        self.weight = np.float32(weight)
        self.boost_mode = boost_mode

    def trace_statics(self):
        return (self.boost_mode,)

    def children(self):
        return [self.child]

    def arrays(self):
        return [self.weight] + list(self.factor_columns)

    def pad_kinds(self):
        return ["s"] + ["dense"] * len(self.factor_columns)

    def emit(self, ctx):
        taken = ctx.take(1 + len(self.factor_columns))
        weight, cols = taken[0], taken[1:]
        s, m = self.child.emit(ctx)
        fn = torch.full_like(s, 1.0) * torch.as_tensor(
            weight, dtype=torch.float32, device=ctx.device)
        for col in cols:
            fn = fn * col
        if self.boost_mode == "multiply":
            out = s * fn
        elif self.boost_mode == "replace":
            out = fn
        elif self.boost_mode == "sum":
            out = s + fn
        elif self.boost_mode == "avg":
            out = (s + fn) / 2.0
        elif self.boost_mode == "max":
            out = torch.maximum(s, fn)
        else:
            out = torch.minimum(s, fn)
        return _where(m, out), m


# ---------------------------------------------------------------------------
# Run
# ---------------------------------------------------------------------------


def execute(seg_device: dict, plan: PlanNode, plan_arrays=None):
    """Run a plan against one segment's device tensors (block_docs,
    block_tfs, norms, live1, kernel tables). ``plan_arrays`` replaces the
    plan's own flat arrays (one slot of a stacked mesh plan). Returns
    (scores f32[nd1], matched bool[nd1]) on the segment's device."""
    ctx = EmitCtx(seg_device, plan.flat_arrays() if plan_arrays is None
                  else plan_arrays)
    scores, matched = plan.emit(ctx)
    return scores, matched & ctx.seg["live1"]
