"""Query execution plans: a query tree run eagerly on one segment's tensors.

Counterpart of ``elasticsearch_tpu/search/plan.py``. The JAX package traces
the tree once into one jitted XLA program; PyTorch runs eagerly, so
``execute`` simply walks the tree. Every node emits ``(scores f32[nd1],
matched bool[nd1])`` with ``nd1 = nd_pad + 1``, the trailing slot a
sentinel that collects padding writes.

Nodes ported: ScoreTermsNode (scatter scoring), PallasScoreTermsNode (the
tile-scoring kernel; the name is kept so the counterpart is easy to find),
MatchAllNode, MatchNoneNode, NumericRangeNode, NumericTermsNode,
OrdTermsNode, OrdRangeNode, BoolNode, ConstantScoreNode, BoostNode.
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
    """Weighted disjunction of term posting blocks with per-lane BM25
    scoring and a minimum-distinct-match threshold, by scatter-add. Taken
    for lane sets the tile kernel does not serve (a zero weight)."""

    def __init__(self, q_blocks, q_weights, q_norm_rows, q_avgdl, q_valid,
                 min_match, k1: float = K1, b: float = B,
                 q_p1=None, q_p2=None):
        n = len(q_blocks)
        self.q_blocks = q_blocks
        self.q_weights = q_weights
        self.q_norm_rows = q_norm_rows
        self.q_avgdl = q_avgdl
        self.q_valid = q_valid
        self.min_match = np.float32(min_match)
        self.q_p1 = q_p1 if q_p1 is not None else np.full(n, k1, np.float32)
        self.q_p2 = q_p2 if q_p2 is not None else np.full(n, b, np.float32)
        # single-scatter fast path: "matched == score > 0" holds for a
        # plain disjunction with every live weight strictly positive
        self._fast = (
            bool(min_match <= 1)
            and bool((np.asarray(q_weights)[np.asarray(q_valid)] > 0).all()))

    def arrays(self):
        return [self.q_blocks, self.q_weights, self.q_norm_rows, self.q_avgdl,
                self.q_valid, self.min_match, self.q_p1, self.q_p2]

    def emit(self, ctx):
        from elasticsearch_tpu_torch.index.similarity import emit_contrib

        (q_blocks, q_weights, q_norm_rows, q_avgdl, q_valid, min_match,
         q_p1, q_p2) = ctx.take(8)
        q_blocks = q_blocks.long()
        docs = ctx.seg["block_docs"][q_blocks].long()
        tfs = ctx.seg["block_tfs"][q_blocks]
        norms = ctx.seg["norms"]
        nd1 = norms.shape[1]
        flat_idx = (q_norm_rows.long()[:, None] * nd1 + docs).reshape(-1)
        doc_len = norms.reshape(-1)[flat_idx].reshape(docs.shape)
        matched = (tfs > 0.0) & q_valid[:, None]
        contrib = emit_contrib("bm25", tfs, doc_len, q_weights[:, None],
                               q_avgdl[:, None], q_p1[:, None], q_p2[:, None])
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
    lane) covering-row tables built host-side."""

    def __init__(self, row_lo, row_hi, kweights, min_match, *, cb: int,
                 sub: int, live_key: str = "k_live_t"):
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

    def arrays(self):
        return [self.row_lo, self.row_hi, self.kweights, self.min_match]

    def emit(self, ctx):
        from elasticsearch_tpu_torch.ops import tile_scoring as tsc

        row_lo, row_hi, kweights, min_match = ctx.take(4)
        outs = tsc.score_tiles(
            ctx.seg["k_docs"], ctx.seg["k_frac"], ctx.seg[self.live_key],
            row_lo, row_hi, kweights,
            t_pad=self.t_pad, cb=self.cb, sub=self.sub,
            dense=True, with_counts=self.with_counts)
        nd = ctx.nd1 - 1
        tail = torch.zeros(1, dtype=torch.float32, device=ctx.device)
        scores = torch.cat([tsc.dense_to_flat(outs[0], self.sub)[:nd], tail])
        if self.with_counts:
            counts = torch.cat([tsc.dense_to_flat(outs[1], self.sub)[:nd],
                                tail])
            return scores, counts >= min_match
        return scores, scores > 0.0


class MatchAllNode(PlanNode):
    def __init__(self, boost: float = 1.0):
        self.boost = np.float32(boost)

    def arrays(self):
        return [self.boost]

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

    def emit(self, ctx):
        flat_docs, flat_ords, lo, hi = ctx.take(4)
        cond = (flat_ords >= lo) & (flat_ords < hi)
        return ctx.zeros_f(), ctx.mark(flat_docs, cond)


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

    def emit(self, ctx):
        (boost,) = ctx.take(1)
        s, m = self.child.emit(ctx)
        return s * boost, m


# ---------------------------------------------------------------------------
# Run
# ---------------------------------------------------------------------------


def execute(seg_device: dict, plan: PlanNode):
    """Run a plan against one segment's device tensors (block_docs,
    block_tfs, norms, live1, kernel tables). Returns (scores f32[nd1],
    matched bool[nd1]) on the segment's device."""
    ctx = EmitCtx(seg_device, plan.flat_arrays())
    scores, matched = plan.emit(ctx)
    return scores, matched & ctx.seg["live1"]
