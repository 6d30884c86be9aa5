"""BM25 scoring over block-packed postings, on tensors.

Counterpart of ``elasticsearch_tpu/ops/scoring.py``. The dense score
accumulator is ``[nd_pad + 1]`` with the sentinel slot last, so
disjunctions, conjunction counting and filter masking are vector ops.
Everything here runs on whatever device its tensors live on.

``top_k`` (also the tile merges' and the mesh plane's top-k) orders by
score descending, then index ascending, because ``torch.topk`` promises no
order among ties and the JAX package's ``lax.top_k`` returns the lower
index first.
"""

from __future__ import annotations

import math

import torch

# Lucene 7 BM25 defaults (index/similarity/SimilarityService.java — BM25 default)
K1 = 1.2
B = 0.75


def bm25_idf(doc_freq, doc_count):
    """Lucene BM25Similarity.idfExplain: ln(1 + (N - df + 0.5)/(df + 0.5))."""
    return math.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))


def score_term_blocks(block_docs, block_tfs, norms, q_blocks, q_weights,
                      q_norm_rows, q_avgdl, q_valid, k1: float = K1,
                      b: float = B):
    """Score a weighted disjunction of terms; also count distinct matched
    terms per doc. Returns (scores [nd1] f32, match_counts [nd1] f32);
    nd1 = nd_pad + 1, the last slot collecting all padding writes."""
    docs = block_docs[q_blocks].long()
    tfs = block_tfs[q_blocks]
    nd1 = norms.shape[1]
    flat_idx = (q_norm_rows.long()[:, None] * nd1 + docs).reshape(-1)
    doc_len = norms.reshape(-1)[flat_idx].reshape(docs.shape)
    denom = tfs + k1 * (1.0 - b + b * doc_len / q_avgdl[:, None])
    contrib = q_weights[:, None] * tfs * (k1 + 1.0) / denom
    matched = (tfs > 0.0) & q_valid[:, None]
    contrib = torch.where(matched, contrib, torch.zeros_like(contrib))
    scores = torch.zeros(nd1, dtype=torch.float32, device=norms.device)
    scores.index_add_(0, docs.reshape(-1), contrib.reshape(-1))
    counts = torch.zeros(nd1, dtype=torch.float32, device=norms.device)
    counts.index_add_(0, docs.reshape(-1), matched.reshape(-1).float())
    return scores, counts


def combine_should(scores_list, matched_list, min_should_match):
    """Sum scores of matching 'should' clauses; matched when at least
    min_should_match clauses matched (BooleanQuery semantics)."""
    total = torch.zeros_like(scores_list[0])
    count = torch.zeros_like(scores_list[0])
    for s, m in zip(scores_list, matched_list):
        total = total + torch.where(m, s, torch.zeros_like(s))
        count = count + m.float()
    return total, count >= min_should_match


def top_k(values, k: int):
    """The ``k`` largest entries along the last axis of a float32 tensor
    and their indices, ties to the lower index (the order of
    ``lax.top_k``; -0.0 ties +0.0 here, where ``lax.top_k`` ranks +0.0
    first). Returns (values [..., k'], indices [..., k'] int64), k' =
    min(k, n), n < 2^32.

    One ``torch.topk`` over a two-key int64 composite selects and orders
    them: the value's bits mapped to an order-preserving int32 (after
    ``+ 0.0``, so -0.0 ties +0.0) in the high half, the index reversed in
    the low half. However many entries tie at the k-th value (a keyword
    or a count sort ties most of a slot), no second pass runs and nothing
    waits on the host.

    A NaN ranks below every number and comes back as -inf, so a caller
    that stops at -inf never returns it: the IB similarity's SPL formula
    gives NaN when its lambda exceeds 1, and the JAX package's top-k on
    the CPU ranks that NaN last too."""
    if values.dtype != torch.float32:
        raise TypeError(f"top_k ranks float32 values, got {values.dtype}")
    values = torch.where(torch.isnan(values),
                         torch.full_like(values, float("-inf")), values)
    n = values.shape[-1]
    k = min(int(k), n)
    bits = (values + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=values.device)
    top = torch.topk(ordered * (1 << 32) + rev, k, dim=-1, sorted=True).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(values, -1, idx), idx


def select_topk(scores, matched, live1, k: int):
    """Mask out non-matching/deleted docs and take the top-k by score,
    ties by ascending doc id (Lucene's collector order).

    Returns (top_scores [k'], top_docs [k'] int64), k' = min(k, n);
    non-matching slots have score = -inf."""
    masked = torch.where(matched & live1, scores,
                         torch.full_like(scores, float("-inf")))
    return top_k(masked, k)


def count_matches(matched, live1):
    return int((matched & live1).sum())
