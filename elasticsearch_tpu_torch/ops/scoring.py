"""BM25 scoring over block-packed postings, on tensors.

Counterpart of ``elasticsearch_tpu/ops/scoring.py``. The dense score
accumulator is ``[nd_pad + 1]`` with the sentinel slot last, so
disjunctions, conjunction counting and filter masking are vector ops.
Everything here runs on whatever device its tensors live on.

``select_topk`` sorts explicitly — score descending, then doc id
ascending — because ``torch.topk`` promises no order among ties and the
JAX package's ``lax.top_k`` returns the lower index first.
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


def select_topk(scores, matched, live1, k: int):
    """Mask out non-matching/deleted docs and take the top-k by score,
    ties by ascending doc id (Lucene's collector order).

    Returns (top_scores [k'], top_docs [k'] int64), k' = min(k, n);
    non-matching slots have score = -inf."""
    masked = torch.where(matched & live1, scores,
                         torch.full_like(scores, float("-inf")))
    k = min(int(k), masked.shape[0])
    if k <= 0:
        return masked[:0], torch.zeros(0, dtype=torch.int64,
                                       device=masked.device)
    kth = torch.topk(masked, k, sorted=True).values[-1]
    cand = torch.nonzero(masked >= kth).squeeze(1)  # ascending doc ids
    order = torch.sort(masked[cand], descending=True, stable=True).indices
    top_docs = cand[order[:k]]
    return masked[top_docs], top_docs


def count_matches(matched, live1):
    return int((matched & live1).sum())
