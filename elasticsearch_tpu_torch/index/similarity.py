"""Per-field similarities: BM25, the default.

Counterpart of ``elasticsearch_tpu/index/similarity.py``, cut to the
default BM25 lane parameters. A similarity folds per-term corpus
statistics into lane constants host-side (``lane_params``); the
contribution formula over ``(tf, doc_len)`` runs on tensors
(``emit_contrib``) for the scatter ``ScoreTermsNode``. The other
similarities (classic, boolean, DFR, IB, LM) are a later slice: naming one
raises the JAX package's "Unknown Similarity" error.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException


class Similarity:
    """Base: ``lane_params(stats)`` -> (kind, weight, p1, p2, p3)."""

    name = "base"
    needs_ttf = False

    def lane_params(self, stats: dict) -> Tuple[str, float, float, float, float]:
        raise NotImplementedError


class BM25Similarity(Similarity):
    name = "BM25"

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = float(k1)
        self.b = float(b)

    def idf(self, df: int, n: int) -> float:
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def lane_params(self, stats):
        w = stats["boost"] * self.idf(stats["df"], stats["doc_count"])
        return ("bm25", w, self.k1, self.b, 0.0)


def emit_contrib(kind: str, tf, dl, w, avgdl, p1, p2):
    """Per-lane score contribution (>= 0 for matching postings; callers
    mask tf == 0 lanes out). All arguments are broadcastable tensors."""
    if kind == "bm25":
        # p1 = k1, p2 = b
        return w * tf * (p1 + 1.0) / (tf + p1 * (1.0 - p2 + p2 * dl / avgdl))
    raise IllegalArgumentException(f"unknown similarity kind [{kind}]")


class SimilarityService:
    """Resolves similarity names for an index: BM25 is the default and the
    only built-in ported so far. ``index.similarity.*`` settings (custom
    similarities) are a later slice and raise."""

    def __init__(self, settings=None):
        if settings is not None:
            custom = [k for k in settings.keys()
                      if k.startswith("index.similarity.")]
            if custom:
                raise IllegalArgumentException(
                    f"custom similarity settings {sorted(custom)} are not "
                    f"supported by the PyTorch port yet")
        self._sims: Dict[str, Similarity] = {"BM25": BM25Similarity()}
        self.default: Similarity = self._sims["BM25"]

    def get(self, name: Optional[str]) -> Similarity:
        if name is None:
            return self.default
        sim = self._sims.get(name)
        if sim is None:
            raise IllegalArgumentException(f"Unknown Similarity [{name}]")
        return sim
