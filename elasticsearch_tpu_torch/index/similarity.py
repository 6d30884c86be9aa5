"""Per-field similarities (scoring models).

Counterpart of ``elasticsearch_tpu/index/similarity.py``: BM25 is the
default; classic TF-IDF, boolean, DFR, IB, LM-Dirichlet and
LM-Jelinek-Mercer are configurable alternatives. Custom similarities are
declared in index settings (``index.similarity.<name>.type`` and the
model's parameters) and bound to fields by the mapping's ``similarity``
parameter; ``index.similarity.default.type`` replaces the index default.

A similarity is split in two:
  * host-side constant folding (``lane_params``): everything that depends
    only on corpus statistics (df, ttf, N, sum_ttf, avgdl) becomes at most
    three scalars a posting-block lane, and
  * a contribution formula over ``(tf, doc_len)`` on tensors
    (``emit_contrib``), chosen by the similarity's *kind* string.

Formulas follow Lucene 7 (``BM25Similarity``, ``ClassicSimilarity``,
``BooleanSimilarity`` and the ``SimilarityBase`` subclasses). Like
Lucene's ``SimilarityBase``, the LM, DFR and IB scores are clamped at
zero, so a matching doc never scores below zero.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

LOG2 = math.log(2.0)


def _log2(x: float) -> float:
    return math.log(x) / LOG2


def _maximum(x, floor: float):
    """Elementwise max against a scalar floor."""
    return torch.clamp(x, min=floor)


class Similarity:
    """Base: a similarity folds per-term stats into lane constants.

    ``lane_params(stats)`` -> (kind, weight, p1, p2, p3) where stats is a
    dict with df, ttf, doc_count (N), sum_ttf (T), avgdl, boost.
    ``kind`` is a string naming the contribution formula.
    """

    name = "base"
    # whether lane_params reads stats["ttf"] — computing total term
    # frequency costs an O(postings) host pass, skipped when unused
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


class ClassicSimilarity(Similarity):
    """Lucene ClassicSimilarity: sqrt(tf) * idf^2 * 1/sqrt(dl)."""

    name = "classic"

    def lane_params(self, stats):
        idf = 1.0 + math.log((stats["doc_count"] + 1.0) / (stats["df"] + 1.0))
        return ("classic", stats["boost"] * idf * idf, 0.0, 0.0, 0.0)


class BooleanSimilarity(Similarity):
    name = "boolean"

    def lane_params(self, stats):
        return ("boolean", stats["boost"], 0.0, 0.0, 0.0)


class LMDirichletSimilarity(Similarity):
    name = "LMDirichlet"
    needs_ttf = True

    def __init__(self, mu: float = 2000.0):
        self.mu = float(mu)

    def lane_params(self, stats):
        # DefaultCollectionModel: p(t|C) = (F + 1) / (T + 1)
        pc = (stats["ttf"] + 1.0) / (stats["sum_ttf"] + 1.0)
        return ("lm_dirichlet", stats["boost"], self.mu, pc, 0.0)


class LMJelinekMercerSimilarity(Similarity):
    name = "LMJelinekMercer"
    needs_ttf = True

    def __init__(self, lam: float = 0.1):
        if not 0.0 < lam <= 1.0:
            raise IllegalArgumentException("lambda must be in (0, 1]")
        self.lam = float(lam)

    def lane_params(self, stats):
        pc = (stats["ttf"] + 1.0) / (stats["sum_ttf"] + 1.0)
        return ("lm_jm", stats["boost"], self.lam, pc, 0.0)


class DFRSimilarity(Similarity):
    """Divergence-from-randomness: basic_model x after_effect x
    normalization (reference: DFRSimilarityProvider.java)."""

    name = "DFR"
    needs_ttf = True
    BASIC_MODELS = ("g", "if", "in", "ine")
    AFTER_EFFECTS = ("no", "b", "l")
    NORMALIZATIONS = ("no", "h1", "h2", "z")

    def __init__(self, basic_model: str = "g", after_effect: str = "l",
                 normalization: str = "h2", c: float = 1.0, z: float = 0.30):
        basic_model = basic_model.lower()
        after_effect = after_effect.lower()
        normalization = normalization.lower()
        if basic_model not in self.BASIC_MODELS:
            raise IllegalArgumentException(
                f"Unsupported BasicModel [{basic_model}]")
        if after_effect not in self.AFTER_EFFECTS:
            raise IllegalArgumentException(
                f"Unsupported AfterEffect [{after_effect}]")
        if normalization not in self.NORMALIZATIONS:
            raise IllegalArgumentException(
                f"Unsupported Normalization [{normalization}]")
        self.basic_model = basic_model
        self.after_effect = after_effect
        self.normalization = normalization
        self.c = float(c)
        self.z = float(z)

    def lane_params(self, stats):
        n, df, f = stats["doc_count"], stats["df"], stats["ttf"]
        # fold the per-term basic-model constants host-side
        if self.basic_model == "g":
            lam = f / (n + f) if (n + f) > 0 else 0.5
            p2 = _log2(1.0 + lam)              # additive part
            p3 = _log2((1.0 + lam) / max(lam, 1e-12))  # per-tfn slope
        elif self.basic_model == "if":
            # BasicModelIF: tfn * log2(1 + (N+1)/(F+0.5))
            p2 = 0.0
            p3 = _log2(1.0 + (n + 1.0) / (f + 0.5))
        else:
            if self.basic_model == "in":
                x = df
            else:  # ine — BasicModelIne: ne = N*(1 - ((N-1)/N)^F)
                x = n * (1.0 - math.pow((n - 1.0) / n, f)) if n > 0 else df
            p2 = 0.0
            p3 = _log2((n + 1.0) / (x + 0.5))
        if self.after_effect == "b":
            ae_const = (f + 1.0) / max(df, 1)
        else:
            ae_const = 1.0  # "l" divides by (tfn+1); "no" is identity
        kind = f"dfr:{self.basic_model}:{self.after_effect}:{self.normalization}"
        # p1 carries the normalization parameter (c for h1/h2, z for z)
        p1 = self.z if self.normalization == "z" else self.c
        return (kind, stats["boost"] * ae_const, p1, p2, p3)


class IBSimilarity(Similarity):
    """Information-based: distribution x lambda x normalization
    (reference: IBSimilarityProvider.java)."""

    name = "IB"
    needs_ttf = True
    DISTRIBUTIONS = ("ll", "spl")
    LAMBDAS = ("df", "ttf")
    NORMALIZATIONS = ("no", "h1", "h2", "z")

    def __init__(self, distribution: str = "ll", lam: str = "df",
                 normalization: str = "h2", c: float = 1.0, z: float = 0.30):
        distribution = distribution.lower()
        lam = lam.lower()
        normalization = normalization.lower()
        if distribution not in self.DISTRIBUTIONS:
            raise IllegalArgumentException(
                f"Unsupported Distribution [{distribution}]")
        if lam not in self.LAMBDAS:
            raise IllegalArgumentException(f"Unsupported Lambda [{lam}]")
        if normalization not in self.NORMALIZATIONS:
            raise IllegalArgumentException(
                f"Unsupported Normalization [{normalization}]")
        self.distribution = distribution
        self.lam = lam
        self.normalization = normalization
        self.c = float(c)
        self.z = float(z)

    def lane_params(self, stats):
        n = stats["doc_count"]
        if self.lam == "df":
            lam = (stats["df"] + 1.0) / (n + 1.0)
        else:
            lam = (stats["ttf"] + 1.0) / (n + 1.0)
        kind = f"ib:{self.distribution}:{self.normalization}"
        p1 = self.z if self.normalization == "z" else self.c
        return (kind, stats["boost"], p1, lam, 0.0)


# ---------------------------------------------------------------------------
# Contribution formulas (on tensors)
# ---------------------------------------------------------------------------


def _tfn(norm: str, tf, dl, avgdl, p1):
    """DFR/IB term-frequency normalization (Lucene NormalizationH1/H2/Z)."""
    if norm == "no":
        return tf
    if norm == "h1":
        return p1 * tf * avgdl / dl  # NormalizationH1: c * tf * avgdl/len
    if norm == "h2":
        return tf * torch.log2(1.0 + p1 * avgdl / dl)
    if norm == "z":
        return tf * torch.pow(avgdl / dl, p1)
    raise IllegalArgumentException(f"unknown normalization [{norm}]")


def emit_contrib(kind: str, tf, dl, w, avgdl, p1, p2, p3=0.0):
    """Per-lane score contribution for one similarity kind.

    All arguments but ``kind`` are [QB, BLOCK]-broadcastable tensors (or
    Python numbers).
    Returns contributions (>= 0) for matching postings; callers mask
    non-matching (tf == 0) lanes out.
    """
    if kind == "bm25":
        # p1 = k1, p2 = b
        return w * tf * (p1 + 1.0) / (tf + p1 * (1.0 - p2 + p2 * dl / avgdl))
    if kind == "classic":
        return w * torch.sqrt(tf) / torch.sqrt(_maximum(dl, 1.0))
    if kind == "boolean":
        return w * (tf > 0.0)
    if kind == "lm_dirichlet":
        # p1 = mu, p2 = p(t|C)
        s = torch.log2(1.0 + tf / (p1 * p2)) + torch.log2(p1 / (dl + p1))
        return _maximum(w * s, 0.0)
    if kind == "lm_jm":
        # p1 = lambda, p2 = p(t|C)
        s = torch.log2(1.0 + ((1.0 - p1) * tf / _maximum(dl, 1.0)) / (p1 * p2))
        return _maximum(w * s, 0.0)
    if kind.startswith("dfr:"):
        _, bm, ae, norm = kind.split(":")
        tfn = _tfn(norm, tf, dl, avgdl, p1)
        if bm == "g":
            basic = p2 + tfn * p3  # log2(1+lam) + tfn*log2((1+lam)/lam)
        else:
            basic = tfn * p3  # tfn * log2((N+1)/(x+0.5))
        if ae in ("b", "l"):
            basic = basic / (tfn + 1.0)  # B's (F+1)/df constant is folded in w
        return _maximum(w * basic, 0.0)
    if kind.startswith("ib:"):
        _, dist, norm = kind.split(":")
        tfn = _tfn(norm, tf, dl, avgdl, p1)
        lam = p2
        if dist == "ll":
            s = -torch.log2(lam / (tfn + lam))
        else:  # spl
            num = torch.pow(lam, tfn / (tfn + 1.0)) - lam
            s = -torch.log2(_maximum(num, 1e-12) / (1.0 - lam))
        return _maximum(w * s, 0.0)
    raise IllegalArgumentException(f"unknown similarity kind [{kind}]")


# kinds whose contributions are strictly positive for tf > 0 and w > 0 —
# eligible for the single-scatter "score > 0 == matched" fast path
STRICTLY_POSITIVE_KINDS = {"bm25", "classic", "boolean"}


# ---------------------------------------------------------------------------
# SimilarityService
# ---------------------------------------------------------------------------


def _build(type_name: str, cfg: dict) -> Similarity:
    t = type_name
    if t == "BM25":
        return BM25Similarity(k1=float(cfg.get("k1", 1.2)),
                              b=float(cfg.get("b", 0.75)))
    if t == "classic":
        return ClassicSimilarity()
    if t == "boolean":
        return BooleanSimilarity()
    if t == "LMDirichlet":
        return LMDirichletSimilarity(mu=float(cfg.get("mu", 2000.0)))
    if t == "LMJelinekMercer":
        return LMJelinekMercerSimilarity(lam=float(cfg.get("lambda", 0.1)))
    if t in ("DFR", "IB"):
        # the c parameter comes from the key matching the *configured*
        # normalization (normalization.h1.c for h1, .h2.c for h2, ...);
        # a stray key for a different normalization is ignored
        norm = str(cfg.get("normalization", "h2"))
        c = float(cfg.get(f"normalization.{norm}.c", 1.0))
        z = float(cfg.get("normalization.z.z", 0.30))
        if t == "DFR":
            return DFRSimilarity(
                basic_model=str(cfg.get("basic_model", "g")),
                after_effect=str(cfg.get("after_effect", "l")),
                normalization=norm, c=c, z=z,
            )
        return IBSimilarity(
            distribution=str(cfg.get("distribution", "ll")),
            lam=str(cfg.get("lambda", "df")),
            normalization=norm, c=c, z=z,
        )
    raise IllegalArgumentException(f"Unknown Similarity type [{t}]")


class SimilarityService:
    """Resolves similarity names for an index.

    Built-ins: BM25 (default), classic, boolean. Custom similarities come
    from ``index.similarity.<name>.type`` (+ params) in the index settings;
    ``index.similarity.default.type`` overrides the index default
    (reference: SimilarityService.java:45-75).
    """

    def __init__(self, settings=None):
        self._sims: Dict[str, Similarity] = {
            "BM25": BM25Similarity(),
            "classic": ClassicSimilarity(),
            "boolean": BooleanSimilarity(),
        }
        if settings is not None:
            groups: Dict[str, dict] = {}
            for key in settings.keys():
                if not key.startswith("index.similarity."):
                    continue
                rest = key[len("index.similarity."):]
                name, _, param = rest.partition(".")
                if name and param:
                    groups.setdefault(name, {})[param] = settings.get(key)
            for name, cfg in groups.items():
                if "type" not in cfg:
                    raise IllegalArgumentException(
                        f"similarity [{name}] must declare a type")
                self._sims[name] = _build(str(cfg["type"]), cfg)
        self.default: Similarity = self._sims.get("default", self._sims["BM25"])

    def get(self, name: Optional[str]) -> Similarity:
        if name is None:
            return self.default
        sim = self._sims.get(name)
        if sim is None:
            raise IllegalArgumentException(f"Unknown Similarity [{name}]")
        return sim
