"""The span query family over the segment's host-side positions
(counterpart of ``elasticsearch_tpu/search/spans.py``).

``span_term``, ``span_multi`` (a prefix, wildcard, regexp or fuzzy query
expanded against the term dictionary, at most 1,024 terms), ``span_or``,
``span_near`` (``slop``, ``in_order``), ``span_first``, ``span_not``
(``pre`` / ``post`` / ``dist``), ``span_containing``, ``span_within`` and
``field_masking_span``. A span is a half-open position interval (start,
end); each builder gives ``{doc: [spans]}`` for one segment, bottom up,
read from ``Segment.positions`` (the analyzer's token index of each
term). The enumeration stays on the host (``enumerate_spans``), as the
JAX package keeps it; the matched docs then score on the device through
``PhraseScoreNode`` over the span count of each doc, weighted by the
summed BM25 idf of the terms involved. A segment without a span gives
``MatchNoneNode``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.ops.scoring import bm25_idf
from elasticsearch_tpu_torch.search import plan as P

Span = Tuple[int, int]

# combination guard for span_near brute-force enumeration
_MAX_NEAR_COMBOS = 100_000


class SpanQueryBuilder:
    """Base: subclasses implement spans(segment) -> {doc: [(start, end)]}
    plus field() and terms() (for IDF weighting)."""

    name = "span_base"

    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def field(self) -> str:
        raise NotImplementedError

    def terms(self, segment) -> List[int]:
        """Term ids involved (for the BM25 weight)."""
        return []

    def spans(self, segment) -> Dict[int, List[Span]]:
        raise NotImplementedError

    # SpanQueryBuilders are also plain QueryBuilders (usable at top level)
    def to_plan(self, ctx, segment) -> P.PlanNode:
        per_doc = enumerate_spans(self, segment)
        if not per_doc:
            return P.MatchNoneNode()
        field = self.field()
        doc_count = segment.field_stats.get(field, {}).get("doc_count", 0)
        weight = sum(
            bm25_idf(int(segment.term_doc_freq[t]), doc_count)
            for t in set(self.terms(segment))
        ) or 1.0
        docs = sorted(per_doc)
        freqs = [float(len(per_doc[d])) for d in docs]
        sentinel = segment.nd_pad
        from elasticsearch_tpu_torch.search.query_dsl import _pad_pow2

        return P.PhraseScoreNode(
            _pad_pow2(docs, sentinel, dtype=np.int32),
            _pad_pow2(freqs, 0.0, dtype=np.float32),
            weight * self.boost,
            segment.field_norm_idx.get(field, 0),
            segment.field_avgdl(field),
        )


def enumerate_spans(builder: SpanQueryBuilder, segment) -> Dict[int, List[Span]]:
    """The host enumeration of a top-level span query on one segment: the
    docs with at least one span, and their spans."""
    return {d: s for d, s in builder.spans(segment).items() if s}


class SpanTermQueryBuilder(SpanQueryBuilder):
    name = "span_term"

    def __init__(self, field: str, value: str, **kw):
        super().__init__(**kw)
        self._field = field
        self.value = str(value)

    def field(self):
        return self._field

    def terms(self, segment):
        tid = segment.term_id(self._field, self.value)
        return [tid] if tid >= 0 else []

    def spans(self, segment):
        tid = segment.term_id(self._field, self.value)
        if tid < 0:
            return {}
        return {
            doc: [(int(p), int(p) + 1) for p in pos.tolist()]
            for doc, pos in segment.positions.get(tid, {}).items()
        }


class SpanMultiTermQueryBuilder(SpanQueryBuilder):
    """span_multi: wraps prefix/wildcard/fuzzy/regexp; expands against the
    term dictionary into a span_or of span_terms."""

    name = "span_multi"

    def __init__(self, inner, **kw):
        # inner: a MultiTermExpandingBuilder (has .field and .matches)
        super().__init__(**kw)
        self.inner = inner

    def field(self):
        return self.inner.field

    def _expansions(self, segment) -> List[str]:
        # the field's matching terms in sorted order, as the JAX package's
        # filter of terms_for_field gives them
        return self.inner.expand(segment)[:1024]

    def terms(self, segment):
        out = []
        for t in self._expansions(segment):
            tid = segment.term_id(self.inner.field, t)
            if tid >= 0:
                out.append(tid)
        return out

    def spans(self, segment):
        out: Dict[int, List[Span]] = {}
        for t in self._expansions(segment):
            sub = SpanTermQueryBuilder(self.inner.field, t).spans(segment)
            for doc, sp in sub.items():
                out.setdefault(doc, []).extend(sp)
        for sp in out.values():
            sp.sort()
        return out


class SpanOrQueryBuilder(SpanQueryBuilder):
    name = "span_or"

    def __init__(self, clauses: List[SpanQueryBuilder], **kw):
        super().__init__(**kw)
        if not clauses:
            raise ParsingException("[span_or] must include [clauses]")
        self.clauses = clauses

    def field(self):
        return self.clauses[0].field()

    def terms(self, segment):
        return [t for c in self.clauses for t in c.terms(segment)]

    def spans(self, segment):
        out: Dict[int, List[Span]] = {}
        for c in self.clauses:
            for doc, sp in c.spans(segment).items():
                out.setdefault(doc, []).extend(sp)
        for sp in out.values():
            sp.sort()
        return out


class SpanNearQueryBuilder(SpanQueryBuilder):
    """span_near: clause spans combine when total gap <= slop; in_order
    requires strictly ordered non-overlapping spans (Lucene NearSpans)."""

    name = "span_near"

    def __init__(self, clauses: List[SpanQueryBuilder], slop: int = 0,
                 in_order: bool = True, **kw):
        super().__init__(**kw)
        if not clauses:
            raise ParsingException("[span_near] must include [clauses]")
        self.clauses = clauses
        self.slop = int(slop)
        self.in_order = bool(in_order)

    def field(self):
        return self.clauses[0].field()

    def terms(self, segment):
        return [t for c in self.clauses for t in c.terms(segment)]

    def spans(self, segment):
        per_clause = [c.spans(segment) for c in self.clauses]
        if not per_clause:
            return {}
        docs = set(per_clause[0])
        for pc in per_clause[1:]:
            docs &= set(pc)
        out: Dict[int, List[Span]] = {}
        for doc in docs:
            lists = [pc[doc] for pc in per_clause]
            combos = 1
            for lst in lists:
                combos *= len(lst)
            if combos > _MAX_NEAR_COMBOS:
                lists = [lst[:16] for lst in lists]
            matches = []
            self._enum(lists, 0, [], matches)
            if matches:
                out[doc] = sorted(set(matches))
        return out

    def _enum(self, lists: List[List[Span]], i: int, chosen: List[Span],
              matches: List[Span]) -> None:
        if i == len(lists):
            starts = [s for s, _ in chosen]
            ends = [e for _, e in chosen]
            lo, hi = min(starts), max(ends)
            length = sum(e - s for s, e in chosen)
            if self.in_order:
                for a, b in zip(chosen, chosen[1:]):
                    if b[0] < a[1]:
                        return
            else:
                # overlapping spans never combine (Lucene semantics)
                ordered = sorted(chosen)
                for a, b in zip(ordered, ordered[1:]):
                    if b[0] < a[1]:
                        return
            if (hi - lo) - length <= self.slop:
                matches.append((lo, hi))
            return
        for sp in lists[i]:
            self._enum(lists, i + 1, chosen + [sp], matches)


class SpanFirstQueryBuilder(SpanQueryBuilder):
    name = "span_first"

    def __init__(self, match: SpanQueryBuilder, end: int, **kw):
        super().__init__(**kw)
        self.match = match
        self.end = int(end)

    def field(self):
        return self.match.field()

    def terms(self, segment):
        return self.match.terms(segment)

    def spans(self, segment):
        return {
            doc: [sp for sp in spans if sp[1] <= self.end]
            for doc, spans in self.match.spans(segment).items()
        }


class SpanNotQueryBuilder(SpanQueryBuilder):
    name = "span_not"

    def __init__(self, include: SpanQueryBuilder, exclude: SpanQueryBuilder,
                 pre: int = 0, post: int = 0, **kw):
        super().__init__(**kw)
        self.include = include
        self.exclude = exclude
        self.pre = int(pre)
        self.post = int(post)

    def field(self):
        return self.include.field()

    def terms(self, segment):
        return self.include.terms(segment)

    def spans(self, segment):
        inc = self.include.spans(segment)
        exc = self.exclude.spans(segment)
        out = {}
        for doc, spans in inc.items():
            bad = exc.get(doc, [])
            kept = [
                sp for sp in spans
                if not any(sp[0] - self.pre < e and b < sp[1] + self.post
                           for b, e in bad)
            ]
            out[doc] = kept
        return out


class SpanContainingQueryBuilder(SpanQueryBuilder):
    """big spans that contain at least one little span."""

    name = "span_containing"

    def __init__(self, little: SpanQueryBuilder, big: SpanQueryBuilder, **kw):
        super().__init__(**kw)
        self.little = little
        self.big = big

    def field(self):
        return self.big.field()

    def terms(self, segment):
        return self.big.terms(segment)

    def spans(self, segment):
        big = self.big.spans(segment)
        little = self.little.spans(segment)
        out = {}
        for doc, bspans in big.items():
            lspans = little.get(doc, [])
            out[doc] = [
                b for b in bspans
                if any(b[0] <= ls and le <= b[1] for ls, le in lspans)
            ]
        return out


class SpanWithinQueryBuilder(SpanQueryBuilder):
    """little spans enclosed by some big span."""

    name = "span_within"

    def __init__(self, little: SpanQueryBuilder, big: SpanQueryBuilder, **kw):
        super().__init__(**kw)
        self.little = little
        self.big = big

    def field(self):
        return self.little.field()

    def terms(self, segment):
        return self.little.terms(segment)

    def spans(self, segment):
        big = self.big.spans(segment)
        little = self.little.spans(segment)
        out = {}
        for doc, lspans in little.items():
            bspans = big.get(doc, [])
            out[doc] = [
                ls for ls in lspans
                if any(b[0] <= ls[0] and ls[1] <= b[1] for b in bspans)
            ]
        return out


class FieldMaskingSpanQueryBuilder(SpanQueryBuilder):
    """field_masking_span: reports a different field name so spans on an
    analyzed sub-field can combine with spans on the base field."""

    name = "field_masking_span"

    def __init__(self, query: SpanQueryBuilder, field: str, **kw):
        super().__init__(**kw)
        self.query = query
        self._field = field

    def field(self):
        return self._field

    def terms(self, segment):
        return self.query.terms(segment)

    def spans(self, segment):
        return self.query.spans(segment)


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

SPAN_TYPES = {"span_term", "span_near", "span_first", "span_or", "span_not",
              "span_containing", "span_within", "span_multi",
              "field_masking_span"}


def parse_span_query(body: dict) -> SpanQueryBuilder:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException("[span] malformed span query clause")
    qtype, qbody = next(iter(body.items()))
    if qtype not in SPAN_TYPES:
        raise ParsingException(
            f"[{qtype}] is not a span query (span clauses must be span queries)"
        )

    if qtype == "span_term":
        if len(qbody) != 1:
            raise ParsingException("[span_term] expects one field")
        field, spec = next(iter(qbody.items()))
        if isinstance(spec, dict):
            return SpanTermQueryBuilder(
                field, spec.get("value"), boost=float(spec.get("boost", 1.0))
            )
        return SpanTermQueryBuilder(field, spec)
    if qtype == "span_near":
        return SpanNearQueryBuilder(
            [parse_span_query(c) for c in qbody.get("clauses", [])],
            slop=int(qbody.get("slop", 0)),
            in_order=bool(qbody.get("in_order", True)),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "span_first":
        return SpanFirstQueryBuilder(
            parse_span_query(qbody["match"]), qbody.get("end", 1),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "span_or":
        return SpanOrQueryBuilder(
            [parse_span_query(c) for c in qbody.get("clauses", [])],
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "span_not":
        return SpanNotQueryBuilder(
            parse_span_query(qbody["include"]),
            parse_span_query(qbody["exclude"]),
            pre=int(qbody.get("pre", qbody.get("dist", 0))),
            post=int(qbody.get("post", qbody.get("dist", 0))),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "span_containing":
        return SpanContainingQueryBuilder(
            parse_span_query(qbody["little"]), parse_span_query(qbody["big"]),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "span_within":
        return SpanWithinQueryBuilder(
            parse_span_query(qbody["little"]), parse_span_query(qbody["big"]),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "span_multi":
        from elasticsearch_tpu_torch.search.query_dsl import (
            MultiTermExpandingBuilder,
            parse_query,
        )

        inner = parse_query(qbody["match"])
        if not isinstance(inner, MultiTermExpandingBuilder):
            raise ParsingException(
                "[span_multi] [match] must be a prefix, wildcard, fuzzy or "
                "regexp query"
            )
        return SpanMultiTermQueryBuilder(inner, boost=float(qbody.get("boost", 1.0)))
    if qtype == "field_masking_span":
        return FieldMaskingSpanQueryBuilder(
            parse_span_query(qbody["query"]), qbody["field"],
            boost=float(qbody.get("boost", 1.0)),
        )
    raise ParsingException(f"no [span] query registered for [{qtype}]")
