"""The query DSL: JSON -> QueryBuilder tree -> per-segment PlanNode.

Counterpart of ``elasticsearch_tpu/search/query_dsl.py``, cut to the
queries of this slice: ``match_all``, ``match_none``, ``match`` (with
``operator`` and ``minimum_should_match``), ``term``, ``terms``, ``range``,
``bool`` and ``constant_score``. Any other query type raises the JAX
package's ``ParsingException`` for an unknown query.

BM25 term disjunctions go to the tile-scoring kernel node whenever the
segment's eligibility holds (every lane default-constant BM25 with a
positive weight); the kernel wrapper then picks the CUDA kernel for a GPU
segment and its plain version for a CPU one. There is no environment
switch. Ineligible lane sets take the scatter node, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    ParsingException,
    QueryShardException,
)
from elasticsearch_tpu_torch.index.similarity import BM25Similarity
from elasticsearch_tpu_torch.mapper.field_types import (
    NumberFieldType,
    TextFieldType,
)
from elasticsearch_tpu_torch.ops.scoring import B, K1
from elasticsearch_tpu_torch.search import plan as P

_DEFAULT_BM25 = BM25Similarity(k1=K1, b=B)


class ShardQueryContext:
    """Per-shard query context (QueryShardContext): mapper + analyzers."""

    def __init__(self, mapper_service):
        self.mapper_service = mapper_service
        self.analyzers = mapper_service.analyzers

    def field_type(self, name: str):
        return self.mapper_service.field_type(name)

    def similarity(self, field: str):
        svc = getattr(self.mapper_service, "similarity_service", None)
        if svc is None:
            return None
        ft = self.mapper_service.field_type(field)
        return svc.get(getattr(ft, "similarity_name", None))


def _pad_pow2(lst, pad_value, min_len=8, dtype=None):
    n = max(min_len, 1)
    while n < len(lst):
        n *= 2
    arr = list(lst) + [pad_value] * (n - len(lst))
    return np.asarray(arr, dtype=dtype)


def term_blocks_arrays(segment, weighted_terms, ctx=None):
    """weighted_terms: list of (field, token, boost). Builds the gather
    arrays for ScoreTermsNode plus the lane metadata the kernel node
    needs: (block_start, block_count, weight, kernel_eligible)."""
    blocks, weights, rows, avgdls, p1s, p2s = [], [], [], [], [], []
    lanes_meta = []
    n_terms_present = 0
    for field, token, boost in weighted_terms:
        tid = segment.term_id(field, token)
        if tid < 0:
            continue
        n_terms_present += 1
        st = segment.field_stats.get(field, {})
        doc_count = st.get("doc_count", 0)
        row = segment.field_norm_idx.get(field, 0)
        avgdl = segment.field_avgdl(field)
        sim = (ctx.similarity(field) if ctx is not None else None) or _DEFAULT_BM25
        kind, w, p1, p2, p3 = sim.lane_params({
            "df": int(segment.term_doc_freq[tid]),
            "ttf": 0,
            "doc_count": doc_count,
            "sum_ttf": st.get("sum_ttf", 0),
            "avgdl": avgdl,
            "boost": boost,
        })
        start = int(segment.term_block_start[tid])
        lanes_meta.append((start, int(segment.term_block_count[tid]),
                           float(w),
                           kind == "bm25" and p1 == K1 and p2 == B))
        for bi in range(start, start + int(segment.term_block_count[tid])):
            blocks.append(bi)
            weights.append(w)
            rows.append(row)
            avgdls.append(avgdl)
            p1s.append(p1)
            p2s.append(p2)
    return {
        "q_blocks": _pad_pow2(blocks, 0, dtype=np.int32),
        "q_weights": _pad_pow2(weights, 0.0, dtype=np.float32),
        "q_norm_rows": _pad_pow2(rows, 0, dtype=np.int32),
        "q_avgdl": _pad_pow2(avgdls, 1.0, dtype=np.float32),
        "q_valid": _pad_pow2([True] * len(blocks), False, dtype=bool),
        "q_p1": _pad_pow2(p1s, 1.0, dtype=np.float32),
        "q_p2": _pad_pow2(p2s, 1.0, dtype=np.float32),
        "n_present": n_terms_present,
        "lanes_meta": lanes_meta,
    }


def score_terms_node(segment, weighted_terms, min_match=1, ctx=None) -> P.PlanNode:
    arrs = term_blocks_arrays(segment, weighted_terms, ctx=ctx)
    if arrs["n_present"] == 0 or min_match > arrs["n_present"]:
        return P.MatchNoneNode()
    node = _pallas_score_terms_node(segment, arrs, min_match)
    if node is not None:
        return node
    return P.ScoreTermsNode(
        arrs["q_blocks"], arrs["q_weights"], arrs["q_norm_rows"],
        arrs["q_avgdl"], arrs["q_valid"], min_match,
        q_p1=arrs["q_p1"], q_p2=arrs["q_p2"],
    )


def _pallas_score_terms_node(segment, arrs, min_match):
    """Route eligible BM25 disjunctions through the tile-scoring kernel:
    all lanes default-constant BM25 with positive weights (zero-weight
    lanes would drop out of the kernel's match counts; the scatter path
    counts them)."""
    lanes = arrs["lanes_meta"]
    if not lanes or not all(ok for _, _, _, ok in lanes):
        return None
    if not all(w > 0 for _, _, w, _ in lanes):
        return None
    segment.device_arrays()  # the kernel tables stage with the base tables
    geom = segment.kernel_geom
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc

    qlanes = [tsc.QueryLane(s, c, w) for s, c, w, _ in lanes]
    # geometry ladder: big tiles first; a dense term's per-tile covering
    # window can exceed the bound there — retry with smaller tiles (the
    # window always fits at tile_sub <= 32 for well-formed segments)
    sub = geom.tile_sub
    while True:
        g = geom if sub == geom.tile_sub else tsc.tile_geometry(
            geom.nd_pad, sub)
        try:
            row_lo, row_hi, kweights, cb = tsc.build_tile_tables(
                qlanes, segment.kernel_bmin, segment.kernel_bmax, g)
            break
        except ValueError:
            if sub <= 32 or g.tile_sub < sub:
                return None  # malformed ranges; the scatter path handles it
            sub //= 2
    live_key = ("k_live_t" if g.tile_sub == geom.tile_sub
                else segment.kernel_live_t_for(g.tile_sub))
    return P.PallasScoreTermsNode(row_lo, row_hi, kweights, min_match,
                                  cb=cb, sub=g.tile_sub, live_key=live_key)


def _numeric_csr(segment, field):
    col = segment.numeric_columns.get(field)
    if col is None:
        return None
    docs = segment.device_column(f"num.{field}.docs", lambda: col.flat_docs)
    vals = segment.device_column(f"num.{field}.vals", lambda: col.flat_values)
    return docs, vals, col


def _ordinal_csr(segment, field):
    col = segment.ordinal_columns.get(field)
    if col is None:
        return None
    docs = segment.device_column(f"ord.{field}.docs", lambda: col.flat_docs)
    ords = segment.device_column(f"ord.{field}.ords", lambda: col.flat_ords)
    return docs, ords, col


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


class QueryBuilder:
    name = "base"

    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def to_plan(self, ctx: ShardQueryContext, segment) -> P.PlanNode:
        raise NotImplementedError

    def _wrap_boost(self, node: P.PlanNode) -> P.PlanNode:
        if self.boost != 1.0:
            return P.BoostNode(node, self.boost)
        return node


class MatchAllQueryBuilder(QueryBuilder):
    name = "match_all"

    def to_plan(self, ctx, segment):
        return P.MatchAllNode(self.boost)


class MatchNoneQueryBuilder(QueryBuilder):
    name = "match_none"

    def to_plan(self, ctx, segment):
        return P.MatchNoneNode()


class MatchQueryBuilder(QueryBuilder):
    """Full-text match: analyze with the field's search analyzer; OR
    (default) or AND over terms; minimum_should_match supported."""

    name = "match"

    def __init__(self, field: str, query, operator: str = "or",
                 minimum_should_match: Optional[str] = None,
                 analyzer: Optional[str] = None, **kw):
        super().__init__(**kw)
        self.field = field
        self.query = query
        self.operator = operator.lower()
        self.minimum_should_match = minimum_should_match
        self.analyzer = analyzer

    def _analyzed_terms(self, ctx) -> List[str]:
        ft = ctx.field_type(self.field)
        if self.analyzer is not None:
            return ctx.analyzers.get(self.analyzer).analyze(str(self.query))
        if ft is None:
            return [str(self.query)]
        if isinstance(ft, TextFieldType):
            return ft.query_terms(self.query, ctx.analyzers)
        return ft.index_terms(self.query, ctx.analyzers) or [
            ft.term_for_query(self.query, ctx.analyzers)
        ]

    def to_plan(self, ctx, segment):
        ft = ctx.field_type(self.field)
        if ft is not None and isinstance(ft, NumberFieldType):
            return TermQueryBuilder(self.field, self.query,
                                    boost=self.boost).to_plan(ctx, segment)
        terms = self._analyzed_terms(ctx)
        if not terms:
            return P.MatchNoneNode()
        if self.operator == "and":
            min_match = len(terms)
        else:
            min_match = parse_min_should_match(
                self.minimum_should_match, len(terms)) or 1
        node = score_terms_node(
            segment, [(self.field, t, 1.0) for t in terms], min_match, ctx=ctx)
        return self._wrap_boost(node)


class TermQueryBuilder(QueryBuilder):
    name = "term"

    def __init__(self, field: str, value, **kw):
        super().__init__(**kw)
        self.field = field
        self.value = value

    def to_plan(self, ctx, segment):
        if self.field == "_id":
            raise ParsingException(
                "[term] on [_id] (an ids query) is not supported by the "
                "PyTorch port yet")
        ft = ctx.field_type(self.field)
        if isinstance(ft, NumberFieldType):
            csr = _numeric_csr(segment, self.field)
            if csr is None:
                return P.MatchNoneNode()
            docs, vals, _ = csr
            v = ft.numeric_for_query(self.value)
            return P.ConstantScoreNode(P.NumericTermsNode(
                docs, vals, _pad_pow2([v], np.nan, min_len=1, dtype=np.float64)
            ), self.boost)
        token = (ft.term_for_query(self.value, ctx.analyzers)
                 if ft is not None and not isinstance(ft, TextFieldType)
                 else str(self.value))
        return score_terms_node(segment, [(self.field, token, self.boost)], 1,
                                ctx=ctx)


class TermsQueryBuilder(QueryBuilder):
    name = "terms"

    def __init__(self, field: str, values: List, **kw):
        super().__init__(**kw)
        self.field = field
        self.values = values

    def to_plan(self, ctx, segment):
        if self.field == "_id":
            raise ParsingException(
                "[terms] on [_id] (an ids query) is not supported by the "
                "PyTorch port yet")
        ft = ctx.field_type(self.field)
        if isinstance(ft, NumberFieldType):
            csr = _numeric_csr(segment, self.field)
            if csr is None:
                return P.MatchNoneNode()
            docs, vals, _ = csr
            nums = [ft.numeric_for_query(v) for v in self.values]
            return P.ConstantScoreNode(P.NumericTermsNode(
                docs, vals,
                _pad_pow2(nums, np.nan, min_len=1, dtype=np.float64),
            ), self.boost)
        # constant-score terms over ordinals if the field has them, else
        # an inverted-index disjunction
        col = segment.ordinal_columns.get(self.field)
        if col is not None:
            docs, ords, col = _ordinal_csr(segment, self.field)
            norm = (ft.term_for_query if ft is not None else (lambda v, a: str(v)))
            o = [col.ord_of(norm(v, ctx.analyzers)) for v in self.values]
            o = [x for x in o if x >= 0]
            if not o:
                return P.MatchNoneNode()
            return P.ConstantScoreNode(P.OrdTermsNode(
                docs, ords, _pad_pow2(o, -1, min_len=1, dtype=np.int32)
            ), self.boost)
        tokens = [
            (ft.term_for_query(v, ctx.analyzers) if ft is not None else str(v))
            for v in self.values
        ]
        node = score_terms_node(
            segment, [(self.field, t, self.boost) for t in tokens], 1, ctx=ctx)
        return P.ConstantScoreNode(node, self.boost)


class RangeQueryBuilder(QueryBuilder):
    name = "range"

    def __init__(self, field: str, gte=None, gt=None, lte=None, lt=None,
                 relation: str = "intersects", **kw):
        super().__init__(**kw)
        self.field = field
        self.gte, self.gt, self.lte, self.lt = gte, gt, lte, lt
        self.relation = str(relation).lower()
        if self.relation not in ("intersects", "within", "contains"):
            raise ParsingException(
                f"[range] query does not support relation [{relation}]")

    def to_plan(self, ctx, segment):
        ft = ctx.field_type(self.field)
        if isinstance(ft, NumberFieldType) or (
            ft is None and segment.numeric_columns.get(self.field) is not None
        ):
            csr = _numeric_csr(segment, self.field)
            if csr is None:
                return P.MatchNoneNode()
            docs, vals, _ = csr
            conv = ft.numeric_for_query if ft is not None else float
            lo = -np.inf
            hi = np.inf
            if self.gte is not None:
                lo = conv(self.gte)
            if self.gt is not None:
                lo = np.nextafter(conv(self.gt), np.inf)
            if self.lte is not None:
                hi = conv(self.lte)
            if self.lt is not None:
                hi = np.nextafter(conv(self.lt), -np.inf)
            return P.ConstantScoreNode(P.NumericRangeNode(docs, vals, lo, hi),
                                       self.boost)
        col = segment.ordinal_columns.get(self.field)
        if col is not None:
            docs, ords, col = _ordinal_csr(segment, self.field)
            lo_ord, hi_ord = col.ord_range(
                str(self.gte) if self.gte is not None else (
                    str(self.gt) if self.gt is not None else None),
                str(self.lte) if self.lte is not None else (
                    str(self.lt) if self.lt is not None else None),
                include_lo=self.gt is None,
                include_hi=self.lt is None,
            )
            return P.ConstantScoreNode(P.OrdRangeNode(docs, ords, lo_ord, hi_ord),
                                       self.boost)
        raise QueryShardException(
            f"field [{self.field}] does not support range queries "
            "(no doc values in this segment)")


class BoolQueryBuilder(QueryBuilder):
    name = "bool"

    def __init__(self, must=None, filter=None, should=None, must_not=None,
                 minimum_should_match=None, **kw):
        super().__init__(**kw)
        self.must = must or []
        self.filter = filter or []
        self.should = should or []
        self.must_not = must_not or []
        self.minimum_should_match = minimum_should_match

    def to_plan(self, ctx, segment):
        must = [q.to_plan(ctx, segment) for q in self.must]
        filter_ = [q.to_plan(ctx, segment) for q in self.filter]
        should = [q.to_plan(ctx, segment) for q in self.should]
        must_not = [q.to_plan(ctx, segment) for q in self.must_not]
        if self.minimum_should_match is not None:
            msm = parse_min_should_match(self.minimum_should_match, len(should))
        elif not self.must and not self.filter:
            msm = 1 if should else 0
        else:
            msm = 0
        return P.BoolNode(must, filter_, should, must_not, msm, self.boost)


class ConstantScoreQueryBuilder(QueryBuilder):
    name = "constant_score"

    def __init__(self, filter: QueryBuilder, **kw):
        super().__init__(**kw)
        self.filter = filter

    def to_plan(self, ctx, segment):
        return P.ConstantScoreNode(self.filter.to_plan(ctx, segment), self.boost)


# ---------------------------------------------------------------------------
# Parsing (JSON -> builders)
# ---------------------------------------------------------------------------


def parse_min_should_match(spec, n_clauses: int) -> int:
    """'2', '30%', '-25%' -> concrete clause count (Queries.calculateMinShouldMatch)."""
    if spec is None:
        return 0
    s = str(spec).strip()
    if s.endswith("%"):
        pct = float(s[:-1])
        if pct < 0:
            return n_clauses - int(-pct / 100.0 * n_clauses)
        return int(pct / 100.0 * n_clauses)
    v = int(s)
    if v < 0:
        return max(n_clauses + v, 0)
    return min(v, n_clauses)


def _field_and_params(body: dict, value_key: str):
    """Handle {"field": "val"} and {"field": {value_key: ..., opts}}."""
    if len(body) != 1:
        raise ParsingException(f"query body must reference one field, got {sorted(body)}")
    field, spec = next(iter(body.items()))
    if isinstance(spec, dict):
        params = dict(spec)
        value = params.pop(value_key, None)
        return field, value, params
    return field, spec, {}


def parse_query(body) -> QueryBuilder:
    """Parse the JSON query DSL (the ``"query": {...}`` object)."""
    if body is None:
        return MatchAllQueryBuilder()
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(
            "[query] malformed query, expected a single query clause object")
    qtype, qbody = next(iter(body.items()))

    if qtype == "match_all":
        return MatchAllQueryBuilder(boost=float((qbody or {}).get("boost", 1.0)))
    if qtype == "match_none":
        return MatchNoneQueryBuilder()
    if qtype == "match":
        field, value, params = _field_and_params(qbody, "query")
        return MatchQueryBuilder(
            field, value, operator=params.get("operator", "or"),
            minimum_should_match=params.get("minimum_should_match"),
            analyzer=params.get("analyzer"),
            boost=float(params.get("boost", 1.0)),
        )
    if qtype == "term":
        field, value, params = _field_and_params(qbody, "value")
        return TermQueryBuilder(field, value, boost=float(params.get("boost", 1.0)))
    if qtype == "terms":
        body2 = dict(qbody)
        boost = float(body2.pop("boost", 1.0))
        if len(body2) != 1:
            raise ParsingException("[terms] query requires exactly one field")
        field, values = next(iter(body2.items()))
        return TermsQueryBuilder(field, values, boost=boost)
    if qtype == "range":
        field, _, params = _field_and_params(qbody, "__none__")
        known = {k: params.get(k) for k in ("gte", "gt", "lte", "lt")}
        if "from" in params:
            known["gte" if params.get("include_lower", True) else "gt"] = params["from"]
        if "to" in params:
            known["lte" if params.get("include_upper", True) else "lt"] = params["to"]
        return RangeQueryBuilder(
            field, boost=float(params.get("boost", 1.0)),
            relation=params.get("relation", "intersects"), **known,
        )
    if qtype == "bool":
        def many(key):
            v = qbody.get(key)
            if v is None:
                return []
            if isinstance(v, list):
                return [parse_query(q) for q in v]
            return [parse_query(v)]

        return BoolQueryBuilder(
            must=many("must"), filter=many("filter"), should=many("should"),
            must_not=many("must_not"),
            minimum_should_match=qbody.get("minimum_should_match"),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "constant_score":
        return ConstantScoreQueryBuilder(
            parse_query(qbody["filter"]), boost=float(qbody.get("boost", 1.0)))
    raise ParsingException(f"no [query] registered for [{qtype}]")
