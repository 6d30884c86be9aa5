"""The query DSL: JSON -> QueryBuilder tree -> per-segment PlanNode.

Counterpart of ``elasticsearch_tpu/search/query_dsl.py``, cut to the
queries the port serves: ``match_all``, ``match_none``, ``match``,
``match_phrase`` (slop too), ``match_phrase_prefix``, ``multi_match``,
``term``, ``terms``, ``range``, ``exists``, ``ids``, ``prefix``,
``wildcard``, ``regexp``, ``fuzzy``, ``bool``, ``constant_score``,
``dis_max``, ``function_score`` (weight, field_value_factor,
random_score), ``query_string`` and ``simple_query_string``,
``more_like_this``, ``knn``, ``geo_distance``, ``geo_bounding_box`` and
``geo_polygon``, ``nested``, ``has_child``, ``has_parent``,
``parent_id``, ``script`` (a dense mask from ``script/``: a numeric
script over the segment's columns on its device, a painless one per doc
on the host), ``geo_shape``, ``percolate``, ``type`` (``match_all``: one
doc type in 6.x) and the span family (``search/spans.py``). ``term`` and
``range`` on a range field test its (lo, hi) pairs (point containment;
``relation``). Any other query type raises the JAX package's
``ParsingException`` for an unknown query; so does ``function_score``'s
``script_score``, which the JAX package collects and then refuses as
well.

``geo_shape`` relates the query shape to each doc's shapes
(``intersects``, ``disjoint``, ``within``, ``contains``): the prefilter
(``shape_prefilter``) is float64 tensor compares over the segment's bbox
table staged on its device (NaN rows for docs without a shape), and the
exact planar relation of the candidates runs on the host
(``shape_relation``, ``utils/geometry.py``). A segment without shapes
gives an all-false mask, so the plan keeps one skeleton on the mesh. An
``indexed_shape`` is inlined by the coordinator (``Node.search``) before
any shard sees it. ``percolate`` indexes the candidate document into a
one-doc segment on the searched segment's device and runs every stored
query's plan there; a stored query that fails to parse or plan does not
match (a ``KernelError`` raises).

``nested`` runs its inner query on the path's sub-segment and folds the
matched objects onto their docs (``DenseScoreNode``); the join queries
run their inner query over every segment of the shard, restricted to one
relation, and map the other side through each segment's parent-id
vocabulary with integer arrays. Their results equal the JAX host rung's;
a join pass is memoized by shard, where the JAX package memoizes it by
builder and so loses, on its mesh plane, every match outside the first
shard (ROADMAP C13). ``collect_inner_hits`` finds the builders whose
``inner_hits`` the fetch phase answers.

``term`` and ``range`` on an ``ip`` field answer as Elasticsearch does,
through the field's ordinal column of formatted addresses: each
segment's vocabulary maps once through ``parse_ip`` to exact ints, and
the matching ordinals go to an ``OrdSetNode``. (The JAX package reads a
numeric column an ip field never has there and matches nothing.)

Multi-term expansion (prefix, wildcard, regexp, fuzzy) runs on the host
against the segment's sorted term dictionary, as does a phrase's
position intersection (``phrase_freqs``); both then score on the device.

BM25 term disjunctions go to the tile-scoring kernel node whenever the
segment's eligibility holds (every lane default-constant BM25 with a
positive weight); the kernel wrapper then picks the CUDA kernel for a GPU
segment and its plain version for a CPU one. There is no environment
switch. Ineligible lane sets take the scatter node, as in the JAX package.

A context built for the mesh plane (``ctx.for_mesh``) keeps one plan
skeleton on every segment: a term missing from one segment's dictionary
becomes an all-invalid scorer instead of ``MatchNoneNode``, and with the
kernel plane staged (``ctx.mesh_kernel``) the kernel node defers its
tables to the executor's shared geometry.
"""

from __future__ import annotations

import bisect
import fnmatch
import ipaddress
import re
from typing import List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
    QueryShardException,
)
from elasticsearch_tpu_torch.index.similarity import BM25Similarity
from elasticsearch_tpu_torch.mapper.field_types import (
    BooleanFieldType,
    DateFieldType,
    DenseVectorFieldType,
    GeoPointFieldType,
    IpFieldType,
    KeywordFieldType,
    NumberFieldType,
    RangeFieldType,
    TextFieldType,
    join_field_of,
    parse_ip,
)
from elasticsearch_tpu_torch.ops.scoring import B, K1, bm25_idf
from elasticsearch_tpu_torch.script.expression import (
    compile_script,
    segment_columns,
)
from elasticsearch_tpu_torch.search import plan as P

_DEFAULT_BM25 = BM25Similarity(k1=K1, b=B)

# the default max_expansions of a multi-term query's rewrite
MAX_EXPANSIONS = 1024


class ShardQueryContext:
    """Per-shard query context (QueryShardContext): mapper + analyzers,
    and the shard's engine for the join queries, which read every segment
    of the shard."""

    def __init__(self, mapper_service, engine=None):
        self.mapper_service = mapper_service
        self.analyzers = mapper_service.analyzers
        self.engine = engine
        # mesh plane: plans must stack across segments (one skeleton), and
        # mesh_kernel is the executor's staged kernel session, if any
        self.for_mesh = False
        self.mesh_kernel = None

    def field_type(self, name: str):
        return self.mapper_service.field_type(name)

    def similarity(self, field: str):
        svc = getattr(self.mapper_service, "similarity_service", None)
        if svc is None:
            return None
        ft = self.mapper_service.field_type(field)
        return svc.get(getattr(ft, "similarity_name", None))

    def all_segments(self, fallback_segment) -> List:
        """Every searchable segment of the shard (the one segment given,
        without an engine)."""
        if self.engine is not None:
            return list(self.engine.searchable_segments())
        return [fallback_segment]

    def default_fields(self) -> List[str]:
        """Every text field: the fields a ``query_string`` without a field
        searches (the JAX package's stand-in for ``all_fields`` mode)."""
        return [f for f, ft in self.mapper_service.mapper.fields.items()
                if isinstance(ft, TextFieldType)]


def _pad_pow2(lst, pad_value, min_len=8, dtype=None):
    n = max(min_len, 1)
    while n < len(lst):
        n *= 2
    arr = list(lst) + [pad_value] * (n - len(lst))
    return np.asarray(arr, dtype=dtype)


def term_blocks_arrays(segment, weighted_terms, ctx=None):
    """weighted_terms: list of (field, token, boost). Builds the gather
    arrays for ScoreTermsNode plus the lane metadata the kernel node
    needs: (block_start, block_count, weight, kernel_eligible). With
    ``ctx``, each field's mapped similarity folds its per-term constants
    into the lane parameters (index/similarity.py); without it, BM25 with
    the default constants."""
    blocks, weights, rows, avgdls = [], [], [], []
    p1s, p2s, p3s, kind_ids = [], [], [], []
    kinds: List[str] = []
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
            # the total term frequency costs a pass over the term's
            # postings: only the DFR, IB and LM similarities read it
            "ttf": segment.term_ttf(tid) if sim.needs_ttf else 0,
            "doc_count": doc_count,
            "sum_ttf": st.get("sum_ttf", 0),
            "avgdl": avgdl,
            "boost": boost,
        })
        if kind not in kinds:
            kinds.append(kind)
        kid = kinds.index(kind)
        start = int(segment.term_block_start[tid])
        # the tile kernel's per-posting norm factors are default-constant
        # BM25 over the segment's own statistics: any other similarity or
        # constants take the scatter node
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
            p3s.append(p3)
            kind_ids.append(kid)
    return {
        "q_blocks": _pad_pow2(blocks, 0, dtype=np.int32),
        "q_weights": _pad_pow2(weights, 0.0, dtype=np.float32),
        "q_norm_rows": _pad_pow2(rows, 0, dtype=np.int32),
        "q_avgdl": _pad_pow2(avgdls, 1.0, dtype=np.float32),
        "q_valid": _pad_pow2([True] * len(blocks), False, dtype=bool),
        "q_p1": _pad_pow2(p1s, 1.0, dtype=np.float32),
        "q_p2": _pad_pow2(p2s, 1.0, dtype=np.float32),
        "q_p3": _pad_pow2(p3s, 0.0, dtype=np.float32),
        "q_kinds": _pad_pow2(kind_ids, 0, dtype=np.int32),
        "kinds": tuple(kinds) if kinds else ("bm25",),
        "n_present": n_terms_present,
        "lanes_meta": lanes_meta,
    }


def score_terms_node(segment, weighted_terms, min_match=1, ctx=None) -> P.PlanNode:
    arrs = term_blocks_arrays(segment, weighted_terms, ctx=ctx)
    for_mesh = getattr(ctx, "for_mesh", False)
    if arrs["n_present"] == 0 or min_match > arrs["n_present"]:
        if not for_mesh:
            return P.MatchNoneNode()
        # mesh plans keep the same skeleton on every segment: a term
        # missing from one segment's dictionary must not turn its node
        # into MatchNone (the plans would no longer stack); an
        # all-invalid-lane scorer matches nothing through the same emit
        if min_match > max(arrs["n_present"], 1):
            # unsatisfiable even with every lane valid: pin the threshold
            # above the padded lane count
            min_match = arrs["q_valid"].shape[0] + 1
    node = None
    if not for_mesh:
        node = _pallas_score_terms_node(segment, arrs, min_match)
    elif getattr(ctx, "mesh_kernel", None) is not None:
        # kernel plane staged: the stackable deferred-geometry node (the
        # executor harmonizes table shapes across slots); ineligible lane
        # sets fall through to the scatter node
        node = _mesh_pallas_score_terms_node(segment, arrs, min_match,
                                             ctx.mesh_kernel)
    if node is not None:
        return node
    return P.ScoreTermsNode(
        arrs["q_blocks"], arrs["q_weights"], arrs["q_norm_rows"],
        arrs["q_avgdl"], arrs["q_valid"], min_match,
        q_p1=arrs["q_p1"], q_p2=arrs["q_p2"], q_p3=arrs["q_p3"],
        q_kinds=arrs["q_kinds"], kinds=arrs["kinds"],
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
    node = P.PallasScoreTermsNode(row_lo, row_hi, kweights, min_match,
                                  cb=cb, sub=g.tile_sub, live_key=live_key,
                                  codec=segment.kernel_codec)
    # the micro-batcher (search/batching.py) unions lane sets across
    # concurrent queries and re-derives shared tables from these
    node._host_lanes = qlanes
    return node


def _mesh_pallas_score_terms_node(segment, arrs, min_match, session):
    """Stackable tile-kernel node for the mesh plane. ``session`` is the
    executor's staged-kernel context ({geom, meta: {id(segment): (bmin,
    bmax, bfmax)}, codec}); the node reads the session's codec. Same lane
    eligibility as _pallas_score_terms_node, but an
    empty lane set stays on the kernel: a term missing from one segment's
    dictionary must not flip that segment's node type."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc

    lanes = arrs["lanes_meta"]
    if not all(ok for _, _, _, ok in lanes):
        return None
    if not all(w > 0 for _, _, w, _ in lanes):
        return None  # score > 0 is the match rule; see above
    meta = session["meta"].get(id(segment))
    if meta is None:
        return None  # segment not part of the staged mesh set
    qlanes = [tsc.QueryLane(s, c, w) for s, c, w, _ in lanes]
    return P.PallasScoreTermsNode.mesh_deferred(qlanes, meta[0], meta[1],
                                                min_match,
                                                codec=session["codec"])


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


def _range_pair_node(segment, field, q_lo, q_hi, relation, boost) -> P.PlanNode:
    """A RangePairNode over a range field's aligned #lo / #hi columns."""
    lo_col = segment.numeric_columns.get(f"{field}#lo")
    hi_col = segment.numeric_columns.get(f"{field}#hi")
    if lo_col is None or hi_col is None:
        return P.MatchNoneNode()
    docs = segment.device_column(f"num.{field}#lo.docs",
                                 lambda: lo_col.flat_docs)
    lo_vals = segment.device_column(f"num.{field}#lo.vals",
                                    lambda: lo_col.flat_values)
    hi_vals = segment.device_column(f"num.{field}#hi.vals",
                                    lambda: hi_col.flat_values)
    return P.ConstantScoreNode(
        P.RangePairNode(docs, lo_vals, hi_vals, q_lo, q_hi, relation), boost)


def ip_vocabulary_ints(segment, field: str) -> List[int]:
    """The ip field's ordinal vocabulary as exact ``parse_ip`` ints,
    mapped once a segment (cached on its host)."""
    key = f"ipints.{field}"
    ints = segment.host_cache.get(key)
    if ints is None:
        col = segment.ordinal_columns[field]
        ints = segment.host_cache[key] = [parse_ip(t) for t in col.terms]
    return ints


def ip_bounds(value) -> tuple:
    """An ip term as inclusive exact int bounds: one address, or a CIDR
    block ``10.0.0.0/16`` from its network to its broadcast address."""
    if isinstance(value, str) and "/" in value:
        try:
            net = ipaddress.ip_network(value, strict=False)
        except ValueError:
            raise QueryShardException(
                f"failed to parse ip prefix [{value}]") from None
        lo, hi = net.network_address, net.broadcast_address
        return parse_ip(str(lo)), parse_ip(str(hi))
    v = parse_ip(value)
    return v, v


def _ip_set_node(segment, field: str, lo: int, hi: int, boost) -> P.PlanNode:
    """The docs holding an address in [lo, hi] (exact ints), as an
    OrdSetNode over the segment's ordinal column."""
    if segment.ordinal_columns.get(field) is None:
        return P.MatchNoneNode()
    docs, ords, col = _ordinal_csr(segment, field)
    ints = ip_vocabulary_ints(segment, field)
    table = np.zeros(max(8, 1 << max(len(ints) - 1, 0).bit_length()), bool)
    table[: len(ints)] = [lo <= v <= hi for v in ints]
    return P.ConstantScoreNode(P.OrdSetNode(docs, ords, table), boost)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


class QueryBuilder:
    name = "base"

    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def to_plan(self, ctx: ShardQueryContext, segment) -> P.PlanNode:
        raise NotImplementedError

    def explain_terms(self, ctx) -> Optional[List[tuple]]:
        """(field, token, boost) lanes for ``_explain``'s per-term BM25
        breakdown; None when this query has no term-lane expansion (the
        explanation then stays a summary)."""
        return None

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


class KnnQueryBuilder(QueryBuilder):
    """Dense-vector kNN clause: every live doc carrying the field scores by
    its embedding's similarity to ``query_vector`` (the mapped field's
    ``similarity`` picks the metric). The top-level ``knn`` request section
    normalizes into this clause (IndexService).

    Scoring is exhaustive and exact (no ANN graph): the mesh_pallas rung
    runs kernel 3 (ops/knn_scoring.py), the host rung ``KnnScoreNode``.
    ``k`` sizes the result (the top-level section defaults the response
    size to it); ``num_candidates`` is accepted for API compatibility and
    has no effect under exact scoring. ``filter`` clauses gate which docs
    may rank (BoolQuery must + filter semantics)."""

    name = "knn"

    def __init__(self, field: str, query_vector, k: int = 10,
                 num_candidates: Optional[int] = None,
                 filter: Optional[list] = None, **kw):
        super().__init__(**kw)
        self.field = field
        self.query_vector = query_vector
        self.k = int(k)
        self.num_candidates = (int(num_candidates)
                               if num_candidates is not None else None)
        self.filter = list(filter or [])

    def _field_type(self, ctx):
        ft = ctx.field_type(self.field)
        if ft is None:
            raise QueryShardException(
                f"failed to create query: field [{self.field}] does not "
                f"exist in the mapping")
        if not isinstance(ft, DenseVectorFieldType):
            raise QueryShardException(
                f"[knn] queries are only supported on [dense_vector] "
                f"fields; [{self.field}] is [{ft.type_name}]")
        qv = self.query_vector
        if (not isinstance(qv, (list, tuple))
                or len(qv) != ft.dims
                or any(isinstance(v, bool) or not isinstance(v, (int, float))
                       or not np.isfinite(v) for v in qv)):
            # a NaN query would poison every score
            raise IllegalArgumentException(
                f"[knn] query_vector must be an array of {ft.dims} "
                f"finite numbers for field [{self.field}]")
        return ft

    def to_plan(self, ctx, segment):
        from elasticsearch_tpu_torch.ops import knn_scoring as knn

        ft = self._field_type(ctx)
        keys = segment.ensure_vector_staged(self.field, ft.similarity)
        if keys is None:
            # no doc of this segment carries the field: nothing can match
            return P.MatchNoneNode()
        emb_key, norm_key, exists_key, d_pad = keys
        qvec = knn.normalize_query(
            np.asarray(self.query_vector, np.float32), ft.similarity,
            d_pad).reshape(1, d_pad)
        node = P.KnnScoreNode(self.field, qvec, ft.similarity, self.boost,
                              emb_key, norm_key, exists_key)
        if self.filter:
            # the vector score ranks, the filter gates (the mesh kNN rung
            # does not take filtered specs: this plan runs the host rung)
            node = P.BoolNode(
                must=[node],
                filter_=[f.to_plan(ctx, segment) for f in self.filter],
                should=[], must_not=[], min_should_match=0)
        return node


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

    def explain_terms(self, ctx):
        ft = ctx.field_type(self.field)
        if ft is None or not isinstance(ft, TextFieldType):
            return None
        return [(self.field, t, self.boost)
                for t in self._analyzed_terms(ctx)]

    def to_plan(self, ctx, segment):
        ft = ctx.field_type(self.field)
        if ft is not None and isinstance(ft, (NumberFieldType, DateFieldType,
                                              BooleanFieldType)):
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


class MatchPhraseQueryBuilder(QueryBuilder):
    """match_phrase: the terms at consecutive positions (``slop`` 0) or
    each within ``slop`` of its place. The phrase frequency comes from a
    position intersection on the host (``phrase_freqs``, over the terms'
    position runs, one term at a time), the score from
    ``PhraseScoreNode`` on the device."""

    name = "match_phrase"

    def __init__(self, field: str, query, slop: int = 0,
                 analyzer: Optional[str] = None, **kw):
        super().__init__(**kw)
        self.field = field
        self.query = query
        self.slop = slop
        self.analyzer = analyzer

    def to_plan(self, ctx, segment):
        ft = ctx.field_type(self.field)
        if self.analyzer is not None:
            terms = ctx.analyzers.get(self.analyzer).analyze(str(self.query))
        elif isinstance(ft, TextFieldType):
            terms = ft.query_terms(self.query, ctx.analyzers)
        else:
            terms = [str(self.query)]
        if not terms:
            return P.MatchNoneNode()
        if len(terms) == 1:
            return MatchQueryBuilder(self.field, self.query,
                                     boost=self.boost).to_plan(ctx, segment)
        tids = [segment.term_id(self.field, t) for t in terms]
        if any(t < 0 for t in tids):
            return P.MatchNoneNode()
        positions = segment.positions
        docs, freqs = phrase_freqs(
            [(*positions.term_run(t), positions.term_keys(t)) for t in tids],
            self.slop)
        if not len(docs):
            return P.MatchNoneNode()
        # the phrase weight under the field's similarity: the sum of the
        # per-term weights; the other lane parameters come from the
        # heaviest term
        st = segment.field_stats.get(self.field, {})
        doc_count = st.get("doc_count", 0)
        sim = (ctx.similarity(self.field) if ctx is not None else None) \
            or _DEFAULT_BM25
        lanes = [
            sim.lane_params({
                "df": int(segment.term_doc_freq[t]),
                "ttf": segment.term_ttf(t) if sim.needs_ttf else 0,
                "doc_count": doc_count,
                "sum_ttf": st.get("sum_ttf", 0),
                "avgdl": segment.field_avgdl(self.field),
                "boost": 1.0,
            })
            for t in tids
        ]
        kind = lanes[0][0]
        weight = sum(lane[1] for lane in lanes) * self.boost
        _, _, p1, p2, p3 = max(lanes, key=lambda lane: lane[1])
        return P.PhraseScoreNode(
            _pad_pow2(docs.tolist(), segment.nd_pad, dtype=np.int32),
            _pad_pow2(freqs.tolist(), 0.0, dtype=np.float32),
            weight,
            segment.field_norm_idx.get(self.field, 0),
            segment.field_avgdl(self.field),
            kind=kind, p1=p1, p2=p2, p3=p3,
        )


def phrase_freqs(runs, slop: int):
    """Phrase frequencies of every doc at once: ``runs`` holds each
    term's (docs, positions) columns sorted by (doc, position), as
    ``SegmentPositions.term_run`` gives them, and their int64 keys
    ``doc << 32 | position`` (``SegmentPositions.term_keys``).
    Returns (docs ascending, freqs) for the docs whose frequency is above
    0, each frequency the JAX package's ``_phrase_freq`` of that doc's
    positions: the exact count at slop 0, else its greedy sloppy count
    (an approximation of Lucene's sloppy frequency).

    A position looks up its neighbours' places as one ``searchsorted``
    over the keys. Slop 0 counts aligned tuples, so the shortest run
    drives (each of its positions q names the tuple that starts at q - its
    index) and the others need an exact hit. The sloppy count is the
    first term's: each of its positions p needs, in term j, the nearest
    position of the same doc (one of the two neighbours of the insertion
    point) within ``slop`` of p + j."""
    if any(not len(docs) for docs, _, _ in runs):
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    if slop == 0:
        lead = int(np.argmin([len(docs) for docs, _, _ in runs]))
        _, lead_pos, lead_keys = runs[lead]
        ok = np.ones(len(lead_keys), bool)
        for j, (_, _, keys) in enumerate(runs):
            if j == lead:
                continue
            off = j - lead
            if off < 0:
                ok &= lead_pos >= -off  # the tuple starts at position >= 0
            q = lead_keys + off
            idx = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
            ok &= keys[idx] == q
        hit = runs[lead][0][ok]
    else:
        d0 = np.asarray(runs[0][0], np.int64)
        p0 = np.asarray(runs[0][1], np.int64)
        ok = np.ones(len(d0), bool)
        far = np.iinfo(np.int64).max
        for j, (dj, pj, keys) in enumerate(runs[1:], start=1):
            target = p0 + j
            idx = np.searchsorted(keys, (d0 << 32) | target)
            hi = np.minimum(idx, len(keys) - 1)
            lo = np.maximum(idx - 1, 0)
            near = np.minimum(
                np.where(dj[lo] == d0, np.abs(pj[lo] - target), far),
                np.where(dj[hi] == d0, np.abs(pj[hi] - target), far))
            ok &= near <= slop
        hit = runs[0][0][ok]
    if not len(hit):
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    # hit ascends (the driving run is sorted by doc): count each doc's run
    starts = np.flatnonzero(np.concatenate([[True], hit[1:] != hit[:-1]]))
    freqs = np.diff(np.append(starts, len(hit)))
    return hit[starts].astype(np.int32), freqs.astype(np.float32)


class MatchPhrasePrefixQueryBuilder(QueryBuilder):
    """match_phrase_prefix: the last term a prefix, expanded against the
    segment's terms (at most ``max_expansions``); one phrase per
    expansion, OR-ed."""

    name = "match_phrase_prefix"

    def __init__(self, field: str, query, max_expansions: int = 50, **kw):
        super().__init__(**kw)
        self.field = field
        self.query = query
        self.max_expansions = max_expansions

    def to_plan(self, ctx, segment):
        ft = ctx.field_type(self.field)
        terms = (ft.query_terms(self.query, ctx.analyzers)
                 if isinstance(ft, TextFieldType) else [str(self.query)])
        if not terms:
            return P.MatchNoneNode()
        expansions = _prefix_terms(segment, self.field,
                                   terms[-1])[: self.max_expansions]
        if len(terms) == 1:
            if not expansions:
                return P.MatchNoneNode()
            return score_terms_node(
                segment, [(self.field, t, self.boost) for t in expansions], 1,
                ctx=ctx)
        subs = [MatchPhraseQueryBuilder(
            self.field, " ".join(terms[:-1] + [exp]), boost=self.boost)
            for exp in expansions]
        if not subs:
            return P.MatchNoneNode()
        return BoolQueryBuilder(should=subs).to_plan(ctx, segment)


class MultiMatchQueryBuilder(QueryBuilder):
    """multi_match: ``best_fields`` (a dis_max over one match a field, the
    default), ``most_fields`` (their sum), and ``cross_fields`` (taken as
    ``most_fields``). A field may carry a boost (``title^2``) and be a
    pattern (``*``)."""

    name = "multi_match"

    def __init__(self, query, fields: List[str], type_: str = "best_fields",
                 operator: str = "or", tie_breaker: float = 0.0,
                 analyzer: Optional[str] = None, **kw):
        super().__init__(**kw)
        self.query = query
        self.fields = fields
        self.type = type_
        self.operator = operator
        self.tie_breaker = tie_breaker
        self.analyzer = analyzer

    def to_plan(self, ctx, segment):
        mapper = ctx.mapper_service.mapper
        field_boosts = []
        for f in self.fields:
            name, boost = (f.split("^", 1) if "^" in f else (f, 1.0))
            for resolved in mapper.simple_match_to_fields(name) or [name]:
                field_boosts.append((resolved, float(boost)))
        per_field = [
            MatchQueryBuilder(f, self.query, operator=self.operator,
                              analyzer=self.analyzer, boost=b)
            .to_plan(ctx, segment)
            for f, b in field_boosts
        ]
        per_field = [n for n in per_field if not isinstance(n, P.MatchNoneNode)]
        if not per_field:
            return P.MatchNoneNode()
        if self.type in ("best_fields", "phrase", "phrase_prefix"):
            node = P.DisMaxNode(per_field, self.tie_breaker)
        else:  # most_fields / cross_fields: the sum of the field scores
            node = P.BoolNode([], [], per_field, [], 1)
        return self._wrap_boost(node)


class TermQueryBuilder(QueryBuilder):
    name = "term"

    def __init__(self, field: str, value, **kw):
        super().__init__(**kw)
        self.field = field
        self.value = value

    def to_plan(self, ctx, segment):
        if self.field == "_id":
            # a term on the _id metadata field is an ids query
            vals = (self.value if isinstance(self.value, list)
                    else [self.value])
            return IdsQueryBuilder([str(v) for v in vals],
                                   boost=self.boost).to_plan(ctx, segment)
        ft = ctx.field_type(self.field)
        if isinstance(ft, RangeFieldType):
            # point containment: the stored range must hold the term
            v = ft.numeric_for_query(self.value)
            return _range_pair_node(segment, self.field, v, v, "intersects",
                                    self.boost)
        if isinstance(ft, (NumberFieldType, DateFieldType)):
            csr = _numeric_csr(segment, self.field)
            if csr is None:
                return P.MatchNoneNode()
            docs, vals, _ = csr
            v = ft.numeric_for_query(self.value)
            return P.ConstantScoreNode(P.NumericTermsNode(
                docs, vals, _pad_pow2([v], np.nan, min_len=1, dtype=np.float64)
            ), self.boost)
        if isinstance(ft, IpFieldType):
            lo, hi = ip_bounds(self.value)
            return _ip_set_node(segment, self.field, lo, hi, self.boost)
        token = (ft.term_for_query(self.value, ctx.analyzers)
                 if ft is not None and not isinstance(ft, TextFieldType)
                 else str(self.value))
        return score_terms_node(segment, [(self.field, token, self.boost)], 1,
                                ctx=ctx)

    def explain_terms(self, ctx):
        ft = ctx.field_type(self.field)
        if isinstance(ft, (KeywordFieldType, BooleanFieldType)) or ft is None:
            token = (ft.term_for_query(self.value, ctx.analyzers)
                     if ft is not None else str(self.value))
            return [(self.field, token, self.boost)]
        if isinstance(ft, TextFieldType):
            return [(self.field, str(self.value), self.boost)]
        return None


class TermsQueryBuilder(QueryBuilder):
    name = "terms"

    def __init__(self, field: str, values: List, **kw):
        super().__init__(**kw)
        self.field = field
        self.values = values

    def to_plan(self, ctx, segment):
        if self.field == "_id":
            return IdsQueryBuilder([str(v) for v in self.values],
                                   boost=self.boost).to_plan(ctx, segment)
        ft = ctx.field_type(self.field)
        if isinstance(ft, (NumberFieldType, DateFieldType)):
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
        if isinstance(ft, RangeFieldType):
            spec = {k: v for k, v in (("gte", self.gte), ("gt", self.gt),
                                      ("lte", self.lte), ("lt", self.lt))
                    if v is not None}
            q_lo, q_hi = ft.parse_range(spec)
            return _range_pair_node(segment, self.field, q_lo, q_hi,
                                    self.relation, self.boost)
        if isinstance(ft, IpFieldType):
            lo, hi = -1, 1 << 128
            if self.gte is not None:
                lo = parse_ip(self.gte)
            if self.gt is not None:
                lo = parse_ip(self.gt) + 1
            if self.lte is not None:
                hi = parse_ip(self.lte)
            if self.lt is not None:
                hi = parse_ip(self.lt) - 1
            return _ip_set_node(segment, self.field, lo, hi, self.boost)
        if isinstance(ft, (NumberFieldType, DateFieldType,
                           BooleanFieldType)) or (
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


class ExistsQueryBuilder(QueryBuilder):
    name = "exists"

    def __init__(self, field: str, **kw):
        super().__init__(**kw)
        self.field = field

    def to_plan(self, ctx, segment):
        fields = (ctx.mapper_service.mapper.simple_match_to_fields(self.field)
                  or [self.field])
        masks = []
        for f in fields:
            if f in segment.exists_masks:
                masks.append(segment.device_column(
                    f"exists.{f}",
                    lambda f=f: np.concatenate(
                        [segment.exists_masks[f], np.zeros(1, dtype=bool)])))
        if not masks:
            return P.MatchNoneNode()
        combined = masks[0]
        for m in masks[1:]:
            combined = combined | m
        return P.ConstantScoreNode(
            P.DenseMaskNode(combined, f"exists:{self.field}"), self.boost)


class IdsQueryBuilder(QueryBuilder):
    name = "ids"

    def __init__(self, values: List[str], **kw):
        super().__init__(**kw)
        self.values = values

    def to_plan(self, ctx, segment):
        id_map = segment.id_to_doc()
        docs = [id_map[v] for v in self.values if v in id_map]
        if not docs:
            return P.MatchNoneNode()
        mask = np.zeros(segment.nd_pad + 1, dtype=bool)
        mask[docs] = True
        return P.ConstantScoreNode(P.DenseMaskNode(mask, "ids"), self.boost)


class GeoDistanceQueryBuilder(QueryBuilder):
    name = "geo_distance"

    def __init__(self, field: str, center, distance, **kw):
        super().__init__(**kw)
        self.field = field
        self.center = GeoPointFieldType.parse_point(center)
        self.distance_m = parse_distance(distance)

    def to_plan(self, ctx, segment):
        col = segment.geo_columns.get(self.field)
        if col is None:
            return P.MatchNoneNode()
        docs, lat, lon = _geo_csr(segment, self.field, col)
        return P.ConstantScoreNode(P.GeoDistanceNode(
            docs, lat, lon, self.center[0], self.center[1], self.distance_m
        ), self.boost)


def _geo_csr(segment, field, col):
    return (segment.device_column(f"geo.{field}.docs", lambda: col.flat_docs),
            segment.device_column(f"geo.{field}.lat", lambda: col.lat),
            segment.device_column(f"geo.{field}.lon", lambda: col.lon))


class GeoBoundingBoxQueryBuilder(QueryBuilder):
    name = "geo_bounding_box"

    def __init__(self, field: str, top_left, bottom_right, **kw):
        super().__init__(**kw)
        self.field = field
        self.top, self.left = GeoPointFieldType.parse_point(top_left)
        self.bottom, self.right = GeoPointFieldType.parse_point(bottom_right)

    def to_plan(self, ctx, segment):
        col = segment.geo_columns.get(self.field)
        if col is None:
            return P.MatchNoneNode()
        docs, lat, lon = _geo_csr(segment, self.field, col)
        return P.ConstantScoreNode(P.GeoBoxNode(
            docs, lat, lon, self.top, self.left, self.bottom, self.right
        ), self.boost)


class GeoPolygonQueryBuilder(QueryBuilder):
    """Docs with a point inside the polygon: a ray cast on the host over
    the geo column, vectorized over the points an edge, into a dense
    mask."""

    name = "geo_polygon"

    def __init__(self, field: str, points, **kw):
        super().__init__(**kw)
        self.field = field
        if not points or len(points) < 3:
            raise ParsingException("too few points defined for geo_polygon query")
        self.points = [GeoPointFieldType.parse_point(p) for p in points]

    def to_plan(self, ctx, segment):
        col = segment.geo_columns.get(self.field)
        if col is None:
            return P.MatchNoneNode()
        n = col.count
        lat = col.lat[:n].astype(np.float64)
        lon = col.lon[:n].astype(np.float64)
        inside = np.zeros(n, dtype=bool)
        # count the edge crossings of a ray along the latitude line
        pts = self.points + [self.points[0]]
        for (lat1, lon1), (lat2, lon2) in zip(pts[:-1], pts[1:]):
            cond = (lat1 > lat) != (lat2 > lat)
            with np.errstate(divide="ignore", invalid="ignore"):
                x = (lon2 - lon1) * (lat - lat1) / (lat2 - lat1) + lon1
            inside ^= cond & (lon < x)
        mask = np.zeros(segment.nd_pad + 1, dtype=bool)
        mask[col.flat_docs[:n][inside]] = True
        mask[segment.nd_pad] = False
        return P.ConstantScoreNode(P.DenseMaskNode(mask, "geo_polygon"),
                                   self.boost)


def shape_prefilter(segment, field: str, col: dict, qbox, relation: str):
    """The bbox prefilter on the segment's device: float64 compares of the
    query shape's bbox against the staged ``[nd_pad, 4]`` table. Returns
    (mask, candidates): the dense ``[nd_pad + 1]`` bool mask of the docs
    the prefilter alone decides (``disjoint``: a shape whose bbox misses
    the query's), and the docs whose exact relation the host decides."""
    bbox = segment.device_column(f"shape.{field}.bbox", lambda: col["bbox"])
    exists = segment.device_column(f"shape.{field}.exists",
                                   lambda: col["exists"])
    q0, q1, q2, q3 = (float(v) for v in qbox)
    # NaN rows (no shape) compare False, and exists drops them
    overlap = exists & ~((bbox[:, 0] > q2) | (q0 > bbox[:, 2])
                         | (bbox[:, 1] > q3) | (q1 > bbox[:, 3]))
    mask = torch.zeros(segment.nd_pad + 1, dtype=torch.bool,
                       device=bbox.device)
    if relation == "disjoint":
        mask[: segment.nd_pad] = exists & ~overlap
        cand = overlap
    elif relation == "contains":
        # a containing shape's bbox covers the query's, so the doc's
        # combined bbox does too
        cand = exists & ((bbox[:, 0] <= q0) & (bbox[:, 1] <= q1)
                         & (bbox[:, 2] >= q2) & (bbox[:, 3] >= q3))
    else:
        # intersects and within: any one of a doc's shapes may qualify,
        # so the combined bbox only has to overlap
        cand = overlap
    return mask, torch.nonzero(cand).flatten().cpu().numpy()


def shape_relation(col: dict, candidates: np.ndarray, shape,
                   relation: str) -> np.ndarray:
    """The exact planar relation of each candidate doc's shapes to the
    query shape, on the host: a doc matches when any of its shapes holds
    the relation (``disjoint``: none intersects)."""
    out = np.zeros(len(candidates), dtype=bool)
    for i, doc in enumerate(candidates.tolist()):
        gs = col["geoms"][doc]
        if relation == "disjoint":
            out[i] = not any(g.intersects(shape) for g in gs)
        else:
            out[i] = any(g.relate(shape, relation) for g in gs)
    return out


class GeoShapeQueryBuilder(QueryBuilder):
    """geo_shape: relate the query shape to each doc's indexed shapes
    (``intersects`` by default, ``disjoint``, ``within``, ``contains``):
    the device prefilter over the bbox table, the exact relation of the
    candidates on the host, one dense mask."""

    name = "geo_shape"

    def __init__(self, field: str, shape=None, relation: str = "intersects",
                 ignore_unmapped: bool = False, **kw):
        from elasticsearch_tpu_torch.utils.geometry import parse_shape

        super().__init__(**kw)
        self.field = field
        self.shape = shape
        self.relation = str(relation).lower()
        self.ignore_unmapped = ignore_unmapped
        if self.relation not in ("intersects", "disjoint", "within",
                                 "contains"):
            raise ParsingException(
                f"Unknown geo_shape relation [{relation}]")
        if shape is None:
            raise ParsingException(
                "[geo_shape] requires a shape or indexed_shape")
        self._geom = parse_shape(shape)  # once a query, not a segment

    def to_plan(self, ctx, segment):
        from elasticsearch_tpu_torch.mapper.field_types import (
            GeoShapeFieldType,
        )

        ft = ctx.field_type(self.field)
        if not isinstance(ft, GeoShapeFieldType):
            if self.ignore_unmapped:
                return P.MatchNoneNode()
            raise QueryShardException(
                f"failed to find geo_shape field [{self.field}]")
        col = segment.shape_column(self.field)
        if col is None:
            mask = np.zeros(segment.nd_pad + 1, dtype=bool)
        else:
            mask, candidates = shape_prefilter(
                segment, self.field, col, self._geom.bbox(), self.relation)
            if len(candidates):
                hit = shape_relation(col, candidates, self._geom,
                                     self.relation)
                mask[torch.from_numpy(candidates).to(mask.device)] = \
                    torch.from_numpy(hit).to(mask.device)
        return P.ConstantScoreNode(
            P.DenseMaskNode(mask, label=f"geo_shape.{self.field}"),
            self.boost)


class PercolateQueryBuilder(QueryBuilder):
    """percolate: the stored queries (a ``percolator`` field) that match a
    candidate document. The candidate is indexed into a one-doc segment on
    the searched segment's device, with a scratch mapper over the index's
    mapping (dynamic mapping on); each live doc's stored query plans and
    runs against it there, and the matching docs form a dense mask."""

    name = "percolate"

    def __init__(self, field: str, document: dict, **kw):
        super().__init__(**kw)
        self.field = field
        self.document = document

    def to_plan(self, ctx, segment):
        from elasticsearch_tpu_torch.analysis.analyzers import (
            AnalysisRegistry,
        )
        from elasticsearch_tpu_torch.index.segment import SegmentBuilder
        from elasticsearch_tpu_torch.mapper.mapping import MapperService

        scratch = MapperService(AnalysisRegistry(),
                                ctx.mapper_service.mapping_dict())
        builder = SegmentBuilder("_percolate", device=segment.device)
        builder.add_document(
            scratch.parse_document("_candidate", self.document), 0)
        temp_seg = builder.seal()
        temp_ctx = ShardQueryContext(scratch)
        locals_, flags = [], []
        try:
            temp_dev = temp_seg.device_arrays()
            for local in np.flatnonzero(segment.live[: segment.num_docs]):
                stored = segment.sources[int(local)].get(self.field)
                if not isinstance(stored, dict):
                    continue
                try:
                    node = parse_query(stored).to_plan(temp_ctx, temp_seg)
                except Exception:  # noqa: BLE001 — a malformed stored
                    continue  # query never matches
                # outside the guard: a device or kernel fault is an error,
                # never a stored query that does not match
                _, m = P.execute(temp_dev, node)
                locals_.append(int(local))
                flags.append(m[0])
            # one read of every stored query's flag
            hit = (torch.stack(flags).cpu().numpy() if flags
                   else np.zeros(0, bool))
        finally:
            temp_seg.release_device()
        matching = [d for d, ok in zip(locals_, hit.tolist()) if ok]
        if not matching:
            return P.MatchNoneNode()
        mask = np.zeros(segment.nd_pad + 1, dtype=bool)
        mask[matching] = True
        return P.ConstantScoreNode(P.DenseMaskNode(mask, "percolate"),
                                   self.boost)


class ScriptQueryBuilder(QueryBuilder):
    """script query: the docs whose script is true (non-zero and not
    nan). The script compiles once (``compile_script``); a numeric one
    evaluates once a segment over the segment's columns on its device
    (``execute_columns``), a painless one once a doc on the host. The
    mask is built on the segment's device; a constant result fills the
    segment's rows, and the sentinel row stays false."""

    name = "script"

    def __init__(self, script_spec, **kw):
        super().__init__(**kw)
        self.script = compile_script(script_spec)
        self.params = (script_spec.get("params") or {}
                       if isinstance(script_spec, dict) else {})

    def to_plan(self, ctx, segment):
        nd = segment.nd_pad
        result = self.script.execute_columns(
            segment_columns(segment, self.script.doc_fields), self.params)
        if result is None:
            return P.MatchNoneNode()
        mask = torch.zeros(nd + 1, dtype=torch.bool, device=segment.device)
        if isinstance(result, np.ndarray):
            result = torch.from_numpy(result).to(segment.device)
        if not isinstance(result, torch.Tensor) or result.dim() == 0:
            mask[:nd] = bool(result)  # a constant expression
        else:
            r = result[:nd]
            mask[:nd] = (r != 0) & ~torch.isnan(r)
        return P.ConstantScoreNode(P.DenseMaskNode(mask, "script"), self.boost)


def _prefix_terms(segment, field: str, prefix: str) -> List[str]:
    """The field's terms that start with ``prefix``, in sorted order: the
    run of its sorted tokens from the first one at or after ``prefix``."""
    toks = segment.field_tokens(field)
    lo = hi = bisect.bisect_left(toks, prefix)
    while hi < len(toks) and toks[hi].startswith(prefix):
        hi += 1
    return toks[lo:hi]


class MultiTermExpandingBuilder(QueryBuilder):
    """The base of prefix, wildcard, regexp and fuzzy: expand against the
    segment's term dictionary on the host (at most ``MAX_EXPANSIONS``
    terms, in sorted order), then a constant-score disjunction (Lucene's
    MultiTermQuery CONSTANT_SCORE rewrite) over the kernel's lanes."""

    def __init__(self, field: str, **kw):
        super().__init__(**kw)
        self.field = field

    def matches(self, token: str) -> bool:
        raise NotImplementedError

    def expand(self, segment) -> List[str]:
        return list(filter(self.matches, segment.field_tokens(self.field)))

    def to_plan(self, ctx, segment):
        expansions = self.expand(segment)[:MAX_EXPANSIONS]
        if not expansions:
            return P.MatchNoneNode()
        node = score_terms_node(
            segment, [(self.field, t, 1.0) for t in expansions], 1, ctx=ctx)
        return P.ConstantScoreNode(node, self.boost)


class PrefixQueryBuilder(MultiTermExpandingBuilder):
    name = "prefix"

    def __init__(self, field: str, value: str, **kw):
        super().__init__(field, **kw)
        self.value = str(value)

    def expand(self, segment):
        return _prefix_terms(segment, self.field, self.value)


class WildcardQueryBuilder(MultiTermExpandingBuilder):
    name = "wildcard"

    def __init__(self, field: str, value: str, **kw):
        super().__init__(field, **kw)
        self.value = str(value)
        # fnmatch.fnmatchcase's own pattern, compiled once
        self._rx = re.compile(fnmatch.translate(self.value))

    def matches(self, token):
        return self._rx.match(token) is not None


class RegexpQueryBuilder(MultiTermExpandingBuilder):
    name = "regexp"

    def __init__(self, field: str, value: str, **kw):
        super().__init__(field, **kw)
        try:
            self._rx = re.compile(value)
        except re.error as e:
            raise ParsingException(
                f"failed to parse regexp [{value}]: {e}") from e

    def matches(self, token):
        return self._rx.fullmatch(token) is not None


def _levenshtein_leq_many(tokens: List[str], b: str, k: int) -> np.ndarray:
    """Whether each token is within ``k`` edits of ``b``: the JAX package's
    ``_levenshtein_leq`` (a banded DP with an early exit that never
    changes the answer) for every token at once, the DP row by row over
    all tokens of one length together (numpy columns)."""
    out = np.zeros(len(tokens), bool)
    lens = np.fromiter(map(len, tokens), np.int64, len(tokens))
    bc = np.array([ord(c) for c in b], np.int64)
    for n in range(max(len(b) - k, 0), len(b) + k + 1):
        idx = np.flatnonzero(lens == n)
        if not len(idx):
            continue
        if n == 0:
            out[idx] = len(b) <= k
            continue
        # the tokens' code points, one row a token
        chars = np.array([tokens[i] for i in idx], f"<U{n}").view(
            np.uint32).reshape(len(idx), n).astype(np.int64)
        prev = np.broadcast_to(np.arange(len(b) + 1),
                               (len(idx), len(b) + 1)).copy()
        for i in range(n):
            cur = np.empty_like(prev)
            cur[:, 0] = i + 1
            sub = prev[:, :-1] + (chars[:, i: i + 1] != bc[None, :])
            ins_del = np.minimum(prev[:, 1:] + 1, sub)
            for j in range(1, len(b) + 1):
                cur[:, j] = np.minimum(ins_del[:, j - 1], cur[:, j - 1] + 1)
            prev = cur
        out[idx] = prev[:, -1] <= k
    return out


class FuzzyQueryBuilder(MultiTermExpandingBuilder):
    name = "fuzzy"

    def __init__(self, field: str, value: str, fuzziness="AUTO",
                 prefix_length: int = 0, **kw):
        super().__init__(field, **kw)
        self.value = str(value)
        self.prefix_length = prefix_length
        if fuzziness in ("AUTO", "auto", None):
            n = len(self.value)
            self.max_edits = 0 if n <= 2 else (1 if n <= 5 else 2)
        else:
            self.max_edits = int(fuzziness)

    def expand(self, segment):
        if self.prefix_length:
            tokens = _prefix_terms(segment, self.field,
                                   self.value[: self.prefix_length])
        else:
            tokens = segment.field_tokens(self.field)
        keep = _levenshtein_leq_many(tokens, self.value, self.max_edits)
        return [t for t, ok in zip(tokens, keep) if ok]


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

    def explain_terms(self, ctx):
        lanes = []
        for child in list(self.must) + list(self.should):
            sub = child.explain_terms(ctx)
            if sub:
                lanes.extend(sub)
        return lanes or None

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


class DisMaxQueryBuilder(QueryBuilder):
    name = "dis_max"

    def __init__(self, queries: List[QueryBuilder], tie_breaker: float = 0.0,
                 **kw):
        super().__init__(**kw)
        self.queries = queries
        self.tie_breaker = tie_breaker

    def to_plan(self, ctx, segment):
        nodes = [q.to_plan(ctx, segment) for q in self.queries]
        return self._wrap_boost(P.DisMaxNode(nodes, self.tie_breaker))


class FunctionScoreQueryBuilder(QueryBuilder):
    """function_score with ``weight``, ``field_value_factor`` (``factor``,
    ``missing``, ``modifier``) and ``random_score`` (``seed``), combined
    multiplicatively, then with the query's score by ``boost_mode``. Any
    other function (``script_score`` too) is a ParsingException."""

    name = "function_score"

    def __init__(self, query: QueryBuilder, functions: List[dict],
                 boost_mode: str = "multiply", score_mode: str = "multiply",
                 **kw):
        super().__init__(**kw)
        self.query = query
        self.functions = functions
        self.boost_mode = boost_mode
        self.score_mode = score_mode

    def to_plan(self, ctx, segment):
        child = self.query.to_plan(ctx, segment)
        weight = 1.0
        factor_columns = []
        for fn in self.functions:
            if "weight" in fn and len(fn) == 1:
                weight *= float(fn["weight"])
                continue
            if "field_value_factor" in fn:
                spec = fn["field_value_factor"]
                col = segment.numeric_columns.get(spec["field"])
                factor = float(spec.get("factor", 1.0))
                missing = float(spec.get("missing", 1.0))
                modifier = spec.get("modifier", "none")
                if col is None:
                    vals = np.full(segment.nd_pad + 1, missing,
                                   dtype=np.float32)
                else:
                    # the f64 doc values, as f32 before the modifier (the
                    # JAX package's order)
                    base = np.where(col.exists, col.first_value, missing)
                    vals = np.concatenate([base, [missing]]).astype(
                        np.float32)
                vals = vals * factor
                if modifier == "log1p":
                    vals = np.log1p(np.maximum(vals, 0))
                elif modifier == "ln":
                    vals = np.log(np.maximum(vals, 1e-9))
                elif modifier == "sqrt":
                    vals = np.sqrt(np.maximum(vals, 0))
                elif modifier == "square":
                    vals = vals * vals
                elif modifier == "reciprocal":
                    vals = 1.0 / np.maximum(vals, 1e-9)
                factor_columns.append(vals.astype(np.float32))
                if "weight" in fn:
                    weight *= float(fn["weight"])
            elif "random_score" in fn:
                # drawn on the host with numpy, per segment, as the JAX
                # package draws them
                seed = int(fn["random_score"].get("seed", 0))
                rng = np.random.RandomState(seed if seed else 42)
                factor_columns.append(
                    rng.uniform(0, 1, segment.nd_pad + 1).astype(np.float32))
            elif "weight" in fn:
                weight *= float(fn["weight"])
            else:
                raise ParsingException(
                    f"unsupported function_score function: {sorted(fn)}")
        return self._wrap_boost(P.FunctionScoreNode(
            child, factor_columns, weight, self.boost_mode))


class QueryStringQueryBuilder(QueryBuilder):
    """The common subset of query_string: ``field:value``, quoted
    phrases, AND / OR / NOT, + / -, and wildcards in terms
    (``simple_query_string`` maps here too). A clause without a field
    searches ``fields``, else ``default_field``, else every text field."""

    name = "query_string"

    def __init__(self, query: str, default_field: Optional[str] = None,
                 fields: Optional[List[str]] = None,
                 default_operator: str = "or",
                 analyzer: Optional[str] = None,
                 lenient: bool = False, **kw):
        super().__init__(**kw)
        self.query = query
        self.default_field = default_field
        self.fields = fields
        self.default_operator = default_operator.lower()
        self.analyzer = analyzer
        self.lenient = lenient

    def _leaf(self, field: Optional[str], text: str, is_phrase: bool,
              ctx) -> QueryBuilder:
        if field is None:
            fields = self.fields or (
                [self.default_field] if self.default_field else None)
            if fields is None:
                fields = ctx.default_fields() or ["*"]
            if len(fields) > 1:
                return MultiMatchQueryBuilder(text, fields,
                                              analyzer=self.analyzer)
            field = fields[0]
        if self.lenient:
            # lenient: a clause whose value does not parse for its field's
            # type matches nothing instead of failing the request
            ft = ctx.field_type(field) if field else None
            if ft is not None and not isinstance(ft, TextFieldType):
                try:
                    ft.term_for_query(text.strip('"'), ctx.analyzers)
                    if isinstance(ft, NumberFieldType):
                        float(text.strip('"'))
                except Exception:  # noqa: BLE001 — the lenient contract
                    return MatchNoneQueryBuilder()
        if is_phrase:
            return MatchPhraseQueryBuilder(field, text,
                                           analyzer=self.analyzer)
        if "*" in text or "?" in text:
            # analyzed fields hold lowercased terms: a wildcard term is
            # lowercased to match them
            ft = ctx.field_type(field)
            if ft is None or isinstance(ft, TextFieldType):
                text = text.lower()
            return WildcardQueryBuilder(field, text)
        return MatchQueryBuilder(field, text, analyzer=self.analyzer)

    def to_plan(self, ctx, segment):
        tokens = re.findall(r'\S*"[^"]*"|\S+', self.query)
        # clauses with their modifiers; AND makes its neighbours must
        clauses = []  # [builder, kind], kind in must / should / must_not
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if tok.upper() == "AND":
                if clauses:
                    clauses[-1][1] = ("must" if clauses[-1][1] == "should"
                                      else clauses[-1][1])
                i += 1
                if i < len(tokens):
                    nxt, kind = self._clause(tokens[i], ctx)
                    if nxt is not None:
                        clauses.append(
                            [nxt, "must" if kind == "should" else kind])
                    i += 1
                continue
            if tok.upper() == "OR":
                i += 1
                continue
            if tok.upper() == "NOT":
                i += 1
                if i < len(tokens):
                    qb, _ = self._clause(tokens[i], ctx)
                    if qb is not None:
                        clauses.append([qb, "must_not"])
                    i += 1
                continue
            qb, kind = self._clause(tok, ctx)
            if qb is not None:
                clauses.append([qb, kind])
            i += 1
        must = [c for c, k in clauses if k == "must"]
        should = [c for c, k in clauses if k == "should"]
        must_not = [c for c, k in clauses if k == "must_not"]
        if self.default_operator == "and" and should:
            must.extend(should)
            should = []
        return BoolQueryBuilder(must=must, should=should, must_not=must_not,
                                boost=self.boost).to_plan(ctx, segment)

    def _clause(self, tok: str, ctx):
        """-> (builder or None, kind)."""
        kind = "should"
        if tok.startswith("+"):
            tok, kind = tok[1:], "must"
        elif tok.startswith("-"):
            tok, kind = tok[1:], "must_not"
        field = None
        if ":" in tok and not tok.startswith('"'):
            field, tok = tok.split(":", 1)
            if not tok:
                return None, kind
        is_phrase = tok.startswith('"') and tok.endswith('"') and len(tok) > 1
        text = tok.strip('"')
        if not text:
            return None, kind
        return self._leaf(field, text, is_phrase, ctx), kind


class MoreLikeThisQueryBuilder(QueryBuilder):
    """more_like_this: the highest-idf terms of the liked texts and docs
    (a doc by ``_id`` in this segment), as one disjunction with
    ``minimum_should_match``."""

    name = "more_like_this"

    def __init__(self, fields: List[str], like, max_query_terms: int = 25,
                 min_term_freq: int = 2, minimum_should_match: str = "30%",
                 **kw):
        super().__init__(**kw)
        self.fields = fields
        self.like = like if isinstance(like, list) else [like]
        self.max_query_terms = max_query_terms
        self.min_term_freq = min_term_freq
        self.minimum_should_match = minimum_should_match

    def to_plan(self, ctx, segment):
        from collections import Counter

        texts: List[str] = []
        for item in self.like:
            if isinstance(item, str):
                texts.append(item)
            elif isinstance(item, dict) and "_id" in item:
                local = segment.id_to_doc().get(item["_id"])
                if local is not None:
                    src = segment.sources[local]
                    for f in self.fields:
                        v = src.get(f)
                        if isinstance(v, str):
                            texts.append(v)
        selected: List[tuple] = []
        for field in self.fields:
            ft = ctx.field_type(field)
            counts: Counter = Counter()
            for text in texts:
                if isinstance(ft, TextFieldType):
                    counts.update(ft.query_terms(text, ctx.analyzers))
                else:
                    counts.update(ctx.analyzers.get("standard").analyze(text))
            doc_count = segment.field_stats.get(field, {}).get("doc_count", 0)
            for tok, tf in counts.items():
                if (tf < self.min_term_freq and len(texts) > 0
                        and len(counts) > 10):
                    continue
                tid = segment.term_id(field, tok)
                if tid < 0:
                    continue
                idf = bm25_idf(int(segment.term_doc_freq[tid]), doc_count)
                selected.append((idf, field, tok))
        selected.sort(reverse=True)
        selected = selected[: self.max_query_terms]
        if not selected:
            return P.MatchNoneNode()
        msm = parse_min_should_match(self.minimum_should_match,
                                     len(selected)) or 1
        return self._wrap_boost(score_terms_node(
            segment, [(f, t, 1.0) for _, f, t in selected], msm, ctx=ctx))


# ---------------------------------------------------------------------------
# Nested objects and the parent-join field
# ---------------------------------------------------------------------------


def _require_join_field(ctx):
    jf = join_field_of(ctx.mapper_service)
    if jf is None:
        raise QueryShardException(
            "no [join] field declared in the mapping of this index")
    return jf


def join_columns(segment, join_field: str):
    """(relation ordinal column, parent-id ordinal column) or None: the
    one place that knows the ``<field>#parent`` encoding."""
    col = segment.ordinal_columns.get(join_field)
    pcol = segment.ordinal_columns.get(f"{join_field}#parent")
    if col is None or pcol is None:
        return None
    return col, pcol


def join_children(segment, join_field: str, child_names):
    """Live docs whose relation is one of ``child_names`` and that carry a
    parent id -> (local docs int64, their parent ids as ordinals of the
    parent-id column, that column), or None when the segment has none."""
    cols = join_columns(segment, join_field)
    if cols is None:
        return None
    col, pcol = cols
    child_ords = [o for o in (col.ord_of(c) for c in child_names) if o >= 0]
    if not child_ords:
        return None
    nd = segment.nd_pad
    sel = (np.isin(col.first_ord, child_ords) & pcol.exists
           & segment.live[:nd])
    locals_ = np.flatnonzero(sel)
    return locals_, pcol.first_ord[locals_].astype(np.int64), pcol


def parent_id_of(segment, join_field: str, local: int) -> Optional[str]:
    cols = join_columns(segment, join_field)
    if cols is None:
        return None
    _, pcol = cols
    if not pcol.exists[local]:
        return None
    return pcol.terms[pcol.first_ord[local]]


def _vocab_to_docs(segment, terms: List[str], key: str) -> np.ndarray:
    """Each term of a parent-id vocabulary as this segment's local doc of
    that id (-1 when absent, dead docs included as ``id_to_doc`` holds
    them), cached in the segment's host cache under ``key``, which names
    the vocabulary's segment (``joinvocab.<field>.<segment>``): both
    sides are immutable."""
    hit = segment.host_cache.get(key)
    if hit is None:
        id_map = segment.id_to_doc()
        hit = np.fromiter((id_map.get(t, -1) for t in terms), np.int64,
                          len(terms))
        segment.host_cache[key] = hit
    return hit


def _matched_by_relation(ctx, segment, query: "QueryBuilder", jf,
                         relation_name: str) -> list:
    """Run ``query`` over every segment of the shard, restricted to live
    docs of one join relation: [(segment, local docs int64, scores f32)]
    in segment order, local docs ascending. The inner query runs on the
    host rung's executor of each segment."""
    inner_ctx = ShardQueryContext(ctx.mapper_service, ctx.engine)
    out = []
    for seg2 in ctx.all_segments(segment):
        col = seg2.ordinal_columns.get(jf.name)
        if col is None:
            continue
        rel_ord = col.ord_of(relation_name)
        if rel_ord < 0:
            continue
        node = query.to_plan(inner_ctx, seg2)
        scores_d, matched_d = P.execute(seg2.device_arrays(), node)
        nd = seg2.nd_pad
        scores = scores_d.cpu().numpy()
        matched = matched_d.cpu().numpy()[:nd]
        sel = matched & seg2.live[:nd] & (col.first_ord == rel_ord)
        locals_ = np.flatnonzero(sel)
        out.append((seg2, locals_, scores[locals_]))
    return out


def _shard_key(ctx):
    """The shard a join pass belongs to: one builder serves every slot of
    the mesh plane, and each shard must see its own children or parents
    (the JAX package keys this memo by builder alone; see ROADMAP C13)."""
    return id(ctx.engine)


class HasChildQueryBuilder(QueryBuilder):
    """has_child (HasChildQueryBuilder): parent docs with min_children ..
    max_children children of ``type`` matching the inner query; the
    children's scores fold per ``score_mode``. The child pass runs once a
    shard a request; each segment then maps the children's parent-id
    vocabulary to its own docs once and folds with integer arrays."""

    name = "has_child"

    def __init__(self, type_: str, query: QueryBuilder, score_mode: str = "none",
                 min_children: int = 1, max_children: Optional[int] = None,
                 inner_hits: Optional[dict] = None, **kw):
        super().__init__(**kw)
        self.type = type_
        self.query = query
        if score_mode not in ("none", "min", "max", "sum", "avg"):
            raise ParsingException(
                f"[has_child] query does not support [score_mode] = "
                f"[{score_mode}]")
        self.score_mode = score_mode
        self.min_children = max(int(min_children), 1)
        self.max_children = int(max_children) if max_children else None
        self.inner_hits = inner_hits
        # shard -> [(segment, child locals, scores, parent-id ords, pcol)]
        self._memo: dict = {}

    def _child_hits(self, ctx, segment, jf) -> list:
        key = _shard_key(ctx)
        hit = self._memo.get(key)
        if hit is None:
            hit = []
            for seg2, locals_, scores in _matched_by_relation(
                    ctx, segment, self.query, jf, self.type):
                pcol = seg2.ordinal_columns.get(f"{jf.name}#parent")
                if pcol is None:
                    continue
                has = pcol.exists[locals_]
                locals_, scores = locals_[has], scores[has]
                hit.append((seg2, locals_, scores,
                            pcol.first_ord[locals_].astype(np.int64), pcol))
            self._memo[key] = hit
        return hit

    def inner_hits_for(self, ctx, segment, local_doc: int, index_name: str):
        """The matching children of one parent hit."""
        spec = self.inner_hits if isinstance(self.inner_hits, dict) else {}
        jf = _require_join_field(ctx)
        pid = segment.doc_ids[local_doc]
        entries = []
        for seg2, locals_, scores, pords, pcol in self._child_hits(
                ctx, segment, jf):
            o = pcol.ord_of(pid)
            if o < 0:
                continue
            for i in np.flatnonzero(pords == o):
                entries.append((float(scores[i]), seg2, int(locals_[i])))
        entries.sort(key=lambda e: (-e[0], e[2]))
        name = spec.get("name", self.type)
        frm = int(spec.get("from", 0) or 0)
        size = int(spec.get("size", 3) if spec.get("size") is not None else 3)
        hits = [{"_index": index_name, "_type": "_doc",
                 "_id": seg2.doc_ids[loc], "_score": score,
                 "_source": seg2.sources[loc]}
                for score, seg2, loc in entries[frm:frm + size]]
        max_score = entries[0][0] if entries else None
        return name, {"hits": {"total": len(entries), "max_score": max_score,
                               "hits": hits}}

    def to_plan(self, ctx, segment):
        jf = _require_join_field(ctx)
        parent_name = jf.parent_of(self.type)
        if parent_name is None:
            raise QueryShardException(
                f"[has_child] join relation [{self.type}] is not a child")
        child_hits = self._child_hits(ctx, segment, jf)
        col = segment.ordinal_columns.get(jf.name)
        parent_ord = col.ord_of(parent_name) if col is not None else -1
        if parent_ord < 0:
            return P.MatchNoneNode()
        # every child as its parent's local doc here (-1: elsewhere), in
        # segment order then local order, as the JAX package folds them
        targets, scores = [], []
        for seg2, _locals, sc, pords, pcol in child_hits:
            vmap = _vocab_to_docs(
                segment, pcol.terms, f"joinvocab.{jf.name}.{seg2.name}")
            targets.append(vmap[pords])
            scores.append(sc.astype(np.float64))
        if not targets:
            return P.MatchNoneNode()
        t = np.concatenate(targets)
        s = np.concatenate(scores)
        keep = t >= 0
        t, s = t[keep], s[keep]
        # a parent id that names a doc of another relation is no parent
        ok = col.first_ord[t] == parent_ord
        t, s = t[ok], s[ok]
        nd1 = segment.nd_pad + 1
        counts = np.bincount(t, minlength=nd1)
        cand = counts >= self.min_children
        if self.max_children is not None:
            cand &= counts <= self.max_children
        mask = cand & (counts > 0)
        if not mask.any():
            return P.MatchNoneNode()
        sc = np.zeros(nd1, dtype=np.float64)
        mode = self.score_mode
        if mode in ("sum", "avg"):
            # sequential float64 in (segment, local) order: the JAX
            # package's Python sum over the same floats
            np.add.at(sc, t, s)
            if mode == "avg":
                sc = np.where(mask, sc / np.maximum(counts, 1), 0.0)
        elif mode == "min":
            sc[:] = np.inf
            np.minimum.at(sc, t, s)
        elif mode == "max":
            sc[:] = -np.inf
            np.maximum.at(sc, t, s)
        else:
            sc[:] = 1.0
        sc = np.where(mask, sc, 0.0).astype(np.float32)
        return self._wrap_boost(P.DenseScoreNode(sc, mask, "has_child"))


class HasParentQueryBuilder(QueryBuilder):
    """has_parent (HasParentQueryBuilder): child docs whose parent matches
    the inner query; ``score: true`` gives each child its parent's
    score. The parent pass runs once a shard a request and keeps each
    parent segment's scores by local doc; a segment's children then read
    them through its parent-id vocabulary mapped once to that segment's
    docs."""

    name = "has_parent"

    def __init__(self, parent_type: str, query: QueryBuilder,
                 score: bool = False, inner_hits: Optional[dict] = None, **kw):
        super().__init__(**kw)
        self.parent_type = parent_type
        self.query = query
        self.score = bool(score)
        self.inner_hits = inner_hits
        # shard -> [(segment, f64 score by local doc, nan: no matched
        # parent)]
        self._memo: dict = {}

    def _parent_hits(self, ctx, segment, jf) -> list:
        key = _shard_key(ctx)
        hit = self._memo.get(key)
        if hit is None:
            hit = []
            for seg2, locals_, scores in _matched_by_relation(
                    ctx, segment, self.query, jf, self.parent_type):
                if locals_.size:
                    by_doc = np.full(seg2.nd_pad, np.nan)
                    by_doc[locals_] = scores
                    hit.append((seg2, by_doc))
            self._memo[key] = hit
        return hit

    def inner_hits_for(self, ctx, segment, local_doc: int, index_name: str):
        """The matched parent of one child hit."""
        spec = self.inner_hits if isinstance(self.inner_hits, dict) else {}
        jf = _require_join_field(ctx)
        name = spec.get("name", self.parent_type)
        pid = parent_id_of(segment, jf.name, local_doc)
        entry = None
        for seg2, by_doc in (self._parent_hits(ctx, segment, jf)
                             if pid else ()):
            loc = seg2.id_to_doc().get(pid)
            if loc is not None and not np.isnan(by_doc[loc]):
                entry = (float(by_doc[loc]), seg2, loc)  # the last wins
        if entry is None:
            return name, {"hits": {"total": 0, "max_score": None, "hits": []}}
        score, seg2, loc = entry
        hits = [{"_index": index_name, "_type": "_doc",
                 "_id": seg2.doc_ids[loc], "_score": score,
                 "_source": seg2.sources[loc]}]
        return name, {"hits": {"total": 1, "max_score": score, "hits": hits}}

    def to_plan(self, ctx, segment):
        jf = _require_join_field(ctx)
        if not jf.is_parent(self.parent_type):
            raise QueryShardException(
                f"[has_parent] join relation [{self.parent_type}] is not a "
                f"parent")
        parent_hits = self._parent_hits(ctx, segment, jf)
        if not parent_hits:
            return P.MatchNoneNode()
        children = join_children(segment, jf.name,
                                 jf.relations.get(self.parent_type, []))
        if children is None:
            return P.MatchNoneNode()
        locals_, pords, pcol = children
        # each child's parent score (nan: no matched parent); a later
        # segment's parent of the same id wins, as in the JAX package
        psc = np.full(locals_.size, np.nan)
        for seg2, by_doc in parent_hits:
            docs = _vocab_to_docs(seg2, pcol.terms,
                                  f"joinvocab.{jf.name}.{segment.name}")[pords]
            ok = docs >= 0
            got = np.full(locals_.size, np.nan)
            got[ok] = by_doc[docs[ok]]
            psc = np.where(np.isnan(got), psc, got)
        hit = ~np.isnan(psc)
        if not hit.any():
            return P.MatchNoneNode()
        nd1 = segment.nd_pad + 1
        mask = np.zeros(nd1, dtype=bool)
        sc = np.zeros(nd1, dtype=np.float32)
        mask[locals_[hit]] = True
        sc[locals_[hit]] = psc[hit] if self.score else 1.0
        return self._wrap_boost(P.DenseScoreNode(sc, mask, "has_parent"))


class ParentIdQueryBuilder(QueryBuilder):
    """parent_id (ParentIdQueryBuilder): children of ``type`` whose parent
    is exactly ``id``."""

    name = "parent_id"

    def __init__(self, type_: str, id_: str, **kw):
        super().__init__(**kw)
        self.type = type_
        self.id = str(id_)

    def to_plan(self, ctx, segment):
        jf = _require_join_field(ctx)
        cols = join_columns(segment, jf.name)
        if cols is None:
            return P.MatchNoneNode()
        col, pcol = cols
        child_ord = col.ord_of(self.type)
        pid_ord = pcol.ord_of(self.id)
        if child_ord < 0 or pid_ord < 0:
            return P.MatchNoneNode()
        nd = segment.nd_pad
        mask = np.zeros(nd + 1, dtype=bool)
        mask[:nd] = ((col.first_ord == child_ord) & pcol.exists
                     & (pcol.first_ord == pid_ord) & segment.live[:nd])
        return P.ConstantScoreNode(P.DenseMaskNode(mask, "parent_id"),
                                   self.boost)


class NestedQueryBuilder(QueryBuilder):
    """nested (NestedQueryBuilder): the inner query runs over the path's
    sub-segment (the host rung's executor on the sub-segment's own
    tables), and the matched objects join to their docs through
    ``parent_of``: one object must satisfy the whole inner query. The
    objects' scores fold in float32 on the host in object order (a
    sequential ``np.add.at``, as the JAX package folds them), so the
    result is the same bits on every device and every run."""

    name = "nested"

    def __init__(self, path: str, query: QueryBuilder, score_mode: str = "avg",
                 ignore_unmapped: bool = False,
                 inner_hits: Optional[dict] = None, **kw):
        super().__init__(**kw)
        self.path = path
        self.query = query
        if score_mode not in ("none", "min", "max", "sum", "avg"):
            raise ParsingException(
                f"[nested] query does not support [score_mode] = "
                f"[{score_mode}]")
        self.score_mode = score_mode
        self.ignore_unmapped = bool(ignore_unmapped)
        self.inner_hits = inner_hits
        # id(segment) -> (segment, result): once a segment a request
        self._cache: dict = {}

    def _nested_matches(self, ctx, segment):
        """The inner query over the path's objects of ``segment`` ->
        (NestedContext, matched bool[n_objs], scores f32[n_objs]), or None
        when the segment holds no object at the path."""
        hit = self._cache.get(id(segment))
        if hit is not None and hit[0] is segment:
            return hit[1]
        nctx = segment.nested.get(self.path)
        out = None
        if nctx is not None and nctx.segment.num_docs > 0:
            nseg = nctx.segment
            node = self.query.to_plan(ShardQueryContext(ctx.mapper_service),
                                      nseg)
            scores_d, matched_d = P.execute(nseg.device_arrays(), node)
            n = nctx.parent_of.shape[0]
            scores = scores_d[:n].cpu().numpy()
            matched = matched_d[:n].cpu().numpy() & nseg.live[:n]
            # objects die with their doc
            matched &= segment.live[nctx.parent_of]
            out = (nctx, matched, scores)
        self._cache[id(segment)] = (segment, out)
        return out

    def to_plan(self, ctx, segment):
        if self.path not in ctx.mapper_service.mapper.nested_paths:
            if self.ignore_unmapped:
                return P.MatchNoneNode()
            raise QueryShardException(
                f"[nested] failed to find nested object under path "
                f"[{self.path}]")
        res = self._nested_matches(ctx, segment)
        if res is None:
            return P.MatchNoneNode()
        nctx, matched, scores = res
        objs = np.flatnonzero(matched)
        if objs.size == 0:
            return P.MatchNoneNode()
        parents = nctx.parent_of[objs]
        nd1 = segment.nd_pad + 1
        mask = np.zeros(nd1, dtype=bool)
        mask[parents] = True
        sc = np.zeros(nd1, dtype=np.float32)
        obj_scores = scores[objs].astype(np.float32)
        if self.score_mode == "sum":
            np.add.at(sc, parents, obj_scores)
        elif self.score_mode == "avg":
            counts = np.zeros(nd1, dtype=np.float32)
            np.add.at(sc, parents, obj_scores)
            np.add.at(counts, parents, 1.0)
            sc = np.where(counts > 0, sc / np.maximum(counts, 1.0), 0.0)
        elif self.score_mode == "min":
            sc[:] = np.inf
            np.minimum.at(sc, parents, obj_scores)
            sc = np.where(mask, sc, 0.0)
        elif self.score_mode == "max":
            sc[:] = -np.inf
            np.maximum.at(sc, parents, obj_scores)
            sc = np.where(mask, sc, 0.0)
        # "none": the docs score 0
        return self._wrap_boost(P.DenseScoreNode(sc.astype(np.float32), mask,
                                                 "nested"))

    def inner_hits_for(self, ctx, segment, local_doc: int, index_name: str):
        """The matched objects of one doc hit, each with its
        ``_nested`` field and offset."""
        spec = self.inner_hits if isinstance(self.inner_hits, dict) else {}
        res = (self._nested_matches(ctx, segment)
               if self.path in ctx.mapper_service.mapper.nested_paths
               else None)
        name = spec.get("name", self.path)
        if res is None:
            return name, {"hits": {"total": 0, "max_score": None, "hits": []}}
        nctx, matched, scores = res
        objs = np.flatnonzero(matched & (nctx.parent_of == local_doc))
        order = sorted(objs.tolist(),
                       key=lambda o: (-scores[o], nctx.offset_of[o]))
        frm = int(spec.get("from", 0) or 0)
        size = int(spec.get("size", 3) if spec.get("size") is not None else 3)
        hits = [{"_index": index_name, "_type": "_doc",
                 "_id": segment.doc_ids[local_doc],
                 "_nested": {"field": self.path,
                             "offset": int(nctx.offset_of[o])},
                 "_score": float(scores[o]),
                 "_source": nctx.segment.sources[o]}
                for o in order[frm:frm + size]]
        max_score = float(scores[order[0]]) if order else None
        return name, {"hits": {"total": len(order), "max_score": max_score,
                               "hits": hits}}


def sub_queries(qb: QueryBuilder) -> List[QueryBuilder]:
    """A compound query's immediate child builders."""
    if isinstance(qb, BoolQueryBuilder):
        return [*qb.must, *qb.filter, *qb.should, *qb.must_not]
    if isinstance(qb, ConstantScoreQueryBuilder):
        return [qb.filter]
    if isinstance(qb, DisMaxQueryBuilder):
        return list(qb.queries)
    if isinstance(qb, (FunctionScoreQueryBuilder, NestedQueryBuilder,
                       HasChildQueryBuilder, HasParentQueryBuilder)):
        return [qb.query]
    return []


def collect_inner_hits(qb: Optional[QueryBuilder]) -> List[QueryBuilder]:
    """The builders anywhere in the tree that carry an ``inner_hits``
    spec."""
    if qb is None:
        return []
    out = []
    if getattr(qb, "inner_hits", None) is not None and hasattr(
            qb, "inner_hits_for"):
        out.append(qb)
    for child in sub_queries(qb):
        out.extend(collect_inner_hits(child))
    return out


# ---------------------------------------------------------------------------
# Parsing (JSON -> builders)
# ---------------------------------------------------------------------------


def parse_distance(d) -> float:
    """'10km', '500m' or a number of meters -> meters: one unit table for
    the geo_distance query and the _geo_distance sort."""
    from elasticsearch_tpu_torch.utils.geometry import _parse_radius

    return _parse_radius(d)


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
    if qtype == "knn":
        if not isinstance(qbody, dict) or "field" not in qbody:
            raise ParsingException("[knn] requires [field]")
        if "query_vector" not in qbody:
            raise ParsingException("[knn] requires [query_vector]")
        unknown = set(qbody) - {"field", "query_vector", "k",
                                "num_candidates", "filter", "boost",
                                "_name"}
        if unknown:
            # strict parsing: a misspelled parameter is a 400
            raise ParsingException(
                f"[knn] unknown parameter(s) {sorted(unknown)}")
        flt = qbody.get("filter")
        filters = ([parse_query(f) for f in flt]
                   if isinstance(flt, list)
                   else [parse_query(flt)] if flt is not None else [])
        return KnnQueryBuilder(
            qbody["field"], qbody["query_vector"],
            k=int(qbody.get("k", 10) or 10),
            num_candidates=qbody.get("num_candidates"),
            filter=filters,
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "match_phrase":
        field, value, params = _field_and_params(qbody, "query")
        return MatchPhraseQueryBuilder(
            field, value, slop=int(params.get("slop", 0)),
            boost=float(params.get("boost", 1.0)),
        )
    if qtype == "match_phrase_prefix":
        field, value, params = _field_and_params(qbody, "query")
        return MatchPhrasePrefixQueryBuilder(
            field, value, max_expansions=int(params.get("max_expansions", 50)),
            boost=float(params.get("boost", 1.0)),
        )
    if qtype == "multi_match":
        return MultiMatchQueryBuilder(
            qbody.get("query"), qbody.get("fields") or ["*"],
            type_=qbody.get("type", "best_fields"),
            operator=qbody.get("operator", "or"),
            tie_breaker=float(qbody.get("tie_breaker", 0.0)),
            boost=float(qbody.get("boost", 1.0)),
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
    if qtype == "exists":
        return ExistsQueryBuilder(qbody["field"],
                                  boost=float(qbody.get("boost", 1.0)))
    if qtype == "ids":
        return IdsQueryBuilder(qbody.get("values", []))
    if qtype == "prefix":
        field, value, params = _field_and_params(qbody, "value")
        return PrefixQueryBuilder(field, value,
                                  boost=float(params.get("boost", 1.0)))
    if qtype == "wildcard":
        field, value, params = _field_and_params(qbody, "value")
        if value is None:
            value = params.pop("wildcard", None)
        return WildcardQueryBuilder(field, value,
                                    boost=float(params.get("boost", 1.0)))
    if qtype == "regexp":
        field, value, params = _field_and_params(qbody, "value")
        return RegexpQueryBuilder(field, value,
                                  boost=float(params.get("boost", 1.0)))
    if qtype == "fuzzy":
        field, value, params = _field_and_params(qbody, "value")
        return FuzzyQueryBuilder(
            field, value, fuzziness=params.get("fuzziness", "AUTO"),
            prefix_length=int(params.get("prefix_length", 0)),
            boost=float(params.get("boost", 1.0)),
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
    if qtype == "dis_max":
        return DisMaxQueryBuilder(
            [parse_query(q) for q in qbody.get("queries", [])],
            tie_breaker=float(qbody.get("tie_breaker", 0.0)),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "function_score":
        inner = (parse_query(qbody.get("query")) if qbody.get("query")
                 else MatchAllQueryBuilder())
        functions = qbody.get("functions")
        if functions is None:
            functions = [{k: qbody[k]} for k in (
                "field_value_factor", "random_score", "script_score",
                "weight") if k in qbody]
        return FunctionScoreQueryBuilder(
            inner, functions, boost_mode=qbody.get("boost_mode", "multiply"),
            score_mode=qbody.get("score_mode", "multiply"),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype in ("query_string", "simple_query_string"):
        return QueryStringQueryBuilder(
            qbody["query"], default_field=qbody.get("default_field"),
            fields=qbody.get("fields"),
            default_operator=qbody.get("default_operator", "or"),
            analyzer=qbody.get("analyzer"),
            lenient=bool(qbody.get("lenient", False)),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "geo_distance":
        params = dict(qbody)
        distance = params.pop("distance")
        params.pop("distance_type", None)
        params.pop("validation_method", None)
        if len(params) != 1:
            raise ParsingException("[geo_distance] requires exactly one field")
        field, center = next(iter(params.items()))
        return GeoDistanceQueryBuilder(field, center, distance)
    if qtype == "geo_bounding_box":
        params = dict(qbody)
        params.pop("validation_method", None)
        params.pop("type", None)
        if len(params) != 1:
            raise ParsingException(
                "[geo_bounding_box] requires exactly one field")
        field, box = next(iter(params.items()))
        return GeoBoundingBoxQueryBuilder(field, box["top_left"],
                                          box["bottom_right"])
    if qtype == "geo_polygon":
        params = dict(qbody)
        params.pop("validation_method", None)
        if len(params) != 1:
            raise ParsingException("[geo_polygon] requires exactly one field")
        field, spec = next(iter(params.items()))
        return GeoPolygonQueryBuilder(field, spec.get("points") or [])
    if qtype == "geo_shape":
        params = dict(qbody)
        ignore_unmapped = bool(params.pop("ignore_unmapped", False))
        boost = float(params.pop("boost", 1.0))
        if len(params) != 1:
            raise ParsingException("[geo_shape] requires exactly one field")
        field, spec = next(iter(params.items()))
        if "indexed_shape" in spec:
            raise ParsingException(
                "[geo_shape] indexed_shape must be resolved by the "
                "coordinator rewrite before shard execution")
        return GeoShapeQueryBuilder(
            field, shape=spec.get("shape"),
            relation=spec.get("relation", "intersects"),
            ignore_unmapped=ignore_unmapped, boost=boost)
    if qtype == "script":
        return ScriptQueryBuilder(
            qbody.get("script", qbody), boost=float(qbody.get("boost", 1.0))
        )
    if qtype == "percolate":
        doc = qbody.get("document")
        if doc is None and "documents" in qbody:
            doc = qbody["documents"][0]
        return PercolateQueryBuilder(qbody["field"], doc or {})
    if qtype == "more_like_this":
        return MoreLikeThisQueryBuilder(
            qbody.get("fields", []), qbody.get("like", []),
            max_query_terms=int(qbody.get("max_query_terms", 25)),
            min_term_freq=int(qbody.get("min_term_freq", 2)),
            minimum_should_match=qbody.get("minimum_should_match", "30%"),
        )
    if qtype == "has_child":
        return HasChildQueryBuilder(
            qbody["type"], parse_query(qbody.get("query")),
            score_mode=qbody.get("score_mode", "none"),
            min_children=int(qbody.get("min_children", 1) or 1),
            max_children=qbody.get("max_children"),
            inner_hits=qbody.get("inner_hits"),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "has_parent":
        return HasParentQueryBuilder(
            qbody["parent_type"], parse_query(qbody.get("query")),
            score=bool(qbody.get("score", False)),
            inner_hits=qbody.get("inner_hits"),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "parent_id":
        return ParentIdQueryBuilder(
            qbody["type"], qbody["id"], boost=float(qbody.get("boost", 1.0)))
    if qtype == "nested":
        return NestedQueryBuilder(
            qbody["path"], parse_query(qbody["query"]),
            score_mode=qbody.get("score_mode", "avg"),
            ignore_unmapped=bool(qbody.get("ignore_unmapped", False)),
            inner_hits=qbody.get("inner_hits"),
            boost=float(qbody.get("boost", 1.0)),
        )
    if qtype == "type":
        return MatchAllQueryBuilder()  # one doc type in 6.x
    from elasticsearch_tpu_torch.search.spans import (
        SPAN_TYPES,
        parse_span_query,
    )

    if qtype in SPAN_TYPES:
        return parse_span_query(body)
    raise ParsingException(f"no [query] registered for [{qtype}]")
