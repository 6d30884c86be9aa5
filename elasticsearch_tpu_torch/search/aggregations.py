"""Aggregations: parse, per-segment partials, associative reduce.

Counterpart of ``elasticsearch_tpu/search/aggregations.py``. Partials are
computed per segment view (one segment + the query's matched mask) and
every partial is associative (count maps, HLL registers, stats tuples), so
one reduce serves segments and shards alike. Sub-aggregations use the
two-phase protocol: the reduce picks the surviving buckets, then each
bucket's filter mask drives a recursive partial pass.

Served:
- metrics: ``min``, ``max``, ``sum``, ``avg``, ``stats``,
  ``extended_stats``, ``value_count``, ``cardinality`` (HLL++ registers,
  ``ops/aggs.hll_*``), ``percentiles`` (exact over a sample of at most
  100,000 matched values a segment, ``RandomState(13)`` as in JAX),
  ``top_hits`` (by the view's scores) and ``matrix_stats``;
- geo metrics: ``geo_bounds`` and ``geo_centroid`` (float32 sums on the
  host, in numpy's order, as the JAX package sums them);
- buckets, each with sub-aggregations: ``terms`` (keyword and ip
  ordinals, and text fielddata, on the device through the segment-sum
  kernel, folded in global ordinal space; numeric terms on the host),
  ``geohash_grid`` (``utils/geohash.encode_cells``), ``histogram``, ``date_histogram`` (fixed and
  calendar intervals, ``offset``, ``min_doc_count``, ``key_as_string``),
  ``range``, ``date_range``, ``filter``, ``filters``, ``global``,
  ``missing``, ``significant_terms``, ``sampler``,
  ``diversified_sampler`` and ``adjacency_matrix``;
- the twelve pipeline types, as siblings and embedded in a parent bucket
  aggregation; ``bucket_script`` and ``bucket_selector`` through the
  restricted arithmetic evaluator.

``finalize_terms``, ``finalize_histogram`` and ``_finalize_metric`` are
shared with the fused doc-values plane (``search/fused_aggs.py``), so both
assemble their responses through one function.

Text fielddata: a text field with no ordinal column (no ``fielddata:
true`` at index time) gets one built from its host postings on the first
aggregation that asks (``_text_fielddata``, as the JAX package builds it,
without the ``fielddata`` gate): vectorized, under a build lock, its
bytes charged to the fielddata breaker before the build with the JAX
estimate and recorded in ``segment.breaker_charges``, the column kept in
the segment's ``host_cache``.

Nested and join buckets: ``nested`` moves the views from the matched
docs to their objects at ``path`` (the sub-segment's columns, keyed by
full path), ``reverse_nested`` joins back to the enclosing docs (or
re-descends into another ``path``; outside a ``nested`` it raises), and
``children`` moves from the matched parents to their children of
``type`` in every segment view, through each segment's parent-id
vocabulary.

``scripted_metric`` is the JAX package's numeric form
(``_run_scripted_metric``): the map script over the segment's columns on
its device, a float64 sum of the matched docs a view, the optional reduce
script over ``params._agg``. ``run_aggregations`` holds its request
estimate on the request circuit breaker (``common/breaker.py``) while it
runs. The ``CUSTOM_AGGS`` plugin hook waits for ``plugins/``.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.mapper.field_types import (
    format_epoch_millis,
    parse_date,
)
from elasticsearch_tpu_torch.ops import aggs as agg_ops
from elasticsearch_tpu_torch.script.expression import (
    compile_script,
    segment_columns,
)

# ---------------------------------------------------------------------------
# Specs (parse)
# ---------------------------------------------------------------------------

BUCKET_TYPES = {"terms", "histogram", "date_histogram", "range", "date_range",
                "filter", "filters", "global", "missing", "significant_terms",
                "sampler", "diversified_sampler", "adjacency_matrix",
                "geohash_grid", "children", "nested", "reverse_nested",
                "scripted_metric"}
METRIC_TYPES = {"min", "max", "sum", "avg", "stats", "extended_stats",
                "value_count", "cardinality", "percentiles", "top_hits",
                "geo_bounds", "geo_centroid", "matrix_stats"}
PIPELINE_TYPES = {"derivative", "cumulative_sum", "moving_avg", "avg_bucket",
                  "sum_bucket", "min_bucket", "max_bucket", "stats_bucket",
                  "bucket_script", "bucket_selector", "bucket_sort", "serial_diff"}


class AggSpec:
    def __init__(self, name: str, agg_type: str, body: dict, subs: List["AggSpec"]):
        self.name = name
        self.type = agg_type
        self.body = body
        self.subs = subs


def parse_aggs(aggs_body: Optional[dict]) -> List[AggSpec]:
    if not aggs_body:
        return []
    specs = []
    for name, spec in aggs_body.items():
        sub_body = spec.get("aggs") or spec.get("aggregations")
        types = [k for k in spec if k not in ("aggs", "aggregations", "meta")]
        if len(types) != 1:
            raise ParsingException(
                f"Expected exactly one aggregation type for [{name}], found {types}")
        t = types[0]
        if t not in BUCKET_TYPES | METRIC_TYPES | PIPELINE_TYPES:
            raise ParsingException(f"Unknown aggregation type [{t}] for [{name}]")
        specs.append(AggSpec(name, t, spec[t], parse_aggs(sub_body)))
    return specs


# ---------------------------------------------------------------------------
# Per-segment partial computation
# ---------------------------------------------------------------------------


class SegmentView:
    """One segment + the matched mask for the current (sub-)aggregation."""

    def __init__(self, segment, mask: np.ndarray, shard_ctx=None,
                 scores: Optional[np.ndarray] = None, nested_ctx=None,
                 root_view: Optional["SegmentView"] = None):
        self.segment = segment
        self.mask = mask  # np bool [nd1], already includes live
        self.shard_ctx = shard_ctx  # ShardQueryContext for filter aggs
        self.scores = scores  # np f32 [nd1] (top_hits)
        # over a nested sub-segment: its join back to the enclosing view
        # (reverse_nested)
        self.nested_ctx = nested_ctx
        self.root_view = root_view

    def with_mask(self, mask: np.ndarray) -> "SegmentView":
        return SegmentView(self.segment, mask, self.shard_ctx, self.scores,
                           self.nested_ctx, self.root_view)


def _resolve_value_field(segment, field: str):
    return segment.numeric_columns.get(field)


def _resolve_ordinal_field(segment, field: str):
    col = segment.ordinal_columns.get(field)
    if col is not None:
        return col
    # terms on "myfield" where the mapping used text + .keyword multi-field
    col = segment.ordinal_columns.get(f"{field}.keyword")
    if col is not None:
        return col
    return _text_fielddata(segment, field)


_fielddata_build_lock = threading.Lock()


def _text_fielddata(segment, field: str):
    """The ordinal view of a text field, built from its postings on first
    use and cached on the segment's host (the reference's heap-loaded
    text fielddata; the JAX package builds it without the ``fielddata``
    gate, and so does the port). Built under a lock: racing first
    aggregations would build twice and charge the breaker twice."""
    key = f"fielddata.{field}"
    hit = segment.host_cache.get(key)
    if hit is not None:
        return hit
    with _fielddata_build_lock:
        hit = segment.host_cache.get(key)
        if hit is not None:
            return hit
        return _build_text_fielddata(segment, field, key)


def _build_text_fielddata(segment, field: str, key: str):
    """The JAX package's column, vectorized: (doc, ord) pairs of every
    posting of the field's terms (ordinal = the token's rank), sorted by
    (doc, ord), padded to a power of two with the sentinel doc;
    ``first_ord`` is a doc's lowest ordinal. The fielddata breaker is
    charged first, with the JAX estimate (8 bytes a posting, 5 a doc)."""
    from elasticsearch_tpu_torch.common.breaker import (
        CircuitBreaker,
        breaker_service,
    )
    from elasticsearch_tpu_torch.index.segment import OrdinalColumn, next_pow2

    tokens = segment.field_tokens(field)
    if not tokens:
        return None
    lo = segment.term_id(field, tokens[0])
    hi = lo + len(tokens)
    est_bytes = int(segment.term_doc_freq[lo:hi].sum()) * 8 \
        + segment.nd_pad * 5
    breaker_service().get_breaker(
        CircuitBreaker.FIELDDATA).add_estimate_bytes_and_maybe_break(
        est_bytes, f"fielddata [{field}]")
    segment.breaker_charges[key] = est_bytes
    nd_pad = segment.nd_pad
    b0 = int(segment.term_block_start[lo])
    counts = segment.term_block_count[lo:hi].astype(np.int64)
    blocks = segment.block_docs[b0: b0 + int(counts.sum())].reshape(-1)
    ords = np.repeat(np.arange(len(tokens), dtype=np.int64),
                     counts * segment.block_docs.shape[1])
    valid = blocks < nd_pad
    # one sort of (doc, ord) keys, the ordinal in the low bits: a term's
    # postings hit distinct docs, so the keys are distinct
    shift = max(len(tokens) - 1, 1).bit_length()
    keys = (blocks[valid].astype(np.int64) << shift) | ords[valid]
    keys.sort()
    n_vals = int(keys.size)
    cap = next_pow2(max(n_vals, 1))
    flat_docs = np.full(cap, nd_pad, dtype=np.int32)
    flat_ords = np.zeros(cap, dtype=np.int32)
    flat_docs[:n_vals] = keys >> shift
    flat_ords[:n_vals] = keys & ((1 << shift) - 1)
    first_ord = np.full(nd_pad, -1, dtype=np.int32)
    exists = np.zeros(nd_pad, dtype=bool)
    d = flat_docs[:n_vals]
    first = np.ones(n_vals, dtype=bool)
    first[1:] = d[1:] != d[:-1]
    first_ord[d[first]] = flat_ords[:n_vals][first]
    exists[d] = True
    col = OrdinalColumn(list(tokens), flat_ords, flat_docs, first_ord,
                        exists, n_vals)
    segment.host_cache[key] = col
    return col


def _f(seg, field):
    """The ordinal column name actually used for a field."""
    return field if field in seg.ordinal_columns else f"{field}.keyword"


def _mask_on_device(view: SegmentView) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(view.mask)).to(
        view.segment.device)


def _device_counts(view: SegmentView, field: str, ocol) -> np.ndarray:
    seg = view.segment
    docs = seg.device_column(f"ord.{_f(seg, field)}.docs",
                             lambda: ocol.flat_docs)
    ords = seg.device_column(f"ord.{_f(seg, field)}.ords",
                             lambda: ocol.flat_ords)
    return agg_ops.ordinal_counts(docs, ords, _mask_on_device(view),
                                  len(ocol.terms)).cpu().numpy()


def compute_partial(spec: AggSpec, view: SegmentView) -> dict:
    fn = _PARTIAL_FNS.get(spec.type)
    if fn is None:
        raise ParsingException(f"Unsupported aggregation type [{spec.type}]")
    return fn(spec, view)


# --- metrics ---


def _metric_values(spec: AggSpec, view: SegmentView) -> np.ndarray:
    """All values of matched docs for the agg's field (host numpy)."""
    field = spec.body.get("field")
    seg = view.segment
    col = _resolve_value_field(seg, field)
    if col is None:
        ocol = _resolve_ordinal_field(seg, field)
        if ocol is not None:
            sel = view.mask[ocol.flat_docs[: ocol.count]]
            return ocol.flat_ords[: ocol.count][sel].astype(np.float64)
        return np.empty(0, dtype=np.float64)
    sel = view.mask[col.flat_docs[: col.count]]
    vals = col.flat_values[: col.count][sel]
    if "missing" in spec.body:
        # docs matched but without the field contribute the missing value
        missing_docs = int(view.mask[: seg.nd_pad][~col.exists].sum())
        if missing_docs:
            vals = np.concatenate([vals, np.full(missing_docs, float(spec.body["missing"]))])
    return vals


def _partial_stats(spec, view):
    vals = _metric_values(spec, view)
    if vals.size == 0:
        return {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf, "sq": 0.0}
    return {
        "count": int(vals.size),
        "sum": float(vals.sum()),
        "min": float(vals.min()),
        "max": float(vals.max()),
        "sq": float((vals * vals).sum()),
    }


def _hll_columns(seg, key: str, hashes_fn, precision: int):
    """Per-value (bucket, rho) of a column at ``precision`` on the
    segment's device, computed on the host once and cached with the
    segment's other doc-value columns."""
    memo = {}

    def pair():
        if not memo:
            memo["v"] = agg_ops.hll_bucket_rho(hashes_fn(), precision)
        return memo["v"]

    bucket = seg.device_column(f"{key}.p{precision}.bucket",
                               lambda: pair()[0])
    rho = seg.device_column(f"{key}.p{precision}.rho", lambda: pair()[1])
    return bucket, rho


def _partial_cardinality(spec, view):
    field = spec.body.get("field")
    seg = view.segment
    precision = _hll_precision(spec.body.get("precision_threshold"))
    ocol = _resolve_ordinal_field(seg, field)
    if ocol is not None:
        def hashes():
            return agg_ops.hash_string_values(ocol.terms)[
                np.clip(ocol.flat_ords, 0, None)]

        docs = seg.device_column(f"ord.{_f(seg, field)}.docs",
                                 lambda: ocol.flat_docs)
        bucket, rho = _hll_columns(seg, f"hll.ord.{field}", hashes,
                                   precision)
        count = ocol.count
    else:
        col = _resolve_value_field(seg, field)
        if col is None:
            return {"registers": np.zeros(1 << precision, np.int32),
                    "precision": precision}
        docs = seg.device_column(f"num.{field}.docs", lambda: col.flat_docs)
        bucket, rho = _hll_columns(
            seg, f"hll.num.{field}",
            lambda: agg_ops.hash_numeric_values(col.flat_values), precision)
        count = col.count
    valid = torch.arange(docs.shape[0], device=docs.device) < count
    regs = agg_ops.hll_scatter(docs, bucket, rho, valid,
                               _mask_on_device(view), precision)
    return {"registers": regs.cpu().numpy(), "precision": precision}


def _hll_precision(threshold) -> int:
    if threshold is None:
        return agg_ops.HLL_DEFAULT_PRECISION
    # ES: registers ~ threshold*... pick smallest p with 2^p >= 5*threshold
    t = max(int(threshold), 1)
    p = 4
    while (1 << p) < 5 * t and p < 18:
        p += 1
    return p


def _partial_percentiles(spec, view):
    # exact over the matched values, sampled down to 100k a segment
    vals = _metric_values(spec, view)
    limit = 100_000
    if vals.size > limit:
        rng = np.random.RandomState(13)
        vals = rng.choice(vals, limit, replace=False)
    return {"values": vals}


def _partial_top_hits(spec, view):
    size = int(spec.body.get("size", 3))
    seg = view.segment
    scores = view.scores if view.scores is not None else np.zeros(seg.nd_pad + 1, np.float32)
    masked = np.where(view.mask[: seg.nd_pad], scores[: seg.nd_pad], -np.inf)
    if masked.size == 0:
        return {"hits": []}
    k = min(size, masked.size)
    idx = np.argpartition(-masked, k - 1)[:k]
    idx = idx[np.argsort(-masked[idx], kind="stable")]
    hits = []
    for d in idx:
        if masked[d] == -np.inf:
            continue
        hits.append({
            "_id": seg.doc_ids[d],
            "_score": float(masked[d]),
            "_source": seg.sources[d],
        })
    return {"hits": hits}


# --- buckets ---


def _partial_terms(spec, view):
    field = spec.body["field"]
    seg = view.segment
    ocol = _resolve_ordinal_field(seg, field)
    if ocol is not None and ocol.count > 0:
        counts = _device_counts(view, field, ocol)
        return {"counts": {ocol.terms[i]: int(c) for i, c in enumerate(counts) if c > 0},
                "doc_count_error_upper_bound": 0}
    col = _resolve_value_field(seg, field)
    if col is None or col.count == 0:
        return {"counts": {}, "doc_count_error_upper_bound": 0}
    sel = view.mask[col.flat_docs[: col.count]]
    vals = col.flat_values[: col.count][sel]
    docs_sel = col.flat_docs[: col.count][sel]
    # numeric terms: dedupe (doc, value)
    uniq = set(zip(docs_sel.tolist(), vals.tolist()))
    counts: Dict = {}
    for _, v in uniq:
        k = int(v) if float(v).is_integer() else float(v)
        counts[k] = counts.get(k, 0) + 1
    return {"counts": counts, "doc_count_error_upper_bound": 0}


def _terms_global_merge(spec, views) -> Optional[Dict]:
    """Cross-segment terms counts in global ordinal space: per-segment
    device counts fold into one int64 array through the cached local ->
    global maps. None when a segment has a numeric column for the field
    (numeric terms keep the key-mapped path)."""
    from elasticsearch_tpu_torch.index.global_ordinals import global_ordinals

    field = spec.body.get("field")
    if field is None or not views:
        return None
    cols = []
    for v in views:
        ocol = _resolve_ordinal_field(v.segment, field)
        if ocol is None and _resolve_value_field(v.segment, field) is not None:
            return None  # numeric terms
        cols.append(ocol)
    gords = global_ordinals([v.segment for v in views], field, columns=cols)
    if not gords.terms:
        return {}
    total = np.zeros(len(gords.terms), np.int64)
    for v, ocol in zip(views, cols):
        if ocol is None or ocol.count == 0:
            continue
        counts = _device_counts(v, field, ocol)
        gords.fold_counts(v.segment, counts.astype(np.int64), total)
    nz = np.nonzero(total)[0]
    return {gords.terms[i]: int(total[i]) for i in nz}


_CAL_INTERVALS = {"year": "Y", "quarter": None, "month": "M", "week": "W",
                  "day": "D", "hour": "h", "minute": "m", "second": "s"}
_FIXED_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}


def _date_interval_ms(interval: str) -> Optional[float]:
    """Fixed intervals -> millis; calendar intervals return None."""
    s = str(interval)
    if s in _CAL_INTERVALS:
        return None
    for unit in sorted(_FIXED_MS, key=len, reverse=True):
        if s.endswith(unit):
            try:
                return float(s[: -len(unit)]) * _FIXED_MS[unit]
            except ValueError:
                break
    raise ParsingException(f"unable to parse interval [{interval}]")


def _calendar_bucket_keys(millis: np.ndarray, interval: str) -> np.ndarray:
    """Calendar rounding via numpy datetime64 (host columnar op)."""
    dt = millis.astype("int64").astype("datetime64[ms]")
    if interval == "quarter":
        months = dt.astype("datetime64[M]").astype(np.int64)
        q_start = (months // 3) * 3
        return q_start.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
    unit = _CAL_INTERVALS[interval]
    return dt.astype(f"datetime64[{unit}]").astype("datetime64[ms]").astype(np.int64)


def _date_interval_spec(body: dict):
    return (body.get("interval") or body.get("calendar_interval")
            or body.get("fixed_interval"))


def _histogram_keys(spec, vals: np.ndarray, is_date: bool) -> np.ndarray:
    """Each value's bucket key, in the JAX package's f64 arithmetic."""
    if is_date:
        interval = _date_interval_spec(spec.body)
        ms = _date_interval_ms(interval)
        if ms is None:
            return _calendar_bucket_keys(vals.astype(np.int64), str(interval))
        offset = float(spec.body.get("offset", 0) or 0)
        return (np.floor((vals - offset) / ms) * ms + offset).astype(np.int64)
    interval = float(spec.body["interval"])
    offset = float(spec.body.get("offset", 0.0))
    return np.floor((vals - offset) / interval) * interval + offset


def _partial_histogram(spec, view, is_date=False):
    field = spec.body["field"]
    seg = view.segment
    col = _resolve_value_field(seg, field)
    if col is None or col.count == 0:
        return {"counts": {}}
    sel = view.mask[col.flat_docs[: col.count]]
    vals = col.flat_values[: col.count][sel]
    if vals.size == 0:
        return {"counts": {}}
    keys = _histogram_keys(spec, vals, is_date)
    counts: Dict = {}
    uniq, cnt = np.unique(keys, return_counts=True)
    for k, c in zip(uniq.tolist(), cnt.tolist()):
        counts[k] = counts.get(k, 0) + int(c)
    return {"counts": counts}


def _partial_range(spec, view, is_date=False):
    field = spec.body["field"]
    ranges = spec.body["ranges"]
    seg = view.segment
    col = _resolve_value_field(seg, field)
    out = []
    conv = (lambda v: float(parse_date(v))) if is_date else float
    for r in ranges:
        lo = conv(r["from"]) if "from" in r else -np.inf
        hi = conv(r["to"]) if "to" in r else np.inf
        if col is None or col.count == 0:
            out.append(0)
            continue
        sel = view.mask[col.flat_docs[: col.count]]
        in_r = (col.flat_values[: col.count] >= lo) & (col.flat_values[: col.count] < hi) & sel
        out.append(int(len(set(col.flat_docs[: col.count][in_r].tolist()))))
    return {"range_counts": out}


def _partial_filter(spec, view):
    from elasticsearch_tpu_torch.search import plan as P
    from elasticsearch_tpu_torch.search.query_dsl import parse_query

    qb = parse_query(spec.body)
    node = qb.to_plan(view.shard_ctx, view.segment)
    _, matched = P.execute(view.segment.device_arrays(), node)
    sub_mask = matched.cpu().numpy() & view.mask
    return {"doc_count": int(sub_mask[: view.segment.nd_pad].sum()),
            "_mask": sub_mask}


def _partial_filters(spec, view):
    filters = spec.body.get("filters")
    out = {}
    if isinstance(filters, dict):
        items = filters.items()
    else:
        items = ((str(i), f) for i, f in enumerate(filters))
    for key, f in items:
        sub = _partial_filter(AggSpec(key, "filter", f, []), view)
        out[key] = sub
    return {"filters": out}


def _partial_global(spec, view):
    seg = view.segment
    mask = np.concatenate([seg.live, np.zeros(1, bool)])
    return {"doc_count": int(seg.live_doc_count), "_mask": mask}


def _partial_missing(spec, view):
    field = spec.body["field"]
    seg = view.segment
    exists = seg.exists_masks.get(field)
    sub_mask = view.mask.copy()
    if exists is not None:
        sub_mask[: seg.nd_pad] &= ~exists
    return {"doc_count": int(sub_mask[: seg.nd_pad].sum()), "_mask": sub_mask}


def _partial_matrix_stats(spec, view):
    """matrix_stats: per-field-pair covariance/correlation over docs having
    all fields."""
    fields = spec.body["fields"]
    seg = view.segment
    cols = []
    for f in fields:
        col = _resolve_value_field(seg, f)
        if col is None:
            return {"n": 0, "fields": fields}
        cols.append(col)
    sel = view.mask[: seg.nd_pad].copy()
    for col in cols:
        sel &= col.exists
    data = np.stack([np.where(sel, c.first_value, 0.0) for c in cols])
    n = int(sel.sum())
    if n == 0:
        return {"n": 0, "fields": fields}
    # sufficient statistics (associative across segments)
    sums = data.sum(axis=1)
    prods = data @ data.T
    return {"n": n, "fields": fields, "sums": sums, "prods": prods}


# --- geo metrics ---


def _geo_values(spec, view):
    """The float32 (lat, lon) values of the matched docs."""
    col = view.segment.geo_columns.get(spec.body["field"])
    if col is None or col.count == 0:
        return np.empty(0, np.float32), np.empty(0, np.float32)
    sel = view.mask[col.flat_docs[: col.count]]
    return col.lat[: col.count][sel], col.lon[: col.count][sel]


def _partial_geo_bounds(spec, view):
    lat, lon = _geo_values(spec, view)
    if lat.size == 0:
        return {"top": None}
    return {"top": float(lat.max()), "bottom": float(lat.min()),
            "left": float(lon.min()), "right": float(lon.max())}


def _partial_geo_centroid(spec, view):
    # float32 sums in numpy's order: the JAX package's bits
    lat, lon = _geo_values(spec, view)
    return {"count": int(lat.size), "lat_sum": float(lat.sum()),
            "lon_sum": float(lon.sum())}


def _partial_geohash_grid(spec, view):
    """Points (not docs) a geohash cell, as the JAX package counts them."""
    from elasticsearch_tpu_torch.utils.geohash import (
        cell_strings,
        encode_cells,
    )

    precision = int(spec.body.get("precision", 5))
    lat, lon = _geo_values(spec, view)
    cells, counts = np.unique(encode_cells(lat, lon, precision),
                              return_counts=True)
    return {"counts": dict(zip(cell_strings(cells, precision),
                               counts.tolist()))}


_PARTIAL_FNS: Dict[str, Callable] = {
    "matrix_stats": _partial_matrix_stats,
    "min": _partial_stats, "max": _partial_stats, "sum": _partial_stats,
    "avg": _partial_stats, "stats": _partial_stats, "extended_stats": _partial_stats,
    "value_count": _partial_stats,
    "cardinality": _partial_cardinality,
    "percentiles": _partial_percentiles,
    "top_hits": _partial_top_hits,
    "terms": _partial_terms,
    "histogram": lambda s, v: _partial_histogram(s, v, is_date=False),
    "date_histogram": lambda s, v: _partial_histogram(s, v, is_date=True),
    "range": lambda s, v: _partial_range(s, v, is_date=False),
    "date_range": lambda s, v: _partial_range(s, v, is_date=True),
    "filter": _partial_filter,
    "filters": _partial_filters,
    "global": _partial_global,
    "missing": _partial_missing,
    "geo_bounds": _partial_geo_bounds,
    "geo_centroid": _partial_geo_centroid,
    "geohash_grid": _partial_geohash_grid,
}


# ---------------------------------------------------------------------------
# Reduce (partials -> final response), two-phase sub-agg execution
# ---------------------------------------------------------------------------


def _reduce_stats(partials: List[dict]) -> dict:
    out = {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf, "sq": 0.0}
    for p in partials:
        out["count"] += p["count"]
        out["sum"] += p["sum"]
        out["min"] = min(out["min"], p["min"])
        out["max"] = max(out["max"], p["max"])
        out["sq"] += p["sq"]
    return out


def _finalize_metric(spec: AggSpec, partials: List[dict]) -> dict:
    t = spec.type
    if t in ("min", "max", "sum", "avg", "stats", "extended_stats", "value_count"):
        st = _reduce_stats(partials)
        count, total = st["count"], st["sum"]
        if t == "min":
            return {"value": None if count == 0 else st["min"]}
        if t == "max":
            return {"value": None if count == 0 else st["max"]}
        if t == "sum":
            return {"value": total}
        if t == "avg":
            return {"value": None if count == 0 else total / count}
        if t == "value_count":
            return {"value": count}
        base = {
            "count": count,
            "min": None if count == 0 else st["min"],
            "max": None if count == 0 else st["max"],
            "avg": None if count == 0 else total / count,
            "sum": total,
        }
        if t == "stats":
            return base
        variance = 0.0
        if count > 0:
            variance = max(st["sq"] / count - (total / count) ** 2, 0.0)
        base.update({
            "sum_of_squares": st["sq"],
            "variance": variance,
            "std_deviation": math.sqrt(variance),
            "std_deviation_bounds": {
                "upper": (total / count + 2 * math.sqrt(variance)) if count else None,
                "lower": (total / count - 2 * math.sqrt(variance)) if count else None,
            },
        })
        return base
    if t == "cardinality":
        regs = None
        for p in partials:
            regs = p["registers"] if regs is None else np.maximum(regs, p["registers"])
        if regs is None:
            return {"value": 0}
        return {"value": int(round(agg_ops.hll_estimate(regs)))}
    if t == "percentiles":
        vals = np.concatenate([p["values"] for p in partials]) if partials else np.empty(0)
        pcts = spec.body.get("percents", [1, 5, 25, 50, 75, 95, 99])
        if vals.size == 0:
            return {"values": {str(float(p)): None for p in pcts}}
        return {"values": {
            str(float(p)): float(np.percentile(vals, p)) for p in pcts
        }}
    if t == "top_hits":
        size = int(spec.body.get("size", 3))
        all_hits = [h for p in partials for h in p["hits"]]
        all_hits.sort(key=lambda h: -h["_score"])
        return {"hits": {
            "total": len(all_hits),
            "hits": all_hits[:size],
        }}
    if t == "geo_bounds":
        tops = [p for p in partials if p.get("top") is not None]
        if not tops:
            return {"bounds": None}
        return {"bounds": {
            "top_left": {"lat": max(p["top"] for p in tops),
                         "lon": min(p["left"] for p in tops)},
            "bottom_right": {"lat": min(p["bottom"] for p in tops),
                             "lon": max(p["right"] for p in tops)},
        }}
    if t == "geo_centroid":
        count = sum(p["count"] for p in partials)
        if count == 0:
            return {"count": 0, "location": None}
        return {"count": count, "location": {
            "lat": sum(p["lat_sum"] for p in partials) / count,
            "lon": sum(p["lon_sum"] for p in partials) / count,
        }}
    if t == "matrix_stats":
        live = [p for p in partials if p.get("n")]
        if not live:
            return {"doc_count": 0, "fields": []}
        fields = live[0]["fields"]
        n = sum(p["n"] for p in live)
        sums = sum(p["sums"] for p in live)
        prods = sum(p["prods"] for p in live)
        means = sums / n
        cov = prods / n - np.outer(means, means)
        std = np.sqrt(np.clip(np.diag(cov), 1e-30, None))
        corr = cov / np.outer(std, std)
        out_fields = []
        for i, f in enumerate(fields):
            out_fields.append({
                "name": f,
                "count": n,
                "mean": float(means[i]),
                "variance": float(cov[i, i]),
                "covariance": {g: float(cov[i, j]) for j, g in enumerate(fields)},
                "correlation": {g: float(corr[i, j]) for j, g in enumerate(fields)},
            })
        return {"doc_count": n, "fields": out_fields}
    raise ParsingException(f"cannot finalize metric [{t}]")


def _agg_request_estimate(specs: List[AggSpec], views) -> int:
    """The request breaker's estimate for one aggregation request: the
    bucket machinery scales with aggs x segments x docs touched."""
    n_specs = sum(1 + len(s.subs) for s in specs)
    n_docs = sum(int(v.segment.nd_pad) for v in views)
    return n_specs * (n_docs * 4 + 4096)


def run_aggregations(specs: List[AggSpec], views: List[SegmentView]) -> dict:
    """Execute an agg tree over segment views; returns the response dict
    keyed by agg name (segments of one or more shards). The request's
    estimate is held on the request breaker while it runs (a trip is a
    429 ``circuit_breaking_exception``)."""
    from elasticsearch_tpu_torch.common.breaker import (
        CircuitBreaker,
        breaker_service,
    )

    breaker = breaker_service().get_breaker(CircuitBreaker.REQUEST)
    est = _agg_request_estimate(specs, views)
    breaker.add_estimate_bytes_and_maybe_break(est, "<agg_request>")
    try:
        out = {}
        pipeline_specs = [s for s in specs if s.type in PIPELINE_TYPES]
        for spec in specs:
            if spec.type in PIPELINE_TYPES:
                continue
            out[spec.name] = _run_one(spec, views)
        for spec in pipeline_specs:
            _apply_pipeline(spec, out)
        return out
    finally:
        breaker.add_without_breaking(-est)


def _run_one(spec: AggSpec, views: List[SegmentView]) -> dict:
    """Runs one agg; pipeline sub-aggs (parent pipelines embedded INSIDE a
    bucket agg) are stripped first and applied across the finished
    buckets."""
    embedded = [s for s in (spec.subs or []) if s.type in PIPELINE_TYPES]
    if embedded:
        spec = AggSpec(spec.name, spec.type, spec.body,
                       [s for s in spec.subs if s.type not in PIPELINE_TYPES])
    result = _run_one_inner(spec, views)
    for p in embedded:
        _apply_embedded_pipeline(p, result)
    return result


def _apply_embedded_pipeline(spec: AggSpec, result: dict) -> None:
    """Apply a parent pipeline to its enclosing agg's reduced buckets by
    wrapping them as a synthetic sibling path."""
    wrapped = {"_b": result}
    body = dict(spec.body)
    if isinstance(body.get("buckets_path"), str):
        body["buckets_path"] = "_b>" + body["buckets_path"]
    elif isinstance(body.get("buckets_path"), dict):
        body["buckets_path"] = {k: "_b>" + v
                                for k, v in body["buckets_path"].items()}
    _apply_pipeline(AggSpec(spec.name, spec.type, body, spec.subs), wrapped)
    if spec.name in wrapped:  # sibling-output pipelines (avg_bucket family)
        result[spec.name] = wrapped[spec.name]


def _merged_counts(partials) -> Dict:
    merged: Dict = {}
    for p in partials:
        for k, c in p["counts"].items():
            merged[k] = merged.get(k, 0) + c
    return merged


def _run_single_bucket(spec, views, partials) -> dict:
    """filter / global / missing: one bucket whose sub-aggs see each
    partial's mask."""
    result = {"doc_count": sum(p["doc_count"] for p in partials)}
    if spec.subs:
        sub_views = [v.with_mask(p["_mask"]) for v, p in zip(views, partials)]
        result.update(run_aggregations(spec.subs, sub_views))
    return result


def _run_one_inner(spec: AggSpec, views: List[SegmentView]) -> dict:
    if spec.type in METRIC_TYPES:
        partials = [compute_partial(spec, v) for v in views]
        return _finalize_metric(spec, partials)

    if spec.type in ("filter", "global", "missing"):
        return _run_single_bucket(
            spec, views, [compute_partial(spec, v) for v in views])

    if spec.type == "filters":
        partials = [compute_partial(spec, v) for v in views]
        buckets = {}
        keys = partials[0]["filters"].keys() if partials else []
        for key in keys:
            doc_count = sum(p["filters"][key]["doc_count"] for p in partials)
            b = {"doc_count": doc_count}
            if spec.subs:
                sub_views = [v.with_mask(p["filters"][key]["_mask"])
                             for v, p in zip(views, partials)]
                b.update(run_aggregations(spec.subs, sub_views))
            buckets[key] = b
        return {"buckets": buckets}

    if spec.type == "terms":
        merged = _terms_global_merge(spec, views)
        if merged is None:  # numeric/missing field: key-mapped partials
            merged = _merged_counts([compute_partial(spec, v) for v in views])
        sub_cb = None
        if spec.subs:
            def sub_cb(key):
                sub_views = [
                    v.with_mask(_term_bucket_mask(v, spec.body["field"], key))
                    for v in views
                ]
                return run_aggregations(spec.subs, sub_views)
        return finalize_terms(spec, merged, sub_cb)

    if spec.type in ("histogram", "date_histogram"):
        is_date = spec.type == "date_histogram"
        merged = _merged_counts([compute_partial(spec, v) for v in views])
        sub_cb = None
        if spec.subs:
            def sub_cb(key, count):
                if count > 0:
                    sub_views = [
                        v.with_mask(_histo_bucket_mask(v, spec, key, is_date))
                        for v in views
                    ]
                else:
                    sub_views = [v.with_mask(np.zeros_like(v.mask))
                                 for v in views]
                return run_aggregations(spec.subs, sub_views)
        return finalize_histogram(spec, merged, is_date, sub_cb)

    if spec.type == "nested":
        return _run_nested(spec, views)

    if spec.type == "reverse_nested":
        return _run_reverse_nested(spec, views)

    if spec.type == "children":
        return _run_children(spec, views)

    if spec.type == "significant_terms":
        return _run_significant_terms(spec, views)

    if spec.type in ("sampler", "diversified_sampler"):
        return _run_sampler(spec, views)

    if spec.type == "adjacency_matrix":
        return _run_adjacency_matrix(spec, views)

    if spec.type == "scripted_metric":
        return _run_scripted_metric(spec, views)

    if spec.type == "geohash_grid":
        merged: Dict[str, int] = {}
        for p in (compute_partial(spec, v) for v in views):
            for k, c in p["counts"].items():
                merged[k] = merged.get(k, 0) + c
        size = int(spec.body.get("size", 10000))
        items = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))[:size]
        return {"buckets": [{"key": k, "doc_count": c} for k, c in items]}

    if spec.type in ("range", "date_range"):
        is_date = spec.type == "date_range"
        partials = [compute_partial(spec, v) for v in views]
        ranges = spec.body["ranges"]
        buckets = []
        for i, r in enumerate(ranges):
            count = sum(p["range_counts"][i] for p in partials)
            key = r.get("key")
            if key is None:
                lo = r.get("from", "*")
                hi = r.get("to", "*")
                key = f"{lo}-{hi}"
            b = {"key": key, "doc_count": count}
            if "from" in r:
                b["from"] = parse_date(r["from"]) if is_date else float(r["from"])
            if "to" in r:
                b["to"] = parse_date(r["to"]) if is_date else float(r["to"])
            if spec.subs:
                sub_views = [
                    v.with_mask(_range_bucket_mask(v, spec.body["field"], r, is_date))
                    for v in views
                ]
                b.update(run_aggregations(spec.subs, sub_views))
            buckets.append(b)
        return {"buckets": buckets}

    raise ParsingException(f"Unsupported aggregation type [{spec.type}]")


def _nested_view(v: SegmentView, nctx, root_mask: np.ndarray,
                 root_view: SegmentView) -> SegmentView:
    """A view over ``nctx``'s live objects whose doc ``root_mask``
    holds."""
    n = nctx.parent_of.shape[0]
    nseg = nctx.segment
    m = np.zeros(nseg.nd_pad + 1, dtype=bool)
    m[:n] = root_mask[nctx.parent_of] & nseg.live[:n]
    return SegmentView(nseg, m, v.shard_ctx, nested_ctx=nctx,
                       root_view=root_view)


def _with_subs(spec, doc_count: int, sub_views) -> dict:
    result = {"doc_count": doc_count}
    if spec.subs:
        result.update(run_aggregations(spec.subs, sub_views))
    return result


def _run_nested(spec, views) -> dict:
    """nested: from the matched docs to their objects at ``path``."""
    path = spec.body.get("path")
    sub_views = []
    for v in views:
        nctx = v.segment.nested.get(path)
        if nctx is None or nctx.segment.num_docs == 0:
            continue
        sub_views.append(_nested_view(v, nctx, v.mask, v))
    return _with_subs(spec, sum(int(sv.mask.sum()) for sv in sub_views),
                      sub_views)


def _run_reverse_nested(spec, views) -> dict:
    """reverse_nested: from the objects back to their enclosing docs, or
    on into another nested ``path`` of those docs."""
    target_path = spec.body.get("path")
    sub_views = []
    for v in views:
        nctx, rv = v.nested_ctx, v.root_view
        if nctx is None or rv is None:
            raise ParsingException(
                "Reverse nested aggregation must be nested in a nested "
                "aggregation")
        n = nctx.parent_of.shape[0]
        rm = np.zeros(rv.segment.nd_pad + 1, dtype=bool)
        rm[nctx.parent_of[np.flatnonzero(v.mask[:n])]] = True
        rm[: rv.segment.nd_pad] &= rv.segment.live
        if target_path is None:
            sub_views.append(SegmentView(rv.segment, rm, rv.shard_ctx,
                                         rv.scores))
            continue
        tctx = rv.segment.nested.get(target_path)
        if tctx is None or tctx.segment.num_docs == 0:
            continue
        sub_views.append(_nested_view(rv, tctx, rm, rv))
    return _with_subs(spec, sum(int(sv.mask.sum()) for sv in sub_views),
                      sub_views)


def _run_children(spec, views) -> dict:
    """children: from the matched docs to their children of ``type`` in
    every view (a child may live in any segment). A child counts when its
    parent id names a matched doc of any view, as the JAX package's id
    set has it: each segment's parent-id vocabulary maps once (cached) to
    each view's docs, and the matched masks are read through it."""
    from elasticsearch_tpu_torch.mapper.field_types import join_field_of
    from elasticsearch_tpu_torch.search.query_dsl import (
        _vocab_to_docs,
        join_children,
    )

    child_type = spec.body["type"]
    jf = None
    for v in views:
        if v.shard_ctx is not None:
            jf = join_field_of(v.shard_ctx.mapper_service)
            if jf is not None:
                break
    parents = [v for v in views if v.mask[: v.segment.nd_pad].any()] \
        if jf is not None else []
    sub_views = []
    total = 0
    for v in views:
        seg = v.segment
        mask = np.zeros_like(v.mask)
        children = (join_children(seg, jf.name, [child_type])
                    if parents else None)
        if children is not None:
            locals_, pords, pcol = children
            in_set = np.zeros(len(pcol.terms), bool)
            for pv in parents:
                docs = _vocab_to_docs(pv.segment, pcol.terms,
                                      f"joinvocab.{jf.name}.{seg.name}")
                ok = docs >= 0
                in_set[ok] |= pv.mask[docs[ok]]
            mask[locals_[in_set[pords]]] = True
        total += int(mask[: seg.nd_pad].sum())
        sub_views.append(v.with_mask(mask))
    return _with_subs(spec, total, sub_views)


def _run_significant_terms(spec, views) -> dict:
    """Foreground (matched) against background (all live) term counts,
    scored by JLH (bucket/significant/heuristics/JLHScore.java)."""
    terms_spec = AggSpec(spec.name, "terms", spec.body, [])
    fg = _merged_counts([compute_partial(terms_spec, v) for v in views])
    bg_views = [v.with_mask(np.concatenate([v.segment.live,
                                            np.zeros(1, bool)]))
                for v in views]
    bg = _merged_counts([compute_partial(terms_spec, v) for v in bg_views])
    fg_total = sum(int(v.mask[: v.segment.nd_pad].sum()) for v in views)
    bg_total = sum(v.segment.live_doc_count for v in views)
    size = int(spec.body.get("size", 10))
    min_doc_count = int(spec.body.get("min_doc_count", 3))
    scored = []
    for key, fg_count in fg.items():
        if fg_count < min_doc_count or fg_total == 0 or bg_total == 0:
            continue
        fg_rate = fg_count / fg_total
        bg_rate = bg.get(key, fg_count) / bg_total
        if fg_rate <= bg_rate:
            continue
        score = (fg_rate - bg_rate) * (fg_rate / max(bg_rate, 1e-12))
        scored.append((score, key, fg_count, bg.get(key, fg_count)))
    scored.sort(reverse=True)
    buckets = []
    for score, key, fg_count, bg_count in scored[:size]:
        b = {"key": key, "doc_count": fg_count, "score": score,
             "bg_count": bg_count}
        if spec.subs:
            sub_views = [
                v.with_mask(_term_bucket_mask(v, spec.body["field"], key))
                for v in views
            ]
            b.update(run_aggregations(spec.subs, sub_views))
        buckets.append(b)
    return {"doc_count": fg_total, "bg_count": bg_total, "buckets": buckets}


def _run_sampler(spec, views) -> dict:
    """The top-scoring ``shard_size`` matched docs a segment (SamplerAggregator);
    the diversified form also caps the docs per distinct value of
    ``field``."""
    shard_size = int(spec.body.get("shard_size", 100))
    max_per_value = int(spec.body.get("max_docs_per_value", 1))
    div_field = spec.body.get("field") if spec.type == "diversified_sampler" \
        else None
    sub_views = []
    total = 0
    for v in views:
        cand = np.nonzero(v.mask[: v.segment.nd_pad])[0]
        if v.scores is not None and cand.size:
            cand = cand[np.argsort(-v.scores[cand], kind="stable")]
        if div_field is not None and cand.size:
            col = _resolve_ordinal_field(v.segment, div_field)
            ncol = (v.segment.numeric_columns.get(div_field)
                    if col is None else None)
            per_value: Dict = {}
            kept = []
            for d in cand:
                if col is not None and col.exists[d]:
                    key = int(col.first_ord[d])
                elif ncol is not None and ncol.exists[d]:
                    key = float(ncol.first_value[d])
                else:
                    key = None  # undiversified docs are not capped
                if key is not None:
                    seen = per_value.get(key, 0)
                    if seen >= max_per_value:
                        continue
                    per_value[key] = seen + 1
                kept.append(d)
                if len(kept) >= shard_size:
                    break
            idx = np.asarray(kept, dtype=np.int64)
        else:
            idx = cand[:shard_size]
        mask = np.zeros_like(v.mask)
        mask[idx] = True
        total += int(idx.size)
        sub_views.append(v.with_mask(mask))
    out = {"doc_count": total}
    if spec.subs:
        out.update(run_aggregations(spec.subs, sub_views))
    return out


def _run_scripted_metric(spec, views) -> dict:
    """scripted_metric (metrics/scripted/), the JAX package's numeric
    form: ``map_script`` maps every doc of a view's segment to a value
    over its columns on the segment's device (``execute_columns``; a
    painless map runs once a doc on the host), each view sums its matched
    docs' values in float64 on that device, the partials add up on the
    host, and an optional ``reduce_script`` folds the total
    (``params._agg``). A map that divides by zero between scalars skips
    the view, as in the JAX package."""
    map_spec = spec.body.get("map_script")
    if map_spec is None:
        raise ParsingException("[scripted_metric] requires [map_script]")
    script = compile_script(map_spec)
    params = dict(spec.body.get("params") or {})
    partials = []
    for v in views:
        seg = v.segment
        nd = seg.nd_pad
        vals = script.execute_columns(
            segment_columns(seg, script.doc_fields), params)
        if vals is None:
            continue
        vals = torch.as_tensor(vals).to(seg.device, torch.float64)
        vals = vals.expand(nd) if vals.dim() == 0 else vals[:nd]
        mask = torch.from_numpy(np.ascontiguousarray(v.mask[:nd])).to(
            seg.device)
        partials.append(float(torch.where(mask, vals, 0.0).sum()))
    total = float(sum(partials))
    reduce_spec = spec.body.get("reduce_script")
    if reduce_spec is not None:
        total = compile_script(reduce_spec).execute(
            {}, {**params, "_agg": total})
    return {"value": total}


def _run_adjacency_matrix(spec, views) -> dict:
    filters = spec.body["filters"]
    keys = list(filters.keys())
    masks: Dict[str, List[np.ndarray]] = {}
    for key in keys:
        masks[key] = [
            _partial_filter(AggSpec(key, "filter", filters[key], []), v)["_mask"]
            for v in views]
    buckets = []
    sep = spec.body.get("separator", "&")
    for i, a in enumerate(keys):
        for j in range(i, len(keys)):
            b_key = keys[j]
            name = a if i == j else f"{a}{sep}{b_key}"
            count = 0
            combined_views = []
            for vi, v in enumerate(views):
                m = masks[a][vi] & masks[b_key][vi]
                count += int(m[: v.segment.nd_pad].sum())
                combined_views.append(v.with_mask(m))
            if count == 0:
                continue
            bucket = {"key": name, "doc_count": count}
            if spec.subs:
                bucket.update(run_aggregations(spec.subs, combined_views))
            buckets.append(bucket)
    return {"buckets": buckets}


def _sort_buckets(items: List[Tuple], order) -> List[Tuple]:
    if isinstance(order, list):
        order = order[0] if order else {"_count": "desc"}
    ((key, direction),) = order.items()
    reverse = str(direction).lower() == "desc"
    if key == "_count":
        return sorted(items, key=lambda kv: (-kv[1] if reverse else kv[1], str(kv[0])))
    if key in ("_key", "_term"):
        return sorted(items, key=lambda kv: kv[0], reverse=reverse)
    # sub-agg ordering unsupported pre-selection; fall back to count desc
    return sorted(items, key=lambda kv: (-kv[1], str(kv[0])))


def finalize_terms(spec: AggSpec, merged: Dict, sub_cb=None) -> dict:
    """Terms bucket selection/formatting from a merged {key: count} map,
    shared by the host reduce and the fused plane. ``sub_cb(key) -> dict``
    attaches sub-aggregation results per surviving bucket (host reduce
    only)."""
    size = int(spec.body.get("size", 10))
    order = spec.body.get("order", {"_count": "desc"})
    items = _sort_buckets(list(merged.items()), order)
    selected = items[:size]
    sum_other = sum(c for _, c in items[size:])
    buckets = []
    for key, count in selected:
        b = {"key": key, "doc_count": count}
        if sub_cb is not None:
            b.update(sub_cb(key))
        buckets.append(b)
    return {
        "doc_count_error_upper_bound": 0,
        "sum_other_doc_count": sum_other,
        "buckets": buckets,
    }


def finalize_histogram(spec: AggSpec, merged: Dict, is_date: bool,
                       sub_cb=None) -> dict:
    """Histogram/date_histogram bucket assembly from merged {key: count}
    (min_doc_count filtering, empty-bucket fill, key_as_string), shared by
    the host reduce and the fused plane. ``sub_cb(key, count) -> dict``."""
    min_doc_count = int(spec.body.get("min_doc_count",
                                      1 if not is_date else 0))
    keys = sorted(merged.keys())
    # date_histogram fills empty buckets between min and max (min_doc_count=0)
    if keys and min_doc_count == 0:
        interval = _date_interval_spec(spec.body)
        ms = (_date_interval_ms(interval) if is_date
              else float(spec.body["interval"]))
        if ms is not None:
            full, k = [], keys[0]
            while k <= keys[-1] and len(full) < 10000:
                full.append(k)
                k += ms if not is_date else int(ms)
            keys = [k for k in full]
    buckets = []
    for key in keys:
        count = merged.get(key, 0)
        if count < min_doc_count:
            continue
        b = {"key": key, "doc_count": count}
        if is_date:
            b["key_as_string"] = format_epoch_millis(int(key))
        if sub_cb is not None:
            b.update(sub_cb(key, count))
        buckets.append(b)
    return {"buckets": buckets}


def _term_bucket_mask(view: SegmentView, field: str, key) -> np.ndarray:
    seg = view.segment
    ocol = _resolve_ordinal_field(seg, field)
    mask = np.zeros_like(view.mask)
    if ocol is not None:
        o = ocol.ord_of(str(key))
        if o < 0:
            return mask
        sel = ocol.flat_ords[: ocol.count] == o
        mask[ocol.flat_docs[: ocol.count][sel]] = True
        return mask & view.mask
    col = _resolve_value_field(seg, field)
    if col is None:
        return mask
    sel = col.flat_values[: col.count] == float(key)
    mask[col.flat_docs[: col.count][sel]] = True
    return mask & view.mask


def _histo_bucket_mask(view: SegmentView, spec: AggSpec, key, is_date: bool) -> np.ndarray:
    seg = view.segment
    col = _resolve_value_field(seg, spec.body["field"])
    mask = np.zeros_like(view.mask)
    if col is None:
        return mask
    keys = _histogram_keys(spec, col.flat_values[: col.count], is_date)
    sel = keys == (int(key) if is_date else float(key))
    mask[col.flat_docs[: col.count][sel]] = True
    return mask & view.mask


def _range_bucket_mask(view: SegmentView, field: str, r: dict, is_date: bool) -> np.ndarray:
    seg = view.segment
    col = _resolve_value_field(seg, field)
    mask = np.zeros_like(view.mask)
    if col is None:
        return mask
    conv = (lambda v: float(parse_date(v))) if is_date else float
    lo = conv(r["from"]) if "from" in r else -np.inf
    hi = conv(r["to"]) if "to" in r else np.inf
    vals = col.flat_values[: col.count]
    sel = (vals >= lo) & (vals < hi)
    mask[col.flat_docs[: col.count][sel]] = True
    return mask & view.mask


# ---------------------------------------------------------------------------
# Pipeline aggregations (post-process the reduced tree)
# ---------------------------------------------------------------------------


def _buckets_path_values(out: dict, path: str) -> List[Optional[float]]:
    """Resolve 'agg>metric' or 'agg' paths against reduced output."""
    parts = path.split(">")
    top = out.get(parts[0])
    if top is None or "buckets" not in top:
        raise ParsingException(f"No bucket aggregation found for path [{path}]")
    buckets = top["buckets"]
    if isinstance(buckets, dict):
        buckets = list(buckets.values())
    values = []
    for b in buckets:
        node = b
        ok = True
        for p in parts[1:]:
            if p == "_count":
                node = b["doc_count"]
                continue
            metric = p.split(".")
            node = node.get(metric[0])
            if node is None:
                ok = False
                break
            if isinstance(node, dict):
                if len(metric) > 1:
                    node = node.get(metric[1])
                elif "value" in node:
                    node = node["value"]
        if not ok:
            values.append(None)
        elif isinstance(node, dict):
            values.append(node.get("value"))
        else:
            values.append(b["doc_count"] if len(parts) == 1 else node)
    if len(parts) == 1:
        values = [b["doc_count"] for b in buckets]
    return values


def _apply_pipeline(spec: AggSpec, out: dict) -> None:
    t = spec.type
    path = spec.body.get("buckets_path")
    if t == "bucket_script" or t == "bucket_selector":
        _apply_bucket_script(spec, out)
        return
    if t == "bucket_sort":
        _apply_bucket_sort(spec, out)
        return
    values = _buckets_path_values(out, path)
    parent = path.split(">")[0]
    buckets = out[parent]["buckets"]
    if isinstance(buckets, dict):
        buckets = list(buckets.values())
    if t == "derivative":
        prev = None
        for b, v in zip(buckets, values):
            if prev is not None and v is not None:
                b[spec.name] = {"value": v - prev}
            prev = v
    elif t == "serial_diff":
        lag = int(spec.body.get("lag", 1))
        for i, b in enumerate(buckets):
            if i >= lag and values[i] is not None and values[i - lag] is not None:
                b[spec.name] = {"value": values[i] - values[i - lag]}
    elif t == "cumulative_sum":
        acc = 0.0
        for b, v in zip(buckets, values):
            acc += v or 0.0
            b[spec.name] = {"value": acc}
    elif t == "moving_avg":
        window = int(spec.body.get("window", 5))
        model = spec.body.get("model", "simple")
        settings = spec.body.get("settings") or {}
        for i, b in enumerate(buckets):
            if i == 0:
                continue
            w = [v for v in values[max(0, i - window): i] if v is not None]
            if w:
                b[spec.name] = {"value": _movavg_model(w, model, settings)}
        predict = int(spec.body.get("predict", 0))
        # predictions append real buckets: only meaningful for list-shaped
        # bucket aggs (histogram family)
        if predict > 0 and buckets and isinstance(out[parent]["buckets"], list):
            _movavg_predict(spec, buckets, values, window, model, settings,
                            predict)
    elif t in ("avg_bucket", "sum_bucket", "min_bucket", "max_bucket", "stats_bucket"):
        vals = [v for v in values if v is not None]
        if t == "avg_bucket":
            out[spec.name] = {"value": sum(vals) / len(vals) if vals else None}
        elif t == "sum_bucket":
            out[spec.name] = {"value": sum(vals)}
        elif t == "min_bucket":
            out[spec.name] = {"value": min(vals) if vals else None}
        elif t == "max_bucket":
            out[spec.name] = {"value": max(vals) if vals else None}
        else:
            out[spec.name] = {
                "count": len(vals),
                "min": min(vals) if vals else None,
                "max": max(vals) if vals else None,
                "avg": sum(vals) / len(vals) if vals else None,
                "sum": sum(vals),
            }


def _movavg_model(w: List[float], model: str, settings: dict,
                  predict_steps: int = 0):
    """Moving-average models (SimpleModel, LinearModel, EwmaModel,
    HoltLinearModel, HoltWintersModel). With predict_steps > 0 returns a
    list of forecasts instead of the one-step smoothed value."""
    n = len(w)
    if model == "simple":
        v = sum(w) / n
        return [v] * predict_steps if predict_steps else v
    if model == "linear":
        num = sum((i + 1) * x for i, x in enumerate(w))
        den = n * (n + 1) / 2.0
        v = num / den
        return [v] * predict_steps if predict_steps else v
    alpha = float(settings.get("alpha", 0.3))
    if model == "ewma":
        s = w[0]
        for x in w[1:]:
            s = alpha * x + (1 - alpha) * s
        return [s] * predict_steps if predict_steps else s
    beta = float(settings.get("beta", 0.1))
    if model == "holt":
        s, prev_s = w[0], w[0]
        trend = (w[1] - w[0]) if n > 1 else 0.0
        for x in w[1:]:
            prev_s = s
            s = alpha * x + (1 - alpha) * (s + trend)
            trend = beta * (s - prev_s) + (1 - beta) * trend
        if predict_steps:
            return [s + (k + 1) * trend for k in range(predict_steps)]
        return s + trend
    if model == "holt_winters":
        gamma = float(settings.get("gamma", 0.3))
        period = int(settings.get("period", 1))
        mult = settings.get("type", "add") == "mult"
        if n < 2 * period:
            # not enough data to seed seasonality: degrade to holt
            return _movavg_model(w, "holt", settings, predict_steps)
        pad = float(settings.get("padding", 1e-10)) if mult else 0.0
        vals = [x + pad for x in w]
        # seed level/trend/seasonal from the first two periods
        s = sum(vals[:period]) / period
        trend = (sum(vals[period:2 * period]) - sum(vals[:period])) / (period ** 2)
        season = ([vals[i] / s for i in range(period)] if mult
                  else [vals[i] - s for i in range(period)])
        for i in range(period, n):
            x = vals[i]
            prev_s = s
            si = season[i % period]
            if mult:
                s = alpha * (x / max(si, 1e-12)) + (1 - alpha) * (s + trend)
            else:
                s = alpha * (x - si) + (1 - alpha) * (s + trend)
            trend = beta * (s - prev_s) + (1 - beta) * trend
            season[i % period] = (gamma * (x / max(s, 1e-12)) + (1 - gamma) * si
                                  if mult else gamma * (x - s) + (1 - gamma) * si)

        def forecast(k):
            si = season[(n + k) % period]
            base = s + (k + 1) * trend
            return base * si if mult else base + si
        if predict_steps:
            return [forecast(k) for k in range(predict_steps)]
        return forecast(0)
    raise ParsingException(f"Unknown MovAvg model [{model}]")


def _movavg_predict(spec: AggSpec, buckets: List[dict], values: List,
                    window: int, model: str, settings: dict,
                    predict: int) -> None:
    """Append `predict` forecast buckets past the series end (keys extend
    at the trailing key interval when numeric)."""
    w = [v for v in values[max(0, len(values) - window):] if v is not None]
    if not w:
        return
    forecasts = _movavg_model(w, model, settings, predict_steps=predict)
    keys = [b.get("key") for b in buckets]
    interval = None
    if (len(keys) >= 2 and isinstance(keys[-1], (int, float))
            and isinstance(keys[-2], (int, float))):
        interval = keys[-1] - keys[-2]
    is_date = bool(buckets and "key_as_string" in buckets[-1])
    for k, fv in enumerate(forecasts):
        nb = {"doc_count": 0, spec.name: {"value": fv}}
        if interval is not None:
            nb["key"] = keys[-1] + (k + 1) * interval
            if is_date:
                nb["key_as_string"] = format_epoch_millis(int(nb["key"]))
        buckets.append(nb)


_SCRIPT_ALLOWED = set("0123456789.+-*/()% eE<>=! &|")


def _eval_bucket_script(script: str, params: Dict[str, Optional[float]]) -> Optional[float]:
    """Tiny safe arithmetic evaluator for bucket_script (the reference uses
    Painless; this accepts +-*/%() and params.<name> references)."""
    expr = script
    for name, value in sorted(params.items(), key=lambda kv: -len(kv[0])):
        if value is None:
            return None
        expr = expr.replace(f"params.{name}", repr(float(value)))
    if not all(c in _SCRIPT_ALLOWED for c in expr):
        raise ParsingException(f"unsupported bucket_script [{script}]")
    try:
        return float(eval(expr, {"__builtins__": {}}, {}))  # noqa: S307 — sanitized above
    except ZeroDivisionError:
        return None
    except Exception as e:
        raise ParsingException(f"failed to evaluate bucket_script [{script}]: {e}") from e


def _apply_bucket_script(spec: AggSpec, out: dict) -> None:
    paths = spec.body["buckets_path"]
    script = spec.body["script"]
    if isinstance(script, dict):
        script = script.get("source") or script.get("inline")
    parents = {p.split(">")[0] for p in paths.values()}
    if len(parents) != 1:
        raise ParsingException("bucket_script paths must share one parent")
    parent = parents.pop()
    per_param = {name: _buckets_path_values(out, path) for name, path in paths.items()}
    buckets = out[parent]["buckets"]
    if isinstance(buckets, dict):
        buckets = list(buckets.values())
    keep = []
    for i, b in enumerate(buckets):
        params = {name: vals[i] for name, vals in per_param.items()}
        value = _eval_bucket_script(script, params)
        if spec.type == "bucket_selector":
            if value:  # truthy keeps the bucket
                keep.append(b)
        else:
            if value is not None:
                b[spec.name] = {"value": value}
    if spec.type == "bucket_selector":
        out[parent]["buckets"] = keep


def _apply_bucket_sort(spec: AggSpec, out: dict) -> None:
    # operates on sibling buckets; sort keys limited to doc_count/_key/metrics
    sorts = spec.body.get("sort", [])
    size = spec.body.get("size")
    from_ = int(spec.body.get("from", 0))
    for parent_name, parent in out.items():
        if not isinstance(parent, dict) or "buckets" not in parent:
            continue
        buckets = parent["buckets"]
        if isinstance(buckets, dict):
            continue
        for s in reversed(sorts):
            if isinstance(s, str):
                key, direction = s, "asc"
            else:
                ((key, spec_dir),) = s.items()
                direction = spec_dir.get("order", "asc") if isinstance(spec_dir, dict) else spec_dir

            def sort_key(b, key=key):
                if key == "_key":
                    return b.get("key")
                if key == "doc_count":
                    return b.get("doc_count")
                node = b.get(key)
                return node.get("value") if isinstance(node, dict) else node

            buckets.sort(key=sort_key, reverse=(direction == "desc"))
        if size is not None:
            parent["buckets"] = buckets[from_: from_ + int(size)]
        elif from_:
            parent["buckets"] = buckets[from_:]
        break  # bucket_sort applies to its sibling context: first bucket agg
