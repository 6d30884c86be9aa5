"""Aggregations: parse, per-segment partials, associative reduce.

Counterpart of ``elasticsearch_tpu/search/aggregations.py``, cut to the
``terms`` aggregation (and terms sub-aggregations): per-segment counts run
on the device through ``ops/aggs.ordinal_counts`` (the segment-sum kernel)
and fold into one global-ordinal count array; ``finalize_terms`` applies
``size``, the order (``_count`` descending then key, or ``_key``),
``sum_other_doc_count`` and ``doc_count_error_upper_bound``. Every other
aggregation type is a later slice and raises ``ParsingException``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.ops import aggs as agg_ops

SUPPORTED_TYPES = {"terms"}


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
        if t not in SUPPORTED_TYPES:
            raise ParsingException(
                f"Unknown aggregation type [{t}] for [{name}] (the PyTorch "
                f"port serves {sorted(SUPPORTED_TYPES)})")
        specs.append(AggSpec(name, t, spec[t], parse_aggs(sub_body)))
    return specs


class SegmentView:
    """One segment + the matched mask for the current (sub-)aggregation."""

    def __init__(self, segment, mask: np.ndarray):
        self.segment = segment
        self.mask = mask  # np bool [nd1], already includes live

    def with_mask(self, mask: np.ndarray) -> "SegmentView":
        return SegmentView(self.segment, mask)


def _resolve_value_field(segment, field: str):
    return segment.numeric_columns.get(field)


def _resolve_ordinal_field(segment, field: str):
    col = segment.ordinal_columns.get(field)
    if col is not None:
        return col
    # terms on "myfield" where the mapping used text + .keyword multi-field
    col = segment.ordinal_columns.get(f"{field}.keyword")
    if col is None and field in segment.field_norm_idx:
        # the JAX package builds text fielddata from the postings here
        raise ParsingException(
            f"terms aggregation on text field [{field}] (text fielddata) is "
            f"not supported by the PyTorch port yet")
    return col


def _f(seg, field):
    """The ordinal column name actually used for a field."""
    return field if field in seg.ordinal_columns else f"{field}.keyword"


def _device_counts(view: SegmentView, field: str, ocol) -> np.ndarray:
    seg = view.segment
    docs = seg.device_column(f"ord.{_f(seg, field)}.docs",
                             lambda: ocol.flat_docs)
    ords = seg.device_column(f"ord.{_f(seg, field)}.ords",
                             lambda: ocol.flat_ords)
    mask = torch.from_numpy(np.ascontiguousarray(view.mask)).to(seg.device)
    return agg_ops.ordinal_counts(docs, ords, mask, len(ocol.terms)).cpu().numpy()


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
    """Cross-segment terms counts in global ordinal space; None when a
    segment has a numeric column for the field (numeric terms keep the
    key-mapped path)."""
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


def run_aggregations(specs: List[AggSpec], views: List[SegmentView]) -> dict:
    """Execute an agg tree over segment views; returns the response dict
    keyed by agg name."""
    return {spec.name: _run_one(spec, views) for spec in specs}


def _run_one(spec: AggSpec, views: List[SegmentView]) -> dict:
    if spec.type != "terms":
        raise ParsingException(f"Unsupported aggregation type [{spec.type}]")
    merged = _terms_global_merge(spec, views)
    if merged is None:
        merged = {}
        for v in views:
            for k, c in _partial_terms(spec, v)["counts"].items():
                merged[k] = merged.get(k, 0) + c
    sub_cb = None
    if spec.subs:
        def sub_cb(key):
            sub_views = [
                v.with_mask(_term_bucket_mask(v, spec.body["field"], key))
                for v in views
            ]
            return run_aggregations(spec.subs, sub_views)
    return finalize_terms(spec, merged, sub_cb)


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
    """Terms bucket selection/formatting from a merged {key: count} map."""
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
