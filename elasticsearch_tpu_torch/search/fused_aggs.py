"""Fused on-device aggregations: the columnar doc-values plane.

Counterpart of ``elasticsearch_tpu/search/fused_aggs.py``. Without it the
mesh plane copies every slot's dense matched mask to the host and reduces
the aggregations there (``with_views``). With it, eligible aggregations
reduce on the device inside the mesh plane's launch: per-segment doc-value
columns are staged per slot (``MeshPlanExecutor.stage_doc_value_columns``)
and the slots' matched masks reduce into a few KB of partials a spec. Only
the partials cross to the host.

The result equals the host reduce byte for byte, by construction:

- **bucket codes are computed on the host at staging time** with the host
  reduce's own arithmetic (global ordinals for terms; the f64
  ``floor((v - offset) / interval)`` for histogram / date_histogram), so
  the device only counts int32 codes. Each slot's codes are offset by
  ``slot * nb`` when they stage, so one launch of the segment-sum kernel's
  f32-mask form counts a bucket spec over every slot at once (``n_ords =
  n_slots * nb``; code -1, no value, drops);
- **counts** are int32 (exact);
- **sums** ride an exact integer-digit decomposition: each value ``v``
  (eligible only when every value is an integer with ``|v| < 2^48`` and
  the column's ``sum(|v|) < 2^53``: epoch-millis dates, counters) is
  offset to ``u = v + 2^49`` and split into six 9-bit digits staged as
  int16 columns; per-slot digit sums stay below 2^31, and the host
  rebuilds the exact integer sum with Python integers. The ``sum(|v|) <
  2^53`` bound also makes the host reduce's own f64 sum exact, so both
  land on the same float;
- **min/max** split each value into ``(floor(v / 2^24), remainder)`` f32
  pairs (exact in the same range) and reduce lexicographically.

Anything outside that envelope (sub-aggregations, multi-valued fields,
calendar intervals, non-integer metric values, text fielddata, bucket
ranges past the caps, other agg types) keeps the host reduce over the
program's matched views, counted by the JAX package's reason names in
``agg_host_fallback_by_reason``, among them ``hbm_budget`` (the device
budget turned the doc-value columns away) and ``staging_fault`` (their
staging faulted terminally). The columns register in the device-memory
ledger as kind ``doc_values`` under the generation's scope; they hold
one row an occupied slot (``executor.n_occupied``).
"""

from __future__ import annotations

import logging

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import segment_sum
from elasticsearch_tpu_torch.search.aggregations import (
    AggSpec,
    _date_interval_ms,
    _finalize_metric,
    finalize_histogram,
    finalize_terms,
)

# metric sums: v is offset to u = v + VALUE_OFFSET and split into
# N_DIGITS base-2^DIGIT_BITS digits; 6 * 9 bits cover u < 2^54 and a
# per-slot digit sum stays < 512 * nd_pad < 2^31 for nd_pad <= 2^21
DIGIT_BITS = 9
DIGIT_BASE = 1 << DIGIT_BITS
N_DIGITS = 6
VALUE_OFFSET = 1 << 49
MAX_ABS_VALUE = 1 << 48
MAX_ABS_SUM = 1 << 53  # f64-exact bound for the host reduce's own sum
MAX_SLOT_DOCS = 1 << 21  # int32-exactness bound for per-slot digit sums
MM_SPLIT = float(1 << 24)  # min/max hi/lo split point (both halves f32-exact)

MAX_HIST_BUCKETS = 4096
MAX_TERMS_ORDS = 1 << 16

FUSED_BUCKET_TYPES = ("terms", "histogram", "date_histogram")
FUSED_METRIC_TYPES = ("min", "max", "sum", "avg", "stats", "value_count")

# request-body keys the fused formulation covers per agg type; anything
# else (missing, script, shard_size, calendar intervals, ...) keeps the
# host reduce, which owns the full surface
_ALLOWED_BODY = {
    "terms": {"field", "size", "order"},
    "histogram": {"field", "interval", "offset", "min_doc_count"},
    "date_histogram": {"field", "interval", "fixed_interval", "offset",
                       "min_doc_count"},
    "min": {"field"}, "max": {"field"}, "sum": {"field"},
    "avg": {"field"}, "stats": {"field"}, "value_count": {"field"},
}


class FusedAggPlan:
    """One query's resolved fused aggregation set.

    ``ops`` (aligned with ``specs``) are the static per-spec descriptors:

      ("empty",)                      field absent everywhere: no device
                                      work, finalize emits the empty frame
      ("bucket", col_key, nb)         terms / histogram / date_histogram:
                                      count int32 codes into [nb] buckets
      ("metric", base, mm, dig)       stats family over base+".ex" /
                                      ".mm" / ".dig" columns

    ``metas`` carry the host-side finalize context (vocab, bucket-key
    reconstruction parameters)."""

    __slots__ = ("specs", "ops", "metas")

    def __init__(self, specs: List[AggSpec], ops: List[tuple],
                 metas: List[dict]):
        self.specs = specs
        self.ops = ops
        self.metas = metas

    @property
    def statics(self) -> tuple:
        return tuple(self.ops)


def n_agg_outputs(statics: tuple) -> int:
    n = 0
    for op in statics:
        if op[0] == "bucket":
            n += 1
        elif op[0] == "metric":
            n += 1 + int(op[2]) + int(op[3])
    return n


# ---------------------------------------------------------------------------
# Device-side partials
# ---------------------------------------------------------------------------


def emit_agg_partials(statics: tuple, cols: dict, mask: torch.Tensor
                      ) -> List[torch.Tensor]:
    """The partial accumulators of every slot for one member's specs.
    ``cols``: the executor's staged columns ([n_slots, nd1, ...]);
    ``mask``: bool [n_slots, nd1], each slot's agg-visible matched mask
    (after min_score, before post_filter, live applied). Output order
    matches ``n_agg_outputs``, each a tensor with a leading [n_slots] axis
    (bucket counts [n_slots, nb] int32, count [n_slots, 1] int32, min/max
    [n_slots, 4] f32, digit sums [n_slots, N_DIGITS] int32).

    A bucket spec is one launch of the segment-sum kernel's f32-mask form
    over all slots: the staged codes carry their slot's ``slot * nb``
    offset. The metrics are plain masked reductions, as they are XLA ops in
    the JAX package."""
    n_slots = mask.shape[0]
    outs: List[torch.Tensor] = []
    contrib = None
    for op in statics:
        if op[0] == "empty":
            continue
        if op[0] == "bucket":
            _, key, nb = op
            if contrib is None:
                contrib = mask.reshape(-1).to(torch.float32)
            count, _ = segment_sum.segment_counts_sums(
                cols[key].reshape(-1), contrib, n_ords=n_slots * nb)
            outs.append(count.reshape(n_slots, nb))
            continue
        _, base, want_mm, want_dig = op
        sel = mask & cols[base + ".ex"]
        outs.append(sel.sum(dim=1, dtype=torch.int32)[:, None])
        if want_mm:
            mm = cols[base + ".mm"]  # [n_slots, nd1, 2] f32
            hi, lo = mm[..., 0], mm[..., 1]
            inf = torch.full_like(hi, math.inf)
            minhi = torch.where(sel, hi, inf).amin(dim=1)
            minlo = torch.where(sel & (hi == minhi[:, None]), lo,
                                inf).amin(dim=1)
            maxhi = torch.where(sel, hi, -inf).amax(dim=1)
            maxlo = torch.where(sel & (hi == maxhi[:, None]), lo,
                                -inf).amax(dim=1)
            outs.append(torch.stack([minhi, minlo, maxhi, maxlo], dim=1))
        if want_dig:
            dig = cols[base + ".dig"]  # [n_slots, nd1, N_DIGITS] int16
            outs.append(torch.where(sel[..., None], dig,
                                    torch.zeros_like(dig)).sum(
                dim=1, dtype=torch.int32))
    return outs


# ---------------------------------------------------------------------------
# Eligibility + column builds (host side, once per executor generation)
# ---------------------------------------------------------------------------


def _metric_field_checks(executor, field: str) -> dict:
    """Column-wide eligibility facts for a numeric field, cached on the
    executor (one scan per field per staged generation)."""
    cache = executor._agg_field_checks
    hit = cache.get(field)
    if hit is not None:
        return hit
    cols = [s.numeric_columns.get(field) for s in executor.segments]
    present = [c for c in cols if c is not None and c.count > 0]
    facts = {"present": bool(present), "single": True, "finite": True,
             "int48": True, "abs_sum_ok": True}
    abs_sum = 0.0
    for c in present:
        vals = c.flat_values[: c.count]
        if c.count != int(c.exists.sum()):
            facts["single"] = False
        if not np.all(np.isfinite(vals)):
            facts["finite"] = False
            continue
        if not (np.all(vals == np.floor(vals))
                and np.all(np.abs(vals) < MAX_ABS_VALUE)):
            facts["int48"] = False
        abs_sum += float(np.abs(vals).sum())
    if abs_sum >= MAX_ABS_SUM:
        facts["abs_sum_ok"] = False
    cache[field] = facts
    return facts


def _build_bucket_codes(executor, per_seg_codes, nb: int) -> np.ndarray:
    """[n_occupied, nd1] int32 codes from per-segment local codes (length
    seg.nd_pad, -1 = no value), each slot's offset by ``slot * nb``."""
    out = np.full((executor.n_occupied, executor.nd1), -1, np.int32)
    for i, codes in enumerate(per_seg_codes):
        if codes is not None:
            out[i, : codes.shape[0]] = np.where(codes >= 0, codes + i * nb,
                                                -1)
    return out


def _resolve_terms(spec, executor, ops, metas, builds) -> Optional[str]:
    from elasticsearch_tpu_torch.index.global_ordinals import global_ordinals

    field = spec.body.get("field")
    segs = executor.segments
    ocols = [s.ordinal_columns.get(field)
             or s.ordinal_columns.get(f"{field}.keyword") for s in segs]
    if all(o is None for o in ocols):
        if any(s.numeric_columns.get(field) is not None for s in segs):
            return "field_ineligible"  # numeric terms: host path
        if any(s.terms_for_field(field) for s in segs):
            # text fielddata: the fused plane stages sealed keyword
            # ordinals only
            return "field_ineligible"
        ops.append(("empty",))
        metas.append({"kind": "terms"})
        return None
    cache = executor._agg_field_checks
    single = cache.get(("ord_single", field))
    if single is None:
        single = all(o is None or o.count == int(o.exists.sum())
                     for o in ocols)
        cache[("ord_single", field)] = single
    if not single:
        return "multi_valued"
    gords = global_ordinals(segs, field, columns=ocols)
    nb = len(gords.terms)
    if nb > MAX_TERMS_ORDS:
        return "bucket_range"
    if nb == 0:
        ops.append(("empty",))
        metas.append({"kind": "terms"})
        return None
    name = f"maggs.ord.{field}"
    if name not in executor._seg_staged and name not in builds:
        def build(gords=gords, ocols=list(ocols), name=name, nb=nb):
            per_seg = []
            for s, o in zip(segs, ocols):
                if o is None:
                    per_seg.append(None)
                    continue
                gmap = gords.seg_map(s)
                codes = np.where(
                    o.exists, gmap[np.clip(o.first_ord, 0, None)],
                    np.int32(-1)).astype(np.int32)
                per_seg.append(codes)
            return {name: _build_bucket_codes(executor, per_seg, nb)}

        builds[name] = build
    ops.append(("bucket", name, nb))
    # read-only reference: the GlobalOrdinals cache owns the list
    metas.append({"kind": "terms", "vocab": gords.terms})
    return None


def _resolve_histogram(spec, executor, ops, metas, builds) -> Optional[str]:
    from elasticsearch_tpu_torch.common.errors import ParsingException

    is_date = spec.type == "date_histogram"
    body = spec.body
    field = body.get("field")
    if is_date:
        interval_spec = body.get("interval") or body.get("fixed_interval")
        if interval_spec is None:
            return "unsupported_params"
        try:
            ms = _date_interval_ms(interval_spec)
        except ParsingException:
            return "field_ineligible"  # the host path owns the 400
        if ms is None:
            return "unsupported_params"  # calendar interval
        interval = float(ms)
    else:
        try:
            interval = float(body["interval"])
        except (KeyError, TypeError, ValueError):
            return "field_ineligible"  # the host path owns the 400
        if not (interval > 0):
            return "field_ineligible"
    offset = body.get("offset", 0) or 0
    if isinstance(offset, bool) or not isinstance(offset, (int, float)):
        return "unsupported_params"
    offset = float(offset)
    segs = executor.segments
    cols = [s.numeric_columns.get(field) for s in segs]
    if all(c is None or c.count == 0 for c in cols):
        ops.append(("empty",))
        metas.append({"kind": "hist", "is_date": is_date})
        return None
    facts = _metric_field_checks(executor, field)
    if not facts["single"]:
        return "multi_valued"
    if not facts["finite"]:
        return "values_not_fusable"
    # the bucket range is an O(corpus) column scan: cache the verdict per
    # (field, interval, offset) on the executor generation
    cache = executor._agg_field_checks
    name = (f"maggs.hist.{field}.{spec.type}.{interval!r}.{offset!r}")
    cached = cache.get(("hist", name))
    if cached is None:
        b_min = b_max = None
        for c in cols:
            if c is None or c.count == 0:
                continue
            b = np.floor((c.first_value - offset)
                         / interval).astype(np.int64)
            bv = b[c.exists]
            if bv.size:
                lo, hi = int(bv.min()), int(bv.max())
                b_min = lo if b_min is None else min(b_min, lo)
                b_max = hi if b_max is None else max(b_max, hi)
        if b_min is None:
            cached = ("empty",)
        else:
            nb = b_max - b_min + 1
            if nb <= 0 or nb > MAX_HIST_BUCKETS:
                # <= 0 only under int64-overflowed bucket indices from
                # extreme values: the same fallback as an oversized range
                cached = ("reason", "bucket_range")
            else:
                cached = ("ok", int(b_min), int(nb))
        cache[("hist", name)] = cached
    if cached[0] == "empty":
        ops.append(("empty",))
        metas.append({"kind": "hist", "is_date": is_date})
        return None
    if cached[0] == "reason":
        return cached[1]
    _tag, b_min, nb = cached
    if name not in executor._seg_staged and name not in builds:
        # exact host-side bucketing (the host reduce's own f64 formula),
        # once per staged generation; the device counts the int32 codes
        def build(cols=list(cols), b_min=b_min, name=name, nb=nb):
            per_seg = []
            for c in cols:
                if c is None or c.count == 0:
                    per_seg.append(None)
                    continue
                b = np.floor((c.first_value - offset)
                             / interval).astype(np.int64)
                codes = np.where(c.exists, b - b_min,
                                 np.int64(-1)).astype(np.int32)
                per_seg.append(codes)
            return {name: _build_bucket_codes(executor, per_seg, nb)}

        builds[name] = build
    ops.append(("bucket", name, int(nb)))
    metas.append({"kind": "hist", "is_date": is_date, "interval": interval,
                  "offset": offset, "min_b": int(b_min)})
    return None


def _resolve_metric(spec, executor, ops, metas, builds) -> Optional[str]:
    field = spec.body.get("field")
    segs = executor.segments
    cols = [s.numeric_columns.get(field) for s in segs]
    if all(c is None or c.count == 0 for c in cols):
        if any(s.ordinal_columns.get(field) is not None
               or s.ordinal_columns.get(f"{field}.keyword") is not None
               or s.terms_for_field(field) for s in segs):
            # the host reduce computes metrics over the ORDINAL values of
            # a keyword field: keep that surface on the host reduce
            return "field_ineligible"
        ops.append(("empty",))
        metas.append({"kind": "metric"})
        return None
    want_mm = spec.type in ("min", "max", "stats")
    want_dig = spec.type in ("sum", "avg", "stats")
    facts = _metric_field_checks(executor, field)
    if not facts["single"]:
        return "multi_valued"
    if not facts["finite"]:
        return "values_not_fusable"
    if (want_mm or want_dig) and not facts["int48"]:
        return "values_not_fusable"
    if want_dig and not facts["abs_sum_ok"]:
        return "values_not_fusable"
    if executor.nd1 > MAX_SLOT_DOCS:
        return "values_not_fusable"  # per-slot digit sums exceed int32
    base = f"maggs.num.{field}"
    staged = executor._seg_staged
    needed = [base + ".ex"]
    if want_mm:
        needed.append(base + ".mm")
    if want_dig:
        needed.append(base + ".dig")
    missing = [n for n in needed if n not in staged]
    if missing:
        # one build closure per field, keyed by ``base``: a second spec on
        # the same field with other component needs extends its name set
        entry = builds.get(base)
        if entry is not None:
            entry.names.update(missing)
        else:
            names = set(missing)

            # the name set travels as a default argument: a closure over
            # its own function would be a reference cycle holding the
            # generation (and its staged tensors) until a cycle collection
            def build_all(cols=list(cols), names=names):
                n_slots, nd1 = executor.n_occupied, executor.nd1
                out = {}
                if base + ".ex" in names:
                    out[base + ".ex"] = np.zeros((n_slots, nd1), bool)
                if base + ".mm" in names:
                    out[base + ".mm"] = np.zeros((n_slots, nd1, 2),
                                                 np.float32)
                if base + ".dig" in names:
                    out[base + ".dig"] = np.zeros(
                        (n_slots, nd1, N_DIGITS), np.int16)
                for i, c in enumerate(cols):
                    if c is None:
                        continue
                    n = c.exists.shape[0]
                    if base + ".ex" in out:
                        out[base + ".ex"][i, :n] = c.exists
                    v = c.first_value
                    if base + ".mm" in out:
                        hi = np.floor(v / MM_SPLIT)
                        out[base + ".mm"][i, :n, 0] = hi
                        out[base + ".mm"][i, :n, 1] = v - hi * MM_SPLIT
                    if base + ".dig" in out:
                        u = np.where(c.exists, v, 0.0).astype(np.int64) \
                            + np.int64(VALUE_OFFSET)
                        for k in range(N_DIGITS):
                            out[base + ".dig"][i, :n, k] = (
                                (u >> (DIGIT_BITS * k))
                                & (DIGIT_BASE - 1)).astype(np.int16)
                return out

            build_all.names = names
            builds[base] = build_all
    ops.append(("metric", base, want_mm, want_dig))
    metas.append({"kind": "metric"})
    return None


def resolve_fused_aggs(specs: List[AggSpec], executor
                       ) -> Tuple[Optional[FusedAggPlan], Optional[str]]:
    """Resolve a query's agg set against the staged segment set.

    Returns ``(plan, None)`` when EVERY spec is fused-eligible (staging any
    missing doc-value columns as a side effect), else ``(None, reason)``:
    all or nothing, so a response never mixes fused and host-reduced
    frames. A doc-value staging the budget turns away gives
    ``hbm_budget``, a terminal staging fault ``staging_fault``; a
    ``KernelError`` raises."""
    ops: List[tuple] = []
    metas: List[dict] = []
    builds: Dict[str, object] = {}
    for spec in specs:
        if spec.type not in FUSED_BUCKET_TYPES + FUSED_METRIC_TYPES:
            return None, "unsupported_agg"
        if spec.subs:
            return None, "sub_aggs"
        allowed = _ALLOWED_BODY[spec.type]
        if not isinstance(spec.body, dict) or set(spec.body) - allowed:
            return None, "unsupported_params"
        if not isinstance(spec.body.get("field"), str):
            return None, "field_ineligible"
        if spec.type == "terms":
            reason = _resolve_terms(spec, executor, ops, metas, builds)
        elif spec.type in ("histogram", "date_histogram"):
            reason = _resolve_histogram(spec, executor, ops, metas, builds)
        else:
            reason = _resolve_metric(spec, executor, ops, metas, builds)
        if reason is not None:
            return None, reason
    if builds:
        from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError

        try:
            staged = executor.stage_doc_value_columns(builds)
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — a terminal classified staging
            # fault (run_staged retried and recorded it): only the device
            # staging step reports staging_fault
            logging.getLogger("elasticsearch_tpu_torch.search.fused_aggs"
                              ).warning(
                "fused-agg doc-value staging failed; aggregations serve "
                "from the host reduce", exc_info=True)
            return None, "staging_fault"
        if not staged:
            return None, "hbm_budget"
    return FusedAggPlan(list(specs), ops, metas), None


# ---------------------------------------------------------------------------
# Host-side finalize (exact reconstruction + shared bucket assembly)
# ---------------------------------------------------------------------------


def finalize_fused(plan: FusedAggPlan, outs: List[np.ndarray],
                   n_real: int) -> dict:
    """Reduce the per-slot partials (``outs``: one [n_slots, ...] array per
    ``n_agg_outputs`` entry; the first ``n_real`` rows are staged
    segments) into the response dict: the host reduce's bytes, by the
    module's exactness contract (integer counts, integer sum
    reconstruction, lexicographic min/max merge, shared bucket
    assembly)."""
    result: dict = {}
    pos = 0
    for spec, op, meta in zip(plan.specs, plan.ops, plan.metas):
        kind = meta["kind"]
        if op[0] == "empty":
            if kind == "terms":
                result[spec.name] = finalize_terms(spec, {})
            elif kind == "hist":
                result[spec.name] = finalize_histogram(
                    spec, {}, meta["is_date"])
            else:
                result[spec.name] = _finalize_metric(spec, [])
            continue
        if op[0] == "bucket":
            counts = np.asarray(outs[pos][:n_real],
                                np.int64).sum(axis=0)
            pos += 1
            if kind == "terms":
                vocab = meta["vocab"]
                merged = {vocab[i]: int(c)
                          for i, c in enumerate(counts.tolist()) if c > 0}
                result[spec.name] = finalize_terms(spec, merged)
            else:
                interval, offset = meta["interval"], meta["offset"]
                merged = {}
                for i, c in enumerate(counts.tolist()):
                    if c <= 0:
                        continue
                    b = np.float64(meta["min_b"] + i)
                    if meta["is_date"]:
                        # the host reduce's per-value expression with the
                        # bucket index substituted: identical f64 ops
                        key = int(np.int64(b * interval + offset))
                    else:
                        key = float(b * interval + offset)
                    merged[key] = int(c)
                result[spec.name] = finalize_histogram(
                    spec, merged, meta["is_date"])
            continue
        # metric
        _, _base, want_mm, want_dig = op
        count = int(np.asarray(outs[pos][:n_real], np.int64).sum())
        pos += 1
        vmin, vmax, total = math.inf, -math.inf, 0.0
        if want_mm:
            mm = np.asarray(outs[pos][:n_real], np.float64)
            pos += 1
            # lexicographic (hi, lo) merge across slots; empty slots carry
            # inf/-inf sentinels and drop here
            mins = [(r[0], r[1]) for r in mm if np.isfinite(r[0])]
            maxs = [(r[2], r[3]) for r in mm if np.isfinite(r[2])]
            if mins:
                h, lo = min(mins)
                vmin = float(h) * MM_SPLIT + float(lo)
            if maxs:
                h, lo = max(maxs)
                vmax = float(h) * MM_SPLIT + float(lo)
        if want_dig:
            digs = np.asarray(outs[pos][:n_real], np.int64)
            pos += 1
            tot_u = 0
            for k in range(N_DIGITS):
                tot_u += int(digs[:, k].sum()) << (DIGIT_BITS * k)
            # exact integer sum; < 2^53 by the eligibility bound, so the
            # float conversion is exact
            total = float(tot_u - count * VALUE_OFFSET)
        result[spec.name] = _finalize_metric(spec, [{
            "count": count, "sum": total, "min": vmin, "max": vmax,
            "sq": 0.0}])
    return result
