"""Aggregation ops: bucket counts and sums, stats, HLL++ cardinality.

Counterpart of ``elasticsearch_tpu/ops/aggs.py``. Every function takes
tensors on one device (the view's mask and the segment's columns) and
returns tensors there, except the host-side helpers (``hll_estimate``,
the hashing, ``hll_bucket_rho``), which are numpy as in the JAX package.

- ``ordinal_counts`` / ``ordinal_sums`` hand the ordinal CSR column, the
  match mask and the doc values to the segment-sum kernel's gather form
  (``ops/segment_sum.py``), which reads ``mask[flat_docs[i]]`` itself;
- ``histogram_counts`` / ``value_histogram_sums`` compute each value's
  bucket in float64 (the int64 rebase, and the validity test made on the
  int64 bucket before it narrows to int32, as the JAX kernel path does)
  and hand the buckets to the kernel's f32-mask form, which drops
  ordinals outside ``[0, n_buckets)``;
- ``range_counts``, ``numeric_stats``, ``value_count``,
  ``masked_values_for_sample`` and the HLL register scatter-max are XLA
  ops in the JAX package, outside any Pallas kernel; here they are plain
  torch ops (masked reductions, ``scatter_reduce_``).

On the card a kernel-2 call issues the kernel's passes; CPU tensors run
its plain version. The JAX package gates its Pallas kernel on the backend
and on 2^24 contributions (f32 count exactness); the port's kernel counts
in int32, so it needs neither. Sums through the kernel are f32, widened to
f64, as on the JAX kernel path.

HLL++: torch has no unsigned 64-bit shifts on every device, so each
value's 64-bit hash is mixed (``_fmix64``) and split into its register
index and rank on the host with numpy ``uint64`` (``hll_bucket_rho``, the
JAX package's formula bit for bit); callers cache the pair per column and
precision, and the device does the masked scatter-max.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import segment_sum

HLL_DEFAULT_PRECISION = 14  # ES default precision_threshold ~3000 -> p 14


# ---------------------------------------------------------------------------
# Bucket aggs
# ---------------------------------------------------------------------------


def ordinal_counts(flat_docs, flat_ords, mask, n_ords: int):
    """Per-ordinal doc counts over matched docs (terms agg heart).

    flat_docs/flat_ords: the ordinal CSR column (int32; padding points at
    the sentinel doc). mask: [nd1] bool (matched & live). Returns
    [n_ords] int32."""
    count, _ = segment_sum.segment_counts_sums_gathered(
        flat_docs, flat_ords, mask, n_ords=n_ords)
    return count


def ordinal_sums(flat_docs, flat_ords, mask, values_by_doc, n_ords: int):
    """Sum of a per-doc metric value ([nd1] float64), bucketed by ordinal.
    Accumulates in f32 like the JAX kernel path; returns [n_ords]
    float64."""
    _, total = segment_sum.segment_counts_sums_gathered(
        flat_docs, flat_ords, mask, values_by_doc, n_ords=n_ords,
        with_count=False)
    return total


def _histogram_buckets(flat_docs, flat_values, mask, interval, offset,
                       min_bucket_key, n_buckets: int):
    """(bucket int32 [n_vals], contrib f32 [n_vals]): the f64 bucket of each
    value rebased by ``min_bucket_key`` in int64; an invalid entry (doc not
    matched, bucket out of range) gets -1 and 0."""
    vals = flat_values.to(torch.float64)
    bucket64 = (torch.floor((vals - float(offset)) / float(interval))
                .to(torch.int64) - int(min_bucket_key))
    valid = mask[flat_docs.long()] & (bucket64 >= 0) & (bucket64 < n_buckets)
    bucket = torch.where(valid, bucket64, torch.full_like(bucket64, -1))
    return bucket.to(torch.int32), valid.to(torch.float32)


def histogram_counts(flat_docs, flat_values, mask, interval, offset,
                     min_bucket_key, n_buckets: int):
    """Fixed-interval histogram: bucket = floor((v - offset)/interval),
    rebased by min_bucket_key; out-of-range values drop (callers size the
    bucket range from segment min/max so nothing real drops). Returns
    [n_buckets] int32."""
    bucket, contrib = _histogram_buckets(flat_docs, flat_values, mask,
                                         interval, offset, min_bucket_key,
                                         n_buckets)
    count, _ = segment_sum.segment_counts_sums(bucket, contrib,
                                               n_ords=n_buckets)
    return count


def value_histogram_sums(flat_docs, flat_values, metric_by_doc, mask,
                         interval, offset, min_bucket_key, n_buckets: int):
    """Sum of a per-doc metric grouped by histogram bucket of this field.
    Accumulates in f32 like the JAX kernel path; returns [n_buckets]
    float64."""
    bucket, contrib = _histogram_buckets(flat_docs, flat_values, mask,
                                         interval, offset, min_bucket_key,
                                         n_buckets)
    vals = metric_by_doc[flat_docs.long()].to(torch.float32)
    _, total = segment_sum.segment_counts_sums(
        bucket, contrib, vals.contiguous(), n_ords=n_buckets,
        with_count=False)
    return total.to(torch.float64)


def range_counts(flat_docs, flat_values, mask, lo, hi, n_ranges: int):
    """Counts per [lo_i, hi_i) range (range agg; ranges may overlap).
    lo/hi: [n_ranges] float64. Counts DOCS (not values): a doc lands in a
    range once even if several of its values do. Returns [n_ranges]
    int32."""
    nd1 = mask.shape[0]
    vals = flat_values.to(torch.float64)
    in_range = ((vals[None, :] >= lo[:n_ranges, None])
                & (vals[None, :] < hi[:n_ranges, None]))
    per_doc = torch.zeros((n_ranges, nd1), dtype=torch.int32,
                          device=mask.device)
    idx = flat_docs.long()[None, :].expand(n_ranges, -1)
    per_doc.scatter_reduce_(1, idx, in_range.to(torch.int32), "amax")
    return ((per_doc > 0) & mask[None, :]).sum(dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Metric aggs
# ---------------------------------------------------------------------------


def numeric_stats(flat_docs, flat_values, valid, mask):
    """(count, sum, min, max, sum_of_squares) over values of matched docs.

    valid: [n_vals] bool: real (non-padding) CSR entries."""
    sel = valid & mask[flat_docs.long()]
    vals64 = flat_values.to(torch.float64)
    vals = torch.where(sel, vals64, torch.zeros_like(vals64))
    count = sel.sum(dtype=torch.int64)
    total = vals.sum()
    sq = (vals * vals).sum()
    vmin = torch.where(sel, vals64, torch.full_like(vals64, np.inf)).min()
    vmax = torch.where(sel, vals64, torch.full_like(vals64, -np.inf)).max()
    return count, total, vmin, vmax, sq


def value_count(flat_docs, valid, mask):
    return (valid & mask[flat_docs.long()]).sum(dtype=torch.int64)


# --- HyperLogLog++ ---------------------------------------------------------


def _fmix64(h: np.ndarray) -> np.ndarray:
    h = np.asarray(h, dtype=np.uint64).copy()
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return h


def _clz64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64).copy()
    n = np.zeros(x.shape, np.int32)
    for shift in (32, 16, 8, 4, 2, 1):
        # if the top `shift` bits are empty, shift left and count
        empty = x < (np.uint64(1) << np.uint64(64 - shift))
        n = n + np.where(empty, shift, 0).astype(np.int32)
        x = np.where(empty, x << np.uint64(shift), x)
    return np.where(x == 0, 64, n).astype(np.int32)


def hll_bucket_rho(hashes: np.ndarray, precision: int = HLL_DEFAULT_PRECISION):
    """Each value's register index and rank from its 64-bit hash (host
    numpy ``uint64``): bucket = the top ``precision`` bits of
    ``_fmix64(hash)``, rho = 1 + the leading zeros of the rest with a stop
    bit. Returns (bucket int32, rho int32)."""
    h = _fmix64(hashes)
    bucket = (h >> np.uint64(64 - precision)).astype(np.int32)
    rest = (h << np.uint64(precision)) | np.uint64(1 << (precision - 1))
    return bucket, (_clz64(rest) + 1).astype(np.int32)


def hll_scatter(flat_docs, bucket, rho, valid, mask,
                precision: int = HLL_DEFAULT_PRECISION):
    """The registers from per-value (bucket, rho) tensors: register j is the
    largest rho of a matched value in bucket j. Returns [2^precision]
    int32."""
    sel = valid & mask[flat_docs.long()]
    r = torch.where(sel, rho, torch.zeros_like(rho))
    b = torch.where(sel, bucket, torch.zeros_like(bucket))
    regs = torch.zeros(1 << precision, dtype=torch.int32, device=mask.device)
    return regs.scatter_reduce_(0, b.long(), r, "amax")


def hll_registers(flat_docs, hashes, valid, mask,
                  precision: int = HLL_DEFAULT_PRECISION):
    """Build HLL++ registers from per-value 64-bit hashes (numpy uint64,
    see hash_numeric_values / hash_string_values). Register j = max over
    matched values with bucket j of (position of the first set bit of the
    remaining hash bits)."""
    bucket, rho = hll_bucket_rho(hashes, precision)
    dev = mask.device
    return hll_scatter(flat_docs, torch.from_numpy(bucket).to(dev),
                       torch.from_numpy(rho).to(dev), valid, mask, precision)


def hll_merge(regs_a, regs_b):
    """Associative register merge (cross-segment / cross-shard reduce)."""
    return torch.maximum(regs_a, regs_b)


def hll_estimate(registers: np.ndarray) -> float:
    """Harmonic-mean estimate with small-range correction (host side; the
    reference's HyperLogLogPlusPlus.cardinality())."""
    regs = np.asarray(registers)
    m = regs.shape[0]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / np.sum(np.power(2.0, -regs.astype(np.float64)))
    zeros = int(np.sum(regs == 0))
    if est <= 2.5 * m and zeros > 0:
        est = m * np.log(m / zeros)  # linear counting
    return float(est)


def hash_numeric_values(values: np.ndarray) -> np.ndarray:
    """Host-side 64-bit hashing of numeric values for HLL (once per segment
    column; cached). Uses the float64 bit pattern."""
    bits = np.asarray(values, dtype=np.float64).view(np.uint64)
    h = bits.copy()
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return h


def hash_string_values(terms) -> np.ndarray:
    """Hash a term dictionary (ordinal -> hash) for HLL over keywords."""
    out = np.empty(len(terms), dtype=np.uint64)
    for i, t in enumerate(terms):
        out[i] = np.frombuffer(
            hashlib.blake2b(t.encode("utf-8"), digest_size=8).digest(),
            dtype=np.uint64)[0]
    return out


# ---------------------------------------------------------------------------
# Percentiles: the host draws the sample and sorts exactly
# ---------------------------------------------------------------------------


def masked_values_for_sample(flat_docs, flat_values, valid, mask):
    """Values of matched docs, NaN elsewhere."""
    sel = valid & mask[flat_docs.long()]
    vals = flat_values.to(torch.float64)
    return torch.where(sel, vals, torch.full_like(vals, np.nan))
