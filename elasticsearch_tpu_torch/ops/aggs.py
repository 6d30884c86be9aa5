"""Aggregation ops: per-ordinal counts and sums over matched docs.

Counterpart of ``elasticsearch_tpu/ops/aggs.py`` (``ordinal_counts``,
``ordinal_sums``). Both run the segment-sum kernel (``ops/segment_sum.py``)
for CUDA tensors and its plain version for CPU tensors. The JAX package
gates its Pallas kernel on the backend and on 2^24 contributions (f32
count exactness); the port's kernel counts in int32, so it needs neither.
"""

from __future__ import annotations

import torch

from elasticsearch_tpu_torch.ops.segment_sum import segment_counts_sums


def ordinal_counts(flat_docs, flat_ords, mask, n_ords: int):
    """Per-ordinal doc counts over matched docs (terms agg heart).

    flat_docs/flat_ords: the ordinal CSR column (int32; padding points at
    the sentinel doc). mask: [nd1] bool (matched & live). Returns
    [n_ords] int32."""
    contrib = mask[flat_docs.long()].to(torch.float32)
    count, _ = segment_counts_sums(flat_ords, contrib, n_ords=n_ords)
    return count


def ordinal_sums(flat_docs, flat_ords, mask, values_by_doc, n_ords: int):
    """Sum of a per-doc metric value, bucketed by ordinal. Accumulates in
    f32 like the JAX kernel path; returns [n_ords] float64."""
    docs = flat_docs.long()
    contrib = mask[docs].to(torch.float32)
    vals = values_by_doc[docs].to(torch.float32).contiguous()
    _, total = segment_counts_sums(flat_ords, contrib, vals, n_ords=n_ords,
                                   with_count=False)
    return total.to(torch.float64)
