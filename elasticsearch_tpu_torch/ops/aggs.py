"""Aggregation ops: per-ordinal counts and sums over matched docs.

Counterpart of ``elasticsearch_tpu/ops/aggs.py`` (``ordinal_counts``,
``ordinal_sums``). Both hand the ordinal CSR column, the match mask and
the doc values to the segment-sum kernel's gather form
(``ops/segment_sum.py``), which reads ``mask[flat_docs[i]]`` itself: on
the card a call issues the kernel's passes and nothing else. CPU tensors
run its plain version. The JAX package gates its Pallas kernel on the
backend and on 2^24 contributions (f32 count exactness); the port's
kernel counts in int32, so it needs neither.
"""

from __future__ import annotations

from elasticsearch_tpu_torch.ops import segment_sum


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
