"""Segment sum: per-bucket doc counts and value sums in one device pass.

Counterpart of ``elasticsearch_tpu/ops/pallas_aggs.py``:

    count[o] = sum_d [mask[d] > 0] [ord[d] == o]
    total[o] = sum_d [mask[d] > 0] [ord[d] == o] * sanitize(value[d])

Values are sanitized as the JAX wrapper does (NaN -> 0, clipped to
+-bf16-max). A CPU tensor runs the plain PyTorch version
(``torch.bincount``); a CUDA tensor launches the hand-written kernel in
``csrc/segment_sum.cu`` or raises. Counts accumulate as int32 in the
kernel, so they stay exact past 2^24; ``segment_aggregate`` returns them
as f32 like the JAX function, ``segment_counts_sums`` keeps them int.
The kernel's f32 sums go through atomics, so their order changes from
run to run (agreement with the plain version is to within a relative
1e-4 of each bucket's sum of |value|).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from elasticsearch_tpu_torch.ops import cuda_kernels

BF16_MAX = 3.3895313892515355e38


def sanitize_values(values: torch.Tensor) -> torch.Tensor:
    v = torch.nan_to_num(values.float(), nan=0.0, posinf=BF16_MAX,
                         neginf=-BF16_MAX)
    return torch.clamp(v, -BF16_MAX, BF16_MAX)


def _check(ords, mask, values) -> None:
    for name, t, dt in (("ords", ords, torch.int32),
                        ("mask", mask, torch.float32),
                        ("values", values, torch.float32)):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != ords.shape[0]:
            raise ValueError(f"{name} must be 1-D of length {ords.shape[0]}")
        if t.device != ords.device:
            raise ValueError(f"{name} is on {t.device}, ords on {ords.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def segment_sum_plain(ords, mask, values, *, n_ords: int, with_count: bool,
                      with_sum: bool):
    """Plain PyTorch version: bincount over the valid docs."""
    valid = (mask > 0.0) & (ords >= 0) & (ords < n_ords)
    o = ords[valid].long()
    count = (torch.bincount(o, minlength=n_ords).to(torch.int32)
             if with_count else None)
    total = None
    if with_sum:
        total = torch.bincount(o, weights=sanitize_values(values)[valid],
                               minlength=n_ords).to(torch.float32)
    return count, total


def _segment_sum_cuda(ords, mask, values, *, n_ords: int, with_count: bool,
                      with_sum: bool):
    dev = ords.device
    count = (torch.zeros(n_ords, dtype=torch.int32, device=dev)
             if with_count else None)
    total = (torch.zeros(n_ords, dtype=torch.float32, device=dev)
             if with_sum else None)
    nd = ords.shape[0]
    if nd == 0 or n_ords == 0:
        return count, total
    lib = cuda_kernels.library()
    rc = lib.estpu_segment_sum(
        ords.data_ptr(), mask.data_ptr(),
        values.data_ptr() if with_sum else None,
        count.data_ptr() if with_count else None,
        total.data_ptr() if with_sum else None,
        nd, n_ords, cuda_kernels.stream_ptr(dev))
    cuda_kernels.check(rc, "segment_sum")
    cuda_kernels.note_launch("segment_sum")
    return count, total


def segment_counts_sums(ords, mask, values=None, *, n_ords: int,
                        with_count: bool = True
                        ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(count [n_ords] int32 or None, total [n_ords] f32 or None)."""
    with_sum = values is not None
    if not (with_sum or with_count):
        raise ValueError("segment sum needs counts, sums or both")
    _check(ords, mask, values)
    kw = dict(n_ords=n_ords, with_count=with_count, with_sum=with_sum)
    if ords.device.type == "cpu":
        return segment_sum_plain(ords, mask, values, **kw)
    if ords.device.type != "cuda":
        raise ValueError(f"unsupported device {ords.device}")
    return _segment_sum_cuda(ords, mask, values, **kw)


def segment_aggregate(ords, mask, values=None, *, n_ords: int,
                      with_sum: bool = False, with_count: bool = True):
    """The JAX ``segment_aggregate`` contract: a tuple of (count [n_ords]
    f32 if with_count, total [n_ords] f32 if with_sum)."""
    if with_sum and values is None:
        raise ValueError("with_sum needs values")
    count, total = segment_counts_sums(
        ords, mask, values if with_sum else None, n_ords=n_ords,
        with_count=with_count)
    outs = []
    if with_count:
        outs.append(count.to(torch.float32))
    if with_sum:
        outs.append(total)
    return tuple(outs)
