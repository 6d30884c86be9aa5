"""Segment sum: per-bucket doc counts and value sums in one device pass.

Counterpart of ``elasticsearch_tpu/ops/pallas_aggs.py``:

    count[o] = sum_d [mask[d] > 0] [0 <= ord[d] < n_ords] [ord[d] == o]
    total[o] = sum_d [mask[d] > 0] [0 <= ord[d] < n_ords] [ord[d] == o]
               * sanitize(value[d])

Values are sanitized as the JAX wrapper does (NaN -> 0, clipped to
+-bf16-max). Two forms of input:

- ``segment_counts_sums(ords, mask, values)``: the f32-mask form, the
  contract of ``segment_aggregate``;
- ``segment_counts_sums_gathered(doc_index, ords, match, values_by_doc)``:
  the ordinal CSR column as it is staged, with the per-doc match mask and
  f64 doc values gathered inside the kernel (``mask[d] =
  match[doc_index[d]]``; a doc_index outside ``[0, nd1)`` contributes
  nothing). Its sums are f32, returned as f64.

A CPU tensor runs the plain PyTorch version (``torch.bincount``); a CUDA
tensor launches the hand-written kernels in ``csrc/segment_sum.cu`` or
raises ``KernelError``. Counts are int32 and exact; ``segment_aggregate``
returns them as f32 like the JAX function. ``segment_sum_plan`` chooses the
launch: on the shared-memory path (the histograms fit in shared memory)
the kernel's sums keep their bits from launch to launch; on the global
path (high cardinality) they go through float atomics and their last bits
vary. Either way they agree with the plain version within
``1e-4 * sum |value| + 1e-3`` of each bucket (``SUM_RTOL``, ``SUM_ATOL``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from elasticsearch_tpu_torch.ops import cuda_kernels
from elasticsearch_tpu_torch.ops.tile_scoring import (
    H100_BLOCK_SMEM_OPTIN,
    H100_SMS,
)

BF16_MAX = 3.3895313892515355e38
# the kernel's sums against the plain version's, per bucket
SUM_RTOL = 1e-4  # of the bucket's sum of |value|
SUM_ATOL = 1e-3

# csrc/segment_sum.cu's constants
UNROLL = 4  # kUnroll: 16-byte units a lane loads per array per step
MAX_WARPS = 16  # kMaxWarps
QUEUE = 32 * UNROLL * 4 + 32  # kQueue: a warp's queue of valid entries
COMBINE_SLICES = 32  # kCombineSlices: warps of a combine block
COMBINE_ORDS = 32  # kCombineOrds: ordinals of a combine block, a lane each
PATHS = {"smem": 0, "global": 1}  # kPathShared, kPathGlobal
# the plan's policy
WARPS = (16, 8, 4, 2)  # warps a CTA may take, most first
STEP_DOCS = 4 * 32 * UNROLL  # docs one warp takes in a step
MIN_DOCS_PER_CTA = 8 * STEP_DOCS  # one step of an 8-warp CTA


class SegmentSumPlan(NamedTuple):
    """How one call runs: the main pass's grid, and the combine pass."""

    path: str  # "smem": shared-memory histograms; "global": device atomics
    grid: int  # CTAs of the main pass
    threads: int  # threads of a main-pass CTA
    smem: int  # dynamic shared bytes of a main-pass CTA
    units_per_cta: int  # 16-byte units (4 docs) each CTA walks
    combine_blocks: int  # blocks of the combine pass; 0: none
    deterministic: bool  # the same inputs give the same total bits

    @property
    def kernels(self) -> int:
        return 1 + (self.combine_blocks > 0)


def segment_sum_smem(n_ords: int, warps: int, with_count: bool,
                     with_sum: bool, path: str) -> int:
    """Dynamic shared bytes of a main-pass CTA (``plan_smem`` in the CUDA
    source): on the shared path the count histogram and one sum histogram
    a warp (each padded to 4 words); then a queue of QUEUE ordinals a warp,
    and of QUEUE values a warp with sums."""
    n4 = (n_ords + 3) & ~3
    words = warps * QUEUE * (2 if with_sum else 1)
    if path == "smem":
        words += (n4 if with_count else 0) + (warps * n4 if with_sum else 0)
    return 4 * words


@functools.lru_cache(maxsize=1024)
def segment_sum_plan(nd: int, n_ords: int, with_count: bool, with_sum: bool,
                     n_sm: int = H100_SMS) -> SegmentSumPlan:
    """The launch for ``nd`` docs and ``n_ords`` buckets on a card of
    ``n_sm`` SMs (planned once per shape).

    One CTA an SM at most, each with at least MIN_DOCS_PER_CTA docs, so a
    small segment runs as one CTA; each CTA walks ``units_per_cta``
    16-byte units and none is left empty. A CTA takes as many warps as
    one step of its docs needs (16 for a 2^20-doc column), as far as its
    histograms and queues fit in shared memory; the shared path needs two
    warps' worth to fit, else the global path takes the warps its queues
    allow. The combine pass adds the shared path's partial histograms
    when there is more than one CTA (a block per 32 buckets), and zeroes
    the global path's outputs before its atomics."""
    n_units = -(-nd // 4)
    want = max(1, min(-(-nd // MIN_DOCS_PER_CTA), n_sm))
    units_per_cta = max(1, -(-n_units // want))
    grid = max(1, -(-n_units // units_per_cta))
    need = WARPS[-1]
    while need < WARPS[0] and need * STEP_DOCS < 4 * units_per_cta:
        need *= 2

    def fitting(path):
        return [w for w in WARPS if w <= need and segment_sum_smem(
            n_ords, w, with_count, with_sum, path) <= H100_BLOCK_SMEM_OPTIN]

    path = "smem" if fitting("smem") else "global"
    warps = fitting(path)[0]
    if path == "global":  # the zero pass: a grid-stride loop
        combine_blocks = max(1, min(-(-n_ords // (COMBINE_SLICES * 32)),
                                    4 * n_sm))
    else:
        combine_blocks = -(-n_ords // COMBINE_ORDS) if grid > 1 else 0
    return SegmentSumPlan(
        path, grid, 32 * warps,
        segment_sum_smem(n_ords, warps, with_count, with_sum, path),
        units_per_cta, combine_blocks, path == "smem" or not with_sum)


def sanitize_values(values: torch.Tensor) -> torch.Tensor:
    v = torch.nan_to_num(values.float(), nan=0.0, posinf=BF16_MAX,
                         neginf=-BF16_MAX)
    return torch.clamp(v, -BF16_MAX, BF16_MAX)


def _check(device, length: int, specs) -> None:
    """Each (name, tensor or None, dtypes) must be 1-D of ``length``,
    contiguous, on ``device``, of one of ``dtypes``."""
    for name, t, dtypes in specs:
        if t is None:
            continue
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}"
                            f", got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != length:
            raise ValueError(f"{name} must be 1-D of length {length}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, want {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bincounts(o, weights, n_ords, with_count, with_sum):
    count = (torch.bincount(o, minlength=n_ords).to(torch.int32)
             if with_count else None)
    total = None
    if with_sum:
        total = torch.bincount(o, weights=weights.double(),
                               minlength=n_ords).to(torch.float32)
    return count, total


def segment_sum_plain(ords, mask, values, *, n_ords: int, with_count: bool,
                      with_sum: bool):
    """Plain PyTorch version of the f32-mask form: bincount over the valid
    docs."""
    valid = (mask > 0.0) & (ords >= 0) & (ords < n_ords)
    weights = sanitize_values(values)[valid] if with_sum else None
    return _bincounts(ords[valid].long(), weights, n_ords, with_count,
                      with_sum)


def segment_sum_gathered_plain(doc_index, ords, match, values_by_doc=None, *,
                               n_ords: int, with_count: bool = True):
    """Plain PyTorch version of the gather form: the match bytes and f64
    values gathered at in-range doc indices, then bincount; the total is
    the f32 sum widened to f64."""
    with_sum = values_by_doc is not None
    inside = (doc_index >= 0) & (doc_index < match.shape[0])
    j = doc_index[inside].long()
    o = ords[inside]
    keep = match[j].bool() & (o >= 0) & (o < n_ords)
    weights = sanitize_values(values_by_doc[j[keep]]) if with_sum else None
    count, total = _bincounts(o[keep].long(), weights, n_ords, with_count,
                              with_sum)
    return count, (total.double() if with_sum else None)


def combine_partials_plain(part_cnt, part_tot):
    """Plain version of the combine pass, in its order: COMBINE_SLICES
    contiguous slices of the parts, each folded in order from zero, then
    the slices folded in order. Either input may be None. Every ordinal is
    folded on its own, so a partial row's padding changes nothing."""
    ref = part_cnt if part_cnt is not None else part_tot
    n_parts, n_ords = ref.shape
    per = -(-n_parts // COMBINE_SLICES)
    count = total = None
    if part_cnt is not None:
        count = part_cnt.sum(0, dtype=torch.int32)
    if part_tot is not None:
        total = torch.zeros(n_ords, dtype=torch.float32, device=ref.device)
        for s in range(COMBINE_SLICES):
            acc = torch.zeros_like(total)
            for b in range(min(s * per, n_parts), min(s * per + per,
                                                      n_parts)):
                acc = acc + part_tot[b]
            total = total + acc
    return count, total


# ----------------------------------------------------------------------
# The launches
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_combine(lib, part_cnt, part_tot, count, total, n_parts: int,
                    n_ords: int, blocks: int, stream) -> None:
    rc = lib.estpu_segment_sum_combine(
        part_cnt, part_tot, _ptr(count), _ptr(total),
        int(total is not None and total.dtype == torch.float64), n_parts,
        n_ords, blocks, stream)
    cuda_kernels.check(rc, "segment_sum_combine")
    cuda_kernels.note_launch("segment_sum_combine")


def _segment_sum_cuda(vectors, main, nd: int, n_ords: int, with_count: bool,
                      with_sum: bool, total_dtype):
    """Allocate outputs and scratch, then launch the plan's passes;
    ``main(lib, count, total, part_cnt, part_tot, plan, stream)`` calls the
    form's C entry point. ``vectors`` are the tensors the kernel reads 16
    bytes at a time."""
    for name, t in vectors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    dev = vectors[0][1].device
    plan = segment_sum_plan(nd, n_ords, with_count, with_sum,
                            _sm_count(dev.index or 0))
    count = (torch.empty(n_ords, dtype=torch.int32, device=dev)
             if with_count else None)
    total = (torch.empty(n_ords, dtype=total_dtype, device=dev)
             if with_sum else None)
    if n_ords == 0:
        return count, total
    lib = cuda_kernels.library()
    stream = cuda_kernels.stream_ptr(dev)
    part_cnt = part_tot = None
    if plan.path == "smem" and plan.grid > 1:
        # a partial row per CTA, n_ords padded to 4: 16-byte rows
        words = plan.grid * ((n_ords + 3) & ~3)
        scratch = torch.empty(words * (with_count + with_sum),
                              dtype=torch.int32, device=dev)
        base = scratch.data_ptr()
        part_cnt = base if with_count else None
        part_tot = base + 4 * words * with_count if with_sum else None
    elif plan.path == "global":
        _launch_combine(lib, None, None, count, total, 0, n_ords,
                        plan.combine_blocks, stream)
    rc = main(lib, _ptr(count), _ptr(total), part_cnt, part_tot, plan, stream)
    cuda_kernels.check(rc, "segment_sum")
    cuda_kernels.note_launch("segment_sum")
    if part_cnt is not None or part_tot is not None:
        _launch_combine(lib, part_cnt, part_tot, count, total, plan.grid,
                        n_ords, plan.combine_blocks, stream)
    return count, total


def _plan_args(plan: SegmentSumPlan):
    return (PATHS[plan.path], plan.grid, plan.threads, plan.smem,
            plan.units_per_cta)


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def segment_counts_sums(ords, mask, values=None, *, n_ords: int,
                        with_count: bool = True
                        ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The f32-mask form: (count [n_ords] int32 or None, total [n_ords]
    f32 or None)."""
    with_sum = values is not None
    if not (with_sum or with_count):
        raise ValueError("segment sum needs counts, sums or both")
    _check(ords.device, ords.shape[0], (
        ("ords", ords, (torch.int32,)), ("mask", mask, (torch.float32,)),
        ("values", values, (torch.float32,))))
    if _device_of(ords) == "cpu":
        return segment_sum_plain(ords, mask, values, n_ords=n_ords,
                                 with_count=with_count, with_sum=with_sum)
    nd = ords.shape[0]

    def main(lib, count, total, part_cnt, part_tot, p, stream):
        return lib.estpu_segment_sum(
            ords.data_ptr(), mask.data_ptr(), _ptr(values), count, total,
            part_cnt, part_tot, nd, n_ords, *_plan_args(p), stream)

    return _segment_sum_cuda(
        (("ords", ords), ("mask", mask), ("values", values)), main, nd,
        n_ords, with_count, with_sum, torch.float32)


def segment_counts_sums_gathered(doc_index, ords, match, values_by_doc=None,
                                 *, n_ords: int, with_count: bool = True
                                 ) -> Tuple[Optional[torch.Tensor],
                                            Optional[torch.Tensor]]:
    """The gather form over the ordinal CSR column: ``doc_index`` [nd]
    int32 (``flat_docs``), ``ords`` [nd] int32, ``match`` [nd1] bool or
    uint8, ``values_by_doc`` [nd1] float64 for sums. Returns (count
    [n_ords] int32 or None, total [n_ords] f64 or None)."""
    with_sum = values_by_doc is not None
    if not (with_sum or with_count):
        raise ValueError("segment sum needs counts, sums or both")
    dev = doc_index.device
    _check(dev, doc_index.shape[0], (
        ("doc_index", doc_index, (torch.int32,)),
        ("ords", ords, (torch.int32,))))
    _check(dev, match.shape[0], (
        ("match", match, (torch.bool, torch.uint8)),
        ("values_by_doc", values_by_doc, (torch.float64,))))
    if _device_of(doc_index) == "cpu":
        return segment_sum_gathered_plain(doc_index, ords, match,
                                          values_by_doc, n_ords=n_ords,
                                          with_count=with_count)
    nd, nd1 = doc_index.shape[0], match.shape[0]

    def main(lib, count, total, part_cnt, part_tot, p, stream):
        return lib.estpu_segment_sum_gathered(
            doc_index.data_ptr(), ords.data_ptr(), match.data_ptr(),
            _ptr(values_by_doc), count, total, part_cnt, part_tot, nd, nd1,
            n_ords, *_plan_args(p), stream)

    return _segment_sum_cuda(
        (("doc_index", doc_index), ("ords", ords)), main, nd, n_ords,
        with_count, with_sum, torch.float64)


def combine_partials(part_cnt, part_tot):
    """The combine pass alone over partial histograms ([n_parts, n_ords]
    int32 and f32, n_ords a multiple of 4, as the main pass writes them;
    either may be None): the kernel on the card, the plain version on the
    CPU. Returns (count int32 or None, total f32 or None)."""
    ref = part_cnt if part_cnt is not None else part_tot
    for name, t, dt in (("part_cnt", part_cnt, torch.int32),
                        ("part_tot", part_tot, torch.float32)):
        if t is not None and (t.dtype != dt or t.dim() != 2
                              or t.shape != ref.shape or t.shape[1] % 4
                              or t.device != ref.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [n_parts, n_ords] "
                             f"{dt} tensor beside the other, n_ords a "
                             f"multiple of 4")
    n_parts, n_ords = ref.shape
    if _device_of(ref) == "cpu":
        return combine_partials_plain(part_cnt, part_tot)
    count = (torch.empty(n_ords, dtype=torch.int32, device=ref.device)
             if part_cnt is not None else None)
    total = (torch.empty(n_ords, dtype=torch.float32, device=ref.device)
             if part_tot is not None else None)
    if n_ords:
        _launch_combine(cuda_kernels.library(), _ptr(part_cnt),
                        _ptr(part_tot), count, total, n_parts, n_ords,
                        max(1, -(-n_ords // COMBINE_ORDS)),
                        cuda_kernels.stream_ptr(ref.device))
    return count, total


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
