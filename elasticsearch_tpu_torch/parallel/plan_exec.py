"""The mesh data plane on one device: a query over all of an index's
(shard, segment) pairs as one stacked program.

Counterpart of ``elasticsearch_tpu/parallel/plan_exec.py``, cut to one
device and to what the port's requests reach. The JAX package shards a
``[n_slots, ...]`` stacked copy of every segment over a device mesh and
runs one ``shard_map`` program; here the slot axis is the only axis
(``n_dev = 1``): the per-slot query phase runs slot by slot, and the
collectives become plain reductions in slot order (``psum`` a sum,
``all_gather`` a concatenation), so candidates merge in the JAX order.

- ``MeshPlanExecutor`` stages the stacked segment tables once, the tile
  kernel's plane (one shared tile geometry over the stacked doc space and
  each slot's live mask in it; the posting tables stay each segment's
  own) on first use, and runs
  - the serial program: per slot ``emit`` -> live -> min_score -> slice
    -> [agg view] -> post_filter -> count -> rank key (the score, or a
    staged sort key column) -> the search_after cut -> the rescore window
    pass -> local top-k, then the global top-k over the slots' candidates
    in slot order (ties to the lower slot, then the lower doc), with each
    top hit's raw sort value;
  - (from ``IndexMeshSearch.query_batch``) the batched program: per slot
    one fused top-k ``score_tiles`` launch for Q queries over the union
    of their lanes, per-query tile merge, then the merge over slots;
  - (the same, with ``search.pallas.pruning.enabled``) the pruned batched
    program, the one-device form of the JAX package's
    ``_mesh_batched_pruned_program``: every slot scores its probe tiles,
    the pools concatenate in slot order (``all_gather``'s order) and give
    the global threshold per query, each slot's rest tiles whose block-max
    bound cannot reach it are zeroed on the device, the rest pass runs,
    and the pools merge (probe, then rest). Nothing crosses to the host
    between the passes;
  - (from ``IndexMeshSearch.query_knn_batch``) the kNN program: per slot
    one ``knn_score_tiles`` launch (kernel 3) for Q query vectors,
    ``merge_knn_topk``, then one top-k over the slots' pools; the total is
    the sum of the slots' live-and-has-vector mask sums.
- ``IndexMeshSearch`` owns the staging lifecycle and the plane ladder:
  ``mesh_pallas`` (the tile kernel inside the program), then ``mesh``
  (scatter nodes), then None (the caller's host rung). ``PlaneHealth``
  benches a plane that raised, as in the JAX package, with one deviation:
  a ``KernelError`` (a kernel that fails to build, load or launch) is no
  plane fault and raises to the caller, so no rung serves in the kernel's
  place.

The staging lifecycle, as in the JAX package. A generation is staged with
slot headroom (``index.staging.delta.enabled``: one refresh's worth of
dead slots, up to ``index.search.mesh.max_slots_per_device``). A refresh
that adds segments within the free slots is a delta append: the successor
generation is built copy on write (a device-to-device gather of the old
rows into the canonical slot order, then the new slots' rows from the new
segments' own staged tensors), so its answers equal a rebuild's byte for
byte, ties included; the JAX package appends at the tail of the slot
order instead. A delete rewrites only its slots' live rows
(``apply_tombstones``). Anything else (a merge, exhausted slots, a codec
change) rebuilds. Every staged table registers in the device-memory ledger
(``common/memory.py``) under the generation's scope; the rebuild is gated
by ``search.memory.hbm_budget_bytes`` (a denial demotes with reason
``hbm_budget``) and runs through ``common/staging.run_staged`` (a terminal
fault benches the staging with reason ``staging_fault``; after the
cooldown one query probes the restage while its peers serve the host
rung). A budget eviction drops the generation; the next staging is a
``probe``. The owner's compaction pass (``IndexService.compact_now``)
restages a compact generation (reason ``compaction``).

Postings codec: the executor resolves its codec over the stacked doc
space (``resolve_postings_codec`` of the index's preference, the node's
default behind it), and each slot reads its segment's own tables in that
codec (``Segment.kernel_tables(codec)``). A segment whose own codec
differs (a small segment stamped packed in a stacked doc space above the
packed word's 2^20 docs) stages a second, raw copy for the mesh; no other
case copies. The session meta holds each slot's block-max column
(``bfmax``) in that codec.

Block-max pruning (``search.pallas.pruning.*``, docs/PRUNING.md of the
JAX package): a plain relevance-ranked request (one kernel-scored
disjunction, no counts, ``size > 0``, no aggs) is served by the pruned
program, serially through ``query`` (``Q == 1``) or in a burst through
``query_batch``; its totals count matches in scored tiles only, a lower
bound marked by the member's ``pruned`` entry (``total_relation:
"gte"``). The JAX package shrinks the tile for pruning (to reach ``2 *
probe`` tiles) down to ``sub = 8`` on a TPU (a mosaic sublane bound) and
to 1 in interpret mode; the port has no such bound and takes 1, what the
JAX package does as its tests run it. Under admission pressure the
brownout's first step forces pruning on for the requests it admitted
(``_pruning_config`` reads ``search.admission.forced_pruning``, the
request's own token, where the JAX package reads the live level at the
launch).

The kNN plane stages no second copy of the embeddings: each slot reads
its segment's own staged ``k_vec_*`` (and ``k_vecnorm_*`` for cosine,
the arrays the host rung reads) with the slot's real row count, and the
executor stages only each slot's live-and-has-vector mask in the shared
geometry (``nd_knn = max(nd_pad, 128)``), whose rows a tombstone or an
append rewrites. As on the tile plane, a ``KernelError`` raises
through ``query_knn_batch`` instead of benching the plane.

Aggregations (``search.aggs.fused``, ``index.search.aggs.fused``): when
every spec of a request is inside the fused envelope
(``search/fused_aggs.py``), its doc-value columns stage per slot
(``stage_doc_value_columns``: register then commit) and the slots'
matched masks reduce on the device in the same program: the serial
program's ``agg_static``, and for an agg-carrying burst the batched dense
agg program (``execute_batched_dense_agg``: one dense ``score_tiles``
launch a slot for the whole burst, kernel 1b raw or 1d packed, whose
scores both rank and aggregate; each member's mask reduces its own specs;
pruning never runs with aggregations). Otherwise the serial program hands
the per-slot matched masks and scores to the host reduce, counted per
reason in ``agg_host_fallback_by_reason``; a batch with such a member
leaves the batched rung. The ``doc_values`` columns register in the ledger
under the generation's scope; a budget denial or a terminal staging fault
demotes the aggregations to the host reduce (``hbm_budget``,
``staging_fault``), and a delta append drops them (they restage lazily).

Sort and paging, as in the JAX package: a one-field sort ranks by a
staged key column (``ensure_sort_column``: numeric and ``_doc`` columns
only when every value is exact in f32, keywords by global ordinals
below 2^24 terms, the missing fills at +-3e38; kind ``doc_values``), a
slice by a staged partition mask (``ensure_slice_column``, kind
``mesh_slot_tables``), both budget-gated; a delta append or a tombstone
drops them (a keyword sort's vocabulary spans every slot) and the next
request restages them. ``IndexMeshSearch.query`` maps the search_after
cursor into the key's oriented space (``_search_after_key``), runs one
rescorer's window per slot, groups the slots' counts by shard for
``terminate_after``, and sends a multi-field, ``ts``-like or custom
string-missing sort to the host rung (``sort_ineligible``), an inexact
cursor or chained rescorers (``feature_ineligible``) and collapse
(``unsupported_body``).

Nested and join clauses stack as ``DenseScoreNode`` (two dense columns
a slot). Their inner queries run on the host rung's executor: a nested
clause on the path's sub-segment of each slot (which stages on that first
use under its own ledger scope, owned by the index, and goes with its
root segment on a tombstone, a compaction, ``close`` and ``DELETE``), a
join clause over every segment of the slot's shard (its pass memoized by
shard, see ROADMAP C13). A slot whose plan is ``MatchNoneNode`` beside a
slot's ``DenseScoreNode`` does not stack (``shape_mismatch``) and the
host rung serves, as in the JAX package; a nested sort has no root
column and goes to the host rung (``sort_ineligible``); the nested and
children aggregations reduce on the host (``unsupported_agg``).

A request's deadline is checkpointed before and after the staging and
before each launch (never between a launch and the read of its output,
so an expired request leaves no work on the card and the ledger as it
was); expiry raises ``TimeExceededException`` to the caller, which
answers ``timed_out``. A profiled request's tracer records the staging,
plan build, program (to its synchronize), merge and aggregate spans; a
batch records them once and folds them into each profiled member, with
the batch's shape (and a pruned launch's tile economy) as annotations.
The ``stats`` groups of a served request count on every shard.

The pruning, kNN, fused-aggregation and delta-staging knobs are read
per request: a cluster-level override on the index (``Node``'s
``put_cluster_settings`` sets it while the cluster setting is explicit)
wins over the index's settings, which ``PUT /{index}/_settings`` may
change.

An index with ``index.sort.*`` is served by the host rung, whose
selection takes each segment's first k matching docs (decision
``index_sorted``), as in the JAX package.

Telemetry, fault injection and first-use accounting: every plane-ladder
decision also counts in the index's ``SearchTelemetry``
(``search.phases.decisions``), and each batched or kNN launch adds its
posting or embedding traffic once (``add_counters``). Before each plane
attempt ``testing/disruption.on_plane_execute`` runs, before each launch
``on_kernel_launch`` with its rung (``mesh_pallas``, ``mesh``,
``batched``, ``pruned``, ``knn``): a ``KernelError`` raised there
reaches the caller as a real launch failure does, and any other raise is
a plane fault, which quarantines the plane (``PlaneHealth``) and serves
from the next rung.
Each launch runs as one variant of ``common/compile_cache.run_variant``
(families ``serial``, ``batched``, ``batched_agg``, ``pruned``, ``knn``,
keyed by their shapes), whose first run in a process counts in the
``compile`` block, as warmed under a warm replay.

Left for later slices: stacking a full rebuild on the card instead of
through host numpy (a ``perf_opt``).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time as _time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.compile_cache import run_variant
from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import (
    INDEX_SEARCH_AGGS_FUSED,
    INDEX_SEARCH_MESH_MAX_SLOTS,
    INDEX_SEARCH_MESH_PLANE,
    INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN,
    INDEX_STAGING_DELTA_ENABLED,
    SEARCH_AGGS_FUSED,
    SEARCH_KNN_ENABLED,
    SEARCH_KNN_TILE_SUB,
    SEARCH_PALLAS_PRUNING_ENABLED,
    SEARCH_PALLAS_PRUNING_PROBE_TILES,
)
from elasticsearch_tpu_torch.common.staging import StagingBail, run_staged
from elasticsearch_tpu_torch.index.segment import tensor_bytes
from elasticsearch_tpu_torch.ops import knn_scoring as knn
from elasticsearch_tpu_torch.ops import tile_scoring as tsc
from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError
from elasticsearch_tpu_torch.ops.scoring import top_k
from elasticsearch_tpu_torch.search import plan as P
from elasticsearch_tpu_torch.search.admission import forced_pruning
from elasticsearch_tpu_torch.search.cancellation import TimeExceededException
from elasticsearch_tpu_torch.testing.disruption import (
    on_kernel_launch,
    on_plane_execute,
)
from elasticsearch_tpu_torch.search.telemetry import NULL_TRACER, QueryTracer

_plane_logger = logging.getLogger("elasticsearch_tpu_torch.parallel.plane")

NEG_INF = float("-inf")
# the missing fills of a staged sort key (finite: -inf means "not matched")
_SORT_BIG = 3.0e38
# the executor's columns derived from the segments' values, dropped by a
# tombstone or an append and restaged on demand
_DERIVED_COLUMNS = ("msort.", "mslice.")


class PlanStructureMismatch(Exception):
    """Per-segment plans for the same query diverged structurally; the
    caller tries the next plane."""


class _KnnStructuralError(Exception):
    """A vector field's segments disagree with its mapping (dims): the
    kNN plane stays off for this segment set; no device fault."""


class PlaneHealth:
    """Per-index execution-plane failure tracking + quarantine.

    A mesh_pallas / mesh plane that RAISES (as opposed to a clean
    PlanStructureMismatch shape fallback) is benched for ``cooldown_s``:
    queries serve from the next rung of the ladder. After the cooldown the
    plane is half-open: exactly one query is admitted as the probe while
    its peers keep serving the healthy rung. The probe's success re-opens
    the plane; its failure re-benches it. A probe that bails without
    executing releases its admission; a prober that dies silently is
    covered by a bounded lease (``PROBE_LEASE_S``)."""

    PLANES = ("mesh_pallas", "mesh")
    MAX_EVENTS = 32
    PROBE_LEASE_S = 30.0

    def __init__(self, cooldown_s: float = 60.0):
        self.cooldown_s = float(cooldown_s)
        self.failures_total: Dict[str, int] = {p: 0 for p in self.PLANES}
        self.failures_by_reason: Dict[str, int] = {}
        self.probes_total = 0
        self._quarantined_until: Dict[str, float] = {}
        self._probe_until: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.events: List[dict] = []

    def record_failure(self, plane: str,
                       reason: str = "kernel_fault") -> None:
        with self._lock:
            self.failures_total[plane] = \
                self.failures_total.get(plane, 0) + 1
            self.failures_by_reason[reason] = \
                self.failures_by_reason.get(reason, 0) + 1
            self._quarantined_until[plane] = (_time.monotonic()
                                              + self.cooldown_s)
            self._probe_until.pop(plane, None)
            self.events.append({
                "plane": plane,
                "reason": reason,
                "timestamp_ms": int(_time.time() * 1000),
                "cooldown_s": self.cooldown_s,
            })
            if len(self.events) > self.MAX_EVENTS:
                del self.events[0]

    def admit(self, plane: str) -> str:
        """``"open"`` = healthy, attempt freely; ``"probe"`` = the caller
        is THE post-cooldown probe (it must end in note_success /
        record_failure / release_probe); ``""`` = benched, or a peer's
        probe is in flight: serve the next rung."""
        now = _time.monotonic()
        with self._lock:
            until = self._quarantined_until.get(plane)
            if until is None:
                return "open"
            if now < until:
                return ""
            if now < self._probe_until.get(plane, 0.0):
                return ""
            self._probe_until[plane] = now + self.PROBE_LEASE_S
            self.probes_total += 1
            return "probe"

    def note_success(self, plane: str) -> None:
        if plane not in self._quarantined_until:
            return
        with self._lock:
            self._quarantined_until.pop(plane, None)
            self._probe_until.pop(plane, None)

    def release_probe(self, plane: str) -> None:
        """The probe bailed without executing the plane: hand the
        admission back (and un-count it)."""
        with self._lock:
            if self._probe_until.pop(plane, None) is not None:
                self.probes_total -= 1

    def available(self, plane: str) -> bool:
        """Non-consuming view for cheap pre-checks: False only while
        benched inside the cooldown (a half-open plane reads as available;
        the serving path uses ``admit``)."""
        return _time.monotonic() >= self._quarantined_until.get(plane, 0.0)

    def quarantined(self) -> List[str]:
        now = _time.monotonic()
        return [p for p, until in sorted(self._quarantined_until.items())
                if now < until]

    def stats(self) -> dict:
        return {
            "plane_failures_total": dict(self.failures_total),
            "plane_failures_by_reason": dict(self.failures_by_reason),
            "plane_probes_total": self.probes_total,
            "plane_quarantined": self.quarantined(),
            "quarantine_events": list(self.events),
        }


def _check_same_structure(plans: List[P.PlanNode]) -> None:
    def skeleton(p: P.PlanNode):
        return (type(p).__name__, len(p.arrays()), p.trace_statics(),
                tuple(skeleton(c) for c in p.children()))

    first = skeleton(plans[0])
    for p in plans[1:]:
        if skeleton(p) != first:
            raise PlanStructureMismatch(f"{skeleton(p)} != {first}")


_PAD_VALUES = {"z": 0, "o": 1, "n": float("nan"), "m1": -1}


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(device)


def stack_plans(plans: List[P.PlanNode], local_nd_pads: List[int],
                stacked_nd1: int, n_slots: int,
                device: torch.device) -> List[torch.Tensor]:
    """Stack per-slot plan arrays: a flat list aligned with
    ``plans[0].flat_arrays()``, every entry a tensor on ``device`` with a
    leading [n_slots] axis, padded by its ``pad_kinds`` entry. Slots
    beyond len(plans) replicate slot 0's arrays."""
    _check_same_structure(plans)
    kinds = plans[0].flat_pad_kinds()
    try:
        flats = [[_as_tensor(a, device) for a in p.flat_arrays()]
                 for p in plans]
    except NotImplementedError:
        raise PlanStructureMismatch("plan contains unfinalized arrays")
    for f in flats:
        if len(f) != len(kinds):
            raise PlanStructureMismatch("flat array count mismatch")
    sentinel = stacked_nd1 - 1
    stacked: List[torch.Tensor] = []
    for i, kind in enumerate(kinds):
        if kind == "x":
            # non-stackable node: the host rung serves these
            raise PlanStructureMismatch("plan contains non-stackable arrays")
        parts = [f[i] for f in flats]
        if kind == "k":
            # kernel tables stack verbatim, and only when every slot's
            # tables were harmonized to one shape
            if len({(tuple(p.shape), p.dtype) for p in parts}) != 1:
                raise PlanStructureMismatch("kernel table shapes diverge")
            parts = parts + [parts[0]] * (n_slots - len(parts))
            stacked.append(torch.stack(parts))
            continue
        parts = parts + [parts[0]] * (n_slots - len(parts))
        if kind == "s" or parts[0].dim() == 0:
            stacked.append(torch.stack(parts))
            continue
        if kind == "dense":
            # a dense [nd1, ...] column (a mask, a factor column): zeros
            # beyond the slot's own rows, as the JAX package pads it
            out = torch.zeros((n_slots, stacked_nd1) + tuple(
                parts[0].shape[1:]), dtype=parts[0].dtype, device=device)
            for d, a in enumerate(parts):
                out[d, : a.shape[0]] = a
            stacked.append(out)
            continue
        max_shape = tuple(max(p.shape[j] for p in parts)
                          for j in range(parts[0].dim()))
        fill = sentinel if kind == "d" else _PAD_VALUES[kind]
        out = torch.full((n_slots,) + max_shape, fill, dtype=parts[0].dtype,
                         device=device)
        for d, a in enumerate(parts):
            if kind == "d":
                # re-point the segment's own sentinel doc to the stacked
                # one (filler slots came from slot 0)
                src = d if d < len(plans) else 0
                a = torch.where(a == local_nd_pads[src],
                                torch.full_like(a, sentinel), a)
            out[(d,) + tuple(slice(0, s) for s in a.shape)] = a
        stacked.append(out)
    return stacked


class _DeltaIneligible(StagingBail):
    """A structural surprise the delta pre-check missed: the owner falls
    back to the full rebuild (no retry, no fault accounting)."""


# the fill of a dead (unoccupied) slot's rows in the stacked base tables;
# block_docs takes the stacked sentinel doc
_DEAD_FILL = {"block_tfs": 0.0, "norms": 1.0, "live1": False}


def _stage_slot_rows(name: str, arr: np.ndarray, n_slots: int,
                     nd_pad: int, device: torch.device) -> torch.Tensor:
    """One stacked base table on the device with ``n_slots`` rows: the
    occupied rows copy from the host stack, the dead rows fill on the
    device (their bytes never cross the bus)."""
    host = torch.from_numpy(arr)
    if arr.shape[0] == n_slots:
        return host.to(device)
    out = torch.empty((n_slots,) + tuple(arr.shape[1:]), dtype=host.dtype,
                      device=device)
    out[: arr.shape[0]].copy_(host)
    out[arr.shape[0]:].fill_(nd_pad if name == "block_docs"
                             else _DEAD_FILL[name])
    return out


def _live_row(seg, width: int) -> np.ndarray:
    """A segment's live mask as f32 over ``width`` docs (0 past its own)."""
    live = np.zeros(width, np.float32)
    live[: seg.nd_pad] = seg.live.astype(np.float32)
    return live


def _knn_mask_row(seg, field: str, width: int) -> np.ndarray:
    """A slot's kNN mask row: live docs that carry the vector."""
    row = np.zeros(width, np.float32)
    col = seg.vector_columns.get(field)
    if col is not None:
        row[: seg.nd_pad] = (col.exists & seg.live).astype(np.float32)
    return row


class MeshPlanExecutor:
    """One staged generation: N sealed segments as ``[n_slots, ...]``
    stacked tables on one device, one slot a segment in the index's
    canonical pair order, plus ``n_slots - N`` dead slots of headroom
    (all-zero live masks) for a later refresh to append into. Runs a query
    plan over every occupied slot.

    Each generation is one device-memory ledger scope (``mesh#N``): the
    stacked slot tables (``mesh_slot_tables``), the kernel plane's and the
    kNN planes' live layouts (``live_mask``) and the fused aggregations'
    doc-value columns (``doc_values``). The posting tables and embeddings
    the programs read are the segments' own (their scopes)."""

    _SCOPE_SEQ = itertools.count(1)

    def __init__(self, segments: List, device: torch.device,
                 postings_codec: Optional[str] = None,
                 postings_codec_default: Optional[str] = None,
                 index_name: Optional[str] = None,
                 stage_reason: str = "initial",
                 slots_per_dev: Optional[int] = None):
        from elasticsearch_tpu_torch.parallel.distributed import (
            stack_shard_arrays,
        )
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        self.device = device
        self.segments = segments
        # the ledger scope: a fresh one a generation, so releasing the old
        # generation is exact (next() is atomic)
        self.index_name = index_name or "_unassigned"
        self.scope = f"mesh#{next(self._SCOPE_SEQ)}"
        # (shard_id, segment) per slot; IndexMeshSearch sets the real
        # shard ids
        self.pairs: List[Tuple[int, object]] = list(enumerate(segments))
        # armed by the owner (make_evictable) only after install
        self._evict_cb = None
        # why this generation staged; its tables inherit it
        self._stage_reason = stage_reason
        # set by release(): a query still pinned to this generation may
        # stage more lazily, and must not register under the released scope
        self._released = False
        self.n_dev = 1
        # slot headroom: the owner may ask for more slots than segments
        self.slots_per_dev = max(1, len(segments))
        if slots_per_dev is not None:
            self.slots_per_dev = max(self.slots_per_dev, int(slots_per_dev))
        self.n_slots = self.slots_per_dev * self.n_dev
        self._kernel_stage_lock = threading.Lock()
        # the reason a staging turned away (hbm_budget / staging_fault),
        # thread-local: each query reads its own
        self._denied = threading.local()
        t0 = _time.monotonic()
        stacked = stack_shard_arrays(segments, len(segments))
        self.nd_pad = stacked.pop("nd_pad")
        self.nd1 = self.nd_pad + 1
        # a raise here aborts the constructor with nothing registered; the
        # owner's run_staged loop retries or classifies it
        on_device_staging(self.index_name, "mesh_slot_tables", "seg_stacked")
        # copy on write: every change publishes a new dict, so a query
        # reads one snapshot of the tables from its start to its end
        self._seg_staged: Dict[str, torch.Tensor] = {
            name: _stage_slot_rows(name, arr, self.n_slots, self.nd_pad,
                                   device)
            for name, arr in stacked.items()}
        self._account("mesh_slot_tables", "seg_stacked",
                      sum(tensor_bytes(t) for t in self._seg_staged.values()),
                      duration_ms=(_time.monotonic() - t0) * 1000.0)
        # lazily staged tile-kernel plane (ensure_kernel): None = not yet,
        # dict = {geom, meta: {id(seg): (bmin, bmax, bfmax)}, codec}
        self._kernel: Optional[dict] = None
        # per occupied slot {k_docs, k_frac} or {k_packed}: the segment's
        # own posting tables in the executor's codec
        self._kernel_tables: List[dict] = []
        # the index's codec preference and the node default behind it;
        # postings_codec is the codec resolved at the kernel staging
        self.postings_codec_pref = postings_codec
        self.postings_codec_default = postings_codec_default
        self.postings_codec = "raw"
        # (id(seg), sub, block_start, block_count) -> per-tile bound column
        self._ub_cache: Dict[tuple, np.ndarray] = {}
        # lazily staged kNN planes (ensure_knn): field -> session dict, or
        # False when the field cannot run here for this segment set
        self._knn: Dict[str, object] = {}
        # fused-aggregation eligibility facts of this generation's columns
        self._agg_field_checks: Dict = {}
        # staged sort key columns -> {"vocab": the global-ordinal terms of
        # a keyword sort, or None}
        self.sort_meta: Dict[str, dict] = {}

    @property
    def kernel_denied_reason(self) -> Optional[str]:
        return getattr(self._denied, "reason", None)

    @kernel_denied_reason.setter
    def kernel_denied_reason(self, value: Optional[str]) -> None:
        self._denied.reason = value

    @property
    def n_occupied(self) -> int:
        """Occupied slots (rows 0..n_occupied-1); the rest are dead."""
        return len(self.segments)

    # ------------------------------------------------------------------
    # Device-memory accounting
    # ------------------------------------------------------------------

    def make_evictable(self, evict) -> None:
        """Arm the budget's eviction callback, called by the owner after
        this generation is installed as current: armed during
        construction, another thread's reservation could evict this scope
        while the owner still points at the previous generation."""
        self._evict_cb = evict
        memory_accountant().set_evict(self.index_name, self.scope, evict)

    def _account(self, kind: str, table: str, nbytes: int,
                 reason: Optional[str] = None, duration_ms: float = 0.0,
                 amplify_bytes: Optional[int] = None) -> None:
        if self._released:
            # a query pinned to a replaced generation may stage more while
            # it finishes; registering would resurrect the released scope
            # (its tensors free with the query's references)
            return
        memory_accountant().register(
            self.index_name, self.scope, kind, table, int(nbytes),
            reason=reason or self._stage_reason, duration_ms=duration_ms,
            plane="mesh", evict=self._evict_cb,
            amplify_bytes=amplify_bytes)

    def release(self) -> int:
        """This generation is replaced or dropped: return its ledger bytes
        at once. The tensors free when the last query holding them drops
        its references."""
        self._released = True
        return memory_accountant().release_scope(self.index_name, self.scope)

    def drop(self) -> None:
        """Release the ledger bytes and drop every tensor reference (the
        index closed: nothing serves from this generation again)."""
        self.release()
        with self._kernel_stage_lock:
            self._seg_staged = {}
            self._kernel = None
            self._kernel_tables = []
            self._knn = {}
            self._ub_cache = {}
            self._agg_field_checks = {}
            self.sort_meta = {}
            self.segments = []
            self.pairs = []

    def touch(self) -> None:
        memory_accountant().touch(self.index_name, self.scope)

    def staged_bytes(self) -> int:
        """Bytes the executor itself stages (the segments' own tables are
        not counted)."""
        tensors = list(self._seg_staged.values()) + [
            e["mask"] for e in self._knn.values() if isinstance(e, dict)]
        return sum(tensor_bytes(t) for t in tensors)

    # ------------------------------------------------------------------
    # Delta staging: append into free slots, tombstone in place
    # ------------------------------------------------------------------

    def free_slots(self) -> int:
        """Unoccupied slots in this generation (the append headroom)."""
        return self.n_slots - len(self.segments)

    @staticmethod
    def delta_append_compatible(old: "MeshPlanExecutor",
                                new_segments: List) -> bool:
        """Can ``new_segments`` append into ``old``'s free slots without a
        geometry rebuild? False when the slots are exhausted or a new
        segment exceeds the stacked shapes (doc space, posting blocks,
        norm rows); a codec change is the owner's check."""
        if old._released:
            return False
        if len(old.segments) + len(new_segments) > old.n_slots:
            return False  # slots exhausted
        bd = old._seg_staged.get("block_docs")
        nm = old._seg_staged.get("norms")
        if bd is None or nm is None:
            return False
        n_blocks, blk = int(bd.shape[1]), int(bd.shape[2])
        n_norm = int(nm.shape[1])
        for seg in new_segments:
            if (seg.nd_pad > old.nd_pad
                    or seg.block_docs.shape[0] > n_blocks
                    or seg.block_docs.shape[1] != blk
                    or seg.norms.shape[0] > n_norm):
                return False  # tile-geometry mismatch
        return True

    @staticmethod
    def stage_delta_segments(old: "MeshPlanExecutor",
                             new_segments: List) -> None:
        """Stage the appended segments' own tensors (base tables, kernel
        tables in the generation's codec, the staged kNN fields'
        embeddings) in their own scopes and retry loops, before the
        append's transactional attempt reads them."""
        kernel = old._kernel if isinstance(old._kernel, dict) else None
        for seg in new_segments:
            seg.device_arrays()
            if kernel is not None:
                seg.kernel_bfmax_for(kernel["codec"])
            for field, entry in old._knn.items():
                if isinstance(entry, dict) and field in seg.vector_columns:
                    seg.ensure_vector_staged(field, entry["metric"])

    @classmethod
    def delta_append(cls, old: "MeshPlanExecutor", pairs: List,
                     changed: frozenset = frozenset()
                     ) -> "MeshPlanExecutor":
        """The successor generation of an incremental refresh, copy on
        write. ``pairs``: the new segment set in canonical order (the
        order a rebuild stages); ``changed``: the (shard, id(segment)) of
        already staged segments whose live masks changed (deletes riding
        along).

        Each stacked table of the successor is a new tensor: one
        device-to-device gather of ``old``'s rows into the canonical order
        (new segments take a dead row), then the new slots' rows written
        on the device from the new segments' own staged tensors, and the
        live rows of new and tombstoned slots from their host masks. Old
        queries keep reading ``old``'s intact tensors, and the successor
        merges its slots in a rebuild's order, so its answers equal a
        rebuild's byte for byte, ties included. The derived doc-value
        columns are dropped and restage lazily.

        One transactional attempt inside the owner's run_staged loop:
        nothing publishes or registers until every tensor is built. The
        delta rows' bytes feed the amplification counters (reason
        ``delta_append``); the successor scope registers its tables' full
        bytes. Raises ``_DeltaIneligible`` on a structural surprise."""
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        old_row = {(sid, id(seg)): i for i, (sid, seg) in enumerate(old.pairs)}
        new_segs = [seg for sid, seg in pairs if (sid, id(seg)) not in old_row]
        if not new_segs or not cls.delta_append_compatible(old, new_segs):
            raise _DeltaIneligible("segment set cannot delta-append")
        self = cls.__new__(cls)
        self.device = dev = old.device
        self.index_name = old.index_name
        self.scope = f"mesh#{next(cls._SCOPE_SEQ)}"
        self.pairs = list(pairs)
        self.segments = [seg for _sid, seg in pairs]
        self._evict_cb = None
        # lazy stagings after install are refresh restages; the delta rows
        # below register as delta_append
        self._stage_reason = "refresh"
        self._released = False
        self.n_dev = old.n_dev
        self.slots_per_dev = old.slots_per_dev
        self.n_slots = old.n_slots
        self.nd_pad = nd_pad = old.nd_pad
        self.nd1 = old.nd1
        self._kernel_stage_lock = threading.Lock()
        self._denied = threading.local()
        self.postings_codec_pref = old.postings_codec_pref
        self.postings_codec_default = old.postings_codec_default
        self.postings_codec = old.postings_codec
        self._ub_cache = dict(old._ub_cache)  # keyed by segment
        self._agg_field_checks = {}
        # the sort and slice columns are not carried over (a keyword
        # sort's vocabulary spans the new segments): they restage lazily
        self.sort_meta = {}
        self._kernel = None
        self._kernel_tables = []
        self._knn = {}

        t0 = _time.monotonic()
        dead = len(old.segments)  # an unoccupied row of ``old``
        src = [old_row.get((sid, id(seg)), dead) for sid, seg in pairs]
        src += [dead] * (self.n_slots - len(pairs))
        new_rows = [r for r, (sid, seg) in enumerate(pairs)
                    if (sid, id(seg)) not in old_row]
        live_rows = sorted(set(new_rows) | {
            r for r, (sid, seg) in enumerate(pairs)
            if (sid, id(seg)) in changed})
        idx = torch.tensor(src, dtype=torch.long, device=dev)
        base = old._seg_staged
        kernel = old._kernel if isinstance(old._kernel, dict) else None

        # a raise here aborts the attempt with nothing registered and the
        # old generation intact
        on_device_staging(self.index_name, "mesh_slot_tables", "delta_append")

        # --- base slot tables: gather, then the delta rows on the device
        staged = {name: base[name].index_select(0, idx)
                  for name in ("block_docs", "block_tfs", "norms", "live1")}
        amp_base = 0
        for r in new_rows:
            seg = self.segments[r]
            sdev = seg.device_arrays()
            bd = sdev["block_docs"]
            nb = int(bd.shape[0])
            # the gathered dead row holds the sentinel, 0 and 1 fills; the
            # segment's own sentinel doc re-points to the stacked one
            staged["block_docs"][r, :nb] = bd.masked_fill(bd == seg.nd_pad,
                                                          nd_pad)
            staged["block_tfs"][r, :nb] = sdev["block_tfs"]
            nm = sdev["norms"]
            staged["norms"][r, : nm.shape[0], : seg.nd_pad] = nm[:, :-1]
            amp_base += sum(tensor_bytes(staged[k][r])
                            for k in ("block_docs", "block_tfs", "norms"))
        for r in live_rows:
            seg = self.segments[r]
            row = np.zeros(self.nd1, bool)
            row[: seg.live.shape[0]] = seg.live
            staged["live1"][r].copy_(torch.from_numpy(row))
            amp_base += tensor_bytes(staged["live1"][r])

        # --- kernel plane: the new slots' own tables, live layout rows
        live_t_amp: Dict[str, int] = {}
        if kernel is not None:
            geom, codec = kernel["geom"], kernel["codec"]
            meta = dict(kernel["meta"])
            tables = []
            for sid, seg in pairs:
                i = old_row.get((sid, id(seg)))
                if i is not None:
                    tables.append(old._kernel_tables[i])
                    continue
                tables.append(seg.kernel_tables(codec))
                meta[id(seg)] = (seg.kernel_bmin, seg.kernel_bmax,
                                 seg.kernel_bfmax_for(codec))
            for key in [k for k in base if k.startswith("k_live_t")]:
                g = (geom if key == "k_live_t" else tsc.tile_geometry(
                    geom.nd_pad, int(key.rsplit("_", 1)[1])))
                lt = base[key].index_select(0, idx)
                for r in live_rows:
                    lt[r].copy_(torch.from_numpy(tsc.build_live_t(
                        _live_row(self.segments[r], g.nd_pad), g)))
                staged[key] = lt
                live_t_amp[key] = len(live_rows) * tensor_bytes(lt[0])

        # --- kNN planes: the new slots' own embeddings, mask rows
        knn_new: Dict[str, dict] = {}
        knn_amp: Dict[str, int] = {}
        for field, entry in old._knn.items():
            if not isinstance(entry, dict):
                continue  # re-evaluated lazily for the new segment set
            dims = entry["dims"]
            if any(field in seg.vector_columns
                   and seg.vector_columns[field].dims != dims
                   for seg in new_segs):
                continue  # a dims surprise: the lazy staging decides
            slots = []
            for sid, seg in pairs:
                i = old_row.get((sid, id(seg)))
                if i is not None:
                    slots.append(entry["slots"][i])
                    continue
                if field not in seg.vector_columns:
                    slots.append(None)  # the slot stays dead
                    continue
                emb_key, norm_key, _ex, _d = seg.ensure_vector_staged(
                    field, entry["metric"])
                sdev = seg.device_arrays()
                slots.append({
                    "emb": sdev[emb_key],
                    "scale": (sdev[norm_key] if entry["metric"] == "cosine"
                              else None),
                    "n_rows": seg.nd_pad})
            mask = entry["mask"].index_select(0, idx)
            for r in live_rows:
                mask[r].copy_(torch.from_numpy(_knn_mask_row(
                    self.segments[r], field, entry["nd_pad"])))
            knn_new[field] = dict(entry, mask=mask, slots=slots)
            knn_amp[field] = len(live_rows) * tensor_bytes(mask[0])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        # --- commit: publish, then register
        self._seg_staged = staged
        self._knn = knn_new
        if kernel is not None:
            self._kernel_tables = tables
            self._kernel = {"geom": kernel["geom"], "meta": meta,
                            "codec": kernel["codec"]}
        dur = (_time.monotonic() - t0) * 1000.0
        self._account("mesh_slot_tables", "seg_stacked",
                      sum(tensor_bytes(staged[k]) for k in
                          ("block_docs", "block_tfs", "norms", "live1")),
                      reason="delta_append", amplify_bytes=amp_base,
                      duration_ms=dur)
        for key, amp in live_t_amp.items():
            self._account("live_mask", key, tensor_bytes(staged[key]),
                          reason="delta_append", amplify_bytes=amp,
                          duration_ms=dur)
        for field, entry in knn_new.items():
            self._account("live_mask", f"knn_mask:{field}",
                          tensor_bytes(entry["mask"]), reason="delta_append",
                          amplify_bytes=knn_amp[field], duration_ms=dur)
        return self

    def apply_tombstones(self, slots: List[int]) -> int:
        """Tombstone deletes: rebuild only the given slots' live rows (the
        stacked ``live1``, which the serial program and the fused
        aggregations' masks read, every staged kernel live layout, and
        each staged kNN field's exists-and-live mask) and publish them on
        this generation by swapping each table's dict entry for a copy
        holding the new rows (one reference assignment: a kernel already
        queued on the old tensor reads it intact). The same ledger keys
        re-register at their unchanged full bytes, with the changed rows'
        bytes as the amplification (reason ``tombstone``).

        One transactional attempt inside the owner's run_staged loop: a
        fault leaves the old masks serving and the ledger as it was.
        Returns the row bytes restaged."""
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        with self._kernel_stage_lock:
            if self._released or not slots:
                return 0
            t0 = _time.monotonic()
            slots = sorted(slots)
            on_device_staging(self.index_name, "live_mask", "tombstone_masks")
            lv = self._seg_staged["live1"].clone()
            for r in slots:
                seg = self.segments[r]
                row = np.zeros(self.nd1, bool)
                row[: seg.live.shape[0]] = seg.live
                lv[r].copy_(torch.from_numpy(row))
            updates = {"live1": lv}
            amp = {"live1": len(slots) * tensor_bytes(lv[0])}
            if isinstance(self._kernel, dict):
                geom = self._kernel["geom"]
                for key in [k for k in self._seg_staged
                            if k.startswith("k_live_t")]:
                    g = (geom if key == "k_live_t" else tsc.tile_geometry(
                        geom.nd_pad, int(key.rsplit("_", 1)[1])))
                    lt = self._seg_staged[key].clone()
                    for r in slots:
                        lt[r].copy_(torch.from_numpy(tsc.build_live_t(
                            _live_row(self.segments[r], g.nd_pad), g)))
                    updates[key] = lt
                    amp[key] = len(slots) * tensor_bytes(lt[0])
            knn_updates: Dict[str, dict] = {}
            for field, entry in self._knn.items():
                if not isinstance(entry, dict):
                    continue
                mask = entry["mask"].clone()
                for r in slots:
                    mask[r].copy_(torch.from_numpy(_knn_mask_row(
                        self.segments[r], field, entry["nd_pad"])))
                knn_updates[field] = dict(entry, mask=mask)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            knn_amp = {f: len(slots) * tensor_bytes(e["mask"][0])
                       for f, e in knn_updates.items()}
            restaged = sum(amp.values()) + sum(knn_amp.values())
            # the sort and slice columns drop with the tombstone and
            # restage lazily on the next query that needs one
            derived = [key for key in self._seg_staged
                       if key.startswith(_DERIVED_COLUMNS)]
            # commit: publish every replacement in one assignment a dict
            # (a running query holds the dict it read at its start, so
            # it never mixes old and new masks), then re-register
            self._seg_staged = {
                key: t for key, t in {**self._seg_staged, **updates}.items()
                if key not in derived}
            self.sort_meta = {}
            memory_accountant().release_tables(
                self.index_name, self.scope,
                [key for key in derived if not key.endswith(".raw")])
            self._knn = {**self._knn, **knn_updates}
            dur = (_time.monotonic() - t0) * 1000.0
            self._account(
                "mesh_slot_tables", "seg_stacked",
                sum(tensor_bytes(self._seg_staged[k]) for k in
                    ("block_docs", "block_tfs", "norms", "live1")),
                reason="tombstone", amplify_bytes=amp.pop("live1"),
                duration_ms=dur)
            for key, a in amp.items():
                self._account("live_mask", key,
                              tensor_bytes(self._seg_staged[key]),
                              reason="tombstone", amplify_bytes=a,
                              duration_ms=dur)
            for field, entry in knn_updates.items():
                self._account("live_mask", f"knn_mask:{field}",
                              tensor_bytes(entry["mask"]),
                              reason="tombstone",
                              amplify_bytes=knn_amp[field], duration_ms=dur)
            return restaged

    # ------------------------------------------------------------------
    # Lazily staged planes: doc values, the tile kernel, kNN
    # ------------------------------------------------------------------

    def stage_doc_value_columns(self, builds: Dict[str, object]) -> bool:
        """Stage fused-aggregation doc-value columns: ``builds`` maps a
        table name to a callable giving ``{name: np.ndarray}`` groups of
        per-slot columns ([n_occupied, nd1, ...]). Budget-gated (a denial
        returns False: the caller demotes the aggregations to the host
        reduce with reason ``hbm_budget``) and transactional: every array
        is built and transferred first, and the columns publish and
        register (kind ``doc_values``) together only after every transfer
        landed, so a fault leaves nothing behind. A transient fault
        retries; a terminal one raises (the caller's ``staging_fault``).
        They live as long as this generation."""
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        with self._kernel_stage_lock:
            arrays: Dict[str, np.ndarray] = {}
            for fn in builds.values():
                for name, arr in fn().items():
                    if name not in self._seg_staged:
                        arrays[name] = arr
            if not arrays:
                return True
            if not memory_accountant().try_reserve(
                    self.index_name,
                    sum(int(a.nbytes) for a in arrays.values()),
                    exclude_scope=self.scope):
                return False

            def attempt():
                t0 = _time.monotonic()
                on_device_staging(self.index_name, "doc_values",
                                  "agg_columns")
                staged = {name: torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device) for name, a in arrays.items()}
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._seg_staged = {**self._seg_staged, **staged}
                dur = (_time.monotonic() - t0) * 1000.0
                for name, t in staged.items():
                    self._account("doc_values", name, tensor_bytes(t),
                                  duration_ms=dur)

            run_staged(attempt, index=self.index_name, kind="doc_values",
                       plane="mesh")
        return True

    def ensure_sort_column(self, field: str, order: str,
                           missing) -> Optional[dict]:
        """Stage the (oriented key, raw value) columns of a one-field sort.
        Returns {"key": name, "raw": name, "columns": {name: tensor},
        "vocab": the keyword sort's global-ordinal terms or None}, or None
        when the field cannot rank exactly on the mesh (or
        ``kernel_denied_reason`` says the budget or a staging fault turned
        the staging away). A query holds the returned tensors: a tombstone
        may drop the columns from the generation meanwhile.

        The rank key is f32: a float64 column qualifies only if every
        value round-trips through f32 (timestamps usually do not, and
        near-tied dates reordered at f32 would be wrong, so they take the
        host rung). The oriented key follows ``_sort_keys``: negated for
        asc, missing docs filled with +-3e38 so -inf stays reserved for
        "not matched". A keyword field ranks by global ordinals (the
        position in the sorted union of every slot's terms), exact in f32
        below 2^24 terms."""
        self.kernel_denied_reason = None
        token = (repr(missing) if isinstance(missing, (int, float))
                 else str(missing or "_last"))
        name = f"msort.{field}.{order}.{token}"
        raw_name = name + ".raw"
        with self._kernel_stage_lock:
            staged, meta = self._seg_staged, self.sort_meta.get(name)
            if name in staged and meta is not None:
                return {"key": name, "raw": raw_name, "vocab": meta["vocab"],
                        "columns": {n: staged[n] for n in (name, raw_name)}}
        ords = [s.ordinal_columns.get(field)
                or s.ordinal_columns.get(f"{field}.keyword")
                for s in self.segments]
        if any(o is not None for o in ords):
            built = self._keyword_sort_columns(ords, order, missing)
        else:
            built = self._numeric_sort_columns(field, order, missing)
        if built is None:
            return None
        keys, raws, vocab = built
        columns = self._stage_derived("doc_values", name,
                                      {name: keys, raw_name: raws},
                                      meta={"vocab": vocab})
        if columns is None:
            return None
        return {"key": name, "raw": raw_name, "vocab": vocab,
                "columns": columns}

    def _numeric_sort_columns(self, field: str, order: str, missing):
        """([n_slots, nd1] f32 keys, raws, None) of a numeric or ``_doc``
        sort, or None when a value is not f32-exact."""
        keys = np.zeros((self.n_slots, self.nd1), np.float32)
        raws = np.zeros((self.n_slots, self.nd1), np.float32)
        for i, seg in enumerate(self.segments):
            if field == "_doc":
                if seg.nd_pad > (1 << 24):
                    return None  # a doc id not f32-exact
                raw = np.arange(seg.nd_pad, dtype=np.float64)
                exists = np.ones(seg.nd_pad, bool)
            else:
                col = seg.numeric_columns.get(field)
                if col is None:
                    return None
                raw = (col.min_value if order == "asc"
                       else col.max_value).astype(np.float64)
                exists = col.exists
                vals = raw[exists]
                if not np.array_equal(
                        vals, vals.astype(np.float32).astype(np.float64)):
                    return None  # not exactly f32-representable
            if missing is None or missing == "_last":
                fill = np.float64(-_SORT_BIG if order == "desc"
                                  else _SORT_BIG)
            elif missing == "_first":
                fill = np.float64(_SORT_BIG if order == "desc"
                                  else -_SORT_BIG)
            else:
                fill = np.float64(missing)
            raw = np.where(exists, raw, fill)
            self._sort_rows(keys, raws, i, seg, raw, order)
        return keys, raws, None

    def _keyword_sort_columns(self, ords: List, order: str, missing):
        """([n_slots, nd1] f32 global-ordinal keys, raws, vocab) of a
        keyword sort; ``ords``: each slot's ordinal column or None (every
        doc of that slot is missing). None for a custom string missing
        (it ranks mid-vocabulary: the host rung) or 2^24 terms and more."""
        if missing not in (None, "_last", "_first"):
            return None
        vocab: List[str] = sorted(
            set().union(*(o.terms for o in ords if o is not None)))
        if len(vocab) >= (1 << 24):
            return None  # an ordinal not f32-exact
        if missing == "_first":
            fill = np.float64(_SORT_BIG if order == "desc" else -_SORT_BIG)
        else:
            fill = np.float64(-_SORT_BIG if order == "desc" else _SORT_BIG)
        keys = np.zeros((self.n_slots, self.nd1), np.float32)
        raws = np.zeros((self.n_slots, self.nd1), np.float32)
        for i, (seg, ocol) in enumerate(zip(self.segments, ords)):
            if ocol is None:
                raw = np.full(seg.nd_pad, fill)
            else:
                # local ordinal -> global ordinal (both term lists sorted:
                # searchsorted is the ordinal map)
                g = np.searchsorted(vocab, ocol.terms).astype(np.float64)
                raw = np.where(ocol.exists, g[ocol.first_ord], fill)
            self._sort_rows(keys, raws, i, seg, raw, order)
        return keys, raws, vocab

    @staticmethod
    def _sort_rows(keys, raws, i, seg, raw, order) -> None:
        key = np.clip(raw if order == "desc" else -raw, -_SORT_BIG,
                      _SORT_BIG)
        keys[i, : seg.nd_pad] = key.astype(np.float32)
        keys[i, seg.nd_pad:] = -_SORT_BIG  # padding never outranks a doc
        raws[i, : seg.nd_pad] = raw.astype(np.float32)

    def ensure_slice_column(self, slice_spec: dict, num_shards: int
                            ) -> Optional[Dict[str, torch.Tensor]]:
        """Stage a slice's doc partition as a [n_slots, nd1] bool column,
        shard-aware like the host rung (``resolve_slice``), from the host
        rung's per-segment mask cache. Returns {name: tensor}, or None
        when the budget or a staging fault turned it away
        (``kernel_denied_reason``)."""
        from elasticsearch_tpu_torch.search.service import (
            resolve_slice,
            slice_mask,
        )

        self.kernel_denied_reason = None
        name = f"mslice.{int(slice_spec['max'])}.{int(slice_spec['id'])}." \
               f"{num_shards}"
        with self._kernel_stage_lock:
            staged = self._seg_staged
            if name in staged:
                return {name: staged[name]}
        out = np.zeros((self.n_slots, self.nd1), bool)
        for i, (sid, seg) in enumerate(self.pairs):
            resolved = resolve_slice(slice_spec, sid, num_shards)
            if resolved == "skip":
                continue  # an all-False row
            if resolved is None:
                out[i, : seg.nd_pad] = True  # the whole shard
                continue
            mask = slice_mask(seg, int(resolved["id"]), int(resolved["max"]))
            out[i, : mask.shape[0]] = mask
        return self._stage_derived("mesh_slot_tables", name, {name: out})

    def _stage_derived(self, kind: str, table: str,
                       arrays: Dict[str, np.ndarray],
                       meta: Optional[dict] = None
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """Stage columns derived from the segments' host arrays (sort keys
        with their ``sort_meta``, slice masks) under this generation's
        scope, budget-gated like ``stage_doc_value_columns``. Returns the
        staged tensors; None on a budget denial (``kernel_denied_reason``
        "hbm_budget") or a terminal staging fault ("staging_fault").
        Publishes copy on write."""
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        nbytes = sum(int(a.nbytes) for a in arrays.values())
        with self._kernel_stage_lock:
            if not memory_accountant().try_reserve(
                    self.index_name, nbytes, exclude_scope=self.scope):
                self.kernel_denied_reason = "hbm_budget"
                return None
            staged: Dict[str, torch.Tensor] = {}

            def attempt():
                t0 = _time.monotonic()
                on_device_staging(self.index_name, kind, table)
                staged.update({name: torch.from_numpy(a).to(self.device)
                               for name, a in arrays.items()})
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._seg_staged = {**self._seg_staged, **staged}
                if meta is not None:
                    self.sort_meta[table] = meta
                self._account(kind, table, nbytes,
                              duration_ms=(_time.monotonic() - t0) * 1000.0)

            try:
                run_staged(attempt, index=self.index_name, kind=kind,
                           plane="mesh")
            except KernelError:
                raise
            except Exception:  # noqa: BLE001 — a terminal staging fault:
                # the host rung serves this request
                _plane_logger.warning(
                    "[%s] mesh staging of %s failed; the host rung serves",
                    self.index_name, table, exc_info=True)
                self.kernel_denied_reason = "staging_fault"
                return None
        return staged

    def ensure_kernel(self) -> Optional[dict]:
        """Stage the tile-kernel plane over the stacked segment set: one
        shared tile geometry covering the stacked doc space, the codec
        resolved over it, and the per-slot live masks in its tile layout.
        Each slot's posting tables are its segment's own in that codec
        (``Segment.kernel_tables(codec)``, staged in the segment's scope):
        every row window is segment-local and the kernel skips the
        zero-``frac`` padding postings, so no stacked copy of them is
        needed. Returns the kernel session, or None with
        ``kernel_denied_reason`` "hbm_budget" (the budget turned it away)
        or "staging_fault" (a terminal staging fault: the caller
        quarantines the plane). A ``KernelError`` raises."""
        self.kernel_denied_reason = None
        if self._kernel is None:
            with self._kernel_stage_lock:
                if self._kernel is None:
                    geom = tsc.tile_geometry(max(self.nd_pad, tsc.LANE))
                    # every slot's doc ids must fit the packed word's bits
                    codec = tsc.resolve_postings_codec(
                        self.postings_codec_pref, geom.nd_pad,
                        self.postings_codec_default)
                    estimate = (self.n_slots * geom.n_tiles * tsc.LANE
                                * geom.tile_sub * 4)
                    if not memory_accountant().try_reserve(
                            self.index_name, estimate,
                            exclude_scope=self.scope):
                        self.kernel_denied_reason = "hbm_budget"
                        return None
                    try:
                        tables = [seg.kernel_tables(codec)
                                  for seg in self.segments]
                        run_staged(lambda: self._stage_kernel_plane(
                            geom, codec, tables), index=self.index_name,
                            kind="live_mask", plane="mesh")
                    except KernelError:
                        raise
                    except Exception:  # noqa: BLE001 — a terminal
                        # staging fault: the ladder's next rung serves
                        _plane_logger.warning(
                            "[%s] mesh kernel staging failed; plane demotes "
                            "with reason staging_fault", self.index_name,
                            exc_info=True)
                        self.kernel_denied_reason = "staging_fault"
                        return None
        return self._kernel

    def _stage_kernel_plane(self, geom, codec: str,
                            tables: List[dict]) -> None:
        """One staging attempt of the kernel plane's live layout; commits
        only a complete plane."""
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        t0 = _time.monotonic()
        live_t = np.zeros(
            (self.n_slots, geom.n_tiles * tsc.LANE, geom.tile_sub),
            np.float32)
        meta = {}
        for i, seg in enumerate(self.segments):
            live_t[i] = tsc.build_live_t(_live_row(seg, geom.nd_pad), geom)
            meta[id(seg)] = (seg.kernel_bmin, seg.kernel_bmax,
                             seg.kernel_bfmax_for(codec))
        on_device_staging(self.index_name, "live_mask", "k_live_t")
        live_dev = torch.from_numpy(live_t).to(self.device)
        self._seg_staged = {**self._seg_staged, "k_live_t": live_dev}
        self._kernel_tables = tables
        self.postings_codec = codec
        self._kernel = {"geom": geom, "meta": meta, "codec": codec}
        self._account("live_mask", "k_live_t", tensor_bytes(live_dev),
                      duration_ms=(_time.monotonic() - t0) * 1000.0)

    def ensure_kernel_live(self, sub: int) -> str:
        """Per-sub live-mask layout for a shrunk tile geometry (the
        geometry ladder), over the stacked slot axis."""
        key = f"k_live_t_{sub}"
        with self._kernel_stage_lock:
            if key not in self._seg_staged:
                geom = tsc.tile_geometry(self._kernel["geom"].nd_pad, sub)
                live_t = np.zeros(
                    (self.n_slots, geom.n_tiles * tsc.LANE, geom.tile_sub),
                    np.float32)
                for i, seg in enumerate(self.segments):
                    live_t[i] = tsc.build_live_t(
                        _live_row(seg, geom.nd_pad), geom)
                t = torch.from_numpy(live_t).to(self.device)
                self._seg_staged = {**self._seg_staged, key: t}
                # the same masks in a new layout: a geometry change
                self._account("live_mask", key, tensor_bytes(t),
                              reason="geometry_change")
        return key

    def ensure_knn(self, field: str, dims: int,
                   metric: str) -> Optional[dict]:
        """Stage a dense_vector field's kNN plane over the segment set: the
        per-slot live-and-has-vector masks [n_slots, nd_knn] in one shared
        geometry (kind ``live_mask``), and per slot the segment's own
        staged embeddings (and inverse norms for cosine) with its row
        count. Deletes reach the masks through ``apply_tombstones``.
        Returns the session dict, or None (with ``kernel_denied_reason``
        "hbm_budget" or "staging_fault")."""
        self.kernel_denied_reason = None
        entry = self._knn.get(field)
        if entry is False:
            return None
        if entry is None:
            with self._kernel_stage_lock:
                entry = self._knn.get(field)
                if entry is False:
                    return None
                if entry is None:
                    nd_knn = max(self.nd_pad, knn.LANE)
                    if not memory_accountant().try_reserve(
                            self.index_name, self.n_slots * nd_knn * 4,
                            exclude_scope=self.scope):
                        self.kernel_denied_reason = "hbm_budget"
                        return None
                    try:
                        slots = self._knn_slots(field, dims, metric)
                        entry = run_staged(
                            lambda: self._stage_knn_mask(
                                field, dims, metric, slots, nd_knn),
                            index=self.index_name, kind="live_mask",
                            plane="mesh")
                    except _KnnStructuralError:
                        # mapping-shaped, permanent for this segment set:
                        # the host rung serves quietly
                        self._knn[field] = False
                        return None
                    except KernelError:
                        raise
                    except Exception:  # noqa: BLE001 — staging fault:
                        # demote; the probe restages
                        _plane_logger.warning(
                            "mesh kNN staging failed for [%s]; plane "
                            "demotes with reason staging_fault", field,
                            exc_info=True)
                        self.kernel_denied_reason = "staging_fault"
                        return None
                    self._knn[field] = entry
                    self._account("live_mask", f"knn_mask:{field}",
                                  tensor_bytes(entry["mask"]))
        return entry

    def _knn_slots(self, field: str, dims: int, metric: str) -> list:
        """Per occupied slot the segment's own staged embeddings (staged in
        the segment's scope), or None for a slot without the field."""
        slots: List[Optional[dict]] = []
        for seg in self.segments:
            col = seg.vector_columns.get(field)
            if col is None:
                slots.append(None)  # the slot stays dead (mask all zero)
                continue
            if col.dims != dims:
                raise _KnnStructuralError(
                    f"segment [{seg.name}] stores [{field}] at "
                    f"dims={col.dims}, mapping says {dims}")
            emb_key, norm_key, _exists_key, _d = seg.ensure_vector_staged(
                field, metric)
            dev = seg.device_arrays()
            slots.append({
                "emb": dev[emb_key],
                "scale": dev[norm_key] if metric == "cosine" else None,
                "n_rows": seg.nd_pad})
        return slots

    def _stage_knn_mask(self, field: str, dims: int, metric: str,
                        slots: list, nd_knn: int) -> dict:
        """One staging attempt of a kNN plane's mask; commits only a
        complete plane."""
        from elasticsearch_tpu_torch.testing.disruption import (
            on_device_staging,
        )

        mask = np.zeros((self.n_slots, nd_knn), np.float32)
        for i, seg in enumerate(self.segments):
            mask[i] = _knn_mask_row(seg, field, nd_knn)
        on_device_staging(self.index_name, "live_mask", f"knn_mask:{field}")
        return {"mask": torch.from_numpy(mask).to(self.device),
                "slots": slots, "d_pad": knn.pad_dims(dims),
                "nd_pad": nd_knn, "metric": metric, "dims": dims}

    def execute_knn(self, session: dict, qmat: torch.Tensor, *, kk: int,
                    sub: int):
        """The kNN program: per slot one kernel-3 launch for the q_pad
        query rows, ``merge_knn_topk``, then one top-k over the slots'
        pools in slot order. Returns (top_s [Q, k'], top_d [Q, k'],
        top_slot [Q, k'], total) tensors, total = live docs carrying the
        vector over every slot."""
        q_pad = qmat.shape[0]
        n_tiles = session["nd_pad"] // (sub * knn.LANE)
        k2 = min(kk, n_tiles * min(kk, sub * knn.LANE))
        cand_s, cand_d, cand_slot = [], [], []
        for i, slot in enumerate(session["slots"]):
            if slot is None:
                # a slot without the field: empty candidates, as the JAX
                # kernel gives for an all-dead slot
                s_i = torch.full((q_pad, k2), NEG_INF, dtype=torch.float32,
                                 device=self.device)
                d_i = torch.full((q_pad, k2), -1, dtype=torch.int32,
                                 device=self.device)
            else:
                ts, td = knn.knn_score_tiles(
                    slot["emb"], slot["scale"], session["mask"][i], qmat,
                    sub=sub, k=kk, q_batch=q_pad, n_rows=slot["n_rows"])
                s_i, d_i = knn.merge_knn_topk(ts, td, kk)
            cand_s.append(s_i)
            cand_d.append(d_i)
            cand_slot.append(torch.full_like(d_i, i))
        pool_s = torch.cat(cand_s, dim=1)
        top_s, top_i = top_k(pool_s, min(kk, pool_s.shape[1]))
        top_d = torch.gather(torch.cat(cand_d, dim=1), 1, top_i)
        top_slot = torch.gather(torch.cat(cand_slot, dim=1), 1, top_i)
        total = (session["mask"] > 0.0).sum()
        return top_s, top_d, top_slot, total

    def harmonize_kernel_nodes(self, plans: List[P.PlanNode]) -> int:
        """Finalize every deferred kernel node so table shapes agree over
        the whole segment set: one (tile_sub, t_pad, cb) per aligned node
        group, chosen by the geometry ladder collectively (a dense term on
        any slot shrinks every slot's tile). Returns the number of groups
        finalized; raises PlanStructureMismatch when no shared geometry
        exists."""
        groups: List[List[P.PlanNode]] = []

        def walk(nodes):
            if all(isinstance(n, P.PallasScoreTermsNode) for n in nodes):
                groups.append(list(nodes))
            kids = [n.children() for n in nodes]
            if len({len(ks) for ks in kids}) != 1:
                raise PlanStructureMismatch("tree arity diverges")
            for child_set in zip(*kids):
                walk(list(child_set))

        walk(plans)
        if not groups:
            return 0
        session = self._kernel
        if not isinstance(session, dict):
            raise PlanStructureMismatch("kernel plane not staged")
        geom = session["geom"]
        for nodes in groups:
            if any(n._mesh_lanes is None for n in nodes):
                raise PlanStructureMismatch(
                    "kernel/scatter node mix across slots")
            t_pad = max(tsc.next_pow2(max(len(n._mesh_lanes), 1))
                        for n in nodes)
            sub = geom.tile_sub
            while True:
                g = geom if sub == geom.tile_sub else tsc.tile_geometry(
                    geom.nd_pad, sub)
                try:
                    tables = [tsc.build_tile_tables(
                        n._mesh_lanes, n._mesh_bmin, n._mesh_bmax, g,
                        t_pad=t_pad) for n in nodes]
                    break
                except ValueError:
                    if sub <= 32 or g.tile_sub < sub:
                        raise PlanStructureMismatch(
                            "no shared kernel geometry for this query")
                    sub //= 2
            cb = max(t[3] for t in tables)
            live_key = ("k_live_t" if g.tile_sub == geom.tile_sub
                        else self.ensure_kernel_live(g.tile_sub))
            for n, (rl, rh, w, _cb) in zip(nodes, tables):
                n.finalize_mesh(rl, rh, w, cb=cb, sub=g.tile_sub,
                                live_key=live_key)
        return len(groups)

    def _corpus(self, i: int):
        """Slot i's posting tables as score_tiles takes them: (docs, frac)
        raw, (words, None) packed."""
        tables = self._kernel_tables[i]
        if self._kernel["codec"] == "packed":
            return tables["k_packed"], None
        return tables["k_docs"], tables["k_frac"]

    def tile_lane_ub_cached(self, seg, union_lanes, row_lo, row_hi,
                            bfmax, sub: int) -> np.ndarray:
        """Per-(tile, lane) block-max bounds with a cache per lane: a
        lane's column depends only on (segment, tile geometry, posting
        run), so repeated queries on hot terms reuse it."""
        n_tiles, t_pad = row_lo.shape
        ub = np.zeros((n_tiles, t_pad), np.float32)
        for j, lane in enumerate(union_lanes):
            key = (id(seg), sub, lane.block_start, lane.block_count)
            col = self._ub_cache.get(key)
            if col is None or col.shape[0] != n_tiles:
                if len(self._ub_cache) > 4096:  # runaway-vocabulary stop
                    self._ub_cache.clear()
                col = tsc.tile_lane_ub(row_lo[:, j: j + 1],
                                       row_hi[:, j: j + 1], bfmax)[:, 0]
                self._ub_cache[key] = col
            ub[:, j] = col
        return ub

    def _slot(self, i: int,
              staged: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """Slot i's tables: its rows of ``staged`` (a query's snapshot of
        the stacked tables; the live one by default) and its segment's
        kernel tables."""
        if staged is None:
            staged = self._seg_staged
        slot = {name: a[i] for name, a in staged.items()}
        if self._kernel_tables:
            slot.update(self._kernel_tables[i])
        return slot

    def execute(self, plans: List[P.PlanNode], k: int,
                with_views: bool = False,
                pf_plans: Optional[List[P.PlanNode]] = None,
                min_score: Optional[float] = None,
                agg_static: tuple = (),
                columns: Optional[Dict[str, torch.Tensor]] = None,
                sort_keys: Optional[Tuple[str, str]] = None,
                slice_col: Optional[str] = None,
                search_after: Optional[float] = None,
                rs_plans: Optional[List[P.PlanNode]] = None,
                rescore: Optional[dict] = None) -> dict:
        """The serial program. ``plans``: one per slot, same query. Per
        slot, in the JAX program's order: emit -> live -> min_score ->
        slice (``slice_col``) -> [agg view] -> post_filter -> count -> rank
        key (the score, or the staged ``sort_keys`` column) -> the
        ``search_after`` cut (key < cursor, in oriented-key space) -> the
        rescore window pass (``rs_plans`` with ``rescore`` {window,
        score_mode, query_weight, rescore_query_weight}) -> local top-k;
        then the top-k over the slots' candidates in slot order.

        ``columns``: the derived columns (sort keys, slice masks) the
        query staged, by name, read beside the generation's tables.

        Returns tensors {keys [k'], slots [k'], docs [k'], total, scores
        [k'], counts [n_occupied]} (doc ids per slot, i.e.
        segment-local), ``raws`` [k'] (each top hit's raw sort value) with
        ``sort_keys``, {matched, scores_all} [n_slots, nd1] with
        ``with_views``, and ``aggs`` (the fused partials of
        ``agg_static``, each [n_slots, ...]) with ``agg_static``."""
        if len(plans) != len(self.segments):
            raise ValueError("one plan per staged slot required")
        # one snapshot of the stacked tables for the whole query: a
        # tombstone update publishes a new dict, never into this one
        staged = self._seg_staged
        if columns:
            staged = {**staged, **columns}
        n_occ = self.n_occupied
        local_pads = [s.nd_pad for s in self.segments]
        stacked = stack_plans(plans, local_pads, self.nd1, n_occ,
                              self.device)
        stacked_pf = (stack_plans(pf_plans, local_pads, self.nd1,
                                  n_occ, self.device)
                      if pf_plans else [])
        stacked_rs = (stack_plans(rs_plans, local_pads, self.nd1,
                                  n_occ, self.device)
                      if rs_plans else [])
        template = plans[0]

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=self.device)

        cand_keys, cand_docs, cand_scores, cand_slot, counts = \
            [], [], [], [], []
        cand_raw = []
        views_m, views_s = [], []
        # occupied slots only: a dead slot launches nothing and gives no
        # candidate
        for i in range(n_occ):
            seg = self._slot(i, staged)
            scores, matched = P.execute(seg, template,
                                        [a[i] for a in stacked])
            if min_score is not None:
                matched = matched & (scores >= f32(min_score))
            if slice_col is not None:
                matched = matched & seg[slice_col]
            if with_views or agg_static:
                views_m.append(matched)
            if with_views:
                views_s.append(scores)
            if pf_plans:
                _, pf_matched = P.execute(seg, pf_plans[0],
                                          [a[i] for a in stacked_pf])
                matched = matched & pf_matched
            counts.append(matched.sum())
            rank_key = scores if sort_keys is None else seg[sort_keys[0]]
            masked = torch.where(matched, rank_key,
                                 torch.full_like(rank_key, NEG_INF))
            if search_after is not None:
                # the strict "after" cut: desc keys are the raw values and
                # asc keys their negation, so "comes after the cursor" is
                # key < cursor; the total is unaffected
                masked = torch.where(rank_key < f32(search_after), masked,
                                     torch.full_like(masked, NEG_INF))
            nd = masked.shape[0]
            if rescore is not None:
                loc_keys, loc_docs = self._rescore_window(
                    seg, masked, stacked_rs, rs_plans[0], i, k, rescore)
                loc_scores = loc_keys  # the rescored score is the score
            else:
                loc_keys, loc_docs = top_k(masked, min(k, nd))
                loc_scores = scores[loc_docs]
            cand_keys.append(loc_keys)
            cand_docs.append(loc_docs)
            cand_scores.append(loc_scores)
            cand_slot.append(torch.full_like(loc_docs, i))
            if sort_keys is not None:
                cand_raw.append(seg[sort_keys[1]][loc_docs])
        all_keys = torch.cat(cand_keys)
        top_keys, top_idx = top_k(all_keys, min(k, all_keys.shape[0]))
        counts_t = torch.stack(counts)
        out = {"keys": top_keys, "slots": torch.cat(cand_slot)[top_idx],
               "docs": torch.cat(cand_docs)[top_idx],
               "scores": torch.cat(cand_scores)[top_idx],
               "total": counts_t.sum(), "counts": counts_t}
        if sort_keys is not None:
            out["raws"] = torch.cat(cand_raw)[top_idx]
        if with_views:
            out["matched"] = torch.stack(views_m)
            out["scores_all"] = torch.stack(views_s)
        if agg_static:
            from elasticsearch_tpu_torch.search.fused_aggs import (
                emit_agg_partials,
            )

            out["aggs"] = emit_agg_partials(agg_static, staged,
                                            torch.stack(views_m))
        return out

    def _rescore_window(self, seg: dict, masked: torch.Tensor, stacked_rs,
                        rs_template, i: int, k: int, rescore: dict):
        """QueryRescorer's window pass on one slot (the host rung's
        window is per segment too): the candidates are the top
        ``max(k, window)``; the first ``window`` of them take combined
        scores, the rest keep theirs, and the candidates re-rank by
        (-score, doc). Returns (keys [k'], docs [k'])."""
        window = rescore["window"]
        nd = masked.shape[0]
        ksel = min(max(k, window), nd)
        sel_keys, sel_docs = top_k(masked, ksel)
        rs_scores, _ = P.execute(seg, rs_template,
                                 [a[i] for a in stacked_rs])
        w = min(window, ksel)
        rs_sel = rs_scores[sel_docs[:w]]
        qw = torch.tensor(rescore["query_weight"], dtype=torch.float32,
                          device=masked.device)
        rqw = torch.tensor(rescore["rescore_query_weight"],
                           dtype=torch.float32, device=masked.device)
        base = sel_keys[:w] * qw
        resc = rs_sel * rqw
        mode = rescore["score_mode"]
        if mode == "total":
            comb = base + resc
        elif mode == "multiply":
            comb = torch.where(rs_sel != 0.0, base * rs_sel, base)
        elif mode == "avg":
            comb = (base + resc) / 2.0
        elif mode == "max":
            comb = torch.maximum(base, resc)
        elif mode == "min":
            comb = torch.minimum(base, resc)
        else:
            raise ValueError(f"score_mode {mode}")
        # max / min could lift an unmatched (-inf) candidate
        comb = torch.where(sel_keys[:w] == NEG_INF,
                           torch.full_like(comb, NEG_INF), comb)
        cand = torch.cat([comb, sel_keys[w:]])
        # the combined scores tie routinely (max / min): ties re-break by
        # doc, as the host rung's (-score, local_doc) sort does
        by_doc = torch.argsort(sel_docs, stable=True)
        order = by_doc[torch.argsort(-cand[by_doc], stable=True)]
        kk = min(k, ksel)
        return cand[order][:kk], sel_docs[order][:kk]

    def execute_batched_topk(self, live_key: str, rl: np.ndarray,
                             rh: np.ndarray, w_all: np.ndarray, *,
                             q_pad: int, kk: int, t_pad: int, cb: int,
                             sub: int):
        """The batched program: per slot one fused top-k launch for the
        q_pad queries, the per-query tile merge, then the merge over the
        slots' candidates. Returns (top_s [Q, k'], top_d [Q, k'], top_slot
        [Q, k'], total [Q]) tensors."""
        rl_t = torch.from_numpy(rl).to(self.device)
        rh_t = torch.from_numpy(rh).to(self.device)
        w_t = torch.from_numpy(w_all).to(self.device)
        live = self._seg_staged[live_key]
        outs = []
        for i in range(self.n_occupied):
            outs.append(tsc.score_tiles(
                *self._corpus(i), live[i], rl_t[i], rh_t[i], w_t[i],
                t_pad=t_pad, cb=cb, sub=sub, k=kk, dense=False,
                q_batch=q_pad, codec=self._kernel["codec"]))
        return self._merge_slots([outs], kk)

    def execute_batched_dense_agg(self, live_key: str, rl: np.ndarray,
                                  rh: np.ndarray, w_all: np.ndarray, *,
                                  q_pad: int, kk: int, t_pad: int, cb: int,
                                  sub: int, agg_statics: tuple):
        """The batched program for agg-carrying bursts: per slot one dense
        ``score_tiles`` launch for the q_pad queries (kernel 1b raw, 1d
        packed), whose scores both rank and aggregate. Per member the
        dense scores give the matched mask (``> 0``: live is folded in the
        kernel); per slot a top-k over doc-ordered scores (lowest doc
        first among ties, as the serial program's), the pools concatenate
        in slot order, one top-k. ``agg_statics``: one fused descriptor
        tuple per member (empty: no aggs); each member's mask over the
        slots reduces its own specs (``emit_agg_partials``). Returns
        (top_s [Q, k'], top_d, top_slot, total [Q] i32, partials: one list
        per member)."""
        from elasticsearch_tpu_torch.search.fused_aggs import (
            emit_agg_partials,
        )

        dev = self.device
        rl_t = torch.from_numpy(rl).to(dev)
        rh_t = torch.from_numpy(rh).to(dev)
        w_t = torch.from_numpy(w_all).to(dev)
        staged = self._seg_staged
        live = staged[live_key]
        nd = self.nd1 - 1
        cand_s, cand_d, cand_slot, matched_all = [], [], [], []
        total = None
        for i in range(self.n_occupied):
            (dense,) = tsc.score_tiles(
                *self._corpus(i), live[i], rl_t[i], rh_t[i], w_t[i],
                t_pad=t_pad, cb=cb, sub=sub, dense=True, q_batch=q_pad,
                codec=self._kernel["codec"])
            if q_pad == 1:
                dense = dense[None]
            n_tiles = dense.shape[1] // tsc.LANE
            flat = dense.reshape(q_pad, n_tiles, tsc.LANE, sub).transpose(
                2, 3).reshape(q_pad, -1)[:, :nd]
            # the sentinel column is dead, as the serial program's live1
            flat = torch.cat([flat, torch.zeros((q_pad, 1),
                                                dtype=flat.dtype,
                                                device=dev)], dim=1)
            matched = flat > 0.0
            masked = torch.where(matched, flat,
                                 torch.full_like(flat, NEG_INF))
            s_i, d_i = top_k(masked, min(kk, masked.shape[1]))
            cand_s.append(s_i)
            cand_d.append(d_i.to(torch.int32))
            cand_slot.append(torch.full_like(d_i, i, dtype=torch.int32))
            c = matched.sum(dim=1, dtype=torch.int32)
            total = c if total is None else total + c
            matched_all.append(matched)
        pool_s = torch.cat(cand_s, dim=1)
        top_s, top_i = top_k(pool_s, min(kk, pool_s.shape[1]))
        top_d = torch.gather(torch.cat(cand_d, dim=1), 1, top_i)
        top_slot = torch.gather(torch.cat(cand_slot, dim=1), 1, top_i)
        stacked = torch.stack(matched_all, dim=1)  # [Q, n_slots, nd1]
        partials = [emit_agg_partials(statics, staged, stacked[q])
                    if statics else [] for q, statics in enumerate(agg_statics)]
        return top_s, top_d, top_slot, total, partials

    def _merge_slots(self, passes, kk: int):
        """Merge per-slot top-k launches: ``passes`` is a list of passes,
        each one launch output per slot. Per slot and pass the per-query
        tile merge; the pools concatenate pass by pass, slot by slot (the
        JAX program's pool order, which decides ties); one top-k. Returns
        (top_s, top_d, top_slot, total [Q] i32)."""
        cand_s, cand_d, cand_slot = [], [], []
        hits = None
        for outs in passes:
            for i, (ts_, td_, th_) in enumerate(outs):
                s_i, d_i, h_i = tsc.merge_tile_topk_batched(ts_, td_, th_,
                                                            kk)
                cand_s.append(s_i)
                cand_d.append(d_i)
                cand_slot.append(torch.full_like(d_i, i))
                hits = h_i if hits is None else hits + h_i
        pool_s = torch.cat(cand_s, dim=1)
        top_s, top_i = top_k(pool_s, min(kk, pool_s.shape[1]))
        top_d = torch.gather(torch.cat(cand_d, dim=1), 1, top_i)
        top_slot = torch.gather(torch.cat(cand_slot, dim=1), 1, top_i)
        return top_s, top_d, top_slot, hits

    def execute_batched_pruned(self, live_key: str, plans: List[dict],
                               w_all: np.ndarray, *, q_pad: int, q_real: int,
                               kk: int, t_pad: int, cb: int, sub: int):
        """The pruned batched program (``plans``: one ``plan_pruned_tiles``
        dict per slot, every one with the same probe and rest sizes):

        - probe pass: every slot scores its probe tiles;
        - the global threshold per query: the kk-th best of the slots'
          probe candidates in slot order (``tile_scoring.probe_threshold``,
          the kk-th score of the merged probe pool), +inf for padding
          members (q >= q_real);
        - gate: a slot's rest tile survives iff some member's bound
          reaches its threshold; the others' row tables are zeroed with
          ``torch.where`` (the program runs the occupied slots only: a
          dead slot of the generation's headroom launches nothing);
        - rest pass; then the pools merge, probe before rest.

        No host sync between the passes. Returns (top_s, top_d, top_slot,
        total [Q] i32, tiles_scored i32, tiles_total int)."""
        dev = self.device

        def put(key):
            return torch.from_numpy(np.ascontiguousarray(
                np.stack([p[key] for p in plans]))).to(dev)

        rl_p, rh_p, tid_p = put("rl_probe"), put("rh_probe"), put("tid_probe")
        rl_r, rh_r, tid_r = put("rl_rest"), put("rh_rest"), put("tid_rest")
        bounds_r = put("bounds_rest")  # [n_slots, n_rest, Q]
        w_t = torch.from_numpy(w_all).to(dev)
        live = self._seg_staged[live_key]
        kw = dict(t_pad=t_pad, cb=cb, sub=sub, k=kk, dense=False,
                  q_batch=q_pad, codec=self._kernel["codec"])
        probe = [tsc.score_tiles(*self._corpus(i), live[i], rl_p[i], rh_p[i],
                                 w_t[i], tile_ids=tid_p[i], **kw)
                 for i in range(self.n_occupied)]
        theta = tsc.probe_threshold([o[0] for o in probe], kk, q_pad, q_real)
        survive = (bounds_r >= theta[None, None, :]).any(dim=2)
        rest = []
        for i in range(self.n_occupied):
            rl2, rh2, tid2 = tsc.gate_rows(survive[i], rl_r[i], rh_r[i],
                                           tid_r[i])
            rest.append(tsc.score_tiles(*self._corpus(i), live[i], rl2, rh2,
                                        w_t[i], tile_ids=tid2, **kw))
        top_s, top_d, top_slot, hits = self._merge_slots([probe, rest], kk)
        n_probe, n_rest = tid_p.shape[1], tid_r.shape[1]
        n_occ = self.n_occupied
        scored = survive.sum(dtype=torch.int32) + n_occ * n_probe
        return (top_s, top_d, top_slot, hits, scored,
                n_occ * (n_probe + n_rest))


def _annotate_members(members, out, q_batch: int) -> None:
    """A served batch's shape (and a pruned launch's tile economy) on
    each profiled member's tracer: the launch the members shared."""
    if out is None:
        return
    for q, tracer in members:
        tracer.annotate("batch_size", q_batch)
        tracer.annotate("batch_member_index", q)
        for key, v in (out[q].get("pruned") or {}).items():
            if key != "total_relation":
                tracer.annotate(key, int(v))


class IndexMeshSearch:
    """Routes an index's query phase through the stacked one-device mesh
    program. Eligible searches run over all (shard, segment) pairs at once;
    anything the program does not cover returns None and the caller uses
    the host rung. The staged generation is keyed by the segment set and
    its live-doc counts: a refresh that adds segments appends them into
    free slots (``delta_append``), a delete rewrites its slot's live rows
    (``apply_tombstones``), and anything else (a merge, exhausted slots,
    a codec change, ``index.staging.delta.enabled: false``) rebuilds the
    generation."""

    # request keys the batched mesh_pallas program covers (and the pruned
    # single-query shortcut): plain relevance-ranked queries
    BATCHABLE_KEYS = frozenset({
        "query", "size", "from", "timeout",
        "allow_partial_search_results", "stats", "profile",
    })
    # request keys the mesh program does not cover: the host rung serves
    UNSUPPORTED = ("collapse",)

    def __init__(self, index_service):
        self.svc = index_service
        self._executor: Optional[MeshPlanExecutor] = None
        self._staged_key = None
        self.query_total = 0
        # queries whose scoring ran on the tile kernel inside the program
        self.pallas_query_total = 0
        # kNN queries served by kernel 3 on the mesh plane
        self.knn_query_total = 0
        self.batched_launch_total = 0
        # block-max pruned scoring: queries served pruned and the tiles
        # they scored and skipped
        self.pruned_query_total = 0
        self.tiles_scored_total = 0
        self.tiles_pruned_total = 0
        # full generation rebuilds, delta appends, tombstone updates and
        # compaction passes
        self.restage_total = 0
        self.delta_restage_total = 0
        self.tombstone_update_total = 0
        self.compaction_runs_total = 0
        # aggregations reduced inside the mesh program, and those served by
        # the host reduce instead, by reason
        self.agg_fused_query_total = 0
        self.agg_host_fallback_total = 0
        self.agg_host_fallback_by_reason: Dict[str, int] = {}
        # bytes of the per-slot masks and scores a host reduce copied
        self.host_mask_bytes_total = 0
        # plane-ladder decisions "plane.reason" -> count
        self.decisions: Dict[str, int] = {}
        settings = index_service.settings
        self.max_slots = INDEX_SEARCH_MESH_MAX_SLOTS.get(settings)
        self.plane_pref = INDEX_SEARCH_MESH_PLANE.get(settings)
        self.plane_health = PlaneHealth(
            INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN.get(settings))
        self._counter_lock = threading.Lock()
        self._stage_lock = threading.Lock()
        # a terminal staging fault benches the staging until this monotonic
        # deadline; after it exactly one query probes the restage
        # (_stage_probing) while its peers serve the host rung
        self._staging_fault_until = 0.0
        self._staging_faulted = False
        self._stage_probing = False
        # a budget eviction dropped the generation: the next staging is a
        # probe restage
        self._evicted_since = False
        self._denied = threading.local()

    @property
    def staging_denied_reason(self) -> Optional[str]:
        """Why the last staging attempt of this thread turned away
        (``hbm_budget`` / ``staging_fault``), thread-local."""
        return getattr(self._denied, "reason", None)

    @staging_denied_reason.setter
    def staging_denied_reason(self, value: Optional[str]) -> None:
        self._denied.reason = value

    def _note(self, plane: str, reason: str, n: int = 1) -> None:
        """A plane-ladder decision, counted per query (``n``: a batch's
        members), here and in the index's telemetry
        (``search.phases.decisions``)."""
        key = f"{plane}.{reason}"
        with self._counter_lock:
            self.decisions[key] = self.decisions.get(key, 0) + n
        self.svc.telemetry.note_decision(plane, reason, n)

    def _current_pairs(self) -> List[Tuple[int, object]]:
        pairs = []
        for sid in sorted(self.svc.shards):
            eng = self.svc.shards[sid].engine
            for seg in eng.searchable_segments():
                if seg.num_docs > 0:
                    pairs.append((sid, seg))
        return pairs

    @staticmethod
    def _key_for(pairs) -> frozenset:
        """Staged-set identity, order-independent: the segments and their
        live-doc counts (deletes mutate a sealed segment's live mask in
        place, which must tombstone the staged live rows)."""
        return frozenset((sid, id(seg), seg.live_doc_count)
                         for sid, seg in pairs)

    def _restage_reason(self, old_key, new_key, old_executor,
                        n_slots_needed: int) -> str:
        """Why the generation restages (the ledger's event reason): a slot
        geometry change, a segment-set change (refresh or merge), a
        live-mask invalidation (deletes), or a restage after a budget
        eviction (probe: each generation is a fresh scope, so the
        accountant cannot infer it)."""
        if old_key is None or old_executor is None:
            if self._evicted_since:
                self._evicted_since = False
                return "probe"
            return "initial"
        if old_executor.n_slots != n_slots_needed:
            return "geometry_change"
        if ({(sid, seg_id) for sid, seg_id, _n in old_key}
                != {(sid, seg_id) for sid, seg_id, _n in new_key}):
            return "refresh"
        return "delete_invalidation"

    def _delta_enabled(self) -> bool:
        """``index.staging.delta.enabled``: the cluster-level override while
        one is set (``put_cluster_settings``), else the index's settings
        as they stand (``PUT /{index}/_settings`` changes them)."""
        override = self.svc.staging_delta_enabled_override
        if override is not None:
            return bool(override)
        return bool(INDEX_STAGING_DELTA_ENABLED.get(self.svc.settings))

    def _classify_delta(self, old: MeshPlanExecutor, pairs):
        """Whether the staged-key change can be served as a delta on the
        live generation: ``("tombstone", changed_slots)`` when only
        live-doc counts changed, ``("append", changed)`` when segments
        were added within the free slots (deletes may ride along), or None
        for the full rebuild (segments retired, slots exhausted, a
        tile-geometry mismatch, a codec change)."""
        staged_counts = {(sid, kid): n for sid, kid, n in self._staged_key}
        slot_of = {(sid, id(seg)): slot
                   for slot, (sid, seg) in enumerate(old.pairs)}
        if set(slot_of) != set(staged_counts):
            return None  # key and generation disagree: rebuild from truth
        new_ids = {(sid, id(seg)) for sid, seg in pairs}
        if not set(slot_of) <= new_ids:
            return None  # segments retired (a merge): rebuild
        if self.svc.postings_codec != old.postings_codec_pref:
            return None  # codec change: rebuild
        appended = [seg for sid, seg in pairs if (sid, id(seg)) not in slot_of]
        changed = frozenset(
            (sid, id(seg)) for sid, seg in pairs
            if (sid, id(seg)) in slot_of
            and staged_counts[(sid, id(seg))] != seg.live_doc_count)
        if not appended:
            if not changed:
                return None
            return ("tombstone", sorted(slot_of[c] for c in changed))
        if not MeshPlanExecutor.delta_append_compatible(old, appended):
            return None
        return ("append", changed)

    def _bench_staging(self, what: str) -> None:
        """A terminal staging fault: bench the staging for the cooldown and
        quarantine the plane (reason ``staging_fault``); the host rung
        serves, visibly."""
        _plane_logger.warning(
            "[%s] mesh %s failed; serving from the host rung for %.1fs "
            "(reason staging_fault)", self.svc.name, what,
            self.plane_health.cooldown_s, exc_info=True)
        self._staging_faulted = True
        self._staging_fault_until = (_time.monotonic()
                                     + self.plane_health.cooldown_s)
        self.plane_health.record_failure("mesh_pallas",
                                         reason="staging_fault")
        self.staging_denied_reason = "staging_fault"

    def _apply_delta(self, old: MeshPlanExecutor, delta, pairs,
                     key) -> Optional[bool]:
        """Serve a classified delta on (tombstone) or over (append) the
        live generation (caller holds ``_stage_lock``). True on success,
        False on a terminal fault or a budget denial (the host rung
        serves), None when a structural surprise says rebuild."""
        self.staging_denied_reason = None
        kind_of, arg = delta
        try:
            if kind_of == "tombstone":
                run_staged(lambda: old.apply_tombstones(arg),
                           index=self.svc.name, kind="live_mask",
                           plane="mesh")
                self._staged_key = key
                with self._counter_lock:
                    self.tombstone_update_total += 1
                old.touch()
                self._maybe_compact()
                return True
            slot_of = {(sid, id(seg)) for sid, seg in old.pairs}
            appended = [seg for sid, seg in pairs
                        if (sid, id(seg)) not in slot_of]
            # budget-gate the delta rows only: the carried tables are in
            # the ledger under the old scope
            estimate = sum(seg.block_docs.nbytes + seg.block_tfs.nbytes
                           + seg.norms.nbytes + seg.nd_pad + 1
                           for seg in appended)
            if not memory_accountant().try_reserve(
                    self.svc.name, estimate, exclude_scope=old.scope):
                self.staging_denied_reason = "hbm_budget"
                return False
            MeshPlanExecutor.stage_delta_segments(old, appended)
            staged = run_staged(
                lambda: MeshPlanExecutor.delta_append(old, pairs, arg),
                index=self.svc.name, kind="mesh_slot_tables", plane="mesh")
        except _DeltaIneligible:
            return None
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — a terminal classified staging
            # fault: the attempt published nothing, the pre-attempt ledger
            # is exact; bench as a rebuild fault would
            self._bench_staging("delta staging")
            return False
        old.release()
        self._executor = staged
        self._staged_key = key
        with self._counter_lock:
            self.delta_restage_total += 1
            if arg:
                self.tombstone_update_total += 1
        staged.make_evictable(self._evict_generation(staged))
        self._maybe_compact()
        return True

    def _maybe_compact(self) -> None:
        """After a delta commit, the owner decides whether to compact and
        runs it off the query path."""
        hook = getattr(self.svc, "maybe_compact_async", None)
        if hook is not None:
            hook()

    def _ensure_staged(self) -> Optional[MeshPlanExecutor]:
        """The current generation, staged (appended, tombstoned or
        rebuilt) for the current segment set, or None with
        ``staging_denied_reason`` when the host rung must serve."""
        ok = self._ensure_staged_ok()
        return self._executor if ok else None

    def _ensure_staged_ok(self) -> bool:
        self.staging_denied_reason = None
        # after a terminal staging fault the staging is benched for the
        # quarantine cooldown: every query until then serves the host rung
        # instead of paying the staging attempt again
        if _time.monotonic() < self._staging_fault_until:
            self.staging_denied_reason = "staging_fault"
            return False
        pairs = self._current_pairs()
        if not pairs:
            return False
        if len(pairs) > 1 * max(self.max_slots, 1):
            return False  # packing bound: n_dev (1) x max_slots_per_device
        key = self._key_for(pairs)
        if key != self._staged_key or self._executor is None:
            if self._stage_probing:
                # single flight: a restage probe after a fault is in flight
                # on a peer; serve the host rung until it commits
                self.staging_denied_reason = "staging_fault"
                return False
            with self._stage_lock:
                executor = self._executor
                if key == self._staged_key and executor is not None:
                    executor.touch()
                    return True  # a peer staged this set while we waited
                if _time.monotonic() < self._staging_fault_until:
                    self.staging_denied_reason = "staging_fault"
                    return False
                old = self._executor
                if (old is not None and self._staged_key is not None
                        and not self._staging_faulted
                        and self._delta_enabled()):
                    delta = self._classify_delta(old, pairs)
                    if delta is not None:
                        handled = self._apply_delta(old, delta, pairs, key)
                        if handled is not None:
                            return handled
                return self._stage_rebuild(pairs, key)
        executor = self._executor
        if executor is not None:
            executor.touch()
        return executor is not None

    def _stage_rebuild(self, pairs, key, reason: Optional[str] = None) -> bool:
        """Full-generation build and install (caller holds _stage_lock):
        the delta paths' fallback and the compaction pass's restage."""
        self.staging_denied_reason = None
        spd = len(pairs)
        if self._delta_enabled() and spd < max(self.max_slots, 1):
            # headroom for one refresh's worth of appended segments (a
            # refresh seals at most one a shard), bounded by the packing
            # limit
            spd = min(spd + max(1, len(self.svc.shards)),
                      max(self.max_slots, 1))
        n_slots = spd
        # the budget gate: a per-slot estimate (the ledger then records the
        # exact bytes); a denial demotes to the host rung, never an error
        estimate = n_slots * max(
            seg.block_docs.nbytes + seg.block_tfs.nbytes
            + seg.norms.nbytes + seg.nd_pad + 1 for _sid, seg in pairs)
        if not memory_accountant().try_reserve(self.svc.name, estimate):
            self.staging_denied_reason = "hbm_budget"
            return False
        if reason is None:
            reason = self._restage_reason(self._staged_key, key,
                                          self._executor, n_slots)
        if self._staging_faulted:
            self._stage_probing = True
        old = self._executor
        try:
            # constructed unarmed (not evictable), installed, then armed
            # (make_evictable); one transactional attempt through the
            # classified retry loop
            staged = run_staged(
                lambda: MeshPlanExecutor(
                    [seg for _, seg in pairs], self.svc.device,
                    postings_codec=self.svc.postings_codec,
                    postings_codec_default=self.svc.postings_codec_default,
                    index_name=self.svc.name, stage_reason=reason,
                    slots_per_dev=spd),
                index=self.svc.name, kind="mesh_slot_tables", plane="mesh")
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — a terminal staging fault
            self._bench_staging("staging")
            return False
        finally:
            self._stage_probing = False
        staged.pairs = pairs
        if old is not None:
            old.release()
        self._executor = staged
        self._staged_key = key
        self._staging_faulted = False
        self._staging_fault_until = 0.0
        with self._counter_lock:
            self.restage_total += 1
        staged.make_evictable(self._evict_generation(staged))
        return True

    def _evict_generation(self, executor: MeshPlanExecutor):
        """The budget's eviction callback for one generation (run under
        the accountant's lock, so it takes no lock of its own): drop the
        generation if it is still the current one and return its ledger
        bytes. Queries holding it finish on its tensors. The generation
        holds its callback, so the callback holds the generation weakly: a
        replaced generation frees when its last reference drops, not at
        the next cycle collection."""
        ref = weakref.ref(executor)

        def evict() -> None:
            victim = ref()
            if victim is None:
                return
            if self._executor is victim:
                self._executor = None
                self._staged_key = None
                self._evicted_since = True
            victim.release()

        return evict

    def _drop_staging(self) -> None:
        """Drop the staged generation and its tensors (the index closed, or
        a shard was quarantined); an eligible query after this would stage
        it again. The budget's eviction runs ``_evict_generation``
        instead: under the accountant's lock it takes no lock of its own
        and leaves the tensors to the queries that hold them."""
        with self._stage_lock:
            executor, self._executor = self._executor, None
            self._staged_key = None
        if executor is not None:
            executor.drop()

    def staging_slot_stats(self) -> Optional[dict]:
        """The live generation's slot occupancy: free slots and each
        slot's tombstone density (the ``_cat/staging`` surface and the
        compaction trigger's inputs). None when nothing is staged."""
        executor = self._executor
        if executor is None:
            return None
        slots = []
        for slot, (sid, seg) in enumerate(executor.pairs):
            total = int(seg.num_docs)
            live = int(seg.live_doc_count)
            slots.append({
                "slot": slot, "shard": int(sid), "segment": seg.name,
                "docs": total, "live": live,
                "tombstone_density": (round(1.0 - live / total, 4)
                                      if total else 0.0),
            })
        free = executor.free_slots()
        return {
            "n_slots": executor.n_slots,
            "slots_per_device": executor.slots_per_dev,
            "free_slots": free,
            "free_slots_per_device": round(free / executor.n_dev, 2),
            "slots": slots,
        }

    def note_compaction_run(self) -> None:
        with self._counter_lock:
            self.compaction_runs_total += 1

    def restage_for_compaction(self) -> bool:
        """The compaction pass's restage: a fresh generation over the
        current segment set with fresh headroom, classified
        ``compaction``; the old generation is released. Off the query
        path (the owner's single-flight pass calls it)."""
        pairs = self._current_pairs()
        if not pairs or len(pairs) > max(self.max_slots, 1):
            return False
        key = self._key_for(pairs)
        with self._stage_lock:
            if self._executor is None:
                return False  # nothing staged: the next query stages cold
            return self._stage_rebuild(pairs, key, reason="compaction")

    @staticmethod
    def _needs_counts(q) -> bool:
        """Cheap body-level pre-check for the Q == 1 pruned path: a query
        carrying minimum_should_match or operator is likely to need the
        dense-counts variant, which query_batch rejects only after building
        every slot's plan; skipping it here saves that planning (a false
        positive only costs the pruned path, never correctness)."""
        if isinstance(q, dict):
            return any(k in ("minimum_should_match", "operator")
                       or IndexMeshSearch._needs_counts(v)
                       for k, v in q.items())
        if isinstance(q, list):
            return any(IndexMeshSearch._needs_counts(v) for v in q)
        return False

    def _pruning_config(self):
        """(enabled, probe_tiles): each the cluster-level override while
        one is set (``PUT _cluster/settings``), else the index settings
        (search.pallas.pruning.*, seeded from the node); a request
        admitted under the brownout's first step forces ``enabled``."""
        settings = self.svc.settings
        enabled = self.svc.pruning_enabled_override
        probe = self.svc.pruning_probe_override
        enabled = (SEARCH_PALLAS_PRUNING_ENABLED.get(settings)
                   if enabled is None else bool(enabled))
        # brownout step 1: under admission pressure the pruned kernel (1e)
        # serves what it can, cheaper tiles before shedding features; the
        # request's admission token decided it, as it marked the answer
        if not enabled and forced_pruning():
            enabled = True
        return (enabled,
                SEARCH_PALLAS_PRUNING_PROBE_TILES.get(settings)
                if probe is None else int(probe))

    def _fused_aggs_enabled(self) -> bool:
        """A cluster-level ``search.aggs.fused`` while one is set, then the
        index's ``index.search.aggs.fused`` ("default" follows the node's
        ``search.aggs.fused``, seeded into the index settings)."""
        if self.svc.aggs_fused_override is not None:
            return bool(self.svc.aggs_fused_override)
        settings = self.svc.settings
        idx = settings.get(INDEX_SEARCH_AGGS_FUSED.key)
        if isinstance(idx, bool):  # a body's boolean through with_index_prefix
            return idx
        idx = INDEX_SEARCH_AGGS_FUSED.get(settings)
        if idx in ("true", "false"):
            return idx == "true"
        return SEARCH_AGGS_FUSED.get(settings)

    def _note_agg_fallback(self, reason: str, n: int = 1) -> None:
        with self._counter_lock:
            self.agg_host_fallback_total += n
            self.agg_host_fallback_by_reason[reason] = \
                self.agg_host_fallback_by_reason.get(reason, 0) + n

    def _resolve_fused_aggs(self, agg_specs, executor):
        """(FusedAggPlan or None, fallback reason or None) for a mesh-
        served request's agg set: all or nothing. A doc-value staging the
        budget turns away or that faults terminally demotes the
        aggregations (not the query) to the host reduce (``hbm_budget``,
        ``staging_fault``)."""
        if not self._fused_aggs_enabled():
            return None, "disabled"
        from elasticsearch_tpu_torch.search.fused_aggs import (
            resolve_fused_aggs,
        )

        return resolve_fused_aggs(agg_specs, executor)

    def _ctx(self, sid: int, session):
        from elasticsearch_tpu_torch.search.query_dsl import ShardQueryContext

        shard = self.svc.shards[sid]
        ctx = ShardQueryContext(shard.mapper_service, shard.engine)
        ctx.for_mesh = True
        ctx.mesh_kernel = session
        return ctx

    def _sort_plan(self, body: dict, executor: MeshPlanExecutor):
        """Resolve the request's sort to staged key columns: (sort,
        sort_spec) with ``sort`` None for relevance or the column dict of
        ``ensure_sort_column``; ("fallback", reason) when the sort cannot
        run on the mesh (``sort_ineligible``, or the staging's
        ``hbm_budget`` / ``staging_fault``)."""
        from elasticsearch_tpu_torch.search.service import normalize_sort

        sort_spec = normalize_sort(body.get("sort"))
        if sort_spec is None:
            return None, None
        if len(sort_spec) != 1:
            return "fallback", "sort_ineligible"
        field, order, missing = sort_spec[0]
        if not isinstance(field, str) or field == "_geo_distance":
            return "fallback", "sort_ineligible"
        # (a lone _score sort never gets here: normalize_sort makes it
        # relevance ranking)
        if isinstance(missing, dict):
            return "fallback", "sort_ineligible"
        if isinstance(missing, str) and missing not in ("_last", "_first"):
            return "fallback", "sort_ineligible"  # the host rung's errors
        if isinstance(missing, (int, float)) and not isinstance(
                missing, bool):
            # the fill is a rank key like any value
            if float(np.float32(missing)) != float(missing):
                return "fallback", "sort_ineligible"
        sort = executor.ensure_sort_column(field, order, missing)
        if sort is None:
            return "fallback", (executor.kernel_denied_reason
                                or "sort_ineligible")
        return sort, sort_spec

    @staticmethod
    def _search_after_key(search_after, sort_spec,
                          sort) -> Optional[float]:
        """The request's search_after cursor in the oriented-key space of
        the staged rank column (strictly after == key < value), or None
        when the cursor cannot cut exactly on the mesh."""
        import bisect

        from elasticsearch_tpu_torch.search.service import _missing_fill

        if not isinstance(search_after, (list, tuple)):
            return None
        if len(search_after) != 1:
            return None  # one value for the one-field sort
        after = search_after[0]
        if sort_spec is None:
            # relevance paging: scores strictly below the cursor's
            try:
                v = float(after)
            except (TypeError, ValueError):
                return None
            if float(np.float32(v)) != v:
                return None  # f32 rounding could move the boundary
            return v
        _field, order, missing = sort_spec[0]
        vocab = sort["vocab"]
        if vocab is not None:
            if after is None:
                # a null cursor is a missing doc's rendered key: the fill
                # the column staged
                if missing == "_first":
                    anchor = _SORT_BIG if order == "desc" else -_SORT_BIG
                else:
                    anchor = -_SORT_BIG if order == "desc" else _SORT_BIG
            else:
                # the cursor string in global-ordinal space; a string
                # between terms sits at its bisect position - 0.5
                text = str(after)
                pos = bisect.bisect_left(vocab, text)
                present = pos < len(vocab) and vocab[pos] == text
                anchor = float(pos) if present else pos - 0.5
                if float(np.float32(anchor)) != anchor:
                    return None  # pos - 0.5 loses exactness past 2^23
            oriented = anchor if order == "desc" else -anchor
            return float(np.clip(oriented, -_SORT_BIG, _SORT_BIG))
        if after is None:
            anchor = _missing_fill(missing, order)
        else:
            try:
                anchor = float(after)
            except (TypeError, ValueError):
                return None
            if float(np.float32(anchor)) != anchor:
                return None
        oriented = anchor if order == "desc" else -anchor
        return float(np.clip(oriented, -_SORT_BIG, _SORT_BIG))

    def query(self, body: dict, k: int, deadline=None,
              tracer=None) -> Optional[dict]:
        """Returns {total, refs, max_score, aggregations, terminated_early,
        plane} or None when the mesh plane does not serve this request.
        deadline: checkpointed before and after the staging and before each
        plane's launch, never between a launch and the read of its output;
        expiry raises ``TimeExceededException`` to the caller's partial
        result. tracer: the request's phase spans (resolve as
        parse_rewrite, staging, plan_build, the program as kernel up to its
        synchronize, finalize as merge and aggregate)."""
        from elasticsearch_tpu_torch.search.aggregations import (
            SegmentView,
            parse_aggs,
            run_aggregations,
        )
        from elasticsearch_tpu_torch.search.query_dsl import parse_query
        from elasticsearch_tpu_torch.search.service import (
            _STR_SENTINEL_HIGH,
            _STR_SENTINEL_LOW,
            DocRef,
            _normalize_rescore,
        )

        if tracer is None:
            tracer = NULL_TRACER
        body = body or {}
        if any(body.get(key) is not None for key in self.UNSUPPORTED):
            self._note("host", "unsupported_body")
            return None
        if len(self.svc.shards) < 2:
            self._note("host", "single_shard")
            return None
        if self.svc.index_sort:
            # index-sorted early termination on the host rung beats a
            # top-k over the stacked slots
            self._note("host", "index_sorted")
            return None
        if deadline is not None:
            deadline.checkpoint()
        t_stage = tracer.start("staging")
        executor = self._ensure_staged()
        tracer.stop("staging", t_stage)
        if executor is None:
            self._note("host", self.staging_denied_reason
                       or "staging_unavailable")
            return None
        if deadline is not None:
            deadline.checkpoint()  # the staging may have taken a while
        self.plane_health.cooldown_s = \
            INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN.get(self.svc.settings)
        pruning_on, _probe = self._pruning_config()
        if (pruning_on and isinstance(body.get("query"), dict)
                and all(key in self.BATCHABLE_KEYS for key in body)
                and int(body.get("size") if body.get("size") is not None
                        else 10) > 0
                and not self._needs_counts(body.get("query"))
                and self.plane_pref in ("auto", "pallas")
                and self.plane_health.available("mesh_pallas")):
            # the block-max pruned single-query path: a plain
            # relevance-ranked query rides the batched rung's pruned
            # program with Q == 1. Anything needing every tile's dense
            # output (aggs, counts, size 0, post_filter, min_score, a
            # sort, search_after, slice, rescore, terminate_after, and
            # track_total_hits, which asks for the exact total) fails the
            # filter above and runs exhaustively below.
            out = self.query_batch([body], deadline=deadline,
                                   tracers=[tracer])
            if out is not None:
                r = out[0]
                return {"total": r["total"], "refs": r["refs"],
                        "max_score": r["max_score"], "aggregations": None,
                        "terminated_early": None, "plane": r["plane"],
                        "pruned": r.get("pruned")}
        t_parse = tracer.start("parse_rewrite")
        agg_specs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        sort, sort_spec = self._sort_plan(body, executor)
        if sort == "fallback":
            self._note("host", sort_spec)
            return None
        # fused aggregations: when every spec is inside the envelope, the
        # reduction runs in the program and the [n_slots, nd1] masks never
        # cross to the host; otherwise the host reduce over the views
        agg_plan = agg_reason = None
        if agg_specs:
            agg_plan, agg_reason = self._resolve_fused_aggs(agg_specs,
                                                            executor)
        min_score = body.get("min_score")
        if min_score is not None:
            ms = float(min_score)
            if float(np.float32(ms)) != ms:
                self._note("host", "feature_ineligible")
                return None  # an f32 compare could move the cut
            min_score = ms
        columns: Dict[str, torch.Tensor] = {}
        if sort is not None:
            columns.update(sort["columns"])
        slice_col = None
        slice_spec = body.get("slice")
        if slice_spec is not None:
            if (not isinstance(slice_spec, dict)
                    or "id" not in slice_spec or "max" not in slice_spec):
                return None  # the host rung owns the error
            try:
                cols = executor.ensure_slice_column(
                    slice_spec, len(self.svc.shards))
            except KernelError:
                raise
            except Exception:  # noqa: BLE001 — the host rung owns errors
                return None
            if cols is None:
                self._note("host", executor.kernel_denied_reason
                           or "staging_unavailable")
                return None
            (slice_col,) = cols
            columns.update(cols)
        after_key = None
        search_after = body.get("search_after")
        if search_after is not None:
            after_key = self._search_after_key(search_after, sort_spec, sort)
            if after_key is None:
                self._note("host", "feature_ineligible")
                return None
        terminate_after = body.get("terminate_after")
        rescore = rs_qb = None
        rescore_specs = _normalize_rescore(body.get("rescore"))
        if rescore_specs and sort_spec is None:
            if len(rescore_specs) != 1:
                self._note("host", "feature_ineligible")
                return None  # chained rescorers: the host rung
            spec = rescore_specs[0]
            rescore = {"window": spec["window_size"],
                       "score_mode": spec["score_mode"],
                       "query_weight": spec["query_weight"],
                       "rescore_query_weight": spec["rescore_query_weight"]}
            rs_qb = parse_query(spec["rescore_query"])
        # (a rescore beside an explicit sort does nothing on the host
        # rung either)
        qb = parse_query(body.get("query"))
        pf_qb = (parse_query(body["post_filter"])
                 if body.get("post_filter") else None)
        tracer.stop("parse_rewrite", t_parse)

        admissions: Dict[str, str] = {}
        kernel_session = None
        if self.plane_pref in ("auto", "pallas"):
            admissions["mesh_pallas"] = self.plane_health.admit(
                "mesh_pallas")
            if admissions["mesh_pallas"]:
                t_stage = tracer.start("staging")
                kernel_session = executor.ensure_kernel()
                tracer.stop("staging", t_stage)
                reason = executor.kernel_denied_reason
                if kernel_session is None and reason:
                    # the budget or a staging fault turned the kernel
                    # staging away: the ladder's next rung serves
                    self._note("mesh_pallas", reason)
                    if reason == "staging_fault":
                        self.plane_health.record_failure(
                            "mesh_pallas", reason="staging_fault")
            else:
                self._note("mesh_pallas", "quarantined")
        attempts = []
        if kernel_session is not None:
            attempts.append(("mesh_pallas", kernel_session))
        if self.plane_pref != "pallas":
            admissions["mesh"] = self.plane_health.admit("mesh")
            if admissions["mesh"]:
                attempts.append(("mesh", None))
        outs = None
        used_pallas = False
        try:
            for plane, session in attempts:
                try:
                    # fault injection: PlaneFailScheme raises here (a
                    # fault of this plane), MeshPlaneDelayScheme holds the
                    # request here, before the checkpoint
                    on_plane_execute(self.svc.name, plane)
                    if deadline is not None:
                        # before committing to this plane's launch
                        deadline.checkpoint()
                    t_plan = tracer.start("plan_build")
                    plans = []
                    pf_plans = [] if pf_qb is not None else None
                    rs_plans = [] if rs_qb is not None else None
                    for sid, seg in executor.pairs:
                        ctx = self._ctx(sid, session)
                        plans.append(qb.to_plan(ctx, seg))
                        # post_filter and rescore plans stay on scatter
                        # nodes
                        ctx.mesh_kernel = None
                        if pf_qb is not None:
                            pf_plans.append(pf_qb.to_plan(ctx, seg))
                        if rs_qb is not None:
                            rs_plans.append(rs_qb.to_plan(ctx, seg))
                    used_pallas = (session is not None and
                                   executor.harmonize_kernel_nodes(plans) > 0)
                    tracer.stop("plan_build", t_plan)
                    on_kernel_launch(self.svc.name, plane)
                    t_kernel = tracer.start("kernel")
                    outs = run_variant(
                        "serial",
                        (plane, executor.n_slots, executor.nd_pad,
                         executor.postings_codec, agg_plan is not None,
                         sort is not None, rescore is not None),
                        lambda: executor.execute(
                            plans, k,
                            with_views=bool(agg_specs) and agg_plan is None,
                            pf_plans=pf_plans, min_score=min_score,
                            agg_static=(agg_plan.statics
                                        if agg_plan is not None else ()),
                            columns=columns,
                            sort_keys=((sort["key"], sort["raw"])
                                       if sort is not None else None),
                            slice_col=slice_col, search_after=after_key,
                            rs_plans=rs_plans, rescore=rescore))
                    if self.svc.device.type == "cuda":
                        torch.cuda.synchronize(self.svc.device)
                    tracer.stop("kernel", t_kernel)
                    self.plane_health.note_success(plane)
                    break
                except (PlanStructureMismatch, NotImplementedError):
                    self._note(plane, "shape_mismatch")
                    continue
                except (KernelError, TimeExceededException):
                    # a kernel that fails to build or launch raises: no
                    # other rung serves in its place; an expired deadline
                    # is no plane fault
                    raise
                except Exception as e:  # noqa: BLE001 — plane fault:
                    # bench the plane for the cooldown, serve from the
                    # next rung. A request error (4xx) is no plane fault:
                    # it raises as it would on the host rung.
                    if (isinstance(e, ElasticsearchTpuException)
                            and e.status_code < 500):
                        raise
                    _plane_logger.warning(
                        "[%s] execution plane [%s] failed; quarantined "
                        "for %.1fs", self.svc.name, plane,
                        self.plane_health.cooldown_s, exc_info=True)
                    self.plane_health.record_failure(plane)
                    self._note(plane, "fault")
                    continue
        finally:
            for plane, adm in admissions.items():
                if adm == "probe":
                    self.plane_health.release_probe(plane)
        if outs is None:
            self._note("host", "no_mesh_plane")
            return None
        plane = "mesh_pallas" if used_pallas else "mesh"
        with self._counter_lock:
            self.query_total += 1
            if used_pallas:
                self.pallas_query_total += 1
        self._note(plane, "served")
        # per-shard search stats stay attributed though the program runs
        # every shard at once
        for sid in self.svc.shards:
            self.svc.shards[sid].searcher.note_query(body.get("stats"))
        t_merge = tracer.start("merge")
        keys = outs["keys"].cpu().numpy()
        slots = outs["slots"].cpu().numpy()
        docs = outs["docs"].cpu().numpy()
        scores = outs["scores"].cpu().numpy()
        total = int(outs["total"])
        # terminate_after caps per shard and a slot holds one segment:
        # the slots' counts group by shard before the cap, as the host
        # rung's per-shard contract has it
        terminated_early = None
        if terminate_after:
            ta = int(terminate_after)
            counts = outs["counts"].cpu().numpy()
            by_shard: Dict[int, int] = {}
            for i, (sid, _seg) in enumerate(executor.pairs):
                by_shard[sid] = by_shard.get(sid, 0) + int(counts[i])
            total = sum(min(c, ta) for c in by_shard.values())
            terminated_early = any(c >= ta for c in by_shard.values())
        raws = outs["raws"].cpu().numpy() if sort is not None else None
        vocab = sort["vocab"] if sort is not None else None
        refs = []
        max_score = None
        for i, (key, slot, d, score) in enumerate(
                zip(keys, slots, docs, scores)):
            if key == -np.inf:
                continue
            sid, seg = executor.pairs[int(slot)]
            score = float(score)
            if sort is None:
                sv = (score,) if rescore is not None else ()
            else:
                # the missing fills come back as the host rung's
                # sentinels (+-inf, the string sentinels): all render null
                raw = float(raws[i])
                if vocab is not None:
                    if abs(raw) >= _SORT_BIG:
                        sv = (_STR_SENTINEL_HIGH if raw > 0
                              else _STR_SENTINEL_LOW,)
                    else:
                        sv = (vocab[int(round(raw))],)
                else:
                    if abs(raw) >= _SORT_BIG:
                        raw = np.inf if raw > 0 else -np.inf
                    sv = (raw,)
            refs.append(DocRef(sid, seg.name, int(d), score, seg, sv))
            if max_score is None and sort_spec is None:
                max_score = score
        tracer.stop("merge", t_merge)
        t_agg = tracer.start("aggregate")
        aggregations = None
        if agg_plan is not None:
            from elasticsearch_tpu_torch.search.fused_aggs import (
                finalize_fused,
            )

            aggregations = finalize_fused(
                agg_plan, [o.cpu().numpy() for o in outs["aggs"]],
                len(executor.pairs))
            with self._counter_lock:
                self.agg_fused_query_total += 1
        elif agg_specs:
            from elasticsearch_tpu_torch.search.query_dsl import (
                ShardQueryContext,
            )

            matched = outs["matched"].cpu().numpy()
            scores_all = outs["scores_all"].cpu().numpy()
            with self._counter_lock:
                self.host_mask_bytes_total += (matched.nbytes
                                               + scores_all.nbytes)
            views = []
            for i, (sid, seg) in enumerate(executor.pairs):
                nd1 = seg.nd_pad + 1
                views.append(SegmentView(
                    seg, matched[i, :nd1],
                    ShardQueryContext(self.svc.shards[sid].mapper_service,
                                      self.svc.shards[sid].engine),
                    scores_all[i, :nd1]))
            aggregations = run_aggregations(agg_specs, views)
            self._note_agg_fallback(agg_reason or "field_ineligible")
        if agg_specs:
            tracer.stop("aggregate", t_agg)
        return {"total": total, "refs": refs,
                "max_score": max_score, "aggregations": aggregations,
                "terminated_early": terminated_early, "plane": plane}

    def query_batch(self, bodies: List[dict], deadline=None,
                    tracers: Optional[list] = None) -> Optional[list]:
        """Cross-query micro-batching on the mesh_pallas rung: Q concurrent
        queries scored by one fused top-k launch per slot over the union
        of their lanes, or, with pruning on, by the pruned program (a tile
        survives when any member's bound reaches that member's threshold),
        or, when a member carries aggregations, by the batched dense agg
        program (one dense launch per slot; every member's agg set must be
        fused-eligible, else the batch leaves this rung).
        Returns one {total, refs, max_score, plane[, pruned][,
        aggregations]} dict per
        member, or None when the batch cannot run here (the caller falls
        to the host-batched rung). A plane fault quarantines mesh_pallas
        once for the whole batch; a ``KernelError`` raises.
        deadline: the single-query pruned path's (a batch checks each
        member's deadline before it forms). tracers: each member's; the
        batch's spans are recorded once and folded into every enabled
        one."""
        if self.plane_pref not in ("auto", "pallas"):
            return None
        adm = self.plane_health.admit("mesh_pallas")
        if not adm:
            self._note("mesh_pallas", "quarantined", len(bodies))
            return None
        members = [(q, t) for q, t in enumerate(tracers or [])
                   if t is not None and t.enabled]
        bt = QueryTracer() if members else NULL_TRACER
        try:
            out = self._query_batch_admitted(bodies, deadline, bt)
        finally:
            for _q, t in members:
                t.merge_from(bt)
            if adm == "probe":
                self.plane_health.release_probe("mesh_pallas")
        _annotate_members(members, out, len(bodies))
        return out

    def _query_batch_admitted(self, bodies, deadline=None,
                              tracer=NULL_TRACER) -> Optional[list]:
        from elasticsearch_tpu_torch.search.query_dsl import parse_query
        from elasticsearch_tpu_torch.search.service import DocRef

        if len(self.svc.shards) < 2:
            return None
        for body in bodies:
            body = body or {}
            if not isinstance(body.get("query"), dict):
                return None
            # an agg-carrying member rides the batched dense agg program
            # when its whole agg set is fused-eligible (resolved below)
            if any(key not in self.BATCHABLE_KEYS
                   and key not in ("aggs", "aggregations") for key in body):
                return None
        if self.svc.index_sort:
            return None
        t_stage = tracer.start("staging")
        executor = self._ensure_staged()
        if executor is None:
            tracer.stop("staging", t_stage)
            self._note("host", self.staging_denied_reason
                       or "staging_unavailable", len(bodies))
            return None
        session = executor.ensure_kernel()
        tracer.stop("staging", t_stage)
        if deadline is not None:
            deadline.checkpoint()
        if session is None:
            self._note("host", executor.kernel_denied_reason
                       or "staging_unavailable", len(bodies))
            if executor.kernel_denied_reason == "staging_fault":
                self.plane_health.record_failure("mesh_pallas",
                                                 reason="staging_fault")
            return None
        q_batch = len(bodies)
        ks = []
        for body in bodies:
            from_ = int(body.get("from", 0) or 0)
            size = (int(body.get("size"))
                    if body.get("size") is not None else 10)
            ks.append(max(from_ + size, 1))
        # pad the batch and kk to powers of two (the JAX package's
        # compiled-program buckets; dead rows score nothing)
        kk = tsc.next_pow2(max(ks))
        q_pad = tsc.next_pow2(q_batch)
        geom = session["geom"]
        n_pairs = len(executor.pairs)
        # per-member, per-slot lane sets from the same deferred plans as
        # the serial mesh path: the plan must be exactly one
        # kernel-scored disjunction. Built outside the fault handler: a
        # malformed body is that member's request error, served serially.
        t_plan = tracer.start("plan_build")
        try:
            lane_sets = [[None] * q_batch for _ in range(n_pairs)]
            for q, body in enumerate(bodies):
                qb = parse_query(body.get("query"))
                for slot, (sid, seg) in enumerate(executor.pairs):
                    plan = qb.to_plan(self._ctx(sid, session), seg)
                    if (not isinstance(plan, P.PallasScoreTermsNode)
                            or plan._mesh_lanes is None
                            or plan.with_counts):
                        # minimum_should_match > 1 needs the dense-counts
                        # variant the fused top-k kernel does not emit
                        return None
                    lane_sets[slot][q] = plan._mesh_lanes
        except Exception:  # noqa: BLE001 — request-shaped error: serial
            # execution surfaces it per member with the right status
            return None
        # fused aggs for the members: all or nothing per batch. If any
        # member's agg set is not fused-eligible, the whole batch goes to
        # the host rung, whose per-member pipeline serves every agg; each
        # eligible member reduces its own specs in the shared launch
        member_agg_plans = [None] * q_batch
        agg_members = [bool(b.get("aggs") or b.get("aggregations"))
                       for b in bodies]
        if any(agg_members):
            if not self._fused_aggs_enabled():
                self._note_agg_fallback("disabled", sum(agg_members))
                return None
            from elasticsearch_tpu_torch.search.aggregations import (
                parse_aggs,
            )

            for q, body in enumerate(bodies):
                if not agg_members[q]:
                    continue
                try:
                    specs = parse_aggs(body.get("aggs")
                                       or body.get("aggregations"))
                except Exception:  # noqa: BLE001 — request error: serial
                    # execution surfaces the member's 400
                    return None
                plan, reason = self._resolve_fused_aggs(specs, executor)
                if plan is None:
                    self._note_agg_fallback(reason or "field_ineligible")
                    return None
                member_agg_plans[q] = plan
        has_aggs = any(p is not None for p in member_agg_plans)
        tracer.stop("plan_build", t_plan)
        pruning, probe = self._pruning_config()
        if has_aggs:
            # skipped tiles would drop docs from the buckets: aggregations
            # always run the exhaustive dense form
            pruning = False
        if pruning and any(
                int(b.get("size") if b.get("size") is not None else 10) <= 0
                for b in bodies):
            # a size 0 member wants the exact total: the batch runs
            # exhaustively
            pruning = False
        codec = session["codec"]
        pruned_stats = None
        try:
            on_plane_execute(self.svc.name, "mesh_pallas")
            # shared batched tables: per-slot unions on one collective
            # geometry (a dense union on any slot shrinks every tile)
            unions = [tsc.union_query_lanes(lane_sets[slot])[0]
                      for slot in range(n_pairs)]
            t_pad = max(tsc.next_pow2(max(len(u), 1)) for u in unions)
            sub = geom.tile_sub
            if pruning:
                # pruning wants at least 2 * probe tiles: shrink the tile
                # (down to sub = 1; the JAX package's floor of 8 is a TPU
                # sublane bound), and if even that cannot give enough
                # tiles, keep the geometry and run exhaustively
                sub_p = sub
                while (sub_p > 1 and tsc.tile_geometry(
                        geom.nd_pad, sub_p).n_tiles < 2 * probe):
                    sub_p //= 2
                if tsc.tile_geometry(geom.nd_pad, sub_p).n_tiles >= 2 * probe:
                    sub = sub_p
                else:
                    pruning = False
            while True:
                g = geom if sub == geom.tile_sub else tsc.tile_geometry(
                    geom.nd_pad, sub)
                try:
                    tables = []
                    for slot, (_sid, seg) in enumerate(executor.pairs):
                        bmin, bmax = session["meta"][id(seg)][:2]
                        tables.append(tsc.build_tile_tables_batched(
                            lane_sets[slot], bmin, bmax, g, t_pad=t_pad))
                    break
                except ValueError:
                    if sub <= 32 or g.tile_sub < sub:
                        return None  # no shared geometry: host rung
                    sub //= 2
            cb = max(t[3] for t in tables)
            live_key = ("k_live_t" if g.tile_sub == geom.tile_sub
                        else executor.ensure_kernel_live(g.tile_sub))
            n_slots = n_pairs
            n_tiles = tables[0][0].shape[0]
            rl = np.zeros((n_slots, n_tiles, t_pad), np.int32)
            rh = np.zeros((n_slots, n_tiles, t_pad), np.int32)
            w_all = np.zeros((n_slots, q_pad, t_pad), np.float32)
            for slot in range(n_pairs):
                rl[slot] = tables[slot][0]
                rh[slot] = tables[slot][1]
                w_all[slot, :q_batch] = tables[slot][2]
            plans_p = None
            if pruning and n_tiles > probe:
                # per-slot pruning plans (host side: order the tiles by
                # bound, split probe / rest); the threshold exchange stays
                # on the device
                plans_p = []
                for slot in range(n_pairs):
                    seg = executor.pairs[slot][1]
                    bfmax = session["meta"][id(seg)][2]
                    ub = executor.tile_lane_ub_cached(
                        seg, unions[slot], rl[slot], rh[slot], bfmax,
                        g.tile_sub)
                    plan = tsc.plan_pruned_tiles(
                        rl[slot], rh[slot], w_all[slot], bfmax, probe, ub=ub)
                    if plan is None:
                        plans_p = None
                        break
                    plans_p.append(plan)
            agg_raw = None
            if deadline is not None:
                # before committing to the launch
                deadline.checkpoint()
            rung = "pruned" if plans_p is not None else "batched"
            on_kernel_launch(self.svc.name, rung)
            shape = (n_slots, q_pad, kk, t_pad, g.tile_sub, codec)
            t_kernel = tracer.start("kernel")
            if plans_p is not None:
                (top_s, top_d, top_slot, totals, scored,
                 tiles_total) = run_variant(
                    "pruned", shape + (probe,),
                    lambda: executor.execute_batched_pruned(
                        live_key, plans_p, w_all, q_pad=q_pad,
                        q_real=q_batch, kk=kk, t_pad=t_pad, cb=cb,
                        sub=g.tile_sub))
                scored = int(scored)
                pruned_stats = {"tiles_scored": scored,
                                "tiles_pruned": tiles_total - scored}
            elif has_aggs:
                # one dense launch a slot both ranks and aggregates the
                # burst; the matched masks reduce on the device
                agg_statics = tuple(
                    member_agg_plans[q].statics
                    if q < q_batch and member_agg_plans[q] is not None
                    else () for q in range(q_pad))
                top_s, top_d, top_slot, totals, agg_parts = run_variant(
                    "batched_agg", shape + (agg_statics,),
                    lambda: executor.execute_batched_dense_agg(
                        live_key, rl, rh, w_all, q_pad=q_pad, kk=kk,
                        t_pad=t_pad, cb=cb, sub=g.tile_sub,
                        agg_statics=agg_statics))
                agg_raw = [[o.cpu().numpy() for o in parts]
                           for parts in agg_parts]
            else:
                top_s, top_d, top_slot, totals = run_variant(
                    "batched", shape,
                    lambda: executor.execute_batched_topk(
                        live_key, rl, rh, w_all, q_pad=q_pad, kk=kk,
                        t_pad=t_pad, cb=cb, sub=g.tile_sub))
            keys = top_s.cpu().numpy()
            docs = top_d.cpu().numpy()
            slots = top_slot.cpu().numpy()
            totals = totals.cpu().numpy()
            tracer.stop("kernel", t_kernel)
        except (PlanStructureMismatch, NotImplementedError):
            self._note("mesh_pallas", "shape_mismatch", q_batch)
            return None
        except KernelError:
            raise  # a kernel fault is never served by the next rung
        except TimeExceededException:
            raise  # the deadline is no plane fault
        except Exception:  # noqa: BLE001 — batch-wide plane fault: bench
            # the plane once (not Q times), serve from the next rung
            _plane_logger.warning(
                "[%s] batched execution plane [mesh_pallas] failed; "
                "quarantined for %.1fs", self.svc.name,
                self.plane_health.cooldown_s, exc_info=True)
            self.plane_health.record_failure("mesh_pallas")
            self._note("mesh_pallas", "fault", q_batch)
            return None
        self.plane_health.note_success("mesh_pallas")
        with self._counter_lock:
            self.query_total += q_batch
            self.pallas_query_total += q_batch
            if q_batch > 1:
                # the Q == 1 pruned path is no cross-query batching
                self.batched_launch_total += 1
            if pruned_stats is not None:
                self.pruned_query_total += q_batch
                self.tiles_scored_total += pruned_stats["tiles_scored"]
                self.tiles_pruned_total += pruned_stats["tiles_pruned"]
        self._note("mesh_pallas",
                   "served_batched" if q_batch > 1 else
                   ("served_pruned" if pruned_stats is not None
                    else "served"), q_batch)
        # the launch's posting traffic, once a launch (not once a member):
        # each scored tile streams t_pad windows of cb blocks, a pruned
        # tile skips them
        tile_bytes = t_pad * cb * tsc.LANE * (4 if codec == "packed" else 8)
        if pruned_stats is not None:
            launch_adds = {
                "postings_bytes_streamed":
                    pruned_stats["tiles_scored"] * tile_bytes,
                "postings_bytes_skipped":
                    pruned_stats["tiles_pruned"] * tile_bytes,
                "tiles_scored": pruned_stats["tiles_scored"],
                "tiles_pruned": pruned_stats["tiles_pruned"]}
        else:
            launch_adds = {
                "postings_bytes_streamed": n_tiles * n_pairs * tile_bytes}
        self.svc.telemetry.add_counters(launch_adds)
        # and on every profiled member: the launch they shared
        for key, v in launch_adds.items():
            tracer.annotate(key, int(v))
        for body in bodies:
            for sid in self.svc.shards:
                self.svc.shards[sid].searcher.note_query(body.get("stats"))
        t_merge = tracer.start("merge")
        member_aggs = [None] * q_batch
        if agg_raw is not None:
            from elasticsearch_tpu_torch.search.fused_aggs import (
                finalize_fused,
            )

            for q in range(q_batch):
                if member_agg_plans[q] is not None:
                    member_aggs[q] = finalize_fused(
                        member_agg_plans[q], agg_raw[q], n_pairs)
            with self._counter_lock:
                self.agg_fused_query_total += sum(
                    1 for p in member_agg_plans if p is not None)
        results = []
        for q in range(q_batch):
            refs = []
            max_score = None
            for key, slot, d in zip(keys[q][: ks[q]], slots[q][: ks[q]],
                                    docs[q][: ks[q]]):
                if key == -np.inf or d < 0:
                    continue
                sid, seg = executor.pairs[int(slot)]
                refs.append(DocRef(sid, seg.name, int(d), float(key), seg))
                if max_score is None:
                    max_score = float(key)
            result = {"total": int(totals[q]), "refs": refs,
                      "max_score": max_score, "plane": "mesh_pallas"}
            if member_aggs[q] is not None:
                result["aggregations"] = member_aggs[q]
            if pruned_stats is not None:
                # under pruning the total counts matches in scored tiles
                # only, a lower bound: the marker says so
                result["pruned"] = dict(pruned_stats, total_relation="gte")
            results.append(result)
        tracer.stop("merge", t_merge)
        return results

    # ------------------------------------------------------------------
    # The kNN rung
    # ------------------------------------------------------------------

    def _knn_config(self):
        """(enabled, tile_sub preference): each the cluster-level override
        while one is set, else the index settings."""
        settings = self.svc.settings
        enabled = self.svc.knn_enabled_override
        sub = self.svc.knn_tile_sub_override
        return (SEARCH_KNN_ENABLED.get(settings)
                if enabled is None else bool(enabled),
                SEARCH_KNN_TILE_SUB.get(settings) if sub is None else int(sub))

    def query_knn(self, spec: dict, k: int, deadline=None, stats=None,
                  tracer=None) -> Optional[dict]:
        """One kNN query on the mesh plane (the Q == 1 form of
        query_knn_batch). Returns {total, refs, max_score, plane} or None
        when ineligible (the caller runs the host rung)."""
        out = self.query_knn_batch([spec], [max(k, 1)], deadline=deadline,
                                   stats=[stats], tracers=[tracer])
        return out[0] if out is not None else None

    def query_knn_batch(self, specs: List[dict], ks: List[int],
                        deadline=None, stats: Optional[list] = None,
                        tracers: Optional[list] = None) -> Optional[list]:
        """Q concurrent vector queries against one dense_vector field,
        scored by one kernel-3 launch per slot (each slot's embeddings are
        read once for the whole batch). Returns one {total, refs,
        max_score, plane} dict per member, or None when the batch cannot
        run here. A plane fault benches mesh_pallas once for the whole
        batch; a ``KernelError`` raises. ``deadline``: a single query's,
        checkpointed after the staging and before the launch. ``stats``:
        each member's request-body stats groups. ``tracers``: as in
        ``query_batch``."""
        if self.plane_pref not in ("auto", "pallas"):
            return None
        adm = self.plane_health.admit("mesh_pallas")
        if not adm:
            self._note("mesh_pallas", "quarantined", len(specs))
            return None
        members = [(q, t) for q, t in enumerate(tracers or [])
                   if t is not None and t.enabled]
        bt = QueryTracer() if members else NULL_TRACER
        try:
            out = self._query_knn_batch_admitted(
                specs, ks, deadline, stats or [None] * len(specs), bt)
        finally:
            for _q, t in members:
                t.merge_from(bt)
            if adm == "probe":
                self.plane_health.release_probe("mesh_pallas")
        _annotate_members(members, out, len(specs))
        return out

    def _query_knn_batch_admitted(self, specs, ks, deadline=None,
                                  stats=(), tracer=NULL_TRACER
                                  ) -> Optional[list]:
        from elasticsearch_tpu_torch.mapper.field_types import (
            DenseVectorFieldType,
        )
        from elasticsearch_tpu_torch.search.service import DocRef

        if len(self.svc.shards) < 2:
            return None
        enabled, sub_pref = self._knn_config()
        if not enabled:
            self._note("host", "knn_disabled", len(specs))
            return None
        # field uniformity and request validation outside the fault
        # handler: a malformed spec is a request error that the serial
        # path answers with its own 4xx, never a plane fault
        try:
            fields = {str(spec["field"]) for spec in specs}
            if len(fields) != 1:
                return None
            field = next(iter(fields))
            ft = self.svc.mapper_service.field_type(field)
            if not isinstance(ft, DenseVectorFieldType):
                return None
            for spec in specs:
                qv = spec["query_vector"]
                if (not isinstance(qv, (list, tuple))
                        or len(qv) != ft.dims
                        or any(isinstance(v, bool)
                               or not isinstance(v, (int, float))
                               or not np.isfinite(v) for v in qv)):
                    return None
        except (KeyError, TypeError):
            return None
        t_stage = tracer.start("staging")
        executor = self._ensure_staged()
        if executor is None:
            tracer.stop("staging", t_stage)
            self._note("host", self.staging_denied_reason
                       or "knn_staging_unavailable", len(specs))
            return None
        session = executor.ensure_knn(field, ft.dims, ft.similarity)
        tracer.stop("staging", t_stage)
        if deadline is not None:
            deadline.checkpoint()
        if session is None:
            reason = executor.kernel_denied_reason
            self._note("host", reason or "knn_staging_unavailable",
                       len(specs))
            if reason == "staging_fault":
                self.plane_health.record_failure("mesh_pallas",
                                                 reason="staging_fault")
            return None
        q_batch = len(specs)
        q_pad = tsc.next_pow2(q_batch)
        kk = tsc.next_pow2(max(max(ks), 1))
        d_pad = session["d_pad"]
        nd_knn = session["nd_pad"]
        g = knn.knn_geometry(nd_knn, d_pad, sub_pref)
        qmat = np.zeros((q_pad, d_pad), np.float32)
        for q, spec in enumerate(specs):
            qmat[q] = knn.normalize_query(
                np.asarray(spec["query_vector"], np.float32),
                ft.similarity, d_pad)
        if deadline is not None:
            # before committing to the launch
            deadline.checkpoint()
        try:
            on_plane_execute(self.svc.name, "mesh_pallas")
            on_kernel_launch(self.svc.name, "knn")
            t_kernel = tracer.start("kernel")
            top_s, top_d, top_slot, total = run_variant(
                "knn", (executor.n_slots, q_pad, kk, g.tile_sub, d_pad,
                        nd_knn, session["metric"]),
                lambda: executor.execute_knn(
                    session, torch.from_numpy(qmat).to(self.svc.device),
                    kk=kk, sub=g.tile_sub))
            keys = top_s.cpu().numpy()
            docs = top_d.cpu().numpy()
            slots = top_slot.cpu().numpy()
            total = int(total)
            tracer.stop("kernel", t_kernel)
        except (PlanStructureMismatch, NotImplementedError):
            self._note("mesh_pallas", "shape_mismatch", q_batch)
            return None
        except KernelError:
            raise  # a kernel fault is never served by the next rung
        except Exception:  # noqa: BLE001 — batch-wide plane fault
            _plane_logger.warning(
                "[%s] kNN execution plane [mesh_pallas] failed; "
                "quarantined for %.1fs", self.svc.name,
                self.plane_health.cooldown_s, exc_info=True)
            self.plane_health.record_failure("mesh_pallas")
            self._note("mesh_pallas", "fault", q_batch)
            return None
        self.plane_health.note_success("mesh_pallas")
        with self._counter_lock:
            self.query_total += q_batch
            self.pallas_query_total += q_batch
            self.knn_query_total += q_batch
            if q_batch > 1:
                self.batched_launch_total += 1
        self._note("mesh_pallas",
                   "knn_served_batched" if q_batch > 1 else "knn_served",
                   q_batch)
        # the batch streams each slot's bf16 embedding rows once
        streamed = executor.n_slots * nd_knn * d_pad * 2
        self.svc.telemetry.add_counters({"embedding_bytes_streamed": streamed})
        tracer.annotate("embedding_bytes_streamed", streamed)
        for groups in stats:
            for sid in self.svc.shards:
                self.svc.shards[sid].searcher.note_query(groups)
        t_merge = tracer.start("merge")
        results = []
        for q in range(q_batch):
            refs = []
            max_score = None
            for key, slot, d in zip(keys[q][: ks[q]], slots[q][: ks[q]],
                                    docs[q][: ks[q]]):
                if key == -np.inf or d < 0:
                    continue
                sid, seg = executor.pairs[int(slot)]
                refs.append(DocRef(sid, seg.name, int(d), float(key), seg))
                if max_score is None:
                    max_score = float(key)
            results.append({"total": total, "refs": refs,
                            "max_score": max_score, "plane": "mesh_pallas"})
        tracer.stop("merge", t_merge)
        return results
