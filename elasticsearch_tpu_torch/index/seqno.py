"""Sequence-number machinery: global checkpoint tracking.

Counterpart of ``elasticsearch_tpu/index/seqno.py``. The port runs one
copy of each shard, so the tracker holds only its primary and
``check_active_shards`` sees one active copy; the module is whole so that
replicas can use it when they are ported.

Role model: ``GlobalCheckpointTracker`` (reference:
core/src/main/java/org/elasticsearch/index/seqno/GlobalCheckpointTracker.java:51)
— the primary tracks every in-sync copy's local checkpoint (highest seqno
below which all ops are processed); the global checkpoint is the minimum
over the in-sync set and fences ops-based recovery + translog trimming.
Local checkpoints are contiguous by construction here (single-writer
engine), matching ``LocalCheckpointTracker``'s invariant.
"""

from __future__ import annotations

from typing import Dict

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    UnavailableShardsException,
)

UNASSIGNED_SEQ_NO = -2
NO_OPS_PERFORMED = -1


class GlobalCheckpointTracker:
    """Primary-side tracker of per-copy local checkpoints."""

    def __init__(self, primary_id: str):
        self.primary_id = primary_id
        # copy id (node/allocation id) -> last reported local checkpoint
        self.local_checkpoints: Dict[str, int] = {primary_id: NO_OPS_PERFORMED}
        self.in_sync: set = {primary_id}
        # copies that finished recovery but whose checkpoint is still below
        # the global checkpoint (reference: pendingInSync — membership is
        # deferred so the global checkpoint stays monotonic)
        self.pending_in_sync: set = set()
        self._gcp_floor = NO_OPS_PERFORMED

    def seed_global_checkpoint(self, value: int) -> None:
        """Primary promotion: the new primary already learned a global
        checkpoint while it was a replica (piggybacked on writes); the
        monotonic floor starts there so the first post-promotion write
        cannot regress it."""
        if value > self._gcp_floor:
            self._gcp_floor = value

    def initiate_tracking(self, copy_id: str) -> None:
        """A recovering copy is tracked but not yet in-sync (its
        checkpoint cannot hold back the global checkpoint)."""
        self.local_checkpoints.setdefault(copy_id, NO_OPS_PERFORMED)

    def mark_in_sync(self, copy_id: str, local_checkpoint: int,
                     force: bool = False) -> None:
        """Recovery finalize: the copy caught up to the primary
        (RecoverySourceHandler finalize -> markAllocationIdAsInSync).
        If the copy is still below the current global checkpoint its
        membership is deferred (pendingInSync) until it catches up, so
        the global checkpoint never moves backwards. ``force`` is the
        primary-promotion path: routing-table copies whose checkpoints
        are unknown join the in-sync set immediately (on a fresh tracker
        the monotonic floor is still NO_OPS_PERFORMED, so this keeps the
        global checkpoint conservative rather than moving it back)."""
        prev = self.local_checkpoints.get(copy_id, NO_OPS_PERFORMED)
        self.local_checkpoints[copy_id] = max(prev, local_checkpoint)
        if force or self.local_checkpoints[copy_id] >= self.global_checkpoint:
            self.pending_in_sync.discard(copy_id)
            self.in_sync.add(copy_id)
        else:
            self.pending_in_sync.add(copy_id)

    def update_local_checkpoint(self, copy_id: str, checkpoint: int) -> None:
        prev = self.local_checkpoints.get(copy_id, NO_OPS_PERFORMED)
        self.local_checkpoints[copy_id] = max(prev, checkpoint)
        if (copy_id in self.pending_in_sync
                and self.local_checkpoints[copy_id] >= self.global_checkpoint):
            self.pending_in_sync.discard(copy_id)
            self.in_sync.add(copy_id)

    def remove(self, copy_id: str) -> None:
        """Copy failed/left: it no longer holds back the global checkpoint
        (in-sync set shrink, IndexMetaData in-sync allocation update)."""
        if copy_id != self.primary_id:
            self.local_checkpoints.pop(copy_id, None)
            self.in_sync.discard(copy_id)
            self.pending_in_sync.discard(copy_id)

    @property
    def global_checkpoint(self) -> int:
        """min local checkpoint over the in-sync set, clamped monotonic."""
        vals = [self.local_checkpoints.get(c, NO_OPS_PERFORMED)
                for c in self.in_sync]
        gcp = min(vals) if vals else NO_OPS_PERFORMED
        if gcp > self._gcp_floor:
            self._gcp_floor = gcp
        return self._gcp_floor

    def prune(self, valid_copy_ids) -> None:
        """Drop tracked copies no longer in the routing table (the
        reference recomputes membership from IndexMetaData's in-sync
        allocation ids on every cluster-state change) — a departed copy
        must not pin the global checkpoint forever."""
        for copy_id in list(self.local_checkpoints):
            if copy_id != self.primary_id and copy_id not in valid_copy_ids:
                self.remove(copy_id)

    def stats(self) -> dict:
        return {
            "global_checkpoint": self.global_checkpoint,
            "in_sync": sorted(self.in_sync),
            "local_checkpoints": dict(self.local_checkpoints),
        }


def check_active_shards(wanted, active: int, total_copies: int,
                        label: str) -> None:
    """Shared wait_for_active_shards gate (ActiveShardsObserver): resolves
    'all'/int and raises UnavailableShardsException when unmet."""
    if wanted == "all":
        required = total_copies
    else:
        try:
            required = int(wanted)
        except (TypeError, ValueError):
            raise IllegalArgumentException(
                f"cannot parse wait_for_active_shards[{wanted}]") from None
    if active < required:
        raise UnavailableShardsException(
            f"{label} Not enough active copies to meet shard count of "
            f"[{wanted}] (have {active}, needed {required})")
