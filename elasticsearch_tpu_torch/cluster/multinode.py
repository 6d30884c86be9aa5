"""Multi-node cluster: membership, state publish, replication, recovery.

Counterpart of ``elasticsearch_tpu/cluster/multinode.py``. Role models:
- membership and publish: ``ZenDiscovery`` + ``PublishClusterStateAction``
  with the master elected by lowest id among the master-eligible nodes,
  a two-phase publish and commit that needs ``min_master_nodes`` acks,
  and master / node fault detection driven by ``check_master`` /
  ``check_nodes`` (or the ``start_fault_detection`` ticker);
- writes: ``TransportReplicationAction`` / ``ReplicationOperation``: the
  primary assigns the seqno under its operation permit and forwards to the
  in-sync replicas; a failing replica is reported to the master and
  dropped from the routing table;
- recovery: ``RecoverySourceHandler``: phase 1 ships the primary's
  committed files in chunks (SHA-256 digests checked at the target),
  phase 2 replays the ops above the shipped seqno, finalize marks the
  copy in sync;
- failover: the master drops a departed node and reroutes; a STARTED
  replica is promoted with a bumped primary term, and its first search is
  run off the query path (``_warm_promoted_primary``).

Each ClusterNode hosts only the shards routed to it, each an
``IndexShard`` on the node's ``device`` (``cuda`` unless the caller asks
for the CPU, as the tests do). A shard always has a data path: under the
node's ``data_path``, or under a temporary directory of the node's own
(one directory a shard copy, removed when the copy closes; the whole
directory goes on ``close``), since phase 1 ships committed files. A
shard copy's device stagings are its own segments' ledger scopes, so a
copy that closes returns only its own bytes. A coordinator-side search
fans out to one copy a shard and merges; the hits are materialized at
the shard (query and fetch in one hop) and leave it as JSON values.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.cluster.allocation import (
    RoutingTable,
    allocate,
    routing_from_dict,
    routing_to_dict,
)
from elasticsearch_tpu_torch.cluster.state import (
    IndexMetadata,
    ShardRouting,
    ShardRoutingState,
)
from elasticsearch_tpu_torch.common import settings as S
from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuException,
    IllegalArgumentException,
    IndexNotFoundException,
    NodeNotConnectedException,
)
from elasticsearch_tpu_torch.common.integrity import integrity_service
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.seqno import GlobalCheckpointTracker
# the registry's three functions stay names of this module, as in the
# JAX package
from elasticsearch_tpu_torch.index.recovery_progress import (  # noqa: F401
    clear_recovery_progress,
    record_recovery_progress,
    recovery_progress_rows,
)
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.index.store import (
    MARKER_PREFIX,
    CorruptIndexException,
)
from elasticsearch_tpu_torch.mapper.mapping import MapperService
from elasticsearch_tpu_torch.transport.local import (
    ConnectionHealth,
    RetryPolicy,
    TransportHub,
    TransportService,
)
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for

logger = logging.getLogger("elasticsearch_tpu_torch.cluster")

ACTION_PUBLISH = "internal:cluster/coordination/publish_state"
ACTION_COMMIT = "internal:cluster/coordination/commit_state"
ACTION_JOIN = "internal:discovery/zen/join"
ACTION_LEAVE = "internal:discovery/zen/leave"
ACTION_SHARD_FAILED = "internal:cluster/shard/failure"
ACTION_SHARD_STARTED = "internal:cluster/shard/started"
ACTION_WRITE_PRIMARY = "indices:data/write/bulk[s][p]"
ACTION_WRITE_REPLICA = "indices:data/write/bulk[s][r]"
ACTION_GET = "indices:data/read/get[s]"
ACTION_QUERY = "indices:data/read/search[phase/query+fetch]"
ACTION_REFRESH = "indices:admin/refresh[s]"
ACTION_RECOVER = "internal:index/shard/recovery/start_recovery"
ACTION_RECOVERY_FINALIZE = "internal:index/shard/recovery/finalize"
ACTION_RECOVER_FILES_START = "internal:index/shard/recovery/files/start"
ACTION_RECOVER_FILE_CHUNK = "internal:index/shard/recovery/files/chunk"
ACTION_RECOVER_FILES_CLOSE = "internal:index/shard/recovery/files/close"
ACTION_MASTER_PING = "internal:discovery/zen/fd/master_ping"

# phase1 file-chunk size (RecoverySettings.CHUNK_SIZE analog, 512KB)
RECOVERY_CHUNK_BYTES = 512 * 1024
# a source-side file session whose target went silent for this long is
# reclaimed (the reference cancels recoveries on timeout); sessions hold a
# full in-memory snapshot of the shard's files
RECOVERY_SESSION_MAX_AGE_S = 600.0

def _plain(value):
    """A hop's payload value as JSON: numpy scalars and arrays become
    Python numbers and lists (scores and sort values leave a node so)."""
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


class NotMasterException(ElasticsearchTpuException):
    """A master-only operation raced with a mastership change; callers
    on the RPC path translate this to a benign {'ok': False}."""


class FailedToCommitClusterStateException(ElasticsearchTpuException):
    """The publish quorum was not reached; the master stepped down and
    the state change is NOT committed (discovery/zen/publish —
    FailedToCommitClusterStateException). Clients must treat the request
    as failed."""

    status_code = 503


class ClusterNode:
    """One node of the in-process cluster (a real Node analog hosting only
    its allocated shards)."""

    def __init__(self, name: str, hub: TransportHub, master_eligible: bool = True,
                 data: bool = True, attrs: Optional[Dict[str, str]] = None,
                 awareness_attributes: Optional[List[str]] = None,
                 min_master_nodes: int = 1,
                 settings: Optional[Settings] = None,
                 data_path: Optional[str] = None, device="cuda"):
        self.name = name
        self.node_id = name  # stable, human-readable ids make tests clear
        self.master_eligible = master_eligible
        self.data = data
        # every shard this node hosts lives on this device; cuda without
        # a card raises here
        self.device = resolve_device(device)
        # durable shard storage (translog + store under
        # <data_path>/<index>/<shard>): a SIGKILLed node restarted over
        # the same path replays acked writes from the translog. None: the
        # shards live under a temporary directory of this node's, removed
        # on close
        self.data_path = data_path
        self._tmp_root: Optional[str] = None
        # transport resilience knobs (common/settings.py registry): per-
        # attempt request deadlines, the RetryableAction-style backoff
        # policies, and the per-node connection health tracker
        self.settings = settings or Settings.EMPTY
        s = self.settings
        self.request_timeout = S.TRANSPORT_REQUEST_TIMEOUT.get(s)
        self.fd_ping_timeout = S.FD_PING_TIMEOUT.get(s)
        self.publish_timeout = S.PUBLISH_TIMEOUT.get(s)
        self.replication_timeout = S.REPLICATION_TIMEOUT.get(s)
        self.recovery_action_timeout = S.RECOVERY_ACTION_TIMEOUT.get(s)
        self.retry_policy = RetryPolicy(
            max_attempts=S.TRANSPORT_RETRY_MAX_ATTEMPTS.get(s),
            initial_backoff=S.TRANSPORT_RETRY_INITIAL_BACKOFF.get(s),
            backoff_multiplier=S.TRANSPORT_RETRY_BACKOFF_MULTIPLIER.get(s),
            max_backoff=S.TRANSPORT_RETRY_MAX_BACKOFF.get(s))
        self.fd_retry = self.retry_policy.derive(
            max_attempts=S.FD_PING_RETRIES.get(s))
        self.recovery_retry = RetryPolicy(
            max_attempts=S.RECOVERY_MAX_RETRIES.get(s),
            initial_backoff=S.RECOVERY_RETRY_DELAY_NETWORK.get(s),
            backoff_multiplier=S.TRANSPORT_RETRY_BACKOFF_MULTIPLIER.get(s),
            max_backoff=S.TRANSPORT_RETRY_MAX_BACKOFF.get(s))
        # publish/replication retries are bounded by an OVERALL deadline:
        # an unresponsive peer costs one timeout, not timeout x attempts
        # (drops fail fast and still get their backoff retries)
        self.publish_retry = self.retry_policy.derive(
            overall_timeout=self.publish_timeout)
        self.replication_retry = self.retry_policy.derive(
            overall_timeout=self.replication_timeout)
        # fail-shard reports guard against SILENT divergence (an
        # unreported failed replica stays STARTED in the routing table
        # and could be promoted later, losing acked writes) — they get
        # twice the retry budget of a normal request
        self.report_retry = self.retry_policy.derive(
            max_attempts=2 * self.retry_policy.max_attempts)
        # node attributes (node.attr.* — awareness zones etc.) + simulated
        # disk usage fraction (ClusterInfoService/FsProbe analog; tests set
        # it and call reroute)
        self.attrs = dict(attrs or {})
        self.disk_used_fraction = 0.0
        # master-side: configured awareness attributes
        # (cluster.routing.allocation.awareness.attributes)
        self.awareness_attributes = list(awareness_attributes or [])
        # master-side: per-node info collected from joins
        self.node_info_map: Dict[str, dict] = {}
        self.transport = TransportService(
            self.node_id, hub,
            health=ConnectionHealth(
                failure_threshold=S.TRANSPORT_HEALTH_FAILURE_THRESHOLD.get(s),
                quarantine_s=S.TRANSPORT_HEALTH_QUARANTINE.get(s)))
        self.hub = hub
        # cluster-state copy (every node holds the latest published state).
        # (epoch, version) orders states like the reference's cluster-state
        # term+version: the epoch bumps at every election, so a deposed
        # master's re-published state (same version base, old epoch) is
        # rejected by every node that followed the new master
        self.cluster_epoch = 0
        self.state_version = 0
        self.indices_meta: Dict[str, IndexMetadata] = {}
        # per-shard primary terms, owned by the master and carried in the
        # published state (reference: IndexMetaData.primaryTerm(shardId),
        # bumped on every primary promotion/reassignment) — replicas learn
        # the current term from the publish, not from write traffic
        self.primary_terms: Dict[Tuple[str, int], int] = {}
        self.routing: RoutingTable = {}
        self.known_nodes: List[str] = []
        self.master_id: Optional[str] = None
        # discovery.zen.minimum_master_nodes: the election AND the publish
        # commit both require this many master-eligible nodes (self
        # included) — the split-brain guard (ElectMasterService
        # .hasEnoughMasterNodes / PublishClusterStateAction commit quorum).
        # The reference's default is 1 (unsafe by default, warned about);
        # production clusters set (eligible // 2) + 1.
        self.min_master_nodes = max(1, int(min_master_nodes))
        # two-phase publish: follower-side buffered state awaiting commit
        # keyed by (epoch, version) — dropped when superseded
        self._pending_publish: Optional[dict] = None
        # while a master-side state update is uncommitted, shards it
        # removes are parked here instead of closed (rollback support)
        self._removed_shards: Optional[list] = None
        # local shards: (index, shard_id) -> IndexShard
        self.shards: Dict[Tuple[str, int], IndexShard] = {}
        self.mappers: Dict[str, MapperService] = {}
        self._lock = threading.RLock()
        # serializes primary writes vs recovery finalize ONLY — a separate
        # lock so it never participates in the node-lock ordering of
        # publish/apply-state paths (cross-node deadlock avoidance: while
        # held, the only outbound calls are lock-free replica writes)
        self._replication_lock = threading.RLock()
        # phase1 file-recovery sessions on this node as a recovery SOURCE:
        # session id -> {"files": {relpath: bytes}, "t0", "sent"}. The file
        # bytes are snapshotted at session start (the reference holds an
        # IndexCommit ref instead) so concurrent flush/merge can't mutate
        # the view mid-transfer.
        self._recovery_sessions: Dict[str, dict] = {}
        self._recovery_session_seq = 0
        # indices.recovery.max_bytes_per_sec analog (None = unthrottled)
        self.recovery_max_bytes_per_sec: Optional[float] = None
        # master-side registry of last-copy corruption:
        # (index, sid) -> {"node", "reason"} — the copy stays routed
        # (dropping it would let the allocator fill a fresh EMPTY
        # primary, i.e. silent data loss) and the quarantine is surfaced
        # through allocation explain / _cat/shards instead
        self.corrupt_retained: Dict[Tuple[str, int], dict] = {}
        # the threads this node starts off the request path (recovery
        # retries, promotion warming), joined or cancelled on close, and
        # what failed in them: a failure there is counted here, never
        # lost
        self._timers: set = set()
        self._warm_threads: List[threading.Thread] = []
        self.warm_runs = 0
        self.warm_failures = 0
        self.background_errors: List[str] = []
        self._closed = False
        self._register_handlers()

    # ------------------------------------------------------------------

    def _register_handlers(self) -> None:
        t = self.transport
        t.register_handler(ACTION_PUBLISH, self._on_publish)
        t.register_handler(ACTION_COMMIT, self._on_commit)
        t.register_handler(ACTION_JOIN, self._on_join)
        t.register_handler(ACTION_LEAVE, self._on_leave)
        t.register_handler(ACTION_SHARD_FAILED, self._on_shard_failed)
        t.register_handler(ACTION_SHARD_STARTED, self._on_shard_started)
        t.register_handler(ACTION_WRITE_PRIMARY, self._on_write_primary)
        t.register_handler(ACTION_WRITE_REPLICA, self._on_write_replica)
        t.register_handler(ACTION_GET, self._on_get)
        t.register_handler(ACTION_QUERY, self._on_query)
        t.register_handler(ACTION_REFRESH, self._on_refresh)
        t.register_handler(ACTION_RECOVER, self._on_start_recovery)
        t.register_handler(ACTION_RECOVERY_FINALIZE, self._on_recovery_finalize)
        t.register_handler(ACTION_RECOVER_FILES_START,
                           self._on_start_file_recovery)
        t.register_handler(ACTION_RECOVER_FILE_CHUNK,
                           self._on_recovery_file_chunk)
        t.register_handler(ACTION_RECOVER_FILES_CLOSE,
                           self._on_recovery_files_close)
        t.register_handler(ACTION_MASTER_PING, self._on_master_ping)

    @property
    def is_master(self) -> bool:
        return self.master_id == self.node_id

    # ------------------------------------------------------------------
    # Master-side: membership + state updates
    # ------------------------------------------------------------------

    def bootstrap_cluster(self) -> None:
        """First node: elect self."""
        with self._lock:
            self.master_id = self.node_id
            self.known_nodes = [self.node_id]
            self.node_info_map[self.node_id] = {
                "attrs": self.attrs, "disk": self.disk_used_fraction,
                "master_eligible": self.master_eligible}
            self.cluster_epoch = 1
            self.state_version = 1

    def join(self, seed_node: str) -> None:
        """Join via any known node (UnicastZenPing seed analog)."""
        payload = {
            "node": self.node_id,
            "master_eligible": self.master_eligible,
            "data": self.data,
            "attrs": self.attrs,
            "disk": self.disk_used_fraction,
        }
        resp = self.transport.send_request(
            seed_node, ACTION_JOIN, payload,
            timeout=self.request_timeout, retry=self.retry_policy)
        if resp.get("master") != seed_node:
            # redirected to the actual master
            self.transport.send_request(
                resp["master"], ACTION_JOIN, payload,
                timeout=self.request_timeout, retry=self.retry_policy)

    def _on_join(self, payload, src) -> dict:
        with self._lock:
            if not self.is_master:
                return {"master": self.master_id}
            node = payload["node"]
            if node not in self.known_nodes:
                self.known_nodes.append(node)
            self.node_info_map[node] = {
                "attrs": payload.get("attrs") or {},
                "disk": payload.get("disk") or 0.0,
                "master_eligible": bool(payload.get("master_eligible", True)),
            }
        self._master_reroute_and_publish()
        return {"master": self.node_id}

    def node_left(self, departed: str) -> None:
        """Master-side removal (fault detection outcome or explicit leave)."""
        with self._lock:
            if not self.is_master:
                raise IllegalArgumentException("node_left must run on the master")
            if departed in self.known_nodes:
                self.known_nodes.remove(departed)
            self.node_info_map.pop(departed, None)
        self._master_reroute_and_publish()

    def _on_leave(self, payload, src) -> dict:
        """Graceful-leave announcement: the departing node tells the
        master BEFORE
        shutting down, so the coordinator routes around it and replicas
        promote NOW instead of after the fault-detection timeout."""
        with self._lock:
            if not self.is_master:
                return {"ok": False, "master": self.master_id}
        try:
            self.node_left(payload["node"])
        except (IllegalArgumentException,
                FailedToCommitClusterStateException):
            return {"ok": False, "master": self.master_id}
        return {"ok": True}

    def graceful_leave(self, timeout_s: float = 2.0) -> bool:
        """Announce this node's departure before shutdown (the rollout
        contract): a follower notifies the master (one redirect hop,
        like join); the master ABDICATES — one state update removes it
        from the node set, hands mastership to the lowest-id other
        eligible node, and reroutes, so its primaries' replicas promote
        under the leave publish instead of after FD timeout. Bounded
        and best-effort: False means peers will learn via fault
        detection."""
        with self._lock:
            peers = [n for n in self.known_nodes if n != self.node_id]
            master = self.master_id
            am_master = self.is_master
        if not peers:
            return True  # last node: nobody to tell
        if not am_master:
            target = master
            for _hop in range(2):  # one redirect, like join()
                if target is None or target == self.node_id:
                    return False
                try:
                    resp = self.transport.send_request(
                        target, ACTION_LEAVE, {"node": self.node_id},
                        timeout=min(self.request_timeout, timeout_s)) or {}
                except (NodeNotConnectedException,
                        ElasticsearchTpuException):
                    return False
                if resp.get("ok"):
                    return True
                target = resp.get("master")
            return False

        # master: abdicate
        def mutate():
            successor = next(
                (n for n in self._master_eligible_nodes(
                    exclude=self.node_id) if n != self.node_id), None)
            if self.node_id in self.known_nodes:
                self.known_nodes.remove(self.node_id)
            self.node_info_map.pop(self.node_id, None)
            self.master_id = successor
            # a mastership TRANSFER bumps the epoch exactly like an
            # election: followers order states by (epoch, version) and
            # break same-epoch master conflicts toward the LOWER id —
            # without the bump, handing off to a higher-id successor
            # would be rejected as a lost election
            self.cluster_epoch += 1

        try:
            self._submit_state_update(mutate)
            return True
        except (FailedToCommitClusterStateException,
                NodeNotConnectedException, ElasticsearchTpuException):
            return False

    def check_nodes(self) -> List[str]:
        """Fault detection (NodesFaultDetection): master pings all nodes;
        unreachable ones are removed. A ping answered with a HIGHER
        cluster epoch means this node was deposed while partitioned — it
        steps down and rejoins the real cluster (the reference's
        "another master for the cluster" rejoin). Returns departed ids."""
        departed = []
        lagging = []
        new_cluster: Optional[dict] = None
        with self._lock:
            if not self.is_master:
                return []
            peers = [n for n in self.known_nodes if n != self.node_id]
            my_epoch = self.cluster_epoch
            my_version = self.state_version
        # ping OUTSIDE the lock: a slow peer must not stall every other
        # master operation for a socket timeout per FD tick. The ping
        # timeout bounds each attempt so an UNRESPONSIVE (not merely
        # disconnected) node is detected; ping_retries keeps a lossy link
        # from evicting a live node
        for node in peers:
            try:
                resp = self.transport.send_request(
                    node, ACTION_PUBLISH, None,
                    timeout=self.fd_ping_timeout, retry=self.fd_retry)
                resp = resp or {}
                if (resp.get("epoch", 0) > my_epoch
                        or (resp.get("epoch", 0) == my_epoch
                            and (resp.get("master") or self.node_id)
                            < self.node_id)):
                    # a cluster with precedence over ours (higher epoch,
                    # or same epoch under a lower-id master) exists
                    new_cluster = resp
                    break
                if ((resp.get("epoch", my_epoch), resp.get("version",
                                                           my_version))
                        < (my_epoch, my_version)):
                    # the follower missed a publish (drops exhausted the
                    # phase-1 retries): without repair its state DIVERGES
                    # silently until the next unrelated state change —
                    # re-publish the full state to it below
                    lagging.append(node)
            except NodeNotConnectedException:
                departed.append(node)
        if lagging:
            self._republish_to_lagging(lagging, my_epoch, my_version)
        if new_cluster is not None:
            with self._lock:
                self.master_id = new_cluster["master"]
            try:
                self.join(new_cluster["master"])
            except NodeNotConnectedException:
                pass
            return []
        with self._lock:
            still_master = self.master_id == self.node_id
        if still_master:
            remaining = [n for n in peers if n not in departed]
            if self._reachable_eligible(remaining) < self.min_master_nodes:
                # the master lost its quorum (minority side of a
                # partition): step down instead of continuing to accept
                # writes that the majority side will fence
                with self._lock:
                    if self.master_id == self.node_id:
                        self.master_id = None
                return departed
        for node in departed:
            self.node_left(node)
        return departed

    def _republish_to_lagging(self, nodes: List[str], my_epoch: int,
                              my_version: int) -> None:
        """FD repair path: push the CURRENT full state (publish + commit)
        to followers whose ping showed an older (epoch, version). The
        state dict is self-contained, so one round catches a follower up
        no matter how many publishes it missed."""
        with self._lock:
            if not self.is_master:
                return
            if (self.cluster_epoch, self.state_version) < (my_epoch,
                                                           my_version):
                return  # our own view moved backwards (deposed): bail
            state = self._state_dict()
        key = {"epoch": state["epoch"], "version": state["version"]}
        for node in nodes:
            try:
                resp = self.transport.send_request(
                    node, ACTION_PUBLISH, state,
                    timeout=self.publish_timeout,
                    retry=self.publish_retry) or {}
                if resp.get("ok"):
                    self.transport.send_request(
                        node, ACTION_COMMIT, key,
                        timeout=self.publish_timeout,
                        retry=self.publish_retry)
            except (NodeNotConnectedException, ElasticsearchTpuException):
                pass  # still unreachable: the next FD tick retries

    # ------------------------------------------------------------------
    # Master fault detection + re-election (MasterFaultDetection.java:56,
    # ZenDiscovery.handleMasterGone -> ElectMasterService: nodes ping the
    # master; on loss the lowest-id master-eligible survivor elects
    # itself, bumps the state version and republishes; promotions bump
    # primary terms, fencing in-flight writes from the deposed master)
    # ------------------------------------------------------------------

    def _on_master_ping(self, payload, src) -> dict:
        return {"master": self.master_id, "is_master": self.is_master,
                "version": self.state_version,
                "epoch": self.cluster_epoch}

    def _master_eligible_nodes(self, exclude: Optional[str] = None):
        out = []
        for n in self.known_nodes:
            if n == exclude:
                continue
            info = self.node_info_map.get(n) or {}
            eligible = info.get("master_eligible", True)
            if n == self.node_id:
                eligible = self.master_eligible
            if eligible:
                out.append(n)
        return sorted(out)

    def check_master(self) -> Optional[str]:
        """Non-master fault detection: ping the master; on loss run the
        election. Returns the new master id if one was chosen, else None."""
        with self._lock:
            master = self.master_id
            if master == self.node_id:
                return None
        if master is None:
            # headless (stepped down after quorum loss): probe known
            # peers for a live master to rejoin, else run an election —
            # without this the node stays orphaned after the partition
            # heals (the majority removed us; nobody publishes to us)
            for peer in sorted(self.known_nodes):
                if peer == self.node_id:
                    continue
                try:
                    resp = self.transport.send_request(
                        peer, ACTION_MASTER_PING, None,
                        timeout=self.fd_ping_timeout,
                        retry=self.fd_retry) or {}
                except NodeNotConnectedException:
                    continue
                claimed = resp.get("master") if not resp.get("is_master") \
                    else peer
                if claimed and resp.get("epoch", 0) >= self.cluster_epoch:
                    try:
                        self.join(claimed)
                        return claimed
                    except NodeNotConnectedException:
                        continue
            return self._handle_master_failure(None)
        try:
            resp = self.transport.send_request(
                master, ACTION_MASTER_PING, None,
                timeout=self.fd_ping_timeout, retry=self.fd_retry)
            if resp.get("is_master"):
                return None
            # it abdicated/lost an election itself: adopt its view only
            # after VERIFYING the proposed master is alive and actually
            # master — blindly adopting could flip us back to a dead node
            proposed = resp.get("master")
            if proposed and proposed != master:
                try:
                    r2 = self.transport.send_request(
                        proposed, ACTION_MASTER_PING, None,
                        timeout=self.fd_ping_timeout, retry=self.fd_retry)
                    if r2.get("is_master"):
                        with self._lock:
                            self.master_id = proposed
                        return proposed
                except NodeNotConnectedException:
                    pass
            # our presumptive master is alive but not (yet) master: stay
            # put; its own election tick converges the cluster
            return None
        except NodeNotConnectedException:
            pass
        return self._handle_master_failure(master)

    def _handle_master_failure(self, dead: str) -> Optional[str]:
        with self._lock:
            if self.master_id != dead:
                return self.master_id  # someone already converged us
            candidates = self._master_eligible_nodes(exclude=dead)
        # walk candidates in election order, skipping unreachable ones
        # (a previously-dead node may still linger in known_nodes: it must
        # not be "elected" just because its id sorts first); count the
        # reachable eligibles for the quorum check
        reachable = []
        winner = None
        for cand in candidates:
            if cand == self.node_id:
                reachable.append(cand)
                if winner is None:
                    winner = cand
                continue
            try:
                self.transport.send_request(
                    cand, ACTION_MASTER_PING, None,
                    timeout=self.fd_ping_timeout, retry=self.fd_retry)
                reachable.append(cand)
                if winner is None:
                    winner = cand
            except NodeNotConnectedException:
                continue
        if winner is None:
            return None
        if len(reachable) < self.min_master_nodes:
            # not enough master nodes (ElectMasterService
            # .hasEnoughMasterNodes): refuse the election — a minority
            # partition must stay headless rather than split-brain
            return None
        new_master = winner
        if new_master != self.node_id:
            # not the winner: adopt the deterministic result; the winner
            # converges through its own master fault detection tick and
            # publishes the new state to us
            with self._lock:
                if self.master_id == dead:
                    self.master_id = new_master
            return new_master
        with self._lock:
            if self.master_id != dead:
                return self.master_id  # lost a race with another publish
            # assume mastership: bump the epoch (fences the deposed
            # master's future publishes), drop it, reroute (promotes
            # its primaries with bumped terms), republish
            self.master_id = self.node_id
            self.cluster_epoch += 1
            if dead in self.known_nodes:
                self.known_nodes.remove(dead)
            self.node_info_map.pop(dead, None)
            self.node_info_map.setdefault(self.node_id, {
                "attrs": self.attrs, "disk": self.disk_used_fraction,
                "master_eligible": self.master_eligible})
        self._master_reroute_and_publish()
        return self.node_id

    def start_fault_detection(self, interval: float = 1.0) -> None:
        """Background FD ticker: the master pings all nodes
        (NodesFaultDetection), everyone else pings the master
        (MasterFaultDetection)."""
        if getattr(self, "_fd_thread", None):
            return
        self._fd_stop = threading.Event()

        def tick():
            while not self._fd_stop.wait(interval):
                try:
                    if self.is_master:
                        self.check_nodes()
                    else:
                        self.check_master()
                except Exception:  # noqa: BLE001 — FD must never die
                    pass

        self._fd_thread = threading.Thread(target=tick, daemon=True)
        self._fd_thread.start()

    def create_index(self, name: str, settings: Optional[dict] = None,
                     mappings: Optional[dict] = None) -> dict:
        def mutate():
            if not self.is_master:
                raise IllegalArgumentException(
                    "create_index must be sent to the master"
                )
            if name in self.indices_meta:
                from elasticsearch_tpu_torch.common.errors import (
                    IndexAlreadyExistsException,
                )

                raise IndexAlreadyExistsException(name)
            self.indices_meta[name] = IndexMetadata(
                name,
                Settings.from_dict(settings or {}).with_index_prefix(),
                mappings or {"properties": {}},
                creation_date=int(time.time() * 1000),
            )

        self._submit_state_update(mutate)
        return {"acknowledged": True, "index": name}

    def delete_index(self, name: str) -> dict:
        def mutate():
            if not self.is_master:
                raise IllegalArgumentException("delete_index must run on master")
            if name not in self.indices_meta:
                raise IndexNotFoundException(name)
            del self.indices_meta[name]
            self.routing.pop(name, None)

        self._submit_state_update(mutate)
        return {"acknowledged": True}

    def update_node_disk(self, node_id: str, used_fraction: float) -> None:
        """Master-side disk-usage report (DiskThresholdMonitor input);
        callers follow with a reroute to act on watermark crossings."""
        with self._lock:
            if not self.is_master:
                raise IllegalArgumentException(
                    "update_node_disk must run on the master")
            info = self.node_info_map.setdefault(
                node_id, {"attrs": {}, "disk": 0.0})
            info["disk"] = used_fraction

    def reroute(self) -> None:
        """Explicit reroute (POST /_cluster/reroute analog)."""
        self._master_reroute_and_publish()

    def _master_reroute_and_publish(self) -> None:
        self._submit_state_update(lambda: None)

    def _submit_state_update(self, mutate) -> None:
        """MasterService.runTasks analog: apply `mutate` + reroute +
        self-apply under the lock, then publish to the other nodes
        OUTSIDE it: a follower's publish handler may synchronously
        recover replicas and report shard-started back to this master —
        holding our lock across the publish round-trip would deadlock
        that nested RPC over a real (TCP) transport. (The in-process hub
        hid this: same-thread RLock reentrancy.) Callers must therefore
        NOT hold self._lock when calling this.

        If the commit quorum fails, the pre-change snapshot is restored
        before FailedToCommitClusterStateException propagates: the
        reference master only applies a state after its publish quorum
        acks (PublishClusterStateAction), so a minority master must not
        keep serving a change its client was told did NOT commit. Local
        shards the uncommitted change removed (e.g. a rolled-back
        delete_index) are held open until the commit succeeds and are
        resurrected with their data on rollback — recreating them empty
        would lose the master's copy while claiming nothing happened."""
        with self._lock:
            snapshot = self._state_dict()
            removed: list = []
            self._removed_shards = removed
            try:
                mutate()
                state, deferred = self._master_reroute_locked()
            finally:
                self._removed_shards = None
        try:
            for action in deferred:  # own-primary started reports etc.
                # a deferred action may itself publish (shard-started →
                # nested _submit_state_update) and hit the same failed
                # quorum — that must roll back THIS change too
                action()
            with self._lock:
                # a nested publish may have superseded `state`; shipping
                # the stale version would cost a full 2-phase broadcast
                # every follower then rejects as stale
                superseded = ((self.cluster_epoch, self.state_version)
                              > (state["epoch"], state["version"]))
            if not superseded:
                self._publish_to_followers(state)
        except FailedToCommitClusterStateException:
            with self._lock:
                # put removed shards back BEFORE re-adopting the
                # snapshot so its reconcile finds the data intact
                for key, shard in removed:
                    if key not in self.shards:
                        self.shards[key] = shard
                restore = self._adopt_state_locked(snapshot)
                self.master_id = None  # stay stepped down post-rollback
            for action in restore:
                action()
            raise
        for _key, shard in removed:  # committed: the removal is final
            self._close_shard(shard)

    def _reachable_eligible(self, nodes) -> int:
        """Count of master-eligible nodes among `nodes` (self included if
        eligible) — the election/commit quorum input."""
        count = 1 if self.master_eligible else 0
        for n in nodes:
            if n == self.node_id:
                continue
            info = self.node_info_map.get(n) or {}
            if info.get("master_eligible", True):
                count += 1
        return count

    def _publish_to_followers(self, state: dict) -> None:
        """Two-phase publish (PublishClusterStateAction): phase 1 sends
        the state, followers BUFFER it; once master-eligible acks (self
        included) reach minimum_master_nodes, phase 2 commits and
        followers apply. Short of the quorum, the master steps down
        (FailedToCommitClusterStateException -> rejoin) and the buffered
        state dies unapplied on every follower."""
        key = {"epoch": state["epoch"], "version": state["version"]}
        acks = 1 if self.master_eligible else 0
        reached = []
        for node in state["nodes"]:
            if node == self.node_id:
                continue
            try:
                # per-follower deadline + retry: a transient drop retries
                # with backoff; an unresponsive follower costs at most the
                # publish timeout and simply does not ack (timeout quorum
                # — PublishClusterStateAction's AckListener deadline)
                resp = self.transport.send_request(
                    node, ACTION_PUBLISH, state,
                    timeout=self.publish_timeout,
                    retry=self.publish_retry) or {}
                if not resp.get("ok"):
                    continue  # explicit rejection (stale epoch) != ack
                reached.append(node)
                info = self.node_info_map.get(node) or {}
                if info.get("master_eligible", True):
                    acks += 1
            except NodeNotConnectedException:
                pass  # fault detection will remove it
        if acks < self.min_master_nodes:
            with self._lock:
                if self.master_id == self.node_id:
                    self.master_id = None  # stepped down; a quorum-backed
                    # master (or a healed partition) re-converges us
            raise FailedToCommitClusterStateException(
                f"publish of cluster state [{state['version']}] reached "
                f"{acks} of the required {self.min_master_nodes} "
                f"master-eligible acks")
        for node in reached:
            try:
                self.transport.send_request(
                    node, ACTION_COMMIT, key,
                    timeout=self.publish_timeout, retry=self.publish_retry)
            except Exception:  # noqa: BLE001 — commit is best-effort
                # past the quorum the state IS committed; a follower
                # whose apply blew up (e.g. its deferred shard-started
                # report hit a nested failed quorum) must not bubble
                # that back here and make us roll back a committed
                # change — it will catch up on the next publish
                pass

    def _master_reroute_locked(self) -> Tuple[dict, list]:
        data_nodes = [n for n in self.known_nodes]  # all nodes are data nodes here
        # prune the corrupt-retained registry: a deleted index releases
        # its keys (a RECREATED index with the same name must get a
        # fresh primary — it never had the lost data)
        self.corrupt_retained = {
            k: v for k, v in self.corrupt_retained.items()
            if k[0] in self.indices_meta}
        old_primaries = {
            (index, sid): copy.node_id
            for index, shards in self.routing.items()
            for sid, copies in shards.items()
            for copy in copies if copy.primary
        }
        self.routing = allocate(
            self.indices_meta, data_nodes, self.routing,
            node_info=self.node_info_map,
            awareness_attributes=self.awareness_attributes or None,
            no_fresh_primary=set(self.corrupt_retained) or None)
        # bump the term wherever the primary copy moved to another node
        # (promotion after failure, cancel+reassign): the old primary may
        # still be alive and issuing writes — the higher term fences it
        for index, shards in self.routing.items():
            for sid, copies in shards.items():
                key = (index, sid)
                self.primary_terms.setdefault(key, 1)
                new_primary = next(
                    (c.node_id for c in copies if c.primary), None)
                old = old_primaries.get(key)
                if (new_primary is not None and old is not None
                        and new_primary != old):
                    self.primary_terms[key] += 1
        self.state_version += 1
        state = self._state_dict()
        deferred = self._apply_state_locked(state)  # self-apply
        return state, deferred

    def _state_dict(self) -> dict:
        return {
            "epoch": self.cluster_epoch,
            "version": self.state_version,
            "master": self.master_id,
            "nodes": list(self.known_nodes),
            "indices": {
                name: {
                    "settings": md.settings.as_dict(),
                    "mappings": md.mappings,
                    "state": md.state,
                    # full IndexMetadata: every apply (follower AND the
                    # master's own self-apply/rollback) rebuilds from
                    # this dict, so omitting a field here silently wipes
                    # it cluster-wide
                    "aliases": md.aliases,
                    "creation_date": md.creation_date,
                    "version": md.version,
                }
                for name, md in self.indices_meta.items()
            },
            "routing": routing_to_dict(self.routing),
            "primary_terms": {
                f"{index}#{sid}": term
                for (index, sid), term in self.primary_terms.items()
            },
            # every node learns eligibility so any survivor can compute
            # the deterministic election result (ElectMasterService sorts
            # master-eligible nodes; lowest id wins)
            "node_info": {
                n: {"master_eligible": bool(
                    info.get("master_eligible", True)),
                    "attrs": info.get("attrs") or {},
                    "disk": info.get("disk") or 0.0}
                for n, info in self.node_info_map.items()
            },
        }

    # ------------------------------------------------------------------
    # Applier side (IndicesClusterStateService.applyClusterState analog)
    # ------------------------------------------------------------------

    def _on_publish(self, payload, src) -> dict:
        if payload is None:
            # ping: answer with our view so a deposed master can notice
            # the higher-epoch cluster and step down, and so the master
            # can spot a LAGGING follower (missed publish under faults)
            # and re-publish to it (check_nodes)
            return {"ok": True, "master": self.master_id,
                    "epoch": self.cluster_epoch,
                    "version": self.state_version}
        with self._lock:
            if payload["epoch"] < self.cluster_epoch:
                # a deposed master re-publishing from a stale epoch: the
                # rejection must be VISIBLE in the ack so its commit
                # quorum fails (not just swallowed at apply time)
                return {"ok": False, "reason": "stale epoch",
                        "epoch": self.cluster_epoch,
                        "master": self.master_id}
            pending = self._pending_publish
            if pending is None or (
                    (payload["epoch"], payload["version"])
                    >= (pending["epoch"], pending["version"])):
                self._pending_publish = payload
        return {"ok": True, "version": payload["version"]}

    def _on_commit(self, payload, src) -> dict:
        with self._lock:
            pending = self._pending_publish
            if pending is None or (pending["epoch"], pending["version"]) != (
                    payload["epoch"], payload["version"]):
                return {"ok": False}
            self._pending_publish = None
        self._apply_state(pending)
        return {"ok": True}

    def _apply_state(self, state: dict) -> None:
        with self._lock:
            deferred = self._apply_state_locked(state)
        # recovery + shard-started reporting run OUTSIDE the node lock
        # (but still synchronously, before the publish response returns):
        # they issue nested RPCs — a recovery's shard-started report makes
        # the master publish back to THIS node, which must be able to take
        # our lock. Holding it here deadlocks the cluster over TCP.
        for action in deferred:
            action()

    def _apply_state_locked(self, state: dict) -> list:
        """Adopt a published state (caller holds self._lock). Returns the
        deferred recovery/report actions, which the caller MUST run after
        releasing the lock."""
        epoch = state.get("epoch", 0)
        if epoch < self.cluster_epoch:
            return []  # publish from a deposed master — reject
        if epoch == self.cluster_epoch:
            if state["master"] == self.master_id:
                if state["version"] < self.state_version:
                    return []  # stale
            elif state["master"] > (self.master_id or ""):
                # two independent elections can reach the SAME epoch (each
                # bumps from its local value); break the tie like the
                # election does — the lower node id wins — so exactly one
                # side is rejected and the clusters can converge
                return []
        return self._adopt_state_locked(state)

    def _adopt_state_locked(self, state: dict) -> list:
        """Unconditionally take on `state` (no staleness checks — callers
        have already decided). Also the rollback primitive: a master whose
        commit quorum failed re-adopts its pre-change snapshot here."""
        self.cluster_epoch = state.get("epoch", 0)
        self.state_version = state["version"]
        self.master_id = state["master"]
        self.known_nodes = list(state["nodes"])
        self.indices_meta = {
            name: IndexMetadata(
                name, Settings(info["settings"]), info["mappings"],
                aliases=info.get("aliases") or {},
                state=info.get("state", "open"),
                creation_date=info.get("creation_date", 0),
                version=info.get("version", 1),
            )
            for name, info in state["indices"].items()
        }
        self.routing = routing_from_dict(state["routing"])
        self.primary_terms = {
            (key.rsplit("#", 1)[0], int(key.rsplit("#", 1)[1])): term
            for key, term in state.get("primary_terms", {}).items()
        }
        if state.get("node_info"):
            self.node_info_map = {
                n: dict(info) for n, info in state["node_info"].items()}
        return self._reconcile_shards()

    def _shard_path(self, index: str, sid: int) -> str:
        """A new shard copy's data path: under ``data_path``, or a fresh
        directory under this node's temporary root (a copy that comes
        back after a failure starts empty, as it would on a new disk)."""
        if self.data_path:
            return os.path.join(self.data_path, index, str(sid))
        if self._tmp_root is None:
            self._tmp_root = tempfile.mkdtemp(
                prefix=f"estpu-torch-{self.node_id}-")
        return tempfile.mkdtemp(prefix=f"{index}_{sid}_", dir=self._tmp_root)

    def _close_shard(self, shard: IndexShard) -> None:
        """Close one local copy: its segments return their own device
        bytes and ledger scopes (other copies of the index, on this card
        too, keep theirs); a temporary store goes with it."""
        shard.close()
        if not self.data_path and self._tmp_root and shard.data_path:
            shutil.rmtree(shard.data_path, ignore_errors=True)

    def _mapper_for(self, index: str) -> MapperService:
        if index not in self.mappers:
            md = self.indices_meta[index]
            self.mappers[index] = MapperService(
                AnalysisRegistry(md.settings), md.mappings
            )
        return self.mappers[index]

    def _reconcile_shards(self) -> list:
        """Create/remove/promote local shards to match the routing table
        (IndicesClusterStateService: createOrUpdateShards/removeShards).
        Returns deferred recovery/report actions for the caller to run
        after releasing the node lock (see _apply_state)."""
        deferred: list = []
        wanted: Dict[Tuple[str, int], ShardRouting] = {}
        for index, shards in self.routing.items():
            for sid, copies in shards.items():
                for copy in copies:
                    if copy.node_id == self.node_id:
                        wanted[(index, sid)] = copy
        # remove shards no longer ours; inside an uncommitted state
        # update the close is deferred so a failed commit quorum can
        # resurrect the shard with its data (see _submit_state_update)
        for key in list(self.shards):
            if key not in wanted or key[0] not in self.indices_meta:
                shard = self.shards.pop(key)
                if self._removed_shards is not None:
                    self._removed_shards.append((key, shard))
                else:
                    self._close_shard(shard)
        # create / update
        for (index, sid), copy in wanted.items():
            shard = self.shards.get((index, sid))
            if shard is None:
                shard = IndexShard(index, sid, self._mapper_for(index),
                                   device=self.device,
                                   data_path=self._shard_path(index, sid),
                                   primary=copy.primary)
                if self.data_path and shard.has_disk_state():
                    try:
                        # restart over an existing data path: store load +
                        # translog replay bring back every acked write
                        shard.recover_from_store()
                    except CorruptIndexException as e:
                        # marked/corrupt bytes under the data path: never
                        # reload them. Quarantine the copy — a replica
                        # heals via peer recovery (the file pull wipes the
                        # directory and installs a verified set); a
                        # primary stays quarantined and fails reads
                        # loudly until a healthy copy takes over.
                        integrity_service().record_corruption(
                            index, sid, "load", str(e))
                        already = shard.engine.store.is_corrupted()
                        marker = shard.engine.store.mark_corrupted(
                            str(e), site="load")
                        if not already:
                            integrity_service().record_marker(
                                index, sid, marker, action="marked")
                        shard.store_corrupted = True
                        shard.start_fresh()
                else:
                    shard.start_fresh()
                if copy.primary:
                    shard.checkpoints = GlobalCheckpointTracker(self.node_id)
                self.shards[(index, sid)] = shard
                if copy.state == ShardRoutingState.INITIALIZING:
                    if copy.primary:
                        # fresh primary starts empty and reports started
                        deferred.append(
                            lambda i=index, s=sid: self._report_started(i, s))
                    else:
                        deferred.append(
                            lambda i=index, s=sid: self._recover_replica(i, s))
            else:
                if copy.primary and not shard.primary:
                    # replica promoted: DRAIN in-flight ops, then adopt
                    # the master-assigned term (fencing) — everything
                    # after the permit barrier runs under the new term
                    # (IndexShardOperationPermits.blockOperations) — and
                    # seed a tracker from the routing table's started
                    # copies (reference: in-sync allocation ids from
                    # IndexMetaData); their checkpoints are unknown (-1)
                    # until the next write ack, keeping the global
                    # checkpoint conservative
                    shard.promote_to_primary(
                        self.primary_terms.get((index, sid), 1))
                    tracker = GlobalCheckpointTracker(self.node_id)
                    tracker.seed_global_checkpoint(
                        shard.engine.global_checkpoint)
                    tracker.update_local_checkpoint(
                        self.node_id, shard.engine.local_checkpoint)
                    for other in self.routing.get(index, {}).get(sid, []):
                        if (other.node_id != self.node_id
                                and other.state == ShardRoutingState.STARTED):
                            tracker.mark_in_sync(other.node_id, -1, force=True)
                    shard.checkpoints = tracker
                    # post-failover warming: heat the promoted primary's
                    # search path off the query path
                    deferred.append(
                        lambda sh=shard: self._warm_promoted_primary(sh))
                elif copy.state == ShardRoutingState.INITIALIZING and not copy.primary:
                    deferred.append(
                        lambda i=index, s=sid: self._recover_replica(i, s))
            # every copy (primary or replica) adopts the published term so
            # equal-seqno tie-breaks and zombie-primary fencing work even
            # on copies that saw no write traffic from the new primary
            shard.primary_term = max(
                shard.primary_term, self.primary_terms.get((index, sid), 1))
            # prune tracker membership to the current routing copies: a
            # departed replica must not pin the global checkpoint
            tracker = getattr(shard, "checkpoints", None)
            if tracker is not None:
                tracker.prune({c.node_id
                               for c in self.routing.get(index, {}).get(sid, [])})
        return deferred

    def _primary_node(self, index: str, sid: int) -> Optional[str]:
        for copy in self.routing.get(index, {}).get(sid, []):
            if copy.primary:
                return copy.node_id
        return None

    # ------------------------------------------------------------------
    # Recovery (ops-based peer recovery, §3.5)
    # ------------------------------------------------------------------

    def _schedule_recovery_retry(self, index: str, sid: int,
                                 attempt: int) -> None:
        """Re-run a replica recovery that hit a transient race: the new
        primary's promotion can ride the SAME publish that assigned this
        INITIALIZING copy, so the source answers "not the primary" until
        it applies that state itself — and with no further state change
        coming, nothing would re-defer the recovery and the copy would
        park INITIALIZING forever. Bounded backoff, off the publish path
        (deferred actions run inside the commit RPC)."""
        if attempt >= 5 or self._closed:
            return

        def retry():
            self._timers.discard(t)
            if self._closed:
                return
            copy = next((c for c in self.routing.get(index, {}).get(sid, [])
                         if c.node_id == self.node_id), None)
            if copy is None or copy.primary \
                    or copy.state != ShardRoutingState.INITIALIZING:
                return  # no longer ours to recover
            try:
                self._recover_replica(index, sid, _attempt=attempt + 1)
            except Exception as e:  # noqa: BLE001 — kept in the node's state
                self._note_background_error(
                    f"recovery retry [{index}][{sid}]", e)

        t = threading.Timer(0.2 * (attempt + 1), retry)
        t.daemon = True
        self._timers.add(t)
        t.start()

    def _note_background_error(self, what: str, exc: BaseException) -> None:
        """A failure off the request path (a recovery retry's timer, the
        promotion warm thread): kept in ``background_errors`` and
        logged."""
        msg = f"{what}: {type(exc).__name__}: {exc}"
        logger.warning("[%s] %s", self.node_id, msg)
        self.background_errors.append(msg)

    def _recover_replica(self, index: str, sid: int,
                         _attempt: int = 0) -> None:
        primary_node = self._primary_node(index, sid)
        if primary_node is None or primary_node == self.node_id:
            self._schedule_recovery_retry(index, sid, _attempt)
            return
        # _cat/recovery progress (RecoveryState analog): one row per
        # copy, updated through every stage of this recovery. A RE-run
        # (the copy failed and recovers again) resets every counter —
        # the row describes THIS recovery, not the sum of attempts.
        record_recovery_progress(
            index, sid, self.node_id, source=primary_node, type="peer",
            stage="init", start_ms=int(time.time() * 1000), stop_ms=None,
            files_total=0, files_recovered=0, bytes_total=0,
            bytes_recovered=0, ops_total=0, ops_recovered=0)
        # phase1: copy the primary's committed segment files in chunks so
        # a fresh replica doesn't replay the whole history doc-by-doc;
        # any failure falls back to full ops replay (above_seqno = -1)
        above_seqno = -1
        try:
            above_seqno = self._pull_recovery_files(index, sid, primary_node)
        except CorruptIndexException as e:
            # corrupt bytes detected while installing the shipped set
            # (digest mismatch or checksum failure on install): retry the
            # whole session ONCE — transport-hop corruption is transient
            # and a fresh pull starts from a clean directory (the
            # transport's retries cover the per-chunk layer). A second failure
            # falls back to full ops replay, which rebuilds a correct
            # copy from the primary's live docs.
            integrity_service().record_corruption(
                index, sid, "recovery", str(e))
            try:
                above_seqno = self._pull_recovery_files(
                    index, sid, primary_node)
            except CorruptIndexException as e2:
                integrity_service().record_corruption(
                    index, sid, "recovery", str(e2))
                above_seqno = -1
            except (NodeNotConnectedException, ElasticsearchTpuException,
                    OSError, ValueError):
                above_seqno = -1
        except (NodeNotConnectedException, ElasticsearchTpuException,
                OSError, ValueError):
            above_seqno = -1
        record_recovery_progress(index, sid, self.node_id,
                                 stage="translog")
        try:
            resp = self.transport.send_request(
                primary_node, ACTION_RECOVER, {
                    "index": index, "shard": sid, "target": self.node_id,
                    "above_seqno": above_seqno,
                },
                timeout=self.recovery_action_timeout,
                retry=self.recovery_retry)
        except (NodeNotConnectedException, ElasticsearchTpuException):
            # retries with backoff exhausted — often the publish-ordering
            # race above (source not yet primary): retry off-path
            self._schedule_recovery_retry(index, sid, _attempt)
            return
        # recovery runs outside the node lock (deferred from
        # _apply_state): a concurrent newer state may have removed the
        # local copy in the meantime — bail instead of KeyError-ing
        # through the publish RPC
        shard = self.shards.get((index, sid))
        if shard is None:
            return
        record_recovery_progress(index, sid, self.node_id,
                                 add_ops_total=len(resp["ops"]))
        for op in resp["ops"]:
            self._apply_replicated_op(shard, op)
            record_recovery_progress(index, sid, self.node_id,
                                     add_ops_recovered=1)
        shard.refresh()
        # confirm the replay to the primary (recovery finalize) so it can
        # mark this copy in-sync at a checkpoint we actually hold; the
        # response carries the ops written since the stream snapshot
        # finalize loop: confirm our checkpoint, apply the returned delta,
        # repeat until the delta is empty so the primary has seen a
        # caught-up checkpoint and promotes us out of pending-in-sync
        # even if no further writes arrive (reference: pendingInSync wait
        # in markAllocationIdAsInSync)
        record_recovery_progress(index, sid, self.node_id,
                                 stage="finalize")
        for _round in range(5):
            fin = None
            try:  # transient faults retry with backoff (RetryableAction)
                fin = self.transport.send_request(
                    primary_node, ACTION_RECOVERY_FINALIZE, {
                        "index": index, "shard": sid,
                        "local_checkpoint": shard.engine.local_checkpoint,
                    },
                    timeout=self.recovery_action_timeout,
                    retry=self.recovery_retry)
            except (NodeNotConnectedException, ElasticsearchTpuException):
                pass
            if fin is None:
                # primary unreachable: stay INITIALIZING; the bounded
                # backoff (or the next publish / master health check)
                # re-runs the recovery from the top — it is idempotent
                self._schedule_recovery_retry(index, sid, _attempt)
                return
            if not fin.get("ops"):
                break
            # delta ops may race with the live write fan-out (this copy is
            # already in the primary's replication group); the engine's
            # seqno staleness guard makes the apply idempotent in either
            # order
            record_recovery_progress(index, sid, self.node_id,
                                     add_ops_total=len(fin["ops"]))
            for op in fin["ops"]:
                self._apply_replicated_op(shard, op)
                record_recovery_progress(index, sid, self.node_id,
                                         add_ops_recovered=1)
            shard.refresh()
        record_recovery_progress(index, sid, self.node_id, stage="done",
                                 stop_ms=int(time.time() * 1000))
        self._report_started(index, sid)

    @staticmethod
    def _apply_replicated_op(shard, op: dict) -> None:
        """Apply one replicated/recovery op (explicit seqno + version from
        the primary); the engine's seqno staleness guard makes this
        idempotent under redelivery and reordering."""
        if op["op"] == "delete":
            shard.engine.delete(op["id"], seqno=op["seq_no"],
                                replicated_version=op.get("version"),
                                primary_term=op.get("primary_term", 1))
        else:
            shard.engine.index(op["id"], op["source"], op.get("routing"),
                               seqno=op["seq_no"],
                               replicated_version=op.get("version"),
                               primary_term=op.get("primary_term", 1))

    def _on_start_recovery(self, payload, src) -> dict:
        """Primary side: stream live docs as seqno-stamped ops — phase2
        replay, above the seqno the file phase already shipped (or the
        whole history when there was no file phase: above_seqno = -1)."""
        shard = self.shards.get((payload["index"], payload["shard"]))
        if shard is None or not shard.primary:
            raise ElasticsearchTpuException(
                f"recovery source is not the primary for "
                f"[{payload['index']}][{payload['shard']}]"
            )
        shard.refresh()
        ops = self._collect_ops(shard, payload.get("above_seqno", -1))
        # the target is tracked (not yet in-sync) until it confirms the
        # replay via the finalize RPC (_on_recovery_finalize)
        tracker = getattr(shard, "checkpoints", None)
        if tracker is not None:
            tracker.initiate_tracking(src)
        return {"ops": ops, "max_seq_no": shard.engine.max_seqno}

    # --- phase1: segment-file shipping (RecoverySourceHandler.phase1) ---

    def _on_start_file_recovery(self, payload, src) -> dict:
        """Primary side: flush a commit, snapshot the store's files, and
        open a chunked-transfer session. The target copies segment files
        instead of replaying the whole history doc-by-doc
        (indices/recovery/RecoverySourceHandler.java:165)."""
        shard = self.shards.get((payload["index"], payload["shard"]))
        if shard is None or not shard.primary:
            raise ElasticsearchTpuException(
                f"recovery source is not the primary for "
                f"[{payload['index']}][{payload['shard']}]")
        store = shard.engine.store
        if store.is_corrupted():
            # a marked copy must never be a recovery source: shipping its
            # bytes would propagate the corruption to a healthy target
            raise ElasticsearchTpuException(
                f"recovery source [{payload['index']}][{payload['shard']}]"
                f" on [{self.node_id}] is marked corrupted")
        shard.flush()  # durable commit: segments + tombstones + terms
        commit = store.read_commit() or {}
        files: Dict[str, bytes] = {}
        base = store.directory
        for root, _dirs, names in os.walk(base):
            for name in names:
                if (root == base and name.startswith(MARKER_PREFIX)
                        and name.endswith(".json")):
                    continue  # corruption markers never ship
                full = os.path.join(root, name)
                rel = os.path.relpath(full, base)
                with open(full, "rb") as f:
                    files[rel] = f.read()
        with self._lock:
            # reclaim sessions whose targets went silent (died mid-pull)
            now = time.monotonic()
            for key in [k for k, v in self._recovery_sessions.items()
                        if now - v.get("last_used", v["t0"])
                        > RECOVERY_SESSION_MAX_AGE_S]:
                del self._recovery_sessions[key]
            self._recovery_session_seq += 1
            session = (f"{payload['index']}_{payload['shard']}_{src}_"
                       f"{self._recovery_session_seq}")
            self._recovery_sessions[session] = {
                "files": files, "t0": time.monotonic(),
                "last_used": time.monotonic(), "sent": 0, "target": src,
            }
        # per-file SHA-256 digests ride the manifest: the
        # target verifies every installed file against the SOURCE's
        # digest before adopting the set — the transport/disk hop can
        # never silently corrupt a copy
        manifest = [{"path": p, "size": len(b),
                     "digest": hashlib.sha256(b).hexdigest()}
                    for p, b in files.items()]
        return {"session": session, "files": manifest,
                "max_seq_no": int(commit.get("max_seq_no", -1))}

    def _on_recovery_file_chunk(self, payload, src) -> dict:
        with self._lock:
            sess = self._recovery_sessions.get(payload["session"])
        if sess is None:
            raise ElasticsearchTpuException(
                f"unknown recovery session [{payload['session']}]")
        data = sess["files"].get(payload["path"])
        if data is None:
            raise ElasticsearchTpuException(
                f"unknown recovery file [{payload['path']}]")
        off = int(payload.get("offset", 0))
        length = min(int(payload.get("length", RECOVERY_CHUNK_BYTES)),
                     RECOVERY_CHUNK_BYTES)
        chunk = data[off: off + length]
        sess["sent"] += len(chunk)
        sess["last_used"] = time.monotonic()
        # source-side throttle (indices.recovery.max_bytes_per_sec):
        # sleep the FULL deficit so low rates are actually honored (a
        # capped single sleep would floor the effective rate at
        # chunk_size / cap regardless of the setting)
        rate = self.recovery_max_bytes_per_sec
        if rate:
            ahead = sess["sent"] / rate - (time.monotonic() - sess["t0"])
            if ahead > 0:
                time.sleep(min(ahead, 30.0))
        return {"data": base64.b64encode(chunk).decode("ascii"),
                "eof": off + len(chunk) >= len(data)}

    def _close_recovery_sessions(self, index: str, sid: int,
                                 target: str) -> None:
        prefix = f"{index}_{sid}_{target}_"
        with self._lock:
            for key in [k for k in self._recovery_sessions
                        if k.startswith(prefix)]:
                del self._recovery_sessions[key]

    def _pull_recovery_files(self, index: str, sid: int,
                             primary_node: str) -> int:
        """Target side of phase1: open a session on the primary, pull
        every committed file in chunks into the local store, and install
        the segments (store load + version map + tombstone adoption).
        Returns the max seqno contained in the shipped files (the phase2
        replay floor). Raises on any mismatch; the caller falls back to
        full ops replay."""
        shard = self.shards.get((index, sid))
        if shard is None:
            raise ElasticsearchTpuException("local copy vanished")
        start = self.transport.send_request(
            primary_node, ACTION_RECOVER_FILES_START, {
                "index": index, "shard": sid, "target": self.node_id},
            timeout=self.recovery_action_timeout,
            retry=self.recovery_retry)
        if not start.get("files") or start.get("max_seq_no", -1) < 0:
            return -1  # empty primary: nothing to ship, pure ops replay
        record_recovery_progress(
            index, sid, self.node_id, stage="index",
            files_total=len(start["files"]),
            bytes_total=sum(int(e["size"]) for e in start["files"]))
        try:
            return self._pull_session_files(shard, start, primary_node)
        except BaseException:
            # abort: tear the source-side session down NOW instead of
            # leaving a full file snapshot pinned until the age-based
            # reclaim (the reference cancels the recovery and releases
            # its IndexCommit ref the same way); best-effort — the
            # age-based sweep remains the backstop
            try:
                self.transport.send_request(
                    primary_node, ACTION_RECOVER_FILES_CLOSE,
                    {"session": start["session"]},
                    timeout=self.recovery_action_timeout)
            except (NodeNotConnectedException, ElasticsearchTpuException):
                pass
            raise

    def _pull_session_files(self, shard, start: dict,
                            primary_node: str) -> int:
        store = shard.engine.store
        # capture markers before the wipe: a successful install below is
        # the ONE legal transition out of quarantine, and the clears must
        # land in the integrity event ring
        prior_markers = store.corruption_markers()
        # a retry may leave partial files behind — start clean
        shutil.rmtree(store.directory, ignore_errors=True)
        os.makedirs(store.directory, exist_ok=True)
        for entry in start["files"]:
            rel, size = entry["path"], entry["size"]
            full = os.path.join(store.directory, rel)
            os.makedirs(os.path.dirname(full) or store.directory,
                        exist_ok=True)
            with open(full, "wb") as f:
                offset = 0
                while offset < size:
                    # chunk pulls retry with backoff: chunks are offset-
                    # addressed reads of an immutable snapshot, so a
                    # redelivered chunk is byte-identical
                    chunk = self.transport.send_request(
                        primary_node, ACTION_RECOVER_FILE_CHUNK, {
                            "session": start["session"], "path": rel,
                            "offset": offset,
                            "length": RECOVERY_CHUNK_BYTES},
                        timeout=self.recovery_action_timeout,
                        retry=self.recovery_retry)
                    data = base64.b64decode(chunk["data"])
                    if not data and not chunk.get("eof"):
                        raise ElasticsearchTpuException(
                            f"empty non-final chunk for [{rel}]")
                    f.write(data)
                    offset += len(data)
                    record_recovery_progress(
                        shard.index_name, shard.shard_id, self.node_id,
                        add_bytes_recovered=len(data))
                    if chunk.get("eof"):
                        break
            if os.path.getsize(full) != size:
                raise ElasticsearchTpuException(
                    f"short file [{rel}]: {os.path.getsize(full)} != {size}")
            # verify the installed bytes against the SOURCE's digest
            # before adopting (Lucene verifies checksums on every file
            # adoption the same way) — a mismatch is corruption in
            # flight, caught before recover_from_store can read it
            expected = entry.get("digest")
            if expected is not None:
                with open(full, "rb") as rf:
                    actual = hashlib.sha256(rf.read()).hexdigest()
                if actual != expected:
                    raise CorruptIndexException(
                        f"recovery file [{rel}] digest mismatch "
                        f"(source={expected[:12]}, installed={actual[:12]})")
            record_recovery_progress(shard.index_name, shard.shard_id,
                                     self.node_id, add_files_recovered=1)
        # install: load the shipped commit (verifies per-segment
        # checksums), defer the version map and re-adopt the tombstones —
        # the path a restarting node takes (IndexShard.recover_from_store).
        # Segments an earlier attempt installed return their device bytes
        # first: the ledger holds only what the copy serves
        with shard.engine._lock:
            for seg in shard.engine.segments:
                seg.release_breaker_charges()
                seg.release_device()
            shard.engine.segments = []
        shard.recover_from_store()
        # the verified set is installed: the copy leaves quarantine
        for marker in prior_markers:
            integrity_service().record_marker(
                shard.index_name, shard.shard_id, marker, action="cleared")
        shard.store_corrupted = False
        return int(start["max_seq_no"])

    def _on_recovery_files_close(self, payload, src) -> dict:
        """Source side: the target aborted its file pull — free the
        session's snapshot bytes immediately."""
        with self._lock:
            self._recovery_sessions.pop(payload["session"], None)
        return {"ok": True}

    @staticmethod
    def _collect_ops(shard, above_seqno: int = -1) -> list:
        """Live docs as seqno-stamped index ops (> above_seqno), plus
        delete tombstones. Tombstones are ALWAYS included: a recovery
        re-run hits a target that may already hold state from a previous
        attempt (ops the staleness guard will noop-skip), so omitting
        deletes would resurrect docs the primary removed between
        attempts."""
        ops = []
        vmap = shard.engine.version_map
        for seg in shard.engine.searchable_segments():
            n = seg.num_docs
            for local in np.flatnonzero(seg.live[:n]
                                        & (seg.seqnos[:n] > above_seqno)):
                local = int(local)
                entry = vmap.get(seg.doc_ids[local])
                ops.append({
                    "op": "index",
                    "id": seg.doc_ids[local],
                    "source": seg.sources[local],
                    "routing": seg.routings[local],
                    "seq_no": int(seg.seqnos[local]),
                    "version": int(seg.versions[local]),
                    "primary_term": entry.term if entry is not None else 1,
                })
        for doc_id, entry in vmap.items():
            if getattr(entry, "deleted", False) and entry.seqno > above_seqno:
                ops.append({"op": "delete", "id": doc_id,
                            "seq_no": int(entry.seqno),
                            "version": int(entry.version),
                            "primary_term": entry.term})
        ops.sort(key=lambda op: op["seq_no"])
        return ops

    @staticmethod
    def _delta_ops(shard, above_seqno: int) -> list:
        """Ops with seqno > above_seqno for the finalize delta. Prefers a
        translog read (cheap, no refresh, no index scan under the
        replication lock); falls back to the full segment scan when the
        translog no longer retains that range (trimmed by a flush)."""
        from elasticsearch_tpu_torch.index.translog import TranslogOp

        tl = shard.engine.translog
        if above_seqno >= tl.committed_seqno:
            return [op.to_dict() for op in tl.snapshot(above_seqno + 1)
                    if op.op_type != TranslogOp.NO_OP]
        shard.refresh()
        return ClusterNode._collect_ops(shard, above_seqno=above_seqno)

    def _on_recovery_finalize(self, payload, src) -> dict:
        """Primary side: the target applied the streamed ops — return the
        delta written since the stream snapshot, then mark the copy
        in-sync (RecoverySourceHandler finalize ->
        markAllocationIdAsInSync). From in-sync on, the write fan-out
        covers the copy even before the master publishes STARTED, so no
        op can fall into the finalize->STARTED window."""
        with self._replication_lock:  # serialize vs _on_write_primary: no
            # op may land between the delta snapshot and the in-sync mark
            shard = self.shards.get((payload["index"], payload["shard"]))
            tracker = getattr(shard, "checkpoints", None) if shard else None
            delta = []
            if shard is not None:
                delta = self._delta_ops(shard, payload["local_checkpoint"])
            if tracker is not None:
                # credit only what the target confirmed; the delta is
                # applied after this RPC returns and the next write ack
                # advances the checkpoint
                tracker.mark_in_sync(src, payload["local_checkpoint"])
        # phase1 file session no longer needed once the target reached
        # the finalize stage — free the snapshot bytes
        self._close_recovery_sessions(payload["index"], payload["shard"], src)
        return {"ok": True, "ops": delta}

    def _report_started(self, index: str, sid: int) -> None:
        try:
            self.transport.send_request(
                self.master_id, ACTION_SHARD_STARTED, {
                    "index": index, "shard": sid, "node": self.node_id,
                },
                timeout=self.request_timeout, retry=self.retry_policy)
        except NodeNotConnectedException:
            pass
        except FailedToCommitClusterStateException:
            # the master could not commit the started-state; it rolled
            # back and stepped down. Swallow: the next elected master
            # re-allocates and this copy re-reports. Propagating would
            # crash the applier loop that triggered the recovery. (When
            # the report ran as a deferred action inside our OWN
            # _submit_state_update, swallowing is still safe: the outer
            # publish independently hits the same dead quorum and rolls
            # the outer change back.)
            pass

    def _on_shard_started(self, payload, src) -> dict:
        with self._lock:
            if not self.is_master:
                return {"ok": False}

        def mutate():
            if not self.is_master:
                raise NotMasterException("master changed")
            for copy in self.routing.get(
                    payload["index"], {}).get(payload["shard"], []):
                if copy.node_id == payload["node"]:
                    copy.state = ShardRoutingState.STARTED

        try:
            self._submit_state_update(mutate)
        except NotMasterException:
            # mastership moved between the pre-check and the locked
            # mutate: answer the benign no-op the reporter expects
            # instead of raising across the RPC
            return {"ok": False}
        return {"ok": True}

    def _on_shard_failed(self, payload, src) -> dict:
        """Primary reports a failed replica copy; master drops it from the
        routing table and reroutes (ShardStateAction.shardFailed)."""
        with self._lock:
            if not self.is_master:
                return {"ok": False}

        def mutate():
            if not self.is_master:
                raise NotMasterException("master changed")
            if payload["index"] not in self.routing:
                # the index was deleted while the report was in flight —
                # a benign no-op, not a crash across the reporter's RPC
                raise NotMasterException("index no longer routed")
            copies = self.routing[payload["index"]].get(payload["shard"], [])
            if payload.get("corrupt"):
                key = (payload["index"], payload["shard"])
                survivors = [
                    c for c in copies
                    if c.node_id != payload["node"]
                    and c.state == ShardRoutingState.STARTED]
                if not survivors:
                    # LAST-copy corruption: dropping it would let the
                    # allocator fill a fresh EMPTY primary — silent
                    # data-loss resurrection. Retain the copy routed
                    # (quarantined on its node, every read fails loudly)
                    # and surface the marker via allocation explain /
                    # _cat/shards until an operator restores a snapshot
                    # or the bytes are repaired out of band.
                    self.corrupt_retained[key] = {
                        "node": payload["node"],
                        "reason": payload.get("reason", ""),
                    }
                    raise NotMasterException("last copy retained")
                self.corrupt_retained.pop(key, None)
            self.routing[payload["index"]][payload["shard"]] = [
                c for c in copies if c.node_id != payload["node"]
            ]

        try:
            self._submit_state_update(mutate)
        except NotMasterException:
            return {"ok": False}
        return {"ok": True}

    # ------------------------------------------------------------------
    # Write path (ReplicationOperation, §3.3)
    # ------------------------------------------------------------------

    def _on_write_primary(self, payload, src) -> dict:
        with self._replication_lock:  # pairs with _on_recovery_finalize
            result, failed_copies = self._write_primary_locked(payload, src)
        # report failed copies OUTSIDE the lock: the master's publish can
        # re-enter other nodes' locks and must not nest under ours
        for node_id in failed_copies:
            try:
                self.transport.send_request(
                    self.master_id, ACTION_SHARD_FAILED, {
                        "index": payload["index"],
                        "shard": payload["shard"],
                        "node": node_id,
                    },
                    timeout=self.request_timeout, retry=self.report_retry)
            except FailedToCommitClusterStateException:
                # a master that could not commit the copy-removal rolled
                # back and stepped down; the re-elected master's epoch
                # fences the old cluster and reconciliation re-runs —
                # the write keeps its ack (same rationale as
                # _report_started)
                pass
            except NodeNotConnectedException as e:
                # the failed copy could NOT be reported: the routing
                # table still lists it STARTED, so a later promotion
                # could pick the diverged copy and lose this op. The
                # reference fails the primary rather than ack
                # (ReplicationOperation.onNoLongerPrimary) — surface
                # the uncertainty so the coordinator retries the write
                # instead of treating it as durably replicated.
                raise ElasticsearchTpuException(
                    f"replica [{node_id}] failed for "
                    f"[{payload['index']}][{payload['shard']}] but the "
                    f"failure could not be reported to the master; the "
                    f"write is not fully replicated") from e
        return result

    def _write_primary_locked(self, payload, src) -> dict:
        index, sid = payload["index"], payload["shard"]
        shard = self.shards.get((index, sid))
        if shard is None or not shard.primary:
            raise ElasticsearchTpuException(
                f"[{index}][{sid}] primary is not allocated on [{self.node_id}]"
            )
        copies = self.routing.get(index, {}).get(sid, [])
        wfas = payload.get("wait_for_active_shards")
        if wfas is not None:
            from elasticsearch_tpu_torch.index.seqno import check_active_shards

            active = sum(1 for c in copies
                         if c.state == ShardRoutingState.STARTED)
            check_active_shards(wfas, active, len(copies), f"[{index}][{sid}]")
        # primary operation permit (IndexShard.java:2089): fences ops the
        # coordinator routed under a superseded term AND holds the permit
        # a promotion/handoff drain waits on
        with shard.acquire_primary_permit(payload.get("term")):
            if payload["op"] == "index":
                result = shard.index_doc(payload["id"], payload["source"],
                                         payload.get("routing"))
            else:
                result = shard.delete_doc(payload["id"])
        # track the primary's own checkpoint, then fan out to replicas with
        # the primary-assigned seqno/version + the current global checkpoint
        # (piggybacked like the reference's replication requests)
        tracker = getattr(shard, "checkpoints", None)
        if tracker is not None:
            tracker.update_local_checkpoint(self.node_id,
                                            shard.engine.local_checkpoint)
        replica_payload = dict(payload)
        replica_payload["seq_no"] = result["_seq_no"]
        replica_payload["version"] = result["_version"]
        replica_payload["primary_term"] = shard.primary_term
        replica_payload["global_checkpoint"] = (
            tracker.global_checkpoint if tracker is not None else -1)
        acks = 1
        failed_copies = []
        for copy in self.routing.get(index, {}).get(sid, []):
            if copy.primary:
                continue
            # replication group = STARTED copies + copies already marked
            # in-sync by recovery finalize (the master may not have
            # published STARTED yet; skipping them would lose the ops
            # written in that window)
            in_sync = tracker is not None and (
                copy.node_id in tracker.in_sync
                or copy.node_id in tracker.pending_in_sync)
            if copy.state != ShardRoutingState.STARTED and not in_sync:
                continue
            try:
                # deadline + bounded retries: a lagging or blackholed
                # replica costs at most the replication timeout, then is
                # FAILED (removed from in-sync, reported to the master
                # for reroute) while the primary keeps serving — the
                # replicated op is seqno-stamped, so retries are
                # idempotent under redelivery
                ack = self.transport.send_request(
                    copy.node_id, ACTION_WRITE_REPLICA, replica_payload,
                    timeout=self.replication_timeout,
                    retry=self.replication_retry)
                acks += 1
                if tracker is not None:
                    tracker.update_local_checkpoint(
                        copy.node_id, ack.get("local_checkpoint", -1))
            except (NodeNotConnectedException, ElasticsearchTpuException):
                # shrink the in-sync set now; the master report happens
                # outside the replication lock (§5.3)
                if tracker is not None:
                    tracker.remove(copy.node_id)
                failed_copies.append(copy.node_id)
        if tracker is not None:
            shard.engine.global_checkpoint = tracker.global_checkpoint
        result["_shards"] = {"total": len(self.routing.get(index, {}).get(sid, [])),
                             "successful": acks, "failed": len(failed_copies)}
        if failed_copies:
            # ReplicationResponse.ShardInfo: per-copy failure details
            result["_shards"]["failures"] = [
                {"_index": index, "_shard": sid, "_node": node_id,
                 "status": "INTERNAL_SERVER_ERROR", "primary": False,
                 "reason": {"type": "replication_failed_exception",
                            "reason": f"failed to replicate to [{node_id}]"}}
                for node_id in failed_copies
            ]
        return result, failed_copies

    def _on_write_replica(self, payload, src) -> dict:
        shard = self.shards.get((payload["index"], payload["shard"]))
        if shard is None:
            raise ElasticsearchTpuException(
                f"replica shard [{payload['index']}][{payload['shard']}] not "
                f"allocated on [{self.node_id}]"
            )
        if payload.get("primary_term", 1) < shard.primary_term:
            # stale primary (fencing, IndexShardOperationPermits analog)
            raise ElasticsearchTpuException("operation primary term is too old")
        # learn a newer term from write traffic too — the publish that
        # carries it may still be in flight
        shard.primary_term = max(shard.primary_term,
                                 payload.get("primary_term", 1))
        self._apply_replicated_op(shard, payload)
        # learn the primary's global checkpoint; report our local one back
        shard.engine.global_checkpoint = max(
            shard.engine.global_checkpoint,
            payload.get("global_checkpoint", -1))
        return {"ok": True,
                "local_checkpoint": shard.engine.local_checkpoint}

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def _on_get(self, payload, src) -> dict:
        shard = self.shards.get((payload["index"], payload["shard"]))
        if shard is None:
            raise ElasticsearchTpuException("shard not allocated here")
        g = shard.get_doc(payload["id"])
        return {
            "found": g.found,
            "_id": payload["id"],
            "_source": g.source,
            "_version": g.version,
            "_seq_no": g.seqno,
        }

    def _on_query(self, payload, src) -> dict:
        shard = self.shards.get((payload["index"], payload["shard"]))
        if shard is None:
            raise ElasticsearchTpuException("shard not allocated here")
        body = payload["body"] or {}
        from elasticsearch_tpu_torch.search.service import fetch_hits
        from elasticsearch_tpu_torch.search.telemetry import (
            get_opaque_id,
            set_opaque_id,
        )

        # the coordinator's task headers ride the transport hop (the
        # reference forwards threadContext headers on every internal
        # action): the data node's slowlog/profile lines join to the
        # ORIGINATING client's X-Opaque-Id
        headers = payload.get("headers") or {}
        prev_oid = get_opaque_id()
        set_opaque_id(headers.get("X-Opaque-Id") or prev_oid)
        try:
            if getattr(shard, "store_corrupted", False):
                # quarantined copy: fail fast (no re-read of marked
                # bytes, no re-detection) — the coordinator fails over
                # to the next ranked copy (ClusterClient.search)
                raise CorruptIndexException(
                    f"shard [{payload['index']}][{payload['shard']}] "
                    f"copy on [{self.node_id}] is marked corrupted")
            try:
                result = shard.searcher.query(body,
                                              size_hint=payload.get("k", 10))
                hits = fetch_hits(result.refs, {shard.shard_id: shard},
                                  body, payload["index"])
            except CorruptIndexException as e:
                # first detection on the cluster query path: quarantine
                # this copy and tell the master so a healthy copy takes
                # over (promotion / re-recovery); re-raise so the
                # coordinator's failover walk tries the next copy — a
                # partial answer, never a silent wrong result
                self._fail_corrupted_copy(
                    payload["index"], payload["shard"], shard, e)
                raise
        finally:
            set_opaque_id(prev_oid)
        for ref, hit in zip(result.refs, hits):
            hit["_sort_tuple"] = list(ref.sort_values)
        # the answer leaves the node as JSON values: no tensor and no
        # numpy scalar crosses the hub
        return _plain({
            "total": int(result.total_hits),
            "max_score": (None if result.max_score is None
                          else float(result.max_score)),
            "hits": hits,
        })

    def _fail_corrupted_copy(self, index: str, sid: int, shard,
                             exc: Exception) -> None:
        """Local quarantine + master report for a corrupt copy detected
        on the serve path: write the marker, flag the shard,
        release its device staging through the accountant (ledger exact
        — a quarantined copy must not pin HBM), then report our own copy
        failed with the corrupt flag so the master heals — replica:
        re-recover from the primary; primary: fail over to a STARTED
        replica; last copy: retained quarantined (RED), never replaced
        with a fresh empty primary."""
        store = shard.engine.store
        integ = integrity_service()
        integ.record_corruption(index, sid, "query", str(exc))
        already = store.is_corrupted()
        marker = store.mark_corrupted(str(exc), site="query")
        if not already:
            integ.record_marker(index, sid, marker, action="marked")
        shard.store_corrupted = True
        for seg in list(shard.engine.segments):
            seg.release_device()
        try:
            self.transport.send_request(
                self.master_id, ACTION_SHARD_FAILED, {
                    "index": index, "shard": sid, "node": self.node_id,
                    "corrupt": True, "reason": str(exc)[:200],
                },
                timeout=self.request_timeout, retry=self.report_retry)
        except (NodeNotConnectedException, ElasticsearchTpuException,
                FailedToCommitClusterStateException):
            # unreachable/stepped-down master: the copy stays quarantined
            # locally (queries fail over); the next master health pass or
            # state publish re-reports through reconciliation
            pass

    def _on_refresh(self, payload, src) -> dict:
        shard = self.shards.get((payload["index"], payload["shard"]))
        if shard is not None:
            shard.refresh()
        return {"ok": True}

    def _warm_promoted_primary(self, shard) -> None:
        """Post-failover promotion warming: the promoted primary's first
        search (its segments staged on the node's device) runs on a
        thread of its own, off the query path, so the first client search
        after a promotion does not pay the cold path. A failure is
        counted (``warm_failures``, ``background_errors``) and the warm
        serves nothing; the next search meets the fault itself."""
        def warm():
            from elasticsearch_tpu_torch.common.compile_cache import warming

            try:
                with warming():
                    shard.searcher.query({"query": {"match_all": {}}},
                                         size_hint=1)
                self.warm_runs += 1
            except Exception as e:  # noqa: BLE001 — counted, not served
                self.warm_failures += 1
                self._note_background_error(
                    f"promotion warm [{shard.index_name}][{shard.shard_id}]",
                    e)

        t = threading.Thread(target=warm, daemon=True,
                             name=f"promote-warm[{shard.index_name}]"
                                  f"[{shard.shard_id}]")
        self._warm_threads.append(t)
        t.start()

    def join_background(self, timeout: float = 60.0) -> None:
        """Wait for the promotion warm threads to end."""
        for t in list(self._warm_threads):
            t.join(timeout)
        self._warm_threads = [t for t in self._warm_threads if t.is_alive()]

    def close(self, graceful: bool = True) -> None:
        """Shutdown ordering: durable synced-flush marker first (warm
        restart over this data path recovers ops-free), then the
        graceful-leave announcement (peers reroute and promote NOW), then
        transport deregistration BEFORE the shards close — a closing node
        must never receive and half-serve a routed request mid-teardown.
        Then the recovery retries are cancelled, the warm threads joined,
        and the shards and the temporary directory go."""
        if self._closed:
            return
        self._closed = True
        if getattr(self, "_fd_stop", None) is not None:
            self._fd_stop.set()
        if self.data_path:
            for shard in list(self.shards.values()):
                try:
                    shard.synced_flush()
                except Exception:  # noqa: BLE001 — flush is best-effort
                    pass  # at shutdown; translog replay covers the gap
        if graceful:
            try:
                self.graceful_leave()
            except Exception:  # noqa: BLE001 — fall back to FD removal
                pass
        self.transport.close()
        for t in list(self._timers):
            t.cancel()
        self.join_background()
        for shard in list(self.shards.values()):
            self._close_shard(shard)
        if self._tmp_root is not None:
            shutil.rmtree(self._tmp_root, ignore_errors=True)


class ClusterClient:
    """Coordinator-side API over the cluster (any node can coordinate —
    here the client picks routes directly from its node's state copy)."""

    def __init__(self, node: ClusterNode):
        self.node = node
        # adaptive replica selection: rank copies by observed latency
        # (node/ResponseCollectorService.java)
        from elasticsearch_tpu_torch.cluster.response_collector import (
            ResponseCollectorService,
        )

        self.response_collector = ResponseCollectorService()

    def _timed_request(self, node_id: str, action: str, payload):
        self.response_collector.on_send(node_id)
        t0 = time.monotonic()
        try:
            resp = self.node.transport.send_request(
                node_id, action, payload,
                timeout=self.node.request_timeout)
            # successes feed the EWMA; failures go through the penalty
            # path below — a dead node's instant connection error must
            # not earn it the best rank
            self.response_collector.add_response_time(
                node_id, time.monotonic() - t0)
            return resp
        except Exception:
            # unreachable copy OR a remote query-phase failure: penalize
            # its rank either way, so adaptive replica selection reroutes
            # reads away from a copy that keeps erroring (a corrupt
            # replica must not stay first in every failover walk)
            self.response_collector.on_failure(
                node_id, time.monotonic() - t0)
            raise
        finally:
            self.response_collector.on_complete(node_id)

    def _routing_entry(self, index: str, doc_id: str,
                       routing: Optional[str]) -> Tuple[int, str]:
        md = self.node.indices_meta.get(index)
        if md is None:
            raise IndexNotFoundException(index)
        sid = shard_id_for(routing if routing is not None else doc_id,
                           md.num_shards)
        primary = self.node._primary_node(index, sid)
        if primary is None:
            raise ElasticsearchTpuException(
                f"primary shard [{index}][{sid}] is unassigned"
            )
        return sid, primary

    def index(self, index: str, doc_id: str, source: dict,
              routing: Optional[str] = None,
              wait_for_active_shards=None) -> dict:
        sid, primary = self._routing_entry(index, doc_id, routing)
        # deadline only, NO retry: re-sending a primary write after a
        # timeout could double-apply it (the op has no client-side
        # idempotency token); the uncertainty surfaces to the caller
        return self.node.transport.send_request(primary, ACTION_WRITE_PRIMARY, {
            "op": "index", "index": index, "shard": sid, "id": doc_id,
            "source": source, "routing": routing,
            "wait_for_active_shards": wait_for_active_shards,
            # the coordinator's view of the primary term rides along so
            # the primary's operation permit can fence ops routed under
            # a superseded term (TransportReplicationAction carries the
            # primary term the same way)
            "term": self.node.primary_terms.get((index, sid)),
        }, timeout=self.node.request_timeout)

    def delete(self, index: str, doc_id: str) -> dict:
        sid, primary = self._routing_entry(index, doc_id, None)
        return self.node.transport.send_request(primary, ACTION_WRITE_PRIMARY, {
            "op": "delete", "index": index, "shard": sid, "id": doc_id,
            "term": self.node.primary_terms.get((index, sid)),
        }, timeout=self.node.request_timeout)

    def get(self, index: str, doc_id: str, prefer_replica: bool = False) -> dict:
        md = self.node.indices_meta.get(index)
        if md is None:
            raise IndexNotFoundException(index)
        sid = shard_id_for(doc_id, md.num_shards)
        copies = [c for c in self.node.routing[index][sid]
                  if c.state == ShardRoutingState.STARTED]
        if prefer_replica:
            copies.sort(key=lambda c: c.primary)
        else:
            # adaptive replica selection: best-ranked copy first, primary
            # breaking ties
            copies = self.response_collector.order_copies(copies)
        for copy in copies:
            try:
                return self._timed_request(copy.node_id, ACTION_GET, {
                    "index": index, "shard": sid, "id": doc_id,
                })
            except NodeNotConnectedException:
                continue
        raise ElasticsearchTpuException(f"no available copy for [{index}][{sid}]")

    def refresh(self, index: str) -> None:
        for sid, copies in self.node.routing.get(index, {}).items():
            for copy in copies:
                try:
                    self.node.transport.send_request(copy.node_id, ACTION_REFRESH, {
                        "index": index, "shard": sid,
                    }, timeout=self.node.request_timeout)
                except NodeNotConnectedException:
                    pass

    def search(self, index: str, body: Optional[dict] = None) -> dict:
        """Scatter-gather across one STARTED copy per shard (§3.2).

        Per-shard isolation (AbstractSearchAsyncAction.onShardFailure):
        a copy that fails — connection loss OR a query-phase exception on
        the remote shard — fails over to the next ranked copy; a shard
        with no surviving copy becomes a failures[] entry and the
        response degrades to partial results (HTTP 200, _shards.failed),
        unless allow_partial_search_results=false."""
        from elasticsearch_tpu_torch.common.errors import (
            SearchPhaseExecutionException,
        )
        from elasticsearch_tpu_torch.search.service import (
            allow_partial_results,
            shard_failure_entry,
        )

        body = body or {}
        if "allow_partial_search_results" not in body and \
                not S.SEARCH_ALLOW_PARTIAL_RESULTS.get(self.node.settings):
            body = dict(body)
            body["allow_partial_search_results"] = False
        md = self.node.indices_meta.get(index)
        if md is None:
            raise IndexNotFoundException(index)
        # coordinator → data-node task headers: the client's X-Opaque-Id
        # crosses the transport hop with the per-shard query actions so
        # remote slowlog/profile lines join to the originating client
        from elasticsearch_tpu_torch.search.telemetry import get_opaque_id

        opaque_id = get_opaque_id()
        hop_headers = ({"X-Opaque-Id": opaque_id} if opaque_id else None)
        from_ = int(body.get("from", 0) or 0)
        size = int(body.get("size", 10) if body.get("size") is not None else 10)
        k = from_ + size
        total = 0
        max_score = None
        all_hits = []
        shard_count = 0
        failures = []
        for sid, copies in sorted(self.node.routing.get(index, {}).items()):
            started = [c for c in copies if c.state == ShardRoutingState.STARTED]
            # adaptive replica selection orders copies; failover walks the
            # ranked list
            started = self.response_collector.order_copies(started)
            shard_count += 1
            resp = None
            last_error = None
            for copy in started:
                try:
                    payload = {"index": index, "shard": sid, "body": body,
                               "k": max(k, 1)}
                    if hop_headers:
                        payload["headers"] = hop_headers
                    resp = self._timed_request(copy.node_id, ACTION_QUERY,
                                               payload)
                    break
                except NodeNotConnectedException:
                    continue
                except Exception as e:  # noqa: BLE001 — shard-level failure
                    from elasticsearch_tpu_torch.index.index_service import (
                        _is_request_error,
                    )

                    if _is_request_error(e):
                        raise  # 4xx validation: keeps its own status
                    # the remote query phase executed and failed; record
                    # it and try the next copy (the failure may be
                    # copy-local — a corrupt segment on one replica)
                    last_error = e
                    continue
            if resp is None:
                if last_error is not None:
                    failures.append(shard_failure_entry(
                        index, sid, last_error))
                else:
                    failures.append({"shard": sid, "index": index,
                                     "reason": "no available shard copy"})
                continue
            total += resp["total"]
            if resp["max_score"] is not None:
                max_score = (resp["max_score"] if max_score is None
                             else max(max_score, resp["max_score"]))
            all_hits.extend(resp["hits"])
        # NOTE: unlike the single-node path, all-shards-unavailable stays
        # a degraded 200 here — the RED-shard contract: a cluster
        # serving through an outage reports the failed shards loudly in
        # _shards rather than erroring reads that might still match docs
        # on recovering copies moments later
        if failures and not allow_partial_results(body):
            raise SearchPhaseExecutionException(
                "query", "Partial shards failure", failures)
        from elasticsearch_tpu_torch.search.service import (
            multi_pass_sort,
            normalize_sort,
        )

        # normalize_sort collapses a lone _score sort to None: that (and
        # no sort at all) ranks by score descending
        spec = (normalize_sort(body.get("sort"))
                if body.get("sort") is not None else None)
        if spec:
            multi_pass_sort(all_hits, spec,
                            lambda h: tuple(h.get("_sort_tuple", ())))
        else:
            all_hits.sort(key=lambda h: -(h.get("_score") or 0.0))
        for h in all_hits:
            h.pop("_sort_tuple", None)
        resp = {
            "took": 0,
            "timed_out": False,
            "_shards": {"total": shard_count,
                        "successful": shard_count - len(failures),
                        "failed": len(failures)},
            "hits": {
                "total": total,
                "max_score": max_score,
                "hits": all_hits[from_: from_ + size],
            },
        }
        if failures:
            resp["_shards"]["failures"] = failures
        return resp
