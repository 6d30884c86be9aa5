"""Transport, query-path, device and store fault injection.

Counterpart of ``elasticsearch_tpu/testing/disruption.py``.

The transport schemes are installed on a ``TransportHub``
(``transport/local.py``) with ``apply_to(hub)`` and run on every delivery
they match (``applies(src, dst, action)``, then ``disrupt``):
``NetworkDelay`` sleeps, ``NetworkDrop`` (seeded) and
``NetworkPartition`` (two node sets, optionally one way) raise
``NodeNotConnectedException``, ``UnresponsiveNode`` and
``ActionBlackhole`` block until the caller's deadline fires. ``remove()``
uninstalls a scheme and unblocks its parked deliveries.

The query-path schemes live in a process-global registry with hooks:

- ``on_shard_search`` runs at the start of every shard's query phase on
  the host rung (``ShardSearcher.query``): ``SearchDelayScheme`` stalls a
  shard (the straggler that trips a ``timeout``) and ``SearchFailScheme``
  makes it raise (a ``_shards.failures`` entry).
- ``on_device_staging`` runs just before every device staging site's
  transfer group: ``StagingFailScheme`` makes the Nth matching staging
  raise a transient or a deterministic fault.
- ``on_plane_execute`` runs before each plane attempt of the mesh ladder
  (``mesh_pallas`` or ``mesh``), ahead of its deadline checkpoint:
  ``PlaneFailScheme`` makes the plane raise there (the plane is
  quarantined and the next rung serves) and ``MeshPlaneDelayScheme``
  holds the request there (for a cancel).
- ``on_kernel_launch`` runs right before each launch of the mesh plane,
  with the rung launching (``mesh_pallas`` serial, ``mesh`` scatter,
  ``batched``, ``pruned`` or ``knn``): ``KernelLaunchFailScheme`` faults
  it as a real launch would. A kernel rung raises ``KernelError``, which
  no other rung serves (the request fails with a 500 and no plane is
  quarantined); the scatter rung, which launches no hand-written kernel,
  raises a plane fault. The JAX package's scheme raises a plane fault on
  every rung and serves from the next one.
- ``on_query_begin`` runs once a search dispatch (``IndexService``):
  ``EvictionStormScheme`` forces the device-memory ledger's LRU evictor
  there, under real query load.
- ``queue_pressure`` is what ``search/admission.py`` consults at every
  acquire and release: ``QueuePressureScheme`` pins synthetic queue
  occupancy, withholds concurrency slots or slows the drain.

``StoreCorruptionScheme`` corrupts a committed segment at rest (a flipped
bit, a truncated file, a torn or missing ``checksums.json``): the next
load, scrub or restore must catch it. In flight, installed on a hub with
``source_node`` set, it flips a bit in the source's recovery-session
snapshot at the first matching file-chunk delivery: the target's digest
check must catch it, and the retried session heals.
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from typing import Iterable, Optional, Sequence

from elasticsearch_tpu_torch.common.errors import NodeNotConnectedException
from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError


# ---------------------------------------------------------------------------
# Transport schemes (deliveries between the nodes of a TransportHub)
# ---------------------------------------------------------------------------


class DisruptionScheme:
    """Base scheme: optional link and action filters + the effect hook.

    ``src``/``dst``: deliveries from/to these node ids (None = any).
    ``nodes``: deliveries touching any of these nodes either way.
    ``actions``: fnmatch patterns over the action name
    (``internal:cluster/*``).
    """

    def __init__(self, src: Optional[Iterable[str]] = None,
                 dst: Optional[Iterable[str]] = None,
                 nodes: Optional[Iterable[str]] = None,
                 actions: Optional[Sequence[str]] = None):
        self.src = set(src) if src else None
        self.dst = set(dst) if dst else None
        self.nodes = set(nodes) if nodes else None
        self.actions = list(actions) if actions else None
        self.hub = None

    def apply_to(self, hub) -> "DisruptionScheme":
        hub.add_disruption(self)
        self.hub = hub
        return self

    def remove(self) -> None:
        if self.hub is not None:
            self.hub.remove_disruption(self)
            self.hub = None

    def applies(self, src: str, dst: str, action: str) -> bool:
        if self.src is not None and src not in self.src:
            return False
        if self.dst is not None and dst not in self.dst:
            return False
        if self.nodes is not None and not ({src, dst} & self.nodes):
            return False
        if self.actions is not None and not any(
                # exact match first: action names hold [s][r] suffixes
                # that fnmatch would read as character classes
                action == pat or fnmatch.fnmatch(action, pat)
                for pat in self.actions):
            return False
        return True

    def disrupt(self, src: str, dst: str, action: str) -> None:
        """The effect; runs outside the hub lock. May sleep or raise."""
        raise NotImplementedError


class NetworkDelay(DisruptionScheme):
    """A fixed, or uniformly random, delay a delivery."""

    def __init__(self, seconds: float, max_seconds: Optional[float] = None,
                 seed: Optional[int] = None, **filters):
        super().__init__(**filters)
        self.seconds = float(seconds)
        self.max_seconds = float(max_seconds) if max_seconds else None
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()

    def delay(self) -> float:
        if self.max_seconds is None:
            return self.seconds
        with self._rng_lock:
            return self._rng.uniform(self.seconds, self.max_seconds)

    def disrupt(self, src, dst, action) -> None:
        time.sleep(self.delay())


class NetworkDrop(DisruptionScheme):
    """Each matching delivery fails with probability ``p`` (a
    connection-level error, so retries and failover engage); ``seed``
    makes the sequence reproducible."""

    def __init__(self, p: float, seed: Optional[int] = None, **filters):
        super().__init__(**filters)
        if not 0.0 <= p <= 1.0:
            raise ValueError("drop probability must be in [0, 1]")
        self.p = float(p)
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.dropped = 0

    def disrupt(self, src, dst, action) -> None:
        with self._rng_lock:
            hit = self._rng.random() < self.p
        if hit:
            self.dropped += 1
            raise NodeNotConnectedException(
                f"[{dst}] dropped [{action}] from [{src}] (injected)")


class NetworkPartition(DisruptionScheme):
    """A partition between two node sets; ``one_way=True`` drops only
    side1 -> side2 (a deposed master can still hear the cluster that no
    longer hears it)."""

    def __init__(self, side1: Iterable[str], side2: Iterable[str],
                 one_way: bool = False, **filters):
        super().__init__(**filters)
        self.side1 = set(side1)
        self.side2 = set(side2)
        self.one_way = bool(one_way)

    def disrupt(self, src, dst, action) -> None:
        forward = src in self.side1 and dst in self.side2
        backward = src in self.side2 and dst in self.side1
        if forward or (backward and not self.one_way):
            raise NodeNotConnectedException(
                f"[{dst}] partitioned from [{src}] (injected)")


class UnresponsiveNode(DisruptionScheme):
    """The node takes requests and never answers: a delivery blocks
    until the caller's timeout fires (or ``max_block_s``, a leak guard),
    then fails; ``remove()`` unblocks the parked deliveries at once."""

    def __init__(self, node: str, max_block_s: float = 60.0, **filters):
        filters.setdefault("nodes", [node])
        super().__init__(**filters)
        self.node = node
        self.max_block_s = float(max_block_s)
        self._healed = threading.Event()

    def remove(self) -> None:
        self._healed.set()
        super().remove()

    def disrupt(self, src, dst, action) -> None:
        self._healed.wait(self.max_block_s)
        raise NodeNotConnectedException(
            f"[{self.node}] unresponsive, [{action}] never answered "
            f"(injected)")


class ActionBlackhole(DisruptionScheme):
    """Requests matching the action patterns vanish: the delivery blocks
    until the caller's deadline. Scope with ``dst=[...]`` to blackhole one
    replica's writes while the node stays reachable otherwise."""

    def __init__(self, actions: Sequence[str], max_block_s: float = 60.0,
                 **filters):
        super().__init__(actions=list(actions), **filters)
        self.max_block_s = float(max_block_s)
        self._healed = threading.Event()
        self.swallowed = 0

    def remove(self) -> None:
        self._healed.set()
        super().remove()

    def disrupt(self, src, dst, action) -> None:
        self.swallowed += 1
        self._healed.wait(self.max_block_s)
        raise NodeNotConnectedException(
            f"[{dst}] blackholed [{action}] from [{src}] (injected)")


# ---------------------------------------------------------------------------
# Query-path, device and store schemes
# ---------------------------------------------------------------------------

_SEARCH_SCHEMES: list = []


class ShardSearchScheme:
    """Base for query-path schemes. ``indices`` and ``shards`` filter the
    (index, shard) query phases the scheme touches (None = any)."""

    def __init__(self, indices: Optional[Iterable[str]] = None,
                 shards: Optional[Iterable[int]] = None):
        self.indices = set(indices) if indices else None
        self.shards = set(shards) if shards is not None else None
        self.hits = 0

    def install(self) -> "ShardSearchScheme":
        _SEARCH_SCHEMES.append(self)
        return self

    def remove(self) -> None:
        if self in _SEARCH_SCHEMES:
            _SEARCH_SCHEMES.remove(self)

    def applies(self, index: str, shard_id) -> bool:
        if self.indices is not None and index not in self.indices:
            return False
        if self.shards is not None and shard_id not in self.shards:
            return False
        return True

    def on_search(self, index: str, shard_id: int) -> None:
        """Effect hook for a shard's query phase on the host rung."""

    def on_plane(self, index: str, plane: str) -> None:
        """Effect hook for a mesh plane attempt (``mesh_pallas`` or
        ``mesh``), before its deadline checkpoint."""

    def on_staging(self, index: str, kind: str, table: str) -> None:
        """Effect hook for a device staging boundary: called right before
        a staging site's transfer group with the ledger kind
        (postings_raw / postings_packed / live_mask / embeddings /
        scale_norm / mesh_slot_tables / doc_values) and the table name."""

    def on_launch(self, index: str, rung: str) -> None:
        """Effect hook for a kernel launch of the mesh plane, per rung
        (``mesh_pallas`` / ``mesh`` / ``batched`` / ``pruned`` /
        ``knn``)."""

    def on_query(self, index: str) -> None:
        """Effect hook at a search's dispatch, before any plane or shard
        work."""


def clear_search_disruptions() -> None:
    del _SEARCH_SCHEMES[:]


def on_shard_search(index: str, shard_id: int) -> None:
    """Called by ``ShardSearcher.query`` before its segments run; runs
    every installed matching scheme in installation order."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.applies(index, shard_id):
            scheme.on_search(index, shard_id)


def on_plane_execute(index: str, plane: str) -> None:
    """Called by the mesh plane right before it executes on a plane
    (``mesh_pallas`` or ``mesh``): a raise here is a fault of that plane.
    Shard filters do not apply: the plane runs every shard as one
    program."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.indices is None or index in scheme.indices:
            scheme.on_plane(index, plane)


def on_kernel_launch(index: str, rung: str) -> None:
    """Called right before each launch of the mesh plane with the rung
    launching; a ``KernelError`` raised here reaches the caller, any other
    raise lands in the plane ladder's fault handler (quarantine, the next
    rung)."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.indices is None or index in scheme.indices:
            scheme.on_launch(index, rung)


def on_query_begin(index: str) -> None:
    """Called once a search dispatch (``IndexService``)."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.indices is None or index in scheme.indices:
            scheme.on_query(index)


def on_device_staging(index: str, kind: str, table: str) -> None:
    """Called by every device staging site (segment stagings, the mesh
    executor's slot tables, kernel and kNN planes, delta appends,
    tombstones and doc-value columns) immediately before its transfer
    group, inside the site's retry loop, so a retried attempt consults
    the schemes again."""
    if not _SEARCH_SCHEMES:
        return
    for scheme in list(_SEARCH_SCHEMES):
        if scheme.indices is None or index in scheme.indices:
            scheme.on_staging(index, kind, table)


class StagingFailScheme(ShardSearchScheme):
    """A device staging boundary faults: the Nth matching staging raises,
    selected by ledger kind and by error class.

    ``kinds``: the ledger kinds to match (``postings`` matches both
    ``postings_raw`` and ``postings_packed``); None = any.
    ``nth``: skip the first nth-1 matching calls.
    ``times``: raise on at most this many calls, then go inert (None =
    every matching call while installed).
    ``transient``: raise :class:`TransientDeviceError` (retried); False
    raises ``ValueError`` (deterministic: the plane demotes and is
    quarantined at once, never retried)."""

    def __init__(self, kinds=None, nth: int = 1,
                 times: Optional[int] = None, transient: bool = True,
                 **filters):
        super().__init__(**filters)
        self.kinds = set(kinds) if kinds else None
        self.nth = max(1, int(nth))
        self.times = times
        self.transient = bool(transient)
        self.calls = 0
        self._lock = threading.Lock()

    def _kind_matches(self, kind: str) -> bool:
        if self.kinds is None:
            return True
        return kind in self.kinds or (
            "postings" in self.kinds and kind.startswith("postings"))

    def on_staging(self, index, kind, table) -> None:
        if not self._kind_matches(kind):
            return
        with self._lock:
            self.calls += 1
            if self.calls < self.nth:
                return
            if self.times is not None and self.hits >= self.times:
                return
            self.hits += 1
        if self.transient:
            from elasticsearch_tpu_torch.common.staging import (
                TransientDeviceError,
            )

            raise TransientDeviceError(
                f"[{index}] CUDA out of memory staging [{kind}/{table}] "
                f"(injected transient)")
        raise ValueError(
            f"[{index}] shape error staging [{kind}/{table}] "
            f"(injected deterministic)")


class SearchDelayScheme(ShardSearchScheme):
    """Every matching shard query phase stalls ``seconds`` before it runs:
    the straggler shard that drives a ``timeout`` deterministically (its
    first segment checkpoint finds the deadline expired)."""

    def __init__(self, seconds: float, **filters):
        super().__init__(**filters)
        self.seconds = float(seconds)

    def on_search(self, index, shard_id) -> None:
        import time

        self.hits += 1
        time.sleep(self.seconds)


class SearchFailScheme(ShardSearchScheme):
    """Every matching shard query phase raises: a ``_shards.failures``
    entry with ``_shards.failed``, never a 500, unless
    ``allow_partial_search_results`` is false or every shard fails."""

    def __init__(self, exception: Optional[Exception] = None, **filters):
        super().__init__(**filters)
        self.exception = exception

    def on_search(self, index, shard_id) -> None:
        self.hits += 1
        if self.exception is not None:
            raise self.exception
        raise RuntimeError(
            f"[{index}][{shard_id}] query phase failed (injected)")


class MeshPlaneDelayScheme(ShardSearchScheme):
    """Every matching mesh plane attempt stalls ``seconds`` before its
    deadline checkpoint: a request held on the mesh plane, so a cancel
    (or a deadline) lands on that checkpoint before any launch."""

    def __init__(self, seconds: float, **filters):
        super().__init__(**filters)
        self.seconds = float(seconds)

    def on_plane(self, index, plane) -> None:
        import time

        self.hits += 1
        time.sleep(self.seconds)


class PlaneFailScheme(ShardSearchScheme):
    """A plane of the mesh ladder raises on use (``planes``:
    ``mesh_pallas``, ``mesh``), as a device fault would: it drives the
    plane-health quarantine."""

    def __init__(self, planes: Sequence[str] = ("mesh_pallas",), **filters):
        super().__init__(**filters)
        self.planes = set(planes)

    def on_plane(self, index, plane) -> None:
        if plane in self.planes:
            self.hits += 1
            raise RuntimeError(
                f"[{index}] plane [{plane}] fault (injected)")


class KernelLaunchFailScheme(ShardSearchScheme):
    """A launch of the mesh plane faults, per rung: ``mesh_pallas`` (the
    serial kernel plane), ``mesh`` (scatter), ``batched``, ``pruned``,
    ``knn``. A kernel rung raises ``KernelError``, as a hand-written
    kernel that fails to launch does: it reaches the caller and no rung
    serves in the kernel's place. ``mesh`` launches plain PyTorch and
    raises a plane fault (the ladder quarantines it and serves from the
    next rung). ``times``: at most this many raises, then inert (None:
    every matching launch while installed)."""

    KERNEL_RUNGS = frozenset({"mesh_pallas", "batched", "pruned", "knn"})

    def __init__(self, rungs: Sequence[str] = ("mesh_pallas",),
                 times: Optional[int] = None, **filters):
        super().__init__(**filters)
        self.rungs = set(rungs)
        self.times = times
        self._lock = threading.Lock()

    def on_launch(self, index, rung) -> None:
        if rung not in self.rungs:
            return
        with self._lock:
            if self.times is not None and self.hits >= self.times:
                return
            self.hits += 1
        msg = f"[{index}] kernel launch [{rung}] fault (injected)"
        if rung in self.KERNEL_RUNGS:
            raise KernelError(msg)
        raise RuntimeError(msg)


class EvictionStormScheme(ShardSearchScheme):
    """Force the device-memory ledger's LRU evictor under query load:
    every ``period``-th matching search dispatch evicts the ``scopes``
    coldest evictable staging scopes, driving the restage paths (lazy
    restage, ``probe`` lifecycle events) without a byte budget."""

    def __init__(self, period: int = 1, scopes: int = 1, **filters):
        super().__init__(**filters)
        self.period = max(1, int(period))
        self.scopes = max(1, int(scopes))
        self.evicted_bytes = 0
        self.calls = 0
        self._lock = threading.Lock()

    def on_query(self, index) -> None:
        with self._lock:
            self.calls += 1
            if self.calls % self.period:
                return
            self.hits += 1
        from elasticsearch_tpu_torch.common.memory import memory_accountant

        freed = memory_accountant().force_evict(self.scopes)
        with self._lock:
            self.evicted_bytes += freed


class QueuePressureScheme(ShardSearchScheme):
    """Synthetic pressure on search admission, consulted by
    ``SearchAdmissionController`` at every acquire and release.

    ``occupancy``: synthetic queued entries: they raise the queue
    pressure (the brownout ladder) and count toward the overflow check,
    so ``occupancy >= search.queue.size`` turns every arrival that finds
    no free slot into a 429.
    ``block_slots``: concurrency slots withheld from
    ``max_concurrent``: arrivals queue (and drain by DRR) as if that
    much capacity were busy elsewhere.
    ``drain_delay_s``: added to every release, slowing the observed
    drain rate (a longer Retry-After)."""

    def __init__(self, occupancy: int = 0, block_slots: int = 0,
                 drain_delay_s: float = 0.0, **filters):
        super().__init__(**filters)
        self.occupancy = max(0, int(occupancy))
        self.block_slots = max(0, int(block_slots))
        self.drain_delay_s = float(drain_delay_s)


def queue_pressure(index: str, count_hit: bool = True):
    """(occupancy, blocked_slots, drain_delay_s) over the installed
    matching ``QueuePressureScheme``s. ``count_hit``: an acquire's
    consult counts as a hit; bookkeeping consults do not."""
    if not _SEARCH_SCHEMES:
        return 0, 0, 0.0
    occ = blocked = 0
    delay = 0.0
    for scheme in list(_SEARCH_SCHEMES):
        if not isinstance(scheme, QueuePressureScheme):
            continue
        if scheme.indices is not None and index not in scheme.indices:
            continue
        if count_hit:
            scheme.hits += 1
        occ += scheme.occupancy
        blocked += scheme.block_slots
        delay = max(delay, scheme.drain_delay_s)
    return occ, blocked, delay


class StoreCorruptionScheme:
    """Deterministic at-rest or in-flight store corruption; every
    injection is logged in ``corrupted`` (each must be detected).

    Kinds: ``bitflip`` (one bit of one byte of a checksummed file,
    ``target`` or ``arrays.npz``), ``truncate`` (the last byte of a
    file cut), ``torn_checksums`` (``checksums.json`` cut mid-JSON),
    ``missing_checksums`` (``checksums.json`` deleted).
    ``corrupt_store(store)`` corrupts one committed segment (the newest
    by default), ``corrupt_segment(dir)`` one segment directory; ``seed``
    makes the file, byte and bit reproducible.

    In flight: ``apply_to(hub)`` with ``source_node`` (the recovery
    source's ``ClusterNode``) flips one bit of a file in the source's
    open recovery sessions at a file-chunk delivery to it, after the
    manifest's digests were taken, ``times`` times; the target's install
    verification must catch it and the retried session heals."""

    KINDS = ("bitflip", "truncate", "torn_checksums", "missing_checksums")

    def __init__(self, kind: str = "bitflip",
                 target: Optional[str] = None,
                 seed: Optional[int] = None,
                 source_node=None, times: int = 1):
        if kind not in self.KINDS:
            raise ValueError(f"unknown corruption kind [{kind}]")
        self.kind = kind
        self.target = target
        self.source_node = source_node
        self.times = max(1, int(times))
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.hub = None
        self.hits = 0
        self.corrupted: list = []  # (path, description) per injection

    def corrupt_segment(self, seg_dir: str) -> str:
        """Corrupt one file of a sealed segment directory; returns its
        path."""
        import json as _json
        import os

        sums_path = os.path.join(seg_dir, "checksums.json")
        if self.kind == "missing_checksums":
            os.remove(sums_path)
            self._log(sums_path, "deleted checksums.json")
            return sums_path
        if self.kind == "torn_checksums":
            size = os.path.getsize(sums_path)
            with open(sums_path, "r+b") as f:
                f.truncate(max(1, size // 2))  # a tear mid-JSON
            self._log(sums_path, "tore checksums.json")
            return sums_path
        with open(sums_path, encoding="utf-8") as f:
            names = sorted(_json.load(f))
        if not names:
            raise ValueError(f"segment [{seg_dir}] has no checksummed files")
        if self.target is not None:
            if self.target not in names:
                raise ValueError(
                    f"target [{self.target}] not checksummed in [{seg_dir}]")
            name = self.target
        else:
            name = ("arrays.npz" if "arrays.npz" in names
                    else self._rng.choice(names))
        path = os.path.join(seg_dir, name)
        if self.kind == "truncate":
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(0, size - 1))
            self._log(path, "truncated 1 byte")
            return path
        size = os.path.getsize(path)
        offset = self._rng.randrange(max(1, size))
        bit = 1 << self._rng.randrange(8)
        with open(path, "r+b") as f:
            f.seek(offset)
            byte = f.read(1)
            f.seek(offset)
            f.write(bytes([byte[0] ^ bit]))
        self._log(path, f"flipped bit {bit:#04x} at offset {offset}")
        return path

    def corrupt_store(self, store, segment: Optional[str] = None) -> str:
        """Corrupt one committed segment of ``store`` (the newest by
        default)."""
        commit = store.read_commit() or {}
        names = [s["name"] if isinstance(s, dict) else s
                 for s in commit.get("segments", [])]
        if not names:
            raise ValueError("store has no committed segments to corrupt")
        name = segment if segment is not None else names[-1]
        return self.corrupt_segment(store._seg_dir(name))

    def _log(self, path: str, what: str) -> None:
        with self._lock:
            self.hits += 1
            self.corrupted.append((path, f"{self.kind}: {what}"))

    # --- in flight (the peer-recovery file stream) ---------------------
    #
    # The hub's scheme protocol (apply_to / applies / disrupt), duck-typed:
    # the effect mutates the source's session bytes, it fails no delivery

    def apply_to(self, hub) -> "StoreCorruptionScheme":
        if self.source_node is None:
            raise ValueError(
                "in-flight corruption needs source_node (the recovery "
                "source's ClusterNode)")
        hub.add_disruption(self)
        self.hub = hub
        return self

    def remove(self) -> None:
        if self.hub is not None:
            self.hub.remove_disruption(self)
            self.hub = None

    def applies(self, src: str, dst: str, action: str) -> bool:
        return (self.source_node is not None
                and action == "internal:index/shard/recovery/files/chunk"
                and dst == self.source_node.node_id)

    def disrupt(self, src: str, dst: str, action: str) -> None:
        """Flip one bit of one file in every open recovery session on the
        source (its digests already in the manifest), ``times``
        deliveries; then inert (the retried session re-reads clean
        disk)."""
        with self._lock:
            if self.hits >= self.times:
                return
            sessions = getattr(self.source_node, "_recovery_sessions", {})
            for sess in list(sessions.values()):
                files = sess.get("files", {})
                rel = next((r for r in sorted(files) if files[r]), None)
                if rel is None:
                    continue
                data = files[rel]
                offset = self._rng.randrange(len(data))
                bit = 1 << self._rng.randrange(8)
                files[rel] = (data[:offset] + bytes([data[offset] ^ bit])
                              + data[offset + 1:])
                self.hits += 1
                self.corrupted.append(
                    (rel, f"in-flight bitflip at offset {offset}"))
                break
