"""Cluster state: a snapshot of the metadata and the routing.

Counterpart of ``elasticsearch_tpu/cluster/state.py``, copied but for its
imports: ``ClusterState`` holds each index's ``IndexMetadata`` (settings,
mapping, aliases, open or closed, version, creation date), the index
templates, the persistent and transient cluster settings, the stored
scripts, and the global metadata the port keeps without serving it yet
(ingest pipelines, snapshot repositories); ``resolve_index_names``
resolves names, aliases, wildcards over names and aliases, comma lists
and ``_all``. State changes go through
``ClusterService.submit_state_update_task`` (one task at a time under a
lock; appliers see the old and the new state, listeners the new). One
node is always its own master; ``routing_table`` puts every primary on
it, and ``routing`` (set by ``_cluster/reroute``) overlays it per index.
The multi-node cluster (``multinode.py``) keeps its own routing table of
``ShardRouting`` copies in ``ShardRoutingState``s.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import IndexNotFoundException
from elasticsearch_tpu_torch.common.settings import Settings


class ShardRoutingState:
    UNASSIGNED = "UNASSIGNED"
    INITIALIZING = "INITIALIZING"
    STARTED = "STARTED"
    RELOCATING = "RELOCATING"


@dataclass
class ShardRouting:
    index: str
    shard_id: int
    node_id: Optional[str]
    primary: bool
    state: str = ShardRoutingState.STARTED
    # the explicit relocation link (a RELOCATING source -> its target
    # node): the allocator retires the source only once THIS target has
    # started (ShardRouting.relocatingNodeId)
    relocating_to: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "index": self.index,
            "shard": self.shard_id,
            "node": self.node_id,
            "primary": self.primary,
            "state": self.state,
        }
        if self.relocating_to is not None:
            d["relocating_node"] = self.relocating_to
        return d


@dataclass
class IndexMetadata:
    name: str
    settings: Settings
    mappings: dict
    aliases: Dict[str, dict] = field(default_factory=dict)
    state: str = "open"  # open | close
    creation_date: int = 0
    version: int = 1

    @property
    def num_shards(self) -> int:
        return self.settings.get_int("index.number_of_shards", 1)

    @property
    def num_replicas(self) -> int:
        return self.settings.get_int("index.number_of_replicas", 1)

    def to_dict(self) -> dict:
        return {
            "settings": self.settings.as_nested_dict(),
            "mappings": {"_doc": self.mappings},
            "aliases": self.aliases,
            "state": self.state,
        }


@dataclass
class DiscoveryNode:
    node_id: str
    name: str
    address: str
    roles: tuple = ("master", "data", "ingest")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "transport_address": self.address,
            "roles": list(self.roles),
        }


class ClusterState:
    """A snapshot: an update copies it (``copy``) and changes the copy."""

    def __init__(self, cluster_name: str, version: int = 0,
                 indices: Optional[Dict[str, IndexMetadata]] = None,
                 nodes: Optional[Dict[str, DiscoveryNode]] = None,
                 master_node_id: Optional[str] = None,
                 templates: Optional[Dict[str, dict]] = None,
                 persistent_settings: Optional[Settings] = None,
                 transient_settings: Optional[Settings] = None,
                 stored_scripts: Optional[Dict[str, dict]] = None,
                 ingest_pipelines: Optional[Dict[str, dict]] = None,
                 repositories: Optional[Dict[str, dict]] = None,
                 routing: Optional[dict] = None):
        self.cluster_name = cluster_name
        self.version = version
        self.indices = dict(indices or {})
        self.nodes = dict(nodes or {})
        self.master_node_id = master_node_id
        self.templates = dict(templates or {})
        self.persistent_settings = persistent_settings or Settings.EMPTY
        self.transient_settings = transient_settings or Settings.EMPTY
        self.stored_scripts = dict(stored_scripts or {})
        self.ingest_pipelines = dict(ingest_pipelines or {})
        self.repositories = dict(repositories or {})
        # the explicit routing table ({index: {shard_id: [ShardRouting]}})
        # that _cluster/reroute sets; None: every primary on the master
        self.routing = routing

    def copy(self, **overrides) -> "ClusterState":
        kw = dict(
            cluster_name=self.cluster_name,
            version=self.version + 1,
            indices=copy.deepcopy(self.indices),
            nodes=dict(self.nodes),
            master_node_id=self.master_node_id,
            templates=copy.deepcopy(self.templates),
            persistent_settings=self.persistent_settings,
            transient_settings=self.transient_settings,
            stored_scripts=dict(self.stored_scripts),
            ingest_pipelines=copy.deepcopy(self.ingest_pipelines),
            repositories=copy.deepcopy(self.repositories),
            routing=copy.deepcopy(self.routing),
        )
        kw.update(overrides)
        return ClusterState(**kw)

    def index_metadata(self, name: str) -> IndexMetadata:
        md = self.indices.get(name)
        if md is None:
            raise IndexNotFoundException(name)
        return md

    def resolve_index_names(self, expression: str) -> List[str]:
        """Index-name expression resolution: names, aliases, wildcards,
        comma lists, _all (cluster/metadata/IndexNameExpressionResolver)."""
        import fnmatch

        if expression in ("_all", "*", "", None):
            return sorted(self.indices)
        out: List[str] = []
        for part in str(expression).split(","):
            part = part.strip()
            if not part:
                continue
            matched = False
            if "*" in part:
                for name, md in sorted(self.indices.items()):
                    if fnmatch.fnmatchcase(name, part) or any(
                        fnmatch.fnmatchcase(a, part) for a in md.aliases
                    ):
                        out.append(name)
                        matched = True
            else:
                if part in self.indices:
                    out.append(part)
                    matched = True
                else:
                    for name, md in sorted(self.indices.items()):
                        if part in md.aliases:
                            out.append(name)
                            matched = True
            if not matched and "*" not in part:
                raise IndexNotFoundException(part)
        seen, uniq = set(), []
        for n in out:
            if n not in seen:
                seen.add(n)
                uniq.append(n)
        return uniq

    def routing_table(self) -> Dict[str, List[ShardRouting]]:
        table = {}
        for name, md in self.indices.items():
            shards = []
            for sid in range(md.num_shards):
                shards.append(ShardRouting(name, sid, self.master_node_id, True))
            table[name] = shards
        return table

    def _routing_table_dict(self) -> dict:
        """The routing table against the current metadata: the explicit
        table is a per-index overlay (an index created after the last
        reroute gets its default routing, a deleted one drops out)."""
        explicit = self.routing or {}
        out = {}
        for n, shards in self.routing_table().items():
            if n in explicit:
                out[n] = {"shards": {
                    str(sid): [c.to_dict() for c in copies]
                    for sid, copies in explicit[n].items()}}
            else:
                out[n] = {"shards": {str(s.shard_id): [s.to_dict()]
                                     for s in shards}}
        return out

    def to_dict(self) -> dict:
        return {
            "cluster_name": self.cluster_name,
            "version": self.version,
            "master_node": self.master_node_id,
            "nodes": {nid: n.to_dict() for nid, n in self.nodes.items()},
            "metadata": {
                "indices": {n: md.to_dict() for n, md in self.indices.items()},
                "templates": self.templates,
                "cluster_settings": {
                    "persistent": self.persistent_settings.as_nested_dict(),
                    "transient": self.transient_settings.as_nested_dict(),
                },
            },
            "routing_table": {"indices": self._routing_table_dict()},
        }


class ClusterService:
    """Single-threaded state-update queue + applier dispatch.

    submit_state_update_task(source, fn) where fn(state) -> new state;
    appliers/listeners run after each successful update (the two-phase
    publish degenerates to local apply on a single node)."""

    def __init__(self, initial_state: ClusterState):
        self._state = initial_state
        self._lock = threading.Lock()
        self._appliers: List[Callable[[ClusterState, ClusterState], None]] = []
        self._listeners: List[Callable[[ClusterState], None]] = []

    @property
    def state(self) -> ClusterState:
        return self._state

    def add_applier(self, applier: Callable[[ClusterState, ClusterState], None]) -> None:
        self._appliers.append(applier)

    def add_listener(self, listener: Callable[[ClusterState], None]) -> None:
        self._listeners.append(listener)

    def submit_state_update_task(self, source: str,
                                 update: Callable[[ClusterState], ClusterState]):
        """Runs the task under the master lock; appliers see old+new."""
        with self._lock:
            old = self._state
            new = update(old)
            if new is old:
                return old
            self._state = new
        for applier in self._appliers:
            applier(old, new)
        for listener in self._listeners:
            listener(new)
        return new


def cluster_health(state: ClusterState) -> dict:
    """_cluster/health (action/admin/cluster/health): single-node => all
    primaries active, replicas unassignable => yellow unless replicas=0."""
    n_shards = sum(md.num_shards for md in state.indices.values()
                   if md.state == "open")
    unassigned = sum(
        md.num_shards * md.num_replicas for md in state.indices.values()
        if md.state == "open"
    )
    status = "green" if unassigned == 0 else "yellow"
    total = n_shards + unassigned
    return {
        "cluster_name": state.cluster_name,
        "status": status,
        "timed_out": False,
        "number_of_nodes": len(state.nodes),
        "number_of_data_nodes": len(state.nodes),
        "active_primary_shards": n_shards,
        "active_shards": n_shards,
        "relocating_shards": 0,
        "initializing_shards": 0,
        "unassigned_shards": unassigned,
        "delayed_unassigned_shards": 0,
        "number_of_pending_tasks": 0,
        "number_of_in_flight_fetch": 0,
        "task_max_waiting_in_queue_millis": 0,
        "active_shards_percent_as_number": (
            100.0 * n_shards / total if total else 100.0
        ),
    }
