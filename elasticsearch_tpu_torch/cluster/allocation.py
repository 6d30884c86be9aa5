"""Shard allocation: assign primaries and replicas to data nodes.

Counterpart of ``elasticsearch_tpu/cluster/allocation.py``, copied but
for its imports. Role model: ``AllocationService`` + ``BalancedShardsAllocator`` + deciders
(cluster/routing/allocation/). Deciders implemented:
SameShardAllocationDecider (a replica never lands on its primary's node),
balance-by-count, ``DiskThresholdDecider`` (low watermark blocks new
allocations, high watermark moves replicas off — fed by per-node disk
usage, the ``ClusterInfoService``/``DiskThresholdMonitor`` analog), and
``AwarenessAllocationDecider`` (spread copies across configured node
attribute values, e.g. zones). Assignments are sticky: existing placements
survive reroutes while their node is alive (the reference's "prefer
existing allocation").
"""

from __future__ import annotations

from typing import Dict, List, Optional

from elasticsearch_tpu_torch.cluster.state import ShardRouting, ShardRoutingState

# routing table shape: {index: {shard_id: [ShardRouting, ...]}} — first
# entry with primary=True is the primary copy.
RoutingTable = Dict[str, Dict[int, List[ShardRouting]]]


def _node_load(table: RoutingTable) -> Dict[str, int]:
    load: Dict[str, int] = {}
    for shards in table.values():
        for copies in shards.values():
            for c in copies:
                if c.node_id is not None:
                    load[c.node_id] = load.get(c.node_id, 0) + 1
    return load


def _least_loaded(candidates: List[str], load: Dict[str, int]) -> Optional[str]:
    if not candidates:
        return None
    return min(candidates, key=lambda n: (load.get(n, 0), n))


# DiskThresholdDecider defaults (cluster.routing.allocation.disk.watermark.*)
WATERMARK_LOW = 0.85
WATERMARK_HIGH = 0.90


def _pick_node(candidates: List[str], load: Dict[str, int],
               existing_copies: List[ShardRouting],
               node_info: Optional[Dict[str, dict]],
               awareness_attributes: Optional[List[str]],
               watermark_low: float) -> Optional[str]:
    """Decider chain for one unassigned copy: disk low-watermark filter,
    awareness-attribute preference, then least-loaded."""
    if node_info:
        ok = [n for n in candidates
              if (node_info.get(n, {}).get("disk") or 0.0) < watermark_low]
        if ok:
            candidates = ok  # else: ignore the watermark rather than leave
            # the copy unassigned? No — the reference leaves it unassigned.
        else:
            return None
    if not candidates:
        return None
    if awareness_attributes and node_info:
        def attr_penalty(n: str) -> int:
            # count existing copies sharing any awareness value with n
            my = node_info.get(n, {}).get("attrs") or {}
            penalty = 0
            for attr in awareness_attributes:
                mine = my.get(attr)
                if mine is None:
                    continue
                for c in existing_copies:
                    other = (node_info.get(c.node_id, {}).get("attrs") or {})
                    if other.get(attr) == mine:
                        penalty += 1
            return penalty

        penalties = {n: attr_penalty(n) for n in candidates}
        best_penalty = min(penalties.values())
        candidates = [n for n in candidates if penalties[n] == best_penalty]
    return _least_loaded(candidates, load)


def allocate(indices_meta: Dict, data_nodes: List[str],
             previous: Optional[RoutingTable] = None,
             node_info: Optional[Dict[str, dict]] = None,
             awareness_attributes: Optional[List[str]] = None,
             watermark_low: float = WATERMARK_LOW,
             watermark_high: float = WATERMARK_HIGH,
             no_fresh_primary: Optional[set] = None) -> RoutingTable:
    """Compute the routing table for the current node set.

    indices_meta: {name: IndexMetadata}. Copies on departed nodes are
    dropped; a surviving replica is promoted when its primary is gone
    (primary promotion — ShardStateAction/failShard path, SURVEY §5.3);
    unassigned copies fill onto the least-loaded eligible node.
    node_info: {node_id: {"attrs": {...}, "disk": used_fraction}} — feeds
    the disk-threshold + awareness deciders.
    no_fresh_primary: (index, sid) keys that must NEVER receive a fresh
    empty primary (the corruption quarantine: the shard HAD data —
    its last copy is corrupt-retained — so filling an empty primary
    would be silent data-loss resurrection; the shard stays red until a
    verified copy returns via snapshot restore or marker repair).
    """
    no_fresh_primary = no_fresh_primary or set()
    previous = previous or {}
    alive = set(data_nodes)
    # DiskThresholdMonitor: nodes above the high watermark shed replicas —
    # but only onto an eligible target (a healthy in-sync copy is never
    # discarded without a replacement)
    hot = set()
    if node_info:
        hot = {n for n in alive
               if (node_info.get(n, {}).get("disk") or 0.0) >= watermark_high}
    table: RoutingTable = {}
    for name, md in indices_meta.items():
        if md.state != "open":
            table[name] = {}
            continue
        shards: Dict[int, List[ShardRouting]] = {}
        prev_shards = previous.get(name, {})
        for sid in range(md.num_shards):
            all_prev = prev_shards.get(sid, [])
            prev_copies = [c for c in all_prev if c.node_id in alive]
            primaries = [c for c in prev_copies if c.primary]
            primary = primaries[0] if primaries else None
            # a relocating primary's target carries primary=True too —
            # it must survive the rebuild alongside the source
            extra_primaries = primaries[1:]
            replicas = [c for c in prev_copies if not c.primary]
            if primary is None and all_prev:
                # promote a STARTED replica only (the in-sync set
                # analog): an INITIALIZING survivor may hold a partial
                # recovery — promoting it would serve stale data
                # silently; the reference refuses via in-sync allocation
                # ids
                started = [r for r in replicas
                           if r.state == ShardRoutingState.STARTED]
                if started:
                    promo = started[0]
                    replicas.remove(promo)
                    promo.primary = True
                    primary = promo
                else:
                    # no in-sync survivor: RETAIN the departed primary
                    # copy in the table. The shard stays red (the fill
                    # below sees a primary and will not allocate a fresh
                    # empty one over lost data), and if the node comes
                    # back its copy resumes with its data — the
                    # reference's delayed-allocation / node-rejoin path
                    primary = next(
                        (c for c in all_prev
                         if c.primary and c.node_id not in alive), None)
            copies: List[ShardRouting] = []
            if primary is not None:
                copies.append(primary)
            copies.extend(extra_primaries)
            copies.extend(replicas)
            shards[sid] = copies
        table[name] = shards

    # retire completed relocations: a RELOCATING source whose LINKED
    # target (relocating_to) has STARTED hands off and leaves the table
    # (the reference's relocation completion). The explicit link matters:
    # with 2+ replicas, some other started same-role peer must not
    # retire a source whose own target is still recovering.
    for name, shards in table.items():
        for copies in shards.values():
            for c in list(copies):
                if c.state != ShardRoutingState.RELOCATING:
                    continue
                target = next(
                    (o for o in copies
                     if o is not c and o.node_id == c.relocating_to), None)
                if target is None:
                    # target vanished (node left / cancelled): resume as
                    # a normal started copy
                    c.state = ShardRoutingState.STARTED
                    c.relocating_to = None
                elif target.state == ShardRoutingState.STARTED:
                    copies.remove(c)

    load = _node_load(table)
    # fill unassigned primaries first, then replicas
    for name, md in indices_meta.items():
        if md.state != "open":
            continue
        for sid in range(md.num_shards):
            copies = table[name][sid]
            if not any(c.primary for c in copies):
                if (name, sid) in no_fresh_primary:
                    # corrupt-retained last copy: the shard
                    # had data — an empty primary here would resurrect
                    # the index over lost bytes. Stays red/unassigned.
                    continue
                # reached only when the shard never had copies (fresh
                # index / previously unplaceable): a shard that LOST its
                # data keeps its departed primary routed above, so it
                # stays red instead of restarting empty
                node = _pick_node(list(alive), load, copies, node_info,
                                  awareness_attributes, watermark_low)
                if node is not None:
                    copies.insert(0, ShardRouting(
                        name, sid, node, True, ShardRoutingState.INITIALIZING
                    ))
                    load[node] = load.get(node, 0) + 1
    for name, md in indices_meta.items():
        if md.state != "open":
            continue
        for sid in range(md.num_shards):
            copies = table[name][sid]
            while len(copies) < 1 + md.num_replicas:
                used = {c.node_id for c in copies}
                candidates = [n for n in alive if n not in used]
                node = _pick_node(candidates, load, copies, node_info,
                                  awareness_attributes, watermark_low)
                if node is None:
                    break  # not enough nodes — stays unassigned (yellow)
                copies.append(ShardRouting(
                    name, sid, node, False, ShardRoutingState.INITIALIZING
                ))
                load[node] = load.get(node, 0) + 1
    if hot:
        _relocate_hot_replicas(table, alive, load, node_info,
                               awareness_attributes, watermark_low, hot,
                               indices_meta)
    # cancel surplus relocation targets whose reason went away (the hot
    # source cooled down before the replacement finished)
    for name, md in indices_meta.items():
        if md.state != "open":
            continue
        desired = 1 + md.num_replicas
        for copies in table[name].values():
            if len(copies) <= desired:
                continue
            awaiting = any(c.node_id in hot and not c.primary for c in copies)
            if awaiting:
                continue  # relocation in progress: keep source + target
            if any(c.state == ShardRoutingState.RELOCATING for c in copies):
                # an explicit move in progress (reroute command): the
                # source+target pair intentionally exceeds the desired
                # copy count until the handoff retires the source
                continue
            for c in list(copies):
                if len(copies) <= desired:
                    break
                if not c.primary and c.state == ShardRoutingState.INITIALIZING:
                    copies.remove(c)
                    load[c.node_id] = load.get(c.node_id, 1) - 1
    _rebalance_replicas(table, alive, load, node_info, awareness_attributes,
                        watermark_low)
    return table


def _relocate_hot_replicas(table: RoutingTable, alive: set,
                           load: Dict[str, int], node_info, awareness,
                           watermark_low: float, hot: set,
                           indices_meta: Dict) -> None:
    """Move replicas off high-watermark nodes when (and only when) a
    target under the low watermark exists. A STARTED (data-bearing) source
    stays until its replacement has started — relocation keeps both copies
    live like the reference's RELOCATING state; only empty INITIALIZING
    copies move directly."""
    for index, shards in table.items():
        desired_replicas = indices_meta[index].num_replicas
        for copies in shards.values():
            # phase 1: a replacement started — retire the hot source
            healthy_started = [c for c in copies
                               if not c.primary
                               and c.state == ShardRoutingState.STARTED
                               and c.node_id not in hot]
            for c in list(copies):
                if (not c.primary and c.node_id in hot
                        and len(healthy_started) >= desired_replicas):
                    copies.remove(c)
                    load[c.node_id] = load.get(c.node_id, 1) - 1
            # phase 2: spawn replacements / move empty copies
            for copy in list(copies):
                if copy.primary or copy.node_id not in hot:
                    continue
                used = {c.node_id for c in copies if c is not copy}
                candidates = [n for n in alive if n not in used]
                target = _pick_node(candidates, load,
                                    [c for c in copies if c is not copy],
                                    node_info, awareness, watermark_low)
                if target is None or target == copy.node_id:
                    continue
                if copy.state == ShardRoutingState.INITIALIZING:
                    # empty copy: move it outright
                    load[copy.node_id] = load.get(copy.node_id, 1) - 1
                    load[target] = load.get(target, 0) + 1
                    copy.node_id = target
                else:
                    # data-bearing copy: add the target alongside; the
                    # source retires on a later reroute once it starts
                    copies.append(ShardRouting(
                        copy.index, copy.shard_id, target, False,
                        ShardRoutingState.INITIALIZING))
                    load[target] = load.get(target, 0) + 1


def _rebalance_replicas(table: RoutingTable, alive: set,
                        load: Dict[str, int],
                        node_info: Optional[Dict[str, dict]] = None,
                        awareness_attributes: Optional[List[str]] = None,
                        watermark_low: float = WATERMARK_LOW) -> None:
    """Move freshly-assigned (INITIALIZING) replicas off overloaded nodes —
    the greedy fill can pile ties onto one node (BalancedShardsAllocator's
    balancing step). Started replicas are never moved here (moving them
    costs a recovery; rebalancing of started copies is a later round)."""
    improved = True
    while improved:
        improved = False
        for shards in table.values():
            for copies in shards.values():
                if any(c.state == ShardRoutingState.RELOCATING
                       for c in copies):
                    continue  # don't shuffle an explicit move's target
                for copy in copies:
                    if copy.primary or copy.state != ShardRoutingState.INITIALIZING:
                        continue
                    used = {c.node_id for c in copies if c is not copy}
                    candidates = [n for n in alive if n not in used]
                    best = _pick_node(candidates, load,
                                      [c for c in copies if c is not copy],
                                      node_info, awareness_attributes,
                                      watermark_low)
                    if best is not None and copy.node_id is not None and \
                            load.get(best, 0) + 1 < load.get(copy.node_id, 0):
                        load[copy.node_id] -= 1
                        load[best] = load.get(best, 0) + 1
                        copy.node_id = best
                        improved = True


# ---------------------------------------------------------------------------
# Reroute commands (cluster/routing/allocation/command/*.java)
# ---------------------------------------------------------------------------


class RerouteException(Exception):
    """A reroute command failed validation (illegal_argument shape)."""


def _find_copies(table: RoutingTable, index: str, shard: int,
                 cmd: str) -> List[ShardRouting]:
    if index not in table:
        raise RerouteException(f"[{cmd}] no such index [{index}]")
    if shard not in table[index]:
        raise RerouteException(f"[{cmd}] no such shard [{index}][{shard}]")
    return table[index][shard]


def apply_command(table: RoutingTable, indices_meta: Dict,
                  node_ids: Dict[str, str], name: str, args: dict) -> dict:
    """Apply ONE reroute command in place; returns its explanation entry.

    node_ids: {accepted name or id -> node_id} for node resolution.
    Commands (AllocationCommands.registerFactory set, 6.x):
    move, cancel, allocate_replica, allocate_empty_primary,
    allocate_stale_primary.
    """
    def node_of(key: str, value) -> str:
        nid = node_ids.get(str(value))
        if nid is None:
            raise RerouteException(
                f"[{name}] no node found for [{key}] = [{value}]")
        return nid

    index = str(args.get("index", ""))
    shard = int(args.get("shard", -1))
    copies = _find_copies(table, index, shard, name)
    decisions = []
    if name == "move":
        src = node_of("from_node", args.get("from_node"))
        dst = node_of("to_node", args.get("to_node"))
        copy = next((c for c in copies if c.node_id == src), None)
        if copy is None:
            raise RerouteException(
                f"[move] shard [{index}][{shard}] not found on node [{src}]")
        if copy.state != ShardRoutingState.STARTED:
            raise RerouteException(
                f"[move] shard [{index}][{shard}] on node [{src}] is "
                f"[{copy.state}]; only STARTED shards can be moved")
        if any(c.node_id == dst for c in copies):
            raise RerouteException(
                f"[move] a copy of [{index}][{shard}] already exists on "
                f"node [{dst}] (SameShardAllocationDecider)")
        # RELOCATING source + INITIALIZING target, like the reference;
        # a later reroute retires the source once ITS target starts (the
        # explicit relocating_to link — matching any started same-role
        # peer would drop a healthy source while the target still
        # recovers). The target inherits the source's primary flag
        # (MoveAllocationCommand relocates the primary AS a primary —
        # otherwise retiring the source would leave no primary copy)
        copy.state = ShardRoutingState.RELOCATING
        copy.relocating_to = dst
        copies.append(ShardRouting(index, shard, dst, copy.primary,
                                   ShardRoutingState.INITIALIZING))
        decisions.append({"decider": "same_shard", "decision": "YES",
                          "explanation": f"moving to [{dst}]"})
    elif name == "cancel":
        nid = node_of("node", args.get("node"))
        copy = next((c for c in copies if c.node_id == nid), None)
        if copy is None:
            raise RerouteException(
                f"[cancel] shard [{index}][{shard}] not found on node "
                f"[{nid}]")
        if copy.primary and not args.get("allow_primary", False):
            raise RerouteException(
                f"[cancel] can't cancel [{index}][{shard}] on node "
                f"[{nid}], shard is primary and allow_primary is false")
        copies.remove(copy)
        decisions.append({"decider": "cancel", "decision": "YES",
                          "explanation": f"cancelled on [{nid}]"})
    elif name == "allocate_replica":
        nid = node_of("node", args.get("node"))
        if not any(c.primary for c in copies):
            raise RerouteException(
                f"[allocate_replica] trying to allocate a replica shard "
                f"[{index}][{shard}], while corresponding primary shard "
                f"is still unassigned")
        if any(c.node_id == nid for c in copies):
            raise RerouteException(
                f"[allocate_replica] a copy of [{index}][{shard}] already "
                f"exists on node [{nid}]")
        md = indices_meta.get(index)
        assigned_replicas = sum(1 for c in copies if not c.primary)
        if md is not None and assigned_replicas >= md.num_replicas:
            raise RerouteException(
                f"[allocate_replica] all replica copies of "
                f"[{index}][{shard}] are already assigned")
        copies.append(ShardRouting(index, shard, nid, False,
                                   ShardRoutingState.INITIALIZING))
        decisions.append({"decider": "replica_after_primary",
                          "decision": "YES",
                          "explanation": f"allocated replica on [{nid}]"})
    elif name in ("allocate_empty_primary", "allocate_stale_primary"):
        nid = node_of("node", args.get("node"))
        if not args.get("accept_data_loss", False):
            raise RerouteException(
                f"[{name}] allocating an empty primary for "
                f"[{index}][{shard}] can result in data loss; please "
                f"confirm by setting the accept_data_loss parameter to "
                f"true")
        live = next((c for c in copies
                     if c.primary and c.state == ShardRoutingState.STARTED),
                    None)
        if live is not None:
            raise RerouteException(
                f"[{name}] primary [{index}][{shard}] is already assigned")
        # drop any retained dead-primary routing and start over on nid
        for c in list(copies):
            if c.primary:
                copies.remove(c)
        copies.insert(0, ShardRouting(index, shard, nid, True,
                                      ShardRoutingState.INITIALIZING))
        decisions.append({"decider": "force_primary", "decision": "YES",
                          "explanation": f"forced primary on [{nid}] "
                                         f"(accept_data_loss)"})
    else:
        raise RerouteException(f"unknown reroute command [{name}]")
    return {"command": name, "parameters": dict(args),
            "decisions": decisions}


def routing_to_dict(table: RoutingTable) -> dict:
    return {
        name: {
            str(sid): [c.to_dict() for c in copies]
            for sid, copies in shards.items()
        }
        for name, shards in table.items()
    }


def routing_from_dict(d: dict) -> RoutingTable:
    out: RoutingTable = {}
    for name, shards in d.items():
        out[name] = {}
        for sid, copies in shards.items():
            out[name][int(sid)] = [
                ShardRouting(c["index"], c["shard"], c["node"], c["primary"],
                             c["state"],
                             relocating_to=c.get("relocating_node"))
                for c in copies
            ]
    return out
