"""Allocation deciders and adaptive replica selection: the port against JAX.

``tests/test_allocation_ars.py`` case for case (disk watermarks,
awareness, the response collector, a search routed away from a slow
copy), then ``allocate`` and ``apply_command`` over 50 seeded random
clusters (nodes, zones, disk fractions, replicas, a departed node, a
reroute command): both packages' routing tables, explanations and errors
held equal.
"""

import numpy as np
import pytest

from torch_cluster_pair import (
    check_both,
    closing,
    routing_view,
)


def meta(P, name="idx", shards=2, replicas=1):
    return P.IndexMetadata(name, P.Settings({
        "index.number_of_shards": shards,
        "index.number_of_replicas": replicas}), {})


def nodes_of(table):
    return sorted({c[0] for shards in table.values()
                   for copies in shards.values() for c in copies})


def started(P, table):
    for shards in table.values():
        for copies in shards.values():
            for c in copies:
                c.state = P.ShardRoutingState.STARTED


class TestDiskThreshold:
    def test_low_watermark_blocks_new_allocations(self):
        def run(P):
            info = {"n1": {"attrs": {}, "disk": 0.2},
                    "n2": {"attrs": {}, "disk": 0.88}}
            return routing_view(P.allocate(
                {"idx": meta(P, shards=4, replicas=0)}, ["n1", "n2"],
                node_info=info))

        assert nodes_of(check_both(run, parallel=False)) == ["n1"]

    def test_no_eligible_node_leaves_unassigned(self):
        def run(P):
            info = {"n1": {"attrs": {}, "disk": 0.95}}
            return routing_view(P.allocate(
                {"idx": meta(P, shards=1, replicas=0)}, ["n1"],
                node_info=info))

        assert check_both(run, parallel=False)["idx"][0] == []

    def test_started_replica_kept_until_replacement_starts(self):
        def run(P):
            info = {f"n{i}": {"attrs": {}, "disk": 0.1} for i in range(1, 4)}
            m = {"idx": meta(P, shards=1, replicas=1)}
            nodes = ["n1", "n2", "n3"]
            table = P.allocate(m, nodes, node_info=info)
            started(P, table)
            replica_node = next(c.node_id for c in table["idx"][0]
                                if not c.primary)
            info[replica_node]["disk"] = 0.95
            t2 = P.allocate(m, nodes, previous=table, node_info=info)
            v2 = routing_view(t2)
            started(P, t2)
            t3 = P.allocate(m, nodes, previous=t2, node_info=info)
            return replica_node, v2, routing_view(t3)

        replica_node, v2, v3 = check_both(run, parallel=False)
        replicas = [c for c in v2["idx"][0] if not c[1]]
        assert len(replicas) == 2
        states = {c[0]: c[2] for c in replicas}
        assert states[replica_node] == "STARTED"
        target = next(n for n in states if n != replica_node)
        assert states[target] == "INITIALIZING"
        assert [c[0] for c in v3["idx"][0] if not c[1]] == [target]

    def test_high_watermark_moves_replicas_off(self):
        def run(P):
            info = {f"n{i}": {"attrs": {}, "disk": 0.1} for i in range(1, 4)}
            m = {"idx": meta(P, shards=1, replicas=1)}
            table = P.allocate(m, ["n1", "n2", "n3"], node_info=info)
            before = routing_view(table)
            replica = next(c for c in table["idx"][0] if not c.primary)
            info[replica.node_id]["disk"] = 0.95
            return before, routing_view(P.allocate(
                m, ["n1", "n2", "n3"], previous=table, node_info=info))

        before, after = check_both(run, parallel=False)
        old_replica = next(c[0] for c in before["idx"][0] if not c[1])
        new_replica = next(c[0] for c in after["idx"][0] if not c[1])
        assert new_replica != old_replica
        assert [c[0] for c in after["idx"][0] if c[1]] == \
            [c[0] for c in before["idx"][0] if c[1]]


class TestDiskThresholdNoTarget:
    def test_replica_kept_when_no_eligible_target(self):
        def run(P):
            info = {"n1": {"attrs": {}, "disk": 0.1},
                    "n2": {"attrs": {}, "disk": 0.1}}
            m = {"idx": meta(P, shards=1, replicas=1)}
            table = P.allocate(m, ["n1", "n2"], node_info=info)
            replica = next(c for c in table["idx"][0] if not c.primary)
            info[replica.node_id]["disk"] = 0.95
            return replica.node_id, routing_view(P.allocate(
                m, ["n1", "n2"], previous=table, node_info=info))

        replica, after = check_both(run, parallel=False)
        assert [c[0] for c in after["idx"][0] if not c[1]] == [replica]


class TestAwareness:
    def test_copies_spread_across_zones(self):
        def run(P):
            info = {n: {"attrs": {"zone": n[0]}, "disk": 0.0}
                    for n in ("a1", "a2", "b1", "b2")}
            return routing_view(P.allocate(
                {"idx": meta(P, shards=4, replicas=1)}, list(info),
                node_info=info, awareness_attributes=["zone"]))

        table = check_both(run, parallel=False)
        for copies in table["idx"].values():
            assert {c[0][0] for c in copies} == {"a", "b"}

    def test_awareness_in_cluster(self):
        def run(P):
            hub = P.TransportHub(strict_serialization=True)
            nodes = [P.node("za-1", hub, attrs={"zone": "a"},
                            awareness_attributes=["zone"]),
                     P.node("za-2", hub, attrs={"zone": "a"}),
                     P.node("zb-1", hub, attrs={"zone": "b"})]
            with closing(nodes):
                nodes[0].bootstrap_cluster()
                for n in nodes[1:]:
                    n.join("za-1")
                nodes[0].create_index("idx", {"index": {
                    "number_of_shards": 2, "number_of_replicas": 1}})
                return {sid: sorted(nodes[0].node_info_map[c.node_id]
                                    ["attrs"]["zone"] for c in copies)
                        for sid, copies in nodes[0].routing["idx"].items()}

        for zones in check_both(run).values():
            assert zones == ["a", "b"]


class TestAdaptiveReplicaSelection:
    def test_collector_ranks_by_ewma(self):
        def run(P):
            rc = P.ResponseCollectorService()
            rc.add_response_time("fast", 0.001)
            rc.add_response_time("slow", 0.5)
            out = [rc.rank("fast"), rc.rank("slow"), rc.rank("unknown")]
            for _ in range(30):
                rc.add_response_time("slow", 0.0001)
            return out + [rc.rank("slow"), rc.stats()]

        fast, slow, unknown, slow_after, _ = check_both(run, parallel=False)
        assert fast < slow and unknown == 0.0 and slow_after < 0.01

    def test_order_copies_prefers_faster_node(self):
        def run(P):
            rc = P.ResponseCollectorService()
            rc.add_response_time("n1", 0.5)
            rc.add_response_time("n2", 0.001)
            copies = [P.ShardRouting("i", 0, "n1", True,
                                     P.ShardRoutingState.STARTED),
                      P.ShardRouting("i", 0, "n2", False,
                                     P.ShardRoutingState.STARTED)]
            return [c.node_id for c in rc.order_copies(copies)]

        assert check_both(run, parallel=False)[0] == "n2"

    def test_search_routes_away_from_slow_copy(self):
        def run(P):
            hub = P.TransportHub(strict_serialization=True)
            nodes = [P.node(f"n{i}", hub) for i in range(2)]
            with closing(nodes):
                nodes[0].bootstrap_cluster()
                nodes[1].join("n0")
                nodes[0].create_index("idx", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 1}})
                client = P.ClusterClient(nodes[0])
                client.index("idx", "1", {"a": 1})
                client.refresh("idx")
                primary = next(n.node_id for n in nodes
                               if n.shards[("idx", 0)].primary)
                other = next(n.node_id for n in nodes if n.node_id != primary)
                client.response_collector.add_response_time(primary, 1.0)
                client.response_collector.add_response_time(other, 0.001)
                hub.requests_log.clear()
                r = client.search("idx", {"query": {"match_all": {}}})
                targets = [dst for (_s, dst, a) in hub.requests_log
                           if "search" in a]
                return r["hits"]["total"], targets, [other]

        total, targets, other = check_both(run)
        assert total == 1 and targets == other


# ---------------------------------------------------------------------------
# 50 seeded random clusters
# ---------------------------------------------------------------------------

COMMANDS = ("move", "cancel", "allocate_replica", "allocate_empty_primary")


def random_cluster(seed):
    """One seeded draw: nodes with zones and disk fractions, indices with
    shards and replicas, a reroute command, a departed node."""
    rng = np.random.RandomState(seed)
    n_nodes = int(rng.randint(1, 7))
    nodes = [f"n{i}" for i in range(n_nodes)]
    zones = ["z0", "z1", "z2"][: int(rng.randint(1, 4))]
    info = {n: {"attrs": {"zone": zones[int(rng.randint(len(zones)))]},
                "disk": float(np.round(rng.uniform(0.0, 1.0), 3))}
            for n in nodes}
    indices = {f"i{k}": (int(rng.randint(1, 5)), int(rng.randint(0, 3)))
               for k in range(int(rng.randint(1, 4)))}
    return {
        "nodes": nodes, "info": info, "indices": indices,
        "awareness": ["zone"] if rng.rand() < 0.5 else None,
        "started_p": float(rng.uniform(0.3, 1.0)),
        "started_draws": rng.rand(64).tolist(),
        "hot": nodes[int(rng.randint(n_nodes))],
        "departed": (nodes[int(rng.randint(n_nodes))]
                     if n_nodes > 1 and rng.rand() < 0.5 else None),
        "command": COMMANDS[int(rng.randint(len(COMMANDS)))],
        "cmd_index": f"i{int(rng.randint(len(indices)))}",
        "cmd_draws": rng.rand(3).tolist(),
        "accept": bool(rng.rand() < 0.8),
    }


def run_random(P, c):
    import copy as _copy

    info = _copy.deepcopy(c["info"])
    md = {name: meta(P, name, s, r) for name, (s, r) in c["indices"].items()}
    kw = dict(node_info=info, awareness_attributes=c["awareness"])
    t1 = P.allocate(md, c["nodes"], **kw)
    out = {"first": routing_view(t1)}
    # some copies start, one node fills past the high watermark
    draws = iter(c["started_draws"] * 4)
    for shards in t1.values():
        for copies in shards.values():
            for copy in copies:
                if next(draws) < c["started_p"]:
                    copy.state = P.ShardRoutingState.STARTED
    info[c["hot"]]["disk"] = 0.95
    alive = [n for n in c["nodes"] if n != c["departed"]]
    t2 = P.allocate(md, alive, previous=t1, **kw)
    out["second"] = routing_view(t2)
    # one reroute command, its nodes drawn from the copies it can act on
    # (a node that holds one, a node that does not), then the allocator
    # normalizes
    index = c["cmd_index"]
    d_shard, d_from, d_to = c["cmd_draws"]
    sid = int(d_shard * len(t2[index]))
    holders = [x.node_id for x in t2[index][sid] if x.node_id in alive]
    others = [n for n in alive if n not in holders]

    def pick(pool, draw):
        return pool[int(draw * len(pool))] if pool else "n-none"

    args = {"index": index, "shard": sid}
    if c["command"] == "move":
        args.update(from_node=pick(holders, d_from),
                    to_node=pick(others, d_to))
    elif c["command"] == "cancel":
        args.update(node=pick(holders, d_from))
    else:
        args.update(node=pick(others, d_to))
        if c["command"] == "allocate_empty_primary":
            args["accept_data_loss"] = c["accept"]
        if c["command"] == "cancel":
            args["allow_primary"] = c["accept"]
    try:
        out["explanation"] = P.apply_command(
            t2, md, {n: n for n in alive}, c["command"], args)
    except P.RerouteException as e:
        out["error"] = (type(e).__name__, str(e))
    out["third"] = routing_view(P.allocate(md, alive, previous=t2, **kw))
    out["command"] = (c["command"], args)
    out["round_trip"] = routing_view(P.routing_from_dict(
        P.routing_to_dict(t2)))
    return out


@pytest.mark.parametrize("seed", range(50))
def test_random_cluster_allocates_as_jax(seed):
    c = random_cluster(seed)
    out = check_both(lambda P: run_random(P, c), parallel=False)
    assert out["round_trip"] == out["second"] or "explanation" in out
