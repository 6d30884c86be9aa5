"""The port's in-process cluster against the JAX package's, case for case.

Each case of ``tests/test_multinode.py``, ``tests/test_file_recovery.py``
and ``tests/test_rollout.py``'s ``TestGracefulLeave`` runs as one
scenario over both packages (``torch_cluster_pair``): the same nodes, the
same seeded writes, the same faults, then the routing tables, primary
terms, seqnos, versions, global checkpoints, errors and search hits held
equal (scores within rtol 1e-5). The port's nodes run on the CPU; every
node is closed.
"""

import pytest

from torch_cluster_pair import (
    both,
    check_both,
    closing,
    routing_view,
    search_view,
    shard_view,
    start_cluster,
)


def seed_docs(client, index, n=20):
    for i in range(n):
        client.index(index, str(i), {"n": i, "body": f"doc number {i}"})
    client.refresh(index)


def three(P):
    return start_cluster(P, ["node-0", "node-1", "node-2"])


def node_list(nodes):
    return [nodes[k] for k in sorted(nodes)]


class TestMembership:
    def test_join_elects_first_master(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                return {n.node_id: (n.is_master, n.master_id,
                                    sorted(n.known_nodes), n.state_version,
                                    n.cluster_epoch)
                        for n in nodes.values()}

        out = check_both(run)
        assert out["node-0"][0] and out["node-1"][1] == "node-0"

    def test_join_via_non_master_redirects(self):
        def run(P):
            hub, nodes = three(P)
            late = P.node("node-9", hub)
            nodes["node-9"] = late
            with closing(nodes):
                late.join("node-2")  # the seed is not the master
                return ("node-9" in nodes["node-0"].known_nodes,
                        late.master_id, sorted(late.known_nodes))

        assert check_both(run)[:2] == (True, "node-0")


class TestAllocationAndReplication:
    def test_shards_spread_and_replicated(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                nodes["node-0"].create_index(
                    "idx", {"index": {"number_of_shards": 3,
                                      "number_of_replicas": 1}})
                return ([len(n.shards) for n in node_list(nodes)],
                        routing_view(nodes["node-0"].routing),
                        {k: shard_view(n) for k, n in nodes.items()})

        counts, routing, _ = check_both(run)
        assert sum(counts) == 6 and max(counts) - min(counts) <= 1
        for copies in routing["idx"].values():
            assert len({c[0] for c in copies}) == len(copies)

    def test_write_replicates_with_same_seqno(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                nodes["node-0"].create_index(
                    "idx", {"index": {"number_of_shards": 1,
                                      "number_of_replicas": 2}})
                client = P.ClusterClient(nodes["node-1"])
                r = client.index("idx", "1", {"v": 1})
                client.refresh("idx")
                seqnos = []
                for node in node_list(nodes):
                    g = node.shards[("idx", 0)].get_doc("1")
                    seqnos.append((g.found, g.source, g.seqno, g.version))
                return r, seqnos, {k: shard_view(n) for k, n in nodes.items()}

        r, seqnos, _ = check_both(run)
        assert r["_shards"]["successful"] == 3
        assert len(set(s[2] for s in seqnos)) == 1

    def test_get_served_from_replica(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                nodes["node-0"].create_index(
                    "idx", {"index": {"number_of_shards": 1,
                                      "number_of_replicas": 1}})
                client = P.ClusterClient(nodes["node-0"])
                client.index("idx", "1", {"v": 7})
                return client.get("idx", "1", prefer_replica=True)

        g = check_both(run)
        assert g["found"] and g["_source"] == {"v": 7}

    def test_search_across_nodes(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                nodes["node-0"].create_index(
                    "idx", {"index": {"number_of_shards": 4,
                                      "number_of_replicas": 0}})
                client = P.ClusterClient(nodes["node-2"])
                seed_docs(client, "idx", 30)
                r = client.search("idx", {"query": {"match": {"body": "doc"}},
                                          "size": 30})
                r2 = client.search("idx", {"query": {"term": {"n": 5}}})
                return search_view(r), search_view(r2)

        r, r2 = check_both(run)
        assert r["hits"]["total"] == 30 and r["_shards"]["failed"] == 0
        assert [h["_id"] for h in r2["hits"]["hits"]] == ["5"]

    def test_sorted_search_merges_across_nodes(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                nodes["node-0"].create_index(
                    "idx", {"index": {"number_of_shards": 3,
                                      "number_of_replicas": 0}})
                client = P.ClusterClient(nodes["node-0"])
                seed_docs(client, "idx", 25)
                return search_view(client.search(
                    "idx", {"query": {"match_all": {}},
                            "sort": [{"n": "asc"}], "size": 5}))

        r = check_both(run)
        assert [h["_id"] for h in r["hits"]["hits"]] == ["0", "1", "2", "3", "4"]

    def test_equal_scores_keep_shard_order(self):
        """The merge is a stable sort by descending score: hits that tie
        keep the shard order, exactly as the JAX coordinator orders
        them."""
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                nodes["node-0"].create_index(
                    "idx", {"index": {"number_of_shards": 3,
                                      "number_of_replicas": 1}})
                client = P.ClusterClient(nodes["node-1"])
                for i in range(12):
                    client.index("idx", f"t{i}", {"body": "same words"})
                client.refresh("idx")
                r = client.search("idx", {"query": {"match": {
                    "body": "same"}}, "size": 12})
                return [h["_id"] for h in r["hits"]["hits"]]

        j, t = both(run)
        assert j == t and len(t) == 12


class TestReplicaRecovery:
    def test_new_replica_recovers_from_primary(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                n0 = nodes["node-0"]
                n0.create_index("idx", {"index": {"number_of_shards": 1,
                                                  "number_of_replicas": 0}})
                seed_docs(P.ClusterClient(n0), "idx", 10)
                n0.indices_meta["idx"].settings = n0.indices_meta[
                    "idx"].settings.merged_with(
                    P.Settings({"index.number_of_replicas": 1}))
                n0._master_reroute_and_publish()
                copies = n0.routing["idx"][0]
                replica = next(c for c in copies if not c.primary)
                return (routing_view(n0.routing),
                        nodes[replica.node_id].shards[("idx", 0)].num_docs,
                        {k: shard_view(n) for k, n in nodes.items()})

        routing, num_docs, _ = check_both(run)
        assert num_docs == 10
        assert all(c[2] == "STARTED" for c in routing["idx"][0])

    def test_late_joining_node_gets_replicas(self):
        def run(P):
            hub, nodes = start_cluster(P, ["node-0"])
            with closing(nodes):
                n0 = nodes["node-0"]
                n0.create_index("idx", {"index": {"number_of_shards": 2,
                                                  "number_of_replicas": 1}})
                seed_docs(P.ClusterClient(n0), "idx", 8)
                before = routing_view(n0.routing)
                n1 = nodes["node-1"] = P.node("node-1", hub)
                n1.join("node-0")
                return (before, routing_view(n0.routing),
                        sum(s.num_docs for s in n1.shards.values()),
                        {k: shard_view(n) for k, n in nodes.items()})

        before, after, total, _ = check_both(run)
        assert all(len(c) == 1 for c in before["idx"].values())
        assert all(len(c) == 2 for c in after["idx"].values())
        assert total == 8


class TestFailover:
    def test_primary_promotion_on_node_loss(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                n0 = nodes["node-0"]
                n0.create_index("idx", {"index": {"number_of_shards": 3,
                                                  "number_of_replicas": 1}})
                seed_docs(P.ClusterClient(n0), "idx", 12)
                sid, primary_id = next(
                    (sid, n0._primary_node("idx", sid))
                    for sid in sorted(n0.routing["idx"])
                    if n0._primary_node("idx", sid) != "node-0")
                old_term = nodes[primary_id].shards[("idx", sid)].primary_term
                hub.disconnect(primary_id)
                departed = n0.check_nodes()
                new_primary_id = n0._primary_node("idx", sid)
                shard = nodes[new_primary_id].shards[("idx", sid)]
                client2 = P.ClusterClient(n0)
                w = client2.index("idx", "new-doc", {"after": "failover"})
                client2.refresh("idx")
                r = client2.search("idx", {"size": 0})
                for n in nodes.values():
                    getattr(n, "join_background", lambda: None)()
                return (departed, primary_id, new_primary_id,
                        bool(shard.primary), shard.primary_term - old_term,
                        w, search_view(r), routing_view(n0.routing),
                        {f"{i}#{s}": t
                         for (i, s), t in sorted(n0.primary_terms.items())})

        out = check_both(run)
        assert out[1] in out[0] and out[2] != out[1]
        assert out[3] and out[4] == 1
        assert out[6]["hits"]["total"] == 13

    def test_replica_failure_during_write_drops_copy(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                n0 = nodes["node-0"]
                n0.create_index("idx", {"index": {"number_of_shards": 1,
                                                  "number_of_replicas": 2}})
                client = P.ClusterClient(n0)
                client.index("idx", "1", {"v": 1})
                primary_id = n0._primary_node("idx", 0)
                replica_ids = [c.node_id for c in n0.routing["idx"][0]
                               if not c.primary]
                hub.disconnect(primary_id, replica_ids[0])
                r = client.index("idx", "2", {"v": 2})
                hub.heal()
                return r["_shards"], routing_view(n0.routing)

        shards, _ = check_both(run)
        assert shards["successful"] >= 2

    def test_search_fails_over_to_replica(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                n0 = nodes["node-0"]
                n0.create_index("idx", {"index": {"number_of_shards": 1,
                                                  "number_of_replicas": 1}})
                client = P.ClusterClient(n0)
                seed_docs(client, "idx", 5)
                primary_id = n0._primary_node("idx", 0)
                if primary_id != "node-0":
                    hub.disconnect("node-0", primary_id)
                r = client.search("idx", {"size": 0})
                hub.heal()
                return search_view(r)

        assert check_both(run)["hits"]["total"] == 5


class TestTransportFaults:
    def test_disconnect_raises(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                hub.disconnect("node-0", "node-1")
                try:
                    nodes["node-0"].transport.send_request(
                        "node-1",
                        "internal:cluster/coordination/publish_state", None)
                    err = None
                except P.errors.NodeNotConnectedException as e:
                    err = type(e).__name__
                hub.heal()
                ok = nodes["node-0"].transport.send_request(
                    "node-1", "internal:cluster/coordination/publish_state",
                    None)["ok"]
                return err, ok

        assert check_both(run) == ("NodeNotConnectedException", True)

    def test_requests_are_json_serializable(self):
        def run(P):
            hub, nodes = three(P)
            with closing(nodes):
                nodes["node-0"].create_index(
                    "idx", {"index": {"number_of_shards": 2,
                                      "number_of_replicas": 1}})
                client = P.ClusterClient(nodes["node-1"])
                seed_docs(client, "idx", 6)
                return search_view(client.search(
                    "idx", {"query": {"match_all": {}}}))

        assert check_both(run)["hits"]["total"] == 6


# ---------------------------------------------------------------------------
# File-based peer recovery (tests/test_file_recovery.py)
# ---------------------------------------------------------------------------

ACTION_CHUNK = "internal:index/shard/recovery/files/chunk"
ACTION_FILES_START = "internal:index/shard/recovery/files/start"
ACTION_RECOVER = "internal:index/shard/recovery/start_recovery"


def one_node_with_docs(P, n_docs=150, deletes=()):
    hub = P.TransportHub(strict_serialization=True)
    n1 = P.node("n1", hub)
    n1.bootstrap_cluster()
    n1.create_index(
        "logs", {"index": {"number_of_shards": 1, "number_of_replicas": 1}},
        {"properties": {"msg": {"type": "text"}}})
    client = P.ClusterClient(n1)
    for i in range(n_docs):
        client.index("logs", str(i), {"msg": f"event {i}"})
    for d in deletes:
        client.delete("logs", str(d))
    return hub, n1, client


def spy_phase2(node):
    seen = {}
    orig = node._on_start_recovery

    def spy(payload, src):
        resp = orig(payload, src)
        seen["above_seqno"] = payload.get("above_seqno", -1)
        seen["n_ops"] = len(resp["ops"])
        return resp

    node.transport.register_handler(ACTION_RECOVER, spy)
    return seen


def promoted_search(P, hub, n2, size):
    hub.disconnect("n1")
    master = n2.check_master()
    c2 = P.ClusterClient(n2)
    c2.refresh("logs")
    res = c2.search("logs", {"query": {"match": {"msg": "event"}},
                             "size": size})
    return master, search_view(res)


class TestFileRecovery:
    def test_replica_recovers_via_files_not_ops(self):
        def run(P):
            hub, n1, client = one_node_with_docs(P, 200)
            n2 = P.node("n2", hub)
            with closing([n1, n2]):
                seen = spy_phase2(n1)
                n2.join("n1")
                actions = {a for _, _, a in hub.requests_log}
                rep = shard_view(n2)
                master, res = promoted_search(P, hub, n2, 300)
                return (ACTION_FILES_START in actions,
                        ACTION_CHUNK in actions, seen, rep, master, res)

        out = check_both(run)
        assert out[0] and out[1]
        assert out[2]["above_seqno"] >= 199 and out[2]["n_ops"] == 0
        assert out[4] == "n2" and out[5]["hits"]["total"] == 200

    def test_deletes_survive_file_recovery(self):
        def run(P):
            hub, n1, client = one_node_with_docs(P, 60, deletes=(3, 17, 42))
            n2 = P.node("n2", hub)
            with closing([n1, n2]):
                n2.join("n1")
                rep = shard_view(n2)
                return rep, promoted_search(P, hub, n2, 100)[1]

        rep, res = check_both(run)
        assert res["hits"]["total"] == 57
        assert not {h["_id"] for h in res["hits"]["hits"]} & {"3", "17", "42"}

    def test_writes_after_commit_covered_by_phase2(self):
        def run(P):
            hub, n1, client = one_node_with_docs(P, 50)
            orig = n1._on_start_file_recovery
            extra = {"done": False}

            def wedge(payload, src):
                resp = orig(payload, src)
                if not extra["done"]:
                    extra["done"] = True
                    for i in range(50, 60):
                        client.index("logs", str(i), {"msg": f"event {i}"})
                return resp

            n1.transport.register_handler(ACTION_FILES_START, wedge)
            seen = spy_phase2(n1)
            n2 = P.node("n2", hub)
            with closing([n1, n2]):
                n2.join("n1")
                return seen, shard_view(n2), promoted_search(
                    P, hub, n2, 100)[1]

        seen, _, res = check_both(run)
        assert seen["n_ops"] == 10 and res["hits"]["total"] == 60

    def test_ops_fallback_when_file_phase_fails(self):
        def run(P):
            hub, n1, client = one_node_with_docs(P, 80)

            def boom(payload, src):
                raise P.errors.ElasticsearchTpuException(
                    "simulated phase1 failure")

            n1.transport.register_handler(ACTION_FILES_START, boom)
            seen = spy_phase2(n1)
            n2 = P.node("n2", hub)
            with closing([n1, n2]):
                n2.join("n1")
                return seen, shard_view(n2), promoted_search(
                    P, hub, n2, 100)[1]

        seen, _, res = check_both(run)
        assert seen == {"above_seqno": -1, "n_ops": 80}
        assert res["hits"]["total"] == 80

    def test_recovered_shard_flush_keeps_new_docs(self):
        def run(P):
            hub, n1, client = one_node_with_docs(P, 50)
            n2 = P.node("n2", hub)
            with closing([n1, n2]):
                n2.join("n1")
                hub.disconnect("n1")
                n2.check_master()
                c2 = P.ClusterClient(n2)
                writes = [c2.index("logs", str(i), {"msg": f"event {i}"})
                          for i in range(50, 60)]
                shard = n2.shards[("logs", 0)]
                shard.flush()
                names = [s.name for s in shard.engine.searchable_segments()]
                store = shard.engine.store
                reloaded = (store.load_segments() if P.name == "jax"
                            else store.load_segments("cpu"))
                total = sum(int(s.live[: s.num_docs].sum()) for s in reloaded)
                c2.refresh("logs")
                res = c2.search("logs", {"query": {"match": {"msg": "event"}},
                                         "size": 100})
                return (writes, len(names) == len(set(names)), total,
                        search_view(res), shard_view(n2))

        writes, unique, total, res, _ = check_both(run)
        assert unique and total == 60 and res["hits"]["total"] == 60

    def test_sessions_cleaned_up_after_finalize(self):
        def run(P):
            hub, n1, client = one_node_with_docs(P, 30)
            n2 = P.node("n2", hub)
            with closing([n1, n2]):
                n2.join("n1")
                return n1._recovery_sessions

        assert check_both(run) == {}

    def test_source_throttle_paces_chunks(self):
        def run(P):
            import time

            hub, n1, client = one_node_with_docs(P, 100)
            n1.recovery_max_bytes_per_sec = 200 * 1024
            t0 = time.monotonic()
            n2 = P.node("n2", hub)
            with closing([n1, n2]):
                n2.join("n1")
                elapsed = time.monotonic() - t0
                sent = sum(1 for _, _, a in hub.requests_log
                           if a == ACTION_CHUNK)
                return (sent > 0, elapsed < 30,
                        promoted_search(P, hub, n2, 200)[1])

        sent, fast, res = check_both(run)
        assert sent and fast and res["hits"]["total"] == 100


# ---------------------------------------------------------------------------
# Graceful leave (tests/test_rollout.py TestGracefulLeave)
# ---------------------------------------------------------------------------


class TestGracefulLeave:
    def test_follower_leave_removes_it_without_fd(self):
        def run(P):
            hub, nodes = start_cluster(P, ["ga", "gb", "gc"],
                                       hub=P.TransportHub())
            with closing(nodes):
                nodes["ga"].create_index("gidx", {"index": {
                    "number_of_shards": 2, "number_of_replicas": 1}})
                nodes["gc"].close(graceful=True)
                return (sorted(nodes["ga"].known_nodes),
                        routing_view(nodes["ga"].routing))

        known, routing = check_both(run)
        assert "gc" not in known
        for copies in routing["gidx"].values():
            assert all(c[0] != "gc" for c in copies)
            assert any(c[1] for c in copies)

    def test_master_abdicates_and_replicas_promote_on_leave(self):
        def run(P):
            hub, nodes = start_cluster(P, ["ga", "gb", "gc"],
                                       hub=P.TransportHub())
            with closing(nodes):
                nodes["ga"].create_index("gidx2", {"index": {
                    "number_of_shards": 2, "number_of_replicas": 1}})
                nodes["ga"].reroute()
                old_terms = dict(nodes["gb"].primary_terms)
                had_primary = sorted(
                    sid for sid, cs in nodes["ga"].routing["gidx2"].items()
                    if any(c.primary and c.node_id == "ga" for c in cs))
                nodes["ga"].close(graceful=True)
                gb = nodes["gb"]
                bumped = {sid: gb.primary_terms[("gidx2", sid)]
                          > old_terms.get(("gidx2", sid), 1)
                          for sid in had_primary}
                return (gb.is_master, sorted(gb.known_nodes),
                        routing_view(gb.routing), bumped,
                        {k: shard_view(n) for k, n in nodes.items()
                         if k != "ga"})

        is_master, known, routing, bumped, _ = check_both(run)
        assert is_master and "ga" not in known and all(bumped.values())
        for copies in routing["gidx2"].values():
            primary = [c for c in copies if c[1]]
            assert primary and primary[0][0] != "ga"

    def test_close_deregisters_transport_before_shard_close(self):
        def run(P):
            hub, nodes = start_cluster(P, ["ha", "hb"],
                                       hub=P.TransportHub())
            with closing(nodes):
                nodes["ha"].create_index("hidx", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 0}})
                nodes["hb"].close(graceful=True)
                try:
                    nodes["ha"].transport.send_request(
                        "hb", "indices:data/read/get[s]",
                        {"index": "hidx", "shard": 0, "id": "x"})
                except P.errors.NodeNotConnectedException as e:
                    return type(e).__name__
                return None

        assert check_both(run) == "NodeNotConnectedException"


# ---------------------------------------------------------------------------
# The port's own choices
# ---------------------------------------------------------------------------


def test_cluster_node_on_cuda_raises_without_a_card():
    import torch

    from torch_cluster_pair import PORT

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    hub = PORT.TransportHub()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.ClusterNode("c1", hub, device="cuda")
    assert "c1" not in hub.nodes()


def test_temporary_store_removed_on_close():
    import os

    from torch_cluster_pair import PORT

    hub, nodes = start_cluster(PORT, ["t1", "t2"])
    with closing(nodes):
        nodes["t1"].create_index("tmp", {"index": {"number_of_shards": 2,
                                                   "number_of_replicas": 1}})
        client = PORT.ClusterClient(nodes["t1"])
        for i in range(10):
            client.index("tmp", str(i), {"body": f"w{i}"})
        roots = [n._tmp_root for n in nodes.values()]
        paths = [s.data_path for n in nodes.values()
                 for s in n.shards.values()]
        assert all(r and os.path.isdir(r) for r in roots)
        assert all(p.startswith(tuple(roots)) and os.path.isdir(p)
                   for p in paths)
        # a copy that leaves a node takes its directory with it
        victim = next(s for s in nodes["t2"].shards.values())
        nodes["t1"].delete_index("tmp")
        assert not os.path.exists(victim.data_path)
    assert not any(os.path.exists(r) for r in roots)


def test_apply_replicated_op_after_file_recovery_sees_whole_map():
    """The first replicated op after a file recovery meets the deferred
    version map: a stale op (a seqno the shipped commit already holds)
    is a no-op, whichever thread applies it."""
    from torch_cluster_pair import PORT

    hub, n1, client = one_node_with_docs(PORT, 40)
    n2 = PORT.node("n2", hub)
    with closing([n1, n2]):
        n2.join("n1")
        shard = n2.shards[("logs", 0)]
        stale = {"op": "index", "id": "7", "source": {"msg": "stale"},
                 "seq_no": 7, "version": 1, "primary_term": 1}
        PORT.mn.ClusterNode._apply_replicated_op(shard, stale)
        shard.refresh()
        assert shard.get_doc("7").source == {"msg": "event 7"}
        assert shard.seq_no_stats()["local_checkpoint"] == 39
