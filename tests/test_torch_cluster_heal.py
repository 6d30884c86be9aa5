"""Cluster heal outcomes and the device ledger of a cluster, port vs JAX.

``tests/test_corruption.py``'s ``TestClusterHealOutcomes`` case for case
(a corrupt replica re-recovers from its primary, a corrupt primary fails
over and is rebuilt, a corrupt last copy stays red and is never replaced
by an empty primary), the in-flight ``StoreCorruptionScheme`` (a bit
flipped in the source's recovery session: the target's digest check
catches it, the retried session heals) and allocation explain with the
corrupted copies' markers, each over both packages with the routing, the
integrity counters' moves and the hits held equal. Then the port's own
choice: each shard copy stages its own segments, so dropping one node's
copy leaves the other copies' stagings and ledger entries whole.
"""

import time

import pytest

from torch_cluster_pair import (
    PORT,
    check_both,
    closing,
    recovery_rows,
    routing_view,
    search_view,
    shard_view,
    start_cluster,
)


def _wait(predicate, attempts=400, delay=0.05):
    for _ in range(attempts):
        if predicate():
            return True
        time.sleep(delay)
    return predicate()


def durable_cluster(P, tmp_path, n=2):
    hub = P.TransportHub()
    nodes = [P.node(f"cn-{i}", hub,
                    data_path=str(tmp_path / P.name / f"cn{i}"))
             for i in range(n)]
    nodes[0].bootstrap_cluster()
    for nd in nodes[1:]:
        nd.join("cn-0")
    return hub, {nd.node_id: nd for nd in nodes}


def seed(client, index, docs=10):
    for i in range(docs):
        client.index(index, str(i), {"body": f"alpha {i}", "n": i})
    client.refresh(index)


def started(master, index, want):
    copies = master.routing.get(index, {}).get(0, [])
    return len(copies) == want and all(c.state == "STARTED" for c in copies)


def healed(master, nodes, index):
    copies = master.routing.get(index, {}).get(0, [])
    if len(copies) != 2 or any(c.state != "STARTED" for c in copies):
        return False
    for copy in copies:
        shard = nodes[copy.node_id].shards.get((index, 0))
        if shard is None or shard.store_corrupted \
                or shard.engine.store.is_corrupted():
            return False
    return True


def always_corrupt(P):
    def query(*a, **k):
        raise P.CorruptIndexException("injected: torn posting block")
    return query


def integrity_delta(before, after):
    return {
        "query": (after["corruption_detected_by_site"].get("query", 0)
                  - before["corruption_detected_by_site"].get("query", 0)),
        "recovery": (after["corruption_detected_by_site"].get("recovery", 0)
                     - before["corruption_detected_by_site"]
                     .get("recovery", 0)),
        "written": after["markers_written_total"]
        - before["markers_written_total"],
        "cleared": after["markers_cleared_total"]
        - before["markers_cleared_total"],
    }


class TestClusterHealOutcomes:
    def test_corrupt_replica_re_recovers_from_primary(self, tmp_path):
        def run(P):
            hub, nodes = durable_cluster(P, tmp_path)
            with closing(nodes):
                master = nodes["cn-0"]
                master.create_index("hr", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 1}})
                client = P.ClusterClient(master)
                seed(client, "hr")
                assert _wait(lambda: started(master, "hr", 2))
                replica = next(c for c in master.routing["hr"][0]
                               if not c.primary)
                rnode = nodes[replica.node_id]
                rnode.shards[("hr", 0)].searcher.query = always_corrupt(P)
                before = P.integrity_service().stats()
                try:
                    rnode._on_query({"index": "hr", "shard": 0,
                                     "body": {"query": {"match_all": {}}},
                                     "k": 10}, "test")
                    err = None
                except P.CorruptIndexException as e:
                    err = type(e).__name__
                mid = P.integrity_service().stats()
                assert _wait(lambda: healed(master, nodes, "hr"))
                after = P.integrity_service().stats()
                r = client.search("hr", {"query": {"match_all": {}},
                                         "size": 20})
                return (err, integrity_delta(before, mid),
                        integrity_delta(before, after)["cleared"] >= 1,
                        routing_view(master.routing), search_view(r))

        err, detected, cleared, _, r = check_both(run)
        assert err == "CorruptIndexException"
        assert detected["query"] >= 1 and detected["written"] >= 1
        assert cleared and r["_shards"]["failed"] == 0
        assert r["hits"]["total"] == 10

    def test_corrupt_primary_fails_over_then_rebuilds(self, tmp_path):
        def run(P):
            hub, nodes = durable_cluster(P, tmp_path)
            with closing(nodes):
                master = nodes["cn-0"]
                master.create_index("hp", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 1}})
                client = P.ClusterClient(master)
                seed(client, "hp")
                assert _wait(lambda: started(master, "hp", 2))
                old = next(c for c in master.routing["hp"][0] if c.primary)
                pnode = nodes[old.node_id]
                pnode.shards[("hp", 0)].searcher.query = always_corrupt(P)
                try:
                    pnode._on_query({"index": "hp", "shard": 0,
                                     "body": {"query": {"match_all": {}}},
                                     "k": 10}, "test")
                except P.CorruptIndexException:
                    pass

                def failed_over():
                    if not healed(master, nodes, "hp"):
                        return False
                    newp = next(c for c in master.routing["hp"][0]
                                if c.primary)
                    return newp.node_id != old.node_id

                assert _wait(failed_over)
                for nd in nodes.values():
                    getattr(nd, "join_background", lambda: None)()
                r = client.search("hp", {"query": {"match_all": {}},
                                         "size": 20})
                return (routing_view(master.routing),
                        {f"{i}#{s}": t for (i, s), t
                         in sorted(master.primary_terms.items())},
                        search_view(r))

        _, terms, r = check_both(run)
        # ROADMAP C21: a primary failed through the shard-failed report is
        # replaced under the same term in both packages (the removal
        # lands before the reroute compares the primaries)
        assert terms == {"hp#0": 1}
        assert r["_shards"]["failed"] == 0 and r["hits"]["total"] == 10

    def test_last_copy_retained_red_never_resurrected(self, tmp_path):
        def run(P):
            hub, nodes = durable_cluster(P, tmp_path)
            with closing(nodes):
                master = nodes["cn-0"]
                master.create_index("lc", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 0}})
                client = P.ClusterClient(master)
                seed(client, "lc", docs=6)
                assert _wait(lambda: started(master, "lc", 1))
                copy = master.routing["lc"][0][0]
                pnode = nodes[copy.node_id]
                shard = pnode.shards[("lc", 0)]
                shard.searcher.query = always_corrupt(P)
                r = client.search("lc", {"query": {"match_all": {}}})
                assert _wait(lambda: ("lc", 0) in master.corrupt_retained)
                marked = shard.engine.store.is_corrupted()
                master.reroute()
                r2 = client.search("lc", {"query": {"match_all": {}}})
                return (r["_shards"]["failed"], r["hits"]["hits"], marked,
                        routing_view(master.routing),
                        r2["_shards"]["failed"], r2["hits"]["hits"],
                        master.corrupt_retained[("lc", 0)]["node"])

        failed, hits, marked, routing, failed2, hits2, node = check_both(run)
        assert failed == failed2 == 1 and hits == hits2 == []
        assert marked and [c[0] for c in routing["lc"][0]] == [node]


class TestInFlightCorruption:
    def test_corrupt_chunk_caught_and_healed_by_the_retry(self):
        def run(P):
            P.mn.clear_recovery_progress()
            hub, nodes = start_cluster(P, ["n1", "n2"])
            with closing(nodes):
                n1 = nodes["n1"]
                n1.create_index("fl", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 0}},
                    {"properties": {"body": {"type": "text"}}})
                client = P.ClusterClient(n1)
                seed(client, "fl", docs=30)
                primary = nodes[n1._primary_node("fl", 0)]
                primary.shards[("fl", 0)].flush()
                scheme = P.d.StoreCorruptionScheme(
                    "bitflip", seed=7, source_node=primary).apply_to(hub)
                before = P.integrity_service().stats()
                try:
                    def mutate():
                        md = n1.indices_meta["fl"]
                        md.settings = md.settings.merged_with(
                            P.Settings({"index.number_of_replicas": 1}))
                    n1._submit_state_update(mutate)
                finally:
                    scheme.remove()
                after = P.integrity_service().stats()
                replica = next(nd for nd in nodes.values()
                               if nd is not primary)
                client.refresh("fl")
                hub.disconnect(primary.node_id)
                if replica.check_master() is None:
                    replica.check_nodes()
                r = P.ClusterClient(replica).search(
                    "fl", {"query": {"match": {"body": "alpha"}},
                           "size": 40})
                rows = recovery_rows(P, "fl")
                out = (scheme.hits, len(scheme.corrupted),
                       integrity_delta(before, after)["recovery"],
                       shard_view(replica), search_view(r), rows)
            P.mn.clear_recovery_progress()
            return out

        hits, logged, detected, _, r, rows = check_both(run)
        assert hits == logged == 1 and detected == 1
        assert r["hits"]["total"] == 30 and r["_shards"]["failed"] == 0
        (peer,) = [row for row in rows if row["type"] == "peer"]
        assert peer["stage"] == "done"
        assert peer["files_recovered"] == peer["files_total"] >= 1

    def test_in_flight_needs_a_source(self):
        def run(P):
            try:
                P.d.StoreCorruptionScheme("bitflip").apply_to(P.TransportHub())
            except ValueError as e:
                return "source_node" in str(e)
            return False

        assert check_both(run, parallel=False) is True


def test_allocation_explain_surfaces_markers(tmp_path):
    """A single node's allocation explain, healthy and with a marker."""
    from test_torch_rest import assert_same_body
    from torch_pair import NodePair

    pair = NodePair(data_paths=(str(tmp_path / "j"), str(tmp_path / "t")))
    try:
        pair.same("PUT", "/rx", {"settings": {"number_of_shards": 2}})
        out = pair.same("GET", "/_cluster/allocation/explain", status=200)
        assert out["can_allocate"] == "yes"
        for node in (pair.j, pair.t):
            node.indices["rx"].shards[1].engine.store.mark_corrupted(
                "torn checksums", site="load")
        (js, jb), (ts, tb) = pair.call("GET", "/_cluster/allocation/explain")
        assert js == ts == 200
        markers = [c.pop("marker") for b in (jb, tb)
                   for c in b["corrupted_copies"]]
        assert all(m.startswith(PORT.MARKER_PREFIX) for m in markers)
        assert_same_body(jb, tb, "allocation explain")
        assert tb["can_allocate"] == "no"
        assert [(c["index"], c["shard"], c["site"])
                for c in tb["corrupted_copies"]] == [("rx", 1, "load")]
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# The port's own choice: a copy's stagings are its own
# ---------------------------------------------------------------------------


def _staged(node, key):
    shard = node.shards[key]
    return {seg.ledger_scope: seg._device is not None
            for seg in shard.engine.segments}


def _ledger_scopes(index):
    from elasticsearch_tpu_torch.common.memory import memory_accountant

    return {row["segment"]: row["bytes"]
            for row in memory_accountant().table() if row["index"] == index}


def test_dropping_one_copy_leaves_the_others_staged():
    """Three nodes, each with a copy of the one shard, each copy staged
    by a search on its own node. Closing one node without grace drops its
    copy's ledger scopes only; the other copies keep their tensors and
    entries, to the byte. Deleting the index then releases everything."""
    hub, nodes = start_cluster(PORT, ["l1", "l2", "l3"])
    with closing(nodes):
        nodes["l1"].create_index("led", {"index": {
            "number_of_shards": 1, "number_of_replicas": 2}},
            {"properties": {"body": {"type": "text"}}})
        client = PORT.ClusterClient(nodes["l1"])
        seed(client, "led", docs=12)
        key = ("led", 0)
        for node in nodes.values():
            res = node._on_query({"index": "led", "shard": 0,
                                  "body": {"query": {"match": {
                                      "body": "alpha"}}}, "k": 5}, "test")
            assert res["total"] == 12
        scopes = _ledger_scopes("led")
        by_node = {n: _staged(nd, key) for n, nd in nodes.items()}
        assert all(all(v.values()) and v for v in by_node.values())
        assert set(scopes) == {s for v in by_node.values() for s in v}
        victim = nodes["l3"]
        victim.close(graceful=False)
        nodes["l1"].check_nodes()
        after = _ledger_scopes("led")
        assert set(after) == set(scopes) - set(by_node["l3"])
        for n in ("l1", "l2"):
            assert _staged(nodes[n], key) == by_node[n]
            for scope in by_node[n]:
                assert after[scope] == scopes[scope]
        nodes["l1"].delete_index("led")
        assert _ledger_scopes("led") == {}


def test_failed_replica_releases_only_its_own_scopes():
    """A replica reported failed (a quarantined copy) returns its
    segments' ledger bytes; the primary's stay whole."""
    hub, nodes = start_cluster(PORT, ["f1", "f2"])
    with closing(nodes):
        nodes["f1"].create_index("fr", {"index": {
            "number_of_shards": 1, "number_of_replicas": 1}},
            {"properties": {"body": {"type": "text"}}})
        seed(PORT.ClusterClient(nodes["f1"]), "fr", docs=8)
        key = ("fr", 0)
        for node in nodes.values():
            node._on_query({"index": "fr", "shard": 0, "body": {
                "query": {"match": {"body": "alpha"}}}, "k": 5}, "test")
        primary = next(nd for nd in nodes.values() if nd.shards[key].primary)
        replica = next(nd for nd in nodes.values() if nd is not primary)
        kept = _staged(primary, key)
        scopes = _ledger_scopes("fr")
        replica.shards[key].searcher.query = always_corrupt(PORT)
        with pytest.raises(PORT.CorruptIndexException):
            replica._on_query({"index": "fr", "shard": 0, "body": {
                "query": {"match_all": {}}}, "k": 5}, "test")
        after = _ledger_scopes("fr")
        assert _staged(primary, key) == kept
        for scope in kept:
            assert after[scope] == scopes[scope]
