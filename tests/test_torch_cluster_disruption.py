"""The port's cluster under injected transport faults, against JAX's.

``tests/test_disruption.py``'s ``TestAdaptiveSelectionPenalty``,
``TestClusterSmoke``, ``TestCatRecovery`` and (marked ``slow`` as it is
there) ``TestDisruptionConvergence``, case for case: each scenario runs
over both packages at once (``torch_cluster_pair.both``) with the same
deadlines, schemes and seeds, and the routing tables, primary terms,
acknowledged writes, error types, search hits and ``_cat/recovery`` rows
(without times) are held equal. Fault detection runs by explicit
``check_nodes`` / ``check_master`` calls; every wait is bounded.
"""

import threading
import time

import pytest

from torch_cluster_pair import (
    JAX,
    PORT,
    assert_same,
    both,
    check_both,
    closing,
    recovery_rows,
    routing_view,
    search_view,
    shard_view,
)

FAST = {
    "transport.request.timeout": "3s",
    "transport.retry.max_attempts": 4,
    "transport.retry.initial_backoff": "20ms",
    "transport.retry.max_backoff": "200ms",
    "transport.health.failure_threshold": 3,
    "transport.health.quarantine": "300ms",
    "discovery.zen.fd.ping_timeout": "500ms",
    "discovery.zen.fd.ping_retries": 3,
    "discovery.zen.publish_timeout": "2s",
    "cluster.replication.timeout": "600ms",
    "indices.recovery.retry_delay_network": "20ms",
    "indices.recovery.max_retries": 4,
    "indices.recovery.internal_action_timeout": "2s",
}
MSG = {"properties": {"msg": {"type": "text"}}}
WRITE_REPLICA = "indices:data/write/bulk[s][r]"
WRITE_PRIMARY = "indices:data/write/bulk[s][p]"
SHARD_FAILED = "internal:cluster/shard/failure"


def cluster(P, names=("n1", "n2", "n3"), **overrides):
    hub = P.TransportHub(strict_serialization=True)
    settings = P.Settings({**FAST, **overrides})
    nodes = {n: P.node(n, hub, settings=settings) for n in names}
    nodes[names[0]].bootstrap_cluster()
    for n in names[1:]:
        nodes[n].join(names[0])
    return hub, nodes


def converge(nodes, attempts=40):
    """Fault-detection ticks until every node agrees on one live master
    and one state version; returns the master id."""
    for _ in range(attempts):
        for node in nodes.values():
            try:
                if node.is_master:
                    node.check_nodes()
                else:
                    node.check_master()
            except Exception:  # noqa: BLE001 — disruption may still bite
                pass
        masters = {n.master_id for n in nodes.values()}
        versions = {n.state_version for n in nodes.values()}
        if len(masters) == 1 and None not in masters and len(versions) == 1:
            return masters.pop()
        time.sleep(0.05)
    raise AssertionError("cluster did not converge")


def wait_started(nodes, index, attempts=80):
    """Reroute until every copy of every shard is STARTED (bounded)."""
    master = next((n for n in nodes.values() if n.is_master), None)
    for _ in range(attempts):
        master = next((n for n in nodes.values() if n.is_master), master)
        try:
            master.reroute()
        except Exception:  # noqa: BLE001
            pass
        copies = [c for cs in master.routing.get(index, {}).values()
                  for c in cs]
        if copies and all(c.state == "STARTED" for c in copies):
            return
        time.sleep(0.05)
    raise AssertionError(f"shards of [{index}] never all STARTED")


def drop_first_n(P, n, **filters):
    class DropFirstN(P.d.DisruptionScheme):
        def __init__(self):
            super().__init__(**filters)
            self.remaining = n
            self._lock = threading.Lock()

        def disrupt(self, src, dst, action):
            with self._lock:
                if self.remaining <= 0:
                    return
                self.remaining -= 1
            raise P.errors.NodeNotConnectedException(
                f"dropped [{action}] (injected)")

    return DropFirstN()


def raise_type(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is the result
        return type(e).__name__, str(e)
    return None


def bump_replicas(P, master, index):
    def mutate():
        md = master.indices_meta[index]
        md.settings = md.settings.merged_with(
            P.Settings({"index.number_of_replicas": 1}))
    master._submit_state_update(mutate)


class TestAdaptiveSelectionPenalty:
    def test_failure_penalizes_rank_success_recovers(self):
        def run(P):
            rc = P.ResponseCollectorService()
            rc.add_response_time("good", 0.01)
            rc.add_response_time("flaky", 0.01)
            rc.on_failure("flaky", 0.6)
            out = [rc.rank("flaky"), rc.rank("good")]
            rc.on_failure("flaky", 0.0)
            out.append(rc.rank("flaky"))
            for _ in range(30):
                rc.add_response_time("flaky", 0.01)
            return out + [rc.rank("flaky")]

        flaky, good, flaky2, recovered = check_both(run, parallel=False)
        assert flaky > good and flaky2 > good and recovered < 0.05

    def test_reads_reroute_away_from_unresponsive_replica(self):
        def run(P):
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("ars", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 1}}, MSG)
                wait_started(nodes, "ars")
                primary = nodes["n1"]._primary_node("ars", 0)
                other = "n2" if primary == "n1" else "n1"
                client = P.ClusterClient(nodes[primary])
                client.index("ars", "1", {"msg": "x"})
                client.refresh("ars")
                scheme = P.d.UnresponsiveNode(other, max_block_s=10
                                              ).apply_to(hub)
                try:
                    r = client.get("ars", "1", prefer_replica=True)
                    ranked = (client.response_collector.rank(other)
                              > client.response_collector.rank(primary))
                finally:
                    scheme.remove()
                return r, ranked

        r, ranked = check_both(run)
        assert r["found"] and ranked


class TestClusterSmoke:
    def test_publish_and_write_survive_transient_drops(self):
        def run(P):
            hub, nodes = cluster(P)
            with closing(nodes):
                drop_first_n(P, 1, actions=["internal:cluster/coordination/*"]
                             ).apply_to(hub)
                nodes["n1"].create_index("logs", {"index": {
                    "number_of_shards": 2, "number_of_replicas": 1}}, MSG)
                client = P.ClusterClient(nodes["n1"])
                writes = [client.index("logs", str(i), {"msg": f"event {i}"})
                          for i in range(6)]
                client.refresh("logs")
                res = client.search("logs", {"query": {"match": {
                    "msg": "event"}}, "size": 20})
                return (writes, search_view(res),
                        nodes["n1"].transport.stats["retries"] >= 1,
                        routing_view(nodes["n1"].routing),
                        {k: shard_view(n) for k, n in nodes.items()})

        writes, res, retried, _, _ = check_both(run)
        assert res["hits"]["total"] == 6 and retried

    def test_unresponsive_master_detected_and_replaced(self):
        def run(P):
            hub, nodes = cluster(P)
            with closing(nodes):
                scheme = P.d.UnresponsiveNode("n1", max_block_s=5
                                              ).apply_to(hub)
                try:
                    new = nodes["n2"].check_master()
                    return (new, nodes["n2"].is_master,
                            nodes["n2"].transport.stats["timeouts"] >= 1)
                finally:
                    scheme.remove()

        assert check_both(run) == ("n2", True, True)

    def test_blackholed_replica_failed_without_blocking_primary(self):
        def run(P):
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("k", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 1}}, MSG)
                wait_started(nodes, "k")
                primary = nodes["n1"]._primary_node("k", 0)
                replica = "n2" if primary == "n1" else "n1"
                scheme = P.d.ActionBlackhole([WRITE_REPLICA], max_block_s=30,
                                             dst=[replica]).apply_to(hub)
                try:
                    client = P.ClusterClient(nodes[primary])
                    t0 = time.monotonic()
                    r = client.index("k", "1", {"msg": "served"})
                    took = time.monotonic() - t0
                    reported = (any(a == SHARD_FAILED
                                    for (_s, _d, a) in hub.requests_log)
                                or nodes[primary].is_master)
                    r2 = client.index("k", "2", {"msg": "still served"})
                    return (r["result"], took < 10.0, r["_shards"],
                            reported, r2["result"])
                finally:
                    scheme.remove()

        result, quick, shards, reported, result2 = check_both(run)
        assert result == "created" and quick and reported
        assert shards["failed"] == 1 and result2 == "created"

    def test_recovery_retries_chunks_under_drop(self):
        def run(P):
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("r", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 0}}, MSG)
                client = P.ClusterClient(nodes["n1"])
                for i in range(20):
                    client.index("r", str(i), {"msg": f"doc {i}"})
                primary = nodes["n1"]._primary_node("r", 0)
                nodes[primary].shards[("r", 0)].flush()
                drop = P.d.NetworkDrop(
                    0.3, seed=11, actions=["internal:index/shard/recovery/*"]
                ).apply_to(hub)
                try:
                    bump_replicas(P, nodes["n1"], "r")
                    wait_started(nodes, "r")
                finally:
                    drop.remove()
                replica = next(n for n in nodes.values()
                               if n.node_id != primary)
                shard = replica.shards[("r", 0)]
                shard.refresh()
                return (shard.num_docs, sum(n.transport.stats["retries"]
                                            for n in nodes.values()) >= 1,
                        shard_view(replica))

        num_docs, retried, _ = check_both(run)
        assert num_docs == 20 and retried

    def test_aborted_file_pull_closes_source_session(self):
        def run(P):
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("s", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 0}}, MSG)
                client = P.ClusterClient(nodes["n1"])
                for i in range(10):
                    client.index("s", str(i), {"msg": f"doc {i}"})
                primary = nodes["n1"]._primary_node("s", 0)
                nodes[primary].shards[("s", 0)].flush()
                scheme = P.d.ActionBlackhole(
                    ["internal:index/shard/recovery/files/chunk"],
                    max_block_s=30).apply_to(hub)
                try:
                    bump_replicas(P, nodes["n1"], "s")
                    wait_started(nodes, "s")
                finally:
                    scheme.remove()
                replica = next(n for n in nodes.values()
                               if n.node_id != primary)
                shard = replica.shards[("s", 0)]
                shard.refresh()
                return (nodes[primary]._recovery_sessions, shard.num_docs,
                        shard_view(replica))

        sessions, num_docs, _ = check_both(run)
        assert sessions == {} and num_docs == 10

    def test_fd_tick_republishes_to_lagging_follower(self):
        def run(P):
            hub, nodes = cluster(P)
            with closing(nodes):
                bh = P.d.ActionBlackhole(["internal:cluster/coordination/*"],
                                         dst=["n3"], max_block_s=5
                                         ).apply_to(hub)
                try:
                    nodes["n1"].create_index("lag", {"index": {
                        "number_of_shards": 1, "number_of_replicas": 0}})
                finally:
                    bh.remove()
                before = ("lag" in nodes["n2"].indices_meta,
                          "lag" in nodes["n3"].indices_meta,
                          nodes["n3"].state_version
                          < nodes["n1"].state_version)
                nodes["n1"].check_nodes()
                return before, (nodes["n3"].state_version
                                == nodes["n1"].state_version,
                                "lag" in nodes["n3"].indices_meta)

        assert check_both(run) == ((True, False, True), (True, True))

    def test_unreported_replica_failure_fails_the_write(self):
        # a 1 s request deadline (FAST's is 3 s) bounds the eight
        # blackholed fail-shard reports to about 8 s
        def run(P):
            hub, nodes = cluster(P, ("n1", "n2", "n3"),
                                 **{"transport.request.timeout": "1s"})
            with closing(nodes):
                nodes["n1"].create_index("ur", {"index": {
                    "number_of_shards": 3, "number_of_replicas": 1}}, MSG)
                wait_started(nodes, "ur")
                sid, primary = next(
                    (s, nodes["n1"]._primary_node("ur", s)) for s in range(3)
                    if nodes["n1"]._primary_node("ur", s)
                    != nodes["n1"].master_id)
                replica = next(c.node_id
                               for c in nodes[primary].routing["ur"][sid]
                               if not c.primary)
                bh_write = P.d.ActionBlackhole(
                    [WRITE_REPLICA], dst=[replica], max_block_s=30
                ).apply_to(hub)
                bh_report = P.d.ActionBlackhole(
                    [SHARD_FAILED], max_block_s=30).apply_to(hub)
                try:
                    doc_id = next(f"d{i}" for i in range(1000)
                                  if P.shard_id_for(f"d{i}", 3) == sid)
                    err = raise_type(lambda: P.ClusterClient(
                        nodes[primary]).index(
                        "ur", doc_id, {"msg": "must not ack silently"}))
                finally:
                    bh_write.remove()
                    bh_report.remove()
                return err

        name, reason = check_both(run)
        assert name == "ElasticsearchTpuException"
        assert "not fully replicated" in reason

    def test_partial_replica_not_promoted_shard_goes_red(self):
        def run(P):
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("red", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 1}}, MSG)
                wait_started(nodes, "red")
                primary = nodes["n1"]._primary_node("red", 0)
                replica_node = "n2" if primary == "n1" else "n1"
                P.ClusterClient(nodes[primary]).index("red", "1",
                                                      {"msg": "kept"})
                bh = P.d.ActionBlackhole(["internal:index/shard/recovery/*"],
                                         max_block_s=30).apply_to(hub)
                try:
                    master = nodes[nodes["n1"].master_id]

                    def demote():
                        for c in master.routing["red"][0]:
                            if c.node_id == replica_node:
                                c.state = "INITIALIZING"
                    master._submit_state_update(demote)
                    hub.disconnect(primary)
                    survivor = nodes[replica_node]
                    for _ in range(10):
                        try:
                            survivor.check_master()
                            survivor.check_nodes()
                        except Exception:  # noqa: BLE001
                            pass
                        if survivor.is_master and primary not in \
                                survivor.known_nodes:
                            break
                        time.sleep(0.05)
                    red_primaries = [c.node_id for c in survivor.routing.get(
                        "red", {}).get(0, []) if c.primary]
                    try:
                        P.ClusterClient(survivor).index("red", "2",
                                                        {"msg": "x"})
                        write_err = None
                    except P.errors.ElasticsearchTpuException as e:
                        write_err = type(e).__name__
                    res = P.ClusterClient(survivor).search(
                        "red", {"query": {"match_all": {}}})
                    failed = res["_shards"]["failed"]
                finally:
                    bh.remove()
                hub.heal()
                nodes[primary].join(replica_node if survivor.is_master
                                    else survivor.master_id)
                for _ in range(40):
                    try:
                        next(n for n in nodes.values()
                             if n.is_master).reroute()
                    except Exception:  # noqa: BLE001
                        pass
                    copies = survivor.routing.get("red", {}).get(0, [])
                    if any(c.primary and c.state == "STARTED"
                           for c in copies):
                        break
                    time.sleep(0.05)
                client = P.ClusterClient(survivor)
                client.refresh("red")
                back = client.search("red", {"query": {"match": {
                    "msg": "kept"}}})
                return (primary, red_primaries, write_err, failed,
                        back["hits"]["total"])

        primary, red_primaries, write_err, failed, back = check_both(run)
        assert red_primaries == [primary] and write_err is not None
        assert failed >= 1 and back == 1

    def test_stale_term_write_rejected_under_disruption(self):
        def run(P):
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("t", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 0}})
                primary = nodes["n1"]._primary_node("t", 0)
                nodes[primary].shards[("t", 0)].primary_term = 7
                return raise_type(lambda: nodes["n1"].transport.send_request(
                    primary, WRITE_PRIMARY,
                    {"op": "index", "index": "t", "shard": 0, "id": "x",
                     "source": {"v": 1}, "routing": None,
                     "wait_for_active_shards": None, "term": 1}))

        name, reason = check_both(run)
        assert name == "ShardNotPrimaryException" and "too old" in reason


class TestCatRecovery:
    def test_peer_recovery_progress_recorded_and_rendered(self):
        def run(P):
            P.mn.clear_recovery_progress()
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("catrec", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 0}}, MSG)
                client = P.ClusterClient(nodes["n1"])
                for i in range(15):
                    client.index("catrec", str(i), {"msg": f"doc {i}"})
                primary = nodes["n1"]._primary_node("catrec", 0)
                nodes[primary].shards[("catrec", 0)].flush()
                bump_replicas(P, nodes["n1"], "catrec")
                wait_started(nodes, "catrec")
                rows = recovery_rows(P, "catrec")
            P.mn.clear_recovery_progress()
            return primary, rows

        primary, rows = check_both(run)
        (row,) = [r for r in rows if r["type"] == "peer"]
        assert row["stage"] == "done" and row["source"] == primary
        assert row["target"] != primary and row["files_total"] >= 1
        assert row["files_recovered"] == row["files_total"]
        assert row["bytes_recovered"] >= row["bytes_total"] >= 1

    def test_rows_render_through_cat_recovery(self):
        """The REST renderer shows the peer rows as the JAX one does
        (percentages, source and target; not the times)."""
        from torch_pair import NodePair

        def run(P):
            P.mn.clear_recovery_progress()
            hub, nodes = cluster(P, ("n1", "n2"))
            with closing(nodes):
                nodes["n1"].create_index("catrec", {"index": {
                    "number_of_shards": 1, "number_of_replicas": 1}}, MSG)
                client = P.ClusterClient(nodes["n1"])
                for i in range(5):
                    client.index("catrec", str(i), {"msg": f"doc {i}"})
                wait_started(nodes, "catrec")

        both(run, parallel=False)
        pair = NodePair()
        try:
            (js, jrows), (ts, trows) = pair.call(
                "GET", "/_cat/recovery", params={"format": "json"})
            assert js == ts == 200
            strip = [[{k: v for k, v in r.items() if k != "time"}
                      for r in rows if r["index"] == "catrec"]
                     for rows in (jrows, trows)]
            assert_same(*strip)
            assert [r["type"] for r in strip[1]] == ["peer"]
            assert strip[1][0]["translog_ops_percent"] == "100.0%"
        finally:
            pair.close()
            for P in (JAX, PORT):
                P.mn.clear_recovery_progress()


@pytest.mark.slow
class TestDisruptionConvergence:
    """30% drop + 200ms delay on every link: publish, master failover and
    replica recovery still converge on both packages."""

    @staticmethod
    def _retry(P, fn, attempts=30):
        last = None
        for _ in range(attempts):
            try:
                return fn()
            except P.ShardNotPrimaryException:
                raise
            except Exception as e:  # noqa: BLE001 — disruption bites
                last = e
                time.sleep(0.1)
        raise last

    def test_publish_and_recovery_converge_under_drop_delay(self):
        def run(P):
            hub, nodes = cluster(P)
            with closing(nodes):
                drop = P.d.NetworkDrop(0.3, seed=1234).apply_to(hub)
                delay = P.d.NetworkDelay(0.2).apply_to(hub)
                try:
                    self._retry(P, lambda: nodes["n1"].create_index(
                        "logs", {"index": {"number_of_shards": 2,
                                           "number_of_replicas": 1}}, MSG))
                    client = P.ClusterClient(nodes["n1"])
                    for i in range(10):
                        self._retry(P, lambda i=i: client.index(
                            "logs", str(i), {"msg": f"event {i}"}))
                    wait_started(nodes, "logs", attempts=240)
                    converge(nodes, attempts=120)
                finally:
                    drop.remove()
                    delay.remove()
                client.refresh("logs")
                res = client.search("logs", {"query": {"match": {
                    "msg": "event"}}, "size": 40})
                return res["hits"]["total"], drop.dropped >= 1

        assert check_both(run, timeout=600) == (10, True)

    def test_master_failover_converges_under_drop_delay(self):
        def run(P):
            hub, nodes = cluster(P)
            with closing(nodes):
                drop = P.d.NetworkDrop(0.3, seed=1234).apply_to(hub)
                delay = P.d.NetworkDelay(0.2).apply_to(hub)
                try:
                    self._retry(P, lambda: nodes["n1"].create_index(
                        "logs", {"index": {"number_of_shards": 2,
                                           "number_of_replicas": 1}}, MSG))
                    client = P.ClusterClient(nodes["n1"])
                    for i in range(8):
                        self._retry(P, lambda i=i: client.index(
                            "logs", str(i), {"msg": f"event {i}"}))
                    wait_started(nodes, "logs", attempts=120)
                    old_terms = dict(nodes["n2"].primary_terms)
                    hub.disconnect("n1")
                    survivors = {k: v for k, v in nodes.items() if k != "n1"}
                    master = converge(survivors, attempts=80)
                    moved = {k for k, t in survivors[master]
                             .primary_terms.items()
                             if t > old_terms.get(k, 1)}
                    (idx, sid) = next(iter(sorted(moved)))
                    new_primary = next(
                        c.node_id for c in survivors[master].routing[idx][sid]
                        if c.primary)
                    stale = raise_type(lambda: self._retry(
                        P, lambda: survivors[master].transport.send_request(
                            new_primary, WRITE_PRIMARY,
                            {"op": "index", "index": idx, "shard": sid,
                             "id": "stale", "source": {"msg": "stale"},
                             "routing": None,
                             "wait_for_active_shards": None,
                             "term": old_terms[(idx, sid)]})))
                    sc = P.ClusterClient(survivors[master])

                    def refresh_and_search():
                        sc.refresh("logs")
                        res = sc.search("logs", {"query": {"match": {
                            "msg": "event"}}, "size": 40})
                        if res["_shards"]["failed"] or \
                                res["hits"]["total"] < 8:
                            raise P.errors.NodeNotConnectedException(
                                "partial result")
                        return res

                    total = self._retry(P, refresh_and_search)["hits"]["total"]
                finally:
                    drop.remove()
                    delay.remove()
                return master in ("n2", "n3"), stale[0], total

        assert check_both(run, timeout=600) == (
            True, "ShardNotPrimaryException", 8)
