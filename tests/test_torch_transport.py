"""The port's transport (``transport/local.py``) against the JAX package's.

``tests/test_disruption.py``'s ``TestRetryPolicy`` and
``TestTransportResilience`` case for case: the same services on a hub,
the same injected faults, then the responses, the raised error types and
the services' counters held equal; and ``aggregate_transport_stats``,
the ``transport`` block of ``_nodes/stats``.
"""

import threading
import time

from torch_cluster_pair import PORT, check_both, closing, start_cluster


def drop_first_n(P, n, **filters):
    """A deterministic transient fault: the first ``n`` matching
    deliveries are dropped, then everything passes."""

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


def pair(P):
    hub = P.TransportHub()
    a = P.TransportService("a", hub)
    b = P.TransportService("b", hub)
    b.register_handler("act", lambda payload, src: {"ok": True})
    return hub, a, b


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is the result
        return type(e).__name__
    return None


class TestRetryPolicy:
    def test_backoff_sequence_and_cap(self):
        def run(P):
            p = P.RetryPolicy(max_attempts=5, initial_backoff=0.1,
                              backoff_multiplier=2.0, max_backoff=0.5)
            return [p.backoff(i) for i in range(4)]

        assert check_both(run, parallel=False) == [0.1, 0.2, 0.4, 0.5]

    def test_classification(self):
        def run(P):
            p = P.RetryPolicy()
            e = P.errors
            return [p.is_retryable(x) for x in (
                e.NodeNotConnectedException("x"),
                e.ReceiveTimeoutTransportException("x"),
                P.RemoteActionException("handler blew up"),
                ValueError("x"),
                e.ConnectTransportException("x"),
                e.EsRejectedExecutionException("x"))]

        assert check_both(run, parallel=False) == [True, True, False, False,
                                                   False, True]

    def test_derive_keeps_the_other_fields(self):
        def run(P):
            p = P.RetryPolicy(max_attempts=4, initial_backoff=0.02,
                              max_backoff=0.2).derive(overall_timeout=0.6)
            return (p.max_attempts, p.initial_backoff, p.backoff_multiplier,
                    p.max_backoff, p.overall_timeout)

        assert check_both(run, parallel=False) == (4, 0.02, 2.0, 0.2, 0.6)


class TestTransportResilience:
    def test_transient_drop_retried_and_counted(self):
        def run(P):
            hub, a, b = pair(P)
            drop_first_n(P, 2, actions=["act"]).apply_to(hub)
            resp = a.send_request("b", "act", {}, retry=P.RetryPolicy(
                max_attempts=4, initial_backoff=0.01))
            return resp, dict(a.stats)

        resp, stats = check_both(run)
        assert resp == {"ok": True}
        assert stats["retries"] == 2 and stats["failures"] == 2

    def test_retry_exhaustion_raises_last_error(self):
        def run(P):
            hub, a, b = pair(P)
            drop_first_n(P, 10, actions=["act"]).apply_to(hub)
            err = raised(lambda: a.send_request(
                "b", "act", {}, retry=P.RetryPolicy(
                    max_attempts=3, initial_backoff=0.01)))
            return err, dict(a.stats)

        err, stats = check_both(run)
        assert err == "NodeNotConnectedException" and stats["failures"] == 3

    def test_timeout_on_unresponsive_node(self):
        def run(P):
            hub, a, b = pair(P)
            scheme = P.d.UnresponsiveNode("b", max_block_s=5).apply_to(hub)
            t0 = time.monotonic()
            err = raised(lambda: a.send_request("b", "act", {}, timeout=0.2))
            quick = time.monotonic() - t0 < 2.0
            scheme.remove()
            return err, quick, a.stats["timeouts"], \
                a.send_request("b", "act", {})

        assert check_both(run) == ("ReceiveTimeoutTransportException", True,
                                   1, {"ok": True})

    def test_fast_fail_after_threshold_and_heal(self):
        def run(P):
            hub = P.TransportHub()
            a = P.TransportService("a", hub, health=P.ConnectionHealth(
                failure_threshold=3, quarantine_s=30.0))
            b = P.TransportService("b", hub)
            b.register_handler("act", lambda payload, src: {"ok": True})
            hub.disconnect("a", "b")
            errs = [raised(lambda: a.send_request("b", "act", {}))
                    for _ in range(3)]
            wire_before = len(hub.requests_log)
            errs.append(raised(lambda: a.send_request("b", "act", {})))
            off_wire = len(hub.requests_log) == wire_before
            hub.heal()
            return errs, off_wire, a.stats["fast_fails"], \
                a.send_request("b", "act", {})

        errs, off_wire, fast_fails, resp = check_both(run)
        assert errs == ["NodeNotConnectedException"] * 3 + [
            "ConnectTransportException"]
        assert off_wire and fast_fails == 1 and resp == {"ok": True}

    def test_one_way_partition(self):
        def run(P):
            hub, a, b = pair(P)
            a.register_handler("act", lambda payload, src: {"ok": "a"})
            P.d.NetworkPartition(["a"], ["b"], one_way=True).apply_to(hub)
            return (raised(lambda: a.send_request("b", "act", {})),
                    b.send_request("a", "act", {}))

        assert check_both(run) == ("NodeNotConnectedException", {"ok": "a"})

    def test_delay_scheme_applies(self):
        def run(P):
            hub, a, b = pair(P)
            P.d.NetworkDelay(0.15, dst=["b"]).apply_to(hub)
            t0 = time.monotonic()
            resp = a.send_request("b", "act", {})
            return resp, time.monotonic() - t0 >= 0.15

        assert check_both(run) == ({"ok": True}, True)

    def test_drop_scheme_is_seeded_deterministic(self):
        def run(P):
            def draws(d):
                out = []
                for _ in range(20):
                    try:
                        d.disrupt("a", "b", "act")
                        out.append(False)
                    except P.errors.NodeNotConnectedException:
                        out.append(True)
                return out

            return (draws(P.d.NetworkDrop(0.5, seed=42)),
                    draws(P.d.NetworkDrop(0.5, seed=1)))

        a, b = check_both(run, parallel=False)
        assert any(a) and any(b)

    def test_action_filters_match_exact_names_first(self):
        def run(P):
            s = P.d.DisruptionScheme(actions=["indices:data/write/bulk[s][r]"],
                                     dst=["b"])
            return [s.applies("a", "b", "indices:data/write/bulk[s][r]"),
                    s.applies("a", "b", "indices:data/write/bulk[s][p]"),
                    s.applies("a", "c", "indices:data/write/bulk[s][r]")]

        assert check_both(run, parallel=False) == [True, False, False]


def test_transport_stats_aggregate_live_services():
    """``aggregate_transport_stats`` sums the live services' counters: a
    three-node port cluster adds three services, and its retried
    publishes show in ``retries``."""
    hub, nodes = start_cluster(PORT, ["s1", "s2", "s3"])
    with closing(nodes):
        drop_first_n(PORT, 1, actions=["internal:cluster/coordination/*"]
                     ).apply_to(hub)
        nodes["s1"].create_index("st", {"index": {"number_of_shards": 1,
                                                  "number_of_replicas": 1}})
        after = PORT.aggregate_transport_stats()
        assert set(after) == {"services", "requests_sent", "retries",
                              "timeouts", "fast_fails", "failures"}
        assert after["services"] >= 3
        assert after["retries"] >= sum(
            n.transport.stats["retries"] for n in nodes.values()) >= 1
        assert after["requests_sent"] >= sum(
            n.transport.stats["requests_sent"] for n in nodes.values())


def test_nodes_stats_transport_block_counts_the_cluster():
    """``_nodes/stats``' ``transport`` block is the process-wide sum: a
    port ``Node`` beside a live port cluster reports its services and
    requests."""
    from elasticsearch_tpu_torch.node import Node

    hub, nodes = start_cluster(PORT, ["u1", "u2"])
    node = Node(device="cpu")
    with closing(nodes):
        try:
            block = node.node_stats()["nodes"][node.node_id]["transport"]
            assert block["services"] >= 2
            assert block["requests_sent"] >= sum(
                n.transport.stats["requests_sent"] for n in nodes.values())
            assert block == {k: block[k] for k in (
                "services", "requests_sent", "retries", "timeouts",
                "fast_fails", "failures")}
        finally:
            node.close()
