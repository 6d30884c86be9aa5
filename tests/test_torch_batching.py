"""The port's micro-batcher: ``MicroBatcher`` and ``batchable_body``, the
same cases as tests/test_query_batching.py's TestMicroBatcher, plus a
threaded burst through ``Node.search`` whose members must equal their
serial responses."""

import sys
import threading
import time

import numpy as np

from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.batching import (
    BatchStats,
    MicroBatcher,
    batchable_body,
)


def test_no_concurrency_goes_direct():
    stats = BatchStats()
    mb = MicroBatcher(window_s=0.5, max_queries=8, stats=stats)
    t0 = time.monotonic()
    out = mb.run("k", 1, single_fn=lambda x: x * 10,
                 batch_fn=lambda items: [x * 100 for x in items])
    assert out == 10
    assert time.monotonic() - t0 < 0.25  # no window paid
    assert stats.as_dict()["batch_window_waits_total"] == 0


def test_concurrent_submissions_batch():
    stats = BatchStats()
    mb = MicroBatcher(window_s=0.3, max_queries=8, stats=stats)
    start = threading.Barrier(3)
    results = {}

    def slow_single(x):
        # hold the in-flight slot so the other two submissions overlap
        time.sleep(0.15)
        return ("single", x)

    def worker(i):
        start.wait()
        results[i] = mb.run(
            "k", i, single_fn=slow_single,
            batch_fn=lambda items: [("batch", x) for x in items])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    kinds = sorted(kind for kind, _ in results.values())
    assert kinds.count("batch") >= 2
    for i in range(3):
        assert results[i][1] == i
    assert stats.as_dict()["batch_window_waits_total"] == 1


def test_full_group_seals_at_max_queries():
    mb = MicroBatcher(window_s=5.0, max_queries=2)
    blocker = threading.Event()
    results = {}

    def occupy():
        mb.run("other", 0, single_fn=lambda x: blocker.wait(5.0),
               batch_fn=lambda items: [None for _ in items])

    def worker(i):
        results[i] = mb.run(
            "k", i, single_fn=lambda x: ("single", x),
            batch_fn=lambda items: [("batch", x) for x in items])

    t0 = threading.Thread(target=occupy)
    t0.start()
    time.sleep(0.05)  # occupy() holds the in-flight slot
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    blocker.set()
    t0.join(10.0)
    assert not t0.is_alive()
    # the full group dispatched without waiting out the 5 s window
    assert time.monotonic() - t_start < 4.0
    assert results == {0: ("batch", 0), 1: ("batch", 1)}


def test_member_exception_isolated():
    mb = MicroBatcher(window_s=0.2, max_queries=4)
    start = threading.Barrier(2)
    outcomes = {}

    def batch_fn(items):
        return [ValueError(f"boom-{x}") if x == 1 else ("ok", x)
                for x in items]

    def worker(i):
        start.wait()
        try:
            outcomes[i] = mb.run("k", i, single_fn=lambda x: ("ok", x),
                                 batch_fn=batch_fn)
        except ValueError as e:
            outcomes[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    # member 1's error (if it rode the batch) is its own; member 0 is intact
    assert outcomes[0] == ("ok", 0)
    assert isinstance(outcomes[1], ValueError) or outcomes[1] == ("ok", 1)


def test_stress_every_member_gets_its_own_result():
    """More threads than cores with a short switch interval: no result is
    lost or crossed between members, and nobody hangs."""
    mb = MicroBatcher(window_s=0.002, max_queries=4)
    n = 48
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            results[i] = mb.run(
                "k", i, single_fn=lambda x: ("single", x),
                batch_fn=lambda items: [("batch", x) for x in items])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(n))
    assert all(results[i][1] == i for i in range(n))
    assert mb._inflight == 0 and mb._groups == {}


def test_batchable_body_filter():
    assert batchable_body({"query": {"match": {"body": "x"}}})
    assert batchable_body({"query": {"term": {"tag": "a"}},
                           "size": 3, "min_score": 0.5,
                           "aggs": {"t": {"terms": {"field": "tag"}}}})
    assert not batchable_body({})  # no query
    assert batchable_body({"query": {"match": {"b": "x"}},
                           "profile": True})
    assert not batchable_body({"query": {"match": {"b": "x"}},
                               "collapse": {"field": "tag"}})


def test_threaded_burst_through_node_equals_serial():
    node = Node(Settings({"search.batch.window_ms": 150.0}), device="cpu")
    try:
        _threaded_burst(node)
    finally:
        node.close()


def _threaded_burst(node):
    # a fixed segment layout: no scheduled refresh between the serial
    # answers and the burst
    node.create_index("b", {
        "settings": {"number_of_shards": 3, "refresh_interval": "-1"},
        "mappings": {"_doc": {"properties": {
            "body": {"type": "text", "analyzer": "whitespace"}}}}})
    rng = np.random.RandomState(4)
    vocab = [f"t{i}" for i in range(20)]
    node.bulk([("index", {"_index": "b", "_id": str(d)},
                {"body": " ".join(rng.choice(vocab, 6))})
               for d in range(150)], refresh=True)
    bodies = [{"query": {"match": {"body": f"t{i} t{(i * 7) % 20}"}},
               "size": 5} for i in range(8)]
    serial = [node.search("b", dict(b)) for b in bodies]
    start = threading.Barrier(len(bodies))
    got = {}

    def worker(i):
        start.wait()
        got[i] = node.search("b", dict(bodies[i]))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    for i, want in enumerate(serial):
        assert got[i]["_plane"] == want["_plane"] == "mesh_pallas"
        assert got[i]["hits"] == want["hits"]
    stats = node.indices["b"].batch_stats.as_dict()
    assert stats["batched_query_total"] >= 2
