"""Both packages' in-process clusters side by side, for the cluster tests.

``JAX`` and ``PORT`` are namespaces with the same names over each
package's cluster modules (``ClusterNode``, ``ClusterClient``,
``TransportHub``, the allocation functions, the disruption schemes, the
errors), so one scenario function ``fn(P)`` drives either. ``P.node``
builds a ``ClusterNode``, on the CPU for the port. ``both(fn)`` runs the
scenario for each package, on two threads at once (their hubs, registries
and recovery rows are separate), and returns ``(jax result, port
result)``; ``assert_same`` holds the two results equal, floats within
rtol 1e-5 and hit lists through ``assert_same_hits`` (ties in any order).
Every scenario closes the nodes it makes (``closing``).
"""

import contextlib
import threading
import types

import numpy as np

import elasticsearch_tpu.cluster.allocation as j_allocation
import elasticsearch_tpu.cluster.multinode as j_multinode
import elasticsearch_tpu.cluster.response_collector as j_rc
import elasticsearch_tpu.cluster.state as j_state
import elasticsearch_tpu.common.errors as j_errors
import elasticsearch_tpu.common.integrity as j_integrity
import elasticsearch_tpu.common.settings as j_settings
import elasticsearch_tpu.index.shard as j_shard
import elasticsearch_tpu.index.store as j_store
import elasticsearch_tpu.testing.disruption as j_disruption
import elasticsearch_tpu.transport.local as j_local
import elasticsearch_tpu.utils.murmur3 as j_murmur3
import elasticsearch_tpu_torch.cluster.allocation as t_allocation
import elasticsearch_tpu_torch.cluster.multinode as t_multinode
import elasticsearch_tpu_torch.cluster.response_collector as t_rc
import elasticsearch_tpu_torch.cluster.state as t_state
import elasticsearch_tpu_torch.common.errors as t_errors
import elasticsearch_tpu_torch.common.integrity as t_integrity
import elasticsearch_tpu_torch.common.settings as t_settings
import elasticsearch_tpu_torch.index.shard as t_shard
import elasticsearch_tpu_torch.index.store as t_store
import elasticsearch_tpu_torch.testing.disruption as t_disruption
import elasticsearch_tpu_torch.transport.local as t_local
import elasticsearch_tpu_torch.utils.murmur3 as t_murmur3
from test_torch_rest import RTOL, assert_same_hits


def _namespace(name, mn, alloc, rc, state, errors, integrity, settings,
               shard, store, disruption, local, murmur3, node_kw):
    def node(node_name, hub, **kw):
        return mn.ClusterNode(node_name, hub, **{**node_kw, **kw})

    return types.SimpleNamespace(
        name=name, mn=mn, node=node, ClusterNode=mn.ClusterNode,
        ClusterClient=mn.ClusterClient,
        TransportHub=local.TransportHub,
        TransportService=local.TransportService,
        ConnectionHealth=local.ConnectionHealth,
        RetryPolicy=local.RetryPolicy,
        RemoteActionException=local.RemoteActionException,
        aggregate_transport_stats=local.aggregate_transport_stats,
        allocate=alloc.allocate, apply_command=alloc.apply_command,
        RerouteException=alloc.RerouteException,
        routing_to_dict=alloc.routing_to_dict,
        routing_from_dict=alloc.routing_from_dict,
        ResponseCollectorService=rc.ResponseCollectorService,
        ShardRouting=state.ShardRouting,
        ShardRoutingState=state.ShardRoutingState,
        IndexMetadata=state.IndexMetadata, Settings=settings.Settings,
        errors=errors, integrity_service=integrity.integrity_service,
        ShardNotPrimaryException=shard.ShardNotPrimaryException,
        CorruptIndexException=store.CorruptIndexException,
        MARKER_PREFIX=store.MARKER_PREFIX, d=disruption,
        shard_id_for=murmur3.shard_id_for)


JAX = _namespace("jax", j_multinode, j_allocation, j_rc, j_state, j_errors,
                 j_integrity, j_settings, j_shard, j_store, j_disruption,
                 j_local, j_murmur3, {})
PORT = _namespace("port", t_multinode, t_allocation, t_rc, t_state,
                  t_errors, t_integrity, t_settings, t_shard, t_store,
                  t_disruption, t_local, t_murmur3, {"device": "cpu"})


def both(fn, parallel=True, timeout=60.0):
    """(fn(JAX), fn(PORT)); with ``parallel`` on two threads at once,
    each joined within ``timeout`` seconds."""
    if not parallel:
        return fn(JAX), fn(PORT)
    out, errs = {}, {}

    def run(P):
        try:
            out[P.name] = fn(P)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs[P.name] = e

    threads = [threading.Thread(target=run, args=(P,), daemon=True,
                                name=f"scenario-{P.name}")
               for P in (JAX, PORT)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"{t.name} did not finish in {timeout} s"
    for name in ("jax", "port"):
        if name in errs:
            raise errs[name]
    return out["jax"], out["port"]


def assert_same(j, t, where="result"):
    """Equal, floats within RTOL, a ``hits`` list tie-group aware."""
    if isinstance(j, dict) and isinstance(t, dict):
        assert set(j) == set(t), (where, sorted(j), sorted(t))
        for k in j:
            if k == "hits" and isinstance(j[k], list) \
                    and isinstance(t[k], list):
                assert len(j[k]) == len(t[k]), (where, j[k], t[k])
                assert_same_hits(j[k], t[k], f"{where}.hits")
            else:
                assert_same(j[k], t[k], f"{where}.{k}")
    elif isinstance(j, (list, tuple)) and isinstance(t, (list, tuple)):
        assert len(j) == len(t), (where, j, t)
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(j, float) and isinstance(t, float):
        np.testing.assert_allclose(t, j, rtol=RTOL, err_msg=where)
    else:
        assert j == t, (where, j, t)


def check_both(fn, parallel=True, timeout=60.0):
    """Run ``fn`` on both packages and hold the results equal."""
    j, t = both(fn, parallel=parallel, timeout=timeout)
    assert_same(j, t)
    return t


@contextlib.contextmanager
def closing(nodes):
    """Close every node at the end, gracefully only where asked."""
    try:
        yield nodes
    finally:
        for n in (nodes.values() if isinstance(nodes, dict) else nodes):
            n.close(graceful=False)


def start_cluster(P, names, hub=None, **kw):
    """Nodes ``names`` on one hub, the first bootstrapped, the rest
    joined through it."""
    hub = hub or P.TransportHub(strict_serialization=True)
    nodes = {n: P.node(n, hub, **kw) for n in names}
    nodes[names[0]].bootstrap_cluster()
    for n in names[1:]:
        nodes[n].join(names[0])
    return hub, nodes


def routing_view(routing):
    """A routing table as plain, ordered data."""
    return {index: {int(sid): [(c.node_id, c.primary, c.state,
                                getattr(c, "relocating_to", None))
                               for c in copies]
                    for sid, copies in sorted(shards.items())}
            for index, shards in sorted(routing.items())}


def shard_view(node):
    """Every local copy's role, term, seqno stats and live docs."""
    out = {}
    for (index, sid), shard in sorted(node.shards.items()):
        docs = {}
        for seg in shard.engine.segments:
            for local in np.flatnonzero(seg.live[: seg.num_docs]):
                local = int(local)
                docs[seg.doc_ids[local]] = (int(seg.seqnos[local]),
                                            int(seg.versions[local]))
        out[f"{index}#{sid}"] = {
            "primary": bool(shard.primary),
            "term": int(shard.primary_term),
            "state": shard.state,
            "seq_no": shard.seq_no_stats(),
            "docs": docs,
        }
    return out


def search_view(resp):
    """A cluster search answer without its timing."""
    return {k: v for k, v in resp.items() if k != "took"}


def recovery_rows(P, index=None):
    """The peer-recovery rows of ``_cat/recovery`` without their times."""
    rows = P.mn.recovery_progress_rows()
    return sorted(
        ({k: v for k, v in r.items() if k not in ("start_ms", "stop_ms")}
         for r in rows if index is None or r["index"] == index),
        key=lambda r: (r["index"], r["shard"], r["target"]))
