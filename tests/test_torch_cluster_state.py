"""The cluster state: the port's ``cluster/state.py`` against the JAX
package's, and the cluster APIs over REST.

- ``ClusterState.resolve_index_names`` over seeded sets of indices and
  aliases and seeded expressions (names, aliases, wildcards over both,
  comma lists, ``_all``, missing names): the same names in the same order,
  or the same 404.
- ``to_dict``, ``routing_table``, ``cluster_health`` (closed indices
  drop out) and ``ClusterService``'s appliers and listeners agree.
- ``_cluster/state[/{metrics}]``, ``_cluster/stats``, ``_cluster/health``,
  ``_nodes`` and ``_nodes/stats`` over REST (``torch_pair.NodePair``):
  bodies equal after dropping the volatile keys and naming each node
  ``<node>``; ``_nodes/stats`` holds the JAX package's sections but
  ``compile`` and ``transport``, which wait for their modules. Mirrors
  ``tests/test_rest.py``'s ``test_cluster_state_and_stats`` and
  ``test_nodes``.
"""

import itertools

import numpy as np
import pytest

from elasticsearch_tpu.cluster import state as jstate
from elasticsearch_tpu.common.errors import (
    ElasticsearchTpuException as JError,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu_torch.cluster import state as tstate
from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.common.settings import Settings
from torch_pair import NodePair

NAMES = ["logs-a", "logs-b", "logs-c", "metrics-1", "kibana", "other"]
ALIASES = ["logs", "kib", "all", "m"]


def build(mod, settings_cls, seed):
    """The same random metadata in either package's ClusterState."""
    rng = np.random.default_rng(seed)
    indices = {}
    for name in NAMES:
        if rng.random() < 0.2:
            continue
        aliases = {a: ({"filter": {"term": {"k": a}}} if rng.random() < 0.3
                       else {}) for a in ALIASES if rng.random() < 0.35}
        indices[name] = mod.IndexMetadata(
            name, settings_cls({"index.number_of_shards":
                                int(rng.integers(1, 4)),
                                "index.number_of_replicas":
                                int(rng.integers(0, 2))}),
            {"properties": {}}, aliases,
            state="close" if rng.random() < 0.2 else "open")
    node = mod.DiscoveryNode("n1", "node-0", "127.0.0.1:9300")
    return mod.ClusterState("c", indices=indices, nodes={"n1": node},
                            master_node_id="n1")


def expressions(seed):
    rng = np.random.default_rng(seed + 1000)
    atoms = NAMES + ALIASES + ["logs-*", "*-1", "k*", "l*", "nope", "_all",
                               "*", "zz*"]
    out = list(atoms)
    for _ in range(25):
        k = int(rng.integers(2, 4))
        out.append(",".join(str(a) for a in rng.choice(atoms, size=k)))
    return out


def resolve(state, expr, err):
    try:
        return state.resolve_index_names(expr)
    except err as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(8))
def test_resolve_index_names_agrees(seed):
    js = build(jstate, JSettings, seed)
    ts = build(tstate, Settings, seed)
    for expr in expressions(seed):
        assert resolve(js, expr, JError) == resolve(
            ts, expr, ElasticsearchTpuException), expr


@pytest.mark.parametrize("seed", range(4))
def test_to_dict_routing_and_health_agree(seed):
    js = build(jstate, JSettings, seed)
    ts = build(tstate, Settings, seed)
    assert js.to_dict() == ts.to_dict()
    assert ({n: [s.to_dict() for s in shards]
             for n, shards in js.routing_table().items()}
            == {n: [s.to_dict() for s in shards]
                for n, shards in ts.routing_table().items()})
    assert jstate.cluster_health(js) == tstate.cluster_health(ts)
    assert js.copy().version == ts.copy().version == 1


def test_cluster_service_appliers_then_listeners():
    calls = {}
    for mod, settings_cls in ((jstate, JSettings), (tstate, Settings)):
        log = []
        svc = mod.ClusterService(build(mod, settings_cls, 0))
        svc.add_applier(lambda old, new: log.append(
            ("applier", old.version, new.version)))
        svc.add_listener(lambda new: log.append(("listener", new.version)))
        svc.submit_state_update_task("noop", lambda s: s)
        new = svc.submit_state_update_task("bump", lambda s: s.copy())
        svc.submit_state_update_task("bump", lambda s: s.copy())
        assert svc.state.version == new.version + 1
        calls[mod.__name__] = log
    assert list(calls.values())[0] == list(calls.values())[1] == [
        ("applier", 0, 1), ("listener", 1), ("applier", 1, 2),
        ("listener", 2)]


@pytest.fixture()
def pair():
    p = NodePair({"cluster.name": "test-cluster"})
    for name, shards in (("idx", 2), ("logs-a", 1)):
        p.same("PUT", f"/{name}", {"settings": {"number_of_shards": shards,
                                                "refresh_interval": "-1"}})
    p.same("PUT", "/idx/_doc/1", {"a": 1}, params={"refresh": "true"})
    p.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "logs-a", "alias": "logs", "routing": "2"}}]})
    p.same("PUT", "/_template/t", {"index_patterns": ["z-*"], "order": 2})
    p.same("PUT", "/_cluster/settings", {"persistent": {
        "search.max_buckets": 100}, "transient": {"search": {
            "default_search_timeout": "5s"}}})
    yield p
    p.close()


@pytest.mark.parametrize("path", [
    "/_cluster/state", "/_cluster/state/metadata", "/_cluster/stats",
    "/_cluster/health", "/_nodes", "/_nodes/_local"])
def test_cluster_apis(pair, path):
    pair.same("GET", path)


def test_cluster_state_and_stats(pair):
    r = pair.same("GET", "/_cluster/state")
    assert set(r["metadata"]["indices"]) == {"idx", "logs-a"}
    assert r["metadata"]["indices"]["logs-a"]["aliases"] == {
        "logs": {"routing": "2"}}
    assert r["metadata"]["cluster_settings"]["transient"] == {
        "search": {"default_search_timeout": "5s"}}
    r = pair.same("GET", "/_cluster/stats")
    assert r["indices"]["count"] == 2 and r["indices"]["docs"]["count"] == 1
    pair.same("POST", "/idx/_close")
    r = pair.same("GET", "/_cluster/state")
    assert r["metadata"]["indices"]["idx"]["state"] == "close"
    pair.same("GET", "/_cluster/health")


@pytest.mark.parametrize("path", ["/_nodes/stats", "/_nodes/stats/indices",
                                  "/_nodes/_local/stats/indices/search"])
def test_nodes_stats_sections(pair, path):
    pair.same("POST", "/idx/_search", {"query": {"match_all": {}}})
    (js, jb), (ts, tb) = pair.call("GET", path)
    assert js == ts == 200
    assert list(tb["nodes"]) == ["<node>"]
    jn, tn = jb["nodes"]["<node>"], tb["nodes"]["<node>"]
    assert set(jn) == set(tn)
    # the transport counters, summed over each package's live services
    assert set(tn["transport"]) == set(jn["transport"]) == {
        "services", "requests_sent", "retries", "timeouts", "fast_fails",
        "failures"}
    assert all(isinstance(v, int) and v >= 0
               for v in tn["transport"].values())
    assert tn["indices"]["docs"] == jn["indices"]["docs"] == {"count": 1}
    assert set(tn["breakers"]) == set(jn["breakers"])
    for section in ("os", "process", "fs"):
        assert set(tn[section]) == set(jn[section]), section
    for block in ("compile", "phases", "admission", "integrity"):
        assert set(tn["indices"]["search"][block]) == set(
            jn["indices"]["search"][block]), block
    assert set(tn["indices"]["search"]["memory"]) == set(
        jn["indices"]["search"]["memory"])
    assert tn["name"] == jn["name"]


def test_node_info_settings(pair):
    r = pair.same("GET", "/_nodes")
    (node,) = r["nodes"].values()
    assert node["settings"] == {"cluster": {"name": "test-cluster"}}
    assert node["plugins"] == []


def test_state_version_moves_with_each_update(pair):
    versions = []
    for step in itertools.count():
        versions.append((pair.j.cluster_service.state.version,
                         pair.t.cluster_service.state.version))
        if step == 3:
            break
        pair.same("PUT", f"/v{step}")
    assert all(j == t for j, t in versions)
    assert versions[-1][0] == versions[0][0] + 3
