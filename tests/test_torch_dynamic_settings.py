"""Dynamic index and cluster settings, ``_mapping`` PUT, ``_stats`` and
``_segments``: the port against the JAX package.

The requests go to a JAX ``Node`` and a port ``Node(device="cpu")``
through their REST controllers (``torch_pair.NodePair``) and must answer
alike. The settings registries must hold the same keys with the same
dynamic flags, and accept and refuse the same values. Mirrors
``tests/test_rest.py``'s ``test_index_settings_dynamic_update``,
``test_put_get_mapping``, ``test_stats_and_segments`` and
``test_cluster_settings``, and the settings-API steps of
``test_delta_staging.py::TestSettingsPlumbing::
test_cluster_override_and_create_seeding``, ``test_device_faults.py::
TestStagingRetrySettings::test_cluster_override_wins_and_clears`` and
``test_device_memory.py::TestBudgetDemotion::
test_budget_never_errors_over_rest``. The explicitness contract of each
cluster-level override (set: it wins on every index, the new ones too;
cleared: the index's own settings win again) is held on both nodes, and
on the port the named plane and counter move with it.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.common import settings as jsettings
from elasticsearch_tpu.common.errors import (
    ElasticsearchTpuException as JError,
)
from elasticsearch_tpu.common.memory import (
    memory_accountant as jmemory_accountant,
)
from elasticsearch_tpu.common.staging import (
    configure_staging_retry as jconfigure_staging_retry,
    staging_retry_config as jstaging_retry_config,
)
from elasticsearch_tpu_torch.common import settings as tsettings
from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.staging import (
    configure_staging_retry,
    staging_retry_config,
)
from test_torch_pruned import MAPPING as PRUNE_MAPPING
from test_torch_pruned import _docs as prune_docs
from test_torch_rest import assert_same_hits
from torch_pair import NodePair

MAPPING = {"properties": {"body": {"type": "text"}, "tag": {"type": "keyword"},
                          "n": {"type": "long"},
                          "emb": {"type": "dense_vector", "dims": 4,
                                  "similarity": "dot_product"}}}
WORDS = ["red", "green", "blue", "cyan", "plum", "teal"]


def seeded_docs(seed, n):
    rng = np.random.default_rng(seed)
    return [{"body": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 6)))),
             "tag": str(rng.choice(["x", "y", "z"])),
             "n": int(rng.integers(0, 50)),
             "emb": [round(float(v), 3) for v in rng.normal(size=4)]}
            for _ in range(n)]


def fill(pair, index, docs):
    lines = []
    for i, d in enumerate(docs):
        lines += [{"index": {"_index": index, "_id": str(i)}}, d]
    pair.same("POST", "/_bulk",
              "".join(json.dumps(x) + "\n" for x in lines).encode(),
              params={"refresh": "true"})


@pytest.fixture()
def pair():
    p = NodePair()
    yield p
    p.close()


@pytest.fixture()
def mesh_pair(pair):
    """A 2-shard mesh index on both nodes, filled with 40 seeded docs."""
    pair.same("PUT", "/m", {"settings": {
        "number_of_shards": 2, "refresh_interval": "-1",
        "search": {"mesh": True}}, "mappings": MAPPING})
    fill(pair, "m", seeded_docs(7, 40))
    return pair


class TestRegistry:
    @pytest.mark.parametrize("scope", ["cluster", "index"])
    def test_same_keys_and_flags(self, scope):
        fn = ("cluster_settings" if scope == "cluster"
              else "index_scoped_settings")
        j = getattr(jsettings, fn)()
        t = getattr(tsettings, fn)()
        assert ({k: s.dynamic for k, s in j._settings.items()}
                == {k: s.dynamic for k, s in t._settings.items()})

    @pytest.mark.parametrize("key,value", [
        ("index.refresh_interval", "30s"), ("index.refresh_interval", "-1"),
        ("index.refresh_interval", "bogus"),
        ("index.max_result_window", 0), ("index.max_result_window", 50),
        ("index.max_slices_per_scroll", 3),
        ("index.number_of_shards", 3), ("index.number_of_replicas", 2),
        ("index.staging.compact.threshold", 0.5),
        ("index.staging.delta.enabled", "false"),
        ("index.search.aggs.fused", "maybe"),
        ("index.translog.durability", "async"), ("index.nope", 1),
        ("search.pallas.pruning.probe_tiles", 3),
        ("search.pallas.pruning.probe_tiles", 16),
        ("search.knn.tile_sub", 24), ("search.queue.size", 0),
        ("search.memory.hbm_budget_bytes", "2mb"),
        ("search.staging.retry.max_attempts", 11),
        ("cluster.name", "x"), ("search.batch.window_ms", -1.0)])
    def test_validate_dynamic_update_agrees(self, key, value):
        """Each scope's ``validate_dynamic_update`` accepts and refuses the
        same updates with the same message."""
        scope = "index" if key.startswith("index.") else "cluster"
        fn = ("cluster_settings" if scope == "cluster"
              else "index_scoped_settings")
        outcomes = []
        for mod, err in ((jsettings, JError),
                         (tsettings, ElasticsearchTpuException)):
            try:
                getattr(mod, fn)().validate_dynamic_update(
                    mod.Settings({key: value}))
                outcomes.append("ok")
            except err as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]

    def test_apply_settings_fires_on_explicit_default(self):
        """An explicit update to the default value still reaches the
        consumer in both packages."""
        seen = []
        for mod in (jsettings, tsettings):
            reg = mod.cluster_settings()
            got = []
            reg.add_settings_update_consumer(
                mod.SEARCH_BATCH_ENABLED, got.append)
            reg.apply_settings(mod.Settings({}), mod.Settings(
                {"search.batch.enabled": True}))
            reg.apply_settings(mod.Settings({"search.batch.enabled": True}),
                               mod.Settings({"search.batch.enabled": False}))
            reg.apply_settings(mod.Settings({"search.batch.enabled": False}),
                               mod.Settings({"search.batch.enabled": False}))
            seen.append(got)
        assert seen[0] == seen[1] == [True, False]


class TestIndexSettings:
    def test_index_settings_dynamic_update(self, pair):
        pair.same("PUT", "/idx")
        pair.same("PUT", "/idx/_settings",
                  {"index": {"refresh_interval": "30s"}})
        r = pair.same("GET", "/idx/_settings")
        assert r["idx"]["settings"]["index"]["refresh_interval"] == "30s"
        pair.same("PUT", "/idx/_settings", {"index": {"number_of_shards": 9}},
                  status=400)
        pair.same("PUT", "/idx/_settings", {"index": {"nope": 9}}, status=400)
        pair.same("PUT", "/_settings", {"settings": {
            "index.max_result_window": 500, "number_of_replicas": 0}})
        pair.same("GET", "/_settings", params={"flat_settings": "true"})
        pair.same("GET", "/_cluster/health")
        pair.same("PUT", "/idx/_doc/1", {"a": 1})
        pair.same("GET", "/_cat/indices", params={"format": "json"})
        assert pair.t.indices["idx"].refresh_interval == 30.0

    def test_max_slices_per_scroll_reaches_searchers(self, pair):
        pair.same("PUT", "/idx", {"settings": {"number_of_shards": 2}})
        pair.same("PUT", "/idx/_settings",
                  {"index": {"max_slices_per_scroll": 2}})
        for svc in (pair.j.indices["idx"], pair.t.indices["idx"]):
            assert all(sh.searcher.max_slices == 2
                       for sh in svc.shards.values())

    def test_put_get_mapping(self, pair):
        pair.same("PUT", "/idx")
        pair.same("PUT", "/idx/_mapping",
                  {"properties": {"age": {"type": "integer"}}})
        pair.same("PUT", "/idx/_mapping/_doc",
                  {"_doc": {"properties": {"who": {"type": "keyword"}}}})
        r = pair.same("GET", "/idx/_mapping")
        props = r["idx"]["mappings"]["_doc"]["properties"]
        assert props["age"]["type"] == "integer"
        pair.same("PUT", "/idx/_mapping",
                  {"properties": {"age": {"type": "keyword"}}}, status=400)
        pair.same("PUT", "/idx/_doc/1", {"age": 3, "who": "a"},
                  params={"refresh": "true"})
        pair.same("POST", "/idx/_search", {"query": {"term": {"who": "a"}}})
        pair.same("GET", "/_cluster/state/metadata")


class TestStats:
    @pytest.mark.parametrize("path,params", [
        ("/m/_stats/docs,indexing", {}),
        ("/m/_stats/docs", {"level": "cluster"}),
        ("/_stats/indexing", {"types": "_doc"}),
        ("/_stats/bogus", {}), ("/_stats/doc", {}),
        ("/m/_stats", {"level": "nope"})])
    def test_stats_sections(self, mesh_pair, path, params):
        mesh_pair.same("GET", path, params=params)

    def test_shard_level_stats_on_durable_nodes(self, tmp_path):
        """The shard level's commit ids name the translog generation, so
        both nodes keep a translog here."""
        pair = NodePair(data_paths=(str(tmp_path / "j"), str(tmp_path / "t")))
        try:
            pair.same("PUT", "/d", {"settings": {
                "number_of_shards": 2, "refresh_interval": "-1"},
                "mappings": MAPPING})
            fill(pair, "d", seeded_docs(9, 12))
            pair.same("GET", "/_stats/docs,translog",
                      params={"level": "shards"})
            pair.same("POST", "/d/_flush")
            pair.same("GET", "/d/_stats/flush,docs,translog",
                      params={"level": "shards"})
        finally:
            pair.close()

    def test_stats_and_segments(self, mesh_pair):
        pair = mesh_pair
        pair.same("DELETE", "/m/_doc/3", params={"refresh": "true"})
        jb = pair.call("GET", "/m/_stats")[0][1]
        tb = pair.call("GET", "/m/_stats")[1][1]
        assert set(jb["indices"]["m"]["total"]) == set(
            tb["indices"]["m"]["total"])
        # (the JAX package keeps a translog without a data path, the port
        # none, so the translog section is held on durable nodes above)
        for sec in ("docs", "indexing", "get", "refresh", "flush"):
            assert (jb["indices"]["m"]["total"][sec]
                    == tb["indices"]["m"]["total"][sec]), sec
        assert (jb["indices"]["m"]["total"]["segments"]["count"]
                == tb["indices"]["m"]["total"]["segments"]["count"])
        assert tb["indices"]["m"]["total"]["docs"]["count"] == sum(
            sh.engine.num_docs for sh in pair.t.indices["m"].shards.values())
        (_, js), (_, ts) = pair.call("GET", "/m/_segments")

        def shape(b):
            return {sid: [{name: {k: v for k, v in seg.items()
                                  if k != "memory_in_bytes"}
                           for name, seg in c["segments"].items()}
                          for c in copies]
                    for sid, copies in b["indices"]["m"]["shards"].items()}
        assert shape(js) == shape(ts)
        assert js["_shards"] == ts["_shards"]

    def test_cat_shards_and_segments(self, mesh_pair):
        mesh_pair.same("GET", "/_cat/shards", params={
            "h": "index,shard,prirep,state,docs,ip,node,integrity",
            "format": "json"})
        mesh_pair.same("GET", "/_cat/shards/m", params={
            "h": "index,shard,docs", "v": "true", "s": "shard"})
        mesh_pair.same("GET", "/_cat/segments", params={
            "h": "index,shard,segment,docs.count,docs.deleted,committed",
            "format": "json", "s": "shard"})


class TestClusterSettings:
    def test_cluster_settings(self, pair):
        r = pair.same("PUT", "/_cluster/settings", {
            "persistent": {"search.max_buckets": 1000},
            "transient": {"search": {"batch": {"enabled": False}}}})
        assert r["persistent"]["search"]["max_buckets"] == 1000
        pair.same("GET", "/_cluster/settings")
        pair.same("PUT", "/_cluster/settings", {
            "transient": {"search.batch.enabled": None}})
        pair.same("GET", "/_cluster/settings")
        pair.same("GET", "/_cluster/state/metadata")

    def test_batch_consumers_reach_live_batchers(self, pair):
        pair.same("PUT", "/b", {"settings": {"number_of_shards": 2}})
        pair.same("PUT", "/_cluster/settings", {"transient": {
            "search.batch.enabled": False, "search.batch.window_ms": 2.5,
            "search.batch.max_queries": 4}})
        for svc in (pair.j.indices["b"], pair.t.indices["b"]):
            b = svc._batcher
            assert (b.enabled, b.window_s, b.max_queries) == (
                False, 0.0025, 4)

    def test_cluster_override_and_create_seeding(self, pair):
        for node in (pair.j, pair.t):
            node.create_index("ovr-a", {"settings": {
                "index": {"number_of_shards": 1}}})
        for node in (pair.j, pair.t):
            svc_a = node.indices["ovr-a"]
            assert svc_a.staging_delta_enabled_override is None
            node.put_cluster_settings({"persistent": {
                "index.staging.delta.enabled": False,
                "index.staging.compact.threshold": 0.5}})
            assert svc_a.staging_delta_enabled_override is False
            assert svc_a.staging_compact_threshold_override == 0.5
            assert svc_a._compact_threshold() == 0.5
            node.create_index("ovr-b", {"settings": {
                "index": {"number_of_shards": 1}}})
            svc_b = node.indices["ovr-b"]
            assert svc_b.staging_delta_enabled_override is False
            assert svc_b.staging_compact_threshold_override == 0.5
            node.put_cluster_settings({"persistent": {
                "index.staging.delta.enabled": None,
                "index.staging.compact.threshold": None}})
            assert svc_a.staging_delta_enabled_override is None
            assert svc_a._compact_threshold() == 0.25
        # the port's delta-staging gate reads the override per request
        ms = pair.t.indices["ovr-b"]
        ms.staging_delta_enabled_override = None
        pair.t.put_cluster_settings({"transient": {
            "index.staging.delta.enabled": False}})
        assert ms.staging_delta_enabled_override is False

    def test_staging_retry_override_wins_and_clears(self):
        pair = NodePair({"search.staging.retry.max_attempts": 4,
                         "search.staging.retry.backoff_ms": 5.0})
        try:
            assert jstaging_retry_config() == staging_retry_config() == (
                4, 5.0)
            for node in (pair.j, pair.t):
                node.put_cluster_settings({"transient": {
                    "search.staging.retry.max_attempts": 7}})
            assert jstaging_retry_config()[0] == staging_retry_config()[0] == 7
            for node in (pair.j, pair.t):
                node.put_cluster_settings({"transient": {
                    "search.staging.retry.max_attempts": None}})
            assert jstaging_retry_config()[0] == staging_retry_config()[0] == 4
        finally:
            pair.close()
            jconfigure_staging_retry(max_attempts=3, backoff_ms=10.0)
            configure_staging_retry(max_attempts=3, backoff_ms=10.0)

    def test_budget_never_errors_over_rest(self, pair):
        try:
            for i in range(20):
                pair.same("PUT", f"/bidx/_doc/{i}",
                          {"body": f"w{i % 4} common"})
            pair.same("POST", "/bidx/_refresh")
            pair.same("PUT", "/_cluster/settings", {
                "persistent": {"search.memory.hbm_budget_bytes": "1b"}})
            r = pair.same("POST", "/bidx/_search",
                          {"query": {"match": {"body": "common"}}, "size": 5})
            assert r["hits"]["total"] == 20
            blocks = []
            for ctl in (pair.jc, pair.tc):
                status, stats = ctl.dispatch("GET", "/_nodes/stats", {},
                                             b"", None)
                assert status == 200
                blocks.append(next(iter(stats["nodes"].values())))
            assert (blocks[0]["breakers"]["accounting"]["limit_size_in_bytes"]
                    == blocks[1]["breakers"]["accounting"][
                        "limit_size_in_bytes"] == 1)
            assert set(blocks[0]) >= set(blocks[1])
            pair.same("PUT", "/_cluster/settings", {
                "persistent": {"search.memory.hbm_budget_bytes": None}})
            assert jmemory_accountant().budget_bytes == 0
            assert memory_accountant().budget_bytes == 0
        finally:
            jmemory_accountant().set_budget(0)
            memory_accountant().set_budget(0)

    def test_search_queue_follows_cluster_setting(self):
        pair = NodePair({"search.queue.size": 50})
        try:
            for node in (pair.j, pair.t):
                assert node.thread_pool.executor("search").queue_size == 50
                node.put_cluster_settings({"transient": {
                    "search.queue.size": 7}})
                assert node.thread_pool.executor("search").queue_size == 7
                node.put_cluster_settings({"transient": {
                    "search.queue.size": None}})
                assert node.thread_pool.executor("search").queue_size == 50
        finally:
            pair.close()


class TestPlaneOverrides:
    """Each override set transient, then cleared: the answers stay equal
    to the JAX package's and the port's named plane counter moves."""

    def test_pruning_override(self, pair):
        """Packed postings over 700 docs whose terms cluster by position
        (``test_torch_pruned``'s corpus), so tile bounds differ."""
        pair.same("PUT", "/p", {"settings": {
            "number_of_shards": 2, "refresh_interval": "-1",
            "search": {"mesh": True,
                       "pallas": {"postings_codec": "packed"}}},
            "mappings": PRUNE_MAPPING})
        lines = []
        for doc_id, src in prune_docs(700, 3):
            lines += [{"index": {"_index": "p", "_id": doc_id}}, src]
        pair.same("POST", "/_bulk",
                  "".join(json.dumps(x) + "\n" for x in lines).encode(),
                  params={"refresh": "true"})
        body = {"query": {"match": {"body": "t0 t3 t7"}}, "size": 10}
        pair.same("PUT", "/_cluster/settings", {"transient": {
            "search.pallas.pruning.enabled": True,
            "search.pallas.pruning.probe_tiles": 2}})
        planes = pair.t.indices["p"].search_stats
        before = planes()["planes"]["pruned_query_total"]
        (_, jr), (_, tr) = pair.call("POST", "/p/_search", body)
        assert "_pruned" in jr and "_pruned" in tr
        assert_same_hits(jr["hits"]["hits"], tr["hits"]["hits"], "pruned")
        assert planes()["planes"]["pruned_query_total"] == before + 1
        pair.same("GET", "/_cluster/settings")
        pair.same("PUT", "/_cluster/settings", {"transient": {
            "search.pallas.pruning.enabled": None,
            "search.pallas.pruning.probe_tiles": None}})
        r = pair.same("POST", "/p/_search", body)
        assert "_pruned" not in r
        assert planes()["planes"]["pruned_query_total"] == before + 1
        assert pair.t.indices["p"].pruning_enabled_override is None

    def test_fused_aggs_override(self, mesh_pair):
        pair = mesh_pair
        body = {"size": 0, "query": {"match": {"body": "blue"}},
                "aggs": {"t": {"terms": {"field": "tag"}}}}
        planes = pair.t.indices["m"].search_stats
        pair.same("PUT", "/_cluster/settings", {"transient": {
            "search.aggs.fused": False}})
        fused0 = planes()["planes"]["agg_fused_query_total"]
        pair.same("POST", "/m/_search", body)
        assert planes()["planes"]["agg_fused_query_total"] == fused0
        pair.same("PUT", "/_cluster/settings", {"transient": {
            "search.aggs.fused": None}})
        pair.same("POST", "/m/_search", body)
        assert planes()["planes"]["agg_fused_query_total"] == fused0 + 1

    def test_knn_override(self, mesh_pair):
        pair = mesh_pair
        body = {"knn": {"field": "emb", "query_vector": [0.5, -1, 0.25, 2],
                        "k": 5}}
        planes = pair.t.indices["m"].search_stats
        pair.same("PUT", "/_cluster/settings", {"transient": {
            "search.knn.enabled": False}})
        k0 = planes()["planes"]["knn_query_total"]
        r1 = pair.same("POST", "/m/_search", body)
        assert planes()["planes"]["knn_query_total"] == k0
        pair.same("PUT", "/_cluster/settings", {"transient": {
            "search.knn.enabled": None}})
        r2 = pair.same("POST", "/m/_search", body)
        assert planes()["planes"]["knn_query_total"] == k0 + 1
        assert [h["_id"] for h in r1["hits"]["hits"]] == [
            h["_id"] for h in r2["hits"]["hits"]]
