"""The global metadata across a full restart: the port against the JAX
package, and data directories passed between the two.

A durable node keeps ``<data>/_state/global-meta.json`` (templates,
persistent cluster settings, stored scripts, ingest pipelines, snapshot
repositories), rewritten atomically on every change, and each index's
``_meta.json`` with its aliases. Mirrors ``tests/test_gateway.py``'s
``test_all_five_survive_full_restart`` (for the three slices the port
serves: templates, persistent settings and stored scripts; an alias
besides), ``test_state_file_is_atomic_and_updated`` and
``test_ephemeral_node_writes_nothing``. A directory written by either
package opens in the other with the same metadata; the port reads back
the ingest pipelines and repositories it does not serve and writes them
again unchanged. Every node is closed by its test.
"""

import json
import os

import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node

MAPPING = {"properties": {"msg": {"type": "text"}, "n": {"type": "long"}}}


def seed(node):
    """The same metadata on a node of either package."""
    node.put_template("logs-template", {
        "index_patterns": ["logs-*"],
        "settings": {"number_of_shards": 2},
        "mappings": {"properties": {"msg": {"type": "text"}}},
        "aliases": {"logs": {}},
        "order": 3})
    node.put_cluster_settings({
        "persistent": {"cluster": {"routing": {"allocation": {
            "enable": "primaries"}}},
            "search.pallas.pruning.enabled": True},
        "transient": {"search": {"default_search_timeout": "9s"}}})
    node.put_stored_script("my-script", {
        "script": {"lang": "painless", "source": "ctx._source.n += 1"}})
    node.create_index("docs", {"settings": {"refresh_interval": "-1"},
                               "mappings": MAPPING,
                               "aliases": {"d": {"filter": {
                                   "term": {"n": 1}}}}})
    node.update_aliases([{"add": {"index": "docs", "alias": "all-docs"}}])
    node.index_doc("docs", "1", {"msg": "hello", "n": 1})
    node.indices["docs"].flush()


def read_state(data_dir):
    with open(os.path.join(data_dir, "_state", "global-meta.json"),
              encoding="utf-8") as f:
        return json.load(f)


def read_meta(data_dir, index):
    with open(os.path.join(data_dir, "indices", index, "_meta.json"),
              encoding="utf-8") as f:
        return json.load(f)


def check_recovered(node):
    state = node.cluster_service.state
    assert state.templates["logs-template"]["order"] == 3
    assert state.persistent_settings.as_dict().get(
        "cluster.routing.allocation.enable") == "primaries"
    assert state.transient_settings.as_dict() == {}
    assert "ctx._source.n += 1" in str(node.get_stored_script("my-script"))
    assert set(state.indices["docs"].aliases) == {"d", "all-docs"}
    assert node.get_doc("docs", "1")["_source"]["msg"] == "hello"
    assert node.search("all-docs", {})["hits"]["total"] == 1
    # the template still applies, its alias too
    node.create_index("logs-2026")
    assert node.indices["logs-2026"].settings.get_int(
        "index.number_of_shards", 0) == 2
    assert "logs" in node.cluster_service.state.indices["logs-2026"].aliases


class TestRestart:
    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_all_three_survive_full_restart(self, tmp_path, pkg):
        make = ((lambda d: JNode(JSettings.EMPTY, data_path=d)) if pkg == "jax"
                else (lambda d: Node(Settings.EMPTY, data_path=d,
                                     device="cpu")))
        d = str(tmp_path / "data")
        node = make(d)
        seed(node)
        node.close()
        node2 = make(d)
        try:
            check_recovered(node2)
        finally:
            node2.close()

    def test_port_restart_keeps_the_pruning_override(self, tmp_path):
        d = str(tmp_path / "data")
        node = Node(data_path=d, device="cpu")
        seed(node)
        assert node.indices["docs"].pruning_enabled_override is True
        node.close()
        node2 = Node(data_path=d, device="cpu")
        try:
            assert node2.indices["docs"].pruning_enabled_override is True
            node2.put_cluster_settings({"persistent": {
                "search.pallas.pruning.enabled": None}})
            assert node2.indices["docs"].pruning_enabled_override is None
            assert "search" not in read_state(d)["persistent_settings"]
        finally:
            node2.close()

    def test_state_file_is_atomic_and_updated(self, tmp_path):
        d = str(tmp_path / "data")
        node = Node(data_path=d, device="cpu")
        try:
            seed(node)
            state_file = os.path.join(d, "_state", "global-meta.json")
            assert os.path.exists(state_file)
            assert not os.path.exists(state_file + ".tmp")
            assert "logs-template" in read_state(d)["templates"]
            node.delete_template("logs-template")
            assert "logs-template" not in read_state(d)["templates"]
            node.delete_stored_script("my-script")
            assert read_state(d)["stored_scripts"] == {}
            # an alias change rewrites the index's _meta.json at once
            node.update_aliases([{"remove": {"index": "docs",
                                             "alias": "d"}}])
            assert set(read_meta(d, "docs")["aliases"]) == {"all-docs"}
        finally:
            node.close()

    def test_same_files_as_jax(self, tmp_path):
        """The same calls write the same global file and the same index
        metadata in both packages."""
        dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
        jn = JNode(JSettings.EMPTY, data_path=dj)
        tn = Node(data_path=dt, device="cpu")
        try:
            seed(jn)
            seed(tn)
            assert read_state(dj) == read_state(dt)
        finally:
            jn.close()
            tn.close()
        assert read_state(dj) == read_state(dt)
        mj, mt = read_meta(dj, "docs"), read_meta(dt, "docs")
        assert mj["aliases"] == mt["aliases"]
        assert mj["mappings"] == mt["mappings"]
        assert mj["settings"] == mt["settings"]

    def test_ephemeral_node_writes_nothing(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        node = Node(device="cpu")
        try:
            node.put_template("t", {"index_patterns": ["x-*"]})
            node.put_cluster_settings({"persistent": {"search.max_buckets":
                                                      10}})
            node.create_index("x-1")
            assert not node.persistent_path
        finally:
            node.close()
        assert os.listdir(tmp_path) == []


class TestAcrossPackages:
    def _jax_dir(self, tmp_path):
        d = str(tmp_path / "data")
        node = JNode(JSettings({"path.repo": [str(tmp_path / "repos")]}),
                     data_path=d)
        try:
            seed(node)
            node.ingest.put_pipeline("my-pipe", {
                "description": "adds a field",
                "processors": [{"set": {"field": "added", "value": True}}]})
            node.snapshots.put_repository("my-repo", {
                "type": "fs", "settings": {
                    "location": str(tmp_path / "repos" / "r")}})
        finally:
            node.close()
        return d

    def test_jax_dir_opens_in_the_port_and_back(self, tmp_path):
        d = self._jax_dir(tmp_path)
        written = read_state(d)
        node = Node(data_path=d, device="cpu")
        try:
            check_recovered(node)
            state = node.cluster_service.state
            assert state.ingest_pipelines == written["ingest_pipelines"]
            assert state.repositories == written["repositories"]
            node.put_template("more", {"index_patterns": ["m-*"],
                                       "order": 1})
        finally:
            node.close()
        after = read_state(d)
        assert after["ingest_pipelines"] == written["ingest_pipelines"]
        assert after["repositories"] == written["repositories"]
        assert set(after["templates"]) == {"logs-template", "more"}
        jn = JNode(JSettings({"path.repo": [str(tmp_path / "repos")]}),
                   data_path=d)
        try:
            state = jn.cluster_service.state
            assert set(state.templates) == {"logs-template", "more"}
            assert "my-pipe" in state.ingest_pipelines
            assert "my-repo" in state.repositories
            assert set(state.indices["docs"].aliases) == {"d", "all-docs"}
            assert set(state.indices["logs-2026"].aliases) == {"logs"}
            assert jn.search("all-docs", {})["hits"]["total"] == 1
        finally:
            jn.close()

    def test_port_dir_opens_in_jax(self, tmp_path):
        d = str(tmp_path / "data")
        node = Node(data_path=d, device="cpu")
        try:
            seed(node)
        finally:
            node.close()
        jn = JNode(JSettings.EMPTY, data_path=d)
        try:
            check_recovered(jn)
        finally:
            jn.close()
