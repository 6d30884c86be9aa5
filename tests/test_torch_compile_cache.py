"""The variant registry and the warm replay of the port against the JAX
package.

Mirrors ``tests/test_rollout.py::TestCompileCachePlane`` and the warm half
of ``TestNodeDrainAndWarmRestart``. The port compiles no XLA program:
its variants are the mesh plane's launch shapes
(``compile_cache.run_variant``), whose first run in a process counts in
the ``compile`` block, and a warm replay runs the recorded bodies under
``warming()``. The registry, the first-call accounting, the body
skeletons and the recorded warm specs must equal the JAX package's; the
port keeps its registry under ``search.compile.cache_path`` when that is
set. Counters are process-wide, so the tests read deltas.
"""

import json
import os

import numpy as np
import pytest

from elasticsearch_tpu.common import compile_cache as jcc
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu_torch.common import compile_cache as tcc
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.node import Node

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"}}}
JOIN_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    jcc.set_variant_registry(jcc.VariantRegistry(None))
    tcc.set_variant_registry(tcc.VariantRegistry(None))
    yield
    jcc.set_variant_registry(jcc.VariantRegistry(None))
    tcc.set_variant_registry(tcc.VariantRegistry(None))
    tcc.configure_compile_cache(None)


def pair(name, **settings):
    base = {"index.number_of_shards": 2, "index.refresh_interval": -1,
            **settings}
    j = JIndex(name, JSettings(base), mapping=MAPPING)
    t = IndexService(name, Settings(base), mapping=MAPPING, device="cpu")
    for idx in (j, t):
        for d in range(8):
            idx.index_doc(str(d), {"body": f"w{d % 2} common"})
        idx.refresh()
    return j, t


def first_calls(mod):
    st = mod.compile_stats().stats()
    return st["compile_cache_hit_total"] + st["compile_cache_miss_total"]


def test_variant_registry_round_trip(tmp_path):
    out = []
    for mod in (jcc, tcc):
        path = str(tmp_path / f"{mod.__name__}.json")
        reg = mod.VariantRegistry(path)
        known0 = reg.program_known("serial:abc")
        reg.record_program("serial:abc")
        reg.record_warm("idx", "k1", {"kind": "search",
                                      "bodies": [{"size": 1}]})
        reg2 = mod.VariantRegistry(path)
        seen = (known0, reg2.program_known("serial:abc"),
                reg2.warm_entries("idx"), reg2.indices())
        reg2.forget_index("idx")
        with open(path, encoding="utf-8") as f:
            on_disk = json.load(f)
        out.append((seen, mod.VariantRegistry(path).warm_entries("idx"),
                    on_disk))
    assert out[1] == out[0]
    assert out[1][0] == (False, True,
                         [{"kind": "search", "bodies": [{"size": 1}]}],
                         ["idx"])


def test_corrupt_registry_warms_nothing(tmp_path):
    for mod in (jcc, tcc):
        path = str(tmp_path / f"{mod.__name__}.json")
        with open(path, "w", encoding="utf-8") as f:
            f.write('{"programs": [')
        reg = mod.VariantRegistry(path)
        assert reg.programs == set() and reg.indices() == []


def test_instrument_program_counts_first_call_once():
    out = []
    for mod in (jcc, tcc):
        calls = []
        fn = mod.instrument_program(lambda x: calls.append(x) or x,
                                    "serial", "serial:testkey1")
        before = first_calls(mod)
        results = (fn(1), fn(2))
        out.append((results, calls, first_calls(mod) - before,
                    "serial:testkey1" in mod.variant_registry().programs,
                    fn.variant_key))
    assert out[1] == out[0] == ((1, 2), [1, 2], 1, True, "serial:testkey1")


def test_warming_context_classifies_first_call():
    out = []
    for mod in (jcc, tcc):
        before = mod.compile_stats().stats()
        fn = mod.instrument_program(lambda: None, "serial",
                                    "serial:testkey2")
        with mod.warming():
            assert mod.in_warming()
            fn()
        assert not mod.in_warming()
        after = mod.compile_stats().stats()
        out.append((after["programs_warmed_total"]
                    - before["programs_warmed_total"],
                    after["query_path_first_compile_total"]
                    - before["query_path_first_compile_total"],
                    after["first_compile_events"][-1]["warmed"]))
    assert out[1] == out[0] == (1, 0, True)


def test_run_variant_times_each_shape_once():
    before = first_calls(tcc)
    for parts in ((4, 1024), (4, 1024), (8, 1024), (4, 1024)):
        assert tcc.run_variant("test_family", parts, lambda: 7) == 7
    assert first_calls(tcc) - before == 2
    key = tcc.variant_key("test_family", 4, 1024)
    assert key == jcc.variant_key("test_family", 4, 1024)
    assert key in tcc.variant_registry().programs


def test_body_skeleton_matches_jax():
    bodies = [
        {"query": {"match": {"body": "a b"}}, "size": 5},
        {"query": {"match": {"body": "c d"}}, "size": 5},
        {"query": {"match": {"body": "a"}}, "size": 5},
        {"query": {"bool": {"must": [{"term": {"x": 1}}, {"term": {
            "y": True}}]}}, "aggs": {"t": {"terms": {"field": "k"}}}},
        {"knn": {"field": "e", "query_vector": [0.1] * 9, "k": 3}},
    ]
    for b in bodies:
        assert tcc.body_skeleton(b) == jcc.body_skeleton(b)
    assert tcc.body_skeleton(bodies[0]) == tcc.body_skeleton(bodies[1])
    assert tcc.body_skeleton(bodies[0]) != tcc.body_skeleton(bodies[2])


def test_compile_block_exported_in_stats():
    j, t = pair("compstats")
    try:
        for idx in (j, t):
            idx.search({"query": {"match": {"body": "common"}}})
        jb, tb = (idx.search_stats()["compile"] for idx in (j, t))
        assert set(tb) == set(jb)
        assert set(tb["first_compile_stall_ms"]) == set(
            jb["first_compile_stall_ms"])
        assert tb["cache_enabled"] is False and tb["cache_path"] is None
    finally:
        j.close()
        t.close()


def test_mesh_query_records_warmable_variant():
    j, t = pair("varrec", **{"index.search.mesh.plane": "pallas"})
    try:
        out = []
        for idx, mod in ((j, jcc), (t, tcc)):
            body = {"query": {"match": {"body": "common"}}, "size": 5}
            r = idx.search(dict(body))
            assert r["_plane"] == "mesh_pallas"
            # the same shape with other terms records nothing new
            idx.search({"query": {"match": {"body": "w1"}}, "size": 5})
            entries = mod.variant_registry().warm_entries("varrec")
            warmed = idx.warm_compile_variants()
            out.append((entries, warmed,
                        mod.variant_registry().warm_entries("varrec")))
        assert out[1] == out[0]
        entries, warmed, after = out[1]
        assert entries == [{"kind": "search", "bodies": [
            {"query": {"match": {"body": "common"}}, "size": 5}]}]
        assert warmed == 1 and after == entries
    finally:
        j.close()
        t.close()


def test_batch_records_search_batch_variant():
    j, t = pair("varbatch", **{"index.search.mesh.plane": "pallas"})
    try:
        burst = [{"query": {"match": {"body": f"w{i % 2}"}}, "size": 3}
                 for i in range(3)]
        out = []
        for idx, mod in ((j, jcc), (t, tcc)):
            res = idx.search_batch([dict(b) for b in burst])
            assert all(r["_plane"] == "mesh_pallas" for r in res)
            out.append(sorted(e["kind"] for e in
                              mod.variant_registry().warm_entries(
                                  "varbatch")))
            assert idx.warm_compile_variants() == len(out[-1])
        # each member's answer records its own shape too
        assert out[1] == out[0] == ["search", "search_batch"]
    finally:
        j.close()
        t.close()


def test_warm_replay_runs_under_warming_and_never_records():
    _j, t = pair("varwarm", **{"index.search.mesh.plane": "pallas"})
    _j.close()
    try:
        body = {"query": {"match": {"body": "common"}}, "size": 2}
        t.search(dict(body))
        seen = []
        orig = t._search_uncached

        def spy(b, *a, **kw):
            seen.append(tcc.in_warming())
            return orig(b, *a, **kw)

        t._search_uncached = spy
        assert t.warm_compile_variants() == 1
        assert seen == [True]
        assert len(tcc.variant_registry().warm_entries("varwarm")) == 1
        # a stale spec (a field gone) warms nothing and never raises
        tcc.variant_registry().record_warm("varwarm", "stale", {
            "kind": "search", "bodies": [{"query": {"nope": {}}}]})
        assert t.warm_compile_variants() == 1
    finally:
        t.close()


def test_cache_path_keeps_the_registry_and_counts_hits(tmp_path):
    cache = str(tmp_path / "cache")
    body = {"query": {"match": {"body": "common"}}, "size": 4}

    def serve():
        node = Node(Settings({"search.compile.cache_path": cache}),
                    device="cpu")
        try:
            node.create_index("cc", {"settings": {
                "number_of_shards": 2, "index.refresh_interval": -1}})
            for d in range(8):
                node.index_doc("cc", str(d), {"body": f"w{d % 2} common"})
            node.refresh("cc")
            r = node.search("cc", dict(body))
            tcc.run_variant("test_cache_path", (id(node),), lambda: None)
            return r, node.node_stats()
        finally:
            node.close()

    r1, s1 = serve()
    assert r1["_plane"] == "mesh_pallas"
    path = os.path.join(cache, tcc.REGISTRY_FILE)
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    assert data["warm"]["cc"] and data["programs"]
    comp = next(iter(s1["nodes"].values()))["indices"]["search"]["compile"]
    assert comp["cache_enabled"] is True and comp["cache_path"] == cache
    # the next node over the same path installs the persisted registry:
    # it knows the variants (a first run of one is a hit) and the specs
    Node(Settings({"search.compile.cache_path": cache}),
         device="cpu").close()
    reg = tcc.variant_registry()
    assert reg.path == path and reg.warm_entries("cc")
    assert all(reg.program_known(k) for k in data["programs"])


def test_warm_restart_replays_off_the_query_path(tmp_path):
    body = {"query": {"match": {"body": "common"}}, "size": 4}

    def fill(node):
        node.create_index("wr", {"settings": {
            "number_of_shards": 2, "index.refresh_interval": -1}})
        for d in range(8):
            node.index_doc("wr", str(d), {"body": f"w{d % 2} common"})
        node.indices["wr"].refresh()
        return node.search("wr", dict(body))

    jnode = JNode(JSettings({"search.compile.warm_on_start": False}),
                  data_path=str(tmp_path / "j"))
    try:
        want = fill(jnode)
    finally:
        jnode.close()
    path = str(tmp_path / "t")
    node = Node(Settings.EMPTY, data_path=path, device="cpu")
    got = fill(node)
    node.close()
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    registry = os.path.join(path, "_state", tcc.REGISTRY_FILE)
    assert os.path.exists(registry)
    before = tcc.compile_stats().stats()
    node = Node(Settings.EMPTY, data_path=path, device="cpu")
    try:
        # the warm thread never blocks the boot; join it to read its work
        assert node._warm_thread is not None
        node._warm_thread.join(JOIN_S)
        assert not node._warm_thread.is_alive()
        warmed = tcc.compile_stats().stats()
        r = node.search("wr", dict(body))
        after = tcc.compile_stats().stats()
        np.testing.assert_allclose(
            [h["_score"] for h in r["hits"]["hits"]],
            [h["_score"] for h in want["hits"]["hits"]], rtol=1e-5)
        # the replay ran the staging and the variant's first run; the
        # query itself met no first run
        assert node.indices["wr"]._mesh_search is not None
        assert (warmed["compile_cache_hit_total"]
                + warmed["compile_cache_miss_total"]
                >= before["compile_cache_hit_total"]
                + before["compile_cache_miss_total"])
        assert (after["query_path_first_compile_total"]
                == warmed["query_path_first_compile_total"])
    finally:
        node.close()


def test_warm_on_start_false_replays_nothing(tmp_path):
    path = str(tmp_path / "n")
    node = Node(Settings.EMPTY, data_path=path, device="cpu")
    node.create_index("wf", {"settings": {
        "number_of_shards": 2, "index.refresh_interval": -1}})
    node.index_doc("wf", "1", {"body": "common"})
    node.refresh("wf")
    node.search("wf", {"query": {"match": {"body": "common"}}})
    node.close()
    node = Node(Settings({"search.compile.warm_on_start": False}),
                data_path=path, device="cpu")
    try:
        assert node._warm_thread is None
        assert node.indices["wf"]._mesh_search is None
    finally:
        node.close()
