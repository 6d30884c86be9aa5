"""Durability: a port ``Node(data_path=..., device="cpu")`` against the JAX
``Node(data_path=...)``, through the same steps.

Both nodes take the same seeded documents (text, keyword, long, date,
boolean and a cosine ``dense_vector``; one dynamic field, so the JAX
package writes its ``_meta.json`` before any close), deletes and an
update, a flush, more writes, then either ``close()`` or a crash (the
node is dropped without closing: its translog is replayed at the next
open). Reopened over the same data path, each must answer exactly as it
did before (bodies equal but ``took``), the two packages must agree (ids,
totals and buckets exact, scores within rtol 1e-5), and the next
``_seq_no`` must continue from the last one. A data path written by one
package must open in the other. A child process killed with SIGKILL in
the middle of a bulk loses no acknowledged doc; a shard whose store
fails its checksums is quarantined and fails into ``_shards.failures``
while the others answer, as in the JAX package.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu_torch.node import Node
from test_torch_search import assert_same_hits

MAPPING = {"_doc": {"properties": {
    "title": {"type": "text"},
    "venue": {"type": "keyword"},
    "year": {"type": "long"},
    "ts": {"type": "date"},
    "open": {"type": "boolean"},
    "emb": {"type": "dense_vector", "dims": 4, "similarity": "cosine"},
}}}
SETTINGS = {"number_of_shards": 2, "refresh_interval": "-1"}
# the JAX index serves from its host rung with its Pallas kernels in
# interpret mode, as tests/test_torch_search.py runs it
JAX_SETTINGS = {**SETTINGS, "search": {"mesh": False},
                "requests": {"cache": {"enable": False}}}

REQUESTS = {
    "match": {"query": {"match": {"title": "w1 w4 w9"}}, "size": 200},
    "bool": {"query": {"bool": {
        "must": [{"match": {"title": "w2 w3"}}],
        "filter": [{"term": {"venue": "v1"}},
                   {"range": {"year": {"gte": 2000}}}]}}, "size": 200},
    "term_open": {"query": {"term": {"open": True}}, "size": 200},
    "range_ts": {"query": {"range": {"ts": {"gte": "2023-06-01"}}},
                 "size": 200},
    "aggs": {"size": 0, "query": {"match": {"title": "w0 w2"}},
             "aggs": {"v": {"terms": {"field": "venue"}},
                      "d": {"date_histogram": {"field": "ts",
                                               "interval": "month"}},
                      "s": {"stats": {"field": "year"}}}},
    "knn": {"knn": {"field": "emb", "query_vector": [0.5, -1.0, 0.25, 2.0],
                    "k": 5}},
}


def seeded_docs(n, seed):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, 31)
    p /= p.sum()
    docs = []
    for i in range(n):
        src = {"title": " ".join(f"w{int(x)}" for x in
                                 rng.choice(30, rng.randint(2, 9), p=p)),
               "venue": f"v{int(rng.randint(5))}",
               "year": int(1990 + rng.randint(30)),
               "ts": f"2023-{1 + int(rng.randint(12)):02d}-"
                     f"{1 + int(rng.randint(28)):02d}",
               "open": bool(rng.rand() < 0.5)}
        if i % 4:
            src["emb"] = [float(x) for x in rng.randn(4)]
        docs.append(src)
    return docs


def bulk(node, ids, docs):
    ops = [("index", {"_index": "idx", "_id": i}, d)
           for i, d in zip(ids, docs)]
    r = node.bulk(ops)
    assert not r["errors"]
    return r


def write_steps(node):
    """The write history both packages take; returns the write
    responses."""
    out = []
    out.append(node.create_index("idx", {
        "settings": JAX_SETTINGS if isinstance(node, JNode) else SETTINGS,
        "mappings": MAPPING}))
    first = seeded_docs(80, seed=41)
    first[7]["extra"] = 7  # a dynamic field: the mapping grows
    out.append(bulk(node, [f"d{i}" for i in range(80)], first)["items"])
    for i in (3, 11, 12, 40):
        out.append(node.delete_doc("idx", f"d{i}"))
    out.append(node.index_doc("idx", "d5", {"title": "w1 w1 updated",
                                            "venue": "v2", "year": 2021}))
    out.append(node.flush("idx") if isinstance(node, Node)
               else (node.indices["idx"].flush(), None)[1])
    out.append(bulk(node, [f"e{i}" for i in range(30)],
                    seeded_docs(30, seed=43))["items"])
    for i in (1, 2):
        out.append(node.delete_doc("idx", f"e{i}"))
    out.append(node.delete_doc("idx", "d50"))
    out.append(node.index_doc("idx", "e4", {"title": "w4 again",
                                            "year": 1999}))
    return out


def read_all(node):
    """The requests, a few GETs, after a refresh."""
    if isinstance(node, Node):
        node.refresh("idx")
    else:
        node.indices["idx"].refresh()
    out = {name: node.search("idx", dict(body))
           for name, body in REQUESTS.items()}
    out["gets"] = [node.get_doc("idx", i) for i in
                   ("d0", "d3", "d5", "d50", "e1", "e4", "e29", "nope")]
    return out


def strip_took(r):
    return {k: v for k, v in r.items() if k != "took"}


def assert_same_reads(jr, tr):
    """The JAX package's reads against the port's."""
    for name in REQUESTS:
        assert jr[name]["hits"]["total"] == tr[name]["hits"]["total"], name
        assert_same_hits(jr[name], tr[name])
        assert jr[name].get("aggregations") == \
            tr[name].get("aggregations"), name
        assert jr[name]["_shards"] == tr[name]["_shards"], name
    assert jr["gets"] == tr["gets"]


def jax_node(path):
    return JNode(JSettings({"search.compile.warm_on_start": False}),
                 data_path=path)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


def run_package(kind, path, end):
    """Write, read, end (close or crash), reopen, read again; the next
    write's response. Returns (before, after, next_write, reopened,
    nodes to close at the end: the crashed one)."""
    make = jax_node if kind == "jax" else (
        lambda p: Node(data_path=p, device="cpu"))
    node = make(path)
    write_steps(node)
    before = read_all(node)
    if end == "close":
        node.close()
    reopened = make(path)
    after = read_all(reopened)
    nxt = reopened.index_doc("idx", "f-new", {"title": "w1 fresh"})
    return before, after, nxt, reopened, [node] if end == "crash" else []


@pytest.mark.parametrize("end", ["close", "crash"])
def test_restart_answers_as_before_and_as_jax(tmp_path, end):
    jb, ja, jn, jnode, jcrashed = run_package("jax", str(tmp_path / "j"),
                                              end)
    tb, ta, tn, tnode, tcrashed = run_package("torch", str(tmp_path / "t"),
                                              end)
    try:
        # each package answers after the reopen as it did before it
        for name in REQUESTS:
            assert strip_took(ta[name]) == strip_took(tb[name]), name
        assert ta["gets"] == tb["gets"]
        # and the two packages agree, before and after
        assert_same_reads(jb, tb)
        assert_same_reads(ja, ta)
        # the next seqno continues from the last one on that shard
        for key in ("_seq_no", "_version", "result", "_shard"):
            assert jn[key] == tn[key], key
        # the translogs hold the same lines: the same stats, bytes included
        for sid in (0, 1):
            ts = tnode.indices["idx"].shards[sid].engine.stats()
            js = jnode.indices["idx"].shards[sid].engine.stats()
            assert ts["translog"] == js["translog"], sid
            assert ts["seq_no"] == js["seq_no"], sid
        svc = tnode.indices["idx"]
        replayed = sum(svc.recovered_ops.values())
        if end == "close":
            assert replayed == 0  # the synced flush covers every op
        else:
            assert replayed == 34  # every op since the flush
        # deleted stays deleted; a force merge changes no match, total,
        # bucket or GET. Scores move, in both packages alike: a segment's
        # BM25 statistics count its deleted docs until a merge expunges
        # them, as Lucene's do
        assert not tnode.get_doc("idx", "d3")["found"]
        pre = read_all(tnode)
        assert tnode.force_merge("idx") == {
            "_shards": {"total": 2, "successful": 2, "failed": 0}}
        jnode.indices["idx"].force_merge()
        assert all(len(s.engine.segments) == 1 for s in svc.shards.values())
        merged = read_all(tnode)
        assert_same_reads(read_all(jnode), merged)
        assert merged["gets"] == pre["gets"]
        for name in REQUESTS:
            r, p = merged[name], pre[name]
            assert r["hits"]["total"] == p["hits"]["total"], name
            assert r.get("aggregations") == p.get("aggregations"), name
            if name != "knn":
                assert ({h["_id"] for h in r["hits"]["hits"]}
                        == {h["_id"] for h in p["hits"]["hits"]}), name
    finally:
        # the crashed nodes too: no JAX staging outlives the test
        for n in [jnode, tnode] + jcrashed + tcrashed:
            n.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("end", ["close", "crash"])
def test_data_path_written_by_one_opens_in_the_other(tmp_path, writer, end):
    path = str(tmp_path / "data")
    if writer == "jax":
        w = jax_node(path)
    else:
        w = Node(data_path=path, device="cpu")
    write_steps(w)
    before = read_all(w)
    if end == "close":
        w.close()
    else:
        # a crash leaves the translog to replay; the writer's files stay
        # open, so the reader opens a copy
        shutil.copytree(path, path + ".copy")
        path = path + ".copy"
    r = Node(data_path=path, device="cpu") if writer == "jax" \
        else jax_node(path)
    try:
        after = read_all(r)
        if writer == "jax":
            assert_same_reads(before, after)
        else:
            assert_same_reads(after, before)
        assert r.get_doc("idx", "d7")["_source"]["extra"] == 7
    finally:
        r.close()
        if end == "crash":
            w.close()


def test_recovered_segments_keep_the_codec_stamp(tmp_path):
    """A recovered segment stages in the index's postings codec, as a
    sealed one does (a packed index's recovered segment must not stage
    raw)."""
    path = str(tmp_path / "data")
    node = Node(data_path=path, device="cpu")
    # one shard: the host rung stages each segment's own kernel tables
    node.create_index("idx", {"settings": {
        **SETTINGS, "number_of_shards": 1,
        "search": {"pallas": {"postings_codec": "packed"}}},
        "mappings": MAPPING})
    bulk(node, [f"d{i}" for i in range(40)], seeded_docs(40, seed=5))
    node.close()
    again = Node(data_path=path, device="cpu")
    try:
        r = again.search("idx", {"query": {"match": {"title": "w1"}}})
        assert r["hits"]["total"] > 0
        segs = [s for sh in again.indices["idx"].shards.values()
                for s in sh.engine.searchable_segments()]
        assert segs and all(s.kernel_codec == "packed" for s in segs)
    finally:
        again.close()


def test_close_releases_staging_after_recovery_and_merge(tmp_path):
    path = str(tmp_path / "data")
    node = Node(data_path=path, device="cpu")
    write_steps(node)
    node.close()
    again = Node(data_path=path, device="cpu")
    svc = again.indices["idx"]
    read_all(again)
    old = [s for sh in svc.shards.values() for s in sh.engine.segments]
    assert sum(s.staged_bytes() for s in old) > 0
    again.force_merge("idx")
    assert sum(s.staged_bytes() for s in old) == 0
    read_all(again)
    merged = [s for sh in svc.shards.values() for s in sh.engine.segments]
    assert sum(s.staged_bytes() for s in merged) > 0
    again.close()
    assert sum(s.staged_bytes() for s in merged) == 0
    assert again.indices == {}


def test_delete_index_removes_its_directory(tmp_path):
    path = str(tmp_path / "data")
    node = Node(data_path=path, device="cpu")
    node.create_index("a", {"settings": SETTINGS})
    node.create_index("b", {"settings": SETTINGS})
    node.index_doc("a", "1", {"title": "w1"})
    node.delete_index("a")
    assert sorted(os.listdir(os.path.join(path, "indices"))) == ["b"]
    node.close()
    again = Node(data_path=path, device="cpu")
    assert sorted(again.indices) == ["b"]
    again.close()


def test_node_without_data_path_keeps_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    node = Node(device="cpu")
    node.create_index("idx", {"settings": SETTINGS})
    node.index_doc("idx", "1", {"title": "w1"})
    assert node.flush("idx")["_shards"]["successful"] == 2
    shard = node.indices["idx"].shards[0]
    assert shard.engine.translog is None and shard.engine.store is None
    node.close()
    assert os.listdir(tmp_path) == []


def test_shard_recovery_replays_up_to_torn_tail(tmp_path):
    """The JAX package's torn-tail shard case, on the port's shard."""
    from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
    from elasticsearch_tpu_torch.index.shard import IndexShard
    from elasticsearch_tpu_torch.mapper.mapping import MapperService

    mapper = MapperService(AnalysisRegistry(None), {"properties": {}})
    path = str(tmp_path / "shard0")
    shard = IndexShard("cr", 0, mapper, device="cpu", data_path=path)
    shard.start_fresh()
    for i in range(8):
        shard.index_doc(f"d{i}", {"n": i})
    tl = shard.engine.translog
    with open(tl._gen_path(tl.generation), "a", encoding="utf-8") as f:
        f.write('{"op": "index", "seq_no": 8, "id": "d8", "so')
    recovered = IndexShard("cr", 0, mapper, device="cpu", data_path=path)
    assert recovered.recover_from_store() == 8
    recovered.refresh()
    assert recovered.num_docs == 8
    for i in range(8):
        assert recovered.get_doc(f"d{i}").found
    assert recovered.seq_no_stats() == {
        "max_seq_no": 7, "local_checkpoint": 7, "global_checkpoint": 7}
    recovered.close()


def test_quarantined_shard_fails_into_failures_like_jax(tmp_path):
    path = str(tmp_path / "data")
    node = Node(data_path=path, device="cpu")
    node.create_index("idx", {"settings": {**SETTINGS,
                                           "number_of_shards": 3},
                              "mappings": MAPPING})
    bulk(node, [f"d{i}" for i in range(60)], seeded_docs(60, seed=9))
    node.close()
    seg_dir = os.path.join(path, "indices", "idx", "1", "index")
    seg = next(e for e in sorted(os.listdir(seg_dir)) if "_seg_" in e)
    npz = os.path.join(seg_dir, seg, "arrays.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(raw))
    shutil.copytree(path, path + ".jax")

    t = Node(data_path=path, device="cpu")
    j = jax_node(path + ".jax")
    try:
        svc = t.indices["idx"]
        assert svc.shards[1].store_corrupted
        assert svc.shards[1].engine.store.is_corrupted()  # marker written
        body = {"query": {"match": {"title": "w1 w2"}}, "size": 100}
        tr, jr = t.search("idx", body), j.search("idx", body)
        assert tr["_plane"] == "host"
        assert tr["_shards"] == jr["_shards"]
        assert tr["_shards"]["failed"] == 1
        assert tr["_shards"]["failures"][0]["shard"] == 1
        assert tr["_shards"]["failures"][0]["reason"]["type"] == \
            "corrupt_index_exception"
        assert_same_hits(jr, tr)
        assert 0 < tr["hits"]["total"]
        shard_of = {h["_id"]: svc._route(h["_id"]) for h in
                    tr["hits"]["hits"]}
        assert 1 not in shard_of.values()
        # a batch takes the host rung too
        out = svc.search_batch([dict(body), dict(body)])
        assert all(r["_shards"]["failed"] == 1 for r in out)
    finally:
        t.close()
        j.close()
    # the close's synced flush left the corrupt shard's bytes alone, and
    # the marker stays: the next open quarantines the shard again
    assert os.path.exists(npz)
    again = Node(data_path=path, device="cpu")
    assert again.indices["idx"].shards[1].store_corrupted
    again.close()
    assert os.path.exists(npz)


@pytest.mark.parametrize("damage", ["live.npy", "commit.json"])
def test_torn_unchecksummed_file_quarantines_the_shard(tmp_path, damage):
    # live.npy and commit.json carry no checksum; torn, either fails its
    # shard's load as corruption: the shard is quarantined and fails into
    # _shards.failures while the others answer, and the node opens
    path = str(tmp_path / "data")
    node = Node(data_path=path, device="cpu")
    node.create_index("idx", {"settings": {**SETTINGS,
                                           "number_of_shards": 3},
                              "mappings": MAPPING})
    bulk(node, [f"d{i}" for i in range(60)], seeded_docs(60, seed=9))
    node.refresh("idx")
    body = {"query": {"match": {"title": "w1 w2"}}, "size": 100}
    whole = node.search("idx", body)
    node.close()
    store_dir = os.path.join(path, "indices", "idx", "1", "index")
    if damage == "live.npy":
        seg = next(e for e in sorted(os.listdir(store_dir)) if "_seg_" in e)
        target = os.path.join(store_dir, seg, "live.npy")
    else:
        target = os.path.join(store_dir, "commit.json")
    raw = open(target, "rb").read()
    open(target, "wb").write(raw[: len(raw) // 2])

    t = Node(data_path=path, device="cpu")
    try:
        svc = t.indices["idx"]
        assert svc.shards[1].store_corrupted
        assert not svc.shards[0].store_corrupted
        assert svc.shards[1].engine.store.is_corrupted()  # marker written
        r = t.search("idx", body)
        assert r["_shards"]["failed"] == 1
        failure = r["_shards"]["failures"][0]
        assert failure["shard"] == 1
        assert failure["reason"]["type"] == "corrupt_index_exception"
        want = [h["_id"] for h in whole["hits"]["hits"]
                if svc._route(h["_id"]) != 1]
        assert [h["_id"] for h in r["hits"]["hits"]] == want
    finally:
        t.close()


CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[2])
from elasticsearch_tpu_torch.node import Node
node = Node(data_path=sys.argv[1], device="cpu")
node.create_index("idx", {"settings": {"number_of_shards": 2},
                          "mappings": {"_doc": {"properties": {
                              "id": {"type": "keyword"},
                              "title": {"type": "text"}}}}})
for b in range(1000):
    ops = [("index", {"_index": "idx", "_id": f"b{b}-{i}"},
            {"id": f"b{b}-{i}", "title": f"w{i % 7} w{b % 5} bulk"})
           for i in range(20)]
    r = node.bulk(ops)
    assert not r["errors"]
    print(json.dumps([next(iter(it.values()))["_id"] for it in r["items"]]),
          flush=True)
"""


def test_acked_writes_survive_sigkill_mid_bulk(tmp_path):
    path = str(tmp_path / "data")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", CHILD, path, root],
                            stdout=subprocess.PIPE, text=True)
    acked = []
    try:
        for _ in range(6):
            line = proc.stdout.readline()
            assert line, "the child died before acknowledging"
            acked += json.loads(line)
    finally:
        # the seventh bulk is in flight: no shutdown, no final fsync
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    node = Node(data_path=path, device="cpu")
    try:
        node.refresh("idx")
        for doc_id in acked:
            assert node.get_doc("idx", doc_id)["found"], doc_id
            r = node.search("idx", {"query": {"term": {"id": doc_id}}})
            assert r["hits"]["total"] == 1, doc_id
        everything = node.search("idx", {"query": {"match_all": {}},
                                         "size": 10_000})
        got = [h["_id"] for h in everything["hits"]["hits"]]
        assert len(got) == len(set(got)) == everything["hits"]["total"]
        assert set(acked) <= set(got)
        for sh in node.indices["idx"].shards.values():
            s = sh.seq_no_stats()
            assert s["local_checkpoint"] == s["max_seq_no"]
        # the totals equal an in-memory node that took exactly the
        # recovered ops
        mem = Node(device="cpu")
        mem.create_index("idx", {"settings": {"number_of_shards": 2},
                                 "mappings": {"_doc": {"properties": {
                                     "id": {"type": "keyword"},
                                     "title": {"type": "text"}}}}})
        srcs = {h["_id"]: h["_source"] for h in everything["hits"]["hits"]}
        mem.bulk([("index", {"_index": "idx", "_id": i}, srcs[i])
                  for i in sorted(srcs)], refresh=True)
        for q in ("w1", "w3 w4", "bulk"):
            body = {"query": {"match": {"title": q}}}
            assert node.search("idx", body)["hits"]["total"] == \
                mem.search("idx", body)["hits"]["total"], q
        mem.close()
    finally:
        node.close()


def test_recovered_version_map_waits_for_its_first_read(tmp_path):
    """A recovered shard defers its version map until the first whole
    read: the commit's tombstone and a search leave it deferred, and the
    map then read equals the JAX package's, built at once (versions,
    seqnos, segment, local doc, deleted and term, doc for doc); the next
    write versions from it."""
    paths = {"t": str(tmp_path / "t"), "j": str(tmp_path / "j")}
    t = Node(data_path=paths["t"], device="cpu")
    j = JNode(JSettings({}), data_path=paths["j"])
    for node, settings in ((t, SETTINGS), (j, JAX_SETTINGS)):
        node.create_index("vm", {"settings": settings, "mappings": MAPPING})
        for i in range(40):
            node.index_doc("vm", f"d{i}", {"title": f"w{i % 5}", "year": i})
        node.indices["vm"].refresh()
        node.index_doc("vm", "d3", {"title": "w1 again", "year": 3})
        node.delete_doc("vm", "d7")
        node.indices["vm"].flush()
        node.close()
    t = Node(data_path=paths["t"], device="cpu")
    j = JNode(JSettings({}), data_path=paths["j"])
    try:
        # the shard whose commit holds d7's tombstone put it by its id:
        # both still defer
        deferred = [sh.engine for _sid, sh in
                    sorted(t.indices["vm"].shards.items())
                    if sh.engine._deferred_entries]
        assert len(deferred) == 2
        t.search("vm", {"query": {"match": {"title": "w1"}}})
        assert deferred[0]._deferred_entries
        for (sid, tsh), (_s, jsh) in zip(
                sorted(t.indices["vm"].shards.items()),
                sorted(j.indices["vm"].shards.items())):
            got = {k: (e.version, e.seqno, e.local_doc, e.deleted, e.term)
                   for k, e in tsh.engine.version_map.items()}
            want = {k: (e.version, e.seqno, e.local_doc, e.deleted,
                        getattr(e, "term", 1))
                    for k, e in jsh.engine.version_map.items()}
            assert got == want, sid
            assert not tsh.engine._deferred_entries
        assert t.get_doc("vm", "d3")["_version"] == 2
        assert t.index_doc("vm", "d3", {"title": "w2"})["_version"] == \
            j.index_doc("vm", "d3", {"title": "w2"})["_version"] == 3
    finally:
        t.close()
        j.close()


def test_deferred_version_map_writes_and_gets_by_id(tmp_path):
    """Writes and gets against a recovered shard look their one id up in
    the deferred segments (the map stays deferred): each answers as the
    JAX package's node over the same store, and the map read whole after
    them equals the JAX package's, entry for entry; a flush writes its
    commit with the map still deferred. The index sort puts an updated
    doc's dead copy after its live one in the sealed segment, so the
    id's last doc there is dead."""
    settings = {**SETTINGS, "index": {"sort": {"field": ["year"],
                                               "order": ["asc"]}}}
    paths = {"t": str(tmp_path / "t"), "j": str(tmp_path / "j")}
    t = Node(data_path=paths["t"], device="cpu")
    j = JNode(JSettings({}), data_path=paths["j"])
    for node, extra in ((t, {}), (j, {"search": {"mesh": False}})):
        node.create_index("vm", {"settings": {**settings, **extra},
                                 "mappings": MAPPING})
        for i in range(60):
            node.index_doc("vm", f"d{i}", {"title": f"w{i % 7}",
                                           "year": 2000 + i})
        node.index_doc("vm", "d4", {"title": "w4 again", "year": 1900})
        node.indices["vm"].refresh()
        for i in range(60, 80):
            node.index_doc("vm", f"d{i}", {"title": "w2", "year": 3000 + i})
        node.index_doc("vm", "d9", {"title": "w9 moved", "year": 1950})
        node.delete_doc("vm", "d13")
        node.indices["vm"].flush()
        node.close()
    t = Node(data_path=paths["t"], device="cpu")
    j = JNode(JSettings({}), data_path=paths["j"])
    try:
        engines = [sh.engine for _sid, sh in
                   sorted(t.indices["vm"].shards.items())]
        assert all(e._deferred_entries for e in engines)
        ids = ["d4", "d9", "d13", "d0", "d59", "d61", "d79", "nope"]
        for node in (t, j):
            node.index_doc("vm", "d61", {"title": "w1 updated", "year": 1})
            node.delete_doc("vm", "d0")
        got = [t.get_doc("vm", i) for i in ids]
        assert got == [j.get_doc("vm", i) for i in ids]
        assert [g["_version"] for g in got if g["found"]] == [2, 2, 1, 2, 1]
        for node in (t, j):
            with pytest.raises(Exception) as e:
                node.index_doc("vm", "d4", {"title": "w4"}, version=1)
            assert type(e.value).__name__ == \
                "VersionConflictEngineException"
        assert [t.delete_doc("vm", i) for i in ("d4", "d13", "d79")] == \
            [j.delete_doc("vm", i) for i in ("d4", "d13", "d79")]
        assert all(e._deferred_entries for e in engines)
        # a flush writes the commit's tombstones and terms from the entries
        # looked up by id: the map stays deferred, and the reopened node
        # answers as the JAX package's
        for node in (t, j):
            node.index_doc("vm", "d62", {"title": "w3", "year": 5})
            node.indices["vm"].flush()
            node.close()
        assert all(e._deferred_entries for e in engines)
        t = Node(data_path=paths["t"], device="cpu")
        j = JNode(JSettings({}), data_path=paths["j"])
        assert [t.get_doc("vm", i) for i in ids] == \
            [j.get_doc("vm", i) for i in ids]
        for node in (t, j):
            node.index_doc("vm", "d9", {"title": "w9 back", "year": 2})
            node.delete_doc("vm", "d59")
        for (sid, tsh), (_s, jsh) in zip(
                sorted(t.indices["vm"].shards.items()),
                sorted(j.indices["vm"].shards.items())):
            got = {k: (e.version, e.seqno, e.segment, e.local_doc,
                       e.deleted, e.term)
                   for k, e in tsh.engine.version_map.items()}
            want = {k: (e.version, e.seqno, e.segment, e.local_doc,
                        e.deleted, getattr(e, "term", 1))
                    for k, e in jsh.engine.version_map.items()}
            assert got == want, sid
        t.refresh("vm")
        j.indices["vm"].refresh()
        body = {"query": {"match": {"title": "w1 w2 w4 w9"}}, "size": 100}
        assert_same_hits(j.search("vm", dict(body)),
                         t.search("vm", dict(body)))
    finally:
        t.close()
        j.close()


def test_deferred_version_map_reads_are_whole_under_threads(tmp_path):
    """Readers racing the first read of a deferred version map each see
    every entry: the deferred list empties only once the map is whole
    (16 threads, a short switch interval)."""
    import threading

    node = Node(data_path=str(tmp_path / "n"), device="cpu")
    node.create_index("idx", {"settings": {**SETTINGS,
                                          "number_of_shards": 1},
                             "mappings": MAPPING})
    ids = [f"d{i}" for i in range(3000)]
    bulk(node, ids, seeded_docs(len(ids), seed=4))
    node.indices["idx"].flush()
    node.close()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    node = Node(data_path=str(tmp_path / "n"), device="cpu")
    try:
        engine = node.indices["idx"].shards[0].engine
        assert engine._deferred_entries
        go = threading.Barrier(16)
        seen = []

        def reader(i):
            go.wait(60)
            seen.append(len(engine.version_map)
                        if i % 2 else engine.get(ids[-1 - i]).found)

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert sorted(seen, key=str) == sorted(
            [True] * 8 + [len(ids)] * 8, key=str)
    finally:
        sys.setswitchinterval(old)
        node.close()
