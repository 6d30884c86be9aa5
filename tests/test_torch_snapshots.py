"""Snapshot and restore on the port, against the JAX package.

Mirrors tests/test_snapshot_status.py's status, abort, missing and
delete-timeout cases and tests/test_corruption.py's snapshot cases
(digests on create, ``_status`` flagging a corrupt blob, a restore that
fails the corrupt index alone). Then, in both packages: a snapshot of an
index on a node without a data path (the port has no store there and
writes the flushed segments straight into the repository; the manifest
must name the same files as the JAX package's, with the same digests but
where the bytes of one content may differ: see ``_CONTENT_ONLY``), a
restore with
``rename_pattern`` whose answers equal the source's, the REST routes and
cat tables, an incremental snapshot that writes no byte, and
repositories kept across a restart in the global ``_state``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu_torch.common.errors import (
    ResourceAlreadyExistsException,
    ResourceNotFoundException,
)
from elasticsearch_tpu_torch.common.integrity import integrity_service
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.snapshots import service as tsnap
from torch_pair import NodePair

MAPPING = {"properties": {"msg": {"type": "text"}, "n": {"type": "integer"},
                          "tag": {"type": "keyword"}}}


def _seed(node, name="snapme", shards=3, count=30, seed=3):
    rng = np.random.default_rng(seed)
    node.create_index(name, {"settings": {"number_of_shards": shards,
                                          "refresh_interval": -1},
                             "mappings": MAPPING})
    for i in range(count):
        node.index_doc(name, str(i), {
            "msg": f"event {int(rng.integers(0, 5))} w{i % 4}",
            "n": int(rng.integers(0, 1000)), "tag": f"t{i % 3}"})
    node.indices[name].refresh()


@pytest.fixture()
def node(tmp_path):
    n = Node(Settings({"path.repo": [str(tmp_path / "repos")]}),
             device="cpu")
    _seed(n)
    n.snapshots.put_repository("r1", {"type": "fs",
                                      "settings": {"location": "statusrepo"}})
    yield n
    n.close()


def _gate_shard_writes(monkeypatch, gate, started=None):
    """Hold each shard's write into the repository until ``gate``."""
    orig = tsnap.SnapshotsService._write_storeless_shard

    def slow(shard, dst, counts):
        if started is not None:
            started.set()
        gate.wait(10)
        return orig(shard, dst, counts)

    monkeypatch.setattr(tsnap.SnapshotsService, "_write_storeless_shard",
                        staticmethod(slow))


class TestSnapshotStatus:
    def test_status_visible_mid_snapshot(self, node, monkeypatch):
        gate = threading.Event()
        _gate_shard_writes(monkeypatch, gate)
        r = node.snapshots.create_snapshot("r1", "live", {},
                                           wait_for_completion=False)
        assert r == {"accepted": True}
        time.sleep(0.05)
        s = node.snapshots.snapshot_status("r1", "live")["snapshots"][0]
        assert s["state"] == "IN_PROGRESS"
        assert s["shards_stats"]["total"] == 3
        assert s["shards_stats"]["done"] < 3
        assert s["indices"]["snapme"]
        # the running snapshot is also the repository's current one
        cur = node.snapshots.snapshot_status("r1")["snapshots"]
        assert [c["snapshot"] for c in cur] == ["live"]
        with pytest.raises(ResourceAlreadyExistsException):
            node.snapshots.create_snapshot("r1", "live")
        gate.set()
        deadline = time.time() + 10
        while time.time() < deadline:
            s = node.snapshots.snapshot_status("r1", "live")["snapshots"][0]
            if s["state"] == "SUCCESS":
                break
            time.sleep(0.02)
        assert s["state"] == "SUCCESS"
        assert s["shards_stats"]["done"] == 3

    def test_abort_leaves_repo_consistent(self, node, monkeypatch):
        gate = threading.Event()
        _gate_shard_writes(monkeypatch, gate)
        node.snapshots.create_snapshot("r1", "doomed", {},
                                       wait_for_completion=False)
        time.sleep(0.05)
        t0 = time.time()
        gate.set()
        assert node.snapshots.delete_snapshot("r1", "doomed") == \
            {"acknowledged": True}
        assert time.time() - t0 < 10
        repo = node.snapshots._repo("r1")
        assert "doomed" not in repo.list_snapshots()
        assert not os.path.exists(repo.snapshot_path("doomed"))
        r = node.snapshots.create_snapshot("r1", "after")
        assert r["snapshot"]["state"] == "SUCCESS"

    def test_status_of_completed_snapshot_from_manifest(self, node):
        node.snapshots.create_snapshot("r1", "done1")
        s = node.snapshots.snapshot_status("r1", "done1")["snapshots"][0]
        assert s["state"] == "SUCCESS"
        assert s["shards_stats"]["done"] == s["shards_stats"]["total"] == 3

    def test_status_missing_snapshot_404(self, node):
        with pytest.raises(ResourceNotFoundException):
            node.snapshots.snapshot_status("r1", "nope")

    def test_delete_timeout_flags_worker_cleanup(self, node, monkeypatch):
        gate, copying = threading.Event(), threading.Event()
        _gate_shard_writes(monkeypatch, gate, started=copying)
        assert node.snapshots.create_snapshot(
            "r1", "racy", {}, wait_for_completion=False) == {"accepted": True}
        assert copying.wait(5)
        prog = node.snapshots._in_progress[("r1", "racy")]

        class _NeverDone:
            def __init__(self, real):
                self.real = real

            def wait(self, timeout=None):
                return False

            def is_set(self):
                return self.real.is_set()

            def set(self):
                self.real.set()

        real_done = prog["done"]
        prog["done"] = _NeverDone(real_done)
        assert node.snapshots.delete_snapshot("r1", "racy") == \
            {"acknowledged": True}
        assert prog["delete_requested"] is True
        gate.set()
        assert real_done.wait(10)
        time.sleep(0.05)
        assert prog["state"] == "ABORTED"
        repo = node.snapshots._repo("r1")
        assert not os.path.exists(repo.snapshot_path("racy"))
        assert "racy" not in repo.list_snapshots()


def _corrupt_snapshot_blob(repo, snapshot, index):
    """Flip one bit in the first digest-covered blob of one index."""
    m = repo.read_manifest(snapshot)
    sid, sinfo = next(iter(m["indices"][index]["shards"].items()))
    rel = next(iter(sinfo["digests"]))
    full = os.path.join(repo.snapshot_path(snapshot), "indices", index,
                        str(sid), rel)
    with open(full, "r+b") as f:
        data = bytearray(f.read())
        data[0] ^= 0x01
        f.seek(0)
        f.write(data)


class TestSnapshotIntegrity:
    @pytest.fixture()
    def node(self, tmp_path):
        n = Node(device="cpu")
        for name in ("snap_a", "snap_b"):
            _seed(n, name, shards=1, count=8)
        n.snapshots.put_repository(
            "ri", {"type": "fs",
                   "settings": {"location": str(tmp_path / "repo")}})
        yield n
        n.close()

    def test_create_records_digests_status_verifies(self, node):
        node.snapshots.create_snapshot("ri", "s1")
        m = node.snapshots._repo("ri").read_manifest("s1")
        digests = m["indices"]["snap_a"]["shards"]["0"]["digests"]
        assert digests and all(len(d) == 64 for d in digests.values())
        ver = node.snapshots.snapshot_status("ri", "s1")["snapshots"][0][
            "indices"]["snap_a"]["0"]["verification"]
        assert ver["verified"]
        assert ver["files_verified"] == ver["files_total"] > 0

    def test_status_flags_corrupt_blob(self, node):
        node.snapshots.create_snapshot("ri", "s2")
        _corrupt_snapshot_blob(node.snapshots._repo("ri"), "s2", "snap_a")
        ver = node.snapshots.snapshot_status("ri", "s2")["snapshots"][0][
            "indices"]["snap_a"]["0"]["verification"]
        assert not ver["verified"]
        assert ver["files_verified"] < ver["files_total"]

    def test_restore_fails_only_the_corrupt_index(self, node):
        node.snapshots.create_snapshot("ri", "s3")
        _corrupt_snapshot_blob(node.snapshots._repo("ri"), "s3", "snap_a")
        node.delete_index("snap_a")
        node.delete_index("snap_b")
        before = integrity_service().stats()
        snap = node.snapshots.restore_snapshot("ri", "s3")["snapshot"]
        assert snap["indices"] == ["snap_b"]
        assert snap["shards"]["failed"] == 1
        fail = snap["failures"][0]
        assert fail["index"] == "snap_a"
        assert fail["type"] == "corrupted_snapshot_exception"
        assert "snap_a" not in node.indices
        assert node.indices["snap_b"].search(
            {"query": {"match_all": {}}})["hits"]["total"] == 8
        after = integrity_service().stats()
        assert (after["corruption_detected_by_site"]["restore"]
                - before["corruption_detected_by_site"]["restore"]) == 1


@pytest.fixture()
def pair(tmp_path):
    p = NodePair({"path.repo": [str(tmp_path / "repos")]})
    for n in (p.j, p.t):
        _seed(n, "src", shards=3, count=40)
    p.repo_root = tmp_path
    yield p
    p.close()


# the files whose bytes may differ for the same docs: the npz's zip
# entries carry a write time; ``positions.json`` is the same object with
# its term ids ascending in the port (first seen first in the JAX
# package), and ``checksums.json`` holds both files' digests. Their
# contents are compared instead.
_CONTENT_ONLY = ("arrays.npz", "positions.json", "checksums.json")


def test_storeless_snapshot_manifest_matches_jax(pair):
    root = pair.repo_root
    for n, sub in ((pair.j, "j"), (pair.t, "t")):
        n.snapshots.put_repository("r", {"type": "fs", "settings": {
            "location": str(root / sub)}})
        n.snapshots.create_snapshot("r", "s")
    jm = json.loads((root / "j" / "snapshots" / "s" / "manifest.json")
                    .read_text())
    tm = json.loads((root / "t" / "snapshots" / "s" / "manifest.json")
                    .read_text())
    ji, ti = jm["indices"]["src"], tm["indices"]["src"]
    assert set(ji["shards"]) == set(ti["shards"]) == {"0", "1", "2"}
    for sid, jshard in ji["shards"].items():
        tshard = ti["shards"][sid]
        assert tshard["segments"] == jshard["segments"]
        assert set(tshard["digests"]) == set(jshard["digests"])
        tblob = root / "t" / "snapshots" / "s" / "indices" / "src" / sid
        jblob = root / "j" / "snapshots" / "s" / "indices" / "src" / sid
        for rel, digest in jshard["digests"].items():
            name = os.path.basename(rel)
            # every digest is the SHA-256 of the blob the repository holds
            assert tsnap._sha256_file(str(tblob / rel)) == \
                tshard["digests"][rel]
            if name not in _CONTENT_ONLY:
                assert tshard["digests"][rel] == digest, rel
            elif name == "arrays.npz":
                jarr, tarr = np.load(jblob / rel), np.load(tblob / rel)
                assert sorted(jarr.files) == sorted(tarr.files)
                for key in jarr.files:
                    np.testing.assert_array_equal(jarr[key], tarr[key])
            else:
                jd = json.loads((jblob / rel).read_text())
                td = json.loads((tblob / rel).read_text())
                assert set(td) == set(jd), rel
                if name == "positions.json":
                    assert td == jd
    assert ti["mappings"] == ji["mappings"]
    assert ti["aliases"] == ji["aliases"]


def test_restore_answers_equal_the_source(pair):
    pair.same("PUT", "/_snapshot/r", {"type": "fs", "settings": {
        "location": "rr"}}, status=200)
    pair.same("PUT", "/_snapshot/r/s1", {"indices": "src"},
              params={"wait_for_completion": "true"}, status=200)
    pair.same("POST", "/_snapshot/r/s1/_restore", {
        "indices": "src", "rename_pattern": "src",
        "rename_replacement": "restored"}, status=200)
    pair.same("POST", "/_snapshot/r/s1/_restore", {
        "indices": "src", "rename_pattern": "src",
        "rename_replacement": "restored"}, status=400)
    bodies = [
        {"query": {"match": {"msg": "event 3"}}, "size": 10},
        {"query": {"match_all": {}}, "sort": [{"n": "desc"}], "size": 7},
        {"query": {"term": {"tag": "t1"}}, "size": 0,
         "aggs": {"t": {"terms": {"field": "tag"}}}},
        {"query": {"range": {"n": {"gte": 100, "lt": 600}}}, "size": 40},
    ]
    for body in bodies:
        src = pair.t.search("src", body)
        for node in (pair.t, pair.j):
            got = node.search("restored", body)
            assert got["hits"]["total"] == src["hits"]["total"]
            assert [h["_id"] for h in got["hits"]["hits"]] == \
                [h["_id"] for h in src["hits"]["hits"]]
            assert got.get("aggregations") == src.get("aggregations")
        pair.same("POST", "/restored/_search", body, status=200)
    # the restored index takes writes
    pair.t.index_doc("restored", "new", {"msg": "event 3", "n": 1,
                                         "tag": "t9"})
    pair.t.indices["restored"].refresh()
    assert pair.t.search("restored", {"size": 0})["hits"]["total"] == 41


def test_rest_routes_and_cat_tables_like_jax(pair):
    pair.same("GET", "/_snapshot", status=200)
    pair.same("PUT", "/_snapshot/r", {"type": "fs", "settings": {
        "location": "rest"}}, status=200)
    pair.same("POST", "/_snapshot/r2", {"type": "fs", "settings": {
        "location": "rest2"}}, status=200)
    pair.same("PUT", "/_snapshot/bad", {"type": "s3", "settings": {}},
              status=400)
    pair.same("PUT", "/_snapshot/esc", {"type": "fs", "settings": {
        "location": "../../outside"}}, status=400)
    pair.same("GET", "/_snapshot", status=200)
    pair.same("GET", "/_snapshot/r", status=200)
    pair.same("GET", "/_snapshot/nope", status=404)
    pair.same("POST", "/_snapshot/r/_verify", status=200)
    pair.same("PUT", "/_snapshot/r/a", {"indices": "src"}, status=200)
    pair.same("PUT", "/_snapshot/r/a", {"indices": "src"}, status=400)
    pair.same("GET", "/_snapshot/r/_status", status=200)
    pair.same("GET", "/_snapshot/r/nope/_status", status=404)
    pair.same("GET", "/_cat/repositories", params={"format": "json"},
              status=200)
    (js, jb), (ts, tb) = pair.call("GET", "/_cat/snapshots/r",
                                   params={"format": "json"})
    assert js == ts == 200
    assert [(r["id"], r["status"], r["indices"]) for r in tb] == \
        [(r["id"], r["status"], r["indices"]) for r in jb]
    pair.same("DELETE", "/_snapshot/r/a", status=200)
    pair.same("DELETE", "/_snapshot/r/a", status=404)
    pair.same("DELETE", "/_snapshot/r2", status=200)
    pair.same("DELETE", "/_snapshot/r2", status=404)
    pair.same("GET", "/_snapshot", status=200)


def test_incremental_snapshot_writes_no_new_bytes(tmp_path):
    node = Node(data_path=str(tmp_path / "data"), device="cpu")
    try:
        _seed(node, "dur", shards=2, count=20)
        node.snapshots.put_repository("r", {"type": "fs", "settings": {
            "location": str(tmp_path / "repo")}})
        node.snapshots.create_snapshot("r", "s1")
        assert node.snapshots.bytes_written > 0
        assert node.snapshots.bytes_reused == 0
        first = node.snapshots.bytes_written
        node.snapshots.create_snapshot("r", "s2")
        assert node.snapshots.bytes_written == 0
        assert node.snapshots.bytes_reused == first
        repo = node.snapshots._repo("r")
        assert repo.read_manifest("s1")["indices"]["dur"]["shards"] == \
            repo.read_manifest("s2")["indices"]["dur"]["shards"]
        # a new doc: only the files that changed are written
        node.index_doc("dur", "x", {"msg": "event 9", "n": 1, "tag": "t"})
        node.snapshots.create_snapshot("r", "s3")
        assert 0 < node.snapshots.bytes_written < first
        # deleting one snapshot keeps the other's blobs whole
        node.snapshots.delete_snapshot("r", "s1")
        node.delete_index("dur")
        out = node.snapshots.restore_snapshot("r", "s2")
        assert out["snapshot"]["indices"] == ["dur"]
        assert node.search("dur", {"size": 0})["hits"]["total"] == 20
    finally:
        node.close()


def test_repositories_survive_a_restart(tmp_path):
    d = str(tmp_path / "data")
    node = Node(data_path=d, device="cpu")
    try:
        node.snapshots.put_repository("keep", {"type": "fs", "settings": {
            "location": "keep"}})
        _seed(node, "x", shards=1, count=4)
        node.snapshots.create_snapshot("keep", "s")
        loc = node.snapshots._repo("keep").location
        assert loc == os.path.join(d, "repos", "keep")
    finally:
        node.close()
    node = Node(data_path=d, device="cpu")
    try:
        assert node.snapshots.get_repository() == {"keep": {
            "type": "fs", "settings": {"location": "keep"}}}
        assert node.snapshots.get_snapshot("keep", "s")["snapshots"][0][
            "state"] == "SUCCESS"
    finally:
        node.close()
