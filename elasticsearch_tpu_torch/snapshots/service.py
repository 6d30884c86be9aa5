"""Snapshot and restore to shared-filesystem repositories.

Counterpart of ``elasticsearch_tpu/snapshots/service.py``. A repository
(``fs``) is a directory: ``snapshots/<name>/manifest.json`` (each index's
settings, mappings, aliases and, per shard, its segment count and the
SHA-256 of every file) beside ``snapshots/<name>/indices/<index>/<shard>/``,
a copy of the shard's store (``commit.json`` and one directory a segment,
``index/store.py``'s layout). A relative ``location`` resolves under the
first ``path.repo`` entry, else ``<path.data>/repos`` on a durable node,
else a per-process temporary root shared by every node of the process;
the JAX package reads no ``path.repo`` (ROADMAP, deviations).

``create_snapshot`` flushes each index first, then copies each shard's
store file by file, hashing what it copies. A file whose digest equals
the same index, shard and path in an earlier snapshot of the repository
is hard-linked from there instead of written again (the incremental
snapshot: ``bytes_written`` / ``bytes_reused`` of the last snapshot). A
shard without a store (a node without a data path keeps none; the JAX
package gives such a shard a temporary store) has its flushed segments
and commit point written straight into the repository through
``index/store.py``'s segment writer: the same files and layout the JAX
package would have copied. A store marked corrupted never seeds a
snapshot. ``wait_for_completion=false`` runs the copy on a thread;
``snapshot_status`` reports its shards' stages, and a delete aborts it
and leaves the repository consistent. ``restore_snapshot`` verifies
every blob of an index against its manifest digest before it creates
the index (a corrupt index fails alone, counted by
``common/integrity.py``), then installs each shard
(``IndexShard.restore_from_snapshot``); the restored index stages on the
device at its first search, as a recovered one does. Repositories live
in the cluster state and in a durable node's global ``_state``.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    CorruptedSnapshotException,
    ElasticsearchTpuException,
    IllegalArgumentException,
    ResourceAlreadyExistsException,
    ResourceNotFoundException,
)
from elasticsearch_tpu_torch.common.integrity import integrity_service
from elasticsearch_tpu_torch.common.settings import PATH_REPO, Settings
from elasticsearch_tpu_torch.index.store import MARKER_PREFIX, Store


class SnapshotState:
    SUCCESS = "SUCCESS"
    IN_PROGRESS = "IN_PROGRESS"
    FAILED = "FAILED"
    ABORTED = "ABORTED"


# process-wide repo root for in-memory nodes: a shared-filesystem repository
# contract means the SAME relative location must alias the SAME directory on
# every node (RepositoriesService resolves against the configured path.repo
# the same way), so the fallback root is per-process, not per-node. Created
# lazily, removed at interpreter exit.
_proc_repo_base: Optional[str] = None
_proc_repo_lock = threading.Lock()


def _process_repo_base() -> str:
    global _proc_repo_base
    with _proc_repo_lock:
        if _proc_repo_base is None:
            _proc_repo_base = tempfile.mkdtemp(prefix="estpu-repos-")
            atexit.register(shutil.rmtree, _proc_repo_base,
                            ignore_errors=True)
        return _proc_repo_base


class FsRepository:
    """Shared-filesystem blob repository (core/.../repositories/fs)."""

    def __init__(self, name: str, settings: dict, base_path: Optional[str] = None):
        self.name = name
        location = settings.get("location")
        if not location:
            raise IllegalArgumentException("[fs] repository requires [location] setting")
        # Relative locations resolve under the node's repo root and must stay
        # inside it (the analog of the reference's path.repo containment check,
        # core/.../env/Environment.resolveRepoFile) so conformance suites with
        # bare names don't scatter dirs into the cwd.
        if base_path and not os.path.isabs(location):
            resolved = os.path.realpath(os.path.join(base_path, location))
            root = os.path.realpath(base_path)
            if not (resolved == root or resolved.startswith(root + os.sep)):
                raise IllegalArgumentException(
                    f"location [{location}] resolves outside the repository root")
            location = resolved
        self.location = location
        os.makedirs(location, exist_ok=True)

    def snapshot_path(self, snapshot: str) -> str:
        return os.path.join(self.location, "snapshots", snapshot)

    def list_snapshots(self) -> List[str]:
        root = os.path.join(self.location, "snapshots")
        if not os.path.isdir(root):
            return []
        return sorted(
            d for d in os.listdir(root)
            if os.path.exists(os.path.join(root, d, "manifest.json"))
        )

    def read_manifest(self, snapshot: str) -> dict:
        path = os.path.join(self.snapshot_path(snapshot), "manifest.json")
        if not os.path.exists(path):
            raise ResourceNotFoundException(f"[{self.name}:{snapshot}] snapshot does not exist")
        with open(path, encoding="utf-8") as f:
            return json.load(f)


class SnapshotsService:
    def __init__(self, node):
        self.node = node
        self.repositories: Dict[str, FsRepository] = {}
        # RepositoryPlugin extension point: {type: factory(name, settings,
        # node)} — fs is built-in, cloud types arrive via plugins
        self.repository_types: Dict[str, object] = {}
        # live snapshot progress: (repo, snapshot) -> tracking dict
        # (SnapshotsInProgress custom in the reference's cluster state)
        self._in_progress: Dict[tuple, dict] = {}
        self._progress_lock = threading.Lock()
        # the last finished snapshot's bytes: copied or written anew, and
        # hard-linked from an earlier snapshot
        self.bytes_written = 0
        self.bytes_reused = 0

    # --- repositories ---

    def _repo_base_path(self) -> str:
        """Root under which relative fs-repo locations resolve: the first
        ``path.repo`` entry, else <path.data>/repos on a durable node,
        else the process-wide temporary root (a bare relative location
        never touches the cwd and names the same directory on every node
        of the process)."""
        roots = PATH_REPO.get(self.node.settings)
        if isinstance(roots, str):
            roots = [r for r in roots.split(",") if r]
        if roots:
            return roots[0]
        if getattr(self.node, "persistent_path", False):
            return os.path.join(self.node.data_path, "repos")
        return _process_repo_base()

    def close(self) -> None:
        # the in-memory repo root is process-scoped (shared across nodes),
        # cleaned by atexit — nothing node-scoped to release here
        pass

    def put_repository(self, name: str, body: dict) -> dict:
        rtype = body.get("type")
        if rtype == "fs":
            settings = body.get("settings") or {}
            loc = settings.get("location")
            base = (self._repo_base_path()
                    if loc and not os.path.isabs(loc) else None)
            repo = FsRepository(name, settings, base_path=base)
        elif rtype in self.repository_types:
            repo = self.repository_types[rtype](
                name, body.get("settings") or {}, self.node)
        else:
            raise IllegalArgumentException(
                f"repository type [{rtype}] does not exist (supported: fs"
                f"{''.join(', ' + t for t in sorted(self.repository_types))}; "
                "url/s3/azure/gcs arrive with their cloud plugins)"
            )
        self.repositories[name] = repo

        def update(state):
            new = state.copy()
            new.repositories[name] = body
            return new

        self.node.cluster_service.submit_state_update_task(f"put-repo [{name}]", update)
        return {"acknowledged": True}

    def get_repository(self, name: Optional[str] = None) -> dict:
        repos = self.node.cluster_service.state.repositories
        if name in (None, "_all", "*"):
            return dict(repos)
        if name not in repos:
            raise ResourceNotFoundException(f"[{name}] missing")
        return {name: repos[name]}

    def delete_repository(self, name: str) -> dict:
        if name not in self.repositories:
            raise ResourceNotFoundException(f"[{name}] missing")
        self.repositories.pop(name)

        def update(state):
            new = state.copy()
            new.repositories.pop(name, None)
            return new

        self.node.cluster_service.submit_state_update_task(f"delete-repo [{name}]", update)
        return {"acknowledged": True}

    def _repo(self, name: str) -> FsRepository:
        repo = self.repositories.get(name)
        if repo is None:
            raise ResourceNotFoundException(f"[{name}] missing")
        return repo

    def verify_repository(self, name: str) -> dict:
        """POST /_snapshot/{repo}/_verify (VerifyRepositoryAction):
        write, read back, and delete a probe blob so a misconfigured /
        read-only / bit-flipping repository is caught at registration
        time, not at the first snapshot. Reports the verifying
        "node"s, reference-shaped."""
        repo = self._repo(name)
        probe = os.path.join(
            repo.location, f"verify-{uuid.uuid4().hex[:12]}.probe")
        payload = uuid.uuid4().hex.encode("ascii")
        try:
            with open(probe, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            with open(probe, "rb") as f:
                echoed = f.read()
        except OSError as e:
            raise ElasticsearchTpuException(
                f"[{name}] repository verification failed: probe blob "
                f"could not be written/read ({e})") from e
        finally:
            try:
                os.remove(probe)
            except OSError:
                pass
        if echoed != payload:
            raise ElasticsearchTpuException(
                f"[{name}] repository verification failed: probe blob "
                f"read back different bytes than written")
        node_id = (getattr(self.node, "node_id", None)
                   or getattr(self.node, "node_name", None) or "node")
        node_name = getattr(self.node, "node_name", None) or node_id
        return {"nodes": {node_id: {"name": node_name}}}

    # --- snapshot ---

    def create_snapshot(self, repo_name: str, snapshot: str,
                        body: Optional[dict] = None,
                        wait_for_completion: bool = True) -> dict:
        """Coordinated snapshot with live per-shard progress tracking
        (SnapshotsService:105 + SnapshotShardsService). With
        ``wait_for_completion=False`` the copy runs on a background
        thread and ``_snapshot/_status`` reports shard stages mid-flight;
        deleting an IN_PROGRESS snapshot aborts it and leaves the repo
        consistent (the partial directory is removed)."""
        repo = self._repo(repo_name)
        body = body or {}
        key = (repo_name, snapshot)
        with self._progress_lock:
            if key in self._in_progress:
                raise ResourceAlreadyExistsException(
                    f"[{repo_name}:{snapshot}] snapshot is already running")
            if snapshot in repo.list_snapshots():
                raise ResourceAlreadyExistsException(
                    f"[{repo_name}:{snapshot}] snapshot with the same name "
                    f"already exists")
            indices_expr = body.get("indices", "_all")
            names = self.node.cluster_service.state.resolve_index_names(
                indices_expr)
            progress = {
                "state": SnapshotState.IN_PROGRESS,
                "start_time_in_millis": int(time.time() * 1000),
                "abort": threading.Event(),
                "done": threading.Event(),
                # set by delete_snapshot when its abort wait timed out:
                # the WORKER owns the partial directory and must clean it
                # up (and suppress a SUCCESS manifest) instead of racing
                # the deleter's rmtree against its own copytree
                "delete_requested": False,
                # (index, sid) -> stage: INIT | STARTED | DONE | FAILURE
                "shards": {(n, sid): "INIT" for n in names
                           for sid in self.node.indices[n].shards},
                "result": None,
            }
            self._in_progress[key] = progress
        if wait_for_completion:
            self._run_snapshot(repo, repo_name, snapshot, names, progress)
            if progress["state"] == SnapshotState.FAILED:
                # synchronous callers get the error as an error, exactly
                # as before the async path existed — not a 200 whose body
                # lacks the success shape
                raise ElasticsearchTpuException(
                    f"[{repo_name}:{snapshot}] snapshot failed: "
                    f"{progress['result'].get('reason')}")
            return {"snapshot": progress["result"]}
        t = threading.Thread(
            target=self._run_snapshot,
            args=(repo, repo_name, snapshot, names, progress),
            name=f"snapshot[{repo_name}:{snapshot}]", daemon=True)
        t.start()
        return {"accepted": True}

    def _run_snapshot(self, repo, repo_name: str, snapshot: str,
                      names, progress) -> None:
        key = (repo_name, snapshot)
        snap_dir = repo.snapshot_path(snapshot)
        aborted = False
        try:
            os.makedirs(snap_dir, exist_ok=True)
            manifest = {
                "snapshot": snapshot,
                "state": SnapshotState.IN_PROGRESS,
                "start_time_in_millis": progress["start_time_in_millis"],
                "indices": {},
            }
            shards_total = 0
            counts = {"written": 0, "reused": 0}
            previous = self._previous_blobs(repo, snapshot)
            for name in names:
                svc = self.node.indices[name]
                svc.flush()  # durable commit before copying (the
                # reference snapshots from a Lucene commit the same way)
                md = self.node.cluster_service.state.indices[name]
                idx_dir = os.path.join(snap_dir, "indices", name)
                shard_info = {}
                for sid, shard in svc.shards.items():
                    if progress["abort"].is_set():
                        aborted = True
                        break
                    progress["shards"][(name, sid)] = "STARTED"
                    shards_total += 1
                    store = shard.engine.store
                    if store is not None and store.is_corrupted():
                        # a marked copy never seeds a snapshot: the
                        # repository would keep the corruption
                        integrity_service().record_corruption(
                            name, sid, "snapshot",
                            "store is marked corrupted")
                        progress["shards"][(name, sid)] = "FAILURE"
                        raise ElasticsearchTpuException(
                            f"cannot snapshot [{name}][{sid}]: store is "
                            f"marked corrupted")
                    dst = os.path.join(idx_dir, str(sid))
                    if store is None:
                        digests = self._write_storeless_shard(shard, dst,
                                                              counts)
                    else:
                        digests = self._copy_shard_store(
                            store.directory, dst,
                            previous.get((name, str(sid)), {}), counts)
                    shard_info[str(sid)] = {
                        "segments": len(shard.engine.segments),
                        "digests": digests}
                    progress["shards"][(name, sid)] = "DONE"
                if aborted:
                    break
                manifest["indices"][name] = {
                    "settings": md.settings.as_dict(),
                    "mappings": svc.mapping_dict(),
                    "aliases": md.aliases,
                    "shards": shard_info,
                }
            # last-chance abort check BEFORE the manifest write: a delete
            # raced past the per-shard checks — it must not observe a
            # SUCCESS manifest for a snapshot it was told is gone
            if progress["abort"].is_set() or progress["delete_requested"]:
                aborted = True
            if aborted:
                # abort leaves the repository consistent: the partial
                # snapshot directory is removed entirely (the reference
                # cleans up aborted shard blobs the same way)
                shutil.rmtree(snap_dir, ignore_errors=True)
                progress["state"] = SnapshotState.ABORTED
                progress["result"] = {
                    "snapshot": snapshot, "state": SnapshotState.ABORTED}
                return
            manifest["state"] = SnapshotState.SUCCESS
            manifest["end_time_in_millis"] = int(time.time() * 1000)
            self.bytes_written = counts["written"]
            self.bytes_reused = counts["reused"]
            with open(os.path.join(snap_dir, "manifest.json"), "w",
                      encoding="utf-8") as f:
                json.dump(manifest, f)
            progress["state"] = SnapshotState.SUCCESS
            progress["result"] = {
                "snapshot": snapshot,
                "uuid": snapshot,
                "state": manifest["state"],
                "indices": list(manifest["indices"].keys()),
                "shards": {"total": shards_total, "failed": 0,
                           "successful": shards_total},
            }
        except Exception as e:  # noqa: BLE001 — surface via status
            shutil.rmtree(snap_dir, ignore_errors=True)
            progress["state"] = SnapshotState.FAILED
            progress["result"] = {"snapshot": snapshot,
                                  "state": SnapshotState.FAILED,
                                  "reason": f"{type(e).__name__}: {e}"}
        finally:
            # a delete that timed out waiting for us owns no files: the
            # worker is the only writer under snap_dir, so it performs
            # the removal the deleter could not do safely. The flag
            # check and done.set() are atomic under the progress lock so
            # a deleter setting the flag either is seen here or observes
            # done already set (and falls through to its own fs delete)
            with self._progress_lock:
                if progress["delete_requested"]:
                    shutil.rmtree(snap_dir, ignore_errors=True)
                    progress["state"] = SnapshotState.ABORTED
                    progress["result"] = {
                        "snapshot": snapshot,
                        "state": SnapshotState.ABORTED}
                progress["done"].set()
                self._in_progress.pop(key, None)

    def snapshot_status(self, repo_name: str,
                        snapshot: Optional[str] = None) -> dict:
        """_snapshot/_status (TransportSnapshotsStatusAction): live
        per-shard stages for running snapshots; completed ones from the
        repository manifest. Without a snapshot name: every snapshot
        currently running in the repo."""
        out = []
        with self._progress_lock:
            running = {k: v for k, v in self._in_progress.items()
                       if k[0] == repo_name}
        if snapshot in (None, "_current"):
            wanted = list(running)
        else:
            wanted = [(repo_name, snapshot)]
        for key in wanted:
            prog = running.get(key)
            if prog is not None:
                stages = prog["shards"]
                counts = {"initializing": 0, "started": 0, "done": 0,
                          "failed": 0}
                per_index: dict = {}
                for (iname, sid), stage in stages.items():
                    counts[{"INIT": "initializing", "STARTED": "started",
                            "DONE": "done",
                            "FAILURE": "failed"}[stage]] += 1
                    per_index.setdefault(iname, {})[str(sid)] = {
                        "stage": stage}
                out.append({
                    "snapshot": key[1],
                    "repository": repo_name,
                    "state": prog["state"],
                    "shards_stats": dict(counts,
                                         total=len(stages)),
                    "indices": per_index,
                })
                continue
            repo = self._repo(repo_name)
            if key[1] not in repo.list_snapshots():
                raise ResourceNotFoundException(
                    f"[{repo_name}:{key[1]}] snapshot does not exist")
            m = repo.read_manifest(key[1])
            shards = {(iname, sid)
                      for iname, info in m["indices"].items()
                      for sid in info.get("shards", {})}
            snap_dir = repo.snapshot_path(key[1])
            per_index: dict = {}
            for iname, info in m["indices"].items():
                for sid, sinfo in (info.get("shards") or {}).items():
                    entry: dict = {"stage": "DONE"}
                    digests = (sinfo or {}).get("digests")
                    if digests:
                        # per-file digest verification state:
                        # re-hash the repo blobs against the manifest so
                        # _status answers "would this snapshot restore?"
                        shard_dir = os.path.join(
                            snap_dir, "indices", iname, str(sid))
                        ok = 0
                        for rel, expected in digests.items():
                            try:
                                with open(os.path.join(shard_dir, rel),
                                          "rb") as f:
                                    if (hashlib.sha256(f.read())
                                            .hexdigest() == expected):
                                        ok += 1
                            except OSError:
                                pass
                        entry["verification"] = {
                            "files_total": len(digests),
                            "files_verified": ok,
                            "verified": ok == len(digests)}
                    per_index.setdefault(iname, {})[str(sid)] = entry
            out.append({
                "snapshot": key[1],
                "repository": repo_name,
                "state": m["state"],
                "shards_stats": {"initializing": 0, "started": 0,
                                 "failed": 0, "done": len(shards),
                                 "total": len(shards)},
                "indices": per_index,
            })
        return {"snapshots": out}

    def get_snapshot(self, repo_name: str, snapshot: Optional[str] = None) -> dict:
        repo = self._repo(repo_name)
        if snapshot in (None, "_all", "*"):
            names = repo.list_snapshots()
        else:
            names = [snapshot]
        out = []
        for s in names:
            m = repo.read_manifest(s)
            out.append({
                "snapshot": s,
                "state": m["state"],
                "indices": list(m["indices"].keys()),
                "start_time_in_millis": m.get("start_time_in_millis"),
                "end_time_in_millis": m.get("end_time_in_millis"),
            })
        return {"snapshots": out}

    def delete_snapshot(self, repo_name: str, snapshot: str) -> dict:
        # DELETE of a RUNNING snapshot aborts it (SnapshotsService:105:
        # deleteSnapshot sets the abort flag and waits for the shards to
        # stop); the worker removes the partial directory itself
        with self._progress_lock:
            prog = self._in_progress.get((repo_name, snapshot))
        if prog is not None:
            prog["abort"].set()
            if not prog["done"].wait(30):
                # the worker is still copying: IT owns the partial
                # directory. Flag the delete so the worker removes the
                # directory and suppresses its SUCCESS manifest when it
                # finishes — an rmtree here would race its copytree and
                # could leave a resurrected half-snapshot behind. Under
                # the progress lock the worker either sees the flag in
                # its finally-block or has already set done — in the
                # latter (the wait timed out JUST as it finished) fall
                # through to the filesystem delete ourselves.
                with self._progress_lock:
                    finished = prog["done"].is_set()
                    if not finished:
                        prog["delete_requested"] = True
                if not finished:
                    return {"acknowledged": True}
            if prog["state"] != SnapshotState.ABORTED:
                # the worker raced past the abort flag and completed:
                # fall through to the filesystem delete so the ack is
                # truthful either way
                pass
            else:
                return {"acknowledged": True}
        repo = self._repo(repo_name)
        path = repo.snapshot_path(snapshot)
        if not os.path.exists(path):
            raise ResourceNotFoundException(f"[{repo_name}:{snapshot}] snapshot does not exist")
        shutil.rmtree(path)
        return {"acknowledged": True}

    # --- restore ---

    def restore_snapshot(self, repo_name: str, snapshot: str,
                         body: Optional[dict] = None) -> dict:
        repo = self._repo(repo_name)
        body = body or {}
        manifest = repo.read_manifest(snapshot)
        indices_expr = body.get("indices")
        rename_pattern = body.get("rename_pattern")
        rename_replacement = body.get("rename_replacement")
        restored = []
        failures = []
        for name, info in manifest["indices"].items():
            if indices_expr and name not in str(indices_expr).split(","):
                continue
            target = name
            if rename_pattern and rename_replacement is not None:
                import re

                target = re.sub(rename_pattern, rename_replacement, name)
            if target in self.node.indices:
                raise ResourceAlreadyExistsException(
                    f"cannot restore index [{target}] because an open index with "
                    "same name already exists"
                )
            snap_idx_dir = os.path.join(repo.snapshot_path(snapshot), "indices", name)
            # verify the repo blobs against the manifest digests BEFORE
            # creating the index: repo-side corruption fails
            # the restore of THIS index only — no half-created index, no
            # unverified bytes installed, the other indices restore
            try:
                self._verify_index_blobs(snapshot, name, info, snap_idx_dir)
            except CorruptedSnapshotException as e:
                failures.append({
                    "index": name,
                    "type": "corrupted_snapshot_exception",
                    "reason": str(e)})
                continue
            self.node.create_index(target, {
                "settings": Settings(info["settings"]).as_nested_dict(),
                "mappings": info["mappings"],
                "aliases": info.get("aliases", {}),
            })
            svc = self.node.indices[target]
            for sid, shard in svc.shards.items():
                src = os.path.join(snap_idx_dir, str(sid))
                if os.path.exists(src):
                    shard.restore_from_snapshot(src)
            restored.append(target)
        resp = {"snapshot": {
            "snapshot": snapshot,
            "indices": restored,
            "shards": {"total": len(restored) + len(failures),
                       "failed": len(failures),
                       "successful": len(restored)},
        }}
        if failures:
            resp["snapshot"]["failures"] = failures
        return resp

    @staticmethod
    def _previous_blobs(repo: FsRepository, snapshot: str) -> dict:
        """{(index, shard): {relative path: (digest, blob path)}} over the
        repository's finished snapshots: what an incremental snapshot may
        link instead of copy."""
        out: dict = {}
        for name in repo.list_snapshots():
            if name == snapshot:
                continue
            try:
                manifest = repo.read_manifest(name)
            except (OSError, ValueError, ResourceNotFoundException):
                continue
            snap_dir = repo.snapshot_path(name)
            for iname, info in (manifest.get("indices") or {}).items():
                for sid, sinfo in (info.get("shards") or {}).items():
                    shard_dir = os.path.join(snap_dir, "indices", iname, sid)
                    entry = out.setdefault((iname, sid), {})
                    for rel, digest in ((sinfo or {}).get("digests")
                                        or {}).items():
                        entry[rel] = (digest, os.path.join(shard_dir, rel))
        return out

    @staticmethod
    def _copy_shard_store(src: str, dst: str, previous: dict,
                          counts: dict) -> Dict[str, str]:
        """Copy one shard store into the repository; returns {relative
        path: SHA-256} of what the repository now holds (markers never
        ship). A file whose digest equals the earlier snapshot's blob at
        the same path is hard-linked from it; any other is copied while
        its copy is hashed."""
        digests = {}
        for root, _dirs, fnames in os.walk(src):
            for fn in fnames:
                if (root == src and fn.startswith(MARKER_PREFIX)
                        and fn.endswith(".json")):
                    continue
                full = os.path.join(root, fn)
                rel = os.path.relpath(full, src)
                out = os.path.join(dst, rel)
                os.makedirs(os.path.dirname(out), exist_ok=True)
                prev = previous.get(rel)
                if prev is not None and os.path.exists(prev[1]):
                    if _sha256_file(full) == prev[0]:
                        try:
                            os.link(prev[1], out)
                        except OSError:
                            shutil.copyfile(prev[1], out)
                        digests[rel] = prev[0]
                        counts["reused"] += os.path.getsize(out)
                        continue
                digests[rel] = _copy_hashing(full, out)
                counts["written"] += os.path.getsize(out)
        return digests

    @staticmethod
    def _write_storeless_shard(shard, dst: str, counts: dict
                               ) -> Dict[str, str]:
        """A shard without a store: write its flushed segments and commit
        point into the repository with the store's own writer (the files
        a store would hold after the flush), then hash them."""
        engine = shard.engine
        with engine._lock:
            Store(dst).commit(engine.segments, engine.max_seqno,
                              engine.version_map)
        digests = {}
        for root, _dirs, fnames in os.walk(dst):
            for fn in fnames:
                full = os.path.join(root, fn)
                digests[os.path.relpath(full, dst)] = _sha256_file(full)
                counts["written"] += os.path.getsize(full)
        return digests

    def _verify_index_blobs(self, snapshot: str, name: str, info: dict,
                            snap_idx_dir: str) -> None:
        """Compare every repo blob of one snapshotted index against the
        per-file digests the create recorded; raise
        :class:`CorruptedSnapshotException` on the first mismatch."""
        for sid_str, sinfo in (info.get("shards") or {}).items():
            digests = (sinfo or {}).get("digests")
            if not digests:
                continue  # a manifest without digests: nothing to verify
            shard_dir = os.path.join(snap_idx_dir, sid_str)
            for rel, expected in digests.items():
                full = os.path.join(shard_dir, rel)
                try:
                    with open(full, "rb") as f:
                        actual = hashlib.sha256(f.read()).hexdigest()
                except OSError:
                    actual = "<missing>"
                if actual != expected:
                    integrity_service().record_corruption(
                        name, int(sid_str), "restore",
                        f"snapshot [{snapshot}] blob [{rel}] digest "
                        f"mismatch")
                    raise CorruptedSnapshotException(
                        f"[{snapshot}] index [{name}] shard [{sid_str}] "
                        f"blob [{rel}] failed verification "
                        f"(manifest={expected[:12]}, "
                        f"actual={actual[:12]})")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _copy_hashing(src: str, dst: str) -> str:
    """Copy ``src`` to ``dst`` and return the SHA-256 of the bytes
    written."""
    h = hashlib.sha256()
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        for chunk in iter(lambda: fi.read(1 << 22), b""):
            h.update(chunk)
            fo.write(chunk)
    shutil.copystat(src, dst)
    return h.hexdigest()
