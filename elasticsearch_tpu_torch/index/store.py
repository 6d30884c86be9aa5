"""On-disk segments and commit points, in the JAX package's layout.

Counterpart of ``elasticsearch_tpu/index/store.py``. A shard's store is one
directory:

- ``commit.json``: the committed segment names, ``max_seq_no``, the delete
  tombstones and non-default primary terms (``tombstones``,
  ``doc_terms``) and, after a synced flush, its ``sync_id``; written
  atomically (tmp + fsync + rename) after every file and directory it
  names is fsynced, and the directory fsynced after the rename, because
  the engine trims the translog on its word;
- ``<segment>/``: ``arrays.npz`` (postings, norms, seqnos, versions, and
  the ``num.<f>.*``, ``ord.<f>.*``, ``geo.<f>.*``, ``vec.<f>.*`` and
  ``exists.<f>`` columns), ``live.npy`` (the tombstone mask, rewritten atomically at
  every commit),
  ``meta.json`` (with each doc's legacy ``_parent`` value under
  ``"parents"``), ``sources.jsonl``, ``positions.json`` and
  ``checksums.json`` (SHA-256 of each file but ``live.npy``, verified on
  every load);
- ``<segment>/nested/``: ``index.json`` (sub-directory -> nested path)
  and one sub-directory a path, itself a segment directory with
  ``parent_of.npy`` and ``offset_of.npy`` beside it (covered by its
  checksums), nested-in-nested recursively;
- ``corrupted_*.json``: a corruption marker. A store that carries one
  refuses every load until a verified copy replaces it
  (``clear_corruption_markers``). ``verify_segment`` checks a committed
  segment's checksums again, nested ones too: the scrubber's disk pass.

The names, npz keys, ``meta.json`` keys and dtypes are the JAX package's,
so a store one package wrote opens in the other for the field types both
have. ``positions.json`` (``{term_id: {doc: [positions]}}``) is read into
the segment's ``positions`` as its bytes (parsed only on first access)
and written from them, so a segment the port writes or merges keeps the
phrase positions the JAX package's ``match_phrase`` reads. Geo points
are the ``geo.<f>.*`` arrays with ``"geo_fields"`` counts; range,
scaled, short, byte, token-count and murmur3 values are numeric columns,
ip, binary and join values ordinal columns, as the JAX package writes
them. Geo shapes are ``meta.json``'s ``"shapes"`` (field -> {doc as a
string: [raw GeoJSON / WKT]}), as the JAX package writes them; the
geometry and bbox table rebuild on first use. Loaded segments
are host numpy on the engine's device and stage lazily, as sealed ones
do.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid
from typing import List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.index.segment import (
    GeoColumn,
    NestedContext,
    NumericColumn,
    OrdinalColumn,
    Segment,
    SegmentPositions,
    VectorColumn,
)


class CorruptIndexException(ElasticsearchTpuException):
    status_code = 500


MARKER_PREFIX = "corrupted_"

# the files a segment directory's checksums cover, in the JAX package's
# order (a nested sub-directory's join arrays among them)
_CHECKSUMMED = ("arrays.npz", "meta.json", "sources.jsonl", "positions.json",
                "parent_of.npy", "offset_of.npy",
                os.path.join("nested", "index.json"))

# dtype of each array the reader hands a Segment: the staging and the
# kernels depend on these, so a file that holds another is corrupt
_DTYPES = {
    "term_block_start": np.int32, "term_block_count": np.int32,
    "term_doc_freq": np.int32, "block_docs": np.int32,
    "block_tfs": np.float32, "norms": np.float32, "seqnos": np.int64,
    "versions": np.int64,
}
_NUM_DTYPES = {"flat_values": np.float64, "flat_docs": np.int32,
               "first_value": np.float64, "min_value": np.float64,
               "max_value": np.float64, "exists": np.bool_}
_ORD_DTYPES = {"flat_ords": np.int32, "flat_docs": np.int32,
               "first_ord": np.int32, "exists": np.bool_}
_VEC_DTYPES = {"vectors": np.float32, "exists": np.bool_}
_GEO_DTYPES = {"lat": np.float32, "lon": np.float32, "flat_docs": np.int32,
               "first_lat": np.float32, "first_lon": np.float32,
               "exists": np.bool_}


def _fsync_json(path: str, payload) -> None:
    """Write ``payload`` as JSON to ``path`` atomically."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_path(path: str) -> None:
    """fsync a file, or a directory's entries."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_live(d: str, live: np.ndarray) -> None:
    """Replace ``<d>/live.npy`` atomically (tmp + fsync + rename)."""
    path = os.path.join(d, "live.npy")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, live)
    _fsync_path(tmp)
    os.replace(tmp, path)
    _fsync_path(d)


class Store:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    # corruption markers (Store.markStoreCorrupted)

    def corruption_markers(self) -> List[dict]:
        """Parsed ``corrupted_*.json`` markers, oldest first. An
        unreadable marker still counts (an empty dict with its file
        name): a torn marker must not unlock the copy."""
        out: List[dict] = []
        try:
            entries = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return out
        for entry in entries:
            if not (entry.startswith(MARKER_PREFIX)
                    and entry.endswith(".json")):
                continue
            p = os.path.join(self.directory, entry)
            if not os.path.isfile(p):
                continue
            try:
                with open(p, encoding="utf-8") as f:
                    marker = json.load(f)
            except (OSError, ValueError):
                marker = {}
            marker.setdefault("marker", entry)
            out.append(marker)
        return out

    def is_corrupted(self) -> bool:
        return bool(self.corruption_markers())

    def mark_corrupted(self, reason: str, site: str = "load") -> dict:
        """Write the corruption marker once (the first cause wins) and
        return it."""
        existing = self.corruption_markers()
        if existing:
            return existing[0]
        marker = {
            "marker": f"{MARKER_PREFIX}{uuid.uuid4().hex[:16]}.json",
            "reason": str(reason),
            "site": site,
            "timestamp_ms": int(time.time() * 1000),
        }
        os.makedirs(self.directory, exist_ok=True)
        _fsync_json(os.path.join(self.directory, marker["marker"]), marker)
        return marker

    def clear_corruption_markers(self) -> int:
        """Remove the markers: legal only after a verified byte set
        replaced the copy (``IndexService.unquarantine_shard``)."""
        cleared = 0
        for marker in self.corruption_markers():
            try:
                os.remove(os.path.join(self.directory, marker["marker"]))
                cleared += 1
            except OSError:
                pass
        return cleared

    def _check_not_corrupted(self) -> None:
        markers = self.corruption_markers()
        if markers:
            m = markers[0]
            raise CorruptIndexException(
                f"store [{self.directory}] is marked corrupted "
                f"[{m.get('marker')}]: {m.get('reason', 'unknown')} — "
                f"the copy must be re-recovered from a healthy copy, "
                f"never reloaded")

    # ------------------------------------------------------------------
    # commit points

    def _seg_dir(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _commit_path(self) -> str:
        return os.path.join(self.directory, "commit.json")

    def commit(self, segments: List[Segment], max_seqno: int,
               version_map: Optional[dict] = None,
               sync_id: Optional[str] = None) -> None:
        """Write each new segment, refresh every segment's live mask, then
        the commit point; drop the directories of segments no longer
        committed (after a merge). Every file the commit point names is
        on disk before it is written, and the commit point before this
        returns: the caller trims the translog next."""
        for seg in segments:
            d = self._seg_dir(seg.name)
            if not os.path.exists(d):
                self.write_segment(seg)
            else:
                _refresh_live(seg, d)
        _fsync_path(self.directory)
        commit = {"segments": [s.name for s in segments],
                  "max_seq_no": int(max_seqno)}
        if sync_id is not None:
            # the synced-flush marker: the commit covers every acked op,
            # so a restart over it replays no translog op
            commit["sync_id"] = sync_id
        if version_map is not None:
            # what segments cannot re-derive: delete tombstones (the seqno
            # staleness guard reads them after a restart) and primary
            # terms other than 1
            commit["tombstones"] = {
                doc_id: {"seq_no": int(e.seqno), "version": int(e.version),
                         "term": int(e.term)}
                for doc_id, e in version_map.items() if e.deleted}
            commit["doc_terms"] = {
                doc_id: int(e.term) for doc_id, e in version_map.items()
                if not e.deleted and e.term != 1}
        _fsync_json(self._commit_path(), commit)
        _fsync_path(self.directory)
        live_names = set(commit["segments"])
        for entry in os.listdir(self.directory):
            p = os.path.join(self.directory, entry)
            if os.path.isdir(p) and entry not in live_names:
                shutil.rmtree(p)

    def read_commit(self) -> Optional[dict]:
        try:
            with open(self._commit_path(), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except ValueError as e:
            raise CorruptIndexException(
                f"store [{self.directory}] has an unreadable commit point: "
                f"{e}") from e

    def load_segments(self, device) -> List[Segment]:
        """The committed segments, verified, as host arrays on
        ``device``."""
        self._check_not_corrupted()
        commit = self.read_commit()
        if commit is None:
            return []
        return [self.read_segment(name, device)
                for name in commit["segments"]]

    # ------------------------------------------------------------------
    # segment writer

    def write_segment(self, seg: Segment) -> None:
        _write_segment_dir(seg, self._seg_dir(seg.name))

    # ------------------------------------------------------------------
    # segment reader

    def read_segment(self, name: str, device) -> Segment:
        self._check_not_corrupted()
        return _read_segment_dir(self._seg_dir(name), device)

    def verify_segment(self, name: str) -> int:
        """Verify a sealed segment's checksums again, its nested
        sub-segments too (the scrubber's disk pass); returns the bytes
        verified, raises ``CorruptIndexException`` at the first
        mismatch."""
        return _verify_segment_dir(self._seg_dir(name))


def _refresh_live(seg: Segment, d: str) -> None:
    """Rewrite a committed segment's live masks, its nested
    sub-segments' too."""
    _write_live(d, seg.live)
    for i, (_path, nctx) in enumerate(sorted(seg.nested.items())):
        _refresh_live(nctx.segment, os.path.join(d, "nested", str(i)))


def _write_segment_dir(seg: Segment, d: str, join=None) -> None:
    """One segment directory; ``join``: a nested sub-segment's
    (parent_of, offset_of), written beside its arrays and checksummed
    with them."""
    os.makedirs(d, exist_ok=True)
    arrays = {
        "term_block_start": seg.term_block_start,
        "term_block_count": seg.term_block_count,
        "term_doc_freq": seg.term_doc_freq,
        "block_docs": seg.block_docs,
        "block_tfs": seg.block_tfs,
        "norms": seg.norms,
        "seqnos": seg.seqnos,
        "versions": seg.versions,
    }
    for f, col in seg.numeric_columns.items():
        for key in _NUM_DTYPES:
            arrays[f"num.{f}.{key}"] = getattr(col, key)
    for f, col in seg.ordinal_columns.items():
        for key in _ORD_DTYPES:
            arrays[f"ord.{f}.{key}"] = getattr(col, key)
    for f, col in seg.geo_columns.items():
        for key in _GEO_DTYPES:
            arrays[f"geo.{f}.{key}"] = getattr(col, key)
    for f, col in seg.vector_columns.items():
        # the bf16-grid f32 host mirror as it is: reloading it stages
        # the same bf16 embeddings
        arrays[f"vec.{f}.vectors"] = col.vectors
        arrays[f"vec.{f}.exists"] = col.exists
    for f, mask in seg.exists_masks.items():
        arrays[f"exists.{f}"] = mask
    np.savez(os.path.join(d, "arrays.npz"), **arrays)
    n = int(seg.num_docs)
    meta = {
        "name": seg.name,
        "num_docs": n,
        "term_keys": list(seg.term_keys),
        "field_stats": {f: {k: int(v) for k, v in st.items()}
                        for f, st in seg.field_stats.items()},
        "field_norm_idx": {f: int(i)
                           for f, i in seg.field_norm_idx.items()},
        "numeric_fields": {f: int(c.count)
                           for f, c in seg.numeric_columns.items()},
        "ordinal_fields": {
            f: {"terms": list(c.terms), "count": int(c.count)}
            for f, c in seg.ordinal_columns.items()},
        "geo_fields": {f: int(c.count)
                       for f, c in seg.geo_columns.items()},
        "vector_fields": {
            f: {"dims": int(c.dims), "count": int(c.count)}
            for f, c in seg.vector_columns.items()},
        "doc_ids": list(seg.doc_ids),
        "routings": list(seg.routings),
        "parents": list(seg.parents),
        "shapes": {f: {str(doc): vals for doc, vals in per_doc.items()}
                   for f, per_doc in seg.shapes.items()},
    }
    # json.dumps, not json.dump: one pass of the C encoder (dump runs the
    # pure-Python one, chunk by chunk); the bytes are the same
    with open(os.path.join(d, "meta.json"), "w", encoding="utf-8") as f:
        f.write(json.dumps(meta))
    with open(os.path.join(d, "sources.jsonl"), "w",
              encoding="utf-8") as f:
        f.write("".join(json.dumps(seg.sources[i], separators=(",", ":"))
                        + "\n" for i in range(n)))
    # positions sidecar (phrase queries): term_id -> {doc: [pos...]}
    with open(os.path.join(d, "positions.json"), "wb") as f:
        positions = seg.positions
        f.write(
            positions.json_bytes()
            if isinstance(positions, SegmentPositions) else
            json.dumps({str(tid): {str(doc): np.asarray(pos).tolist()
                                   for doc, pos in per_doc.items()}
                        for tid, per_doc in positions.items()}
                       ).encode("utf-8"))
    if join is not None:
        np.save(os.path.join(d, "parent_of.npy"), join[0])
        np.save(os.path.join(d, "offset_of.npy"), join[1])
    if seg.nested:
        # one sub-directory a path, recursively
        nd = os.path.join(d, "nested")
        os.makedirs(nd, exist_ok=True)
        index = {}
        for i, (path, nctx) in enumerate(sorted(seg.nested.items())):
            _write_segment_dir(nctx.segment, os.path.join(nd, str(i)),
                               join=(nctx.parent_of, nctx.offset_of))
            index[str(i)] = path
        with open(os.path.join(nd, "index.json"), "w",
                  encoding="utf-8") as f:
            json.dump(index, f)
        _fsync_path(nd)
    sums = {}
    for fn in _CHECKSUMMED:
        p = os.path.join(d, fn)
        if os.path.exists(p):
            sums[fn] = _sha256(p)
    with open(os.path.join(d, "checksums.json"), "w",
              encoding="utf-8") as f:
        json.dump(sums, f)
    for fn in os.listdir(d):
        if fn != "nested":
            _fsync_path(os.path.join(d, fn))
    _write_live(d, seg.live)


def _read_segment_dir(d: str, device) -> Segment:
    """One segment directory, verified, with its nested sub-segments."""
    name = os.path.basename(d)
    _verify_checksums_dir(d)
    with open(os.path.join(d, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    # one parse of every line at once (the C decoder over one array)
    with open(os.path.join(d, "sources.jsonl"), "rb") as f:
        lines = [ln for ln in f.read().split(b"\n") if ln.strip()]
    sources = json.loads(b"[" + b",".join(lines) + b"]")

    def arr(key, dtype):
        a = data[key]
        if a.dtype != dtype:
            raise CorruptIndexException(
                f"segment [{name}] array [{key}] has dtype [{a.dtype}], "
                f"expected [{np.dtype(dtype)}]")
        return a

    numeric_columns = {
        f: NumericColumn(**{k: arr(f"num.{f}.{k}", t)
                            for k, t in _NUM_DTYPES.items()},
                         count=int(count))
        for f, count in meta["numeric_fields"].items()}
    ordinal_columns = {
        f: OrdinalColumn(info["terms"],
                         **{k: arr(f"ord.{f}.{k}", t)
                            for k, t in _ORD_DTYPES.items()},
                         count=int(info["count"]))
        for f, info in meta["ordinal_fields"].items()}
    vector_columns = {
        f: VectorColumn(**{k: arr(f"vec.{f}.{k}", t)
                           for k, t in _VEC_DTYPES.items()},
                        dims=int(info["dims"]), count=int(info["count"]))
        for f, info in (meta.get("vector_fields") or {}).items()}
    geo_columns = {
        f: GeoColumn(**{k: arr(f"geo.{f}.{k}", t)
                        for k, t in _GEO_DTYPES.items()},
                     count=int(count))
        for f, count in (meta.get("geo_fields") or {}).items()}
    exists_masks = {k[len("exists."):]: arr(k, np.bool_)
                    for k in data.files if k.startswith("exists.")}
    # kept as read: parsed only when something reads the positions
    with open(os.path.join(d, "positions.json"), "rb") as f:
        positions = SegmentPositions.from_json_bytes(f.read())
    seg = Segment(
        name=meta["name"],
        num_docs=meta["num_docs"],
        doc_ids=meta["doc_ids"],
        sources=sources,
        routings=meta["routings"],
        term_keys=meta["term_keys"],
        field_stats=meta["field_stats"],
        field_norm_idx=meta["field_norm_idx"],
        **{k: arr(k, t) for k, t in _DTYPES.items()},
        numeric_columns=numeric_columns,
        ordinal_columns=ordinal_columns,
        vector_columns=vector_columns,
        geo_columns=geo_columns,
        exists_masks=exists_masks,
        positions=positions,
        parents=meta.get("parents"),
        shapes={f: {int(doc): vals for doc, vals in per_doc.items()}
                for f, per_doc in (meta.get("shapes") or {}).items()},
        device=device,
    )
    live_path = os.path.join(d, "live.npy")
    if os.path.exists(live_path):
        try:
            live = np.load(live_path)
        except (ValueError, EOFError, OSError) as e:
            # live.npy carries no checksum: a torn one fails here
            raise CorruptIndexException(
                f"segment [{name}] live mask unreadable: {e}") from e
        if live.dtype != np.bool_ or live.shape != seg.live.shape:
            raise CorruptIndexException(
                f"segment [{name}] live mask has dtype [{live.dtype}] "
                f"and shape {live.shape}, expected bool "
                f"{seg.live.shape}")
        seg.live = live
    nested_index = os.path.join(d, "nested", "index.json")
    if os.path.exists(nested_index):
        with open(nested_index, encoding="utf-8") as f:
            index = json.load(f)
        for i, path in index.items():
            sub = os.path.join(d, "nested", i)
            nseg = _read_segment_dir(sub, device)
            nseg.name = f"{seg.name}#{path}"
            seg.nested[path] = NestedContext(
                nseg, _load_join(sub, "parent_of.npy", nseg),
                _load_join(sub, "offset_of.npy", nseg))
    return seg


def _load_join(d: str, fn: str, nseg: Segment) -> np.ndarray:
    arr = np.load(os.path.join(d, fn))
    if arr.dtype != np.int32 or arr.shape != (nseg.num_docs,):
        raise CorruptIndexException(
            f"nested segment [{nseg.name}] {fn} has dtype [{arr.dtype}] and "
            f"shape {arr.shape}, expected int32 ({nseg.num_docs},)")
    return arr


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify_segment_dir(d: str) -> int:
    _verify_checksums_dir(d)
    total = 0
    with open(os.path.join(d, "checksums.json"), encoding="utf-8") as f:
        for fn in json.load(f):
            total += os.path.getsize(os.path.join(d, fn))
    nested = os.path.join(d, "nested")
    if os.path.isdir(nested):
        for entry in sorted(os.listdir(nested)):
            sub = os.path.join(nested, entry)
            if os.path.isdir(sub):
                total += _verify_segment_dir(sub)
    return total


def _verify_checksums_dir(d: str) -> None:
    name = os.path.basename(d)
    try:
        with open(os.path.join(d, "checksums.json"), encoding="utf-8") as f:
            sums = json.load(f)
    except FileNotFoundError:
        raise CorruptIndexException(
            f"segment [{name}] missing checksums") from None
    except ValueError:
        # a torn manifest is corruption, like a mismatch
        raise CorruptIndexException(
            f"segment [{name}] torn checksums") from None
    for fn, expected in sums.items():
        try:
            actual = _sha256(os.path.join(d, fn))
        except FileNotFoundError:
            raise CorruptIndexException(
                f"segment file [{name}/{fn}] listed in checksums but "
                f"missing on disk") from None
        if actual != expected:
            raise CorruptIndexException(
                f"checksum failed for [{name}/{fn}] "
                f"(stored={expected[:12]}, actual={actual[:12]})")
