"""Store: the port's segment writer and reader against the JAX package's.

The same seeded documents (text, keyword, long, date, boolean and a
cosine ``dense_vector``) are parsed and sealed by each package's own
mapper and ``SegmentBuilder``. A segment directory each package writes
must read back in the other with every array equal, dtype included
(doc values ``float64``, vectors the bf16-grid ``float32`` mirror), and
the same ``meta.json`` keys; so must a segment of the field types the
port added (geo points, ip, the range family, token_count, short, byte,
half and scaled floats, binary, murmur3 and text fielddata), and a data
path holding geo and range data serves the same answers in either
package. Commit points round-trip; a checksum mismatch, a missing or torn
file and a corruption marker refuse the load with
``CorruptIndexException``; data the port cannot hold (shapes) refuses it
naming the kind. Nested sub-segments (``nested/``, with ``parent_of`` and
``offset_of``) and legacy ``_parent`` values round-trip both ways.
"""

import json
import os

import numpy as np
import pytest

from elasticsearch_tpu.analysis.analyzers import AnalysisRegistry as JAnalysis
from elasticsearch_tpu.index import store as jstore
from elasticsearch_tpu.index.segment import SegmentBuilder as JBuilder
from elasticsearch_tpu.mapper.mapping import MapperService as JMapper
from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.index import store as tstore
from elasticsearch_tpu_torch.index.engine import VersionEntry
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.mapper.mapping import MapperService

MAPPING = {"properties": {
    "title": {"type": "text"},
    "venue": {"type": "keyword"},
    "year": {"type": "long"},
    "ts": {"type": "date"},
    "open": {"type": "boolean"},
    "emb": {"type": "dense_vector", "dims": 5, "similarity": "cosine"},
}}


def seeded_docs(n=60, seed=17):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        src = {"title": " ".join(f"w{int(x)}" for x in
                                 rng.zipf(1.5, rng.randint(2, 12)) % 40),
               "venue": f"v{int(rng.randint(7))}",
               "year": int(1990 + rng.randint(30)),
               "ts": f"2023-{1 + int(rng.randint(12)):02d}-"
                     f"{1 + int(rng.randint(28)):02d}",
               "open": bool(rng.rand() < 0.5)}
        if i % 5:
            src["emb"] = [float(x) for x in rng.randn(5)]
        if i % 11 == 0:
            del src["year"]  # a missing doc value
        docs.append((f"doc-{i}", src))
    return docs


NEW_TYPES_MAPPING = {"properties": {
    "title": {"type": "text", "fielddata": True,
              "fields": {"length": {"type": "token_count"}}},
    "loc": {"type": "geo_point"},
    "ip": {"type": "ip"},
    "span": {"type": "integer_range"},
    "window": {"type": "date_range"},
    "net": {"type": "ip_range"},
    "temp": {"type": "double_range"},
    "s": {"type": "short"},
    "b": {"type": "byte"},
    "h": {"type": "half_float"},
    "price": {"type": "scaled_float", "scaling_factor": 100},
    "blob": {"type": "binary", "doc_values": True},
    "tag": {"type": "keyword", "fields": {"hash": {"type": "murmur3"}}},
}}


def new_types_docs(n=50, seed=23):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        src = {"title": " ".join(f"w{int(x)}" for x in
                                 rng.randint(0, 20, rng.randint(1, 8))),
               "s": int(rng.randint(-300, 300)), "b": int(rng.randint(-9, 9)),
               "h": float(rng.rand()), "price": float(rng.rand() * 50),
               "tag": f"k{i % 6}", "blob": "aGVsbG8="}
        k = i % 4
        if k:
            pts = [{"lat": float(rng.uniform(-80, 80)),
                    "lon": float(rng.uniform(-170, 170))} for _ in range(k)]
            src["loc"] = pts if k > 1 else f"{pts[0]['lat']},{pts[0]['lon']}"
        if i % 5:
            src["ip"] = (f"10.0.{i % 3}.{i}" if i % 2 else f"2001:db8::{i:x}")
            lo = int(rng.randint(0, 50))
            src["span"] = [{"gte": lo, "lt": lo + 9}, {"gt": lo + 20}]
            src["window"] = {"gte": f"2023-0{1 + i % 9}-01", "lte": "2023-12-31"}
            src["net"] = "192.168.0.0/16"
            src["temp"] = {"gt": -1.5, "lte": float(rng.rand())}
        docs.append((f"n{i}", src))
    return docs


def jax_segment(name="i_0_seg_1", docs=None, mapping=MAPPING):
    mapper = JMapper(JAnalysis(None), mapping)
    b = JBuilder(name)
    for s, (doc_id, src) in enumerate(docs or seeded_docs()):
        b.add_document(mapper.parse_document(doc_id, src, None), s, 1)
    seg = b.seal()
    seg.live[3] = False
    return seg


def torch_segment(name="i_0_seg_1", docs=None, mapping=MAPPING):
    mapper = MapperService(AnalysisRegistry(None), mapping)
    b = SegmentBuilder(name, device="cpu")
    for s, (doc_id, src) in enumerate(docs or seeded_docs()):
        b.add_document(mapper.parse_document(doc_id, src, None), s, 1)
    seg = b.seal()
    seg.live[3] = False
    return seg


def seg_arrays(seg):
    """Every array a store keeps, by its npz key, plus the live mask."""
    out = {k: getattr(seg, k) for k in (
        "term_block_start", "term_block_count", "term_doc_freq", "block_docs",
        "block_tfs", "norms", "seqnos", "versions", "live")}
    for f, c in seg.numeric_columns.items():
        for k in ("flat_values", "flat_docs", "first_value", "min_value",
                  "max_value", "exists"):
            out[f"num.{f}.{k}"] = getattr(c, k)
    for f, c in seg.ordinal_columns.items():
        for k in ("flat_ords", "flat_docs", "first_ord", "exists"):
            out[f"ord.{f}.{k}"] = getattr(c, k)
    for f, c in seg.vector_columns.items():
        out[f"vec.{f}.vectors"] = c.vectors
        out[f"vec.{f}.exists"] = c.exists
    for f, c in seg.geo_columns.items():
        for k in ("lat", "lon", "flat_docs", "first_lat", "first_lon",
                  "exists"):
            out[f"geo.{f}.{k}"] = getattr(c, k)
    for f, m in seg.exists_masks.items():
        out[f"exists.{f}"] = m
    return out


def seg_meta(seg):
    return {
        "num_docs": seg.num_docs, "term_keys": list(seg.term_keys),
        "field_stats": seg.field_stats, "field_norm_idx": seg.field_norm_idx,
        "doc_ids": list(seg.doc_ids), "routings": list(seg.routings),
        "sources": [seg.sources[i] for i in range(seg.num_docs)],
        "ordinal_terms": {f: (list(c.terms), c.count)
                          for f, c in seg.ordinal_columns.items()},
        "numeric_counts": {f: c.count
                           for f, c in seg.numeric_columns.items()},
        "vector_info": {f: (c.dims, c.count)
                        for f, c in seg.vector_columns.items()},
        "geo_counts": {f: c.count for f, c in seg.geo_columns.items()},
    }


def assert_same_segment(a, b):
    aa, ba = seg_arrays(a), seg_arrays(b)
    assert sorted(aa) == sorted(ba)
    for k in aa:
        assert aa[k].dtype == ba[k].dtype, k
        assert aa[k].shape == ba[k].shape, k
        np.testing.assert_array_equal(aa[k], ba[k], err_msg=k)
    assert seg_meta(a) == seg_meta(b)


def test_both_packages_seal_the_same_segment():
    """The premise of a shared layout: the same docs give the same arrays
    in both packages."""
    assert_same_segment(jax_segment(), torch_segment())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_segment_written_by_one_reads_in_the_other(tmp_path, writer):
    if writer == "jax":
        seg = jax_segment()
        jstore.Store(str(tmp_path)).write_segment(seg)
        jstore.Store(str(tmp_path))._refresh_live(
            seg, str(tmp_path / seg.name))
        back = tstore.Store(str(tmp_path)).read_segment(seg.name, "cpu")
        assert back.device.type == "cpu"
    else:
        seg = torch_segment()
        tstore.Store(str(tmp_path)).write_segment(seg)
        back = jstore.Store(str(tmp_path)).read_segment(seg.name)
    assert_same_segment(seg, back)
    assert back.num_docs == seg.num_docs and back.live_doc_count == 59
    for f in ("year", "ts"):
        assert back.numeric_columns[f].flat_values.dtype == np.float64
    assert back.vector_columns["emb"].vectors.dtype == np.float32


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_new_field_types_round_trip_both_ways(tmp_path, writer):
    """Geo points, ip, ranges, token counts, the scalar types, binary,
    murmur3 and text fielddata seal to the same arrays in both packages,
    and a segment one package writes reads back whole in the other."""
    docs = new_types_docs()
    seg_j = jax_segment(docs=docs, mapping=NEW_TYPES_MAPPING)
    seg_t = torch_segment(docs=docs, mapping=NEW_TYPES_MAPPING)
    assert_same_segment(seg_j, seg_t)
    assert set(seg_t.geo_columns) == {"loc"}
    assert {"span#lo", "span#hi", "title.length", "tag.hash"} \
        <= set(seg_t.numeric_columns)
    assert {"ip", "blob", "title"} <= set(seg_t.ordinal_columns)
    if writer == "jax":
        jstore.Store(str(tmp_path)).write_segment(seg_j)
        jstore.Store(str(tmp_path))._refresh_live(
            seg_j, str(tmp_path / seg_j.name))
        back = tstore.Store(str(tmp_path)).read_segment(seg_j.name, "cpu")
    else:
        tstore.Store(str(tmp_path)).write_segment(seg_t)
        back = jstore.Store(str(tmp_path)).read_segment(seg_t.name)
    assert_same_segment(seg_j, back)
    assert back.geo_columns["loc"].lat.dtype == np.float32


def test_new_field_types_write_the_jax_layout(tmp_path):
    docs = new_types_docs()
    check_jax_layout(tmp_path,
                     jax_segment(docs=docs, mapping=NEW_TYPES_MAPPING),
                     torch_segment(docs=docs, mapping=NEW_TYPES_MAPPING))


def test_segment_files_and_meta_keys_match_jax(tmp_path):
    check_jax_layout(tmp_path, jax_segment(), torch_segment())


def check_jax_layout(tmp_path, seg_j, seg_t):
    jstore.Store(str(tmp_path / "j")).write_segment(seg_j)
    tstore.Store(str(tmp_path / "t")).write_segment(seg_t)
    jd, td = tmp_path / "j" / seg_j.name, tmp_path / "t" / seg_t.name
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    jm = json.loads((jd / "meta.json").read_text())
    tm = json.loads((td / "meta.json").read_text())
    assert list(jm) == list(tm)
    for key in jm:
        assert jm[key] == tm[key], key
    assert (jd / "sources.jsonl").read_bytes() == \
        (td / "sources.jsonl").read_bytes()
    assert json.loads((jd / "checksums.json").read_text()).keys() == \
        json.loads((td / "checksums.json").read_text()).keys()
    jz, tz = np.load(jd / "arrays.npz"), np.load(td / "arrays.npz")
    # the same keys (the exists masks' order follows each package's seal)
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].dtype == tz[k].dtype, k
        np.testing.assert_array_equal(jz[k], tz[k], err_msg=k)
    # the phrase positions sidecar: the same term ids, docs and positions
    assert json.loads((td / "positions.json").read_text()) == \
        json.loads((jd / "positions.json").read_text()) != {}


def test_commit_round_trip_and_gc(tmp_path):
    st = tstore.Store(str(tmp_path))
    a, b = torch_segment("i_0_seg_1"), torch_segment("i_0_seg_2")
    vmap = {"gone": VersionEntry(3, 70, None, -1, deleted=True),
            "doc-1": VersionEntry(1, 1, "i_0_seg_1", 1, term=2)}
    st.commit([a, b], 71, vmap, sync_id="abc")
    c = st.read_commit()
    assert c == {"segments": ["i_0_seg_1", "i_0_seg_2"], "max_seq_no": 71,
                 "sync_id": "abc",
                 "tombstones": {"gone": {"seq_no": 70, "version": 3,
                                         "term": 1}},
                 "doc_terms": {"doc-1": 2}}
    loaded = st.load_segments("cpu")
    assert [s.name for s in loaded] == ["i_0_seg_1", "i_0_seg_2"]
    assert_same_segment(a, loaded[0])
    # a later commit refreshes the live masks and drops merged-away dirs
    b.live[5] = False
    st.commit([b], 72)
    assert not os.path.exists(tmp_path / "i_0_seg_1")
    again = st.load_segments("cpu")
    assert [s.name for s in again] == ["i_0_seg_2"]
    assert not again[0].live[5] and again[0].live_doc_count == 58
    # a JAX store reads the same commit
    assert jstore.Store(str(tmp_path)).read_commit() == st.read_commit()


def _written(tmp_path):
    st = tstore.Store(str(tmp_path))
    seg = torch_segment()
    st.commit([seg], seg.num_docs - 1)
    return st, tmp_path / seg.name


@pytest.mark.parametrize("damage,match", [
    ("flip", "checksum failed"),
    ("missing", "missing on disk"),
    ("no_manifest", "missing checksums"),
    ("torn_manifest", "torn checksums"),
])
def test_damaged_segment_raises_corrupt_index(tmp_path, damage, match):
    st, d = _written(tmp_path)
    if damage == "flip":
        raw = bytearray((d / "arrays.npz").read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        (d / "arrays.npz").write_bytes(bytes(raw))
    elif damage == "missing":
        os.remove(d / "sources.jsonl")
    elif damage == "no_manifest":
        os.remove(d / "checksums.json")
    else:
        (d / "checksums.json").write_text('{"arrays.npz": "ab')
    with pytest.raises(tstore.CorruptIndexException, match=match):
        st.load_segments("cpu")
    # the JAX package refuses the same bytes
    with pytest.raises(jstore.CorruptIndexException):
        jstore.Store(str(tmp_path)).load_segments()


@pytest.mark.parametrize("damage", ["truncated", "garbage", "empty"])
def test_torn_live_mask_raises_corrupt_index(tmp_path, damage):
    # live.npy carries no checksum: a torn one is corruption all the same
    st, d = _written(tmp_path)
    raw = (d / "live.npy").read_bytes()
    (d / "live.npy").write_bytes({"truncated": raw[: len(raw) - 7],
                                  "garbage": b"\x93NUMPY" + raw[12:40],
                                  "empty": b""}[damage])
    with pytest.raises(tstore.CorruptIndexException,
                       match="live mask unreadable"):
        st.load_segments("cpu")


def test_torn_commit_point_raises_corrupt_index(tmp_path):
    st, _ = _written(tmp_path)
    (tmp_path / "commit.json").write_text('{"segments": ["i_0_')
    with pytest.raises(tstore.CorruptIndexException,
                       match="unreadable commit point"):
        st.read_commit()


def test_commit_is_on_disk_before_its_commit_point(tmp_path, monkeypatch):
    # every file a commit point names, and the directories holding them,
    # are fsynced before commit.json is written, and the store directory
    # after its rename: the engine trims the translog on that word
    events = []
    real_fsync, real_json = tstore._fsync_path, tstore._fsync_json
    monkeypatch.setattr(tstore, "_fsync_path", lambda p: (
        events.append(("fsync", os.path.relpath(p, tmp_path))),
        real_fsync(p))[1])
    monkeypatch.setattr(tstore, "_fsync_json", lambda p, x: (
        events.append(("commit", os.path.relpath(p, tmp_path))),
        real_json(p, x))[1])
    st = tstore.Store(str(tmp_path))
    a, b = torch_segment("i_0_seg_1"), torch_segment("i_0_seg_2")
    st.commit([a, b], 71)
    at = events.index(("commit", "commit.json"))
    synced = {p for kind, p in events[:at] if kind == "fsync"}
    for seg in ("i_0_seg_1", "i_0_seg_2"):
        for fn in os.listdir(tmp_path / seg):
            # live.npy is fsynced under its tmp name, then renamed
            fn += ".tmp" if fn == "live.npy" else ""
            assert os.path.join(seg, fn) in synced, fn
        assert seg in synced
    assert "." in synced and events[at + 1:] == [("fsync", ".")]
    # a later commit replaces each live mask atomically, then commits
    events.clear()
    b.live[3] = False
    st.commit([a, b], 72)
    at = events.index(("commit", "commit.json"))
    assert {"i_0_seg_1", "i_0_seg_2", "."} <= {p for _k, p in events[:at]}
    assert not any(fn.endswith(".tmp") for seg in ("i_0_seg_1", "i_0_seg_2")
                   for fn in os.listdir(tmp_path / seg))
    assert not st.load_segments("cpu")[1].live[3]


def test_marker_refuses_load_in_both_packages(tmp_path):
    st, _ = _written(tmp_path)
    assert not st.is_corrupted()
    m = st.mark_corrupted("checksum failed for [x]", site="load")
    assert st.mark_corrupted("a second cause") == m  # the first cause wins
    assert st.is_corrupted() and len(st.corruption_markers()) == 1
    with pytest.raises(tstore.CorruptIndexException, match="marked corrupted"):
        st.load_segments("cpu")
    assert jstore.Store(str(tmp_path)).is_corrupted()
    with pytest.raises(jstore.CorruptIndexException, match="marked corrupted"):
        jstore.Store(str(tmp_path)).load_segments()
    # a marker the JAX package wrote refuses the port's load too
    other = tmp_path / "other"
    jst = jstore.Store(str(other))
    jst.mark_corrupted("scrubber found a bad block")
    with pytest.raises(tstore.CorruptIndexException, match="bad block"):
        tstore.Store(str(other)).load_segments("cpu")


def test_wrong_dtype_raises(tmp_path):
    st, d = _written(tmp_path)
    data = dict(np.load(d / "arrays.npz"))
    data["num.year.flat_values"] = data["num.year.flat_values"].astype(
        np.float32)
    np.savez(d / "arrays.npz", **data)
    sums = json.loads((d / "checksums.json").read_text())
    sums["arrays.npz"] = tstore._sha256(str(d / "arrays.npz"))
    (d / "checksums.json").write_text(json.dumps(sums))
    with pytest.raises(tstore.CorruptIndexException,
                       match=r"num\.year\.flat_values.*float32"):
        st.load_segments("cpu")


@pytest.mark.parametrize("kind", ["geo_point", "geo_shape", "nested",
                                  "_parent"])
def test_unported_columns_refuse_the_load(tmp_path, kind):
    """A JAX segment with a column the port has no type for would fail
    the load naming the kind; it never opens without that column. Every
    kind is ported now: geo points, geo shapes, nested objects and
    ``_parent`` values load with their column, shapes, sub-segment or
    parents."""
    mapping = {"properties": {"title": {"type": "text"},
                              "loc": {"type": "geo_point"},
                              "area": {"type": "geo_shape"},
                              "kids": {"type": "nested", "properties": {
                                  "k": {"type": "keyword"}}}}}
    mapper = JMapper(JAnalysis(None), mapping)
    b = JBuilder("i_0_seg_1")
    src = {"title": "hello"}
    if kind == "geo_point":
        src["loc"] = {"lat": 1.5, "lon": 2.5}
    elif kind == "geo_shape":
        src["area"] = {"type": "point", "coordinates": [1.0, 2.0]}
    elif kind == "nested":
        src["kids"] = [{"k": "a"}, {"k": "b"}]
    parsed = mapper.parse_document("1", src, None)
    b.add_document(parsed, 0, 1,
                   parent="p1" if kind == "_parent" else None)
    seg = b.seal()
    jstore.Store(str(tmp_path)).commit([seg], 0)
    if kind == "geo_point":
        back, = tstore.Store(str(tmp_path)).load_segments("cpu")
        col, jcol = back.geo_columns["loc"], seg.geo_columns["loc"]
        for k in ("lat", "lon", "flat_docs", "first_lat", "first_lon",
                  "exists"):
            np.testing.assert_array_equal(getattr(col, k), getattr(jcol, k))
        return
    if kind == "geo_shape":
        back, = tstore.Store(str(tmp_path)).load_segments("cpu")
        assert back.shapes == seg.shapes
        np.testing.assert_array_equal(back.exists_masks["area"],
                                      seg.exists_masks["area"])
        return
    if kind in ("nested", "_parent"):
        back, = tstore.Store(str(tmp_path)).load_segments("cpu")
        assert back.parents == seg.parents
        assert sorted(back.nested) == sorted(seg.nested)
        for path, nctx in seg.nested.items():
            got = back.nested[path]
            assert_same_segment(nctx.segment, got.segment)
            np.testing.assert_array_equal(got.parent_of, nctx.parent_of)
            np.testing.assert_array_equal(got.offset_of, nctx.offset_of)
        return
    with pytest.raises(tstore.CorruptIndexException, match=kind):
        tstore.Store(str(tmp_path)).load_segments("cpu")


def test_port_merge_keeps_the_phrase_positions_jax_reads(tmp_path):
    """A data path shared by both packages: the JAX node writes two
    segments, the port adds a third, force-merges and closes, and the
    reopened JAX node's ``match_phrase`` finds all three docs."""
    from elasticsearch_tpu.common.memory import memory_accountant as jacct
    from elasticsearch_tpu.common.settings import Settings as JSettings
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu_torch.node import Node

    jbytes = jacct().staged_bytes()
    path = str(tmp_path / "data")
    phrase = {"query": {"match_phrase": {"body": "brown fox"}}}
    body = {"settings": {"number_of_shards": 1},
            "mappings": {"_doc": {"properties": {"body": {"type": "text"}}}}}

    def jax_node():
        return JNode(JSettings({"search.compile.warm_on_start": False}),
                     data_path=path)

    jn = jax_node()
    try:
        jn.create_index("tpos", body)
        for i in (1, 2):
            jn.index_doc("tpos", f"j{i}", {"body": "the quick brown fox"},
                         refresh=True)
        assert jn.search("tpos", dict(phrase))["hits"]["total"] == 2
    finally:
        jn.close()
    tn = Node(data_path=path, device="cpu")
    try:
        tn.index_doc("tpos", "t1", {"body": "a quick brown fox jumps"},
                     refresh=True)
        tn.force_merge("tpos")
        seg, = tn.indices["tpos"].shards[0].engine.segments
        assert seg.num_docs == 3
        tid = seg.term_id("body", "fox")
        assert sorted(seg.positions[tid]) == list(range(3))
    finally:
        tn.close()
    jn = jax_node()
    try:
        got = jn.search("tpos", dict(phrase))
        assert got["hits"]["total"] == 3
        assert sorted(h["_id"] for h in got["hits"]["hits"]) == \
            ["j1", "j2", "t1"]
        assert jn.search("tpos", {"query": {"match_phrase": {
            "body": "fox brown"}}})["hits"]["total"] == 0
    finally:
        jn.close()
    assert jacct().staged_bytes() <= jbytes  # no JAX staging outlives it


def test_loaded_positions_parse_on_first_access(tmp_path):
    """A load keeps ``positions.json`` as its bytes: no JSON parse until
    something reads the positions, and a write of the loaded segment
    copies the bytes as they were read."""
    seg = jax_segment()
    jstore.Store(str(tmp_path / "a")).write_segment(seg)
    back = tstore.Store(str(tmp_path / "a")).read_segment(seg.name, "cpu")
    assert back.positions._raw is None and not back.positions._terms
    tstore.Store(str(tmp_path / "b")).write_segment(back)
    assert back.positions._raw is None
    raw = (tmp_path / "a" / seg.name / "positions.json").read_bytes()
    assert (tmp_path / "b" / seg.name / "positions.json").read_bytes() == raw
    assert len(seg.positions) > 0
    for tid, per_doc in seg.positions.items():
        assert sorted(back.positions[tid]) == sorted(per_doc)
        for doc, pos in per_doc.items():
            np.testing.assert_array_equal(back.positions[tid][doc], pos)
            assert back.positions[tid][doc].dtype == np.int32


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_geo_data_path_serves_the_same_answers_in_both(tmp_path, writer):
    """A node of one package indexes geo, ip and range docs and closes; a
    node of the other opens its data path and answers the geo queries,
    the geo sort, the range relations and the geo aggregations as the
    writer did (ip term and range aside: ROADMAP C12)."""
    from elasticsearch_tpu.common.settings import Settings as JSettings
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu_torch.node import Node

    path = str(tmp_path / "data")

    def make(kind):
        if kind == "jax":
            return JNode(JSettings({"search.compile.warm_on_start": False}),
                         data_path=path)
        return Node(data_path=path, device="cpu")

    bodies = [
        {"query": {"geo_distance": {"distance": "2000km",
                                    "loc": {"lat": 10, "lon": 10}}},
         "size": 60},
        {"query": {"geo_bounding_box": {"loc": {
            "top_left": {"lat": 60, "lon": -100},
            "bottom_right": {"lat": -20, "lon": 40}}}}, "size": 60},
        {"query": {"range": {"span": {"gte": 10, "lte": 30,
                                      "relation": "within"}}}, "size": 60},
        {"query": {"term": {"window": "2023-06-15"}}, "size": 60},
        {"query": {"match_all": {}}, "size": 60, "sort": [
            {"_geo_distance": {"loc": [0, 0], "order": "asc"}}]},
        {"size": 0, "aggs": {
            "b": {"geo_bounds": {"field": "loc"}},
            "c": {"geo_centroid": {"field": "loc"}},
            "g": {"geohash_grid": {"field": "loc", "precision": 2}},
            "t": {"terms": {"field": "title"}},
            "i": {"terms": {"field": "ip"}}}},
    ]
    first = make(writer)
    try:
        first.create_index("geo", {
            "settings": {"number_of_shards": 1},
            "mappings": {"_doc": NEW_TYPES_MAPPING}})
        for i, (doc_id, src) in enumerate(new_types_docs()):
            first.index_doc("geo", doc_id, src, refresh=(i % 20 == 19))
        first.indices["geo"].refresh()
        want = [first.search("geo", dict(b)) for b in bodies]
        first.indices["geo"].flush()
    finally:
        first.close()
    second = make("torch" if writer == "jax" else "jax")
    try:
        for b, w in zip(bodies, want):
            got = second.search("geo", dict(b))
            assert got["hits"]["total"] == w["hits"]["total"]
            assert [(h["_id"], h.get("sort")) for h in got["hits"]["hits"]] \
                == [(h["_id"], h.get("sort")) for h in w["hits"]["hits"]]
            assert got.get("aggregations") == w.get("aggregations")
        assert want[0]["hits"]["total"] > 0 and want[2]["hits"]["total"] > 0
    finally:
        second.close()


NESTED_MAPPING = {"properties": {
    "title": {"type": "text"},
    "j": {"type": "join", "relations": {"q": "a"}},
    "c": {"type": "nested", "include_in_root": True, "properties": {
        "t": {"type": "text"}, "n": {"type": "long"},
        "d": {"type": "nested", "properties": {"k": {"type": "keyword"}}}}},
}}


def nested_docs(n=30, seed=41):
    """(doc id, source, legacy parent) triples: nested objects two levels
    deep (some null or absent), join parents and children."""
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        src = {"title": f"w{i % 4} w{i % 7}"}
        objs = []
        for _ in range(int(rng.randint(0, 4))):
            obj = {"t": f"x{int(rng.randint(5))}", "n": int(rng.randint(90))}
            if rng.rand() < 0.5:
                obj["d"] = [{"k": f"k{int(rng.randint(3))}"}
                            for _ in range(int(rng.randint(1, 3)))]
            objs.append(obj)
        if objs:
            src["c"] = objs + ([None] if i % 6 == 0 else [])
        src["j"] = ("q" if i % 3 == 0
                    else {"name": "a", "parent": f"n{i - i % 3}"})
        docs.append((f"n{i}", src, f"p{i % 5}" if i % 2 else None))
    return docs


def nested_pair():
    jm = JMapper(JAnalysis(None), NESTED_MAPPING)
    tm = MapperService(AnalysisRegistry(None), NESTED_MAPPING)
    jb, tb = JBuilder("i_0_seg_1"), SegmentBuilder("i_0_seg_1", device="cpu")
    for s, (doc_id, src, parent) in enumerate(nested_docs()):
        jb.add_document(jm.parse_document(doc_id, src, None), s, 1,
                        parent=parent)
        tb.add_document(tm.parse_document(doc_id, src, None), s, 1,
                        parent=parent)
    seg_j, seg_t = jb.seal(), tb.seal()
    for seg in (seg_j, seg_t):
        seg.delete_docs(np.asarray([3, 7], np.int64))
    return seg_j, seg_t


def assert_same_nested(a, b):
    """Root arrays, parents, and every nested path's sub-segment (with its
    live mask) and join arrays, recursively."""
    assert_same_segment(a, b)
    assert list(a.parents) == list(b.parents)
    assert sorted(a.nested) == sorted(b.nested)
    for path, nctx in a.nested.items():
        other = b.nested[path]
        np.testing.assert_array_equal(other.parent_of, nctx.parent_of)
        np.testing.assert_array_equal(other.offset_of, nctx.offset_of)
        assert other.parent_of.dtype == nctx.parent_of.dtype == np.int32
        assert_same_nested(nctx.segment, other.segment)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_nested_and_parents_round_trip_both_ways(tmp_path, writer):
    """Nested objects (nested-in-nested, include_in_root, a null element),
    the join columns and legacy ``_parent`` values seal to the same arrays
    in both packages; deletes reach every level; a segment one package
    writes (``nested/index.json``, ``parent_of.npy`` and ``offset_of.npy``
    under the sub-directory's checksums) reads back whole in the other."""
    seg_j, seg_t = nested_pair()
    assert_same_nested(seg_j, seg_t)
    assert sorted(seg_t.nested) == ["c", "c.d"]
    assert {"j", "j#parent"} <= set(seg_t.ordinal_columns)
    if writer == "jax":
        jstore.Store(str(tmp_path)).commit([seg_j], 40)
        back, = tstore.Store(str(tmp_path)).load_segments("cpu")
    else:
        tstore.Store(str(tmp_path)).commit([seg_t], 40, {})
        back, = jstore.Store(str(tmp_path)).load_segments()
    assert_same_nested(seg_j, back)
    d = tmp_path / "i_0_seg_1" / "nested"
    index = json.loads((d / "index.json").read_text())
    assert index == {"0": "c", "1": "c.d"}
    sums = json.loads((d / "0" / "checksums.json").read_text())
    assert {"parent_of.npy", "offset_of.npy",
            os.path.join("nested", "index.json")} <= set(sums)


def test_nested_live_masks_refresh_at_commit(tmp_path):
    """A delete after the first commit reaches the committed nested
    sub-segments' live masks at the next commit (each level's
    ``live.npy``), as the JAX store refreshes them."""
    _seg_j, seg = nested_pair()
    st = tstore.Store(str(tmp_path))
    st.commit([seg], 40, {})
    seg.delete_docs(np.asarray([0, 1, 2], np.int64))
    st.commit([seg], 41, {})
    back, = jstore.Store(str(tmp_path)).load_segments()
    for path in ("c", "c.d"):
        np.testing.assert_array_equal(back.nested[path].segment.live,
                                      seg.nested[path].segment.live)
    killed = np.isin(seg.nested["c"].parent_of, [0, 1, 2])
    assert not seg.nested["c"].segment.live[np.flatnonzero(killed)].any()
