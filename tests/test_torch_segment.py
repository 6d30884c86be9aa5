"""Parity of the PyTorch port's ingest path with the JAX package.

The same seeded documents go through both packages' analyzers, mappers
and ``SegmentBuilder.seal``; the sealed arrays must be equal, array for
array. ``Segment.from_arrays`` must round-trip a sealed JAX segment, and
the staged kernel tables must equal what the JAX segment computes.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis.analyzers import AnalysisRegistry as JAnalysis
from elasticsearch_tpu.index.segment import SegmentBuilder as JBuilder
from elasticsearch_tpu.mapper.mapping import MapperService as JMapper
from elasticsearch_tpu.ops import pallas_scoring as jps
from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import MapperParsingException
from elasticsearch_tpu_torch.index.segment import Segment, SegmentBuilder
from elasticsearch_tpu_torch.mapper.mapping import MapperService

WORDS = ["search", "Engine", "tpu", "GPU", "kernel", "naïve", "Ünïcödé",
         "données", "東京", "x86_64", "state-of-the-art", "it's", "C++",
         "3.14", "e-mail", "über", "ǅemal", "ΣΊΣΥΦΟΣ", "mañana", "foo_bar"]
PUNCT = [" ", " ", " ", ", ", ". ", "; ", " — ", "!? ", "\t", "\n", "/"]

MAPPING = {"properties": {
    "title": {"type": "text"},
    "body": {"type": "text"},
    "venue": {"type": "keyword"},
    "year": {"type": "long"},
    "n": {"type": "integer"},
    "score": {"type": "double"},
}}


def seeded_text(rng, n_words):
    out = []
    for _ in range(n_words):
        out.append(WORDS[rng.randint(len(WORDS))])
        out.append(PUNCT[rng.randint(len(PUNCT))])
    return "".join(out)


def seeded_docs(seed, n):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        d = {"title": seeded_text(rng, rng.randint(1, 8)),
             "body": seeded_text(rng, rng.randint(3, 30)),
             "venue": f"venue-{rng.randint(12)}",
             "year": int(1990 + rng.randint(30)),
             "n": int(rng.randint(-50, 50)),
             "score": float(rng.randn())}
        if i % 5 == 0:
            d["tags"] = ["Red", "green Tea"][: 1 + i % 2]  # dynamic text
        if i % 7 == 0:
            del d["venue"]
        if i % 11 == 0:
            d["venue"] = ["venue-1", "venue-2"]  # multi-valued keyword
        docs.append((f"d{i}", d))
    return docs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_standard_analyzer_tokens_equal(seed):
    rng = np.random.RandomState(seed)
    a, b = AnalysisRegistry().get("standard"), JAnalysis().get("standard")
    for _ in range(200):
        text = seeded_text(rng, rng.randint(1, 40))
        assert a.analyze_tokens(text) == b.analyze_tokens(text)
        assert a.analyze(text.encode("ascii", "ignore").decode()) == \
            b.analyze(text.encode("ascii", "ignore").decode())


def _seal_both(docs):
    tm, jm = (MapperService(AnalysisRegistry(), MAPPING),
              JMapper(JAnalysis(), MAPPING))
    tb, jb = SegmentBuilder("s", device="cpu"), JBuilder("s")
    for seqno, (doc_id, src) in enumerate(docs):
        tb.add_document(tm.parse_document(doc_id, src), seqno)
        jb.add_document(jm.parse_document(doc_id, src), seqno)
    return tb.seal(), jb.seal(), tm, jm


@pytest.mark.parametrize("seed,n", [(0, 37), (1, 300), (2, 129)])
def test_seal_equal_arrays(seed, n):
    t, j, tm, jm = _seal_both(seeded_docs(seed, n))
    assert tm.mapping_dict() == jm.mapping_dict()
    assert t.term_keys == j.term_keys
    assert t.nd_pad == j.nd_pad and t.num_docs == j.num_docs
    for name in ("term_block_start", "term_block_count", "term_doc_freq",
                 "block_docs", "block_tfs", "norms", "seqnos", "versions"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t.field_stats == j.field_stats
    assert t.field_norm_idx == j.field_norm_idx
    assert t.doc_ids == j.doc_ids and t.sources == j.sources
    assert sorted(t.ordinal_columns) == sorted(j.ordinal_columns)
    for f, tc in t.ordinal_columns.items():
        jc = j.ordinal_columns[f]
        assert tc.terms == jc.terms and tc.count == jc.count
        for name in ("flat_ords", "flat_docs", "first_ord", "exists"):
            np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    assert sorted(t.numeric_columns) == sorted(j.numeric_columns)
    for f, tc in t.numeric_columns.items():
        jc = j.numeric_columns[f]
        for name in ("flat_values", "flat_docs", "first_value", "min_value",
                     "max_value", "exists"):
            a, b = getattr(tc, name), getattr(jc, name)
            assert a.dtype == b.dtype == (np.float64 if "value" in name
                                          else a.dtype)
            np.testing.assert_array_equal(a, b)


def _columns(cols, fields):
    return {f: {k: getattr(c, k) for k in fields} for f, c in cols.items()}


def from_jax(j, device="cpu"):
    return Segment.from_arrays(
        j.name, term_keys=j.term_keys, term_block_start=j.term_block_start,
        term_block_count=j.term_block_count, term_doc_freq=j.term_doc_freq,
        block_docs=j.block_docs, block_tfs=j.block_tfs, norms=j.norms,
        live=j.live, field_stats=j.field_stats,
        field_norm_idx=j.field_norm_idx, doc_ids=j.doc_ids, sources=j.sources,
        numeric_columns=_columns(j.numeric_columns, (
            "flat_values", "flat_docs", "first_value", "min_value",
            "max_value", "exists", "count")),
        ordinal_columns=_columns(j.ordinal_columns, (
            "terms", "flat_ords", "flat_docs", "first_ord", "exists", "count")),
        seqnos=j.seqnos, versions=j.versions, device=device)


def test_from_arrays_round_trips_a_jax_segment():
    _, j, _, _ = _seal_both(seeded_docs(5, 260))
    j.delete_docs(np.asarray([3, 17, 200]))
    t = from_jax(j)
    assert t.device == torch.device("cpu")
    np.testing.assert_array_equal(t.live, j.live)
    assert t.live_doc_count == j.live_doc_count
    for name in ("block_docs", "block_tfs", "norms", "term_block_start"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    dev = t.device_arrays()
    np.testing.assert_array_equal(dev["block_docs"].numpy(), j.block_docs)
    np.testing.assert_array_equal(dev["live1"].numpy()[:-1], j.live)
    assert not bool(dev["live1"][-1])
    # the kernel tables equal the JAX segment's
    geom = jps.tile_geometry(j.nd_pad)
    dp, fp = jps.pad_segment_blocks(j.block_docs, j._block_frac(), j.nd_pad)
    np.testing.assert_array_equal(dev["k_docs"].numpy(), dp)
    np.testing.assert_array_equal(dev["k_frac"].numpy(), fp)
    np.testing.assert_array_equal(
        dev["k_live_t"].numpy(),
        jps.build_live_t(j.live.astype(np.float32), geom))
    assert tuple(t.kernel_geom) == tuple(geom)


def test_delete_docs_restages_every_live_layout():
    _, j, _, _ = _seal_both(seeded_docs(6, 300))
    t = from_jax(j)
    t.device_arrays()
    key = t.kernel_live_t_for(1)
    t.delete_docs(np.asarray([0, 5, 299]))
    j.delete_docs(np.asarray([0, 5, 299]))
    dev = t.device_arrays()
    np.testing.assert_array_equal(dev["live"].numpy(), j.live)
    for k, sub in (("k_live_t", t.kernel_geom.tile_sub), (key, 1)):
        np.testing.assert_array_equal(
            dev[k].numpy(),
            jps.build_live_t(j.live.astype(np.float32),
                             jps.tile_geometry(j.nd_pad, sub)))


def test_unported_field_type_raises():
    m = MapperService(AnalysisRegistry())
    with pytest.raises(MapperParsingException):
        m.parse_document("1", {"when": "2020-01-02"})  # dynamic date
    with pytest.raises(MapperParsingException):
        MapperService(AnalysisRegistry(), {"properties": {"g": {"type": "geo_point"}}})


def test_routing_hash_matches_jax():
    from elasticsearch_tpu.utils import murmur3 as jm
    from elasticsearch_tpu_torch.utils import murmur3 as tm

    rng = np.random.RandomState(8)
    for i in range(300):
        s = seeded_text(rng, rng.randint(1, 4)) + str(i)
        assert tm.murmur3_32(s.encode()) == jm.murmur3_32(s.encode())
        for shards in (1, 5, 7):
            assert tm.shard_id_for(s, shards) == jm.shard_id_for(s, shards)
