"""Parity of the PyTorch port's ingest path with the JAX package.

The same seeded documents go through both packages' analyzers, mappers
and ``SegmentBuilder.seal``; the sealed arrays must be equal, array for
array. ``Segment.from_arrays`` must round-trip a sealed JAX segment, and
the staged kernel tables and vector arrays must equal what the JAX segment
computes.
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
    "emb": {"type": "dense_vector", "dims": 12, "similarity": "cosine"},
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
        if i % 3:
            d["emb"] = [float(x) for x in rng.randn(12)]
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
    assert sorted(t.vector_columns) == sorted(j.vector_columns) == ["emb"]
    for f, tc in t.vector_columns.items():
        jc = j.vector_columns[f]
        assert (tc.dims, tc.count) == (jc.dims, jc.count)
        assert tc.vectors.dtype == jc.vectors.dtype == np.float32
        np.testing.assert_array_equal(tc.vectors.view(np.uint32),
                                      jc.vectors.view(np.uint32))
        np.testing.assert_array_equal(tc.exists, jc.exists)


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
        vector_columns=_columns(j.vector_columns, (
            "vectors", "exists", "dims", "count")),
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


def _same_positions(per_doc, want):
    assert sorted(per_doc) == sorted(want)
    for doc, pos in want.items():
        np.testing.assert_array_equal(per_doc[doc], pos)
        assert per_doc[doc].dtype == np.int32


def test_phrase_query_decodes_only_its_terms():
    """A phrase query on a sealed (flat-built) segment slices its terms'
    runs out of the flat position columns: no other term is decoded, and
    each decoded term equals the JAX segment's nested positions."""
    from elasticsearch_tpu_torch.search.query_dsl import (
        MatchPhraseQueryBuilder,
        ShardQueryContext,
    )

    t, j, tm, _ = _seal_both(seeded_docs(3, 200))
    ctx = ShardQueryContext(tm)
    pos = t.positions
    assert not pos._runs and not pos._terms
    MatchPhraseQueryBuilder("body", "search engine").to_plan(ctx, t)
    tids = {t.term_id("body", "search"), t.term_id("body", "engine")}
    assert set(pos._runs) == tids and not pos._terms
    for tid in sorted(tids):
        _same_positions(pos[tid], j.positions[tid])
    assert set(pos._terms) == tids and set(pos._runs) == tids
    # iteration and len read the term column, and still build nothing else
    assert sorted(pos) == sorted(j.positions) and len(pos) == len(j.positions)
    assert set(pos._terms) == tids
    assert (t.term_id("body", "kernel") in pos) == \
        (t.term_id("body", "kernel") in j.positions)


@pytest.mark.parametrize("form", ["positions", "flat", "mapping"])
def test_from_arrays_takes_positions_as_they_are(form):
    """``from_arrays(positions=...)`` keeps a ``SegmentPositions`` and the
    three flat int32 columns as they are (no nested build), and a
    mapping ``{term: {doc: positions}}`` keeps working."""
    from elasticsearch_tpu_torch.index.segment import SegmentPositions

    t, j, _, _ = _seal_both(seeded_docs(4, 120))
    cols = t.positions._flat
    given = {"positions": t.positions, "flat": cols,
             "mapping": j.positions}[form]
    seg = Segment.from_arrays(
        j.name, term_keys=j.term_keys, term_block_start=j.term_block_start,
        term_block_count=j.term_block_count, term_doc_freq=j.term_doc_freq,
        block_docs=j.block_docs, block_tfs=j.block_tfs, norms=j.norms,
        live=j.live, field_stats=j.field_stats,
        field_norm_idx=j.field_norm_idx, doc_ids=j.doc_ids,
        sources=j.sources, positions=given, device="cpu")
    assert isinstance(seg.positions, SegmentPositions)
    if form == "positions":
        assert seg.positions is t.positions
    elif form == "flat":
        assert all(a is b for a, b in zip(seg.positions._flat, cols))
    assert not seg.positions._terms
    for tid in j.positions:
        _same_positions(seg.positions[tid], j.positions[tid])
    assert seg.positions.json_dict() == t.positions.json_dict()


def test_term_ttf_equals_jax():
    t, j, _, _ = _seal_both(seeded_docs(6, 90))
    for tid in range(0, len(t.term_keys), 7):
        assert t.term_ttf(tid) == j.term_ttf(tid)


@pytest.mark.parametrize("metric", ["cosine", "dot_product"])
def test_staged_vectors_bit_equal_to_the_jax_segment(metric):
    """A JAX segment carried across by ``from_arrays`` stages the same
    bf16 embeddings, inverse norms and exists mask as the JAX segment."""
    _, j, _, _ = _seal_both(seeded_docs(7, 150))
    j.delete_docs(np.asarray([2, 40]))
    t = from_jax(j)
    jkeys = j.ensure_vector_staged("emb", metric)
    tkeys = t.ensure_vector_staged("emb", metric)
    assert tkeys == jkeys
    emb_key, norm_key, exists_key, d_pad = tkeys
    jdev, tdev = j.device_arrays(), t.device_arrays()
    assert tdev[emb_key].dtype == torch.bfloat16
    assert tuple(tdev[emb_key].shape) == tuple(jdev[emb_key].shape)
    np.testing.assert_array_equal(
        tdev[emb_key].view(torch.int16).numpy(),
        np.asarray(jdev[emb_key]).view(np.int16))
    np.testing.assert_array_equal(tdev[exists_key].numpy(),
                                  np.asarray(jdev[exists_key]))
    if metric == "cosine":
        np.testing.assert_array_equal(tdev[norm_key].numpy(),
                                      np.asarray(jdev[norm_key]))
    else:
        assert norm_key not in tdev
    assert t.ensure_vector_staged("nosuchfield", metric) is None


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
    """An unknown type raises; percolator and geo_shape map since the
    field-type remainder's slice."""
    MapperService(AnalysisRegistry(),
                  {"properties": {"a": {"type": "percolator"}}})
    MapperService(AnalysisRegistry(),
                  {"properties": {"g": {"type": "geo_shape"}}})
    with pytest.raises(MapperParsingException):
        MapperService(AnalysisRegistry(),
                      {"properties": {"a": {"type": "percolator_x"}}})


def test_routing_hash_matches_jax():
    from elasticsearch_tpu.utils import murmur3 as jm
    from elasticsearch_tpu_torch.utils import murmur3 as tm

    rng = np.random.RandomState(8)
    for i in range(300):
        s = seeded_text(rng, rng.randint(1, 4)) + str(i)
        assert tm.murmur3_32(s.encode()) == jm.murmur3_32(s.encode())
        for shards in (1, 5, 7):
            assert tm.shard_id_for(s, shards) == jm.shard_id_for(s, shards)
