"""Parity of the port's packed postings codec with the JAX package.

The same seeded numpy inputs go through ``elasticsearch_tpu``'s codec
helpers and ``score_tiles(codec="packed")`` (interpret mode, as
tests/test_pruned_scoring.py runs it) and through
``elasticsearch_tpu_torch``'s helpers and plain versions on the CPU.
Tolerances: the host helpers (quantize, dequantize, pack, block max,
codec resolution) equal bit for bit; scores within rtol 1e-5 (the JAX
kernel's two-pass bf16 split, about 2^-17 relative); match counts, hit
counts and top-k ids exact (the corpus has few distinct scores, so ties
are exact and distinct scores far apart). Inside the port the packed
outputs equal the raw outputs over the dequantized frac bit for bit: the
decode is exact f32 arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.ops import pallas_scoring as jps
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.ops import tile_scoring as tts
from test_torch_search import assert_same_hits
from test_torch_segment import _seal_both, from_jax, seeded_docs
from test_torch_tile_scoring_batched import SPEC, corpus, lane_sets_for

LANE = 128


def _fracs(seed):
    """Fracs over (0, k1 + 1): zeros (padding), sub-step values that clamp
    to code 1, values at the top of the range, and the rest uniform."""
    rng = np.random.RandomState(seed)
    frac = rng.rand(96, LANE).astype(np.float32) * np.float32(
        tts.PACK_MAX_FRAC * 0.999)
    frac[rng.rand(96, LANE) < 0.3] = 0.0
    frac[0, :8] = np.float32(tts.PACK_FRAC_SCALE) * np.float32(0.2)
    frac[1, :8] = np.float32(tts.PACK_MAX_FRAC) - np.float32(1e-6)
    frac[-1, -4:] = 1.0
    return frac


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_helpers_equal_bit_for_bit(seed):
    frac = _fracs(seed)
    rng = np.random.RandomState(seed + 10)
    nd_pad = tts.PACKED_DOC_CAP  # the 1M-doc corpus: exactly the cap
    docs = np.sort(rng.choice(nd_pad, frac.size, replace=False)).astype(
        np.int32).reshape(frac.shape)
    # docs at the top of the doc space set the sign bit of their word
    docs[-1, -4:] = [nd_pad - 4, nd_pad - 3, nd_pad - 2, nd_pad - 1]
    docs[frac == 0.0] = nd_pad  # padding postings carry the sentinel
    q_t, q_j = tts.quantize_frac(frac), jps.quantize_frac(frac)
    assert q_t.dtype == q_j.dtype == np.int32
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(q_t > 0, frac > 0)
    dq_t, dq_j = tts.dequantize_frac(q_t), jps.dequantize_frac(q_j)
    np.testing.assert_array_equal(dq_t.view(np.uint32), dq_j.view(np.uint32))
    w_t = tts.pack_segment_blocks(docs, frac, nd_pad)
    w_j = jps.pack_segment_blocks(docs, frac, nd_pad)
    assert w_t.dtype == w_j.dtype == np.int32
    assert w_t.shape == (frac.shape[0] + tts.CB_MAX, LANE)
    np.testing.assert_array_equal(w_t, w_j)
    last = frac.shape[0] - 1
    assert (w_t[last, -4:] < 0).all()  # the sign bit is set there
    np.testing.assert_array_equal(
        tts.pack_segment_blocks(docs, frac, nd_pad, q=q_t), w_t)
    for f in (frac, dq_t):
        np.testing.assert_array_equal(tts.block_frac_max(f),
                                      jps.block_frac_max(f))
    # the plain decode shifts logically: every doc comes back
    rows = torch.arange(frac.shape[0])
    d, f = tts._decode(torch.from_numpy(w_t), None, rows)
    real = q_t > 0
    np.testing.assert_array_equal(d.numpy()[real], docs[real])
    np.testing.assert_array_equal(f.numpy().view(np.uint32),
                                  dq_t.view(np.uint32))
    # an arithmetic shift would have smeared the sign bit
    assert (torch.from_numpy(w_t[last, -4:]) >> 12 < 0).all()


def test_pack_rejects_oversized_doc_space():
    docs = np.zeros((1, LANE), np.int32)
    frac = np.ones((1, LANE), np.float32)
    for pkg in (tts, jps):
        with pytest.raises(ValueError):
            pkg.pack_segment_blocks(docs, frac, pkg.PACKED_DOC_CAP * 2)
        pkg.pack_segment_blocks(docs, frac, pkg.PACKED_DOC_CAP)


CODEC_CASES = [
    (None, 1 << 20, "packed"), (None, 1 << 21, "packed"),
    ("raw", 1 << 10, "packed"), (None, 1 << 10, None),
    ("packed", 1 << 10, None), ("default", 1 << 10, "packed"),
    ("default", 1 << 12, "raw"), ("bitpacked", 1 << 10, "packed"),
    ("packed", (1 << 20) + 1, None), (None, 1 << 10, "bogus"),
]


@pytest.mark.parametrize("pref,nd_pad,node_default", CODEC_CASES)
def test_codec_resolution_equal(monkeypatch, pref, nd_pad, node_default):
    """The JAX package reads the node default from ES_TPU_PALLAS_CODEC; the
    port takes it as an argument. Same answers for the same preferences."""
    if node_default is None:
        monkeypatch.delenv("ES_TPU_PALLAS_CODEC", raising=False)
    else:
        monkeypatch.setenv("ES_TPU_PALLAS_CODEC", node_default)
    assert (tts.resolve_postings_codec(pref, nd_pad, node_default)
            == jps.resolve_postings_codec(pref, nd_pad))


@pytest.fixture(scope="module")
def packed_data():
    bd, frac, live, starts, counts, nd_pad = corpus(11)
    return (bd, frac, live, nd_pad, lane_sets_for(starts, counts, SPEC),
            tts.pack_segment_blocks(bd, frac, nd_pad))


def _tables(bd, frac, live, nd_pad, tile_sub, lane_sets):
    geom = tts.tile_geometry(nd_pad, tile_sub=tile_sub)
    bmin, bmax = tts.block_min_max(bd, frac, nd_pad)
    rl, rh, w, cb = tts.build_tile_tables_batched(lane_sets, bmin, bmax,
                                                  geom)
    return geom, rl, rh, w, cb, tts.build_live_t(live, geom)


def _run_packed(words, geom, rl, rh, w, cb, lt, **kw):
    common = dict(t_pad=w.shape[1], cb=cb, sub=geom.tile_sub,
                  q_batch=w.shape[0], codec="packed", **kw)
    jo = jps.score_tiles(jnp.asarray(words), None, jnp.asarray(lt),
                         jnp.asarray(rl), jnp.asarray(rh), jnp.asarray(w),
                         interpret=True, **common)
    to = tts.score_tiles(*[torch.from_numpy(x) for x in (words,)], None,
                         *[torch.from_numpy(x) for x in (lt, rl, rh, w)],
                         **common)
    return [np.asarray(o) for o in jo], [o.numpy() for o in to]


@pytest.mark.parametrize("tile_sub,with_counts,members", [
    (8, False, 1), (2, True, 1), (4, False, 5), (2, True, 5)])
def test_packed_dense_matches_jax(packed_data, tile_sub, with_counts,
                                  members):
    bd, frac, live, nd_pad, lane_sets, words = packed_data
    sets = lane_sets[2:3] if members == 1 else lane_sets
    t = _tables(bd, frac, live, nd_pad, tile_sub, sets)
    jo, to = _run_packed(words, *t, dense=True, with_counts=with_counts)
    assert len(jo) == len(to) == 1 + int(with_counts)
    assert to[0].shape == jo[0].shape
    np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(to[0] > 0, jo[0] > 0)
    if with_counts:
        np.testing.assert_array_equal(to[1], jo[1])


@pytest.mark.parametrize("tile_sub,k,members", [(4, 10, 1), (8, 4, 5),
                                                (1, 16, 5)])
def test_packed_topk_matches_jax(packed_data, tile_sub, k, members):
    bd, frac, live, nd_pad, lane_sets, words = packed_data
    sets = lane_sets[:1] if members == 1 else lane_sets
    t = _tables(bd, frac, live, nd_pad, tile_sub, sets)
    (js, jd, jh), (ts_, td, th) = _run_packed(words, *t, dense=False, k=k)
    assert ts_.shape == js.shape
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(ts_, js, rtol=1e-5, atol=1e-7)
    assert np.isfinite(ts_).any() and (td[~np.isfinite(ts_)] == -1).all()


@pytest.mark.parametrize("dense,with_counts", [(True, False), (True, True),
                                               (False, False)])
def test_packed_equals_raw_over_dequantized_frac(packed_data, dense,
                                                 with_counts):
    """The decode is exact: the packed outputs equal the raw outputs over
    dequantize(quantize(frac)) bit for bit, counts included (frac > 0
    survives the round trip)."""
    bd, frac, live, nd_pad, lane_sets, words = packed_data
    geom, rl, rh, w, cb, lt = _tables(bd, frac, live, nd_pad, 2, lane_sets)
    dq = tts.dequantize_frac(tts.quantize_frac(frac))
    dp, fp = tts.pad_segment_blocks(bd, dq, nd_pad)
    kw = dict(t_pad=w.shape[1], cb=cb, sub=geom.tile_sub, q_batch=w.shape[0],
              dense=dense, with_counts=with_counts, k=12)
    tl = [torch.from_numpy(x) for x in (lt, rl, rh, w)]
    packed = tts.score_tiles(torch.from_numpy(words), None, *tl,
                             codec="packed", **kw)
    raw = tts.score_tiles(torch.from_numpy(dp), torch.from_numpy(fp), *tl,
                          **kw)
    for a, b in zip(packed, raw):
        assert torch.equal(a, b)
    if with_counts:
        _dp, fp_raw = tts.pad_segment_blocks(bd, frac, nd_pad)
        raw_frac = tts.score_tiles(torch.from_numpy(dp),
                                   torch.from_numpy(fp_raw), *tl, **kw)
        assert torch.equal(packed[1], raw_frac[1])


def test_packed_at_the_doc_cap_matches_the_oracle():
    """nd_pad = 2^20, postings at the top of the doc space (their words
    have the sign bit set): the plain packed version equals the numpy
    oracle over the dequantized frac, dense and top-k."""
    rng = np.random.RandomState(5)
    nd_pad = tts.PACKED_DOC_CAP
    bd, bt, lanes = [], [], []
    for t in range(3):
        docs = np.sort(np.concatenate([
            rng.choice(1 << 19, 150, replace=False),
            (1 << 19) + rng.choice(1 << 19, 150, replace=False)])).astype(
                np.int32)
        docs[-1] = nd_pad - 1
        start = len(bd)
        for i in range(0, len(docs), LANE):
            d = np.full(LANE, nd_pad, np.int32)
            f = np.zeros(LANE, np.float32)
            chunk = docs[i: i + LANE]
            d[: len(chunk)] = chunk
            f[: len(chunk)] = rng.randint(1, 4, len(chunk))
            bd.append(d)
            bt.append(f)
        lanes.append(tts.QueryLane(start, len(bd) - start, 0.7 + 0.4 * t))
    bd, bt = np.stack(bd), np.stack(bt)
    dl = np.full(nd_pad + 1, 20.0, np.float32)
    frac = tts.compute_block_frac(bd, bt, dl, avgdl=20.0)
    words = tts.pack_segment_blocks(bd, frac, nd_pad)
    live = np.ones(nd_pad, np.float32)
    geom = tts.tile_geometry(nd_pad, 128)
    bmin, bmax = tts.block_min_max(bd, bt, nd_pad)
    rl, rh, w, cb = tts.build_tile_tables(lanes, bmin, bmax, geom)
    args = [torch.from_numpy(words), None] + [
        torch.from_numpy(x) for x in (tts.build_live_t(live, geom), rl, rh, w)]
    kw = dict(t_pad=w.shape[1], cb=cb, sub=geom.tile_sub, codec="packed")
    (dense,) = tts.score_tiles(*args, **kw, dense=True)
    ref = tts.reference_scores(
        bd, tts.dequantize_frac(tts.quantize_frac(frac)), lanes, nd_pad)
    flat = tts.dense_to_flat(dense, geom.tile_sub).numpy()
    np.testing.assert_allclose(flat, ref, rtol=1e-6, atol=0)
    assert flat[nd_pad - 1] > 0 and (flat[1 << 19:] > 0).sum() >= 150
    top_s, top_d, hits = tts.merge_tile_topk(
        *tts.score_tiles(*args, **kw, k=10), 10)
    assert int(hits) == int((ref > 0).sum())
    order = np.lexsort((np.arange(nd_pad), -ref))[:10]
    np.testing.assert_array_equal(top_d.numpy(), order)


def test_segment_from_jax_staged_packed_scores_like_jax(monkeypatch):
    """A segment sealed by the JAX package, carried across through
    Segment.from_arrays and staged packed, holds the JAX staging's words
    and block-max column bit for bit and scores as the JAX kernel does."""
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    _, j, _, _ = _seal_both(seeded_docs(7, 300))
    j.postings_codec = "packed"
    jdev = j.device_arrays()
    assert j.kernel_codec == "packed"
    t = from_jax(j)
    t.postings_codec = "packed"
    dev = t.device_arrays()
    assert t.kernel_codec == "packed" and "k_docs" not in dev
    np.testing.assert_array_equal(dev["k_packed"].numpy(),
                                  np.asarray(jdev["k_packed"]))
    assert t.kernel_postings_bytes == j.kernel_postings_bytes
    np.testing.assert_array_equal(
        t.kernel_bfmax, jps.block_frac_max(jps.dequantize_frac(
            jps.quantize_frac(j._block_frac()))))
    lanes = [tts.QueryLane(int(t.term_block_start[i]),
                           int(t.term_block_count[i]), 1.0 + 0.25 * n)
             for n, i in enumerate((0, 5, 11))]
    geom = tts.tile_geometry(t.nd_pad, 4)
    rl, rh, w, cb = tts.build_tile_tables(lanes, t.kernel_bmin, t.kernel_bmax,
                                          geom)
    lt = tts.build_live_t(t.live.astype(np.float32), geom)
    kw = dict(t_pad=w.shape[1], cb=cb, sub=geom.tile_sub, codec="packed",
              dense=True, with_counts=True)
    jo = jps.score_tiles(jdev["k_packed"], None, jnp.asarray(lt),
                         jnp.asarray(rl), jnp.asarray(rh), jnp.asarray(w),
                         interpret=True, **kw)
    to = tts.score_tiles(dev["k_packed"], None, torch.from_numpy(lt),
                         torch.from_numpy(rl), torch.from_numpy(rh),
                         torch.from_numpy(w), **kw)
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))


MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
    "tag": {"type": "keyword"},
}}


def _docs(n_docs, seed=0):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(20)]
    tags = ["red", "green", "blue"]
    return [(str(d), {"body": " ".join(
        vocab[rng.randint(len(vocab))] for _ in range(rng.randint(3, 9))),
        "n": d, "tag": tags[d % 3]}) for d in range(n_docs)]


@pytest.fixture(scope="module")
def host_pair():
    """A packed index on the host rung (index.search.mesh: false, 2
    shards) in both packages."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    common = {"index.number_of_shards": 2, "index.refresh_interval": -1,
              "index.search.mesh": False,
              "index.search.pallas.postings_codec": "packed"}
    jidx = JIndex("codec-host", JSettings({
        **common, "index.requests.cache.enable": False}), mapping=MAPPING)
    tidx = IndexService("codec-host", Settings(common), mapping=MAPPING,
                        device="cpu")
    for doc_id, src in _docs(400, seed=2):
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    yield jidx, tidx
    jidx.close()
    tidx.close()
    mp.undo()


HOST_BODIES = {
    "match": {"query": {"match": {"body": "t0 t4 t9"}}, "size": 10},
    "msm": {"query": {"match": {"body": {"query": "t1 t2 t3",
                                         "minimum_should_match": 2}}},
            "size": 10},
    "and": {"query": {"match": {"body": {"query": "t5 t6",
                                         "operator": "and"}}}, "size": 10},
    "agg": {"query": {"match": {"body": "t7 t8"}}, "size": 3,
            "aggs": {"tags": {"terms": {"field": "tag"}}}},
}


@pytest.mark.parametrize("name", sorted(HOST_BODIES))
def test_packed_host_rung_equals_jax(host_pair, name):
    jidx, tidx = host_pair
    body = HOST_BODIES[name]
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert tr["_plane"] == jr["_plane"] == "host"
    assert "_pruned" not in tr
    assert_same_hits(jr, tr)
    assert jr.get("aggregations") == tr.get("aggregations")
    for shard in tidx.shards.values():
        for seg in shard.engine.searchable_segments():
            assert seg.kernel_codec == "packed"
            assert "k_packed" in seg.device_arrays()
            assert seg.kernel_postings_bytes == seg.postings_bytes_staged()


def test_packed_host_batched_rung_equals_jax(host_pair):
    """The host rung's batched launch (kernel 1b) reads the packed words:
    each member equals JAX's, and its own serial response bit for bit."""
    jidx, tidx = host_pair
    bodies = [{"query": {"match": {"body": f"t{i} t{(3 * i + 1) % 20}"}},
               "size": 5} for i in range(4)]
    jout = jidx.search_batch([dict(b) for b in bodies])
    tout = tidx.search_batch([dict(b) for b in bodies])
    for body, jr, tr in zip(bodies, jout, tout):
        assert isinstance(tr, dict) and tr["_plane"] == "host"
        assert_same_hits(jr, tr)
        serial = tidx.search(dict(body))
        assert ([(h["_id"], h["_score"]) for h in tr["hits"]["hits"]]
                == [(h["_id"], h["_score"]) for h in serial["hits"]["hits"]])


def test_packed_staging_halves_the_posting_bytes(host_pair):
    _, tidx = host_pair
    # the packed index's segment layout: no scheduled refresh during the
    # ingest
    raw = IndexService("codec-raw", Settings({
        "index.number_of_shards": 2, "index.search.mesh": False,
        "index.refresh_interval": -1}), mapping=MAPPING, device="cpu")
    for doc_id, src in _docs(400, seed=2):
        raw.index_doc(doc_id, src)
    raw.refresh()
    body = HOST_BODIES["match"]
    raw.search(dict(body))
    tidx.search(dict(body))
    b_raw = raw.search_stats()["planes"]["postings_bytes_staged"]
    raw.close()
    b_packed = tidx.search_stats()["planes"]["postings_bytes_staged"]
    assert 0 < b_packed and 2 * b_packed == b_raw


def test_node_settings_reach_the_index():
    """search.pallas.* comes from the node (create_index prefixes body
    settings with ``index.``); the index setting overrides the codec."""
    from elasticsearch_tpu_torch.node import Node

    node = Node(Settings({"search.pallas.postings_codec": "packed",
                          "search.pallas.pruning.enabled": True,
                          "search.pallas.pruning.probe_tiles": 4}),
                device="cpu")
    try:
        _node_settings_reach_the_index(node)
    finally:
        node.close()


def _node_settings_reach_the_index(node):
    from elasticsearch_tpu_torch.node import Node

    node.create_index("a", {"settings": {"number_of_shards": 1}})
    node.create_index("b", {"settings": {
        "number_of_shards": 1, "search.pallas.postings_codec": "raw"}})
    a, b = node.indices["a"], node.indices["b"]
    assert (a.postings_codec, a.postings_codec_default) == ("default",
                                                            "packed")
    assert b.postings_codec == "raw"
    for idx in ("a", "b"):
        node.index_doc(idx, "1", {"body": "hello world"}, refresh=True)
        node.search(idx, {"query": {"match": {"body": "hello"}}})
    seg_a = a.shards[0].engine.searchable_segments()[0]
    seg_b = b.shards[0].engine.searchable_segments()[0]
    assert (seg_a.kernel_codec, seg_b.kernel_codec) == ("packed", "raw")
    ms = a._mesh_plane()
    assert ms._pruning_config() == (True, 4)
    from elasticsearch_tpu_torch.common.errors import (
        IllegalArgumentException,
    )

    bad = Node(Settings({"search.pallas.pruning.probe_tiles": 3}),
               device="cpu")
    try:
        with pytest.raises(IllegalArgumentException):
            bad.create_index("c", {})
    finally:
        bad.close()
    with pytest.raises(IllegalArgumentException):
        node.create_index("d", {"settings": {
            "search.pallas.postings_codec": "bitpacked"}})
