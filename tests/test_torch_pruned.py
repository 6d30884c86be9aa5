"""Parity of the port's block-max pruned scoring with the JAX package.

Three layers, each fed the same seeded numpy inputs in both packages (the
JAX kernel in interpret mode, ``ES_TPU_PALLAS=interpret``, set on the JAX
side only; the port's plain versions on the CPU):

- the host helpers ``tile_lane_ub`` and ``plan_pruned_tiles`` equal bit
  for bit;
- ``score_tiles`` with ``tile_ids`` (sel mode, raw and packed) and the
  ``score_tiles_pruned`` orchestration: scores within rtol 1e-5 (the JAX
  kernel's bf16 split, about 2^-17 relative), ids and hit counts exact;
  the pruned top-k equals the exhaustive top-k; padding members stay
  empty; ``tiles_scored`` equals JAX's where no bound lies within that
  tolerance of a threshold (asserted of the inputs), since the two
  packages' thresholds agree only within it;
- the service: a pruned 2-shard index on the one-device mesh plane answers
  as JAX's (``_plane``, the ``_pruned`` marker, ids, scores, the totals
  relation), runs the exhaustive fallbacks with no marker, keeps its stats,
  serves bursts, raises a ``KernelError`` and benches the plane once for
  any other fault.
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.ops import pallas_scoring as jps
from elasticsearch_tpu.parallel.mesh import shard_mesh
from elasticsearch_tpu.parallel.plan_exec import IndexMeshSearch as JMesh
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.ops import tile_scoring as tts
from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError
from test_torch_search import assert_same_hits

LANE = 128
RTOL = 1e-5


def skewed_corpus(seed, nd=3000, vocab=24):
    """Block-packed postings whose terms cluster in parts of the doc space
    with varying doc lengths, so tile bounds differ and pruning fires."""
    rng = np.random.RandomState(seed)
    nd_pad = tts.next_pow2(nd)
    bd, bt, starts, counts = [], [], [], []
    for _ in range(vocab):
        center = rng.randint(nd)
        spread = rng.randint(200, nd)
        df = rng.randint(30, 500)
        docs = np.unique(np.clip(
            (center + rng.randn(df) * spread / 3).astype(np.int64), 0,
            nd - 1)).astype(np.int32)
        tfs = rng.randint(1, 6, len(docs)).astype(np.float32)
        starts.append(len(bd))
        counts.append(-(-len(docs) // LANE))
        for i in range(0, len(docs), LANE):
            d = np.full(LANE, nd_pad, np.int32)
            f = np.zeros(LANE, np.float32)
            chunk = docs[i: i + LANE]
            d[: len(chunk)] = chunk
            f[: len(chunk)] = tfs[i: i + LANE]
            bd.append(d)
            bt.append(f)
    bd, bt = np.stack(bd), np.stack(bt)
    dl = np.clip(rng.lognormal(np.log(30), 0.5, nd_pad + 1), 4, 200).astype(
        np.float32)
    frac = tts.compute_block_frac(bd, bt, dl, avgdl=30.0)
    live = np.zeros(nd_pad, np.float32)
    live[:nd] = 1.0
    live[rng.choice(nd, nd // 12, replace=False)] = 0.0
    return bd, bt, frac, live, starts, counts, nd_pad, rng


def staged(bd, bt, frac, live, nd_pad, tile_sub, lane_sets, q_pad, codec):
    """(geometry, tables with weights padded to q_pad rows, the plan, the
    corpus arrays (numpy) and the live mask) for one codec."""
    geom = tts.tile_geometry(nd_pad, tile_sub)
    bmin, bmax = tts.block_min_max(bd, bt, nd_pad)
    rl, rh, w, cb = tts.build_tile_tables_batched(lane_sets, bmin, bmax, geom)
    wp = np.zeros((q_pad, w.shape[1]), np.float32)
    wp[: w.shape[0]] = w
    if codec == "packed":
        corpus = (tts.pack_segment_blocks(bd, frac, nd_pad), None)
        bfmax = tts.block_frac_max(tts.dequantize_frac(
            tts.quantize_frac(frac)))
    else:
        corpus = tts.pad_segment_blocks(bd, frac, nd_pad)
        bfmax = tts.block_frac_max(frac)
    return geom, rl, rh, wp, cb, corpus, bfmax, tts.build_live_t(live, geom)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("seed,q", [(0, 1), (1, 4), (2, 4)])
def test_bound_helpers_equal(seed, q):
    bd, bt, frac, live, starts, counts, nd_pad, rng = skewed_corpus(seed)
    sets = [[tts.QueryLane(starts[t], counts[t], float(rng.rand() + 0.2))
             for t in rng.choice(len(starts), 3, replace=False)]
            for _ in range(q)]
    geom, rl, rh, wp, cb, _c, bfmax, _lt = staged(
        bd, bt, frac, live, nd_pad, 2, sets, q, "raw")
    ub_t, ub_j = tts.tile_lane_ub(rl, rh, bfmax), jps.tile_lane_ub(rl, rh,
                                                                   bfmax)
    np.testing.assert_array_equal(ub_t, ub_j)
    for probe in (2, 8):
        pt = tts.plan_pruned_tiles(rl, rh, wp, bfmax, probe)
        pj = jps.plan_pruned_tiles(rl, rh, wp, bfmax, probe, ub=ub_j)
        assert sorted(pt) == sorted(pj)
        for key in pt:
            if isinstance(pt[key], np.ndarray):
                assert pt[key].dtype == pj[key].dtype, key
                np.testing.assert_array_equal(pt[key], pj[key], err_msg=key)
            else:
                assert pt[key] == pj[key]
    # too few tiles to split: both decline
    assert tts.plan_pruned_tiles(rl[:2], rh[:2], wp, bfmax, 8) is None
    assert jps.plan_pruned_tiles(rl[:2], rh[:2], wp, bfmax, 8) is None


@pytest.mark.parametrize("codec,q", [("raw", 1), ("raw", 4), ("packed", 1),
                                     ("packed", 4)])
def test_sel_mode_matches_jax(codec, q):
    """A tile subset in plan order with about half its rows zeroed (what
    the pruned gate does): port equals JAX, and the zeroed rows give
    empty candidates, what the full kernel gives for an empty tile."""
    bd, bt, frac, live, starts, counts, nd_pad, rng = skewed_corpus(3)
    sets = [[tts.QueryLane(starts[t], counts[t], float(rng.rand() + 0.2))
             for t in rng.choice(len(starts), 3, replace=False)]
            for _ in range(q)]
    geom, rl, rh, wp, cb, corpus, _bf, lt = staged(
        bd, bt, frac, live, nd_pad, 2, sets, q, codec)
    sel = rng.permutation(geom.n_tiles).astype(np.int32)
    zero = rng.rand(len(sel)) < 0.5
    rls, rhs = rl[sel].copy(), rh[sel].copy()
    rls[zero] = 0
    rhs[zero] = 0
    kw = dict(t_pad=wp.shape[1], cb=cb, sub=geom.tile_sub, k=10, q_batch=q,
              codec=codec)
    js, jd, jh = (np.asarray(o) for o in jps.score_tiles(
        *[_j(x) for x in (*corpus, lt, rls, rhs, wp)], tile_ids=_j(sel),
        interpret=True, **kw))
    ts_, td, th = (o.numpy() for o in tts.score_tiles(
        *[_t(x) for x in (*corpus, lt, rls, rhs, wp)], tile_ids=_t(sel), **kw))
    assert ts_.shape == js.shape == (len(sel), q, 10)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(ts_, js, rtol=RTOL, atol=1e-7)
    assert (ts_[zero] == -np.inf).all() and (td[zero] == -1).all()
    assert (th[zero] == 0).all() and np.isfinite(ts_[~zero]).any()
    # the kept rows equal the exhaustive launch's rows of those tiles
    full = tts.score_tiles(*[_t(x) for x in (*corpus, lt, rl, rh, wp)], **kw)
    for a, b in zip((ts_, td, th), full):
        np.testing.assert_array_equal(a[~zero], b.numpy()[sel[~zero]])


def _pruned_both(corpus, lt, plan, wp, cb, geom, q_pad, q_real, codec, k=10):
    keys = ("rl_probe", "rh_probe", "tid_probe", "rl_rest", "rh_rest",
            "tid_rest", "bounds_rest")
    kw = dict(t_pad=wp.shape[1], cb=cb, sub=geom.tile_sub, k=k,
              q_batch=q_pad, q_real=q_real, codec=codec)
    jo = jps.score_tiles_pruned(
        *[_j(x) for x in (*corpus, lt)], *[_j(plan[x]) for x in keys],
        _j(wp), interpret=True, **kw)
    to = tts.score_tiles_pruned(
        *[_t(x) for x in (*corpus, lt)], *[_t(plan[x]) for x in keys],
        _t(wp), **kw)
    return [np.asarray(o) for o in jo], [o.numpy() for o in to]


def _exhaustive(corpus, lt, rl, rh, wp, cb, geom, q_pad, codec, k=10):
    out = tts.score_tiles(*[_t(x) for x in (*corpus, lt, rl, rh, wp)],
                          t_pad=wp.shape[1], cb=cb, sub=geom.tile_sub, k=k,
                          q_batch=q_pad, codec=codec)
    return [o.numpy() for o in tts.merge_tile_topk_batched(*out, k)]


def _theta_margin(corpus, lt, plan, wp, cb, geom, q_pad, q_real, codec):
    """Smallest |bound - theta| / theta over the rest tiles and real
    members (theta from the port's probe pass)."""
    ts1 = tts.score_tiles(
        *[_t(x) for x in (*corpus, lt)], _t(plan["rl_probe"]),
        _t(plan["rh_probe"]), _t(wp), tile_ids=_t(plan["tid_probe"]),
        t_pad=wp.shape[1], cb=cb, sub=geom.tile_sub, k=10, q_batch=q_pad,
        codec=codec)[0]
    theta = tts.probe_threshold([ts1], 10, q_pad, q_real).numpy()[:q_real]
    b = plan["bounds_rest"][:, :q_real]
    return float((np.abs(b - theta) / np.maximum(theta, 1e-6)).min())


@pytest.mark.parametrize("seed,codec", [(10, "raw"), (11, "packed"),
                                        (12, "raw"), (13, "packed")])
def test_pruned_matches_jax_and_the_exhaustive_topk(seed, codec):
    bd, bt, frac, live, starts, counts, nd_pad, rng = skewed_corpus(seed)
    q_real, q_pad = 3, 4
    sets = [[tts.QueryLane(starts[t], counts[t], float(rng.rand() * 2 + 0.1))
             for t in rng.choice(len(starts), 2, replace=False)]
            for _ in range(q_real)]
    geom, rl, rh, wp, cb, corpus, bfmax, lt = staged(
        bd, bt, frac, live, nd_pad, 2, sets, q_pad, codec)
    plan = tts.plan_pruned_tiles(rl, rh, wp, bfmax, probe_tiles=2)
    (js, jd, jh, jn), (ts_, td, th, tn) = _pruned_both(
        corpus, lt, plan, wp, cb, geom, q_pad, q_real, codec)
    es, ed, eh = _exhaustive(corpus, lt, rl, rh, wp, cb, geom, q_pad, codec)
    # the pruned top-k is the exhaustive top-k, in both packages
    np.testing.assert_array_equal(ts_[:q_real], es[:q_real])
    np.testing.assert_array_equal(td[:q_real], ed[:q_real])
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(ts_, js, rtol=RTOL, atol=1e-7)
    # padding members stay empty
    assert (ts_[q_real:] == -np.inf).all() and (th[q_real:] == 0).all()
    # totals: a lower bound of the exhaustive count
    assert (th[:q_real] <= eh[:q_real]).all()
    margin = _theta_margin(corpus, lt, plan, wp, cb, geom, q_pad, q_real,
                           codec)
    assert margin > 1e-4, f"a bound lies within {margin} of a threshold"
    assert int(tn) == int(jn) and tn.dtype == np.int32
    np.testing.assert_array_equal(th, jh)
    assert 2 <= int(tn) <= geom.n_tiles


def test_pruning_fires_on_skewed_postings():
    fired = 0
    for seed in range(20, 26):
        bd, bt, frac, live, starts, counts, nd_pad, rng = skewed_corpus(seed)
        sets = [[tts.QueryLane(starts[t], counts[t], 1.0)
                 for t in rng.choice(len(starts), 2, replace=False)]]
        geom, rl, rh, wp, cb, corpus, bfmax, lt = staged(
            bd, bt, frac, live, nd_pad, 1, sets, 1, "raw")
        plan = tts.plan_pruned_tiles(rl, rh, wp, bfmax, probe_tiles=4)
        _j_out, (ts_, td, th, tn) = _pruned_both(
            corpus, lt, plan, wp, cb, geom, 1, 1, "raw")
        es, ed, _eh = _exhaustive(corpus, lt, rl, rh, wp, cb, geom, 1, "raw")
        np.testing.assert_array_equal(td, ed)
        fired += int(tn) < geom.n_tiles
    assert fired >= 3


# Two docs of one query tie exactly here, at ranks 9 and 10: the pruned
# pool (probe tiles first) and the exhaustive pool (tile order) list them
# in different orders, and JAX's pruned order is the probe-first one.
TIE_EXAMPLE = dict(seed=615583862, probe=1, codec="packed")
# Three docs of one query tie exactly at ranks 9, 10 and 11: which two the
# pruned and the exhaustive pools keep in their top-10 differs, and JAX's
# pruned pool keeps the same two as the port's.
CUT_TIE_EXAMPLE = dict(seed=57, probe=1, codec="packed")


def assert_same_ranking(got_s, got_d, want_s, want_d, deep_s, deep_d):
    """Scores equal exactly; ids equal exactly across distinct scores and
    as sets within each run of equal scores (the order of exact ties
    depends on the order in which the pools were merged). The run that
    reaches the last rank may go on past it, and which of its docs make
    the cut depends on that order too: there the ids are distinct docs
    of that score in ``deep_s``/``deep_d``, the exhaustive ranking taken
    deeper."""
    np.testing.assert_array_equal(got_s, want_s)
    k = want_s.shape[1]
    for q in range(want_s.shape[0]):
        i = 0
        while i < k:
            j = i
            while j + 1 < k and want_s[q, j + 1] == want_s[q, i]:
                j += 1
            got, want = got_d[q, i: j + 1], want_d[q, i: j + 1]
            if j == k - 1:
                tied = set(deep_d[q][deep_s[q] == want_s[q, i]].tolist())
                ok = len(set(got.tolist())) == len(got) and \
                    set(got.tolist()) <= tied
            else:
                ok = sorted(got) == sorted(want)
            assert ok, (f"query {q}, ranks {i}..{j}: {got} against {want}")
            i = j + 1


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), probe=st.sampled_from([1, 2, 4]),
       codec=st.sampled_from(["raw", "packed"]))
@example(**TIE_EXAMPLE)
@example(**CUT_TIE_EXAMPLE)
def test_no_true_topk_doc_is_ever_pruned(seed, probe, codec):
    """Property: over random skewed corpora, queries and probe sizes, the
    pruned top-k equals the exhaustive top-k: scores exactly, ids up to
    the order of exact ties. On the two examples with a tie, the pruned
    ids equal the JAX package's pruned ids in order."""
    bd, bt, frac, live, starts, counts, nd_pad, rng = skewed_corpus(
        seed, nd=1500, vocab=12)
    q = int(rng.randint(1, 4))
    sets = [[tts.QueryLane(starts[t], counts[t], float(rng.rand() * 2 + 0.1))
             for t in rng.choice(len(starts), rng.randint(1, 4),
                                 replace=False)]
            for _ in range(q)]
    geom, rl, rh, wp, cb, corpus, bfmax, lt = staged(
        bd, bt, frac, live, nd_pad, 1, sets, q, codec)
    plan = tts.plan_pruned_tiles(rl, rh, wp, bfmax, probe_tiles=probe)
    keys = ("rl_probe", "rh_probe", "tid_probe", "rl_rest", "rh_rest",
            "tid_rest", "bounds_rest")
    out = tts.score_tiles_pruned(
        *[_t(x) for x in (*corpus, lt)], *[_t(plan[x]) for x in keys],
        _t(wp), t_pad=wp.shape[1], cb=cb, sub=geom.tile_sub, k=10,
        q_batch=q, codec=codec)
    es, ed, eh = _exhaustive(corpus, lt, rl, rh, wp, cb, geom, q, codec)
    deep_s, deep_d, _ = _exhaustive(corpus, lt, rl, rh, wp, cb, geom, q,
                                    codec, k=geom.tile_sub * LANE)
    assert_same_ranking(out[0].numpy(), out[1].numpy(), es, ed, deep_s,
                        deep_d)
    assert (out[2].numpy() <= eh).all()
    if dict(seed=seed, probe=probe, codec=codec) in (TIE_EXAMPLE,
                                                     CUT_TIE_EXAMPLE):
        (js, jd, _jh, _jn), (ts_, td, _th, _tn) = _pruned_both(
            corpus, lt, plan, wp, cb, geom, q, q, codec)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_allclose(ts_, js, rtol=RTOL, atol=1e-7)
        assert not np.array_equal(td, ed), "the example holds no tie"


def test_signature_defaults_to_topk_like_jax():
    """Called without ``dense``, both packages return the fused top-k
    triple of the same shapes and values."""
    bd, bt, frac, live, starts, counts, nd_pad, rng = skewed_corpus(4)
    sets = [[tts.QueryLane(starts[0], counts[0], 1.0)]]
    geom, rl, rh, wp, cb, corpus, _bf, lt = staged(
        bd, bt, frac, live, nd_pad, 4, sets, 1, "raw")
    kw = dict(t_pad=wp.shape[1], cb=cb, sub=geom.tile_sub)
    jo = jps.score_tiles(*[_j(x) for x in (*corpus, lt, rl, rh, wp)],
                         interpret=True, **kw)
    to = tts.score_tiles(*[_t(x) for x in (*corpus, lt, rl, rh, wp)], **kw)
    assert len(jo) == len(to) == 3
    for a, b in zip(jo, to):
        assert tuple(b.shape) == tuple(a.shape) == (geom.n_tiles, 1,
                                                    b.shape[2])
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))


# ----------------------------------------------------------------------
# The service: a pruned 2-shard index on the one-device mesh plane
# ----------------------------------------------------------------------

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "n": {"type": "integer"},
    "tag": {"type": "keyword"},
}}

PRUNE_SETTINGS = {
    "search.pallas.pruning.enabled": True,
    "search.pallas.pruning.probe_tiles": 2,
    "index.search.pallas.postings_codec": "packed",
}


def _docs(n_docs, seed):
    """Docs whose terms cluster by doc position (so tiles differ in their
    bounds), a few with long repeats (high tf)."""
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(20)]
    tags = ["red", "green", "blue"]
    out = []
    for d in range(n_docs):
        base = (d * len(vocab)) // n_docs
        toks = [vocab[(base + int(rng.zipf(2.0)) - 1) % len(vocab)]
                for _ in range(rng.randint(3, 12))]
        out.append((str(d), {"body": " ".join(toks), "n": d,
                             "tag": tags[d % 3]}))
    return out


def build_pair(name, n_docs=700, seed=3, **extra):
    common = {"index.number_of_shards": 2, "index.refresh_interval": -1,
              **extra}
    jidx = JIndex(name, JSettings({
        **common, "search.aggs.fused": False,
        "index.staging.delta.enabled": False,
        "index.requests.cache.enable": False}), mapping=MAPPING)
    # the port serves one device: give the JAX plane a one-device mesh
    jidx._mesh_search = JMesh(jidx, mesh=shard_mesh(1))
    tidx = IndexService(name, Settings(common), mapping=MAPPING,
                        device="cpu")
    for doc_id, src in _docs(n_docs, seed):
        jidx.index_doc(doc_id, src)
        tidx.index_doc(doc_id, src)
    jidx.refresh()
    tidx.refresh()
    return jidx, tidx


@pytest.fixture(scope="module")
def pruned_pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jidx, tidx = build_pair("prune-on", **PRUNE_SETTINGS)
    yield jidx, tidx
    jidx.close()
    tidx.close()
    mp.undo()


def _port_index(name, n_docs=700, seed=3, **extra):
    # a fixed segment layout: no scheduled refresh during the ingest
    tidx = IndexService(name, Settings({
        "index.number_of_shards": 2, "index.refresh_interval": -1,
        **extra}), mapping=MAPPING, device="cpu")
    for doc_id, src in _docs(n_docs, seed):
        tidx.index_doc(doc_id, src)
    tidx.refresh()
    return tidx


SERIAL = {
    "three_terms": {"query": {"match": {"body": "t0 t3 t7"}}, "size": 10},
    "one_term": {"query": {"match": {"body": "t1"}}, "size": 5},
    "rare_terms": {"query": {"match": {"body": "t12 t17"}}, "size": 8},
    "from_size": {"query": {"match": {"body": "t4 t9"}}, "size": 4,
                  "from": 3},
}


@pytest.mark.parametrize("name", sorted(SERIAL))
def test_mesh_pruned_equals_jax(pruned_pair, name):
    jidx, tidx = pruned_pair
    body = SERIAL[name]
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert tr["_plane"] == jr["_plane"] == "mesh_pallas"
    assert tr["_pruned"]["total_relation"] == "gte"
    assert set(tr["_pruned"]) == set(jr["_pruned"]) == {
        "tiles_scored", "tiles_pruned", "total_relation"}
    assert tr["_pruned"] == jr["_pruned"]
    assert_same_hits(jr, tr)
    # the totals relation: a lower bound of the exact count
    exact = tidx.search({**body, "size": 0})
    assert "_pruned" not in exact
    assert tr["hits"]["total"] <= exact["hits"]["total"]


def test_pruned_stats_and_packed_bytes(pruned_pair):
    jidx, tidx = pruned_pair
    for body in SERIAL.values():
        tidx.search(dict(body))
    st_ = tidx.search_stats()["planes"]
    assert st_["pruned_query_total"] >= len(SERIAL)
    assert st_["tiles_scored_total"] > 0
    assert st_["tiles_pruned_total"] > 0  # the skewed corpus prunes
    assert st_["postings_codec"] == "packed"
    assert st_["decisions"].get("mesh_pallas.served_pruned", 0) >= len(SERIAL)
    assert st_["mesh_batched_launch_total"] == 0  # Q == 1 is no batching
    raw = _port_index("prune-raw")
    raw.search(dict(SERIAL["one_term"]))
    st_raw = raw.search_stats()["planes"]
    assert st_raw["postings_codec"] == "raw"
    assert 0 < st_["postings_bytes_staged"] < st_raw["postings_bytes_staged"]
    assert st_raw["pruned_query_total"] == 0
    # the JAX package counts the same pruned queries and tiles
    jst = jidx.stats()["total"]["search"]["planes"]
    assert jst["postings_codec"] == "packed"


FALLBACKS = {
    "aggs": {"query": {"match": {"body": "t0 t1"}}, "size": 5,
             "aggs": {"tags": {"terms": {"field": "tag"}}}},
    "operator_and": {"query": {"match": {"body": {"query": "t0 t1",
                                                  "operator": "and"}}},
                     "size": 5},
    "msm": {"query": {"match": {"body": {"query": "t2 t3 t5",
                                         "minimum_should_match": 2}}},
            "size": 5},
    "size_0": {"query": {"match": {"body": "t1"}}, "size": 0},
    "post_filter": {"query": {"match": {"body": "t2 t6"}}, "size": 5,
                    "post_filter": {"term": {"tag": "red"}}},
    "min_score": {"query": {"match": {"body": "t2 t6"}}, "size": 5,
                  "min_score": 1.5},
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_exhaustive_fallbacks_carry_no_marker(pruned_pair, name):
    """Requests needing every tile's output never take the pruned path:
    exact totals, no ``_pruned``, the same response as JAX."""
    jidx, tidx = pruned_pair
    body = FALLBACKS[name]
    jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
    assert "_pruned" not in tr and "_pruned" not in jr
    assert tr["_plane"] == jr["_plane"] == "mesh_pallas"
    assert_same_hits(jr, tr)
    assert jr.get("aggregations") == tr.get("aggregations")


def test_search_batch_with_pruning(pruned_pair):
    """A burst rides the pruned batched program: every member pruned, equal
    to JAX's member; hits and scores equal the member's serial response;
    its total lies between the serial total and the exact one (a tile
    survives when any member needs it)."""
    jidx, tidx = pruned_pair
    bodies = [{"query": {"match": {"body": f"t{i} t{(5 * i + 3) % 20}"}},
               "size": 6} for i in range(5)]
    launched = tidx._mesh_plane().batched_launch_total
    jout = jidx.search_batch([dict(b) for b in bodies])
    tout = tidx.search_batch([dict(b) for b in bodies])
    assert tidx._mesh_search.batched_launch_total == launched + 1
    for body, jr, tr in zip(bodies, jout, tout):
        assert isinstance(tr, dict) and tr["_plane"] == "mesh_pallas"
        assert tr["_pruned"] == jr["_pruned"]
        assert_same_hits(jr, tr)
        serial = tidx.search(dict(body))
        assert ([(h["_id"], h["_score"]) for h in tr["hits"]["hits"]]
                == [(h["_id"], h["_score"]) for h in serial["hits"]["hits"]])
        exact = tidx.search({**body, "size": 0})["hits"]["total"]
        assert serial["hits"]["total"] <= tr["hits"]["total"] <= exact


def test_deletes_then_pruned_again(pruned_pair):
    jidx, tidx = pruned_pair
    for d in range(0, 700, 23):
        assert (jidx.delete_doc(str(d))["result"]
                == tidx.delete_doc(str(d))["result"] == "deleted")
    jidx.refresh()
    tidx.refresh()
    for body in SERIAL.values():
        jr, tr = jidx.search(dict(body)), tidx.search(dict(body))
        assert "_pruned" in tr and tr["_pruned"] == jr["_pruned"]
        assert_same_hits(jr, tr)
        assert not any(int(h["_id"]) % 23 == 0 for h in tr["hits"]["hits"])
    planes = tidx.search_stats()["planes"]
    assert planes["plane_failures_total"] == {"mesh_pallas": 0, "mesh": 0}


@pytest.mark.parametrize("how", ["serial", "batch"])
def test_sel_kernel_fault_raises(monkeypatch, how):
    """A KernelError in the sel-mode kernel raises through the serial and
    the batched pruned paths: no rung serves in its place, no plane is
    benched."""
    tidx = _port_index("prune-kfault", **PRUNE_SETTINGS)
    orig = tts.score_tiles

    def broken(*args, **kw):
        if kw.get("tile_ids") is not None:
            raise KernelError("tile_scoring_topk_sel_packed kernel launch "
                              "failed: CUDA error 700")
        return orig(*args, **kw)

    monkeypatch.setattr(tts, "score_tiles", broken)
    bodies = [dict(b) for b in SERIAL.values()]
    with pytest.raises(KernelError):
        if how == "serial":
            tidx.search(bodies[0])
        else:
            tidx.search_batch(bodies)
    planes = tidx.search_stats()["planes"]
    assert planes["plane_failures_total"] == {"mesh_pallas": 0, "mesh": 0}
    assert planes["plane_quarantined"] == []


@pytest.mark.parametrize("how", ["serial", "batch"])
def test_other_fault_under_pruning_benches_once(monkeypatch, how):
    """Any other fault in the pruned program benches mesh_pallas once for
    the request or the whole batch; the next rung serves, exhaustively."""
    tidx = _port_index("prune-fault", **PRUNE_SETTINGS)
    want = tidx.search(dict(SERIAL["three_terms"]))
    orig = tts.score_tiles

    def broken(*args, **kw):
        if kw.get("tile_ids") is not None:
            raise RuntimeError("staged table went missing")
        return orig(*args, **kw)

    monkeypatch.setattr(tts, "score_tiles", broken)
    if how == "serial":
        got = tidx.search(dict(SERIAL["three_terms"]))
        # served by the scatter rung, exact (no marker)
        assert got["_plane"] == "mesh" and "_pruned" not in got
        assert got["hits"]["total"] >= want["hits"]["total"]
    else:
        out = tidx.search_batch([dict(b) for b in SERIAL.values()])
        assert all(isinstance(r, dict) and r["_plane"] == "host"
                   and "_pruned" not in r for r in out)
    planes = tidx.search_stats()["planes"]
    assert planes["plane_failures_total"]["mesh_pallas"] == 1
    assert planes["plane_quarantined"] == ["mesh_pallas"]


def test_mixed_codec_stages_a_second_copy_only_where_needed(monkeypatch):
    """With a stand-in for the 2^20 cap, the larger segment's doc space
    stays raw and so does the stacked one: the mesh plane resolves raw, the
    small (packed) segment stages one extra raw copy for it, and the mesh
    answers as an all-raw index bit for bit."""
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for

    monkeypatch.setattr(tts, "PACKED_DOC_CAP", 256)
    route = {}
    i = 0
    while len(route) < 2:
        route.setdefault(shard_id_for(f"r{i}", 2), f"r{i}")
        i += 1
    docs = _docs(400, 5)
    idx = {}
    for name, extra in (("mixed", {"index.search.pallas.postings_codec":
                                   "packed"}), ("allraw", {})):
        svc = IndexService(name, Settings({"index.number_of_shards": 2,
                                           "index.refresh_interval": -1,
                                           **extra}),
                           mapping=MAPPING, device="cpu")
        for n, (doc_id, src) in enumerate(docs):
            # shard 0: 300 docs (nd_pad 512 > the cap), shard 1: 100 (128)
            svc.index_doc(doc_id, src, routing=route[0 if n < 300 else 1])
        svc.refresh()
        idx[name] = svc
    big, small = (idx["mixed"].shards[s].engine.searchable_segments()[0]
                  for s in (0, 1))
    assert (big.nd_pad, small.nd_pad) == (512, 128)
    for body in SERIAL.values():
        got = idx["mixed"].search(dict(body))
        want = idx["allraw"].search(dict(body))
        assert got["_plane"] == want["_plane"] == "mesh_pallas"
        assert got["hits"]["total"] == want["hits"]["total"]
        assert ([(h["_id"], h["_score"]) for h in got["hits"]["hits"]]
                == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])
    ex = idx["mixed"]._mesh_search._executor
    assert ex.postings_codec == "raw"
    assert sorted(big._kernel_tables) == ["raw"]
    assert sorted(small._kernel_tables) == ["raw"]  # the mesh's copy only
    # the host rung reads the small segment in its own codec, packed
    body = dict(SERIAL["one_term"])
    for seg in (big, small):
        seg.device_arrays()
    assert small.kernel_codec == "packed" and big.kernel_codec == "raw"
    assert sorted(small._kernel_tables) == ["packed", "raw"]
    assert small.postings_bytes_staged() == (
        small._kernel_tables["packed"]["k_packed"].numel() * 4
        + small._kernel_tables["raw"]["k_docs"].numel() * 8)
    host = idx["mixed"].shards[1].searcher.query(body, size_hint=5)
    assert host.total_hits > 0
