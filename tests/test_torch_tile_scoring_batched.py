"""Parity of the port's batched (q_batch > 1) and fused top-k tile scoring
with the JAX Pallas kernel, and of the candidate merges.

The same seeded numpy inputs go through ``elasticsearch_tpu``'s
``score_tiles`` in interpret mode and through ``elasticsearch_tpu_torch``'s
plain versions on the CPU. Tolerances: scores within rtol 1e-5 (the JAX
kernel's two-pass bf16 split carries about 2^-17 relative error,
pallas_scoring.py:698-705); match counts, hit counts and top-k doc ids
exact. The corpus uses one doc length and tfs 1-3, so scores take few
distinct values: exact ties are common (both packages break them to the
lower doc id) while distinct scores stay far apart. Inside the port a
batched member equals its own ``q_batch=1`` result bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import pallas_scoring as jps
from elasticsearch_tpu_torch.ops import tile_scoring as tts
from test_torch_tile_scoring import build_corpus

LANE = 128


def corpus(seed, nd=3000, vocab=24):
    bd, bt, starts, counts, nd_pad, _dl, rng = build_corpus(
        seed, nd, vocab, max_df=700, min_df=20)
    bt = np.minimum(bt, 3.0).astype(np.float32)
    dl = np.full(nd_pad + 1, 12.0, np.float32)
    frac = tts.compute_block_frac(bd, bt, dl, avgdl=12.0)
    live = np.zeros(nd_pad, np.float32)
    live[:nd] = 1.0
    live[rng.choice(nd, nd // 10, replace=False)] = 0.0
    return bd, frac, live, starts, counts, nd_pad


def lane_sets_for(starts, counts, spec):
    return [[tts.QueryLane(starts[t], counts[t], w) for t, w in q]
            for q in spec]


# heterogeneous members: a shared term (lane dedup), different term
# counts, a lane order that differs from the union's, a dead member
SPEC = [
    [(0, 1.3), (3, 0.7)],
    [(3, 2.0)],
    [(5, 0.4), (7, 1.1), (9, 0.9)],
    [(9, 1.6), (0, 0.5), (11, 1.0)],
    [],
]


def tables(pkg, bd, frac, live, nd_pad, tile_sub, lane_sets):
    geom = pkg.tile_geometry(nd_pad, tile_sub=tile_sub)
    bmin, bmax = pkg.block_min_max(bd, frac, nd_pad)
    qsets = [[pkg.QueryLane(*ln) for ln in lanes] for lanes in lane_sets]
    rl, rh, w, cb = pkg.build_tile_tables_batched(qsets, bmin, bmax, geom)
    dp, fp = pkg.pad_segment_blocks(bd, frac, nd_pad)
    return geom, rl, rh, w, cb, dp, fp, pkg.build_live_t(live, geom)


def run_jax(geom, rl, rh, w, cb, dp, fp, lt, **kw):
    outs = jps.score_tiles(
        jnp.asarray(dp), jnp.asarray(fp), jnp.asarray(lt), jnp.asarray(rl),
        jnp.asarray(rh), jnp.asarray(w), t_pad=w.shape[1], cb=cb,
        sub=geom.tile_sub, interpret=True, q_batch=w.shape[0], **kw)
    return [np.array(o) for o in outs]


def run_port(geom, rl, rh, w, cb, dp, fp, lt, **kw):
    outs = tts.score_tiles(
        *[torch.from_numpy(x) for x in (dp, fp, lt, rl, rh, w)],
        t_pad=w.shape[1], cb=cb, sub=geom.tile_sub, q_batch=w.shape[0], **kw)
    return [o.numpy() for o in outs]


@pytest.fixture(scope="module")
def data():
    bd, frac, live, starts, counts, nd_pad = corpus(7)
    return bd, frac, live, nd_pad, lane_sets_for(starts, counts, SPEC)


def test_union_and_batched_tables_equal(data):
    bd, frac, live, nd_pad, lane_sets = data
    ju, jw = jps.union_query_lanes(
        [[jps.QueryLane(*ln) for ln in lanes] for lanes in lane_sets])
    tu, tw = tts.union_query_lanes(lane_sets)
    assert [tuple(x) for x in tu] == [tuple(x) for x in ju]
    np.testing.assert_array_equal(tw, jw)
    for sub in (8, 2):
        for a, b in zip(tables(tts, bd, frac, live, nd_pad, sub, lane_sets),
                        tables(jps, bd, frac, live, nd_pad, sub, lane_sets)):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert tuple(a) == tuple(b) if isinstance(a, tuple) else a == b


@pytest.mark.parametrize("tile_sub,with_counts", [(8, False), (2, True)])
def test_plain_batched_dense_matches_jax(data, tile_sub, with_counts):
    bd, frac, live, nd_pad, lane_sets = data
    t = tables(tts, bd, frac, live, nd_pad, tile_sub, lane_sets)
    jouts = run_jax(*t, dense=True, with_counts=with_counts)
    touts = run_port(*t, dense=True, with_counts=with_counts)
    geom = t[0]
    assert len(touts) == len(jouts) == 1 + int(with_counts)
    assert touts[0].shape == jouts[0].shape == (
        len(lane_sets), geom.n_tiles * LANE, geom.tile_sub)
    np.testing.assert_allclose(touts[0], jouts[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(touts[0] > 0, jouts[0] > 0)
    if with_counts:
        # dead lanes (another member's terms) add no count
        np.testing.assert_array_equal(touts[1], jouts[1])
        for q, lanes in enumerate(lane_sets):
            assert touts[1][q].max() <= len(lanes)


@pytest.mark.parametrize("tile_sub,k", [(8, 4), (1, 16)])
def test_plain_topk_matches_jax(data, tile_sub, k):
    bd, frac, live, nd_pad, lane_sets = data
    t = tables(tts, bd, frac, live, nd_pad, tile_sub, lane_sets)
    js, jd, jh = run_jax(*t, dense=False, k=k)
    ts_, td, th = run_port(*t, dense=False, k=k)
    kk = min(k, tile_sub * LANE)
    assert ts_.shape == js.shape == (t[0].n_tiles, len(lane_sets), kk)
    assert td.dtype == np.int32 and th.shape == jh.shape
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(ts_, js, rtol=1e-5, atol=1e-7)
    # the cases the test is for: ties, empty tiles, k beyond the hits
    s = ts_[np.isfinite(ts_)]
    assert len(s) > len(np.unique(s))
    assert (th == 0).any()
    assert (th[..., 0] < kk).any()
    assert (td[~np.isfinite(ts_)] == -1).all()


def test_plain_topk_single_query_matches_jax(data):
    bd, frac, live, nd_pad, lane_sets = data
    t = tables(tts, bd, frac, live, nd_pad, 4, lane_sets[2:3])
    js, jd, jh = run_jax(*t, dense=False, k=10)
    ts_, td, th = run_port(*t, dense=False, k=10)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(ts_, js, rtol=1e-5, atol=1e-7)


def test_merges_equal_including_ties(data):
    bd, frac, live, nd_pad, lane_sets = data
    t = tables(tts, bd, frac, live, nd_pad, 2, lane_sets)
    js, jd, jh = run_jax(*t, dense=False, k=8)
    for k in (5, 40, 10_000):
        jb = jps.merge_tile_topk_batched(jnp.asarray(js), jnp.asarray(jd),
                                         jnp.asarray(jh), k)
        tb = tts.merge_tile_topk_batched(torch.from_numpy(js),
                                         torch.from_numpy(jd),
                                         torch.from_numpy(jh), k)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        j1 = jps.merge_tile_topk(jnp.asarray(js[:, :1]), jnp.asarray(jd[:, :1]),
                                 jnp.asarray(jh[:, :1]), k)
        t1 = tts.merge_tile_topk(*[torch.from_numpy(x[:, :1].copy())
                                   for x in (js, jd, jh)], k)
        for a, b in zip(t1, j1):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # tied candidates: the lower flat index wins in both
    s = np.array([[[1.0, 1.0]], [[2.0, 1.0]]], np.float32)
    d = np.array([[[4, 9]], [[1, 3]]], np.int32)
    h = np.ones((2, 1, 1), np.float32)
    jb = jps.merge_tile_topk_batched(jnp.asarray(s), jnp.asarray(d),
                                     jnp.asarray(h), 3)
    tb = tts.merge_tile_topk_batched(torch.from_numpy(s), torch.from_numpy(d),
                                     torch.from_numpy(h), 3)
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
    assert tb[1].tolist() == [[1, 4, 9]]


@pytest.mark.parametrize("with_counts", [False, True])
def test_batched_member_bit_equal_to_serial(data, with_counts):
    bd, frac, live, nd_pad, lane_sets = data
    members = lane_sets[:4]
    t = tables(tts, bd, frac, live, nd_pad, 4, members)
    dense = run_port(*t, dense=True, with_counts=with_counts)
    top = run_port(*t, dense=False, k=12)
    for q, lanes in enumerate(members):
        ts = tables(tts, bd, frac, live, nd_pad, 4, [lanes])
        assert ts[1].shape[1] <= t[1].shape[1]
        one = run_port(*ts, dense=True, with_counts=with_counts)
        # q_batch=1 output has no leading axis
        np.testing.assert_array_equal(dense[0][q], one[0])
        if with_counts:
            np.testing.assert_array_equal(dense[1][q], one[1])
        s1, d1, h1 = run_port(*ts, dense=False, k=12)
        np.testing.assert_array_equal(top[0][:, q], s1[:, 0])
        np.testing.assert_array_equal(top[1][:, q], d1[:, 0])
        np.testing.assert_array_equal(top[2][:, q], h1[:, 0])


@pytest.mark.parametrize("shape,k", [((37,), 5), ((4, 64), 16), ((3, 2, 9), 12),
                                     ((1, 300), 300)])
def test_top_k_matches_lax_top_k_with_ties(shape, k):
    """The one top-k helper of the port (serial and batched merges) gives
    ``lax.top_k``'s values and indices, ties to the lower index, -inf
    entries included."""
    from jax import lax

    from elasticsearch_tpu_torch.ops.scoring import top_k

    rng = np.random.default_rng(sum(shape) + k)
    pool = np.array([0.0, 0.5, 1.0, 1.0, 2.25, -1.5, -np.inf], np.float32)
    x = rng.choice(pool, size=shape).astype(np.float32)
    jv, ji = lax.top_k(jnp.asarray(x), min(k, shape[-1]))
    tv, ti = top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
