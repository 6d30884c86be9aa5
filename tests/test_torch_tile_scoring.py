"""Parity of the PyTorch tile-scoring module with the JAX Pallas kernel.

The same seeded numpy inputs go through ``elasticsearch_tpu``'s
``score_tiles`` (interpret mode, as tests/test_pallas_scoring.py runs it)
and through ``elasticsearch_tpu_torch``'s plain version on the CPU.
Tolerance: scores within rtol 1e-5 — the JAX kernel's two-pass bf16 split
carries about 2^-17 relative error (pallas_scoring.py:698-705) — while
match counts and the matched mask are exact. Against the numpy oracle
``reference_scores`` (the same f32 adds in the same order) the plain
version is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import pallas_scoring as jps
from elasticsearch_tpu_torch.ops import tile_scoring as tts

LANE = 128


def build_corpus(seed, nd, vocab, max_df=300, min_df=1):
    """Block-packed synthetic postings like SegmentBuilder.seal() emits."""
    rng = np.random.RandomState(seed)
    nd_pad = tts.next_pow2(nd)
    blocks_docs, blocks_tfs, term_start, term_count = [], [], [], []
    for _ in range(vocab):
        df = rng.randint(min_df, max_df)
        docs = np.sort(rng.choice(nd, size=min(df, nd),
                                  replace=False)).astype(np.int32)
        tfs = rng.randint(1, 5, size=len(docs)).astype(np.float32)
        nb = -(-len(docs) // LANE)
        term_start.append(len(blocks_docs))
        term_count.append(nb)
        for i in range(nb):
            d = np.full(LANE, nd_pad, np.int32)
            f = np.zeros(LANE, np.float32)
            chunk = docs[i * LANE:(i + 1) * LANE]
            d[: len(chunk)] = chunk
            f[: len(chunk)] = tfs[i * LANE:(i + 1) * LANE]
            blocks_docs.append(d)
            blocks_tfs.append(f)
    bd, bt = np.stack(blocks_docs), np.stack(blocks_tfs)
    doc_len = np.clip(rng.lognormal(np.log(40), 0.4, nd_pad + 1), 5, 200)
    doc_len = doc_len.astype(np.float32)
    return bd, bt, term_start, term_count, nd_pad, doc_len, rng


def tables(pkg, bd, frac, live, lanes, nd_pad, tile_sub):
    geom = pkg.tile_geometry(nd_pad, tile_sub=tile_sub)
    bmin, bmax = pkg.block_min_max(bd, frac, nd_pad)
    row_lo, row_hi, weights, cb = pkg.build_tile_tables(
        [pkg.QueryLane(*ln) for ln in lanes], bmin, bmax, geom)
    dp, fp = pkg.pad_segment_blocks(bd, frac, nd_pad)
    return geom, row_lo, row_hi, weights, cb, dp, fp, pkg.build_live_t(live, geom)


def run_both(bd, frac, live, lanes, nd_pad, tile_sub, with_counts):
    geom, rl, rh, w, cb, dp, fp, lt = tables(tts, bd, frac, live, lanes,
                                             nd_pad, tile_sub)
    jouts = jps.score_tiles(
        jnp.asarray(dp), jnp.asarray(fp), jnp.asarray(lt), jnp.asarray(rl),
        jnp.asarray(rh), jnp.asarray(w), t_pad=w.shape[1], cb=cb,
        sub=geom.tile_sub, dense=True, with_counts=with_counts,
        interpret=True)
    touts = tts.score_tiles(
        torch.from_numpy(dp), torch.from_numpy(fp), torch.from_numpy(lt),
        torch.from_numpy(rl), torch.from_numpy(rh), torch.from_numpy(w),
        t_pad=w.shape[1], cb=cb, sub=geom.tile_sub, dense=True,
        with_counts=with_counts)
    return geom, [np.asarray(o) for o in jouts], [o.numpy() for o in touts]


def _case(name):
    """(bd, frac, live, lanes, nd_pad, tile_sub) for a named case."""
    if name == "multi_row_lanes":
        bd, bt, ts_, tc, nd_pad, dl, rng = build_corpus(1, 3000, 40,
                                                        max_df=900, min_df=300)
        lanes = [(ts_[i], tc[i], w) for i, w in ((3, 1.4), (10, 0.9), (21, 2.0))]
        assert all(c > 1 for _, c, _ in lanes)
        live = np.zeros(nd_pad, np.float32)
        live[:3000] = 1.0
        tile_sub = 8
    elif name == "deletes":
        bd, bt, ts_, tc, nd_pad, dl, rng = build_corpus(2, 1000, 20)
        lanes = [(ts_[0], tc[0], 1.0), (ts_[5], tc[5], 0.7)]
        live = np.zeros(nd_pad, np.float32)
        live[:1000] = 1.0
        live[rng.choice(1000, 200, replace=False)] = 0.0
        tile_sub = 4
    elif name == "shrunk_sub":
        # the geometry ladder's smaller tile: many tiles, windows that
        # straddle tile boundaries
        bd, bt, ts_, tc, nd_pad, dl, rng = build_corpus(3, 4000, 30,
                                                        max_df=2000, min_df=1000)
        lanes = [(ts_[i], tc[i], 1.0 + 0.1 * i) for i in range(6)]
        live = np.zeros(nd_pad, np.float32)
        live[:4000] = 1.0
        tile_sub = 2
    elif name == "empty_lanes":
        # a missing/zero-weight lane in the middle of the set
        bd, bt, ts_, tc, nd_pad, dl, rng = build_corpus(4, 500, 10)
        lanes = [(ts_[1], tc[1], 1.2), (0, 0, 0.0), (ts_[2], tc[2], 0.0),
                 (ts_[7], tc[7], 0.4)]
        live = np.zeros(nd_pad, np.float32)
        live[:500] = 1.0
        tile_sub = 128
    else:
        raise ValueError(name)
    frac = tts.compute_block_frac(bd, bt, dl, avgdl=float(dl.mean()))
    return bd, frac, live, lanes, nd_pad, tile_sub


CASES = ["multi_row_lanes", "deletes", "shrunk_sub", "empty_lanes"]


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel(case, with_counts):
    bd, frac, live, lanes, nd_pad, tile_sub = _case(case)
    geom, jouts, touts = run_both(bd, frac, live, lanes, nd_pad, tile_sub,
                                  with_counts)
    assert len(jouts) == len(touts) == 1 + int(with_counts)
    assert touts[0].shape == jouts[0].shape == (geom.n_tiles * LANE,
                                                geom.tile_sub)
    np.testing.assert_allclose(touts[0], jouts[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(touts[0] > 0, jouts[0] > 0)
    if with_counts:
        np.testing.assert_array_equal(touts[1], jouts[1])


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_scores(case):
    bd, frac, live, lanes, nd_pad, tile_sub = _case(case)
    geom, rl, rh, w, cb, dp, fp, lt = tables(tts, bd, frac, live, lanes,
                                             nd_pad, tile_sub)
    (out,) = tts.score_tiles(
        torch.from_numpy(dp), torch.from_numpy(fp), torch.from_numpy(lt),
        torch.from_numpy(rl), torch.from_numpy(rh), torch.from_numpy(w),
        t_pad=w.shape[1], cb=cb, sub=geom.tile_sub)
    flat = tts.dense_to_flat(out, geom.tile_sub).numpy()[:nd_pad]
    ref = tts.reference_scores(bd, frac, [tts.QueryLane(*ln) for ln in lanes],
                               nd_pad)
    ref[live[:nd_pad] == 0] = 0.0
    np.testing.assert_allclose(flat, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_host_helpers_equal(case):
    bd, frac, live, lanes, nd_pad, tile_sub = _case(case)
    bt = (frac > 0).astype(np.float32)
    dl = np.linspace(3, 90, nd_pad + 1).astype(np.float32)
    np.testing.assert_array_equal(
        tts.compute_block_frac(bd, bt, dl, 31.5),
        jps.compute_block_frac(bd, bt, dl, 31.5))
    assert tuple(tts.tile_geometry(nd_pad, tile_sub)) == tuple(
        jps.tile_geometry(nd_pad, tile_sub))
    for a, b in zip(tables(tts, bd, frac, live, lanes, nd_pad, tile_sub),
                    tables(jps, bd, frac, live, lanes, nd_pad, tile_sub)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert tuple(a) == tuple(b) if isinstance(a, tuple) else a == b
    for a, b in zip(tts.block_min_max(bd, frac, nd_pad),
                    jps.block_min_max(bd, frac, nd_pad)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tts.reference_scores(bd, frac, [tts.QueryLane(*ln) for ln in lanes], nd_pad),
        jps.reference_scores(bd, frac, [jps.QueryLane(*ln) for ln in lanes], nd_pad))


def test_ladder_bound_raises_like_jax():
    bd, bt, ts_, tc, nd_pad, dl, _ = build_corpus(5, 4000, 4, max_df=4000,
                                                  min_df=3999)
    lanes = [(ts_[0], tc[0], 1.0)]
    for pkg in (tts, jps):
        bmin, bmax = pkg.block_min_max(bd, bt, nd_pad)
        geom = pkg.tile_geometry(nd_pad, 128)
        # one dense term puts 32 blocks in the single 4096-doc tile: a cb of
        # 8 is too small in both packages
        with pytest.raises(ValueError):
            pkg.build_tile_tables([pkg.QueryLane(*lanes[0])], bmin, bmax,
                                  geom, cb=8)


def test_wrapper_rejects_unported_variants_and_bad_inputs():
    bd, frac, live, lanes, nd_pad, tile_sub = _case("deletes")
    geom, rl, rh, w, cb, dp, fp, lt = tables(tts, bd, frac, live, lanes,
                                             nd_pad, tile_sub)
    args = [torch.from_numpy(x) for x in (dp, fp, lt, rl, rh, w)]
    kw = dict(t_pad=w.shape[1], cb=cb, sub=geom.tile_sub)
    for bad in (dict(dense=False), dict(codec="packed"), dict(q_batch=2)):
        with pytest.raises(NotImplementedError):
            tts.score_tiles(*args, **kw, **bad)
    wrong = list(args)
    wrong[1] = wrong[1].double()
    with pytest.raises(TypeError):
        tts.score_tiles(*wrong, **kw)
    with pytest.raises(ValueError):
        tts.score_tiles(*args, t_pad=w.shape[1] * 2, cb=cb, sub=geom.tile_sub)
