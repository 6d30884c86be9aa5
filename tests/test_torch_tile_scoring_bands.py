"""The dense tile kernel's launch plan, and the band-edge inputs that hold
the kernel on the card, pinned to the JAX reference.

- ``dense_band_plan`` over sub 1..128, Q 1..64, with and without counts,
  t_pad up to 64: S is a power of two dividing sub and at least min(4,
  sub); the groups cover Q, the last one possibly ragged; a block's shared
  memory (the C entry point's formula) leaves room for four blocks an SM;
  no wider band fits and still fills the card; G is the most queries that
  fit beside the band; the bench geometry (2^20 docs, sub 128) launches
  at least 2 x 132 blocks at Q = 1, 2 and 16; a budget too small for
  S = 1, G = 1 raises.
- ``score_tiles_plain`` against the JAX ``score_tiles`` (interpret mode,
  as tests/test_torch_tile_scoring.py runs it) on ``chip_smoke.py``'s
  band-edge corpus, the inputs ``chip_smoke.py`` feeds the kernel on the
  card: raw over a 2^13-doc space on three rungs of the ladder, packed at
  the 2^20 cap (docs at and above 2^19 set their word's sign bit), Q 1, 2
  and 16 with dead lanes, with and without counts. Tolerances as in
  test_torch_tile_scoring.py: scores within rtol 1e-5 (the JAX kernel's
  two-pass bf16 split, about 2^-17 relative), counts and the matched mask
  exact.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import pallas_scoring as jps
from elasticsearch_tpu_torch.ops import tile_scoring as tts

LANE = 128
SUBS = [1, 2, 4, 8, 16, 32, 64, 128]
BENCH_DOCS = 1 << 20


@functools.lru_cache(maxsize=None)
def chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_plan(plan, sub, q_batch, with_counts, t_pad, n_tiles, budget):
    s, g = plan.band_sub, plan.group
    assert s >= 1 and s & (s - 1) == 0 and sub % s == 0
    assert 1 <= g <= min(q_batch, tts.DENSE_MAX_GROUP)
    n_groups = -(-q_batch // g)
    # every query in exactly one group; only the last may hold fewer
    assert (n_groups - 1) * g < q_batch <= n_groups * g
    assert plan.smem == tts.dense_band_smem(s, g, t_pad, with_counts)
    assert 2 * (plan.smem + tts.BLOCK_RESERVED_SMEM) <= budget
    assert plan.blocks == n_tiles * (sub // s) * n_groups


def largest_group(s, q_batch, t_pad, with_counts, per_block):
    """The largest near-equal query group that fits beside a band of s."""
    best = 0
    for n_groups in range(-(-q_batch // tts.DENSE_MAX_GROUP), q_batch + 1):
        g = -(-q_batch // n_groups)
        if tts.dense_band_smem(s, g, t_pad, with_counts) <= per_block:
            best = max(best, g)
    return best


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("sub", SUBS)
def test_band_plan_properties(sub, with_counts):
    budget = tts.H100_SM_SHARED_BYTES
    four = budget // 4 - tts.BLOCK_RESERVED_SMEM
    for q_batch in (1, 2, 3, 5, 16, 17, 33, 64):
        for t_pad in (1, 4, 16, 64):
            for n_tiles in (1, 8, 64, 8192):
                plan = tts.dense_band_plan(sub, q_batch, with_counts, t_pad,
                                           budget, n_tiles=n_tiles)
                check_plan(plan, sub, q_batch, with_counts, t_pad, n_tiles,
                           budget)
                # the vector epilogue wherever the tile is 4 columns wide
                assert plan.band_sub >= min(4, sub)
                # four blocks an SM at these sizes
                assert plan.smem <= four
                s, g = plan.band_sub, plan.group
                # the most queries that fit beside the band
                assert g == largest_group(s, q_batch, t_pad, with_counts,
                                          four)
                # no wider band that fits also reaches two blocks an SM
                enough = plan.blocks >= 2 * tts.H100_SMS
                wider = 2 * s
                while wider <= sub:
                    gw = largest_group(wider, q_batch, t_pad, with_counts,
                                       four)
                    assert not gw or not enough or (
                        n_tiles * (sub // wider) * -(-q_batch // gw)
                        < 2 * tts.H100_SMS)
                    wider *= 2


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("q_batch,t_pad", [(1, 4), (2, 8), (16, 64)])
def test_band_plan_fills_the_card_at_the_bench_geometry(q_batch, t_pad,
                                                        with_counts):
    geom = tts.tile_geometry(BENCH_DOCS, 128)
    plan = tts.dense_band_plan(geom.tile_sub, q_batch, with_counts, t_pad,
                               n_tiles=geom.n_tiles)
    assert plan.blocks >= 2 * tts.H100_SMS
    # the sizes the kernel's note gives for 2^20 docs: Q = 1 a band of 2048
    # docs; Q = 16 bands of 4096 docs for two queries (one with counts)
    want = {(1, False): (16, 1), (1, True): (16, 1), (2, False): (16, 2),
            (2, True): (32, 1), (16, False): (32, 2),
            (16, True): (32, 1)}[q_batch, with_counts]
    assert (plan.band_sub, plan.group) == want


def test_band_plan_ragged_groups_and_small_budgets_raise():
    plan = tts.dense_band_plan(128, 5, False, 16, n_tiles=64)
    assert (plan.band_sub, plan.group) == (32, 2)  # groups of 2, 2 and 1
    check_plan(plan, 128, 5, False, 16, 64, tts.H100_SM_SHARED_BYTES)
    # a tight budget: the widest band that still fits, one query a block
    budget = 4 * (tts.dense_band_smem(4, 3, 16, False)
                  + tts.BLOCK_RESERVED_SMEM)
    plan = tts.dense_band_plan(128, 16, False, 16, budget, n_tiles=64)
    assert (plan.band_sub, plan.group) == (8, 1)
    check_plan(plan, 128, 16, False, 16, 64, budget)
    # a budget that holds only S = 1, G = 1: the scalar band
    tight = 2 * (tts.dense_band_smem(1, 1, 4, False)
                 + tts.BLOCK_RESERVED_SMEM)
    plan = tts.dense_band_plan(128, 8, False, 4, tight, n_tiles=64)
    assert (plan.band_sub, plan.group) == (1, 1)
    with pytest.raises(ValueError):
        tts.dense_band_plan(128, 8, False, 4, tight - 8, n_tiles=64)
    with pytest.raises(ValueError):
        tts.dense_band_plan(1, 1, True, 64, 1024)


@functools.lru_cache(maxsize=None)
def band_case(nd_pad):
    return chip_smoke().band_edge_corpus(nd_pad)


def test_band_edge_corpus_sits_on_every_band_edge():
    c = band_case(1 << 13)
    docs = c["block_docs"]
    edge_term = docs[c["term_start"][0]: c["term_start"][0]
                     + c["term_rows"][0]].ravel()
    nd = c["nd_pad"]
    for sub in SUBS:
        for q_batch in (1, 2, 16):
            geom = tts.tile_geometry(nd, sub)
            plan = tts.dense_band_plan(sub, q_batch, True, 8,
                                       n_tiles=geom.n_tiles)
            d = plan.band_sub * LANE
            lo = np.arange(d, nd, d)
            assert np.isin(lo - 1, edge_term).all()
            assert np.isin(lo, edge_term).all()
    # the packed corpus reaches the sign bit and the last doc
    big = band_case(tts.PACKED_DOC_CAP)
    all_docs = big["block_docs"][big["block_docs"] < big["nd_pad"]]
    assert (all_docs >= 1 << 19).sum() > 1000 and all_docs.max() == (1 << 20) - 1
    assert any(len(m) == 0 for m in c["members"])


@functools.lru_cache(maxsize=None)
def band_run(nd_pad, sub, q_batch, codec):
    """(JAX outputs with counts, the tables and arrays) for one case."""
    c = band_case(nd_pad)
    geom, rl, rh, w, cb = chip_smoke().band_edge_tables(tts, c, sub, q_batch)
    lt = tts.build_live_t(c["live"], geom)
    if codec == "packed":
        a0, a1 = tts.pack_segment_blocks(c["block_docs"], c["frac"], nd_pad), None
    else:
        a0, a1 = tts.pad_segment_blocks(c["block_docs"], c["frac"], nd_pad)
    jo = jps.score_tiles(
        jnp.asarray(a0), None if a1 is None else jnp.asarray(a1),
        jnp.asarray(lt), jnp.asarray(rl), jnp.asarray(rh), jnp.asarray(w),
        t_pad=w.shape[1], cb=cb, sub=sub, dense=True, with_counts=True,
        q_batch=q_batch, codec=codec, interpret=True)
    args = [torch.from_numpy(a0), None if a1 is None else torch.from_numpy(a1),
            torch.from_numpy(lt), torch.from_numpy(rl), torch.from_numpy(rh),
            torch.from_numpy(w)]
    return [np.asarray(o) for o in jo], args, w


CASES = ([("raw", 1 << 13, sub, q) for sub in (64, 4, 1) for q in (1, 2, 16)]
         + [("packed", 1 << 20, 128, q) for q in (1, 2)])


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("codec,nd_pad,sub,q_batch", CASES)
def test_plain_matches_jax_on_band_edges(codec, nd_pad, sub, q_batch,
                                         with_counts):
    jo, args, w = band_run(nd_pad, sub, q_batch, codec)
    touts = tts.score_tiles_plain(*args, sub=sub, with_counts=with_counts,
                                  q_batch=q_batch)
    assert len(touts) == 1 + int(with_counts)
    scores = touts[0].numpy()
    assert scores.shape == jo[0].shape
    np.testing.assert_allclose(scores, jo[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(scores > 0, jo[0] > 0)
    if with_counts:
        np.testing.assert_array_equal(touts[1].numpy(), jo[1])
        # a dead lane (weight 0, or another member's term) adds no count
        most = touts[1].numpy().reshape(q_batch, -1).max(axis=1)
        assert (most <= (w > 0).sum(axis=1)).all()
    # the band edges score: docs on both sides of each 128-doc edge
    flat = tts.dense_to_flat(
        torch.from_numpy(scores.reshape(-1, sub)[: nd_pad // sub]), sub).numpy()
    live = band_case(nd_pad)["live"]
    edge = np.arange(LANE, nd_pad, LANE)
    hit = edge[live[edge] & live[edge - 1]]
    assert (flat[hit] > 0).all() and (flat[hit - 1] > 0).all()
