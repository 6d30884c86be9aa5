"""Parity of the port's ``ops/scoring.py`` and BM25 lane math with JAX.

Same seeded numpy inputs into ``elasticsearch_tpu.ops.scoring`` (jitted
JAX on the CPU) and ``elasticsearch_tpu_torch.ops.scoring``. The scatter
scores agree within rtol 1e-6 (f32, scatter order may differ), match
counts exactly; ``select_topk`` returns the same docs in the same order,
ties by ascending doc id.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index import similarity as jsim
from elasticsearch_tpu.ops import scoring as js
from elasticsearch_tpu_torch.index import similarity as tsim
from elasticsearch_tpu_torch.ops import scoring as ts


def _postings(seed, nd_pad=512, n_blocks=24):
    rng = np.random.RandomState(seed)
    block_docs = np.full((n_blocks, 128), nd_pad, np.int32)
    block_tfs = np.zeros((n_blocks, 128), np.float32)
    for b in range(n_blocks):
        n = rng.randint(1, 128)
        block_docs[b, :n] = np.sort(rng.choice(nd_pad, n, replace=False))
        block_tfs[b, :n] = rng.randint(1, 6, n)
    norms = np.ones((2, nd_pad + 1), np.float32)
    norms[:, :nd_pad] = rng.randint(3, 90, (2, nd_pad))
    qb = 16
    q_blocks = rng.choice(n_blocks, qb, replace=False).astype(np.int32)
    q_weights = rng.rand(qb).astype(np.float32) + 0.1
    q_rows = rng.randint(0, 2, qb).astype(np.int32)
    q_avgdl = (rng.rand(qb) * 40 + 20).astype(np.float32)
    q_valid = rng.rand(qb) > 0.2
    return block_docs, block_tfs, norms, q_blocks, q_weights, q_rows, q_avgdl, q_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_term_blocks_matches_jax(seed):
    args = _postings(seed)
    js_s, js_c = js.score_term_blocks(*[jnp.asarray(a) for a in args])
    ts_s, ts_c = ts.score_term_blocks(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(ts_s.numpy(), np.asarray(js_s), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ts_c.numpy(), np.asarray(js_c))


def test_emit_contrib_and_idf_match_jax():
    rng = np.random.RandomState(4)
    tf = rng.randint(1, 9, 300).astype(np.float32)
    dl = rng.randint(1, 200, 300).astype(np.float32)
    a = jsim.emit_contrib("bm25", jnp.asarray(tf), jnp.asarray(dl), 1.7, 33.0,
                          1.2, 0.75, 0.0)
    b = tsim.emit_contrib("bm25", torch.from_numpy(tf), torch.from_numpy(dl),
                          1.7, 33.0, 1.2, 0.75)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for df, n in ((1, 10), (37, 1000), (999, 1000)):
        assert ts.bm25_idf(df, n) == js.bm25_idf(df, n)
        stats = {"df": df, "doc_count": n, "boost": 2.0, "ttf": 0,
                 "sum_ttf": 0, "avgdl": 5.0}
        assert tsim.BM25Similarity().lane_params(stats) == \
            jsim.BM25Similarity().lane_params(stats)


def test_select_topk_ties_by_ascending_doc():
    scores = np.array([1.0, 3.0, 3.0, 0.5, 3.0, 2.0, 3.0, 0.0], np.float32)
    matched = np.array([1, 1, 1, 1, 0, 1, 1, 0], bool)
    live1 = np.ones(8, bool)
    for k in (1, 3, 5, 8, 20):
        jsc, jd = js.select_topk(jnp.asarray(scores), jnp.asarray(matched),
                                 jnp.asarray(live1), k)
        tsc, td = ts.select_topk(torch.from_numpy(scores),
                                 torch.from_numpy(matched),
                                 torch.from_numpy(live1), k)
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        real = np.asarray(jsc) > -np.inf
        np.testing.assert_array_equal(td.numpy()[real], np.asarray(jd)[real])


def test_combine_should_and_count_matches_match_jax():
    rng = np.random.RandomState(5)
    ss = [rng.rand(64).astype(np.float32) for _ in range(3)]
    ms = [rng.rand(64) > 0.5 for _ in range(3)]
    live = rng.rand(64) > 0.1
    jt, jm = js.combine_should([jnp.asarray(s) for s in ss],
                               [jnp.asarray(m) for m in ms], 2.0)
    tt, tm = ts.combine_should([torch.from_numpy(s) for s in ss],
                               [torch.from_numpy(m) for m in ms], 2.0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert ts.count_matches(torch.from_numpy(ms[0]), torch.from_numpy(live)) \
        == int(js.count_matches(jnp.asarray(ms[0]), jnp.asarray(live)))
