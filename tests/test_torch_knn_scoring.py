"""Parity of the port's kNN module (kernel 3's plain version and its host
helpers) with the JAX package's ``ops/pallas_knn.py``.

The same seeded numpy inputs go through the JAX ``knn_score_tiles`` (the
Pallas kernel in interpret mode, as tests/test_knn.py runs it) and the
port's ``knn_score_tiles`` on the CPU (its plain version). Tolerance, per
doc: ``tol = 1e-6 + 1e-6 * sum_j |x_j * q_j| * scale`` (scale = 1 for
dot_product), the f32 reordering bound for these widths: the JAX kernel
sums the dot in XLA's order, the port in ascending ``j``. Docs are exact
except among candidates whose JAX scores tie within that tolerance.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import pallas_knn as jkn
from elasticsearch_tpu_torch.ops import knn_scoring as tkn

LANE = 128


def make_case(seed, nd, dims, metric, n_rows=None, nd_space=None,
              dead_tile=None, sub=1):
    """Seeded inputs for both packages: bf16-grid vectors (every 13th doc
    without one, every 17th deleted), the metric's scale column, the mask
    over a doc space of ``nd_space`` docs (a power of two)."""
    rng = np.random.RandomState(seed)
    nd_space = nd_space or tkn.LANE * 8
    d_pad = tkn.pad_dims(dims)
    vecs = jkn.bf16_round(rng.randn(nd, dims))
    has = np.ones(nd, bool)
    has[::13] = False
    vecs[~has] = 0.0
    live = np.ones(nd, bool)
    live[5::17] = False
    n_rows = nd if n_rows is None else n_rows
    emb = np.zeros((nd_space, d_pad), np.float32)
    emb[:n_rows, :dims] = vecs[:n_rows]
    scale = np.zeros(nd_space, np.float32)
    scale[:nd] = jkn.vector_scale_column(vecs, metric)[:, 0]
    mask = np.zeros(nd_space, np.float32)
    mask[:n_rows] = (has & live)[:n_rows]
    if dead_tile is not None:
        w = sub * LANE
        mask[dead_tile * w:(dead_tile + 1) * w] = 0.0
    return dict(vecs=vecs, emb=emb, scale=scale, mask=mask, d_pad=d_pad,
                n_rows=n_rows, rng=rng, sub=sub, metric=metric)


def queries(case, q_real, q_pad, zero=False):
    rng = case["rng"]
    dims = case["vecs"].shape[1]
    raw = [np.zeros(dims, np.float32) if zero
           else rng.randn(dims).astype(np.float32) for _ in range(q_real)]
    rows = [tkn.normalize_query(q, case["metric"], case["d_pad"])
            for q in raw]
    rows += [np.zeros(case["d_pad"], np.float32)] * (q_pad - q_real)
    return np.stack(rows).astype(np.float32)


def run_jax(case, qmat, k):
    ts, td = jkn.knn_score_tiles(
        jnp.asarray(case["emb"], jnp.bfloat16),
        jnp.asarray(case["scale"].reshape(-1, 1)),
        jnp.asarray(case["mask"].reshape(-1, 1)), jnp.asarray(qmat),
        sub=case["sub"], k=k, q_batch=qmat.shape[0], interpret=True)
    # [n_tiles, k, Q] -> the port's [n_tiles, Q, k]
    return (np.asarray(ts).transpose(0, 2, 1),
            np.asarray(td).transpose(0, 2, 1))


def run_port(case, qmat, k):
    emb = torch.from_numpy(case["emb"][: case["n_rows"]]).to(torch.bfloat16)
    scale = (torch.from_numpy(case["scale"]) if case["metric"] == "cosine"
             else None)
    ts, td = tkn.knn_score_tiles(
        emb, scale, torch.from_numpy(case["mask"]), torch.from_numpy(qmat),
        sub=case["sub"], k=k, q_batch=qmat.shape[0],
        n_rows=case["n_rows"])
    return ts.numpy(), td.numpy()


def doc_tol(case, qrow, docs):
    """tol per doc id (-1 = empty slot: exact)."""
    x = case["emb"][np.maximum(docs, 0)].astype(np.float64)
    s = np.abs(x * qrow.astype(np.float64)).sum(axis=-1)
    if case["metric"] == "cosine":
        s = s * case["scale"][np.maximum(docs, 0)]
    return np.where(docs >= 0, 1e-6 + 1e-6 * s, 0.0)


def assert_same_candidates(case, qmat, jax_out, port_out):
    js, jd = jax_out
    ts, td = port_out
    assert ts.shape == js.shape and td.shape == jd.shape
    n_tiles, q_batch, k = js.shape
    for t in range(n_tiles):
        for q in range(q_batch):
            j_s, j_d, t_s, t_d = js[t, q], jd[t, q], ts[t, q], td[t, q]
            np.testing.assert_array_equal(t_d < 0, j_d < 0)
            np.testing.assert_array_equal(np.isinf(t_s), np.isinf(j_s))
            tol = doc_tol(case, qmat[q], j_d)
            fin = np.isfinite(j_s)
            assert np.all(np.abs(t_s[fin] - j_s[fin]) <= tol[fin]), \
                (t, q, t_s, j_s)
            # docs: exact except inside groups of JAX scores tied within
            # tol; a group that meets the cut at k may hold other docs
            n_fin = int(fin.sum())
            i = 0
            while i < n_fin:
                j = i + 1
                while j < n_fin and abs(j_s[j] - j_s[i]) <= max(tol[i],
                                                                 tol[j]):
                    j += 1
                if j < n_fin or n_fin < k:
                    assert set(t_d[i:j]) == set(j_d[i:j]), (t, q, i, j)
                else:
                    assert all(abs(t_s[r] - j_s[i]) <= 2 * tol[i]
                               for r in range(i, j)), (t, q, i, j)
                i = j


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("q_real,q_pad", [(1, 1), (3, 4)])
@pytest.mark.parametrize("dims", [20, 200])
@pytest.mark.parametrize("metric", ["cosine", "dot_product"])
def test_plain_matches_jax_kernel(metric, dims, q_real, q_pad, k):
    case = make_case(dims + q_pad + k, 700, dims, metric)
    qmat = queries(case, q_real, q_pad)
    assert_same_candidates(case, qmat, run_jax(case, qmat, k),
                           run_port(case, qmat, k))


@pytest.mark.parametrize("metric", ["cosine", "dot_product"])
def test_zero_norm_query_ties_take_the_lowest_docs(metric):
    """A zero query scores every live vector doc 0.5: the whole result is
    ties, resolved to the lowest docs of each tile, then tile-major."""
    case = make_case(4, 700, 20, metric)
    qmat = queries(case, 2, 2, zero=True)
    js, jd = run_jax(case, qmat, 10)
    ts, td = run_port(case, qmat, 10)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ts, js)
    assert set(ts[np.isfinite(ts)].tolist()) == {0.5}
    ms, md = tkn.merge_knn_topk(torch.from_numpy(ts), torch.from_numpy(td),
                                10)
    jms, jmd = jkn.merge_knn_topk(jnp.asarray(js.transpose(0, 2, 1)),
                                  jnp.asarray(jd.transpose(0, 2, 1)), 10)
    np.testing.assert_array_equal(md.numpy(), np.asarray(jmd))
    live = np.flatnonzero(case["mask"] > 0)
    assert md.numpy()[0].tolist() == live[:10].tolist()


@pytest.mark.parametrize("n_rows", [300, 511, 640])
def test_rows_beyond_n_rows_are_dead(n_rows):
    """The slot of a smaller segment in a larger shared geometry: the port
    reads only n_rows rows of its embeddings; JAX sees zeros and a zero
    mask there."""
    case = make_case(7, 700, 20, "cosine", n_rows=n_rows)
    qmat = queries(case, 3, 4)
    port = run_port(case, qmat, 10)
    assert_same_candidates(case, qmat, run_jax(case, qmat, 10), port)
    assert port[1].max() < n_rows


def test_all_dead_tile_and_k_beyond_live_docs():
    """A tile with no live doc gives only empty slots; a k larger than a
    tile's live docs pads with (-inf, -1)."""
    case = make_case(9, 700, 20, "dot_product", dead_tile=2, sub=1)
    case["mask"][3 * LANE + 5: 4 * LANE] = 0.0  # tile 3: 5 live docs at most
    qmat = queries(case, 1, 1)
    js, jd = run_jax(case, qmat, 16)
    ts, td = run_port(case, qmat, 16)
    assert (td[2] == -1).all() and np.isneginf(ts[2]).all()
    assert (td[3] >= 0).sum() <= 5 and (td[3, 0, 5:] == -1).all()
    assert_same_candidates(case, qmat, (js, jd), (ts, td))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_knn_topk_equals_jax(seed):
    """The merge pools tile-major per query and keeps lax.top_k's tie
    order; many equal scores and empty slots make ties decide."""
    rng = np.random.RandomState(seed)
    n_tiles, q, kk = 6, 3, 8
    s = rng.randint(0, 4, (n_tiles, q, kk)).astype(np.float32) / 4
    s = -np.sort(-s, axis=2)
    d = rng.randint(0, 5000, (n_tiles, q, kk)).astype(np.int32)
    s[1, :, 5:] = -np.inf
    d[1, :, 5:] = -1
    for k in (1, 8, 20, 48, 60):
        ts, td = tkn.merge_knn_topk(torch.from_numpy(s), torch.from_numpy(d),
                                    k)
        js, jd = jkn.merge_knn_topk(jnp.asarray(s.transpose(0, 2, 1)),
                                    jnp.asarray(d.transpose(0, 2, 1)), k)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


BF16_INPUTS = {
    "random": lambda rng: rng.randn(4096).astype(np.float32),
    "subnormal": lambda rng: (rng.randn(4096) * 1e-39).astype(np.float32),
    "large": lambda rng: np.concatenate([
        (rng.randn(4096) * 1e38).astype(np.float32),
        np.array([3.4028235e38, -3.4028235e38, 3.39e38, 1e-45, -1e-45, 0.0,
                  -0.0, np.inf, -np.inf], np.float32)]),
    "halfway": lambda rng: (
        (rng.randint(0, 1 << 16, 4096).astype(np.uint32) << 16)
        | np.uint32(0x8000)).view(np.float32),
}


@pytest.mark.parametrize("name", sorted(BF16_INPUTS))
def test_bf16_round_bit_equal_to_ml_dtypes(name):
    with np.errstate(over="ignore"):  # "large" casts past f32 max to inf
        x = BF16_INPUTS[name](np.random.RandomState(3))
    # NaN payloads are not compared: the mapper rejects non-finite vectors
    x = x[~np.isnan(x)]
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = tkn.bf16_round(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dims", [1, 20, 128, 129, 768, 1024])
def test_host_helpers_equal_jax(dims):
    rng = np.random.RandomState(dims)
    assert tkn.pad_dims(dims) == jkn.pad_dims(dims)
    d_pad = tkn.pad_dims(dims)
    for nd_pad in (128, 4096, 1 << 20):
        for pref in (8, 64, 128, 7):
            assert tkn.knn_tile_sub(nd_pad, d_pad, pref) == \
                jkn.knn_tile_sub(nd_pad, d_pad, pref)
            assert tuple(tkn.knn_geometry(nd_pad, d_pad, pref)) == \
                tuple(jkn.knn_geometry(nd_pad, d_pad, pref))
    vecs = jkn.bf16_round(rng.randn(50, dims))
    vecs[3] = 0.0
    for metric in ("cosine", "dot_product"):
        np.testing.assert_array_equal(
            tkn.vector_scale_column(vecs, metric),
            jkn.vector_scale_column(vecs, metric))
        for q in (rng.randn(dims), np.zeros(dims)):
            np.testing.assert_array_equal(
                tkn.normalize_query(q, metric, d_pad),
                jkn.normalize_query(q, metric, d_pad))
        mask = np.ones(50, bool)
        mask[::7] = False
        q = rng.randn(dims)
        for a, b in zip(tkn.reference_knn_topk(vecs, mask, q, 10, metric),
                        jkn.reference_knn_topk(vecs, mask, q, 10, metric)):
            np.testing.assert_array_equal(a, b)


def test_host_knn_scores_chunks_equal_one_product(monkeypatch):
    """The host rung's product converts row chunks into one buffer; the
    chunking changes no value (each row is its own dot)."""
    rng = np.random.RandomState(5)
    emb = torch.from_numpy(jkn.bf16_round(rng.randn(1000, 128))).to(
        torch.bfloat16)
    q = torch.from_numpy(rng.randn(128).astype(np.float32))
    whole = emb.float() @ q
    monkeypatch.setattr(tkn, "HOST_CHUNK_F32", 128 * 96)
    got = tkn.host_knn_scores(emb, q)
    assert got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_wrapper_rejects_bad_operands():
    emb = torch.zeros((256, 128), dtype=torch.bfloat16)
    mask = torch.ones(256)
    q = torch.zeros((1, 128))
    with pytest.raises(TypeError):
        tkn.knn_score_tiles(emb.float(), None, mask, q, sub=1)
    with pytest.raises(ValueError):
        tkn.knn_score_tiles(emb, None, torch.ones(200), q, sub=1)
    with pytest.raises(ValueError):
        tkn.knn_score_tiles(emb, None, mask, q, sub=1, n_rows=300)
    with pytest.raises(ValueError):
        tkn.knn_score_tiles(emb, None, mask, torch.zeros((2, 128)), sub=1)
    out = tkn.knn_score_tiles(emb, None, mask, q, sub=1, k=500)
    assert out[0].shape == (2, 1, 128)
