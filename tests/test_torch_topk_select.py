"""The fused top-k kernels' selection and launch plan, on the CPU.

Three layers:

- ``topk_cluster_plan`` (``ops/tile_scoring.py``), which splits a launch
  of the top-k tile kernel or kernel 3 into clusters of bands: its bands
  cover the tile, C is a power of two <= 16 that shrinks as k grows (1 at
  k = W), a CTA's shared memory stays within the budget and equals the
  sizes the CUDA sources compute (their constants are read from the
  sources, their formulas restated here), and the main path's shapes fill
  the card (128 CTAs for 8 tiles of 16,384 docs at Q = 1, 256 for a
  262,144-doc kNN slot);
- a numpy model of ``csrc/block_topk.cuh`` (a band's warp top-k for k <=
  32, whose lane-maxima bound never drops a true candidate, or its radix
  select above, then the cluster merge of the bands' candidates) equals
  ``scoring.top_k``
  on hypothesis-drawn rows full of ties, -0.0 beside +0.0, -inf, and
  fewer candidates than k, for k in {1, 10, 16, 100, W};
- tie-heavy inputs through the port (its plain versions, on the CPU) and
  the JAX package (the Pallas kernels in interpret mode): the top-k tile
  kernel over equal frac and equal weights (all rows and sel mode with
  zeroed rows, raw and packed) and kernel 3 over duplicated embedding
  rows (cosine and dot_product). Ids and hit counts exact; scores within
  the parity tests' tolerances (rtol 1e-5 for the tile kernel, the JAX
  kernel's bf16 split; ``1e-6 + 1e-6 * sum_j |x_j q_j| * scale`` for
  kernel 3, the f32 reordering bound).
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from elasticsearch_tpu.ops import pallas_knn as jkn
from elasticsearch_tpu.ops import pallas_scoring as jps
from elasticsearch_tpu_torch.ops import knn_scoring as tkn
from elasticsearch_tpu_torch.ops import tile_scoring as tts
from elasticsearch_tpu_torch.ops.scoring import top_k

LANE = 128
RTOL = 1e-5
CSRC = os.path.join(os.path.dirname(tts.__file__), os.pardir, "csrc")


# ----------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------

PLAN_CASES = [
    # (kind, sub, q_batch, k, n_tiles, width)
    ("tile", 128, 1, 10, 8, 4), ("tile", 128, 1, 16, 64, 4),
    ("tile", 128, 16, 16, 64, 64), ("tile", 128, 16, 100, 8, 32),
    ("tile", 128, 3, 1000, 8, 8), ("tile", 128, 1, 16384, 8, 8),
    ("tile", 32, 2, 16, 16, 8), ("tile", 1, 1, 10, 2, 4),
    ("tile", 4, 16, 512, 3, 16), ("knn", 64, 1, 10, 32, 128),
    ("knn", 64, 1, 100, 32, 128), ("knn", 64, 16, 10, 32, 128),
    ("knn", 64, 16, 16, 128, 128), ("knn", 64, 1, 8192, 32, 128),
    ("knn", 16, 4, 16, 128, 768), ("knn", 8, 40, 10, 2, 1024),
    ("knn", 1, 1, 10, 1, 128),
]


def _width_kw(kind, width):
    return {"t_pad": width} if kind == "tile" else {"d_pad": width}


@pytest.mark.parametrize("kind,sub,q,k,n_tiles,width", PLAN_CASES)
def test_plan_invariants(kind, sub, q, k, n_tiles, width):
    p = tts.topk_cluster_plan(kind, sub, q, k, n_tiles,
                              **_width_kw(kind, width))
    w = sub * LANE
    kk = min(k, w)
    assert p.cluster in (1, 2, 4, 8, 16)
    assert p.cluster * p.band_docs == w and p.cluster <= sub
    groups = -(-q // p.group)
    assert 1 <= p.group <= tts.TOPK_MAX_GROUP[kind]
    assert p.blocks == n_tiles * groups * p.cluster
    assert p.smem <= tts.H100_BLOCK_SMEM_OPTIN
    if p.cluster > 1:
        assert kk <= p.band_docs // 2  # a band keeps at most half its docs
    if kind == "tile":
        assert p.smem == tts.topk_tile_smem(p.cluster, p.group, kk, sub,
                                            width)
    else:
        assert p.smem == tts.topk_knn_smem(p.cluster, p.group, kk, sub,
                                           width)


@pytest.mark.parametrize("kind,sub,n_tiles,width", [
    ("tile", 128, 8, 4), ("tile", 32, 16, 8), ("knn", 64, 32, 128),
    ("knn", 64, 128, 128)])
def test_cluster_shrinks_as_k_grows(kind, sub, n_tiles, width):
    w = sub * LANE
    ks = sorted({1, 10, 16, 100, 257, 1000, w // 4, w // 2, w - 1, w})
    sizes = [tts.topk_cluster_plan(kind, sub, 1, k, n_tiles,
                                   **_width_kw(kind, width)).cluster
             for k in ks if k <= w]
    assert sizes == sorted(sizes, reverse=True)
    assert sizes[-1] == 1  # k = W: one CTA holds the whole tile


def test_main_path_shapes_fill_the_card():
    # the pruned program: 8 tiles of 16,384 docs a pass, Q = 1
    for k in (10, 16):
        p = tts.topk_cluster_plan("tile", 128, 1, k, 8, t_pad=4)
        assert p.blocks >= 128, p
    # the kNN rung: one 262,144-doc slot (32 tiles of 8,192 docs)
    sub = tkn.knn_geometry(262144, 128).tile_sub
    p = tts.topk_cluster_plan("knn", sub, 1, 10, 262144 // (sub * LANE),
                              d_pad=128)
    assert p.blocks >= 256, p
    # k = 100: rank 0 merges at most TOPK_MERGE_CANDIDATES a query
    p = tts.topk_cluster_plan("knn", sub, 1, 100, 32, d_pad=128)
    assert p.cluster * 100 <= tts.TOPK_MERGE_CANDIDATES and p.blocks >= 128
    # at Q = 16 every embedding row is read once for the whole batch
    p = tts.topk_cluster_plan("knn", sub, 16, 10, 32, d_pad=128)
    assert p.group == 16


def test_plan_asks_the_card_and_refuses_what_nothing_fits():
    asked = []

    def no_16(c, g, smem):
        asked.append((c, g, smem))
        return c < 16

    p = tts.topk_cluster_plan("tile", 128, 1, 10, 8, t_pad=4,
                              schedulable=no_16)
    assert p.cluster == 8 and (16, 1, tts.topk_tile_smem(16, 1, 10, 128, 4)) \
        in asked
    with pytest.raises(ValueError):
        tts.topk_cluster_plan("knn", 64, 1, 10, 32, d_pad=128,
                              schedulable=lambda c, g, s: False)
    with pytest.raises(ValueError):
        tts.topk_cluster_plan("tile", 128, 1, 10, 8, t_pad=4,
                              smem_bytes=8 * 1024)
    with pytest.raises(ValueError):
        tts.topk_cluster_plan("other", 128, 1, 10, 8)
    assert tts.topk_cluster_plan("tile", 128, 1, 10, 8, t_pad=4,
                                 clusters=(2,)).cluster == 2


def _constexprs(path):
    """The ``constexpr int`` constants of a CUDA source, evaluated."""
    env = {}
    with open(path) as f:
        for name, expr in re.findall(
                r"constexpr int (k\w+) = ([^;]+);", f.read()):
            expr = expr.split("//")[0]
            try:
                env[name] = int(eval(expr, {}, dict(env)))
            except (NameError, SyntaxError):
                pass
    return env


def test_smem_mirrors_match_the_cuda_sources():
    sel = _constexprs(os.path.join(CSRC, "block_topk.cuh"))
    knn = _constexprs(os.path.join(CSRC, "knn_scoring.cu"))
    knn["kSelectThreads"] = sel["kSelectThreads"]
    knn = {**knn, **_constexprs(os.path.join(CSRC, "knn_scoring.cu"))}
    assert sel["kSelectWords"] == tts.SELECT_WORDS
    assert sel["kSelectThreads"] == tts.SELECT_THREADS
    assert sel["kMaxCluster"] == max(tts.TOPK_CLUSTERS)
    assert sel["kWarpK"] == tts.WARP_K
    assert sel["kWarpSegment"] == 1024  # model_warp_select's min_segment
    assert knn["kRingWords"] == tts.KNN_RING_WORDS
    assert knn["kMaxGroup"] == tts.TOPK_MAX_GROUP["knn"]

    # topk_select_words / topk_smem_words / knn_smem_words, restated
    def a4(x):
        return (x + 3) & ~3

    def select_words(c, g, k, band):
        kp = min(k, band)
        p = 1
        while p < kp:
            p *= 2
        warp_k = sel["kWarpK"]
        lists = (2 * warp_k * (g + 4 * sel["kSelectWarps"]) if kp <= warp_k
                 else p)
        return (a4(2 * g * c * kp if c > 1 else 0) + a4(lists)
                + a4(sel["kSelectWords"] + 2 * g + 2 * g * c))

    for c in (1, 2, 4, 8, 16):
        for g in (1, 3, 16):
            for k in (1, 10, 100, 4096):
                for sub, t_pad in ((16, 4), (128, 64)):
                    s = sub // c
                    pad = 0 if s < 4 else (32 // s if s <= 32 else 1)
                    dense = (s * LANE + g * s * (LANE + pad) + g * t_pad
                             + 8 * t_pad + 3)
                    assert tts.topk_tile_smem(c, g, k, sub, t_pad) == 4 * (
                        select_words(c, g, k, s * LANE) + dense)
                for sub, d_pad in ((16, 768), (64, 128)):
                    band = sub * LANE // c
                    assert tts.topk_knn_smem(c, g, k, sub, d_pad) == 4 * (
                        select_words(c, g, k, band) + knn["kRingWords"]
                        + g * d_pad + g * band)


# ----------------------------------------------------------------------
# A numpy model of block_topk.cuh
# ----------------------------------------------------------------------


def score_key(v):
    """block_topk.cuh's score_key: order-keeping u32, -0.0 folded into
    +0.0, 0 for -inf and NaN."""
    v = np.asarray(v, np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    u = np.where(v == 0.0, 0, u)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(v > -np.inf, key, 0).astype(np.uint64)


def key_score(key):
    key = np.asarray(key, np.uint64)
    u = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return u.astype(np.uint32).view(np.float32)


def model_band_select(keys, k):
    """band_select: the radix select over the key's bytes (a histogram a
    digit, stopping once a bin is taken whole), the compaction of the keys
    above T and the lowest-index keys equal to T, then the sort by (key
    desc, index asc). Returns the sorted band-local indices."""
    keys = np.asarray(keys, np.uint64)
    valid = keys != 0
    need = min(k, int(valid.sum()))
    if need == 0:
        return np.zeros(0, np.int64)
    pref, tshift, take_eq, all_eq = 0, 32, need, False
    for shift in (24, 16, 8, 0):
        inside = valid if shift == 24 else valid & (
            (keys >> np.uint64(shift + 8)) == pref)
        digits = ((keys[inside] >> np.uint64(shift)) & 0xFF).astype(np.int64)
        hist = np.bincount(digits, minlength=256)
        above = 0
        for b in range(255, -1, -1):
            if above + hist[b] >= take_eq:
                break
            above += hist[b]
        pref = (pref << 8) | b
        take_eq -= above
        tshift = shift
        all_eq = hist[b] == take_eq
        if all_eq:
            break
    hi = keys >> np.uint64(tshift)
    gt = np.nonzero(valid & (hi > pref))[0]
    eq = np.nonzero(valid & (hi == pref))[0]
    chosen = np.concatenate([gt, eq if all_eq else eq[:take_eq]])
    assert len(chosen) == need
    order = np.lexsort((chosen, -keys[chosen].astype(np.float64)))
    return chosen[order]


def model_warp_topk(words, k):
    """warp_topk: the k-th largest of the 32 lanes' maxima (lane l holding
    words l, l + 32, ...) bounds the k-th largest word from below; the
    words at or above it, in order, merge 32 at a time into the sorted
    slots. Returns the k slots (0 = empty)."""
    lane_max = [max(words[lane::32], default=0) for lane in range(32)]
    nonzero = sorted((w for w in lane_max if w), reverse=True)
    cut = nonzero[k - 1] if len(nonzero) >= k else 0
    # the bound never drops a true top-k word
    true_top = sorted((w for w in words if w), reverse=True)[:k]
    assert all(w >= cut for w in true_top)
    slots, thr, buf = [], cut - 1 if cut else 0, []
    for r in range(0, len(words), 32):
        buf += [w for w in words[r: r + 32] if w > thr]
        while len(buf) >= 32 or (r + 32 >= len(words) and buf):
            batch, buf = buf[:32], buf[32:]
            slots = sorted(slots + batch, reverse=True)[:k]
            if len(slots) == k:
                thr = max(thr, slots[-1])
    return slots + [0] * (k - len(slots))


def model_warp_select(keys, k, gn=1, min_segment=1024):
    """warp_select for one query: the band splits into segments of at
    least ``min_segment`` words (block_topk.cuh kWarpSegment), as many as
    fill 8 warps; a warp's warp_topk each, then one warp takes the top-k
    of the segments' lists. Returns the sorted band-local indices."""
    n = len(keys)
    nseg = 1
    while 2 * nseg * gn <= 8 and n // (2 * nseg) >= min_segment:
        nseg *= 2
    seg = -(-n // nseg)
    lists = []
    for u in range(nseg):
        words = [(int(keys[b]) << 32) | (~b & 0xFFFFFFFF) if keys[b] else 0
                 for b in range(u * seg, min(n, (u + 1) * seg))]
        lists += model_warp_topk(words, k) + [0] * (32 - k)
    out = model_warp_topk(lists, k) if nseg > 1 else lists[:k]
    return np.array([~w & 0xFFFFFFFF for w in out if w], np.int64)


def model_select(values, k, cluster):
    """The kernels' selection of one row of W scores split into
    ``cluster`` bands: each band's top-min(k, D) (the warp path up to 32,
    the radix select above), then rank 0's merge: the warp path over the
    gathered lists up to 32; above it, each candidate placed at its own
    rank plus the candidates of the other bands that beat it. Returns
    (scores [k], docs [k]), empty -inf / -1."""
    values = np.asarray(values, np.float32)
    w = len(values)
    d = w // cluster
    keys = score_key(values)
    lists = []
    for c in range(cluster):
        band = keys[c * d:(c + 1) * d]
        kp = min(k, d)
        idx = (model_warp_select(band, kp) if kp <= 32
               else model_band_select(band, kp)) + c * d
        # (key, ~doc) words: key descending, then doc ascending
        lists.append([(int(keys[i]) << 32) | (~int(i) & 0xFFFFFFFF)
                      for i in idx])
    out_s = np.full(k, -np.inf, np.float32)
    out_d = np.full(k, -1, np.int64)
    kp = min(k, d)
    if cluster > 1 and kp <= 32:
        # rank 0 runs the warp path over the gathered [C][k'] words
        gathered = [w for lst in lists for w in lst + [0] * (kp - len(lst))]
        merged = model_warp_topk(gathered, k)
        for rank, word in enumerate(w for w in merged if w):
            out_s[rank] = key_score(word >> 32)
            out_d[rank] = ~word & 0xFFFFFFFF
        return out_s, out_d
    for c, lst in enumerate(lists):
        for j, word in enumerate(lst):
            rank = j + sum(sum(1 for o in other if o > word)
                           for oc, other in enumerate(lists) if oc != c)
            if rank < k:
                out_s[rank] = key_score(word >> 32)
                out_d[rank] = ~word & 0xFFFFFFFF
    return out_s, out_d


def reference_select(values, k):
    """scoring.top_k with the kernels' empty slots."""
    vals, idx = top_k(torch.from_numpy(np.asarray(values, np.float32)), k)
    vals, idx = vals.numpy(), idx.numpy()
    idx = np.where(vals == -np.inf, -1, idx)
    return vals, idx


@st.composite
def tie_rows(draw):
    """Rows of W = 512 scores drawn from a few levels: +-0.0, -inf,
    negatives, many repeats; sometimes almost all -inf."""
    levels = draw(st.lists(st.sampled_from(
        [0.0, -0.0, -np.inf, 1.0, 2.5, -3.0, 0.5, 7.25, 1e-30, -1e30]),
        min_size=1, max_size=6))
    w = 512
    n_live = draw(st.sampled_from([0, 1, 5, 17, 200, w]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.RandomState(seed)
    row = np.full(w, -np.inf, np.float32)
    at = rng.choice(w, n_live, replace=False)
    row[at] = np.asarray(levels, np.float32)[rng.randint(0, len(levels),
                                                         n_live)]
    return row


@settings(max_examples=40, deadline=None)
@given(row=tie_rows(), k=st.sampled_from([1, 10, 16, 100, 512]),
       cluster=st.sampled_from([1, 2, 4, 8, 16]))
def test_model_equals_top_k(row, k, cluster):
    got_s, got_d = model_select(row, k, cluster)
    want_s, want_d = reference_select(row, k)
    np.testing.assert_array_equal(got_s, want_s)  # -0.0 == +0.0 here
    np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("k,cluster", [(1, 1), (10, 1), (32, 2), (16, 4)])
def test_model_splits_long_bands(k, cluster):
    """Bands of 4,096 and 2,048 words split into 1,024-word segments a
    warp, whose lists merge in a second warp pass."""
    rng = np.random.RandomState(k)
    row = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0, -1.0, -np.inf]),
                     4096).astype(np.float32)
    row[rng.randint(4096, size=40)] = np.float32(3.0)  # ties at the top
    got_s, got_d = model_select(row, k, cluster)
    want_s, want_d = reference_select(row, k)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_d, want_d)


def test_model_on_one_distinct_value_and_all_inf():
    w = 1024
    for cluster in (1, 4, 16):
        for k in (1, 10, 16, 100, w):
            row = np.full(w, 3.0, np.float32)
            s, d = model_select(row, k, cluster)
            assert (d == np.arange(k)).all() and (s == 3.0).all()
            s, d = model_select(np.full(w, -np.inf, np.float32), k, cluster)
            assert (d == -1).all() and (s == -np.inf).all()
    # -0.0 and +0.0 tie: the lower doc first, whichever sign it has
    row = np.full(256, -np.inf, np.float32)
    row[[3, 9, 40]] = [0.0, -0.0, 0.0]
    _s, d = model_select(row, 2, 2)
    assert d.tolist() == [3, 9]


# ----------------------------------------------------------------------
# Tie-heavy kernel inputs, the port against the JAX package
# ----------------------------------------------------------------------


def tie_postings(nd_pad=2048, seed=7):
    """Four terms (every other doc, every third, a random quarter, a run
    across the middle), every frac 1.0; 5 % of the docs deleted."""
    rng = np.random.RandomState(seed)
    terms = [np.arange(0, nd_pad, 2), np.arange(0, nd_pad, 3),
             rng.choice(nd_pad, nd_pad // 4, replace=False),
             np.arange(nd_pad // 2 - 300, nd_pad // 2 + 300)]
    bd, bf, starts, counts = [], [], [], []
    for docs in terms:
        docs = np.unique(docs).astype(np.int32)
        starts.append(len(bd))
        counts.append(-(-len(docs) // LANE))
        for i in range(0, len(docs), LANE):
            d = np.full(LANE, nd_pad, np.int32)
            f = np.zeros(LANE, np.float32)
            chunk = docs[i: i + LANE]
            d[: len(chunk)] = chunk
            f[: len(chunk)] = 1.0
            bd.append(d)
            bf.append(f)
    live = (rng.rand(nd_pad) >= 0.05).astype(np.float32)
    return np.stack(bd), np.stack(bf), starts, counts, live


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# (q_batch, k, tile sub); k None is k = W, on 128-doc tiles
TIE_CASES = [(1, 1, 4), (2, 10, 4), (3, 16, 4), (1, 100, 4), (2, None, 1)]


@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("q,k,sub", TIE_CASES)
def test_tile_topk_ties_match_jax(codec, q, k, sub):
    bd, bf, starts, counts, live = tie_postings()
    nd_pad = 2048
    geom = tts.tile_geometry(nd_pad, sub)
    k = k or geom.tile_w
    bmin, bmax = tts.block_min_max(bd, bf, nd_pad)
    members = [[0, 1, 2, 3], [0, 1], [2, 3]]
    sets = [[tts.QueryLane(starts[t], counts[t], 1.0) for t in members[i]]
            for i in range(q)]
    rl, rh, wts, cb = tts.build_tile_tables_batched(sets, bmin, bmax, geom)
    if codec == "packed":
        corpus = (tts.pack_segment_blocks(bd, bf, nd_pad), None)
    else:
        corpus = tts.pad_segment_blocks(bd, bf, nd_pad)
    lt = tts.build_live_t(live, geom)
    kw = dict(t_pad=wts.shape[1], cb=cb, sub=geom.tile_sub, k=k, q_batch=q,
              codec=codec)
    sel = np.random.RandomState(q).permutation(geom.n_tiles).astype(np.int32)
    zero = np.arange(geom.n_tiles) % 4 == 1
    rls = np.where(zero[:, None], 0, rl[sel])
    rhs = np.where(zero[:, None], 0, rh[sel])
    for rows_lo, rows_hi, tid in ((rl, rh, None), (rls, rhs, sel)):
        extra = {} if tid is None else {"tile_ids": tid}
        js, jd, jh = (np.asarray(o) for o in jps.score_tiles(
            *[_j(x) for x in (*corpus, lt, rows_lo, rows_hi, wts)],
            interpret=True, **{**kw, **{a: _j(b) for a, b in extra.items()}}))
        ts_, td, th = (o.numpy() for o in tts.score_tiles(
            *[_t(x) for x in (*corpus, lt, rows_lo, rows_hi, wts)],
            **{**kw, **{a: _t(b) for a, b in extra.items()}}))
        kk = min(k, geom.tile_w)
        assert ts_.shape == js.shape == (geom.n_tiles, q, kk)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_allclose(ts_, js, rtol=RTOL, atol=1e-7)
        # ties are the point: some score repeats within a row
        fin = ts_[np.isfinite(ts_)]
        assert len(np.unique(fin)) < len(fin)
        if tid is not None:
            assert (td[zero] == -1).all() and (th[zero] == 0).all()


@pytest.mark.parametrize("metric", ["cosine", "dot_product"])
@pytest.mark.parametrize("q,k,sub", TIE_CASES)
def test_knn_ties_match_jax(metric, q, k, sub):
    rng = np.random.RandomState(3)
    nd_space, dims = 1024, 24
    k = k or sub * LANE
    d_pad = tkn.pad_dims(dims)
    base = jkn.bf16_round(rng.randn(12, dims))
    vecs = base[rng.randint(0, len(base), nd_space)]  # duplicated rows
    n_rows = nd_space - 100  # a dead tail
    mask = np.ones(nd_space, np.float32)
    mask[::29] = 0.0
    mask[n_rows:] = 0.0
    emb = np.zeros((nd_space, d_pad), np.float32)
    emb[:n_rows, :dims] = vecs[:n_rows]
    scale = jkn.vector_scale_column(vecs, metric)[:, 0].astype(np.float32)
    qmat = np.stack([tkn.normalize_query(base[i] + 0.1 * rng.randn(dims),
                                         metric, d_pad) for i in range(q)])
    js, jd = jkn.knn_score_tiles(
        jnp.asarray(emb, jnp.bfloat16), jnp.asarray(scale.reshape(-1, 1)),
        jnp.asarray(mask.reshape(-1, 1)), jnp.asarray(qmat), sub=sub, k=k,
        q_batch=q, interpret=True)
    js = np.asarray(js).transpose(0, 2, 1)
    jd = np.asarray(jd).transpose(0, 2, 1)
    ts_, td = (o.numpy() for o in tkn.knn_score_tiles(
        torch.from_numpy(emb[:n_rows]).to(torch.bfloat16),
        torch.from_numpy(scale) if metric == "cosine" else None,
        torch.from_numpy(mask), torch.from_numpy(qmat), sub=sub, k=k,
        q_batch=q, n_rows=n_rows))
    np.testing.assert_array_equal(td, jd)
    fin = np.isfinite(js)
    assert (np.isfinite(ts_) == fin).all()
    # the f32 reordering bound, per doc
    docs = np.where(td >= 0, td, 0)
    prods = np.abs(emb[docs][..., :d_pad] * qmat[None, :, None, :]).sum(-1)
    sc = scale[docs] if metric == "cosine" else 1.0
    tol = 1e-6 + 1e-6 * prods * sc
    assert (np.abs(ts_[fin] - js[fin]) <= tol[fin]).all()
    vals = ts_[fin]
    assert len(np.unique(vals)) < len(vals)  # duplicated rows tie
