"""Parity of the PyTorch segment-sum module with the JAX Pallas kernel.

Seeded numpy inputs go through ``elasticsearch_tpu``'s
``segment_aggregate`` (interpret mode, as tests/test_pallas_aggs.py runs
it) and through ``elasticsearch_tpu_torch``'s plain version. Counts are
exact; sums agree within rtol 1e-4 / atol 1e-4 (the JAX kernel sums f32 in
chunk order through a two-pass bf16 split, the plain version sums with
``torch.bincount``).
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops.aggs import ordinal_counts as jax_ordinal_counts
from elasticsearch_tpu.ops.pallas_aggs import (
    CHUNK,
    reference_segment_aggregate,
    segment_aggregate as jax_segment_aggregate,
)
from elasticsearch_tpu_torch.ops import aggs as tagg
from elasticsearch_tpu_torch.ops.segment_sum import (
    segment_aggregate,
    segment_counts_sums,
)


def run_both(ords, mask, vals, n_ords):
    j = jax_segment_aggregate(
        jnp.asarray(ords), jnp.asarray(mask),
        None if vals is None else jnp.asarray(vals), n_ords=n_ords,
        with_sum=vals is not None, interpret=True)
    t = segment_aggregate(
        torch.from_numpy(ords), torch.from_numpy(mask),
        None if vals is None else torch.from_numpy(vals), n_ords=n_ords,
        with_sum=vals is not None)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def inputs(seed, nd, n_ords, special=False):
    rng = np.random.RandomState(seed)
    ords = rng.randint(-1, n_ords + 3, nd).astype(np.int32)
    mask = (rng.rand(nd) > 0.3).astype(np.float32)
    vals = (rng.randn(nd) * 10).astype(np.float32)
    if special and nd:
        idx = rng.choice(nd, min(nd, 12), replace=False)
        vals[idx[:3]] = np.nan
        vals[idx[3:6]] = np.inf
        vals[idx[6:9]] = -np.inf
        vals[idx[9:]] = np.float32(3e38)  # above bf16-max: clipped
    return ords, mask, vals


@pytest.mark.parametrize("nd,n_ords,special", [
    (7000, 500, False),          # padding not a multiple of CHUNK
    (CHUNK * 3, 300, False),     # an exact multiple of CHUNK
    (4099, 131, True),           # NaN / +-inf / > bf16-max sanitization
    (1500, 1000, False),         # n_ords not a power of two
    (0, 17, False),              # nd == 0
])
def test_plain_matches_jax_kernel(nd, n_ords, special):
    ords, mask, vals = inputs(nd + n_ords, nd, n_ords, special)
    (jc, jt), (tc, tt) = run_both(ords, mask, vals, n_ords)
    assert tc.shape == jc.shape == (n_ords,) and tc.dtype == np.float32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tt, jt, rtol=1e-4, atol=1e-4)
    (jc_only,), (tc_only,) = run_both(ords, mask, None, n_ords)
    np.testing.assert_array_equal(tc_only, jc_only)


def test_plain_matches_numpy_oracle():
    ords, mask, vals = inputs(9, 5000, 250)
    rc, rt = reference_segment_aggregate(ords, mask, vals, n_ords=250)
    count, total = segment_counts_sums(
        torch.from_numpy(ords), torch.from_numpy(mask),
        torch.from_numpy(vals), n_ords=250)
    assert count.dtype == torch.int32
    np.testing.assert_array_equal(count.numpy(), rc.astype(np.int32))
    np.testing.assert_allclose(total.numpy(), rt, rtol=1e-4, atol=1e-4)


def test_ordinal_counts_matches_jax():
    rng = np.random.RandomState(3)
    nd_pad, n_vals, n_ords = 1024, 900, 40
    flat_docs = np.full(1024, nd_pad, np.int32)
    flat_docs[:n_vals] = np.sort(rng.randint(0, nd_pad, n_vals))
    flat_ords = np.zeros(1024, np.int32)
    flat_ords[:n_vals] = rng.randint(0, n_ords, n_vals)
    mask = np.zeros(nd_pad + 1, bool)
    mask[:nd_pad] = rng.rand(nd_pad) > 0.5
    j = np.asarray(jax_ordinal_counts(jnp.asarray(flat_docs),
                                      jnp.asarray(flat_ords),
                                      jnp.asarray(mask), n_ords))
    t = tagg.ordinal_counts(torch.from_numpy(flat_docs),
                            torch.from_numpy(flat_ords),
                            torch.from_numpy(mask), n_ords)
    np.testing.assert_array_equal(t.numpy(), j)


def test_wrapper_checks():
    ords, mask, vals = inputs(1, 100, 10)
    with pytest.raises(TypeError):
        segment_aggregate(torch.from_numpy(ords).long(),
                          torch.from_numpy(mask), n_ords=10)
    with pytest.raises(ValueError):
        segment_aggregate(torch.from_numpy(ords), torch.from_numpy(mask[:50]),
                          n_ords=10)


# ----------------------------------------------------------------------
# The gather form: the ordinal CSR column, the match mask and the f64
# doc values, gathered inside the kernel
# ----------------------------------------------------------------------

from elasticsearch_tpu.ops import aggs as jax_aggs  # noqa: E402
from elasticsearch_tpu_torch.ops import segment_sum as tss  # noqa: E402

CSRC = os.path.join(os.path.dirname(tss.__file__), os.pardir, "csrc")


def zipf(rng, n, n_ords):
    p = 1.0 / np.arange(1, n_ords + 1)
    return rng.choice(n_ords, n, p=p / p.sum()).astype(np.int32)


def csr_inputs(seed, nd1, n_vals, n_ords, *, cap=None, hot=False,
               special=False, bad_ords=False):
    """An ordinal CSR column over nd1 - 1 docs plus the sentinel: sorted
    flat_docs padded to ``cap`` at the sentinel, ords uniform or zipf
    (``hot``), a match mask whose sentinel is False, f64 doc values with
    NaN, +-inf and 3e38 each in a bucket of its own (``special``), and ords
    at -1 and >= n_ords (``bad_ords``)."""
    rng = np.random.RandomState(seed)
    cap = n_vals if cap is None else cap
    flat_docs = np.full(cap, nd1 - 1, np.int32)
    flat_docs[:n_vals] = np.sort(rng.randint(0, max(nd1 - 1, 1), n_vals))
    flat_ords = np.zeros(cap, np.int32)
    flat_ords[:n_vals] = (zipf(rng, n_vals, n_ords) if hot
                          else rng.randint(0, n_ords, n_vals))
    match = rng.rand(nd1) > 0.4
    match[nd1 - 1] = False
    values = rng.randn(nd1) * 50.0
    if special:
        # four docs, each with buckets of its own: NaN, +inf, -inf, 3e38
        flat_ords[:n_vals] %= n_ords - 4
        docs = rng.choice(np.unique(flat_docs[:n_vals]), 4, replace=False)
        for i, (d, v) in enumerate(zip(docs, (np.nan, np.inf, -np.inf,
                                              3e38))):
            flat_ords[:n_vals][flat_docs[:n_vals] == d] = n_ords - 1 - i
            values[d] = v
            match[d] = True
    if bad_ords and n_vals >= 4:
        flat_ords[:n_vals:7] = -1
        flat_ords[3:n_vals:11] = n_ords + rng.randint(0, 300)
    return flat_docs, flat_ords, match, values


def run_gathered(flat_docs, flat_ords, match, values, n_ords):
    t = [torch.from_numpy(x) for x in (flat_docs, flat_ords, match, values)]
    count = tagg.ordinal_counts(t[0], t[1], t[2], n_ords)
    total = tagg.ordinal_sums(t[0], t[1], t[2], t[3], n_ords)
    return count.numpy(), total.numpy()


def run_jax(monkeypatch, flat_docs, flat_ords, match, values, n_ords):
    # the JAX package's own dispatch onto its Pallas kernel, interpreted
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")
    j = [jnp.asarray(x) for x in (flat_docs, flat_ords, match, values)]
    count = np.asarray(jax_aggs.ordinal_counts(j[0], j[1], j[2], n_ords))
    total = np.asarray(jax_aggs.ordinal_sums(j[0], j[1], j[2], j[3], n_ords))
    return count, total


def abs_sums(flat_docs, flat_ords, match, values, n_ords):
    """Per bucket, the sum of |sanitized value| over the contributions."""
    nd1 = match.shape[0]
    ok = (flat_docs >= 0) & (flat_docs < nd1)
    d, o = flat_docs[ok], flat_ords[ok]
    ok = match[d] & (o >= 0) & (o < n_ords)
    v = np.abs(np.clip(np.nan_to_num(values[d[ok]].astype(np.float32),
                                     nan=0.0), -tss.BF16_MAX, tss.BF16_MAX))
    return np.bincount(o[ok], weights=v.astype(np.float64), minlength=n_ords)


def assert_sums_close(got, want, absum):
    same = got == want  # both inf of one sign, or equal
    tol = tss.SUM_RTOL * absum + tss.SUM_ATOL
    with np.errstate(invalid="ignore"):  # inf - inf where both are inf
        close = np.abs(got - want) <= tol
    assert np.all(same | close), (got, want)


GATHER_CASES = {
    # name: (nd1, n_vals, n_ords, kwargs)
    "uniform": (1025, 3000, 40, {}),
    "padded_to_cap": (2049, 1500, 130, {"cap": 2048}),
    "zipf_hot_bucket": (4097, 4096, 2000, {"hot": True}),
    "nan_inf_3e38": (1025, 1024, 64, {"special": True}),
    "ords_minus1_and_above": (1025, 2000, 77, {"bad_ords": True}),
    "one_value": (9, 1, 5, {}),
    "no_values": (9, 0, 5, {}),
    # n_ords on both sides of the shared-memory path's limit
    "counts_at_smem_limit": (3001, 3000, 57024, {}),
    "counts_past_smem_limit": (3001, 3000, 57025, {}),
    "sums_at_smem_limit": (3001, 3000, 18644, {"hot": True}),
    "sums_past_smem_limit": (3001, 3000, 18645, {"hot": True}),
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gathered_plain_matches_jax(monkeypatch, case):
    nd1, n_vals, n_ords, kw = GATHER_CASES[case]
    x = csr_inputs(len(case), nd1, n_vals, n_ords, **kw)
    count, total = run_gathered(*x, n_ords)
    jc, jt = run_jax(monkeypatch, *x, n_ords)
    assert count.dtype == np.int32 and total.dtype == np.float64
    assert count.shape == total.shape == (n_ords,)
    np.testing.assert_array_equal(count, jc)
    assert_sums_close(total, jt, abs_sums(*x, n_ords))


@pytest.mark.parametrize("where", ["negative", "past_nd1", "sentinel"])
def test_doc_index_outside_contributes_nothing(monkeypatch, where):
    flat_docs, flat_ords, match, values = csr_inputs(11, 1025, 2000, 50)
    bad = np.arange(5, 2000, 13)
    bad_docs = flat_docs.copy()
    bad_docs[bad] = {"negative": -3, "past_nd1": 1025 + 40,
                     "sentinel": 1024}[where]
    count, total = run_gathered(bad_docs, flat_ords, match, values, 50)
    # the JAX package gathers out-of-range indices clamped, so it is held
    # on the column with those entries dropped
    keep = np.ones(2000, bool)
    keep[bad] = False
    jc, jt = run_jax(monkeypatch, flat_docs[keep], flat_ords[keep], match,
                     values, 50)
    np.testing.assert_array_equal(count, jc)
    assert_sums_close(total, jt, abs_sums(flat_docs[keep], flat_ords[keep],
                                          match, values, 50))


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gathered_equals_mask_form(case):
    """The gather form is the f32-mask form over the gathered column."""
    nd1, n_vals, n_ords, kw = GATHER_CASES[case]
    flat_docs, flat_ords, match, values = csr_inputs(
        len(case) + 1, nd1, n_vals, n_ords, **kw)
    flat_docs[::17] = -1
    count, total = tss.segment_counts_sums_gathered(
        *(torch.from_numpy(x) for x in (flat_docs, flat_ords, match,
                                        values)), n_ords=n_ords)
    inside = (flat_docs >= 0) & (flat_docs < nd1)
    d = np.where(inside, flat_docs, 0)
    mask = (match[d] & inside).astype(np.float32)
    mc, mt = segment_counts_sums(
        torch.from_numpy(flat_ords), torch.from_numpy(mask),
        torch.from_numpy(values[d].astype(np.float32)), n_ords=n_ords)
    assert torch.equal(count, mc)
    assert total.dtype == torch.float64 and torch.equal(total, mt.double())


def test_gathered_match_as_uint8_and_counts_only():
    flat_docs, flat_ords, match, values = csr_inputs(5, 513, 700, 30)
    args = [torch.from_numpy(x) for x in (flat_docs, flat_ords)]
    c_bool, t_none = tss.segment_counts_sums_gathered(
        *args, torch.from_numpy(match), n_ords=30)
    c_u8, t_u8 = tss.segment_counts_sums_gathered(
        *args, torch.from_numpy(match.astype(np.uint8)),
        torch.from_numpy(values), n_ords=30)
    assert t_none is None and torch.equal(c_bool, c_u8)
    _, sums_only = tss.segment_counts_sums_gathered(
        *args, torch.from_numpy(match), torch.from_numpy(values), n_ords=30,
        with_count=False)
    assert torch.equal(sums_only, t_u8)


def test_gathered_wrapper_checks():
    flat_docs, flat_ords, match, values = csr_inputs(2, 65, 80, 9)
    d, o, m, v = (torch.from_numpy(x) for x in (flat_docs, flat_ords, match,
                                                values))
    with pytest.raises(TypeError):  # f32 values: the port keeps f64
        tss.segment_counts_sums_gathered(d, o, m, v.float(), n_ords=9)
    with pytest.raises(TypeError):
        tss.segment_counts_sums_gathered(d, o, m.float(), n_ords=9)
    with pytest.raises(TypeError):
        tss.segment_counts_sums_gathered(d.long(), o, m, n_ords=9)
    with pytest.raises(ValueError):
        tss.segment_counts_sums_gathered(d, o[:-1], m, n_ords=9)
    with pytest.raises(ValueError):
        tss.segment_counts_sums_gathered(d, o, m, v[:-1], n_ords=9)
    with pytest.raises(ValueError):
        tss.segment_counts_sums_gathered(d, o, m, n_ords=9, with_count=False)


# ----------------------------------------------------------------------
# The launch plan (csrc/segment_sum.cu's constants and formula)
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _constexprs(path):
    env = {}
    with open(path) as f:
        for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);",
                                     f.read()):
            env[name] = int(eval(expr.split("//")[0], {}, dict(env)))
    return env


def test_plan_constants_match_the_cuda_source():
    c = _constexprs(os.path.join(CSRC, "segment_sum.cu"))
    assert c["kUnroll"] == tss.UNROLL
    assert c["kMaxWarps"] == tss.MAX_WARPS == max(tss.WARPS)
    assert c["kCombineSlices"] == tss.COMBINE_SLICES
    assert c["kCombineOrds"] == tss.COMBINE_ORDS
    assert c["kQueue"] == tss.QUEUE
    assert {"smem": c["kPathShared"], "global": c["kPathGlobal"]} == tss.PATHS
    # a warp's step: every lane's kUnroll units of 4 docs
    assert tss.STEP_DOCS == 4 * 32 * c["kUnroll"]
    assert tss.MIN_DOCS_PER_CTA == 8 * tss.STEP_DOCS


def smem_restated(n_ords, warps, wc, ws, path):
    # plan_smem: a warp's queue of 32 * kUnroll * 4 + 32 ordinals (and as
    # many values with sums); on the shared path the count histogram and a
    # sum histogram a warp, padded to 4
    c = _constexprs(os.path.join(CSRC, "segment_sum.cu"))
    n4 = -(-n_ords // 4) * 4
    words = warps * (32 * c["kUnroll"] * 4 + 32) * (1 + ws)
    if path == "smem":
        words += n4 * wc + warps * n4 * ws
    return 4 * words


PLAN_NDS = [0, 1, 3, 4, 5, 4095, 4096, 4097, 20_000, 262_144, 1 << 20,
            (1 << 20) + 3, 10_000_000]
PLAN_ORDS = [1, 17, 2000, 5000, 6000, 18644, 18645, 49408, 49409, 57024,
             57025, 1 << 18]


@pytest.mark.parametrize("wc,ws", [(True, True), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("n_ords", PLAN_ORDS)
def test_plan_properties(n_ords, wc, ws):
    for nd in PLAN_NDS:
        for n_sm in (132, 114, 8):
            p = tss.segment_sum_plan(nd, n_ords, wc, ws, n_sm)
            warps = p.threads // 32
            assert p.threads % 32 == 0 and warps in tss.WARPS
            assert p.smem == smem_restated(n_ords, warps, wc, ws, p.path)
            assert p.smem <= 227 * 1024
            # the grid covers nd and leaves no CTA empty
            units = -(-nd // 4)
            assert p.grid * p.units_per_cta >= units
            assert nd == 0 or (p.grid - 1) * p.units_per_cta < units
            # one CTA an SM at most, and the warps one step needs
            assert p.grid <= n_sm
            assert warps == tss.WARPS[-1] or \
                (warps // 2) * tss.STEP_DOCS < 4 * p.units_per_cta
            if nd <= tss.MIN_DOCS_PER_CTA:
                assert p.grid == 1
            if p.path == "smem":
                assert p.deterministic
                assert p.combine_blocks == (
                    -(-n_ords // 32) if p.grid > 1 else 0)
            else:
                assert p.deterministic == (not ws)
                assert p.combine_blocks >= 1 and p.kernels == 2
            assert p.kernels <= 2


def test_limit_cases_sit_on_both_sides_of_the_limit():
    for case, want in (("counts_at_smem_limit", "smem"),
                       ("counts_past_smem_limit", "global"),
                       ("sums_at_smem_limit", "smem"),
                       ("sums_past_smem_limit", "global")):
        nd1, n_vals, n_ords, _ = GATHER_CASES[case]
        # counts alone, or counts and sums
        ws = case.startswith("sums")
        assert tss.segment_sum_plan(n_vals, n_ords, True, ws).path == want


@pytest.mark.parametrize("wc,ws", [(True, True), (True, False),
                                   (False, True)])
def test_plan_path_switches_where_the_formula_says(wc, ws):
    optin = 232448

    def largest_fit(warps):
        # the largest n_ords whose shared-path CTA of ``warps`` fits
        lo, hi = 0, 1 << 20
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if smem_restated(mid, warps, wc, ws, "smem") <= optin:
                lo = mid
            else:
                hi = mid - 1
        return lo

    # the fewest warps a CTA may take bound the shared path
    last = largest_fit(min(tss.WARPS))
    assert tss.segment_sum_plan(1 << 20, last, wc, ws).path == "smem"
    assert tss.segment_sum_plan(1 << 20, last + 1, wc, ws).path == "global"
    # 2^20 docs want 16 warps a CTA; fewer where the queues and
    # histograms of 16 do not fit
    for warps in (16, 8, 4):
        edge = largest_fit(warps)
        assert tss.segment_sum_plan(1 << 20, edge, wc, ws).threads \
            == 32 * warps
        assert tss.segment_sum_plan(1 << 20, edge + 1, wc, ws).threads \
            == 16 * warps


def test_plan_main_path_shapes():
    # the terms aggregation at 2^20 docs and 2,000 venue ordinals: a CTA
    # of 16 warps an SM, partials folded by the combine pass
    p = tss.segment_sum_plan(1 << 20, 2000, True, False)
    assert (p.path, p.grid, p.threads, p.units_per_cta) == \
        ("smem", 132, 512, 1986)
    assert p.combine_blocks == 63 and p.deterministic and p.kernels == 2
    # an ingest shard's 4,096 docs: one CTA writes the outputs itself
    small = tss.segment_sum_plan(4096, 2000, True, True)
    assert small.grid == 1 and small.kernels == 1 and small.deterministic
    # 2^18 ordinals with sums: the global path
    high = tss.segment_sum_plan(1 << 20, 1 << 18, True, True)
    assert high.path == "global" and not high.deterministic
    assert high.grid == 132 and high.kernels == 2


# ----------------------------------------------------------------------
# The combine pass
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [1, 3, 32, 33, 256])
def test_combine_plain_folds_in_slice_order(n_parts):
    rng = np.random.RandomState(n_parts)
    pc = rng.randint(0, 1000, (n_parts, 72)).astype(np.int32)
    pt = (rng.randn(n_parts, 72) * 1e4).astype(np.float32)
    count, total = tss.combine_partials(torch.from_numpy(pc),
                                        torch.from_numpy(pt))
    np.testing.assert_array_equal(count.numpy(), pc.sum(0))
    slices = tss.COMBINE_SLICES
    per = -(-n_parts // slices)
    want = np.zeros(72, np.float32)
    for s in range(slices):
        acc = np.zeros(72, np.float32)
        for b in range(min(s * per, n_parts), min(s * per + per, n_parts)):
            acc = acc + pt[b]
        want = want + acc
    np.testing.assert_array_equal(total.numpy(), want)
    _, only = tss.combine_partials(None, torch.from_numpy(pt))
    np.testing.assert_array_equal(only.numpy(), want)
