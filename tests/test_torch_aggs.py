"""Parity of the port's aggregation ops (``elasticsearch_tpu_torch/ops/
aggs.py``) with the JAX package's (``elasticsearch_tpu/ops/aggs.py``).

The same seeded numpy inputs go through both; the JAX side runs its Pallas
segment-sum kernel in interpret mode (``ES_TPU_PALLAS=interpret``), the
port's its plain version on the CPU. Counts, range counts, HLL registers
and estimates are exact. Stats are exact too: the values are multiples of
1/8 below 2^40, so every f64 sum is exact in any order. Histogram sums are
f32 on both sides (the kernel path) and agree within ``1e-4 * sum |v| +
1e-3`` of each bucket.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import aggs as jagg
from elasticsearch_tpu_torch.ops import aggs as tagg


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("ES_TPU_PALLAS", "interpret")


def csr(seed, nd1=1025, n_vals=3000, scale=50.0, base=0.0):
    """A seeded CSR value column: sorted docs (the last padding entries at
    the sentinel doc), values on the 1/8 grid, a match mask."""
    rng = np.random.RandomState(seed)
    flat_docs = np.sort(rng.randint(0, nd1 - 1, n_vals)).astype(np.int32)
    flat_docs[-7:] = nd1 - 1  # CSR padding points at the sentinel
    flat_values = base + np.round(rng.randn(n_vals) * scale * 8) / 8
    mask = np.zeros(nd1, bool)
    mask[rng.choice(nd1 - 1, nd1 // 2, replace=False)] = True
    valid = np.arange(n_vals) < n_vals - 7
    by_doc = np.round(rng.randn(nd1) * 80) / 8
    return flat_docs, flat_values.astype(np.float64), mask, valid, by_doc


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


HIST_CASES = {
    # (seed, interval, offset, min_bucket_key, n_buckets, scale, base)
    "plain": (1, 10.0, 0.0, -30, 60, 50.0, 0.0),
    "offset": (2, 4.0, 1.5, -80, 160, 50.0, 0.0),
    "clipped_range": (3, 5.0, 0.0, -4, 8, 50.0, 0.0),
    "epoch_ms_hours": (4, 3_600_000.0, 0.0, 1_700_000_000_000 // 3_600_000,
                       25, 1e7, 1_700_000_000_000.0),
    "epoch_ms_days_offset": (5, 86_400_000.0, 3_600_000.0,
                             1_600_000_000_000 // 86_400_000 - 3, 9, 5e7,
                             1_600_000_000_000.0),
    # buckets far out of range: an int32 narrowing before the validity test
    # would wrap them into valid buckets
    "far_out_of_range": (6, 1.0, 0.0, 0, 64, 1e12, 2.0 ** 33),
}


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_histogram_counts(case):
    seed, interval, offset, mkey, nb, scale, base = HIST_CASES[case]
    docs, vals, mask, _, _ = csr(seed, scale=scale, base=base)
    want = np.asarray(jagg.histogram_counts(
        jnp.asarray(docs), jnp.asarray(vals), jnp.asarray(mask), interval,
        offset, mkey, nb))
    got = tagg.histogram_counts(t(docs), t(vals), t(mask), interval, offset,
                                mkey, nb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_value_histogram_sums(case):
    seed, interval, offset, mkey, nb, scale, base = HIST_CASES[case]
    docs, vals, mask, _, by_doc = csr(seed, scale=scale, base=base)
    want = np.asarray(jagg.value_histogram_sums(
        jnp.asarray(docs), jnp.asarray(vals), jnp.asarray(by_doc),
        jnp.asarray(mask), interval, offset, mkey, nb))
    got = tagg.value_histogram_sums(t(docs), t(vals), t(by_doc), t(mask),
                                    interval, offset, mkey, nb)
    assert got.dtype == torch.float64
    # per-bucket sum of |v| over the contributing entries
    b = np.floor((vals - offset) / interval).astype(np.int64) - mkey
    ok = mask[docs] & (b >= 0) & (b < nb)
    abs_sum = np.bincount(b[ok], weights=np.abs(by_doc[docs][ok]),
                          minlength=nb)
    assert np.all(np.abs(got.numpy() - want) <= 1e-4 * abs_sum + 1e-3)


RANGES = {
    "disjoint": ([-np.inf, -20.0, 0.0, 35.5], [-20.0, 0.0, 35.5, np.inf]),
    "overlapping": ([-10.0, -5.0, 0.0], [10.0, 5.0, 200.0]),
    "empty_and_point": ([3.0, 1e9], [3.0, 2e9]),
}


@pytest.mark.parametrize("case", sorted(RANGES))
def test_range_counts(case):
    lo, hi = (np.asarray(x, np.float64) for x in RANGES[case])
    docs, vals, mask, _, _ = csr(7)
    want = np.asarray(jagg.range_counts(
        jnp.asarray(docs), jnp.asarray(vals), jnp.asarray(mask),
        jnp.asarray(lo), jnp.asarray(hi), len(lo)))
    got = tagg.range_counts(t(docs), t(vals), t(mask), t(lo), t(hi), len(lo))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,empty", [(8, False), (9, False), (10, True)])
def test_numeric_stats_and_value_count(seed, empty):
    docs, vals, mask, valid, _ = csr(seed)
    if empty:
        mask[:] = False
    want = [np.asarray(x) for x in jagg.numeric_stats(
        jnp.asarray(docs), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(mask))]
    got = [x.numpy() for x in tagg.numeric_stats(t(docs), t(vals), t(valid),
                                                 t(mask))]
    for g, w in zip(got, want):
        assert g.tolist() == w.tolist()
    vc_j = int(jagg.value_count(jnp.asarray(docs), jnp.asarray(valid),
                                jnp.asarray(mask)))
    assert int(tagg.value_count(t(docs), t(valid), t(mask))) == vc_j


def test_masked_values_for_sample():
    docs, vals, mask, valid, _ = csr(11)
    want = np.asarray(jagg.masked_values_for_sample(
        jnp.asarray(docs), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(mask)))
    got = tagg.masked_values_for_sample(t(docs), t(vals), t(valid),
                                        t(mask)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def _hashes(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "full_range":
        # every bit drawn: half the hashes have the top bit set
        h = rng.randint(0, 2 ** 32, (n, 2)).astype(np.uint64)
        out = (h[:, 0] << np.uint64(32)) | h[:, 1]
        out[:4] = [np.uint64(2 ** 64 - 1), np.uint64(2 ** 63),
                   np.uint64(0), np.uint64(1)]
        return out
    if kind == "numeric":
        return tagg.hash_numeric_values(np.round(rng.randn(n) * 1e3) / 4)
    return tagg.hash_string_values([f"term-{i}-{rng.randint(1e6)}"
                                    for i in range(n)])


@pytest.mark.parametrize("kind", ["full_range", "numeric", "strings"])
@pytest.mark.parametrize("precision", [4, 14, 18])
def test_hll_registers_bit_equal(kind, precision):
    n_vals = 3000
    docs, _, mask, valid, _ = csr(12, n_vals=n_vals)
    hashes = _hashes(kind, n_vals, 13)
    assert np.any(hashes >= np.uint64(2 ** 63))
    want = np.asarray(jagg.hll_registers(
        jnp.asarray(docs), jnp.asarray(hashes), jnp.asarray(valid),
        jnp.asarray(mask), precision=precision))
    got = tagg.hll_registers(t(docs), hashes, t(valid), t(mask),
                             precision=precision)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tagg.hll_estimate(got.numpy()) == jagg.hll_estimate(want)


def test_hll_merge_and_estimate_small_range():
    docs, _, mask, valid, _ = csr(14, n_vals=40)
    a = tagg.hll_registers(t(docs), _hashes("strings", 40, 1), t(valid),
                           t(mask))
    b = tagg.hll_registers(t(docs), _hashes("numeric", 40, 2), t(valid),
                           t(mask))
    merged = tagg.hll_merge(a, b).numpy()
    want = np.asarray(jagg.hll_merge(jnp.asarray(a.numpy()),
                                     jnp.asarray(b.numpy())))
    np.testing.assert_array_equal(merged, want)
    # few registers set: the linear-counting branch
    assert tagg.hll_estimate(merged) == jagg.hll_estimate(want)


def test_value_hashes_equal():
    rng = np.random.RandomState(15)
    vals = np.concatenate([rng.randn(100) * 1e6, [0.0, -0.0, 1.0, 2.0 ** 60]])
    np.testing.assert_array_equal(tagg.hash_numeric_values(vals),
                                  jagg.hash_numeric_values(vals))
    terms = ["", "a", "ü", "venue0001", "x" * 300]
    np.testing.assert_array_equal(tagg.hash_string_values(terms),
                                  jagg.hash_string_values(terms))


def test_ordinal_counts_and_sums():
    rng = np.random.RandomState(16)
    docs, _, mask, _, by_doc = csr(16)
    ords = rng.randint(0, 40, docs.shape[0]).astype(np.int32)
    want_c = np.asarray(jagg.ordinal_counts(
        jnp.asarray(docs), jnp.asarray(ords), jnp.asarray(mask), 40))
    got_c = tagg.ordinal_counts(t(docs), t(ords), t(mask), 40)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    want_s = np.asarray(jagg.ordinal_sums(
        jnp.asarray(docs), jnp.asarray(ords), jnp.asarray(mask),
        jnp.asarray(by_doc), 40))
    got_s = tagg.ordinal_sums(t(docs), t(ords), t(mask), t(by_doc), 40)
    ok = mask[docs]
    abs_sum = np.bincount(ords[ok], weights=np.abs(by_doc[docs][ok]),
                          minlength=40)
    assert np.all(np.abs(got_s.numpy() - want_s) <= 1e-4 * abs_sum + 1e-3)
