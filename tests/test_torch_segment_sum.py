"""Parity of the PyTorch segment-sum module with the JAX Pallas kernel.

Seeded numpy inputs go through ``elasticsearch_tpu``'s
``segment_aggregate`` (interpret mode, as tests/test_pallas_aggs.py runs
it) and through ``elasticsearch_tpu_torch``'s plain version. Counts are
exact; sums agree within rtol 1e-4 / atol 1e-4 (the JAX kernel sums f32 in
chunk order through a two-pass bf16 split, the plain version sums with
``torch.bincount``).
"""

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
