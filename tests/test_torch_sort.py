"""K12 and K13 on the CPU: the port's scalar DISTINCT and ORDER BY
permutation (their plain versions, which the CUDA kernels are held against
on the card) against the JAX package's distinct_count, the reference
runner's _dedup_values and order_permutation, on the same numpy-seeded
inputs.

Tolerance: none. The permutation is compared element for element, ties
included (both sorts are stable); the distinct counts exactly; the dedup
mask exactly, and the sorted values at the rows it marks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickstep_tpu.exec.runner import PlanRunner as RefRunner
from quickstep_tpu.ops import groupby as RG
from quickstep_tpu.ops import sort as RS
from quickstep_tpu_torch.ops import groupby as G
from quickstep_tpu_torch.ops import sort as S

DTYPES = [np.int32, np.int64, np.float32, np.float64, np.bool_]
N = 600


def _values(rng, dtype, n=N, domain=40):
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(dtype, np.integer):
        v = rng.integers(-domain, domain, n).astype(dtype)
        info = np.iinfo(dtype)
        v[:4] = [info.min, info.max, info.min + 1, -1]
        return v
    v = (rng.integers(-domain, domain, n) * 0.25).astype(dtype)
    v[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, np.nan]
    v[rng.random(n) < 0.05] = -0.0
    return v


def _masks(rng, n=N):
    return rng.random(n) < 0.85, rng.random(n) < 0.9


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
@pytest.mark.parametrize("nulls_first", [None, True, False],
                         ids=["nulls_default", "nulls_first", "nulls_last"])
def test_order_permutation_one_key(dtype, asc, nulls_first):
    rng = np.random.default_rng(hash((np.dtype(dtype).name, asc,
                                      nulls_first)) % 2 ** 32)
    key = _values(rng, dtype)
    valid, alive = _masks(rng)
    want = np.asarray(RS.order_permutation(
        [jnp.asarray(key)], [jnp.asarray(valid)], [asc], [nulls_first],
        jnp.asarray(alive)))
    got = S.order_permutation([torch.from_numpy(key)],
                              [torch.from_numpy(valid)], [asc], [nulls_first],
                              torch.from_numpy(alive))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_order_permutation_three_keys(seed):
    """A DOUBLE DESC key, a nullable int key and an int tiebreak (the SF10
    case of chip_smoke.py), with few distinct values so ties reach every
    key."""
    rng = np.random.default_rng(seed)
    dts = [(np.float64, False, None), (np.int32, True, bool(seed % 2)),
           (np.int64, seed % 3 != 0, None)]
    keys = [_values(rng, dt, domain=6) for dt, _, _ in dts]
    valids = [None, rng.random(N) < 0.8,
              None if seed % 2 else rng.random(N) < 0.9]
    asc = [a for _, a, _ in dts]
    nf = [f for _, _, f in dts]
    alive = rng.random(N) < 0.9
    want = np.asarray(RS.order_permutation(
        [jnp.asarray(k) for k in keys],
        [None if v is None else jnp.asarray(v) for v in valids], asc, nf,
        jnp.asarray(alive)))
    got = S.order_permutation(
        [torch.from_numpy(k) for k in keys],
        [None if v is None else torch.from_numpy(v) for v in valids], asc,
        nf, torch.from_numpy(alive))
    np.testing.assert_array_equal(got.numpy(), want)


def test_order_permutation_empty():
    got = S.order_permutation([torch.zeros(0, dtype=torch.float64)], [None],
                              [True], [None], torch.zeros(0, dtype=torch.bool))
    assert got.shape == (0,)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("nullable", [False, True])
def test_distinct_count_matches_reference(dtype, nullable):
    rng = np.random.default_rng(7 + nullable)
    vals = _values(rng, dtype, domain=25)
    valid, alive = _masks(rng)
    valid = valid if nullable else None
    want = int(RG.distinct_count(
        jnp.asarray(vals), None if valid is None else jnp.asarray(valid),
        jnp.asarray(alive)))
    tv = None if valid is None else torch.from_numpy(valid)
    got = G.distinct_count(torch.from_numpy(vals), tv,
                           torch.from_numpy(alive))
    assert int(got) == want
    assert int(G.distinct_count_plain(torch.from_numpy(vals), tv,
                                      torch.from_numpy(alive))) == want


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("nullable", [False, True])
def test_dedup_values_matches_reference(dtype, nullable):
    rng = np.random.default_rng(11 + nullable)
    vals = _values(rng, dtype, domain=25)
    valid, alive = _masks(rng)
    valid = valid if nullable else None
    s_ref, _, mask_ref = RefRunner._dedup_values(
        None, jnp.asarray(vals),
        None if valid is None else jnp.asarray(valid), jnp.asarray(alive))
    s, mask = G.dedup_values(torch.from_numpy(vals),
                             None if valid is None else torch.from_numpy(valid),
                             torch.from_numpy(alive))
    mask_ref = np.asarray(mask_ref)
    np.testing.assert_array_equal(mask.numpy(), mask_ref)
    np.testing.assert_array_equal(s.numpy()[mask_ref],
                                  np.asarray(s_ref)[mask_ref])


def test_distinct_count_empty():
    empty = torch.zeros(0, dtype=torch.int32)
    assert int(G.distinct_count(empty, None,
                                torch.zeros(0, dtype=torch.bool))) == 0
