"""K1, the residual-int8 tile-table scan: the port's plain version (and the
wrapper's CPU path) against the reference's Pallas kernel in interpret mode,
on the same numpy inputs. (The CUDA kernel is held to the plain version on
the card by chip_smoke.py: the card's machine has no JAX, which these tests
import.)

Tolerances: ids equal on >= 99.5% of (query, rank) slots and every mismatch
a near-tie (the two scores at that rank within 1e-4); scores within 1e-4
absolute. The centroid term sums bf16 products in f32 in another order in
each implementation, so scores differ in their last bits and exact ties can
fall either way.
"""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.ops.pallas_band import tiles_topk_resid_pallas
from cloudvectordb_tpu_torch.ops import band

TOL = 1e-4


def _inputs(seed, *, d=64, tile_n=256, tile_q=16, n_tiles=6, w=3, nq=32, p=4):
    """Random kernel inputs: monotone per-tile local ids, valid_end with
    holes (some lists cut short, a short final tile), a table with a repeated
    tile, and bf16-exact centroid tiles."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile_n
    payload = rng.integers(-127, 128, size=(n, d), dtype=np.int8)
    local = np.zeros((1, n), np.uint8)
    valid_end = np.zeros((n_tiles, w), np.int32)
    for t in range(n_tiles):
        cuts = np.sort(rng.integers(0, tile_n, size=w - 1))
        loc = np.searchsorted(cuts, np.arange(tile_n), side="right")
        local[0, t * tile_n:(t + 1) * tile_n] = loc
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [tile_n]])
        # each list keeps a random prefix of its rows: the rest are holes
        keep = (starts + rng.uniform(0.5, 1.0, size=w) * (ends - starts)).astype(np.int32)
        valid_end[t] = t * tile_n + keep
    valid_end[-1] = np.minimum(valid_end[-1], (n_tiles - 1) * tile_n + tile_n // 3)
    ct = torch.from_numpy(rng.normal(size=(n_tiles, w, d)).astype(np.float32) / np.sqrt(d))
    ct = ct.to(torch.bfloat16).float().numpy()
    queries = rng.normal(size=(nq, d)).astype(np.float32) / np.sqrt(d)
    table = rng.integers(0, n_tiles, size=(nq // tile_q, p)).astype(np.int32)
    table[:, -1] = table[:, 0]  # duplicate entries are harmless
    return dict(payload=payload, local=local, ct=ct, scale=0.02,
                queries=queries, table=table, valid_end=valid_end,
                tile_n=tile_n, tile_q=tile_q)


def _run_jax(x, k, l_buckets):
    v, i = tiles_topk_resid_pallas(
        x["payload"], x["local"], x["ct"], x["scale"], x["queries"],
        x["table"], k, x["valid_end"], tile_n=x["tile_n"],
        tile_q=x["tile_q"], l_buckets=l_buckets, interpret=True)
    return np.asarray(v), np.asarray(i)


def _run_torch(fn, x, k, l_buckets):
    t = torch.as_tensor
    v, i = fn(t(x["payload"]), t(x["local"]), t(x["ct"]), x["scale"],
              t(x["queries"]), t(x["table"]), k, t(x["valid_end"]),
              tile_n=x["tile_n"], tile_q=x["tile_q"], l_buckets=l_buckets)
    return v.numpy(), i.numpy()


def _assert_agree(v_ref, i_ref, v, i, min_match):
    np.testing.assert_allclose(v, v_ref, atol=TOL, rtol=0)
    same = i == i_ref
    assert same.mean() >= min_match, same.mean()
    assert np.all(np.abs(v - v_ref)[~same] <= TOL)


@pytest.mark.parametrize("l_buckets,k", [(0, 10), (64, 10), (16, 16)],
                         ids=["R1", "R4", "R16_k_eq_L"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_pallas_interpret(seed, l_buckets, k):
    x = _inputs(seed)
    v_jax, i_jax = _run_jax(x, k, l_buckets)
    v_ref, i_ref = _run_torch(band.tiles_topk_resid_reference, x, k, l_buckets)
    _assert_agree(v_jax, i_jax, v_ref, i_ref, 0.995)
    assert np.isfinite(v_ref).all()


def test_wrapper_cpu_path_is_the_reference():
    x = _inputs(3, w=1, p=3)
    before = band.tiles_topk_resid.launches
    v_ref, i_ref = _run_torch(band.tiles_topk_resid_reference, x, 10, 0)
    v, i = _run_torch(band.tiles_topk_resid, x, 10, 0)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(v, v_ref)
    assert band.tiles_topk_resid.launches == before  # no kernel on the CPU


def test_fully_masked_slots_stay_unfilled():
    """A tile whose lists are all holes contributes (-inf, row 0) slots, as
    the reference's initial slot state."""
    x = _inputs(4, n_tiles=2, p=1)
    x["valid_end"][:] = np.arange(2)[:, None] * x["tile_n"]  # every row a hole
    v_jax, i_jax = _run_jax(x, 5, 0)
    v, i = _run_torch(band.tiles_topk_resid_reference, x, 5, 0)
    assert np.isneginf(v).all() and np.isneginf(v_jax).all()
    np.testing.assert_array_equal(i, i_jax)


@pytest.mark.parametrize("kw", [dict(l2=True), dict(top2=True), dict(int8_q=False)])
def test_unported_variants_raise(kw):
    x = _inputs(5)
    t = torch.as_tensor
    with pytest.raises(NotImplementedError):
        band.tiles_topk_resid(t(x["payload"]), t(x["local"]), t(x["ct"]), 0.1,
                              t(x["queries"]), t(x["table"]), 10,
                              t(x["valid_end"]), tile_n=256, tile_q=16, **kw)
