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

import sys
from pathlib import Path

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


def _run_variant(fn, x, k, l_buckets, kw, mask):
    """One K1 call with the options ``kw`` and allow bits ``mask`` (or
    None): the reference's Pallas kernel when ``fn`` is None."""
    if fn is None:
        v, i = tiles_topk_resid_pallas(
            x["payload"], x["local"], x["ct"], x["scale"], x["queries"], x["table"], k,
            x["valid_end"], tile_n=x["tile_n"], tile_q=x["tile_q"], l_buckets=l_buckets,
            interpret=True, row_mask=None if mask is None else mask[None, :], **kw)
        return np.asarray(v), np.asarray(i)
    t = torch.as_tensor
    v, i = fn(t(x["payload"]), t(x["local"]), t(x["ct"]), x["scale"], t(x["queries"]),
              t(x["table"]), k, t(x["valid_end"]), tile_n=x["tile_n"], tile_q=x["tile_q"],
              l_buckets=l_buckets, row_mask=None if mask is None else t(mask), **kw)
    return v.numpy(), i.numpy()


def _assert_variant_agrees(x, k, l_buckets, kw, mask):
    v_jax, i_jax = _run_variant(None, x, k, l_buckets, kw, mask)
    v, i = _run_variant(band.tiles_topk_resid_reference, x, k, l_buckets, kw, mask)
    live = np.isfinite(v_jax)
    np.testing.assert_array_equal(np.isfinite(v), live)
    np.testing.assert_allclose(v[live], v_jax[live], atol=TOL, rtol=0)
    same = (i == i_jax) | ~live
    assert same.mean() >= 0.995, same.mean()
    assert np.all(np.abs(v - v_jax)[~same] <= TOL)
    v_w, i_w = _run_variant(band.tiles_topk_resid, x, k, l_buckets, kw, mask)
    np.testing.assert_array_equal(v_w, v)  # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(i_w, i)
    return v, i


#: K1's options: (options, allow bits); l2 keys reach ~60 here, where f32
#: steps are 4e-6, still far inside TOL
VARIANTS = {"precise": (dict(int8_q=False), False), "l2": (dict(l2=True), False),
            "top2": (dict(top2=True), False), "row_mask": ({}, True),
            "all_four": (dict(int8_q=False, l2=True, top2=True), True)}


@pytest.mark.parametrize("l_buckets,k", [(0, 10), (64, 10), (16, 24)],
                         ids=["R1", "R4", "R16_k_gt_L"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_match_pallas_interpret(variant, l_buckets, k):
    """Each contract variant of K1 (and all four at once) against the
    reference's kernel: R 1, 4 and 16 (k above L, so top-2's second slots
    rank), valid_end holes, a repeated table entry, a 50% row mask."""
    kw, masked = VARIANTS[variant]
    x = _inputs(30 + len(variant))
    mask = ((np.random.default_rng(31).random(x["payload"].shape[0]) < 0.5).astype(np.int8)
            if masked else None)
    v, i = _assert_variant_agrees(x, k, l_buckets, kw, mask)
    assert np.isfinite(v).any()
    if masked:
        assert mask[i[np.isfinite(v)]].all()
    if kw.get("top2") and k > (l_buckets or x["tile_n"]):
        assert np.isfinite(v[:, l_buckets:]).any()  # the second slots reached the top-k


@pytest.mark.parametrize("kw", [dict(l2=True), dict(top2=True), dict(int8_q=False)])
def test_unported_variants_raise(kw):
    """The three variants this file once refused (NotImplementedError) are
    now ported: each is held against the reference's kernel, at R 4."""
    _assert_variant_agrees(_inputs(5), 12, 64, kw, None)


def test_row_bias_is_the_reference_expression():
    """``resid_row_bias`` (the CPU path: the plain version) gives each row
    -s²‖r‖²/2 - s·(c·r) - ‖c‖²/2 in f64 to f32 accuracy, and K1's l2 key
    less its ip score is that bias on every filled slot."""
    x = _inputs(8, p=1)  # one tile a query tile: its slots hold every row of it
    t = torch.as_tensor
    bias = band.resid_row_bias(t(x["payload"]), t(x["local"]), t(x["ct"]), x["scale"],
                               x["tile_n"]).numpy()
    r = x["payload"].astype(np.float64)
    c = x["ct"].astype(np.float64)[np.arange(r.shape[0]) // x["tile_n"], x["local"][0]]
    s = np.float64(np.float32(x["scale"]))
    exact = -0.5 * s * s * (r * r).sum(1) - s * (c * r).sum(1) - 0.5 * (c * c).sum(1)
    np.testing.assert_allclose(bias, exact, atol=2e-5, rtol=0)
    k = x["tile_n"]
    v_ip, i_ip = _run_variant(band.tiles_topk_resid, x, k, 0, {}, None)
    v_l2, i_l2 = _run_variant(band.tiles_topk_resid, x, k, 0, dict(l2=True), None)
    for q in range(v_ip.shape[0]):
        live = np.isfinite(v_ip[q])
        key = dict(zip(i_l2[q][np.isfinite(v_l2[q])], v_l2[q][np.isfinite(v_l2[q])]))
        assert sorted(key) == sorted(i_ip[q][live])
        for val, row in zip(v_ip[q][live], i_ip[q][live]):
            assert abs(key[row] - (val + bias[row])) <= TOL


def test_query_quantization_is_the_reference_byte_for_byte():
    """K1's int8 queries and row scales are the reference's expressions
    (pallas_band.py:676-680) to the bit. torch computes ``127.0 / t`` as
    ``t.reciprocal() * 127`` (two roundings), which moved q8 by one step on
    a few codes in a million; the port divides by f32 tensors instead."""
    import jax.numpy as jnp

    q = np.random.default_rng(6).normal(size=(200_000, 64)).astype(np.float32)
    q_amax = jnp.maximum(jnp.max(jnp.abs(q), axis=1, keepdims=True), 1e-12)
    q8_j = jnp.clip(jnp.round(q * (127.0 / q_amax)), -127, 127).astype(jnp.int8)
    rs_j = (q_amax / 127.0) * jnp.asarray(0.02, jnp.float32)
    _, q8, row_scale = band._quantize_queries(torch.from_numpy(q), 0.02)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(q8_j))
    np.testing.assert_array_equal(row_scale.numpy(), np.asarray(rs_j).reshape(-1))


def _chip_smoke():
    """chip_smoke.py, the card run, whose holds these tests check on the CPU."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    return chip_smoke


def _exact_args(x):
    t = torch.as_tensor
    return dict(db_resid=t(x["payload"]), local_ids=t(x["local"]), centroid_tiles=t(x["ct"]),
                resid_scale=x["scale"], queries_sorted=t(x["queries"]),
                valid_end=t(x["valid_end"]), tile_n=x["tile_n"])


def _exact_gap(exact, v, i):
    """max |value - exact f64 score of its id| over the filled slots."""
    qi, pos = np.nonzero(np.isfinite(v))
    return float((torch.as_tensor(v[qi, pos]).double() - exact(qi, i[qi, pos])).abs().max())


@pytest.mark.parametrize("l_buckets", [0, 64], ids=["R1", "R4"])
@pytest.mark.parametrize("seed", [20, 21])
def test_exact_scorer_holds_the_reference_and_the_pallas_kernel(seed, l_buckets):
    """chip_smoke.py's exact f64 scorer of K1 (``resid_exact``) gives every
    id that the plain version and the reference's Pallas kernel (interpret
    mode) return its score within the card's hold tolerance, SCORE_TOL."""
    c = _chip_smoke()
    x = _inputs(seed)
    exact = c.resid_exact(_exact_args(x))
    for v, i in (_run_torch(band.tiles_topk_resid_reference, x, 10, l_buckets),
                 _run_jax(x, 10, l_buckets)):
        assert np.isfinite(v).any()
        assert _exact_gap(exact, v, i) <= c.SCORE_TOL


@pytest.mark.parametrize("fault", ["other list", "hole"])
def test_exact_scorer_fails_a_planted_wrong_local_id(fault):
    """Scoring a returned row under another local list (the centroid term of
    the wrong list), or as a hole past its list's valid_end, puts its exact
    score off the plain version's by more than SCORE_TOL."""
    c = _chip_smoke()
    x = _inputs(22)
    v, i = _run_torch(band.tiles_topk_resid_reference, x, 10, 0)
    row = int(i[0, 0])
    if fault == "other list":
        x["local"][0, row] = (x["local"][0, row] + 1) % x["ct"].shape[1]
        x["valid_end"][row // x["tile_n"]] = (row // x["tile_n"] + 1) * x["tile_n"]
    else:
        x["valid_end"][row // x["tile_n"], x["local"][0, row]] = row
    exact = c.resid_exact(_exact_args(x))
    assert _exact_gap(exact, v[:1, :1], i[:1, :1]) > c.SCORE_TOL


def test_hold_fails_a_repeated_id(monkeypatch):
    """chip_smoke.py's compare fails a kernel whose results name one row
    twice for a query (a top-2 merge that lets slot 1's row into slot 2),
    even where each id's score is its exact score."""
    c = _chip_smoke()

    def fake(ids):
        fake.launches += 1
        return v, ids

    fake.launches = 0
    monkeypatch.setitem(c.WRAPPERS, "Kt", fake)
    monkeypatch.setattr(c, "sync", lambda: None)  # no card here
    v = torch.tensor([[3.0, 2.0, 1.0]])
    i = torch.tensor([[7, 9, 4]], dtype=torch.int32)
    dup = torch.tensor([[7, 7, 4]], dtype=torch.int32)
    c.compare("Kt distinct", lambda: fake(i), lambda: (v, i), quiet=True)
    with pytest.raises(AssertionError, match="an id repeats"):
        c.compare("Kt repeated", lambda: fake(dup), lambda: (v, dup), quiet=True)
