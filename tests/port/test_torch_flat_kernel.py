"""K2, the fused flat scan: the port's plain version (the wrappers' CPU path)
against the reference's ``flat_topk_pallas`` / ``flat_topk_pallas_int8`` in
interpret mode, on the same numpy inputs. (The CUDA kernel is held to the
plain version on the card by chip_smoke.py.)

Tolerances: f32 and bf16 scores within 1e-5 absolute on unit-norm data (f32
sums in another order); ids equal except where the two scores at that rank
are within 1e-5 (a near-tie). int8 x int8 scores are exact integers, so
values and ids are equal outright; after the f32 rescale of
``flat_topk_int8`` (two f32 products, which XLA may associate another way)
values agree within 3e-7 relative.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.ops.pallas_topk import flat_topk_pallas, flat_topk_pallas_int8
from cloudvectordb_tpu_torch.ops import flat_topk as flat

TOL = 1e-5
#: (query dtype, row dtype): the flat index's f32, bf16 and int8 stores, and
#: f32 queries against a bf16 store as FlatIndex.search passes them
PAIRS = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
         "int8": ("int8", "int8"), "f32xbf16": ("float32", "bfloat16")}


def _arrays(seed, n, d, nq, pair):
    rng = np.random.default_rng(seed)

    def make(m, dt):
        if dt == "int8":
            return rng.integers(-127, 128, size=(m, d), dtype=np.int8)
        x = (rng.normal(size=(m, d)) / np.sqrt(d)).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if dt == "bfloat16" else x

    return make(n, pair[1]), make(nq, pair[0])


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_agree(v_ref, i_ref, v, i, tol=TOL):
    v_ref, i_ref = np.asarray(v_ref), np.asarray(i_ref)
    np.testing.assert_allclose(v, v_ref, atol=tol, rtol=0)
    same = i == i_ref
    assert np.all(np.abs(v - v_ref)[~same] <= tol)
    assert same.mean() >= 0.99, same.mean()


@pytest.mark.parametrize("l_buckets", [0, 512], ids=["R1", "R4"])
@pytest.mark.parametrize("pair,metric", [  # the int8 scan is inner product only
    (p, m) for p in PAIRS for m in ("ip", "l2") if not (p == "int8" and m == "l2")])
def test_reference_matches_pallas_interpret(pair, metric, l_buckets):
    db, q = _arrays(7, 2 * 2048 + 901, 64, 20, PAIRS[pair])  # ragged last tile
    v_j, i_j = flat_topk_pallas(jnp.asarray(db), jnp.asarray(q), 10, metric=metric,
                                l_buckets=l_buckets, interpret=True)
    v, i = flat.flat_topk(_torch(db), _torch(q), 10, metric=metric, l_buckets=l_buckets)
    if pair == "int8":  # exact int32 scores: nothing may differ
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    else:
        _assert_agree(v_j, i_j, v.numpy(), i.numpy())


def test_l2_with_given_norms_and_k_above_n():
    db, q = _arrays(8, 5, 32, 6, PAIRS["f32"])
    v_j, i_j = flat_topk_pallas(db, q, 10, metric="l2", interpret=True)
    v, i = flat.flat_topk(_torch(db), _torch(q), 10, metric="l2",
                          db_sqnorms=torch.from_numpy((db * db).sum(1)))
    assert v.shape == (6, 5)  # k clipped to the 5 rows
    _assert_agree(v_j, i_j, v.numpy(), i.numpy())


def test_tile_q_does_not_change_the_result():
    db, q = _arrays(9, 3000, 48, 33, PAIRS["f32"])
    a = flat.flat_topk(_torch(db), _torch(q), 10, tile_q=8)
    b = flat.flat_topk(_torch(db), _torch(q), 10, tile_q=256)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_int8_wrapper_matches_reference():
    """flat_topk_int8 quantizes each query with the reference's expression
    (q8 byte for byte) and rescales the exact int32 top-k."""
    rng = np.random.default_rng(10)
    db = rng.integers(-127, 128, size=(4100, 64), dtype=np.int8)
    q = rng.normal(size=(24, 64)).astype(np.float32)
    q_amax = np.maximum(np.abs(q).max(axis=1, keepdims=True), 1e-12)
    q8_j = np.asarray(jnp.clip(jnp.round(jnp.asarray(q) / (jnp.asarray(q_amax) / 127.0)),
                               -127, 127).astype(jnp.int8))
    q8, _ = flat.quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(q8.numpy(), q8_j)
    v_j, i_j = flat_topk_pallas_int8(db, 0.0123, q, 10, interpret=True)
    v, i = flat.flat_topk_int8(torch.from_numpy(db), 0.0123, torch.from_numpy(q), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=3e-7, atol=0)


def test_wrapper_cpu_path_is_the_reference():
    db, q = _arrays(11, 5000, 32, 10, PAIRS["f32"])
    before = flat.flat_topk.launches
    a = flat.flat_topk(_torch(db), _torch(q), 10, metric="l2")
    b = flat.flat_topk_reference(_torch(db), _torch(q), 10, metric="l2")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert flat.flat_topk.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("kw", [dict(metric="cos"), dict(precision="low"),
                                dict(l_buckets=300)])
def test_bad_arguments_raise(kw):
    db, q = _arrays(12, 3000, 16, 4, PAIRS["f32"])
    with pytest.raises(ValueError):
        flat.flat_topk(_torch(db), _torch(q), 5, **kw)


def test_unsupported_type_pair_raises():
    db, q = _arrays(13, 3000, 16, 4, PAIRS["int8"])
    with pytest.raises(TypeError):
        flat.flat_topk(_torch(db), _torch(q).float(), 5)


@pytest.mark.parametrize("l_buckets", [0, 512], ids=["R1", "R4"])
def test_f32_l2_of_integer_rows_is_exact(l_buckets):
    """Rows and queries that are integers in [0, 255] at D 128 (the SIFT-like
    cell's data): every partial sum of 2 q.x - |x|^2 is an integer below 2^24
    (at most 2 x 128 x 255^2 = 16,646,400), so the f32 scan is exact in any
    summation order: its slot values and its final values (less |q|^2)
    equal an f64 computation outright. This is why the card run holds K2
    f32 l2 equal to its plain version there."""
    from cloudvectordb_tpu_torch.ops.band import SCAN_ALL, _scan_slots

    rng = np.random.default_rng(14)
    d, n = 128, 3 * 2048 + 333
    db = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    q = rng.integers(0, 256, size=(40, d)).astype(np.float32)
    db[:5], q[:3] = 255.0, 255.0  # the largest sums
    sq = (db.astype(np.float64) ** 2).sum(1)
    v, i, _ = _scan_slots(SCAN_ALL, torch.from_numpy(db), torch.from_numpy(q), None,
                          -(-n // 2048), torch.from_numpy(sq.astype(np.float32)),
                          tile_n=2048, tile_q=len(q), l_buckets=l_buckets or 2048,
                          n_valid=n, plain=True)
    rows = i.numpy().astype(np.int64)
    want = 2.0 * (q.astype(np.float64)[:, None, :] * db[rows].astype(np.float64)).sum(-1)
    np.testing.assert_array_equal(v.numpy().astype(np.float64), want - sq[rows])
    v, i = flat.flat_topk(torch.from_numpy(db), torch.from_numpy(q), 10, metric="l2",
                          l_buckets=l_buckets)
    dist = ((q.astype(np.float64)[:, None, :] - db[i.numpy()].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(v.numpy().astype(np.float64), -dist)
