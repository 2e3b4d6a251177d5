"""The int8 rescore of the PQ route (ops/rescore.py; csrc/rescore_int8.cu on
the card), in its four variants: residual or whole rows, ip or l2.

On the CPU:
1. the plain version against an f64 numpy recomputation of the same formula
   (within 1e-5 of max(|score|, 1));
2. unfilled K5 slots (-inf) stay exactly -inf;
3. K5's rows past the refine rows (or before the first) reach the rescore
   clamped by ``_pq_tiles_core``, which owns the clamp: the op receives
   rows in range, and the answers are those of rows clamped beforehand;
4. a batch that ``_rescore_cap`` cuts into several query sub-batches gives
   the same scores as one sub-batch;
5. ``_pq_tiles_core`` on a tiny ``BandIVFPQIndex(refine='int8')`` returns
   bit for bit what the core did before the rescore moved into
   ops/rescore.py (an inline copy of that core below).

On the card (marked ``card``; they skip without one): the kernel against
the plain version on the same CUDA tensors at a tiny shape and at the
``opqpq10m.b4096`` cell's (B 4096, k_cand 2050, D 768), the scores before
and after ``topk_stable`` held as tests/port/test_torch_pq_kernel.py holds
K5 (within 1e-5 of max(|score|, 1), -inf exact, a differing id only between
scores within that); D not a multiple of 4 refused; and one kernel launch
for one ``search_device`` call.
tests/conftest.py imports JAX, which the card's machine does not have, so
there this file runs alone: ``python -m pytest --noconftest -p
no:cacheprovider tests/port/test_torch_rescore.py -m card``. This file
imports no JAX.
"""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu_torch.index import ivf_band
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.ops import rescore
from cloudvectordb_tpu_torch.ops.pq import pq_tiles_topk
from cloudvectordb_tpu_torch.ops.topk import NEG_INF, f32_const, topk_stable

RTOL = 1e-5
#: (residual, l2)
VARIANTS = [(True, False), (True, True), (False, False), (False, True)]
VARIANT_IDS = ["resid-ip", "resid-l2", "whole-ip", "whole-l2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(seed: int, *, b: int, kc: int, d: int, n: int, nlist: int = 64, tile_n: int = 16,
            w: int = 4, unfilled: float = 0.1, scale: float = 0.004, device="cpu"):
    """Random rescore inputs: int8 rows over the whole range, unit-scale
    queries and centroids, a planner order, per-tile windows and local
    bytes, ``unfilled`` of the slots -inf. Made on ``device`` by a seeded
    torch generator (the card's shape is 1.5 GB)."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, generator=g)
    v = torch.rand((b, kc), **kw)
    v = torch.where(torch.rand((b, kc), **kw) < unfilled, NEG_INF, v)
    q = torch.randn((b, d), **kw) / d ** 0.5
    cents = torch.randn((nlist, d), **kw) / d ** 0.5
    return dict(
        q_s=q, v=v, rows=torch.randint(0, n, (b, kc), **kw),
        refine_rows=torch.randint(-128, 128, (n, d), dtype=torch.int8, **kw),
        refine_scale=scale, centroids=cents, dots=torch.randn((b, nlist), **kw),
        order=torch.randperm(b, **kw),
        tile_window=torch.randint(0, nlist, (-(-n // tile_n), w), **kw),
        local_ids=torch.randint(0, w, (n,), dtype=torch.uint8, **kw), tile_n=tile_n)


def _call(fn, a: dict, residual: bool, l2: bool, **over):
    a = {**a, **over}
    return fn(a["q_s"], a["v"], a["rows"], a["refine_rows"], a["refine_scale"],
              residual=residual, l2=l2, centroids=a["centroids"], dots=a["dots"],
              order=a["order"], tile_window=a["tile_window"], local_ids=a["local_ids"],
              tile_n=a["tile_n"])


def _f64_scores(a: dict, residual: bool, l2: bool) -> np.ndarray:
    """The module's formula in f64 numpy, from the same f32 inputs."""
    rows = a["rows"].numpy()
    r = a["refine_rows"].numpy()[rows].astype(np.float64)  # (B, kc, D)
    s = np.float64(np.float32(a["refine_scale"]))
    if residual:
        q = a["q_s"].to(torch.bfloat16).double().numpy()
        ex = np.einsum("bkd,bd->bk", r, q) * s
        lists = a["tile_window"].numpy()[rows // a["tile_n"], a["local_ids"].numpy()[rows]]
        if l2:
            c = a["centroids"].double().numpy()[lists]
            ex -= 0.5 * ((c * c).sum(-1) + 2 * s * (c * r).sum(-1) + s * s * (r * r).sum(-1))
        ex += np.take_along_axis(a["dots"].double().numpy()[a["order"].numpy()], lists, 1)
    else:
        x = r * s
        ex = np.einsum("bkd,bd->bk", x, a["q_s"].double().numpy())
        if l2:
            ex -= 0.5 * (x * x).sum(-1)
    return np.where(np.isfinite(a["v"].numpy()), ex, -np.inf)


def _assert_close(ex, ref) -> None:
    """Scores within RTOL of max(|ref|, 1); -inf exactly where ref has it."""
    ex, ref = np.asarray(ex, np.float64), np.asarray(ref, np.float64)
    live = np.isfinite(ref)
    np.testing.assert_array_equal(live, np.isfinite(ex))
    assert np.all(ex[~live] == -np.inf)
    gap = np.abs(ex[live] - ref[live])
    assert np.all(gap <= RTOL * np.maximum(np.abs(ref[live]), 1.0)), gap.max()


def _assert_same_topk(v, i, v_ref, i_ref):
    """tests/port/test_torch_pq_kernel.py's rule (that file imports JAX)."""
    v, i = np.asarray(v), np.asarray(i)
    v_ref, i_ref = np.asarray(v_ref), np.asarray(i_ref)
    assert v.shape == v_ref.shape and i.shape == i_ref.shape
    live = np.isfinite(v_ref)
    np.testing.assert_array_equal(live, np.isfinite(v))
    tol = RTOL * np.maximum(np.abs(v_ref), 1.0)
    assert np.all(np.abs(v - v_ref)[live] <= tol[live])
    diff = (i != i_ref) & live
    # a differing id is a tie: its score matches the reference's slot
    assert np.all(np.abs(v - v_ref)[diff] <= tol[diff])
    assert diff.mean() <= 0.01, diff.mean()


@pytest.mark.parametrize("d", [32, 30])
@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_plain_matches_f64_recomputation(residual, l2, d):
    a = _inputs(1, b=24, kc=40, d=d, n=200)
    ex = _call(rescore.rescore_int8, a, residual, l2)
    assert ex.dtype == torch.float32 and tuple(ex.shape) == (24, 40)
    _assert_close(ex.numpy(), _f64_scores(a, residual, l2))


@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_unfilled_slots_stay_neg_inf(residual, l2):
    a = _inputs(2, b=16, kc=32, d=32, n=100, unfilled=0.5)
    a["v"][3] = NEG_INF  # a query with no candidate at all
    ex = _call(rescore.rescore_int8, a, residual, l2)
    dead = a["v"] == NEG_INF
    assert bool(dead.any()) and bool((~dead).any())
    assert bool((ex[dead] == NEG_INF).all())
    assert bool(torch.isfinite(ex[~dead]).all())


@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_sub_batches_match_one_sub_batch(residual, l2, monkeypatch):
    b, kc = 256, 8192
    sub = rescore._rescore_cap(kc, b, halve=l2 and residual)
    assert b // sub >= 2  # the plain version cuts this batch
    a = _inputs(4, b=b, kc=kc, d=8, n=512)
    ex = _call(rescore.rescore_int8, a, residual, l2)
    monkeypatch.setattr(rescore, "_rescore_cap", lambda kc, b, halve=False: b)
    one = _call(rescore.rescore_int8, a, residual, l2)
    assert torch.equal(ex, one)


def _parent_pq_tiles_core(q, centroids, codes, codebooks, refine_rows, tile_window,
                          centroid_tiles, n_valid, local_ids, row_mask=None, *, k: int,
                          k_cand: int, p_tiles: int, tile_n: int, tile_q: int,
                          refine_scale: float, n_pools: int = 1, l_buckets: int = 0,
                          refine_residual: bool = False, l2: bool = False, top2: bool = False,
                          row_bias=None, segments=None):
    """``index/ivf_band.py::_pq_tiles_core`` as it was before its rescore
    moved into ops/rescore.py (spans left out), kept here as the yardstick
    of the CPU path's answers."""
    tile_live = None
    if row_mask is not None:
        tile_live = row_mask.reshape(-1, tile_n).amax(dim=1) > 0
    q_s, order, dots, tile_table = ivf_band._plan_tiles(
        q, centroids, tile_window, tile_q, p_tiles, tile_live=tile_live)
    v, rows = pq_tiles_topk(
        codes, codebooks, q_s, tile_table, k_cand, centroid_tiles=centroid_tiles,
        tile_n=tile_n, tile_q=tile_q, l_buckets=l_buckets, n_valid=n_valid,
        row_major=True, local_ids=local_ids, n_pools=n_pools, row_mask=row_mask, l2=l2,
        top2=top2, row_bias=row_bias, segments=segments)
    if refine_scale > 0:
        valid = v > NEG_INF
        rows = rows.long().clamp(0, refine_rows.shape[0] - 1)
        b, kc = rows.shape
        scale = f32_const(refine_scale, q)
        half = f32_const(0.5, q)
        lists = None
        if refine_residual:
            lists = tile_window[rows // tile_n, local_ids.reshape(-1)[rows].long()].long()
        sub = rescore._rescore_cap(kc, b, halve=l2 and refine_residual)
        parts = []
        for s in range(0, b, sub):
            cand = refine_rows[rows[s:s + sub]].float()
            if refine_residual:
                qb = q_s[s:s + sub].to(torch.bfloat16).float()
                ex = torch.bmm(cand, qb[:, :, None])[:, :, 0] * scale
                if l2:
                    ca = centroids[lists[s:s + sub]]
                    ex = ex - half * (
                        (ca * ca).sum(dim=2)
                        + f32_const(2.0 * refine_scale, q) * (ca * cand).sum(dim=2)
                        + f32_const(refine_scale * refine_scale, q)
                        * (cand * cand).sum(dim=2))
            else:
                cand = cand * scale
                ex = torch.bmm(cand, q_s[s:s + sub, :, None])[:, :, 0]
                if l2:
                    ex = ex - half * (cand * cand).sum(dim=2)
            parts.append(ex)
        ex = torch.cat(parts)
        if refine_residual:
            ex = ex + torch.gather(dots[order], 1, lists)
        ex = torch.where(valid, ex, NEG_INF)
        v, pos = topk_stable(ex, k)
        rows = torch.gather(rows, 1, pos)
    else:
        v, rows = v[:, :k], rows[:, :k].long()
    v, rows = ivf_band._unsort(order, v, rows)
    if l2:
        v = f32_const(2.0, v) * v - (q * q).sum(dim=1, keepdim=True)
    return v, rows


def _corpus(n: int, d: int, seed: int):
    """Unit rows around 32 centres, and 40 queries near rows."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((32, d)).astype(np.float32)
    x = centres[rng.integers(0, 32, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, 40, replace=False)] + 0.05 * rng.standard_normal((40, d)).astype(
        np.float32)
    return x, q.astype(np.float32)


def _tiny_index(residual: bool, l2: bool, device="cpu"):
    x, q = _corpus(3000, 64, seed=5)
    idx = BandIVFPQIndex.build(x, nlist=16, m=8, nbits=6, kmeans_iters=6, pq_train_iters=6,
                               tile_n=256, tile_q=16, refine="int8", residual=residual,
                               metric="l2" if l2 else "ip", device=device)
    return idx, q


@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_pq_tiles_core_answers_are_the_parents(residual, l2, monkeypatch):
    idx, q = _tiny_index(residual, l2)
    kw = dict(k=10, refine_factor=8, p_tiles=6, tile_q=16)
    v, ids = idx.search_device(q, **kw)
    v_top2, ids_top2 = idx.search_device(q, top2=True, **kw)
    assert bool(torch.isfinite(v).all())
    monkeypatch.setattr(ivf_band, "_pq_tiles_core", _parent_pq_tiles_core)
    v_p, ids_p = idx.search_device(q, **kw)
    v_top2_p, ids_top2_p = idx.search_device(q, top2=True, **kw)
    for a, b in ((v, v_p), (ids, ids_p), (v_top2, v_top2_p), (ids_top2, ids_top2_p)):
        assert torch.equal(a, b)


def _wild_k5(clamp_to: int | None = None):
    """K5 whose rows are pushed past the refine rows (every third slot) and
    before the first (every seventh), then clamped to [0, clamp_to) if given."""
    def k5(*args, **kw):
        v, rows = pq_tiles_topk(*args, **kw)
        wild = rows.long().clone()
        wild[:, ::3] += 1 << 20
        wild[:, 1::7] = -wild[:, 1::7] - 1
        return v, wild if clamp_to is None else wild.clamp(0, clamp_to - 1)
    return k5


@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_rows_past_the_refine_rows_are_clamped(residual, l2, monkeypatch):
    idx, q = _tiny_index(residual, l2)
    kw = dict(k=10, refine_factor=8, p_tiles=6, tile_q=16)
    n_refine = []

    def rescore_in_range(q_s, v, rows, refine_rows, *args, **kw_):
        n_refine.append(refine_rows.shape[0])
        assert int(rows.min()) >= 0 and int(rows.max()) < refine_rows.shape[0]
        return rescore.rescore_int8(q_s, v, rows, refine_rows, *args, **kw_)

    monkeypatch.setattr(ivf_band, "rescore_int8", rescore_in_range)
    monkeypatch.setattr(ivf_band, "pq_tiles_topk", _wild_k5())
    v, ids = idx.search_device(q, **kw)
    monkeypatch.setattr(ivf_band, "pq_tiles_topk", _wild_k5(n_refine[0]))
    v_c, ids_c = idx.search_device(q, **kw)
    assert len(n_refine) == 2
    assert torch.equal(v, v_c) and torch.equal(ids, ids_c)


def _card_holds(a: dict, residual: bool, l2: bool, k: int = 10) -> None:
    """The kernel (the wrapper on CUDA tensors) against the plain version on
    the same tensors, before and after the stable top-k."""
    before = rescore.rescore_int8.launches
    ex = _call(rescore.rescore_int8, a, residual, l2)
    ref = _call(rescore.rescore_int8_reference, a, residual, l2)
    torch.cuda.synchronize()
    assert rescore.rescore_int8.launches == before + 1
    _assert_close(ex.cpu().numpy(), ref.cpu().numpy())
    v, pos = topk_stable(ex, k)
    v_ref, pos_ref = topk_stable(ref, k)
    _assert_same_topk(v.cpu().numpy(), pos.cpu().numpy(), v_ref.cpu().numpy(),
                      pos_ref.cpu().numpy())


@pytest.mark.card
@pytest.mark.parametrize("b,kc,d", [(24, 40, 32), (6, 9000, 32)], ids=["d32", "chunks"])
@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_kernel_matches_plain_tiny(residual, l2, b, kc, d, card):
    """A tiny shape, and more slots a query than the kernel stages in
    shared memory at once."""
    _card_holds(_inputs(6, b=b, kc=kc, d=d, n=200, device=card), residual, l2)


@pytest.mark.card
def test_kernel_refuses_d_not_a_multiple_of_4(card):
    a = _inputs(6, b=4, kc=8, d=30, n=50, device=card)
    before = rescore.rescore_int8.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        _call(rescore.rescore_int8, a, True, False)
    assert rescore.rescore_int8.launches == before


@pytest.mark.card
@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_kernel_matches_plain_at_the_cells_shape(residual, l2, card):
    a = _inputs(7, b=4096, kc=2050, d=768, n=1 << 20, nlist=4096, tile_n=1024, w=8,
                unfilled=0.02, device=card)
    _card_holds(a, residual, l2)


@pytest.mark.card
@pytest.mark.parametrize("residual,l2", VARIANTS, ids=VARIANT_IDS)
def test_search_device_launches_the_kernel_once(residual, l2, card):
    idx, q = _tiny_index(residual, l2, device=card)
    before = rescore.rescore_int8.launches
    v, _ = idx.search_device(q, k=10, refine_factor=8, p_tiles=6, tile_q=16)
    torch.cuda.synchronize()
    assert rescore.rescore_int8.launches == before + 1
    assert bool(torch.isfinite(v).all())
