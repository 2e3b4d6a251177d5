"""K5 (``pq_tiles_topk``) and K6 (``pq_topk``): the plain PyTorch versions,
which CPU tensors take, held to the reference's Pallas kernels in interpret
mode on the same numpy inputs.

Both sides meet the same bf16 operands (codebooks, centroid tiles, queries)
and sum the same f32 products, only in another order, so scores agree
within 1e-5 relative and ids are identical except between candidates whose
scores agree within that tolerance. Unfilled slots (-inf) must agree
exactly. The CUDA kernel is held to the same plain version on the card
(``chip_smoke.py::pq_checks``).

K5's filtered (``row_mask``) and l2 variants, alone and together and with
top-2, are held the same way; the l2 key's per-row bias route the kernel
takes (``pq_row_bias``, added after the split-form score) is held to the
Pallas kernel within 1e-4 against its own f64 recomputation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.ops.pallas_pq import pq_tiles_topk_pallas, pq_topk_pallas
from cloudvectordb_tpu_torch.ops import pq
from cloudvectordb_tpu_torch.ops.band import _bucket_merge, _bucket_merge_top2

RTOL = 1e-5


def _assert_same_topk(v, i, v_ref, i_ref):
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


def _tiles_inputs(seed, *, m=8, nbits=6, dsub=8, tile_n=128, n_tiles=5, w=3, nq=32,
                  tile_q=16, p=5):
    """Random K5 inputs: codes, codebooks, per-tile local bytes that rise
    through the tile window, bf16-rounded centroid tiles, a tile table with
    a repeated entry, n_valid cutting the last tile."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile_n
    d = m * dsub
    codes = rng.integers(0, 2 ** nbits, size=(n, m), dtype=np.uint8)
    local = np.zeros(n, np.uint8)
    for t in range(n_tiles):
        cuts = np.sort(rng.integers(0, tile_n, size=w - 1))
        local[t * tile_n:(t + 1) * tile_n] = np.searchsorted(cuts, np.arange(tile_n),
                                                             side="right")
    table = rng.integers(0, n_tiles, size=(nq // tile_q, p)).astype(np.int32)
    table[:, -1] = table[:, 0]  # plan padding repeats an entry
    table[0, 1] = n_tiles - 1  # the cut tile is scanned
    return dict(
        codes=codes, local=local,
        codebooks=rng.normal(size=(m, 2 ** nbits, dsub)).astype(np.float32),
        centroid_tiles=rng.normal(size=(n_tiles, w, d)).astype(np.float32),
        queries=rng.normal(size=(nq, d)).astype(np.float32),
        table=table, n_valid=n - tile_n // 3, tile_n=tile_n, tile_q=tile_q)


CASES = [  # (residual, row_major, n_pools, top2, l_buckets)
    (True, True, 1, False, 0),
    (True, True, 2, True, 32),
    (True, False, 3, False, 64),
    (True, False, 1, True, 0),
    (False, True, 2, False, 32),
    (False, True, 3, True, 32),
    (False, False, 1, True, 128),
    (True, True, 3, True, 16),
]


@pytest.mark.parametrize("residual,row_major,n_pools,top2,l_buckets", CASES)
def test_pq_tiles_topk_matches_the_reference(residual, row_major, n_pools, top2, l_buckets):
    a = _tiles_inputs(seed=n_pools + 10 * top2 + 100 * residual + 1000 * row_major)
    if row_major:
        codes_j, codes_t = jnp.asarray(a["codes"]), torch.from_numpy(a["codes"])
    else:  # code-major, the local byte in row m
        cm = a["codes"].T
        if residual:
            cm = np.concatenate([cm, a["local"][None, :]])
        codes_j, codes_t = jnp.asarray(cm), torch.from_numpy(np.ascontiguousarray(cm))
    ct = a["centroid_tiles"] if residual else None
    kw = dict(tile_n=a["tile_n"], tile_q=a["tile_q"], l_buckets=l_buckets,
              n_valid=a["n_valid"], row_major=row_major, n_pools=n_pools, top2=top2)
    k = 40
    v_j, i_j = pq_tiles_topk_pallas(
        codes_j, jnp.asarray(a["codebooks"]), jnp.asarray(a["queries"]),
        jnp.asarray(a["table"]), k,
        centroid_tiles=None if ct is None else jnp.asarray(ct, jnp.bfloat16),
        local_ids=jnp.asarray(a["local"][None, :]) if row_major and residual else None,
        interpret=True, **kw)
    local_t = torch.from_numpy(a["local"][None, :]) if row_major and residual else None
    args = (codes_t, torch.from_numpy(a["codebooks"]), torch.from_numpy(a["queries"]),
            torch.from_numpy(a["table"]), k)
    kw_t = dict(kw, centroid_tiles=None if ct is None else torch.from_numpy(ct),
                local_ids=local_t)
    before = pq.pq_tiles_topk.launches
    v_t, i_t = pq.pq_tiles_topk(*args, **kw_t)
    assert pq.pq_tiles_topk.launches == before  # CPU tensors take the plain version
    assert i_t.dtype == torch.int32 and v_t.shape == (a["queries"].shape[0], k)
    _assert_same_topk(v_t.numpy(), i_t.numpy(), v_j, i_j)
    v_r, i_r = pq.pq_tiles_topk_reference(*args, **kw_t)
    assert torch.equal(v_r, v_t) and torch.equal(i_r, i_t)


@pytest.mark.parametrize("n,l_buckets", [(1000, 0), (1300, 128)])
def test_pq_topk_matches_the_reference(n, l_buckets):
    """K6 over a ragged N (not a multiple of tile_n)."""
    rng = np.random.default_rng(n)
    m, nbits, dsub = 8, 5, 8
    codes = rng.integers(0, 2 ** nbits, size=(m, n), dtype=np.uint8)
    cb = rng.normal(size=(m, 2 ** nbits, dsub)).astype(np.float32)
    q = rng.normal(size=(20, m * dsub)).astype(np.float32)
    kw = dict(tile_n=256, l_buckets=l_buckets)
    v_j, i_j = pq_topk_pallas(jnp.asarray(codes), jnp.asarray(cb), jnp.asarray(q), 10,
                              tile_q=16, interpret=True, **kw)
    v_t, i_t = pq.pq_topk(torch.from_numpy(codes), torch.from_numpy(cb),
                          torch.from_numpy(q), 10, **kw)
    assert pq.pq_topk.launches == 0
    _assert_same_topk(v_t.numpy(), i_t.numpy(), v_j, i_j)
    assert int(i_t.max()) < n


def test_unported_options_raise():
    """What K5 refuses: a bad mask, a bias without l2, residual codes
    without local ids, and malformed segments (a cut that is not whole
    tiles or misses rows, a parallel tuple of the wrong length, a segment
    without its pad tile, n_live_tiles past the arena)."""
    a = _tiles_inputs(seed=1)
    args = (torch.from_numpy(a["codes"]), torch.from_numpy(a["codebooks"]),
            torch.from_numpy(a["queries"]), torch.from_numpy(a["table"]), 10)
    kw = dict(tile_n=a["tile_n"], tile_q=a["tile_q"], row_major=True)
    tile_n = a["tile_n"]
    for bad in (dict(segments=[tile_n, 3 * tile_n]), dict(segments=[100, 5 * tile_n - 100]),
                dict(n_live_tiles=6)):
        with pytest.raises(ValueError):
            pq.pq_tiles_topk(*args, **kw, **bad)
    two = (args[0][:2 * tile_n], args[0][2 * tile_n:])
    with pytest.raises(ValueError):  # three n_valid for two segments
        pq.pq_tiles_topk(two, *args[1:], **kw, n_valid=(1, 2, 3))
    with pytest.raises(ValueError):  # a one-tile segment has no pad tile
        pq.pq_tiles_topk((args[0][:tile_n],), *args[1:], **kw)
    n = a["codes"].shape[0]
    for bad in (dict(row_mask=torch.ones(1, n - 1, dtype=torch.int8)),
                dict(row_bias=torch.zeros(n))):
        with pytest.raises(ValueError):
            pq.pq_tiles_topk(*args, **kw, **bad)
    with pytest.raises(ValueError):  # residual row-major codes need local ids
        pq.pq_tiles_topk(*args, centroid_tiles=torch.from_numpy(a["centroid_tiles"]), **kw)


#: K5's contract variants held to the reference: (residual, n_pools, top2,
#: l_buckets, masked, l2)
VARIANT_CASES = [
    (True, 1, False, 0, True, False),    # masked
    (True, 2, False, 32, False, True),   # l2
    (True, 2, False, 32, True, True),    # masked + l2
    (True, 2, True, 32, True, False),    # masked + top-2
    (False, 3, True, 16, True, True),    # all at once, no residual term
    (True, 1, True, 0, True, True),      # all at once, R 1
]


def _mask(n: int, seed: int) -> np.ndarray:
    """(N,) int8 allow bits: a 6% random filter with one tile all but
    disallowed, so that queries run short of allowed rows."""
    rng = np.random.default_rng(seed)
    m = (rng.random(n) < 0.06).astype(np.int8)
    m[128:256] = 0
    m[200] = 1
    return m


@pytest.mark.parametrize("residual,n_pools,top2,l_buckets,masked,l2", VARIANT_CASES)
def test_pq_tiles_variants_match_the_reference(residual, n_pools, top2, l_buckets, masked, l2):
    """Filtered and l2 K5 (and both, and with top-2) against the Pallas
    kernel in interpret mode: ids equal but at ties, scores within 1e-5
    relative, unfilled slots equal; no disallowed row in a filled slot; the
    plain version with the precomputed bias (the kernel's route) equal to
    the wrapper's within 1e-5 (the bias is the same sum in another order)."""
    a = _tiles_inputs(seed=7 + n_pools + 10 * top2 + 100 * masked + 1000 * l2)
    n = a["codes"].shape[0]
    mask = _mask(n, n_pools) if masked else None
    ct = a["centroid_tiles"] if residual else None
    kw = dict(tile_n=a["tile_n"], tile_q=a["tile_q"], l_buckets=l_buckets,
              n_valid=a["n_valid"], row_major=True, n_pools=n_pools, top2=top2, l2=l2)
    k = 40
    v_j, i_j = pq_tiles_topk_pallas(
        jnp.asarray(a["codes"]), jnp.asarray(a["codebooks"]), jnp.asarray(a["queries"]),
        jnp.asarray(a["table"]), k,
        centroid_tiles=None if ct is None else jnp.asarray(ct, jnp.bfloat16),
        local_ids=jnp.asarray(a["local"][None, :]) if residual else None,
        row_mask=None if mask is None else jnp.asarray(mask[None, :]),
        interpret=True, **kw)
    args = (torch.from_numpy(a["codes"]), torch.from_numpy(a["codebooks"]),
            torch.from_numpy(a["queries"]), torch.from_numpy(a["table"]), k)
    kw_t = dict(kw, centroid_tiles=None if ct is None else torch.from_numpy(ct),
                local_ids=torch.from_numpy(a["local"][None, :]) if residual else None,
                row_mask=None if mask is None else torch.from_numpy(mask[None, :]))
    v_t, i_t = pq.pq_tiles_topk(*args, **kw_t)
    assert pq.pq_tiles_topk.launches == 0
    _assert_same_topk(v_t.numpy(), i_t.numpy(), v_j, i_j)
    if masked:
        filled = np.isfinite(v_t.numpy())
        assert (mask[i_t.numpy()[filled]] == 1).all()
        assert (~filled).any()  # the sparse tile leaves some queries short
    if l2:
        bias = pq.pq_row_bias(args[0], kw_t["local_ids"], args[1], kw_t["centroid_tiles"],
                              a["tile_n"])
        assert pq.pq_row_bias.launches == 0
        v_b, i_b = pq.pq_tiles_topk_reference(*args, **kw_t, row_bias=bias)
        _assert_same_topk(v_b.numpy(), i_b.numpy(), v_t.numpy(), i_t.numpy())


def test_pq_row_bias_is_the_exact_norm():
    """pq_row_bias (CPU: its plain version) against -|x|^2/2 recomputed in
    f64 from the bf16 codewords and centroid rows, residual and not."""
    a = _tiles_inputs(seed=3)
    codes, local = torch.from_numpy(a["codes"]), torch.from_numpy(a["local"])
    cb = torch.from_numpy(a["codebooks"])
    ct = torch.from_numpy(a["centroid_tiles"])
    m = codes.shape[1]
    x = cb.to(torch.bfloat16).double()[torch.arange(m), codes.long()].reshape(codes.shape[0], -1)
    for resid in (False, True):
        want = x + (ct.to(torch.bfloat16).double()[torch.arange(codes.shape[0]) // a["tile_n"],
                                                   local.long()] if resid else 0.0)
        got = pq.pq_row_bias(codes, local if resid else None, cb, ct if resid else None,
                             a["tile_n"])
        exact = -0.5 * (want * want).sum(1)
        assert got.dtype == torch.float32
        assert float((got.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())
    with pytest.raises(ValueError):
        pq.pq_row_bias(codes, local, cb, None, a["tile_n"])


def _split_form_topk(a, residual: bool, n_pools: int, top2: bool, l_buckets: int, k: int,
                     mask=None, l2: bool = False):
    """The card kernel's arithmetic (csrc/pq_scan.cu), written in torch: the
    bf16 query times the bf16 concatenation of a row's codewords in f32,
    plus, in residual mode, C[q, w] = q · ct[tile, w] (f32) added after by
    the row's local byte; with l2, plus the row's bias -|x|^2/2 (f32 x
    squared in f64, as pq_bias_kernel); a mask byte of 0 scores -inf; then
    the bucketed merge and the final top-k of ops/band.py and ops/pq.py."""
    codes = torch.from_numpy(a["codes"]).long()
    local = torch.from_numpy(a["local"]).long()
    cb = torch.from_numpy(a["codebooks"]).to(torch.bfloat16).float()
    q = torch.from_numpy(a["queries"]).to(torch.bfloat16).float()
    ct = torch.from_numpy(a["centroid_tiles"]).to(torch.bfloat16).float()
    table = torch.from_numpy(a["table"]).long()
    tile_n, tile_q, n_valid = a["tile_n"], a["tile_q"], a["n_valid"]
    n, m = codes.shape
    d = q.shape[1]
    n_qt, steps = table.shape
    lb = l_buckets or tile_n
    rows = cb[torch.arange(m), codes].reshape(n, d)  # every row's codewords, bf16 values
    bias = None
    if l2:
        x = rows + (ct[torch.arange(n) // tile_n, local] if residual else 0.0)
        bias = (-0.5 * (x.double() * x.double()).sum(1)).float()
    qt = q.view(n_qt, tile_q, d)
    n_slots = n_pools * (2 if top2 else 1)
    best_v = torch.full((n_slots, n_qt, tile_q, lb), float("-inf"))
    best_i = torch.zeros((n_slots, n_qt, tile_q, lb), dtype=torch.int64)
    for j in range(steps):
        t = table[:, j]
        g = t[:, None] * tile_n + torch.arange(tile_n)
        scores = torch.bmm(qt, rows[g].transpose(1, 2))
        if residual:
            c = torch.bmm(qt, ct[t].transpose(1, 2))  # (n_qt, tile_q, W)
            scores = scores + torch.gather(c, 2, local[g][:, None, :].expand(-1, tile_q, -1))
        if bias is not None:
            scores = scores + bias[g][:, None, :]
        live = g < n_valid
        if mask is not None:
            live = live & (torch.from_numpy(mask)[g] != 0)
        scores = torch.where(live[:, None, :], scores, float("-inf"))
        pid, base = j % n_pools, t * tile_n
        if top2:
            s1, s2 = 2 * pid, 2 * pid + 1
            best_v[s1], best_i[s1], best_v[s2], best_i[s2] = _bucket_merge_top2(
                scores, base, lb, best_v[s1], best_i[s1], best_v[s2], best_i[s2])
        else:
            best_v[pid], best_i[pid] = _bucket_merge(scores, base, lb, best_v[pid], best_i[pid])
    nq = n_qt * tile_q
    return pq._slots_topk(best_v.view(n_slots, nq, lb), best_i.view(n_slots, nq, lb).int(), k)


@pytest.mark.parametrize("top2", [False, True])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("m,dsub,nbits", [(64, 12, 8), (8, 8, 6), (6, 5, 8)])
def test_tensor_core_split_form_holds_to_the_reference(m, dsub, nbits, residual, top2):
    """The kernel's split form (codeword term on bf16 tensor cores, centroid
    term once per table entry and added by local byte) against the Pallas
    kernel in interpret mode, as the card run holds the kernel: ids >= 0.999
    equal, |dscore| <= 1e-4, mismatches only at near-ties. Inputs scaled
    so that scores are of order one, as in the card checks. dsub 5 (D 30)
    is the shape at which the kernel reads one codebook value at a time and
    pads the depth past D."""
    a = _tiles_inputs(seed=m + dsub + 2 * residual + top2, m=m, nbits=nbits, dsub=dsub)
    d = m * dsub
    for key in ("codebooks", "centroid_tiles", "queries"):
        a[key] = a[key] / np.float32(np.sqrt(d))
    n_pools, l_buckets, k = 2, 32, 40
    v_ref, i_ref = pq_tiles_topk_pallas(
        jnp.asarray(a["codes"]), jnp.asarray(a["codebooks"]), jnp.asarray(a["queries"]),
        jnp.asarray(a["table"]), k,
        centroid_tiles=jnp.asarray(a["centroid_tiles"], jnp.bfloat16) if residual else None,
        local_ids=jnp.asarray(a["local"][None, :]) if residual else None,
        tile_n=a["tile_n"], tile_q=a["tile_q"], l_buckets=l_buckets, n_valid=a["n_valid"],
        row_major=True, n_pools=n_pools, top2=top2, interpret=True)
    v, i = _split_form_topk(a, residual, n_pools, top2, l_buckets, k)
    v, i, v_ref, i_ref = v.numpy(), i.numpy(), np.asarray(v_ref), np.asarray(i_ref)
    live = np.isfinite(v_ref)
    np.testing.assert_array_equal(live, np.isfinite(v))
    diff = np.abs(v - v_ref)
    assert diff[live].max(initial=0.0) <= 1e-4
    same = i == i_ref
    assert same.mean() >= 0.999
    assert np.all(diff[~same & live] <= 1e-4)  # a differing id is a near-tie


@pytest.mark.parametrize("masked,l2", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("m,dsub,nbits", [(64, 12, 8), (6, 5, 8)])
def test_split_form_variants_hold_to_the_reference(m, dsub, nbits, masked, l2):
    """The kernel's split form with the mask byte and the per-row l2 bias
    (the route csrc/pq_scan.cu takes) against the Pallas kernel's masked and
    l2 variants in interpret mode, residual with top-2: |dscore| <= 1e-4,
    ids >= 0.999 equal, mismatches only at near-ties."""
    a = _tiles_inputs(seed=m + dsub + 5 * masked + 7 * l2, m=m, nbits=nbits, dsub=dsub)
    d = m * dsub
    for key in ("codebooks", "centroid_tiles", "queries"):
        a[key] = a[key] / np.float32(np.sqrt(d))
    mask = _mask(a["codes"].shape[0], m) if masked else None
    n_pools, l_buckets, k = 2, 32, 40
    v_ref, i_ref = pq_tiles_topk_pallas(
        jnp.asarray(a["codes"]), jnp.asarray(a["codebooks"]), jnp.asarray(a["queries"]),
        jnp.asarray(a["table"]), k, centroid_tiles=jnp.asarray(a["centroid_tiles"], jnp.bfloat16),
        local_ids=jnp.asarray(a["local"][None, :]),
        row_mask=None if mask is None else jnp.asarray(mask[None, :]),
        tile_n=a["tile_n"], tile_q=a["tile_q"], l_buckets=l_buckets, n_valid=a["n_valid"],
        row_major=True, n_pools=n_pools, top2=True, l2=l2, interpret=True)
    v, i = _split_form_topk(a, True, n_pools, True, l_buckets, k, mask=mask, l2=l2)
    v, i, v_ref, i_ref = v.numpy(), i.numpy(), np.asarray(v_ref), np.asarray(i_ref)
    live = np.isfinite(v_ref)
    np.testing.assert_array_equal(live, np.isfinite(v))
    diff = np.abs(v - v_ref)
    assert diff[live].max(initial=0.0) <= 1e-4
    same = i == i_ref
    assert same.mean() >= 0.999
    assert np.all(diff[~same & live] <= 1e-4)


#: K5's segmented dispatch held to the reference's (pallas_pq.py:364-388):
#: (residual, n_pools, top2, l_buckets, masked, l2)
SEGMENT_CASES = [
    (True, 1, False, 0, False, False),   # ip
    (True, 2, False, 32, False, True),   # l2, two pools
    (True, 1, False, 0, True, False),    # row mask
    (True, 2, True, 32, True, False),    # row mask, top-2, two pools
    (False, 2, True, 16, True, True),    # all at once, no residual term
]
#: the segment cap of these cases, in tiles: 5 tiles -> segments of 2, 2, 1
SEG_TILES = 2


def _segmented(a: dict, mask):
    """The reference's segmented form of a joined row-major arena: each
    segment of SEG_TILES tiles (the last shorter) with a trailing zero pad
    tile, and the parallel tuples of centroid tiles (a zero pad tile),
    local bytes and mask bytes (zero on the pad tile) and real row counts;
    with the row counts of the cut (``segments=``)."""
    tile_n, n = a["tile_n"], a["codes"].shape[0]
    rows = [min(SEG_TILES * tile_n, n - off) for off in range(0, n, SEG_TILES * tile_n)]
    pad = lambda x: np.concatenate([x, np.zeros((tile_n, *x.shape[1:]), x.dtype)])  # noqa: E731
    out = dict(codes=[], ct=[], local=[], mask=[], n_valid=[])
    off = 0
    for r in rows:
        out["codes"].append(pad(a["codes"][off:off + r]))
        ct = a["centroid_tiles"][off // tile_n:(off + r) // tile_n]
        out["ct"].append(np.concatenate([ct, np.zeros_like(ct[:1])]))
        out["local"].append(pad(a["local"][off:off + r])[None, :])
        if mask is not None:
            out["mask"].append(pad(mask[off:off + r])[None, :])
        out["n_valid"].append(int(np.clip(a["n_valid"] - off, 0, r)))
        off += r
    return out, rows


def _segment_table(a: dict) -> np.ndarray:
    """A tile table whose query tiles read tiles of every segment, one of
    them only tiles of the first, with a repeated entry."""
    t = np.array(a["table"])
    n_tiles = a["codes"].shape[0] // a["tile_n"]
    t[0] = np.arange(t.shape[1]) % n_tiles
    t[1] = 0
    t[1, 1] = 1
    return t


@pytest.mark.parametrize("residual,n_pools,top2,l_buckets,masked,l2", SEGMENT_CASES)
def test_pq_tiles_segmented_matches_the_reference(residual, n_pools, top2, l_buckets, masked,
                                                  l2):
    """The reference's segmented form (a tuple of segments, each with its
    pad tile, and parallel tuples) into both packages: ids equal but at
    ties, scores within 1e-5 relative, unfilled slots equal, no disallowed
    row in a filled slot. The port's view form (one joined arena cut by
    ``segments=``) equals its tuple form exactly, and K5 with every table
    entry skipped (``n_live_tiles`` 0) fills no slot."""
    a = _tiles_inputs(seed=31 + n_pools + 10 * top2 + 100 * masked + 1000 * l2, n_tiles=5)
    a["table"] = _segment_table(a)
    n = a["codes"].shape[0]
    mask = _mask(n, n_pools) if masked else None
    seg, rows = _segmented(a, mask)
    assert len(rows) == 3
    kw = dict(tile_n=a["tile_n"], tile_q=a["tile_q"], l_buckets=l_buckets, row_major=True,
              n_pools=n_pools, top2=top2, l2=l2)
    k = 40
    v_j, i_j = pq_tiles_topk_pallas(
        tuple(jnp.asarray(c) for c in seg["codes"]), jnp.asarray(a["codebooks"]),
        jnp.asarray(a["queries"]), jnp.asarray(a["table"]), k,
        centroid_tiles=tuple(jnp.asarray(c, jnp.bfloat16) for c in seg["ct"]) if residual
        else None,
        local_ids=tuple(jnp.asarray(x) for x in seg["local"]) if residual else None,
        n_valid=tuple(seg["n_valid"]),
        row_mask=tuple(jnp.asarray(x) for x in seg["mask"]) if masked else None,
        interpret=True, **kw)
    t = torch.from_numpy
    head = (t(a["codebooks"]), t(a["queries"]), t(a["table"]), k)
    v_t, i_t = pq.pq_tiles_topk(
        tuple(t(c) for c in seg["codes"]), *head,
        centroid_tiles=tuple(t(c) for c in seg["ct"]) if residual else None,
        local_ids=tuple(t(x) for x in seg["local"]) if residual else None,
        n_valid=tuple(seg["n_valid"]),
        row_mask=tuple(t(x) for x in seg["mask"]) if masked else None, **kw)
    assert pq.pq_tiles_topk.launches == pq.pq_tiles_topk.seg_launches == 0
    _assert_same_topk(v_t.numpy(), i_t.numpy(), v_j, i_j)
    if masked:
        filled = np.isfinite(v_t.numpy())
        assert (mask[i_t.numpy()[filled]] == 1).all()
    v_w, i_w = pq.pq_tiles_topk(
        t(a["codes"]), *head, centroid_tiles=t(a["centroid_tiles"]) if residual else None,
        local_ids=t(a["local"]) if residual else None, n_valid=a["n_valid"],
        row_mask=t(mask) if masked else None, segments=rows, **kw)
    assert torch.equal(v_w, v_t) and torch.equal(i_w, i_t)
    v_r, i_r = pq.pq_tiles_topk_reference(
        t(a["codes"]), *head, centroid_tiles=t(a["centroid_tiles"]) if residual else None,
        local_ids=t(a["local"]) if residual else None, n_valid=a["n_valid"],
        row_mask=t(mask) if masked else None, segments=rows, **kw)
    assert torch.equal(v_r, v_t) and torch.equal(i_r, i_t)
    if l2:  # the kernel's route: the joined arena's bias, cut with it
        bias = pq.pq_row_bias(t(a["codes"]), t(a["local"]) if residual else None,
                              head[0], t(a["centroid_tiles"]) if residual else None,
                              a["tile_n"])
        v_b, i_b = pq.pq_tiles_topk_reference(
            t(a["codes"]), *head, centroid_tiles=t(a["centroid_tiles"]) if residual else None,
            local_ids=t(a["local"]) if residual else None, n_valid=a["n_valid"],
            row_mask=t(mask) if masked else None, segments=rows, row_bias=bias, **kw)
        _assert_same_topk(v_b.numpy(), i_b.numpy(), v_t.numpy(), i_t.numpy())
    v0, _ = pq.pq_tiles_topk(
        t(a["codes"]), *head, centroid_tiles=t(a["centroid_tiles"]) if residual else None,
        local_ids=t(a["local"]) if residual else None, n_valid=a["n_valid"],
        n_live_tiles=0, **{**kw, "row_major": True})
    assert not np.isfinite(v0.numpy()).any()


def test_pq_tiles_segments_widen_the_joined_pools():
    """Each segment keeps its own pools, so the segmented candidates are a
    superset of the joined arena's: every filled slot of the joined
    dispatch is among the segmented dispatch's, with the same score (k at
    the joined dispatch's slot count, R 1, one pool)."""
    a = _tiles_inputs(seed=77, n_tiles=5)
    a["table"] = _segment_table(a)
    t = torch.from_numpy
    args = (t(a["codes"]), t(a["codebooks"]), t(a["queries"]), t(a["table"]))
    kw = dict(tile_n=a["tile_n"], tile_q=a["tile_q"], n_valid=a["n_valid"], row_major=True,
              centroid_tiles=t(a["centroid_tiles"]), local_ids=t(a["local"]))
    k = a["tile_n"]
    vj, ij = pq.pq_tiles_topk(*args, k, **kw)
    _, rows = _segmented(a, None)
    vs, is_ = pq.pq_tiles_topk(*args, 3 * k, segments=rows, **kw)
    for b in range(vj.shape[0]):
        got = {i: v for i, v in zip(is_[b].tolist(), vs[b].tolist()) if np.isfinite(v)}
        for i, v in zip(ij[b].tolist(), vj[b].tolist()):
            if np.isfinite(v):
                assert got[i] == v


def test_pq_tiles_segmented_unfilled_slots():
    """A reference fault, recorded: the reference adds each segment's row
    offset to every slot of its top-k (pallas_pq.py:384), unfilled ones too,
    so where k exceeds a segment's slot count (n_pools·L) and the merge
    reaches a later segment's unfilled slots, they carry that segment's
    first row, a real row. The port adds the offset to filled slots only:
    its unfilled slots keep the joined dispatch's row 0. In an index k
    never exceeds the slot count, so the first segment's unfilled slots
    come first and the fault does not show there."""
    a = _tiles_inputs(seed=78, n_tiles=5)
    a["table"] = _segment_table(a)
    a["table"][:, :] = 0  # one tile read: at most tile_n candidates
    seg, rows = _segmented(a, None)
    k, l_buckets = 48, 16  # 16 slots a segment, 48 over three
    kw = dict(tile_n=a["tile_n"], tile_q=a["tile_q"], l_buckets=l_buckets, row_major=True)
    v_j, i_j = pq_tiles_topk_pallas(
        tuple(jnp.asarray(c) for c in seg["codes"]), jnp.asarray(a["codebooks"]),
        jnp.asarray(a["queries"]), jnp.asarray(a["table"]), k,
        centroid_tiles=tuple(jnp.asarray(c, jnp.bfloat16) for c in seg["ct"]),
        local_ids=tuple(jnp.asarray(x) for x in seg["local"]), n_valid=tuple(seg["n_valid"]),
        interpret=True, **kw)
    t = torch.from_numpy
    v_t, i_t = pq.pq_tiles_topk(
        t(a["codes"]), t(a["codebooks"]), t(a["queries"]), t(a["table"]), k,
        centroid_tiles=t(a["centroid_tiles"]), local_ids=t(a["local"]),
        n_valid=a["n_valid"], segments=rows, **kw)
    v_j, i_j, v_t, i_t = np.asarray(v_j), np.asarray(i_j), v_t.numpy(), i_t.numpy()
    unfilled = ~np.isfinite(v_j)
    np.testing.assert_array_equal(unfilled, ~np.isfinite(v_t))
    assert unfilled[:, :16].sum() == 0 and unfilled[:, 16:].all()
    starts = {0, rows[0], rows[0] + rows[1]}
    assert set(np.unique(i_j[unfilled])) == starts - {0}  # real rows of segments 1, 2
    assert (i_t[unfilled] == 0).all()  # the joined dispatch's unfilled row
    _assert_same_topk(v_t, i_t, v_j, i_j)
