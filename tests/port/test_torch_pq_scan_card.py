"""K5 and K6 (csrc/pq_scan.cu) at both block widths, on the card.

The kernel holds 64 queries a block where the query tile is a multiple of
64, R = 1 and the scan is unmasked and ranks by inner product
(``block_queries``, bound as ``cvdb_pq_scan_block_queries``), else 32. Both
widths
sum each (query, row) score in the same f32 order, so a query tile of 64
(or 128) must give, bit for bit, the slots that the same queries give at
tile_q 32 with each table row repeated 2 (or 4) times: the 32-query
blocks' work. Held so for residual and whole rows, top-1 and top-2, one
and two pools, and R = 1, R > 1, a row mask and l2 (where both runs take
32), at D 768
(m 64, dsub 12: one 8-byte codebook load a lane) and at D 30 (dsub 5: a
value at a time); each wide run is also held to the plain version. K6 (the
ALL source, tile_q = the batch) at 256 queries (64 a block) is held to the
plain version and to the same queries run inside a batch of 288 (32 a
block). The rule falls back to 32 where the 64-query block's shared
memory overflows, and K5's ``cvdb.scan`` span counts its reads at the
width each launch reports.

Every test is marked ``card`` and skips without one. tests/conftest.py
imports JAX, which the card's machine does not have, so there this file
runs alone: ``python -m pytest --noconftest -p no:cacheprovider
tests/port/test_torch_pq_scan_card.py -m card``. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

from cloudvectordb_tpu_torch.ops import pq
from cloudvectordb_tpu_torch.ops.band import SCAN_ALL, SCAN_TABLE
from cloudvectordb_tpu_torch.utils import metrics

RTOL = 1e-4  # the kernel against the plain version: the same products, another f32 order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _block_queries(tile_q, tile_n, l_buckets, m, dsub, w, top2, mask, l2) -> int:
    """csrc/pq_scan.cu's rule, from the library (l_buckets 0: tile_n)."""
    from cloudvectordb_tpu_torch.ops import _cuda

    return _cuda._load("pq_scan").cvdb_pq_scan_block_queries(
        tile_q, tile_n, l_buckets or tile_n, m, dsub, w, int(top2), int(mask), int(l2))


def _inputs(seed, dev, *, m, dsub, tile_n, n_tiles, w, nq, p, residual, mask, l2):
    """Random K5 inputs on ``dev``, prepared as the wrapper prepares them
    (``pq._tiles_args``): rows of n_tiles tiles, local bytes rising through
    each tile's window of w lists, a table with a repeated entry and the
    cut tile, n_valid cutting the last tile, a 20% row mask, the l2 bias."""
    rng = np.random.default_rng(seed)
    n, d = n_tiles * tile_n, m * dsub
    local = np.zeros(n, np.uint8)
    for t in range(n_tiles):
        cuts = np.sort(rng.integers(0, tile_n, size=w - 1))
        local[t * tile_n:(t + 1) * tile_n] = np.searchsorted(cuts, np.arange(tile_n),
                                                             side="right")
    table = rng.integers(0, n_tiles, size=(nq // 32, p)).astype(np.int32)
    table[:, -1] = table[:, 0]  # plan padding repeats an entry
    table[0, 1] = n_tiles - 1
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    codes = t(rng.integers(0, 256, size=(n, m), dtype=np.uint8))
    cb = t(rng.normal(size=(m, 256, dsub)).astype(np.float32) / np.sqrt(d))
    ct = t(rng.normal(size=(n_tiles, w, d)).astype(np.float32) / np.sqrt(d)) if residual else None
    q = t(rng.normal(size=(nq, d)).astype(np.float32) / np.sqrt(d))
    row_mask = t((rng.random(n) < 0.2).astype(np.int8)) if mask else None
    codes, loc, cb, ct, q, _, n_valid, row_mask = pq._tiles_args(
        codes, cb, q, t(table), ct, tile_n, 32, 0, n - tile_n // 3, True,
        t(local) if residual else None, 1, None, row_mask, l2)
    bias = pq.pq_row_bias(codes, loc, cb, ct, tile_n=tile_n) if l2 else None
    return dict(codes=codes, local=loc, cb=cb, ct=ct, q=q, n_valid=n_valid, row_mask=row_mask,
                row_bias=bias, table=table, tile_n=tile_n)


def _slots(a, table: np.ndarray, tile_q: int, *, l_buckets, n_pools, top2, plain=False):
    """(values, rows) of every slot of K5 at ``tile_q`` over ``table``."""
    tab = torch.as_tensor(table, device=a["codes"].device)
    v, i, block_q = pq._pq_slots(
        SCAN_TABLE, a["codes"], a["local"], a["cb"], a["ct"], a["q"], tab, tab.shape[1],
        tile_n=a["tile_n"], tile_q=tile_q, l_buckets=l_buckets or a["tile_n"],
        n_valid=a["n_valid"], n_pools=n_pools, top2=top2, plain=plain,
        row_mask=a["row_mask"], l2=a["row_bias"] is not None, row_bias=a["row_bias"])
    assert (block_q == 0) == plain
    torch.cuda.synchronize()
    return v.cpu().numpy(), i.cpu().numpy()


def _assert_held(got, ref):
    """Slots of the kernel against the plain version's: the same unfilled
    slots, values within RTOL of max(|v|, 1), a differing row only between
    scores within it."""
    (v, i), (v_ref, i_ref) = got, ref
    live = np.isfinite(v_ref)
    np.testing.assert_array_equal(live, np.isfinite(v))
    tol = RTOL * np.maximum(np.abs(v_ref[live]), 1.0)
    assert np.all(np.abs(v[live] - v_ref[live]) <= tol)
    assert (((i != i_ref) & live).mean()) <= 0.01


#: D 768 as the cells run it, and D 30 (dsub 5: a codebook value at a time)
WIDE = dict(m=64, dsub=12, tile_n=1024, n_tiles=12, w=24, nq=256, p=8)
NARROW_D = dict(m=6, dsub=5, tile_n=512, n_tiles=9, w=70, nq=256, p=7)
#: (shape, residual, top2, mask, l2, n_pools, l_buckets); l_buckets below
#: tile_n is R > 1, and a masked or l2 scan, where both widths' runs take 32
#: queries a block
CASES = [
    (WIDE, True, True, False, False, 2, 0),  # the opqpq10m.b4096 cell's variant
    (WIDE, True, False, False, False, 1, 0),
    (WIDE, False, True, False, False, 1, 0),
    (WIDE, True, True, True, False, 2, 0),
    (WIDE, True, False, False, True, 2, 0),
    (WIDE, False, False, True, True, 1, 0),
    (WIDE, True, True, False, False, 2, 256),
    (WIDE, False, False, True, False, 1, 512),
    (NARROW_D, True, True, False, False, 2, 0),
    (NARROW_D, True, True, True, True, 2, 0),
    (NARROW_D, False, False, False, False, 1, 0),
    (NARROW_D, True, False, True, False, 2, 128),
]
CASE_IDS = [f"{'D768' if s is WIDE else 'D30'}-{'resid' if r else 'whole'}"
            f"{'-top2' if t2 else ''}{'-mask' if mk else ''}{'-l2' if l2 else ''}"
            f"-pools{pl}-L{lb or 'tile_n'}" for s, r, t2, mk, l2, pl, lb in CASES]


@pytest.mark.card
@pytest.mark.parametrize("tile_q", [64, 128])
@pytest.mark.parametrize("shape,residual,top2,mask,l2,n_pools,l_buckets", CASES, ids=CASE_IDS)
def test_wide_block_equals_the_repeated_table_at_tile_q_32(
        shape, residual, top2, mask, l2, n_pools, l_buckets, tile_q, card):
    a = _inputs(7 + tile_q, card, residual=residual, mask=mask, l2=l2, **shape)
    tiles = shape["tile_n"]
    qb = _block_queries(tile_q, tiles, l_buckets, shape["m"], shape["dsub"],
                        shape["w"] if residual else 0, top2, mask, l2)
    assert qb == (64 if l_buckets in (0, tiles) and not (mask or l2) else 32)
    rep = tile_q // 32
    # the 32-query tiles of one wide tile scan its table row
    table = a["table"][::rep]
    kw = dict(l_buckets=l_buckets, n_pools=n_pools, top2=top2)
    wide = _slots(a, table, tile_q, **kw)
    narrow = _slots(a, np.repeat(table, rep, axis=0), 32, **kw)
    np.testing.assert_array_equal(wide[1], narrow[1])
    np.testing.assert_array_equal(wide[0].view(np.uint32), narrow[0].view(np.uint32))
    _assert_held(wide, _slots(a, table, tile_q, plain=True, **kw))


@pytest.mark.card
def test_all_source_at_64_a_block_holds(card):
    """K6 at 256 queries (64 a block) against its plain version, and bit
    for bit against the same queries among 288 (32 a block)."""
    rng = np.random.default_rng(11)
    m, dsub, n = 64, 12, 7777
    d = m * dsub
    codes = torch.as_tensor(rng.integers(0, 256, size=(m, n), dtype=np.uint8), device=card)
    cb = torch.as_tensor(rng.normal(size=(m, 256, dsub)).astype(np.float32) / np.sqrt(d),
                         device=card).to(torch.bfloat16)
    q = torch.as_tensor(rng.normal(size=(288, d)).astype(np.float32) / np.sqrt(d),
                        device=card).to(torch.bfloat16)
    assert _block_queries(256, 2048, 0, m, dsub, 0, False, False, False) == 64
    assert _block_queries(288, 2048, 0, m, dsub, 0, False, False, False) == 32

    def slots(qs, plain=False):
        v, i, block_q = pq._pq_slots(
            SCAN_ALL, codes.T, None, cb, None, qs, None, -(-n // 2048), tile_n=2048,
            tile_q=qs.shape[0], l_buckets=2048, n_valid=n, n_pools=1, top2=False, plain=plain)
        assert block_q == (0 if plain else 64 if qs.shape[0] == 256 else 32)
        torch.cuda.synchronize()
        return v.cpu().numpy(), i.cpu().numpy()

    wide, among = slots(q[:256]), slots(q)
    np.testing.assert_array_equal(wide[1], among[1][:, :256])
    np.testing.assert_array_equal(wide[0].view(np.uint32), among[0][:, :256].view(np.uint32))
    _assert_held(wide, slots(q[:256], plain=True))
    before = pq.pq_topk.launches
    pq.pq_topk(codes, cb, q[:256], 10)
    assert pq.pq_topk.launches == before + 1


@pytest.mark.card
def test_block_width_falls_back_where_64_queries_do_not_fit(card):
    """The 64-query block for an unmasked inner-product scan where its
    shared memory fits (D 768 at W 24, top-2); 32 for a masked or l2 scan,
    at D 1536, or where W's centroid term and top-2's slot rows overflow
    it (W 128 at D 768: top-1 fits, top-2 does not)."""
    assert _block_queries(64, 1024, 0, 64, 12, 24, True, False, False) == 64
    assert _block_queries(64, 1024, 0, 64, 12, 24, True, True, False) == 32
    assert _block_queries(64, 1024, 0, 64, 12, 24, True, False, True) == 32
    assert _block_queries(64, 1024, 0, 96, 16, 24, False, False, False) == 32
    assert _block_queries(64, 1024, 0, 64, 12, 128, False, False, False) == 64
    assert _block_queries(64, 1024, 0, 64, 12, 128, True, False, False) == 32


@pytest.mark.card
@pytest.mark.parametrize("tile_q,mask,blocks", [(32, False, 1), (64, False, 1), (128, False, 2),
                                                (64, True, 2), (128, True, 4)])
def test_scan_span_counts_the_reads_at_the_launchs_width(tile_q, mask, blocks, card):
    """K5's ``cvdb.scan`` span on the card: n_qt · P · ceil(tile_q / QB),
    QB the launch's own width (64 unmasked at a tile_q that is a multiple
    of 64, 32 masked), as the benchmark's ``scan_tile_reads.qps`` reads
    it; two pools and top-2, as the opqpq10m.b4096 cell runs."""
    shape = dict(WIDE, nq=256)
    a = _inputs(3, card, residual=True, mask=mask, l2=False, **shape)
    table = torch.as_tensor(a["table"][::tile_q // 32], device=card)
    args = dict(codes_cm=a["codes"], codebooks=a["cb"], queries_sorted=a["q"],
                tile_table=table, k=40, centroid_tiles=a["ct"], tile_n=a["tile_n"],
                tile_q=tile_q, n_valid=a["n_valid"], row_major=True, local_ids=a["local"],
                n_pools=2, top2=True, row_mask=a["row_mask"])
    metrics.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pq.pq_tiles_topk(**args)
    (scan,) = [r for r in metrics.span_records()["records"] if r["name"] == "cvdb.scan"]
    metrics.reset_spans()
    reads = table.numel() * blocks
    row_bytes = shape["m"] + 1
    assert scan["counts"] == {"tile_reads": reads,
                              "tile_read_bytes": reads * shape["tile_n"] * row_bytes}
