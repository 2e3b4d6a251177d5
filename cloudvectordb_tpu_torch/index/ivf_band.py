"""Tile-pruned IVF — the serving index (counterpart of
cloudvectordb_tpu/index/ivf_band.py: the inner-product ``BandIVFIndex`` over
residual-int8 arenas and over whole-row int8, bf16 and f32 arenas, its
device planner ``_plan_tiles``, its one-dispatch searches
``_tiles_resid_plan_search``, ``_tiles_plan_search`` and, for the PQ family
(index/ivf_band_pq.py), ``_pq_tiles_core``/``_pq_tiles_plan_search``, and
the band strategy ``_search_band``).

Layout: rows sorted by coarse list into one arena, padded to a multiple of
``tile_n``: int8 residuals (row − its list centroid) with
``residual=True``, else whole rows (int8 with one scale, bf16 or f32). A
tiles search sorts queries by their top-1 list, gives each group of
``tile_q`` queries one table of the ``p_tiles`` arena tiles its lists score
best on, and scans those tiles with ops/band.py (K1 for residual arenas,
K3 for whole rows; hand-written kernels on CUDA). The band strategy scans
each query group's contiguous band of tiles instead (K7). The index lives
on one explicit ``device``; only small metadata (assignments, offsets,
per-tile tables, band plans) is computed on the host.

Residual arenas also serve filtered search (``where=``: an allow bitmap by
global id, index/filters.py, gathered into arena order once per filter and
arena state and masked in K1 at score time, with tiles that hold no allowed
row dropped from the plan), ``metric='l2'`` (K1's l2 key over a cached
per-row bias; scores come back as -‖q - x̂‖²), ``top2`` (K1 or K3 keep each
bucket's best two rows) and ``scoring='precise'`` (bf16 queries in K1's
residual term). Whole-row arenas filter through ``filters.filtered_search``.

Mutation (BASELINE config #5's incremental updates). ``add`` quantizes a
batch under the arena's scale; on a ``slack`` arena (each list's segment
keeps ceil(count·slack)+8 empty slots) rows land in place by one device
scatter, otherwise, and when a list's slack is full, they append to the
host pending buffer (index/arena.py). Past ``merge_threshold`` of the arena
an int8 index folds the pending rows into the device annex. Searches scan
pending and annex rows exactly (f32 products, ``torch.matmul``) and merge
them with the arena's top-k, the filter applied before their top-k.
``remove`` swap-removes residual rows in place (``valid_end`` retreats, the
freed slots keep their bytes) and compacts whole rows. ``merge_pending``
shifts a compact int8 arena's rows right in place when
``build_device_streaming(merge_headroom=)`` left room, else re-sorts the
union through the host. ``merge_from``, ``reconstruct`` and
``build_streaming`` complete the surface.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from cloudvectordb_tpu_torch.eval.tune import coverage_ladder
from cloudvectordb_tpu_torch.index.arena import PendingBuffer, normalize_remove_ids
from cloudvectordb_tpu_torch.index.base import Index, from_numpy, pad_rows, to_numpy
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.band import (
    band_topk, order_centroids, resid_row_bias, tiles_topk, tiles_topk_resid)
from cloudvectordb_tpu_torch.ops.flat_topk import quantize_queries
from cloudvectordb_tpu_torch.ops.pq import pq_tiles_topk
from cloudvectordb_tpu_torch.ops.rescore import _rescore_cap, rescore_int8
from cloudvectordb_tpu_torch.ops.topk import (
    NEG_INF, f32_const, merge_topk, tiled_topk, topk_stable, topk_stable_select)
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device
from cloudvectordb_tpu_torch.utils.metrics import SEARCH, span
from cloudvectordb_tpu_torch.utils.native import arena_sort

#: max list indices one arena tile may span: bounds the per-tile window W
#: that sizes centroid_tiles (n_tiles, W, D) and the uint8 per-row local
#: index (< 256). Enforced by _capacity_layout via tile-boundary hole
#: padding; healthy data never triggers it.
_W_CAP = 128
_ARENA_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _plan_tiles(q: torch.Tensor, centroids: torch.Tensor,
                tile_window: torch.Tensor, tile_q: int, p_tiles: int,
                tile_live: torch.Tensor | None = None):
    """Device-side planning prologue of every tiles search.

    Sorts queries by their top-1 coarse centroid (L2 ranking — the
    assignment metric; a stable sort, as ``jnp.argsort``), then scores arena
    tiles per query group: group-max over queries first, then the
    tile-window gather. Returns (q_s, order, dots, tile_table): dots the
    raw (B, nlist) q·centroids matrix in caller query order (the PQ
    family's refine reads it), tile_table (n_qt, p_tiles) int32.

    Every tile of a list spanning several tiles gets the same score, so the
    tile scores hold many exact ties; the table keeps the lower tile id on
    ties, as ``lax.top_k`` does (a stable descending sort, not torch.topk).

    ``tile_live`` (n_tiles,) bool (filtered search): tiles holding no
    allowed row score -inf, so the p_tiles budget goes to tiles the filter
    can hit (selectivity-aware planning: a filter correlated with a few
    lists still gets its tiles covered).
    """
    n_qt = q.shape[0] // tile_q
    n_tiles = tile_window.shape[0]
    if not 0 < p_tiles <= n_tiles:
        raise ValueError(f"p_tiles={p_tiles} outside 1..{n_tiles} arena tiles")
    with span("cvdb.plan"):
        dots = q @ centroids.T
        c_sq = (centroids * centroids).sum(dim=1)
        coarse = dots - 0.5 * c_sq[None, :]
        top1 = torch.argmax(coarse, dim=1)
        order = torch.argsort(top1, stable=True)
        q_s = q[order]
        g_max = coarse[order].reshape(n_qt, tile_q, -1).amax(dim=1)
        ts = g_max[:, tile_window.T].amax(dim=1)  # (n_qt, n_tiles)
        if tile_live is not None:
            ts = torch.where(tile_live[None, :], ts, NEG_INF)
        _, tile_table = topk_stable(ts, p_tiles)
        return q_s, order, dots, tile_table.to(torch.int32).contiguous()


def train_ordered_centroids(x: torch.Tensor, nlist: int, train_sample: int, iters: int,
                            seed: int, device: torch.device | None = None) -> np.ndarray:
    """The reference's quantizer training: k-means, on ``device`` (default
    ``x``'s), of a seeded sample of ``x`` (rows in their sorted order),
    relabelled along the locality order (ops/band.py::order_centroids).
    (nlist, D) f32 numpy."""
    ns = min(train_sample, x.shape[0])
    sel = np.random.default_rng(seed).choice(x.shape[0], ns, replace=False)
    xs = x[torch.as_tensor(np.sort(sel), device=x.device)].to(device or x.device)
    c, _ = train_kmeans(xs, nlist, iters=iters, seed=seed)
    c = c.cpu().numpy()
    return c[order_centroids(c)]


def auto_p_tiles(n: int, nlist: int, tile_n: int, tile_q: int, nq: int, nprobe: int,
                 n_tiles: int) -> int:
    """Span-aware tile budget of an arena of extent ``n``. The planner
    shares ONE tile table across each group of ``tile_q`` sorted queries, so
    the budget must cover the group's union of relevant tiles: for g =
    min(tile_q, nq) queries spread over the locality-ordered lists the union
    spans ~min(nlist·g/nq, g·nprobe) lists; multiply by tiles-per-list and
    add a per-query margin."""
    g = min(tile_q, max(nq, 1))
    r = max(n, 1) / max(nlist, 1) / tile_n  # tiles/list
    span = min(nlist * g / max(nq, 1), float(g) * nprobe)
    margin = max(8.0, nprobe * max(r, 0.25))
    return int(min(n_tiles, max(8, int(np.ceil(span * r + margin)))))


def query_tile(tile_q: int | None, default: int, nq: int) -> int:
    """The query tile a batch of ``nq`` is served at: ``tile_q``, else the
    index's ``default``; a batch smaller than that, given no tile_q, pads
    to the pow2 cover of the batch (at least 8), not to a full query group
    (bucketed: bounded distinct shapes)."""
    if tile_q is None and nq < default:
        return max(8, _next_pow2(nq))
    return tile_q or default


def _queries_in(queries: np.ndarray, tq: int, device, rotate: np.ndarray | None = None):
    """``search()``'s way in: the (Q, D) f32 host queries (times
    ``rotate``ᵀ on the host when given), padded to a multiple of ``tq`` by
    repeating the last, copied to ``device``; the ``cvdb.search.in``
    span."""
    with span("cvdb.search.in"):
        if rotate is not None:
            queries = queries @ rotate.T
        return torch.as_tensor(pad_rows(queries, tq), device=device)


def _answers_out(v: torch.Tensor, gids: torch.Tensor):
    """``search()``'s way out: scores and ids as host f32 and int64 numpy
    arrays; the ``cvdb.search.out`` span."""
    with span("cvdb.search.out"):
        return v.cpu().numpy(), gids.cpu().numpy().astype(np.int64)


def _unsort(order, v, gids):
    """Scores and global ids back in the caller's query order."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return v[inv], gids[inv]


def _arena_mask_from_ids(ids: torch.Tensor, allowed: torch.Tensor, n_pad: int | None = None):
    """(1, n_pad) int8 arena-order allow bits: the allow bitmap (by global
    id, index/filters.py) gathered through the arena's id table. It must
    cover every arena row, pad rows included (``n_pad``, a tile_n multiple;
    the id table may be shorter); pad rows and gid -1 (holes) are 0. A
    random-access (N,) gather, so the index caches the result per filter
    and arena state (``BandIVFIndex._arena_filter``)."""
    g = ids.long()
    ok = allowed[g.clamp(0, allowed.shape[0] - 1)]
    ok = torch.where(g >= 0, ok, 0).to(torch.int8)
    if n_pad is not None and n_pad != ok.shape[0]:
        ok = torch.cat([ok, torch.zeros(n_pad - ok.shape[0], dtype=torch.int8,
                                        device=ok.device)])
    return ok[None, :]


def _tile_live(row_mask: torch.Tensor, tile_n: int) -> torch.Tensor:
    """(n_tiles,) bool: the arena tiles holding a row ``row_mask``
    allows."""
    return row_mask.reshape(-1, tile_n).amax(dim=1) > 0


def _tiles_resid_plan_search(
    q, centroids, payload, local_ids, centroid_tiles, resid_scale, ids,
    tile_window, valid_end, allowed=None, row_mask=None, *, k: int,
    p_tiles: int, tile_n: int, tile_q: int, int8_q: bool = True,
    l2: bool = False, top2: bool = False, row_bias=None, tile_live=None,
):
    """One-dispatch residual-int8 search: device planning, the tile scan
    (ops/band.py), the arena-row → global-id map and the unsort to caller
    query order. q (B, D) f32 with B % tile_q == 0; ids int32 on the
    device. Unfilled slots map through ids[clip(row)], as the reference's.

    Filtered search: ``row_mask`` ((1, N_pad) arena-order allow bits, the
    index's cached form) or ``allowed`` (the gid-keyed bitmap, gathered
    here); tiles with no allowed row leave the plan (``tile_live``, the
    mask's ``_tile_live``, computed if None), and unfilled slots return
    (-inf, -1). ``l2``: K1 ranks by q·x̂ - ‖x̂‖²/2 over ``row_bias``
    (computed if None) and the scores return as -‖q - x̂‖² (-inf stays
    -inf). ``top2``: two slots a bucket in K1."""
    if row_mask is None and allowed is not None:
        row_mask = _arena_mask_from_ids(ids, allowed, n_pad=payload.shape[0])
    if row_mask is not None and tile_live is None:
        tile_live = _tile_live(row_mask, tile_n)
    q_s, order, _, tile_table = _plan_tiles(
        q, centroids, tile_window, tile_q, p_tiles, tile_live=tile_live)
    v, rows = tiles_topk_resid(
        payload, local_ids, centroid_tiles, resid_scale, q_s, tile_table, k,
        valid_end, tile_n=tile_n, tile_q=tile_q, int8_q=int8_q, row_mask=row_mask,
        l2=l2, top2=top2, row_bias=row_bias)
    gids = ids[rows.long().clamp(0, ids.shape[0] - 1)]
    if row_mask is not None:
        gids = torch.where(v > NEG_INF, gids, -1)
    v, gids = _unsort(order, v, gids)
    if l2:  # the key q·x̂ - ‖x̂‖²/2 -> -‖q - x̂‖², FlatIndex's l2 convention
        v = f32_const(2.0, v) * v - (q * q).sum(dim=1, keepdim=True)
    return v, gids


def _tiles_plan_search(q, centroids, payload, ids, tile_window, db_scale, n_valid,
                       *, k: int, p_tiles: int, tile_n: int, tile_q: int, int8,
                       top2: bool = False):
    """One-dispatch whole-row search: device planning, the tile scan (K3,
    ops/band.py), the arena-row → global-id map and the unsort. ``int8``
    is the reference's score mode: True quantizes each query to int8
    (``round(q / (amax/127))``), 'hybrid' scores bf16 queries against the
    int8 rows, False scores queries cast to the arena dtype."""
    q_s, order, _, tile_table = _plan_tiles(q, centroids, tile_window, tile_q, p_tiles)
    scale = f32_const(db_scale, q)
    if int8 == "hybrid":
        q_dev = q_s.to(torch.bfloat16)
    elif int8:
        q_dev, q_scale = quantize_queries(q_s)
        scale = q_scale * scale
    else:
        q_dev = q_s.to(payload.dtype)
    v, rows = tiles_topk(payload, q_dev, tile_table, k, tile_n=tile_n,
                         tile_q=tile_q, int8=int8, n_valid=n_valid, top2=top2)
    v = v * scale
    return _unsort(order, v, ids[rows.long().clamp(0, ids.shape[0] - 1)])


def _pq_tiles_core(q, centroids, codes, codebooks, refine_rows, tile_window,
                   centroid_tiles, n_valid, local_ids, row_mask=None, *, k: int,
                   k_cand: int, p_tiles: int, tile_n: int, tile_q: int,
                   refine_scale: float, n_pools: int = 1, l_buckets: int = 0,
                   refine_residual: bool = False, l2: bool = False, top2: bool = False,
                   row_bias=None, segments=None):
    """The PQ-tiles search without the arena-row → global-id map: device
    planning, K5 (ops/pq.py) over the row-major (N_pad, m) codes for
    ``k_cand`` candidates, the int8 refine rescore, the unsort and the l2
    key's conversion. Returns (v, rows) in caller query order, rows as
    arena rows. ``segments`` (the row count of each segment of an arena
    past the index's segment cap, index/ivf_band_pq.py) makes K5 dispatch a
    segment at a time over views of the joined arena, each with its own
    pools; every other step sees the joined arena.

    ``row_mask`` ((1, N_pad) int8 allow bits, the index's cached form):
    tiles with no allowed row leave the plan and K5 masks the rest. ``l2``:
    K5 ranks by q·x̂ - ‖x̂‖²/2 over ``row_bias`` (computed if None), the
    rescore takes the same key of its reconstruction, and the scores
    return as -‖q - x̂‖² (-inf stays -inf); two-stage callers (pq2, host)
    receive the k_cand candidates in that form.

    The rescore (``refine_scale > 0``) scores each candidate against its
    int8 refine row (ops/rescore.py: the kernel ``csrc/rescore_int8.cu`` on
    CUDA, one launch a batch). Residual rows (``refine_residual``):
    bf16(q)·bf16(r) as exact f32 products summed in f32, times the scale,
    plus the exact centroid term ``dots[order]`` gathered by the row's list
    (its local byte through the tile window); l2 subtracts ‖c + s·r‖²/2
    expanded as the reference does. Whole rows: q·(r·scale) in f32 (l2:
    less ‖r·scale‖²/2). Unfilled kernel slots (-inf) stay -inf. Then a
    stable top-k."""
    tile_live = None
    if row_mask is not None:
        tile_live = _tile_live(row_mask, tile_n)
    q_s, order, dots, tile_table = _plan_tiles(q, centroids, tile_window, tile_q, p_tiles,
                                               tile_live=tile_live)
    v, rows = pq_tiles_topk(
        codes, codebooks, q_s, tile_table, k_cand, centroid_tiles=centroid_tiles,
        tile_n=tile_n, tile_q=tile_q, l_buckets=l_buckets, n_valid=n_valid,
        row_major=True, local_ids=local_ids, n_pools=n_pools, row_mask=row_mask, l2=l2,
        top2=top2, row_bias=row_bias, segments=segments)
    if refine_scale > 0:
        with span("cvdb.rescore"):
            rows = rows.long().clamp(0, refine_rows.shape[0] - 1)
            ex = rescore_int8(q_s, v, rows, refine_rows, refine_scale,
                              residual=refine_residual, l2=l2, centroids=centroids,
                              dots=dots, order=order, tile_window=tile_window,
                              local_ids=local_ids, tile_n=tile_n)
            v, pos = topk_stable(ex, k)
            rows = torch.gather(rows, 1, pos)
    else:
        v, rows = v[:, :k], rows[:, :k].long()
    v, rows = _unsort(order, v, rows)
    if l2:  # the key q·x̂ - ‖x̂‖²/2 -> -‖q - x̂‖²
        v = f32_const(2.0, v) * v - (q * q).sum(dim=1, keepdim=True)
    return v, rows


def _pq_tiles_plan_search(q, centroids, codes, codebooks, refine_rows, ids, tile_window,
                          centroid_tiles, n_valid, local_ids, row_mask=None, **kw):
    """One-dispatch PQ-tiles search (``_pq_tiles_core``) with the arena-row
    → global-id map: (v (B, k) f32, ids (B, k) int32) in caller order; with
    a row mask unfilled slots are (-inf, -1)."""
    v, rows = _pq_tiles_core(q, centroids, codes, codebooks, refine_rows, tile_window,
                             centroid_tiles, n_valid, local_ids, row_mask, **kw)
    gids = ids[rows.clamp(0, ids.shape[0] - 1)]
    if row_mask is not None:
        gids = torch.where(v > NEG_INF, gids, -1)
    return v, gids


def _rescore_nsub(b: int, kc: int, m2: int, budget: int = 1 << 25) -> int:
    """Query-chunk count bounding ``_pq2_rescore``'s (b/nsub, kc, m2) gather
    temporaries to ~``budget`` elements (the reference's ``_rescore_nsub``)."""
    nsub = 1
    while b % (nsub * 2) == 0 and (b // nsub) * kc * m2 > budget:
        nsub *= 2
    return nsub


def _pq2_rescore(q, v, gids, codes2, codebooks2, s2=None, *, k: int, l2: bool = False):
    """Tier-2 ADC correction (refine='pq2', the reference's ``_pq2_rescore``):
    the candidates' tier-1 score ``v`` plus q·decode2(code2), the tier-2
    codes gathered by global id (``codes2`` (N_cap, m2) uint8) and scored
    through a per-query (m2, C) f32 lookup table; l2 keys (-‖q - x̂₁‖²) take
    2·corr - s₂[gid] instead. Unfilled slots (-inf) stay -inf. In
    ``_rescore_nsub`` query chunks; each a stable top-k. Returns (v, gids)
    of k columns."""
    b, kc = v.shape
    m2, _, dsub2 = codebooks2.shape
    nsub = _rescore_nsub(b, kc, m2)
    step = b // nsub
    two = f32_const(2.0, v)
    out_v, out_i = [], []
    for s in range(0, b, step):
        qb, vb, gb = q[s:s + step], v[s:s + step], gids[s:s + step]
        g = gb.long().clamp(0, codes2.shape[0] - 1)
        c2 = codes2[g].long()  # (bs, kc, m2)
        lut = torch.einsum("bmd,mcd->bmc", qb.reshape(qb.shape[0], m2, dsub2), codebooks2)
        corr = torch.gather(lut.transpose(1, 2), 1, c2).sum(dim=2)
        if l2:
            corr = two * corr - s2[g]
        ex = torch.where(vb > NEG_INF, vb + corr, NEG_INF)
        v2, pos = topk_stable(ex, k)
        out_v.append(v2)
        out_i.append(torch.gather(gb, 1, pos))
    return torch.cat(out_v), torch.cat(out_i)


def _host_rescore(q, v, gids, r8, assign, centroids, scale: float, x_sq=None, *, k: int,
                  resid: bool = True, l2: bool = False):
    """Exact rescore of the shortlist's int8 rows shipped from host RAM
    (refine='host', the reference's ``_host_rescore``): ``r8`` (B, kc, D)
    int8, ``assign`` (B, kc) their lists. bf16(q)·bf16(r) as exact f32
    products summed in f32, times the scale, plus (residual rows) the exact
    centroid term; l2 gives -‖q - x̂‖² from ``x_sq`` (residual: (B, kc)
    ‖x̂‖², gathered host-side) or the rows themselves. In query sub-batches;
    a stable top-k."""
    b, kc = v.shape
    sc = f32_const(scale, q)
    qb = q.to(torch.bfloat16).float()
    sub = _rescore_cap(kc, b)
    parts, sq = [], []
    for s in range(0, b, sub):
        r = r8[s:s + sub].float()
        parts.append(sc * torch.bmm(r, qb[s:s + sub, :, None])[:, :, 0])
        if l2 and not resid:  # whole rows: their own norms
            sq.append((sc * sc) * (r * r).sum(dim=2))
    ex = torch.cat(parts)
    if resid:
        ex = ex + torch.gather(q @ centroids.T, 1, assign.long())
    if l2:
        x_sq = torch.cat(sq) if sq else x_sq
        ex = f32_const(2.0, ex) * ex - x_sq - (q * q).sum(dim=1, keepdim=True)
    ex = torch.where(v > NEG_INF, ex, NEG_INF)
    v2, pos = topk_stable(ex, k)
    return v2, torch.gather(gids, 1, pos)


def host_rows_sq(rows: np.ndarray, assign: np.ndarray, centroids: np.ndarray,
                 scale: float) -> np.ndarray:
    """(N,) f32 ‖x̂‖² of every host-store row (x̂ = c[assign] + scale·r), on
    the host in 1M-row chunks (the reference's ``host_rows_sq``): the l2
    host rescore's bias."""
    cents = np.asarray(centroids, np.float32)
    s = np.float32(scale)
    n = rows.shape[0]
    out = np.empty(n, np.float32)
    for lo in range(0, n, 1 << 20):
        hi = min(n, lo + (1 << 20))
        x = cents[assign[lo:hi]] + rows[lo:hi].astype(np.float32) * s
        out[lo:hi] = np.einsum("nd,nd->n", x, x)
    return out


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


#: rows a block move of the in-place merge copies at once (~192 MB at 768-d)
MERGE_CHUNK = 1 << 18


def _move_rows(buf: torch.Tensor, dst: torch.Tensor, s: int, c: int) -> None:
    """One block move of the in-place merge (``_try_merge_inplace_device``):
    rows [s, s+c) of ``buf`` written to their destinations dst[s:s+c]. The
    block is copied out first: the destinations may overlap the rows the
    block reads (a shift smaller than c)."""
    buf[dst[s:s + c]] = buf[s:s + c].clone()


def _scan_topk(score, n: int, k: int, nq: int, allow=None):
    """Exact top-k over ``n`` candidates scored tile by tile (``score(lo,
    hi)`` -> (nq, hi - lo) f32), each tile's top-k merged into the running
    one: ties go to the lower candidate, as ``lax.top_k``. ``allow`` (n,)
    bool sets disallowed candidates to -inf before the top-k. Returns (v,
    pos) of min(k, n) columns."""
    tile = max(1024, (1 << 27) // max(nq, 1))  # a (nq, tile) f32 block of <= 512 MB
    best = None
    for lo in range(0, n, tile):
        hi = min(n, lo + tile)
        s = score(lo, hi)
        if allow is not None:
            s = torch.where(allow[None, lo:hi], s, NEG_INF)
        v, pos = topk_stable_select(s, min(k, hi - lo))
        best = (v, pos + lo) if best is None else merge_topk(*best, v, pos + lo, k)
    return best


def _pending_scan(q, rows, scale: float, *, k: int, l2: bool = False, allow=None):
    """Exact top-k over the pending rows (reference ``_pending_scan``): f32
    q·rows (TF32 off) times ``scale``, the arena path's dequantized ip; l2
    gives -‖q - scale·row‖² instead."""
    sc = f32_const(scale, q)
    q_sq = (q * q).sum(dim=1, keepdim=True) if l2 else None

    def score(lo, hi):
        r = rows[lo:hi].float()
        s = (q @ r.T) * sc
        if l2:
            s = 2.0 * s - ((sc * sc) * (r * r).sum(dim=1))[None, :] - q_sq
        return s

    return _scan_topk(score, rows.shape[0], k, q.shape[0], allow)


def _annex_scan(q, rows8, assign, centroids, scale: float, *, k: int, resid: bool,
                l2: bool = False, allow=None):
    """Exact top-k over the annex's int8 rows (reference ``_annex_scan``):
    bf16(q)·bf16(row) as f32 products summed in f32 (TF32 off; the
    reference's bf16 dot with an f32 result) times ``scale``, plus the
    exact f32 centroid term of residual rows; l2 gives -‖q - x̂‖²."""
    sc = f32_const(scale, q)
    qb = q.to(torch.bfloat16).float()
    dots = q @ centroids.T if resid else None
    q_sq = (q * q).sum(dim=1, keepdim=True) if l2 else None

    def score(lo, hi):
        r = rows8[lo:hi].float()  # int8 values are exact in bf16
        ex = (qb @ r.T) * sc
        if resid:
            ex = ex + dots[:, assign[lo:hi]]
        if l2:
            x_sq = (sc * sc) * (r * r).sum(dim=1)
            if resid:
                ca = centroids[assign[lo:hi]]
                x_sq = x_sq + (2.0 * sc) * (ca * r).sum(dim=1) + (ca * ca).sum(dim=1)
            ex = 2.0 * ex - x_sq[None, :] - q_sq
        return ex

    return _scan_topk(score, rows8.shape[0], k, q.shape[0], allow)


class BandIVFIndex(Index):
    kind = "band_ivf"

    def __init__(
        self,
        dim: int,
        nlist: int,
        dtype: str = "int8",
        kmeans_iters: int = 15,
        seed: int = 0,
        tile_n: int = 2048,
        tile_q: int = 256,
        residual: bool = False,
        slack: float = 0.0,
        metric: str = "ip",
        device: str | torch.device = DEFAULT,
    ):
        """The reference's constructor with an explicit ``device``.
        ``residual=True`` (int8 only) stores int8 residuals and adds the
        centroid term back in the kernel; otherwise the arena holds whole
        rows in ``dtype``. ``slack > 0`` (residual arenas) gives each list's
        segment ceil(count·slack)+8 empty slots that ``add`` fills in place;
        K1 masks them through the per-tile-list valid_end table.
        ``metric='l2'`` (residual arenas) ranks by -‖q - x̂‖². What the
        reference refuses raises ValueError (residual bf16/f32, slack or l2
        on whole rows)."""
        if dtype not in ("int8", "bfloat16", "float32"):
            raise ValueError(f"unknown arena dtype {dtype!r}")
        if residual and dtype != "int8":
            raise ValueError("residual is the int8 path")
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if slack != 0.0 and not residual:
            raise ValueError("slack slots require the residual-int8 arena")
        if metric == "l2" and not residual:
            # the whole-row kernels carry no l2 bias (as the reference)
            raise ValueError("BandIVFIndex metric='l2' requires the residual-int8 arena; "
                             "FlatIndex serves whole-row l2")
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.dtype = dtype
        self.residual = residual
        self.slack = slack
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.tile_n = tile_n
        self.tile_q = tile_q
        self.device = as_device(device)
        self.centroids: np.ndarray | None = None  # (nlist, D) f32, locality-ordered
        self._payload: torch.Tensor | None = None  # (N_pad, D) on device
        self._ids: np.ndarray | None = None  # arena row -> global id (-1: hole)
        self._offsets: np.ndarray | None = None  # (nlist+1,) row offsets
        self._list_lens: np.ndarray | None = None  # valid rows per list (holes)
        self._local = None  # (1, N_pad) uint8 per-row local list idx
        self._centroid_tiles = None  # (n_tiles, W, D) f32
        self._valid_end = None  # (n_tiles, W) int32 per-tile-list valid end
        self._tile_window = None  # (n_tiles, W) int32 list ids per tile
        self._scale = 1.0
        self._n = 0  # arena extent (capacity offsets[-1])
        self._next_id = 0  # 0: derive from the id stores (_gid_bound)
        self._dev = None
        self._flt_cache: dict = {}  # filter masks by (filter, ids tensor, its version)
        self._bias_cache = None  # (arena key, its tensors, (N_pad,) f32 l2 row bias)
        # pending rows: int8 arena-scale rows, or f32 whole rows
        self._pending = PendingBuffer(dim, np.int8 if dtype == "int8" else np.float32)
        self._pending_dev = None  # (rows, ids, ids int32, n) on the device
        self.merge_threshold = 0.05  # fold once pending exceeds this share of the arena
        # device annex: int8 rows folded from pending (rows, assign on the
        # device; ids on the host; n filled of the capacity)
        self._annex: dict | None = None
        self._annex_ver = 0  # bumped on every annex change (its device id copy)

    @property
    def _n_valid(self) -> int:
        """Valid arena rows: the extent minus slack and tile-span-cap holes."""
        if self._list_lens is not None:
            return int(self._list_lens.sum())
        return self._n

    @property
    def ntotal(self) -> int:
        ax = self._annex["n"] if self._annex is not None else 0
        return self._n_valid + self._pending.size + ax

    def _gid_bound(self) -> int:
        """1 + the largest global id ever allocated. After a remove() the id
        space has gaps, so this, not ntotal, sizes gid-keyed tables and
        seeds new ids. Derived from the id stores on first use (every build
        assigns ids from 0), then kept up to date."""
        if self._next_id == 0:
            hi = 0
            if self._ids is not None and len(self._ids):
                hi = int(np.asarray(self._ids).max(initial=-1)) + 1
            snap = self._pending.snapshot_full()
            if snap is not None and snap[1].size:
                hi = max(hi, int(snap[1].max()) + 1)
            if self._annex is not None and self._annex["n"]:
                hi = max(hi, int(self._annex["ids"][: self._annex["n"]].max()) + 1)
            self._next_id = hi
        return self._next_id

    def _alloc_ids(self, b: int) -> np.ndarray:
        nid = self._gid_bound()
        self._next_id = nid + b
        return np.arange(nid, nid + b, dtype=np.int64)

    # -- build ------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, train_sample: int = 262_144,
              centroids: np.ndarray | None = None, **kw) -> "BandIVFIndex":
        """Build from (N, D) vectors (numpy or a tensor). ``centroids``, when
        given, is the final, locality-ordered quantizer and skips training."""
        idx = cls(int(vectors.shape[1]), nlist, **kw)
        x = torch.as_tensor(vectors, dtype=torch.float32).to(idx.device)
        if centroids is None:
            centroids = train_ordered_centroids(x, nlist, train_sample, idx.kmeans_iters,
                                                idx.seed)
        idx.centroids = np.asarray(centroids, np.float32)
        idx._populate(x)
        return idx

    def _centroids_dev(self) -> torch.Tensor:
        return torch.as_tensor(self.centroids, dtype=torch.float32, device=self.device)

    def _populate(self, x: torch.Tensor) -> None:
        cdev = self._centroids_dev()
        a, _ = assign_clusters(x, cdev)
        a_np = a.cpu().numpy()
        order = np.argsort(a_np, kind="stable")
        order_d = torch.as_tensor(order, device=self.device)
        xs = x[order_d]  # list order
        if self.residual:
            xs = xs - cdev[a[order_d]]
        if self.dtype == "int8":
            rms = torch.sqrt(torch.mean(xs * xs))
            amax = torch.max(torch.abs(xs))
            scale = float(torch.clamp_min(
                torch.minimum(amax, 4.0 * rms) / f32_const(127.0, xs), 1e-12))
            payload = torch.clamp(torch.round(xs / f32_const(scale, xs)), -127,
                                  127).to(torch.int8)
        else:
            scale = 1.0
            payload = xs.to(_ARENA_DTYPES[self.dtype])
        offsets, dest, lens = self._layout(np.bincount(a_np, minlength=self.nlist))
        extent = int(offsets[-1])
        n_pad = -(-extent // self.tile_n) * self.tile_n
        arena = torch.zeros((n_pad, self.dim), dtype=payload.dtype, device=self.device)
        arena[torch.as_tensor(dest, device=self.device)] = payload
        self._list_lens = lens
        if lens is not None:
            ids = np.full(n_pad, -1, np.int64)
            ids[dest] = order
        else:  # the reference keeps int64 ids for residual, int32 for whole rows
            ids = order.astype(np.int64 if self.residual else np.int32)
        self._set_arena(arena, ids, offsets, extent, scale)

    @classmethod
    def build_streaming(cls, chunks, nlist: int, train_sample: int = 262_144,
                        centroids: np.ndarray | None = None, **kw) -> "BandIVFIndex":
        """Streaming encode→insert build (BASELINE config #5): each chunk of
        (n_i, D) rows (numpy or tensors, e.g. an encoder's batches) is
        assigned and quantized on the device, its int8 rows kept on the
        host, and the arena assembled once by the native counting sort; the
        full-precision corpus never exists in one piece. The first chunk
        trains the quantizer (unless ``centroids`` gives it) and sets the
        int8 scale."""
        chunks = iter(chunks)
        first = next(chunks, None)
        if first is None:
            raise ValueError("empty stream")
        idx = cls(int(first.shape[1]), nlist, **kw)
        if idx.dtype != "int8":
            raise ValueError("streaming build is the int8 path")
        payload_chunks: list[torch.Tensor] = []
        assign_chunks: list[np.ndarray] = []
        for q8, a in idx.quantize_stream(itertools.chain([first], chunks), train_sample,
                                         centroids):
            payload_chunks.append(q8)
            assign_chunks.append(a)
        payload = torch.cat(payload_chunks)
        idx._assemble_compact(payload, np.arange(payload.shape[0], dtype=np.int64),
                              np.concatenate(assign_chunks))
        return idx

    def quantize_stream(self, chunks, train_sample: int, centroids: np.ndarray | None):
        """Yield each chunk's (int8 rows on the host, list assignments),
        assigned and quantized on the device. The first chunk trains the
        quantizer (unless ``centroids`` gives it) and sets the int8 scale
        (of residuals with ``residual``); both are set on this index."""
        cdev = None
        scale = 0.0
        for chunk in chunks:
            chunk = torch.as_tensor(chunk, dtype=torch.float32).to(self.device)
            if cdev is None:
                if centroids is None:
                    ns = min(train_sample, chunk.shape[0])
                    c, _ = train_kmeans(chunk[:ns], self.nlist, iters=self.kmeans_iters,
                                        seed=self.seed)
                    c = c.cpu().numpy()
                    centroids = c[order_centroids(c)]
                self.centroids = np.asarray(centroids, np.float32)
                cdev = self._centroids_dev()
            a, _ = assign_clusters(chunk, cdev)
            if self.residual:
                chunk = chunk - cdev[a]
            if scale == 0.0:  # the first chunk sets the (residual-aware) scale
                rms = float(torch.sqrt(torch.mean(chunk * chunk)))
                amax = float(torch.max(torch.abs(chunk)))
                scale = self._scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
            q8 = torch.clamp(torch.round(chunk / f32_const(scale, chunk)), -127, 127)
            yield q8.to(torch.int8).cpu(), a.cpu().numpy()

    @classmethod
    def build_device_streaming(
        cls, chunk_fn, n_chunks: int, nlist: int, train_sample: int = 262_144,
        merge_headroom: float = 0.0, centroids: np.ndarray | None = None, **kw,
    ) -> "BandIVFIndex":
        """Device-resident streaming build: only the (N,) assignments reach
        the host. ``chunk_fn(i) -> (n_i, D)`` f32 tensor must be
        deterministic: chunks are produced twice (pass 1: train on the first
        chunk, assign every chunk; pass 2: quantize and scatter into the
        arena at positions from the host-side native counting sort). Peak
        device memory ≈ int8 arena + one f32 chunk. ``centroids``, when
        given, is the final, locality-ordered quantizer and skips training.
        The first chunk sets the int8 scale (of residuals, or of whole rows
        with ``residual=False``). The arena is int8 either way, as the
        reference's. ``merge_headroom`` > 0 allocates that share of the
        extent again as tail capacity (masked like padding), so that
        ``merge_pending`` can shift the rows right in place: no second
        arena, no host copy."""
        idx = None
        cdev = None
        assigns: list[np.ndarray] = []
        sizes: list[int] = []
        scale = 0.0
        for ci in range(n_chunks):
            chunk = chunk_fn(ci)
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, **kw)
                if idx.dtype != "int8":
                    raise ValueError("device-streaming is the int8 path")
            chunk = torch.as_tensor(chunk, dtype=torch.float32).to(idx.device)
            if cdev is None:
                if centroids is None:
                    ns = min(train_sample, chunk.shape[0])
                    c, _ = train_kmeans(chunk[:ns], nlist, iters=idx.kmeans_iters,
                                        seed=idx.seed)
                    c = c.cpu().numpy()
                    centroids = c[order_centroids(c)]
                idx.centroids = np.asarray(centroids, np.float32)
                cdev = idx._centroids_dev()
            a, _ = assign_clusters(chunk, cdev)
            if scale == 0.0:  # first chunk sets the scale
                enc = chunk - cdev[a] if idx.residual else chunk
                rms = float(torch.sqrt(torch.mean(enc * enc)))
                amax = float(torch.max(torch.abs(enc)))
                scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
                enc = None
            assigns.append(a.cpu().numpy().astype(np.int32))
            sizes.append(int(chunk.shape[0]))
            chunk = a = None  # one f32 chunk resident at a time
        if idx is None:
            raise ValueError("empty stream")

        assign_all = np.concatenate(assigns)
        n = assign_all.shape[0]
        order, offsets = arena_sort(assign_all, nlist)
        offsets, cap_dest, lens = idx._layout(np.diff(offsets))
        extent = int(offsets[-1])
        dest = np.empty(n, np.int64)
        dest[order] = cap_dest  # source row -> arena position
        cap = int(np.ceil(extent * (1.0 + merge_headroom)))
        n_pad = -(-cap // idx.tile_n) * idx.tile_n
        arena = torch.zeros((n_pad, idx.dim), dtype=torch.int8, device=idx.device)
        # the f32 value the reference divides by (its scale rides into jit
        # as a weakly typed f32 constant)
        scale_t = f32_const(scale, arena)
        base = 0
        for ci in range(n_chunks):
            chunk = torch.as_tensor(chunk_fn(ci), dtype=torch.float32).to(idx.device)
            d = torch.as_tensor(dest[base : base + sizes[ci]], device=idx.device)
            if idx.residual:
                a_dev = torch.as_tensor(assigns[ci], device=idx.device).long()
                chunk = chunk - cdev[a_dev]
            q8 = torch.clamp(torch.round(chunk / scale_t), -127, 127).to(torch.int8)
            # the reference's donated scatter (``ar.at[d].set(q8)``) becomes an
            # in-place write into the preallocated arena
            arena[d] = q8
            base += sizes[ci]
            chunk = q8 = None
        idx._list_lens = lens
        if lens is not None:  # slack slots or tile-span-cap holes
            ids = np.full(n_pad, -1, np.int64)
            ids[dest] = np.arange(n, dtype=np.int64)  # global id = source row
        else:
            ids = order.astype(np.int64)
        idx._set_arena(arena, ids, offsets, extent, scale)
        return idx

    def _set_arena(self, arena: torch.Tensor, ids: np.ndarray,
                   offsets: np.ndarray, extent: int, scale: float) -> None:
        """Install an arena (``_list_lens`` already set): the derived tables
        are recomputed and the staged device state dropped."""
        self._payload = arena
        self._ids = ids
        self._offsets = np.asarray(offsets, np.int64)
        self._n = extent
        self._scale = scale
        self._tile_window = self._compute_tile_window()
        if self.residual:
            self._build_residual_aux()
        self._dev = None

    def _layout(self, counts: np.ndarray):
        """(offsets, dest, list_lens) of an arena holding ``counts`` rows
        per list: dest[i] is the arena slot of the i-th list-sorted row.
        Residual arenas take slack slots (``_slack_layout``) and the
        tile-span cap (``_capacity_layout``), and then list_lens; a layout
        without holes (whole rows always) is the plain cumsum, list_lens
        None."""
        counts = counts.astype(np.int64)
        n = int(counts.sum())
        if self.slack > 0:
            return (*self._slack_layout(counts), counts)
        if self.residual:
            offsets, dest = self._capacity_layout(counts, counts)
            if int(offsets[-1]) != n:  # the tile-span cap padded holes
                return offsets, dest, counts
        return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                np.arange(n, dtype=np.int64), None)

    def _capacity_layout(self, counts: np.ndarray, caps: np.ndarray):
        """Capacity offsets + per-sorted-row destination for hole-bearing
        (residual) arenas, with the TILE-SPAN CAP applied: no arena tile may
        span more than ``_W_CAP`` list indices. When the (W_CAP+1)-th list
        would begin inside the current tile, the layout pads to the next
        tile boundary first; the holes are masked like slack slots. Healthy
        data inserts no padding, and with caps == counts the layout equals
        the plain cumsum.

        Returns (offsets_cap (nlist+1,), dest (n,)) where dest[i] is the
        arena position of the i-th list-sorted row (each list's rows sit at
        the start of its capacity segment)."""
        counts = counts.astype(np.int64)
        caps = caps.astype(np.int64)
        tile_n = self.tile_n
        starts = np.empty(len(caps), np.int64)
        off = 0
        tile_of = -1
        in_tile = 0
        for li, c in enumerate(caps):
            t = off // tile_n
            if t != tile_of:
                tile_of, in_tile = t, 0
            in_tile += 1
            if in_tile > _W_CAP:
                off = (t + 1) * tile_n
                tile_of, in_tile = t + 1, 1
            starts[li] = off
            off += int(c)
        offsets = np.concatenate([starts, [off]]).astype(np.int64)
        start = np.concatenate([[0], np.cumsum(counts)])
        dest = (np.arange(int(counts.sum()), dtype=np.int64)
                - np.repeat(start[:-1], counts)
                + np.repeat(offsets[:-1], counts))
        return offsets, dest

    def _slack_layout(self, counts: np.ndarray):
        """Capacity layout of a slack arena: each list's rows at the start of
        its segment, then ceil(count·slack)+8 empty slots that ``add``
        fills in place. Tile-span-capped (``_capacity_layout``)."""
        counts = counts.astype(np.int64)
        caps = counts + np.ceil(counts * self.slack).astype(np.int64) + 8
        return self._capacity_layout(counts, caps)

    def _assemble_compact(self, payload: torch.Tensor, ids: np.ndarray,
                          assigns: np.ndarray) -> None:
        """Set the arena from quantized rows (a tensor on the host or the
        device), their global ids and list assignments: one native
        counting sort, then the rows written into a new arena on the
        device in blocks. Shared by the streaming build, the host merge,
        ``merge_from`` and the whole-row remove. A slack arena gets fresh
        slack slots in every list."""
        order, offsets = arena_sort(np.asarray(assigns, np.int32), self.nlist)
        offsets, dest, lens = self._layout(np.diff(offsets))
        extent = int(offsets[-1])
        n_pad = -(-extent // self.tile_n) * self.tile_n
        arena = torch.zeros((n_pad, self.dim), dtype=_ARENA_DTYPES[self.dtype],
                            device=self.device)
        for lo in range(0, order.shape[0], 1 << 20):
            src = torch.as_tensor(order[lo:lo + (1 << 20)], device=payload.device)
            arena[torch.as_tensor(dest[lo:lo + (1 << 20)], device=self.device)] = (
                payload[src].to(device=self.device, dtype=arena.dtype))
        ids = np.asarray(ids, np.int64)[order]
        # a compact arena has every list full again: lens an in-place remove
        # left behind would mask the tail of every list
        self._list_lens = lens
        if lens is not None:
            ids_full = np.full(n_pad, -1, np.int64)
            ids_full[dest] = ids
            ids = ids_full
        self._set_arena(arena, ids, offsets, extent, self._scale)

    def _build_residual_aux(self) -> None:
        """Per-row LOCAL list index within its tile window, per-tile centroid
        matrices (n_tiles, W, D) and the per-tile-list valid_end table, all
        derived from the capacity offsets + list lengths."""
        n = self._n  # arena extent, including holes
        n_pad = int(self._payload.shape[0])
        tw = self._tile_window  # (n_tiles, W)
        assigns = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
        row_tile = np.arange(n) // self.tile_n
        local = assigns - tw[row_tile, 0]
        w = tw.shape[1]
        assert local.min(initial=0) >= 0 and local.max(initial=0) < w
        assert w <= 256, (
            f"per-tile window W={w} overflows the uint8 local index — a "
            "layout path skipped the tile-span cap (_capacity_layout)")
        loc = np.zeros((1, n_pad), np.uint8)
        loc[0, :n] = local.astype(np.uint8)
        self._local = loc
        self._centroid_tiles = np.ascontiguousarray(self.centroids[tw]).astype(np.float32)
        self._valid_end = self._valid_end_table()

    def _compute_tile_window(self) -> np.ndarray:
        """(n_tiles, W) list ids intersecting each arena tile (rows padded by
        repeating the last id) — drives device-side tile scoring."""
        n_rows = int(self._payload.shape[0])
        n_tiles = n_rows // self.tile_n
        starts = np.arange(n_tiles, dtype=np.int64) * self.tile_n
        ends = np.minimum(starts + self.tile_n - 1, max(self._n - 1, 0))
        fl = np.clip(np.searchsorted(self._offsets, starts, side="right") - 1,
                     0, self.nlist - 1)
        ll = np.clip(np.searchsorted(self._offsets, ends, side="right") - 1,
                     0, self.nlist - 1)
        w = int((ll - fl).max()) + 1 if n_tiles else 1
        window = fl[:, None] + np.arange(w)[None, :]
        window = np.minimum(window, ll[:, None])
        return np.clip(window, 0, self.nlist - 1).astype(np.int32)

    def _valid_end_table(self) -> np.ndarray:
        """(n_tiles, W) int32: the end of each tile-list's valid rows."""
        tw = self._tile_window
        lens = self._list_lens if self._list_lens is not None else np.diff(self._offsets)
        return (self._offsets[:-1][tw] + lens[tw]).astype(np.int32)

    def _writable_tables(self) -> None:
        """Host id and list-length tables that mutation may write in place
        (the loaded ones may be read-only or int32)."""
        if self._ids.dtype != np.int64 or not self._ids.flags.writeable:
            self._ids = np.array(self._ids, np.int64)
        if self._list_lens is None:  # a compact arena: every list full
            self._list_lens = np.diff(self._offsets).astype(np.int64)
        elif not self._list_lens.flags.writeable:
            self._list_lens = self._list_lens.copy()

    # -- mutation ---------------------------------------------------------
    def add(self, vectors, ids: np.ndarray | None = None) -> None:
        """Insert (B, D) rows, searchable at once: assigned and quantized on
        the device under the arena's scale. A slack arena writes them into
        their lists' free slots by one in-place scatter; rows beyond a
        list's slack, and every row of an arena without slack, append to
        the pending buffer, which folds (``_fold_pending``) once it exceeds
        ``merge_threshold`` of the arena. ``ids``: explicit global ids (at
        least the current bound: ids are never reused), else allocated from
        the bound. Host tables are written before the device scatter, so a
        failed scatter leaves no table pointing at rows never written."""
        x = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        if self._n == 0 and self._pending.size == 0:
            if self.centroids is None:
                raise ValueError("add() on an empty index needs build()'s quantizer")
            if ids is not None:
                raise ValueError("explicit ids need a populated arena")
            self._populate(x)
            return
        cdev = self._centroids_dev()
        a, _ = assign_clusters(x, cdev)
        a_np = a.cpu().numpy()
        b = int(x.shape[0])
        if ids is None:
            ids = self._alloc_ids(b)
        else:
            ids = np.asarray(ids, np.int64)
            if ids.shape != (b,) or ids.min(initial=np.iinfo(np.int64).max) < self._gid_bound():
                raise ValueError("explicit ids must be (B,) and not below the ids ever allocated")
            self._next_id = max(self._gid_bound(), int(ids.max(initial=-1)) + 1)
        spill = np.arange(b)
        if self.slack > 0 and self._list_lens is not None:
            caps = np.diff(self._offsets)
            order = np.argsort(a_np, kind="stable")
            a_s = a_np[order]
            rank = np.arange(b) - np.searchsorted(a_s, np.arange(self.nlist))[a_s]
            take = rank < caps[a_s] - self._list_lens[a_s]
            dest = (self._offsets[:-1][a_s] + self._list_lens[a_s] + rank)[take]
            t_idx, spill = order[take], order[~take]
            if t_idx.size:
                t_dev = torch.as_tensor(t_idx, device=self.device)
                rows = self._quantize_rows(x[t_dev], a[t_dev], cdev)
                self._writable_tables()
                self._ids[dest] = ids[t_idx]
                np.add.at(self._list_lens, a_np[t_idx], 1)
                self._valid_end = self._valid_end_table()
                dest_dev = torch.as_tensor(dest, device=self.device)
                self._payload[dest_dev] = rows
                if self._dev is not None:  # the staged tables, in place
                    self._dev["ids"][dest_dev] = torch.as_tensor(
                        ids[t_idx].astype(np.int32), device=self.device)
                    self._dev["valid_end"].copy_(torch.as_tensor(self._valid_end))
            if not spill.size:
                return
        s_dev = torch.as_tensor(spill, device=self.device)
        rows = self._quantize_rows(x[s_dev], a[s_dev], cdev)
        self._pending.append(rows.cpu().numpy(), ids[spill], a_np[spill])
        self._pending_dev = None
        arena = self._n_valid if self.slack > 0 and self._list_lens is not None else self._n
        if self._pending.size > max(self.merge_threshold * arena, 4 * self.tile_n):
            self._fold_pending()

    def _quantize_rows(self, x: torch.Tensor, assigns: torch.Tensor,
                       cdev: torch.Tensor) -> torch.Tensor:
        """f32 rows -> the arena's payload type under its scale (int8 rows
        beyond the build's clip clip, so every score stays comparable);
        residual rows less their list centroid first."""
        if self.residual:
            x = x - cdev[assigns]
        if self.dtype == "int8":
            return torch.clamp(torch.round(x / f32_const(self._scale, x)), -127,
                               127).to(torch.int8)
        return x.float()

    def _fold_pending(self) -> None:
        """The threshold fold: int8 indexes fold the pending rows into the
        device annex (an arena at 12.5M rows has no room for a second copy
        to re-sort into), others merge them into the arena."""
        if self.dtype == "int8":
            self._fold_pending_annex()
        else:
            self.merge_pending()

    def _fold_pending_annex(self) -> None:
        if self._pending.size == 0:
            return
        rows8, pids, passign = self._pending.drain()
        self._pending_dev = None
        n_new = rows8.shape[0]
        dev = self.device
        if self._annex is None:
            cap = max(_next_pow2(n_new), 8192)
            self._annex = dict(rows=torch.zeros((cap, self.dim), dtype=torch.int8, device=dev),
                               assign=torch.zeros(cap, dtype=torch.int64, device=dev),
                               ids=np.full(cap, -1, np.int64), n=0)
        ax = self._annex
        n = ax["n"]
        if n + n_new > ax["ids"].shape[0]:  # grow to the next power of two
            cap = _next_pow2(n + n_new)
            rows = torch.zeros((cap, self.dim), dtype=torch.int8, device=dev)
            assign = torch.zeros(cap, dtype=torch.int64, device=dev)
            rows[:n], assign[:n] = ax["rows"][:n], ax["assign"][:n]
            ids = np.full(cap, -1, np.int64)
            ids[:n] = ax["ids"][:n]
            ax.update(rows=rows, assign=assign, ids=ids)
        ax["rows"][n:n + n_new] = torch.as_tensor(rows8, device=dev)
        ax["assign"][n:n + n_new] = torch.as_tensor(passign, device=dev)
        ax["ids"][n:n + n_new] = pids
        ax["n"] = n + n_new
        self._annex_ver += 1

    def merge_pending(self, chunk: int = MERGE_CHUNK) -> None:
        """Merge the pending and annex rows into the arena (no
        requantization: they share its scale). A compact int8 arena with
        room left by ``merge_headroom`` shifts its rows right in place
        (``_try_merge_inplace_device``, blocks of ``chunk`` rows); otherwise
        the union is re-sorted through the host (the payload's one trip
        there), with fresh slack on a slack arena."""
        ax = self._annex if self._annex is not None and self._annex["n"] else None
        if self._pending.size == 0 and ax is None:
            return
        p_np, pids, passign = self._pending.drain()
        p = torch.as_tensor(p_np).to(self.device)
        if ax is not None:
            n = ax["n"]
            p = torch.cat([p, ax["rows"][:n].to(p.dtype)])
            pids = np.concatenate([pids, ax["ids"][:n]])
            passign = np.concatenate([passign, ax["assign"][:n].cpu().numpy()])
        self._annex = None
        self._pending_dev = None
        if self._n and self._try_merge_inplace_device(p, pids, passign, chunk):
            return
        if self._n:
            cap_assign = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
            ids = np.asarray(self._ids, np.int64)[: self._n]
            host = self._payload[: self._n].cpu()
            if self._list_lens is not None:  # skip the holes
                valid = np.flatnonzero(ids >= 0)
                host, cap_assign, ids = host[torch.as_tensor(valid)], cap_assign[valid], ids[valid]
            p = torch.cat([host, p.cpu().to(host.dtype)])
            pids = np.concatenate([ids, pids])
            passign = np.concatenate([cap_assign, passign])
        self._assemble_compact(p, pids, passign)

    def _try_merge_inplace_device(self, p: torch.Tensor, pids: np.ndarray,
                                  passign: np.ndarray, chunk: int = MERGE_CHUNK) -> bool:
        """Merge ``p`` (arena-scale int8 rows on the device) into a compact
        int8 arena in its own buffer: no second arena, no host copy. Each
        list's rows shift right by the rows inserted before it (prefix sums
        of the per-list counts), so destinations grow with the source
        position: blocks of ``chunk`` rows moved from the highest source
        down never read a slot an earlier block wrote (``_move_rows``
        copies each block out before writing it). Then ``p`` scatters into
        its lists' new tail slots in one write. False (nothing changed)
        on a slack or hole-bearing arena, a whole-row bf16/f32 one, or when
        the merged extent exceeds the buffer: the caller re-sorts through
        the host."""
        if not (self.dtype == "int8" and self._list_lens is None and p.shape[0]):
            return False
        n_old = self._n
        counts_old = np.diff(self._offsets)
        passign = np.asarray(passign, np.int64)
        offsets_new = np.concatenate(
            [[0], np.cumsum(counts_old + np.bincount(passign, minlength=self.nlist))]
        ).astype(np.int64)
        n_new = int(offsets_new[-1])
        if n_new > int(self._payload.shape[0]):
            return False  # the headroom is spent
        shift = offsets_new[:-1] - self._offsets[:-1]
        dst_all = np.arange(n_old, dtype=np.int64) + np.repeat(shift, counts_old)
        order_p = np.argsort(passign, kind="stable")
        a_s = passign[order_p]
        dest_p = np.empty(p.shape[0], np.int64)
        dest_p[order_p] = (offsets_new[:-1][a_s] + counts_old[a_s]
                           + np.arange(p.shape[0]) - np.searchsorted(a_s, a_s))
        buf = self._payload
        dst_dev = torch.as_tensor(dst_all, device=self.device)
        # rows before the first shifted list stay where they are
        src_min = (int(self._offsets[:-1][np.argmax(shift > 0)]) if (shift > 0).any()
                   else n_old)
        for s in list(range(src_min, n_old, chunk))[::-1]:
            _move_rows(buf, dst_dev, s, min(chunk, n_old - s))
        buf[torch.as_tensor(dest_p, device=self.device)] = p.to(buf.dtype)
        ids_new = np.empty(n_new, np.int64)
        ids_new[dst_all] = np.asarray(self._ids, np.int64)[:n_old]
        ids_new[dest_p] = pids
        self._set_arena(buf, ids_new, offsets_new, n_new, self._scale)
        return True

    def remove(self, ids) -> int:
        """Delete rows by global id; returns how many were removed (unknown
        ids are ignored; freed ids are never reused). Residual arenas
        swap-remove in place: in each hit list the surviving tail rows move
        into the removed slots and the list's valid_end retreats (the freed
        slots keep their bytes; K1 never reads past valid_end), so the
        payload never leaves its buffer and freed slots become slack that
        ``add`` refills. Pending rows drop on the host, annex rows
        swap-remove within the annex; whole-row arenas compact."""
        req = normalize_remove_ids(ids)
        if req.size == 0:
            return 0
        self._gid_bound()  # fixed before ids vanish: ids are never reused
        removed = self._remove_pending(req) + self._remove_annex(req)
        if self._n:
            slots = np.flatnonzero(np.isin(np.asarray(self._ids[: self._n], np.int64), req))
            if slots.size:
                if self.residual:
                    self._remove_arena_inplace(slots)
                else:
                    self._remove_arena_compact(slots)
                removed += int(slots.size)
        return removed

    def _remove_pending(self, req: np.ndarray) -> int:
        n_rem, _ = self._pending.remove_ids(req)
        if n_rem:
            self._pending_dev = None
        return n_rem

    def _remove_annex(self, req: np.ndarray) -> int:
        ax = self._annex
        if ax is None or ax["n"] == 0:
            return 0
        n = ax["n"]
        hit = np.flatnonzero(np.isin(ax["ids"][:n], req))
        if hit.size == 0:
            return 0
        new_n = n - int(hit.size)
        head = hit[hit < new_n]  # holes to fill
        tail = np.arange(new_n, n)
        tail_surv = tail[~np.isin(tail, hit)]  # the survivors that fill them
        if head.size:
            src = torch.as_tensor(tail_surv, device=self.device)
            dst = torch.as_tensor(head, device=self.device)
            ax["rows"][dst] = ax["rows"][src]  # the gather copies: disjoint slots
            ax["assign"][dst] = ax["assign"][src]
            ax["ids"][head] = ax["ids"][tail_surv]
        ax["ids"][new_n:n] = -1
        ax["n"] = new_n
        self._annex_ver += 1
        return int(hit.size)

    def _swap_remove_slots(self, slots: np.ndarray):
        """Per-list swap-remove plan: in each hit list the survivors among
        its last ``cnt`` valid slots move into the removed slots before
        them, so every list stays front-packed (the valid_end invariant).
        Decrements ``_list_lens``. Returns (src, dst, freed) arena slots:
        src -> dst moves (disjoint), and the freed tail slots (id -1).
        Vectorized: within a list the removed head slots and the surviving
        tail slots are equal in number, and both come out grouped by list,
        so they pair by position."""
        offs = self._offsets
        lens = self._list_lens
        slots = np.sort(np.asarray(slots, np.int64))
        lists = np.searchsorted(offs, slots, side="right") - 1
        ul, cnt = np.unique(lists, return_counts=True)
        new_lens = lens[ul] - cnt
        cut = offs[ul] + new_lens  # each hit list's first freed slot
        seg_start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        freed = (np.arange(int(cnt.sum()), dtype=np.int64)
                 - np.repeat(seg_start, cnt) + np.repeat(cut, cnt))
        tail_surv = freed[~np.isin(freed, slots)]
        head_holes = slots[slots < cut[np.searchsorted(ul, lists)]]
        if head_holes.size != tail_surv.size:
            raise AssertionError("swap-remove plan out of balance")
        lens[ul] = new_lens
        return tail_surv, head_holes, freed

    def _remove_arena_inplace(self, slots: np.ndarray) -> None:
        """Residual arenas: the O(batch) swap-remove (``remove``). A compact
        arena gets its list lengths here. Host tables first, as in
        ``add``."""
        self._writable_tables()
        src, dst, freed = self._swap_remove_slots(slots)
        self._ids[dst] = self._ids[src]
        self._ids[freed] = -1
        self._valid_end = self._valid_end_table()
        sd = torch.as_tensor(src, device=self.device)
        dd = torch.as_tensor(dst, device=self.device)
        if src.size:
            self._payload[dd] = self._payload[sd]  # the gather copies: disjoint slots
        if self._dev is not None:  # the staged tables, in place
            ids_t = self._dev["ids"]
            if src.size:
                ids_t[dd] = ids_t[sd]
            ids_t[torch.as_tensor(freed, device=self.device)] = -1
            self._dev["valid_end"].copy_(torch.as_tensor(self._valid_end))

    def _remove_arena_compact(self, slots: np.ndarray) -> None:
        """Whole-row arenas (their scan masks rows past n_valid only): the
        surviving rows re-assembled into a new compact arena."""
        ids_arr = np.asarray(self._ids[: self._n], np.int64)
        keep = ids_arr >= 0
        keep[slots] = False
        kept = np.flatnonzero(keep)
        cap_assign = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
        payload = self._payload[torch.as_tensor(kept, device=self.device)]
        self._assemble_compact(payload, ids_arr[kept], cap_assign[kept])

    def _export_rows(self):
        """(payload tensor, gids, assigns) of every valid arena row, after
        the pending and annex rows merge in: ``merge_from``'s interchange
        form (slack holes and padding drop out)."""
        self.merge_pending()
        ids = np.asarray(self._ids, np.int64)
        valid = np.flatnonzero(ids >= 0)
        payload = self._payload[torch.as_tensor(valid, device=self.device)]
        assigns = (np.searchsorted(self._offsets, valid, side="right") - 1).astype(np.int32)
        return payload, ids[valid], assigns

    def merge_from(self, other: "BandIVFIndex", id_offset: int | None = None) -> int:
        """Consolidate another index built with the same quantizer (the
        FAISS ``merge_from`` surface): one re-sort of the union, no
        re-encoding; ``other`` is left as it was. The family parameters and
        centroids must match; int8 rows requantize from ``other``'s scale
        to this one's. Global ids must not collide: ``id_offset`` shifts
        ``other``'s (e.g. by this index's ``_gid_bound()``). Returns the
        rows merged in."""
        if (self.kind, self.dim, self.metric, self.dtype, self.residual, self.nlist) != (
                other.kind, other.dim, other.metric, other.dtype, other.residual,
                other.nlist):
            raise ValueError("merge_from needs the same index family and parameters")
        if not np.allclose(self.centroids, other.centroids, rtol=1e-7, atol=1e-6):
            raise ValueError("merge_from needs the shared coarse quantizer (train once, "
                             "reuse for every worker's build)")
        p_s, id_s, a_s = self._export_rows()
        p_o, id_o, a_o = other._export_rows()
        p_o = p_o.to(self.device)
        if self.dtype == "int8" and other._scale != self._scale:
            ratio = f32_const(other._scale / self._scale, p_o)
            p_o = torch.clamp(torch.round(p_o.float() * ratio), -127, 127).to(torch.int8)
        if id_offset is not None:
            id_o = id_o + int(id_offset)
        both = np.concatenate([id_s, id_o])
        uniq = np.unique(both)
        if uniq.size != both.size:
            raise ValueError(f"{both.size - uniq.size} colliding global ids: pass "
                             "id_offset=self._gid_bound() (or any disjoint shift)")
        self._assemble_compact(torch.cat([p_s, p_o]), both, np.concatenate([a_s, a_o]))
        self._next_id = int(uniq[-1]) + 1 if uniq.size else 0
        return int(id_o.shape[0])

    def reconstruct(self, ids) -> np.ndarray:
        """(len(ids), D) f32 approximate rows (the dequantized payload, plus
        the list centroid of residual rows) for global ids in the arena,
        the pending buffer or the annex."""
        ids = np.asarray(ids, np.int64)
        ids_arr = np.asarray(self._ids, np.int64)
        valid = np.flatnonzero(ids_arr >= 0)
        bound = max(self._gid_bound(), 1)
        if ids.size and (ids.min() < 0 or ids.max() >= bound):
            raise ValueError("unknown id")
        pos = np.full(bound, -1, np.int64)
        pos[ids_arr[valid]] = valid
        out = np.empty((ids.shape[0], self.dim), np.float32)
        scale = self._scale if self.dtype == "int8" else 1.0
        in_arena = pos[ids] >= 0
        if in_arena.any():
            rows = pos[ids[in_arena]]
            dec = self._payload[torch.as_tensor(rows, device=self.device)].float().cpu().numpy()
            dec = dec * scale
            if self.residual:
                dec = dec + self.centroids[np.searchsorted(self._offsets, rows, "right") - 1]
            out[in_arena] = dec
        if (~in_arena).any():
            p_rows = [np.zeros((0, self.dim), np.float32)]
            p_ids, p_assign = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
            snap = self._pending.snapshot_full()
            if snap is not None:
                p_rows.append(snap[0].astype(np.float32))
                p_ids.append(snap[1])
                p_assign.append(snap[2])
            if self._annex is not None and self._annex["n"]:
                n = self._annex["n"]
                p_rows.append(self._annex["rows"][:n].cpu().numpy().astype(np.float32))
                p_ids.append(self._annex["ids"][:n])
                p_assign.append(self._annex["assign"][:n].cpu().numpy())
            p_rows, p_ids, p_assign = (np.concatenate(a) for a in (p_rows, p_ids, p_assign))
            ppos = np.full(bound, -1, np.int64)
            ppos[p_ids] = np.arange(p_ids.shape[0])
            sel = ppos[ids[~in_arena]]
            if (sel < 0).any():
                raise ValueError("unknown id")
            dec = p_rows[sel] * scale
            if self.residual:
                dec = dec + self.centroids[p_assign[sel]]
            out[~in_arena] = dec
        return out

    # -- pending and annex scans ------------------------------------------
    def _pending_device(self):
        """(rows, ids, ids int32 on the device, n) of the pending rows,
        staged once per pending state. Residual rows are reconstructed on
        the host (centroid + scale·r8, as the reference) so their exact scan
        runs on plain rows at scale 1."""
        if self._pending_dev is None:
            snap = self._pending.snapshot_full()
            if snap is None:
                return None
            rows, pids, passign = snap
            if self.residual:
                rows = self.centroids[passign] + rows.astype(np.float32) * self._scale
            self._pending_dev = (torch.as_tensor(rows, device=self.device), pids,
                                 torch.as_tensor(pids.astype(np.int32), device=self.device),
                                 rows.shape[0])
        return self._pending_dev

    def _pending_scan_scale(self) -> float:
        if self.residual:
            return 1.0  # rows already reconstructed
        return self._scale if self.dtype == "int8" else 1.0

    def _annex_ids_device(self) -> torch.Tensor:
        """The annex's (n,) int32 ids on the device, cached per annex
        version (folds append, removes swap; both bump it)."""
        ax = self._annex
        if ax.get("ids_dev_ver") != self._annex_ver:
            ax["ids_dev"] = torch.as_tensor(ax["ids"][: ax["n"]].astype(np.int32),
                                            device=self.device)
            ax["ids_dev_ver"] = self._annex_ver
        return ax["ids_dev"]

    def _merge_pending_topk(self, v, gids, queries, k: int, flt=None):
        """The arena's top-k (v, gids on the device) merged with exact scans
        of the pending rows and the annex: one stable top-k over [arena,
        pending, annex] (ties to the earlier), for ``search`` and
        ``search_device`` alike. ``flt`` masks pending and annex rows before
        their top-k, so a query keeps its best allowed rows however many
        disallowed ones outrank them (the reference masks after the top-k
        and can lose them); unfilled slots are (-inf, -1)."""
        pdev = self._pending_device()
        ax = self._annex
        n_annex = ax["n"] if ax is not None else 0
        if pdev is None and not n_annex:
            return v, gids
        with span("cvdb.pending"):
            extra_v, extra_i = [], []
            l2 = self.metric == "l2"
            if pdev is not None:
                rows, _, pids_dev, n = pdev
                pv, pi = _pending_scan(
                    queries, rows, self._pending_scan_scale(), k=min(k, n), l2=l2,
                    allow=None if flt is None else flt.allowed_dev(pids_dev))
                extra_v.append(pv)
                extra_i.append(pids_dev[pi])
            if n_annex:
                ids_dev = self._annex_ids_device()
                av, ap = _annex_scan(queries, ax["rows"][:n_annex], ax["assign"][:n_annex],
                                     self._device_state()["centroids"], self._scale,
                                     k=min(k, n_annex), resid=self.residual, l2=l2,
                                     allow=None if flt is None else flt.allowed_dev(ids_dev))
                extra_v.append(av)
                extra_i.append(ids_dev[ap])
            all_v = torch.cat([v, *extra_v], dim=1)
            all_i = torch.cat([gids.to(torch.int32), *extra_i], dim=1)
            v2, pos = topk_stable(all_v, k)
            out_i = torch.gather(all_i, 1, pos)
            if flt is not None:
                out_i = torch.where(v2 > NEG_INF, out_i, -1)
            return v2, out_i

    # -- search -----------------------------------------------------------
    def _device_state(self) -> dict:
        if self._dev is None:
            dev = self.device
            self._dev = dict(
                payload=self._payload,
                centroids=torch.as_tensor(self.centroids, dtype=torch.float32, device=dev),
                ids=torch.as_tensor(self._ids.astype(np.int32), device=dev),
                tile_window=torch.as_tensor(self._tile_window, device=dev).long(),
            )
            if self.residual:
                self._dev.update(
                    local=torch.as_tensor(self._local, device=dev),
                    centroid_tiles=torch.as_tensor(self._centroid_tiles, device=dev).to(
                        torch.bfloat16),
                    valid_end=torch.as_tensor(self._valid_end, device=dev),
                )
        return self._dev

    def make_filter(self, where):
        """``where`` (an IdFilter, a bool mask by global id, or an array of
        allowed gids) as an IdFilter over this index's id space. Build once
        and reuse: its device bitmap and arena mask are cached."""
        from cloudvectordb_tpu_torch.index.filters import IdFilter

        return IdFilter.coerce(where, self._gid_bound())

    def search(self, queries, k: int, nprobe: int = 32, strategy: str = "tiles",
               p_tiles: int = 0, scoring: str = "hybrid", tile_q: int | None = None,
               where=None, top2: bool | None = None):
        """Numpy in, numpy out: (scores (Q, k) f32, ids (Q, k) int64).

        strategy='tiles' (default): device-planned, query-clustered tile
        probing in one dispatch; compute ∝ p_tiles/n_tiles of a full scan.
        p_tiles=0 and tile_q=None take the tuned op point, else the
        span-aware auto budget; top2=None takes the op point's, else False.
        strategy='band' (whole-row arenas): each query group scans a
        contiguous band of tiles (``_search_band``). scoring on int8
        arenas: residual arenas score the residual with int8 queries for
        'hybrid' and 'int8' and with bf16 queries for 'precise'; whole-row
        arenas score bf16 queries against the int8 rows for 'hybrid' and
        'precise' and int8 x int8 for 'int8'. ``where`` (residual arenas):
        an id predicate (``make_filter``), masked at score time; queries
        with fewer than k allowed hits return (-inf, -1) tails. top2 keeps
        each bucket's best two rows (2·L candidates). Pending and annex rows
        are scanned exactly and merged in (``_merge_pending_topk``)."""
        assert self._n, "empty index"
        queries = np.asarray(queries, np.float32)
        with span(SEARCH):
            flt = self.make_filter(where) if where is not None else None
            if strategy == "tiles":
                v, gids = self._search_tiles(queries, k, nprobe, p_tiles, scoring, tile_q,
                                             flt, top2, host=True)
            elif strategy == "band":
                if self.residual:
                    raise ValueError("band strategy lacks the centroid term; use tiles")
                if flt is not None:
                    raise ValueError("filtered search: use strategy='tiles' (residual "
                                     "arenas) or index.filters.filtered_search")
                v, gids = (torch.as_tensor(a, device=self.device)
                           for a in self._search_band(queries, k, nprobe))
                v, gids = self._merge_pending_topk(
                    v, gids, torch.as_tensor(queries, device=self.device), k, flt)
            else:
                raise ValueError(f"unknown strategy {strategy!r}")
            return _answers_out(v, gids)

    def search_device(self, queries, k: int, nprobe: int = 32,
                      p_tiles: int = 0, scoring: str = "hybrid",
                      tile_q: int | None = None, where=None, top2: bool | None = None):
        """All-device serving path: ``queries`` is (or becomes) a (B, D) f32
        tensor on the index's device and the returned (scores (B, k) f32,
        ids (B, k) int32) stay there — no host transfer or sync in the call
        once a filter's mask and the pending rows are staged. Knobs resolve
        as in ``search()``; pending and annex rows merge in as there."""
        assert self._n, "empty index"
        with span(SEARCH):
            flt = self.make_filter(where) if where is not None else None
            queries = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
            return self._search_tiles(queries, k, nprobe, p_tiles, scoring, tile_q, flt, top2,
                                      host=False)

    def _search_tiles(self, queries, k, nprobe, p_tiles, scoring, tile_q, flt, top2, host):
        """The tiles strategy's body under ``search()`` and ``search_device()``:
        the knobs resolved (``_resolve_knobs``), the batch padded to the
        query tile, the dispatch, pending and annex rows merged in. ``host``:
        ``queries`` is search()'s numpy batch, in through ``_queries_in``;
        else a device tensor, padded in place. (v, gids) on the device, one
        row a query."""
        nq = queries.shape[0]
        p_tiles, tq, top2 = self._resolve_knobs(nq, nprobe, p_tiles, tile_q, top2)
        qp = _queries_in(queries, tq, self.device) if host else pad_rows(queries, tq)
        v, gids = self._tiles_kernel_dispatch(qp, k, p_tiles, tq, scoring, flt, top2)
        return self._merge_pending_topk(v[:nq], gids[:nq], qp[:nq], k, flt)

    def _resolve_knobs(self, nq: int, nprobe: int, p_tiles: int, tile_q, top2=None):
        """(p_tiles, tile_q, top2) of a tiles search: the op point or the
        default for knobs at their sentinels (``_op_knobs``), the
        small-batch query tile (``query_tile``), the span-aware auto
        coverage."""
        kn = self._op_knobs(p_tiles=p_tiles, tile_q=tile_q, top2=top2)
        tq = query_tile(kn["tile_q"], self.tile_q, nq)
        p_tiles = kn["p_tiles"] or self._auto_p_tiles(nq, nprobe, self._tune_n_tiles(), tile_q=tq)
        return p_tiles, tq, kn["top2"]

    def _arena_filter(self, flt):
        """(K1's (and K5's) arena-order allow bits for ``flt``, the plan's
        (n_tiles,) bool live tiles, the filter's counts), cached per
        (filter, device id table, the table's version): the (N,) gid gather,
        the tile reduction and the counts' one sync run once per filter and
        arena state. The version counts in-place writes to the ids tensor,
        so a mutation that keeps the tensor still misses. The counts are
        host ints: ``allowed_rows`` (arena rows the filter allows),
        ``live_tiles`` (tiles holding one) and ``live_rows`` (live_tiles ·
        tile_n, the rows a plan can choose from)."""
        ids = self._device_state()["ids"]
        key = (id(flt), id(ids), ids._version)
        hit = self._flt_cache.get(key)
        if hit is None:
            if len(self._flt_cache) > 32:  # bound multi-tenant rotation
                self._flt_cache.clear()
            rm = _arena_mask_from_ids(ids, flt.mask_device(self.device),
                                      n_pad=self._mask_pad_rows())
            live = _tile_live(rm, self.tile_n)
            n_allowed, n_live = torch.stack([rm.sum(), live.sum()]).tolist()
            counts = {"allowed_rows": n_allowed, "live_tiles": n_live,
                      "live_rows": n_live * self.tile_n}
            # the entry holds the filter and ids, so their ids stay unique
            self._flt_cache[key] = hit = (flt, ids, self._split_row_mask(rm), live, counts)
        return hit[2:]

    def _mask_pad_rows(self) -> int:
        """The padded arena row count a filter mask must cover."""
        return int(self._payload.shape[0])

    def _split_row_mask(self, rm):
        return rm  # a segmented arena would re-slice it

    def _arena_row_bias(self) -> torch.Tensor:
        """K1's (N_pad,) f32 l2 row bias (ops/band.py::resid_row_bias),
        cached per arena state: the payload and local-id tensors, their
        versions (an in-place add, remove or merge bumps the payload's) and
        the scale. The entry holds the tensors, so their ids stay unique."""
        st = self._device_state()
        pay, loc = st["payload"], st["local"]
        key = (id(pay), pay._version, id(loc), loc._version, self._scale)
        if self._bias_cache is None or self._bias_cache[0] != key:
            bias = resid_row_bias(pay, loc, st["centroid_tiles"], self._scale, self.tile_n)
            self._bias_cache = (key, (pay, loc), bias)
        return self._bias_cache[2]

    def _tiles_kernel_dispatch(self, qp, k, p_tiles, tq, scoring, flt=None, top2=False):
        """One device dispatch of the tiles search over the arena: qp a
        (q_pad, D) f32 tensor on the device, q_pad a multiple of tq.
        Returns (v (q_pad, k) f32, gids (q_pad, k) int32) on the device."""
        if scoring not in ("hybrid", "int8", "precise"):
            raise ValueError(f"unknown scoring {scoring!r}")
        st = self._device_state()
        if self.residual:
            l2 = self.metric == "l2"
            row_mask = tile_live = None
            if flt is not None:
                # the span carries the cached counts: a hit adds no device op
                with span("cvdb.filter") as sp:
                    row_mask, tile_live, counts = self._arena_filter(flt)
                    if sp is not None:
                        sp.counts.update(counts)
            return _tiles_resid_plan_search(
                qp, st["centroids"], st["payload"], st["local"],
                st["centroid_tiles"], self._scale, st["ids"],
                st["tile_window"], st["valid_end"], row_mask=row_mask,
                k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
                int8_q=(scoring != "precise"), l2=l2, top2=top2,
                row_bias=self._arena_row_bias() if l2 else None, tile_live=tile_live,
            )
        if flt is not None:
            raise ValueError("where= masks at score time in the residual-int8 kernel; for "
                             "whole-row arenas use index.filters.filtered_search")
        if self.dtype == "int8":
            # 'precise' maps to the hybrid scan: two-sided int8 is the
            # noisiest mode and serves scoring='int8' only
            int8 = True if scoring == "int8" else "hybrid"
        else:
            int8 = False
        return _tiles_plan_search(
            qp, st["centroids"], st["payload"], st["ids"], st["tile_window"],
            self._scale, self._n, k=k, p_tiles=p_tiles, tile_n=self.tile_n,
            tile_q=tq, int8=int8, top2=top2)

    def _search_band(self, queries: np.ndarray, k: int, nprobe: int):
        """Contiguous-band search (whole-row arenas; kept for comparison:
        1-D id locality is weak in high dimensions, so bands prune poorly):
        the host plan (``_plan_band``), the band scan (K7) and the unsort."""
        nq = queries.shape[0]
        st = self._device_state()
        perm, q_dev, q_scale, band_start, band_tiles = self._plan_band(queries, nprobe)
        v, rows = band_topk(
            st["payload"], q_dev, band_start, k, band_tiles=band_tiles,
            tile_n=self.tile_n, tile_q=self.tile_q, int8=self.dtype == "int8",
            n_valid=self._n)
        v = v.cpu().numpy() * (q_scale * self._scale)
        gids = st["ids"][rows.long().clamp(0, self._n - 1)].cpu().numpy()

        # unsort: perm[pos] is the caller's index of the query at sorted
        # position pos; positions >= nq are padding
        out_v = np.empty((nq, v.shape[1]), np.float32)
        out_i = np.empty((nq, v.shape[1]), np.int64)
        out_v[perm[:nq]] = v[:nq]
        out_i[perm[:nq]] = gids[:nq]
        return out_v, out_i

    def _plan_band(self, queries: np.ndarray, nprobe: int):
        """Host band planning: each query's nprobe nearest lists give it an
        id band [lo, hi]; queries sort by band centre into groups of tile_q
        (the last query repeated to fill the last group); each group scans
        the arena tiles covering its union band, band_tiles of them (the
        widest band, bucketed to a power of two), its start clamped so the
        band ends inside the arena. Returns (perm, device queries in the
        score mode's type, (Q_pad, 1) f32 query scales, (n_qt,) int32
        band_start on the device, band_tiles)."""
        nprobe = min(nprobe, self.nlist)
        st = self._device_state()
        _, probed = tiled_topk(st["centroids"], torch.as_tensor(queries, device=self.device),
                               nprobe, metric="l2", tile=min(8192, self.nlist))
        probed = probed.cpu().numpy()
        lo = probed.min(axis=1)
        hi = probed.max(axis=1)

        perm = pad_rows(np.argsort(lo + hi, kind="stable"), self.tile_q)
        q_pad = perm.shape[0]
        q_sorted = queries[perm]
        lo_s, hi_s = lo[perm], hi[perm]

        n_tiles = int(self._payload.shape[0]) // self.tile_n
        n_qt = q_pad // self.tile_q
        t0 = np.empty(n_qt, np.int64)
        t1 = np.empty(n_qt, np.int64)
        for i in range(n_qt):
            sl = slice(i * self.tile_q, (i + 1) * self.tile_q)
            row_lo = self._offsets[lo_s[sl].min()]
            row_hi = self._offsets[hi_s[sl].max() + 1]
            t0[i] = row_lo // self.tile_n
            t1[i] = -(-max(int(row_hi), int(row_lo) + 1) // self.tile_n)
        band_tiles = min(_next_pow2(int((t1 - t0).max())), n_tiles)
        band_start = np.minimum(t0, n_tiles - band_tiles).astype(np.int32)

        if self.dtype == "int8":
            q_amax = np.maximum(np.abs(q_sorted).max(axis=1, keepdims=True), 1e-12)
            q_scale = q_amax / 127.0
            q_dev = torch.as_tensor(
                np.clip(np.round(q_sorted / q_scale), -127, 127).astype(np.int8),
                device=self.device)
        else:
            q_scale = np.ones((q_pad, 1), np.float32)
            q_dev = torch.as_tensor(q_sorted, device=self.device).to(st["payload"].dtype)
        return (perm, q_dev, q_scale,
                torch.as_tensor(band_start, device=self.device), band_tiles)

    def _auto_p_tiles(self, nq: int, nprobe: int, n_tiles: int,
                      tile_q: int | None = None) -> int:
        """Span-aware tile budget (``auto_p_tiles``) of this arena."""
        return auto_p_tiles(self._n, self.nlist, self.tile_n, tile_q or self.tile_q, nq,
                            nprobe, n_tiles)

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_tile_qs(self, nq: int) -> list[int]:
        """Query-tile sizes worth trying: smaller tiles make each group's
        shared tile table more specific, at more planning work."""
        cand = {self.tile_q, 32, 64, 128}
        return sorted(t for t in cand if t <= max(32, nq))

    def _tune_n_tiles(self) -> int:
        return int(self._payload.shape[0]) // self.tile_n

    def _tune_candidates(self, nq: int) -> list[dict]:
        n_tiles = self._tune_n_tiles()
        seen, out = set(), []
        for tq in self._tune_tile_qs(nq):
            for p in coverage_ladder(self._auto_p_tiles(nq, 32, n_tiles, tile_q=tq), n_tiles):
                if (p, tq) not in seen:
                    seen.add((p, tq))
                    out.append({"p_tiles": p, "tile_q": tq})
        # scan cost ∝ p_tiles · query-groups; prefer larger tile_q at equal
        # coverage (fewer groups, one shared table each)
        out.sort(key=lambda c: (c["p_tiles"], -c["tile_q"]))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        # full tile coverage ≡ an exact scan up to arena quantization
        return {"p_tiles": self._tune_n_tiles()}

    # -- persistence ------------------------------------------------------
    def _state_arrays(self) -> dict:
        self.merge_pending()  # one arena on disk: pending and annex rows merge first
        out = {
            "centroids": self.centroids,
            "payload": to_numpy(self._payload),
            "ids": self._ids,
            "offsets": self._offsets,
        }
        if self._list_lens is not None:
            out["list_lens"] = self._list_lens
        return out

    def _state_meta(self) -> dict:
        return {
            "nlist": self.nlist, "dtype": self.dtype, "scale": self._scale,
            "n": self._n, "kmeans_iters": self.kmeans_iters, "seed": self.seed,
            "tile_n": self.tile_n, "tile_q": self.tile_q,
            "residual": self.residual, "slack": self.slack,
            "next_id": self._gid_bound(),
        }

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, device: str | torch.device = DEFAULT,
                   metric: str = "ip") -> "BandIVFIndex":
        """Index from the reference's numpy state: ``meta`` as its
        ``_state_meta()`` (the manifest's "meta"), ``arrays`` as its
        ``_state_arrays()`` (centroids, payload, ids, offsets, list_lens),
        ``metric`` as its ``metric`` (the manifest's top level). The derived
        tables (tile_window, local, centroid_tiles, valid_end) are
        recomputed here."""
        dim = int(np.asarray(arrays["centroids"]).shape[1])
        idx = cls(dim, meta["nlist"], meta["dtype"], meta["kmeans_iters"],
                  meta["seed"], meta["tile_n"], meta["tile_q"],
                  residual=meta.get("residual", False),
                  slack=meta.get("slack", 0.0), metric=metric, device=device)
        idx.centroids = np.array(arrays["centroids"], np.float32)  # off the mmap
        if "list_lens" in arrays:
            idx._list_lens = np.array(arrays["list_lens"], np.int64)
        payload = from_numpy(arrays["payload"], _ARENA_DTYPES[idx.dtype])
        idx._set_arena(payload.to(idx.device), np.array(arrays["ids"], np.int64),
                       np.asarray(arrays["offsets"], np.int64), int(meta["n"]),
                       float(meta["scale"]))
        idx._next_id = int(meta.get("next_id", 0))
        return idx

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "BandIVFIndex":
        idx = cls.from_state(manifest["meta"], arrays, device=device,
                             metric=manifest.get("metric", "ip"))
        if idx.dim != manifest["dim"]:
            raise ValueError(f"manifest dim {manifest['dim']} != centroids {idx.dim}")
        return idx
