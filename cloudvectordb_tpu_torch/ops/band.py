"""Tile scans over an arena (counterpart of cloudvectordb_tpu/ops/pallas_band.py:
``order_centroids``, ``tiles_topk_resid_pallas`` (K1), ``tiles_topk_pallas``
(K3) and ``band_topk_pallas`` (K7); K2, ``flat_topk_pallas``, is
ops/flat_topk.py on the same scan).

Each wrapper dispatches on the device of its tensors: CUDA tensors go to a
hand-written kernel (K1 ``csrc/tiles_resid.cu``; K2, K3 and K7 one kernel,
``csrc/tiles_scan.cu``; built and bound by ``ops/_cuda.py``), CPU tensors to
the plain version (``*_reference``). There is no third path and no
fallback: a kernel that fails to build or launch raises.

The bucketed-slot merge, written once (``_bucket_merge``; its CUDA twin is
``csrc/slot_merge.cuh``). Each query keeps ``l_buckets`` slots (L). Within a
tile, bucket ``b`` takes the best of rows ``t·tile_n + r·L + b`` over r (the
smallest r on ties); across steps a strict ``>`` keeps the earlier step on
ties. Slots start at (-inf, row 0). The final top-k over the slots is a
stable descending sort, so ties go to the lower slot as ``lax.top_k`` does.

K1 (the reference kernel ``_tiles_resid_kernel``). For query tile ``qt``,
table entry ``p``, arena tile ``t = tile_table[qt, p]`` and arena row ``g``
of that tile::

    score = bf16(q)·bf16(c[local[g]])  (f32 accumulation)
            + row_scale[q] · (q8 · r8[g])  (exact int32)
    live  = g < valid_end[t, local[g]]

Its options, each the reference's expression:
  - ``int8_q=False`` (``scoring='precise'``): the residual term is
    ``bf16(q)·bf16(r8[g])`` with f32 accumulation and ``row_scale`` is
    ``resid_scale`` for every query;
  - ``row_mask`` (N_pad,) int8 allow bits: a row whose bit is 0 is not live;
  - ``l2``: the score gains the row's bias ``-s²‖r‖²/2 - s·(c·r) - ‖c‖²/2``
    (``s`` the global ``resid_scale``, ``c`` the row's bf16 list centroid,
    all in f32; ``resid_row_bias``), so the ranking key is
    ``q·x̂ - ‖x̂‖²/2``;
  - ``top2``: each bucket keeps its best two distinct rows
    (``_bucket_merge_top2``) and the final top-k runs over the 2·L slots
    laid side by side.

K3 and K7 (``_tiles_kernel``, ``_band_kernel``): whole rows, step j of
query tile qt reads tile ``tile_table[qt, j]`` (K3) or ``band_start[qt] +
j`` (K7), scores ``q·row[g]`` under the mode the reference's ``int8`` flag
names (``_score_tile``), and rows ``g >= n_valid`` score -inf. K3 takes
``top2`` as K1 does; K7 has none, as the reference's band kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.ops.topk import NEG_INF, f32_const, topk_stable
from cloudvectordb_tpu_torch.utils.metrics import span

#: where step j of a whole-row scan reads, as csrc/tiles_scan.cu numbers it:
#: tile j (K2), tile_table[qt, j] (K3), band_start[qt] + j (K7)
SCAN_ALL, SCAN_TABLE, SCAN_BAND = 0, 1, 2


def order_centroids(centroids: np.ndarray) -> np.ndarray:
    """Locality-preserving centroid permutation: recursive balanced 2-means.

    A 1-D projection (PC1, space-filling curve) cannot localize 768-d probe
    sets (measured: bands/unions degenerate to the whole arena). The
    hierarchical ordering puts genuinely similar centroids at adjacent ids at
    EVERY scale — a query's nprobe nearest lists then concentrate in a small
    id range, so query tiles (sorted by top-1 id) share small tile unions.
    """
    c = np.asarray(centroids, np.float64)
    rng = np.random.default_rng(0)

    def rec(idx: np.ndarray) -> list[int]:
        if len(idx) <= 2:
            return idx.tolist()
        sub = c[idx]
        # 2-means direction (few Lloyd rounds), then a balanced median split
        picks = rng.choice(len(idx), 2, replace=False)
        c0, c1 = sub[picks[0]].copy(), sub[picks[1]].copy()
        for _ in range(6):
            d0 = ((sub - c0) ** 2).sum(1)
            d1 = ((sub - c1) ** 2).sum(1)
            m = d0 <= d1
            if m.any():
                c0 = sub[m].mean(0)
            if (~m).any():
                c1 = sub[~m].mean(0)
        proj = sub @ (c1 - c0)
        order = np.argsort(proj, kind="stable")
        half = len(idx) // 2
        return rec(idx[order[:half]]) + rec(idx[order[half:]])

    return np.asarray(rec(np.arange(len(c))), dtype=np.int64)


def _quantize_queries(queries_sorted: torch.Tensor, resid_scale: float):
    """(bf16 queries, int8 queries, (Q,) f32 row scale) — the reference's
    expressions (pallas_band.py:675-680), so q8 matches it byte for byte
    (torch.round, like jnp.round, rounds half to even; the constants are
    f32 tensors, see ``f32_const``)."""
    qf = queries_sorted.float()
    q_amax = qf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    c127 = f32_const(127.0, qf)
    q8 = torch.clamp(torch.round(qf * (c127 / q_amax)), -127, 127).to(torch.int8)
    row_scale = ((q_amax / c127) * f32_const(resid_scale, qf)).reshape(-1)
    return qf.to(torch.bfloat16), q8, row_scale


def _resolve_buckets(tile_n: int, l_buckets: int) -> int:
    l_buckets = min(l_buckets or tile_n, tile_n)  # 0: L = tile_n (R = 1)
    if tile_n % l_buckets:
        raise ValueError(f"l_buckets {l_buckets} must divide tile_n {tile_n}")
    return l_buckets


def _check_args(db_resid, local_ids, centroid_tiles, queries_sorted,
                tile_table, valid_end, tile_n, tile_q, l_buckets, row_mask=None,
                row_bias=None) -> int:
    """Validate shapes and options; return the resolved l_buckets."""
    n, d = db_resid.shape
    nq = queries_sorted.shape[0]
    if n % tile_n or nq % tile_q:
        raise ValueError(f"rows {n} / queries {nq} not multiples of "
                         f"tile_n {tile_n} / tile_q {tile_q}")
    if d % 4:
        raise ValueError(f"D={d} must be a multiple of 4")
    l_buckets = _resolve_buckets(tile_n, l_buckets)
    n_tiles = n // tile_n
    w = centroid_tiles.shape[1]
    if tuple(centroid_tiles.shape) != (n_tiles, w, d):
        raise ValueError(f"centroid_tiles {tuple(centroid_tiles.shape)} != "
                         f"({n_tiles}, W, {d})")
    if tuple(valid_end.shape) != (n_tiles, w):
        raise ValueError(f"valid_end {tuple(valid_end.shape)} != ({n_tiles}, {w})")
    for name, t in (("local_ids", local_ids), ("row_mask", row_mask),
                    ("row_bias", row_bias)):
        if t is not None and t.numel() != n:
            raise ValueError(f"{name} has {t.numel()} entries, arena {n}")
    if tile_table.dim() != 2 or tile_table.shape[0] != nq // tile_q:
        raise ValueError(f"tile_table {tuple(tile_table.shape)} needs "
                         f"{nq // tile_q} rows")
    if db_resid.dtype != torch.int8:
        raise TypeError(f"arena must be int8, got {db_resid.dtype}")
    if row_mask is not None and row_mask.dtype not in (torch.int8, torch.uint8, torch.bool):
        raise TypeError(f"row_mask must be int8 allow bits, got {row_mask.dtype}")
    devices = {t.device for t in (db_resid, local_ids, centroid_tiles, queries_sorted,
                                  tile_table, valid_end, row_mask, row_bias)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return l_buckets


def _slots_init(n_qt: int, tile_q: int, l_buckets: int, dev, top2: bool = False):
    """(n_qt, tile_q, L) slots at (-inf, row 0): [values, rows], and with
    top2 [values, rows] of slot 2 after them."""
    shape = (n_qt, tile_q, l_buckets)
    return [t for _ in range(2 if top2 else 1)
            for t in (torch.full(shape, NEG_INF, device=dev),
                      torch.zeros(shape, dtype=torch.int64, device=dev))]


def _bucket_merge(scores, base, l_buckets: int, best_v, best_i):
    """One step of the bucketed-slot merge (module docstring; the plain twin
    of csrc/slot_merge.cuh). ``scores`` (n_qt, tile_q, tile_n) are the
    step's tile scores with masked rows at -inf, ``base`` (n_qt,) int64 the
    arena row of each tile's first row, ``best_*`` the (n_qt, tile_q, L)
    running slots. Returns the updated slots."""
    n_qt, tile_q, tile_n = scores.shape
    r_per = tile_n // l_buckets
    dev = scores.device
    s4 = scores.view(n_qt, tile_q, r_per, l_buckets)
    mx = s4.amax(dim=2)
    r_iota = torch.arange(r_per, device=dev).view(1, 1, r_per, 1)
    r_star = torch.where(s4 >= mx[:, :, None, :], r_iota, r_per).amin(dim=2)
    b_iota = torch.arange(l_buckets, device=dev, dtype=torch.int64)
    new_idx = base[:, None, None] + r_star * l_buckets + b_iota
    better = mx > best_v
    return torch.where(better, mx, best_v), torch.where(better, new_idx, best_i)


def _bucket_merge_top2(scores, base, l_buckets: int, v1, i1, v2, i2):
    """One step of the top-2 slot merge (the plain twin of
    csrc/slot_merge.cuh's ``tile_take2``/``slot_merge2``; the reference's
    ``pallas_pq.py:255-292``). Each bucket keeps its best two distinct
    rows: slot 1 (``v1``, ``i1``) and slot 2 (``v2``, ``i2``), each
    (n_qt, tile_q, L). Within the tile the runner-up is the best row other
    than the winner, the smallest r on ties. Across steps the new slot 1 is
    the better of (slot 1, tile best) by a strict ``>``; the loser of that
    pair races ``max(slot 2, tile runner-up)`` for slot 2, except when the
    tile best is the row already in slot 1 (a repeated table entry). A
    bucket whose rows are all masked scores -inf and never wins. Returns
    the updated (v1, i1, v2, i2)."""
    n_qt, tile_q, tile_n = scores.shape
    r_per = tile_n // l_buckets
    dev = scores.device
    s4 = scores.view(n_qt, tile_q, r_per, l_buckets)
    r_iota = torch.arange(r_per, device=dev).view(1, 1, r_per, 1)
    b_iota = torch.arange(l_buckets, device=dev, dtype=torch.int64)
    mx = s4.amax(dim=2)
    r_star = torch.where(s4 >= mx[:, :, None, :], r_iota, r_per).amin(dim=2)
    s4b = torch.where(r_iota == r_star[:, :, None, :], NEG_INF, s4)
    mx2 = s4b.amax(dim=2)
    r2 = torch.where(s4b >= mx2[:, :, None, :], r_iota, r_per).amin(dim=2)
    new_idx = base[:, None, None] + r_star * l_buckets + b_iota
    new_idx2 = base[:, None, None] + r2 * l_buckets + b_iota
    use_t = mx > v1
    dup = ~use_t & (new_idx == i1)
    lo = torch.where(dup, NEG_INF, torch.where(use_t, v1, mx))
    lo_i = torch.where(use_t, i1, new_idx)
    c2 = torch.maximum(v2, mx2)
    c2_i = torch.where(mx2 > v2, new_idx2, i2)
    win2 = lo > c2
    return (torch.where(use_t, mx, v1), torch.where(use_t, new_idx, i1),
            torch.where(win2, lo, c2), torch.where(win2, lo_i, c2_i))


def _slots_out(top2: bool, nq: int, l_buckets: int, v1, i1, v2=None, i2=None):
    """(Q, L) slots, or with top2 the (Q, 2·L) slots of both ranks side by
    side (slot 1's L buckets, then slot 2's), as the reference lays them."""
    v1, i1 = v1.reshape(nq, l_buckets), i1.reshape(nq, l_buckets)
    if not top2:
        return v1, i1.int()
    return (torch.cat([v1, v2.reshape(nq, l_buckets)], 1),
            torch.cat([i1, i2.reshape(nq, l_buckets)], 1).int())


def _merge_step(scores, base, l_buckets: int, slots: list, top2: bool) -> list:
    if top2:
        return list(_bucket_merge_top2(scores, base, l_buckets, *slots))
    return list(_bucket_merge(scores, base, l_buckets, *slots))


def _slots_reference(db_resid, local_ids, centroid_tiles, q_bf16, q_dot,
                     row_scale, tile_table, valid_end, tile_n, tile_q,
                     l_buckets, row_mask=None, row_bias=None, top2=False):
    """Plain PyTorch slot scan: (Q_pad, L) f32 values and (Q_pad, L) int32
    rows (top2: (Q_pad, 2·L), ``_slots_out``). Walks the table entries in
    order, each one vectorized over query tiles. ``q_dot`` is the residual
    term's queries: int8 (``int8_q``) or bf16; the dot runs in float64,
    exact for int8 queries and for bf16 ones but for one rounding to f32.
    ``row_mask`` (N,) allow bits and ``row_bias`` (N,) f32 l2 bias are
    optional."""
    n, d = db_resid.shape
    nq = q_dot.shape[0]
    n_qt, p = tile_table.shape
    dev = db_resid.device
    rows3 = db_resid.view(n // tile_n, tile_n, d)
    local3 = local_ids.reshape(n // tile_n, tile_n).long()
    mask3 = None if row_mask is None else row_mask.reshape(n // tile_n, tile_n) != 0
    bias3 = None if row_bias is None else row_bias.reshape(n // tile_n, tile_n)
    qdt = q_dot.view(n_qt, tile_q, d).double()
    qbt = q_bf16.view(n_qt, tile_q, d).float()
    rst = row_scale.view(n_qt, tile_q, 1)
    ct = centroid_tiles.to(torch.bfloat16).float()
    row_iota = torch.arange(tile_n, device=dev, dtype=torch.int64)
    slots = _slots_init(n_qt, tile_q, l_buckets, dev, top2)
    for j in range(p):
        t = tile_table[:, j].long()  # (n_qt,)
        r_scores = torch.bmm(qdt, rows3[t].double().transpose(1, 2)).float()
        qc = torch.bmm(qbt, ct[t].transpose(1, 2))  # (n_qt, tile_q, W) f32
        loc = local3[t]  # (n_qt, tile_n)
        c_scores = torch.gather(qc, 2, loc[:, None, :].expand(-1, tile_q, -1))
        scores = c_scores + rst * r_scores
        if bias3 is not None:
            scores = scores + bias3[t][:, None, :]
        g = t[:, None] * tile_n + row_iota[None, :]
        live = g < torch.gather(valid_end[t].long(), 1, loc)
        if mask3 is not None:
            live = live & mask3[t]
        scores = torch.where(live[:, None, :], scores, NEG_INF)
        slots = _merge_step(scores, t * tile_n, l_buckets, slots, top2)
    return _slots_out(top2, nq, l_buckets, *slots)


def _final_topk(out_v, out_i, k):
    top_v, pos = topk_stable(out_v, min(k, out_v.shape[1]))
    return top_v, torch.gather(out_i, 1, pos)


def _row_bias_tiles(rows, ct, loc, s):
    """The l2 bias of every row of some tiles (``resid_row_bias``'s plain
    expression, the reference's pallas_band.py:518-549 in f32): rows
    (T, tile_n, D) int8, ct (T, W, D) f32 centroid tiles, loc (T, tile_n)
    local list ids, s the f32 residual scale as a 0-d tensor."""
    r = rows.float()
    rr = (r * r).sum(dim=2)  # exact: integers below 2^24
    cr = torch.gather(torch.bmm(r, ct.transpose(1, 2)), 2, loc[:, :, None])[:, :, 0]
    cc = torch.gather((ct * ct).sum(dim=2), 1, loc)
    half = f32_const(0.5, rows)
    return ((-half * s) * s) * rr - s * cr - half * cc


def resid_row_bias_reference(db_resid, local_ids, centroid_tiles, resid_scale,
                             tile_n: int):
    """Plain version of ``resid_row_bias``, 64 tiles at a time."""
    chunk_tiles = 64
    n, d = db_resid.shape
    n_tiles = n // tile_n
    rows3 = db_resid.view(n_tiles, tile_n, d)
    local3 = local_ids.reshape(n_tiles, tile_n).long()
    ct = centroid_tiles.to(torch.bfloat16).float()
    s = f32_const(resid_scale, db_resid)
    parts = [_row_bias_tiles(rows3[a:a + chunk_tiles], ct[a:a + chunk_tiles],
                             local3[a:a + chunk_tiles], s).reshape(-1)
             for a in range(0, n_tiles, chunk_tiles)]
    return torch.cat(parts) if parts else torch.zeros(0, device=db_resid.device)


def resid_row_bias(db_resid, local_ids, centroid_tiles, resid_scale, tile_n: int):
    """(N_pad,) f32 l2 bias of every arena row of a residual-int8 arena:
    ``-s²‖r‖²/2 - s·(c·r) - ‖c‖²/2`` with ``s`` the residual scale, ``r``
    the row's int8 residual and ``c`` its bf16 list centroid
    (``centroid_tiles[g // tile_n, local[g]]``). It depends on the arena
    only, so an index computes it once per arena state. CUDA tensors launch
    the hand-written kernel (csrc/tiles_resid.cu ``resid_bias_kernel``);
    CPU tensors run the plain version."""
    n, d = db_resid.shape
    if n % tile_n or local_ids.numel() != n or tuple(centroid_tiles.shape[::2]) != (
            n // tile_n, d):
        raise ValueError(f"arena {tuple(db_resid.shape)}, tile_n {tile_n}, local ids "
                         f"{local_ids.numel()}, centroid_tiles {tuple(centroid_tiles.shape)}")
    dev = db_resid.device
    if dev.type == "cuda":
        from cloudvectordb_tpu_torch.ops import _cuda

        out = _cuda.resid_row_bias(db_resid, local_ids, centroid_tiles.to(torch.bfloat16),
                                   resid_scale, tile_n=tile_n)
        resid_row_bias.launches += 1
        return out
    if dev.type != "cpu":
        raise NotImplementedError(f"no resid_row_bias path for {dev.type} tensors")
    return resid_row_bias_reference(db_resid, local_ids, centroid_tiles, resid_scale, tile_n)


resid_row_bias.launches = 0


def _resid_prepare(db_resid, local_ids, centroid_tiles, resid_scale, queries_sorted,
                   tile_table, valid_end, tile_n, tile_q, l_buckets, int8_q, row_mask,
                   l2, row_bias, bias_fn):
    """Checked arguments of K1 and its plain version: (l_buckets, bf16
    queries, the residual term's queries, row scales, mask, bias)."""
    if not l2 and row_bias is not None:
        raise ValueError("row_bias is the l2 key's; pass l2=True")
    l_buckets = _check_args(db_resid, local_ids, centroid_tiles, queries_sorted,
                            tile_table, valid_end, tile_n, tile_q, l_buckets,
                            row_mask, row_bias)
    q_bf16, q8, row_scale = _quantize_queries(queries_sorted, resid_scale)
    if not int8_q:  # the reference's row scale without the query's own
        q8 = q_bf16
        row_scale = f32_const(resid_scale, queries_sorted).expand(
            queries_sorted.shape[0]).contiguous()
    if row_mask is not None:
        row_mask = row_mask.reshape(-1)
        row_mask = row_mask.view(torch.uint8) if row_mask.dtype == torch.int8 else (
            row_mask.to(torch.uint8))
    if l2 and row_bias is None:
        row_bias = bias_fn(db_resid, local_ids, centroid_tiles, resid_scale, tile_n)
    if row_bias is not None:
        row_bias = row_bias.reshape(-1).float()
    return l_buckets, q_bf16, q8, row_scale, row_mask, row_bias


def tiles_topk_resid_reference(
    db_resid, local_ids, centroid_tiles, resid_scale, queries_sorted,
    tile_table, k: int, valid_end, tile_n: int = 2048, tile_q: int = 256,
    l_buckets: int = 0, int8_q: bool = True, row_mask=None, l2: bool = False,
    top2: bool = False, row_bias=None,
):
    """Plain PyTorch version of ``tiles_topk_resid`` on any device: the CPU
    path of the wrapper, and the kernel's yardstick on the card. With l2
    and no ``row_bias`` the bias is ``resid_row_bias_reference``'s."""
    l_buckets, q_bf16, q_dot, row_scale, row_mask, row_bias = _resid_prepare(
        db_resid, local_ids, centroid_tiles, resid_scale, queries_sorted, tile_table,
        valid_end, tile_n, tile_q, l_buckets, int8_q, row_mask, l2, row_bias,
        resid_row_bias_reference)
    out_v, out_i = _slots_reference(
        db_resid, local_ids, centroid_tiles, q_bf16, q_dot, row_scale,
        tile_table, valid_end, tile_n, tile_q, l_buckets, row_mask, row_bias, top2)
    return _final_topk(out_v, out_i, k)


#: queries one block of K1 holds (csrc/tc_scan.cuh ``Narrow::QB``); each
#: block reads every tile of its query tile's table once. K5 counts its
#: reads at the block width its launches report (ops/pq.py::pq_tiles_topk),
#: and at this one where its plain version, which has no grid, ran
SCAN_QB = 32
#: the span of one K1 or K5 dispatch
SCAN_SPAN = "cvdb.scan"


def scan_span(tile_table, tile_q: int, tile_bytes: int):
    """The ``cvdb.scan`` span of one K1 dispatch over ``tile_table``
    (n_qt, P): ``tile_reads``, the whole-tile reads its grid schedules,
    n_qt · P · ceil(tile_q / SCAN_QB) (slot blocks split a tile's buckets,
    not its reads), and ``tile_read_bytes``, those reads times
    ``tile_bytes``. A kernel that changes its schedule changes this count."""
    reads = tile_table.shape[0] * tile_table.shape[1] * -(-tile_q // SCAN_QB)
    return span(SCAN_SPAN, tile_reads=reads, tile_read_bytes=reads * tile_bytes)


def tiles_topk_resid(
    db_resid,        # (N_pad, D) int8 residual rows
    local_ids,       # (1, N_pad) or (N_pad,) uint8: per-row local list idx
    centroid_tiles,  # (n_tiles, W, D) bf16 per-tile list centroids
    resid_scale,     # float: residual dequant scale
    queries_sorted,  # (Q_pad, D) f32 pre-sorted queries
    tile_table,      # (n_qt, P) int32 arena-tile ids
    k: int,
    valid_end,       # (n_tiles, W) int32: one past each tile-list's last valid row
    tile_n: int = 2048,
    tile_q: int = 256,
    l_buckets: int = 0,
    int8_q: bool = True,   # False: bf16 queries in the residual term ('precise')
    row_mask=None,         # (1, N_pad) or (N_pad,) int8 allow bits (filtered search)
    l2: bool = False,      # rank by q·x̂ - ‖x̂‖²/2 (module docstring)
    top2: bool = False,    # best two distinct rows a bucket: 2·L candidates
    row_bias=None,         # (N_pad,) f32 l2 bias (resid_row_bias), computed if None
):
    """Top-k over residual-int8 arena tiles: (Q_pad, k) f32 scores and
    (Q_pad, k) int32 arena rows (module docstring). CUDA tensors launch the
    hand-written kernel; CPU tensors run the plain version."""
    dev = db_resid.device
    with scan_span(tile_table, tile_q, tile_n * (db_resid.shape[1] + 1)):
        l_buckets, q_bf16, q_dot, row_scale, row_mask, row_bias = _resid_prepare(
            db_resid, local_ids, centroid_tiles, resid_scale, queries_sorted, tile_table,
            valid_end, tile_n, tile_q, l_buckets, int8_q, row_mask, l2, row_bias,
            resid_row_bias)
        if dev.type == "cuda":
            from cloudvectordb_tpu_torch.ops import _cuda

            out_v, out_i = _cuda.tiles_resid_slots(
                db_resid, local_ids, centroid_tiles.to(torch.bfloat16), q_bf16, q_dot,
                row_scale, tile_table.to(torch.int32), valid_end.to(torch.int32),
                row_mask, row_bias, tile_n=tile_n, tile_q=tile_q, l_buckets=l_buckets,
                top2=top2)
            tiles_topk_resid.launches += 1
        elif dev.type == "cpu":
            out_v, out_i = _slots_reference(
                db_resid, local_ids, centroid_tiles, q_bf16, q_dot, row_scale,
                tile_table, valid_end, tile_n, tile_q, l_buckets, row_mask, row_bias, top2)
        else:
            raise NotImplementedError(f"no tiles_topk_resid path for {dev.type} tensors")
        return _final_topk(out_v, out_i, k)


#: kernel launches since the last reset (the card run resets and reads it)
tiles_topk_resid.launches = 0


# -- whole-row scans: K3 (tile table), K7 (band); K2 in ops/flat_topk.py ------
#: the (query, row) element types the scan takes, by the reference's int8
#: flag: True int8 x int8, 'hybrid' bf16 x int8, False the native dtypes
_NATIVE_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                 (torch.float32, torch.bfloat16)}


def _check_score_mode(queries, db, int8) -> None:
    pair = (queries.dtype, db.dtype)
    if int8 == "hybrid":
        ok = pair == (torch.bfloat16, torch.int8)
    elif int8:
        ok = pair == (torch.int8, torch.int8)
    else:
        ok = pair in _NATIVE_PAIRS
    if not ok:
        raise TypeError(f"int8={int8!r} does not score {queries.dtype} queries "
                        f"against {db.dtype} rows")


def _scan_reference(db, q, tiles, sqnorm, tile_n: int, tile_q: int,
                    l_buckets: int, n_valid: int, top2: bool = False):
    """Plain whole-row scan (K2, K3, K7): (Q, L) f32 slot values and (Q, L)
    int32 arena rows (top2: (Q, 2·L), ``_slots_out``). ``tiles`` (n_qt, S)
    int64 names the arena tile of each query tile at each step (n_qt = 1
    and tile_q = Q for the flat scan).
    Rows outside [0, n_valid) score -inf; only tile-sized row blocks are
    gathered, never a padded copy of ``db``. int8 x int8 dots are exact:
    every partial sum is an integer below 2^24 in f32 (D <= 1024), else the
    dot runs in float64."""
    n, d = db.shape
    nq = q.shape[0]
    n_qt = tiles.shape[0]
    dev = db.device
    acc = torch.float32
    if q.dtype == torch.int8 and 128 * 128 * d > 2**24:
        acc = torch.float64
    qt = q.to(acc).view(n_qt, tile_q, d)
    row_iota = torch.arange(tile_n, device=dev, dtype=torch.int64)
    slots = _slots_init(n_qt, tile_q, l_buckets, dev, top2)
    for j in range(tiles.shape[1]):
        t = tiles[:, j]
        g = t[:, None] * tile_n + row_iota  # (n_qt, tile_n)
        gc = g.clamp(0, n - 1)
        scores = torch.bmm(qt, db[gc].to(acc).transpose(1, 2)).float()
        if sqnorm is not None:  # the flat index's l2: 2 q·x - ||x||²
            scores = 2.0 * scores - sqnorm[gc][:, None, :]
        live = (g >= 0) & (g < n_valid)
        scores = torch.where(live[:, None, :], scores, NEG_INF)
        slots = _merge_step(scores, t * tile_n, l_buckets, slots, top2)
    return _slots_out(top2, nq, l_buckets, *slots)


def _scan_slots(source: int, db, q, table, steps: int, sqnorm, *, tile_n: int,
                tile_q: int, l_buckets: int, n_valid: int, plain: bool,
                top2: bool = False):
    """(Q, L) slots of a whole-row scan (top2: (Q, 2·L)): the plain version
    when ``plain`` or on CPU tensors, the kernel (csrc/tiles_scan.cu) on
    CUDA tensors. Returns (values, rows, launched)."""
    dev = db.device
    if plain or dev.type == "cpu":
        step = torch.arange(steps, device=dev, dtype=torch.int64)
        if source == SCAN_ALL:
            tiles = step[None, :]
        elif source == SCAN_TABLE:
            tiles = table.long()
        else:
            tiles = table.long()[:, None] + step
        out = _scan_reference(db, q, tiles, sqnorm, tile_n, tile_q, l_buckets, n_valid,
                              top2)
        return (*out, False)
    if dev.type != "cuda":
        raise NotImplementedError(f"no whole-row scan for {dev.type} tensors")
    from cloudvectordb_tpu_torch.ops import _cuda

    out = _cuda.tiles_scan_slots(
        source, db, q.contiguous(), None if table is None else table.to(torch.int32).contiguous(),
        sqnorm, n_qt=q.shape[0] // tile_q, tile_q=tile_q, steps=steps, tile_n=tile_n,
        l_buckets=l_buckets, n_valid=n_valid, top2=top2)
    return (*out, True)


def _check_arena(db, queries_sorted, tile_n: int, tile_q: int, int8, others=()) -> None:
    n = db.shape[0]
    nq = queries_sorted.shape[0]
    if n % tile_n or nq % tile_q:
        raise ValueError(f"rows {n} / queries {nq} not multiples of "
                         f"tile_n {tile_n} / tile_q {tile_q}")
    if queries_sorted.shape[1] != db.shape[1]:
        raise ValueError(f"queries D={queries_sorted.shape[1]} != rows D={db.shape[1]}")
    _check_score_mode(queries_sorted, db, int8)
    devices = {t.device for t in (db, queries_sorted, *others)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def _tiles_topk(db, queries_sorted, tile_table, k, tile_n, tile_q, l_buckets,
                int8, n_valid, top2, plain):
    _check_arena(db, queries_sorted, tile_n, tile_q, int8, (tile_table,))
    l_buckets = _resolve_buckets(tile_n, l_buckets)
    n_qt = queries_sorted.shape[0] // tile_q
    if tile_table.dim() != 2 or tile_table.shape[0] != n_qt:
        raise ValueError(f"tile_table {tuple(tile_table.shape)} needs {n_qt} rows")
    out_v, out_i, launched = _scan_slots(
        SCAN_TABLE, db, queries_sorted, tile_table, tile_table.shape[1], None,
        tile_n=tile_n, tile_q=tile_q, l_buckets=l_buckets,
        n_valid=db.shape[0] if n_valid is None else int(n_valid), plain=plain, top2=top2)
    tiles_topk.launches += launched
    return _final_topk(out_v, out_i, k)


def tiles_topk(
    db,              # (N_pad, D) whole rows: int8, bf16 or f32
    queries_sorted,  # (Q_pad, D) pre-sorted queries, as the score mode takes them
    tile_table,      # (n_qt, P) int32 arena-tile ids (repeats harmless)
    k: int,
    tile_n: int = 2048,
    tile_q: int = 256,
    l_buckets: int = 0,
    int8=False,      # True int8 x int8, 'hybrid' bf16 x int8, False native dtypes
    n_valid=None,    # true row count; rows >= n_valid never become candidates
    top2: bool = False,  # best two distinct rows a bucket: 2·L candidates
):
    """K3: top-k over each query tile's table of arena tiles: (Q_pad, k) f32
    scores and (Q_pad, k) int32 arena rows (module docstring). CUDA tensors
    launch the hand-written kernel; CPU tensors run the plain version."""
    return _tiles_topk(db, queries_sorted, tile_table, k, tile_n, tile_q,
                       l_buckets, int8, n_valid, top2, plain=False)


def tiles_topk_reference(db, queries_sorted, tile_table, k: int, tile_n: int = 2048,
                         tile_q: int = 256, l_buckets: int = 0, int8=False,
                         n_valid=None, top2: bool = False):
    """Plain PyTorch version of ``tiles_topk`` on any device: the CPU path
    of the wrapper, and the kernel's yardstick on the card."""
    return _tiles_topk(db, queries_sorted, tile_table, k, tile_n, tile_q,
                       l_buckets, int8, n_valid, top2, plain=True)


def _band_topk(db, queries_sorted, band_start, k, band_tiles, tile_n, tile_q,
               l_buckets, int8, n_valid, plain):
    _check_arena(db, queries_sorted, tile_n, tile_q, int8, (band_start,))
    l_buckets = _resolve_buckets(tile_n, l_buckets)
    n_qt = queries_sorted.shape[0] // tile_q
    if tuple(band_start.shape) != (n_qt,):
        raise ValueError(f"band_start {tuple(band_start.shape)} needs ({n_qt},)")
    out_v, out_i, launched = _scan_slots(
        SCAN_BAND, db, queries_sorted, band_start, band_tiles, None,
        tile_n=tile_n, tile_q=tile_q, l_buckets=l_buckets,
        n_valid=db.shape[0] if n_valid is None else int(n_valid), plain=plain)
    band_topk.launches += launched
    return _final_topk(out_v, out_i, k)


def band_topk(
    db,              # (N_pad, D) whole rows: int8, bf16 or f32
    queries_sorted,  # (Q_pad, D) pre-sorted queries, as the score mode takes them
    band_start,      # (n_qt,) int32 first arena tile of each query tile's band
    k: int,
    band_tiles: int,  # tiles per band; the caller clamps band_start
    tile_n: int = 2048,
    tile_q: int = 256,
    l_buckets: int = 0,
    int8=False,
    n_valid=None,
):
    """K7: top-k over each query tile's contiguous band of arena tiles,
    ``band_start[qt] + j`` for j < band_tiles: (Q_pad, k) f32 scores and
    (Q_pad, k) int32 arena rows. CUDA tensors launch the hand-written
    kernel; CPU tensors run the plain version."""
    return _band_topk(db, queries_sorted, band_start, k, band_tiles, tile_n,
                      tile_q, l_buckets, int8, n_valid, plain=False)


def band_topk_reference(db, queries_sorted, band_start, k: int, band_tiles: int,
                        tile_n: int = 2048, tile_q: int = 256, l_buckets: int = 0,
                        int8=False, n_valid=None):
    """Plain PyTorch version of ``band_topk`` on any device."""
    return _band_topk(db, queries_sorted, band_start, k, band_tiles, tile_n,
                      tile_q, l_buckets, int8, n_valid, plain=True)


tiles_topk.launches = 0
band_topk.launches = 0
