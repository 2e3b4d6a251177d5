"""Residual-int8 tile-table scan (counterpart of
cloudvectordb_tpu/ops/pallas_band.py; this slice ports ``order_centroids``
and ``tiles_topk_resid_pallas``).

``tiles_topk_resid`` dispatches on the device of its tensors: CUDA tensors
go to the hand-written kernel (``csrc/tiles_resid.cu``, built and bound by
``ops/_cuda.py``), CPU tensors to the plain version
``tiles_topk_resid_reference``. There is no third path and no fallback: a
kernel that fails to build or launch raises.

Contract (the reference kernel ``_tiles_resid_kernel`` with int8_q=True,
no row_mask, no l2, no top2). For query tile ``qt``, table entry ``p``,
arena tile ``t = tile_table[qt, p]`` and arena row ``g`` of that tile::

    score = bf16(q)·bf16(c[local[g]])  (f32 accumulation)
            + row_scale[q] · (q8 · r8[g])  (exact int32)
    live  = g < valid_end[t, local[g]]

Each query keeps ``l_buckets`` slots (L). Within a tile, bucket ``b`` takes
the best of rows ``t·tile_n + r·L + b`` over r (the smallest r on ties);
across table entries a strict ``>`` keeps the earlier entry on ties. Slots
start at (-inf, row 0). The final top-k over the slots is a stable
descending sort, so ties go to the lower slot as ``lax.top_k`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.ops.topk import NEG_INF, topk_stable


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
    (torch.round, like jnp.round, rounds half to even)."""
    qf = queries_sorted.float()
    q_amax = qf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    q8 = torch.clamp(torch.round(qf * (127.0 / q_amax)), -127, 127).to(torch.int8)
    rs = torch.tensor(resid_scale, dtype=torch.float32, device=qf.device)
    row_scale = ((q_amax / 127.0) * rs).reshape(-1)
    return qf.to(torch.bfloat16), q8, row_scale


def _check_args(db_resid, local_ids, centroid_tiles, queries_sorted,
                tile_table, valid_end, tile_n, tile_q, l_buckets,
                row_mask, l2, top2) -> int:
    """Validate shapes and options; return the resolved l_buckets."""
    if row_mask is not None or l2 or top2:
        raise NotImplementedError(
            "row_mask, l2 and top2 arrive with the filtered/l2 slice")
    n, d = db_resid.shape
    nq = queries_sorted.shape[0]
    if n % tile_n or nq % tile_q:
        raise ValueError(f"rows {n} / queries {nq} not multiples of "
                         f"tile_n {tile_n} / tile_q {tile_q}")
    if d % 4:
        raise ValueError(f"D={d} must be a multiple of 4")
    if l_buckets == 0:
        l_buckets = tile_n
    l_buckets = min(l_buckets, tile_n)
    if tile_n % l_buckets:
        raise ValueError(f"l_buckets {l_buckets} must divide tile_n {tile_n}")
    n_tiles = n // tile_n
    w = centroid_tiles.shape[1]
    if tuple(centroid_tiles.shape) != (n_tiles, w, d):
        raise ValueError(f"centroid_tiles {tuple(centroid_tiles.shape)} != "
                         f"({n_tiles}, W, {d})")
    if tuple(valid_end.shape) != (n_tiles, w):
        raise ValueError(f"valid_end {tuple(valid_end.shape)} != ({n_tiles}, {w})")
    if local_ids.numel() != n:
        raise ValueError(f"local_ids has {local_ids.numel()} entries, arena {n}")
    if tile_table.dim() != 2 or tile_table.shape[0] != nq // tile_q:
        raise ValueError(f"tile_table {tuple(tile_table.shape)} needs "
                         f"{nq // tile_q} rows")
    if db_resid.dtype != torch.int8:
        raise TypeError(f"arena must be int8, got {db_resid.dtype}")
    devices = {t.device for t in (db_resid, local_ids, centroid_tiles,
                                  queries_sorted, tile_table, valid_end)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return l_buckets


def _slots_reference(db_resid, local_ids, centroid_tiles, q_bf16, q8,
                     row_scale, tile_table, valid_end, tile_n, tile_q,
                     l_buckets):
    """Plain PyTorch slot scan: (Q_pad, L) f32 values, (Q_pad, L) int32 rows.
    Walks the table entries in order, each one vectorized over query tiles;
    the int8 dot runs in float64, exact for any D this kernel takes."""
    n, d = db_resid.shape
    nq = q8.shape[0]
    n_qt, p = tile_table.shape
    r_per = tile_n // l_buckets
    dev = db_resid.device
    rows3 = db_resid.view(n // tile_n, tile_n, d)
    local3 = local_ids.reshape(n // tile_n, tile_n).long()
    q8t = q8.view(n_qt, tile_q, d).double()
    qbt = q_bf16.view(n_qt, tile_q, d).float()
    rst = row_scale.view(n_qt, tile_q, 1)
    ct = centroid_tiles.to(torch.bfloat16).float()
    row_iota = torch.arange(tile_n, device=dev, dtype=torch.int64)
    r_iota = torch.arange(r_per, device=dev).view(1, 1, r_per, 1)
    b_iota = torch.arange(l_buckets, device=dev, dtype=torch.int64)
    best_v = torch.full((n_qt, tile_q, l_buckets), NEG_INF, device=dev)
    best_i = torch.zeros((n_qt, tile_q, l_buckets), dtype=torch.int64, device=dev)
    for j in range(p):
        t = tile_table[:, j].long()  # (n_qt,)
        r_scores = torch.bmm(q8t, rows3[t].double().transpose(1, 2)).float()
        qc = torch.bmm(qbt, ct[t].transpose(1, 2))  # (n_qt, tile_q, W) f32
        loc = local3[t]  # (n_qt, tile_n)
        c_scores = torch.gather(qc, 2, loc[:, None, :].expand(-1, tile_q, -1))
        scores = c_scores + rst * r_scores
        g = t[:, None] * tile_n + row_iota[None, :]
        ve = torch.gather(valid_end[t].long(), 1, loc)
        scores = torch.where((g < ve)[:, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        s4 = scores.view(n_qt, tile_q, r_per, l_buckets)
        mx = s4.amax(dim=2)
        r_star = torch.where(s4 >= mx[:, :, None, :], r_iota, r_per).amin(dim=2)
        new_idx = t[:, None, None] * tile_n + r_star * l_buckets + b_iota
        better = mx > best_v
        best_v = torch.where(better, mx, best_v)
        best_i = torch.where(better, new_idx, best_i)
    return best_v.view(nq, l_buckets), best_i.view(nq, l_buckets).int()


def _final_topk(out_v, out_i, k):
    top_v, pos = topk_stable(out_v, min(k, out_v.shape[1]))
    return top_v, torch.gather(out_i, 1, pos)


def tiles_topk_resid_reference(
    db_resid, local_ids, centroid_tiles, resid_scale, queries_sorted,
    tile_table, k: int, valid_end, tile_n: int = 2048, tile_q: int = 256,
    l_buckets: int = 0, int8_q: bool = True, row_mask=None, l2: bool = False,
    top2: bool = False,
):
    """Plain PyTorch version of ``tiles_topk_resid`` on any device: the CPU
    path of the wrapper, and the kernel's yardstick on the card."""
    if not int8_q:
        raise NotImplementedError("int8_q=False (scoring='precise') is not ported yet")
    l_buckets = _check_args(db_resid, local_ids, centroid_tiles, queries_sorted,
                            tile_table, valid_end, tile_n, tile_q, l_buckets,
                            row_mask, l2, top2)
    q_bf16, q8, row_scale = _quantize_queries(queries_sorted, resid_scale)
    out_v, out_i = _slots_reference(
        db_resid, local_ids, centroid_tiles, q_bf16, q8, row_scale,
        tile_table, valid_end, tile_n, tile_q, l_buckets)
    return _final_topk(out_v, out_i, k)


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
    int8_q: bool = True,
    row_mask=None,
    l2: bool = False,
    top2: bool = False,
):
    """Top-k over residual-int8 arena tiles: (Q_pad, k) f32 scores and
    (Q_pad, k) int32 arena rows (module docstring). CUDA tensors launch the
    hand-written kernel; CPU tensors run the plain version."""
    if not int8_q:
        raise NotImplementedError("int8_q=False (scoring='precise') is not ported yet")
    l_buckets = _check_args(db_resid, local_ids, centroid_tiles, queries_sorted,
                            tile_table, valid_end, tile_n, tile_q, l_buckets,
                            row_mask, l2, top2)
    q_bf16, q8, row_scale = _quantize_queries(queries_sorted, resid_scale)
    dev = db_resid.device
    if dev.type == "cuda":
        from cloudvectordb_tpu_torch.ops import _cuda

        out_v, out_i = _cuda.tiles_resid_slots(
            db_resid, local_ids, centroid_tiles.to(torch.bfloat16), q_bf16, q8,
            row_scale, tile_table.to(torch.int32), valid_end.to(torch.int32),
            tile_n=tile_n, tile_q=tile_q, l_buckets=l_buckets)
        tiles_topk_resid.launches += 1
    elif dev.type == "cpu":
        out_v, out_i = _slots_reference(
            db_resid, local_ids, centroid_tiles, q_bf16, q8, row_scale,
            tile_table, valid_end, tile_n, tile_q, l_buckets)
    else:
        raise NotImplementedError(f"no tiles_topk_resid path for {dev.type} tensors")
    return _final_topk(out_v, out_i, k)


#: kernel launches since the last reset (the card run resets and reads it)
tiles_topk_resid.launches = 0
