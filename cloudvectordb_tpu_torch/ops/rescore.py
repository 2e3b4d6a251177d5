"""The int8 rescore of the PQ route: each query's K5 candidates scored
against their int8 refine rows (index/ivf_band.py::_pq_tiles_core). The JAX
package has no kernel for this step: it leaves the gather, the cast and
the einsum to XLA (cloudvectordb_tpu/index/ivf_band.py:146-170).

``rescore_int8`` dispatches on the device of its tensors: CUDA tensors go to
the hand-written kernel (``csrc/rescore_int8.cu``, built and bound by
``ops/_cuda.py``), which reads each candidate's int8 row once and sums its
products in registers; CPU tensors go to the plain version
(``rescore_int8_reference``), which gathers the rows into an f32 (sub,
k_cand, D) block in query sub-batches (``_rescore_cap``) and calls
``torch.bmm``. There is no third path and no fallback. The kernel loads a
row by 4-byte words, so on CUDA D must be a multiple of 4 (every
configuration's is; the wrapper raises otherwise).

The contract. ``rows`` (B, k_cand) are arena rows in [0, N) of the N
refine rows: the caller clamps them (``_pq_tiles_core``, whose clamped rows
also feed its id lookup), and neither version clamps again. ``q_s`` (B, D)
f32 the queries in planner order. Residual rows
(``residual``): bf16(q)·r as exact f32 products summed in f32, times the
scale, plus the exact centroid term ``dots[order]`` gathered by the row's
list (its local byte through the tile window); l2 subtracts ‖c + s·r‖²/2
expanded as (‖c‖² + 2s·(c·r) + s²·‖r‖²)/2 before the centroid term. Whole
rows: q·(r·scale) in f32 (l2: less ‖r·scale‖²/2). Unfilled K5 slots (v ==
-inf) score -inf. The kernel takes the same products and the same epilogue;
only the order of the f32 sums differs (held within 1e-5 relative on the
card by ``tests/port/test_torch_rescore.py``).
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.topk import NEG_INF, f32_const


def _rescore_cap(k_cand: int, b: int, halve: bool = False) -> int:
    """Query sub-batch of the refine rescore: the largest divisor of b not
    above min(512, 2^20 / k_cand) (halved with ``halve``), so one gathered
    (sub, k_cand, D) block stays near 1 GB of f32 at D 768 (the reference's
    cap, ivf_band.py:173-181)."""
    cap = max(1, min(512, (1 << 20) // max(k_cand, 1)))
    if halve:
        cap = max(1, cap // 2)
    return max(s for s in range(1, min(cap, b) + 1) if b % s == 0)


def rescore_int8_reference(q_s, v, rows, refine_rows, refine_scale: float, *,
                           residual: bool = False, l2: bool = False, centroids=None,
                           dots=None, order=None, tile_window=None, local_ids=None,
                           tile_n: int = 0):
    """Plain version of ``rescore_int8``: (B, k_cand) f32. In query
    sub-batches of ``_rescore_cap`` (halved for l2 residual rows, whose
    centroid gather doubles the temporaries)."""
    valid = v > NEG_INF
    rows = rows.long()
    b, kc = rows.shape
    scale = f32_const(refine_scale, q_s)
    half = f32_const(0.5, q_s)
    lists = None
    if residual:  # row -> local byte -> list id
        lists = tile_window[rows // tile_n, local_ids.reshape(-1)[rows].long()].long()
    sub = _rescore_cap(kc, b, halve=l2 and residual)
    parts = []
    for s in range(0, b, sub):
        cand = refine_rows[rows[s:s + sub]].float()  # (sub, k_cand, D), int8 values
        if residual:
            qb = q_s[s:s + sub].to(torch.bfloat16).float()
            ex = torch.bmm(cand, qb[:, :, None])[:, :, 0] * scale
            if l2:
                ca = centroids[lists[s:s + sub]]
                ex = ex - half * (
                    (ca * ca).sum(dim=2)
                    + f32_const(2.0 * refine_scale, q_s) * (ca * cand).sum(dim=2)
                    + f32_const(refine_scale * refine_scale, q_s)
                    * (cand * cand).sum(dim=2))
        else:
            cand = cand * scale
            ex = torch.bmm(cand, q_s[s:s + sub, :, None])[:, :, 0]
            if l2:
                ex = ex - half * (cand * cand).sum(dim=2)
        parts.append(ex)
    ex = torch.cat(parts)
    if residual:
        ex = ex + torch.gather(dots[order], 1, lists)
    return torch.where(valid, ex, NEG_INF)


def rescore_int8(q_s, v, rows, refine_rows, refine_scale: float, *, residual: bool = False,
                 l2: bool = False, centroids=None, dots=None, order=None, tile_window=None,
                 local_ids=None, tile_n: int = 0):
    """(B, k_cand) f32 scores of each query's candidates against their int8
    refine rows, -inf where ``v`` is -inf (the module's contract). ``q_s``
    (B, D) f32 queries in planner order; ``v`` (B, k_cand) K5's slot values;
    ``rows`` (B, k_cand) arena rows in [0, N) of ``refine_rows`` (N, D) int8
    (the caller clamps them; D a multiple of 4 on CUDA).
    Residual rows also take ``centroids`` (nlist, D) f32, ``dots`` (B,
    nlist) f32 in caller order, ``order`` (B,) the planner order,
    ``tile_window`` (n_tiles, W), ``local_ids`` (N_pad,) uint8 and
    ``tile_n``. CUDA tensors launch the kernel (``rescore_int8.launches``
    counts it), CPU tensors run the plain version."""
    b, kc = rows.shape
    if tuple(v.shape) != (b, kc) or q_s.shape[0] != b or q_s.shape[1] != refine_rows.shape[1]:
        raise ValueError(f"rows {tuple(rows.shape)}, v {tuple(v.shape)}, queries "
                         f"{tuple(q_s.shape)}, refine rows {tuple(refine_rows.shape)}")
    if residual and any(t is None for t in (centroids, dots, order, tile_window, local_ids)):
        raise ValueError("residual rows need centroids, dots, order, tile_window, local_ids")
    kw = dict(residual=residual, l2=l2, centroids=centroids, dots=dots, order=order,
              tile_window=tile_window, local_ids=local_ids, tile_n=tile_n)
    dev = rows.device
    if dev.type == "cpu":
        return rescore_int8_reference(q_s, v, rows, refine_rows, refine_scale, **kw)
    if dev.type != "cuda":
        raise NotImplementedError(f"no int8 rescore for {dev.type} tensors")
    if b == 0 or kc == 0:
        return torch.empty((b, kc), dtype=torch.float32, device=dev)
    from cloudvectordb_tpu_torch.ops import _cuda

    side = None
    if residual:
        side = (local_ids, tile_window.long().contiguous(), dots.float().contiguous(),
                order.long().contiguous(), centroids.float().contiguous(), tile_n)
    out = _cuda.rescore_int8(
        refine_rows.contiguous(), rows.long().contiguous(), v.float().contiguous(),
        q_s.float().contiguous(), float(refine_scale), l2=l2, residual=side)
    rescore_int8.launches += 1
    return out


#: kernel launches since the last reset (the card run resets and reads it)
rescore_int8.launches = 0
