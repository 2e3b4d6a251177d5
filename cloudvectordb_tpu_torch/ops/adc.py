"""ADC scan: top-k over PQ codes by asymmetric distance computation
(counterpart of cloudvectordb_tpu/ops/adc.py).

A row's score against query b is the sum over sub-spaces j of
``lut[b, j, code[row, j]]``. The reference writes that lookup as a one-hot
matmul per sub-space because the TPU has no fast gather; on the card it is
the gather itself, one sub-space at a time into an f32 sum (the reference's
order), tiled over the rows and merged by a stable top-k. As the
reference's, the tables are rounded to bf16 before the sum.

It is the reference's public op, kept for its callers. The IVF-PQ probe
scan does not call it, as the reference's does not: it sums f32 tables
over a probe's window (index/ivf_pq.py::_table_sum).
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.topk import NEG_INF, merge_topk, topk_stable


def adc_scan(codes: torch.Tensor, luts: torch.Tensor, k: int, tile: int = 16384):
    """Top-k by ADC score. ``codes`` (N, m) uint8; ``luts`` (B, m, C) f32
    with ``lut[b, j, c]`` the contribution of codeword c of sub-space j to
    query b's score (index/ivf_pq.py::_build_luts). Returns (scores (B, k)
    f32, rows (B, k) int64), larger is better, on the tables' device; ties
    go to the lower row, and k is at most N."""
    n, m = codes.shape
    b, m2, _ = luts.shape
    if m != m2:
        raise ValueError(f"codes have {m} sub-spaces, tables {m2}")
    k = min(k, n)
    lut = luts.to(torch.bfloat16).float()  # the reference's bf16 tables
    codes = codes.to(luts.device)
    best_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=luts.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=luts.device)
    for start in range(0, n, tile):
        blk = codes[start:start + tile].long()
        scores = torch.zeros((b, blk.shape[0]), dtype=torch.float32, device=luts.device)
        for j in range(m):
            scores += lut[:, j, blk[:, j]]
        tv, tp = topk_stable(scores, min(k, blk.shape[0]))
        best_v, best_i = merge_topk(best_v, best_i, tv, tp + start, k)
    return best_v, best_i
