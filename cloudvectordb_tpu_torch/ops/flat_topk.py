"""Fused flat scan with a bucketed top-k (counterpart of
cloudvectordb_tpu/ops/pallas_topk.py: K2, ``flat_topk_pallas`` and
``flat_topk_pallas_int8``).

Every database row is scored against every query and merged into L =
``l_buckets`` slots per query (``l_buckets=0``: L = ``tile_n``); row ``j``
competes for slot ``j mod L`` within its ``tile_n``-row tile, so ``tile_n``
and L decide the candidate set and the defaults give the reference's. The
final top-k over the slots is exact. ``tile_q`` does not change the result.
The merge and the scan are ops/band.py's (``_scan_slots``): CUDA tensors
launch the hand-written kernel ``csrc/tiles_scan.cu``, CPU tensors run the
plain version. The ragged last tile is masked, never padded: no copy of the
database is made.

Score modes follow the operands' dtypes: int8 x int8 into exact int32,
bf16 x bf16 and f32 x bf16 with f32 sums of exact products, f32 x f32 in
f32. ``precision='default'`` permits a kernel to round f32 operands to bf16,
as the TPU's MXU does; today the kernel and the plain version both compute
exact f32 for 'default' and 'highest', which is what the reference computes
on the CPU. l2 scores ``2 q·x - ||x||²`` in the scan and subtracts ``||q||²``
after the top-k.
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.band import (
    SCAN_ALL, _check_score_mode, _final_topk, _resolve_buckets, _scan_slots)
from cloudvectordb_tpu_torch.ops.topk import f32_const


def _flat_topk(db, queries, k, metric, db_sqnorms, tile_n, l_buckets, precision,
               plain):
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if precision not in ("default", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    int8 = queries.dtype == torch.int8
    _check_score_mode(queries, db, int8)
    if int8 and metric == "l2":
        raise ValueError("the int8 flat scan is inner product only")
    if db.device != queries.device:
        raise ValueError(f"db on {db.device}, queries on {queries.device}")
    n = db.shape[0]
    nq = queries.shape[0]
    l_buckets = _resolve_buckets(tile_n, l_buckets)
    sqnorm = None
    if metric == "l2":
        if db_sqnorms is None:
            dbf = db.float()
            db_sqnorms = (dbf * dbf).sum(dim=1)
        sqnorm = db_sqnorms.to(device=db.device, dtype=torch.float32).contiguous()
    out_v, out_i, launched = _scan_slots(
        SCAN_ALL, db, queries, None, -(-n // tile_n), sqnorm, tile_n=tile_n,
        tile_q=nq, l_buckets=l_buckets, n_valid=n, plain=plain)
    flat_topk.launches += launched
    top_v, top_i = _final_topk(out_v, out_i, min(k, n))
    if metric == "l2":
        qf = queries.float()
        top_v = top_v - (qf * qf).sum(dim=1)[:, None]
    return top_v, top_i


def flat_topk(db, queries, k: int, metric: str = "ip", db_sqnorms=None,
              tile_n: int = 2048, tile_q: int = 256, l_buckets: int = 0,
              precision: str = "default"):
    """Fused flat-scan top-k: (scores (Q, k) f32, rows (Q, k) int32). db (N,
    D) f32, bf16 or int8; queries (Q, D) of a type the scan takes with it
    (module docstring). CUDA tensors launch the hand-written kernel; CPU
    tensors run the plain version."""
    del tile_q  # the kernel's query blocking is its own; slots are per query
    return _flat_topk(db, queries, k, metric, db_sqnorms, tile_n, l_buckets,
                      precision, plain=False)


def flat_topk_reference(db, queries, k: int, metric: str = "ip", db_sqnorms=None,
                        tile_n: int = 2048, tile_q: int = 256, l_buckets: int = 0,
                        precision: str = "default"):
    """Plain PyTorch version of ``flat_topk`` on any device: the CPU path of
    the wrapper, and the kernel's yardstick on the card."""
    del tile_q
    return _flat_topk(db, queries, k, metric, db_sqnorms, tile_n, l_buckets,
                      precision, plain=True)


def quantize_queries(queries):
    """(int8 queries, (Q, 1) f32 scale): the reference's per-query symmetric
    quantization (pallas_topk.py:228-230), byte for byte."""
    qf = queries.float()
    q_scale = qf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / f32_const(127.0, qf)
    return torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8), q_scale


def _flat_topk_int8(db_i8, db_scale, queries, k, tile_n, l_buckets, plain):
    q_i8, q_scale = quantize_queries(queries)
    top_v, top_i = _flat_topk(db_i8, q_i8, k, "ip", None, tile_n, l_buckets,
                              "default", plain)
    return top_v * (q_scale * f32_const(db_scale, q_scale)), top_i


def flat_topk_int8(db_i8, db_scale, queries, k: int, tile_n: int = 2048,
                   tile_q: int = 256, l_buckets: int = 0):
    """int8 x int8 inner-product scan: f32 queries are quantized per query,
    the scan is ``flat_topk``'s (its kernel and launch count), and the top-k
    values are rescaled by ``q_scale * db_scale``."""
    del tile_q
    return _flat_topk_int8(db_i8, db_scale, queries, k, tile_n, l_buckets, plain=False)


def flat_topk_int8_reference(db_i8, db_scale, queries, k: int, tile_n: int = 2048,
                             tile_q: int = 256, l_buckets: int = 0):
    """Plain PyTorch version of ``flat_topk_int8`` on any device."""
    del tile_q
    return _flat_topk_int8(db_i8, db_scale, queries, k, tile_n, l_buckets, plain=True)


#: kernel launches since the last reset (the card run resets and reads it)
flat_topk.launches = 0
