"""Masked multi-head attention over head-packed rows (counterpart of
cloudvectordb_tpu/ops/pallas_attn.py: K4, ``mha_small_head``).

q, k and v are (B, L, H·d) rows, head h in columns h·d … (h+1)·d, as the
encoder's projections give them; ``mask`` (B, L) marks the live keys. Per
sequence and head, in f32: ``s = (q_h·scale)·k_hᵀ``, masked keys set to
-1e30 (so a fully masked row gets the mean of v over all L keys, as the
reference's does), ``p = softmax(s)``, ``o_h = p·v_h``, returned in q's
type. No probs dropout.

``mha_small_head`` is a ``torch.autograd.Function``. CUDA tensors launch
the hand-written kernels of ``csrc/mha_small_head.cu`` (bf16 rows on the
tensor cores, f32 rows on the CUDA cores; the backward recomputes p from
the forward's row max and row sum), or raise; CPU
tensors run the plain PyTorch version: ``_fwd_plain``, and ``_bwd_plain``,
which mirrors the reference's ``_bwd_kernel`` step by step (recompute p,
``dv = pᵀ·do``, ``dp = do·vᵀ``, ``ds = p ⊙ (dp − rowsum(dp ⊙ p))``,
``dq = scale·ds·k``, ``dk = dsᵀ·(q·scale)``) rather than autograd through
the forward, so the plain backward is itself held to the reference.
``mha_small_head_reference`` runs the plain version on any device (the
kernels' yardstick on the card). The mask gets no gradient.

Launch counts (the card run resets and reads them): ``mha_small_head.launches``
for the forward, ``mha_small_head.bwd_launches`` for the backward (one
kernel for bf16 rows at L 128, else two: either counts as one launch of
K4's backward).
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.topk import f32_const

MASKED = -1e30  # the reference's key mask value (pallas_attn.py:46)


def _heads(x: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    b, length, _ = x.shape
    return x.float().reshape(b, length, heads, d)


def _probs(qh, kh, mask):
    """The reference's masked softmax: (B, H, L, L) f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    s = torch.where((mask > 0)[:, None, None, :], s, f32_const(MASKED, s))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _fwd_plain(q, k, v, mask, heads: int, d: int, scale: float):
    b, length, hd = q.shape
    qh = _heads(q, heads, d) * f32_const(scale, q)
    p = _probs(qh, _heads(k, heads, d), mask)
    o = torch.einsum("bhqk,bkhd->bqhd", p, _heads(v, heads, d))
    return o.reshape(b, length, hd).to(q.dtype)


def _bwd_plain(q, k, v, mask, do, heads: int, d: int, scale: float):
    b, length, hd = q.shape
    sc = f32_const(scale, q)
    qh = _heads(q, heads, d) * sc
    kh, vh, doh = _heads(k, heads, d), _heads(v, heads, d), _heads(do, heads, d)
    p = _probs(qh, kh, mask)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, doh)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = sc * torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return tuple(g.reshape(b, length, hd).to(q.dtype) for g in (dq, dk, dv))


class _MhaSmallHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, heads: int, d: int, scale: float, plain: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        mask = mask.to(torch.int32).contiguous()
        stats = ()
        if plain:
            out = _fwd_plain(q, k, v, mask, heads, d, scale)
        else:
            from cloudvectordb_tpu_torch.ops import _cuda

            out, *stats = _cuda.mha_fwd(q, k, v, mask, heads, d, scale)
            mha_small_head.launches += 1
        ctx.save_for_backward(q, k, v, mask, *stats)
        ctx.args = (heads, d, scale, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, *stats = ctx.saved_tensors
        heads, d, scale, plain = ctx.args
        do = do.to(q.dtype).contiguous()
        if plain:
            dq, dk, dv = _bwd_plain(q, k, v, mask, do, heads, d, scale)
        else:
            from cloudvectordb_tpu_torch.ops import _cuda

            dq, dk, dv = _cuda.mha_bwd(q, k, v, mask, do, *stats, heads, d, scale)
            mha_small_head.bwd_launches += 1
        return dq, dk, dv, None, None, None, None, None


def _check(q, k, v, mask, heads: int, d: int) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, L, H*d) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] != heads * d:
        raise ValueError(f"rows of {q.shape[2]} are not {heads} heads of {d}")
    if tuple(mask.shape) != tuple(q.shape[:2]):
        raise ValueError(f"mask {tuple(mask.shape)} != (B, L) = {tuple(q.shape[:2])}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must be all f32 or all bf16: {q.dtype}, {k.dtype}, {v.dtype}")


def mha_small_head(q, k, v, mask, heads: int, d: int, scale: float):
    """Masked MHA over head-packed (B, L, H·d) rows with a (B, L) key mask:
    (B, L, H·d) in q's type, differentiable in q, k and v. CUDA tensors
    launch K4 (L % 128 == 0, L ≤ 512, d in 16/32/64) or raise; CPU tensors
    run the plain version."""
    _check(q, k, v, mask, heads, d)
    return _MhaSmallHead.apply(q, k, v, mask, heads, d, scale, not q.is_cuda)


def mha_small_head_reference(q, k, v, mask, heads: int, d: int, scale: float):
    """The plain PyTorch version of ``mha_small_head`` on any device, with
    the same autograd: the CPU path of the wrapper, and the kernels'
    yardstick on the card."""
    _check(q, k, v, mask, heads, d)
    return _MhaSmallHead.apply(q, k, v, mask, heads, d, scale, True)


#: kernel launches since the last reset (the card run resets and reads them)
mha_small_head.launches = 0
mha_small_head.bwd_launches = 0
