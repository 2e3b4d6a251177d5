"""Contrastive losses for triplet-based encoder training (counterpart of
cloudvectordb_tpu/train/losses.py).

The InfoNCE similarity matrix is one (B, B[+B]) matmul over in-batch
negatives. Embeddings are assumed L2-normalised when a temperature is used
(the encoder's default). Each formula is the reference's, in the same
order of operations (optax's cross entropy: max-shifted logits,
log-sum-exp minus the label's logit).
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.topk import f32_const


def triplet_margin_loss(anchor, positive, negative, margin: float = 0.5):
    """max(0, margin + d(a,p) - d(a,n)) with squared-L2 distances."""
    d_ap = ((anchor - positive) ** 2).sum(dim=-1)
    d_an = ((anchor - negative) ** 2).sum(dim=-1)
    return torch.clamp_min(margin + d_ap - d_an, 0.0).mean()


def infonce_loss(anchor, positive, negative=None, temperature: float = 0.05):
    """Multiple-negatives-ranking / InfoNCE over in-batch negatives: row
    i's positive is positive[i]; every other positive (and the explicit
    negatives, if given) is a negative. Returns (loss, acc)."""
    cands = positive if negative is None else torch.cat([positive, negative], 0)
    logits = (anchor @ cands.T) / f32_const(temperature, anchor)  # (B, B[+B])
    labels = torch.arange(anchor.shape[0], device=anchor.device)
    shifted = logits - logits.amax(dim=1, keepdim=True).detach()
    loss = torch.log(torch.exp(shifted).sum(dim=1)) - shifted.gather(1, labels[:, None])[:, 0]
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss.mean(), acc


def uniformity_loss(x, t: float = 2.0):
    """Wang–Isola uniformity: log E[exp(−t·‖xi−xj‖²)] over in-batch pairs,
    with ‖xi−xj‖² from the Gram matrix (one matmul, no (B, B, D)
    difference). A collapsed batch scores 0, a uniform one ≈ −2t."""
    x2 = (x * x).sum(dim=1)
    sq = torch.clamp_min(x2[:, None] + x2[None, :] - (2.0 * x) @ x.T, 0.0)
    b = x.shape[0]
    off = ~torch.eye(b, dtype=torch.bool, device=x.device)
    scores = torch.where(off, -t * sq, f32_const(float("-inf"), sq))
    return torch.logsumexp(scores.reshape(-1), dim=0) - torch.log(f32_const(b * (b - 1), x))


def loss_fn_for(name: str):
    if name == "infonce":
        return infonce_loss
    if name == "triplet":
        return triplet_margin_loss
    raise ValueError(f"unknown loss {name!r}")
