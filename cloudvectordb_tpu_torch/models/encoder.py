"""Transformer sentence encoder (counterpart of
cloudvectordb_tpu/models/encoder.py): BERT-style post-LN, MiniLM-L6 class.

Parameters are f32 master weights in torch's own orientation (``Dense``
weights are (out, in)), under the reference's names: ``tok_emb``,
``pos_emb``, ``emb_ln``, ``layer_<i>`` (``attention.{query,key,value,out}``,
``attention_ln``, ``mlp_in``, ``mlp_out``, ``mlp_ln``) and ``proj``.
models/hf_import.py maps the reference's flax params onto them.

Numerics follow flax's: a ``Dense`` casts its input, kernel and bias to
``cfg.dtype``; an ``Embed`` gathers rows and casts them to ``cfg.dtype``;
``LayerNorm`` (eps 1e-6) takes its statistics in f32 as E[x²] − E[x]²,
normalises, scales and shifts in f32 and rounds once to ``cfg.dtype``;
gelu is the tanh form; pooling, the optional ``proj`` and the L2
normalisation (``max(norm, 1e-12)``) run in f32.

Attention (``SelfAttention._dispatch``) mirrors the reference's
``_attn_dispatch``, with "the TPU backend" read as "the tensors are on
CUDA":
- ``'naive'``: materialised f32 logits, ``finfo(f32).min`` masking, probs
  dropout;
- ``'packed_batch'``: 128/L short sequences per block with a block-diagonal
  mask, the same math as naive (deterministic forwards only);
- ``'packed'``: K4, ops/attn.py::mha_small_head (-1e30 masking; its plain
  version on CPU tensors, where the reference would assert);
- ``'fused'``: torch's ``scaled_dot_product_attention`` with the
  reference's segment-id masking (the reference calls the stock flash
  kernel here, not a kernel of its own).
``'auto'`` picks, on CUDA, ``packed_batch`` for short deterministic
forwards and ``packed`` for a training forward with no probs dropout, L %
128 == 0 and L ≤ 512; on CPU it is ``naive``, as the reference's is.

Dropout masks come from the ``torch.Generator`` the caller passes, never
the global RNG; a training forward with dropout and no generator raises.
``cfg.remat`` checkpoints each layer (``torch.utils.checkpoint``); the
recompute redraws the same masks from a copy of the generator's state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cloudvectordb_tpu_torch.ops.attn import mha_small_head
from cloudvectordb_tpu_torch.ops.topk import f32_const
from cloudvectordb_tpu_torch.utils.config import EncoderConfig
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LN_EPS = 1e-6  # flax's LayerNorm default
_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at ±2 std, std
    1/sqrt(fan_in) after the truncation."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s type, as JAX makes a Python scalar weakly typed."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _dropout(x: torch.Tensor, rate: float, g: torch.Generator | None) -> torch.Tensor:
    """flax's Dropout: keep with probability 1 - rate and scale by
    1/(1 - rate); the identity when ``g`` is None (deterministic) or rate
    is 0."""
    if g is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / _scalar(1.0 - rate, x), torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))


class Dense(nn.Module):
    """flax ``Dense(dtype=...)``: f32 weight (out, in) and bias; input,
    weight and bias cast to ``dtype`` for the product."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=...)``: f32 statistics (E[x²] − E[x]², clipped
    at 0), f32 normalise/scale/shift, one rounding to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + f32_const(LN_EPS, xf)) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        h = cfg.hidden_dim
        self.query = Dense(h, h, dtype)
        self.key = Dense(h, h, dtype)
        self.value = Dense(h, h, dtype)
        self.out = Dense(h, h, dtype)

    def forward(self, x, mask, deterministic: bool, g: torch.Generator | None):
        c = self.cfg
        b, length, _ = x.shape
        heads, hd = c.num_heads, c.hidden_dim // c.num_heads
        q = self.query(x).reshape(b, length, heads, hd)
        k = self.key(x).reshape(b, length, heads, hd)
        v = self.value(x).reshape(b, length, heads, hd)
        scale = hd ** -0.5
        attn_p = c.dropout if c.attn_dropout is None else c.attn_dropout
        impl = self._dispatch(attn_p, deterministic, length, b, x.is_cuda)
        if impl == "packed":
            out = mha_small_head(q.reshape(b, length, -1), k.reshape(b, length, -1),
                                 v.reshape(b, length, -1), mask.to(torch.int32), heads, hd,
                                 scale).to(self.dtype)
        elif impl == "fused":
            # the reference's segment ids: a query sees the keys of its own
            # segment (live keys for live queries, pads for pads)
            seg = mask.to(torch.int32)
            allowed = seg[:, None, :, None] == seg[:, None, None, :]
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=allowed, scale=scale).transpose(1, 2).to(self.dtype)
        elif impl == "packed_batch":
            p = 128 // length
            qp, kp, vp = (t.reshape(b // p, p * length, heads, hd) for t in (q, k, v))
            logits = torch.einsum("bqhd,bkhd->bhqk", qp * _scalar(scale, qp), kp)
            own = torch.block_diag(*[torch.ones(length, length, dtype=torch.bool,
                                                device=x.device)] * p)
            allowed = own[None, None] & mask.reshape(b // p, p * length)[:, None, None, :]
            probs = self._softmax(logits, allowed)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, vp).reshape(b, length, heads, hd)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q * _scalar(scale, q), k)
            probs = self._softmax(logits, mask[:, None, None, :])
            probs = _dropout(probs, attn_p, g)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out.reshape(b, length, c.hidden_dim))

    def _softmax(self, logits, allowed):
        """f32 softmax of the logits with disallowed keys at finfo(f32).min,
        in the activation type (the reference's naive masking)."""
        neg = torch.finfo(torch.float32).min
        logits = torch.where(allowed, logits.float(), f32_const(neg, logits))
        return torch.softmax(logits, dim=-1).to(self.dtype)

    def _dispatch(self, attn_p: float, deterministic: bool, seq_len: int, batch: int,
                  on_card: bool) -> str:
        """The reference's ``_attn_dispatch`` with "the TPU backend" read as
        ``on_card`` (the tensors are on CUDA). The 128-row rule binds on the
        runtime sequence length, not the config's."""
        c = self.cfg
        impl = c.attn_impl
        if impl == "naive":
            return "naive"
        no_drop = deterministic or (c.attn_dropout is not None and attn_p == 0.0)
        pb_applies = (no_drop and 0 < seq_len < 128 and 128 % seq_len == 0
                      and batch > 0 and batch % (128 // seq_len) == 0)
        if impl == "packed_batch":
            if not no_drop:
                raise ValueError("attn_impl='packed_batch' needs attn_dropout=0.0 or a "
                                 "deterministic forward (no probs dropout)")
            return impl if pb_applies else "naive"
        if impl in ("fused", "packed"):
            if not (no_drop and seq_len % 128 == 0):
                raise ValueError(f"attn_impl={impl!r} needs seq_len % 128 == 0 and "
                                 "attn_dropout=0.0 (no probs dropout in the kernel)")
            return impl
        if impl != "auto":
            raise ValueError(f"unknown attn_impl {impl!r}")
        applies = no_drop and seq_len % 128 == 0 and on_card
        if pb_applies and on_card:
            return "packed_batch"
        if applies and seq_len <= 512 and not deterministic:
            return "packed"
        if applies and (c.hidden_dim // c.num_heads) % 128 == 0:
            return "fused"
        return "naive"


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg, dtype)
        self.attention_ln = LayerNorm(cfg.hidden_dim, dtype)
        self.mlp_in = Dense(cfg.hidden_dim, cfg.mlp_dim, dtype)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.hidden_dim, dtype)
        self.mlp_ln = LayerNorm(cfg.hidden_dim, dtype)

    def forward(self, x, mask, deterministic: bool, g: torch.Generator | None):
        rate = self.cfg.dropout
        g = None if deterministic else g
        attn = _dropout(self.attention(x, mask, deterministic, g), rate, g)
        x = self.attention_ln(x + attn)
        h = F.gelu(self.mlp_in(x), approximate="tanh")
        h = _dropout(self.mlp_out(h), rate, g)
        return self.mlp_ln(x + h)


class Encoder(nn.Module):
    """token ids (B, L) + mask (B, L) → sentence embeddings (B, embed_dim)
    f32."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        dtype = _DTYPES[cfg.dtype]
        self.dtype = dtype
        # _weight: no default init, which would draw from the global RNG
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_dim,
                                    _weight=torch.empty(cfg.vocab_size, cfg.hidden_dim))
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.hidden_dim,
                                    _weight=torch.empty(cfg.max_len, cfg.hidden_dim))
        self.emb_ln = LayerNorm(cfg.hidden_dim, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, dtype))
        if cfg.out_dim and cfg.out_dim != cfg.hidden_dim:
            self.proj = Dense(cfg.hidden_dim, cfg.out_dim, torch.float32)

    @property
    def embed_dim(self) -> int:
        return self.cfg.out_dim or self.cfg.hidden_dim

    def layers(self) -> list[EncoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def forward(self, input_ids, attention_mask, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        c = self.cfg
        if not deterministic and c.dropout > 0 and generator is None:
            raise ValueError("a training forward with dropout needs a torch.Generator")
        g = None if deterministic else generator
        length = input_ids.shape[1]
        tok = self.tok_emb(input_ids).to(self.dtype)
        pos = self.pos_emb.weight[:length].to(self.dtype)
        x = self.emb_ln(tok + pos[None])
        x = _dropout(x, c.dropout, g)
        mask = attention_mask.bool()
        for layer in self.layers():
            x = self._layer(layer, x, mask, deterministic, g)
        if c.pooling == "cls":
            pooled = x[:, 0, :].float()
        else:  # masked mean pooling
            w = attention_mask.float()[:, :, None]
            pooled = (x.float() * w).sum(dim=1) / torch.clamp_min(w.sum(dim=1), 1.0)
        if c.out_dim and c.out_dim != c.hidden_dim:
            pooled = self.proj(pooled)
        if c.normalize:
            norm = torch.sqrt((pooled * pooled).sum(dim=-1, keepdim=True))
            pooled = pooled / torch.clamp_min(norm, 1e-12)
        return pooled

    def _layer(self, layer, x, mask, deterministic, g):
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return layer(x, mask, deterministic, g)
        # remat: the recompute must redraw this layer's masks, so the layer
        # draws from a copy of g's state and g then moves past those draws
        state = None if g is None else g.get_state()
        end = {}

        def run(x):
            local = None
            if state is not None:
                local = torch.Generator(device=g.device)
                local.set_state(state)
            out = layer(x, mask, deterministic, local)
            if local is not None:
                end["state"] = local.get_state()
            return out

        out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
        if g is not None:
            g.set_state(end["state"])
        return out


def init_encoder(cfg: EncoderConfig, seed: int = 0,
                 device: str | torch.device = DEFAULT) -> Encoder:
    """A new encoder on ``device`` with flax's default inits drawn from a
    CPU generator seeded with ``seed`` (lecun-normal kernels, zero biases,
    unit LayerNorm scales, embeddings normal with std 1/sqrt(hidden)). The
    reference returns (model, params); here the module holds its params."""
    dev = as_device(device)
    model = Encoder(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("tok_emb.weight", "pos_emb.weight")):
                p.normal_(0.0, cfg.hidden_dim ** -0.5, generator=g)
            elif name.endswith("weight") and p.dim() == 2:
                _lecun_normal_(p, p.shape[1], g)
    return model.to(dev)
