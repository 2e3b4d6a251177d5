"""Weights into the port's Encoder (counterpart of
cloudvectordb_tpu/models/hf_import.py).

Two sources, each mapped onto the port's state dict (models/encoder.py):
- a HuggingFace BERT-family state dict (MiniLM-L6 / BERT: the same post-LN
  transformer); ``token_type_embeddings[0]`` is folded into the position
  embeddings, as the reference does for single-segment encoding;
- the JAX package's flax params (a nested dict of arrays), which is how
  weights cross between the two packages: ``DenseGeneral`` q/k/v kernels
  (hidden, H, d) become (H·d, hidden) weights, ``out`` (H, d, hidden)
  becomes (hidden, H·d), ``Dense`` kernels are transposed, LayerNorm
  ``scale``/``bias`` become ``weight``/``bias``, embeddings stay as they
  are.
``load_hf_encoder`` reads a local checkpoint directory with
``transformers`` (imported inside it; nothing is downloaded).
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.models.encoder import Encoder
from cloudvectordb_tpu_torch.utils.config import EncoderConfig
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device

_LAYER_HF = {  # port name -> HF name, under layer_<i>. / encoder.layer.<i>.
    "attention.query": "attention.self.query",
    "attention.key": "attention.self.key",
    "attention.value": "attention.self.value",
    "attention.out": "attention.output.dense",
    "attention_ln": "attention.output.LayerNorm",
    "mlp_in": "intermediate.dense",
    "mlp_out": "output.dense",
    "mlp_ln": "output.LayerNorm",
}


def config_from_hf(hf_cfg) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_dim=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        mlp_dim=hf_cfg.intermediate_size,
        max_len=hf_cfg.max_position_embeddings,
        dropout=hf_cfg.hidden_dropout_prob,
    )


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def state_dict_from_hf(sd: dict, cfg: EncoderConfig) -> dict[str, torch.Tensor]:
    """HF BertModel state dict (torch tensors or numpy) → the port's state
    dict (f32, CPU). HF's Linear weights are already (out, in)."""
    out = {"tok_emb.weight": _f32(sd["embeddings.word_embeddings.weight"])}
    pos = _f32(sd["embeddings.position_embeddings.weight"])
    if "embeddings.token_type_embeddings.weight" in sd:
        pos = pos + _f32(sd["embeddings.token_type_embeddings.weight"])[0][None, :]
    out["pos_emb.weight"] = pos
    out["emb_ln.weight"] = _f32(sd["embeddings.LayerNorm.weight"])
    out["emb_ln.bias"] = _f32(sd["embeddings.LayerNorm.bias"])
    for i in range(cfg.num_layers):
        for port, hf in _LAYER_HF.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{port}.{leaf}"] = _f32(sd[f"encoder.layer.{i}.{hf}.{leaf}"])
    return out


def state_dict_from_flax(params: dict, cfg: EncoderConfig) -> dict[str, torch.Tensor]:
    """The JAX package's Encoder params → the port's state dict (f32, CPU)."""
    a = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    hidden = cfg.hidden_dim
    out = {"tok_emb.weight": _f32(a(params["tok_emb"]["embedding"])),
           "pos_emb.weight": _f32(a(params["pos_emb"]["embedding"])),
           "emb_ln.weight": _f32(a(params["emb_ln"]["scale"])),
           "emb_ln.bias": _f32(a(params["emb_ln"]["bias"]))}
    for i in range(cfg.num_layers):
        lp, pre = params[f"layer_{i}"], f"layer_{i}."
        att = lp["attention"]
        for name in ("query", "key", "value"):  # (hidden, H, d) -> (H*d, hidden)
            out[f"{pre}attention.{name}.weight"] = _f32(a(att[name]["kernel"]).reshape(hidden, -1).T)
            out[f"{pre}attention.{name}.bias"] = _f32(a(att[name]["bias"]).reshape(-1))
        out[f"{pre}attention.out.weight"] = _f32(a(att["out"]["kernel"]).reshape(-1, hidden).T)
        out[f"{pre}attention.out.bias"] = _f32(a(att["out"]["bias"]))
        for name in ("mlp_in", "mlp_out"):
            out[f"{pre}{name}.weight"] = _f32(a(lp[name]["kernel"]).T)
            out[f"{pre}{name}.bias"] = _f32(a(lp[name]["bias"]))
        for name in ("attention_ln", "mlp_ln"):
            out[f"{pre}{name}.weight"] = _f32(a(lp[name]["scale"]))
            out[f"{pre}{name}.bias"] = _f32(a(lp[name]["bias"]))
    if "proj" in params:
        out["proj.weight"] = _f32(a(params["proj"]["kernel"]).T)
        out["proj.bias"] = _f32(a(params["proj"]["bias"]))
    return out


def load_hf_encoder(model_dir: str, device: str | torch.device = DEFAULT) -> Encoder:
    """Local checkpoint directory → the port's Encoder on ``device``. Needs
    ``transformers``."""
    dev = as_device(device)
    import transformers

    hf = transformers.AutoModel.from_pretrained(model_dir, local_files_only=True)
    cfg = config_from_hf(hf.config)
    sd = {k.removeprefix("bert."): v for k, v in hf.state_dict().items()}
    model = Encoder(cfg)
    model.load_state_dict(state_dict_from_hf(sd, cfg))
    return model.to(dev)
