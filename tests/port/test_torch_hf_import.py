"""models/hf_import.py: an HF BERT-shaped state dict maps onto the port's
state dict exactly as the JAX package's params for it map across, and the
encoder loaded from it matches the JAX encoder (f32, 1e-5: the same f32
formulas summed in other orders)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.models.encoder import Encoder as JaxEncoder
from cloudvectordb_tpu.models.hf_import import params_from_state_dict
from cloudvectordb_tpu.utils.config import EncoderConfig as JaxConfig
from cloudvectordb_tpu_torch.models import hf_import
from cloudvectordb_tpu_torch.models.encoder import Encoder
from cloudvectordb_tpu_torch.utils.config import EncoderConfig

CFG = dict(vocab_size=96, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
           max_len=20, dropout=0.0, dtype="float32")


def _hf_state_dict(cfg, seed=0):
    """A synthetic HF BertModel state dict (numpy), token-type table
    included."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)  # noqa: E731
    h, m = cfg["hidden_dim"], cfg["mlp_dim"]
    sd = {"embeddings.word_embeddings.weight": r(cfg["vocab_size"], h),
          "embeddings.position_embeddings.weight": r(cfg["max_len"], h),
          "embeddings.token_type_embeddings.weight": r(2, h),
          "embeddings.LayerNorm.weight": 1 + r(h), "embeddings.LayerNorm.bias": r(h)}
    shapes = {"attention.self.query": (h, h), "attention.self.key": (h, h),
              "attention.self.value": (h, h), "attention.output.dense": (h, h),
              "attention.output.LayerNorm": (h,), "intermediate.dense": (m, h),
              "output.dense": (h, m), "output.LayerNorm": (h,)}
    for i in range(cfg["num_layers"]):
        for name, shape in shapes.items():
            p = f"encoder.layer.{i}.{name}"
            sd[p + ".weight"] = (1 + r(*shape)) if len(shape) == 1 else r(*shape)
            sd[p + ".bias"] = r(shape[0])
    return sd


def test_hf_state_dict_equals_the_flax_route():
    cfg = EncoderConfig(**CFG)
    sd = _hf_state_dict(CFG)
    direct = hf_import.state_dict_from_hf(sd, cfg)
    via_jax = hf_import.state_dict_from_flax(params_from_state_dict(sd, JaxConfig(**CFG)), cfg)
    assert direct.keys() == via_jax.keys() == Encoder(cfg).state_dict().keys()
    for k in direct:
        assert torch.equal(direct[k], via_jax[k]), k


def test_encoder_from_hf_weights_matches_the_jax_encoder():
    cfg = EncoderConfig(**CFG)
    sd = _hf_state_dict(CFG, seed=1)
    model = Encoder(cfg)
    model.load_state_dict(hf_import.state_dict_from_hf(sd, cfg))
    jcfg = JaxConfig(**CFG)
    params = params_from_state_dict(sd, jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 96, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 11:] = 0
    ref = np.asarray(JaxEncoder(jcfg).apply({"params": params}, jnp.asarray(ids),
                                            jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_load_hf_encoder_from_a_local_checkpoint(tmp_path):
    """A random BertModel saved to disk loads onto the requested device and
    mean-pools to HF's own last hidden states (the tolerance of the JAX
    package's HF parity test: HF's LayerNorm eps is 1e-12, ours 1e-6)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=20, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    hf.save_pretrained(tmp_path)
    loaded = hf_import.load_hf_encoder(str(tmp_path), device="cpu")
    assert loaded.cfg.hidden_dim == 32 and loaded.cfg.num_layers == 2
    model = Encoder(dataclasses.replace(loaded.cfg, dtype="float32", normalize=False))
    model.load_state_dict(loaded.state_dict())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 96, (3, 20)).astype(np.int64)
    mask = np.ones((3, 20), np.int64)
    mask[1, 12:] = 0
    with torch.no_grad():
        hs = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)
                ).last_hidden_state.numpy()
        ours = model(torch.tensor(ids), torch.tensor(mask)).numpy()
    w = mask[:, :, None].astype(np.float32)
    np.testing.assert_allclose(ours, (hs * w).sum(1) / w.sum(1), rtol=2e-3, atol=2e-4)
