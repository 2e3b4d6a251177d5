"""The port's Encoder (models/encoder.py) on CPU against the JAX package's,
with the JAX params carried across by models/hf_import.py::
state_dict_from_flax, on the same numpy token ids and masks.

Tolerances: f32 embeddings within 1e-5 (the same f32 formulas, summed in
other orders); bf16 activations, mean cosine >= 0.999 (the two frameworks
round bf16 products and sums at different places); K4's plain version
('packed') against 'naive' within 2e-5 (-1e30 against finfo.min masking,
and a different softmax order); 'packed_batch' against 'naive' within 2e-6
(the same math on another block layout)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.models.encoder import init_encoder as jax_init
from cloudvectordb_tpu.utils.config import EncoderConfig as JaxConfig
from cloudvectordb_tpu_torch.models.encoder import Encoder, init_encoder
from cloudvectordb_tpu_torch.models.hf_import import state_dict_from_flax
from cloudvectordb_tpu_torch.ops import attn
from cloudvectordb_tpu_torch.utils.config import EncoderConfig

TINY = dict(vocab_size=128, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
            max_len=16, dropout=0.0, dtype="float32")


def _pair(**kw):
    """(JAX model, JAX params, the port's Encoder with those params)."""
    cfg = {**TINY, **kw}
    jm, jp = jax_init(JaxConfig(**cfg), seed=0)
    pcfg = EncoderConfig(**cfg)
    model = Encoder(pcfg)
    model.load_state_dict(state_dict_from_flax(jp, pcfg))
    return jm, jp, model.eval()


def _batch(n, length, vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (n, length)).astype(np.int32)
    mask = np.ones((n, length), np.int32)
    mask[1, length // 2:] = 0
    mask[2, 3:] = 0
    return ids, mask


def _run(jm, jp, model, ids, mask):
    a = np.asarray(jm.apply({"params": jp}, jnp.asarray(ids), jnp.asarray(mask), True))
    with torch.no_grad():
        b = model(torch.tensor(ids), torch.tensor(mask)).numpy()
    return a, b


@pytest.mark.parametrize("extra", [{}, {"out_dim": 24}, {"pooling": "cls"},
                                   {"normalize": False}])
def test_f32_embeddings_match_the_reference(extra):
    jm, jp, model = _pair(**extra)
    ids, mask = _batch(4, 16, 128)
    a, b = _run(jm, jp, model, ids, mask)
    assert b.shape == (4, extra.get("out_dim", 32)) and b.dtype == np.float32
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_bf16_embeddings_match_the_reference_in_cosine():
    jm, jp, model = _pair(dtype="bfloat16")
    ids, mask = _batch(8, 16, 128, seed=1)
    a, b = _run(jm, jp, model, ids, mask)
    assert float(np.mean(np.sum(a * b, axis=1))) >= 0.999


def test_padding_invariance():
    """Tokens under the mask do not move the pooled embedding."""
    _, _, model = _pair()
    ids, mask = _batch(4, 16, 128)
    ids2 = ids.copy()
    ids2[mask == 0] = 77
    with torch.no_grad():
        a = model(torch.tensor(ids), torch.tensor(mask))
        b = model(torch.tensor(ids2), torch.tensor(mask))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(a.numpy(), axis=1), 1.0, rtol=1e-5)


def test_packed_batch_equals_naive_and_falls_back():
    """128/L sequences per attention block with the block-diagonal mask:
    the same numbers as naive; a batch that does not divide falls back."""
    _, jp, naive = _pair(max_len=32)
    cfg = EncoderConfig(**{**TINY, "max_len": 32, "attn_impl": "packed_batch"})
    packed = Encoder(cfg)
    packed.load_state_dict(naive.state_dict())
    ids, mask = _batch(16, 32, 128, seed=2)
    mask[3, 5:] = 0
    with torch.no_grad():
        a = naive(torch.tensor(ids), torch.tensor(mask)).numpy()
        b = packed(torch.tensor(ids), torch.tensor(mask)).numpy()
        c = packed(torch.tensor(ids[:2]), torch.tensor(mask[:2])).numpy()
    layer = packed.layers()[0].attention
    assert layer._dispatch(0.0, True, 32, 16, False) == "packed_batch"
    assert layer._dispatch(0.0, True, 32, 2, False) == "naive"
    np.testing.assert_allclose(b, a, atol=2e-6)
    np.testing.assert_allclose(c, a[:2], atol=2e-6)


def test_packed_runs_k4s_plain_version_and_matches_naive():
    cfg = {**TINY, "max_len": 128, "attn_dropout": 0.0}
    _, _, naive = _pair(**cfg)
    packed = Encoder(EncoderConfig(**{**cfg, "attn_impl": "packed"}))
    packed.load_state_dict(naive.state_dict())
    ids, mask = _batch(3, 128, 128, seed=3)
    before = attn.mha_small_head.launches
    ti, tm = torch.tensor(ids), torch.tensor(mask)
    # a training forward (dropout 0): gradients flow through K4's plain backward
    out = packed(ti, tm, deterministic=False, generator=torch.Generator())
    grads = torch.autograd.grad(out.sum(), list(packed.parameters()))
    with torch.no_grad():
        a, b = naive(ti, tm).numpy(), packed(ti, tm).numpy()
    np.testing.assert_allclose(b, a, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), a, atol=2e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert attn.mha_small_head.launches == before  # CPU tensors: no kernel


def test_auto_picks_on_cpu_what_the_reference_picks_on_cpu():
    """On CPU the reference's 'auto' is always 'naive' (its kernels need
    the TPU); the port's is too, and picks the reference's TPU choices only
    for CUDA tensors."""
    jm, _, model = _pair(max_len=128, attn_dropout=0.0)
    att = model.layers()[0].attention
    jatt_cfg = JaxConfig(**{**TINY, "max_len": 128, "attn_dropout": 0.0})
    from cloudvectordb_tpu.models.encoder import SelfAttention as JaxAttention

    jatt = JaxAttention(jatt_cfg, jnp.float32)
    for det, length, batch in ((False, 128, 4), (True, 128, 4), (True, 32, 8), (True, 64, 3)):
        ref = jatt._attn_dispatch(0.0, det, length, batch)
        assert att._dispatch(0.0, det, length, batch, on_card=False) == ref == "naive"
    assert att._dispatch(0.0, False, 128, 4, on_card=True) == "packed"
    assert att._dispatch(0.0, True, 128, 4, on_card=True) == "naive"
    assert att._dispatch(0.0, True, 32, 8, on_card=True) == "packed_batch"
    att_drop = Encoder(EncoderConfig(**{**TINY, "max_len": 128, "dropout": 0.1})).layers()[0]
    assert att_drop.attention._dispatch(0.1, False, 128, 4, on_card=True) == "naive"


def test_dropout_needs_a_generator_and_is_reproducible():
    cfg = EncoderConfig(**{**TINY, "dropout": 0.1})
    model = init_encoder(cfg, seed=0, device="cpu")
    ids, mask = (torch.tensor(a) for a in _batch(4, 16, 128))
    with pytest.raises(ValueError):
        model(ids, mask, deterministic=False)
    outs = [model(ids, mask, deterministic=False,
                  generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], model(ids, mask))


def test_init_draws_flax_default_distributions():
    cfg = EncoderConfig(**{**TINY, "vocab_size": 2048, "hidden_dim": 64, "mlp_dim": 256})
    sd = init_encoder(cfg, seed=0, device="cpu").state_dict()
    assert abs(float(sd["tok_emb.weight"].std()) - 64 ** -0.5) < 0.01
    w = sd["layer_0.mlp_out.weight"]  # fan_in 256, truncated at 2 std
    assert abs(float(w.std()) - 256 ** -0.5) < 0.005
    assert float(w.abs().max()) <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6
    assert float(sd["layer_0.mlp_ln.weight"].min()) == 1.0
    assert float(sd["layer_0.mlp_in.bias"].abs().max()) == 0.0
    a = init_encoder(cfg, seed=0, device="cpu").state_dict()
    assert all(torch.equal(sd[k], a[k]) for k in sd)


def test_remat_config_is_the_same_function():
    cfg = dataclasses.replace(EncoderConfig(**TINY), remat=True)
    model = Encoder(cfg)
    _, _, plain = _pair()
    model.load_state_dict(plain.state_dict())
    ids, mask = (torch.tensor(a) for a in _batch(4, 16, 128))
    np.testing.assert_array_equal(model(ids, mask).detach().numpy(),
                                  plain(ids, mask).detach().numpy())
