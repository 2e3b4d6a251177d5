"""Data-parallel training and encoding (train/trainer.py and models/embed.py
with ``mesh=``, parallel/mesh.py's ``data_sharding``, ``replicated`` and
``shard_rows``) against the JAX package's on its eight simulated CPU
devices, the port's mesh eight ``'data'`` slots on the CPU.

- tests/distributed/test_train_dp.py's three cases on the port's mesh: the
  loss falls, ``fit`` checkpoints and resumes, a resume skips the batches
  already consumed.
- Eight slots against one on the same global batch (dropout 0, f32): the
  loss is the global batch's InfoNCE (in-batch negatives from every slot),
  so loss and grad_norm agree within 1e-5 relative and the parameters
  within 1e-5 after three steps; every replica holds the same parameters.
  The attention key biases are the exception: the loss does not depend on
  them (a softmax is unchanged by a shift shared by all its logits), so
  their gradient is f32 rounding noise (~1e-9 here), which Adam's
  normalisation turns into steps of up to lr in either direction; they are
  held, as test_torch_train.py holds every parameter, within 2·lr a live
  update.
- Eight slots against the JAX trainer's data-parallel steps from its own
  initial params, carried across, as tests/port/test_torch_train.py holds
  the one-card trainer.
- ``encode_corpus`` and ``encode_corpus_streaming`` over eight slots equal
  the one-slot encode (a batch that does not divide by eight included) and
  the JAX package's sharded encode within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import synthetic_corpus
from cloudvectordb_tpu.data.tokenize import TextTokenizer as JaxTokenizer
from cloudvectordb_tpu.models import embed as jax_embed
from cloudvectordb_tpu.models.encoder import init_encoder as jax_init
from cloudvectordb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cloudvectordb_tpu.parallel.mesh import shard_rows as jax_shard_rows
from cloudvectordb_tpu.train.trainer import Trainer as JaxTrainer
from cloudvectordb_tpu.utils.config import EncoderConfig as JaxEncoderConfig
from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer
from cloudvectordb_tpu_torch.models import embed
from cloudvectordb_tpu_torch.models.encoder import Encoder
from cloudvectordb_tpu_torch.models.hf_import import state_dict_from_flax
from cloudvectordb_tpu_torch.parallel.mesh import (
    data_sharding, make_mesh, replicated, shard_rows)
from cloudvectordb_tpu_torch.train.trainer import Trainer
from cloudvectordb_tpu_torch.utils.checkpoint import list_checkpoints
from cloudvectordb_tpu_torch.utils.config import EncoderConfig, TrainConfig

from test_torch_train import _cfgs, toy_batches

#: the DP step against the one-slot step: relative on loss and grad_norm,
#: absolute on the parameters (f32; the same sums in other orders)
DP_TOL = 1e-5


def data_mesh(n: int = 8):
    return make_mesh(n, axis_name="data", devices=["cpu"])


def dp_cfg(tmp_path, **kw):
    enc = EncoderConfig(vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2, mlp_dim=32,
                        max_len=8, dropout=0.0, dtype="float32")
    return TrainConfig(encoder=enc, **{**dict(batch_size=16, log_every=100,
                                              ckpt_dir=str(tmp_path / "ckpt")), **kw})


def test_dp_training_learns(tmp_path):
    _, cfg = _cfgs(tmp_path, total_steps=60, warmup_steps=5)
    trainer = Trainer(cfg, mesh=data_mesh())
    assert trainer.mesh.shape["data"] == 8 and len(trainer._slots) == 8
    state = trainer.init_state()
    losses = []
    for batch in toy_batches(60):
        state, m = trainer.step_fn(state, trainer.place_batch(batch))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7, losses[::10]


def test_fit_checkpoints_and_resumes(tmp_path):
    cfg = dp_cfg(tmp_path, total_steps=10, ckpt_every=5)
    Trainer(cfg, mesh=data_mesh()).fit(toy_batches(6), resume=False)  # stops at step 6
    assert 5 in list_checkpoints(cfg.ckpt_dir)
    final = Trainer(cfg, mesh=data_mesh()).fit(toy_batches(20), resume=True)
    assert final.step == 10


def test_resume_skips_consumed_batches(tmp_path):
    cfg = dp_cfg(tmp_path, total_steps=8, ckpt_every=4)
    Trainer(cfg, mesh=data_mesh()).fit(toy_batches(4), resume=False)  # ckpt at 4
    consumed = []

    def tracking_stream():
        for i, b in enumerate(toy_batches(20)):
            consumed.append(i)
            yield b

    final = Trainer(cfg, mesh=data_mesh()).fit(tracking_stream(), resume=True)
    assert final.step == 8
    assert consumed[:8] == list(range(8)) and len(consumed) <= 9


def test_dp_step_equals_one_slot_step(tmp_path):
    """Eight slots and one from the same initial parameters on the same
    global batches: the global InfoNCE, global grad_norm, the same AdamW
    step (uniformity term on; acc equal)."""
    _, cfg = _cfgs(tmp_path, uniformity_weight=0.1)
    one, dp = Trainer(cfg, device="cpu"), Trainer(cfg, mesh=data_mesh())
    s1, s8 = one.init_state(), dp.init_state()
    assert len(s8.replicas) == 7 and s8.model is not s8.replicas[0]
    shift_free = [n for n, _ in s1.model.named_parameters() if n.endswith("key.bias")]
    for batch in toy_batches(3, seed=5):
        placed = one.place_batch(batch)
        grads = dict(zip((n for n, _ in s1.model.named_parameters()), torch.autograd.grad(
            one.loss_of(s1.model, placed, s1.generator)[0], list(s1.model.parameters()))))
        assert max(float(grads[n].abs().max()) for n in shift_free) < 1e-7
        s1, m1 = one.step_fn(s1, placed)
        s8, m8 = dp.step_fn(s8, dp.place_batch(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m8[key]), float(m1[key]), rtol=DP_TOL)
        assert float(m8["acc"]) == float(m1["acc"])
    a, b = s1.model.state_dict(), s8.model.state_dict()
    assert max(float((a[k] - b[k]).abs().max()) for k in a if k not in shift_free) <= DP_TOL
    n_live = sum(one.opt.schedule(c) > 0 for c in range(s1.opt_state["count"]))
    assert max(float((a[k] - b[k]).abs().max()) for k in shift_free) <= 2 * cfg.lr * n_live
    for r in s8.replicas:
        assert all(torch.equal(p, q) for p, q in zip(r.parameters(), s8.model.parameters()))


def test_dp_steps_match_the_reference_trainer(tmp_path):
    """Eight slots against the JAX trainer's data-parallel step on its eight
    devices, from its own initial params: test_torch_train.py's bounds."""
    jcfg, cfg = _cfgs(tmp_path)
    jt = JaxTrainer(jcfg, mesh=jax_make_mesh(axis_name="data"))
    jstate = jt.init_state()
    trainer = Trainer(cfg, mesh=data_mesh())
    state = trainer.init_state()
    sd = state_dict_from_flax(jax.device_get(jstate.params), cfg.encoder)
    for m in (state.model, *state.replicas):
        m.load_state_dict(sd)
    for batch in toy_batches(3, seed=5):
        jstate, jm = jt.step_fn(jstate, jt.place_batch(batch))
        state, m = trainer.step_fn(state, trainer.place_batch(batch))
        jm = jax.device_get(jm)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(m["acc"]) == float(jm["acc"])
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ref = state_dict_from_flax(jax.device_get(jstate.params), cfg.encoder)
    got = state.model.state_dict()
    diff = torch.cat([(got[k] - ref[k]).abs().reshape(-1) for k in ref])
    n_live = sum(trainer.opt.schedule(c) > 0 for c in range(state.opt_state["count"]))
    assert float(diff.max()) <= 2 * cfg.lr * n_live
    assert float(diff.mean()) <= 0.01 * cfg.lr


def test_mesh_helpers_match_the_reference():
    """shard_rows pads to a multiple of the slots and returns the true N, as
    the reference's; data_sharding splits a batch in slot order;
    replicated gives a replica a slot."""
    x = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    ref, n_ref = jax_shard_rows(x, jax_make_mesh(axis_name="shard"))
    pieces, n = shard_rows(x, make_mesh(8, devices=["cpu"]))
    assert n == n_ref == 13 and len(pieces) == 8
    np.testing.assert_array_equal(torch.cat(pieces).numpy(), np.asarray(ref))
    mesh = data_mesh(4)
    parts = data_sharding(mesh)(x[:12])
    assert [p.shape[0] for p in parts] == [3] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x[:12])
    with pytest.raises(ValueError):
        data_sharding(mesh)(x)
    lin = torch.nn.Linear(3, 2)
    reps = replicated(mesh)(lin)
    assert reps[0] is lin and len({id(r) for r in reps}) == 4
    assert all(torch.equal(r.weight, lin.weight) for r in reps)



def test_default_mesh_follows_mesh_data_axis(tmp_path, monkeypatch):
    """Trainer's mesh without ``mesh=``: ``mesh_data_axis`` slots (0: one)
    as the reference's; the CPU holds any number, while slots that would
    share a card raise instead of copying the model N times onto it (the
    card named, or the plain "cuda" of a machine with one card; devices
    built without touching a card, so this runs on the CPU)."""
    from cloudvectordb_tpu_torch.parallel import mesh as mesh_mod
    from cloudvectordb_tpu_torch.train import trainer as trainer_mod

    for axis, slots in ((0, 1), (4, 4)):
        tr = Trainer(dp_cfg(tmp_path, mesh_data_axis=axis), device="cpu")
        assert len(tr.mesh.local_slots()) == slots and tr.device == torch.device("cpu")
    monkeypatch.setattr(trainer_mod, "as_device", torch.device)
    monkeypatch.setattr(mesh_mod, "as_device", torch.device)
    monkeypatch.setattr(mesh_mod.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh_mod.torch.cuda, "device_count", lambda: 1)
    one_card = trainer_mod.default_mesh(dp_cfg(tmp_path, mesh_data_axis=1), "cuda")
    assert [d for _, _, d in one_card.local_slots()] == [torch.device("cuda", 0)]
    for device in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="share a card"):
            Trainer(dp_cfg(tmp_path, mesh_data_axis=2), device=device)
    monkeypatch.setattr(mesh_mod.torch.cuda, "device_count", lambda: 2)
    two_cards = trainer_mod.default_mesh(dp_cfg(tmp_path), "cuda")
    assert [d for _, _, d in two_cards.local_slots()] == [torch.device("cuda", i)
                                                          for i in range(2)]


@pytest.fixture(scope="module")
def enc_setup():
    corpus = synthetic_corpus(45, seed=200)
    jtok = JaxTokenizer.train(corpus, vocab_size=512, max_len=16)
    tok = TextTokenizer(jtok._tok, max_len=16)
    kw = dict(vocab_size=max(tok.vocab_size, 8), hidden_dim=32, num_layers=1, num_heads=4,
              mlp_dim=64, max_len=16, dropout=0.0, dtype="float32")
    jm, jp = jax_init(JaxEncoderConfig(**kw), seed=0)
    cfg = EncoderConfig(**kw)
    model = Encoder(cfg)
    model.load_state_dict(state_dict_from_flax(jp, cfg))
    return corpus, jtok, tok, jm, jp, model


def test_encode_over_mesh_equals_one_slot(enc_setup):
    corpus, jtok, tok, jm, jp, model = enc_setup
    one = embed.encode_corpus(model, tok, corpus, batch_size=16, device="cpu")
    mesh = data_mesh()
    got = embed.encode_corpus(model, tok, corpus, batch_size=16, mesh=mesh)
    np.testing.assert_allclose(got, one, atol=1e-6, rtol=0)
    got7 = embed.encode_corpus(model, tok, corpus, batch_size=12, mesh=data_mesh(5))
    np.testing.assert_allclose(got7, one, atol=1e-6, rtol=0)  # 12 rows over 5 slots: padded
    ref = jax_embed.encode_corpus(jm, jp, jtok, corpus, mesh=jax_make_mesh(axis_name="data"),
                                  batch_size=16)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    seen = []
    n = embed.encode_corpus_streaming(model, tok, corpus, seen.append, batch_size=16, mesh=mesh)
    assert n == 45 and all(isinstance(e, torch.Tensor) for e in seen)
    np.testing.assert_allclose(torch.cat(seen).numpy(), one, atol=1e-6, rtol=0)
