"""train/ and utils/checkpoint.py against the JAX package's, on CPU.

- The losses on the same numpy embeddings: within 1e-6 (the same f32
  formulas in the same order; the matmuls sum in other orders).
- Three ``step_fn`` steps from the JAX trainer's own initial params, carried
  across, on the same numpy batches (dropout 0, f32), with and without
  ``grad_accum``: loss within 1e-5 relative, acc equal, grad norm within
  1e-4 relative (the parameters drift apart by f32 rounding between steps).
  Final params: Adam divides each gradient by its own running RMS, so a
  weight whose gradient is rounding noise can move by up to lr per update in
  either direction; the bound is 2·lr per update with a nonzero learning
  rate, and the mean difference stays below 1% of lr.
- Port-only: the loss falls on learnable batches; 4 steps straight equal 2
  steps + checkpoint + resume for 2, bit for bit, with dropout 0.1; remat
  redraws the same dropout masks (the same gradients, bit for bit); a
  restore into another structure raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.train import losses as jax_losses
from cloudvectordb_tpu.train.trainer import Trainer as JaxTrainer
from cloudvectordb_tpu.utils.config import EncoderConfig as JaxEncoderConfig
from cloudvectordb_tpu.utils.config import TrainConfig as JaxTrainConfig
from cloudvectordb_tpu_torch.models.hf_import import state_dict_from_flax
from cloudvectordb_tpu_torch.train import losses
from cloudvectordb_tpu_torch.train.trainer import Trainer
from cloudvectordb_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from cloudvectordb_tpu_torch.utils.config import EncoderConfig, TrainConfig
from cloudvectordb_tpu_torch.utils.metrics import MetricsWriter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ENC = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
           max_len=8, dropout=0.0, dtype="float32")
TRAIN = dict(loss="infonce", temperature=0.1, batch_size=16, lr=3e-3, warmup_steps=1,
             total_steps=10, weight_decay=0.01, log_every=100, ckpt_every=100)


def toy_batches(n_steps, batch=16, max_len=8, vocab=64, seed=0):
    """Learnable structure (tests/distributed/test_train_dp.py): positives
    share the anchor's leading topic token, negatives carry another."""
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        topic = rng.integers(1, 8, size=batch)
        anchor, pos, neg = (rng.integers(8, vocab, size=(batch, max_len)).astype(np.int32)
                            for _ in range(3))
        anchor[:, 0] = topic
        pos[:, 0] = topic
        neg[:, 0] = (topic % 7) + 1
        mask = np.ones((batch, max_len), np.int32)
        mask[::3, 5:] = 0  # some padding
        yield {"anchor_ids": anchor, "anchor_mask": mask, "pos_ids": pos, "pos_mask": mask,
               "neg_ids": neg, "neg_mask": mask}


def _cfgs(tmp_path, enc=None, **kw):
    enc = {**ENC, **(enc or {})}
    kw = {**TRAIN, "ckpt_dir": str(tmp_path / "ckpt"), **kw}
    return (JaxTrainConfig(encoder=JaxEncoderConfig(**enc), **kw),
            TrainConfig(encoder=EncoderConfig(**enc), **kw))


def test_losses_match_the_reference():
    rng = np.random.default_rng(0)
    a, p, n = (rng.normal(size=(16, 24)).astype(np.float32) for _ in range(3))
    a, p, n = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (a, p, n))
    j = [jnp.asarray(x) for x in (a, p, n)]
    t = [torch.tensor(x) for x in (a, p, n)]
    close = lambda x, y: np.testing.assert_allclose(float(x), float(y), atol=1e-6, rtol=0)  # noqa: E731
    close(losses.triplet_margin_loss(*t), jax_losses.triplet_margin_loss(*j))
    for neg in (True, False):
        got = losses.infonce_loss(t[0], t[1], t[2] if neg else None, temperature=0.1)
        ref = jax_losses.infonce_loss(j[0], j[1], j[2] if neg else None, temperature=0.1)
        close(got[0], ref[0])
        assert float(got[1]) == float(ref[1])
    close(losses.uniformity_loss(t[0]), jax_losses.uniformity_loss(j[0]))
    assert losses.loss_fn_for("triplet") is losses.triplet_margin_loss
    with pytest.raises(ValueError):
        losses.loss_fn_for("nope")


def _steps_against_jax(tmp_path, n_steps, **kw):
    jcfg, cfg = _cfgs(tmp_path, **kw)
    jt = JaxTrainer(jcfg)
    jstate = jt.init_state()
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(state_dict_from_flax(jax.device_get(jstate.params),
                                                     cfg.encoder))
    for batch in toy_batches(n_steps, seed=5):
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
    return state


def test_three_steps_match_the_reference_trainer(tmp_path):
    state = _steps_against_jax(tmp_path, 3)
    assert state.step == 3 and state.opt_state["count"] == 3


def test_grad_accum_matches_optax_multisteps(tmp_path):
    state = _steps_against_jax(tmp_path, 4, grad_accum=2)
    assert state.step == 4 and state.opt_state["count"] == 2


def test_schedule_is_optax_warmup_cosine(tmp_path):
    import optax

    _, cfg = _cfgs(tmp_path, warmup_steps=3, total_steps=9)
    sched = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, 3, 9)
    opt = Trainer(cfg, device="cpu").opt
    for c in range(12):
        np.testing.assert_allclose(opt.schedule(c), float(sched(c)), rtol=1e-6, atol=1e-12)
    assert opt.schedule(0) == 0.0


def test_training_learns_the_topic_token(tmp_path):
    _, cfg = _cfgs(tmp_path, total_steps=40, warmup_steps=4)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    got = []
    for batch in toy_batches(40):
        state, m = trainer.step_fn(state, trainer.place_batch(batch))
        got.append(float(m["loss"]))
    assert np.mean(got[-8:]) < 0.7 * np.mean(got[:8]), got[::8]


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_exact_resume_is_bit_for_bit_with_dropout(tmp_path):
    enc = {"dropout": 0.1}
    _, straight = _cfgs(tmp_path / "a", enc=enc, total_steps=4, ckpt_every=2, log_every=1)
    metrics = tmp_path / "metrics.jsonl"
    with MetricsWriter(metrics) as mw:
        full = Trainer(straight, device="cpu", metrics=mw).fit(toy_batches(6), resume=False)
    rec = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rec] == [1, 2, 3, 4]
    assert {"loss", "acc", "grad_norm", "examples_per_s"} <= rec[0].keys()

    _, split = _cfgs(tmp_path / "b", enc=enc, total_steps=4, ckpt_every=2)
    first = Trainer(split, device="cpu").fit(toy_batches(2), resume=False)  # ckpt at 2
    assert first.step == 2
    resumed = Trainer(split, device="cpu").fit(toy_batches(6), resume=True)
    assert resumed.step == 4
    a, b = _params(full), _params(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())
    for slot in ("mu", "nu"):
        assert all(torch.equal(full.opt_state[slot][k], resumed.opt_state[slot][k])
                   for k in full.opt_state[slot])


def test_remat_redraws_the_same_dropout_masks(tmp_path):
    grads = []
    for remat in (False, True):
        _, cfg = _cfgs(tmp_path, enc={"dropout": 0.1, "remat": remat})
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state(seed=3)
        batch = trainer.place_batch(next(toy_batches(1)))
        loss, _ = trainer.loss_of(state.model, batch, state.generator)
        grads.append(torch.autograd.grad(loss, list(state.model.parameters())))
        grads.append(state.generator.get_state())
    assert torch.equal(grads[1], grads[3])  # the generator moved past the same draws
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[2]))


def test_restore_into_another_structure_raises(tmp_path):
    _, cfg = _cfgs(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    save_checkpoint(tmp_path / "c", 1, trainer.state_arrays(state))
    _, small = _cfgs(tmp_path, enc={"num_layers": 1})
    other = Trainer(small, device="cpu")
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path / "c", other.state_arrays(other.init_state()))
    like = trainer.state_arrays(state)
    like["params.emb_ln.bias"] = np.zeros(7, np.float32)  # same names, another shape
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path / "c", like)
    arrays, step, _ = restore_checkpoint(tmp_path / "c", trainer.state_arrays(state))
    assert step == 1 and arrays.keys() == trainer.state_arrays(state).keys()
    for s in range(2, 6):
        save_checkpoint(tmp_path / "c", s, arrays, keep_last=3)
    assert sorted(int(p.name[5:]) for p in (tmp_path / "c").iterdir()) == [3, 4, 5]
