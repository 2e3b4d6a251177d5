"""Contrastive training loop on one card (counterpart of
cloudvectordb_tpu/train/trainer.py).

One step runs the (anchor, positive, negative) token batches as ONE forward
on the stacked 3B batch, takes the loss (InfoNCE, optionally plus the
uniformity term, or the triplet margin), its gradients, and one optimizer
update. The optimizer (``make_optimizer``) is the reference's
``optax.adamw`` over ``optax.warmup_cosine_decay_schedule``, written out:
weight decay on every parameter (optax applies it with no mask), the
schedule read at the optimizer's own update count (so the first update has
lr 0), eps outside the square root; with ``grad_accum > 1``, optax's
``MultiSteps``: micro-step gradients are averaged, and the update count,
the schedule and the weight decay advance only on update steps.

Checkpoints carry params, optimizer state, step, the dropout generator's
state and the data cursor, so ``fit`` resumes exactly: restore, then
fast-forward the batch stream by the cursor (through its ``skip()`` where it
has one). One card, no data parallelism (the reference's mesh and DDP come
with the distribution slice).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.base import from_numpy, to_numpy
from cloudvectordb_tpu_torch.models.encoder import Encoder, init_encoder
from cloudvectordb_tpu_torch.ops.topk import f32_const
from cloudvectordb_tpu_torch.train.losses import (
    infonce_loss, triplet_margin_loss, uniformity_loss)
from cloudvectordb_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from cloudvectordb_tpu_torch.utils.config import TrainConfig
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device
from cloudvectordb_tpu_torch.utils.metrics import MetricsWriter, get_logger

log = get_logger("cvdb.train")

_LEGS = ("anchor", "pos", "neg")


@dataclass
class TrainState:
    model: Encoder
    opt_state: dict  # AdamW.init: count, mu, nu (+ mini_step, acc with grad_accum)
    step: int
    generator: torch.Generator  # draws every dropout mask


class AdamW:
    """``optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(total_steps, warmup_steps + 1)), weight_decay=...)``, wrapped in
    ``optax.MultiSteps(every_k_schedule=grad_accum)`` when grad_accum > 1.
    The state holds tensors keyed by parameter name; ``update`` changes the
    parameters in place."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        self.lr = cfg.lr
        self.warmup = cfg.warmup_steps
        self.decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
        self.weight_decay = cfg.weight_decay
        self.every = cfg.grad_accum

    def schedule(self, count: int) -> float:
        """The learning rate at update ``count`` (from 0), in f32 as optax
        computes it."""
        f = np.float32
        if count < self.warmup:  # linear from 0 to lr
            frac = f(1) - f(count) / f(self.warmup)
            return float((f(0) - f(self.lr)) * frac + f(self.lr))
        span = self.decay_steps - self.warmup
        c = min(count - self.warmup, span)
        return float(f(self.lr) * (f(0.5) * (f(1) + np.cos(f(np.pi) * f(c) / f(span)))))

    def init(self, model: torch.nn.Module) -> dict:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in model.named_parameters()}  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.every > 1:
            state.update(mini_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: list[torch.Tensor],
               state: dict) -> None:
        names = list(params)
        if self.every > 1:  # MultiSteps: running mean of the micro-step grads
            acc = [state["acc"][n] for n in names]
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_div_(diff, f32_const(state["mini_step"] + 1, acc[0]))
            torch._foreach_add_(acc, diff)
            if state["mini_step"] < self.every - 1:
                state["mini_step"] += 1
                return
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            state["mini_step"] = 0
        p = [params[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        count = state["count"] + 1
        f = np.float32
        bc1 = f32_const(float(f(1) - f(self.B1) ** f(count)), p[0])
        bc2 = f32_const(float(f(1) - f(self.B2) ** f(count)), p[0])
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.B1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - self.B2)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_add_(nu, g2)
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd * p;  p += -lr * u
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, f32_const(-self.schedule(state["count"]), p[0]))
        torch._foreach_add_(p, upd)
        state["count"] = count


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(cfg)


class Trainer:
    def __init__(self, cfg: TrainConfig, device: str | torch.device = DEFAULT,
                 metrics: MetricsWriter | None = None):
        self.cfg = cfg
        self.device = as_device(device)
        self.opt = make_optimizer(cfg)
        self.metrics = metrics or MetricsWriter(None)

    def init_state(self, seed: int | None = None) -> TrainState:
        seed = self.cfg.seed if seed is None else seed
        model = init_encoder(self.cfg.encoder, seed=seed, device=self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return TrainState(model, self.opt.init(model), 0, generator)

    # -- one step ------------------------------------------------------------
    def loss_of(self, model: Encoder, batch: dict, generator: torch.Generator):
        """(loss, acc) of one stacked 3B forward in training mode."""
        cfg = self.cfg
        ids = torch.cat([batch[f"{leg}_ids"] for leg in _LEGS])
        mask = torch.cat([batch[f"{leg}_mask"] for leg in _LEGS])
        model.train()
        emb = model(ids, mask, deterministic=False, generator=generator)
        b = batch["anchor_ids"].shape[0]
        a, p, n = emb[:b], emb[b:2 * b], emb[2 * b:]
        if cfg.loss == "infonce":
            loss, acc = infonce_loss(a, p, n, temperature=cfg.temperature)
            if cfg.uniformity_weight > 0.0:
                loss = loss + cfg.uniformity_weight * uniformity_loss(a)
        else:
            loss = triplet_margin_loss(a, p, n, margin=cfg.margin)
            acc = (((a - p) ** 2).sum(-1) < ((a - n) ** 2).sum(-1)).float().mean()
        return loss, acc

    def step_fn(self, state: TrainState, batch: dict):
        """One training step on a placed batch; updates ``state`` in place
        and returns it with {"loss", "acc", "grad_norm"} as 0-d tensors on
        the device (no host sync)."""
        loss, acc = self.loss_of(state.model, batch, state.generator)
        params = dict(state.model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        gnorm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        self.opt.update(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), "acc": acc.detach(), "grad_norm": gnorm}

    def place_batch(self, batch: dict) -> dict:
        """Host (numpy) or device batch → tensors on the trainer's device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    # -- checkpoint state ----------------------------------------------------
    @staticmethod
    def state_arrays(state: TrainState) -> dict[str, np.ndarray]:
        """Every array of the state, named by its state-dict key."""
        out = {f"params.{n}": to_numpy(t) for n, t in state.model.state_dict().items()}
        for slot in ("mu", "nu", "acc"):
            for n, t in state.opt_state.get(slot, {}).items():
                out[f"opt.{slot}.{n}"] = to_numpy(t)
        out["opt.count"] = np.asarray(state.opt_state["count"], np.int64)
        if "mini_step" in state.opt_state:
            out["opt.mini_step"] = np.asarray(state.opt_state["mini_step"], np.int64)
        out["step"] = np.asarray(state.step, np.int64)
        out["rng"] = state.generator.get_state().numpy()
        return out

    @staticmethod
    def load_state_arrays(state: TrainState, arrays: dict) -> TrainState:
        sd = state.model.state_dict()
        state.model.load_state_dict(
            {n: from_numpy(arrays[f"params.{n}"], t.dtype) for n, t in sd.items()})
        with torch.no_grad():
            for slot in ("mu", "nu", "acc"):
                for n, t in state.opt_state.get(slot, {}).items():
                    t.copy_(from_numpy(arrays[f"opt.{slot}.{n}"], t.dtype))
        state.opt_state["count"] = int(arrays["opt.count"])
        if "mini_step" in state.opt_state:
            state.opt_state["mini_step"] = int(arrays["opt.mini_step"])
        state.step = int(arrays["step"])
        state.generator.set_state(torch.from_numpy(np.array(arrays["rng"], np.uint8)))
        return state

    # -- the loop --------------------------------------------------------------
    def fit(self, batches: Iterator[dict], state: TrainState | None = None,
            resume: bool = True) -> TrainState:
        cfg = self.cfg
        state = state or self.init_state()
        skipper = batches if hasattr(batches, "skip") else None
        batches = iter(batches)
        start_step = 0
        if resume:
            arrays, step, meta = restore_checkpoint(cfg.ckpt_dir, self.state_arrays(state))
            if arrays is not None:
                state = self.load_state_arrays(state, arrays)
                start_step = step
                # exact resume: the stream restarts from its beginning on
                # every fit(), so skip what the checkpointed run consumed
                cursor = int(meta.get("data_cursor", step))
                if skipper is not None:
                    skipper.skip(cursor)
                else:
                    for _ in range(cursor):
                        if next(batches, None) is None:
                            break
                log.info("resumed from step %d (data cursor %d)", step, cursor)
        t0 = time.perf_counter()
        seen = 0
        for i, batch in enumerate(batches):
            step_idx = start_step + i
            if step_idx >= cfg.total_steps:
                break
            state, m = self.step_fn(state, self.place_batch(batch))
            seen += batch["anchor_ids"].shape[0]
            if (step_idx + 1) % cfg.log_every == 0:
                m = {k: float(v) for k, v in m.items()}
                dt = time.perf_counter() - t0
                self.metrics.log("train_step", step=step_idx + 1, loss=m["loss"],
                                 acc=m["acc"], grad_norm=m["grad_norm"],
                                 examples_per_s=seen / dt)
                log.info("step %d loss %.4f acc %.3f (%.0f ex/s)", step_idx + 1,
                         m["loss"], m["acc"], seen / dt)
            if (step_idx + 1) % cfg.ckpt_every == 0 or step_idx + 1 == cfg.total_steps:
                save_checkpoint(cfg.ckpt_dir, step_idx + 1, self.state_arrays(state),
                                meta={"data_cursor": step_idx + 1}, keep_last=cfg.keep_last)
        return state
