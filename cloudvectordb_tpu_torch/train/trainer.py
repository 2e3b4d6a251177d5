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
has one).

Data parallelism over a 1-D ``'data'`` mesh (parallel/mesh.py; the
reference's ``jit`` with the batch sharded and the parameters replicated):
each slot holds a replica of the model on its device and forwards its
contiguous slice of the global batch; the slices' embeddings are gathered
(within a process by a copy, across processes by a gather that carries
gradients, ``gather_rows``), and the loss is the global batch's (InfoNCE's
in-batch negatives drawn from the whole global batch, as the reference's
SPMD program computes it; a stock DDP wrapper averaging each slice's own
loss would compute another). The parameter gradients sum over the slots
and then over the processes (``_reduce_grads``), so ``grad_norm`` is global
and every process takes the same AdamW step; a process's other replicas
copy the updated parameters of its first. The global batch is the
processes' batches in rank order, each split over its slots. With one slot
the step is the one-card step. Slot 0 draws its dropout masks from the
state's generator; any other slot from one seeded by (seed, step, slot),
so a resumed run draws the same masks. Rank 0 writes the checkpoints;
every process reads them on resume.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.base import from_numpy, to_numpy
from cloudvectordb_tpu_torch.models.encoder import Encoder, init_encoder
from cloudvectordb_tpu_torch.ops.topk import f32_const
from cloudvectordb_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_sum, data_sharding, gather_rows, make_mesh, replicated)
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
    generator: torch.Generator  # draws global slot 0's dropout masks
    replicas: list = field(default_factory=list)  # the models of this process's other slots


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


def default_mesh(cfg: TrainConfig, device: str | torch.device = DEFAULT) -> Mesh:
    """The trainer's mesh when none is given, by the reference's rule:
    ``cfg.mesh_data_axis`` 'data' slots over the visible cards (0: one a
    card; joined processes: the cards ``make_mesh`` gives each, one at its
    local rank or all of a host's to its only process) where ``device`` is
    plain ``"cuda"``, else on ``device`` (one card, or the CPU, which holds any
    number: the tests' stand-in for devices). Slots that would share a card
    raise: each replica is a copy of the model on its card, so N on one card
    take N times the memory and train no faster; ``mesh=`` shares a card
    deliberately."""
    dev = as_device(device)
    every_card = dev.type == "cuda" and dev.index is None
    mesh = make_mesh(cfg.mesh_data_axis or None, axis_name="data",
                     devices=None if every_card else [dev])
    cards = [d for _, _, d in mesh.local_slots() if d.type == "cuda"]
    if len(set(cards)) < len(cards):
        raise ValueError(
            f"mesh_data_axis={cfg.mesh_data_axis} puts {len(cards)} data slots on "
            f"{len(set(cards))} card(s) of this process, each replica a copy of the model; "
            "pass mesh=make_mesh(n, axis_name='data', devices=[...]) to share a card")
    return mesh


class Trainer:
    """``mesh``: a 1-D ``'data'`` mesh (parallel/mesh.py), by default
    ``default_mesh(cfg, device)``. The first local slot's device is the
    trainer's."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device = DEFAULT,
                 metrics: MetricsWriter | None = None, mesh: Mesh | None = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else default_mesh(cfg, device)
        self._place = data_sharding(self.mesh)
        self._slots = [s for _, s, _ in self.mesh.local_slots()]
        self.device = self.mesh.local_devices()[0]
        self.opt = make_optimizer(cfg)
        self.metrics = metrics or MetricsWriter(None)

    def init_state(self, seed: int | None = None) -> TrainState:
        seed = self.cfg.seed if seed is None else seed
        model = init_encoder(self.cfg.encoder, seed=seed, device=self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        models = replicated(self.mesh)(model)
        return TrainState(models[0], self.opt.init(models[0]), 0, generator, models[1:])

    # -- one step ------------------------------------------------------------
    def _embed(self, model: Encoder, batch: dict, generator: torch.Generator):
        """(anchor, positive, negative) embeddings of one stacked 3B forward
        in training mode."""
        ids = torch.cat([batch[f"{leg}_ids"] for leg in _LEGS])
        mask = torch.cat([batch[f"{leg}_mask"] for leg in _LEGS])
        model.train()
        emb = model(ids, mask, deterministic=False, generator=generator)
        b = batch["anchor_ids"].shape[0]
        return emb[:b], emb[b:2 * b], emb[2 * b:]

    def _loss(self, a, p, n):
        cfg = self.cfg
        if cfg.loss == "infonce":
            loss, acc = infonce_loss(a, p, n, temperature=cfg.temperature)
            if cfg.uniformity_weight > 0.0:
                loss = loss + cfg.uniformity_weight * uniformity_loss(a)
        else:
            loss = triplet_margin_loss(a, p, n, margin=cfg.margin)
            acc = (((a - p) ** 2).sum(-1) < ((a - n) ** 2).sum(-1)).float().mean()
        return loss, acc

    def loss_of(self, model: Encoder, batch: dict, generator: torch.Generator):
        """(loss, acc) of one stacked 3B forward in training mode."""
        return self._loss(*self._embed(model, batch, generator))

    def _slot_generator(self, state: TrainState, j: int) -> torch.Generator:
        """Local slot j's dropout generator: the state's for global slot 0,
        else one seeded by (seed, step, slot)."""
        s = self._slots[j]
        if s == 0:
            return state.generator
        g = torch.Generator(device=self.mesh.local_slots()[j][2])
        g.manual_seed((self.cfg.seed * 1_000_003 + state.step) * 4099 + s)
        return g

    def _reduce_grads(self, per_slot: list[list[torch.Tensor]]) -> list[torch.Tensor]:
        """The gradient all-reduce: per parameter, the sum over this
        process's slots in slot order on the first slot's device, then over
        the processes (mesh.py::all_reduce_sum)."""
        grads = list(per_slot[0])
        for more in per_slot[1:]:
            grads = [g + h.to(g.device) for g, h in zip(grads, more)]
        return all_reduce_sum(grads, self.mesh)

    def step_fn(self, state: TrainState, batch):
        """One training step on a placed batch (``place_batch``'s: a dict,
        or one a slot; a dict of this process's whole batch is split here);
        updates ``state`` in place and returns it with {"loss", "acc",
        "grad_norm"} as 0-d tensors on the device (no host sync)."""
        parts = batch if isinstance(batch, list) else (
            [batch] if len(self._slots) == 1 else self.place_batch(batch))
        models = [state.model, *state.replicas]
        embs = [self._embed(m, part, self._slot_generator(state, j))
                for j, (m, part) in enumerate(zip(models, parts))]
        if len(embs) == 1:
            a, p, n = embs[0]
        else:
            a, p, n = (torch.cat([e[i].to(self.device) for e in embs]) for i in range(3))
        a, p, n = (gather_rows(t, self.mesh) for t in (a, p, n))
        loss, acc = self._loss(a, p, n)
        params = dict(state.model.named_parameters())
        every = [list(m.parameters()) for m in models]
        flat = torch.autograd.grad(loss, [t for ps in every for t in ps])
        n_par = len(params)
        grads = self._reduce_grads([list(flat[j * n_par:(j + 1) * n_par])
                                    for j in range(len(models))])
        gnorm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        self.opt.update(params, grads, state.opt_state)
        self._sync_replicas(state)
        state.step += 1
        return state, {"loss": loss.detach(), "acc": acc.detach(), "grad_norm": gnorm}

    @staticmethod
    def _sync_replicas(state: TrainState) -> None:
        """This process's other replicas take its first's parameters."""
        if state.replicas:
            with torch.no_grad():
                src = list(state.model.parameters())
                for r in state.replicas:
                    for dst, p in zip(r.parameters(), src):
                        dst.copy_(p)

    def place_batch(self, batch: dict):
        """This process's host (numpy) or device batch → tensors on the
        trainer's device (one slot), or split over its slots, one dict a
        slot on the slot's device (``mesh.py::data_sharding``)."""
        if len(self._slots) == 1:
            return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        pieces = {k: self._place(v) for k, v in batch.items()}
        return [{k: v[j] for k, v in pieces.items()} for j in range(len(self._slots))]

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
        Trainer._sync_replicas(state)
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
                self._save(state, step_idx + 1)
        return state

    def _save(self, state: TrainState, step: int) -> None:
        """The checkpoint, written by rank 0; with several processes every
        process waits until it is written."""
        if self.mesh.rank == 0:
            save_checkpoint(self.cfg.ckpt_dir, step, self.state_arrays(state),
                            meta={"data_cursor": step}, keep_last=self.cfg.keep_last)
        if self.mesh.group is not None:
            torch.distributed.barrier(group=self.mesh.group)
