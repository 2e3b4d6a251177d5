"""Encoder throughput on the card (counterpart of scripts/bench_encode.py):
the MiniLM-L6-class encoder at max_len 128, the forward encode and the full
training step, the numbers the "<1 hour build from raw text" budget takes.

    python scripts/torch_bench_encode.py

Env: PRESET (an encoder preset; default the 384-d MiniLM-L6 config),
ENC_B (512, the encode batch), TRAIN_B (512 triplets a step), FUSED=1 (also
time the 'fused' variant: torch's scaled_dot_product_attention, a library
call and no kernel of this repo).

Training variants, as the reference's: 'naive' attention with dropout,
'naive' without attention-probs dropout, and 'packed' (K4, forward and
backward) without it. Each step is three legs of TRAIN_B sequences (anchor,
positive, negative), forward and backward, on batches placed on the card
before the timed span; time is the fenced host clock over the steps. MFU
counts 6 x non-embedding parameters x tokens against the H100's dense bf16
peak (989 TFLOP/s). The closing check holds the 'fused' forward against the
'naive' one on a padded batch (mean cosine > 0.999) and fails the run
otherwise. Ends with one JSON line.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.models.encoder import init_encoder  # noqa: E402
from cloudvectordb_tpu_torch.models.presets import get_preset  # noqa: E402
from cloudvectordb_tpu_torch.train.trainer import Trainer  # noqa: E402
from cloudvectordb_tpu_torch.utils.config import EncoderConfig, TrainConfig  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

MAX_LEN = 128
ENC_ITERS, TRAIN_ITERS = 6, 4
#: the padded batch of the closing check keeps its first PAD_FROM tokens
PAD_FROM = 100
BF16_PEAK = 989e12
COS_FLOOR = 0.999


def encoder_config() -> EncoderConfig:
    preset = os.environ.get("PRESET")
    if preset:
        return dataclasses.replace(get_preset(preset), max_len=MAX_LEN)
    return EncoderConfig(max_len=MAX_LEN)


def time_train(dev, enc_cfg: EncoderConfig, tb: int, label: str) -> dict:
    """ms a step of TRAIN_ITERS steps after one warm-up step."""
    tcfg = TrainConfig(encoder=enc_cfg, batch_size=tb, total_steps=1)
    trainer = Trainer(tcfg, device=dev)
    state = trainer.init_state()
    rng = np.random.default_rng(0)

    def mk_train():
        ones = np.ones((tb, enc_cfg.max_len), np.int32)
        return {f"{leg}_{x}": (rng.integers(0, enc_cfg.vocab_size, (tb, enc_cfg.max_len))
                               .astype(np.int32) if x == "ids" else ones)
                for leg in ("anchor", "pos", "neg") for x in ("ids", "mask")}

    state, m = trainer.step_fn(state, trainer.place_batch(mk_train()))
    loss0 = float(m["loss"])
    placed = [trainer.place_batch(mk_train()) for _ in range(TRAIN_ITERS)]

    def steps():
        nonlocal state
        for b in placed:
            state, _ = trainer.step_fn(state, b)

    _, ms = harness.host_ms(steps, dev)
    ms /= TRAIN_ITERS
    n_p = sum(p.numel() for p in state.model.parameters())
    n_embed = enc_cfg.vocab_size * enc_cfg.hidden_dim + enc_cfg.max_len * enc_cfg.hidden_dim
    flops = 6 * (n_p - n_embed) * 3 * tb * enc_cfg.max_len
    row = {"variant": label, "B": tb, "L": enc_cfg.max_len, "params": n_p, "ms_step": ms,
           "triplets_per_s": tb / (ms / 1e3), "mfu": flops / (ms / 1e3) / BF16_PEAK,
           "loss0": loss0}
    print(f"train[{label}] (B={tb} triplets, L={enc_cfg.max_len}, {n_p / 1e6:.1f}M params): "
          f"{row['triplets_per_s']:,.0f} triplets/s ({ms:.1f} ms/step, MFU {row['mfu']:.1%} "
          f"of the bf16 peak, loss0 {loss0:.3f})", flush=True)
    return row


def main(argv=None, device="cuda") -> dict:
    dev = as_device(device)
    card = harness.card_line(dev)
    cfg = encoder_config()
    b = int(os.environ.get("ENC_B", "512"))
    tb = int(os.environ.get("TRAIN_B", "512"))
    harness.reset_launches()

    model = init_encoder(cfg, seed=0, device=dev).eval()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    batches = [torch.randint(0, cfg.vocab_size, (b, cfg.max_len), generator=g, device=dev)
               for _ in range(8)]
    mask = torch.ones_like(batches[0])
    with torch.inference_mode():
        model(batches[0], mask)
        ms = harness.device_ms(lambda i: model(batches[i % 8], mask), dev, ENC_ITERS)
    enc_ps = b * ENC_ITERS / (sum(ms) / 1e3)
    print(f"encode fwd (B={b}, L={cfg.max_len}; {card}): {enc_ps:,.0f} passages/s", flush=True)
    print(f"  → 1M passages in {1e6 / enc_ps:,.0f} s", flush=True)
    del model

    variants = [(dict(attn_impl="naive"), "naive, full dropout"),
                (dict(attn_impl="naive", attn_dropout=0.0), "naive, attn_dropout=0"),
                (dict(attn_impl="packed", attn_dropout=0.0), "packed (K4), attn_dropout=0")]
    if os.environ.get("FUSED") == "1":
        variants.append((dict(attn_impl="fused", attn_dropout=0.0),
                         "fused (SDPA), attn_dropout=0"))
    train = [time_train(dev, dataclasses.replace(cfg, **kw), tb, label)
             for kw, label in variants]

    # numerical sanity: the fused forward against the naive one on a padded batch
    ids = batches[0]
    pad = mask.clone()
    pad[:, PAD_FROM:] = 0
    outs = []
    for impl in ("naive", "fused"):
        m = init_encoder(dataclasses.replace(cfg, attn_impl=impl, attn_dropout=0.0), seed=0,
                         device=dev).eval()
        with torch.inference_mode():
            outs.append(m(ids, pad).float())
    cos = float((outs[0] * outs[1]).sum(dim=1).mean())
    print(f"fused-vs-naive fwd mean cos (padded batch): {cos:.6f}", flush=True)
    if not cos > COS_FLOOR:
        raise AssertionError(f"fused attention diverged from the naive path: {cos}")
    return harness.emit({"script": "bench_encode", "card": card, "preset":
                         os.environ.get("PRESET") or "minilm-l6 (EncoderConfig)",
                         "encode": {"B": b, "L": cfg.max_len, "passages_per_s": enc_ps},
                         "train": train, "fused_vs_naive_cos": cos,
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
