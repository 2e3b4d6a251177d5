"""Typed dataclass configs for every pipeline stage (a copy of
cloudvectordb_tpu/utils/config.py, which imports no JAX).

The same fields, defaults, JSON round-trip, dotted-path overrides and
``config_hash``, so a config saved by either package loads in the other and
hashes the same. ``TrainConfig.rng_impl`` (the TPU's hardware RNG; the
port draws dropout masks from a ``torch.Generator``) means nothing to the
port and is kept only so the JSON round-trips. ``TrainConfig.mesh_data_axis``
sizes the trainer's default data-parallel mesh (train/trainer.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


def _asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


class _ConfigBase:
    """JSON round-trip + dotted-path CLI overrides for all stage configs."""

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, sort_keys=True)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "_ConfigBase":
        """Build from a dict, recursing into nested dataclass fields.

        PEP-563 (`from __future__ import annotations`) makes `f.type` a
        STRING, so nested types must come from resolved type hints — an
        `is_dataclass(f.type)` check would silently never fire and leave
        raw dicts in nested fields.
        """
        import typing

        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            ftype = hints.get(f.name, f.type)
            if isinstance(v, dict) and dataclasses.is_dataclass(ftype):
                kwargs[f.name] = ftype.from_dict(v)
            elif (isinstance(v, dict)
                  and isinstance(f.default_factory, type)
                  and dataclasses.is_dataclass(f.default_factory)):
                kwargs[f.name] = f.default_factory.from_dict(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str | Path) -> "_ConfigBase":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def with_overrides(self, overrides: dict[str, Any]) -> "_ConfigBase":
        """Apply {'a.b.c': value} dotted-path overrides, returning a new config."""
        d = _asdict(self)
        for dotted, value in overrides.items():
            node = d
            *parents, leaf = dotted.split(".")
            for p in parents:
                node = node[p]
            if leaf not in node:
                raise KeyError(f"unknown config key: {dotted}")
            node[leaf] = value
        return type(self).from_dict(d)

    def config_hash(self) -> str:
        import hashlib

        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


@dataclass
class EncoderConfig(_ConfigBase):
    """MiniLM-class sentence encoder (BASELINE.json:8-9: 384-d and 768-d variants)."""

    vocab_size: int = 30522
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 256
    dropout: float = 0.1
    # attention-probs dropout (HF BERT's attention_probs_dropout_prob).
    # None → follow `dropout`. Its mask is the model's largest tensor
    # (B·heads·L², 4.6× the hidden states at L=128); 0.0 lets 'auto' take
    # the packed kernel K4 in training.
    attn_dropout: float | None = None
    # attention implementation (models/encoder.py::SelfAttention._dispatch):
    # 'auto' takes the packed small-head kernel K4 (ops/attn.py) for a
    # training forward on the card with no probs dropout, L%128==0 and
    # L≤512, 'packed_batch' for short deterministic forwards on the card,
    # and 'naive' otherwise. 'packed'/'fused'/'packed_batch'/'naive' force
    # a path; 'fused' is torch's scaled_dot_product_attention.
    attn_impl: str = "auto"
    pooling: str = "mean"          # mean | cls
    normalize: bool = True         # L2-normalize sentence embeddings
    dtype: str = "bfloat16"        # activation dtype (params stay f32)
    out_dim: int = 0               # 0 → hidden_dim; else linear projection head
    remat: bool = False            # rematerialize layers (trade FLOPs for HBM)


@dataclass
class TrainConfig(_ConfigBase):
    """Contrastive training (SURVEY.md §2.1 Trainer)."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    encoder_preset: str = ""       # named preset (models/presets.py) overrides encoder
    loss: str = "infonce"          # infonce | triplet
    temperature: float = 0.1      # InfoNCE temperature (0.05 collapses
                                  # tiny from-scratch encoders)
    uniformity_weight: float = 0.0  # optional Wang–Isola anti-collapse term
    margin: float = 0.5            # triplet margin
    batch_size: int = 256          # global batch
    lr: float = 2e-5
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    grad_accum: int = 1
    seed: int = 0
    # the reference's PRNG implementation for dropout masks ('rbg': the
    # TPU's hardware RNG); ignored by the port, kept for the JSON round-trip
    rng_impl: str = "rbg"
    ckpt_every: int = 200
    ckpt_dir: str = "artifacts/ckpt"
    keep_last: int = 3
    log_every: int = 10
    mesh_data_axis: int = 0        # 'data' slots over the visible cards; 0 → one a card


@dataclass
class IndexConfig(_ConfigBase):
    """Index-and-query engine config (SURVEY.md §2.2)."""

    kind: str = "ivf_pq"           # flat | ivf_flat | ivf_pq | band_ivf
    metric: str = "ip"             # ip | l2  (ip on L2-normalized vectors ≡ cosine)
    dim: int = 384
    nlist: int = 4096              # coarse centroids (BASELINE config #2)
    nprobe: int = 64
    m: int = 64                    # PQ sub-quantizers (BASELINE config #3)
    nbits: int = 8                 # bits per sub-code → 2**nbits codewords
    opq: bool = False              # learned rotation before PQ
    refine: str = "int8"           # none | int8: exact re-rank of ADC top-R
    refine_factor: int = 16       # ADC candidates per requested k
    residual: bool = True          # band_ivf: residual-int8 encoding (r2)
    slack: float = 0.0             # band_ivf residual: per-list slack slots
                                   # for O(batch) in-place adds (r2)
    aniso_eta: float = 0.0         # band_ivf_pq: >1 trains score-aware
                                   # (anisotropic) PQ codebooks (r2)
    kmeans_iters: int = 20
    pq_train_iters: int = 12
    train_sample: int = 262_144    # vectors sampled for k-means / PQ training
    seed: int = 0
    dtype: str = "float32"         # stored vector dtype for flat / ivf_flat
    nshards: int = 0               # >0: row-partitioned sharded index over a
                                   # 1-D 'shard' device mesh (config #4) —
                                   # band_ivf | ivf_pq kinds (r3)


@dataclass
class MiningConfig(_ConfigBase):
    """Triplet mining (SURVEY.md §2.1 Triplet miner)."""

    strategy: str = "inbatch"      # inbatch | hard (index-assisted hard negatives)
    num_triplets: int = 100_000
    hard_topk: int = 100           # candidate pool per anchor for hard negatives
    hard_skip: int = 1             # skip top results (likely positives)
    seed: int = 0


@dataclass
class DataConfig(_ConfigBase):
    corpus: str = "synthetic"      # synthetic | hf:<dataset> | file:<path>
    split: str = "train"
    text_field: str = "text"
    num_docs: int = 10_000
    max_len: int = 256
    chunk_long_docs: bool = True   # chunk-and-pool for long documents (SURVEY.md §5.7)
    chunk_stride: int = 140        # must be ≤ chunk window (180 words) or
                                   # inter-window words would be dropped;
                                   # chunk_document clamps defensively
    seed: int = 0


@dataclass
class PipelineConfig(_ConfigBase):
    """The whole "script" [REF README.md:2], staged + resumable."""

    workdir: str = "artifacts/run"
    data: DataConfig = field(default_factory=DataConfig)
    mining: MiningConfig = field(default_factory=MiningConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    encode_batch: int = 1024
    eval_k: int = 10
    eval_queries: int = 1024
    stages: tuple = ("mine", "train", "encode", "build", "eval")
