"""Named encoder presets matching the BASELINE model classes (a copy of
cloudvectordb_tpu/models/presets.py).

BASELINE.json:8 — "MiniLM-L6 (384-d)"; BASELINE.json:9 — 768-d encoder
trained on MS MARCO triplets. Both are the same BERT-family architecture
(models/encoder.py) at different scales; HF checkpoints of these classes
import via models/hf_import.py.
"""

from __future__ import annotations

from cloudvectordb_tpu_torch.utils.config import EncoderConfig

PRESETS: dict[str, EncoderConfig] = {
    # sentence-transformers/all-MiniLM-L6-v2 class: 22M params, 384-d
    "minilm-l6-384": EncoderConfig(
        vocab_size=30522, hidden_dim=384, num_layers=6, num_heads=12,
        mlp_dim=1536, max_len=256, pooling="mean", normalize=True,
    ),
    # MiniLM-L12 class: 33M params, 384-d
    "minilm-l12-384": EncoderConfig(
        vocab_size=30522, hidden_dim=384, num_layers=12, num_heads=12,
        mlp_dim=1536, max_len=256, pooling="mean", normalize=True,
    ),
    # BERT-base class: 110M params, 768-d (BASELINE config #3's encoder scale)
    "bert-base-768": EncoderConfig(
        vocab_size=30522, hidden_dim=768, num_layers=12, num_heads=12,
        mlp_dim=3072, max_len=256, pooling="mean", normalize=True,
    ),
    # distilled 6-layer 768-d class (DistilBERT-ish)
    "distil-768": EncoderConfig(
        vocab_size=30522, hidden_dim=768, num_layers=6, num_heads=12,
        mlp_dim=3072, max_len=256, pooling="mean", normalize=True,
    ),
    # tiny config for tests / smoke runs
    "tiny-test": EncoderConfig(
        vocab_size=2048, hidden_dim=64, num_layers=2, num_heads=4,
        mlp_dim=128, max_len=64, dropout=0.0, dtype="float32",
    ),
}


def get_preset(name: str) -> EncoderConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown encoder preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return EncoderConfig(**cfg.__dict__)  # defensive copy
