"""PyTorch + CUDA port of cloudvectordb_tpu for one NVIDIA H100.

The JAX package (``cloudvectordb_tpu``) is the reference; each module here
names its counterpart. Ported so far:
- ``index/``: ``BandIVFIndex`` over residual-int8 and whole-row arenas
  (k-means, device-streaming build, device planner, tiles and band
  searches, tuning) and ``FlatIndex``; ``eval/``: recall, device QPS,
  the tuner;
- ``models/``: ``encoder`` (the post-LN BERT encoder and its attention
  dispatch), ``presets``, ``hf_import`` (HF BERT and flax state dicts),
  ``embed`` (batch and streaming encode); ``data/tokenize``;
- ``train/``: ``losses`` and ``trainer`` (AdamW with warmup-cosine, grad
  accumulation, exact resume); ``utils/``: ``config``, ``checkpoint``,
  ``metrics``, ``device`` (entry points default to the card), ``native``;
- ``ops/``: the kernel wrappers, each with its plain PyTorch version, and
  ``_cuda`` (build and binding). The hand-written ``sm_90a`` kernels:
  ``csrc/tiles_resid.cu`` (K1), ``csrc/tiles_scan.cu`` (K2, K3, K7) and
  ``csrc/mha_small_head.cu`` (K4, attention forward and backward).

The package imports ``torch``, ``numpy`` and the standard library only.

TF32 policy: every f32 matmul of the port (exact top-k ground truth, coarse
assignment, k-means, the planner's query·centroid scores) runs in full f32,
as the reference's ``Precision.HIGHEST`` ground truth does
(``cloudvectordb_tpu/ops/topk.py``). That is PyTorch's default; it is set
here, on import of any module of the package, so that the exact paths do
not depend on it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
