"""PyTorch + CUDA port of cloudvectordb_tpu for one NVIDIA H100.

The JAX package (``cloudvectordb_tpu``) is the reference; each module here
names its counterpart. Ported so far: ``BandIVFIndex`` over residual-int8
and whole-row arenas (k-means, device-streaming build, device planner, tiles
and band searches, tuning, device QPS) and ``FlatIndex``, with their scans
as hand-written ``sm_90a`` kernels (``csrc/tiles_resid.cu``,
``csrc/tiles_scan.cu``).

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
