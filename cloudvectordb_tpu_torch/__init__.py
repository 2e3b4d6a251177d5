"""PyTorch + CUDA port of cloudvectordb_tpu for one NVIDIA H100.

The JAX package (``cloudvectordb_tpu``) is the reference; each module here
names its counterpart. This slice carries the residual-int8 ``BandIVFIndex``
serving path: k-means, a device-streaming build, the device planner, the
tile-table scan (a hand-written ``sm_90a`` kernel, ``csrc/tiles_resid.cu``),
tuning and device QPS.

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
