"""The port stands alone: importing it, and running its paths on CPU tensors
(residual and whole-row tiles search, the band strategy, the fused flat
scan), loads no JAX, Flax, Triton or reference package, and never reaches
the CUDA binding (ops/_cuda.py): CPU tensors go to the plain versions."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

_PROBE = """
import json, sys
import numpy as np
import cloudvectordb_tpu_torch
from cloudvectordb_tpu_torch.eval import qps, recall, tune
from cloudvectordb_tpu_torch.index import arena, base, flat, ivf_band, kmeans, registry
from cloudvectordb_tpu_torch.ops import assign, band, flat_topk, topk
from cloudvectordb_tpu_torch.utils import metrics, native

rng = np.random.default_rng(0)
db = rng.normal(size=(2500, 32)).astype(np.float32)
hits = []
for kw in (dict(residual=True), dict(dtype="float32")):
    idx = ivf_band.BandIVFIndex.build(db, nlist=8, kmeans_iters=3, tile_n=128,
                                      tile_q=16, **kw)
    hits.append(idx.search(db[:20], 5)[1][:, 0])
hits.append(idx.search(db[:20], 5, strategy="band")[1][:, 0])
hits.append(flat.FlatIndex.build(db, metric="l2").search(db[:20], 5, exact=False)[1][:, 0])
print(json.dumps({
    "loaded": sorted(m for m in ("jax", "flax", "triton", "cloudvectordb_tpu",
                                 "cloudvectordb_tpu_torch.ops._cuda")
                     if m in sys.modules),
    "self_hit": min(float((h == np.arange(20)).mean()) for h in hits),
    "launches": [band.tiles_topk_resid.launches, band.tiles_topk.launches,
                 band.band_topk.launches, flat_topk.flat_topk.launches],
}))
"""


def test_import_and_cpu_path_pull_in_no_jax_and_no_cuda_binding():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["launches"] == [0, 0, 0, 0]
    assert res["self_hit"] >= 0.9


def test_device_measurement_refuses_the_cpu():
    from cloudvectordb_tpu_torch.eval.qps import qps_device

    with pytest.raises(RuntimeError):
        qps_device(lambda q: q, torch.zeros(4, 8))
