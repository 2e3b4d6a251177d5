"""The port stands alone: importing it (the data layer, the pipeline, the
CLI, ``python -m``'s ``__main__`` and the sharded serving layer
``parallel/`` included), and running its paths on CPU tensors (residual
and whole-row tiles search, the band strategy, the fused flat scan, the
PQ-tiles index with OPQ on both serving routes, the probe-scan IVF-Flat
and IVF-PQ indexes, the sharded band, IVF-PQ and flat indexes over a mesh
of four CPU shards, the full PQ scan, an encoder
forward, K4's plain forward and backward, a training step, inbatch mining),
loads no JAX, Flax, Triton or reference package, and never reaches the CUDA
binding (ops/_cuda.py): CPU tensors go to the plain versions. Entry points
default to the card: without one they raise."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

_PROBE = """
import json, sys
import numpy as np
import torch
import cloudvectordb_tpu_torch
from cloudvectordb_tpu_torch.eval import qps, recall, sweep, tune
from cloudvectordb_tpu_torch.index import (
    arena, base, flat, ivf_band, ivf_band_pq, ivf_flat, ivf_pq, kmeans, opq, pq as pq_index,
    range as range_search, registry)
from cloudvectordb_tpu_torch import cli
from cloudvectordb_tpu_torch.data import corpus, synthetic, tokenize, triplets
from cloudvectordb_tpu_torch.pipeline import run
from cloudvectordb_tpu_torch.models import embed, encoder, hf_import, presets
from cloudvectordb_tpu_torch.ops import adc, assign, attn, band, flat_topk, pq, topk
from cloudvectordb_tpu_torch.train import losses, trainer
from cloudvectordb_tpu_torch.utils import checkpoint, config, device, metrics, native

rng = np.random.default_rng(0)
db = rng.normal(size=(2500, 32)).astype(np.float32)
hits = []
for kw in (dict(residual=True), dict(dtype="float32")):
    idx = ivf_band.BandIVFIndex.build(db, nlist=8, kmeans_iters=3, tile_n=128,
                                      tile_q=16, device="cpu", **kw)
    hits.append(idx.search(db[:20], 5)[1][:, 0])
hits.append(idx.search(db[:20], 5, strategy="band")[1][:, 0])
hits.append(flat.FlatIndex.build(db, metric="l2", device="cpu").search(db[:20], 5, exact=False)[1][:, 0])
pqi = ivf_band_pq.BandIVFPQIndex.build(db, nlist=8, m=8, nbits=5, opq=True, kmeans_iters=3,
                                       pq_train_iters=3, tile_n=128, tile_q=16, device="cpu")
for route in ("pq", "refine"):
    hits.append(pqi.search(db[:20], 5, serve_from=route, refine_factor=8)[1][:, 0])
hits.append(ivf_flat.IVFFlatIndex.build(db, 8, kmeans_iters=3, device="cpu")
            .search(db[:20], 5, nprobe=2)[1][:, 0])
hits.append(ivf_pq.IVFPQIndex.build(db, 8, m=8, nbits=5, kmeans_iters=3, pq_train_iters=3,
                                    refine="int8", device="cpu")
            .search(db[:20], 5, nprobe=2)[1][:, 0])
from cloudvectordb_tpu_torch import parallel
from cloudvectordb_tpu_torch.parallel import dist_band, dist_ivf, dist_search, mesh, persist
cpu4 = mesh.make_mesh(4, devices=["cpu"])
hits.append(parallel.ShardedBandIndex.build(db, 8, mesh=cpu4, residual=True, kmeans_iters=3,
                                            tile_n=128, tile_q=16)
            .search(db[:20], 5)[1][:, 0])
hits.append(parallel.ShardedIVFPQIndex.build(db, 8, m=8, nbits=5, mesh=cpu4, kmeans_iters=3,
                                             pq_train_iters=3, refine="int8")
            .search(db[:20], 5, nprobe=8)[1][:, 0])
hits.append(parallel.DistributedFlatIndex.build(db, mesh=cpu4).search(db[:20], 5)[1][:, 0])
codes_cm = pqi._codes[:1000].T.contiguous()
hits.append(pq.pq_topk(codes_cm, torch.from_numpy(pqi.codebooks),
                       torch.from_numpy(db[:20] @ pqi.opq_matrix.T), 5)[1][:, 0].numpy())
enc = config.EncoderConfig(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=4,
                           mlp_dim=64, max_len=128, dropout=0.0, dtype="float32")
ids = torch.from_numpy(rng.integers(1, 64, size=(4, 128)))
mask = torch.ones((4, 128), dtype=torch.int32)
emb = embed.make_encode_fn(encoder.init_encoder(enc, device="cpu"), device="cpu")(ids, mask)
q, k, v = (torch.randn(2, 128, 32, requires_grad=True) for _ in range(3))
attn.mha_small_head(q, k, v, mask[:2], 4, 8, 8 ** -0.5).sum().backward()
tcfg = config.TrainConfig(encoder=enc, batch_size=4, total_steps=2)
tr = trainer.Trainer(tcfg, device="cpu")
batch = tr.place_batch({f"{leg}_{x}": (ids if x == "ids" else mask)
                        for leg in ("anchor", "pos", "neg") for x in ("ids", "mask")})
_, m = tr.step_fn(tr.init_state(), batch)
passages, doc_ids = corpus.load_passages(config.DataConfig(num_docs=30))
mined = triplets.mine_triplets(passages, doc_ids, config.MiningConfig(num_triplets=8))
import contextlib, io, runpy
sys.argv = ["cloudvectordb_tpu_torch", "--help"]
with contextlib.redirect_stdout(io.StringIO()) as helped:
    try:
        runpy.run_module("cloudvectordb_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0
print(json.dumps({
    "loaded": sorted(m for m in ("jax", "flax", "triton", "cloudvectordb_tpu",
                                 "cloudvectordb_tpu_torch.ops._cuda")
                     if m in sys.modules),
    "self_hit": min(float((h == np.arange(20)).mean()) for h in hits[:-1]),
    "pq_scan_ran": bool(np.all(hits[-1] >= 0) and np.all(hits[-1] < 1000)),
    "launches": [band.tiles_topk_resid.launches, band.tiles_topk.launches,
                 band.band_topk.launches, flat_topk.flat_topk.launches,
                 pq.pq_tiles_topk.launches, pq.pq_topk.launches,
                 attn.mha_small_head.launches, attn.mha_small_head.bwd_launches],
    "finite": bool(torch.isfinite(emb).all() and torch.isfinite(q.grad).all()
                   and torch.isfinite(m["loss"])),
    "mined": len(mined), "helped": "pipeline" in helped.getvalue(),
}))
"""


def test_import_and_cpu_path_pull_in_no_jax_and_no_cuda_binding():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["launches"] == [0] * 8
    assert res["self_hit"] >= 0.9 and res["finite"] and res["pq_scan_ran"]
    assert res["mined"] == 8 and res["helped"]


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card, an entry point given no device raises torch's own
    error; none of them quietly builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the defaults run there")
    from cloudvectordb_tpu_torch.index.flat import FlatIndex
    from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
    from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
    from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex
    from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex
    from cloudvectordb_tpu_torch.index.registry import load_index
    from cloudvectordb_tpu_torch.models.embed import make_encode_fn
    from cloudvectordb_tpu_torch.cli import main as cli_main
    from cloudvectordb_tpu_torch.models.encoder import init_encoder
    from cloudvectordb_tpu_torch.pipeline.run import Pipeline
    from cloudvectordb_tpu_torch.train.trainer import Trainer
    from cloudvectordb_tpu_torch.utils.config import EncoderConfig, PipelineConfig, TrainConfig

    no_card = (AssertionError, RuntimeError)  # torch's "not compiled with CUDA"
    with pytest.raises(no_card):
        FlatIndex(8)
    with pytest.raises(no_card):
        BandIVFIndex(8, 4)
    with pytest.raises(no_card):
        BandIVFPQIndex(64, 4, m=8)
    with pytest.raises(no_card):
        IVFFlatIndex(8, 4)
    with pytest.raises(no_card):
        IVFPQIndex(64, 4, m=8)
    FlatIndex.build(np.eye(8, dtype=np.float32), device="cpu").save(tmp_path / "flat")
    with pytest.raises(no_card):
        load_index(tmp_path / "flat")
    assert load_index(tmp_path / "flat", device="cpu").ntotal == 8
    enc = EncoderConfig(vocab_size=16, hidden_dim=8, num_layers=1, num_heads=2, mlp_dim=16,
                        max_len=8)
    with pytest.raises(no_card):
        init_encoder(enc)
    with pytest.raises(no_card):
        make_encode_fn(init_encoder(enc, device="cpu"))
    with pytest.raises(no_card):
        Trainer(TrainConfig(encoder=enc))
    with pytest.raises(no_card):
        Pipeline(PipelineConfig(workdir=str(tmp_path / "run")))
    assert not (tmp_path / "run").exists()  # raised before touching the workdir
    with pytest.raises(no_card):
        cli_main(["eval", "--workdir", str(tmp_path / "run")])


def test_device_measurement_refuses_the_cpu():
    from cloudvectordb_tpu_torch.eval.qps import qps_device

    with pytest.raises(RuntimeError):
        qps_device(lambda q: q, torch.zeros(4, 8))


def test_no_source_of_the_port_imports_jax_or_the_reference():
    """Read statically: no module of the port (``parallel/`` included), not
    ``chip_smoke.py`` and no ``scripts/torch_*.py`` (the measuring entry
    points and the card's tools) imports jax, flax or the JAX package, at
    any depth of a function."""
    import re

    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|flax|cloudvectordb_tpu)(?:[.\s]|$)",
                     re.MULTILINE)
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    files = (sorted((REPO / "cloudvectordb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + scripts)
    assert any(f.parent.name == "parallel" for f in files)
    assert {f.stem for f in scripts} >= {
        "torch_bench_latency", "torch_bench_build_budget", "torch_bench_text_serving",
        "torch_bench_encoder_real", "torch_bench_encode", "torch_bench_config2",
        "torch_bench_config5", "torch_eval_sift", "torch_pq_hold_faults", "torch_pq_scan_ab",
        "torch_scan_checkout_times", "torch_scan_hold_faults", "torch_wordpiece_runs"}
    hits = [(f.relative_to(REPO), m.group(0).strip()) for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []
