#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (cloudvectordb_tpu_torch) on one GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build of the hand-written kernel from csrc/tiles_resid.cu (nvcc), timed;
3. the kernel against its plain PyTorch version on the card, on small
   random shapes (one slot per bucket and four, windows of 1 to 129 lists,
   valid_end holes, a short final tile, partial query blocks);
4. the serving slice: a 12.5M x 768 corpus generated on the device (the
   process of bench.py: latent 32, 256 centres, noise 0.3/sqrt(32),
   L2-normalised), ``BandIVFIndex.build_device_streaming`` with nlist 4096
   and residual int8, ``tune(k=10, target_recall=0.95)``, then batches of
   4096 through ``search_device``; the kernel's launch count over that run
   must be > 0 and recall@10 against the exact f32 ground truth on 512
   queries must reach 0.90; device QPS is the median of CUDA-event-timed
   repetitions;
5. the kernel against its plain version at the main path's shape (the
   tuned op point on a real 4096-query batch), with both times.

Then one JSON line with the kernel's record and, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cloudvectordb_tpu_torch.eval.qps import qps_device
from cloudvectordb_tpu_torch.eval.recall import recall_at_k
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex, _plan_tiles
from cloudvectordb_tpu_torch.ops import band
from cloudvectordb_tpu_torch.ops.topk import merge_topk, tiled_topk

D, K, B, LATENT, NCENTERS = 768, 10, 4096, 32, 256
N_ROWS = 12_500_000
CHUNK = 500_000
NLIST = 4096
NQ_GT = 512
RECALL_FLOOR = 0.90
ID_MATCH_FLOOR = 0.999
SCORE_TOL = 1e-4
KERNEL = {
    "name": "tiles_topk_resid",
    "route": "cuda",
    "source": "cloudvectordb_tpu_torch/csrc/tiles_resid.cu",
    "replaces": "cloudvectordb_tpu/ops/pallas_band.py:621",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- kernel against its plain version --------------------------------------
def random_kernel_inputs(seed, dev, *, d=768, tile_n=2048, tile_q=64,
                         n_tiles=6, w=3, nq=128, p=5):
    """Random K1 inputs: monotone per-tile local ids, valid_end holes, a short
    final tile, a repeated table entry, bf16-exact centroid tiles."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile_n
    local = np.zeros(n, np.uint8)
    valid_end = np.zeros((n_tiles, w), np.int32)
    for t in range(n_tiles):
        cuts = np.sort(rng.integers(0, tile_n, size=w - 1))
        local[t * tile_n:(t + 1) * tile_n] = np.searchsorted(
            cuts, np.arange(tile_n), side="right")
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [tile_n]])
        keep = starts + rng.uniform(0.5, 1.0, size=w) * (ends - starts)
        valid_end[t] = t * tile_n + keep.astype(np.int32)
    valid_end[-1] = np.minimum(valid_end[-1], (n_tiles - 1) * tile_n + tile_n // 3)
    table = rng.integers(0, n_tiles, size=(nq // tile_q, p)).astype(np.int32)
    table[:, -1] = table[:, 0]
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(
        db_resid=t(rng.integers(-127, 128, size=(n, d), dtype=np.int8)),
        local_ids=t(local[None, :]),
        centroid_tiles=t(rng.normal(size=(n_tiles, w, d)).astype(np.float32)
                         / np.sqrt(d)).to(torch.bfloat16),
        resid_scale=0.02,
        queries_sorted=t(rng.normal(size=(nq, d)).astype(np.float32) / np.sqrt(d)),
        tile_table=t(table), valid_end=t(valid_end), tile_n=tile_n,
        tile_q=tile_q)


def compare_kernel(name: str, args: dict, k: int, l_buckets: int) -> float:
    """Kernel vs plain version on the same inputs; returns max |Δscore|."""
    v_ref, i_ref = band.tiles_topk_resid_reference(**args, k=k, l_buckets=l_buckets)
    v, i = band.tiles_topk_resid(**args, k=k, l_buckets=l_buckets)
    if v.is_cuda:
        torch.cuda.synchronize()
    v, i, v_ref, i_ref = (a.cpu().numpy() for a in (v, i, v_ref, i_ref))
    live = np.isfinite(v_ref)
    if not np.array_equal(live, np.isfinite(v)):
        raise AssertionError(f"{name}: unfilled slots differ")
    err = float(np.abs(v - v_ref)[live].max(initial=0.0))
    same = i == i_ref
    match = float(same.mean())
    near_tie = np.all(np.abs(v - v_ref)[~same & live] <= SCORE_TOL)
    log(f"[kernel] {name}: ids {match:.5f} equal, max |dscore| {err:.3g}, "
        f"mismatches near-ties: {bool(near_tie)}")
    if match < ID_MATCH_FLOOR or err > SCORE_TOL or not near_tie:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def small_kernel_checks(dev) -> float:
    cases = [
        ("R1_W3_D768", dict(), 0),
        ("R4_W3_D768", dict(), 512),
        ("R1_W1", dict(w=1, d=256), 0),
        ("R1_W129", dict(w=129, d=128), 0),
        ("R4_W129", dict(w=129, d=128), 512),
        ("R8_L32_lt_block", dict(tile_n=256, d=128), 32),
        ("R1_tq16", dict(tile_q=16, nq=64, d=128), 0),
        ("R1_tq48_D100", dict(tile_q=48, nq=96, d=100), 0),
    ]
    err = 0.0
    for seed, (name, shape, l_buckets) in enumerate(cases):
        err = max(err, compare_kernel(name, random_kernel_inputs(seed, dev, **shape),
                                      K, l_buckets))
    return err


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- the serving slice --------------------------------------------------------
def make_corpus(dev, chunk: int):
    """Deterministic chunk_fn on the device: the generating process of
    bench.py (latent 32, 256 centres, noise 0.3/sqrt(32), L2-normalised),
    drawn from torch.Generators."""
    g = torch.Generator(device=dev)
    g.manual_seed(1000)
    w = torch.randn((LATENT, D), generator=g, device=dev) / LATENT ** 0.5
    centers = torch.randn((NCENTERS, LATENT), generator=g, device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)

    def chunk_fn(i: int) -> torch.Tensor:
        gi = torch.Generator(device=dev)
        gi.manual_seed(i)
        a = torch.randint(0, NCENTERS, (chunk,), generator=gi, device=dev)
        z = centers[a] + (0.3 / LATENT ** 0.5) * torch.randn(
            (chunk, LATENT), generator=gi, device=dev)
        x = z @ w
        return x / x.norm(dim=1, keepdim=True)

    return chunk_fn


def queries_and_gt(chunk_fn, n_chunks: int, chunk: int, dev, batch: int):
    g = torch.Generator(device=dev)
    g.manual_seed(7777)
    base = chunk_fn(0)
    sel = torch.randint(0, base.shape[0], (batch,), generator=g, device=dev)
    q = base[sel] + (0.15 / D ** 0.5) * torch.randn((batch, D), generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    nq = min(NQ_GT, batch)
    best_v = torch.full((nq, K), float("-inf"), device=dev)
    best_i = torch.zeros((nq, K), dtype=torch.int64, device=dev)
    for ci in range(n_chunks):
        cv, cidx = tiled_topk(chunk_fn(ci), q[:nq], K, tile=8192)
        best_v, best_i = merge_topk(best_v, best_i, cv, cidx + ci * chunk, K)
    return q, best_i.cpu().numpy()


def run_slice(dev, rows: int = N_ROWS, nlist: int = NLIST, chunk: int = CHUNK,
              batch: int = B, reps: int = 7) -> dict:
    """Build, tune and serve the port's main path; returns its numbers.
    Resets the kernel's launch count just before and reads it just after."""
    n_chunks = rows // chunk
    chunk_fn = make_corpus(dev, chunk)
    t0 = time.perf_counter()
    queries, gt = queries_and_gt(chunk_fn, n_chunks, chunk, dev, batch)
    gt_s = time.perf_counter() - t0

    band.tiles_topk_resid.launches = 0
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(
        chunk_fn, n_chunks, nlist=nlist, kmeans_iters=10, residual=True,
        device=dev)
    if idx.device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[slice] built {idx.ntotal} x {D}, nlist {nlist}: {build_s:.1f} s "
        f"(ground truth {gt_s:.1f} s), W={idx._tile_window.shape[1]}, "
        f"{idx._tune_n_tiles()} tiles, scale {idx._scale:.6g}")

    t0 = time.perf_counter()
    report = idx.tune(queries.cpu().numpy(), k=K, target_recall=0.95, verbose=True)
    tune_s = time.perf_counter() - t0
    log(f"[slice] tuned in {tune_s:.1f} s: op {report['op']}, met {report['met']}, "
        f"self-relative recall {report['recall']:.4f}, tried {len(report['tried'])}")

    v, ids = idx.search_device(queries, K)
    qps = qps_device(lambda q: idx.search_device(q, K), queries, reps=reps) \
        if idx.device.type == "cuda" else None
    launches = band.tiles_topk_resid.launches

    v, ids = v.cpu().numpy(), ids.cpu().numpy()
    if v.shape != (batch, K) or ids.shape != (batch, K):
        raise AssertionError(f"result shapes {v.shape}, {ids.shape}")
    if not np.isfinite(v).all() or ids.min() < 0 or ids.max() >= idx.ntotal:
        raise AssertionError("non-finite scores or ids out of range")
    recall = recall_at_k(ids[: gt.shape[0]], gt)
    log(f"[slice] recall@{K} vs exact f32 ground truth on {gt.shape[0]} queries: "
        f"{recall:.4f}")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall {recall:.4f} < {RECALL_FLOOR}")
    return dict(idx=idx, queries=queries, report=report, build_s=build_s,
                tune_s=tune_s, recall=recall, qps=qps, launches=launches)


def main_path_kernel_check(idx: BandIVFIndex, queries: torch.Tensor) -> dict:
    """K1 at the main path's shape: the tuned op point's tile table over the
    real arena for the whole batch. Kernel vs plain version, and both times."""
    op = idx._op_point or {}
    p_tiles, tq = idx._resolve_knobs(queries.shape[0], 32, 0, op.get("tile_q"))
    st = idx._device_state()
    q_s, _, table = _plan_tiles(queries, st["centroids"], st["tile_window"],
                                   tq, p_tiles)
    args = dict(db_resid=st["payload"], local_ids=st["local"],
                centroid_tiles=st["centroid_tiles"], resid_scale=idx._scale,
                queries_sorted=q_s, tile_table=table, valid_end=st["valid_end"],
                tile_n=idx.tile_n, tile_q=tq)
    name = f"main_path_B{queries.shape[0]}_p{p_tiles}_tq{tq}"
    err = compare_kernel(name, args, K, 0)
    ms = time_ms(lambda: band.tiles_topk_resid(**args, k=K), reps=10)
    plain_ms = time_ms(lambda: band.tiles_topk_resid_reference(**args, k=K), reps=3)
    ops = 2.0 * queries.shape[0] * p_tiles * idx.tile_n * D
    log(f"[kernel] {name}: kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} Tops/s int8), "
        f"plain version {plain_ms:.3f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    from cloudvectordb_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib_path, compiler_out = _cuda.build()
    build_kernel_s = time.perf_counter() - t0
    log(f"[build] {lib_path.name} in {build_kernel_s:.1f} s")
    for line in compiler_out.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")

    err = small_kernel_checks(dev)

    s = run_slice(dev)
    if s["launches"] <= 0:
        raise AssertionError("the main path never launched the kernel")
    qps = s["qps"]
    log(f"[slice] {card}: build {s['build_s']:.1f} s, op {s['report']['op']}, "
        f"recall@{K} {s['recall']:.4f}, device QPS {qps['qps']:.1f} at B={B} "
        f"(median of {qps['reps']}: {qps['ms_median']:.3f} ms; min "
        f"{qps['ms_min']:.3f}, max {qps['ms_max']:.3f}), kernel launches "
        f"{s['launches']}")

    mp = main_path_kernel_check(s["idx"], s["queries"])
    log(f"[kernel] {card}")
    print(json.dumps({"kernels": [{**KERNEL, "launches": s["launches"],
                                   "max_abs_err": max(err, mp["err"]),
                                   "ms": mp["ms"], "plain_ms": mp["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
