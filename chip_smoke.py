#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (cloudvectordb_tpu_torch) on one GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build of every hand-written kernel from csrc/*.cu (one nvcc per source,
   all at once), timed, with ptxas' registers and spills per kernel;
3. k-means determinism: two trainings on the same 262,144 rows (nlist
   4096, 10 iterations) must give bit-identical centroids;
4. each kernel against its plain PyTorch version on the card, on small
   random shapes: K1 (tiles_topk_resid: one slot per bucket and four,
   windows of 1 to 129 lists, valid_end holes, a short final tile, partial
   query blocks), K2 (flat_topk: ip/l2 x f32/bf16/int8, R 1 and 4, ragged
   N), K3 (tiles_topk: int8, hybrid, bf16, f32 scoring, repeated table
   entries, n_valid holes) and K7 (band_topk: clamped bands);
5. the residual serving path: a 12.5M x 768 corpus generated on the device
   (the process of bench.py: latent 32, 256 centres, noise 0.3/sqrt(32),
   L2-normalised), ``BandIVFIndex.build_device_streaming`` with nlist 4096
   and residual int8, ``tune(k=10, target_recall=0.95)``, then batches of
   4096 through ``search_device``; K1's launch count over that run must be
   > 0 and recall@10 against the exact f32 ground truth on 512 queries must
   reach 0.90; device QPS is the median of CUDA-event-timed repetitions;
   then K1 against its plain version at the main path's shape, both timed;
6. the whole-row path on the same corpus, queries and ground truth (the
   residual index freed first): ``build_device_streaming(residual=False)``
   (int8), ``tune``, ``search_device`` with the default hybrid scoring (QPS
   as above), one batch with scoring='int8' and one through
   ``search(strategy='band')``; K3 and K7 must launch and hybrid recall@10
   must reach 0.80; then K3 (at the tuned op point) and K7 (at the band
   plan) against their plain versions, both timed;
7. the flat path: ``FlatIndex`` at BASELINE config #1's shape (1M x 128
   SIFT-like f32 rows: clustered, non-negative, integer-valued, made on the
   device; 10,000 queries; l2; k 10) must reach recall@10 0.99 against the
   exact f32 scan, and at bench.py's int8 flat shape (1M x 768 of the
   corpus, the 4096 queries, ip) its recall is logged; K2 must launch;
   then K2 against its plain version at both shapes, both timed.

Then one JSON line with the four kernels' records, the card's line and, as
the last line, ``{"ok": true, "device": {...}}``.
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
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex, _plan_tiles
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.ops import band, flat_topk as flat
from cloudvectordb_tpu_torch.ops.topk import merge_topk, tiled_topk

D, K, B, LATENT, NCENTERS = 768, 10, 4096, 32, 256
N_ROWS = 12_500_000
CHUNK = 500_000
NLIST = 4096
NQ_GT = 512
RECALL_FLOOR = 0.90
WHOLE_ROW_RECALL_FLOOR = 0.80
FLAT_RECALL_FLOOR = 0.99
SIFT_ROWS, SIFT_D, SIFT_Q = 1_000_000, 128, 10_000
ID_MATCH_FLOOR = 0.999
SCORE_TOL = 1e-4
_SCAN = "cloudvectordb_tpu_torch/csrc/tiles_scan.cu"
KERNELS = {
    "K1": {"name": "tiles_topk_resid", "route": "cuda",
           "source": "cloudvectordb_tpu_torch/csrc/tiles_resid.cu",
           "replaces": "cloudvectordb_tpu/ops/pallas_band.py:621"},
    "K2": {"name": "flat_topk", "route": "cuda", "source": _SCAN,
           "replaces": "cloudvectordb_tpu/ops/pallas_topk.py:117"},
    "K3": {"name": "tiles_topk", "route": "cuda", "source": _SCAN,
           "replaces": "cloudvectordb_tpu/ops/pallas_band.py:257"},
    "K7": {"name": "band_topk", "route": "cuda", "source": _SCAN,
           "replaces": "cloudvectordb_tpu/ops/pallas_band.py:355"},
}
WRAPPERS = {"K1": band.tiles_topk_resid, "K2": flat.flat_topk,
            "K3": band.tiles_topk, "K7": band.band_topk}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def sync() -> None:
    torch.cuda.synchronize()


# -- kernels against their plain versions ----------------------------------
def compare(name: str, kernel, plain) -> float:
    """kernel() against plain(), both returning (values, ids), on the same
    inputs; returns max |Δscore| over the filled slots. The wrapper named
    by the first word of ``name`` must count a launch in kernel() and none
    in plain()."""
    wrapper = WRAPPERS[name.split()[0]]
    before = wrapper.launches
    v_ref, i_ref = plain()
    if wrapper.launches != before:
        raise AssertionError(f"{name}: the plain version launched the kernel")
    v, i = kernel()
    sync()
    if wrapper.launches <= before:
        raise AssertionError(f"{name}: the kernel was not launched")
    v, i, v_ref, i_ref = (a.cpu().numpy() for a in (v, i, v_ref, i_ref))
    live = np.isfinite(v_ref)
    if v.shape != v_ref.shape or not np.array_equal(live, np.isfinite(v)):
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


def random_resid_inputs(seed, dev, *, d=768, tile_n=2048, tile_q=64,
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


def resid_checks(dev) -> float:
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
    for seed, (name, shape, lb) in enumerate(cases):
        a = random_resid_inputs(seed, dev, **shape)
        err = max(err, compare(
            f"K1 {name}", lambda: band.tiles_topk_resid(**a, k=K, l_buckets=lb),
            lambda: band.tiles_topk_resid_reference(**a, k=K, l_buckets=lb)))
    return err


def random_rows(rng, n, d, dtype, dev):
    """Rows of ``dtype`` on the device: random int8 codes, or normal values
    scaled to unit-order norms for bf16/f32."""
    if dtype == torch.int8:
        return torch.as_tensor(rng.integers(-127, 128, size=(n, d), dtype=np.int8), device=dev)
    x = rng.normal(size=(n, d)).astype(np.float32) / np.sqrt(d)
    return torch.as_tensor(x, device=dev).to(dtype)


def flat_checks(dev) -> float:
    """K2 on ragged databases (N not a multiple of tile_n), R 1 and 4."""
    err = 0.0
    cases = [(qt, rt, m) for qt, rt in ((torch.float32, torch.float32),
                                        (torch.bfloat16, torch.bfloat16),
                                        (torch.int8, torch.int8),
                                        (torch.float32, torch.bfloat16))
             for m in ("ip", "l2") if not (rt == torch.int8 and m == "l2")]
    for seed, (qt, rt, metric) in enumerate(cases):
        for lb in (0, 512):
            rng = np.random.default_rng(100 + seed)
            # D = 99 takes the kernel's unaligned int8 staging path
            d = 99 if rt == torch.int8 else (100 if seed % 2 else 128)
            db = random_rows(rng, 3 * 2048 + 777, d, rt, dev)
            q = random_rows(rng, 100, d, qt, dev)
            name = f"K2 {str(qt)[6:]}x{str(rt)[6:]} {metric} L{lb or 2048} D{d}"
            err = max(err, compare(
                name, lambda: flat.flat_topk(db, q, K, metric=metric, l_buckets=lb),
                lambda: flat.flat_topk_reference(db, q, K, metric=metric, l_buckets=lb)))
    return err


def table_checks(dev) -> float:
    """K3 (tile table with repeated entries) and K7 (bands clamped at the
    arena end), every score mode, n_valid below the padded size."""
    modes = [(True, torch.int8, torch.int8), ("hybrid", torch.bfloat16, torch.int8),
             (False, torch.bfloat16, torch.bfloat16), (False, torch.float32, torch.float32)]
    err3 = err7 = 0.0
    for seed, (int8, qt, rt) in enumerate(modes):
        for lb, d, tile_q in ((0, 768, 64), (512, 100, 48)):
            rng = np.random.default_rng(200 + seed)
            n_tiles, tile_n, nq = 6, 2048, 2 * tile_q
            db = random_rows(rng, n_tiles * tile_n, d, rt, dev)
            q = random_rows(rng, nq, d, qt, dev)
            n_valid = n_tiles * tile_n - 1500
            table = rng.integers(0, n_tiles, size=(2, 5)).astype(np.int32)
            table[:, -1] = table[:, 0]
            table = torch.as_tensor(table, device=dev)
            kw = dict(tile_n=tile_n, tile_q=tile_q, l_buckets=lb, int8=int8,
                      n_valid=n_valid)
            tag = f"{int8!r} L{lb or tile_n} D{d} tq{tile_q}"
            err3 = max(err3, compare(
                f"K3 {tag}", lambda: band.tiles_topk(db, q, table, K, **kw),
                lambda: band.tiles_topk_reference(db, q, table, K, **kw)))
            starts = torch.tensor([1, n_tiles - 3], dtype=torch.int32, device=dev)
            err7 = max(err7, compare(
                f"K7 {tag}", lambda: band.band_topk(db, q, starts, K, 3, **kw),
                lambda: band.band_topk_reference(db, q, starts, K, 3, **kw)))
    return err3, err7


def small_kernel_checks(dev) -> dict:
    err = {"K1": resid_checks(dev), "K2": flat_checks(dev)}
    err["K3"], err["K7"] = table_checks(dev)
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


def main_shape_check(key: str, label: str, kernel, plain, reps: int,
                     plain_reps: int) -> dict:
    """A kernel against its plain version at a main path's shape, and both
    times (each the median of CUDA-event repetitions, one process, one
    card)."""
    err = compare(f"{key} {label}", kernel, plain)
    plain_ms = time_ms(plain, plain_reps)
    ms = time_ms(kernel, reps)
    log(f"[kernel] {key} {label}: kernel {ms:.3f} ms, plain version {plain_ms:.3f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms)


# -- k-means ----------------------------------------------------------------
def kmeans_determinism(chunk_fn) -> None:
    x = chunk_fn(0)[:262_144]
    t0 = time.perf_counter()
    c1, a1 = train_kmeans(x, NLIST, iters=10, seed=0)
    c2, a2 = train_kmeans(x, NLIST, iters=10, seed=0)
    sync()
    same = torch.equal(c1, c2) and torch.equal(a1, a2)
    log(f"[kmeans] two trainings on {x.shape[0]} x {D}, nlist {NLIST}, 10 iterations: "
        f"bit-identical centroids {same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("k-means is not deterministic")


# -- the corpus ---------------------------------------------------------------
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


def exact_gt(chunk_fn, n_chunks: int, chunk: int, q: torch.Tensor, metric="ip"):
    best_v = torch.full((q.shape[0], K), float("-inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], K), dtype=torch.int64, device=q.device)
    for ci in range(n_chunks):
        cv, cidx = tiled_topk(chunk_fn(ci), q, K, metric=metric, tile=8192)
        best_v, best_i = merge_topk(best_v, best_i, cv, cidx + ci * chunk, K)
    return best_i.cpu().numpy()


def queries_and_gt(chunk_fn, n_chunks: int, chunk: int, dev, batch: int):
    g = torch.Generator(device=dev)
    g.manual_seed(7777)
    base = chunk_fn(0)
    sel = torch.randint(0, base.shape[0], (batch,), generator=g, device=dev)
    q = base[sel] + (0.15 / D ** 0.5) * torch.randn((batch, D), generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    return q, exact_gt(chunk_fn, n_chunks, chunk, q[:min(NQ_GT, batch)])


def check_result(v, ids, batch: int, ntotal: int, label: str) -> None:
    v, ids = np.asarray(v), np.asarray(ids)
    if v.shape != (batch, K) or ids.shape != (batch, K):
        raise AssertionError(f"{label}: result shapes {v.shape}, {ids.shape}")
    if not np.isfinite(v).all() or ids.min() < 0 or ids.max() >= ntotal:
        raise AssertionError(f"{label}: non-finite scores or ids out of range")


def build_and_tune(dev, chunk_fn, n_chunks, queries, residual: bool):
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(
        chunk_fn, n_chunks, nlist=NLIST, kmeans_iters=10, residual=residual,
        device=dev)
    sync()
    build_s = time.perf_counter() - t0
    log(f"[{'resid' if residual else 'whole'}] built {idx.ntotal} x {D}, nlist {NLIST}: "
        f"{build_s:.1f} s, W={idx._tile_window.shape[1]}, {idx._tune_n_tiles()} tiles, "
        f"scale {idx._scale:.6g}")
    t0 = time.perf_counter()
    report = idx.tune(queries.cpu().numpy(), k=K, target_recall=0.95, verbose=True)
    tune_s = time.perf_counter() - t0
    log(f"[{'resid' if residual else 'whole'}] tuned in {tune_s:.1f} s: op {report['op']}, "
        f"met {report['met']}, self-relative recall {report['recall']:.4f}, "
        f"tried {len(report['tried'])}")
    return idx, report, build_s


def serve(idx, queries, gt, reps: int, label: str, **kw) -> tuple[float, dict]:
    """search_device on the batch: recall@10 against gt and device QPS."""
    v, ids = idx.search_device(queries, K, **kw)
    qps = qps_device(lambda q: idx.search_device(q, K, **kw), queries, reps=reps)
    v, ids = v.cpu().numpy(), ids.cpu().numpy()
    check_result(v, ids, queries.shape[0], idx.ntotal, label)
    recall = recall_at_k(ids[: gt.shape[0]], gt)
    log(f"[{label}] recall@{K} vs exact f32 ground truth on {gt.shape[0]} queries: "
        f"{recall:.4f}; device QPS {qps['qps']:.1f} at B={queries.shape[0]} (median of "
        f"{qps['reps']}: {qps['ms_median']:.3f} ms; min {qps['ms_min']:.3f}, "
        f"max {qps['ms_max']:.3f})")
    return recall, qps


# -- the residual serving path ------------------------------------------------
def run_residual(dev, chunk_fn, n_chunks, queries, gt, card, reps: int = 7) -> dict:
    """Build, tune and serve the residual path; K1's launch count is reset
    just before and read just after. Then K1 at the main path's shape."""
    reset_launches()
    idx, report, build_s = build_and_tune(dev, chunk_fn, n_chunks, queries, True)
    recall, qps = serve(idx, queries, gt, reps, "resid")
    launches = band.tiles_topk_resid.launches
    log(f"[resid] {card}: build {build_s:.1f} s, op {report['op']}, recall@{K} "
        f"{recall:.4f}, device QPS {qps['qps']:.1f}, K1 launches {launches}")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"residual recall {recall:.4f} < {RECALL_FLOOR}")

    op = idx._op_point or {}
    p_tiles, tq = idx._resolve_knobs(queries.shape[0], 32, 0, op.get("tile_q"))
    st = idx._device_state()
    q_s, _, table = _plan_tiles(queries, st["centroids"], st["tile_window"], tq, p_tiles)
    args = dict(db_resid=st["payload"], local_ids=st["local"],
                centroid_tiles=st["centroid_tiles"], resid_scale=idx._scale,
                queries_sorted=q_s, tile_table=table, valid_end=st["valid_end"],
                tile_n=idx.tile_n, tile_q=tq)
    mp = main_shape_check(
        "K1", f"main path B{queries.shape[0]} p{p_tiles} tq{tq}",
        lambda: band.tiles_topk_resid(**args, k=K),
        lambda: band.tiles_topk_resid_reference(**args, k=K), reps=10, plain_reps=3)
    ops = 2.0 * queries.shape[0] * p_tiles * idx.tile_n * D
    log(f"[kernel] K1: {ops / mp['ms'] / 1e9:.1f} T int8 ops/s")
    return dict(launches={"K1": launches}, mp={"K1": mp})


# -- the whole-row path ---------------------------------------------------------
def run_whole_row(dev, chunk_fn, n_chunks, queries, gt, card, reps: int = 7) -> dict:
    """Whole-row int8 arena on the same corpus: tiles search with hybrid and
    int8 scoring, and the band strategy; K3's and K7's launch counts are
    reset just before and read just after. Then K3 and K7 at their main
    path shapes."""
    reset_launches()
    idx, report, build_s = build_and_tune(dev, chunk_fn, n_chunks, queries, False)
    recall, qps = serve(idx, queries, gt, reps, "whole")
    _, ids8 = idx.search_device(queries, K, scoring="int8")
    ids8 = ids8.cpu().numpy()
    check_result(np.zeros(ids8.shape), ids8, queries.shape[0], idx.ntotal, "whole int8")
    recall8 = recall_at_k(ids8[: gt.shape[0]], gt)
    t0 = time.perf_counter()
    vb, idsb = idx.search(queries.cpu().numpy(), K, strategy="band")
    band_s = time.perf_counter() - t0
    check_result(vb, idsb, queries.shape[0], idx.ntotal, "whole band")
    recall_band = recall_at_k(idsb[: gt.shape[0]], gt)
    launches = {"K3": band.tiles_topk.launches, "K7": band.band_topk.launches}
    log(f"[whole] {card}: build {build_s:.1f} s, op {report['op']}, recall@{K} hybrid "
        f"{recall:.4f}, int8 {recall8:.4f}, band {recall_band:.4f} (band search "
        f"{band_s:.2f} s host clock), device QPS {qps['qps']:.1f}, launches {launches}")
    if recall < WHOLE_ROW_RECALL_FLOOR:
        raise AssertionError(f"whole-row hybrid recall {recall:.4f} < "
                             f"{WHOLE_ROW_RECALL_FLOOR}")

    op = idx._op_point or {}
    p_tiles, tq = idx._resolve_knobs(queries.shape[0], 32, 0, op.get("tile_q"))
    st = idx._device_state()
    q_s, _, table = _plan_tiles(queries, st["centroids"], st["tile_window"], tq, p_tiles)
    q_bf = q_s.to(torch.bfloat16)
    kw3 = dict(tile_n=idx.tile_n, tile_q=tq, int8="hybrid", n_valid=idx._n)
    mp = {"K3": main_shape_check(
        "K3", f"hybrid main path B{queries.shape[0]} p{p_tiles} tq{tq}",
        lambda: band.tiles_topk(st["payload"], q_bf, table, K, **kw3),
        lambda: band.tiles_topk_reference(st["payload"], q_bf, table, K, **kw3),
        reps=5, plain_reps=3)}
    ops = 2.0 * queries.shape[0] * p_tiles * idx.tile_n * D
    log(f"[kernel] K3: {ops / mp['K3']['ms'] / 1e9:.1f} T f32 FMA-ops/s")
    _, q8, _, starts, band_tiles = idx._plan_band(queries.cpu().numpy(), 32)
    kw7 = dict(tile_n=idx.tile_n, tile_q=idx.tile_q, int8=True, n_valid=idx._n)
    mp["K7"] = main_shape_check(
        "K7", f"int8 band plan B{queries.shape[0]} band_tiles {band_tiles} "
              f"of {idx._tune_n_tiles()}",
        lambda: band.band_topk(st["payload"], q8, starts, K, band_tiles, **kw7),
        lambda: band.band_topk_reference(st["payload"], q8, starts, K, band_tiles, **kw7),
        reps=2, plain_reps=1)
    return dict(launches=launches, mp=mp)


# -- the flat path ------------------------------------------------------------
def sift_like(dev, n: int, d: int, seed: int) -> torch.Tensor:
    """SIFT-shaped rows on the device: clustered, non-negative and
    integer-valued (1,000 centres, clipped to [0, 255])."""
    g = torch.Generator(device=dev)
    g.manual_seed(2024)
    centers = torch.rand((1000, d), generator=g, device=dev) * 80.0
    gi = torch.Generator(device=dev)
    gi.manual_seed(seed)
    a = torch.randint(0, 1000, (n,), generator=gi, device=dev)
    x = centers[a] + 15.0 * torch.randn((n, d), generator=gi, device=dev)
    return torch.clamp(torch.round(x), 0.0, 255.0)


def run_flat(dev, chunk_fn, queries, card) -> dict:
    """FlatIndex at BASELINE config #1's shape (l2, f32) and at bench.py's
    int8 flat shape; K2's launch count is reset just before and read just
    after. Then K2 at both shapes against its plain version."""
    x = sift_like(dev, SIFT_ROWS, SIFT_D, seed=1)
    qs = sift_like(dev, SIFT_Q, SIFT_D, seed=2)
    t0 = time.perf_counter()
    _, gt_sift = tiled_topk(x, qs, K, metric="l2", tile=8192)
    gt_sift = gt_sift.cpu().numpy()
    gt_s = time.perf_counter() - t0
    x8 = torch.cat([chunk_fn(0), chunk_fn(1)])
    gt8 = exact_gt(lambda i: x8, 1, 0, queries[:NQ_GT])

    reset_launches()
    sift = FlatIndex.build(x, metric="l2", dtype="float32", device=dev)
    t0 = time.perf_counter()
    v, ids = sift.search(qs.cpu().numpy(), K)
    sift_s = time.perf_counter() - t0
    check_result(v, ids, SIFT_Q, sift.ntotal, "flat sift")
    recall_sift = recall_at_k(ids, gt_sift)
    flat8 = FlatIndex.build(x8, metric="ip", dtype="int8", device=dev)
    t0 = time.perf_counter()
    v8, ids8 = flat8.search(queries.cpu().numpy(), K)
    flat8_s = time.perf_counter() - t0
    check_result(v8, ids8, queries.shape[0], flat8.ntotal, "flat int8")
    recall8 = recall_at_k(ids8[:NQ_GT], gt8)
    launches = {"K2": flat.flat_topk.launches}
    log(f"[flat] {card}: SIFT-like {SIFT_ROWS} x {SIFT_D} f32 l2, {SIFT_Q} queries: "
        f"recall@{K} {recall_sift:.4f} vs exact f32 (ground truth {gt_s:.1f} s), search "
        f"{sift_s:.3f} s host clock; int8 {x8.shape[0]} x {D} ip, B {queries.shape[0]}: "
        f"recall@{K} {recall8:.4f} on {NQ_GT} queries, search {flat8_s:.3f} s host "
        f"clock; launches {launches}")
    if recall_sift < FLAT_RECALL_FLOOR:
        raise AssertionError(f"flat recall {recall_sift:.4f} < {FLAT_RECALL_FLOOR}")

    mp = {"K2": main_shape_check(
        "K2", f"f32 l2 {SIFT_ROWS}x{SIFT_D} Q{SIFT_Q}",
        lambda: flat.flat_topk(sift._vecs, qs, K, metric="l2", db_sqnorms=sift._sqnorms),
        lambda: flat.flat_topk_reference(sift._vecs, qs, K, metric="l2",
                                         db_sqnorms=sift._sqnorms),
        reps=5, plain_reps=3)}
    q8, _ = flat.quantize_queries(queries)
    mp["K2 int8"] = main_shape_check(
        "K2", f"int8 ip {x8.shape[0]}x{D} Q{queries.shape[0]}",
        lambda: flat.flat_topk(flat8._vecs, q8, K),
        lambda: flat.flat_topk_reference(flat8._vecs, q8, K), reps=3, plain_reps=2)
    return dict(launches=launches, mp=mp)


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
    built = _cuda.build()
    log(f"[build] {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for name, (_, out) in built.items():
        for line in out.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    chunk_fn = make_corpus(dev, CHUNK)
    kmeans_determinism(chunk_fn)
    err = small_kernel_checks(dev)

    n_chunks = N_ROWS // CHUNK
    t0 = time.perf_counter()
    queries, gt = queries_and_gt(chunk_fn, n_chunks, CHUNK, dev, B)
    log(f"[gt] exact f32 top-{K} of {gt.shape[0]} queries over {N_ROWS} rows: "
        f"{time.perf_counter() - t0:.1f} s")
    runs = [run_residual(dev, chunk_fn, n_chunks, queries, gt, card)]
    torch.cuda.empty_cache()  # the residual index is gone: one arena at a time
    runs.append(run_whole_row(dev, chunk_fn, n_chunks, queries, gt, card))
    torch.cuda.empty_cache()
    runs.append(run_flat(dev, chunk_fn, queries, card))

    launches = {k: v for r in runs for k, v in r["launches"].items()}
    mp = {k: v for r in runs for k, v in r["mp"].items()}
    for key in KERNELS:
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"{key} ({KERNELS[key]['name']}) never launched on its path")
    records = []
    for key, meta in KERNELS.items():
        errs = [err[key]] + [m["err"] for k, m in mp.items() if k.split()[0] == key]
        records.append({**meta, "launches": launches[key], "max_abs_err": max(errs),
                        "ms": mp[key]["ms"], "plain_ms": mp[key]["plain_ms"]})
    print(json.dumps({"kernels": records}))
    log(f"[kernel] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
