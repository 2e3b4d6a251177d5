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
   then K2 against its plain version at both shapes, both timed;
8. K4 (mha_small_head) against its plain version, forward outputs and dq,
   dk, dv: L 128, 256 and 512, (H, d) (12, 32) and (12, 64), f32 and bf16,
   ragged key padding and a fully masked sequence; each check must count
   one forward and one backward launch;
9. training: ``Trainer.fit`` on minilm-l6-384 at full width (bf16, max_len
   128, no probs dropout, 'auto'), 20 steps of 512 learnable triplets made
   on the device; finite losses, K4 forward and backward launched once per
   layer and step; from the checkpoint fit wrote, one step through 'auto'
   (K4) against one through 'naive' (dropout 0): loss within 1e-2 and grad
   norm within 1% relative; ms/step of 'auto', 'naive' and 'fused' (SDPA),
   and a torch.profiler split of one step;
10. encoding and search: 1,000,000 passages of device-made token ids
   (lengths 16-128, padded to 128) through 'packed' (K4, launches counted)
   in batches of 1024 into ``FlatIndex(384)``; passages/s, also for
   'naive' and 'fused'; mean cosine 'packed' vs 'naive' on 4096 passages
   >= 0.999; ``encode_corpus_streaming`` on 16,384 of them (a stand-in
   tokenizer) must give the bulk embeddings; 10,000 short queries (first
   <= 32 tokens, 15% resampled) through 'auto' (packed_batch) and
   ``FlatIndex.search`` (K2) must reach recall@10 0.99 against the exact
   scan;
11. K4 at the main path's shapes (bf16, B 1536 forward and backward, B 1024
   forward) against its plain version, timed beside torch's
   scaled_dot_product_attention.

Then one JSON line with every kernel's record (times, bound, library
time), the card's line and, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cloudvectordb_tpu_torch.eval.qps import qps_device
from cloudvectordb_tpu_torch.eval.recall import recall_at_k
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex, _plan_tiles
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.models.embed import encode_corpus_streaming, make_encode_fn
from cloudvectordb_tpu_torch.models.encoder import Encoder
from cloudvectordb_tpu_torch.models.presets import get_preset
from cloudvectordb_tpu_torch.ops import attn, band, flat_topk as flat
from cloudvectordb_tpu_torch.ops.topk import merge_topk, tiled_topk
from cloudvectordb_tpu_torch.train.trainer import Trainer
from cloudvectordb_tpu_torch.utils.checkpoint import restore_checkpoint
from cloudvectordb_tpu_torch.utils.config import TrainConfig
from cloudvectordb_tpu_torch.utils.metrics import MetricsWriter

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
_ATTN = {"route": "cuda", "source": "cloudvectordb_tpu_torch/csrc/mha_small_head.cu",
         "replaces": "cloudvectordb_tpu/ops/pallas_attn.py:109"}
KERNELS["K4"] = {"name": "mha_small_head", **_ATTN}
KERNELS["K4 bwd"] = {"name": "mha_small_head_bwd", **_ATTN}
WRAPPERS = {"K1": band.tiles_topk_resid, "K2": flat.flat_topk,
            "K3": band.tiles_topk, "K7": band.band_topk}
#: the least time the card could take (NVIDIA's H100 SXM data sheet, dense
#: rates): bytes over the memory rate against
#: operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_MANGLED = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}


def ptxas_report(out: str) -> list[str]:
    """One line per kernel instance from ``nvcc -Xptxas -v``: its name and
    template arguments (read from the mangled symbol; "rep" repeats an
    earlier type), registers and spills."""
    rows, name, spill = [], "?", ""
    for line in out.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            sym = entry.group(1)
            name = (re.findall(r"[a-z_]+_kernel", sym) or [sym])[0]
            args = re.search(re.escape(name) + r"I(\w+?)EEv", sym)
            if args:
                tokens = re.findall(r"Li(\d+)E|(13__nv_bfloat16|S\d*_|[a-z])", args.group(1))
                name += "<" + ",".join(n or _MANGLED.get(t, "rep") for n, t in tokens) + ">"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append(f"{name}: {regs} registers; {spill}")
    return rows


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    attn.mha_small_head.launches = attn.mha_small_head.bwd_launches = 0


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by for moving ``n_bytes`` (each input read once,
    each output written once) and doing ``ops`` operations of ``kind``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def table_work(table: torch.Tensor, tile_q: int, tile_n: int, d: int) -> tuple[int, int]:
    """(distinct arena tiles a tile table reads, multiply-adds it needs):
    each query tile scores tile_q queries against the distinct tiles of its
    row (a repeated entry adds no work)."""
    t = table.cpu().numpy()
    per_row = sum(len(np.unique(r)) for r in t)
    return len(np.unique(t)), per_row * tile_q * tile_n * d


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


# -- K4: attention against its plain version ---------------------------------
#: K4 against its plain version: max |kernel - plain| over each of o, dq, dk,
#: dv must stay within tol x max |plain| (f32: max(1, max |plain|)). f32: both
#: sum the same f32 products in different orders. bf16: both round an f32
#: result to bf16, which can differ by one bf16 step (2^-7 of the value).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}


def attn_inputs(seed, dev, b, length, heads, d, dtype):
    """Random K4 operands on the device: normal q, k, v and do; key masks
    with ragged padding, and the last sequence fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(b, length, heads * d)).astype(np.float32),
                                   device=dev).to(dtype) for _ in range(4))
    mask = np.ones((b, length), np.int32)
    for i in range(b - 1):
        mask[i, rng.integers(1, length + 1):] = 0
    mask[-1] = 0
    return q, k, v, torch.as_tensor(mask, device=dev), do


def attn_run(fn, q, k, v, mask, do, heads: int, d: int):
    """(o, dq, dk, dv) of fn, forward and backward through autograd."""
    ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fn(*ts, mask, heads, d, d ** -0.5)
    return (out.detach(), *torch.autograd.grad(out, ts, do))


def attn_compare(name: str, q, k, v, mask, do, heads: int, d: int) -> float:
    """K4's forward and backward against the plain version on the same
    inputs; each must count one launch, the plain version none. Returns the
    largest |kernel - plain| over o, dq, dk and dv."""
    fn = attn.mha_small_head
    before = (fn.launches, fn.bwd_launches)
    ref = attn_run(attn.mha_small_head_reference, q, k, v, mask, do, heads, d)
    if (fn.launches, fn.bwd_launches) != before:
        raise AssertionError(f"{name}: the plain version launched the kernel")
    got = attn_run(fn, q, k, v, mask, do, heads, d)
    sync()
    if (fn.launches, fn.bwd_launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"{name}: the kernels were not launched once each")
    tol, worst, parts = ATTN_TOL[q.dtype], 0.0, []
    for label, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
        a, r = a.float(), r.float()
        top = float(r.abs().max())
        bound = tol * (top if q.dtype == torch.bfloat16 else max(1.0, top))
        err = float((a - r).abs().max())
        parts.append(f"{label} {err:.3g} (bound {bound:.3g})")
        if not bool(torch.isfinite(a).all()) or err > bound:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain version "
                                 f"({err:.3g} > {bound:.3g})")
        worst = max(worst, err)
    log(f"[kernel] {name}: max |kernel - plain| {', '.join(parts)}")
    return worst


def attn_checks(dev) -> float:
    """K4 at every shape the slice uses: L 128, 256, 512; (H, d) (12, 32)
    and (12, 64); f32 and bf16; ragged padding and a fully masked row."""
    err, seed = 0.0, 300
    for length in (128, 256, 512):
        for heads, d in ((12, 32), (12, 64)):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                args = attn_inputs(seed, dev, 3, length, heads, d, dtype)
                err = max(err, attn_compare(
                    f"K4 L{length} H{heads} d{d} {str(dtype)[6:]}", *args, heads, d))
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
    used, macs = table_work(table, tq, idx.tile_n, D)
    w = st["centroid_tiles"].shape[1]  # per tile: rows, local ids, centroids, valid_end
    mp.update(bound(used * (idx.tile_n * (D + 1) + w * (2 * D + 4))
                    + nbytes(q_s, table) + queries.shape[0] * K * 8, 2.0 * macs, "int8"))
    log(f"[kernel] K1 bound: {mp['bound_ms']:.3f} ms ({mp['bound_by']}): {used} of "
        f"{idx._tune_n_tiles()} tiles read")
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
    used, macs = table_work(table, tq, idx.tile_n, D)
    mp["K3"].update(bound(used * idx.tile_n * D + nbytes(q_bf, table)
                          + queries.shape[0] * K * 8, 2.0 * macs, "bf16"))
    log(f"[kernel] K3 bound: {mp['K3']['bound_ms']:.3f} ms ({mp['K3']['bound_by']}): "
        f"{used} of {idx._tune_n_tiles()} tiles read")
    _, q8, _, starts, band_tiles = idx._plan_band(queries.cpu().numpy(), 32)
    kw7 = dict(tile_n=idx.tile_n, tile_q=idx.tile_q, int8=True, n_valid=idx._n)
    mp["K7"] = main_shape_check(
        "K7", f"int8 band plan B{queries.shape[0]} band_tiles {band_tiles} "
              f"of {idx._tune_n_tiles()}",
        lambda: band.band_topk(st["payload"], q8, starts, K, band_tiles, **kw7),
        lambda: band.band_topk_reference(st["payload"], q8, starts, K, band_tiles, **kw7),
        reps=2, plain_reps=1)
    n_tiles = st["payload"].shape[0] // idx.tile_n
    spans = [(s0, min(s0 + band_tiles, n_tiles)) for s0 in starts.cpu().tolist()]
    used = len(set().union(*(range(a, b) for a, b in spans)))
    macs = sum(b - a for a, b in spans) * idx.tile_q * idx.tile_n * D
    mp["K7"].update(bound(used * idx.tile_n * D + nbytes(q8, starts)
                          + queries.shape[0] * K * 8, 2.0 * macs, "int8"))
    log(f"[kernel] K7 bound: {mp['K7']['bound_ms']:.3f} ms ({mp['K7']['bound_by']}): "
        f"{used} of {n_tiles} tiles read")
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
    mp["K2"].update(bound(nbytes(sift._vecs, sift._sqnorms, qs) + SIFT_Q * K * 8,
                          2.0 * SIFT_Q * SIFT_ROWS * SIFT_D, "f32"))
    q8, _ = flat.quantize_queries(queries)
    mp["K2 int8"] = main_shape_check(
        "K2", f"int8 ip {x8.shape[0]}x{D} Q{queries.shape[0]}",
        lambda: flat.flat_topk(flat8._vecs, q8, K),
        lambda: flat.flat_topk_reference(flat8._vecs, q8, K), reps=3, plain_reps=2)
    mp["K2 int8"].update(bound(nbytes(flat8._vecs, q8) + q8.shape[0] * K * 8,
                               2.0 * q8.shape[0] * x8.shape[0] * D, "int8"))
    log(f"[kernel] K2 bounds: f32 l2 {mp['K2']['bound_ms']:.3f} ms ({mp['K2']['bound_by']}), "
        f"int8 ip {mp['K2 int8']['bound_ms']:.3f} ms ({mp['K2 int8']['bound_by']})")
    return dict(launches=launches, mp=mp)


# -- the encoder path: training, encoding, search --------------------------------
ENC_PRESET = "minilm-l6-384"
ENC_LEN, QUERY_LEN = 128, 32
TRIPLETS, TRAIN_STEPS = 512, 20  # bench_encode.py:68: 3 x 512 sequences a step
TOPICS, TOPIC_SPAN = 1000, 8  # the learnable batches' topic tokens, and how many lead
ENC_BATCH = 1024  # PipelineConfig.encode_batch
N_PASSAGES, N_STREAM, N_QUERIES, N_COSINE = 1_000_000, 16_384, 10_000, 4096
QUERY_RECALL_FLOOR, COSINE_FLOOR = 0.99, 0.999
AUTO_NAIVE_LOSS_RTOL, AUTO_NAIVE_GNORM_RTOL = 1e-2, 1e-2


def encoder_config(impl: str = "auto", dropout: float = 0.1):
    """minilm-l6-384 at full width, max_len 128, bf16 activations, no
    attention-probs dropout (so 'auto' takes K4 in training)."""
    return dataclasses.replace(get_preset(ENC_PRESET), max_len=ENC_LEN, dtype="bfloat16",
                               attn_dropout=0.0, attn_impl=impl, dropout=dropout)


def with_impl(model: Encoder, impl: str, dev) -> Encoder:
    """The same weights under another attention implementation."""
    other = Encoder(dataclasses.replace(model.cfg, attn_impl=impl))
    other.load_state_dict(model.state_dict())
    return other.to(dev)


def ragged_mask(g, n: int, length: int, lo: int, dev) -> torch.Tensor:
    """(n, length) int32 masks with live lengths uniform in [lo, length]."""
    lens = torch.randint(lo, length + 1, (n, 1), generator=g, device=dev)
    return (torch.arange(length, device=dev)[None, :] < lens).to(torch.int32)


def topic_batch(g, vocab: int, dev) -> dict:
    """Learnable triplets made on the device (tests/distributed/
    test_train_dp.py's structure): the positive keeps the anchor's topic
    token, the negative carries another; the topic token fills the first
    TOPIC_SPAN positions, so that it survives mean pooling over up to 128
    tokens; lengths 16-128."""
    topic = torch.randint(1, TOPICS + 1, (TRIPLETS,), generator=g, device=dev)
    legs = {}
    for leg, lead in (("anchor", topic), ("pos", topic), ("neg", topic % TOPICS + 1)):
        ids = torch.randint(TOPICS + 1, vocab, (TRIPLETS, ENC_LEN), generator=g, device=dev)
        ids[:, :TOPIC_SPAN] = lead[:, None]
        mask = ragged_mask(g, TRIPLETS, ENC_LEN, 16, dev)
        legs[f"{leg}_ids"], legs[f"{leg}_mask"] = (ids * mask).to(torch.int32), mask
    return legs


def step_ms(trainer: Trainer, state, batches, reps: int) -> float:
    """Median host-clock time of one synchronised training step."""
    times = []
    for i in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        state, m = trainer.step_fn(state, batches[i % len(batches)])
        float(m["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def device_profile(fn, label: str, top: int = 8) -> dict:
    """torch.profiler over one call of fn: the card's time by kernel, summed
    into K4, GEMMs, the optimizer's multi-tensor kernels and the rest
    (elementwise and reductions: LayerNorm, gelu, casts, dropout, losses)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    time_of = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    total = sum(time_of(e) for e in kernels) or 1.0
    groups = {"K4": ("mha_",), "GEMM": ("gemm", "nvjet", "xmma", "cutlass", "sm90_"),
              "optimizer": ("multi_tensor",)}
    share = {name: 0.0 for name in (*groups, "other")}
    for e in kernels:
        name = next((g for g, keys in groups.items()
                     if any(k in e.key.lower() for k in keys)), "other")
        share[name] += time_of(e)
    log(f"[profile] {label}: {total / 1e3:.3f} ms of kernel time; "
        + ", ".join(f"{k} {v / total:.1%}" for k, v in share.items()))
    for e in sorted(kernels, key=time_of, reverse=True)[:top]:
        log(f"[profile]   {time_of(e) / 1e3:8.3f} ms x{e.count:<4} {e.key[:110]}")
    return {k: v / total for k, v in share.items()}


def run_training(dev, card) -> dict:
    """Trainer.fit on learnable triplets through 'auto' (K4 forward and
    backward, counted: 6 each per step); then, from the checkpoint fit
    wrote, one step through 'auto' against one through 'naive' (dropout
    0), and ms/step of 'auto', 'naive' and 'fused'."""
    enc = encoder_config()
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    batches = [topic_batch(g, enc.vocab_size, dev) for _ in range(TRAIN_STEPS)]
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(encoder=enc, batch_size=TRIPLETS, lr=5e-4, warmup_steps=4,
                          total_steps=TRAIN_STEPS, ckpt_every=10**9, log_every=1,
                          ckpt_dir=ckpt, keep_last=1)
        metrics = Path(ckpt) / "metrics.jsonl"
        with MetricsWriter(metrics) as mw:
            trainer = Trainer(cfg, device=dev, metrics=mw)
            reset_launches()
            t0 = time.perf_counter()
            state = trainer.fit(iter(batches), resume=False)
            sync()
            fit_s = time.perf_counter() - t0
        losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
        launches = (attn.mha_small_head.launches, attn.mha_small_head.bwd_launches)
        like = trainer.state_arrays(state)
        arrays, _, _ = restore_checkpoint(ckpt, like)
    log(f"[train] {card}: {ENC_PRESET} bf16, {TRIPLETS} triplets x 3 x {ENC_LEN}, "
        f"{TRAIN_STEPS} steps of Trainer.fit in {fit_s:.2f} s (checkpoint included): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; K4 launches forward {launches[0]}, "
        f"backward {launches[1]}")
    if not np.all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"training losses not finite: {losses}")
    per_step = enc.num_layers * TRAIN_STEPS
    if launches != (per_step, per_step):
        raise AssertionError(f"K4 launches {launches}: expected {enc.num_layers} per step each")

    def restored(impl: str, dropout: float = 0.0):
        c = dataclasses.replace(cfg, encoder=encoder_config(impl, dropout))
        tr = Trainer(c, device=dev)
        return tr, tr.load_state_arrays(tr.init_state(), arrays)

    got = {}
    for impl in ("auto", "naive"):
        tr, st = restored(impl)
        _, m = tr.step_fn(st, batches[0])
        got[impl] = {k: float(v) for k, v in m.items()}
    dl = abs(got["auto"]["loss"] - got["naive"]["loss"]) / abs(got["naive"]["loss"])
    dg = abs(got["auto"]["grad_norm"] / got["naive"]["grad_norm"] - 1.0)
    log(f"[train] one step from the saved state, dropout 0: auto (K4) {got['auto']} vs "
        f"naive {got['naive']}: loss rel diff {dl:.3g}, grad norm rel diff {dg:.3g}")
    if dl > AUTO_NAIVE_LOSS_RTOL or dg > AUTO_NAIVE_GNORM_RTOL:
        raise AssertionError("the K4 training step disagrees with the naive one")

    ms = {}
    for impl in ("auto", "naive", "fused"):
        tr, st = restored(impl, dropout=0.1)
        ms[impl] = step_ms(tr, st, batches[:4], reps=5)
        log(f"[train] {impl}: {ms[impl]:.3f} ms/step, {TRIPLETS / ms[impl] * 1e3:,.1f} "
            f"triplets/s (median of 5 synchronised steps, host clock)")
        if impl == "auto":
            device_profile(lambda: tr.step_fn(st, batches[0]), "one 'auto' training step")
        del tr, st
        torch.cuda.empty_cache()
    return dict(model=state.model, launches=launches, ms=ms, losses=losses)


def make_passages(dev, n: int, length: int):
    """(n, length) int32 token ids over the whole vocabulary and their
    masks, lengths 16-length, ids 0 past the end; made on the device."""
    g = torch.Generator(device=dev)
    g.manual_seed(4242)
    mask = ragged_mask(g, n, length, 16, dev)
    ids = torch.randint(1, get_preset(ENC_PRESET).vocab_size, (n, length), generator=g,
                        device=dev)
    return (ids * mask).to(torch.int32), mask


class IdTokenizer:
    """A stand-in tokenizer: space-separated integer ids -> (ids, mask)
    numpy batches, as data/tokenize.py::TextTokenizer.encode_batch returns
    them."""

    def __init__(self, max_len: int):
        self.max_len = max_len

    def encode_batch(self, texts, max_len=None):
        max_len = max_len or self.max_len
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for r, t in enumerate(texts):
            tok = [int(w) for w in t.split()][:max_len]
            ids[r, :len(tok)] = tok
            mask[r, :len(tok)] = 1
        return ids, mask


def encode_all(encode, ids, mask, consume=None) -> float:
    """Encode rows in batches of ENC_BATCH (to ``consume``); host seconds,
    synchronised."""
    sync()
    t0 = time.perf_counter()
    for s in range(0, ids.shape[0], ENC_BATCH):
        emb = encode(ids[s:s + ENC_BATCH], mask[s:s + ENC_BATCH])
        if consume is not None:
            consume(emb)
    sync()
    return time.perf_counter() - t0


def run_encode_search(dev, model: Encoder, card) -> dict:
    """The trained encoder fills FlatIndex(384) with N_PASSAGES passages
    through 'packed' (K4 forward, counted), then serves short queries
    ('auto' -> packed_batch) through K2, held to the exact scan."""
    ids, mask = make_passages(dev, N_PASSAGES, ENC_LEN)
    packed = with_impl(model, "packed", dev)
    index = FlatIndex(model.embed_dim, device=dev)
    reset_launches()
    enc_s = encode_all(make_encode_fn(packed, device=dev), ids, mask, index.add)
    launches = attn.mha_small_head.launches
    n_batches = -(-N_PASSAGES // ENC_BATCH)
    log(f"[encode] {card}: {N_PASSAGES:,} passages (lengths 16-{ENC_LEN}, padded to "
        f"{ENC_LEN}) through 'packed' into FlatIndex({model.embed_dim}): {enc_s:.2f} s, "
        f"{N_PASSAGES / enc_s:,.1f} passages/s; K4 forward launches {launches}")
    if index.ntotal != N_PASSAGES or launches != model.cfg.num_layers * n_batches:
        raise AssertionError(f"encode: {index.ntotal} rows, {launches} K4 launches")
    if not bool(torch.isfinite(index._vecs).all()):
        raise AssertionError("encode: non-finite embeddings")

    rates = {"packed": N_PASSAGES / enc_s}
    for impl in ("naive", "fused"):
        enc = make_encode_fn(with_impl(model, impl, dev), device=dev)
        encode_all(enc, ids[:ENC_BATCH], mask[:ENC_BATCH])  # warm-up
        secs = encode_all(enc, ids[:8 * ENC_BATCH], mask[:8 * ENC_BATCH])
        rates[impl] = 8 * ENC_BATCH / secs
        log(f"[encode] {impl}: {rates[impl]:,.1f} passages/s (8 batches of {ENC_BATCH})")
    device_profile(lambda: make_encode_fn(packed, device=dev)(ids[:ENC_BATCH], mask[:ENC_BATCH]),
                   f"one 'packed' encode batch of {ENC_BATCH}")

    naive = make_encode_fn(with_impl(model, "naive", dev), device=dev)
    e_naive = torch.cat([naive(ids[s:s + ENC_BATCH], mask[s:s + ENC_BATCH])
                         for s in range(0, N_COSINE, ENC_BATCH)])
    cos = float((e_naive * index._vecs[:N_COSINE]).sum(dim=1).mean())
    log(f"[encode] mean cosine 'packed' vs 'naive' on {N_COSINE} passages: {cos:.6f}")
    if cos < COSINE_FLOOR:
        raise AssertionError(f"packed vs naive mean cosine {cos:.6f} < {COSINE_FLOOR}")

    lens = mask[:N_STREAM].sum(dim=1).cpu().tolist()
    texts = [" ".join(map(str, row[:n])) for row, n in zip(ids[:N_STREAM].cpu().tolist(), lens)]
    streamed = FlatIndex(model.embed_dim, device=dev)
    t0 = time.perf_counter()
    n = encode_corpus_streaming(packed, IdTokenizer(ENC_LEN), texts, streamed.add,
                                batch_size=ENC_BATCH, device=dev)
    sync()
    diff = float((streamed._vecs - index._vecs[:N_STREAM]).abs().max())
    log(f"[encode] encode_corpus_streaming: {n} passages in {time.perf_counter() - t0:.2f} s "
        f"(host tokenization included); max |diff| to the bulk embeddings {diff:.3g}")
    if n != N_STREAM or streamed.ntotal != N_STREAM or diff > 1e-5:
        raise AssertionError("encode_corpus_streaming disagrees with the bulk encode")

    g = torch.Generator(device=dev)
    g.manual_seed(5151)
    src = torch.randint(0, N_PASSAGES, (N_QUERIES,), generator=g, device=dev)
    q_ids, q_mask = ids[src, :QUERY_LEN].clone(), mask[src, :QUERY_LEN]
    swap = (torch.rand(q_ids.shape, generator=g, device=dev) < 0.15) & (q_mask > 0)
    q_ids[swap] = torch.randint(1, model.cfg.vocab_size, (int(swap.sum()),), generator=g,
                                device=dev, dtype=torch.int32)
    encode_q = make_encode_fn(model, device=dev)  # 'auto': packed_batch at L 32
    before = attn.mha_small_head.launches
    queries = torch.cat([encode_q(q_ids[s:s + ENC_BATCH], q_mask[s:s + ENC_BATCH])
                         for s in range(0, N_QUERIES, ENC_BATCH)])
    if attn.mha_small_head.launches != before:
        raise AssertionError("short queries took K4, not packed_batch")
    flat.flat_topk.launches = 0
    t0 = time.perf_counter()
    _, found = index.search(queries, K)
    search_s = time.perf_counter() - t0
    _, exact = tiled_topk(index._vecs, queries, K, metric="ip", tile=8192)
    exact = exact.cpu().numpy()
    recall = recall_at_k(found, exact)
    own = float((found == src.cpu().numpy()[:, None]).any(axis=1).mean())
    log(f"[search] {N_QUERIES} queries (first <= {QUERY_LEN} tokens, 15% resampled) over "
        f"{N_PASSAGES:,} x {model.embed_dim}: recall@{K} {recall:.4f} vs the exact scan, "
        f"search {search_s:.3f} s host clock, K2 launches {flat.flat_topk.launches}; "
        f"source passage in the top {K}: {own:.4f}")
    if recall < QUERY_RECALL_FLOOR or flat.flat_topk.launches <= 0:
        raise AssertionError(f"query recall {recall:.4f} < {QUERY_RECALL_FLOOR}")
    return dict(launches=launches, rates=rates, recall=recall)


def k4_inputs(dev, b: int, dtype, seed: int):
    """K4 operands at the main path's shape: (b, 128, 12 x 32) q, k, v, do,
    ragged key masks (lengths 16-128)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (b, ENC_LEN, 384)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
    return q, k, v, ragged_mask(g, b, ENC_LEN, 16, dev), do


def k4_bound(q, mask, heads: int, d: int, backward: bool) -> dict:
    """Forward: q, k, v and the mask in, o out; 2 products of 2·L²·d FLOP
    per sequence and head. Backward: q, k, v, do and the mask in, dq, dk and
    dv out; 5 products (the recomputed scores, dv, dp, dq, dk)."""
    b, length, _ = q.shape
    rows = (7 if backward else 4) * nbytes(q) + nbytes(mask)
    flop = (5 if backward else 2) * 2.0 * b * heads * length * length * d
    return bound(rows, flop, "bf16" if q.dtype == torch.bfloat16 else "f32")


def sdpa(q, k, v, mask, heads: int, d: int):
    """The yardstick: torch's scaled_dot_product_attention on the same
    rows viewed as (B, H, L, d), with K4's -1e30 key mask as an additive
    mask (so even a fully masked row is the same function)."""
    b, length, _ = q.shape
    view = lambda t: t.view(b, length, heads, d).transpose(1, 2)  # noqa: E731
    add = torch.where(mask > 0, 0.0, -1e30).to(q.dtype)[:, None, None, :]
    return F.scaled_dot_product_attention(view(q), view(k), view(v), attn_mask=add,
                                          scale=d ** -0.5)


def k4_main_shapes(dev) -> dict:
    """K4 at the main path's shapes, bf16: forward and backward at B 1536
    (a training step's 3 x 512 sequences), forward at B 1024 (an encode
    batch); each against its plain version, then timed beside SDPA."""
    heads, d, scale = 12, 32, 32 ** -0.5
    out = {}
    for b, seed in ((1536, 900), (1024, 901)):
        q, k, v, mask, do = k4_inputs(dev, b, torch.bfloat16, seed)
        err = attn_compare(f"K4 main path B{b} L{ENC_LEN} H{heads} d{d} bfloat16",
                           q, k, v, mask, do, heads, d)
        with torch.no_grad():
            fwd = time_ms(lambda: attn.mha_small_head(q, k, v, mask, heads, d, scale), 10)
            fwd_plain = time_ms(
                lambda: attn.mha_small_head_reference(q, k, v, mask, heads, d, scale), 3)
            fwd_lib = time_ms(lambda: sdpa(q, k, v, mask, heads, d), 10)
        rec = {"err": err, "fwd": {"ms": fwd, "plain_ms": fwd_plain, "library_ms": fwd_lib,
                                   **k4_bound(q, mask, heads, d, False)}}
        log(f"[kernel] K4 forward B{b}: kernel {fwd:.3f} ms, plain version {fwd_plain:.3f} ms, "
            f"SDPA {fwd_lib:.3f} ms, bound {rec['fwd']['bound_ms']:.3f} ms "
            f"({rec['fwd']['bound_by']})")
        if b == 1536:
            times = {}
            for name, fn in (("kernel", attn.mha_small_head),
                             ("plain", attn.mha_small_head_reference),
                             ("library", lambda *a: sdpa(*a[:6]))):
                ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = fn(*ts, mask, heads, d, scale)
                do_ = do if name != "library" else do.view(o.shape[0], ENC_LEN, heads, d
                                                           ).transpose(1, 2)
                times[name] = time_ms(
                    lambda: torch.autograd.grad(o, ts, do_, retain_graph=True),
                    10 if name != "plain" else 3)
            both = {}
            for name, fn, grad_out in (("kernel", attn.mha_small_head, do),
                                       ("library", lambda *a: sdpa(*a[:6]),
                                        do.view(q.shape[0], ENC_LEN, heads, d).transpose(1, 2))):
                def step(fn=fn, grad_out=grad_out):
                    ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
                    return torch.autograd.grad(fn(*ts, mask, heads, d, scale), ts, grad_out)
                both[name] = time_ms(step, 10)
            log(f"[kernel] K4 forward+backward B{b}: kernel {both['kernel']:.3f} ms, "
                f"SDPA {both['library']:.3f} ms")
            rec["bwd"] = {"ms": times["kernel"], "plain_ms": times["plain"],
                          "library_ms": times["library"],
                          **k4_bound(q, mask, heads, d, True)}
            log(f"[kernel] K4 backward B{b}: kernel {times['kernel']:.3f} ms, plain version "
                f"{times['plain']:.3f} ms, SDPA backward {times['library']:.3f} ms, bound "
                f"{rec['bwd']['bound_ms']:.3f} ms ({rec['bwd']['bound_by']})")
        out[b] = rec
    return out


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
        for row in ptxas_report(out):
            log(f"[build] {name}: {row}")

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
    del queries, gt
    torch.cuda.empty_cache()

    err["K4"] = err["K4 bwd"] = attn_checks(dev)
    train = run_training(dev, card)
    torch.cuda.empty_cache()
    enc = run_encode_search(dev, train["model"], card)
    torch.cuda.empty_cache()
    k4 = k4_main_shapes(dev)
    k4_err = max(r["err"] for r in k4.values())
    runs.append(dict(
        launches={"K4": train["launches"][0] + enc["launches"],
                  "K4 bwd": train["launches"][1]},
        mp={"K4": {**k4[1536]["fwd"], "err": k4_err},
            "K4 bwd": {**k4[1536]["bwd"], "err": k4_err}}))
    log(f"[encoder] {card}: training {train['ms']['auto']:.3f} ms/step through K4 "
        f"({TRIPLETS / train['ms']['auto'] * 1e3:,.1f} triplets/s; naive "
        f"{train['ms']['naive']:.3f}, fused {train['ms']['fused']:.3f} ms/step); encode "
        f"{enc['rates']['packed']:,.1f} passages/s through K4 (naive "
        f"{enc['rates']['naive']:,.1f}, fused {enc['rates']['fused']:,.1f}); query recall@{K} "
        f"{enc['recall']:.4f}")

    launches = {k: v for r in runs for k, v in r["launches"].items()}
    mp = {k: v for r in runs for k, v in r["mp"].items()}
    for key in KERNELS:
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"{key} ({KERNELS[key]['name']}) never launched on its path")
    records = []
    for key, meta in KERNELS.items():
        errs = [err[key]] + [m["err"] for k, m in mp.items() if k.split()[0] == key.split()[0]]
        records.append({**meta, "launches": launches[key], "max_abs_err": max(errs),
                        **{f: mp[key].get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms")}})
    print(json.dumps({"kernels": records}))
    log(f"[kernel] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
