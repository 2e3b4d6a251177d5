#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (cloudvectordb_tpu_torch) on one GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build of every hand-written kernel from csrc/*.cu (one nvcc per source,
   all at once), timed, with ptxas' registers and spills per kernel; the
   tensor-core instructions (HMMA, IMMA; HGMMA, IGMMA for wgmma) in each K4
   kernel, each K5/K6 kernel (pq_scan.cu), each K2/K3/K7 kernel
   (tiles_scan.cu) and K1's two (tiles_resid.cu), counted in ``cuobjdump
   --dump-sass``: every bf16 K4 kernel, every pq_scan instantiation and
   every tiles_scan tensor-core instantiation must have some (IMMA or IGMMA
   for int8 rows and queries, HMMA or HGMMA for the bf16 ones; K3's three
   top-2 instantiations too), each of K1's 16 scan instantiations (int8 or
   'precise' queries x mask x l2 x top-2: IMMA for int8, HMMA for
   'precise') and its centroid-term prologue HMMA, and tiles_scan's f32 body
   none of any kind (its contract is f32 FMA); ptxas' registers and spills
   of each K1 scan and K3 top-2 instantiation;
3. k-means determinism: two trainings on the same 262,144 rows (nlist
   4096, 10 iterations) must give bit-identical centroids;
4. each kernel against its plain PyTorch version on the card, on small
   random shapes: K1 (tiles_topk_resid: one slot per bucket and four,
   windows of 1 to 129 lists, valid_end holes, a short final tile, partial
   query blocks; ids held through their exact f64 scores; each contract
   variant, 'precise', a 50% row mask, l2, top-2 and all four at once, at R
   1, 4 and 8 with repeated table entries), K1's l2 bias kernel
   (resid_row_bias, against its plain version and the exact f64 bias), K2 (flat_topk:
   ip/l2 x f32/bf16/int8, R 1 and 4, ragged N), K3 (tiles_topk: int8,
   hybrid, bf16, f32 scoring, repeated table entries, n_valid holes; R 1, 4
   and 8; D 768, 100, 99 and 1000; tile_q 64, 48 and 160; top-2 on the
   int8, hybrid and bf16 pairs), K7 (band_topk:
   clamped bands, the same shapes), K5 (pq_tiles_topk: residual or not,
   pools 1-3, top-2 on and off, R 1 and 4, repeated entries, n_valid
   cutting a tile, D 768 at m 64, D 64, and D 30 at dsub 5; its segmented
   dispatch over a five-tile arena cut at two tiles, residual, masked, l2
   and top-2 with two pools, the view form equal to the reference's tuple
   form with pad tiles), K6
   (pq_topk: ragged N, D 768 and D 30) and K8 (rescore_int8, the PQ route's
   int8 rescore: residual or whole rows, ip or l2, 40 and 9,000 slots a
   query); one line per kernel;
5. the residual serving path: a 12.5M x 768 corpus generated on the device
   (the process of bench.py: latent 32, 256 centres, noise 0.3/sqrt(32),
   L2-normalised), ``BandIVFIndex.build_device_streaming`` with nlist 4096
   and residual int8, ``tune(k=10, target_recall=0.95)``, then batches of
   4096 through ``search_device``; K1's launch count over that run must be
   > 0 and recall@10 against the exact f32 ground truth on 512 queries must
   reach 0.90; device QPS is the median of CUDA-event-timed repetitions;
   then K1 against its plain version at the main path's shape (its ids held
   through their exact f64 scores, as EXACT_TIE says), both timed; then on
   the same index (``run_resid_variants``, each path's launch counts reset
   just before and read just after): filtered batches (``where=``) under a
   random 10% filter, a random 0.1% one and a correlated one (every row of
   32 lists adjacent in the locality order), each with no disallowed id
   and (-inf, -1) unfilled slots, its mask gather's time and cache hit and
   its QPS, recall@10 against the exact filtered f32 ground truth (>= 0.90
   for the correlated filter at the op point and for the 10% filter at
   full coverage); one batch with scoring='precise' and one with top-2
   (recall@10 >= 0.90 each); an l2 view of the same arena (recall@10 >=
   0.90 against the exact l2 ground truth; the largest distance of its
   scores from -|q - x|^2); then the l2 bias kernel over the arena and K1's
   'precise', masked (10%), l2 and top-2 plans against their plain
   versions (held through exact f64 scores), each timed, with its bound;
   then cell 14, sharded serving (``run_sharded``, the residual index
   freed first; alone: ``cell14``), at BASELINE config #4's per-card share
   on cell 1's quantizer: (a) a 4-shard ``ShardedBandIndex`` on this card
   (``make_mesh(4)``) by ``build_streaming`` of the 25 chunks,
   ``tune(gt=)`` at B 4096 against the exact top-10 of every query,
   recall@10 >= 0.90 at the op point and, at full coverage, no more than
   0.005 below cell 1's single index, device QPS, a 10% and a 3-id filter
   (no disallowed id, (-inf, -1) tails), a torch.profiler split, the
   merge's time, and K1 at shard 0's plan against its plain version (held
   as cell 1's, timed, with its bound); (b) two spawned processes (gloo)
   loading 2 + 2 shards of a saved 1M-row 4-shard index: ids and scores
   equal to one process at p 32 and at full coverage; (c)
   ``DistributedFlatIndex`` over those 1M rows (K2, f32 ip, 4096 queries)
   equal to the exact top-10 under K2's one-row-a-bucket rule, near-ties
   aside; (d) the saved index loaded (equal at both plans) and resharded
   4 -> 2 (ids equal by position on >= 0.999, recall within 0.001);
6. the whole-row path on the same corpus, queries and ground truth (the
   residual index freed first): ``build_device_streaming(residual=False)``
   (int8), ``tune``, ``search_device`` with the default hybrid scoring (QPS
   as above), one batch with scoring='int8' and one through
   ``search(strategy='band')``, and one hybrid top-2 batch; K3 and K7 must
   launch and hybrid recall@10 (top-2 too) must reach 0.80; then against
   their plain versions, each timed, with
   its bound: K3 at the tuned op point, hybrid (its ids held to the plain
   version's through their exact f64 scores, as EXACT_TIE says) and int8
   (values and ids equal outright), and hybrid top-2 (held as hybrid) at
   the tuned op point, again at (96, 32) if the tuner picked another point;
   K7 at the band plan (values and ids equal outright);
   then K3's top-2 where the narrow tensor-core block cannot take it (the
   CUDA-core body, ``run_top2_routes``): an f32 whole-row index over the
   corpus's first 1M rows at (96, 32) (recall@10 >= 0.80) and a hybrid
   int8 arena of 262,144 rows at D 3072, each one top-2 batch of 4096
   (its K3 launches counted just around it) and K3 top-2 at that plan
   against its plain version through exact f64 scores, timed, with its
   bound;
7. mutation (``run_mutation``, the launch counts of K1, K3 and K7 reset
   just before and read just after, at the residual path's op point, each
   state's recall@10 against its own exact f32 ground truth from one pass
   over its rows): scripts/bench_fold.py's protocol (the residual index
   with merge_headroom 0.06; five adds of 131,072 rows of further chunks of
   the corpus, the first pending, the fifth past the 5% threshold folding
   all 655,360 into the annex; a batch under a random 10% filter;
   ``merge_pending`` in place: the arena's buffer and capacity kept), then
   scripts/bench_remove.py's (a slack 0.05 arena, four fenced rounds of
   8,192 removes of random live ids, K1 held against its plain version on
   the mutated arena at the op point, a refill of 8,192 rows in place, a
   filtered batch under a filter built before the removes), then whole
   rows (1M x 768 int8, 131,072 added rows in the annex through the tiles
   and band strategies, 8,192 removed by the compact path); recall@10 >=
   0.90 in every residual state (0.80 whole rows), no removed id returned,
   no -1 in a filled slot, self-hit@1 of 256 added rows >= 0.99 while
   pending or in the annex and >= 0.90 merged;
8. the flat path: ``FlatIndex`` at BASELINE config #1's shape (1M x 128
   SIFT-like f32 rows: clustered, non-negative, integer-valued, made on the
   device; 10,000 queries; l2; k 10) must reach recall@10 0.99 against the
   exact f32 scan, and at bench.py's int8 flat shape (1M x 768 of the
   corpus, the 4096 queries, ip) its recall is logged; K2 must launch;
   then K2 against its plain version at both shapes, values and ids equal
   outright (int8 is exact; the f32 l2 rows and queries are integers whose
   every partial sum is exact in f32), both timed;
9. the PQ-tiles path at BASELINE config #3 (``run_pq``): the first 10M
   rows of the corpus, ``BandIVFPQIndex.build_device_streaming`` (nlist
   4096, m 64, nbits 8, OPQ, residual int8 refine, k-means 10 and PQ 8
   iterations), ``tune``, the refine route (K1) at the op point (recall@10
   >= 0.90 against the exact f32 ground truth on 512 queries), then the PQ
   route (K5, then the exact int8 rescore, K8) at the tuned p_tiles and
   tile_q with refine_factor 16, 64 and 64 with top-2 (K5 must launch, and
   K8 once a K5 launch; recall@10 >= 0.70, 0.85 and 0.85), device QPS of
   each; then on that plan K1 over the refine arena and K5 at each of the
   three candidate budgets against their plain versions, each timed, with
   its bound (K5's ids held to the plain version's through their exact f64
   scores, as EXACT_TIE says, and each score to its id's exact score), and
   K8 on K5's refine_factor-64 candidates against its plain version
   (scores within 1e-5 of max(1, |score|), the same after the stable
   top-k), both timed, with its bound; the index is freed before the next
   phase;
10. K6 (``pq_topk``, ``run_k6``): codebooks trained (m 64) on 65,536
   corpus rows, 1M rows encoded, the 4096 queries, k 10: recall against the
   exact scan, then K6 against its plain version as K5, both timed;
   then cell 13, BASELINE config #5 at its per-card share (``run_config5``):
   125M x 768 rows (chunks 0-249 of the corpus) through
   ``BandIVFPQIndex.build_device_streaming`` (nlist 16384, m 64, OPQ,
   refine 'pq2' m2 32, tile_n 1024; past the 28·2^20-row segment cap, so
   K5 dispatches five segments, each with its own pools), ``tune(gt=)`` at
   B 4096 against the exact f32 top-10, recall@10 and device QPS at the op
   point beside the same plan's recall without the pq2 rescore (the run
   fails if pq2 reads more than 0.005 below it) and beside the joined
   dispatch's on the same arena (the cap set past its rows; the run fails
   if the segmented recall reads more than 0.005 below it), the random
   10% and correlated filters (no
   disallowed id, (-inf, -1) unfilled slots), 131,072 added rows pending
   (plain and filtered batches; the allowed pending rows find themselves),
   ``merge_pending``, 8,192 removes (no removed id back), 1,024
   ``reconstruct`` calls (equal to the decode, cosine >= 0.8 to their
   source rows), each timed; then K5's segmented dispatch at the op plan
   against its plain version plain, masked (10%), masked with top-2 and
   l2, through exact f64 scores, each timed (the five launches of a call
   together), with its bound; then its smaller checks
   (``c5_small_checks``): (a) l2 at 500,000 rows with row norms in [0.5, 3.0]
   (pq2 and int8 builds, both routes, against the exact l2 truth; K5's l2
   bias kernel against its plain version and the exact f64 bias), (b) the
   pq2+host cascade on cell 7's first 10M rows at host_factor 32 and 102
   (``attach_host_refine`` from host copies of the rotated chunks), (c)
   anisotropic codebooks (aniso_eta 4) beside the plain ones at 500,000,
   full coverage, (d) ``build_streaming`` at 1M equal to
   ``build_device_streaming`` given its quantizers, and ``merge_from`` of two
   500,000-row halves equal to one build (recall within 0.005); inside (b), cell 15
   (``run_sharded_config5``; alone: ``cell15``): a 4-shard
   ``ShardedBandIVFPQIndex`` ('pq2+host', four shards of 2.5M on this card)
   by ``build_streaming`` of (b)'s 10M rows on (b)'s quantizers, pq2 alone
   and the cascade at full coverage no more than 0.02 below the single
   index on the same plan and the cascade at least pq2, a 10% filter,
   ``tune(gt=)`` at B 4096 (target 0.90), the op point's recall and
   host-clock QPS, a torch.profiler split, K5 at shard 0's plan against its
   plain version (timed, with its bound); on the first 1M rows save, load
   (equal), a 4 -> 2 reshard (every id's codes, list, tier-2 codes and host
   row equal; each query whose ids differ a K5 slot collision of one layout
   or an exact tie; recall within 0.02) and two processes on the card
   (gloo), each loading 2 + 2 shards and its own host stores, equal to one
   process;
   then the probe-scan families (no hand-written kernel): cell 10,
   ``IVFFlatIndex`` at BASELINE config #2's shape (``run_ivf_flat``: 1M x
   384 rows of the corpus's process, nlist 4096, 512 queries; the nprobe
   sweep 1-64, recall not falling by more than 0.005 along it, its
   operating point, ``tune(gt=)``, a torch.profiler split of one batch, a
   full-probe batch equal to the exact top-10 but for near-ties, and
   ``range_search`` at full probe equal to the exact oracle's hit sets but
   for near-ties), and cell 11, ``IVFPQIndex`` at scripts/bench_ivf.py's
   shape (``run_ivf_pq``: 1M x 768, 4096 queries, nlist 1024, m 64,
   residual; sweeps of nprobe x refine_factor 16/64 and of the ADC-only
   route, recall not falling along nprobe, ``tune(gt=)``, the full probe
   at rf 64 within 0.01 of the method's exact oracle, 8,192 removes (no
   removed id back, recall within 0.01), ``merge_from`` of two halves
   (every id once, recall within 0.005) and ``reconstruct`` (cosine >=
   0.99)); in it cell 14 (e): 4-shard ``ShardedIVFPQIndex`` builds on
   cell 11's quantizers, recall@10 at nprobe 1, 16 and 64 within 0.01 of
   the single index on the ADC route and no more than 0.01 below it with
   the int8 refine (rf 64: rf·10 candidates a shard, the reference's
   rule), and at full probe no more than 0.01 below the method's oracle;
11. K4 (mha_small_head) against its plain version, forward outputs and dq,
   dk, dv: L 128, 256 and 512, (H, d) (12, 32) and (12, 64), f32 and bf16,
   and (12, 16) bf16, ragged key padding and a fully masked sequence; each
   check must count one forward and one backward launch, and each bf16
   backward must give bit-identical gradients in two runs;
12. training: ``Trainer.fit`` on minilm-l6-384 at full width (bf16, max_len
   128, no probs dropout, 'auto'), 20 steps of 512 learnable triplets made
   on the device; finite losses, K4 forward and backward launched once per
   layer and step; from the checkpoint fit wrote, one step through 'auto'
   (K4) against one through 'naive' (dropout 0): loss within 1e-2 and grad
   norm within 1% relative; ms/step of 'auto', 'naive' and 'fused' (SDPA),
   and a torch.profiler split of one step;
13. encoding and search: 1,000,000 passages of device-made token ids
   (lengths 16-128, padded to 128) through 'packed' (K4, launches counted)
   in batches of 1024 into ``FlatIndex(384)``; passages/s, also for
   'naive' and 'fused'; mean cosine 'packed' vs 'naive' on 4096 passages
   >= 0.999; ``encode_corpus_streaming`` on 16,384 of them (a stand-in
   tokenizer) must give the bulk embeddings; 10,000 short queries (first
   <= 32 tokens, 15% resampled) through 'auto' (packed_batch) and
   ``FlatIndex.search`` (K2) must reach recall@10 0.99 against the exact
   scan; then K2 (f32 ip, 1M x 384, 10,000 queries) against its plain
   version, both timed, with its bound;
13b. cell 16, data parallelism (``run_train_dp``): first K4 against its
   plain version at the cell's own shapes (a replica's B 768 at f32 and
   bf16, a slot's encode B 512 at f32, forward and backward; B 768 bf16
   timed beside SDPA, with its bound); MiniLM-L6-384 at full
   width, 512 triplets a global batch: ``Trainer(mesh=make_mesh(2,
   axis_name="data"))`` (two replicas on this card) against the one-slot
   trainer, 3 f32 steps with dropout 0 (loss and grad_norm within 1e-5
   relative, every parameter but the attention key biases within 1e-5, the
   key biases within 2·lr a live update), K4 6 forward and 6 backward
   launches a replica a step; bf16 ms/step of one slot and two and the
   gradient all-reduce's ms; two processes on the card (gloo, 256 triplets
   each) held the same way against one process on the concatenated batch,
   their ms/step and all-reduce; ``encode_corpus`` over the two slots
   within 1e-5 of one slot on 65,536 passages (f32, 'packed');
14. K4 at the main path's shapes (bf16, B 1536 forward and backward, B 1024
   forward) against its plain version (with SDPA's own distance to it, and
   the backward bit-identical in two runs, at B 1536), timed beside torch's
   scaled_dot_product_attention (K4 and SDPA as the mean of 20 calls back to
   back, each repetition);
15. cell 12, the pipeline from raw text (``run_pipeline``), driven through
   the CLI entry point in this process (``cli.main(["pipeline", ...])``)
   on a temporary workdir: 125,000 synthetic passages, 50,000 inbatch
   triplets (cut from 1M and 100,000 to keep the run in its time limit),
   MiniLM-L6-384 at full width (bf16, max_len 128, dropout 0.1, no probs
   dropout, 'packed': K4 forward and backward in training, K4 in
   encoding), 60 steps of 512 triplets, every passage encoded, a
   residual-int8 band_ivf index (nlist 4096), tune, eval; the stage table
   from metrics.jsonl (host tokenization, tokenizer training and corpus
   synthesis split out; kernel launches per stage); every stage's marker
   and artifact, a finite falling loss, 125,000 x 384 finite unit-norm
   embeddings (within 1e-3), K4 forward and backward in train, K4 in
   encode and K1 in tune and eval launched, eval recall@10 >= 0.90 against
   the exact f64 ground truth; a second ``pipeline`` on the workdir must
   skip every stage (the same eval.json, no K4); ``search`` from text must
   print 10 passages; then hard mining (a second workdir with copies of
   the passages, tokenizer.json and checkpoints; 16,384 anchors, each
   negative a filled candidate of its anchor's top 100 through K2 from
   another document) and the text -> results split (tokenization, the L
   32 query encode, ``search_device``) at B 1, 64 and 4096.

Then one JSON line with every kernel's record (times, bound, library
time), the card's line and, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cloudvectordb_tpu_torch import cli
from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer
from cloudvectordb_tpu_torch.data.triplets import Triplets
from cloudvectordb_tpu_torch.eval.harness import direct_corpus
from cloudvectordb_tpu_torch.eval.qps import qps_device
from cloudvectordb_tpu_torch.eval.recall import recall_at_k
from cloudvectordb_tpu_torch.eval.sweep import nprobe_sweep, operating_point
from cloudvectordb_tpu_torch.index import ivf_band as ivf_band_module
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex, _plan_tiles
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.index.pq import pq_decode, pq_encode, train_pq
from cloudvectordb_tpu_torch.index.registry import load_index
from cloudvectordb_tpu_torch.models.embed import encode_corpus_streaming, make_encode_fn
from cloudvectordb_tpu_torch.models.encoder import Encoder
from cloudvectordb_tpu_torch.models.presets import get_preset
from cloudvectordb_tpu_torch.ops import attn, band, flat_topk as flat, pq, rescore
from cloudvectordb_tpu_torch.pipeline import run as pipeline_run
from cloudvectordb_tpu_torch.pipeline.run import Pipeline
from cloudvectordb_tpu_torch.ops.topk import (
    NEG_INF, _score_block, merge_topk, tiled_topk, topk_stable, topk_stable_select)
from cloudvectordb_tpu_torch.train.trainer import Trainer
from cloudvectordb_tpu_torch.utils.checkpoint import restore_checkpoint
from cloudvectordb_tpu_torch.utils.config import (
    DataConfig, IndexConfig, MiningConfig, PipelineConfig, TrainConfig)
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
PQ_ROWS, PQ_M, PQ_NBITS = 10_000_000, 64, 8  # BASELINE config #3
PQ_REFINE_FLOOR = 0.90
#: the PQ route's plans (refine_factor, top2) and their recall@10 floors
PQ_PLANS = {"rf16": (16, False), "rf64": (64, False), "rf64+top2": (64, True)}
#: the opqpq10m.b4096 cell's plan (cvdb_bench/op_points/opqpq10m.b4096.json):
#: p_tiles, tile_q and {name: (refine_factor, top2)}, the pools the
#: candidate budget picks: K5's 64-query block
PQ_CELL_P, PQ_CELL_TQ, PQ_CELL_PLAN = 320, 64, {"cell": (205, True)}
#: K5's hold at that plan: 2,050 candidates a query reach deep into each
#: query's ranking, where exact near-ties within EXACT_TIE reorder about 3x
#: more positions than at k_cand 640 (an H100 run read 0.93475 by position
#: on config #3's index, every differing id within the tie window and the
#: kernel's ids' exact sum above the plain version's: PERF.md section 6; the
#: 32-query block gives the same ids bit for bit); every other criterion of
#: ``compare`` holds as at the other plans
PQ_CELL_ID_FLOOR = 0.92
PQ_ROUTE_FLOORS = {"rf16": 0.70, "rf64": 0.85, "rf64+top2": 0.85}
K6_TRAIN, K6_ROWS, K6_TILE_N = 65_536, 1_000_000, 2048
ID_MATCH_FLOOR = 0.999
SCORE_TOL = 1e-4
#: K1 and K5/K6 at full shape, against exact scores (f64 on the bf16 and
#: int8 inputs both versions take). There two rows of one slot can lie
#: closer than the versions' f32 rounding (K5 on config #3's corpus: up to
#: 1.6e-6 for the plain version, 4.2e-7 for the kernel, on an H100:
#: PERF.md), which then orders
#: them. So the kernel's id at a slot agrees with the plain version's when
#: its exact score is at most EXACT_TIE below (twice the two errors
#: together, the most such a swap can cost); the exact scores of all the
#: kernel's ids sum to at least the plain version's less EXACT_TIE; and at
#: least EXACT_ID_FLOOR of the ids are equal by position (the runs read
#: 0.975-0.999). The bf16 pairs of K3/K7 take the same rule with the tie
#: derived in the run, twice the two versions' measured errors together
#: (``compare``'s tie=None): their raw scores reach the hundreds.
EXACT_TIE = 4e-6
EXACT_ID_FLOOR = 0.97
#: K1's l2 bias kernel and its plain version, each against the exact f64
#: bias: within BIAS_TOL x max(1, |exact|) (f32 sums of up to 1024 terms in
#: different orders; the bias reaches ~1e3 on the small checks' random rows)
BIAS_TOL = 1e-5
_SCAN = "cloudvectordb_tpu_torch/csrc/tiles_scan.cu"
#: K1's contract variants, as tiles_topk_resid's options (the row mask's
#: bits are the run's own)
VARIANTS = {"precise": dict(int8_q=False), "masked": {}, "l2": dict(l2=True),
            "top2": dict(top2=True)}
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
_PQ = "cloudvectordb_tpu_torch/csrc/pq_scan.cu"
KERNELS["K5"] = {"name": "pq_tiles_topk", "route": "cuda", "source": _PQ,
                 "replaces": "cloudvectordb_tpu/ops/pallas_pq.py:315"}
KERNELS["K6"] = {"name": "pq_topk", "route": "cuda", "source": _PQ,
                 "replaces": "cloudvectordb_tpu/ops/pallas_pq.py:510"}
KERNELS["K4"] = {"name": "mha_small_head", **_ATTN}
KERNELS["K4 bwd"] = {"name": "mha_small_head_bwd", **_ATTN}
#: K1's l2 bias (a kernel of its own in tiles_resid.cu: the l2 part of the
#: reference's K1 body)
KERNELS["K1b"] = {"name": "resid_row_bias", "route": "cuda",
                  "source": "cloudvectordb_tpu_torch/csrc/tiles_resid.cu",
                  "replaces": "cloudvectordb_tpu/ops/pallas_band.py:518"}
#: K5's l2 bias (a kernel of its own in pq_scan.cu: the l2 part of the
#: reference's K5 body)
KERNELS["K5b"] = {"name": "pq_row_bias", "route": "cuda", "source": _PQ,
                  "replaces": "cloudvectordb_tpu/ops/pallas_pq.py:205"}
#: the PQ route's int8 rescore (no Pallas counterpart: the reference leaves
#: the step to XLA)
KERNELS["K8"] = {"name": "rescore_int8", "route": "cuda",
                 "source": "cloudvectordb_tpu_torch/csrc/rescore_int8.cu",
                 "replaces": "none: the XLA rescore at cloudvectordb_tpu/index/ivf_band.py:146-170"}
#: a kernel's other main-path shapes and contract variants, each a record of
#: its own in the kernels line: K1 over config #3's refine arena (cell 7),
#: K2 over int8 rows (cell 4) and over the encoded passages (cell 6); K1's
#: 'precise', filtered (row_mask), l2 and top-2 searches and K3's top-2
#: (cells 1 and 2); K1 over the slack arena after its removes (cell 9); K3's
#: top-2 on the CUDA-core body over f32 rows and deep hybrid rows; K5's
#: filtered and l2 searches (cell 13); K1 and K5 at shard 0's plan (cells 14
#: and 15); K4 forward and backward in a data-parallel replica (cell 16);
#: K5's segmented dispatch at cell 13's op plan (its launches: the
#: segmented dispatch's)
SHAPE_RECORDS = {"K1 refine": "K1", "K2 int8": "K2", "K2 ip": "K2", "K1 precise": "K1",
                 "K1 masked": "K1", "K1 l2": "K1", "K1 top2": "K1", "K3 top2": "K3",
                 "K1 mutated": "K1", "K3 top2 f32": "K3", "K3 top2 deep": "K3",
                 "K5 masked": "K5", "K5 l2": "K5", "K1 sharded": "K1", "K5 sharded": "K5",
                 "K4 dp": "K4", "K4 bwd dp": "K4 bwd", "K5 seg": "K5"}
KERNELS.update({key: dict(KERNELS[base], **({"name": f"{KERNELS[base]['name']} "
                                                     f"{' '.join(key.split()[1:])}"}
                                            if key.split()[1] in VARIANTS else {}))
                for key, base in SHAPE_RECORDS.items()})
KERNELS["K5 seg"]["name"] = "pq_tiles_topk segmented"
WRAPPERS = {"K1": band.tiles_topk_resid, "K2": flat.flat_topk,
            "K3": band.tiles_topk, "K7": band.band_topk, "K5": pq.pq_tiles_topk,
            "K6": pq.pq_topk, "K1b": band.resid_row_bias, "K5b": pq.pq_row_bias,
            "K8": rescore.rescore_int8}
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


def kernel_name(sym: str) -> str:
    """The ``*_kernel`` identifier inside a mangled symbol (a length-prefixed
    name), else the symbol itself."""
    for run in re.finditer(r"\d+", sym):
        for i in range(len(run.group())):
            n = int(run.group()[i:])
            name = sym[run.end():run.end() + n]
            if len(name) == n and name.endswith("_kernel") and name[0].isalpha():
                return name
    return sym


def ptxas_report(out: str) -> list[str]:
    """A library's kernels from ``nvcc -Xptxas -v``, one string each: its
    name, its instances (template arguments), their range of registers,
    and the largest spill (bytes of spill stores)."""
    kernels: dict[str, list[tuple[int, int]]] = {}
    name, spill = "?", 0
    for line in out.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            kernels.setdefault(name, []).append((regs, spill))
    return [f"{k} x{len(v)}: {min(r for r, _ in v)}-{max(r for r, _ in v)} registers, "
            f"spill stores <= {max(s for _, s in v)} B" for k, v in kernels.items()]


def ptxas_instances(out: str, label) -> list[str]:
    """Registers and spill stores of each kernel instantiation in ``nvcc
    -Xptxas -v`` output that ``label(mangled symbol)`` names (None: skip)."""
    lines, sym, spill = [], None, 0
    for line in out.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            sym = entry.group(1)
        elif "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "Used" in line and "registers" in line and sym and label(sym):
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            lines.append(f"{label(sym)} {regs} registers, {spill} B spill stores")
    return lines


#: the CUDA-core body's (query, row) types, as mangled in its symbols
CC_PAIRS = {"aa": "int8", "13__nv_bfloat16a": "hybrid", "13__nv_bfloat16S": "bf16",
            "ff": "f32", "f13__nv_bfloat16": "f32 x bf16"}


def tc_top2_label(sym: str) -> str | None:
    """A tiles_scan.cu top-2 instantiation's label (the narrow tensor-core
    block, or the CUDA-core body), else None."""
    m = re.search(r"tiles_tc_kernelILi(\d)ELi(\d)E.*ELb1E", sym)
    if m:
        return f"TABLE {SCAN_TC_PAIRS[m.group(2)][0]} top2"
    m = re.search(r"tiles_scan_kernelILi1E(\w+?)Lb1E", sym)
    if m:
        pair = next((v for k, v in CC_PAIRS.items() if m.group(1).startswith(k)), m.group(1))
        return f"TABLE {pair} top2 (CUDA-core)"
    return None


#: tensor-core instructions in SASS: HMMA and IMMA (mma.sync), HGMMA and
#: IGMMA (wgmma)
TENSOR_CORE_OP = re.compile(r"\b([HI]G?MMA)\b")


def sass_tensor_core_counts(sass: str) -> dict[str, tuple[dict[str, int], int]]:
    """({tensor-core mnemonic: count}, all instructions) of each kernel in
    ``cuobjdump --dump-sass`` text, by mangled symbol."""
    counts: dict[str, tuple[dict[str, int], list[int]]] = {}
    sym = None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            sym = fn.group(1)
            counts[sym] = ({}, [0])
        elif sym is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            ops, n = counts[sym]
            n[0] += 1
            op = TENSOR_CORE_OP.search(line)
            if op:
                ops[op.group(1)] = ops.get(op.group(1), 0) + 1
    return {k: (ops, n[0]) for k, (ops, n) in counts.items()}


def tensor_core_ops(lib: Path) -> dict[str, tuple[int, int]]:
    """(tensor-core instructions, all instructions) in each kernel of a
    built library, by mangled symbol."""
    return {k: (sum(ops.values()), n) for k, (ops, n) in sass_counts(lib).items()}


def sass_counts(lib: Path) -> dict[str, tuple[dict[str, int], int]]:
    """``sass_tensor_core_counts`` of a built library's
    ``cuobjdump --dump-sass``."""
    from cloudvectordb_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-sass", str(lib)], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    return sass_tensor_core_counts(out)


def k4_tensor_core_check(lib: Path) -> None:
    """Every bf16 K4 kernel (a symbol over __nv_bfloat16 rows: four kernels
    at d 16, 32 and 64) must run tensor-core instructions; one line."""
    counts = tensor_core_ops(lib)
    by_name: dict[str, list[tuple[int, int]]] = {}
    for sym, n in counts.items():
        key = kernel_name(sym) + (" bf16" if "__nv_bfloat16" in sym else " f32")
        by_name.setdefault(key, []).append(n)
    log("[build] mha_small_head tensor-core instructions of all (cuobjdump --dump-sass): "
        + "; ".join(f"{k} x{len(v)}: {min(h for h, _ in v)}-{max(h for h, _ in v)} of "
                    f"{min(a for _, a in v)}-{max(a for _, a in v)}"
                    for k, v in sorted(by_name.items())))
    bf16 = [h for sym, (h, _) in counts.items() if "__nv_bfloat16" in sym]
    if len(bf16) != 12 or min(bf16) == 0:
        raise AssertionError(f"bf16 K4 kernels without tensor-core instructions: {by_name}")


#: pq_scan.cu's scan instantiations: (source, residual, top2, mask, l2, QB)
#: for TABLE x 16 and ALL x 1 at 32 queries a block, and TABLE's 4 unmasked
#: inner-product variants and ALL at 64 (its l2 bias kernel, f64 sums, is
#: not counted)
PQ_INSTANCES = 22


def pq_tensor_core_check(lib: Path) -> None:
    """Every K5/K6 scan instantiation (pq_scan.cu) must run tensor-core
    instructions; one line with the counts."""
    counts = {sym: n for sym, n in tensor_core_ops(lib).items()
              if kernel_name(sym) == "pq_scan_kernel"}
    def label(sym: str) -> str:
        src, *flags, qb = re.search(r"ILi(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELi(\d+)E",
                                    sym).groups()
        return (f"{'TABLE' if src == '1' else 'ALL'}" + "".join(
            f" {o}" for o, f in zip(("resid", "top2", "mask", "l2"), flags) if f == "1")
            + f" QB{qb}")

    log("[build] pq_scan tensor-core instructions of all (cuobjdump --dump-sass): "
        + "; ".join(f"{label(sym)}: {h} of {n}" for sym, (h, n) in sorted(counts.items())))
    if len(counts) != PQ_INSTANCES or min(h for h, _ in counts.values()) == 0:
        raise AssertionError(f"pq_scan kernels without tensor-core instructions: {counts}")


#: tiles_scan.cu's tensor-core instantiations: (ALL, TABLE, BAND) x (int8,
#: hybrid, bf16) in the narrow block, (ALL, TABLE, BAND) x int8 in the wide
#: one, and K3's top-2: TABLE x (int8, hybrid, bf16) narrow
SCAN_TC_INSTANCES = 15
#: tiles_scan.cu's f32-body instantiations: (ALL, TABLE, BAND) x (f32, bf16
#: rows)
SCAN_F32_INSTANCES = 6
#: the tensor-core instruction each pair must run (tc_scan.cuh's Pair)
SCAN_TC_PAIRS = {"0": ("int8", ("IMMA", "IGMMA")), "1": ("hybrid", ("HMMA", "HGMMA")),
                 "2": ("bf16", ("HMMA", "HGMMA"))}
SCAN_SOURCES = {"0": "ALL", "1": "TABLE", "2": "BAND"}


def scan_tensor_core_check(counts: dict[str, tuple[dict[str, int], int]]) -> None:
    """``sass_tensor_core_counts`` of tiles_scan.cu's library: every
    instantiation of the tensor-core body (tiles_tc_kernel) must run
    tensor-core instructions of its pair's kind (IMMA or IGMMA for int8, HMMA
    or HGMMA for bf16), and the f32 body (tiles_f32_kernel) none of any kind
    (its contract is f32 FMA: TF32 would break it); one line with the
    counts. Nothing is asked of the CUDA-core body."""
    lines, bad, n_tc, n_f32 = [], [], 0, 0
    for sym, (ops, n) in sorted(counts.items()):
        name = kernel_name(sym)
        found = ", ".join(f"{k} {v}" for k, v in sorted(ops.items())) or "none"
        if name == "tiles_tc_kernel":
            n_tc += 1
            src, pair, wm, top2 = re.search(
                r"ILi(\d)ELi(\d)E.*?TcCfgILi(\d)E.*ELb(\d)E", sym).groups()
            kind, want = SCAN_TC_PAIRS[pair]
            label = (f"{SCAN_SOURCES[src]} {kind} {'narrow' if wm == '8' else 'wide'}"
                     + (" top2" if top2 == "1" else ""))
            if not any(ops.get(k, 0) for k in want):
                bad.append(label)
        elif name == "tiles_f32_kernel":
            n_f32 += 1
            src = re.search(r"ILi(\d)E", sym).group(1)
            label = f"{SCAN_SOURCES[src]} f32 x {'bf16' if 'bfloat16' in sym else 'f32'}"
            if ops:
                bad.append(f"{label} (tensor-core instructions in the f32 body)")
        else:
            continue
        lines.append(f"{label}: {found} of {n}")
    log("[build] tiles_scan tensor-core instructions (cuobjdump --dump-sass): " + "; ".join(lines))
    if n_tc != SCAN_TC_INSTANCES or n_f32 != SCAN_F32_INSTANCES or bad:
        raise AssertionError(f"tiles_scan kernels: {n_tc} tensor-core and {n_f32} f32 "
                             f"instantiations; without their instructions or with forbidden "
                             f"ones: {bad}")


#: tiles_resid.cu's kernels and the tensor-core instruction each must run:
#: the scan's int8 pair IMMA, its hybrid pair ('precise') HMMA, the
#: centroid-term prologue HMMA; the l2 bias kernel runs none (f32 sums)
RESID_TC = {"0": ("IMMA", "IGMMA"), "1": ("HMMA", "HGMMA"),
            "resid_centroid_kernel": ("HMMA", "HGMMA")}
#: the scan's instantiations: (int8, hybrid) x mask x l2 x top-2
RESID_SCAN_INSTANCES = 16


def resid_label(sym: str) -> str:
    """A K1 kernel's name, with the scan's template arguments spelt out."""
    name = kernel_name(sym)
    if name != "resid_scan_kernel":
        return name
    pair, masked, l2, top2 = re.search(r"ILi(\d)ELb(\d)ELb(\d)ELb(\d)E", sym).groups()
    return (f"scan {'precise' if pair == '1' else 'int8'}"
            + "".join(f" {o}" for o, f in (("mask", masked), ("l2", l2), ("top2", top2))
                      if f == "1"))


def resid_tensor_core_check(counts: dict[str, tuple[dict[str, int], int]]) -> None:
    """``sass_tensor_core_counts`` of tiles_resid.cu's library (K1): every
    instantiation of its scan and its prologue must run their kind of
    tensor-core instructions; one line with the counts."""
    found = {resid_label(sym): v for sym, v in counts.items()}
    log("[build] tiles_resid tensor-core instructions (cuobjdump --dump-sass): " + "; ".join(
        f"{k}: " + (", ".join(f"{o} {c}" for o, c in sorted(ops.items())) or "none") + f" of {n}"
        for k, (ops, n) in sorted(found.items())))
    bad = []
    for sym, (ops, _) in counts.items():
        name = kernel_name(sym)
        want = (RESID_TC[re.search(r"ILi(\d)E", sym).group(1)] if name == "resid_scan_kernel"
                else RESID_TC.get(name, ()))
        if want and not any(ops.get(o, 0) for o in want):
            bad.append(resid_label(sym))
    scans = sum(kernel_name(sym) == "resid_scan_kernel" for sym in counts)
    if bad or scans != RESID_SCAN_INSTANCES or "resid_centroid_kernel" not in found:
        raise AssertionError(f"K1 kernels: {scans} scan instantiations; without their "
                             f"tensor-core instructions: {bad}")


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    attn.mha_small_head.launches = attn.mha_small_head.bwd_launches = 0
    pq.pq_tiles_topk.seg_launches = 0


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
#: small-shape checks per kernel: (shapes, worst id match, worst |dscore|),
#: logged as one line per kernel by small_kernel_checks
CHECKS: dict[str, list] = {}


def compare(name: str, kernel, plain, quiet: bool = False, exact=None,
            tie: float | None = EXACT_TIE, equal: bool = False, allow=None,
            id_floor: float = EXACT_ID_FLOOR) -> float:
    """kernel() against plain(), both returning (values, ids), on the same
    inputs; returns max |Δscore| over the filled slots. The wrapper named
    by the first word of ``name`` must count a launch in kernel() and none
    in plain(). ``quiet`` folds the result into CHECKS instead of a line.
    With ``exact`` (query indices, ids) -> f64 scores, the kernel's ids are
    held to the plain version's as EXACT_TIE says (``tie`` in its place;
    None: twice the two versions' largest distances from the exact scores);
    ``id_floor`` (EXACT_ID_FLOOR unless said) of the ids must be equal by
    position; the kernel's score of each id must be its exact score within
    SCORE_TOL,
    and the plain version's within SCORE_TOL plus the plain version's own
    largest distance from the exact scores (both sum the same products in
    f32 in different orders; where scores reach the hundreds, as the
    hybrid pair's do, the plain version's f32 sum alone is off by more than
    SCORE_TOL). ``equal``: values and ids must be the plain version's
    outright (exact scores: int8 x int8). Apart from K5 (whose pools may
    hold one row twice), no id may repeat among a query's filled slots.
    ``allow`` (N,) allow bits: no filled slot of either version may hold a
    disallowed row. Every failed criterion is named in the error."""
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
    positional, ties, faults, score_tol = float(same.mean()), "", [], SCORE_TOL
    if exact is not None:
        qs_, ps_ = np.nonzero(live)
        own = [float((torch.as_tensor(vals[qs_, ps_]).double()
                      - exact(qs_, ids[qs_, ps_]).cpu()).abs().max())
               if qs_.size else 0.0 for vals, ids in ((v, i), (v_ref, i_ref))]
        score_tol = SCORE_TOL + own[1]
        tie = 2 * (own[0] + own[1]) if tie is None else tie
        qi, pos = np.nonzero(~same & live)
        # the kernel's id's exact score less the plain version's, per slot
        gap = (exact(qi, i[qi, pos]) - exact(qi, i_ref[qi, pos])).cpu().numpy()
        tied = gap >= -tie
        same[qi[tied], pos[tied]] = True
        total = float(gap.sum())  # equal ids add nothing
        ties = (f" ({positional:.5f} by position; {int(tied.sum())} of {gap.size} differing "
                f"ids within {tie:.3g} below exactly, lowest {gap.min(initial=0.0):.3g}; "
                f"exact sum of the kernel's ids less the plain's {total:.3g}; max |f32 - exact|: "
                f"kernel {own[0]:.3g}, plain {own[1]:.3g})")
        if own[0] > SCORE_TOL:
            faults.append(f"the kernel's scores are not its ids' exact scores (max |f32 - "
                          f"exact| {own[0]:.3g})")
        if positional < id_floor:
            faults.append(f"ids {positional:.5f} equal by position < {id_floor}")
        if total < -tie:
            faults.append(f"the exact scores of its ids sum {total:.3g} below the plain's")
    match = float(same.mean())
    near_tie = np.all(np.abs(v - v_ref)[~same & live] <= score_tol)
    if match < ID_MATCH_FLOOR:
        faults.append(f"ids {match:.5f} equal < {ID_MATCH_FLOOR}")
    if err > score_tol:
        faults.append(f"max |dscore| {err:.3g} > {score_tol:.3g}")
    if not near_tie:
        faults.append("a differing id is not a near-tie")
    if not name.startswith("K5"):  # pools may hold one row twice; no other scan may
        ids = np.sort(np.where(live, i, -1 - np.arange(i.shape[1])), axis=1)
        if (np.diff(ids, axis=1) == 0).any():
            faults.append("an id repeats within a query's results")
    if allow is not None:
        ok = allow.reshape(-1).cpu().numpy() != 0
        for who, ids in (("kernel", i), ("plain version", i_ref)):
            if not ok[ids[live]].all():
                faults.append(f"the {who} returned a disallowed row")
    if equal and not (np.array_equal(v, v_ref) and np.array_equal(i, i_ref)):
        faults.append(f"values and ids not equal outright ({int((v != v_ref).sum())} values, "
                      f"{int((i != i_ref).sum())} ids differ)")
    elif equal:
        ties = "; values and ids equal outright"
    if faults:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: "
                             + "; ".join(faults) + ties)
    if quiet:
        c = CHECKS.setdefault(name.split()[0], [0, 1.0, 0.0, 0.0, 0.0])
        c[0], c[1], c[2] = c[0] + 1, min(c[1], match), max(c[2], err)
        if exact is not None:
            c[3], c[4] = max(c[3], own[0]), max(c[4], own[1])
    else:
        log(f"[kernel] {name}: ids {match:.5f} equal{ties}, max |dscore| {err:.3g}, "
            f"mismatches near-ties: {bool(near_tie)}")
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
            lambda: band.tiles_topk_resid_reference(**a, k=K, l_buckets=lb), quiet=True,
            exact=resid_exact(a)))
    return err


def variant_args(a: dict, variant: str, rng) -> dict:
    """K1's arguments ``a`` with a variant's options; 'masked' (and 'all')
    draw a 50% row mask from ``rng``. The l2 key adds -s^2 |r|^2 / 2: over
    full-range random int8 rows at the small checks' scale it reaches ~800,
    where one f32 step is 6e-5, so l2 takes a tenth of the scale (keys of
    ~10, as unit-norm data's are of ~1) to stay inside SCORE_TOL's absolute
    hold."""
    if variant == "all":
        out = dict(a, int8_q=False, l2=True, top2=True)
    else:
        out = dict(a, **VARIANTS[variant])
    if out.get("l2"):
        out["resid_scale"] = a["resid_scale"] / 10
    if variant in ("masked", "all"):
        n = a["db_resid"].shape[0]
        out["row_mask"] = torch.as_tensor((rng.random(n) < 0.5).astype(np.int8),
                                          device=a["db_resid"].device)
    return out


#: K1's variant checks at small shapes: (name, random_resid_inputs shape,
#: l_buckets, k): windows of 1, 3 and 129 lists, R 1, 4 and 8, D 768, 256,
#: 128 and 100, k above L (top-2's second slots rank)
RESID_VARIANT_CASES = [
    ("R1_W3_D768", dict(), 0, K),
    ("R4_W3_D768", dict(), 512, K),
    ("R1_W1", dict(w=1, d=256), 0, K),
    ("R4_W129", dict(w=129, d=128), 512, K),
    ("R8_L32_k48", dict(tile_n=256, d=128), 32, 48),
    ("R1_tq48_D100", dict(tile_q=48, nq=96, d=100), 0, K),
]


def resid_variant_checks(dev) -> float:
    """K1's contract variants ('precise', row mask, l2, top-2, and all four
    together) against the plain version on small shapes, ids held through
    their exact f64 scores; the table repeats an entry (twice, adjacent, for
    top-2)."""
    err = 0.0
    for seed, (name, shape, lb, k) in enumerate(RESID_VARIANT_CASES):
        for variant in (*VARIANTS, "all"):
            a = random_resid_inputs(700 + seed, dev, **shape)
            a["tile_table"][:, 1] = a["tile_table"][:, 0]
            args = variant_args(a, variant, np.random.default_rng(seed))
            err = max(err, compare(
                f"K1 {variant} {name}", lambda: band.tiles_topk_resid(**args, k=k, l_buckets=lb),
                lambda: band.tiles_topk_resid_reference(**args, k=k, l_buckets=lb),
                quiet=True, exact=resid_exact(args)))
    return err


def bias_compare(label: str, db, local, ct, scale: float, tile_n: int) -> float:
    """K1's l2 bias kernel against its plain version and the exact f64
    bias (``resid_bias_exact``): each within BIAS_TOL x max(1, |exact|) of
    it; the kernel must count a launch. Returns max |kernel - plain|."""
    before = band.resid_row_bias.launches
    plain = band.resid_row_bias_reference(db, local, ct, scale, tile_n)
    kern = band.resid_row_bias(db, local, ct, scale, tile_n)
    sync()
    if band.resid_row_bias.launches != before + 1:
        raise AssertionError(f"K1b {label}: the kernel was not launched once")
    exact = torch.cat([resid_bias_exact(db, local, ct, scale, tile_n,
                                        torch.arange(s0, min(s0 + (1 << 18), db.shape[0]),
                                                     device=db.device))
                       for s0 in range(0, db.shape[0], 1 << 18)])
    off = [float(((x.double() - exact).abs() / exact.abs().clamp_min(1.0)).max())
           for x in (kern, plain)]
    if max(off) > BIAS_TOL:
        raise AssertionError(f"K1b {label}: relative distance from the exact bias: kernel "
                             f"{off[0]:.3g}, plain {off[1]:.3g} > {BIAS_TOL}")
    err = float((kern - plain).abs().max())
    log(f"[kernel] K1b {label}: max |kernel - plain| {err:.3g}; relative distance from the "
        f"exact f64 bias: kernel {off[0]:.3g}, plain {off[1]:.3g} (tolerance {BIAS_TOL})")
    return err


def pq_bias_exact(codes, local, cb, ct, tile_n: int, rows: torch.Tensor) -> torch.Tensor:
    """f64 -|x|^2/2 of arena rows ``rows``: x the bf16 codewords plus the
    bf16 centroid row of the row's local byte (ct None: no centroid term),
    exactly."""
    cbd = cb.to(torch.bfloat16).double()
    x = cbd[torch.arange(cbd.shape[0], device=cbd.device), codes[rows].long()].reshape(
        rows.numel(), -1)
    if ct is not None:
        x = x + ct.to(torch.bfloat16).double()[rows // tile_n, local.reshape(-1)[rows].long()]
    return -0.5 * (x * x).sum(1)


def pq_bias_compare(label: str, codes, local, cb, ct, tile_n: int, quiet: bool = False) -> float:
    """K5's l2 bias kernel (pq_row_bias) against its plain version and the
    exact f64 bias: each within BIAS_TOL x max(1, |exact|) of it; the kernel
    must count a launch. Returns max |kernel - plain|."""
    before = pq.pq_row_bias.launches
    plain = pq.pq_row_bias_reference(codes, local, cb, ct, tile_n)
    kern = pq.pq_row_bias(codes, local, cb, ct, tile_n)
    sync()
    if pq.pq_row_bias.launches != before + 1:
        raise AssertionError(f"K5b {label}: the kernel was not launched once")
    n = codes.shape[0]
    exact = torch.cat([pq_bias_exact(codes, local, cb, ct, tile_n,
                                     torch.arange(s0, min(s0 + (1 << 16), n), device=codes.device))
                       for s0 in range(0, n, 1 << 16)])
    off = [float(((x.double() - exact).abs() / exact.abs().clamp_min(1.0)).max())
           for x in (kern, plain)]
    if max(off) > BIAS_TOL:
        raise AssertionError(f"K5b {label}: relative distance from the exact bias: kernel "
                             f"{off[0]:.3g}, plain {off[1]:.3g} > {BIAS_TOL}")
    err = float((kern - plain).abs().max())
    c = CHECKS.setdefault("K5b", [0, 1.0, 0.0, 0.0, 0.0])
    c[0], c[2], c[3], c[4] = c[0] + 1, max(c[2], err), max(c[3], off[0]), max(c[4], off[1])
    if not quiet:
        log(f"[kernel] K5b {label}: max |kernel - plain| {err:.3g}; relative distance from "
            f"the exact f64 bias: kernel {off[0]:.3g}, plain {off[1]:.3g} (tolerance "
            f"{BIAS_TOL})")
    return err


def bias_checks(dev) -> float:
    """The bias kernel on K1's small random inputs (rows not unit-norm,
    D 768, 256, 100)."""
    err = 0.0
    for seed, shape in enumerate((dict(), dict(w=1, d=256), dict(w=129, d=100, tile_n=256))):
        a = random_resid_inputs(800 + seed, dev, **shape)
        err = max(err, bias_compare(f"D{a['db_resid'].shape[1]} W{a['centroid_tiles'].shape[1]}",
                                    a["db_resid"], a["local_ids"], a["centroid_tiles"],
                                    a["resid_scale"], a["tile_n"]))
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
                lambda: flat.flat_topk_reference(db, q, K, metric=metric, l_buckets=lb),
                quiet=True))
    return err


#: K3/K7 small shapes (l_buckets, D, tile_q): R 1, 4 and 8; D 768, 100, 99
#: (rows copied byte by byte) and 1000 (copied in 8-byte runs as int8); tile
#: queries 64, 48 (partial blocks) and 160 (int8: the wide block, 128 + 32)
TABLE_SHAPES = ((0, 768, 64), (512, 100, 48), (0, 99, 160), (256, 1000, 160))


def table_checks(dev) -> float:
    """K3 (tile table with repeated entries) and K7 (bands clamped at the
    arena end), every score mode, n_valid below the padded size."""
    modes = [(True, torch.int8, torch.int8), ("hybrid", torch.bfloat16, torch.int8),
             (False, torch.bfloat16, torch.bfloat16), (False, torch.float32, torch.float32)]
    err3 = err7 = 0.0
    for seed, (int8, qt, rt) in enumerate(modes):
        for lb, d, tile_q in TABLE_SHAPES:
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
            # int8 x int8 is exact; the bf16 pairs are held to exact scores
            hold = (dict(equal=True) if int8 is True else
                    dict(exact=wholerow_exact(db, q), tie=None) if qt == torch.bfloat16
                    else {})
            err3 = max(err3, compare(
                f"K3 {tag}", lambda: band.tiles_topk(db, q, table, K, **kw),
                lambda: band.tiles_topk_reference(db, q, table, K, **kw), quiet=True, **hold))
            # top-2 (k above L at R > 1): the tensor-core pairs on the
            # narrow block, the f32 pair on the CUDA-core body
            k2 = 2 * lb if lb else K
            err3 = max(err3, compare(
                f"K3 top2 {tag}", lambda: band.tiles_topk(db, q, table, k2, top2=True, **kw),
                lambda: band.tiles_topk_reference(db, q, table, k2, top2=True, **kw),
                quiet=True, **hold))
            starts = torch.tensor([1, n_tiles - 3], dtype=torch.int32, device=dev)
            err7 = max(err7, compare(
                f"K7 {tag}", lambda: band.band_topk(db, q, starts, K, 3, **kw),
                lambda: band.band_topk_reference(db, q, starts, K, 3, **kw), quiet=True,
                **hold))
    return max(err3, deep_top2_checks(dev)), err7


#: K3 top-2 on the CUDA-core body's other routes (int8, D, l_buckets,
#: tile_q): tensor-core pairs too deep for resident queries (hybrid and bf16
#: past D 2,752, int8 past 5,504), f32 x bf16 rows, and a hybrid state too
#: large for the narrow block at R 8
DEEP_TOP2_CASES = (("hybrid", torch.bfloat16, torch.int8, 3072, 512, 64),
                   (False, torch.bfloat16, torch.bfloat16, 2900, 0, 48),
                   (True, torch.int8, torch.int8, 5600, 256, 32),
                   (False, torch.float32, torch.bfloat16, 768, 256, 64),
                   ("hybrid", torch.bfloat16, torch.int8, 2600, 256, 32))


def deep_top2_checks(dev) -> float:
    err = 0.0
    for seed, (int8, qt, rt, d, lb, tile_q) in enumerate(DEEP_TOP2_CASES):
        rng = np.random.default_rng(300 + seed)
        n_tiles, tile_n, nq = 4, 2048, 2 * tile_q
        db = random_rows(rng, n_tiles * tile_n, d, rt, dev)
        q = random_rows(rng, nq, d, qt, dev)
        table = rng.integers(0, n_tiles, size=(2, 4)).astype(np.int32)
        table[:, -1] = table[:, 0]
        table = torch.as_tensor(table, device=dev)
        kw = dict(tile_n=tile_n, tile_q=tile_q, l_buckets=lb, int8=int8,
                  n_valid=n_tiles * tile_n - 700, top2=True)
        hold = (dict(equal=True) if int8 is True else
                dict(exact=wholerow_exact(db, q), tie=None) if qt == torch.bfloat16 else {})
        k2 = 2 * lb if lb else K
        err = max(err, compare(
            f"K3 top2 {int8!r} {qt} x {rt} L{lb or tile_n} D{d} tq{tile_q} "
            f"({scan_body(q, db, tile_q, tile_n // (lb or tile_n))})",
            lambda: band.tiles_topk(db, q, table, k2, **kw),
            lambda: band.tiles_topk_reference(db, q, table, k2, **kw), **hold))
    return err


def random_pq_inputs(seed, dev, *, m=64, nbits=8, dsub=12, tile_n=1024, n_tiles=5,
                     w=3, nq=64, tile_q=32, p=5, residual=True):
    """Random K5 inputs: codes, codebooks, local bytes rising through each
    tile's window, centroid tiles, a table with a repeated entry, n_valid
    cutting the last tile."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile_n
    local = np.zeros(n, np.uint8)
    for t in range(n_tiles):
        cuts = np.sort(rng.integers(0, tile_n, size=w - 1))
        local[t * tile_n:(t + 1) * tile_n] = np.searchsorted(cuts, np.arange(tile_n),
                                                             side="right")
    table = rng.integers(0, n_tiles, size=(nq // tile_q, p)).astype(np.int32)
    table[:, -1] = table[:, 0]  # plan padding repeats an entry
    table[0, 1] = n_tiles - 1
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    d = m * dsub
    ct = rng.normal(size=(n_tiles, w, d)).astype(np.float32) / np.sqrt(d)
    return dict(
        codes_cm=t(rng.integers(0, 2 ** nbits, size=(n, m), dtype=np.uint8)),
        codebooks=t(rng.normal(size=(m, 2 ** nbits, dsub)).astype(np.float32) / np.sqrt(d)),
        queries_sorted=t(rng.normal(size=(nq, d)).astype(np.float32) / np.sqrt(d)),
        tile_table=t(table), centroid_tiles=t(ct) if residual else None,
        local_ids=t(local) if residual else None, tile_n=tile_n, tile_q=tile_q,
        n_valid=n - tile_n // 3, row_major=True)


def k5_block_queries(a: dict) -> int:
    """The queries one block of K5 holds at pq_tiles_topk's arguments
    ``a`` (csrc/pq_scan.cu's rule, from the library)."""
    from cloudvectordb_tpu_torch.ops import _cuda

    cb, ct = a["codebooks"], a.get("centroid_tiles")
    return _cuda._load("pq_scan").cvdb_pq_scan_block_queries(
        a["tile_q"], a["tile_n"], a.get("l_buckets") or a["tile_n"], cb.shape[0], cb.shape[2],
        0 if ct is None else ct.shape[1], int(a.get("top2", False)),
        int(a.get("row_mask") is not None), int(a.get("l2", False)))


#: K5's 64-query block in the small checks: (tile_q, residual, pools,
#: top2, D 30), 256 queries, R = 1
PQ64_CASES = ((64, True, 2, True, False), (64, True, 1, True, False),
              (64, False, 2, True, False), (64, False, 1, False, False),
              (128, True, 2, True, False), (128, False, 1, True, False),
              (128, True, 1, False, False), (64, True, 2, True, True),
              (128, False, 2, True, True), (64, False, 1, False, True))


def pq_checks(dev) -> tuple[float, float]:
    """K5 (residual and not; pools 1, 2, 3; top-2 on and off; R 1 and > 1;
    repeated table entries; n_valid cutting a tile; D 768 at m 64 and a
    narrow D; dsub 5, D 30: one codebook value at a time, zeros past D,
    centroid rows of a width not a multiple of 4; at 32 queries a block,
    and at 64 (PQ64_CASES)) and K6 (ragged N, R 1 and 4; D 768 and D 30)."""
    err5 = 0.0
    cases = [(resid, pools, top2, lb, False, False) for resid in (True, False)
             for pools in (1, 2, 3) for top2 in (False, True) for lb in (0, 256)]
    cases += [(True, 2, True, 256, False, False), (True, 1, False, 0, False, False)]
    # the filtered and l2 variants (mask, l2, both, mask with top-2)
    cases += [(resid, pools, top2, lb, mask, l2) for resid in (True, False)
              for (pools, top2, lb, mask, l2) in ((1, False, 0, True, False),
                                                  (2, False, 256, False, True),
                                                  (3, False, 256, True, True),
                                                  (2, True, 256, True, False),
                                                  (1, True, 0, True, True))]
    odd = dict(m=6, dsub=5, tile_n=512, tile_q=48, nq=96)
    for seed, (resid, pools, top2, lb, mask, l2) in enumerate(cases):
        shape = (odd if seed in (24, 25) or seed >= 34 else dict() if seed % 3 else
                 dict(m=8, dsub=8, nbits=6, tile_n=512, tile_q=48, nq=96))
        a = random_pq_inputs(500 + seed, dev, residual=resid, **shape)
        n = a["codes_cm"].shape[0]
        if mask:  # a 20% filter and an all but empty tile
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            rm = (torch.rand(n, generator=g, device=dev) < 0.2).to(torch.int8)
            rm[:a["tile_n"]] = 0
            a["row_mask"] = rm
        kw = dict(k=4 * K, l_buckets=lb, n_pools=pools, top2=top2, l2=l2)
        err5 = max(err5, compare(
            f"K5 resid={resid} pools={pools} top2={top2} mask={mask} l2={l2} L{lb} "
            f"D{a['queries_sorted'].shape[1]}",
            lambda: pq.pq_tiles_topk(**a, **kw),
            lambda: pq.pq_tiles_topk_reference(**a, **kw), quiet=True,
            allow=a.get("row_mask")))
        if l2:
            args = (a["codes_cm"], a["local_ids"], a["codebooks"], a["centroid_tiles"],
                    a["tile_n"])
            err5 = max(err5, pq_bias_compare(f"D{a['queries_sorted'].shape[1]} resid={resid}",
                                             *args, quiet=True))
    for seed, (tq, resid, pools, top2, narrow) in enumerate(PQ64_CASES):
        shape = dict(m=6, dsub=5, tile_n=512) if narrow else {}
        a = random_pq_inputs(800 + seed, dev, residual=resid, nq=256, tile_q=tq, **shape)
        kw = dict(k=4 * K, n_pools=pools, top2=top2)
        if k5_block_queries({**a, **kw}) != 64:
            raise AssertionError(f"K5 tq{tq} D{a['queries_sorted'].shape[1]}: not 64 a block")
        err5 = max(err5, compare(
            f"K5 tq{tq} resid={resid} pools={pools} top2={top2} D{a['queries_sorted'].shape[1]}",
            lambda: pq.pq_tiles_topk(**a, **kw), lambda: pq.pq_tiles_topk_reference(**a, **kw),
            quiet=True))
    err5 = max(err5, pq_segment_checks(dev))
    err6 = 0.0
    for seed, (n, lb, m, dsub) in enumerate(((5000, 0, PQ_M, 12), (7777, 512, PQ_M, 12),
                                             (3001, 256, 6, 5))):
        rng = np.random.default_rng(600 + seed)
        d = m * dsub
        codes = torch.as_tensor(rng.integers(0, 256, size=(m, n), dtype=np.uint8), device=dev)
        cb = torch.as_tensor(rng.normal(size=(m, 256, dsub)).astype(np.float32) / np.sqrt(d),
                             device=dev)
        q = torch.as_tensor(rng.normal(size=(100, d)).astype(np.float32) / np.sqrt(d),
                            device=dev)
        err6 = max(err6, compare(
            f"K6 N{n} L{lb} D{d}", lambda: pq.pq_topk(codes, cb, q, K, l_buckets=lb),
            lambda: pq.pq_topk_reference(codes, cb, q, K, l_buckets=lb), quiet=True))
    return err5, err6


#: K5's segmented dispatch in the small checks: a five-tile arena cut at two
#: tiles (segments of 2, 2 and 1 tiles); (residual, top2, mask, l2), two pools
SEG_CASES = ((True, False, False, False), (True, False, True, False),
             (True, False, False, True), (True, True, False, False), (True, True, True, True),
             (False, True, True, True))


def pq_segment_checks(dev) -> float:
    """K5's segmented dispatch against its plain version (SEG_CASES), the
    table reading every segment; a launch a segment; the view form (the
    index's) equal outright to the reference's tuple form, each segment
    with a trailing pad tile its entries never read."""
    err = 0.0
    for seed, (resid, top2, mask, l2) in enumerate(SEG_CASES):
        a = random_pq_inputs(700 + seed, dev, residual=resid, p=6)
        tile_n = a["tile_n"]
        a["tile_table"][0] = torch.arange(6, device=dev) % 5  # every segment
        n = a["codes_cm"].shape[0]
        if mask:
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            a["row_mask"] = (torch.rand(n, generator=g, device=dev) < 0.2).to(torch.int8)
        rows = (2 * tile_n, 2 * tile_n, tile_n)
        kw = dict(k=4 * K, l_buckets=256, n_pools=2, top2=top2, l2=l2)
        before = pq.pq_tiles_topk.seg_launches
        err = max(err, compare(
            f"K5 seg resid={resid} top2={top2} mask={mask} l2={l2}",
            lambda: pq.pq_tiles_topk(**a, **kw, segments=rows),
            lambda: pq.pq_tiles_topk_reference(**a, **kw, segments=rows), quiet=True,
            allow=a.get("row_mask")))
        if pq.pq_tiles_topk.seg_launches - before != len(rows):
            raise AssertionError("K5 seg: not a launch a segment")
        pad = lambda x: torch.cat([x, torch.zeros_like(x[:tile_n])])  # noqa: E731
        tup = dict(a, codes_cm=[], centroid_tiles=[] if resid else None,
                   local_ids=[] if resid else None, row_mask=[] if mask else None, n_valid=[])
        off = 0
        for r in rows:
            sl = slice(off, off + r)
            tup["codes_cm"].append(pad(a["codes_cm"][sl]))
            if resid:
                ct = a["centroid_tiles"][off // tile_n:(off + r) // tile_n]
                tup["centroid_tiles"].append(torch.cat([ct, torch.zeros_like(ct[:1])]))
                tup["local_ids"].append(pad(a["local_ids"][sl]))
            if mask:
                tup["row_mask"].append(pad(a["row_mask"][sl]))
            tup["n_valid"].append(min(max(a["n_valid"] - off, 0), r))
            off += r
        v1, i1 = pq.pq_tiles_topk(**a, **kw, segments=rows)
        v2, i2 = pq.pq_tiles_topk(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in tup.items()}, **kw)
        if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
            raise AssertionError("K5 seg: the view form differs from the tuple form")
    return err


# -- K8: the PQ route's int8 rescore --------------------------------------------
#: K8 against its plain version (both sum the same exact f32 products in f32,
#: in other orders): every score within RESCORE_TOL x max(1, |plain|), -inf
#: exactly where the plain version has it; after the stable top-k the same,
#: a differing id only between scores within that, and at most
#: RESCORE_ID_DIFF of the filled slots (tests/port/test_torch_rescore.py's rule)
RESCORE_TOL = 1e-5
RESCORE_ID_DIFF = 0.01
#: (residual, l2), as ops/rescore.py's options
RESCORE_VARIANTS = {"resid-ip": (True, False), "resid-l2": (True, True),
                    "whole-ip": (False, False), "whole-l2": (False, True)}


def rescore_inputs(seed: int, dev, *, b: int, kc: int, d: int, n: int, nlist: int = 64,
                   tile_n: int = 16, w: int = 4) -> dict:
    """Random ``rescore.rescore_int8`` arguments on the device: int8 rows over
    the whole range, unit-scale queries and centroids, a planner order,
    per-tile windows and local bytes, 10% of the slots unfilled."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    kw = dict(device=dev, generator=g)
    v = torch.rand((b, kc), **kw)
    v = torch.where(torch.rand((b, kc), **kw) < 0.1, NEG_INF, v)
    return dict(
        q_s=torch.randn((b, d), **kw) / d ** 0.5, v=v, rows=torch.randint(0, n, (b, kc), **kw),
        refine_rows=torch.randint(-128, 128, (n, d), dtype=torch.int8, **kw),
        refine_scale=0.004, centroids=torch.randn((nlist, d), **kw) / d ** 0.5,
        dots=torch.randn((b, nlist), **kw), order=torch.randperm(b, **kw),
        tile_window=torch.randint(0, nlist, (-(-n // tile_n), w), **kw),
        local_ids=torch.randint(0, w, (n,), dtype=torch.uint8, **kw), tile_n=tile_n)


def rescore_compare(name: str, args: dict, residual: bool, l2: bool) -> float:
    """K8 (``rescore.rescore_int8`` on CUDA tensors, one launch) against its
    plain version (no launch) on ``args``, held as RESCORE_TOL says, the
    candidates' rows standing for ids after the top-k; returns max
    |Δscore| over the filled slots. Every failed criterion is named."""
    kw = dict(args, residual=residual, l2=l2)
    before = rescore.rescore_int8.launches
    ref = rescore.rescore_int8_reference(**kw)
    if rescore.rescore_int8.launches != before:
        raise AssertionError(f"{name}: the plain version launched the kernel")
    ex = rescore.rescore_int8(**kw)
    sync()
    if rescore.rescore_int8.launches != before + 1:
        raise AssertionError(f"{name}: not one kernel launch")
    faults = []

    def held(what, x, x_ref):
        live = torch.isfinite(x_ref)
        if not torch.equal(live, torch.isfinite(x)) or bool((x[~live] != NEG_INF).any()):
            faults.append(f"{what}: unfilled slots differ")
            return float("inf")
        gap = (x[live].double() - x_ref[live].double()).abs()
        tol = RESCORE_TOL * x_ref[live].double().abs().clamp_min(1.0)
        if bool((gap > tol).any()):
            faults.append(f"{what}: {int((gap > tol).sum())} scores past the tolerance, "
                          f"max |dscore| {float(gap.max()):.3g}")
        return float(gap.max()) if gap.numel() else 0.0

    err = held("scores", ex, ref)
    v, pos = topk_stable(ex, K)
    v_ref, pos_ref = topk_stable(ref, K)
    held("top-k", v, v_ref)
    rows = args["rows"]
    diff = (torch.gather(rows, 1, pos) != torch.gather(rows, 1, pos_ref)) & torch.isfinite(v_ref)
    share = float(diff.float().mean())
    if share > RESCORE_ID_DIFF:
        faults.append(f"{share:.4f} of the top-k ids differ > {RESCORE_ID_DIFF}")
    if faults:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: "
                             + "; ".join(faults))
    return err


def rescore_checks(dev) -> float:
    """K8 in its four variants against its plain version: a tiny shape, and
    9,000 slots a query (more than the kernel stages in shared memory at
    once); one line."""
    err, n = 0.0, 0
    for seed, (b, kc, d) in enumerate(((24, 40, 32), (6, 9000, 64))):
        for name, (residual, l2) in RESCORE_VARIANTS.items():
            a = rescore_inputs(800 + seed, dev, b=b, kc=kc, d=d, n=200)
            err = max(err, rescore_compare(f"K8 {name} B{b} k_cand {kc} D {d}", a, residual, l2))
            n += 1
    log(f"[kernel] K8 (rescore_int8) against its plain version on {n} small shapes: max "
        f"|dscore| {err:.3g} (tolerance {RESCORE_TOL} x max(1, |score|))")
    return err


def rescore_main_check(idx, st, queries, k5_args: dict, p_tiles: int, tq: int) -> dict:
    """K8 on K5's candidates at a PQ-route plan of config #3's index, with the
    arguments ``_pq_tiles_core`` gives it (rows clamped to the refine rows,
    the plan's order and query-centroid products), against its plain
    version, both timed (CUDA events), with its bound: the filled slots'
    int8 rows read once, plus the slots' row ids, values and scores and the
    queries, against one multiply-add a byte at the f32 rate."""
    _, order, dots, _ = _plan_tiles(idx._rotate(queries), st["centroids"], st["tile_window"],
                                    tq, p_tiles)
    v, rows = pq.pq_tiles_topk(**k5_args)
    q_s, refine = k5_args["queries_sorted"], st["refine"]
    args = dict(q_s=q_s, v=v, rows=rows.long().clamp(0, refine.shape[0] - 1),
                refine_rows=refine, refine_scale=idx._scale, centroids=st["centroids"],
                dots=dots, order=order, tile_window=st["tile_window"], local_ids=st["local"],
                tile_n=idx.tile_n)
    residual, l2 = idx._refine_residual, idx.metric == "l2"
    label = (f"resid={residual} l2={l2} B{q_s.shape[0]} p{p_tiles} tq{tq} k_cand "
             f"{rows.shape[1]} D {q_s.shape[1]}")
    err = rescore_compare(f"K8 {label}", args, residual, l2)
    kw = dict(args, residual=residual, l2=l2)
    plain_ms = time_ms(lambda: rescore.rescore_int8_reference(**kw), 1)
    ms = time_ms(lambda: rescore.rescore_int8(**kw), 5, inner=5)
    filled = int(torch.isfinite(v).sum())
    r = dict(err=err, ms=ms, plain_ms=plain_ms, shape=label,
             **bound(filled * q_s.shape[1] + v.numel() * (8 + 4 + 4) + nbytes(q_s),
                     2.0 * filled * q_s.shape[1], "f32"))
    log(f"[kernel] K8 {label}: kernel {ms:.3f} ms, plain version {plain_ms:.3f} ms; "
        f"{filled} of {v.numel()} slots filled; max |dscore| {err:.3g}; bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    return r


def small_kernel_checks(dev) -> dict:
    err = {"K1": max(resid_checks(dev), resid_variant_checks(dev)), "K2": flat_checks(dev),
           "K1b": bias_checks(dev)}
    err["K3"], err["K7"] = table_checks(dev)
    err["K5"], err["K6"] = pq_checks(dev)
    err["K5b"] = CHECKS["K5b"][2]
    err["K8"] = rescore_checks(dev)
    for key, (n, match, worst, own, own_plain) in CHECKS.items():
        if key == "K5b":
            log(f"[kernel] K5b (pq_row_bias) against its plain version on {n} small shapes: "
                f"max |kernel - plain| {worst:.3g}; relative distance from the exact f64 bias: "
                f"kernel {own:.3g}, plain {own_plain:.3g} (tolerance {BIAS_TOL})")
            continue
        exact = (f"; float pairs against exact f64 scores: max |f32 - exact| kernel {own:.3g}, "
                 f"plain {own_plain:.3g}" if own_plain else "")
        log(f"[kernel] {key} against its plain version on {n} small shapes: ids >= "
            f"{match:.5f} equal, max |dscore| {worst:.3g} (tolerance {SCORE_TOL}{exact})")
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


def attn_compare(name: str, q, k, v, mask, do, heads: int, d: int,
                 quiet: bool = False) -> float:
    """K4's forward and backward against the plain version on the same
    inputs; each must count one launch, the plain version none. Returns the
    largest |kernel - plain| over o, dq, dk and dv (``quiet``: no line)."""
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
    if not quiet:
        log(f"[kernel] {name}: max |kernel - plain| {', '.join(parts)}")
    return worst


def bwd_bit_identical(name: str, q, k, v, mask, do, heads: int, d: int) -> None:
    """Two runs of K4's backward on the same inputs must give the same bits
    (no atomics: every sum runs in one fixed order)."""
    runs = [attn_run(attn.mha_small_head, q, k, v, mask, do, heads, d)[1:] for _ in range(2)]
    sync()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{name}: two backward runs gave different gradients")


#: (H, d) per row type: bf16 also at d 16, so every width the tensor-core
#: kernels are compiled for is held
ATTN_HEADS = {torch.float32: ((12, 32), (12, 64)),
              torch.bfloat16: ((12, 16), (12, 32), (12, 64))}


def attn_checks(dev) -> float:
    """K4 at every shape the slice uses: L 128, 256, 512; (H, d) (12, 32)
    and (12, 64), and (12, 16) for bf16; f32 and bf16; ragged padding and a
    fully masked row; bf16 backward bit-identical across two runs."""
    err, seed, n = {}, 300, 0
    for length in (128, 256, 512):
        for dtype, shapes in ATTN_HEADS.items():
            for heads, d in shapes:
                seed += 1
                args = attn_inputs(seed, dev, 3, length, heads, d, dtype)
                name = f"K4 L{length} H{heads} d{d} {str(dtype)[6:]}"
                e = attn_compare(name, *args, heads, d, quiet=True)
                if dtype == torch.bfloat16:
                    bwd_bit_identical(name, *args, heads, d)
                err[dtype] = max(err.get(dtype, 0.0), e)
                n += 1
    log(f"[kernel] K4 forward and backward against the plain version at {n} shapes (L 128, "
        f"256, 512; d 32, 64, and 16 for bf16; f32, bf16; ragged and fully masked rows): max "
        f"|kernel - plain| f32 {err[torch.float32]:.3g}, bf16 {err[torch.bfloat16]:.3g}; "
        f"bf16 backward bit-identical across two runs at each")
    return max(err.values())


def time_ms(fn, reps: int, inner: int = 1) -> float:
    """Median CUDA-event time of fn() over reps, after one warm-up call. With
    ``inner`` > 1 each repetition times that many calls back to back and
    counts their mean: for calls shorter than a millisecond, so that the
    host's launch of one call overlaps the card's run of the one before."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def timed(fn):
    """fn with the CUDA-event time of its last call in ``.ms``."""
    def call():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        call.ms = start.elapsed_time(end)
        return out

    call.ms = None
    return call


def main_shape_check(key: str, label: str, kernel, plain, reps: int,
                     plain_reps: int, **hold) -> dict:
    """A kernel against its plain version at a main path's shape (``hold``:
    compare's exact, tie and equal), and both times (each the median of
    CUDA-event repetitions, one process, one card; with ``plain_reps`` 1
    the plain version's is its held call's)."""
    if plain_reps == 1:
        plain = timed(plain)
    err = compare(f"{key} {label}", kernel, plain, **hold)
    plain_ms = plain.ms if plain_reps == 1 else time_ms(plain, plain_reps)
    ms = time_ms(kernel, reps)
    log(f"[kernel] {key} {label}: kernel {ms:.3f} ms, plain version {plain_ms:.3f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms, shape=label)


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
def make_corpus(dev, chunk: int, d: int = D):
    """Deterministic chunk_fn on the device: the generating process of
    bench.py (latent 32, 256 centres, noise 0.3/sqrt(32), L2-normalised, at
    width ``d``), drawn from torch.Generators."""
    g = torch.Generator(device=dev)
    g.manual_seed(1000)
    w = torch.randn((LATENT, d), generator=g, device=dev) / LATENT ** 0.5
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


def exact_chunks_topk(chunk_fn, n_chunks: int, chunk: int, q: torch.Tensor, k: int = K,
                      metric: str = "ip"):
    """The exact f32 top-k (values, gids) of ``q`` over the chunks, TF32
    off: each tile's top-k by selection (``ivf_band._scan_topk``), ties to
    the lower gid."""
    best = None
    for ci in range(n_chunks):
        x = chunk_fn(ci)
        v, pos = ivf_band_module._scan_topk(lambda lo, hi: _score_block(q, x[lo:hi], metric),
                                            x.shape[0], k, q.shape[0])
        best = (v, pos + ci * chunk) if best is None else merge_topk(*best, v, pos + ci * chunk,
                                                                     k)
    return best


def exact_gt(chunk_fn, n_chunks: int, chunk: int, q: torch.Tensor, metric="ip"):
    return exact_chunks_topk(chunk_fn, n_chunks, chunk, q, metric=metric)[1].cpu().numpy()


def make_queries(chunk_fn, dev, batch: int) -> torch.Tensor:
    """Noisy copies of rows of the first chunk, L2-normalised."""
    g = torch.Generator(device=dev)
    g.manual_seed(7777)
    base = chunk_fn(0)
    d = base.shape[1]
    sel = torch.randint(0, base.shape[0], (batch,), generator=g, device=dev)
    q = base[sel] + (0.15 / d ** 0.5) * torch.randn((batch, d), generator=g, device=dev)
    return q / q.norm(dim=1, keepdim=True)


def queries_and_gt(chunk_fn, n_chunks: int, chunk: int, dev, batch: int):
    q = make_queries(chunk_fn, dev, batch)
    return q, exact_gt(chunk_fn, n_chunks, chunk, q[:min(NQ_GT, batch)])


def check_result(v, ids, batch: int, ntotal: int, label: str) -> None:
    v, ids = np.asarray(v), np.asarray(ids)
    if v.shape != (batch, K) or ids.shape != (batch, K):
        raise AssertionError(f"{label}: result shapes {v.shape}, {ids.shape}")
    if not np.isfinite(v).all() or ids.min() < 0 or ids.max() >= ntotal:
        raise AssertionError(f"{label}: non-finite scores or ids out of range")


def build_index(dev, chunk_fn, n_chunks, residual: bool):
    """The residual or whole-row BandIVFIndex over the corpus (nlist 4096);
    (index, seconds of the build)."""
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(
        chunk_fn, n_chunks, nlist=NLIST, kmeans_iters=10, residual=residual,
        device=dev)
    sync()
    build_s = time.perf_counter() - t0
    log(f"[{'resid' if residual else 'whole'}] built {idx.ntotal} x {D}, nlist {NLIST}: "
        f"{build_s:.1f} s, W={idx._tile_window.shape[1]}, {idx._tune_n_tiles()} tiles, "
        f"scale {idx._scale:.6g}")
    return idx, build_s


def build_and_tune(dev, chunk_fn, n_chunks, queries, residual: bool):
    idx, build_s = build_index(dev, chunk_fn, n_chunks, residual)
    report = tune_logged(idx, queries, "resid" if residual else "whole")
    return idx, report, build_s


def tune_logged(idx, queries, label: str, gt=None, target: float = 0.95) -> dict:
    """``tune(k=10, target_recall=target)`` against the index's own
    max-effort reference (or the exact ground truth ``gt``), logged in one
    line: the op point, the candidates walked and skipped by the cost proxy,
    and each finalist's host-API QPS."""
    t0 = time.perf_counter()
    report = idx.tune(queries.cpu().numpy(), k=K, target_recall=target, gt=gt)
    tried = report["tried"]
    skipped = sum("skipped" in r for r in tried)
    finals = ", ".join(f"{f['op']}: {f['qps']:.0f}" for f in report["finalists"])
    log(f"[{label}] tuned in {time.perf_counter() - t0:.1f} s: op {report['op']}, met "
        f"{report['met']}, {'self-relative' if gt is None else 'exact'} recall "
        f"{report['recall']:.4f}; walked "
        f"{len(tried) - skipped}, skipped {skipped}; finalists (qps) {finals}")
    return report


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
    p_tiles, tq, _ = idx._resolve_knobs(queries.shape[0], 32, 0, op.get("tile_q"))
    mp = k1_check(f"main path B{queries.shape[0]} p{p_tiles} tq{tq}", idx,
                  k1_plan(idx, queries, p_tiles, tq), reps=10, plain_reps=3)
    (_, ids_full), n_full = counted(lambda: idx.search_device(
        queries[:gt.shape[0]], K, p_tiles=idx._tune_n_tiles()))
    full = recall_at_k(ids_full.cpu().numpy(), gt)
    log(f"[resid] full coverage ({idx._tune_n_tiles()} tiles): recall@{K} {full:.4f}")
    out = run_resid_variants(dev, idx, chunk_fn, n_chunks, queries, gt, card, p_tiles, tq)
    return dict(launches={"K1": launches + n_full["K1"], **out["launches"]},
                mp={"K1": mp, **out["mp"]}, op=(p_tiles, tq),
                cell1=dict(centroids=idx.centroids, full_recall=full))


#: filtered search at full width: random filters by fraction of the gids,
#: and a correlated one, every row of CORRELATED_LISTS lists adjacent in the
#: locality order (a tenant clustered into few lists)
FILTER_FRACS = {"random 10%": 0.10, "random 0.1%": 0.001}
CORRELATED_LISTS = 32


def make_filters(idx, dev, n_ids: int = N_ROWS, n_rows: int = N_ROWS) -> dict:
    """name -> (n_ids,) bool allow mask by gid, on the device (the
    correlated window sized for an arena of ``n_rows``)."""
    g = torch.Generator(device=dev)
    g.manual_seed(4242)
    masks = {name: torch.rand(n_ids, generator=g, device=dev) < frac
             for name, frac in FILTER_FRACS.items()}
    # the window of adjacent lists whose rows come nearest an average window's
    sums = idx._offsets[CORRELATED_LISTS:] - idx._offsets[:-CORRELATED_LISTS]
    l0 = int(np.argmin(np.abs(sums - CORRELATED_LISTS * n_rows / idx.nlist)))
    rows = idx._ids[idx._offsets[l0]:idx._offsets[l0 + CORRELATED_LISTS]]
    corr = torch.zeros(n_ids, dtype=torch.bool, device=dev)
    corr[torch.as_tensor(rows[rows >= 0], device=dev)] = True
    masks[f"correlated {CORRELATED_LISTS} lists"] = corr
    return masks


def exact_pass(chunk_fn, n_chunks: int, chunk: int, q: torch.Tensor, masks: dict,
               need: torch.Tensor):
    """One pass over the corpus: the exact f32 top-K ids of ``q`` restricted
    to each allow mask (ip), its exact l2 top-K ids, and the corpus rows of
    the sorted gids ``need``. Returns ({name: ids}, l2 ids, rows)."""
    nq = q.shape[0]
    best = {name: (torch.full((nq, K), float("-inf"), device=q.device),
                   torch.zeros((nq, K), dtype=torch.int64, device=q.device))
            for name in (*masks, "l2")}
    rows = torch.zeros((need.numel(), D), device=q.device)
    for ci in range(n_chunks):
        x = chunk_fn(ci)
        base = ci * chunk
        for name in best:
            if name == "l2":
                cv, cidx = tiled_topk(x, q, K, metric="l2", tile=8192)
                best[name] = merge_topk(*best[name], cv, cidx + base, K)
                continue
            sel = masks[name][base:base + x.shape[0]].nonzero()[:, 0]
            if sel.numel():
                cv, cidx = tiled_topk(x[sel], q, K, metric="ip", tile=8192)
                best[name] = merge_topk(*best[name], cv, sel[cidx] + base, K)
        here = (need >= base) & (need < base + x.shape[0])
        rows[here] = x[need[here] - base]
    gts = {name: b[1].cpu().numpy() for name, b in best.items()}
    return gts, gts.pop("l2"), rows


def check_filtered(v, ids, allow: torch.Tensor, label: str) -> None:
    """No returned id is disallowed; unfilled slots are exactly (-inf, -1)."""
    filled = ids >= 0
    if not torch.equal(filled, torch.isfinite(v)) or not bool(
            torch.isneginf(v[~filled]).all()):
        raise AssertionError(f"{label}: unfilled slots are not (-inf, -1)")
    if not bool(allow[ids[filled].long()].all()):
        raise AssertionError(f"{label}: a disallowed id was returned")


def counted(fn):
    """fn() with every wrapper's launch count reset just before and read
    just after: (result, {wrapper key: launches})."""
    reset_launches()
    out = fn()
    sync()
    return out, {k: w.launches for k, w in WRAPPERS.items()}


def run_resid_variants(dev, idx, chunk_fn, n_chunks, queries, gt, card, p_tiles: int,
                       tq: int, reps: int = 5) -> dict:
    """Cell 1's filtered, 'precise', top-2 and l2 searches on the residual
    index, each path's launch counts reset just before and read just after;
    recall against exact ground truth from one pass over the corpus; then K1
    at each variant's plan and the l2 bias kernel against their plain
    versions, timed, with their bounds."""
    n_gt = gt.shape[0]
    masks = make_filters(idx, dev)
    res, launches = {}, {}
    flts = {}
    for name, m in masks.items():
        flts[name] = flt = idx.make_filter(m.cpu().numpy())
        t0 = time.perf_counter()
        rm = idx._arena_filter(flt)[0]
        sync()
        gather_s = time.perf_counter() - t0
        hit = idx._arena_filter(flt)[0] is rm
        (v, ids), n = counted(lambda: idx.search_device(queries, K, where=flt))
        qps = qps_device(lambda q: idx.search_device(q, K, where=flt), queries, reps=reps)
        check_filtered(v, ids, m, f"resid filtered {name}")
        live = int(rm.reshape(-1, idx.tile_n).amax(dim=1).gt(0).sum())
        res[name] = dict(ids=ids[:n_gt].cpu().numpy(), qps=qps, gather_s=gather_s, hit=hit,
                         live=live, n=int(m.sum()), launches=n["K1"])
    name10 = "random 10%"
    p_all = idx._tune_n_tiles()
    (v, ids), _ = counted(lambda: idx.search_device(queries[:n_gt], K, where=flts[name10],
                                                    p_tiles=p_all))
    check_filtered(v, ids, masks[name10], f"resid filtered {name10} full coverage")
    res[name10]["ids_full"] = ids.cpu().numpy()
    launches["K1 masked"] = sum(r["launches"] for r in res.values())

    # 'precise' and top-2 at the op point
    mp = {}
    for key, kw in (("K1 precise", dict(scoring="precise")), ("K1 top2", dict(top2=True))):
        (recall, qps), n = counted(lambda: serve(idx, queries, gt, reps, f"resid {key[3:]}",
                                                 **kw))
        launches[key] = n["K1"]
        if recall < RECALL_FLOOR:
            raise AssertionError(f"residual {key[3:]} recall {recall:.4f} < {RECALL_FLOOR}")

    # l2: a view of the same arena (the build never reads the metric); the
    # device tensors are shared, the caches are its own
    l2 = copy.copy(idx)
    l2.metric, l2._flt_cache, l2._bias_cache = "l2", {}, None
    (v_l2, ids_l2), n = counted(lambda: l2.search_device(queries, K))
    launches["K1 l2"], launches["K1b"] = n["K1"], n["K1b"]
    qps_l2 = qps_device(lambda q: l2.search_device(q, K), queries, reps=reps)
    check_result(v_l2.cpu().numpy(), ids_l2.cpu().numpy(), queries.shape[0], idx.ntotal,
                 "resid l2")

    q_gt = queries[:n_gt]
    need = torch.unique(ids_l2[:n_gt].long())
    t0 = time.perf_counter()
    gts, gt_l2, rows = exact_pass(chunk_fn, n_chunks, CHUNK, q_gt, masks, need)
    log(f"[resid] exact filtered and l2 ground truth on {n_gt} queries, one pass over "
        f"{N_ROWS} rows: {time.perf_counter() - t0:.1f} s")
    for name, r in res.items():
        recall = recall_at_k(r["ids"], gts[name])
        extra = ""
        if "ids_full" in r:
            full = recall_at_k(r["ids_full"], gts[name])
            extra = f"; at full coverage (p_tiles {p_all}) {full:.4f}"
            if full < RECALL_FLOOR:
                raise AssertionError(f"{name} filter at full coverage: recall {full:.4f}")
        log(f"[resid] filtered {name} ({r['n']} allowed ids, {r['live']} of {p_all} tiles "
            f"live): recall@{K} vs exact filtered f32 {recall:.4f} at the op point{extra}; mask "
            f"gather {r['gather_s'] * 1e3:.1f} ms host clock, then cache hit {r['hit']}; device "
            f"QPS {r['qps']['qps']:.1f} (median {r['qps']['ms_median']:.3f} ms); K1 launches "
            f"{r['launches']}; no disallowed id, unfilled slots (-inf, -1)")
        if not r["hit"]:
            raise AssertionError(f"{name}: the mask cache missed on a second call")
        if name.startswith("correlated") and recall < RECALL_FLOOR:
            raise AssertionError(f"correlated filter recall {recall:.4f} < {RECALL_FLOOR}")
    recall_l2 = recall_at_k(ids_l2[:n_gt].cpu().numpy(), gt_l2)
    same = float((np.sort(gt_l2, 1) == np.sort(gt, 1)).mean())
    pos = torch.searchsorted(need, ids_l2[:n_gt].long())
    exact_l2 = -((q_gt[:, None, :].double() - rows[pos].double()) ** 2).sum(2)
    l2_err = float((v_l2[:n_gt].double() - exact_l2).abs().max())
    log(f"[resid l2] recall@{K} vs exact f32 l2 ground truth {recall_l2:.4f} (the corpus is "
        f"unit-norm, so that ground truth is the ip one: {same:.4f} of its ids equal); max "
        f"|score - exact -|q - x|^2| over the returned ids {l2_err:.3g} (x the corpus row: "
        f"quantization included); device QPS {qps_l2['qps']:.1f} (median "
        f"{qps_l2['ms_median']:.3f} ms); K1 launches {launches['K1 l2']}, bias launches "
        f"{launches['K1b']}")
    if recall_l2 < RECALL_FLOOR:
        raise AssertionError(f"residual l2 recall {recall_l2:.4f} < {RECALL_FLOOR}")

    # K1's variants and the bias kernel at full shape
    st = idx._device_state()
    kern_bias = l2._arena_row_bias()
    plain_bias = band.resid_row_bias_reference(st["payload"], st["local"],
                                               st["centroid_tiles"], idx._scale, idx.tile_n)
    err = bias_compare(f"{N_ROWS} x {D} arena", st["payload"], st["local"],
                       st["centroid_tiles"], idx._scale, idx.tile_n)
    n_pad = st["payload"].shape[0]
    mp["K1b"] = dict(err=err, shape=f"{n_pad} x {D} arena", **bias_times(st, idx))
    rm10 = idx._arena_filter(flts[name10])[0]
    for key, variant in (("K1 precise", "precise"), ("K1 masked", "masked"),
                         ("K1 l2", "l2"), ("K1 top2", "top2")):
        args = dict(k1_plan(idx, queries, p_tiles, tq,
                            row_mask=rm10 if variant == "masked" else None),
                    **VARIANTS[variant])
        kw = {}
        if variant == "l2":
            kw = dict(kernel_kw=dict(row_bias=kern_bias), plain_kw=dict(row_bias=plain_bias))
        mp[key] = k1_check(f"{variant} B{queries.shape[0]} p{p_tiles} tq{tq}", idx, args,
                           reps=5, plain_reps=1, **kw)
    return dict(launches=launches, mp=mp)


def bias_times(st: dict, idx) -> dict:
    """The l2 bias kernel and its plain version timed over the whole arena,
    with its bound: rows, local ids and centroid tiles read, the bias
    written; 4 operations a dim (three sums)."""
    args = (st["payload"], st["local"], st["centroid_tiles"], idx._scale, idx.tile_n)
    ms = time_ms(lambda: band.resid_row_bias(*args), 5)
    plain_ms = time_ms(lambda: band.resid_row_bias_reference(*args), 2)
    n = st["payload"].shape[0]
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(nbytes(st["payload"], st["local"], st["centroid_tiles"]) + 4 * n,
                       6.0 * n * D, "f32"))
    log(f"[kernel] K1b over {n} x {D}: kernel {ms:.3f} ms, plain version {plain_ms:.3f} ms; "
        f"bound {out['bound_ms']:.3f} ms ({out['bound_by']})")
    return out


def k1_plan(idx, queries, p_tiles: int, tq: int, row_mask=None) -> dict:
    """tiles_topk_resid's arguments (but k) for the residual index's tiles
    search at (p_tiles, tile_q)."""
    st = idx._device_state()
    live = None if row_mask is None else row_mask.reshape(-1, idx.tile_n).amax(dim=1) > 0
    q_s, _, _, table = _plan_tiles(queries, st["centroids"], st["tile_window"], tq, p_tiles,
                                   tile_live=live)
    out = dict(db_resid=st["payload"], local_ids=st["local"],
               centroid_tiles=st["centroid_tiles"], resid_scale=idx._scale, queries_sorted=q_s,
               tile_table=table, valid_end=st["valid_end"], tile_n=idx.tile_n, tile_q=tq)
    return out if row_mask is None else dict(out, row_mask=row_mask)


def resid_bias_exact(db, local, ct, scale: float, tile_n: int, rows: torch.Tensor):
    """f64 l2 bias of arena ``rows``: -s^2 |r|^2 / 2 - s (c . r) - |c|^2 / 2
    on the int8 rows, their bf16 list centroids and the f32 scale, without
    rounding."""
    s = float(np.float32(scale))
    r = db[rows].double()
    c = ct.to(torch.bfloat16)[rows // tile_n, local.reshape(-1)[rows].long()].double()
    return -0.5 * s * s * (r * r).sum(1) - s * (c * r).sum(1) - 0.5 * (c * c).sum(1)


def resid_exact(args: dict):
    """(query indices, arena rows) -> f64 scores of the function K1 computes
    on ``args`` (tiles_topk_resid's arguments, options included), on the
    bf16 queries, centroid tiles, int8 (or, int8_q=False, bf16) queries and
    row scales it takes, without rounding: f64(bf16 q) . f64(bf16
    ct[g // tile_n, local[g]]) + f64(row_scale) . (q' . r8[g]), plus the
    exact l2 bias with l2; -inf where g >= valid_end[g // tile_n, local[g]]
    or the row mask's bit is 0."""
    q_bf, q8, rs = band._quantize_queries(args["queries_sorted"], args["resid_scale"])
    if not args.get("int8_q", True):
        q8, rs = q_bf, torch.full_like(rs, float(np.float32(args["resid_scale"])))
    qd, q8d, rsd = q_bf.double(), q8.double(), rs.double()
    ct = args["centroid_tiles"].to(torch.bfloat16)
    payload, tile_n, valid_end = args["db_resid"], args["tile_n"], args["valid_end"]
    local = args["local_ids"].reshape(-1)
    mask = args.get("row_mask")
    mask = None if mask is None else mask.reshape(-1)

    def score(qi, rows):
        qi, rows = (torch.as_tensor(a, device=payload.device).long() for a in (qi, rows))
        out = []
        for s in range(0, rows.numel(), 1 << 16):
            g, q = rows[s:s + (1 << 16)], qi[s:s + (1 << 16)]
            t, li = g // tile_n, local[g].long()
            c = (ct[t, li].double() * qd[q]).sum(dim=1)
            r = (payload[g].double() * q8d[q]).sum(dim=1) * rsd[q]
            x = c + r
            if args.get("l2"):
                x = x + resid_bias_exact(payload, local, ct, args["resid_scale"], tile_n, g)
            live = g < valid_end[t, li].long()
            if mask is not None:
                live = live & (mask[g] != 0)
            out.append(torch.where(live, x, float("-inf")))
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)

    return score


def k1_check(label: str, idx, args: dict, reps: int, plain_reps: int,
             kernel_kw: dict | None = None, plain_kw: dict | None = None) -> dict:
    """K1 against its plain version on ``args`` (a residual-int8 arena of
    ``idx``, a tile plan and a variant's options; ``kernel_kw`` and
    ``plain_kw`` go to one side each: each version's own l2 bias), its ids
    held through their exact f64 scores (``resid_exact``, as EXACT_TIE
    says), both timed, with its bound: the rows, local ids, centroid tiles
    and valid_end of the tiles read, plus a byte a row of mask or four of
    bias; the operations at the int8 peak, or the bf16 one for 'precise'."""
    q_s, table, tq = args["queries_sorted"], args["tile_table"], args["tile_q"]
    mp = main_shape_check("K1", label,
                          lambda: band.tiles_topk_resid(**args, **(kernel_kw or {}), k=K),
                          lambda: band.tiles_topk_resid_reference(**args, **(plain_kw or {}), k=K),
                          reps=reps, plain_reps=plain_reps, exact=resid_exact(args))
    used, macs = table_work(table, tq, idx.tile_n, D)
    w = args["centroid_tiles"].shape[1]  # per tile: rows, local ids, centroids, valid_end
    side = (1 if args.get("row_mask") is not None else 0) + (4 if args.get("l2") else 0)
    kind = "int8" if args.get("int8_q", True) else "bf16"
    mp.update(bound(used * (idx.tile_n * (D + 1 + side) + w * (2 * D + 4))
                    + nbytes(q_s, table) + q_s.shape[0] * K * 8, 2.0 * macs, kind))
    ops = 2.0 * q_s.shape[0] * table.shape[1] * idx.tile_n * D
    log(f"[kernel] K1 {label}: {ops / mp['ms'] / 1e9:.1f} T {kind} ops/s; bound "
        f"{mp['bound_ms']:.3f} ms ({mp['bound_by']}): {used} of {idx._tune_n_tiles()} tiles "
        f"read")
    return mp


# -- cell 14: sharded serving (parallel/) -----------------------------------------
SHARDS = 4
#: the sharded search plans every query group at the index's tile_q (it has
#: no tile_q knob, as the reference's); cell 1's op point runs tile_q 32
SHARD_TILE_Q = 32
#: (b)-(d) run on cell 1's first MH_CHUNKS chunks (1M rows), (b) at a
#: partial budget of MH_P_TILES tiles a shard and at full coverage
MH_CHUNKS, MH_P_TILES = 2, 32
MH_TIMEOUT_S = 300
#: cell 14 (a): full coverage over 4 shards may read this much below cell
#: 1's single index at full coverage, no more
SHARD_FULL_SLACK = 0.005
#: (c): K2 keeps one row a bucket of its tile_n-row tiles; the collision-aware
#: exact top-K is drawn from this many exact candidates a query
FLAT_POOL, K2_TILE_N = 32, 2048
SHARD_GROUPS = {"K1": ("resid_",), "GEMM": ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_"),
                "sort and top-k": ("sort", "radix", "topk", "scan")}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_worker(rank: int, world: int, port: int, tmp: str, device: str,
                   task: str = "band") -> None:
    """One of two processes on the one card (gloo; what crosses, crosses
    through host memory), every collective in step on both, ended by
    ``shutdown_multihost``; it writes its results for the parent. ``task``
    'band', cell 14 (b): loads the two shards its mesh slots hold of the
    saved 4-shard index, searches the saved queries at the partial and the
    full plan (a warm-up first), times the search and the partials' gather
    (host clock, fenced). 'cascade' and 'dp': cells 15 and 16
    (``cascade_worker``, ``dp_worker``)."""
    from cloudvectordb_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=120)
    try:
        # two processes of one host on its one card: the mapping takes gloo
        if torch.distributed.get_backend() != "gloo":
            raise AssertionError(f"two processes on one card chose "
                                 f"{torch.distributed.get_backend()}, not gloo")
        tmp = Path(tmp)
        if task != "band":
            worker = {"cascade": cascade_worker, "dp": dp_worker}[task]
            np.savez(tmp / f"res_{rank}.npz", **worker(rank, world, tmp, torch.device(device)))
            return
        idx = load_index(tmp / "index", mesh=mesh_mod.make_mesh(SHARDS, devices=[device]))
        q = np.load(tmp / "queries.npy")
        out = dict(held=np.array(sum(sh is not None for sh in idx._shards)))
        idx.search(q, K, p_tiles=MH_P_TILES)
        for name, p_tiles in (("part", MH_P_TILES), ("full", idx._n_tiles())):
            (v, i), _, host_s = fenced(lambda: idx.search(q, K, p_tiles=p_tiles))
            out.update({f"{name}_v": v, f"{name}_i": i, f"{name}_ms": np.array(host_s * 1e3)})
        v = torch.zeros((2, q.shape[0], K), device=idx.device)
        times = []
        for _ in range(5):
            _, _, host_s = fenced(lambda: mesh_mod._gather_partials(v, v.long(), idx.mesh))
            times.append(host_s * 1e3)
        out["gather_ms"] = np.array(np.median(times))
        np.savez(tmp / f"res_{rank}.npz", **out)
    finally:
        mesh_mod.shutdown_multihost()


def run_two_processes(tmp: Path, device: torch.device, task: str = "band") -> list:
    """Two spawned processes running ``sharded_worker``'s ``task``, each
    bounded by MH_TIMEOUT_S (a hung collective fails the run); every
    process stopped before return. Their result files."""
    ctx = torch.multiprocessing.start_processes(
        sharded_worker, args=(2, free_port(), str(tmp), str(device), task), nprocs=2,
        join=False, start_method="spawn")
    deadline = time.monotonic() + MH_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"two-process run still going after {MH_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    return [dict(np.load(tmp / f"res_{r}.npz")) for r in range(2)]


def bucket_keys(idx) -> np.ndarray:
    """gid -> K1's slot at full coverage in a sharded residual index: shard
    and arena position modulo tile_n (one slot a bucket, the rows of a
    bucket a tile apart); -1 for ids it does not hold."""
    keys = np.full(max(m["gid_bound"] for m in idx._meta), -1, np.int64)
    for si, sh in enumerate(idx._shards):
        ids = np.asarray(sh._ids, np.int64)
        pos = np.flatnonzero(ids >= 0)
        keys[ids[pos]] = si * sh.tile_n + pos % sh.tile_n
    return keys


def collisions_explain(ids_a: np.ndarray, ids_b: np.ndarray, keys_a: np.ndarray,
                       keys_b: np.ndarray) -> tuple[int, int]:
    """(queries whose ids differ, those whose difference no bucket collision
    explains) between two layouts of the same rows searched at full
    coverage: each layout returns the exact top-K of its scores but where two
    rows of a query's top-K share one of its K1 slots, so where the two
    differ, an id one returns and the other misses must share the other's
    slot with an id that the other returns."""
    differ = np.flatnonzero((np.sort(ids_a, 1) != np.sort(ids_b, 1)).any(axis=1))
    bad = 0
    for qi in differ:
        a, b = set(ids_a[qi].tolist()), set(ids_b[qi].tolist())
        slots_a = {keys_a[g] for g in a}
        slots_b = {keys_b[g] for g in b}
        if not (any(keys_b[g] in slots_b for g in a - b)
                or any(keys_a[g] in slots_a for g in b - a)):
            bad += 1
    return int(differ.size), bad


def flat_collision_truth(x: torch.Tensor, q: torch.Tensor, rps: int):
    """(scores (Q, K), ids (Q, K), colliding queries) of the exact f32 top-K
    under K2's rule on each shard of ``rps`` rows: rows of one shard whose
    offsets agree modulo K2_TILE_N share one slot, and only the best of them
    (the lower row on a tie) can surface. Drawn from each query's FLAT_POOL
    exact candidates, in blocks of 512 queries."""
    outs, n_coll = [], 0
    earlier = torch.ones(FLAT_POOL, FLAT_POOL, device=x.device).tril(-1).bool()
    for s in range(0, q.shape[0], 512):
        v, g = topk_stable_select(exact_scores(x, q[s:s + 512]), FLAT_POOL)
        slot = (g // rps) * K2_TILE_N + (g % rps) % K2_TILE_N
        shadowed = ((slot[:, :, None] == slot[:, None, :]) & earlier[None]).any(dim=2)
        key = torch.where(shadowed, FLAT_POOL, torch.arange(FLAT_POOL, device=x.device))
        pos = torch.sort(key, dim=1, stable=True).indices[:, :K]
        n_coll += int(shadowed[:, :K].any(dim=1).sum())
        outs.append((torch.gather(v, 1, pos), torch.gather(g, 1, pos)))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]), n_coll


def check_flat_exact(ids: np.ndarray, x: torch.Tensor, q: torch.Tensor, tv: torch.Tensor,
                     tids: torch.Tensor, label: str) -> None:
    """Ids must be the collision-aware exact top-K's (``flat_collision_truth``),
    except ids whose exact score lies within CUT_TIE of its K-th: a missing
    truth id there, or a returned id scoring there."""
    n_bad = 0
    for s in range(0, q.shape[0], 512):
        sc = exact_scores(x, q[s:s + 512])
        got = torch.as_tensor(ids[s:s + 512], device=x.device)
        kth = tv[s:s + 512, -1:]
        bad_got = (got < 0) | (torch.gather(sc, 1, got.clamp_min(0)) < kth - CUT_TIE)
        t = tids[s:s + 512]
        missing = ~(t[:, :, None] == got[:, None, :]).any(dim=2)
        bad_miss = missing & (tv[s:s + 512] > kth + CUT_TIE)
        n_bad += int(bad_got.sum()) + int(bad_miss.sum())
    log(f"[{label}] ids equal to the exact top-{K} under K2's one-row-a-bucket rule but for "
        f"near-ties: {n_bad == 0} ({n_bad} differences beyond {CUT_TIE})")
    if n_bad:
        raise AssertionError(f"{label}: not the exact top-{K}")


def check_resharded_rows(a, b) -> None:
    """Every global id once in each layout, with the same int8 row and the
    same list (the residual's centroid), between sharded indexes ``a`` and
    ``b`` of one global scale."""
    def rows(idx):
        parts = []
        for sh in idx._shards:
            ids = np.asarray(sh._ids, np.int64)
            pos = np.flatnonzero(ids >= 0)
            lists = np.searchsorted(sh._offsets, pos, side="right") - 1
            parts.append((ids[pos], lists, sh._payload[torch.as_tensor(pos, device=sh.device)]))
        gid = np.concatenate([p[0] for p in parts])
        order = np.argsort(gid)
        return (gid[order], np.concatenate([p[1] for p in parts])[order],
                torch.cat([p[2] for p in parts])[torch.as_tensor(order, device=parts[0][2].device)])
    (ga, la, ra), (gb, lb, rb) = rows(a), rows(b)
    if not (a._scale == b._scale and np.array_equal(ga, gb) and np.array_equal(ga, np.unique(ga))
            and np.array_equal(la, lb) and torch.equal(ra, rb.to(ra.device))):
        raise AssertionError("(d) the resharded rows, lists or scale differ")


def sharded_merge_ms(idx, queries) -> float:
    """CUDA-event time of the fan-in alone: ``merge_partials`` over SHARDS
    partials of (B, K), as one search makes them."""
    from cloudvectordb_tpu_torch.parallel.mesh import merge_partials

    g = torch.Generator(device=queries.device)
    g.manual_seed(3)
    parts = [(torch.rand((queries.shape[0], K), generator=g, device=queries.device),
              torch.randint(0, N_ROWS, (queries.shape[0], K), generator=g,
                            device=queries.device)) for _ in range(SHARDS)]
    return time_ms(lambda: merge_partials(parts, K, idx.mesh), reps=10)


def cell14(dev) -> dict:
    """Cell 14 (a)-(d) alone, for a short card call: the corpus, the B
    queries and the exact top-K of the first NQ_GT, then ``run_sharded`` on
    a quantizer of its own."""
    chunk_fn = make_corpus(dev, CHUNK)
    n_chunks = N_ROWS // CHUNK
    queries, gt = queries_and_gt(chunk_fn, n_chunks, CHUNK, dev, B)
    return run_sharded(dev, chunk_fn, n_chunks, queries, gt, card_line(), None)


def run_sharded(dev, chunk_fn, n_chunks, queries, gt, card, cell1: dict | None) -> dict:
    """Cell 14, sharded serving on the one card: (a) BASELINE config #4's
    per-card share, a 4-shard ``ShardedBandIndex`` (residual int8, nlist
    4096, ``make_mesh(4)``: four shards on this card) streamed from cell 1's
    25 chunks on cell 1's quantizer, ``tune(gt=)`` at B 4096 against the
    exact top-K of all 4096 queries, recall at the op point (>= 0.90) and at
    full coverage (no more than SHARD_FULL_SLACK below cell 1's single
    index there), device QPS, a 10% and a 3-id filter, a torch.profiler
    split and the merge's time, K1 at shard 0's plan against its plain
    version; (b) two processes on the card (gloo), 2 + 2 shards of a 1M-row
    index loaded from its saved artifact, id for id and score for score
    equal to one process at a partial and the full plan; (c)
    ``DistributedFlatIndex`` over the same 1M rows (K2, f32 ip, 4096
    queries) against the exact top-K under K2's bucket rule; (d) the saved
    index loaded (equal) and resharded 4 -> 2 (RESHARD_ID_FLOOR). Launch
    counts reset just before (a) and read just after each path. ``cell1``
    None (the cell alone): the quantizer is trained on the first chunk and
    (a)'s full-coverage floor is not held."""
    from cloudvectordb_tpu_torch.parallel import (
        DistributedFlatIndex, ShardedBandIndex, make_mesh)

    kw = dict(residual=True, tile_q=SHARD_TILE_Q, kmeans_iters=10)
    centroids = None if cell1 is None else cell1["centroids"]
    t0 = time.perf_counter()
    reset_launches()
    idx = ShardedBandIndex.build_streaming((chunk_fn(i) for i in range(n_chunks)), NLIST,
                                           mesh=make_mesh(SHARDS, devices=[dev]), centroids=centroids, **kw)
    sync()
    build_s = time.perf_counter() - t0
    gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"[sharded] built {idx.ntotal} x {D} on {SHARDS} shards of "
        f"{[sh.ntotal for sh in idx._shards]} rows ({[sh._tune_n_tiles() for sh in idx._shards]}"
        f" tiles), nlist {NLIST}, tile_q {SHARD_TILE_Q}: {build_s:.1f} s, resident {gib:.2f} GiB")
    t0 = time.perf_counter()
    gt_all = exact_gt(chunk_fn, n_chunks, CHUNK, queries)
    log(f"[sharded] exact f32 top-{K} of all {queries.shape[0]} queries: "
        f"{time.perf_counter() - t0:.1f} s")
    report = tune_logged(idx, queries, "sharded", gt=gt_all)
    recall, qps = serve(idx, queries, gt_all, 5, "sharded")
    _, ids_full = idx.search_device(queries[:gt.shape[0]], K, p_tiles=idx._n_tiles())
    full = recall_at_k(ids_full.cpu().numpy(), gt)  # cell 1's queries and ground truth
    log(f"[sharded] {card}: op {report['op']}, recall@{K} {recall:.4f} (floor {RECALL_FLOOR}), "
        f"device QPS {qps['qps']:.1f} ({SHARDS} K1 launches a batch); full coverage "
        f"({idx._n_tiles()} tiles a shard, the first {gt.shape[0]} queries) {full:.4f}"
        + ("" if cell1 is None else f", cell 1's single index {cell1['full_recall']:.4f}"))
    if recall < RECALL_FLOOR:
        raise AssertionError(f"sharded recall {recall:.4f} < {RECALL_FLOOR}")
    if cell1 is not None and full < cell1["full_recall"] - SHARD_FULL_SLACK:
        raise AssertionError(f"sharded full coverage {full:.4f} < cell 1's "
                             f"{cell1['full_recall']:.4f} - {SHARD_FULL_SLACK}")
    allow = torch.rand(N_ROWS, generator=torch.Generator(device=dev).manual_seed(14),
                       device=dev) < 0.10
    for name, where in (("random 10%", allow),
                        ("3 ids", torch.isin(torch.arange(N_ROWS, device=dev),
                                             torch.tensor([5, 5_000_000, 12_000_000],
                                                          device=dev)))):
        v, ids = idx.search_device(queries, K, where=where.cpu().numpy())
        check_filtered(v, ids, where, f"sharded filtered {name}")
        log(f"[sharded] filter {name}: no disallowed id, (-inf, -1) in the "
            f"{int((ids < 0).sum())} unfilled slots")
    split = device_profile(lambda: idx.search_device(queries, K), "sharded one batch at the op "
                           "point", groups=SHARD_GROUPS)
    merge_ms = sharded_merge_ms(idx, queries)
    log(f"[sharded] the merge alone ({SHARDS} partials of {queries.shape[0]} x {K}): "
        f"{merge_ms:.3f} ms; K1 {split['K1']:.1%} of the batch's kernel time")
    k1_a = band.tiles_topk_resid.launches  # (a)'s main path; the hold's launches not
    sh0 = idx._shards[0]
    p0 = min(idx._resolve(queries.shape[0], 32, 0, None)[0], sh0._tune_n_tiles())
    mp = k1_check(f"shard 0 of {SHARDS} B{queries.shape[0]} p{p0} tq{SHARD_TILE_Q}", sh0,
                  k1_plan(sh0, queries, p0, SHARD_TILE_Q), reps=5, plain_reps=1)
    band.tiles_topk_resid.launches = k1_a
    del idx, sh0
    torch.cuda.empty_cache()

    n_mh = MH_CHUNKS * CHUNK
    q_gt = queries[:gt.shape[0]]
    qn = queries.cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="cell14_") as tmp:
        tmp = Path(tmp)
        mh = ShardedBandIndex.build_streaming((chunk_fn(i) for i in range(MH_CHUNKS)), NLIST,
                                              mesh=make_mesh(SHARDS, devices=[dev]), centroids=centroids, **kw)
        ref = {"part": mh.search(qn, K, p_tiles=MH_P_TILES),
               "full": mh.search(qn, K, p_tiles=mh._n_tiles())}
        _, _, one_s = fenced(lambda: mh.search(qn, K, p_tiles=MH_P_TILES))
        mh.save(tmp / "index")
        np.save(tmp / "queries.npy", qn)
        t0 = time.perf_counter()
        res = run_two_processes(tmp, dev)
        two_s = time.perf_counter() - t0
        for rank, r in enumerate(res):
            for name in ("part", "full"):
                if not (np.array_equal(r[f"{name}_i"], ref[name][1])
                        and np.array_equal(r[f"{name}_v"], ref[name][0])):
                    raise AssertionError(f"two processes, rank {rank}, {name} plan: not the "
                                         "one-process ids and scores")
            if int(r["held"]) != SHARDS // 2:
                raise AssertionError(f"rank {rank} held {int(r['held'])} shards")
        log(f"[sharded] (b) two processes on the card (gloo, 2 + 2 shards of {n_mh} rows, "
            f"loaded from the saved index): ids and scores equal to one process at p "
            f"{MH_P_TILES} and at full coverage ({mh._n_tiles()} tiles); a search at p "
            f"{MH_P_TILES} {res[0]['part_ms']:.1f} / {res[1]['part_ms']:.1f} ms host clock "
            f"(one process {one_s * 1e3:.1f} ms), the partials' gather through host memory "
            f"{float(res[0]['gather_ms']):.3f} ms; {two_s:.1f} s with the processes' start")

        gt_mh = exact_gt(chunk_fn, MH_CHUNKS, CHUNK, q_gt)
        loaded = load_index(tmp / "index", device=dev)
        got = {name: loaded.search(qn, K, p_tiles=p) for name, p in
               (("part", MH_P_TILES), ("full", loaded._n_tiles()))}
        for name in got:
            if not (np.array_equal(got[name][1], ref[name][1])
                    and np.array_equal(got[name][0], ref[name][0])):
                raise AssertionError(f"(d) the loaded index differs at the {name} plan")
        del loaded
        two = ShardedBandIndex.load(tmp / "index", mesh=make_mesh(2, devices=[dev]))
        check_resharded_rows(mh, two)
        _, i2 = two.search(qn, K, p_tiles=two._n_tiles())
        n_diff, n_bad = collisions_explain(ref["full"][1], i2, bucket_keys(mh), bucket_keys(two))
        r4, r2 = (recall_at_k(i[:gt_mh.shape[0]], gt_mh) for i in (ref["full"][1], i2))
        log(f"[sharded] (d) saved, loaded: equal at both plans; resharded 4 -> 2 "
            f"({[sh.ntotal for sh in two._shards]} rows): every id's int8 row and list equal; "
            f"at full coverage {n_diff} of {qn.shape[0]} queries differ, {n_bad} of them not by "
            f"a K1 bucket collision of one layout; recall@{K} {r2:.4f} (4 shards {r4:.4f})")
        if n_bad:
            raise AssertionError(f"(d) the resharded index: {n_bad} queries differ beyond "
                                 "K1's bucket collisions")
        del two, mh
    torch.cuda.empty_cache()

    x = torch.cat([chunk_fn(i) for i in range(MH_CHUNKS)])
    flat_idx = DistributedFlatIndex.build(x.cpu().numpy(), mesh=make_mesh(SHARDS, devices=[dev]))
    v, ids = flat_idx.search(qn, K)
    check_result(v, ids, queries.shape[0], n_mh, "sharded flat")
    tv, tids, n_coll = flat_collision_truth(x, queries, -(-n_mh // SHARDS))
    check_flat_exact(ids, x, queries, tv, tids, "sharded flat")
    log(f"[sharded] (c) DistributedFlatIndex, {SHARDS} shards of {n_mh} x {D} f32, ip, "
        f"{queries.shape[0]} queries: K2 launches {flat.flat_topk.launches}; {n_coll} queries have two of "
        f"their exact top-{K} in one K2 bucket (the reference's flat_topk_pallas keeps one too)")
    del x, flat_idx
    torch.cuda.empty_cache()
    launches = {"K1": band.tiles_topk_resid.launches, "K1 sharded": k1_a,
                "K2": flat.flat_topk.launches}
    return dict(launches=launches, mp={"K1 sharded": mp})


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
    (recall2, _), n = counted(lambda: serve(idx, queries, gt, reps, "whole top2", top2=True))
    launches["K3 top2"] = n["K3"]
    if recall2 < WHOLE_ROW_RECALL_FLOOR:
        raise AssertionError(f"whole-row hybrid top-2 recall {recall2:.4f} < "
                             f"{WHOLE_ROW_RECALL_FLOOR}")
    log(f"[whole] {card}: build {build_s:.1f} s, op {report['op']}, recall@{K} hybrid "
        f"{recall:.4f}, int8 {recall8:.4f}, band {recall_band:.4f} (band search "
        f"{band_s:.2f} s host clock), device QPS {qps['qps']:.1f}, launches {launches}")
    if recall < WHOLE_ROW_RECALL_FLOOR:
        raise AssertionError(f"whole-row hybrid recall {recall:.4f} < "
                             f"{WHOLE_ROW_RECALL_FLOOR}")

    op = idx._op_point or {}
    p_tiles, tq, _ = idx._resolve_knobs(queries.shape[0], 32, 0, op.get("tile_q"))
    mp = k3_holds(idx, queries, p_tiles, tq, reps=5, main_op=(p_tiles, tq))
    if (p_tiles, tq) != MAIN_OP:  # the tuner moved: K3 also where the earlier runs timed it
        mp.update({f"{k} {MAIN_OP}": v
                   for k, v in k3_holds(idx, queries, *MAIN_OP, reps=3).items()})
    mp["K7"] = k7_hold(idx, queries, reps=2)
    return dict(launches=launches, mp=mp)


def wholerow_exact(db: torch.Tensor, q: torch.Tensor):
    """(query indices, arena rows) -> f64 scores of the whole-row scan on
    the rows and queries it takes (hybrid: bf16 queries against int8 rows),
    without rounding."""
    qd = q.double()

    def score(qi, rows):
        qi, rows = (torch.as_tensor(a, device=db.device).long() for a in (qi, rows))
        out = [(db[rows[s:s + (1 << 16)]].double() * qd[qi[s:s + (1 << 16)]]).sum(dim=1)
               for s in range(0, rows.numel(), 1 << 16)]
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)

    return score


#: the whole-row path's op point in the runs before the tensor-core scan
#: (p_tiles, tile_q): K3 is timed there too if the tuner picks another
MAIN_OP = (96, 32)


def k3_plan(idx, queries, p_tiles: int, tq: int):
    """(sorted queries, tile table) of the whole-row tiles search at (p_tiles,
    tile_q)."""
    st = idx._device_state()
    q_s, _, _, table = _plan_tiles(queries, st["centroids"], st["tile_window"], tq, p_tiles)
    return q_s, table


def k3_holds(idx, queries, p_tiles: int, tq: int, reps: int,
             main_op: tuple | None = None) -> dict:
    """K3 at a whole-row plan against its plain version, timed, with its
    bound: hybrid (held to the exact scores) and int8 (values and ids equal
    outright); hybrid top-2 (held as hybrid) at the plan ``main_op`` (the
    tuned one)."""
    q_s, table = k3_plan(idx, queries, p_tiles, tq)
    q_bf = q_s.to(torch.bfloat16)
    q8, _ = flat.quantize_queries(q_s)
    mp = {}
    for key, label, qk, int8, kind in (("K3", "hybrid", q_bf, "hybrid", "bf16"),
                                       ("K3 int8", "int8", q8, True, "int8"),
                                       ("K3 top2", "hybrid top2", q_bf, "hybrid", "bf16")):
        if key == "K3 top2" and (p_tiles, tq) != main_op:
            continue
        mp[key] = k3_hold(key, label, idx, qk, table, int8, kind, p_tiles, tq, reps,
                          top2=key == "K3 top2")
    return mp


def k3_hold(key: str, label: str, idx, qk, table, int8, kind: str, p_tiles: int, tq: int,
            reps: int, top2: bool, plain_reps: int = 2, l_buckets: int = 0) -> dict:
    """K3 on sorted queries ``qk`` and a tile table against its plain
    version, timed, with its bound: the float pairs held to the exact f64
    scores (as EXACT_TIE says, the tie from the run), int8 x int8 equal
    outright. ``l_buckets`` 0 is the main path's L = tile_n (R 1)."""
    st = idx._device_state()
    batch, d = qk.shape
    used, macs = table_work(table, tq, idx.tile_n, d)
    ops = 2.0 * batch * p_tiles * idx.tile_n * d
    kw = dict(tile_n=idx.tile_n, tile_q=tq, int8=int8, n_valid=idx._n, top2=top2,
              l_buckets=l_buckets)
    hold = (dict(equal=True) if int8 is True
            else dict(exact=wholerow_exact(st["payload"], qk), tie=None))
    r = main_shape_check(
        "K3", f"{label} B{batch} p{p_tiles} tq{tq} R{idx.tile_n // (l_buckets or idx.tile_n)}",
        lambda: band.tiles_topk(st["payload"], qk, table, K, **kw),
        lambda: band.tiles_topk_reference(st["payload"], qk, table, K, **kw),
        reps=reps, plain_reps=plain_reps, **hold)
    row_bytes = d * st["payload"].element_size()
    r.update(bound(used * idx.tile_n * row_bytes + nbytes(qk, table) + batch * K * 8,
                   2.0 * macs, kind))
    pairs = table.numel() * idx.tile_n * row_bytes  # every (query tile, entry) reads its tile
    log(f"[kernel] {key} p{p_tiles} tq{tq}: {ops / r['ms'] / 1e9:.1f} T {kind} ops/s; "
        f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}): {used} of "
        f"{idx._tune_n_tiles()} tiles read once ({used * idx.tile_n * row_bytes / 1e9:.2f} GB); "
        f"{table.numel()} (query tile, entry) pairs read {pairs / 1e9:.2f} GB, "
        f"{pairs / HBM_BYTES_PER_S * 1e3:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return r


#: K3's top-2 where the tensor-core block cannot take it (the CUDA-core
#: body): f32 whole rows over the first TOP2_F32_ROWS rows of the corpus,
#: and a hybrid int8 arena of DEEP_ROWS rows at DEEP_D (text-embedding-3-
#: large's width), too deep for resident bf16 queries, at plan DEEP_OP
TOP2_F32_ROWS = 1_000_000
DEEP_D, DEEP_ROWS, DEEP_NLIST, DEEP_OP = 3072, 262_144, 256, (16, 32)
DEEP_R4_BUCKETS = 512


def scan_body(qk, db, tq: int, r_per_tile: int = 1) -> str:
    """The tiles_scan.cu body a K3 top-2 call at these shapes takes."""
    from cloudvectordb_tpu_torch.ops import _cuda

    smem = _cuda._load("tiles_scan").cvdb_tiles_scan_smem_bytes(
        1, _cuda._ELEM[qk.dtype], _cuda._ELEM[db.dtype], tq, db.shape[1], 0, 1, r_per_tile)
    return "CUDA-core" if smem == 0 else "tensor-core narrow" if smem > 0 else "none"


def top2_route(idx, queries, gt, p_tiles: int, tq: int, label: str, qk_of, int8, kind: str,
               reps: int):
    """One top-2 batch through ``search_device`` (K3's launches counted just
    around it; recall@10 against ``gt``), then K3 top-2 at that plan against
    its plain version through the exact f64 scores, timed, with its bound.
    Returns (launches, record, recall)."""
    (v, ids), n = counted(lambda: idx.search_device(queries, K, p_tiles=p_tiles, tile_q=tq,
                                                    top2=True))
    v, ids = v.cpu().numpy(), ids.cpu().numpy()
    check_result(v, ids, queries.shape[0], idx.ntotal, label)
    recall = recall_at_k(ids[: gt.shape[0]], gt)
    q_s, table = k3_plan(idx, queries, p_tiles, tq)
    qk = qk_of(q_s)
    body = scan_body(qk, idx._device_state()["payload"], tq)
    log(f"[top2] {label}: {idx.ntotal} x {qk.shape[1]}, p{p_tiles} tq{tq}, B {queries.shape[0]}: "
        f"recall@{K} {recall:.4f} against exact on {gt.shape[0]} queries; K3 launches {n['K3']}; "
        f"body {body}")
    if body != "CUDA-core":
        raise AssertionError(f"{label}: K3 top-2 took the {body} body")
    r = k3_hold("K3", f"{label} top2", idx, qk, table, int8, kind, p_tiles, tq, reps,
                top2=True, plain_reps=1)
    return n["K3"], r, recall


def build_f32_rows(dev, chunk_fn):
    """The f32 whole-row BandIVFIndex over the corpus's first TOP2_F32_ROWS
    rows (nlist NLIST)."""
    x = torch.cat([chunk_fn(i) for i in range(TOP2_F32_ROWS // CHUNK)])
    t0 = time.perf_counter()
    idx = BandIVFIndex.build(x, NLIST, dtype="float32", residual=False, kmeans_iters=10,
                             device=dev)
    sync()
    log(f"[top2] f32 whole rows: built {idx.ntotal} x {D}, nlist {NLIST} in "
        f"{time.perf_counter() - t0:.1f} s")
    return idx


def build_deep(dev):
    """(index, chunk_fn, queries) of the deep hybrid arena: DEEP_ROWS unit rows
    of the corpus's process at DEEP_D, int8 whole rows (nlist DEEP_NLIST),
    and B noisy copies of its rows."""
    deep_fn = make_corpus(dev, DEEP_ROWS, d=DEEP_D)
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(deep_fn, 1, nlist=DEEP_NLIST, kmeans_iters=10,
                                              residual=False, device=dev)
    sync()
    log(f"[top2] deep hybrid: built {idx.ntotal} x {DEEP_D} int8, nlist {DEEP_NLIST} in "
        f"{time.perf_counter() - t0:.1f} s")
    return idx, deep_fn, make_queries(deep_fn, dev, B)


def run_top2_routes(dev, chunk_fn, queries, card, reps: int = 3) -> dict:
    """K3's top-2 on the routes the narrow tensor-core block cannot take:
    f32 whole rows (``build_f32_rows``, the main op point, recall@10 >=
    WHOLE_ROW_RECALL_FLOOR) and the deep hybrid arena (``build_deep``); each
    batch's launches, and K3 top-2 held at its plan."""
    launches, mp = {}, {}
    idx = build_f32_rows(dev, chunk_fn)
    gt = exact_gt(chunk_fn, TOP2_F32_ROWS // CHUNK, CHUNK, queries[:NQ_GT])
    launches["K3 top2 f32"], mp["K3 top2 f32"], recall = top2_route(
        idx, queries, gt, *MAIN_OP, "f32", lambda q: q, False, "f32", reps)
    if recall < WHOLE_ROW_RECALL_FLOOR:
        raise AssertionError(f"f32 top-2 recall {recall:.4f} < {WHOLE_ROW_RECALL_FLOOR}")
    del idx
    torch.cuda.empty_cache()
    idx, deep_fn, qd = build_deep(dev)
    gtd = exact_gt(deep_fn, 1, DEEP_ROWS, qd[:NQ_GT])
    launches["K3 top2 deep"], mp["K3 top2 deep"], _ = top2_route(
        idx, qd, gtd, *DEEP_OP, f"hybrid D{DEEP_D}", lambda q: q.to(torch.bfloat16),
        "hybrid", "bf16", reps)
    # slot 2 never reaches the deep arena's top-10 at R 1 (each bucket holds
    # one row a tile), so a slot-2 fault shows only at R > 1: held at R 4 too
    q_s, table = k3_plan(idx, qd, *DEEP_OP)
    k3_hold("K3", f"hybrid D{DEEP_D} top2", idx, q_s.to(torch.bfloat16), table, "hybrid",
            "bf16", *DEEP_OP, reps=1, top2=True, plain_reps=1, l_buckets=DEEP_R4_BUCKETS)
    log(f"[top2] {card}: f32 top-2 {mp['K3 top2 f32']['ms']:.3f} ms, deep hybrid top-2 "
        f"{mp['K3 top2 deep']['ms']:.3f} ms (CUDA-core body)")
    return dict(launches=launches, mp=mp)


def k7_plan(idx, queries):
    """(int8 sorted queries, band starts, band_tiles) of the band search."""
    _, q8, _, starts, band_tiles = idx._plan_band(queries.cpu().numpy(), 32)
    return q8, starts, band_tiles


def k7_hold(idx, queries, reps: int) -> dict:
    """K7 at the band plan against its plain version (values and ids equal
    outright), timed, with its bound."""
    st = idx._device_state()
    q8, starts, band_tiles = k7_plan(idx, queries)
    kw7 = dict(tile_n=idx.tile_n, tile_q=idx.tile_q, int8=True, n_valid=idx._n)
    r = main_shape_check(
        "K7", f"int8 band plan B{queries.shape[0]} band_tiles {band_tiles} "
              f"of {idx._tune_n_tiles()}",
        lambda: band.band_topk(st["payload"], q8, starts, K, band_tiles, **kw7),
        lambda: band.band_topk_reference(st["payload"], q8, starts, K, band_tiles, **kw7),
        reps=reps, plain_reps=1, equal=True)
    n_tiles = st["payload"].shape[0] // idx.tile_n
    spans = [(s0, min(s0 + band_tiles, n_tiles)) for s0 in starts.cpu().tolist()]
    used = len(set().union(*(range(a, b) for a, b in spans)))
    macs = sum(b - a for a, b in spans) * idx.tile_q * idx.tile_n * D
    r.update(bound(used * idx.tile_n * D + nbytes(q8, starts) + queries.shape[0] * K * 8,
                   2.0 * macs, "int8"))
    log(f"[kernel] K7: {2.0 * macs / r['ms'] / 1e9:.1f} T int8 ops/s; bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']}): {used} of {n_tiles} tiles read")
    return r


# -- the flat path ------------------------------------------------------------
# -- mutation ---------------------------------------------------------------------
#: the mutation phase: scripts/bench_fold.py's protocol (merge_headroom, five
#: adds of MUT_ADD rows, the fifth past the 5% fold threshold, an in-place
#: merge) and scripts/bench_remove.py's (slack, MUT_ROUNDS rounds of
#: MUT_REMOVE removes, a refill of MUT_REMOVE adds), then whole rows at a
#: smaller depth
MUT_ADD, MUT_ADDS, MUT_HEADROOM = 131_072, 5, 0.06
MUT_SLACK, MUT_REMOVE, MUT_ROUNDS = 0.05, 8192, 4
WHOLE_MUT_ROWS = 1_000_000
#: self-hit@1 of added rows queried with themselves at full coverage, as
#: the reference's test does: exact while pending or in the annex, the
#: reference's bar once merged (tests/unit/test_band_ivf.py:538)
SELF_HIT_ROWS, SELF_HIT_EXACT, SELF_HIT_MERGED = 256, 0.99, 0.90


def added_rows(chunk_fn, n_chunks: int, j: int, n: int = MUT_ADD) -> torch.Tensor:
    """The j-th batch of added rows: the first n rows of a further chunk of
    the corpus's generating process."""
    return chunk_fn(n_chunks + j)[:n]


def exact_states(segments, q: torch.Tensor, keeps: dict) -> dict:
    """One pass over a state's rows, ``segments`` [(first gid, rows fn)]:
    the exact f32 top-K gids of ``q`` over the rows each ``keeps`` mask
    (name -> (gid bound,) bool) allows."""
    nq = q.shape[0]
    best = {name: (torch.full((nq, K), float("-inf"), device=q.device),
                   torch.zeros((nq, K), dtype=torch.int64, device=q.device)) for name in keeps}
    for base, rows in segments:
        x = rows()
        for name, keep in keeps.items():
            sel = keep[base:base + x.shape[0]].nonzero()[:, 0]
            if sel.numel():
                cv, cidx = tiled_topk(x[sel], q, K, metric="ip", tile=8192)
                best[name] = merge_topk(*best[name], cv, sel[cidx] + base, K)
    return {name: b[1].cpu().numpy() for name, b in best.items()}


def corpus_segments(chunk_fn, n_chunks: int) -> list:
    return [(ci * CHUNK, lambda ci=ci: chunk_fn(ci)) for ci in range(n_chunks)]


def mut_serve(idx, queries, gt, label: str, floor: float, removed=None, reps: int = 5,
              **kw) -> dict:
    """search_device on the batch: no -1 in a filled slot, no removed id,
    recall@10 >= floor against the state's exact ground truth; device QPS."""
    v, ids = idx.search_device(queries, K, **kw)
    qps = qps_device(lambda q: idx.search_device(q, K, **kw), queries, reps=reps)
    v, ids = v.cpu().numpy(), ids.cpu().numpy()
    check_result(v, ids, queries.shape[0], idx._gid_bound(), label)
    if removed is not None and np.isin(ids, removed).any():
        raise AssertionError(f"{label}: a removed id was returned")
    recall = recall_at_k(ids[: gt.shape[0]], gt)
    log(f"[mut] {label}: ntotal {idx.ntotal}, recall@{K} vs the state's exact f32 "
        f"{recall:.4f}; search_device {qps['ms_median']:.3f} ms (QPS {qps['qps']:.1f}; min "
        f"{qps['ms_min']:.3f}, max {qps['ms_max']:.3f})")
    if recall < floor:
        raise AssertionError(f"{label}: recall {recall:.4f} < {floor}")
    return dict(recall=recall, ms=qps["ms_median"], qps=qps["qps"])


def mut_filtered(idx, queries, flt, allow: torch.Tensor, gt, label: str, removed=None,
                 **kw) -> float:
    """One filtered batch: no disallowed or removed id, (-inf, -1) unfilled
    slots, recall@10 >= RECALL_FLOOR against the exact filtered truth."""
    v, ids = idx.search_device(queries, K, where=flt, **kw)
    check_filtered(v, ids, allow, f"mut {label}")
    ids = ids.cpu().numpy()
    if removed is not None and np.isin(ids, removed).any():
        raise AssertionError(f"{label}: a removed id was returned")
    recall = recall_at_k(ids[: gt.shape[0]], gt)
    log(f"[mut] {label}: recall@{K} vs the exact filtered f32 {recall:.4f}; no disallowed id")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"{label}: recall {recall:.4f} < {RECALL_FLOOR}")
    return recall


def self_hit(idx, rows, first_gid: int, label: str, floor: float) -> float:
    """Added rows queried with themselves at full coverage: the share whose
    top-1 is the row."""
    _, ids = idx.search_device(rows, 1, p_tiles=idx._tune_n_tiles(), tile_q=32)
    hit = float((ids[:, 0].cpu().numpy() == first_gid + np.arange(rows.shape[0])).mean())
    log(f"[mut] {label}: self-hit@1 of {rows.shape[0]} added rows {hit:.4f}")
    if hit < floor:
        raise AssertionError(f"{label}: self-hit@1 {hit:.4f} < {floor}")
    return hit


def fenced(fn):
    """(fn(), seconds to its return, seconds to the card's end of its work)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    sync()
    return out, t1 - t0, time.perf_counter() - t0


def slack_removed(dev, chunk_fn, n_chunks: int):
    """scripts/bench_remove.py's arena at config #4's 12.5M: the residual
    index with slack MUT_SLACK, then MUT_ROUNDS rounds of MUT_REMOVE removes
    of random live ids (rng 3), each fenced. Returns (index, removed ids,
    build seconds, [(host seconds, fenced seconds) per round])."""
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, n_chunks, nlist=NLIST, kmeans_iters=10,
                                              residual=True, slack=MUT_SLACK, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    removed, rounds = [], []
    for _ in range(MUT_ROUNDS):
        live = np.asarray(idx._ids[: idx._n])
        victims = rng.choice(live[live >= 0], MUT_REMOVE, replace=False)
        n, host_s, all_s = fenced(lambda: idx.remove(victims))
        if n != MUT_REMOVE:
            raise AssertionError(f"remove: {n} of {MUT_REMOVE} rows removed")
        removed.append(victims)
        rounds.append((host_s, all_s))
    return idx, np.concatenate(removed), build_s, rounds


def run_mutation(dev, chunk_fn, n_chunks, queries, gt, card, op) -> dict:
    """Cell 9: mutation of the residual index at 12.5M x 768 (fold and
    in-place merge; remove and refill on a slack arena) and of a 1M
    whole-row int8 arena (annex rows through K3 and K7, a compact remove),
    served at the headline's op point ``op`` (p_tiles, tile_q); every state
    held to its own exact ground truth. Launch counts reset just before and
    read just after; K1 then held on the mutated slack arena."""
    kw = dict(p_tiles=op[0], tile_q=op[1])
    q_gt = queries[: gt.shape[0]]
    out = {}
    reset_launches()

    # 1. fold and merge (scripts/bench_fold.py)
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, n_chunks, nlist=NLIST, kmeans_iters=10,
                                              residual=True, merge_headroom=MUT_HEADROOM,
                                              device=dev)
    sync()
    build_s = time.perf_counter() - t0
    ptr, cap = idx._payload.data_ptr(), idx._payload.shape[0]
    n_ids = N_ROWS + MUT_ADDS * MUT_ADD
    gid = torch.arange(n_ids, device=dev)
    mask10 = make_filters(idx, dev, n_ids)["random 10%"]
    gts = exact_states(corpus_segments(chunk_fn, n_chunks) + [
        (N_ROWS + j * MUT_ADD, lambda j=j: added_rows(chunk_fn, n_chunks, j))
        for j in range(MUT_ADDS)], q_gt,
        {"pending": gid < N_ROWS + MUT_ADD, "annex": gid >= 0, "annex 10%": mask10})
    hit_rows = added_rows(chunk_fn, n_chunks, 0, SELF_HIT_ROWS)
    log(f"[mut] built {N_ROWS} x {D} with merge_headroom {MUT_HEADROOM}: {build_s:.1f} s, "
        f"{cap} rows of capacity for an extent of {idx._n}")
    add_s = []
    for j in range(MUT_ADDS):
        x = added_rows(chunk_fn, n_chunks, j)
        _, _, s = fenced(lambda: idx.add(x))
        add_s.append(s)
        if j == 0:
            if idx._pending.size != MUT_ADD or idx._annex is not None:
                raise AssertionError("the first add did not stay pending")
            out["pending"] = mut_serve(idx, queries, gts["pending"],
                                       f"{MUT_ADD} rows pending", RECALL_FLOOR, **kw)
            self_hit(idx, hit_rows, N_ROWS, "pending", SELF_HIT_EXACT)
    if (idx._annex or {}).get("n") != n_ids - N_ROWS or idx._pending.size:
        raise AssertionError(f"the fifth add did not fold into the annex "
                             f"({idx._pending.size} pending)")
    log(f"[mut] {card}: adds of {MUT_ADD} rows: " + ", ".join(
        f"{s:.3f} s ({MUT_ADD / s:,.0f} rows/s)" for s in add_s)
        + f"; the fifth folded {n_ids - N_ROWS} rows into the annex")
    out["annex"] = mut_serve(idx, queries, gts["annex"], f"{n_ids - N_ROWS} rows in the annex",
                             RECALL_FLOOR, **kw)
    out["annex profile"] = device_profile(lambda: idx.search_device(queries, K, **kw),
                                          "search_device with the annex", top=6)
    self_hit(idx, hit_rows, N_ROWS, "annex", SELF_HIT_EXACT)
    mut_filtered(idx, queries, idx.make_filter(mask10.cpu().numpy()), mask10, gts["annex 10%"],
                 "random 10% filter over arena and annex", **kw)
    _, _, merge_s = fenced(idx.merge_pending)
    if (idx._payload.data_ptr(), idx._payload.shape[0]) != (ptr, cap) or idx._annex is not None \
            or idx._pending.size or idx.ntotal != n_ids or idx._n != n_ids:
        raise AssertionError("merge_pending did not merge in place")
    log(f"[mut] {card}: merge_pending in place in {merge_s:.3f} s (the arena's buffer and "
        f"capacity kept; {idx._n} of {cap} rows used)")
    out["merged"] = mut_serve(idx, queries, gts["annex"], "merged", RECALL_FLOOR, **kw)
    self_hit(idx, hit_rows, N_ROWS, "merged", SELF_HIT_MERGED)
    rec = torch.as_tensor(idx.reconstruct(N_ROWS + np.arange(SELF_HIT_ROWS)), device=dev)
    cos = float(((rec * hit_rows).sum(1) / rec.norm(dim=1)).min())
    log(f"[mut] merged: the {SELF_HIT_ROWS} added rows reconstructed from the arena: "
        f"least cosine to their source rows {cos:.5f}")
    if cos < 0.99:
        raise AssertionError(f"merged rows do not reconstruct their sources (cosine {cos:.5f})")
    out.update(add_s=add_s, merge_s=merge_s)
    k1_fold = band.tiles_topk_resid.launches
    del idx, gts
    torch.cuda.empty_cache()

    # 2. remove and refill on a slack arena (scripts/bench_remove.py)
    idx, removed, build_s, rounds = slack_removed(dev, chunk_fn, n_chunks)
    n_ids = N_ROWS + MUT_REMOVE
    gid = torch.arange(n_ids, device=dev)
    gone = torch.zeros(n_ids, dtype=torch.bool, device=dev)
    gone[torch.as_tensor(removed, device=dev)] = True
    allow = torch.cat([make_filters(idx, dev)["random 10%"],
                       torch.zeros(MUT_REMOVE, dtype=torch.bool, device=dev)])
    refill = added_rows(chunk_fn, n_chunks, 0, MUT_REMOVE)
    gts = exact_states(corpus_segments(chunk_fn, n_chunks) + [(N_ROWS, lambda: refill)], q_gt,
                       {"removed": ~gone & (gid < N_ROWS), "refill": ~gone,
                        "refill 10%": ~gone & allow})
    host_s, all_s = sum(r[0] for r in rounds), sum(r[1] for r in rounds)
    log(f"[mut] {card}: slack {MUT_SLACK} arena built in {build_s:.1f} s; {MUT_ROUNDS} rounds "
        f"of {MUT_REMOVE} removes: " + ", ".join(f"{a:.3f} s" for _, a in rounds)
        + f" fenced; {len(removed) / all_s:,.0f} rows/s, host share {host_s / all_s:.0%}")
    ptr = idx._payload.data_ptr()
    if idx.ntotal != N_ROWS - len(removed):
        raise AssertionError(f"ntotal {idx.ntotal} after removes")
    out["removed"] = mut_serve(idx, queries, gts["removed"], f"{len(removed)} rows removed",
                               RECALL_FLOOR, removed=removed, **kw)
    flt = idx.make_filter(allow[:N_ROWS].cpu().numpy())
    k1_path = band.tiles_topk_resid.launches
    out["mp"] = k1_check(f"mutated slack arena B{queries.shape[0]} p{op[0]} tq{op[1]}", idx,
                         k1_plan(idx, queries, *op), reps=10, plain_reps=3)
    band.tiles_topk_resid.launches = k1_path  # the hold's launches are not the path's
    _, _, refill_s = fenced(lambda: idx.add(refill))
    if idx._pending.size or idx._payload.data_ptr() != ptr or \
            idx.ntotal != N_ROWS - len(removed) + MUT_REMOVE:
        raise AssertionError("the refill did not land in place")
    log(f"[mut] {card}: refill of {MUT_REMOVE} rows in place in {refill_s:.3f} s "
        f"({MUT_REMOVE / refill_s:,.0f} rows/s), none pending")
    out["refill"] = mut_serve(idx, queries, gts["refill"], "refilled", RECALL_FLOOR,
                              removed=removed, **kw)
    mut_filtered(idx, queries, flt, allow, gts["refill 10%"],
                 "random 10% filter built before the removes", removed=removed, **kw)
    k1 = band.tiles_topk_resid.launches
    out.update(remove_rounds=rounds, refill_s=refill_s)
    del idx, gts, refill
    torch.cuda.empty_cache()

    # 3. whole rows at 1M: annex rows through K3 and K7, then a compact remove
    n_w = WHOLE_MUT_ROWS // CHUNK
    reset_launches()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, n_w, nlist=NLIST, kmeans_iters=10,
                                              residual=False, device=dev)
    x = added_rows(chunk_fn, n_chunks, 0)
    idx.add(x)
    if (idx._annex or {}).get("n") != MUT_ADD:
        raise AssertionError("the whole-row add did not fold into the annex")
    victims = np.random.default_rng(4).choice(WHOLE_MUT_ROWS, MUT_REMOVE, replace=False)
    n_ids = WHOLE_MUT_ROWS + MUT_ADD
    gone = torch.zeros(n_ids, dtype=torch.bool, device=dev)
    gone[torch.as_tensor(victims, device=dev)] = True
    gts = exact_states(corpus_segments(chunk_fn, n_w) + [(WHOLE_MUT_ROWS, lambda: x)], q_gt,
                       {"added": torch.ones_like(gone), "removed": ~gone})
    out["whole"] = mut_serve(idx, queries, gts["added"],
                             f"whole rows {WHOLE_MUT_ROWS} + {MUT_ADD} in the annex",
                             WHOLE_ROW_RECALL_FLOOR, **kw)
    vb, ib = idx.search(queries.cpu().numpy(), K, strategy="band")
    check_result(vb, ib, queries.shape[0], n_ids, "whole band with the annex")
    recall_band = recall_at_k(ib[: gt.shape[0]], gts["added"])
    log(f"[mut] whole rows, band strategy with the annex: recall@{K} {recall_band:.4f}")
    if recall_band < WHOLE_ROW_RECALL_FLOOR:
        raise AssertionError(f"whole-row band recall {recall_band:.4f}")
    n, _, rem_s = fenced(lambda: idx.remove(victims))
    if n != MUT_REMOVE or idx.ntotal != n_ids - MUT_REMOVE:
        raise AssertionError(f"whole-row remove: {n} removed, ntotal {idx.ntotal}")
    log(f"[mut] {card}: whole-row remove of {MUT_REMOVE} rows (compact) in {rem_s:.3f} s")
    out["whole removed"] = mut_serve(idx, queries, gts["removed"], "whole rows removed",
                                     WHOLE_ROW_RECALL_FLOOR, removed=victims, **kw)
    launches = {"K1": k1, "K1 mutated": k1 - k1_fold, "K3": band.tiles_topk.launches,
                "K7": band.band_topk.launches}
    del idx, gts, x
    return dict(launches=launches, mp={"K1 mutated": out["mp"]}, report=out)


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
    launches = {"K2": flat.flat_topk.launches}
    flat8 = FlatIndex.build(x8, metric="ip", dtype="int8", device=dev)
    t0 = time.perf_counter()
    v8, ids8 = flat8.search(queries.cpu().numpy(), K)
    flat8_s = time.perf_counter() - t0
    check_result(v8, ids8, queries.shape[0], flat8.ntotal, "flat int8")
    recall8 = recall_at_k(ids8[:NQ_GT], gt8)
    launches["K2 int8"] = flat.flat_topk.launches - launches["K2"]
    log(f"[flat] {card}: SIFT-like {SIFT_ROWS} x {SIFT_D} f32 l2, {SIFT_Q} queries: "
        f"recall@{K} {recall_sift:.4f} vs exact f32 (ground truth {gt_s:.1f} s), search "
        f"{sift_s:.3f} s host clock; int8 {x8.shape[0]} x {D} ip, B {queries.shape[0]}: "
        f"recall@{K} {recall8:.4f} on {NQ_GT} queries, search {flat8_s:.3f} s host "
        f"clock; launches {launches}")
    if recall_sift < FLAT_RECALL_FLOOR:
        raise AssertionError(f"flat recall {recall_sift:.4f} < {FLAT_RECALL_FLOOR}")

    # the rows and queries are integers in [0, 255] at D 128: every partial
    # sum of 2 q.x - |x|^2 is an integer below 2^24, exact in f32 in any order,
    # so the kernel must equal its plain version outright
    mp = {"K2": main_shape_check(
        "K2", f"f32 l2 {SIFT_ROWS}x{SIFT_D} Q{SIFT_Q}",
        lambda: flat.flat_topk(sift._vecs, qs, K, metric="l2", db_sqnorms=sift._sqnorms),
        lambda: flat.flat_topk_reference(sift._vecs, qs, K, metric="l2",
                                         db_sqnorms=sift._sqnorms),
        reps=5, plain_reps=3, equal=True)}
    mp["K2"].update(bound(nbytes(sift._vecs, sift._sqnorms, qs) + SIFT_Q * K * 8,
                          2.0 * SIFT_Q * SIFT_ROWS * SIFT_D, "f32"))
    q8, _ = flat.quantize_queries(queries)
    mp["K2 int8"] = main_shape_check(
        "K2", f"int8 ip {x8.shape[0]}x{D} Q{queries.shape[0]}",
        lambda: flat.flat_topk(flat8._vecs, q8, K),
        lambda: flat.flat_topk_reference(flat8._vecs, q8, K), reps=3, plain_reps=2,
        equal=True)
    mp["K2 int8"].update(bound(nbytes(flat8._vecs, q8) + q8.shape[0] * K * 8,
                               2.0 * q8.shape[0] * x8.shape[0] * D, "int8"))
    log(f"[kernel] K2 bounds: f32 l2 {mp['K2']['bound_ms']:.3f} ms ({mp['K2']['bound_by']}), "
        f"int8 ip {mp['K2 int8']['bound_ms']:.3f} ms ({mp['K2 int8']['bound_by']})")
    return dict(launches=launches, mp=mp)


# -- the PQ-tiles path (BASELINE config #3) ------------------------------------
def pq_bound(codes_bytes_per_row: int, rows_scored: int, distinct_rows: int, ct_bytes: int,
             q, out_bytes: int, m: int, ncode: int, dsub: int) -> dict:
    """K5/K6's bound: the bytes of the distinct rows' codes (and local
    bytes) and centroid tiles, the queries and the slots over the memory
    rate, against the least arithmetic of the function, the LUT-ADC form, at
    the f32 rate: m adds per (query, row) scored plus the queries' lookup
    tables, B·m·ncode·dsub multiply-adds."""
    n_bytes = distinct_rows * codes_bytes_per_row + ct_bytes + nbytes(q) + out_bytes
    ops = rows_scored * m + 2.0 * q.shape[0] * m * ncode * dsub
    return bound(n_bytes, ops, "f32")


def pq_exact(codes, local, cb, ct, tile_n: int, q, l2: bool = False):
    """(query indices, arena rows) -> f64 scores of the function K5/K6
    compute, on the bf16 codebooks, centroid tiles and queries they take:
    q . x with x = cb[j][code(g, j)] + ct[g // tile_n, local[g]] without
    rounding (ct None: no centroid term); ``l2``: K5's l2 key
    q . x - |x|^2 / 2."""
    cbd = cb.to(torch.bfloat16).double()
    ctd = None if ct is None else ct.to(torch.bfloat16).double()
    qd = q.to(torch.bfloat16).double()
    sub = torch.arange(cbd.shape[0], device=cbd.device)

    def score(qi, rows):
        qi, rows = (torch.as_tensor(a, device=cbd.device).long() for a in (qi, rows))
        out = []
        for s in range(0, rows.numel(), 1 << 16):
            g = rows[s:s + (1 << 16)]
            x = cbd[sub, codes[g].long()].reshape(g.numel(), -1)
            if ctd is not None:
                x = x + ctd[g // tile_n, local[g].long()]
            sc = (x * qd[qi[s:s + (1 << 16)]]).sum(dim=1)
            out.append(sc - 0.5 * (x * x).sum(dim=1) if l2 else sc)
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)

    return score


def split_form_flops(table: torch.Tensor, tile_q: int, tile_n: int, w: int) -> float:
    """bf16 flops of K5's split form over a tile table, as the kernel runs
    it: every (query, row) of every entry against its D dims, plus the
    centroid term C = q . ct once per (query, entry), W rows."""
    steps = table.numel()
    return 2.0 * steps * tile_q * (tile_n + w) * D


def build_pq(dev, chunk_fn):
    """Config #3's index over the first 10M rows of the corpus; (index,
    seconds of the build)."""
    t0 = time.perf_counter()
    idx = BandIVFPQIndex.build_device_streaming(
        chunk_fn, PQ_ROWS // CHUNK, nlist=NLIST, m=PQ_M, nbits=PQ_NBITS, opq=True,
        refine="int8", kmeans_iters=10, pq_train_iters=8, device=dev)
    sync()
    return idx, time.perf_counter() - t0


def pq_holds(idx, queries, p_tiles: int, tq: int, pq_plans: dict = PQ_PLANS):
    """What K5 is held at on config #3's index at the plan (p_tiles, tq):
    (the index's scan state, the sorted rotated queries, the tile table,
    ``pq_exact`` on them, {PQ-route plan of ``pq_plans``: K5's arguments})."""
    st = idx._refine_scan_state()
    q_s, _, _, table = _plan_tiles(idx._rotate(queries), st["centroids"], st["tile_window"],
                                   tq, p_tiles)
    exact = pq_exact(st["codes"], st["local"].reshape(-1), st["codebooks"],
                     st["centroid_tiles"], idx.tile_n, q_s)
    plans = {}
    for name, (rf, top2) in pq_plans.items():
        _, k_cand, n_pools, l_buckets, _ = idx._pq_stage_plan(K, rf, 0, tq, p_tiles, top2)
        plans[name] = dict(codes_cm=st["codes"], codebooks=st["codebooks"], queries_sorted=q_s,
                           tile_table=table, k=k_cand, centroid_tiles=st["centroid_tiles"],
                           tile_n=idx.tile_n, tile_q=tq, l_buckets=l_buckets, n_valid=idx._n,
                           row_major=True, local_ids=st["local"], n_pools=n_pools, top2=top2)
    return st, q_s, table, exact, plans


def pq_plan_label(name: str, args: dict, batch: int, p_tiles: int) -> str:
    return (f"{name} B{batch} p{p_tiles} tq{args['tile_q']} k_cand {args['k']} "
            f"L{args['l_buckets']} pools {args['n_pools']}")


def run_pq(dev, chunk_fn, queries, card, reps: int = 5) -> dict:
    """BASELINE config #3 (10M x 768, OPQ + IVF-PQ, m 64, nbits 8, residual
    int8 refine): ``build_device_streaming`` on the first 10M rows of the
    corpus, ``tune``, the refine route (K1) at the op point, then the PQ
    route (K5 + int8 rescore, K8) at the tuned p_tiles and tile_q with
    refine_factor 16, 64 and 64 with top-2; the launch counts are reset
    just before the build and read after the PQ route (K8 one a K5
    launch). Then, on the plan both routes serve, K1 over the refine arena
    and K5 at each of the three candidate budgets against their plain
    versions, each timed; K5's record is refine_factor 64's, and every
    check's error joins its kernel's max_abs_err; then K8 on K5's
    refine_factor-64 candidates against its plain version, both timed."""
    n_chunks = PQ_ROWS // CHUNK
    t0 = time.perf_counter()
    gt = exact_gt(chunk_fn, n_chunks, CHUNK, queries[:NQ_GT])
    log(f"[pq] exact f32 top-{K} of {NQ_GT} queries over {PQ_ROWS} rows: "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    idx, build_s = build_pq(dev, chunk_fn)
    log(f"[pq] built {idx.ntotal} x {D} OPQ+IVF-PQ (nlist {NLIST}, m {PQ_M}, nbits "
        f"{PQ_NBITS}, residual int8 refine): {build_s:.1f} s, tile_n {idx.tile_n} after the "
        f"skew fit, W={idx._tile_window.shape[1]}, {idx._tune_n_tiles()} tiles, refine "
        f"scale {idx._scale:.6g}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    report = tune_logged(idx, queries, "pq")
    op = dict(report["op"])
    recall_rf, qps_rf = serve(idx, queries, gt, reps, "pq refine route")
    if recall_rf < PQ_REFINE_FLOOR:
        raise AssertionError(f"config #3 refine-route recall {recall_rf:.4f} < {PQ_REFINE_FLOOR}")
    p_tiles, tq = op["p_tiles"], op["tile_q"]
    routes = {}
    for name, (rf, top2) in PQ_PLANS.items():
        routes[name] = serve(idx, queries, gt, reps, f"pq route {name} p{p_tiles} tq{tq}",
                             serve_from="pq", p_tiles=p_tiles, tile_q=tq, refine_factor=rf,
                             top2=top2)
    launches = {"K5": pq.pq_tiles_topk.launches, "K1": band.tiles_topk_resid.launches,
                "K8": rescore.rescore_int8.launches}
    log(f"[pq] {card}: build {build_s:.1f} s, op {op}, refine route recall@{K} "
        f"{recall_rf:.4f} at {qps_rf['qps']:.1f} QPS; PQ route "
        + "; ".join(f"{k}: {r:.4f} at {q_['qps']:.1f} QPS" for k, (r, q_) in routes.items())
        + f"; launches {launches}")
    low = {n: routes[n][0] for n, floor in PQ_ROUTE_FLOORS.items() if routes[n][0] < floor}
    if launches["K5"] <= 0 or launches["K8"] != launches["K5"] or low:
        raise AssertionError(f"config #3 PQ route: K5 launches {launches['K5']}, K8 launches "
                             f"{launches['K8']} (one a K5 launch), recall@{K} below its floor "
                             f"{PQ_ROUTE_FLOORS}: {low}")

    # K1 and K5 against their plain versions on the plan both routes serve
    st, q_s, table, exact, plans = pq_holds(idx, queries, p_tiles, tq)
    k1_args = dict(db_resid=st["refine"], local_ids=st["local"],
                   centroid_tiles=st["centroid_tiles"], resid_scale=idx._scale,
                   queries_sorted=q_s, tile_table=table, valid_end=st["refine_valid_end"],
                   tile_n=idx.tile_n, tile_q=tq)
    mp = {"K1 refine": k1_check(f"refine arena B{queries.shape[0]} p{p_tiles} tq{tq}", idx,
                                k1_args, reps=5, plain_reps=1)}
    used, rows_scored = table_work(table, tq, idx.tile_n, 1)
    w = st["centroid_tiles"].shape[1]
    for name, args in plans.items():
        l_buckets, n_pools, top2 = args["l_buckets"], args["n_pools"], args["top2"]
        r = main_shape_check(
            "K5", pq_plan_label(name, args, queries.shape[0], p_tiles),
            lambda: pq.pq_tiles_topk(**args), lambda: pq.pq_tiles_topk_reference(**args),
            reps=5 if name == "rf64" else 2, plain_reps=1, exact=exact)
        n_slots = (2 if top2 else 1) * n_pools
        r.update(pq_bound(PQ_M + 1, rows_scored, used * idx.tile_n, used * w * D * 2, q_s,
                          queries.shape[0] * n_slots * l_buckets * 8, PQ_M, 2 ** PQ_NBITS,
                          D // PQ_M))
        log(f"[kernel] K5 {name}: {2.0 * rows_scored * D / r['ms'] / 1e9:.2f} T flop/s in the "
            f"decode form, {split_form_flops(table, tq, idx.tile_n, w) / r['ms'] / 1e9:.2f} T "
            f"bf16 flop/s in the split form; bound {r['bound_ms']:.3f} ms ({r['bound_by']}): "
            f"{used} of {idx._tune_n_tiles()} tiles read, {rows_scored:.4g} (query, row) pairs "
            f"scored")
        mp["K5" if name == "rf64" else f"K5 {name}"] = r
    mp["K8"] = rescore_main_check(idx, st, queries, plans["rf64"], p_tiles, tq)
    del st, args, plans, k1_args, exact
    # the cell's plan, where K5 holds 64 queries a block
    _, _, table, exact, plans = pq_holds(idx, queries, PQ_CELL_P, PQ_CELL_TQ, PQ_CELL_PLAN)
    args = plans["cell"]
    if k5_block_queries(args) != 64:
        raise AssertionError(f"K5 at the cell's plan: {k5_block_queries(args)} queries a block")
    mp["K5 cell"] = main_shape_check(
        "K5", pq_plan_label("cell", args, queries.shape[0], PQ_CELL_P) + " (64 a block)",
        lambda: pq.pq_tiles_topk(**args), lambda: pq.pq_tiles_topk_reference(**args), reps=2,
        plain_reps=1, exact=exact, id_floor=PQ_CELL_ID_FLOOR)
    del idx, table, exact, plans, args
    return dict(launches={"K5": launches["K5"], "K1 refine": launches["K1"],
                          "K8": launches["K8"]}, mp=mp)


def k6_inputs(chunk_fn):
    """K6's corpus: the first 1M rows, codebooks trained non-residually (m
    64) on 65,536 of them, the rows encoded code-major; (rows, codebooks,
    (m, N) codes, seconds of training and encoding)."""
    x = torch.cat([chunk_fn(0), chunk_fn(1)])[:K6_ROWS]
    t0 = time.perf_counter()
    cb = train_pq(x[:K6_TRAIN], PQ_M, PQ_NBITS, iters=8, seed=0)
    codes_cm = pq_encode(x, cb).T.contiguous()
    sync()
    return x, cb, codes_cm, time.perf_counter() - t0


def run_k6(dev, chunk_fn, queries, card) -> dict:
    """K6 (``pq_topk``, the full PQ scan; no index reaches it): codebooks
    trained non-residually (m 64) on 65,536 corpus rows, the first 1M rows
    encoded, the 4096 queries, k 10, tile_n 2048; its launch count is reset
    just before the scan and read after. Recall against the exact f32 scan
    of those rows, then K6 against its plain version, both timed."""
    x, cb, codes_cm, train_s = k6_inputs(chunk_fn)
    _, exact = tiled_topk(x, queries, K, metric="ip", tile=8192)
    # the scan's own oracle: the exact top-k over the bf16 reconstructions
    x_hat = pq_decode(codes_cm.T, cb.to(torch.bfloat16).float())
    _, oracle = tiled_topk(x_hat, queries.to(torch.bfloat16).float(), K, metric="ip",
                           tile=8192)
    del x_hat
    reset_launches()
    _, found = pq.pq_topk(codes_cm, cb, queries, K, tile_n=K6_TILE_N)
    launches = pq.pq_topk.launches
    found = found.cpu().numpy()
    recall = recall_at_k(found, exact.cpu().numpy())
    recall_oracle = recall_at_k(found, oracle.cpu().numpy())
    log(f"[k6] {card}: codebooks on {K6_TRAIN} rows + encode of {K6_ROWS} rows "
        f"{train_s:.1f} s; pq_topk over {K6_ROWS} x {PQ_M} codes, B {queries.shape[0]}: "
        f"recall@{K} {recall:.4f} vs the exact f32 scan of the rows, {recall_oracle:.4f} vs "
        f"the exact scan of their reconstructions; K6 launches {launches}")
    kw = dict(tile_n=K6_TILE_N)
    mp = main_shape_check(
        "K6", f"{K6_ROWS}x{PQ_M} codes B{queries.shape[0]} tile_n {K6_TILE_N}",
        lambda: pq.pq_topk(codes_cm, cb, queries, K, **kw),
        lambda: pq.pq_topk_reference(codes_cm, cb, queries, K, **kw), reps=2, plain_reps=1,
        exact=pq_exact(codes_cm.T, None, cb, None, K6_TILE_N, queries))
    mp.update(pq_bound(PQ_M, queries.shape[0] * K6_ROWS, K6_ROWS, 0, queries.to(torch.bfloat16),
                       queries.shape[0] * K6_TILE_N * 8, PQ_M, 2 ** PQ_NBITS, D // PQ_M))
    log(f"[kernel] K6: {2.0 * queries.shape[0] * K6_ROWS * D / mp['ms'] / 1e9:.2f} T bf16 "
        f"flop/s (the split form has no centroid term here); bound {mp['bound_ms']:.3f} ms "
        f"({mp['bound_by']})")
    return dict(launches={"K6": launches}, mp={"K6": mp})


# -- cell 13: BASELINE config #5 (PQ tiles at 125M rows) ----------------------
#: config #5's per-card share (scripts/bench_config5.py:1-16,40-52): 125M x
#: 768 of the corpus's process (chunks 0-249), OPQ + IVF-PQ m 64, nbits 8,
#: refine 'pq2' (m2 32), nlist 16384, tile_n 1024, k-means 8 and PQ 6
#: iterations; the updates: 131,072 added rows (chunk 250), 8,192 removes,
#: 1,024 reconstructs
C5_ROWS, C5_NLIST, C5_M2, C5_TILE_N = 125_000_000, 16_384, 32, 1024
C5_ADD, C5_REMOVE, C5_RECON, C5_SELF = 131_072, 8192, 1024, 256
C5_KW = dict(nlist=C5_NLIST, m=PQ_M, nbits=PQ_NBITS, opq=True, refine="pq2", m2=C5_M2,
             tile_n=C5_TILE_N, train_sample=262_144, kmeans_iters=8, pq_train_iters=6)
#: pq2's recall may not fall below the same plan's tier-1 recall by more
PQ2_SLACK = 0.005
#: the segmented dispatch's recall may not fall below the joined
#: dispatch's on the same arena by more (its pools only widen)
C5_SEG_SLACK = 0.005
#: the reference's best recall@10 at this cell (VERDICT.md:117-119, TPU r4,
#: the pq2+host cascade), quoted as recall only; not a floor
C5_REF_RECALL = 0.928
#: cell 13's tune target, just under its method's oracle (0.3420 on the card,
#: PR 13): at 0.95, out of the method's reach, the tuner walked all 90
#: candidates (148.4 s of the run) to return its best-recall one
C5_TUNE_TARGET = 0.33
#: K5's holds at cell 13's op plan: each bucket slot takes the best of
#: ~4,800 rows (cell 7's plans: 224), so exact near-ties within EXACT_TIE
#: reorder ~20x more slots than EXACT_ID_FLOOR was set on (an H100 run read
#: 0.96894 by position there, every differing id within the tie window and
#: the kernel's ids' exact sum above the plain version's: PERF.md, PR 13);
#: every other criterion of ``compare`` holds as for cell 7
C5_ID_FLOOR = 0.95
#: reconstruct: each row the decode of its id's arena row within this, and
#: its cosine to its source row at least C5_RECON_COS (a PQ decode, m 64)
C5_RECON_TOL, C5_RECON_COS = 1e-4, 0.8
#: the smaller checks: rows of (a) l2 and (c) anisotropic codebooks, of (d)
#: build_streaming; nlist of (a), (c), (d) (cell 11's); the cascade (b) on
#: cell 7's first 10M rows at these host factors
C5_SMALL_ROWS, C5_STREAM_ROWS, C5_SMALL_NLIST = 500_000, 1_000_000, 1024
C5_HOST_FACTORS = (32, 102)


def c5_build(dev, chunk_fn, n_chunks: int, **kw):
    """build_device_streaming at cell 13's settings (``kw`` overrides);
    (index, seconds)."""
    t0 = time.perf_counter()
    idx = BandIVFPQIndex.build_device_streaming(chunk_fn, n_chunks, device=dev,
                                                **{**C5_KW, **kw})
    sync()
    return idx, time.perf_counter() - t0


def c5_truths(chunk_fn, n_chunks: int, queries, added, removed: np.ndarray, masks: dict,
              names) -> dict:
    """Cell 13's exact f32 truths: the top-K of every query over the
    corpus (the tuner's), and of the first NQ_GT with the added rows, after
    the removes (from the top 2K of the corpus and of the added rows: at
    most K of either may be removed) and under each filter (``names``, and
    the 10% filter with the added rows)."""
    q_gt = queries[:NQ_GT]
    v, i = exact_chunks_topk(chunk_fn, n_chunks, CHUNK, queries, 2 * K)
    out = {"all": i[:, :K].cpu().numpy()}
    va, ia = tiled_topk(added, q_gt, 2 * K, metric="ip", tile=8192)
    cv = torch.cat([v[:NQ_GT], va], 1)
    ci = torch.cat([i[:NQ_GT], ia + C5_ROWS], 1)
    _, pos = topk_stable(cv, K)
    out["added"] = torch.gather(ci, 1, pos).cpu().numpy()
    gone = torch.as_tensor(np.isin(ci.cpu().numpy(), removed), device=cv.device)
    if int(gone[:, :2 * K].sum(1).max()) > K or int(gone[:, 2 * K:].sum(1).max()) > K:
        raise AssertionError("c5: more than K removed ids in a top-2K: deepen the truth")
    _, pos = topk_stable(torch.where(gone, float("-inf"), cv), K)
    out["removed"] = torch.gather(ci, 1, pos).cpu().numpy()
    gid = torch.arange(C5_ROWS + added.shape[0], device=q_gt.device)
    out.update(exact_states(corpus_segments(chunk_fn, n_chunks) + [(C5_ROWS, lambda: added)],
                            q_gt, {**{name: masks[name] & (gid < C5_ROWS) for name in names},
                                   "added 10%": masks["random 10%"]}))
    return out


def pq_oracles(idx, q: torch.Tensor, gt: np.ndarray, block: int = 1 << 20) -> dict:
    """The method's own ceilings, its plain oracles: recall@K of the exact
    f32 top-K over every arena row's reconstruction, tier 1 (the list
    centroid plus the PQ decode) and tier 1 plus the tier-2 decode, with no
    plan and no candidate budget; in the index's rotated space."""
    st = idx._device_state()
    qr = idx._rotate(q)
    cb2 = idx._codebooks2_dev()
    codes2 = idx._codes2_device()
    lists = torch.as_tensor(idx._list_of_rows(), device=q.device).long()
    gids = st["ids"].long()
    best = {name: None for name in ("tier 1", "tier 1 + 2")}
    for lo in range(0, idx._n, block):
        hi = min(idx._n, lo + block)
        x = pq_decode(st["codes"][lo:hi], st["codebooks"]) + st["centroids"][lists[lo:hi]]
        for name in best:
            if name == "tier 1 + 2":
                x = x + pq_decode(codes2[gids[lo:hi]], cb2)
            v, pos = ivf_band_module._scan_topk(lambda a, b: qr @ x[a:b].T, hi - lo, K,
                                                q.shape[0])
            g = gids[lo:hi][pos]
            best[name] = (v, g) if best[name] is None else merge_topk(*best[name], v, g, K)
    return {name: recall_at_k(b[1].cpu().numpy(), gt) for name, b in best.items()}


def tier1_search(idx, queries, k: int, p_tiles: int, tq: int, rf: int, top2: bool):
    """The PQ route's plan (p_tiles, tile_q, refine_factor, top2) without the
    pq2 rescore: the kernel's top-k of the same k_cand candidates by their
    tier-1 scores; (scores, ids) on the device."""
    st = idx._device_state()
    _, k_cand, n_pools, l_buckets, _ = idx._pq_stage_plan(k, rf, 0, tq, p_tiles, top2)
    qp = idx._rotate(queries)
    return ivf_band_module._pq_tiles_plan_search(
        qp, st["centroids"], st["codes"], st["codebooks"], st["refine"], st["ids"],
        st["tile_window"], st["centroid_tiles"], idx._n, st["local"], k=k, k_cand=k_cand,
        p_tiles=p_tiles, tile_n=idx.tile_n, tile_q=tq, refine_scale=0.0, n_pools=n_pools,
        l_buckets=l_buckets, top2=top2, segments=idx._seg_rows())


def c5_k5_holds(idx, queries, op: dict, rm10) -> dict:
    """K5's segmented dispatch (the index's five segments) against its plain
    version at the op point's plan in four forms: plain (the record 'K5
    seg'), masked (the 10% filter's arena mask), masked with top-2, and l2
    (its row bias from the bias kernel, the plain version's from the decoded
    rows); ids held through exact f64 scores (``pq_exact``), each timed (a
    call's launches together), with its bound: each distinct tile's codes,
    local bytes and centroid tiles, a mask byte or four bias bytes a row,
    the queries and slots."""
    st = idx._device_state()
    p_tiles, tq, rf = op["p_tiles"], op.get("tile_q", idx.tile_q), op.get("refine_factor", 16)
    q_s, _, _, table = _plan_tiles(idx._rotate(queries), st["centroids"], st["tile_window"],
                                   tq, p_tiles)
    used, rows_scored = table_work(table, tq, idx.tile_n, 1)
    w = st["centroid_tiles"].shape[1]
    forms = {"K5 seg": (False, False, False), "K5 masked": (True, False, False),
             "K5 masked top2": (True, True, False), "K5 l2": (False, False, True)}
    segments = idx._seg_rows()
    out = {}
    for key, (masked, top2, l2) in forms.items():
        _, k_cand, n_pools, l_buckets, _ = idx._pq_stage_plan(K, rf, 0, tq, p_tiles, top2)
        args = dict(codes_cm=st["codes"], codebooks=st["codebooks"], queries_sorted=q_s,
                    tile_table=table, k=k_cand, centroid_tiles=st["centroid_tiles"],
                    tile_n=idx.tile_n, tile_q=tq, l_buckets=l_buckets, n_valid=idx._n,
                    row_major=True, local_ids=st["local"], n_pools=n_pools, top2=top2,
                    row_mask=rm10 if masked else None, l2=l2, segments=segments)
        kern = dict(args)
        if l2:
            kern["row_bias"] = pq.pq_row_bias(st["codes"], st["local"], st["codebooks"],
                                              st["centroid_tiles"], idx.tile_n)
        label = (f"{key[3:]} B{queries.shape[0]} p{p_tiles} tq{tq} k_cand {k_cand} "
                 f"L{l_buckets} pools {n_pools} segments {len(segments or (0,))}")
        hold = dict(allow=rm10 if masked else None, id_floor=C5_ID_FLOOR,
                    exact=pq_exact(st["codes"], st["local"], st["codebooks"],
                                   st["centroid_tiles"], idx.tile_n, q_s, l2=l2))
        # the plain version (~11 s a call at this plan on an H100) runs once:
        # its hold's call is its timing
        plain = timed(lambda: pq.pq_tiles_topk_reference(**args))
        err = compare(f"K5 {label}", lambda: pq.pq_tiles_topk(**kern), plain, **hold)
        if key not in KERNELS:  # held, not a record
            out[key] = dict(err=err)
            continue
        before = pq.pq_tiles_topk.seg_launches
        r = dict(err=err, ms=time_ms(lambda: pq.pq_tiles_topk(**kern), 3),
                 plain_ms=plain.ms, shape=label)
        per_call = (pq.pq_tiles_topk.seg_launches - before) // 4
        log(f"[kernel] K5 {label}: kernel {r['ms']:.3f} ms ({per_call} launches a call, "
            f"together), plain version {r['plain_ms']:.3f} ms (one call)")
        side = (1 if masked else 0) + (4 if l2 else 0)
        n_slots = (2 if top2 else 1) * n_pools
        r.update(pq_bound(PQ_M + 1 + side, rows_scored, used * idx.tile_n, used * w * D * 2,
                          q_s, queries.shape[0] * n_slots * l_buckets * 8, PQ_M,
                          2 ** PQ_NBITS, D // PQ_M))
        log(f"[kernel] {key}: {split_form_flops(table, tq, idx.tile_n, w) / r['ms'] / 1e9:.2f} "
            f"T bf16 flop/s in the split form; bound {r['bound_ms']:.3f} ms ({r['bound_by']}): "
            f"{used} of {idx._tune_n_tiles()} tiles read")
        out[key] = r
    return out


def run_config5(dev, chunk_fn, queries, card, reps: int = 5) -> dict:
    """Cell 13, BASELINE config #5 at its per-card share (module docstring,
    phase 10): build, tune(gt=), serve, filters, updates, K5's holds. The
    launch counts are reset just before the build and read after serving,
    and again around the filtered searches."""
    n_chunks = C5_ROWS // CHUNK
    q_gt = queries[:NQ_GT]
    launches = {}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    idx, build_s = c5_build(dev, chunk_fn, n_chunks)
    log(f"[c5] built {idx.ntotal} x {D} OPQ+IVF-PQ (nlist {C5_NLIST}, m {PQ_M}, pq2 m2 "
        f"{C5_M2}, tile_n {idx.tile_n}, W={idx._tile_window.shape[1]}, "
        f"{idx._tune_n_tiles()} tiles): {build_s:.1f} s ({idx.ntotal / build_s:,.0f} rows/s); "
        f"device memory {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB resident "
        f"(codes {nbytes(idx._codes) / 2**30:.2f}, tier-2 codes "
        f"{nbytes(idx._codes2) / 2**30:.2f}), peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")

    # one pass over the corpus and the added rows: every state's exact truth
    added = chunk_fn(n_chunks)[:C5_ADD]
    n_ids = C5_ROWS + C5_ADD
    masks = make_filters(idx, dev, n_ids, n_rows=C5_ROWS)
    rm_names = ("random 10%", f"correlated {CORRELATED_LISTS} lists")
    removed = np.sort(np.random.default_rng(13).choice(n_ids, C5_REMOVE, replace=False))
    t0 = time.perf_counter()
    gts = c5_truths(chunk_fn, n_chunks, queries, added, removed, masks, rm_names)
    gt_all = gts.pop("all")  # tune(gt=) at B 4096
    gts["built"] = gt_all[:NQ_GT]
    log(f"[c5] exact f32 ground truths: {queries.shape[0]} queries over {C5_ROWS} rows, then "
        f"{NQ_GT} over {n_ids} rows in each state: {time.perf_counter() - t0:.1f} s")

    report = tune_logged(idx, queries, "c5", gt=gt_all, target=C5_TUNE_TARGET)
    op = dict(report["op"])
    p_tiles, tq, rf = op["p_tiles"], op.get("tile_q", idx.tile_q), op.get("refine_factor", 16)
    top2 = bool(op.get("top2"))
    recall, qps = serve(idx, queries, gts["built"], reps, "c5 pq2")
    launches["K5"] = pq.pq_tiles_topk.launches  # build, tune and serve
    launches["K5 seg"] = pq.pq_tiles_topk.seg_launches
    if idx._seg_rows() is None or launches["K5 seg"] != launches["K5"]:
        raise AssertionError(f"c5: the arena's {idx._n_pad_rows} rows are not dispatched in "
                             f"segments ({launches['K5 seg']} of {launches['K5']} launches)")
    # the joined dispatch on the same arena: the cap past its rows, no rebuild
    idx.seg_rows_cap = idx._n_pad_rows
    recall_j, qps_j = serve(idx, queries, gts["built"], 3, "c5 pq2 joined dispatch")
    del idx.seg_rows_cap
    log(f"[c5] {card}: {len(idx._seg_rows())} segments ({idx._seg_n_valid()} rows) against "
        f"the joined dispatch on the same arena: recall@{K} {recall:.4f} against "
        f"{recall_j:.4f}, device QPS {qps['qps']:.1f} against {qps_j['qps']:.1f}")
    if recall < recall_j - C5_SEG_SLACK:
        raise AssertionError(f"c5: segmented recall {recall:.4f} below the joined dispatch's "
                             f"{recall_j:.4f} by more than {C5_SEG_SLACK}")
    _, ids1 = tier1_search(idx, queries, K, p_tiles, tq, rf, top2)
    recall1 = recall_at_k(ids1[:NQ_GT].cpu().numpy(), gts["built"])
    t0 = time.perf_counter()
    oracle = pq_oracles(idx, q_gt, gts["built"])
    log(f"[c5] the method's plain oracles (the exact f32 top-{K} over every row's "
        f"reconstruction, no plan): " + ", ".join(f"{k} {v:.4f}" for k, v in oracle.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    log(f"[c5] {card}: op {op}: recall@{K} {recall:.4f} vs exact f32 (the reference's best "
        f"at this cell {C5_REF_RECALL}, its pq2+host cascade on a TPU, segmented: recall "
        f"only); the same plan without the pq2 rescore {recall1:.4f}; device QPS "
        f"{qps['qps']:.1f} (median {qps['ms_median']:.3f} ms); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if recall < recall1 - PQ2_SLACK:
        raise AssertionError(f"c5: pq2 recall {recall:.4f} below tier-1 {recall1:.4f}")

    # filtered search at the op point
    flts = {name: idx.make_filter(masks[name].cpu().numpy()) for name in rm_names}
    k5m = 0
    for name in rm_names:
        (v, ids), n = counted(lambda: idx.search_device(queries, K, where=flts[name]))
        k5m += n["K5"]
        check_filtered(v, ids, masks[name], f"c5 filtered {name}")
        fq = qps_device(lambda q: idx.search_device(q, K, where=flts[name]), queries, reps=3)
        log(f"[c5] filtered {name}: recall@{K} vs exact filtered f32 "
            f"{recall_at_k(ids[:NQ_GT].cpu().numpy(), gts[name]):.4f}; device QPS "
            f"{fq['qps']:.1f}; no disallowed id, unfilled slots (-inf, -1)")

    # updates: add (pending), plain and filtered search, merge, remove, reconstruct
    flt_add = idx.make_filter(masks["random 10%"].cpu().numpy())
    _, _, add_s = fenced(lambda: idx.add(added))
    if idx._pending.size != C5_ADD:
        raise AssertionError(f"c5: {idx._pending.size} rows pending after the add")
    mut_serve(idx, queries, gts["added"], f"c5 {C5_ADD} rows pending", 0.0, reps=3)
    (v, ids), n = counted(lambda: idx.search_device(queries, K, where=flt_add))
    k5m += n["K5"]
    check_filtered(v, ids, masks["random 10%"], "c5 filtered with rows pending")
    allowed_new = torch.nonzero(masks["random 10%"][C5_ROWS:])[:C5_SELF, 0]
    _, own = idx.search_device(added[allowed_new], 1, where=flt_add)
    hit = float((own[:, 0].long() == C5_ROWS + allowed_new).float().mean())
    log(f"[c5] filtered with rows pending: recall@{K} vs exact filtered f32 "
        f"{recall_at_k(ids[:NQ_GT].cpu().numpy(), gts['added 10%']):.4f}; no disallowed id; "
        f"{allowed_new.numel()} allowed pending rows as queries: self-hit@1 {hit:.4f}")
    if hit < SELF_HIT_EXACT:
        raise AssertionError(f"c5: allowed pending rows not returned (self-hit {hit:.4f})")
    _, host_m, merge_s = fenced(idx.merge_pending)
    log(f"[c5] {card}: add of {C5_ADD} rows {add_s:.3f} s ({C5_ADD / add_s:,.0f} rows/s); "
        f"merge_pending {merge_s:.3f} s (host clock to return {host_m:.3f} s) into "
        f"{idx.ntotal} rows")
    n_rem, host_r, rem_s = fenced(lambda: idx.remove(removed))
    if n_rem != C5_REMOVE or idx.ntotal != n_ids - C5_REMOVE:
        raise AssertionError(f"c5: remove took {n_rem} rows, ntotal {idx.ntotal}")
    log(f"[c5] {card}: remove of {C5_REMOVE} ids {rem_s:.3f} s ({C5_REMOVE / rem_s:,.0f} "
        f"rows/s; host clock to return {host_r:.3f} s)")
    mut_serve(idx, queries, gts["removed"], "c5 after the removes", 0.0, removed=removed, reps=3)
    keep = np.setdiff1d(np.arange(7 * CHUNK, 8 * CHUNK), removed)
    rec_ids = np.concatenate([keep[:C5_RECON // 2], C5_ROWS + np.setdiff1d(
        np.arange(C5_ADD), removed - C5_ROWS)[:C5_RECON // 2]])
    src = torch.cat([chunk_fn(7)[torch.as_tensor(rec_ids[:C5_RECON // 2] - 7 * CHUNK,
                                                 device=dev)],
                     added[torch.as_tensor(rec_ids[C5_RECON // 2:] - C5_ROWS, device=dev)]])
    rec, _, rec_s = fenced(lambda: idx.reconstruct(rec_ids))
    rec = torch.as_tensor(rec, device=dev)
    # the decode of each id's arena row, found through the id table
    pos = np.full(idx._gid_bound(), -1, np.int64)
    pos[idx._ids[: idx._n]] = np.arange(idx._n)
    rows = pos[rec_ids]
    lists = np.searchsorted(idx._offsets, rows, side="right") - 1
    want = (pq_decode(idx._codes[torch.as_tensor(rows, device=dev)],
                      torch.as_tensor(idx.codebooks, device=dev))
            + torch.as_tensor(idx.centroids[lists], device=dev)) @ torch.as_tensor(
                idx.opq_matrix, device=dev)
    off = float((rec - want).abs().max())
    cos = float(((rec * src).sum(1) / rec.norm(dim=1) / src.norm(dim=1)).min())
    log(f"[c5] {card}: reconstruct of {C5_RECON} ids {rec_s:.3f} s; max |it - the decode| "
        f"{off:.3g}; least cosine to the source rows {cos:.5f}")
    if off > C5_RECON_TOL or cos < C5_RECON_COS:
        raise AssertionError(f"c5: reconstruct off the decode by {off:.3g}, cosine {cos:.5f}")
    launches["K5 masked"] = k5m

    mp = c5_k5_holds(idx, queries, op, idx._arena_filter(flt_add)[0])
    log(f"[c5] {card}: build {build_s:.1f} s; op {op}; recall@{K} {recall:.4f} (tier-1 "
        f"{recall1:.4f}); {qps['qps']:.1f} QPS; add {C5_ADD / add_s:,.0f} rows/s, merge "
        f"{merge_s:.3f} s, remove {C5_REMOVE / rem_s:,.0f} rows/s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del idx, gts, added, masks, flts
    return dict(launches=launches, mp=mp,
                report=dict(recall=recall, recall1=recall1, qps=qps, op=op, oracle=oracle,
                            recall_joined=recall_j, qps_joined=qps_j))


def l2_corpus(chunk_fn, dev):
    """Cell 1's process with a norm in [0.5, 3.0] a row (seeded per chunk),
    so that l2 and ip rankings differ."""
    def fn(i: int) -> torch.Tensor:
        g = torch.Generator(device=dev)
        g.manual_seed(20_000 + i)
        x = chunk_fn(i)
        return x * (0.5 + 2.5 * torch.rand((x.shape[0], 1), generator=g, device=dev))

    return fn


def c5_small_checks(dev, chunk_fn, queries, card) -> dict:
    """Cell 13's smaller checks: (a) l2 at C5_SMALL_ROWS (pq2 and int8 builds,
    both routes, against the exact l2 truth; K5's bias kernel held), (b) the
    pq2+host cascade on cell 7's first 10M rows, (c) anisotropic codebooks
    at C5_SMALL_ROWS, (d) build_streaming and merge_from at C5_STREAM_ROWS."""
    q_gt = queries[:NQ_GT]
    small = C5_SMALL_ROWS // CHUNK
    kw = dict(nlist=C5_SMALL_NLIST, tile_n=C5_TILE_N)
    launches, mp = {}, {}

    # (a) l2: pq2 (the PQ route) and int8 (both routes)
    l2fn = l2_corpus(chunk_fn, dev)
    gt_l2 = exact_gt(l2fn, small, CHUNK, q_gt, metric="l2")
    gt_ip = exact_gt(l2fn, small, CHUNK, q_gt)
    lines = []
    launches["K5 l2"] = launches["K5b"] = 0
    for refine in ("pq2", "int8"):
        reset_launches()
        idx, build_s = c5_build(dev, l2fn, small, refine=refine, metric="l2", **kw)
        routes = ("pq", "refine") if refine == "int8" else ("pq",)
        for route in routes:
            got = []
            for p in (max(1, idx._tune_n_tiles() // 8), idx._tune_n_tiles()):
                v, ids = idx.search_device(queries, K, serve_from=route, refine_factor=64,
                                           p_tiles=p)
                check_result(v.cpu().numpy(), ids.cpu().numpy(), queries.shape[0], idx.ntotal,
                             f"l2 {refine} {route}")
                got.append(f"{recall_at_k(ids[:NQ_GT].cpu().numpy(), gt_l2):.4f}")
            lines.append(f"{refine} {route} {' / '.join(got)}")
        sync()
        launches["K5 l2"] += pq.pq_tiles_topk.launches
        launches["K5b"] += pq.pq_row_bias.launches
        if refine == "pq2":
            st = idx._device_state()
            err = pq_bias_compare(f"{idx.ntotal} x {D} l2 arena", st["codes"], st["local"],
                                  st["codebooks"], st["centroid_tiles"], idx.tile_n)
            args = (st["codes"], st["local"], st["codebooks"], st["centroid_tiles"], idx.tile_n)
            ms = time_ms(lambda: pq.pq_row_bias(*args), 5)
            plain_ms = time_ms(lambda: pq.pq_row_bias_reference(*args), 1)
            n = st["codes"].shape[0]
            mp["K5b"] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                             shape=f"{n} x {PQ_M} codes",
                             **bound(nbytes(st["codes"], st["local"], st["centroid_tiles"],
                                            st["codebooks"]) + 4 * n, 2.0 * n * D, "f32"))
            log(f"[kernel] K5b over {n} x {PQ_M} codes: kernel {ms:.3f} ms, plain version "
                f"{plain_ms:.3f} ms; bound {mp['K5b']['bound_ms']:.3f} ms "
                f"({mp['K5b']['bound_by']})")
        del idx
        torch.cuda.empty_cache()
    same = float((np.sort(gt_l2, 1) == np.sort(gt_ip, 1)).mean())
    log(f"[c5 a] l2 at {C5_SMALL_ROWS} rows, norms 0.5-3.0 (the l2 truth's ids {same:.4f} the "
        f"ip truth's): recall@{K} vs exact f32 l2 at 1/8 and all of the tiles, rf 64: "
        + ", ".join(lines)
        + f"; K5 launches {launches['K5 l2']}, bias launches {launches['K5b']}")

    # (b) the cascade on cell 7's first 10M rows
    n_c = PQ_ROWS // CHUNK
    gt7 = exact_gt(chunk_fn, n_c, CHUNK, q_gt)
    idx, build_s = c5_build(dev, chunk_fn, n_c, nlist=NLIST, tile_n=1024)
    t0 = time.perf_counter()
    idx.attach_host_refine(lambda i: idx._rotate(chunk_fn(i)).cpu().numpy(), n_c,
                           chunks_rotated=True)
    attach_s = time.perf_counter() - t0
    # the tuner's max-effort cascade plan (refine_factor 820) on 1/4 of the tiles
    rf, p = 820, idx._tune_n_tiles() // 4
    _, f2 = idx.search_device(q_gt, K, refine_factor=rf, p_tiles=p)  # the on-card prefix
    res = [f"pq2 only {recall_at_k(f2.cpu().numpy(), gt7):.4f}"]
    for hf in C5_HOST_FACTORS:
        t0 = time.perf_counter()
        v, f = idx.search(q_gt.cpu().numpy(), K, refine_factor=rf, p_tiles=p, host_factor=hf)
        dt = time.perf_counter() - t0
        check_result(v, f, NQ_GT, idx.ntotal, f"cascade hf {hf}")
        res.append(f"host_factor {hf}: {recall_at_k(f, gt7):.4f} ({NQ_GT / dt:,.0f} QPS host "
                   f"clock)")
    log(f"[c5 b] {card}: pq2+host cascade at {PQ_ROWS} rows (the one cut: 125M rows would "
        f"hold 96 GB of host int8), build {build_s:.1f} s, attach {attach_s:.1f} s "
        f"({idx._host_rows.nbytes / 1e9:.2f} GB host int8); rf {rf}, p_tiles {p}: "
        + "; ".join(res))
    single = single_cascade_recalls(idx, q_gt, gt7, rf, p)
    quant = dict(opq_matrix=idx.opq_matrix, centroids=idx.centroids, codebooks=idx.codebooks,
                 codebooks2=idx.codebooks2)
    del idx
    torch.cuda.empty_cache()
    out15 = run_sharded_config5(dev, chunk_fn, queries, gt7, quant, single, card)
    launches.update(out15["launches"])
    mp.update(out15["mp"])

    # (c) anisotropic codebooks beside the plain ones, at full coverage
    gt1 = exact_gt(chunk_fn, small, CHUNK, q_gt)
    rec = []
    for eta in (0.0, 4.0):
        idx, build_s = c5_build(dev, chunk_fn, small, refine="none", aniso_eta=eta, **kw)
        _, f = idx.search_device(q_gt, K, p_tiles=idx._tune_n_tiles())
        rec.append(f"aniso_eta {eta}: {recall_at_k(f.cpu().numpy(), gt1):.4f} (build "
                   f"{build_s:.1f} s)")
        del idx
    log(f"[c5 c] anisotropic codebooks at {C5_SMALL_ROWS} rows, refine 'none', full "
        f"coverage: recall@{K} " + "; ".join(rec))
    torch.cuda.empty_cache()

    # (d) build_streaming and merge_from
    n_s = C5_STREAM_ROWS // CHUNK
    d, _ = c5_build(dev, chunk_fn, n_s, **kw)
    quant = dict(centroids=d.centroids, codebooks=d.codebooks, codebooks2=d.codebooks2,
                 opq_matrix=d.opq_matrix)
    kw_q = {**C5_KW, **kw, **quant, "opq": False}
    s = BandIVFPQIndex.build_streaming((chunk_fn(i) for i in range(n_s)), device=dev, **kw_q)
    same_codes = (torch.equal(s._codes, d._codes) and torch.equal(s._local, d._local)
                  and np.array_equal(s._ids, d._ids)
                  and torch.equal(s._codes2_device(), d._codes2_device()))
    half = n_s // 2
    a = BandIVFPQIndex.build_device_streaming(chunk_fn, half, device=dev, **kw_q)
    b = BandIVFPQIndex.build_device_streaming(lambda i: chunk_fn(half + i), n_s - half,
                                              device=dev, **kw_q)
    a.merge_from(b, id_offset=half * CHUNK)
    gt2 = exact_gt(chunk_fn, n_s, CHUNK, q_gt)
    p = d._tune_n_tiles() // 8
    r_one = recall_at_k(d.search_device(q_gt, K, p_tiles=p, refine_factor=64)[1].cpu().numpy(),
                        gt2)
    r_merged = recall_at_k(a.search_device(q_gt, K, p_tiles=p, refine_factor=64)[1]
                           .cpu().numpy(), gt2)
    same_arena = torch.equal(a._codes, d._codes) and np.array_equal(a._ids, d._ids)
    log(f"[c5 d] build_streaming at {C5_STREAM_ROWS} rows: codes, local bytes, ids and tier-2 "
        f"codes equal to build_device_streaming's {same_codes}; merge_from of two "
        f"{half * CHUNK}-row halves: arena equal to one build's {same_arena}, recall@{K} "
        f"{r_merged:.4f} vs one build's {r_one:.4f}")
    if not same_codes or abs(r_merged - r_one) > 0.005:
        raise AssertionError("c5 d: build_streaming or merge_from departs from one build")
    del d, s, a, b
    torch.cuda.empty_cache()
    return dict(launches=launches, mp=mp)


# -- cell 15: config #5 across shards (parallel/dist_band_pq.py) -----------------
#: ShardedBandIVFPQIndex at BASELINE config #5's width (768-d, OPQ, m 64,
#: nbits 8, pq2 m2 32, tile_n 1024, refine 'pq2+host') on (b)'s 10M rows and
#: nlist, four shards of 2.5M on the card, on (b)'s quantizers
C15_KW = dict(nlist=NLIST, m=PQ_M, nbits=PQ_NBITS, m2=C5_M2, tile_n=C5_TILE_N,
              kmeans_iters=8, pq_train_iters=6)
#: the plan of the full-coverage holds: (b)'s refine_factor, host_factor 32;
#: pq2 and the cascade there may read this much below the single index on
#: the same plan, no more (tests/distributed/test_sharded_band_pq.py:33-94)
C15_RF, C15_HF, C15_SLACK = 820, 32, 0.02
#: tune(gt=)'s recall target at B 4096 (the repo's serving floor)
C15_TARGET = RECALL_FLOOR
C15_GROUPS = {"K5": ("pq_scan",), "GEMM": ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_"),
              "gather": ("index", "gather"), "sort and top-k": ("sort", "radix", "topk", "scan")}


def single_cascade_recalls(idx, q_gt, gt, rf: int, p: int) -> dict:
    """The single cascade index's recall@K at full coverage and at (b)'s plan
    (p tiles): pq2 alone (``search_device``'s on-card prefix) and the
    cascade at C15_HF."""
    out = {}
    for name, pt in (("full", idx._tune_n_tiles()), ("plan", p)):
        _, f2 = idx.search_device(q_gt, K, refine_factor=rf, p_tiles=pt)
        _, fc = idx.search(q_gt.cpu().numpy(), K, refine_factor=rf, p_tiles=pt,
                           host_factor=C15_HF)
        out[name] = dict(pq2=recall_at_k(f2.cpu().numpy(), gt), cascade=recall_at_k(fc, gt))
    return out


def k5_shard_hold(idx, queries, op: dict) -> dict:
    """K5 at shard 0's plan of the sharded op point (p_tiles capped at the
    shard's tiles, the wrapper's candidate budget) against its plain version,
    ids held through exact f64 scores (``pq_exact``, C5_ID_FLOOR), timed,
    with its bound as cell 13's K5."""
    sh = idx._shards[0]
    st = sh._device_state()
    tq = op.get("tile_q") or idx.proto.tile_q
    p = min(op["p_tiles"], sh._tune_n_tiles())
    top2 = bool(op.get("top2", False))
    *_, k_cand, n_pools, l_buckets, _ = idx._stage_plan(
        K, op.get("refine_factor", 16), op.get("host_factor", 64), 0, tq, op["p_tiles"], top2)
    q_s, _, _, table = _plan_tiles(sh._rotate(queries), st["centroids"], st["tile_window"], tq, p)
    args = dict(codes_cm=st["codes"], codebooks=st["codebooks"], queries_sorted=q_s,
                tile_table=table, k=k_cand, centroid_tiles=st["centroid_tiles"], tile_n=sh.tile_n,
                tile_q=tq, l_buckets=l_buckets, n_valid=sh._n, row_major=True,
                local_ids=st["local"], n_pools=n_pools, top2=top2)
    label = (f"sharded, shard 0 of {SHARDS} B{queries.shape[0]} p{p} tq{tq} k_cand {k_cand} "
             f"L{l_buckets} pools {n_pools}")
    plain = timed(lambda: pq.pq_tiles_topk_reference(**args))
    err = compare(f"K5 {label}", lambda: pq.pq_tiles_topk(**args), plain, id_floor=C5_ID_FLOOR,
                  exact=pq_exact(st["codes"], st["local"], st["codebooks"],
                                 st["centroid_tiles"], sh.tile_n, q_s))
    r = dict(err=err, ms=time_ms(lambda: pq.pq_tiles_topk(**args), 3), plain_ms=plain.ms,
             library_ms=None, shape=label)
    used, rows_scored = table_work(table, tq, sh.tile_n, 1)
    w = st["centroid_tiles"].shape[1]
    r.update(pq_bound(PQ_M + 1, rows_scored, used * sh.tile_n, used * w * D * 2, q_s,
                      queries.shape[0] * (2 if top2 else 1) * n_pools * l_buckets * 8, PQ_M,
                      2 ** PQ_NBITS, D // PQ_M))
    log(f"[kernel] K5 {label}: kernel {r['ms']:.3f} ms, plain version {r['plain_ms']:.3f} ms "
        f"(one call); bound {r['bound_ms']:.3f} ms ({r['bound_by']}): {used} of "
        f"{sh._tune_n_tiles()} tiles read")
    return {"K5 sharded": r}


def pq_store_rows(idx) -> tuple:
    """Every global id of a sharded PQ index (one process) in gid order,
    with what each layout must carry for it: its tier-1 codes and list from
    its shard's arena, and its tier-2 codes, host row and host list from its
    shard's tier stores."""
    parts = []
    for si, sh in enumerate(idx._shards):
        st, perm = idx._tier_store(si), idx._arena_perm(si)
        parts.append((np.asarray(sh._ids, np.int64)[: sh._n], sh._codes[: sh._n].cpu().numpy(),
                      np.searchsorted(sh._offsets, np.arange(sh._n), side="right") - 1,
                      st["c2"][perm], st["host"][perm], st["assign"][perm]))
    order = np.argsort(np.concatenate([p[0] for p in parts]), kind="stable")
    return tuple(np.concatenate([p[j] for p in parts])[order] for j in range(6))


def check_resharded_tiers(a, b) -> None:
    """Every global id once in each of two layouts of one sharded PQ index,
    with equal tier-1 codes, list, tier-2 codes, host row and host list."""
    ra, rb = pq_store_rows(a), pq_store_rows(b)
    names = ("ids", "codes", "lists", "tier-2 codes", "host rows", "host lists")
    bad = [n for n, x, y in zip(names, ra, rb) if not np.array_equal(x, y)]
    if bad or np.unique(ra[0]).size != ra[0].size or not np.array_equal(ra[2], ra[5]):
        raise AssertionError(f"c15: the resharded tier stores differ ({', '.join(bad)})")


def k5_candidates(idx, qn: np.ndarray, skw: dict) -> dict:
    """K5's candidates for each query in one ``search`` of a sharded PQ index
    (one process, one replica), recorded from each shard's
    ``_pq_tiles_core`` call: per shard its arena's gids, the candidate arena
    rows (Q, k_cand) and which are filled, and each query's rank of every
    tile in its tile table (-1: not in it); with the plan's n_pools,
    l_buckets, tile_n and top2."""
    from cloudvectordb_tpu_torch.parallel import dist_band_pq

    core, calls = dist_band_pq._pq_tiles_core, []

    def recording(*args, **kw):
        out = core(*args, **kw)
        calls.append((args[0], args[1], args[5], kw, out))
        return out

    dist_band_pq._pq_tiles_core = recording
    try:
        idx.search(qn, K, **skw)
    finally:
        dist_band_pq._pq_tiles_core = core
    nq, shards = qn.shape[0], []
    for sh, (q, cents, window, kw, (v, rows)) in zip(idx._shards, calls):
        _, order, _, table = _plan_tiles(q, cents, window, kw["tile_q"], kw["p_tiles"])
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        rank = torch.full((table.shape[0], window.shape[0]), -1, dtype=torch.long,
                          device=table.device)
        rank.scatter_(1, table.long(), torch.arange(table.shape[1], device=table.device)
                      .expand(table.shape[0], -1).contiguous())
        shards.append(dict(ids=np.asarray(sh._ids, np.int64),
                           rows=rows[:nq].long().cpu().numpy(),
                           filled=(v[:nq] > float("-inf")).cpu().numpy(),
                           tile_rank=rank[inv[:nq] // kw["tile_q"]].cpu().numpy()))
    if kw["k_cand"] < (2 if kw["top2"] else 1) * kw["n_pools"] * kw["l_buckets"]:
        raise ValueError("k5_collisions_explain needs a plan whose k_cand takes every slot")
    return dict(shards=shards, **{k: kw[k] for k in ("n_pools", "l_buckets", "tile_n", "top2")})


def k5_collisions_explain(res_a: tuple, res_b: tuple, ca: dict, cb: dict) -> tuple:
    """(queries whose ids differ, those of them whose K5 candidates are
    equal and whose scores are equal by position (exact ties), those
    nothing explains) between two layouts of the same rows searched at full
    coverage, from their results (scores, ids) and ``k5_candidates``. Every
    later tier is a function of each id's codes and rows (held equal by
    ``check_resharded_tiers``), so ids can differ only where the candidates
    do; and a layout's K5 keeps one row a slot (two with top2), its slot
    (shard, pool: the tile's rank in the query's table mod n_pools, bucket:
    the arena row mod l_buckets), so each candidate one layout has and the
    other lacks must share its slot in the other with as many of the
    other's own candidates."""
    def lookup(c):
        n = max(int(s["ids"].max()) for s in c["shards"]) + 1
        shard_of, row_of = np.full(n, -1), np.full(n, -1)
        for si, s in enumerate(c["shards"]):
            rows = np.flatnonzero(s["ids"] >= 0)
            shard_of[s["ids"][rows]], row_of[s["ids"][rows]] = si, rows
        return shard_of, row_of

    def cands(c, qi):
        return np.concatenate([s["ids"][s["rows"][qi][s["filled"][qi]]] for s in c["shards"]])

    def slots(c, lk, qi, gids):
        si, r = lk[0][gids], lk[1][gids]
        ranks = np.full((len(c["shards"]), max(s["tile_rank"].shape[1] for s in c["shards"])), -1)
        for j, s in enumerate(c["shards"]):
            ranks[j, : s["tile_rank"].shape[1]] = s["tile_rank"][qi]
        rank = ranks[si, r // c["tile_n"]]
        key = (si * c["n_pools"] + rank % c["n_pools"]) * c["l_buckets"] + r % c["l_buckets"]
        return np.where((si >= 0) & (rank >= 0), key, -1)

    lk = (lookup(ca), lookup(cb))
    (va, ia), (vb, ib) = res_a, res_b
    differ = np.flatnonzero((np.sort(ia, 1) != np.sort(ib, 1)).any(axis=1))
    n_tie = n_bad = 0
    for qi in differ:
        ka, kb = cands(ca, qi), cands(cb, qi)
        lost = (np.setdiff1d(ka, kb), np.setdiff1d(kb, ka))
        if not (lost[0].size or lost[1].size):
            n_tie += int(np.array_equal(va[qi], vb[qi]))
            n_bad += int(not np.array_equal(va[qi], vb[qi]))
            continue
        ok = True
        for c, l, mine, gone in ((cb, lk[1], kb, lost[0]), (ca, lk[0], ka, lost[1])):
            held = slots(c, l, qi, mine)
            key = slots(c, l, qi, gone)
            taken = np.searchsorted(np.sort(held), key, side="right") - np.searchsorted(
                np.sort(held), key, side="left")
            ok &= bool(((key >= 0) & (taken >= (2 if c["top2"] else 1))).all())
        n_bad += int(not ok)
    return int(differ.size), n_tie, n_bad


def run_sharded_config5(dev, chunk_fn, queries, gt7, quant: dict, single: dict, card) -> dict:
    """Cell 15, BASELINE config #5 across shards on the card: a 4-shard
    ``ShardedBandIVFPQIndex`` ('pq2+host', ``make_mesh(4)``: four shards of
    2.5M on this card) by ``build_streaming`` of (b)'s 10M rows on (b)'s
    quantizers (nothing trained again). Held: at full coverage pq2 alone (a
    view of the same shards) and the cascade each no more than C15_SLACK
    below the single index on the same plan, the cascade at least pq2, no
    -1 in a filled slot or id out of range, a 10% filter returning no
    disallowed id. Then ``tune(gt=)`` at B 4096 against the exact top-K of
    every query, the op point's recall and host-clock QPS (``search``
    returns numpy), a torch.profiler split, and K5 at shard 0's plan against
    its plain version (``k5_shard_hold``); then on the first MH_CHUNKS
    chunks (1M rows) save, load (equal), a 4 -> 2 reshard (every id's tiers
    equal, ``check_resharded_tiers``; each query whose ids differ explained
    by ``k5_collisions_explain``; recall within C15_SLACK) and two processes on the
    card, each loading 2 + 2 shards and gathering only its own shards' host
    rows, equal to one process. K5's launches reset just before the build
    and read after the profiled batch (the hold's not counted)."""
    from cloudvectordb_tpu_torch.parallel import ShardedBandIVFPQIndex, make_mesh

    n_c = PQ_ROWS // CHUNK
    q_gt, qn = queries[:NQ_GT], queries.cpu().numpy()
    qn_gt = qn[:NQ_GT]
    reset_launches()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    idx = ShardedBandIVFPQIndex.build_streaming(
        (chunk_fn(i) for i in range(n_c)), mesh=make_mesh(SHARDS, devices=[dev]),
        refine="pq2+host", **quant, **C15_KW)
    sync()
    build_s = time.perf_counter() - t0
    host_gb = sum(a.nbytes for chunks in idx._t_host for a in chunks) / 1e9
    log(f"[c15] {card}: built {idx.ntotal} x {D} on {SHARDS} shards of "
        f"{[sh.ntotal for sh in idx._shards]} rows ({[sh._tune_n_tiles() for sh in idx._shards]} "
        f"tiles), nlist {NLIST}, OPQ, m {PQ_M}, pq2 m2 {C5_M2}, refine 'pq2+host', (b)'s "
        f"quantizers: {build_s:.1f} s, resident {(torch.cuda.memory_allocated() - mem0) / 2 ** 30:.2f}"
        f" GiB (before staging the tier-2 codes), host int8 {host_gb:.2f} GB")
    full = idx._n_tiles()
    view = copy.copy(idx)  # pq2 alone over the same shards and stores
    view.refine, view._dev = "pq2", {}
    v2, f2 = view.search(qn_gt, K, p_tiles=full, refine_factor=C15_RF)
    del view
    vc, fc = idx.search(qn_gt, K, p_tiles=full, refine_factor=C15_RF, host_factor=C15_HF)
    for v, f, name in ((v2, f2, "pq2"), (vc, fc, "cascade")):
        check_result(v, f, NQ_GT, idx.ntotal, f"c15 full coverage {name}")
    r2, rc = recall_at_k(f2, gt7), recall_at_k(fc, gt7)
    s_full, s_plan = single["full"], single["plan"]
    log(f"[c15] full coverage ({full} tiles a shard), rf {C15_RF}, host_factor {C15_HF}: "
        f"recall@{K} pq2 {r2:.4f}, cascade {rc:.4f}; the single index on the same plan "
        f"{s_full['pq2']:.4f} / {s_full['cascade']:.4f} (at (b)'s plan {s_plan['pq2']:.4f} / "
        f"{s_plan['cascade']:.4f})")
    if r2 < s_full["pq2"] - C15_SLACK or rc < s_full["cascade"] - C15_SLACK or rc < r2:
        raise AssertionError("c15: the sharded pq2 or cascade falls short of the single index "
                             "or the cascade of pq2")
    allow = torch.rand(idx.ntotal, generator=torch.Generator(device=dev).manual_seed(15),
                       device=dev) < 0.10
    v, ids = idx.search(qn_gt, K, where=allow.cpu().numpy())
    check_filtered(torch.from_numpy(v), torch.from_numpy(ids), allow.cpu(), "c15 filtered 10%")
    log(f"[c15] filter 10%: no disallowed id; {int((ids < 0).sum())} unfilled slots (-inf, -1)")

    t0 = time.perf_counter()
    gt_all = exact_gt(chunk_fn, n_c, CHUNK, queries)
    log(f"[c15] exact f32 top-{K} of all {queries.shape[0]} queries: "
        f"{time.perf_counter() - t0:.1f} s")
    report = tune_logged(idx, queries, "c15", gt=gt_all, target=C15_TARGET)
    _, f = idx.search(qn, K)
    times = [fenced(lambda: idx.search(qn, K))[2] for _ in range(3)]
    ms = float(np.median(times)) * 1e3
    rec = recall_at_k(f, gt_all)
    log(f"[c15] {card}: op {report['op']}: recall@{K} {rec:.4f} over {queries.shape[0]} "
        f"queries, {queries.shape[0] / ms * 1e3:,.1f} QPS host clock ({ms:.1f} ms a batch of "
        f"{queries.shape[0]}, median of 3: {', '.join(f'{t * 1e3:.1f}' for t in times)})")
    split = device_profile(lambda: idx.search(qn, K), "c15 one batch at the op point",
                           groups=C15_GROUPS)
    k5_main = pq.pq_tiles_topk.launches
    log(f"[c15] K5 {split['K5']:.1%} of the batch's kernel time; K5 launches on the main path "
        f"{k5_main} ({SHARDS} a batch)")
    mp = k5_shard_hold(idx, queries, report["op"])
    pq.pq_tiles_topk.launches = k5_main
    del idx
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="cell15_") as tmp:
        tmp = Path(tmp)
        small = ShardedBandIVFPQIndex.build_streaming(
            (chunk_fn(i) for i in range(MH_CHUNKS)), mesh=make_mesh(SHARDS, devices=[dev]),
            refine="pq2+host", **quant, **C15_KW)
        skw = dict(p_tiles=small._n_tiles(), refine_factor=C15_RF, host_factor=C15_HF)
        ref = small.search(qn_gt, K, **skw)
        small.save(tmp / "c5")
        loaded = load_index(tmp / "c5", device=dev)
        got = loaded.search(qn_gt, K, **skw)
        if not (np.array_equal(got[1], ref[1]) and np.array_equal(got[0], ref[0])):
            raise AssertionError("c15: the loaded index differs")
        two = ShardedBandIVFPQIndex.load(tmp / "c5", mesh=make_mesh(2, devices=[dev]))
        check_resharded_tiers(small, two)
        skw2 = dict(skw, p_tiles=two._n_tiles())
        res2 = two.search(qn_gt, K, **skw2)
        n_diff, n_tie, n_bad = k5_collisions_explain(
            ref, res2, k5_candidates(small, qn_gt, skw), k5_candidates(two, qn_gt, skw2))
        gt_mh = exact_gt(chunk_fn, MH_CHUNKS, CHUNK, q_gt)
        r4, r2s = recall_at_k(ref[1], gt_mh), recall_at_k(res2[1], gt_mh)
        same = float((res2[1] == ref[1]).mean())
        log(f"[c15] {MH_CHUNKS * CHUNK} rows: saved, loaded: equal; resharded 4 -> 2 "
            f"({[sh.ntotal for sh in two._shards]} rows): every id's codes, list, tier-2 codes "
            f"and host row equal; ids {same:.5f} equal by position; at full coverage {n_diff} "
            f"of {qn_gt.shape[0]} queries differ: {n_diff - n_tie - n_bad} by K5's slot "
            f"collisions of one layout, {n_tie} by exact ties, {n_bad} unexplained; recall@{K} "
            f"{r2s:.4f} (4 shards {r4:.4f})")
        if n_bad or r2s < r4 - C15_SLACK:
            raise AssertionError(f"c15: the resharded index: {n_bad} queries differ beyond "
                                 f"K5's slot collisions and exact ties; recall {r2s:.4f}")
        del small, two
        np.save(tmp / "queries.npy", qn_gt)
        (tmp / "skw.json").write_text(json.dumps(skw))
        t0 = time.perf_counter()
        res = run_two_processes(tmp, dev, task="cascade")
        two_s = time.perf_counter() - t0
        for rank, r in enumerate(res):
            mine = list(range(rank * SHARDS // 2, (rank + 1) * SHARDS // 2))
            if r["held"].tolist() != mine or r["host_held"].tolist() != mine:
                raise AssertionError(f"c15 rank {rank}: shards {r['held']}, host stores "
                                     f"{r['host_held']}")
            if not (np.array_equal(r["i"], got[1]) and np.array_equal(r["v"], got[0])):
                raise AssertionError(f"c15 rank {rank}: not the one-process ids and scores")
        _, _, one_s = fenced(lambda: loaded.search(qn_gt, K, **skw))
        log(f"[c15] two processes on the card (gloo, 2 + 2 shards of the saved cascade, each "
            f"its own shards' host rows): ids and scores equal to one process; a search "
            f"{float(res[0]['ms']):.1f} / {float(res[1]['ms']):.1f} ms host clock (one "
            f"process {one_s * 1e3:.1f} ms); {two_s:.1f} s with the processes' start")
        del loaded
    torch.cuda.empty_cache()
    return dict(launches={"K5 sharded": k5_main}, mp=mp)


def cascade_worker(rank: int, world: int, tmp: Path, device: torch.device) -> dict:
    """Cell 15's worker: loads the two shards its slots hold of the saved
    cascade index (and only their host stores), searches the saved queries
    (a warm-up, then fenced)."""
    from cloudvectordb_tpu_torch.parallel import mesh as mesh_mod

    idx = load_index(tmp / "c5", mesh=mesh_mod.make_mesh(SHARDS, devices=[device]))
    q = np.load(tmp / "queries.npy")
    skw = json.loads((tmp / "skw.json").read_text())
    idx.search(q, K, **skw)
    (v, i), _, host_s = fenced(lambda: idx.search(q, K, **skw))
    return dict(v=v, i=i, ms=np.array(host_s * 1e3),
                held=np.array([si for si, sh in enumerate(idx._shards) if sh is not None]),
                host_held=np.array([si for si in range(SHARDS) if idx._t_host[si]]))


# -- cell 16: data-parallel training and encoding ------------------------------------
#: cell 5's MiniLM-L6-384 at full width (max_len 128), global batches of
#: TRIPLETS; the holds after C16_STEPS steps at f32, dropout 0: loss and
#: grad_norm within C16_RTOL relative, every parameter but the attention key
#: biases within C16_PARAM_TOL (a key bias's gradient is rounding noise:
#: the loss does not depend on it, and Adam turns noise into steps of up to
#: lr, so those are held within 2·lr a live update); the sharded encode
#: within C16_ENC_TOL of the one-slot encode (f32) on C16_PASSAGES
C16_STEPS, C16_RTOL, C16_PARAM_TOL, C16_ENC_TOL = 3, 1e-5, 1e-5, 1e-5
C16_PASSAGES, C16_LR = 65_536, 5e-4


def dp_config(dtype: str, dropout: float = 0.0) -> TrainConfig:
    """Cell 16's training config: cell 5's encoder ('auto': K4 forward and
    backward) at ``dtype``."""
    enc = dataclasses.replace(encoder_config("auto", dropout), dtype=dtype)
    return TrainConfig(encoder=enc, batch_size=TRIPLETS, lr=C16_LR, warmup_steps=1,
                       total_steps=10 ** 6, ckpt_every=10 ** 9, log_every=10 ** 9)


def dp_metrics(trainer, state, batches) -> tuple:
    """C16_STEPS steps: ([(loss, grad_norm, acc)], K4 forward and backward
    launches of the run), the state stepped in place."""
    reset_launches()
    out = []
    for b in batches:
        state, m = trainer.step_fn(state, trainer.place_batch(b))
        out.append((float(m["loss"]), float(m["grad_norm"]), float(m["acc"])))
    return out, (attn.mha_small_head.launches, attn.mha_small_head.bwd_launches)


def hold_dp(label: str, ref: list, got: list, ref_model, got_params, lr: float) -> str:
    """The DP hold: per step loss and grad_norm within C16_RTOL relative, acc
    equal; parameters as C16_PARAM_TOL says. Returns the log's summary."""
    rl = max(abs(g[i] / r[i] - 1.0) for r, g in zip(ref, got) for i in (0, 1))
    names = [n for n, _ in ref_model.named_parameters()]
    diff = {n: float((p.detach().to(q.device) - q.detach()).abs().max())
            for n, p, q in zip(names, ref_model.parameters(), got_params)}
    free = [n for n in names if n.endswith("key.bias")]
    dp = max(v for n, v in diff.items() if n not in free)
    dk = max(diff[n] for n in free)
    n_live = C16_STEPS - 1  # warmup 1: the first update's lr is 0
    summary = (f"loss and grad_norm max rel diff {rl:.3g}, params max |diff| {dp:.3g} "
               f"(key biases {dk:.3g}), bit-identical {rl == 0 and dp == 0 and dk == 0}")
    if (rl > C16_RTOL or any(r[2] != g[2] for r, g in zip(ref, got)) or dp > C16_PARAM_TOL
            or dk > 2 * lr * n_live):
        raise AssertionError(f"c16 {label}: not the reference step: {summary}")
    return summary


def dp_batches(dev) -> list:
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    return [topic_batch(g, get_preset(ENC_PRESET).vocab_size, dev) for _ in range(C16_STEPS)]


def dp_worker(rank: int, world: int, tmp: Path, dev: torch.device) -> dict:
    """Cell 16 across two processes: one 'data' slot each (one card, gloo:
    the embeddings' gather and the gradients' all-reduce through host
    memory), each training its half of every global batch: C16_STEPS f32
    steps from the parent's initial parameters (losses, grad norms, the
    parameters, K4's launches), then bf16 ms/step (dropout 0.1) and the
    gradient all-reduce's ms (host clock, fenced; medians of 5)."""
    from cloudvectordb_tpu_torch.parallel.mesh import make_mesh

    half = TRIPLETS // world
    d = np.load(tmp / "dp.npz")
    batches = [{k: torch.as_tensor(d[k][j, rank * half:(rank + 1) * half]).to(dev)
                for k in d.files} for j in range(C16_STEPS)]
    tr = Trainer(dp_config("float32"), mesh=make_mesh(axis_name="data", devices=[dev]))
    st = tr.init_state()
    st.model.load_state_dict(torch.load(tmp / "init.pt", map_location=dev))
    got, k4 = dp_metrics(tr, st, batches)
    params = [p.detach().cpu().numpy() for p in st.model.parameters()]
    del tr, st
    torch.cuda.empty_cache()
    tr = Trainer(dp_config("bfloat16", dropout=0.1),
                 mesh=make_mesh(axis_name="data", devices=[dev]))
    st = tr.init_state()
    ms = step_ms(tr, st, batches, reps=5)
    grads = [p.detach().clone() for p in st.model.parameters()]
    ar = float(np.median([fenced(lambda: tr._reduce_grads([grads]))[2] * 1e3
                          for _ in range(5)]))
    return dict(metrics=np.array(got), k4=np.array(k4), ms=np.array(ms), allreduce_ms=np.array(ar),
                **{f"p{j}": a for j, a in enumerate(params)})


def k4_dp_holds(dev) -> dict:
    """K4 at cell 16's own shapes against its plain version (``attn_compare``:
    forward and backward): a replica's 3 x TRIPLETS / 2 sequences at f32
    (the held steps) and at bf16 (the timed steps), and a slot's
    ENC_BATCH / 2 at f32 (the sharded encode's forward). The bf16 replica
    shape timed beside its plain version and SDPA, with its bound: records
    'K4 dp' and 'K4 bwd dp'."""
    heads, d, scale = 12, 32, 32 ** -0.5
    b_rep, b_enc = 3 * TRIPLETS // 2, ENC_BATCH // 2
    errs = []
    for b, dtype, seed in ((b_rep, torch.float32, 1601), (b_enc, torch.float32, 1602),
                           (b_rep, torch.bfloat16, 1603)):
        q, k, v, mask, do = k4_inputs(dev, b, dtype, seed)
        errs.append(attn_compare(f"K4 data-parallel B{b} L{ENC_LEN} H{heads} d{d} "
                                 f"{str(dtype).split('.')[1]}", q, k, v, mask, do, heads, d))
    fns = {"kernel": (attn.mha_small_head, do), "plain": (attn.mha_small_head_reference, do),
           "library": (lambda *a: sdpa(*a[:6]), do.view(b_rep, ENC_LEN, heads, d).transpose(1, 2))}

    def fwd(fn):
        with torch.no_grad():
            return fn(q, k, v, mask, heads, d, scale)

    def bwd(fn, grad_out):
        ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = fn(*ts, mask, heads, d, scale)
        return lambda: torch.autograd.grad(o, ts, grad_out, retain_graph=True)

    reps = {"kernel": (10, K4_INNER), "plain": (3,), "library": (10, K4_INNER)}
    fwd_ms = {n: time_ms(lambda fn=fn: fwd(fn), *reps[n]) for n, (fn, _) in fns.items()}
    bwd_ms = {n: time_ms(bwd(fn, g), *reps[n]) for n, (fn, g) in fns.items()}
    shape = f"data-parallel replica B{b_rep} L{ENC_LEN} H{heads} d{d} bfloat16"
    out = {}
    for key, ms, back in (("K4 dp", fwd_ms, False), ("K4 bwd dp", bwd_ms, True)):
        out[key] = dict(err=max(errs), ms=ms["kernel"], plain_ms=ms["plain"],
                        library_ms=ms["library"], shape=shape,
                        **k4_bound(q, mask, heads, d, back))
        log(f"[kernel] K4 {'backward' if back else 'forward'} B{b_rep} (a replica's step): "
            f"kernel {ms['kernel']:.3f} ms, plain version {ms['plain']:.3f} ms, SDPA "
            f"{ms['library']:.3f} ms, bound {out[key]['bound_ms']:.3f} ms "
            f"({out[key]['bound_by']})")
    return out


def run_train_dp(dev, card) -> dict:
    """Cell 16: ``Trainer(mesh=make_mesh(2, axis_name="data"))``, two
    replicas on this card, against the one-slot trainer on the same global
    batches of TRIPLETS (C16_STEPS f32 steps, dropout 0, ``hold_dp``); K4's
    forward and backward launches a replica and step; ms/step at bf16
    (dropout 0.1) of one slot and of two, and the gradient all-reduce's ms;
    then two processes on the card (``dp_worker``, TRIPLETS / 2 each)
    against the one process on the concatenated batch; then
    ``encode_corpus`` over the two slots against one slot on C16_PASSAGES
    passages (f32, 'packed': K4). First K4 at the cell's own shapes
    (``k4_dp_holds``). K4's launches reset before each part and read after
    it: the one-slot runs' count as 'K4', the replicas' as 'K4 dp'."""
    from cloudvectordb_tpu_torch.models.embed import encode_corpus
    from cloudvectordb_tpu_torch.parallel import make_mesh

    mp = k4_dp_holds(dev)
    batches = dp_batches(dev)
    mesh2 = make_mesh(2, axis_name="data", devices=[dev])
    one, dp = Trainer(dp_config("float32"), device=dev), Trainer(dp_config("float32"), mesh=mesh2)
    s1, s2 = one.init_state(), dp.init_state()
    init = {k: v.detach().clone() for k, v in s1.model.state_dict().items()}
    ref, k4_one = dp_metrics(one, s1, batches)
    got, k4_dp = dp_metrics(dp, s2, batches)
    summary = hold_dp("two slots", ref, got, s1.model, list(s2.model.parameters()), C16_LR)
    same = all(torch.equal(p, q) for r in s2.replicas
               for p, q in zip(r.parameters(), s2.model.parameters()))
    per_rep = tuple(n // (2 * C16_STEPS) for n in k4_dp)
    log(f"[c16] {card}: {ENC_PRESET} f32, {TRIPLETS} triplets x 3 x {ENC_LEN} a global batch, "
        f"{C16_STEPS} steps, two slots on the card against one: {summary}; replicas equal "
        f"{same}; loss {ref[0][0]:.5f} -> {ref[-1][0]:.5f}; K4 launches a replica a step "
        f"forward {per_rep[0]}, backward {per_rep[1]} (one slot: {k4_one[0] // C16_STEPS}, "
        f"{k4_one[1] // C16_STEPS})")
    layers = get_preset(ENC_PRESET).num_layers
    if not same or per_rep != (layers, layers):
        raise AssertionError(f"c16: replicas equal {same}, K4 launches a replica {per_rep}")
    final = [p.detach().cpu() for p in s1.model.parameters()]
    k4 = {"K4": k4_one[0], "K4 bwd": k4_one[1], "K4 dp": k4_dp[0], "K4 bwd dp": k4_dp[1]}
    del one, dp, s1, s2
    torch.cuda.empty_cache()

    ms, ar = {}, None
    for name, kw in (("one slot", dict(device=dev)), ("two slots", dict(mesh=mesh2))):
        tr = Trainer(dp_config("bfloat16", dropout=0.1), **kw)
        st = tr.init_state()
        ms[name] = step_ms(tr, st, [tr.place_batch(b) for b in batches], reps=5)
        if name == "two slots":
            grads = [[p.detach().clone() for p in m.parameters()] for m in (st.model, *st.replicas)]
            ar = float(np.median([fenced(lambda: tr._reduce_grads(grads))[2] * 1e3
                                  for _ in range(5)]))
        del tr, st
        torch.cuda.empty_cache()
    log(f"[c16] bf16, dropout 0.1: {ms['one slot']:.3f} ms/step one slot, "
        f"{ms['two slots']:.3f} two slots on the card ({TRIPLETS / ms['two slots'] * 1e3:,.1f} "
        f"triplets/s); the gradient all-reduce {ar:.3f} ms (the two replicas' sum on the card)")

    with tempfile.TemporaryDirectory(prefix="cell16_") as tmp:
        tmp = Path(tmp)
        torch.save(init, tmp / "init.pt")
        np.savez(tmp / "dp.npz", **{k: torch.stack([b[k] for b in batches]).cpu().numpy()
                                    for k in batches[0]})
        t0 = time.perf_counter()
        res = run_two_processes(tmp, dev, task="dp")
        two_s = time.perf_counter() - t0
    model = Encoder(dp_config("float32").encoder)
    with torch.no_grad():
        for p, q in zip(model.parameters(), final):
            p.copy_(q)
    for rank, r in enumerate(res):
        s = hold_dp(f"rank {rank}", ref, [tuple(x) for x in r["metrics"]], model,
                    [torch.from_numpy(r[f"p{j}"]) for j in range(len(final))], C16_LR)
        log(f"[c16] two processes, rank {rank} ({TRIPLETS // 2} triplets each, gloo) against "
            f"one process on the concatenated batch: {s}; K4 launches forward "
            f"{int(r['k4'][0])}, backward {int(r['k4'][1])}; bf16 {float(r['ms']):.3f} ms/step, "
            f"the gradient all-reduce {float(r['allreduce_ms']):.3f} ms (gloo, host memory)")
        k4["K4 dp"] += int(r["k4"][0])
        k4["K4 bwd dp"] += int(r["k4"][1])
    if any(not np.array_equal(res[0][f"p{j}"], res[1][f"p{j}"]) for j in range(len(final))):
        raise AssertionError("c16: the two processes' parameters differ")
    log(f"[c16] the two processes hold equal parameters; {two_s:.1f} s with their start")

    ids, mask = make_passages(dev, C16_PASSAGES, ENC_LEN)
    texts = [" ".join(map(str, row[:n])) for row, n in
             zip(ids.cpu().numpy(), mask.sum(dim=1).cpu().numpy())]
    packed = with_impl(model, "packed", dev)
    tok = IdTokenizer(ENC_LEN)
    reset_launches()
    t0 = time.perf_counter()
    e1 = encode_corpus(packed, tok, texts, batch_size=ENC_BATCH, device=dev)
    t1, n1 = time.perf_counter(), attn.mha_small_head.launches
    e2 = encode_corpus(packed, tok, texts, batch_size=ENC_BATCH, mesh=mesh2)
    t2, n2 = time.perf_counter(), attn.mha_small_head.launches - n1
    diff = float(np.abs(e1 - e2).max())
    log(f"[c16] encode_corpus of {C16_PASSAGES} passages (f32, 'packed'): two slots against one "
        f"max |diff| {diff:.3g} (equal outright {bool(diff == 0)}); {t1 - t0:.1f} / "
        f"{t2 - t1:.1f} s with tokenization; K4 launches {n1} / {n2}")
    if diff > C16_ENC_TOL or not np.isfinite(e2).all() or not n2:
        raise AssertionError(f"c16: the sharded encode differs from one slot by {diff:.3g} "
                             f"(K4 launches {n2})")
    k4["K4"] += n1
    k4["K4 dp"] += n2
    return dict(launches=k4, mp=mp)


def cell15(dev) -> dict:
    """Cell 15 alone, for a short card call: (b)'s single cascade index on
    cell 7's first 10M rows (its quantizers and recalls), then
    ``run_sharded_config5``."""
    chunk_fn = make_corpus(dev, CHUNK)
    queries = make_queries(chunk_fn, dev, B)
    q_gt = queries[:NQ_GT]
    n_c = PQ_ROWS // CHUNK
    gt7 = exact_gt(chunk_fn, n_c, CHUNK, q_gt)
    idx, _ = c5_build(dev, chunk_fn, n_c, nlist=NLIST, tile_n=1024)
    idx.attach_host_refine(lambda i: idx._rotate(chunk_fn(i)).cpu().numpy(), n_c,
                           chunks_rotated=True)
    single = single_cascade_recalls(idx, q_gt, gt7, 820, idx._tune_n_tiles() // 4)
    quant = dict(opq_matrix=idx.opq_matrix, centroids=idx.centroids, codebooks=idx.codebooks,
                 codebooks2=idx.codebooks2)
    del idx
    torch.cuda.empty_cache()
    return run_sharded_config5(dev, chunk_fn, queries, gt7, quant, single, card_line())


# -- the probe-scan families (cells 10 and 11) --------------------------------
#: cell 10, BASELINE config #2 (scripts/bench_config2.py:26,38-66): 1M x 384
#: rows of the corpus's process, 512 queries, IVF-Flat nlist 4096, k-means 10
C2_ROWS, C2_D, C2_NLIST, C2_NQ = 1_000_000, 384, 4096, 512
#: cell 11, the reference's on-chip IVF-PQ shape (scripts/bench_ivf.py:18,31-60):
#: 1M x 768 rows about 256 centres, 4096 queries, nlist 1024, m 64, nbits 8
C3_ROWS, C3_D, C3_NLIST, C3_M, C3_NQ = 1_000_000, 768, 1024, 64, 4096
NPROBES = (1, 4, 8, 16, 32, 64)
PROBE_BATCH = 256
#: recall may not fall by more than this from one nprobe to the next
RECALL_STEP_DROP = 0.005
#: exact scores this close to a cut (the 10th score, a radius) may fall
#: either side of it in f32
CUT_TIE = 1e-5
#: cell 11: the refine route at full probe (rf 64) against the method's own
#: exact oracle (``ivfpq_oracle``): recall@10 within this of it
IVFPQ_ORACLE_TOL = 0.01
IVFPQ_REMOVE = 8192
#: cell 11 tunes on the first C3_TUNE_Q queries, and its sweeps time one
#: pass of the 4096 queries an nprobe
C3_TUNE_Q, C3_TIME_ITERS = 512, 1


def check_sweep(rows: list, label: str) -> None:
    """Log an nprobe sweep; fail if recall falls by more than
    RECALL_STEP_DROP from one nprobe to the next."""
    for r in rows:
        log(f"[{label}] nprobe {r['nprobe']:3d}: recall@{K} {r['recall']:.4f}, "
            f"{r['qps']:,.1f} QPS, {r['latency_ms']:.3f} ms a batch of {PROBE_BATCH}")
    for a, b in zip(rows, rows[1:]):
        if b["recall"] < a["recall"] - RECALL_STEP_DROP:
            raise AssertionError(f"{label}: recall falls from {a['recall']:.4f} at nprobe "
                                 f"{a['nprobe']} to {b['recall']:.4f} at {b['nprobe']}")


def exact_scores(x: torch.Tensor, q: torch.Tensor, keep=None) -> torch.Tensor:
    """(Q, N) f32 inner products, TF32 off; rows outside ``keep`` -inf."""
    s = q @ x.T
    return s if keep is None else s.masked_fill(~keep[None, :], float("-inf"))


def exact_topk(x, q, keep=None):
    """Exact f32 top-K (scores, ids) of q over x (stable ties), in blocks of
    512 queries."""
    out = [topk_stable_select(exact_scores(x, q[s:s + 512], keep), K)
           for s in range(0, q.shape[0], 512)]
    return torch.cat([v for v, _ in out]), torch.cat([i for _, i in out])


def check_full_probe(ids: np.ndarray, s_exact: torch.Tensor, gt_v: torch.Tensor,
                     label: str) -> None:
    """Ids at nprobe = nlist must be the exact top-K's, except ids whose
    exact score lies within CUT_TIE of the exact K-th: a missing exact id
    there, or a returned id scoring there."""
    ids_t = torch.as_tensor(ids, device=s_exact.device)
    kth = gt_v[:, -1:]
    got = torch.gather(s_exact, 1, ids_t.clamp_min(0))
    in_top = s_exact >= kth  # the exact top-K and its ties at the K-th
    bad_got = (ids_t < 0) | (got < kth - CUT_TIE)
    found = torch.zeros_like(in_top)
    found.scatter_(1, ids_t.clamp_min(0), ids_t >= 0)
    bad_miss = in_top & ~found & (s_exact > kth + CUT_TIE)
    n_bad = int(bad_got.sum()) + int(bad_miss.sum())
    log(f"[{label}] full probe: {ids.shape[0]} queries, ids equal to the exact top-{K} but "
        f"for near-ties: {n_bad == 0} ({n_bad} differences beyond {CUT_TIE})")
    if n_bad:
        raise AssertionError(f"{label}: the full probe is not the exact top-{K}")


def check_range(lims, ids, s_exact: torch.Tensor, radius: float, label: str) -> None:
    """range_search's hit sets against the exact oracle (score >= radius),
    ids whose exact score lies within CUT_TIE of the radius aside."""
    hits = s_exact >= radius
    found = torch.zeros_like(hits)
    qi = torch.as_tensor(np.repeat(np.arange(len(lims) - 1), np.diff(lims)), device=hits.device)
    found[qi, torch.as_tensor(ids, device=hits.device)] = True
    differ = (hits != found) & ((s_exact - radius).abs() > CUT_TIE)
    log(f"[{label}] range search at radius {radius:.6f}: {int(found.sum())} hits over "
        f"{hits.shape[0]} queries ({int(hits.sum(1).min())}-{int(hits.sum(1).max())} a query "
        f"exactly), {int(differ.sum())} differences from the exact oracle beyond {CUT_TIE}")
    if int(differ.sum()):
        raise AssertionError(f"{label}: range search hit sets differ from the exact oracle")


def run_ivf_flat(dev, card) -> dict:
    """Cell 10: IVF-Flat at BASELINE config #2's shape. The nprobe sweep
    against the exact f32 top-K (recall must not fall along nprobe), its
    operating point at 0.95, ``tune(gt=)``, one batch at nprobe = nlist
    (the exact top-K but for near-ties), and ``range_search`` at full probe
    against the exact oracle, at the median exact K-th score."""
    fn = make_corpus(dev, C2_ROWS, d=C2_D)
    x = fn(0)
    q = make_queries(fn, dev, C2_NQ)
    gt_v, gt_i = exact_topk(x, q)
    gt = gt_i.cpu().numpy()
    t0 = time.perf_counter()
    idx = IVFFlatIndex.build(x, C2_NLIST, metric="ip", kmeans_iters=10, device=dev)
    sync()
    lens = idx._arena.list_lens
    log(f"[ivf_flat] built {idx.ntotal} x {C2_D}, nlist {C2_NLIST} in "
        f"{time.perf_counter() - t0:.1f} s; list lengths {lens.min()}-{lens.max()} "
        f"(mean {lens.mean():.1f})")
    qn = q.cpu().numpy()
    sweep = nprobe_sweep(idx, None, qn, k=K, nprobes=NPROBES, batch=PROBE_BATCH, gt_ids=gt)
    check_sweep(sweep, "ivf_flat")
    op = operating_point(sweep, 0.95)
    report = tune_logged(idx, q, "ivf_flat", gt=gt)
    device_profile(lambda: idx.search(qn[:PROBE_BATCH], K, nprobe=report["op"]["nprobe"]),
                   f"ivf_flat one batch of {PROBE_BATCH} at nprobe {report['op']['nprobe']}",
                   groups=PROBE_GROUPS)
    qb = qn[:PROBE_BATCH]
    t0 = time.perf_counter()
    _, ids = idx.search(qb, K, nprobe=C2_NLIST)
    full_s = time.perf_counter() - t0
    s_exact = exact_scores(x, q[:PROBE_BATCH])
    check_full_probe(ids, s_exact, gt_v[:PROBE_BATCH], "ivf_flat")
    radius = float(gt_v[:PROBE_BATCH, -1].median())
    t0 = time.perf_counter()
    lims, _, rids = idx.range_search(qb, radius, k_start=512, k_max=C2_ROWS,
                                     nprobe=C2_NLIST)
    range_s = time.perf_counter() - t0
    check_range(lims, rids, s_exact, radius, "ivf_flat")
    log(f"[ivf_flat] {card}: operating point at 0.95 {op and op['nprobe']} "
        f"({op and round(op['qps'], 1)} QPS); tuned {report['op']} (recall "
        f"{report['recall']:.4f}); a full-probe batch {full_s:.2f} s, the range search "
        f"{range_s:.2f} s host clock")
    return dict(launches={}, mp={})


def ivfpq_oracle(idx, x: torch.Tensor, q: torch.Tensor, gt: np.ndarray, rf: int):
    """Recall@K of IVF-PQ's own semantics at full probe, computed plainly:
    every row's ADC score as q . (its list centroid + its decoded code), one
    f32 product (TF32 off), the top K*rf rows kept, rescored from the int8
    refine store (the method's oracle), and from the rows themselves (the
    candidates' ceiling). Returns (oracle recall, ceiling recall)."""
    st = idx._device_state()
    lists = torch.repeat_interleave(torch.arange(idx.nlist, device=x.device), st["lens"])
    xhat = st["centroids"][lists] + pq_decode(st["codes"], st["codebooks"])
    _, pos = topk_stable_select(q @ xhat.T, K * rf)
    del xhat
    gid = st["ids"][pos]
    r8 = st["refine"][gid].float() * idx._refine_scale + st["centroids"][lists[pos]]
    out = []
    for rows in (r8, x[gid]):
        _, top = topk_stable(torch.bmm(rows, q[:, :, None])[:, :, 0], K)
        out.append(recall_at_k(torch.gather(gid, 1, top).cpu().numpy(), gt))
    return tuple(out)


def ivfpq_recall(idx, q: np.ndarray, gt: np.ndarray, label: str, **kw) -> float:
    _, ids = idx.search(q, K, **kw)
    r = recall_at_k(ids, gt)
    log(f"[ivf_pq] {label}: recall@{K} {r:.4f}")
    return r


#: cell 14 (e): the sharded IVF-PQ's recall@10 against the single index's
#: at each of SHARD_NPROBES: within this on the ADC route; on the int8
#: refine route (rf 64) no lower by more than this
SHARD_IVFPQ_TOL, SHARD_NPROBES = 0.01, (1, 16, 64)


def run_sharded_ivfpq(x, qn, gt, single, quant: dict, kw: dict, oracle: float, card) -> None:
    """Cell 14 (e): ``ShardedIVFPQIndex`` on cell 11's corpus and settings
    over SHARDS shards on this card, on the single index's quantizers. The
    ADC route (refine 'none') ranks every probed row by the same scores as
    the single index: recall@K within SHARD_IVFPQ_TOL of it at nprobe 1, 16
    and 64. The refine route keeps rf·K candidates a shard (the
    reference's rule), a superset of the single index's rf·K: recall no
    lower than the single index's by more than SHARD_IVFPQ_TOL at each
    nprobe, and at full probe than the method's exact oracle (the single
    index's rf·K rescored). The probe scans are plain torch ops."""
    from cloudvectordb_tpu_torch.parallel import ShardedIVFPQIndex, make_mesh

    xn = x.cpu().numpy()
    common = dict(mesh=make_mesh(SHARDS, devices=[x.device]), **quant,
                  **{k: v for k, v in kw.items() if k != "device"})
    t0 = time.perf_counter()
    sh = ShardedIVFPQIndex.build(xn, C3_NLIST, refine="int8", **common)
    adc = ShardedIVFPQIndex.build(xn, C3_NLIST, refine="none", **common)
    single_adc = IVFPQIndex.build(x, C3_NLIST, refine="none", **kw, **quant)
    log(f"[sharded ivf_pq] built {sh.ntotal} x {C3_D} on {SHARDS} shards twice (refine int8 "
        f"and none) and the single ADC index in {time.perf_counter() - t0:.1f} s; refine "
        f"scale {sh._refine_scale:.6g} (single {single._refine_scale:.6g})")
    for nprobe in SHARD_NPROBES:
        r1 = recall_at_k(single.search(qn, K, nprobe=nprobe, refine_factor=64)[1], gt)
        (_, ids), _, host_s = fenced(lambda: sh.search(qn, K, nprobe=nprobe, refine_factor=64))
        r = recall_at_k(ids, gt)
        a1 = recall_at_k(single_adc.search(qn, K, nprobe=nprobe)[1], gt)
        a = recall_at_k(adc.search(qn, K, nprobe=nprobe)[1], gt)
        log(f"[sharded ivf_pq] {card}: nprobe {nprobe}: ADC recall@{K} {a:.4f} (single "
            f"{a1:.4f}); rf 64 {r:.4f} (single {r1:.4f}), {qn.shape[0] / host_s:,.1f} QPS "
            "host clock")
        if abs(a - a1) > SHARD_IVFPQ_TOL or r < r1 - SHARD_IVFPQ_TOL:
            raise AssertionError(f"sharded IVF-PQ at nprobe {nprobe}: ADC {a:.4f} against "
                                 f"{a1:.4f}, rf 64 {r:.4f} against {r1:.4f}")
    _, ids = sh.search(qn[:PROBE_BATCH], K, nprobe=C3_NLIST, refine_factor=64)
    full = recall_at_k(ids, gt[:PROBE_BATCH])
    log(f"[sharded ivf_pq] full probe, rf 64: recall@{K} {full:.4f} (the single index's "
        f"method's exact oracle {oracle:.4f}: rf·K candidates in all, here rf·K a shard)")
    if full < oracle - IVFPQ_ORACLE_TOL:
        raise AssertionError(f"sharded IVF-PQ at full probe {full:.4f}, oracle {oracle:.4f}")


def run_ivf_pq(dev, card) -> dict:
    """Cell 11: IVF-PQ at the reference's on-chip shape, residual, two
    builds on one quantizer: refine 'int8' (the nprobe x refine_factor
    sweep, ``tune(gt=)``, full probe at rf 64 against its exact oracle) and
    'none' (the ADC route's sweep: recall must not fall along nprobe); then
    on the refine build ``remove`` of IVFPQ_REMOVE random ids (none comes
    back; recall against the new exact top-K within 0.01 of before),
    ``merge_from`` of two halves (every id once; recall within 0.005 of the
    whole build's) and ``reconstruct`` (cosine >= 0.99)."""
    x, q = direct_corpus(dev, C3_ROWS, C3_D, C3_NQ)
    gt_v, gt_i = exact_topk(x, q)
    gt = gt_i.cpu().numpy()
    qn = q.cpu().numpy()
    kw = dict(m=C3_M, nbits=8, metric="ip", residual=True, kmeans_iters=10, pq_train_iters=6,
              device=dev)
    t0 = time.perf_counter()
    idx = IVFPQIndex.build(x, C3_NLIST, refine="int8", **kw)
    sync()
    lens = idx._arena.list_lens
    log(f"[ivf_pq] built {idx.ntotal} x {C3_D}, nlist {C3_NLIST}, m {C3_M}, refine int8 in "
        f"{time.perf_counter() - t0:.1f} s (k-means, PQ training, encode); list lengths "
        f"{lens.min()}-{lens.max()} (mean {lens.mean():.1f})")
    quant = dict(centroids=idx.centroids, codebooks=idx.codebooks)
    sweep = dict(k=K, nprobes=NPROBES, batch=PROBE_BATCH, time_iters=C3_TIME_ITERS, gt_ids=gt)
    for rf in (16, 64):
        check_sweep(nprobe_sweep(idx, None, qn, refine_factor=rf, **sweep),
                    f"ivf_pq refine rf {rf}")
    report = tune_logged(idx, q[:C3_TUNE_Q], "ivf_pq", gt=gt[:C3_TUNE_Q])
    op = report["op"]
    device_profile(lambda: idx.search(qn[:PROBE_BATCH], K, **op),
                   f"ivf_pq one batch of {PROBE_BATCH} at {op}", groups=PROBE_GROUPS)
    full = ivfpq_recall(idx, qn[:PROBE_BATCH], gt[:PROBE_BATCH],
                        f"full probe, rf 64, {PROBE_BATCH} queries", nprobe=C3_NLIST,
                        refine_factor=64)
    oracle, ceiling = ivfpq_oracle(idx, x, q[:PROBE_BATCH], gt[:PROBE_BATCH], 64)
    log(f"[ivf_pq] the method's exact oracle at full probe, rf 64: recall@{K} {oracle:.4f} "
        f"(the int8 store), {ceiling:.4f} (exact rows: the candidates' ceiling)")
    if abs(full - oracle) > IVFPQ_ORACLE_TOL:
        raise AssertionError(f"IVF-PQ refine at full probe: recall {full:.4f}, its exact "
                             f"oracle {oracle:.4f}")
    run_sharded_ivfpq(x, qn, gt, idx, quant, kw, oracle, card)
    t0 = time.perf_counter()
    adc = IVFPQIndex.build(x, C3_NLIST, refine="none", **kw, **quant)
    sync()
    log(f"[ivf_pq] ADC-only build on the same quantizers: {time.perf_counter() - t0:.1f} s")
    check_sweep(nprobe_sweep(adc, None, qn, **sweep), "ivf_pq ADC only")
    del adc

    before = ivfpq_recall(idx, qn, gt, f"at the tuned {op}")
    victims = np.random.default_rng(11).choice(C3_ROWS, IVFPQ_REMOVE, replace=False)
    n, _, rem_s = fenced(lambda: idx.remove(victims))
    if n != IVFPQ_REMOVE or idx.ntotal != C3_ROWS - IVFPQ_REMOVE:
        raise AssertionError(f"IVF-PQ remove: {n} removed, ntotal {idx.ntotal}")
    keep = torch.ones(C3_ROWS, dtype=torch.bool, device=dev)
    keep[torch.as_tensor(victims, device=dev)] = False
    _, ids = idx.search(qn, K)
    if np.isin(ids, victims).any():
        raise AssertionError("IVF-PQ: a removed id came back")
    after = recall_at_k(ids, exact_topk(x, q, keep)[1].cpu().numpy())
    log(f"[ivf_pq] {card}: remove of {IVFPQ_REMOVE} ids {rem_s:.3f} s; no removed id "
        f"returned; recall@{K} against the new exact top-{K} {after:.4f} (before {before:.4f})")
    if after < before - 0.01:
        raise AssertionError(f"IVF-PQ recall after remove {after:.4f} < {before:.4f} - 0.01")
    del idx
    torch.cuda.empty_cache()

    half = C3_ROWS // 2
    t0 = time.perf_counter()
    merged = IVFPQIndex.build(x[:half], C3_NLIST, refine="int8", **kw, **quant)
    other = IVFPQIndex.build(x[half:], C3_NLIST, refine="int8", **kw, **quant)
    n = merged.merge_from(other, id_offset=half)
    sync()
    ids_all = np.sort(merged._arena.ids)
    if n != half or not np.array_equal(ids_all, np.arange(C3_ROWS)):
        raise AssertionError("IVF-PQ merge_from: ids are not each row once")
    merged._op_point = op
    r_merged = ivfpq_recall(merged, qn, gt, f"merge_from of two halves at {op}")
    log(f"[ivf_pq] merge_from: two builds of {half} and the merge {time.perf_counter() - t0:.1f} s")
    if abs(r_merged - before) > 0.005:
        raise AssertionError(f"IVF-PQ merge_from recall {r_merged:.4f} vs {before:.4f}")
    sel = np.random.default_rng(12).choice(C3_ROWS, PROBE_BATCH, replace=False)
    rec = torch.as_tensor(merged.reconstruct(sel), device=dev)
    cos = F.cosine_similarity(rec, x[torch.as_tensor(sel, device=dev)], dim=1)
    log(f"[ivf_pq] reconstruct of {PROBE_BATCH} ids through the refine store: cosine "
        f"{float(cos.min()):.5f}-{float(cos.max()):.5f}")
    if float(cos.min()) < 0.99:
        raise AssertionError(f"IVF-PQ reconstruct cosine {float(cos.min()):.5f} < 0.99")
    return dict(launches={}, mp={})


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


#: device_profile's kernel groups (by substrings of the kernel's name): the
#: encoder's, and the probe scans'
ENCODER_GROUPS = {"K4": ("mha_",), "GEMM": ("gemm", "nvjet", "xmma", "cutlass", "sm90_"),
                  "optimizer": ("multi_tensor",)}
PROBE_GROUPS = {"gather": ("index", "gather"),
                "GEMM": ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_", "dot_kernel"),
                "sort": ("sort", "radix", "scan"), "reduce": ("reduce",)}


def device_profile(fn, label: str, top: int = 8, groups: dict = ENCODER_GROUPS) -> dict:
    """torch.profiler over one call of fn: the card's time by kernel, summed
    into ``groups`` and the rest (for the encoder: K4, GEMMs, the
    optimizer's multi-tensor kernels, and elementwise and reductions:
    LayerNorm, gelu, casts, dropout, losses), and the call's host clock;
    its card-busy share is the kernel time over that clock."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    time_of = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    total = sum(time_of(e) for e in kernels) or 1.0
    share = {name: 0.0 for name in (*groups, "other")}
    for e in kernels:
        name = next((g for g, keys in groups.items()
                     if any(k in e.key.lower() for k in keys)), "other")
        share[name] += time_of(e)
    log(f"[profile] {label}: {total / 1e3:.3f} ms of kernel time in {wall * 1e3:.3f} ms "
        f"host clock (profiled; card busy {total / 1e6 / wall:.1%}); "
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
    k2_launches = flat.flat_topk.launches
    if recall < QUERY_RECALL_FLOOR or k2_launches <= 0:
        raise AssertionError(f"query recall {recall:.4f} < {QUERY_RECALL_FLOOR}")
    del ids, mask, q_ids, q_mask, packed, streamed
    k2 = main_shape_check(
        "K2", f"f32 ip {N_PASSAGES}x{model.embed_dim} Q{N_QUERIES}",
        lambda: flat.flat_topk(index._vecs, queries, K),
        lambda: flat.flat_topk_reference(index._vecs, queries, K), reps=3, plain_reps=2)
    k2.update(bound(nbytes(index._vecs, queries) + N_QUERIES * K * 8,
                    2.0 * N_QUERIES * N_PASSAGES * model.embed_dim, "f32"))
    log(f"[kernel] K2 f32 ip: {2.0 * N_QUERIES * N_PASSAGES * model.embed_dim / k2['ms'] / 1e9:.1f}"
        f" T f32 flop/s; bound {k2['bound_ms']:.3f} ms ({k2['bound_by']})")
    return dict(launches=launches, rates=rates, recall=recall, k2_launches=k2_launches, k2=k2)


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


def sdpa_rows(q, k, v, mask, heads: int, d: int, scale: float):
    """sdpa() back in K4's (B, L, H·d) layout (``scale`` is d ** -0.5)."""
    return sdpa(q, k, v, mask, heads, d).transpose(1, 2).reshape(q.shape)


#: K4 and SDPA run under a millisecond at the main shapes: each timed
#: repetition runs this many calls back to back (time_ms)
K4_INNER = 20


def k4_main_shapes(dev) -> dict:
    """K4 at the main path's shapes, bf16: forward and backward at B 1536
    (a training step's 3 x 512 sequences), forward at B 1024 (an encode
    batch); each against its plain version (with SDPA's own distance to it
    at B 1536, and the backward's bits across two runs), then timed beside
    SDPA."""
    heads, d, scale = 12, 32, 32 ** -0.5
    out = {}
    for b, seed in ((1536, 900), (1024, 901)):
        q, k, v, mask, do = k4_inputs(dev, b, torch.bfloat16, seed)
        name = f"K4 main path B{b} L{ENC_LEN} H{heads} d{d} bfloat16"
        err = attn_compare(name, q, k, v, mask, do, heads, d)
        if b == 1536:
            bwd_bit_identical(name, q, k, v, mask, do, heads, d)
            ref = attn_run(attn.mha_small_head_reference, q, k, v, mask, do, heads, d)
            lib = attn_run(sdpa_rows, q, k, v, mask, do, heads, d)
            log("[kernel] SDPA at the same inputs: max |SDPA - plain| " + ", ".join(
                f"{label} {float((a.float() - r.float()).abs().max()):.3g}"
                for label, a, r in zip(("o", "dq", "dk", "dv"), lib, ref))
                + "; K4's backward bit-identical across two runs")
            del ref, lib
        with torch.no_grad():
            fwd = time_ms(lambda: attn.mha_small_head(q, k, v, mask, heads, d, scale), 10,
                          K4_INNER)
            fwd_plain = time_ms(
                lambda: attn.mha_small_head_reference(q, k, v, mask, heads, d, scale), 3)
            fwd_lib = time_ms(lambda: sdpa(q, k, v, mask, heads, d), 10, K4_INNER)
        rec = {"err": err, "fwd": {"ms": fwd, "plain_ms": fwd_plain, "library_ms": fwd_lib,
                                   **k4_bound(q, mask, heads, d, False)}}
        log(f"[kernel] K4 forward B{b}: kernel {fwd:.3f} ms, plain version {fwd_plain:.3f} ms, "
            f"SDPA {fwd_lib:.3f} ms, bound {rec['fwd']['bound_ms']:.3f} ms "
            f"({rec['fwd']['bound_by']})")
        if b == 1536:
            times, alone = {}, {}
            for name, fn in (("kernel", attn.mha_small_head),
                             ("plain", attn.mha_small_head_reference),
                             ("library", lambda *a: sdpa(*a[:6]))):
                ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = fn(*ts, mask, heads, d, scale)
                do_ = do if name != "library" else do.view(o.shape[0], ENC_LEN, heads, d
                                                           ).transpose(1, 2)
                def grad(o=o, ts=ts, do_=do_):
                    return torch.autograd.grad(o, ts, do_, retain_graph=True)
                times[name] = time_ms(grad, *((10, K4_INNER) if name != "plain" else (3,)))
                if name != "plain":
                    def fwd_of(fn=fn):
                        with torch.no_grad():
                            return fn(q, k, v, mask, heads, d, scale)
                    alone[name] = (time_ms(fwd_of, 10), time_ms(grad, 10))
            both = {}
            for name, fn, grad_out in (("kernel", attn.mha_small_head, do),
                                       ("library", lambda *a: sdpa(*a[:6]),
                                        do.view(q.shape[0], ENC_LEN, heads, d).transpose(1, 2))):
                def step(fn=fn, grad_out=grad_out):
                    ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
                    return torch.autograd.grad(fn(*ts, mask, heads, d, scale), ts, grad_out)
                both[name] = time_ms(step, 10, K4_INNER)
            log(f"[kernel] K4 forward+backward B{b}: kernel {both['kernel']:.3f} ms, "
                f"SDPA {both['library']:.3f} ms")
            log(f"[kernel] K4 B{b} forward / backward as one call alone, its host launch "
                f"included: kernel {alone['kernel'][0]:.3f} / {alone['kernel'][1]:.3f} ms, SDPA "
                f"{alone['library'][0]:.3f} / {alone['library'][1]:.3f} ms")
            rec["bwd"] = {"ms": times["kernel"], "plain_ms": times["plain"],
                          "library_ms": times["library"],
                          **k4_bound(q, mask, heads, d, True)}
            log(f"[kernel] K4 backward B{b}: kernel {times['kernel']:.3f} ms, plain version "
                f"{times['plain']:.3f} ms, SDPA backward {times['library']:.3f} ms, bound "
                f"{rec['bwd']['bound_ms']:.3f} ms ({rec['bwd']['bound_by']})")
        out[b] = rec
    return out


# -- cell 12: the pipeline from raw text, through the CLI ------------------------
#: cut from 1M passages, 100,000 triplets and 200 steps (PR 12) so that the
#: run keeps inside its time limit with cells 13-16 (PERF.md §4)
PIPE_DOCS, PIPE_TRIPLETS, PIPE_STEPS = 62_500, 50_000, 60
PIPE_STAGES = ("mine", "train", "encode", "build", "tune", "eval")
PIPE_ARTIFACTS = ("passages.jsonl", "tokenizer.json", "triplets.jsonl", "ckpt",
                  "embeddings.npy", "index", "eval.json")
PIPE_RECALL_FLOOR, PIPE_NORM_TOL = 0.90, 1e-3
#: the index's recall at full coverage against its plain version's, and the
#: tuned op point's against full coverage
PIPE_METHOD_TOL = 0.01
HARD_ANCHORS, HARD_TOPK = 16_384, 100
SPLIT_BATCHES, SPLIT_REPS = (1, 64, 4096), 5
SEARCH_QUERY = "the telescope and the galaxy relate to orbit through the nebula."


def pipeline_config(workdir: Path) -> PipelineConfig:
    """Cell 12: BASELINE config #2's encoder (MiniLM-L6, 384-d) at full
    width over PIPE_DOCS synthetic passages (Wikipedia's text cannot be had
    offline; its depth cut to keep the run inside its time limit), the
    residual-int8 band_ivf index. Fields set directly
    with no preset (a preset would replace them); attn_dropout 0 so that
    training takes K4, attn_impl 'packed' so that encoding does too ('auto'
    takes the naive path in a deterministic forward at L 128)."""
    enc = dataclasses.replace(get_preset(ENC_PRESET), max_len=ENC_LEN, dtype="bfloat16",
                              dropout=0.1, attn_dropout=0.0, attn_impl="packed")
    return PipelineConfig(
        workdir=str(workdir),
        data=DataConfig(corpus="synthetic", num_docs=PIPE_DOCS),
        mining=MiningConfig(strategy="inbatch", num_triplets=PIPE_TRIPLETS),
        train=TrainConfig(encoder=enc, encoder_preset="", batch_size=TRIPLETS, lr=1e-4,
                          warmup_steps=20, total_steps=PIPE_STEPS,
                          ckpt_every=PIPE_STEPS // 2),
        index=IndexConfig(kind="band_ivf", metric="ip", nlist=NLIST, residual=True,
                          dtype="int8", train_sample=262_144),
        encode_batch=ENC_BATCH, eval_k=K, eval_queries=1024, stages=PIPE_STAGES)


def kernel_counts() -> dict:
    return {"K4": attn.mha_small_head.launches, "K4 bwd": attn.mha_small_head.bwd_launches,
            "K1": band.tiles_topk_resid.launches, "K2": flat.flat_topk.launches}


class StageProbe:
    """Instrumentation of one pipeline run, outside the package: each
    ``Pipeline.stage_*`` wrapped to record its kernel launches, and the
    host seconds of tokenization (``TextTokenizer.encode_batch``), tokenizer
    training and corpus synthesis spent inside it."""

    TIMED = ((TextTokenizer, "encode_batch", "tokenize"), (TextTokenizer, "train", "tok_train"),
             (pipeline_run, "load_passages", "corpus"))

    def __init__(self):
        self.host = {"tokenize": 0.0, "tok_train": 0.0, "corpus": 0.0}
        self.stages: dict[str, dict] = {}
        self._saved = []

    def _timed(self, fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.host[key] += time.perf_counter() - t0
        return wrapped

    def _stage(self, fn, name):
        def wrapped(pipe, *a, **kw):
            before, host = kernel_counts(), dict(self.host)
            out = fn(pipe, *a, **kw)
            rec = self.stages.setdefault(name, {})
            for k, v in kernel_counts().items():
                rec[k] = rec.get(k, 0) + v - before[k]
            for k, v in self.host.items():
                rec[k] = rec.get(k, 0.0) + v - host[k]
            return out
        return wrapped

    def __enter__(self):
        targets = [(owner, attr, self._timed(getattr(owner, attr), key))
                   for owner, attr, key in self.TIMED]
        targets += [(Pipeline, f"stage_{s}", self._stage(getattr(Pipeline, f"stage_{s}"), s))
                    for s in PIPE_STAGES]
        for owner, attr, fn in targets:
            self._saved.append((owner, attr, owner.__dict__[attr]))
            setattr(owner, attr, fn)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)


def cli_run(argv: list[str]) -> tuple[list[str], float]:
    """cli.main(argv) in this process: the lines it printed, host seconds."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return out.getvalue().strip().splitlines(), secs


def events(workdir: Path, name: str) -> list[dict]:
    lines = (workdir / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["event"] == name]


def check_embeddings(path: Path, n: int, d: int) -> float:
    """(n, d), finite, unit-norm within PIPE_NORM_TOL; the largest |norm - 1|."""
    emb = np.load(path, mmap_mode="r")
    if emb.shape != (n, d):
        raise AssertionError(f"embeddings {emb.shape}, expected {(n, d)}")
    worst = 0.0
    for s in range(0, n, 131_072):
        block = np.asarray(emb[s:s + 131_072], np.float64)
        if not np.isfinite(block).all():
            raise AssertionError("non-finite embeddings")
        worst = max(worst, float(np.abs(np.linalg.norm(block, axis=1) - 1.0).max()))
    if worst > PIPE_NORM_TOL:
        raise AssertionError(f"embedding norms off 1 by {worst:.3g} > {PIPE_NORM_TOL}")
    return worst


def stage_table(workdir: Path, probe: StageProbe, card) -> None:
    """Log each stage's seconds (StageTimer), its host work and launches."""
    secs = {e["stage"]: e["wall_s"] for e in events(workdir, "stage_done")}
    total = sum(secs.values())
    parts = []
    for s in PIPE_STAGES:
        rec = probe.stages.get(s, {})
        host = ", ".join(f"{k} {rec[k]:.1f} s" for k in ("corpus", "tok_train", "tokenize")
                         if rec.get(k, 0.0) >= 0.05)
        launches = ", ".join(f"{k} {rec[k]}" for k in ("K4", "K4 bwd", "K1", "K2") if rec.get(k))
        if s == "encode":
            host += f", device and copies {secs[s] - rec.get('tokenize', 0.0):.1f} s"
        parts.append(f"{s} {secs[s]:.2f} s" + (f" ({host})" if host else "")
                     + (f" [{launches}]" if launches else ""))
    log(f"[pipeline] {card}: stages: " + "; ".join(parts)
        + f"; raw text to a tuned index {total - secs['eval']:.2f} s, with eval {total:.2f} s")


def hard_mining(dev, src: Path, tmp: Path, card) -> dict:
    """Hard mining over the trained encoder: a second workdir with copies of
    the first's passages, tokenizer.json (copied: WordPiece training is not
    deterministic from run to run) and checkpoints; the whole corpus
    re-encoded (K4) into FlatIndex, each anchor's negative from its top
    HARD_TOPK (K2). Every negative must be a filled candidate of its
    anchor's search from another document."""
    work = tmp / "hard"
    work.mkdir()
    for name in ("passages.jsonl", "tokenizer.json"):
        shutil.copy(src / name, work / name)
    shutil.copytree(src / "ckpt", work / "ckpt")
    cfg = pipeline_config(work)
    cfg.mining = MiningConfig(strategy="hard", num_triplets=HARD_ANCHORS, hard_topk=HARD_TOPK)
    cfg.stages = ("mine",)
    cfg.save(tmp / "hard.json")
    found = []
    search = FlatIndex.search

    def recording(index, q, k, **kw):
        out = search(index, q, k, **kw)
        found.append(out)
        return out

    FlatIndex.search = recording
    reset_launches()
    try:
        _, secs = cli_run(["pipeline", "--config", str(tmp / "hard.json"), "--device", str(dev)])
    finally:
        FlatIndex.search = search
    launches = kernel_counts()
    passages = [json.loads(line)["text"] for line in (work / "passages.jsonl").open()]
    row = {p: i for i, p in enumerate(passages)}
    trip = Triplets.load(work / "triplets.jsonl")
    picks = np.random.default_rng(cfg.mining.seed).integers(0, len(passages), size=HARD_ANCHORS)
    scores = np.concatenate([s for s, _ in found])
    ids = np.concatenate([i for _, i in found])
    unfilled = int((ids < 0).sum())
    topic = lambda i: passages[i].split(" about ", 1)[1].split(":", 1)[0]  # noqa: E731
    same_topic = 0
    for t, neg in enumerate(trip.negatives):
        j = row.get(neg)
        cand = {int(c) for s, c in zip(scores[t, 1:], ids[t, 1:]) if np.isfinite(s) and c >= 0}
        if j is None or j == picks[t] or j not in cand:
            raise AssertionError(f"hard negative {t}: {neg!r} is not a filled candidate of "
                                 f"anchor {picks[t]} from another document")
        same_topic += topic(j) == topic(int(picks[t]))
    share = same_topic / len(trip)
    log(f"[pipeline] {card}: hard mining, {HARD_ANCHORS:,} anchors, top {HARD_TOPK} of "
        f"{len(passages):,}: {secs:.2f} s (re-encode included); negatives sharing the "
        f"anchor's topic {share:.4f} (inbatch: ~1/8); unfilled slots returned {unfilled}; "
        f"K4 {launches['K4']}, K2 {launches['K2']}")
    if launches["K4"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"hard mining launches {launches}")
    return dict(launches=launches, secs=secs, share=share)


def text_split(dev, workdir: Path, card) -> dict:
    """scripts/bench_text_serving.py's split on the pipeline's own index:
    text queries (passage prefixes) at B 1, 64 and 4096, three legs each,
    the median of SPLIT_REPS: host tokenization at L 32, the query encode
    ('auto' -> packed_batch where 128 / 32 divides B), search_device at the
    tuned op point; each leg fenced by a synchronise."""
    pipe = Pipeline(PipelineConfig.load(workdir / "pipeline_config.json"), device=dev)
    model = with_impl(pipe._load_params(), "auto", dev)
    encode = make_encode_fn(model, device=dev)
    tok = TextTokenizer.load(workdir / "tokenizer.json", QUERY_LEN)
    index = load_index(workdir / "index", device=dev)
    passages = pipe.passages
    rng = np.random.default_rng(77)
    out = {}
    for b in SPLIT_BATCHES:
        legs = {"tokenize": [], "encode": [], "search": []}
        for rep in range(SPLIT_REPS + 1):
            texts = [" ".join(passages[i].split()[:8])
                     for i in rng.integers(0, len(passages), size=b)]
            sync()
            t0 = time.perf_counter()
            ids, mask = tok.encode_batch(texts, QUERY_LEN)
            t1 = time.perf_counter()
            q = encode(ids, mask)
            sync()
            t2 = time.perf_counter()
            index.search_device(q, K)
            sync()
            t3 = time.perf_counter()
            if rep:  # the first is a warm-up
                for leg, dt in zip(legs, (t1 - t0, t2 - t1, t3 - t2)):
                    legs[leg].append(dt * 1e3)
        out[b] = {leg: float(np.median(v)) for leg, v in legs.items()}
    log(f"[pipeline] {card}: text -> results at L {QUERY_LEN}, median of {SPLIT_REPS} ms "
        "(tokenize / encode / search_device): " + "; ".join(
            f"B {b} {r['tokenize']:.3f} / {r['encode']:.3f} / {r['search']:.3f}"
            for b, r in out.items()))
    return out


def recall_witness(dev, workdir: Path, card) -> dict:
    """What caps the pipeline index's recall, on the eval's own queries and
    exact f64 ground truth (``Pipeline._eval_queries``): the exact f32
    search over the embeddings; the index at full tile coverage through K1
    (int8 and 'precise' bf16 queries) and through K1's plain version; the
    ceiling of the int8 rows alone, an exact f32 search over the index's
    own rows (``reconstruct``); the median spread of the true top-10's
    scores against the median score error at the true neighbours of the
    int8 rows and of K1's scores (bf16 queries and centroids, the
    reference's contract); how many true neighbours share the source
    passage's template (its text but for the document number)."""
    pipe = Pipeline(PipelineConfig.load(workdir / "pipeline_config.json"), device=dev)
    emb = np.load(workdir / "embeddings.npy")
    q, gt = pipe._eval_queries(emb)
    src = np.random.default_rng(0).choice(emb.shape[0], q.shape[0], replace=False)
    x = torch.from_numpy(emb).to(dev)
    qt = torch.from_numpy(q).to(dev)
    index = load_index(workdir / "index", device=dev)
    full = index._tune_n_tiles()
    s_k1, i_k1 = index.search(q, K, p_tiles=full)
    out = {"exact f32": recall_at_k(tiled_topk(x, qt, K)[1].cpu().numpy(), gt),
           "K1 full coverage": recall_at_k(i_k1, gt),
           "K1 full, precise": recall_at_k(
               index.search(q, K, p_tiles=full, scoring="precise")[1], gt)}
    kernel = ivf_band_module.tiles_topk_resid
    ivf_band_module.tiles_topk_resid = band.tiles_topk_resid_reference
    try:
        out["plain full coverage"] = recall_at_k(index.search(q, K, p_tiles=full)[1], gt)
    finally:
        ivf_band_module.tiles_topk_resid = kernel
    rows = torch.from_numpy(index.reconstruct(np.arange(emb.shape[0]))).to(dev)
    out["int8 rows, exact"] = recall_at_k(tiled_topk(rows, qt, K)[1].cpu().numpy(), gt)
    g = torch.from_numpy(gt).to(dev)
    s_true = (x[g] * qt[:, None]).sum(-1)
    err = float(((rows[g] * qt[:, None]).sum(-1) - s_true).abs().median())
    found = torch.from_numpy(i_k1).to(dev)
    k1_err = float((torch.from_numpy(s_k1).to(dev)
                    - (x[found] * qt[:, None]).sum(-1)).abs().median())
    spread = float((s_true[:, 0] - s_true[:, -1]).median())
    template = [p.split(" ", 2)[2] for p in pipe.passages]
    sizes = {}
    for t in template:
        sizes[t] = sizes.get(t, 0) + 1
    mates = float(np.mean([[template[j] == template[i] for j in row]
                           for i, row in zip(src, gt)]))
    log(f"[pipeline] {card}: recall@{K} witness: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()) + f"; the true top-{K}'s score spread "
        f"{spread:.3g} (median) against the score error of the int8 rows {err:.3g} and "
        f"of K1 {k1_err:.3g}; {mates:.4f} of the true neighbours share the source's "
        f"template ({np.mean([sizes[template[i]] for i in src]):.1f} passages a template)")
    del x, rows, qt, index
    torch.cuda.empty_cache()
    return dict(out, spread=spread, err=err, k1_err=k1_err, mates=mates)


def run_pipeline(dev, card) -> dict:
    """Cell 12: the port's pipeline from raw text to a served index, through
    the CLI entry point in this process: the six stages and their table,
    the recall witness (the index held to its plain version at full
    coverage; the 0.90 floor reported), a no-op resume, a search from text,
    hard mining, the text -> results split. Returns the path's kernel
    launches."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        workdir = tmp / "run"
        cfg_path = tmp / "cell12.json"
        pipeline_config(workdir).save(cfg_path)
        argv = ["pipeline", "--config", str(cfg_path), "--device", str(dev)]
        reset_launches()
        with StageProbe() as probe:
            printed, _ = cli_run(argv)
        launches = kernel_counts()
        result = json.loads(printed[-1])
        stage_table(workdir, probe, card)
        for s in PIPE_STAGES:
            if not (workdir / f".done_{s}").exists():
                raise AssertionError(f"stage {s} left no marker")
        for name in PIPE_ARTIFACTS:
            if not (workdir / name).exists():
                raise AssertionError(f"no artifact {name}")
        losses = [e["loss"] for e in events(workdir, "train_step")]
        (enc_ev,), tuned = events(workdir, "encoded"), events(workdir, "tuned")
        worst = check_embeddings(workdir / "embeddings.npy", PIPE_DOCS, 384)
        stages = probe.stages
        log(f"[pipeline] {card}: loss {losses[0]:.4f} -> {losses[-1]:.4f} ({len(losses)} logged "
            f"of {PIPE_STEPS} steps); embeddings {PIPE_DOCS:,} x 384, max |norm - 1| "
            f"{worst:.3g}, mean pairwise cosine {enc_ev['mean_sim']:.4f}; tune op "
            f"{tuned[-1]['op']} recall {tuned[-1]['recall']:.4f} vs exact, met "
            f"{tuned[-1]['met']}; eval recall@{K} {result['recall_at_k']:.4f}, "
            f"{result['qps']:,.1f} QPS (host clock, {result['nq']} queries); K4 forward / "
            f"backward in train {stages['train']['K4']} / {stages['train']['K4 bwd']}, K4 in "
            f"encode {stages['encode']['K4']}, K1 in tune {stages['tune']['K1']}, in eval "
            f"{stages['eval']['K1']}")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"training loss not finite and falling: {losses}")
        if min(stages["train"]["K4"], stages["train"]["K4 bwd"], stages["encode"]["K4"],
               stages["tune"]["K1"], stages["eval"]["K1"]) <= 0:
            raise AssertionError(f"a kernel of the pipeline never launched: {stages}")
        witness = recall_witness(dev, workdir, card)
        if witness["exact f32"] < FLAT_RECALL_FLOOR:
            raise AssertionError(f"exact f32 recall@{K} {witness['exact f32']:.4f} < "
                                 f"{FLAT_RECALL_FLOOR}: the eval's ground truth is not the "
                                 "embeddings' own")
        gap = abs(witness["K1 full coverage"] - witness["plain full coverage"])
        if gap > PIPE_METHOD_TOL or result["recall_at_k"] < witness["K1 full coverage"] - \
                PIPE_METHOD_TOL:
            raise AssertionError(f"the index departs from its method: eval "
                                 f"{result['recall_at_k']:.4f}, {witness}")
        if result["recall_at_k"] < PIPE_RECALL_FLOOR:
            log(f"[pipeline] {card}: UNMET: eval recall@{K} {result['recall_at_k']:.4f} < the "
                f"{PIPE_RECALL_FLOOR} floor, equal to K1's plain version at full coverage "
                f"({witness['plain full coverage']:.4f}); the int8 rows alone reach "
                f"{witness['int8 rows, exact']:.4f} (mean cosine {enc_ev['mean_sim']:.4f})")

        n_done = len(events(workdir, "stage_done"))
        reset_launches()
        again, secs = cli_run(argv)
        if (json.loads(again[-1]) != result or kernel_counts()["K4"] != 0
                or len(events(workdir, "stage_done")) != n_done):
            raise AssertionError(f"the resume re-ran a stage: {again[-1]}, {kernel_counts()}")
        log(f"[pipeline] {card}: resume: every stage skipped in {secs:.2f} s, the same "
            "eval.json")

        reset_launches()
        hits, secs = cli_run(["search", "--workdir", str(workdir), "--device", str(dev),
                              "--query", SEARCH_QUERY, "-k", str(K)])
        search_launches = kernel_counts()
        log(f"[pipeline] {card}: search {SEARCH_QUERY!r}: {len(hits)} passages in {secs:.2f} s (model, "
            f"index and passages loaded); K4 {search_launches['K4']}, K1 "
            f"{search_launches['K1']}; top: {hits[0] if hits else None}")
        if len(hits) != K or search_launches["K4"] <= 0 or search_launches["K1"] <= 0:
            raise AssertionError(f"search printed {len(hits)} lines, launches {search_launches}")
        for k, v in search_launches.items():
            launches[k] += v

        hard = hard_mining(dev, workdir, tmp, card)
        reset_launches()
        split = text_split(dev, workdir, card)
        for k, v in hard["launches"].items():
            launches[k] += v + kernel_counts()[k]
    log(f"[pipeline] {card}: cell 12 in {time.perf_counter() - t_phase:.1f} s; its launches "
        f"{launches}")
    return dict(launches=launches, result=result, split=split)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
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
        for line in ptxas_report(out):
            log(f"[build] {name} {line}")
    log("[build] tiles_resid instantiations (ptxas): " + "; ".join(ptxas_instances(
        built["tiles_resid"][1], lambda sym: resid_label(sym) if "resid_" in sym else None)))
    log("[build] tiles_scan top-2 instantiations (ptxas): " + "; ".join(ptxas_instances(
        built["tiles_scan"][1], tc_top2_label)))
    k4_tensor_core_check(built["mha_small_head"][0])
    pq_tensor_core_check(built["pq_scan"][0])
    scan_tensor_core_check(sass_counts(built["tiles_scan"][0]))
    resid_tensor_core_check(sass_counts(built["tiles_resid"][0]))

    chunk_fn = make_corpus(dev, CHUNK)
    kmeans_determinism(chunk_fn)
    err = small_kernel_checks(dev)

    n_chunks = N_ROWS // CHUNK
    t0 = time.perf_counter()
    queries, gt = queries_and_gt(chunk_fn, n_chunks, CHUNK, dev, B)
    log(f"[gt] exact f32 top-{K} of {gt.shape[0]} queries over {N_ROWS} rows: "
        f"{time.perf_counter() - t0:.1f} s")
    t_run = time.perf_counter()

    def phase(fn, *args):
        """fn(*args), its host seconds logged; after it the path's tensors
        freed, reference cycles included, and the card's cache emptied."""
        t0 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_run:.1f} s into the paths)")
        return out

    # one arena at a time: each path's index is gone before the next
    runs = [phase(run_residual, dev, chunk_fn, n_chunks, queries, gt, card)]
    runs.append(phase(run_sharded, dev, chunk_fn, n_chunks, queries, gt, card,
                      runs[0]["cell1"]))
    runs.append(phase(run_whole_row, dev, chunk_fn, n_chunks, queries, gt, card))
    runs.append(phase(run_top2_routes, dev, chunk_fn, queries, card))
    runs.append(phase(run_mutation, dev, chunk_fn, n_chunks, queries, gt, card, runs[0]["op"]))
    runs.append(phase(run_flat, dev, chunk_fn, queries, card))
    runs.append(phase(run_pq, dev, chunk_fn, queries, card))
    runs.append(phase(run_k6, dev, chunk_fn, queries, card))
    runs.append(phase(run_config5, dev, chunk_fn, queries, card))
    runs.append(phase(c5_small_checks, dev, chunk_fn, queries, card))
    del queries, gt
    torch.cuda.empty_cache()
    runs.append(phase(run_ivf_flat, dev, card))
    runs.append(phase(run_ivf_pq, dev, card))

    err["K4"] = err["K4 bwd"] = phase(attn_checks, dev)
    train = phase(run_training, dev, card)
    enc = phase(run_encode_search, dev, train["model"], card)
    runs.append(phase(run_train_dp, dev, card))
    k4 = phase(k4_main_shapes, dev)
    k4_err = max(r["err"] for r in k4.values())
    runs.append(dict(launches=phase(run_pipeline, dev, card)["launches"], mp={}))
    runs.append(dict(
        launches={"K4": train["launches"][0] + enc["launches"],
                  "K4 bwd": train["launches"][1], "K2 ip": enc["k2_launches"]},
        mp={"K4": {**k4[1536]["fwd"], "err": k4_err},
            "K4 bwd": {**k4[1536]["bwd"], "err": k4_err}, "K2 ip": enc["k2"]}))
    log(f"[encoder] {card}: training {train['ms']['auto']:.3f} ms/step through K4 "
        f"({TRIPLETS / train['ms']['auto'] * 1e3:,.1f} triplets/s; naive "
        f"{train['ms']['naive']:.3f}, fused {train['ms']['fused']:.3f} ms/step); encode "
        f"{enc['rates']['packed']:,.1f} passages/s through K4 (naive "
        f"{enc['rates']['naive']:,.1f}, fused {enc['rates']['fused']:,.1f}); query recall@{K} "
        f"{enc['recall']:.4f}")

    launches = {}
    for r in runs:  # a kernel's launches over every path that ran it
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    mp = {k: v for r in runs for k, v in r["mp"].items()}
    for key in KERNELS:
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"{key} ({KERNELS[key]['name']}) never launched on its path")
    records = []
    for key, meta in KERNELS.items():
        errs = ([mp[key]["err"]] if key in SHAPE_RECORDS else [err[key]] + [
            m["err"] for k, m in mp.items() if k.split()[0] == key.split()[0]])
        records.append({**meta, "launches": launches[key], "max_abs_err": max(errs),
                        **{f: mp[key].get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms", "shape")}})
    print(json.dumps({"kernels": records}))
    log(f"[time] the run: {time.perf_counter() - t_start:.1f} s")
    log(f"[kernel] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
