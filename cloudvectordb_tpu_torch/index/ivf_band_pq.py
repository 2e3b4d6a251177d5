"""Tile-pruned PQ index with refine tiers (counterpart of
cloudvectordb_tpu/index/ivf_band.py:2146-4004, ``BandIVFPQIndex``; the
registry names it ``band_ivf_pq``).

PQ codes are the memory format (m bytes a row), the tile table prunes the
decode to each query tile's probed lists (K5, ops/pq.py), and a refine tier
re-ranks the candidates. BASELINE config #3 (10M×768, nlist 4096, m 64,
nbits 8, OPQ, refine 'int8') and config #5 (125M×768 per card, nlist
16384, refine 'pq2') are ``build_device_streaming``'s path. Two serving
routes share one build: ``serve_from='pq'`` (K5, then the refine tier) and
``serve_from='refine'`` (the residual-int8 refine rows scanned directly by
K1, which the tuner prefers when they exist).

Refine tiers (the reference's, ``ivf_band.py:2188-2212``):
- 'int8': residual (or whole-row) int8 rows in device memory, an exact
  rescore of the kernel's candidates (``_pq_tiles_core``);
- 'pq2': a second PQ (m2 bytes a row) trained on the tier-1 reconstruction
  error, its codes keyed by global id; the rescore adds q·decode2 to the
  tier-1 score (``_pq2_rescore``; l2 takes the per-row s₂ table);
- 'host': int8 residual rows in host memory, keyed by global id; the
  shortlist's rows cross to the card from pinned memory for an exact
  rescore (``_host_rescore``); ``search()`` only;
- 'pq2+host': the cascade, tier 2 narrows the kernel's candidates to
  k·host_factor on the card, then the host rescore.

Filtered search (``where=``) masks rows in K5 or K1 and drops tiles with no
allowed row from the plan; pending rows are filtered before their top-k
(``_merge_pending_topk``; the reference filters them after it on this
route, ROADMAP queue 3). ``metric='l2'`` ranks by -‖q - x̂‖² on both routes
(K5 over a per-row bias cached per arena state). ``aniso_eta > 1`` trains
and encodes with anisotropic codebooks (index/pq.py).

Mutation: ``add`` encodes a batch on the device and appends it to the
pending buffer (whole-row int8 at its own scale, scanned exactly) and the
gid-keyed tier stores; ``merge_pending`` (also past ``merge_threshold``)
and ``remove`` re-sort the arena (``_reassemble``, on the device; the
kernel masks by row count, so holes cannot stay); ``reconstruct``,
``merge_from``, ``build_streaming`` and ``attach_host_refine`` complete the
surface.

The port keeps one code layout: row-major (N_pad, m) uint8 codes and a
separate (N_pad,) uint8 local-list byte in residual mode. The reference
keeps code-major (m+1, N_pad) codes for host builds, for the TPU's lanes;
either layout loads here. Past ``seg_rows_cap`` (28·2^20 rows) the
reference stores the arena as segments, for Mosaic's DMA descriptors, and
K5 keeps each segment's candidate pools apart (``_seg_layout``). The port
keeps the arena, the local bytes and the centroid tiles joined (one tensor
each: no copy, no pad tile) and K5 dispatches a segment at a time over
views of them, so its pools are the reference's: five segments at 125M
rows. The segmentation follows ``_n_pad_rows`` wherever it changes (merge,
remove, merge_from, build_streaming, load), and an artifact is saved
joined, as the reference's. Unlike the reference, an int8 refine index
past the cap builds, grows and serves (its rows fit on the card; ROADMAP
queue 3). ``_fit_tile_n_to_skew`` keeps tile_n a multiple of 128, which the
reference does not (ADVICE.md r5).
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.arena import grow_scatter_gid, normalize_remove_ids
from cloudvectordb_tpu_torch.eval.tune import coverage_ladder
from cloudvectordb_tpu_torch.index.base import pad_rows, to_numpy
from cloudvectordb_tpu_torch.index.ivf_band import (
    BandIVFIndex, _answers_out, _host_rescore, _next_pow2, _pq2_rescore, _pq_tiles_plan_search,
    _queries_in, _tiles_resid_plan_search, host_rows_sq)
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.index.opq import train_opq
from cloudvectordb_tpu_torch.index.pq import (
    pq_decode, pq_encode, pq_encode_aniso, train_pq, train_pq_aniso)
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.band import order_centroids, resid_row_bias
from cloudvectordb_tpu_torch.ops.pq import pq_row_bias
from cloudvectordb_tpu_torch.ops.topk import f32_const
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device
from cloudvectordb_tpu_torch.utils.metrics import SEARCH, span
from cloudvectordb_tpu_torch.utils.native import arena_sort, gather_rows

_REFINES = ("none", "int8", "pq2", "host", "pq2+host")


def _scale_of(src: torch.Tensor) -> float:
    """The int8 scale max(min(amax, 4·rms)/127, 1e-12) in Python-float
    arithmetic from the f32 rms and amax (the reference's build paths)."""
    rms = float(torch.sqrt(torch.mean(src * src)))
    amax = float(torch.max(torch.abs(src)))
    return max(min(amax, 4.0 * rms) / 127.0, 1e-12)


def _int8_scale(src: torch.Tensor) -> float:
    """The refine scale max(min(amax, 4·rms)/127, 1e-12), in f32 as the
    reference's ``_populate`` computes it."""
    rms = torch.sqrt(torch.mean(src * src))
    amax = torch.max(torch.abs(src))
    return float(torch.clamp_min(torch.minimum(amax, 4.0 * rms) / f32_const(127.0, src),
                                 1e-12))


def _quantize(src: torch.Tensor, scale: float) -> torch.Tensor:
    """round(src / scale) clipped to ±127, dividing by the f32 scale."""
    return torch.clamp(torch.round(src / f32_const(scale, src)), -127, 127).to(torch.int8)


def pq_candidate_budget(k: int, refine_factor: int, n_pools: int, tq: int, p_tiles: int,
                        top2: bool, *, two_stage: bool, n: int, tile_n: int) -> tuple:
    """K5's candidate budget over an arena of ``n`` rows (the reference's,
    number for number): (k_cand, n_pools, l_buckets). A two-stage search
    draws k·refine_factor candidates (at least 32); auto pools
    (n_pools <= 0) hold them within a slot budget that shrinks with the
    query tile; top2 doubles each pool's slots; the bucket count is the
    next power of two of k_cand over the slots, floored at 128, that
    divides tile_n."""
    k_cand = min(max(k * refine_factor, 32), n) if two_stage else k
    slot_budget = max(min(262_144 // tq, 8192), tile_n)
    mult = 2 if top2 else 1
    if n_pools <= 0:
        n_pools = max(1, min(-(-k_cand // (mult * tile_n)),
                             max(slot_budget // (mult * tile_n), 1), p_tiles))
    l_buckets = min(tile_n, max(128, _next_pow2(-(-k_cand // (mult * n_pools)))))
    while tile_n % l_buckets != 0 and l_buckets < tile_n:
        l_buckets *= 2
    l_buckets = min(l_buckets, tile_n)
    if tile_n % l_buckets != 0:
        l_buckets = tile_n
    return min(k_cand, mult * n_pools * l_buckets), n_pools, l_buckets


def host_tier_rescore(q: torch.Tensor, v, gids, rows: np.ndarray, assign: np.ndarray,
                      pos: np.ndarray, centroids, scale: float, rows_sq=None, *, k: int,
                      resid: bool, l2: bool, cache: dict) -> tuple:
    """The host tier's exact rescore of the candidates (v, gids): the host
    store's int8 ``rows`` at positions ``pos`` (their lists ``assign[pos]``;
    l2 residual rows: ``rows_sq[pos]``, their ‖x̂‖²) gathered into the pinned
    buffer that ``cache`` keeps (the only host -> card traffic of the
    search), copied to q's device, rescored by ``_host_rescore``."""
    dev = q.device
    shape = (*pos.shape, rows.shape[1])
    size = int(np.prod(shape))
    pinned = cache.get("pinned")
    if pinned is None or pinned.numel() < size:
        pinned = torch.empty(size, dtype=torch.int8, pin_memory=dev.type == "cuda")
        cache["pinned"] = pinned
    buf = pinned[:size].view(shape)
    np.take(rows, pos, axis=0, out=buf.numpy())
    r8 = buf.to(dev, non_blocking=True)
    asg = torch.as_tensor(assign[pos].astype(np.int64), device=dev)
    x_sq = torch.as_tensor(rows_sq[pos], device=dev) if rows_sq is not None else None
    out = _host_rescore(q, v, gids, r8, asg, centroids, scale, x_sq, k=k, resid=resid, l2=l2)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()  # the buffer is reused
    return out


class BandIVFPQIndex(BandIVFIndex):
    kind = "band_ivf_pq"
    #: arenas past this many rows are searched a segment at a time (the
    #: reference's cap, ivf_band.py:2167; tests patch it on the class)
    seg_rows_cap = 28 * 1024 * 1024

    def __init__(
        self,
        dim: int,
        nlist: int,
        m: int = 64,
        nbits: int = 8,
        refine: str = "int8",
        pq_train_iters: int = 8,
        kmeans_iters: int = 15,
        seed: int = 0,
        tile_n: int = 1024,
        tile_q: int = 128,
        residual: bool = True,
        opq_matrix: np.ndarray | None = None,
        aniso_eta: float = 0.0,
        m2: int = 32,
        nbits2: int = 8,
        metric: str = "ip",
        device: str | torch.device = DEFAULT,
    ):
        """The reference's constructor with an explicit ``device``; what it
        refuses raises ValueError."""
        if refine not in _REFINES:
            raise ValueError(f"unknown refine {refine!r}")
        if dim % m or dim % m2:
            raise ValueError(f"dim {dim} not divisible by m={m} / m2={m2}")
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        super().__init__(dim, nlist, dtype="int8", kmeans_iters=kmeans_iters, seed=seed,
                         tile_n=tile_n, tile_q=tile_q, device=device)
        self.metric = metric
        self.opq_matrix = None if opq_matrix is None else np.array(opq_matrix, np.float32)
        self.m = m
        self.nbits = nbits
        self.refine = refine
        self.residual = residual
        self.aniso_eta = aniso_eta
        self.m2 = m2
        self.nbits2 = nbits2
        self.pq_train_iters = pq_train_iters
        # residual PQ stores refine rows as int8 residuals (the local list
        # byte that recovers the centroid term already exists)
        self._refine_residual = residual and refine == "int8"
        self.codebooks: np.ndarray | None = None  # (m, 2**nbits, dim/m) f32
        self.codebooks2: np.ndarray | None = None  # (m2, 2**nbits2, dim/m2), tier 2
        self._codes: torch.Tensor | None = None  # (N_pad, m) uint8, arena order
        self._local: torch.Tensor | None = None  # (N_pad,) uint8 local list byte
        self._refine_rows: torch.Tensor | None = None  # (N_pad, dim) int8 or (1, dim)
        self._n_pad_rows = 0
        self._opq_dev = None
        # gid-keyed tier stores, each with appends not folded in yet
        self._codes2: torch.Tensor | None = None  # (N_cap, m2) uint8 on the device
        self._s2: torch.Tensor | None = None  # (N_cap,) f32 ‖x̂₂‖² - ‖x̂₁‖² (l2)
        self._codes2_pending: list[np.ndarray] = []
        self._s2_pending: list[np.ndarray] = []
        self._host_rows: np.ndarray | None = None  # (N_cap, dim) int8 in host memory
        self._host_assign: np.ndarray | None = None  # (N_cap,) int32 list ids
        self._host_scale = 0.0
        self._host_pending_rows: list[np.ndarray] = []
        self._host_pending_assign: list[np.ndarray] = []
        self._assign_gid: np.ndarray | None = None  # attach_host_refine's assignments
        # pending adds: whole-row int8 at _pending_scale in the base buffer,
        # their PQ codes chunk for chunk beside it
        self._pending_codes: list[np.ndarray] = []
        self._pending_scale = 0.0
        self._caches: dict = {}  # l2 biases and the host tier's staging, by arena state

    @property
    def _tier2_active(self) -> bool:
        return self.refine in ("pq2", "pq2+host")

    @property
    def _host_active(self) -> bool:
        return self.refine in ("host", "pq2+host")

    # -- quantizers ---------------------------------------------------------
    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        """x' = x @ Rᵀ on the device in f32 (TF32 off by the package's
        policy: the reference's Precision.HIGHEST); x itself without OPQ."""
        if self.opq_matrix is None:
            return x
        if self._opq_dev is None:
            self._opq_dev = torch.as_tensor(self.opq_matrix, device=self.device)
        return x @ self._opq_dev.T

    def _pq_encode_rows(self, enc_in: torch.Tensor, xdir: torch.Tensor,
                        codebooks: torch.Tensor) -> torch.Tensor:
        """Codes under the metric the codebooks were trained with
        (anisotropic when aniso_eta > 1, ``xdir`` the full rotated rows)."""
        if self.aniso_eta > 1.0:
            return pq_encode_aniso(enc_in, xdir, codebooks, eta=self.aniso_eta)
        return pq_encode(enc_in, codebooks)

    def _train_pq_codebooks(self, enc_vecs: torch.Tensor, xdir: torch.Tensor) -> np.ndarray:
        if self.aniso_eta > 1.0:
            cb = train_pq_aniso(enc_vecs, xdir, self.m, self.nbits, iters=self.pq_train_iters,
                                eta=self.aniso_eta, seed=self.seed)
        else:
            cb = train_pq(enc_vecs, self.m, self.nbits, iters=self.pq_train_iters,
                          seed=self.seed)
        return cb.cpu().numpy()

    def _train_quantizers(self, tr: torch.Tensor, centroids, codebooks,
                          codebooks2=None) -> torch.Tensor:
        """Coarse centroids (in band order), PQ codebooks and the refine
        tier's quantizers (tier-2 codebooks, the host scale) from the
        rotated training rows ``tr``, each skipped when given. Returns the
        rows the codebooks are trained on (residuals in residual mode)."""
        if centroids is None:
            c, _ = train_kmeans(tr, self.nlist, iters=self.kmeans_iters, seed=self.seed)
            c = c.cpu().numpy()
            centroids = c[order_centroids(c)]
        self.centroids = np.array(centroids, np.float32)
        train_vecs = tr
        if self.residual:
            cdev = self._centroids_dev()
            a, _ = assign_clusters(tr, cdev)
            train_vecs = tr - cdev[a]
        if codebooks is None:
            codebooks = self._train_pq_codebooks(train_vecs, tr)
        self.codebooks = np.array(codebooks, np.float32)
        if self._tier2_active:
            self._train_tier2(train_vecs, tr, codebooks2)
        if self._host_active:
            self._host_scale = _scale_of(train_vecs)
        return train_vecs

    def _train_tier2(self, enc_sample: torch.Tensor, xdir: torch.Tensor, codebooks2=None):
        """Tier-2 codebooks on the tier-1 reconstruction error of the
        training rows (additive residual PQ), or ``codebooks2`` as given
        (the reference seeds its k-means from jax.random: parity takes its
        codebooks from outside)."""
        if codebooks2 is None:
            cb = self._codebooks_dev()
            err = enc_sample - pq_decode(self._pq_encode_rows(enc_sample, xdir, cb), cb)
            codebooks2 = train_pq(err, self.m2, self.nbits2, iters=self.pq_train_iters,
                                  seed=self.seed + 1).cpu().numpy()
        self.codebooks2 = np.array(codebooks2, np.float32)

    def _encode_tier2(self, enc_in: torch.Tensor, codes: torch.Tensor, c_rows=None,
                      with_s2: bool = False):
        """Tier-2 codes of rows whose tier-1 codes are ``codes``; with_s2
        (l2) also s₂ = 2·x̂₁·d₂ + ‖d₂‖² per row (x̂₁ = [c +] decode1, d₂ =
        decode2), the scalar the exact l2 rescore needs."""
        cb2 = self._codebooks2_dev()
        err = enc_in - pq_decode(codes, self._codebooks_dev())
        codes2 = pq_encode(err, cb2)
        if not with_s2:
            return codes2
        d2 = pq_decode(codes2, cb2)
        xhat1 = enc_in - err
        if c_rows is not None:
            xhat1 = xhat1 + c_rows
        return codes2, f32_const(2.0, d2) * (xhat1 * d2).sum(dim=1) + (d2 * d2).sum(dim=1)

    def _train_opq(self, sample: torch.Tensor) -> None:
        r, _ = train_opq(sample[: min(int(sample.shape[0]), 65536)], self.m, self.nbits,
                         outer_iters=4, pq_iters=5, seed=self.seed)
        self.opq_matrix = r

    @classmethod
    def train_proto(cls, sample, nlist: int, m: int = 64, opq: bool = False,
                    centroids: np.ndarray | None = None,
                    codebooks: np.ndarray | None = None,
                    codebooks2: np.ndarray | None = None, **kw) -> "BandIVFPQIndex":
        """Every quantizer (OPQ rotation, coarse centroids in band order, PQ
        codebooks, the refine tier's) trained on ``sample``, or taken as
        given: the empty trained index."""
        idx = cls(int(sample.shape[1]), nlist, m=m, **kw)
        sample = torch.as_tensor(sample, dtype=torch.float32).to(idx.device)
        if opq and idx.opq_matrix is None:
            idx._train_opq(sample)
        idx._train_quantizers(idx._rotate(sample), centroids, codebooks, codebooks2)
        return idx

    # -- build ----------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, m: int = 64, train_sample: int = 262_144,
              opq: bool = False, centroids: np.ndarray | None = None,
              codebooks: np.ndarray | None = None, codebooks2: np.ndarray | None = None,
              **kw) -> "BandIVFPQIndex":
        """Build from (N, D) vectors. The training sample is the reference's
        numpy draw (``ivf_band.py:2603-2604``). ``centroids``
        (locality-ordered), ``codebooks``, ``codebooks2`` and ``opq_matrix``
        (a constructor keyword), when given, skip their training."""
        dev = as_device(kw.get("device", DEFAULT))
        x = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
        ns = min(train_sample, x.shape[0])
        sel = np.sort(np.random.default_rng(kw.get("seed", 0)).choice(
            x.shape[0], ns, replace=False))
        idx = cls.train_proto(x[torch.as_tensor(sel, device=dev)], nlist, m=m, opq=opq,
                              centroids=centroids, codebooks=codebooks,
                              codebooks2=codebooks2, **kw)
        idx._populate(idx._rotate(x))
        return idx

    def _populate(self, x: torch.Tensor) -> None:
        """Arena from rotated rows: list order, codes, local bytes, refine
        rows (the scale from every row), and the gid-keyed tier stores."""
        cdev = self._centroids_dev()
        a, _ = assign_clusters(x, cdev)
        a_np = a.cpu().numpy()
        order = np.argsort(a_np, kind="stable")
        order_d = torch.as_tensor(order, device=self.device)
        xs = x[order_d]
        n = int(xs.shape[0])
        counts = np.bincount(a_np, minlength=self.nlist)
        self._offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self._n = n
        n_pad = self._fit_tile_n_to_skew(n)
        self._tile_window = self._compute_tile_window()
        a_sorted = a[order_d]
        enc = xs - cdev[a_sorted] if self.residual else xs
        codes = torch.zeros((n_pad, self.m), dtype=torch.uint8, device=self.device)
        codes[:n] = self._pq_encode_rows(enc, xs, self._codebooks_dev())
        refine = torch.zeros((1, self.dim), dtype=torch.int8, device=self.device)
        scale = 0.0
        if self.refine == "int8":
            src = enc if self._refine_residual else xs
            scale = _int8_scale(src)
            refine = torch.zeros((n_pad, self.dim), dtype=torch.int8, device=self.device)
            refine[:n] = _quantize(src, scale)
        if self._tier2_active:  # keyed by global id: arena row i is gid order[i]
            c_rows = cdev[a_sorted] if self.residual else None
            out = self._encode_tier2(enc, codes[:n], c_rows, with_s2=self.metric == "l2")
            c2_sorted, s2_sorted = out if self.metric == "l2" else (out, None)
            self._codes2 = torch.zeros((n, self.m2), dtype=torch.uint8, device=self.device)
            self._codes2[order_d] = c2_sorted
            if s2_sorted is not None:
                self._s2 = torch.zeros(n, dtype=torch.float32, device=self.device)
                self._s2[order_d] = s2_sorted
        if self._host_active:
            if self._host_scale == 0.0:
                self._host_scale = _scale_of(enc)
            host = np.empty((n, self.dim), np.int8)
            host[order] = _quantize(enc, self._host_scale).cpu().numpy()
            self._host_rows = host
            self._host_assign = a_np.astype(np.int32)
        self._ids = order.astype(np.int64)
        self._install(codes, self._local_from_offsets() if self.residual else None,
                      refine, scale)

    @classmethod
    def build_device_streaming(
        cls, chunk_fn, n_chunks: int, nlist: int, m: int = 64,
        train_sample: int = 262_144, opq: bool = False,
        centroids: np.ndarray | None = None, codebooks: np.ndarray | None = None,
        codebooks2: np.ndarray | None = None, **kw,
    ) -> "BandIVFPQIndex":
        """Device-resident build, BASELINE configs #3 and #5's path: the codes,
        refine rows and tier-2 codes are written into arenas on the device
        and only the (N,) assignments reach the host (and, with a host tier,
        each chunk's int8 rows). ``chunk_fn(i) -> (n_i, D)`` must be
        deterministic: pass 1 trains OPQ, the coarse quantizer, the PQ
        codebooks and the refine tier on the first chunk and assigns every
        chunk; pass 2 re-produces each chunk, encodes it and scatters its
        codes and refine rows to their host-sorted positions, its tier-2
        codes (and l2 s₂) to their global ids. The refine scale comes from
        the first chunk (its training residuals in residual mode)."""
        idx = None
        cdev = None
        assigns: list[np.ndarray] = []
        sizes: list[int] = []
        for ci in range(n_chunks):
            chunk = chunk_fn(ci)
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, m=m, **kw)
            chunk = torch.as_tensor(chunk, dtype=torch.float32).to(idx.device)
            if cdev is None:
                if opq and idx.opq_matrix is None:
                    idx._train_opq(chunk[: min(train_sample, chunk.shape[0])])
                tr = idx._rotate(chunk)
                ns = min(train_sample, tr.shape[0])
                train_vecs = idx._train_quantizers(tr[:ns], centroids, codebooks, codebooks2)
                cdev = idx._centroids_dev()
                if idx.refine == "int8":  # Python-float arithmetic, as the reference's
                    idx._scale = _scale_of(train_vecs if idx._refine_residual else tr)
                train_vecs = None
            else:
                tr = idx._rotate(chunk)
            a, _ = assign_clusters(tr, cdev)
            assigns.append(a.cpu().numpy().astype(np.int32))
            sizes.append(int(chunk.shape[0]))
            chunk = tr = a = None  # one f32 chunk resident at a time
        if idx is None:
            raise ValueError("empty stream")

        assign_all = np.concatenate(assigns)
        n = assign_all.shape[0]
        order, offsets = arena_sort(assign_all, nlist)
        dest = np.empty(n, np.int64)
        dest[order] = np.arange(n)
        idx._offsets = np.asarray(offsets, np.int64)
        idx._n = n
        n_pad = idx._fit_tile_n_to_skew(n)
        idx._ids = order.astype(np.int64)
        idx._tile_window = idx._compute_tile_window()
        codes = torch.zeros((n_pad, m), dtype=torch.uint8, device=idx.device)
        do_refine = idx.refine == "int8"
        refine = torch.zeros((n_pad if do_refine else 1, idx.dim), dtype=torch.int8,
                             device=idx.device)
        need_s2 = idx._tier2_active and idx.metric == "l2"
        if idx._tier2_active:
            idx._codes2 = torch.zeros((n, idx.m2), dtype=torch.uint8, device=idx.device)
            idx._s2 = (torch.zeros(n, dtype=torch.float32, device=idx.device)
                       if need_s2 else None)
            cb2 = idx._codebooks2_dev()
        if idx._host_active:
            idx._host_rows = np.empty((n, idx.dim), np.int8)
            idx._host_assign = assign_all.astype(np.int32)
        cb = idx._codebooks_dev()
        base = 0
        for ci in range(n_chunks):
            tr = idx._rotate(torch.as_tensor(chunk_fn(ci), dtype=torch.float32).to(idx.device))
            d = torch.as_tensor(dest[base : base + sizes[ci]], device=idx.device)
            a = torch.as_tensor(assigns[ci], device=idx.device).long()
            enc = tr - cdev[a] if idx.residual else tr
            # the reference's donated scatters (``.at[d].set``) become
            # in-place writes into the preallocated arenas
            codes_b = idx._pq_encode_rows(enc, tr, cb)
            codes[d] = codes_b
            if do_refine:
                refine[d] = _quantize(enc if idx._refine_residual else tr, idx._scale)
            if idx._tier2_active:  # gid = insertion order
                dec1 = pq_decode(codes_b, cb)
                c2 = pq_encode(enc - dec1, cb2)
                idx._codes2[base : base + sizes[ci]] = c2
                if need_s2:
                    d2 = pq_decode(c2, cb2)
                    xh1 = dec1 + cdev[a] if idx.residual else dec1
                    idx._s2[base : base + sizes[ci]] = (
                        f32_const(2.0, d2) * (xh1 * d2).sum(dim=1) + (d2 * d2).sum(dim=1))
                dec1 = c2 = None
            if idx._host_active:
                idx._host_rows[base : base + sizes[ci]] = (
                    _quantize(enc, idx._host_scale).cpu().numpy())
            base += sizes[ci]
            tr = enc = d = a = codes_b = None
        if not do_refine:
            idx._scale = 0.0
        # the gid-keyed assignments stay on the host: attach_host_refine
        # reuses them, so a later host tier never re-runs the assignment
        idx._assign_gid = assign_all
        idx._install(codes, idx._local_from_offsets() if idx.residual else None, refine,
                     idx._scale)
        return idx

    @classmethod
    def build_streaming(cls, chunks, nlist: int, m: int = 64, train_sample: int = 262_144,
                        opq: bool = False, centroids: np.ndarray | None = None,
                        codebooks: np.ndarray | None = None,
                        codebooks2: np.ndarray | None = None, **kw) -> "BandIVFPQIndex":
        """Host-assembled build from an iterable of (n_i, D) chunks (the
        reference's ``build_streaming``): the quantizers train on the first
        chunk; each chunk is rotated, assigned and encoded on the device and
        only its codes (and refine rows, tier-2 codes, host rows) reach the
        host, where the arena assembles once with the native sort."""
        idx = None
        cdev = None
        code_chunks: list[np.ndarray] = []
        refine_chunks: list[np.ndarray] = []
        assign_chunks: list[np.ndarray] = []
        scale = 1e-12
        for chunk in chunks:
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, m=m, **kw)
            chunk = torch.as_tensor(chunk, dtype=torch.float32).to(idx.device)
            if cdev is None:
                if opq and idx.opq_matrix is None:
                    idx._train_opq(chunk[: min(train_sample, chunk.shape[0])])
                tr = idx._rotate(chunk)
                ns = min(train_sample, tr.shape[0])
                train_vecs = idx._train_quantizers(tr[:ns], centroids, codebooks, codebooks2)
                cdev = idx._centroids_dev()
                if idx.refine == "int8":
                    scale = _scale_of(train_vecs if idx._refine_residual else tr)
                train_vecs = None
            else:
                tr = idx._rotate(chunk)
            a, _ = assign_clusters(tr, cdev)
            enc = tr - cdev[a] if idx.residual else tr
            codes = idx._pq_encode_rows(enc, tr, idx._codebooks_dev())
            code_chunks.append(codes.cpu().numpy())
            assign_chunks.append(a.cpu().numpy().astype(np.int32))
            if idx.refine == "int8":
                refine_chunks.append(
                    _quantize(enc if idx._refine_residual else tr, scale).cpu().numpy())
            if idx._tier2_active:  # gid = insertion order: plain appends
                if idx.metric == "l2":
                    c2, s2 = idx._encode_tier2(enc, codes, cdev[a] if idx.residual else None,
                                               with_s2=True)
                    idx._codes2_pending.append(c2.cpu().numpy())
                    idx._s2_pending.append(s2.cpu().numpy())
                else:
                    idx._codes2_pending.append(idx._encode_tier2(enc, codes).cpu().numpy())
            if idx._host_active:
                idx._host_pending_rows.append(_quantize(enc, idx._host_scale).cpu().numpy())
                idx._host_pending_assign.append(a.cpu().numpy().astype(np.int32))
        if idx is None:
            raise ValueError("empty stream")
        codes_all = np.concatenate(code_chunks)
        assigns = np.concatenate(assign_chunks)
        n = codes_all.shape[0]
        order, offsets = arena_sort(assigns, nlist)
        idx._offsets = np.asarray(offsets, np.int64)
        idx._n = n
        n_pad = idx._fit_tile_n_to_skew(n)
        idx._tile_window = idx._compute_tile_window()
        codes = np.zeros((n_pad, m), np.uint8)
        codes[:n] = gather_rows(codes_all, order)
        refine = np.zeros((1, idx.dim), np.int8)
        if idx.refine == "int8":
            refine = np.zeros((n_pad, idx.dim), np.int8)
            refine[:n] = gather_rows(np.concatenate(refine_chunks), order)
        else:
            scale = 0.0
        idx._ids = order.astype(np.int64)
        idx._install(torch.from_numpy(codes).to(idx.device),
                     idx._local_from_offsets() if idx.residual else None,
                     torch.from_numpy(refine).to(idx.device), scale)
        return idx

    def attach_host_refine(self, host_chunk_fn, n_chunks: int, *,
                           chunks_rotated: bool = False) -> None:
        """Attach the host-memory exact-rescore tier from a host-side row
        source (the reference's ``attach_host_refine``): the rows never
        cross to the card. Needs a ``build_device_streaming`` index (its
        gid-keyed assignments); ``host_chunk_fn(i)`` must give the build's
        rows in its order (sizes are checked, contents trusted). OPQ
        rotation (unless ``chunks_rotated``), residual and int8
        quantization (scale from the first chunk) run on the host as torch
        CPU ops, on every core (the reference's numpy takes one). A 'pq2'
        index becomes the 'pq2+host' cascade, others 'host'."""
        if self._assign_gid is None:
            raise ValueError("attach_host_refine needs a build that kept its assignments "
                             "(build_device_streaming)")
        n = int(self._assign_gid.shape[0])
        if self._gid_bound() > n:
            raise ValueError(f"attach covers gids 0..{n - 1} but ids up to "
                             f"{self._gid_bound() - 1} exist: attach before add()ing")
        rot = (torch.as_tensor(self.opq_matrix).T
               if self.opq_matrix is not None and not chunks_rotated else None)
        cent = torch.as_tensor(self.centroids)
        assign = torch.as_tensor(self._assign_gid).long()
        rows = np.empty((n, self.dim), np.int8)
        base = 0
        for ci in range(n_chunks):
            chunk = torch.as_tensor(np.asarray(host_chunk_fn(ci), np.float32))
            b = chunk.shape[0]
            if base + b > n:
                raise ValueError("host chunks exceed the built row count")
            tr = chunk @ rot if rot is not None else chunk
            enc = tr - cent[assign[base : base + b]] if self.residual else tr
            if ci == 0:
                self._host_scale = _scale_of(enc)
            rows[base : base + b] = _quantize(enc, self._host_scale).numpy()
            base += b
        if base != n:
            raise ValueError(f"host chunks cover {base} of {n} rows")
        self._host_rows = rows
        self._host_assign = self._assign_gid
        self._host_pending_rows = []
        self._host_pending_assign = []
        self.refine = "pq2+host" if self._tier2_active else "host"

    # -- arena layout -----------------------------------------------------------
    def _local_from_offsets(self) -> torch.Tensor:
        """(N_pad,) uint8 local list byte of every arena row on the device:
        its list minus the first list of its tile's window."""
        tw = self._tile_window
        if tw.shape[1] > 256:
            raise ValueError(
                f"per-tile window W={tw.shape[1]} overflows the uint8 local byte even "
                "at the tile_n floor: rebuild with a smaller nlist")
        dev = self.device
        counts = torch.as_tensor(np.diff(self._offsets), device=dev)
        lists = torch.repeat_interleave(torch.arange(self.nlist, device=dev), counts)
        first = torch.as_tensor(tw[:, 0].astype(np.int64), device=dev)
        local = torch.zeros(self._n_pad_rows, dtype=torch.uint8, device=dev)
        local[: self._n] = (lists - first.repeat_interleave(self.tile_n)[: self._n]).to(
            torch.uint8)
        return local

    def _install(self, codes: torch.Tensor, local, refine: torch.Tensor, scale: float) -> None:
        """The arena and its derived device tables: the (N_pad,) local bytes
        (a tensor or numpy) and the (n_tiles, W, D) bf16 centroid tiles,
        gathered on the device."""
        self._codes = codes
        self._payload = codes  # the base class reads its row count
        self._local = None if local is None else torch.as_tensor(local, device=self.device)
        self._centroid_tiles = None
        if self.residual:
            tw = torch.as_tensor(self._tile_window.astype(np.int64), device=self.device)
            self._centroid_tiles = self._centroids_dev()[tw].to(torch.bfloat16)
        self._refine_rows = refine
        self._scale = scale
        self._dev = None

    def _fit_tile_n_to_skew(self, n: int) -> int:
        """Residual mode: shrink tile_n (halving, rounded up to a multiple
        of 128, floor 256) until the per-tile window fits the uint8 local
        byte (W <= 256) on this data's list sizes; returns the padded row
        count for the final tile_n. Needs ``_offsets`` and ``_n``. A no-op
        on healthy data."""
        while True:
            n_pad = -(-n // self.tile_n) * self.tile_n
            self._n_pad_rows = n_pad
            if (not self.residual or self.tile_n <= 256
                    or self._compute_tile_window().shape[1] <= 256):
                return n_pad
            self.tile_n = -(-(self.tile_n // 2) // 128) * 128

    def _compute_tile_window(self) -> np.ndarray:
        """(n_tiles, W) list ids intersecting each arena tile of the padded
        arena (``_n_pad_rows`` rows), rows padded by repeating the last id."""
        n_tiles = self._n_pad_rows // self.tile_n
        starts = np.arange(n_tiles, dtype=np.int64) * self.tile_n
        ends = np.minimum(starts + self.tile_n - 1, max(self._n - 1, 0))
        fl = np.clip(np.searchsorted(self._offsets, starts, side="right") - 1,
                     0, self.nlist - 1)
        ll = np.clip(np.searchsorted(self._offsets, ends, side="right") - 1,
                     0, self.nlist - 1)
        w = int((ll - fl).max()) + 1 if n_tiles else 1
        window = np.minimum(fl[:, None] + np.arange(w)[None, :], ll[:, None])
        return np.clip(window, 0, self.nlist - 1).astype(np.int32)

    def _seg_layout(self, n_pad: int) -> tuple[list[int], list[int]]:
        """(row counts, first rows) of the segments of an arena of ``n_pad``
        rows: the cap rounded down to whole tiles (at least one), then the
        rest (the reference's ``_seg_layout``)."""
        cap = max(self.seg_rows_cap // self.tile_n, 1) * self.tile_n
        rows, offs = [], []
        for off in range(0, n_pad, cap):
            rows.append(min(cap, n_pad - off))
            offs.append(off)
        return rows, offs

    @property
    def _segmented(self) -> bool:
        return self._n_pad_rows > self.seg_rows_cap

    def _seg_rows(self) -> tuple | None:
        """K5's ``segments=``: the segments' row counts past the cap, else
        None (one arena)."""
        return tuple(self._seg_layout(self._n_pad_rows)[0]) if self._segmented else None

    def _seg_n_valid(self) -> tuple:
        """Each segment's real row count (the reference's ``_seg_n_valid``)."""
        rows, offs = self._seg_layout(self._n_pad_rows)
        return tuple(int(np.clip(self._n - off, 0, r)) for r, off in zip(rows, offs))

    def _tune_n_tiles(self) -> int:
        return self._n_pad_rows // self.tile_n

    def _mask_pad_rows(self) -> int:
        return self._n_pad_rows

    def _codebooks_dev(self) -> torch.Tensor:
        return torch.as_tensor(self.codebooks, dtype=torch.float32, device=self.device)

    def _codebooks2_dev(self) -> torch.Tensor:
        hit = self._caches.get("cb2")
        if hit is None or hit[0] is not self.codebooks2:
            hit = (self.codebooks2, torch.as_tensor(self.codebooks2, dtype=torch.float32,
                                                    device=self.device))
            self._caches["cb2"] = hit
        return hit[1]

    def _list_of_rows(self) -> np.ndarray:
        """(N,) int32 list of every arena row."""
        return np.repeat(np.arange(self.nlist, dtype=np.int32), np.diff(self._offsets))

    # -- gid-keyed tier stores --------------------------------------------------
    def _codes2_device(self, fold: bool = True) -> torch.Tensor:
        """Tier-2 code table (gid-keyed) on the device. ``fold`` lands the
        pending appends (before pending rows enter the arena, and on save);
        serving passes fold=False, since its candidates are arena rows only
        (a None table always folds)."""
        dev = self.device
        if (fold or self._codes2 is None) and self._codes2_pending:
            parts = [] if self._codes2 is None else [self._codes2]
            parts.append(torch.as_tensor(np.concatenate(self._codes2_pending), device=dev))
            self._codes2 = torch.cat(parts)
            self._codes2_pending = []
        if (fold or self._s2 is None) and self._s2_pending:
            parts = [] if self._s2 is None else [self._s2]
            parts.append(torch.as_tensor(np.concatenate(self._s2_pending), device=dev))
            self._s2 = torch.cat(parts)
            self._s2_pending = []
        return self._codes2

    def _s2_device(self) -> torch.Tensor:
        self._codes2_device(fold=False)
        if self._s2 is None:
            raise ValueError("metric='l2' pq2 rescore needs the s2 table; this index was "
                             "built or loaded without it")
        return self._s2

    def _host_store(self):
        """(rows, assign) host arrays (gid-keyed) with the pending appends
        folded in."""
        if self._host_pending_rows:
            base_r = [] if self._host_rows is None else [self._host_rows]
            base_a = [] if self._host_assign is None else [self._host_assign]
            self._host_rows = np.concatenate(base_r + self._host_pending_rows)
            self._host_assign = np.concatenate(base_a + self._host_pending_assign)
            self._host_pending_rows = []
            self._host_pending_assign = []
        return self._host_rows, self._host_assign

    def _host_row_sq(self) -> np.ndarray:
        """(N,) f32 ‖x̂‖² per host-store row, the l2 host rescore's bias:
        computed on the host once per store object."""
        rows, assign = self._host_store()
        hit = self._caches.get("host_sq")
        if hit is None or hit[0] is not rows:
            hit = (rows, host_rows_sq(rows, assign, self.centroids, self._host_scale))
            self._caches["host_sq"] = hit
        return hit[1]

    # -- mutation -----------------------------------------------------------------
    def add(self, vectors, ids: np.ndarray | None = None) -> None:
        """Insert (B, D) rows, searchable at once: rotated, assigned and
        PQ-encoded on the device. The codes and whole-row int8 rows (at
        their own scale, fixed at the first add) go to the pending buffer,
        scanned exactly by every search; tier-2 codes and host rows append
        to their gid-keyed stores. Past ``merge_threshold`` of the arena the
        pending rows merge (``merge_pending``). ``ids``: explicit global
        ids, at least the current bound (and, with a refine tier active,
        exactly the next ones: its stores append by position)."""
        if self.centroids is None or self.codebooks is None:
            raise ValueError("build() trains the quantizers before add()")
        x = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        tr = self._rotate(x)
        if self._n == 0 and self._pending.size == 0:
            if ids is not None:
                raise ValueError("explicit ids need a populated arena")
            self._populate(tr)
            return
        cdev = self._centroids_dev()
        a, _ = assign_clusters(tr, cdev)
        enc = tr - cdev[a] if self.residual else tr
        codes = self._pq_encode_rows(enc, tr, self._codebooks_dev())
        if self._pending_scale == 0.0:
            # whole-row refine ties pending rows to the arena's scale; the
            # other modes need a whole-row scale: the pending scan scores raw rows
            if self.refine == "int8" and not self._refine_residual:
                self._pending_scale = self._scale
            else:
                self._pending_scale = _scale_of(tr)
        rows8 = _quantize(tr, self._pending_scale)
        b = int(x.shape[0])
        if ids is None:
            ids = self._alloc_ids(b)
        else:
            ids = np.asarray(ids, np.int64)
            if ids.shape != (b,) or ids.min(initial=np.iinfo(np.int64).max) < self._gid_bound():
                raise ValueError("explicit ids must be (B,) and not below the ids ever allocated")
            if ((self._tier2_active and self.codebooks2 is not None)
                    or (self._host_active and self._host_scale > 0)):
                if not (ids == np.arange(self._gid_bound(), self._gid_bound() + b)).all():
                    raise ValueError("explicit non-consecutive ids would misalign the "
                                     "gid-keyed refine tier stores")
            self._next_id = max(self._gid_bound(), int(ids.max(initial=-1)) + 1)
        if self._tier2_active and self.codebooks2 is not None:
            if self.metric == "l2":
                c2, s2 = self._encode_tier2(enc, codes, cdev[a] if self.residual else None,
                                            with_s2=True)
                self._codes2_pending.append(c2.cpu().numpy())
                self._s2_pending.append(s2.cpu().numpy())
            else:
                self._codes2_pending.append(self._encode_tier2(enc, codes).cpu().numpy())
        if self._host_active and self._host_scale > 0:
            self._host_pending_rows.append(_quantize(enc, self._host_scale).cpu().numpy())
            self._host_pending_assign.append(a.cpu().numpy().astype(np.int32))
        self._pending.append(rows8.cpu().numpy(), ids, a.cpu().numpy())
        self._pending_codes.append(codes.cpu().numpy())
        self._pending_dev = None
        if self._pending.size > max(self.merge_threshold * self._n, 4 * self.tile_n):
            self.merge_pending()

    def _pending_device(self):
        """(rows, ids, ids int32 on the device, n) of the pending rows,
        staged once per pending state: whole-row int8 at ``_pending_scale``
        (the PQ family's pending rows are not residuals)."""
        if self._pending_dev is None:
            snap = self._pending.snapshot_full()
            if snap is None:
                return None
            rows, pids, _ = snap
            self._pending_dev = (torch.as_tensor(rows, device=self.device), pids,
                                 torch.as_tensor(pids.astype(np.int32), device=self.device),
                                 rows.shape[0])
        return self._pending_dev

    def _pending_scan_scale(self) -> float:
        return self._pending_scale

    def _fold_pending(self) -> None:
        """The PQ family never folds into the annex (its pending rows ride
        with their codes at their own scale): the fold is the merge."""
        self.merge_pending()

    def merge_pending(self) -> None:
        """Merge the pending rows into the arena: their codes (and refine
        rows: residual rows re-expressed at the arena's scale) re-sorted
        with the arena's (``_reassemble``)."""
        if self._pending.size == 0:
            return
        if self._tier2_active and self._codes2_pending:
            self._codes2_device()  # pending rows become arena rows: land their codes
        rows8, pids, passign = self._pending.drain()
        pcodes = np.concatenate(self._pending_codes)
        self._pending_codes = []
        self._pending_dev = None
        n_old = self._n
        dev = self.device
        codes_all = torch.cat([self._codes[:n_old], torch.as_tensor(pcodes, device=dev)])
        assigns = np.concatenate([self._list_of_rows(), passign.astype(np.int32)])
        ids_all = np.concatenate([np.asarray(self._ids, np.int64)[:n_old], pids])
        refine_all = None
        if self.refine == "int8":
            if self._refine_residual:
                # pending rows are whole-row int8 at _pending_scale: residuals
                # at the arena's scale (a second quantization, merged adds only)
                r = torch.as_tensor(rows8, device=dev).float()
                resid = (r * f32_const(self._pending_scale, r)
                         - self._centroids_dev()[torch.as_tensor(passign, device=dev).long()])
                p_ref = _quantize(resid, self._scale)
            else:
                p_ref = torch.as_tensor(rows8, device=dev)
            refine_all = torch.cat([self._refine_rows[:n_old], p_ref])
        self._reassemble(codes_all, ids_all, assigns, refine_all)

    def _reassemble(self, codes_all: torch.Tensor, ids_all: np.ndarray, assigns: np.ndarray,
                    refine_all: torch.Tensor | None) -> None:
        """Re-sort (codes, ids[, refine rows]) by list (the native stable
        sort on the host, the rows gathered on the device) and reinstall the
        arena and every derived table: the shared tail of merge_pending,
        remove and merge_from. Byte for byte the reference's host re-sort."""
        order, offsets = arena_sort(np.ascontiguousarray(assigns, np.int32), self.nlist)
        n = int(codes_all.shape[0])
        self._offsets = np.asarray(offsets, np.int64)
        self._n = n
        n_pad = self._fit_tile_n_to_skew(n)
        self._ids = np.asarray(ids_all, np.int64)[order]
        self._tile_window = self._compute_tile_window()
        dev = self.device
        ordered = bool((order == np.arange(n)).all())  # a removal keeps the order
        order_d = None if ordered else torch.as_tensor(order, device=dev)
        codes = torch.zeros((n_pad, self.m), dtype=torch.uint8, device=dev)
        codes[:n] = codes_all if ordered else codes_all[order_d]
        codes_all = None
        refine = torch.zeros((1, self.dim), dtype=torch.int8, device=dev)
        if refine_all is not None:
            refine = torch.zeros((n_pad, self.dim), dtype=torch.int8, device=dev)
            refine[:n] = refine_all if ordered else refine_all[order_d]
        self._install(codes, self._local_from_offsets() if self.residual else None, refine,
                      self._scale)

    def remove(self, ids) -> int:
        """Delete rows by global id; returns how many were removed (unknown
        ids are ignored; freed ids are never reused). K5 masks by row count,
        not per list, so the arena compacts (``_reassemble``: the surviving
        rows keep their order). Pending rows and their codes drop alike;
        the gid-keyed tier stores keep stale entries (a removed gid is never
        a candidate)."""
        req = normalize_remove_ids(ids)
        if req.size == 0:
            return 0
        bound = self._gid_bound()  # fixed before ids vanish: ids are never reused
        n_rem, masks = self._pending.remove_ids(req)
        if n_rem:
            self._pending_dev = None
            self._pending_codes = [c if mk.all() else c[mk]
                                   for c, mk in zip(self._pending_codes, masks) if mk.any()]
        if self._n:
            hit = np.zeros(bound + 1, bool)
            hit[req[req < bound]] = True
            ids_arr = np.asarray(self._ids, np.int64)[: self._n]
            drop = hit[np.clip(ids_arr, -1, bound)]
            if drop.any():
                if self._tier2_active and self._codes2_pending:
                    self._codes2_device()
                keep = np.flatnonzero(~drop)
                keep_d = torch.as_tensor(keep, device=self.device)
                refine_all = (self._refine_rows[keep_d] if self.refine == "int8" else None)
                self._reassemble(self._codes[keep_d], ids_arr[keep],
                                 self._list_of_rows()[keep], refine_all)
                n_rem += int(drop.sum())
        return n_rem

    def reconstruct(self, ids) -> np.ndarray:
        """(len(ids), D) f32 rows for global ids, in the original space:
        the int8 refine rows when present, else the host store's rows, else
        the PQ decode (plus the list centroid in residual mode); pending
        rows from their int8 rows. OPQ is undone."""
        ids = np.asarray(ids, np.int64)
        bound = max(self._gid_bound(), 1)
        if ids.size and (ids.min() < 0 or ids.max() >= bound):
            raise ValueError("unknown id")
        out = np.empty((ids.shape[0], self.dim), np.float32)
        pos = np.full(bound, -1, np.int64)
        if self._n:
            pos[np.asarray(self._ids, np.int64)[: self._n]] = np.arange(self._n)
        in_arena = pos[ids] >= 0
        if in_arena.any():
            rows = pos[ids[in_arena]]
            lists = np.searchsorted(self._offsets, rows, side="right") - 1
            rows_d = torch.as_tensor(rows, device=self.device)
            if self.refine == "int8":
                rec = self._refine_rows[rows_d].float().cpu().numpy() * np.float32(self._scale)
                if self._refine_residual:
                    rec = rec + self.centroids[lists]
            elif self._host_active and (self._host_rows is not None or self._host_pending_rows):
                rows_h, assign_h = self._host_store()
                g = ids[in_arena]
                rec = rows_h[g].astype(np.float32) * np.float32(self._host_scale)
                if self.residual:
                    rec = rec + self.centroids[assign_h[g]]
            else:
                rec = pq_decode(self._codes[rows_d], self._codebooks_dev()).cpu().numpy()
                if self.residual:
                    rec = rec + self.centroids[lists]
            out[in_arena] = rec
        if (~in_arena).any():
            snap = self._pending.snapshot()
            if snap is None:
                raise ValueError("unknown id")
            p_rows, p_ids = snap
            ppos = np.full(bound, -1, np.int64)
            ppos[p_ids] = np.arange(p_rows.shape[0])
            sel = ppos[ids[~in_arena]]
            if (sel < 0).any():
                raise ValueError("unknown id")
            out[~in_arena] = p_rows[sel].astype(np.float32) * np.float32(self._pending_scale)
        if self.opq_matrix is not None:
            out = out @ self.opq_matrix
        return out

    def merge_from(self, other: "BandIVFPQIndex", id_offset: int | None = None) -> int:
        """Consolidate another index built with the same quantizers (the
        FAISS ``merge_from`` surface on the PQ memory format): the codes
        transfer verbatim with one re-sort; int8 refine rows requantize to
        this index's scale when the scales differ; the gid-keyed tier-2
        codes (and s₂) and host rows scatter under the shifted ids (host
        rows at the larger scale). Both indexes' pending rows merge first;
        global ids must not collide (``id_offset`` shifts ``other``'s).
        Returns the rows merged in."""
        if (self.kind, self.dim, self.metric, self.m, self.nbits, self.residual,
                self.refine, self.nlist) != (other.kind, other.dim, other.metric, other.m,
                                             other.nbits, other.residual, other.refine,
                                             other.nlist) or (
                (self.opq_matrix is None) != (other.opq_matrix is None)):
            raise ValueError("merge_from needs the same index family and parameters")
        same = [(self.centroids, other.centroids), (self.codebooks, other.codebooks)]
        if self.opq_matrix is not None:
            same.append((self.opq_matrix, other.opq_matrix))
        if self._tier2_active:
            if (self.m2, self.nbits2) != (other.m2, other.nbits2):
                raise ValueError("merge_from needs the same tier-2 parameters")
            same.append((self.codebooks2, other.codebooks2))
        if not all(np.allclose(a, b, rtol=0, atol=1e-6) for a, b in same):
            raise ValueError("merge_from needs the shared quantizers (train once, reuse "
                             "for every worker's build)")
        self.merge_pending()
        other.merge_pending()
        ids_s = np.asarray(self._ids, np.int64)[: self._n]
        src_o = np.asarray(other._ids, np.int64)[: other._n]  # keys of other's tier stores
        ids_o = src_o + int(id_offset) if id_offset is not None else src_o
        both = np.concatenate([ids_s, ids_o])
        uniq = np.unique(both)
        if uniq.size != both.size:
            raise ValueError(f"{both.size - uniq.size} colliding global ids: pass "
                             "id_offset=self._gid_bound() (or any disjoint shift)")
        dev = self.device
        codes_all = torch.cat([self._codes[: self._n], other._codes[: other._n].to(dev)])
        assigns = np.concatenate([self._list_of_rows(), other._list_of_rows()])
        refine_all = None
        if self.refine == "int8":
            r_o = other._refine_rows[: other._n].to(dev)
            if other._scale != self._scale:
                ratio = f32_const(other._scale / self._scale, r_o.float())
                r_o = torch.clamp(torch.round(r_o.float() * ratio), -127, 127).to(torch.int8)
            refine_all = torch.cat([self._refine_rows[: self._n], r_o])
        if self._tier2_active:
            c2_s, c2_o = self._codes2_device().cpu().numpy(), other._codes2_device().cpu().numpy()
            self._codes2 = torch.as_tensor(grow_scatter_gid(c2_s, c2_o[src_o], ids_o),
                                           device=dev)
            if self.metric == "l2":
                self._s2 = torch.as_tensor(grow_scatter_gid(
                    self._s2.cpu().numpy(), other._s2.cpu().numpy()[src_o], ids_o), device=dev)
        if self._host_active:
            rows_s, asg_s = self._host_store()
            rows_o, asg_o = other._host_store()
            if rows_s is None or rows_o is None:
                raise ValueError("refine='host' merge needs both host stores attached")
            s = max(self._host_scale, other._host_scale)  # requantizing down loses range
            if s > self._host_scale:
                rows_s = np.clip(np.round(rows_s.astype(np.float32)
                                          * np.float32(self._host_scale / s)),
                                 -127, 127).astype(np.int8)
            r_o = rows_o[src_o]
            if s > other._host_scale:
                r_o = np.clip(np.round(r_o.astype(np.float32)
                                       * np.float32(other._host_scale / s)),
                              -127, 127).astype(np.int8)
            self._host_scale = s
            self._host_rows = grow_scatter_gid(rows_s, r_o, ids_o)
            self._host_assign = grow_scatter_gid(asg_s, asg_o[src_o], ids_o)
        if self._assign_gid is not None and other._assign_gid is not None:
            self._assign_gid = grow_scatter_gid(self._assign_gid, other._assign_gid[src_o],
                                                ids_o)
        else:
            self._assign_gid = None
        self._reassemble(codes_all, both, assigns, refine_all)
        self._next_id = int(uniq[-1]) + 1 if uniq.size else 0
        return int(ids_o.shape[0])

    # -- search ---------------------------------------------------------------
    def _device_state(self) -> dict:
        if self._dev is None:
            dev = self.device
            self._dev = dict(
                codes=self._codes, local=self._local, refine=self._refine_rows,
                centroids=torch.as_tensor(self.centroids, dtype=torch.float32, device=dev),
                codebooks=self._codebooks_dev(),
                ids=torch.as_tensor(self._ids.astype(np.int32), device=dev),
                tile_window=torch.as_tensor(self._tile_window, device=dev).long(),
                centroid_tiles=self._centroid_tiles,
            )
        return self._dev

    def _refine_scan_state(self) -> dict:
        """Device state for serving straight from the residual-int8 refine
        rows (``serve_from='refine'``): they share the code arena's layout,
        so K1 scans them with each tile-list's valid end as its mask."""
        if not (self.refine == "int8" and self._refine_residual):
            raise ValueError("serve_from='refine' needs residual-int8 refine rows")
        st = self._device_state()
        if "refine_valid_end" not in st:
            tw = self._tile_window
            ve = self._offsets[:-1][tw] + np.diff(self._offsets)[tw]
            st["refine_valid_end"] = torch.as_tensor(ve.astype(np.int32), device=self.device)
        return st

    def _row_bias(self, route: str) -> torch.Tensor:
        """The l2 row bias of a route, cached per arena state (the tensors it
        reads and their versions): K5's -‖x̂‖²/2 over the codes ('pq'), K1's
        over the residual refine rows ('refine')."""
        st = self._device_state()
        src = st["codes"] if route == "pq" else st["refine"]
        key = (route, id(src), src._version, id(st["local"]), self._scale)
        hit = self._caches.get(("bias", route))
        if hit is None or hit[0] != key:
            if route == "pq":
                bias = pq_row_bias(src, st["local"], st["codebooks"], st["centroid_tiles"],
                                   self.tile_n)
            else:
                bias = resid_row_bias(src, st["local"], st["centroid_tiles"], self._scale,
                                      self.tile_n)
            hit = (key, (src, st["local"]), bias)  # holds the tensors: their ids stay unique
            self._caches[("bias", route)] = hit
        return hit[2]

    def _have_tier2(self) -> bool:
        return (self._tier2_active and self.codebooks2 is not None
                and (self._codes2 is not None or bool(self._codes2_pending)))

    def _have_host(self) -> bool:
        return self._host_active and (self._host_rows is not None
                                      or bool(self._host_pending_rows))

    def _pq_stage_plan(self, k, refine_factor, n_pools, tq, p_tiles, top2=False):
        """(two_stage, k_cand, n_pools, l_buckets, k_stage1): the candidate
        budget (``pq_candidate_budget``) of this index. The int8 tier
        rescores inside the search (k_stage1 = k); pq2 and host receive the
        k_cand candidates."""
        two_stage = self.refine == "int8" or self._have_tier2() or self._have_host()
        k_cand, n_pools, l_buckets = pq_candidate_budget(
            k, refine_factor, n_pools, tq, p_tiles, top2, two_stage=two_stage, n=self._n,
            tile_n=self.tile_n)
        k_stage1 = k if self.refine == "int8" else (k_cand if two_stage else k)
        return two_stage, k_cand, n_pools, l_buckets, k_stage1

    def _host_tier_rescore(self, qp: torch.Tensor, v, gids, k: int) -> tuple:
        """The host tier's exact rescore of the candidates (v, gids) from the
        gid-keyed host store (``host_tier_rescore``)."""
        rows, assign = self._host_store()
        g = np.clip(gids.cpu().numpy().astype(np.int64), 0, rows.shape[0] - 1)
        l2 = self.metric == "l2"
        return host_tier_rescore(
            qp, v, gids, rows, assign, g, self._device_state()["centroids"], self._host_scale,
            self._host_row_sq() if l2 and self.residual else None, k=k, resid=self.residual,
            l2=l2, cache=self._caches)

    def _serve(self, qp: torch.Tensor, k: int, serve_from: str, refine_factor: int,
               p_tiles: int, tq: int, n_pools: int, top2: bool, flt, host_factor: int,
               host: bool):
        """(v, ids) on the device for the padded, rotated batch ``qp``: the
        route, then the refine tiers (``host``: the host tier too, else the
        cascade's on-card prefix)."""
        l2 = self.metric == "l2"
        row_mask = self._arena_filter(flt)[0] if flt is not None else None
        if serve_from == "refine":
            st = self._refine_scan_state()
            return _tiles_resid_plan_search(
                qp, st["centroids"], st["refine"], st["local"], st["centroid_tiles"],
                self._scale, st["ids"], st["tile_window"], st["refine_valid_end"],
                row_mask=row_mask, k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
                l2=l2, row_bias=self._row_bias("refine") if l2 else None)
        if serve_from != "pq":
            raise ValueError(f"unknown serve_from {serve_from!r}")
        st = self._device_state()
        two_stage, k_cand, n_pools, l_buckets, k_stage1 = self._pq_stage_plan(
            k, refine_factor, n_pools, tq, p_tiles, top2)
        if two_stage and not host and self._have_host() and not self._have_tier2():
            raise ValueError("refine='host' rescores from host memory: use search()")
        v, gids = _pq_tiles_plan_search(
            qp, st["centroids"], st["codes"], st["codebooks"], st["refine"], st["ids"],
            st["tile_window"], st["centroid_tiles"], self._n, st["local"], row_mask,
            k=k_stage1, k_cand=k_cand, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
            refine_scale=self._scale if self.refine == "int8" else 0.0, n_pools=n_pools,
            l_buckets=l_buckets, refine_residual=self._refine_residual, l2=l2, top2=top2,
            row_bias=self._row_bias("pq") if l2 else None, segments=self._seg_rows())
        have_host = host and self._have_host()
        if two_stage and self._have_tier2():
            # the cascade: tier 2 keeps a k·host_factor shortlist on the card
            k_mid = min(max(k * host_factor, k), k_cand) if have_host else k
            v, gids = _pq2_rescore(qp, v, gids, self._codes2_device(fold=False),
                                   self._codebooks2_dev(), self._s2_device() if l2 else None,
                                   k=k_mid, l2=l2)
            if have_host:
                v, gids = self._host_tier_rescore(qp, v, gids, k)
        elif two_stage and have_host:
            v, gids = self._host_tier_rescore(qp, v, gids, k)
        return v, gids

    def search(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
               refine_factor: int | None = None, n_pools: int = 0,
               tile_q: int | None = None, serve_from: str | None = None, where=None,
               top2: bool | None = None, host_factor: int | None = None):
        """Numpy in, numpy out: (scores (Q, k) f32, ids (Q, k) int64).
        Queries rotate on the host (numpy), as the reference's. Knobs left
        at their sentinels take the tuned op point, else the defaults:
        serve_from 'pq', refine_factor 16, host_factor 64, auto pools, the
        span-aware p_tiles. n_pools=0 sizes the pools to hold k·refine_factor
        candidates; serve_from='refine' scans the residual-int8 refine rows
        with K1 instead of PQ-decoding (module docstring). ``where``: an id
        predicate (``make_filter``); queries short of allowed rows return
        (-inf, -1) tails. Pending rows are scanned exactly and merged in."""
        assert self._n, "empty index"
        queries = np.asarray(queries, np.float32)
        with span(SEARCH):
            flt = self.make_filter(where) if where is not None else None
            v, gids = self._search_pq(queries, k, nprobe, p_tiles, refine_factor, n_pools,
                                      tile_q, serve_from, flt, top2, host_factor, host=True)
            return _answers_out(v, gids)

    def search_device(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
                      refine_factor: int | None = None, n_pools: int = 0,
                      tile_q: int | None = None, serve_from: str | None = None,
                      where=None, top2: bool | None = None):
        """All-device twin of ``search()``: a (B, D) f32 tensor in (rotated
        on the device in f32, TF32 off), (scores (B, k) f32, ids (B, k)
        int32) tensors out, no host transfer in the call once a filter's
        mask and the pending rows are staged. 'pq2+host' serves its on-card
        prefix (kernel and tier 2); refine='host' raises ValueError (its
        rows are in host memory: ``search()``)."""
        assert self._n, "empty index"
        with span(SEARCH):
            queries = self._rotate(
                torch.as_tensor(queries, dtype=torch.float32).to(self.device))
            flt = self.make_filter(where) if where is not None else None
            return self._search_pq(queries, k, nprobe, p_tiles, refine_factor, n_pools, tile_q,
                                   serve_from, flt, top2, None, host=False)

    def _search_pq(self, queries, k, nprobe, p_tiles, refine_factor, n_pools, tile_q,
                   serve_from, flt, top2, host_factor, host):
        """The body under ``search()`` and ``search_device()``: the knobs
        resolved (``_op_knobs``, ``_resolve_knobs``), the batch padded to
        the query tile, ``_serve``, pending rows merged in. ``host``:
        ``queries`` is search()'s numpy batch, rotated on the host and in
        through ``_queries_in``, and the host tier runs; else a device
        tensor, rotated already, padded in place. (v, gids) on the device,
        one row a query."""
        nq = queries.shape[0]
        kn = self._op_knobs(serve_from=serve_from, refine_factor=refine_factor, n_pools=n_pools,
                            host_factor=host_factor)
        p_tiles, tq, top2 = self._resolve_knobs(nq, nprobe, p_tiles, tile_q, top2)
        qp = (_queries_in(queries, tq, self.device, rotate=self.opq_matrix) if host
              else pad_rows(queries, tq))
        v, gids = self._serve(qp, k, p_tiles=p_tiles, tq=tq, top2=top2, flt=flt, host=host,
                              **kn)
        return self._merge_pending_topk(v[:nq], gids[:nq], qp[:nq], k, flt)

    # -- op-point tuning (eval/tune.py) -----------------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """With residual-int8 refine rows the direct refine scan goes first
        (its ladder alone); 'pq2+host' walks the cascade ladder (deep kernel
        candidate sets x the shortlist's width); otherwise the PQ route over
        coverage x refine depth, with top-2 offered where shadowing binds.
        Ordered by the reference's cost proxy."""
        can_refine_scan = self.refine == "int8" and self._refine_residual
        n_tiles = self._tune_n_tiles()
        out = []
        for tq in self._tune_tile_qs(nq):
            for p in coverage_ladder(self._auto_p_tiles(nq, 32, n_tiles, tile_q=tq), n_tiles):
                if can_refine_scan:
                    out.append({"p_tiles": p, "tile_q": tq, "serve_from": "refine"})
                elif self.refine == "pq2+host":
                    for rf in (64, 205, 410, 820):
                        for hf in (32, 102):
                            cfg = {"p_tiles": p, "tile_q": tq, "refine_factor": rf,
                                   "host_factor": hf}
                            out.append(cfg)
                            if rf >= 205:
                                out.append({**cfg, "top2": True})
                else:
                    two_stage = self.refine in ("int8", "pq2", "host")
                    for rf in ((16, 64, 102) if two_stage else (None,)):
                        cfg = {"p_tiles": p, "tile_q": tq}
                        if rf is not None:
                            cfg["refine_factor"] = rf
                        out.append(cfg)
                        if rf is not None and rf >= 64:
                            out.append({**cfg, "top2": True})
        seen = set()
        out = [c for c in out
               if (key := tuple(sorted(c.items()))) not in seen and not seen.add(key)]
        out.sort(key=lambda c: (c["p_tiles"] * (1 + c.get("refine_factor", 0) / 256.0)
                                * (1 + c.get("host_factor", 0) / 512.0)
                                * (1.02 if c.get("top2") else 1.0), -c["tile_q"]))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        n_tiles = self._tune_n_tiles()
        if self.refine == "int8" and self._refine_residual:
            return {"p_tiles": n_tiles, "serve_from": "refine"}
        kw = {"p_tiles": n_tiles}
        if self.refine in ("int8", "pq2", "host"):
            kw["refine_factor"] = 102  # ~1024 candidates at k=10
        elif self.refine == "pq2+host":
            kw["refine_factor"] = 820  # the cascade: deep candidates on the card,
            kw["host_factor"] = 102    # a wide shortlist through the host
        return kw

    # -- persistence ------------------------------------------------------------
    def _state_arrays(self) -> dict:
        self.merge_pending()  # one arena on disk
        out = {
            "centroids": self.centroids,
            "codebooks": self.codebooks,
            "codes_cm": to_numpy(self._codes),  # row-major (N_pad, m)
            "ids": self._ids,
            "offsets": self._offsets,
        }
        if self.refine == "int8":
            out["refine_rows"] = to_numpy(self._refine_rows)
        if self._tier2_active and (self._codes2 is not None or self._codes2_pending):
            out["codes2"] = to_numpy(self._codes2_device())
            out["codebooks2"] = self.codebooks2
            if self.metric == "l2":
                out["s2"] = to_numpy(self._s2_device())
        if self._have_host():
            out["host_rows"], out["host_assign"] = self._host_store()
        if self.opq_matrix is not None:
            out["opq_matrix"] = self.opq_matrix
        return out

    def _state_meta(self) -> dict:
        meta = super()._state_meta()
        meta.update({"m": self.m, "nbits": self.nbits, "refine": self.refine,
                     "pq_train_iters": self.pq_train_iters, "n_pad_rows": self._n_pad_rows,
                     "residual": self.residual, "aniso_eta": self.aniso_eta,
                     "refine_residual": self._refine_residual, "codes_row_major": True,
                     "m2": self.m2, "nbits2": self.nbits2, "host_scale": self._host_scale})
        return meta

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, device: str | torch.device = DEFAULT,
                   metric: str = "ip") -> "BandIVFPQIndex":
        """Index from the reference's numpy state: ``meta`` as its
        ``_state_meta()``, ``arrays`` as its ``_state_arrays()``, ``metric``
        as its ``metric``."""
        dim = int(np.asarray(arrays["centroids"]).shape[1])
        return cls._from_state({"dim": dim, "meta": meta, "metric": metric}, arrays,
                               device=device)

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "BandIVFPQIndex":
        """Load either package's artifact: the reference's host-build
        layout (code-major (m+1, N_pad), the local byte in row m), its
        device-build layout (row-major, the local byte derived from the
        offsets; a segmented arena is saved joined) and the port's
        (row-major); the tier stores with them."""
        meta = manifest["meta"]
        idx = cls(manifest["dim"], meta["nlist"], meta["m"], meta["nbits"], meta["refine"],
                  meta["pq_train_iters"], meta["kmeans_iters"], meta["seed"],
                  meta["tile_n"], meta["tile_q"], residual=meta.get("residual", False),
                  aniso_eta=meta.get("aniso_eta", 0.0), m2=meta.get("m2", 32),
                  nbits2=meta.get("nbits2", 8), metric=manifest.get("metric", "ip"),
                  device=device)
        idx._refine_residual = meta.get("refine_residual", False)
        idx._host_scale = float(meta.get("host_scale", 0.0))
        idx.centroids = np.array(arrays["centroids"], np.float32)
        idx.codebooks = np.array(arrays["codebooks"], np.float32)
        if "opq_matrix" in arrays:
            idx.opq_matrix = np.array(arrays["opq_matrix"], np.float32)
        if "codes2" in arrays:
            idx.codebooks2 = np.array(arrays["codebooks2"], np.float32)
            idx._codes2 = torch.from_numpy(np.array(arrays["codes2"], np.uint8)).to(idx.device)
            if "s2" in arrays:
                idx._s2 = torch.from_numpy(np.array(arrays["s2"], np.float32)).to(idx.device)
        if "host_rows" in arrays:
            idx._host_rows = np.array(arrays["host_rows"], np.int8)
            idx._host_assign = np.array(arrays["host_assign"], np.int32)
        idx._ids = np.array(arrays["ids"], np.int64)
        idx._offsets = np.array(arrays["offsets"], np.int64)
        idx._n = int(meta["n"])
        idx._n_pad_rows = int(meta["n_pad_rows"])
        idx._next_id = int(meta.get("next_id", 0))
        idx._tile_window = idx._compute_tile_window()
        cm = np.asarray(arrays["codes_cm"])
        local = None
        if meta.get("codes_row_major", False):
            rows = cm[:, : idx.m]
            if idx.residual:
                local = idx._local_from_offsets()
        else:
            rows = cm[: idx.m].T
            if idx.residual:
                local = np.array(cm[idx.m], np.uint8)
        codes = torch.from_numpy(np.array(rows, np.uint8, order="C")).to(idx.device)
        refine = torch.from_numpy(np.array(arrays["refine_rows"], np.int8)
                                  if "refine_rows" in arrays
                                  else np.zeros((1, idx.dim), np.int8)).to(idx.device)
        idx._install(codes, local, refine, float(meta["scale"]))
        return idx
