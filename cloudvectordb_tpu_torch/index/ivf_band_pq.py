"""Tile-pruned PQ index with int8 refinement (counterpart of
cloudvectordb_tpu/index/ivf_band.py:2146-4004, ``BandIVFPQIndex``; the
registry names it ``band_ivf_pq``).

PQ codes are the memory format (m bytes a row), the tile table prunes the
decode to each query tile's probed lists (K5, ops/pq.py), and an int8
refine store re-ranks the candidates exactly. BASELINE config #3
(10M×768, nlist 4096, m 64, nbits 8, OPQ, refine 'int8') is
``build_device_streaming``'s path. Two serving routes share one build:
``serve_from='pq'`` (K5, then the int8 rescore, ``_pq_tiles_core``) and
``serve_from='refine'`` (the residual-int8 refine rows scanned directly by
K1, which the tuner prefers when they exist).

The port keeps one code layout: row-major (N_pad, m) uint8 codes and a
separate (N_pad,) uint8 local-list byte in residual mode. (The reference
keeps code-major (m+1, N_pad) codes for host builds and segments large
row-major arenas, both for the TPU's lanes and DMA descriptors; either
layout loads here.) Its ``_fit_tile_n_to_skew`` keeps tile_n a multiple of
128, which the reference does not (ADVICE.md r5).

Not ported yet, each raising NotImplementedError (ROADMAP queue 1 item 13):
refine tiers 'pq2', 'host' and 'pq2+host' (and ``attach_host_refine``), the
mutation surface (``add``, ``remove``, ``merge_pending``, ``merge_from``,
``reconstruct``; the pending buffer it inherits stays empty),
``build_streaming``, filters (``where=``), ``metric='l2'`` and anisotropic
codebooks (``aniso_eta > 1``).
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.base import to_numpy
from cloudvectordb_tpu_torch.index.ivf_band import (
    BandIVFIndex, _next_pow2, _pq_tiles_plan_search, _tiles_resid_plan_search)
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.index.opq import train_opq
from cloudvectordb_tpu_torch.index.pq import pq_encode, train_pq
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.band import order_centroids
from cloudvectordb_tpu_torch.ops.topk import f32_const
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device

_LATER = "arrives with the rest of the PQ-tiles family (ROADMAP queue 1 item 13)"
_REFINES = ("none", "int8", "pq2", "host", "pq2+host")


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


class BandIVFPQIndex(BandIVFIndex):
    kind = "band_ivf_pq"

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
        """The reference's constructor with an explicit ``device``. What it
        refuses raises ValueError; what the port has not ported raises
        NotImplementedError (module docstring)."""
        if refine not in _REFINES:
            raise ValueError(f"unknown refine {refine!r}")
        if dim % m or dim % m2:
            raise ValueError(f"dim {dim} not divisible by m={m} / m2={m2}")
        if refine not in ("none", "int8"):
            raise NotImplementedError(f"refine={refine!r} {_LATER}")
        if metric == "l2":
            raise NotImplementedError(f"metric='l2' {_LATER}")
        if aniso_eta > 1.0:
            raise NotImplementedError(f"anisotropic codebooks (aniso_eta > 1) {_LATER}")
        super().__init__(dim, nlist, dtype="int8", kmeans_iters=kmeans_iters, seed=seed,
                         tile_n=tile_n, tile_q=tile_q, metric=metric, device=device)
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
        self._codes: torch.Tensor | None = None  # (N_pad, m) uint8, arena order
        self._local: torch.Tensor | None = None  # (N_pad,) uint8 local list byte
        self._refine_rows: torch.Tensor | None = None  # (N_pad, dim) int8 or (1, dim)
        self._n_pad_rows = 0
        self._opq_dev = None

    # -- quantizers ---------------------------------------------------------
    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        """x' = x @ Rᵀ on the device in f32 (TF32 off by the package's
        policy: the reference's Precision.HIGHEST); x itself without OPQ."""
        if self.opq_matrix is None:
            return x
        if self._opq_dev is None:
            self._opq_dev = torch.as_tensor(self.opq_matrix, device=self.device)
        return x @ self._opq_dev.T

    def _train_quantizers(self, tr: torch.Tensor, centroids, codebooks) -> torch.Tensor:
        """Coarse centroids (in band order) and PQ codebooks from the rotated
        training rows ``tr``, each skipped when given. Returns the rows the
        codebooks are trained on (residuals in residual mode)."""
        if centroids is None:
            c, _ = train_kmeans(tr, self.nlist, iters=self.kmeans_iters, seed=self.seed)
            c = c.cpu().numpy()
            centroids = c[order_centroids(c)]
        self.centroids = np.array(centroids, np.float32)
        train_vecs = tr
        if self.residual:
            cdev = torch.as_tensor(self.centroids, device=self.device)
            a, _ = assign_clusters(tr, cdev)
            train_vecs = tr - cdev[a]
        if codebooks is None:
            codebooks = train_pq(train_vecs, self.m, self.nbits, iters=self.pq_train_iters,
                                 seed=self.seed).cpu().numpy()
        self.codebooks = np.array(codebooks, np.float32)
        return train_vecs

    def _train_opq(self, sample: torch.Tensor) -> None:
        r, _ = train_opq(sample[: min(int(sample.shape[0]), 65536)], self.m, self.nbits,
                         outer_iters=4, pq_iters=5, seed=self.seed)
        self.opq_matrix = r

    @classmethod
    def train_proto(cls, sample, nlist: int, m: int = 64, opq: bool = False,
                    centroids: np.ndarray | None = None,
                    codebooks: np.ndarray | None = None, **kw) -> "BandIVFPQIndex":
        """Every quantizer (OPQ rotation, coarse centroids in band order, PQ
        codebooks) trained on ``sample``, or taken as given: the empty
        trained index."""
        idx = cls(int(sample.shape[1]), nlist, m=m, **kw)
        sample = torch.as_tensor(sample, dtype=torch.float32).to(idx.device)
        if opq and idx.opq_matrix is None:
            idx._train_opq(sample)
        idx._train_quantizers(idx._rotate(sample), centroids, codebooks)
        return idx

    # -- build ----------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, m: int = 64, train_sample: int = 262_144,
              opq: bool = False, centroids: np.ndarray | None = None,
              codebooks: np.ndarray | None = None, **kw) -> "BandIVFPQIndex":
        """Build from (N, D) vectors. The training sample is the reference's
        numpy draw (``ivf_band.py:2603-2604``). ``centroids``
        (locality-ordered), ``codebooks`` and ``opq_matrix`` (a constructor
        keyword), when given, skip their training."""
        dev = as_device(kw.get("device", DEFAULT))
        x = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
        ns = min(train_sample, x.shape[0])
        sel = np.sort(np.random.default_rng(kw.get("seed", 0)).choice(
            x.shape[0], ns, replace=False))
        idx = cls.train_proto(x[torch.as_tensor(sel, device=dev)], nlist, m=m, opq=opq,
                              centroids=centroids, codebooks=codebooks, **kw)
        idx._populate(idx._rotate(x))
        return idx

    def _populate(self, x: torch.Tensor) -> None:
        """Arena from rotated rows: list order, codes, local bytes, refine
        rows (the scale from every row)."""
        cdev = torch.as_tensor(self.centroids, device=self.device)
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
        enc = xs - cdev[a[order_d]] if self.residual else xs
        codes = torch.zeros((n_pad, self.m), dtype=torch.uint8, device=self.device)
        codes[:n] = pq_encode(enc, self._codebooks_dev())
        refine = torch.zeros((1, self.dim), dtype=torch.int8, device=self.device)
        scale = 0.0
        if self.refine == "int8":
            src = enc if self._refine_residual else xs
            scale = _int8_scale(src)
            refine = torch.zeros((n_pad, self.dim), dtype=torch.int8, device=self.device)
            refine[:n] = _quantize(src, scale)
        self._ids = order.astype(np.int64)
        self._install(codes, self._local_from_offsets() if self.residual else None,
                      refine, scale)

    @classmethod
    def build_device_streaming(
        cls, chunk_fn, n_chunks: int, nlist: int, m: int = 64,
        train_sample: int = 262_144, opq: bool = False,
        centroids: np.ndarray | None = None, codebooks: np.ndarray | None = None, **kw,
    ) -> "BandIVFPQIndex":
        """Device-resident build, BASELINE config #3's path: the codes and
        refine rows are written into arenas on the device and only the (N,)
        assignments reach the host. ``chunk_fn(i) -> (n_i, D)`` must be
        deterministic: pass 1 trains OPQ, the coarse quantizer and the PQ
        codebooks on the first chunk and assigns every chunk; pass 2
        re-produces each chunk, encodes it and scatters its codes and refine
        rows to their host-sorted positions. The refine scale comes from the
        first chunk (its training residuals in residual mode)."""
        from cloudvectordb_tpu_torch.utils.native import arena_sort

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
                train_vecs = idx._train_quantizers(tr[:ns], centroids, codebooks)
                cdev = torch.as_tensor(idx.centroids, device=idx.device)
                if idx.refine == "int8":  # Python-float arithmetic, as the reference's
                    src = train_vecs if idx._refine_residual else tr
                    rms = float(torch.sqrt(torch.mean(src * src)))
                    amax = float(torch.max(torch.abs(src)))
                    idx._scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
                train_vecs = src = None
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
        cb = idx._codebooks_dev()
        base = 0
        for ci in range(n_chunks):
            tr = idx._rotate(torch.as_tensor(chunk_fn(ci), dtype=torch.float32).to(idx.device))
            d = torch.as_tensor(dest[base : base + sizes[ci]], device=idx.device)
            enc = tr
            if idx.residual:
                enc = tr - cdev[torch.as_tensor(assigns[ci], device=idx.device).long()]
            # the reference's donated scatters (``.at[d].set``) become
            # in-place writes into the preallocated arenas
            codes[d] = pq_encode(enc, cb)
            if do_refine:
                refine[d] = _quantize(enc if idx._refine_residual else tr, idx._scale)
            base += sizes[ci]
            tr = enc = d = None
        if not do_refine:
            idx._scale = 0.0
        idx._install(codes, idx._local_from_offsets() if idx.residual else None, refine,
                     idx._scale)
        return idx

    def _local_from_offsets(self) -> np.ndarray:
        """(N_pad,) uint8 local list byte of every arena row: its list minus
        the first list of its tile's window."""
        tw = self._tile_window
        if tw.shape[1] > 256:
            raise ValueError(
                f"per-tile window W={tw.shape[1]} overflows the uint8 local byte even "
                "at the tile_n floor: rebuild with a smaller nlist")
        assigns = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
        local = np.zeros(self._n_pad_rows, np.uint8)
        local[: self._n] = assigns - tw[np.arange(self._n) // self.tile_n, 0]
        return local

    def _install(self, codes: torch.Tensor, local: np.ndarray | None,
                 refine: torch.Tensor, scale: float) -> None:
        self._codes = codes
        self._payload = codes  # the base class reads its row count
        self._local = None if local is None else torch.as_tensor(local, device=self.device)
        self._centroid_tiles = (np.ascontiguousarray(self.centroids[self._tile_window])
                                if self.residual else None)
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

    def _tune_n_tiles(self) -> int:
        return self._n_pad_rows // self.tile_n

    def _codebooks_dev(self) -> torch.Tensor:
        return torch.as_tensor(self.codebooks, dtype=torch.float32, device=self.device)

    # -- unported surface -----------------------------------------------------
    def add(self, vectors, ids=None) -> None:
        raise NotImplementedError(f"add() {_LATER}")

    def remove(self, ids) -> int:
        raise NotImplementedError(f"remove() {_LATER}")

    def merge_pending(self) -> None:
        raise NotImplementedError(f"merge_pending() {_LATER}")

    def merge_from(self, other, id_offset=None) -> int:
        raise NotImplementedError(f"merge_from() {_LATER}")

    def reconstruct(self, ids) -> np.ndarray:
        raise NotImplementedError(f"reconstruct() {_LATER}")

    @classmethod
    def build_streaming(cls, chunks, nlist: int, **kw) -> "BandIVFPQIndex":
        raise NotImplementedError(f"build_streaming() {_LATER}")

    def attach_host_refine(self, host_chunk_fn, n_chunks: int, **kw) -> None:
        raise NotImplementedError(f"attach_host_refine() (the host refine tier) {_LATER}")

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
                centroid_tiles=(None if self._centroid_tiles is None else torch.as_tensor(
                    self._centroid_tiles, device=dev).to(torch.bfloat16)),
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

    def _derive_l_buckets(self, k_cand: int, n_pools: int) -> int:
        """Bucket count for a candidate budget: the next power of two of
        ceil(k_cand / n_pools), floored at 128, that divides tile_n."""
        l_buckets = min(self.tile_n, max(128, _next_pow2(-(-k_cand // n_pools))))
        while self.tile_n % l_buckets != 0 and l_buckets < self.tile_n:
            l_buckets *= 2
        l_buckets = min(l_buckets, self.tile_n)
        if self.tile_n % l_buckets != 0:
            l_buckets = self.tile_n
        return l_buckets

    def _resolve_pq_knobs(self, nq, nprobe, p_tiles, tile_q, refine_factor, n_pools,
                          serve_from, top2=None):
        """Tuned op-point fills for knobs left at their sentinels, the
        small-batch query-tile shrink, and the span-aware auto coverage."""
        op = self._op_point or {}
        if serve_from is None:
            serve_from = op.get("serve_from", "pq")
        if refine_factor is None:
            refine_factor = op.get("refine_factor", 16)
        if p_tiles <= 0:
            p_tiles = op.get("p_tiles", 0)
        if tile_q is None:
            tile_q = op.get("tile_q")
        if n_pools <= 0:
            n_pools = op.get("n_pools", 0)
        if top2 is None:
            top2 = bool(op.get("top2", False))
        tq = tile_q or self.tile_q
        if tile_q is None and nq < tq:
            tq = max(8, _next_pow2(nq))
        if p_tiles <= 0:
            p_tiles = self._auto_p_tiles(nq, nprobe, self._tune_n_tiles(), tile_q=tq)
        return serve_from, refine_factor, p_tiles, tq, n_pools, top2

    def _pq_stage_plan(self, k, refine_factor, n_pools, tq, p_tiles, top2=False):
        """Candidate budget (the reference's, number for number):
        (two_stage, k_cand, n_pools, l_buckets, k_stage1). With refine rows
        the kernel returns k·refine_factor candidates (at least 32) for the
        rescore; auto pools (n_pools <= 0) hold them within a slot budget
        that shrinks with the query tile; top2 doubles each pool's slots."""
        two_stage = self.refine == "int8"
        k_cand = min(max(k * refine_factor, 32), self._n) if two_stage else k
        slot_budget = max(min(262_144 // tq, 8192), self.tile_n)
        mult = 2 if top2 else 1
        if n_pools <= 0:
            n_pools = max(1, min(-(-k_cand // (mult * self.tile_n)),
                                 max(slot_budget // (mult * self.tile_n), 1), p_tiles))
        l_buckets = self._derive_l_buckets(k_cand, mult * n_pools)
        k_cand = min(k_cand, mult * n_pools * l_buckets)
        return two_stage, k_cand, n_pools, l_buckets, k

    def _serve(self, qp: torch.Tensor, k: int, serve_from: str, refine_factor: int,
               p_tiles: int, tq: int, n_pools: int, top2: bool):
        """(v, ids) on the device for the padded, rotated batch ``qp``."""
        if serve_from == "refine":
            st = self._refine_scan_state()
            return _tiles_resid_plan_search(
                qp, st["centroids"], st["refine"], st["local"], st["centroid_tiles"],
                self._scale, st["ids"], st["tile_window"], st["refine_valid_end"],
                k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq)
        if serve_from != "pq":
            raise ValueError(f"unknown serve_from {serve_from!r}")
        st = self._device_state()
        _, k_cand, n_pools, l_buckets, k_stage1 = self._pq_stage_plan(
            k, refine_factor, n_pools, tq, p_tiles, top2)
        return _pq_tiles_plan_search(
            qp, st["centroids"], st["codes"], st["codebooks"], st["refine"], st["ids"],
            st["tile_window"], st["centroid_tiles"], self._n, st["local"],
            k=k_stage1, k_cand=k_cand, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
            refine_scale=self._scale if self.refine == "int8" else 0.0, n_pools=n_pools,
            l_buckets=l_buckets, refine_residual=self._refine_residual, top2=top2)

    def search(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
               refine_factor: int | None = None, n_pools: int = 0,
               tile_q: int | None = None, serve_from: str | None = None, where=None,
               top2: bool | None = None):
        """Numpy in, numpy out: (scores (Q, k) f32, ids (Q, k) int64).
        Queries rotate on the host (numpy), as the reference's. Knobs left
        at their sentinels take the tuned op point, else the defaults:
        serve_from 'pq', refine_factor 16, auto pools, the span-aware
        p_tiles. n_pools=0 sizes the pools to hold k·refine_factor
        candidates; serve_from='refine' scans the residual-int8 refine rows
        with K1 instead of PQ-decoding (module docstring)."""
        if where is not None:
            raise NotImplementedError(f"filtered search (where=) {_LATER}")
        assert self._n, "empty index"
        queries = np.asarray(queries, np.float32)
        if self.opq_matrix is not None:
            queries = queries @ self.opq_matrix.T
        nq = queries.shape[0]
        serve_from, refine_factor, p_tiles, tq, n_pools, top2 = self._resolve_pq_knobs(
            nq, nprobe, p_tiles, tile_q, refine_factor, n_pools, serve_from, top2)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)])
        v, gids = self._serve(torch.as_tensor(qp, device=self.device), k, serve_from,
                              refine_factor, p_tiles, tq, n_pools, top2)
        return v[:nq].cpu().numpy(), gids[:nq].cpu().numpy().astype(np.int64)

    def search_device(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
                      refine_factor: int | None = None, n_pools: int = 0,
                      tile_q: int | None = None, serve_from: str | None = None,
                      where=None, top2: bool | None = None):
        """All-device twin of ``search()``: a (B, D) f32 tensor in (rotated
        on the device in f32, TF32 off), (scores (B, k) f32, ids (B, k)
        int32) tensors out, no host transfer in the call."""
        if where is not None:
            raise NotImplementedError(f"filtered search (where=) {_LATER}")
        assert self._n, "empty index"
        queries = self._rotate(torch.as_tensor(queries, dtype=torch.float32).to(self.device))
        nq = queries.shape[0]
        serve_from, refine_factor, p_tiles, tq, n_pools, top2 = self._resolve_pq_knobs(
            nq, nprobe, p_tiles, tile_q, refine_factor, n_pools, serve_from, top2)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else torch.cat(
            [queries, queries[-1:].expand(q_pad - nq, -1)])
        v, gids = self._serve(qp, k, serve_from, refine_factor, p_tiles, tq, n_pools, top2)
        return v[:nq], gids[:nq]

    # -- op-point tuning (eval/tune.py) -----------------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """With residual-int8 refine rows the direct refine scan goes first
        (its ladder alone); otherwise the PQ route over coverage x refine
        depth, with top-2 offered where shadowing binds (refine_factor >=
        64). Ordered by the reference's cost proxy."""
        can_refine_scan = self.refine == "int8" and self._refine_residual
        n_tiles = self._tune_n_tiles()
        out = []
        for tq in self._tune_tile_qs(nq):
            base = self._auto_p_tiles(nq, 32, n_tiles, tile_q=tq)
            for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
                p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
                if can_refine_scan:
                    out.append({"p_tiles": p, "tile_q": tq, "serve_from": "refine"})
                else:
                    two_stage = self.refine == "int8"
                    for rf in ((16, 64, 102) if two_stage else (None,)):
                        cfg = {"p_tiles": p, "tile_q": tq}
                        if rf is not None:
                            cfg["refine_factor"] = rf
                        out.append(cfg)
                        if rf is not None and rf >= 64:
                            out.append({**cfg, "top2": True})
                if p >= n_tiles:
                    break
        seen = set()
        out = [c for c in out
               if (key := tuple(sorted(c.items()))) not in seen and not seen.add(key)]
        out.sort(key=lambda c: (c["p_tiles"] * (1 + c.get("refine_factor", 0) / 256.0)
                                * (1.02 if c.get("top2") else 1.0), -c["tile_q"]))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        n_tiles = self._tune_n_tiles()
        if self.refine == "int8" and self._refine_residual:
            return {"p_tiles": n_tiles, "serve_from": "refine"}
        kw = {"p_tiles": n_tiles}
        if self.refine == "int8":
            kw["refine_factor"] = 102  # ~1024 candidates at k=10
        return kw

    # -- persistence ------------------------------------------------------------
    def _state_arrays(self) -> dict:
        out = {
            "centroids": self.centroids,
            "codebooks": self.codebooks,
            "codes_cm": to_numpy(self._codes),  # row-major (N_pad, m)
            "ids": self._ids,
            "offsets": self._offsets,
        }
        if self.refine == "int8":
            out["refine_rows"] = to_numpy(self._refine_rows)
        if self.opq_matrix is not None:
            out["opq_matrix"] = self.opq_matrix
        return out

    def _state_meta(self) -> dict:
        meta = super()._state_meta()
        meta.update({"m": self.m, "nbits": self.nbits, "refine": self.refine,
                     "pq_train_iters": self.pq_train_iters, "n_pad_rows": self._n_pad_rows,
                     "residual": self.residual, "aniso_eta": self.aniso_eta,
                     "refine_residual": self._refine_residual, "codes_row_major": True,
                     "m2": self.m2, "nbits2": self.nbits2, "host_scale": 0.0})
        return meta

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, device: str | torch.device = DEFAULT
                   ) -> "BandIVFPQIndex":
        """Index from the reference's numpy state: ``meta`` as its
        ``_state_meta()``, ``arrays`` as its ``_state_arrays()``."""
        dim = int(np.asarray(arrays["centroids"]).shape[1])
        return cls._from_state({"dim": dim, "meta": meta}, arrays, device=device)

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "BandIVFPQIndex":
        """Load either package's artifact: the reference's host-build
        layout (code-major (m+1, N_pad), the local byte in row m), its
        device-build layout (row-major, the local byte derived from the
        offsets) and the port's (row-major)."""
        if manifest.get("metric", "ip") != "ip":
            raise NotImplementedError(f"metric='l2' {_LATER}")
        meta = manifest["meta"]
        idx = cls(manifest["dim"], meta["nlist"], meta["m"], meta["nbits"], meta["refine"],
                  meta["pq_train_iters"], meta["kmeans_iters"], meta["seed"],
                  meta["tile_n"], meta["tile_q"], residual=meta.get("residual", False),
                  aniso_eta=meta.get("aniso_eta", 0.0), m2=meta.get("m2", 32),
                  nbits2=meta.get("nbits2", 8), device=device)
        idx._refine_residual = meta.get("refine_residual", False)
        idx.centroids = np.array(arrays["centroids"], np.float32)
        idx.codebooks = np.array(arrays["codebooks"], np.float32)
        if "opq_matrix" in arrays:
            idx.opq_matrix = np.array(arrays["opq_matrix"], np.float32)
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
