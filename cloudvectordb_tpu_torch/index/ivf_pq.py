"""IVF-PQ: coarse quantizer + per-list PQ codes (counterpart of
cloudvectordb_tpu/index/ivf_pq.py; BASELINE configs #3/#4).

Residual encoding stores each row as the PQ code of (x - its list
centroid); scoring inside a probe is ADC: per query a lookup table (m,
2**nbits) from one small f32 product (``_build_luts``), then one table
entry per sub-space and row, gathered and summed in f32. The centroid term
of a residual score is a per-(query, probe) constant:
  ip: q.x = q.c_l + q.r
  l2: -|q - x|^2 = -|q - c_l|^2 + 2 q.r - 2 c_l.r - |r|^2
The probe scan is IVF-Flat's (index/ivf_flat.py::_probe_scan): a step
gathers the codes of a few consecutive probe ranks, and the table gather
runs on a flattened (B, m*C) table with index j*C + code. With
``refine='int8'`` the scan returns refine_factor*k candidates, rescored
exactly in f32 (TF32 off) from a gid-keyed int8 store: the rotated
residuals (x_rot - centroid) on residual indexes, whole unrotated rows
otherwise (``_refine_rescore``). OPQ rotates rows and queries by
``opq_matrix`` first.

The quantizers come from outside where torch cannot reproduce the
reference's ``jax.random`` streams: ``train``/``build`` take
``centroids=`` and ``codebooks=``, the constructor ``opq_matrix=``.
Unfilled slots come back as (-inf, -1); the reference returns the id of
arena row 0 there (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.arena import ListArena, PendingBuffer, grow_scatter_gid
from cloudvectordb_tpu_torch.index.base import from_numpy
from cloudvectordb_tpu_torch.index.ivf_flat import (
    ListArenaIndex, _pad_k, _probe_scan, as_f32, probe_lists, rows_to_ids, unfilled)
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.index.pq import pq_encode, train_pq
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.topk import NEG_INF, f32_const, topk_stable
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device


def _build_luts(q: torch.Tensor, codebooks: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-query ADC lookup tables: q (B, D), codebooks (m, C, dsub) ->
    (B, m, C) f32, ``q_j . cb[j, c]`` for 'ip' and ``-|q_j - cb[j, c]|^2``
    for 'l2' (larger is better). On residual indexes the caller adds the
    probe's constant term."""
    m, _, dsub = codebooks.shape
    qs = q.float().reshape(q.shape[0], m, dsub)
    cb = codebooks.float()
    dots = torch.bmm(qs.transpose(0, 1), cb.transpose(1, 2)).transpose(0, 1)  # (B, m, C)
    if metric == "ip":
        return dots
    q_sq = (qs * qs).sum(dim=2)  # (B, m)
    c_sq = (cb * cb).sum(dim=2)  # (m, C)
    return 2.0 * dots - q_sq[:, :, None] - c_sq[None, :, :]


def _table_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of ``table[b, idx[b, ..., j]]``: table (B, T)
    flattened, idx (B, R, m) int64 -> (B, R) f32."""
    b, r, m = idx.shape
    return torch.gather(table, 1, idx.reshape(b, -1)).reshape(b, r, m).sum(dim=2)


def _ivfpq_scan_search(q, st: dict, *, k: int, nprobe: int, metric: str, residual: bool):
    """Probe-scan ADC search of one batch: (scores (B, k) f32, arena rows
    (B, k) int64, -1 where unfilled). Probes are chosen by l2 (the
    assignment metric); the ip coarse value is the residual ip score's
    constant term."""
    b = q.shape[0]
    codes, cb = st["codes"], st["codebooks"]
    m, c, _ = cb.shape
    lists = probe_lists(q, st["centroids"], nprobe)
    probed_c = st["centroids"][lists]  # (B, P, D)
    if metric == "ip":
        coarse = torch.bmm(probed_c, q[:, :, None])[:, :, 0]
    else:
        diff = q[:, None, :] - probed_c
        coarse = -(diff * diff).sum(dim=2)
    luts = _build_luts(q, cb, "ip").reshape(b, m * c)  # q.r lookups
    jc = torch.arange(m, device=q.device) * c
    c_sq = st["c_sq_codes"].reshape(1, m * c).expand(b, -1)  # |cb_j[code]|^2
    q_sq = (q * q).sum(dim=1)

    def score(g0, g1, rows, valid):
        g = g1 - g0
        idx = codes[rows].long() + jc  # (B, R, m): flat table index j*C + code
        q_dot_r = _table_sum(luts, idx)
        if residual and metric == "ip":
            s = (coarse[:, g0:g1, None] + q_dot_r.view(b, g, -1)).reshape(b, -1)
        elif residual:
            r_sq = _table_sum(c_sq, idx)
            cent = _build_luts(probed_c[:, g0:g1].reshape(b * g, -1), cb, "ip")
            rank = idx.view(b, g, -1, m) + (torch.arange(g, device=q.device) * (m * c))[
                None, :, None, None]
            c_dot_r = _table_sum(cent.reshape(b, g * m * c), rank.view(b, -1, m))
            s = (coarse[:, g0:g1, None] + 2.0 * q_dot_r.view(b, g, -1)).reshape(b, -1)
            s = s - 2.0 * c_dot_r - r_sq
        elif metric == "ip":
            s = q_dot_r
        else:
            s = 2.0 * q_dot_r - _table_sum(c_sq, idx) - q_sq[:, None]
        return torch.where(valid, s, NEG_INF)

    return _probe_scan(score, st["starts"][lists], st["lens"][lists], k, m)


def _refine_rescore(q_rot, q_raw, v, rows, st: dict, refine_scale: float, *, k: int,
                    metric: str, refine_residual: bool):
    """Exact rescore of the scan's candidates from the int8 store: (scores
    (B, k), arena rows (B, k), -1 where unfilled). ``rows`` are arena
    positions; the store is keyed by global id (ids[row]). Residual stores
    hold rotated residuals, scored with the exact centroid term (q.c of the
    candidate's list, found by a search over the arena offsets); whole-row
    stores hold unrotated rows, scored against the raw queries."""
    ids, store, cent = st["ids"], st["refine"], st["centroids"]
    valid = v > NEG_INF
    rows_c = rows.clamp(0, ids.shape[0] - 1)
    gid = ids[rows_c].clamp(0, store.shape[0] - 1)
    r8 = store[gid].float() * f32_const(refine_scale, q_rot)  # (B, kc, D)
    if refine_residual:
        assign = (torch.searchsorted(st["offsets_full"], rows_c, right=True) - 1).clamp(
            0, cent.shape[0] - 1)
        if metric == "ip":
            dots = q_rot @ cent.T
            ex = (torch.bmm(r8, q_rot[:, :, None])[:, :, 0]
                  + torch.gather(dots, 1, assign))
        else:
            diff = q_rot[:, None, :] - (cent[assign] + r8)
            ex = -(diff * diff).sum(dim=2)
    elif metric == "ip":
        ex = torch.bmm(r8, q_raw[:, :, None])[:, :, 0]
    else:
        diff = q_raw[:, None, :] - r8
        ex = -(diff * diff).sum(dim=2)
    ex = torch.where(valid, ex, NEG_INF)
    v2, pos = topk_stable(ex, min(k, ex.shape[1]))
    return _pad_k(v2, torch.where(v2 > NEG_INF, torch.gather(rows, 1, pos), -1), k)


class IVFPQIndex(ListArenaIndex):
    """``remove`` (ListArenaIndex's) leaves the refine store's rows of the
    removed ids in place: a removed id never surfaces as a candidate."""

    kind = "ivf_pq"

    def __init__(self, dim: int, nlist: int, m: int = 64, nbits: int = 8, metric: str = "ip",
                 residual: bool = True, kmeans_iters: int = 20, pq_train_iters: int = 12,
                 seed: int = 0, opq_matrix: np.ndarray | None = None, refine: str = "none",
                 device: str | torch.device = DEFAULT):
        """The reference's constructor with an explicit ``device``."""
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if refine not in ("none", "int8"):
            raise ValueError(f"unknown refine {refine!r}")
        if dim % m:
            raise ValueError(f"dim {dim} not divisible by m={m}")
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.m = m
        self.nbits = nbits
        self.residual = residual
        self.kmeans_iters = kmeans_iters
        self.pq_train_iters = pq_train_iters
        self.seed = seed
        self.device = as_device(device)
        self.centroids: np.ndarray | None = None
        self.codebooks: np.ndarray | None = None
        self.opq_matrix = None if opq_matrix is None else np.asarray(opq_matrix, np.float32)
        self._arena = ListArena(nlist, m, np.uint8)
        self._pending = PendingBuffer(m, np.uint8)
        # int8 refine store, keyed by global id: rotated residuals on
        # residual indexes (finer steps than whole rows), else unrotated rows
        self.refine = refine
        self._refine_residual = residual and refine == "int8"
        self._refine_rows = np.zeros((0, dim), np.int8)
        self._refine_scale = 1e-12
        self._next_id = 0
        self._dev = None

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None and self.codebooks is not None

    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        """Rows rotated by the OPQ matrix (x' = R x), f32 with TF32 off."""
        return x if self.opq_matrix is None else x @ as_f32(self.opq_matrix, self.device).T

    def train(self, sample, centroids: np.ndarray | None = None,
              codebooks: np.ndarray | None = None) -> None:
        """k-means on the (rotated) sample and PQ codebooks on its residuals
        (or on it, without ``residual``); ``centroids`` / ``codebooks``, when
        given, are taken as they are."""
        x = self._rotate(as_f32(sample, self.device)) if sample is not None else None
        if centroids is None:
            c, assign = train_kmeans(x, self.nlist, iters=self.kmeans_iters, seed=self.seed)
        else:
            c = as_f32(centroids, self.device)
            assign = assign_clusters(x, c)[0] if codebooks is None else None
        if codebooks is None:
            cb = train_pq(x - c[assign] if self.residual else x, self.m, self.nbits,
                          iters=self.pq_train_iters, seed=self.seed)
            codebooks = cb.cpu().numpy()
        self.centroids = c.cpu().numpy()
        self.codebooks = np.asarray(codebooks, np.float32)
        self._dev = None

    @classmethod
    def build(cls, vectors, nlist: int, m: int = 64, metric: str = "ip",
              train_sample: int = 262_144, centroids: np.ndarray | None = None,
              codebooks: np.ndarray | None = None, **kw) -> "IVFPQIndex":
        """Train on a seeded sample (or take the quantizers given), add
        every row, merge."""
        idx = cls(int(vectors.shape[1]), nlist, m=m, metric=metric, **kw)
        sample = None
        if centroids is None or codebooks is None:
            ns = min(train_sample, vectors.shape[0])
            rs = np.random.default_rng(idx.seed).choice(vectors.shape[0], ns, replace=False)
            sample = as_f32(vectors, idx.device)[torch.as_tensor(rs, device=idx.device)]
        idx.train(sample, centroids=centroids, codebooks=codebooks)
        idx.add(vectors)
        idx.merge_pending()
        return idx

    def add(self, vectors, ids=None) -> None:
        """Append vectors; ids default to a contiguous range (explicit ids
        let a caller assign global ids across indexes)."""
        assert self.is_trained, "call train() before add()"
        raw = as_f32(vectors, self.device)  # unrotated: the whole-row refine stores these
        x = self._rotate(raw)
        n = x.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
            self._next_id += n
        else:
            ids = np.asarray(ids, np.int64)
            self._next_id = max(self._next_id, int(ids.max(initial=-1)) + 1)
        cent = as_f32(self.centroids, self.device)
        assign, _ = assign_clusters(x, cent)
        enc = x - cent[assign] if self.residual else x
        codes = pq_encode(enc, as_f32(self.codebooks, self.device))
        if self.refine == "int8":
            self._store_refine(enc if self._refine_residual else raw, ids)
        self._pending.append(codes.cpu().numpy(), ids, assign.cpu().numpy())
        if self._pending.size > max(4096, 0.1 * self._arena.size):
            self.merge_pending()
        self._dev = None

    def _requantize(self, rows: np.ndarray, old_scale: float, new_scale: float) -> np.ndarray:
        """int8 rows at ``old_scale`` re-expressed at ``new_scale`` (on the
        device, in the reference's f32 arithmetic)."""
        r = from_numpy(rows, torch.int8).to(self.device).float()
        r = torch.clamp(torch.round(r * f32_const(old_scale / new_scale, r)), -127, 127)
        return r.to(torch.int8).cpu().numpy()

    def _store_refine(self, vectors: torch.Tensor, ids: np.ndarray) -> None:
        """Quantize rows into the gid-keyed int8 store under one scale (4
        rms, clipped to the batch's max), requantizing the store when a
        batch widens it; the arithmetic runs on the device."""
        rms = float(torch.sqrt(torch.mean(vectors.double() ** 2)))
        amax = float(vectors.abs().max()) if vectors.numel() else 0.0
        batch_scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
        if batch_scale > self._refine_scale and self._refine_rows.shape[0]:
            self._refine_rows = self._requantize(self._refine_rows, self._refine_scale,
                                                 batch_scale)
        self._refine_scale = max(self._refine_scale, batch_scale)
        hi = int(ids.max()) + 1
        if hi > self._refine_rows.shape[0]:
            grown = np.zeros((hi, self.dim), np.int8)
            grown[: self._refine_rows.shape[0]] = self._refine_rows
            self._refine_rows = grown
        q8 = torch.clamp(torch.round(vectors / f32_const(self._refine_scale, vectors)),
                         -127, 127)
        self._refine_rows[ids] = q8.to(torch.int8).cpu().numpy()

    def merge_from(self, other: "IVFPQIndex", id_offset: int | None = None) -> int:
        """Consolidate another IVF-PQ with the same quantizers into this one:
        its codes move verbatim (one re-sort), its int8 refine rows are
        requantized to the larger of the two scales and scattered under
        their (shifted) global ids. ``id_offset`` shifts ``other``'s ids;
        colliding ids are refused. Returns the number of rows merged in."""
        assert self.kind == other.kind and self.dim == other.dim
        assert self.metric == other.metric and self.m == other.m
        assert self.nbits == other.nbits and self.residual == other.residual
        assert self.refine == other.refine
        assert (self.opq_matrix is None) == (other.opq_matrix is None)
        np.testing.assert_allclose(self.centroids, other.centroids, atol=1e-6)
        np.testing.assert_allclose(self.codebooks, other.codebooks, atol=1e-6)
        if self.opq_matrix is not None:
            np.testing.assert_allclose(self.opq_matrix, other.opq_matrix, atol=1e-6)
        self.merge_pending()
        other.merge_pending()
        oa = other._arena
        codes_o = np.asarray(oa.payload)
        ids_o = np.asarray(oa.ids, np.int64)
        assign_o = np.repeat(np.arange(self.nlist), oa.list_lens)
        if id_offset is not None:
            ids_o = ids_o + int(id_offset)
        both = np.concatenate([np.asarray(self._arena.ids, np.int64), ids_o])
        uniq = np.unique(both)
        assert uniq.size == both.size, (
            f"{both.size - uniq.size} colliding global ids: pass "
            "id_offset=self._next_id (or any disjoint shift)")
        if self.refine == "int8" and other._refine_rows.shape[0]:
            # the larger scale wins: requantizing down would lose range
            s = max(self._refine_scale, other._refine_scale)
            if s > self._refine_scale and self._refine_rows.shape[0]:
                self._refine_rows = self._requantize(self._refine_rows, self._refine_scale, s)
            rows_o = other._refine_rows
            if s > other._refine_scale:
                rows_o = self._requantize(rows_o, other._refine_scale, s)
            self._refine_scale = s
            # other's store is keyed by its unshifted ids
            src = np.asarray(oa.ids, np.int64)
            self._refine_rows = grow_scatter_gid(self._refine_rows, rows_o[src], ids_o)
        self._arena.merge(codes_o, ids_o, assign_o)
        self._next_id = int(uniq[-1]) + 1 if uniq.size else 0
        self._dev = None
        return int(ids_o.shape[0])

    def _device_state(self) -> dict:
        if self._dev is None:
            ar, dev = self._arena, self.device
            cb = as_f32(self.codebooks, self.device)
            self._dev = dict(
                self._list_state(),
                codes=from_numpy(ar.payload, torch.uint8).to(dev),
                offsets_full=from_numpy(ar.offsets, torch.int64).to(dev),
                codebooks=cb,
                c_sq_codes=(cb * cb).sum(dim=2),
                refine=(from_numpy(self._refine_rows, torch.int8).to(dev)
                        if self.refine == "int8" else None),
            )
        return self._dev

    def search(self, queries, k: int, nprobe: int | None = None, batch: int = 256,
               refine_factor: int | None = None):
        """Numpy in, numpy out: (scores (Q, k) f32, ids (Q, k) int64), in
        batches of ``batch`` queries. With the int8 refine store the ADC
        scan retrieves refine_factor*k candidates (at least 32), rescored
        exactly. nprobe and refine_factor default to the tuned op point,
        else 8 and 16."""
        assert self.is_trained
        self.merge_pending()  # pending rows are codes: the simplest right path
        kn = self._op_knobs(nprobe=nprobe, refine_factor=refine_factor)
        nprobe = min(kn["nprobe"], self.nlist)
        do_refine = self.refine == "int8" and self._refine_rows.shape[0]
        kk = min(max(k * kn["refine_factor"], 32), self.ntotal) if do_refine else k
        st = self._device_state()

        def scan(q_raw):
            if not self._arena.size:
                return unfilled(q_raw.shape[0], k, self.device)
            q = self._rotate(q_raw)
            v, rows = _ivfpq_scan_search(q, st, k=kk, nprobe=nprobe, metric=self.metric,
                                         residual=self.residual)
            if do_refine:
                v, rows = _refine_rescore(q, q_raw, v, rows, st, self._refine_scale, k=k,
                                          metric=self.metric,
                                          refine_residual=self._refine_residual)
            return v, rows_to_ids(rows, st["ids"])

        return self._batched(queries, batch, scan)

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """nprobe ladder x refine depth, cheapest first: cost ~ nprobe (the
        scan) + rf*k (the rescore)."""
        rfs = (16, 64) if self.refine == "int8" else (None,)
        out, p = [], 1
        while p < self.nlist:
            for rf in rfs:
                out.append({"nprobe": p} if rf is None else {"nprobe": p, "refine_factor": rf})
            p *= 2
        for rf in rfs:
            out.append({"nprobe": self.nlist} if rf is None
                       else {"nprobe": self.nlist, "refine_factor": rf})
        out.sort(key=lambda c: c["nprobe"] * (1 + c.get("refine_factor", 0) / 64.0))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        # full probe and deep refine: the index's recall ceiling
        kw = {"nprobe": self.nlist}
        if self.refine == "int8":
            kw["refine_factor"] = 64
        return kw

    def reconstruct(self, ids) -> np.ndarray:
        """Rows in the original space for global ids: from the int8 refine
        store when there is one (residual rows get their list centroid
        back), else the PQ decode; OPQ output un-rotated."""
        self.merge_pending()
        ids = np.asarray(ids)
        ar = self._arena
        pos = np.full(max(self._next_id, int(ar.ids.max(initial=-1)) + 1), -1, np.int64)
        pos[ar.ids] = np.arange(ar.size)
        rows = pos[ids]
        if not (rows >= 0).all():
            raise KeyError("unknown (removed?) id")
        lists = np.searchsorted(ar.offsets, rows, side="right") - 1
        rotated = True  # whether `out` is in the rotated space
        if self.refine == "int8" and self._refine_rows.shape[0]:
            out = self._refine_rows[ids].astype(np.float32) * np.float32(self._refine_scale)
            if self._refine_residual:
                out = out + self.centroids[lists]
            else:
                rotated = False  # the whole-row store is unrotated
        else:
            codes = np.asarray(ar.payload)[rows]
            out = np.concatenate([self.codebooks[j][codes[:, j]] for j in range(self.m)],
                                 axis=1)
            if self.residual:
                out = out + self.centroids[lists]
        if self.opq_matrix is not None and rotated:
            out = out @ self.opq_matrix  # rotated -> original
        return out

    # -- persistence ------------------------------------------------------
    def _state_arrays(self) -> dict:
        out = dict(self._arena_arrays(), codebooks=self.codebooks)
        if self.opq_matrix is not None:
            out["opq_matrix"] = self.opq_matrix
        if self.refine == "int8":
            out["refine_rows"] = self._refine_rows
        return out

    def _state_meta(self) -> dict:
        return {"nlist": self.nlist, "m": self.m, "nbits": self.nbits,
                "residual": self.residual, "kmeans_iters": self.kmeans_iters,
                "pq_train_iters": self.pq_train_iters, "seed": self.seed,
                "next_id": self._next_id, "opq": self.opq_matrix is not None,
                "refine": self.refine, "refine_scale": self._refine_scale,
                "refine_residual": self._refine_residual}

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "IVFPQIndex":
        m = manifest["meta"]
        idx = cls(manifest["dim"], m["nlist"], m["m"], m["nbits"], manifest["metric"],
                  m["residual"], m["kmeans_iters"], m["pq_train_iters"], m["seed"],
                  opq_matrix=arrays.get("opq_matrix"), refine=m.get("refine", "none"),
                  device=device)
        if "refine_rows" in arrays:
            idx._refine_rows = np.asarray(arrays["refine_rows"])
            idx._refine_scale = m.get("refine_scale", 1e-12)
        # artifacts from before residual refine stored whole rows
        idx._refine_residual = m.get("refine_residual", False)
        idx.codebooks = np.asarray(arrays["codebooks"], np.float32)
        idx._load_arena(arrays, m)
        return idx
