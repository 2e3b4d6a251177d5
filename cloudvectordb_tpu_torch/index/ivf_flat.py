"""IVF-Flat: coarse quantizer + raw-vector lists (counterpart of
cloudvectordb_tpu/index/ivf_flat.py; BASELINE config #2).

Build: k-means (or the caller's ``centroids=``) -> assign every vector ->
list-sorted host arena (index/arena.py::ListArena), copied to the index's
device as f32. Search, per batch of queries: the coarse top-nprobe lists by
l2 (the metric that assigned the rows), then the probe scan
(``_probe_scan``): each step gathers the windows of a few consecutive probe
ranks, scores them exactly in f32 (TF32 off), and merges a stable top-k of
the step into the running one, so ties resolve as the reference's
per-probe ``lax.scan`` does (earlier probe, then lower window position).
The reference sizes every window by the arena's longest list, a static
shape for XLA; here a step's window is the longest list it probes, which
changes no result. ``add`` appends to the host pending buffer, scanned
exactly at query time and merged into the arena past a fraction of it.

Unfilled slots (the probed lists and pending rows hold fewer than k rows)
come back as (-inf, -1), the convention of every other family. The
reference returns id 0 there (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.arena import ListArena, PendingBuffer, normalize_remove_ids
from cloudvectordb_tpu_torch.index.base import Index, from_numpy
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.topk import NEG_INF, merge_topk, tiled_topk, topk_stable
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device

MERGE_FRACTION = 0.1  # merge pending into the arena beyond this fraction
#: elements (rows x row width) one probe step may gather: a step takes as
#: many consecutive probe ranks as fit, and at least one
PROBE_STEP_ELEMS = 1 << 27


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or a tensor) as an f32 tensor on ``device``."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = np.array(x)  # torch takes no read-only (memory-mapped, JAX) buffer
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def probe_lists(q: torch.Tensor, centroids: torch.Tensor, nprobe: int) -> torch.Tensor:
    """(B, nprobe) int64 lists each query probes, nearest first by l2 (the
    assignment metric; ties to the lower list)."""
    _, lists = tiled_topk(centroids, q, nprobe, metric="l2",
                          tile=min(8192, centroids.shape[0]))
    return lists


def _probe_groups(lens_p: np.ndarray, row_elems: int, budget: int) -> list[tuple]:
    """Consecutive probe ranks [(g0, g1, cap)], each group's window ``cap``
    the longest list its ranks probe over the batch, with (g1 - g0) x cap x
    ``row_elems`` within ``budget`` unless the group is one rank."""
    caps = np.maximum(lens_p.max(axis=0, initial=0), 1)
    groups, g0, n = [], 0, lens_p.shape[1]
    while g0 < n:
        cap, g1 = int(caps[g0]), g0 + 1
        while g1 < n and (g1 + 1 - g0) * max(cap, int(caps[g1])) * row_elems <= budget:
            cap = max(cap, int(caps[g1]))
            g1 += 1
        groups.append((g0, g1, cap))
        g0 = g1
    return groups


def _pad_k(v: torch.Tensor, r: torch.Tensor, k: int):
    """(B, kk) slots padded to k with (-inf, -1)."""
    pad = k - v.shape[1]
    if pad <= 0:
        return v, r
    return (torch.cat([v, v.new_full((v.shape[0], pad), NEG_INF)], dim=1),
            torch.cat([r, r.new_full((r.shape[0], pad), -1)], dim=1))


def _probe_scan(score, starts: torch.Tensor, lens_p: torch.Tensor, k: int, row_width: int):
    """Top-k over the probed lists' rows: (scores (B, k) f32, arena rows
    (B, k) int64, -1 where unfilled). ``starts``/``lens_p`` (B, P) give
    each probe's arena window; ``score(g0, g1, rows, valid)`` scores the
    (B, R) arena rows of probe ranks g0..g1-1 (R = (g1 - g0) x cap, rank
    by rank, ``valid`` False past a list's end) and masks the invalid ones
    to -inf. A step's stable top-k runs over its ranks in order and merges
    after the earlier steps' (which win ties): the reference's per-probe
    top-k and merge_topk give the same order."""
    b = starts.shape[0]
    dev = starts.device
    best_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_r = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for g0, g1, cap in _probe_groups(lens_p.cpu().numpy(), b * row_width, PROBE_STEP_ELEMS):
        w = torch.arange(cap, device=dev)
        valid = (w < lens_p[:, g0:g1, None]).reshape(b, -1)
        rows = torch.where(valid, (starts[:, g0:g1, None] + w).reshape(b, -1), 0)
        s = score(g0, g1, rows, valid)
        tv, tp = topk_stable(s, min(k, s.shape[1]))
        tr = torch.where(tv > NEG_INF, torch.gather(rows, 1, tp), -1)
        best_v, best_r = merge_topk(best_v, best_r, tv, tr, k)
    return best_v, best_r


def rows_to_ids(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Arena rows -> global ids, -1 staying -1."""
    return torch.where(rows >= 0, ids[rows.clamp_min(0)], -1)


def unfilled(b: int, k: int, device: torch.device):
    """(B, k) slots holding nothing: (-inf, -1)."""
    return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
            torch.full((b, k), -1, dtype=torch.int64, device=device))


class ListArenaIndex(Index):
    """What the probe-scan families share: a coarse quantizer
    (``centroids``), a list-sorted host arena (``_arena``) and a host
    pending buffer (``_pending``) of their payload rows, global ids from
    ``_next_id``, and device copies (``_dev``) dropped when rows move."""

    @property
    def ntotal(self) -> int:
        return self._arena.size + self._pending.size

    def merge_pending(self) -> None:
        """Merge the pending rows into the arena (one re-sort). The device
        copies are dropped only when rows moved: the reference drops them on
        every call, and its IVF-PQ ``search`` calls this first."""
        p, i, a = self._pending.drain()
        if p.shape[0]:
            self._arena.merge(p, i, a)
            self._dev = None

    def remove(self, ids) -> int:
        """Delete rows by global id: pending chunks filter in place, the
        arena compacts by one boolean-mask pass. Returns the number
        removed; unknown ids are ignored; freed ids are never reused."""
        req = normalize_remove_ids(ids)
        if req.size == 0:
            return 0
        n_rem, _ = self._pending.remove_ids(req)
        n_rem += self._arena.remove_ids(req)
        if n_rem:
            self._dev = None
        return n_rem

    def _list_state(self) -> dict:
        """Device copies of the coarse quantizer and the arena's layout:
        centroids, ids, each list's start and length."""
        ar, dev = self._arena, self.device
        return dict(centroids=as_f32(self.centroids, dev),
                    ids=from_numpy(ar.ids, torch.int64).to(dev),
                    starts=from_numpy(ar.offsets[:-1], torch.int64).to(dev),
                    lens=from_numpy(ar.list_lens, torch.int64).to(dev))

    def _batched(self, queries, batch: int, scan):
        """Numpy queries in batches of ``batch``, each scanned by
        ``scan(q)`` (q (B, D) f32 on the device -> (scores, ids) (B, k)):
        (scores (Q, k) f32, ids (Q, k) int64) as numpy."""
        queries = np.asarray(queries, np.float32)
        outs_v, outs_i = [], []
        for s in range(0, queries.shape[0], batch):
            v, i = scan(as_f32(queries[s:s + batch], self.device))
            outs_v.append(v.cpu().numpy())
            outs_i.append(i.cpu().numpy())
        return np.concatenate(outs_v), np.concatenate(outs_i)

    def _arena_arrays(self) -> dict:
        self.merge_pending()
        return {"centroids": self.centroids, "payload": self._arena.payload,
                "ids": self._arena.ids, "offsets": self._arena.offsets}

    def _load_arena(self, arrays: dict, meta: dict) -> None:
        self.centroids = np.asarray(arrays["centroids"], np.float32)
        self._arena.payload = np.asarray(arrays["payload"])
        self._arena.ids = np.asarray(arrays["ids"], np.int64)
        self._arena.offsets = np.asarray(arrays["offsets"], np.int64)
        self._next_id = meta["next_id"]


class IVFFlatIndex(ListArenaIndex):
    kind = "ivf_flat"

    def __init__(self, dim: int, nlist: int, metric: str = "ip", dtype: str = "float32",
                 kmeans_iters: int = 20, seed: int = 0,
                 device: str | torch.device = DEFAULT):
        """The reference's constructor with an explicit ``device``."""
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.dtype = dtype
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.device = as_device(device)
        self.centroids: np.ndarray | None = None
        self._arena = ListArena(
            nlist, dim, np.dtype(dtype).type if dtype != "bfloat16" else np.float32)
        self._pending = PendingBuffer(dim, np.float32)
        self._next_id = 0
        self._dev = None  # device copies of the arena, built on first search

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def train(self, sample, centroids: np.ndarray | None = None) -> None:
        """Fit the coarse quantizer on a sample, or take ``centroids`` as it
        (parity tests give both packages the same ones)."""
        if centroids is None:
            c, _ = train_kmeans(as_f32(sample, self.device), self.nlist,
                                iters=self.kmeans_iters, seed=self.seed)
            centroids = c.cpu().numpy()
        self.centroids = np.asarray(centroids, np.float32)
        self._dev = None

    @classmethod
    def build(cls, vectors, nlist: int, metric: str = "ip", train_sample: int = 262_144,
              centroids: np.ndarray | None = None, **kw) -> "IVFFlatIndex":
        """Train on a seeded sample (or take ``centroids``), add every row,
        merge."""
        idx = cls(int(vectors.shape[1]), nlist, metric=metric, **kw)
        if centroids is None:
            ns = min(train_sample, vectors.shape[0])
            rs = np.random.default_rng(idx.seed).choice(vectors.shape[0], ns, replace=False)
            idx.train(as_f32(vectors, idx.device)[torch.as_tensor(rs, device=idx.device)])
        else:
            idx.train(None, centroids=centroids)
        idx.add(vectors)
        idx.merge_pending()
        return idx

    def _assign(self, x: torch.Tensor) -> np.ndarray:
        a, _ = assign_clusters(x, as_f32(self.centroids, self.device))
        return a.cpu().numpy()

    def add(self, vectors) -> None:
        assert self.is_trained, "call train() before add()"
        x = as_f32(vectors, self.device)
        n = x.shape[0]
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        self._pending.append(x.cpu().numpy(), ids, self._assign(x))
        if self._pending.size > max(4096, MERGE_FRACTION * self._arena.size):
            self.merge_pending()

    def _device_state(self) -> dict:
        if self._dev is None:
            vecs = from_numpy(self._arena.payload, torch.float32).to(self.device)
            self._dev = dict(self._list_state(), vecs=vecs,
                             sqnorms=(vecs * vecs).sum(dim=1) if self.metric == "l2" else None)
        return self._dev

    def _scan(self, q: torch.Tensor, st: dict, k: int, nprobe: int):
        """The probe scan of one batch: (scores, ids) (B, k)."""
        lists = probe_lists(q, st["centroids"], nprobe)
        q_sq = (q * q).sum(dim=1)

        def score(g0, g1, rows, valid):
            dots = torch.bmm(st["vecs"][rows], q[:, :, None])[:, :, 0]
            s = dots if self.metric == "ip" else (
                2.0 * dots - st["sqnorms"][rows] - q_sq[:, None])
            return torch.where(valid, s, NEG_INF)

        v, rows = _probe_scan(score, st["starts"][lists], st["lens"][lists], k, self.dim)
        return v, rows_to_ids(rows, st["ids"])

    def _pending_topk(self, q: torch.Tensor, k: int):
        """Exact top-k over the pending rows, or None: the reference's flat
        scan (tiled_topk), unfilled slots (-inf, -1)."""
        snap = self._pending.snapshot()
        if snap is None:
            return None
        pv, pi = snap
        fv, fpos = tiled_topk(as_f32(pv, self.device), q, min(k, pv.shape[0]),
                              metric=self.metric, tile=max(256, min(8192, pv.shape[0])))
        return _pad_k(fv, torch.as_tensor(pi, device=self.device)[fpos], k)

    def search(self, queries, k: int, nprobe: int | None = None, batch: int = 256):
        """Numpy in, numpy out: (scores (Q, k) f32, ids (Q, k) int64), in
        batches of ``batch`` queries. nprobe defaults to the tuned op point,
        else 8."""
        assert self.is_trained
        nprobe = min(self._op_knobs(nprobe=nprobe)["nprobe"], self.nlist)
        st = self._device_state()

        def scan(q):
            v, i = (self._scan(q, st, k, nprobe) if self._arena.size
                    else unfilled(q.shape[0], k, self.device))
            pend = self._pending_topk(q, k)
            return (v, i) if pend is None else merge_topk(v, i, *pend, k)

        return self._batched(queries, batch, scan)

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        p, out = 1, []
        while p < self.nlist:
            out.append({"nprobe": p})
            p *= 2
        out.append({"nprobe": self.nlist})
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        return {"nprobe": self.nlist}  # the exhaustive scan: the recall ceiling

    # -- persistence ------------------------------------------------------
    def _state_arrays(self) -> dict:
        return self._arena_arrays()

    def _state_meta(self) -> dict:
        return {"nlist": self.nlist, "dtype": self.dtype, "kmeans_iters": self.kmeans_iters,
                "seed": self.seed, "next_id": self._next_id}

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "IVFFlatIndex":
        m = manifest["meta"]
        idx = cls(manifest["dim"], m["nlist"], manifest["metric"], m["dtype"],
                  m["kmeans_iters"], m["seed"], device=device)
        idx._load_arena(arrays, m)
        return idx
