"""Sharded IVF-PQ over a mesh, BASELINE config #4 as the reference first
built it (counterpart of cloudvectordb_tpu/parallel/dist_ivf.py:
``ShardedIVFPQIndex``).

The coarse quantizer and the PQ codebooks are trained once on a global
sample (or given) and shared; the rows partition across the shard slots,
each shard an ``IVFPQIndex`` with its own list-sorted code arena on its
slot's device and global ids in its arena. A search runs each held shard's
probe scan (index/ivf_pq.py::_ivfpq_scan_search, ADC by gathers: plain
torch ops, as the reference's scan is XLA), with the int8 refine
(``_refine_rescore``) on the shard before the merge, and merges the
partials in shard order (parallel/mesh.py::merge_partials): the recall of
one IVF-PQ index with the same nprobe, every shard probing its own part of
the same lists.

The int8 refine rows live in the wrapper, per shard in insertion order and
keyed by global id, and are permuted into the shard's arena order when the
shard is staged (arena order changes with every merge); the shards
themselves carry no refine store. Unfilled slots are (-inf, -1); the
reference returns the id of a shard's arena row 0 there (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.eval.tune import TunableMixin
from cloudvectordb_tpu_torch.index.base import pad_rows
from cloudvectordb_tpu_torch.index.ivf_flat import _pad_k, as_f32, rows_to_ids, unfilled
from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex, _ivfpq_scan_search, _refine_rescore
from cloudvectordb_tpu_torch.index.pq import pq_encode
from cloudvectordb_tpu_torch.index.range import RangeSearchMixin
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.topk import f32_const
from cloudvectordb_tpu_torch.parallel.mesh import (
    Mesh, assert_equal_across_processes, fetch_local, gather_shard_meta, make_mesh,
    merge_partials, replica_slices, stage_queries, stage_replicated)
from cloudvectordb_tpu_torch.parallel.persist import (
    load_extras, load_shards, read_sharded_manifest, save_sharded)
from cloudvectordb_tpu_torch.utils.device import DEFAULT


def _refine_scale(src: torch.Tensor, f64: bool) -> float:
    """The int8 refine scale of rows ``src``: 4 rms clipped to the max,
    over 127 (the rms summed in f64 on a host build, in f32 on a stream's
    first chunk, as the reference)."""
    x = src.double() if f64 else src
    rms = float(torch.sqrt(torch.mean(x * x)))
    amax = float(src.abs().max())
    return max(min(amax, 4.0 * rms) / 127.0, 1e-12)


class ShardedIVFPQIndex(TunableMixin, RangeSearchMixin):
    """Row-partitioned IVF-PQ with shared quantizers. With several processes
    every process makes the same calls with the same arguments; each holds
    only the shards (and their refine rows) of its mesh slots."""

    kind = "sharded_ivf_pq"

    def __init__(self, mesh: Mesh | None = None, refine: str = "none", **ivfpq_kw):
        if "device" in ivfpq_kw:
            raise ValueError("shard devices come from the mesh (make_mesh(devices=...))")
        if refine not in ("none", "int8"):
            raise ValueError(f"unknown refine {refine!r}")
        ivfpq_kw.pop("refine", None)  # the refine rows live in the wrapper
        if ivfpq_kw.pop("opq_matrix", None) is not None:
            raise ValueError("ShardedIVFPQIndex does not rotate (no OPQ)")
        self.mesh = mesh or make_mesh()
        self.kw = ivfpq_kw
        self.refine = refine
        self.metric = ivfpq_kw.get("metric", "ip")
        self.residual = ivfpq_kw.get("residual", True)
        # residual refine: the rows are int8 residuals (x - list centroid),
        # the centroid term exact at rescore
        self._refine_residual = self.residual and refine == "int8"
        self._shards: list[IVFPQIndex | None] = []
        self._meta: list[dict] = []
        self._refine_rows_ins: list[list[np.ndarray]] = []
        self._refine_gids_ins: list[list[np.ndarray]] = []
        self._refine_scale = 0.0
        self._next_id = 0
        self._dev: dict = {}  # (replica, shard) -> (shard on that device, refine state)

    @property
    def nshards(self) -> int:
        return self.mesh.n_shard

    @property
    def ntotal(self) -> int:
        return sum(m["ntotal"] for m in self._meta)

    @property
    def device(self) -> torch.device:
        return self.mesh.local_devices()[0]

    def _new_shard(self, dim: int, si: int) -> IVFPQIndex:
        return IVFPQIndex(dim, **self.kw, device=self.mesh.shard_device(si))

    def _refine_src(self, x: torch.Tensor, centroids: np.ndarray) -> torch.Tensor:
        """Residuals of ``x`` against their assigned list centroid: the
        residual refine store's rows."""
        cdev = as_f32(centroids, x.device)
        a, _ = assign_clusters(x, cdev)
        return x - cdev[a]

    def _quantize_refine(self, src: torch.Tensor) -> np.ndarray:
        q8 = torch.clamp(torch.round(src / f32_const(self._refine_scale, src)), -127, 127)
        return q8.to(torch.int8).cpu().numpy()

    # -- build ------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, m: int = 64, mesh: Mesh | None = None,
              train_sample: int = 262_144, centroids: np.ndarray | None = None,
              codebooks: np.ndarray | None = None, **kw) -> "ShardedIVFPQIndex":
        """Shared quantizers from a seeded global sample (or ``centroids`` and
        ``codebooks``), then shard si takes rows [N·si/S, N·(si+1)/S) under
        their global ids, with their int8 refine rows."""
        vectors = np.asarray(vectors, np.float32)
        idx = cls(mesh, nlist=nlist, m=m, **kw)
        s, dim, dev = idx.nshards, vectors.shape[1], idx.device
        proto = IVFPQIndex(dim, **idx.kw, device=dev)
        ns = min(train_sample, vectors.shape[0])
        sel = np.random.default_rng(proto.seed).choice(vectors.shape[0], ns, replace=False)
        sample = torch.from_numpy(vectors[sel]).to(dev)
        proto.train(sample, centroids=centroids, codebooks=codebooks)
        if idx.refine == "int8":
            if idx._refine_residual:
                idx._refine_scale = _refine_scale(idx._refine_src(sample, proto.centroids), True)
            else:
                idx._refine_scale = _refine_scale(torch.from_numpy(vectors), True)
        bounds = np.linspace(0, vectors.shape[0], s + 1).astype(int)
        idx._shards = [None] * s
        idx._refine_rows_ins = [[] for _ in range(s)]
        idx._refine_gids_ins = [[] for _ in range(s)]
        for si in range(s):
            if not idx.mesh.holds(si):
                continue
            sub = idx._new_shard(dim, si)
            sub.centroids, sub.codebooks = proto.centroids, proto.codebooks
            block = torch.from_numpy(vectors[bounds[si]:bounds[si + 1]]).to(sub.device)
            gids = np.arange(bounds[si], bounds[si + 1], dtype=np.int64)
            sub.add(block, ids=gids)
            sub.merge_pending()
            idx._shards[si] = sub
            if idx.refine == "int8":
                src = idx._refine_src(block, proto.centroids) if idx._refine_residual else block
                idx._refine_rows_ins[si].append(idx._quantize_refine(src))
                idx._refine_gids_ins[si].append(gids)
        idx._next_id = int(vectors.shape[0])
        idx._refresh_meta()
        return idx

    @classmethod
    def build_streaming(cls, chunks, nlist: int, m: int = 64, mesh: Mesh | None = None,
                        train_sample: int = 262_144, centroids: np.ndarray | None = None,
                        codebooks: np.ndarray | None = None, **kw) -> "ShardedIVFPQIndex":
        """Build from a chunk iterator: the quantizers train on the first
        chunk (unless given), every chunk is assigned and PQ-encoded on the
        device, and only its m-byte codes (and int8 refine rows) reach the
        host, split across the shards (``np.array_split``) under global ids
        in stream order. The f32 corpus never exists in one piece."""
        idx = cls(mesh, nlist=nlist, m=m, **kw)
        s, dev = idx.nshards, idx.device
        proto = None
        acc: list[list] = [[] for _ in range(s)]
        idx._refine_rows_ins = [[] for _ in range(s)]
        idx._refine_gids_ins = [[] for _ in range(s)]
        next_id = 0
        for chunk in chunks:
            chunk = torch.as_tensor(chunk, dtype=torch.float32).to(dev)
            if proto is None:
                proto = IVFPQIndex(int(chunk.shape[1]), **idx.kw, device=dev)
                proto.train(chunk[:min(train_sample, chunk.shape[0])], centroids=centroids,
                            codebooks=codebooks)
                cdev, cbdev = as_f32(proto.centroids, dev), as_f32(proto.codebooks, dev)
            a, _ = assign_clusters(chunk, cdev)
            enc_in = chunk - cdev[a] if idx.residual else chunk
            codes_h, a_h = pq_encode(enc_in, cbdev).cpu().numpy(), a.cpu().numpy()
            rows8_h = None
            if idx.refine == "int8":
                rsrc = enc_in if idx._refine_residual else chunk
                if idx._refine_scale == 0.0:  # the first chunk sets the scale
                    idx._refine_scale = _refine_scale(rsrc, False)
                rows8_h = idx._quantize_refine(rsrc)
            b = codes_h.shape[0]
            ids_h = np.arange(next_id, next_id + b, dtype=np.int64)
            next_id += b
            for si, sl in enumerate(np.array_split(np.arange(b), s)):
                if not sl.size or not idx.mesh.holds(si):
                    continue
                acc[si].append((codes_h[sl], a_h[sl], ids_h[sl]))
                if rows8_h is not None:
                    idx._refine_rows_ins[si].append(rows8_h[sl])
                    idx._refine_gids_ins[si].append(ids_h[sl])
        if proto is None:
            raise ValueError("empty stream")
        idx._shards = [None] * s
        for si in range(s):
            if not idx.mesh.holds(si):
                continue
            if not acc[si]:
                raise ValueError(f"shard {si} received no rows")
            sub = idx._new_shard(proto.dim, si)
            sub.centroids, sub.codebooks = proto.centroids, proto.codebooks
            codes, assigns, gids = (np.concatenate(c) for c in zip(*acc[si]))
            sub._arena.rebuild(codes, gids, assigns)
            sub._next_id = next_id
            idx._shards[si] = sub
        idx._next_id = next_id
        idx._refresh_meta()
        return idx

    def _refresh_meta(self) -> None:
        self._meta = gather_shard_meta(
            {si: dict(ntotal=sh.ntotal, n_refine=sum(r.shape[0] for r in self._refine_rows_ins[si]))
             for si, sh in enumerate(self._shards) if sh is not None}, self.mesh)
        self._dev = {}

    # -- mutation ---------------------------------------------------------
    def add(self, vectors) -> np.ndarray:
        """Append to the smallest shard under global ids (returned); with
        refine, the batch's int8 rows join that shard's insertion-order
        store (at the build's scale: rows past it clip)."""
        vectors = np.asarray(vectors, np.float32)
        si = int(np.argmin([m["ntotal"] for m in self._meta]))
        n = vectors.shape[0]
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        sh = self._shards[si]
        if sh is not None:
            x = torch.from_numpy(vectors).to(sh.device)
            sh.add(x, ids=ids)
            sh.merge_pending()
            if self.refine == "int8":
                src = self._refine_src(x, sh.centroids) if self._refine_residual else x
                self._refine_rows_ins[si].append(self._quantize_refine(src))
                self._refine_gids_ins[si].append(ids)
        self._refresh_meta()
        return ids

    def remove(self, ids) -> int:
        """Delete by global id: each shard compacts the ids it holds (unknown
        ids are ignored). The refine store keeps the removed ids' rows,
        which the arena-order permutation never looks up. Freed ids are
        never reused."""
        before = self.ntotal
        for sh in self._shards:
            if sh is not None:
                sh.remove(ids)
        self._refresh_meta()
        return before - self.ntotal

    def _refine_arena_order(self, si: int) -> np.ndarray:
        """Shard si's int8 refine rows permuted into its current arena order
        (the store is keyed by global id)."""
        rows = np.concatenate(self._refine_rows_ins[si])
        gids = np.concatenate(self._refine_gids_ins[si])
        sort_idx = np.argsort(gids, kind="stable")
        pos = sort_idx[np.searchsorted(gids[sort_idx], self._shards[si]._arena.ids)]
        return rows[pos]

    def _staged(self, r: int, si: int):
        """(shard on slot (r, si)'s device, its refine state or None): the
        state ``_refine_rescore`` reads, the arena-ordered rows keyed by
        arena row (an identity id table)."""
        if (r, si) not in self._dev:
            sh = self._shards[si]
            sh.merge_pending()
            dev = self.mesh.slot_device(r, si)
            if dev != sh.device:
                sh = IVFPQIndex._from_state(
                    {"meta": sh._state_meta(), "dim": sh.dim, "metric": sh.metric},
                    sh._state_arrays(), device=dev)
            rst = None
            if self.refine == "int8" and self._refine_rows_ins[si]:
                st = sh._device_state()
                rows = torch.as_tensor(self._refine_arena_order(si), device=dev)
                rst = dict(ids=torch.arange(rows.shape[0], device=dev), refine=rows,
                           centroids=st["centroids"], offsets_full=st["offsets_full"])
            self._dev[(r, si)] = (sh, rst)
        return self._dev[(r, si)]

    # -- search -----------------------------------------------------------
    def _serve(self, qb: np.ndarray, k: int, k_cand: int, nprobe: int, do_refine: bool):
        outs = []
        for r, sl in replica_slices(self.mesh, qb.shape[0]):
            parts, q_on = [], stage_replicated(qb[sl], self.mesh)
            for r2, si, _ in self.mesh.local_slots():
                if r2 != r:
                    continue
                sh, rst = self._staged(r, si)
                q = q_on[sh.device]
                if not sh._arena.size:
                    parts.append(unfilled(q.shape[0], k, sh.device))
                    continue
                st = sh._device_state()
                v, rows = _ivfpq_scan_search(q, st, k=k_cand, nprobe=nprobe, metric=self.metric,
                                             residual=self.residual)
                if do_refine and rst is not None:
                    # a range-escalated k can exceed k_cand (capped at the
                    # largest shard): rescore what exists, pad back to k
                    v, rows = _refine_rescore(q, q, v, rows, rst, self._refine_scale,
                                              k=min(k, k_cand), metric=self.metric,
                                              refine_residual=self._refine_residual)
                    v, rows = _pad_k(v, rows, k)
                else:
                    v, rows = _pad_k(v[:, :k], rows[:, :k], k)
                parts.append((v, rows_to_ids(rows, st["ids"])))
            outs.append(merge_partials(parts, k, self.mesh))
        return (np.concatenate([fetch_local(v) for v, _ in outs]),
                np.concatenate([fetch_local(i) for _, i in outs]))

    def search(self, queries, k: int, nprobe: int | None = None, batch: int = 256,
               refine_factor: int | None = None):
        """Numpy in, numpy out: (scores (Q, k) f32, ids (Q, k) int64), in
        batches of ``batch`` queries. nprobe and refine_factor default to the
        tuned op point, else 8 and 16; with refine rows each shard's scan
        keeps refine_factor·k candidates (at least 32, at most the largest
        shard's rows), rescored exactly before the merge."""
        queries = np.asarray(queries, np.float32)
        kn = self._op_knobs(nprobe=nprobe, refine_factor=refine_factor)
        nprobe = min(kn["nprobe"], self.kw["nlist"])
        do_refine = self.refine == "int8" and sum(m["n_refine"] for m in self._meta) > 0
        per_shard = max(m["ntotal"] for m in self._meta)
        k_cand = min(max(k * kn["refine_factor"], 32), per_shard) if do_refine else k
        # the batch loop's length and every knob that shapes a collective
        # must match across processes before the first collective
        assert_equal_across_processes((queries.shape[0], k, k_cand, nprobe, batch),
                                      "sharded IVF-PQ search batch", self.mesh)
        n_rep = self.mesh.n_replica if self.mesh.nproc == 1 else 1
        outs_v, outs_i = [], []
        for s0 in range(0, queries.shape[0], batch):
            qh = queries[s0:s0 + batch]
            real = qh.shape[0]
            qh = pad_rows(qh, n_rep)  # every replica's slice equal-sized
            v, i = self._serve(stage_queries(qh, self.mesh), k, k_cand, nprobe, do_refine)
            outs_v.append(v[:real])
            outs_i.append(i[:real])
        return np.concatenate(outs_v), np.concatenate(outs_i).astype(np.int64)

    # -- op-point tuning: the single index's ladder (same knobs, same
    # nlist and refine config)
    def _ladder_proto(self) -> IVFPQIndex:
        sh = next(s for s in self._shards if s is not None)
        return IVFPQIndex(sh.dim, **self.kw, refine=self.refine, device=sh.device)

    def _tune_candidates(self, nq: int) -> list[dict]:
        return self._ladder_proto()._tune_candidates(nq)

    def _tune_reference_kw(self, nq: int) -> dict:
        return self._ladder_proto()._tune_reference_kw(nq)

    # -- persistence ------------------------------------------------------
    def save(self, path, extra_meta: dict | None = None) -> None:
        """One atomic directory: the shards' IVF-PQ artifacts and the
        wrapper's insertion-order refine stores (rows and their global
        ids). Needs every shard in this process."""
        if any(sh is None for sh in self._shards):
            raise ValueError("save() needs every shard in this process")
        extras = None
        if self.refine == "int8":
            extras = {"refine_rows": [np.concatenate(c) if c else None
                                      for c in self._refine_rows_ins],
                      "refine_gids": [np.concatenate(c) if c else None
                                      for c in self._refine_gids_ins]}
        save_sharded(path, {"kind": self.kind, "kw": self.kw, "refine": self.refine,
                            "refine_scale": self._refine_scale, "next_id": self._next_id,
                            "op_point": self._op_point, **(extra_meta or {})},
                     self._shards, extras_per_shard=extras)

    @classmethod
    def load(cls, path, mesh: Mesh | None = None, mmap: bool = True,
             device=DEFAULT) -> "ShardedIVFPQIndex":
        """The wrapper from a saved artifact, each held shard on its slot's
        device; a mesh of another shard count reshards (``_do_reshard``)."""
        man = read_sharded_manifest(path)
        if man["kind"] != cls.kind:
            raise ValueError(f"{path} holds a {man['kind']!r} index")
        s_saved = man["nshards"]
        mesh = mesh or make_mesh(s_saved, devices=[device])
        idx = cls(mesh, refine=man["refine"], **man.get("kw", {}))
        reshard = idx.nshards != s_saved
        if reshard and mesh.nproc > 1:
            raise ValueError("resharding loads every shard: one process")
        # a reshard loads every saved shard onto this process's first device
        devs = [idx.device if reshard else mesh.shard_device(si) if mesh.holds(si) else None
                for si in range(s_saved)]
        idx._shards = load_shards(path, man, devs, mmap=mmap)
        for sh in idx._shards:  # the wrapper's store is the one searched
            if sh is not None and sh.refine != "none":
                sh.refine, sh._refine_residual = "none", False
                sh._refine_rows = np.zeros((0, sh.dim), np.int8)
        idx._refine_scale = man["refine_scale"]
        idx._next_id = man["next_id"]
        rows = load_extras(path, man, "refine_rows", mmap=mmap) or [None] * s_saved
        gids = load_extras(path, man, "refine_gids", mmap=mmap) or [None] * s_saved
        idx._refine_rows_ins = [[np.asarray(r)] if r is not None else [] for r in rows]
        idx._refine_gids_ins = [[np.asarray(g)] if g is not None else [] for g in gids]
        if reshard:
            idx._do_reshard()
        idx._refresh_meta()
        if man.get("op_point"):
            idx._op_point = dict(man["op_point"])
        return idx

    def _do_reshard(self) -> None:
        """Re-partition the loaded shards onto this mesh's shard count: every
        shard's PQ codes export once and move verbatim (the quantizers are
        shared), the rows sort by global id and split contiguously, each
        new shard runs one arena sort, and the refine store re-splits by
        membership in each new shard (rows of removed ids drop out)."""
        codes_l, gids_l, asg_l = [], [], []
        for sh in self._shards:
            sh.merge_pending()
            ar = sh._arena
            codes_l.append(np.asarray(ar.payload))
            gids_l.append(np.asarray(ar.ids, np.int64))
            asg_l.append(np.repeat(np.arange(sh.nlist), ar.list_lens))
        codes, gid = np.concatenate(codes_l), np.concatenate(gids_l)
        assign = np.concatenate(asg_l).astype(np.int32)
        order = np.argsort(gid, kind="stable")
        codes, gid, assign = codes[order], gid[order], assign[order]
        proto = self._shards[0]
        if self.refine == "int8":
            r_all = np.concatenate([np.concatenate(c) for c in self._refine_rows_ins if c])
            g_all = np.concatenate([np.concatenate(c) for c in self._refine_gids_ins if c])
        bounds = np.linspace(0, gid.shape[0], self.nshards + 1).astype(int)
        shards, rows_ins, gids_ins = [], [], []
        for si in range(self.nshards):
            lo, hi = bounds[si], bounds[si + 1]
            if hi <= lo:
                raise ValueError(f"reshard to {self.nshards}: shard {si} would be empty")
            sub = self._new_shard(proto.dim, si)
            sub.centroids = np.asarray(proto.centroids)
            sub.codebooks = np.asarray(proto.codebooks)
            sub._arena.merge(codes[lo:hi], gid[lo:hi], assign[lo:hi])
            sub._next_id = self._next_id
            shards.append(sub)
            if self.refine == "int8":
                keep = np.isin(g_all, gid[lo:hi])
                rows_ins.append([r_all[keep]])
                gids_ins.append([g_all[keep]])
            else:
                rows_ins.append([])
                gids_ins.append([])
        self._shards, self._refine_rows_ins, self._refine_gids_ins = shards, rows_ins, gids_ins
