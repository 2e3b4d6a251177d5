"""Sharded tile-pruned serving index, BASELINE config #4's fast path
(counterpart of cloudvectordb_tpu/parallel/dist_band.py:
``ShardedBandIndex``).

Rows partition across the mesh's shard slots, contiguously by row for
``build`` and chunk by chunk for ``build_streaming``; the coarse quantizer
is shared (trained once, or given by ``centroids=``). Each shard is the
port's own ``BandIVFIndex`` on its slot's device, and a search runs every
held shard's own plan and kernel (K1 on residual-int8 arenas, K3 on whole
int8 rows) and merges the partial top-k in shard order
(parallel/mesh.py::merge_partials).

Differences from the reference, none of which a caller of ``search`` sees
at full tile coverage:
- One global dequant scale, the largest shard scale, as the reference's.
  The reference keeps each shard at its own scale and requantizes a staged
  copy; here each shard's arena is requantized in place once (the same f32
  arithmetic, byte for byte), and rows added later are quantized at the
  global scale directly, where the reference quantizes them at the shard's
  build scale and requantizes them again at staging.
- The reference stages every shard at one padded shape, repeating each
  shard's last tile window up to the largest shard's tile count; its
  planner can then spend the tile budget on those pad tiles (masked rows),
  which tie with the shard's last real tile. Each shard here plans over its
  own tiles, with ``p_tiles`` capped at its tile count: the budget always
  goes to real tiles. ``p_tiles``, its auto budget and the tune ladder
  count tiles as the reference does, by the largest shard.
- Pending and annex rows of a shard (a direct ``add`` to one) are scanned
  and merged in as the single index does; the reference's mesh search
  skips them.
"""

from __future__ import annotations

import itertools
import zlib

import numpy as np
import torch

from cloudvectordb_tpu_torch.eval.tune import TunableMixin
from cloudvectordb_tpu_torch.index.filters import IdFilter
from cloudvectordb_tpu_torch.index.ivf_band import (
    BandIVFIndex, auto_p_tiles, train_ordered_centroids)
from cloudvectordb_tpu_torch.index.range import RangeSearchMixin
from cloudvectordb_tpu_torch.ops.topk import NEG_INF, f32_const
from cloudvectordb_tpu_torch.parallel.mesh import (
    Mesh, fetch_local, gather_shard_meta, make_mesh, merge_partials, replica_slices,
    stage_queries, stage_replicated)
from cloudvectordb_tpu_torch.parallel.persist import (
    load_shards, read_sharded_manifest, save_sharded)
from cloudvectordb_tpu_torch.utils.device import DEFAULT


def requantize(sh: BandIVFIndex, scale: float, chunk: int = 1 << 20) -> None:
    """Re-express an int8 shard's arena at ``scale`` in place, block by
    block: round(r8 · f32(old / new)), clipped, the reference's staging
    arithmetic (dist_band.py:258-263). Pending and annex rows merge first."""
    if sh._scale == scale:
        return
    sh.merge_pending()
    pay = sh._payload
    ratio = f32_const(sh._scale / scale, pay)
    for lo in range(0, pay.shape[0], chunk):
        blk = pay[lo:lo + chunk]
        blk.copy_(torch.clamp(torch.round(blk.float() * ratio), -127, 127).to(torch.int8))
    sh._scale = scale
    sh._dev = sh._bias_cache = None


class ShardedBandIndex(TunableMixin, RangeSearchMixin):
    """Row-partitioned ``BandIVFIndex`` (int8 arenas, residual or whole
    rows) with a shared coarse quantizer. With several processes every
    process makes the same calls (build, add, remove, search) with the same
    arguments; each holds only the shards of its mesh slots."""

    kind = "sharded_band_ivf"

    def __init__(self, mesh: Mesh | None = None, **band_kw):
        if "device" in band_kw:
            raise ValueError("shard devices come from the mesh (make_mesh(devices=...))")
        if band_kw.get("dtype", "int8") != "int8":
            raise ValueError("sharded band arenas are int8 (residual or whole rows)")
        self.mesh = mesh or make_mesh()
        self.kw = band_kw
        self._shards: list[BandIVFIndex | None] = []  # None: another process's
        self._meta: list[dict] = []  # every shard's counts, on every process
        self._scale = 1.0
        self._copies: dict = {}  # (replica, shard) -> the shard on that slot's device

    @property
    def nshards(self) -> int:
        return self.mesh.n_shard

    @property
    def ntotal(self) -> int:
        return sum(m["ntotal"] for m in self._meta)

    @property
    def metric(self) -> str:
        return self.kw.get("metric", "ip")

    @property
    def device(self) -> torch.device:
        return self.mesh.local_devices()[0]

    def _proto(self) -> BandIVFIndex:
        return next(sh for sh in self._shards if sh is not None)

    def _new_shard(self, dim: int, nlist: int, si: int) -> BandIVFIndex:
        return BandIVFIndex(dim, nlist, **self.kw, device=self.mesh.shard_device(si))

    # -- build ------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, mesh: Mesh | None = None, train_sample: int = 262_144,
              centroids: np.ndarray | None = None, **kw) -> "ShardedBandIndex":
        """Train the shared quantizer on a seeded sample (or take
        ``centroids``, the final locality-ordered one), then give shard si
        rows [N·si/S, N·(si+1)/S) under global ids (slack holes keep -1)."""
        vectors = np.asarray(vectors, np.float32)
        idx = cls(mesh, **kw)
        s = idx.nshards
        dim = vectors.shape[1]
        if centroids is None:
            proto = BandIVFIndex(dim, nlist, **kw, device=idx.device)
            centroids = train_ordered_centroids(torch.from_numpy(vectors), nlist, train_sample,
                                                proto.kmeans_iters, proto.seed, idx.device)
        bounds = np.linspace(0, vectors.shape[0], s + 1).astype(int)
        idx._shards = [None] * s
        for si in range(s):
            if not idx.mesh.holds(si):
                continue
            sub = idx._new_shard(dim, nlist, si)
            sub.centroids = np.asarray(centroids, np.float32)
            sub._populate(torch.from_numpy(vectors[bounds[si]:bounds[si + 1]]).to(sub.device))
            ids = np.asarray(sub._ids, np.int64)
            # hole slots keep -1: offset into the valid range they would
            # alias a real row's id
            sub._ids = np.where(ids >= 0, ids + bounds[si], -1).astype(np.int32)
            idx._shards[si] = sub
        idx._finish()
        return idx

    @classmethod
    def build_streaming(cls, chunks, nlist: int, mesh: Mesh | None = None,
                        train_sample: int = 262_144, centroids: np.ndarray | None = None,
                        **kw) -> "ShardedBandIndex":
        """Build from (n_i, D) chunks (numpy or tensors, e.g. device-made
        batches) without the f32 corpus in one piece: the first chunk trains
        the shared quantizer (unless ``centroids``) and sets the one int8
        scale, every chunk is assigned and quantized on the device, and its
        int8 rows split across the shards (``np.array_split``, balanced
        whatever the chunk count) under global ids in stream order. Each
        held shard assembles its arena once. Host peak: the int8 rows."""
        idx = cls(mesh, **kw)
        s = idx.nshards
        chunks = iter(chunks)
        first = next(chunks, None)
        if first is None:
            raise ValueError("empty stream")
        proto = BandIVFIndex(int(first.shape[1]), nlist, **kw, device=idx.device)
        parts: list[list] = [[] for _ in range(s)]
        next_id = 0
        stream = proto.quantize_stream(itertools.chain([first], chunks), train_sample,
                                       centroids)
        for q8, a in stream:
            b = q8.shape[0]
            for si, sl in enumerate(np.array_split(np.arange(b), s)):
                if sl.size and idx.mesh.holds(si):
                    lo, hi = int(sl[0]), int(sl[-1]) + 1
                    parts[si].append((q8[lo:hi], a[lo:hi], next_id + sl))
            next_id += b
        idx._shards = [None] * s
        for si in range(s):
            if not idx.mesh.holds(si):
                continue
            if not parts[si]:
                raise ValueError(f"shard {si} received no rows")
            sub = idx._new_shard(proto.dim, nlist, si)
            sub.centroids = proto.centroids
            sub._scale = proto._scale
            q8s, assigns, gids = zip(*parts[si])
            sub._assemble_compact(torch.cat(q8s), np.concatenate(gids),
                                  np.concatenate(assigns))
            parts[si] = None
            idx._shards[si] = sub
        idx._finish()
        return idx

    def _finish(self, scale: float | None = None) -> None:
        """Every shard's metadata on every process, the global scale (the
        largest shard scale, or ``scale``) and each held arena requantized
        under it."""
        self._refresh_meta()
        self._scale = max(m["scale"] for m in self._meta) if scale is None else scale
        for sh in self._shards:
            if sh is not None:
                requantize(sh, self._scale)
        self._copies = {}

    def _refresh_meta(self) -> None:
        self._meta = gather_shard_meta(
            {si: dict(ntotal=sh.ntotal, gid_bound=sh._gid_bound(), n=sh._n, nlist=sh.nlist,
                      n_tiles=sh._tune_n_tiles(), scale=sh._scale)
             for si, sh in enumerate(self._shards) if sh is not None}, self.mesh)

    def _replica(self, r: int, si: int) -> BandIVFIndex:
        """Shard si on the device of slot (r, si): the shard itself, or a
        copy where a replica lives on another device."""
        sh = self._shards[si]
        dev = self.mesh.slot_device(r, si)
        if dev == sh.device:
            return sh
        if (r, si) not in self._copies:
            self._copies[(r, si)] = BandIVFIndex.from_state(
                sh._state_meta(), sh._state_arrays(), device=dev, metric=sh.metric)
        return self._copies[(r, si)]

    # -- search -----------------------------------------------------------
    def _n_tiles(self) -> int:
        """Tiles of the largest shard: what ``p_tiles`` counts."""
        return max(m["n_tiles"] for m in self._meta)

    def _auto_p_tiles(self, nq: int, nprobe: int) -> int:
        sh, m0 = self._proto(), self._meta[0]
        return auto_p_tiles(m0["n"], m0["nlist"], sh.tile_n, sh.tile_q, nq, nprobe,
                            self._n_tiles())

    def _resolve(self, nq: int, nprobe: int, p_tiles: int, top2):
        """(p_tiles, top2, tile_q, padded batch): the tuned op point for the
        sentinels, else the auto budget over each replica's own slice; the
        batch padded so every replica's slice is a tile_q multiple."""
        op = self._op_point or {}
        if p_tiles <= 0:
            p_tiles = op.get("p_tiles", 0)
        if top2 is None:
            top2 = bool(op.get("top2", False))
        tq = self._proto().tile_q
        if self.mesh.nproc > 1:  # this process's traffic, or the broadcast batch
            nq_plan, q_mult = nq, tq
        else:
            nq_plan, q_mult = max(1, nq // self.mesh.n_replica), tq * self.mesh.n_replica
        if p_tiles <= 0:
            p_tiles = self._auto_p_tiles(nq_plan, nprobe)
        return p_tiles, top2, tq, -(-nq // q_mult) * q_mult

    def _serve(self, qp, k: int, p_tiles: int, tq: int, scoring: str, flt, top2: bool):
        """Fan-out and fan-in of a padded batch (numpy or a tensor): each
        held shard's own tiles search, pending and annex rows merged in,
        then the merge in shard order. (scores, ids) tensors."""
        outs = []
        for r, sl in replica_slices(self.mesh, qp.shape[0]):
            parts, q_on = [], stage_replicated(qp[sl], self.mesh)
            for r2, si, _ in self.mesh.local_slots():
                if r2 != r:
                    continue
                sh = self._replica(r, si)
                q = q_on[sh.device]
                v, g = sh._tiles_kernel_dispatch(q, k, min(p_tiles, sh._tune_n_tiles()), tq,
                                                 scoring, flt, top2)
                parts.append(sh._merge_pending_topk(v, g, q, k, flt))
            outs.append(merge_partials(parts, k, self.mesh))
        dev = outs[0][0].device
        return torch.cat([v.to(dev) for v, _ in outs]), torch.cat([i.to(dev) for _, i in outs])

    def make_filter(self, where):
        """IdFilter over the global id space: one bitmap, each shard gathers
        it through its own id table."""
        return IdFilter.coerce(where, max((m["gid_bound"] for m in self._meta), default=0))

    def search(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
               scoring: str = "hybrid", where=None, top2: bool | None = None):
        """Numpy in, numpy out: (scores (Q, k') f32, ids (Q, k') int64), k' =
        min(k, the merged pool). Knobs as ``BandIVFIndex.search``'s tiles
        strategy, at the index's tile_q; ``p_tiles`` counts the largest
        shard's tiles. With several processes ``queries`` is this process's
        traffic on a replica-per-process mesh and the identical broadcast
        batch on a 1-D one (checked, with the static knobs, before the
        collective)."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        flt = self.make_filter(where) if where is not None else None
        p_tiles, top2, tq, q_pad = self._resolve(nq, nprobe, p_tiles, top2)
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)])
        # every knob that shapes the collective is part of the contract;
        # the filter rides as a CRC of its bitmap (a mismatch would corrupt
        # the merge, not hang it)
        scoring_code = {"precise": 0, "int8": 1}.get(scoring, 2)
        flt_crc = zlib.crc32(flt.mask_np.tobytes()) if flt is not None else 0
        qp = stage_queries(qp, self.mesh, statics=(p_tiles, k, scoring_code, flt_crc,
                                                   int(self.metric == "l2"), int(top2)))
        if flt is not None:
            flt.staged_for_mesh(self.mesh)
        v, i = self._serve(qp, k, p_tiles, tq, scoring, flt, top2)
        out_v, out_i = fetch_local(v)[:nq], fetch_local(i)[:nq].astype(np.int64)
        if flt is not None:  # unfilled slots keep the (-inf, -1) convention
            out_i = np.where(out_v > -np.inf, out_i, -1)
        return out_v, out_i

    def search_device(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
                      scoring: str = "hybrid", where=None, top2: bool | None = None):
        """``search`` on a (B, D) f32 tensor, results left on the device
        (scores (B, k') f32, ids (B, k') int64): one process's mesh only."""
        if self.mesh.nproc > 1:
            raise ValueError("search_device serves a one-process mesh; use search()")
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        nq = q.shape[0]
        flt = self.make_filter(where) if where is not None else None
        p_tiles, top2, tq, q_pad = self._resolve(nq, nprobe, p_tiles, top2)
        qp = q if q_pad == nq else torch.cat([q, q[-1:].expand(q_pad - nq, -1)])
        v, i = self._serve(qp, k, p_tiles, tq, scoring, flt, top2)
        v, i = v[:nq], i[:nq]
        if flt is not None:
            i = torch.where(v > NEG_INF, i, -1)
        return v, i

    # -- op-point tuning: tune() and _op_point from TunableMixin -------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """The cheapest tile budget meeting the recall target; the op point
        becomes search()'s default and persists with save()."""
        n_tiles = self._n_tiles()
        base = self._auto_p_tiles(nq, 32)
        out = []
        for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
            p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
            out.append({"p_tiles": p})
            if p >= n_tiles:
                break
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        return {"p_tiles": self._n_tiles()}

    # -- mutation ---------------------------------------------------------
    def add(self, vectors) -> np.ndarray:
        """Append to the smallest shard under wrapper-allocated global ids
        (returned), folded into its arena at once (``merge_pending``), so
        every row is in an arena the fan-out scans."""
        vectors = np.asarray(vectors, np.float32)
        nid = max(m["gid_bound"] for m in self._meta)
        ids = np.arange(nid, nid + vectors.shape[0], dtype=np.int64)
        si = int(np.argmin([m["ntotal"] for m in self._meta]))
        sh = self._shards[si]
        if sh is not None:
            sh.add(vectors, ids=ids)
            sh.merge_pending()
        self._copies = {}
        self._refresh_meta()
        return ids

    def remove(self, ids) -> int:
        """Delete by global id: each shard removes the ids it holds (an
        in-place swap-remove on residual arenas; unknown ids are ignored).
        Returns how many were removed over every shard."""
        before = self.ntotal
        for sh in self._shards:
            if sh is not None:
                sh.remove(ids)
        self._copies = {}
        self._refresh_meta()
        return before - self.ntotal

    # -- persistence ------------------------------------------------------
    def save(self, path, extra_meta: dict | None = None) -> None:
        """Every shard (a single-index artifact) and the wrapper's manifest
        under one directory (parallel/persist.py). Needs every shard in this
        process."""
        if any(sh is None for sh in self._shards):
            raise ValueError("save() needs every shard in this process")
        save_sharded(path, {"kind": self.kind, "scale": self._scale, "kw": self.kw,
                            "op_point": self._op_point, **(extra_meta or {})}, self._shards)

    @classmethod
    def load(cls, path, mesh: Mesh | None = None, mmap: bool = True,
             device=DEFAULT) -> "ShardedBandIndex":
        """The wrapper from a saved artifact, each held shard on its slot's
        device and requantized under the saved global scale. ``mesh``
        defaults to one of the saved shard count over ``device``; a mesh of
        another shard count reshards (``_reshard``)."""
        man = read_sharded_manifest(path)
        if man["kind"] != cls.kind:
            raise ValueError(f"{path} holds a {man['kind']!r} index")
        mesh = mesh or make_mesh(man["nshards"], devices=[device])
        idx = cls(mesh, **man.get("kw", {}))
        if idx.nshards == man["nshards"]:
            devs = [mesh.shard_device(si) if mesh.holds(si) else None
                    for si in range(idx.nshards)]
            idx._shards = load_shards(path, man, devs, mmap=mmap)
        else:
            if mesh.nproc > 1:
                raise ValueError("resharding loads every shard: one process")
            host = load_shards(path, man, ["cpu"] * man["nshards"], mmap=mmap)
            idx._shards = idx._reshard(host, man["scale"])
        idx._finish(scale=man["scale"])
        if man.get("op_point"):
            idx._op_point = dict(man["op_point"])
        return idx

    def _reshard(self, shards: list[BandIVFIndex], scale: float) -> list[BandIVFIndex]:
        """Re-partition loaded shards' rows onto this mesh's shard count
        without a rebuild: every valid row exports once (int8 rows
        requantized under ``scale`` where a shard's differs), the rows sort
        by global id and split contiguously, and each new shard runs one
        arena sort. The quantizer is shared, so nothing is retrained."""
        pls, gds, asg = [], [], []
        for sh in shards:
            requantize(sh, scale)
            p, g, a = sh._export_rows()
            pls.append(p.cpu())
            gds.append(g)
            asg.append(a)
        payload, gid, assign = torch.cat(pls), np.concatenate(gds), np.concatenate(asg)
        order = np.argsort(gid, kind="stable")
        payload, gid, assign = payload[torch.from_numpy(order)], gid[order], assign[order]
        proto = shards[0]
        bounds = np.linspace(0, gid.shape[0], self.nshards + 1).astype(int)
        out = []
        for si in range(self.nshards):
            lo, hi = bounds[si], bounds[si + 1]
            if hi <= lo:
                raise ValueError(f"reshard to {self.nshards}: shard {si} would be empty")
            sub = self._new_shard(proto.dim, proto.nlist, si)
            sub.centroids = np.asarray(proto.centroids)
            sub._scale = scale
            sub._assemble_compact(payload[lo:hi], gid[lo:hi], assign[lo:hi])
            out.append(sub)
        return out
