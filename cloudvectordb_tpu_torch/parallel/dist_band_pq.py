"""Sharded PQ-tiles serving index, BASELINE config #5 across shards
(counterpart of cloudvectordb_tpu/parallel/dist_band_pq.py:
``ShardedBandIVFPQIndex``).

Rows partition across the mesh's shard slots (contiguously for ``build``,
chunk by chunk for ``build_streaming``) and every quantizer is shared:
the OPQ rotation, the coarse centroids and the tier-1 and tier-2 PQ
codebooks are trained once on a global sample, or given (``centroids=``,
``codebooks=``, ``codebooks2=``, ``opq_matrix=``). Each shard is the port's
own ``refine='none'`` ``BandIVFPQIndex`` on its slot's device, holding
global ids, and a search runs K5 on every held shard through the
single-card ``_pq_tiles_core`` (K5b's bias for l2), with ``p_tiles``
capped at the shard's own tile count.

The refine tiers live in the wrapper: per shard, in insertion order and
keyed by global id (``_t_gids``), the tier-2 codes (``_t_c2``, and the l2
s₂ table ``_t_s2``), the host tier's int8 rows (``_t_host``) with their
lists (``_t_assign``) and the int8 refine rows (``_t_r8``). Staging a shard
permutes them into its arena order (``_arena_perm``), so the tier-2
rescore (``_pq2_rescore``) runs on the shard keyed by arena row, before the
merge. The host tier runs as the reference's two dispatches: each shard's
shortlist of k·host_factor rows (``stack_out``), then each shard's rows
gathered from its own host store into pinned memory, rescored exactly on
the shard's device (``_host_rescore``) and merged. Every merge is
``mesh.merge_partials``: one stable top-k in shard order, an
``all_gather`` across processes, so with several processes each gathers
only its own shards' host rows.

Differences from the reference, by design:
- No padded (S·n_pad, ...) stack: each shard is staged at its own size
  (the SPMD program needs one shape; a card does not). A shard past the
  segment cap is segmented by its own n_pad (index/ivf_band_pq.py) where
  the reference stages common segments over the largest shard's rows: the
  boundaries are multiples of the cap from row 0 either way, so K5's pools
  are the same; a shorter shard has fewer segments, where the reference's
  extra ones are all pad and give no candidates.
- Unfilled slots are (-inf, -1). The reference maps them through a shard's
  padded id table (``np.pad`` with 0s) when no filter is given, so a query
  short of candidates can get id 0.
- The host tier also serves a ('replica', 'shard') mesh (the reference
  refuses it).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from cloudvectordb_tpu_torch.eval.tune import TunableMixin, coverage_ladder
from cloudvectordb_tpu_torch.index.base import pad_rows
from cloudvectordb_tpu_torch.index.filters import IdFilter
from cloudvectordb_tpu_torch.index.ivf_band import (
    _pq2_rescore, _pq_tiles_core, auto_p_tiles, host_rows_sq, query_tile)
from cloudvectordb_tpu_torch.index.ivf_band_pq import (
    BandIVFPQIndex, _quantize, _scale_of, host_tier_rescore, pq_candidate_budget)
from cloudvectordb_tpu_torch.index.range import RangeSearchMixin
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.topk import NEG_INF
from cloudvectordb_tpu_torch.parallel.mesh import (
    Mesh, fetch_local, gather_shard_meta, make_mesh, merge_partials, replica_slices,
    stage_queries, stage_replicated)
from cloudvectordb_tpu_torch.parallel.persist import (
    load_extras, load_shards, read_sharded_manifest, save_sharded)
from cloudvectordb_tpu_torch.utils.device import DEFAULT

#: the wrapper's per-shard tier stores, each a list of insertion-order chunks
_TIERS = ("_t_gids", "_t_c2", "_t_s2", "_t_host", "_t_assign", "_t_r8")
_QUANT = ("centroids", "codebooks", "codebooks2")


class ShardedBandIVFPQIndex(TunableMixin, RangeSearchMixin):
    """Row-partitioned ``BandIVFPQIndex`` with shared quantizers. With
    several processes every process makes the same calls (build, add,
    remove, search) with the same arguments; each holds only the shards,
    and the tier stores, of its mesh slots."""

    kind = "sharded_band_ivf_pq"

    def __init__(self, mesh: Mesh | None = None, refine: str = "none", **pq_kw):
        if "device" in pq_kw:
            raise ValueError("shard devices come from the mesh (make_mesh(devices=...))")
        pq_kw.pop("refine", None)
        self.mesh = mesh or make_mesh()
        self.kw = pq_kw
        self.refine = refine
        self.proto: BandIVFPQIndex | None = None  # the shared quantizers
        self._shards: list[BandIVFPQIndex | None] = []  # None: another process's
        self._meta: list[dict] = []  # every shard's counts, on every process
        self._init_tier_lists(0)
        self._refine_scale = 0.0
        self._next_gid = 0
        self._dev: dict = {}  # (replica, shard) -> staged state
        self._pinned: dict = {}  # the host tier's pinned buffer (host_tier_rescore)

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

    @property
    def _tier2_active(self) -> bool:
        return self.refine in ("pq2", "pq2+host")

    @property
    def _host_active(self) -> bool:
        return self.refine in ("host", "pq2+host")

    @property
    def _any_tier(self) -> bool:
        return self._tier2_active or self._host_active or self.refine == "int8"

    def _gid_bound(self) -> int:
        return self._next_gid

    def _init_tier_lists(self, s: int) -> None:
        for name in _TIERS:
            setattr(self, name, [[] for _ in range(s)])
        self._tier_cache: dict = {}

    def _new_shard(self, si: int, device=None) -> BandIVFPQIndex:
        proto = self.proto
        sub = BandIVFPQIndex(proto.dim, refine="none", **self.kw,
                             device=device or self.mesh.shard_device(si))
        sub.centroids = np.asarray(proto.centroids)
        sub.codebooks = np.asarray(proto.codebooks)
        sub.opq_matrix = proto.opq_matrix
        return sub

    def _make_proto(self, sample, nlist: int, m: int, opq: bool, quant: dict) -> None:
        """The shared quantizers from ``sample`` (rows on this process's first
        device), each given one (``quant``) taken as it is."""
        self.proto = BandIVFPQIndex.train_proto(
            sample, nlist, m=m, opq=opq, refine=self.refine,
            **{k: v for k, v in quant.items() if k in _QUANT},
            **{k: v for k, v in self.kw.items() if k not in ("nlist", "m")},
            opq_matrix=quant.get("opq_matrix"), device=self.device)

    def _encode_batch(self, chunk) -> dict:
        """Rotate, assign and tier-1 encode one chunk with the shared
        quantizers on the device, with every active tier's payload; host
        (numpy) results."""
        proto = self.proto
        tr = proto._rotate(torch.as_tensor(chunk, dtype=torch.float32).to(proto.device))
        cdev = proto._centroids_dev()
        a, _ = assign_clusters(tr, cdev)
        enc_in = tr - cdev[a] if proto.residual else tr
        codes = proto._pq_encode_rows(enc_in, tr, proto._codebooks_dev())
        out = {"codes": codes.cpu().numpy(), "assigns": a.cpu().numpy().astype(np.int32)}
        if self.refine == "int8":
            rsrc = enc_in if proto.residual else tr
            if self._refine_scale == 0.0:  # the first chunk sets the scale
                self._refine_scale = _scale_of(rsrc)
            out["r8"] = _quantize(rsrc, self._refine_scale).cpu().numpy()
        if self._tier2_active:
            if self.metric == "l2":
                c2, s2 = proto._encode_tier2(enc_in, codes, cdev[a] if proto.residual else None,
                                             with_s2=True)
                out["c2"], out["s2"] = c2.cpu().numpy(), s2.cpu().numpy()
            else:
                out["c2"] = proto._encode_tier2(enc_in, codes).cpu().numpy()
        if self._host_active:
            out["host"] = _quantize(enc_in, proto._host_scale).cpu().numpy()
        return out

    def _append_tiers(self, si: int, gids: np.ndarray, enc: dict) -> None:
        if not self._any_tier:
            return
        self._t_gids[si].append(gids.astype(np.int64))
        if self._tier2_active:
            self._t_c2[si].append(enc["c2"])
            if self.metric == "l2":
                self._t_s2[si].append(enc["s2"])
        if self._host_active:
            self._t_host[si].append(enc["host"])
        if self.refine == "int8":
            self._t_r8[si].append(enc["r8"])
        self._t_assign[si].append(enc["assigns"])

    def _assemble(self, si: int, codes: np.ndarray, gids: np.ndarray, assigns: np.ndarray):
        """Shard si's arena (one host sort, ``_reassemble``), global ids."""
        sub = self._new_shard(si)
        sub._reassemble(torch.from_numpy(np.ascontiguousarray(codes)).to(sub.device),
                        gids, assigns, None)
        sub._next_id = self._next_gid
        return sub

    # -- build ------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, m: int = 64, mesh: Mesh | None = None,
              train_sample: int = 262_144, opq: bool = False, refine: str = "none",
              centroids=None, codebooks=None, codebooks2=None, opq_matrix=None,
              **kw) -> "ShardedBandIVFPQIndex":
        """Host-matrix build: the shared quantizers from the reference's
        seeded sample (or as given), then shard si takes rows
        [N·si/S, N·(si+1)/S) under their global ids."""
        vectors = np.asarray(vectors, np.float32)
        idx = cls(mesh, refine=refine, nlist=nlist, m=m, **kw)
        s = idx.nshards
        if vectors.shape[0] < s:
            raise ValueError(f"{vectors.shape[0]} rows cannot populate {s} shards")
        ns = min(train_sample, vectors.shape[0])
        sel = np.sort(np.random.default_rng(kw.get("seed", 0)).choice(
            vectors.shape[0], ns, replace=False))
        idx._make_proto(torch.from_numpy(vectors[sel]), nlist, m, opq,
                        dict(centroids=centroids, codebooks=codebooks, codebooks2=codebooks2,
                             opq_matrix=opq_matrix))
        idx._init_tier_lists(s)
        idx._next_gid = int(vectors.shape[0])
        bounds = np.linspace(0, vectors.shape[0], s + 1).astype(int)
        idx._shards = [None] * s
        for si in range(s):
            if not idx.mesh.holds(si):
                continue
            gids = np.arange(bounds[si], bounds[si + 1], dtype=np.int64)
            enc = idx._encode_batch(vectors[bounds[si]:bounds[si + 1]])
            idx._shards[si] = idx._assemble(si, enc["codes"], gids, enc["assigns"])
            idx._append_tiers(si, gids, enc)
        idx._refresh_meta()
        return idx

    @classmethod
    def build_streaming(cls, chunks, nlist: int, m: int = 64, mesh: Mesh | None = None,
                        train_sample: int = 262_144, opq: bool = False, refine: str = "none",
                        centroids=None, codebooks=None, codebooks2=None, opq_matrix=None,
                        **kw) -> "ShardedBandIVFPQIndex":
        """Config #5 at mesh scale: the quantizers train on the first chunk
        (or are given); every chunk (numpy or a tensor) is rotated, assigned
        and encoded on the device, and its codes and tier payloads split
        across the shards (``np.array_split``) under global ids in stream
        order. The f32 corpus never exists in one piece; each held shard's
        arena assembles once."""
        idx = cls(mesh, refine=refine, nlist=nlist, m=m, **kw)
        s = idx.nshards
        idx._init_tier_lists(s)
        acc: list[list] = [[] for _ in range(s)]
        next_id = 0
        for chunk in chunks:
            if idx.proto is None:
                chunk = torch.as_tensor(chunk, dtype=torch.float32).to(idx.device)
                idx._make_proto(chunk[:min(train_sample, chunk.shape[0])], nlist, m, opq,
                                dict(centroids=centroids, codebooks=codebooks,
                                     codebooks2=codebooks2, opq_matrix=opq_matrix))
            enc = idx._encode_batch(chunk)
            b = enc["codes"].shape[0]
            gids = np.arange(next_id, next_id + b, dtype=np.int64)
            next_id += b
            for si, sl in enumerate(np.array_split(np.arange(b), s)):
                if not sl.size or not idx.mesh.holds(si):
                    continue
                lo, hi = int(sl[0]), int(sl[-1]) + 1
                part = {k_: v_[lo:hi] for k_, v_ in enc.items()}
                acc[si].append((part["codes"], part["assigns"], gids[lo:hi]))
                idx._append_tiers(si, gids[lo:hi], part)
            enc = chunk = None
        if idx.proto is None:
            raise ValueError("empty stream")
        idx._next_gid = next_id
        idx._shards = [None] * s
        for si in range(s):
            if not idx.mesh.holds(si):
                continue
            if not acc[si]:
                raise ValueError(f"shard {si} received no rows")
            codes, assigns, gids = (np.concatenate(c) for c in zip(*acc[si]))
            acc[si] = None
            idx._shards[si] = idx._assemble(si, codes, gids, assigns)
        idx._refresh_meta()
        return idx

    def _refresh_meta(self) -> None:
        """Every shard's counts on every process (a collective with several
        processes); the staged state is dropped."""
        self._meta = gather_shard_meta(
            {si: dict(ntotal=sh.ntotal, n=sh._n, n_tiles=sh._tune_n_tiles(),
                      tile_n=sh.tile_n, n_host=sum(len(c) for c in self._t_host[si]))
             for si, sh in enumerate(self._shards) if sh is not None}, self.mesh)
        if len({m["tile_n"] for m in self._meta}) != 1:
            raise ValueError("the shards' arenas took different tile_n (skewed lists): "
                             "rebuild with a smaller tile_n")
        self._dev = {}

    # -- mutation ---------------------------------------------------------
    def add(self, vectors) -> np.ndarray:
        """Append to the smallest non-empty shard under wrapper-allocated
        global ids (returned), merged into its arena at once; the tier
        payloads encode once with the shared quantizers and join that
        shard's stores. Freed ids are never reused."""
        if not self._meta:
            raise ValueError("build() first")
        vectors = np.asarray(vectors, np.float32)
        b = vectors.shape[0]
        gids = np.arange(self._next_gid, self._next_gid + b, dtype=np.int64)
        self._next_gid += b
        # an emptied shard cannot take explicit ids (its add would populate)
        sizes = [m["ntotal"] if m["ntotal"] else np.inf for m in self._meta]
        if not np.isfinite(min(sizes)):
            raise ValueError("every shard is empty: build a fresh index instead")
        si = int(np.argmin(sizes))
        sh = self._shards[si]
        if sh is not None:
            sh.add(vectors, ids=gids)
            sh.merge_pending()
            self._append_tiers(si, gids, self._encode_batch(vectors))
        self._refresh_meta()
        return gids

    def remove(self, ids) -> int:
        """Delete by global id: each shard compacts what it holds (unknown ids
        are ignored). The tier stores keep the removed rows, which staging
        never looks up. Returns how many were removed over every shard."""
        before = self.ntotal
        for sh in self._shards:
            if sh is not None:
                sh.remove(ids)
        self._refresh_meta()
        return before - self.ntotal

    # -- staging ----------------------------------------------------------
    def _tier_store(self, si: int) -> dict:
        """Shard si's tier stores joined, with the gids' stable sort; cached
        per append count (an add re-sorts)."""
        key = len(self._t_gids[si])
        hit = self._tier_cache.get(si)
        if hit is not None and hit[0] == key:
            return hit[1]

        def cat(name):
            chunks = getattr(self, name)[si]
            return np.concatenate(chunks) if chunks else None

        gids = cat("_t_gids")
        gids = np.empty(0, np.int64) if gids is None else gids
        sort_idx = np.argsort(gids, kind="stable")
        out = dict(gids_sorted=gids[sort_idx], sort_idx=sort_idx, c2=cat("_t_c2"),
                   s2=cat("_t_s2"), host=cat("_t_host"), assign=cat("_t_assign"),
                   r8=cat("_t_r8"))
        self._tier_cache[si] = (key, out)
        return out

    def _arena_perm(self, si: int) -> np.ndarray:
        """Store position of each of shard si's arena rows (a gid lookup)."""
        st = self._tier_store(si)
        arena_ids = np.asarray(self._shards[si]._ids, np.int64)[: self._shards[si]._n]
        pos = np.searchsorted(st["gids_sorted"], arena_ids)
        pos = np.minimum(pos, max(st["gids_sorted"].shape[0] - 1, 0))
        if st["gids_sorted"].shape[0] == 0 or not (st["gids_sorted"][pos] == arena_ids).all():
            raise ValueError(f"shard {si}: the tier store misses arena ids")
        return st["sort_idx"][pos]

    def _replica(self, r: int, si: int) -> BandIVFPQIndex:
        """Shard si on the device of slot (r, si): the shard itself, or a
        copy where a replica lives on another device."""
        sh = self._shards[si]
        dev = self.mesh.slot_device(r, si)
        if dev == sh.device:
            return sh
        return BandIVFPQIndex.from_state(sh._state_meta(), sh._state_arrays(), device=dev,
                                         metric=sh.metric)

    def _staged(self, r: int, si: int) -> dict:
        """Slot (r, si)'s serving state: the shard on its device and the tier
        stores it needs in its arena order, padded to the arena's rows (the
        int8 refine rows, the tier-2 codes and s₂), with the host tier's
        arena row -> store position map. Cached until a mutation."""
        if (r, si) in self._dev:
            return self._dev[(r, si)]
        sh = self._replica(r, si)
        dev, n_pad = sh.device, sh._n_pad_rows
        out = {"sh": sh, "si": si}
        if self._any_tier and self._t_gids[si]:
            perm = self._arena_perm(si)
            st = self._tier_store(si)

            def arena(arr, dtype):
                a = np.zeros((n_pad, *arr.shape[1:]), dtype)
                a[: perm.shape[0]] = arr[perm]
                return torch.from_numpy(a).to(dev)

            if self.refine == "int8":
                out["refine"] = arena(st["r8"], np.int8)
            if self._tier2_active:
                out["codes2"] = arena(st["c2"], np.uint8)
                out["codebooks2"] = torch.as_tensor(self.proto.codebooks2, device=dev)
                if self.metric == "l2":
                    out["s2"] = arena(st["s2"], np.float32)
            if self._host_active and st["host"] is not None:
                out["perm"] = perm
        self._dev[(r, si)] = out
        return out

    def _host_sq(self, si: int) -> np.ndarray:
        """‖x̂‖² of each of shard si's host-store rows (the l2 host rescore's
        bias), cached per store state."""
        st = self._tier_store(si)
        hit = self._tier_cache.get(("sq", si))
        if hit is None or hit[0] is not st["host"]:
            hit = (st["host"], host_rows_sq(st["host"], st["assign"], self.proto.centroids,
                                            self.proto._host_scale))
            self._tier_cache[("sq", si)] = hit
        return hit[1]

    # -- filters ----------------------------------------------------------
    def make_filter(self, where):
        """IdFilter over the global id space: one bitmap; each shard gathers
        it through its own id table (K5's row_mask, cached per filter)."""
        return IdFilter.coerce(where, max(self._next_gid, 1))

    # -- search -----------------------------------------------------------
    def _n_tiles(self) -> int:
        """Tiles of the largest shard: what ``p_tiles`` counts."""
        return max(m["n_tiles"] for m in self._meta)

    def _auto_p_tiles(self, nq: int, nprobe: int, tq: int) -> int:
        m0 = self._meta[0]
        return auto_p_tiles(m0["n"], self.proto.nlist, m0["tile_n"], tq, nq, nprobe,
                            self._n_tiles())

    def _stage_plan(self, k, refine_factor, host_factor, n_pools, tq, p_tiles, top2):
        """The reference's per-shard candidate budget: (two_stage, tier2,
        host, k_cand, n_pools, l_buckets, k_out). Each shard draws k_cand
        candidates (``pq_candidate_budget`` over the largest shard; every
        shard shares tile_n); k_out is each shard's output width (k, or the
        host tier's shortlist)."""
        tier2 = self._tier2_active and self.proto.codebooks2 is not None
        host = self._host_active and any(m["n_host"] for m in self._meta)
        two_stage = tier2 or host or self.refine == "int8"
        k_cand, n_pools, l_buckets = pq_candidate_budget(
            k, refine_factor, n_pools, tq, p_tiles, top2, two_stage=two_stage,
            n=max(m["n"] for m in self._meta), tile_n=self._meta[0]["tile_n"])
        if host:
            k_out = min(max(k * host_factor, k), k_cand) if tier2 else k_cand
        else:
            k_out = k
        return two_stage, tier2, host, k_cand, n_pools, l_buckets, k_out

    def _shard_search(self, st: dict, q: torch.Tensor, k: int, plan: dict, flt, host: bool):
        """One shard's part: K5 over its own tiles, the int8 rescore or the
        tier-2 rescore keyed by arena row, the global-id map, and with the
        host tier its exact rescore from the shard's own host store. (v, ids)
        of k (host tier) or k_out columns; unfilled slots (-inf, -1)."""
        sh = st["sh"]
        ds = sh._device_state()
        l2 = self.metric == "l2"
        v, rows = _pq_tiles_core(
            q, ds["centroids"], ds["codes"], ds["codebooks"], st.get("refine", ds["refine"]),
            ds["tile_window"], ds["centroid_tiles"], sh._n, ds["local"],
            sh._arena_filter(flt)[0] if flt is not None else None,
            k=plan["k_core"], k_cand=plan["k_cand"],
            p_tiles=min(plan["p_tiles"], sh._tune_n_tiles()), tile_n=sh.tile_n,
            tile_q=plan["tq"], refine_scale=plan["refine_scale"], n_pools=plan["n_pools"],
            l_buckets=plan["l_buckets"], refine_residual=plan["refine_residual"], l2=l2,
            top2=plan["top2"], row_bias=sh._row_bias("pq") if l2 else None,
            segments=sh._seg_rows())
        if plan["tier2"]:
            # a range search's escalated k can pass a small shard's candidates
            v, rows = _pq2_rescore(q, v, rows, st["codes2"], st["codebooks2"], st.get("s2"),
                                   k=min(plan["k_out"], v.shape[1]), l2=l2)
        v, rows = v[:, :plan["k_out"]], rows[:, :plan["k_out"]].long()
        rows = rows.clamp(0, max(sh._n - 1, 0))
        gid = torch.where(v > NEG_INF, ds["ids"][rows].long(), -1)
        if host:
            return self._host_tier(st, q, v, gid, rows, k)
        return v, gid

    def _host_tier(self, st: dict, q, v, gid, rows, k: int):
        """Dispatch 2 on one shard: ``host_tier_rescore`` of its shortlist
        from the shard's own host store (arena row -> store position)."""
        si, store = st["si"], self._tier_store(st["si"])
        l2 = self.metric == "l2"
        resid = self.proto.residual
        return host_tier_rescore(
            q, v, gid, store["host"], store["assign"], st["perm"][rows.cpu().numpy()],
            st["sh"]._device_state()["centroids"], self.proto._host_scale,
            self._host_sq(si) if l2 and resid else None, k=min(k, v.shape[1]), resid=resid,
            l2=l2, cache=self._pinned)

    def search(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
               refine_factor: int | None = None, n_pools: int = 0, tile_q: int | None = None,
               where=None, top2: bool | None = None, host_factor: int | None = None):
        """Numpy in, numpy out: (scores (Q, k') f32, ids (Q, k') int64), k' =
        min(k, the merged pool). Knobs as ``BandIVFPQIndex.search``'s PQ
        route; left at their sentinels they take the tuned op point, else
        refine_factor 16, host_factor 64, auto pools and the span-aware
        ``p_tiles``, which counts the largest shard's tiles. With several
        processes ``queries`` is this process's traffic on a
        replica-per-process mesh and the identical broadcast batch on a 1-D
        one (checked, with the static knobs, before the first collective)."""
        if not self._meta:
            raise ValueError("build() first")
        queries = np.asarray(queries, np.float32)
        proto = self.proto
        if proto.opq_matrix is not None:
            queries = queries @ proto.opq_matrix.T
        nq = queries.shape[0]
        flt = self.make_filter(where) if where is not None else None
        kn = self._op_knobs(refine_factor=refine_factor, host_factor=host_factor,
                            n_pools=n_pools, p_tiles=p_tiles, tile_q=tile_q, top2=top2)
        # this process's traffic or the broadcast batch, else a replica's slice
        n_rep = 1 if self.mesh.nproc > 1 else self.mesh.n_replica
        nq_plan = nq if self.mesh.nproc > 1 else max(1, nq // n_rep)
        tq = query_tile(kn["tile_q"], proto.tile_q, nq_plan)
        p_tiles = kn["p_tiles"] or self._auto_p_tiles(nq_plan, nprobe, tq)
        top2 = kn["top2"]
        two_stage, tier2, host, k_cand, n_pools, l_buckets, k_out = self._stage_plan(
            k, kn["refine_factor"], kn["host_factor"], kn["n_pools"], tq, p_tiles, top2)
        qp = pad_rows(queries, tq * n_rep)
        int8 = self.refine == "int8"
        flt_crc = zlib.crc32(flt.mask_np.tobytes()) if flt is not None else 0
        qp = stage_queries(qp, self.mesh, statics=(p_tiles, k, k_cand, k_out, n_pools,
                                                   l_buckets, flt_crc,
                                                   int(self.metric == "l2"), int(top2),
                                                   int(host)))
        if flt is not None:
            flt.staged_for_mesh(self.mesh)
        plan = dict(
            p_tiles=p_tiles, tq=tq, k_cand=k_cand, n_pools=n_pools, l_buckets=l_buckets,
            k_out=k_out, top2=top2, tier2=tier2,
            # the core's own width: every candidate when a later tier reranks them
            k_core=k_cand if (tier2 or host) and not int8 else k,
            refine_scale=self._refine_scale if int8 else 0.0,
            refine_residual=int8 and proto.residual)
        outs = []
        for r, sl in replica_slices(self.mesh, qp.shape[0]):
            parts, q_on = [], stage_replicated(qp[sl], self.mesh)
            for r2, si, _ in self.mesh.local_slots():
                if r2 != r:
                    continue
                st = self._staged(r, si)
                parts.append(self._shard_search(st, q_on[st["sh"].device], k, plan, flt, host))
            outs.append(merge_partials(parts, k, self.mesh))
        out_v = np.concatenate([fetch_local(v) for v, _ in outs])[:nq]
        out_i = np.concatenate([fetch_local(i) for _, i in outs])[:nq].astype(np.int64)
        return out_v, np.where(out_v > -np.inf, out_i, -1)

    # -- op-point tuning: tune() and _op_point from TunableMixin -------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """The reference's ladder: coverage x refine depth (x the cascade's
        shortlist width), cheapest first by its cost proxy."""
        n_tiles = self._n_tiles()
        host = self._host_active and any(m["n_host"] for m in self._meta)
        out = []
        for p in coverage_ladder(self._auto_p_tiles(nq, 32, self.proto.tile_q), n_tiles):
            if self.refine == "none":
                out.append({"p_tiles": p})
            elif host and self._tier2_active:
                for rf in (64, 205, 410):
                    for hf in (32, 102):
                        out.append({"p_tiles": p, "refine_factor": rf, "host_factor": hf})
            else:
                for rf in (16, 64, 102):
                    out.append({"p_tiles": p, "refine_factor": rf})
                    if rf >= 64:
                        out.append({"p_tiles": p, "refine_factor": rf, "top2": True})
        seen = set()
        out = [c for c in out
               if (key := tuple(sorted(c.items()))) not in seen and not seen.add(key)]
        out.sort(key=lambda c: (c["p_tiles"] * (1 + c.get("refine_factor", 0) / 256.0)
                                * (1 + c.get("host_factor", 0) / 512.0)))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        kw = {"p_tiles": self._n_tiles()}
        if self.refine != "none":
            kw["refine_factor"] = 102
        if self._host_active and self._tier2_active and any(m["n_host"] for m in self._meta):
            kw["refine_factor"] = 410
            kw["host_factor"] = 102
        return kw

    # -- persistence ------------------------------------------------------
    def save(self, path, extra_meta: dict | None = None) -> None:
        """One atomic directory (parallel/persist.py): the shards' PQ-tiles
        artifacts and the wrapper's insertion-order tier stores (keyed by
        global id, so they survive merges and a reshard). Needs every shard
        in this process."""
        if any(sh is None for sh in self._shards):
            raise ValueError("save() needs every shard in this process")

        def cat(chunks):
            return np.concatenate(chunks) if chunks else None

        extras = {"tier_gids": [cat(c) for c in self._t_gids],
                  "tier_assign": [cat(c) for c in self._t_assign]}
        if self._tier2_active:
            extras["tier_c2"] = [cat(c) for c in self._t_c2]
            if self.metric == "l2":
                extras["tier_s2"] = [cat(c) for c in self._t_s2]
            extras["codebooks2"] = ([np.asarray(self.proto.codebooks2)]
                                    + [None] * (self.nshards - 1))
        if self._host_active:
            extras["tier_host"] = [cat(c) for c in self._t_host]
        if self.refine == "int8":
            extras["tier_r8"] = [cat(c) for c in self._t_r8]
        save_sharded(path, {"kind": self.kind, "kw": self.kw, "refine": self.refine,
                            "refine_scale": self._refine_scale,
                            "host_scale": float(self.proto._host_scale),
                            "next_gid": self._next_gid, "op_point": self._op_point,
                            **(extra_meta or {})},
                     self._shards, extras_per_shard=extras)

    @classmethod
    def load(cls, path, mesh: Mesh | None = None, mmap: bool = True,
             device=DEFAULT) -> "ShardedBandIVFPQIndex":
        """The wrapper from either package's saved artifact, each held shard on
        its slot's device; a mesh of another shard count reshards
        (``_do_reshard``, one process)."""
        man = read_sharded_manifest(path)
        if man["kind"] != cls.kind:
            raise ValueError(f"{path} holds a {man['kind']!r} index")
        s_saved = man["nshards"]
        mesh = mesh or make_mesh(s_saved, devices=[device])
        idx = cls(mesh, refine=man["refine"], **man.get("kw", {}))
        reshard = idx.nshards != s_saved
        if reshard and mesh.nproc > 1:
            raise ValueError("resharding loads every shard: one process")
        devs = [idx.device if reshard else mesh.shard_device(si) if mesh.holds(si) else None
                for si in range(s_saved)]
        idx._shards = load_shards(path, man, devs, mmap=mmap)
        idx._refine_scale = man["refine_scale"]
        idx._next_gid = man["next_gid"]
        idx._init_tier_lists(s_saved)
        for name, attr in (("tier_gids", "_t_gids"), ("tier_assign", "_t_assign"),
                           ("tier_c2", "_t_c2"), ("tier_s2", "_t_s2"),
                           ("tier_host", "_t_host"), ("tier_r8", "_t_r8")):
            for si, a in enumerate(load_extras(path, man, name, mmap=mmap) or []):
                if a is not None and devs[si] is not None:
                    getattr(idx, attr)[si].append(np.asarray(a))
        # the shared quantizers: a held shard's, and codebooks2 from the extras
        sh = next(s for s in idx._shards if s is not None)
        proto = BandIVFPQIndex(sh.dim, refine=idx.refine, **idx.kw, device=idx.device)
        proto.centroids = np.asarray(sh.centroids)
        proto.codebooks = np.asarray(sh.codebooks)
        proto.opq_matrix = sh.opq_matrix
        proto._host_scale = float(man.get("host_scale", 0.0))
        cb2 = load_extras(path, man, "codebooks2", mmap=mmap)
        if cb2 and cb2[0] is not None:
            proto.codebooks2 = np.array(cb2[0], np.float32)
        idx.proto = proto
        if reshard:
            idx._do_reshard(idx.nshards)
        idx._refresh_meta()
        if man.get("op_point"):
            idx._op_point = dict(man["op_point"])
        return idx

    def _do_reshard(self, s_new: int) -> None:
        """Re-partition the loaded shards onto ``s_new`` without a rebuild:
        the codes move verbatim (the quantizers are shared), the rows sort by
        global id and split contiguously, each new shard runs one arena
        sort, and the tier stores re-split by membership (removed ids' rows
        drop out)."""
        codes_l, gids_l, asg_l = [], [], []
        for sh in self._shards:
            sh.merge_pending()
            codes_l.append(sh._codes[: sh._n].cpu().numpy())
            gids_l.append(np.asarray(sh._ids, np.int64)[: sh._n])
            asg_l.append(sh._list_of_rows())
        codes, gid = np.concatenate(codes_l), np.concatenate(gids_l)
        assign = np.concatenate(asg_l)
        order = np.argsort(gid, kind="stable")
        codes, gid, assign = codes[order], gid[order], assign[order]

        def cat_all(name):
            parts = [np.concatenate(c) for c in getattr(self, name) if c]
            return np.concatenate(parts) if parts else None

        stores = {name: cat_all(name) for name in _TIERS}
        g_all = stores.pop("_t_gids")
        bounds = np.linspace(0, gid.shape[0], s_new + 1).astype(int)
        self._init_tier_lists(s_new)
        shards = []
        for si in range(s_new):
            lo, hi = bounds[si], bounds[si + 1]
            if hi <= lo:
                raise ValueError(f"reshard to {s_new}: shard {si} would be empty")
            shards.append(self._assemble(si, codes[lo:hi], gid[lo:hi], assign[lo:hi]))
            if g_all is not None:
                sel = np.isin(g_all, gid[lo:hi])
                self._t_gids[si].append(g_all[sel])
                for name, arr in stores.items():
                    if arr is not None:
                        getattr(self, name)[si].append(arr[sel])
        self._shards = shards
