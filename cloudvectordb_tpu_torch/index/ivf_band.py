"""Tile-pruned IVF — the serving index (counterpart of
cloudvectordb_tpu/index/ivf_band.py: the inner-product ``BandIVFIndex`` over
residual-int8 arenas and over whole-row int8, bf16 and f32 arenas, its
device planner ``_plan_tiles``, its one-dispatch searches
``_tiles_resid_plan_search`` and ``_tiles_plan_search``, and the band
strategy ``_search_band``).

Layout: rows sorted by coarse list into one arena, padded to a multiple of
``tile_n``: int8 residuals (row − its list centroid) with
``residual=True``, else whole rows (int8 with one scale, bf16 or f32). A
tiles search sorts queries by their top-1 list, gives each group of
``tile_q`` queries one table of the ``p_tiles`` arena tiles its lists score
best on, and scans those tiles with ops/band.py (K1 for residual arenas,
K3 for whole rows; hand-written kernels on CUDA). The band strategy scans
each query group's contiguous band of tiles instead (K7). The index lives
on one explicit ``device``; only small metadata (assignments, offsets,
per-tile tables, band plans) is computed on the host.

Not in this slice (each raises or is absent): filters and ``row_mask``,
``metric='l2'`` (residual arenas; the reference refuses it for whole rows),
``top2``, slack arenas with ``add``/``remove``, the pending buffer and
annex, ``merge_from`` and ``build_streaming``. Without ``add`` there are
never pending rows, so a search is the arena scan alone.
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.base import Index, from_numpy, to_numpy
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
from cloudvectordb_tpu_torch.ops.assign import assign_clusters
from cloudvectordb_tpu_torch.ops.band import (
    band_topk, order_centroids, tiles_topk, tiles_topk_resid)
from cloudvectordb_tpu_torch.ops.flat_topk import quantize_queries
from cloudvectordb_tpu_torch.ops.topk import f32_const, tiled_topk, topk_stable
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device

#: max list indices one arena tile may span: bounds the per-tile window W
#: that sizes centroid_tiles (n_tiles, W, D) and the uint8 per-row local
#: index (< 256). Enforced by _capacity_layout via tile-boundary hole
#: padding; healthy data never triggers it.
_W_CAP = 128
_ARENA_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _plan_tiles(q: torch.Tensor, centroids: torch.Tensor,
                tile_window: torch.Tensor, tile_q: int, p_tiles: int):
    """Device-side planning prologue of every tiles search.

    Sorts queries by their top-1 coarse centroid (L2 ranking — the
    assignment metric; a stable sort, as ``jnp.argsort``), then scores arena
    tiles per query group: group-max over queries first, then the
    tile-window gather. Returns (q_s, order, tile_table) with tile_table
    (n_qt, p_tiles) int32. (The reference also returns the raw q·centroids
    matrix, which only its PQ family reads.)

    Every tile of a list spanning several tiles gets the same score, so the
    tile scores hold many exact ties; the table keeps the lower tile id on
    ties, as ``lax.top_k`` does (a stable descending sort, not torch.topk).
    """
    n_qt = q.shape[0] // tile_q
    n_tiles = tile_window.shape[0]
    if not 0 < p_tiles <= n_tiles:
        raise ValueError(f"p_tiles={p_tiles} outside 1..{n_tiles} arena tiles")
    dots = q @ centroids.T
    c_sq = (centroids * centroids).sum(dim=1)
    coarse = dots - 0.5 * c_sq[None, :]
    top1 = torch.argmax(coarse, dim=1)
    order = torch.argsort(top1, stable=True)
    q_s = q[order]
    g_max = coarse[order].reshape(n_qt, tile_q, -1).amax(dim=1)
    ts = g_max[:, tile_window.T].amax(dim=1)  # (n_qt, n_tiles)
    _, tile_table = topk_stable(ts, p_tiles)
    return q_s, order, tile_table.to(torch.int32).contiguous()


def _unsort(order, v, gids):
    """Scores and global ids back in the caller's query order."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return v[inv], gids[inv]


def _tiles_resid_plan_search(
    q, centroids, payload, local_ids, centroid_tiles, resid_scale, ids,
    tile_window, valid_end, *, k: int, p_tiles: int, tile_n: int,
    tile_q: int, int8_q: bool = True,
):
    """One-dispatch residual-int8 search: device planning, the tile scan
    (ops/band.py), the arena-row → global-id map and the unsort to caller
    query order. q (B, D) f32 with B % tile_q == 0; ids int32 on the
    device. Unfilled slots map through ids[clip(row)], as the reference's."""
    q_s, order, tile_table = _plan_tiles(
        q, centroids, tile_window, tile_q, p_tiles)
    v, rows = tiles_topk_resid(
        payload, local_ids, centroid_tiles, resid_scale, q_s, tile_table, k,
        valid_end, tile_n=tile_n, tile_q=tile_q, int8_q=int8_q)
    return _unsort(order, v, ids[rows.long().clamp(0, ids.shape[0] - 1)])


def _tiles_plan_search(q, centroids, payload, ids, tile_window, db_scale, n_valid,
                       *, k: int, p_tiles: int, tile_n: int, tile_q: int, int8):
    """One-dispatch whole-row search: device planning, the tile scan (K3,
    ops/band.py), the arena-row → global-id map and the unsort. ``int8``
    is the reference's score mode: True quantizes each query to int8
    (``round(q / (amax/127))``), 'hybrid' scores bf16 queries against the
    int8 rows, False scores queries cast to the arena dtype."""
    q_s, order, tile_table = _plan_tiles(q, centroids, tile_window, tile_q, p_tiles)
    scale = f32_const(db_scale, q)
    if int8 == "hybrid":
        q_dev = q_s.to(torch.bfloat16)
    elif int8:
        q_dev, q_scale = quantize_queries(q_s)
        scale = q_scale * scale
    else:
        q_dev = q_s.to(payload.dtype)
    v, rows = tiles_topk(payload, q_dev, tile_table, k, tile_n=tile_n,
                         tile_q=tile_q, int8=int8, n_valid=n_valid)
    v = v * scale
    return _unsort(order, v, ids[rows.long().clamp(0, ids.shape[0] - 1)])


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class BandIVFIndex(Index):
    kind = "band_ivf"

    def __init__(
        self,
        dim: int,
        nlist: int,
        dtype: str = "int8",
        kmeans_iters: int = 15,
        seed: int = 0,
        tile_n: int = 2048,
        tile_q: int = 256,
        residual: bool = False,
        slack: float = 0.0,
        metric: str = "ip",
        device: str | torch.device = DEFAULT,
    ):
        """The reference's constructor with an explicit ``device``.
        ``residual=True`` (int8 only) stores int8 residuals and adds the
        centroid term back in the kernel; otherwise the arena holds whole
        rows in ``dtype``. What the reference refuses raises ValueError
        (residual bf16/f32, slack on whole rows, l2 on whole rows); what
        this slice has not ported raises NotImplementedError (slack arenas,
        residual l2)."""
        if dtype not in ("int8", "bfloat16", "float32"):
            raise ValueError(f"unknown arena dtype {dtype!r}")
        if residual and dtype != "int8":
            raise ValueError("residual is the int8 path")
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if slack != 0.0:
            if not residual:
                raise ValueError("slack slots require the residual-int8 arena")
            raise NotImplementedError(
                "slack arenas (in-place add/remove) arrive with the mutation slice")
        if metric == "l2":
            if not residual:
                # the whole-row kernels carry no l2 bias (as the reference)
                raise ValueError(
                    "BandIVFIndex metric='l2' requires the residual-int8 arena")
            raise NotImplementedError("metric='l2' arrives with the l2/top2 slice")
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.dtype = dtype
        self.residual = residual
        self.slack = slack
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.tile_n = tile_n
        self.tile_q = tile_q
        self.device = as_device(device)
        self.centroids: np.ndarray | None = None  # (nlist, D) f32, locality-ordered
        self._payload: torch.Tensor | None = None  # (N_pad, D) on device
        self._ids: np.ndarray | None = None  # arena row -> global id (-1: hole)
        self._offsets: np.ndarray | None = None  # (nlist+1,) row offsets
        self._list_lens: np.ndarray | None = None  # valid rows per list (holes)
        self._local = None  # (1, N_pad) uint8 per-row local list idx
        self._centroid_tiles = None  # (n_tiles, W, D) f32
        self._valid_end = None  # (n_tiles, W) int32 per-tile-list valid end
        self._tile_window = None  # (n_tiles, W) int32 list ids per tile
        self._scale = 1.0
        self._n = 0  # arena extent (capacity offsets[-1])
        self._next_id = 0  # 0: derive from the id table (_gid_bound)
        self._dev = None

    @property
    def _n_valid(self) -> int:
        """Valid arena rows (the extent minus tile-span-cap holes)."""
        if self._list_lens is not None:
            return int(self._list_lens.sum())
        return self._n

    @property
    def ntotal(self) -> int:
        return self._n_valid

    def _gid_bound(self) -> int:
        """1 + the largest global id ever allocated."""
        if self._next_id == 0 and self._ids is not None and len(self._ids):
            self._next_id = int(np.asarray(self._ids).max(initial=-1)) + 1
        return self._next_id

    def add(self, vectors) -> None:
        raise NotImplementedError(
            "add() (pending buffer, slack arenas) arrives with the mutation slice")

    # -- build ------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, train_sample: int = 262_144,
              centroids: np.ndarray | None = None, **kw) -> "BandIVFIndex":
        """Build from (N, D) vectors (numpy or a tensor). ``centroids``, when
        given, is the final, locality-ordered quantizer and skips training."""
        idx = cls(int(vectors.shape[1]), nlist, **kw)
        x = torch.as_tensor(vectors, dtype=torch.float32).to(idx.device)
        if centroids is None:
            ns = min(train_sample, x.shape[0])
            sel = np.random.default_rng(idx.seed).choice(x.shape[0], ns, replace=False)
            c, _ = train_kmeans(x[torch.as_tensor(np.sort(sel), device=idx.device)],
                                nlist, iters=idx.kmeans_iters, seed=idx.seed)
            c = c.cpu().numpy()
            centroids = c[order_centroids(c)]  # relabel along locality order
        idx.centroids = np.asarray(centroids, np.float32)
        idx._populate(x)
        return idx

    def _populate(self, x: torch.Tensor) -> None:
        cdev = torch.as_tensor(self.centroids, device=self.device)
        a, _ = assign_clusters(x, cdev)
        a_np = a.cpu().numpy()
        order = np.argsort(a_np, kind="stable")
        order_d = torch.as_tensor(order, device=self.device)
        xs = x[order_d]  # list order
        if self.residual:
            xs = xs - cdev[a[order_d]]
        if self.dtype == "int8":
            rms = torch.sqrt(torch.mean(xs * xs))
            amax = torch.max(torch.abs(xs))
            scale = float(torch.clamp_min(
                torch.minimum(amax, 4.0 * rms) / f32_const(127.0, xs), 1e-12))
            payload = torch.clamp(torch.round(xs / f32_const(scale, xs)), -127,
                                  127).to(torch.int8)
        else:
            scale = 1.0
            payload = xs.to(_ARENA_DTYPES[self.dtype])
        n = int(payload.shape[0])
        counts = np.bincount(a_np, minlength=self.nlist)
        if self.residual:
            # tile-span cap (_capacity_layout doc): skewed list sizes may
            # force hole padding; the identity layout costs nothing otherwise
            offsets, dest = self._capacity_layout(counts)
        else:  # whole rows: no cap (the reference caps residual arenas only)
            offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            dest = np.arange(n, dtype=np.int64)
        extent = int(offsets[-1])
        n_pad = -(-extent // self.tile_n) * self.tile_n
        arena = torch.zeros((n_pad, self.dim), dtype=payload.dtype, device=self.device)
        arena[torch.as_tensor(dest, device=self.device)] = payload
        if extent != n:
            ids = np.full(n_pad, -1, np.int64)
            ids[dest] = order
            self._list_lens = counts.astype(np.int64)
        else:  # the reference keeps int64 ids for residual, int32 for whole rows
            ids = order.astype(np.int64 if self.residual else np.int32)
        self._set_arena(arena, ids, offsets, extent, scale)

    @classmethod
    def build_device_streaming(
        cls, chunk_fn, n_chunks: int, nlist: int, train_sample: int = 262_144,
        centroids: np.ndarray | None = None, **kw,
    ) -> "BandIVFIndex":
        """Device-resident streaming build: only the (N,) assignments reach
        the host. ``chunk_fn(i) -> (n_i, D)`` f32 tensor must be
        deterministic: chunks are produced twice (pass 1: train on the first
        chunk, assign every chunk; pass 2: quantize and scatter into the
        arena at positions from the host-side native counting sort). Peak
        device memory ≈ int8 arena + one f32 chunk. ``centroids``, when
        given, is the final, locality-ordered quantizer and skips training.
        The first chunk sets the int8 scale (of residuals, or of whole rows
        with ``residual=False``). The arena is int8 either way, as the
        reference's."""
        from cloudvectordb_tpu_torch.utils.native import arena_sort

        idx = None
        cdev = None
        assigns: list[np.ndarray] = []
        sizes: list[int] = []
        scale = 0.0
        for ci in range(n_chunks):
            chunk = chunk_fn(ci)
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, **kw)
                if idx.dtype != "int8":
                    raise ValueError("device-streaming is the int8 path")
            chunk = torch.as_tensor(chunk, dtype=torch.float32).to(idx.device)
            if cdev is None:
                if centroids is None:
                    ns = min(train_sample, chunk.shape[0])
                    c, _ = train_kmeans(chunk[:ns], nlist, iters=idx.kmeans_iters,
                                        seed=idx.seed)
                    c = c.cpu().numpy()
                    centroids = c[order_centroids(c)]
                idx.centroids = np.asarray(centroids, np.float32)
                cdev = torch.as_tensor(idx.centroids, device=idx.device)
            a, _ = assign_clusters(chunk, cdev)
            if scale == 0.0:  # first chunk sets the scale
                enc = chunk - cdev[a] if idx.residual else chunk
                rms = float(torch.sqrt(torch.mean(enc * enc)))
                amax = float(torch.max(torch.abs(enc)))
                scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
                enc = None
            assigns.append(a.cpu().numpy().astype(np.int32))
            sizes.append(int(chunk.shape[0]))
            chunk = a = None  # one f32 chunk resident at a time
        if idx is None:
            raise ValueError("empty stream")

        assign_all = np.concatenate(assigns)
        n = assign_all.shape[0]
        order, offsets = arena_sort(assign_all, nlist)
        counts = np.diff(offsets)
        if idx.residual:  # tile-span cap, as in _populate
            offsets, cap_dest = idx._capacity_layout(counts)
        else:
            cap_dest = np.arange(n, dtype=np.int64)
        extent = int(offsets[-1])
        dest = np.empty(n, np.int64)
        dest[order] = cap_dest  # source row -> arena position
        n_pad = -(-extent // idx.tile_n) * idx.tile_n
        arena = torch.zeros((n_pad, idx.dim), dtype=torch.int8, device=idx.device)
        # the f32 value the reference divides by (its scale rides into jit
        # as a weakly typed f32 constant)
        scale_t = f32_const(scale, arena)
        base = 0
        for ci in range(n_chunks):
            chunk = torch.as_tensor(chunk_fn(ci), dtype=torch.float32).to(idx.device)
            d = torch.as_tensor(dest[base : base + sizes[ci]], device=idx.device)
            if idx.residual:
                a_dev = torch.as_tensor(assigns[ci], device=idx.device).long()
                chunk = chunk - cdev[a_dev]
            q8 = torch.clamp(torch.round(chunk / scale_t), -127, 127).to(torch.int8)
            # the reference's donated scatter (``ar.at[d].set(q8)``) becomes an
            # in-place write into the preallocated arena
            arena[d] = q8
            base += sizes[ci]
            chunk = q8 = None
        if extent != n:  # tile-span cap forced hole padding
            ids = np.full(n_pad, -1, np.int64)
            ids[dest] = np.arange(n, dtype=np.int64)  # global id = source row
            idx._list_lens = counts.astype(np.int64)
        else:
            ids = order.astype(np.int64)
        idx._set_arena(arena, ids, offsets, extent, scale)
        return idx

    def _set_arena(self, arena: torch.Tensor, ids: np.ndarray,
                   offsets: np.ndarray, extent: int, scale: float) -> None:
        self._payload = arena
        self._ids = ids
        self._offsets = np.asarray(offsets, np.int64)
        self._n = extent
        self._scale = scale
        self._tile_window = self._compute_tile_window()
        if self.residual:
            self._build_residual_aux()
        self._dev = None

    def _capacity_layout(self, counts: np.ndarray):
        """Capacity offsets + per-sorted-row destination, with the TILE-SPAN
        CAP applied (each list's capacity is its count: the reference's
        separate ``caps`` exist for slack arenas, not ported yet): no arena
        tile may span more than ``_W_CAP`` list
        indices. When the (W_CAP+1)-th list would begin inside the current
        tile, the layout pads to the next tile boundary first; the holes are
        masked like padding. Healthy data inserts no padding and the layout
        equals the plain cumsum.

        Returns (offsets_cap (nlist+1,), dest (n,)) where dest[i] is the
        arena position of the i-th list-sorted row (each list's rows sit at
        the start of its capacity segment)."""
        counts = counts.astype(np.int64)
        tile_n = self.tile_n
        starts = np.empty(len(counts), np.int64)
        off = 0
        tile_of = -1
        in_tile = 0
        for li, c in enumerate(counts):
            t = off // tile_n
            if t != tile_of:
                tile_of, in_tile = t, 0
            in_tile += 1
            if in_tile > _W_CAP:
                off = (t + 1) * tile_n
                tile_of, in_tile = t + 1, 1
            starts[li] = off
            off += int(c)
        offsets = np.concatenate([starts, [off]]).astype(np.int64)
        start = np.concatenate([[0], np.cumsum(counts)])
        dest = (np.arange(int(counts.sum()), dtype=np.int64)
                - np.repeat(start[:-1], counts)
                + np.repeat(offsets[:-1], counts))
        return offsets, dest

    def _build_residual_aux(self) -> None:
        """Per-row LOCAL list index within its tile window, per-tile centroid
        matrices (n_tiles, W, D) and the per-tile-list valid_end table, all
        derived from the capacity offsets + list lengths."""
        n = self._n  # arena extent, including holes
        n_pad = int(self._payload.shape[0])
        tw = self._tile_window  # (n_tiles, W)
        assigns = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
        row_tile = np.arange(n) // self.tile_n
        local = assigns - tw[row_tile, 0]
        w = tw.shape[1]
        assert local.min(initial=0) >= 0 and local.max(initial=0) < w
        assert w <= 256, (
            f"per-tile window W={w} overflows the uint8 local index — a "
            "layout path skipped the tile-span cap (_capacity_layout)")
        loc = np.zeros((1, n_pad), np.uint8)
        loc[0, :n] = local.astype(np.uint8)
        self._local = loc
        self._centroid_tiles = np.ascontiguousarray(self.centroids[tw]).astype(np.float32)
        lens = (self._list_lens if self._list_lens is not None
                else np.diff(self._offsets))
        self._valid_end = (self._offsets[:-1][tw] + lens[tw]).astype(np.int32)

    def _compute_tile_window(self) -> np.ndarray:
        """(n_tiles, W) list ids intersecting each arena tile (rows padded by
        repeating the last id) — drives device-side tile scoring."""
        n_rows = int(self._payload.shape[0])
        n_tiles = n_rows // self.tile_n
        starts = np.arange(n_tiles, dtype=np.int64) * self.tile_n
        ends = np.minimum(starts + self.tile_n - 1, max(self._n - 1, 0))
        fl = np.clip(np.searchsorted(self._offsets, starts, side="right") - 1,
                     0, self.nlist - 1)
        ll = np.clip(np.searchsorted(self._offsets, ends, side="right") - 1,
                     0, self.nlist - 1)
        w = int((ll - fl).max()) + 1 if n_tiles else 1
        window = fl[:, None] + np.arange(w)[None, :]
        window = np.minimum(window, ll[:, None])
        return np.clip(window, 0, self.nlist - 1).astype(np.int32)

    # -- search -----------------------------------------------------------
    def _device_state(self) -> dict:
        if self._dev is None:
            dev = self.device
            self._dev = dict(
                payload=self._payload,
                centroids=torch.as_tensor(self.centroids, dtype=torch.float32, device=dev),
                ids=torch.as_tensor(self._ids.astype(np.int32), device=dev),
                tile_window=torch.as_tensor(self._tile_window, device=dev).long(),
            )
            if self.residual:
                self._dev.update(
                    local=torch.as_tensor(self._local, device=dev),
                    centroid_tiles=torch.as_tensor(self._centroid_tiles, device=dev).to(
                        torch.bfloat16),
                    valid_end=torch.as_tensor(self._valid_end, device=dev),
                )
        return self._dev

    def search(self, queries, k: int, nprobe: int = 32, strategy: str = "tiles",
               p_tiles: int = 0, scoring: str = "hybrid", tile_q: int | None = None,
               top2: bool | None = None):
        """Numpy in, numpy out: (scores (Q, k) f32, ids (Q, k) int64).

        strategy='tiles' (default): device-planned, query-clustered tile
        probing in one dispatch; compute ∝ p_tiles/n_tiles of a full scan.
        p_tiles=0 and tile_q=None take the tuned op point, else the
        span-aware auto budget. strategy='band' (whole-row arenas): each
        query group scans a contiguous band of tiles (``_search_band``).
        scoring on int8 arenas: residual arenas score the residual with
        int8 queries for 'hybrid' and 'int8' ('precise' is not ported yet);
        whole-row arenas score bf16 queries against the int8 rows for
        'hybrid' and 'precise' and int8 x int8 for 'int8'. top2 is not
        ported yet."""
        assert self._n, "empty index"
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        self._refuse_top2(top2)
        if strategy == "band":
            if self.residual:
                raise ValueError("band strategy lacks the centroid term; use tiles")
            return self._search_band(queries, k, nprobe)
        if strategy != "tiles":
            raise ValueError(f"unknown strategy {strategy!r}")
        p_tiles, tq = self._resolve_knobs(nq, nprobe, p_tiles, tile_q)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)])
        v, gids = self._tiles_kernel_dispatch(
            torch.as_tensor(qp, device=self.device), k, p_tiles, tq, scoring)
        return v[:nq].cpu().numpy(), gids[:nq].cpu().numpy().astype(np.int64)

    def search_device(self, queries, k: int, nprobe: int = 32,
                      p_tiles: int = 0, scoring: str = "hybrid",
                      tile_q: int | None = None, top2: bool | None = None):
        """All-device serving path: ``queries`` is (or becomes) a (B, D) f32
        tensor on the index's device and the returned (scores (B, k) f32,
        ids (B, k) int32) stay there — no host transfer or sync in the call.
        Knobs resolve as in ``search()``."""
        assert self._n, "empty index"
        self._refuse_top2(top2)
        queries = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        nq = queries.shape[0]
        p_tiles, tq = self._resolve_knobs(nq, nprobe, p_tiles, tile_q)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else torch.cat(
            [queries, queries[-1:].expand(q_pad - nq, -1)])
        v, gids = self._tiles_kernel_dispatch(qp, k, p_tiles, tq, scoring)
        return v[:nq], gids[:nq]

    def _refuse_top2(self, top2) -> None:
        if top2 is None:
            top2 = bool((self._op_point or {}).get("top2", False))
        if top2:
            raise NotImplementedError("top2 arrives with the l2/top2 slice")

    def _resolve_knobs(self, nq: int, nprobe: int, p_tiles: int, tile_q):
        """Tuned op point for knobs left at their sentinels, then
        _resolve_tiles_knobs."""
        op = self._op_point or {}
        if p_tiles <= 0:
            p_tiles = op.get("p_tiles", 0)
        if tile_q is None:
            tile_q = op.get("tile_q")
        return self._resolve_tiles_knobs(nq, nprobe, p_tiles, tile_q)

    def _tiles_kernel_dispatch(self, qp, k, p_tiles, tq, scoring):
        if scoring not in ("hybrid", "int8", "precise"):
            raise ValueError(f"unknown scoring {scoring!r}")
        st = self._device_state()
        if self.residual:
            return _tiles_resid_plan_search(
                qp, st["centroids"], st["payload"], st["local"],
                st["centroid_tiles"], self._scale, st["ids"],
                st["tile_window"], st["valid_end"],
                k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
                int8_q=(scoring != "precise"),
            )
        if self.dtype == "int8":
            # 'precise' maps to the hybrid scan: two-sided int8 is the
            # noisiest mode and serves scoring='int8' only
            int8 = True if scoring == "int8" else "hybrid"
        else:
            int8 = False
        return _tiles_plan_search(
            qp, st["centroids"], st["payload"], st["ids"], st["tile_window"],
            self._scale, self._n, k=k, p_tiles=p_tiles, tile_n=self.tile_n,
            tile_q=tq, int8=int8)

    def _search_band(self, queries: np.ndarray, k: int, nprobe: int):
        """Contiguous-band search (whole-row arenas; kept for comparison:
        1-D id locality is weak in high dimensions, so bands prune poorly):
        the host plan (``_plan_band``), the band scan (K7) and the unsort."""
        nq = queries.shape[0]
        st = self._device_state()
        perm, q_dev, q_scale, band_start, band_tiles = self._plan_band(queries, nprobe)
        v, rows = band_topk(
            st["payload"], q_dev, band_start, k, band_tiles=band_tiles,
            tile_n=self.tile_n, tile_q=self.tile_q, int8=self.dtype == "int8",
            n_valid=self._n)
        v = v.cpu().numpy() * (q_scale * self._scale)
        gids = st["ids"][rows.long().clamp(0, self._n - 1)].cpu().numpy()

        # unsort: perm[pos] is the caller's index of the query at sorted
        # position pos; positions >= nq are padding
        out_v = np.empty((nq, v.shape[1]), np.float32)
        out_i = np.empty((nq, v.shape[1]), np.int64)
        out_v[perm[:nq]] = v[:nq]
        out_i[perm[:nq]] = gids[:nq]
        return out_v, out_i

    def _plan_band(self, queries: np.ndarray, nprobe: int):
        """Host band planning: each query's nprobe nearest lists give it an
        id band [lo, hi]; queries sort by band centre into groups of tile_q
        (the last query repeated to fill the last group); each group scans
        the arena tiles covering its union band, band_tiles of them (the
        widest band, bucketed to a power of two), its start clamped so the
        band ends inside the arena. Returns (perm, device queries in the
        score mode's type, (Q_pad, 1) f32 query scales, (n_qt,) int32
        band_start on the device, band_tiles)."""
        nq = queries.shape[0]
        nprobe = min(nprobe, self.nlist)
        st = self._device_state()
        _, probed = tiled_topk(st["centroids"], torch.as_tensor(queries, device=self.device),
                               nprobe, metric="l2", tile=min(8192, self.nlist))
        probed = probed.cpu().numpy()
        lo = probed.min(axis=1)
        hi = probed.max(axis=1)

        order = np.argsort(lo + hi, kind="stable")
        q_pad = -(-nq // self.tile_q) * self.tile_q
        perm = np.concatenate([order, np.full(q_pad - nq, order[-1])])
        q_sorted = queries[perm]
        lo_s, hi_s = lo[perm], hi[perm]

        n_tiles = int(self._payload.shape[0]) // self.tile_n
        n_qt = q_pad // self.tile_q
        t0 = np.empty(n_qt, np.int64)
        t1 = np.empty(n_qt, np.int64)
        for i in range(n_qt):
            sl = slice(i * self.tile_q, (i + 1) * self.tile_q)
            row_lo = self._offsets[lo_s[sl].min()]
            row_hi = self._offsets[hi_s[sl].max() + 1]
            t0[i] = row_lo // self.tile_n
            t1[i] = -(-max(int(row_hi), int(row_lo) + 1) // self.tile_n)
        band_tiles = min(_next_pow2(int((t1 - t0).max())), n_tiles)
        band_start = np.minimum(t0, n_tiles - band_tiles).astype(np.int32)

        if self.dtype == "int8":
            q_amax = np.maximum(np.abs(q_sorted).max(axis=1, keepdims=True), 1e-12)
            q_scale = q_amax / 127.0
            q_dev = torch.as_tensor(
                np.clip(np.round(q_sorted / q_scale), -127, 127).astype(np.int8),
                device=self.device)
        else:
            q_scale = np.ones((q_pad, 1), np.float32)
            q_dev = torch.as_tensor(q_sorted, device=self.device).to(st["payload"].dtype)
        return (perm, q_dev, q_scale,
                torch.as_tensor(band_start, device=self.device), band_tiles)

    def _resolve_tiles_knobs(self, nq, nprobe, p_tiles, tile_q):
        """Small-batch query-tile shrink + span-aware auto coverage."""
        n_tiles = int(self._payload.shape[0]) // self.tile_n
        tq = tile_q or self.tile_q
        if tile_q is None and nq < tq:
            # small batches: pad to the pow2 cover of the batch, not to a
            # full query group (bucketed: bounded distinct shapes)
            tq = max(8, _next_pow2(nq))
        if p_tiles <= 0:
            p_tiles = self._auto_p_tiles(nq, nprobe, n_tiles, tile_q=tq)
        return p_tiles, tq

    def _auto_p_tiles(self, nq: int, nprobe: int, n_tiles: int,
                      tile_q: int | None = None) -> int:
        """Span-aware tile budget. The planner shares ONE tile table across
        each group of `tile_q` sorted queries, so the budget must cover the
        group's union of relevant tiles: for g = min(tile_q, nq) queries
        spread over the locality-ordered lists the union spans
        ≈ min(nlist·g/nq, g·nprobe) lists; multiply by tiles-per-list and
        add a per-query margin."""
        tq = tile_q or self.tile_q
        g = min(tq, max(nq, 1))
        r = max(self._n, 1) / max(self.nlist, 1) / self.tile_n  # tiles/list
        span = min(self.nlist * g / max(nq, 1), float(g) * nprobe)
        margin = max(8.0, nprobe * max(r, 0.25))
        return int(min(n_tiles, max(8, int(np.ceil(span * r + margin)))))

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_tile_qs(self, nq: int) -> list[int]:
        """Query-tile sizes worth trying: smaller tiles make each group's
        shared tile table more specific, at more planning work."""
        cand = {self.tile_q, 32, 64, 128}
        return sorted(t for t in cand if t <= max(32, nq))

    def _tune_n_tiles(self) -> int:
        return int(self._payload.shape[0]) // self.tile_n

    def _tune_candidates(self, nq: int) -> list[dict]:
        n_tiles = self._tune_n_tiles()
        seen, out = set(), []
        for tq in self._tune_tile_qs(nq):
            base = self._auto_p_tiles(nq, 32, n_tiles, tile_q=tq)
            for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
                p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
                if (p, tq) not in seen:
                    seen.add((p, tq))
                    out.append({"p_tiles": p, "tile_q": tq})
                if p >= n_tiles:
                    break
        # scan cost ∝ p_tiles · query-groups; prefer larger tile_q at equal
        # coverage (fewer groups, one shared table each)
        out.sort(key=lambda c: (c["p_tiles"], -c["tile_q"]))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        # full tile coverage ≡ an exact scan up to arena quantization
        return {"p_tiles": self._tune_n_tiles()}

    # -- persistence ------------------------------------------------------
    def _state_arrays(self) -> dict:
        out = {
            "centroids": self.centroids,
            "payload": to_numpy(self._payload),
            "ids": self._ids,
            "offsets": self._offsets,
        }
        if self._list_lens is not None:
            out["list_lens"] = self._list_lens
        return out

    def _state_meta(self) -> dict:
        return {
            "nlist": self.nlist, "dtype": self.dtype, "scale": self._scale,
            "n": self._n, "kmeans_iters": self.kmeans_iters, "seed": self.seed,
            "tile_n": self.tile_n, "tile_q": self.tile_q,
            "residual": self.residual, "slack": self.slack,
            "next_id": self._gid_bound(),
        }

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, device: str | torch.device = DEFAULT
                   ) -> "BandIVFIndex":
        """Index from the reference's numpy state: ``meta`` as its
        ``_state_meta()`` (the manifest's "meta"), ``arrays`` as its
        ``_state_arrays()`` (centroids, payload, ids, offsets, list_lens).
        The derived tables (tile_window, local, centroid_tiles, valid_end)
        are recomputed here."""
        dim = int(np.asarray(arrays["centroids"]).shape[1])
        idx = cls(dim, meta["nlist"], meta["dtype"], meta["kmeans_iters"],
                  meta["seed"], meta["tile_n"], meta["tile_q"],
                  residual=meta.get("residual", False),
                  slack=meta.get("slack", 0.0), device=device)
        idx.centroids = np.array(arrays["centroids"], np.float32)  # off the mmap
        if "list_lens" in arrays:
            idx._list_lens = np.array(arrays["list_lens"], np.int64)
        payload = from_numpy(arrays["payload"], _ARENA_DTYPES[idx.dtype])
        idx._set_arena(payload.to(idx.device), np.array(arrays["ids"], np.int64),
                       np.asarray(arrays["offsets"], np.int64), int(meta["n"]),
                       float(meta["scale"]))
        idx._next_id = int(meta.get("next_id", 0))
        return idx

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "BandIVFIndex":
        if manifest.get("metric", "ip") != "ip":
            raise NotImplementedError("metric='l2' arrives with the l2/top2 slice")
        idx = cls.from_state(manifest["meta"], arrays, device=device)
        if idx.dim != manifest["dim"]:
            raise ValueError(f"manifest dim {manifest['dim']} != centroids {idx.dim}")
        return idx
