"""PQ decode-and-score scans (counterpart of cloudvectordb_tpu/ops/pallas_pq.py:
``pq_tiles_topk_pallas`` (K5) and ``pq_topk_pallas`` (K6)).

Each wrapper dispatches on the device of its tensors: CUDA tensors go to
the hand-written kernel (K5 and K6 are one kernel, ``csrc/pq_scan.cu``,
built and bound by ``ops/_cuda.py``), CPU tensors to the plain version
(``*_reference``). There is no third path and no fallback.

The contract, as the reference computes it in interpret mode. Codebooks and
centroid tiles are rounded to bf16 (``pallas_pq.py:413-415, 481``). Arena
row g of a scanned tile decodes to x̂[e] = cb[j][code[g, j]][e - j·dsub]
(j = e // dsub), plus in residual mode ct[tile, local[g], e], added in f32;
every element is one bf16 codeword value plus at most one bf16 centroid
value. The score is the f32 dot of the bf16-rounded query with that f32 x̂
(``:201-204``); rows g >= n_valid score -inf. (Mosaic on the TPU may have
truncated x̂ to bf16; the port follows interpret mode.) Scores go into the
bucketed slots of ops/band.py: table entry j merges into pool j % n_pools;
with ``top2`` each pool keeps two slots per bucket (``_bucket_merge_top2``),
slot 2·pid and 2·pid + 1. The pools lie side by side before the final
top-k, ties to the lower candidate. The kernel takes the same score in split
form on the tensor cores, q·(codewords) + q·ct[tile, local[g]] with the
second term formed once per table entry: the same bf16 products, summed in
another f32 order (held to these plain versions within 1e-4 on the card,
and by ``tests/port/test_torch_pq_kernel.py`` on the CPU).

K5's two further variants (``pallas_pq.py:205-249``). ``row_mask`` (N_pad,)
int8 allow bits: a row is a candidate iff g < n_valid and its bit is set.
``l2``: the key is q·x̂ - ‖x̂‖²/2. The plain version subtracts ‖x̂‖²/2 from
the decoded x̂ as interpret mode does; the kernel never forms x̂, so it adds
a per-row bias -‖x̂‖²/2 that ``pq_row_bias`` writes once per arena state (a
kernel of its own on CUDA; the index caches it) and the wrapper computes
when it is not given. The caller turns the key into -‖q - x̂‖².

K5 walks each query tile's table of arena tiles; K6 walks every tile of a
code-major (m, N) matrix with no residual term.

K5's segmented dispatch (``pallas_pq.py:364-388``): an arena past the
index's segment cap is scanned a segment at a time, and each segment keeps
its own bucketed slots and takes its own top-k; the segments' candidates
are joined in segment order with their row offsets and one stable top-k
merges them (ties to the earlier segment, then the earlier rank). So a
segment's pools hold the best rows of its own tiles, and the candidates are
a superset of the joined arena's. Two forms: the reference's (a tuple of
row-major segments, each with a trailing pad tile, and parallel tuples of
centroid tiles, local ids, n_valid, row masks and row biases) and
``segments=`` (the row count of each segment of one joined arena, which is
sliced into views: no copy, no pad tile). Table entries outside a segment
become its ``n_live_tiles``, and the scan skips an entry at or past
``n_live_tiles`` whole, before any read. An unfilled slot keeps the joined
dispatch's (-inf, row 0): the offset is added to filled slots only (the
reference adds it to every slot, pointing an unfilled one of segment s > 0
at a real row; ROADMAP.md queue 3). One launch a segment.
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.band import (
    SCAN_ALL, SCAN_QB, SCAN_SPAN, SCAN_TABLE, _bucket_merge, _bucket_merge_top2, _final_topk,
    _resolve_buckets)
from cloudvectordb_tpu_torch.ops.topk import NEG_INF, f32_const
from cloudvectordb_tpu_torch.utils.metrics import span


def _decode_rows(codes, local, cbf, ctf, g, tile_n: int):
    """f32 x̂ of arena rows ``g`` (any shape): the codewords of each row
    plus, with ``ctf``, its tile's centroid row of its local byte; (*g.shape,
    D)."""
    m = codes.shape[1]
    sub = torch.arange(m, device=codes.device)
    xhat = cbf[sub, codes[g].long()].reshape(*g.shape, -1)
    if ctf is not None:
        xhat = xhat + ctf[g // tile_n, local[g].long()]
    return xhat


def _pq_slots_reference(codes, local, cb, ct, q, tiles, *, tile_n: int, tile_q: int,
                        l_buckets: int, n_valid: int, n_pools: int, top2: bool,
                        row_mask=None, l2: bool = False, row_bias=None,
                        n_live_tiles: int | None = None):
    """Plain PQ slot scan: (n_slots, Q, L) f32 values and int32 arena rows.
    ``codes`` (N, m) uint8 rows (any strides), ``local`` (N,) uint8 or None,
    ``cb`` (m, ncode, dsub) and ``ct`` (n_tiles, W, D) bf16 (ct None: no
    residual term), ``q`` (Q, D) bf16, ``tiles`` (n_qt, S) int64 the arena
    tile of each query tile at each step. ``row_mask`` (N,) uint8 allow
    bytes; ``l2`` adds ``row_bias`` (N,) f32, or -‖x̂‖²/2 from the decoded
    rows when it is None. An entry at or past ``n_live_tiles`` is skipped:
    its rows are not decoded and score -inf, which changes no slot. Only
    tile-sized row blocks are gathered and decoded."""
    n, m = codes.shape
    nq, d = q.shape
    n_qt, steps = tiles.shape
    dev = codes.device
    cbf = cb.float()
    ctf = None if ct is None else ct.float()
    row_iota = torch.arange(tile_n, device=dev, dtype=torch.int64)
    half = f32_const(0.5, cbf)
    qt = q.float().view(n_qt, tile_q, d)
    n_slots = n_pools * (2 if top2 else 1)
    best_v = torch.full((n_slots, n_qt, tile_q, l_buckets), NEG_INF, device=dev)
    best_i = torch.zeros((n_slots, n_qt, tile_q, l_buckets), dtype=torch.int64, device=dev)
    # with skipped entries, only the live entries' rows are decoded, into a
    # zeroed (n_qt, tile_n, D) buffer: the product keeps its full shape, so a
    # tile's scores are bitwise the same at every step that reads it (the
    # top-2 merge's repeated-entry rule compares them) whichever other
    # entries are live (a batched product of another shape may sum in
    # another order on the card)
    xbuf = None if n_live_tiles is None else torch.zeros((n_qt, tile_n, d), device=dev)
    for j in range(steps):
        t = tiles[:, j]
        g = t[:, None] * tile_n + row_iota  # (n_qt, tile_n)
        gc = g.clamp(0, n - 1)
        live = g < n_valid
        if xbuf is None:
            xhat = _decode_rows(codes, local, cbf, ctf, gc, tile_n)
        else:
            keep = t < n_live_tiles
            if not bool(keep.any()):
                continue
            live = live & keep[:, None]
            sel = keep.nonzero()[:, 0]
            xbuf[sel] = _decode_rows(codes, local, cbf, ctf, gc[sel], tile_n)
            xhat = xbuf
        scores = torch.bmm(qt, xhat.transpose(1, 2))
        if l2:
            bias = -half * (xhat * xhat).sum(dim=2) if row_bias is None else row_bias[gc]
            scores = scores + bias[:, None, :]
        if xbuf is not None:
            xbuf[sel] = 0.0
        if row_mask is not None:
            live = live & (row_mask[gc] != 0)
        scores = torch.where(live[:, None, :], scores, NEG_INF)
        pid = j % n_pools
        base = t * tile_n
        if top2:
            s1, s2 = 2 * pid, 2 * pid + 1
            best_v[s1], best_i[s1], best_v[s2], best_i[s2] = _bucket_merge_top2(
                scores, base, l_buckets, best_v[s1], best_i[s1], best_v[s2], best_i[s2])
        else:
            best_v[pid], best_i[pid] = _bucket_merge(
                scores, base, l_buckets, best_v[pid], best_i[pid])
    return (best_v.view(n_slots, nq, l_buckets),
            best_i.view(n_slots, nq, l_buckets).int())


def _slots_topk(out_v, out_i, k: int):
    """Pools side by side, (Q, n_slots·L) candidates per query, then the
    stable top-k (``pallas_pq.py:498-502``)."""
    nq = out_v.shape[1]
    cand_v = out_v.permute(1, 0, 2).reshape(nq, -1)
    cand_i = out_i.permute(1, 0, 2).reshape(nq, -1)
    return _final_topk(cand_v, cand_i, k)


def _pq_slots(source: int, codes, local, cb, ct, q, table, steps: int, *, tile_n: int,
              tile_q: int, l_buckets: int, n_valid: int, n_pools: int, top2: bool,
              plain: bool, row_mask=None, l2: bool = False, row_bias=None,
              n_live_tiles: int | None = None):
    """(n_slots, Q, L) slots of a PQ scan: the plain version when ``plain``
    or on CPU tensors, the kernel (csrc/pq_scan.cu) on CUDA tensors, which
    takes the l2 key as ``row_bias`` (computed here when None). Table
    entries at or past ``n_live_tiles`` are skipped.
    Returns (values, rows, block_q): the queries one block of the launch
    held, 0 where the plain version ran."""
    dev = codes.device
    if plain or dev.type == "cpu":
        step = torch.arange(steps, device=dev, dtype=torch.int64)
        tiles = step[None, :] if source == SCAN_ALL else table.long()
        out = _pq_slots_reference(codes, local, cb, ct, q, tiles, tile_n=tile_n,
                                  tile_q=tile_q, l_buckets=l_buckets, n_valid=n_valid,
                                  n_pools=n_pools, top2=top2, row_mask=row_mask, l2=l2,
                                  row_bias=row_bias, n_live_tiles=n_live_tiles)
        return (*out, 0)
    if dev.type != "cuda":
        raise NotImplementedError(f"no PQ scan for {dev.type} tensors")
    from cloudvectordb_tpu_torch.ops import _cuda

    if l2 and row_bias is None:
        row_bias = pq_row_bias(codes, local, cb, ct, tile_n=tile_n)
    return _cuda.pq_scan_slots(
        source, codes, local, cb, ct, q,
        None if table is None else table.to(torch.int32).contiguous(),
        row_mask, row_bias if l2 else None,
        n_qt=q.shape[0] // tile_q, tile_q=tile_q, steps=steps, tile_n=tile_n,
        l_buckets=l_buckets, n_valid=n_valid, n_pools=n_pools, top2=top2,
        n_live_tiles=n_live_tiles)


def pq_row_bias_reference(codes, local, codebooks, centroid_tiles, tile_n: int,
                          chunk: int = 1 << 16):
    """Plain version of ``pq_row_bias``: -‖x̂‖²/2 of the decoded f32 rows,
    ``chunk`` rows at a time."""
    cbf = codebooks.to(torch.bfloat16).float()
    ctf = None if centroid_tiles is None else centroid_tiles.to(torch.bfloat16).float()
    half = f32_const(0.5, cbf)
    n = codes.shape[0]
    parts = []
    for lo in range(0, n, chunk):
        g = torch.arange(lo, min(n, lo + chunk), device=codes.device)
        xhat = _decode_rows(codes, local, cbf, ctf, g, tile_n)
        parts.append(-half * (xhat * xhat).sum(dim=1))
    return torch.cat(parts) if parts else torch.zeros(0, device=codes.device)


def pq_row_bias(codes, local, codebooks, centroid_tiles, tile_n: int):
    """(N,) f32 l2 bias -‖x̂‖²/2 of every row of the (N, m) uint8 codes
    (x̂: the bf16 codewords plus, with ``centroid_tiles``, the bf16 centroid
    row of the row's local byte in its tile, summed in f32): K5's l2 key
    term. It depends on the arena only, so an index computes it once per
    arena state. CUDA tensors launch the hand-written kernel
    (csrc/pq_scan.cu ``pq_bias_kernel``); CPU tensors run the plain version."""
    n, m = codes.shape
    if (centroid_tiles is None) != (local is None) or (
            local is not None and local.numel() != n):
        raise ValueError("the residual term needs (N,) local bytes and centroid tiles")
    local = None if local is None else local.reshape(-1)
    dev = codes.device
    if dev.type == "cuda":
        from cloudvectordb_tpu_torch.ops import _cuda

        out = _cuda.pq_row_bias(
            codes, local,
            codebooks.to(torch.bfloat16).contiguous(),
            None if centroid_tiles is None else centroid_tiles.to(torch.bfloat16).contiguous(),
            tile_n=tile_n)
        pq_row_bias.launches += 1
        return out
    if dev.type != "cpu":
        raise NotImplementedError(f"no pq_row_bias path for {dev.type} tensors")
    return pq_row_bias_reference(codes, local, codebooks, centroid_tiles, tile_n)


def _check_devices(*ts) -> None:
    devices = {t.device for t in ts if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def _tiles_args(codes_cm, codebooks, queries_sorted, tile_table, centroid_tiles, tile_n,
                tile_q, l_buckets, n_valid, row_major, local_ids, n_pools, n_live_tiles,
                row_mask, l2):
    """Validate K5's arguments on one arena (a segment, or all of it);
    return (codes (N, m) rows, local or None, bf16 codebooks, bf16 centroid
    tiles or None, bf16 queries, L, n_valid, (N,) uint8 row mask or None)."""
    residual = centroid_tiles is not None
    m, ncode, dsub = codebooks.shape
    if row_major:
        codes = codes_cm
        if residual:
            if local_ids is None:
                raise ValueError("row-major residual codes need local_ids")
            local = local_ids.reshape(-1)
        else:
            local = None
    else:  # code-major (m[+1], N): the local byte rides in row m
        codes = codes_cm[:m].T
        local = codes_cm[m] if residual else None
    n = codes.shape[0]
    if codes.dtype != torch.uint8 or codes.shape[1] != m:
        raise ValueError(f"codes {tuple(codes.shape)} {codes.dtype}: need (N, {m}) uint8")
    if ncode > 256:
        raise ValueError(f"{ncode} codewords do not fit uint8 codes")
    nq, d = queries_sorted.shape
    if d != m * dsub:
        raise ValueError(f"queries D={d} != m·dsub = {m * dsub}")
    if n % tile_n or nq % tile_q:
        raise ValueError(f"rows {n} / queries {nq} not multiples of "
                         f"tile_n {tile_n} / tile_q {tile_q}")
    if tile_table.dim() != 2 or tile_table.shape[0] != nq // tile_q:
        raise ValueError(f"tile_table {tuple(tile_table.shape)} needs {nq // tile_q} rows")
    if n_pools < 1:
        raise ValueError(f"n_pools={n_pools}")
    if n_live_tiles is not None and not 0 <= n_live_tiles <= n // tile_n:
        raise ValueError(f"n_live_tiles={n_live_tiles} outside 0..{n // tile_n}")
    ct = None
    if residual:
        if centroid_tiles.dim() != 3 or centroid_tiles.shape[0] != n // tile_n \
                or centroid_tiles.shape[2] != d:
            raise ValueError(f"centroid_tiles {tuple(centroid_tiles.shape)} != "
                             f"({n // tile_n}, W, {d})")
        if local.numel() != n or local.dtype != torch.uint8:
            raise ValueError(f"local ids: need ({n},) uint8")
        ct = centroid_tiles.to(torch.bfloat16).contiguous()
    if row_mask is not None:
        if row_mask.numel() != n or row_mask.dtype not in (torch.int8, torch.uint8, torch.bool):
            raise ValueError(f"row_mask: need ({n},) int8 allow bits, got "
                             f"{tuple(row_mask.shape)} {row_mask.dtype}")
        row_mask = row_mask.reshape(-1)
        row_mask = (row_mask.view(torch.uint8) if row_mask.dtype == torch.int8
                    else row_mask.to(torch.uint8))
    _check_devices(codes, local, codebooks, queries_sorted, tile_table, ct, row_mask)
    l_buckets = _resolve_buckets(tile_n, l_buckets)
    n_valid = n if n_valid is None else int(n_valid)
    return (codes, local, codebooks.to(torch.bfloat16).contiguous(), ct,
            queries_sorted.to(torch.bfloat16).contiguous(), l_buckets, n_valid, row_mask)


def _one_arena(codes_cm, codebooks, queries_sorted, tile_table, k, centroid_tiles, tile_n,
               tile_q, l_buckets, n_valid, row_major, local_ids, n_pools, n_live_tiles,
               row_mask, l2, top2, plain, row_bias):
    """K5 over one arena or one segment: (top-k values, rows, block_q as
    ``_pq_slots`` gives it)."""
    codes, local, cb, ct, q, l_buckets, n_valid, row_mask = _tiles_args(
        codes_cm, codebooks, queries_sorted, tile_table, centroid_tiles, tile_n, tile_q,
        l_buckets, n_valid, row_major, local_ids, n_pools, n_live_tiles, row_mask, l2)
    if row_bias is not None:
        if row_bias.numel() != codes.shape[0]:
            raise ValueError(f"row_bias: {row_bias.numel()} entries for {codes.shape[0]} rows")
        row_bias = row_bias.reshape(-1).float()
    out_v, out_i, block_q = _pq_slots(
        SCAN_TABLE, codes, local, cb, ct, q, tile_table, tile_table.shape[1],
        tile_n=tile_n, tile_q=tile_q, l_buckets=l_buckets, n_valid=n_valid,
        n_pools=n_pools, top2=top2, plain=plain, row_mask=row_mask, l2=l2,
        row_bias=row_bias, n_live_tiles=n_live_tiles)
    return (*_slots_topk(out_v, out_i, k), block_q)


def _parallel(x, n_seg: int, name: str) -> list:
    """A segment tuple's parallel argument as a list (None: None each)."""
    if x is None:
        return [None] * n_seg
    if not isinstance(x, (list, tuple)) or len(x) != n_seg:
        raise ValueError(f"{name}: need a tuple of {n_seg}, one a segment")
    return list(x)


def _segment_parts(codes_cm, centroid_tiles, local_ids, n_valid, row_mask, row_bias,
                   segments, tile_n: int) -> list:
    """(codes, centroid tiles, local ids, n_valid, row mask, row bias,
    n_live_tiles) of each segment: the reference's tuple of segments (each
    with its pad tile, the other arguments parallel tuples), or views of
    one joined arena cut into ``segments`` (row counts, multiples of tile_n,
    summing to its rows)."""
    if isinstance(codes_cm, (list, tuple)):
        if segments is not None:
            raise ValueError("segments= cuts one joined arena, not a tuple of segments")
        n_seg = len(codes_cm)
        live = []
        for seg in codes_cm:
            if seg.dim() != 2 or seg.shape[0] % tile_n or seg.shape[0] < 2 * tile_n:
                raise ValueError(f"segment {tuple(seg.shape)}: need whole tiles of "
                                 f"{tile_n} rows and a trailing pad tile")
            live.append(seg.shape[0] // tile_n - 1)
        nv = ([t * tile_n for t in live] if n_valid is None
              else [int(v) for v in _parallel(n_valid, n_seg, "n_valid")])
        return list(zip(codes_cm, _parallel(centroid_tiles, n_seg, "centroid_tiles"),
                        _parallel(local_ids, n_seg, "local_ids"), nv,
                        _parallel(row_mask, n_seg, "row_mask"),
                        _parallel(row_bias, n_seg, "row_bias"), live))
    rows = [int(r) for r in segments]
    n = codes_cm.shape[0]
    if sum(rows) != n or any(r <= 0 or r % tile_n for r in rows):
        raise ValueError(f"segments {rows}: need positive multiples of tile_n {tile_n} "
                         f"summing to the arena's {n} rows")
    n_valid = n if n_valid is None else int(n_valid)
    local, mask, bias = (None if x is None else x.reshape(-1)
                         for x in (local_ids, row_mask, row_bias))
    out, off = [], 0
    for r in rows:
        sl, tl = slice(off, off + r), slice(off // tile_n, (off + r) // tile_n)
        out.append((codes_cm[sl], _cut(centroid_tiles, tl), _cut(local, sl),
                    min(max(n_valid - off, 0), r), _cut(mask, sl), _cut(bias, sl), r // tile_n))
        off += r
    return out


def _cut(x, sl: slice):
    return None if x is None else x[sl]


def _pq_tiles_topk(codes_cm, codebooks, queries_sorted, tile_table, k, centroid_tiles,
                   tile_n, tile_q, l_buckets, n_valid, row_major, local_ids, n_pools,
                   n_live_tiles, row_mask, l2, top2, plain, row_bias=None, segments=None):
    """(values, rows, reads): ``reads`` is the whole-tile reads the
    launches' grids schedule, each table entry counted ceil(tile_q / QB)
    times at the block width QB of the launch that reads it (SCAN_QB where
    the plain version ran); an int, or a 0-d tensor where segments launch
    at different widths (read it only when it is wanted: a sync)."""
    if row_bias is not None and not l2:
        raise ValueError("row_bias is the l2 key's; pass l2=True")
    per_entry = lambda qb: -(-tile_q // (qb or SCAN_QB))  # noqa: E731
    if not isinstance(codes_cm, (list, tuple)) and segments is None:
        v, i, block_q = _one_arena(
            codes_cm, codebooks, queries_sorted, tile_table, k, centroid_tiles, tile_n,
            tile_q, l_buckets, n_valid, row_major, local_ids, n_pools, n_live_tiles, row_mask,
            l2, top2, plain, row_bias)
        pq_tiles_topk.launches += block_q > 0
        return v, i, tile_table.numel() * per_entry(block_q)
    if not row_major or n_live_tiles is not None:
        raise ValueError("a segmented arena is row-major and sets each segment's "
                         "n_live_tiles itself")
    # every entry counts at the first segment's width, plus the difference
    # in the segment it lies in (an entry in none is read by no launch)
    outs_v, outs_i, t_off, first, reads = [], [], 0, None, 0
    for codes, ct, local, nv, rm, rb, live in _segment_parts(
            codes_cm, centroid_tiles, local_ids, n_valid, row_mask, row_bias, segments,
            tile_n):
        # entries outside the segment point at its pad tile, which is skipped
        in_seg = (tile_table >= t_off) & (tile_table < t_off + live)
        table = torch.where(in_seg, tile_table - t_off, live).to(torch.int32)
        v, i, block_q = _one_arena(codes, codebooks, queries_sorted, table, k, ct, tile_n,
                                   tile_q, l_buckets, nv, True, local, n_pools, live, rm,
                                   l2, top2, plain, rb)
        pq_tiles_topk.launches += block_q > 0
        pq_tiles_topk.seg_launches += block_q > 0
        first = per_entry(block_q) if first is None else first
        if per_entry(block_q) != first:
            reads = reads + in_seg.sum() * (per_entry(block_q) - first)
        outs_v.append(v)
        outs_i.append(torch.where(v > NEG_INF, i + t_off * tile_n, i))
        t_off += live
    v, i = _final_topk(torch.cat(outs_v, 1), torch.cat(outs_i, 1), k)
    return v, i, reads + tile_table.numel() * first


def pq_tiles_topk(
    codes_cm,        # (m[+1], N_pad) uint8 code-major, or (N_pad, m) with row_major
    codebooks,       # (m, 2**nbits, dsub) codebooks (rounded to bf16 here)
    queries_sorted,  # (Q_pad, D) pre-sorted queries (rounded to bf16 here)
    tile_table,      # (n_qt, P) int32 arena-tile ids (repeats harmless)
    k: int,
    centroid_tiles=None,  # (n_tiles, W, D) per-tile list centroids: residual mode
    tile_n: int = 1024,
    tile_q: int = 128,
    l_buckets: int = 0,
    n_valid=None,    # true row count; rows >= n_valid never become candidates
    row_major: bool = False,
    local_ids=None,  # (1, N_pad) or (N_pad,) uint8 local list byte (row_major + residual)
    n_pools: int = 1,  # independent bucket pools; table entry j -> pool j % n_pools
    n_live_tiles=None,  # table entries at or past this are skipped (one arena)
    row_mask=None,   # (1, N_pad) or (N_pad,) int8 allow bits (filtered search)
    l2: bool = False,  # rank by q·x̂ - ‖x̂‖²/2 (module docstring)
    top2: bool = False,  # best two distinct rows per bucket and pool
    row_bias=None,   # (N_pad,) f32 -‖x̂‖²/2 (pq_row_bias), computed if None
    segments=None,   # row counts of the segments of a joined row-major arena
):
    """K5: tile-table-pruned PQ search, inner product on reconstructions
    (or the l2 key): (Q_pad, k') f32 scores and int32 arena rows, k' =
    min(k, n_slots·L), or min(k, n_seg·k'') over segments (module
    docstring). A tuple ``codes_cm`` is the reference's segmented form: its
    ``centroid_tiles``, ``local_ids``, ``n_valid``, ``row_mask`` and
    ``row_bias`` are then parallel tuples. CUDA tensors launch the
    hand-written kernel, once a segment; CPU tensors run the plain
    version. A table entry lies in one segment, so the segments' launches
    read its tile once between them. The ``cvdb.scan`` span counts those
    reads as ops/band.py::scan_span does for K1, at the block width each
    launch reports (csrc/pq_scan.cu ``block_queries``: 32 or 64 queries)."""
    row_bytes = codebooks.shape[0] + (centroid_tiles is not None)  # codes, local byte
    with span(SCAN_SPAN) as sp:
        v, i, reads = _pq_tiles_topk(codes_cm, codebooks, queries_sorted, tile_table, k,
                                     centroid_tiles, tile_n, tile_q, l_buckets, n_valid,
                                     row_major, local_ids, n_pools, n_live_tiles, row_mask, l2,
                                     top2, plain=False, row_bias=row_bias, segments=segments)
        if sp is not None:  # a profiler records
            reads = int(reads)
            sp.counts.update(tile_reads=reads, tile_read_bytes=reads * tile_n * row_bytes)
    return v, i


def pq_tiles_topk_reference(codes_cm, codebooks, queries_sorted, tile_table, k: int,
                            centroid_tiles=None, tile_n: int = 1024, tile_q: int = 128,
                            l_buckets: int = 0, n_valid=None, row_major: bool = False,
                            local_ids=None, n_pools: int = 1, n_live_tiles=None,
                            row_mask=None, l2: bool = False, top2: bool = False,
                            row_bias=None, segments=None):
    """Plain PyTorch version of ``pq_tiles_topk`` on any device: the CPU path
    of the wrapper, and the kernel's yardstick on the card. With l2 and no
    ``row_bias`` the key subtracts ‖x̂‖²/2 of the decoded rows."""
    return _pq_tiles_topk(codes_cm, codebooks, queries_sorted, tile_table, k,
                          centroid_tiles, tile_n, tile_q, l_buckets, n_valid, row_major,
                          local_ids, n_pools, n_live_tiles, row_mask, l2, top2, plain=True,
                          row_bias=row_bias, segments=segments)[:2]


def _pq_topk(codes_cm, codebooks, queries, k, tile_n, l_buckets, plain):
    m, n = codes_cm.shape
    mc, ncode, dsub = codebooks.shape
    nq, d = queries.shape
    if codes_cm.dtype != torch.uint8 or mc != m or ncode > 256:
        raise ValueError(f"codes {tuple(codes_cm.shape)} {codes_cm.dtype} do not match "
                         f"codebooks {tuple(codebooks.shape)}")
    if d != m * dsub:
        raise ValueError(f"queries D={d} != m·dsub = {m * dsub}")
    _check_devices(codes_cm, codebooks, queries)
    l_buckets = _resolve_buckets(tile_n, l_buckets)
    # every query is scored against every row independently of the others,
    # so all queries form one query tile: the reference's tile_q, which only
    # pads the batch, has no counterpart here
    out_v, out_i, block_q = _pq_slots(
        SCAN_ALL, codes_cm.T, None, codebooks.to(torch.bfloat16).contiguous(), None,
        queries.to(torch.bfloat16).contiguous(), None, -(-n // tile_n), tile_n=tile_n,
        tile_q=nq, l_buckets=l_buckets, n_valid=n, n_pools=1, top2=False, plain=plain)
    pq_topk.launches += block_q > 0
    return _slots_topk(out_v, out_i, min(k, n))


def pq_topk(
    codes_cm,   # (m, N) uint8 code-major
    codebooks,  # (m, 2**nbits, dsub)
    queries,    # (Q, D), D = m·dsub
    k: int,
    tile_n: int = 2048,
    l_buckets: int = 0,
):
    """K6: top-k inner product over every PQ-coded row (non-residual):
    (Q, min(k, N)) f32 scores against the reconstructions and int32 rows.
    CUDA tensors launch the hand-written kernel; CPU tensors run the plain
    version."""
    return _pq_topk(codes_cm, codebooks, queries, k, tile_n, l_buckets, plain=False)


def pq_topk_reference(codes_cm, codebooks, queries, k: int, tile_n: int = 2048,
                      l_buckets: int = 0):
    """Plain PyTorch version of ``pq_topk`` on any device."""
    return _pq_topk(codes_cm, codebooks, queries, k, tile_n, l_buckets, plain=True)


#: kernel launches since the last reset (the card run resets and reads them);
#: ``seg_launches``: those of K5 made by the segmented dispatch
pq_tiles_topk.launches = 0
pq_tiles_topk.seg_launches = 0
pq_topk.launches = 0
pq_row_bias.launches = 0
