"""The chip's published peaks and the work each part of a search batch
needs, counted from the cell's parameters and the index's sizes, never
from a tile table or a counter the program returns, so the count stays the
same whatever implements the scan.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit; the same table as ``chip_smoke.py``'s ``bound``): 3.35 TB/s of HBM,
int8 1,979 T op/s, bf16 989 T flop/s, f32 67 T flop/s outside the tensor
cores. A part's least time is the larger of its bytes at the memory rate
and its operations at its type's peak; each input byte is counted once,
each output byte once. Where a count depends on data (which tiles a plan
reaches) the most that the plan can reach is counted for bytes and what
the parameters fix for operations; the parts that depend on data alone
(the centroid term of each table entry) are left out, so a share can only
read low, never above 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def part(ops: float, kind: str, n_bytes: float) -> dict:
    return {"ops": float(ops), "kind": kind, "bytes": float(n_bytes)}


def least_s(p: dict) -> float:
    """The least seconds of one part: bytes at the memory rate or
    operations at the type's peak, whichever is larger."""
    return max(p["bytes"] / HBM_BYTES_PER_S, p["ops"] / PEAK_OPS_PER_S[p["kind"]])


def compute_s(parts: dict) -> float:
    """Seconds the parts' operations take at their types' peaks: the
    numerator of a share of the chip's peak (mfu)."""
    return sum(p["ops"] / PEAK_OPS_PER_S[p["kind"]] for p in parts.values())


def k1(batch: int, p_tiles: int, tile_q: int, tile_n: int, dim: int, n_tiles: int,
       k: int) -> dict:
    """K1, the residual-int8 tile scan: every query against the tile_n rows
    of each of its group's p_tiles tiles, 2·D int8 operations a pair; the
    bytes of the distinct tiles the ceil(B/tile_q) groups' tables can reach
    (int8 rows and their local list byte), the int8 queries and the (B, k)
    f32 scores and int32 rows written."""
    groups = -(-batch // tile_q)
    tiles = min(groups * p_tiles, n_tiles)
    return part(2.0 * batch * p_tiles * tile_n * dim, "int8",
                tiles * tile_n * (dim + 1) + batch * dim + batch * k * 8)


def k5(batch: int, p_tiles: int, tile_q: int, tile_n: int, m: int, nbits: int, dim: int,
       n_tiles: int, k_cand: int) -> dict:
    """K5, the PQ tile scan, by the least arithmetic of its function (the
    LUT-ADC form, as ``chip_smoke.py::pq_bound`` counts it): m adds a
    (query, row) pair scored plus the queries' lookup tables,
    B·m·2^nbits·(D/m) multiply-adds, at the f32 rate; the bytes of the
    distinct tiles' codes and local bytes, the bf16 queries and the
    (B, k_cand) candidates written."""
    groups = -(-batch // tile_q)
    tiles = min(groups * p_tiles, n_tiles)
    pairs = batch * p_tiles * tile_n
    ops = pairs * m + 2.0 * batch * m * (2 ** nbits) * (dim // m)
    return part(ops, "f32", tiles * tile_n * (m + 1) + batch * dim * 2 + batch * k_cand * 8)


def planner(batch: int, nlist: int, dim: int) -> dict:
    """The planner's f32 query-centroid product (TF32 off)."""
    return part(2.0 * batch * nlist * dim, "f32", (batch + nlist) * dim * 4 + batch * nlist * 4)


def exact_scan(batch: int, rows: int, dim: int, row_bytes: int = 4) -> dict:
    """An exact f32 scan of ``rows`` rows (the pending rows): B·rows·2D f32
    operations, the rows and queries read once."""
    return part(2.0 * batch * rows * dim, "f32", rows * dim * row_bytes + batch * dim * 4)


def rescore(batch: int, k_cand: int, dim: int) -> dict:
    """The int8 rescore of k_cand candidates a query: a gathered int8 row
    and 2·D f32 operations a candidate."""
    return part(2.0 * batch * k_cand * dim, "f32", batch * k_cand * dim + batch * dim * 4)


def rotation(batch: int, dim: int) -> dict:
    """The OPQ rotation of the queries, an f32 (B, D) x (D, D) product."""
    return part(2.0 * batch * dim * dim, "f32", (2 * batch + dim) * dim * 4)
