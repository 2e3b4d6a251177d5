#!/usr/bin/env python3
"""Planted faults against chip_smoke.py's holds of K1, K2, K3 and K7 (at
full shape; K1 also at small shapes), on one GPU: each hold must pass the
package's kernel and fail a kernel with a fault planted in it.

Run from the repository root::

    python3 scripts/torch_scan_hold_faults.py

It builds csrc/tiles_scan.cu (K2, K3, K7) and csrc/tiles_resid.cu (K1), and
copies of them with one fault planted each, written with the headers they
include to a temporary directory (the package's sources are not touched):

- ``entry`` (the tensor-core body, tc_scan.cuh): one step of every block is
  skipped, so its rows are never scored: the step in the middle of the
  block's share of the steps (for a band, the tiles nearest its queries);
- ``r`` (tc_scan.cuh): rows of r == 1 (the second row block of a tile at a
  slot) are never scored; only a plan with R > 1 has such rows;
- ``chunk`` (tc_scan.cuh): the second 128-byte chunk of every row's depth is
  dropped from every score;
- ``local`` (K1's epilogue): a row takes the centroid term of the next local
  list, not its own;
- ``valid_end`` (K1's epilogue): rows past their list's valid_end are scored;
- ``ve_plus1`` (K1's epilogue): the row at its list's valid_end is scored
  too (one slot past the end);
- ``mask`` (K1's epilogue): the row mask is not applied;
- ``bias`` (K1's epilogue): the l2 key drops the row's bias;
- ``dup`` (the top-2 merge, slot_merge.cuh): a repeated table entry's best
  row, already in slot 1, races for slot 2 too;
- ``cc_slot2_row`` (the CUDA-core body's top-2): slot 2 reports slot 1's
  row beside its own value;
- ``cc_runner_up`` (the CUDA-core body's top-2): a tile's runner-up never
  reaches slot 2; only a plan with R > 1 has runner-ups;
- ``sqnorm`` (the f32 body): the l2 bias drops |x|^2 (scores 2 q.x);
- ``last_tile`` (the rows of a flat scan): the ragged last tile is never
  scored.

Then it holds K1 against its exact f64 scores at two of chip_smoke.py's
small shapes (R 1 and R 4, D 768, valid_end cutting every list; there also
with a 50% row mask against ``mask``, with l2 against ``bias`` and with
top-2 over a table that repeats entries against ``dup``) and, as
chip_smoke.py does, over the residual index (12.5M x 768, nlist 4096) at
(p_tiles, tile_q) = (96, 32), every fault but valid_end there (the arena has
too few rows past a valid_end for the top-10 to see it); then, as
chip_smoke.py's mutation phase does, over the slack arena (slack 0.05) after
four rounds of 8,192 removes, whose freed slots keep their old bytes past
each list's valid_end, against ``valid_end`` and ``ve_plus1``; then the whole-row
int8 index on the same corpus and queries, holding K3 at (96, 32) with
hybrid queries (exact f64 scores) and int8 queries (values and ids equal
outright) and K7 at the band plan (equal outright); each at R 1 (L =
tile_n, the main path) and R 4 (l_buckets 512).
Then K2 at the flat cells' shapes, equal outright: f32 l2 over 1M x 128
SIFT-like integer rows against 10,000 such queries, int8 over 1M x 768 of
the corpus against the 4096 queries. Then K3's top-2 on the CUDA-core body
as chip_smoke.py's ``run_top2_routes`` holds it (exact f64 scores): f32
whole rows over the corpus's first 1M rows at (96, 32), and the deep
hybrid arena (D 3072) at its plan, each at R 1 and R 4 (the deep arena's
slot 2 reaches a top-10 only at R 4, measured: there the R 1 hold takes
no fault). One line per
(shape, build): passed, or the criteria it failed. Exits 1 unless the
package's kernels pass every hold and each faulted build fails every hold
it applies to.

Arguments name the groups of holds to run (k1, k1_mutated, k3_k7, k2,
k3_top2); none runs them all, e.g.::

    python3 scripts/torch_scan_hold_faults.py k3_top2
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as c  # noqa: E402
from cloudvectordb_tpu_torch.index.flat import FlatIndex  # noqa: E402
from cloudvectordb_tpu_torch.ops import _cuda, band  # noqa: E402
from cloudvectordb_tpu_torch.ops import flat_topk as flat  # noqa: E402

ROWS = "  auto rows = [&](int j, int r) { return epi.rows(qt, b0, j, r); };"
#: fault -> {source file: [(its text, the replacement)]}, each text found once
FAULTS = {
    "entry": {"tc_scan.cuh": [(ROWS, """  const int skip_ = (int)((2LL * blockIdx.x + 1) * a.steps / (2 * gridDim.x));
  auto rows = [&](int j, int r) {
    RowBlock x = epi.rows(qt, b0, j, r);
    if (j == skip_ && a.steps > 1) x.n_rows = 0;
    return x;
  };""")]},
    "r": {"tc_scan.cuh": [(ROWS, """  auto rows = [&](int j, int r) {
    RowBlock x = epi.rows(qt, b0, j, r);
    if (r == 1) x.n_rows = 0;
    return x;
  };""")]},
    "chunk": {"tc_scan.cuh": [("const int nsub = min(DEPTH, lay.row_pad - kc * DEPTH) / 32;",
                               "const int nsub = kc == 1 ? 0 : min(DEPTH, lay.row_pad - kc * DEPTH) "
                               "/ 32;")]},
    "local": {"tiles_resid.cu": [("(side + at.c)[qi * wp + li]",
                                  "(side + at.c)[qi * wp + (li + 1) % w]")]},
    "valid_end": {"tiles_resid.cu": [(
        "if (x.row0 + slot >= reinterpret_cast<const int32_t*>(side + at.ve)[li]) "
        "return -INFINITY;", "")]},
    "ve_plus1": {"tiles_resid.cu": [(
        "x.row0 + slot >= reinterpret_cast<const int32_t*>(side + at.ve)[li]",
        "x.row0 + slot > reinterpret_cast<const int32_t*>(side + at.ve)[li]")]},
    "mask": {"tiles_resid.cu": [(
        "if (side[at.mask + static_cast<int>(x.row0 & 3) + slot] == 0) return -INFINITY;",
        ";")]},
    "bias": {"tiles_resid.cu": [(
        "if constexpr (L2) return __fadd_rn(s, reinterpret_cast<const float*>(side + at.bias)"
        "[slot]);", "if constexpr (L2) return s;")]},
    "dup": {"slot_merge.cuh": [("const bool dup = !use_t && ni == i1;",
                                "const bool dup = false;")]},
    "cc_slot2_row": {"tiles_scan.cu": [("out_i2[o] = best_i[1][i][jj];",
                                        "out_i2[o] = best_i[0][i][jj];")]},
    "cc_runner_up": {"tiles_scan.cu": [("slot_merge2(tmx[0][i][jj], row, tmx[1][i][jj],",
                                        "slot_merge2(tmx[0][i][jj], row, -INFINITY,")]},
    "sqnorm": {"tiles_scan.cu": [("__fsub_rn(2.f * acc[i][jj], bias)", "2.f * acc[i][jj]")]},
    "last_tile": {"tiles_scan.cu": [(
        "x.n_rows = x.row0 < 0 ? 0 : (int)max(0LL, hi);",
        "x.n_rows = (x.row0 < 0 || (SRC == ALL && j == steps - 1)) ? 0 : (int)max(0LL, hi);")]},
}
LIBS = ("tiles_scan", "tiles_resid")


def build(out: Path) -> dict[str, dict[str, ctypes.CDLL]]:
    """{library: {"kernel": the package's build, fault: a faulted build}},
    a fault built into every library whose sources it edits, each bound as
    ops/_cuda.py binds the library."""
    csrc = _cuda._CSRC
    sources = {lib: {"kernel": csrc / f"{lib}.cu"} for lib in LIBS}
    for name, edits in FAULTS.items():
        tree = out / name
        tree.mkdir()
        for path in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
            text = path.read_text()
            for old, new in edits.get(path.name, []):
                if text.count(old) != 1:
                    raise RuntimeError(f"fault {name}: {old!r} is not in {path.name} once")
                text = text.replace(old, new)
            (tree / path.name).write_text(text)
        for lib in LIBS:
            if any(f.name in edits for f in _cuda._sources(csrc / f"{lib}.cu")):
                sources[lib][name] = tree / f"{lib}.cu"
    procs = {}
    for lib, builds in sources.items():
        for name, src in builds.items():
            so = out / f"lib{lib}_{name}.so"
            cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(src)]
            procs[lib, name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True))
    libs: dict[str, dict[str, ctypes.CDLL]] = {lib: {} for lib in LIBS}
    for (lib, name), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{lib} {name}: nvcc failed\n{err}")
        dll = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in _cuda._SIGNATURES[lib].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = restype
        libs[lib][name] = dll
    return libs


def hold(libs, lib: str, label: str, kernel, plain, faults: list[str], **how) -> list[str]:
    """Each build of ``lib`` through one hold (the plain version run once);
    returns what went wrong."""
    wrong = []
    ref = plain()
    for name in ["kernel", *faults]:
        _cuda._libs[lib] = libs[lib][name]
        try:
            c.compare(f"{label} [{name}]", kernel, lambda: ref, **how)
            if name != "kernel":
                wrong.append(f"{label}: fault {name} passed the hold")
        except AssertionError as e:
            c.log(f"[fault] {label} [{name}]: failed: {e}")
            if name == "kernel":
                wrong.append(f"{label}: the package's kernel failed the hold")
    _cuda._libs[lib] = libs[lib]["kernel"]
    return wrong


def holds_k1(libs, dev, chunk_fn, queries) -> list[str]:
    """K1 at the residual index's plan, and at chip_smoke.py's small shapes
    with valid_end cutting every list: the index's arena holds 12,500,992
    rows for 12.5M vectors, so at most 992 rows lie past a valid_end there,
    too few for a dropped mask to change a top-10."""
    wrong = []
    for seed, lb in ((0, 0), (1, 512)):
        a = c.random_resid_inputs(seed, dev)
        r_blocks = a["tile_n"] // (lb or a["tile_n"])
        faults = ["entry", "chunk", "local", "valid_end"] + (["r"] if r_blocks > 1 else [])
        wrong += hold(libs, "tiles_resid", f"K1 small shape R{r_blocks} W3 D768",
                      lambda: band.tiles_topk_resid(**a, k=c.K, l_buckets=lb),
                      lambda: band.tiles_topk_resid_reference(**a, k=c.K, l_buckets=lb),
                      faults, exact=c.resid_exact(a))
        a["tile_table"][:, 1] = a["tile_table"][:, 0]  # a repeat next to its first
        for variant, fault in (("masked", "mask"), ("l2", "bias"), ("top2", "dup")):
            v = c.variant_args(a, variant, np.random.default_rng(seed))
            wrong += hold(libs, "tiles_resid", f"K1 {variant} small shape R{r_blocks} W3 D768",
                          lambda v=v: band.tiles_topk_resid(**v, k=4 * c.K, l_buckets=lb),
                          lambda v=v: band.tiles_topk_resid_reference(**v, k=4 * c.K,
                                                                      l_buckets=lb),
                          [fault], exact=c.resid_exact(v))
    idx, _ = c.build_index(dev, chunk_fn, c.N_ROWS // c.CHUNK, True)
    p_tiles, tq = c.MAIN_OP
    args = c.k1_plan(idx, queries, p_tiles, tq)
    exact = c.resid_exact(args)
    for lb in (0, 512):
        r_blocks = idx.tile_n // (lb or idx.tile_n)
        faults = ["entry", "chunk", "local"] + (["r"] if r_blocks > 1 else [])
        wrong += hold(libs, "tiles_resid", f"K1 B{c.B} p{p_tiles} tq{tq} R{r_blocks}",
                      lambda: band.tiles_topk_resid(**args, k=c.K, l_buckets=lb),
                      lambda: band.tiles_topk_resid_reference(**args, k=c.K, l_buckets=lb),
                      faults, exact=exact)
    return wrong


def holds_k1_mutated(libs, dev, chunk_fn, queries) -> list[str]:
    """K1 at the main plan over chip_smoke.py's mutated slack arena: every
    list ends in freed slots that still hold the rows that were there."""
    idx, _, _, _ = c.slack_removed(dev, chunk_fn, c.N_ROWS // c.CHUNK)
    p_tiles, tq = c.MAIN_OP
    args = c.k1_plan(idx, queries, p_tiles, tq)
    return hold(libs, "tiles_resid", f"K1 mutated slack arena B{c.B} p{p_tiles} tq{tq}",
                lambda: band.tiles_topk_resid(**args, k=c.K),
                lambda: band.tiles_topk_resid_reference(**args, k=c.K),
                ["valid_end", "ve_plus1"], exact=c.resid_exact(args))


def holds_k3_k7(libs, dev, chunk_fn, queries) -> list[str]:
    idx, _ = c.build_index(dev, chunk_fn, c.N_ROWS // c.CHUNK, False)
    st = idx._device_state()
    p_tiles, tq = c.MAIN_OP
    q_s, table = c.k3_plan(idx, queries, p_tiles, tq)
    q_bf = q_s.to(torch.bfloat16)
    q8, _ = flat.quantize_queries(q_s)
    q8b, starts, band_tiles = c.k7_plan(idx, queries)
    exact = c.wholerow_exact(st["payload"], q_bf)
    wrong = []
    for lb in (0, 512):
        r_blocks = idx.tile_n // (lb or idx.tile_n)
        faults = ["entry", "r", "chunk"] if r_blocks > 1 else ["entry", "chunk"]
        for label, qk, int8, how in (("hybrid", q_bf, "hybrid", dict(exact=exact, tie=None)),
                                     ("int8", q8, True, dict(equal=True))):
            kw = dict(tile_n=idx.tile_n, tile_q=tq, int8=int8, n_valid=idx._n, l_buckets=lb)
            wrong += hold(
                libs, "tiles_scan", f"K3 {label} B{c.B} p{p_tiles} tq{tq} R{r_blocks}",
                lambda a=(qk, kw): band.tiles_topk(st["payload"], a[0], table, c.K, **a[1]),
                lambda a=(qk, kw): band.tiles_topk_reference(st["payload"], a[0], table, c.K,
                                                             **a[1]), faults, **how)
        kw7 = dict(tile_n=idx.tile_n, tile_q=idx.tile_q, int8=True, n_valid=idx._n,
                   l_buckets=lb)
        wrong += hold(
            libs, "tiles_scan", f"K7 int8 band plan B{c.B} band_tiles {band_tiles} R{r_blocks}",
            lambda: band.band_topk(st["payload"], q8b, starts, c.K, band_tiles, **kw7),
            lambda: band.band_topk_reference(st["payload"], q8b, starts, c.K, band_tiles, **kw7),
            faults, equal=True)
    return wrong


def holds_k2(libs, dev, chunk_fn, queries) -> list[str]:
    x = c.sift_like(dev, c.SIFT_ROWS, c.SIFT_D, seed=1)
    qs = c.sift_like(dev, c.SIFT_Q, c.SIFT_D, seed=2)
    sift = FlatIndex.build(x, metric="l2", dtype="float32", device=dev)
    wrong = hold(libs, "tiles_scan", f"K2 f32 l2 {c.SIFT_ROWS}x{c.SIFT_D} Q{c.SIFT_Q}",
                 lambda: flat.flat_topk(sift._vecs, qs, c.K, metric="l2",
                                        db_sqnorms=sift._sqnorms),
                 lambda: flat.flat_topk_reference(sift._vecs, qs, c.K, metric="l2",
                                                  db_sqnorms=sift._sqnorms),
                 ["sqnorm", "last_tile"], equal=True)
    del x, qs, sift
    flat8 = FlatIndex.build(torch.cat([chunk_fn(0), chunk_fn(1)]), metric="ip", dtype="int8",
                            device=dev)
    q8, _ = flat.quantize_queries(queries)
    wrong += hold(libs, "tiles_scan", f"K2 int8 ip {flat8.ntotal}x{c.D} Q{c.B}",
                  lambda: flat.flat_topk(flat8._vecs, q8, c.K),
                  lambda: flat.flat_topk_reference(flat8._vecs, q8, c.K), ["last_tile"],
                  equal=True)
    return wrong


def holds_k3_top2(libs, dev, chunk_fn, queries) -> list[str]:
    """K3 top-2 on the CUDA-core body: f32 whole rows and the deep hybrid
    arena, each at its plan with R 1 and R 4."""
    wrong = []
    idx = c.build_f32_rows(dev, chunk_fn)
    q_s, table = c.k3_plan(idx, queries, *c.MAIN_OP)
    wrong += holds_top2(libs, idx, q_s, table, False, c.MAIN_OP[1],
                        f"K3 f32 top2 B{c.B} {c.MAIN_OP}")
    del idx, q_s, table
    torch.cuda.empty_cache()
    idx, _, qd = c.build_deep(dev)
    q_s, table = c.k3_plan(idx, qd, *c.DEEP_OP)
    return wrong + holds_top2(libs, idx, q_s.to(torch.bfloat16), table, "hybrid", c.DEEP_OP[1],
                              f"K3 hybrid D{c.DEEP_D} top2 B{c.B} {c.DEEP_OP}",
                              slot2_at_r1=False)


def holds_top2(libs, idx, qk, table, int8, tq: int, label: str,
               slot2_at_r1: bool = True) -> list[str]:
    """K3 top-2 at R 1 and R 4 against the top-2 faults; ``slot2_at_r1``
    False where slot 2 never reaches a top-K at R 1 (each bucket holds one
    row a tile, and a query's neighbours fill one or two tiles), so that
    only R 4's hold can see a slot-2 fault."""
    st = idx._device_state()
    exact = c.wholerow_exact(st["payload"], qk)
    wrong = []
    for lb in (0, 512):
        r_blocks = idx.tile_n // (lb or idx.tile_n)
        kw = dict(tile_n=idx.tile_n, tile_q=tq, int8=int8, n_valid=idx._n,
                  l_buckets=lb, top2=True)
        wrong += hold(libs, "tiles_scan", f"{label} R{r_blocks}",
                      lambda: band.tiles_topk(st["payload"], qk, table, c.K, **kw),
                      lambda: band.tiles_topk_reference(st["payload"], qk, table, c.K, **kw),
                      (["cc_slot2_row"] if r_blocks > 1 or slot2_at_r1 else [])
                      + (["cc_runner_up"] if r_blocks > 1 else []),
                      exact=exact, tie=None)
    return wrong


HOLDS = {"k1": holds_k1, "k1_mutated": holds_k1_mutated, "k3_k7": holds_k3_k7,
         "k2": holds_k2, "k3_top2": holds_k3_top2}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_hold_faults: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(HOLDS)
    if any(n not in HOLDS for n in names):
        print(f"torch_scan_hold_faults: holds are {', '.join(HOLDS)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = c.card_line()
    c.log(f"[env] card: {card}")
    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        chunk_fn = c.make_corpus(dev, c.CHUNK)
        queries = c.make_queries(chunk_fn, dev, c.B)
        for name in names:
            wrong += HOLDS[name](libs, dev, chunk_fn, queries)
            torch.cuda.empty_cache()
    for line in wrong:
        c.log(f"[fault] WRONG: {line}")
    c.log(f"[fault] {card}: " + (f"{len(wrong)} wrong" if wrong else
                                 "every hold passed the kernel and failed each fault"))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
