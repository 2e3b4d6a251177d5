#!/usr/bin/env python3
"""Planted faults against chip_smoke.py's full-shape holds of K3 and K7, on
one GPU: each hold must pass the package's kernel and fail a kernel that
skips rows or depth.

Run from the repository root::

    python3 scripts/torch_scan_hold_faults.py

It builds csrc/tiles_scan.cu and copies of it with one fault planted in the
tensor-core body each, written to a temporary directory (the package's
source is not touched):

- ``entry``: one step of every block is skipped, so its rows are never
  scored: the first table entry (TABLE: the query tile's best tile), or the
  band step in the middle of the query tile's share of the band (BAND);
- ``r``: rows of r == 1 (the second row block of a tile at a slot) are never
  scored; only a plan with R > 1 has such rows;
- ``chunk``: the second 128-byte chunk of every row's depth is dropped from
  every score.

Then, as chip_smoke.py's run_whole_row does, it builds the whole-row int8
index (12.5M x 768, nlist 4096) on the same corpus and queries, and holds
each build against the plain version: K3 at (p_tiles, tile_q) = (96, 32)
with hybrid queries (exact f64 scores) and int8 queries (values and ids
equal outright), and K7 at the band plan (equal outright), each at R 1 (L =
tile_n, the main path) and R 4 (l_buckets 512). One line per (shape,
build): passed, or the criteria it failed. Exits 1 unless the package's
kernel passes every hold and each faulted build fails every hold it applies
to.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as c  # noqa: E402
from cloudvectordb_tpu_torch.ops import _cuda, band  # noqa: E402
from cloudvectordb_tpu_torch.ops import flat_topk as flat  # noqa: E402

ROW_BLOCK = "x.n_rows = x.row0 < 0 ? 0 : (int)max(0LL, hi);"
#: fault -> (text of csrc/tiles_scan.cu, its replacement), each found once
FAULTS = {
    "entry": [(ROW_BLOCK, """const int n_qt = gridDim.x / ((a.tile_q + C::QB - 1) / C::QB);
  const int skip = SRC == BAND ? (2 * qt + 1) * a.steps / (2 * n_qt) : 0;
  x.n_rows = (x.row0 < 0 || (j == skip && a.steps > 1)) ? 0 : (int)max(0LL, hi);""")],
    "r": [(ROW_BLOCK, "x.n_rows = (x.row0 < 0 || r == 1) ? 0 : (int)max(0LL, hi);")],
    "chunk": [("const int nsub = min(DEPTH, lay.row_pad - kc * DEPTH) / 32;",
               "const int nsub = kc == 1 ? 0 : min(DEPTH, lay.row_pad - kc * DEPTH) / 32;")],
}


def build(out: Path) -> dict[str, ctypes.CDLL]:
    """The package's kernel ("kernel") and one build per fault, bound as
    ops/_cuda.py binds tiles_scan."""
    text = (_cuda._CSRC / "tiles_scan.cu").read_text()
    sources = {"kernel": _cuda._CSRC / "tiles_scan.cu"}
    for name, edits in FAULTS.items():
        planted = text
        for old, new in edits:
            if planted.count(old) != 1:
                raise RuntimeError(f"fault {name}: {old!r} is not in tiles_scan.cu once")
            planted = planted.replace(old, new)
        sources[name] = out / f"tiles_scan_{name}.cu"
        sources[name].write_text(planted)
    procs = {}
    for name, src in sources.items():
        lib = out / f"libtiles_scan_{name}.so"
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(_cuda._CSRC), "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        dll = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in _cuda._SIGNATURES["tiles_scan"].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = restype
        libs[name] = dll
    return libs


def hold(libs, label: str, kernel, plain, faults: list[str], **how) -> list[str]:
    """Each build through one hold (the plain version run once); returns
    what went wrong."""
    wrong = []
    ref = plain()
    for name in ["kernel", *faults]:
        _cuda._libs["tiles_scan"] = libs[name]
        try:
            c.compare(f"{label} [{name}]", kernel, lambda: ref, **how)
            if name != "kernel":
                wrong.append(f"{label}: fault {name} passed the hold")
        except AssertionError as e:
            c.log(f"[fault] {label} [{name}]: failed: {e}")
            if name == "kernel":
                wrong.append(f"{label}: the package's kernel failed the hold")
    _cuda._libs["tiles_scan"] = libs["kernel"]
    return wrong


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_hold_faults: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = c.card_line()
    c.log(f"[env] card: {card}")
    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        chunk_fn = c.make_corpus(dev, c.CHUNK)
        queries = c.make_queries(chunk_fn, dev, c.B)
        idx, _ = c.build_index(dev, chunk_fn, c.N_ROWS // c.CHUNK, False)
        st = idx._device_state()
        p_tiles, tq = c.MAIN_OP
        q_s, table = c.k3_plan(idx, queries, p_tiles, tq)
        q_bf = q_s.to(torch.bfloat16)
        q8, _ = flat.quantize_queries(q_s)
        q8b, starts, band_tiles = c.k7_plan(idx, queries)
        exact = c.wholerow_exact(st["payload"], q_bf)
        for lb in (0, 512):
            r_blocks = idx.tile_n // (lb or idx.tile_n)
            faults = ["entry", "r", "chunk"] if r_blocks > 1 else ["entry", "chunk"]
            for label, qk, int8, how in (("hybrid", q_bf, "hybrid", dict(exact=exact, tie=None)),
                                         ("int8", q8, True, dict(equal=True))):
                kw = dict(tile_n=idx.tile_n, tile_q=tq, int8=int8, n_valid=idx._n, l_buckets=lb)
                wrong += hold(
                    libs, f"K3 {label} B{c.B} p{p_tiles} tq{tq} R{r_blocks}",
                    lambda a=(qk, kw): band.tiles_topk(st["payload"], a[0], table, c.K, **a[1]),
                    lambda a=(qk, kw): band.tiles_topk_reference(st["payload"], a[0], table, c.K,
                                                                 **a[1]), faults, **how)
            kw7 = dict(tile_n=idx.tile_n, tile_q=idx.tile_q, int8=True, n_valid=idx._n,
                       l_buckets=lb)
            wrong += hold(
                libs, f"K7 int8 band plan B{c.B} band_tiles {band_tiles} R{r_blocks}",
                lambda: band.band_topk(st["payload"], q8b, starts, c.K, band_tiles, **kw7),
                lambda: band.band_topk_reference(st["payload"], q8b, starts, c.K, band_tiles,
                                                 **kw7), faults, equal=True)
    for line in wrong:
        c.log(f"[fault] WRONG: {line}")
    c.log(f"[fault] {card}: " + (f"{len(wrong)} wrong" if wrong else
                                 "every hold passed the kernel and failed each fault"))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
