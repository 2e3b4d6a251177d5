#!/usr/bin/env python3
"""Planted faults against chip_smoke.py's full-shape holds of K5 and K6, on
one GPU: each hold must pass the package's kernel and fail a kernel that
skips rows.

Run from the repository root::

    python3 scripts/torch_pq_hold_faults.py

It builds csrc/pq_scan.cu and copies of it with one fault planted each,
written to a temporary directory (the package's source is not touched):

- ``entry``: every block skips the first table entry of its pool (K6: the
  first arena tile), so those rows are never scored;
- ``r``: rows of r == 1 (the second row block of a tile at a slot) are never
  scored; a plan whose tiles hold one row block per slot (R 1) has no such
  rows;
- ``mask``: the row mask is ignored, so disallowed rows become candidates;
- ``l2``: the l2 bias is added twice (the key q . x - |x|^2).

Then, as chip_smoke.py's run_pq does, it builds BASELINE config #3's index
(10M x 768 OPQ+IVF-PQ, m 64) on the same corpus and queries, and holds each
build against the plain version at the PQ route's three plans at (p_tiles,
tile_q) = (224, 32), the op point chip_smoke.py's tune picks there, and at
refine_factor 64's plan masked by a random 10% filter (no disallowed row in
either version's results) and with the l2 key (the bias from the bias
kernel; its exact scores the l2 key's); then K6 over 1M x 64 codes as run_k6
does. Every hold is chip_smoke.compare with
the exact scores, as in chip_smoke.py. One line per (shape, build): passed,
or the criteria it failed. Exits 1 unless the package's kernel passes every
hold and each faulted build fails every hold it applies to.
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
from cloudvectordb_tpu_torch.ops import _cuda, pq  # noqa: E402

P_TILES, TILE_Q = 224, 32
#: fault -> (text of csrc/pq_scan.cu, its replacement), each found once
FAULTS = {
    "entry": [("const int n_it = n_steps * R;",
               "const int n_it = (n_steps - (n_steps > 1)) * R;"),
              ("const int j = pid + js * a.n_pools;",
               "const int j = pid + (js + (n_steps > 1)) * a.n_pools;")],
    "r": [("if (row < x.n_rows && (!MASK || mask_s[bi * SB + row])) {",
           "if (row < x.n_rows && (!MASK || mask_s[bi * SB + row]) && x.r != 1) {")],
    "mask": [("if (row < x.n_rows && (!MASK || mask_s[bi * SB + row])) {",
              "if (row < x.n_rows) {")],
    "l2": [("if (L2) sc += bias_s[bi * SB + row];", "if (L2) sc += 2.0f * bias_s[bi * SB + row];")],
}


def build(out: Path) -> dict[str, ctypes.CDLL]:
    """The package's kernel ("kernel") and one build per fault, bound as
    ops/_cuda.py binds pq_scan."""
    text = (_cuda._CSRC / "pq_scan.cu").read_text()
    sources = {"kernel": _cuda._CSRC / "pq_scan.cu"}
    for name, edits in FAULTS.items():
        planted = text
        for old, new in edits:
            if planted.count(old) != 1:
                raise RuntimeError(f"fault {name}: {old!r} is not in pq_scan.cu once")
            planted = planted.replace(old, new)
        sources[name] = out / f"pq_scan_{name}.cu"
        sources[name].write_text(planted)
    procs = {}
    for name, src in sources.items():
        lib = out / f"libpq_scan_{name}.so"
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
        for fn, (argtypes, restype) in _cuda._SIGNATURES["pq_scan"].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = restype
        libs[name] = dll
    return libs


def hold(libs, label: str, kernel, plain, exact, faults: list[str], allow=None) -> list[str]:
    """Each build through one hold; returns what went wrong."""
    wrong = []
    for name in ["kernel", *faults]:
        _cuda._libs["pq_scan"] = libs[name]
        try:
            c.compare(f"{label} [{name}]", kernel, plain, exact=exact, allow=allow)
            if name != "kernel":
                wrong.append(f"{label}: fault {name} passed the hold")
        except AssertionError as e:
            c.log(f"[fault] {label} [{name}]: failed: {e}")
            if name == "kernel":
                wrong.append(f"{label}: the package's kernel failed the hold")
    _cuda._libs["pq_scan"] = libs["kernel"]
    return wrong


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pq_hold_faults: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = c.card_line()
    c.log(f"[env] card: {card}")
    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        chunk_fn = c.make_corpus(dev, c.CHUNK)
        queries = c.make_queries(chunk_fn, dev, c.B)
        idx, build_s = c.build_pq(dev, chunk_fn)
        c.log(f"[pq] built config #3 in {build_s:.1f} s, tile_n {idx.tile_n}")
        st, q_s, _, exact, plans = c.pq_holds(idx, queries, P_TILES, TILE_Q)
        for name, args in plans.items():
            r_blocks = args["tile_n"] // args["l_buckets"]
            label = f"K5 {c.pq_plan_label(name, args, c.B, P_TILES)} R{r_blocks}"
            wrong += hold(libs, label, lambda a=args: pq.pq_tiles_topk(**a),
                          lambda a=args: pq.pq_tiles_topk_reference(**a), exact,
                          ["entry", "r"] if r_blocks > 1 else ["entry"])
        g = torch.Generator(device=dev)
        g.manual_seed(4242)
        rm = (torch.rand(st["codes"].shape[0], generator=g, device=dev) < 0.1).to(torch.int8)
        masked = dict(plans["rf64"], row_mask=rm)
        wrong += hold(libs, f"K5 {c.pq_plan_label('rf64 masked 10%', masked, c.B, P_TILES)}",
                      lambda: pq.pq_tiles_topk(**masked),
                      lambda: pq.pq_tiles_topk_reference(**masked), exact, ["entry", "mask"],
                      allow=rm)
        l2 = dict(plans["rf64"], l2=True)
        bias = pq.pq_row_bias(st["codes"], st["local"], st["codebooks"], st["centroid_tiles"],
                              idx.tile_n)
        wrong += hold(libs, f"K5 {c.pq_plan_label('rf64 l2', l2, c.B, P_TILES)}",
                      lambda: pq.pq_tiles_topk(**l2, row_bias=bias),
                      lambda: pq.pq_tiles_topk_reference(**l2),
                      c.pq_exact(st["codes"], st["local"], st["codebooks"],
                                 st["centroid_tiles"], idx.tile_n, q_s, l2=True),
                      ["entry", "l2"])
        del idx, plans, exact, st, bias
        torch.cuda.empty_cache()
        _, cb, codes_cm, _ = c.k6_inputs(chunk_fn)
        kw = dict(tile_n=c.K6_TILE_N)
        wrong += hold(libs, f"K6 {c.K6_ROWS}x{c.PQ_M} codes B{c.B} tile_n {c.K6_TILE_N}",
                      lambda: pq.pq_topk(codes_cm, cb, queries, c.K, **kw),
                      lambda: pq.pq_topk_reference(codes_cm, cb, queries, c.K, **kw),
                      c.pq_exact(codes_cm.T, None, cb, None, c.K6_TILE_N, queries), ["entry"])
    for line in wrong:
        c.log(f"[fault] WRONG: {line}")
    c.log(f"[fault] {card}: " + (f"{len(wrong)} wrong" if wrong else
                                 "every hold passed the kernel and failed each fault"))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
