#!/usr/bin/env python3
"""Time the int8 rescore of the PQ route (ops/rescore.py: csrc/rescore_int8.cu,
and variants of it) at the ``opqpq10m.b4096`` cell's shape on one GPU.

Run from the repository root::

    python3 scripts/torch_rescore_time.py [SOURCE.cu ...]

The package's csrc/rescore_int8.cu comes first, then each SOURCE.cu given (a
whole variant of it, with the same C interface); each is built by nvcc (all
at once, ptxas' registers and spills printed), bound in place of the
package's library and, for each of the four variants (residual or whole
rows, ip or l2), held against the plain version and timed in turns (forward,
then backward; CUDA events over 10 back-to-back launches, median of 5) on
random data made on the device: 4,096 queries of 2,050 candidates each
(k 10 x refine_factor 205) over 10M x 768 int8 refine rows, 2% of the slots
unfilled. Beside them: the plain version (the gather, the f32 cast and
``torch.bmm``, median of 3), the stable top-k that follows in the PQ core,
and the bound: the candidates' int8 rows read once, plus the row ids, slot
values and scores, at 3.35 TB/s. One JSON line at the end, with the card's
name and power limit.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke as c  # noqa: E402
from cloudvectordb_tpu_torch.ops import _cuda, rescore  # noqa: E402
from cloudvectordb_tpu_torch.ops.topk import topk_stable  # noqa: E402
from torch_pq_scan_ab import build  # noqa: E402

B, KC, D, N_ROWS, NLIST, TILE_N, W = 4096, 2050, 768, 10_000_000, 4096, 1024, 24
VARIANTS = {"resid-ip": (True, False), "resid-l2": (True, True), "whole-ip": (False, False),
            "whole-l2": (False, True)}


def inputs(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(11)
    kw = dict(device=dev, generator=g)
    v = torch.rand((B, KC), **kw)
    v = torch.where(torch.rand((B, KC), **kw) < 0.02, float("-inf"), v)
    q = torch.randn((B, D), **kw)
    q = q / q.norm(dim=1, keepdim=True)
    cents = torch.randn((NLIST, D), **kw) / D ** 0.5
    return dict(
        q_s=q, v=v, rows=torch.randint(0, N_ROWS, (B, KC), **kw),
        refine_rows=torch.randint(-127, 128, (N_ROWS, D), dtype=torch.int8, **kw),
        refine_scale=0.00114, centroids=cents, dots=q @ cents.T,
        order=torch.randperm(B, **kw),
        tile_window=torch.randint(0, NLIST, (-(-N_ROWS // TILE_N), W), **kw),
        local_ids=torch.randint(0, W, (N_ROWS,), dtype=torch.uint8, **kw), tile_n=TILE_N)


def call(fn, a: dict, residual: bool, l2: bool):
    return fn(a["q_s"], a["v"], a["rows"], a["refine_rows"], a["refine_scale"],
              residual=residual, l2=l2, centroids=a["centroids"], dots=a["dots"],
              order=a["order"], tile_window=a["tile_window"], local_ids=a["local_ids"],
              tile_n=a["tile_n"])


def held(ex: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest score gap over max(|ref|, 1), inf if -inf slots differ."""
    live = torch.isfinite(ref)
    if not torch.equal(live, torch.isfinite(ex)) or bool((ex[~live] != ref[~live]).any()):
        return float("inf")
    gap = (ex[live].double() - ref[live].double()).abs() / ref[live].double().abs().clamp_min(1)
    return float(gap.max()) if gap.numel() else 0.0


def main(argv=None) -> dict:
    dev = torch.device("cuda", 0)
    sources = [_cuda._CSRC / "rescore_int8.cu"] + [Path(s) for s in (argv or [])]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build("rescore_int8", sources, Path(tmp))
        a = inputs(dev)
        n_bytes = B * KC * (D + 8 + 4 + 4) + B * D * 4
        bound_ms = n_bytes / c.HBM_BYTES_PER_S * 1e3
        rec = {"card": c.card_line(), "shape": f"B{B} k_cand{KC} D{D} rows{N_ROWS}",
               "bound_ms": bound_ms, "bound_by": "bytes", "variants": {}}
        for name, (residual, l2) in VARIANTS.items():
            ref = call(rescore.rescore_int8_reference, a, residual, l2)
            plain_ms = c.time_ms(lambda: call(rescore.rescore_int8_reference, a, residual, l2),
                                 3)
            times = {label: [] for label in libs}
            gaps = {}
            for order in (list(libs), list(libs)[::-1]):
                for label in order:
                    _cuda._libs["rescore_int8"] = libs[label]
                    if label not in gaps:
                        gaps[label] = held(call(rescore.rescore_int8, a, residual, l2), ref)
                    times[label].append(c.time_ms(
                        lambda: call(rescore.rescore_int8, a, residual, l2), 5, inner=10))
            topk_ms = c.time_ms(lambda: topk_stable(ref, 10), 3, inner=5)
            row = {"plain_ms": plain_ms, "topk_stable_ms": topk_ms,
                   "kernel_ms": {k: float(np.mean(t)) for k, t in times.items()},
                   "max_rel_gap": gaps}
            rec["variants"][name] = row
            print(f"[rescore] {name}: " + ", ".join(
                f"{k} {v:.3f} ms (gap {gaps[k]:.2e})" for k, v in row["kernel_ms"].items())
                + f"; plain {plain_ms:.3f} ms; topk_stable {topk_ms:.3f} ms; "
                f"bound {bound_ms:.3f} ms", flush=True)
            del ref
        _cuda._libs.pop("rescore_int8", None)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
