"""The plain reference of the inner-product configurations: the exact f32
top-k of every query over every row the index holds, in plain torch with
TF32 off, recomputed from the benchmark's own rows (gen.Data); and the
exact f32 score of each id an answer names, so that the answer's scores
are judged too.

It imports nothing of the program. ``bits`` < 32 quantizes every row to
signed ``bits``-bit levels under one scale from the first chunk (the
program's rule for its int8 scale: min(amax, 4·rms) / (2^(bits-1) - 1)),
which makes the lower-precision control of the correctness check.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _merge(best, v, i, k):
    if best is None:
        return v, i
    v = torch.cat([best[0], v], dim=1)
    i = torch.cat([best[1], i], dim=1)
    v2, pos = torch.topk(v, k, dim=1)
    return v2, torch.gather(i, 1, pos)


def run(data, queries: torch.Tensor, k: int, answers=None, bits: int = 32) -> dict:
    """{'ids': (Q, k) int64 exact top-k ids, 'scores': their f32 scores,
    'answer_scores': (Q, k) f64 exact scores of ``answers`` ((Q, k) int64
    ids; NaN where an id names no row)} over ``data.all_chunks()``."""
    q = queries.float()
    nq = q.shape[0]
    tile = max(1024, (1 << 28) // max(nq, 1))  # a (Q, tile) f32 block of <= 1 GiB
    best = None
    ans = None if answers is None else torch.as_tensor(answers, device=q.device).long()
    ans_sc = None if ans is None else torch.full(ans.shape, float("nan"),
                                                  dtype=torch.float64, device=q.device)
    scale = None
    levels = 2 ** (bits - 1) - 1
    with no_tf32():
        for base, fn in data.all_chunks():
            x = fn().float()
            m = x.shape[0]
            if ans is not None:  # answers are judged against the f32 rows
                inside = (ans >= base) & (ans < base + m)
                if bool(inside.any()):
                    qi, si = inside.nonzero(as_tuple=True)
                    rows = x[ans[qi, si] - base]
                    ans_sc[qi, si] = (q[qi].double() * rows.double()).sum(dim=1)
                    rows = None
            if bits < 32:
                if scale is None:
                    rms = torch.sqrt(torch.mean(x * x))
                    scale = torch.clamp(torch.minimum(x.abs().max(), 4.0 * rms) / levels,
                                        min=1e-12)
                x = torch.clamp(torch.round(x / scale), -levels, levels) * scale
            for lo in range(0, m, tile):
                hi = min(m, lo + tile)
                s = q @ x[lo:hi].T
                v, i = torch.topk(s, min(k, hi - lo), dim=1)
                best = _merge(best, v, i + (base + lo), k)
                s = None
            x = None
    return {"ids": best[1], "scores": best[0], "answer_scores": ans_sc}
