"""The plain reference of the filtered configuration: the exact f32 top-k of
every query over the rows the filter allows, ids ``>= int(0.99 ·
data.rows)`` (VectorDBBench's ``IntFilterPerformanceCase`` at filter_rate
0.99, ids in corpus order, the rows added in set-up after them), in plain
torch with TF32 off, recomputed from the benchmark's own rows (gen.Data);
and the exact f32 score of each allowed id an answer names. An answer
naming a row the filter disallows scores ``DISALLOWED`` (1e30, the judge's
own "largest gap"), so ``score_gap`` fails it; an id naming no row stays
NaN, for ``bad_answers``. Chunks that hold no allowed row are never made.

It imports nothing of the program. ``bits`` < 32 quantizes the rows to
signed ``bits``-bit levels under one scale from the first chunk of the
corpus, as ``exact_ip.py`` does, for the lower-precision control.
"""

from __future__ import annotations

import torch

from cvdb_bench.references.exact_ip import _merge, no_tf32

#: VectorDBBench's filter_rate of case Performance768D10M99P
FILTER_RATE = 0.99
#: the exact score of an answer the filter disallows
DISALLOWED = 1e30


def threshold(rows: int, filter_rate: float = FILTER_RATE) -> int:
    """The smallest id the filter allows: int(filter_rate · rows)."""
    return int(filter_rate * rows)


def _scale(data, bits: int):
    x = data.chunk(0).float()
    levels = 2 ** (bits - 1) - 1
    rms = torch.sqrt(torch.mean(x * x))
    return torch.clamp(torch.minimum(x.abs().max(), 4.0 * rms) / levels, min=1e-12)


def run(data, queries: torch.Tensor, k: int, answers=None, bits: int = 32,
        filter_rate: float = FILTER_RATE) -> dict:
    """{'ids': (Q, k) int64 exact top-k ids of the allowed rows, 'scores':
    their f32 scores, 'answer_scores': (Q, k) f64 exact scores of
    ``answers`` ((Q, k) int64 ids; DISALLOWED where the filter disallows
    the id, NaN where it names no row)} over ``data.all_chunks()``."""
    q = queries.float()
    nq = q.shape[0]
    lo_id = threshold(data.rows, filter_rate)
    n_total = data.rows + data.added
    tile = max(1024, (1 << 28) // max(nq, 1))  # a (Q, tile) f32 block of <= 1 GiB
    best = None
    ans = None if answers is None else torch.as_tensor(answers, device=q.device).long()
    ans_sc = None
    if ans is not None:
        ans_sc = torch.full(ans.shape, float("nan"), dtype=torch.float64, device=q.device)
        ans_sc[(ans >= 0) & (ans < min(lo_id, n_total))] = DISALLOWED
    scale = _scale(data, bits) if bits < 32 else None
    levels = 2 ** (bits - 1) - 1
    with no_tf32():
        sizes = list(data.sizes) + list(data.added_sizes)
        for (base, fn), m in zip(data.all_chunks(), sizes):
            if base + m <= lo_id:
                continue  # no allowed row: never made
            first = max(base, lo_id)
            x = fn()[first - base:].float()
            if ans is not None:  # answers are judged against the f32 rows
                inside = (ans >= first) & (ans < base + m)
                if bool(inside.any()):
                    qi, si = inside.nonzero(as_tuple=True)
                    rows = x[ans[qi, si] - first]
                    ans_sc[qi, si] = (q[qi].double() * rows.double()).sum(dim=1)
                    rows = None
            if scale is not None:
                x = torch.clamp(torch.round(x / scale), -levels, levels) * scale
            n = x.shape[0]
            for lo in range(0, n, tile):
                hi = min(n, lo + tile)
                s = q @ x[lo:hi].T
                v, i = torch.topk(s, min(k, hi - lo), dim=1)
                best = _merge(best, v, i + (first + lo), k)
                s = None
            x = None
    return {"ids": best[1], "scores": best[0], "answer_scores": ans_sc}
