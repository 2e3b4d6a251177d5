"""What decides ``correct``: the judged answers of the timed path against
the plain reference, each number beside its limit.

- ``recall_short``: 1 - recall@k of the judged answers against the exact
  top-k. Its limit is the configuration's stated guarantee (recall@10 >=
  0.95, so 0.05).
- ``score_gap``: the largest gap between a score an answer returns and the
  exact f32 score of the row it names (the reference recomputes it from
  the benchmark's own rows). Its limit lies between the program's sound
  runs and the int4 control's (PERF.md gives the readings).
- ``bad_answers``: answers (queries) naming an id that no row has, -1, or
  one id twice. Exact: limit 0.

A number is within its limit when it is at most the limit.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(found: np.ndarray, exact: np.ndarray) -> float:
    """Mean over queries of |found ∩ exact| / k."""
    k = exact.shape[1]
    hits = sum(len(set(f.tolist()) & set(e.tolist())) for f, e in zip(found, exact))
    return hits / (k * exact.shape[0])


def bad_answers(ids: np.ndarray, n_total: int) -> int:
    out_of_range = ((ids < 0) | (ids >= n_total)).any(axis=1)
    s = np.sort(ids, axis=1)
    twice = (s[:, 1:] == s[:, :-1]).any(axis=1)
    return int((out_of_range | twice).sum())


def score_gap(scores: np.ndarray, exact_scores: np.ndarray) -> float:
    """max |returned - exact| over the slots that name a row (an unnamed
    slot is counted by bad_answers); 1e30 if no slot names one."""
    ok = np.isfinite(exact_scores) & np.isfinite(scores)
    if not ok.any():
        return 1e30  # no slot names a row: the largest gap, finite for JSON
    return float(np.abs(scores.astype(np.float64)[ok] - exact_scores[ok]).max())


def judge(ids: np.ndarray, scores: np.ndarray, ref: dict, n_total: int,
          limits: dict) -> tuple[bool, dict, float]:
    """(correct, {name: {'value', 'limit'}}, recall) of answers ``ids`` /
    ``scores`` ((Q, k)) against the reference's output ``ref``."""
    exact = ref["ids"].cpu().numpy()
    exact_sc = ref["answer_scores"].cpu().numpy()
    recall = recall_at_k(ids, exact)
    values = {"recall_short": 1.0 - recall,
              "score_gap": score_gap(scores, exact_sc),
              "bad_answers": bad_answers(ids, n_total)}
    checks = {name: {"value": v, "limit": limits[name]} for name, v in values.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, recall
