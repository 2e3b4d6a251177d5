"""Op-point auto-tuner (counterpart of cloudvectordb_tpu/eval/tune.py).

``Index.tune(queries, target_recall)``: each index family supplies a
cost-ordered candidate ladder (``_tune_candidates``) and a max-effort
reference config (``_tune_reference_kw``); the engine walks the ladder
cheapest-first measuring recall@k against the reference (or a caller-
supplied exact ground truth). The first passing config in each ``tile_q``
branch becomes a finalist, every finalist is timed, and the fastest
measured one wins. The op point is stored on the index (``_op_point``),
where ``search()`` picks it up for any knob the caller leaves at its
sentinel default (``TunableMixin._op_knobs``, the one place that decides
it), and is persisted in the artifact manifest. ``coverage_ladder`` is the
tiles kinds' shared ``p_tiles`` ladder.

Differences from the reference: timing is the host clock around
``search()`` calls fenced by ``torch.cuda.synchronize`` (the reference
subtracted a dev-relay round trip, which does not exist here); a config is
allowed to fail only by running out of device memory, which is recorded in
``tried`` (any other error, such as a kernel that fails to launch, raises);
and candidates the cost-proxy prune skips are recorded in ``tried`` too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cloudvectordb_tpu_torch.eval.recall import recall_at_k

#: a serving knob's default where neither the call nor the op point sets it
#: (nprobe: the probe-scan families'); p_tiles, tile_q and n_pools have
#: none here: their auto sizes depend on the batch
KNOB_DEFAULTS = {"nprobe": 8, "refine_factor": 16, "host_factor": 64, "serve_from": "pq",
                 "top2": False}
#: knobs whose sentinel is <= 0 (their public default 0), not None
_ZERO_SENTINELS = ("p_tiles", "n_pools")


def coverage_ladder(base: int, n_tiles: int) -> list[int]:
    """The tune ladder's ``p_tiles`` rungs over the auto budget ``base``:
    multiples of it rounded down to 32 (at least 32), capped at
    ``n_tiles``, up to the first rung that covers every tile. Rungs may
    repeat; callers drop repeated candidates."""
    out = []
    for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
        out.append(min(n_tiles, max(32, int(base * mult) // 32 * 32)))
        if out[-1] >= n_tiles:
            break
    return out


class TunableMixin:
    """``tune()`` + tuned-op-point storage. Subclasses supply
    ``_tune_candidates(nq)`` (cost-ordered ladder of search() kwargs),
    ``_tune_reference_kw(nq)`` (max-effort config) and a ``device``."""

    #: tuned serving knobs — search() uses these for any parameter the
    #: caller leaves at its sentinel default; persisted in the manifest
    _op_point: dict | None = None

    def _op_knobs(self, **knobs) -> dict:
        """The knobs a call was given, resolved, by name: one at its
        sentinel (None; <= 0 for p_tiles and n_pools) takes the op point's
        value, else ``KNOB_DEFAULTS``' (else 0 or None, for the auto sizes
        to fill)."""
        op = self._op_point or {}
        for name, v in knobs.items():
            if name in _ZERO_SENTINELS:
                if v <= 0:
                    knobs[name] = op.get(name, 0)
            elif v is None:
                knobs[name] = op.get(name, KNOB_DEFAULTS.get(name))
        return knobs

    def _tune_candidates(self, nq: int) -> list[dict]:
        raise NotImplementedError(f"{type(self).__name__} does not support tune()")

    def _tune_reference_kw(self, nq: int) -> dict:
        raise NotImplementedError

    def tune(self, queries, k: int = 10, target_recall: float = 0.95,
             gt: np.ndarray | None = None, time_iters: int = 3,
             verbose: bool = False, max_finalists: int = 4) -> dict:
        """Pick the fastest measured serving config meeting
        ``target_recall`` on ``queries`` and make it this index's default
        op point. Returns the tune report (see tune_index)."""
        report = tune_index(self, queries, k, target_recall, gt,
                            time_iters=time_iters, verbose=verbose,
                            max_finalists=max_finalists)
        self._op_point = report["op"]
        return report


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_search(index, queries, k: int, kw: dict, iters: int = 3) -> dict:
    """Wall clock of ``index.search`` (numpy in, numpy out) over ``iters``
    calls with distinct inputs, fenced on the index's device."""
    _sync(index.device)
    t0 = time.perf_counter()
    for it in range(iters):
        index.search(np.roll(queries, it + 1, axis=0), k, **kw)
    _sync(index.device)
    dt = (time.perf_counter() - t0) / iters
    return {"qps": queries.shape[0] / dt, "latency_ms": 1000.0 * dt}


def _proxy_cost(cfg: dict) -> float:
    """Per-query scan-work proxy, the reference's: the coverage knob times
    the refine-depth multipliers. It bounds how far past the first
    finalist the walk goes; it does not pick the winner."""
    c = float(cfg.get("p_tiles") or cfg.get("nprobe") or 1)
    c *= 1 + cfg.get("refine_factor", 0) / 256.0
    c *= 1 + cfg.get("host_factor", 0) / 512.0
    return c


def _reference_ids(index, queries, k: int, candidates: list[dict], verbose: bool):
    """Ids of the index's own max-effort config, the ground truth when the
    caller gives none. That config is the deepest of all, so where it runs
    out of device memory the walk goes down the ladder, most expensive
    first, as the reference's does; any other error raises."""
    last = None
    for kw in [index._tune_reference_kw(queries.shape[0])] + candidates[::-1]:
        try:
            return index.search(queries, k, **kw)[1]
        except torch.cuda.OutOfMemoryError as e:
            last = e
            if verbose:
                print(f"[tune] reference {kw}: out of device memory", flush=True)
    raise RuntimeError(f"every reference config ran out of device memory; last error: {last}")


def tune_index(
    index,
    queries,
    k: int = 10,
    target_recall: float = 0.95,
    gt: np.ndarray | None = None,
    time_iters: int = 3,
    verbose: bool = False,
    max_finalists: int = 4,
) -> dict:
    """Walk the index's candidate ladder; return the chosen op point.

    Returns ``{"op", "recall", "met", "qps", "latency_ms", "tried",
    "finalists"}``. ``met=False`` means no candidate reached the target and
    ``op`` is the best-recall candidate instead. ``qps`` is the host-API
    rate of ``search()`` on ``index.device``.
    """
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    candidates = index._tune_candidates(nq)
    if not candidates:
        raise ValueError("index supplied an empty tune ladder")
    if gt is None:
        gt = _reference_ids(index, queries, k, candidates, verbose)
    tried = []
    best = None  # (recall, cfg) fallback when nothing meets target
    finalists: dict = {}  # tile_q branch -> (recall, cfg), first pass each
    n_branches = len({c.get("tile_q") for c in candidates})
    for cfg in candidates:
        branch = cfg.get("tile_q")
        if branch in finalists:
            continue  # within a branch the first pass is its fastest pass
        if finalists and _proxy_cost(cfg) > 4.0 * min(
                _proxy_cost(f[1]) for f in finalists.values()):
            # >4x the scan work of an already-passing config cannot win on
            # wall clock; recorded so the prune leaves a trace
            tried.append({**cfg, "skipped": "proxy cost > 4x a finalist"})
            continue
        try:
            _, found = index.search(queries, k, **cfg)
        except torch.cuda.OutOfMemoryError as e:
            tried.append({**cfg, "error": f"OutOfMemoryError: {e}"[:160]})
            if verbose:
                print(f"[tune] {cfg}: out of device memory", flush=True)
            continue
        r = float(recall_at_k(found, gt))
        tried.append({**cfg, "recall": r})
        if verbose:
            print(f"[tune] {cfg}: recall@{k}={r:.4f}", flush=True)
        if best is None or r > best[0]:
            best = (r, cfg)
        if r >= target_recall:
            finalists[branch] = (r, cfg)
            if len(finalists) >= min(max_finalists, n_branches):
                break
    if best is None:
        raise RuntimeError(f"every tune candidate failed: {tried}")
    if not finalists:
        recall, op = best
        timing = _time_search(index, queries, k, op, iters=time_iters)
        return {"op": dict(op), "recall": recall, "met": False, **timing,
                "tried": tried, "finalists": []}
    measured = []
    for r, cfg in finalists.values():
        t = _time_search(index, queries, k, cfg, iters=time_iters)
        measured.append({"op": dict(cfg), "recall": r, **t})
        if verbose:
            print(f"[tune] finalist {cfg}: {t['qps']:,.0f} qps "
                  f"(recall {r:.4f})", flush=True)
    measured.sort(key=lambda m: (-m["qps"], -m["recall"]))
    win = measured[0]
    return {"op": win["op"], "recall": win["recall"], "met": True,
            "qps": win["qps"], "latency_ms": win["latency_ms"],
            "tried": tried, "finalists": measured}
