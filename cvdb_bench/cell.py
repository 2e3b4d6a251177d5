"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell; everything of one configuration, one
traffic mix or one metric sits in a file of its own, found by name:

- ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the deployment's sizes and guarantees, the builder (``builders/<name>.py``)
  and the plain reference (``references/<name>.py``) beside it, and the
  limits of the correctness check;
- ``mixes/<traffic>.json``: batch, pool, rows added, the loop
  (``loops/<name>.py``) that drives the window;
- ``op_points/<workload>.json``: the search knobs, fixed by one tune;
- ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: a reader
  of each metric, ``read(ctx) -> float | None`` (None: nothing to read, and
  the metric is left out of the line).

A later cell, mix or metric is a new file and a new entry; no file here
changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from cvdb_bench import gen, judge, trace

HERE = Path(__file__).resolve().parent
#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudvectordb_tpu")


def load_module(path: Path):
    """A module from a file path (metric files have dots in their names)."""
    name = "cvdb_bench._by_name." + path.parent.name + "." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def resolve(root: Path, workload: str, bench: Path = HERE) -> dict:
    """The cell's entries and files, by the names in ``BENCHMARK.json`` at
    ``root``, from the benchmark's folder ``bench``."""
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return {"workload": w, "config": read_json(root / conf["file"]),
            "mix": read_json(bench / "mixes" / f"{w['traffic']}.json"),
            "op": read_json(bench / "op_points" / f"{workload}.json")["search"],
            "end_to_end": spec["end_to_end"], "per_layer": spec["per_layer"], "dir": bench}


def metrics_of(entries: list, workload: str, reported: set | None = None) -> list:
    """The entries that this cell reports: those listing it under
    ``workloads``, and those without the key whose ``moves`` (per-layer)
    this cell reports, or every one (end to end)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def run(c: dict, seed: int, seconds: float, do_trace: bool, dev: torch.device,
        t_start: float, log=print) -> dict:
    """One run of the cell ``c`` (``resolve()``'s dict): set-up, the
    window, the trace (``do_trace``), the check, the metrics. Returns the
    result line's dict."""
    cfg, mix, w, here = c["config"], c["mix"], c["workload"], c["dir"]
    k = int(cfg["k"])
    data = gen.Data(dev, cfg, mix, seed)
    builder = load_module(here / "builders" / f"{cfg['builder']}.py")
    loop = load_module(here / "loops" / f"{mix['loop']}.py")

    t0 = time.perf_counter()
    served = builder.Served(cfg, data, dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    served.op = dict(c["op"])
    for j in range(len(data.added_sizes)):
        served.add(data.added_chunk(j))
    pool_dev = data.query_pool()
    judged = data.scored_batches()
    pool = pool_dev if loop.POOL == "device" else [q.cpu().numpy() for q in pool_dev]
    judged_q = torch.cat([pool_dev[j] for j in judged])
    pool_dev = None
    loop.warm(served, pool, mix, dev)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    build_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"[setup] {setup_s:.3f} s (build {build_s:.3f} s); window {seconds} s")

    win = loop.window(served, pool, mix, dev, seconds, set(judged))
    serve_peak = _peak(dev)
    memory_peak = max(build_peak, serve_peak)
    log(f"[window] {win['calls']} calls, {win['queries']} queries in {win['seconds']:.3f} s")
    tr = loop.traced(served, pool, mix, dev) if do_trace else None
    work = served.work(int(mix["batch"]), data.added)
    kernels = builder.KERNELS

    missing = [j for j in judged if j not in win["answers"]]
    if missing:  # a window too short to reach them: served now, by the same entry
        log(f"[check] pool batches {missing} answered after the window")
        call = served.search_device if loop.POOL == "device" else served.search_host
        for j in missing:
            win["answers"][j] = call(pool[j])
    ans = [win["answers"][j] for j in judged]
    ids = np.concatenate([np.asarray(i.cpu() if torch.is_tensor(i) else i) for _, i in ans])
    scores = np.concatenate([np.asarray(v.cpu() if torch.is_tensor(v) else v) for v, _ in ans])
    ids = ids.astype(np.int64)
    # the program's state goes before the reference runs
    served = pool = ans = None
    win["answers"] = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    reference = load_module(here / "references" / f"{cfg['reference']}.py")
    t1 = time.perf_counter()
    ref = reference.run(data, judged_q, k, answers=ids)
    correct, checks, recall = judge.judge(ids, scores, ref, data.rows + data.added,
                                          cfg["limits"])
    log(f"[check] reference {time.perf_counter() - t1:.3f} s over {ids.shape[0]} queries")

    ctx = SimpleNamespace(window=win, recall=recall, setup_s=setup_s, build_s=build_s,
                          serve_peak_bytes=serve_peak if dev.type == "cuda" else None,
                          trace=tr, work=work, kernels=kernels, batch=int(mix["batch"]),
                          n_pending=data.added, op=c["op"], dev=dev)
    e2e = metrics_of(c["end_to_end"], w["name"])
    if do_trace:
        entries = metrics_of(c["per_layer"], w["name"], {m["name"] for m in e2e})
        folder = "layer_metrics"
    else:
        entries, folder = e2e, "e2e_metrics"
    metrics = {}
    for m in entries:
        value = load_module(here / folder / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(w["chips"]), "memory_peak_bytes": memory_peak}
    out = {"correct": bool(correct), "attempted": int(win["queries"]),
           "failed": int(checks["bad_answers"]["value"]), "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = trace.breakdown(tr)
    out["checks"] = checks
    return out
