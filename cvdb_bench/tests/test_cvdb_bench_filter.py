"""The filtered configuration (``ivf_resid_int8_10m_filter99``): its
reference against brute-force numpy over the allowed rows, its threshold
against the configuration's, whole tiny runs broken underneath (the
builder searching without ``where=``; one disallowed id in the last slot of
1 query in 50, which recall alone would pass), the int4 control, and the
two filter readers on a fake trace."""

import ast
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cloudvectordb_tpu_torch.index import ivf_band
from cvdb_bench import cell, control, gen, roofline, trace
from cvdb_bench.tests._tiny import ROOT, tiny_cell

CPU = torch.device("cpu")
CELL = "resid10m.filter99.b4096"
REF = cell.load_module(cell.HERE / "references" / "exact_ip_filter99.py")
BUILDER = cell.load_module(cell.HERE / "builders" / "band_ivf_filter.py")
SEED = 2**31 + 777


def small_data(rows=3000, added=500):
    cfg = {"dim": 96, "rows": rows, "chunk_rows": 700, "corpus_seed": 3}
    mix = {"batch": 40, "pool_batches": 3, "scored_batches": 2, "added_rows": added,
           "noise": 0.15}
    return gen.Data(CPU, cfg, mix, 9)


def test_threshold_is_the_configurations_filter_value():
    c = cell.resolve(ROOT, CELL)["config"]
    f = c["filter"]
    assert REF.threshold(c["rows"]) == f["value"] == 9_900_000
    assert BUILDER.threshold(c, c["rows"]) == f["value"]
    assert REF.FILTER_RATE == f["filter_rate"]
    assert c["rows"] - f["value"] == f["allowed_rows"]
    assert BUILDER.threshold(c, 20_000) == REF.threshold(20_000) == 19_800  # the tiny cell


def test_reference_equals_brute_force_numpy_over_the_allowed_rows():
    data = small_data()
    x = np.concatenate([fn().numpy().astype(np.float64) for _, fn in data.all_chunks()])
    assert x.shape == (3500, 96)
    lo = REF.threshold(3000)
    assert lo == 2970  # 30 corpus rows and the 500 added rows pass
    q = torch.cat(data.query_pool()[:2])
    s = q.numpy().astype(np.float64) @ x.T
    s[:, :lo] = -np.inf
    want = np.argsort(-s, axis=1, kind="stable")[:, :10]
    answers = np.stack([want[:, 0], np.full(len(q), 2980), np.full(len(q), 2969),
                        np.full(len(q), 0), np.full(len(q), -1), np.full(len(q), 3500)], axis=1)
    out = REF.run(data, q, 10, answers=answers)
    assert (out["ids"].numpy() == want).all()
    np.testing.assert_allclose(out["scores"].numpy(), np.take_along_axis(s, want, 1),
                               rtol=0, atol=1e-5)
    sc = out["answer_scores"].numpy()
    np.testing.assert_allclose(sc[:, :2], np.take_along_axis(s, answers[:, :2], 1),
                               rtol=0, atol=1e-12)
    assert (sc[:, 2:4] == REF.DISALLOWED).all()  # rows the filter disallows
    assert np.isnan(sc[:, 4:]).all()  # -1 and an id past every row name none


def test_reference_never_makes_a_chunk_without_an_allowed_row(monkeypatch):
    data = small_data(added=0)
    q = data.query_pool()[0]
    made = []
    real = data.chunk
    monkeypatch.setattr(data, "chunk", lambda i: made.append(i) or real(i))
    REF.run(data, q, 10, answers=np.zeros((40, 10), int))
    assert made == [4]  # rows 2800-2999 of chunks of 700


def run(c, monkeypatch=None, fault=None):
    if fault == "no_where":  # the builder's view searches as the unfiltered index
        real = ivf_band.BandIVFIndex.search_device

        def search_device(self, queries, k, where=None, **kw):
            return real(self, queries, k, **kw)

        monkeypatch.setattr(ivf_band.BandIVFIndex, "search_device", search_device)
    elif fault == "last_slot":  # 1 query in 50: a disallowed row in its last slot
        real = ivf_band.BandIVFIndex.search_device

        def search_device(self, queries, k, **kw):
            v, ids = real(self, queries, k, **kw)
            ids = ids.clone()
            rows = torch.arange(0, ids.shape[0], 50)
            ids[rows, -1] = rows.to(ids.dtype)  # rows 0, 50, ... lie below the threshold
            return v, ids

        monkeypatch.setattr(ivf_band.BandIVFIndex, "search_device", search_device)
    return cell.run(c, SEED, 0.3, False, CPU, 0.0, log=lambda m: None)


def test_sound_tiny_run_is_correct():
    out = run(tiny_cell(CELL))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"qps", "recall_at_10", "setup_s"}


@pytest.mark.parametrize("fault", ["no_where", "last_slot"])
def test_fault_is_not_correct(monkeypatch, fault):
    out = run(tiny_cell(CELL), monkeypatch, fault)
    assert not out["correct"]
    checks = out["checks"]
    assert checks["score_gap"]["value"] > 1e29  # a disallowed id scores 1e30
    if fault == "last_slot":  # recall alone would pass it
        assert checks["recall_short"]["value"] <= checks["recall_short"]["limit"]
        assert checks["bad_answers"]["value"] == 0


def test_int4_control_is_not_correct():
    out = control.control_checks(tiny_cell(CELL), 2**33 + 5, CPU, bits=4)
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > out["checks"]["score_gap"]["limit"]


def test_k1_bytes_count_the_tiles_the_filtered_plan_can_reach():
    """K1's bytes count the live tiles (those holding an allowed row), not
    the arena's: the filtered plan reaches no other while p_tiles fit in
    them, and past that p_tiles in all (the same lowest dead tiles for
    every group)."""
    c = tiny_cell(CELL)
    data = gen.Data(CPU, c["config"], c["mix"], SEED)
    served = BUILDER.Served(c["config"], data, CPU)
    idx, st = served.index._index, served.index._device_state()
    n_tiles, tile_n, dim = idx._tune_n_tiles(), idx.tile_n, idx.dim
    gids = np.full(n_tiles * tile_n, -1, np.int64)
    gids[: idx._ids.shape[0]] = idx._ids
    live = (gids.reshape(n_tiles, tile_n) >= served.lo).any(axis=1)
    n_live = int(live.sum())
    assert 0 < n_live < n_tiles  # each list's allowed rows are its last inserted
    q = data.query_pool()[0]  # 64 queries: two groups of 32
    for p in (4, n_live + 3):
        served.op = {"p_tiles": p, "tile_q": 32}
        k1 = served.work(64, 0)["K1"]
        tiles = min(2 * p, max(n_live, p))
        assert k1 == roofline.k1(64, p, 32, tile_n, dim, max(n_live, p), 10)
        assert k1["bytes"] == tiles * tile_n * (dim + 1) + 64 * dim + 64 * 10 * 8
        *_, table = ivf_band._plan_tiles(q, st["centroids"], st["tile_window"], 32, p,
                                         tile_live=torch.as_tensor(live))
        reached = np.unique(table.numpy())
        assert len(reached) <= tiles
        if p <= n_live:
            assert live[reached].all()


def test_reference_and_builder_import_no_jax_and_the_reference_none_of_the_program():
    for name in ("references/exact_ip_filter99.py", "builders/band_ivf_filter.py"):
        tree = ast.parse((cell.HERE / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in mods), name
        if name.startswith("references"):
            assert not any(m.split(".")[0].startswith("cloudvectordb") for m in mods), mods


def filter_trace():
    """Two calls, each a cvdb.filter span that issued a reduction and a
    compare (0.01 + 0.02 s, then 0.03 + 0.01 s, idle between them not
    counted), then K1."""
    tr = trace.Trace(window_s=1.0, n_calls=2, calls=[(0.0, 0.5), (0.5, 1.0)])
    calls = [[("cvdb.filter", 0.01, 0.05, [(0.02, "reduce", 0.10, 0.11),
                                           (0.03, "compare", 0.12, 0.14)]),
              ("cvdb.scan", 0.05, 0.09, [(0.06, "resid_scan_kernel<1>", 0.15, 0.40)])],
             [("cvdb.filter", 0.51, 0.55, [(0.52, "reduce", 0.56, 0.59),
                                           (0.53, "compare", 0.59, 0.60)]),
              ("cvdb.scan", 0.55, 0.59, [(0.56, "resid_scan_kernel<1>", 0.61, 0.90)])]]
    for (ca, cb), spans_ in zip(tr.calls, calls):
        tr.host_ops.append(("cvdb.search", ca, cb))
        for name, a, b, launches in spans_:
            tr.host_ops.append((name, a, b))
            for t, op, x, y in launches:
                tr.host_ops.append(("cudaLaunchKernel", t, t + 0.001))
                tr.kernels.append((op, x, y))
    tr.busy_s = trace.covered((0.0, 1.0), trace.union((a, b) for _, a, b in tr.kernels))
    return tr


def records(with_filter=True):
    out = []
    for call in (1, 2):
        if with_filter:
            out.append({"name": "cvdb.filter", "call": call, "root": False,
                        "counts": {"allowed_rows": 100_000, "live_tiles": 4_883,
                                   "live_rows": 4_883 * 2048}})
        out += [{"name": "cvdb.scan", "call": call, "root": False,
                 "counts": {"tile_reads": 28_672, "tile_read_bytes": 1}},
                {"name": "cvdb.search", "call": call, "root": True, "counts": {}}]
    return out


@pytest.mark.parametrize("with_filter", [True, False], ids=["change", "parent"])
def test_filter_readers(monkeypatch, with_filter):
    from cloudvectordb_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "span_records",
                        lambda: {"records": records(with_filter), "dropped": 0})
    tr = filter_trace()
    if not with_filter:  # the parent: no span, nothing launched inside one
        tr.host_ops = [op for op in tr.host_ops if op[0] != "cvdb.filter"]
    ctx = SimpleNamespace(trace=tr, kernels=BUILDER.KERNELS, work={})
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in cell.metrics_of(spec["per_layer"], CELL, {"qps"})}
    got = {}
    for name in ("filter_device_ms.qps", "filter_yield_pct.qps"):
        assert entries[name]["workloads"] == [CELL]
        got[name] = cell.load_module(cell.HERE / "layer_metrics" / f"{name}.py").read(ctx)
    if with_filter:
        assert got["filter_device_ms.qps"] == pytest.approx(1e3 * 0.035)  # median of 30, 40 ms
        assert got["filter_yield_pct.qps"] == pytest.approx(100 * 100_000 / (4_883 * 2048))
    else:
        assert got == {"filter_device_ms.qps": None, "filter_yield_pct.qps": None}
