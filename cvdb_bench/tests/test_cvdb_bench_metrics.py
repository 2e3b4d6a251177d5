"""The end-to-end and per-layer arithmetic: a rate is all queries over the
whole window, a tail is taken over every call, and the work counts and
trace arithmetic match hand arithmetic at small shapes."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cvdb_bench import cell, readers, roofline, trace

CPU = torch.device("cpu")
HERE = cell.HERE


def reader(folder, name):
    return cell.load_module(HERE / folder / f"{name}.py").read


class SlowServed:
    """A served index whose calls take a known, uneven time."""

    def __init__(self, delays_s):
        self.delays, self.i = delays_s, 0

    def _call(self, q):
        time.sleep(self.delays[self.i % len(self.delays)])
        self.i += 1
        n = q.shape[0]
        return torch.zeros(n, 10), torch.zeros(n, 10, dtype=torch.int32)

    search_device = _call

    def search_host(self, q):
        v, i = self._call(q)
        return v.numpy(), i.numpy()


def test_rate_is_every_query_over_the_whole_window():
    loop = cell.load_module(HERE / "loops" / "closed_device.py")
    pool = [torch.zeros(8, 4) for _ in range(3)]
    served = SlowServed([0.001, 0.02, 0.001])
    win = loop.window(served, pool, {"batch": 8, "in_flight": 2}, CPU, 0.3, {1})
    assert win["calls"] == served.i and win["queries"] == 8 * served.i
    assert win["seconds"] >= 0.3
    qps = reader("e2e_metrics", "qps")(SimpleNamespace(window=win))
    assert qps == pytest.approx(8 * served.i / win["seconds"])
    assert set(win["answers"]) == {1}


def test_tail_is_over_every_call():
    loop = cell.load_module(HERE / "loops" / "closed_host.py")
    pool = [np.zeros((4, 4), np.float32) for _ in range(2)]
    # one call in ten is slow: a median of chunks would hide it, the p95 of all calls not
    served = SlowServed([0.001] * 9 + [0.03])
    win = loop.window(served, pool, {"batch": 4}, CPU, 0.5, {0, 1})
    assert len(win["latencies_ms"]) == win["calls"] == served.i
    p95 = reader("e2e_metrics", "p95_ms")(SimpleNamespace(window=win))
    assert p95 == readers.percentile(win["latencies_ms"], 95.0)
    assert p95 >= 25.0


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert readers.percentile(vals, 95.0) == 95
    assert readers.percentile([5.0], 95.0) == 5.0
    assert readers.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 100], 95.0) == 100
    assert readers.percentile([], 95.0) is None


def test_k1_work_by_hand():
    p = roofline.k1(batch=64, p_tiles=3, tile_q=32, tile_n=16, dim=8, n_tiles=5, k=10)
    assert p["ops"] == 2 * 64 * 3 * 16 * 8 and p["kind"] == "int8"
    # 2 groups x 3 entries reach at most the 5 tiles of the arena
    assert p["bytes"] == 5 * 16 * 9 + 64 * 8 + 64 * 10 * 8
    few = roofline.k1(batch=32, p_tiles=3, tile_q=32, tile_n=16, dim=8, n_tiles=5, k=10)
    assert few["bytes"] == 3 * 16 * 9 + 32 * 8 + 32 * 10 * 8


def test_k5_and_the_rest_by_hand():
    p = roofline.k5(batch=64, p_tiles=2, tile_q=64, tile_n=16, m=4, nbits=8, dim=8,
                    n_tiles=10, k_cand=40)
    assert p["ops"] == 64 * 2 * 16 * 4 + 2 * 64 * 4 * 256 * 2 and p["kind"] == "f32"
    assert p["bytes"] == 2 * 16 * 5 + 64 * 8 * 2 + 64 * 40 * 8
    assert roofline.planner(4, 3, 2)["ops"] == 2 * 4 * 3 * 2
    assert roofline.exact_scan(4, 100, 2)["ops"] == 2 * 4 * 100 * 2
    assert roofline.exact_scan(4, 100, 2, row_bytes=1)["bytes"] == 100 * 2 + 4 * 2 * 4
    assert roofline.rescore(4, 7, 2)["ops"] == 2 * 4 * 7 * 2
    assert roofline.rotation(4, 2)["ops"] == 2 * 4 * 2 * 2


def test_least_time_is_the_larger_bound():
    ops_bound = roofline.part(1979e12, "int8", 1.0)
    assert roofline.least_s(ops_bound) == pytest.approx(1.0)
    byte_bound = roofline.part(1.0, "int8", 3.35e12 * 2)
    assert roofline.least_s(byte_bound) == pytest.approx(2.0)
    parts = {"a": roofline.part(67e12, "f32", 0), "b": roofline.part(989e12, "bf16", 0)}
    assert roofline.compute_s(parts) == pytest.approx(2.0)


def fake_trace():
    tr = trace.Trace(window_s=1.0, n_calls=2)
    tr.kernels = [("resid_scan_kernel<1>", 0.10, 0.40), ("resid_centroid_kernel", 0.40, 0.45),
                  ("topk", 0.45, 0.50), ("resid_scan_kernel<1>", 0.60, 0.90),
                  ("memcpy", 0.89, 0.95)]
    tr.calls = [(0.05, 0.55), (0.55, 1.0)]
    tr.busy_s = trace.covered((0.0, 1.0), trace.union((a, b) for _, a, b in tr.kernels))
    return tr


def test_trace_arithmetic():
    tr = fake_trace()
    assert tr.busy_s == pytest.approx(0.75)
    assert tr.kernel_s(("resid_scan_kernel", "resid_centroid_kernel")) == pytest.approx(0.65)
    work = {"K1": roofline.part(1979e12 * 0.13, "int8", 0.0),
            "planner": roofline.part(67e12 * 0.02, "f32", 0.0)}
    ctx = SimpleNamespace(trace=tr, kernels={"K1": ("resid_scan_kernel",
                                                    "resid_centroid_kernel")}, work=work)
    assert readers.kernel_roofline_pct(ctx, "K1") == pytest.approx(100 * 0.13 / 0.325)
    assert readers.kernel_roofline_pct(ctx, "K5") is None
    assert readers.rest_device_ms(ctx) == pytest.approx(1e3 * 0.11 / 2)
    assert readers.idle_pct(ctx) == pytest.approx(25.0)
    assert readers.batch_mfu_pct(ctx) == pytest.approx(100 * 0.15 / 0.5)
    # call 1: 0.50 s, covered 0.40; call 2: 0.45 s, covered 0.35
    assert readers.host_gap_ms(ctx) == pytest.approx(1e3 * 0.10)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["resid_scan_kernel<1>", pytest.approx(0.6)]
    assert bd["idle_gaps"][0][1] == pytest.approx(0.10)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_readers_read_nothing_without_a_trace():
    ctx = SimpleNamespace(trace=None, kernels={}, work={})
    for name in ("k1_roofline_pct.qps", "k5_roofline_pct.qps", "idle_pct.qps",
                 "batch_mfu_pct.b64", "host_gap_ms.b64", "rest_device_ms.qps"):
        assert reader("layer_metrics", name)(ctx) is None
    assert reader("e2e_metrics", "serve_peak_gib")(SimpleNamespace(serve_peak_bytes=None)) \
        is None
