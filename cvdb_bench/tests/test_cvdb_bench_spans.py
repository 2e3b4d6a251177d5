"""The readers of the program's spans (``spans.py`` and its six metrics) by
hand arithmetic on a fake trace and fake span records: a layer's device
ms from the ops launched inside its spans (idle time between them not
counted), tile reads and the issued rate, idle time under the copy spans
only, and None with no trace, no device op, no spans (a program without
them), spans dropped, a number of calls that differs from the trace's, or
launches that do not match the device ops."""

from types import SimpleNamespace

import pytest

from cvdb_bench import cell, spans, trace

NAMES = ("plan_device_ms.qps", "rescore_device_ms.qps", "pending_device_ms.qps",
         "scan_tile_reads.qps", "scan_issued_tbs.qps", "copy_idle_ms.b64")
DEVICE_MS = NAMES[:3]
KERNELS = {"K1": ("resid_scan_kernel", "resid_centroid_kernel")}
H2D, D2H = "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)"

#: each call: (span, host start, host end, [(launch, host time, device op,
#: device start, device end), ...]) on one stream, device ops in launch order
CALLS = [
    [("cvdb.search.in", 0.05, 0.12, [("cudaMemcpyAsync", 0.06, H2D, 0.07, 0.08)]),
     ("cvdb.plan", 0.12, 0.20, [("cudaLaunchKernel", 0.13, "gemm", 0.14, 0.16)]),
     ("cvdb.scan", 0.20, 0.30, [("cudaLaunchKernel", 0.21, "resid_centroid_kernel", 0.22, 0.25),
                                ("cudaLaunchKernel", 0.23, "resid_scan_kernel<1>", 0.25, 0.40)]),
     ("cvdb.rescore", 0.30, 0.36, [("cuLaunchKernel", 0.31, "gather", 0.40, 0.43),
                                   ("cudaLaunchKernelExC", 0.33, "gemv2T", 0.44, 0.46)]),
     ("cvdb.pending", 0.36, 0.40, [("cudaMemsetAsync", 0.37, "Memset (Device)", 0.46, 0.47)]),
     ("cvdb.search.out", 0.48, 0.55, [("cudaMemcpyAsync", 0.49, D2H, 0.50, 0.51)])],
    [("cvdb.search.in", 0.55, 0.62, [("cudaMemcpyAsync", 0.56, H2D, 0.58, 0.59)]),
     ("cvdb.plan", 0.62, 0.66, [("cudaLaunchKernel", 0.63, "gemm", 0.59, 0.63)]),
     ("cvdb.scan", 0.66, 0.75, [("cudaLaunchKernel", 0.67, "resid_centroid_kernel", 0.67, 0.69),
                                ("cudaLaunchKernel", 0.68, "resid_scan_kernel<1>", 0.69, 0.87)]),
     ("cvdb.rescore", 0.75, 0.80, [("cuLaunchKernel", 0.76, "gather", 0.87, 0.90),
                                   ("cudaLaunchKernelExC", 0.77, "gemv2T", 0.92, 0.96)]),
     ("cvdb.pending", 0.80, 0.85, [("cudaMemsetAsync", 0.81, "Memset (Device)", 0.96, 0.98)]),
     ("cvdb.search.out", 0.95, 1.0, [("cudaMemcpyAsync", 0.96, D2H, 0.98, 0.99)])],
]


def reader(name):
    return cell.load_module(cell.HERE / "layer_metrics" / f"{name}.py").read


def fake_trace(calls=CALLS):
    tr = trace.Trace(window_s=1.0, n_calls=len(calls), calls=[(0.05, 0.55), (0.55, 1.0)])
    for (ca, cb), spans_ in zip(tr.calls, calls):
        tr.host_ops.append(("cvdb.search", ca, cb))
        for name, a, b, launches in spans_:
            tr.host_ops.append((name, a, b))
            for launch, t, op, x, y in launches:
                tr.host_ops.append((launch, t, t + 0.005))
                tr.kernels.append((op, x, y))
    tr.host_ops += [("aten::to", 0.50, 0.55), ("cudaEventRecord", 0.35, 0.351),
                    ("cudaStreamSynchronize", 0.495, 0.499), ("cvdb.search.in", 1.1, 1.2)]
    tr.busy_s = trace.covered((0.0, 1.0), trace.union((a, b) for _, a, b in tr.kernels))
    return tr


def rec(name, call, root=False, **counts):
    return {"name": name, "call": call, "root": root, "counts": counts}


def fake_records(calls=(1, 2)):
    out = []
    for call in calls:
        out += [rec(n, call) for n in ("cvdb.search.in", "cvdb.plan")]
        out += [rec("cvdb.scan", call, tile_reads=28_672, tile_read_bytes=45 * 10**9),
                rec("cvdb.rescore", call), rec("cvdb.pending", call),
                rec("cvdb.search.out", call), rec("cvdb.search", call, root=True)]
    out.append(rec("cvdb.stage.build", None))  # outside any call: read by none
    return out


@pytest.fixture
def program(monkeypatch):
    """give(result): what the program's ``span_records()`` returns."""
    from cloudvectordb_tpu_torch.utils import metrics

    def give(got):
        monkeypatch.setattr(metrics, "span_records", lambda: got)

    give({"records": fake_records(), "dropped": 0})
    return give


@pytest.fixture
def ctx(program):
    return SimpleNamespace(trace=fake_trace(), kernels=KERNELS, work={})


def test_layer_device_ms_is_the_median_over_calls_of_the_ops_issued(ctx):
    # plan: 0.02 and 0.04 s; rescore: 0.03 + 0.02 (the idle 0.43-0.44 not
    # counted) and 0.03 + 0.04; pending: the fills, 0.01 and 0.02
    assert reader("plan_device_ms.qps")(ctx) == pytest.approx(30.0)
    assert reader("rescore_device_ms.qps")(ctx) == pytest.approx(60.0)
    assert reader("pending_device_ms.qps")(ctx) == pytest.approx(15.0)
    # the scan's two kernels: 0.18 and 0.20 s
    assert spans.device_ms(ctx, "cvdb.scan") == pytest.approx(190.0)


def test_a_call_without_the_span_reads_none(ctx):
    calls = [CALLS[0], [s for s in CALLS[1] if s[0] != "cvdb.pending"]]
    ctx.trace = fake_trace(calls)
    assert reader("pending_device_ms.qps")(ctx) is None
    assert reader("plan_device_ms.qps")(ctx) == pytest.approx(30.0)


def test_launches_that_do_not_match_the_device_ops_read_none(ctx):
    assert spans.launched(ctx.trace) is not None
    lost = fake_trace()
    lost.host_ops = [op for op in lost.host_ops if op[:2] != ("cudaLaunchKernel", 0.13)]
    assert spans.launched(lost) is None  # one launch fewer than device ops
    swapped = fake_trace()
    swapped.host_ops = [("cudaLaunchKernel",) + op[1:] if op[:2] == ("cudaMemcpyAsync", 0.06)
                        else op for op in swapped.host_ops]
    assert spans.launched(swapped) is None  # a copy's launch named a kernel's
    for tr in (lost, swapped):
        ctx.trace = tr
        for name in DEVICE_MS:
            assert reader(name)(ctx) is None, name
        assert reader("scan_tile_reads.qps")(ctx) == 28_672  # the counts still read


def test_scan_reads_and_issued_rate(ctx):
    assert reader("scan_tile_reads.qps")(ctx) == 28_672
    # 45 GB a call over the scan kernels' 0.18 + 0.20 s of two calls
    assert reader("scan_issued_tbs.qps")(ctx) == pytest.approx(45e9 / 0.19 / 1e12)
    assert spans.scan_issued_tbs(SimpleNamespace(trace=ctx.trace, kernels={})) is None


def test_copy_idle_counts_only_idle_time_under_the_copy_spans(ctx):
    # call 1: in 0.05-0.12, its copy 0.07-0.08 (idle 0.06); out 0.48-0.55, its
    # copy 0.50-0.51 (idle 0.06), the aten::to beside it not counted: 0.12.
    # Call 2: in 0.55-0.62 under the copy and the gemm from 0.58 (idle 0.03);
    # out 0.95-1.0 under ops but for 0.99-1.0 (idle 0.01): 0.04. The span past
    # the calls is in neither.
    assert reader("copy_idle_ms.b64")(ctx) == pytest.approx(1e3 * 0.08)
    ctx.trace.host_ops = [op for op in ctx.trace.host_ops if op[0] not in spans.COPIES]
    assert reader("copy_idle_ms.b64")(ctx) is None


def test_nothing_to_read(ctx, program):
    for name in NAMES:  # the fake is readable
        assert reader(name)(ctx) is not None, name
    ok = {"records": fake_records(), "dropped": 0}
    cases = {"no trace": (None, ok),
             "no device op": (trace.Trace(n_calls=2, calls=fake_trace().calls), ok),
             "no spans kept": (fake_trace(), {"records": [], "dropped": 0}),
             "spans dropped": (fake_trace(), {"records": fake_records(), "dropped": 1}),
             "calls differ": (fake_trace(), {"records": fake_records((1,)), "dropped": 0})}
    for why, (tr, got) in cases.items():
        program(got)
        c = SimpleNamespace(trace=tr, kernels=KERNELS, work={})
        for name in NAMES:
            assert reader(name)(c) is None, (why, name)


def test_a_program_without_spans_reads_none(monkeypatch):
    """A program from before the spans has no ``span_records``."""
    from cloudvectordb_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "span_records")
    assert spans.program_records() is None
    c = SimpleNamespace(trace=fake_trace(), kernels=KERNELS, work={})
    assert all(reader(name)(c) is None for name in NAMES)
