"""The port's spans (utils/metrics.py ``span``) on the search path: nothing
recorded and the same answers with no profiler; under one, a
``cvdb.search`` root a call with its planner, scan, copy, pending and
rescore spans inside it on the profiler's host timeline, the scan's tile
reads from its grid (a span a launch; K5's at the block width its launch
reports), no user annotation among them,
``StageTimer``'s stage span, the buffer's bound, and the benchmark's traced
run of a tiny cell recording one root a traced call."""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudvectordb_tpu_torch.index import ivf_band, ivf_band_pq
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.ops import band, pq
from cloudvectordb_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parents[2]
D, K, NQ = 32, 5, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_old_spans():
    metrics.reset_spans()
    yield
    metrics.reset_spans()


@pytest.fixture(scope="module")
def db():
    return np.random.default_rng(0).normal(size=(3000, D)).astype(np.float32)


def resid_index(db):
    return BandIVFIndex.build(db, nlist=8, kmeans_iters=3, tile_n=128, tile_q=16,
                              device="cpu", residual=True)


def pq_index(db):
    return BandIVFPQIndex.build(db, nlist=8, m=8, nbits=5, opq=True, kmeans_iters=3,
                                pq_train_iters=3, tile_n=128, tile_q=16, device="cpu")


def traced(fn):
    """Run ``fn`` under a CPU profiler: (its result, the profiler's events,
    the span records it left)."""
    metrics.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events(), metrics.span_records()["records"]


def named(recs, name):
    return [r for r in recs if r["name"] == name]


def intervals(events, name):
    """(start, end) of the profiler's host events ``name``, in time order."""
    return sorted((e.time_range.start, e.time_range.end) for e in events if e.name == name)


def inside(span, outer) -> bool:
    return outer[0] <= span[0] and span[1] <= outer[1]


@pytest.mark.parametrize("kind", ["resid", "pq"])
def test_no_profiler_records_nothing_and_changes_no_answer(db, monkeypatch, kind):
    idx = resid_index(db) if kind == "resid" else pq_index(db)
    kw = dict(p_tiles=4, tile_q=32) if kind == "resid" else dict(
        p_tiles=4, tile_q=32, serve_from="pq", refine_factor=8)
    q = db[:NQ]

    def answers():
        v, i = idx.search(q, K, **kw)
        vd, idd = idx.search_device(torch.as_tensor(q), K, **kw)
        return v, i, vd.numpy(), idd.numpy()

    with_spans = answers()
    assert metrics.span_records() == {"records": [], "dropped": 0}
    stub = lambda *a, **kw: contextlib.nullcontext()  # noqa: E731
    for mod in (ivf_band, ivf_band_pq, band, pq):
        monkeypatch.setattr(mod, "span", stub)
    for a, b in zip(with_spans, answers()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_search_device_gives_one_root_a_call_and_no_user_annotation(db):
    idx = resid_index(db)
    q = torch.as_tensor(db[:NQ])
    _, events, recs = traced(lambda: [idx.search_device(q, K, p_tiles=4, tile_q=32)
                                      for _ in range(2)])
    roots = [r for r in recs if r["root"]]
    assert [r["name"] for r in roots] == ["cvdb.search"] * 2
    assert len({r["call"] for r in roots}) == 2
    for root in roots:
        kids = {r["name"] for r in recs if r["call"] == root["call"] and not r["root"]}
        assert kids == {"cvdb.plan", "cvdb.scan"}
    assert all(set(r) == {"name", "call", "root", "counts"} for r in recs)
    assert named(recs, "cvdb.plan")[0]["counts"] == {}
    ours = [e for e in events if e.name.startswith("cvdb.")]
    assert {e.name for e in ours} == {"cvdb.search", "cvdb.plan", "cvdb.scan"}
    assert len(ours) == 6 and not any(e.is_user_annotation for e in ours)
    # each call's planner, then its scan, inside its root on the host timeline
    for call, plan, scan in zip(intervals(events, "cvdb.search"), intervals(events, "cvdb.plan"),
                                intervals(events, "cvdb.scan")):
        assert inside(plan, call) and inside(scan, call) and plan[1] <= scan[0]


@pytest.mark.parametrize("p,tq", [(4, 32), (6, 64)])
def test_scan_counts_the_grid_reads_and_the_launches_it_saw(db, monkeypatch, p, tq):
    """A ``cvdb.scan`` span a K1 launch, with the reads its grid schedules."""
    idx = resid_index(db)
    real = band._slots_reference

    def counted(*a, **kw):  # the CPU path counting a launch as the card's does
        band.tiles_topk_resid.launches += 1
        return real(*a, **kw)

    monkeypatch.setattr(band, "_slots_reference", counted)
    before = band.tiles_topk_resid.launches
    _, _, recs = traced(lambda: idx.search_device(torch.as_tensor(db[:NQ]), K, p_tiles=p,
                                                  tile_q=tq))
    scans = named(recs, "cvdb.scan")
    assert len(scans) == band.tiles_topk_resid.launches - before == 1
    n_qt = -(-NQ // tq)
    reads = n_qt * p * -(-tq // 32)
    assert scans[0]["counts"] == {"tile_reads": reads, "tile_read_bytes": reads * 128 * (D + 1)}


def _pq_inputs(rng, nq: int, tq: int, p: int, n_tiles: int = 3, tile_n: int = 128, m: int = 4,
               dsub: int = 8, w: int = 2):
    t = torch.as_tensor
    return dict(
        codes_cm=t(rng.integers(0, 32, size=(n_tiles * tile_n, m), dtype=np.uint8)),
        codebooks=t(rng.normal(size=(m, 32, dsub)).astype(np.float32)),
        queries_sorted=t(rng.normal(size=(nq, m * dsub)).astype(np.float32)),
        tile_table=t(rng.integers(0, n_tiles, size=(nq // tq, p)).astype(np.int32)),
        k=K, centroid_tiles=t(rng.normal(size=(n_tiles, w, m * dsub)).astype(np.float32)),
        local_ids=t(rng.integers(0, w, size=n_tiles * tile_n).astype(np.uint8)),
        tile_n=tile_n, tile_q=tq, row_major=True)


def _launching(monkeypatch, width):
    """K5's plain version standing in for a launch that reports the block
    width ``width(row_mask)`` (the card's rule decides it there)."""
    real = pq._pq_slots

    def launch(*a, **kw):
        v, r, _ = real(*a, **kw)
        return v, r, width(kw.get("row_mask"))

    monkeypatch.setattr(pq, "_pq_slots", launch)


@pytest.mark.parametrize("tq,width,blocks", [(32, 0, 1), (64, 0, 2), (128, 0, 4),
                                             (64, 64, 1), (128, 64, 2)])
def test_pq_scan_counts_the_reads_at_its_block_width(monkeypatch, tq, width, blocks):
    """K5's ``cvdb.scan`` span counts n_qt · P · ceil(tile_q / QB) at the
    block width QB its launch reports (64 or 32 on the card), and at
    SCAN_QB (32) where the plain version ran (width 0: the CPU's)."""
    p, nq = 5, 256
    args = _pq_inputs(np.random.default_rng(5), nq, tq, p)
    if width:
        _launching(monkeypatch, lambda mask: width)
    before = pq.pq_tiles_topk.launches
    (v, i), _, recs = traced(lambda: pq.pq_tiles_topk(**args))
    assert pq.pq_tiles_topk.launches - before == (1 if width else 0)
    (scan,) = named(recs, "cvdb.scan")
    reads = nq // tq * p * blocks
    assert scan["counts"] == {"tile_reads": reads, "tile_read_bytes": reads * 128 * (4 + 1)}
    v_ref, i_ref = pq.pq_tiles_topk_reference(**args)
    assert torch.equal(v, v_ref) and torch.equal(i, i_ref)


def test_pq_segmented_scan_counts_each_entry_at_its_segments_width(monkeypatch):
    """Segments that launch at different widths (here a masked one at 32
    and an unmasked one at 64, as the card's rule has it): each table entry
    counts at the width of the segment it lies in, an entry in no segment
    at the first segment's."""
    rng = np.random.default_rng(9)
    tq, p, nq, tile_n, m = 64, 6, 256, 128, 4
    parts = [_pq_inputs(rng, nq, tq, p, n_tiles=live + 1) for live in (2, 3)]
    mask0 = torch.as_tensor((rng.random(3 * tile_n) < 0.5).astype(np.int8))
    table = torch.as_tensor(rng.integers(0, 5, size=(nq // tq, p)).astype(np.int32))
    table[0, 0] = 7  # past both segments' 5 live tiles
    args = dict(parts[0], codes_cm=tuple(a["codes_cm"] for a in parts),
                centroid_tiles=tuple(a["centroid_tiles"] for a in parts),
                local_ids=tuple(a["local_ids"] for a in parts), row_mask=(mask0, None),
                tile_table=table)
    _launching(monkeypatch, lambda mask: 32 if mask is not None else 64)
    before = pq.pq_tiles_topk.seg_launches
    _, _, recs = traced(lambda: pq.pq_tiles_topk(**args))
    assert pq.pq_tiles_topk.seg_launches - before == 2
    (scan,) = named(recs, "cvdb.scan")
    t = table.numpy()
    reads = 2 * int((t < 2).sum()) + int(((t >= 2) & (t < 5)).sum()) + 2 * int((t >= 5).sum())
    assert scan["counts"] == {"tile_reads": reads, "tile_read_bytes": reads * tile_n * (m + 1)}


@pytest.mark.parametrize("method", ["search", "search_device"])
@pytest.mark.parametrize("kind", ["resid", "pq"])
def test_search_adds_the_copy_spans(db, kind, method):
    """One ``cvdb.search`` record a call, the root; ``search()`` adds the
    copies in and out around the planner and the scan, ``search_device()``
    none."""
    idx = resid_index(db) if kind == "resid" else pq_index(db)
    kw = dict(p_tiles=4, tile_q=32) if kind == "resid" else dict(
        p_tiles=4, tile_q=32, serve_from="pq", refine_factor=8)
    q = db[:NQ] if method == "search" else torch.as_tensor(db[:NQ])
    _, events, recs = traced(lambda: getattr(idx, method)(q, K, **kw))
    (root,) = named(recs, "cvdb.search")
    assert root["root"] and [r for r in recs if r["root"]] == [root]
    assert all(r["call"] == root["call"] for r in recs)
    assert not any(e.is_user_annotation for e in events if e.name.startswith("cvdb."))
    if method == "search_device":
        assert not named(recs, "cvdb.search.in") and not named(recs, "cvdb.search.out")
        return
    # the copy in before the planner, the copy out after the scan, in the call
    (call,), (cin,), (cout,) = (intervals(events, n) for n in (
        "cvdb.search", "cvdb.search.in", "cvdb.search.out"))
    (plan,), (scan,) = intervals(events, "cvdb.plan"), intervals(events, "cvdb.scan")
    assert inside(cin, call) and inside(cout, call)
    assert cin[1] <= plan[0] and scan[1] <= cout[0]


def test_pending_span_only_once_rows_are_added(db):
    idx = resid_index(db)
    q = torch.as_tensor(db[:NQ])
    _, _, recs = traced(lambda: idx.search_device(q, K, p_tiles=4, tile_q=32))
    assert not named(recs, "cvdb.pending")
    idx.add(np.random.default_rng(1).normal(size=(50, D)).astype(np.float32))
    _, _, recs = traced(lambda: idx.search_device(q, K, p_tiles=4, tile_q=32))
    (pend,) = named(recs, "cvdb.pending")
    (root,) = [r for r in recs if r["root"]]
    assert pend["call"] == root["call"] and pend["counts"] == {}


def test_pq_route_gives_the_rescore_span(db):
    idx = pq_index(db)
    p, tq, rf = 4, 32, 8
    _, events, recs = traced(lambda: idx.search(db[:NQ], K, p_tiles=p, tile_q=tq,
                                                serve_from="pq", refine_factor=rf))
    (res,) = named(recs, "cvdb.rescore")
    (root,) = [r for r in recs if r["root"]]
    assert res["call"] == root["call"]
    (scan_t,), (res_t,) = intervals(events, "cvdb.scan"), intervals(events, "cvdb.rescore")
    assert scan_t[1] <= res_t[0]  # the rescore of the scan's candidates
    (scan,) = named(recs, "cvdb.scan")
    assert scan["counts"]["tile_reads"] == 2 * p
    assert scan["counts"]["tile_read_bytes"] == 2 * p * 128 * (8 + 1)  # codes, local byte
    assert {r["name"] for r in recs} == {"cvdb.search", "cvdb.search.in", "cvdb.plan",
                                          "cvdb.scan", "cvdb.rescore", "cvdb.search.out"}


def test_stage_timer_opens_a_stage_span(tmp_path):
    path = tmp_path / "metrics.jsonl"

    def stage():
        with metrics.MetricsWriter(path) as mw, metrics.StageTimer(mw, "build"):
            pass

    _, events, recs = traced(stage)
    (stage,) = recs
    assert stage == {"name": "cvdb.stage.build", "call": None, "root": False, "counts": {}}
    assert [e.name for e in events if e.name.startswith("cvdb.")] == ["cvdb.stage.build"]
    line = path.read_text().splitlines()
    assert len(line) == 1 and '"stage": "build"' in line[0] and '"wall_s"' in line[0]


def test_buffer_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(metrics, "SPAN_CAP", 3)

    def spans():
        for i in range(5):
            with metrics.span("cvdb.plan", queries=i):
                pass

    _, _, recs = traced(spans)
    assert [r["counts"]["queries"] for r in recs] == [0, 1, 2]
    assert metrics.span_records()["dropped"] == 2
    metrics.reset_spans()
    assert metrics.span_records() == {"records": [], "dropped": 0}


def test_benchmark_traced_run_records_one_root_a_traced_call(monkeypatch):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from cvdb_bench import cell, trace
    from cvdb_bench.tests._tiny import tiny_cell

    kept = []
    real = trace.profile

    def profile(body, dev):
        kept.append(real(body, dev))
        return kept[-1]

    monkeypatch.setattr(trace, "profile", profile)
    out = cell.run(tiny_cell("resid12m.fresh.b4096"), 2**31 + 99, 0.3, True,
                   torch.device("cpu"), 0.0, log=lambda m: None)
    assert out["correct"]
    recs = metrics.span_records()["records"]
    roots = [r for r in recs if r["root"]]
    assert len(roots) == kept[0].n_calls == 2
    for root in roots:
        names = sorted(r["name"] for r in recs if r["call"] == root["call"])
        assert names == ["cvdb.pending", "cvdb.plan", "cvdb.scan", "cvdb.search"]
