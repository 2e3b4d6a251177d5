"""The port's counterparts of the reference's last six measuring scripts
(``scripts/torch_bench_{band,scale,filtered,fold,remove,ivf}.py``) on the
CPU at a tiny size: each ``main(device="cpu")`` runs to its closing JSON
line with its module's sizes patched down. Held against the reference:
bench_ivf's host arena (its own statements, read from its source and
executed) byte for byte, and the port's probe scan over the script's
hand-built state against the JAX ``_ivfpq_scan_search``; bench_scale's p
clamp and share arithmetic. Three faults of the reference's scripts are
held with both behaviours recorded: bench_filtered's merged ground truth
is not exact at low selectivity, bench_fold's self-hit counts any added id,
and bench_remove reports an unfilled -1 slot as a removed id. On the CPU
every kernel wrapper runs its plain version, so the launch counts read 0.
Kept apart from test_torch_scripts.py so that xdist's ``--dist loadfile``
can run the two files on two workers."""

import ast
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.index.ivf_pq import _ivfpq_scan_search as jax_ivfpq_scan_search
from cloudvectordb_tpu.ops.topk import tiled_topk as jax_tiled_topk
from cloudvectordb_tpu_torch.eval import harness
from cloudvectordb_tpu_torch.eval.recall import recall_at_k
from cloudvectordb_tpu_torch.index.ivf_pq import _ivfpq_scan_search
from test_torch_scripts import SCRIPTS, _load, _run, _statements


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- each script to its closing line ------------------------------------------
def test_band(monkeypatch, capsys):
    mod = _load("torch_bench_band")
    out = _run(mod, monkeypatch, capsys, {},
               {"N": 16_384, "D": 32, "NLIST": 16, "B": 256, "P_TILES": (2, 8), "ITERS": 1}, [])
    assert out["n_tiles"] == 8 and [r["p_tiles"] for r in out["rows"]] == [2, 8]
    assert out["rows"][-1]["share"] == 1.0 and out["rows"][-1]["recall"] >= 0.9
    assert out["full_scan"]["recall"] >= 0.9


@pytest.mark.parametrize("resid", ["1", "0"])
def test_scale(monkeypatch, capsys, resid):
    mod = _load("torch_bench_scale")
    out = _run(mod, monkeypatch, capsys, {"BENCH_CHUNK": 4000, "BENCH_RESID": resid},
               {"D": 32, "B": 256, "NQ_GT": 32, "REPS": 1}, ["0.0164", "16", "2,64"])
    assert out["N"] == 16_400 and out["residual"] == (resid == "1")
    modes = ["resid"] if resid == "1" else ["hybrid", "int8"]
    n_tiles = out["n_tiles"]
    assert [(r["mode"], r["p_tiles"]) for r in out["rows"]] == [
        (m, p) for m in modes for p in (2, n_tiles)]  # 64 clamped to the arena
    assert min(r["recall"] for r in out["rows"] if r["p_tiles"] == n_tiles) >= 0.9


def test_filtered(monkeypatch, capsys):
    mod = _load("torch_bench_filtered")
    out = _run(mod, monkeypatch, capsys,
               {"N_ROWS": 16_000, "SELS": "0.5,0.02", "BENCH_P": 2, "BENCH_TQ": 16},
               {"CHUNK": 4000, "D": 32, "NLIST": 16, "B": 64, "NQ_GT": 32, "GT_PER_CHUNK": 16,
                "REPS": 1}, [])
    assert [r["sel"] for r in out["rows"]] == [0.5, 0.02]
    assert out["rows"][0]["more_tiles"] == []
    assert [r["p"] for r in out["rows"][1]["more_tiles"]] == [4, 8]
    full = out["rows"][1]["more_tiles"][-1]  # p 8: every tile
    assert full["recall"] >= 0.9
    # 2% of 16,000 rows: a chunk's top-16 holds 0.32 allowed rows on average
    assert out["rows"][1]["reference_gt_overlap"] < 1.0


def test_fold(monkeypatch, capsys):
    mod = _load("torch_bench_fold")
    out = _run(mod, monkeypatch, capsys, {"N": 16_000, "ADD": 256, "NLIST": 16},
               {"CHUNK": 4000, "D": 32}, [])
    assert out["inplace"] and out["ntotal"] == 16_256
    full = out["self_hit"]["full"]
    assert full["p_tiles"] == out["cap_rows"] // 2048
    assert full["own"] >= mod.SELF_HIT_MERGED and full["any_added"] >= full["own"]


def test_remove(monkeypatch, capsys):
    mod = _load("torch_bench_remove")
    out = _run(mod, monkeypatch, capsys,
               {"N_ROWS": 16_000, "CHUNK": 4000, "NLIST": 16, "REMOVE_B": 64, "ROUNDS": 2},
               {"D": 32, "NQ": 32}, [])
    assert out["removed"] == 128 and out["ntotal"] == 16_000 - 128 + 64
    assert len(out["rounds"]) == 2 and 0.0 < out["host_share"] <= 1.0


def test_ivf(monkeypatch, capsys):
    mod = _load("torch_bench_ivf")
    out = _run(mod, monkeypatch, capsys, {},
               {"N": 4000, "D": 32, "M": 8, "NLIST": 16, "B": 32, "SAMPLE": 2000,
                "ENC_CHUNK": 1500, "NPROBES": (1, 16)}, [])
    assert [r["nprobe"] for r in out["rows"]] == [1, 16]
    assert out["rows"][1]["recall"] >= out["rows"][0]["recall"] and out["cap"] > 0


# -- against the reference -----------------------------------------------------
def test_direct_corpus_draws_what_chip_smoke_drew():
    """harness.direct_corpus is chip_smoke.py's corpus process, moved: the
    same tensors for a fixed seed as the function it replaced (its body
    below, as it stood in chip_smoke.py), and chip_smoke now imports it."""
    import chip_smoke

    def before_the_move(dev, n, d, nq, seed=0):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        centers = torch.randn((256, d), generator=g, device=dev)
        centers = centers / centers.norm(dim=1, keepdim=True)
        a = torch.randint(0, 256, (n,), generator=g, device=dev)
        x = centers[a] + (0.3 / d ** 0.5) * torch.randn((n, d), generator=g, device=dev)
        x = x / x.norm(dim=1, keepdim=True)
        sel = torch.randint(0, n, (nq,), generator=g, device=dev)
        q = x[sel] + (0.1 / d ** 0.5) * torch.randn((nq, d), generator=g, device=dev)
        return x, q / q.norm(dim=1, keepdim=True)

    assert chip_smoke.direct_corpus is harness.direct_corpus
    dev = torch.device("cpu")
    for seed in (0, 5):
        for got, want in zip(harness.direct_corpus(dev, 3000, 24, 40, seed),
                             before_the_move(dev, 3000, 24, 40, seed)):
            assert torch.equal(got, want)


def _arena_inputs(n=600, nlist=8, m=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, nlist, n).astype(np.int32), rng.integers(0, 256, (n, m), np.uint8)


def test_ivf_host_arena_matches_the_reference():
    """bench_ivf.py:72-78 executed from its source equals the port's
    ``host_arena`` byte for byte."""
    mod = _load("torch_bench_ivf")
    for n, nlist in ((600, 8), (5000, 64)):
        a_np, codes_np = _arena_inputs(n, nlist)
        ns = {"np": np, "a_np": a_np, "codes_np": codes_np, "NLIST": nlist}
        exec(_statements(SCRIPTS / "bench_ivf.py", "order", "cap"), ns)  # noqa: S102
        got = mod.host_arena(a_np, codes_np, nlist)
        for g, name in zip(got, ("arena", "ids", "offsets", "lens", "cap")):
            want = ns[name]
            if name == "cap":
                assert g == want
            else:
                assert g.dtype == want.dtype and g.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("nprobe", [1, 8])
def test_ivf_scan_over_the_hand_built_state_matches_jax(nprobe):
    """The port's ``_ivfpq_scan_search`` over ``scan_state`` of the host
    arena against the JAX scan on the same numpy inputs, nprobe 1 and
    nprobe = nlist: rows equal but within exact-tie runs, scores within
    rtol 1e-5."""
    mod = _load("torch_bench_ivf")
    nlist, m, d, k = 8, 4, 16, 10
    rng = np.random.default_rng(7)
    a_np, codes_np = _arena_inputs(600, nlist, m)
    arena, _, offsets, lens, cap = mod.host_arena(a_np, codes_np, nlist)
    cent = rng.normal(size=(nlist, d)).astype(np.float32)
    cb = (0.3 * rng.normal(size=(m, 256, d // m))).astype(np.float32)
    q = rng.normal(size=(12, d)).astype(np.float32)
    st = mod.scan_state(cent, arena, offsets, lens, cb, torch.device("cpu"))
    v, rows = _ivfpq_scan_search(torch.from_numpy(q), st, k=k, nprobe=nprobe, metric="ip",
                                 residual=True)
    jv, jrows = jax_ivfpq_scan_search(
        jnp.asarray(q), jnp.asarray(cent), jnp.asarray(arena), jnp.asarray(offsets),
        jnp.asarray(lens), jnp.asarray(cb), k=k, nprobe=nprobe, cap=cap, metric="ip",
        residual=True)
    v, rows, jv, jrows = v.numpy(), rows.numpy(), np.asarray(jv), np.asarray(jrows)
    assert np.isfinite(v).all()
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=0)
    for i in range(q.shape[0]):
        for s in np.unique(np.round(jv[i], 5)):  # each run of equal scores as a set
            at = np.round(jv[i], 5) == s
            if at.all() or not at[-1]:  # a run cut by the k-th slot may differ
                assert set(rows[i][at]) == set(jrows[i][at])


def test_scale_clamp_and_share_match_the_reference():
    """bench_scale.py's clamp (:113), coverage (:148) and '× share' (its
    print's ``qps/6250``) against the port's."""
    mod = _load("torch_bench_scale")
    src = SCRIPTS / "bench_scale.py"
    share = next(n for n in ast.walk(ast.parse(src.read_text()))
                 if isinstance(n, ast.BinOp) and isinstance(n.right, ast.Constant)
                 and n.right.value == 6250)
    share = compile(ast.Expression(share), str(src), "eval")
    for n_tiles in (9, 640, 6104):
        for p in (128, 640, 1024, 8192):
            ns = {"p_tiles": p, "n_tiles": n_tiles}
            exec(_statements(src, "p_tiles", "p_tiles"), ns)  # noqa: S102
            assert mod.clamp_p(p, n_tiles) == ns["p_tiles"]
            exec(_statements(src, "cov", "cov"), ns)  # noqa: S102
            assert mod.clamp_p(p, n_tiles) / n_tiles == ns["cov"]
    for qps in (1.0, 6250.0, 98_425.3):
        assert mod.share(qps) == eval(share, {"qps": qps})  # noqa: S307


# -- the reference's faults, both behaviours recorded ----------------------------
def test_filtered_reference_ground_truth_misses_at_low_selectivity():
    """bench_filtered.py:119-128's ground truth (each chunk's top-m,
    post-filtered, merged), executed from its source through its own
    ``tiled_topk`` and ``lax.top_k``, misses true neighbours where a chunk's
    top-m holds few allowed rows; the port's ``merged_chunk_gt`` reproduces
    it id for id, and ``exact_topk_chunks(allow=)`` equals a brute-force
    masked top-k."""
    mod = _load("torch_bench_filtered")
    chunk, n_chunks, d, nq, k, per_chunk = 400, 5, 16, 16, 10, 16
    rng = np.random.default_rng(11)
    x = rng.normal(size=(chunk * n_chunks, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:nq] + 0.1 * rng.normal(size=(nq, d)).astype(np.float32)
    mask = rng.random(x.shape[0]) < 0.1  # a chunk's top-16 holds 1.6 allowed rows

    src = (SCRIPTS / "bench_filtered.py").read_text()
    lines = src.splitlines()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "gt_merge")
    a = next(i for i, ln in enumerate(lines) if "best_v = jnp.full" in ln)
    b = next(i for i, ln in enumerate(lines) if "gt = jax.device_get(best_i)" in ln)
    ns = {"jax": jax, "jnp": jnp, "np": np, "tiled_topk": jax_tiled_topk, "K": k,
          "NQ_GT": nq, "GT_PER_CHUNK": per_chunk, "CHUNK": chunk, "n_chunks": n_chunks,
          "mask": mask, "q": jnp.asarray(q),
          "chunk_fn": lambda ci: jnp.asarray(x[ci * chunk:(ci + 1) * chunk])}
    exec(textwrap.dedent("\n".join(lines[fn.decorator_list[0].lineno - 1:fn.end_lineno])),  # noqa: S102
         ns)
    exec(textwrap.dedent("\n".join(lines[a:b + 1])), ns)  # noqa: S102
    ref = np.asarray(ns["gt"])

    s = q.astype(np.float64) @ x.T.astype(np.float64)
    s[:, ~mask] = -np.inf
    brute = np.argsort(-s, axis=1, kind="stable")[:, :k]
    chunk_fn = (lambda ci: torch.from_numpy(x[ci * chunk:(ci + 1) * chunk]))
    qt, allow = torch.from_numpy(q), torch.from_numpy(mask)
    _, exact = harness.exact_topk_chunks(chunk_fn, n_chunks, qt, k, allow=allow)
    assert np.array_equal(exact.numpy(), brute)
    assert recall_at_k(ref, brute) < 1.0  # the reference's recipe misses
    port_ref = mod.merged_chunk_gt(mod.chunk_tops(chunk_fn, n_chunks, qt, per_chunk), allow, k)
    filled = np.take_along_axis(s, ref, axis=1) > -np.inf
    assert np.array_equal(port_ref.numpy()[filled], ref[filled])
    assert mod.miss_share(ref, brute) > 0.0 and mod.miss_share(exact.numpy(), brute) == 0.0


def test_fold_reference_self_hit_counts_any_added_id():
    """bench_fold.py:80 scores a self-hit as any added id (>= N): an added
    row that finds another added row counts. The port scores the row's own
    id and reports the reference's measure beside it."""
    mod = _load("torch_bench_fold")
    n0 = 1000
    found = (n0 + np.array([0, 1, 0, 3, 7, 42]))[:, None]  # rows 2 and 4 find another added row
    found = np.concatenate([found, [[5]]])  # row 6 finds an original row
    ns = {"found": found, "N": n0}
    exec(_statements(SCRIPTS / "bench_fold.py", "self_hit", "self_hit"), ns)  # noqa: S102
    own, any_added = mod.self_hits(found, n0)
    assert any_added == ns["self_hit"] == 6 / 7
    assert own == 3 / 7


def test_remove_reference_reports_an_unfilled_slot_as_a_removed_id():
    """bench_remove.py:102-103 flags any id neither live nor >= N, so an
    unfilled -1 slot reads as 'removed id surfaced'. The port checks the
    two apart: removed ids returned, and -1 in a filled slot."""
    mod = _load("torch_bench_remove")
    src = (SCRIPTS / "bench_remove.py").read_text()
    check = next(n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Assert)
                 and isinstance(n.msg, ast.Constant) and n.msg.value == "removed id surfaced")
    check = compile(ast.Expression(check.test), "bench_remove.py", "eval")
    n, removed = 100, np.array([3, 17])
    live_set = set(range(n)) - set(removed.tolist())
    cases = {  # ids, scores -> (reference passes, port's two counts)
        "unfilled -1": ([[5, 8, -1]], [[0.9, 0.8, -np.inf]], (False, (0, 0))),
        "removed id": ([[5, 17, 8]], [[0.9, 0.8, 0.7]], (False, (1, 0))),
        "filled -1": ([[5, -1, 8]], [[0.9, 0.8, 0.7]], (False, (0, 1))),
        "clean": ([[5, 8, 9]], [[0.9, 0.8, 0.7]], (True, (0, 0))),
    }
    for name, (ids, v, (ref_ok, port)) in cases.items():
        g1 = np.array(ids)
        assert eval(check, {"g1": g1, "live_set": live_set, "N": n}) is ref_ok, name  # noqa: S307
        assert mod.post_remove_faults(np.array(v), g1, removed) == port, name
