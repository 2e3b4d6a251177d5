"""The measuring entry points (``scripts/torch_*.py``, counterparts of the
reference's ``scripts/bench_*.py``, ``scripts/eval_sift.py`` and ``scripts/sweep_*.py``) on the CPU
at a tiny size: each ``main(device="cpu")`` runs to its closing JSON line,
with its module's sizes patched down (the encoder, the corpus, the
batches). The scripts' own arithmetic is held against the reference
scripts, imported by path: ``gen_passages`` string for string,
``geometry_stats`` within 1e-12, the latency reduction and the build-budget
projection and the sweeps' p_tiles against the reference's own statements
(read from its source), the pools sweep's rows against its list, and
eval_sift's exact row against the reference's on the same synthetic
base. On the CPU every kernel wrapper runs its plain version, so the
launch counts read 0."""

import ast
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudvectordb_tpu_torch.eval import harness
from cloudvectordb_tpu_torch.utils.config import EncoderConfig

REPO = Path(__file__).resolve().parents[2]
SCRIPTS = REPO / "scripts"
ENTRY_POINTS = ("bench_latency", "bench_build_budget", "bench_text_serving",
                "bench_encoder_real", "bench_encode", "bench_config2", "bench_config5",
                "eval_sift", "sweep_headline", "sweep_pq_pools", "bench_band", "bench_scale",
                "bench_filtered", "bench_fold", "bench_remove", "bench_ivf")
TINY_ENCODER = dict(hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(name: str):
    """A script of scripts/ as a module of its own (reference scripts import
    jax at their top; the port's do not)."""
    path = SCRIPTS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, monkeypatch, capsys, env: dict, consts: dict, argv: list) -> dict:
    """main(argv, device='cpu') with ``env`` set and the module's constants
    ``consts`` patched; its closing line, parsed, equal to what it returns."""
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    out = mod.main(argv, device="cpu")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(out, default=float))
    assert last["card"] == "cpu" and set(last["launches"].values()) == {0}
    return last


def test_every_entry_point_is_there_and_defaults_to_the_card():
    for name in ENTRY_POINTS:
        src = (SCRIPTS / f"torch_{name}.py").read_text()
        tree = ast.parse(src)
        mains = [f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main"]
        assert mains, name
        args = mains[0].args
        assert [a.arg for a in args.args] == ["argv", "device"], name
        assert [ast.literal_eval(d) for d in args.defaults] == [None, "cuda"], name
        assert "is_available" not in src, name  # no move to the CPU when no card is found


def test_latency(monkeypatch, capsys):
    mod = _load("torch_bench_latency")
    out = _run(mod, monkeypatch, capsys, {"BENCH_NLIST": 8, "LAT_BATCHES": "1,8",
                                          "LAT_REPS": 3},
               {"D": 32, "POOL": 256, "SELF_HIT_ROWS": 8}, ["0.003"])
    assert [r["B"] for r in out["rows"]] == [1, 8] and out["N"] == 3000
    for r in out["rows"]:
        assert r["tq"] == max(8, r["B"]) and 0 < r["p50_ms"] <= r["p99_ms"]
    assert out["self_hit"] >= mod.SELF_HIT_FLOOR


def test_build_budget(monkeypatch, capsys):
    mod = _load("torch_bench_build_budget")
    out = _run(mod, monkeypatch, capsys,
               {"BENCH_CHUNK": 2000, "BENCH_NLIST": 16, "RF_CFGS": "0:32"},
               {"D": 64, "M": 8, "B": 64, "NQ_GT": 32, "K_CEIL": 32, "TRAIN_SAMPLE": 2000,
                "ENC_B": 2, "ENC_L": 8, "ENC_ITERS": 1, "REPS": 1,
                "DECOMP": ((64, 1, 32, False),), "EncoderConfig": lambda max_len: EncoderConfig(
                    vocab_size=64, max_len=max_len, **TINY_ENCODER)},
               ["0.004", "0:64:1:32,0:32:2:32:1"])
    assert set(out["train"]) == {"opq_s", "kmeans_s", "pq_s"}
    assert [e["top2"] for e in out["eval"]] == [False, True]  # four fields: no top-2
    assert out["refine_scan"][0]["recall"] >= 0.9
    proj = out["projection"]
    assert proj["total_s"] == pytest.approx(proj["encode_s"] + proj["train_s"]
                                            + proj["populate_s"])


def test_text_serving(monkeypatch, capsys):
    mod = _load("torch_bench_text_serving")
    out = _run(mod, monkeypatch, capsys, {"N": 3000, "P": 8, "TQ": 16, "L": 8},
               {"D": 32, "NLIST": 8, "BATCHES": (1, 16), "ENCODER": TINY_ENCODER,
                "VOCAB": 256, "TOKENIZE_REPS": 1}, [])
    assert set(out["B"]) == {"1", "16"}
    assert out["B"]["16"]["tq"] == 16 and out["B"]["1"]["tq"] == 8


def test_encoder_real(monkeypatch, capsys):
    mod = _load("torch_bench_encoder_real")
    out = _run(mod, monkeypatch, capsys, {"UNIF": 1.0},
               {"ENCODER": TINY_ENCODER, "VOCAB": 512, "TOKENIZER_DOCS": 500, "MINE_DOCS": 2000,
                "NUM_TRIPLETS": 64, "TRAIN_BATCH": 16, "WARMUP": 1, "ENCODE_BATCH": 256,
                "CHUNK_ROWS": 1000, "HOST_ROWS": 1500, "B": 64, "NQ_GT": 32, "NLIST": 16,
                "IVF_NLIST": 8, "NPROBES": (2, 8)}, ["0.003", "2"])
    assert out["passages"] == 3000 and out["steps"] == 2
    w = out["witness"]
    assert 0.0 <= w["op"] <= 1.0 and w["full_coverage"] >= w["op"] - 1e-9
    assert out["reference"]["recall"] == 0.9436


def test_encode(monkeypatch, capsys):
    mod = _load("torch_bench_encode")
    out = _run(mod, monkeypatch, capsys, {"ENC_B": 2, "TRAIN_B": 2, "FUSED": 1},
               {"encoder_config": lambda: EncoderConfig(vocab_size=64, max_len=128,
                                                        **{**TINY_ENCODER, "num_heads": 1}),
                "ENC_ITERS": 1, "TRAIN_ITERS": 1}, [])
    assert [r["variant"].split(",")[0] for r in out["train"]] == [
        "naive", "naive", "packed (K4)", "fused (SDPA)"]
    assert out["fused_vs_naive_cos"] > mod.COS_FLOOR


def test_config2(monkeypatch, capsys):
    mod = _load("torch_bench_config2")
    out = _run(mod, monkeypatch, capsys, {},
               {"D": 32, "NLIST": 16, "TILES_NLIST": 8, "B": 16, "NQ": 8, "REPS": 1,
                "P_TILES": (1, 2)}, ["3000", "1,4,16"])
    assert [r["nprobe"] for r in out["ivf_flat"]][0] == 1
    assert out["ivf_flat"][-1]["recall"] == pytest.approx(1.0)
    assert [t["p_tiles"] for t in out["tiles"]] == [1, 2]


@pytest.mark.parametrize("refine,attach", [("pq2", "1"), ("none", "1")])
def test_config5(monkeypatch, capsys, refine, attach):
    mod = _load("torch_bench_config5")
    out = _run(mod, monkeypatch, capsys,
               {"REFINE": refine, "M2": 8, "BENCH_TILE_N": 128, "BENCH_CHUNK": 2000,
                "ATTACH_HOST": attach, "CASC": "16:4:0,16:0:1"},
               {"D": 32, "M": 8, "B": 128, "NQ_GT": 64, "CEILINGS": ((64, 2, False),),
                "PQ2_PLANS": ((8, 2, 32),), "HOST_B": 32, "ADDS": 64, "REPS": 1},
               ["0.004", "8", "8"])
    routes = [e["route"] for e in out["eval"]]
    assert routes == (["tier1", "ceiling", "pq2"] if refine == "pq2" else ["tier1"])
    assert out["refine"] == ("pq2+host" if refine == "pq2" else "host")
    assert [h["k_host"] for h in out["host"]] == [40, 160]  # hf 0: no host_factor
    assert out["add_self_hit"] >= 0.9


def test_sweep_headline(monkeypatch, capsys):
    mod = _load("torch_sweep_headline")
    out = _run(mod, monkeypatch, capsys,
               {"SWEEP_TILE_N": "128", "SWEEP_TQ": "16,32", "SWEEP_P": "1.0,1.4"},
               {"D": 32, "B": 64, "NQ_GT": 32, "CHUNK": 1000, "NLIST": 16, "REPS": 1},
               ["0.0045"])
    assert out["N"] == 4000 and [b["n_tiles"] for b in out["builds"]] == [32]
    assert [(r["tq"], r["p"]) for r in out["rows"]] == [(16, 32), (16, 32), (32, 32), (32, 32)]
    assert min(r["recall"] for r in out["rows"]) >= 0.9  # every tile scanned


def test_sweep_pq_pools(monkeypatch, capsys):
    mod = _load("torch_sweep_pq_pools")
    out = _run(mod, monkeypatch, capsys, {},
               {"D": 32, "M": 8, "B": 64, "NQ_GT": 32, "CHUNK": 1500, "TRAIN_SAMPLE": 2000,
                "TILE_N": 256, "TILE_Q": 16, "KMEANS_ITERS": 5, "REPS": 1},
               ["0.004", "16", "0"])
    assert out["N"] == 4000 and out["p_tiles"] == 8 and out["n_tiles"] == 16
    assert [(r["n_pools"], r["refine_factor"], r["top2"]) for r in out["rows"]] == list(
        mod.ROWS)
    assert set(out["train"]) == {"opq_s", "kmeans_s", "pq_s"}
    assert max(r["recall"] for r in out["rows"]) >= 0.8


def test_sweep_p_and_rows_match_the_reference():
    """The sweeps' p_tiles against the reference's own statements
    (sweep_headline.py:87, :100; sweep_pq_pools.py:93-94) and the pools
    sweep's rows against its list (:102-106)."""
    head, pools = _load("torch_sweep_headline"), _load("torch_sweep_pq_pools")
    src = SCRIPTS / "sweep_headline.py"
    ns = {}
    exec(_statements(src, "ref_cov", "ref_cov"), ns)  # noqa: S102
    assert head.REF_COV == ns["ref_cov"]
    for n_tiles in (100, 305, 6104, 12207):
        for frac in (0.7, 1.0, 1.4, 3.0):
            got = dict(ns, n_tiles=n_tiles, frac=frac)
            exec(_statements(src, "p", "p"), got)  # noqa: S102
            assert head.sweep_p(n_tiles, frac) == got["p"]
    for n_pad, arg in ((2_000_896, 0), (51_200, 0), (2_000_896, 64)):
        ns = {"idx": type("Idx", (), {"_n_pad_rows": n_pad, "tile_n": 1024}), "p_tiles_arg": arg}
        exec(_statements(SCRIPTS / "sweep_pq_pools.py", "n_tiles", "p_tiles"), ns)  # noqa: S102
        assert pools.sweep_p(ns["n_tiles"], arg) == ns["p_tiles"]
    loops = [n for n in ast.walk(ast.parse((SCRIPTS / "sweep_pq_pools.py").read_text()))
             if isinstance(n, ast.For) and isinstance(n.target, ast.Tuple)]
    assert tuple(tuple(r) for r in ast.literal_eval(loops[0].iter)) == pools.ROWS


def test_eval_sift(monkeypatch, capsys):
    mod = _load("torch_eval_sift")
    out = _run(mod, monkeypatch, capsys, {}, {"NPROBES": (1, 4, 16)},
               ["--n", "2000", "--nq", "40", "--nlist", "16"])
    assert out["source"] == "synthetic" and out["exact_recall"] == 1.0
    assert out["sweep"][-1]["recall"] == pytest.approx(1.0)


def test_eval_sift_reads_fvecs_files(tmp_path, monkeypatch, capsys):
    """``--base/--query/--gt`` read SIFT1M-format files: each row an int32
    dimension, then the values."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(500, 16)).astype(np.float32)
    query = base[:20] + 0.01 * rng.normal(size=(20, 16)).astype(np.float32)
    gt = np.argsort(((query[:, None] - base[None]) ** 2).sum(-1), axis=1)[:, :10]

    def write(path, a, dtype):
        rows = np.concatenate([np.full((a.shape[0], 1), a.shape[1], np.int32),
                               a.astype(dtype).view(np.int32)], axis=1)
        rows.tofile(path)

    write(tmp_path / "b.fvecs", base, np.float32)
    write(tmp_path / "q.fvecs", query, np.float32)
    write(tmp_path / "g.ivecs", gt, np.int32)
    mod = _load("torch_eval_sift")
    out = _run(mod, monkeypatch, capsys, {}, {"NPROBES": (1, 8)},
               ["--base", str(tmp_path / "b.fvecs"), "--query", str(tmp_path / "q.fvecs"),
                "--gt", str(tmp_path / "g.ivecs"), "--nlist", "8"])
    assert out["source"] == "sift" and out["base"] == [500, 16] and out["nq"] == 20
    assert out["exact_recall"] == 1.0


# -- the scripts' arithmetic against the reference scripts --------------------
def _statements(path: Path, first: str, last: str) -> str:
    """The source of the reference's statements from the last one assigning
    ``first`` before the last one assigning ``last``, to that one,
    inclusive, dedented."""
    src = path.read_text()
    lines = src.splitlines()
    nodes = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Assign)]

    def names(n):
        t = n.targets[0]
        return {e.id for e in (t.elts if isinstance(t, ast.Tuple) else [t])
                if isinstance(e, ast.Name)}

    end = max((n for n in nodes if last in names(n)), key=lambda n: n.lineno)
    a = max(n.lineno for n in nodes if first in names(n) and n.lineno <= end.lineno)
    b = end.end_lineno
    block = lines[a - 1:b]
    pad = min(len(ln) - len(ln.lstrip()) for ln in block if ln.strip())
    return "\n".join(ln[pad:] for ln in block)


def test_gen_passages_and_geometry_match_the_reference():
    ref = _load("bench_encoder_real")
    port = _load("torch_bench_encoder_real")
    assert port.gen_passages(3000, seed=11) == ref.gen_passages(3000, seed=11)
    emb = np.random.default_rng(5).normal(size=(600, 24)).astype(np.float32)
    emb[:, 0] += 2.0  # a shared direction: a mean cosine away from 0
    for got, want in zip(port.geometry_stats(emb), ref.geometry_stats(emb)):
        assert got == pytest.approx(want, abs=1e-12, rel=0)


@pytest.mark.parametrize("n", [1, 7, 30, 100, 101])
def test_latency_reduction_matches_the_reference(n):
    """p50 and p99 of a sample by the reference's own two statements."""
    lats = list(np.random.default_rng(n).exponential(size=n))
    ns = {"np": np, "lats": list(lats)}
    exec(_statements(SCRIPTS / "bench_latency.py", "lats", "p50"), ns)  # noqa: S102
    assert harness.p50_p99(lats) == (ns["p50"], ns["p99"])


@pytest.mark.parametrize("enc_ps,t_build,n", [(9000.0, 300.0, 10_000_000),
                                              (1234.5, 77.0, 1_000_000)])
def test_build_projection_matches_the_reference(enc_ps, t_build, n):
    """The reference scales its whole build (the quantizers' training
    inside) with the rows; the port scales only the populate, with the
    training held constant. With no training time the two agree; with
    some, the port's total is the reference's less the training's scaled
    share plus the training once."""
    port = _load("torch_bench_build_budget")
    ns = {"enc_ps": enc_ps, "t_build": t_build, "n": n}
    exec(_statements(SCRIPTS / "bench_build_budget.py", "rows_per_chip_100m", "total"), ns)  # noqa: S102
    got = port.projection(enc_ps, 0.0, t_build, n)
    assert got["rows"] == ns["rows_per_chip_100m"]
    assert got["encode_s"] == pytest.approx(ns["t_enc_100m"], rel=1e-12)
    assert got["populate_s"] == pytest.approx(ns["t_pop_100m"], rel=1e-12)
    assert got["total_s"] == pytest.approx(ns["total"], rel=1e-12)
    train = 0.25 * t_build
    split = port.projection(enc_ps, train, t_build - train, n)
    assert split["total_s"] == pytest.approx(
        ns["total"] - train * ns["rows_per_chip_100m"] / n + train, rel=1e-12)


def test_eval_sift_exact_row_matches_the_reference(monkeypatch, capsys):
    """The reference's exact row (its IVF sweep patched out) and the port's
    on the same synthetic base read the same recall, 1.0 on both: the exact
    row is the tiled f32 scan in both packages, so no parity fault."""
    import cloudvectordb_tpu.eval.sweep as jax_sweep
    from cloudvectordb_tpu.index import IVFFlatIndex as JaxIVFFlat

    ref = _load("eval_sift")
    monkeypatch.setattr(jax_sweep, "nprobe_sweep", lambda *a, **k: [])
    monkeypatch.setattr(JaxIVFFlat, "build", staticmethod(lambda *a, **k: None))
    argv = ["--n", "3000", "--nq", "60", "--metric", "l2"]
    monkeypatch.setattr(sys, "argv", ["eval_sift.py", *argv])
    ref.main()
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("exact"))
    want = float(line.split(":")[1].split()[0])
    port = _load("torch_eval_sift")
    args = port.parse(argv)
    base, queries, _, _ = port.load(args)
    from cloudvectordb_tpu_torch.eval.recall import brute_force_topk

    _, gt = brute_force_topk(base, queries, args.k, metric=args.metric)
    got, _ = port.exact_row(base, queries, gt, args.k, args.metric, "cpu")
    assert round(got, 4) == want == 1.0
