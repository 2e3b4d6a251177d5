"""pipeline/run.py against the JAX package's pipeline on the same tiny
configuration (tests/integration/test_pipeline_e2e.py's ``_tiny_cfg``),
each package run once from raw text: byte-identical passages.jsonl and
triplets.jsonl (tokenizer.json is not compared: WordPiece training is not
deterministic from run to run); the port's recall@10 1.0 at full probe,
falling losses, every artifact and marker; the reference's trained weights
carried into the port encode the reference's passages, through the
reference's tokenizer.json, within 1e-5 of its embeddings.npy; the tune
stage (a persisted op point; flat's exact note); fault injection and
resume; the ``ckpt_dir`` default, where the reference orphans an older
workdir's checkpoints and the port resumes from them; and the eval's
host-clock rate, ``qps_bench``."""

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.pipeline.run import Pipeline as JaxPipeline
from cloudvectordb_tpu.utils.config import PipelineConfig as JaxPipelineConfig
from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer
from cloudvectordb_tpu_torch.eval.recall import recall_at_k
from cloudvectordb_tpu_torch.index.registry import load_index
from cloudvectordb_tpu_torch.models.embed import encode_corpus
from cloudvectordb_tpu_torch.models.encoder import Encoder
from cloudvectordb_tpu_torch.models.hf_import import state_dict_from_flax
from cloudvectordb_tpu_torch.pipeline.run import FailInjection, Pipeline
from cloudvectordb_tpu_torch.utils.config import EncoderConfig, PipelineConfig, TrainConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_E2E = Path(__file__).resolve().parents[1] / "integration" / "test_pipeline_e2e.py"
STAGES = ("mine", "train", "encode", "build", "tune", "eval")
ARTIFACTS = ("passages.jsonl", "tokenizer.json", "triplets.jsonl", "embeddings.npy",
             "index", "eval.json", "metrics.jsonl", "pipeline_config.json", "ckpt")


def _tiny_cfg(tmp_path, kind="ivf_flat") -> dict:
    """test_pipeline_e2e.py's configuration, as a dict both packages load."""
    spec = importlib.util.spec_from_file_location("_pipeline_e2e_model", _E2E)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return json.loads(mod._tiny_cfg(tmp_path, kind=kind).to_json())


def _port_cfg(d: dict, **top) -> PipelineConfig:
    return PipelineConfig.from_dict({**d, **top})


def _events(workdir, name):
    lines = (Path(workdir) / "metrics.jsonl").read_text().splitlines()
    return [rec for rec in map(json.loads, lines) if rec["event"] == name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    ref_cfg = JaxPipelineConfig.from_dict(_tiny_cfg(ref_dir))
    ref_result = JaxPipeline(ref_cfg).run()
    port_cfg = _port_cfg(_tiny_cfg(port_dir), stages=STAGES)
    port_result = Pipeline(port_cfg, device="cpu").run()
    return dict(ref_cfg=ref_cfg, ref=Path(ref_cfg.workdir), ref_result=ref_result,
                port_cfg=port_cfg, port=Path(port_cfg.workdir), result=port_result,
                tmp=port_dir)


def test_corpus_and_triplet_files_are_the_references(runs):
    for name in ("passages.jsonl", "triplets.jsonl"):
        assert (runs["port"] / name).read_bytes() == (runs["ref"] / name).read_bytes()


def test_port_pipeline_runs_from_raw_text(runs):
    """Full-probe IVF-Flat over the trained embeddings: recall 1.0 whatever
    their quality; the loss falls; every stage left its marker."""
    result, workdir = runs["result"], runs["port"]
    assert result["recall_at_k"] == 1.0 and result["kind"] == "ivf_flat"
    assert result == json.loads((workdir / "eval.json").read_text())
    losses = [e["loss"] for e in _events(workdir, "train_step")]
    assert len(losses) >= 3 and losses[-1] < losses[0]
    for name in ARTIFACTS:
        assert (workdir / name).exists(), name
    for stage in STAGES:
        assert (workdir / f".done_{stage}").exists(), stage
    emb = np.load(workdir / "embeddings.npy")
    assert emb.shape == (300, 32) and np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    assert {e["stage"] for e in _events(workdir, "stage_done")} == set(STAGES)


def test_resume_skips_every_stage(runs):
    before = len(_events(runs["port"], "stage_done"))
    again = Pipeline(_port_cfg(_tiny_cfg(runs["tmp"]), stages=STAGES), device="cpu").run()
    assert again == runs["result"]
    assert len(_events(runs["port"], "stage_done")) == before


def test_carried_weights_encode_as_the_reference(runs):
    """The reference's trained params, carried by state_dict_from_flax,
    encode its passages through its own tokenizer.json within 1e-5 (f32:
    the same formulas summed in other orders)."""
    ref_pipe = JaxPipeline(runs["ref_cfg"])
    _, params = ref_pipe._load_params()
    cfg = EncoderConfig.from_dict(json.loads(ref_pipe._train_cfg().encoder.to_json()))
    model = Encoder(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg))
    tok = TextTokenizer.load(runs["ref"] / "tokenizer.json", cfg.max_len)
    passages = [json.loads(line)["text"]
                for line in (runs["ref"] / "passages.jsonl").read_text().splitlines()]
    got = encode_corpus(model, tok, passages, batch_size=runs["ref_cfg"].encode_batch,
                        device="cpu")
    np.testing.assert_allclose(got, np.load(runs["ref"] / "embeddings.npy"), atol=1e-5, rtol=0)


def test_tune_stage_persists_an_op_point(runs):
    """test_pipeline_tune_stage's and test_pipeline_tune_in_stages_tuple's
    asserts: the in-run tune persisted an op point, and a direct tune
    re-tunes, persists and serves with it by default."""
    pipe = Pipeline(_port_cfg(_tiny_cfg(runs["tmp"]), stages=STAGES), device="cpu")
    assert load_index(pipe.workdir / "index", device="cpu")._op_point
    out = pipe.stage_tune(target_recall=0.9)
    assert out["met"] and out["recall"] >= 0.9 and "nprobe" in out["op"]
    loaded = load_index(pipe.workdir / "index", device="cpu")
    assert loaded._op_point == out["op"]
    q, gt = pipe._eval_queries(np.load(pipe.workdir / "embeddings.npy"))
    assert recall_at_k(loaded.search(q, pipe.cfg.eval_k)[1], gt) >= 0.9


def test_flat_kind_tunes_to_the_exact_note(runs, tmp_path):
    """A flat build on the same trained artifacts: tune returns the
    reference's exact note, eval is exact."""
    work = tmp_path / "flat"
    shutil.copytree(runs["port"], work)
    for name in ("index", "eval.json", ".done_build", ".done_tune", ".done_eval"):
        target = work / name
        shutil.rmtree(target) if target.is_dir() else target.unlink()
    d = _tiny_cfg(runs["tmp"], kind="flat")
    d["train"]["ckpt_dir"] = str(work / "ckpt")
    pipe = Pipeline(_port_cfg(d, workdir=str(work), stages=("build", "tune", "eval")),
                    device="cpu")
    assert pipe.run()["recall_at_k"] == 1.0
    out = pipe.stage_tune()
    assert out["op"] == {} and out["met"] and out["recall"] == 1.0
    assert "exact" in out["note"]


def test_fail_injection_then_resume_without_retraining(tmp_path):
    cfg = lambda: _port_cfg(_tiny_cfg(tmp_path))  # noqa: E731
    with pytest.raises(FailInjection):
        Pipeline(cfg(), fail_after="train", device="cpu").run()
    workdir = tmp_path / "run"
    assert (workdir / ".done_train").exists() and not (workdir / ".done_encode").exists()
    mtime = (workdir / ".done_train").stat().st_mtime
    steps = len(_events(workdir, "train_step"))
    assert Pipeline(cfg(), device="cpu").run()["recall_at_k"] == 1.0
    assert (workdir / ".done_train").stat().st_mtime == mtime
    assert len(_events(workdir, "train_step")) == steps


def test_default_ckpt_dir_of_an_older_workdir(runs, tmp_path, monkeypatch):
    """A workdir stamped with the class-default ckpt_dir (CWD-relative),
    whose checkpoints live there, resumed as the CLI resumes it (from the
    stamped config). The reference rescopes ckpt_dir to workdir/ckpt, where
    there is no checkpoint, so its training would start again from step 0
    (a known fault of the reference); the port keeps the stamped directory
    and resumes: stage_train runs no step."""
    monkeypatch.chdir(tmp_path)
    default = TrainConfig().ckpt_dir
    shutil.copytree(runs["port"] / "ckpt", tmp_path / default)
    work = tmp_path / "older"
    work.mkdir()
    for name in ("passages.jsonl", "tokenizer.json", "triplets.jsonl", ".done_mine"):
        shutil.copy(runs["port"] / name, work / name)
    d = _tiny_cfg(runs["tmp"])
    d["workdir"] = str(work)
    d["train"]["ckpt_dir"] = default
    (work / "pipeline_config.json").write_text(json.dumps(d))

    ref = JaxPipeline(JaxPipelineConfig.load(work / "pipeline_config.json"))
    assert ref.cfg.train.ckpt_dir == str(work / "ckpt")
    assert not (work / "ckpt").exists()

    pipe = Pipeline(PipelineConfig.load(work / "pipeline_config.json"), device="cpu")
    assert pipe.cfg.train.ckpt_dir == default
    pipe.stage_train()
    assert (work / ".done_train").exists() and _events(work, "train_step") == []
    assert not (work / "ckpt").exists()


def test_qps_bench_times_distinct_passes_on_the_host():
    """stage_eval's rate: warmup + iters passes over the queries in batches,
    each pass with its own inputs (the reference's protocol), on the CPU."""
    from cloudvectordb_tpu_torch.eval.qps import qps_bench

    seen = []

    def search(qb):
        seen.append(qb.copy())
        return qb.sum(axis=1), np.zeros(len(qb), np.int64)

    q = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    out = qps_bench(search, q, batch=4, warmup=1, iters=3)
    assert len(seen) == 4 * 3 and out["batch"] == 4
    assert out["qps"] > 0 and out["latency_ms"] > 0
    firsts = [seen[i][0] for i in range(0, 12, 3)]  # the first batch of each pass
    assert len({f.tobytes() for f in firsts}) == 4
