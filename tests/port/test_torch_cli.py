"""cli.py: tests/unit/test_cli_config.py's five cases against the port's
``cli``; the pipeline driven through ``main`` on the CPU printing its eval
JSON; ``search`` printing ranked passages and skipping unfilled (-inf, -1)
slots; ``--profile`` and ``--debug``; ``python -m cloudvectordb_tpu_torch``
importing no JAX."""

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cloudvectordb_tpu_torch import cli
from cloudvectordb_tpu_torch.cli import _load_cfg, _parse_value
from cloudvectordb_tpu_torch.utils.config import PipelineConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REPO = Path(__file__).resolve().parents[2]
_E2E = REPO / "tests" / "integration" / "test_pipeline_e2e.py"


def _args(**kw):
    base = dict(config=None, workdir=None, set=None)
    base.update(kw)
    return SimpleNamespace(**base)


def test_parse_value_types():
    assert _parse_value("3") == 3
    assert _parse_value("0.5") == 0.5
    assert _parse_value("true") is True
    assert _parse_value('"ivf_pq"') == "ivf_pq"
    assert _parse_value("plaintext") == "plaintext"


def test_overrides_applied(tmp_path):
    args = _args(workdir=str(tmp_path / "w"),
                 set=["index.nlist=32", 'index.kind="flat"', "train.lr=0.01"])
    cfg = _load_cfg(args)
    assert cfg.index.nlist == 32
    assert cfg.index.kind == "flat"
    assert cfg.train.lr == 0.01
    assert cfg.workdir == str(tmp_path / "w")


def test_saved_workdir_config_is_source_of_truth(tmp_path):
    wd = tmp_path / "run"
    wd.mkdir()
    saved = PipelineConfig(workdir=str(wd))
    saved.index.nlist = 77
    saved.train.ckpt_dir = str(wd / "ckpt")
    saved.save(wd / "pipeline_config.json")
    cfg = _load_cfg(_args(workdir=str(wd)))
    assert cfg.index.nlist == 77
    assert cfg.train.ckpt_dir == str(wd / "ckpt")
    # explicit --config beats the saved one
    other = tmp_path / "other.json"
    c2 = PipelineConfig()
    c2.index.nlist = 11
    c2.save(other)
    cfg2 = _load_cfg(_args(config=str(other), workdir=str(wd)))
    assert cfg2.index.nlist == 11


def test_unknown_override_rejected(tmp_path):
    with pytest.raises(KeyError):
        _load_cfg(_args(workdir=str(tmp_path / "w"), set=["index.bogus=1"]))


def test_config_roundtrip_preserves_tuple_stages(tmp_path):
    cfg = PipelineConfig(stages=("encode", "build"))
    p = tmp_path / "c.json"
    cfg.save(p)
    cfg2 = PipelineConfig.load(p)
    assert tuple(cfg2.stages) == ("encode", "build")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The tiny pipeline (test_pipeline_e2e.py's configuration) run through
    ``main(["pipeline", ...])``, its config from a file; what it printed."""
    tmp = tmp_path_factory.mktemp("cli")
    spec = importlib.util.spec_from_file_location("_pipeline_e2e_model", _E2E)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = tmp / "cfg.json"
    mod._tiny_cfg(tmp).save(path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["pipeline", "--config", str(path), "--device", "cpu"]) == 0
    return tmp, out.getvalue()


def test_pipeline_command_prints_the_eval_json(workdir, capsys):
    tmp, printed = workdir
    result = json.loads(printed.strip().splitlines()[-1])
    assert result["recall_at_k"] == 1.0 and result["kind"] == "ivf_flat"
    assert result == json.loads((tmp / "run" / "eval.json").read_text())
    # a resume from the stamped config alone returns the same result
    assert cli.main(["eval", "--workdir", str(tmp / "run"), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


def _search(tmp, capsys, *extra):
    assert cli.main(["search", "--workdir", str(tmp / "run"), "--device", "cpu",
                     "--query", "the telescope and the galaxy", *extra]) == 0
    return capsys.readouterr().out.strip().splitlines()


def test_search_prints_ranked_passages_and_skips_unfilled_slots(workdir, capsys):
    tmp, _ = workdir
    lines = _search(tmp, capsys, "-k", "5")
    assert len(lines) == 5
    assert [int(line.split(".")[0]) for line in lines] == [1, 2, 3, 4, 5]
    passages = [json.loads(x)["text"] for x in (tmp / "run" / "passages.jsonl").open()]
    scores = [float(line.split("[")[1].split("]")[0]) for line in lines]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    # one probed list of ~19 rows cannot fill 60 slots: the rest are
    # (-inf, -1), and none of them prints (the reference would print the
    # last passage for each)
    short = _search(tmp, capsys, "-k", "60", "--nprobe", "1")
    assert 0 < len(short) < 60
    assert [int(line.split(".")[0]) for line in short] == list(range(1, len(short) + 1))
    assert all("-inf" not in line and line.split("] ", 1)[1] in
               {p[:120] for p in passages} for line in short)


def test_profile_writes_a_trace_and_debug_turns_on_anomaly_detection(workdir, capsys):
    tmp, _ = workdir
    assert cli.main(["eval", "--workdir", str(tmp / "run"), "--device", "cpu",
                     "--profile"]) == 0
    assert (tmp / "run" / "profile" / "eval.trace.json").stat().st_size > 0
    capsys.readouterr()
    try:
        assert cli.main(["eval", "--workdir", str(tmp / "run"), "--device", "cpu",
                         "--debug"]) == 0
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_module_entry_point_imports_no_jax():
    probe = ("import runpy, sys\n"
             "sys.argv = ['cloudvectordb_tpu_torch', '--help']\n"
             "try:\n"
             "    runpy.run_module('cloudvectordb_tpu_torch', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert e.code == 0, e.code\n"
             "print(sorted(m for m in ('jax', 'flax', 'cloudvectordb_tpu') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert "pipeline" in out.stdout and "search" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"
    helped = subprocess.run([sys.executable, "-m", "cloudvectordb_tpu_torch", "search", "--help"],
                            cwd=REPO, check=True, capture_output=True, text=True, timeout=120)
    assert "--device" in helped.stdout and "--nprobe" in helped.stdout
