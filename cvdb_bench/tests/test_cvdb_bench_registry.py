"""BENCHMARK.json and the files it names: each configuration, mix, op
point and metric is a file of its own that the harness finds by name, and
a new cell, mix or metric is new files and entries, with no edit."""

import json
import re
import shutil

import pytest
import torch

from cvdb_bench import cell
from cvdb_bench.tests._tiny import ROOT, tiny_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cvdb_bench"] and SPEC["command"][1] == "cvdb_bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_keep_to_the_contract():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = set()
    for section, want in keys.items():
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == want, (section, e["name"])
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            for text in ("why", "layer", "source"):
                if text in e and section in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            if section == "end_to_end":
                assert 0.01 <= e["bound"] <= 0.25
                assert e["source"] in ("host_clock", "device_trace")
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    c = cell.resolve(ROOT, workload)
    cfg, mix = c["config"], c["mix"]
    here = c["dir"]
    for path in (here / "builders" / f"{cfg['builder']}.py",
                 here / "references" / f"{cfg['reference']}.py",
                 here / "loops" / f"{mix['loop']}.py"):
        assert path.is_file(), path
    e2e = cell.metrics_of(c["end_to_end"], workload)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = cell.metrics_of(c["per_layer"], workload, names)
    assert layer
    for m in e2e:
        assert hasattr(cell.load_module(here / "e2e_metrics" / f"{m['name']}.py"), "read")
    for m in layer:
        assert m["moves"] in names
        assert hasattr(cell.load_module(here / "layer_metrics" / f"{m['name']}.py"), "read")


def test_config_files_state_their_deployment():
    for conf in SPEC["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        assert cfg["name"] == conf["name"] and conf["file"].startswith("cvdb_bench/")
        assert cfg["limits"]["recall_short"] == pytest.approx(
            1 - cfg["guarantees"]["recall_at_10_min"])
        assert cfg["assumed"] and cfg["deployment"]


def test_a_new_cell_mix_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, then add a mix file, an op point, a metric
    reader and entries: the copy runs the new cell and reports the new
    metric, and no file of the copy changed."""
    bench = tmp_path / "cvdb_bench"
    shutil.copytree(cell.HERE, bench, ignore=shutil.ignore_patterns("__pycache__", "out"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    (bench / "mixes" / "b32.json").write_text(json.dumps(
        {**json.loads((bench / "mixes" / "b4096.json").read_text()), "batch": 32}))
    (bench / "op_points" / "resid12m.b32.json").write_text(
        json.dumps({"search": {"p_tiles": 64, "tile_q": 32}}))
    (bench / "layer_metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return None if ctx.trace is None else ctx.trace.n_calls\n")
    spec["workloads"].append({"name": "resid12m.b32", "config": "ivf_resid_int8_12.5m",
                              "traffic": "b32", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "device", "moves": "qps",
                              "workloads": ["resid12m.b32"]})
    spec["end_to_end"][0]["workloads"].append("resid12m.b32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = tiny_cell("resid12m.b32", tmp_path, bench)
    c["mix"]["batch"] = 32
    out = cell.run(c, 2**40 + 3, 0.3, True, torch.device("cpu"), 0.0, log=lambda m: None)
    assert out["metrics"]["calls_traced"]["value"] == c["mix"]["trace_batches"]
    assert all(p.read_bytes() == b for p, b in before.items())
