"""Whole runs on the CPU at a tiny size, the harness's look for a card
skipped: a sound run comes out correct, and the timed path broken
underneath makes ``correct`` false, once for each fault a serving cell can
have (an answer altered where it is produced; half of the batch left
unanswered; the pending rows left out of the merge). The module check and
the command's refusals run in fresh processes."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cloudvectordb_tpu_torch.index import ivf_band, ivf_band_pq
from cvdb_bench import cell
from cvdb_bench.tests._tiny import ROOT, tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 1234


def run(workload, seconds=1.0, trace=False):
    return cell.run(tiny_cell(workload), SEED, seconds, trace, CPU, 0.0, log=lambda m: None)


def broken(monkeypatch, cls, fault):
    real = cls.search_device

    def search_device(self, queries, k, **kw):
        v, ids = real(self, queries, k, **kw)
        v, ids = v.clone(), ids.clone()
        if fault == "altered":  # every answer's first id names another row
            ids[:, 0] = (ids[:, 0] + 1) % self._gid_bound()
        elif fault == "half":  # the second half of the batch left unanswered
            h = ids.shape[0] // 2
            v[h:], ids[h:] = v[:h], ids[:h]
        return v, ids

    monkeypatch.setattr(cls, "search_device", search_device)


@pytest.mark.parametrize("workload", ["resid12m.b4096", "opqpq10m.b4096",
                                      "resid12m.fresh.b4096"])
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) >= {"setup_s", "recall_at_10"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("workload,cls", [("resid12m.b4096", ivf_band.BandIVFIndex),
                                          ("opqpq10m.b4096", ivf_band_pq.BandIVFPQIndex)])
def test_fault_is_not_correct(monkeypatch, workload, cls, fault):
    broken(monkeypatch, cls, fault)
    assert not run(workload)["correct"]


def test_host_loop_fault_is_not_correct(monkeypatch):
    real = ivf_band.BandIVFIndex.search

    def search(self, queries, k, **kw):
        v, ids = real(self, queries, k, **kw)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % self._gid_bound()
        return v, ids

    monkeypatch.setattr(ivf_band.BandIVFIndex, "search", search)
    assert not run("resid12m.b64")["correct"]


def test_pending_rows_left_out_is_not_correct(monkeypatch):
    monkeypatch.setattr(ivf_band.BandIVFIndex, "_merge_pending_topk",
                        lambda self, v, gids, queries, k, flt=None: (v, gids))
    out = run("resid12m.fresh.b4096")
    assert not out["correct"]
    assert out["checks"]["recall_short"]["value"] > out["checks"]["recall_short"]["limit"]


def test_traced_run_reports_layer_metrics_only():
    out = run("resid12m.b64", trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"build_s"}  # the rest read the card's trace
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out


PROBE = """
import sys, json, torch
sys.path.insert(0, {root!r})
from cvdb_bench import cell
from cvdb_bench.tests._tiny import tiny_cell
out = cell.run(tiny_cell("resid12m.b4096"), 7, 0.2, False, torch.device("cpu"), 0.0,
               log=lambda m: None)
sys.modules["cloudvectordb_tpu_torchx"] = sys  # a name that only begins like one
print(json.dumps({{"bad": cell.forbidden_modules(), "correct": out["correct"]}}))
sys.modules["jaxlib.xla"] = sys
sys.modules["cloudvectordb_tpu"] = sys
print(json.dumps(cell.forbidden_modules()))
"""


def test_a_run_loads_no_jax_compared_by_whole_names():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    first, second = out.stdout.strip().splitlines()[-2:]
    assert json.loads(first) == {"bad": [], "correct": True}
    assert json.loads(second) == ["cloudvectordb_tpu", "jaxlib"]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "cvdb_bench/run.py", "--workload", "resid12m.b4096",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cell.HERE, tmp_path / "cvdb_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    out = subprocess.run([sys.executable, "cvdb_bench/run.py", "--workload", "resid12m.b4096",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
