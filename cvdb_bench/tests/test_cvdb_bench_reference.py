"""The plain reference against a brute-force numpy top-k, the judge's
arithmetic, and the lower-precision control, which must come out not
correct."""

import ast

import numpy as np
import pytest
import torch

from cvdb_bench import cell, control, gen, judge
from cvdb_bench.tests._tiny import tiny_cell

CPU = torch.device("cpu")
REF = cell.load_module(cell.HERE / "references" / "exact_ip.py")


def small_data(seed=9, rows=3000, added=500, corpus=1):
    cfg = {"dim": 96, "rows": rows, "chunk_rows": 700, "corpus_seed": corpus}
    mix = {"batch": 40, "pool_batches": 3, "scored_batches": 2, "added_rows": added,
           "query_from_added": 0.25, "noise": 0.15}
    return gen.Data(CPU, cfg, mix, seed)


def test_reference_equals_brute_force_numpy():
    data = small_data()
    x = np.concatenate([fn().numpy().astype(np.float64) for _, fn in data.all_chunks()])
    assert x.shape == (3500, 96)
    q = torch.cat(data.query_pool()[:2])
    s = q.numpy().astype(np.float64) @ x.T
    want = np.argsort(-s, axis=1, kind="stable")[:, :10]
    answers = np.stack([want[:, 0], want[:, 5], np.full(len(q), 3499), np.full(len(q), 3500)],
                       axis=1)
    out = REF.run(data, q, 10, answers=answers)
    assert (out["ids"].numpy() == want).all()
    np.testing.assert_allclose(out["scores"].numpy(), np.take_along_axis(s, want, 1),
                               rtol=0, atol=1e-5)
    sc = out["answer_scores"].numpy()
    np.testing.assert_allclose(sc[:, :3], np.take_along_axis(s, answers[:, :3], 1),
                               rtol=0, atol=1e-12)
    assert np.isnan(sc[:, 3]).all()  # id 3500 names no row


def test_seeds_give_the_same_corpus_and_other_traffic():
    a, b = small_data(seed=2**31 + 5), small_data(seed=2**31 + 6)
    assert a.sizes == b.sizes and a.added_sizes == b.added_sizes
    assert torch.equal(a.chunk(0), b.chunk(0)) and torch.equal(a.chunk(4), b.chunk(4))
    assert not torch.equal(a.chunk(0), a.chunk(1))
    assert not torch.equal(a.added_chunk(0), b.added_chunk(0))
    assert torch.equal(a.added_chunk(0), small_data(seed=2**31 + 5).added_chunk(0))
    pool, other = a.query_pool(), b.query_pool()
    assert len(pool) == 3 and pool[0].shape == (40, 96)
    assert not torch.equal(pool[0], other[0])
    assert torch.equal(pool[1], small_data(seed=2**31 + 5).query_pool()[1])
    assert a.scored_batches() == small_data(seed=2**31 + 5).scored_batches()
    # a seed that equals the corpus seed adds rows the corpus does not hold
    c = small_data(seed=1)
    assert not any(torch.equal(c.added_chunk(0), c.chunk(i)[:500]) for i in range(5))


def test_added_rows_share_the_corpus_process():
    """Rows added by any seed span the corpus's one 32-d latent subspace;
    another corpus seed spans another."""
    def rank(*chunks):
        return int(torch.linalg.matrix_rank(torch.cat(chunks).double(), atol=1e-4))

    a = small_data(seed=2**31 + 5)
    assert rank(a.chunk(0)) == rank(a.chunk(0), a.added_chunk(0)) == gen.LATENT
    assert rank(a.chunk(0), small_data(corpus=2).chunk(0)) == 2 * gen.LATENT


def test_judge_arithmetic():
    exact = np.array([[1, 2, 3], [4, 5, 6]])
    assert judge.recall_at_k(np.array([[3, 2, 9], [4, 5, 6]]), exact) == pytest.approx(5 / 6)
    assert judge.bad_answers(np.array([[0, 1, 2], [1, 1, 2], [0, -1, 2], [0, 1, 9]]), 9) == 3
    assert judge.score_gap(np.array([[1.0, 2.0]]), np.array([[1.5, np.nan]])) == 0.5
    ref = {"ids": torch.as_tensor(exact), "answer_scores": torch.ones(2, 3, dtype=torch.float64)}
    ok, checks, recall = judge.judge(exact, np.ones((2, 3), np.float32), ref, 7,
                                     {"recall_short": 0.05, "score_gap": 0.01,
                                      "bad_answers": 0})
    assert ok and recall == 1.0 and checks["bad_answers"]["value"] == 0
    ok, checks, _ = judge.judge(exact, np.full((2, 3), 1.5, np.float32), ref, 7,
                                {"recall_short": 0.05, "score_gap": 0.01, "bad_answers": 0})
    assert not ok and checks["score_gap"]["value"] == pytest.approx(0.5)


@pytest.mark.parametrize("workload", ["resid12m.b4096", "opqpq10m.b4096"])
def test_int4_control_is_not_correct(workload):
    out = control.control_checks(tiny_cell(workload), 2**33 + 1, CPU, bits=4)
    assert not out["correct"]
    assert out["checks"]["recall_short"]["value"] > out["checks"]["recall_short"]["limit"]


@pytest.mark.card
def test_int4_control_at_the_cells_size(card):
    """The control at cell 1's own size on the card (the runs that set the
    limits are in PERF.md)."""
    out = control.control_checks(cell.resolve(cell.HERE.parent, "resid12m.b4096"),
                                 2**33 + 2, card, bits=4)
    assert not out["correct"]


def test_reference_and_yardstick_import_nothing_of_the_program():
    for name in ("gen.py", "judge.py", "roofline.py", "trace.py", "readers.py",
                 "references/exact_ip.py"):
        tree = ast.parse((cell.HERE / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert not any(m.split(".")[0].startswith("cloudvectordb") for m in mods), (name, mods)
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in mods), name
