"""IVF-PQ's trained quantizers held to the reference's, each package
training its own: a witness that does not rest on the port's tables.

The corpus is scripts/bench_ivf.py's generating process, drawn here with
numpy: unit rows about 256 unit centres (noise 0.3/sqrt(d)), and queries
that are noisy copies of random rows (noise 0.1/sqrt(d)). The reference
and the port each build an int8-refine IVF-PQ index over it with their own
k-means and PQ training (residual, nbits 8, kmeans_iters 10,
pq_train_iters 6; two trainings from different random streams). Held to
each other:

- the quantizers' error on the same held rows, both encoded by the port's
  encoder (held to the reference's in test_torch_ivf_pq.py): the mean
  squared coarse residual and the mean squared PQ error of that residual;
  the port's within QUANT_RTOL (2%) of the reference's;
- recall@10 of each package's own index at full probe, refine_factor 16
  and 64: the port's within RECALL_TOL (0.03) of the reference's.

The test runs the cut SMALL. Run as a script, it runs the cut RECORD (the
full build's training sample of 262,144 rows, nlist 1024, m 64, D 768)
and prints the numbers as one JSON line:

    JAX_PLATFORMS=cpu python tests/port/test_torch_ivf_pq_witness.py
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from cloudvectordb_tpu.index.ivf_pq import IVFPQIndex as JaxIVFPQIndex  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex  # noqa: E402
from cloudvectordb_tpu_torch.index.pq import pq_decode, pq_encode  # noqa: E402
from cloudvectordb_tpu_torch.ops.assign import assign_clusters  # noqa: E402

K, NCENTRES = 10, 256
QUANT_RTOL, RECALL_TOL = 0.02, 0.03
#: (rows, queries, held rows, d, nlist, m)
SMALL = (4096, 64, 1024, 768, 32, 64)
RECORD = (262_144, 256, 32_768, 768, 1024, 64)


def corpus(n: int, nq: int, n_held: int, d: int, seed: int = 0):
    """(rows, queries, held rows): the held rows are further draws of the
    same process, in no index."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((NCENTRES, d), dtype=np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, NCENTRES, n + n_held)]
    x += (0.3 / d ** 0.5) * rng.standard_normal(x.shape, dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, nq)] + (0.1 / d ** 0.5) * rng.standard_normal((nq, d), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x[:n], q, x[n:]


def quant_error(centroids: np.ndarray, codebooks: np.ndarray, held: np.ndarray) -> dict:
    """Mean squared coarse residual and mean squared PQ error of it."""
    x = torch.from_numpy(held)
    c = torch.from_numpy(np.array(centroids, np.float32))
    r = x - c[assign_clusters(x, c)[0]]
    cb = torch.from_numpy(np.array(codebooks, np.float32))
    err = r - pq_decode(pq_encode(r, cb), cb)
    return dict(coarse=float((r * r).sum(1).mean()), pq=float((err * err).sum(1).mean()))


def witness(cut) -> dict:
    n, nq, n_held, d, nlist, m = cut
    x, q, held = corpus(n, nq, n_held, d)
    gt = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :K]
    kw = dict(m=m, nbits=8, metric="ip", residual=True, kmeans_iters=10, pq_train_iters=6,
              refine="int8")
    out = {"rows": n, "queries": nq, "held": n_held, "d": d, "nlist": nlist, "m": m}
    for name, build in (("reference", lambda: JaxIVFPQIndex.build(x, nlist, **kw)),
                        ("port", lambda: IVFPQIndex.build(x, nlist, device="cpu", **kw))):
        t0 = time.perf_counter()
        idx = build()
        rec = {"build_s": time.perf_counter() - t0}
        rec.update(quant_error(idx.centroids, idx.codebooks, held))
        for rf in (16, 64):
            _, ids = idx.search(q, K, nprobe=nlist, refine_factor=rf)
            rec[f"recall_rf{rf}"] = recall_at_k(np.asarray(ids), gt)
        out[name] = rec
    return out


def check(out: dict) -> None:
    ref, port = out["reference"], out["port"]
    for key in ("coarse", "pq"):
        assert port[key] <= ref[key] * (1 + QUANT_RTOL), (key, port[key], ref[key])
    for rf in (16, 64):
        key = f"recall_rf{rf}"
        assert port[key] >= ref[key] - RECALL_TOL, (key, port[key], ref[key])


def test_port_quantizers_match_reference_training():
    check(witness(SMALL))


if __name__ == "__main__":
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    result = witness(RECORD)
    print(json.dumps(result))
    check(result)
