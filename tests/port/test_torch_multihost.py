"""The sharded serving layer across processes, executed: two OS processes
over TCP (``init_multihost``, gloo), each holding the CPU slots of its rank
(parallel/mesh.py), against the same build and search on one process: ids
bit-identical and scores equal, as tests/distributed/test_multihost.py
holds the JAX package. What crosses the process boundary: the shard
metadata at build time, the query contract (shapes, knobs, the batch's CRC
on a broadcast mesh) and, on a 1-D mesh, the (S_local, B, k) partials of
the merge. Cases: ``ShardedBandIndex`` on a 1-D mesh (2 + 2 shards) and on
a replica-per-process 2 x 2 mesh (each process its own traffic slice), the
same index loaded from a saved artifact (each process loads its own
shards), ``ShardedIVFPQIndex`` and ``DistributedFlatIndex`` on the 1-D
mesh. Each worker has a timeout of its own, so a hung collective fails the
test."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu_torch.parallel.dist_search import DistributedFlatIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_2d_mesh, make_mesh

REPO = Path(__file__).resolve().parents[2]
WORKER_TIMEOUT_S = 240
BAND_KW = dict(dtype="int8", residual=True, kmeans_iters=4, tile_n=128, tile_q=8, seed=5)
PQ_KW = dict(nlist=8, m=8, nbits=4, kmeans_iters=4, pq_train_iters=4, refine="int8", seed=5)

_WORKER = """
import sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
from cloudvectordb_tpu_torch.parallel.mesh import init_multihost, make_2d_mesh, make_mesh
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu_torch.parallel.dist_search import DistributedFlatIndex
from cloudvectordb_tpu_torch.index.registry import load_index
import json
assert init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=120) == world
d = np.load(out / "data.npz")
band_kw, pq_kw = json.loads((out / "kw.json").read_text())
db, q = d["db"], d["q"]
res = {}
one = ShardedBandIndex.build(db, 8, mesh=make_mesh(4, devices=["cpu"]), centroids=d["c"],
                             **band_kw)
assert one.ntotal == db.shape[0] and sum(s is not None for s in one._shards) == 2
n_tiles = one._n_tiles()
res["oned_full"] = one.search(q, 5, p_tiles=n_tiles)
res["oned_part"] = one.search(q, 5, p_tiles=1)
loaded = load_index(out / "saved", mesh=make_mesh(4, devices=["cpu"]))
res["loaded"] = loaded.search(q, 5, p_tiles=1)
two = ShardedBandIndex.build(db, 8, mesh=make_2d_mesh(world, 2, devices=["cpu"]),
                             centroids=d["c"], **band_kw)
per = q.shape[0] // world
res["twod"] = two.search(q[rank * per:(rank + 1) * per], 5, p_tiles=n_tiles)
pq = ShardedIVFPQIndex.build(db, mesh=make_mesh(4, devices=["cpu"]), centroids=d["pc"],
                             codebooks=d["pcb"], **pq_kw)
res["pq"] = pq.search(q, 5, nprobe=8)
flat = DistributedFlatIndex.build(db, mesh=make_mesh(4, devices=["cpu"]))
res["flat"] = flat.search(q, 5)
try:
    one.search(q[: 8 + 8 * rank], 5, p_tiles=1)  # unequal batches: raises on both ranks
    res["contract"] = "passed"
except ValueError as e:
    res["contract"] = "raised" if "contract violated" in str(e) else str(e)
np.savez(out / f"res_{rank}.npz", contract=np.array(res.pop("contract")),
         **{f"{k}_{w}": v for k, (s, i) in res.items() for w, v in (("v", s), ("i", i))})
print(f"WORKER {rank} OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(nproc: int, port: int, out: Path):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(nproc), str(port),
                               str(out)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(nproc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multi-process workers timed out\n" + "\n".join(logs))
    return [p.returncode for p in procs], logs


@pytest.fixture(scope="module")
def expected(tmp_path_factory):
    """The one-process reference on the same topology, one torch thread (as
    the workers), with the quantizers the workers are given."""
    out = tmp_path_factory.mktemp("mh")
    db = clustered_vectors(1024, 32, n_clusters=16, seed=50, normalize=True)
    q = queries_from(db, 32, seed=51, normalize=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ShardedBandIndex.build(db, 8, mesh=make_mesh(4, devices=["cpu"]), **BAND_KW)
        c = one._proto().centroids
        n_tiles = one._n_tiles()
        one.save(out / "saved")
        pq = ShardedIVFPQIndex.build(db, mesh=make_mesh(4, devices=["cpu"]), **PQ_KW)
        ref = {"oned_full": one.search(q, 5, p_tiles=n_tiles),
               "oned_part": one.search(q, 5, p_tiles=1),
               "twod": ShardedBandIndex.build(db, 8, mesh=make_2d_mesh(2, 2, devices=["cpu"]),
                                              centroids=c, **BAND_KW).search(q, 5,
                                                                             p_tiles=n_tiles),
               "pq": pq.search(q, 5, nprobe=8),
               "flat": DistributedFlatIndex.build(db, mesh=make_mesh(4, devices=["cpu"]))
               .search(q, 5)}
        ref["loaded"] = ref["oned_part"]
    finally:
        torch.set_num_threads(threads)
    np.savez(out / "data.npz", db=db, q=q, c=c, pc=pq._shards[0].centroids,
             pcb=pq._shards[0].codebooks)
    (out / "kw.json").write_text(json.dumps([BAND_KW, PQ_KW]))
    return out, ref


def test_two_process_serving_parity(expected):
    out, ref = expected
    nproc = 2
    for _ in range(3):  # _free_port can race another process for the port
        rcs, logs = _run_workers(nproc, _free_port(), out)
        if all(rc == 0 for rc in rcs) or not any("address already in use" in lg.lower()
                                                 for lg in logs):
            break
    for rank, (rc, lg) in enumerate(zip(rcs, logs)):
        assert rc == 0, f"worker {rank} failed (rc={rc}):\n{lg[-4000:]}"
        assert f"WORKER {rank} OK" in lg
    per = ref["twod"][1].shape[0] // nproc
    for rank in range(nproc):
        got = np.load(out / f"res_{rank}.npz")
        assert str(got["contract"]) == "raised"
        for key in ("oned_full", "oned_part", "loaded", "pq", "flat"):
            # a broadcast mesh: every process holds the whole merged answer
            np.testing.assert_array_equal(got[f"{key}_i"], ref[key][1], err_msg=key)
            np.testing.assert_array_equal(got[f"{key}_v"], ref[key][0], err_msg=key)
        # one replica per process: each serves exactly its own slice
        sl = slice(rank * per, (rank + 1) * per)
        np.testing.assert_array_equal(got["twod_i"], ref["twod"][1][sl])
        np.testing.assert_array_equal(got["twod_v"], ref["twod"][0][sl])
