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
mesh, and the reference's cases (e) and (d): the config #5 cascade
(``ShardedBandIVFPQIndex``, refine 'pq2+host': each process rescores its
own shards' shortlists from its own host stores, then the merge crosses),
built and loaded, and three data-parallel training steps, each process
feeding its half of the global batch (its embeddings gathered across the
processes with their gradients, the gradients all-reduced), equal to one
process of two slots on the concatenated batch and, in loss, to the
one-slot step on it; and the encode over the two processes' slots. Each
worker has a timeout of its own, so a hung collective fails the test, and
ends through ``shutdown_multihost``. A last test holds the exit: two
processes that never tear their group down themselves exit with rc 0."""

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
from cloudvectordb_tpu_torch.models.embed import make_encode_fn
from cloudvectordb_tpu_torch.parallel import mesh as mesh_mod
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu_torch.parallel.dist_band_pq import ShardedBandIVFPQIndex
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu_torch.parallel.dist_search import DistributedFlatIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_2d_mesh, make_mesh
from cloudvectordb_tpu_torch.train.trainer import Trainer
from cloudvectordb_tpu_torch.utils.config import EncoderConfig, TrainConfig

REPO = Path(__file__).resolve().parents[2]
WORKER_TIMEOUT_S = 240
BAND_KW = dict(dtype="int8", residual=True, kmeans_iters=4, tile_n=128, tile_q=8, seed=5)
PQ_KW = dict(nlist=8, m=8, nbits=4, kmeans_iters=4, pq_train_iters=4, refine="int8", seed=5)
#: the reference's case (e): the cascade at its multihost test's settings
C5_KW = dict(nlist=8, m=8, nbits=4, refine="pq2+host", m2=8, kmeans_iters=4, pq_train_iters=4,
             tile_n=128, tile_q=8, seed=5)
C5_SEARCH = dict(refine_factor=16, host_factor=8)
#: case (d): a small encoder, f32, dropout 0; a global batch of 16 triplets
DP_ENC = dict(vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2, mlp_dim=32, max_len=8,
              dropout=0.0, dtype="float32")
DP_TRAIN = dict(temperature=0.1, batch_size=16, lr=3e-3, warmup_steps=1, total_steps=10)
DP_STEPS, DP_BATCH = 3, 16

_WORKER = """
import sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
from cloudvectordb_tpu_torch.parallel.mesh import (
    init_multihost, make_2d_mesh, make_mesh, shutdown_multihost)
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu_torch.parallel.dist_band_pq import ShardedBandIVFPQIndex
from cloudvectordb_tpu_torch.models.embed import make_encode_fn
from cloudvectordb_tpu_torch.train.trainer import Trainer
from cloudvectordb_tpu_torch.utils.config import EncoderConfig, TrainConfig
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu_torch.parallel.dist_search import DistributedFlatIndex
from cloudvectordb_tpu_torch.index.registry import load_index
import json
assert init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=120) == world
d = np.load(out / "data.npz")
band_kw, pq_kw, c5_kw, c5_search, dp_enc, dp_train = json.loads((out / "kw.json").read_text())
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
c5 = ShardedBandIVFPQIndex.build(db, mesh=make_mesh(4, devices=["cpu"]), centroids=d["c5c"],
                                 codebooks=d["c5cb"], codebooks2=d["c5cb2"], **c5_kw)
assert sum(len(t) for t in c5._t_host) == 2 and c5._t_host[2 - 2 * rank] == []
res["c5"] = c5.search(q, 5, p_tiles=c5._n_tiles(), **c5_search)
c5l = load_index(out / "c5", mesh=make_mesh(4, devices=["cpu"]))
res["c5_loaded"] = c5l.search(q, 5, p_tiles=c5l._n_tiles(), **c5_search)
cfg = TrainConfig(encoder=EncoderConfig(**dp_enc), ckpt_dir=str(out / "ckpt"), **dp_train)
tr = Trainer(cfg, mesh=make_mesh(axis_name="data", devices=["cpu"]))
st = tr.init_state()
st.model.load_state_dict(torch.load(out / "init.pt"))
half = d["dp_a"].shape[1] // world
losses = []
for j in range(d["dp_a"].shape[0]):
    sl = slice(rank * half, (rank + 1) * half)
    batch = {f"{leg}_{x}": d[f"dp_{leg[0]}"][j, sl] if x == "ids" else np.ones_like(d["dp_a"][j, sl])
             for leg in ("anchor", "pos", "neg") for x in ("ids", "mask")}
    st, m = tr.step_fn(st, tr.place_batch(batch))
    losses.append([float(m["loss"]), float(m["grad_norm"])])
res["dp"] = (np.array(losses), torch.cat([p.detach().reshape(-1) for p in st.model.parameters()]).numpy())
enc = make_encode_fn(st.model, mesh=make_mesh(axis_name="data", devices=["cpu"]))
res["enc"] = (enc(d["dp_a"][0], np.ones_like(d["dp_a"][0])).numpy(), np.zeros(1))
try:
    one.search(q[: 8 + 8 * rank], 5, p_tiles=1)  # unequal batches: raises on both ranks
    res["contract"] = "passed"
except ValueError as e:
    res["contract"] = "raised" if "contract violated" in str(e) else str(e)
np.savez(out / f"res_{rank}.npz", contract=np.array(res.pop("contract")),
         **{f"{k}_{w}": v for k, (s, i) in res.items() for w, v in (("v", s), ("i", i))})
print(f"WORKER {rank} OK", flush=True)
shutdown_multihost()
shutdown_multihost()  # a second call does nothing
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
        c5 = ShardedBandIVFPQIndex.build(db, mesh=make_mesh(4, devices=["cpu"]), **C5_KW)
        ref["c5"] = ref["c5_loaded"] = c5.search(q, 5, p_tiles=c5._n_tiles(), **C5_SEARCH)
        c5.save(out / "c5")
        ref.update(_dp_reference(out))
    finally:
        torch.set_num_threads(threads)
    p5 = c5.proto
    np.savez(out / "data.npz", db=db, q=q, c=c, pc=pq._shards[0].centroids,
             pcb=pq._shards[0].codebooks, c5c=p5.centroids, c5cb=p5.codebooks,
             c5cb2=p5.codebooks2, **{f"dp_{k}": v for k, v in _dp_batches().items()})
    (out / "kw.json").write_text(json.dumps([BAND_KW, PQ_KW, C5_KW, C5_SEARCH, DP_ENC,
                                             DP_TRAIN]))
    return out, ref


def _dp_batches() -> dict:
    """DP_STEPS global batches of DP_BATCH triplets (ids; full masks): the
    anchor's leading token its topic, shared by the positive."""
    rng = np.random.default_rng(7)
    a, p, n = (rng.integers(8, 64, size=(DP_STEPS, DP_BATCH, 8)).astype(np.int32)
               for _ in range(3))
    topic = rng.integers(1, 8, size=(DP_STEPS, DP_BATCH))
    a[:, :, 0], p[:, :, 0], n[:, :, 0] = topic, topic, topic % 7 + 1
    return {"a": a, "p": p, "n": n}


def _dp_reference(out: Path) -> dict:
    """Case (d) in one process: the steps on a mesh of two slots (what the
    two processes must equal) and on one slot (the loss on the concatenated
    batch); the initial parameters the workers load; the two-slot encode."""
    cfg = TrainConfig(encoder=EncoderConfig(**DP_ENC), ckpt_dir=str(out / "ckpt"), **DP_TRAIN)
    d = _dp_batches()
    res = {}
    for name, kw in (("dp", dict(mesh=make_mesh(2, axis_name="data", devices=["cpu"]))),
                     ("dp_one", dict(device="cpu"))):
        tr = Trainer(cfg, **kw)
        st = tr.init_state()
        if name == "dp":
            torch.save(st.model.state_dict(), out / "init.pt")
        losses = []
        for j in range(DP_STEPS):
            batch = {f"{leg}_{x}": d[leg[0]][j] if x == "ids" else np.ones_like(d["a"][j])
                     for leg in ("anchor", "pos", "neg") for x in ("ids", "mask")}
            st, m = tr.step_fn(st, tr.place_batch(batch))
            losses.append([float(m["loss"]), float(m["grad_norm"])])
        res[name] = (np.array(losses),
                     torch.cat([p.detach().reshape(-1) for p in st.model.parameters()]).numpy())
        if name == "dp":
            enc = make_encode_fn(st.model, mesh=make_mesh(2, axis_name="data", devices=["cpu"]))
            res["enc"] = (enc(d["a"][0], np.ones_like(d["a"][0])).numpy(), np.zeros(1))
    return res


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
        for key in ("oned_full", "oned_part", "loaded", "pq", "flat", "c5", "c5_loaded",
                    "dp", "enc"):
            # a broadcast mesh: every process holds the whole merged answer;
            # (d): the two processes' steps are the one process's two slots'
            np.testing.assert_array_equal(got[f"{key}_i"], ref[key][1], err_msg=key)
            np.testing.assert_array_equal(got[f"{key}_v"], ref[key][0], err_msg=key)
        # (d) the loss and grad_norm of the one-slot step on the concatenated batch
        np.testing.assert_allclose(got["dp_v"], ref["dp_one"][0], rtol=1e-5)
        # one replica per process: each serves exactly its own slice
        sl = slice(rank * per, (rank + 1) * per)
        np.testing.assert_array_equal(got["twod_i"], ref["twod"][1][sl])
        np.testing.assert_array_equal(got["twod_v"], ref["twod"][0][sl])


_EXIT_WORKER = """
import sys, time
import torch
import torch.distributed as dist
from cloudvectordb_tpu_torch.parallel.mesh import init_multihost, shutdown_multihost
rank, world, port, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=120)
t = torch.full((4,), float(rank + 1))
dist.all_reduce(t)
assert t.tolist() == [3.0] * 4
if rank == 1:
    time.sleep(1.0)  # rank 0 (the store's host) reaches its exit first
if mode == "twice":
    shutdown_multihost()
    assert not dist.is_initialized()
    shutdown_multihost()
print(f"EXIT WORKER {rank} OK", flush=True)
"""


@pytest.mark.parametrize("mode", ["at_exit", "twice"])
def test_group_ends_cleanly_at_exit(mode):
    """Two processes join through init_multihost, run a collective, and exit
    without calling destroy_process_group themselves: the teardown
    init_multihost registered (a barrier, then the group destroyed) ends
    both with rc 0, where a group left alive into interpreter teardown
    could abort a process (SIGABRT, 'terminate called without an active
    exception'). ``shutdown_multihost`` ends it explicitly, and a second
    call does nothing."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for _ in range(3):  # _free_port can race another process for the port
        port = str(_free_port())
        procs = [subprocess.Popen([sys.executable, "-c", _EXIT_WORKER, str(r), "2", port, mode],
                                  env=env, cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT) for r in range(2)]
        try:
            logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(errors="replace")
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not any("address already in use" in lg.lower() for lg in logs):
            break
    for rank, (p, lg) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {rank} rc={p.returncode}:\n{lg[-4000:]}"
        assert f"EXIT WORKER {rank} OK" in lg and "terminate called" not in lg


def test_shutdown_without_a_group_does_nothing():
    assert not mesh_mod._OWNED["group"]
    mesh_mod.shutdown_multihost()
    mesh_mod.shutdown_multihost()
