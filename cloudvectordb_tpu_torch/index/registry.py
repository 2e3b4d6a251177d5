"""Index factory and polymorphic load (counterpart of
cloudvectordb_tpu/index/registry.py).

``build_index`` builds every single-card kind from vectors and an
``IndexConfig`` with the reference's arguments and clamps; ``load_index``
reads a directory in the shared on-disk format (index/base.py), saved by
either package, onto an explicit device: the ``flat``, ``ivf_flat``,
``ivf_pq``, ``band_ivf`` (residual-int8 and whole-row arenas) and
``band_ivf_pq`` kinds (code-major or row-major codes), and the sharded
``sharded_band_ivf`` and ``sharded_ivf_pq`` artifacts (parallel/persist.py)
onto a mesh. ``nshards > 0`` builds the sharded wrapper of ``band_ivf`` and
``ivf_pq`` over a mesh of that many shard slots on ``device``
(parallel/); the sharded ``band_ivf_pq`` raises and names the part of the
distribution item it waits for (ROADMAP item 14 (b)).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.base import Index
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex
from cloudvectordb_tpu_torch.index.opq import train_opq
from cloudvectordb_tpu_torch.utils.config import IndexConfig
from cloudvectordb_tpu_torch.utils.device import DEFAULT

_KINDS = {"flat": FlatIndex, "ivf_flat": IVFFlatIndex, "ivf_pq": IVFPQIndex,
          "band_ivf": BandIVFIndex, "band_ivf_pq": BandIVFPQIndex}


def build_index(vectors, cfg: IndexConfig, device: str | torch.device = DEFAULT) -> Index:
    """Build any index kind from (N, D) vectors and ``cfg``, training its
    quantizers inline, on ``device``; ``cfg.nshards > 0`` builds the
    row-sharded wrapper of ``band_ivf`` or ``ivf_pq`` (parallel/) over
    ``make_mesh(cfg.nshards)`` on that device (BASELINE config #4's
    topology), with the same arguments."""
    vectors = np.asarray(vectors, np.float32)
    sharded = cfg.nshards > 0
    if sharded and cfg.kind not in ("band_ivf", "ivf_pq"):
        if cfg.kind == "band_ivf_pq":
            raise NotImplementedError(_SHARDED_BAND_PQ)
        raise ValueError(f"nshards>0 supports kinds band_ivf | ivf_pq, got {cfg.kind!r}")
    if sharded and cfg.kind == "ivf_pq" and cfg.opq:
        raise ValueError("the sharded ivf_pq does not rotate (no OPQ)")
    if cfg.kind == "flat":
        return FlatIndex.build(vectors, metric=cfg.metric, dtype=cfg.dtype, device=device)
    nlist = min(cfg.nlist, max(1, vectors.shape[0] // 4))
    common = dict(train_sample=cfg.train_sample, kmeans_iters=cfg.kmeans_iters,
                  seed=cfg.seed, metric=cfg.metric)
    if sharded:
        from cloudvectordb_tpu_torch.parallel import (
            ShardedBandIndex, ShardedIVFPQIndex, make_mesh)

        common["mesh"] = make_mesh(cfg.nshards, devices=[device])
        band_cls, ivfpq_cls = ShardedBandIndex, ShardedIVFPQIndex
    else:
        common["device"] = device
        band_cls, ivfpq_cls = BandIVFIndex, IVFPQIndex
    if cfg.kind == "band_ivf":
        dtype = cfg.dtype if cfg.dtype != "float32" else "int8"
        resid = cfg.residual and dtype == "int8"
        return band_cls.build(vectors, nlist, dtype=dtype, residual=resid,
                              slack=(cfg.slack if resid else 0.0), **common)
    if cfg.kind == "band_ivf_pq":
        return BandIVFPQIndex.build(
            vectors, nlist, m=cfg.m, nbits=cfg.nbits, refine=cfg.refine, opq=cfg.opq,
            aniso_eta=cfg.aniso_eta, pq_train_iters=cfg.pq_train_iters, **common)
    if cfg.kind == "ivf_flat":
        return IVFFlatIndex.build(vectors, nlist, dtype=cfg.dtype, **common)
    if cfg.kind == "ivf_pq":
        opq_matrix = None
        if cfg.opq:
            ns = min(cfg.train_sample, vectors.shape[0], 65536)
            rs = np.random.default_rng(cfg.seed).choice(vectors.shape[0], ns, replace=False)
            opq_matrix, _ = train_opq(vectors[rs], cfg.m, cfg.nbits, seed=cfg.seed,
                                      device=device)
        return ivfpq_cls.build(
            vectors, nlist, m=cfg.m, nbits=cfg.nbits, pq_train_iters=cfg.pq_train_iters,
            opq_matrix=opq_matrix, refine=cfg.refine, **common)
    raise ValueError(f"unknown index kind {cfg.kind!r}")


_SHARDED_BAND_PQ = ("the sharded band_ivf_pq (config #5 across cards, ShardedBandIVFPQIndex) "
                    "is the next part of the distribution item, ROADMAP item 14 (b)")


def load_index(path: str | Path, device: str | torch.device = DEFAULT,
               mmap: bool = True, mesh=None) -> Index:
    """Load a saved index onto ``device``. A tuned op point in the manifest
    becomes the index's default serving config. A sharded artifact loads
    onto ``mesh`` (default: one of its saved shard count on ``device``)."""
    path = Path(path)
    from cloudvectordb_tpu_torch.parallel.persist import (
        is_sharded_artifact, read_sharded_manifest)

    if is_sharded_artifact(path):
        from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
        from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex

        kind = read_sharded_manifest(path)["kind"]
        if kind == "sharded_band_ivf_pq":
            raise NotImplementedError(_SHARDED_BAND_PQ)
        cls = {"sharded_band_ivf": ShardedBandIndex, "sharded_ivf_pq": ShardedIVFPQIndex}.get(kind)
        if cls is None:
            raise ValueError(f"unknown sharded index kind {kind!r}")
        return cls.load(path, mesh=mesh, mmap=mmap, device=device)
    manifest = Index.read_manifest(path)
    kind = manifest["kind"]
    if kind not in _KINDS:
        raise ValueError(f"unknown index kind {kind!r}")
    idx = _KINDS[kind]._from_state(manifest, Index.load_arrays(path, mmap=mmap),
                                   device=device)
    if manifest.get("op_point"):  # tuned serving knobs (eval/tune.py)
        idx._op_point = dict(manifest["op_point"])
    return idx
