"""Polymorphic load (counterpart of cloudvectordb_tpu/index/registry.py).

Reads a directory in the shared on-disk format (index/base.py), saved by
either package, onto an explicit device: the ``flat``, ``ivf_flat``,
``ivf_pq``, ``band_ivf`` (residual-int8 and whole-row arenas) and
``band_ivf_pq`` kinds (code-major or row-major codes). Sharded artifacts
raise and name the slice they wait for.
"""

from __future__ import annotations

from pathlib import Path

import torch

from cloudvectordb_tpu_torch.index.base import MANIFEST, Index
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex
from cloudvectordb_tpu_torch.utils.device import DEFAULT

_KINDS = {"flat": FlatIndex, "ivf_flat": IVFFlatIndex, "ivf_pq": IVFPQIndex,
          "band_ivf": BandIVFIndex, "band_ivf_pq": BandIVFPQIndex}


def load_index(path: str | Path, device: str | torch.device = DEFAULT,
               mmap: bool = True) -> Index:
    """Load a saved index onto ``device``. A tuned op point in the manifest
    becomes the index's default serving config."""
    path = Path(path)
    if not (path / MANIFEST).exists():
        raise NotImplementedError(
            f"{path} has no {MANIFEST}: sharded artifacts arrive with the "
            "distribution slice")
    manifest = Index.read_manifest(path)
    kind = manifest["kind"]
    if kind not in _KINDS:
        raise ValueError(f"unknown index kind {kind!r}")
    idx = _KINDS[kind]._from_state(manifest, Index.load_arrays(path, mmap=mmap),
                                   device=device)
    if manifest.get("op_point"):  # tuned serving knobs (eval/tune.py)
        idx._op_point = dict(manifest["op_point"])
    return idx
