"""Polymorphic load (counterpart of cloudvectordb_tpu/index/registry.py).

Reads a directory in the shared on-disk format (index/base.py), saved by
either package, onto an explicit device. This slice loads the ``flat`` and
``band_ivf`` kinds (residual-int8 and whole-row arenas); every other kind
raises and names the slice it waits for.
"""

from __future__ import annotations

from pathlib import Path

import torch

from cloudvectordb_tpu_torch.index.base import MANIFEST, Index
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.utils.device import DEFAULT

_KINDS = {"flat": FlatIndex, "band_ivf": BandIVFIndex}
_LATER = {
    "ivf_flat": "the probe-scan families slice",
    "ivf_pq": "the probe-scan families slice",
    "band_ivf_pq": "the PQ-tiles slice (pq_tiles_topk kernel)",
}


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
        raise NotImplementedError(
            f"index kind {kind!r} arrives with {_LATER.get(kind, 'a later slice')}")
    idx = _KINDS[kind]._from_state(manifest, Index.load_arrays(path, mmap=mmap),
                                   device=device)
    if manifest.get("op_point"):  # tuned serving knobs (eval/tune.py)
        idx._op_point = dict(manifest["op_point"])
    return idx
