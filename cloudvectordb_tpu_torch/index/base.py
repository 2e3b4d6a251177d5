"""Index protocol + persistence (counterpart of cloudvectordb_tpu/index/base.py).

Every index saves as a directory in the reference's on-disk format:
``manifest.json`` (format version, kind, metric, dim, counts, family meta,
tuned op point, array names) plus one ``.npy`` per array, written to a
temporary directory and swapped in atomically. An artifact saved by either
package loads in the other; bf16 arrays are stored as the two-byte void
dtype the reference's ml_dtypes arrays save as (``to_numpy``/``from_numpy``).
Every family gets ``tune()`` from eval/tune.py and ``range_search()`` from
index/range.py.
"""

from __future__ import annotations

import abc
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from cloudvectordb_tpu_torch.eval.tune import TunableMixin
from cloudvectordb_tpu_torch.index.range import RangeSearchMixin
from cloudvectordb_tpu_torch.utils.device import DEFAULT

MANIFEST = "manifest.json"
FORMAT_VERSION = 1


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor in the shared on-disk format: bf16 becomes the
    two-byte void dtype the reference's ml_dtypes arrays save as."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Tensor of ``dtype`` from a saved or in-memory array (a copy, off any
    memory map); two-byte void or ml_dtypes bf16 arrays are read as bf16."""
    a = np.asarray(a)
    if dtype == torch.bfloat16 and a.dtype.kind == "V":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def pad_rows(x, mult: int):
    """``x`` (a numpy array or a tensor) with its last row repeated up to a
    multiple of ``mult`` rows: a batch padded to whole query groups or
    replica slices. ``x`` itself when no row is missing."""
    pad = -x.shape[0] % mult
    if not pad:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def replace_dir_atomic(tmp: Path, path: Path, old_prefix: str) -> None:
    """Swap a fully-written ``tmp`` dir into ``path``, moving any existing
    artifact aside first (never delete-then-rename: a crash in that window
    would destroy the only copy). After a crash here a complete artifact
    exists at ``path``, in ``tmp``, or in the ``old_prefix`` aside dir."""
    old = None
    if path.exists():
        old = Path(tempfile.mkdtemp(dir=path.parent, prefix=old_prefix)) / "prev"
        os.rename(path, old)
    os.rename(tmp, path)
    if old is not None:
        shutil.rmtree(old.parent, ignore_errors=True)


class Index(TunableMixin, RangeSearchMixin, abc.ABC):
    """Build/search/save/load surface; tuning (``tune()``/``_op_point``)
    comes from eval/tune.py's TunableMixin, radius queries from
    index/range.py's RangeSearchMixin."""

    kind: str = "abstract"
    metric: str = "ip"
    dim: int = 0

    @property
    @abc.abstractmethod
    def ntotal(self) -> int:
        ...

    @abc.abstractmethod
    def add(self, vectors, ids=None) -> None:
        """Append vectors (N, dim); ids are assigned contiguously, or given
        by ``ids`` where the family takes them (``BandIVFIndex``)."""

    @abc.abstractmethod
    def search(self, queries, k: int, **kw) -> tuple[np.ndarray, np.ndarray]:
        """Return (scores (Q, k), ids (Q, k)); larger score is better."""

    # -- persistence ------------------------------------------------------
    @abc.abstractmethod
    def _state_arrays(self) -> dict[str, np.ndarray]:
        ...

    @abc.abstractmethod
    def _state_meta(self) -> dict:
        ...

    @classmethod
    @abc.abstractmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "Index":
        ...

    def save(self, path: str | Path, extra_meta: dict | None = None) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=path.parent, prefix=".idx_tmp_"))
        try:
            arrays = self._state_arrays()
            manifest = {
                "format_version": FORMAT_VERSION,
                "kind": self.kind,
                "metric": self.metric,
                "dim": self.dim,
                "ntotal": self.ntotal,
                "meta": self._state_meta(),
                "op_point": self._op_point,
                **(extra_meta or {}),
            }
            manifest["arrays"] = sorted(arrays)
            (tmp / MANIFEST).write_text(json.dumps(manifest, indent=2))
            # one .npy per array: load_arrays can memory-map large payloads
            for name, arr in arrays.items():
                np.save(tmp / f"{name}.npy", np.asarray(arr))
            replace_dir_atomic(tmp, path, ".idx_old_")
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)

    @staticmethod
    def read_manifest(path: str | Path) -> dict:
        return json.loads((Path(path) / MANIFEST).read_text())

    @staticmethod
    def load_arrays(path: str | Path, mmap: bool = True) -> dict:
        """Load saved arrays; mmap=True maps large payloads lazily."""
        path = Path(path)
        manifest = Index.read_manifest(path)
        mode = "r" if mmap else None
        return {name: np.load(path / f"{name}.npy", mmap_mode=mode)
                for name in manifest.get("arrays", [])}
