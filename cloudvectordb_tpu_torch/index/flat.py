"""Exact brute-force index: ground truth and small/medium-scale serving
(counterpart of cloudvectordb_tpu/index/flat.py).

Vectors live on one explicit ``device`` as f32, bf16 or int8 (symmetric
quantization with one scale, widened as batches arrive). ``search`` runs
the fused bucketed scan (ops/flat_topk.py, the hand-written kernel on CUDA)
when the index is on a CUDA device and holds at least 2048 rows, or when
``exact=False``; otherwise, and whenever ``exact=True``, the exact tiled
scan (ops/topk.py).
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.arena import normalize_remove_ids
from cloudvectordb_tpu_torch.index.base import Index, from_numpy, to_numpy
from cloudvectordb_tpu_torch.ops.flat_topk import flat_topk, flat_topk_int8
from cloudvectordb_tpu_torch.ops.topk import f32_const, tiled_topk
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
#: the fused scan's tile: below one tile of rows the exact scan serves
_FUSED_MIN_ROWS = 2048


class FlatIndex(Index):
    kind = "flat"

    def __init__(self, dim: int, metric: str = "ip", dtype: str = "float32",
                 device: str | torch.device = DEFAULT):
        """The reference's constructor with an explicit ``device``."""
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if dtype not in _STORE_DTYPES:
            raise ValueError(f"unknown store dtype {dtype!r}")
        if dtype == "int8" and metric != "ip":
            raise ValueError("int8 FlatIndex supports metric='ip' only")
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.device = as_device(device)
        self._vecs = torch.zeros((0, dim), dtype=_STORE_DTYPES[dtype], device=self.device)
        self._sqnorms = torch.zeros((0,), dtype=torch.float32, device=self.device)
        self._scale = 1.0  # int8 dequant scale (a Python float, as the reference's)
        # ids are implicit row positions until the first remove() creates
        # gaps; then _ids maps position -> global id (sorted ascending)
        self._ids: np.ndarray | None = None
        self._next_id = 0

    @property
    def ntotal(self) -> int:
        return int(self._vecs.shape[0])

    @classmethod
    def build(cls, vectors, metric: str = "ip", dtype: str = "float32",
              device: str | torch.device = DEFAULT) -> "FlatIndex":
        idx = cls(int(vectors.shape[1]), metric=metric, dtype=dtype, device=device)
        idx.add(vectors)
        return idx

    def add(self, vectors) -> None:
        x = torch.as_tensor(vectors).to(self.device)
        if x.shape[1] != self.dim:
            raise ValueError(f"vectors D={x.shape[1]} != index D={self.dim}")
        xf = x.float()
        if self.dtype == "int8":
            # clip-scale at 4 x rms; a wider batch scale requantizes the store
            amax = float(xf.abs().max())
            rms = float(torch.sqrt(torch.mean(xf * xf)))
            batch_scale = min(amax, 4.0 * rms) / 127.0
            new_scale = max(self._scale if self.ntotal else 0.0, batch_scale, 1e-12)
            if self.ntotal and new_scale != self._scale:
                ratio = f32_const(self._scale / new_scale, xf)
                self._vecs = torch.clamp(torch.round(self._vecs.float() * ratio),
                                         -127, 127).to(torch.int8)
            self._scale = new_scale
            q8 = torch.clamp(torch.round(xf / f32_const(self._scale, xf)), -127, 127)
            self._vecs = torch.cat([self._vecs, q8.to(torch.int8)])
        else:
            self._vecs = torch.cat([self._vecs, x.to(self._vecs.dtype)])
        if self.metric == "l2":
            self._sqnorms = torch.cat([self._sqnorms, (xf * xf).sum(dim=1)])
        n = int(x.shape[0])
        if self._ids is not None:
            self._ids = np.concatenate(
                [self._ids, np.arange(self._next_id, self._next_id + n)])
        self._next_id = max(self._next_id, self.ntotal - n) + n

    def remove(self, ids) -> int:
        """Delete rows by global id with one device compaction gather.
        Returns the number removed; unknown ids are ignored; freed ids are
        never reused (search keeps returning the original ids through the id
        map the first remove materializes)."""
        req = normalize_remove_ids(ids)
        if req.size == 0 or self.ntotal == 0:
            return 0
        cur = (self._ids if self._ids is not None
               else np.arange(self.ntotal, dtype=np.int64))
        self._next_id = max(self._next_id, self.ntotal)
        keep = ~np.isin(cur, req)
        n_rem = int(self.ntotal - keep.sum())
        if n_rem == 0:
            return 0
        kidx = torch.as_tensor(np.flatnonzero(keep), device=self.device)
        self._vecs = self._vecs[kidx]
        if self.metric == "l2":
            self._sqnorms = self._sqnorms[kidx]
        self._ids = cur[keep]
        return n_rem

    def search(self, queries, k: int, exact: bool | None = None, tile: int = 8192):
        """(scores (Q, k) f32, ids (Q, k) int64) as numpy. ``exact=None``
        takes the fused scan on a CUDA device, the exact scan elsewhere."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        sqnorms = self._sqnorms if self.metric == "l2" else None
        scale = f32_const(self._scale, q)
        if self.dtype == "int8":
            # score against the int8 store with the query pre-scaled, so
            # scores come out dequantized
            q = q * scale
        fused = self.device.type == "cuda" if exact is None else not exact
        if fused and self.ntotal >= _FUSED_MIN_ROWS and self.dtype == "int8":
            # the int8 scan quantizes raw queries itself: undo the pre-scale
            s, i = flat_topk_int8(self._vecs, scale, q / scale, k)
        elif fused and self.ntotal >= _FUSED_MIN_ROWS:
            s, i = flat_topk(self._vecs, q, k, metric=self.metric, db_sqnorms=sqnorms)
        else:
            db = self._vecs if self.dtype != "int8" else self._vecs.float()
            s, i = tiled_topk(db, q, k, metric=self.metric,
                              tile=min(tile, max(256, self.ntotal)), db_sqnorms=sqnorms)
        s, i = s.cpu().numpy(), i.cpu().numpy().astype(np.int64)
        if self._ids is not None:  # after a remove: positions -> original ids
            i = self._ids[np.clip(i, 0, self.ntotal - 1)]
        return s, i

    def _positions(self, ids) -> np.ndarray:
        """Global ids -> current row positions (_ids stays sorted)."""
        ids = np.asarray(ids)
        if self._ids is None:
            return ids
        pos = np.searchsorted(self._ids, ids)
        if not ((pos < self._ids.shape[0]).all() and (self._ids[pos] == ids).all()):
            raise KeyError("unknown (removed?) id")
        return pos

    def reconstruct(self, ids) -> np.ndarray:
        pos = torch.as_tensor(self._positions(ids), device=self.device)
        v = self._vecs[pos].float().cpu().numpy()
        if self.dtype == "int8":
            return v * np.float32(self._scale)
        return v

    # -- persistence ------------------------------------------------------
    def _state_arrays(self) -> dict:
        out = {"vecs": to_numpy(self._vecs)}
        if self.metric == "l2":
            out["sqnorms"] = to_numpy(self._sqnorms)
        if self._ids is not None:
            out["ids"] = self._ids
        return out

    def _state_meta(self) -> dict:
        return {"dtype": self.dtype, "scale": self._scale,
                "next_id": max(self._next_id, self.ntotal)}

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, metric: str = "ip",
                   device: str | torch.device = DEFAULT) -> "FlatIndex":
        """Index from the reference's numpy state: ``meta`` as its
        ``_state_meta()``, ``arrays`` as its ``_state_arrays()`` (vecs, and
        sqnorms and ids where it has them)."""
        vecs = np.asarray(arrays["vecs"])
        idx = cls(int(vecs.shape[1]), metric, meta["dtype"], device=device)
        idx._vecs = from_numpy(vecs, _STORE_DTYPES[idx.dtype]).to(idx.device)
        idx._scale = float(meta["scale"])
        if "sqnorms" in arrays:
            idx._sqnorms = from_numpy(arrays["sqnorms"], torch.float32).to(idx.device)
        if "ids" in arrays:
            idx._ids = np.array(arrays["ids"], np.int64, copy=True)
        idx._next_id = int(meta.get("next_id", idx.ntotal))
        return idx

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict, device=DEFAULT) -> "FlatIndex":
        idx = cls.from_state(manifest["meta"], arrays, manifest["metric"], device=device)
        if idx.dim != manifest["dim"]:
            raise ValueError(f"manifest dim {manifest['dim']} != vecs {idx.dim}")
        return idx
