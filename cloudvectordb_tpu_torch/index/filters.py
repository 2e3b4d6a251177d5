"""Predicate filters for filtered search (counterpart of
cloudvectordb_tpu/index/filters.py): multi-tenant serving, soft deletes,
attribute pre-filters.

A filter is a dense allow bitmap keyed by global id, staged on a device
once per filter object. The residual-int8 ``BandIVFIndex`` gathers it
through its id table into arena order (cached per arena state) and K1
masks rows at score time, before any slot fills: exact at any selectivity.
Other families use ``filtered_search``: oversample, then post-filter
(exact only when enough allowed rows land in the oversampled set;
under-filled slots return (-inf, -1), the package's unfilled-slot
convention).
"""

from __future__ import annotations

import numpy as np
import torch


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class IdFilter:
    """Dense allow bitmap over global ids. Build once, reuse across
    searches; each device's copy uploads on its first use.

    The bitmap is padded to a power-of-two length (at least 1024); pad
    entries are 0 (disallowed), and gid -1 (holes, unfilled slots) is
    always disallowed."""

    def __init__(self, mask_by_gid):
        mask = np.asarray(mask_by_gid)
        if mask.ndim != 1:
            raise ValueError(f"mask must be (gid_bound,), got shape {mask.shape}")
        n_pad = _next_pow2(max(int(mask.shape[0]), 1024))
        self.mask_np = np.zeros(n_pad, np.uint8)
        self.mask_np[: mask.shape[0]] = mask.astype(bool)
        self._mask_dev: dict[torch.device, torch.Tensor] = {}

    @classmethod
    def coerce(cls, where, gid_bound: int) -> "IdFilter":
        """Accept an IdFilter (passed through), a bool mask indexed by gid
        (or a uint8 one covering ``gid_bound``), or an integer array of
        allowed gids."""
        if isinstance(where, IdFilter):
            return where
        arr = np.asarray(where)
        if arr.dtype == np.bool_ or (arr.ndim == 1 and arr.size >= gid_bound
                                     and arr.dtype == np.uint8):
            return cls(arr)
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError("where= takes an IdFilter, a bool mask indexed by global id, "
                            "or an integer array of allowed ids")
        mask = np.zeros(max(gid_bound, int(arr.max(initial=-1)) + 1), np.uint8)
        mask[arr[arr >= 0]] = 1
        return cls(mask)

    @property
    def n_allowed(self) -> int:
        return int(self.mask_np.sum())

    def allowed_np(self, gids) -> np.ndarray:
        """Bool allow decision per (possibly negative) global id, on the host."""
        g = np.asarray(gids)
        ok = self.mask_np[np.clip(g, 0, self.mask_np.shape[0] - 1)] > 0
        return ok & (g >= 0) & (g < self.mask_np.shape[0])

    def mask_device(self, device: str | torch.device) -> torch.Tensor:
        """(n_pad,) int8 allow bits on ``device`` (cached per device)."""
        dev = torch.device(device)
        if dev not in self._mask_dev:
            self._mask_dev[dev] = torch.as_tensor(self.mask_np.astype(np.int8), device=dev)
        return self._mask_dev[dev]

    def allowed_dev(self, gids: torch.Tensor) -> torch.Tensor:
        """Device twin of ``allowed_np``: gids of any integer dtype and shape,
        on the device they lie on."""
        m = self.mask_device(gids.device)
        g = gids.long()
        ok = m[g.clamp(0, m.shape[0] - 1)] > 0
        return ok & (g >= 0) & (g < m.shape[0])

    def staged_for_mesh(self, mesh) -> dict:
        """The bitmap on each of this process's devices of a serving mesh
        (parallel/mesh.py), {device: (n_pad,) int8 tensor}, cached per
        device as ``mask_device``: each shard gathers it through its own
        global-id table, so one copy a device serves every shard and
        replica there."""
        return {d: self.mask_device(d) for d in mesh.local_devices()}


def filtered_search(index, queries, k: int, where, oversample: int = 8, **search_kw):
    """Oversample and post-filter, for index families without score-time
    masking (``FlatIndex``, the whole-row ``BandIVFIndex`` arenas): fetch
    k·oversample candidates, drop disallowed ids, keep the top k. Exact
    whenever at least k allowed rows survive per query; under-filled rows
    pad with (-inf, -1). The residual-int8 arenas take ``where=`` on
    ``search()`` directly instead."""
    flt = IdFilter.coerce(where, getattr(index, "_gid_bound", lambda: 0)() or index.ntotal)
    kk = max(k, min(k * oversample, index.ntotal))
    v, g = index.search(queries, kk, **search_kw)
    v, g = np.asarray(v), np.asarray(g)
    v = np.where(flt.allowed_np(g), v, -np.inf)
    sel = np.argsort(-v, axis=1, kind="stable")[:, :k]
    v2 = np.take_along_axis(v, sel, axis=1)
    g2 = np.where(v2 > -np.inf, np.take_along_axis(g, sel, axis=1), -1)
    return v2, g2
