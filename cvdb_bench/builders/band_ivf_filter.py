"""The residual-int8 tiles index of ``band_ivf.py``, searched under an
integer filter on every query: VectorDBBench's ``IntFilterPerformanceCase``,
``id >= int(filter_rate · rows)`` over ids in corpus order. The filter is
one ``IdFilter`` made once (``index.make_filter``), passed as ``where=`` to
``search_device`` and ``search``; its arena mask is gathered by the first
search, in warm-up. K1 (``csrc/tiles_resid.cu``) scans the planned tiles
masked, so its work is counted as ``band_ivf.py`` counts the unmasked K1's,
over the tiles the planner may choose: those holding an allowed row (the
mask's bytes, one a row of a tile read, left out)."""

from __future__ import annotations

import numpy as np
import torch

from cvdb_bench import roofline
from cvdb_bench.builders import band_ivf

KERNELS = band_ivf.KERNELS


def threshold(cfg: dict, rows: int) -> int:
    """The smallest id the filter allows, int(filter_rate · rows), as
    VectorDBBench sets it from the dataset's size."""
    return int(float(cfg["filter"]["filter_rate"]) * rows)


class FilteredView:
    """The index as the cell serves it: ``search_device`` and ``search``
    take ``where=`` the filter; everything else (the tune's ladder and
    sizes, ``add``) is the index's own. ``tune_op.py`` searches through
    ``Served.index``, so the tune walks the filtered index."""

    def __init__(self, index, flt):
        self._index, self.filter = index, flt

    def search_device(self, queries, k: int, **kw):
        return self._index.search_device(queries, k, where=self.filter, **kw)

    def search(self, queries, k: int, **kw):
        return self._index.search(queries, k, where=self.filter, **kw)

    def __getattr__(self, name):
        return getattr(self._index, name)


class Served(band_ivf.Served):
    def __init__(self, cfg: dict, data, dev):
        super().__init__(cfg, data, dev)
        idx = self.index
        # ids of the rows added in set-up follow the corpus's, in insertion order
        n_ids = max(idx._gid_bound(), data.rows + data.added)
        self.lo = threshold(cfg, data.rows)
        self.index = FilteredView(idx, idx.make_filter(np.arange(n_ids) >= self.lo))

    def live_tiles(self) -> int:
        """The arena tiles holding a row the filter allows, from the
        arena's id table (pad rows and holes allow none)."""
        idx = self.index._index
        ids = idx._device_state()["ids"]
        ok = torch.zeros(idx._tune_n_tiles() * idx.tile_n, dtype=torch.bool, device=ids.device)
        ok[: ids.shape[0]] = ids.long() >= self.lo
        return int(ok.reshape(-1, idx.tile_n).any(dim=1).sum())

    def work(self, batch: int, n_pending: int) -> dict:
        """``band_ivf``'s parts, K1's distinct tiles those the plan may
        choose: the live tiles, or p_tiles where fewer are live (every
        group then fills its table with the same lowest dead tiles)."""
        parts = super().work(batch, n_pending)
        s, op = self.sizes(), self.op
        parts["K1"] = roofline.k1(batch, op["p_tiles"], op["tile_q"], s["tile_n"], s["dim"],
                                  max(self.live_tiles(), op["p_tiles"]), self.k)
        return parts
