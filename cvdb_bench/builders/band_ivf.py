"""The residual-int8 tiles index, ``BandIVFIndex(residual=True,
dtype='int8')``, built on the device by ``build_device_streaming`` from
the benchmark's rows and served at the cell's fixed op point. K1
(``csrc/tiles_resid.cu``) scans its tiles."""

from __future__ import annotations

from cvdb_bench import roofline

#: kernel names in the device trace, by the kernel table's names
KERNELS = {"K1": ("resid_scan_kernel", "resid_centroid_kernel")}


class Served:
    def __init__(self, cfg: dict, data, dev):
        from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex

        self.cfg, self.k = cfg, int(cfg["k"])
        self.index = BandIVFIndex.build_device_streaming(
            lambda i: data.chunk(i), len(data.sizes), nlist=int(cfg["nlist"]),
            train_sample=int(cfg["train_sample"]), residual=True, dtype="int8",
            tile_n=int(cfg["tile_n"]), metric=cfg["metric"],
            kmeans_iters=int(cfg["kmeans_iters"]), device=dev)
        self.op: dict = {}

    def add(self, rows) -> None:
        self.index.add(rows)

    def search_device(self, q):
        return self.index.search_device(q, self.k, **self.op)

    def search_host(self, q):
        return self.index.search(q, self.k, **self.op)

    def sizes(self) -> dict:
        idx = self.index
        return {"n_tiles": idx._tune_n_tiles(), "tile_n": idx.tile_n, "dim": idx.dim,
                "nlist": idx.nlist}

    def work(self, batch: int, n_pending: int) -> dict:
        """The parts of one batch of ``batch`` queries at the op point."""
        s, op = self.sizes(), self.op
        parts = {"K1": roofline.k1(batch, op["p_tiles"], op["tile_q"], s["tile_n"], s["dim"],
                                   s["n_tiles"], self.k),
                 "planner": roofline.planner(batch, s["nlist"], s["dim"])}
        if n_pending:
            parts["pending"] = roofline.exact_scan(batch, n_pending, s["dim"])
        return parts

    def tune_candidates(self, batch: int) -> list[dict]:
        return self.index._tune_candidates(batch)
