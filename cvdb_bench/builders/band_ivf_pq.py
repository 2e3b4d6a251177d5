"""The OPQ + IVF-PQ tiles index, ``BandIVFPQIndex(refine='int8')``, built
on the device by ``build_device_streaming(opq=True)`` from the
benchmark's rows and served from its PQ codes (``serve_from='pq'``: K5,
``csrc/pq_scan.cu``), then the int8 rescore, at the cell's fixed op
point."""

from __future__ import annotations

from cvdb_bench import roofline

KERNELS = {"K5": ("pq_scan_kernel",)}


class Served:
    def __init__(self, cfg: dict, data, dev):
        from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex

        self.cfg, self.k = cfg, int(cfg["k"])
        self.index = BandIVFPQIndex.build_device_streaming(
            lambda i: data.chunk(i), len(data.sizes), nlist=int(cfg["nlist"]),
            m=int(cfg["m"]), nbits=int(cfg["nbits"]), refine=cfg["refine"],
            opq=bool(cfg["opq"]), train_sample=int(cfg["train_sample"]),
            kmeans_iters=int(cfg["kmeans_iters"]), pq_train_iters=int(cfg["pq_train_iters"]),
            tile_n=int(cfg["tile_n"]), metric=cfg["metric"], device=dev)
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
                "nlist": idx.nlist, "m": idx.m, "nbits": idx.nbits, "rows": idx._n}

    def work(self, batch: int, n_pending: int) -> dict:
        s, op = self.sizes(), self.op
        k_cand = min(max(self.k * int(op["refine_factor"]), 32), s["rows"])
        parts = {"K5": roofline.k5(batch, op["p_tiles"], op["tile_q"], s["tile_n"], s["m"],
                                   s["nbits"], s["dim"], s["n_tiles"], k_cand),
                 "planner": roofline.planner(batch, s["nlist"], s["dim"]),
                 "rescore": roofline.rescore(batch, k_cand, s["dim"])}
        if self.index.opq_matrix is not None:
            parts["rotation"] = roofline.rotation(batch, s["dim"])
        if n_pending:
            parts["pending"] = roofline.exact_scan(batch, n_pending, s["dim"], row_bytes=1)
        return parts

    def tune_candidates(self, batch: int) -> list[dict]:
        """The PQ route's ladder (the index's own ladder, with int8 refine
        rows, walks the refine route instead): coverage from the span-aware
        budget x refine depth x pools x top-2, by the index's cost proxy."""
        idx = self.index
        n_tiles = idx._tune_n_tiles()
        out = []
        for tq in (64, 128):
            base = idx._auto_p_tiles(batch, 32, n_tiles, tile_q=tq)
            for mult in (1.0, 1.5, 2.5, 4.0, 7.0):
                p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
                for rf in (16, 64, 102, 205, 410):
                    for pools in (0, 4):
                        cfg = {"p_tiles": p, "tile_q": tq, "serve_from": "pq",
                               "refine_factor": rf, "n_pools": pools}
                        out.append(cfg)
                        if rf >= 64:
                            out.append({**cfg, "top2": True})
        out.sort(key=lambda c: (c["p_tiles"] * (1 + c["refine_factor"] / 256.0)
                                * (1.02 if c.get("top2") else 1.0), -c["tile_q"]))
        return out
