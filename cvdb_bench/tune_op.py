"""Fix a cell's op point once, off the timed runs: the program's tuner
(``eval/tune.py::tune_index``) walks the index's candidate ladder at the
cell's own batch size, against the exact top-10 of the cell's judged
queries, on a seed no proof run uses; the winner goes into
``op_points/<workload>.json`` by hand, with the report in PERF.md.

    python cvdb_bench/tune_op.py --workload <name> --seed <n> [--target 0.95]

Each candidate is served as the cell serves: ``search_device`` for a
device loop, ``search()`` for a host loop, in batches of the mix's size.
Prints the tune's report as one JSON line (and writes it to
``cvdb_bench/out/tune_<workload>.json``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class CellAsIndex:
    """What ``tune_index`` asks of an index, answered by the cell's served
    index at the cell's batch size and loop."""

    def __init__(self, served, mix, dev):
        self.served, self.mix, self.device = served, mix, dev
        self.batch = int(mix["batch"])

    def _tune_candidates(self, nq: int) -> list[dict]:
        return self.served.tune_candidates(self.batch)

    def search(self, queries, k: int, **kw):
        import numpy as np
        import torch

        idx, b = self.served.index, self.batch
        vs, ids = [], []
        for s in range(0, queries.shape[0], b):
            q = queries[s:s + b]
            if self.mix["loop"] == "closed_device":
                v, i = idx.search_device(torch.as_tensor(q, device=self.device), k, **kw)
                v, i = v.cpu().numpy(), i.cpu().numpy()
            else:
                v, i = idx.search(q, k, **kw)
            vs.append(v)
            ids.append(i)
        return np.concatenate(vs), np.concatenate(ids).astype(np.int64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--target", type=float, default=0.95)
    a = ap.parse_args(argv)
    import torch

    from cloudvectordb_tpu_torch.eval.tune import tune_index
    from cvdb_bench import cell, gen

    c = cell.resolve(ROOT, a.workload)
    cfg, mix = c["config"], c["mix"]
    dev = torch.device("cuda", 0)
    data = gen.Data(dev, cfg, mix, a.seed)
    builder = cell.load_module(c["dir"] / "builders" / f"{cfg['builder']}.py")
    t0 = time.perf_counter()
    served = builder.Served(cfg, data, dev)
    for j in range(len(data.added_sizes)):
        served.add(data.added_chunk(j))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pool = data.query_pool()
    q = torch.cat([pool[j] for j in data.scored_batches()])
    reference = cell.load_module(c["dir"] / "references" / f"{cfg['reference']}.py")
    gt = reference.run(data, q, int(cfg["k"]))["ids"].cpu().numpy()
    t1 = time.perf_counter()
    report = tune_index(CellAsIndex(served, mix, dev), q.cpu().numpy(), int(cfg["k"]),
                        a.target, gt, verbose=True)
    out = {"workload": a.workload, "seed": a.seed, "target": a.target, "build_s": build_s,
           "tune_s": time.perf_counter() - t1, "sizes": served.sizes(), **report}
    line = json.dumps(out, default=float)
    out_dir = ROOT / "cvdb_bench" / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"tune_{a.workload}.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
