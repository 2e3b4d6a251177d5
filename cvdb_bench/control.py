"""The lower-precision control of the correctness check, run apart from the
benchmark's runs: the plain reference put in the program's place and
computed over int4 rows (the nearest precision below the int8 that both
configurations state), its answers judged exactly as a run judges the
program's, at the cell's own size and on the cell's own judged queries.

    python cvdb_bench/control.py --workload <name> --seeds 11,12,13 [--bits 4]

Prints one JSON line a seed: the checks, each beside its limit, and
whether the control came out correct (it must not). Imports nothing of the
program.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_checks(c: dict, seed: int, dev, bits: int = 4) -> dict:
    import torch

    from cvdb_bench import cell, gen, judge

    cfg, mix = c["config"], c["mix"]
    k = int(cfg["k"])
    data = gen.Data(dev, cfg, mix, seed)
    pool = data.query_pool()
    q = torch.cat([pool[j] for j in data.scored_batches()])
    pool = None
    reference = cell.load_module(c["dir"] / "references" / f"{cfg['reference']}.py")
    ctl = reference.run(data, q, k, bits=bits)
    ids = ctl["ids"].cpu().numpy().astype("int64")
    scores = ctl["scores"].cpu().numpy()
    ref = reference.run(data, q, k, answers=ids)
    correct, checks, recall = judge.judge(ids, scores, ref, data.rows + data.added,
                                          cfg["limits"])
    return {"seed": seed, "bits": bits, "correct": correct, "recall": recall, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--bits", type=int, default=4)
    a = ap.parse_args(argv)
    import torch

    from cvdb_bench import cell

    if not torch.cuda.is_available():
        print("the control runs at the cell's own size on a CUDA card", file=sys.stderr)
        return 1
    c = cell.resolve(ROOT, a.workload)
    dev = torch.device("cuda", 0)
    for s in a.seeds.split(","):
        t0 = time.perf_counter()
        out = control_checks(c, int(s), dev, a.bits)
        out["workload"], out["seconds"] = a.workload, time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
