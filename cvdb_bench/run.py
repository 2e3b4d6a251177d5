"""The benchmark of cloudvectordb_tpu_torch: one run of one cell.

    python cvdb_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and the program (``cloudvectordb_tpu_torch``). It makes the cell's rows
and queries from ``--seed``, builds the index on the card and warms it up
(set-up), serves the cell's traffic for ``--seconds`` (the window), with
``--trace 1`` profiles a few more batches, then checks the answers of the
window against the plain reference. Its last line on standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error). It
exits 1 and prints no result without enough CUDA cards, and if ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the window closes.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")  # keep transformers, if anything loads it, off JAX
os.environ.setdefault("USE_JAX", "0")
# kernel caches at fixed paths inside the checkout (the program builds its own
# csrc libraries into cloudvectordb_tpu_torch/_build/, also inside it)
CACHE = ROOT / "cvdb_bench" / "out" / "cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from cvdb_bench import cell

    c = cell.resolve(ROOT, a.workload)
    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        err(f"{a.workload} needs {chips} CUDA card(s); this machine has {n}")
        return 1
    err(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = cell.run(c, a.seed, a.seconds, bool(a.trace), dev, T_START, log=err)
    bad = cell.forbidden_modules()
    if bad:
        err(f"loaded after the window: {bad}: the run may use neither JAX nor the JAX package")
        return 1
    for name, chk in out["checks"].items():
        err(f"{name} {chk['value']!r} limit {chk['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
