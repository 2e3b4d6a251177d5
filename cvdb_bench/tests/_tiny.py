"""A cell of the benchmark cut to a size the CPU tests hold: the same
files, found by the same names, with the configuration's scale, the
mix's batch and pool and the op point shrunk (widths kept: D 768)."""

from pathlib import Path

from cvdb_bench import cell

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIG = {"rows": 20_000, "chunk_rows": 5_000, "nlist": 32, "tile_n": 256,
               "kmeans_iters": 4, "train_sample": 5_000}
TINY_MIX = {"batch": 64, "pool_batches": 4, "scored_batches": 2, "trace_batches": 2}


def tiny_cell(workload: str, root: Path = ROOT, bench: Path = cell.HERE) -> dict:
    c = cell.resolve(root, workload, bench)
    c["config"] = {**c["config"], **TINY_CONFIG}
    mix = {**c["mix"], **TINY_MIX}
    if "added_rows" in mix:
        mix["added_rows"] = 2_000
    c["mix"] = mix
    c["op"] = {**c["op"], "p_tiles": 64, "tile_q": 32}
    return c
