"""Numpy checkpointing (counterpart of cloudvectordb_tpu/utils/checkpoint.py).

The reference's layout: ``<ckpt_dir>/step_<n>/arrays.npz`` + ``meta.json``,
written to a temporary directory and renamed into place, with keep-last-k
rotation. Training checkpoints hold params, optimizer state, step,
generator state and data cursor. Arrays are named by their state-dict keys;
their ordered list in ``meta.json`` takes the place of the reference's
treedef string, and a restore into a different structure (other names,
other order, other shapes) raises. Checkpoints do not load across the two
packages: their optimizer states differ in structure.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from pathlib import Path

import numpy as np

_STEP_RE = re.compile(r"^step_(\d+)$")


def save_checkpoint(ckpt_dir: str | Path, step: int, arrays: dict[str, np.ndarray],
                    meta: dict | None = None, keep_last: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".ckpt_tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "meta.json").write_text(
            json.dumps({"step": step, "keys": list(arrays), **(meta or {})}))
        final = ckpt_dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for s in list_checkpoints(ckpt_dir)[:-keep_last]:  # rotate
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    return ckpt_dir / f"step_{step}"


def list_checkpoints(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir()
                  if (m := _STEP_RE.match(p.name)))


def restore_checkpoint(ckpt_dir: str | Path, like: dict[str, np.ndarray],
                       step: int | None = None):
    """Restore arrays with the names, order and shapes of ``like``. Returns
    (arrays, step, meta), or (None, -1, {}) when no checkpoint exists."""
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        return None, -1, {}
    step = steps[-1] if step is None else step
    d = Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((d / "meta.json").read_text())
    with np.load(d / "arrays.npz") as data:
        arrays = {name: data[name] for name in data.files}
    if meta.get("keys") != list(like):
        raise ValueError(f"checkpoint structure mismatch at {d}: saved arrays "
                         f"{len(arrays)} differ from the restore target's {len(like)} "
                         "(names or order)")
    for name, ref in like.items():
        if arrays[name].shape != np.shape(ref):
            raise ValueError(f"checkpoint structure mismatch at {d}: {name} has shape "
                             f"{arrays[name].shape}, the target {np.shape(ref)}")
    return {name: arrays[name] for name in like}, step, meta
