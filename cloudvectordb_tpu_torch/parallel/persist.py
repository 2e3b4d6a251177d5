"""Sharded-index persistence (counterpart of
cloudvectordb_tpu/parallel/persist.py), in the reference's format:

    path/
      sharded.json          manifest: sharded kind, shard count, the
                            wrapper's config, per-shard dir names, extras
      shard_000/            each shard a single-index artifact
        manifest.json       (index/base.py's format)
        *.npy
      shard_001/ ...
      <extra>_000.npy ...   wrapper-level per-shard arrays (refine rows)

The save is atomic: everything is written into a temporary directory that
one rename swaps in. Artifacts saved by either package load in the other.
A process loads only the shards its mesh slots hold.
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

import numpy as np

from cloudvectordb_tpu_torch.index.base import replace_dir_atomic

SHARDED_MANIFEST = "sharded.json"
SHARDED_FORMAT_VERSION = 1


def is_sharded_artifact(path: str | Path) -> bool:
    return (Path(path) / SHARDED_MANIFEST).exists()


def save_sharded(path: str | Path, manifest: dict, shards,
                 extras_per_shard: dict[str, list[np.ndarray | None]] | None = None) -> None:
    """Write ``shards`` (single indexes, each saved by its own ``save``) and
    the wrapper manifest atomically; ``extras_per_shard`` maps an array name
    to one (possibly None) array per shard, stored as ``{name}_{si:03d}.npy``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=path.parent, prefix=".shidx_tmp_"))
    try:
        shard_dirs = []
        for si, sh in enumerate(shards):
            name = f"shard_{si:03d}"
            sh.save(tmp / name)
            shard_dirs.append(name)
        extras_present: dict[str, list[bool]] = {}
        for name, arrs in (extras_per_shard or {}).items():
            present = []
            for si, arr in enumerate(arrs):
                if arr is not None:
                    np.save(tmp / f"{name}_{si:03d}.npy", np.asarray(arr))
                present.append(arr is not None)
            extras_present[name] = present
        top = {"format_version": SHARDED_FORMAT_VERSION, "nshards": len(shard_dirs),
               "shard_dirs": shard_dirs, "extras": extras_present, **manifest}
        (tmp / SHARDED_MANIFEST).write_text(json.dumps(top, indent=2))
        replace_dir_atomic(tmp, path, ".shidx_old_")
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def read_sharded_manifest(path: str | Path) -> dict:
    return json.loads((Path(path) / SHARDED_MANIFEST).read_text())


def load_shards(path: str | Path, manifest: dict, devices: list, mmap: bool = True) -> list:
    """Shard ``si`` loaded onto ``devices[si]`` through the polymorphic
    single-index loader; None where ``devices[si]`` is None (a shard another
    process holds)."""
    from cloudvectordb_tpu_torch.index.registry import load_index

    return [None if dev is None else load_index(Path(path) / name, device=dev, mmap=mmap)
            for name, dev in zip(manifest["shard_dirs"], devices)]


def load_extras(path: str | Path, manifest: dict, name: str,
                mmap: bool = True) -> list[np.ndarray | None]:
    """Per-shard wrapper arrays saved by ``save_sharded``."""
    mode = "r" if mmap else None
    return [np.load(Path(path) / f"{name}_{si:03d}.npy", mmap_mode=mode) if present else None
            for si, present in enumerate(manifest.get("extras", {}).get(name, []))]
