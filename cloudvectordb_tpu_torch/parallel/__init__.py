"""The sharded serving layer (counterpart of cloudvectordb_tpu/parallel/):
the mesh and processes (``mesh.py``), the row-sharded indexes
``DistributedFlatIndex`` (K2 per shard), ``ShardedBandIndex`` (K1 or K3
per shard) and ``ShardedIVFPQIndex`` (the probe scan per shard), and their
persistence (``persist.py``), on ``torch.distributed``.

``ShardedBandIVFPQIndex`` (BASELINE config #5 across cards) is the next
part of the distribution item; importing it raises and says so.
"""

from cloudvectordb_tpu_torch.parallel.mesh import (  # noqa: F401
    init_multihost, make_2d_mesh, make_mesh, stage_replicated, stage_row_sharded)
from cloudvectordb_tpu_torch.parallel.dist_search import DistributedFlatIndex  # noqa: F401
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex  # noqa: F401
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex  # noqa: F401


def __getattr__(name: str):
    if name == "ShardedBandIVFPQIndex":
        raise ImportError("ShardedBandIVFPQIndex (config #5 across cards, dist_band_pq.py) is "
                          "not ported yet: ROADMAP item 14 (b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
