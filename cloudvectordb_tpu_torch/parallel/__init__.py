"""The sharded serving layer and data parallelism (counterpart of
cloudvectordb_tpu/parallel/): the mesh and processes (``mesh.py``, with
the training helpers ``data_sharding``, ``replicated`` and ``shard_rows``),
the row-sharded indexes ``DistributedFlatIndex`` (K2 per shard),
``ShardedBandIndex`` (K1 or K3 per shard), ``ShardedIVFPQIndex`` (the probe
scan per shard) and ``ShardedBandIVFPQIndex`` (K5 per shard, BASELINE
config #5 across shards), and their persistence (``persist.py``), on
``torch.distributed``.
"""

from cloudvectordb_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding, init_multihost, make_2d_mesh, make_mesh, replicated, shard_rows,
    shutdown_multihost, stage_replicated, stage_row_sharded)
from cloudvectordb_tpu_torch.parallel.dist_search import DistributedFlatIndex  # noqa: F401
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex  # noqa: F401
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex  # noqa: F401

from cloudvectordb_tpu_torch.parallel.dist_band_pq import ShardedBandIVFPQIndex  # noqa: F401
