"""The two multi-device modes on ``torch.distributed``: point-sharded
(``sharded.py``) and grid-sharded (``spatial.py``), with their collectives
in ``comm.py``."""

from .sharded import exec_type1_sharded, exec_type2_sharded, shard_points
from .spatial import SpatialNUFFT, SpatialPoints

__all__ = [
    "exec_type1_sharded",
    "exec_type2_sharded",
    "shard_points",
    "SpatialNUFFT",
    "SpatialPoints",
]
