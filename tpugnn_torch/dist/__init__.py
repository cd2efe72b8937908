"""Distributed decoding and training on ``torch.distributed``: the mesh, the
edge partitioner and the halo exchange (the port of ``tpugnn.dist``)."""

from tpugnn_torch.dist.api import dryrun, make_sharded_apply, make_sharded_train_step
from tpugnn_torch.dist.mesh import make_mesh
from tpugnn_torch.dist.partition import (
    LocalGraphView,
    PartitionedGraph,
    build_partitioned_code,
    partition_graph,
)

__all__ = [
    "dryrun", "make_sharded_apply", "make_sharded_train_step", "make_mesh",
    "LocalGraphView", "PartitionedGraph", "build_partitioned_code", "partition_graph",
]
