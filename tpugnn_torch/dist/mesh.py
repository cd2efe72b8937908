"""The ('data', 'graph') mesh of ranks (the port of ``tpugnn.dist.mesh``).

* ``data`` shards the syndrome batch: its gradient all-reduce runs once a
  step and tolerates a slow link;
* ``graph`` edge-partitions the Tanner graph: its exchanges run every
  message round, so it is the last dimension, whose ranks are contiguous
  (rank = data_index * graph + graph_index) and so on one node.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group :func:`tpugnn_torch.dist.multihost.initialize` joined:
``mesh.get_group('graph')`` is a rank's graph group,
``mesh.get_local_rank('data')`` its index on the data axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpugnn_torch.configs.config import MeshConfig

__all__ = ["make_mesh", "data_shard"]


def make_mesh(cfg: MeshConfig | None = None, *, n_devices: int | None = None):
    """Build the mesh over the joined process group.

    With no config every rank is on the data axis.  ``n_devices`` is the
    number of ranks offered (the world's size when None); the mesh must use
    all of them, and raises as the JAX package does when it needs more."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "tpugnn_torch.dist.multihost.initialize() first")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    have = world if n_devices is None else min(n_devices, world)
    if cfg is None:
        cfg = MeshConfig(data=have, graph=1)
    want = cfg.data * cfg.graph
    if want > have:
        raise ValueError(f"mesh {cfg.data}x{cfg.graph} needs {want} devices, have {have}")
    if want != world:
        raise ValueError(f"mesh {cfg.data}x{cfg.graph} covers {want} of the {world} "
                         f"ranks; launch {want}")
    # 'cuda' only where the group can move device tensors; a gloo group on a
    # card stages its exchanges through the host and is a CPU mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (cfg.data, cfg.graph),
                            mesh_dim_names=tuple(cfg.axis_names))


def data_shard(mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's share of ``x`` along the batch dimension ``dim``: the
    ``data`` axis's index-th of ``mesh.size('data')`` equal slices (the
    counterpart of ``data_sharding``; replicated arrays need no helper)."""
    n, i = mesh.size(0), mesh.get_local_rank(0)
    if x.shape[dim] % n:
        raise ValueError(f"batch {x.shape[dim]} does not divide over data={n}")
    share = x.shape[dim] // n
    return x.narrow(dim, i * share, share)
