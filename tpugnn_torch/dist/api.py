"""Graph- and data-parallel decoding and training (the port of
``tpugnn.dist.api``).

Every rank runs the same program on its own shard (SPMD over
``torch.distributed``):

* the ``graph`` axis edge-partitions the Tanner graph: a rank runs the
  decoder on its :class:`~tpugnn_torch.dist.partition.LocalGraphView`, whose
  rounds exchange halos with the other graph ranks and whose pooled sums
  are summed over them;
* the ``data`` axis splits the batch; gradients are averaged over it.

Gradient accounting of :func:`make_sharded_train_step`: a rank's loss is its
qubit columns' share of the per-qubit term plus ``1 / P`` of the logical
term (which every graph rank computes from the same pooled sums), so the
graph ranks' losses sum to the whole graph's loss.  Every collective's
backward is its transpose (the sum's is the sum of the cotangents, the
exchange's the reverse exchange), so summing the ranks' gradients gives the
whole graph's gradient with each edge counted once; they are then averaged
over ``data``.

Launch: one process per rank, joined by
:func:`tpugnn_torch.dist.multihost.initialize` (``torchrun`` on several
cards), or :func:`tpugnn_torch.dist.multihost.launch` on one host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpugnn_torch.configs.config import (
    CodeConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from tpugnn_torch.dist import multihost
from tpugnn_torch.dist.exchange import _all_reduce, gather_rows
from tpugnn_torch.dist.mesh import data_shard, make_mesh
from tpugnn_torch.dist.partition import PartitionedGraph, build_partitioned_code
from tpugnn_torch.models.decoder import DecoderOutput, GNNDecoder
from tpugnn_torch.sampling.noise import SyndromeBatch
from tpugnn_torch.utils.device import resolve_device

__all__ = ["make_sharded_apply", "make_sharded_train_step", "dryrun", "ShardedApply"]


def _place(model: GNNDecoder, device) -> torch.device:
    """Put ``model`` on ``device`` (a card unless the caller asks for the
    CPU; on a card without an index, the rank's current one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model.to(dev)
    return dev


def _graph_axis(mesh, pgraph: PartitionedGraph, dev):
    """(graph group, this rank's index on the graph axis).  Runs the group's
    first collective, a sum of one zero: NCCL wants every rank of a group in
    its first batch of point-to-point calls, and a ring shift leaves out the
    ranks with nothing to send."""
    name = mesh.mesh_dim_names[1]
    if mesh.size(1) != pgraph.n_parts:
        raise ValueError(f"the mesh's graph axis has {mesh.size(1)} ranks and the graph "
                         f"{pgraph.n_parts} shards")
    group = mesh.get_group(name)
    _all_reduce(torch.zeros(1, device=dev), group)
    return group, mesh.get_local_rank(name)


class ShardedApply:
    """What :func:`make_sharded_apply` returns: ``apply(graph, syndrome) ->
    DecoderOutput`` on this rank's shard; ``view`` is the shard."""

    def __init__(self, model: GNNDecoder, view, mb: int):
        self.model, self.view, self.mb = model, view, mb
        self.per_qubit = model.cfg.readout == "per_qubit"

    def __call__(self, graph, syndrome: torch.Tensor) -> DecoderOutput:
        view, g, mb = self.view, self.view.rank, self.mb
        out = self.model(view, syndrome[:, g * mb:(g + 1) * mb].to(view.c_mask.device))
        return DecoderOutput(qubit_logits=gather_rows(out.qubit_logits, view.group, halo=False),
                             logical_logits=None if self.per_qubit else out.logical_logits)

    def to(self, device) -> "ShardedApply":
        """Kept on its rank's device (``ler_monte_carlo`` moves its model)."""
        if torch.device(device) != self.view.c_mask.device:
            raise ValueError(f"a sharded apply stays on {self.view.c_mask.device}, not {device}")
        return self


def make_sharded_apply(model: GNNDecoder, mesh, pgraph: PartitionedGraph, *,
                       device="cuda") -> ShardedApply:
    """Graph-parallel forward: ``apply(graph, syndrome) -> DecoderOutput``,
    the signature of ``model(graph, syndrome)`` (``graph`` is not used: the
    partitioned graph drives the forward).  ``syndrome`` is the whole
    [B, m_pad] batch on every graph rank; the qubit logits come back whole
    ([B, n_pad, .], all-gathered over the graph ranks) and the logical
    logits replicated, as ``tpugnn/dist/api.py:37-71`` returns them.  The
    model and the rank's shard go to ``device``."""
    dev = _place(model, device)
    group, g = _graph_axis(mesh, pgraph, dev)
    return ShardedApply(model, pgraph.shard(g, group, dev), pgraph.mb)


def _local_batch(batch: SyndromeBatch, mesh, pgraph: PartitionedGraph, g: int,
                 dev) -> SyndromeBatch:
    """This rank's data share of the batch, at its graph shard's columns."""
    share = SyndromeBatch(*[data_shard(mesh, t) for t in batch])
    cs = slice(g * pgraph.mb, (g + 1) * pgraph.mb)
    qs = slice(g * pgraph.nb, (g + 1) * pgraph.nb)
    return SyndromeBatch(syndrome=share.syndrome[:, cs].to(dev), ex=share.ex[:, qs].to(dev),
                         ez=share.ez[:, qs].to(dev), class_bits=share.class_bits.to(dev))


def make_sharded_train_step(cfg: ExperimentConfig, model: GNNDecoder, mesh, graph,
                            pgraph: PartitionedGraph, optimizer=None, *, device="cuda"):
    """One data- and graph-parallel train step (``tpugnn/dist/api.py:86-118``):
    ``step(batch) -> metrics``.

    ``batch`` is the whole batch (a ``SyndromeBatch`` of B rows, the same on
    every rank; the step does not sample it); each rank takes its data share
    and its graph shard's columns.  Gradients are summed over the graph
    ranks and averaged over the data ranks (module docstring), and every
    rank applies ``optimizer`` (``make_optimizer(cfg, ...)`` when None) to
    the same gradients.  The metrics are those of ``loss_fn`` on the whole
    batch, as tensors.  The model and the rank's shard go to ``device``."""
    from tpugnn_torch.train.loop import loss_terms
    from tpugnn_torch.train.optim import make_optimizer

    dev = _place(model, device)
    group, g = _graph_axis(mesh, pgraph, dev)
    n_data = mesh.size(0)
    view = pgraph.shard(g, group, dev)
    opt = optimizer if optimizer is not None else make_optimizer(cfg, model.parameters())
    params = list(model.parameters())
    nb = pgraph.nb
    qm = ((torch.arange(nb, device=dev) + g * nb) < pgraph.n_qubits).float()

    def step(batch: SyndromeBatch) -> dict:
        local = _local_batch(batch, mesh, pgraph, g, dev)
        opt.zero_grad(set_to_none=True)
        total, metrics = loss_terms(model(view, local.syndrome), local, qm,
                                    pgraph.n_qubits, cfg, logical_share=1.0 / pgraph.n_parts)
        total.backward()
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        flat = _all_reduce(flat, dist.group.WORLD) / n_data
        i = 0
        for p in params:
            p.grad = flat[i:i + p.numel()].view_as(p)
            i += p.numel()
        opt.step()
        names = sorted(metrics)
        vals = _all_reduce(torch.stack([metrics[k].detach().float() for k in names]),
                           dist.group.WORLD) / n_data
        return dict(zip(names, vals))

    return step


def _pick_mesh_shape(n_devices: int) -> MeshConfig:
    graph_ax = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    return MeshConfig(data=n_devices // graph_ax, graph=graph_ax)


def _dryrun_rank(n_devices: int, distance: int, family: str, hidden: int, rounds: int,
                 halo: str, device_type: str) -> float:
    """One rank of :func:`dryrun`."""
    from tpugnn_torch.train.loop import init_state
    from tpugnn_torch.sampling.noise import sample_batch

    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    mcfg = _pick_mesh_shape(n_devices)
    mesh = make_mesh(mcfg, n_devices=n_devices)
    graph, pgraph = build_partitioned_code(family, distance, mcfg.graph, halo=halo)
    cfg = ExperimentConfig(
        code=CodeConfig(family=family, distance=distance, p=0.05),
        model=ModelConfig(hidden=hidden, msg_hidden=hidden, rounds=rounds),
        train=TrainConfig(batch=max(8, 2 * mcfg.data), steps=1, warmup_steps=1), mesh=mcfg)
    state = init_state(cfg, graph, dev)
    step = make_sharded_train_step(cfg, state.model, mesh, graph, pgraph, state.optimizer,
                                   device=dev)
    batch = sample_batch(state.generator, graph.to(dev), cfg.code.p, cfg.train.batch)
    loss = float(step(batch)["loss"])
    print(f"dryrun: mesh=(data={mcfg.data}, graph={mcfg.graph}) "
          f"graph={graph.name} loss={loss:.4f}", flush=True)
    return loss


def dryrun(n_devices: int, *, distance: int = 5, family: str = "surface", hidden: int = 16,
           rounds: int = 2, halo: str = "alltoall", device="cuda", backend: str | None = None,
           timeout: float = 600.0) -> float:
    """One sharded train step on small shapes over ``n_devices`` ranks that
    it starts itself (``tpugnn/dist/api.py:126-153``): mesh
    ``data x graph`` with graph 4, 2 or 1, batch ``max(8, 2 * data)``.
    Every rank prints ``dryrun: mesh=(data=.., graph=..) graph=.. loss=..``;
    returns rank 0's loss and raises if the ranks' losses differ.  On a
    card every rank takes ``cuda:rank mod device_count`` (``backend``:
    ``nccl`` by default, ``'gloo'`` for several ranks on one card)."""
    dev = resolve_device(device)
    losses = multihost.launch(
        _dryrun_rank, n_devices,
        args=(n_devices, distance, family, hidden, rounds, halo, dev.type),
        device=dev.type, backend=backend, timeout=timeout)
    if max(losses) - min(losses) > 1e-6 * max(1.0, abs(losses[0])):
        raise RuntimeError(f"dryrun: the ranks' losses differ: {losses}")
    return losses[0]
