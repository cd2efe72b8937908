"""Functional message-passing engine (the port of ``tpugnn.mp.propagate``).

:func:`propagate` runs one direction (collect -> message -> aggregate ->
update); :func:`bipartite_round` one full round, both directions reading the
pre-round states, with the endpoint gather shared between them.  On a
shard's :class:`~tpugnn_torch.dist.partition.LocalGraphView` both route to
the halo exchange of :mod:`tpugnn_torch.dist.exchange` (``backend`` is then
not used), so the calling model runs unchanged on one rank or on several.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpugnn_torch.mp.aggregate import (
    aggregate_to_checks,
    aggregate_to_qubits,
    gather_endpoints,
)

__all__ = ["propagate", "bipartite_round", "NodeStates"]

# message_fn(x_check_at_edge, x_qubit_at_edge, edge_attr) -> per-edge message
MessageFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
# update_fn(old_node_state, aggregated_messages) -> new node state
UpdateFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class NodeStates(NamedTuple):
    """Bipartite node states: checks [..., m_pad, F], qubits [..., n_pad, F]."""

    check: torch.Tensor
    qubit: torch.Tensor


def propagate(graph, x_check: torch.Tensor, x_qubit: torch.Tensor,
              message_fn: MessageFn, *, to: str,
              edge_attr: Optional[torch.Tensor] = None, aggr: str = "sum",
              update_fn: Optional[UpdateFn] = None,
              backend: str = "segment") -> torch.Tensor:
    """One directed step: per-edge messages from both endpoints, aggregated
    into ``to`` in {"check", "qubit"} rows, then ``update_fn(old, agg)``
    when given."""
    if to not in ("check", "qubit"):
        raise ValueError(f"to must be 'check' or 'qubit', got {to!r}")
    if getattr(graph, "partitioned", False):
        from tpugnn_torch.dist.exchange import sharded_propagate

        return sharded_propagate(graph, x_check, x_qubit, message_fn, to=to,
                                 edge_attr=edge_attr, aggr=aggr, update_fn=update_fn)
    xc_e, xq_e = gather_endpoints(graph, x_check, x_qubit, backend=backend)
    msg = message_fn(xc_e, xq_e, edge_attr)
    if to == "check":
        out = aggregate_to_checks(graph, msg, backend=backend, agg=aggr)
        old = x_check
    else:
        out = aggregate_to_qubits(graph, msg, backend=backend, agg=aggr)
        old = x_qubit
    if update_fn is not None:
        out = update_fn(old, out)
    return out


def bipartite_round(graph, state: NodeStates, *, message_to_qubit: MessageFn,
                    message_to_check: MessageFn, update_check: UpdateFn,
                    update_qubit: UpdateFn, edge_attr: Optional[torch.Tensor] = None,
                    aggr: str = "sum", backend: str = "segment") -> NodeStates:
    """One round: both message directions and both node updates (Jacobi:
    both directions read the pre-round states)."""
    if getattr(graph, "partitioned", False):
        from tpugnn_torch.dist.exchange import sharded_bipartite_round

        return sharded_bipartite_round(
            graph, state, message_to_qubit=message_to_qubit,
            message_to_check=message_to_check, update_check=update_check,
            update_qubit=update_qubit, edge_attr=edge_attr, aggr=aggr)
    xc_e, xq_e = gather_endpoints(graph, state.check, state.qubit, backend=backend)
    m_q = message_to_qubit(xc_e, xq_e, edge_attr)
    m_c = message_to_check(xc_e, xq_e, edge_attr)
    # edge-sized tensors (GBs at B=4096) are freed before the node updates
    del xc_e, xq_e
    agg_q = aggregate_to_qubits(graph, m_q, backend=backend, agg=aggr)
    agg_c = aggregate_to_checks(graph, m_c, backend=backend, agg=aggr)
    del m_q, m_c
    return NodeStates(check=update_check(state.check, agg_c),
                      qubit=update_qubit(state.qubit, agg_q))
