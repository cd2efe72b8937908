"""PyG-style ``MessagePassing`` adapter over the functional engine (the port
of ``tpugnn.mp.message_passing``)::

    class BPLayer(MessagePassing):
        def __init__(self):
            super().__init__(aggr="sum", flow="qubit->check")
        def message(self, x_i, x_j, edge_attr):
            return torch.tanh(x_i + x_j)          # x_i = dst, x_j = src
        def update(self, aggr_out, x):
            return x + aggr_out

    new_checks = BPLayer().propagate(graph, x_check=xc, x_qubit=xq)

``message`` receives ``(x_i, x_j, edge_attr)`` with ``x_i`` the destination
endpoint; ``update`` receives ``(aggr_out, x_dst)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpugnn_torch.mp.aggregate import AGGREGATIONS
from tpugnn_torch.mp.propagate import propagate as _propagate

__all__ = ["MessagePassing"]


class MessagePassing:
    """Subclassable twin of the reference's MessagePassing base class."""

    def __init__(self, aggr: str = "sum", flow: str = "qubit->check",
                 backend: str = "segment"):
        if aggr not in AGGREGATIONS:
            raise ValueError(f"aggr must be sum|mean|max, got {aggr!r}")
        if flow not in ("qubit->check", "check->qubit"):
            raise ValueError(f"flow must be 'qubit->check' or 'check->qubit', got {flow!r}")
        self.aggr = aggr
        self.flow = flow
        self.backend = backend

    def message(self, x_i: torch.Tensor, x_j: torch.Tensor,
                edge_attr: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-edge message from destination (x_i) and source (x_j) features."""
        return x_j

    def update(self, aggr_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """New destination-node state from the aggregated messages."""
        return aggr_out

    def propagate(self, graph, *, x_check: torch.Tensor, x_qubit: torch.Tensor,
                  edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """collect -> message -> aggregate -> update, one direction; returns
        the updated destination states (checks for flow='qubit->check')."""
        to = "check" if self.flow == "qubit->check" else "qubit"

        def message_fn(xc_e, xq_e, ea):
            x_i, x_j = (xc_e, xq_e) if to == "check" else (xq_e, xc_e)
            return self.message(x_i, x_j, ea)

        return _propagate(graph, x_check, x_qubit, message_fn, to=to,
                          edge_attr=edge_attr, aggr=self.aggr,
                          update_fn=lambda old, agg: self.update(agg, old),
                          backend=self.backend)

    def __call__(self, graph, x_check, x_qubit, edge_attr=None):
        return self.propagate(graph, x_check=x_check, x_qubit=x_qubit,
                              edge_attr=edge_attr)
