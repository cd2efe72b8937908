"""Functional message-passing engine (the port of ``tpugnn.mp``)."""

from tpugnn_torch.mp.aggregate import (
    AGGREGATIONS,
    BACKENDS,
    aggregate_to_checks,
    aggregate_to_qubits,
    gather_endpoints,
    global_node_sum,
)
from tpugnn_torch.mp.message_passing import MessagePassing
from tpugnn_torch.mp.propagate import NodeStates, bipartite_round, propagate

__all__ = ["AGGREGATIONS", "BACKENDS", "MessagePassing", "NodeStates",
           "aggregate_to_checks", "aggregate_to_qubits", "bipartite_round",
           "gather_endpoints", "global_node_sum", "propagate"]
