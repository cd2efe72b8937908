"""Gather and scatter-aggregate backends of Tanner-graph message passing.

The port of ``tpugnn.mp.aggregate`` (without the mesh ``psum``).  The same
four interchangeable backends, each the same function up to f32 summation
order:

``segment``  ``index_select`` gathers; ``index_add_`` sums into rows
             (``scatter_reduce('amax')`` for max);
``dense``    one-hot incidence ``einsum`` in f32 (max goes to ``segment``);
``ell``      gather into the ELL slot tables, then a masked reshape-sum or
             max over the slots, in the message's type;
``pallas``   the ELL slot tables through the hand-written kernels K3a (sum,
             mean) and K3b (max) of :mod:`tpugnn_torch.kernels.spmm`; the
             message is read as f32 and the result is f32.

Every backend multiplies the messages by ``edge_mask`` first, so padded
edges are exact zeros (and, as in JAX, a bf16 message becomes f32 there); an
empty row's max is 0; mean divides by ``check_deg``/``qubit_deg``, clamped
to >= 1 as the graph builds them.  Graph arrays are tensors
(``TannerGraph.to``).
"""

from __future__ import annotations

import torch

__all__ = ["gather_endpoints", "aggregate_to_checks", "aggregate_to_qubits",
           "global_node_sum", "BACKENDS", "AGGREGATIONS"]

BACKENDS = ("segment", "dense", "ell", "pallas")
AGGREGATIONS = ("sum", "mean", "max")


def _validate_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")


def _onehot(index: torch.Tensor, rows: int, edge_mask: torch.Tensor) -> torch.Tensor:
    """f32[E_pad, rows] one-hot of edge -> row, zero for padded edges."""
    oh = torch.nn.functional.one_hot(index.long(), rows).float()
    return oh * edge_mask[:, None]


def gather_endpoints(graph, x_check: torch.Tensor, x_qubit: torch.Tensor, *,
                     backend: str = "segment") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge endpoint features: x_check [..., m_pad, F], x_qubit
    [..., n_pad, F] -> (xc_e, xq_e) [..., E_pad, F] in canonical edge order,
    zero on padded edges."""
    _validate_backend(backend)
    if backend == "dense":
        oc = _onehot(graph.edge_check, graph.n_checks_pad, graph.edge_mask)
        oq = _onehot(graph.edge_qubit, graph.n_qubits_pad, graph.edge_mask)
        return (torch.einsum("em,...mf->...ef", oc, x_check.float()),
                torch.einsum("en,...nf->...ef", oq, x_qubit.float()))
    mask = graph.edge_mask[:, None]
    xc_e = x_check.index_select(-2, graph.edge_check.long())
    xq_e = x_qubit.index_select(-2, graph.edge_qubit.long())
    return xc_e * mask, xq_e * mask


def _segment_agg(msg: torch.Tensor, seg_ids: torch.Tensor, rows: int,
                 agg: str) -> torch.Tensor:
    """Reduction of the edge axis (-2) into ``rows`` segments."""
    idx = seg_ids.long()
    shape = msg.shape[:-2] + (rows, msg.shape[-1])
    if agg == "max":
        index = idx.reshape((1,) * (msg.dim() - 2) + (-1, 1)).expand(msg.shape)
        out = msg.new_full(shape, float("-inf")).scatter_reduce(
            -2, index, msg, "amax", include_self=False)
        # empty rows stay -inf; zero them, and only them
        return torch.where(torch.isneginf(out), 0.0, out)
    return msg.new_zeros(shape).index_add_(-2, idx, msg)


def _aggregate(graph, msg: torch.Tensor, *, to: str, backend: str,
               agg: str) -> torch.Tensor:
    """msg [..., E_pad, F] in canonical edge order -> [..., rows, F]."""
    _validate_backend(backend)
    if agg not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {agg!r}; have sum|mean|max")
    msg = msg * graph.edge_mask[:, None]
    if to == "check":
        seg_ids, rows, deg = graph.edge_check, graph.n_checks_pad, graph.check_deg
        slot_edge, slot_mask = graph.ell_check_edge, graph.ell_check_mask
    else:
        seg_ids, rows, deg = graph.edge_qubit, graph.n_qubits_pad, graph.qubit_deg
        slot_edge, slot_mask = graph.ell_qubit_edge, graph.ell_qubit_mask

    if backend == "pallas":
        from tpugnn_torch.kernels import spmm

        out = spmm.ell_aggregate(msg, slot_edge, slot_mask, agg=agg)
    elif backend == "ell":
        f = msg.shape[-1]
        sl = msg.index_select(-2, slot_edge.reshape(-1).long())
        sl = sl.reshape(msg.shape[:-2] + tuple(slot_edge.shape) + (f,))
        if agg == "max":
            sl = torch.where(slot_mask[..., None] > 0, sl, float("-inf"))
            out = sl.amax(-2)
            out = torch.where(torch.isneginf(out), 0.0, out)
        else:
            out = (sl * slot_mask[..., None]).sum(-2)
    elif backend == "dense" and agg in ("sum", "mean"):
        out = torch.einsum("er,...ef->...rf", _onehot(seg_ids, rows, graph.edge_mask),
                           msg.float())
    else:
        out = _segment_agg(msg, seg_ids, rows, agg)
    if agg == "mean":
        out = out / deg[:, None]
    return out


def global_node_sum(graph, x: torch.Tensor, *, which: str) -> torch.Tensor:
    """Masked sum of node features over the real nodes: [..., rows, F] -> [..., F]."""
    mask = graph.check_mask if which == "check" else graph.qubit_mask
    return (x * mask[:, None]).sum(-2)


def aggregate_to_checks(graph, msg: torch.Tensor, *, backend: str = "segment",
                        agg: str = "sum") -> torch.Tensor:
    """Aggregate per-edge messages into check rows: [..., m_pad, F]."""
    return _aggregate(graph, msg, to="check", backend=backend, agg=agg)


def aggregate_to_qubits(graph, msg: torch.Tensor, *, backend: str = "segment",
                        agg: str = "sum") -> torch.Tensor:
    """Aggregate per-edge messages into qubit rows: [..., n_pad, F]."""
    return _aggregate(graph, msg, to="qubit", backend=backend, agg=agg)
