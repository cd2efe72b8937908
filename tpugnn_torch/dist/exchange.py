"""Halo exchange and shard-local aggregation of edge-partitioned rounds.

The port of ``tpugnn.dist.exchange`` onto ``torch.distributed``: the twin of
:func:`tpugnn_torch.mp.bipartite_round` on one rank's
:class:`~tpugnn_torch.dist.partition.LocalGraphView`, over its ``graph``
process group.

* Edges belong to the shard of their destination row, so aggregation is a
  shard-local segmented sum (``index_add_``); only source node features
  cross ranks.
* ``view.halo`` picks how they cross: ``'gather'`` all-gathers every node
  block (``all_gather``; also the route of max aggregation), ``'alltoall'``
  sends each peer only the boundary rows it reads, as one
  ``all_to_all_single`` of a [P, H, F] buffer, and ``'ring'`` sends the same
  slices as P - 1 cyclic shifts (slice j to peer (i + j) mod P, one
  ``batch_isend_irecv`` each), equal to ``'alltoall'`` bit for bit.
* ``view.halo_dtype`` is the wire type of the boundary exchanges:
  ``'float32'``, ``'bfloat16'`` (half the bytes) or ``'int8'`` (a quarter:
  symmetric, at a per-(shot, peer-slice) scale ``max(amax, 1e-30)`` that
  rides a second exchange).  The exchange is a ``torch.autograd.Function``
  whose backward is the transpose of the f32 exchange (the reverse
  all-to-all or shifts, then ``index_add_`` into the sent rows), for every
  wire type: compressed wires train through a straight-through estimator.
* Only the real halo rows move: a peer's slots are filled from the first,
  so each slice of the [P, H, F] buffer is cut to its real rows on the
  wire (``all_to_all_single`` with uneven splits) and the receiver's
  padded slots are zero, as the masked send makes them.
* Payloads move as bytes.  On a gloo group with tensors on a card (several
  ranks sharing one card) every collective is staged through pinned host
  memory; that is decided by the group's backend, and :func:`counts` gives
  the bytes staged and the halo bytes sent to peers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from tpugnn_torch.mp.aggregate import _segment_agg

__all__ = ["sharded_bipartite_round", "sharded_propagate", "halo_exchange",
           "all_reduce_sum", "gather_rows", "counts", "reset_counts"]

_COUNTS = {"exchanges": 0, "halo_bytes": 0, "staged_bytes": 0}


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def counts() -> dict:
    """Since the last :func:`reset_counts`: halo exchanges run, bytes sent to
    peers by them (payload and scales, forward and backward) and bytes
    staged through the host (both ways, every collective)."""
    return dict(_COUNTS)


# --- collectives -------------------------------------------------------------

def _group(group):
    return dist.group.WORLD if group is None else group


def _staged(t: torch.Tensor, group) -> bool:
    """A gloo group moves host tensors only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    _COUNTS["staged_bytes"] += h.numel() * h.element_size()
    return h


def _to_device(h: torch.Tensor, device) -> torch.Tensor:
    _COUNTS["staged_bytes"] += h.numel() * h.element_size()
    return h.to(device, non_blocking=True)


def _move(buf: torch.Tensor, group, *, ring: bool, reverse: bool = False,
          send_rows=None, recv_rows=None) -> torch.Tensor:
    """Peer-major [P, ...] send buffer (slice j for peer j) -> [P, ...]
    receive buffer (slice j from peer j), as bytes.  ``ring``: P - 1 cyclic
    shifts, the j-th sending slice (i + j) mod P to that peer (``reverse``:
    to (i - j) mod P, the transpose).  With ``send_rows``/``recv_rows`` (a
    count per peer) only that prefix of dim 2 of each slice moves: the halo
    rows a peer reads are the first of its slots, the rest are masked, and
    the receive buffer is zero there."""
    group = _group(group)
    p, me = dist.get_world_size(group), dist.get_rank(group)
    whole = send_rows is None
    parts = [buf[j] if whole else buf[j, :, :send_rows[j]] for j in range(p)]
    src = torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in parts])
    sizes_out = [t.numel() * t.element_size() for t in parts]
    shapes_in = [buf.shape[1:] if whole else (buf.shape[1], recv_rows[i]) + buf.shape[3:]
                 for i in range(p)]
    sizes_in = [math.prod(sh) * buf.element_size() for sh in shapes_in]
    staged = _staged(buf, group)
    if staged:
        src = _to_host(src)
    _COUNTS["halo_bytes"] += sum(sizes_out) - sizes_out[me]
    out = torch.empty(sum(sizes_in), dtype=torch.uint8, device=src.device)
    if not ring:
        dist.all_to_all_single(out, src, output_split_sizes=sizes_in,
                               input_split_sizes=sizes_out, group=group)
    else:
        at_out = [sum(sizes_out[:j]) for j in range(p)]
        at_in = [sum(sizes_in[:j]) for j in range(p)]
        seg = lambda t, at, size, j: t[at[j]:at[j] + size[j]]
        seg(out, at_in, sizes_in, me).copy_(seg(src, at_out, sizes_out, me))
        ranks = dist.get_process_group_ranks(group)
        for j in range(1, p):
            to, frm = ((me - j) % p, (me + j) % p) if reverse else ((me + j) % p, (me - j) % p)
            ops = []
            if sizes_out[to]:
                ops.append(dist.P2POp(dist.isend, seg(src, at_out, sizes_out, to),
                                      ranks[to], group))
            if sizes_in[frm]:
                ops.append(dist.P2POp(dist.irecv, seg(out, at_in, sizes_in, frm),
                                      ranks[frm], group))
            for r in dist.batch_isend_irecv(ops) if ops else ():
                r.wait()
    if staged:
        out = _to_device(out, buf.device)
    if whole:
        return out.view(buf.dtype).reshape(buf.shape)
    recv = buf.new_zeros(buf.shape)
    for i, chunk in enumerate(out.split(sizes_in)):
        if sizes_in[i]:
            recv[i, :, :recv_rows[i]] = chunk.view(buf.dtype).reshape(shapes_in[i])
    return recv


def _gather_rows(x: torch.Tensor, group, halo: bool) -> torch.Tensor:
    """[..., rows, F] on each rank -> [..., P * rows, F], the blocks in rank
    order (``jax.lax.all_gather(..., axis=-2, tiled=True)``); ``halo``
    counts it as an exchange."""
    group = _group(group)
    p = dist.get_world_size(group)
    xm = x.movedim(-2, 0).contiguous()
    src = xm.view(torch.uint8)
    staged = _staged(x, group)
    if staged:
        src = _to_host(src)
    outs = [torch.empty_like(src) for _ in range(p)]
    dist.all_gather(outs, src, group=group)
    if halo:
        _COUNTS["exchanges"] += 1
        _COUNTS["halo_bytes"] += (p - 1) * src.numel()
    out = torch.cat(outs, 0)
    if staged:
        out = _to_device(out, x.device)
    return out.view(x.dtype).movedim(0, -2)


def _reduce_scatter_rows(g: torch.Tensor, group) -> torch.Tensor:
    """Transpose of :func:`_gather_rows`: [..., P * rows, F] -> each rank's
    block summed over the ranks."""
    p = dist.get_world_size(_group(group))
    gm = g.movedim(-2, 0)
    gm = gm.reshape((p, gm.shape[0] // p) + gm.shape[1:])
    return _move(gm, group, ring=False).sum(0).movedim(0, -2)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    group = _group(group)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    staged = _staged(y, group)
    buf = _to_host(y) if staged else y
    dist.all_reduce(buf, group=group)
    return _to_device(buf, x.device) if staged else buf


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its transpose is the same sum of the cotangents
    (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, halo):
        ctx.group = group
        return _gather_rows(x, group, halo)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_rows(g.contiguous(), ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group, *, halo: bool = True) -> torch.Tensor:
    """Differentiable all-gather of node blocks along dim -2 (``halo``:
    counted in :func:`counts` as an exchange)."""
    return _GatherRows.apply(x, group, halo)


# --- the boundary exchange ---------------------------------------------------

def _quant_pack(send: torch.Tensor, halo_dtype: str):
    """[..., P, H, F] send buffer -> (wire payload, per-(shot, peer) scale
    [..., P, 1, 1] or None), in ``tpugnn/dist/exchange.py:100-120``'s
    order of operations (``torch.round`` rounds half to even, as
    ``jnp.round``)."""
    if halo_dtype == "float32":
        return send, None
    if halo_dtype == "bfloat16":
        return send.to(torch.bfloat16), None
    if halo_dtype == "int8":
        amax = send.abs().amax(dim=(-2, -1), keepdim=True)
        scale = torch.clamp_min(amax, 1e-30)
        q = torch.clamp(torch.round(send / scale * 127.0), -127.0, 127.0)
        return q.to(torch.int8), scale
    raise ValueError(f"unknown halo_dtype {halo_dtype!r}; have 'float32'|'bfloat16'|'int8'")


def _dequant(recv: torch.Tensor, scale: Optional[torch.Tensor], halo_dtype: str):
    if halo_dtype == "int8":
        return recv.float() * (scale * (1.0 / 127.0))
    return recv.float()


def _exchange(x, send_idx, send_mask, rows, group, ring: bool, halo_dtype: str):
    """[..., rows, F] -> the f32 halo receive buffer [..., P * H, F];
    ``rows`` = (real rows sent to each peer, real rows received from each)."""
    p, h = send_idx.shape
    lead, f = x.shape[:-2], x.shape[-1]
    send = x.index_select(-2, send_idx.reshape(-1)) * send_mask.reshape(-1)[:, None]
    send = send.reshape((-1, p, h, f))                     # [N, P, H, F]
    payload, scale = _quant_pack(send, halo_dtype)
    recv = _move(payload.transpose(0, 1), group, ring=ring, send_rows=rows[0],
                 recv_rows=rows[1]).transpose(0, 1)
    if scale is not None:
        scale = _move(scale.transpose(0, 1), group, ring=ring).transpose(0, 1)
    _COUNTS["exchanges"] += 1
    return _dequant(recv, scale, halo_dtype).reshape(lead + (p * h, f))


class _HaloExchange(torch.autograd.Function):
    """The boundary exchange at any wire type; its backward is the transpose
    of the f32 exchange (straight through the quantisation)."""

    @staticmethod
    def forward(ctx, x, send_idx, send_mask, rows, group, ring, halo_dtype):
        ctx.save_for_backward(send_idx, send_mask)
        ctx.rows, ctx.group, ctx.ring = rows, group, ring
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return _exchange(x, send_idx, send_mask, rows, group, ring, halo_dtype)

    @staticmethod
    def backward(ctx, g):
        send_idx, send_mask = ctx.saved_tensors
        p, h = send_idx.shape
        rows, f = ctx.x_shape[-2], ctx.x_shape[-1]
        gb = g.reshape((-1, p, h, f)).float()
        back = _move(gb.transpose(0, 1), ctx.group, ring=ctx.ring, reverse=True,
                     send_rows=ctx.rows[1], recv_rows=ctx.rows[0]).transpose(0, 1)
        back = (back * send_mask[None, :, :, None]).reshape(-1, p * h, f)
        gx = back.new_zeros((back.shape[0], rows, f)).index_add_(1, send_idx.reshape(-1), back)
        return gx.reshape(ctx.x_shape).to(ctx.x_dtype), None, None, None, None, None, None


def halo_exchange(view, x_check: torch.Tensor, x_qubit: torch.Tensor):
    """Both boundary exchanges of a round at the view's halo mode and wire
    type: (check halo [..., P * Hc, F], qubit halo [..., P * Hq, F])."""
    ring = view.halo == "ring"
    q_halo = _HaloExchange.apply(x_qubit, view.qsend_idx, view.qsend_mask, view.q_halo_rows,
                                 view.group, ring, view.halo_dtype)
    c_halo = _HaloExchange.apply(x_check, view.csend_idx, view.csend_mask, view.c_halo_rows,
                                 view.group, ring, view.halo_dtype)
    return c_halo, q_halo


# --- the sharded rounds ------------------------------------------------------

def _segment(msg, dst, rows, agg, deg):
    out = _segment_agg(msg, dst, rows, "max" if agg == "max" else "sum")
    if agg == "mean":
        out = out / deg[:, None]
    return out


def _local_attr(edge_attr, eid):
    """Shard-local rows of the canonical per-edge attribute table (small,
    replicated on every rank); padded slots read row 0 and are zeroed by the
    edge mask after the message function."""
    if edge_attr is None:
        return None
    return edge_attr.index_select(-2, eid)


def sharded_propagate(view, x_check, x_qubit, message_fn, *, to: str, edge_attr=None,
                      aggr: str = "sum", update_fn=None):
    """One directed step on a shard: all-gather the sources, aggregate
    locally (``tpugnn/dist/exchange.py:64-97``)."""
    if to == "check":
        x_src_all = gather_rows(x_qubit, view.group)
        xc_e = x_check.index_select(-2, view.c_dst)
        xq_e = x_src_all.index_select(-2, view.c_src)
        msg = message_fn(xc_e, xq_e, _local_attr(edge_attr, view.c_eid))
        msg = msg * view.c_mask[:, None]
        out = _segment(msg, view.c_dst, view.n_checks_pad, aggr, view.check_deg)
        old = x_check
    elif to == "qubit":
        x_src_all = gather_rows(x_check, view.group)
        xq_e = x_qubit.index_select(-2, view.q_dst)
        xc_e = x_src_all.index_select(-2, view.q_src)
        msg = message_fn(xc_e, xq_e, _local_attr(edge_attr, view.q_eid))
        msg = msg * view.q_mask[:, None]
        out = _segment(msg, view.q_dst, view.n_qubits_pad, aggr, view.qubit_deg)
        old = x_qubit
    else:
        raise ValueError(f"to must be 'check' or 'qubit', got {to!r}")
    if update_fn is not None:
        out = update_fn(old, out)
    return out


def _alltoall_round(view, state, message_to_qubit, message_to_check, update_check,
                    update_qubit, aggr, edge_attr=None):
    """Boundary-only exchange, interior and boundary edges aggregated apart
    (``tpugnn/dist/exchange.py:248-301``)."""
    from tpugnn_torch.mp.propagate import NodeStates

    c_halo, q_halo = halo_exchange(view, state.check, state.qubit)

    # interior (local sources)
    xc_i = state.check.index_select(-2, view.ci_dst)
    xq_i = state.qubit.index_select(-2, view.ci_src)
    m_ci = message_to_check(xc_i, xq_i, _local_attr(edge_attr, view.ci_eid))
    m_ci = m_ci * view.ci_mask[:, None]
    agg_c = _segment(m_ci, view.ci_dst, view.n_checks_pad, "sum", view.check_deg)

    xq_i2 = state.qubit.index_select(-2, view.qi_dst)
    xc_i2 = state.check.index_select(-2, view.qi_src)
    m_qi = message_to_qubit(xc_i2, xq_i2, _local_attr(edge_attr, view.qi_eid))
    m_qi = m_qi * view.qi_mask[:, None]
    agg_q = _segment(m_qi, view.qi_dst, view.n_qubits_pad, "sum", view.qubit_deg)

    # boundary (sources from the halo buffers)
    xc_b = state.check.index_select(-2, view.cb_dst)
    xq_b = q_halo.index_select(-2, view.cb_src)
    m_cb = message_to_check(xc_b, xq_b, _local_attr(edge_attr, view.cb_eid))
    m_cb = m_cb * view.cb_mask[:, None]
    agg_c = agg_c + _segment(m_cb, view.cb_dst, view.n_checks_pad, "sum", view.check_deg)

    xq_b2 = state.qubit.index_select(-2, view.qb_dst)
    xc_b2 = c_halo.index_select(-2, view.qb_src)
    m_qb = message_to_qubit(xc_b2, xq_b2, _local_attr(edge_attr, view.qb_eid))
    m_qb = m_qb * view.qb_mask[:, None]
    agg_q = agg_q + _segment(m_qb, view.qb_dst, view.n_qubits_pad, "sum", view.qubit_deg)

    if aggr == "mean":
        agg_c = agg_c / view.check_deg[:, None]
        agg_q = agg_q / view.qubit_deg[:, None]
    return NodeStates(check=update_check(state.check, agg_c),
                      qubit=update_qubit(state.qubit, agg_q))


def sharded_bipartite_round(view, state, *, message_to_qubit, message_to_check,
                            update_check, update_qubit, edge_attr=None, aggr: str = "sum"):
    """One round on one shard, both directions reading the pre-round states
    (``tpugnn/dist/exchange.py:304-356``).  Each direction evaluates its
    message on its own destination-owned copy of the edge.  ``'alltoall'``
    and ``'ring'`` run the boundary exchange for sum and mean; max, and the
    ``'gather'`` mode, all-gather the node blocks."""
    if view.halo in ("alltoall", "ring") and aggr in ("sum", "mean"):
        return _alltoall_round(view, state, message_to_qubit, message_to_check,
                               update_check, update_qubit, aggr, edge_attr)
    from tpugnn_torch.mp.propagate import NodeStates

    xq_all = gather_rows(state.qubit, view.group)
    xc_all = gather_rows(state.check, view.group)

    xc_e = state.check.index_select(-2, view.c_dst)
    xq_e = xq_all.index_select(-2, view.c_src)
    m_c = message_to_check(xc_e, xq_e, _local_attr(edge_attr, view.c_eid))
    m_c = m_c * view.c_mask[:, None]
    agg_c = _segment(m_c, view.c_dst, view.n_checks_pad, aggr, view.check_deg)

    xq_e2 = state.qubit.index_select(-2, view.q_dst)
    xc_e2 = xc_all.index_select(-2, view.q_src)
    m_q = message_to_qubit(xc_e2, xq_e2, _local_attr(edge_attr, view.q_eid))
    m_q = m_q * view.q_mask[:, None]
    agg_q = _segment(m_q, view.q_dst, view.n_qubits_pad, aggr, view.qubit_deg)

    return NodeStates(check=update_check(state.check, agg_c),
                      qubit=update_qubit(state.qubit, agg_q))
