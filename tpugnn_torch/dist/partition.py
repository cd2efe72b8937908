"""Deterministic edge partitioner for graph-parallel message passing.

The port of ``tpugnn.dist.partition``; the tables are built with NumPy
exactly as the JAX package builds them, so they are bit-equal to its own.

* Check rows and qubit rows are split into ``n_parts`` contiguous blocks of
  the global padded layout (block p owns checks [p*mb, (p+1)*mb) and qubits
  [p*nb, (p+1)*nb)), so a shard's node features are plain slices of the
  global arrays and reassembling outputs is concatenation.
* Every edge is assigned twice, once per aggregation direction, to the shard
  that owns its destination row, so aggregation is a shard-local segmented
  sum and only source node features cross shards (the halo exchange,
  :mod:`tpugnn_torch.dist.exchange`).
* Per-shard lists are padded to the largest shard's size; padded edges
  carry a zero mask and point at the local dump row ``block - 1``.

:class:`PartitionedGraph` holds the stacked tables ([P, ...], NumPy or, after
:meth:`PartitionedGraph.to`, tensors); :meth:`PartitionedGraph.shard` gives
one rank's :class:`LocalGraphView`, which carries the ``graph`` process group
and the attribute surface of ``TannerGraph`` that the decoder touches, so the
port's ``GNNDecoder`` runs unchanged on it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpugnn_torch.tanner.graph import TannerGraph

__all__ = ["PartitionedGraph", "LocalGraphView", "partition_graph", "build_partitioned_code",
           "HALO_MODES"]

HALO_MODES = ("gather", "alltoall", "ring")

# the per-shard arrays of both classes; the halo tables and edge ids are None
# in 'gather' mode (edge ids are always built)
_BASE = ("c_dst", "c_src", "c_mask", "q_dst", "q_src", "q_mask", "check_mask",
         "qubit_mask", "check_is_x", "check_deg", "qubit_deg", "check_feat", "qubit_feat")
_HALO = ("ci_dst", "ci_src", "ci_mask", "cb_dst", "cb_src", "cb_mask", "qsend_idx",
         "qsend_mask", "qi_dst", "qi_src", "qi_mask", "qb_dst", "qb_src", "qb_mask",
         "csend_idx", "csend_mask")
_EIDS = ("c_eid", "q_eid", "ci_eid", "cb_eid", "qi_eid", "qb_eid")
ARRAYS = _BASE + _HALO + _EIDS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to(obj, device):
    """``obj`` with every array field a tensor on ``device``; index tables
    (integer arrays) become int64."""
    def conv(v):
        if v is None:
            return None
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        if not t.is_floating_point():
            t = t.long()
        return t.to(device)
    return dataclasses.replace(obj, **{f: conv(getattr(obj, f)) for f in ARRAYS})


@dataclass(frozen=True)
class LocalGraphView:
    """One rank's shard of a :class:`PartitionedGraph`.

    ``n_checks_pad``/``n_qubits_pad`` are the local block sizes (mb, nb) and
    ``n_checks``/``n_qubits`` the global real counts (the pool's
    normalisation); ``group`` is the ``graph`` process group its exchanges
    and pooled sums run over.  ``partitioned`` routes ``tpugnn_torch.mp``
    to the halo exchange."""

    partitioned = True

    name: str
    group: Any                 # torch.distributed process group (None: the world)
    rank: int                  # this shard's index on the graph axis
    n_parts: int
    n_checks_pad: int          # = mb (local rows)
    n_qubits_pad: int          # = nb
    n_checks: int              # global real counts
    n_qubits: int
    k: int
    halo: str
    halo_dtype: str
    hq: int                    # qubit halo width per peer
    hc: int                    # check halo width per peer

    c_dst: Any                 # [Ec] local check index
    c_src: Any                 # [Ec] global qubit index
    c_mask: Any
    q_dst: Any                 # [Eq] local qubit index
    q_src: Any                 # [Eq] global check index
    q_mask: Any
    check_mask: Any            # [mb]
    qubit_mask: Any            # [nb]
    check_is_x: Any
    check_deg: Any
    qubit_deg: Any
    check_feat: Any            # [mb, POS_F]
    qubit_feat: Any            # [nb, POS_F]
    # (real rows this shard sends each peer, real rows each peer sends it) of
    # the qubit and the check halo: the real slots of a peer come first
    q_halo_rows: tuple = ()
    c_halo_rows: tuple = ()
    # boundary-only halo tables ('alltoall', 'ring'): interior edges read a
    # local source row, boundary edges a row of the [P*H] receive buffer;
    # *send_idx/*send_mask [P, H] are the rows this shard sends each peer
    ci_dst: Any = None
    ci_src: Any = None
    ci_mask: Any = None
    cb_dst: Any = None
    cb_src: Any = None
    cb_mask: Any = None
    qsend_idx: Any = None
    qsend_mask: Any = None
    qi_dst: Any = None
    qi_src: Any = None
    qi_mask: Any = None
    qb_dst: Any = None
    qb_src: Any = None
    qb_mask: Any = None
    csend_idx: Any = None
    csend_mask: Any = None
    # canonical edge id of each local edge slot (indexes the global padded
    # edge axis), so per-edge attributes are gathered locally
    c_eid: Any = None
    q_eid: Any = None
    ci_eid: Any = None
    cb_eid: Any = None
    qi_eid: Any = None
    qb_eid: Any = None

    def to(self, device) -> "LocalGraphView":
        return _to(self, device)


@dataclass(frozen=True)
class PartitionedGraph:
    """Stacked per-shard graph data; the leading axis of every array is the
    shard (the mesh's ``graph`` axis)."""

    name: str
    n_parts: int
    mb: int                    # local check rows
    nb: int                    # local qubit rows
    ec_pad: int
    eq_pad: int
    n_checks: int
    n_qubits: int
    k: int
    halo: str
    halo_dtype: str
    hq: int
    hc: int

    c_dst: Any
    c_src: Any
    c_mask: Any
    q_dst: Any
    q_src: Any
    q_mask: Any
    check_mask: Any
    qubit_mask: Any
    check_is_x: Any
    check_deg: Any
    qubit_deg: Any
    check_feat: Any
    qubit_feat: Any
    ci_dst: Any = None
    ci_src: Any = None
    ci_mask: Any = None
    cb_dst: Any = None
    cb_src: Any = None
    cb_mask: Any = None
    qsend_idx: Any = None
    qsend_mask: Any = None
    qi_dst: Any = None
    qi_src: Any = None
    qi_mask: Any = None
    qb_dst: Any = None
    qb_src: Any = None
    qb_mask: Any = None
    csend_idx: Any = None
    csend_mask: Any = None
    c_eid: Any = None
    q_eid: Any = None
    ci_eid: Any = None
    cb_eid: Any = None
    qi_eid: Any = None
    qb_eid: Any = None

    def to(self, device) -> "PartitionedGraph":
        return _to(self, device)

    def shard(self, rank: int, group=None, device=None) -> LocalGraphView:
        """Shard ``rank``'s view (row ``rank`` of every table), its arrays
        tensors on ``device`` (the arrays' own device when None)."""
        if not 0 <= rank < self.n_parts:
            raise ValueError(f"rank {rank} outside the {self.n_parts} shards")
        rows = {f: None if getattr(self, f) is None else getattr(self, f)[rank]
                for f in ARRAYS}

        def halo_rows(mask):
            if mask is None:
                return ()
            n = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask).sum(-1)
            n = n.astype(np.int64)
            return tuple(n[rank].tolist()), tuple(n[:, rank].tolist())

        view = LocalGraphView(
            name=self.name, group=group, rank=rank, n_parts=self.n_parts,
            n_checks_pad=self.mb, n_qubits_pad=self.nb, n_checks=self.n_checks,
            n_qubits=self.n_qubits, k=self.k, halo=self.halo, halo_dtype=self.halo_dtype,
            hq=self.hq, hc=self.hc, q_halo_rows=halo_rows(self.qsend_mask),
            c_halo_rows=halo_rows(self.csend_mask), **rows)
        if device is None:
            first = rows["c_dst"]
            device = first.device if isinstance(first, torch.Tensor) else "cpu"
        return view.to(device)


def _halo_tables(dst, src, n_parts, dst_block, src_block, pad=8):
    """Interior/boundary edge split and per-peer send tables of one
    direction (``tpugnn/dist/partition.py:204-260``).

    An edge is interior when its source row is local to its destination's
    shard, boundary otherwise.  Boundary sources are deduplicated per
    (receiver, sender) pair and given sorted halo slots; the receiver's halo
    buffer is [P_senders, H] flattened, so a boundary edge's source is
    ``sender * H + slot``."""
    P = n_parts
    interior = [[] for _ in range(P)]
    boundary = [[] for _ in range(P)]   # (dst_local, sender, src_global, eid)
    needed: dict[tuple[int, int], list[int]] = {}
    for e, (d, s) in enumerate(zip(dst.tolist(), src.tolist())):
        p, o = d // dst_block, s // src_block
        if o == p:
            interior[p].append((d - p * dst_block, s - p * src_block, e))
        else:
            boundary[p].append((d - p * dst_block, o, s, e))
            lst = needed.setdefault((p, o), [])
            if s not in lst:
                lst.append(s)
    h = _round_up(max((len(v) for v in needed.values()), default=1), pad)
    slot = {(p, o): {s: k for k, s in enumerate(sorted(v))} for (p, o), v in needed.items()}
    send_idx = np.zeros((P, P, h), np.int32)
    send_mask = np.zeros((P, P, h), np.float32)
    for (p, o), v in needed.items():
        for s, k in slot[(p, o)].items():
            send_idx[o, p, k] = s - o * src_block
            send_mask[o, p, k] = 1.0
    ei = _round_up(max((len(x) for x in interior), default=1) or 1, pad)
    eb = _round_up(max((len(x) for x in boundary), default=1) or 1, pad)
    i_dst = np.full((P, ei), dst_block - 1, np.int32)
    i_src = np.full((P, ei), src_block - 1, np.int32)
    i_mask = np.zeros((P, ei), np.float32)
    i_eid = np.zeros((P, ei), np.int32)
    b_dst = np.full((P, eb), dst_block - 1, np.int32)
    b_src = np.zeros((P, eb), np.int32)
    b_mask = np.zeros((P, eb), np.float32)
    b_eid = np.zeros((P, eb), np.int32)
    for p in range(P):
        for j, (dl, sl, e) in enumerate(interior[p]):
            i_dst[p, j], i_src[p, j], i_mask[p, j], i_eid[p, j] = dl, sl, 1.0, e
        for j, (dl, o, s, e) in enumerate(boundary[p]):
            b_dst[p, j] = dl
            b_src[p, j] = o * h + slot[(p, o)][s]
            b_mask[p, j] = 1.0
            b_eid[p, j] = e
    return (i_dst, i_src, i_mask, b_dst, b_src, b_mask, send_idx, send_mask, h,
            i_eid, b_eid)


def partition_graph(graph: TannerGraph, n_parts: int, *, pad_edges: int = 128,
                    halo: str = "alltoall", halo_dtype: str = "float32") -> PartitionedGraph:
    """Partition a built graph into ``n_parts`` contiguous node blocks
    (``tpugnn/dist/partition.py:263-345``).  The padded node counts must
    divide evenly: :func:`build_partitioned_code` pads for a shard count.
    ``halo`` picks the exchange ('alltoall', 'ring' or 'gather'),
    ``halo_dtype`` its wire type ('float32', 'bfloat16' or 'int8'; checked
    where the exchange runs, as in the JAX package)."""
    m_pad, n_pad = graph.n_checks_pad, graph.n_qubits_pad
    if m_pad % n_parts or n_pad % n_parts:
        raise ValueError(
            f"padded node counts ({m_pad}, {n_pad}) must divide n_parts={n_parts}; "
            "build the graph with pad_nodes a multiple of 8*n_parts")
    if halo not in HALO_MODES:
        raise ValueError(f"unknown halo mode {halo!r}; have 'gather'|'alltoall'|'ring'")
    mb, nb = m_pad // n_parts, n_pad // n_parts

    ec = np.asarray(graph.edge_check)[: graph.n_edges]
    eq = np.asarray(graph.edge_qubit)[: graph.n_edges]

    def lists(dst, src, block):
        owners = dst // block
        per = [np.lexsort((src[owners == p], dst[owners == p])) for p in range(n_parts)]
        counts = [int((owners == p).sum()) for p in range(n_parts)]
        epad = _round_up(max(max(counts), 1), pad_edges)
        d = np.full((n_parts, epad), block - 1, np.int32)
        s = np.zeros((n_parts, epad), np.int32)
        msk = np.zeros((n_parts, epad), np.float32)
        eid = np.zeros((n_parts, epad), np.int32)
        for p in range(n_parts):
            sel = np.where(owners == p)[0][per[p]]
            c = counts[p]
            d[p, :c] = dst[sel] - p * block
            s[p, :c] = src[sel]
            msk[p, :c] = 1.0
            eid[p, :c] = sel
        return d, s, msk, epad, counts, eid

    c_dst, c_src, c_mask, ec_pad, c_counts, c_eid = lists(ec, eq, mb)
    q_dst, q_src, q_mask, eq_pad, q_counts, q_eid = lists(eq, ec, nb)
    assert sum(c_counts) == graph.n_edges and sum(q_counts) == graph.n_edges

    def blocks(x, block):
        return np.asarray(x).reshape(n_parts, block)

    fields: dict = {"halo": halo, "halo_dtype": halo_dtype, "hq": 0, "hc": 0,
                    "c_eid": c_eid, "q_eid": q_eid}
    if halo in ("alltoall", "ring"):   # ring reuses the per-peer send tables
        (ci_d, ci_s, ci_m, cb_d, cb_s, cb_m, qs_i, qs_m, hq,
         ci_e, cb_e) = _halo_tables(ec, eq, n_parts, mb, nb)
        (qi_d, qi_s, qi_m, qb_d, qb_s, qb_m, cs_i, cs_m, hc,
         qi_e, qb_e) = _halo_tables(eq, ec, n_parts, nb, mb)
        fields.update(
            hq=hq, hc=hc,
            ci_dst=ci_d, ci_src=ci_s, ci_mask=ci_m, ci_eid=ci_e,
            cb_dst=cb_d, cb_src=cb_s, cb_mask=cb_m, cb_eid=cb_e,
            qsend_idx=qs_i, qsend_mask=qs_m,
            qi_dst=qi_d, qi_src=qi_s, qi_mask=qi_m, qi_eid=qi_e,
            qb_dst=qb_d, qb_src=qb_s, qb_mask=qb_m, qb_eid=qb_e,
            csend_idx=cs_i, csend_mask=cs_m)

    return PartitionedGraph(
        name=graph.name + f"_p{n_parts}", n_parts=n_parts, mb=mb, nb=nb,
        ec_pad=ec_pad, eq_pad=eq_pad, n_checks=graph.n_checks, n_qubits=graph.n_qubits,
        k=graph.k, c_dst=c_dst, c_src=c_src, c_mask=c_mask, q_dst=q_dst, q_src=q_src,
        q_mask=q_mask,
        check_mask=blocks(graph.check_mask, mb), qubit_mask=blocks(graph.qubit_mask, nb),
        check_is_x=blocks(graph.check_is_x, mb), check_deg=blocks(graph.check_deg, mb),
        qubit_deg=blocks(graph.qubit_deg, nb),
        check_feat=np.asarray(graph.check_feat).reshape(n_parts, mb, -1),
        qubit_feat=np.asarray(graph.qubit_feat).reshape(n_parts, nb, -1),
        **fields)


def build_partitioned_code(family: str, distance: int, n_parts: int,
                           **kw) -> tuple[TannerGraph, PartitionedGraph]:
    """Build a code padded for an ``n_parts`` graph axis and partition it
    (``tpugnn/dist/partition.py:348-360``)."""
    from tpugnn_torch.tanner import build_code

    pad = _round_up(kw.pop("pad_nodes", 8) * n_parts, 8)
    halo = kw.pop("halo", "alltoall")
    halo_dtype = kw.pop("halo_dtype", "float32")
    graph = build_code(family, distance, pad_nodes=pad, **kw)
    return graph, partition_graph(graph, n_parts, halo=halo, halo_dtype=halo_dtype)

