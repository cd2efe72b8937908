"""TannerGraph: the static, padded graph of one CSS code instance.

The port's copy of ``tpugnn.tanner.graph``: the same fields, built the same
way, held as NumPy arrays.  ``TannerGraph.to(device)`` gives the same
dataclass with every array field a torch tensor on ``device``; the decode
path takes that form.

Layout (checks are X-type rows first, then Z-type):

* static padded shapes, with the last check, qubit and edge always a masked
  dump slot;
* canonical COO sorted by (check, qubit), CSR row pointers both ways;
* ELL slot tables ``ell_check_edge`` [m_pad, Dc] and ``ell_qubit_edge``
  [n_pad, Dq] of canonical edge ids with 0/1 masks (the fused rounds gather
  through them);
* fixed random +-1 node-identity features, dense syndrome operators,
  logical operators and pure-error tables for Monte-Carlo evaluation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from tpugnn_torch.utils import f2

__all__ = ["TannerGraph", "build_tanner_graph", "POS_F"]

POS_F = 8  # width of the static random node-identity features

_STATIC = ("name", "n_checks", "n_qubits", "n_edges", "n_checks_x",
           "n_checks_pad", "n_qubits_pad", "n_edges_pad", "k",
           "deg_max_check", "deg_max_qubit")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class TannerGraph:
    """Padded Tanner graph; array fields are NumPy arrays or, after
    :meth:`to`, torch tensors on one device."""

    name: str
    n_checks: int
    n_qubits: int
    n_edges: int
    n_checks_x: int
    n_checks_pad: int
    n_qubits_pad: int
    n_edges_pad: int
    k: int
    deg_max_check: int
    deg_max_qubit: int

    edge_check: object      # i32[E_pad]; padded edges -> n_checks_pad - 1
    edge_qubit: object      # i32[E_pad]; padded edges -> n_qubits_pad - 1
    edge_mask: object       # f32[E_pad]
    check_rowptr: object    # i32[m_pad + 1]
    check_deg: object       # f32[m_pad] (clamped to >= 1)
    qubit_perm: object      # i32[E_pad]
    qubit_rowptr: object    # i32[n_pad + 1]
    qubit_deg: object       # f32[n_pad]
    ell_check_edge: object  # i32[m_pad, Dc]; sentinel E_pad - 1
    ell_check_mask: object  # f32[m_pad, Dc]
    ell_qubit_edge: object  # i32[n_pad, Dq]
    ell_qubit_mask: object  # f32[n_pad, Dq]
    check_mask: object      # f32[m_pad]
    qubit_mask: object      # f32[n_pad]
    check_feat: object      # f32[m_pad, POS_F]
    qubit_feat: object      # f32[n_pad, POS_F]
    h_syn_ez: object        # f32[m_pad, n_pad]; X-type rows: s = Hx @ ez
    h_syn_ex: object        # f32[m_pad, n_pad]; Z-type rows: s = Hz @ ex
    check_is_x: object      # f32[m_pad]
    logicals_x: object      # f32[k, n_pad]
    logicals_z: object      # f32[k, n_pad]
    pure_ex: object         # f32[n_pad, m_pad]
    pure_ez: object         # f32[n_pad, m_pad]
    # None: depolarizing sampling at uniform rate p.  f32[n_pad]:
    # single-sector bit-flip sampling at rate p * rate_scale[q] (spacetime
    # detector graphs, whose "qubits" are fault locations with distinct
    # data and measurement rates)
    rate_scale: object = None

    @property
    def h_inc(self):
        """f32[m_pad, n_pad] 0/1 incidence."""
        return self.h_syn_ez + self.h_syn_ex

    @classmethod
    def array_fields(cls) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls)
                     if f.name not in _STATIC)

    def to(self, device) -> "TannerGraph":
        """The same graph with every array field a tensor on ``device``."""
        import torch

        def conv(v):
            if v is None:
                return None
            return torch.as_tensor(np.asarray(v), device=device)

        return dataclasses.replace(
            self, **{f: conv(getattr(self, f)) for f in self.array_fields()})


def build_tanner_graph(
    hx: np.ndarray,
    hz: np.ndarray,
    *,
    name: str,
    pad_nodes: int = 8,
    pad_edges: int = 128,
    logicals: tuple[np.ndarray, np.ndarray] | None = None,
    rate_scale: np.ndarray | None = None,
) -> TannerGraph:
    """Build the padded graph from a CSS pair ``hx`` [mx, n], ``hz`` [mz, n].

    ``logicals=(lx, lz)`` replaces the derived logical operators (detector
    graphs: the base code's logicals lifted over the fault locations);
    ``rate_scale`` [n] attaches per-qubit noise-rate multipliers
    (``TannerGraph.rate_scale``).
    """
    hx = np.asarray(hx, dtype=np.uint8).reshape(-1, hx.shape[-1]) if hx.size else np.zeros((0, hz.shape[-1]), np.uint8)
    hz = np.asarray(hz, dtype=np.uint8).reshape(-1, hz.shape[-1]) if hz.size else np.zeros((0, hx.shape[-1]), np.uint8)
    mx, n = hx.shape
    mz = hz.shape[0]
    m = mx + mz
    h = np.vstack([hx, hz])

    if mx and mz and ((hx @ hz.T) % 2).any():
        raise ValueError(f"{name}: Hx Hz^T != 0, not CSS")

    if logicals is not None:
        lx, lz = (np.asarray(v, np.uint8) for v in logicals)
        if lx.shape != lz.shape or lx.shape[1] != n:
            raise ValueError(f"{name}: logicals of shapes {lx.shape}, {lz.shape} "
                             f"for {n} qubits")
    else:
        lx, lz = f2.css_logicals(hx, hz)
    k = lx.shape[0]
    t_ez = f2.solve_right_inverse(hx)
    t_ex = f2.solve_right_inverse(hz)

    cc, qq = np.nonzero(h)
    order = np.lexsort((qq, cc))
    cc, qq = cc[order].astype(np.int32), qq[order].astype(np.int32)
    e = cc.shape[0]

    m_pad = _round_up(m + 1, pad_nodes)
    n_pad = _round_up(n + 1, pad_nodes)
    e_pad = _round_up(e + 1, pad_edges)

    edge_check = np.full(e_pad, m_pad - 1, np.int32)
    edge_qubit = np.full(e_pad, n_pad - 1, np.int32)
    edge_mask = np.zeros(e_pad, np.float32)
    edge_check[:e], edge_qubit[:e], edge_mask[:e] = cc, qq, 1.0

    check_deg = np.bincount(edge_check, minlength=m_pad).astype(np.int64)
    check_rowptr = np.zeros(m_pad + 1, np.int32)
    check_rowptr[1:] = np.cumsum(check_deg).astype(np.int32)

    qorder = np.lexsort((edge_check, edge_qubit)).astype(np.int32)
    qubit_deg = np.bincount(edge_qubit, minlength=n_pad).astype(np.int64)
    qubit_rowptr = np.zeros(n_pad + 1, np.int32)
    qubit_rowptr[1:] = np.cumsum(qubit_deg).astype(np.int32)

    def ell(dst, rows):
        deg = np.bincount(dst, minlength=rows)
        dmax = max(int(deg[:rows].max(initial=0)), 1)
        tbl = np.full((rows, dmax), e_pad - 1, np.int32)
        msk = np.zeros((rows, dmax), np.float32)
        fill = np.zeros(rows, np.int64)
        for eid, r in enumerate(dst):
            tbl[r, fill[r]] = eid
            msk[r, fill[r]] = 1.0
            fill[r] += 1
        return tbl, msk, dmax

    ell_c_edge, ell_c_mask, dc = ell(cc, m_pad)
    ell_q_edge, ell_q_mask, dq = ell(qq, n_pad)

    h_pad = np.zeros((m_pad, n_pad), np.float32)
    h_pad[:m, :n] = h
    is_x = np.zeros(m_pad, np.float32)
    is_x[:mx] = 1.0
    h_syn_ez = h_pad * is_x[:, None]
    h_syn_ex = h_pad * (1.0 - is_x)[:, None]
    h_syn_ex[m:] = 0.0

    lx_pad = np.zeros((k, n_pad), np.float32)
    lz_pad = np.zeros((k, n_pad), np.float32)
    lx_pad[:, :n], lz_pad[:, :n] = lx, lz

    pure_ez = np.zeros((n_pad, m_pad), np.float32)
    pure_ex = np.zeros((n_pad, m_pad), np.float32)
    pure_ez[:n, :mx] = t_ez
    pure_ex[:n, mx:m] = t_ex

    real_c = (np.arange(m_pad) < m)
    real_q = (np.arange(n_pad) < n)
    return TannerGraph(
        name=name,
        n_checks=m, n_qubits=n, n_edges=e, n_checks_x=mx,
        n_checks_pad=m_pad, n_qubits_pad=n_pad, n_edges_pad=e_pad, k=k,
        deg_max_check=dc, deg_max_qubit=dq,
        edge_check=edge_check,
        edge_qubit=edge_qubit,
        edge_mask=edge_mask,
        check_rowptr=check_rowptr,
        check_deg=np.maximum(check_deg, 1).astype(np.float32),
        qubit_perm=qorder,
        qubit_rowptr=qubit_rowptr,
        qubit_deg=np.maximum(qubit_deg, 1).astype(np.float32),
        ell_check_edge=ell_c_edge,
        ell_check_mask=ell_c_mask,
        ell_qubit_edge=ell_q_edge,
        ell_qubit_mask=ell_q_mask,
        check_mask=real_c.astype(np.float32),
        qubit_mask=real_q.astype(np.float32),
        check_feat=((np.random.default_rng(12345).integers(0, 2, (m_pad, POS_F)) * 2.0 - 1.0)
                    * real_c[:, None]).astype(np.float32),
        qubit_feat=((np.random.default_rng(54321).integers(0, 2, (n_pad, POS_F)) * 2.0 - 1.0)
                    * real_q[:, None]).astype(np.float32),
        h_syn_ez=h_syn_ez,
        h_syn_ex=h_syn_ex,
        check_is_x=is_x,
        logicals_x=lx_pad,
        logicals_z=lz_pad,
        pure_ex=pure_ex,
        pure_ez=pure_ez,
        rate_scale=(None if rate_scale is None
                    else np.pad(np.asarray(rate_scale, np.float32), (0, n_pad - n))),
    )
