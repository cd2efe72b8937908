"""Exact minimum-weight perfect-matching (MWPM) baseline decoder.

The port's copy of ``tpugnn.baselines.mwpm``: NumPy on the host, with the
blossom core of ``csrc/mwpm.cpp`` loaded through ``tpugnn_torch.utils.native``.

The reference's canonical classical comparison is MWPM [SURVEY.md §2.1 C6
"typically compared against MWPM"; §1 L4 "MWPM/baseline comparison"].  Like
the union-find baseline this decodes per CSS sector on the decoding graph
(vertices = checks of one sector, edges = data qubits, weight-1 qubits =
open-boundary edges), but instead of cluster growth it solves the matching
problem exactly:

  1. host-side, once per graph: geodesic distances + shortest-path trees
     between all decoding-graph vertices (Dijkstra; the virtual boundary is
     an extra vertex reached through boundary edges);
  2. per shot: defects (flipped checks) are paired by minimum-weight
     perfect matching — each defect also gets a virtual boundary partner so
     odd clusters can terminate on the boundary — via the O(V^3) blossom
     core in csrc/mwpm.cpp;
  3. matched pairs XOR their geodesic's edges into the correction.

Non-uniform priors are supported through per-edge weights (e.g.
log((1-p)/p) from a noise model); default is the uniform unit weight.

A pure-Python twin (networkx blossom over the identical instance) runs only
when a caller asks for it (``force_python=True``) and cross-checks the
native core in the tests; networkx is imported inside it, so the decoder
runs where networkx is not installed.
"""

from __future__ import annotations

import heapq

import numpy as np

from tpugnn_torch.baselines.union_find import _sector_edges
from tpugnn_torch.tanner.graph import TannerGraph

__all__ = ["MWPMSectorDecoder", "MWPMDecoder"]

_SCALE = 1 << 16          # fixed-point scale for float edge weights
_INF = np.int64(1) << 62  # unreachable sentinel (int64 fixed-point)


def _geodesics(
    eu: np.ndarray, ev: np.ndarray, nv: int, weights: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """All-sources Dijkstra over the decoding graph plus virtual boundary.

    Returns (dist, par_v, par_e), each [(nv+1), (nv+1)]: fixed-point
    geodesic costs, and the predecessor vertex/edge of column t in the
    shortest-path tree rooted at row u.  Vertex ``nv`` is the boundary.
    """
    stride = nv + 1
    adj: list[list[tuple[int, int, int]]] = [[] for _ in range(stride)]
    has_boundary = False
    for e in range(len(eu)):
        u = int(eu[e])
        if u < 0:
            continue  # qubit untouched by this sector: never in a path
        v = int(ev[e]) if ev[e] >= 0 else nv
        w = int(round(float(weights[e]) * _SCALE))
        if w <= 0:
            raise ValueError(f"edge {e}: MWPM weights must be positive")
        if v == nv:
            has_boundary = True
        adj[u].append((v, w, e))
        adj[v].append((u, w, e))

    dist = np.full((stride, stride), _INF, np.int64)
    par_v = np.full((stride, stride), -1, np.int32)
    par_e = np.full((stride, stride), -1, np.int32)
    for s in range(stride):
        d = dist[s]
        d[s] = 0
        heap = [(0, s)]
        while heap:
            du, u = heapq.heappop(heap)
            if du > d[u]:
                continue
            for v, w, e in adj[u]:
                nd = du + w
                if nd < d[v]:
                    d[v] = nd
                    par_v[s, v] = u
                    par_e[s, v] = e
                    heapq.heappush(heap, (nd, v))
    return dist, par_v, par_e, has_boundary


class MWPMSectorDecoder:
    """Exact MWPM on one decoding graph (one CSS sector / detector graph).

    eu, ev: per-edge endpoint vertices (ev = -1 for boundary edges), as
    produced by the union-find baseline's graph extraction; ``weights``
    optionally gives per-edge costs (default 1).
    """

    def __init__(
        self,
        eu: np.ndarray,
        ev: np.ndarray,
        n_verts: int,
        *,
        weights: np.ndarray | None = None,
        force_python: bool = False,
    ):
        self.eu = np.ascontiguousarray(np.asarray(eu, np.int32))
        self.ev = np.ascontiguousarray(np.asarray(ev, np.int32))
        self.nv = int(n_verts)
        self.n_edges = len(self.eu)
        w = np.ones(self.n_edges) if weights is None else np.asarray(weights, float)
        if w.shape != (self.n_edges,):
            raise ValueError("weights must be one per decoding-graph edge")
        self.dist, self.par_v, self.par_e, self.has_boundary = _geodesics(
            self.eu, self.ev, self.nv, w
        )
        self._lib = None
        if not force_python:
            from tpugnn_torch.utils.native import load

            self._lib = load()

    def decode(self, syndromes: np.ndarray) -> np.ndarray:
        """[batch, nv] uint8 defects -> [batch, n_edges] uint8 corrections."""
        syn = np.ascontiguousarray(np.asarray(syndromes, np.uint8))
        if syn.ndim != 2 or syn.shape[1] != self.nv:
            raise ValueError(f"syndromes must be [batch, {self.nv}]")
        out = np.zeros((syn.shape[0], self.n_edges), np.uint8)
        if self.nv == 0 or syn.shape[0] == 0:
            return out
        if self._lib is not None:
            rc = self._lib.mwpm_decode_batch(
                np.ascontiguousarray(self.dist.ravel()),
                np.ascontiguousarray(self.par_v.ravel()),
                np.ascontiguousarray(self.par_e.ravel()),
                self.nv, self.n_edges, int(self.has_boundary), int(_INF),
                syn, syn.shape[0], out,
            )
            if rc != 0:
                raise RuntimeError(f"native MWPM decode failed (rc={rc})")
            return out
        for b in range(syn.shape[0]):
            self._decode_py(syn[b], out[b])
        return out

    # --- pure-Python twin / oracle (networkx blossom) ---

    def _xor_path(self, row: np.ndarray, u: int, t: int) -> None:
        while t != u:
            e = int(self.par_e[u, t])
            if e < 0:
                raise RuntimeError("MWPM: matched pair is unreachable")
            row[e] ^= 1
            t = int(self.par_v[u, t])

    def _decode_py(self, syn: np.ndarray, row: np.ndarray) -> None:
        import networkx as nx

        defects = np.nonzero(syn)[0]
        k = len(defects)
        if k == 0:
            return
        if not self.has_boundary and k % 2:
            raise RuntimeError("odd defect count on a closed code")
        g = nx.Graph()
        costs = [
            int(self.dist[defects[i], defects[j]])
            for i in range(k) for j in range(i + 1, k)
            if self.dist[defects[i], defects[j]] < _INF
        ] + [
            int(self.dist[v, self.nv])
            for v in defects
            if self.has_boundary and self.dist[v, self.nv] < _INF
        ]
        n = 2 * k if self.has_boundary else k
        big = (max(costs) if costs else 1) * (n + 1) + 1
        for i in range(k):
            for j in range(i + 1, k):
                c = int(self.dist[defects[i], defects[j]])
                if c < _INF:
                    g.add_edge(i, j, weight=big - c)
            if self.has_boundary:
                c = int(self.dist[defects[i], self.nv])
                if c < _INF:
                    g.add_edge(i, k + i, weight=big - c)
                for j in range(i + 1, k):
                    g.add_edge(k + i, k + j, weight=big)
        mates = nx.max_weight_matching(g, maxcardinality=True)
        seen = set()
        for a, b in mates:
            seen.update((a, b))
            i, j = min(a, b), max(a, b)
            if j < k:
                self._xor_path(row, int(defects[i]), int(defects[j]))
            elif i < k:
                self._xor_path(row, int(defects[i]), self.nv)
        if len(seen) != n:
            raise RuntimeError("MWPM: no perfect matching on defect graph")


def _llr_weights(graph: TannerGraph, p: float | None) -> np.ndarray | None:
    """Per-fault log-likelihood matching weights from the graph's noise
    model: w_e = log((1-p_e)/p_e) with p_e = p * rate_scale[e].  None (the
    uniform unit weight) when the graph has no rate metadata or no physical
    rate is given — for uniform rates the constant factor cannot change the
    matching."""
    if p is None or graph.rate_scale is None:
        return None
    pe = p * np.asarray(graph.rate_scale)[: graph.n_qubits].astype(float)
    pe = np.clip(pe, 1e-9, 0.499)  # keep weights finite and positive
    return np.log((1.0 - pe) / pe)


class MWPMDecoder:
    """Batched two-sector exact MWPM decoder over a TannerGraph.

    Drop-in alternative to UnionFindDecoder: ``decode(syndrome)`` returns
    (ex_hat, ez_hat).  X errors are matched on the Z-check sector and vice
    versa.  When the graph carries per-fault rates (spacetime/circuit
    detector graphs) and a physical rate ``p`` is given, geodesics use
    log-likelihood weights instead of hop counts.
    """

    def __init__(self, graph: TannerGraph, *, p: float | None = None,
                 force_python: bool = False):
        self.graph = graph
        mx = graph.n_checks_x
        m, n = graph.n_checks, graph.n_qubits
        hx = np.asarray(graph.h_syn_ez)[:mx, :n].astype(np.uint8)   # X-type rows
        hz = np.asarray(graph.h_syn_ex)[mx:m, :n].astype(np.uint8)  # Z-type rows
        x_eu, x_ev = _sector_edges(hz)
        z_eu, z_ev = _sector_edges(hx)
        w = _llr_weights(graph, p)
        self._x = MWPMSectorDecoder(x_eu, x_ev, hz.shape[0], weights=w,
                                    force_python=force_python)
        self._z = MWPMSectorDecoder(z_eu, z_ev, hx.shape[0], weights=w,
                                    force_python=force_python)
        self._mx = mx

    def decode(self, syndrome: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """syndrome: [B, m_pad] (host) -> (ex_hat, ez_hat) uint8 [B, n]."""
        s = np.asarray(syndrome)[:, : self.graph.n_checks]
        s_x, s_z = s[:, : self._mx], s[:, self._mx:]
        ex = self._x.decode(s_z)
        ez = self._z.decode(s_x)
        return ex, ez
