"""Union-find baseline decoder (the reference's classical-matching baseline).

The port's copy of ``tpugnn.baselines.union_find``: NumPy on the host, over
the port's NumPy ``TannerGraph``, with the C++ batch decoder of
``csrc/unionfind.cpp`` loaded through ``tpugnn_torch.utils.native``.

The reference evaluates its GNN against a classical decoder [SURVEY.md §1 L4
"MWPM/baseline comparison"]; union-find (Delfosse-Nickerson) is the standard
near-MWPM baseline with almost-linear runtime.  Decoding happens per CSS
sector on the *decoding graph*: vertices = checks of that sector, edges =
data qubits (each touches <= 2 same-type checks for surface/toric codes;
weight-1 qubits become boundary edges).

The batched hot loop runs in C++ (csrc/unionfind.cpp via ctypes); the
pure-Python implementation of the same algorithm runs only when a caller asks
for it (``force_python=True``) and is the cross-check oracle of the tests.
"""

from __future__ import annotations

import numpy as np

from tpugnn_torch.tanner.graph import TannerGraph

__all__ = ["UnionFindDecoder", "uf_decode_py"]


def _sector_edges(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decoding-graph edges for one sector: qubit q -> (check_u, check_v|-1)."""
    m, n = h.shape
    eu = np.full(n, -1, np.int32)
    ev = np.full(n, -1, np.int32)
    for q in range(n):
        cs = np.nonzero(h[:, q])[0]
        if len(cs) > 2:
            raise ValueError(
                f"qubit {q} touches {len(cs)} same-type checks; union-find "
                "baseline requires a matchable (degree <= 2) code"
            )
        if len(cs) >= 1:
            eu[q] = cs[0]
        if len(cs) == 2:
            ev[q] = cs[1]
    return eu, ev


class _DSU:
    def __init__(self, n: int):
        self.p = list(range(n))
        self.r = [0] * n
        self.parity = [0] * n
        self.boundary = [False] * n

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def unite(self, a: int, b: int) -> None:
        a, b = self.find(a), self.find(b)
        if a == b:
            return
        if self.r[a] < self.r[b]:
            a, b = b, a
        self.p[b] = a
        self.parity[a] ^= self.parity[b]
        self.boundary[a] |= self.boundary[b]
        if self.r[a] == self.r[b]:
            self.r[a] += 1

    def odd(self, x: int) -> bool:
        r = self.find(x)
        return bool(self.parity[r]) and not self.boundary[r]


def uf_decode_py(eu: np.ndarray, ev: np.ndarray, n_verts: int, syndrome: np.ndarray) -> np.ndarray:
    """Pure-Python union-find decode of one syndrome (reference algorithm).

    Smallest-cluster-first HALF-edge growth (Delfosse-Nickerson): each step
    grows the smallest odd cluster's boundary edges by half an edge; an edge
    joins once its growth reaches 2.  Full-edge all-clusters growth loses
    the sub-threshold scaling on 3-D spacetime detector graphs.
    """
    E = len(eu)
    cor = np.zeros(E, np.uint8)
    dsu = _DSU(n_verts)
    defect = [int(b) for b in syndrome]
    for v in range(n_verts):
        dsu.parity[v] = defect[v]

    adj: list[list[int]] = [[] for _ in range(n_verts)]
    for e in range(E):
        if eu[e] >= 0:
            adj[int(eu[e])].append(e)
            if ev[e] >= 0:
                adj[int(ev[e])].append(e)
    members = {v: [v] for v in range(n_verts)}
    growth = np.zeros(E, np.int8)
    grown = np.zeros(E, bool)
    guard = 0
    while True:
        odd = [v for v in range(n_verts)
               if dsu.p[v] == v and dsu.parity[v] and not dsu.boundary[v]]
        if not odd:
            break
        guard += 1
        if guard > 4 * E + 2 * n_verts + 4:
            raise RuntimeError("union-find growth failed to converge")
        r = min(odd, key=lambda x: len(members[x]))
        newly = []
        for v in members[r]:
            for e in adj[v]:
                if grown[e]:
                    continue
                growth[e] += 1
                if growth[e] >= 2:
                    grown[e] = True
                    newly.append(e)
        for e in newly:
            u, v = int(eu[e]), int(ev[e])
            if v >= 0:
                ru, rv = dsu.find(u), dsu.find(v)
                if ru != rv:
                    mu, mv = members.pop(ru), members.pop(rv)
                    dsu.unite(u, v)
                    members[dsu.find(u)] = mu + mv
            else:
                dsu.boundary[dsu.find(u)] = True

    # spanning forest (virtual boundary vertex = n_verts)
    forest = _DSU(n_verts + 1)
    in_forest = np.zeros(E, bool)
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n_verts)]
    deg = np.zeros(n_verts, np.int64)
    for e in range(E):
        if not grown[e]:
            continue
        u = int(eu[e])
        v = int(ev[e]) if ev[e] >= 0 else n_verts
        if forest.find(u) == forest.find(v):
            continue
        forest.unite(u, v)
        in_forest[e] = True
        adj[u].append((e, int(ev[e])))
        if ev[e] >= 0:
            adj[int(ev[e])].append((e, u))
        deg[u] += 1
        if ev[e] >= 0:
            deg[int(ev[e])] += 1

    stack = [v for v in range(n_verts) if deg[v] == 1]
    while stack:
        leaf = stack.pop()
        if deg[leaf] != 1:
            continue
        edge, other = -1, -2
        for e, o in adj[leaf]:
            if in_forest[e]:
                edge, other = e, o
                break
        if edge < 0:
            continue
        in_forest[edge] = False
        deg[leaf] -= 1
        if other >= 0:
            deg[other] -= 1
        if defect[leaf]:
            cor[edge] = 1
            defect[leaf] = 0
            if other >= 0:
                defect[other] ^= 1
        if other >= 0 and deg[other] == 1:
            stack.append(other)
    return cor


class UnionFindDecoder:
    """Batched two-sector union-find decoder over a TannerGraph."""

    def __init__(self, graph: TannerGraph, *, force_python: bool = False):
        """``graph``: the NumPy graph (not ``TannerGraph.to``'s tensors).
        The C++ library is built or loaded here and raises if it cannot be;
        ``force_python`` runs the Python twin instead."""
        self.graph = graph
        mx = graph.n_checks_x
        m, n = graph.n_checks, graph.n_qubits
        hx = np.asarray(graph.h_syn_ez)[:mx, :n].astype(np.uint8)   # X-type rows
        hz = np.asarray(graph.h_syn_ex)[mx:m, :n].astype(np.uint8)  # Z-type rows
        # X errors flip Z-type checks; Z errors flip X-type checks
        self._x_eu, self._x_ev = _sector_edges(hz)
        self._x_nv = hz.shape[0]
        self._z_eu, self._z_ev = _sector_edges(hx)
        self._z_nv = hx.shape[0]
        self._mx = mx
        self._lib = None
        if not force_python:
            from tpugnn_torch.utils.native import load

            self._lib = load()

    def _decode_sector(self, eu, ev, nv, syndromes: np.ndarray) -> np.ndarray:
        batch = syndromes.shape[0]
        syn = np.ascontiguousarray(syndromes.astype(np.uint8))
        out = np.zeros((batch, len(eu)), np.uint8)
        if self._lib is not None and nv > 0:
            rc = self._lib.uf_decode_batch(
                np.ascontiguousarray(eu), np.ascontiguousarray(ev),
                len(eu), nv, syn, batch, out,
            )
            if rc != 0:
                raise RuntimeError("native union-find decode failed")
            return out
        for b in range(batch):
            if nv > 0:
                out[b] = uf_decode_py(eu, ev, nv, syn[b])
        return out

    def decode(self, syndrome: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """syndrome: [B, m_pad] (host) -> (ex_hat, ez_hat) uint8 [B, n]."""
        s = np.asarray(syndrome)[:, : self.graph.n_checks]
        s_x, s_z = s[:, : self._mx], s[:, self._mx :]
        ex = self._decode_sector(self._x_eu, self._x_ev, self._x_nv, s_z)
        ez = self._decode_sector(self._z_eu, self._z_ev, self._z_nv, s_x)
        return ex, ez
