"""Toric code of distance d (the port's copy of ``tpugnn.tanner.toric``):
2 d^2 data qubits on the edges of a periodic d x d lattice, d^2 vertex
(X-type) and d^2 plaquette (Z-type) stabilizers, k = 2."""

from __future__ import annotations

import numpy as np

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph

__all__ = ["toric_code_checks", "build_toric_code"]


def toric_code_checks(d: int) -> tuple[np.ndarray, np.ndarray]:
    """Parity-check matrices (hx, hz) of the d x d toric code.

    Qubit indexing: horizontal edge at (r, c) -> r*d + c; vertical edge at
    (r, c) -> d*d + r*d + c (all coordinates mod d).
    """
    if d < 2:
        raise ValueError("toric code needs d >= 2")
    n = 2 * d * d

    def hq(r: int, c: int) -> int:
        return (r % d) * d + (c % d)

    def vq(r: int, c: int) -> int:
        return d * d + (r % d) * d + (c % d)

    hx = np.zeros((d * d, n), np.uint8)  # vertex stabilizers
    hz = np.zeros((d * d, n), np.uint8)  # plaquette stabilizers
    for r in range(d):
        for c in range(d):
            v = r * d + c
            hx[v, hq(r, c)] ^= 1
            hx[v, hq(r, c - 1)] ^= 1
            hx[v, vq(r, c)] ^= 1
            hx[v, vq(r - 1, c)] ^= 1
            hz[v, hq(r, c)] ^= 1
            hz[v, hq(r + 1, c)] ^= 1
            hz[v, vq(r, c)] ^= 1
            hz[v, vq(r, c + 1)] ^= 1
    return hx, hz


def build_toric_code(d: int, *, pad_nodes: int = 8, pad_edges: int = 128) -> TannerGraph:
    hx, hz = toric_code_checks(d)
    g = build_tanner_graph(hx, hz, name=f"toric_d{d}",
                           pad_nodes=pad_nodes, pad_edges=pad_edges)
    if g.k != 2:
        raise AssertionError(f"toric code must encode k=2, got {g.k}")
    return g
