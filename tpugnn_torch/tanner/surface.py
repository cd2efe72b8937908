"""Rotated surface code of distance d (the port's copy of
``tpugnn.tanner.surface``): d*d data qubits, d^2 - 1 stabilizers, k = 1."""

from __future__ import annotations

import numpy as np

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph

__all__ = ["surface_code_checks", "build_surface_code"]


def surface_code_checks(d: int) -> tuple[np.ndarray, np.ndarray]:
    """Parity-check matrices (hx, hz) of the rotated surface code."""
    if d < 2:
        raise ValueError("surface code needs d >= 2")
    n = d * d

    def qid(r: int, c: int) -> int:
        return r * d + c

    hx_rows: list[np.ndarray] = []
    hz_rows: list[np.ndarray] = []
    # plaquette (i, j) covers data qubits (i-1..i) x (j-1..j)
    for i in range(d + 1):
        for j in range(d + 1):
            qs = [qid(r, c) for r in (i - 1, i) for c in (j - 1, j)
                  if 0 <= r < d and 0 <= c < d]
            if len(qs) < 2:
                continue  # corners
            is_x = (i + j) % 2 == 0
            if len(qs) == 2:
                # boundary: top/bottom keep X-type only; left/right Z-type
                on_tb = i == 0 or i == d
                if on_tb != is_x:
                    continue
            row = np.zeros(n, np.uint8)
            row[qs] = 1
            (hx_rows if is_x else hz_rows).append(row)

    hx = np.array(hx_rows, np.uint8)
    hz = np.array(hz_rows, np.uint8)
    if hx.shape[0] + hz.shape[0] != n - 1:
        raise AssertionError(f"d={d}: got {hx.shape[0]}+{hz.shape[0]} stabilizers")
    return hx, hz


def build_surface_code(d: int, *, pad_nodes: int = 8,
                       pad_edges: int = 128) -> TannerGraph:
    hx, hz = surface_code_checks(d)
    g = build_tanner_graph(hx, hz, name=f"surface_d{d}",
                           pad_nodes=pad_nodes, pad_edges=pad_edges)
    if g.k != 1:
        raise AssertionError(f"surface code must encode k=1, got {g.k}")
    return g
