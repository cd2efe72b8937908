"""Steane code [[7,1,3]] (the port's copy of ``tpugnn.tanner.steane``): the
self-dual CSS code of the Hamming(7,4) parity checks."""

from __future__ import annotations

import numpy as np

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph

__all__ = ["steane_code_checks", "build_steane_code"]


def steane_code_checks(d: int = 3) -> tuple[np.ndarray, np.ndarray]:
    if d != 3:
        raise ValueError("the Steane family is the d=3 triangular color code")
    h = np.array([[1, 1, 1, 0, 1, 0, 0],
                  [1, 1, 0, 1, 0, 1, 0],
                  [1, 0, 1, 1, 0, 0, 1]], np.uint8)
    return h.copy(), h.copy()


def build_steane_code(d: int = 3, *, pad_nodes: int = 8,
                      pad_edges: int = 128) -> TannerGraph:
    hx, hz = steane_code_checks(d)
    g = build_tanner_graph(hx, hz, name="steane", pad_nodes=pad_nodes,
                           pad_edges=pad_edges)
    if g.k != 1:
        raise AssertionError(f"Steane code must encode k=1, got {g.k}")
    return g
