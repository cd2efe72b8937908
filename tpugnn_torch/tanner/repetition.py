"""Repetition code (the port's copy of ``tpugnn.tanner.repetition``): d
qubits, d-1 adjacent ZZ checks, so only X errors are detectable."""

from __future__ import annotations

import numpy as np

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph

__all__ = ["repetition_code_checks", "build_repetition_code"]


def repetition_code_checks(d: int) -> tuple[np.ndarray, np.ndarray]:
    if d < 2:
        raise ValueError("repetition code needs d >= 2")
    hx = np.zeros((0, d), np.uint8)
    hz = np.zeros((d - 1, d), np.uint8)
    for i in range(d - 1):
        hz[i, i] = hz[i, i + 1] = 1
    return hx, hz


def build_repetition_code(d: int, *, pad_nodes: int = 8,
                          pad_edges: int = 128) -> TannerGraph:
    hx, hz = repetition_code_checks(d)
    g = build_tanner_graph(hx, hz, name=f"repetition_d{d}",
                           pad_nodes=pad_nodes, pad_edges=pad_edges)
    if g.k != 1:
        raise AssertionError(f"repetition code must encode k=1, got {g.k}")
    return g
