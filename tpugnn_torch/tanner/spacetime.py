"""Spacetime (phenomenological-noise) detector graphs of one CSS sector.

The port's copy of ``tpugnn.tanner.spacetime``.  Stabilizers are measured
``d_t`` times and each measurement flips with its own probability; one
sector is decoded from detection events, the differences of consecutive
noisy syndromes (the last round perfect)::

    s_hat_t = H (sum_{tau<=t} e_tau) XOR m_t,      m_{d_t-1} = 0
    D_0 = s_hat_0,  D_t = s_hat_t XOR s_hat_{t-1} = H e_t XOR m_t XOR m_{t-1}

which is a linear code over fault locations::

    H' [m d_t, n d_t + m (d_t - 1)]
    data fault (q, tau)  -> detectors (c, tau) for c in supp(H[:, q])
    meas fault (c, tau)  -> detectors (c, tau), (c, tau + 1)

The detector graph is a single-sector ``TannerGraph`` (faults are its
qubits, detectors its Z-type checks, no X-type check), so the decoder, the
fused rounds, the LER harness and the classical baselines run on it as on a
code graph.  Two things are injected: the physical logicals (the base code's
logicals of the opposite type lifted over the data-fault blocks: failure
depends on the net data error) and the per-location rates (data faults at
p, measurement faults at p * meas_ratio, round-0 data faults at p *
t0_scale).
"""

from __future__ import annotations

import numpy as np

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph
from tpugnn_torch.utils import f2

__all__ = ["spacetime_matrix", "build_spacetime_code", "sector_checks"]


def sector_checks(family: str, distance: int) -> tuple[np.ndarray, np.ndarray]:
    """``(hx, hz)`` uint8 of a ported code family."""
    from tpugnn_torch.tanner import repetition, steane, surface, toric

    checks = {
        "surface": surface.surface_code_checks,
        "toric": toric.toric_code_checks,
        "repetition": repetition.repetition_code_checks,
        "steane": steane.steane_code_checks,
    }
    if family not in checks:
        raise ValueError(f"unknown or unported code family {family!r}; "
                         f"ported: {sorted(checks)}")
    hx, hz = checks[family](distance)
    return np.asarray(hx, np.uint8), np.asarray(hz, np.uint8)


def spacetime_matrix(h: np.ndarray, d_t: int) -> np.ndarray:
    """Detector parity-check matrix H' over fault locations of one sector."""
    h = np.asarray(h, np.uint8)
    m, n = h.shape
    if d_t < 1:
        raise ValueError("need d_t >= 1 measurement rounds")
    hp = np.zeros((m * d_t, n * d_t + m * (d_t - 1)), np.uint8)
    for t in range(d_t):
        hp[t * m:(t + 1) * m, t * n:(t + 1) * n] = h
    for t in range(d_t - 1):   # measurement fault (c, t): detectors t and t+1
        cols = n * d_t + t * m + np.arange(m)
        hp[t * m + np.arange(m), cols] ^= 1
        hp[(t + 1) * m + np.arange(m), cols] ^= 1
    return hp


def build_spacetime_code(family: str, distance: int, d_t: int, *, sector: str = "z",
                         meas_ratio: float = 1.0, t0_scale: float = 1.0,
                         pad_nodes: int = 8, pad_edges: int = 128) -> TannerGraph:
    """Detector graph of ``d_t`` noisy syndrome rounds of one sector.

    ``sector='z'`` decodes X-type data faults through the Z-type
    stabilizers (``'x'`` the converse).  ``meas_ratio`` scales the
    measurement-fault rate and ``t0_scale`` the round-0 data-fault rate
    against p (a window of a stream sees what earlier windows left as
    round-0 faults); neither changes the graph's structure.
    """
    hx, hz = sector_checks(family, distance)
    if sector == "z":
        h = hz
    elif sector == "x":
        h = hx
    else:
        raise ValueError("sector must be 'x' or 'z'")
    if h.shape[0] == 0:
        raise ValueError(f"{family} has no {sector}-type stabilizers")
    m, n = h.shape
    hp = spacetime_matrix(h, d_t)
    n_faults = hp.shape[1]

    # X faults (sector z) pair with the base code's Z logicals, and back
    base_lx, base_lz = f2.css_logicals(hx, hz)
    base = base_lz if sector == "z" else base_lx
    lifted = np.zeros((base.shape[0], n_faults), np.uint8)
    for t in range(d_t):
        lifted[:, t * n:(t + 1) * n] = base
    # faults are 'ex' errors seen by Z-type rows: class bit <lz, ex XOR ex0>,
    # so logicals_z is the lifted operator; logicals_x a zero partner
    logicals = (np.zeros_like(lifted), lifted)

    rate_scale = np.ones(n_faults, np.float32)
    rate_scale[n * d_t:] = meas_ratio
    rate_scale[:n] = t0_scale

    return build_tanner_graph(
        np.zeros((0, n_faults), np.uint8), hp,
        name=f"{family}_d{distance}_t{d_t}_{sector}",
        pad_nodes=pad_nodes, pad_edges=pad_edges,
        logicals=logicals, rate_scale=rate_scale)
