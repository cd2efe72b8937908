"""Syndrome sampling: depolarizing noise and parity extraction on a device.

The port's copy of ``tpugnn.sampling.noise``.  Random numbers come from an
explicit ``torch.Generator`` on the graph's device, so a run is reproducible
from its seed; they are not JAX's threefry bits, so the two packages agree in
distribution, and exactly on the same given errors.  Mod-2 arithmetic is f32
matmuls of 0/1 values followed by ``% 2`` (exact at these magnitudes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpugnn_torch.tanner.graph import TannerGraph

__all__ = ["SyndromeBatch", "sample_depolarizing", "sample_batch", "syndrome",
           "logical_class_bits", "training_rate"]


class SyndromeBatch(NamedTuple):
    """One batch of decoding episodes (tensors on the graph's device).

    ex, ez:     f32[B, n_pad] symplectic error components
    syndrome:   f32[B, m_pad] stabilizer parities in {0, 1}
    class_bits: f32[B, 2k] logical class relative to the pure error T @ s
    """

    ex: torch.Tensor
    ez: torch.Tensor
    syndrome: torch.Tensor
    class_bits: torch.Tensor


def sample_depolarizing(generator: torch.Generator, graph: TannerGraph,
                        p, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """i.i.d. depolarizing noise at rate p on the real data qubits.

    One uniform draw u per qubit: u < p/3 -> X, p/3 <= u < 2p/3 -> Y,
    2p/3 <= u < p -> Z.  ``p`` is a float, or a [B, 1] tensor of per-shot
    rates.  ``graph`` holds tensors (``TannerGraph.to``) on the generator's
    device.
    """
    qm = graph.qubit_mask
    u = torch.rand((batch, graph.n_qubits_pad), generator=generator,
                   device=qm.device, dtype=torch.float32)
    ex = (u < 2.0 * p / 3.0).float()
    ez = ((u >= p / 3.0) & (u < p)).float()
    return ex * qm, ez * qm


def syndrome(graph: TannerGraph, ex: torch.Tensor, ez: torch.Tensor) -> torch.Tensor:
    """Stabilizer syndrome s in {0,1}^[..., m_pad]."""
    acc = ez @ graph.h_syn_ez.T + ex @ graph.h_syn_ex.T
    return torch.remainder(acc, 2.0)


def logical_class_bits(graph: TannerGraph, ex: torch.Tensor, ez: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Class bits of e relative to the pure error T @ s: f32[..., 2k]
    (bx = <lz, e XOR e0>_x bits, then bz bits)."""
    ex0 = torch.remainder(s @ graph.pure_ex.T, 2.0)
    ez0 = torch.remainder(s @ graph.pure_ez.T, 2.0)
    cx = torch.remainder(ex + ex0, 2.0)
    cz = torch.remainder(ez + ez0, 2.0)
    bx = torch.remainder(cx @ graph.logicals_z.T, 2.0)
    bz = torch.remainder(cz @ graph.logicals_x.T, 2.0)
    return torch.cat([bx, bz], dim=-1)


def training_rate(generator: torch.Generator, code_p: float, batch: int, step: int,
                  p_curriculum=None, p_mix=None):
    """The noise rate of one training batch (``tpugnn/train/loop.py:152-166``).

    ``p_curriculum=(p0, p1, over)``: the float p0 + (p1 - p0) min(step /
    over, 1).  ``p_mix=(lo, hi)``: a per-shot rate, a [batch, 1] tensor
    uniform in [lo, hi) on the generator's device.  Neither: ``code_p``."""
    if p_curriculum is not None and p_mix is not None:
        raise ValueError("p_curriculum and p_mix are mutually exclusive")
    if p_curriculum is not None:
        p0, p1, over = p_curriculum
        return p0 + (p1 - p0) * min(step / max(over, 1), 1.0)
    if p_mix is not None:
        lo, hi = p_mix
        u = torch.rand((batch, 1), generator=generator, device=generator.device)
        return lo + (hi - lo) * u
    return code_p


def sample_batch(generator: torch.Generator, graph: TannerGraph, p,
                 batch: int) -> SyndromeBatch:
    """Sample a batch of decoding episodes on the graph's device."""
    ex, ez = sample_depolarizing(generator, graph, p, batch)
    s = syndrome(graph, ex, ez)
    bits = logical_class_bits(graph, ex, ez, s)
    return SyndromeBatch(ex=ex, ez=ez, syndrome=s, class_bits=bits)
