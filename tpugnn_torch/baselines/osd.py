"""BP + OSD-0: ordered-statistics post-processing of the BP posteriors.

The port of ``tpugnn.baselines.osd``.  Plain BP fails on degenerate quantum
codes mostly by not converging (the residual syndrome does not vanish); OSD
orders the parity-check columns by BP reliability, Gauss-eliminates in that
order and solves for a syndrome-consistent correction on the most likely
qubits.  OSD-0 (no higher-order reprocessing) is the classical companion of
BP in the decoder comparisons.

BP runs on the device (``baselines.bp``); the per-shot Gaussian elimination
runs on the host in the C++ library (``csrc/osd.cpp`` through
``tpugnn_torch.utils.native``, which raises if it cannot be built).
``osd0_py`` is the NumPy version of the same algorithm: the tests' oracle,
run only where a caller asks for it (``force_python=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpugnn_torch.baselines.bp import bp_posteriors
from tpugnn_torch.tanner.graph import TannerGraph
from tpugnn_torch.utils.device import resolve_device

__all__ = ["BPOSDDecoder", "osd0_py"]


def osd0_py(h: np.ndarray, syndromes: np.ndarray, llrs: np.ndarray) -> np.ndarray:
    """NumPy OSD-0.  h: uint8[m, n]; syndromes: uint8[B, m]; llrs: f32[B, n]
    (ascending = least reliable first).  Returns corrections uint8[B, n]."""
    m, n = h.shape
    out = np.zeros((syndromes.shape[0], n), np.uint8)
    for s in range(syndromes.shape[0]):
        order = np.argsort(llrs[s], kind="stable")
        a = np.concatenate([h, syndromes[s][:, None]], axis=1).astype(np.uint8)
        rank = 0
        pivots: list[int] = []
        for j in order:
            rows = np.nonzero(a[rank:, j])[0]
            if rows.size == 0:
                continue
            r = rank + rows[0]
            if r != rank:
                a[[rank, r]] = a[[r, rank]]
            for i in np.nonzero(a[:, j])[0]:
                if i != rank:
                    a[i] ^= a[rank]
            pivots.append(j)
            rank += 1
            if rank == m:
                break
        for i, j in enumerate(pivots):
            out[s, j] = a[i, n]
    return out


class BPOSDDecoder:
    """Batched BP+OSD-0 decoder over both CSS sectors.

    ``graph`` is the NumPy graph; BP runs on ``device`` (the card unless the
    caller asks for the CPU).  ``decode(syndrome)`` returns host uint8
    ``(ex_hat, ez_hat)`` [B, n_qubits]; every correction reproduces its
    syndrome (a valid syndrome lies in its sector's column space).
    """

    def __init__(self, graph: TannerGraph, *, p: float, iters: int = 32,
                 alpha: float = 0.8, force_python: bool = False, device="cuda"):
        self.graph = graph
        self.p = p
        self.iters = iters
        self.alpha = alpha
        self.device = resolve_device(device)
        self._dg = graph.to(self.device)
        m, n = graph.n_checks, graph.n_qubits
        is_x = np.asarray(graph.check_is_x)[:m] > 0.5
        self._rows_x = np.nonzero(is_x)[0]          # X checks constrain ez
        self._rows_z = np.nonzero(~is_x)[0]         # Z checks constrain ex
        self._hx = np.ascontiguousarray(
            np.asarray(graph.h_syn_ez)[self._rows_x, :n].astype(np.uint8))
        self._hz = np.ascontiguousarray(
            np.asarray(graph.h_syn_ex)[self._rows_z, :n].astype(np.uint8))
        self._lib = None
        if not force_python:
            from tpugnn_torch.utils.native import load

            self._lib = load()

    def _osd(self, h: np.ndarray, syn: np.ndarray, llr: np.ndarray) -> np.ndarray:
        out = np.zeros((syn.shape[0], h.shape[1]), np.uint8)
        if h.shape[0] == 0:          # a sector without checks: nothing to explain
            return out
        if self._lib is None:
            return osd0_py(h, syn, llr)
        self._lib.osd0_decode_batch(h, h.shape[0], h.shape[1], np.ascontiguousarray(syn),
                                    np.ascontiguousarray(llr), syn.shape[0], out)
        return out

    def posteriors(self, syndrome) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """BP on the device: host ``(l_ex, l_ez)`` f32 [B, n_qubits] and the
        syndrome as host uint8 [B, m_pad]."""
        n = self.graph.n_qubits
        syn = torch.as_tensor(syndrome).to(device=self.device, dtype=torch.float32)
        l_ex, l_ez = bp_posteriors(self._dg, syn, self.p, iters=self.iters, alpha=self.alpha)
        return (l_ex[:, :n].cpu().numpy(), l_ez[:, :n].cpu().numpy(),
                syn.to(torch.uint8).cpu().numpy())

    def osd(self, l_ex: np.ndarray, l_ez: np.ndarray,
            syn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The host half: OSD-0 of each sector on :meth:`posteriors`' output."""
        ex_hat = self._osd(self._hz, np.ascontiguousarray(syn[:, self._rows_z]), l_ex)
        ez_hat = self._osd(self._hx, np.ascontiguousarray(syn[:, self._rows_x]), l_ez)
        return ex_hat, ez_hat

    def decode(self, syndrome) -> tuple[np.ndarray, np.ndarray]:
        """syndrome: [B, n_checks_pad] (host or device) -> (ex_hat, ez_hat)."""
        return self.osd(*self.posteriors(syndrome))
