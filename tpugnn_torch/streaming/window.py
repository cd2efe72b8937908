"""Sliding-window streaming decoder for continuous syndrome measurement.

The port of ``tpugnn.streaming.window``.  A running quantum computer never
stops measuring, so decoding runs in bounded-latency windows over an
unbounded detector stream (the overlapping-window scheme of sliding-window
matching decoders):

* decode a window of ``W`` consecutive syndrome rounds with a decoder built
  for the ``d_t = W`` spacetime detector graph;
* commit only the data-fault corrections of the window's first ``C < W``
  rounds (the tail is re-decoded by the next window with more context);
* slide by ``C`` and re-reference the next window's first detector by the
  syndrome of everything committed so far (``D_0' = s_hat_T XOR H e_hat``),
  so residual or mis-committed errors re-enter as time-0 data faults;
* the stream's final window (a perfect last round) commits all its rounds.

The window decoder is pluggable: the port's ``GNNDecoder`` raw
(``from_gnn``), with the on-device repair (``from_gnn_device``) or with a
host cleanup (``from_gnn_cleanup``), union-find (``from_union_find``),
exact MWPM (``from_mwpm``), or any ``[B, m_pad] uint8 -> ex_hat`` callable.
A GNN window's forward, its consistency test and its device repair run on
the model's device (the card unless the caller asks for the CPU); the
window's uint8 correction (and, for a host cleanup, its residual syndrome)
is what crosses to the host.  The stream bookkeeping runs in NumPy, and
``sample_stream`` draws from NumPy's ``default_rng``, so a seed gives the
JAX package's streams exactly.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from tpugnn_torch.tanner.spacetime import build_spacetime_code, sector_checks
from tpugnn_torch.utils import f2
from tpugnn_torch.utils.device import resolve_device

__all__ = ["SlidingWindowDecoder", "sample_stream", "stream_ler"]


def _sector_h(family: str, distance: int, sector: str) -> np.ndarray:
    hx, hz = sector_checks(family, distance)
    return hz if sector == "z" else hx


class SlidingWindowDecoder:
    """Decode an unbounded noisy-syndrome stream in overlapping windows.

    ``decode_window(detectors uint8 [B, m_pad]) -> ex_hat [B, >= n*W]``
    predicts per-fault flips on the ``d_t = window`` spacetime graph (data
    faults time-major in the first ``n*W`` columns, as
    ``tanner.spacetime.spacetime_matrix`` lays them out).
    """

    def __init__(self, family: str, distance: int, *, window: int, commit: int,
                 sector: str = "z", meas_ratio: float = 1.0,
                 decode_window: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 pad_nodes: int = 8, pad_edges: int = 128):
        if not 1 <= commit <= window:
            raise ValueError("need 1 <= commit <= window")
        self.family = family
        self.distance = distance
        self.window = window
        self.commit = commit
        self.sector = sector
        self.h = _sector_h(family, distance, sector)
        if self.h.shape[0] == 0:
            raise ValueError(f"{family} has no {sector}-type stabilizers")
        self.m, self.n = self.h.shape
        self.graph = build_spacetime_code(family, distance, window, sector=sector,
                                          meas_ratio=meas_ratio, pad_nodes=pad_nodes,
                                          pad_edges=pad_edges)
        self._decode_window = decode_window

    # -- adapters -----------------------------------------------------------

    @classmethod
    def _gnn_setup(cls, family, distance, model, device, kw):
        """The decoder, its graph's tensors and the model on ``device``."""
        self = cls(family, distance, **kw)
        dev = resolve_device(device)
        return self, dev, self.graph.to(dev), model.to(dev).eval()

    @classmethod
    def from_gnn(cls, family, distance, *, window, commit, model, sector: str = "z",
                 defer_inconsistent: bool = True, device="cuda",
                 **kw) -> "SlidingWindowDecoder":
        """Window decoder = a trained ``GNNDecoder`` (its per-qubit head).

        ``defer_inconsistent`` (default on): a window prediction whose
        spacetime syndrome does not reproduce the window's detectors is
        replaced by the zero correction, so nothing is committed and the
        unexplained defects roll into the next window's re-referenced frame.
        Without it, committed inconsistent corrections re-enter every later
        window as phantom time-0 faults and the stream decodes near chance.
        """
        from tpugnn_torch.eval.ler import decode_corrections
        from tpugnn_torch.sampling.noise import syndrome

        self, dev, dg, model = cls._gnn_setup(
            family, distance, model, device,
            dict(window=window, commit=commit, sector=sector, **kw))
        m_real = dg.n_checks

        @torch.inference_mode()
        def _decode(d):
            syn = torch.as_tensor(np.asarray(d, np.uint8)).to(dev).float()
            ex, _ = decode_corrections(model(dg, syn).qubit_logits)
            if defer_inconsistent:
                s_hat = syndrome(dg, ex, torch.zeros_like(ex))
                ok = (s_hat[:, :m_real] == syn[:, :m_real]).all(1)
                ex = ex * ok[:, None].float()
            return ex.to(torch.uint8).cpu().numpy()

        self._decode_window = _decode
        return self

    @classmethod
    def from_gnn_device(cls, family, distance, *, window, commit, model,
                        sector: str = "z", device="cuda", **kw) -> "SlidingWindowDecoder":
        """Window decoder = GNN + the on-device greedy residual repair
        (``baselines.device_repair``): every window correction reproduces
        its detectors, with no host decoder per window."""
        from tpugnn_torch.baselines.device_repair import DeviceRepair
        from tpugnn_torch.eval.ler import decode_corrections
        from tpugnn_torch.sampling.noise import syndrome

        self, dev, dg, model = cls._gnn_setup(
            family, distance, model, device,
            dict(window=window, commit=commit, sector=sector, **kw))
        dr = DeviceRepair(self.graph, device=dev)

        @torch.inference_mode()
        def _decode(d):
            syn = torch.as_tensor(np.asarray(d, np.uint8)).to(dev).float()
            ex, _ = decode_corrections(model(dg, syn).qubit_logits)
            s_res = torch.remainder(syn + syndrome(dg, ex, torch.zeros_like(ex)), 2.0)
            rx, _ = dr.repair(s_res)
            return torch.remainder(ex + rx, 2.0).to(torch.uint8).cpu().numpy()

        self._decode_window = _decode
        return self

    @classmethod
    def from_gnn_cleanup(cls, family, distance, *, window, commit, model,
                         sector: str = "z", cleanup: str = "uf",
                         tau: Optional[float] = None, p: Optional[float] = None,
                         device="cuda", **kw) -> "SlidingWindowDecoder":
        """Window decoder = GNN + a host cleanup (``'uf'`` or ``'mwpm'``) of
        the window's residual syndrome (``eval.hybrid`` per window), so every
        committed correction is consistent.  ``tau`` gates the GNN's flips
        by confidence; ``p`` weights MWPM by the graph's fault rates."""
        from tpugnn_torch.eval.hybrid import _cleanup_decoder, _gated_corrections, lazy_decode
        from tpugnn_torch.sampling.noise import syndrome

        self, dev, dg, model = cls._gnn_setup(
            family, distance, model, device,
            dict(window=window, commit=commit, sector=sector, **kw))
        dec = _cleanup_decoder(self.graph, cleanup, p, False)

        @torch.inference_mode()
        def _fwd(d):
            syn = torch.as_tensor(np.asarray(d, np.uint8)).to(dev).float()
            ex, ez = _gated_corrections(model(dg, syn).qubit_logits, tau)
            s_res = torch.remainder(syn + syndrome(dg, ex, ez), 2.0)
            return ex.to(torch.uint8).cpu().numpy(), s_res.to(torch.uint8).cpu().numpy()

        def _decode(d):
            ex_g, s_res = _fwd(d)
            ex_u, _ = lazy_decode(dec, s_res)
            return ex_g[:, :ex_u.shape[1]] ^ ex_u

        self._decode_window = _decode
        return self

    @classmethod
    def from_union_find(cls, family, distance, *, window, commit, sector: str = "z",
                        **kw) -> "SlidingWindowDecoder":
        """Window decoder = the union-find baseline (host, C++)."""
        from tpugnn_torch.baselines.union_find import UnionFindDecoder

        self = cls(family, distance, window=window, commit=commit, sector=sector, **kw)
        uf = UnionFindDecoder(self.graph)
        self._decode_window = lambda d: uf.decode(d)[0]
        return self

    @classmethod
    def from_mwpm(cls, family, distance, *, window, commit, sector: str = "z",
                  p: Optional[float] = None, **kw) -> "SlidingWindowDecoder":
        """Window decoder = exact MWPM on the window's detector graph (the
        classic sliding-window matching decoder).  ``p`` weights it by the
        graph's per-fault rates when measurement and data rates differ."""
        from tpugnn_torch.baselines.mwpm import MWPMDecoder

        self = cls(family, distance, window=window, commit=commit, sector=sector, **kw)
        mw = MWPMDecoder(self.graph, p=p)
        self._decode_window = lambda d: mw.decode(d)[0]
        return self

    # -- streaming ----------------------------------------------------------

    def n_windows(self, rounds: int) -> int:
        """Window decodes per stream of ``rounds`` rounds."""
        return (rounds - self.window) // self.commit + 1

    def decode_stream(self, s_hat: np.ndarray) -> np.ndarray:
        """Noisy syndromes [B, T, m] -> net data-fault correction [B, n].

        ``s_hat`` follows the cumulative-error convention of
        ``tanner/spacetime.py``: ``s_hat_t = H(XOR_{tau<=t} e_tau) XOR m_t``
        with a perfect final round.  Requires ``T >= window`` and
        ``(T - window) % commit == 0``, so the commit regions tile the stream.
        """
        if self._decode_window is None:
            raise ValueError("no window decoder configured")
        s_hat = np.asarray(s_hat, np.uint8)
        if s_hat.ndim == 2:
            s_hat = s_hat[None]
        b, t, m = s_hat.shape
        w, c, n = self.window, self.commit, self.n
        if m != self.m:
            raise ValueError(f"syndrome width {m} != {self.m} checks")
        if t < w or (t - w) % c:
            raise ValueError(f"stream length {t} must be window + k*commit "
                             f"(window={w}, commit={c})")
        m_pad = self.graph.n_checks_pad
        e_total = np.zeros((b, n), np.uint8)
        offset = 0
        while True:
            last = offset == t - w
            det = np.zeros((b, w, m), np.uint8)
            # frame re-reference: the committed corrections make the apparent
            # time-(offset) syndrome H(E XOR e_total)
            det[:, 0] = s_hat[:, offset] ^ (e_total @ self.h.T % 2)
            det[:, 1:] = s_hat[:, offset + 1:offset + w] ^ s_hat[:, offset:offset + w - 1]
            flat = np.zeros((b, m_pad), np.uint8)
            flat[:, :w * m] = det.reshape(b, w * m)
            ex = np.asarray(self._decode_window(flat), np.uint8)
            for tau in range(w if last else c):
                e_total ^= ex[:, tau * n:(tau + 1) * n]
            if last:
                return e_total
            offset += c


def sample_stream(rng: np.random.Generator, family: str, distance: int, *, p: float,
                  rounds: int, batch: int = 1, sector: str = "z",
                  meas_ratio: float = 1.0):
    """Phenomenological stream: ``(s_hat [B, T, m], e_net [B, n])``.

    Data faults e_t ~ Bern(p) per round, measurement faults m_t ~
    Bern(p * meas_ratio) but in the (perfect) final round; syndromes follow
    the cumulative convention s_hat_t = H(XOR_{tau<=t} e_tau) XOR m_t.  The
    draws are the JAX package's, in the same order.
    """
    h = _sector_h(family, distance, sector)
    m, n = h.shape
    e = (rng.random((batch, rounds, n)) < p).astype(np.uint8)
    cum = np.bitwise_xor.accumulate(e, axis=1)
    meas = (rng.random((batch, rounds, m)) < p * meas_ratio).astype(np.uint8)
    meas[:, -1] = 0
    s_hat = (cum @ h.T % 2).astype(np.uint8) ^ meas
    return s_hat, cum[:, -1]


def stream_ler(decoder: SlidingWindowDecoder, *, p: float, rounds: int, shots: int,
               seed: int = 0, batch: int = 256, meas_ratio: float = 1.0) -> dict:
    """Monte-Carlo logical error rate of the streaming decoder.

    A shot fails when the residual E XOR E_hat leaves a syndrome or
    anticommutes with a base-code logical of the opposite type (the
    convention of ``eval/ler.py`` for the monolithic detector decode).
    Also returns the window decodes made and the wall seconds spent in
    ``decode_stream``.
    """
    h = decoder.h
    hx, hz = sector_checks(decoder.family, decoder.distance)
    lx, lz = f2.css_logicals(hx, hz)
    logical = lz if decoder.sector == "z" else lx

    rng = np.random.default_rng(seed)
    fails = done = windows = 0
    seconds = 0.0
    while done < shots:
        bsz = min(batch, shots - done)
        s_hat, e_net = sample_stream(rng, decoder.family, decoder.distance, p=p,
                                     rounds=rounds, batch=bsz, sector=decoder.sector,
                                     meas_ratio=meas_ratio)
        t0 = time.perf_counter()
        e_hat = decoder.decode_stream(s_hat)
        seconds += time.perf_counter() - t0
        windows += decoder.n_windows(rounds)
        res = e_net ^ e_hat
        syn_bad = (res @ h.T % 2).any(axis=1)
        log_bad = (res @ logical.T % 2).any(axis=1)
        fails += int(np.logical_or(syn_bad, log_bad).sum())
        done += bsz
    ler = fails / done
    return {"ler": ler, "shots": float(done),
            "ler_stderr": (max(ler * (1 - ler), 1e-12) / done) ** 0.5,
            "windows": windows, "decode_seconds": seconds}
