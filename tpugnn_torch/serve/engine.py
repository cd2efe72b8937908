"""Serving engine: batched decode of syndromes, NumPy in and NumPy out.

The port of ``tpugnn.serve.engine.DecodeEngine``::

    eng = DecodeEngine.from_npz(cleanup="uf")     # trained d=11 weights
    corrections = eng.decode(syndromes)           # np [B, m] -> uint8 [B, n, 2]

* the decode program runs once on a ``max_batch`` batch at construction, so
  the first request finds the kernel built and loaded;
* every chunk is padded to ``max_batch`` rows (one shape on the device for
  any request size) and requests above ``max_batch`` are decoded in
  microbatches of ``max_batch``;
* ``cleanup`` picks what follows the GNN (``tpugnn_torch.eval.hybrid``):
  ``None`` the hard per-qubit correction; ``'uf'`` / ``'mwpm'`` the gated
  correction XOR the host union-find / MWPM repair of its residual
  syndrome; ``'best_of'`` the per-shot lightest of {gated qubit head,
  logical head, GNN+UF, GNN+MWPM, raw MWPM} (``lazy=True``: raw MWPM only
  where the gated correction is inconsistent); ``'device'`` the gated
  correction repaired on the device (``baselines.device_repair``: no host
  decoding); ``'best_of_device'`` the lightest of {gated qubit head,
  logical head, GNN+device repair} chosen on the device, and raw MWPM on
  the host only for shots whose gated correction is inconsistent.
  ``select_cost='nll'`` ranks the best-of candidates by the GNN's posterior
  (``TPUGNN_NLL_TEMP`` read once, here); ``cleanup_tau`` gates the GNN's
  flips by confidence;
* the wire is bit-packed (``wire_pack``, lossless): syndromes go up as
  ``np.packbits`` bytes and unpack on the device with shifts; the outputs
  pack on the device in the same big-endian bit order and ``np.unpackbits``
  reads them on the host;
* an in-flight window: each chunk's outputs are copied into pinned host
  buffers without blocking and a CUDA event is recorded; a pool of
  ``pp_workers`` threads waits on the event and runs the host tail (unpack,
  classical cleanup, selection; the C++ decoders and BLAS release the GIL)
  while the card runs the next chunks, with at most ``inflight_window``
  chunks ahead.  Each worker has its own cleanup decoders.  ``timing``
  sums each chunk's host-tail ms and its span on the device.

``data_parallel=N`` (N > 1) replicates the model on ``cuda:0`` ..
``cuda:N-1`` and splits every chunk's forward N ways, each share launched on
its card (the cards run at once), the outputs gathered on the engine's
device: no collectives, as GSPMD partitions the JAX engine's decode
(``tpugnn/serve/engine.py:309-333``).  With ``device='cpu'`` the N shares
run on the CPU, one after another.  It raises when there are fewer devices
(on the CPU: cores) than N, or when N does not divide ``max_batch``.

The model is any :class:`~tpugnn_torch.models.decoder.GNNDecoder`: a
``'fused'`` one runs its rounds in K1, a generic one (``load_decoder(...,
backend='pallas')``) runs the message-passing engine, as
``tpugnn/serve/engine.py:92-97`` takes the fused fast path only for
``backend == 'fused'``.  ``close()`` (or a ``with`` block) shuts the pool
down.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpugnn_torch.configs import ExperimentConfig
from tpugnn_torch.eval.hybrid import (
    NLP_SCALE,
    _device_start,
    _gated_corrections,
    _HostCopy,
    _nlp4,
    _residual,
    lazy_decode,
    logical_head_correction,
    min_weight_select,
)
from tpugnn_torch.eval.ler import decode_corrections
from tpugnn_torch.models.convert import DEFAULT_WEIGHTS, load_decoder
from tpugnn_torch.models.decoder import GNNDecoder
from tpugnn_torch.tanner import build_code
from tpugnn_torch.tanner.graph import TannerGraph
from tpugnn_torch.utils.device import resolve_device

__all__ = ["DecodeEngine", "CLEANUPS", "pack_rows", "unpack_rows"]

CLEANUPS = (None, "uf", "mwpm", "best_of", "device", "best_of_device")
_BIG = 1.0e9
_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)   # np.packbits' default bit order


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """uint8 0/1 [B, R, ...] -> uint8 [B, ceil(R / 8), ...], packed along
    dim 1 as ``np.packbits(x, axis=1)`` packs (first row in the top bit)."""
    r = bits.shape[1]
    pad = (-r) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros((bits.shape[0], pad, *bits.shape[2:]))], 1)
    g = bits.reshape(bits.shape[0], (r + pad) // 8, 8, *bits.shape[2:]).to(torch.int32)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int32, device=bits.device)
    shifts = shifts.reshape(1, 1, 8, *([1] * (bits.dim() - 2)))
    return (g << shifts).sum(dim=2).to(torch.uint8)


def unpack_rows(packed: torch.Tensor, count: int) -> torch.Tensor:
    """uint8 [B, ceil(count / 8)] -> uint8 0/1 [B, count], the inverse of
    ``np.packbits(x, axis=1)`` (``np.unpackbits(p, axis=1, count=count)``)."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :count]


class DecodeEngine:
    # chunks allowed in flight on the device at once: enough to keep the
    # device busy while the host post-processes the synced chunk, bounded so
    # that device and pinned memory stay O(window), not O(request)
    inflight_window: int = 3

    def __init__(self, cfg: ExperimentConfig, model: GNNDecoder,
                 graph: TannerGraph | None = None, *, max_batch: int = 4096,
                 cleanup: str | None = None, cleanup_tau: float | None = None,
                 lazy: bool = False, wire_pack: bool = True, pp_workers: int = 2,
                 select_cost: str = "weight", device="cuda", data_parallel: int | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        # lazy best-of serving: the raw-MWPM candidate is computed only for
        # shots whose gated GNN correction is syndrome-INconsistent;
        # consistent shots substitute the GNN correction for that candidate
        # (an approximation: a full raw-MWPM decode could occasionally be
        # lighter than an already-consistent GNN correction)
        self._lazy = bool(lazy)
        if select_cost not in ("weight", "nll"):
            raise ValueError(f"unknown select_cost {select_cost!r}; have 'weight'|'nll'")
        if select_cost == "nll" and cleanup not in ("best_of", "best_of_device"):
            raise ValueError("select_cost='nll' requires cleanup='best_of' "
                             "or 'best_of_device'")
        if cleanup not in CLEANUPS:
            raise ValueError(f"unknown cleanup decoder {cleanup!r}; have {CLEANUPS}")
        self._nll = select_cost == "nll"
        # read once, at engine init: part of this engine's program
        self._nll_temp = float(os.environ.get("TPUGNN_NLL_TEMP", "1.0"))
        self.cleanup = cleanup
        self.cleanup_tau = cleanup_tau
        self.device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph if graph is not None else build_code(
            cfg.code.family, cfg.code.distance,
            pad_nodes=cfg.code.pad_nodes, pad_edges=cfg.code.pad_edges)
        self._dgraph = self.graph.to(self.device)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self._replicas = self._replicate(int(data_parallel or 1))
        g = self.graph
        n = g.n_qubits
        self._hx = np.asarray(g.h_syn_ez)[: g.n_checks, :n].astype(np.uint8)
        self._hz = np.asarray(g.h_syn_ex)[: g.n_checks, :n].astype(np.uint8)
        self._repair = None
        if cleanup in ("device", "best_of_device"):
            from tpugnn_torch.baselines.device_repair import DeviceRepair

            self._repair = DeviceRepair(g, device=self.device)
        n_pad, m_pad = g.n_qubits_pad, g.n_checks_pad
        self._out_rows = n_pad + {None: 0, "uf": m_pad, "mwpm": m_pad,
                                  "best_of": m_pad + n_pad, "device": 0,
                                  "best_of_device": 1}[cleanup]
        self._wire_pack = bool(wire_pack)
        self._tl = threading.local()
        self._timing_lock = threading.Lock()
        self.reset_timing()
        # the host decoders are built (the C++ library loaded) now, so that a
        # missing compiler fails here and not in a worker
        self._tl_decoders()
        # warm-up: build/load the kernel and run the serving shape once
        self._finish_chunk(self._launch(np.zeros((max_batch, m_pad), np.float32)), 0,
                           np.zeros((0, m_pad), np.float32))
        self._pp_workers = max(1, int(pp_workers))
        self._pool = ThreadPoolExecutor(max_workers=self._pp_workers)
        self.reset_timing()

    @classmethod
    def from_npz(cls, path: str = DEFAULT_WEIGHTS, *, device="cuda", dtype: str | None = None,
                 **kw) -> "DecodeEngine":
        cfg, model, graph = load_decoder(path, device=device, dtype=dtype)
        return cls(cfg, model, graph, device=device, **kw)

    def close(self) -> None:
        """Shut down the host post-processing pool (idempotent)."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._pool = None

    def __enter__(self) -> "DecodeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best effort; an explicit close() is preferred
        try:
            self.close()
        except Exception:
            pass

    # --- the device program -------------------------------------------------

    def _replicate(self, n: int) -> list:
        """[(model, graph)] of each data-parallel share; [] for one share."""
        if n <= 1:
            return []
        dev = self.device
        have = torch.cuda.device_count() if dev.type == "cuda" else (os.cpu_count() or 1)
        if have < n:
            raise ValueError(f"data_parallel={n} but only {have} devices")
        if self.max_batch % n:
            raise ValueError("max_batch must divide by data_parallel")
        if dev.type != "cuda":
            return [(self.model, self._dgraph)] * n
        here = next(self.model.parameters()).device
        cards = [torch.device("cuda", i) for i in range(n)]
        return [(self.model if d == here else copy.deepcopy(self.model).to(d), self.graph.to(d))
                for d in cards]

    def _forward(self, syn: torch.Tensor):
        """The model on a chunk: whole, or split over the data-parallel
        replicas, each share launched on its card's current stream (the
        cards run at once), and gathered on the engine's device."""
        if not self._replicas:
            return self.model(self._dgraph, syn)
        share = syn.shape[0] // len(self._replicas)
        outs = [model(graph, syn[i * share:(i + 1) * share].to(graph.edge_mask.device,
                                                                non_blocking=True))
                for i, (model, graph) in enumerate(self._replicas)]
        cat = lambda ts: None if ts[0] is None else torch.cat([t.to(syn.device) for t in ts])
        return type(outs[0])(*[cat([o[j] for o in outs]) for j in range(len(outs[0]))])

    @torch.inference_mode()
    def _program(self, syn: torch.Tensor) -> dict:
        """One chunk's device work: [B, m_pad] f32 syndromes -> ``bits``
        (uint8 0/1 [B, rows, 2]) and the mode's side tensors."""
        dg, cleanup, tau = self._dgraph, self.cleanup, self.cleanup_tau
        u8 = lambda x: x.to(torch.uint8)
        out = self._forward(syn)
        if cleanup is None:
            ex, ez = decode_corrections(out.qubit_logits)
            return {"bits": u8(torch.stack([ex, ez], dim=-1))}
        ex, ez = _gated_corrections(out.qubit_logits, tau)
        s_res = _residual(dg, syn, ex, ez)
        nlp = _nlp4(out.qubit_logits, self._nll_temp) if self._nll else None
        if cleanup in ("uf", "mwpm"):
            s2 = torch.stack([s_res, torch.zeros_like(s_res)], dim=-1)
            return {"bits": u8(torch.cat([torch.stack([ex, ez], -1), s2], dim=1))}
        if cleanup == "best_of":
            lex, lez = (logical_head_correction(dg, syn, out.logical_logits)
                        if out.logical_logits is not None else (ex, ez))
            s2 = torch.stack([s_res, torch.zeros_like(s_res)], dim=-1)
            bits = torch.cat([torch.stack([ex, ez], -1), s2,
                              torch.stack([lex, lez], -1)], dim=1)
            return {"bits": u8(bits), "nlp": nlp}
        rx, rz = self._repair.repair(s_res)
        exd, ezd = torch.remainder(ex + rx, 2.0), torch.remainder(ez + rz, 2.0)
        if cleanup == "device":
            return {"bits": u8(torch.stack([exd, ezd], dim=-1))}
        # best_of_device: the lightest of {gated qubit, logical, GNN+repair}
        # on the device; the host only gates raw MWPM on inconsistent shots
        n_q, m_c = self.graph.n_qubits, self.graph.n_checks
        inc_q = torch.any(s_res[:, :m_c] > 0.5, dim=1)
        if out.logical_logits is not None:
            lex, lez = logical_head_correction(dg, syn, out.logical_logits)
            inc_l = torch.any(_residual(dg, syn, lex, lez)[:, :m_c] > 0.5, dim=1)
        else:
            lex, lez, inc_l = ex, ez, inc_q

        def cost(cex, cez):
            # as min_weight_select: the Y-aware weight or the posterior NLL
            if nlp is None:
                return torch.maximum(cex, cez)[:, :n_q].sum(dim=1)
            cls = (cex + 2.0 * cez)[:, :n_q].to(torch.int64)
            per_q = torch.gather(nlp[:, :n_q].float(), 2, cls[:, :, None])[:, :, 0]
            return per_q.sum(dim=1) / NLP_SCALE

        costs = torch.stack([cost(ex, ez) + _BIG * inc_q.float(),
                             cost(lex, lez) + _BIG * inc_l.float(),
                             cost(exd, ezd)])                     # [3, B]
        choice = torch.argmin(costs, dim=0)
        c_sel = costs.amin(dim=0)
        ar = torch.arange(syn.shape[0], device=syn.device)
        sel_ex = torch.stack([ex, lex, exd])[choice, ar]
        sel_ez = torch.stack([ez, lez, ezd])[choice, ar]
        flag = torch.stack([inc_q.float(), torch.zeros_like(inc_q, dtype=torch.float32)],
                           dim=-1)[:, None, :]                     # [B, 1, 2]
        bits = torch.cat([torch.stack([sel_ex, sel_ez], dim=-1), flag], dim=1)
        return {"bits": u8(bits), "cost": c_sel, "nlp": nlp}

    def _launch(self, chunk: np.ndarray) -> _HostCopy:
        """Send one padded chunk, run the program and start the copies back."""
        m_pad = self.graph.n_checks_pad
        start = _device_start(self.device)
        if self._wire_pack:
            wire = torch.from_numpy(np.packbits(chunk.astype(np.uint8), axis=1))
            if self.device.type == "cuda":
                wire = wire.pin_memory()
            with torch.inference_mode():
                syn = unpack_rows(wire.to(self.device, non_blocking=True), m_pad).float()
        else:
            syn = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(self.device)
        res = self._program(syn)
        if self._wire_pack:
            with torch.inference_mode():
                res["bits"] = pack_rows(res["bits"])
        return _HostCopy(res, start)

    # --- requests -----------------------------------------------------------

    def decode(self, syndromes: np.ndarray) -> np.ndarray:
        """np [B, m] or [B, m_pad] in {0, 1} -> np.uint8 [B, n_qubits, 2].

        Software-pipelined: chunk i's host tail runs on the pool while the
        device computes the chunks after it."""
        if self._pool is None:
            raise RuntimeError("DecodeEngine is closed")
        s = np.asarray(syndromes, np.float32)
        if s.ndim != 2:
            raise ValueError(f"syndromes must be [B, m], got shape {s.shape}")
        b, m = s.shape
        m_pad = self.graph.n_checks_pad
        if m > m_pad:
            raise ValueError(f"syndrome width {m} exceeds graph checks {m_pad}")
        if m < m_pad:
            s = np.pad(s, ((0, 0), (0, m_pad - m)))
        n = self.graph.n_qubits
        los = list(range(0, b, self.max_batch))
        if not los:
            return np.zeros((0, n, 2), np.uint8)
        outs: list = [None] * len(los)
        futs: dict = {}
        for i, lo in enumerate(los):
            chunk = s[lo:lo + self.max_batch]
            nb = chunk.shape[0]
            if nb < self.max_batch:
                chunk = np.pad(chunk, ((0, self.max_batch - nb), (0, 0)))
            futs[i] = self._pool.submit(self._finish_chunk, self._launch(chunk), nb, s[lo:lo + nb])
            if i >= self.inflight_window:
                j = i - self.inflight_window
                outs[j] = futs.pop(j).result()
        for j in sorted(futs):
            outs[j] = futs[j].result()
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _finish_chunk(self, copy: _HostCopy, nb: int, s_chunk: np.ndarray) -> np.ndarray:
        """Worker-thread tail: wait for the chunk's copies, unpack,
        post-process."""
        h = copy.numpy()
        t0 = time.perf_counter()
        full = h["bits"][:nb]
        if self._wire_pack:
            full = np.unpackbits(full, axis=1, count=self._out_rows)
        nlp = None if h.get("nlp") is None else h["nlp"][:nb]
        cost = None if h.get("cost") is None else h["cost"][:nb]
        out = self._postprocess(full.astype(np.uint8), s_chunk, nlp=nlp, cost=cost)
        host_ms, device_ms = (time.perf_counter() - t0) * 1e3, copy.device_ms()
        with self._timing_lock:
            self.timing["chunks"] += 1
            self.timing["host_ms"] += host_ms
            if device_ms is not None:
                self.timing["device_ms"] = (self.timing["device_ms"] or 0.0) + device_ms
        return out

    def reset_timing(self) -> None:
        """Zero :attr:`timing`: per chunk, summed since the last reset, the
        host tail's ms (unpack, cleanup, selection; summed over the pool's
        threads) and, on a card, the chunk's span on the device's stream
        (upload to the end of the copies back)."""
        with self._timing_lock:
            self.timing = {"chunks": 0, "host_ms": 0.0, "device_ms": None}

    def _tl_decoders(self):
        """Per-thread cleanup decoder instances: each pool worker gets its own."""
        tl = self._tl
        if not getattr(tl, "ready", False):
            from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder

            p = self.cfg.code.p
            if self.cleanup in ("uf", "best_of"):
                tl.uf = UnionFindDecoder(self.graph)
            if self.cleanup in ("mwpm", "best_of", "best_of_device"):
                tl.mw = MWPMDecoder(self.graph, p=p)
            tl.ready = True
        return tl

    def _postprocess(self, full: np.ndarray, s_chunk: np.ndarray,
                     nlp: np.ndarray | None = None,
                     cost: np.ndarray | None = None) -> np.ndarray:
        """Host tail for one synced chunk: [nb, rows, 2] uint8 -> [nb, n, 2]."""
        g = self.graph
        n_pad, m_pad, n = g.n_qubits_pad, g.n_checks_pad, g.n_qubits
        cleanup = self.cleanup
        if cleanup in (None, "device"):
            return full[:, :n, :]
        if cleanup == "best_of_device":
            # the device already selected among {qubit, logical, gnn+device};
            # raw MWPM runs only on shots whose gated GNN correction was
            # syndrome-inconsistent (the flag row)
            sel = full[:, :n, :].copy()
            nz = np.flatnonzero(full[:, n_pad, 0])
            if nz.size:
                er, zr = self._tl_decoders().mw.decode(s_chunk[nz])
                er, zr = er.astype(np.uint8), zr.astype(np.uint8)
                if nlp is not None:
                    cls = (er + 2 * zr).astype(np.int64)
                    cm = np.take_along_axis(
                        nlp[nz, :n].astype(np.float32), cls[:, :, None],
                        axis=2)[:, :, 0].sum(axis=1).astype(np.float64) / NLP_SCALE
                else:
                    cm = (er | zr).sum(axis=1).astype(np.float64)
                # strict <: ties keep the device pick, as the first-wins
                # argmin of min_weight_select does (mwpm last)
                better = cm < cost[nz].astype(np.float64)
                idx = nz[better]
                sel[idx, :, 0] = er[better]
                sel[idx, :, 1] = zr[better]
            return sel
        tl = self._tl_decoders()
        exg, ezg = full[:, :n, 0], full[:, :n, 1]
        s_res = full[:, n_pad:n_pad + m_pad, 0]
        if cleanup in ("uf", "mwpm"):
            ex_u, ez_u = lazy_decode(tl.uf if cleanup == "uf" else tl.mw, s_res)
            return np.stack([exg ^ ex_u, ezg ^ ez_u], axis=-1)
        lex = full[:, n_pad + m_pad:n_pad + m_pad + n, 0]
        lez = full[:, n_pad + m_pad:n_pad + m_pad + n, 1]
        exu, ezu = lazy_decode(tl.uf, s_res)
        exm, ezm = lazy_decode(tl.mw, s_res)
        if self._lazy:
            # matcher only where the GNN correction is inconsistent;
            # consistent shots reuse the GNN correction as the 'mwpm'
            # candidate
            nz = np.flatnonzero(s_res.any(axis=1))
            exr, ezr = exg.copy(), ezg.copy()
            if nz.size:
                er, zr = tl.mw.decode(s_chunk[nz])
                exr[nz], ezr[nz] = er.astype(np.uint8), zr.astype(np.uint8)
        else:
            er, zr = tl.mw.decode(s_chunk)
            exr, ezr = er.astype(np.uint8), zr.astype(np.uint8)
        cands = {
            "qubit": (exg, ezg),
            "logical": (lex, lez),
            "gnn_uf": (exg ^ exu, ezg ^ ezu),
            "gnn_mwpm": (exg ^ exm, ezg ^ ezm),
            "mwpm": (exr, ezr),
        }
        ex_hat, ez_hat, _ = min_weight_select(
            tuple(cands), cands, s_chunk.astype(np.uint8), self._hz, self._hx,
            qubit_inconsistent=s_res.any(axis=1),
            nlp=None if nlp is None else nlp[:, :n])
        return np.stack([ex_hat, ez_hat], axis=-1).astype(np.uint8)
