"""Serving engine: batched decode of syndromes, NumPy in and NumPy out.

The port of ``tpugnn.serve.engine.DecodeEngine`` without classical cleanup
(``cleanup=None``)::

    eng = DecodeEngine.from_npz()                 # trained d=11 weights
    corrections = eng.decode(syndromes)           # np [B, m] -> uint8 [B, n, 2]

* the decoder runs once on a ``max_batch`` batch at construction, so the
  first request finds the kernel built and loaded;
* every chunk is padded to ``max_batch`` rows (one shape on the device for
  any request size) and requests above ``max_batch`` are decoded in
  microbatches of ``max_batch``.

The model is any :class:`~tpugnn_torch.models.decoder.GNNDecoder`: a
``'fused'`` one runs its rounds in K1, a generic one (``load_decoder(...,
backend='pallas')``) runs the message-passing engine, as
``tpugnn/serve/engine.py:92-97`` takes the fused fast path only for
``backend == 'fused'``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpugnn_torch.configs import ExperimentConfig
from tpugnn_torch.eval.ler import decode_corrections
from tpugnn_torch.models.convert import DEFAULT_WEIGHTS, load_decoder
from tpugnn_torch.models.decoder import GNNDecoder
from tpugnn_torch.tanner import build_code
from tpugnn_torch.tanner.graph import TannerGraph
from tpugnn_torch.utils.device import resolve_device

__all__ = ["DecodeEngine"]


class DecodeEngine:
    def __init__(self, cfg: ExperimentConfig, model: GNNDecoder,
                 graph: TannerGraph | None = None, *, max_batch: int = 4096,
                 device="cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph if graph is not None else build_code(
            cfg.code.family, cfg.code.distance,
            pad_nodes=cfg.code.pad_nodes, pad_edges=cfg.code.pad_edges)
        self._dgraph = self.graph.to(self.device)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        # warm-up: build/load the kernel and run the serving shape once
        self._decode_chunk(torch.zeros((max_batch, self.graph.n_checks_pad),
                                       device=self.device))

    @classmethod
    def from_npz(cls, path: str = DEFAULT_WEIGHTS, *, device="cuda",
                 **kw) -> "DecodeEngine":
        cfg, model, graph = load_decoder(path, device=device)
        return cls(cfg, model, graph, device=device, **kw)

    @torch.inference_mode()
    def _decode_chunk(self, syn: torch.Tensor) -> torch.Tensor:
        out = self.model(self._dgraph, syn)
        ex, ez = decode_corrections(out.qubit_logits)
        return torch.stack([ex, ez], dim=-1).to(torch.uint8)

    def decode(self, syndromes: np.ndarray) -> np.ndarray:
        """np [B, m] or [B, m_pad] in {0, 1} -> np.uint8 [B, n_qubits, 2]."""
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
        outs = []
        for lo in range(0, b, self.max_batch):
            chunk = s[lo:lo + self.max_batch]
            nb = chunk.shape[0]
            if nb < self.max_batch:
                chunk = np.pad(chunk, ((0, self.max_batch - nb), (0, 0)))
            dev = self._decode_chunk(torch.from_numpy(chunk).to(self.device))
            outs.append(dev[:nb, :n].cpu().numpy())
        if not outs:
            return np.zeros((0, n, 2), np.uint8)
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
