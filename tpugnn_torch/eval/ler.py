"""Monte-Carlo logical error rate of a decoder, on the decoder's device.

The port of ``tpugnn.eval.ler``.  Per shot:

* per-qubit head: the hard correction from the logits fails iff its syndrome
  differs from the observed one or the residual anticommutes with a logical
  operator;
* logical head: fails iff any predicted class bit (relative to the pure
  error T @ s) differs from the true one;
* hybrid: the per-qubit correction where it is syndrome-consistent, else the
  logical head's.
"""

from __future__ import annotations

import torch

from tpugnn_torch.sampling.noise import SyndromeBatch, sample_batch, syndrome
from tpugnn_torch.tanner.graph import TannerGraph
from tpugnn_torch.utils.device import resolve_device

__all__ = ["decode_corrections", "count_failures", "ler_monte_carlo"]


def decode_corrections(qubit_logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-qubit logits -> hard correction (ex, ez) in f32.

    Width 2: independent bits thresholded at 0.  Width 4: argmax over
    [I, X, Z, Y] with index = ex + 2 ez.
    """
    if qubit_logits.shape[-1] == 4:
        idx = torch.argmax(qubit_logits, dim=-1)
        return (idx % 2).float(), (idx // 2).float()
    hard = (qubit_logits > 0.0).float()
    return hard[..., 0], hard[..., 1]


def count_failures(graph: TannerGraph, batch: SyndromeBatch, ex_hat: torch.Tensor,
                   ez_hat: torch.Tensor,
                   logical_logits: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """Per-shot failure indicators (f32 0/1) of both heads."""
    rx = torch.remainder(batch.ex + ex_hat, 2.0)
    rz = torch.remainder(batch.ez + ez_hat, 2.0)
    s_hat = syndrome(graph, ex_hat, ez_hat)
    syn_mismatch = torch.any(s_hat != batch.syndrome, dim=-1)
    lx_flip = torch.remainder(rx @ graph.logicals_z.T, 2.0)
    lz_flip = torch.remainder(rz @ graph.logicals_x.T, 2.0)
    logical_flip = torch.any(lx_flip + lz_flip > 0.5, dim=-1)
    res = {
        "fail_qubit": (syn_mismatch | logical_flip).float(),
        "syn_mismatch": syn_mismatch.float(),
    }
    if logical_logits is not None:
        pred_bits = (logical_logits > 0.0).float()
        fail_logical = torch.any(pred_bits != batch.class_bits, dim=-1).float()
        res["fail_logical"] = fail_logical
        res["fail_hybrid"] = torch.where(syn_mismatch, fail_logical,
                                         logical_flip.float())
    return res


@torch.inference_mode()
def ler_monte_carlo(model, graph: TannerGraph, *, p: float, shots: int, batch: int,
                    generator: torch.Generator, device="cuda") -> dict[str, float]:
    """Monte-Carlo LER of ``model`` (a ``GNNDecoder`` of either layout) over
    ``shots`` episodes.

    ``graph`` is the NumPy graph; it and the model are moved to ``device``.
    Shots come from ``generator``, a ``torch.Generator`` on ``device``.  Returns the JAX version's keys:
    ``*_rate`` per failure kind, ``ler`` (per-qubit head) and its binomial
    ``ler_stderr``, ``shots``, ``ler_logical``, ``ler_hybrid``.
    """
    dev = resolve_device(device)
    dg = graph.to(dev)
    model = model.to(dev)
    n_chunks = max(1, (shots + batch - 1) // batch)
    total: dict[str, torch.Tensor] = {}
    for _ in range(n_chunks):
        b = sample_batch(generator, dg, p, batch)
        out = model(dg, b.syndrome)
        ex_hat, ez_hat = decode_corrections(out.qubit_logits)
        for k, v in count_failures(dg, b, ex_hat, ez_hat, out.logical_logits).items():
            total[k] = total[k] + v.sum() if k in total else v.sum()
    n = n_chunks * batch
    out = {f"{k}_rate": float(v) / n for k, v in total.items()}
    ler = out.get("fail_qubit_rate", 0.0)
    out["ler"] = ler
    out["ler_stderr"] = (max(ler * (1 - ler), 1e-12) / n) ** 0.5
    out["shots"] = float(n)
    if "fail_logical_rate" in out:
        out["ler_logical"] = out["fail_logical_rate"]
    if "fail_hybrid_rate" in out:
        out["ler_hybrid"] = out["fail_hybrid_rate"]
    return out
