"""Monte-Carlo LER of the classical baseline decoders (union-find, MWPM, BP,
BP+OSD-0).

The port of ``tpugnn.eval.baseline``.  Shots are sampled on the device from
one ``torch.Generator``, drawn as :func:`tpugnn_torch.eval.ler.ler_monte_carlo`
draws them.  For the host decoders (union-find, MWPM, the OSD of BP+OSD)
they are copied to the host once per chunk and the failure check (residual
syndrome and logical parity) runs in NumPy; BP alone stays on the device
from sampling to the failure counts.
"""

from __future__ import annotations

import torch

from tpugnn_torch.baselines.union_find import UnionFindDecoder
from tpugnn_torch.eval.hybrid import _failure_fn
from tpugnn_torch.sampling.noise import sample_batch
from tpugnn_torch.tanner.graph import TannerGraph
from tpugnn_torch.utils.device import resolve_device

__all__ = ["ler_union_find", "ler_mwpm", "ler_bp", "ler_bp_osd"]


@torch.inference_mode()
def _ler_host(graph: TannerGraph, dec, name: str, *, p: float, shots: int, batch: int,
              generator: torch.Generator, device) -> dict[str, float]:
    """Shared Monte-Carlo loop for host-side decoders: sample on the device,
    decode on the host, check the residual syndrome and logical parity in
    NumPy."""
    dg = graph.to(resolve_device(device))
    n = graph.n_qubits
    fail_of = _failure_fn(graph)
    fails = 0
    syn_mismatch = 0
    total = 0
    for _ in range(max(1, (shots + batch - 1) // batch)):
        b = sample_batch(generator, dg, p, batch)
        ex = b.ex[:, :n].to(torch.uint8).cpu().numpy()
        ez = b.ez[:, :n].to(torch.uint8).cpu().numpy()
        ex_hat, ez_hat = dec.decode(b.syndrome.to(torch.uint8).cpu().numpy())
        # the residual syndrome must vanish (every baseline reproduces it)
        f, sm = fail_of(ex_hat, ez_hat, ex, ez)
        fails += int(f.sum())
        syn_mismatch += int(sm.sum())
        total += batch
    ler = fails / total
    return {
        "ler": ler,
        "ler_stderr": (max(ler * (1 - ler), 1e-12) / total) ** 0.5,
        "syn_mismatch_rate": syn_mismatch / total,
        "shots": float(total),
        "decoder": name,
    }


def ler_union_find(graph: TannerGraph, *, p: float, shots: int, batch: int = 4096,
                   generator: torch.Generator, force_python: bool = False,
                   device="cuda") -> dict[str, float]:
    """Monte-Carlo LER of the union-find decoder (``graph``: the NumPy graph;
    shots from ``generator`` on ``device``)."""
    dec = UnionFindDecoder(graph, force_python=force_python)
    return _ler_host(graph, dec, "union_find", p=p, shots=shots, batch=batch,
                     generator=generator, device=device)


def ler_mwpm(graph: TannerGraph, *, p: float, shots: int, batch: int = 4096,
             generator: torch.Generator, force_python: bool = False,
             device="cuda") -> dict[str, float]:
    """Monte-Carlo LER of exact minimum-weight perfect matching, the
    reference's canonical baseline."""
    from tpugnn_torch.baselines.mwpm import MWPMDecoder

    dec = MWPMDecoder(graph, p=p, force_python=force_python)
    return _ler_host(graph, dec, "mwpm", p=p, shots=shots, batch=batch,
                     generator=generator, device=device)


@torch.inference_mode()
def ler_bp(graph: TannerGraph, *, p: float, shots: int, batch: int = 4096, iters: int = 32,
           alpha: float = 0.8, generator: torch.Generator, device="cuda") -> dict[str, float]:
    """Monte-Carlo LER of min-sum BP, entirely on ``device``: sampling, the
    decode and the residual-syndrome and logical-parity checks; the counts
    are read once at the end."""
    from tpugnn_torch.baselines.bp import bp_decode
    from tpugnn_torch.eval.ler import count_failures

    dg = graph.to(resolve_device(device))
    fails = torch.zeros((), device=dg.qubit_mask.device)
    syn_mismatch = torch.zeros_like(fails)
    total = 0
    for _ in range(max(1, (shots + batch - 1) // batch)):
        b = sample_batch(generator, dg, p, batch)
        ex_hat, ez_hat = bp_decode(dg, b.syndrome, p, iters=iters, alpha=alpha)
        f = count_failures(dg, b, ex_hat, ez_hat, None)
        fails += f["fail_qubit"].sum()
        syn_mismatch += f["syn_mismatch"].sum()
        total += batch
    ler = float(fails) / total
    return {
        "ler": ler,
        "ler_stderr": (max(ler * (1 - ler), 1e-12) / total) ** 0.5,
        "syn_mismatch_rate": float(syn_mismatch) / total,
        "shots": float(total),
        "decoder": f"bp_minsum(iters={iters}, alpha={alpha})",
    }


def ler_bp_osd(graph: TannerGraph, *, p: float, shots: int, batch: int = 4096,
               iters: int = 32, alpha: float = 0.8, generator: torch.Generator,
               force_python: bool = False, device="cuda") -> dict[str, float]:
    """Monte-Carlo LER of BP + OSD-0 (BP on ``device``, the OSD on the host)."""
    from tpugnn_torch.baselines.osd import BPOSDDecoder

    dec = BPOSDDecoder(graph, p=p, iters=iters, alpha=alpha, force_python=force_python,
                       device=device)
    return _ler_host(graph, dec, f"bp_osd0(iters={iters}, alpha={alpha})", p=p,
                     shots=shots, batch=batch, generator=generator, device=device)
