"""Normalized min-sum belief propagation, in tensor ops on the graph's device.

The port of ``tpugnn.baselines.bp``.  Messages live on the padded canonical
edge list ([B, E_pad] f32).  The check update's excluding-self sign and
minimum and the qubit update's excluding-self sums go through the ELL slot
tables of the graph, so a decode is a fixed number of iterations of gathers
and masked slot reductions, with no scatter and no data-dependent control
flow.  Both CSS sectors share one message array (every edge belongs to one
check, and per-sector masked sums keep the beliefs apart): X-type checks
constrain ``ez``, Z-type checks ``ex``.

As in JAX, this is plain array code outside any kernel: a Python loop of
``iters`` tensor steps.  Ties resolve as JAX resolves them
(``torch.argmin`` returns the first minimum); the masked-slot sentinel
``_BIG`` and the magnitude cap of 20 are JAX's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpugnn_torch.tanner.graph import TannerGraph

__all__ = ["bp_decode", "bp_posteriors"]

_BIG = 1e9    # sentinel magnitude of a masked slot
_CAP = 20.0   # magnitude cap of a check message


def _prior_llr(graph: TannerGraph, p) -> torch.Tensor:
    """Per-qubit prior LLR log((1-q)/q) of one Pauli component, f32[n_pad]:
    q = 2p/3 under depolarizing noise (that component or Y), p * rate_scale
    on a detector graph."""
    if graph.rate_scale is not None:
        q = p * graph.rate_scale
    else:
        q = torch.full((graph.n_qubits_pad,), 2.0 * p / 3.0, dtype=torch.float32,
                       device=graph.qubit_mask.device)
    q = torch.clamp(q, 1e-9, 0.5 - 1e-6)
    return torch.log((1.0 - q) / q).float()


def _edge_to_slot(graph: TannerGraph) -> torch.Tensor:
    """i64[E_pad]: the flattened (row, slot) position of each canonical edge
    in the check ELL table (the inverse of ``ell_check_edge``; a padded edge
    points at a masked slot, whose value is 0)."""
    flat = graph.ell_check_edge.reshape(-1).long()
    e_pad = graph.edge_check.shape[0]
    order = torch.argsort(flat, stable=True)
    pos = torch.searchsorted(flat[order], torch.arange(e_pad, device=flat.device))
    return order[pos.clamp(0, flat.numel() - 1)]


@torch.inference_mode()
def bp_posteriors(graph: TannerGraph, syndrome: torch.Tensor, p, *, iters: int = 32,
                  alpha: float = 0.8) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior LLRs ``(L_ex, L_ez)``, each f32[B, n_pad]; negative means
    flip.  ``graph`` holds tensors (``TannerGraph.to``) on the syndrome's
    device; ``syndrome`` is [B, m_pad] in {0, 1}."""
    ec, eq = graph.edge_check.long(), graph.edge_qubit.long()
    emask = graph.edge_mask.float()
    is_x = graph.check_is_x.float()[ec]
    sec_x = is_x * emask                     # edges of X-type checks (constrain ez)
    sec_z = (1.0 - is_x) * emask
    lam = _prior_llr(graph, p)
    lam_e = lam[eq]
    syn_sign = 1.0 - 2.0 * syndrome.float()[:, ec]                 # [B, E]
    ell_c, mask_c = graph.ell_check_edge.long(), graph.ell_check_mask.float()
    ell_q, mask_q = graph.ell_qubit_edge.long(), graph.ell_qubit_mask.float()
    inv = _edge_to_slot(graph)
    real_c = mask_c > 0.5

    def qubit_sums(msg):
        """Per-sector sums of the incoming check messages per qubit."""
        sx = ((msg * sec_x)[:, ell_q] * mask_q).sum(-1)
        sz = ((msg * sec_z)[:, ell_q] * mask_q).sum(-1)
        return sx, sz

    msg = torch.zeros((syndrome.shape[0], ec.shape[0]), dtype=torch.float32,
                      device=syndrome.device)
    for _ in range(iters):
        # qubit -> check: prior + same-sector sum excluding self
        sx, sz = qubit_sums(msg)
        q_msg = lam_e + (sec_x * sx[:, eq] + sec_z * sz[:, eq]) - msg
        # check -> qubit: normalized min-sum excluding self
        qs = q_msg[:, ell_c]                                        # [B, m, Dc]
        mag = qs.abs() * mask_c + _BIG * (1.0 - mask_c)
        neg = (qs < 0.0) & real_c
        n_neg = neg.sum(-1, keepdim=True)
        sgn = 1.0 - 2.0 * torch.remainder(n_neg - neg.long(), 2).float()
        m1 = mag.amin(-1, keepdim=True)
        is_min = F.one_hot(mag.argmin(-1), mag.shape[-1]).float()
        m2 = (mag + _BIG * is_min).amin(-1, keepdim=True)
        excl = torch.where(is_min > 0.5, m2, m1)
        # degree-1 rows (detector-graph boundaries) have no other neighbour:
        # their parity pins the qubit, as a strong but finite LLR
        out = alpha * sgn * torch.clamp(excl, max=_CAP)
        flat = (out * mask_c).reshape(out.shape[0], -1)
        msg = flat[:, inv] * syn_sign * emask
    sx, sz = qubit_sums(msg)
    return lam[None] + sz, lam[None] + sx    # L_ex (Z checks), L_ez (X checks)


@torch.inference_mode()
def bp_decode(graph: TannerGraph, syndrome: torch.Tensor, p, *, iters: int = 32,
              alpha: float = 0.8) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard-decision corrections ``(ex_hat, ez_hat)``, each f32[B, n_pad]."""
    l_ex, l_ez = bp_posteriors(graph, syndrome, p, iters=iters, alpha=alpha)
    qm = graph.qubit_mask[None].float()
    return (l_ex < 0.0).float() * qm, (l_ez < 0.0).float() * qm
