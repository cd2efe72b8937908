"""GNN decoder: embed -> R fused message rounds -> per-qubit and logical heads.

The port of ``tpugnn.models.decoder.GNNDecoder`` with ``backend='fused'``, run
as ``tpugnn.models.pallas_decoder.PallasDecoder`` runs it: embed and readout
are plain PyTorch GEMMs in f32, and the round loop is one call of
:func:`tpugnn_torch.kernels.fused_decoder.decoder_rounds` (the CUDA kernel on
a card, the plain version on the CPU) with states stored in ``cfg.dtype``.

Parameters keep the flax names and layouts (``embed_check_d0.kernel`` is
[in, out], ``rounds.msg_to_check.w_dst`` ...), so a flax ``'fused'`` tree
loads through :func:`tpugnn_torch.models.convert.params_from_flax`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.kernels.fused_decoder import (
    RoundWeights,
    decoder_rounds,
    make_operators,
)
from tpugnn_torch.tanner.graph import POS_F

__all__ = ["GNNDecoder", "DecoderOutput", "FusedRounds"]


class DecoderOutput(NamedTuple):
    qubit_logits: torch.Tensor                # f32[B, n_pad, 2 | 4]
    logical_logits: Optional[torch.Tensor]    # f32[B, 2k]


class Dense(nn.Module):
    """``x @ kernel + bias`` with a flax-layout kernel [in, out]."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class _Message(nn.Module):
    """One direction's message parameters (flax ``_FusedMessage``)."""

    def __init__(self, h: int, mh: int):
        super().__init__()
        self.w_dst = nn.Parameter(torch.empty(h, mh))
        self.w_src = nn.Parameter(torch.empty(h, mh))
        self.b0 = nn.Parameter(torch.zeros(mh))
        self.w_out = nn.Parameter(torch.empty(mh, h))
        self.b_out = nn.Parameter(torch.zeros(h))


class _LayerNormParams(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(h))
        self.bias = nn.Parameter(torch.zeros(h))


class FusedRounds(nn.Module):
    """Parameters of the weight-tied round (flax ``FusedRoundCell``)."""

    def __init__(self, h: int, mh: int):
        super().__init__()
        self.msg_to_check = _Message(h, mh)
        self.msg_to_qubit = _Message(h, mh)
        self.update_check_d0 = Dense(2 * h + 1, h)   # [state | agg | syndrome]
        self.update_check_d1 = Dense(h, h)
        self.update_qubit_d0 = Dense(2 * h, h)       # [state | agg]
        self.update_qubit_d1 = Dense(h, h)
        self.ln_check = _LayerNormParams(h)
        self.ln_qubit = _LayerNormParams(h)

    def round_weights(self) -> RoundWeights:
        """Kernel layout (``tpugnn.models.pallas_decoder.roundweights_from_flax``)."""
        mc, mq = self.msg_to_check, self.msg_to_qubit
        h = mc.w_dst.shape[0]
        r2 = lambda v: v.reshape(1, -1)
        k0c = self.update_check_d0.kernel
        k0q = self.update_qubit_d0.kernel
        return RoundWeights(
            wd_c=mc.w_dst, ws_c=mc.w_src, b0_c=r2(mc.b0), wo_c=mc.w_out, bo_c=r2(mc.b_out),
            wd_q=mq.w_dst, ws_q=mq.w_src, b0_q=r2(mq.b0), wo_q=mq.w_out, bo_q=r2(mq.b_out),
            uc_x=k0c[:h], uc_a=k0c[h:2 * h], uc_s=k0c[2 * h:],
            uc_b0=r2(self.update_check_d0.bias), uc_w1=self.update_check_d1.kernel,
            uc_b1=r2(self.update_check_d1.bias),
            uq_x=k0q[:h], uq_a=k0q[h:], uq_b0=r2(self.update_qubit_d0.bias),
            uq_w1=self.update_qubit_d1.kernel, uq_b1=r2(self.update_qubit_d1.bias),
            lnc_scale=r2(self.ln_check.scale), lnc_bias=r2(self.ln_check.bias),
            lnq_scale=r2(self.ln_qubit.scale), lnq_bias=r2(self.ln_qubit.bias),
        )


def _mlp2(x, d0: Dense, d1: Dense):
    return d1(torch.relu(d0(x)))


class GNNDecoder(nn.Module):
    """Full decoder over a graph whose arrays are tensors (``TannerGraph.to``)."""

    def __init__(self, cfg: ModelConfig, k: int):
        super().__init__()
        if not cfg.weight_tied or cfg.aggr != "sum" or cfg.update != "mlp":
            raise ValueError("the port runs weight-tied rounds with aggr='sum' "
                             "and update='mlp' only")
        if cfg.backend != "fused":
            raise ValueError(f"the port loads the 'fused' parameter layout, not "
                             f"backend={cfg.backend!r}")
        if cfg.readout not in ("per_qubit", "logical", "both"):
            raise ValueError(f"unknown readout {cfg.readout!r}")
        if cfg.qubit_head not in ("bits", "pauli4"):
            raise ValueError(f"unknown qubit_head {cfg.qubit_head!r}")
        self.cfg = cfg
        self.k = k
        h = cfg.hidden
        self.embed_check_d0 = Dense(3 + POS_F, h)
        self.embed_check_d1 = Dense(h, h)
        self.embed_qubit_d0 = Dense(POS_F, h)
        self.embed_qubit_d1 = Dense(h, h)
        self.rounds = FusedRounds(h, cfg.msg_hidden)
        if cfg.readout in ("per_qubit", "both"):
            self.head_qubit = Dense(h, 4 if cfg.qubit_head == "pauli4" else 2)
        if cfg.readout in ("logical", "both"):
            self.head_logical_d0 = Dense(2 * h, h)
            self.head_logical_d1 = Dense(h, 2 * k)
        self.init_random(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_random(self, generator: torch.Generator, bias_std: float = 0.0):
        """Seeded random weights: matrices N(0, 1/fan_in), vectors
        N(0, bias_std^2) (LayerNorm scales 1 + that noise)."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=generator) / p.shape[0] ** 0.5)
            else:
                base = 1.0 if name.endswith("scale") else 0.0
                p.copy_(base + bias_std * torch.randn(p.shape, generator=generator))
        return self

    def forward(self, graph, syndrome: torch.Tensor) -> DecoderOutput:
        cfg = self.cfg
        batch = syndrome.shape[0]
        m_pad, n_pad = graph.n_checks_pad, graph.n_qubits_pad
        cm, qm = graph.check_mask, graph.qubit_mask

        s_pm = (2.0 * syndrome.float() - 1.0) * cm
        is_x = graph.check_is_x.expand(batch, m_pad)
        pos_c = graph.check_feat.expand(batch, m_pad, graph.check_feat.shape[-1])
        check_in = torch.cat(
            [torch.stack([s_pm, is_x * cm, (1.0 - is_x) * cm], dim=-1), pos_c], dim=-1)
        x_c = _mlp2(check_in, self.embed_check_d0, self.embed_check_d1) * cm[:, None]
        xq0 = _mlp2(graph.qubit_feat, self.embed_qubit_d0, self.embed_qubit_d1)
        x_q = (xq0 * qm[:, None]).expand(batch, n_pad, cfg.hidden)

        x_c, x_q = decoder_rounds(x_c, x_q, s_pm[..., None], make_operators(graph),
                                  self.rounds.round_weights(), cfg.rounds, cfg.dtype)

        qubit_logits = None
        logical_logits = None
        if cfg.readout in ("per_qubit", "both"):
            qubit_logits = self.head_qubit(x_q)
        if cfg.readout in ("logical", "both"):
            qsum = (x_q * qm[:, None]).sum(-2) / graph.n_qubits
            csum = (x_c * cm[:, None]).sum(-2) / graph.n_checks
            pooled = torch.cat([qsum, csum], dim=-1)
            logical_logits = _mlp2(pooled, self.head_logical_d0, self.head_logical_d1)
        if qubit_logits is None:
            qubit_logits = torch.zeros((batch, n_pad, 2), device=syndrome.device)
        return DecoderOutput(qubit_logits=qubit_logits, logical_logits=logical_logits)
