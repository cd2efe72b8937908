"""GNN decoder: embed -> R message rounds -> per-qubit and logical heads.

The port of ``tpugnn.models.decoder.GNNDecoder``.  ``cfg.backend`` picks the
rounds, as in the JAX package:

* ``'fused'``: the fused layout, run as ``tpugnn.models.pallas_decoder.
  PallasDecoder`` runs it.  Embed and readout are plain PyTorch GEMMs in
  f32, and the round loop is one call of
  :func:`tpugnn_torch.kernels.fused_decoder.decoder_rounds` (K1 on a card,
  the plain version on the CPU) with states stored in ``cfg.dtype``; with
  ``weight_tied=False`` R calls of one round, each on its round's weights
  (flax scans ``FusedRoundCell`` so, ``tpugnn/models/decoder.py:162-184``).
  Under autograd the same calls train through the kernels K2a and K2b
  (``tpugnn_torch/kernels/fused_backward.py``).  ``msg_hidden`` may differ
  from ``hidden``: the kernels' packs are zero-padded to the larger.
* ``'segment'``, ``'dense'``, ``'ell'``, ``'pallas'``: the generic
  :class:`RoundCell` (flax ``RoundCell``) on the message-passing engine
  :mod:`tpugnn_torch.mp`, whose ``'pallas'`` aggregation is the kernels K3a
  and K3b (``tpugnn_torch/kernels/spmm.py``).  Embed, rounds and the
  pooled sums run in ``cfg.dtype`` as flax's ``dtype=`` runs them (operands
  cast to it, LayerNorm statistics in f32); the heads in f32.  It trains
  under autograd (``'pallas'`` excepted: K3a/K3b have no backward), with
  ``cfg.remat`` recomputing each round in the backward.  The edge MLPs
  are ``torch.matmul``: keep ``torch.backends.cuda.matmul.allow_tf32`` off
  (PyTorch's default) to stay at the JAX package's f32.

Parameters keep the flax names and layouts (``embed_check_d0.kernel`` is
[in, out], ``rounds.msg_to_check.w_dst``, ``rounds.gru_check.ir.kernel``
...; per-round weights stacked [R, ...] as ``nn.scan`` stores them), so a
flax tree loads through :func:`tpugnn_torch.models.convert.params_from_flax`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.kernels.fused_decoder import (
    STATE_DTYPES,
    RoundWeights,
    decoder_rounds,
    make_operators,
)
from tpugnn_torch.mp import BACKENDS, AGGREGATIONS, NodeStates, bipartite_round, global_node_sum
from tpugnn_torch.tanner.graph import POS_F

__all__ = ["GNNDecoder", "DecoderOutput", "FusedRounds", "RoundCell", "lecun_normal_"]

# flax lecun_normal: a normal truncated at +-2 of its own std, that std
# divided by the std of a unit normal truncated there, so the variance is
# 1 / fan_in
_TRUNC_STD = 0.87962566103423978
_MATRICES = ("kernel", "w_dst", "w_src", "w_out")


class DecoderOutput(NamedTuple):
    qubit_logits: torch.Tensor                # f32[B, n_pad, 2 | 4]
    logical_logits: Optional[torch.Tensor]    # f32[B, 2k]


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal`` in place: fan_in is ``w.shape[-2]``, and leading
    axes (per-round stacks) are independent draws."""
    std = w.shape[-2] ** -0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """``x @ kernel + bias`` with a flax-layout kernel [in, out]; with
    ``stack=(R,)`` one such layer per round, stacked on a leading axis."""

    def __init__(self, fin: int, fout: int, stack: tuple = (), bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*stack, fin, fout))
        self.bias = nn.Parameter(torch.zeros(*stack, fout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                r: Optional[int] = None) -> torch.Tensor:
        """With ``dtype``, flax ``Dense(dtype=...)``: operands cast to it
        (``torch.cat`` of mixed types promotes, as ``jnp.concatenate``
        does), the product and the bias add rounded to it.  ``r`` picks the
        round of a stacked layer."""
        k, b = self.kernel, self.bias
        if r is not None:
            k, b = k[r], (None if b is None else b[r])
        if dtype is not None:
            x, k = x.to(dtype), k.to(dtype)
            b = None if b is None else b.to(dtype)
        y = x @ k
        return y if b is None else y + b


class _Message(nn.Module):
    """One direction's message parameters (flax ``_FusedMessage``)."""

    def __init__(self, h: int, mh: int, stack: tuple = ()):
        super().__init__()
        self.w_dst = nn.Parameter(torch.empty(*stack, h, mh))
        self.w_src = nn.Parameter(torch.empty(*stack, h, mh))
        self.b0 = nn.Parameter(torch.zeros(*stack, mh))
        self.w_out = nn.Parameter(torch.empty(*stack, mh, h))
        self.b_out = nn.Parameter(torch.zeros(*stack, h))


class _LayerNormParams(nn.Module):
    def __init__(self, h: int, stack: tuple = ()):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(*stack, h))
        self.bias = nn.Parameter(torch.zeros(*stack, h))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                r: Optional[int] = None) -> torch.Tensor:
        """flax ``LayerNorm(dtype=...)``: statistics and the affine map in
        f32 (mean of squares minus squared mean, eps 1e-6), the result
        rounded to ``dtype``."""
        scale, bias = self.scale, self.bias
        if r is not None:
            scale, bias = scale[r], bias[r]
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return ((xf - mu) * (torch.rsqrt(var + 1e-6) * scale) + bias).to(dtype)


class FusedRounds(nn.Module):
    """Parameters of the rounds (flax ``FusedRoundCell``): one set shared by
    every round, or with ``rounds`` (``weight_tied=False``) one set per
    round, every leaf stacked [R, ...] as ``nn.scan`` stores it."""

    def __init__(self, h: int, mh: int, rounds: Optional[int] = None):
        super().__init__()
        st = () if rounds is None else (rounds,)
        self.stacked = rounds is not None
        self.msg_to_check = _Message(h, mh, st)
        self.msg_to_qubit = _Message(h, mh, st)
        self.update_check_d0 = Dense(2 * h + 1, h, st)   # [state | agg | syndrome]
        self.update_check_d1 = Dense(h, h, st)
        self.update_qubit_d0 = Dense(2 * h, h, st)       # [state | agg]
        self.update_qubit_d1 = Dense(h, h, st)
        self.ln_check = _LayerNormParams(h, st)
        self.ln_qubit = _LayerNormParams(h, st)

    def round_weights(self, r: Optional[int] = None) -> RoundWeights:
        """Kernel layout (``tpugnn.models.pallas_decoder.roundweights_from_flax``)
        of round ``r``'s weights (per-round weights need ``r``; shared ones
        are every round's)."""
        if self.stacked and r is None:
            raise ValueError("per-round weights: round_weights(r) takes the round")
        at = (lambda t: t[r]) if self.stacked else (lambda t: t)
        mc, mq = self.msg_to_check, self.msg_to_qubit
        h = mc.w_dst.shape[-2]
        r2 = lambda v: at(v).reshape(1, -1)
        k0c = at(self.update_check_d0.kernel)
        k0q = at(self.update_qubit_d0.kernel)
        return RoundWeights(
            wd_c=at(mc.w_dst), ws_c=at(mc.w_src), b0_c=r2(mc.b0), wo_c=at(mc.w_out),
            bo_c=r2(mc.b_out),
            wd_q=at(mq.w_dst), ws_q=at(mq.w_src), b0_q=r2(mq.b0), wo_q=at(mq.w_out),
            bo_q=r2(mq.b_out),
            uc_x=k0c[:h], uc_a=k0c[h:2 * h], uc_s=k0c[2 * h:],
            uc_b0=r2(self.update_check_d0.bias), uc_w1=at(self.update_check_d1.kernel),
            uc_b1=r2(self.update_check_d1.bias),
            uq_x=k0q[:h], uq_a=k0q[h:], uq_b0=r2(self.update_qubit_d0.bias),
            uq_w1=at(self.update_qubit_d1.kernel), uq_b1=r2(self.update_qubit_d1.bias),
            lnc_scale=r2(self.ln_check.scale), lnc_bias=r2(self.ln_check.bias),
            lnq_scale=r2(self.ln_qubit.scale), lnq_bias=r2(self.ln_qubit.bias),
        )

    def run(self, rounds_fn, x_c, x_q, syn, rounds: int):
        """The R rounds through ``rounds_fn(x_c, x_q, syn, weights, n)``,
        which runs ``n`` rounds on one set of weights: one call of all R on
        shared weights, or R calls of one round, each on its round's."""
        if not self.stacked:
            return rounds_fn(x_c, x_q, syn, self.round_weights(), rounds)
        for r in range(rounds):
            x_c, x_q = rounds_fn(x_c, x_q, syn, self.round_weights(r), 1)
        return x_c, x_q


def _mlp2(x, d0: Dense, d1: Dense, dtype: Optional[torch.dtype] = None,
          r: Optional[int] = None):
    return d1(torch.relu(d0(x, dtype, r)), dtype, r)


class GRUCell(nn.Module):
    """flax ``GRUCell``: input kernels ``ir``, ``iz``, ``in`` with bias,
    recurrent ``hr``, ``hz`` without and ``hn`` with bias::

        r = sigmoid(ir(x) + hr(h));  z = sigmoid(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h));  h' = (1 - z) n + z h
    """

    def __init__(self, fin: int, h: int, stack: tuple = ()):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(fin, h, stack))
        for name in ("hr", "hz"):
            self.add_module(name, Dense(h, h, stack, bias=False))
        self.add_module("hn", Dense(h, h, stack))

    def forward(self, h: torch.Tensor, x: torch.Tensor, dtype: torch.dtype,
                r: Optional[int]) -> torch.Tensor:
        d = lambda name, v: self._modules[name](v, dtype, r)
        rg = torch.sigmoid(d("ir", x) + d("hr", h))
        z = torch.sigmoid(d("iz", x) + d("hz", h))
        n = torch.tanh(d("in", x) + rg * d("hn", h))
        return (1.0 - z) * n + z * h


class RoundCell(nn.Module):
    """One generic round (flax ``RoundCell``): the edge MLPs
    ``msg_to_qubit``/``msg_to_check`` over ``concat([xc_e, xq_e])``, the
    engine's aggregation (``cfg.aggr`` on ``cfg.backend``), then the node
    updates: residual MLP over ``[x | agg | syndrome]`` (checks) or
    ``[x | agg]`` (qubits) and LayerNorm for ``update='mlp'``, GRU cells
    over ``[agg | syndrome]`` / ``agg`` for ``update='gru'``.  Without
    ``weight_tied`` every weight is stacked [R, ...] and round ``r`` reads
    its slice."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        h, mh = cfg.hidden, cfg.msg_hidden
        st = () if cfg.weight_tied else (cfg.rounds,)
        self.msg_to_qubit_d0 = Dense(2 * h, mh, st)
        self.msg_to_qubit_d1 = Dense(mh, h, st)
        self.msg_to_check_d0 = Dense(2 * h, mh, st)
        self.msg_to_check_d1 = Dense(mh, h, st)
        if cfg.update == "gru":
            self.gru_check = GRUCell(h + 1, h, st)
            self.gru_qubit = GRUCell(h, h, st)
        else:
            self.update_check_d0 = Dense(2 * h + 1, h, st)
            self.update_check_d1 = Dense(h, h, st)
            self.update_qubit_d0 = Dense(2 * h, h, st)
            self.update_qubit_d1 = Dense(h, h, st)
            self.ln_check = _LayerNormParams(h, st)
            self.ln_qubit = _LayerNormParams(h, st)

    def forward(self, graph, state: NodeStates, syn_feat: torch.Tensor,
                r: int) -> NodeStates:
        cfg = self.cfg
        dt = STATE_DTYPES[cfg.dtype]
        rr = None if cfg.weight_tied else r

        def message(d0, d1):
            return lambda xc_e, xq_e, _: _mlp2(torch.cat([xc_e, xq_e], -1), d0, d1, dt, rr)

        if cfg.update == "gru":
            def update_check(x, agg):
                return self.gru_check(x, torch.cat([agg, syn_feat], -1), dt, rr)

            def update_qubit(x, agg):
                return self.gru_qubit(x, agg, dt, rr)
        else:
            def update_check(x, agg):
                u = _mlp2(torch.cat([x, agg, syn_feat], -1), self.update_check_d0,
                          self.update_check_d1, dt, rr)
                return self.ln_check(x + u, dt, rr)

            def update_qubit(x, agg):
                u = _mlp2(torch.cat([x, agg], -1), self.update_qubit_d0,
                          self.update_qubit_d1, dt, rr)
                return self.ln_qubit(x + u, dt, rr)

        return bipartite_round(
            graph, state,
            message_to_qubit=message(self.msg_to_qubit_d0, self.msg_to_qubit_d1),
            message_to_check=message(self.msg_to_check_d0, self.msg_to_check_d1),
            update_check=update_check, update_qubit=update_qubit,
            aggr=cfg.aggr, backend=cfg.backend)


class GNNDecoder(nn.Module):
    """Full decoder over a graph whose arrays are tensors (``TannerGraph.to``)."""

    def __init__(self, cfg: ModelConfig, k: int):
        super().__init__()
        if cfg.readout not in ("per_qubit", "logical", "both"):
            raise ValueError(f"unknown readout {cfg.readout!r}")
        if cfg.qubit_head not in ("bits", "pauli4"):
            raise ValueError(f"unknown qubit_head {cfg.qubit_head!r}")
        if cfg.dtype not in STATE_DTYPES:
            raise ValueError(f"unknown dtype {cfg.dtype!r}; have {sorted(STATE_DTYPES)}")
        if cfg.aggr not in AGGREGATIONS:
            raise ValueError(f"unknown aggregation {cfg.aggr!r}; have {AGGREGATIONS}")
        if cfg.update not in ("mlp", "gru"):
            raise ValueError(f"unknown update {cfg.update!r}; have mlp|gru")
        h = cfg.hidden
        if cfg.backend == "fused":
            if cfg.aggr != "sum" or cfg.update != "mlp":
                raise ValueError("backend='fused' runs rounds with aggr='sum' and "
                                 "update='mlp' (use a generic backend, "
                                 f"{BACKENDS}, for the others)")
            rounds = FusedRounds(h, cfg.msg_hidden,
                                 None if cfg.weight_tied else cfg.rounds)
        elif cfg.backend in BACKENDS:
            rounds = RoundCell(cfg)
        else:
            raise ValueError(f"unknown backend {cfg.backend!r}; have "
                             f"{('fused',) + BACKENDS}")
        self.cfg = cfg
        self.k = k
        self.embed_check_d0 = Dense(3 + POS_F, h)
        self.embed_check_d1 = Dense(h, h)
        self.embed_qubit_d0 = Dense(POS_F, h)
        self.embed_qubit_d1 = Dense(h, h)
        self.rounds = rounds
        if cfg.readout in ("per_qubit", "both"):
            self.head_qubit = Dense(h, 4 if cfg.qubit_head == "pauli4" else 2)
        if cfg.readout in ("logical", "both"):
            self.head_logical_d0 = Dense(2 * h, h)
            self.head_logical_d1 = Dense(h, 2 * k)
        self.init_random(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_random(self, generator: torch.Generator, bias_std: float = 0.0):
        """Seeded random weights as flax draws them: Dense kernels and the
        fused message matrices ``lecun_normal``, the GRU recurrent kernels
        (``hr``, ``hz``, ``hn``) orthogonal, biases 0 and LayerNorm scales 1.
        ``bias_std`` adds N(0, bias_std^2) to every vector, so that every
        term of a random model is exercised."""
        for name, p in self.named_parameters():
            parts = name.split(".")
            if parts[-1] == "kernel" and parts[-2] in ("hr", "hz", "hn"):
                for w in p.view(-1, *p.shape[-2:]):
                    nn.init.orthogonal_(w, generator=generator)
            elif parts[-1] in _MATRICES:
                lecun_normal_(p, generator)
            else:
                base = 1.0 if parts[-1] == "scale" else 0.0
                p.copy_(base + bias_std * torch.randn(p.shape, generator=generator))
        return self

    def embed(self, graph, syndrome: torch.Tensor):
        """The node states the rounds start from and the +-1 syndrome
        feature: ``(x_c [B, m_pad, H], x_q [B, n_pad, H], s_pm [B, m_pad])``,
        padded rows zero."""
        cfg = self.cfg
        batch = syndrome.shape[0]
        m_pad, n_pad = graph.n_checks_pad, graph.n_qubits_pad
        fused = cfg.backend == "fused"
        # the fused layout embeds in f32 (PallasDecoder); the generic engine
        # in cfg.dtype (flax GNNDecoder)
        dt = torch.float32 if fused else STATE_DTYPES[cfg.dtype]
        cast = None if fused else dt
        cm, qm = graph.check_mask.to(dt), graph.qubit_mask.to(dt)

        s_pm = (2.0 * syndrome.to(dt) - 1.0) * cm
        is_x = graph.check_is_x.to(dt).expand(batch, m_pad)
        pos_c = graph.check_feat.to(dt).expand(batch, m_pad, graph.check_feat.shape[-1])
        check_in = torch.cat(
            [torch.stack([s_pm, is_x * cm, (1.0 - is_x) * cm], dim=-1), pos_c], dim=-1)
        x_c = _mlp2(check_in, self.embed_check_d0, self.embed_check_d1, cast) * cm[:, None]
        xq0 = _mlp2(graph.qubit_feat.to(dt), self.embed_qubit_d0, self.embed_qubit_d1, cast)
        x_q = (xq0 * qm[:, None]).expand(batch, n_pad, cfg.hidden)
        return x_c, x_q, s_pm

    def readout(self, graph, x_c: torch.Tensor, x_q: torch.Tensor) -> DecoderOutput:
        """The heads on the states after the rounds."""
        cfg = self.cfg
        qubit_logits = None
        logical_logits = None
        if cfg.readout in ("per_qubit", "both"):
            qubit_logits = self.head_qubit(x_q.float())
        if cfg.readout in ("logical", "both"):
            # summed over the shards too on a partitioned view
            qsum = global_node_sum(graph, x_q, which="qubit") / graph.n_qubits
            csum = global_node_sum(graph, x_c, which="check") / graph.n_checks
            pooled = torch.cat([qsum, csum], dim=-1)
            logical_logits = _mlp2(pooled, self.head_logical_d0, self.head_logical_d1)
        if qubit_logits is None:
            qubit_logits = torch.zeros((x_q.shape[0], graph.n_qubits_pad, 2),
                                       device=x_q.device)
        return DecoderOutput(qubit_logits=qubit_logits, logical_logits=logical_logits)

    def forward(self, graph, syndrome: torch.Tensor) -> DecoderOutput:
        cfg = self.cfg
        if cfg.backend in ("fused", "pallas") and getattr(graph, "partitioned", False):
            raise ValueError(
                f"backend={cfg.backend!r} has no partitioned rounds: a shard's view runs "
                "the generic rounds ('segment'); convert fused weights with "
                "tpugnn_torch.models.fused_cell.convert_fused_round_params "
                "(load_decoder(..., backend='segment') does so)")
        x_c, x_q, s_pm = self.embed(graph, syndrome)
        if cfg.backend == "fused":
            ops = make_operators(graph)
            x_c, x_q = self.rounds.run(
                lambda xc, xq, syn, w, n: decoder_rounds(xc, xq, syn, ops, w, n, cfg.dtype),
                x_c, x_q, s_pm[..., None], cfg.rounds)
        else:
            state = NodeStates(check=x_c, qubit=x_q)
            # remat (tpugnn/models/decoder.py:168-171): each round's
            # activations are recomputed in the backward, not kept
            remat = cfg.remat and torch.is_grad_enabled()
            for r in range(cfg.rounds):
                if remat:
                    state = checkpoint(self.rounds, graph, state, s_pm[..., None], r,
                                       use_reentrant=False, preserve_rng_state=False)
                else:
                    state = self.rounds(graph, state, s_pm[..., None], r)
            x_c, x_q = state
        return self.readout(graph, x_c, x_q)
