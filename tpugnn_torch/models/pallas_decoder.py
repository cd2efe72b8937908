"""PallasDecoder: the decode of a fused-layout model on a chosen rounds kernel.

The port of ``tpugnn.models.pallas_decoder.PallasDecoder`` for inference.
It wraps a :class:`~tpugnn_torch.models.decoder.GNNDecoder` with
``backend='fused'`` and shares its parameters; embed and readout are the
model's own (:meth:`GNNDecoder.embed`, :meth:`GNNDecoder.readout`).  The
``schedule`` picks the rounds, as ``tpugnn/models/pallas_decoder.py:89-96,
155-192`` does:

* ``None`` (or no ``'rollgather'``): the fused rounds
  (:func:`~tpugnn_torch.kernels.fused_decoder.decoder_rounds`: K1 on a
  card), the same function the model runs itself;
* ``('rollgather',)``: the roll rounds on the surface code's raster
  (:func:`~tpugnn_torch.kernels.roll_gather.decoder_rounds_roll`: K5 on a
  card), with f32 slot sums; ``('rollgather', 'slot16')`` keeps the slot
  stage in the state type.  Where the raster plan does not apply (not an
  open-boundary rotated surface code, or padding other than the default)
  it runs the fused rounds, as the JAX package does.

The roll rounds are inference only: under autograd a ``'rollgather'``
schedule raises.  The TPU kernel's other schedule variants (``'sumrelu'``,
``'fold'``, ``'biggather'``) are exact rewrites of K1's function for the
TPU and are not ported; naming them raises.
"""

from __future__ import annotations

import torch
from torch import nn

from tpugnn_torch.kernels.fused_decoder import _needs_grad, decoder_rounds, make_operators
from tpugnn_torch.kernels.roll_gather import decoder_rounds_roll, plan_for_graph
from tpugnn_torch.models.decoder import DecoderOutput, GNNDecoder

__all__ = ["PallasDecoder", "SCHEDULE_NAMES"]

SCHEDULE_NAMES = ("rollgather", "slot16")


class PallasDecoder(nn.Module):
    """``PallasDecoder(model, schedule)(graph, syndrome) -> DecoderOutput``,
    callable wherever a model is (``ler_monte_carlo``, ``DecodeEngine``)."""

    def __init__(self, model: GNNDecoder, schedule: tuple | None = None):
        super().__init__()
        if model.cfg.backend != "fused":
            raise ValueError("PallasDecoder runs a fused-layout model (backend='fused'), "
                             f"got backend={model.cfg.backend!r}")
        if not model.cfg.weight_tied:
            # tpugnn/models/pallas_decoder.py:66 refuses them too; the
            # model itself runs them, a round's weights at a time
            raise ValueError("PallasDecoder supports weight-tied rounds only")
        schedule = tuple(schedule or ())
        unknown = [s for s in schedule if s not in SCHEDULE_NAMES]
        if unknown:
            raise ValueError(f"unknown schedule names {unknown}; the port has "
                             f"{SCHEDULE_NAMES} (the TPU variants of K1 are exact "
                             "rewrites of its function and are not ported)")
        if "slot16" in schedule and "rollgather" not in schedule:
            raise ValueError("'slot16' sets the slot type of 'rollgather' and "
                             "needs it in the schedule")
        self.model = model
        self.schedule = schedule

    def forward(self, graph, syndrome: torch.Tensor) -> DecoderOutput:
        cfg = self.model.cfg
        x_c, x_q, s_pm = self.model.embed(graph, syndrome)
        syn = s_pm[..., None]
        w = self.model.rounds.round_weights()
        roll = "rollgather" in self.schedule
        if roll and _needs_grad(x_c, x_q, syn, w):
            raise RuntimeError("the 'rollgather' schedule is inference only: call "
                               "PallasDecoder under torch.no_grad() or "
                               "torch.inference_mode(), and train the model itself")
        plan = plan_for_graph(graph) if roll else None
        if plan is None:
            x_c, x_q = decoder_rounds(x_c, x_q, syn, make_operators(graph), w,
                                      cfg.rounds, cfg.dtype)
        else:
            slot = "bfloat16" if "slot16" in self.schedule else "float32"
            x_c, x_q = decoder_rounds_roll(x_c, x_q, syn, plan, w, rounds=cfg.rounds,
                                           state_dtype=cfg.dtype, slot_dtype=slot)
        return self.model.readout(graph, x_c, x_q)
