"""Parameter conversion between the fused and the generic round layouts.

The port of ``convert_generic_round_params`` and
``convert_fused_round_params`` (``tpugnn/models/fused_cell.py:150``,
``:183``) on nested dicts of NumPy arrays or torch tensors.  The generic
round's first message layer reads ``concat([xc_e, xq_e])`` in both
directions, so its kernel [2H, MH] (or [R, 2H, MH] per round) is the check
endpoint's rows over the qubit endpoint's: ``msg_to_check`` has ``w_dst`` on
top, ``msg_to_qubit`` has ``w_src`` on top.  Exact in both directions.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_generic_round_params", "convert_fused_round_params"]


def _concat_rows(top, bot):
    if isinstance(top, torch.Tensor):
        return torch.cat([top, bot], dim=-2)
    return np.concatenate([top, bot], axis=-2)


def convert_generic_round_params(round_params: dict) -> dict:
    """Generic ``RoundCell`` round subtree -> the fused layout
    (``msg_to_check/{w_dst, w_src, b0, w_out, b_out}`` and the same for
    ``msg_to_qubit``); every other leaf is kept."""
    out = dict(round_params)
    for dname in ("msg_to_check", "msg_to_qubit"):
        d0 = out.pop(f"{dname}_d0")
        d1 = out.pop(f"{dname}_d1")
        k0 = d0["kernel"]
        h = k0.shape[-2] // 2
        top, bot = k0[..., :h, :], k0[..., h:, :]
        w_dst, w_src = (top, bot) if dname == "msg_to_check" else (bot, top)
        out[dname] = {"w_dst": w_dst, "w_src": w_src, "b0": d0["bias"],
                      "w_out": d1["kernel"], "b_out": d1["bias"]}
    return out


def convert_fused_round_params(round_params: dict) -> dict:
    """Inverse of :func:`convert_generic_round_params`: a fused round
    subtree (every trained flagship) -> the generic layout."""
    out = dict(round_params)
    for dname in ("msg_to_check", "msg_to_qubit"):
        f = dict(out.pop(dname))
        if dname == "msg_to_check":
            top, bot = f["w_dst"], f["w_src"]
        else:
            top, bot = f["w_src"], f["w_dst"]
        out[f"{dname}_d0"] = {"kernel": _concat_rows(top, bot), "bias": f["b0"]}
        out[f"{dname}_d1"] = {"kernel": f["w_out"], "bias": f["b_out"]}
    return out
