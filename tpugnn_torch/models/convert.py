"""Flax parameter trees -> the port's modules, and the shipped weights file.

The weights of the JAX decoder are a nested dict of arrays (the flax
``'fused'``-backend tree).  ``params_from_flax`` maps that tree, given as
nested dicts of NumPy arrays, onto the state dict of
:class:`tpugnn_torch.models.decoder.GNNDecoder`, whose parameters keep the
flax names and layouts (Dense kernels are [in, out]).  ``load_npz`` reads a
weights file written by ``scripts/export_torch_weights.py``: the tree
flattened to ``'/'``-joined keys, which ``state_dict_from_flat`` maps onto
the module, plus a ``__meta__`` JSON record of the checkpoint step and
config.  Reading needs NumPy only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig

__all__ = ["flatten_tree", "state_dict_from_flat", "params_from_flax", "load_npz",
           "read_meta", "load_decoder", "DEFAULT_WEIGHTS"]

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
    "surface_d11_h128_r14_ema40000.npz")


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {'a/b/c': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def state_dict_from_flat(flat: dict) -> dict:
    """``{'params/a/b': array}`` (the flattened flax tree, with or without
    the top-level ``'params'``) -> a state dict of ``GNNDecoder``."""
    return {k.removeprefix("params/").replace("/", "."):
            torch.tensor(np.asarray(v, np.float32)) for k, v in flat.items()}


def params_from_flax(tree: dict) -> dict:
    """Flax ``'fused'`` parameter tree (nested dicts of arrays, with or
    without the top-level ``'params'``) -> a state dict of ``GNNDecoder``."""
    return state_dict_from_flat(flatten_tree(tree))


def read_meta(path: str = DEFAULT_WEIGHTS) -> dict:
    """The ``__meta__`` record of a weights file: step, source, config and,
    where the exporter measured it, ``ler_reference``."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def load_npz(path: str = DEFAULT_WEIGHTS) -> tuple[ExperimentConfig, dict, int]:
    """Read a weights file: ``(config, {'params/a/b': NumPy array}, step)``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    cfg = ExperimentConfig(code=CodeConfig(**meta["code"]),
                           model=ModelConfig(**meta["model"]))
    return cfg, flat, int(meta["step"])


def load_decoder(path: str = DEFAULT_WEIGHTS, device="cuda"):
    """Entry point: ``(config, GNNDecoder on device, TannerGraph)`` from a
    weights file.  The model is in eval mode."""
    from tpugnn_torch.models.decoder import GNNDecoder
    from tpugnn_torch.tanner import build_code
    from tpugnn_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, flat, _ = load_npz(path)
    graph = build_code(cfg.code.family, cfg.code.distance,
                       pad_nodes=cfg.code.pad_nodes, pad_edges=cfg.code.pad_edges)
    model = GNNDecoder(cfg.model, k=graph.k)
    model.load_state_dict(state_dict_from_flat(flat))
    return cfg, model.to(dev).eval(), graph
