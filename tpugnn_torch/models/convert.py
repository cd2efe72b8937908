"""Flax parameter trees -> the port's modules, and the shipped weights files.

The weights of the JAX decoder are a nested dict of arrays: the flax tree of
the ``'fused'`` layout or of the generic ``RoundCell`` (with its GRU leaves,
and per-round leaves stacked [R, ...] when the rounds are not weight-tied).
``params_from_flax`` maps either tree, given as nested dicts of NumPy
arrays, onto the state dict of :class:`tpugnn_torch.models.decoder.GNNDecoder`,
whose parameters keep the flax names and layouts (Dense kernels are
[in, out]).  ``load_npz`` reads a weights file written by
``scripts/export_torch_weights.py``: the tree flattened to ``'/'``-joined
keys, which ``state_dict_from_flat`` maps onto the module, plus a
``__meta__`` JSON record of the checkpoint step and config.
``load_decoder(path, backend=...)`` loads such a file into either layout,
converting the rounds' parameters (``tpugnn_torch.models.fused_cell``), on
the graph the file names: the code graph of ``code``, or, where the record
has a ``graph`` entry, the detector graph it describes, phenomenological
or circuit-level (:func:`graph_of_meta`).  Reading needs NumPy only.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig

__all__ = ["flatten_tree", "state_dict_from_flat", "params_from_flax", "load_npz",
           "read_meta", "columns_path", "read_columns", "convert_flat_layout", "load_decoder",
           "graph_of_meta", "DEFAULT_WEIGHTS", "TORIC_D7_WEIGHTS", "DETECTOR_D5_WEIGHTS",
           "STREAM_D5_WEIGHTS"]

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets")
# the trained d=11 surface-code flagship (runs/v3_surface_d11/ema, step 40000)
DEFAULT_WEIGHTS = os.path.join(_ASSETS, "surface_d11_h128_r14_ema40000.npz")
# the trained d=7 toric code (runs/r2_toric_d7/ema, step 8000)
TORIC_D7_WEIGHTS = os.path.join(_ASSETS, "toric_d7_h128_r10_ema8000.npz")
# the phenomenological detector graph of surface d=5 over 5 rounds
# (runs/spacetime_surface_d5_t5, step 4000), and its twin trained for
# sliding windows with round-0 faults at twice the rate
# (runs/spacetime_surface_d5_t5_w, step 4000)
DETECTOR_D5_WEIGHTS = os.path.join(_ASSETS, "spacetime_surface_d5_t5_h96_r8_4000.npz")
STREAM_D5_WEIGHTS = os.path.join(_ASSETS, "spacetime_surface_d5_t5_w_h96_r8_4000.npz")


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


def columns_path(path: str = DEFAULT_WEIGHTS) -> str:
    """The sidecar of a weights file (``x.npz`` -> ``x.columns.json``):
    the JAX package's f32 hybrid LER columns of those weights
    (``scripts/export_torch_weights.py --columns-shots``)."""
    return path.removesuffix(".npz") + ".columns.json"


def read_columns(path: str = DEFAULT_WEIGHTS) -> dict:
    """The columns sidecar of a weights file: step, config, p, shots, seed
    and ``columns`` (``ler``, ``ler_logical``, ``ler_hybrid``, ``gnn_uf``,
    ``gnn_mwpm``, ``gnn_best_of``, ``uf``, ``mwpm``)."""
    with open(columns_path(path)) as f:
        return json.load(f)


def load_npz(path: str = DEFAULT_WEIGHTS) -> tuple[ExperimentConfig, dict, int]:
    """Read a weights file: ``(config, {'params/a/b': NumPy array}, step)``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    cfg = ExperimentConfig(code=CodeConfig(**meta["code"]),
                           model=ModelConfig(**meta["model"]))
    return cfg, flat, int(meta["step"])


def graph_of_meta(meta: dict):
    """The NumPy ``TannerGraph`` a weights file's ``__meta__`` record names:
    ``build_code`` of its ``code`` entry, or, where it has a ``graph`` entry,
    that detector graph of the code's family and distance: of kind
    ``'spacetime'`` (``d_t``, ``sector``, ``meas_ratio``, ``t0_scale``) with
    the noise rates the weights were trained on, or of kind ``'circuit'``
    (``d_t``, ``sector``), the circuit-level graph of ``tanner/circuit.py``."""
    from tpugnn_torch.tanner import build_circuit_code, build_code, build_spacetime_code

    code = meta["code"]
    pads = dict(pad_nodes=code["pad_nodes"], pad_edges=code["pad_edges"])
    g = meta.get("graph")
    if g is None:
        return build_code(code["family"], code["distance"], **pads)
    if g.get("kind") == "circuit":
        return build_circuit_code(code["family"], code["distance"], g["d_t"],
                                  sector=g["sector"], **pads)
    if g.get("kind") != "spacetime":
        raise ValueError(f"unknown graph kind in the weights file: {g}")
    return build_spacetime_code(code["family"], code["distance"], g["d_t"],
                                sector=g["sector"], meas_ratio=g["meas_ratio"],
                                t0_scale=g["t0_scale"], **pads)


def _layout(backend: str) -> str:
    return "fused" if backend == "fused" else "generic"


def convert_flat_layout(flat: dict, src_backend: str, dst_backend: str) -> dict:
    """Flat parameters (``'params/rounds/...'`` keys) of a model with
    ``src_backend`` -> those of one with ``dst_backend``: the rounds'
    subtree goes through ``convert_fused_round_params`` or
    ``convert_generic_round_params`` when the two layouts differ."""
    from tpugnn_torch.models.fused_cell import (
        convert_fused_round_params,
        convert_generic_round_params,
    )

    src, dst = _layout(src_backend), _layout(dst_backend)
    if src == dst:
        return dict(flat)
    prefix = "params/rounds/" if any(k.startswith("params/") for k in flat) else "rounds/"
    rounds: dict = {}
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            out[k] = v
            continue
        node = rounds
        *path, leaf = k[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    conv = convert_fused_round_params if src == "fused" else convert_generic_round_params
    out.update(flatten_tree(conv(rounds), prefix.rstrip("/")))
    return out


def load_decoder(path: str = DEFAULT_WEIGHTS, device="cuda", backend: str | None = None):
    """Entry point: ``(config, GNNDecoder on device, TannerGraph)`` from a
    weights file, on the graph its record names (:func:`graph_of_meta`: the
    code graph or a detector graph).  The model is in eval mode.
    ``backend`` (default: the file's) picks the rounds: ``'fused'`` for the
    fused kernels K1/K2, ``'segment'``, ``'dense'``, ``'ell'`` or
    ``'pallas'`` for the generic engine (``'pallas'``: the kernels
    K3a/K3b); the parameters are converted between the layouts."""
    from tpugnn_torch.models.decoder import GNNDecoder
    from tpugnn_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, flat, _ = load_npz(path)
    if backend is not None:
        flat = convert_flat_layout(flat, cfg.model.backend, backend)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, backend=backend))
    graph = graph_of_meta(read_meta(path))
    model = GNNDecoder(cfg.model, k=graph.k)
    model.load_state_dict(state_dict_from_flat(flat))
    return cfg, model.to(dev).eval(), graph
