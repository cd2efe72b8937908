"""Training loop of the decoder (the port of ``tpugnn/train/loop.py``).

One step samples a batch on the device from an explicit
``torch.Generator``, runs the decoder, the loss and the backward, and applies
the optimizer.  ``backend='pallas'`` (or ``'fused'``) trains the fused
layout: the rounds' forward and backward are the kernels K2a and K2b on a
card (:class:`~tpugnn_torch.kernels.fused_backward.FusedRoundsFn`), embed,
heads and loss plain PyTorch in f32.  ``'segment'``, ``'dense'`` and
``'ell'`` train the generic ``RoundCell`` on the message-passing engine under
autograd, as the JAX package trains its flax module directly
(``tpugnn/train/loop.py:97-113``); ``remat`` recomputes each round in the
backward (``torch.utils.checkpoint``).  The loop adds an EMA of the
parameters, Monte-Carlo evaluation every ``eval_every`` steps through
:func:`~tpugnn_torch.eval.ler.ler_monte_carlo`, checkpoints, and a warm
start from ``init_from``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpugnn_torch.configs import ExperimentConfig
from tpugnn_torch.eval.ler import ler_monte_carlo
from tpugnn_torch.models.decoder import GNNDecoder
from tpugnn_torch.sampling.noise import SyndromeBatch, sample_batch, training_rate
from tpugnn_torch.tanner import build_code
from tpugnn_torch.train.checkpoint import CheckpointManager
from tpugnn_torch.train.optim import OptaxAdamW, make_optimizer
from tpugnn_torch.utils.device import resolve_device
from tpugnn_torch.utils.metrics import MetricLogger, profile
from tpugnn_torch.utils.timing import hard_sync

__all__ = ["TrainState", "loss_fn", "loss_terms", "train_step", "ema_update", "init_params_from",
           "train_model_config", "init_state", "train"]


@dataclass
class TrainState:
    """What a run carries from step to step; ``step`` counts finished steps."""

    model: GNNDecoder
    optimizer: OptaxAdamW
    generator: torch.Generator
    step: int
    ema: Optional[GNNDecoder] = None


def loss_fn(model: GNNDecoder, graph, batch: SyndromeBatch, cfg: ExperimentConfig):
    """Masked per-qubit loss plus logical BCE (``tpugnn/train/loop.py:43-80``).

    pauli4 head: softmax cross entropy over [I, X, Z, Y] with the class
    ex + 2 ez; bits head: BCE on (ex, ez).  Both are summed over real qubits
    and divided by B * n_qubits (* 2 for bits).  The logical head adds the
    mean BCE of its class bits.  ``graph`` holds tensors on the model's
    device.  Returns ``(total, metrics)``; the metrics are tensors."""
    out = model(graph, batch.syndrome)
    qm = (torch.arange(graph.n_qubits_pad, device=batch.ex.device) < graph.n_qubits).float()
    return loss_terms(out, batch, qm, graph.n_qubits, cfg)


def loss_terms(out, batch: SyndromeBatch, qm: torch.Tensor, n: int, cfg: ExperimentConfig,
               logical_share: float = 1.0):
    """:func:`loss_fn`'s terms on a decoder output: ``qm`` masks the real
    qubits of ``batch``'s columns, ``n`` is the code's real qubit count.  A
    shard of a partitioned graph passes its own qubit columns and
    ``logical_share = 1 / shards``, so that the shards' losses sum to the
    whole graph's (:mod:`tpugnn_torch.dist.api`)."""
    b = batch.syndrome.shape[0]
    total = torch.zeros((), device=batch.ex.device)
    metrics = {}
    if out.qubit_logits is not None and cfg.train.loss_qubit_weight:
        logits = out.qubit_logits
        if logits.shape[-1] == 4:
            labels = (batch.ex + 2.0 * batch.ez).long()
            per = F.cross_entropy(logits.reshape(-1, 4), labels.reshape(-1),
                                  reduction="none").reshape(labels.shape) * qm
            lq = per.sum() / (b * n)
            acc = ((logits.argmax(-1) == labels).float() * qm).sum() / (b * n)
        else:
            targets = torch.stack([batch.ex, batch.ez], dim=-1)
            per = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
            lq = (per * qm[:, None]).sum() / (b * n * 2)
            hard = (logits > 0).float()
            acc = ((hard == targets).float() * qm[:, None]).sum() / (b * n * 2)
        total = total + cfg.train.loss_qubit_weight * lq
        metrics["loss_qubit"] = lq
        metrics["acc_qubit"] = acc
    if out.logical_logits is not None and cfg.train.loss_logical_weight:
        ll = F.binary_cross_entropy_with_logits(out.logical_logits, batch.class_bits)
        if logical_share != 1.0:
            ll = ll * logical_share
        total = total + cfg.train.loss_logical_weight * ll
        metrics["loss_logical"] = ll
    metrics["loss"] = total
    return total, metrics


def train_step(model: GNNDecoder, optimizer: OptaxAdamW, graph, batch: SyndromeBatch,
               cfg: ExperimentConfig) -> dict:
    """Forward, loss, backward and update on a sampled batch; returns the
    metrics as tensors (nothing waits for the device)."""
    optimizer.zero_grad(set_to_none=True)
    total, metrics = loss_fn(model, graph, batch, cfg)
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def ema_update(ema: GNNDecoder, model: GNNDecoder, decay: float) -> None:
    """ema <- decay ema + (1 - decay) params (``tpugnn/train/loop.py:231``)."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.mul_(decay).add_((1.0 - decay) * p)


def init_params_from(path: str) -> dict:
    """A warm start's state dict: the parameters of the newest checkpoint in
    a port checkpoint directory, or of an exported weights file (.npz)."""
    if path.endswith(".npz"):
        from tpugnn_torch.models.convert import load_npz, state_dict_from_flat

        return state_dict_from_flat(load_npz(path)[1])
    donor = CheckpointManager(path).restore_latest()
    if donor is None:
        raise FileNotFoundError(f"init_from={path!r}: no checkpoint")
    return donor["model"]


def train_model_config(cfg: ExperimentConfig):
    """The model config a run trains: ``backend='pallas'`` trains the fused
    layout through the kernels K2a/K2b (``'fused'``), as
    ``tpugnn/train/loop.py:97-113`` maps it; ``'fused'``, ``'segment'``,
    ``'dense'`` and ``'ell'`` train as they are.  The generic engine's
    ``'pallas'`` aggregation (K3a/K3b) has no backward, nor has the JAX
    package's, so no backend reaches it here."""
    mcfg = cfg.model
    if mcfg.backend == "pallas":
        return dataclasses.replace(mcfg, backend="fused")
    if mcfg.backend not in ("fused", "segment", "dense", "ell"):
        raise ValueError(f"train() takes backend 'pallas', 'fused', 'segment', 'dense' "
                         f"or 'ell', not {mcfg.backend!r}")
    return mcfg


def init_state(cfg: ExperimentConfig, graph, device="cuda") -> TrainState:
    """A fresh run's state (``tpugnn/train/loop.py:116-131``): the model of
    :func:`train_model_config` with random weights drawn from
    ``cfg.train.seed``, on ``device``; the optimizer; the sampling generator
    on ``device``, seeded with ``cfg.train.seed``; step 0."""
    dev = resolve_device(device)
    t = cfg.train
    model = GNNDecoder(train_model_config(cfg), k=graph.k)
    model.init_random(torch.Generator().manual_seed(t.seed))
    model = model.to(dev)
    generator = torch.Generator(device=dev).manual_seed(t.seed)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      generator=generator, step=0)


def _payload(state: TrainState) -> dict:
    out = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
           "generator": state.generator.get_state()}
    if state.ema is not None:
        out["ema"] = state.ema.state_dict()
    return out


def train(cfg: ExperimentConfig, *, device="cuda", graph=None, log=print,
          callback: Optional[Callable[[int, dict], None]] = None):
    """A training run; returns ``(state, model, graph, history)``.

    Runs on ``device`` (a card unless the caller asks for the CPU).
    ``history`` holds one record per evaluation, as the JAX loop's does.
    ``callback(step, metrics)``, when given, is called after every step with
    the step's metrics as tensors on the device.

    ``cfg.model.backend`` picks the layout (:func:`train_model_config`):
    ``'pallas'`` trains the fused layout through the fused kernels, and the
    returned model is then a ``'fused'`` one; ``'segment'``, ``'dense'`` and
    ``'ell'`` train the generic model under autograd."""
    dev = resolve_device(device)
    t = cfg.train
    if graph is None:
        graph = build_code(cfg.code.family, cfg.code.distance,
                           pad_nodes=cfg.code.pad_nodes, pad_edges=cfg.code.pad_edges)
    dg = graph.to(dev)
    state = init_state(cfg, graph, dev)
    model, optimizer, generator = state.model, state.optimizer, state.generator

    ckpt = CheckpointManager(t.checkpoint_dir) if t.checkpoint_dir else None
    restored = ckpt.restore_latest() if ckpt is not None else None
    if restored is not None:
        model.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        generator.set_state(restored["generator"])
        state.step = restored["step"]
        log(f"restored checkpoint at step {state.step}")
    elif t.init_from:
        model.load_state_dict(init_params_from(t.init_from))
        log(f"warm-started params from {t.init_from}")
    if t.ema_decay:
        state.ema = copy.deepcopy(model)
        if restored is not None and "ema" in restored:
            state.ema.load_state_dict(restored["ema"])

    history = []
    profiling = contextlib.ExitStack()     # the trace of steps 10..14
    jl = MetricLogger(t.metrics_jsonl, stdout=False) if t.metrics_jsonl else None
    for i in range(state.step, t.steps):
        if t.profile_dir and i == 10:
            profiling.enter_context(profile(t.profile_dir))
        p = training_rate(generator, cfg.code.p, t.batch, i, t.p_curriculum, t.p_mix)
        batch = sample_batch(generator, dg, p, t.batch)
        metrics = train_step(model, optimizer, dg, batch, cfg)
        state.step = i + 1
        if state.ema is not None:
            ema_update(state.ema, model, float(t.ema_decay))
        if t.profile_dir and i == 14:
            hard_sync(metrics["loss"])
            profiling.close()
        if callback is not None:
            callback(i + 1, metrics)
        if (i + 1) % max(1, t.eval_every) == 0 or i + 1 == t.steps:
            m = {k: float(v) for k, v in metrics.items()}
            evals = [("", model)] + ([("_ema", state.ema)] if state.ema is not None else [])
            for suffix, mdl in evals:
                ev = ler_monte_carlo(
                    mdl, graph, p=cfg.code.p, shots=t.eval_shots,
                    batch=min(t.eval_shots, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1000 + i))
                m["ler" + suffix] = ev["ler"]
                if not suffix:
                    m["ler_stderr"] = ev["ler_stderr"]
                for extra in ("ler_logical", "ler_hybrid"):
                    if extra in ev:
                        m[extra + suffix] = ev[extra]
            m["step"] = i + 1
            history.append(m)
            if jl is not None:
                jl.log(m)
            log(f"step {i + 1}: loss={m['loss']:.4f} ler={m['ler']:.4f}"
                + (f" ler_logical={m['ler_logical']:.4f}" if "ler_logical" in m else ""))
        if ckpt is not None and (i + 1) % t.checkpoint_every == 0:
            ckpt.save(i + 1, _payload(state))
    profiling.close()       # a run that ends before step 14 keeps what it traced
    if ckpt is not None and ckpt.latest_step() != state.step:
        ckpt.save(state.step, _payload(state))
    if jl is not None:
        jl.close()
    return state, model, graph, history
