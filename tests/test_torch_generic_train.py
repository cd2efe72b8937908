"""Training through the generic backends against the JAX package's.

The same flax parameters (converted with ``params_from_flax``) and the same
sampled batch, as NumPy, go through ``tpugnn.train.loop.loss_fn`` with the
flax ``GNNDecoder`` (which the JAX package trains directly for every
backend but 'pallas', ``tpugnn/train/loop.py:97-113``) under ``jax.grad``,
and through the port's ``loss_fn`` and ``backward()``: surface d=3, H=16,
R=3, B=8, for ``segment``, ``dense`` and ``ell``, ``update`` mlp and gru,
weight-tied and per-round, with and without ``remat``.

Tolerances.  f32: the loss within 1e-5 and every gradient entry within
1e-5 of the largest gradient (the same arithmetic summed in another order;
measured below 5e-7).  bf16 (H=32): the two packages round at different
points (XLA keeps excess f32 precision inside a fusion and expands sigmoid
and tanh in its own steps), and at B=8 a rounding that flips a ReLU moves a
whole gradient entry, so entry by entry the two bf16 gradients are not a
stable comparison (up to 0.037 of the largest gradient at H=32; at H=16
the JAX bf16 gradient lies 0.43 in L2 from its own f32 gradient).  Held
instead: the loss within 5e-3, the whole gradient within 5e-2 in relative
L2 of jax.grad's (measured at most 0.020), and no farther from the JAX f32
gradient than JAX's own bf16 gradient is, plus 2e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpugnn.configs import CodeConfig as JCodeConfig
from tpugnn.configs import ExperimentConfig as JExperimentConfig
from tpugnn.configs import ModelConfig as JModelConfig
from tpugnn.configs import TrainConfig as JTrainConfig
from tpugnn.models import GNNDecoder as JGNNDecoder
from tpugnn.sampling import SyndromeBatch as JSyndromeBatch
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn.train.loop import loss_fn as jax_loss_fn
from tpugnn.train.loop import make_optimizer as jax_make_optimizer
from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import params_from_flax
from tpugnn_torch.models.decoder import FusedRounds, RoundCell
from tpugnn_torch.sampling import SyndromeBatch
from tpugnn_torch.tanner import build_code
from tpugnn_torch.train import (
    CheckpointManager,
    init_state,
    loss_fn,
    make_optimizer,
    train,
    train_model_config,
    train_step,
)

torch.set_num_threads(1)

D, B = 3, 8
LOSS_TOL_F32 = 1e-5
GRAD_TOL_F32 = 1e-5       # of the largest gradient entry
STEP_TOL_F32 = 1e-5       # parameters after 3 optimizer steps
LOSS_TOL_BF16 = 5e-3
GRAD_REL_BF16 = 5e-2      # relative L2 of the whole gradient against jax.grad's
GRAD_SLACK_BF16 = 2e-2    # distance to JAX's f32 gradient beyond JAX bf16's own
# The port's bf16 gradient lies at least this share of JAX bf16's distance
# from JAX f32 (measured 0.86-1.16 at H=32; an f32 port, 1e-5) ...
ROUNDING_SHARE_BF16 = 0.5
# ... and deviates from JAX f32 the way JAX bf16 does: cosine of the two
# deviations (measured 0.54-0.99 at H=32; an f32 port, -0.06-0.13).
ROUNDING_COS_BF16 = 0.3
BACKENDS = ["segment", "dense", "ell"]


def _configs(backend, update, weight_tied, dtype="float32", remat=False, hidden=16, **train):
    kw = dict(hidden=hidden, msg_hidden=hidden, rounds=3, backend=backend, update=update,
              weight_tied=weight_tied, readout="both", qubit_head="bits", dtype=dtype,
              remat=remat)
    code = dict(family="surface", distance=D, p=0.08)
    return (JExperimentConfig(code=JCodeConfig(**code), model=JModelConfig(**kw),
                              train=JTrainConfig(**train)),
            ExperimentConfig(code=CodeConfig(**code), model=ModelConfig(**kw),
                             train=TrainConfig(**train)))


@functools.lru_cache(maxsize=None)
def _graphs():
    return jax_build_code("surface", D), build_code("surface", D).to("cpu")


def _batch(seed):
    """A JAX-sampled batch as NumPy."""
    jg, _ = _graphs()
    b = jax_sample_batch(jax.random.PRNGKey(seed), jg, 0.08, B)
    return {k: np.array(v) for k, v in b._asdict().items()}


def _params(jcfg, seed=1):
    jg, _ = _graphs()
    p = JGNNDecoder(jcfg.model, k=jg.k).init(jax.random.PRNGKey(seed), jg,
                                             jnp.zeros((2, jg.n_checks_pad)))
    return jax.tree.map(np.asarray, p)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jax_loss_and_grads(jcfg, params, nb):
    jg, _ = _graphs()
    apply_fn = JGNNDecoder(jcfg.model, k=jg.k).apply
    batch = JSyndromeBatch(**{k: jnp.asarray(v) for k, v in nb.items()})
    (loss, _), g = jax.value_and_grad(
        lambda p: jax_loss_fn(p, apply_fn, jg, batch, jcfg), has_aux=True)(params)
    return float(loss), _flat(jax.tree.map(np.asarray, g)["params"])


def _model(tcfg, params):
    jg, _ = _graphs()
    m = GNNDecoder(tcfg.model, k=jg.k)
    m.load_state_dict(params_from_flax(params))
    return m


def _torch_batch(nb):
    return SyndromeBatch(**{k: torch.from_numpy(v) for k, v in nb.items()})


def _port_loss_and_grads(tcfg, params, nb):
    _, dg = _graphs()
    model = _model(tcfg, params)
    total, _ = loss_fn(model, dg, _torch_batch(nb), tcfg)
    total.backward()
    return float(total.detach()), {k: p.grad.numpy() for k, p in model.named_parameters()}


def _vector(grads, ref):
    return np.concatenate([grads[k].reshape(ref[k].shape).ravel() for k in sorted(ref)])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("weight_tied", [True, False], ids=["tied", "per_round"])
@pytest.mark.parametrize("update", ["mlp", "gru"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_f32_loss_and_gradients_equal_jax_grad(backend, update, weight_tied, remat):
    jcfg, tcfg = _configs(backend, update, weight_tied, remat=remat)
    params, nb = _params(jcfg), _batch(0)
    jloss, ref = _jax_loss_and_grads(jcfg, params, nb)
    loss, got = _port_loss_and_grads(tcfg, params, nb)
    assert set(got) == set(ref)
    assert abs(loss - jloss) <= LOSS_TOL_F32
    gmax = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        err = float(np.abs(got[k].reshape(r.shape) - r).max())
        assert err <= GRAD_TOL_F32 * gmax, f"{k}: {err / gmax} of the largest gradient"


@pytest.mark.parametrize("weight_tied", [True, False], ids=["tied", "per_round"])
@pytest.mark.parametrize("update", ["mlp", "gru"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_loss_and_gradients_track_jax_grad(backend, update, weight_tied):
    jcfg, tcfg = _configs(backend, update, weight_tied, dtype="bfloat16", hidden=32)
    jcfg32, _ = _configs(backend, update, weight_tied, hidden=32)
    params, nb = _params(jcfg32), _batch(0)
    jloss, ref = _jax_loss_and_grads(jcfg, params, nb)
    _, ref32 = _jax_loss_and_grads(jcfg32, params, nb)
    loss, got = _port_loss_and_grads(tcfg, params, nb)
    _, got32 = _port_loss_and_grads(_configs(backend, update, weight_tied, hidden=32)[1],
                                    params, nb)
    assert abs(loss - jloss) <= LOSS_TOL_BF16
    g, r, r32 = _vector(got, ref), _vector(ref, ref), _vector(ref32, ref)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert rel(g, r) <= GRAD_REL_BF16
    assert rel(g, r32) <= rel(r, r32) + GRAD_SLACK_BF16

    def rounds_as_bf16(v):
        dv, dr = v - r32, r - r32
        cos = float(dv @ dr / (np.linalg.norm(dv) * np.linalg.norm(dr)))
        return rel(v, r32) >= ROUNDING_SHARE_BF16 * rel(r, r32) and cos >= ROUNDING_COS_BF16

    assert rounds_as_bf16(g)
    # the check tells a port that computes in f32 where bf16 is asked
    assert not rounds_as_bf16(_vector(got32, ref))


@pytest.mark.parametrize("backend", BACKENDS)
def test_three_optimizer_steps_equal_optax(backend):
    """Three train_steps against jax.grad + optax on the same three batches
    (f32, per-round mlp): every parameter within 1e-5."""
    train_kw = dict(batch=B, steps=10, lr=1e-2, warmup_steps=1)
    jcfg, tcfg = _configs(backend, "mlp", False, **train_kw)
    params = _params(jcfg)
    opt = jax_make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    ostate = opt.init(jparams)
    jg, dg = _graphs()
    apply_fn = JGNNDecoder(jcfg.model, k=jg.k).apply
    model = _model(tcfg, params)
    topt = make_optimizer(tcfg, model.parameters())
    for step in range(3):
        nb = _batch(10 + step)
        batch = JSyndromeBatch(**{k: jnp.asarray(v) for k, v in nb.items()})
        g = jax.grad(lambda p: jax_loss_fn(p, apply_fn, jg, batch, jcfg)[0])(jparams)
        upd, ostate = opt.update(g, ostate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        train_step(model, topt, dg, _torch_batch(nb), tcfg)
    ref = _flat(jax.tree.map(np.asarray, jparams)["params"])
    moved = 0.0
    for k, p in model.named_parameters():
        r = ref[k]
        got = p.detach().numpy().reshape(r.shape)
        np.testing.assert_allclose(got, r, rtol=0, atol=STEP_TOL_F32, err_msg=k)
        moved = max(moved, float(np.abs(r - _flat(params["params"])[k]).max()))
    assert moved > 1e-3


def test_segment_training_learns(tmp_path):
    """train(backend='segment') at d=3 learns, as tests/test_fused.py::
    test_fused_trains asks of the fused layout; its evaluations go to the
    JSONL file as the JAX loop's MetricLogger writes them (with ``time``)."""
    jsonl = tmp_path / "m.jsonl"
    cfg = ExperimentConfig(
        code=CodeConfig(family="surface", distance=3, p=0.05),
        model=ModelConfig(hidden=32, msg_hidden=32, rounds=3, backend="segment"),
        train=TrainConfig(batch=128, steps=120, eval_every=60, eval_shots=512,
                          metrics_jsonl=str(jsonl)))
    state, model, _, history = train(cfg, device="cpu", log=lambda *_: None)
    assert isinstance(model.rounds, RoundCell) and model.cfg.backend == "segment"
    assert state.step == 120
    assert history[-1]["loss"] < 0.8
    assert history[-1]["ler"] < 0.5
    import json

    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["step"] for r in records] == [60, 120]
    assert all(set(r) == set(h) | {"time"} for r, h in zip(records, history))


@pytest.mark.parametrize("backend,layout", [("pallas", "fused"), ("fused", "fused"),
                                            ("segment", "segment"), ("dense", "dense"),
                                            ("ell", "ell")])
def test_train_model_config_maps_the_backends_as_tpugnn(backend, layout):
    cfg = ExperimentConfig(model=ModelConfig(hidden=8, msg_hidden=8, rounds=2,
                                             backend=backend))
    assert train_model_config(cfg).backend == layout
    state = init_state(cfg, build_code("surface", 3), "cpu")
    assert isinstance(state.model.rounds, FusedRounds if layout == "fused" else RoundCell)
    again = init_state(cfg, build_code("surface", 3), "cpu")
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    assert state.step == 0 and state.generator.initial_seed() == cfg.train.seed


def test_generic_pallas_aggregation_still_refuses_autograd():
    """K3a/K3b have no backward (nor has tpugnn/kernels/spmm.py): the
    generic 'pallas' model decodes without grad and raises under it."""
    _, dg = _graphs()
    cfg = ModelConfig(hidden=8, msg_hidden=8, rounds=2, backend="pallas")
    model = GNNDecoder(cfg, k=1)
    syn = torch.zeros(2, dg.n_checks_pad)
    with torch.no_grad():
        model(dg, syn)
    with pytest.raises(RuntimeError, match="no backward"):
        model(dg, syn)
    with pytest.raises(ValueError, match="train"):
        train_model_config(ExperimentConfig(model=dataclasses.replace(cfg, backend="sparse")))


def test_generic_checkpoint_resume_equals_straight_run(tmp_path):
    """A segment run resumed from its step-2 checkpoint ends where a
    straight run ends, bit for bit."""
    def cfg(ckpt, steps):
        return ExperimentConfig(
            code=CodeConfig(family="surface", distance=3, p=0.05),
            model=ModelConfig(hidden=8, msg_hidden=8, rounds=2, backend="segment",
                              update="gru", weight_tied=False, remat=True),
            train=TrainConfig(batch=8, steps=steps, warmup_steps=1, eval_every=1000,
                              eval_shots=16, ema_decay=0.9, checkpoint_dir=ckpt))
    quiet = lambda *_: None
    a, _, _, _ = train(cfg(str(tmp_path / "a"), 4), device="cpu", log=quiet)
    train(cfg(str(tmp_path / "b"), 2), device="cpu", log=quiet)
    msgs = []
    b, _, _, _ = train(cfg(str(tmp_path / "b"), 4), device="cpu", log=msgs.append)
    assert "restored checkpoint at step 2" in msgs
    for x, y in zip(list(a.model.parameters()) + list(a.ema.parameters()),
                    list(b.model.parameters()) + list(b.ema.parameters())):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert CheckpointManager(str(tmp_path / "a")).latest_step() == 4
