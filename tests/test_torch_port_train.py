"""The port's training path (tpugnn_torch/train) against tpugnn's.

The same flax parameters and the same sampled batch, as numpy, go through
the JAX package's ``loss_fn`` (its trainable PallasDecoder, Pallas forward
and backward kernels in interpret mode) and the port's, with gradients from
``jax.grad`` and ``backward()``.  The optimizer is held to optax on fixed
gradients, and the loop's sampling, EMA, checkpoints and warm start are
checked on the CPU at d=3.
"""

import dataclasses
import json
import os

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
from tpugnn.models.pallas_decoder import PallasDecoder
from tpugnn.sampling import SyndromeBatch as JSyndromeBatch
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn.train.loop import loss_fn as jax_loss_fn
from tpugnn.train.loop import make_optimizer as jax_make_optimizer
from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import DEFAULT_WEIGHTS, load_decoder, params_from_flax
from tpugnn_torch.sampling import SyndromeBatch, sample_batch, training_rate
from tpugnn_torch.tanner import build_code
from tpugnn_torch.train import (
    CheckpointManager,
    ema_update,
    loss_fn,
    make_optimizer,
    train,
    train_step,
    warmup_cosine_decay,
)

torch.set_num_threads(1)

# Loss values: f32 summed in another order; a loss is O(1).
LOSS_TOL = 1e-5
# Whole-model gradients, leaf by leaf, as relative L2 errors.  f32: the same
# arithmetic summed in another order through 3 rounds (the kernel VJP alone
# agrees to ~1e-6, see test_torch_port_backward.py).  bf16: both round the
# states and the kernel VJP's cotangents at the same points; a summation
# order that differs flips a bf16 rounding now and then (1 ulp = 2^-8).
GRAD_REL = {"float32": 1e-4, "bfloat16": 2e-2}


def _setup(qubit_head="pauli4", dtype="float32", d=3, h=32, rounds=3, batch=8, seed=0):
    jcfg = JExperimentConfig(
        code=JCodeConfig(family="surface", distance=d, p=0.08),
        model=JModelConfig(hidden=h, msg_hidden=h, rounds=rounds, backend="fused",
                           readout="both", qubit_head=qubit_head, dtype=dtype))
    tcfg = ExperimentConfig(
        code=CodeConfig(family="surface", distance=d, p=0.08),
        model=ModelConfig(hidden=h, msg_hidden=h, rounds=rounds, backend="fused",
                          readout="both", qubit_head=qubit_head, dtype=dtype))
    jg = jax_build_code("surface", d)
    jb = jax_sample_batch(jax.random.PRNGKey(seed), jg, 0.08, batch)
    params = JGNNDecoder(jcfg.model, k=jg.k).init(jax.random.PRNGKey(seed + 1), jg,
                                                  jb.syndrome)
    params = jax.tree_util.tree_map(np.asarray, params)
    nb = {k: np.array(v) for k, v in jb._asdict().items()}
    tg = build_code("surface", d)
    model = GNNDecoder(tcfg.model, k=tg.k)
    model.load_state_dict(params_from_flax(params))
    tb = SyndromeBatch(**{k: torch.from_numpy(v) for k, v in nb.items()})
    return jcfg, tcfg, jg, tg, params, nb, model, tb


def _jax_loss(jcfg, jg, params, nb, grad=False):
    apply_fn = PallasDecoder(jcfg.model, k=jg.k, trainable=True, interpret=True).apply
    batch = JSyndromeBatch(**{k: jnp.asarray(v) for k, v in nb.items()})
    f = lambda p: jax_loss_fn(p, apply_fn, jg, batch, jcfg)
    if grad:
        return jax.value_and_grad(f, has_aux=True)(params)
    return f(params)


@pytest.mark.parametrize("qubit_head", ["pauli4", "bits"])
def test_loss_matches_jax(qubit_head):
    jcfg, tcfg, jg, tg, params, nb, model, tb = _setup(qubit_head)
    _, jm = _jax_loss(jcfg, jg, params, nb)
    with torch.no_grad():
        _, tm = loss_fn(model, tg.to("cpu"), tb, tcfg)
    assert set(tm) == set(jm) == {"loss", "loss_qubit", "acc_qubit", "loss_logical"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=LOSS_TOL, rtol=LOSS_TOL,
                                   err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_gradients_match_jax(dtype):
    """Every parameter's gradient of the whole loss, leaf by leaf: the flax
    names map one to one onto the module's (params_from_flax)."""
    jcfg, tcfg, jg, tg, params, nb, model, tb = _setup("pauli4", dtype)
    (_, _), jgrads = _jax_loss(jcfg, jg, params, nb, grad=True)
    ref = _flat(jax.tree_util.tree_map(np.asarray, jgrads)["params"])
    total, _ = loss_fn(model, tg.to("cpu"), tb, tcfg)
    total.backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].reshape(r.shape)
        rel = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-12)
        assert rel <= GRAD_REL[dtype], f"{k}: relative error {rel}"


def test_train_steps_match_jax_optax():
    """Two steps of the port's train_step against jax.grad + optax on the
    same two batches: parameters agree to 1e-4 relative (f32)."""
    jcfg, tcfg, jg, tg, params, nb, model, tb = _setup("pauli4", "float32")
    train_cfg = dict(batch=8, steps=10, lr=1e-2, warmup_steps=1)
    jcfg = dataclasses.replace(jcfg, train=JTrainConfig(**train_cfg))
    tcfg = dataclasses.replace(tcfg, train=TrainConfig(**train_cfg))
    opt = jax_make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ostate = opt.init(jparams)
    topt = make_optimizer(tcfg, model.parameters())
    dg = tg.to("cpu")
    for step in range(2):
        b = jax_sample_batch(jax.random.PRNGKey(10 + step), jg, 0.08, 8)
        nbs = {k: np.array(v) for k, v in b._asdict().items()}
        (_, _), g = _jax_loss(jcfg, jg, jparams, nbs, grad=True)
        upd, ostate = opt.update(g, ostate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        train_step(model, topt, dg,
                   SyndromeBatch(**{k: torch.from_numpy(v) for k, v in nbs.items()}), tcfg)
    ref = _flat(jax.tree_util.tree_map(np.asarray, jparams)["params"])
    for k, p in model.named_parameters():
        r = ref[k]
        rel = np.linalg.norm(p.detach().numpy().reshape(r.shape) - r) / np.linalg.norm(r)
        assert rel <= 1e-4, f"{k}: relative error {rel}"


def test_optimizer_matches_optax_on_fixed_gradients():
    """5 steps on given gradients, through warmup, the clip (steps 0-2 have
    a global norm above 1) and unclipped steps: parameters to 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 5), "b": (5,), "c": (3, 4, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (2.0 if t < 3 else 0.05)).astype(np.float32)
              for k, s in shapes.items()} for t in range(5)]
    cfg_kw = dict(lr=3e-2, warmup_steps=2, steps=4, weight_decay=1e-2)
    jcfg = JExperimentConfig(train=JTrainConfig(**cfg_kw))
    opt = jax_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = make_optimizer(ExperimentConfig(train=TrainConfig(**cfg_kw)), list(tp.values()))
    for g in grads:
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # the optimizer state survives a state_dict round trip
    topt2 = make_optimizer(ExperimentConfig(train=TrainConfig(**cfg_kw)), list(tp.values()))
    topt2.load_state_dict(topt.state_dict())
    assert topt2.param_groups[0]["count"] == 5


@pytest.mark.parametrize("count", [0, 1, 199, 200, 201, 1100, 1999, 2000, 2600])
def test_schedule_matches_optax(count):
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 200, 2000, 1e-4)
    got = warmup_cosine_decay(count, peak=1e-3, warmup_steps=200, decay_steps=2000,
                              end=1e-4)
    np.testing.assert_allclose(got, float(sched(count)), rtol=1e-6, atol=1e-12)


def test_p_mix_rates_are_per_shot_and_in_range():
    gen = torch.Generator().manual_seed(0)
    p = training_rate(gen, 0.05, 512, 0, p_mix=(0.01, 0.05))
    assert p.shape == (512, 1)
    assert float(p.min()) >= 0.01 and float(p.max()) < 0.05
    assert len(torch.unique(p)) > 500
    # each shot's errors follow its own rate
    g = build_code("surface", 5).to("cpu")
    rates = torch.cat([torch.zeros(256, 1), torch.full((256, 1), 0.5)])
    b = sample_batch(gen, g, rates, 512)
    assert float(b.ex[:256].sum() + b.ez[:256].sum()) == 0.0
    assert float(b.ex[256:].sum()) > 0.0
    assert training_rate(gen, 0.05, 8, 50, p_curriculum=(0.01, 0.03, 100)) == \
        pytest.approx(0.02)
    assert training_rate(gen, 0.05, 8, 500, p_curriculum=(0.01, 0.03, 100)) == \
        pytest.approx(0.03)
    assert training_rate(gen, 0.05, 8, 0) == 0.05
    with pytest.raises(ValueError, match="exclusive"):
        training_rate(gen, 0.05, 8, 0, p_curriculum=(0.01, 0.03, 10), p_mix=(0.01, 0.05))


def test_ema_update():
    a = GNNDecoder(ModelConfig(hidden=8, msg_hidden=8, rounds=1, backend="fused"), k=1)
    b = GNNDecoder(ModelConfig(hidden=8, msg_hidden=8, rounds=1, backend="fused"), k=1)
    b.init_random(torch.Generator().manual_seed(5), bias_std=0.3)
    before = [p.detach().clone() for p in a.parameters()]
    ema_update(a, b, 0.9)
    for e0, e1, p in zip(before, a.parameters(), b.parameters()):
        torch.testing.assert_close(e1, 0.9 * e0 + 0.1 * p, rtol=1e-6, atol=1e-7)


def _tiny(tmp=None, steps=3, **kw):
    return ExperimentConfig(
        code=CodeConfig(family="surface", distance=3, p=0.05),
        model=ModelConfig(hidden=16, msg_hidden=16, rounds=2, backend="fused",
                          readout="both", qubit_head="pauli4", dtype="bfloat16"),
        train=TrainConfig(batch=8, steps=steps, warmup_steps=2, eval_every=1000,
                          eval_shots=16, ema_decay=0.9, p_mix=(0.01, 0.05),
                          checkpoint_dir=tmp, **kw))


def test_train_runs_on_cpu(tmp_path):
    losses = []
    jsonl = tmp_path / "metrics.jsonl"
    state, model, graph, history = train(
        _tiny(metrics_jsonl=str(jsonl)), device="cpu", log=lambda s: None,
        callback=lambda step, m: losses.append(float(m["loss"])))
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert state.step == 3 and len(history) == 1 and history[0]["step"] == 3
    assert 0.0 <= history[0]["ler"] <= 1.0 and "ler_ema" in history[0]
    assert any(not torch.equal(e, p) for e, p in zip(state.ema.parameters(),
                                                     model.parameters()))
    assert [json.loads(l)["step"] for l in jsonl.read_text().splitlines()] == [3]


def test_train_profiles_steps_10_to_14(tmp_path):
    train(_tiny(steps=15, profile_dir=str(tmp_path / "prof")), device="cpu",
          log=lambda s: None)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_checkpoint_resume_equals_straight_run(tmp_path):
    """A run resumed from its step-3 checkpoint ends where a straight run
    ends: parameters, EMA and optimizer state bit for bit."""
    quiet = lambda s: None
    a, _, _, _ = train(_tiny(str(tmp_path / "a"), steps=6, checkpoint_every=3),
                       device="cpu", log=quiet)
    train(_tiny(str(tmp_path / "b"), steps=3), device="cpu", log=quiet)
    msgs = []
    b, _, _, _ = train(_tiny(str(tmp_path / "b"), steps=6), device="cpu", log=msgs.append)
    assert "restored checkpoint at step 3" in msgs
    for x, y in zip(list(a.model.parameters()) + list(a.ema.parameters()),
                    list(b.model.parameters()) + list(b.ema.parameters())):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.optimizer.param_groups[0]["count"] == b.optimizer.param_groups[0]["count"] == 6
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.latest_step() == 6
    for s in range(7, 12):
        mgr.save(s, {"x": torch.zeros(1)})
    assert sorted(int(f[5:14]) for f in os.listdir(tmp_path / "a")) == [9, 10, 11]


def test_init_from_npz_and_checkpoint(tmp_path):
    """Warm start: the parameters of the exported weights file, and of a
    port checkpoint directory, at step 0 with a fresh optimizer."""
    from tpugnn_torch.models.convert import read_meta

    meta = read_meta()
    cfg = ExperimentConfig(code=CodeConfig(**meta["code"]), model=ModelConfig(**meta["model"]),
                           train=TrainConfig(steps=0, init_from=DEFAULT_WEIGHTS))
    state, model, _, _ = train(cfg, device="cpu", log=lambda s: None)
    _, ref, _ = load_decoder(device="cpu")
    for (k, p), (_, r) in zip(model.named_parameters(), ref.named_parameters()):
        torch.testing.assert_close(p, r, rtol=0, atol=0, msg=k)
    assert state.step == 0 and state.optimizer.param_groups[0]["count"] == 0

    donor, _, _, _ = train(_tiny(str(tmp_path / "donor"), steps=2), device="cpu",
                           log=lambda s: None)
    warm, _, _, _ = train(dataclasses.replace(
        _tiny(steps=0), train=dataclasses.replace(_tiny(steps=0).train,
                                                  init_from=str(tmp_path / "donor"))),
        device="cpu", log=lambda s: None)
    for x, y in zip(donor.model.parameters(), warm.model.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
