"""The generic decoder (RoundCell on the message-passing engine) against
tpugnn's GNNDecoder, the config/dispatch/init repairs, the layout
converters and the trained toric d=7 weights.

Parity: the same flax parameters (JAX's init plus seeded noise, converted
with params_from_flax) and the same syndromes from NumPy; JAX's pallas
backend runs its Pallas kernels in interpret mode.  Tolerance in f32:
atol 2e-4 / rtol 1e-4 on the logits, the bound tests/test_fused.py:39-45
holds the fused cell to the generic one.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn import configs as jconfigs
from tpugnn.eval.ler import count_failures as jax_count_failures
from tpugnn.eval.ler import decode_corrections as jax_decode_corrections
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.models import fused_cell as jfused_cell
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch import configs
from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig
from tpugnn_torch.eval import count_failures, decode_corrections
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models import fused_cell
from tpugnn_torch.models.convert import (
    TORIC_D7_WEIGHTS,
    flatten_tree,
    load_decoder,
    load_npz,
    params_from_flax,
    read_meta,
)
from tpugnn_torch.models.decoder import FusedRounds, RoundCell, lecun_normal_
from tpugnn_torch.sampling import SyndromeBatch
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- repairs: config fields, the meaning of 'pallas', the init ------------

@pytest.mark.parametrize("name", ["CodeConfig", "ModelConfig", "TrainConfig",
                                  "ExperimentConfig"])
def test_config_fields_and_defaults_equal_tpugnn(name):
    """Every field of the JAX package's config, with its default (the mesh
    stays out until dist/ is ported)."""
    fields = lambda cls: {f.name: f.default for f in dataclasses.fields(cls)
                          if f.name != "mesh"}
    ours, theirs = fields(getattr(configs, name)), fields(getattr(jconfigs, name))
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        v_ours = ours[k]
        if dataclasses.is_dataclass(v):
            v, v_ours = dataclasses.asdict(v), dataclasses.asdict(v_ours)
        assert v_ours == v, k


@pytest.mark.parametrize("backend", ["fused", "segment", "dense", "ell", "pallas"])
def test_backend_picks_the_rounds_as_tpugnn_does(backend):
    """GNNDecoder takes the fused layout for 'fused' only; 'pallas' is the
    generic engine on the spmm kernels (tpugnn/models/decoder.py:162-167)."""
    m = GNNDecoder(ModelConfig(hidden=8, msg_hidden=8, rounds=2, backend=backend), k=1)
    assert isinstance(m.rounds, FusedRounds if backend == "fused" else RoundCell)


def _flagship_train_config(steps, batch):
    """benchmarks/train_quality_v3.py:64-78 as scripts/tpu_queue_r2a.sh:108-110
    runs it (backend='pallas', bf16, EMA, p-mix), cut to ``steps`` steps of
    ``batch`` shots with a small evaluation."""
    return ExperimentConfig(
        code=CodeConfig(family="surface", distance=11, p=0.05),
        model=ModelConfig(hidden=128, msg_hidden=128, rounds=14, backend="pallas",
                          readout="both", qubit_head="pauli4", remat=False,
                          dtype="bfloat16"),
        train=TrainConfig(batch=batch, steps=steps, lr=1e-3, warmup_steps=200,
                          eval_every=1000, eval_shots=4, ema_decay=0.999,
                          p_mix=(0.01, 0.05)))


def test_flagship_training_config_with_pallas_trains_the_fused_layout():
    from tpugnn_torch.train import train

    state, model, _, history = train(_flagship_train_config(steps=1, batch=2),
                                     device="cpu", log=lambda s: None)
    assert state.step == 1 and model.cfg.backend == "fused"
    assert isinstance(model.rounds, FusedRounds)
    assert np.isfinite(history[-1]["loss"])
    with pytest.raises(ValueError, match="generic"):
        train(ExperimentConfig(train=TrainConfig(steps=1)), device="cpu")


def test_lecun_normal_is_flax_lecun_normal():
    """Truncated at +-2 std with std = fan_in^-1/2 / 0.87962566; the sample
    variance within 2% of jax.nn.initializers.lecun_normal's on [512, 512]."""
    w = lecun_normal_(torch.empty(512, 512), torch.Generator().manual_seed(0))
    std = 512 ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (512, 512)))
    assert abs(float(w.var()) / float(ref.var()) - 1) < 0.02
    assert abs(float(w.var()) * 512 - 1) < 0.02


@pytest.mark.parametrize("backend,update", [("fused", "mlp"), ("segment", "gru")])
def test_init_random_draws_as_flax(backend, update):
    """Kernels lecun_normal (within 2 std), GRU recurrent kernels orthogonal,
    biases 0 and LayerNorm scales 1; per-round slices are separate draws."""
    cfg = ModelConfig(hidden=64, msg_hidden=64, rounds=2, backend=backend, update=update,
                      weight_tied=backend == "fused")
    m = GNNDecoder(cfg, k=1).init_random(torch.Generator().manual_seed(3))
    for name, p in m.named_parameters():
        leaf, parent = name.split(".")[-1], name.split(".")[-2]
        if leaf == "kernel" and parent in ("hr", "hz", "hn"):
            for w in p:
                torch.testing.assert_close(w.T @ w, torch.eye(w.shape[0]), atol=1e-5,
                                           rtol=0)
        elif leaf in ("kernel", "w_dst", "w_src", "w_out"):
            std = p.shape[-2] ** -0.5 / 0.87962566103423978
            assert float(p.detach().abs().max()) <= 2 * std, name
        else:
            assert torch.equal(p, torch.full_like(p, float(leaf == "scale"))), name
    if backend != "fused":
        k = m.rounds.msg_to_check_d0.kernel
        assert not torch.equal(k[0], k[1])


# --- the generic decoder against tpugnn's ----------------------------------

def _noisy_params(cfg, jg, syn, seed):
    """JAX's init of ``cfg`` plus 0.1 N(0, 1) on every leaf, so that every
    bias and LayerNorm term is exercised; as NumPy."""
    params = JaxGNNDecoder(cfg, k=jg.k).init(jax.random.PRNGKey(seed), jg, jnp.asarray(syn))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return jax.tree.map(np.asarray, jax.tree_util.tree_unflatten(
        tree, [x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)]))


def _syndromes(jg, b=4, seed=0):
    rng = np.random.default_rng(seed)
    syn = (rng.random((b, jg.n_checks_pad)) < 0.25).astype(np.float32)
    return syn * np.asarray(jg.check_mask)


def _run_pair(kw, family="surface", d=3, seed=1):
    """(JAX outputs, port outputs) of GNNDecoder(**kw) on the same params."""
    jg = jax_build_code(family, d)
    syn = _syndromes(jg, seed=seed)
    jcfg = jconfigs.ModelConfig(**kw)
    params = _noisy_params(jcfg, jg, syn, seed)
    ref = JaxGNNDecoder(jcfg, k=jg.k).apply(params, jg, jnp.asarray(syn))
    tm = GNNDecoder(ModelConfig(**kw), k=jg.k)
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tm(build_code(family, d).to("cpu"), torch.from_numpy(syn))
    return ref, got


@pytest.mark.parametrize("weight_tied", [True, False])
@pytest.mark.parametrize("update", ["mlp", "gru"])
@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
@pytest.mark.parametrize("backend", ["segment", "ell", "pallas"])
def test_generic_decoder_matches_tpugnn(backend, aggr, update, weight_tied):
    ref, got = _run_pair(dict(hidden=16, msg_hidden=24, rounds=2, backend=backend,
                              aggr=aggr, update=update, weight_tied=weight_tied,
                              qubit_head="pauli4"))
    for a, b in ((got.qubit_logits, ref.qubit_logits),
                 (got.logical_logits, ref.logical_logits)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("update", ["mlp", "gru"])
def test_generic_decoder_bf16_matches_tpugnn(update):
    """bf16 on the pallas backend with sum.  The port rounds every product,
    add and activation to bf16 as flax's ``dtype=`` asks (LayerNorm takes its
    statistics in f32); XLA need not round at the same points (it may keep
    f32 inside a fusion), so the two differ by up to a few bf16 steps on a
    logit.  Bound: logits within 0.1 + 2% of their size (a logit is O(1)),
    and the argmax correction and the logical bits equal on >= 95% of the
    entries; the port's bf16 logits are not its f32 ones."""
    kw = dict(hidden=16, msg_hidden=24, rounds=2, backend="pallas", aggr="sum",
              update=update, dtype="bfloat16", qubit_head="pauli4")
    ref, got = _run_pair(kw)
    for a, b in ((got.qubit_logits, ref.qubit_logits),
                 (got.logical_logits, ref.logical_logits)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), atol=0.1, rtol=0.02)
    agree = (got.qubit_logits.argmax(-1).numpy() == np.asarray(ref.qubit_logits).argmax(-1))
    assert agree.mean() >= 0.95
    assert ((got.logical_logits.numpy() > 0) == (np.asarray(ref.logical_logits) > 0)).mean() \
        >= 0.95
    _, got32 = _run_pair(dict(kw, dtype="float32"))
    assert not torch.equal(got.qubit_logits, got32.qubit_logits)


# --- the two layouts ---------------------------------------------------------

@pytest.mark.parametrize("weight_tied", [True, False])
def test_converters_equal_tpugnn_and_round_trip(weight_tied):
    jg = jax_build_code("surface", 3)
    syn = _syndromes(jg)
    cfg = jconfigs.ModelConfig(hidden=16, msg_hidden=24, rounds=3, backend="segment",
                               weight_tied=weight_tied)
    rounds = _noisy_params(cfg, jg, syn, seed=5)["params"]["rounds"]
    fused = fused_cell.convert_generic_round_params(rounds)
    ref = jax.tree.map(np.asarray, jfused_cell.convert_generic_round_params(rounds))
    for tree_a, tree_b in ((fused, ref),
                           (fused_cell.convert_fused_round_params(fused),
                            jax.tree.map(np.asarray,
                                         jfused_cell.convert_fused_round_params(ref)))):
        a, b = flatten_tree(tree_a), flatten_tree(tree_b)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = flatten_tree(fused_cell.convert_fused_round_params(fused))
    for k, v in flatten_tree(rounds).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # torch tensors convert the same way
    tback = fused_cell.convert_fused_round_params(
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), fused))
    np.testing.assert_array_equal(tback["msg_to_qubit_d0"]["kernel"].numpy(),
                                  rounds["msg_to_qubit_d0"]["kernel"])


@pytest.mark.parametrize("family", ["surface", "toric"])
def test_fused_and_generic_models_agree(family):
    """The port's fused model (plain rounds) and its generic models on the
    converted weights give the same logits (tests/test_fused.py:106's
    atol 1e-4)."""
    jg = jax_build_code(family, 3)
    syn = _syndromes(jg, seed=6)
    kw = dict(hidden=16, msg_hidden=16, rounds=3, qubit_head="pauli4")
    flat = flatten_tree(_noisy_params(jconfigs.ModelConfig(backend="fused", **kw), jg,
                                      syn, seed=7))
    from tpugnn_torch.models.convert import convert_flat_layout, state_dict_from_flat

    tg = build_code(family, 3).to("cpu")
    outs = {}
    for backend in ("fused", "segment", "pallas"):
        m = GNNDecoder(ModelConfig(backend=backend, **kw), k=jg.k)
        m.load_state_dict(state_dict_from_flat(convert_flat_layout(flat, "fused", backend)))
        with torch.no_grad():
            outs[backend] = m(tg, torch.from_numpy(syn))
    for backend in ("segment", "pallas"):
        for a, b in zip(outs[backend], outs["fused"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


# --- the trained toric d=7 weights -------------------------------------------

@pytest.fixture(scope="module")
def toric_restored(tmp_path_factory):
    """runs/r2_toric_d7/ema (step 8000), restored by the JAX package from a
    temporary copy (its checkpoint manager must not touch the repository)."""
    from tpugnn.train.checkpoint import CheckpointManager
    from tpugnn.train.loop import init_state

    cfg = jconfigs.ExperimentConfig(
        code=jconfigs.CodeConfig(family="toric", distance=7),
        model=jconfigs.ModelConfig(hidden=128, msg_hidden=128, rounds=10, backend="fused",
                                   qubit_head="pauli4"))
    graph = jax_build_code("toric", 7)
    copy = tmp_path_factory.mktemp("ckpt") / "ema"
    shutil.copytree(os.path.join(REPO, "runs", "r2_toric_d7", "ema"), copy)
    state, model = init_state(cfg, graph)
    mgr = CheckpointManager(str(copy))
    r = mgr.restore_latest(state)
    mgr.close()
    return graph, model, r


def test_toric_npz_equals_fresh_restore(toric_restored):
    _, _, r = toric_restored
    cfg, got, step = load_npz(TORIC_D7_WEIGHTS)
    assert step == int(r.step) == 8000
    m = cfg.model
    assert (cfg.code.family, cfg.code.distance) == ("toric", 7)
    assert (m.hidden, m.rounds, m.qubit_head, m.backend) == (128, 10, "pauli4", "fused")
    want = flatten_tree(jax.tree.map(np.asarray, r.params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ref = read_meta(TORIC_D7_WEIGHTS)["ler_reference"]
    assert ref["p"] == 0.05 and ref["shots"] >= 65536
    assert os.path.getsize(TORIC_D7_WEIGHTS) <= 2 * 1024 * 1024


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_toric_d7_failures_equal_jax_on_shared_shots(toric_restored, backend):
    """Shot for shot, the port's decode of the trained toric weights, through
    the fused path and through the generic engine on converted weights,
    fails where the JAX package's fused decode does (both heads and the
    hybrid, p=0.05, 2048 JAX-sampled shots)."""
    jg, jmodel, r = toric_restored
    shots = 2048
    b = jax_sample_batch(jax.random.PRNGKey(2027), jg, 0.05, shots)
    ref_out = jmodel.apply(r.params, jg, b.syndrome)
    ref = jax_count_failures(jg, b, *jax_decode_corrections(ref_out.qubit_logits),
                             ref_out.logical_logits)
    _, model, graph = load_decoder(TORIC_D7_WEIGHTS, device="cpu", backend=backend)
    assert model.cfg.backend == backend
    dg = graph.to("cpu")
    tb = SyndromeBatch(*(torch.from_numpy(np.array(x)) for x in b))
    got = {}
    with torch.no_grad():
        for lo in range(0, shots, 512):
            part = SyndromeBatch(*(x[lo:lo + 512] for x in tb))
            out = model(dg, part.syndrome)
            for k, v in count_failures(dg, part, *decode_corrections(out.qubit_logits),
                                       out.logical_logits).items():
                got.setdefault(k, []).append(v)
    assert 0 < float(np.sum(ref["fail_logical"])) < shots
    for k in ("fail_qubit", "fail_logical", "fail_hybrid"):
        np.testing.assert_array_equal(torch.cat(got[k]).numpy(), np.asarray(ref[k]),
                                      err_msg=k)
