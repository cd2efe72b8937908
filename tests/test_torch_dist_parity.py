"""Edge-partitioned decoding and training of the port against the JAX package.

The JAX references run here (``tests/conftest.py`` gives 8 virtual CPU
devices): ``tpugnn.dist.make_sharded_apply`` and the single-device
``model.apply`` at H=16, R=3, B=8, with the parameters of the flax init
(converted by ``params_from_flax``) and JAX-sampled syndromes, the cases of
``tests/dist/test_parity.py`` and ``test_halo_compression.py``.  The port
runs the same inputs on gloo ranks started once per module by
``tpugnn_torch.dist.multihost.launch``: 8 ranks for the forwards, the edge
attributes and the compressed train steps (meshes data = 8 / P x graph =
P), 4 for the 2 x 2 train step.  This module imports no JAX at its top, so
that each rank imports it cheaply.

Tolerances.  f32 sharded forward: within 1e-5 of JAX's sharded forward and
1e-4 of its single-device forward (the same f32 sums in another order),
the same hard decisions; 'alltoall' and 'ring' move the same slices, so
their logits are equal bit for bit.  bf16/int8 wires: within 5e-3 of JAX at
the same wire type with >= 99.9% equal signs (both quantise the same f32
buffer, so they differ only where an f32 reassociation moves a value across
a rounding step), and within JAX's own 0.05/0.08 of the port's f32 with
> 99.5% equal signs.  Train step: the loss within 1e-5, every gradient
entry within 1e-5 of the largest of ``jax.value_and_grad(loss_fn)`` on the
whole graph, the parameters after one optax step within 1e-4.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpugnn_torch.configs import CodeConfig, ExperimentConfig, MeshConfig, ModelConfig
from tpugnn_torch.configs import TrainConfig
from tpugnn_torch.dist import (
    dryrun,
    make_mesh,
    make_sharded_apply,
    make_sharded_train_step,
    partition_graph,
)
from tpugnn_torch.dist.multihost import launch
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.mp import NodeStates, bipartite_round
from tpugnn_torch.sampling import SyndromeBatch, sample_batch
from tpugnn_torch.tanner import build_code
from tpugnn_torch.train import init_state, make_optimizer

H, R, B = 16, 3, 8
WORLD = 8
RANK_TIMEOUT_S = 240
# name: (family, d, P, halo, halo_dtype, p)
FORWARDS = {
    "surface5_p4": ("surface", 5, 4, "alltoall", "float32", 0.08),
    "toric3_p2": ("toric", 3, 2, "alltoall", "float32", 0.08),
    "surface15_p8": ("surface", 15, 8, "alltoall", "float32", 0.08),
    "modes_gather": ("toric", 3, 4, "gather", "float32", 0.1),
    "modes_alltoall": ("toric", 3, 4, "alltoall", "float32", 0.1),
    "modes_ring": ("toric", 3, 4, "ring", "float32", 0.1),
    "surface5_p4_ring": ("surface", 5, 4, "ring", "float32", 0.08),
    **{f"surface5_p4_{halo}_{hdt}": ("surface", 5, 4, halo, hdt, 0.08)
       for halo in ("alltoall", "ring") for hdt in ("bfloat16", "int8")},
}
BAD_DTYPE = ("surface", 5, 4, "alltoall", "float16", 0.08)
TRAIN_KW = dict(batch=16, steps=10, lr=1e-2, warmup_steps=0)


def _model_cfg(rounds=R):
    return ModelConfig(hidden=H, msg_hidden=H, rounds=rounds)


def _graph(family, d, P, halo="alltoall", hdt="float32"):
    """The graph ``build_partitioned_code`` pads for P shards."""
    graph = build_code(family, d, pad_nodes=8 * P)
    return graph, partition_graph(graph, P, halo=halo, halo_dtype=hdt)


def _mesh(P):
    return make_mesh(MeshConfig(data=dist.get_world_size() // P, graph=P))


# --- what the ranks run --------------------------------------------------------

def _forward(case, state, syn):
    family, d, P, halo, hdt, _ = case
    graph, pg = _graph(family, d, P, halo, hdt)
    model = GNNDecoder(_model_cfg(), k=graph.k)
    model.load_state_dict(state)
    apply = make_sharded_apply(model, _mesh(P), pg, device="cpu")
    try:
        with torch.no_grad():
            out = apply(None, torch.from_numpy(syn))
    except ValueError as e:
        return str(e)
    return out.qubit_logits.numpy(), out.logical_logits.numpy()


def _edge_message(xc_e, xq_e, ea):
    return torch.tanh(xc_e + 2.0 * xq_e) * ea


def _edge_update(old, agg):
    return old + agg


def _edge_round(halo, xc, xq, attr):
    """One sharded round with per-edge attributes; this rank's rows."""
    graph = build_code("surface", 5, pad_nodes=32)
    pg = partition_graph(graph, 4, halo=halo)
    mesh = _mesh(4)
    g = mesh.get_local_rank("graph")
    view = pg.shard(g, mesh.get_group("graph"))
    mb, nb = pg.mb, pg.nb
    out = bipartite_round(view, NodeStates(torch.from_numpy(xc[g * mb:(g + 1) * mb]),
                                           torch.from_numpy(xq[g * nb:(g + 1) * nb])),
                          message_to_qubit=_edge_message, message_to_check=_edge_message,
                          update_check=_edge_update, update_qubit=_edge_update,
                          edge_attr=torch.from_numpy(attr))
    return g, out.check.numpy(), out.qubit.numpy()


def _compressed_steps(hdt):
    """Two sharded train steps (mesh 2 x 4, surface d=3) at wire type
    ``hdt`` from the port's seeded init: (params before, after, last loss)."""
    graph, pg = _graph("surface", 3, 4, "alltoall", hdt)
    cfg = ExperimentConfig(code=CodeConfig(family="surface", distance=3, p=0.05),
                           model=_model_cfg(rounds=2),
                           train=TrainConfig(batch=16, steps=4, warmup_steps=1))
    state = init_state(cfg, graph, "cpu")
    before = {k: v.detach().clone().numpy() for k, v in state.model.named_parameters()}
    step = make_sharded_train_step(cfg, state.model, _mesh(4), graph, pg, state.optimizer,
                                   device="cpu")
    gen = torch.Generator().manual_seed(5)
    dg = graph.to("cpu")
    for _ in range(2):
        metrics = step(sample_batch(gen, dg, cfg.code.p, cfg.train.batch))
    after = {k: v.detach().numpy() for k, v in state.model.named_parameters()}
    return before, after, float(metrics["loss"])


def _world8(inputs, edge_inputs):
    out = {"forward": {name: _forward(FORWARDS[name], *inputs[name]) for name in FORWARDS},
           "bad_dtype": _forward(BAD_DTYPE, *inputs["surface5_p4"]),
           "edge": {halo: _edge_round(halo, *edge_inputs) for halo in
                    ("gather", "alltoall", "ring")}}
    out["steps"] = {hdt: _compressed_steps(hdt) for hdt in ("float32", "bfloat16", "int8")}
    return out


def _world4_train(params, batch):
    graph, pg = _graph("surface", 3, 2)
    cfg = ExperimentConfig(code=CodeConfig(family="surface", distance=3, p=0.05),
                           model=_model_cfg(rounds=2), train=TrainConfig(**TRAIN_KW))
    model = GNNDecoder(cfg.model, k=graph.k)
    model.load_state_dict(params)
    step = make_sharded_train_step(cfg, model, make_mesh(MeshConfig(data=2, graph=2)), graph,
                                   pg, make_optimizer(cfg, model.parameters()), device="cpu")
    metrics = step(SyndromeBatch(**{k: torch.from_numpy(v) for k, v in batch.items()}))
    return (float(metrics["loss"]),
            {k: p.grad.numpy() for k, p in model.named_parameters()},
            {k: p.detach().numpy() for k, p in model.named_parameters()})


# --- the JAX references (here, in the test process) ---------------------------

@functools.lru_cache(maxsize=None)
def _jax_model(family, d, P, p):
    """The JAX package's graph (padded for P shards), model, flax params
    and syndromes; the halo mode and wire type change none of them."""
    import jax

    from tpugnn.configs import ModelConfig as JModelConfig
    from tpugnn.dist import build_partitioned_code as jbuild
    from tpugnn.models import GNNDecoder as JGNNDecoder
    from tpugnn.sampling import sample_batch as jsample

    graph, _ = jbuild(family, d, P)
    model = JGNNDecoder(JModelConfig(hidden=H, msg_hidden=H, rounds=R), k=graph.k)
    syn = jsample(jax.random.PRNGKey(0), graph, p, B).syndrome
    params = jax.jit(model.init)(jax.random.PRNGKey(1), graph, syn)
    return graph, model, params, syn


def _port_inputs(case):
    import jax

    from tpugnn_torch.models.convert import params_from_flax

    family, d, P, _, _, p = case
    _, _, params, syn = _jax_model(family, d, P, p)
    return params_from_flax(jax.tree.map(np.asarray, params)), np.asarray(syn)


@functools.lru_cache(maxsize=None)
def _jax_single(family, d, P, p):
    """JAX's single-device forward on the whole graph."""
    import jax

    graph, model, params, syn = _jax_model(family, d, P, p)
    out = jax.jit(model.apply)(params, graph, syn)
    return np.asarray(out.qubit_logits), np.asarray(out.logical_logits)


@functools.lru_cache(maxsize=None)
def _jax_sharded(case):
    """JAX's ``make_sharded_apply`` forward of a case."""
    import jax

    from tpugnn.configs.config import MeshConfig as JMeshConfig
    from tpugnn.dist import make_mesh as jmake_mesh
    from tpugnn.dist import make_sharded_apply as jsharded
    from tpugnn.dist import partition_graph as jpartition

    family, d, P, halo, hdt, p = case
    graph, model, params, syn = _jax_model(family, d, P, p)
    pg = jpartition(graph, P, halo=halo, halo_dtype=hdt)
    mesh = jmake_mesh(JMeshConfig(data=1, graph=P), n_devices=P)
    out = jax.jit(jsharded(model, mesh, pg))(params, graph, syn)
    return np.asarray(out.qubit_logits), np.asarray(out.logical_logits)


# the cases whose JAX references the tests read
SHARDED_REFS = ("surface5_p4", "toric3_p2", "surface15_p8", "surface5_p4_alltoall_bfloat16",
                "surface5_p4_alltoall_int8", "surface5_p4_ring_bfloat16",
                "surface5_p4_ring_int8")
SINGLE_REFS = ("surface5_p4", "toric3_p2", "surface15_p8", "modes_gather")


@functools.lru_cache(maxsize=None)
def _jax_edge_inputs():
    import jax

    from tpugnn.tanner import build_code as jbuild_code

    graph = jbuild_code("surface", 5, pad_nodes=32)
    kc, kq, ka = jax.random.split(jax.random.PRNGKey(0), 3)
    f = 16
    xc = jax.random.normal(kc, (graph.n_checks_pad, f)) * graph.check_mask[:, None]
    xq = jax.random.normal(kq, (graph.n_qubits_pad, f)) * graph.qubit_mask[:, None]
    attr = jax.random.normal(ka, (graph.n_edges_pad, f))
    return graph, xc, xq, attr


def _jax_train_setup():
    import jax

    from tpugnn.configs import CodeConfig as JCodeConfig
    from tpugnn.configs import ExperimentConfig as JExperimentConfig
    from tpugnn.configs import ModelConfig as JModelConfig
    from tpugnn.configs import TrainConfig as JTrainConfig
    from tpugnn.dist import build_partitioned_code as jbuild
    from tpugnn.sampling import sample_batch as jsample
    from tpugnn.train.loop import init_state as jinit_state

    graph, _ = jbuild("surface", 3, 2)
    jcfg = JExperimentConfig(code=JCodeConfig(family="surface", distance=3, p=0.05),
                             model=JModelConfig(hidden=H, msg_hidden=H, rounds=2),
                             train=JTrainConfig(**TRAIN_KW))
    state, model = jinit_state(jcfg, graph)
    batch = jsample(jax.random.PRNGKey(3), graph, 0.05, TRAIN_KW["batch"])
    return graph, jcfg, state.params, model, batch


def _jax_train_step(graph, jcfg, params, model, batch):
    """Loss, ``jax.value_and_grad(loss_fn)`` and one optax step on the whole
    graph, flattened to the port's parameter names."""
    import jax
    import optax

    from tpugnn.train.loop import loss_fn as jloss_fn
    from tpugnn.train.loop import make_optimizer as jmake_optimizer
    from tpugnn_torch.models.convert import flatten_tree

    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, model.apply, graph, batch, jcfg), has_aux=True))(params)
    opt = jmake_optimizer(jcfg)
    stepped = jax.jit(lambda g, p: optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]))(
        grads, params)
    flat = lambda t: {k.replace("/", "."): np.asarray(v) for k, v in flatten_tree(
        jax.tree.map(np.asarray, t)["params"]).items()}
    return dict(loss=float(loss), grads=flat(grads), params=flat(stepped), start=flat(params))


@pytest.fixture(scope="module")
def ranks(devices8):
    """Every launch of the module, run at once beside the JAX references:
    8 ranks (forwards, edge attributes, compressed steps), 4 ranks (the
    2 x 2 train step) and ``dryrun(n)`` for n in 1, 2, 4, 8 with their
    standard output."""
    import contextlib
    import io
    import jax
    from concurrent.futures import ThreadPoolExecutor

    from tpugnn_torch.models.convert import params_from_flax

    inputs = {name: _port_inputs(c) for name, c in FORWARDS.items()}
    _, xc, xq, attr = _jax_edge_inputs()
    train = _jax_train_setup()
    graph, jcfg, params, model, batch = train
    out = io.StringIO()
    with ThreadPoolExecutor(max_workers=6) as pool, contextlib.redirect_stdout(out):
        w8 = pool.submit(launch, _world8, WORLD, args=(
            inputs, (np.asarray(xc), np.asarray(xq), np.asarray(attr))),
            device="cpu", timeout=RANK_TIMEOUT_S, echo=False)
        w4 = pool.submit(launch, _world4_train, 4, args=(
            params_from_flax(jax.tree.map(np.asarray, params)),
            {k: np.asarray(v) for k, v in batch._asdict().items()}),
            device="cpu", timeout=RANK_TIMEOUT_S, echo=False)
        dry = {n: pool.submit(dryrun, n, device="cpu", timeout=RANK_TIMEOUT_S)
               for n in (1, 2, 4, 8)}
        for name in SHARDED_REFS:
            _jax_sharded(FORWARDS[name])
        for name in SINGLE_REFS:
            _jax_single(*_single_key(name))
        train_ref = _jax_train_step(*train)
        results = {"world8": w8.result(), "train": (train_ref, w4.result()[0]),
                   "dryrun": {n: f.result() for n, f in dry.items()}}
    results["stdout"] = out.getvalue()
    return results


@pytest.fixture(scope="module")
def world8(ranks):
    return ranks["world8"]


@pytest.fixture(scope="module")
def train4(ranks):
    return ranks["train"]


# --- the tests -----------------------------------------------------------------

def _single_key(name):
    family, d, P, _, _, p = FORWARDS[name]
    return family, d, P, p


@pytest.mark.parametrize("name", ["surface5_p4", "toric3_p2", "surface15_p8"])
def test_sharded_forward_matches_jax(world8, name):
    sharded, single = _jax_sharded(FORWARDS[name]), _jax_single(*_single_key(name))
    q, lg = world8[0]["forward"][name]
    np.testing.assert_allclose(q, sharded[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lg, sharded[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(q, single[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(lg, single[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(q > 0, single[0] > 0)
    # every rank holds the whole, same output
    for r in world8[1:]:
        np.testing.assert_array_equal(r["forward"][name][0], q)
        np.testing.assert_array_equal(r["forward"][name][1], lg)


def test_halo_modes_agree(world8):
    """gather, all_to_all and ring exchanges give the same decode, that of
    JAX on one device; all_to_all and ring bit for bit."""
    got = {m: world8[0]["forward"][f"modes_{m}"] for m in ("gather", "alltoall", "ring")}
    ref = _jax_single(*_single_key("modes_gather"))
    for m, (q, lg) in got.items():
        np.testing.assert_allclose(q, got["gather"][0], rtol=0, atol=1e-5, err_msg=m)
        np.testing.assert_allclose(lg, got["gather"][1], rtol=0, atol=1e-5, err_msg=m)
        np.testing.assert_allclose(q, ref[0], rtol=0, atol=1e-4, err_msg=m)
        np.testing.assert_allclose(lg, ref[1], rtol=0, atol=1e-4, err_msg=m)
    for a, b in zip(got["alltoall"], got["ring"]):
        np.testing.assert_array_equal(a, b)
    f = world8[0]["forward"]
    np.testing.assert_array_equal(f["surface5_p4"][0], f["surface5_p4_ring"][0])


@pytest.mark.parametrize("halo", ["gather", "alltoall", "ring"])
def test_edge_attr_parity(world8, halo):
    """Per-edge attributes reach the message function as on one device
    (``tpugnn.mp.bipartite_round`` on the whole graph)."""
    import jax.numpy as jnp

    from tpugnn.mp import NodeStates as JNodeStates
    from tpugnn.mp import bipartite_round as jbipartite_round

    graph, xc, xq, attr = _jax_edge_inputs()
    msg = lambda xc_e, xq_e, ea: jnp.tanh(xc_e + 2.0 * xq_e) * ea
    upd = lambda old, agg: old + agg
    ref = jbipartite_round(graph, JNodeStates(xc, xq), message_to_qubit=msg,
                           message_to_check=msg, update_check=upd, update_qubit=upd,
                           edge_attr=attr)
    parts = sorted((r["edge"][halo] for r in world8[:4]), key=lambda t: t[0])
    assert [p[0] for p in parts] == [0, 1, 2, 3]
    np.testing.assert_allclose(np.concatenate([p[1] for p in parts]), np.asarray(ref.check),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([p[2] for p in parts]), np.asarray(ref.qubit),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("halo", ["alltoall", "ring"])
@pytest.mark.parametrize("halo_dtype,tol", [("bfloat16", 0.05), ("int8", 0.08)])
def test_compressed_halo_matches_jax(world8, halo, halo_dtype, tol):
    name = f"surface5_p4_{halo}_{halo_dtype}"
    q, lg = world8[0]["forward"][name]
    ref_q, ref_l = _jax_sharded(FORWARDS[name])
    np.testing.assert_allclose(q, ref_q, rtol=0, atol=5e-3)
    np.testing.assert_allclose(lg, ref_l, rtol=0, atol=5e-3)
    assert (np.sign(q) == np.sign(ref_q)).mean() >= 0.999
    f32 = world8[0]["forward"]["surface5_p4" if halo == "alltoall" else "surface5_p4_ring"]
    np.testing.assert_allclose(q, f32[0], atol=tol, rtol=tol)
    np.testing.assert_allclose(lg, f32[1], atol=tol, rtol=tol)
    assert (np.sign(q) == np.sign(f32[0])).mean() > 0.995
    assert not np.array_equal(q, f32[0])       # the wire did compress


def test_unknown_halo_dtype_raises_on_the_ranks(world8):
    assert all("halo_dtype" in r["bad_dtype"] for r in world8)


def test_sharded_train_step_matches_jax_grad(train4):
    ref, (loss, grads, params) = train4
    assert abs(loss - ref["loss"]) <= 1e-5
    assert set(grads) == set(ref["grads"])
    gmax = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for k, r in ref["grads"].items():
        err = float(np.abs(grads[k].reshape(r.shape) - r).max())
        assert err <= 1e-5 * gmax, f"{k}: {err / gmax} of the largest gradient"
    moved = 0.0
    for k, r in ref["params"].items():
        np.testing.assert_allclose(params[k].reshape(r.shape), r, rtol=0, atol=1e-4,
                                   err_msg=k)
        moved = max(moved, float(np.abs(r - ref["start"][k]).max()))
    assert moved > 1e-3


@pytest.mark.parametrize("halo_dtype", ["bfloat16", "int8"])
def test_compressed_halo_train_step_learns(world8, halo_dtype):
    """``test_halo_compression.py``'s criteria: the compressed step's loss
    near the f32 sharded step's, its updates of the same sign almost
    everywhere and not vanishing through the quantised wire."""
    s0_ref, s1_ref, loss_ref = world8[0]["steps"]["float32"]
    s0_q, s1_q, loss_q = world8[0]["steps"][halo_dtype]
    assert np.isfinite(loss_q)
    assert abs(loss_q - loss_ref) < 0.05
    upd_ref = np.concatenate([(s1_ref[k] - s0_ref[k]).ravel() for k in sorted(s0_ref)])
    upd_q = np.concatenate([(s1_q[k] - s0_q[k]).ravel() for k in sorted(s0_q)])
    moved = np.abs(upd_ref) > 1e-6
    assert (np.sign(upd_q[moved]) == np.sign(upd_ref[moved])).mean() > 0.9
    total = float(np.abs(upd_q).sum())
    assert total > 1e-3
    assert total > 0.3 * float(np.abs(upd_ref).sum())
    # every rank applied the same update
    for r in world8[1:]:
        for k, v in r["steps"][halo_dtype][1].items():
            np.testing.assert_array_equal(v, s1_q[k])


@pytest.mark.parametrize("n,data,graph", [(1, 1, 1), (2, 1, 2), (4, 1, 4), (8, 2, 4)])
def test_dryrun_all_device_counts(ranks, n, data, graph):
    """Every rank prints the JAX package's line with the same loss; dryrun
    returns rank 0's."""
    loss = ranks["dryrun"][n]
    assert np.isfinite(loss)
    head = f"dryrun: mesh=(data={data}, graph={graph}) graph=surface_d5 loss="
    lines = [line for line in ranks["stdout"].splitlines() if line.startswith(head)]
    assert lines == [f"{head}{loss:.4f}"] * n, lines
