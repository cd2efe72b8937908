"""The fused backend at msg_hidden != hidden and with per-round weights,
against the JAX package.

The configurations of ``tests/test_fused.py:25-46``: ``GNNDecoder(backend=
'fused')`` at hidden=32, msg_hidden=48, R=3, with ``weight_tied`` True and
False, on surface d=3 and d=5 and toric d=3.  The JAX model's parameters
(the flax ``FusedRoundCell`` tree; without weight tying every round leaf
stacked [R, ...] by ``nn.scan``) load into the port through
``params_from_flax``, and the same numpy syndromes go through both.  On the
CPU the port runs the rounds' plain versions: the packs zero-padded to
max(H, MH) = 48 and, where MH > H, the states too, the LayerNorm over H.

Tolerances (f32): the forward is held to the JAX test's own atol 2e-4 /
rtol 1e-4 on the logits.  Gradients of a random linear functional of both
heads' logits, leaf by leaf: both sides differ only in f32 summation order
(the port folds ``wo @ ua`` once, JAX applies them in turn), which through
3 LayerNorm'd rounds and their adjoints stays some 1e-6 of a leaf's largest
entry; each leaf is held to atol 1e-4 of its largest entry and rtol 1e-3.
The rounds alone at MH != H are held to the JAX package's Pallas kernel in
interpret mode with the bounds of tests/test_torch_port_fused_rounds.py
(f32 atol 5e-4 / rtol 1e-3; bf16 mean 1e-4 and at most 1% of entries
apart) and its kernel VJP with those of tests/test_torch_port_backward.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.kernels import fused_decoder as jfd
from tpugnn.kernels.fused_backward import kernel_trained_rounds
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.kernels import roll_gather as rg
from tpugnn_torch.models import GNNDecoder, PallasDecoder
from tpugnn_torch.models.convert import flatten_tree, params_from_flax
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4            # tests/test_fused.py:40-46
G_ATOL_SHARE, G_RTOL = 1e-4, 1e-3
H, MH, R = 32, 48, 3
# the rounds alone: tests/test_torch_port_fused_rounds.py and
# tests/test_torch_port_backward.py
R_ATOL, R_RTOL = 5e-4, 1e-3
BF16_MEAN_ABS, BF16_SHARE_DIFFERENT = 1e-4, 0.01
V_ATOL, V_RTOL, VW_ATOL, VW_RTOL = 2e-3, 2e-3, 2e-3, 5e-3

GRAPHS = [("surface", 3), ("surface", 5), ("toric", 3)]


def _pair(family, d, weight_tied, batch=8, seed=0):
    """(torch graph, JAX model, JAX params, port model, syndromes): the JAX
    fused model's parameters with every leaf moved off its init (non-zero
    biases and LayerNorm offsets), the port's loaded from them."""
    jg = jax_build_code(family, d)
    kw = dict(hidden=H, msg_hidden=MH, rounds=R, weight_tied=weight_tied, backend="fused")
    jm = JaxGNNDecoder(JaxModelConfig(**kw), k=jg.k)
    rng = np.random.default_rng(seed + d)
    syn = (rng.random((batch, jg.n_checks_pad)) < 0.15).astype(np.float32)
    syn *= np.asarray(jg.check_mask)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(syn))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    tm = GNNDecoder(ModelConfig(**kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, build_code(family, d).to("cpu"), jm, params, tm, syn


@pytest.mark.parametrize("family,d", GRAPHS)
@pytest.mark.parametrize("weight_tied", [True, False])
def test_fused_forward_matches_jax_fused(family, d, weight_tied):
    jg, tg, jm, params, tm, syn = _pair(family, d, weight_tied)
    if not weight_tied:
        assert tm.rounds.msg_to_check.w_dst.shape == (R, H, MH)
    ref = jm.apply(params, jg, jnp.asarray(syn))
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.logical_logits.numpy(), np.asarray(ref.logical_logits),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("family,d", [("surface", 3), ("toric", 3)])
@pytest.mark.parametrize("weight_tied", [True, False])
def test_fused_gradients_match_jax_grad(family, d, weight_tied):
    """Every parameter leaf's gradient through the port's autograd Function
    (the plain forward-with-stash and adjoint on the CPU; per round without
    weight tying) against ``jax.grad`` of the JAX fused model."""
    jg, tg, jm, params, tm, syn = _pair(family, d, weight_tied, batch=4, seed=10)
    n_head = 4 if jm.cfg.qubit_head == "pauli4" else 2
    rng = np.random.default_rng(20 + d)
    cot_q = rng.standard_normal((4, jg.n_qubits_pad, n_head)).astype(np.float32)
    cot_l = rng.standard_normal((4, 2 * jg.k)).astype(np.float32)

    def loss(p):
        out = jm.apply(p, jg, jnp.asarray(syn))
        return jnp.sum(out.qubit_logits * cot_q) + jnp.sum(out.logical_logits * cot_l)

    ref = flatten_tree(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    ref = {k.removeprefix("params/").replace("/", "."): v for k, v in ref.items()}
    out = tm(tg, torch.from_numpy(syn))
    ((out.qubit_logits * torch.from_numpy(cot_q)).sum()
     + (out.logical_logits * torch.from_numpy(cot_l)).sum()).backward()
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k], r, atol=G_ATOL_SHARE * float(np.abs(r).max()),
                                   rtol=G_RTOL, err_msg=k)


def _round_weights(seed):
    """Round weights of width H and message width MH (RoundWeights' fields)."""
    rng = np.random.default_rng(seed)
    shapes = dict(wd_c=(H, MH), ws_c=(H, MH), b0_c=(1, MH), wo_c=(MH, H),
                  wd_q=(H, MH), ws_q=(H, MH), b0_q=(1, MH), wo_q=(MH, H))
    out = {}
    for f in fd.RoundWeights._fields:
        shp = shapes.get(f, (1, H) if f.startswith(("b", "ln", "uc_s", "uc_b", "uq_b"))
                         else (H, H))
        scale = 0.2 if shp[0] == 1 else shp[0] ** -0.5
        w = rng.standard_normal(shp) * scale + (1.0 if f.endswith("scale") else 0.0)
        out[f] = w.astype(np.float32)
    return out


def _round_case(d, batch, seed):
    jg = jax_build_code("surface", d)
    rng = np.random.default_rng(seed)
    cm, qm = np.asarray(jg.check_mask), np.asarray(jg.qubit_mask)
    xc = rng.standard_normal((batch, jg.n_checks_pad, H)).astype(np.float32) * cm[None, :, None]
    xq = rng.standard_normal((batch, jg.n_qubits_pad, H)).astype(np.float32) * qm[None, :, None]
    syn = np.sign(rng.standard_normal((batch, jg.n_checks_pad, 1))).astype(np.float32)
    return jg, build_code("surface", d).to("cpu"), (xc, xq, syn * cm[None, :, None])


def test_packs_pad_the_message_width():
    """The packs of a model with MH > H are [10, MH, MH] and [14, MH]: the
    matrices and vectors of width H or MH zero-padded, so no padded entry
    is non-zero; with MH < H they are [10, H, H]."""
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _round_weights(1).items()})
    mats, vecs = fd.pack_weights_f32(w)
    assert fd.pack_width(w) == MH and mats.shape == (10, MH, MH) and vecs.shape == (14, MH)
    torch.testing.assert_close(mats[0, :H, :], w.wd_c)
    torch.testing.assert_close(mats[3, :, :H], w.wo_c @ w.uc_a)
    # rows past H of the matrices a state multiplies, columns past H of
    # those whose product is a state's width, lanes past H of every vector
    # but b0
    assert torch.count_nonzero(mats[[0, 1, 2, 4, 5, 6, 7, 9], H:, :]) == 0
    assert torch.count_nonzero(mats[[1, 3, 4, 6, 8, 9], :, H:]) == 0
    assert torch.count_nonzero(vecs[[1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13], H:]) == 0
    narrow = w._replace(**{f: getattr(w, f)[:, :16] for f in ("wd_c", "ws_c", "wd_q", "ws_q",
                                                               "b0_c", "b0_q")},
                        wo_c=w.wo_c[:16], wo_q=w.wo_q[:16])
    mats, vecs = fd.pack_weights_f32(narrow)
    assert mats.shape == (10, H, H) and torch.count_nonzero(mats[0, :, 16:]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rounds_plain_matches_jax_kernel_at_msg_width(dtype):
    """rounds_plain at H=32, MH=48 against the JAX package's Pallas kernel
    (decoder_rounds_tiled in interpret mode, which pads MH to 128 with
    pad_msg_width) on the same weights and states."""
    jg, tg, states = _round_case(3, 4, seed=5)
    w = _round_weights(6)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    got = fd.rounds_plain(*(torch.from_numpy(a) for a in states), fd.make_operators(tg), tw,
                          rounds=2, state_dtype=dtype)
    ref = jfd.decoder_rounds(*(jnp.asarray(a) for a in states), jfd.make_operators(jg),
                             jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
                             rounds=2, interpret=True, compute_dtype=dtype)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r, np.float32)
        assert g.shape == r.shape == (4, r.shape[1], H)
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=R_ATOL, rtol=R_RTOL)
        else:
            diff = np.abs(g - r)
            assert diff.mean() <= BF16_MEAN_ABS and (diff > 0).mean() <= BF16_SHARE_DIFFERENT


def test_trained_rounds_match_jax_kernel_vjp_at_msg_width():
    """The port's differentiable rounds on the CPU at H=32, MH=48 (the plain
    forward-with-stash and adjoint on states padded to 48, the LayerNorm
    over 32) against ``jax.grad`` through the JAX package's kernel VJP in
    interpret mode: the state, syndrome and every weight leaf's gradient."""
    jg, tg, (xc, xq, syn) = _round_case(3, 3, seed=7)
    w = _round_weights(8)
    rng = np.random.default_rng(9)
    cot_c, cot_q = (rng.standard_normal(a.shape).astype(np.float32) for a in (xc, xq))
    f = kernel_trained_rounds(jfd.make_operators(jg), rounds=2, compute_dtype="float32",
                              interpret=True)

    def loss(xc, xq, syn, w):
        oc, oq = f(xc, xq, syn, w)
        return jnp.sum(oc * cot_c) + jnp.sum(oq * cot_q)

    gx = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn),
        jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()}))
    ref = {"dxc": gx[0], "dxq": gx[1], "dsyn": gx[2],
           **{k: getattr(gx[3], k) for k in fd.RoundWeights._fields}}
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (xc, xq, syn)]
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    oc, oq = fd.decoder_rounds(*ts, fd.make_operators(tg), fd.RoundWeights(**leaves), 2)
    assert oc.shape == xc.shape and oq.shape == xq.shape
    ((oc * torch.from_numpy(cot_c)).sum() + (oq * torch.from_numpy(cot_q)).sum()).backward()
    got = {"dxc": ts[0].grad, "dxq": ts[1].grad, "dsyn": ts[2].grad,
           **{k: v.grad for k, v in leaves.items()}}
    for k, r in ref.items():
        g, r = got[k].numpy(), np.asarray(r, np.float32)
        assert g.shape == r.shape, k
        if k in ("dxc", "dxq", "dsyn"):
            np.testing.assert_allclose(g, r, atol=V_ATOL, rtol=V_RTOL, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g, r, atol=VW_ATOL * scale, rtol=VW_RTOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roll_rounds_at_msg_width_equal_the_fused_rounds(dtype):
    """The roll rounds (K5's plain version, on the raster padded to MH with
    the LayerNorm over H) at H=32, MH=48 give the fused rounds' states on
    the real rows, within the tolerances the roll tests hold them to."""
    _, tg, states = _round_case(5, 3, seed=11)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _round_weights(12).items()})
    ts = [torch.from_numpy(a) for a in states]
    got = rg.decoder_rounds_roll(*ts, rg.plan_for_graph(tg), tw, rounds=2, state_dtype=dtype)
    ref = fd.rounds_plain(*ts, fd.make_operators(tg), tw, rounds=2, state_dtype=dtype)
    real = (tg.check_mask > 0, tg.qubit_mask > 0)
    for g, r, keep in zip(got, ref, real):
        g, r = g[:, keep].numpy(), r[:, keep].numpy()
        assert g.shape == r.shape and g.shape[-1] == H
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=R_ATOL, rtol=R_RTOL)
        else:
            assert np.abs(g - r).max() <= 0.25 and np.abs(g - r).mean() <= 1e-2


def test_untied_fused_model_runs_a_round_at_a_time(monkeypatch):
    """Without weight tying the fused model calls the rounds once a round,
    each call one round on that round's weights (the kernels' wrapper on a
    card), and round r reads slice r of every stacked leaf."""
    from tpugnn_torch.models import decoder as dec

    g = build_code("surface", 3).to("cpu")
    model = GNNDecoder(ModelConfig(hidden=H, msg_hidden=MH, rounds=R, backend="fused",
                                   weight_tied=False), k=g.k)
    calls = []
    real = dec.decoder_rounds

    def spy(xc, xq, syn, ops, w, rounds, dtype):
        calls.append((rounds, w.wd_c.data_ptr(), w.lnq_bias.shape))
        return real(xc, xq, syn, ops, w, rounds, dtype)

    monkeypatch.setattr(dec, "decoder_rounds", spy)
    with torch.no_grad():
        model(g, torch.zeros((2, g.n_checks_pad)))
    stack = model.rounds.msg_to_check.w_dst
    assert [c[0] for c in calls] == [1] * R
    assert [c[1] for c in calls] == [stack[r].data_ptr() for r in range(R)]
    assert all(c[2] == (1, H) for c in calls)
    with pytest.raises(ValueError, match="round_weights"):
        model.rounds.round_weights()
    with pytest.raises(ValueError, match="weight-tied"):
        PallasDecoder(model)
