"""Narrower models on the rounds kernels' 128 columns, and the wrappers' choice
of kernel by graph, width and state type.

The narrowest pack of the rounds kernels (K1, K2a/K2b, K5) is 128 columns.
A model of width h < 128 runs on states and packs zero-padded to 128, with the
LayerNorm's mean and variance over the first h columns (``width=h`` in the
plain versions).  Here the plain twins of that padded function are held to
the real-width plain versions and to the JAX package's kernels in interpret
mode (h=24, as ``decoder_rounds_tiled`` and ``decoder_rounds_roll`` run a
model of that width), its adjoint to the unpadded gradients; and the CUDA
wrappers, with stubbed libraries, to the C entry point each call must
reach on every graph (the kernels keep no gather panels, so no graph
takes a variant).  Tolerances are those of
tests/test_torch_port_fused_rounds.py (states) and
tests/test_torch_port_backward.py (gradients).
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.kernels import fused_decoder as jfd
from tpugnn.kernels import roll_gather as jrg
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig
from tpugnn_torch.kernels import fused_backward as fb
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.kernels import roll_gather as rg
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models import decoder as dec
from tpugnn_torch.sampling import sample_batch
from tpugnn_torch.tanner import build_circuit_code, build_code
from tpugnn_torch.train.loop import train_step
from tpugnn_torch.train.optim import make_optimizer

torch.set_num_threads(1)

# states: tests/test_torch_port_fused_rounds.py
ATOL, RTOL = 5e-4, 1e-3
BF16_MEAN_ABS = 1e-4
BF16_SHARE_DIFFERENT = 0.01
# gradients: tests/test_torch_port_backward.py
G_ATOL, G_RTOL = 2e-3, 2e-3
W_ATOL, W_RTOL = 2e-3, 5e-3
BF16_REL = 2e-2
PLAN_FIELDS = ("cell_of_check", "cell_of_qubit", "mask_c", "mask_q", "deg_c", "deg_q")


def _weights(h, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f in fd.RoundWeights._fields:
        vec = f.startswith(("b", "ln")) or f in ("uc_s", "uc_b0", "uc_b1", "uq_b0", "uq_b1")
        shp = (1, h) if vec else (h, h)
        w = rng.standard_normal(shp).astype(np.float32) * (0.2 if vec else h ** -0.5)
        out[f] = (w + (1.0 if f.endswith("scale") else 0.0)).astype(np.float32)
    return out


def _states(jg, h, batch, seed):
    """States with zero padded rows and a +-1 syndrome feature on real checks."""
    rng = np.random.default_rng(seed)
    cm, qm = np.asarray(jg.check_mask), np.asarray(jg.qubit_mask)
    xc = rng.standard_normal((batch, jg.n_checks_pad, h)).astype(np.float32) * cm[None, :, None]
    xq = rng.standard_normal((batch, jg.n_qubits_pad, h)).astype(np.float32) * qm[None, :, None]
    syn = np.sign(rng.standard_normal((batch, jg.n_checks_pad, 1))).astype(np.float32)
    return xc, xq, syn * cm[None, :, None]


def _case(d, h, batch, seed):
    """(jax graph, torch graph, numpy weights, torch weights, torch states)."""
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    w = _weights(h, seed)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    xc, xq, syn = (torch.from_numpy(a) for a in _states(jg, h, batch, seed + 1))
    return jg, tg, w, tw, (xc, xq, syn)


def _padded_rounds(tg, tw, states, rounds, dtype, h):
    """The padded twin: packs and states zero-padded to 128, the LayerNorm
    over the first h columns; returns the 128-wide f32 outputs."""
    dt = fd.STATE_DTYPES[dtype]
    mats, vecs = fd.pad_packs(*fd.pack_weights(tw, dt))
    xc, xq = fd.pad_states(*states[:2])
    return fd.rounds_packed(xc, xq, states[2], fd.make_operators(tg), mats, vecs,
                            rounds=rounds, dtype=dt, width=h)


def _assert_states_close(got, ref, dtype):
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        assert g.shape == r.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL)
        else:
            diff = np.abs(g - r)
            assert diff.mean() <= BF16_MEAN_ABS, diff.mean()
            assert (diff > 0).mean() <= BF16_SHARE_DIFFERENT, (diff > 0).mean()


def _assert_padded_zero(outs, h):
    for o in outs:
        assert o.shape[-1] == fd.WIDTH
        assert torch.count_nonzero(o[..., h:]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [24, 64, 96])
def test_padded_rounds_equal_real_width(h, dtype):
    """rounds_packed on operands padded to 128 with width=h equals
    rounds_plain at width h, and leaves every padded column exactly 0."""
    _, tg, _, tw, states = _case(5, h, 4, seed=h)
    got = _padded_rounds(tg, tw, states, 3, dtype, h)
    _assert_padded_zero(got, h)
    ref = fd.rounds_plain(*states, fd.make_operators(tg), tw, rounds=3, state_dtype=dtype)
    _assert_states_close([g[..., :h] for g in got], ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_rounds_match_jax_interpret(dtype):
    """At h=24 the padded twin equals the JAX package's Pallas kernel
    (decoder_rounds_tiled, interpret mode) on a model of width 24."""
    h, rounds = 24, 2
    jg, tg, w, tw, states = _case(3, h, 4, seed=7)
    got = _padded_rounds(tg, tw, states, rounds, dtype, h)
    ref = jfd.decoder_rounds(*(jnp.asarray(s.numpy()) for s in states), jfd.make_operators(jg),
                             jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
                             rounds=rounds, interpret=True, compute_dtype=dtype)
    _assert_states_close([g[..., :h] for g in got], ref, dtype)


def _padded_roll(tg, tw, states, rounds, dtype, h):
    plan = rg.plan_for_graph(tg)
    ops = rg.pad_raster(rg.to_raster(*states, plan, tw, dtype))
    out = rg.roll_rounds_plain(ops, rounds=rounds, width=h)
    _assert_padded_zero([o.float() for o in out], h)
    return rg.from_raster(out[0][..., :h], out[1][..., :h], plan)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [24, 64, 96])
def test_padded_roll_equals_real_width(h, dtype):
    """The roll twin on padded raster operands (pad_raster, width=h) equals
    decoder_rounds_roll at width h, and leaves every padded column 0."""
    _, tg, _, tw, states = _case(5, h, 4, seed=30 + h)
    got = _padded_roll(tg, tw, states, 3, dtype, h)
    ref = rg.decoder_rounds_roll(*states, rg.plan_for_graph(tg), tw, rounds=3,
                                 state_dtype=dtype)
    _assert_states_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_roll_matches_jax_interpret(dtype):
    """At h=24 the padded roll twin equals the JAX package's roll kernel
    (decoder_rounds_roll, interpret mode) on a model of width 24."""
    h, rounds = 24, 2
    jg, tg, w, tw, states = _case(3, h, 4, seed=9)
    got = _padded_roll(tg, tw, states, rounds, dtype, h)
    plan = jrg.raster_plan(jg)
    ref = jrg.decoder_rounds_roll(
        *(jnp.asarray(s.numpy()) for s in states),
        tuple(jnp.asarray(getattr(plan, f)) for f in PLAN_FIELDS),
        (plan.d, plan.l_pad, plan.offs_c, plan.offs_q),
        jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
        rounds=rounds, interpret=True, compute_dtype=dtype, slot_dtype="float32",
        block_batch=8)
    _assert_states_close(got, ref, dtype)


def _grads(tg, tw, states, rounds, dtype, pad, cot):
    """Gradients of a random linear functional of both outputs through the
    plain versions, on the kernels' padded operands (padded_rounds, as the
    kernels take them) or at the model's width (trained_rounds)."""
    xc, xq, syn = (s.clone().requires_grad_(True) for s in states)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tw._asdict().items()}
    w, ops = fd.RoundWeights(**leaves), fd.make_operators(tg)
    if pad:
        oc, oq = fb.padded_rounds(xc, xq, syn, ops, *fd.pack_weights_f32(w), rounds, dtype,
                                  kernels=False)
    else:
        oc, oq = fb.trained_rounds(xc, xq, syn, ops, w, rounds, dtype, kernels=False)
    assert oc.shape == states[0].shape and oq.shape == states[1].shape
    ((oc * cot[0]).sum() + (oq * cot[1]).sum()).backward()
    out = {"dxc": xc.grad, "dxq": xq.grad, "dsyn": syn.grad}
    out.update({k: v.grad for k, v in leaves.items()})
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [24, 64])
def test_padded_gradients_equal_unpadded(h, dtype):
    """Through the padded path (F.pad outside the autograd Function, the
    masked LayerNorm and its adjoint inside) every gradient, of the input
    states, the syndrome feature and all 25 round-weight leaves, has the
    leaf's own shape and equals the unpadded plain version's."""
    _, tg, _, tw, states = _case(3, h, 4, seed=50 + h)
    rng = np.random.default_rng(h)
    cot = [torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
           for s in states[:2]]
    got = _grads(tg, tw, states, 2, dtype, True, cot)
    ref = _grads(tg, tw, states, 2, dtype, False, cot)
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if dtype == "bfloat16":
            rel = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-6)
            assert rel <= BF16_REL, f"{k}: relative error {rel}"
        elif k in ("dxc", "dxq", "dsyn"):
            np.testing.assert_allclose(g, r, atol=G_ATOL, rtol=G_RTOL, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g, r, atol=W_ATOL * scale, rtol=W_RTOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_cotangent_reaches_a_padded_column(dtype):
    """K2b's plain version on padded operands (width=h), given the output
    cotangents the wrapper's slice leaves (0 on the padded columns), returns
    exactly 0 on every padded column of the state cotangents and every
    padded row and column of the pack gradients."""
    h, rounds = 24, 2
    _, tg, _, tw, states = _case(3, h, 2, seed=61)
    mats32, vecs32 = fd.pad_packs(*fd.pack_weights_f32(tw))
    xc, xq = fd.pad_states(*states[:2])
    ops = fd.make_operators(tg)
    _, _, sc, sq = fb.rounds_fwd_stash_plain(xc, xq, states[2], ops, mats32, vecs32,
                                             rounds=rounds, state_dtype=dtype, width=h)
    rng = np.random.default_rng(3)
    cot_c, cot_q = fd.pad_states(*(torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)) for x in states[:2]))
    dxc, dxq, _, dmats, dvecs = fb.rounds_vjp_plain(sc, sq, states[2], ops, mats32, vecs32,
                                                    cot_c, cot_q, state_dtype=dtype, width=h)
    for t in (dxc, dxq, dvecs):
        assert torch.count_nonzero(t[..., h:]) == 0
    assert torch.count_nonzero(dmats[:, h:, :]) == 0
    assert torch.count_nonzero(dmats[:, :, h:]) == 0
    assert torch.count_nonzero(dxc[..., :h]) > 0 and torch.count_nonzero(dmats) > 0


def _rounds_on_cpu(pad):
    """decoder_rounds of a training step on the plain versions: on the
    kernels' padded operands (padded_rounds) or at the model's width."""
    def rounds(xc, xq, syn, ops, w, r, dt):
        if pad:
            return fb.padded_rounds(xc, xq, syn, ops, *fd.pack_weights_f32(w), r, dt,
                                    kernels=False)
        return fb.trained_rounds(xc, xq, syn, ops, w, r, dt, kernels=False)
    return rounds


def test_train_step_on_the_padded_path_equals_unpadded(monkeypatch):
    """A train step of a width-24 model whose rounds run on the padded path
    (as on a card) moves every parameter as the unpadded path does, and the
    parameter tree keeps the model's width: no padded entry reaches it."""
    cfg = ExperimentConfig(
        code=CodeConfig(family="surface", distance=3, p=0.05),
        model=ModelConfig(hidden=24, msg_hidden=24, rounds=2, backend="fused",
                          qubit_head="pauli4"),
        train=TrainConfig(batch=8, steps=4, warmup_steps=1))
    graph = build_code("surface", 3).to("cpu")
    batch = sample_batch(torch.Generator().manual_seed(1), graph, 0.1, 8)
    after = {}
    for pad in (False, True):
        model = GNNDecoder(cfg.model, k=graph.k).init_random(torch.Generator().manual_seed(2))
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        opt = make_optimizer(cfg, model.parameters())
        monkeypatch.setattr(dec, "decoder_rounds", _rounds_on_cpu(pad))
        train_step(model, opt, graph, batch, cfg)
        after[pad] = {n: p.detach().clone() for n, p in model.named_parameters()}
        assert {n: tuple(p.shape) for n, p in after[pad].items()} == shapes
    for n, p in after[False].items():
        torch.testing.assert_close(after[True][n], p, atol=1e-6, rtol=1e-5, msg=n)


# --- the CUDA wrappers with stubbed libraries (CPU tensors standing in) ---

class _RoundsLibrary:
    """A library of the rounds kernels (csrc/wide_rounds.cuh) as far as a
    launch: records (library, entry, arguments) of each launch."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def wide_rounds_bwd_scratch_bytes(self, code, b, m, n, dc, dq, w):
        return 16

    def wide_rounds_bwd_segments(self):
        return 4

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((self.name, entry, args))
            return 0
        return launch


ROUNDS_LIBRARIES = ("wide_rounds", "wide_rounds_tf32", "wide_backward", "wide_backward_tf32")


@pytest.fixture
def rounds_library(monkeypatch):
    """The four rounds libraries stubbed, every other library a failure of
    the test that loads it; the launches in order as (library, entry,
    arguments)."""
    from tpugnn_torch.kernels import _build

    calls = []
    libs = {n: _RoundsLibrary(n, calls) for n in ROUNDS_LIBRARIES}
    monkeypatch.setattr(_build, "load_library",
                        lambda name: libs[name] if name in libs else pytest.fail(f"loaded {name}"))
    monkeypatch.setattr(fd, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(rg, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    fd.reset_launch_counts()
    rg.reset_launch_counts()
    return calls


def _graph(d, circuit=False):
    return (build_circuit_code("surface", d, d) if circuit else build_code("surface", d)).to("cpu")


def _k1_call(d, h, dtype, batch=2, circuit=False):
    """A K1 call on the surface code of distance d (with ``circuit``, its
    circuit-level graph over d rounds) on zero states of width h."""
    g = _graph(d, circuit)
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _weights(h, 0).items()})
    xc = torch.zeros((batch, g.n_checks_pad, h))
    xq = torch.zeros((batch, g.n_qubits_pad, h))
    return g, (xc, xq, xc[..., :1], fd.make_operators(g), w, 2, dtype)


def _train_call(args):
    """K2a then K2b under autograd on a K1 call's arguments."""
    w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in args[4]])
    out_c, out_q = fb.trained_rounds(*args[:4], w, args[5], args[6], kernels=True)
    (out_c.sum() + out_q.sum()).backward()
    return out_c, out_q


def _launched():
    c = {**fd.launch_counts(), **rg.launch_counts()}
    return {k: v for k, v in c.items() if v}


@pytest.mark.parametrize("h", [64, 96])
def test_k1_wrapper_pads_narrow_models(h, rounds_library):
    """A model of width h < 128 reaches the kernel at W = 128 with the
    model's width as its LayerNorm width and comes back at width h."""
    _, args = _k1_call(5, h, "float32")
    out_c, out_q = fd._rounds_cuda(*args)
    ((lib, name, a),) = rounds_library
    assert (lib, name) == ("wide_rounds_tf32", "wide_rounds_launch") and a[20:22] == (128, h)
    assert out_c.shape[-1] == h and out_q.shape[-1] == h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["k1", "k2a", "k2"])
@pytest.mark.parametrize("h", [64, 96, 128])
def test_packs_up_to_128_reach_the_wgmma_kernels(h, entry, dtype, rounds_library):
    """Packs of at most 128 columns reach the wgmma rounds libraries at W =
    128, in the state type's library, with the model's width as the
    LayerNorm's: K1 (no stash), K2a alone (its stash) and K2a then K2b
    under autograd (K2b with the message width for its ties), counted under
    the 128-column names and no wide one."""
    code, tdt = (0 if dtype == "float32" else 1), fd.STATE_DTYPES[dtype]
    g, args = _k1_call(5, h, dtype)
    m, n = g.n_checks_pad, g.n_qubits_pad
    if entry == "k1":
        out = fd._rounds_cuda(*args)
        want = {"fused_rounds": 1}
    elif entry == "k2a":
        mats32, vecs32 = fd.pad_packs(*fd.pack_weights_f32(args[4]), 128)
        xc, xq = fd.pad_states(*args[:2], width=128)
        out = fb._fwd_stash_cuda(xc, xq, args[2], args[3], mats32, vecs32, 2, dtype, h)
        assert out[2].shape == (2, 2, m, 128) and out[2].dtype == tdt
        out = [o[..., :h] for o in out[:2]]
        want = {"fused_rounds_fwd_stash": 1}
    else:
        out = _train_call(args)
        want = {"fused_rounds_fwd_stash": 1, "fused_rounds_bwd": 1}
    assert out[0].shape[-1] == h and out[1].shape[-1] == h
    assert _launched() == want
    fwd = rounds_library[0]
    # (dtype code, 13 pointers, B, M, N, Dc, Dq, R, W, width, stream)
    assert fwd[:2] == (fd.wide_library(tdt), "wide_rounds_launch")
    assert fwd[2][0] == code and fwd[2][14:17] == (2, m, n) and fwd[2][19:22] == (2, 128, h)
    assert (fwd[2][10] is None) == (entry == "k1")
    if entry == "k2":
        lib, name, b = rounds_library[1]
        assert (lib, name) == (fd.wide_library(tdt, backward=True), "wide_rounds_bwd_launch")
        # (dtype code, 28 pointers, B, M, N, Dc, Dq, R, W, width, msg_width,
        #  chunks, stream)
        assert b[0] == code and b[29:32] == (2, m, n) and b[34:38] == (2, 128, h, h)
        assert b[38] == fb.wgrad_chunks(128)
    assert len(rounds_library) == (2 if entry == "k2" else 1)


GRAPHS = [(3, False), (11, False), (13, False), (15, False), (3, True), (5, True), (7, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["k1", "k2"])
@pytest.mark.parametrize("d,circuit", GRAPHS)
def test_every_graph_takes_the_one_kernel(d, circuit, entry, dtype, rounds_library):
    """Every graph, the surface codes past d=11 and the circuit graphs
    whose gather panels the 128-column kernels kept in global memory
    included, takes the same entry points with its own rows and slots: K1,
    or K2a and K2b, one launch each, no panel variant and no other
    library."""
    tdt = fd.STATE_DTYPES[dtype]
    g, args = _k1_call(d, 128, dtype, batch=3, circuit=circuit)
    ops = args[3]
    shape = (3, g.n_checks_pad, g.n_qubits_pad, ops[0].shape[1], ops[3].shape[1])
    if entry == "k1":
        fd._rounds_cuda(*args)
        assert _launched() == {"fused_rounds": 1}
        ((lib, name, a),) = rounds_library
        assert (lib, name) == (fd.wide_library(tdt), "wide_rounds_launch")
        assert a[14:19] == shape
    else:
        _train_call(args)
        assert _launched() == {"fused_rounds_fwd_stash": 1, "fused_rounds_bwd": 1}
        (_, fwd, a), (lib, bwd, b) = rounds_library
        assert (fwd, bwd) == ("wide_rounds_launch", "wide_rounds_bwd_launch")
        assert lib == fd.wide_library(tdt, backward=True)
        assert a[14:19] == shape and b[29:34] == shape


@pytest.mark.parametrize("entry,h", [("k1", 160), ("k5", 160), ("k2", 160), ("k1", 640),
                                     ("k5", 640), ("k2", 640)])
def test_wrappers_route_widths_above_128(entry, h, rounds_library):
    """H = 160 reaches the wide instantiations, padded to 256, from every
    rounds wrapper (K1; K5; K2a and K2b under autograd), with the LayerNorm
    over 160 columns, counted under the wide names; past 512 (H = 640)
    every wrapper raises a ValueError that names that limit, before any
    library call."""
    g, args = _k1_call(3, h, "float32")
    m, n = g.n_checks_pad, g.n_qubits_pad
    if entry == "k1":
        call = lambda: fd._rounds_cuda(*args)
    elif entry == "k5":
        plan = rg.plan_for_graph(g)
        call = lambda: rg._roll_rounds_cuda(rg.to_raster(*args[:3], plan, args[4], "float32"),
                                            rounds=1)
    else:
        call = lambda: _train_call(args)
    if h > fd.WIDE_MAX:
        with pytest.raises(ValueError, match="at most 512"):
            call()
        assert not rounds_library and not _launched()
        return
    out_c, out_q = call()
    assert out_c.shape[-1] == h and out_q.shape[-1] == h
    names = [name for _, name, _ in rounds_library]
    if entry == "k1":
        ((_, name, a),) = rounds_library
        # (dtype code, 13 pointers, B, M, N, Dc, Dq, R, W, width, stream)
        assert name == "wide_rounds_launch" and a[0] == 0
        assert a[14:17] == (2, m, n) and a[19:22] == (2, 256, 160)
        assert a[10] is None and a[11] is None            # no stash
        assert _launched() == {"fused_rounds_wide": 1}
    elif entry == "k5":
        ((_, name, a),) = rounds_library
        # (dtype code, slot16, 12 pointers, B, L, R, W, width, stream)
        assert name == "wide_roll_launch" and a[:2] == (0, 0)
        assert a[14:19] == (2, plan.l_pad, 1, 256, 160)
        assert _launched() == {"roll_rounds_wide": 1}
    else:
        assert names == ["wide_rounds_launch", "wide_rounds_bwd_launch"]
        fwd, bwd = (a for _, _, a in rounds_library)
        assert fwd[10] is not None and fwd[11] is not None   # K2a: the stash
        # (dtype code, 28 pointers, B, M, N, Dc, Dq, R, W, width, msg_width,
        #  chunks, stream)
        assert bwd[29:32] == (2, m, n) and bwd[34:38] == (2, 256, 160, 160)
        assert _launched() == {"fused_rounds_fwd_stash_wide": 1, "fused_rounds_bwd_wide": 1}


def _msg_weights(h, mh, seed=0):
    """Round weights of width h and message width mh (tensors)."""
    w = _weights(max(h, mh), seed)
    msg_in = ("wd_c", "ws_c", "wd_q", "ws_q")
    out = {}
    for k, v in w.items():
        if k in msg_in:
            v = v[:h, :mh]
        elif k in ("b0_c", "b0_q"):
            v = v[:, :mh]
        elif k in ("wo_c", "wo_q"):
            v = v[:mh, :h]
        else:
            v = v[:v.shape[0] if v.shape[0] == 1 else h, :h]
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return fd.RoundWeights(**out)


@pytest.mark.parametrize("h,mh,route", [(32, 96, "128"), (32, 16, "128"), (32, 160, "wide"),
                                        (200, 96, "wide"), (32, 1000, "refused")])
def test_msg_hidden_other_than_hidden_routes_by_pack_width(h, mh, route, rounds_library):
    """msg_hidden may differ from hidden, packed at the larger width: a pack
    of at most 128 columns reaches K1 at W = 128 (H=32, MH=96 with the
    LayerNorm over 32 and width 32 returned; MH < H packs at H), a wider one
    at the next multiple of 128 (H=32 with MH=160, and H=200 with MH=96, at
    256), and past 512 it is refused with the limit named, before a library
    call."""
    g = build_code("surface", 5).to("cpu")
    xc = torch.zeros((2, g.n_checks_pad, h))
    xq = torch.zeros((2, g.n_qubits_pad, h))
    call = lambda: fd._rounds_cuda(xc, xq, xc[..., :1], fd.make_operators(g),
                                   _msg_weights(h, mh), 2, "float32")
    if route == "refused":
        with pytest.raises(ValueError, match="at most 512"):
            call()
        assert not rounds_library
        return
    out_c, out_q = call()
    assert out_c.shape[-1] == h and out_q.shape[-1] == h
    assert fd.pack_weights_f32(_msg_weights(h, mh))[0].shape[-1] == max(h, mh)
    ((_, name, a),) = rounds_library
    wid = 128 if route == "128" else 256
    assert name == "wide_rounds_launch" and a[20:22] == (wid, h)
    assert _launched() == {"fused_rounds" if route == "128" else "fused_rounds_wide": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("d,circuit", [(3, False), (3, True)])
def test_k2a_stash_equals_k1_through_the_plain_versions(d, circuit, h, dtype):
    """K2a is K1 with a stash: through the plain versions, on operands
    padded to 128 columns with the LayerNorm over the model's h, K2a's
    outputs equal K1's bit for bit, its stash entry 0 holds the inputs in
    the state type and entry r K1's states after r rounds."""
    tdt = fd.STATE_DTYPES[dtype]
    g = _graph(d, circuit)
    ops = fd.make_operators(g)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _weights(h, 3).items()})
    gen = torch.Generator().manual_seed(5)
    xc = torch.randn((2, g.n_checks_pad, h), generator=gen)
    xq = torch.randn((2, g.n_qubits_pad, h), generator=gen)
    syn = torch.sign(torch.randn((2, g.n_checks_pad, 1), generator=gen))
    mats32, vecs32 = fd.pad_packs(*fd.pack_weights_f32(tw), 128)
    xc, xq = fd.pad_states(xc, xq, width=128)
    width = h if h < 128 else None
    rounds = 3
    oc, oq, sc, sq = fb.rounds_fwd_stash_plain(xc, xq, syn, ops, mats32, vecs32, rounds=rounds,
                                               state_dtype=dtype, width=width)
    mats, vecs = fd.cast_packs(mats32, vecs32, tdt)
    assert sc.shape == (rounds, 2, g.n_checks_pad, 128) and sc.dtype == tdt
    for r in range(rounds + 1):
        kc, kq = fd.rounds_packed(xc, xq, syn, ops, mats, vecs, rounds=r, dtype=tdt, width=width)
        if r < rounds:
            assert torch.equal(sc[r], kc.to(tdt)) and torch.equal(sq[r], kq.to(tdt))
        else:
            assert torch.equal(oc, kc) and torch.equal(oq, kq)
