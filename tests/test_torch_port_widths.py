"""Narrower models on the rounds kernels' 128 columns, and the wrappers' choice
of kernel by graph, width and state type.

The rounds kernels (K1, K2a/K2b, K5) are built for 128 columns.  A model of
width h < 128 runs on states and packs zero-padded to 128, with the
LayerNorm's mean and variance over the first h columns (``width=h`` in the
plain versions).  Here the plain twins of that padded function are held to
the real-width plain versions and to the JAX package's kernels in interpret
mode (h=24, as ``decoder_rounds_tiled`` and ``decoder_rounds_roll`` run a
model of that width), its adjoint to the unpadded gradients; and the CUDA
wrappers, with a stubbed library that sizes shared memory as the card's
does, to the C entry point each call must reach.  Tolerances are those of
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


# --- the CUDA wrappers with a stubbed library (CPU tensors standing in) ---

def _align16(x):
    return (x + 15) & ~15


def _k1_smem(code, m, n, dc, dq, gpanels=False, stash=False):
    """fused_rounds_smem_bytes / fused_rounds_gpanels_smem_bytes /
    fused_rounds_stash_smem_bytes as csrc/fused_rounds_tf32.cu (f32) and
    csrc/fused_rounds.cu (bf16) compute them.
    f32 K1 and K2a (one kernel, its stash flag aside): panels, one 128-row
    f32 chunk buffer (row stride 132) and 16-row slabs of split TF32
    weights (1 KB a row: two beside shared panels, three beside global
    ones), its slot tables read from global memory.  bf16 (both): swizzled
    panels (none with
    gpanels), 128-row chunk buffers, a double buffer of 64-row slabs
    (32-row where only those fit beside shared panels) and the slot
    tables."""
    tables = _align16(m * dc * 4) + _align16(n * dq * 4)
    if code == 0:
        panels = 0 if gpanels else _align16(n * 512) + _align16(m * 512)
        return panels + 128 * 132 * 4 + (3 if gpanels else 2) * 16 * 1024
    if gpanels:
        return 2 * 128 * 136 * 2 + 2 * 64 * 272 + tables
    bf = lambda sr: _align16(n * 256) + _align16(m * 256) + 2 * 128 * 136 * 2 + 2 * sr * 272
    fits = lambda sr: bf(sr) + tables <= 232448
    return (bf(32) if fits(32) and not fits(64) else bf(64)) + tables


def _k2b_layout(m, n, dc, dq):
    """The layout of bf16 K2b that csrc/fused_backward.cu's tc_layout picks,
    ``(slab rows, masks in shared memory, panels in the scratch, bytes)``:
    the first to fit of 64-row slabs and the slot masks in shared memory,
    32-row slabs and the masks, 64-row slabs, 32-row slabs beside shared
    panels, then with the panels in the scratch 64-row slabs and the masks,
    64-row slabs, 32-row slabs and the masks, 32-row slabs; slab rows 0 and
    the last one's bytes where none fits.  The work area holds the panels
    (shared only) and two chunk buffers, or S5's staging (4 x 3 x 32 rows)
    where that is more; then the slab ring, the slot and readers tables."""
    stage = 4 * 3 * 32 * 272
    tables = (_align16(m * dc * 4) + _align16(n * dq * 4) + _align16((n + 1 + m * dc) * 4)
              + _align16((m + 1 + n * dq) * 4))
    order = [(64, True, False), (32, True, False), (64, False, False), (32, False, False),
             (64, True, True), (64, False, True), (32, True, True), (32, False, True)]
    for sr, live, gp in order:
        work = max(2 * 128 * 272 + (0 if gp else _align16(n * 256) + _align16(m * 256)), stage)
        size = work + (16 * (m * dc + n * dq) if live else 0) + 2 * sr * 272 + tables
        if size <= 232448:
            return sr, live, gp, size
    return 0, False, True, size


def _k2b_f32_layout(m, n, dc, dq):
    """f32 K2b's layout as csrc/fused_backward_tf32.cu picks and sizes it,
    ``(panels in the scratch, shared memory, scratch, scratch with the
    panels in it)``: the f32 panels and one 128-row chunk buffer (row
    stride 132), or S5's staging (three arrays x three 32-row chunks, row
    stride 136) where that is more, and two 16-row slabs of split weights;
    the panels move to the head of the block's scratch where that does not
    fit, leaving the chunk buffer under the staging.  The scratch: the
    readers tables, the slot masks and ties, one sample's dhs, a row of hs
    a warp and the tile's (8 samples') six f32 residual arrays a
    direction."""
    panels = _align16(n * 512) + _align16(m * 512)
    chunk, stage, ring = 128 * 132 * 4, 3 * 3 * 32 * 136 * 4, 2 * 16 * 1024
    shared = max(panels + chunk, stage) + ring
    gp = shared > 232448
    tables = _align16((n + 1 + m * dc) * 4) + _align16((m + 1 + n * dq) * 4)
    scratch = tables + 2 * 16 * (m * dc + n * dq) + (m + n) * 512 + 8 * 512 \
        + 6 * 8 * (m + n) * 512
    return (gp, max(chunk, stage) + ring if gp else shared,
            scratch + (panels if gp else 0), scratch + panels)


def _k2b_scratch(m, n, dc, dq, gp):
    """fused_rounds_bwd_scratch_bytes: with gp the panels, then the slot
    masks, one sample's rnd(dhs) and the tile's (8 samples') six bf16
    residual arrays a direction."""
    return ((m + n) * 256 if gp else 0) + 16 * (m * dc + n * dq) + (m + n) * 256 \
        + 6 * 8 * (m + n) * 256


class _K1Library:
    """The fused-rounds library as far as a launch: records each entry point
    reached with its arguments and stops."""

    def __init__(self):
        self.calls = []

    def fused_rounds_smem_bytes(self, code, m, n, dc, dq):
        return _k1_smem(code, m, n, dc, dq)

    def fused_rounds_gpanels_smem_bytes(self, code, m, n, dc, dq):
        return _k1_smem(code, m, n, dc, dq, gpanels=True)

    def fused_rounds_stash_smem_bytes(self, code, m, n, dc, dq):
        return _k1_smem(code, m, n, dc, dq, stash=True)

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((entry, args))
            return 0
        return launch


@pytest.fixture
def k1_library(monkeypatch):
    from tpugnn_torch.kernels import _build

    lib = _K1Library()
    monkeypatch.setattr(_build, "load_library", lambda name: lib if name in (
        "fused_rounds", "fused_rounds_tf32") else pytest.fail(f"loaded {name}"))
    monkeypatch.setattr(fd, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    fd.reset_launch_counts()
    return lib


class _K2bLibrary:
    """bf16 K2b's library as far as a launch (csrc/fused_backward.cu's
    entry points, sized by :func:`_k2b_layout`): records each launch."""

    def __init__(self):
        self.calls = []

    def fused_rounds_bwd_smem_bytes(self, m, n, dc, dq):
        return _k2b_layout(m, n, dc, dq)[3]

    def fused_rounds_bwd_tile(self):
        return 8

    def fused_rounds_bwd_scratch_bytes(self, m, n, dc, dq):
        return _k2b_scratch(m, n, dc, dq, _k2b_layout(m, n, dc, dq)[2])

    def fused_rounds_bwd_gpanels(self, m, n, dc, dq):
        return int(_k2b_layout(m, n, dc, dq)[2])

    def fused_rounds_bwd_launch(self, *args):
        self.calls.append(args)
        return 0


class _K2bF32Library:
    """f32 K2b's library as far as a launch (csrc/fused_backward_tf32.cu's
    entry points, sized by :func:`_k2b_f32_layout`): records each launch
    and each scratch size handed out."""

    def __init__(self):
        self.calls, self.scratch = [], []

    def fused_rounds_bwd_smem_bytes(self, m, n, dc, dq):
        return _k2b_f32_layout(m, n, dc, dq)[1]

    def fused_rounds_bwd_tile(self):
        return 8

    def fused_rounds_bwd_scratch_bytes(self, m, n, dc, dq):
        self.scratch.append(_k2b_f32_layout(m, n, dc, dq)[2])
        return self.scratch[-1]

    def fused_rounds_bwd_gpanels_scratch_bytes(self, m, n, dc, dq):
        self.scratch.append(_k2b_f32_layout(m, n, dc, dq)[3])
        return self.scratch[-1]

    def fused_rounds_bwd_gpanels(self, m, n, dc, dq):
        return int(_k2b_f32_layout(m, n, dc, dq)[0])

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((entry, args))
            return 0
        return launch


@pytest.fixture
def k2b_f32_library(k1_library, monkeypatch):
    """The stub f32 K2b library beside the stub fused-rounds one."""
    from tpugnn_torch.kernels import _build

    lib = _K2bF32Library()
    libs = {"fused_rounds": k1_library, "fused_rounds_tf32": k1_library,
            "fused_backward_tf32": lib}
    monkeypatch.setattr(_build, "load_library",
                        lambda name: libs[name] if name in libs else pytest.fail(f"loaded {name}"))
    return lib


@pytest.fixture
def k2b_library(k1_library, monkeypatch):
    """The stub K2b library beside the stub fused-rounds one."""
    from tpugnn_torch.kernels import _build

    lib = _K2bLibrary()
    libs = {"fused_rounds": k1_library, "fused_rounds_tf32": k1_library,
            "fused_backward": lib}
    monkeypatch.setattr(_build, "load_library",
                        lambda name: libs[name] if name in libs else pytest.fail(f"loaded {name}"))
    return lib


def _slot_args(g):
    """(M, N, Dc, Dq) of a graph's padded slot tables."""
    src_c, _, _, src_q, _, _ = fd.make_operators(g.to("cpu"))
    return g.n_checks_pad, g.n_qubits_pad, src_c.shape[1], src_q.shape[1]


def test_stub_sizes_shared_memory_as_the_card():
    """The stub's sizes are those csrc/fused_rounds{,_tf32}.cu compute on the
    card: f32 K1 231,424 B at d=11 (fits), 280,576 at d=13 and 337,920 at
    d=15 (over SMEM_LIMIT); f32 K2a the same (K1's kernel); bf16, and f32
    K1 without the panels, fit through d=15."""
    sizes = {}
    for d in (11, 13, 15):
        args = _slot_args(build_code("surface", d))
        sizes[d] = (_k1_smem(0, *args), _k1_smem(1, *args), _k1_smem(0, *args, gpanels=True),
                    _k1_smem(0, *args, stash=True))
    assert [sizes[d][0] for d in (11, 13, 15)] == [231424, 280576, 337920]
    assert [sizes[d][3] for d in (11, 13, 15)] == [231424, 280576, 337920]
    assert all(s[1] <= fd.SMEM_LIMIT and s[2] <= fd.SMEM_LIMIT for s in sizes.values())


def test_stub_sizes_circuit_d7_in_bf16_as_the_card():
    """bf16 on the circuit d=7 graph (M=176, N=920, Dc=14, Dq=2), as
    csrc/fused_rounds.cu and csrc/fused_backward.cu size it: K1 and K2a
    402,240 B with their panels in shared memory, 121,664 with them in
    global memory; K2b over the limit in every shared-panel layout (the
    last tried, 32-row slabs and the slot masks in the scratch, 406,464 B)
    and 178,112 in the first global one that fits (64-row slabs, the masks
    in the scratch; 64-row slabs with the masks in shared memory would take
    246,976, 32-row slabs with them 229,568).  The shared-panel layouts the
    card measured keep their bytes: K2b 195,616 at d=11 and 218,848 on
    circuit d=5."""
    args = _slot_args(build_circuit_code("surface", 7, 7))
    assert args == (176, 920, 14, 2)
    assert _k1_smem(1, *args) == 402240 and _k1_smem(1, *args, gpanels=True) == 121664
    m, n, dc, dq = args
    stage, slab32, masks = 4 * 3 * 32 * 272, 2 * 32 * 272, 16 * (m * dc + n * dq)
    tables = (_align16(m * dc * 4) + _align16(n * dq * 4) + _align16((n + 1 + m * dc) * 4)
              + _align16((m + 1 + n * dq) * 4))
    assert _align16(n * 256) + _align16(m * 256) + 2 * 128 * 272 + slab32 + tables == 406464
    assert _k2b_layout(*args) == (64, False, True, 178112)
    assert stage + 2 * slab32 + masks + tables == 246976
    assert stage + slab32 + masks + tables == 229568
    assert _k2b_layout(*_slot_args(build_code("surface", 11)))[:3] == (64, True, False)
    assert _k2b_layout(*_slot_args(build_code("surface", 11)))[3] == 195616
    assert _k2b_layout(*_slot_args(build_circuit_code("surface", 5, 5))) == (
        32, True, False, 218848)


def _k1_call(d, h, dtype, batch=2, circuit=False):
    """A K1 call on the surface code of distance d (with ``circuit``, its
    circuit-level graph over d rounds) on zero states of width h."""
    g = (build_circuit_code("surface", d, d) if circuit else build_code("surface", d)).to("cpu")
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _weights(h, 0).items()})
    xc = torch.zeros((batch, g.n_checks_pad, h))
    xq = torch.zeros((batch, g.n_qubits_pad, h))
    return g, (xc, xq, xc[..., :1], fd.make_operators(g), w, 2, dtype)


@pytest.mark.parametrize("d,dtype,entry,circuit", [
    (11, "float32", "fused_rounds_launch", False),
    (13, "float32", "fused_rounds_gpanels_launch", False),
    (15, "float32", "fused_rounds_gpanels_launch", False),
    (13, "bfloat16", "fused_rounds_launch", False),
    (15, "bfloat16", "fused_rounds_launch", False),
    (5, "bfloat16", "fused_rounds_launch", True),
    (7, "bfloat16", "fused_rounds_gpanels_launch", True),
    (7, "float32", "fused_rounds_gpanels_launch", True)])
def test_k1_wrapper_picks_the_panel_route(d, dtype, entry, circuit, k1_library):
    """Graphs whose panels overflow shared memory take the global-panel
    variant on a persistent grid of min(B, SMs) blocks, its panels in the
    state type: in f32 d=13, d=15 and circuit d=7, in bf16 circuit d=7
    alone; the rest keep the shared-panel kernel.  Each call is counted
    under its kernel's name."""
    g, args = _k1_call(d, 128, dtype, batch=200, circuit=circuit)
    out_c, out_q = fd._rounds_cuda(*args)
    ((name, a),) = k1_library.calls
    assert name == entry and out_c.shape == args[0].shape
    m, n = g.n_checks_pad, g.n_qubits_pad
    code = 0 if dtype == "float32" else 1
    if entry == "fused_rounds_gpanels_launch":
        # (dtype code, 9 operand pointers, panels, B, M, N, Dc, Dq, R, width,
        # grid, stream)
        assert a[0] == code and a[11:14] == (200, m, n) and a[16:19] == (2, 128, 132)
        assert fd.launch_counts()["fused_rounds_gpanels"] == 1
        assert fd.launch_counts()["fused_rounds"] == 0
    else:
        # (dtype code, 9 operand pointers, B, M, N, Dc, Dq, R, width, stream)
        assert a[0] == (0 if dtype == "float32" else 1) and a[10:13] == (200, m, n)
        assert a[15:17] == (2, 128)
        assert fd.launch_counts()["fused_rounds"] == 1
        assert fd.launch_counts()["fused_rounds_gpanels"] == 0


@pytest.mark.parametrize("h", [64, 96])
def test_k1_wrapper_pads_narrow_models(h, k1_library):
    """A model of width h < 128 reaches the kernel with the model's width as
    its LayerNorm width and comes back at width h."""
    _, args = _k1_call(5, h, "float32")
    out_c, out_q = fd._rounds_cuda(*args)
    ((name, a),) = k1_library.calls
    assert name == "fused_rounds_launch" and a[16] == h
    assert out_c.shape[-1] == h and out_q.shape[-1] == h


@pytest.mark.parametrize("d,batch,per_block", [(3, 8, 8), (3, 12, 4), (5, 8, 4), (5, 2, 2),
                                                (7, 8, 2), (9, 8, 1), (3, 7, 1)])
def test_k1_wrapper_stacks_small_graphs(d, batch, per_block, k1_library):
    """f32 K1 runs a small graph's samples per_block to a block, as one
    graph of per_block times the rows (each side within one 128-row chunk,
    per_block a power of two dividing the batch)."""
    g, args = _k1_call(d, 128, "float32", batch=batch)
    fd._rounds_cuda(*args)
    ((name, a),) = k1_library.calls
    m, n = g.n_checks_pad, g.n_qubits_pad
    assert fd.samples_per_block(batch, m, n) == per_block
    assert name == "fused_rounds_launch"
    assert a[10:13] == (batch // per_block, m * per_block, n * per_block)


def test_stacked_slot_tables_give_the_same_rounds():
    """The rounds on s samples laid end to end as one graph (their states
    viewed [B / s, s * rows, H], the slot tables stacked) equal the rounds
    sample by sample: what f32 K1 computes on a stacked block."""
    g = build_code("surface", 3).to("cpu")
    m, n = g.n_checks_pad, g.n_qubits_pad
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _weights(32, 3).items()})
    rng = np.random.default_rng(5)
    b, s = 8, 4
    xc = torch.from_numpy(rng.standard_normal((b, m, 32)).astype(np.float32))
    xq = torch.from_numpy(rng.standard_normal((b, n, 32)).astype(np.float32))
    syn = torch.from_numpy(np.sign(rng.standard_normal((b, m, 1))).astype(np.float32))
    ops = fd.make_operators(g)
    idx_c, idx_q = fd._slot_tables(ops[0], ops[1], ops[3], ops[4])

    def operators(idx):
        mask = (idx >= 0).float()
        return idx.clamp(min=0).long(), mask, mask.sum(1)

    stacked = (*operators(fd.stack_slot_tables(idx_c, n, s)),
               *operators(fd.stack_slot_tables(idx_q, m, s)))
    want = fd.rounds_plain(xc, xq, syn, ops, w, rounds=3)
    got = fd.rounds_plain(xc.reshape(b // s, s * m, 32), xq.reshape(b // s, s * n, 32),
                          syn.reshape(b // s, s * m, 1), stacked, w, rounds=3)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.reshape(w_.shape), w_, atol=1e-6, rtol=1e-6)


def test_k2a_keeps_its_shared_memory_check(k1_library, monkeypatch):
    """f32 K2a at d=13 takes its global-panel variant (one f32 chunk buffer
    and three weight slabs, 116,736 B), and where even that does not fit
    (here: a limit of 100,000 B) it is refused before a launch."""
    g, args = _k1_call(13, 128, "float32")
    mats32, vecs32 = fd.pack_weights_f32(args[4])
    fb._fwd_stash_cuda(args[0], args[1], args[2], args[3], mats32, vecs32, 2, "float32")
    assert [name for name, _ in k1_library.calls] == ["fused_rounds_stash_gpanels_launch"]
    assert _k1_smem(0, *_slot_args(g), gpanels=True) == 116736
    k1_library.calls.clear()
    monkeypatch.setattr(fd, "SMEM_LIMIT", 100000)
    with pytest.raises(ValueError, match="shared memory"):
        fb._fwd_stash_cuda(args[0], args[1], args[2], args[3], mats32, vecs32, 2, "float32")
    assert not k1_library.calls


@pytest.mark.parametrize("d,circuit,batch", [(13, False, 8), (13, False, 200), (5, True, 20),
                                             (7, True, 20)])
def test_f32_k2a_takes_global_panels_past_shared_memory(d, circuit, batch, k1_library):
    """f32 K2a on surface d=13 and the circuit d=5 and d=7 graphs launches
    its global-panel variant: dtype code 0, the split pack, the slot tables
    of one sample (no stacking: one sample a block at a time) on min(B,
    SMs) blocks of a persistent grid with f32 panels, and the stash [R, B,
    rows, 128] indexed by the whole batch."""
    g, args = _k1_call(d, 128, "float32", batch=batch, circuit=circuit)
    mats32, vecs32 = fd.pack_weights_f32(args[4])
    _, _, sc, sq = fb._fwd_stash_cuda(*args[:4], mats32, vecs32, 3, "float32")
    ((name, a),) = k1_library.calls
    m, n, dc, dq = _slot_args(g)
    # (dtype code, 9 operand pointers, stash_c, stash_q, panels, B, M, N, Dc,
    # Dq, R, width, grid, stream)
    assert name == "fused_rounds_stash_gpanels_launch" and a[0] == 0
    assert a[10:12] == (sc.data_ptr(), sq.data_ptr())
    assert a[13:21] == (batch, m, n, dc, dq, 3, 128, min(batch, 132))
    assert tuple(sc.shape) == (3, batch, m, 128) and sc.dtype == torch.float32
    assert tuple(sq.shape) == (3, batch, n, 128)
    assert fd.launch_counts()["fused_rounds_fwd_stash_gpanels"] == 1
    assert fd.launch_counts()["fused_rounds_fwd_stash"] == 0


def test_stub_sizes_f32_k2b_as_the_card():
    """f32 K2b's sizes as csrc/fused_backward_tf32.cu computes them: its
    panels in shared memory 231,424 B at d=11 (the layout it keeps) and
    280,576 at d=13 (over the limit); with them in the scratch 189,440 B on
    every graph (S5's staging and the slabs), taken at d=13 and on the
    circuit d=5 and d=7 graphs, whose scratch grows by their panels, (M +
    N) x 512 B."""
    cases = {"d11": _slot_args(build_code("surface", 11)),
             "d13": _slot_args(build_code("surface", 13)),
             "c5": _slot_args(build_circuit_code("surface", 5, 5)),
             "c7": _slot_args(build_circuit_code("surface", 7, 7))}
    lay = {k: _k2b_f32_layout(*v) for k, v in cases.items()}
    assert lay["d11"][:2] == (False, 231424)
    m, n = cases["d13"][:2]
    assert (m, n) == (176, 176) and (m + n) * 512 + 128 * 132 * 4 + 2 * 16 * 1024 == 280576
    for k in ("d13", "c5", "c7"):
        assert lay[k][:2] == (True, 189440)
        m, n = cases[k][:2]
        assert lay[k][2] - (lay[k][3] - (m + n) * 512) == (m + n) * 512
    assert lay["d11"][3] - lay["d11"][2] == 256 * 512


@pytest.mark.parametrize("d,circuit,entry", [
    (11, False, "fused_rounds_bwd"), (13, False, "fused_rounds_bwd_gpanels"),
    (5, True, "fused_rounds_bwd_gpanels"), (7, True, "fused_rounds_bwd_gpanels")])
def test_f32_k2b_takes_the_scratch_panel_layout(d, circuit, entry, k2b_f32_library):
    """f32 K2b keeps its shared-panel layout where it fits (d=11) and on
    d=13 and the circuit d=5 and d=7 graphs takes the layout with its
    panels in the scratch, counted apart, through the library's own
    launch; the scratch it is handed has room for every block's panels."""
    batch = 20
    g, args = _k1_call(d, 128, "float32", batch=batch, circuit=circuit)
    mats32, vecs32 = fd.pack_weights_f32(args[4])
    m, n = g.n_checks_pad, g.n_qubits_pad
    sc = torch.zeros((2, batch, m, 128))
    sq = torch.zeros((2, batch, n, 128))
    fb._bwd_cuda(sc, sq, args[2], args[3], mats32, vecs32, args[0], args[1], "float32")
    ((name, a),) = k2b_f32_library.calls
    args4 = _slot_args(g)
    # (stash_c, stash_q, syn, idx_c, idx_q, mats, mats_t, mats32, mats32_t, xn_c,
    #  xn_q, wn, vecs, ucs32, dxc, dxq, dsyn, scratch, part_mats, part_vecs,
    #  dmats, dvecs, B, M, N, Dc, Dq, R, width, msg_width, grid, stream)
    assert name == "fused_rounds_bwd_launch" and a[22:31] == (batch, *args4, 2, 128, 128, 3)
    gp, _, scratch, scratch_gp = _k2b_f32_layout(*args4)
    assert gp == (entry == "fused_rounds_bwd_gpanels")
    assert k2b_f32_library.scratch == [scratch_gp if gp else scratch]
    other = "fused_rounds_bwd" if gp else "fused_rounds_bwd_gpanels"
    assert fd.launch_counts()[entry] == 1 and fd.launch_counts()[other] == 0


def test_f32_k2b_launches_its_global_layout_on_request(k2b_f32_library):
    """``force_gpanels`` launches f32 K2b's global layout where the shared
    one fits too (d=11: the placements' comparison on the card), with the
    scratch of that layout, counted as it; bf16 K2b takes no such request."""
    g, args = _k1_call(11, 128, "float32", batch=4)
    mats32, vecs32 = fd.pack_weights_f32(args[4])
    m, n = g.n_checks_pad, g.n_qubits_pad
    sc, sq = torch.zeros((2, 4, m, 128)), torch.zeros((2, 4, n, 128))
    fb._bwd_cuda(sc, sq, args[2], args[3], mats32, vecs32, args[0], args[1], "float32",
                 force_gpanels=True)
    ((name, a),) = k2b_f32_library.calls
    assert name == "fused_rounds_bwd_gpanels_launch" and len(a) == 32
    assert k2b_f32_library.scratch == [_k2b_f32_layout(*_slot_args(g))[3]]
    assert fd.launch_counts()["fused_rounds_bwd_gpanels"] == 1
    with pytest.raises(ValueError, match="f32"):
        fb._bwd_cuda(sc.bfloat16(), sq.bfloat16(), args[2], args[3], mats32, vecs32, args[0],
                     args[1], "bfloat16", force_gpanels=True)
    assert len(k2b_f32_library.calls) == 1


@pytest.mark.parametrize("d,circuit", [(13, False), (5, True), (7, True)])
def test_f32_training_past_shared_memory_launches_both_global_variants(
        d, circuit, k1_library, k2b_f32_library):
    """A training step's rounds in f32 on surface d=13 and the circuit d=5
    and d=7 graphs go through K2a's and K2b's global-panel variants, one
    launch each, with no ValueError."""
    _, args = _k1_call(d, 128, "float32", batch=4, circuit=circuit)
    w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in args[4]])
    out_c, out_q = fb.trained_rounds(*args[:4], w, 2, "float32", kernels=True)
    (out_c.sum() + out_q.sum()).backward()
    assert [name for name, _ in k1_library.calls] == ["fused_rounds_stash_gpanels_launch"]
    assert [name for name, _ in k2b_f32_library.calls] == ["fused_rounds_bwd_launch"]
    c = fd.launch_counts()
    assert c["fused_rounds_fwd_stash_gpanels"] == 1 and c["fused_rounds_bwd_gpanels"] == 1
    assert c["fused_rounds_fwd_stash"] == c["fused_rounds_bwd"] == 0


def test_f32_training_raises_before_k2a_where_k2b_does_not_fit(k1_library, k2b_f32_library,
                                                               monkeypatch):
    """The f32 twin of the bf16 test below: where K2a fits and K2b does not
    (a limit of 150,000 B, between f32 K2a's global 116,736 and K2b's
    global 189,440 at d=13), a training call raises before any launch."""
    monkeypatch.setattr(fd, "SMEM_LIMIT", 150000)
    _, args = _k1_call(13, 128, "float32", batch=4)
    w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in args[4]])
    with pytest.raises(ValueError, match="fused backward kernel"):
        fb.trained_rounds(*args[:4], w, 2, "float32", kernels=True)
    assert not k1_library.calls and not k2b_f32_library.calls
    assert not any(fd.launch_counts().values())


@pytest.mark.parametrize("batch", [8, 200])
def test_bf16_k2a_takes_global_panels_on_circuit_d7(batch, k1_library):
    """bf16 K2a on the circuit d=7 graph launches its global-panel variant
    on min(B, SMs) blocks, with bf16 panels, and writes the stash [R, B,
    rows, 128] indexed by the whole batch B (not by the grid)."""
    g, args = _k1_call(7, 128, "bfloat16", batch=batch, circuit=True)
    mats32, vecs32 = fd.pack_weights_f32(args[4])
    _, _, sc, sq = fb._fwd_stash_cuda(*args[:4], mats32, vecs32, 3, "bfloat16")
    ((name, a),) = k1_library.calls
    m, n = g.n_checks_pad, g.n_qubits_pad
    # (dtype code, 9 operand pointers, stash_c, stash_q, panels, B, M, N, Dc,
    # Dq, R, width, grid, stream)
    assert name == "fused_rounds_stash_gpanels_launch" and a[0] == 1
    assert a[10:12] == (sc.data_ptr(), sq.data_ptr())
    assert a[13:16] == (batch, m, n) and a[18:21] == (3, 128, min(batch, 132))
    assert tuple(sc.shape) == (3, batch, m, 128) and tuple(sq.shape) == (3, batch, n, 128)
    assert sc.dtype == torch.bfloat16
    assert fd.launch_counts()["fused_rounds_fwd_stash_gpanels"] == 1
    assert fd.launch_counts()["fused_rounds_fwd_stash"] == 0


@pytest.mark.parametrize("d,circuit,entry", [
    (11, False, "fused_rounds_bwd"), (5, True, "fused_rounds_bwd"),
    (7, True, "fused_rounds_bwd_gpanels")])
def test_bf16_k2b_takes_the_scratch_panel_layout(d, circuit, entry, k2b_library):
    """bf16 K2b keeps its shared-panel layouts wherever one fits (d=11,
    circuit d=5) and on circuit d=7 launches the layout with its panels in
    the scratch, counted apart; the scratch it is handed has room for the
    panels of each of its blocks."""
    batch = 20
    g, args = _k1_call(d, 128, "bfloat16", batch=batch, circuit=circuit)
    mats32, vecs32 = fd.pack_weights_f32(args[4])
    m, n = g.n_checks_pad, g.n_qubits_pad
    sc = torch.zeros((2, batch, m, 128), dtype=torch.bfloat16)
    sq = torch.zeros((2, batch, n, 128), dtype=torch.bfloat16)
    fb._bwd_cuda(sc, sq, args[2], args[3], mats32, vecs32, args[0], args[1], "bfloat16")
    (a,) = k2b_library.calls
    grid = 3      # ceil(20 / 8) tiles, one block each
    # (stash_c, stash_q, syn, idx_c, idx_q, mats, mats_t, vecs, ucs32, dxc, dxq,
    # dsyn, scratch, part_mats, part_vecs, dmats, dvecs, B, M, N, Dc, Dq, R,
    # width, grid, stream)
    args4 = _slot_args(g)
    assert a[17:25] == (batch, *args4, 2, 128, grid)
    gp = entry == "fused_rounds_bwd_gpanels"
    assert _k2b_layout(*args4)[2] == gp
    assert k2b_library.fused_rounds_bwd_scratch_bytes(*args4) == _k2b_scratch(*args4, gp)
    other = "fused_rounds_bwd" if gp else "fused_rounds_bwd_gpanels"
    assert fd.launch_counts()[entry] == 1 and fd.launch_counts()[other] == 0


def test_bf16_training_on_circuit_d7_launches_both_global_variants(k1_library, k2b_library):
    """A training step's rounds in bf16 on the circuit d=7 graph go through
    K2a's and K2b's global-panel variants, one launch each."""
    _, args = _k1_call(7, 128, "bfloat16", batch=4, circuit=True)
    w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in args[4]])
    out_c, out_q = fb.trained_rounds(*args[:4], w, 2, "bfloat16", kernels=True)
    (out_c.sum() + out_q.sum()).backward()
    assert [name for name, _ in k1_library.calls] == ["fused_rounds_stash_gpanels_launch"]
    assert len(k2b_library.calls) == 1
    c = fd.launch_counts()
    assert c["fused_rounds_fwd_stash_gpanels"] == 1 and c["fused_rounds_bwd_gpanels"] == 1
    assert c["fused_rounds_fwd_stash"] == c["fused_rounds_bwd"] == 0


def test_training_raises_before_k2a_where_k2b_does_not_fit(k1_library, k2b_library,
                                                          monkeypatch):
    """Where K2a fits and K2b does not (here: a limit of 150,000 B, between
    K2a's 121,664 and K2b's 178,112 on circuit d=7), a training call raises
    before any launch, so no step runs a forward that its backward cannot
    follow."""
    monkeypatch.setattr(fd, "SMEM_LIMIT", 150000)
    _, args = _k1_call(7, 128, "bfloat16", batch=4, circuit=True)
    w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in args[4]])
    with pytest.raises(ValueError, match="fused backward kernel"):
        fb.trained_rounds(*args[:4], w, 2, "bfloat16", kernels=True)
    assert not k1_library.calls and not k2b_library.calls
    assert not any(fd.launch_counts().values())


class _WideLibrary:
    """The wide rounds library as far as a launch (csrc/wide_rounds.cu's
    entry points): records each launch."""

    def __init__(self):
        self.calls = []

    def wide_rounds_bwd_scratch_bytes(self, code, b, m, n, dc, dq, w):
        return 16

    def wide_rounds_bwd_segments(self):
        return 4

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((entry, args))
            return 0
        return launch


@pytest.fixture
def wide_library(k1_library, monkeypatch):
    """The stub wide library beside the stub 128-column ones: K1/K2a's, and
    K2b's and K5's that fail a test which reaches them."""
    from tpugnn_torch.kernels import _build

    lib = _WideLibrary()
    libs = {"fused_rounds": k1_library, "fused_rounds_tf32": k1_library, "wide_rounds": lib}
    monkeypatch.setattr(_build, "load_library",
                        lambda name: libs[name] if name in libs else pytest.fail(f"loaded {name}"))
    monkeypatch.setattr(rg, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    rg.reset_launch_counts()
    return lib


@pytest.mark.parametrize("entry,h", [("k1", 160), ("k5", 160), ("k2", 160), ("k1", 640),
                                     ("k5", 640), ("k2", 640)])
def test_wrappers_route_widths_above_128(entry, h, wide_library):
    """H = 160 reaches the wide kernels, padded to 256, from every rounds
    wrapper (K1; K5; K2a and K2b under autograd), with the LayerNorm over
    160 columns, and no 128-column kernel; past the wide kernels' 512 (H =
    640) every wrapper raises a ValueError that names that limit, before
    any library call."""
    g, args = _k1_call(3, h, "float32")
    m, n = g.n_checks_pad, g.n_qubits_pad
    if entry == "k1":
        call = lambda: fd._rounds_cuda(*args)
    elif entry == "k5":
        plan = rg.plan_for_graph(g)
        call = lambda: rg._roll_rounds_cuda(rg.to_raster(*args[:3], plan, args[4], "float32"),
                                            rounds=1)
    else:
        w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in args[4]])

        def call():
            out_c, out_q = fb.trained_rounds(*args[:4], w, 2, "float32", kernels=True)
            (out_c.sum() + out_q.sum()).backward()
            return out_c, out_q
    if h > fd.WIDE_MAX:
        with pytest.raises(ValueError, match="at most 512"):
            call()
        assert not wide_library.calls and not any(fd.launch_counts().values())
        return
    out_c, out_q = call()
    assert out_c.shape[-1] == h and out_q.shape[-1] == h
    names = [name for name, _ in wide_library.calls]
    if entry == "k1":
        ((name, a),) = wide_library.calls
        # (dtype code, 13 pointers, B, M, N, Dc, Dq, R, W, width, stream)
        assert name == "wide_rounds_launch" and a[0] == 0
        assert a[14:17] == (2, m, n) and a[19:22] == (2, 256, 160)
        assert a[10] is None and a[11] is None            # no stash
        assert fd.launch_counts()["fused_rounds_wide"] == 1
    elif entry == "k5":
        ((name, a),) = wide_library.calls
        # (dtype code, slot16, 12 pointers, B, L, R, W, width, stream)
        assert name == "wide_roll_launch" and a[:2] == (0, 0)
        assert a[14:19] == (2, plan.l_pad, 1, 256, 160)
        assert rg.launch_counts()["roll_rounds_wide"] == 1
    else:
        assert names == ["wide_rounds_launch", "wide_rounds_bwd_launch"]
        fwd, bwd = (a for _, a in wide_library.calls)
        assert fwd[10] is not None and fwd[11] is not None   # K2a: the stash
        # (dtype code, 28 pointers, B, M, N, Dc, Dq, R, W, width, msg_width,
        #  chunks, stream)
        assert bwd[29:32] == (2, m, n) and bwd[34:38] == (2, 256, 160, 160)
        c = fd.launch_counts()
        assert c["fused_rounds_fwd_stash_wide"] == 1 and c["fused_rounds_bwd_wide"] == 1
    assert not k128_launches()


def k128_launches():
    """The launches of the 128-column rounds kernels recorded."""
    c = {**fd.launch_counts(), **rg.launch_counts()}
    return {k: v for k, v in c.items() if v and not k.endswith("_wide")}


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
def test_msg_hidden_other_than_hidden_routes_by_pack_width(h, mh, route, wide_library):
    """msg_hidden may differ from hidden, packed at the larger width: a pack
    of at most 128 columns reaches the 128-column K1 (H=32, MH=96 with the
    LayerNorm over 32 and width 32 returned; MH < H packs at H), a wider one
    the wide K1 at the next multiple of 128 (H=32 with MH=160, and H=200
    with MH=96, at 256), and past 512 it is refused with the limit named,
    before a library call."""
    g = build_code("surface", 5).to("cpu")
    xc = torch.zeros((2, g.n_checks_pad, h))
    xq = torch.zeros((2, g.n_qubits_pad, h))
    from tpugnn_torch.kernels import _build

    k128 = _build.load_library("fused_rounds")
    call = lambda: fd._rounds_cuda(xc, xq, xc[..., :1], fd.make_operators(g),
                                   _msg_weights(h, mh), 2, "float32")
    if route == "refused":
        with pytest.raises(ValueError, match="at most 512"):
            call()
        assert not k128.calls and not wide_library.calls
        return
    out_c, out_q = call()
    assert out_c.shape[-1] == h and out_q.shape[-1] == h
    assert fd.pack_weights_f32(_msg_weights(h, mh))[0].shape[-1] == max(h, mh)
    if route == "128":
        ((name, a),) = k128.calls
        assert name == "fused_rounds_launch" and a[16] == h and not wide_library.calls
    else:
        ((name, a),) = wide_library.calls
        assert name == "wide_rounds_launch" and a[20:22] == (256, h) and not k128.calls
