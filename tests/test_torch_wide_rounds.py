"""The rounds above 128 columns: the plain versions against the JAX package,
and the wrappers' routing to the wide kernels.

A model's packs run at the kernel width W = 128 ceil(max(hidden,
msg_hidden) / 128): at 128 the 128-column kernels, above it the wide ones
(``csrc/wide_rounds.cuh``: four libraries, forward and backward in each state
type), up to 512.  The plain versions take any width:
here they are held to the JAX package's Pallas kernels in interpret mode at
W = 256 (H = 256; H = 160 with MH = 200) and W = 384 on surface and toric
d=3, to JAX's fused model at hidden=160, msg_hidden=200 (forward and
gradients, the CPU training path included), and the wrappers, with stubbed
libraries, to the C entry point each call must reach and its width
arguments.

Tolerances: f32 rounds those of tests/test_torch_port_fused_rounds.py (atol
5e-4 / rtol 1e-3), the model those of tests/test_fused.py (atol 2e-4 / rtol
1e-4) and its gradients those of tests/test_torch_fused_configs.py (each
leaf atol 1e-4 of its largest entry, rtol 1e-3).  The bf16 bounds there (a
mean of 1e-4 and at most 1% of entries apart, met at 32 columns) do not
hold at these widths for any two orders of summation: a bf16 rounding flip
of one entry of hs or hc moves a whole row through the products and the
LayerNorm, so both grow with the width (at 256 after two rounds 2.5% of
entries apart, means 6e-5 to 1.3e-4; both versions 3e-3 from the rounds in
f32 on average, 25 to 50 times their distance from each other).  In their
place the port's bf16 rounds lie as far from the rounds in f32 as JAX's do,
in max and in mean, within a factor BF16_F32_RATIO either way
(chip_smoke.py's BF16_F64_RATIO holds the kernels so): a wrong gather moves
the port far past JAX's distance, a rounding point left out brings it
nearer.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.kernels import fused_decoder as jfd
from tpugnn.kernels import roll_gather as jrg
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.kernels import fused_backward as fb
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.kernels import roll_gather as rg
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import flatten_tree, params_from_flax
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

ATOL, RTOL = 5e-4, 1e-3
BF16_F32_RATIO = 1.25
M_ATOL, M_RTOL = 2e-4, 1e-4
G_ATOL_SHARE, G_RTOL = 1e-4, 1e-3
PLAN_FIELDS = ("cell_of_check", "cell_of_qubit", "mask_c", "mask_q", "deg_c", "deg_q")
WIDTHS = [(256, 256), (160, 200), (384, 384)]


def _weights(h, mh, seed):
    """Round weights of width h and message width mh (numpy)."""
    rng = np.random.default_rng(seed)
    shapes = dict(wd_c=(h, mh), ws_c=(h, mh), b0_c=(1, mh), wo_c=(mh, h),
                  wd_q=(h, mh), ws_q=(h, mh), b0_q=(1, mh), wo_q=(mh, h))
    out = {}
    for f in fd.RoundWeights._fields:
        vec = f.startswith(("b", "ln")) or f in ("uc_s", "uc_b0", "uc_b1", "uq_b0", "uq_b1")
        shp = shapes.get(f, (1, h) if vec else (h, h))
        scale = 0.2 if shp[0] == 1 else shp[0] ** -0.5
        w = rng.standard_normal(shp) * scale + (1.0 if f.endswith("scale") else 0.0)
        out[f] = w.astype(np.float32)
    return out


def _case(family, d, h, mh, batch, seed):
    """(jax graph, torch graph, numpy weights, numpy states)."""
    jg = jax_build_code(family, d)
    rng = np.random.default_rng(seed)
    cm, qm = np.asarray(jg.check_mask), np.asarray(jg.qubit_mask)
    xc = rng.standard_normal((batch, jg.n_checks_pad, h)).astype(np.float32) * cm[None, :, None]
    xq = rng.standard_normal((batch, jg.n_qubits_pad, h)).astype(np.float32) * qm[None, :, None]
    syn = np.sign(rng.standard_normal((batch, jg.n_checks_pad, 1))).astype(np.float32)
    return jg, build_code(family, d).to("cpu"), _weights(h, mh, seed + 1), (
        xc, xq, syn * cm[None, :, None])


def _tw(w):
    return fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})


def _jw(w):
    return jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()})


def _assert_states_close(got, ref, dtype, f32=None):
    """The port's states ``got`` against JAX's ``ref``; in bf16 both also
    against the rounds in f32, ``f32``."""
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        assert g.shape == r.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL)
        else:
            e = np.asarray(f32[i], np.float32)
            for stat in (np.max, np.mean):
                port, jax_ = stat(np.abs(g - e)), stat(np.abs(r - e))
                assert jax_ / BF16_F32_RATIO <= port <= BF16_F32_RATIO * jax_, (
                    stat.__name__, port, jax_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,mh", WIDTHS)
@pytest.mark.parametrize("family", ["surface", "toric"])
def test_plain_rounds_match_jax_interpret(family, h, mh, dtype):
    """rounds_plain at W = 256 and 384 against the JAX package's Pallas
    kernel (decoder_rounds_tiled, interpret mode, which pads MH to a
    multiple of 128) on d=3, B=4, R=2."""
    jg, tg, w, states = _case(family, 3, h, mh, 4, seed=h + mh)
    run = lambda dt: fd.rounds_plain(*(torch.from_numpy(a) for a in states),
                                     fd.make_operators(tg), _tw(w), rounds=2, state_dtype=dt)
    got = run(dtype)
    ref = jfd.decoder_rounds(*(jnp.asarray(a) for a in states), jfd.make_operators(jg), _jw(w),
                             rounds=2, interpret=True, compute_dtype=dtype)
    assert got[0].shape[-1] == h
    _assert_states_close(got, ref, dtype, run("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,mh", [(256, 256), (160, 200)])
def test_plain_roll_matches_jax_interpret(h, mh, dtype):
    """decoder_rounds_roll's plain version (on the raster padded to the
    packs' width, the LayerNorm over H) against the JAX package's roll
    kernel in interpret mode on surface d=3, B=4, R=2."""
    jg, tg, w, states = _case("surface", 3, h, mh, 4, seed=3 * h + mh)
    run = lambda dt: rg.decoder_rounds_roll(*(torch.from_numpy(a) for a in states),
                                            rg.plan_for_graph(tg), _tw(w), rounds=2,
                                            state_dtype=dt)
    got = run(dtype)
    plan = jrg.raster_plan(jg)
    ref = jrg.decoder_rounds_roll(
        *(jnp.asarray(a) for a in states),
        tuple(jnp.asarray(getattr(plan, f)) for f in PLAN_FIELDS),
        (plan.d, plan.l_pad, plan.offs_c, plan.offs_q), _jw(w),
        rounds=2, interpret=True, compute_dtype=dtype, slot_dtype="float32", block_batch=4)
    _assert_states_close(got, ref, dtype, run("float32"))


def _model_pair(batch, seed):
    """(jax graph, torch graph, JAX model, its params, port model, syndromes)
    at hidden=160, msg_hidden=200, R=2 on surface d=3, every leaf moved off
    its init, the port's parameters loaded from JAX's."""
    jg = jax_build_code("surface", 3)
    kw = dict(hidden=160, msg_hidden=200, rounds=2, backend="fused")
    jm = JaxGNNDecoder(JaxModelConfig(**kw), k=jg.k)
    rng = np.random.default_rng(seed)
    syn = (rng.random((batch, jg.n_checks_pad)) < 0.15).astype(np.float32)
    syn *= np.asarray(jg.check_mask)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(syn))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    tm = GNNDecoder(ModelConfig(**kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, build_code("surface", 3).to("cpu"), jm, params, tm, syn


def test_fused_model_matches_jax_at_msg_width_above_128():
    """GNNDecoder(backend='fused') at hidden=160, msg_hidden=200 against
    the JAX fused model: both heads' logits."""
    jg, tg, jm, params, tm, syn = _model_pair(6, seed=3)
    ref = jm.apply(params, jg, jnp.asarray(syn))
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=M_ATOL, rtol=M_RTOL)
    np.testing.assert_allclose(got.logical_logits.numpy(), np.asarray(ref.logical_logits),
                               atol=M_ATOL, rtol=M_RTOL)


def test_cpu_training_takes_msg_hidden_above_128():
    """The CPU training path (the plain forward-with-stash and adjoint under
    autograd) at hidden=160, msg_hidden=200: every parameter leaf's gradient
    against jax.grad of the JAX fused model."""
    jg, tg, jm, params, tm, syn = _model_pair(4, seed=5)
    rng = np.random.default_rng(7)
    n_head = 4 if jm.cfg.qubit_head == "pauli4" else 2
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


@pytest.mark.parametrize("wid", [128, 256, 384])
def test_packs_in_fragment_order(wid):
    """The split f32 pack of the 128-column kernels at width W holds, for
    matrix i, k-step s, n-tile j and lane 4 g + t, the entries their B
    fragments read; the wide kernels' packs (``wgmma_pack``) hold, for
    matrix i and slab s, element (k, n) at the no-swizzle K-major core-matrix
    offset csrc/wide_mma.cuh's header gives, bf16 as it is and f32 as its
    TF32 halves hi then lo."""
    mats = torch.randn((10, wid, wid), generator=torch.Generator().manual_seed(wid))
    split = fd.tf32_split_pack(mats)
    assert split.shape == (10, wid // 8, wid // 8, 8, 4, 2, 2)
    hi = fd.tf32_round(mats)
    lo = fd.tf32_round(mats - hi)
    rng = np.random.default_rng(wid)
    for _ in range(50):
        i, g, t = rng.integers(10), rng.integers(8), rng.integers(4)
        s, j = rng.integers(wid // 8), rng.integers(wid // 8)
        n = 8 * j + g
        assert split[i, s, j, g, t, 0, 0] == hi[i, 8 * s + t, n]
        assert split[i, s, j, g, t, 0, 1] == hi[i, 8 * s + t + 4, n]
        assert split[i, s, j, g, t, 1, 1] == lo[i, 8 * s + t + 4, n]
    for dt, te, halves in ((torch.bfloat16, 8, (mats.to(torch.bfloat16),)),
                           (torch.float32, 4, (hi, lo))):
        ks = fd.wide_slab_rows(wid, dt)
        flat = fd.wgmma_pack(mats, dt).reshape(10, wid // ks, -1)
        for _ in range(50):
            i, k, n = rng.integers(10), rng.integers(wid), rng.integers(wid)
            off = ((n // 8) * (ks // te) + (k % ks) // te) * 8 * te + (n % 8) * te + k % te
            for h, m in enumerate(halves):
                assert flat[i, k // ks, h * ks * wid + off] == m[i, k, n]


def test_readers_list_every_slot_once_in_order():
    """The transposed slot lists K2b's gather adjoint walks: every real slot
    r D + k once, under the source row it reads, ascending."""
    g = build_code("surface", 5).to("cpu")
    src_c, mask_c, _, src_q, mask_q, _ = fd.make_operators(g)
    idx_c, _ = fd._slot_tables(src_c, mask_c, src_q, mask_q)
    off, lst = fb._readers(idx_c, g.n_qubits_pad)
    assert off[0] == 0 and off[-1] == len(lst) == int((idx_c >= 0).sum())
    flat = idx_c.reshape(-1)
    for s in range(g.n_qubits_pad):
        entries = lst[off[s]:off[s + 1]].tolist()
        assert entries == sorted(entries) and all(flat[e] == s for e in entries)


# ---------------------------------------------------------------------------
# The wrappers' routing, with stub libraries (CPU tensors stand in for the
# card's).

def _align16(x):
    return (x + 15) // 16 * 16


def _roll_smem_bf16(l_pad):
    """bf16 K5's shared memory as csrc/roll_gather.cu sizes it: two
    swizzled panels, two 144-row chunk buffers, 64-row slabs (32 where 64
    do not fit) and the slot bits."""
    for sr in (64, 32):
        s = 2 * _align16(l_pad * 256) + 2 * 144 * 136 * 2 + 2 * sr * 136 * 2 + _align16(2 * l_pad)
        if s <= fd.SMEM_LIMIT or sr == 32:
            return s


def _roll_gp_smem_bf16(l_pad):
    return 2 * 144 * 136 * 2 + 2 * 64 * 136 * 2 + _align16(2 * l_pad)


class _Library:
    """Any library as far as a launch: records (entry, args) and stops;
    sizes shared memory with ``sizes`` (entry -> function), 0 otherwise."""

    def __init__(self, name, calls, sizes):
        self.name, self.calls, self.sizes = name, calls, sizes

    def __getattr__(self, entry):
        if entry in self.sizes:
            return self.sizes[entry]
        if entry.endswith(("_smem_bytes", "_scratch_bytes")):
            return lambda *a: 0
        if entry == "wide_rounds_bwd_segments":
            return lambda: 4

        def launch(*args):
            self.calls.append((self.name, entry, args))
            return 0
        return launch


@pytest.fixture
def libraries(monkeypatch):
    """Every library stubbed; the calls in order as (library, entry, args)."""
    from tpugnn_torch.kernels import _build

    calls = []
    sizes = {"roll_rounds_smem_bytes": lambda code, l: _roll_smem_bf16(l) if code == 1 else 0,
             "roll_rounds_tc_gpanels_smem_bytes": _roll_gp_smem_bf16}
    monkeypatch.setattr(_build, "load_library", lambda name: _Library(name, calls, sizes))
    monkeypatch.setattr(fd, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(rg, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    fd.reset_launch_counts()
    rg.reset_launch_counts()
    return calls


def _call(entry, d, h, mh, dtype, batch=2):
    """One call of a rounds wrapper ('k1', 'k5', or 'k2': K2a and K2b under
    autograd) on zero states of width h and weights of message width mh;
    returns the torch graph."""
    g = build_code("surface", d).to("cpu")
    w = _tw(_weights(h, mh, 0))
    xc = torch.zeros((batch, g.n_checks_pad, h))
    xq = torch.zeros((batch, g.n_qubits_pad, h))
    syn = xc[..., :1]
    ops = fd.make_operators(g)
    if entry == "k1":
        out = fd._rounds_cuda(xc, xq, syn, ops, w, 2, dtype)
    elif entry == "k5":   # as decoder_rounds_roll hands it over on a card
        ops = rg.to_raster(xc, xq, syn, rg.plan_for_graph(g), w, dtype)
        width = None
        if ops.mats.shape[-1] > h:
            ops, width = rg.pad_raster(ops, ops.mats.shape[-1]), h
        out = [o[..., :h] for o in rg._roll_rounds_cuda(ops, rounds=2, width=width)]
    else:
        w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in w])
        out = fb.trained_rounds(xc, xq, syn, ops, w, 2, dtype, kernels=True)
        (out[0].sum() + out[1].sum()).backward()
    assert out[0].shape[-1] == h and out[1].shape[-1] == h
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["k1", "k5"])
def test_width_128_keeps_the_128_column_kernels(entry, dtype, libraries):
    """A model of width 128 reaches today's 128-column entry points with
    today's arguments (width 128; K1's library by state type, f32 and bf16
    building apart), and no wide one."""
    g = _call(entry, 5, 128, 128, dtype)
    ((lib, name, a),) = libraries
    code = 0 if dtype == "float32" else 1
    if entry == "k1":
        assert lib == ("fused_rounds_tf32" if code == 0 else "fused_rounds")
        assert name == "fused_rounds_launch" and a[0] == code and a[16] == 128
        assert fd.launch_counts()["fused_rounds"] == 1
    else:
        assert lib == ("roll_gather_tf32" if code == 0 else "roll_gather")
        assert name == "roll_rounds_launch" and a[0] == code
        assert a[12:16] == (2, rg.plan_for_graph(g).l_pad, 2, 128)
        assert rg.launch_counts()["roll_rounds"] == 1
    assert not fd.launch_counts()["fused_rounds_wide"] and not rg.launch_counts()[
        "roll_rounds_wide"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["k1", "k5", "k2"])
@pytest.mark.parametrize("h,mh,wid", [(256, 256, 256), (160, 200, 256), (320, 384, 384)])
def test_wide_widths_reach_the_wide_kernels(h, mh, wid, entry, dtype, libraries):
    """Packs wider than 128 reach the wide kernels' entry points, and only
    those, with the width W (the next multiple of 128) and the LayerNorm's
    width H: K1, K5, and K2a then K2b (with the message width MH for its
    ties), each counted under its wide name.  f32 K2b at a width it refuses
    (``fb.F32_BWD_REFUSED``) raises after K2a's launch, before its own."""
    code = 0 if dtype == "float32" else 1
    tdt = fd.STATE_DTYPES[dtype]
    if entry == "k2" and code == 0 and wid in fb.F32_BWD_REFUSED:
        with pytest.raises(ValueError, match=f"refuses f32 states at {wid} columns"):
            _call(entry, 3, h, mh, dtype)
        assert [name for _, name, _ in libraries] == ["wide_rounds_launch"]
        assert fd.launch_counts()["fused_rounds_fwd_stash_wide"] == 1
        assert not fd.launch_counts()["fused_rounds_bwd_wide"]
        return
    g = _call(entry, 3, h, mh, dtype)
    assert {lib for lib, _, _ in libraries} == {fd.wide_library(tdt)} | (
        {fd.wide_library(tdt, backward=True)} if entry == "k2" else set())
    m, n = g.n_checks_pad, g.n_qubits_pad
    if entry == "k1":
        ((_, name, a),) = libraries
        # (dtype code, 13 pointers, B, M, N, Dc, Dq, R, W, width, stream)
        assert name == "wide_rounds_launch" and a[0] == code
        assert a[14:17] == (2, m, n) and a[19:22] == (2, wid, h) and a[10] is None
        assert fd.launch_counts()["fused_rounds_wide"] == 1
    elif entry == "k5":
        ((_, name, a),) = libraries
        # (dtype code, slot16, 12 pointers, B, L, R, W, width, stream)
        assert name == "wide_roll_launch" and a[:2] == (code, 0)
        assert a[14:19] == (2, rg.plan_for_graph(g).l_pad, 2, wid, h)
        assert rg.launch_counts()["roll_rounds_wide"] == 1
    else:
        (_, fwd, a), (_, bwd, b) = libraries
        assert (fwd, bwd) == ("wide_rounds_launch", "wide_rounds_bwd_launch")
        assert a[10] is not None and a[19:22] == (2, wid, h)
        # (dtype code, 28 pointers, B, M, N, Dc, Dq, R, W, width, msg_width,
        #  chunks, stream); f32 reads its ties' operands, bf16 none
        assert b[0] == code and b[29:32] == (2, m, n) and b[34:38] == (2, wid, h, mh)
        assert (b[14] is not None) == (code == 0) and (b[18] is not None) == (code == 0)
        c = fd.launch_counts()
        assert c["fused_rounds_fwd_stash_wide"] == 1 and c["fused_rounds_bwd_wide"] == 1
    assert sum(fd.launch_counts().values()) + sum(rg.launch_counts().values()) == (
        2 if entry == "k2" else 1)


@pytest.mark.parametrize("d,entry", [(15, "roll_rounds_launch"),
                                     (17, "roll_rounds_tc_gpanels_launch"),
                                     (19, "roll_rounds_tc_gpanels_launch")])
def test_bf16_k5_past_shared_memory_takes_global_panels(d, entry, libraries):
    """bf16 K5 keeps its shared layout through d=15 (227,328 B with 32-row
    slabs) and past it (d=17: 264,336 B; d=19: 301,344) takes the variant
    with both panels in a per-block bf16 scratch [grid, 2 l_pad, 128] on a
    persistent grid of min(B, SMs) blocks, counted as roll_rounds_tc_gpanels
    (the f32 variant, another kernel, counts as roll_rounds_gpanels)."""
    plan = rg.plan_for_graph(build_code("surface", d))
    assert _roll_smem_bf16(plan.l_pad) == {15: 227328, 17: 264336, 19: 301344}[d]
    _call("k5", d, 128, 128, "bfloat16", batch=200)
    ((lib, name, a),) = libraries
    assert (lib, name) == ("roll_gather", entry)
    if d > 15:
        # (slot16, 9 pointers, panels, offs, B, l_pad, R, width, grid, stream)
        assert a[0] == 0 and a[12:17] == (200, plan.l_pad, 2, 128, 132)
        assert rg.launch_counts()["roll_rounds_tc_gpanels"] == 1
        assert not rg.launch_counts()["roll_rounds_gpanels"]
    else:
        assert rg.launch_counts()["roll_rounds"] == 1


@pytest.mark.parametrize("entry", ["k1", "k5", "k2"])
def test_no_library_call_past_the_wide_limit(entry, libraries):
    """Past the wide kernels' 512 columns (MH = 600) every wrapper raises a
    ValueError naming the limit, before any library call."""
    with pytest.raises(ValueError, match="at most 512"):
        _call(entry, 3, 64, 600, "float32")
    assert not libraries
    assert not any(fd.launch_counts().values()) and not any(rg.launch_counts().values())
