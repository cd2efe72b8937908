"""The roll rounds (tpugnn_torch/kernels/roll_gather.py) and PallasDecoder
against tpugnn.

The JAX side runs as tests/kernels/test_roll_gather.py runs it: the Pallas
kernel ``decoder_rounds_roll`` in interpret mode on the CPU.  Inputs come
from numpy seeds, with the padded rows zero as the embed leaves them.
Bounds, each with what this file measured on the CPU:

* f32: atol 1e-5 on every output row, padded rows included (measured at
  most 1.5e-6): the same f32 function summed in another order.
* bf16 states (f32 slots, and ``slot16``): mean abs <= 1e-4 and at most 1%
  of the states different at all (measured: equal, but for 0.012% of the
  qubit states at d=5 with f32 slots, by 6e-8).  Both versions round at the
  same points, after every op in the bf16 slot stage; an f32 sum taken in
  another order flips a bf16 rounding now and then.  A plain version that
  rounds the slot16 sum once at the end differs on over 30% of the states
  (``test_slot16_bound_rejects_rounding_once``), so these bounds pin the
  rounding order; both are far inside JAX's own 0.08 against XLA
  (tests/kernels/test_roll_gather.py:136-141).
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
from tpugnn.models.pallas_decoder import PallasDecoder as JaxPallasDecoder
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.eval import decode_corrections, ler_monte_carlo
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.kernels import roll_gather as rg
from tpugnn_torch.models import GNNDecoder, PallasDecoder
from tpugnn_torch.models import pallas_decoder as pdm
from tpugnn_torch.models.convert import params_from_flax
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

F32_ATOL = 1e-5
BF16_MEAN_ABS = 1e-4
BF16_SHARE_DIFFERENT = 0.01
LOGITS_BF16_MAX = 0.05
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


def _jax_roll(jg, xc, xq, syn, w, rounds, cdt, sdt):
    plan = jrg.raster_plan(jg)
    arrays = tuple(jnp.asarray(getattr(plan, f)) for f in PLAN_FIELDS)
    out = jrg.decoder_rounds_roll(
        jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn), arrays,
        (plan.d, plan.l_pad, plan.offs_c, plan.offs_q),
        jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
        rounds=rounds, interpret=True, compute_dtype=cdt, slot_dtype=sdt, block_batch=8)
    return [np.asarray(o, np.float32) for o in out]


def _port_roll(d, xc, xq, syn, w, rounds, cdt, sdt):
    tg = build_code("surface", d)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    out = rg.decoder_rounds_roll(torch.from_numpy(xc), torch.from_numpy(xq),
                                 torch.from_numpy(syn), rg.plan_for_graph(tg), tw,
                                 rounds=rounds, state_dtype=cdt, slot_dtype=sdt)
    return [o.numpy() for o in out]


def _assert_bf16_close(got, ref):
    for g, r in zip(got, ref):
        diff = np.abs(g - r)
        assert diff.mean() <= BF16_MEAN_ABS, diff.mean()
        assert (diff > 0).mean() <= BF16_SHARE_DIFFERENT, (diff > 0).mean()


@pytest.mark.parametrize("d", [3, 5, 7, 11])
def test_raster_plan_equals_tpugnn(d):
    """Field for field, from the NumPy graph and from its tensors."""
    ref = jrg.raster_plan(jax_build_code("surface", d))
    g = build_code("surface", d)
    for got in (rg.raster_plan(g), rg.raster_plan(g.to("cpu")), rg.plan_for_graph(g)):
        assert (got.d, got.l_pad, got.offs_c, got.offs_q) == (
            ref.d, ref.l_pad, ref.offs_c, ref.offs_q)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert ref.l_pad == -(-(d + 1) ** 2 // 8) * 8


@pytest.mark.parametrize("family,d", [("toric", 4), ("repetition", 5), ("steane", 3)])
def test_raster_plan_is_none_off_the_surface_code(family, d):
    g = build_code(family, d)
    assert jrg.raster_plan(jax_build_code(family, d)) is None
    assert rg.raster_plan(g) is None
    assert rg.plan_for_graph(g) is None


def test_plan_for_graph_needs_the_default_padding():
    """As the JAX package's guard: the plan of the code rebuilt by name at
    the default padding applies only where the padded row counts agree."""
    assert rg.plan_for_graph(build_code("surface", 5, pad_edges=8)) is not None
    assert rg.plan_for_graph(build_code("surface", 5, pad_nodes=64)) is None


def test_rotate_sign_matches_jax_rot():
    """d=5: l_pad = 40 while L = 36, so the rotation wraps at l_pad."""
    plan = rg.plan_for_graph(build_code("surface", 5))
    assert plan.l_pad == 40
    x = np.random.default_rng(0).standard_normal((plan.l_pad, 3)).astype(np.float32)
    for o in plan.offs_c + plan.offs_q:
        got = rg.rotate(torch.from_numpy(x)[None], o)[0].numpy()
        np.testing.assert_array_equal(got, np.asarray(jrg._rot(jnp.asarray(x), o)))
        np.testing.assert_array_equal(got, x[(np.arange(plan.l_pad) + o) % plan.l_pad])


@pytest.mark.parametrize("d,cdt,sdt", [
    (3, "float32", "float32"), (5, "float32", "float32"),
    (3, "bfloat16", "float32"), (5, "bfloat16", "float32"),
    (3, "bfloat16", "bfloat16"), (5, "bfloat16", "bfloat16"),
])
def test_plain_matches_tpugnn_roll_kernel(d, cdt, sdt):
    """Every output row, padded rows (the last raster cell's state) included."""
    jg = jax_build_code("surface", d)
    h, rounds = 32, 3
    w = _weights(h, seed=d)
    xc, xq, syn = _states(jg, h, 8, seed=100 + d)
    ref = _jax_roll(jg, xc, xq, syn, w, rounds, cdt, sdt)
    got = _port_roll(d, xc, xq, syn, w, rounds, cdt, sdt)
    assert got[0].shape == (8, jg.n_checks_pad, h) and got[1].shape == (8, jg.n_qubits_pad, h)
    if cdt == "float32":
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, atol=F32_ATOL, rtol=0)
    else:
        _assert_bf16_close(got, ref)


@pytest.mark.parametrize("d", [3, 5])
def test_slot16_bound_rejects_rounding_once(d, monkeypatch):
    """A slot stage that sums in f32 and rounds to bf16 once at the end
    breaks the bf16 bounds above: they pin the per-op rounding."""
    def round_once(ys, ydb, masks, offs, sdt):
        hs = sum(torch.relu(rg.rotate(ys, o).float() + ydb) * masks[k][:, None]
                 for k, o in enumerate(offs))
        return hs.to(sdt)

    jg = jax_build_code("surface", d)
    w = _weights(32, seed=d)
    xc, xq, syn = _states(jg, 32, 8, seed=100 + d)
    ref = _jax_roll(jg, xc, xq, syn, w, 3, "bfloat16", "bfloat16")
    monkeypatch.setattr(rg, "_slot_sum", round_once)
    got = _port_roll(d, xc, xq, syn, w, 3, "bfloat16", "bfloat16")
    shares = [(np.abs(g - r) > 0).mean() for g, r in zip(got, ref)]
    assert min(shares) > BF16_SHARE_DIFFERENT, shares


def test_roll_rounds_match_fused_rounds_on_real_rows():
    """The roll rounds compute K1's function: the port's two plain versions
    agree on the real rows in f32 (another slot order and (deg*bo)@ua
    against deg*(bo@ua))."""
    d, h = 5, 32
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    w = _weights(h, seed=1)
    xc, xq, syn = _states(jg, h, 4, seed=2)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    t = [torch.from_numpy(a) for a in (xc, xq, syn)]
    roll = rg.decoder_rounds_roll(*t, rg.plan_for_graph(tg), tw, rounds=4)
    fused = fd.rounds_plain(*t, fd.make_operators(tg), tw, rounds=4)
    for a, b, n in zip(roll, fused, (tg.n_checks, tg.n_qubits)):
        torch.testing.assert_close(a[:, :n], b[:, :n], atol=F32_ATOL, rtol=0)


def _model_pair(d, readout, dtype, rounds=3, h=32):
    """A JAX fused-layout model's params and the port's model holding them."""
    jg = jax_build_code("surface", d)
    kw = dict(hidden=h, msg_hidden=h, rounds=rounds, readout=readout, dtype=dtype)
    cfg = JaxModelConfig(backend="fused", **kw)
    jm = JaxGNNDecoder(cfg, k=jg.k)
    rng = np.random.default_rng(d)
    syn = (rng.random((16, jg.n_checks_pad)) < 0.2).astype(np.float32)
    syn *= np.asarray(jg.check_mask)
    params = jm.init(jax.random.PRNGKey(0), jg, jnp.asarray(syn))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, cfg, params, tm, syn


@pytest.mark.parametrize("schedule", [("rollgather",), ("rollgather", "slot16")])
@pytest.mark.parametrize("readout", ["per_qubit", "both"])
def test_pallas_decoder_matches_tpugnn(schedule, readout):
    """d=3, H=32, R=3, bf16 states: embed, roll rounds and heads against the
    JAX PallasDecoder on the same params and syndromes.  The logits are f32
    heads over bf16 states: mean abs <= 1e-4 as for the states, max <= 0.05
    (a few flipped bf16 roundings), measured 2e-7 and 1.7e-6 (the states
    agree, the f32 embed and heads sum in another order); the hard
    decisions are equal."""
    jg, cfg, params, tm, syn = _model_pair(3, readout, "bfloat16")
    ref = JaxPallasDecoder(cfg, k=jg.k, schedule=schedule).apply(params, jg, jnp.asarray(syn))
    with torch.no_grad():
        got = PallasDecoder(tm, schedule)(build_code("surface", 3).to("cpu"),
                                          torch.from_numpy(syn))
    pairs = [(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits))]
    if readout == "both":
        pairs.append((got.logical_logits.numpy(), np.asarray(ref.logical_logits)))
    else:
        assert got.logical_logits is None and ref.logical_logits is None
    for a, b in pairs:
        diff = np.abs(a - b)
        assert diff.mean() <= BF16_MEAN_ABS and diff.max() <= LOGITS_BF16_MAX, diff.max()
    np.testing.assert_array_equal(np.sign(pairs[0][0]), np.sign(pairs[0][1]))


@pytest.mark.parametrize("d,dtype", [(3, "float32"), (5, "float32"), (3, "bfloat16")])
def test_roll_path_matches_fused_decoder(d, dtype):
    """The port's roll path against its own fused GNNDecoder (K1's plain
    version) on the same model (tests/kernels/test_roll_gather.py:144):
    f32 logits within 1e-4 (measured 8e-7); in bf16, where the slot order
    flips roundings, JAX's bounds there (atol 0.15, rtol 0.1) and at least
    99% equal signs."""
    _, _, _, tm, syn = _model_pair(d, "both", dtype)
    tg = build_code("surface", d).to("cpu")
    with torch.no_grad():
        ref = tm(tg, torch.from_numpy(syn))
        got = PallasDecoder(tm, ("rollgather",))(tg, torch.from_numpy(syn))
    n = tg.n_qubits
    a, b = got.qubit_logits[:, :n], ref.qubit_logits[:, :n]
    if dtype == "float32":
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        torch.testing.assert_close(got.logical_logits, ref.logical_logits, atol=1e-4, rtol=0)
        for x, y in zip(decode_corrections(a), decode_corrections(b)):
            torch.testing.assert_close(x, y, atol=0, rtol=0)
    else:
        torch.testing.assert_close(a, b, atol=0.15, rtol=0.1)
        assert (torch.sign(a) == torch.sign(b)).float().mean() > 0.99


def test_rollgather_off_the_surface_code_runs_the_fused_rounds(monkeypatch):
    """A toric graph has no raster plan: the schedule takes K1's route, and
    the output equals the model's own forward exactly."""
    def refuse(*a, **k):
        raise AssertionError("the roll rounds ran on a toric graph")

    monkeypatch.setattr(pdm, "decoder_rounds_roll", refuse)
    model = GNNDecoder(ModelConfig(hidden=16, msg_hidden=16, rounds=2, backend="fused",
                                   readout="both"), k=2)
    model.init_random(torch.Generator().manual_seed(0), bias_std=0.1)
    tg = build_code("toric", 3).to("cpu")
    syn = (torch.rand((4, tg.n_checks_pad), generator=torch.Generator().manual_seed(1))
           < 0.2).float() * tg.check_mask
    with torch.no_grad():
        got = PallasDecoder(model, ("rollgather", "slot16"))(tg, syn)
        ref = model(tg, syn)
    torch.testing.assert_close(got.qubit_logits, ref.qubit_logits, atol=0, rtol=0)
    torch.testing.assert_close(got.logical_logits, ref.logical_logits, atol=0, rtol=0)


@pytest.mark.parametrize("schedule", [("sumrelu",), ("biggather",), ("rollgather", "fold"),
                                      ("slot16",)])
def test_unknown_schedule_raises(schedule):
    model = GNNDecoder(ModelConfig(hidden=16, msg_hidden=16, rounds=1, backend="fused"), k=1)
    with pytest.raises(ValueError):
        PallasDecoder(model, schedule)


def test_pallas_decoder_needs_the_fused_layout():
    with pytest.raises(ValueError, match="fused"):
        PallasDecoder(GNNDecoder(ModelConfig(hidden=16, msg_hidden=16, rounds=1), k=1))


def test_pallas_decoder_shares_the_model_parameters():
    model = GNNDecoder(ModelConfig(hidden=16, msg_hidden=16, rounds=1, backend="fused"), k=1)
    dec = PallasDecoder(model, ("rollgather",))
    assert [p.data_ptr() for p in dec.parameters()] == [p.data_ptr() for p in model.parameters()]


def test_rollgather_refuses_autograd():
    """Inference only, as the JAX roll kernel: with grad enabled the
    schedule raises, and so does decoder_rounds_roll on an operand that
    requires grad; without grad both run."""
    model = GNNDecoder(ModelConfig(hidden=16, msg_hidden=16, rounds=1, backend="fused"), k=1)
    tg = build_code("surface", 3).to("cpu")
    syn = torch.zeros((2, tg.n_checks_pad))
    dec = PallasDecoder(model, ("rollgather",))
    with pytest.raises(RuntimeError, match="inference only"):
        dec(tg, syn)
    with torch.no_grad():
        dec(tg, syn)
    w = model.rounds.round_weights()
    xc = torch.zeros((2, tg.n_checks_pad, 16), requires_grad=True)
    xq = torch.zeros((2, tg.n_qubits_pad, 16))
    plan = rg.plan_for_graph(tg)
    with pytest.raises(RuntimeError, match="inference only"):
        rg.decoder_rounds_roll(xc, xq, syn, plan, w, rounds=1)
    with torch.inference_mode():
        rg.decoder_rounds_roll(xc, xq, syn, plan, w, rounds=1)


def test_roll_decode_needs_cuda_unless_asked_for_cpu(monkeypatch):
    """ler_monte_carlo over a PallasDecoder defaults to the card and raises
    without one; with device='cpu' it runs the plain version and gives the
    fused decode's failures on the same shots.  Any other device raises."""
    model = GNNDecoder(ModelConfig(hidden=16, msg_hidden=16, rounds=2, backend="fused",
                                   readout="both"), k=1)
    model.init_random(torch.Generator().manual_seed(0), bias_std=0.1)
    dec = PallasDecoder(model, ("rollgather",))
    g = build_code("surface", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ler_monte_carlo(dec, g, p=0.1, shots=8, batch=8, generator=torch.Generator())
    got = ler_monte_carlo(dec, g, p=0.1, shots=64, batch=32,
                          generator=torch.Generator().manual_seed(5), device="cpu")
    ref = ler_monte_carlo(model, g, p=0.1, shots=64, batch=32,
                          generator=torch.Generator().manual_seed(5), device="cpu")
    assert got == ref
    meta = torch.zeros((1, g.n_checks_pad, 16), device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="cpu or cuda"):
        rg.decoder_rounds_roll(meta, meta, meta, rg.plan_for_graph(g), model.rounds.round_weights(),
                               rounds=1)


class _StubLibrary:
    """The roll library as far as a launch: records the call and stops.
    ``smem`` is the block's shared memory, or a function of (dtype code,
    l_pad) giving it; ``gpanels_smem`` the same for the f32 variant with
    its gather panels in global memory (dtype code "gp"; "tcgp" for the
    bf16 one)."""

    def __init__(self, smem=0):
        self.smem = smem
        self.gpanels_smem = 0
        self.calls = []
        self.gpanels_calls = []
        self.queries = []
        self.loaded = []

    def roll_rounds_smem_bytes(self, code, l_pad):
        self.queries.append((code, l_pad))
        return self.smem(code, l_pad) if callable(self.smem) else self.smem

    def roll_rounds_gpanels_smem_bytes(self, l_pad):
        self.queries.append(("gp", l_pad))
        s = self.gpanels_smem
        return s("gp", l_pad) if callable(s) else s

    def roll_rounds_tc_gpanels_smem_bytes(self, l_pad):
        self.queries.append(("tcgp", l_pad))
        s = self.gpanels_smem
        return s("tcgp", l_pad) if callable(s) else s

    def roll_rounds_launch(self, *args):
        self.calls.append(args)
        return 0

    def roll_rounds_tc_gpanels_launch(self, *args):
        self.gpanels_calls.append(args)
        return 0

    def roll_rounds_gpanels_launch(self, *args):
        self.gpanels_calls.append(args)
        return 0


@pytest.fixture
def stub_library(monkeypatch):
    from tpugnn_torch.kernels import _build

    lib = _StubLibrary()

    def load(name):
        if name not in ("roll_gather", "roll_gather_tf32"):
            pytest.fail(f"loaded {name}")
        lib.loaded.append(name)
        return lib

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(rg, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    # the persistent grid of the global-panel variant: one block per SM
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    rg.reset_launch_counts()
    return lib


def _ops(d, state_dtype, h=128, batch=2):
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d)
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _weights(h, 0).items()})
    xc, xq, syn = (torch.from_numpy(a) for a in _states(jg, h, batch, 1))
    plan = rg.plan_for_graph(tg)
    return plan, rg.to_raster(xc, xq, syn, plan, w, state_dtype)


@pytest.mark.parametrize("state_dtype,slot_dtype,code,slot16", [
    ("float32", "float32", 0, 0), ("float32", "bfloat16", 0, 0),
    ("bfloat16", "float32", 1, 0), ("bfloat16", "bfloat16", 1, 1)])
def test_cuda_wrapper_launches_k5(state_dtype, slot_dtype, code, slot16, stub_library):
    """The CUDA wrapper (CPU tensors standing in for the card's) reaches
    K5's C entry point with the raster's shapes, the slot-mask bits and the
    offsets, and counts one launch; it loads no other library."""
    plan, ops = _ops(5, state_dtype)
    out_c, out_q = rg._roll_rounds_cuda(ops, rounds=3, slot_dtype=slot_dtype)
    assert out_c.shape == (2, plan.l_pad, 128) and out_c.dtype == ops.xc.dtype
    (args,) = stub_library.calls
    # (dtype code, slot16, xc, xq, syn, bits, degbo, mats, vecs, out_c, out_q,
    #  offs, B, l_pad, R, width, samples a block, scratch, grid, stream)
    assert args[:2] == (code, slot16) and args[12:16] == (2, plan.l_pad, 3, 128)
    assert list(args[11]) == list(plan.offs_c + plan.offs_q)
    # each state type has its library: f32 and bf16 build apart
    assert stub_library.loaded == ["roll_gather_tf32" if code == 0 else "roll_gather"]
    assert rg.launch_counts() == {"roll_rounds": 1, "roll_rounds_gpanels": 0,
                                  "roll_rounds_tc_gpanels": 0, "roll_rounds_wide": 0}


def test_cuda_wrapper_mask_bits():
    """Bit k of a cell's entry is slot k's mask, checks then qubits."""
    plan, ops = _ops(3, "float32", h=16)
    bits = rg._mask_bits(ops.masks)
    assert bits.dtype == torch.int32 and bits.shape == (2, plan.l_pad)
    for side, mask in enumerate((plan.mask_c, plan.mask_q)):
        for k in range(4):
            np.testing.assert_array_equal(((bits[side] >> k) & 1).numpy(), mask[k, :, 0])


def test_cuda_wrapper_checks_and_raises(stub_library, monkeypatch):
    """No fallback: operands the kernels do not take (a width above the
    wide kernels' 512 columns), a raster too large for shared memory even
    with the gather panels in global memory (in f32 and in bf16) and a
    failed build all raise."""
    from tpugnn_torch.kernels import _build

    _, ops640 = _ops(3, "float32", h=640)
    with pytest.raises(ValueError, match="at most 512"):
        rg._roll_rounds_cuda(ops640, rounds=1)
    _, ops = _ops(3, "float32")
    with pytest.raises(ValueError, match="rounds"):
        rg._roll_rounds_cuda(ops, rounds=0)
    stub_library.smem = fd.SMEM_LIMIT + 1
    stub_library.gpanels_smem = fd.SMEM_LIMIT + 1
    with pytest.raises(ValueError, match="shared memory.*global memory.*limit 232448"):
        rg._roll_rounds_cuda(ops, rounds=1)
    _, ops16 = _ops(3, "bfloat16")     # bf16 takes its global panels as f32 does
    with pytest.raises(ValueError, match="shared memory.*global memory.*limit 232448"):
        rg._roll_rounds_cuda(ops16, rounds=1)
    assert ("tcgp", ops16.xc.shape[1]) in stub_library.queries

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load_library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        rg._roll_rounds_cuda(ops, rounds=1)
    assert rg.launch_counts() == {"roll_rounds": 0, "roll_rounds_gpanels": 0,
                                  "roll_rounds_tc_gpanels": 0, "roll_rounds_wide": 0}
    assert not stub_library.calls and not stub_library.gpanels_calls


# What roll_rounds_smem_bytes returns on the card, (dtype code, l_pad) ->
# bytes (chip_smoke.py phase 11 prints it): f32 (3xTF32) one swizzled f32
# gather panel, a 144-row f32 chunk buffer of 9 warps and two 16-row slabs
# of split weights, its global-panel variant the same without the panel;
# bf16 swizzled panels, tensor-core chunk buffers and a double buffer of
# 64-row weight slabs (32-row at d=15, where 64 do not fit), for 144-row
# chunks of 9 warps.  Each with the slot bits.
_SMEM_ON_THE_CARD = {(0, 144): 182816, (1, 144): 187168, (0, 200): 211600,
                     (1, 200): 215952, (0, 256): 240384, (1, 256): 227328,
                     ("gp", 144): 109088, ("gp", 200): 109200, ("gp", 256): 109312}


@pytest.mark.parametrize("d,state_dtype,slot_dtype,fits", [
    (11, "float32", "float32", True), (11, "bfloat16", "float32", True),
    (11, "bfloat16", "bfloat16", True), (13, "float32", "float32", True),
    (13, "bfloat16", "float32", True), (13, "bfloat16", "bfloat16", True),
    (15, "float32", "float32", False), (15, "bfloat16", "float32", True)])
def test_cuda_wrapper_sizes_the_block_by_state_dtype(d, state_dtype, slot_dtype, fits,
                                                     stub_library):
    """The wrapper asks the library for the block's shared memory with the
    states' dtype code and the raster's length and launches the shared-panel
    kernel where that fits (bf16 up to d=15 on the tensor-core kernel, f32
    up to d=13); where it does not (f32 at d=15) it asks for the
    global-panel variant's and launches that, on a persistent grid of one
    block per SM with an f32 scratch [grid, 2 l_pad, 128] (the check
    states' second buffer and the panel)."""
    stub_library.smem = lambda code, l_pad: _SMEM_ON_THE_CARD[(code, l_pad)]
    stub_library.gpanels_smem = lambda code, l_pad: _SMEM_ON_THE_CARD[(code, l_pad)]
    plan, ops = _ops(d, state_dtype)
    code = 0 if state_dtype == "float32" else 1
    rg._roll_rounds_cuda(ops, rounds=2, slot_dtype=slot_dtype)
    if fits:
        (args,) = stub_library.calls
        assert args[:2] == (code, int(slot_dtype == "bfloat16"))
        # (..., B, l_pad, R, width, samples a block, scratch, grid, stream)
        assert args[12:17] == (2, plan.l_pad, 2, 128, 1)
        assert args[18] == (2 if state_dtype == "float32" else 0)
        assert rg.launch_counts() == {"roll_rounds": 1, "roll_rounds_gpanels": 0,
                                      "roll_rounds_tc_gpanels": 0, "roll_rounds_wide": 0}
        assert stub_library.queries == [(code, plan.l_pad)]
    else:
        (args,) = stub_library.gpanels_calls
        # (xc, xq, syn, bits, degbo, mats, vecs, out_c, out_q, panels, offs,
        #  B, l_pad, R, width, grid, stream)
        assert args[11:16] == (2, plan.l_pad, 2, 128, 2)
        assert not stub_library.calls
        assert rg.launch_counts() == {"roll_rounds": 0, "roll_rounds_gpanels": 1,
                                      "roll_rounds_tc_gpanels": 0, "roll_rounds_wide": 0}
        assert stub_library.queries == [(code, plan.l_pad), ("gp", plan.l_pad)]


def test_cpu_dispatch_is_the_plain_version():
    plan, ops = _ops(3, "bfloat16", h=16)
    before = rg.launch_counts()
    a = rg.roll_rounds_plain(ops, rounds=2, slot_dtype="bfloat16")
    jg = jax_build_code("surface", 3)
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in _weights(16, 0).items()})
    xc, xq, syn = (torch.from_numpy(x) for x in _states(jg, 16, 2, 1))
    b = rg.decoder_rounds_roll(xc, xq, syn, plan, w, rounds=2, state_dtype="bfloat16",
                               slot_dtype="bfloat16")
    for x, y in zip(rg.from_raster(*a, plan), b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    assert rg.launch_counts() == before
    with pytest.raises(ValueError, match="slot_dtype"):
        rg.roll_rounds_plain(ops, rounds=1, slot_dtype="float16")
