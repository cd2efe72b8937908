"""The plain versions of K3a, K3b and K4 against the JAX package's Pallas
kernels (interpret mode, as tests/kernels/ runs them), and the wrappers'
routing: CPU tensors take the plain versions; a CUDA call reaches the C
entry point of its kernel (the library loader is stubbed) or raises.

Tolerances:
* K3a/K3b (``ell_aggregate``): f32 atol 1e-5 (sums of at most 6 O(1)
  messages in another order; the max is exact), for f32 and bf16 messages
  (both read as f32);
* K4 (``sddmm_edge_hidden``) in f32: atol 1e-5 (the two projections
  summed in another order);
* K4 in bf16: the same rounding order as JAX's kernel, so at most 1% of
  the elements may differ, and by at most 0.0625: a projection whose f32
  sum, taken in another order, lands on the other side of a bf16 rounding
  boundary moves one bf16 step (2^-5 at |y| in [4, 8); both projections
  and the final rounding make 0.0625), also where the sum cancels.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.kernels.fused_decoder import make_operators as jax_make_operators
from tpugnn.kernels.sddmm import sddmm_edge_hidden as jax_sddmm
from tpugnn.kernels.spmm import ell_aggregate as jax_ell_aggregate
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.kernels import sddmm, spmm
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.tanner import build_code

from tests.test_torch_port_mp import graphs

torch.set_num_threads(1)

ATOL = 1e-5
GRAPHS = ["surface3", "surface5", "toric3", "lopsided"]


def _msg(g, b=4, f=32, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, g.n_edges_pad, f)).astype(np.float32)
    if dtype == "bfloat16":
        m = np.array(jnp.asarray(m, jnp.bfloat16).astype(jnp.float32))
    return m


def _tables(tg, to):
    if to == "check":
        return tg.ell_check_edge, tg.ell_check_mask
    return tg.ell_qubit_edge, tg.ell_qubit_mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("agg", ["sum", "max"])
@pytest.mark.parametrize("graph", GRAPHS)
def test_ell_plain_matches_pallas_interpret(graph, agg, dtype):
    """K3a's and K3b's plain versions against tpugnn.kernels.spmm.ell_aggregate,
    both directions, with f32 or bf16 messages (the JAX wrapper casts to f32)."""
    jg, tg = graphs(graph)
    msg = _msg(jg, seed=1, dtype=dtype)
    jm = jnp.asarray(msg, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tm = torch.from_numpy(msg).to(getattr(torch, dtype))
    plain = spmm.ell_aggregate_plain if agg == "sum" else spmm.ell_max_plain
    for to in ("check", "qubit"):
        edge, mask = _tables(tg, to)
        ref = jax_ell_aggregate(jm, jnp.asarray(edge.numpy()), jnp.asarray(mask.numpy()),
                                agg=agg, interpret=True)
        got = plain(tm, edge, mask)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_ell_aggregate_on_cpu_is_the_plain_version():
    _, tg = graphs("lopsided")
    msg = torch.from_numpy(_msg(tg, seed=2)).reshape(2, 2, tg.n_edges_pad, 32)
    spmm.reset_launch_counts()
    for agg in ("sum", "mean", "max"):
        got = spmm.ell_aggregate(msg, tg.ell_check_edge, tg.ell_check_mask, agg=agg)
        want = spmm.PLAIN[agg](msg.reshape(4, tg.n_edges_pad, 32), tg.ell_check_edge,
                               tg.ell_check_mask).reshape(2, 2, tg.n_checks_pad, 32)
        assert torch.equal(got, want)
    assert spmm.launch_counts() == {"ell_sum": 0, "ell_max": 0}
    with pytest.raises(ValueError, match="aggregation"):
        spmm.ell_aggregate(msg, tg.ell_check_edge, tg.ell_check_mask, agg="min")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm.ell_aggregate(msg.to("meta"), tg.ell_check_edge, tg.ell_check_mask)


@pytest.mark.parametrize("kernel", ["spmm", "sddmm"])
def test_kernels_refuse_autograd(kernel):
    """Neither kernel has a backward (nor has the JAX package's), so an
    operand that requires grad is refused, on any device."""
    _, tg = graphs("surface3")
    if kernel == "spmm":
        msg = torch.randn(2, tg.n_edges_pad, 8, requires_grad=True)
        call = lambda: spmm.ell_aggregate(msg, tg.ell_check_edge, tg.ell_check_mask)
    else:
        x = torch.randn(2, tg.n_checks_pad, 8)
        w = torch.randn(8, 8, requires_grad=True)
        src = tg.edge_qubit.long()[tg.ell_check_edge.long()]
        call = lambda: sddmm.sddmm_edge_hidden(x, x, src, tg.ell_check_mask, w, w,
                                               torch.zeros(8))
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()


class _StubLibrary:
    """Stands in for a built kernel library: records each launch's
    arguments and returns 0 (launched); ``sddmm_smem_bytes`` says 0."""

    def __init__(self, name, calls):
        self.name = name
        self.calls = calls

    def sddmm_smem_bytes(self, *args):
        return 0

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((entry, args))
            return 0
        return launch


@pytest.fixture
def stub_kernels(monkeypatch):
    """The library loader stubbed and the stream context a no-op, so a call
    on CPU tensors runs the CUDA wrappers down to the C entry point."""
    from tpugnn_torch.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "load_library", lambda name: _StubLibrary(name, calls))
    for mod in (spmm, sddmm):
        monkeypatch.setattr(mod, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    spmm.reset_launch_counts()
    sddmm.reset_launch_counts()
    return calls


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_generic_pallas_model_launches_two_per_round(agg, stub_kernels, monkeypatch):
    """GNNDecoder(backend='pallas') aggregates every round in both
    directions through ell_aggregate; on a card each call is one launch of
    K3a (sum, mean) or K3b (max).  The aggregation is routed to the CUDA
    wrapper here (its plain version replaced), so the launches are those a
    card's forward makes."""
    for name in ("sum", "mean", "max"):
        monkeypatch.setitem(spmm.PLAIN, name,
                            lambda m, e, k, a=name: spmm._ell_cuda(m, e, k, a))
    rounds = 3
    tg = build_code("surface", 3).to("cpu")
    model = GNNDecoder(ModelConfig(hidden=16, msg_hidden=16, rounds=rounds,
                                   backend="pallas", aggr=agg), k=1)
    with torch.no_grad():
        model(tg, torch.zeros(2, tg.n_checks_pad))
    kind = "ell_max" if agg == "max" else "ell_sum"
    assert spmm.launch_counts() == {"ell_sum": 0, "ell_max": 0, kind: 2 * rounds}
    assert [c[0] for c in stub_kernels] == ["ell_aggregate_launch"] * (2 * rounds)
    # (dtype code, is_max, msg, table, out, B', E_pad, F, rows, D, stream)
    args = stub_kernels[0][1]
    assert args[:2] == (0, int(agg == "max"))
    assert args[5:7] == (2, tg.n_edges_pad) and args[7] == 16
    assert {c[1][8:10] for c in stub_kernels} == {
        (tg.n_checks_pad, tg.deg_max_check), (tg.n_qubits_pad, tg.deg_max_qubit)}


def test_ell_cuda_wrapper_checks_its_operands(stub_kernels):
    _, tg = graphs("surface3")
    msg = torch.randn(2, tg.n_edges_pad, 8)
    with pytest.raises(ValueError, match="f32 or bf16"):
        spmm._ell_cuda(msg.double(), tg.ell_check_edge, tg.ell_check_mask, "sum")
    with pytest.raises(ValueError, match="slot tables"):
        spmm._ell_cuda(msg, tg.ell_check_edge, tg.ell_check_mask[:, :2], "sum")
    out = spmm._ell_cuda(msg.bfloat16(), tg.ell_check_edge, tg.ell_check_mask, "max")
    assert out.dtype == torch.float32 and out.shape == (2, tg.n_checks_pad, 8)
    assert stub_kernels[-1][1][:2] == (1, 1)
    assert spmm.launch_counts() == {"ell_sum": 0, "ell_max": 1}


def _sddmm_inputs(jg, tg, h=32, mh=48, b=8, seed=0):
    rng = np.random.default_rng(seed)
    xd = rng.standard_normal((b, jg.n_checks_pad, h)).astype(np.float32)
    xs = rng.standard_normal((b, jg.n_qubits_pad, h)).astype(np.float32)
    wd = (rng.standard_normal((h, mh)) / np.sqrt(h)).astype(np.float32)
    ws = (rng.standard_normal((h, mh)) / np.sqrt(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(mh)).astype(np.float32)
    g_c, mask_c = jax_make_operators(jg)[0], jg.ell_check_mask
    # the port takes the slot source-row table; its rows of JAX's one-hot
    slot_src = np.asarray(g_c).argmax(-1).reshape(jg.n_checks_pad, -1)
    # (real slots) is make_operators' table; a masked slot is read as 0
    src_c = tg.edge_qubit.long()[tg.ell_check_edge.long()].numpy()
    real = np.asarray(mask_c) > 0
    np.testing.assert_array_equal(slot_src[real], src_c[real])
    return (xd, xs, wd, ws, bias), (g_c, mask_c), slot_src


@pytest.mark.parametrize("mh", [48, 32])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("graph", ["surface3", "toric3", "surface5"])
def test_sddmm_plain_matches_pallas_interpret(graph, compute_dtype, mh):
    jg, tg = graphs(graph)
    (xd, xs, wd, ws, bias), (g_c, mask_c), slot_src = _sddmm_inputs(jg, tg, mh=mh)
    ref = np.asarray(jax_sddmm(jnp.asarray(xd), jnp.asarray(xs), g_c, mask_c,
                               jnp.asarray(wd), jnp.asarray(ws), jnp.asarray(bias),
                               compute_dtype=compute_dtype, interpret=True))
    got = sddmm.sddmm_edge_hidden(
        *(torch.from_numpy(a) for a in (xd, xs)), torch.from_numpy(slot_src),
        torch.from_numpy(np.array(mask_c)),
        *(torch.from_numpy(a) for a in (wd, ws, bias)),
        compute_dtype=compute_dtype).numpy()
    assert got.shape == ref.shape == (8, jg.n_checks_pad * jg.deg_max_check, mh)
    assert got.dtype == np.float32
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
        return
    diff = np.abs(got - ref)
    assert (diff > 0).mean() <= 0.01
    assert diff.max() <= 0.0625


@pytest.mark.parametrize("order", ["round_once_at_the_end", "unrounded_projections"])
def test_sddmm_bf16_gate_rejects_other_rounding_orders(order):
    """The bf16 gate above pins the rounding order: a plain version that
    rounds the sum once at the end, or keeps the projections in f32,
    differs from JAX's kernel on more than 1% of the outputs."""
    jg, tg = graphs("surface5")
    (xd, xs, wd, ws, bias), (g_c, mask_c), slot_src = _sddmm_inputs(jg, tg)
    ref = np.asarray(jax_sddmm(jnp.asarray(xd), jnp.asarray(xs), g_c, mask_c,
                               jnp.asarray(wd), jnp.asarray(ws), jnp.asarray(bias),
                               compute_dtype="bfloat16", interpret=True))
    rnd = lambda t: t.to(torch.bfloat16).float()
    proj = (lambda t: t) if order == "unrounded_projections" else rnd
    t = lambda a: torch.from_numpy(np.array(a))
    yd = proj(rnd(t(xd)) @ rnd(t(wd)))
    ys = proj(rnd(t(xs)) @ rnd(t(ws)))
    z = ys.index_select(1, t(slot_src).reshape(-1).long()) + yd.repeat_interleave(
        slot_src.shape[1], dim=1)
    if order == "round_once_at_the_end":
        pre = rnd(z + rnd(t(bias)))
    else:
        pre = rnd(rnd(z) + rnd(t(bias)))
    got = (torch.relu(pre) * t(mask_c).reshape(1, -1, 1)).numpy()
    assert (np.abs(got - ref) > 0).mean() > 0.01


def test_sddmm_cuda_wrapper_launches(stub_kernels):
    jg, tg = graphs("toric3")
    (xd, xs, wd, ws, bias), (_, mask_c), slot_src = _sddmm_inputs(jg, tg, mh=48, b=2)
    t = lambda a: torch.from_numpy(np.array(a))
    out = sddmm._sddmm_cuda(t(xd), t(xs), t(slot_src), t(mask_c), t(wd), t(ws), t(bias),
                            torch.bfloat16)
    assert out.shape == (2, jg.n_checks_pad * jg.deg_max_check, 48)
    entry, args = stub_kernels[-1]
    assert entry == "sddmm_edge_hidden_launch"
    # (compute code, xd, xs, table, wd, ws, bias, out, B, rows_dst, rows_src, D, H, MH, stream)
    assert args[0] == 1 and args[8:14] == (2, jg.n_checks_pad, jg.n_qubits_pad,
                                           jg.deg_max_check, 32, 48)
    assert sddmm.launch_counts() == {"sddmm_edge_hidden": 1, "sddmm_edge_hidden_tc": 0}
    with pytest.raises(ValueError, match="weights"):
        sddmm._sddmm_cuda(t(xd), t(xs), t(slot_src), t(mask_c), t(wd), t(ws[:8]), t(bias),
                          torch.float32)


def _tc_smem(rows_dst, rows_src, d):
    """The tensor-core kernel's shared memory, as csrc/sddmm.cu sizes it:
    both weight matrices, then the source and destination panels (rows
    rounded up to 16), all at a row stride of 136 bf16, and the slot table."""
    r16 = lambda r: (r + 15) // 16 * 16
    return (2 * 128 * 136 * 2 + (r16(rows_src) + r16(rows_dst)) * 272
            + (rows_dst * d * 4 + 15) // 16 * 16)


def _fma_smem(rows_dst, rows_src, d, mh):
    """The FMA kernel's: the f32 panel, two 16 x 64 f32 slabs, the slot table."""
    a16 = lambda x: (x + 15) // 16 * 16
    return a16(rows_src * mh * 4) + 2 * 16 * 64 * 4 + a16(rows_dst * d * 4)


class _SizingStub(_StubLibrary):
    """A stub that sizes shared memory as the card's library does and keeps
    a copy of the weights each launch reads (the wrapper's tensors are gone
    after the call)."""

    def sddmm_smem_bytes(self, rows_dst, rows_src, d, mh):
        return _fma_smem(rows_dst, rows_src, d, mh)

    def sddmm_tc_smem_bytes(self, rows_dst, rows_src, d):
        return _tc_smem(rows_dst, rows_src, d)

    def __getattr__(self, entry):
        def launch(*args):
            tc = entry == "sddmm_edge_hidden_tc_launch"
            h, mh = args[11:13] if tc else args[12:14]
            size = h * mh * (2 if tc else 4)
            wd_ptr, ws_ptr = args[3:5] if tc else args[4:6]
            weights = tuple(ctypes.string_at(p, size) for p in (wd_ptr, ws_ptr))
            self.calls.append((entry, args, weights))
            return 0
        return launch


@pytest.fixture
def sizing_stub(monkeypatch, stub_kernels):
    from tpugnn_torch.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "load_library", lambda name: _SizingStub(name, calls))
    return calls


def _wide_inputs(b, rows_dst, rows_src, d, h, mh, seed=0):
    g = torch.Generator().manual_seed(seed)
    xd, xs = torch.randn(b, rows_dst, h, generator=g), torch.randn(b, rows_src, h, generator=g)
    src = torch.randint(0, rows_src, (rows_dst, d), generator=g)
    mask = (torch.rand(rows_dst, d, generator=g) > 0.2).float()
    wd, ws = torch.randn(h, mh, generator=g) / h ** 0.5, torch.randn(h, mh, generator=g) / h ** 0.5
    return xd, xs, src, mask, wd, ws, 0.1 * torch.randn(mh, generator=g)


@pytest.mark.parametrize("dtype,h,mh,route", [
    (torch.bfloat16, 128, 128, "sddmm_edge_hidden_tc"),
    (torch.float32, 128, 128, "sddmm_edge_hidden"),
    (torch.bfloat16, 32, 48, "sddmm_edge_hidden"),
    (torch.bfloat16, 64, 64, "sddmm_edge_hidden"),
    (torch.bfloat16, 128, 64, "sddmm_edge_hidden"),
])
def test_sddmm_cuda_wrapper_picks_the_kernel_by_shape(dtype, h, mh, route, sizing_stub):
    """bf16 at H = MH = 128 launches the tensor-core entry with bf16 weights;
    f32, or any other width, the FMA entry with f32 weights; the launch is
    counted under its kernel's name."""
    xd, xs, src, mask, wd, ws, bias = _wide_inputs(2, 128, 128, 4, h, mh)
    out = sddmm._sddmm_cuda(xd, xs, src, mask, wd, ws, bias, dtype)
    assert out.shape == (2, 128 * 4, mh) and out.dtype == torch.float32
    (entry, args, (wd_bytes, ws_bytes)), = sizing_stub
    other = {"sddmm_edge_hidden": "sddmm_edge_hidden_tc",
             "sddmm_edge_hidden_tc": "sddmm_edge_hidden"}[route]
    assert sddmm.launch_counts() == {route: 1, other: 0}
    wdt = torch.bfloat16 if route.endswith("_tc") else torch.float32
    for got, w in ((wd_bytes, wd), (ws_bytes, ws)):
        assert torch.equal(torch.frombuffer(bytearray(got), dtype=wdt), w.to(wdt).flatten())
    if route.endswith("_tc"):
        # (xd, xs, table, wd, ws, bias, out, B, rows_dst, rows_src, D, H, MH, stream)
        assert entry == "sddmm_edge_hidden_tc_launch" and args[7:13] == (2, 128, 128, 4, h, mh)
    else:
        assert entry == "sddmm_edge_hidden_launch"
        assert args[0] == int(dtype == torch.bfloat16) and args[8:14] == (2, 128, 128, 4, h, mh)


@pytest.mark.parametrize("dtype,rows_src", [(torch.bfloat16, 592), (torch.float32, 448)])
def test_sddmm_cuda_wrapper_refuses_a_panel_that_does_not_fit(dtype, rows_src, sizing_stub):
    """A source panel larger than a block's shared memory is refused before
    any launch, on either kernel; the largest that fits launches."""
    fits = rows_src - 16
    for rows, ok in ((fits, True), (rows_src, False)):
        args = _wide_inputs(1, 16, rows, 4, 128, 128)
        if ok:
            sddmm._sddmm_cuda(*args, dtype)
            continue
        with pytest.raises(ValueError, match="shared memory"):
            sddmm._sddmm_cuda(*args, dtype)
    assert len(sizing_stub) == 1
    route = "sddmm_edge_hidden_tc" if dtype == torch.bfloat16 else "sddmm_edge_hidden"
    assert sddmm.launch_counts()[route] == 1 and sum(sddmm.launch_counts().values()) == 1


def test_sddmm_launch_counts_per_kernel(sizing_stub):
    """Counts name the kernel that ran: two bench-width bf16 calls and one
    f32 call count 2 and 1."""
    args = _wide_inputs(1, 16, 16, 4, 128, 128)
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        sddmm._sddmm_cuda(*args, dtype)
    assert sddmm.launch_counts() == {"sddmm_edge_hidden": 1, "sddmm_edge_hidden_tc": 2}
    assert [c[0] for c in sizing_stub] == ["sddmm_edge_hidden_tc_launch",
                                           "sddmm_edge_hidden_launch",
                                           "sddmm_edge_hidden_tc_launch"]
    sddmm.reset_launch_counts()
    assert sddmm.launch_counts() == {"sddmm_edge_hidden": 0, "sddmm_edge_hidden_tc": 0}


def test_sddmm_cuda_wrapper_aligns_its_operands(sizing_stub):
    """The tensor-core kernel reads x, the weights and the bias 16 bytes at
    a time: an operand whose storage starts off a 16-byte boundary reaches
    the kernel as an aligned copy."""
    xd, xs, src, mask, wd, ws, bias = _wide_inputs(1, 16, 16, 4, 128, 128)
    shifted = torch.cat([torch.zeros(1), bias])[1:]
    assert shifted.data_ptr() % 16 != 0 and torch.equal(shifted, bias)
    sddmm._sddmm_cuda(xd, xs, src, mask, wd, ws, shifted, torch.bfloat16)
    (entry, args, _), = sizing_stub
    assert entry == "sddmm_edge_hidden_tc_launch"
    assert all(p % 16 == 0 for p in args[:7])
