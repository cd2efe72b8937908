"""The f32 raster rounds (K5) and the f32 forward-with-stash (K2a) on tensor
cores (3xTF32).

With f32 states K5 (``csrc/roll_gather_tf32.cu``) and K2a (K1's kernel in
``csrc/wide_rounds.cuh``, the library ``wide_rounds_tf32``, with its stash)
form every product as three TF32 products of operands split into TF32
halves, as f32 K1 does (``tests/test_torch_tf32x3.py``).  These tests hold:

* ``roll_rounds_plain`` with every f32 product split three ways (the
  emulation of ``tests/tf32x3_emulation.py``) against the JAX package's
  ``rounds_xla`` in f32 on the same numpy-seeded inputs, on the real rows,
  within 1e-3 (the kernels' tolerance against the plain version on the
  card); the same rounds with one TF32 product land past it;
* the K5 wrapper: the split pack it passes, exactly and in fragment order;
  the samples it stacks in a block; its placement of the gather panel (in
  shared memory where the block fits, else global) at the shared memory
  the card's kernels need;
* the K2a wrapper: the split pack (TF32 halves in the wgmma slab order)
  for f32 stash launches, one sample's rows after another with the stash's
  layout [R, B, rows, 128], and bf16 matrices packed as they are.

The wrappers run on CPU tensors standing in for the card's, against a stub
library that records each launch.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tf32x3_emulation import Tf32x3Products, round_weights, split_matrices, wgmma_matrices
from tpugnn.kernels import fused_decoder as jfd
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.kernels import fused_backward as fb
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.kernels import roll_gather as rg
from tpugnn_torch.tanner import build_code

TOL_F32 = 1e-3   # the f32 kernels' max abs error against the plain version
SMS = 132        # the stub card's SMs: the persistent grid's bound


def _states(jg, h, batch, seed):
    """Seeded states with zero padded rows and a +-1 syndrome on real checks."""
    rng = np.random.default_rng(seed)
    cm, qm = np.asarray(jg.check_mask), np.asarray(jg.qubit_mask)
    xc = rng.standard_normal((batch, jg.n_checks_pad, h)).astype(np.float32) * cm[None, :, None]
    xq = rng.standard_normal((batch, jg.n_qubits_pad, h)).astype(np.float32) * qm[None, :, None]
    syn = np.sign(rng.standard_normal((batch, jg.n_checks_pad, 1))).astype(np.float32)
    return xc, xq, syn * cm[None, :, None]


@pytest.mark.parametrize("d,h,rounds,batch", [(5, 128, 14, 8), (3, 64, 14, 8)])
def test_split_products_on_the_raster_match_rounds_xla(d, h, rounds, batch):
    """K5's plain version with every f32 product split three ways, on the
    raster operands the kernel reads (padded to 128 columns, the LayerNorm
    over the model's h), against JAX rounds_xla at width h on the real
    rows: within TOL_F32, the padded columns exactly 0; one TF32 pass on
    the same inputs lands past TOL_F32."""
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d)
    w = round_weights(h, seed=90 + d)
    xc, xq, syn = _states(jg, h, batch, 100 + d)
    ref = jfd.rounds_xla(jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn),
                         jfd.make_operators(jg),
                         jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
                         rounds=rounds)
    plan = rg.plan_for_graph(tg)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    ops = rg.pad_raster(rg.to_raster(torch.from_numpy(xc), torch.from_numpy(xq),
                                     torch.from_numpy(syn), plan, tw, "float32"))
    real = (tg.n_checks, tg.n_qubits)

    def rounds_as(passes):
        mode = Tf32x3Products(passes)
        with torch.no_grad(), mode:
            out = rg.roll_rounds_plain(ops, rounds=rounds, width=h if h < fd.WIDTH else None)
        assert mode.count == 10 * rounds      # five products a side and round
        got = rg.from_raster(*out, plan)
        err = max(float(np.abs(g[:, :n, :h].numpy() - np.asarray(r)[:, :n]).max())
                  for g, r, n in zip(got, ref, real))
        return got, err

    got, err = rounds_as(3)
    for g_ in got:
        assert g_.shape[-1] == fd.WIDTH and not g_[..., h:].any()
    assert err <= TOL_F32, err
    _, err_one = rounds_as(1)
    print(f"d={d} h={h}: max err from rounds_xla on the real rows, 3xTF32 {err}, "
          f"one TF32 pass {err_one}")
    assert err_one > TOL_F32, err_one


def _k5_smem(l_pad, gpanels=False):
    """roll_rounds_smem_bytes(0, l_pad) / roll_rounds_gpanels_smem_bytes as
    csrc/roll_gather.cu computes them: one swizzled f32 gather panel (none
    with global panels), a 144-row f32 chunk buffer (row stride 132), two
    16-row slabs of split weights (1 KB a row) and the slot bits."""
    align = lambda x: (x + 15) & ~15
    return (0 if gpanels else align(l_pad * 512)) + 144 * 132 * 4 + 2 * 16 * 1024 + align(2 * l_pad)


class _RollLibrary:
    """The roll library as far as a launch, sizing shared memory as the
    card does: records each entry point reached with its arguments."""

    def __init__(self):
        self.calls = []
        self.loaded = []

    def roll_rounds_smem_bytes(self, code, l_pad):
        return _k5_smem(l_pad) if code == 0 else 0     # bf16 fits

    def roll_rounds_gpanels_smem_bytes(self, l_pad):
        return _k5_smem(l_pad, gpanels=True)

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((entry, args))
            return 0
        return launch


@contextlib.contextmanager
def _recorded_packs(monkeypatch, module):
    """Every pack ``module.tf32_split_pack`` makes, in a list."""
    packs = []
    real = fd.tf32_split_pack

    def record(mats):
        packs.append(real(mats))
        return packs[-1]

    monkeypatch.setattr(module, "tf32_split_pack", record)
    yield packs


@pytest.fixture
def roll_library(monkeypatch):
    from tpugnn_torch.kernels import _build

    lib = _RollLibrary()

    def load(name):    # f32 and bf16 states build apart
        if name not in ("roll_gather_tf32", "roll_gather"):
            pytest.fail(f"loaded {name}")
        lib.loaded.append(name)
        return lib

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(rg, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
    rg.reset_launch_counts()
    return lib


def _raster(d, h, batch, dtype="float32"):
    tg = build_code("surface", d)
    jg = jax_build_code("surface", d)
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in round_weights(h, 3).items()})
    xc, xq, syn = (torch.from_numpy(a) for a in _states(jg, h, batch, 4))
    plan = rg.plan_for_graph(tg)
    return plan, rg.to_raster(xc, xq, syn, plan, w, dtype)


def test_k5_shared_memory_as_the_card_computes_it():
    """The f32 kernel's block: 182,816 B at d=11, 211,600 at d=13 (both
    within SMEM_LIMIT, the panel in shared memory), 240,384 at d=15 (over
    it: 109,312 with the panel in global memory)."""
    sizes = [_k5_smem(rg.plan_for_graph(build_code("surface", d)).l_pad) for d in (11, 13, 15)]
    assert sizes == [182816, 211600, 240384]
    assert sizes[1] <= fd.SMEM_LIMIT < sizes[2]
    assert _k5_smem(256, gpanels=True) == 109312


@pytest.mark.parametrize("h", [128, 64])
def test_k5_wrapper_passes_the_split_pack(h, roll_library, monkeypatch):
    """f32 K5 reads its weights as the split pack, made once a call from
    the raster's matrices padded to 128: hi and lo TF32 halves of every
    entry, in the B-fragment order the kernel's lanes read."""
    _, ops = _raster(5, h, 2)
    with _recorded_packs(monkeypatch, rg) as packs:
        rg._roll_rounds_cuda(ops, rounds=2)
    ((entry, args),) = roll_library.calls
    (pack,) = packs
    assert entry == "roll_rounds_launch" and args[:2] == (0, 0)
    # (dtype code, slot16, xc, xq, syn, bits, degbo, mats, ...)
    assert args[7] == pack.data_ptr()
    mats = fd.pad_packs(ops.mats, ops.vecs)[0]
    assert torch.equal(pack, fd.tf32_split_pack(mats))
    hi, lo = split_matrices(pack)
    assert torch.equal(hi, fd.tf32_round(mats))
    assert torch.equal(lo, fd.tf32_round(mats - hi))
    assert not hi[:, h:].any() and not hi[:, :, h:].any()


def test_bf16_k5_takes_its_matrices_unsplit(roll_library, monkeypatch):
    """bf16 K5 keeps its bf16 matrices, one sample a block and no scratch."""
    _, ops = _raster(5, 128, 4, "bfloat16")
    with _recorded_packs(monkeypatch, rg) as packs:
        rg._roll_rounds_cuda(ops, rounds=2)
    ((entry, args),) = roll_library.calls
    assert roll_library.loaded == ["roll_gather"]
    assert not packs and entry == "roll_rounds_launch" and args[:2] == (1, 0)
    # (..., B, l_pad, R, width, samples a block, scratch, grid, stream)
    assert args[12:19] == (4, ops.xc.shape[1], 2, 128, 1, None, 0)


@pytest.mark.parametrize("d,batch,samples", [(3, 8, 8), (3, 12, 4), (3, 7, 1), (5, 8, 2),
                                             (5, 1, 1), (7, 8, 2), (9, 8, 1), (11, 8, 1),
                                             (13, 8, 1)])
def test_k5_wrapper_stacks_small_rasters(d, batch, samples, roll_library):
    """f32 K5 with its panel in shared memory takes `samples` samples a
    block (a power of two dividing the batch, their raster within one
    144-row chunk) on a persistent grid of at most one block per SM; the
    launch names the samples, not the blocks."""
    plan, ops = _raster(d, 128, batch)
    rg._roll_rounds_cuda(ops, rounds=3)
    ((entry, args),) = roll_library.calls
    assert entry == "roll_rounds_launch" and roll_library.loaded == ["roll_gather_tf32"]
    assert args[12:17] == (batch, plan.l_pad, 3, 128, samples)
    assert args[18] == min(batch // samples, SMS)
    assert rg.launch_counts() == {"roll_rounds": 1, "roll_rounds_gpanels": 0,
                                  "roll_rounds_tc_gpanels": 0, "roll_rounds_wide": 0}


@pytest.mark.parametrize("d,gpanels", [(3, False), (9, False), (11, False), (13, False),
                                       (15, True)])
def test_k5_wrapper_places_the_panel(d, gpanels, roll_library):
    """The gather panel goes in shared memory where the block fits (d <= 13)
    and in global memory where it does not (d=15): that variant launches on
    a persistent grid of min(B, SMs) blocks, one sample each, with a
    scratch of two raster's rows a block."""
    plan, ops = _raster(d, 128, 200)
    rg._roll_rounds_cuda(ops, rounds=2)
    ((entry, args),) = roll_library.calls
    if gpanels:
        # (xc, xq, syn, bits, degbo, mats, vecs, out_c, out_q, scratch, offs,
        #  B, l_pad, R, width, grid, stream)
        assert entry == "roll_rounds_gpanels_launch"
        assert args[11:16] == (200, plan.l_pad, 2, 128, min(200, SMS))
        assert rg.launch_counts() == {"roll_rounds": 0, "roll_rounds_gpanels": 1,
                                      "roll_rounds_tc_gpanels": 0, "roll_rounds_wide": 0}
    else:
        assert entry == "roll_rounds_launch" and args[:2] == (0, 0)
        assert rg.launch_counts() == {"roll_rounds": 1, "roll_rounds_gpanels": 0,
                                      "roll_rounds_tc_gpanels": 0, "roll_rounds_wide": 0}


class _K1Library:
    """The forward rounds library as far as a launch (K1 and K2a share one
    kernel): records each entry point reached with its arguments."""

    def __init__(self):
        self.calls = []
        self.loaded = []

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((entry, args))
            return 0
        return launch


@pytest.fixture
def k1_library(monkeypatch):
    from tpugnn_torch.kernels import _build

    lib = _K1Library()

    def load(name):    # f32 and bf16 states build apart
        if name not in ("wide_rounds", "wide_rounds_tf32"):
            pytest.fail(f"loaded {name}")
        lib.loaded.append(name)
        return lib

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(fd, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    fd.reset_launch_counts()
    return lib


@contextlib.contextmanager
def _recorded_wgmma_packs(monkeypatch):
    """Every pack ``fd.wgmma_pack`` makes, in a list, with its state type."""
    packs = []
    real = fd.wgmma_pack

    def record(mats, dt):
        packs.append((real(mats, dt), dt))
        return packs[-1][0]

    monkeypatch.setattr(fd, "wgmma_pack", record)
    yield packs


@pytest.mark.parametrize("d,batch,samples", [(11, 4, 1), (3, 8, 8), (5, 8, 4)])
def test_k2a_wrapper_passes_the_split_pack(d, batch, samples, k1_library, monkeypatch):
    """f32 K2a launches K1's 3xTF32 kernel with its stash: the split pack of
    its padded matrices (TF32 halves in the slab order its ring and wgmma
    read), the batch's rows one sample after another whatever the graph's
    size (its row tiles span samples; ``samples`` is what f32 K5 stacks in
    a block on the same graph), and the stash it returns [R, B, rows, 128]
    as K2b reads it."""
    g = build_code("surface", d).to("cpu")
    m, n = g.n_checks_pad, g.n_qubits_pad
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in round_weights(128, 5).items()})
    mats32, vecs32 = fd.pack_weights_f32(w)
    xc, xq = torch.zeros((batch, m, 128)), torch.zeros((batch, n, 128))
    with _recorded_wgmma_packs(monkeypatch) as packs:
        out_c, out_q, sc, sq = fb._fwd_stash_cuda(xc, xq, xc[..., :1], fd.make_operators(g),
                                                  mats32, vecs32, 3, "float32")
    ((entry, args),) = k1_library.calls
    ((pack, dt),) = packs
    assert k1_library.loaded == ["wide_rounds_tf32"] and dt == torch.float32
    assert rg.samples_per_block(batch, m, n) == samples
    # (dtype code, xc, xq, syn, idx_c, idx_q, pack, vecs, out_c, out_q,
    #  stash_c, stash_q, ys_c, ys_q, B, M, N, Dc, Dq, R, W, width, stream)
    assert entry == "wide_rounds_launch" and args[0] == 0 and args[6] == pack.data_ptr()
    hi, lo = wgmma_matrices(pack, 128, torch.float32)
    mats = fd.cast_packs(mats32, vecs32, torch.float32)[0]
    assert torch.equal(hi, fd.tf32_round(mats)) and torch.equal(lo, fd.tf32_round(mats - hi))
    assert args[10] == sc.data_ptr() and args[11] == sq.data_ptr()
    assert args[14:17] == (batch, m, n) and args[19:22] == (3, 128, 128)
    assert tuple(sc.shape) == (3, batch, m, 128) and tuple(sq.shape) == (3, batch, n, 128)
    assert sc.dtype == torch.float32 and out_c.shape == (batch, m, 128)
    assert fd.launch_counts()["fused_rounds_fwd_stash"] == 1


def test_bf16_k2a_is_left_as_it_was(k1_library, monkeypatch):
    """bf16 K2a packs its bf16 matrices as they are, and takes the batch's
    rows as they come."""
    g = build_code("surface", 3).to("cpu")
    m, n = g.n_checks_pad, g.n_qubits_pad
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in round_weights(128, 5).items()})
    mats32, vecs32 = fd.pack_weights_f32(w)
    xc, xq = torch.zeros((8, m, 128)), torch.zeros((8, n, 128))
    with _recorded_wgmma_packs(monkeypatch) as packs:
        _, _, sc, _ = fb._fwd_stash_cuda(xc, xq, xc[..., :1], fd.make_operators(g), mats32,
                                         vecs32, 2, "bfloat16")
    ((entry, args),) = k1_library.calls
    ((pack, dt),) = packs
    assert k1_library.loaded == ["wide_rounds"] and dt == torch.bfloat16
    (got,) = wgmma_matrices(pack, 128, torch.bfloat16)
    assert torch.equal(got, fd.cast_packs(mats32, vecs32, torch.bfloat16)[0])
    assert args[0] == 1 and args[14:17] == (8, m, n)
    assert sc.dtype == torch.bfloat16 and tuple(sc.shape) == (2, 8, m, 128)
