"""The f32 rounds' adjoint (K2b) on tensor cores (3xTF32).

With f32 states K2b (``csrc/wide_rounds.cuh``, the library
``wide_backward_tf32``) forms every product of the replay, the adjoint and
the weight gradients as three TF32 products of operands split into TF32
halves, as f32 K1, K2a and K5 do (``tests/test_torch_tf32x3.py``).  These
tests hold:

* ``rounds_vjp_plain`` fed the stash of ``rounds_fwd_stash_plain``, both
  with every f32 product split three ways (the emulation of
  ``tests/tf32x3_emulation.py``), against ``jax.grad`` through the JAX
  package's kernel VJP in f32 (``kernel_trained_rounds(interpret=True)``, as
  ``tests/test_torch_port_backward.py`` builds it), leaf by leaf within that
  file's tolerances; the same adjoint with one TF32 product lands farther
  from JAX;
* the K2b wrapper: with f32 states it loads the f32 library and hands the
  kernel the forward pack and the transposed one, each split into TF32
  halves in the wgmma slab order, and both unsplit for its ties; with
  bf16 states the bf16 library and both packs in bf16, no ties;
* every surface graph launches: the kernel keeps no gather panels, so its
  shared memory does not grow with the graph.

The wrappers run on CPU tensors standing in for the card's, against a stub
library that records each launch.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from tests.test_torch_port_backward import (ATOL, RTOL, W_ATOL, W_RTOL, _compare, _inputs,
                                            _jax_grads)
from tests.tf32x3_emulation import Tf32x3Products, round_weights, wgmma_matrices
from tpugnn.kernels import fused_decoder as jfd
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.kernels import fused_backward as fb
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.tanner import build_code

SMS = 132   # the stub card's SMs: the persistent grid's bound


def _emulated_grads(tg, w, inputs, rounds, passes):
    """jax.grad's leaves from the plain forward-with-stash and adjoint on the
    kernels' operands (padded to 128 columns, the LayerNorm over the model's
    width), every f32 product formed as the kernels form it."""
    h = w["wd_c"].shape[0]
    xc, xq, syn, cot_c, cot_q = (torch.from_numpy(a) for a in inputs)
    rw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    mats32, vecs32 = fd.pad_packs(*fd.pack_weights_f32(rw))
    xcp, xqp, ccp, cqp = fd.pad_states(xc, xq, cot_c, cot_q)
    width = h if h < fd.WIDTH else None
    ops = fd.make_operators(tg)
    mode = Tf32x3Products(passes)
    with torch.no_grad(), mode:
        _, _, sc, sq = fb.rounds_fwd_stash_plain(xcp, xqp, syn, ops, mats32, vecs32,
                                                 rounds=rounds, width=width)
        forward = mode.count
        gc, gq, dsyn, dmats, dvecs = fb.rounds_vjp_plain(sc, sq, syn, ops, mats32, vecs32,
                                                         ccp, cqp, width=width)
    assert forward == 10 * rounds and mode.count - forward == 30 * rounds
    leaves = [t.clone().requires_grad_(True) for t in rw]
    with torch.enable_grad():
        packs = fd.pad_packs(*fd.pack_weights_f32(fd.RoundWeights(*leaves)))
        grads = torch.autograd.grad(packs, leaves, (dmats, dvecs))
    out = {"dxc": gc[..., :h], "dxq": gq[..., :h], "dsyn": dsyn}
    out.update(zip(fd.RoundWeights._fields, grads))
    return {k: v.numpy() for k, v in out.items()}


def _worst(got, ref):
    """The largest |got - ref| over atol + rtol |ref| of any entry, with the
    tolerances of ``_compare`` (1 is its limit)."""
    out = 0.0
    for k, r in ref.items():
        if k in ("dxc", "dxq", "dsyn"):
            atol, rtol = ATOL, RTOL
        else:
            atol, rtol = W_ATOL * max(1.0, float(np.abs(r).max())), W_RTOL
        out = max(out, float((np.abs(got[k] - r) / (atol + rtol * np.abs(r))).max()))
    return out


@pytest.mark.parametrize("d,h,rounds,batch", [(5, 128, 14, 8), (3, 64, 14, 8)])
def test_split_adjoint_matches_jax_kernel_vjp(d, h, rounds, batch):
    """The adjoint with every product split three ways against JAX's kernel
    VJP in f32, within tests/test_torch_port_backward.py's tolerances; one
    TF32 pass on the same inputs lands farther from it."""
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    w = round_weights(h, seed=110 + d)
    inputs = _inputs(jg.n_checks_pad, jg.n_qubits_pad, h, batch, seed=120 + d,
                     check_mask=np.asarray(jg.check_mask))
    ref = _jax_grads(jfd.make_operators(jg), w, inputs, rounds, "float32")
    got = _emulated_grads(tg, w, inputs, rounds, passes=3)
    _compare(got, ref, "float32")
    worst3 = _worst(got, ref)
    worst1 = _worst(_emulated_grads(tg, w, inputs, rounds, passes=1), ref)
    print(f"d={d} h={h}: worst error over tolerance against JAX, 3xTF32 {worst3}, "
          f"one TF32 pass {worst1}")
    assert worst3 <= 1.0 < worst1, (worst3, worst1)


class _Library:
    """A rounds library as far as a launch: records each entry point
    reached with its arguments."""

    def __init__(self, name):
        self.name = name
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
def k2b_library(monkeypatch):
    """The stub backward libraries by name (any other library fails the
    test); the wrapper's packs as it casts them (``cast``) and packs them
    for wgmma (``packed``, with the matrices each came from in
    ``unpacked``)."""
    from tpugnn_torch.kernels import _build

    libs = {n: _Library(n) for n in ("wide_backward", "wide_backward_tf32")}
    monkeypatch.setattr(_build, "load_library", lambda name: libs.get(name) or
                        pytest.fail(f"loaded {name}"))
    monkeypatch.setattr(fd, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
    packs = types.SimpleNamespace(cast=[], packed=[], unpacked=[])
    cast, pack = fd.cast_packs, fd.wgmma_pack

    def record_cast(*args):
        mats, vecs = cast(*args)
        packs.cast.append(mats)
        return mats, vecs

    def record_pack(mats, dt):
        packs.unpacked.append(mats)
        packs.packed.append(pack(mats, dt))
        return packs.packed[-1]

    monkeypatch.setattr(fd, "cast_packs", record_cast)
    monkeypatch.setattr(fd, "wgmma_pack", record_pack)
    fd.reset_launch_counts()
    return libs, packs


def _bwd(d, batch, rounds, dtype):
    """_bwd_cuda on a zero stash of the surface code of distance d."""
    g = build_code("surface", d).to("cpu")
    m, n = g.n_checks_pad, g.n_qubits_pad
    w = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in round_weights(128, 7).items()})
    mats32, vecs32 = fd.pack_weights_f32(w)
    dt = fd.STATE_DTYPES[dtype]
    sc = torch.zeros((rounds, batch, m, 128), dtype=dt)
    sq = torch.zeros((rounds, batch, n, 128), dtype=dt)
    cot_c, cot_q = torch.zeros((batch, m, 128)), torch.zeros((batch, n, 128))
    ops = fd.make_operators(g)
    fb._bwd_cuda(sc, sq, torch.zeros((batch, m, 1)), ops, mats32, vecs32, cot_c, cot_q, dtype)
    return m, n, ops, mats32


@pytest.mark.parametrize("d,batch", [(11, 20), (3, 8)])
def test_f32_k2b_wrapper_passes_both_split_packs(d, batch, k2b_library):
    """f32 K2b loads the f32 library and hands its kernel the matrices and
    their transposes, each split into TF32 halves in the slab order its
    ring and wgmma read, and both unsplit (for its ties) with the stash
    rows' norms and the matrices' largest column norms."""
    libs, packs = k2b_library
    m, n, ops, mats32 = _bwd(d, batch, 3, "float32")
    assert not libs["wide_backward"].calls
    ((entry, args),) = libs["wide_backward_tf32"].calls
    # (dtype code, stash_c, stash_q, syn, idx_c, idx_q, off_c, lst_c, off_q,
    #  lst_q, deg_c, deg_q, pack, pack_t, mats32, mats32_t, xn_c, xn_q, wn,
    #  vecs, ucs32, dxc, dxq, dsyn, scratch, part_mats, part_vecs, dmats,
    #  dvecs, B, M, N, Dc, Dq, R, W, width, msg_width, chunks, stream)
    assert entry == "wide_rounds_bwd_launch" and len(args) == 40 and args[0] == 0
    pack, pack_t = packs.packed
    assert (args[12], args[13]) == (pack.data_ptr(), pack_t.data_ptr())
    (mats,) = packs.cast
    assert mats.dtype == torch.float32 and packs.unpacked[0] is mats
    assert torch.equal(packs.unpacked[1], mats.transpose(1, 2))
    assert (args[14], args[15]) == (mats.data_ptr(), packs.unpacked[1].data_ptr())
    assert args[16] is not None and args[17] is not None and len(args[18]) == 10
    for p, want in ((pack, mats), (pack_t, mats.transpose(1, 2))):
        hi, lo = wgmma_matrices(p, 128, torch.float32)
        assert torch.equal(hi, fd.tf32_round(want))
        assert torch.equal(lo, fd.tf32_round(want - hi))
    assert args[29:39] == (batch, m, n, ops[0].shape[1], ops[3].shape[1], 3, 128, 128, 128,
                           fb.wgrad_chunks(128))
    assert fd.launch_counts()["fused_rounds_bwd"] == 1


def test_bf16_k2b_takes_its_packs_unsplit(k2b_library):
    """bf16 K2b loads the bf16 library and hands its kernel the bf16
    matrices and their transposes as they are, and no tie operands."""
    libs, packs = k2b_library
    _bwd(5, 8, 2, "bfloat16")
    assert not libs["wide_backward_tf32"].calls
    ((entry, args),) = libs["wide_backward"].calls
    (mats,) = packs.cast
    assert entry == "wide_rounds_bwd_launch" and args[0] == 1
    assert mats.dtype == torch.bfloat16 and packs.unpacked[0] is mats
    (got,) = wgmma_matrices(packs.packed[0], 128, torch.bfloat16)
    assert torch.equal(got, mats)
    assert args[14:19] == (None,) * 5
    assert args[29] == 8 and args[34:36] == (2, 128)


@pytest.mark.parametrize("d", [3, 5, 7, 9, 11])
def test_f32_k2b_fits_every_surface_graph_through_d11(d, k2b_library):
    """The f32 kernel keeps no gather panels (its row tiles gather from
    global memory), so its block's shared memory does not grow with the
    graph: every surface graph through d=11 (the models of widths 64, 96
    and 128 run on the same padded rows) launches it once, with its rows."""
    libs, _ = k2b_library
    m, n, ops, _ = _bwd(d, 2, 2, "float32")
    ((entry, args),) = libs["wide_backward_tf32"].calls
    assert entry == "wide_rounds_bwd_launch" and args[29:32] == (2, m, n)
    assert fd.launch_counts()["fused_rounds_bwd"] == 1
