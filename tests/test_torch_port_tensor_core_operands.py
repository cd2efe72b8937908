"""The premise of the bf16 tensor-core kernels: every matrix product of the
plain versions reads bf16 values.

K1/K2a and K2b (``csrc/wide_rounds.cuh``, on ``wgmma``), K4
(``csrc/sddmm.cu``, bf16 at width 128) and K5 (``csrc/roll_gather.cu``, on
``mma.sync``) form their bf16 products with bf16 operands and f32
accumulation.
That computes the plain versions' function only if each operand of each
product the plain versions form in bf16 is already a bf16 value (states and
hiddens rounded, packed matrices stored in bf16, cotangents rounded where the
JAX kernel rounds them): then the f32 products are exact and only the f32
summation order differs.  These tests watch every product of
``rounds_fwd_stash_plain``, ``rounds_vjp_plain``, ``roll_rounds_plain``
(with f32 and with bf16 slot sums) and ``sddmm_edge_hidden_plain`` under a
``TorchFunctionMode`` and hold each operand to ``a == bf16(a)``, so a later
change to the plain versions that feeds a product an unrounded f32 operand
fails here.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tpugnn_torch.kernels import fused_backward as fb
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.kernels import roll_gather as rg
from tpugnn_torch.kernels import sddmm
from tpugnn_torch.tanner import build_code

_PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.Tensor.matmul, torch.Tensor.mm,
             torch.Tensor.bmm, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__}


class _WatchProducts(TorchFunctionMode):
    """Records, for every matrix product, whether each operand is unchanged
    by rounding to bf16."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            self.seen.append([bool(torch.equal(a, a.bfloat16().float()))
                              for a in args[:2] if isinstance(a, torch.Tensor)])
        return func(*args, **kwargs)


def _weights(h, rng):
    w = {}
    for f in fd.RoundWeights._fields:
        if f in ("b0_c", "bo_c", "b0_q", "bo_q", "uc_s", "uc_b0", "uc_b1", "uq_b0",
                 "uq_b1", "lnc_scale", "lnc_bias", "lnq_scale", "lnq_bias"):
            a = rng.standard_normal((1, h)) * 0.2 + (1.0 if f.endswith("scale") else 0.0)
        else:
            a = rng.standard_normal((h, h)) / np.sqrt(h)
        w[f] = torch.from_numpy(a.astype(np.float32))
    return fd.RoundWeights(**w)


def _case(d, h, batch, seed):
    graph = build_code("surface", d).to("cpu")
    ops = fd.make_operators(graph)
    rng = np.random.default_rng(seed)
    mats32, vecs32 = fd.pack_weights_f32(_weights(h, rng))
    m, n = graph.n_checks_pad, graph.n_qubits_pad
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    xc, xq = t(batch, m, h), t(batch, n, h)
    syn = torch.from_numpy(np.sign(rng.standard_normal((batch, m, 1))).astype(np.float32))
    return ops, mats32, vecs32, xc, xq, syn, t(batch, m, h), t(batch, n, h)


@pytest.mark.parametrize("d,h,batch", [(3, 16, 4), (5, 32, 2)])
@pytest.mark.parametrize("stage", ["fwd_stash", "vjp"])
def test_every_product_reads_bf16_values(d, h, batch, stage):
    ops, mats32, vecs32, xc, xq, syn, cot_c, cot_q = _case(d, h, batch, seed=d)
    rounds = 3
    with torch.no_grad():
        _, _, stash_c, stash_q = fb.rounds_fwd_stash_plain(
            xc, xq, syn, ops, mats32, vecs32, rounds=rounds, state_dtype="bfloat16")
        watch = _WatchProducts()
        with watch:
            if stage == "fwd_stash":
                fb.rounds_fwd_stash_plain(xc, xq, syn, ops, mats32, vecs32, rounds=rounds,
                                          state_dtype="bfloat16")
            else:
                fb.rounds_vjp_plain(stash_c, stash_q, syn, ops, mats32, vecs32, cot_c,
                                    cot_q, state_dtype="bfloat16")
    # the forward forms 10 products per round, the adjoint 30
    assert len(watch.seen) == (10 if stage == "fwd_stash" else 30) * rounds
    bad = [i for i, ok in enumerate(watch.seen) if not (len(ok) == 2 and all(ok))]
    assert not bad, f"products {bad} of {len(watch.seen)} read an operand that is not bf16"


@pytest.mark.parametrize("d,h,batch", [(3, 16, 4), (5, 32, 2)])
@pytest.mark.parametrize("slot_dtype", ["float32", "bfloat16"])
def test_every_roll_product_reads_bf16_values(d, h, batch, slot_dtype):
    """K5's premise: with bf16 states every product of roll_rounds_plain
    (the projections, ydb, x @ ux, hs @ wf and hc @ w1 of both sides) reads
    bf16 values, with f32 slot sums and with slot16."""
    graph = build_code("surface", d).to("cpu")
    rng = np.random.default_rng(d)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    syn = torch.from_numpy(np.sign(rng.standard_normal((batch, graph.n_checks_pad, 1)))
                           .astype(np.float32))
    ops = rg.to_raster(t(batch, graph.n_checks_pad, h), t(batch, graph.n_qubits_pad, h), syn,
                       rg.plan_for_graph(graph), _weights(h, rng), "bfloat16")
    rounds = 3
    watch = _WatchProducts()
    with torch.no_grad(), watch:
        rg.roll_rounds_plain(ops, rounds=rounds, slot_dtype=slot_dtype)
    # 5 products per side and round
    assert len(watch.seen) == 10 * rounds
    bad = [i for i, ok in enumerate(watch.seen) if not (len(ok) == 2 and all(ok))]
    assert not bad, f"products {bad} of {len(watch.seen)} read an operand that is not bf16"


@pytest.mark.parametrize("h", [16, 32])
@pytest.mark.parametrize("to", ["check", "qubit"])
@pytest.mark.parametrize("d", [3, 5])
def test_every_sddmm_product_reads_bf16_values(d, to, h):
    """K4's premise: in bf16 both projections of sddmm_edge_hidden_plain
    (x_dst @ wd and x_src @ ws) read bf16 values, in either direction."""
    graph = build_code("surface", d).to("cpu")
    src_c, mask_c, _, src_q, mask_q, _ = fd.make_operators(graph)
    m, n = graph.n_checks_pad, graph.n_qubits_pad
    rows_dst, rows_src, src, mask = (m, n, src_c, mask_c) if to == "check" else (n, m, src_q,
                                                                                 mask_q)
    rng = np.random.default_rng(d + h)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    watch = _WatchProducts()
    with torch.no_grad(), watch:
        sddmm.sddmm_edge_hidden_plain(t(2, rows_dst, h), t(2, rows_src, h), src, mask,
                                      t(h, h) / h ** 0.5, t(h, h) / h ** 0.5, t(h),
                                      compute_dtype="bfloat16")
    assert len(watch.seen) == 2
    bad = [i for i, ok in enumerate(watch.seen) if not (len(ok) == 2 and all(ok))]
    assert not bad, f"products {bad} of {len(watch.seen)} read an operand that is not bf16"


def test_the_watch_sees_an_unrounded_operand():
    """The check is not vacuous: an f32 operand with bits below bf16's is
    caught."""
    a = torch.full((2, 2), 1.0 + 2.0 ** -12)
    watch = _WatchProducts()
    with watch:
        a @ torch.ones(2, 2)
        torch.ones(2, 2).bfloat16().float() @ torch.ones(2, 2)
    assert watch.seen == [[False, True], [True, True]]
