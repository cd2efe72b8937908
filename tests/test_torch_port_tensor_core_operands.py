"""The premise of the bf16 tensor-core kernels: every matrix product of the
plain versions reads bf16 values.

K1/K2a (``csrc/fused_rounds.cu``) and K2b (``csrc/fused_backward.cu``) form
their bf16 products on ``mma.sync`` with bf16 operands and f32 accumulation.
That computes the plain versions' function only if each operand of each
product the plain versions form in bf16 is already a bf16 value (states and
hiddens rounded, packed matrices stored in bf16, cotangents rounded where the
JAX kernel rounds them): then the f32 products are exact and only the f32
summation order differs.  These tests watch every product of
``rounds_fwd_stash_plain`` and ``rounds_vjp_plain`` under a
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


def _case(d, h, batch, seed):
    graph = build_code("surface", d).to("cpu")
    ops = fd.make_operators(graph)
    rng = np.random.default_rng(seed)
    w = {}
    for f in fd.RoundWeights._fields:
        if f in ("b0_c", "bo_c", "b0_q", "bo_q", "uc_s", "uc_b0", "uc_b1", "uq_b0",
                 "uq_b1", "lnc_scale", "lnc_bias", "lnq_scale", "lnq_bias"):
            a = rng.standard_normal((1, h)) * 0.2 + (1.0 if f.endswith("scale") else 0.0)
        else:
            a = rng.standard_normal((h, h)) / np.sqrt(h)
        w[f] = torch.from_numpy(a.astype(np.float32))
    mats32, vecs32 = fd.pack_weights_f32(fd.RoundWeights(**w))
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


def test_the_watch_sees_an_unrounded_operand():
    """The check is not vacuous: an f32 operand with bits below bf16's is
    caught."""
    a = torch.full((2, 2), 1.0 + 2.0 ** -12)
    watch = _WatchProducts()
    with watch:
        a @ torch.ones(2, 2)
        torch.ones(2, 2).bfloat16().float() @ torch.ones(2, 2)
    assert watch.seen == [[False, True], [True, True]]
