"""The training core of the port (kernels/fused_backward.py) against tpugnn.

``rounds_vjp_plain`` (through ``FusedRoundsFn`` on CPU tensors) against
``jax.grad`` through the JAX package's kernel VJP,
``kernel_trained_rounds(interpret=True)``: the Pallas forward-with-stash and
backward kernels in interpret mode.  Same inputs from numpy, gradients of a
random linear functional of both outputs, compared leaf by leaf.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.kernels import fused_decoder as jfd
from tpugnn.kernels.fused_backward import kernel_trained_rounds
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.kernels import fused_backward as fb
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

# f32: tests/kernels/test_fused_backward.py:54-85, the JAX package's own
# bound of its kernel VJP against autodiff of its XLA twin: f32 summed in
# another order through R rounds of LayerNorm.
ATOL, RTOL = 2e-3, 2e-3
W_ATOL, W_RTOL = 2e-3, 5e-3
# bf16: both versions round states, slot sums, hiddens and the cotangents
# dpre, dt, dz, dydb and dys to bf16 at the same points.  An f32 summation
# order that differs flips a rounding now and then (1 ulp = 2^-8 relative),
# and the adjoint carries the flip back through the rounds.  Each leaf is
# held to a relative L2 error of 2e-2, some five ulps over the whole leaf.
BF16_REL = 2e-2


def _weights(h, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f in fd.RoundWeights._fields:
        if f in ("b0_c", "bo_c", "b0_q", "bo_q", "uc_s", "uc_b0", "uc_b1", "uq_b0",
                 "uq_b1", "lnc_scale", "lnc_bias", "lnq_scale", "lnq_bias"):
            w = rng.standard_normal((1, h)) * 0.2 + (1.0 if f.endswith("scale") else 0.0)
        else:
            w = rng.standard_normal((h, h)) / np.sqrt(h)
        out[f] = w.astype(np.float32)
    return out


def _inputs(m, n, h, batch, seed, check_mask=None):
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((batch, m, h)).astype(np.float32)
    xq = rng.standard_normal((batch, n, h)).astype(np.float32)
    syn = np.sign(rng.standard_normal((batch, m, 1))).astype(np.float32)
    if check_mask is not None:
        syn = syn * check_mask[None, :, None]
    cot_c = rng.standard_normal((batch, m, h)).astype(np.float32)
    cot_q = rng.standard_normal((batch, n, h)).astype(np.float32)
    return xc, xq, syn, cot_c, cot_q


def _jax_grads(jops, w, inputs, rounds, dtype):
    xc, xq, syn, cot_c, cot_q = (jnp.asarray(a) for a in inputs)
    f = kernel_trained_rounds(jops, rounds=rounds, compute_dtype=dtype, interpret=True)
    jw = jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()})

    def loss(xc, xq, syn, w):
        oc, oq = f(xc, xq, syn, w)
        return jnp.sum(oc * cot_c) + jnp.sum(oq * cot_q)

    gx = jax.grad(loss, argnums=(0, 1, 2, 3))(xc, xq, syn, jw)
    out = {"dxc": gx[0], "dxq": gx[1], "dsyn": gx[2]}
    out.update({f: getattr(gx[3], f) for f in fd.RoundWeights._fields})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _torch_grads(tops, w, inputs, rounds, dtype):
    xc, xq, syn, cot_c, cot_q = (torch.from_numpy(a).requires_grad_(True) for a in inputs)
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    oc, oq = fd.decoder_rounds(xc, xq, syn, tops, fd.RoundWeights(**leaves), rounds, dtype)
    ((oc * cot_c.detach()).sum() + (oq * cot_q.detach()).sum()).backward()
    out = {"dxc": xc.grad, "dxq": xq.grad, "dsyn": syn.grad}
    out.update({k: v.grad for k, v in leaves.items()})
    return {k: v.numpy() for k, v in out.items()}


def _compare(got, ref, dtype):
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if dtype == "bfloat16":
            rel = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-6)
            assert rel <= BF16_REL, f"{k}: relative error {rel}"
        elif k in ("dxc", "dxq", "dsyn"):
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g, r, atol=W_ATOL * scale, rtol=W_RTOL, err_msg=k)


@pytest.mark.parametrize("d,rounds,dtype", [(3, 2, "float32"), (5, 3, "float32"),
                                            (3, 2, "bfloat16")])
def test_vjp_plain_matches_jax_kernel_vjp(d, rounds, dtype):
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    w = _weights(32, seed=40 + d)
    inputs = _inputs(jg.n_checks_pad, jg.n_qubits_pad, 32, 4, seed=50 + d,
                     check_mask=np.asarray(jg.check_mask))
    ref = _jax_grads(jfd.make_operators(jg), w, inputs, rounds, dtype)
    got = _torch_grads(fd.make_operators(tg), w, inputs, rounds, dtype)
    _compare(got, ref, dtype)


def _lopsided():
    """M != N (8 check rows, 24 qubit rows), Dc != Dq, rows of degree 0 and
    padded rows, through synthetic ELL tables (as in
    tests/test_torch_port_fused_rounds.py)."""
    rng = np.random.default_rng(3)
    m, n = 8, 24
    edges = [(c, q) for c in range(6) for q in range(22) if rng.random() < 0.3]
    edges += [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5)]
    edges = sorted(set(edges))
    e_pad = len(edges) + 3
    ec = np.full(e_pad, m - 1, np.int32)
    eq = np.full(e_pad, n - 1, np.int32)
    ec[:len(edges)] = [c for c, _ in edges]
    eq[:len(edges)] = [q for _, q in edges]

    def ell(dst, rows):
        deg = np.bincount(dst[:len(edges)], minlength=rows)
        tbl = np.full((rows, int(deg.max())), e_pad - 1, np.int32)
        msk = np.zeros(tbl.shape, np.float32)
        fill = np.zeros(rows, np.int64)
        for eid, r in enumerate(dst[:len(edges)]):
            tbl[r, fill[r]], msk[r, fill[r]] = eid, 1.0
            fill[r] += 1
        return tbl, msk

    tc, mc = ell(ec, m)
    tq, mq = ell(eq, n)
    arrays = dict(edge_check=ec, edge_qubit=eq, ell_check_edge=tc, ell_check_mask=mc,
                  ell_qubit_edge=tq, ell_qubit_mask=mq)
    jgraph = SimpleNamespace(**{k: jnp.asarray(v) for k, v in arrays.items()},
                             n_checks_pad=m, n_qubits_pad=n)
    tgraph = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return m, n, jgraph, tgraph


def test_vjp_plain_matches_jax_kernel_vjp_on_lopsided_graph():
    """Masked slots: JAX's one-hot gathers read 0 there and its defc term
    cancels them; the port skips them.  The gradients must agree."""
    m, n, jgraph, tgraph = _lopsided()
    w = _weights(16, seed=6)
    inputs = _inputs(m, n, 16, 3, seed=7)
    ref = _jax_grads(jfd.make_operators(jgraph), w, inputs, 2, "float32")
    got = _torch_grads(fd.make_operators(tgraph), w, inputs, 2, "float32")
    _compare(got, ref, "float32")


def _small(d=3, h=16, b=3, seed=0):
    tg = build_code("surface", d).to("cpu")
    w = {k: torch.from_numpy(v) for k, v in _weights(h, seed).items()}
    xc, xq, syn, cot_c, cot_q = (torch.from_numpy(a) for a in _inputs(
        tg.n_checks_pad, tg.n_qubits_pad, h, b, seed + 1))
    return fd.make_operators(tg), fd.RoundWeights(**w), xc, xq, syn, cot_c, cot_q


def test_vjp_plain_matches_autograd_through_rounds_plain():
    """In f32 no cotangent rounding applies, so the explicit adjoint is
    autograd's through rounds_plain, up to f32 summation order."""
    ops, w, xc, xq, syn, cot_c, cot_q = _small()
    mats, vecs = fd.pack_weights_f32(w)
    mats.requires_grad_(True)
    vecs.requires_grad_(True)
    xcg, xqg, sg = (t.clone().requires_grad_(True) for t in (xc, xq, syn))
    oc, oq = fd.rounds_packed(xcg, xqg, sg, ops, *fd.cast_packs(mats, vecs, torch.float32),
                              rounds=3, dtype=torch.float32)
    ((oc * cot_c).sum() + (oq * cot_q).sum()).backward()
    _, _, stash_c, stash_q = fb.rounds_fwd_stash_plain(xc, xq, syn, ops, mats.detach(),
                                                       vecs.detach(), rounds=3)
    got = fb.rounds_vjp_plain(stash_c, stash_q, syn, ops, mats.detach(), vecs.detach(),
                              cot_c, cot_q)
    ref = (xcg.grad, xqg.grad, sg.grad, mats.grad, vecs.grad)
    for name, a, b in zip(("dxc", "dxq", "dsyn", "dmats", "dvecs"), got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_gradient_directional_finite_difference():
    """A random direction in every input and weight at once; the mean-tanh
    loss keeps cancellation noise small, relu kinks make pointwise checks
    flaky (tests/kernels/test_fused_backward.py's reasoning), hence rtol 5e-2."""
    ops, w, xc, xq, syn, _, _ = _small(h=16, b=2, seed=9)
    gen = torch.Generator().manual_seed(1)
    xs = [xc.double().float(), xq] + list(w)
    dirs = [torch.randn(t.shape, generator=gen) for t in xs]
    norm = sum(float((v * v).sum()) for v in dirs) ** 0.5
    dirs = [v / norm for v in dirs]

    def loss(ts):
        oc, oq = fd.decoder_rounds(ts[0], ts[1], syn, ops, fd.RoundWeights(*ts[2:]), 2)
        return torch.tanh(oc).mean() + torch.tanh(oq).mean()

    leaves = [t.clone().requires_grad_(True) for t in xs]
    loss(leaves).backward()
    analytic = sum(float((l.grad * v).sum()) for l, v in zip(leaves, dirs))
    eps = 1e-2
    with torch.no_grad():
        up = loss([t + eps * v for t, v in zip(xs, dirs)])
        dn = loss([t - eps * v for t, v in zip(xs, dirs)])
    numeric = float(up - dn) / (2 * eps)
    np.testing.assert_allclose(analytic, numeric, rtol=5e-2, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_stash_plain_outputs_equal_rounds_plain(dtype):
    ops, w, xc, xq, syn, _, _ = _small()
    mats, vecs = fd.pack_weights_f32(w)
    oc, oq, stash_c, stash_q = fb.rounds_fwd_stash_plain(xc, xq, syn, ops, mats, vecs,
                                                         rounds=3, state_dtype=dtype)
    pc, pq = fd.rounds_plain(xc, xq, syn, ops, w, rounds=3, state_dtype=dtype)
    torch.testing.assert_close(oc, pc, rtol=0, atol=0)
    torch.testing.assert_close(oq, pq, rtol=0, atol=0)
    dt = fd.STATE_DTYPES[dtype]
    assert stash_c.shape == (3, *xc.shape) and stash_c.dtype == dt
    torch.testing.assert_close(stash_c[0], xc.to(dt), rtol=0, atol=0)
    # round r's input is round r-1's output
    pc1, pq1 = fd.rounds_plain(xc, xq, syn, ops, w, rounds=2, state_dtype=dtype)
    torch.testing.assert_close(stash_c[2].float(), pc1, rtol=0, atol=0)
    torch.testing.assert_close(stash_q[2].float(), pq1, rtol=0, atol=0)
