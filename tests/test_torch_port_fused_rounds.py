"""rounds_plain (the fused rounds' plain PyTorch version) against tpugnn.

``rounds_xla`` is the JAX package's pure twin of its kernel and
``decoder_rounds(..., interpret=True)`` the Pallas kernel in interpret mode.
Tolerance atol 5e-4 / rtol 1e-3, the bound of
tests/kernels/test_fused_decoder.py: f32 throughout, summed in another order
(the port folds wo @ ua; the TPU kernel reassociates its slot sums).
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.kernels import fused_decoder as jfd
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

ATOL, RTOL = 5e-4, 1e-3


def _weights(h, seed):
    rng = np.random.default_rng(seed)
    shapes = {f: (h, h) for f in fd.RoundWeights._fields}
    for f in ("b0_c", "bo_c", "b0_q", "bo_q", "uc_s", "uc_b0", "uc_b1", "uq_b0",
              "uq_b1", "lnc_scale", "lnc_bias", "lnq_scale", "lnq_bias"):
        shapes[f] = (1, h)
    out = {}
    for f, shp in shapes.items():
        scale = 1.0 / np.sqrt(h) if shp[0] == h else 0.2
        w = rng.standard_normal(shp).astype(np.float32) * scale
        out[f] = (w + (1.0 if f.endswith("scale") else 0.0)).astype(np.float32)
    return out


def _states(m, n, h, batch, seed, check_mask=None):
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((batch, m, h)).astype(np.float32)
    xq = rng.standard_normal((batch, n, h)).astype(np.float32)
    syn = np.sign(rng.standard_normal((batch, m, 1))).astype(np.float32)
    if check_mask is not None:
        syn = syn * check_mask[None, :, None]
    return xc, xq, syn


def _both(w):
    jw = jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()})
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    return jw, tw


def _t(*a):
    return [torch.from_numpy(x) for x in a]


@pytest.mark.parametrize("d,rounds", [(3, 3), (5, 4)])
def test_plain_matches_rounds_xla_and_pallas_interpret(d, rounds):
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    h = 32
    jw, tw = _both(_weights(h, seed=d))
    xc, xq, syn = _states(jg.n_checks_pad, jg.n_qubits_pad, h, 4, seed=10 + d,
                          check_mask=np.asarray(jg.check_mask))
    got = fd.rounds_plain(*_t(xc, xq, syn), fd.make_operators(tg), tw, rounds=rounds)
    ops = jfd.make_operators(jg)
    ref = jfd.rounds_xla(jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn), ops, jw,
                         rounds=rounds)
    pal = jfd.decoder_rounds(jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn), ops, jw,
                             rounds=rounds, interpret=True, compute_dtype="float32")
    for g, r, p in zip(got, ref, pal):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=ATOL, rtol=RTOL)


# bf16 states against the Pallas kernel in interpret mode.  Both round the
# states, slot sums, update hiddens and the syndrome term to bf16 at the same
# points; they differ only in f32 summation order, which flips a bf16
# rounding now and then (1 ulp = 2^-8 relative).  A flip travels through
# later rounds, so the bounds are on the mean and on the share of states that
# differ at all, not on the max.
BF16_MEAN_ABS = 1e-4
BF16_SHARE_DIFFERENT = 0.01


@pytest.mark.parametrize("d", [3, 5])
def test_bf16_plain_matches_pallas_interpret(d):
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    h, rounds = 32, 4
    w = _weights(h, seed=20 + d)
    w["uc_s"] = (0.7 * np.random.default_rng(d).standard_normal((1, h))).astype(np.float32)
    jw, tw = _both(w)
    xc, xq, syn = _states(jg.n_checks_pad, jg.n_qubits_pad, h, 8, seed=30 + d,
                          check_mask=np.asarray(jg.check_mask))
    got = fd.rounds_plain(*_t(xc, xq, syn), fd.make_operators(tg), tw, rounds=rounds,
                          state_dtype="bfloat16")
    pal = jfd.decoder_rounds(jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn),
                             jfd.make_operators(jg), jw, rounds=rounds, interpret=True,
                             compute_dtype="bfloat16")
    for g, p in zip(got, pal):
        diff = np.abs(g.numpy() - np.asarray(p, np.float32))
        assert diff.mean() <= BF16_MEAN_ABS, diff.mean()
        assert (diff > 0).mean() <= BF16_SHARE_DIFFERENT, (diff > 0).mean()


def test_plain_matches_rounds_xla_on_lopsided_graph():
    """M != N (8 check rows, 24 qubit rows), mixed degrees, rows of degree 0
    and padded rows, through synthetic ELL tables."""
    rng = np.random.default_rng(3)
    m, n, h = 8, 24, 16
    edges = [(c, q) for c in range(6) for q in range(22) if rng.random() < 0.3]
    edges += [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5)]          # a degree-5 qubit
    edges = sorted(set(edges))
    e_pad = len(edges) + 3
    ec = np.full(e_pad, m - 1, np.int32)
    eq = np.full(e_pad, n - 1, np.int32)
    ec[:len(edges)] = [c for c, _ in edges]
    eq[:len(edges)] = [q for _, q in edges]

    def ell(dst, rows):
        deg = np.bincount(dst[:len(edges)], minlength=rows)
        dmax = int(deg.max())
        tbl = np.full((rows, dmax), e_pad - 1, np.int32)
        msk = np.zeros((rows, dmax), np.float32)
        fill = np.zeros(rows, np.int64)
        for eid, r in enumerate(dst[:len(edges)]):
            tbl[r, fill[r]], msk[r, fill[r]] = eid, 1.0
            fill[r] += 1
        return tbl, msk, deg

    tc, mc, deg_c = ell(ec, m)
    tq, mq, deg_q = ell(eq, n)
    assert tc.shape[1] != tq.shape[1] and (deg_c == 0).any() and (deg_q == 0).any()
    jgraph = SimpleNamespace(
        edge_check=jnp.asarray(ec), edge_qubit=jnp.asarray(eq),
        ell_check_edge=jnp.asarray(tc), ell_check_mask=jnp.asarray(mc),
        ell_qubit_edge=jnp.asarray(tq), ell_qubit_mask=jnp.asarray(mq),
        n_checks_pad=m, n_qubits_pad=n)
    tgraph = SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                for k, v in vars(jgraph).items() if k.startswith(("edge", "ell"))})
    jw, tw = _both(_weights(h, seed=4))
    xc, xq, syn = _states(m, n, h, 3, seed=5)
    got = fd.rounds_plain(*_t(xc, xq, syn), fd.make_operators(tgraph), tw, rounds=3)
    ref = jfd.rounds_xla(jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn),
                         jfd.make_operators(jgraph), jw, rounds=3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


def test_make_operators_tables():
    g = build_code("surface", 5)
    src_c, mask_c, deg_c, src_q, mask_q, deg_q = fd.make_operators(g.to("cpu"))
    h = np.asarray(g.h_inc)
    # every real slot of check r reads a qubit of its support, each once
    for r in range(g.n_checks_pad):
        real = src_c[r][mask_c[r] > 0].numpy()
        assert sorted(real) == list(np.nonzero(h[r])[0])
        assert deg_c[r] == len(real)
    for q in range(g.n_qubits_pad):
        real = src_q[q][mask_q[q] > 0].numpy()
        assert sorted(real) == list(np.nonzero(h[:, q])[0])
        assert deg_q[q] == len(real)


def test_cpu_dispatch_is_the_plain_version():
    tg = build_code("surface", 3).to("cpu")
    _, tw = _both(_weights(16, seed=1))
    xc, xq, syn = _t(*_states(tg.n_checks_pad, tg.n_qubits_pad, 16, 2, seed=2))
    ops = fd.make_operators(tg)
    before = fd.launch_counts()["fused_rounds"]
    a = fd.decoder_rounds(xc, xq, syn, ops, tw, 2, "float32")
    b = fd.rounds_plain(xc, xq, syn, ops, tw, rounds=2)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert fd.launch_counts()["fused_rounds"] == before


def test_bf16_storage_rounds_states():
    """bf16 storage: every state comes back bf16-representable and near the
    f32 function (atol 0.1: a few bf16 ulps at |x| <= 4, over 3 rounds)."""
    tg = build_code("surface", 3).to("cpu")
    _, tw = _both(_weights(32, seed=6))
    xc, xq, syn = _t(*_states(tg.n_checks_pad, tg.n_qubits_pad, 32, 2, seed=7))
    ops = fd.make_operators(tg)
    lo = fd.rounds_plain(xc, xq, syn, ops, tw, rounds=3, state_dtype="bfloat16")
    hi = fd.rounds_plain(xc, xq, syn, ops, tw, rounds=3)
    for a, b in zip(lo, hi):
        torch.testing.assert_close(a, a.to(torch.bfloat16).float(), rtol=0, atol=0)
        torch.testing.assert_close(a, b, rtol=0, atol=0.1)


def test_pack_weights_folds_aggregation():
    _, tw = _both(_weights(16, seed=8))
    mats, vecs = fd.pack_weights(tw, torch.float32)
    assert mats.shape == (10, 16, 16) and vecs.shape == (14, 16)
    torch.testing.assert_close(mats[3], tw.wo_c @ tw.uc_a)
    torch.testing.assert_close(mats[8], tw.wo_q @ tw.uq_a)
    torch.testing.assert_close(vecs[1], (tw.bo_c @ tw.uc_a).reshape(-1))
    assert not vecs[9].any()          # the qubit side has no syndrome term


def test_kernel_path_refuses_other_devices():
    tg = build_code("surface", 3).to("cpu")
    _, tw = _both(_weights(16, seed=1))
    xc, xq, syn = (t.to("meta") for t in _t(*_states(tg.n_checks_pad, tg.n_qubits_pad,
                                                      16, 1, seed=2)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fd.decoder_rounds(xc, xq, syn, fd.make_operators(tg), tw, 1)


class _Launched(Exception):
    """Raised by the stubbed library: which C entry point the call reached."""


class _StubLibrary:
    def __init__(self, name):
        self.name = name

    def fused_rounds_smem_bytes(self, *args):
        return 0

    def __getattr__(self, entry):
        def launch(*args):
            raise _Launched(entry)
        return launch


@pytest.mark.parametrize("case,entry", [
    ("state_grad", "fused_rounds_stash_launch"),     # K2a, in FusedRoundsFn
    ("weight_grad", "fused_rounds_stash_launch"),
    ("no_grad", "fused_rounds_launch"),              # K1
    ("inference_mode", "fused_rounds_launch"),
])
def test_kernel_path_routes_autograd(case, entry, monkeypatch):
    """With grad enabled and an operand that requires grad, the CUDA path
    goes through the autograd Function, whose forward is K2a; under no_grad
    or inference_mode it launches K1.  The library loader is stubbed, so the
    call stops at the C entry point it reaches (with CPU tensors standing in
    for the card's, and no stream)."""
    from tpugnn_torch.kernels import _build

    monkeypatch.setattr(_build, "load_library", _StubLibrary)
    monkeypatch.setattr(fd, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    tg = build_code("surface", 3).to("cpu")
    _, tw = _both(_weights(128, seed=1))
    xc, xq, syn = _t(*_states(tg.n_checks_pad, tg.n_qubits_pad, 128, 1, seed=2))
    ops = fd.make_operators(tg)
    if case == "state_grad":
        xc.requires_grad_(True)
    else:
        tw.uc_w1.requires_grad_(True)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        case, torch.enable_grad)
    with ctx(), pytest.raises(_Launched, match=entry):
        fd._rounds_cuda(xc, xq, syn, ops, tw, 1, "float32")
