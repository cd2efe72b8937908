"""The port's BP and BP+OSD-0 (tpugnn_torch.baselines.{bp,osd}) against the
JAX package's.

* ``bp_posteriors`` within 1e-4 of JAX's (f32 LLRs) on the same numpy-seeded
  syndromes at surface d=3, d=5 and on a spacetime detector graph, at
  alpha 0.8 and 1.0.
* ``osd0_py`` and the native OSD equal JAX's ``osd0_py`` exactly on given
  LLRs; ``BPOSDDecoder``'s corrections equal JAX's on >= 99.9% of 2,048
  d=5 syndromes (the OSD's column order follows the f32 LLRs, which may
  differ in the last place) and reproduce every syndrome.
* The JAX package's own BP and OSD tests, on the port: BP exact on the
  repetition chain, zero syndrome to zero correction, padded qubits never
  flip, BP+OSD always syndrome-consistent and better than plain BP, and
  ``ler_bp`` / ``ler_bp_osd`` on a detector graph (an empty X sector).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.baselines.bp import bp_posteriors as jax_bp_posteriors
from tpugnn.baselines.osd import BPOSDDecoder as JaxBPOSD
from tpugnn.baselines.osd import osd0_py as jax_osd0_py
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn.tanner.spacetime import build_spacetime_code as jax_spacetime
from tpugnn_torch.baselines import BPOSDDecoder, bp_decode, bp_posteriors, osd0_py
from tpugnn_torch.baselines.bp import _edge_to_slot
from tpugnn_torch.eval import ler_bp, ler_bp_osd
from tpugnn_torch.sampling import sample_batch
from tpugnn_torch.sampling.noise import syndrome
from tpugnn_torch.tanner import build_code, build_spacetime_code
from tpugnn_torch.utils import native

torch.set_num_threads(1)

GRAPHS = {"surface3": (lambda: build_code("surface", 3), lambda: jax_build_code("surface", 3)),
          "surface5": (lambda: build_code("surface", 5), lambda: jax_build_code("surface", 5)),
          "detector3": (lambda: build_spacetime_code("surface", 3, 3),
                        lambda: jax_spacetime("surface", 3, 3))}


def _syndromes(g, seed, bsz, p):
    """Syndromes of numpy-seeded errors: depolarizing, or single-sector on a
    detector graph."""
    rng = np.random.default_rng(seed)
    ex = (rng.random((bsz, g.n_qubits_pad)) < p).astype(np.float32) * g.qubit_mask
    ez = np.zeros_like(ex) if g.rate_scale is not None else \
        (rng.random((bsz, g.n_qubits_pad)) < p).astype(np.float32) * g.qubit_mask
    s = (ez @ np.asarray(g.h_syn_ez).T + ex @ np.asarray(g.h_syn_ex).T) % 2
    return s.astype(np.float32)


@pytest.mark.parametrize("alpha", [0.8, 1.0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bp_posteriors_match_jax(name, alpha):
    g, jg = (f() for f in GRAPHS[name])
    syn = _syndromes(g, 7, 128, 0.04)
    got = bp_posteriors(g.to("cpu"), torch.from_numpy(syn), 0.05, iters=32, alpha=alpha)
    ref = jax_bp_posteriors(jg, jnp.asarray(syn), 0.05, iters=32, alpha=alpha)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == (128, g.n_qubits_pad)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_edge_to_slot_inverts_the_check_table():
    g = build_code("surface", 5)
    inv = _edge_to_slot(g.to("cpu")).numpy()
    flat = g.ell_check_edge.reshape(-1)
    assert (flat[inv[:g.n_edges]] == np.arange(g.n_edges)).all()
    assert (g.ell_check_mask.reshape(-1)[inv[g.n_edges:]] == 0).all()


def test_bp_repetition_matches_bruteforce_ml():
    """The repetition code's Tanner graph is a chain, where min-sum with
    alpha=1 is exact: hard decisions equal the most likely error."""
    d = 5
    g = build_code("repetition", d)
    n, m = g.n_qubits, g.n_checks
    h = np.asarray(g.h_syn_ex)[:m, :n]
    errs = [np.zeros(n, np.uint8)]
    for k in (1, 2):
        for idx in itertools.combinations(range(n), k):
            e = np.zeros(n, np.uint8)
            e[list(idx)] = 1
            errs.append(e)
    all_e = np.array(list(itertools.product([0, 1], repeat=n)), np.uint8)
    all_s = all_e @ h.T % 2
    syn = np.zeros((len(errs), g.n_checks_pad), np.float32)
    syn[:, :m] = np.stack([e @ h.T % 2 for e in errs])
    ex_hat, _ = bp_decode(g.to("cpu"), torch.from_numpy(syn), 0.08, iters=16, alpha=1.0)
    for si, s in enumerate(syn[:, :m].astype(np.uint8)):
        match = np.all(all_s == s, axis=1)
        ml = all_e[match][np.argmin(all_e[match].sum(1))]
        np.testing.assert_array_equal(ex_hat[si, :n].numpy().astype(np.uint8), ml)


def test_bp_zero_syndrome_and_padding():
    g = build_code("toric", 3)
    dg = g.to("cpu")
    ex, ez = bp_decode(dg, torch.zeros((3, g.n_checks_pad)), 0.05)
    assert not ex.any() and not ez.any()
    b = sample_batch(torch.Generator().manual_seed(1), dg, 0.1, 64)
    ex, ez = bp_decode(dg, b.syndrome, 0.1, iters=8)
    assert not ex[:, g.n_qubits:].any() and not ez[:, g.n_qubits:].any()


@pytest.mark.parametrize("family,d", [("surface", 3), ("surface", 5), ("toric", 4)])
def test_bp_reproduces_syndrome_at_low_p(family, d):
    """tests/test_bp.py's check on its own shots (JAX's sampler, key 0)."""
    dg = build_code(family, d).to("cpu")
    syn = torch.from_numpy(np.array(
        jax_sample_batch(jax.random.PRNGKey(0), jax_build_code(family, d), 0.01, 512).syndrome))
    ex, ez = bp_decode(dg, syn, 0.01)
    agree = float((syndrome(dg, ex, ez) == syn).all(-1).float().mean())
    assert agree > 0.9, agree


def _osd_instance(rng, m, n, batch):
    h = (rng.random((m, n)) < 0.35).astype(np.uint8)
    h[0] |= 1
    e = (rng.random((batch, n)) < 0.15).astype(np.uint8)
    syn = (e @ h.T % 2).astype(np.uint8)
    llr = rng.standard_normal((batch, n)).astype(np.float32)
    return h, syn, llr


@pytest.mark.parametrize("m,n", [(6, 10), (12, 25), (24, 49)])
def test_osd_python_and_native_equal_jax(m, n):
    h, syn, llr = _osd_instance(np.random.default_rng(m), m, n, 32)
    want = jax_osd0_py(h, syn, llr)
    np.testing.assert_array_equal(osd0_py(h, syn, llr), want)
    got = np.zeros_like(want)
    native.load().osd0_decode_batch(h, m, n, syn, llr, syn.shape[0], got)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got @ h.T % 2, syn)


def test_bp_osd_equals_jax_on_2048_syndromes():
    g, jg = build_code("surface", 5), jax_build_code("surface", 5)
    syn = _syndromes(g, 11, 2048, 0.05)
    got = BPOSDDecoder(g, p=0.05, device="cpu").decode(syn)
    ref = JaxBPOSD(jg, p=0.05).decode(jnp.asarray(syn))
    same = np.ones(2048, bool)
    for a, b in zip(got, ref):
        same &= (a == np.asarray(b)).all(1)
    assert same.mean() >= 0.999, same.mean()
    n, m = g.n_qubits, g.n_checks
    s_hat = (got[1] @ np.asarray(g.h_syn_ez)[:m, :n].T
             + got[0] @ np.asarray(g.h_syn_ex)[:m, :n].T) % 2
    np.testing.assert_array_equal(s_hat, syn[:, :m])


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("family,d", [("surface", 3), ("toric", 4)])
def test_bp_osd_always_syndrome_consistent(family, d, force_python):
    g = build_code(family, d)
    b = sample_batch(torch.Generator().manual_seed(0), g.to("cpu"), 0.08, 128)
    ex, ez = BPOSDDecoder(g, p=0.08, iters=16, force_python=force_python,
                          device="cpu").decode(b.syndrome)
    n, m = g.n_qubits, g.n_checks
    s_hat = (ez @ np.asarray(g.h_syn_ez)[:m, :n].T + ex @ np.asarray(g.h_syn_ex)[:m, :n].T) % 2
    np.testing.assert_array_equal(s_hat, b.syndrome[:, :m].numpy())


def test_bp_osd_beats_plain_bp():
    g = build_code("surface", 5)
    kw = dict(p=0.03, shots=512, batch=256, iters=24, device="cpu")
    bp = ler_bp(g, generator=torch.Generator().manual_seed(2), **kw)
    osd = ler_bp_osd(g, generator=torch.Generator().manual_seed(2), **kw)
    assert osd["syn_mismatch_rate"] == 0.0 and bp["syn_mismatch_rate"] > 0.0
    assert osd["ler"] < bp["ler"]


def test_bp_and_bp_osd_on_a_detector_graph():
    g = build_spacetime_code("surface", 3, 3)
    kw = dict(p=0.02, shots=256, batch=128, device="cpu")
    bp = ler_bp(g, generator=torch.Generator().manual_seed(3), **kw)
    osd = ler_bp_osd(g, generator=torch.Generator().manual_seed(3), **kw)
    assert osd["syn_mismatch_rate"] == 0.0 and osd["shots"] == 256.0
    assert 0.0 <= osd["ler"] <= bp["ler"] + 0.05 and osd["ler"] < 0.3
    ex, ez = BPOSDDecoder(g, p=0.02, device="cpu").decode(
        torch.from_numpy(_syndromes(g, 4, 32, 0.02)))
    assert ex.shape == ez.shape == (32, g.n_qubits) and not ez.any()
