"""The port's classical baselines against the JAX package's.

Union-find and MWPM corrections must equal tpugnn's bit for bit on the same
syndromes (surface d=3/5, toric d=3, weighted MWPM); the C++ library (built
by tpugnn_torch.utils.native into tpugnn_torch/_build/) must equal the
port's Python twins; the loader must raise, not fall back, when it cannot
build.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tpugnn.baselines import mwpm as jax_mwpm
from tpugnn.baselines import union_find as jax_uf
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.baselines import MWPMDecoder, MWPMSectorDecoder, UnionFindDecoder, uf_decode_py
from tpugnn_torch.baselines import mwpm as port_mwpm
from tpugnn_torch.baselines import union_find as port_uf
from tpugnn_torch.eval.baseline import ler_mwpm, ler_union_find
from tpugnn_torch.tanner import build_code
from tpugnn_torch.utils import native

torch.set_num_threads(1)

CODES = [("surface", 3), ("surface", 5), ("toric", 3)]


def _syndromes(family, d, p=0.08, batch=96, seed=0):
    jg = jax_build_code(family, d)
    syn = np.asarray(jax_sample_batch(jax.random.PRNGKey(seed + d), jg, p, batch).syndrome)
    return jg, build_code(family, d), syn.astype(np.uint8)


def _sector_mats(g):
    mx, m, n = g.n_checks_x, g.n_checks, g.n_qubits
    hx = np.asarray(g.h_syn_ez)[:mx, :n].astype(np.uint8)
    hz = np.asarray(g.h_syn_ex)[mx:m, :n].astype(np.uint8)
    return hx, hz


@pytest.mark.parametrize("family,d", CODES)
def test_sector_edges_and_geodesics_equal_tpugnn(family, d):
    jg, g, _ = _syndromes(family, d)
    for (a, b) in zip(_sector_mats(jg), _sector_mats(g)):
        je, pe = jax_uf._sector_edges(a), port_uf._sector_edges(b)
        for x, y in zip(je, pe):
            np.testing.assert_array_equal(x, y)
        w = np.linspace(0.5, 2.0, len(pe[0]))
        for x, y in zip(jax_mwpm._geodesics(*je, a.shape[0], w),
                        port_mwpm._geodesics(*pe, b.shape[0], w)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("family,d", CODES)
def test_union_find_equals_tpugnn(family, d):
    jg, g, syn = _syndromes(family, d)
    ref = jax_uf.UnionFindDecoder(jg).decode(syn)
    got = UnionFindDecoder(g).decode(syn)
    for a, b in zip(got, ref):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family,d", CODES)
def test_mwpm_equals_tpugnn(family, d):
    jg, g, syn = _syndromes(family, d, seed=1)
    ref = jax_mwpm.MWPMDecoder(jg, p=0.08).decode(syn)
    got = MWPMDecoder(g, p=0.08).decode(syn)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family,d", [("surface", 5), ("toric", 3)])
def test_weighted_mwpm_equals_tpugnn(family, d):
    """Per-edge weights (the log-likelihood weights of a noise model) reroute
    the geodesics; both packages match on them alike."""
    jg, g, syn = _syndromes(family, d, seed=2)
    _, hz = _sector_mats(g)
    eu, ev = port_uf._sector_edges(hz)
    w = np.random.default_rng(d).uniform(0.5, 3.0, len(eu))
    s = syn[:, g.n_checks_x:g.n_checks]
    ref = jax_mwpm.MWPMSectorDecoder(eu, ev, hz.shape[0], weights=w).decode(s)
    got = MWPMSectorDecoder(eu, ev, hz.shape[0], weights=w).decode(s)
    np.testing.assert_array_equal(got, ref)
    # the weights move the answer: unit weights give another correction
    assert not np.array_equal(got, MWPMSectorDecoder(eu, ev, hz.shape[0]).decode(s))


@pytest.mark.parametrize("family,d", [("surface", 3), ("toric", 3)])
def test_native_equals_python_twins(family, d):
    _, g, syn = _syndromes(family, d, p=0.1, batch=24, seed=3)
    for cls in (UnionFindDecoder, MWPMDecoder):
        fast = cls(g).decode(syn)
        twin = cls(g, force_python=True)
        assert twin._lib is None if cls is UnionFindDecoder else twin._x._lib is None
        for a, b in zip(fast, twin.decode(syn)):
            np.testing.assert_array_equal(a, b)


def test_uf_decode_py_simple_chain():
    eu = np.array([0, 0, 1], np.int32)
    ev = np.array([-1, 1, -1], np.int32)
    cor = uf_decode_py(eu, ev, 2, np.array([1, 0], np.uint8))
    assert (cor[0] ^ cor[1], cor[1] ^ cor[2]) == (1, 0)


def test_native_library_builds_into_the_port(tmp_path):
    lib = native.load()
    path = native.library_path(native._cxx())
    assert os.path.dirname(path).endswith(os.path.join("tpugnn_torch", "_build"))
    assert os.path.exists(path) and lib is native.load()
    assert lib.mwpm_match.restype is not None


def test_native_load_raises_without_a_compiler(monkeypatch):
    """No silent fallback: a build that cannot run raises."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="compiler"):
        native.load()
    with pytest.raises(RuntimeError, match="compiler"):
        UnionFindDecoder(build_code("surface", 3))


def test_native_load_raises_on_a_failed_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DNO_SUCH", "-Wbogus-x",
                                                                  "--no-such-flag"))
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


@pytest.mark.parametrize("ler_fn", [ler_union_find, ler_mwpm])
def test_baseline_ler_reproduces_syndromes(ler_fn):
    g = build_code("surface", 3)
    zero = ler_fn(g, p=0.0, shots=64, batch=64, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    assert zero["ler"] == 0.0
    ev = ler_fn(g, p=0.06, shots=600, batch=256, generator=torch.Generator().manual_seed(1),
                device="cpu")
    assert ev["syn_mismatch_rate"] == 0.0 and ev["shots"] == 768.0
    assert 0.0 < ev["ler"] < 0.5
    again = ler_fn(g, p=0.06, shots=600, batch=256,
                   generator=torch.Generator().manual_seed(1), device="cpu")
    assert again == ev
