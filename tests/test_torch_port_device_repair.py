"""The port's on-device residual repair against the JAX package's.

DeviceRepair.repair must equal tpugnn's bit for bit on the same residual
syndromes (random syndromes and sparse GNN-like residuals, several k_iters),
reproduce every input syndrome, and map zero syndromes to zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.baselines.device_repair import DeviceRepair as JaxDeviceRepair
from tpugnn.baselines.device_repair import _sector_tables as jax_sector_tables
from tpugnn.baselines.union_find import _sector_edges as jax_sector_edges
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.baselines.device_repair import DeviceRepair, _sector_tables
from tpugnn_torch.baselines.mwpm import MWPMDecoder
from tpugnn_torch.sampling.noise import syndrome
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

CODES = [("surface", 3), ("surface", 5), ("toric", 3), ("toric", 5), ("repetition", 5)]


def _pair(family, d, p, batch, seed, k_iters=8):
    jg = jax_build_code(family, d)
    syn = np.array(jax_sample_batch(jax.random.PRNGKey(seed), jg, p, batch).syndrome)
    return (JaxDeviceRepair(jg, k_iters=k_iters),
            DeviceRepair(build_code(family, d), k_iters=k_iters, device="cpu"), syn)


@pytest.mark.parametrize("family,d", CODES)
def test_repair_equals_tpugnn(family, d):
    jr, tr, syn = _pair(family, d, 0.1, 128, d)
    ref = jax.jit(jr.repair)(jnp.asarray(syn))
    got = tr.repair(torch.from_numpy(syn))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k_iters", [0, 1, 3])
def test_repair_equals_tpugnn_few_rounds(k_iters):
    """Fewer greedy rounds leave more defects to the root fallback."""
    jr, tr, syn = _pair("surface", 5, 0.12, 64, 40 + k_iters, k_iters)
    ref = jax.jit(jr.repair)(jnp.asarray(syn))
    got = tr.repair(torch.from_numpy(syn))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_repair_equals_tpugnn_on_sparse_residuals():
    """GNN-like residuals: 0-4 defects per sector, where the exact small-set
    resolver decides."""
    jr, tr, syn = _pair("surface", 5, 0.02, 256, 7)
    ref = jax.jit(jr.repair)(jnp.asarray(syn))
    got = tr.repair(torch.from_numpy(syn))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("family,d", [("surface", 5), ("toric", 3)])
def test_sector_tables_equal_tpugnn(family, d):
    g = build_code(family, d)
    mx, m, n = g.n_checks_x, g.n_checks, g.n_qubits
    hz = np.asarray(g.h_syn_ex)[mx:m, :n].astype(np.uint8)
    eu, ev = jax_sector_edges(hz)
    for a, b in zip(_sector_tables(eu, ev, hz.shape[0], n),
                    jax_sector_tables(eu, ev, hz.shape[0], n)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("family,d", CODES)
def test_repair_is_valid(family, d):
    g = build_code(family, d)
    tr = DeviceRepair(g, device="cpu")
    s = (np.random.default_rng(d).random((64, g.n_checks_pad)) < 0.3).astype(np.float32)
    s[:, g.n_checks:] = 0
    if family == "toric":     # a closed sector has even defect parity
        for lo, hi in ((0, g.n_checks_x), (g.n_checks_x, g.n_checks)):
            odd = s[:, lo:hi].sum(1) % 2 == 1
            s[odd, lo] = 1 - s[odd, lo]
    st = torch.from_numpy(s)
    ex, ez = tr.repair(st)
    assert ex.shape == (64, g.n_qubits_pad)
    assert not ex[:, g.n_qubits:].any() and not ez[:, g.n_qubits:].any()
    np.testing.assert_array_equal(syndrome(g.to("cpu"), ex, ez).numpy()[:, :g.n_checks],
                                  s[:, :g.n_checks])


def test_repair_zero_syndrome_is_identity():
    g = build_code("surface", 5)
    ex, ez = DeviceRepair(g, device="cpu").repair(torch.zeros((8, g.n_checks_pad)))
    assert float(ex.sum() + ez.sum()) == 0.0


def test_exact_small_sets_match_mwpm_weight():
    """At most 4 defects in a sector: the resolver's weight is the exact
    matcher's."""
    g = build_code("surface", 5)
    jg = jax_build_code("surface", 5)
    syn = np.array(jax_sample_batch(jax.random.PRNGKey(11), jg, 0.04, 256).syndrome)
    ex_d, ez_d = DeviceRepair(g, device="cpu").repair(torch.from_numpy(syn))
    ex_m, ez_m = MWPMDecoder(g, p=0.04).decode(syn.astype(np.uint8))
    n, mx, s = g.n_qubits, g.n_checks_x, syn[:, :g.n_checks]
    few_x, few_z = s[:, mx:].sum(1) <= 4, s[:, :mx].sum(1) <= 4
    np.testing.assert_array_equal(ex_d.numpy()[:, :n].sum(1)[few_x], ex_m.sum(1)[few_x])
    np.testing.assert_array_equal(ez_d.numpy()[:, :n].sum(1)[few_z], ez_m.sum(1)[few_z])


def test_repair_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceRepair(build_code("surface", 3))
