"""Syndrome sampling of the port against tpugnn.sampling.noise.

The two packages draw different random numbers, so the parity checks feed
both the same NumPy errors (exact equality); the torch sampler is checked for
its rates (within binomial error) and for s = H e mod 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.sampling import noise as jnoise
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.sampling import logical_class_bits, sample_batch, syndrome
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)


def _errors(g, batch, p, seed):
    rng = np.random.default_rng(seed)
    u = rng.random((batch, g.n_qubits_pad))
    qm = np.asarray(g.qubit_mask)
    ex = (u < 2 * p / 3).astype(np.float32) * qm
    ez = ((u >= p / 3) & (u < p)).astype(np.float32) * qm
    return ex, ez


@pytest.mark.parametrize("d", [3, 5])
def test_syndrome_and_class_bits_equal_tpugnn(d):
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    ex, ez = _errors(jg, 8, 0.15, seed=d)
    s_ref = np.asarray(jnoise.syndrome(jg, jnp.asarray(ex), jnp.asarray(ez)))
    s = syndrome(tg, torch.from_numpy(ex), torch.from_numpy(ez)).numpy()
    np.testing.assert_array_equal(s, s_ref)
    b_ref = np.asarray(jnoise.logical_class_bits(
        jg, jnp.asarray(ex), jnp.asarray(ez), jnp.asarray(s_ref)))
    b = logical_class_bits(tg, torch.from_numpy(ex), torch.from_numpy(ez),
                           torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(b, b_ref)


def test_sampler_rates_within_binomial_error():
    g = build_code("surface", 5).to("cpu")
    p, batch = 0.3, 2000
    b = sample_batch(torch.Generator().manual_seed(0), g, p, batch)
    qm = g.qubit_mask.bool()
    ex, ez = b.ex[:, qm], b.ez[:, qm]
    n = ex.numel()
    for name, frac in (("X", ((ex == 1) & (ez == 0)).float().mean()),
                       ("Y", ((ex == 1) & (ez == 1)).float().mean()),
                       ("Z", ((ex == 0) & (ez == 1)).float().mean())):
        se = (p / 3 * (1 - p / 3) / n) ** 0.5
        assert abs(float(frac) - p / 3) < 5 * se, (name, float(frac))
    # padded qubits never err; syndromes and class bits are those of the errors
    assert not b.ex[:, ~qm].any() and not b.ez[:, ~qm].any()
    torch.testing.assert_close(b.syndrome, syndrome(g, b.ex, b.ez), rtol=0, atol=0)
    torch.testing.assert_close(
        b.class_bits, logical_class_bits(g, b.ex, b.ez, b.syndrome), rtol=0, atol=0)


def test_sampler_is_seeded():
    g = build_code("surface", 3).to("cpu")
    a = sample_batch(torch.Generator().manual_seed(5), g, 0.1, 16)
    b = sample_batch(torch.Generator().manual_seed(5), g, 0.1, 16)
    torch.testing.assert_close(a.ex, b.ex, rtol=0, atol=0)
    torch.testing.assert_close(a.ez, b.ez, rtol=0, atol=0)
