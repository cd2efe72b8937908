"""The port's GNNDecoder forward against tpugnn's GNNDecoder(backend='fused').

Same flax parameters (converted with params_from_flax), same syndromes from
numpy, f32.  Tolerance atol 5e-4 / rtol 1e-3 on the logits (the bound of
tests/kernels/test_fused_decoder.py), and identical hard corrections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.eval.ler import decode_corrections as jax_decode_corrections
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.eval import decode_corrections
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import params_from_flax
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

ATOL, RTOL = 5e-4, 1e-3


def _pair(d, head, readout="both", rounds=3, h=32):
    jg = jax_build_code("surface", d)
    kw = dict(hidden=h, msg_hidden=h, rounds=rounds, qubit_head=head, readout=readout)
    jm = JaxGNNDecoder(JaxModelConfig(backend="fused", **kw), k=jg.k)
    rng = np.random.default_rng(d)
    syn = (rng.random((4, jg.n_checks_pad)) < 0.25).astype(np.float32)
    syn *= np.asarray(jg.check_mask)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(syn))
    # non-zero biases and LayerNorm offsets, so every term is exercised
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, jm, params, tm, syn


@pytest.mark.parametrize("d,head", [(3, "bits"), (3, "pauli4"), (5, "bits"), (5, "pauli4")])
def test_forward_matches_tpugnn_fused(d, head):
    jg, jm, params, tm, syn = _pair(d, head)
    ref = jm.apply(params, jg, jnp.asarray(syn))
    with torch.no_grad():
        got = tm(build_code("surface", d).to("cpu"), torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.logical_logits.numpy(), np.asarray(ref.logical_logits),
                               atol=ATOL, rtol=RTOL)
    for a, b in zip(decode_corrections(got.qubit_logits),
                    jax_decode_corrections(ref.qubit_logits)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.logical_logits.numpy() > 0,
                                  np.asarray(ref.logical_logits) > 0)


@pytest.mark.parametrize("readout", ["per_qubit", "logical"])
def test_single_readout_matches_tpugnn(readout):
    jg, jm, params, tm, syn = _pair(3, "bits", readout=readout, rounds=2)
    ref = jm.apply(params, jg, jnp.asarray(syn))
    with torch.no_grad():
        got = tm(build_code("surface", 3).to("cpu"), torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=ATOL, rtol=RTOL)
    assert (got.logical_logits is None) == (ref.logical_logits is None)
    if readout == "logical":
        np.testing.assert_allclose(got.logical_logits.numpy(),
                                   np.asarray(ref.logical_logits), atol=ATOL, rtol=RTOL)


def test_state_dict_keys_are_the_flax_tree():
    jg, _, params, tm, _ = _pair(3, "pauli4", rounds=1)
    flat = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(flat) == set(tm.state_dict())
    assert "rounds.update_check_d0.kernel" in flat


@pytest.mark.parametrize("bad", [dict(backend="nope"), dict(backend="fused", update="gru"),
                                 dict(backend="fused", aggr="max"), dict(qubit_head="x")])
def test_unsupported_config_raises(bad):
    with pytest.raises(ValueError):
        GNNDecoder(ModelConfig(hidden=8, msg_hidden=8, **bad), k=1)
