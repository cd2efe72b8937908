"""Failure counting, Monte-Carlo LER and the serve engine of the port.

count_failures and decode_corrections must equal tpugnn's exactly on the
same numpy shots and logits; the DecodeEngine must pad, microbatch and
answer like tpugnn's engine (cleanup=None) on the same parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import CodeConfig as JaxCodeConfig
from tpugnn.configs import ExperimentConfig as JaxExperimentConfig
from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.eval import ler as jler
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.serve.engine import DecodeEngine as JaxDecodeEngine
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig
from tpugnn_torch.eval import count_failures, decode_corrections, ler_monte_carlo
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import params_from_flax
from tpugnn_torch.sampling import SyndromeBatch
from tpugnn_torch.serve import DecodeEngine
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)


@pytest.mark.parametrize("width", [2, 4])
def test_decode_corrections_equal_tpugnn(width):
    logits = np.random.default_rng(width).standard_normal((6, 13, width)).astype(np.float32)
    got = decode_corrections(torch.from_numpy(logits))
    ref = jler.decode_corrections(jnp.asarray(logits))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("d", [3, 5])
def test_count_failures_equal_tpugnn(d):
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    b = jax_sample_batch(jax.random.PRNGKey(d), jg, 0.12, 8)
    rng = np.random.default_rng(d)
    # corrections: the true error on some shots (syndrome-consistent), noise on others
    ex_hat = np.where(rng.random((8, 1)) < 0.5, np.asarray(b.ex),
                      (rng.random(b.ex.shape) < 0.1) * np.asarray(jg.qubit_mask))
    ez_hat = np.where(rng.random((8, 1)) < 0.5, np.asarray(b.ez),
                      (rng.random(b.ez.shape) < 0.1) * np.asarray(jg.qubit_mask))
    ex_hat, ez_hat = ex_hat.astype(np.float32), ez_hat.astype(np.float32)
    logl = rng.standard_normal((8, 2)).astype(np.float32)
    ref = jler.count_failures(jg, b, jnp.asarray(ex_hat), jnp.asarray(ez_hat),
                              jnp.asarray(logl))
    tb = SyndromeBatch(*(torch.from_numpy(np.array(x)) for x in b))
    got = count_failures(tg, tb, torch.from_numpy(ex_hat), torch.from_numpy(ez_hat),
                         torch.from_numpy(logl))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def _small_pair(max_batch=8):
    jg = jax_build_code("surface", 3)
    kw = dict(hidden=16, msg_hidden=16, rounds=2, qubit_head="pauli4")
    jcfg = JaxExperimentConfig(code=JaxCodeConfig(distance=3),
                               model=JaxModelConfig(backend="fused", **kw))
    params = JaxGNNDecoder(jcfg.model, k=1).init(
        jax.random.PRNGKey(4), jg, jnp.zeros((2, jg.n_checks_pad)))
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=1)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    cfg = ExperimentConfig(code=CodeConfig(distance=3), model=ModelConfig(backend="fused", **kw))
    return jcfg, params, jg, DecodeEngine(cfg, tm, max_batch=max_batch, device="cpu")


def test_engine_matches_tpugnn_engine():
    jcfg, params, jg, eng = _small_pair()
    ref_eng = JaxDecodeEngine(jcfg, params, jg, max_batch=8, use_pallas=False)
    try:
        syn = np.asarray(jax_sample_batch(jax.random.PRNGKey(9), jg, 0.1, 19).syndrome)
        syn = syn.astype(np.uint8)
        np.testing.assert_array_equal(eng.decode(syn), ref_eng.decode(syn))
    finally:
        ref_eng.close()


def test_engine_padding_and_microbatches():
    _, _, jg, eng = _small_pair(max_batch=8)
    syn = np.asarray(jax_sample_batch(jax.random.PRNGKey(3), jg, 0.1, 20).syndrome)
    syn = syn.astype(np.uint8)
    full = eng.decode(syn)                        # 3 microbatches, last one padded
    assert full.shape == (20, jg.n_qubits, 2) and full.dtype == np.uint8
    np.testing.assert_array_equal(full[:1], eng.decode(syn[:1]))
    np.testing.assert_array_equal(full[8:16], eng.decode(syn[8:16]))
    # the real-check width pads to m_pad with zeros
    np.testing.assert_array_equal(full[3:7], eng.decode(syn[3:7, :jg.n_checks]))
    assert eng.decode(syn[:0]).shape == (0, jg.n_qubits, 2)
    with pytest.raises(ValueError, match="exceeds"):
        eng.decode(np.zeros((2, jg.n_checks_pad + 1)))


def test_ler_monte_carlo_on_cpu_is_seeded():
    _, _, jg, eng = _small_pair()
    g = build_code("surface", 3)
    run = lambda: ler_monte_carlo(eng.model, g, p=0.05, shots=40, batch=16,
                                  generator=torch.Generator().manual_seed(3),
                                  device="cpu")
    a, b = run(), run()
    assert a == b
    assert a["shots"] == 48.0
    for k in ("ler", "ler_stderr", "ler_logical", "ler_hybrid", "syn_mismatch_rate"):
        assert 0.0 <= a[k] <= 1.0, k
