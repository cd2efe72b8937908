"""``DecodeEngine(data_parallel=N)`` of the port on the CPU.

The counterpart of ``tests/test_serve.py:71-96``: N shares of every chunk
run on the CPU (JAX's virtual CPU devices there) and the decode equals the
single-device engine's bit for bit, and the JAX package's data-parallel
engine's on the same parameters; the constructor refuses more shares than
devices and a ``max_batch`` that N does not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import CodeConfig as JaxCodeConfig
from tpugnn.configs import ExperimentConfig as JaxExperimentConfig
from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.serve.engine import DecodeEngine as JaxDecodeEngine
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import params_from_flax
from tpugnn_torch.serve import DecodeEngine

torch.set_num_threads(1)

KW = dict(hidden=16, msg_hidden=16, rounds=2)


def _setup(backend, **extra):
    jg = jax_build_code("surface", 3)
    jcfg = JaxExperimentConfig(code=JaxCodeConfig(family="surface", distance=3),
                               model=JaxModelConfig(backend=backend, **KW, **extra))
    params = JaxGNNDecoder(jcfg.model, k=jg.k).init(
        jax.random.PRNGKey(2), jg, jnp.zeros((2, jg.n_checks_pad)))
    cfg = ExperimentConfig(code=CodeConfig(family="surface", distance=3),
                           model=ModelConfig(backend=backend, **KW, **extra))
    model = GNNDecoder(cfg.model, k=jg.k)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    syn = np.asarray(jax_sample_batch(jax.random.PRNGKey(7), jg, 0.08, 70).syndrome)
    return jcfg, params, jg, cfg, model, syn


@pytest.mark.parametrize("backend,cleanup,extra", [
    ("fused", None, {}), ("segment", None, {}),
    ("fused", "uf", {"qubit_head": "pauli4"}), ("fused", "device", {})])
def test_data_parallel_matches_single_device(backend, cleanup, extra, devices8):
    jcfg, params, jg, cfg, model, syn = _setup(backend, **extra)
    with DecodeEngine(cfg, model, max_batch=32, cleanup=cleanup, device="cpu") as single, \
            DecodeEngine(cfg, model, max_batch=32, cleanup=cleanup, device="cpu",
                         data_parallel=4) as dp:
        assert len(dp._replicas) == 4 and not single._replicas
        got, want = dp.decode(syn), single.decode(syn)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (70, jg.n_qubits, 2) and got.dtype == np.uint8
    ref_eng = JaxDecodeEngine(jcfg, params, jg, max_batch=32, use_pallas=False,
                              cleanup=cleanup, data_parallel=4)
    try:
        np.testing.assert_array_equal(got, ref_eng.decode(syn))
    finally:
        ref_eng.close()


def test_data_parallel_validates():
    _, _, _, cfg, model, _ = _setup("fused")
    with pytest.raises(ValueError, match="divide"):
        DecodeEngine(cfg, model, max_batch=10, data_parallel=4, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        DecodeEngine(cfg, model, max_batch=32, data_parallel=4096, device="cpu")
    # one share or none is the plain engine
    for n in (None, 0, 1):
        with DecodeEngine(cfg, model, max_batch=8, data_parallel=n, device="cpu") as eng:
            assert eng._replicas == []


def test_data_parallel_needs_the_cards(monkeypatch):
    """On a card, N shares need N cards; without one the engine asks for the
    CPU before anything else."""
    _, _, _, cfg, model, _ = _setup("fused")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(cfg, model, max_batch=32, data_parallel=2)
