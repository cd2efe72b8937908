"""The port's DecodeEngine cleanup modes against the JAX package's engine.

On the same converted parameters and syndromes, every cleanup mode ('uf',
'mwpm', 'best_of' with both cost rules and lazy, 'device' and
'best_of_device' with the same k_iters) answers as tpugnn's engine does,
bit for bit, across microbatches and with the wire packed or not.  Also:
the bit-packed wire format's round trip, the constructor's refusals, and
close() twice.
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
from tpugnn_torch.serve.engine import pack_rows, unpack_rows

torch.set_num_threads(1)

KW = dict(hidden=16, msg_hidden=16, rounds=2, qubit_head="pauli4", readout="both")


@pytest.fixture(scope="module")
def setup():
    """A d=5 decoder of each package on the same parameters, and 37
    syndromes (3 microbatches of 16, the last one padded)."""
    jg = jax_build_code("surface", 5)
    jcfg = JaxExperimentConfig(code=JaxCodeConfig(distance=5, p=0.05),
                               model=JaxModelConfig(backend="fused", **KW))
    params = JaxGNNDecoder(jcfg.model, k=1).init(
        jax.random.PRNGKey(4), jg, jnp.zeros((2, jg.n_checks_pad)))
    tm = GNNDecoder(ModelConfig(backend="fused", **KW), k=1)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    cfg = ExperimentConfig(code=CodeConfig(distance=5, p=0.05),
                           model=ModelConfig(backend="fused", **KW))
    syn = np.array(jax_sample_batch(jax.random.PRNGKey(9), jg, 0.06, 37).syndrome)
    return jcfg, params, jg, cfg, tm, syn[:, :jg.n_checks].astype(np.uint8)


MODES = [
    ("uf", {}), ("mwpm", {}), ("uf", {"cleanup_tau": 0.6}),
    ("best_of", {}), ("best_of", {"lazy": True}), ("best_of", {"select_cost": "nll"}),
    ("best_of", {"select_cost": "nll", "lazy": True}),
    ("device", {}), ("best_of_device", {}), ("best_of_device", {"select_cost": "nll"}),
    ("uf", {"wire_pack": False}), ("best_of_device", {"wire_pack": False}),
]


@pytest.mark.parametrize("mode,kw", MODES)
def test_engine_mode_equals_tpugnn(setup, mode, kw):
    jcfg, params, jg, cfg, tm, syn = setup
    ref_eng = JaxDecodeEngine(jcfg, params, jg, max_batch=16, use_pallas=False, cleanup=mode,
                              **kw)
    with DecodeEngine(cfg, tm, max_batch=16, cleanup=mode, device="cpu", **kw) as eng:
        got = eng.decode(syn)
        assert eng.timing["chunks"] == 3 and eng.timing["device_ms"] is None
    try:
        ref = ref_eng.decode(syn)
    finally:
        ref_eng.close()
    assert got.shape == (37, jg.n_qubits, 2) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    n, m = jg.n_qubits, jg.n_checks
    h_ex = np.asarray(jg.h_syn_ex)[:m, :n]
    h_ez = np.asarray(jg.h_syn_ez)[:m, :n]
    s_hat = (got[:, :, 0] @ h_ex.T + got[:, :, 1] @ h_ez.T) % 2
    np.testing.assert_array_equal(s_hat, syn)


def test_device_mode_calls_no_host_decoder(setup, monkeypatch):
    _, _, _, cfg, tm, syn = setup
    from tpugnn_torch.baselines import mwpm, union_find

    def refuse(*a, **k):
        raise AssertionError("a host decoder ran")

    with DecodeEngine(cfg, tm, max_batch=16, cleanup="device", device="cpu") as eng:
        monkeypatch.setattr(union_find.UnionFindDecoder, "decode", refuse)
        monkeypatch.setattr(mwpm.MWPMSectorDecoder, "decode", refuse)
        assert eng.decode(syn).shape == (37, 25, 2)


@pytest.mark.parametrize("rows", [1, 7, 8, 13, 241])
def test_wire_pack_round_trip(rows):
    bits = (np.random.default_rng(rows).random((5, rows, 2)) < 0.4).astype(np.uint8)
    packed = pack_rows(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(bits, axis=1))
    np.testing.assert_array_equal(np.unpackbits(packed.numpy(), axis=1, count=rows), bits)
    syn = bits[:, :, 0]
    back = unpack_rows(torch.from_numpy(np.packbits(syn, axis=1)), rows)
    np.testing.assert_array_equal(back.numpy(), syn)


def test_constructor_refusals(setup):
    _, _, _, cfg, tm, _ = setup
    with pytest.raises(ValueError, match="select_cost"):
        DecodeEngine(cfg, tm, max_batch=8, select_cost="foo", device="cpu")
    with pytest.raises(ValueError, match="best_of"):
        DecodeEngine(cfg, tm, max_batch=8, cleanup="uf", select_cost="nll", device="cpu")
    with pytest.raises(ValueError, match="cleanup"):
        DecodeEngine(cfg, tm, max_batch=8, cleanup="bp", device="cpu")


def test_close_twice_and_context_manager(setup):
    _, _, _, cfg, tm, _ = setup
    with DecodeEngine(cfg, tm, max_batch=16, cleanup="uf", device="cpu") as eng:
        assert eng.decode(np.zeros((2, 24))).shape == (2, 25, 2)
    eng.close()          # a second close is a no-op
    with pytest.raises(RuntimeError, match="closed"):
        eng.decode(np.zeros((2, 24)))


def test_nll_temperature_is_read_at_init(setup, monkeypatch):
    _, _, _, cfg, tm, syn = setup
    monkeypatch.setenv("TPUGNN_NLL_TEMP", "3.0")
    hot = DecodeEngine(cfg, tm, max_batch=16, cleanup="best_of_device", select_cost="nll",
                       device="cpu")
    monkeypatch.setenv("TPUGNN_NLL_TEMP", "1.0")
    with hot, DecodeEngine(cfg, tm, max_batch=16, cleanup="best_of_device",
                           select_cost="nll", device="cpu") as cold:
        assert hot._nll_temp == 3.0 and cold._nll_temp == 1.0
        a, b = hot.decode(syn), cold.decode(syn)
        assert a.shape == b.shape
