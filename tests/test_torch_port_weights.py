"""The shipped weights file against the checkpoint it was exported from.

The npz must hold exactly the arrays of a fresh restore of
runs/v3_surface_d11/ema/40000 (restored from a temporary copy: the orbax
manager keeps at most three steps and must not touch the repository), and
the port's d=11, R=14 forward on them must match JAX's at atol 5e-4 /
rtol 1e-3 with identical hard corrections.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import CodeConfig, ExperimentConfig, ModelConfig
from tpugnn.eval.ler import count_failures as jax_count_failures
from tpugnn.eval.ler import decode_corrections as jax_decode_corrections
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn.train.checkpoint import CheckpointManager
from tpugnn.train.loop import init_state
from tpugnn_torch.eval import count_failures, decode_corrections
from tpugnn_torch.models.convert import (
    DEFAULT_WEIGHTS,
    flatten_tree,
    load_decoder,
    load_npz,
    read_meta,
)
from tpugnn_torch.sampling import SyndromeBatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "runs", "v3_surface_d11", "ema")


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    cfg = ExperimentConfig(
        code=CodeConfig(family="surface", distance=11),
        model=ModelConfig(hidden=128, msg_hidden=128, rounds=14, backend="fused",
                          qubit_head="pauli4"))
    graph = jax_build_code("surface", 11)
    copy = tmp_path_factory.mktemp("ckpt") / "ema"
    shutil.copytree(CKPT, copy)
    state, model = init_state(cfg, graph)
    mgr = CheckpointManager(str(copy))
    r = mgr.restore_latest(state)
    mgr.close()
    return cfg, graph, model, r


def test_npz_equals_fresh_restore(restored):
    _, _, _, r = restored
    cfg, got, step = load_npz(DEFAULT_WEIGHTS)
    assert step == int(r.step) == 40000
    want = flatten_tree(jax.tree.map(np.asarray, r.params))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_npz_config_and_size():
    cfg, flat, _ = load_npz(DEFAULT_WEIGHTS)
    m = cfg.model
    assert (cfg.code.family, cfg.code.distance) == ("surface", 11)
    assert (m.hidden, m.msg_hidden, m.rounds, m.qubit_head, m.dtype, m.backend) == \
        (128, 128, 14, "pauli4", "float32", "fused")
    assert os.path.getsize(DEFAULT_WEIGHTS) <= 2 * 1024 * 1024
    assert sum(v.size for v in flat.values()) == 267654


def test_npz_records_the_jax_f32_reference_ler():
    """chip_smoke.py holds the card's LER against this record: the JAX
    package's own f32 decode of these weights at p=0.05."""
    meta = read_meta(DEFAULT_WEIGHTS)
    assert meta["step"] == 40000
    ref = meta["ler_reference"]
    assert ref["p"] == 0.05 and ref["shots"] >= 100_000
    assert "float32" in ref["function"]
    # the p=0.05 logical-head rate of benchmarks/LER_TABLE.md:30 (0.00211)
    # within 4 pooled standard errors
    n, t = ref["shots"], 1_000_000
    pool = (ref["ler_logical"] * n + 0.00211 * t) / (n + t)
    se = (pool * (1 - pool) * (1 / n + 1 / t)) ** 0.5
    assert abs(ref["ler_logical"] - 0.00211) < 4 * se


def test_d11_forward_matches_jax(restored):
    jcfg, jg, jmodel, r = restored
    rng = np.random.default_rng(11)
    syn = (rng.random((4, jg.n_checks_pad)) < 0.1).astype(np.float32)
    syn *= np.asarray(jg.check_mask)
    ref = jmodel.apply(r.params, jg, jnp.asarray(syn))
    cfg, model, graph = load_decoder(device="cpu")
    with torch.no_grad():
        got = model(graph.to("cpu"), torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got.logical_logits.numpy(), np.asarray(ref.logical_logits),
                               atol=5e-4, rtol=1e-3)
    for a, b in zip(decode_corrections(got.qubit_logits),
                    jax_decode_corrections(ref.qubit_logits)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_d11_failures_equal_jax_on_shared_shots(restored):
    """Shot for shot, the port's decode of the trained weights fails where
    the JAX package's does (both heads, p=0.05, JAX-sampled shots)."""
    _, jg, jmodel, r = restored
    b = jax_sample_batch(jax.random.PRNGKey(777), jg, 0.05, 64)
    ref_out = jmodel.apply(r.params, jg, b.syndrome)
    ex, ez = jax_decode_corrections(ref_out.qubit_logits)
    ref = jax_count_failures(jg, b, ex, ez, ref_out.logical_logits)
    _, model, graph = load_decoder(device="cpu")
    dg = graph.to("cpu")
    tb = SyndromeBatch(*(torch.from_numpy(np.array(x)) for x in b))
    with torch.no_grad():
        out = model(dg, tb.syndrome)
    got = count_failures(dg, tb, *decode_corrections(out.qubit_logits),
                         out.logical_logits)
    assert 0 < float(np.sum(ref["fail_qubit"])) < 64
    for k in ("fail_qubit", "fail_logical", "fail_hybrid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
