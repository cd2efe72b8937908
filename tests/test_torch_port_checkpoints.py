"""The six surface-code weights files beside the d=11 flagship's, against the
checkpoints they were exported from.

Each npz in tpugnn_torch/assets/ (scripts/export_torch_weights.py) must hold
exactly the arrays of a fresh restore of its checkpoint (restored from a
temporary copy: the orbax manager must not touch the repository), carry the
config and step of the benchmarks/LER_TABLE.md row it stands for, record the
JAX package's own f32 LER at p=0.05, and give the port's CPU forward JAX's
logits (atol 5e-4 / rtol 1e-3, as tests/test_torch_port_weights.py holds
d=11's) and identical hard corrections on shared syndromes.  The d=11 file
has its own tests there.
"""

import functools
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import CodeConfig, ExperimentConfig, ModelConfig
from tpugnn.eval.ler import decode_corrections as jax_decode_corrections
from tpugnn.tanner import build_code as jax_build_code
from tpugnn.train.checkpoint import CheckpointManager
from tpugnn.train.loop import init_state
from tpugnn_torch.eval import decode_corrections
from tpugnn_torch.models.convert import flatten_tree, load_decoder, load_npz, read_meta

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tpugnn_torch", "assets")

# (weights file, checkpoint directory, d, H = MH, R, step): the p=0.05 rows
# of benchmarks/LER_TABLE.md (:10, :14, :18, :22, :34, :37) and the configs
# their runs were trained and tabled with (scripts/tpu_queue_r1b.sh:26-29,
# tpu_queue_r4a.sh:89, tpu_queue_r4f.sh:50; pauli4 heads)
CHECKPOINTS = [
    ("surface_d3_h64_r8_4000.npz", "runs/v2_surface_d3", 3, 64, 8, 4000),
    ("surface_d5_h96_r8_4000.npz", "runs/v2_surface_d5", 5, 96, 8, 4000),
    ("surface_d7_h128_r10_8000.npz", "runs/v3_surface_d7", 7, 128, 10, 8000),
    ("surface_d9_h128_r12_8000.npz", "runs/v3_surface_d9", 9, 128, 12, 8000),
    ("surface_d13_h128_r14_ema8000.npz", "runs/v3_surface_d13/ema", 13, 128, 14, 8000),
    ("surface_d15_h128_r14_ema8000.npz", "runs/v3_surface_d15/ema", 15, 128, 14, 8000),
]
IDS = [f"d{c[2]}" for c in CHECKPOINTS]


@functools.lru_cache(maxsize=None)
def _restored(ckpt: str, d: int, h: int, rounds: int):
    """(JAX graph, model, restored state) of a checkpoint directory, restored
    from a temporary copy."""
    cfg = ExperimentConfig(
        code=CodeConfig(family="surface", distance=d),
        model=ModelConfig(hidden=h, msg_hidden=h, rounds=rounds, backend="fused",
                          qubit_head="pauli4"))
    graph = jax_build_code("surface", d)
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "ckpt")
        shutil.copytree(os.path.join(REPO, ckpt), copy)
        state, model = init_state(cfg, graph)
        mgr = CheckpointManager(copy)
        r = mgr.restore_latest(state)
        mgr.close()
    return graph, model, r


@pytest.mark.parametrize("case", CHECKPOINTS, ids=IDS)
def test_npz_equals_fresh_restore(case):
    fname, ckpt, d, h, rounds, step = case
    _, _, r = _restored(ckpt, d, h, rounds)
    _, got, got_step = load_npz(os.path.join(ASSETS, fname))
    assert got_step == int(r.step) == step
    want = flatten_tree(jax.tree.map(np.asarray, r.params))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", CHECKPOINTS, ids=IDS)
def test_npz_config_matches_the_table(case):
    fname, ckpt, d, h, rounds, step = case
    path = os.path.join(ASSETS, fname)
    cfg, _, got_step = load_npz(path)
    m = cfg.model
    assert (cfg.code.family, cfg.code.distance, got_step) == ("surface", d, step)
    assert (m.hidden, m.msg_hidden, m.rounds, m.qubit_head, m.dtype, m.backend) == \
        (h, h, rounds, "pauli4", "float32", "fused")
    assert read_meta(path)["source"] == ckpt
    assert os.path.getsize(path) <= 2 * 1024 * 1024


@pytest.mark.parametrize("case", CHECKPOINTS, ids=IDS)
def test_npz_records_the_jax_f32_reference_ler(case):
    """chip_smoke.py's checkpoints phase holds the card's LER against this
    record: the JAX package's own f32 decode at p=0.05, with its seed."""
    ref = read_meta(os.path.join(ASSETS, case[0]))["ler_reference"]
    assert ref["p"] == 0.05 and ref["shots"] >= 65536 and isinstance(ref["seed"], int)
    assert "float32" in ref["function"]
    for k in ("ler", "ler_logical", "ler_hybrid"):
        assert 0.0 < ref[k] < 1.0, k


@pytest.mark.parametrize("case", CHECKPOINTS, ids=IDS)
def test_forward_matches_jax(case):
    fname, ckpt, d, h, rounds, _ = case
    jg, jmodel, r = _restored(ckpt, d, h, rounds)
    batch = 2 if d >= 13 else 4
    rng = np.random.default_rng(d)
    syn = (rng.random((batch, jg.n_checks_pad)) < 0.1).astype(np.float32)
    syn *= np.asarray(jg.check_mask)
    ref = jmodel.apply(r.params, jg, jnp.asarray(syn))
    _, model, graph = load_decoder(os.path.join(ASSETS, fname), device="cpu")
    with torch.no_grad():
        got = model(graph.to("cpu"), torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got.logical_logits.numpy(), np.asarray(ref.logical_logits),
                               atol=5e-4, rtol=1e-3)
    for a, b in zip(decode_corrections(got.qubit_logits),
                    jax_decode_corrections(ref.qubit_logits)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
