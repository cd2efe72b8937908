"""The port's detector-graph path against the JAX package's.

* Spacetime graphs: ``spacetime_matrix`` and every array of
  ``build_spacetime_code`` (ELL tables, masks, ``logicals``, ``rate_scale``,
  pure-error tables) bit-equal for surface d=3/t=3 and d=5/t=5 and toric
  d=3/t=2 in both sectors.
* Sampling: on given faults the syndromes and class bits are equal exactly;
  the single-sector draw is ``ex = u < p * rate_scale`` on the generator's
  uniforms, ``ez = 0``.
* The two detector weights files: bit-equal to a fresh restore of their
  checkpoints, loaded onto the detector graph their record names, and the
  port's CPU forward gives JAX's logits (atol 5e-4 / rtol 1e-3, as
  tests/test_torch_port_checkpoints.py holds the code-graph files) and the
  same hard corrections; their sidecars carry the JAX f32 references.
* The classical decoders on a graph with an empty X sector: union-find,
  MWPM and the device repair bit-equal to JAX on the same syndromes.
* The slice end to end: on a random H=32, R=3 model the GNN+UF and
  GNN+MWPM corrections equal JAX's on every shot whose logits are all at
  least 1e-4 from 0; the trained weights run ``ler_all_columns`` on the
  detector graph with its plain columns equal to ``ler_monte_carlo``'s and
  no cleanup syndrome left.
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

from tpugnn.baselines import MWPMDecoder as JaxMWPM
from tpugnn.baselines import UnionFindDecoder as JaxUF
from tpugnn.baselines.device_repair import DeviceRepair as JaxDeviceRepair
from tpugnn.configs import CodeConfig as JaxCodeConfig
from tpugnn.configs import ExperimentConfig as JaxExperimentConfig
from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.eval import hybrid as jh
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.sampling.noise import logical_class_bits as jax_class_bits
from tpugnn.sampling.noise import syndrome as jax_syndrome
from tpugnn.tanner.spacetime import build_spacetime_code as jax_spacetime
from tpugnn.tanner.spacetime import spacetime_matrix as jax_spacetime_matrix
from tpugnn.train.checkpoint import CheckpointManager
from tpugnn.train.loop import init_state
from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder
from tpugnn_torch.baselines.device_repair import DeviceRepair
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.eval import decode_corrections, ler_monte_carlo
from tpugnn_torch.eval import hybrid as th
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import (
    DETECTOR_D5_WEIGHTS,
    STREAM_D5_WEIGHTS,
    flatten_tree,
    load_decoder,
    load_npz,
    params_from_flax,
    read_columns,
    read_meta,
)
from tpugnn_torch.sampling.noise import logical_class_bits, sample_depolarizing, syndrome
from tpugnn_torch.tanner import build_spacetime_code, spacetime_matrix
from tpugnn_torch.tanner.surface import surface_code_checks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = [("surface", 3, 3), ("surface", 5, 5), ("toric", 3, 2)]
# (weights file, checkpoint directory, step): benchmarks/LER_DETECTOR.md:40-42
# and the streaming row of runs/stream_quality_w.json (d=5, window 5)
# (weights file, checkpoint, step, round-0 fault boost it was trained with)
DETECTOR_FILES = [(DETECTOR_D5_WEIGHTS, "runs/spacetime_surface_d5_t5", 4000, 1.0),
                  (STREAM_D5_WEIGHTS, "runs/spacetime_surface_d5_t5_w", 4000, 2.0)]
FILE_IDS = ["monolithic", "window"]


@pytest.mark.parametrize("d_t", [1, 2, 4])
def test_spacetime_matrix_equal(d_t):
    h = surface_code_checks(3)[1]
    np.testing.assert_array_equal(spacetime_matrix(h, d_t), jax_spacetime_matrix(h, d_t))


@pytest.mark.parametrize("sector", ["z", "x"])
@pytest.mark.parametrize("case", GRAPHS, ids=[f"{f}{d}_t{t}" for f, d, t in GRAPHS])
def test_spacetime_graph_bit_equal(case, sector):
    family, d, d_t = case
    kw = dict(sector=sector, meas_ratio=0.5, t0_scale=2.0)
    got = build_spacetime_code(family, d, d_t, **kw)
    ref = jax_spacetime(family, d, d_t, **kw)
    for f in ("name", "n_checks", "n_qubits", "n_edges", "n_checks_x", "n_checks_pad",
              "n_qubits_pad", "n_edges_pad", "k", "deg_max_check", "deg_max_qubit"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in got.array_fields():
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert got.n_checks_x == 0 and got.rate_scale is not None


def test_spacetime_refusals():
    with pytest.raises(ValueError, match="sector"):
        build_spacetime_code("surface", 3, 3, sector="y")
    with pytest.raises(ValueError, match="d_t"):
        spacetime_matrix(surface_code_checks(3)[1], 0)
    with pytest.raises(ValueError, match="unported"):
        build_spacetime_code("hexagonal", 3, 3)


@pytest.mark.parametrize("case", GRAPHS[:2], ids=["d3", "d5"])
def test_syndrome_and_class_bits_on_given_faults(case):
    family, d, d_t = case
    g = build_spacetime_code(family, d, d_t)
    jg = jax_spacetime(family, d, d_t)
    rng = np.random.default_rng(d)
    ex = (rng.random((64, g.n_qubits_pad)) < 0.1).astype(np.float32) * g.qubit_mask
    ez = np.zeros_like(ex)
    dg = g.to("cpu")
    s = syndrome(dg, torch.from_numpy(ex), torch.from_numpy(ez))
    bits = logical_class_bits(dg, torch.from_numpy(ex), torch.from_numpy(ez), s)
    js = jax_syndrome(jg, jnp.asarray(ex), jnp.asarray(ez))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jax_class_bits(jg, jnp.asarray(ex), jnp.asarray(ez), js)))
    assert bits.shape == (64, 2 * g.k) and not bits[:, g.k:].any()   # no ez faults
    assert 0 < float(bits[:, :g.k].mean()) < 1


def test_single_sector_sampling_draws_rate_scaled_bit_flips():
    g = build_spacetime_code("surface", 3, 3, meas_ratio=0.5, t0_scale=2.0)
    dg = g.to("cpu")
    ex, ez = sample_depolarizing(torch.Generator().manual_seed(3), dg, 0.2, 4096)
    u = torch.rand((4096, g.n_qubits_pad), generator=torch.Generator().manual_seed(3))
    want = (u < 0.2 * dg.rate_scale).float() * dg.qubit_mask
    assert torch.equal(ex, want) and not ez.any()
    assert not ex[:, g.n_qubits:].any()
    m, n = surface_code_checks(3)[1].shape
    rates = ex.mean(0)
    assert abs(float(rates[:n].mean()) - 0.4) < 0.02          # round 0 at t0_scale
    assert abs(float(rates[n:3 * n].mean()) - 0.2) < 0.02     # data faults at p
    assert abs(float(rates[3 * n:g.n_qubits].mean()) - 0.1) < 0.02   # measurements


@functools.lru_cache(maxsize=None)
def _restored(ckpt: str):
    """(JAX detector graph, model, restored state) of a d=5, t=5 detector
    checkpoint (H=96, R=8, bits head), restored from a temporary copy."""
    cfg = JaxExperimentConfig(code=JaxCodeConfig(family="surface", distance=5),
                              model=JaxModelConfig(hidden=96, msg_hidden=96, rounds=8,
                                                   backend="fused", qubit_head="bits"))
    graph = jax_spacetime("surface", 5, 5)
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "ckpt")
        shutil.copytree(os.path.join(REPO, ckpt), copy, ignore=shutil.ignore_patterns("ema"))
        state, model = init_state(cfg, graph)
        mgr = CheckpointManager(copy)
        r = mgr.restore_latest(state)
        mgr.close()
    return graph, model, r


@pytest.mark.parametrize("case", DETECTOR_FILES, ids=FILE_IDS)
def test_detector_npz_equals_fresh_restore_and_names_its_graph(case):
    path, ckpt, step, t0_scale = case
    _, _, r = _restored(ckpt)
    cfg, got, got_step = load_npz(path)
    assert got_step == int(r.step) == step
    want = flatten_tree(jax.tree.map(np.asarray, r.params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    meta = read_meta(path)
    assert meta["source"] == ckpt
    assert meta["graph"] == {"kind": "spacetime", "d_t": 5, "sector": "z", "meas_ratio": 1.0,
                             "t0_scale": t0_scale}
    m = cfg.model
    assert (m.hidden, m.msg_hidden, m.rounds, m.qubit_head, m.dtype) == \
        (96, 96, 8, "bits", "float32")
    assert os.path.getsize(path) <= 1024 * 1024


@pytest.mark.parametrize("case", DETECTOR_FILES, ids=FILE_IDS)
def test_detector_forward_matches_jax(case):
    path, ckpt, _, t0_scale = case
    jg, jmodel, r = _restored(ckpt)
    _, model, graph = load_decoder(path, device="cpu")
    assert graph.name == jg.name == "surface_d5_t5_z"
    # the noise rates the weights were trained on
    np.testing.assert_array_equal(
        graph.rate_scale, np.asarray(jax_spacetime("surface", 5, 5, t0_scale=t0_scale).rate_scale))
    assert (graph.n_checks_pad, graph.n_qubits_pad, graph.deg_max_check,
            graph.deg_max_qubit) == (64, 176, 6, 2)
    rng = np.random.default_rng(5)
    syn = (rng.random((4, jg.n_checks_pad)) < 0.1).astype(np.float32) * graph.check_mask
    ref = jmodel.apply(r.params, jg, jnp.asarray(syn))
    with torch.no_grad():
        got = model(graph.to("cpu"), torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got.logical_logits.numpy(), np.asarray(ref.logical_logits),
                               atol=5e-4, rtol=1e-3)
    # the bits head's hard corrections, where a logit is not within 1e-3 of 0
    ref_l = np.asarray(ref.qubit_logits)
    sure = np.abs(ref_l) > 1e-3
    assert sure.mean() > 0.99
    np.testing.assert_array_equal((got.qubit_logits.numpy() > 0)[sure], (ref_l > 0)[sure])
    ex, ez = decode_corrections(got.qubit_logits)
    np.testing.assert_array_equal(ex.numpy(), (got.qubit_logits[..., 0] > 0).float().numpy())


def test_detector_sidecars_hold_the_jax_references():
    """What chip_smoke.py's detector_and_stream phase gates against: the
    JAX f32 columns of the monolithic decoder at p=0.02 and the JAX f32
    stream rates of the window decoder's five adapters, each of its weights."""
    for path in (DETECTOR_D5_WEIGHTS, STREAM_D5_WEIGHTS):
        side, meta = read_columns(path), read_meta(path)
        for k in ("step", "source", "code", "model", "graph"):
            assert side[k] == meta[k], (path, k)
    cols = read_columns(DETECTOR_D5_WEIGHTS)
    assert cols["p"] == 0.02 and cols["shots"] >= 131072
    assert set(cols["columns"]) == {"ler", "ler_logical", "ler_hybrid", "gnn_uf", "gnn_mwpm",
                                    "gnn_best_of", "uf", "mwpm"}
    stream = read_columns(STREAM_D5_WEIGHTS)["stream"]
    assert (stream["p"], stream["window"], stream["commit"], stream["rounds"], stream["seed"],
            stream["batch"], stream["shots"]) == (0.02, 5, 1, 11, 11, 256, 10000)
    assert set(stream["rates"]) == {"gnn_stream", "gnn_uf_stream", "gnn_dev_stream",
                                    "uf_stream", "uf_monolithic"}


def _syndromes(g, seed, bsz=128, p=0.03):
    rng = np.random.default_rng(seed)
    ex = (rng.random((bsz, g.n_qubits_pad)) < p).astype(np.float32) * g.qubit_mask
    s = (ex @ np.asarray(g.h_syn_ex).T) % 2
    return s.astype(np.uint8)


@pytest.mark.parametrize("case", GRAPHS, ids=[f"{f}{d}_t{t}" for f, d, t in GRAPHS])
def test_classical_decoders_equal_on_a_single_sector_graph(case):
    family, d, d_t = case
    g = build_spacetime_code(family, d, d_t)
    jg = jax_spacetime(family, d, d_t)
    syn = _syndromes(g, d + d_t)
    for got_dec, ref_dec in ((UnionFindDecoder(g), JaxUF(jg)),
                             (MWPMDecoder(g, p=0.03), JaxMWPM(jg, p=0.03))):
        got, ref = got_dec.decode(syn), ref_dec.decode(syn)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert not got[1].any()                      # the empty X sector
    dr = DeviceRepair(g, device="cpu")
    got = dr.repair(torch.from_numpy(syn.astype(np.float32)))
    ref = JaxDeviceRepair(jg).repair(jnp.asarray(syn, jnp.float32))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the repair reproduces every syndrome
    s = (got[0].numpy() @ np.asarray(g.h_syn_ex).T) % 2
    np.testing.assert_array_equal(s, syn)


@pytest.fixture(scope="module")
def random_pair():
    """A detector decoder (surface d=3, t=3, H=32, R=3, bits head) of each
    package on the same converted parameters."""
    jg = jax_spacetime("surface", 3, 3)
    kw = dict(hidden=32, msg_hidden=32, rounds=3, qubit_head="bits", readout="both")
    jm = JaxGNNDecoder(JaxModelConfig(backend="fused", **kw), k=jg.k)
    params = jm.init(jax.random.PRNGKey(3), jg, jnp.zeros((2, jg.n_checks_pad)))
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, build_spacetime_code("surface", 3, 3), jm, params, tm.eval()


def test_detector_cleanup_decisions_equal_jax(random_pair):
    jg, g, jm, params, tm = random_pair
    n = g.n_qubits
    syn = _syndromes(g, 21, bsz=256).astype(np.float32)
    with torch.inference_mode():
        out = tm(g.to("cpu"), torch.from_numpy(syn))
    sure = (out.qubit_logits[:, :n].abs() > 1e-4).all(-1).all(-1).numpy()
    assert sure.mean() > 0.9
    for got_dec, ref_dec in ((UnionFindDecoder(g), JaxUF(jg)),
                             (MWPMDecoder(g, p=0.03), JaxMWPM(jg, p=0.03))):
        got = th.gnn_cleanup_corrections(tm, g, syn, got_dec, device="cpu")
        ref = jh.gnn_cleanup_corrections(jm.apply, params, jg, jnp.asarray(syn), ref_dec)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a[sure], np.asarray(b)[sure])
        s = (got[0] @ np.asarray(g.h_syn_ex)[:g.n_checks, :n].T) % 2
        np.testing.assert_array_equal(s, syn[:, :g.n_checks])


def test_ler_all_columns_on_a_detector_graph():
    """The trained monolithic weights through ler_all_columns on 256 shots
    at p=0.02 (JAX: per-qubit 0.61, every other column 0.03-0.05 in the
    sidecar): the plain columns equal ler_monte_carlo's, no cleanup column
    leaves a syndrome, and the columns sit where the sidecar's do."""
    _, model, g = load_decoder(DETECTOR_D5_WEIGHTS, device="cpu")
    kw = dict(p=0.02, shots=256, batch=128, device="cpu")
    cols = th.ler_all_columns(model, g, generator=torch.Generator().manual_seed(4),
                              best_of=True, with_mwpm=True, with_uf_raw=True, **kw)
    plain = ler_monte_carlo(model, g, generator=torch.Generator().manual_seed(4), **kw)
    for k in ("ler", "ler_logical", "ler_hybrid"):
        assert cols[k] == plain[k], k
    assert not any(cols["syn_mismatch"].values())
    assert sum(cols["picked"].values()) == 256
    assert cols["ler"] > 0.4
    for k in ("ler_logical", "ler_hybrid", "gnn_uf", "gnn_mwpm", "gnn_best_of", "uf", "mwpm"):
        assert cols[k] < 0.15, (k, cols[k])


def test_d11_sidecar_records_per_qubit_rates():
    """scripts/ler_rows_card.py holds the d=11 per-qubit head at p=0.02 and
    0.03 to these JAX f32 rates (131,072 shots each)."""
    from tpugnn_torch.models.convert import DEFAULT_WEIGHTS

    ref = read_columns(DEFAULT_WEIGHTS)["per_qubit_reference"]
    assert "float32" in ref["function"]
    rows = {r["p"]: r for r in ref["rows"]}
    assert set(rows) == {0.02, 0.03}
    for r in rows.values():
        assert r["shots"] == 131072 and isinstance(r["seed"], int)
        assert 0.1 < r["ler"] < 0.4 and r["ler_logical"] < 1e-3
