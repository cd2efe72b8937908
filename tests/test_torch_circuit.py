"""The port's circuit-level detector graphs against the JAX package's.

* Graphs: every array of ``build_circuit_code`` (ELL tables, masks,
  ``logicals``, ``rate_scale``, pure-error tables) bit-equal to
  ``tpugnn.tanner.circuit``'s for the surface, toric and repetition codes in
  both sectors, d in {3, 5}, d_t in {1, 2, 3, 5}, and surface d=7 over 7
  rounds; the same refusals.
* The closed-form detector rules on the port's functions, against an
  explicit layer-by-layer simulation of the extraction circuit (the twins of
  tests/test_circuit.py).
* Decoding: a random circuit d=3 decoder (H=32, B=8, flax parameters
  converted) gives the JAX fused model's logits within 1e-5 in f32; the
  classical decoders (union-find, MWPM, the device repair) and the GNN
  cleanups equal JAX's on circuit syndromes; ``ler_all_columns`` with
  ``select_cost='nll'`` and ``DecodeEngine`` with ``cleanup='mwpm'`` run on
  a circuit graph.
* The five circuit weights files: bit-equal to a fresh restore of their
  checkpoints, on the graph their record names, with a forward equal to
  JAX's and sidecars holding the JAX f32 references at p=0.01.
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
from tpugnn.tanner.circuit import build_circuit_code as jax_circuit
from tpugnn.train.checkpoint import CheckpointManager
from tpugnn.train.loop import init_state
from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder
from tpugnn_torch.baselines.device_repair import DeviceRepair
from tpugnn_torch.configs import ExperimentConfig, ModelConfig
from tpugnn_torch.eval import hybrid as th
from tpugnn_torch.eval import ler_monte_carlo
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import (
    flatten_tree,
    load_decoder,
    load_npz,
    params_from_flax,
    read_columns,
    read_meta,
)
from tpugnn_torch.sampling import sample_batch, syndrome
from tpugnn_torch.serve import DecodeEngine
from tpugnn_torch.tanner import build_circuit_code
from tpugnn_torch.tanner.circuit import (
    SCALE_CNOT,
    SCALE_IDLE,
    SCALE_MEAS,
    SCALE_PREP,
    circuit_fault_classes,
    elementary_faults,
    fault_effect,
    repetition_schedule,
    surface_schedule,
    toric_schedule,
)
from tpugnn_torch.tanner.repetition import repetition_code_checks
from tpugnn_torch.tanner.surface import surface_code_checks
from tpugnn_torch.tanner.toric import toric_code_checks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tpugnn_torch", "assets")
CHECKS = {"surface": surface_code_checks, "toric": toric_code_checks,
          "repetition": repetition_code_checks}
SCHEDULES = {"surface": surface_schedule, "toric": toric_schedule,
             "repetition": repetition_schedule}
SIZES = [(d, d_t) for d in (3, 5) for d_t in (1, 2, 3, 5)]
# the circuit checkpoints behind benchmarks/LER_DETECTOR.md's [nll] rows:
# (weights file, checkpoint, step, d, sector, graph's M_pad / N_pad / Dc)
CIRCUIT_FILES = [
    ("circuit_surface_d3_t3_h128_r8_ema24000.npz", "runs/circuit_surface_d3_t3_h128c/ema",
     24000, 3, "z", (16, 56, 10)),
    ("circuit_surface_d5_t5_h128_r8_ema24000.npz", "runs/circuit_surface_d5_t5_h128c/ema",
     24000, 5, "z", (64, 304, 14)),
    ("circuit_surface_d3_t3_x_h128_r8_ema6000.npz", "runs/circuit_surface_d3_t3_x_h128c/ema",
     6000, 3, "x", (16, 56, 11)),
    ("circuit_surface_d5_t5_x_h128_r8_ema8000.npz", "runs/circuit_surface_d5_t5_x_h128c/ema",
     8000, 5, "x", (64, 304, 14)),
    ("circuit_surface_d7_t7_h128_r8_ema2000.npz", "runs/circuit_surface_d7_t7_h128c/ema",
     2000, 7, "z", (176, 920, 14)),
]
FILE_IDS = ["d3z", "d5z", "d3x", "d5x", "d7z"]


def _assert_graphs_equal(got, ref):
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


# --- the graphs --------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=[f"d{d}_t{t}" for d, t in SIZES])
@pytest.mark.parametrize("sector", ["z", "x"])
@pytest.mark.parametrize("family", ["surface", "toric", "repetition"])
def test_circuit_graph_bit_equal(family, sector, size):
    d, d_t = size
    if family == "repetition" and sector == "x":
        for build in (build_circuit_code, jax_circuit):
            with pytest.raises(ValueError, match="no x-sector"):
                build(family, d, d_t, sector=sector)
        return
    _assert_graphs_equal(build_circuit_code(family, d, d_t, sector=sector),
                         jax_circuit(family, d, d_t, sector=sector))


def test_circuit_d7_graph_bit_equal():
    got = build_circuit_code("surface", 7, 7)
    _assert_graphs_equal(got, jax_circuit("surface", 7, 7))
    assert (got.n_checks_pad, got.n_qubits_pad, got.deg_max_check, got.deg_max_qubit,
            got.n_edges) == (176, 920, 14, 2, 1710)


def test_circuit_refusals():
    with pytest.raises(ValueError, match="surface.*toric"):
        build_circuit_code("steane", 3, 3)
    with pytest.raises(ValueError, match="sector"):
        build_circuit_code("surface", 3, 3, sector="y")
    with pytest.raises(ValueError, match="d_t"):
        build_circuit_code("surface", 3, 0)


# --- the closed-form rules against a simulation (tests/test_circuit.py) ------

def simulate_circuit(own_sched, other_sched, n_data, d_t, prims):
    """Explicit X-frame simulation of the extraction circuit, layer by layer:
    own-check CNOTs copy the current data frame onto the check's
    accumulator at their layer; an X on an other-sector ancilla copies onto
    its partner data qubit at each of its remaining layers; faults land at
    their (round, after-layer) time.  Returns (difference detectors
    [m*d_t], final data frame [n_data])."""
    m = len(own_sched)
    x = np.zeros(n_data, np.uint8)
    outcomes = np.zeros((d_t, m), np.uint8)
    for t in range(d_t):
        for p in prims:
            if p[0] == "data" and p[2] == t and p[3] == -1:
                x[p[1]] ^= 1
        acc = np.zeros(m, np.uint8)
        anc = np.zeros(len(other_sched), np.uint8)
        for layer in range(4):
            for c, qs in enumerate(own_sched):
                for q, s in qs:
                    if s == layer:
                        acc[c] ^= x[q]
            for j, qs in enumerate(other_sched):
                if anc[j]:
                    for q, s in qs:
                        if s == layer:
                            x[q] ^= 1
            for p in prims:
                if p[0] == "data" and p[2] == t and p[3] == layer:
                    x[p[1]] ^= 1
                elif p[0] == "otheranc" and p[2] == t and p[3] == layer:
                    anc[p[1]] ^= 1
        for p in prims:
            if p[0] == "ownmeas" and p[2] == t:
                acc[p[1]] ^= 1
        outcomes[t] = acc
    det = outcomes.copy()
    det[1:] ^= outcomes[:-1]
    return det.reshape(-1), x


def _effect_arrays(prims, own, other, n, d_t):
    m = len(own)
    eff = fault_effect(prims, own, other, n, d_t)
    sym = np.zeros(m * d_t, np.uint8)
    err = np.zeros(n, np.uint8)
    if eff is not None:
        sym[sorted(eff[0])] = 1
        err[sorted(eff[1])] = 1
    return sym, err


CLOSED_FORM = [("surface", 3, 3, "z"), ("surface", 3, 2, "z"), ("surface", 5, 3, "z"),
               ("toric", 3, 3, "z"), ("toric", 2, 2, "z"), ("repetition", 5, 3, "z"),
               ("surface", 3, 3, "x"), ("toric", 3, 2, "x")]


@pytest.mark.parametrize("family,d,d_t,sector", CLOSED_FORM)
def test_closed_form_matches_simulation(family, d, d_t, sector):
    """Every elementary fault's (symptom, net data error) as the simulator
    finds it; sector 'x' swaps the schedules."""
    hx, _ = CHECKS[family](d)
    x_sched, z_sched = SCHEDULES[family](d)
    own, other = (z_sched, x_sched) if sector == "z" else (x_sched, z_sched)
    n = hx.shape[1]
    for prims, _ in elementary_faults(own, other, n, d_t):
        det_sim, x_sim = simulate_circuit(own, other, n, d_t, prims)
        sym, err = _effect_arrays(prims, own, other, n, d_t)
        np.testing.assert_array_equal(sym, det_sim, err_msg=f"prims={prims}")
        np.testing.assert_array_equal(err, x_sim, err_msg=f"prims={prims}")


def test_random_fault_combinations_match_simulation():
    """Linearity: the XOR of random fault subsets as the simulator finds it."""
    d, d_t = 3, 3
    x_sched, z_sched = surface_schedule(d)
    n = d * d
    faults = elementary_faults(z_sched, x_sched, n, d_t)
    rng = np.random.default_rng(0)
    for _ in range(20):
        sel = rng.random(len(faults)) < 0.1
        prims = [p for (ps, _), s in zip(faults, sel) if s for p in ps]
        det_sim, x_sim = simulate_circuit(z_sched, x_sched, n, d_t, prims)
        sym, err = _effect_arrays(prims, z_sched, x_sched, n, d_t)
        np.testing.assert_array_equal(sym, det_sim)
        np.testing.assert_array_equal(err, x_sim)


@pytest.mark.parametrize("family", ["surface", "toric", "repetition"])
def test_schedule_is_conflict_free_and_matches_checks(family):
    for d in (3, 5, 7):
        hx, hz = CHECKS[family](d)
        x_sched, z_sched = SCHEDULES[family](d)
        assert len(x_sched) == hx.shape[0] and len(z_sched) == hz.shape[0]
        for sched, hmat in ((x_sched, hx), (z_sched, hz)):
            for c, qs in enumerate(sched):
                assert sorted(q for q, _ in qs) == sorted(np.nonzero(hmat[c])[0].tolist())
        for layer in range(4):
            busy = set()
            for qs in x_sched + z_sched:
                for q, s in qs:
                    if s == layer:
                        assert q not in busy, (d, layer, q)
                        busy.add(q)


def test_dt1_reduces_to_code_capacity():
    """One perfect round: the base code's Hz over single-qubit idles."""
    d = 3
    _, hz = surface_code_checks(d)
    x_sched, z_sched = surface_schedule(d)
    hp, e_net, rate = circuit_fault_classes(z_sched, x_sched, d * d, 1)
    assert hp.shape[1] == d * d
    np.testing.assert_array_equal(e_net.sum(1), 1)
    np.testing.assert_array_equal(hp[:, np.argsort(np.argmax(e_net, 1))], hz)
    assert np.allclose(rate, SCALE_IDLE)


def test_hooks_and_merged_rates():
    d, d_t = 3, 3
    x_sched, z_sched = surface_schedule(d)
    hp, e_net, rate = circuit_fault_classes(z_sched, x_sched, d * d, d_t)
    assert (e_net.sum(1) >= 2).any(), "no hook errors found"
    m = len(z_sched)
    bulk = [c for c, qs in enumerate(z_sched) if len(qs) == 4][0]
    sym = np.zeros(m * d_t, np.uint8)
    sym[[bulk, m + bulk]] = 1
    j = [jj for jj in range(hp.shape[1]) if (hp[:, jj] == sym).all() and e_net[jj].sum() == 0]
    assert len(j) == 1
    np.testing.assert_allclose(rate[j[0]], SCALE_PREP + SCALE_MEAS + 4 * SCALE_CNOT, rtol=1e-6)


@pytest.mark.parametrize("family,sector,k", [("surface", "z", 1), ("surface", "x", 1),
                                             ("toric", "z", 2), ("repetition", "z", 1)])
def test_sampled_syndromes_are_consistent(family, sector, k):
    """Sampling on a circuit graph: one sector, and every syndrome the
    syndrome of its pure-error representative."""
    g = build_circuit_code(family, 3 if family != "repetition" else 5, 3, sector=sector)
    assert g.n_checks_x == 0 and g.k == k
    dg = g.to("cpu")
    b = sample_batch(torch.Generator().manual_seed(0), dg, 0.02, 128)
    assert not b.ez.any()
    ex0 = torch.remainder(b.syndrome @ dg.pure_ex.T, 2.0)
    torch.testing.assert_close(syndrome(dg, ex0, torch.zeros_like(ex0)), b.syndrome,
                               rtol=0, atol=0)


# --- decoding on circuit graphs ---------------------------------------------

def test_random_circuit_decoder_matches_jax_fused():
    """A circuit d=3 decoder (H=32, R=3, bits head, B=8) on flax parameters
    converted: the port's forward (the plain version of K1 on the CPU)
    gives the JAX fused model's logits within 1e-5 (f32)."""
    jg = jax_circuit("surface", 3, 3)
    kw = dict(hidden=32, msg_hidden=32, rounds=3, qubit_head="bits", readout="both",
              backend="fused")
    jm = JaxGNNDecoder(JaxModelConfig(**kw), k=jg.k)
    rng = np.random.default_rng(8)
    syn = (rng.random((8, jg.n_checks_pad)) < 0.2).astype(np.float32) * np.asarray(jg.check_mask)
    params = jm.init(jax.random.PRNGKey(4), jg, jnp.asarray(syn))
    ref = jm.apply(params, jg, jnp.asarray(syn))
    tm = GNNDecoder(ModelConfig(**kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm(build_circuit_code("surface", 3, 3).to("cpu"), torch.from_numpy(syn))
    for a, b in ((got.qubit_logits, ref.qubit_logits), (got.logical_logits, ref.logical_logits)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def _circuit_syndromes(g, seed, bsz=128, p=0.01):
    """Syndromes of fault vectors drawn at p * rate_scale."""
    rng = np.random.default_rng(seed)
    rate = np.asarray(g.rate_scale)[None, :] * p
    ex = (rng.random((bsz, g.n_qubits_pad)) < rate).astype(np.float32) * g.qubit_mask
    return ((ex @ np.asarray(g.h_syn_ex).T) % 2).astype(np.uint8)


@pytest.mark.parametrize("case", [("surface", 3, 3, "z"), ("surface", 5, 5, "x"),
                                  ("toric", 3, 2, "z")], ids=["d3z", "d5x", "toric3"])
def test_classical_decoders_equal_on_circuit_graphs(case):
    """Union-find, MWPM (weighted by rate_scale) and the device repair
    decode circuit syndromes bit-equal to JAX's, and every repair
    reproduces its syndrome."""
    family, d, d_t, sector = case
    g = build_circuit_code(family, d, d_t, sector=sector)
    jg = jax_circuit(family, d, d_t, sector=sector)
    syn = _circuit_syndromes(g, d + d_t, p=0.02)
    n = g.n_qubits
    h = np.asarray(g.h_syn_ex)[:g.n_checks, :n]
    for got_dec, ref_dec in ((UnionFindDecoder(g), JaxUF(jg)),
                             (MWPMDecoder(g, p=0.02), JaxMWPM(jg, p=0.02))):
        got, ref = got_dec.decode(syn), ref_dec.decode(syn)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert not got[1].any()
        np.testing.assert_array_equal((got[0][:, :n] @ h.T) % 2, syn[:, :g.n_checks])
    got = DeviceRepair(g, device="cpu").repair(torch.from_numpy(syn.astype(np.float32)))
    ref = JaxDeviceRepair(jg).repair(jnp.asarray(syn, jnp.float32))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def random_pair():
    """A circuit d=3 decoder (H=32, R=3, bits head) of each package on the
    same converted parameters."""
    jg = jax_circuit("surface", 3, 3)
    kw = dict(hidden=32, msg_hidden=32, rounds=3, qubit_head="bits", readout="both")
    jm = JaxGNNDecoder(JaxModelConfig(backend="fused", **kw), k=jg.k)
    params = jm.init(jax.random.PRNGKey(3), jg, jnp.zeros((2, jg.n_checks_pad)))
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, build_circuit_code("surface", 3, 3), jm, params, tm.eval()


def test_circuit_cleanup_decisions_equal_jax(random_pair):
    """GNN + union-find and GNN + MWPM on a circuit graph: the port's
    corrections equal JAX's on every shot whose logits are all at least
    1e-4 from 0, and each reproduces its syndrome."""
    jg, g, jm, params, tm = random_pair
    n = g.n_qubits
    syn = _circuit_syndromes(g, 21, bsz=256, p=0.02).astype(np.float32)
    with torch.inference_mode():
        out = tm(g.to("cpu"), torch.from_numpy(syn))
    sure = (out.qubit_logits[:, :n].abs() > 1e-4).all(-1).all(-1).numpy()
    assert sure.mean() > 0.9
    for got_dec, ref_dec in ((UnionFindDecoder(g), JaxUF(jg)),
                             (MWPMDecoder(g, p=0.02), JaxMWPM(jg, p=0.02))):
        got = th.gnn_cleanup_corrections(tm, g, syn, got_dec, device="cpu")
        ref = jh.gnn_cleanup_corrections(jm.apply, params, jg, jnp.asarray(syn), ref_dec)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a[sure], np.asarray(b)[sure])
        s = (got[0] @ np.asarray(g.h_syn_ex)[:g.n_checks, :n].T) % 2
        np.testing.assert_array_equal(s, syn[:, :g.n_checks])


def test_nll_selection_equals_jax_on_a_circuit_graph(random_pair):
    """min_weight_select with the NLL rule over the GNN's candidates picks
    JAX's candidate on every sure shot of a circuit graph."""
    jg, g, jm, params, tm = random_pair
    n = g.n_qubits
    syn = _circuit_syndromes(g, 22, bsz=256, p=0.02).astype(np.float32)
    with torch.inference_mode():
        out = tm(g.to("cpu"), torch.from_numpy(syn))
    sure = (out.qubit_logits[:, :n].abs() > 1e-4).all(-1).all(-1).numpy()
    nlp = th._nlp4(out.qubit_logits).numpy()[:, :n]
    jnlp = np.asarray(jh._nlp4(jm.apply(params, jg, jnp.asarray(syn)).qubit_logits))[:, :n]
    np.testing.assert_allclose(nlp[sure], jnlp[sure], atol=1e-4, rtol=1e-4)
    rng = np.random.default_rng(5)
    names = ["gnn_uf", "gnn_mwpm", "mwpm"]
    cands = {c: ((rng.random((256, n)) < 0.05).astype(np.uint8),
                 np.zeros((256, n), np.uint8)) for c in names}
    hz = np.asarray(g.h_syn_ex)[:g.n_checks, :n].astype(np.uint8)
    hx = np.zeros((g.n_checks, n), np.uint8)
    s = syn[:, :g.n_checks].astype(np.uint8)
    got = th.min_weight_select(names, cands, s, hz, hx, nlp=nlp)
    ref = jh.min_weight_select(names, cands, s, hz, hx, nlp=jnlp)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a)[sure], np.asarray(b)[sure])
    assert len(set(got[2][sure].tolist())) > 1


@functools.lru_cache(maxsize=None)
def _restored(ckpt: str, d: int, sector: str):
    """(JAX circuit graph, model, restored state) of a circuit checkpoint
    (H=128, R=8, bits head), restored from a temporary copy."""
    cfg = JaxExperimentConfig(code=JaxCodeConfig(family="surface", distance=d),
                              model=JaxModelConfig(hidden=128, msg_hidden=128, rounds=8,
                                                   backend="fused", qubit_head="bits"))
    graph = jax_circuit("surface", d, d, sector=sector)
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "ckpt")
        shutil.copytree(os.path.join(REPO, ckpt), copy)
        state, model = init_state(cfg, graph)
        mgr = CheckpointManager(copy)
        r = mgr.restore_latest(state)
        mgr.close()
    return graph, model, r


@pytest.mark.parametrize("case", CIRCUIT_FILES, ids=FILE_IDS)
def test_circuit_npz_equals_fresh_restore_and_names_its_graph(case):
    fname, ckpt, step, d, sector, shape = case
    path = os.path.join(ASSETS, fname)
    jg, jmodel, r = _restored(ckpt, d, sector)
    cfg, flat, got_step = load_npz(path)
    assert got_step == int(r.step) == step
    want = flatten_tree(jax.tree.map(np.asarray, r.params))
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    meta = read_meta(path)
    assert meta["source"] == ckpt
    assert meta["graph"] == {"kind": "circuit", "d_t": d, "sector": sector}
    m = cfg.model
    assert (m.hidden, m.msg_hidden, m.rounds, m.qubit_head, m.dtype, m.backend) == \
        (128, 128, 8, "bits", "float32", "fused")
    assert os.path.getsize(path) <= 2 * 1024 * 1024
    # the graph the record names, and the forward on it
    _, model, graph = load_decoder(path, device="cpu")
    assert graph.name == jg.name == f"surface_d{d}_circuit_t{d}_{sector}"
    np.testing.assert_array_equal(graph.rate_scale, np.asarray(jg.rate_scale))
    assert (graph.n_checks_pad, graph.n_qubits_pad, graph.deg_max_check) == shape
    syn = _circuit_syndromes(graph, d, bsz=4, p=0.01).astype(np.float32)
    ref = jmodel.apply(r.params, jg, jnp.asarray(syn))
    with torch.no_grad():
        got = model(graph.to("cpu"), torch.from_numpy(syn))
    np.testing.assert_allclose(got.qubit_logits.numpy(), np.asarray(ref.qubit_logits),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got.logical_logits.numpy(), np.asarray(ref.logical_logits),
                               atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("case", CIRCUIT_FILES, ids=FILE_IDS)
def test_circuit_sidecars_hold_the_jax_references(case):
    """What chip_smoke.py's circuit_and_cli phase gates against: the JAX f32
    LER at p=0.01 in the weights file and the JAX f32 columns (NLL
    selection) at p=0.01 in its sidecar, both of these weights."""
    path = os.path.join(ASSETS, case[0])
    meta, side = read_meta(path), read_columns(path)
    for k in ("step", "source", "code", "model", "graph"):
        assert side[k] == meta[k], k
    ref = meta["ler_reference"]
    assert ref["p"] == 0.01 and ref["shots"] >= 65536 and "float32" in ref["function"]
    assert side["p"] == 0.01 and side["shots"] >= 65536 and side["select_cost"] == "nll"
    assert set(side["columns"]) == {"ler", "ler_logical", "ler_hybrid", "gnn_uf", "gnn_mwpm",
                                    "gnn_best_of", "uf", "mwpm"}


def test_ler_all_columns_nll_on_the_circuit_weights():
    """The trained d=3 circuit weights through ler_all_columns with the NLL
    rule on 512 shots at p=0.01: the plain columns equal ler_monte_carlo's,
    no cleanup column leaves a syndrome, and the columns sit near the JAX
    sidecar's (about 0.03 but the per-qubit head's 0.12)."""
    path = os.path.join(ASSETS, CIRCUIT_FILES[0][0])
    _, model, g = load_decoder(path, device="cpu")
    kw = dict(p=0.01, shots=512, batch=256, device="cpu")
    cols = th.ler_all_columns(model, g, generator=torch.Generator().manual_seed(4),
                              best_of=True, with_mwpm=True, with_uf_raw=True,
                              select_cost="nll", **kw)
    plain = ler_monte_carlo(model, g, generator=torch.Generator().manual_seed(4), **kw)
    for k in ("ler", "ler_logical", "ler_hybrid"):
        assert cols[k] == plain[k], k
    assert not any(cols["syn_mismatch"].values())
    assert sum(cols["picked"].values()) == 512
    for k in ("ler_logical", "ler_hybrid", "gnn_uf", "gnn_mwpm", "gnn_best_of", "uf", "mwpm"):
        assert cols[k] < 0.1, (k, cols[k])


def test_weights_file_decodes_in_the_state_type_asked_for():
    """load_decoder and DecodeEngine.from_npz with dtype='bfloat16' (the
    state type the circuit checkpoints were trained in) load the file's
    parameters into a model whose rounds store bf16 states: its logits move
    off the f32 model's, and its decisions agree with them on at least 99%
    of the entries (chip_smoke.py's MIN_AGREE_BF16)."""
    path = os.path.join(ASSETS, CIRCUIT_FILES[0][0])
    _, m32, g = load_decoder(path, device="cpu")
    cfg, m16, _ = load_decoder(path, device="cpu", dtype="bfloat16")
    assert cfg.model.dtype == "bfloat16" and m16.cfg.dtype == "bfloat16"
    for (k, a), (_, b) in zip(m32.state_dict().items(), m16.state_dict().items()):
        assert torch.equal(a, b), k
    dg = g.to("cpu")
    syn = torch.from_numpy(_circuit_syndromes(g, 3, bsz=256, p=0.01).astype(np.float32))
    with torch.no_grad():
        o32, o16 = m32(dg, syn), m16(dg, syn)
    for f in ("qubit_logits", "logical_logits"):
        a, b = getattr(o32, f), getattr(o16, f)
        assert not torch.equal(a, b), f
        assert ((a > 0) == (b > 0)).float().mean() >= 0.99, f
    with DecodeEngine.from_npz(path, device="cpu", dtype="bfloat16", max_batch=64) as eng:
        assert eng.model.cfg.dtype == "bfloat16"
        corr = eng.decode(syn[:64, :g.n_checks].to(torch.uint8).numpy())
    assert corr.shape == (64, g.n_qubits, 2)


def test_decode_engine_serves_a_circuit_graph():
    """DecodeEngine with cleanup='mwpm' on the d=3 circuit weights: every
    correction reproduces its syndrome, and the first equals the
    GNN+MWPM correction of eval/hybrid."""
    path = os.path.join(ASSETS, CIRCUIT_FILES[0][0])
    cfg, model, g = load_decoder(path, device="cpu")
    syn_pad = _circuit_syndromes(g, 3, bsz=300, p=0.01)
    syn = syn_pad[:, :g.n_checks]
    with DecodeEngine(cfg, model, g, max_batch=128, cleanup="mwpm", device="cpu") as eng:
        corr = eng.decode(syn)
    n = g.n_qubits
    assert corr.shape == (300, n, 2) and not corr[..., 1].any()
    h = np.asarray(g.h_syn_ex)[:g.n_checks, :n]
    np.testing.assert_array_equal((corr[..., 0].astype(np.int64) @ h.T) % 2, syn)
    want = th.gnn_cleanup_corrections(model, g, syn_pad.astype(np.float32),
                                      MWPMDecoder(g, p=cfg.code.p), device="cpu")
    np.testing.assert_array_equal(corr[..., 0], want[0][:, :n])
    assert isinstance(cfg, ExperimentConfig)
