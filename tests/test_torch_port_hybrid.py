"""The port's hybrid layer (tpugnn_torch.eval.hybrid) against the JAX package's.

* On the same logits fed to both: _gated_corrections (with and without
  tau), _nlp4, logical_head_correction, min_weight_select (both costs),
  lazy_decode and gnn_cleanup_corrections are equal exactly.
* End to end through converted weights on the same syndromes: the GNN+UF,
  GNN+MWPM and best-of decisions are equal on every shot whose top-two
  logit margin exceeds 1e-4; the others are counted and must be <= 0.1%.
* ler_all_columns against itself and the single-column evaluators on one
  CPU generator: its plain columns equal ler_monte_carlo's, its cleanup
  columns ler_gnn_cleanup's, ler_best_of's and the baselines'; a killed and
  resumed run equals an uninterrupted one; with_mwpm_raw without MWPM
  reports no column.
"""

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.baselines import MWPMDecoder as JaxMWPM
from tpugnn.baselines import UnionFindDecoder as JaxUF
from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.eval import hybrid as jh
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.sampling import sample_batch as jax_sample_batch
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.eval import hybrid as th
from tpugnn_torch.eval import ler_best_of, ler_gnn_cleanup, ler_monte_carlo
from tpugnn_torch.eval.baseline import ler_mwpm, ler_union_find
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import (
    DEFAULT_WEIGHTS,
    columns_path,
    params_from_flax,
    read_columns,
    read_meta,
)
from tpugnn_torch.models.decoder import DecoderOutput
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)


def _logits(shape, seed, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("tau", [None, 0.6, 0.9])
def test_gated_corrections_equal(width, tau):
    lg = _logits((16, 40, width), width)
    got = th._gated_corrections(torch.from_numpy(lg), tau)
    ref = jh._gated_corrections(jnp.asarray(lg), tau)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if tau is not None:
        assert 0 < float(got[0].sum() + got[1].sum()) < float(
            sum(x.sum() for x in th._gated_corrections(torch.from_numpy(lg), None)))


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("temp", [1.0, 1.7])
def test_nlp4_equal(width, temp):
    lg = _logits((16, 40, width), 10 + width, scale=6.0)
    got = th._nlp4(torch.from_numpy(lg), temp)
    ref = np.asarray(jh._nlp4(jnp.asarray(lg), temp))
    assert got.dtype == torch.uint8 and got.shape == (16, 40, 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.max() == 255 or temp != 1.0     # the clip to 255 is exercised


@pytest.mark.parametrize("d", [3, 5])
def test_logical_head_correction_equal(d):
    jg = jax_build_code("surface", d)
    b = jax_sample_batch(jax.random.PRNGKey(d), jg, 0.1, 32)
    lg = _logits((32, 2 * jg.k), d)
    ref = jh.logical_head_correction(jg, b.syndrome, jnp.asarray(lg))
    got = th.logical_head_correction(build_code("surface", d).to("cpu"),
                                     torch.from_numpy(np.array(b.syndrome)),
                                     torch.from_numpy(lg))
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def _candidates(g, seed, bsz=64):
    """Candidate corrections of a d=5 code: consistent ones from the
    decoders, and raw 'qubit' / 'logical' ones that often are not."""
    jg = jax_build_code("surface", 5)
    syn = np.array(jax_sample_batch(jax.random.PRNGKey(seed), jg, 0.08, bsz).syndrome)
    syn = syn.astype(np.uint8)
    n, rng = g.n_qubits, np.random.default_rng(seed)
    ux, uz = UnionFindDecoder(g).decode(syn)
    mx, mz = MWPMDecoder(g).decode(syn)
    noisy = lambda x: x ^ (rng.random(x.shape) < 0.05).astype(np.uint8)
    cands = {"qubit": (noisy(ux), noisy(uz)), "logical": (np.where(rng.random((bsz, 1)) < .5,
                                                                   ux, noisy(mx)), mz),
             "gnn_uf": (ux, uz), "gnn_mwpm": (mx, mz), "mwpm": (mx, mz)}
    nlp = rng.integers(0, 256, (bsz, n, 4)).astype(np.uint8)
    return syn, cands, nlp


@pytest.mark.parametrize("cost", ["weight", "nll"])
@pytest.mark.parametrize("gate", [False, True])
def test_min_weight_select_equal(cost, gate):
    g = build_code("surface", 5)
    syn, cands, nlp = _candidates(g, 3 + gate)
    n = g.n_qubits
    hx = np.asarray(g.h_syn_ez)[:g.n_checks, :n].astype(np.uint8)
    hz = np.asarray(g.h_syn_ex)[:g.n_checks, :n].astype(np.uint8)
    kw = dict(nlp=nlp if cost == "nll" else None,
              qubit_inconsistent=(np.random.default_rng(1).random(64) < .5) if gate else None)
    got = th.min_weight_select(tuple(cands), cands, syn, hz, hx, **kw)
    ref = jh.min_weight_select(tuple(cands), cands, syn, hz, hx, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(set(got[2].tolist())) > 1


def test_lazy_decode_equal_and_exact():
    jg, g = jax_build_code("surface", 3), build_code("surface", 3)
    syn = np.array(jax_sample_batch(jax.random.PRNGKey(21), jg, 0.03, 64).syndrome)
    syn = syn.astype(np.uint8)
    syn[::3] = 0
    for port, ref in ((UnionFindDecoder(g), JaxUF(jg)), (MWPMDecoder(g), JaxMWPM(jg))):
        got, want = th.lazy_decode(port, syn), jh.lazy_decode(ref, syn)
        eager = port.decode(syn)
        for a, b, c in zip(got, want, eager):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert not any(x.any() for x in th.lazy_decode(port, np.zeros_like(syn)))


class _JaxOut(NamedTuple):
    qubit_logits: jnp.ndarray
    logical_logits: Optional[jnp.ndarray]


class _FixedModel(torch.nn.Module):
    """A decoder whose outputs are given: the same logits for both packages."""

    def __init__(self, qubit, logical):
        super().__init__()
        self.q, self.l = torch.from_numpy(qubit), torch.from_numpy(logical)

    def forward(self, graph, syn):
        return DecoderOutput(qubit_logits=self.q, logical_logits=self.l)


@pytest.mark.parametrize("cleanup", ["uf", "mwpm"])
@pytest.mark.parametrize("tau", [None, 0.7])
def test_gnn_cleanup_corrections_equal_on_the_same_logits(cleanup, tau):
    jg, g = jax_build_code("surface", 5), build_code("surface", 5)
    syn = np.array(jax_sample_batch(jax.random.PRNGKey(5), jg, 0.06, 48).syndrome)
    q = _logits((48, g.n_qubits_pad, 4), 8)
    q[..., 0] += 3.0                         # mostly the identity, as a trained head
    lo = _logits((48, 2), 9)
    apply_fn = lambda params, graph, s: _JaxOut(jnp.asarray(q), jnp.asarray(lo))
    jdec = JaxUF(jg) if cleanup == "uf" else JaxMWPM(jg, p=0.06)
    tdec = UnionFindDecoder(g) if cleanup == "uf" else MWPMDecoder(g, p=0.06)
    ref = jh.gnn_cleanup_corrections(apply_fn, None, jg, jnp.asarray(syn), jdec, tau=tau)
    got = th.gnn_cleanup_corrections(_FixedModel(q, lo), g, syn, tdec, tau=tau, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pair():
    """A d=5 decoder of each package on the same (converted) parameters."""
    jg = jax_build_code("surface", 5)
    kw = dict(hidden=32, msg_hidden=32, rounds=3, qubit_head="pauli4", readout="both")
    jm = JaxGNNDecoder(JaxModelConfig(backend="fused", **kw), k=1)
    params = jm.init(jax.random.PRNGKey(4), jg, jnp.zeros((2, jg.n_checks_pad)))
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=1)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, build_code("surface", 5), jm, params, tm.eval()


def test_end_to_end_decisions_through_converted_weights(pair):
    """The same syndromes through each package's forward and hybrid layer:
    GNN+UF, GNN+MWPM and best-of equal on every shot whose top-two logit
    margin (every real qubit, and |logical logit|) exceeds 1e-4."""
    jg, g, jm, params, tm = pair
    n = g.n_qubits
    jdecs = (JaxUF(jg), JaxMWPM(jg, p=0.05))
    tdecs = (UnionFindDecoder(g), MWPMDecoder(g, p=0.05))
    hx = np.asarray(g.h_syn_ez)[:g.n_checks, :n].astype(np.uint8)
    hz = np.asarray(g.h_syn_ex)[:g.n_checks, :n].astype(np.uint8)
    dg = g.to("cpu")
    shots = near = 0
    for i in range(32):                      # 32 forwards of 8 shots
        syn = np.array(jax_sample_batch(jax.random.PRNGKey(100 + i), jg, 0.05, 8).syndrome)
        got, ref = [], []
        for jd, td in zip(jdecs, tdecs):
            ref.append(jh.gnn_cleanup_corrections(jm.apply, params, jg, jnp.asarray(syn), jd))
            got.append(th.gnn_cleanup_corrections(tm, g, syn, td, device="cpu"))
        with torch.inference_mode():
            out = tm(dg, torch.from_numpy(syn))
        h = th._HostCopy(th._chunk(tm, dg, torch.from_numpy(syn), None)).numpy()
        jout = jm.apply(params, jg, jnp.asarray(syn))
        lex, lez = jh.logical_head_correction(jg, jnp.asarray(syn), jout.logical_logits)
        exg, ezg = (np.asarray(x)[:, :n].astype(np.uint8)
                    for x in jh._gated_corrections(jout.qubit_logits, None))
        for side, (exq, ezq, lx, lz, cl) in (
                ("port", (h["ex_g"][:, :n], h["ez_g"][:, :n], h["lex"][:, :n], h["lez"][:, :n],
                          got)),
                ("jax", (exg, ezg, np.asarray(lex)[:, :n].astype(np.uint8),
                         np.asarray(lez)[:, :n].astype(np.uint8), ref))):
            cands = {"qubit": (exq, ezq), "logical": (lx, lz), "gnn_uf": cl[0],
                     "gnn_mwpm": cl[1]}
            best = th.min_weight_select(tuple(cands), cands, syn.astype(np.uint8), hz, hx)
            (got if side == "port" else ref).append(best[:2])
        top2 = torch.topk(out.qubit_logits[:, :n], 2, dim=-1).values
        margin = torch.minimum((top2[..., 0] - top2[..., 1]).amin(1),
                               out.logical_logits.abs().amin(1)).numpy()
        sure = margin > 1e-4
        near += int((~sure).sum())
        shots += len(sure)
        for (a, b), (c, e) in zip(got, ref):
            np.testing.assert_array_equal(a[sure], c[sure])
            np.testing.assert_array_equal(b[sure], e[sure])
    assert near <= 0.001 * shots, (near, shots)


@pytest.fixture(scope="module")
def small():
    """A d=3 port decoder on converted JAX parameters, and its graph."""
    jg = jax_build_code("surface", 3)
    kw = dict(hidden=32, msg_hidden=32, rounds=3, qubit_head="pauli4", readout="both")
    params = JaxGNNDecoder(JaxModelConfig(backend="fused", **kw), k=1).init(
        jax.random.PRNGKey(7), jg, jnp.zeros((2, jg.n_checks_pad)))
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=1)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return tm.eval(), build_code("surface", 3)


def _gen(seed=11):
    return torch.Generator().manual_seed(seed)


def test_all_columns_equal_single_column_evaluators(small):
    model, g = small
    kw = dict(p=0.06, shots=500, batch=128, device="cpu")
    u = th.ler_all_columns(model, g, generator=_gen(), with_uf_raw=True, **kw)
    ev = ler_monte_carlo(model, g, generator=_gen(), **kw)
    guf = ler_gnn_cleanup(model, g, generator=_gen(), cleanup="uf", **kw)
    gmw = ler_gnn_cleanup(model, g, generator=_gen(), cleanup="mwpm", **kw)
    gbo = ler_best_of(model, g, generator=_gen(), **kw)
    assert u["shots"] == ev["shots"] == 512.0
    for k in ("ler", "ler_logical", "ler_hybrid"):
        assert u[k] == ev[k], k
    assert (u["gnn_uf"], u["gnn_mwpm"]) == (guf["ler"], gmw["ler"])
    assert u["gnn_best_of"] == gbo["ler"] and u["picked"] == gbo["picked"]
    assert u["uf"] == ler_union_find(g, generator=_gen(), **kw)["ler"]
    assert u["mwpm"] == ler_mwpm(g, generator=_gen(), **kw)["ler"]
    assert sum(u["picked"].values()) == 512
    assert not any(u["syn_mismatch"].values())
    assert guf["syn_mismatch_rate"] == gmw["syn_mismatch_rate"] == 0.0
    assert u["timing"]["device_s"] is None and u["timing"]["host_s"] > 0


def test_closed_gate_equals_pure_union_find(small):
    model, g = small
    kw = dict(p=0.05, shots=256, batch=128, device="cpu")
    res = ler_gnn_cleanup(model, g, generator=_gen(3), cleanup="uf", tau=1.5, **kw)
    assert res["ler"] == ler_union_find(g, generator=_gen(3), **kw)["ler"]


def test_nll_best_of_runs(small, monkeypatch):
    model, g = small
    monkeypatch.setenv("TPUGNN_NLL_TEMP", "1.5")
    u = th.ler_all_columns(model, g, p=0.06, shots=256, batch=128, generator=_gen(),
                           select_cost="nll", device="cpu")
    w = th.ler_all_columns(model, g, p=0.06, shots=256, batch=128, generator=_gen(),
                           device="cpu")
    assert sum(u["picked"].values()) == 256 and u["gnn_uf"] == w["gnn_uf"]
    with pytest.raises(ValueError, match="select_cost"):
        th.ler_all_columns(model, g, p=0.06, shots=1, generator=_gen(), select_cost="foo",
                           device="cpu")


def test_mwpm_raw_requires_mwpm(small):
    model, g = small
    u = th.ler_all_columns(model, g, p=0.06, shots=128, batch=128, generator=_gen(19),
                           with_mwpm=False, with_mwpm_raw=True, device="cpu")
    assert u["mwpm"] is None and u["gnn_mwpm"] is None
    assert set(u["picked"]) == {"qubit", "logical", "gnn_uf"}


class _Abort(Exception):
    pass


def _columns(model, g, seed=5, **kw):
    return th.ler_all_columns(model, g, p=0.05, shots=6 * 64, batch=64, generator=_gen(seed),
                              device="cpu", flush_every=2, **kw)


def test_resume_equals_uninterrupted(small, tmp_path):
    model, g = small
    ref = _columns(model, g)
    prog = str(tmp_path / "p.progress.json")
    partial = []

    def abort(res):
        partial.append(res["shots"])
        raise _Abort

    with pytest.raises(_Abort):
        _columns(model, g, progress_path=prog, on_progress=abort)
    assert os.path.exists(prog) and partial == [128.0]
    seen = []
    res = _columns(model, g, progress_path=prog, on_progress=lambda r: seen.append(r["shots"]))
    # the resumed run starts at chunk 3: its first flush is after 4 chunks
    assert seen == [256.0, 384.0]
    res.pop("timing"), ref.pop("timing")
    assert res == ref
    assert not os.path.exists(prog)


def test_resume_refuses_another_generator_or_model(small, tmp_path):
    model, g = small
    prog = str(tmp_path / "q.progress.json")

    def abort(res):
        raise _Abort

    with pytest.raises(_Abort):
        _columns(model, g, progress_path=prog, on_progress=abort)
    # another seed: the progress file is not of this run, so it starts clean
    other = _columns(model, g, seed=6, progress_path=prog)
    fresh = _columns(model, g, seed=6)
    other.pop("timing"), fresh.pop("timing")
    assert other == fresh


def test_columns_sidecar_names_the_weights():
    """The JAX f32 columns that chip_smoke.py gates against belong to the
    shipped d=11 weights: same step, source, code and model config."""
    assert os.path.exists(columns_path(DEFAULT_WEIGHTS))
    cols, meta = read_columns(), read_meta()
    for k in ("step", "source", "code", "model"):
        assert cols[k] == meta[k], k
    assert cols["p"] == meta["ler_reference"]["p"] == 0.05
    assert cols["seed"] == meta["ler_reference"]["seed"]
    # the plain columns are the weights file's own JAX reference run
    if cols["shots"] == meta["ler_reference"]["shots"]:
        for k in ("ler", "ler_logical", "ler_hybrid"):
            assert cols["columns"][k] == meta["ler_reference"][k], k
    assert set(cols["columns"]) >= {"gnn_uf", "gnn_mwpm", "gnn_best_of", "uf", "mwpm"}
    assert sum(cols["picked"].values()) == cols["shots"]
