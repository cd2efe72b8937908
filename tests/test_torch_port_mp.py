"""The port's message-passing engine (tpugnn_torch.mp) against tpugnn.mp.

Every backend (segment, dense, ell, pallas) and aggregation (sum, mean,
max) against the same JAX backend, on the surface code at d=3 and d=5, the
toric code at d=3 and a lopsided graph (M != N, Dc != Dq, a check and
qubits of degree 0).  Inputs are made from a seed with NumPy; JAX's pallas
backend runs its Pallas kernel in interpret mode, as tests/kernels/ runs it.
Tolerance: f32 atol 1e-5 (the same sums in another order; every value is
O(1) and a row sums at most 6 messages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn import mp as jmp
from tpugnn.tanner import build_code as jax_build_code
from tpugnn.tanner import build_tanner_graph as jax_build_tanner_graph
from tpugnn_torch import mp
from tpugnn_torch.tanner import build_code, build_tanner_graph

torch.set_num_threads(1)

ATOL = 1e-5
BACKENDS = ["segment", "dense", "ell", "pallas"]
AGGS = ["sum", "mean", "max"]
GRAPHS = ["surface3", "surface5", "toric3", "lopsided"]


def _lopsided_checks():
    """A CSS pair with 5 checks (one empty) on 12 qubits (four in no check):
    m_pad 8 != n_pad 16, check degree up to 6, qubit degree up to 3."""
    hx = np.zeros((2, 12), np.uint8)
    hx[0, :4] = 1
    hx[1, 2:8] = 1
    hz = np.zeros((3, 12), np.uint8)
    hz[0, :2] = 1
    hz[1, 2:4] = 1
    return hx, hz


def graphs(name):
    """(JAX graph, the port's graph with tensors on the CPU)."""
    if name == "lopsided":
        hx, hz = _lopsided_checks()
        return (jax_build_tanner_graph(hx, hz, name="lopsided"),
                build_tanner_graph(hx, hz, name="lopsided").to("cpu"))
    family, d = name[:-1], int(name[-1])
    return jax_build_code(family, d), build_code(family, d).to("cpu")


def _states(g, b=3, f=8, seed=0):
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, g.n_checks_pad, f)).astype(np.float32)
    xq = rng.standard_normal((b, g.n_qubits_pad, f)).astype(np.float32)
    msg = rng.standard_normal((b, g.n_edges_pad, f)).astype(np.float32)
    return xc, xq, msg


def _close(got, ref, atol=ATOL):
    assert got.dtype == torch.float32 and str(np.asarray(ref).dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_lopsided_graph_equals_tpugnn():
    """The lopsided pair builds the same graph in both packages, with the
    degree-0 rows the engine tests rely on."""
    jg, tg = graphs("lopsided")
    for f in ("edge_check", "edge_qubit", "edge_mask", "check_deg", "qubit_deg",
              "ell_check_edge", "ell_check_mask", "ell_qubit_edge", "ell_qubit_mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    assert (tg.n_checks_pad, tg.n_qubits_pad) == (8, 16)
    assert (tg.deg_max_check, tg.deg_max_qubit) == (6, 3)
    real_deg_c = tg.ell_check_mask.sum(1)[:tg.n_checks]
    real_deg_q = tg.ell_qubit_mask.sum(1)[:tg.n_qubits]
    assert (real_deg_c == 0).any() and (real_deg_q == 0).any()


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_gather_endpoints_matches_tpugnn(backend, graph):
    jg, tg = graphs(graph)
    xc, xq, _ = _states(jg, seed=1)
    ref_c, ref_q = jmp.gather_endpoints(jg, jnp.asarray(xc), jnp.asarray(xq), backend=backend)
    got_c, got_q = mp.gather_endpoints(tg, torch.from_numpy(xc), torch.from_numpy(xq),
                                       backend=backend)
    _close(got_c, ref_c)
    _close(got_q, ref_q)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_aggregate_matches_tpugnn(backend, agg, graph):
    """Both directions.  dense+max is JAX's segment route (aggregate.py:170-181),
    so it is held against JAX's dense+max all the same."""
    jg, tg = graphs(graph)
    _, _, msg = _states(jg, seed=2)
    for jfn, tfn in ((jmp.aggregate_to_checks, mp.aggregate_to_checks),
                     (jmp.aggregate_to_qubits, mp.aggregate_to_qubits)):
        ref = jfn(jg, jnp.asarray(msg), backend=backend, agg=agg)
        got = tfn(tg, torch.from_numpy(msg), backend=backend, agg=agg)
        _close(got, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_aggregate_bf16_messages_match_tpugnn(backend):
    """bf16 messages: the mask multiply promotes them to f32 in both
    packages, and every backend returns what the JAX backend returns (the
    same type, the same values to f32 reassociation)."""
    jg, tg = graphs("surface3")
    _, _, msg = _states(jg, seed=3)
    msg = np.array(jnp.asarray(msg, jnp.bfloat16).astype(jnp.float32))
    for agg in AGGS:
        ref = jmp.aggregate_to_checks(jg, jnp.asarray(msg, jnp.bfloat16), backend=backend,
                                      agg=agg)
        got = mp.aggregate_to_checks(tg, torch.from_numpy(msg).bfloat16(), backend=backend,
                                     agg=agg)
        _close(got, ref)


def test_max_keeps_negative_rows_and_zeroes_empty_ones():
    """A row whose every message is negative keeps its negative max; only
    rows without a real edge give 0 (tests/kernels/test_spmm.py's case)."""
    jg, tg = graphs("lopsided")
    _, _, msg = _states(jg, seed=4)
    msg = -np.abs(msg) - 0.5
    for backend in BACKENDS:
        got = mp.aggregate_to_checks(tg, torch.from_numpy(msg), backend=backend, agg="max")
        ref = jmp.aggregate_to_checks(jg, jnp.asarray(msg), backend=backend, agg="max")
        _close(got, ref)
        real = tg.ell_check_mask.sum(1) > 0
        assert (got[:, real] < 0).all() and (got[:, ~real] == 0).all()


def _message_fns(lib):
    tanh = jnp.tanh if lib is jnp else torch.tanh
    return (lambda c, q, _: tanh(c) * q), (lambda c, q, _: c + 0.5 * q)


@pytest.mark.parametrize("graph", ["surface5", "lopsided"])
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_propagate_and_bipartite_round_match_tpugnn(backend, agg, graph):
    jg, tg = graphs(graph)
    xc, xq, _ = _states(jg, seed=5)
    jx = (jnp.asarray(xc), jnp.asarray(xq))
    tx = (torch.from_numpy(xc), torch.from_numpy(xq))
    (jm_q, jm_c), (tm_q, tm_c) = _message_fns(jnp), _message_fns(torch)
    for to in ("check", "qubit"):
        ref = jmp.propagate(jg, *jx, jm_c, to=to, aggr=agg, backend=backend,
                            update_fn=lambda x, a: x - a)
        got = mp.propagate(tg, *tx, tm_c, to=to, aggr=agg, backend=backend,
                           update_fn=lambda x, a: x - a)
        _close(got, ref)
    ref = jmp.bipartite_round(jg, jmp.NodeStates(*jx), message_to_qubit=jm_q,
                              message_to_check=jm_c, update_check=lambda x, a: x + a,
                              update_qubit=lambda x, a: x - a, aggr=agg, backend=backend)
    got = mp.bipartite_round(tg, mp.NodeStates(*tx), message_to_qubit=tm_q,
                             message_to_check=tm_c, update_check=lambda x, a: x + a,
                             update_qubit=lambda x, a: x - a, aggr=agg, backend=backend)
    _close(got.check, ref.check)
    _close(got.qubit, ref.qubit)


def _bp_layer(base, lib, aggr, flow, backend):
    """The BPLayer of the MessagePassing docstring, on either package."""
    tanh = jnp.tanh if lib is jnp else torch.tanh

    class BPLayer(base):
        def __init__(self):
            super().__init__(aggr=aggr, flow=flow, backend=backend)

        def message(self, x_i, x_j, edge_attr):
            return tanh(x_i + x_j)

        def update(self, aggr_out, x):
            return x + aggr_out

    return BPLayer()


@pytest.mark.parametrize("flow", ["qubit->check", "check->qubit"])
@pytest.mark.parametrize("aggr", AGGS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_message_passing_adapter_matches_tpugnn(backend, aggr, flow):
    jg, tg = graphs("toric3")
    xc, xq, _ = _states(jg, seed=6)
    ref = _bp_layer(jmp.MessagePassing, jnp, aggr, flow, backend)(
        jg, jnp.asarray(xc), jnp.asarray(xq))
    got = _bp_layer(mp.MessagePassing, torch, aggr, flow, backend)(
        tg, torch.from_numpy(xc), torch.from_numpy(xq))
    _close(got, ref)


def test_global_node_sum_and_bad_arguments():
    from tpugnn.mp.aggregate import global_node_sum as jax_global_node_sum

    jg, tg = graphs("lopsided")
    xc, xq, msg = _states(jg, seed=7)
    for which, x in (("check", xc), ("qubit", xq)):
        _close(mp.global_node_sum(tg, torch.from_numpy(x), which=which),
               jax_global_node_sum(jg, jnp.asarray(x), which=which))
    with pytest.raises(ValueError, match="backend"):
        mp.aggregate_to_checks(tg, torch.from_numpy(msg), backend="scatter")
    with pytest.raises(ValueError, match="aggregation"):
        mp.aggregate_to_qubits(tg, torch.from_numpy(msg), agg="min")
    with pytest.raises(ValueError, match="check"):
        mp.propagate(tg, torch.from_numpy(xc), torch.from_numpy(xq),
                     lambda c, q, _: c, to="edge")
    with pytest.raises(ValueError, match="flow"):
        mp.MessagePassing(flow="check->check")
