"""The port's sliding-window streaming decoder (tpugnn_torch.streaming)
against the JAX package's.

* ``sample_stream`` draws the JAX package's streams from the same
  ``default_rng`` seed, exactly.
* ``from_union_find`` and ``from_mwpm`` decode those streams bit-equal to
  JAX's; the union-find stream and monolithic rates of the shipped window
  checkpoint's sidecar are reproduced exactly at its settings.
* A random H=32, R=2 bits-head model carried across by the weight
  conversion: ``from_gnn`` (with and without deferral), ``from_gnn_device``
  and ``from_gnn_cleanup`` (union-find and MWPM) give JAX's window
  corrections on every shot none of whose logits lies within 1e-4 of 0
  (a sign there is f32 rounding, not the port).
* tests/test_streaming.py's cases on the port: a zero stream, single data
  and measurement faults, the tiling check, streaming against monolithic
  union-find, MWPM windows, a closed cleanup gate equal to union-find, and
  a cleanup stream without residual syndrome.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import ModelConfig as JaxModelConfig
from tpugnn.models import GNNDecoder as JaxGNNDecoder
from tpugnn.streaming import SlidingWindowDecoder as JaxSWD
from tpugnn.streaming import sample_stream as jax_sample_stream
from tpugnn_torch.configs import ModelConfig
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.models.convert import STREAM_D5_WEIGHTS, params_from_flax, read_columns
from tpugnn_torch.streaming import SlidingWindowDecoder, sample_stream, stream_ler
from tpugnn_torch.tanner.spacetime import sector_checks
from tpugnn_torch.utils import f2

torch.set_num_threads(1)


@pytest.mark.parametrize("sector", ["z", "x"])
def test_sample_stream_equals_jax(sector):
    kw = dict(p=0.05, rounds=7, batch=16, sector=sector, meas_ratio=0.5)
    got = sample_stream(np.random.default_rng(5), "surface", 3, **kw)
    ref = jax_sample_stream(np.random.default_rng(5), "surface", 3, **kw)
    for a, b in zip(got, ref):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


CLASSICAL = [("from_union_find", {}), ("from_mwpm", {}), ("from_mwpm", {"p": 0.03})]


@pytest.mark.parametrize("adapter,kw", CLASSICAL, ids=["uf", "mwpm", "mwpm_weighted"])
@pytest.mark.parametrize("family,d,w,c,t", [("surface", 3, 3, 1, 7), ("surface", 5, 4, 2, 8),
                                            ("repetition", 5, 4, 2, 10)])
def test_classical_streams_bit_equal(adapter, kw, family, d, w, c, t):
    s_hat, _ = sample_stream(np.random.default_rng(d + t), family, d, p=0.03, rounds=t,
                             batch=64)
    got = getattr(SlidingWindowDecoder, adapter)(family, d, window=w, commit=c,
                                                 **kw).decode_stream(s_hat)
    ref = getattr(JaxSWD, adapter)(family, d, window=w, commit=c, **kw).decode_stream(s_hat)
    assert got.shape == (64, d * d if family == "surface" else d)
    np.testing.assert_array_equal(got, ref)


def test_sidecar_union_find_rates_reproduced():
    """chip_smoke.py gates the card's uf_stream and uf_monolithic on these
    recorded JAX rates: the same numpy streams through the same C++
    decoder give them exactly."""
    st = read_columns(STREAM_D5_WEIGHTS)["stream"]
    kw = dict(window=st["window"], commit=st["commit"])
    decs = {"uf_stream": SlidingWindowDecoder.from_union_find("surface", 5, **kw),
            "uf_monolithic": SlidingWindowDecoder.from_union_find(
                "surface", 5, window=st["rounds"], commit=st["rounds"])}
    for name, dec in decs.items():
        r = stream_ler(dec, p=st["p"], rounds=st["rounds"], shots=st["shots"], seed=st["seed"],
                       batch=st["batch"])
        assert r["ler"] == st["rates"][name], name
        assert r["windows"] == -(-st["shots"] // st["batch"]) * dec.n_windows(st["rounds"])


@pytest.fixture(scope="module")
def gnn_pair():
    """A window model (surface d=3, window 3, H=32, R=2, bits head) of each
    package on the same converted parameters."""
    jdec = JaxSWD.from_union_find("surface", 3, window=3, commit=1)
    jg = jdec.graph
    kw = dict(hidden=32, msg_hidden=32, rounds=2, qubit_head="bits", readout="both")
    jm = JaxGNNDecoder(JaxModelConfig(backend="fused", **kw), k=jg.k)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.zeros((2, jg.n_checks_pad)))
    tm = GNNDecoder(ModelConfig(backend="fused", **kw), k=jg.k)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


def _windows(dec, seed, batch=64, rounds=6):
    """The detector windows a stream presents (the first window of each
    offset, frames re-referenced by nothing committed)."""
    s_hat, _ = sample_stream(np.random.default_rng(seed), "surface", 3, p=0.04,
                             rounds=rounds, batch=batch)
    w, m = dec.window, dec.m
    out = []
    for off in range(rounds - w + 1):
        det = np.zeros((batch, w, m), np.uint8)
        det[:, 0] = s_hat[:, off]
        det[:, 1:] = s_hat[:, off + 1:off + w] ^ s_hat[:, off:off + w - 1]
        flat = np.zeros((batch, dec.graph.n_checks_pad), np.uint8)
        flat[:, :w * m] = det.reshape(batch, -1)
        out.append(flat)
    return np.concatenate(out)


GNN_ADAPTERS = [("from_gnn", {}), ("from_gnn", {"defer_inconsistent": False}),
                ("from_gnn_device", {}), ("from_gnn_cleanup", {}),
                ("from_gnn_cleanup", {"cleanup": "mwpm", "p": 0.04}),
                ("from_gnn_cleanup", {"tau": 0.8})]


@pytest.mark.parametrize("adapter,kw", GNN_ADAPTERS,
                         ids=["raw", "raw_no_defer", "device", "uf", "mwpm", "uf_tau"])
def test_gnn_window_corrections_equal_jax(gnn_pair, adapter, kw):
    jm, params, tm = gnn_pair
    dec = getattr(SlidingWindowDecoder, adapter)("surface", 3, window=3, commit=1, model=tm,
                                                 device="cpu", **kw)
    jdec = getattr(JaxSWD, adapter)("surface", 3, window=3, commit=1, apply_fn=jm.apply,
                                    params=params, **kw)
    flat = _windows(dec, 7)
    got = dec._decode_window(flat)
    ref = np.asarray(jdec._decode_window(flat)).astype(np.uint8)
    n = dec.graph.n_qubits
    with torch.inference_mode():
        lg = tm(dec.graph.to("cpu"), torch.from_numpy(flat).float()).qubit_logits[:, :n]
    sure = (lg.abs() > 1e-4).all(-1).all(-1).numpy()
    assert sure.mean() > 0.9
    assert got.dtype == np.uint8 and got.shape[0] == flat.shape[0]
    cols = min(got.shape[1], ref.shape[1])
    np.testing.assert_array_equal(got[sure, :cols], ref[sure, :cols])
    s = (got[:, :n] @ np.asarray(dec.graph.h_syn_ex)[:, :n].T) % 2
    consistent = (s == flat).all(1)
    if adapter != "from_gnn":           # repaired or cleaned: every window
        assert consistent.all()
    elif kw.get("defer_inconsistent", True):   # deferred: consistent or zero
        assert (consistent | ~got.any(1)).all()


def test_gnn_device_stream_agrees_with_jax(gnn_pair):
    """Whole streams through the repaired GNN windows: a near-zero logit in
    one window moves every later frame, so streams are compared per shot
    (>= 95% equal) and the port's decode is repeatable."""
    jm, params, tm = gnn_pair
    s_hat, _ = sample_stream(np.random.default_rng(2), "surface", 3, p=0.02, rounds=5,
                             batch=64)
    dec = SlidingWindowDecoder.from_gnn_device("surface", 3, window=3, commit=1, model=tm,
                                               device="cpu")
    jdec = JaxSWD.from_gnn_device("surface", 3, window=3, commit=1, apply_fn=jm.apply,
                                  params=params)
    got, ref = dec.decode_stream(s_hat), jdec.decode_stream(s_hat)
    assert got.shape == (64, 9)
    assert (got == ref).all(1).mean() >= 0.95
    e1 = dec.decode_stream(s_hat)
    np.testing.assert_array_equal(got, e1)


def _logical(dec):
    hx, hz = sector_checks(dec.family, dec.distance)
    lx, lz = f2.css_logicals(hx, hz)
    return lz if dec.sector == "z" else lx


def test_zero_stream_zero_correction():
    dec = SlidingWindowDecoder.from_union_find("repetition", 5, window=4, commit=2)
    e = dec.decode_stream(np.zeros((3, 8, dec.m), np.uint8))
    assert e.shape == (3, dec.n) and not e.any()


def test_single_data_fault_corrected_exactly():
    d, t_rounds = 5, 10
    dec = SlidingWindowDecoder.from_union_find("repetition", d, window=4, commit=2)
    for tau in (0, 3, 6, 9):
        for q in range(d):
            e = np.zeros((1, t_rounds, d), np.uint8)
            e[0, tau, q] = 1
            cum = np.bitwise_xor.accumulate(e, axis=1)
            res = cum[:, -1] ^ dec.decode_stream((cum @ dec.h.T % 2).astype(np.uint8))
            assert not res.any(), (tau, q)


def test_single_measurement_fault_no_logical_damage():
    d, t_rounds = 5, 8
    dec = SlidingWindowDecoder.from_union_find("repetition", d, window=4, commit=2)
    for tau in (0, 2, 5):
        for c in range(dec.m):
            s_hat = np.zeros((1, t_rounds, dec.m), np.uint8)
            s_hat[0, tau, c] = 1
            res = dec.decode_stream(s_hat)[0]
            assert not ((res @ dec.h.T) % 2).any(), (tau, c)
            assert res.sum() < d, (tau, c)


def test_stream_requires_tiling_and_a_decoder():
    dec = SlidingWindowDecoder.from_union_find("repetition", 3, window=4, commit=2)
    with pytest.raises(ValueError, match="window"):
        dec.decode_stream(np.zeros((1, 5, dec.m), np.uint8))
    with pytest.raises(ValueError, match="checks"):
        dec.decode_stream(np.zeros((1, 6, dec.m + 1), np.uint8))
    with pytest.raises(ValueError, match="commit"):
        SlidingWindowDecoder("repetition", 3, window=2, commit=3)
    with pytest.raises(ValueError, match="no window decoder"):
        SlidingWindowDecoder("repetition", 3, window=2, commit=1).decode_stream(
            np.zeros((1, 4, 2), np.uint8))


def test_streaming_ler_tracks_monolithic():
    d, t_rounds, shots, p = 5, 8, 400, 0.03
    stream_dec = SlidingWindowDecoder.from_union_find("repetition", d, window=4, commit=2)
    mono_dec = SlidingWindowDecoder.from_union_find("repetition", d, window=t_rounds,
                                                    commit=t_rounds)
    ler_s = stream_ler(stream_dec, p=p, rounds=t_rounds, shots=shots, seed=3)
    ler_m = stream_ler(mono_dec, p=p, rounds=t_rounds, shots=shots, seed=3)
    s_hat, e_net = sample_stream(np.random.default_rng(3), "repetition", d, p=p,
                                 rounds=t_rounds, batch=shots)
    no_decode = float(np.logical_or((e_net @ stream_dec.h.T % 2).any(axis=1),
                                    (e_net @ _logical(stream_dec).T % 2).any(axis=1)).mean())
    assert ler_s["ler"] < no_decode * 0.5
    assert ler_s["ler"] <= ler_m["ler"] + 3 * (ler_m["ler_stderr"] + 0.02)
    assert ler_s["windows"] == 2 * stream_dec.n_windows(t_rounds) == 6


def test_mwpm_window_decoder():
    dec = SlidingWindowDecoder.from_mwpm("repetition", 5, window=4, commit=2)
    for tau, q in ((0, 2), (5, 0), (9, 4)):
        e = np.zeros((1, 10, 5), np.uint8)
        e[0, tau, q] = 1
        cum = np.bitwise_xor.accumulate(e, axis=1)
        res = cum[:, -1] ^ dec.decode_stream((cum @ dec.h.T % 2).astype(np.uint8))
        assert not res.any(), (tau, q)
    mw = stream_ler(dec, p=0.04, rounds=8, shots=400, seed=3)
    uf = stream_ler(SlidingWindowDecoder.from_union_find("repetition", 5, window=4, commit=2),
                    p=0.04, rounds=8, shots=400, seed=3)
    assert mw["ler"] <= uf["ler"] + 3 * uf["ler_stderr"]


def _random_model(graph, seed):
    cfg = ModelConfig(hidden=8, msg_hidden=8, rounds=2, backend="segment",
                      readout="per_qubit")
    return GNNDecoder(cfg, k=graph.k).init_random(torch.Generator().manual_seed(seed)).eval()


def test_gnn_cleanup_closed_gate_equals_uf():
    dec_uf = SlidingWindowDecoder.from_union_find("repetition", 3, window=3, commit=1)
    dec = SlidingWindowDecoder.from_gnn_cleanup("repetition", 3, window=3, commit=1,
                                                model=_random_model(dec_uf.graph, 0),
                                                tau=1.5, device="cpu")
    s_hat, _ = sample_stream(np.random.default_rng(1), "repetition", 3, p=0.1, rounds=5,
                             batch=8)
    np.testing.assert_array_equal(dec.decode_stream(s_hat), dec_uf.decode_stream(s_hat))


def test_gnn_cleanup_stream_is_syndrome_consistent():
    dec0 = SlidingWindowDecoder.from_union_find("repetition", 5, window=3, commit=1)
    dec = SlidingWindowDecoder.from_gnn_cleanup("repetition", 5, window=3, commit=1,
                                                model=_random_model(dec0.graph, 2),
                                                device="cpu")
    s_hat, e_net = sample_stream(np.random.default_rng(3), "repetition", 5, p=0.05, rounds=7,
                                 batch=32)
    res = e_net ^ dec.decode_stream(s_hat)
    assert not ((res @ dec.h.T) % 2).any()


def test_unknown_cleanup_refused(gnn_pair):
    with pytest.raises(ValueError, match="cleanup"):
        SlidingWindowDecoder.from_gnn_cleanup("surface", 3, window=3, commit=1,
                                              model=gnn_pair[2], cleanup="bp", device="cpu")
