"""GNN + classical-cleanup hybrid decoding.

The port of ``tpugnn.eval.hybrid``.  The deployed hybrid rule of
:mod:`tpugnn_torch.eval.ler` falls back to the logical-class head whenever
the per-qubit correction is syndrome-inconsistent.  This module implements
the stronger decode-time rule

    e_hat = e_gnn  XOR  cleanup(s XOR H @ e_gnn)

i.e. the GNN removes the bulk of the error pattern and a classical decoder
(union-find or exact MWPM) repairs the *residual* syndrome, so the combined
correction is syndrome-consistent by construction.  With ``tau`` set, only
qubit flips whose posterior max-probability reaches ``tau`` are kept (the
rest are left to the cleanup decoder).  Best-of selection commits, per shot,
the lightest of several consistent candidates.

Everything before the host decodes runs on the device in one
``torch.inference_mode()`` chunk: sampling, the forward, the gated
corrections, the residual syndrome, the logical-head realisation and the
uint8 casts.  The chunk's outputs are copied into pinned host buffers
without blocking, and a pool of host threads decodes chunk i (the C++
decoders and the BLAS products release the GIL) while the card runs the
chunks after it.

Shots come from a ``torch.Generator`` drawn exactly as
:func:`tpugnn_torch.eval.ler.ler_monte_carlo` draws them, so on the same
seed ``ler_all_columns``' plain columns equal ``ler_monte_carlo``'s shot for
shot, and its cleanup columns equal ``ler_gnn_cleanup``'s and
``ler_best_of``'s.  Graphs are the NumPy ``TannerGraph``; the model and the
device tensors live on ``device`` (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from tpugnn_torch.eval.ler import count_failures, decode_corrections
from tpugnn_torch.sampling.noise import sample_batch, syndrome
from tpugnn_torch.tanner.graph import TannerGraph
from tpugnn_torch.utils.device import resolve_device

__all__ = ["gnn_cleanup_corrections", "ler_gnn_cleanup", "ler_best_of",
           "ler_all_columns", "logical_head_correction", "min_weight_select",
           "lazy_decode"]

# chunks whose host work may run at once, and chunks in flight on the device
HOST_WORKERS = 4


def lazy_decode(dec, syn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run a classical decoder only on rows with a nonzero syndrome.

    Zero-syndrome rows map to the zero correction for both union-find and
    MWPM (no defects -> no clusters / no matching -> no flips), so this is
    exact, not approximate.  For the residual-syndrome cleanup decodes the
    GNN leaves most shots with an empty residual, so this removes the
    per-shot matcher cost for the majority of the batch.
    """
    syn = np.asarray(syn)
    nz = np.flatnonzero(syn.any(axis=1))
    n = dec.graph.n_qubits
    ex = np.zeros((syn.shape[0], n), np.uint8)
    ez = np.zeros((syn.shape[0], n), np.uint8)
    if nz.size:
        exn, ezn = dec.decode(syn[nz])
        ex[nz] = exn.astype(np.uint8)
        ez[nz] = ezn.astype(np.uint8)
    return ex, ez


NLP_SCALE = 16.0  # uint8 neg-log-prob quantization: 1/16 nat per level


class _Parity:
    """x -> (x @ h.T) mod 2 for a 0/1 table ``h`` [r, n] and 0/1 uint8 rows
    x [B, n], by gathering each row's support and XOR-reducing it.  No BLAS:
    these products are small, and a threaded BLAS called from the host
    worker threads ran them over ten times slower than one thread does."""

    def __init__(self, h: np.ndarray):
        h = np.asarray(h) != 0
        r, n = h.shape
        w = max(1, int(h.sum(axis=1).max(initial=0)))
        self.idx = np.full((r, w), n, np.int64)        # n: a zero column
        for i in range(r):
            nz = np.flatnonzero(h[i])
            self.idx[i, :len(nz)] = nz
        self.n = n

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.uint8)[:, : self.n]
        ext = np.concatenate([x, np.zeros((x.shape[0], 1), np.uint8)], axis=1)
        return np.bitwise_xor.reduce(ext[:, self.idx], axis=2) & 1


def min_weight_select(cand_names, cands, syn, hz, hx, *,
                      qubit_inconsistent: np.ndarray | None = None,
                      nlp: np.ndarray | None = None):
    """Per-shot minimum-cost selection over candidate corrections.

    ``cands`` maps name -> (ex, ez) uint8 [B, n]; ``syn`` is the observed
    syndrome uint8 [B, >=n_checks].  The cleanup/matcher candidates are
    syndrome-consistent by construction; the "qubit" and "logical" heads
    are consistency-gated (infinite weight on mismatch).  Returns
    (ex_hat, ez_hat, choice[B]); ties go to the first candidate.

    Two cost rules:

    * default: the Y-aware depolarizing weight |support(ex OR ez)|
      (X, Y, Z equiprobable single events, so a Y costs ONE unit);
    * ``nlp`` given: posterior likelihood selection, candidate cost =
      sum_q -log p_q(class of candidate at q) under the GNN's own per-qubit
      posterior (``nlp`` uint8 [B, n, 4] in 1/16-nat units, class =
      ex + 2 ez; see _nlp4).

    ``qubit_inconsistent`` (bool [B]): precomputed consistency gate for the
    "qubit" candidate (s_res nonzero).  Parities are exact (XOR over each
    check's support).
    """
    bsz = next(iter(cands.values()))[0].shape[0]
    weights = np.full((len(cand_names), bsz), np.inf)
    nlp_f = None if nlp is None else nlp.astype(np.float32)
    par_z = par_x = None
    for i, name in enumerate(cand_names):
        cex, cez = cands[name]
        if nlp_f is not None:
            cls = (cex + 2 * cez).astype(np.int64)  # [B, n] in {0..3}
            w = np.take_along_axis(
                nlp_f, cls[:, :, None], axis=2
            )[:, :, 0].sum(axis=1).astype(np.float64) / NLP_SCALE
        else:
            w = (cex | cez).sum(axis=1).astype(np.float64)
        if name in ("qubit", "logical"):
            if name == "qubit" and qubit_inconsistent is not None:
                sm = qubit_inconsistent
            else:
                if par_z is None:
                    par_z, par_x = _Parity(hz), _Parity(hx)
                s_hat = par_z(cex) ^ par_x(cez)
                sm = (s_hat != syn[:, : hz.shape[0]]).any(axis=1)
            w = np.where(sm, np.inf, w)
        weights[i] = w
    choice = np.argmin(weights, axis=0)
    ex_hat = np.take_along_axis(
        np.stack([cands[c][0] for c in cand_names]),
        choice[None, :, None], axis=0)[0]
    ez_hat = np.take_along_axis(
        np.stack([cands[c][1] for c in cand_names]),
        choice[None, :, None], axis=0)[0]
    return ex_hat, ez_hat, choice


def _gated_corrections(qubit_logits: torch.Tensor, tau: float | None):
    """Hard (ex, ez) from logits, optionally zeroed below confidence tau."""
    ex, ez = decode_corrections(qubit_logits)
    if tau is None:
        return ex, ez
    if qubit_logits.shape[-1] == 4:
        conf = torch.softmax(qubit_logits, dim=-1).amax(dim=-1)
    else:
        # sigmoid bits: confidence = max(p, 1-p) of the chosen bit, jointly
        p = torch.sigmoid(qubit_logits)
        conf = torch.prod(torch.maximum(p, 1.0 - p), dim=-1)
    keep = (conf >= tau).float()
    return ex * keep, ez * keep


def _nlp4(qubit_logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Per-qubit 4-class negative log-probs, uint8-quantized (1/16 nat).

    pauli4 head: -log_softmax over [I, X, Z, Y].  bits head (2 sigmoid
    logits): the two bits are modeled independent, so
    -log p(ex, ez) = -log p_x(ex) - log p_z(ez), in the class order
    I, X, Z, Y (class = ex + 2 ez).  ``temperature`` > 1 softens the
    posterior first.  Rounds half to even, then clips to 0..255.  Callers
    read ``TPUGNN_NLL_TEMP`` once, at call or engine-init time, and pass
    the value.
    """
    t = float(temperature)
    if t != 1.0:
        qubit_logits = qubit_logits / t
    if qubit_logits.shape[-1] == 4:
        nlp = -torch.log_softmax(qubit_logits, dim=-1)
    else:
        lx = qubit_logits[..., 0]
        lz = qubit_logits[..., 1]
        nx1 = -F.logsigmoid(lx)
        nx0 = -F.logsigmoid(-lx)
        nz1 = -F.logsigmoid(lz)
        nz0 = -F.logsigmoid(-lz)
        nlp = torch.stack([nx0 + nz0, nx1 + nz0, nx0 + nz1, nx1 + nz1], dim=-1)
    q = torch.round(nlp * NLP_SCALE)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8)


def logical_head_correction(graph: TannerGraph, syndrome_batch: torch.Tensor,
                            logical_logits: torch.Tensor):
    """Realize the logical-class head's prediction as a physical correction.

    e_hat = (pure error T @ s) XOR the predicted logical representatives:
    bx selects lx_i, bz selects lz_i (the symplectic pairing used by
    sampling.logical_class_bits, so <lz_i, ex_hat XOR ex0> = bx_i).
    Syndrome-consistent by construction.  ``graph`` holds tensors
    (``TannerGraph.to``) on the syndrome's device.
    """
    s = syndrome_batch
    b = (logical_logits > 0.0).float()
    k = graph.k
    bx, bz = b[..., :k], b[..., k:]
    ex0 = torch.remainder(s @ graph.pure_ex.T, 2.0)
    ez0 = torch.remainder(s @ graph.pure_ez.T, 2.0)
    ex = torch.remainder(ex0 + bx @ graph.logicals_x, 2.0)
    ez = torch.remainder(ez0 + bz @ graph.logicals_z, 2.0)
    return ex, ez


def _residual(dg: TannerGraph, syn: torch.Tensor, ex: torch.Tensor,
              ez: torch.Tensor) -> torch.Tensor:
    """The syndrome a correction leaves unexplained: s XOR H e (f32 0/1)."""
    return torch.remainder(syn + syndrome(dg, ex, ez), 2.0)


def _device_start(device: torch.device):
    """A timing event recorded on the current stream of a card (None on the
    CPU): the start of a chunk's span on the device."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _HostCopy:
    """Tensors on their way to host memory without blocking the caller.

    On a card each tensor is copied into a pinned host buffer with
    ``non_blocking=True`` and a CUDA event is recorded after the copies;
    :meth:`numpy` waits on the event alone (the caller's thread goes on
    launching).  On the CPU the tensors are the buffers.  With ``start``
    (from :func:`_device_start`), :meth:`device_ms` is the chunk's span on
    the device's stream, from ``start`` to the end of the copies."""

    def __init__(self, tensors: dict, start=None):
        self._bufs, self._event, self._start = {}, None, start
        for k, t in tensors.items():
            if t is not None and t.device.type == "cuda":
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t = buf
                self._event = self._event or torch.cuda.Event(
                    enable_timing=start is not None)
            self._bufs[k] = t
        if self._event is not None:
            self._event.record()

    def numpy(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return {k: None if t is None else t.numpy() for k, t in self._bufs.items()}

    def device_ms(self) -> float | None:
        """The span on the device (after :meth:`numpy`); None on the CPU."""
        if self._start is None or self._event is None:
            return None
        return self._start.elapsed_time(self._event)


@torch.inference_mode()
def _chunk(model, dg: TannerGraph, syn: torch.Tensor, tau: float | None, *,
           batch=None, with_logical: bool = True, with_nlp: bool = False,
           nll_temp: float = 1.0) -> dict:
    """One chunk on the device: the forward on ``syn``, the gated
    corrections and their residual, the logical head's realisation (the
    gated correction for a model without one) and, when ``batch`` (the
    sampled SyndromeBatch behind ``syn``) is given, the failure sums of the
    plain columns.  Bits leave as uint8."""
    out = model(dg, syn)
    ex_g, ez_g = _gated_corrections(out.qubit_logits, tau)
    s_res = _residual(dg, syn, ex_g, ez_g)
    u8 = lambda x: x.to(torch.uint8)
    res = {"syn": u8(syn), "ex_g": u8(ex_g), "ez_g": u8(ez_g), "s_res": u8(s_res)}
    if with_logical:
        # fallback realisation of the "logical" candidate for models without
        # a logical head: the GATED qubit correction
        lex, lez = (logical_head_correction(dg, syn, out.logical_logits)
                    if out.logical_logits is not None else (ex_g, ez_g))
        res.update(lex=u8(lex), lez=u8(lez))
    if batch is not None:
        ex, ez = decode_corrections(out.qubit_logits)
        fails = count_failures(dg, batch, ex, ez, out.logical_logits)
        res.update(ex=u8(batch.ex), ez=u8(batch.ez),
                   sums=torch.stack([v.sum() for v in fails.values()]))
        res["sum_names"] = tuple(fails)
    if with_nlp:
        res["nlp"] = _nlp4(out.qubit_logits, nll_temp)
    return res


def _launch(model, dg, generator, p, batch: int, tau, **kw):
    """Sample one chunk from ``generator`` (as ``ler_monte_carlo`` does) and
    run it on the device; returns its host copy."""
    start = _device_start(generator.device)
    b = sample_batch(generator, dg, p, batch)
    res = _chunk(model, dg, b.syndrome, tau, batch=b, **kw)
    names = res.pop("sum_names")
    return names, _HostCopy(res, start)


def gnn_cleanup_corrections(model, graph: TannerGraph, syndrome_batch, cleanup_decoder, *,
                            tau: float | None = None, device="cuda"):
    """Decode one batch: GNN correction + classical cleanup of the residual.

    ``syndrome_batch``: [B, n_checks_pad] in {0, 1} (NumPy or a tensor);
    ``cleanup_decoder.decode(syndrome [B, n_checks_pad]) -> (ex, ez)`` over
    the unpadded ``n_qubits`` (the UnionFindDecoder / MWPMDecoder API).
    Returns host uint8 arrays (ex_hat, ez_hat) of shape [B, n_qubits].
    """
    dev = resolve_device(device)
    dg = graph.to(dev)
    syn = torch.as_tensor(syndrome_batch).to(device=dev, dtype=torch.float32)
    h = _HostCopy(_chunk(model.to(dev), dg, syn, tau, with_logical=False)).numpy()
    n = graph.n_qubits
    ex_u, ez_u = lazy_decode(cleanup_decoder, h["s_res"])
    return h["ex_g"][:, :n] ^ ex_u, h["ez_g"][:, :n] ^ ez_u


def _parity_tables(graph: TannerGraph):
    n = graph.n_qubits
    hx = np.asarray(graph.h_syn_ez)[: graph.n_checks, :n].astype(np.uint8)
    hz = np.asarray(graph.h_syn_ex)[: graph.n_checks, :n].astype(np.uint8)
    lx = np.asarray(graph.logicals_x)[:, :n].astype(np.uint8)
    lz = np.asarray(graph.logicals_z)[:, :n].astype(np.uint8)
    return hx, hz, lx, lz


def _failure_fn(graph: TannerGraph) -> Callable:
    """``fail(cex, cez, ex, ez)`` -> (fails, mismatches), bool [B] each: the
    correction leaves a nonzero syndrome or flips a logical, and the first of
    the two alone."""
    n = graph.n_qubits
    hx, hz, lx, lz = _parity_tables(graph)
    par_hz, par_hx, par_lz, par_lx = map(_Parity, (hz, hx, lz, lx))

    def fail_of(cex, cez, ex, ez):
        rx = (ex[:, :n] ^ cex) & 1
        rz = (ez[:, :n] ^ cez) & 1
        sm = par_hz(rx).any(axis=1) | par_hx(rz).any(axis=1)
        lf = par_lz(rx).any(axis=1) | par_lx(rz).any(axis=1)
        return sm | lf, sm

    return fail_of


def _stderr(ler: float, total: int) -> float:
    return (max(ler * (1 - ler), 1e-12) / total) ** 0.5


def _run_chunks(n_chunks: int, launch: Callable, host: Callable, collect: Callable) -> None:
    """Launch ``n_chunks`` device chunks in order, hand each one's host copy
    to ``host`` on a pool of HOST_WORKERS threads, and pass the results to
    ``collect`` in chunk order; at most HOST_WORKERS + 1 chunks are in
    flight."""
    with ThreadPoolExecutor(max_workers=HOST_WORKERS) as pool:
        pending: collections.deque = collections.deque()
        for _ in range(n_chunks):
            item = launch()
            pending.append((pool.submit(host, item), item))
            while len(pending) > HOST_WORKERS:
                fut, item = pending.popleft()
                collect(fut.result(), item)
        while pending:
            fut, item = pending.popleft()
            collect(fut.result(), item)


def _n_chunks(shots: int, batch: int, total: int = 0) -> int:
    need = max(shots, 1) - total
    return max(0, (need + batch - 1) // batch)


def _cleanup_decoder(graph: TannerGraph, cleanup: str, p, force_python: bool):
    from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder

    if cleanup == "uf":
        return UnionFindDecoder(graph, force_python=force_python)
    if cleanup == "mwpm":
        return MWPMDecoder(graph, p=p, force_python=force_python)
    raise ValueError(f"unknown cleanup decoder {cleanup!r}")


def ler_gnn_cleanup(model, graph: TannerGraph, *, p: float, shots: int, batch: int = 4096,
                    generator: torch.Generator, cleanup: str = "uf",
                    tau: float | None = None, force_python: bool = False,
                    device="cuda") -> dict[str, float]:
    """Monte-Carlo LER of the GNN + cleanup hybrid decoder."""
    dec = _cleanup_decoder(graph, cleanup, p, force_python)
    dev = resolve_device(device)
    dg, model = graph.to(dev), model.to(dev)
    n = graph.n_qubits
    fail_of = _failure_fn(graph)
    acc = {"fails": 0, "sm": 0, "total": 0}

    def host(item):
        h = item[1].numpy()
        ex_u, ez_u = lazy_decode(dec, h["s_res"])
        cex, cez = h["ex_g"][:, :n] ^ ex_u, h["ez_g"][:, :n] ^ ez_u
        fails, sm = fail_of(cex, cez, h["ex"], h["ez"])
        return int(fails.sum()), int(sm.sum()), cex.shape[0]

    def collect(r, _):
        acc["fails"] += r[0]
        acc["sm"] += r[1]
        acc["total"] += r[2]

    _run_chunks(_n_chunks(shots, batch),
                lambda: _launch(model, dg, generator, p, batch, tau, with_logical=False),
                host, collect)
    total = acc["total"]
    ler = acc["fails"] / total
    return {
        "ler": ler,
        "ler_stderr": _stderr(ler, total),
        "syn_mismatch_rate": acc["sm"] / total,
        "shots": float(total),
        "decoder": f"gnn+{cleanup}" + (f"@tau{tau}" if tau is not None else ""),
    }


def _columns_result(sums, counters, picked, cand_names, total, *,
                    best_of, with_mwpm, with_uf_raw, with_mwpm_raw) -> dict:
    """Assemble the ler_all_columns output dict from accumulated counters."""
    ler = sums.get("fail_qubit", 0) / total
    out = {
        "ler": ler,
        "ler_stderr": _stderr(ler, total),
        "shots": float(total),
        "gnn_uf": counters["gnn_uf"] / total,
        "gnn_mwpm": (counters["gnn_mwpm"] / total) if with_mwpm else None,
        "gnn_best_of": (counters["best_of"] / total) if best_of else None,
        "picked": ({c: int(picked[i]) for i, c in enumerate(cand_names)}
                   if best_of else None),
        "uf": (counters["uf"] / total) if with_uf_raw else None,
        "mwpm": (counters["mwpm"] / total) if with_mwpm_raw else None,
        "syn_mismatch": {k: counters[f"sm_{k}"] for k in
                         ("gnn_uf", "gnn_mwpm", "best_of", "uf", "mwpm")},
    }
    if "fail_logical" in sums:
        out["ler_logical"] = sums["fail_logical"] / total
        out["ler_hybrid"] = sums["fail_hybrid"] / total
    return out


def _state_digest(model) -> str:
    """sha256 of the model's state dict (names, dtypes, shapes and bytes)."""
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        t = t.detach().cpu().contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def _generator_state(generator: torch.Generator) -> str:
    return generator.get_state().numpy().tobytes().hex()


def ler_all_columns(model, graph: TannerGraph, *, p: float, shots: int, batch: int = 4096,
                    generator: torch.Generator, tau: float | None = None,
                    best_of: bool = True, with_mwpm: bool = True, with_uf_raw: bool = False,
                    with_mwpm_raw: bool | None = None, force_python: bool = False,
                    progress_path: str | None = None, flush_every: int = 25,
                    on_progress: Callable[[dict], None] | None = None,
                    select_cost: str = "weight", device="cuda") -> dict:
    """Every GNN-side LER column from ONE Monte-Carlo pass.

    Samples once per chunk and shares the forward and the classical decodes
    across columns; each chunk draws from ``generator`` as
    ``ler_monte_carlo`` does, so each column equals its single-column
    evaluator's value on the same seed.

    Returns ler / ler_logical / ler_hybrid (+stderr), gnn_uf, gnn_mwpm,
    gnn_best_of (+picked), optionally the raw union-find / MWPM baselines on
    the same shots (``with_uf_raw`` / ``with_mwpm_raw``; raw MWPM is on by
    default whenever ``best_of`` and ``with_mwpm`` are, since the best-of
    candidate set needs it anyway), ``syn_mismatch``: per cleanup column
    the shots whose correction left a nonzero syndrome (0 by construction),
    and ``timing``: the call's wall seconds, the seconds its host threads
    spent on the chunks' host work (decodes, selection, counting; summed
    over threads) and, on a card, the chunks' summed spans on the device's
    stream (sampling to the end of the copies back).
    ``select_cost='nll'`` ranks the best-of candidates by the GNN's own
    posterior likelihood instead of support weight (see min_weight_select).

    **Resumable**: with ``progress_path`` set, the accumulated counters and
    the generator's state after the last counted chunk are written to a JSON
    file every ``flush_every`` chunks (atomic rename), and a rerun with the
    same configuration, generator seed and initial state, and model weights
    restores the generator's state and goes on where it stopped: the result
    equals an uninterrupted run's.  ``on_progress`` (called at each flush
    with the partial result dict) lets the caller land partial rows.  The
    file is removed when the run completes.  HOST_WORKERS host threads
    decode chunks while the device runs the next ones.
    """
    from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder

    uf = UnionFindDecoder(graph, force_python=force_python)
    mw = MWPMDecoder(graph, p=p, force_python=force_python) if with_mwpm else None
    if with_mwpm_raw is None:
        with_mwpm_raw = best_of and with_mwpm
    # the raw-MWPM decode lives under the with_mwpm branch: without it the
    # counter would stay 0 and report a spuriously perfect baseline
    with_mwpm_raw = with_mwpm_raw and with_mwpm
    if select_cost not in ("weight", "nll"):
        raise ValueError(f"unknown select_cost {select_cost!r}; have 'weight'|'nll'")
    nll_temp = float(os.environ.get("TPUGNN_NLL_TEMP", "1.0"))

    dev = resolve_device(device)
    dg, model = graph.to(dev), model.to(dev)
    n = graph.n_qubits
    hx, hz, _, _ = _parity_tables(graph)
    fail_of = _failure_fn(graph)
    with_nlp = best_of and select_cost == "nll"

    cand_names = ["qubit", "logical", "gnn_uf"]
    if with_mwpm:
        cand_names += ["gnn_mwpm", "mwpm"] if with_mwpm_raw else ["gnn_mwpm"]
    keys = ("gnn_uf", "gnn_mwpm", "best_of", "uf", "mwpm")
    st = {"sums": {}, "counters": dict.fromkeys(keys + tuple(f"sm_{k}" for k in keys), 0),
          "picked": np.zeros(len(cand_names), np.int64), "total": 0, "chunks": 0}

    fingerprint = {"batch": batch, "p": p, "tau": tau, "cand_names": list(cand_names),
                   "best_of": best_of, "with_uf_raw": with_uf_raw,
                   "with_mwpm_raw": with_mwpm_raw, "select_cost": select_cost,
                   "nll_temp": nll_temp, "seed": generator.initial_seed(),
                   "state0": hashlib.sha256(generator.get_state().numpy().tobytes())
                   .hexdigest(), "state_digest": _state_digest(model)}

    if progress_path and os.path.exists(progress_path):
        try:
            with open(progress_path) as f:
                saved = json.load(f)
            if saved.get("fingerprint") == fingerprint and saved.get("total", 0) > 0:
                st.update(total=int(saved["total"]),
                          counters={k: int(v) for k, v in saved["counters"].items()},
                          sums={k: int(v) for k, v in saved["sums"].items()},
                          picked=np.asarray(saved["picked"], np.int64))
                generator.set_state(torch.frombuffer(
                    bytearray(bytes.fromhex(saved["generator_state"])), dtype=torch.uint8))
        except (ValueError, KeyError, OSError):
            pass  # corrupt or foreign progress file: start clean

    def result():
        return _columns_result(st["sums"], st["counters"], st["picked"], cand_names,
                               st["total"], best_of=best_of, with_mwpm=with_mwpm,
                               with_uf_raw=with_uf_raw, with_mwpm_raw=with_mwpm_raw)

    def flush(gen_state: str):
        saved = {"fingerprint": fingerprint, "total": st["total"],
                 "counters": st["counters"], "sums": st["sums"],
                 "picked": [int(x) for x in st["picked"]], "generator_state": gen_state}
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(saved, f)
        os.replace(tmp, progress_path)
        if on_progress is not None:
            on_progress(result())

    def launch():
        names, hc = _launch(model, dg, generator, p, batch, tau, with_nlp=with_nlp,
                            nll_temp=nll_temp)
        return names, hc, _generator_state(generator) if progress_path else None

    def count(name, cex, cez, h, c):
        fails, sm = fail_of(cex, cez, h["ex"], h["ez"])
        c[name] += int(fails.sum())
        c[f"sm_{name}"] += int(sm.sum())

    def host(item):
        names, hc, _ = item
        h = hc.numpy()
        t0 = time.perf_counter()
        c = dict.fromkeys(st["counters"], 0)
        exg, ezg = h["ex_g"][:, :n], h["ez_g"][:, :n]
        s_res, syn = h["s_res"], h["syn"]
        exu, ezu = lazy_decode(uf, s_res)
        cands = {"qubit": (exg, ezg),
                 "logical": (h["lex"][:, :n], h["lez"][:, :n]),
                 "gnn_uf": (exg ^ exu, ezg ^ ezu)}
        if with_mwpm:
            exm, ezm = lazy_decode(mw, s_res)
            cands["gnn_mwpm"] = (exg ^ exm, ezg ^ ezm)
            if with_mwpm_raw:
                cands["mwpm"] = lazy_decode(mw, syn)
                count("mwpm", *cands["mwpm"], h, c)
        if with_uf_raw:
            count("uf", *lazy_decode(uf, syn), h, c)
        count("gnn_uf", *cands["gnn_uf"], h, c)
        if with_mwpm:
            count("gnn_mwpm", *cands["gnn_mwpm"], h, c)
        picked = np.zeros(len(cand_names), np.int64)
        if best_of:
            nlp = h["nlp"][:, :n] if with_nlp else None
            ex_hat, ez_hat, choice = min_weight_select(
                cand_names, cands, syn, hz, hx,
                qubit_inconsistent=s_res.any(axis=1), nlp=nlp)
            picked += np.bincount(choice, minlength=len(cand_names))
            count("best_of", ex_hat, ez_hat, h, c)
        sums = {k: int(v) for k, v in zip(names, h["sums"])}
        return sums, c, picked, exg.shape[0], time.perf_counter() - t0, hc.device_ms()

    def collect(r, item):
        sums, c, picked, bsz, host_s, device_ms = r
        timing["host_s"] += host_s
        if device_ms is not None:
            timing["device_s"] = (timing["device_s"] or 0.0) + device_ms / 1e3
        for k, v in sums.items():
            st["sums"][k] = st["sums"].get(k, 0) + v
        for k, v in c.items():
            st["counters"][k] += v
        st["picked"] += picked
        st["total"] += bsz
        st["chunks"] += 1
        if progress_path and st["chunks"] % max(1, flush_every) == 0:
            flush(item[2])

    timing = {"wall_s": 0.0, "host_s": 0.0, "device_s": None}
    t_wall = time.perf_counter()
    _run_chunks(_n_chunks(shots, batch, st["total"]), launch, host, collect)
    timing["wall_s"] = time.perf_counter() - t_wall
    out = result()
    out["timing"] = timing
    if progress_path:
        # a completed result must not resume into a later request
        with contextlib.suppress(OSError):
            os.remove(progress_path)
        with contextlib.suppress(OSError):
            os.remove(progress_path + ".tmp")
    return out


def ler_best_of(model, graph: TannerGraph, *, p: float, shots: int, batch: int = 4096,
                generator: torch.Generator,
                candidates: tuple = ("qubit", "logical", "gnn_uf", "gnn_mwpm", "mwpm"),
                tau: float | None = None, force_python: bool = False,
                device="cuda") -> dict[str, float]:
    """Per-shot minimum-weight selection over syndrome-consistent candidates.

    Every candidate correction is syndrome-consistent (the raw per-qubit
    head is assigned infinite weight when it is not); the decoder commits
    the lightest under the Y-aware depolarizing weight |support(ex OR ez)|.
    Approximate MAP over the candidate set.
    """
    from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder

    for name in candidates:
        if name not in ("qubit", "logical", "gnn_uf", "gnn_mwpm", "mwpm"):
            raise ValueError(f"unknown candidate {name!r}")
    uf = UnionFindDecoder(graph, force_python=force_python) \
        if "gnn_uf" in candidates else None
    mw = MWPMDecoder(graph, p=p, force_python=force_python) \
        if "gnn_mwpm" in candidates or "mwpm" in candidates else None
    dev = resolve_device(device)
    dg, model = graph.to(dev), model.to(dev)
    n = graph.n_qubits
    hx, hz, _, _ = _parity_tables(graph)
    fail_of = _failure_fn(graph)
    acc = {"fails": 0, "total": 0, "picked": np.zeros(len(candidates), np.int64)}

    def host(item):
        h = item[1].numpy()
        s_res, syn = h["s_res"], h["syn"]
        exg, ezg = h["ex_g"][:, :n], h["ez_g"][:, :n]
        cands = {}
        for name in candidates:
            if name == "qubit":
                cands[name] = (exg, ezg)
            elif name == "logical":
                cands[name] = (h["lex"][:, :n], h["lez"][:, :n])
            elif name == "gnn_uf":
                exu, ezu = lazy_decode(uf, s_res)
                cands[name] = (exg ^ exu, ezg ^ ezu)
            elif name == "gnn_mwpm":
                exm, ezm = lazy_decode(mw, s_res)
                cands[name] = (exg ^ exm, ezg ^ ezm)
            else:
                cands[name] = lazy_decode(mw, syn)
        ex_hat, ez_hat, choice = min_weight_select(
            candidates, cands, syn, hz, hx, qubit_inconsistent=s_res.any(axis=1))
        return (int(fail_of(ex_hat, ez_hat, h["ex"], h["ez"])[0].sum()),
                np.bincount(choice, minlength=len(candidates)), exg.shape[0])

    def collect(r, _):
        acc["fails"] += r[0]
        acc["picked"] += r[1]
        acc["total"] += r[2]

    _run_chunks(_n_chunks(shots, batch), lambda: _launch(model, dg, generator, p, batch, tau),
                host, collect)
    total = acc["total"]
    ler = acc["fails"] / total
    return {
        "ler": ler,
        "ler_stderr": _stderr(ler, total),
        "shots": float(total),
        "decoder": "best_of:" + "+".join(candidates),
        "picked": {c: int(acc["picked"][i]) for i, c in enumerate(candidates)},
    }
