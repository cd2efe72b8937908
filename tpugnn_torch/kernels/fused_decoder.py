"""R weight-tied message rounds of the decoder in one kernel launch.

The port of ``tpugnn/kernels/fused_decoder.py``.  ``decoder_rounds`` runs all
R rounds of both message directions (check and qubit updates, residual and
LayerNorm) on node states in the batch layout ``[B, rows, H]``:

* a tensor on the CPU goes to :func:`rounds_plain`, the plain PyTorch
  version, which defines the function;
* a tensor on a CUDA device goes to the hand-written kernel
  ``csrc/fused_rounds.cu`` (built by ``_build.py``), which replaces the TPU
  kernel ``decoder_rounds_tiled`` (``pl.pallas_call`` at
  ``tpugnn/kernels/fused_decoder.py:637``).  It launches or raises; there is
  no fallback.

The function of one round, per direction (checks shown; qubits alike without
the syndrome term), with ``rnd`` rounding to the state storage type and all
arithmetic in f32::

    ys_c  = rnd(x_q @ ws_c)                       source projection, [N, MH]
    ydb   = x_c @ wd_c + b0_c
    hs    = rnd(sum_k mask[r,k] relu(ys_c[src[r,k]] + ydb[r]))
    pre   = x_c @ uc_x + hs @ (wo_c @ uc_a) + deg (bo_c @ uc_a)
            + syn uc_s + uc_b0
    x_c'  = rnd(LN(x_c + rnd(relu(pre)) @ uc_w1 + uc_b1))      LN eps 1e-6

``wo @ ua`` is folded once per call in f32 (an exact rewrite up to f32
reassociation, the TPU kernel's "fold" variant); the matrices are then stored
in the state type and the vectors in f32.  The slot gather reads source rows
by index, not through the TPU's one-hot incidence GEMM.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["RoundWeights", "make_operators", "pack_weights", "rounds_plain",
           "decoder_rounds", "launch_counts", "reset_launch_counts",
           "STATE_DTYPES", "SMEM_LIMIT"]

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper

# launches of the CUDA kernel by decoder_rounds in this process
_LAUNCHES = {"fused_rounds": 0}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


class RoundWeights(NamedTuple):
    """Weight-tied round parameters (the 25 fields of the JAX kernel's
    ``RoundWeights``); matrices [in, out], vectors [1, F], all f32."""

    # message to checks: dst = check, src = qubit
    wd_c: torch.Tensor   # [H, MH]
    ws_c: torch.Tensor   # [H, MH]
    b0_c: torch.Tensor   # [1, MH]
    wo_c: torch.Tensor   # [MH, H]
    bo_c: torch.Tensor   # [1, H]
    # message to qubits: dst = qubit, src = check
    wd_q: torch.Tensor
    ws_q: torch.Tensor
    b0_q: torch.Tensor
    wo_q: torch.Tensor
    bo_q: torch.Tensor
    # check update MLP (input split: state / agg / syndrome)
    uc_x: torch.Tensor   # [H, H]
    uc_a: torch.Tensor   # [H, H]
    uc_s: torch.Tensor   # [1, H]
    uc_b0: torch.Tensor  # [1, H]
    uc_w1: torch.Tensor  # [H, H]
    uc_b1: torch.Tensor  # [1, H]
    # qubit update MLP (state / agg)
    uq_x: torch.Tensor
    uq_a: torch.Tensor
    uq_b0: torch.Tensor
    uq_w1: torch.Tensor
    uq_b1: torch.Tensor
    # LayerNorms
    lnc_scale: torch.Tensor  # [1, H]
    lnc_bias: torch.Tensor
    lnq_scale: torch.Tensor
    lnq_bias: torch.Tensor


def make_operators(graph) -> tuple:
    """Slot index tables of a graph whose arrays are tensors.

    Returns ``(src_c [M, Dc] i64, mask_c [M, Dc] f32, deg_c [M] f32,
    src_q [N, Dq] i64, mask_q [N, Dq] f32, deg_q [N] f32)``: for every ELL
    slot of a check (qubit) row the qubit (check) it reads, whether the slot
    is real, and each row's real degree.  Masked slots point at the dump
    node and must be read through the mask.
    """
    src_c = graph.edge_qubit.long()[graph.ell_check_edge.long()]
    src_q = graph.edge_check.long()[graph.ell_qubit_edge.long()]
    mask_c = graph.ell_check_mask.float()
    mask_q = graph.ell_qubit_mask.float()
    return (src_c, mask_c, mask_c.sum(1), src_q, mask_q, mask_q.sum(1))


def pack_weights(w: RoundWeights, dtype: torch.dtype):
    """The kernel's two weight operands, shared by the plain version.

    ``mats`` [10, H, H] in ``dtype``, in the order
    ``wd_c, uc_x, ws_q, wo_c@uc_a, uc_w1, wd_q, uq_x, ws_c, wo_q@uq_a, uq_w1``
    (each direction's five: dst projection, state term, the projection that
    feeds the OTHER direction's gather, folded aggregation, update output);
    ``vecs`` [14, H] f32: ``b0, bo@ua, uc_s, ub0, ub1, ln_scale, ln_bias``
    for checks, then the same for qubits with a zero row for the syndrome.
    """
    f32 = torch.float32
    h = w.wd_c.shape[0]
    mh = w.wd_c.shape[1]
    if mh != h:
        raise ValueError(f"fused rounds need msg_hidden == hidden, got {mh} != {h}")
    f = lambda a: a.to(f32)
    wf_c = f(w.wo_c) @ f(w.uc_a)
    wf_q = f(w.wo_q) @ f(w.uq_a)
    mats = torch.stack([
        f(w.wd_c), f(w.uc_x), f(w.ws_q), wf_c, f(w.uc_w1),
        f(w.wd_q), f(w.uq_x), f(w.ws_c), wf_q, f(w.uq_w1),
    ]).to(dtype).contiguous()
    row = lambda a: f(a).reshape(-1)
    vecs = torch.stack([
        row(w.b0_c), row(f(w.bo_c) @ f(w.uc_a)), row(w.uc_s), row(w.uc_b0),
        row(w.uc_b1), row(w.lnc_scale), row(w.lnc_bias),
        row(w.b0_q), row(f(w.bo_q) @ f(w.uq_a)), torch.zeros_like(row(w.uq_b0)),
        row(w.uq_b0), row(w.uq_b1), row(w.lnq_scale), row(w.lnq_bias),
    ]).contiguous()
    return mats, vecs


def _layer_norm(v: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + 1e-6) * scale + bias


def _update(x, ys_src, src, mask, deg, mats, vecs, syn, rnd):
    """One direction's node update (see the module docstring)."""
    b, rows, _ = x.shape
    d = src.shape[1]
    ydb = x @ mats[0] + vecs[0]
    ux = x @ mats[1]
    g = ys_src.index_select(1, src.reshape(-1)).reshape(b, rows, d, -1)
    z = torch.relu(g + ydb[:, :, None, :]) * mask[None, :, :, None]
    hs = rnd(z.sum(2))
    pre = ux + hs @ mats[3] + deg[:, None] * vecs[1] + syn * vecs[2] + vecs[3]
    hc = rnd(torch.relu(pre))
    v = x + hc @ mats[4] + vecs[4]
    return rnd(_layer_norm(v, vecs[5], vecs[6]))


def rounds_plain(xc, xq, syn, operators, weights: RoundWeights, *, rounds: int,
                 state_dtype: str = "float32"):
    """Plain PyTorch version of the fused rounds; returns f32 states.

    ``xc`` [B, M, H], ``xq`` [B, N, H], ``syn`` [B, M, 1] (or [B, M]).
    States are stored in ``state_dtype`` and rounded at the same points as
    the kernel; every product and sum runs in f32.
    """
    dt = STATE_DTYPES[state_dtype]
    src_c, mask_c, deg_c, src_q, mask_q, deg_q = operators
    mats, vecs = pack_weights(weights, dt)
    mats = mats.float()
    rnd = lambda t: t.to(dt).float()
    xc = rnd(xc.float())
    xq = rnd(xq.float())
    s = syn.reshape(xc.shape[0], xc.shape[1], 1).float()
    for _ in range(rounds):
        ys_c = rnd(xq @ mats[7])       # qubit sources of the check gather
        ys_q = rnd(xc @ mats[2])       # check sources of the qubit gather
        xc, xq = (
            _update(xc, ys_c, src_c, mask_c, deg_c, mats[0:5], vecs[0:7], s, rnd),
            _update(xq, ys_q, src_q, mask_q, deg_q, mats[5:10], vecs[7:14], 0.0, rnd),
        )
    return xc, xq


def decoder_rounds(xc, xq, syn, operators, weights: RoundWeights, rounds: int,
                   state_dtype: str = "float32"):
    """R fused rounds; returns ``(xc, xq)`` in f32, batch layout.

    CPU tensors take :func:`rounds_plain`; CUDA tensors take the kernel,
    which has no backward: with grad enabled and an operand that requires
    grad, it raises rather than return states cut off from the graph.
    """
    if xc.device.type == "cpu":
        return rounds_plain(xc, xq, syn, operators, weights, rounds=rounds,
                            state_dtype=state_dtype)
    if xc.device.type != "cuda":
        raise ValueError(f"decoder_rounds runs on cpu or cuda, not {xc.device}")
    return _rounds_cuda(xc, xq, syn, operators, weights, rounds, state_dtype)


def _rounds_cuda(xc, xq, syn, operators, weights, rounds, state_dtype):
    from tpugnn_torch.kernels._build import load_library

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (xc, xq, syn, *weights)):
        raise RuntimeError(
            "the fused-rounds CUDA kernel has no backward: call it under "
            "torch.no_grad() or torch.inference_mode(), or train on the CPU "
            "(rounds_plain)")
    dt = STATE_DTYPES[state_dtype]
    src_c, mask_c, _, src_q, mask_q, _ = operators
    b, m, h = xc.shape
    n = xq.shape[1]
    dc, dq = src_c.shape[1], src_q.shape[1]
    if xq.shape[0] != b or xq.shape[2] != h:
        raise ValueError(f"state shapes disagree: {tuple(xc.shape)} vs {tuple(xq.shape)}")
    if h != 128 or weights.wd_c.shape != (128, 128):
        raise ValueError("the fused-rounds kernel is built for hidden = "
                         f"msg_hidden = 128, got {tuple(weights.wd_c.shape)}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if src_c.shape[0] != m or src_q.shape[0] != n:
        raise ValueError("operators do not match the state rows")
    dev = xc.device
    for t in (xq, syn, src_c, src_q, mask_c, mask_q):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    lib = load_library()
    code = _DTYPE_CODE[dt]
    smem = lib.fused_rounds_smem_bytes(code, m, n, dc, dq)
    if smem > SMEM_LIMIT:
        raise ValueError(f"graph too large for the fused-rounds kernel: needs "
                         f"{smem} B of shared memory per block (M={m}, N={n}), "
                         f"limit {SMEM_LIMIT}")
    mats, vecs = pack_weights(weights, dt)
    idx_c = torch.where(mask_c > 0, src_c, -1).to(torch.int32).contiguous()
    idx_q = torch.where(mask_q > 0, src_q, -1).to(torch.int32).contiguous()
    xc_in = xc.to(dt).contiguous()
    xq_in = xq.to(dt).contiguous()
    syn2 = syn.reshape(b, m).to(torch.float32).contiguous()
    out_c = torch.empty_like(xc_in)
    out_q = torch.empty_like(xq_in)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rounds_launch(
            code, xc_in.data_ptr(), xq_in.data_ptr(), syn2.data_ptr(),
            idx_c.data_ptr(), idx_q.data_ptr(), mats.data_ptr(),
            vecs.data_ptr(), out_c.data_ptr(), out_q.data_ptr(),
            b, m, n, dc, dq, rounds, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_rounds kernel launch failed: CUDA error {err}")
    _LAUNCHES["fused_rounds"] += 1
    return out_c.float(), out_q.float()
