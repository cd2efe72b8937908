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
  no fallback;
* a call that autograd must differentiate goes to
  :class:`~tpugnn_torch.kernels.fused_backward.FusedRoundsFn` instead (the
  kernels K2a and K2b on a card, their plain versions on the CPU).

The function of one round, per direction (checks shown; qubits alike without
the syndrome term), with ``rnd`` rounding to the state storage type and all
arithmetic in f32::

    ys_c  = rnd(x_q @ ws_c)                       source projection, [N, MH]
    ydb   = x_c @ wd_c + b0_c
    hs    = rnd(sum_k mask[r,k] relu(ys_c[src[r,k]] + ydb[r]))
    pre   = x_c @ uc_x + hs @ (wo_c @ uc_a) + deg (bo_c @ uc_a)
            + rnd(syn uc_s) + uc_b0
    x_c'  = rnd(LN(x_c + rnd(relu(pre)) @ uc_w1 + uc_b1))      LN eps 1e-6

``wo @ ua`` is folded once per call in f32 (an exact rewrite up to f32
reassociation, the TPU kernel's "fold" variant); the matrices are then stored
in the state type and the vectors in f32.  The slot gather reads source rows
by index, not through the TPU's one-hot incidence GEMM.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

__all__ = ["RoundWeights", "make_operators", "pack_weights", "pack_weights_f32",
           "cast_packs", "rounds_plain",
           "decoder_rounds", "launch_counts", "reset_launch_counts",
           "STATE_DTYPES", "SMEM_LIMIT"]

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper

# launches of the CUDA kernels in this process: K1 (decoder_rounds without
# grad), K2a and K2b (kernels/fused_backward.py)
_LAUNCHES = {"fused_rounds": 0, "fused_rounds_fwd_stash": 0, "fused_rounds_bwd": 0}


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


def pack_weights_f32(w: RoundWeights):
    """The kernels' two weight operands in f32, differentiable in ``w``.

    ``mats`` [10, H, H] in the order
    ``wd_c, uc_x, ws_q, wo_c@uc_a, uc_w1, wd_q, uq_x, ws_c, wo_q@uq_a, uq_w1``
    (each direction's five: dst projection, state term, the projection that
    feeds the OTHER direction's gather, folded aggregation, update output);
    ``vecs`` [14, H]: ``b0, bo@ua, uc_s, ub0, ub1, ln_scale, ln_bias`` for
    checks, then the same for qubits with a zero row for the syndrome.
    Training differentiates through this packing, as the JAX package's
    ``kernel_trained_rounds_tiled`` does, so the fold's gradients un-fold
    into ``wo``, ``ua`` and ``bo`` by autograd.
    """
    f32 = torch.float32
    h = w.wd_c.shape[0]
    mh = w.wd_c.shape[1]
    if mh != h:
        raise ValueError(f"fused rounds need msg_hidden == hidden, got {mh} != {h}")
    f = lambda a: a.to(f32)
    mats = torch.stack([
        f(w.wd_c), f(w.uc_x), f(w.ws_q), f(w.wo_c) @ f(w.uc_a), f(w.uc_w1),
        f(w.wd_q), f(w.uq_x), f(w.ws_c), f(w.wo_q) @ f(w.uq_a), f(w.uq_w1),
    ])
    row = lambda a: f(a).reshape(-1)
    vecs = torch.stack([
        row(w.b0_c), row(f(w.bo_c) @ f(w.uc_a)), row(w.uc_s), row(w.uc_b0),
        row(w.uc_b1), row(w.lnc_scale), row(w.lnc_bias),
        row(w.b0_q), row(f(w.bo_q) @ f(w.uq_a)), torch.zeros_like(row(w.uq_b0)),
        row(w.uq_b0), row(w.uq_b1), row(w.lnq_scale), row(w.lnq_bias),
    ])
    return mats, vecs


def cast_packs(mats: torch.Tensor, vecs: torch.Tensor, dtype: torch.dtype):
    """The f32 packs as the kernels read them: matrices stored in ``dtype``;
    vectors in f32, except the syndrome row ``uc_s``, rounded through
    ``dtype``.  The JAX package rounds the syndrome term ``syn * uc_s`` to
    the state type before its kernels use it
    (``tpugnn/models/pallas_decoder.py:288``,
    ``tpugnn/kernels/fused_backward.py:592``); with ``syn`` in {-1, 0, +1}
    rounding ``uc_s`` is the same thing."""
    ucs = vecs[2:3].to(dtype).float()
    vecs = torch.cat([vecs[:2], ucs, vecs[3:]])
    return mats.to(dtype).contiguous(), vecs.contiguous()


def pack_weights(w: RoundWeights, dtype: torch.dtype):
    """``(mats, vecs)`` of :func:`pack_weights_f32` as the kernels and the
    plain versions read them (:func:`cast_packs`)."""
    return cast_packs(*pack_weights_f32(w), dtype)


def _update(x, ys_src, src, mask, deg, mats, vecs, synterm, rnd, keep=None):
    """One direction's node update (see the module docstring).

    ``keep``, a dict, receives what the adjoint reads: the slot relu's
    live mask, ``hs``, ``t``, ``hc`` and the LayerNorm's ``nh`` and
    ``inv``."""
    b, rows, _ = x.shape
    d = src.shape[1]
    ydb = x @ mats[0] + vecs[0]
    ux = x @ mats[1]
    g = ys_src.index_select(1, src.reshape(-1)).reshape(b, rows, d, -1)
    zin = g + ydb[:, :, None, :]
    z = torch.relu(zin) * mask[None, :, :, None]
    hs = rnd(z.sum(2))
    t = ux + hs @ mats[3] + deg[:, None] * vecs[1] + synterm + vecs[3]
    hc = rnd(torch.relu(t))
    v = x + hc @ mats[4] + vecs[4]
    ctr = v - v.mean(-1, keepdim=True)
    inv = torch.rsqrt((ctr * ctr).mean(-1, keepdim=True) + 1e-6)
    nh = ctr * inv
    if keep is not None:
        keep.update(live=(zin > 0) & (mask[None, :, :, None] > 0), hs=hs, t=t,
                    hc=hc, nh=nh, inv=inv)
    return rnd(nh * vecs[5] + vecs[6])


def rounds_packed(xc, xq, syn, operators, mats, vecs, *, rounds: int,
                  dtype: torch.dtype, stash=None):
    """The rounds on packed weights (:func:`cast_packs`); returns f32 states.

    ``stash``, a pair of lists, receives each round's input states in
    ``dtype`` (the residuals of training)."""
    src_c, mask_c, deg_c, src_q, mask_q, deg_q = operators
    mats = mats.float()
    rnd = lambda t: t.to(dtype).float()
    xc = rnd(xc.float())
    xq = rnd(xq.float())
    synterm = syn.reshape(xc.shape[0], xc.shape[1], 1).float() * vecs[2]
    for _ in range(rounds):
        if stash is not None:
            stash[0].append(xc.to(dtype))
            stash[1].append(xq.to(dtype))
        ys_c = rnd(xq @ mats[7])       # qubit sources of the check gather
        ys_q = rnd(xc @ mats[2])       # check sources of the qubit gather
        xc, xq = (
            _update(xc, ys_c, src_c, mask_c, deg_c, mats[0:5], vecs[0:7], synterm, rnd),
            _update(xq, ys_q, src_q, mask_q, deg_q, mats[5:10], vecs[7:14], 0.0, rnd),
        )
    return xc, xq


def rounds_plain(xc, xq, syn, operators, weights: RoundWeights, *, rounds: int,
                 state_dtype: str = "float32"):
    """Plain PyTorch version of the fused rounds; returns f32 states.

    ``xc`` [B, M, H], ``xq`` [B, N, H], ``syn`` [B, M, 1] (or [B, M]).
    States are stored in ``state_dtype`` and rounded at the same points as
    the kernel; every product and sum runs in f32.
    """
    dt = STATE_DTYPES[state_dtype]
    mats, vecs = pack_weights(weights, dt)
    return rounds_packed(xc, xq, syn, operators, mats, vecs, rounds=rounds, dtype=dt)


def _needs_grad(xc, xq, syn, weights) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (xc, xq, syn, *weights))


def decoder_rounds(xc, xq, syn, operators, weights: RoundWeights, rounds: int,
                   state_dtype: str = "float32"):
    """R fused rounds; returns ``(xc, xq)`` in f32, batch layout.

    CPU tensors take the plain versions, CUDA tensors the kernels.  With
    grad enabled and an operand that requires grad, the call goes through
    :class:`~tpugnn_torch.kernels.fused_backward.FusedRoundsFn` (K2a forward,
    K2b backward on a card); otherwise it runs K1 (:func:`rounds_plain` on
    the CPU).
    """
    if xc.device.type == "cpu":
        if _needs_grad(xc, xq, syn, weights):
            from tpugnn_torch.kernels.fused_backward import trained_rounds

            return trained_rounds(xc, xq, syn, operators, weights, rounds,
                                  state_dtype, kernels=False)
        return rounds_plain(xc, xq, syn, operators, weights, rounds=rounds,
                            state_dtype=state_dtype)
    if xc.device.type != "cuda":
        raise ValueError(f"decoder_rounds runs on cpu or cuda, not {xc.device}")
    return _rounds_cuda(xc, xq, syn, operators, weights, rounds, state_dtype)


@contextlib.contextmanager
def _cuda_stream(dev):
    """Makes ``dev`` current and yields its current stream for a launch."""
    with torch.cuda.device(dev):
        yield ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _slot_tables(src_c, mask_c, src_q, mask_q):
    """int32 slot tables of the kernels: the source row, -1 for a masked slot."""
    idx_c = torch.where(mask_c > 0, src_c, -1).to(torch.int32).contiguous()
    idx_q = torch.where(mask_q > 0, src_q, -1).to(torch.int32).contiguous()
    return idx_c, idx_q


class _CudaOperands(NamedTuple):
    code: int
    b: int
    m: int
    n: int
    dc: int
    dq: int
    xc: torch.Tensor      # [B, M, H] in the state type, contiguous
    xq: torch.Tensor
    syn: torch.Tensor     # [B, M] f32
    idx_c: torch.Tensor
    idx_q: torch.Tensor


def _cuda_operands(lib, xc, xq, syn, operators, mats, rounds, dt) -> _CudaOperands:
    """Checks a call of the forward kernels (K1, K2a) and prepares its
    operands; raises on anything the kernels do not take."""
    src_c, mask_c, _, src_q, mask_q, _ = operators
    b, m, h = xc.shape
    n = xq.shape[1]
    dc, dq = src_c.shape[1], src_q.shape[1]
    if xq.shape[0] != b or xq.shape[2] != h:
        raise ValueError(f"state shapes disagree: {tuple(xc.shape)} vs {tuple(xq.shape)}")
    if h != 128 or tuple(mats.shape[-2:]) != (128, 128):
        raise ValueError("the fused-rounds kernels are built for hidden = "
                         f"msg_hidden = 128, got {tuple(mats.shape[-2:])}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if src_c.shape[0] != m or src_q.shape[0] != n:
        raise ValueError("operators do not match the state rows")
    dev = xc.device
    for t in (xq, syn, src_c, src_q, mask_c, mask_q):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    code = _DTYPE_CODE[dt]
    smem = lib.fused_rounds_smem_bytes(code, m, n, dc, dq)
    if smem > SMEM_LIMIT:
        raise ValueError(f"graph too large for the fused-rounds kernel: needs "
                         f"{smem} B of shared memory per block (M={m}, N={n}), "
                         f"limit {SMEM_LIMIT}")
    idx_c, idx_q = _slot_tables(src_c, mask_c, src_q, mask_q)
    return _CudaOperands(code, b, m, n, dc, dq, xc.detach().to(dt).contiguous(),
                         xq.detach().to(dt).contiguous(),
                         syn.detach().reshape(b, m).to(torch.float32).contiguous(),
                         idx_c, idx_q)


def _rounds_cuda(xc, xq, syn, operators, weights, rounds, state_dtype):
    from tpugnn_torch.kernels._build import load_library

    if _needs_grad(xc, xq, syn, weights):
        from tpugnn_torch.kernels.fused_backward import trained_rounds

        return trained_rounds(xc, xq, syn, operators, weights, rounds, state_dtype,
                              kernels=True)
    dt = STATE_DTYPES[state_dtype]
    lib = load_library("fused_rounds")
    mats, vecs = pack_weights(weights, dt)
    a = _cuda_operands(lib, xc, xq, syn, operators, mats, rounds, dt)
    out_c = torch.empty_like(a.xc)
    out_q = torch.empty_like(a.xq)
    with _cuda_stream(xc.device) as stream:
        err = lib.fused_rounds_launch(
            a.code, a.xc.data_ptr(), a.xq.data_ptr(), a.syn.data_ptr(),
            a.idx_c.data_ptr(), a.idx_q.data_ptr(), mats.data_ptr(),
            vecs.data_ptr(), out_c.data_ptr(), out_q.data_ptr(),
            a.b, a.m, a.n, a.dc, a.dq, rounds, stream)
    if err != 0:
        raise RuntimeError(f"fused_rounds kernel launch failed: CUDA error {err}")
    _LAUNCHES["fused_rounds"] += 1
    return out_c.float(), out_q.float()
