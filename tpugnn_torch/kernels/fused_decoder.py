"""R weight-tied message rounds of the decoder in one kernel launch.

The port of ``tpugnn/kernels/fused_decoder.py``.  ``decoder_rounds`` runs all
R rounds of both message directions (check and qubit updates, residual and
LayerNorm) on node states in the batch layout ``[B, rows, H]``:

* a tensor on the CPU goes to :func:`rounds_plain`, the plain PyTorch
  version, which defines the function;
* a tensor on a CUDA device goes to the hand-written kernel
  ``csrc/wide_rounds.cuh`` (the library ``wide_rounds``, bf16 states, or
  ``wide_rounds_tf32``, f32 states; built by ``_build.py``), which replaces
  the TPU kernel ``decoder_rounds_tiled`` (``pl.pallas_call`` at
  ``tpugnn/kernels/fused_decoder.py:637``).  It launches or raises; there is
  no fallback.  Its products run on Hopper's warpgroup MMA (``wgmma``):
  bf16 states in bf16, f32 states as three TF32 products of operands split
  into TF32 halves ("3xTF32", near f32 accuracy; the wrapper packs the
  weights once a call, :func:`wgmma_pack`);
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

The kernel takes packs of 128, 256, 384 or 512 columns (``WIDE_MAX``), each
width an instantiation of the same templates.  A model runs at the kernel
width :func:`kernel_width` of its packs, ``W = 128 ceil(max(hidden,
msg_hidden) / 128)``, counted in :func:`launch_counts` as ``fused_rounds`` at
128 and ``fused_rounds_wide`` above it.
States and packs are zero-padded to ``W`` (:func:`pad_packs`,
:func:`pad_states`), which keeps every padded column exactly 0 through a
round, and the LayerNorm takes its mean and variance over the model's first
``hidden`` columns (``width=h`` in the plain versions; 0 on the rest).  The
padding is exact, as the JAX package's ``pad_msg_width`` is
(``tpugnn/kernels/fused_decoder.py:127-142``).  A model whose
``msg_hidden`` differs from its ``hidden`` packs at the larger of the two
(:func:`pack_weights_f32`), its states padded to that width as well where
``msg_hidden`` is the larger, the LayerNorm still over ``hidden``.  The
plain versions take any width; the kernels refuse only a pack wider than
``WIDE_MAX`` (:func:`check_width`).  The kernel keeps no gather panels: its
tiles of 64 or 128 rows gather from global memory, so it takes any graph.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["RoundWeights", "make_operators", "pack_weights", "pack_weights_f32", "pack_width",
           "kernel_width", "cast_packs", "pad_packs", "pad_states", "check_width",
           "rounds_plain", "decoder_rounds", "launch_counts", "reset_launch_counts",
           "tf32_round", "tf32_split_pack", "wgmma_pack", "wide_slab_rows", "wide_library",
           "STATE_DTYPES", "SMEM_LIMIT", "WIDTH", "WIDE_MAX"]

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper
WIDTH = 128          # the narrowest pack of the rounds kernels: narrower models pad to it
WIDE_MAX = 512       # the widest pack the rounds kernels take (csrc/wide_rounds.cuh)

# launches of the CUDA kernels in this process: K1 (decoder_rounds without
# grad), K2a and K2b (kernels/fused_backward.py), at 128 columns and, apart
# (``_wide``), above
_LAUNCHES = {"fused_rounds": 0, "fused_rounds_wide": 0, "fused_rounds_fwd_stash": 0,
             "fused_rounds_fwd_stash_wide": 0, "fused_rounds_bwd": 0,
             "fused_rounds_bwd_wide": 0}


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


def pack_width(w: RoundWeights) -> int:
    """The packs' width: ``max(hidden, msg_hidden)``."""
    return max(w.uc_x.shape[0], w.wd_c.shape[1])


def pack_weights_f32(w: RoundWeights):
    """The kernels' two weight operands in f32, differentiable in ``w``.

    ``mats`` [10, W, W] in the order
    ``wd_c, uc_x, ws_q, wo_c@uc_a, uc_w1, wd_q, uq_x, ws_c, wo_q@uq_a, uq_w1``
    (each direction's five: dst projection, state term, the projection that
    feeds the OTHER direction's gather, folded aggregation, update output);
    ``vecs`` [14, W]: ``b0, bo@ua, uc_s, ub0, ub1, ln_scale, ln_bias`` for
    checks, then the same for qubits with a zero row for the syndrome.
    ``W = max(hidden, msg_hidden)`` (:func:`pack_width`): every matrix and
    vector is zero-padded to it.  That is exact, as the JAX package's
    ``pad_msg_width`` (``tpugnn/kernels/fused_decoder.py:127``) is: a padded
    message lane carries relu(0 + 0) = 0 and meets a zero row of ``wo``, a
    padded state column stays 0 (its LayerNorm scale and bias are 0), and
    the LayerNorm runs over the model's ``hidden`` columns (``width``).
    Training differentiates through this packing, as the JAX package's
    ``kernel_trained_rounds_tiled`` does, so the fold's gradients un-fold
    into ``wo``, ``ua`` and ``bo`` by autograd.
    """
    f32 = torch.float32
    wid = pack_width(w)
    f = lambda a: a.to(f32)
    # padded only where narrower: a pad is one more kernel launch a call
    sq = lambda a: a if a.shape == (wid, wid) else F.pad(
        a, (0, wid - a.shape[1], 0, wid - a.shape[0]))
    mats = torch.stack([sq(a) for a in (
        f(w.wd_c), f(w.uc_x), f(w.ws_q), f(w.wo_c) @ f(w.uc_a), f(w.uc_w1),
        f(w.wd_q), f(w.uq_x), f(w.ws_c), f(w.wo_q) @ f(w.uq_a), f(w.uq_w1))])
    row = lambda a: (f(a).reshape(-1) if a.numel() == wid
                     else F.pad(f(a).reshape(-1), (0, wid - a.numel())))
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


def pad_packs(mats: torch.Tensor, vecs: torch.Tensor, width: int = WIDTH):
    """The packs zero-padded to ``width`` columns (and rows), differentiably:
    ``mats`` [10, h, h] -> [10, width, width], ``vecs`` [14, h] -> [14,
    width]; as they are where ``h == width``.  The padded LayerNorm scale
    and bias are 0, so a padded column's state stays 0."""
    p = width - mats.shape[-1]
    return (mats, vecs) if p == 0 else (F.pad(mats, (0, p, 0, p)), F.pad(vecs, (0, p)))


def pad_states(*xs: torch.Tensor, width: int = WIDTH):
    """Each ``x`` [..., h] zero-padded to [..., width], differentiably (as it
    is where ``h == width``: ``F.pad`` would copy it)."""
    return tuple(x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))
                 for x in xs)


def check_width(h: int) -> None:
    """Raises unless the kernels take packs of width ``h``
    (:func:`pack_width`): ``WIDE_MAX`` is the limit."""
    if not 1 <= h <= WIDE_MAX:
        raise ValueError(f"the rounds kernels take hidden and msg_hidden of at most "
                         f"{WIDE_MAX}, got {h}")


def kernel_width(h: int) -> int:
    """The columns the kernels run packs of width ``h`` at: the next
    multiple of 128 (``WIDTH``)."""
    return WIDTH * -(-h // WIDTH)


def pack_weights(w: RoundWeights, dtype: torch.dtype):
    """``(mats, vecs)`` of :func:`pack_weights_f32` as the kernels and the
    plain versions read them (:func:`cast_packs`)."""
    return cast_packs(*pack_weights_f32(w), dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as the f32 kernels' ``cvt.rna.tf32.f32``
    does: to the nearest value with 10 explicit mantissa bits, ties away
    from zero (half an ulp added to the magnitude's bits, the low 13
    cleared).  The kernels split each operand ``x`` of a product into
    ``hi = tf32_round(x)`` and ``lo = tf32_round(x - hi)``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_pack(mats: torch.Tensor) -> torch.Tensor:
    """The f32 weight pack as f32 K5 (``csrc/roll_gather_tf32.cu``) reads it: each matrix
    ``w`` [W (k), W (n)] (W = 128) split into ``hi = tf32_round(w)`` and ``lo =
    tf32_round(w - hi)``, laid out in the B-fragment order of
    ``mma.m16n8k8`` so that a lane reads its four values of a k-step and
    n-tile with one 16-byte load: ``[10, k-step s, n-tile j, g, t, (hi,
    lo), (row 8s + t, row 8s + t + 4)]`` for column ``8j + g``, lane ``4g +
    t``.  ``hi + lo`` is ``w`` to within 2^-21 of ``|w|``."""
    m = mats.float()
    wid = m.shape[-1]
    hi = tf32_round(m)
    lo = tf32_round(m - hi)
    frag = lambda w: w.reshape(-1, wid // 8, 2, 4, wid // 8, 8).permute(0, 1, 4, 5, 3, 2)
    return torch.stack([frag(hi), frag(lo)], -2).contiguous()


def wide_slab_rows(wid: int, dt: torch.dtype) -> int:
    """The k rows of one weight slab of the rounds kernels at pack width
    ``wid`` (``Geo::KS`` in csrc/wide_mma.cuh): 32 in bf16; in f32 (TF32
    halves) 16, or 8 at 512 columns, so that the ring's slabs (at most 48
    KB each) fit in shared memory beside the f32 A tile."""
    if dt == torch.float32:
        return 16 if wid <= 384 else 8
    return 32


def wgmma_pack(mats: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The weight pack of the rounds kernels (``csrc/wide_mma.cuh``): each
    matrix ``w`` [W (k), W (n)] cut into slabs of ``KS =``
    :func:`wide_slab_rows` k rows, each slab contiguous (one bulk copy into
    the kernels' ring) and laid out as wgmma reads a K-major operand without
    swizzle, 16-byte core rows of ``T`` k values (8 bf16, 4 f32) for one n:
    ``[10, slab s, n // 8, (k % KS) // T, n % 8, k % T]``.  bf16 states:
    ``w`` in bf16.  f32 states: each slab holds ``hi = tf32_round(w)`` then
    ``lo = tf32_round(w - hi)`` in that layout,
    ``[10, s, (hi, lo), n // 8, (k % KS) // 4, n % 8, k % 4]``."""
    m = mats.float()
    wid = m.shape[-1]
    ks = wide_slab_rows(wid, dt)
    te = 4 if dt == torch.float32 else 8
    lay = lambda w: w.reshape(-1, wid // ks, ks // te, te, wid // 8, 8).permute(0, 1, 4, 2, 5, 3)
    if dt != torch.float32:
        return lay(m.to(dt)).contiguous()
    hi = tf32_round(m)
    return torch.stack([lay(hi), lay(tf32_round(m - hi))], 2).contiguous()


def wide_library(dt: torch.dtype, backward: bool = False) -> str:
    """The library of the rounds kernels for a state type, K1, K2a and (above
    128 columns) K5, or with ``backward`` K2b: f32 and bf16 states build
    apart, and the forward apart from the backward (``wide_rounds.cu``,
    ``wide_rounds_tf32.cu``, ``wide_backward.cu``, ``wide_backward_tf32.cu``)."""
    name = "wide_backward" if backward else "wide_rounds"
    return name + "_tf32" if dt == torch.float32 else name


def ln_mean(t: torch.Tensor, width: int | None) -> torch.Tensor:
    """The mean over the first ``width`` columns (all for None)."""
    return t.mean(-1, keepdim=True) if width is None else t[..., :width].mean(-1, keepdim=True)


def ln_mask(t: torch.Tensor, width: int | None) -> torch.Tensor:
    """``t`` with the columns from ``width`` on set to 0 (as it is for None)."""
    return t if width is None else F.pad(t[..., :width], (0, t.shape[-1] - width))


def layer_norm(v: torch.Tensor, width: int | None):
    """The rounds' LayerNorm before its scale and bias (eps 1e-6), over the
    first ``width`` columns: ``(nh, inv)``, ``nh`` 0 on the others."""
    ctr = ln_mask(v - ln_mean(v, width), width)
    inv = torch.rsqrt(ln_mean(ctr * ctr, width) + 1e-6)
    return ctr * inv, inv


def _update(x, ys_src, src, mask, deg, mats, vecs, synterm, rnd, keep=None, width=None):
    """One direction's node update (see the module docstring); the
    LayerNorm over the first ``width`` columns.

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
    nh, inv = layer_norm(x + hc @ mats[4] + vecs[4], width)
    if keep is not None:
        keep.update(live=(zin > 0) & (mask[None, :, :, None] > 0), hs=hs, t=t,
                    hc=hc, nh=nh, inv=inv)
    return rnd(nh * vecs[5] + vecs[6])


def rounds_packed(xc, xq, syn, operators, mats, vecs, *, rounds: int,
                  dtype: torch.dtype, stash=None, width: int | None = None):
    """The rounds on packed weights (:func:`cast_packs`); returns f32 states.

    ``stash``, a pair of lists, receives each round's input states in
    ``dtype`` (the residuals of training).  ``width``: the model's width
    when states and packs are zero-padded past it (:func:`pad_packs`), the
    LayerNorm's columns; None for all."""
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
            _update(xc, ys_c, src_c, mask_c, deg_c, mats[0:5], vecs[0:7], synterm, rnd,
                    width=width),
            _update(xq, ys_q, src_q, mask_q, deg_q, mats[5:10], vecs[7:14], 0.0, rnd,
                    width=width),
        )
    return xc, xq


def rounds_plain(xc, xq, syn, operators, weights: RoundWeights, *, rounds: int,
                 state_dtype: str = "float32"):
    """Plain PyTorch version of the fused rounds; returns f32 states.

    ``xc`` [B, M, H], ``xq`` [B, N, H], ``syn`` [B, M, 1] (or [B, M]).
    States are stored in ``state_dtype`` and rounded at the same points as
    the kernel; every product and sum runs in f32.  Where ``msg_hidden >
    hidden`` the states run zero-padded to the packs' width, the LayerNorm
    over their first H columns.
    """
    dt = STATE_DTYPES[state_dtype]
    mats, vecs = pack_weights(weights, dt)
    h, wid = xc.shape[-1], mats.shape[-1]
    xc, xq = pad_states(xc, xq, width=wid)
    xc, xq = rounds_packed(xc, xq, syn, operators, mats, vecs, rounds=rounds, dtype=dt,
                           width=h if wid > h else None)
    return xc[..., :h], xq[..., :h]


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


def _forward_launch(xc, xq, syn, operators, mats, vecs, rounds: int, dt: torch.dtype,
                   width: int, *, stash: bool):
    """K1 (K2a with ``stash``) on states and packs padded to a multiple of
    128 (``csrc/wide_rounds.cuh``); ``width`` is the LayerNorm's columns.
    Returns ``(out_c, out_q, stash_c, stash_q)`` in the state type (the
    stash entries None without ``stash``).  K2a writes round r's input
    states into entry r of the stash and reads them back for the next round,
    K1 updates its outputs in place: the same arithmetic, so the same bits.
    Raises on what the kernel does not take."""
    from tpugnn_torch.kernels._build import load_library

    src_c, mask_c, _, src_q, mask_q, _ = operators
    b, m, wid = xc.shape
    n = xq.shape[1]
    dc, dq = src_c.shape[1], src_q.shape[1]
    check_width(wid)
    if wid % WIDTH or tuple(mats.shape[-2:]) != (wid, wid):
        raise ValueError(f"the rounds kernels take states and packs padded to a multiple "
                         f"of {WIDTH}, got {wid} and {tuple(mats.shape[-2:])}")
    if xq.shape[0] != b or xq.shape[2] != wid:
        raise ValueError(f"state shapes disagree: {tuple(xc.shape)} vs {tuple(xq.shape)}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if src_c.shape[0] != m or src_q.shape[0] != n:
        raise ValueError("operators do not match the state rows")
    dev = xc.device
    for t in (xq, syn, src_c, src_q, mask_c, mask_q, mats, vecs):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    lib = load_library(wide_library(dt))
    code = _DTYPE_CODE[dt]
    idx_c, idx_q = _slot_tables(src_c, mask_c, src_q, mask_q)
    pack = wgmma_pack(mats, dt)
    vecs = vecs.float().contiguous()
    xc = xc.detach().to(dt).contiguous()
    xq = xq.detach().to(dt).contiguous()
    syn = syn.detach().reshape(b, m).to(torch.float32).contiguous()
    out_c, out_q = torch.empty_like(xc), torch.empty_like(xq)
    ys_c = torch.empty((b, n, wid), dtype=dt, device=dev)   # the gathers' sources
    ys_q = torch.empty((b, m, wid), dtype=dt, device=dev)
    st_c = st_q = None
    if stash:
        st_c = torch.empty((rounds, b, m, wid), dtype=dt, device=dev)
        st_q = torch.empty((rounds, b, n, wid), dtype=dt, device=dev)
    with _cuda_stream(dev) as stream:
        err = lib.wide_rounds_launch(
            code, xc.data_ptr(), xq.data_ptr(), syn.data_ptr(), idx_c.data_ptr(),
            idx_q.data_ptr(), pack.data_ptr(), vecs.data_ptr(), out_c.data_ptr(),
            out_q.data_ptr(), None if st_c is None else st_c.data_ptr(),
            None if st_q is None else st_q.data_ptr(), ys_c.data_ptr(), ys_q.data_ptr(),
            b, m, n, dc, dq, rounds, wid, width, stream)
    name = ("fused_rounds_fwd_stash" if stash else "fused_rounds") + (
        "_wide" if wid > WIDTH else "")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _LAUNCHES[name] += 1
    return out_c, out_q, st_c, st_q


def _rounds_cuda(xc, xq, syn, operators, weights, rounds, state_dtype):
    if _needs_grad(xc, xq, syn, weights):
        from tpugnn_torch.kernels.fused_backward import trained_rounds

        return trained_rounds(xc, xq, syn, operators, weights, rounds, state_dtype,
                              kernels=True)
    dt = STATE_DTYPES[state_dtype]
    mats, vecs = pack_weights(weights, dt)
    check_width(mats.shape[-1])
    h = xc.shape[-1]   # the model's width, the LayerNorm's columns
    if h != weights.uc_x.shape[0]:
        raise ValueError(f"states of width {h}, weights of width {weights.uc_x.shape[0]}")
    wid = kernel_width(mats.shape[-1])
    mats, vecs = pad_packs(mats, vecs, wid)
    xc, xq = pad_states(xc, xq, width=wid)
    out_c, out_q, _, _ = _forward_launch(xc, xq, syn, operators, mats, vecs, rounds, dt, h,
                                        stash=False)
    return out_c[..., :h].float(), out_q[..., :h].float()
