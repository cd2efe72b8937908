"""Per-slot edge hidden states in ELL slot order: the SDDMM kernel K4.

The port of ``tpugnn/kernels/sddmm.py``: the first layer of one direction's
edge MLP with the concat split (``models/fused_cell.py``), for every ELL slot
of every destination row::

    out[b, r*D + k, :] = relu(ys[b, src[r, k]] + yd[b, r] + bias) * mask[r, k]
    yd = x_dst @ wd,  ys = x_src @ ws

``x_dst`` [B, rows_dst, H], ``x_src`` [B, rows_src, H], ``slot_src``
[rows_dst, D] the source row of each slot (the table ``make_operators``
gives; JAX's one-hot ``g_src`` is its one-hot), ``wd``/``ws`` [H, MH],
``bias`` [MH]; out f32 [B, rows_dst * D, MH].  In ``compute_dtype``
bfloat16 it rounds as the JAX kernel does (``sddmm.py:40-55``): the
operands to bf16, each projection accumulated in f32 and rounded to bf16,
``bf16(bf16(zs + zd) + bias)``, relu and the mask in bf16, the result as
f32.  In float32 everything is f32.

* a tensor on the CPU goes to :func:`sddmm_edge_hidden_plain`, which
  defines the function;
* a tensor on a CUDA device goes to the hand-written kernels of
  ``csrc/sddmm.cu``, which replace ``sddmm_edge_hidden``
  (``pl.pallas_call`` at ``tpugnn/kernels/sddmm.py:100``): in bfloat16 at
  ``H = MH = 128`` the tensor-core kernel (``mma.sync``, weights rounded to
  bf16 here, once), at any other width or in float32 the f32 FMA kernel.
  The shape picks the kernel, never a failure: each launches or raises;
  there is no fallback.  Neither has a backward (nor has JAX's).
"""

from __future__ import annotations

import torch

from tpugnn_torch.kernels.fused_decoder import (
    _DTYPE_CODE,
    SMEM_LIMIT,
    STATE_DTYPES,
    _cuda_stream,
)

__all__ = ["sddmm_edge_hidden", "sddmm_edge_hidden_plain", "launch_counts",
           "reset_launch_counts"]

_TC_WIDTH = 128  # H = MH of the tensor-core kernel (rounds_common.cuh's width)

# launches per kernel: the f32 FMA kernel and the bf16 tensor-core kernel
_LAUNCHES = {"sddmm_edge_hidden": 0, "sddmm_edge_hidden_tc": 0}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def sddmm_edge_hidden_plain(x_dst, x_src, slot_src, slot_mask, wd, ws, b, *,
                            compute_dtype: str = "bfloat16") -> torch.Tensor:
    """K4's function in plain PyTorch (f32 arithmetic on values rounded to
    ``compute_dtype`` where the JAX kernel rounds)."""
    cdt = STATE_DTYPES[compute_dtype]
    rnd = lambda t: t.to(cdt).float()
    d = slot_src.shape[1]
    yd = rnd(rnd(x_dst) @ rnd(wd))
    ys = rnd(rnd(x_src) @ rnd(ws))
    zs = ys.index_select(1, slot_src.reshape(-1).long())
    zd = yd.repeat_interleave(d, dim=1)
    pre = rnd(rnd(zs + zd) + rnd(b).reshape(-1))
    return torch.relu(pre) * slot_mask.reshape(1, -1, 1).float()


def sddmm_edge_hidden(x_dst, x_src, slot_src, slot_mask, wd, ws, b, *,
                      compute_dtype: str = "bfloat16") -> torch.Tensor:
    """relu(gather(x_src @ ws) + broadcast(x_dst @ wd) + b), masked, in ELL
    slot order: f32 [B, rows_dst * D, MH].  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if compute_dtype not in STATE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(STATE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    operands = (x_dst, x_src, slot_mask, wd, ws, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("sddmm_edge_hidden has no backward (nor has the JAX "
                           "package's kernel): call it without grad")
    if x_dst.device.type == "cpu":
        return sddmm_edge_hidden_plain(x_dst, x_src, slot_src, slot_mask, wd, ws, b,
                                       compute_dtype=compute_dtype)
    if x_dst.device.type != "cuda":
        raise ValueError(f"sddmm_edge_hidden runs on cpu or cuda, not {x_dst.device}")
    return _sddmm_cuda(x_dst, x_src, slot_src, slot_mask, wd, ws, b,
                       STATE_DTYPES[compute_dtype])


def _sddmm_cuda(x_dst, x_src, slot_src, slot_mask, wd, ws, b, cdt):
    from tpugnn_torch.kernels._build import load_library

    bsz, rows_dst, h = x_dst.shape
    rows_src = x_src.shape[1]
    d = slot_src.shape[1]
    mh = wd.shape[1]
    if x_src.shape[0] != bsz or x_src.shape[2] != h:
        raise ValueError(f"state shapes disagree: {tuple(x_dst.shape)} vs {tuple(x_src.shape)}")
    if tuple(wd.shape) != (h, mh) or tuple(ws.shape) != (h, mh) or b.numel() != mh:
        raise ValueError(f"weights must be [H, MH] = [{h}, {mh}] and bias [MH]")
    if tuple(slot_src.shape) != (rows_dst, d) or tuple(slot_mask.shape) != (rows_dst, d):
        raise ValueError("slot tables must be [rows_dst, D]")
    dev = x_dst.device
    for t in (x_src, slot_src, slot_mask, wd, ws, b):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    lib = load_library("sddmm")
    tc = cdt == torch.bfloat16 and h == mh == _TC_WIDTH   # the tensor-core kernel
    if tc:
        smem = lib.sddmm_tc_smem_bytes(rows_dst, rows_src, d)
    else:
        smem = lib.sddmm_smem_bytes(rows_dst, rows_src, d, mh)
    if smem > SMEM_LIMIT:
        raise ValueError(f"too large for the SDDMM kernel: needs {smem} B of shared "
                         f"memory per block (rows_src={rows_src}, MH={mh}), limit "
                         f"{SMEM_LIMIT}")
    xd = _aligned(x_dst.detach().to(cdt).contiguous())
    xs = _aligned(x_src.detach().to(cdt).contiguous())
    tbl = torch.where(slot_mask > 0, slot_src, -1).to(torch.int32).contiguous()
    wdt = cdt if tc else torch.float32   # the tensor-core kernel reads bf16 weights
    wd_k, ws_k = (_aligned(w.detach().to(wdt).contiguous()) for w in (wd, ws))
    b32 = _aligned(b.detach().to(torch.float32).reshape(-1).contiguous())
    out = torch.empty((bsz, rows_dst * d, mh), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with _cuda_stream(dev) as stream:
        if tc:
            err = lib.sddmm_edge_hidden_tc_launch(
                xd.data_ptr(), xs.data_ptr(), tbl.data_ptr(), wd_k.data_ptr(),
                ws_k.data_ptr(), b32.data_ptr(), out.data_ptr(), bsz, rows_dst, rows_src,
                d, h, mh, stream)
        else:
            err = lib.sddmm_edge_hidden_launch(
                _DTYPE_CODE[cdt], xd.data_ptr(), xs.data_ptr(), tbl.data_ptr(),
                wd_k.data_ptr(), ws_k.data_ptr(), b32.data_ptr(), out.data_ptr(),
                bsz, rows_dst, rows_src, d, h, mh, stream)
    if err != 0:
        raise RuntimeError(f"sddmm_edge_hidden kernel launch failed: CUDA error {err}")
    _LAUNCHES["sddmm_edge_hidden_tc" if tc else "sddmm_edge_hidden"] += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its storage offset breaks the kernels'
    16-byte loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
