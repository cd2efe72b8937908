"""ELL slot-table aggregation of per-edge messages into rows: K3a and K3b.

The port of ``tpugnn/kernels/spmm.py``.  For a destination side with slot
tables ``slot_edge`` [rows, D] (canonical edge ids, sentinel ``E_pad - 1``)
and ``slot_mask`` [rows, D]::

    sum:  out[b, r, :] = sum_k mask[r, k] * msg[b, slot_edge[r, k], :]
    max:  out[b, r, :] = max over the valid slots k of msg[b, slot_edge[r, k], :],
          0 for a row without a valid slot

``msg`` [..., E_pad, F] is read as f32 and the result is f32 [..., rows, F];
mean is the sum, divided by the caller (``tpugnn_torch.mp.aggregate``).

* a tensor on the CPU goes to the plain versions :func:`ell_aggregate_plain`
  and :func:`ell_max_plain`, which define the function;
* a tensor on a CUDA device goes to the hand-written kernels of
  ``csrc/spmm.cu``: K3a replaces ``_ell_aggregate_impl`` (``pl.pallas_call``
  at ``tpugnn/kernels/spmm.py:79``), K3b ``_ell_max_impl`` (``:129``).  They
  launch or raise; there is no fallback.

Neither has a backward (the JAX package defines none): a call whose operand
requires grad raises.
"""

from __future__ import annotations

import torch

from tpugnn_torch.kernels.fused_decoder import _DTYPE_CODE, _cuda_stream

__all__ = ["ell_aggregate", "ell_aggregate_plain", "ell_max_plain", "PLAIN",
           "launch_counts", "reset_launch_counts"]

# launches of the CUDA kernels in this process: K3a (sum and mean), K3b (max)
_LAUNCHES = {"ell_sum": 0, "ell_max": 0}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _slots(msg: torch.Tensor, slot_edge: torch.Tensor) -> torch.Tensor:
    """f32 [B', rows, D, F]: the message of every slot."""
    rows, d = slot_edge.shape
    sl = msg.float().index_select(1, slot_edge.reshape(-1).long())
    return sl.reshape(msg.shape[0], rows, d, msg.shape[-1])


def ell_aggregate_plain(msg: torch.Tensor, slot_edge: torch.Tensor,
                        slot_mask: torch.Tensor) -> torch.Tensor:
    """K3a's function in plain PyTorch: msg [B', E_pad, F] -> f32 [B', rows, F]."""
    return (_slots(msg, slot_edge) * slot_mask[None, :, :, None].float()).sum(2)


def ell_max_plain(msg: torch.Tensor, slot_edge: torch.Tensor,
                  slot_mask: torch.Tensor) -> torch.Tensor:
    """K3b's function in plain PyTorch: the masked slot max, 0 for a row with
    no valid slot (``jnp.where(isneginf(mx), 0, mx)``, which also zeroes a
    row whose valid messages are all -inf)."""
    sl = torch.where(slot_mask[None, :, :, None] > 0, _slots(msg, slot_edge),
                     float("-inf"))
    mx = sl.amax(2)
    return torch.where(torch.isneginf(mx), 0.0, mx)


PLAIN = {"sum": ell_aggregate_plain, "mean": ell_aggregate_plain, "max": ell_max_plain}


def ell_aggregate(msg: torch.Tensor, slot_edge: torch.Tensor, slot_mask: torch.Tensor,
                  *, agg: str = "sum") -> torch.Tensor:
    """Aggregate per-edge messages into destination rows through the ELL
    tables: msg [..., E_pad, F] -> f32 [..., rows, F].  sum and mean run K3a
    (mean is scaled by the caller), max runs K3b."""
    if agg not in PLAIN:
        raise ValueError(f"unknown aggregation {agg!r}; have sum|mean|max")
    if torch.is_grad_enabled() and (msg.requires_grad or slot_mask.requires_grad):
        raise RuntimeError("ell_aggregate has no backward (nor has the JAX "
                           "package's spmm kernel): call it without grad")
    rows = slot_edge.shape[0]
    e_pad, f = msg.shape[-2], msg.shape[-1]
    lead = msg.shape[:-2]
    msg3 = msg.reshape((-1, e_pad, f))
    if msg.device.type == "cpu":
        out = PLAIN[agg](msg3, slot_edge, slot_mask)
    elif msg.device.type == "cuda":
        out = _ell_cuda(msg3, slot_edge, slot_mask, agg)
    else:
        raise ValueError(f"ell_aggregate runs on cpu or cuda, not {msg.device}")
    return out.reshape(lead + (rows, f))


def _ell_cuda(msg: torch.Tensor, slot_edge: torch.Tensor, slot_mask: torch.Tensor,
              agg: str) -> torch.Tensor:
    """Launches K3a or K3b on msg [B', E_pad, F]; raises on what they do not take."""
    from tpugnn_torch.kernels._build import load_library

    if msg.dtype not in _DTYPE_CODE:
        raise ValueError(f"ell_aggregate reads f32 or bf16 messages, not {msg.dtype}")
    b, e_pad, f = msg.shape
    rows, d = slot_edge.shape
    if tuple(slot_mask.shape) != (rows, d):
        raise ValueError(f"slot tables disagree: {tuple(slot_edge.shape)} vs "
                         f"{tuple(slot_mask.shape)}")
    dev = msg.device
    for t in (slot_edge, slot_mask):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    msg = msg.contiguous()
    # source edge per slot, -1 for a masked slot (the kernels skip it)
    tbl = torch.where(slot_mask > 0, slot_edge, -1).to(torch.int32).contiguous()
    out = torch.empty((b, rows, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = load_library("spmm")
    is_max = agg == "max"
    with _cuda_stream(dev) as stream:
        err = lib.ell_aggregate_launch(_DTYPE_CODE[msg.dtype], int(is_max),
                                       msg.data_ptr(), tbl.data_ptr(), out.data_ptr(),
                                       b, e_pad, f, rows, d, stream)
    if err != 0:
        raise RuntimeError(f"ell_aggregate kernel launch failed: CUDA error {err}")
    _LAUNCHES["ell_max" if is_max else "ell_sum"] += 1
    return out
