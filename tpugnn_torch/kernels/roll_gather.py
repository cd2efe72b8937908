"""The fused rounds on a raster of the rotated surface code: K5.

The port of ``tpugnn/kernels/roll_gather.py``.  It computes the function of
:mod:`tpugnn_torch.kernels.fused_decoder` (R weight-tied rounds of both
message directions) for an open-boundary rotated surface code, with the node
rows laid out on a (d+1)-pitch raster: check (plaquette) (i, j) at cell
``i*(d+1)+j``, data qubit (r, c) at cell ``r*(d+1)+c``, in ``L = (d+1)^2``
cells padded to ``l_pad``, a multiple of 8.  On that raster every slot reads
its source at a constant offset (``offs_c = (0, -1, -(d+1), -(d+2))`` for
checks, ``offs_q = (0, 1, d+1, d+2)`` for qubits), so a gather is a rotation
``x[(i + o) mod l_pad]`` and a per-cell slot mask.

:func:`decoder_rounds_roll` takes and returns the original row layout in
f32.  It permutes the rows into the raster (:func:`to_raster`), runs the
rounds there on every cell, empty cells included, and permutes back
(:func:`from_raster`):

* a tensor on the CPU goes to :func:`roll_rounds_plain`, the plain PyTorch
  version, which defines the function;
* a tensor on a CUDA device goes to the hand-written kernel
  ``csrc/roll_gather.cu`` (bf16 states; f32 states build apart from
  ``csrc/roll_gather_tf32.cu``), which replaces the TPU kernel
  ``decoder_rounds_roll`` (``pl.pallas_call`` at
  ``tpugnn/kernels/roll_gather.py:364``).  Its products run on the tensor
  cores (``mma.sync``, K1's routines in ``csrc/rounds_mma.cuh``): with bf16
  states in bf16, with f32 states as three TF32 products of operands split
  into TF32 halves ("3xTF32", near f32 accuracy; the wrapper splits the
  weights, :func:`~tpugnn_torch.kernels.fused_decoder.tf32_split_pack`, and
  stacks a small raster's samples into one block, :func:`samples_per_block`).  It
  launches or raises; there is no fallback to the plain version, to the
  other instantiation or to K1.

It is inference only, as in the JAX package: a call that autograd would have
to differentiate raises.

As K1's, the kernel is built for 128 columns: a narrower model's raster
operands are zero-padded to 128 (:func:`pad_raster`) and its LayerNorm runs
over the model's ``width`` columns; a model with ``msg_hidden > hidden``
runs on states padded to the packs' width first (:func:`decoder_rounds_roll`).
Packs wider than 128 run, padded to the next multiple of 128, on the wide
rounds kernel's raster mode (``csrc/wide_rounds.cuh``, ``roll_rounds_wide``),
up to ``WIDE_MAX`` columns.  A raster whose gather panels do not fit in
shared memory runs the kernel's variant with them in global memory
(f32 states at d=15, ``roll_rounds_gpanels``; bf16 states at d >= 17,
``roll_rounds_tc_gpanels``).

One round, per side (checks shown; qubits alike without the syndrome term),
with ``rnd`` rounding to the state type ``cdt`` and ``sdt`` the slot type
(f32, or ``cdt`` with ``slot_dtype='bfloat16'``)::

    ydb   = x @ wd_c + b0_c                                  f32
    ys    = rnd(x_q @ ws_c)                                  sources
    hs    = t_0 + t_1 + t_2 + t_3,   in offs order, each add in sdt
    t_k   = relu(rot(ys, o_k).to(sdt) + ydb.to(sdt)) * mask_k
    agg   = rnd(hs) @ (wo_c @ uc_a) + (deg * bo_c) @ uc_a
    pre   = x @ uc_x + agg + rnd(syn * uc_s) + uc_b0
    x'    = rnd(LN(x + rnd(relu(pre)) @ uc_w1 + uc_b1))      LN eps 1e-6

That is the term order of the JAX kernel (``round_body``,
``tpugnn/kernels/roll_gather.py:244-273``), which differs from K1's plain
version in the slot order and in ``(deg * bo) @ ua`` against
``deg * (bo @ ua)``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpugnn_torch.kernels.fused_decoder import (
    _DTYPE_CODE,
    SMEM_LIMIT,
    STATE_DTYPES,
    WIDTH,
    RoundWeights,
    _cuda_stream,
    _needs_grad,
    check_width,
    kernel_width,
    layer_norm,
    pack_weights_f32,
    pad_packs,
    pad_states,
    tf32_split_pack,
    wgmma_pack,
    wide_library,
)

__all__ = ["RollPlan", "RasterOperands", "raster_plan", "plan_for_graph", "rotate",
           "to_raster", "from_raster", "pad_raster", "roll_rounds_plain",
           "decoder_rounds_roll", "roll_library", "launch_counts", "reset_launch_counts",
           "samples_per_block", "SLOT_DTYPES"]

SLOT_DTYPES = ("float32", "bfloat16")
F32_CHUNK_ROWS = 144   # rows of one f32 K5 chunk (9 warps; t3r::CRN in csrc/roll_gather_tf32.cu)

def samples_per_block(b: int, m: int, n: int) -> int:
    """How many samples one block of f32 K5's shared-panel kernel takes: the
    largest power of two ``s`` dividing ``b`` whose ``s`` samples' check and
    qubit rows each fit in one chunk of ``F32_CHUNK_ROWS`` rows.  A small
    raster (d=3: 16 cells) would otherwise keep one warp of nine busy while
    every weight streams."""
    s = 1
    while b % (2 * s) == 0 and 2 * s * max(m, n) <= F32_CHUNK_ROWS:
        s *= 2
    return s


# launches of the CUDA kernel in this process: K5, its variants with the
# gather panels in global memory (f32 and bf16, two kernels) and its wide
# kernel apart
_LAUNCHES = {"roll_rounds": 0, "roll_rounds_gpanels": 0, "roll_rounds_tc_gpanels": 0,
             "roll_rounds_wide": 0}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


class RollPlan(NamedTuple):
    """Raster layout and slot offsets of one surface-code graph (NumPy)."""

    d: int
    l_pad: int                 # raster length, padded to a multiple of 8
    offs_c: tuple              # per-slot source offsets, check side (qubits)
    offs_q: tuple              # per-slot source offsets, qubit side (checks)
    cell_of_check: np.ndarray  # i32[m_pad] raster cell of each original row
    cell_of_qubit: np.ndarray  # i32[n_pad]
    mask_c: np.ndarray         # f32[Dc, l_pad, 1] slot-valid masks (check side)
    mask_q: np.ndarray         # f32[Dq, l_pad, 1]
    deg_c: np.ndarray          # f32[l_pad, 1] raster check degrees
    deg_q: np.ndarray          # f32[l_pad, 1]


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def raster_plan(graph) -> RollPlan | None:
    """The raster permutation and slot offsets of ``graph``, or None if it is
    not an open-boundary rotated surface code.  Checked by structure, not by
    name: every check's support must sit on one plaquette and every edge on
    one of the four constant offsets.  The graph's arrays may be NumPy
    arrays or tensors."""
    n, m = graph.n_qubits, graph.n_checks
    d = math.isqrt(n)
    if d * d != n or m != n - 1:
        return None
    ec = _np(graph.edge_check)[: graph.n_edges]
    eq = _np(graph.edge_qubit)[: graph.n_edges]
    cell_q = np.array([(q // d) * (d + 1) + (q % d) for q in range(n)], np.int32)
    # plaquette (i, j) of each check from its qubit support: the rows present
    # are {i-1, i} clipped to the grid; a single row r0 means i = 0 (r0 = 0)
    # or i = d (r0 = d-1); the same for columns
    sup_r: list[list[int]] = [[] for _ in range(m)]
    sup_c: list[list[int]] = [[] for _ in range(m)]
    for c, q in zip(ec.tolist(), eq.tolist()):
        if c >= m or q >= n:
            return None
        sup_r[c].append(q // d)
        sup_c[c].append(q % d)

    def corner(vals: list[int]) -> int | None:
        lo, hi = min(vals), max(vals)
        if hi == lo + 1:
            return hi
        if hi == lo:
            return 0 if lo == 0 else (d if lo == d - 1 else None)
        return None

    cell_c = np.zeros(m, np.int32)
    for c in range(m):
        if not sup_r[c]:
            return None
        i, j = corner(sup_r[c]), corner(sup_c[c])
        if i is None or j is None:
            return None
        cell_c[c] = i * (d + 1) + j
    if len(set(cell_c.tolist())) != m:
        return None

    l_pad = -(-(d + 1) * (d + 1) // 8) * 8
    offs_c = (0, -1, -(d + 1), -(d + 2))
    offs_q = (0, 1, d + 1, d + 2)
    # slot masks from the edge set (exact: wrap-around and missing neighbours
    # never appear as edges)
    edges = {(int(cell_c[c]), int(cell_q[q])) for c, q in zip(ec, eq)}
    mask_c = np.zeros((len(offs_c), l_pad, 1), np.float32)
    mask_q = np.zeros((len(offs_q), l_pad, 1), np.float32)
    for k, o in enumerate(offs_c):
        for cc in cell_c.tolist():
            if (cc, cc + o) in edges:
                mask_c[k, cc, 0] = 1.0
    for k, o in enumerate(offs_q):
        for qq in cell_q.tolist():
            # edges are (check cell, qubit cell): the qubit side's source at
            # offset o is the check at cell qq + o
            if (qq + o, qq) in edges:
                mask_q[k, qq, 0] = 1.0
    # every edge covered exactly once across the slots
    if mask_c.sum() != len(edges) or mask_q.sum() != len(edges):
        return None
    # every padded row maps to the last cell, which no real node holds
    m_pad, n_pad = graph.n_checks_pad, graph.n_qubits_pad
    cell_of_check = np.full(m_pad, l_pad - 1, np.int32)
    cell_of_check[:m] = cell_c
    cell_of_qubit = np.full(n_pad, l_pad - 1, np.int32)
    cell_of_qubit[:n] = cell_q
    return RollPlan(d, l_pad, offs_c, offs_q, cell_of_check, cell_of_qubit,
                    mask_c, mask_q, mask_c.sum(axis=0), mask_q.sum(axis=0))


@functools.lru_cache(maxsize=16)
def _plan_from_name(name: str, pad_nodes: int = 8, pad_edges: int = 8):
    """``(graph, plan)`` of the surface code ``name`` names ('surface_d11'),
    rebuilt at the given padding; None for any other name."""
    if not name.startswith("surface_d"):
        return None
    try:
        d = int(name[len("surface_d"):])
    except ValueError:
        return None
    from tpugnn_torch.tanner import build_code

    g = build_code("surface", d, pad_nodes=pad_nodes, pad_edges=pad_edges)
    return g, raster_plan(g)


def plan_for_graph(graph) -> RollPlan | None:
    """The raster plan of ``graph``, or None where the roll rounds do not
    apply.  As ``tpugnn.models.pallas_decoder`` does, the plan comes from
    the code rebuilt from the graph's name at the default padding (cached
    by name), and applies only when that graph's padded row counts equal
    ``graph``'s."""
    built = _plan_from_name(graph.name)
    if built is None or built[1] is None:
        return None
    g, plan = built
    if g.n_checks_pad != graph.n_checks_pad or g.n_qubits_pad != graph.n_qubits_pad:
        return None
    return plan


def rotate(x: torch.Tensor, o: int) -> torch.Tensor:
    """``out[:, i] = x[:, (i + o) mod l_pad]`` on the raster axis 1 (the JAX
    kernel's ``_rot``)."""
    return torch.roll(x, -o, dims=1)


class RasterOperands(NamedTuple):
    """One call's operands on the raster, as K5 and its plain version read
    them."""

    xc: torch.Tensor        # [B, l_pad, H] check states in the state type
    xq: torch.Tensor        # [B, l_pad, H] qubit states
    syn: torch.Tensor       # [B, l_pad] f32 syndrome feature (0 off the checks)
    masks: torch.Tensor     # [2, 4, l_pad] f32 slot masks: checks, qubits
    degbo: torch.Tensor     # [2, l_pad, H] f32 (deg * bo) @ ua per side
    mats: torch.Tensor      # [10, H, H] folded matrices in the state type
    vecs: torch.Tensor      # [14, H] f32 vectors (row 2: uc_s, unrounded)
    offs_c: tuple
    offs_q: tuple


def _raster_index(cells: np.ndarray, l_pad: int, dev):
    """For each cell the original row it takes, and whether any row maps
    there.  Every padded row maps to the last cell; the highest row index
    among them is taken (the JAX package leaves that choice to XLA's
    duplicate-index scatter).  The embed zeroes padded rows, so which one it
    is does not show."""
    inv = np.zeros(l_pad, np.int64)
    np.maximum.at(inv, cells, np.arange(len(cells)))
    owned = np.zeros(l_pad, np.float32)
    owned[cells] = 1.0
    return (torch.as_tensor(inv, device=dev), torch.as_tensor(owned, device=dev))


def to_raster(xc, xq, syn, plan: RollPlan, weights: RoundWeights,
              state_dtype: str = "float32") -> RasterOperands:
    """The operands of the roll rounds from original-layout states ``xc``
    [B, m_pad, H], ``xq`` [B, n_pad, H] and ``syn`` [B, m_pad, 1] (or [B,
    m_pad]).  A cell no row maps to starts at zero."""
    dt = STATE_DTYPES[state_dtype]
    b, m_pad, h = xc.shape
    n_pad = xq.shape[1]
    if (m_pad, n_pad) != (len(plan.cell_of_check), len(plan.cell_of_qubit)):
        raise ValueError(f"state rows ({m_pad}, {n_pad}) do not match the plan's "
                         f"({len(plan.cell_of_check)}, {len(plan.cell_of_qubit)})")
    dev = xc.device
    inv_c, own_c = _raster_index(plan.cell_of_check, plan.l_pad, dev)
    inv_q, own_q = _raster_index(plan.cell_of_qubit, plan.l_pad, dev)
    take = lambda x, inv, own: (x.float().index_select(1, inv) * own[:, None]).to(dt)
    syn_r = syn.reshape(b, m_pad).float().index_select(1, inv_c) * own_c
    mats32, vecs32 = pack_weights_f32(weights)
    deg = torch.as_tensor(np.stack([plan.deg_c[:, 0], plan.deg_q[:, 0]]), device=dev)
    f = lambda a: a.float().reshape(1, -1)
    degbo = torch.stack([(deg[0][:, None] * f(weights.bo_c)) @ weights.uc_a.float(),
                         (deg[1][:, None] * f(weights.bo_q)) @ weights.uq_a.float()])
    masks = torch.as_tensor(np.stack([plan.mask_c[..., 0], plan.mask_q[..., 0]]),
                            device=dev)
    return RasterOperands(take(xc, inv_c, own_c), take(xq, inv_q, own_q), syn_r,
                          masks, degbo, mats32.to(dt), vecs32, tuple(plan.offs_c),
                          tuple(plan.offs_q))


def pad_raster(ops: RasterOperands, width: int = WIDTH) -> RasterOperands:
    """``ops`` with states, ``degbo`` and packs zero-padded to ``width``
    columns (the kernel's operands for a narrower model)."""
    mats, vecs = pad_packs(ops.mats, ops.vecs, width)
    xc, xq, degbo = pad_states(ops.xc, ops.xq, ops.degbo, width=width)
    return ops._replace(xc=xc, xq=xq, degbo=degbo, mats=mats, vecs=vecs)


def from_raster(xc_r, xq_r, plan: RollPlan):
    """Raster states back to the original row layout, in f32: row ``r``
    reads cell ``cell_of_row[r]``, so every padded row reads the last cell."""
    dev = xc_r.device
    cells = lambda c: torch.as_tensor(c, dtype=torch.long, device=dev)
    return (xc_r.index_select(1, cells(plan.cell_of_check)).float(),
            xq_r.index_select(1, cells(plan.cell_of_qubit)).float())


def _slot_dtype(slot_dtype: str, dt: torch.dtype) -> torch.dtype:
    """f32 slots, or with ``'bfloat16'`` the state type (the JAX kernel's
    ``slot_f32=False``; with f32 states that changes nothing)."""
    if slot_dtype not in SLOT_DTYPES:
        raise ValueError(f"unknown slot_dtype {slot_dtype!r}; have {SLOT_DTYPES}")
    return torch.float32 if slot_dtype == "float32" else dt


def _slot_sum(ys, ydb, masks, offs, sdt):
    """``sum_k relu(rot(ys, o_k) + ydb) * mask_k`` in ``offs`` order, every
    op in ``sdt`` (PyTorch rounds a bf16 op's result once, as XLA does)."""
    ydb = ydb.to(sdt)
    hs = None
    for k, o in enumerate(offs):
        t = torch.relu(rotate(ys, o).to(sdt) + ydb) * masks[k].to(sdt)[:, None]
        hs = t if hs is None else hs + t
    return hs


def _update(x, ux, hs, wf, degbo, syn_term, ub0, w1, ub1, ln_s, ln_b, dt, width):
    """The rest of one side's round from the slot sum: returns the new
    states in ``dt``; the LayerNorm over the first ``width`` columns."""
    agg = hs.float() @ wf + degbo
    pre = ux + agg
    if syn_term is not None:
        pre = pre + syn_term
    hc = torch.relu(pre + ub0).to(dt).float()
    nh, _ = layer_norm(x + hc @ w1 + ub1, width)
    return (nh * ln_s + ln_b).to(dt)


def roll_rounds_plain(ops: RasterOperands, *, rounds: int, slot_dtype: str = "float32",
                      width: int | None = None):
    """Plain PyTorch version of K5: the rounds on the raster, every cell
    included; returns ``(xc, xq)`` [B, l_pad, H] in the state type.
    ``width``: the model's width on operands padded past it
    (:func:`pad_raster`), the LayerNorm's columns; None for all."""
    dt = ops.xc.dtype
    sdt = _slot_dtype(slot_dtype, dt)
    mats, v = ops.mats.float(), ops.vecs
    syn_term = (ops.syn[..., None] * v[2]).to(dt).float()
    xc, xq = ops.xc, ops.xq
    for _ in range(rounds):
        xcf, xqf = xc.float(), xq.float()
        ys_q = (xcf @ mats[2]).to(dt)     # check sources of the qubit side
        ys_c = (xqf @ mats[7]).to(dt)     # qubit sources of the check side
        hs_c = _slot_sum(ys_c, xcf @ mats[0] + v[0], ops.masks[0], ops.offs_c, sdt).to(dt)
        hs_q = _slot_sum(ys_q, xqf @ mats[5] + v[7], ops.masks[1], ops.offs_q, sdt).to(dt)
        xc, xq = (
            _update(xcf, xcf @ mats[1], hs_c, mats[3], ops.degbo[0], syn_term, v[3],
                    mats[4], v[4], v[5], v[6], dt, width),
            _update(xqf, xqf @ mats[6], hs_q, mats[8], ops.degbo[1], None, v[10],
                    mats[9], v[11], v[12], v[13], dt, width),
        )
    return xc, xq


def decoder_rounds_roll(xc, xq, syn, plan: RollPlan, weights: RoundWeights, *,
                        rounds: int, state_dtype: str = "float32",
                        slot_dtype: str = "float32"):
    """R fused rounds on the raster of ``plan``; takes and returns the
    original row layout, ``(xc [B, m_pad, H], xq [B, n_pad, H])`` in f32.

    CPU tensors take :func:`roll_rounds_plain`, CUDA tensors K5.  Inference
    only: with grad enabled and an operand that requires grad it raises."""
    if _needs_grad(xc, xq, syn, weights):
        raise RuntimeError("decoder_rounds_roll is inference only (as the JAX "
                           "package's roll kernel): call it under torch.no_grad() "
                           "or torch.inference_mode(), and train through "
                           "decoder_rounds")
    _slot_dtype(slot_dtype, STATE_DTYPES[state_dtype])
    if xc.device.type == "cpu":
        run = roll_rounds_plain
    elif xc.device.type == "cuda":
        run = _roll_rounds_cuda
    else:
        raise ValueError(f"decoder_rounds_roll runs on cpu or cuda, not {xc.device}")
    ops = to_raster(xc, xq, syn, plan, weights, state_dtype)
    h, wid = xc.shape[-1], ops.mats.shape[-1]
    width = None
    if wid > h:   # msg_hidden > hidden: the states run padded to the packs' width
        ops, width = pad_raster(ops, wid), h
    out_c, out_q = run(ops, rounds=rounds, slot_dtype=slot_dtype, width=width)
    return from_raster(out_c[..., :h], out_q[..., :h], plan)


def roll_library(dt: torch.dtype) -> str:
    """The library of K5 for a state type: f32 and bf16 states build apart
    (``roll_gather_tf32.cu``, ``roll_gather.cu``)."""
    return "roll_gather_tf32" if dt == torch.float32 else "roll_gather"


def _mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """int32 [2, l_pad] from the masks [2, 4, l_pad]: bit k of a cell's
    entry is set where slot k of that cell is an edge."""
    weight = torch.tensor([1, 2, 4, 8], dtype=torch.int32, device=masks.device)
    return ((masks > 0).int() * weight[None, :, None]).sum(1).to(torch.int32).contiguous()


def _roll_rounds_cuda(ops: RasterOperands, *, rounds: int, slot_dtype: str = "float32",
                      width: int | None = None):
    """Launches K5 on raster operands on a card; returns ``(xc, xq)``
    [B, l_pad, H] in the state type.  A model narrower than 128 runs on
    operands padded to 128 (:func:`pad_raster`), a wider one on operands
    padded to the next multiple of 128 on the wide kernel; ``width``, the
    LayerNorm's columns where the operands are already padded past the
    model's width (None: all ``H``).  With f32 states the
    weights go in split into TF32 halves (:func:`tf32_split_pack`), a
    persistent grid of one block per SM walks the samples with an f32
    scratch a block (the check states' second buffer; with global panels
    the panel too), and the shared-panel kernel takes ``samples_per_block``
    samples a block.  With bf16 states a raster whose panels do not fit in
    shared memory runs on a persistent grid with both panels in a per-block
    scratch in bf16.  Raises on what the kernel does not take."""
    from tpugnn_torch.kernels._build import load_library

    dt = ops.xc.dtype
    slot16 = _slot_dtype(slot_dtype, dt) == torch.bfloat16
    b, l_pad, h = ops.xc.shape
    if tuple(ops.xq.shape) != (b, l_pad, h) or tuple(ops.syn.shape) != (b, l_pad):
        raise ValueError(f"raster shapes disagree: {tuple(ops.xc.shape)}, "
                         f"{tuple(ops.xq.shape)}, {tuple(ops.syn.shape)}")
    check_width(h)
    if tuple(ops.mats.shape) != (10, h, h) or tuple(ops.degbo.shape) != (2, l_pad, h):
        raise ValueError(f"the roll-rounds kernel takes weights of the states' width "
                         f"{h}, got {tuple(ops.mats.shape)} and {tuple(ops.degbo.shape)}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if len(ops.offs_c) != 4 or len(ops.offs_q) != 4 or tuple(ops.masks.shape) != (2, 4, l_pad):
        raise ValueError("the roll-rounds kernel takes four slots per side")
    if ops.mats.dtype != dt:
        raise ValueError(f"weights in {ops.mats.dtype}, states in {dt}")
    dev = ops.xc.device
    for t in (ops.xq, ops.syn, ops.masks, ops.degbo, ops.mats, ops.vecs):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    ln_width = h if width is None else width
    code = _DTYPE_CODE[dt]
    offs = (ctypes.c_int * 8)(*ops.offs_c, *ops.offs_q)
    wid = kernel_width(h)
    if wid > WIDTH:
        return _roll_rounds_wide(pad_raster(ops, wid), rounds, slot16, ln_width, h, offs)
    lib = load_library(roll_library(dt))
    smem = lib.roll_rounds_smem_bytes(code, l_pad)
    gpanels = smem > SMEM_LIMIT
    if gpanels:
        smem = (lib.roll_rounds_gpanels_smem_bytes(l_pad) if code == 0
                else lib.roll_rounds_tc_gpanels_smem_bytes(l_pad))
    if smem > SMEM_LIMIT:
        raise ValueError(f"raster too large for the roll-rounds kernel: needs {smem} B "
                         f"of shared memory per block (l_pad={l_pad}, {dt} states"
                         f"{', gather panels in global memory' if gpanels else ''}), "
                         f"limit {SMEM_LIMIT}")
    ops = pad_raster(ops)
    bits = _mask_bits(ops.masks)
    xc, xq = ops.xc.contiguous(), ops.xq.contiguous()
    syn = ops.syn.float().contiguous()
    degbo, mats = ops.degbo.float().contiguous(), ops.mats.contiguous()
    vecs = ops.vecs.float().contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s, grid, scratch = 1, 0, None
    if code == 0:
        mats = tf32_split_pack(mats)
        if not gpanels:
            s = samples_per_block(b, l_pad, l_pad)
        grid = min(b // s, sms)
        # per block: the check states' second buffer, and the global panel
        scratch = torch.empty((grid, (2 if gpanels else 1) * s * l_pad, WIDTH),
                              dtype=torch.float32, device=dev)
    elif gpanels:   # per block: both bf16 panels
        grid = min(b, sms)
        scratch = torch.empty((grid, 2 * l_pad, WIDTH), dtype=dt, device=dev)
    out_c, out_q = torch.empty_like(xc), torch.empty_like(xq)
    with _cuda_stream(dev) as stream:
        ptrs = (xc.data_ptr(), xq.data_ptr(), syn.data_ptr(), bits.data_ptr(),
                degbo.data_ptr(), mats.data_ptr(), vecs.data_ptr(), out_c.data_ptr(),
                out_q.data_ptr())
        if gpanels and code == 0:
            err = lib.roll_rounds_gpanels_launch(*ptrs, scratch.data_ptr(), offs, b, l_pad,
                                                 rounds, ln_width, grid, stream)
        elif gpanels:
            err = lib.roll_rounds_tc_gpanels_launch(int(slot16), *ptrs, scratch.data_ptr(),
                                                    offs, b, l_pad, rounds, ln_width, grid,
                                                    stream)
        else:
            err = lib.roll_rounds_launch(code, int(slot16), *ptrs, offs, b, l_pad, rounds,
                                         ln_width, s,
                                         scratch if scratch is None else scratch.data_ptr(),
                                         grid, stream)
    name = ("roll_rounds" if not gpanels else "roll_rounds_gpanels" if code == 0
            else "roll_rounds_tc_gpanels")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _LAUNCHES[name] += 1
    return out_c[..., :h], out_q[..., :h]


def _roll_rounds_wide(ops: RasterOperands, rounds: int, slot16: bool, ln_width: int, h: int,
                      offs):
    """K5 above 128 columns: the wide rounds kernel's raster mode on
    operands padded to a multiple of 128 (``csrc/wide_rounds.cuh``, the slot
    sum in ``offs`` order under the mask bits, ``(deg bo) @ ua`` read per
    cell); returns the first ``h`` columns of ``(xc, xq)``."""
    from tpugnn_torch.kernels._build import load_library

    dt = ops.xc.dtype
    b, l_pad, wid = ops.xc.shape
    dev = ops.xc.device
    lib = load_library(wide_library(dt))
    code = _DTYPE_CODE[dt]
    bits = _mask_bits(ops.masks)
    xc, xq = ops.xc.contiguous(), ops.xq.contiguous()
    syn = ops.syn.float().contiguous()
    degbo = ops.degbo.float().contiguous()
    pack = wgmma_pack(ops.mats, dt)
    vecs = ops.vecs.float().contiguous()
    ys_c, ys_q = torch.empty_like(xc), torch.empty_like(xq)   # the gathers' sources
    out_c, out_q = torch.empty_like(xc), torch.empty_like(xq)
    with _cuda_stream(dev) as stream:
        err = lib.wide_roll_launch(code, int(slot16), xc.data_ptr(), xq.data_ptr(),
                                   syn.data_ptr(), bits.data_ptr(), degbo.data_ptr(),
                                   pack.data_ptr(), vecs.data_ptr(), out_c.data_ptr(),
                                   out_q.data_ptr(), ys_c.data_ptr(), ys_q.data_ptr(), offs, b,
                                   l_pad, rounds, wid, ln_width, stream)
    if err != 0:
        raise RuntimeError(f"roll_rounds_wide kernel launch failed: CUDA error {err}")
    _LAUNCHES["roll_rounds_wide"] += 1
    return out_c[..., :h], out_q[..., :h]
