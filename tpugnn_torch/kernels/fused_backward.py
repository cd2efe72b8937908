"""Training through the fused rounds: forward with stash, explicit adjoint.

The port of ``tpugnn/kernels/fused_backward.py`` (``make_kernel_vjp_rounds``
and ``kernel_trained_rounds_tiled``).  :class:`FusedRoundsFn` is the
autograd boundary.  It takes the f32 weight packs of
:func:`~tpugnn_torch.kernels.fused_decoder.pack_weights_f32` and casts them to
the state type inside, so autograd sees f32 cotangents and un-folds the
gradients of ``wo @ ua`` and ``bo @ ua`` into ``wo``, ``ua`` and ``bo``:

* forward: every round's input states are written to a stash
  ``[R, B, rows, H]`` in the state type, besides the rounds' outputs.  On a
  CUDA tensor this is the kernel ``csrc/fused_rounds.cu`` (bf16 states;
  ``fused_rounds_tf32.cu`` with f32 states) with its stash flag (K2a,
  replacing ``_fwd``'s ``pl.pallas_call`` at
  ``tpugnn/kernels/fused_backward.py:575``), above 128 columns the wide
  forward (``csrc/wide_rounds.cuh``) with its stash; on a CPU tensor,
  :func:`rounds_fwd_stash_plain`;
* backward: the rounds in reverse.  Each replays its forward from the stash
  and chains the adjoint through the LayerNorm, the residual MLP, the relu
  masks, the folded aggregation, the slot gather and the wide projections.
  Weight gradients are summed over the batch.  On a CUDA tensor this is K2b,
  replacing ``_bwd``'s ``pl.pallas_call`` at ``:624``:
  ``csrc/fused_backward.cu`` with bf16 states, ``csrc/fused_backward_tf32.cu``
  with f32 states (every product as three TF32 products on the tensor
  cores, as f32 K1, K2a and K5 form theirs), above 128 columns the wide
  backward (``csrc/wide_rounds.cuh``; libraries ``wide_backward`` and
  ``wide_backward_tf32``), which refuses f32 states at 384 columns
  (``F32_BWD_REFUSED``); on a CPU tensor, :func:`rounds_vjp_plain`.

A model trains on states and packs zero-padded to the kernels' width
(:func:`~tpugnn_torch.kernels.fused_decoder.kernel_width`: 128, or above 128
the next multiple of 128, where ``csrc/wide_rounds.cuh`` runs K2a and K2b)
outside the autograd Function (:func:`padded_rounds`, with ``F.pad``), so
autograd slices every gradient back to the model's width; inside, the
LayerNorm and its adjoint run over the model's ``width`` columns, and no
cotangent reaches a padded one.  The plain versions take any width.

Cotangents are f32.  Where the JAX kernel rounds a cotangent to the state
type before a product (``dpre``, ``dt``, each slot's ``dz`` before the
scatter, and ``dydb``/``dys`` in the wide projection), both versions here
round it too.  So in bf16 this is the JAX kernel's function, and not autograd
through :func:`~tpugnn_torch.kernels.fused_decoder.rounds_plain`, which rounds
no cotangent.
"""

from __future__ import annotations

import torch

from tpugnn_torch.kernels import fused_decoder as fd

__all__ = ["FusedRoundsFn", "padded_rounds", "rounds_fwd_stash_plain", "rounds_vjp_plain",
           "trained_rounds"]

def rounds_fwd_stash_plain(xc, xq, syn, operators, mats32, vecs32, *, rounds: int,
                           state_dtype: str = "float32", width: int | None = None):
    """Plain version of K2a: ``(xc, xq, stash_c, stash_q)``.

    The outputs are :func:`~tpugnn_torch.kernels.fused_decoder.rounds_plain`'s
    (f32); ``stash_c`` [R, B, M, H] and ``stash_q`` [R, B, N, H] hold every
    round's input states in the state type.  ``width``: the LayerNorm's
    columns on padded operands (None: all)."""
    dt = fd.STATE_DTYPES[state_dtype]
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    stash = ([], [])
    xc, xq = fd.rounds_packed(xc, xq, syn, operators, mats, vecs, rounds=rounds,
                              dtype=dt, stash=stash, width=width)
    return xc, xq, torch.stack(stash[0]), torch.stack(stash[1])


def _wgrad(a, b):
    """``a^T @ b`` summed over batch and rows: [B, rows, K] x [B, rows, F]."""
    return a.reshape(-1, a.shape[-1]).T @ b.reshape(-1, b.shape[-1])


def _head_adjoint(g, res, mats, vecs, deg, rnd, dvec, width=None):
    """LayerNorm, residual-MLP and folded-aggregation adjoint of one
    direction.  ``g`` is the cotangent of the round's new states.  Fills
    ``dvec`` rows 1 and 3-6 and returns ``(dpre, dt, dt_r, dhs, dw1, dwf)``:
    ``dpre`` is the residual's share of the state cotangent, ``dt_r`` is
    ``dt`` rounded to the state type, as the products read it.  The
    LayerNorm's adjoint is over its first ``width`` columns, ``dpre`` 0 on
    the others."""
    nh, inv, t, hc, hs = res["nh"], res["inv"], res["t"], res["hc"], res["hs"]
    dvec[5] = (g * nh).sum((0, 1))
    dvec[6] = g.sum((0, 1))
    dnh = g * vecs[5]
    dpre = fd.ln_mask(inv * (dnh - fd.ln_mean(dnh, width)
                             - nh * fd.ln_mean(dnh * nh, width)), width)
    dpre_r = rnd(dpre)
    dw1 = _wgrad(hc, dpre_r)
    dvec[4] = dpre.sum((0, 1))
    dt = (dpre_r @ mats[4].T) * (t > 0)
    dt_r = rnd(dt)
    dvec[3] = dt.sum((0, 1))
    dvec[1] = (deg[None, :, None] * dt).sum((0, 1))
    dwf = _wgrad(hs, dt_r)
    dhs = dt_r @ mats[3].T
    return dpre, dt, dt_r, dhs, dw1, dwf


def _gather_adjoint(dhs, live, src, n_src, rnd, dvec):
    """Slot-gather adjoint of one direction: ``dydb`` of the destination rows
    and ``dys``, the cotangent of the gathered source projection, scattered
    onto the ``n_src`` source rows (each slot's share rounded first, as the
    JAX kernel's transposed one-hot GEMMs read it).  Fills ``dvec`` row 0."""
    b, rows, d, h = live.shape
    dz = dhs[:, :, None, :] * live
    dydb = dz.sum(2)
    dvec[0] = dydb.sum((0, 1))
    dys = torch.zeros((b, n_src, h), dtype=dhs.dtype, device=dhs.device)
    dys.index_add_(1, src.reshape(-1), rnd(dz).reshape(b, rows * d, h))
    return dydb, dys


def rounds_vjp_plain(stash_c, stash_q, syn, operators, mats32, vecs32, dxc, dxq, *,
                     state_dtype: str = "float32", width: int | None = None):
    """Plain version of K2b: the explicit adjoint of the rounds.

    Replays each round from the stash (:func:`rounds_fwd_stash_plain`) and
    walks the rounds in reverse, like the JAX kernel's ``_make_bwd_kernel``
    (``tpugnn/kernels/fused_backward.py:273``).  ``dxc``/``dxq`` are the
    cotangents of the rounds' outputs.  Returns ``(dxc, dxq, dsyn, dmats,
    dvecs)`` in f32: the cotangents of the input states, of ``syn`` (shaped
    like it) and of the f32 packs.  ``width``: the LayerNorm's columns on
    padded operands (None: all)."""
    dt = fd.STATE_DTYPES[state_dtype]
    src_c, mask_c, deg_c, src_q, mask_q, deg_q = operators
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    mats = mats.float()
    rnd = lambda t: t.to(dt).float()
    b, m, h = stash_c.shape[1:]
    n = stash_q.shape[2]
    s = syn.reshape(b, m, 1).float()
    synterm = s * vecs[2]
    ucs32 = vecs32[2].float()
    gc, gq = dxc.float(), dxq.float()
    dmats = torch.zeros((10, h, h), device=gc.device)
    dvecs = torch.zeros((14, h), device=gc.device)
    dsyn = torch.zeros((b, m), device=gc.device)
    for r in range(stash_c.shape[0] - 1, -1, -1):
        xc, xq = stash_c[r].float(), stash_q[r].float()
        ys_c = rnd(xq @ mats[7])
        ys_q = rnd(xc @ mats[2])
        res_c, res_q = {}, {}
        fd._update(xc, ys_c, src_c, mask_c, deg_c, mats[0:5], vecs[0:7], synterm, rnd,
                   keep=res_c, width=width)
        fd._update(xq, ys_q, src_q, mask_q, deg_q, mats[5:10], vecs[7:14], 0.0, rnd,
                   keep=res_q, width=width)
        dv_c = torch.zeros((7, h), device=gc.device)
        dv_q = torch.zeros((7, h), device=gc.device)
        dpre_c, dt_c, dtr_c, dhs_c, dw1_c, dwf_c = _head_adjoint(
            gc, res_c, mats[0:5], vecs[0:7], deg_c, rnd, dv_c, width)
        dpre_q, _, dtr_q, dhs_q, dw1_q, dwf_q = _head_adjoint(
            gq, res_q, mats[5:10], vecs[7:14], deg_q, rnd, dv_q, width)
        dv_c[2] = (s * dt_c).sum((0, 1))
        dsyn += (dt_c * ucs32).sum(-1)
        dydb_c, dys_c = _gather_adjoint(dhs_c, res_c["live"], src_c, n, rnd, dv_c)
        dydb_q, dys_q = _gather_adjoint(dhs_q, res_q["live"], src_q, m, rnd, dv_q)
        dydb_c, dys_q, dydb_q, dys_c = (rnd(dydb_c), rnd(dys_q), rnd(dydb_q),
                                        rnd(dys_c))
        # wide projections: xc feeds ydb_c (wd_c), ys_q (ws_q), ux_c (uc_x)
        gc = dpre_c + dydb_c @ mats[0].T + dys_q @ mats[2].T + dtr_c @ mats[1].T
        gq = dpre_q + dydb_q @ mats[5].T + dys_c @ mats[7].T + dtr_q @ mats[6].T
        dmats += torch.stack([
            _wgrad(xc, dydb_c), _wgrad(xc, dtr_c), _wgrad(xc, dys_q), dwf_c, dw1_c,
            _wgrad(xq, dydb_q), _wgrad(xq, dtr_q), _wgrad(xq, dys_c), dwf_q, dw1_q])
        dvecs += torch.cat([dv_c, dv_q])
    dvecs[9] = 0.0                      # the qubit side has no syndrome term
    return gc, gq, dsyn.reshape(syn.shape), dmats, dvecs


def _fwd_stash_cuda(xc, xq, syn, operators, mats32, vecs32, rounds, state_dtype,
                    width=None):
    """K2a: the fused-rounds kernel with its stash flag, on operands padded
    to the kernels' width; ``width`` is the model's (None: the operands').
    Above 128 columns it is the wide K1 with its stash
    (``fused_rounds_fwd_stash_wide``).  With f32 states it is K1's 3xTF32
    kernel: the weights go in split into TF32 halves
    (``fd.tf32_split_pack``) and, with the panels in shared memory, a small
    graph's samples stacked, as one graph of ``s`` times the rows
    (``fd.samples_per_block``), which leaves the stash's layout [R, B,
    rows, H] as it is.  In both state types a graph whose gather panels do
    not fit in shared memory runs the global-panel variant
    (``fused_rounds_fwd_stash_gpanels``) on a persistent grid, one sample
    at a time; its stash is laid out as the shared-panel kernel's."""
    from tpugnn_torch.kernels._build import load_library

    dt = fd.STATE_DTYPES[state_dtype]
    width = width or xc.shape[-1]
    if mats32.shape[-1] > fd.WIDTH:
        mats, vecs = fd.cast_packs(mats32, vecs32, dt)
        out_c, out_q, stash_c, stash_q = fd._wide_forward(xc, xq, syn, operators, mats, vecs,
                                                          rounds, dt, width, stash=True)
        return out_c.float(), out_q.float(), stash_c, stash_q
    fd.check_width(width)
    lib = load_library(fd.forward_library(dt))
    a = fd._cuda_operands(lib, xc, xq, syn, operators, mats32, rounds, dt, stash=True)
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    b, m, n, h = a.b, a.m, a.n, xc.shape[2]
    s, idx_c, idx_q = 1, a.idx_c, a.idx_q
    if a.code == 0:
        mats = fd.tf32_split_pack(mats)
        if not a.gpanels:
            s = fd.samples_per_block(b, m, n)
            idx_c = fd.stack_slot_tables(idx_c, n, s)
            idx_q = fd.stack_slot_tables(idx_q, m, s)
    stash_c = torch.empty((rounds, b, m, h), dtype=dt, device=xc.device)
    stash_q = torch.empty((rounds, b, n, h), dtype=dt, device=xc.device)
    out_c = torch.empty((b, m, h), dtype=dt, device=xc.device)
    out_q = torch.empty((b, n, h), dtype=dt, device=xc.device)
    ptrs = (a.xc.data_ptr(), a.xq.data_ptr(), a.syn.data_ptr(), idx_c.data_ptr(),
            idx_q.data_ptr(), mats.data_ptr(), vecs.data_ptr(), out_c.data_ptr(),
            out_q.data_ptr(), stash_c.data_ptr(), stash_q.data_ptr())
    with fd._cuda_stream(xc.device) as stream:
        if a.gpanels:
            grid, panels = fd._gpanel_scratch(a, dt, xc.device)
            err = lib.fused_rounds_stash_gpanels_launch(a.code, *ptrs, panels.data_ptr(), b, m,
                                                        n, a.dc, a.dq, rounds, width, grid,
                                                        stream)
        else:
            err = lib.fused_rounds_stash_launch(a.code, *ptrs, b // s, m * s, n * s, a.dc,
                                                a.dq, rounds, width, stream)
    name = "fused_rounds_fwd_stash_gpanels" if a.gpanels else "fused_rounds_fwd_stash"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    fd._LAUNCHES[name] += 1
    return out_c.float(), out_q.float(), stash_c, stash_q


# K2b's library by state type: bf16 and f32 (3xTF32) states build apart
_BWD_LIBRARY = {torch.bfloat16: "fused_backward", torch.float32: "fused_backward_tf32"}


def _bwd_library(dt: torch.dtype, operators):
    """K2b's library for the state type, after checking that a block of the
    layout it takes on the graph of ``operators`` fits in shared memory:
    ``(library, idx_c, idx_q)``, the slot tables."""
    from tpugnn_torch.kernels._build import load_library

    lib = load_library(_BWD_LIBRARY[dt])
    src_c, mask_c, _, src_q, mask_q, _ = operators
    idx_c, idx_q = fd._slot_tables(src_c, mask_c, src_q, mask_q)
    m, n, dc, dq = idx_c.shape[0], idx_q.shape[0], idx_c.shape[1], idx_q.shape[1]
    smem = lib.fused_rounds_bwd_smem_bytes(m, n, dc, dq)
    if smem > fd.SMEM_LIMIT:
        raise ValueError(f"graph too large for the fused backward kernel: needs "
                         f"{smem} B of shared memory per block (M={m}, N={n}), "
                         f"limit {fd.SMEM_LIMIT}")
    return lib, idx_c, idx_q


def _bwd_cuda(stash_c, stash_q, syn, operators, mats32, vecs32, dxc, dxq, state_dtype,
              width=None, msg_width: int | None = None, force_gpanels: bool = False):
    """K2b: the reverse round walk, then the fixed-order sum of the blocks'
    weight-gradient partials (two launches, counted as one call), on
    operands padded to ``fd.WIDTH`` columns; ``width`` is the model's (None:
    the operands').  With
    f32 states the kernel forms every product as three TF32 products: the
    matrices and their transposes go in split into TF32 halves in fragment
    order (``fd.tf32_split_pack``).  It takes again, as this module's plain
    version computes them, the relu decisions of its replay that fall within
    the rounding of its products: for that it reads the matrices and their
    transposes in f32, the L2 norm of each stash row and the largest column
    norm of each matrix, and ``msg_width``, the model's message width
    (``width`` by default): the slot relus past it are 0 on both sides and
    hold no tie.  In both state types a graph whose gather panels
    do not fit in shared memory runs the layout that keeps them in the
    scratch (``fused_rounds_bwd_gpanels``); with f32 states
    ``force_gpanels`` launches that layout on any graph (to compare the two
    placements where both fit).  Above 128 columns it is the wide K2b
    (``fused_rounds_bwd_wide``)."""
    width = width or stash_c.shape[-1]
    if stash_c.shape[-1] > fd.WIDTH:
        if force_gpanels:
            raise ValueError("the wide K2b has no panel placement to force")
        return _bwd_wide_cuda(stash_c, stash_q, syn, operators, mats32, vecs32, dxc, dxq,
                              state_dtype, width, msg_width)
    dt = fd.STATE_DTYPES[state_dtype]
    rounds, b, m, h = stash_c.shape
    n = stash_q.shape[2]
    dev = stash_c.device
    src_c, src_q = operators[0], operators[3]
    fd.check_width(width)
    if h != fd.WIDTH or stash_c.dtype != dt or stash_q.shape[:2] != stash_c.shape[:2]:
        raise ValueError(f"the backward kernel takes the stash of K2a, padded to "
                         f"{fd.WIDTH} columns, got {tuple(stash_c.shape)} {stash_c.dtype} "
                         f"and {tuple(stash_q.shape)}")
    if src_c.shape[0] != m or src_q.shape[0] != n or src_c.device != dev:
        raise ValueError("operators do not match the stash's rows or device")
    if force_gpanels and dt != torch.float32:
        raise ValueError("only the f32 K2b library launches its global layout on request")
    lib, idx_c, idx_q = _bwd_library(dt, operators)
    dc, dq = idx_c.shape[1], idx_q.shape[1]
    if force_gpanels:
        gpanels, launch = True, lib.fused_rounds_bwd_gpanels_launch
        scratch_bytes = lib.fused_rounds_bwd_gpanels_scratch_bytes
    else:
        gpanels = lib.fused_rounds_bwd_gpanels(m, n, dc, dq) == 1
        launch, scratch_bytes = lib.fused_rounds_bwd_launch, lib.fused_rounds_bwd_scratch_bytes
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    mats_t = mats.transpose(1, 2).contiguous()
    ties, widths = (), (width,)
    if dt == torch.float32:
        widths = (width, msg_width or width)
        norms = [torch.linalg.vector_norm(x, dim=-1) for x in (stash_c, stash_q)]
        ties = (mats, mats_t, *norms, torch.linalg.vector_norm(mats, dim=1).amax(-1))
        mats, mats_t = fd.tf32_split_pack(mats), fd.tf32_split_pack(mats_t)
    ucs32 = vecs32[2].detach().float().contiguous()
    tiles = -(-b // lib.fused_rounds_bwd_tile())   # a block takes a tile of samples
    grid = min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    g_c = dxc.float().contiguous().clone()          # rewritten in place
    g_q = dxq.float().contiguous().clone()
    dsyn = torch.zeros((b, m), dtype=torch.float32, device=dev)
    scratch = torch.empty(grid * scratch_bytes(m, n, dc, dq), dtype=torch.uint8, device=dev)
    part_mats = torch.zeros((grid, 10, h, h), dtype=torch.float32, device=dev)
    part_vecs = torch.zeros((grid, 8, 14, h), dtype=torch.float32, device=dev)
    dmats = torch.empty((10, h, h), dtype=torch.float32, device=dev)
    dvecs = torch.empty((14, h), dtype=torch.float32, device=dev)
    syn2 = syn.reshape(b, m).float().contiguous()
    with fd._cuda_stream(dev) as stream:
        err = launch(
            stash_c.data_ptr(), stash_q.data_ptr(), syn2.data_ptr(),
            idx_c.data_ptr(), idx_q.data_ptr(), mats.data_ptr(), mats_t.data_ptr(),
            *(t.data_ptr() for t in ties), vecs.data_ptr(), ucs32.data_ptr(),
            g_c.data_ptr(), g_q.data_ptr(), dsyn.data_ptr(), scratch.data_ptr(),
            part_mats.data_ptr(), part_vecs.data_ptr(), dmats.data_ptr(),
            dvecs.data_ptr(), b, m, n, dc, dq, rounds, *widths, grid, stream)
    name = "fused_rounds_bwd_gpanels" if gpanels else "fused_rounds_bwd"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    fd._LAUNCHES[name] += 1
    return g_c, g_q, dsyn.reshape(syn.shape), dmats, dvecs


def _readers(idx: torch.Tensor, n_src: int):
    """The transposed slot lists of a slot table ``idx`` [rows, D] (-1
    masked) onto ``n_src`` source rows: ``(off [n_src + 1], lst)`` int32,
    the slots ``r * D + k`` that read source row ``s`` in ``lst[off[s] :
    off[s + 1]]``, ascending."""
    flat = idx.reshape(-1).long()
    slots = torch.nonzero(flat >= 0).reshape(-1)
    src = flat[slots]
    order = torch.sort(src, stable=True).indices
    counts = torch.bincount(src, minlength=n_src)
    off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return off.to(torch.int32).contiguous(), slots[order].to(torch.int32).contiguous()


# Pack widths at which the wide K2b refuses f32 states: it takes the relu
# ties of its replay again in the order of the plain version's f32 products,
# one FMA per k ascending, and at K = 384 cuBLAS sums those products
# otherwise (no split of k into equal slices reproduces them either), so its
# masks miss the plain version's on some seeds (scripts/k2b_wide_ties.py;
# ROADMAP.md, Queue 3).  bf16 states, and K1, K2a and K5, run there.
F32_BWD_REFUSED = (384,)

# blocks of the wide K2b's weight-gradient launch: 10 matrices x (W / 128)^2
# output tiles x row chunks, about two per SM of an H100
_WGRAD_BLOCKS = 320


def wgrad_chunks(wid: int) -> int:
    """The row chunks of the wide K2b's weight-gradient launch at pack width
    ``wid``: its blocks are 10 matrices x ``(wid / 128)^2`` output tiles of
    128 x 128 x the chunks, about ``_WGRAD_BLOCKS`` in all (at least one
    chunk); each chunk's partial is summed in a fixed order."""
    return max(1, _WGRAD_BLOCKS // (10 * (wid // 128) ** 2))


def _bwd_wide_cuda(stash_c, stash_q, syn, operators, mats32, vecs32, dxc, dxq, state_dtype,
                   width, msg_width=None):
    """The wide K2b (``csrc/wide_rounds.cuh``, its backward library by
    state type) on K2a's stash padded to W > 128 columns: the rounds in
    reverse, a chain of launches a round, the gathers' adjoints over the
    transposed slot lists and the weight and bias gradients as partials
    summed in a fixed order, so two calls give the same bits; the packs
    (``fd.wgmma_pack``) of the matrices and of their transposes.  With f32
    states it reads, for its ties, the matrices and their transposes
    unpacked, the stash rows' norms and the matrices' largest column norms,
    and takes the slot ties over ``msg_width``
    columns, as the 128-column f32 K2b does.  It raises for f32 states at a
    width of ``F32_BWD_REFUSED``, before any launch."""
    import ctypes

    from tpugnn_torch.kernels._build import load_library

    dt = fd.STATE_DTYPES[state_dtype]
    rounds, b, m, wid = stash_c.shape
    n = stash_q.shape[2]
    dev = stash_c.device
    fd.check_width(wid)
    if dt == torch.float32 and wid in F32_BWD_REFUSED:
        raise ValueError(f"the wide K2b refuses f32 states at {wid} columns: its relu-tie "
                         f"re-decisions assume the plain version's f32 products sum one FMA "
                         f"per k in order, which cuBLAS does not at K = {wid}; bf16 states "
                         f"train at this width")
    if (wid % fd.WIDTH or stash_c.dtype != dt or stash_q.shape[:2] != stash_c.shape[:2]
            or stash_q.shape[3] != wid or tuple(mats32.shape) != (10, wid, wid)):
        raise ValueError(f"the wide backward kernel takes the stash of the wide K2a, got "
                         f"{tuple(stash_c.shape)} {stash_c.dtype}, {tuple(stash_q.shape)} and "
                         f"packs {tuple(mats32.shape)}")
    src_c, mask_c, deg_c, src_q, mask_q, deg_q = operators
    if src_c.shape[0] != m or src_q.shape[0] != n or src_c.device != dev:
        raise ValueError("operators do not match the stash's rows or device")
    lib = load_library(fd.wide_library(dt, backward=True))
    code = fd._DTYPE_CODE[dt]
    idx_c, idx_q = fd._slot_tables(src_c, mask_c, src_q, mask_q)
    dc, dq = idx_c.shape[1], idx_q.shape[1]
    off_c, lst_c = _readers(idx_c, n)   # the check gather's readers of each qubit row
    off_q, lst_q = _readers(idx_q, m)
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    mats_t = mats.transpose(1, 2).contiguous()
    ties = [None] * 4
    wn = None
    pack, pack_t = fd.wgmma_pack(mats, dt), fd.wgmma_pack(mats_t, dt)
    if dt == torch.float32:
        ties = [mats.contiguous(), mats_t,
                torch.linalg.vector_norm(stash_c, dim=-1).contiguous(),
                torch.linalg.vector_norm(stash_q, dim=-1).contiguous()]
        wn = (ctypes.c_float * 10)(*torch.linalg.vector_norm(mats, dim=1).amax(-1).tolist())
    nch = wgrad_chunks(wid)
    ucs32 = vecs32[2].detach().float().contiguous()
    g_c = dxc.float().contiguous().clone()          # rewritten in place
    g_q = dxq.float().contiguous().clone()
    dsyn = torch.zeros((b, m), dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.wide_rounds_bwd_scratch_bytes(code, b, m, n, dc, dq, wid),
                          dtype=torch.uint8, device=dev)
    part_mats = torch.zeros((nch, 10, wid, wid), dtype=torch.float32, device=dev)
    part_vecs = torch.zeros((2, lib.wide_rounds_bwd_segments(), 7, wid), dtype=torch.float32,
                            device=dev)
    dmats = torch.empty((10, wid, wid), dtype=torch.float32, device=dev)
    dvecs = torch.empty((14, wid), dtype=torch.float32, device=dev)
    syn2 = syn.reshape(b, m).float().contiguous()
    degs = [d.float().contiguous() for d in (deg_c, deg_q)]
    ptr = lambda t: None if t is None else t.data_ptr()
    with fd._cuda_stream(dev) as stream:
        err = lib.wide_rounds_bwd_launch(
            code, stash_c.contiguous().data_ptr(), stash_q.contiguous().data_ptr(),
            syn2.data_ptr(), idx_c.data_ptr(), idx_q.data_ptr(), off_c.data_ptr(),
            lst_c.data_ptr(), off_q.data_ptr(), lst_q.data_ptr(), degs[0].data_ptr(),
            degs[1].data_ptr(), pack.data_ptr(), pack_t.data_ptr(), *(ptr(t) for t in ties),
            wn, vecs.data_ptr(), ucs32.data_ptr(), g_c.data_ptr(), g_q.data_ptr(),
            dsyn.data_ptr(), scratch.data_ptr(), part_mats.data_ptr(), part_vecs.data_ptr(),
            dmats.data_ptr(), dvecs.data_ptr(), b, m, n, dc, dq, rounds, wid, width,
            msg_width or width, nch, stream)
    if err != 0:
        raise RuntimeError(f"fused_rounds_bwd_wide kernel launch failed: CUDA error {err}")
    fd._LAUNCHES["fused_rounds_bwd_wide"] += 1
    return g_c, g_q, dsyn.reshape(syn.shape), dmats, dvecs


class FusedRoundsFn(torch.autograd.Function):
    """The rounds with a hand-written backward (``jax.custom_vjp`` ``core``
    of ``make_kernel_vjp_rounds``).

    ``apply(xc, xq, syn, mats32, vecs32, operators, rounds, state_dtype,
    kernels, width, msg_width)``: ``kernels`` selects K2a/K2b (CUDA tensors)
    or the plain versions (CPU tensors); the caller decides it from the
    device.  ``width`` is the model's width on operands padded past it (the
    LayerNorm's columns), or None where they are not; ``msg_width`` its
    message width (K2b's ties; None: ``width``)."""

    @staticmethod
    def forward(ctx, xc, xq, syn, mats32, vecs32, operators, rounds, state_dtype,
                kernels, width, msg_width):
        if kernels:
            # K2b must take the graph before K2a runs: a step launches both or
            # neither (the wide kernels take any graph)
            if mats32.shape[-1] <= fd.WIDTH:
                _bwd_library(fd.STATE_DTYPES[state_dtype], operators)
            outs = _fwd_stash_cuda(xc, xq, syn, operators, mats32, vecs32, rounds,
                                   state_dtype, width)
        else:
            outs = rounds_fwd_stash_plain(xc, xq, syn, operators, mats32, vecs32,
                                          rounds=rounds, state_dtype=state_dtype,
                                          width=width)
        xc_o, xq_o, stash_c, stash_q = outs
        ctx.save_for_backward(stash_c, stash_q, syn, mats32, vecs32)
        ctx.operators = operators
        ctx.state_dtype = state_dtype
        ctx.kernels = kernels
        ctx.width = width
        ctx.msg_width = msg_width
        return xc_o, xq_o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dxc, dxq):
        stash_c, stash_q, syn, mats32, vecs32 = ctx.saved_tensors
        if dxc is None:
            dxc = torch.zeros(stash_c.shape[1:], device=stash_c.device)
        if dxq is None:
            dxq = torch.zeros(stash_q.shape[1:], device=stash_q.device)
        args = (stash_c, stash_q, syn, ctx.operators, mats32, vecs32, dxc, dxq)
        if ctx.kernels:
            grads = _bwd_cuda(*args, ctx.state_dtype, ctx.width, ctx.msg_width)
        else:
            grads = rounds_vjp_plain(*args, state_dtype=ctx.state_dtype, width=ctx.width)
        return (*grads, None, None, None, None, None, None)


def padded_rounds(xc, xq, syn, operators, mats32, vecs32, rounds: int,
                  state_dtype: str = "float32", *, kernels: bool, width: int | None = None,
                  msg_width: int | None = None):
    """:class:`FusedRoundsFn` on ``width`` columns (by default the kernels'
    width for the packs, :func:`~tpugnn_torch.kernels.fused_decoder.kernel_width`,
    with ``kernels``; the packs' own without): the states and f32 packs go in
    zero-padded (``F.pad``, so autograd slices their gradients back to their
    own widths), the LayerNorm runs over the states' width (the model's) and
    the outputs come back sliced to it.  Only the kernels have a widest pack
    (:func:`~tpugnn_torch.kernels.fused_decoder.check_width`).  ``msg_width``:
    the model's message width (the packs' by default)."""
    h = xc.shape[-1]
    if kernels:
        fd.check_width(mats32.shape[-1])
    if width is None:
        width = fd.kernel_width(mats32.shape[-1]) if kernels else mats32.shape[-1]
    msg_width = msg_width or mats32.shape[-1]
    mats32, vecs32 = fd.pad_packs(mats32, vecs32, width)
    xc, xq = fd.pad_states(xc, xq, width=width)
    xc_o, xq_o = FusedRoundsFn.apply(xc, xq, syn, mats32, vecs32, operators, rounds,
                                     state_dtype, kernels, h, msg_width)
    return xc_o[..., :h], xq_o[..., :h]


def trained_rounds(xc, xq, syn, operators, weights, rounds: int,
                   state_dtype: str = "float32", *, kernels: bool):
    """The differentiable rounds: packs the weights in f32 (autograd records
    the packing) and calls :class:`FusedRoundsFn`, for the kernels through
    :func:`padded_rounds`; on the plain versions through it too where
    ``msg_hidden > hidden`` (the states padded to the packs' width)."""
    mats32, vecs32 = fd.pack_weights_f32(weights)
    mh = weights.wd_c.shape[1]
    if kernels:
        return padded_rounds(xc, xq, syn, operators, mats32, vecs32, rounds, state_dtype,
                             kernels=True, msg_width=mh)
    if mats32.shape[-1] != xc.shape[-1]:
        return padded_rounds(xc, xq, syn, operators, mats32, vecs32, rounds, state_dtype,
                             kernels=False, width=mats32.shape[-1], msg_width=mh)
    return FusedRoundsFn.apply(xc, xq, syn, mats32, vecs32, operators, rounds,
                               state_dtype, kernels, None, None)
