"""Training through the fused rounds: forward with stash, explicit adjoint.

The port of ``tpugnn/kernels/fused_backward.py`` (``make_kernel_vjp_rounds``
and ``kernel_trained_rounds_tiled``).  :class:`FusedRoundsFn` is the
autograd boundary.  It takes the f32 weight packs of
:func:`~tpugnn_torch.kernels.fused_decoder.pack_weights_f32` and casts them to
the state type inside, so autograd sees f32 cotangents and un-folds the
gradients of ``wo @ ua`` and ``bo @ ua`` into ``wo``, ``ua`` and ``bo``:

* forward: every round's input states are written to a stash
  ``[R, B, rows, H]`` in the state type, besides the rounds' outputs.  On a
  CUDA tensor this is the kernel ``csrc/fused_rounds.cu`` with its stash flag
  (K2a, replacing ``_fwd``'s ``pl.pallas_call`` at
  ``tpugnn/kernels/fused_backward.py:575``); on a CPU tensor,
  :func:`rounds_fwd_stash_plain`;
* backward: the rounds in reverse.  Each replays its forward from the stash
  and chains the adjoint through the LayerNorm, the residual MLP, the relu
  masks, the folded aggregation, the slot gather and the wide projections.
  Weight gradients are summed over the batch.  On a CUDA tensor this is
  ``csrc/fused_backward.cu`` (K2b, replacing ``_bwd``'s ``pl.pallas_call`` at
  ``:624``); on a CPU tensor, :func:`rounds_vjp_plain`.

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

__all__ = ["FusedRoundsFn", "rounds_fwd_stash_plain", "rounds_vjp_plain",
           "trained_rounds"]

def rounds_fwd_stash_plain(xc, xq, syn, operators, mats32, vecs32, *, rounds: int,
                           state_dtype: str = "float32"):
    """Plain version of K2a: ``(xc, xq, stash_c, stash_q)``.

    The outputs are :func:`~tpugnn_torch.kernels.fused_decoder.rounds_plain`'s
    (f32); ``stash_c`` [R, B, M, H] and ``stash_q`` [R, B, N, H] hold every
    round's input states in the state type."""
    dt = fd.STATE_DTYPES[state_dtype]
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    stash = ([], [])
    xc, xq = fd.rounds_packed(xc, xq, syn, operators, mats, vecs, rounds=rounds,
                              dtype=dt, stash=stash)
    return xc, xq, torch.stack(stash[0]), torch.stack(stash[1])


def _wgrad(a, b):
    """``a^T @ b`` summed over batch and rows: [B, rows, K] x [B, rows, F]."""
    return a.reshape(-1, a.shape[-1]).T @ b.reshape(-1, b.shape[-1])


def _head_adjoint(g, res, mats, vecs, deg, rnd, dvec):
    """LayerNorm, residual-MLP and folded-aggregation adjoint of one
    direction.  ``g`` is the cotangent of the round's new states.  Fills
    ``dvec`` rows 1 and 3-6 and returns ``(dpre, dt, dt_r, dhs, dw1, dwf)``:
    ``dpre`` is the residual's share of the state cotangent, ``dt_r`` is
    ``dt`` rounded to the state type, as the products read it."""
    nh, inv, t, hc, hs = res["nh"], res["inv"], res["t"], res["hc"], res["hs"]
    dvec[5] = (g * nh).sum((0, 1))
    dvec[6] = g.sum((0, 1))
    dnh = g * vecs[5]
    dpre = inv * (dnh - dnh.mean(-1, keepdim=True)
                  - nh * (dnh * nh).mean(-1, keepdim=True))
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
                     state_dtype: str = "float32"):
    """Plain version of K2b: the explicit adjoint of the rounds.

    Replays each round from the stash (:func:`rounds_fwd_stash_plain`) and
    walks the rounds in reverse, like the JAX kernel's ``_make_bwd_kernel``
    (``tpugnn/kernels/fused_backward.py:273``).  ``dxc``/``dxq`` are the
    cotangents of the rounds' outputs.  Returns ``(dxc, dxq, dsyn, dmats,
    dvecs)`` in f32: the cotangents of the input states, of ``syn`` (shaped
    like it) and of the f32 packs."""
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
                   keep=res_c)
        fd._update(xq, ys_q, src_q, mask_q, deg_q, mats[5:10], vecs[7:14], 0.0, rnd,
                   keep=res_q)
        dv_c = torch.zeros((7, h), device=gc.device)
        dv_q = torch.zeros((7, h), device=gc.device)
        dpre_c, dt_c, dtr_c, dhs_c, dw1_c, dwf_c = _head_adjoint(
            gc, res_c, mats[0:5], vecs[0:7], deg_c, rnd, dv_c)
        dpre_q, _, dtr_q, dhs_q, dw1_q, dwf_q = _head_adjoint(
            gq, res_q, mats[5:10], vecs[7:14], deg_q, rnd, dv_q)
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


def _fwd_stash_cuda(xc, xq, syn, operators, mats32, vecs32, rounds, state_dtype):
    """K2a: the fused-rounds kernel with its stash flag."""
    from tpugnn_torch.kernels._build import load_library

    dt = fd.STATE_DTYPES[state_dtype]
    lib = load_library("fused_rounds")
    a = fd._cuda_operands(lib, xc, xq, syn, operators, mats32, rounds, dt)
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    b, m, n, h = a.b, a.m, a.n, xc.shape[2]
    stash_c = torch.empty((rounds, b, m, h), dtype=dt, device=xc.device)
    stash_q = torch.empty((rounds, b, n, h), dtype=dt, device=xc.device)
    out_c = torch.empty((b, m, h), dtype=dt, device=xc.device)
    out_q = torch.empty((b, n, h), dtype=dt, device=xc.device)
    with fd._cuda_stream(xc.device) as stream:
        err = lib.fused_rounds_stash_launch(
            a.code, a.xc.data_ptr(), a.xq.data_ptr(), a.syn.data_ptr(),
            a.idx_c.data_ptr(), a.idx_q.data_ptr(), mats.data_ptr(), vecs.data_ptr(),
            out_c.data_ptr(), out_q.data_ptr(), stash_c.data_ptr(), stash_q.data_ptr(),
            b, m, n, a.dc, a.dq, rounds, stream)
    if err != 0:
        raise RuntimeError(f"fused_rounds_fwd_stash kernel launch failed: CUDA error {err}")
    fd._LAUNCHES["fused_rounds_fwd_stash"] += 1
    return out_c.float(), out_q.float(), stash_c, stash_q


def _bwd_cuda(stash_c, stash_q, syn, operators, mats32, vecs32, dxc, dxq, state_dtype):
    """K2b: the reverse round walk, then the fixed-order sum of the blocks'
    weight-gradient partials (two launches, counted as one call)."""
    from tpugnn_torch.kernels._build import load_library

    dt = fd.STATE_DTYPES[state_dtype]
    lib = load_library("fused_backward")
    rounds, b, m, h = stash_c.shape
    n = stash_q.shape[2]
    dev = stash_c.device
    src_c, mask_c, _, src_q, mask_q, _ = operators
    if h != 128 or stash_c.dtype != dt or stash_q.shape[:2] != stash_c.shape[:2]:
        raise ValueError(f"the backward kernel takes the stash of K2a at hidden 128, "
                         f"got {tuple(stash_c.shape)} {stash_c.dtype} and "
                         f"{tuple(stash_q.shape)}")
    if src_c.shape[0] != m or src_q.shape[0] != n or src_c.device != dev:
        raise ValueError("operators do not match the stash's rows or device")
    idx_c, idx_q = fd._slot_tables(src_c, mask_c, src_q, mask_q)
    dc, dq = idx_c.shape[1], idx_q.shape[1]
    code = fd._DTYPE_CODE[dt]
    smem = lib.fused_rounds_bwd_smem_bytes(code, m, n, dc, dq)
    if smem > fd.SMEM_LIMIT:
        raise ValueError(f"graph too large for the fused backward kernel: needs "
                         f"{smem} B of shared memory per block (M={m}, N={n}), "
                         f"limit {fd.SMEM_LIMIT}")
    mats, vecs = fd.cast_packs(mats32, vecs32, dt)
    mats_t = mats.transpose(1, 2).contiguous()
    ucs32 = vecs32[2].detach().float().contiguous()
    tiles = -(-b // lib.fused_rounds_bwd_tile(code))  # a block takes a tile of samples
    grid = min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    g_c = dxc.float().contiguous().clone()          # rewritten in place
    g_q = dxq.float().contiguous().clone()
    dsyn = torch.zeros((b, m), dtype=torch.float32, device=dev)
    scratch = torch.empty(grid * lib.fused_rounds_bwd_scratch_bytes(code, m, n, dc, dq),
                          dtype=torch.uint8, device=dev)
    part_mats = torch.zeros((grid, 10, h, h), dtype=torch.float32, device=dev)
    part_vecs = torch.zeros((grid, 8, 14, h), dtype=torch.float32, device=dev)
    dmats = torch.empty((10, h, h), dtype=torch.float32, device=dev)
    dvecs = torch.empty((14, h), dtype=torch.float32, device=dev)
    syn2 = syn.reshape(b, m).float().contiguous()
    with fd._cuda_stream(dev) as stream:
        err = lib.fused_rounds_bwd_launch(
            code, stash_c.data_ptr(), stash_q.data_ptr(), syn2.data_ptr(),
            idx_c.data_ptr(), idx_q.data_ptr(), mats.data_ptr(), mats_t.data_ptr(),
            vecs.data_ptr(), ucs32.data_ptr(),
            g_c.data_ptr(), g_q.data_ptr(), dsyn.data_ptr(), scratch.data_ptr(),
            part_mats.data_ptr(), part_vecs.data_ptr(), dmats.data_ptr(),
            dvecs.data_ptr(), b, m, n, dc, dq, rounds, grid, stream)
    if err != 0:
        raise RuntimeError(f"fused_rounds_bwd kernel launch failed: CUDA error {err}")
    fd._LAUNCHES["fused_rounds_bwd"] += 1
    return g_c, g_q, dsyn.reshape(syn.shape), dmats, dvecs


class FusedRoundsFn(torch.autograd.Function):
    """The rounds with a hand-written backward (``jax.custom_vjp`` ``core``
    of ``make_kernel_vjp_rounds``).

    ``apply(xc, xq, syn, mats32, vecs32, operators, rounds, state_dtype,
    kernels)``: ``kernels`` selects K2a/K2b (CUDA tensors) or the plain
    versions (CPU tensors); the caller decides it from the device."""

    @staticmethod
    def forward(ctx, xc, xq, syn, mats32, vecs32, operators, rounds, state_dtype,
                kernels):
        if kernels:
            outs = _fwd_stash_cuda(xc, xq, syn, operators, mats32, vecs32, rounds,
                                   state_dtype)
        else:
            outs = rounds_fwd_stash_plain(xc, xq, syn, operators, mats32, vecs32,
                                          rounds=rounds, state_dtype=state_dtype)
        xc_o, xq_o, stash_c, stash_q = outs
        ctx.save_for_backward(stash_c, stash_q, syn, mats32, vecs32)
        ctx.operators = operators
        ctx.state_dtype = state_dtype
        ctx.kernels = kernels
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
            grads = _bwd_cuda(*args, ctx.state_dtype)
        else:
            grads = rounds_vjp_plain(*args, state_dtype=ctx.state_dtype)
        return (*grads, None, None, None, None)


def trained_rounds(xc, xq, syn, operators, weights, rounds: int,
                   state_dtype: str = "float32", *, kernels: bool):
    """The differentiable rounds: packs the weights in f32 (autograd records
    the packing) and calls :class:`FusedRoundsFn`."""
    mats32, vecs32 = fd.pack_weights_f32(weights)
    return FusedRoundsFn.apply(xc, xq, syn, mats32, vecs32, operators, rounds,
                               state_dtype, kernels)
