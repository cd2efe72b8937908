#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpugnn_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's decode path on the card and checks it, in phases that each
print one JSON line with their wall time:

  0 environment: torch, nvcc and the card's name and power limit
  1 build: the CUDA kernel from the sources in the checkout (nvcc -> .so)
  2 kernel vs plain: the fused-rounds kernel against rounds_plain on the card
    at the main path's shapes, d=11, H=128, B=4096 (R=8 bf16 and R=14 f32),
    with stated tolerances
  3 serve: a DecodeEngine on the trained d=11 weights answers requests of
    1, 1000 and 5000 syndromes; outputs equal the model's direct decode
  4 LER: ler_monte_carlo of the trained weights at p=0.05 on 65,536 shots,
    z-scores against the JAX package's own f32 LER recorded in the weights
    file (both heads gated at |z| <= 4) and against benchmarks/LER_TABLE.md:30
    (logical head gated at |z| <= 4; per-qubit head reported, see below)
  5 timing: the bench config (d=11, B=4096, R=8, H=128, bf16) with CUDA
    events: the kernel's step, rounds_plain, and an index_select + index_add_
    round loop as the yardstick
  6 training kernels vs plain: at the flagship training shapes (d=11, H=128,
    R=14, B=4096) in bf16 and in f32, K2a's outputs against K1's, its stash
    against rounds_fwd_stash_plain, and K2b's gradients (states, syndrome and
    every weight leaf) against rounds_vjp_plain, with stated tolerances
  7 train: train() on the flagship training config from a seeded random
    init, TRAIN_STEPS steps in two calls with a checkpoint resume between
    them; gates a finite, falling loss, one K2a and one K2b launch and no K1
    launch per step, the EMA, and a bit-equal restore; times the step, K2a
    and K2b alone, their plain versions and the autograd yardstick

Phases 3, 4 and 7 are the main paths; the launch counts are reset before
and read after each.  Then it prints the kernel table as one JSON line, the
card's name and power limit, and last {"ok": true, "device": {...}}.  Any
failure raises and exits nonzero.  It exits nonzero without printing a result
when there is no CUDA device or when run outside the repository.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASE_LIMIT_S = 180       # a phase that runs longer is taken for a hang
D = 11                    # surface-code distance of the main path
B = 4096                  # the main path's batch (serve microbatch, LER chunk)

# benchmarks/LER_TABLE.md:30, v3_surface_d11/ema@40000, p=0.05, 1e6 shots,
# measured on a TPU.  The per-qubit head's rate depends on the GEMM
# precision: a TPU runs f32 GEMMs in one bf16 pass by default, and
# scripts/jax_ler_precision.py shows that the JAX package at that precision
# lands on the table's per-qubit rate while at f32 it does not.  The port and
# the JAX package on the CPU run f32 and agree shot for shot, so the
# per-qubit head is gated against the JAX package's f32 LER that
# scripts/export_torch_weights.py records in the weights file, and its z
# against this table is reported.  The logical head is gated against both.
REF_SHOTS = 1_000_000
REF_LER_LOGICAL = 0.00211
REF_LER_QUBIT = 0.4386

# Kernel vs plain tolerances on [B, rows, 128] states after the rounds.
# f32: the same f32 arithmetic summed in another order (FMA loops vs the
# library GEMMs), carried through 14 LayerNorm'd rounds; a state is O(1), so
# 1e-3 leaves two orders of magnitude over f32 reassociation noise.
TOL_F32 = 1e-3
# bf16: states, slot sums and update hiddens are stored in bf16 by both
# versions; a different f32 summation order flips a bf16 rounding now and
# then (1 ulp = 2^-8 relative, 0.016 at |x| = 4) and the flip travels through
# later rounds.  Max 0.25 (16 ulp at |x| = 4) and mean 1e-2 bound that drift.
TOL_BF16_MAX = 0.25
TOL_BF16_MEAN = 1e-2
# share of real qubits whose argmax correction under a random pauli4 head
# must agree between kernel and plain
MIN_AGREE_F32 = 0.999
MIN_AGREE_BF16 = 0.99

# K2a against K1: the same kernel code with a flag that adds the stash
# copies, so the same arithmetic in the same order; outputs must be equal.
# K2b against rounds_vjp_plain, fed the same stash: each gradient leaf (dxc,
# dxq, dsyn, the 25 weight leaves) as a relative L2 error.  f32: summation
# order alone, through 14 rounds of LayerNorm adjoint, ~1e-6; bound 1e-4.
# bf16: both round dpre, dt, dz, dydb and dys to bf16 at the same points; a
# summation order that differs flips a rounding now and then (1 ulp = 2^-8
# relative) and the flip travels back through the rounds; bound 1e-2, a
# couple of ulps over a whole leaf.
TOL_GRAD_REL_F32 = 1e-4
TOL_GRAD_REL_BF16 = 1e-2
# train phase: the flagship training config (benchmarks/train_quality_v3.py
# with scripts/tpu_queue_r2a.sh:108-110) for TRAIN_STEPS steps, resumed from
# a checkpoint at TRAIN_RESUME.  LOSS_FALL bounds the mean loss of the last 5
# steps over that of the first 5.  The run is seeded; the first chip run gave
# 0.162 (3.93 -> 0.64: the random init's loss, then the class priors learnt
# during the warmup) and a CPU run of the same config at B=64 gave 0.18, so
# 0.25 leaves room for another card's rounding and still fails a run whose
# loss only creeps down.
TRAIN_STEPS = 30
TRAIN_RESUME = 15
LOSS_FALL = 0.25

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12    # f32 outside the tensor cores
H100_HBM_BPS = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Phase:
    """Arms the hang watchdog, times the phase and prints its JSON line."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        faulthandler.dump_traceback_later(PHASE_LIMIT_S, exit=True)
        self.t0 = time.perf_counter()
        return self.info

    def __exit__(self, exc_type, exc, tb):
        faulthandler.cancel_dump_traceback_later()
        if exc_type is None:
            emit({"phase": self.name,
                  "seconds": round(time.perf_counter() - self.t0, 3), **self.info})
        return False


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rounds_flops(graph, h: int) -> float:
    """Operations one sample's round needs with folded weights: ten [rows, H]
    x [H, H] GEMMs per side pair (5 over check rows, 5 over qubit rows) and an
    add and a max per real slot and column in each direction.  Only real
    rows count: nothing reads a padded row's state."""
    rows = graph.n_checks + graph.n_qubits
    return 2.0 * h * h * 5 * rows + 2.0 * 2 * graph.n_edges * h


def rounds_bytes(graph, batch: int, h: int, itemsize: int) -> float:
    """Bytes the rounds must move: the real rows' states read once and
    written once, the syndrome, the folded weights and one int32 source index
    per real slot in each direction."""
    rows = graph.n_checks + graph.n_qubits
    return (2 * batch * rows * h * itemsize + batch * graph.n_checks * 4
            + 10 * h * h * itemsize + 14 * h * 4 + 2 * graph.n_edges * 4)


def rounds_bwd_flops(graph, h: int) -> float:
    """Operations of one sample's round in the backward: the replay (the
    forward's work), the adjoint's ten transposed-weight products and the ten
    weight-gradient products (each as much as a forward product), and per
    real slot and column a compare and an add for dydb and for dys."""
    rows = graph.n_checks + graph.n_qubits
    return 3 * 2.0 * h * h * 5 * rows + (2 + 4) * 2 * graph.n_edges * h


def stash_bytes(graph, batch: int, rounds: int, h: int, itemsize: int) -> float:
    """The stash of the real rows: every round's input states."""
    return rounds * batch * (graph.n_checks + graph.n_qubits) * h * itemsize


def weight_leaves(w, mats_grad, vecs_grad):
    """Gradients of the 25 round-weight leaves from those of the f32 packs,
    through autograd of the packing (the fold's un-folding included)."""
    import torch

    from tpugnn_torch.kernels import fused_decoder as fd

    leaves = [t.detach().requires_grad_(True) for t in w]
    with torch.enable_grad():
        mats, vecs = fd.pack_weights_f32(fd.RoundWeights(*leaves))
        grads = torch.autograd.grad((mats, vecs), leaves, (mats_grad, vecs_grad))
    return dict(zip(fd.RoundWeights._fields, grads))


def rel_err(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def flagship_train_config(steps: int, checkpoint_dir: str):
    """The flagship training config: surface d=11, H = MH = 128, R=14
    weight-tied, readout both, pauli4, bf16 states, batch 4096, lr 1e-3,
    warmup 200, per-shot p-mix 0.01..0.05, EMA 0.999
    (benchmarks/train_quality_v3.py:64-78, scripts/tpu_queue_r2a.sh:108-110),
    from a seeded random init."""
    from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig

    return ExperimentConfig(
        code=CodeConfig(family="surface", distance=D, p=0.05),
        model=ModelConfig(hidden=128, msg_hidden=128, rounds=14, readout="both",
                          qubit_head="pauli4", dtype="bfloat16"),
        train=TrainConfig(batch=B, steps=steps, lr=1e-3, warmup_steps=200,
                          eval_every=1000, eval_shots=8192, seed=0,
                          checkpoint_dir=checkpoint_dir, checkpoint_every=1000,
                          ema_decay=0.999, p_mix=(0.01, 0.05)))


def yardstick_rounds(xc, xq, syn, dg, w, rounds: int, dtype):
    """Reference mechanics of one round, R times: per-edge index_select of
    both endpoints, the edge MLPs, index_add_ into the destination rows, then
    the update MLPs and LayerNorm (eps 1e-6).  The same function as
    rounds_plain without the weight folding; the port never calls it."""
    import torch
    import torch.nn.functional as F

    e = dg.n_edges
    ec = dg.edge_check[:e].long()
    eq = dg.edge_qubit[:e].long()
    c = lambda a: a.to(dtype)
    W = {k: c(v) for k, v in w._asdict().items()}
    xc, xq, s = c(xc), c(xq), c(syn)
    h = xc.shape[-1]
    for _ in range(rounds):
        xce = xc.index_select(1, ec)
        xqe = xq.index_select(1, eq)
        m_c = torch.relu(xce @ W["wd_c"] + xqe @ W["ws_c"] + W["b0_c"]) @ W["wo_c"] + W["bo_c"]
        m_q = torch.relu(xqe @ W["wd_q"] + xce @ W["ws_q"] + W["b0_q"]) @ W["wo_q"] + W["bo_q"]
        agg_c = torch.zeros_like(xc).index_add_(1, ec, m_c)
        agg_q = torch.zeros_like(xq).index_add_(1, eq, m_q)
        hc = torch.relu(xc @ W["uc_x"] + agg_c @ W["uc_a"] + s * W["uc_s"] + W["uc_b0"])
        hq = torch.relu(xq @ W["uq_x"] + agg_q @ W["uq_a"] + W["uq_b0"])
        xc, xq = (
            F.layer_norm(xc + hc @ W["uc_w1"] + W["uc_b1"], (h,),
                         W["lnc_scale"].reshape(-1), W["lnc_bias"].reshape(-1), 1e-6),
            F.layer_norm(xq + hq @ W["uq_w1"] + W["uq_b1"], (h,),
                         W["lnq_scale"].reshape(-1), W["lnq_bias"].reshape(-1), 1e-6),
        )
    return xc.float(), xq.float()


def random_states(dg, batch: int, h: int, gen):
    """Seeded N(0, 1) node states masked to real nodes, and a +-1 syndrome
    feature from depolarizing noise at p = 0.05."""
    import torch

    from tpugnn_torch.sampling import sample_batch

    dev = dg.check_mask.device
    xc = torch.randn((batch, dg.n_checks_pad, h), generator=gen, device=dev)
    xq = torch.randn((batch, dg.n_qubits_pad, h), generator=gen, device=dev)
    syn = sample_batch(gen, dg, 0.05, batch).syndrome
    s_pm = ((2.0 * syn - 1.0) * dg.check_mask)[..., None]
    return xc * dg.check_mask[:, None], xq * dg.qubit_mask[:, None], s_pm


def z_score(rate: float, n: int, ref: float, ref_n: int) -> float:
    """Two-sample z of a binomial rate against the reference, pooled."""
    pool = (rate * n + ref * ref_n) / (n + ref_n)
    se = (pool * (1 - pool) * (1 / n + 1 / ref_n)) ** 0.5
    return (rate - ref) / se


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(REPO, "tpugnn_torch")):
        log("chip_smoke.py must run from a checkout of the repository "
            "(tpugnn_torch/ not found beside it)")
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on an NVIDIA card")
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpugnn_torch.eval import decode_corrections, ler_monte_carlo
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels._build import build_libraries, nvcc_path
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.models.convert import read_meta
    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.serve import DecodeEngine
    from tpugnn_torch.tanner import build_code

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    with Phase("environment") as info:
        smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0].strip()
        info.update(torch=torch.__version__, cuda=torch.version.cuda,
                    nvcc=run([nvcc_path(), "--version"]).splitlines()[-1],
                    device=kind, nvidia_smi=smi, device_count=torch.cuda.device_count())

    with Phase("build") as info:
        t0 = time.perf_counter()
        built = build_libraries()       # one nvcc per source, all at once
        for name, (path, seconds, build_log) in built.items():
            log(build_log)
            info[name] = dict(library=os.path.relpath(path, REPO), cold=seconds > 0,
                              build_seconds=round(seconds, 3))
        info["wall_seconds"] = round(time.perf_counter() - t0, 3)

    graph = build_code("surface", D)
    dg = graph.to(dev)
    ops = fd.make_operators(dg)
    h = 128

    with Phase("kernel_vs_plain") as info:
        errs = {}
        for dtype, rounds, tol_max, tol_mean, min_agree in (
                ("bfloat16", 8, TOL_BF16_MAX, TOL_BF16_MEAN, MIN_AGREE_BF16),
                ("float32", 14, TOL_F32, TOL_F32, MIN_AGREE_F32)):
            gen = torch.Generator(device=dev).manual_seed(7)
            model = GNNDecoder(ModelConfig(hidden=h, msg_hidden=h, rounds=rounds,
                                           qubit_head="pauli4", dtype=dtype), k=1)
            model.init_random(torch.Generator().manual_seed(11), bias_std=0.1)
            model = model.to(dev).eval()
            w = model.rounds.round_weights()
            xc, xq, s = random_states(dg, B, h, gen)
            with torch.inference_mode():
                kc, kq = fd.decoder_rounds(xc, xq, s, ops, w, rounds, dtype)
                pc, pq = fd.rounds_plain(xc, xq, s, ops, w, rounds=rounds, state_dtype=dtype)
                torch.cuda.synchronize()
                diff = torch.cat([(kc - pc).abs().flatten(), (kq - pq).abs().flatten()])
                max_err, mean_err = float(diff.max()), float(diff.mean())
                n = graph.n_qubits
                agree = float((model.head_qubit(kq)[:, :n].argmax(-1)
                               == model.head_qubit(pq)[:, :n].argmax(-1)).float().mean())
                finite = bool(torch.isfinite(kc).all() and torch.isfinite(kq).all())
            errs[dtype] = max_err
            info[dtype] = dict(rounds=rounds, max_abs_err=max_err, mean_abs_err=mean_err,
                               agree=agree, tol_max=tol_max, tol_mean=tol_mean,
                               min_agree=min_agree)
            if not finite:
                raise RuntimeError(f"{dtype}: kernel produced non-finite states")
            if max_err > tol_max or mean_err > tol_mean or agree < min_agree:
                raise RuntimeError(f"{dtype} R={rounds}: kernel disagrees with "
                                   f"rounds_plain: {info[dtype]}")
        # the yardstick's function, checked once in f32 against the plain version
        with torch.inference_mode():
            yc, yq = yardstick_rounds(xc, xq, s, dg, w, 14, torch.float32)
            info["yardstick_vs_plain_f32"] = float(torch.maximum(
                (yc - pc).abs().max(), (yq - pq).abs().max()))

    launches = {}
    with Phase("serve") as info:
        fd.reset_launch_counts()
        eng = DecodeEngine.from_npz(device="cuda", max_batch=B)
        gen = torch.Generator(device=dev).manual_seed(2024)
        syn = sample_batch(gen, dg, 0.05, 6001).syndrome.cpu().numpy().astype("uint8")
        reqs = [syn[:1], syn[1:1001, :graph.n_checks], syn[1001:6001]]
        outs, request_ms = [], []
        for r in reqs:            # decode() returns host arrays: it has synced
            t0 = time.perf_counter()
            outs.append(eng.decode(r))
            request_ms.append((time.perf_counter() - t0) * 1e3)
        launches["serve"] = fd.launch_counts()["fused_rounds"]
        # the same requests through the model directly, chunk for chunk
        with torch.inference_mode():
            for r, o in zip(reqs, outs):
                if o.shape != (r.shape[0], graph.n_qubits, 2) or o.dtype != np.uint8:
                    raise RuntimeError(f"serve output {o.shape} {o.dtype}")
                full = np.zeros((r.shape[0], graph.n_checks_pad), np.float32)
                full[:, :r.shape[1]] = r
                want = []
                for lo in range(0, r.shape[0], B):
                    chunk = np.zeros((B, graph.n_checks_pad), np.float32)
                    part = full[lo:lo + B]
                    chunk[:len(part)] = part
                    out = eng.model(dg, torch.from_numpy(chunk).to(dev))
                    ex, ez = decode_corrections(out.qubit_logits)
                    want.append(torch.stack([ex, ez], -1)[:len(part), :graph.n_qubits]
                                .to(torch.uint8).cpu().numpy())
                if not np.array_equal(o, np.concatenate(want)):
                    raise RuntimeError("serve output differs from the direct decode")
        if launches["serve"] < 1:
            raise RuntimeError("the serve path did not launch the kernel")
        info.update(requests=[int(r.shape[0]) for r in reqs],
                    widths=[int(r.shape[1]) for r in reqs], request_ms=request_ms,
                    launches=launches["serve"])

    with Phase("ler") as info:
        fd.reset_launch_counts()
        gen = torch.Generator(device=dev).manual_seed(2025)
        ev = ler_monte_carlo(eng.model, graph, p=0.05, shots=65536, batch=B,
                             generator=gen, device="cuda")
        launches["ler"] = fd.launch_counts()["fused_rounds"]
        n = int(ev["shots"])
        ref = read_meta()["ler_reference"]
        if ref["p"] != 0.05:
            raise RuntimeError(f"weights file's reference LER is at p={ref['p']}")
        z = {
            "logical_vs_jax_f32": z_score(ev["ler_logical"], n, ref["ler_logical"], ref["shots"]),
            "qubit_vs_jax_f32": z_score(ev["ler"], n, ref["ler"], ref["shots"]),
            "logical_vs_table": z_score(ev["ler_logical"], n, REF_LER_LOGICAL, REF_SHOTS),
            "qubit_vs_table": z_score(ev["ler"], n, REF_LER_QUBIT, REF_SHOTS),
        }
        info.update(shots=n, ler_logical=ev["ler_logical"], ler_qubit=ev["ler"],
                    ler_hybrid=ev["ler_hybrid"], z=z,
                    jax_f32=dict(shots=ref["shots"], ler_logical=ref["ler_logical"],
                                 ler_qubit=ref["ler"]),
                    table=dict(shots=REF_SHOTS, ler_logical=REF_LER_LOGICAL,
                               ler_qubit=REF_LER_QUBIT),
                    launches=launches["ler"])
        if launches["ler"] < 1:
            raise RuntimeError("the LER path did not launch the kernel")
        gated = ("logical_vs_jax_f32", "qubit_vs_jax_f32", "logical_vs_table")
        if any(abs(z[k]) > 4 for k in gated):
            raise RuntimeError(f"LER off the reference: {info}")
    trained = eng.model
    del eng

    with Phase("timing") as info:
        b, rounds = B, 8
        gen = torch.Generator(device=dev).manual_seed(5)
        model = GNNDecoder(ModelConfig(hidden=h, msg_hidden=h, rounds=rounds,
                                       qubit_head="pauli4", dtype="bfloat16"), k=1)
        model.init_random(torch.Generator().manual_seed(13), bias_std=0.1)
        w = model.to(dev).rounds.round_weights()
        w = fd.RoundWeights(*[t.detach() for t in w])
        xc, xq, s = random_states(dg, b, h, gen)
        with torch.inference_mode():
            k_ms = time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, w, rounds, "bfloat16"))
            p_ms = time_ms(lambda: fd.rounds_plain(xc, xq, s, ops, w, rounds=rounds,
                                                   state_dtype="bfloat16"))
            y_ms = time_ms(lambda: yardstick_rounds(xc, xq, s, dg, w, rounds, torch.bfloat16))
        flops = rounds_flops(graph, h) * b * rounds
        nbytes = rounds_bytes(graph, b, h, 2)
        t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BPS * 1e3
        edges = b * graph.n_edges * rounds
        info.update(batch=b, rounds=rounds, kernel_ms=k_ms, plain_ms=p_ms,
                    yardstick_ms=y_ms, bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    f32_core_ms=flops / H100_F32_FLOPS * 1e3, gflop=flops / 1e9,
                    edges_per_s_kernel=edges / (k_ms / 1e3),
                    edges_per_s_plain=edges / (p_ms / 1e3),
                    edges_per_s_yardstick=edges / (y_ms / 1e3))
        # the trained config's decode step (B=4096, R=14, f32): the whole
        # forward beside its rounds kernel alone on same-shaped states
        gen = torch.Generator(device=dev).manual_seed(6)
        syn = sample_batch(gen, dg, 0.05, b).syndrome
        wt = fd.RoundWeights(*[t.detach() for t in trained.rounds.round_weights()])
        xc, xq, s = random_states(dg, b, h, gen)
        r_t = trained.cfg.rounds
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: trained(dg, syn))
            rk_ms = time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, wt, r_t, "float32"))
        flops_t = rounds_flops(graph, h) * b * r_t
        info.update(trained_forward_ms=fwd_ms, trained_kernel_ms=rk_ms,
                    trained_gflop=flops_t / 1e9,
                    trained_bound_ms=max(flops_t / H100_F32_FLOPS,
                                         rounds_bytes(graph, b, h, 4) / H100_HBM_BPS) * 1e3,
                    trained_kernel_share=rk_ms / fwd_ms,
                    trained_edges_per_s=b * graph.n_edges * r_t / (fwd_ms / 1e3))
        timing = dict(info)

    from tpugnn_torch.kernels import fused_backward as fb

    with Phase("train_kernel_vs_plain") as info:
        train_errs = {}
        for dtype, tol_rel, tol_max, tol_mean in (
                ("bfloat16", TOL_GRAD_REL_BF16, TOL_BF16_MAX, TOL_BF16_MEAN),
                ("float32", TOL_GRAD_REL_F32, TOL_F32, TOL_F32)):
            rounds = 14
            gen = torch.Generator(device=dev).manual_seed(9)
            model = GNNDecoder(ModelConfig(hidden=h, msg_hidden=h, rounds=rounds,
                                           qubit_head="pauli4", dtype=dtype), k=1)
            model.init_random(torch.Generator().manual_seed(14), bias_std=0.1)
            w = fd.RoundWeights(*[t.detach() for t in model.to(dev).rounds.round_weights()])
            mats32, vecs32 = fd.pack_weights_f32(w)
            xc, xq, s = random_states(dg, B, h, gen)
            cot_c = torch.randn(xc.shape, generator=gen, device=dev)
            cot_q = torch.randn(xq.shape, generator=gen, device=dev)
            with torch.no_grad():
                k1c, k1q = fd.decoder_rounds(xc, xq, s, ops, w, rounds, dtype)
                kc, kq, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32,
                                                    rounds, dtype)
                pc, pq, psc, psq = fb.rounds_fwd_stash_plain(
                    xc, xq, s, ops, mats32, vecs32, rounds=rounds, state_dtype=dtype)
                # both backward versions read the kernel's stash
                kg = fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dtype)
                pg = fb.rounds_vjp_plain(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q,
                                         state_dtype=dtype)
                torch.cuda.synchronize()
                same_as_k1 = bool(torch.equal(kc, k1c) and torch.equal(kq, k1q))
                out_diff = torch.cat([(kc - pc).abs().flatten(), (kq - pq).abs().flatten()])
                st_max, st_sum, st_n = 0.0, 0.0, 0
                for r in range(rounds):
                    for a_, b_ in ((sc[r], psc[r]), (sq[r], psq[r])):
                        dd = (a_.float() - b_.float()).abs()
                        st_max = max(st_max, float(dd.max()))
                        st_sum += float(dd.sum())
                        st_n += dd.numel()
                finite = all(bool(torch.isfinite(t).all()) for t in (kc, kq, *kg))
            k_leaves = weight_leaves(w, kg[3], kg[4])
            p_leaves = weight_leaves(w, pg[3], pg[4])
            rels = {n: rel_err(a_, b_) for n, a_, b_ in zip(("dxc", "dxq", "dsyn"), kg, pg)}
            rels.update({f: rel_err(k_leaves[f], p_leaves[f]) for f in fd.RoundWeights._fields})
            grad_max = max(float((a_ - b_).abs().max()) for a_, b_ in zip(
                list(kg[:3]) + list(k_leaves.values()), list(pg[:3]) + list(p_leaves.values())))
            worst = max(rels, key=rels.get)
            info[dtype] = dict(
                rounds=rounds, batch=B, k2a_equals_k1=same_as_k1,
                k2a_vs_plain_max=float(out_diff.max()), k2a_vs_plain_mean=float(out_diff.mean()),
                stash_vs_plain_max=st_max, stash_vs_plain_mean=st_sum / st_n,
                k2b_max_abs_err=grad_max, k2b_worst_rel=rels[worst], k2b_worst_leaf=worst,
                k2b_rel=rels, tol_rel=tol_rel, tol_max=tol_max, tol_mean=tol_mean)
            train_errs[dtype] = info[dtype]
            if not finite:
                raise RuntimeError(f"{dtype}: K2a/K2b produced non-finite values")
            if not same_as_k1:
                raise RuntimeError(f"{dtype}: K2a's outputs differ from K1's")
            if (float(out_diff.max()) > tol_max or float(out_diff.mean()) > tol_mean
                    or st_max > tol_max or st_sum / st_n > tol_mean):
                raise RuntimeError(f"{dtype}: K2a disagrees with rounds_fwd_stash_plain: "
                                   f"{info[dtype]}")
            if rels[worst] > tol_rel:
                raise RuntimeError(f"{dtype}: K2b disagrees with rounds_vjp_plain on "
                                   f"{worst}: {info[dtype]}")
            del kc, kq, sc, sq, pc, pq, psc, psq, kg, pg, out_diff
            torch.cuda.empty_cache()

    with Phase("train") as info:
        import tempfile

        from tpugnn_torch.train import train

        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
        steps_log = []                 # (step, loss, launches in the step, event)
        prev = {}

        def on_step(step, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            now = fd.launch_counts()
            steps_log.append((step, metrics["loss"], {k: now[k] - prev[k] for k in now},
                              ev))
            prev.update(now)

        fd.reset_launch_counts()
        prev.update(fd.launch_counts())
        first, _, _, _ = train(flagship_train_config(TRAIN_RESUME, ckpt_dir), device="cuda",
                               log=log, callback=on_step)
        live = [p.detach().clone() for p in first.model.parameters()]
        n_first = len(steps_log)
        del first
        # a fresh train() restores the step-TRAIN_RESUME checkpoint, runs no step
        msgs = []
        again, _, _, _ = train(flagship_train_config(TRAIN_RESUME, ckpt_dir), device="cuda",
                               log=msgs.append, callback=on_step)
        restored_equal = all(torch.equal(x, y) for x, y in zip(live, again.model.parameters()))
        del again
        prev.update(fd.launch_counts())
        state, model, _, history = train(flagship_train_config(TRAIN_STEPS, ckpt_dir),
                                         device="cuda", log=log, callback=on_step)
        torch.cuda.synchronize()
        launches["train"] = fd.launch_counts()
        losses = [float(l) for _, l, _, _ in steps_log]
        per_step = [c for _, _, c, _ in steps_log]
        step_ms = [steps_log[i - 1][3].elapsed_time(steps_log[i][3])
                   for i in range(2, len(steps_log)) if i != n_first and i != n_first + 1]
        first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        ema_diff = any(not torch.equal(e, p) for e, p in zip(state.ema.parameters(),
                                                             model.parameters()))
        ema_finite = all(bool(torch.isfinite(e).all()) for e in state.ema.parameters())
        info.update(steps=len(losses), resumed_at=TRAIN_RESUME, losses=losses,
                    loss_first5=first5, loss_last5=last5, loss_ratio=last5 / first5,
                    loss_fall_bound=LOSS_FALL, restored_equal=restored_equal,
                    restore_message=msgs, ema_differs=ema_diff, ema_finite=ema_finite,
                    launches=launches["train"], history=history,
                    step_ms_median=statistics.median(step_ms), step_ms=step_ms)
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"train: {len(losses)} steps, losses {losses}")
        if any(c != {"fused_rounds": 0, "fused_rounds_fwd_stash": 1, "fused_rounds_bwd": 1}
               for c in per_step):
            raise RuntimeError(f"train: a step did not launch K2a and K2b once each "
                               f"(and K1 never): {per_step}")
        if not last5 < LOSS_FALL * first5:
            raise RuntimeError(f"train: loss did not fall: {first5} -> {last5}")
        if not (ema_diff and ema_finite):
            raise RuntimeError("train: the EMA equals the live parameters or is not finite")
        if f"restored checkpoint at step {TRAIN_RESUME}" not in msgs or not restored_equal:
            raise RuntimeError(f"train: the restored parameters differ from the live "
                               f"run's at step {TRAIN_RESUME}: {msgs}")

        # K2a and K2b alone at the step's shapes, their plain versions, and
        # the autograd yardstick of the same rounds
        rounds = state.model.cfg.rounds
        gen = torch.Generator(device=dev).manual_seed(10)
        w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
        mats32, vecs32 = fd.pack_weights_f32(w)
        xc, xq, s = random_states(dg, B, h, gen)
        cot_c = torch.randn(xc.shape, generator=gen, device=dev)
        cot_q = torch.randn(xq.shape, generator=gen, device=dev)
        with torch.no_grad():
            k2a_ms = time_ms(lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32,
                                                        rounds, "bfloat16"))
            _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, rounds,
                                              "bfloat16")
            k2b_ms = time_ms(lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c,
                                                  cot_q, "bfloat16"), warmup=2, iters=7)
            plain_fwd_ms = time_ms(lambda: fb.rounds_fwd_stash_plain(
                xc, xq, s, ops, mats32, vecs32, rounds=rounds, state_dtype="bfloat16"),
                warmup=1, iters=3)
            plain_bwd_ms = time_ms(lambda: fb.rounds_vjp_plain(
                sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, state_dtype="bfloat16"),
                warmup=1, iters=3)
        del sc, sq
        torch.cuda.empty_cache()
        leaves = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in w])
        xcg, xqg = xc.clone().requires_grad_(True), xq.clone().requires_grad_(True)

        def y_forward(r):
            with torch.enable_grad():
                return yardstick_rounds(xcg, xqg, s, dg, leaves, r, torch.bfloat16)

        def y_step(r):
            yc, yq = y_forward(r)
            with torch.enable_grad():
                ((yc * cot_c).sum() + (yq * cot_q).sum()).backward()

        y_rounds = rounds
        torch.cuda.reset_peak_memory_stats()
        try:
            y_step_ms = time_ms(lambda: y_step(y_rounds), warmup=1, iters=3)
        except torch.cuda.OutOfMemoryError:
            y_rounds = 8            # R=14 at B=4096 does not fit on this card
            torch.cuda.empty_cache()
            y_step_ms = time_ms(lambda: y_step(y_rounds), warmup=1, iters=3)
        y_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        y_fwd_ms = time_ms(lambda: y_forward(y_rounds), warmup=1, iters=3)
        t_ops_a = rounds_flops(graph, h) * B * rounds / H100_BF16_FLOPS * 1e3
        t_bytes_a = (rounds_bytes(graph, B, h, 2)
                     + stash_bytes(graph, B, rounds, h, 2)) / H100_HBM_BPS * 1e3
        rows = graph.n_checks + graph.n_qubits
        t_ops_b = rounds_bwd_flops(graph, h) * B * rounds / H100_BF16_FLOPS * 1e3
        t_bytes_b = (stash_bytes(graph, B, rounds, h, 2) + 2 * 2 * B * rows * h * 4
                     + 2 * B * graph.n_checks * 4 + 10 * h * h * (2 * 2 + 4)
                     + 2 * 14 * h * 4) / H100_HBM_BPS * 1e3
        info.update(
            k2a_ms=k2a_ms, k2b_ms=k2b_ms, plain_fwd_stash_ms=plain_fwd_ms,
            plain_vjp_ms=plain_bwd_ms,
            k2a_bound_ms=max(t_ops_a, t_bytes_a),
            k2a_bound_by="operations" if t_ops_a >= t_bytes_a else "bytes",
            k2b_bound_ms=max(t_ops_b, t_bytes_b),
            k2b_bound_by="operations" if t_ops_b >= t_bytes_b else "bytes",
            k2a_bytes_ms=t_bytes_a, k2b_bytes_ms=t_bytes_b,
            rounds_share_of_step=(k2a_ms + k2b_ms) / statistics.median(step_ms),
            yardstick_rounds=y_rounds, yardstick_step_ms=y_step_ms,
            yardstick_fwd_ms=y_fwd_ms, yardstick_bwd_ms=y_step_ms - y_fwd_ms,
            yardstick_peak_gb=y_peak_gb)
        train_timing = dict(info)
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    k1_launches = {k: (v if isinstance(v, int) else v["fused_rounds"])
                   for k, v in launches.items()}
    emit({"kernels": [{
        "name": "fused_rounds", "route": "cuda",
        "source": "tpugnn_torch/kernels/csrc/fused_rounds.cu",
        "replaces": "tpugnn/kernels/fused_decoder.py:637",
        "launches": sum(k1_launches.values()), "launches_by_path": k1_launches,
        "max_abs_err": errs["bfloat16"], "max_abs_err_f32": errs["float32"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "yardstick_ms": timing["yardstick_ms"],
    }, {
        "name": "fused_rounds_fwd_stash", "route": "cuda",
        "source": "tpugnn_torch/kernels/csrc/fused_rounds.cu",
        "replaces": "tpugnn/kernels/fused_backward.py:575",
        "launches": launches["train"]["fused_rounds_fwd_stash"],
        "max_abs_err": train_errs["bfloat16"]["k2a_vs_plain_max"],
        "max_abs_err_f32": train_errs["float32"]["k2a_vs_plain_max"],
        "ms": train_timing["k2a_ms"], "plain_ms": train_timing["plain_fwd_stash_ms"],
        "bound_ms": train_timing["k2a_bound_ms"], "bound_by": train_timing["k2a_bound_by"],
        "library_ms": None, "yardstick_ms": train_timing["yardstick_fwd_ms"],
    }, {
        "name": "fused_rounds_bwd", "route": "cuda",
        "source": "tpugnn_torch/kernels/csrc/fused_backward.cu",
        "replaces": "tpugnn/kernels/fused_backward.py:624",
        "launches": launches["train"]["fused_rounds_bwd"],
        "max_abs_err": train_errs["bfloat16"]["k2b_max_abs_err"],
        "max_rel_err": train_errs["bfloat16"]["k2b_worst_rel"],
        "max_rel_err_f32": train_errs["float32"]["k2b_worst_rel"],
        "ms": train_timing["k2b_ms"], "plain_ms": train_timing["plain_vjp_ms"],
        "bound_ms": train_timing["k2b_bound_ms"], "bound_by": train_timing["k2b_bound_by"],
        "library_ms": None, "yardstick_ms": train_timing["yardstick_bwd_ms"],
    }]})
    emit({"total_seconds": round(time.perf_counter() - t_start, 3)})
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0].strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
