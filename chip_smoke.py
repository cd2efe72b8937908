#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpugnn_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's decode path on the card and checks it, in phases that each
print one JSON line with their wall time:

  0 environment: torch, nvcc and the card's name and power limit
  1 build: the CUDA kernels from the sources in the checkout (one nvcc per
    source, all started together -> .so)
  2 kernel vs plain: the fused-rounds kernel against rounds_plain on the card
    at the main path's shapes, d=11, H=128, B=4096 (R=8 bf16 and R=14 f32),
    and at d=13 in bf16 (B=64, R=3: its 176-row sides run a whole 128-row
    chunk and a ragged one), with stated tolerances
  3 serve: a DecodeEngine on the trained d=11 weights answers requests of
    1, 1000 and 5000 syndromes; outputs equal the model's direct decode
  4 LER: ler_monte_carlo of the trained weights at p=0.05 on 65,536 shots,
    z-scores against the JAX package's own f32 LER recorded in the weights
    file (both heads gated at |z| <= 4) and against benchmarks/LER_TABLE.md:30
    (logical head gated at |z| <= 4; per-qubit head reported, see below)
  5 timing: the bench config (d=11, B=4096, R=8, H=128, bf16) with CUDA
    events: the kernel's step and its TFLOP/s beside its bound and the f32
    CUDA-core floor, rounds_plain, and an index_select + index_add_ round
    loop as the yardstick
  6 training kernels vs plain: at the flagship training shapes (d=11, H=128,
    R=14, B=4096) in bf16 and in f32, K2a's outputs against K1's, its stash
    against rounds_fwd_stash_plain, and K2b's gradients (states, syndrome and
    every weight leaf) against rounds_vjp_plain, with stated tolerances; K2b
    twice on the same inputs, bit-equal; the same checks at d=13 in bf16
    (B=64, R=3)
  7 train: train() on the flagship training config from a seeded random
    init, TRAIN_STEPS steps in two calls with a checkpoint resume between
    them; gates a finite, falling loss, one K2a and one K2b launch and no K1
    launch per step, the EMA, and a bit-equal restore; then two train steps
    from the run's last state through K2a/K2b and through their plain
    versions on the same CUDA tensors, each parameter leaf's change gated
    (with K2b's weight gradients zeroed, what the gate catches, reported);
    times the step, K2a and K2b alone (with their TFLOP/s and f32 CUDA-core
    floors), their plain versions and the autograd yardstick
  8 spmm/sddmm kernels vs plain: K3a (sum, mean), K3b (max) and K4 at d=11,
    B=4096, F = H = MH = 128 against their plain versions on the card, in f32
    and bf16, with stated tolerances; their times beside their plain
    versions', their bounds and the PyTorch call that computes the same
    function (index_add_, scatter_reduce amax)
  9 generic flagship: the trained d=11 weights on the generic engine
    (load_decoder(backend='pallas'), f32, R=14): LER at p=0.05 on phase 4's
    65,536 shots, both heads gated at |z| <= 4 against the JAX f32 rate;
    per-shot decisions against phase 4's fused decode (>= 99.9% equal);
    2 R K3a launches per chunk and no K1; the forward's time and K3a's share
 10 toric d=7: the trained toric weights through the fused path (K1) and
    the generic path (K3a), LER at p=0.05 on 65,536 shots, both heads gated
    at |z| <= 4 against the JAX f32 rate and the logical head against
    benchmarks/LER_TORIC.md:18; then random-weight full-width generic
    forwards (d=11, H=128, B=4096, R=8) with aggr max (K3b) and mean (K3a)
    against the same model on the plain versions, and the bench config's
    generic forward (bf16, sum) for its edges/s
 11 roll gather: K5 (the rounds on the surface code's raster) at the bench
    config with f32 slots and with slot16 against roll_rounds_plain on the
    card (every raster cell) and against K1 on the real rows, with stated
    tolerances; its time beside its plain version's and K1's on the same
    inputs, and edges/s of both schedules; then the trained d=11 weights
    through PallasDecoder(schedule=('rollgather',)) (f32, R=14): K5 against
    the plain version, LER at p=0.05 on phase 4's 65,536 shots (both heads
    gated at |z| <= 4 against the JAX f32 rate), per-shot decisions against
    phase 4's fused decode (>= 99.9% equal), one K5 launch per chunk and no
    K1, the forward's time; and the wrapper's refusal of d=13 in f32 (its
    raster does not fit in shared memory)

Phases 3, 4, 7, 9, 10 and 11 are the main paths; the launch counts of every
kernel are reset before and read after each.  Then it prints the kernel
table as one JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any
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
LER_SHOTS = 65536         # Monte-Carlo shots of each LER phase

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
# d=13 checks of K1, K2a and K2b (phases 2 and 6): its 176-row sides run a
# whole 128-row chunk and a ragged 48-row one; the tolerances above apply
D13_BATCH = 64
D13_ROUNDS = 3
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
# K2b trains: from the run's last state (parameters and AdamW moments),
# TRAIN_CHECK_STEPS steps through K2a/K2b and through their plain versions on
# the same CUDA tensors and batches; each parameter leaf's change from the
# start, kernels against plain, as a relative L2 error after every step.  K2b's
# gradients are within about 2e-3 of the plain version's per leaf (phase 6),
# and a step moves the AdamW first moment by a tenth of the new gradient, so
# the changes differ by about 1e-3 (on an H100: 7.0e-4 after one step,
# 1.07e-3 after two); with K2b's weight gradients zeroed the least-moved round
# leaf differs by 0.33 and 0.45.  Bound 1e-2.
TRAIN_CHECK_STEPS = 2
TRAIN_STEP_REL = 1e-2

# K3a against ell_aggregate_plain on the card: the same f32 adds of at most
# 4 messages per row in another order; relative to the largest output.
TOL_ELL_SUM_REL = 1e-5
# K4 in f32 against sddmm_edge_hidden_plain: the projections summed in
# another order (FMA loops vs the library GEMM); values O(1).
TOL_SDDMM_F32 = 1e-4
# K4 in bf16: both round each projection, each add and the bias to bf16 in
# the same order, but the f32 sums inside a projection run in another order,
# so a projection now and then rounds one bf16 step apart (2^-5 = 0.031 at
# |y| in [4, 8)); with both projections and the final rounding that is at
# most 0.0625 on an output, and it happens on few of them (<= 1%).
TOL_SDDMM_BF16_MAX = 0.0625
TOL_SDDMM_BF16_SHARE = 0.01
# the generic flagship's per-shot decisions (the per-qubit head's failure
# and the logical head's class bits) against the fused decode's: the same
# f32 function summed in another order
MIN_SHOT_AGREE = 0.999
# K5 against roll_rounds_plain: the same tolerances as K1's (TOL_F32,
# TOL_BF16_MAX, TOL_BF16_MEAN), for the same reason: both round at the same
# points (with slot16 after every op of the slot stage) and differ in f32
# summation order.  K5 against K1 on the real rows: the same function with
# the slot sum in another order (offs order against ELL order) and
# (deg * bo) @ ua against deg * (bo @ ua), so bf16 roundings flip more
# often; the plain versions of both on the CPU (d=11, B=8, R=8, bf16) differ
# by max 0.023 / mean 3.3e-4 with f32 slots and 0.031 / 3.4e-3 with slot16,
# inside the same max 0.25 and mean 1e-2.
# benchmarks/LER_TORIC.md:18: r2_toric_d7@8000, p=0.05, 1e6 shots, taken on a
# TPU; logical head 0.01267 (gated), per-qubit 0.1631 (reported: the TPU's
# GEMM precision moves it, as for LER_TABLE.md:30)
TORIC_REF_LER_LOGICAL = 0.01267
TORIC_REF_LER_QUBIT = 0.1631

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
    """The flagship training config as benchmarks/train_quality_v3.py:64-78
    writes it and scripts/tpu_queue_r2a.sh:108-110 runs it: surface d=11,
    H = MH = 128, R=14 weight-tied, backend 'pallas' (trained in the fused
    layout), no remat, readout both, pauli4, bf16 states, batch 4096, lr
    1e-3, warmup 200, per-shot p-mix 0.01..0.05, EMA 0.999; from a seeded
    random init."""
    from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig

    return ExperimentConfig(
        code=CodeConfig(family="surface", distance=D, p=0.05),
        model=ModelConfig(hidden=128, msg_hidden=128, rounds=14, backend="pallas",
                          readout="both", qubit_head="pauli4", remat=False,
                          dtype="bfloat16"),
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


def random_round_case(d: int, batch: int, rounds: int, dtype: str, seed: int, dev):
    """A surface code of distance d on the card, seeded random full-width
    round weights (H = MH = 128) and random states: ``(graph, dg, ops, w,
    xc, xq, syn, gen)``."""
    import torch

    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.tanner import build_code

    graph = build_code("surface", d)
    dg = graph.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = GNNDecoder(ModelConfig(hidden=128, msg_hidden=128, rounds=rounds, backend="fused",
                                   qubit_head="pauli4", dtype=dtype), k=1)
    model.init_random(torch.Generator().manual_seed(seed + 1), bias_std=0.1)
    w = fd.RoundWeights(*[t.detach() for t in model.to(dev).rounds.round_weights()])
    xc, xq, syn = random_states(dg, batch, 128, gen)
    return graph, dg, fd.make_operators(dg), w, xc, xq, syn, gen


def grad_errors(w, kg, pg) -> dict:
    """Relative L2 error of K2b's gradients against the plain version's, per
    leaf: dxc, dxq, dsyn and the 25 round-weight leaves."""
    from tpugnn_torch.kernels import fused_decoder as fd

    k_leaves = weight_leaves(w, kg[3], kg[4])
    p_leaves = weight_leaves(w, pg[3], pg[4])
    rels = {n: rel_err(a, b) for n, a, b in zip(("dxc", "dxq", "dsyn"), kg, pg)}
    rels.update({f: rel_err(k_leaves[f], p_leaves[f]) for f in fd.RoundWeights._fields})
    return rels


def z_score(rate: float, n: int, ref: float, ref_n: int) -> float:
    """Two-sample z of a binomial rate against the reference, pooled."""
    pool = (rate * n + ref * ref_n) / (n + ref_n)
    se = (pool * (1 - pool) * (1 / n + 1 / ref_n)) ** 0.5
    return (rate - ref) / se


def reset_counts() -> None:
    """Sets the launch count of every kernel to 0."""
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather, sddmm, spmm

    for mod in (fd, spmm, sddmm, roll_gather):
        mod.reset_launch_counts()


def counts() -> dict:
    """Launches of every kernel since the last reset_counts()."""
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather, sddmm, spmm

    return {**fd.launch_counts(), **spmm.launch_counts(), **sddmm.launch_counts(),
            **roll_gather.launch_counts()}


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` at the HBM rate and ``ops`` at
    ``peak``, and which of the two sets it."""
    t_b, t_o = nbytes / H100_HBM_BPS * 1e3, ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def ell_bound(graph, batch: int, f: int, itemsize: int, to: str) -> tuple[float, str]:
    """K3a/K3b on one direction: each real edge's message read once, each
    real row written once in f32, the slot table read once; one add (or
    compare) per real edge and column at the f32 CUDA-core peak."""
    if to == "check":
        rows, rows_pad, d = graph.n_checks, graph.n_checks_pad, graph.deg_max_check
    else:
        rows, rows_pad, d = graph.n_qubits, graph.n_qubits_pad, graph.deg_max_qubit
    nbytes = batch * graph.n_edges * f * itemsize + batch * rows * f * 4 + rows_pad * d * 4
    return bound(nbytes, batch * graph.n_edges * f, H100_F32_FLOPS)


def sddmm_bound(graph, batch: int, h: int, mh: int, compute: str) -> tuple[float, str]:
    """K4 to checks: the real rows of both sides read once, each real slot's
    f32 output written once, the weights once; both projections over the
    real rows and an add, add and relu per real slot and column, at the
    compute type's peak (bf16 tensor cores or f32 CUDA cores)."""
    itemsize, peak = (2, H100_BF16_FLOPS) if compute == "bfloat16" else (4, H100_F32_FLOPS)
    rows = graph.n_checks + graph.n_qubits
    nbytes = (batch * rows * h * itemsize + batch * graph.n_edges * mh * 4 + 2 * h * mh * 4
              + mh * 4 + graph.n_checks_pad * graph.deg_max_check * 4)
    ops = 2 * batch * rows * h * mh + 3 * batch * graph.n_edges * mh
    return bound(nbytes, ops, peak)


def train_steps_vs_plain(state, cfg, dg, dev) -> dict:
    """Phase 7's check that K2b trains: TRAIN_CHECK_STEPS train steps from
    the run's last state, through K2a/K2b (``kernels``), through their plain
    versions on the same CUDA tensors (``plain``), and through K2a/K2b with
    K2b's weight gradients replaced by zeros (``zero_wgrads``, what the check
    must catch), on the same batches.  Returns each variant's relative L2
    error against ``plain`` of every parameter leaf's change from the start,
    after every step."""
    import copy

    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.models import decoder as dec
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.train.loop import train_step
    from tpugnn_torch.train.optim import make_optimizer

    gen = torch.Generator(device=dev).manual_seed(77)
    batches = [sample_batch(gen, dg, 0.05, cfg.train.batch) for _ in range(TRAIN_CHECK_STEPS)]
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    rounds_fn, bwd_cuda = dec.decoder_rounds, fb._bwd_cuda

    def plain_rounds(xc, xq, syn, ops, weights, rounds, state_dtype):
        return fb.trained_rounds(xc, xq, syn, ops, weights, rounds, state_dtype, kernels=False)

    def zero_wgrads(*args):
        g_c, g_q, dsyn, dmats, dvecs = bwd_cuda(*args)
        return g_c, g_q, dsyn, torch.zeros_like(dmats), torch.zeros_like(dvecs)

    deltas = {}
    for variant in ("kernels", "plain", "zero_wgrads"):
        model = copy.deepcopy(state.model)
        opt = make_optimizer(cfg, model.parameters())
        opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
        if variant == "plain":
            dec.decoder_rounds = plain_rounds
        elif variant == "zero_wgrads":
            fb._bwd_cuda = zero_wgrads
        try:
            deltas[variant] = []
            for batch in batches:
                train_step(model, opt, dg, batch, cfg)
                deltas[variant].append({n: p.detach() - start[n]
                                        for n, p in model.named_parameters()})
        finally:
            dec.decoder_rounds, fb._bwd_cuda = rounds_fn, bwd_cuda
        del model, opt
    return {v: [{n: rel_err(d[n], p[n]) for n in d} for d, p in zip(deltas[v], deltas["plain"])]
            for v in ("kernels", "zero_wgrads")}


def phase_spmm_sddmm(graph, dg, dev, info: dict) -> dict:
    """Phase 8: K3a, K3b and K4 against their plain versions at the main
    path's shapes (d=11, B=4096, F = H = MH = 128), f32 and bf16; their
    times, bounds and the library calls.  Returns the kernel-table rows'
    numbers."""
    import torch

    from tpugnn_torch import mp
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import sddmm, spmm

    f = 128
    gen = torch.Generator(device=dev).manual_seed(31)
    sides = {"check": (dg.ell_check_edge, dg.ell_check_mask, dg.edge_check,
                       graph.n_checks_pad, dg.check_deg),
             "qubit": (dg.ell_qubit_edge, dg.ell_qubit_mask, dg.edge_qubit,
                       graph.n_qubits_pad, dg.qubit_deg)}
    # the engine's messages: padded edges are zero (msg * edge_mask)
    msg32 = torch.randn((B, graph.n_edges_pad, f), generator=gen, device=dev)
    msg32 *= dg.edge_mask[:, None]
    checks, worst = {}, {"sum": 0.0, "max": 0.0, "mean": 0.0}
    with torch.inference_mode():
        for dname, msg in (("float32", msg32), ("bfloat16", msg32.bfloat16())):
            for to, (edge, mask, _, _, deg) in sides.items():
                for agg in ("sum", "max", "mean"):
                    if agg == "mean":   # K3a, divided by the clamped degree
                        k = getattr(mp, f"aggregate_to_{to}s")(dg, msg, backend="pallas",
                                                              agg="mean")
                        p = spmm.ell_aggregate_plain(msg, edge, mask) / deg[:, None]
                    else:
                        k = spmm.ell_aggregate(msg, edge, mask, agg=agg)
                        p = spmm.PLAIN[agg](msg, edge, mask)
                    torch.cuda.synchronize()
                    err = float((k - p).abs().max())
                    rel = err / max(float(p.abs().max()), 1e-30)
                    checks[f"{agg}_{to}_{dname}"] = dict(max_abs_err=err, rel_err=rel)
                    worst[agg] = max(worst[agg], err)
                    if not bool(torch.isfinite(k).all()):
                        raise RuntimeError(f"{agg} {to} {dname}: non-finite output")
                    if agg == "max" and not torch.equal(k, p):
                        raise RuntimeError(f"K3b {to} {dname} is not bit-equal to "
                                           f"ell_max_plain: max err {err}")
                    if agg != "max" and rel > TOL_ELL_SUM_REL:
                        raise RuntimeError(f"K3a {agg} {to} {dname} disagrees with the "
                                           f"plain version: rel {rel}")
        info["ell_checks"] = checks

        # times on f32 messages (the generic f32 path's), both directions
        times = {}
        for to, (edge, mask, seg, rows, _) in sides.items():
            idx = seg.long()
            ix = idx.view(1, -1, 1).expand(msg32.shape)

            def index_add():
                return torch.zeros((B, rows, f), device=dev).index_add_(1, idx, msg32)

            def scatter_amax():
                out = torch.full((B, rows, f), float("-inf"), device=dev).scatter_reduce_(
                    1, ix, msg32, "amax", include_self=False)
                return torch.where(torch.isneginf(out), 0.0, out)   # empty rows -> 0

            lib_sum, lib_max = index_add(), scatter_amax()
            k_sum = spmm.ell_aggregate(msg32, edge, mask, agg="sum")
            k_max = spmm.ell_aggregate(msg32, edge, mask, agg="max")
            torch.cuda.synchronize()
            times[to] = dict(
                k3a_ms=time_ms(lambda: spmm.ell_aggregate(msg32, edge, mask, agg="sum")),
                k3b_ms=time_ms(lambda: spmm.ell_aggregate(msg32, edge, mask, agg="max")),
                plain_sum_ms=time_ms(lambda: spmm.ell_aggregate_plain(msg32, edge, mask)),
                plain_max_ms=time_ms(lambda: spmm.ell_max_plain(msg32, edge, mask)),
                index_add_ms=time_ms(index_add),
                scatter_amax_ms=time_ms(scatter_amax),
                index_add_vs_k3a=float((lib_sum - k_sum).abs().max()),
                scatter_amax_equals_k3b=bool(torch.equal(lib_max, k_max)),
                bound_ms=ell_bound(graph, B, f, 4, to)[0],
                bound_by=ell_bound(graph, B, f, 4, to)[1],
                bound_ms_bf16=ell_bound(graph, B, f, 2, to)[0])
            del lib_sum, lib_max, k_sum, k_max
        info["ell_times"] = times

        # K4 to checks: x_dst the check states, x_src the qubit states
        h = mh = 128
        xd = torch.randn((B, graph.n_checks_pad, h), generator=gen, device=dev)
        xs = torch.randn((B, graph.n_qubits_pad, h), generator=gen, device=dev)
        xd *= dg.check_mask[:, None]
        xs *= dg.qubit_mask[:, None]
        wd = torch.randn((h, mh), generator=gen, device=dev) / h ** 0.5
        ws = torch.randn((h, mh), generator=gen, device=dev) / h ** 0.5
        b = 0.1 * torch.randn(mh, generator=gen, device=dev)
        src_c, mask_c = fd.make_operators(dg)[:2]
        args = (xd, xs, src_c, mask_c, wd, ws, b)
        k4 = {}
        for cdt in ("float32", "bfloat16"):
            k = sddmm.sddmm_edge_hidden(*args, compute_dtype=cdt)
            p = sddmm.sddmm_edge_hidden_plain(*args, compute_dtype=cdt)
            torch.cuda.synchronize()
            diff = (k - p).abs()
            err, share = float(diff.max()), float((diff > 0).float().mean())
            finite = bool(torch.isfinite(k).all())
            del k, p, diff
            t_k = time_ms(lambda: sddmm.sddmm_edge_hidden(*args, compute_dtype=cdt))
            t_p = time_ms(lambda: sddmm.sddmm_edge_hidden_plain(*args, compute_dtype=cdt))
            b_ms, b_by = sddmm_bound(graph, B, h, mh, cdt)
            k4[cdt] = dict(max_abs_err=err, differing_share=share, ms=t_k, plain_ms=t_p,
                           bound_ms=b_ms, bound_by=b_by)
            if not finite:
                raise RuntimeError(f"K4 {cdt}: non-finite output")
            if cdt == "float32" and err > TOL_SDDMM_F32:
                raise RuntimeError(f"K4 f32 disagrees with the plain version: {err}")
            if cdt == "bfloat16" and (err > TOL_SDDMM_BF16_MAX
                                      or share > TOL_SDDMM_BF16_SHARE):
                raise RuntimeError(f"K4 bf16 disagrees with the plain version: {k4[cdt]}")
        info["sddmm"] = k4
    info.update(tol_ell_sum_rel=TOL_ELL_SUM_REL, tol_sddmm_f32=TOL_SDDMM_F32,
                tol_sddmm_bf16_max=TOL_SDDMM_BF16_MAX,
                tol_sddmm_bf16_share=TOL_SDDMM_BF16_SHARE)
    del msg32
    torch.cuda.empty_cache()
    tc = times["check"]
    return {
        "ell_sum": dict(max_abs_err=worst["sum"], max_abs_err_mean=worst["mean"],
                        ms=tc["k3a_ms"], plain_ms=tc["plain_sum_ms"],
                        bound_ms=tc["bound_ms"], bound_by=tc["bound_by"],
                        library_ms=tc["index_add_ms"], library="index_add_"),
        "ell_max": dict(max_abs_err=worst["max"], ms=tc["k3b_ms"],
                        plain_ms=tc["plain_max_ms"], bound_ms=tc["bound_ms"],
                        bound_by=tc["bound_by"], library_ms=tc["scatter_amax_ms"],
                        library="scatter_reduce amax (include_self=False) + "
                                "where(isneginf, 0) fix-up of empty rows"),
        "sddmm_edge_hidden": dict(max_abs_err=k4["bfloat16"]["max_abs_err"],
                                  max_abs_err_f32=k4["float32"]["max_abs_err"],
                                  ms=k4["bfloat16"]["ms"], plain_ms=k4["bfloat16"]["plain_ms"],
                                  bound_ms=k4["bfloat16"]["bound_ms"],
                                  bound_by=k4["bfloat16"]["bound_by"], library_ms=None),
    }


def shot_decisions(model, dg, batch):
    """Per shot: the per-qubit head's failure and the logical head's class
    bits (the decisions a user reads)."""
    from tpugnn_torch.eval import count_failures, decode_corrections

    out = model(dg, batch.syndrome)
    fails = count_failures(dg, batch, *decode_corrections(out.qubit_logits),
                           out.logical_logits)
    return fails, out.logical_logits > 0


def profile_forward(model, dg, syn) -> dict:
    """One forward under torch.profiler: the device time of its kernels by
    kind, their sum, and the forward's wall time (host clock to a
    synchronise, profiler on)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model(dg, syn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds: dict = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        name = e.key.lower()
        kind = next((k for k, tags in (
            ("gemm", ("gemm",)), ("ell_reduce (K3a/K3b)", ("ell_reduce",)),
            ("concatenate", ("cat",)), ("gather", ("index", "gather")),
            ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))
            if any(t in name for t in tags)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    total = sum(kinds.values())
    return dict(kernel_ms=total, wall_ms=wall_ms,
                by_kind={k: dict(ms=v, share=v / total) for k, v in
                         sorted(kinds.items(), key=lambda kv: -kv[1])} if total else {})


def generic_gemm_flops(graph, batch: int, h: int, mh: int, rounds: int) -> float:
    """The GEMM operations of a generic forward with update='mlp': per round
    the two edge MLPs over all E_pad edges ([2H, MH] then [MH, H]) and the
    two update MLPs over all padded rows; embed and heads left out."""
    edges = 2 * graph.n_edges_pad * (2 * h * mh + mh * h)
    nodes = (graph.n_checks_pad * ((2 * h + 1) * h + h * h)
             + graph.n_qubits_pad * (2 * h * h + h * h))
    return 2.0 * batch * rounds * (edges + nodes)


def k3a_per_round_ms(ell_times: dict) -> float:
    """K3a's time for one round (both directions, f32 messages), from phase 8."""
    return ell_times["check"]["k3a_ms"] + ell_times["qubit"]["k3a_ms"]


def phase_generic_flagship(graph, dg, dev, trained, info: dict, ell_times: dict) -> dict:
    """Phase 9: the trained d=11 weights on the generic engine (pallas,
    f32, R=14).  Returns the launches of its LER run."""
    import torch

    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.models.convert import load_decoder, read_meta
    from tpugnn_torch.sampling import sample_batch

    cfg, model, _ = load_decoder(backend="pallas", device="cuda")
    rounds = cfg.model.rounds
    shots = LER_SHOTS
    reset_counts()
    gen = torch.Generator(device=dev).manual_seed(2025)      # phase 4's shots
    t0 = time.perf_counter()
    ev = ler_monte_carlo(model, graph, p=0.05, shots=shots, batch=B, generator=gen,
                         device="cuda")
    ler_s = time.perf_counter() - t0
    launched = counts()
    chunks = shots // B
    ref = read_meta()["ler_reference"]
    n = int(ev["shots"])
    z = {"logical_vs_jax_f32": z_score(ev["ler_logical"], n, ref["ler_logical"], ref["shots"]),
         "qubit_vs_jax_f32": z_score(ev["ler"], n, ref["ler"], ref["shots"])}
    # the same shots through the fused model of phase 4
    gen = torch.Generator(device=dev).manual_seed(2025)
    same = torch.zeros((), device=dev)
    with torch.inference_mode():
        for _ in range(chunks):
            b = sample_batch(gen, dg, 0.05, B)
            fg, lg = shot_decisions(model, dg, b)
            ff, lf = shot_decisions(trained, dg, b)
            same += ((fg["fail_qubit"] == ff["fail_qubit"]) & (lg == lf).all(-1)).sum()
        agree = float(same) / (chunks * B)
        syn = sample_batch(gen, dg, 0.05, B).syndrome
        fwd_ms = time_ms(lambda: model(dg, syn), warmup=2, iters=7)
        fused_ms = time_ms(lambda: trained(dg, syn), warmup=2, iters=7)
        breakdown = profile_forward(model, dg, syn)
    info.update(shots=n, ler_logical=ev["ler_logical"], ler_qubit=ev["ler"],
                ler_hybrid=ev["ler_hybrid"], z=z, ler_seconds=ler_s,
                jax_f32=dict(shots=ref["shots"], ler_logical=ref["ler_logical"],
                             ler_qubit=ref["ler"]),
                launches=launched, shot_agreement_with_fused=agree,
                min_shot_agreement=MIN_SHOT_AGREE, rounds=rounds,
                forward_ms=fwd_ms, fused_forward_ms=fused_ms,
                k3a_share=rounds * k3a_per_round_ms(ell_times) / fwd_ms,
                gemm_tflop=generic_gemm_flops(graph, B, 128, 128, rounds) / 1e12,
                edges_per_s=B * graph.n_edges * rounds / (fwd_ms / 1e3),
                forward_breakdown=breakdown)
    want = {"ell_sum": 2 * rounds * chunks, "fused_rounds": 0, "ell_max": 0}
    if any(launched[k] != v for k, v in want.items()):
        raise RuntimeError(f"generic LER launches {launched}, expected {want}")
    if any(abs(v) > 4 for v in z.values()):
        raise RuntimeError(f"generic LER off the JAX f32 reference: {info}")
    if agree < MIN_SHOT_AGREE:
        raise RuntimeError(f"generic decisions agree with the fused decode on only "
                           f"{agree} of the shots")
    del model
    torch.cuda.empty_cache()
    return launched


def phase_toric_and_random(graph, dg, dev, info: dict, ell_times: dict) -> dict:
    """Phase 10: the trained toric d=7 weights through the fused and the
    generic path; random-weight full-width generic forwards with max and
    mean against the plain versions; the bench config's generic forward.
    Returns the launches of each path."""
    import torch

    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.kernels import spmm
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.models.convert import TORIC_D7_WEIGHTS, load_decoder, read_meta
    from tpugnn_torch.sampling import sample_batch

    launched = {}
    shots = LER_SHOTS
    ref = read_meta(TORIC_D7_WEIGHTS)["ler_reference"]
    for backend in ("fused", "pallas"):
        cfg, model, tgraph = load_decoder(TORIC_D7_WEIGHTS, device="cuda", backend=backend)
        reset_counts()
        gen = torch.Generator(device=dev).manual_seed(2026)   # the same shots for both
        ev = ler_monte_carlo(model, tgraph, p=0.05, shots=shots, batch=B, generator=gen,
                             device="cuda")
        launched[f"toric_{backend}"] = counts()
        n = int(ev["shots"])
        z = {"logical_vs_jax_f32": z_score(ev["ler_logical"], n, ref["ler_logical"],
                                           ref["shots"]),
             "qubit_vs_jax_f32": z_score(ev["ler"], n, ref["ler"], ref["shots"]),
             "logical_vs_table": z_score(ev["ler_logical"], n, TORIC_REF_LER_LOGICAL,
                                         REF_SHOTS),
             "qubit_vs_table": z_score(ev["ler"], n, TORIC_REF_LER_QUBIT, REF_SHOTS)}
        info[backend] = dict(shots=n, ler_logical=ev["ler_logical"], ler_qubit=ev["ler"],
                             ler_hybrid=ev["ler_hybrid"], z=z,
                             launches=launched[f"toric_{backend}"])
        kernel = "fused_rounds" if backend == "fused" else "ell_sum"
        if launched[f"toric_{backend}"][kernel] < 1:
            raise RuntimeError(f"toric {backend}: {kernel} was not launched")
        if any(abs(z[k]) > 4 for k in ("logical_vs_jax_f32", "qubit_vs_jax_f32",
                                        "logical_vs_table")):
            raise RuntimeError(f"toric {backend} LER off the reference: {info[backend]}")
        del model
    info.update(jax_f32=dict(shots=ref["shots"], ler_logical=ref["ler_logical"],
                             ler_qubit=ref["ler"]),
                table=dict(shots=REF_SHOTS, ler_logical=TORIC_REF_LER_LOGICAL,
                           ler_qubit=TORIC_REF_LER_QUBIT))

    # random weights at full width: K3b (max) and K3a (mean) on the main
    # path's shapes against the same model on the plain versions
    rounds = 8
    gen = torch.Generator(device=dev).manual_seed(41)
    syn = sample_batch(gen, dg, 0.05, B).syndrome
    n = graph.n_qubits
    for aggr, kernel in (("max", "ell_max"), ("mean", "ell_sum")):
        model = GNNDecoder(ModelConfig(hidden=128, msg_hidden=128, rounds=rounds,
                                       backend="pallas", aggr=aggr, qubit_head="pauli4"), k=1)
        model = model.init_random(torch.Generator().manual_seed(17), bias_std=0.1)
        model = model.to(dev).eval()
        with torch.inference_mode():
            reset_counts()
            out_k = model(dg, syn)
            torch.cuda.synchronize()
            launched[f"random_{aggr}"] = counts()
            cuda_launch = spmm._ell_cuda
            spmm._ell_cuda = lambda m, e, k, a: spmm.PLAIN[a](m, e, k)
            try:
                out_p = model(dg, syn)
            finally:
                spmm._ell_cuda = cuda_launch
            agree = float((out_k.qubit_logits[:, :n].argmax(-1)
                           == out_p.qubit_logits[:, :n].argmax(-1)).float().mean())
            err = float((out_k.qubit_logits - out_p.qubit_logits).abs().max())
            finite = bool(torch.isfinite(out_k.qubit_logits).all()
                          and torch.isfinite(out_k.logical_logits).all())
            fwd_ms = time_ms(lambda: model(dg, syn), warmup=1, iters=5)
        info[f"random_{aggr}"] = dict(rounds=rounds, launches=launched[f"random_{aggr}"],
                                      agree=agree, min_agree=MIN_AGREE_F32,
                                      logits_max_abs_err=err, forward_ms=fwd_ms)
        if launched[f"random_{aggr}"][kernel] != 2 * rounds:
            raise RuntimeError(f"random {aggr}: {launched[f'random_{aggr}']}")
        if not finite or agree < MIN_AGREE_F32:
            raise RuntimeError(f"random {aggr}: kernels vs plain versions {info}")
        del model, out_k, out_p

    # the bench config (bf16, R=8, sum) on the generic engine: edges/s
    model = GNNDecoder(ModelConfig(hidden=128, msg_hidden=128, rounds=rounds,
                                   backend="pallas", qubit_head="pauli4", dtype="bfloat16"),
                       k=1)
    model = model.init_random(torch.Generator().manual_seed(13), bias_std=0.1).to(dev).eval()
    with torch.inference_mode():
        out = model(dg, syn)
        if not bool(torch.isfinite(out.qubit_logits).all()):
            raise RuntimeError("generic bench config: non-finite logits")
        bench_ms = time_ms(lambda: model(dg, syn), warmup=2, iters=7)
        breakdown = profile_forward(model, dg, syn)
    info["generic_bench"] = dict(rounds=rounds, dtype="bfloat16", forward_ms=bench_ms,
                                 forward_breakdown=breakdown,
                                 edges_per_s=B * graph.n_edges * rounds / (bench_ms / 1e3),
                                 k3a_share=rounds * k3a_per_round_ms(ell_times) / bench_ms)
    del model
    torch.cuda.empty_cache()
    return launched


def raster_errors(kc, kq, pc, pq) -> tuple[float, float]:
    """Max and mean abs difference over both sides' states."""
    import torch

    diff = torch.cat([(kc.float() - pc.float()).abs().flatten(),
                      (kq.float() - pq.float()).abs().flatten()])
    return float(diff.max()), float(diff.mean())


def phase_roll_gather(graph, dg, dev, trained, info: dict) -> tuple[dict, dict]:
    """Phase 11: K5 at the bench config against its plain version and K1,
    their times; the trained d=11 weights on the roll path.  Returns the
    launches of its LER run and the kernel-table row's numbers."""
    import torch

    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.models import GNNDecoder, PallasDecoder
    from tpugnn_torch.models.convert import read_meta
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.tanner import build_code

    h, rounds = 128, 8
    plan = rg.plan_for_graph(graph)
    if plan is None:
        raise RuntimeError("no raster plan for the d=11 surface code")
    ops = fd.make_operators(dg)
    real = lambda x, n: x[:, :n]

    # the bench config: phase 5's weights and states
    gen = torch.Generator(device=dev).manual_seed(5)
    model = GNNDecoder(ModelConfig(hidden=h, msg_hidden=h, rounds=rounds, backend="fused",
                                   qubit_head="pauli4", dtype="bfloat16"), k=1)
    model.init_random(torch.Generator().manual_seed(13), bias_std=0.1)
    w = fd.RoundWeights(*[t.detach() for t in model.to(dev).rounds.round_weights()])
    xc, xq, s = random_states(dg, B, h, gen)
    edges = B * graph.n_edges * rounds
    bench = {}
    with torch.inference_mode():
        r_ops = rg.to_raster(xc, xq, s, plan, w, "bfloat16")
        k1c, k1q = fd.decoder_rounds(xc, xq, s, ops, w, rounds, "bfloat16")
        for slot in ("float32", "bfloat16"):
            kc, kq = rg._roll_rounds_cuda(r_ops, rounds=rounds, slot_dtype=slot)
            pc, pq = rg.roll_rounds_plain(r_ops, rounds=rounds, slot_dtype=slot)
            torch.cuda.synchronize()
            max_err, mean_err = raster_errors(kc, kq, pc, pq)
            oc, oq = rg.from_raster(kc, kq, plan)
            k1_max, k1_mean = raster_errors(real(oc, graph.n_checks), real(oq, graph.n_qubits),
                                            real(k1c, graph.n_checks), real(k1q, graph.n_qubits))
            finite = bool(torch.isfinite(oc).all() and torch.isfinite(oq).all())
            del kc, kq, pc, pq, oc, oq
            k_ms = time_ms(lambda: rg._roll_rounds_cuda(r_ops, rounds=rounds, slot_dtype=slot))
            call_ms = time_ms(lambda: rg.decoder_rounds_roll(
                xc, xq, s, plan, w, rounds=rounds, state_dtype="bfloat16", slot_dtype=slot))
            p_ms = time_ms(lambda: rg.roll_rounds_plain(r_ops, rounds=rounds, slot_dtype=slot),
                           warmup=1, iters=5)
            bench[slot] = dict(max_abs_err=max_err, mean_abs_err=mean_err,
                               vs_k1_real_rows_max=k1_max, vs_k1_real_rows_mean=k1_mean,
                               kernel_ms=k_ms, call_ms=call_ms, plain_ms=p_ms,
                               edges_per_s=edges / (call_ms / 1e3),
                               edges_per_s_kernel=edges / (k_ms / 1e3))
            if not finite:
                raise RuntimeError(f"K5 slots {slot}: non-finite states")
            if max_err > TOL_BF16_MAX or mean_err > TOL_BF16_MEAN:
                raise RuntimeError(f"K5 slots {slot} disagrees with roll_rounds_plain: "
                                   f"{bench[slot]}")
            if k1_max > TOL_BF16_MAX or k1_mean > TOL_BF16_MEAN:
                raise RuntimeError(f"K5 slots {slot} disagrees with K1 on the real rows: "
                                   f"{bench[slot]}")
        k1_ms = time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, w, rounds, "bfloat16"))
    del r_ops, k1c, k1q
    flops = rounds_flops(graph, h) * B * rounds
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, rounds_bytes(graph, B, h, 2) / H100_HBM_BPS * 1e3
    info.update(batch=B, rounds=rounds, l_pad=plan.l_pad, raster_rows=2 * plan.l_pad,
                real_rows=graph.n_checks + graph.n_qubits, bench=bench, k1_ms=k1_ms,
                k1_edges_per_s=edges / (k1_ms / 1e3), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                tol_max=TOL_BF16_MAX, tol_mean=TOL_BF16_MEAN)

    # the trained d=11 weights through PallasDecoder on the roll path
    pd = PallasDecoder(trained, ("rollgather",))
    r_t = trained.cfg.rounds
    wt = fd.RoundWeights(*[t.detach() for t in trained.rounds.round_weights()])
    gen = torch.Generator(device=dev).manual_seed(6)
    xc, xq, s = random_states(dg, B, h, gen)
    with torch.inference_mode():
        t_ops_r = rg.to_raster(xc, xq, s, plan, wt, "float32")
        kc, kq = rg._roll_rounds_cuda(t_ops_r, rounds=r_t)
        pc, pq = rg.roll_rounds_plain(t_ops_r, rounds=r_t)
        torch.cuda.synchronize()
        f32_max, f32_mean = raster_errors(kc, kq, pc, pq)
        del t_ops_r, kc, kq, pc, pq
    if f32_max > TOL_F32:
        raise RuntimeError(f"K5 f32 (trained weights, R={r_t}) disagrees with "
                           f"roll_rounds_plain: max {f32_max}")
    reset_counts()
    gen = torch.Generator(device=dev).manual_seed(2025)      # phase 4's shots
    t0 = time.perf_counter()
    ev = ler_monte_carlo(pd, graph, p=0.05, shots=LER_SHOTS, batch=B, generator=gen,
                         device="cuda")
    ler_s = time.perf_counter() - t0
    launched = counts()
    chunks = LER_SHOTS // B
    ref = read_meta()["ler_reference"]
    n = int(ev["shots"])
    z = {"logical_vs_jax_f32": z_score(ev["ler_logical"], n, ref["ler_logical"], ref["shots"]),
         "qubit_vs_jax_f32": z_score(ev["ler"], n, ref["ler"], ref["shots"])}
    gen = torch.Generator(device=dev).manual_seed(2025)
    same = torch.zeros((), device=dev)
    with torch.inference_mode():
        for _ in range(chunks):
            b = sample_batch(gen, dg, 0.05, B)
            fr, lr = shot_decisions(pd, dg, b)
            ff, lf = shot_decisions(trained, dg, b)
            same += ((fr["fail_qubit"] == ff["fail_qubit"]) & (lr == lf).all(-1)).sum()
        agree = float(same) / (chunks * B)
        syn = sample_batch(gen, dg, 0.05, B).syndrome
        fwd_ms = time_ms(lambda: pd(dg, syn), warmup=2, iters=7)
        fused_ms = time_ms(lambda: trained(dg, syn), warmup=2, iters=7)
        # d=13's raster in f32 does not fit in shared memory: refused, not launched
        g13 = build_code("surface", 13)
        z13 = torch.zeros((1, g13.n_checks_pad, h), device=dev)
        zq13 = torch.zeros((1, g13.n_qubits_pad, h), device=dev)
        before = rg.launch_counts()["roll_rounds"]
        try:
            rg._roll_rounds_cuda(rg.to_raster(z13, zq13, z13[..., :1], rg.plan_for_graph(g13),
                                              wt, "float32"), rounds=1)
            refused = None
        except ValueError as e:
            refused = str(e)
        if refused is None or rg.launch_counts()["roll_rounds"] != before:
            raise RuntimeError("K5 took d=13 in f32, whose raster exceeds shared memory")
    info["trained"] = dict(
        rounds=r_t, k5_vs_plain_f32_max=f32_max, k5_vs_plain_f32_mean=f32_mean,
        tol_f32=TOL_F32, shots=n, ler_logical=ev["ler_logical"], ler_qubit=ev["ler"],
        ler_hybrid=ev["ler_hybrid"], z=z, ler_seconds=ler_s,
        jax_f32=dict(shots=ref["shots"], ler_logical=ref["ler_logical"], ler_qubit=ref["ler"]),
        launches=launched, shot_agreement_with_fused=agree, min_shot_agreement=MIN_SHOT_AGREE,
        forward_ms=fwd_ms, fused_forward_ms=fused_ms,
        edges_per_s=B * graph.n_edges * r_t / (fwd_ms / 1e3), d13_f32_refused=refused)
    want = {"roll_rounds": chunks, "fused_rounds": 0, "ell_sum": 0, "ell_max": 0}
    if any(launched[k] != v for k, v in want.items()):
        raise RuntimeError(f"roll LER launches {launched}, expected {want}")
    if any(abs(v) > 4 for v in z.values()):
        raise RuntimeError(f"roll LER off the JAX f32 reference: {info['trained']}")
    if agree < MIN_SHOT_AGREE:
        raise RuntimeError(f"roll decisions agree with the fused decode on only {agree} "
                           "of the shots")
    torch.cuda.empty_cache()
    f32s, s16 = bench["float32"], bench["bfloat16"]
    row = dict(max_abs_err=f32s["max_abs_err"], max_abs_err_slot16=s16["max_abs_err"],
               max_abs_err_f32=f32_max, ms=f32s["kernel_ms"], ms_slot16=s16["kernel_ms"],
               plain_ms=f32s["plain_ms"], plain_ms_slot16=s16["plain_ms"],
               bound_ms=info["bound_ms"], bound_by=info["bound_by"], library_ms=None,
               yardstick_ms=k1_ms, yardstick="K1 (fused_rounds) on the same inputs")
    return launched, row


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
                                           backend="fused", qubit_head="pauli4",
                                           dtype=dtype), k=1)
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
        # d=13 in bf16: 176-row sides, a whole 128-row chunk and a ragged one
        g13, dg13, ops13, w13, xc, xq, s, _ = random_round_case(
            13, D13_BATCH, D13_ROUNDS, "bfloat16", 12, dev)
        with torch.inference_mode():
            kc, kq = fd.decoder_rounds(xc, xq, s, ops13, w13, D13_ROUNDS, "bfloat16")
            pc, pq = fd.rounds_plain(xc, xq, s, ops13, w13, rounds=D13_ROUNDS,
                                     state_dtype="bfloat16")
            torch.cuda.synchronize()
            diff = torch.cat([(kc - pc).abs().flatten(), (kq - pq).abs().flatten()])
            finite = bool(torch.isfinite(kc).all() and torch.isfinite(kq).all())
        info["d13_bfloat16"] = dict(batch=D13_BATCH, rounds=D13_ROUNDS, rows=g13.n_checks_pad,
                                    max_abs_err=float(diff.max()),
                                    mean_abs_err=float(diff.mean()),
                                    tol_max=TOL_BF16_MAX, tol_mean=TOL_BF16_MEAN)
        if not finite or float(diff.max()) > TOL_BF16_MAX or float(diff.mean()) > TOL_BF16_MEAN:
            raise RuntimeError(f"d=13 bf16: kernel disagrees with rounds_plain: "
                               f"{info['d13_bfloat16']}")
        del kc, kq, pc, pq, diff

    launches = {}
    with Phase("serve") as info:
        reset_counts()
        eng = DecodeEngine.from_npz(device="cuda", max_batch=B)
        gen = torch.Generator(device=dev).manual_seed(2024)
        syn = sample_batch(gen, dg, 0.05, 6001).syndrome.cpu().numpy().astype("uint8")
        reqs = [syn[:1], syn[1:1001, :graph.n_checks], syn[1001:6001]]
        outs, request_ms = [], []
        for r in reqs:            # decode() returns host arrays: it has synced
            t0 = time.perf_counter()
            outs.append(eng.decode(r))
            request_ms.append((time.perf_counter() - t0) * 1e3)
        launches["serve"] = counts()
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
        if launches["serve"]["fused_rounds"] < 1:
            raise RuntimeError("the serve path did not launch the kernel")
        info.update(requests=[int(r.shape[0]) for r in reqs],
                    widths=[int(r.shape[1]) for r in reqs], request_ms=request_ms,
                    launches=launches["serve"])

    with Phase("ler") as info:
        reset_counts()
        gen = torch.Generator(device=dev).manual_seed(2025)
        ev = ler_monte_carlo(eng.model, graph, p=0.05, shots=LER_SHOTS, batch=B,
                             generator=gen, device="cuda")
        launches["ler"] = counts()
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
        if launches["ler"]["fused_rounds"] < 1:
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
                                       backend="fused", qubit_head="pauli4",
                                       dtype="bfloat16"), k=1)
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
                    kernel_tflops=flops / (k_ms * 1e-3) / 1e12,
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
                                           backend="fused", qubit_head="pauli4",
                                           dtype=dtype), k=1)
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
                again = fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dtype)
                pg = fb.rounds_vjp_plain(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q,
                                         state_dtype=dtype)
                torch.cuda.synchronize()
                repeatable = all(torch.equal(a_, b_) for a_, b_ in zip(kg, again))
                del again
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
                rounds=rounds, batch=B, k2a_equals_k1=same_as_k1, k2b_repeatable=repeatable,
                k2a_vs_plain_max=float(out_diff.max()), k2a_vs_plain_mean=float(out_diff.mean()),
                stash_vs_plain_max=st_max, stash_vs_plain_mean=st_sum / st_n,
                k2b_max_abs_err=grad_max, k2b_worst_rel=rels[worst], k2b_worst_leaf=worst,
                k2b_rel=rels, tol_rel=tol_rel, tol_max=tol_max, tol_mean=tol_mean)
            train_errs[dtype] = info[dtype]
            if not finite:
                raise RuntimeError(f"{dtype}: K2a/K2b produced non-finite values")
            if not same_as_k1:
                raise RuntimeError(f"{dtype}: K2a's outputs differ from K1's")
            if not repeatable:
                raise RuntimeError(f"{dtype}: K2b's gradients differ between two runs on "
                                   f"the same inputs")
            if (float(out_diff.max()) > tol_max or float(out_diff.mean()) > tol_mean
                    or st_max > tol_max or st_sum / st_n > tol_mean):
                raise RuntimeError(f"{dtype}: K2a disagrees with rounds_fwd_stash_plain: "
                                   f"{info[dtype]}")
            if rels[worst] > tol_rel:
                raise RuntimeError(f"{dtype}: K2b disagrees with rounds_vjp_plain on "
                                   f"{worst}: {info[dtype]}")
            del kc, kq, sc, sq, pc, pq, psc, psq, kg, pg, out_diff
            torch.cuda.empty_cache()

        # d=13 in bf16 (a ragged second chunk per side): K2a equal to K1, its
        # stash and outputs and K2b's gradients against the plain versions
        _, _, ops13, w13, xc, xq, s, gen = random_round_case(
            13, D13_BATCH, D13_ROUNDS, "bfloat16", 15, dev)
        mats32, vecs32 = fd.pack_weights_f32(w13)
        cot_c = torch.randn(xc.shape, generator=gen, device=dev)
        cot_q = torch.randn(xq.shape, generator=gen, device=dev)
        with torch.no_grad():
            k1c, k1q = fd.decoder_rounds(xc, xq, s, ops13, w13, D13_ROUNDS, "bfloat16")
            kc, kq, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops13, mats32, vecs32, D13_ROUNDS,
                                                "bfloat16")
            pc, pq, psc, psq = fb.rounds_fwd_stash_plain(
                xc, xq, s, ops13, mats32, vecs32, rounds=D13_ROUNDS, state_dtype="bfloat16")
            kg = fb._bwd_cuda(sc, sq, s, ops13, mats32, vecs32, cot_c, cot_q, "bfloat16")
            pg = fb.rounds_vjp_plain(sc, sq, s, ops13, mats32, vecs32, cot_c, cot_q,
                                     state_dtype="bfloat16")
            torch.cuda.synchronize()
            same_as_k1 = bool(torch.equal(kc, k1c) and torch.equal(kq, k1q))
            out_diff = torch.cat([(kc - pc).abs().flatten(), (kq - pq).abs().flatten()])
            st_diff = torch.cat([(sc.float() - psc.float()).abs().flatten(),
                                 (sq.float() - psq.float()).abs().flatten()])
            finite = all(bool(torch.isfinite(t).all()) for t in (kc, kq, *kg))
        rels = grad_errors(w13, kg, pg)
        worst = max(rels, key=rels.get)
        info["d13_bfloat16"] = dict(
            batch=D13_BATCH, rounds=D13_ROUNDS, k2a_equals_k1=same_as_k1,
            k2a_vs_plain_max=float(out_diff.max()), k2a_vs_plain_mean=float(out_diff.mean()),
            stash_vs_plain_max=float(st_diff.max()), stash_vs_plain_mean=float(st_diff.mean()),
            k2b_worst_rel=rels[worst], k2b_worst_leaf=worst, tol_rel=TOL_GRAD_REL_BF16)
        if not finite or not same_as_k1:
            raise RuntimeError(f"d=13 bf16: K2a/K2b non-finite or K2a differs from K1: "
                               f"{info['d13_bfloat16']}")
        if (float(out_diff.max()) > TOL_BF16_MAX or float(out_diff.mean()) > TOL_BF16_MEAN
                or float(st_diff.max()) > TOL_BF16_MAX or float(st_diff.mean()) > TOL_BF16_MEAN
                or rels[worst] > TOL_GRAD_REL_BF16):
            raise RuntimeError(f"d=13 bf16: K2a or K2b disagrees with its plain version: "
                               f"{info['d13_bfloat16']}")
        del kc, kq, sc, sq, pc, pq, psc, psq, kg, pg, out_diff, st_diff

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

        reset_counts()
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
        launches["train"] = counts()
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

        step_errs = train_steps_vs_plain(state, flagship_train_config(TRAIN_STEPS, ckpt_dir),
                                         dg, dev)
        k_worst = [max(e.items(), key=lambda kv: kv[1]) for e in step_errs["kernels"]]
        z_least = [min(((n, v) for n, v in e.items() if n.startswith("rounds.")),
                       key=lambda kv: kv[1]) for e in step_errs["zero_wgrads"]]
        info["steps_vs_plain"] = dict(
            steps=TRAIN_CHECK_STEPS, bound=TRAIN_STEP_REL,
            kernels_worst=[dict(leaf=n, rel=v) for n, v in k_worst],
            zero_wgrads_least=[dict(leaf=n, rel=v) for n, v in z_least],
            kernels_rel=step_errs["kernels"][-1])
        if any(v > TRAIN_STEP_REL for _, v in k_worst):
            raise RuntimeError(f"train: steps through K2a/K2b move the parameters otherwise "
                               f"than their plain versions: {info['steps_vs_plain']}")

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
            k2a_tflops=t_ops_a * 1e-3 * H100_BF16_FLOPS / (k2a_ms * 1e-3) / 1e12,
            k2b_tflops=t_ops_b * 1e-3 * H100_BF16_FLOPS / (k2b_ms * 1e-3) / 1e12,
            k2a_f32_core_ms=t_ops_a * H100_BF16_FLOPS / H100_F32_FLOPS,
            k2b_f32_core_ms=t_ops_b * H100_BF16_FLOPS / H100_F32_FLOPS,
            rounds_share_of_step=(k2a_ms + k2b_ms) / statistics.median(step_ms),
            yardstick_rounds=y_rounds, yardstick_step_ms=y_step_ms,
            yardstick_fwd_ms=y_fwd_ms, yardstick_bwd_ms=y_step_ms - y_fwd_ms,
            yardstick_peak_gb=y_peak_gb)
        train_timing = dict(info)
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    with Phase("spmm_sddmm_vs_plain") as info:
        new_kernels = phase_spmm_sddmm(graph, dg, dev, info)
        ell_times = info["ell_times"]

    with Phase("generic_flagship") as info:
        launches["generic_ler"] = phase_generic_flagship(graph, dg, dev, trained, info,
                                                         ell_times)

    with Phase("toric_d7_and_generic_random") as info:
        launches.update(phase_toric_and_random(graph, dg, dev, info, ell_times))

    with Phase("roll_gather") as info:
        launches["roll_ler"], roll_row = phase_roll_gather(graph, dg, dev, trained, info)
    del trained

    def by_path(kernel):
        return {p: c[kernel] for p, c in launches.items() if c[kernel]}

    def row(name, **kw):
        paths = by_path(name)
        return {"name": name, "route": "cuda", "launches": sum(paths.values()),
                "launches_by_path": paths, **kw}

    emit({"kernels": [row(
        "fused_rounds",
        source="tpugnn_torch/kernels/csrc/fused_rounds.cu",
        replaces="tpugnn/kernels/fused_decoder.py:637",
        max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
        ms=timing["kernel_ms"], plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
        library_ms=None, yardstick_ms=timing["yardstick_ms"],
    ), row(
        "fused_rounds_fwd_stash",
        source="tpugnn_torch/kernels/csrc/fused_rounds.cu",
        replaces="tpugnn/kernels/fused_backward.py:575",
        max_abs_err=train_errs["bfloat16"]["k2a_vs_plain_max"],
        max_abs_err_f32=train_errs["float32"]["k2a_vs_plain_max"],
        ms=train_timing["k2a_ms"], plain_ms=train_timing["plain_fwd_stash_ms"],
        bound_ms=train_timing["k2a_bound_ms"], bound_by=train_timing["k2a_bound_by"],
        library_ms=None, yardstick_ms=train_timing["yardstick_fwd_ms"],
    ), row(
        "fused_rounds_bwd",
        source="tpugnn_torch/kernels/csrc/fused_backward.cu",
        replaces="tpugnn/kernels/fused_backward.py:624",
        max_abs_err=train_errs["bfloat16"]["k2b_max_abs_err"],
        max_rel_err=train_errs["bfloat16"]["k2b_worst_rel"],
        max_rel_err_f32=train_errs["float32"]["k2b_worst_rel"],
        ms=train_timing["k2b_ms"], plain_ms=train_timing["plain_vjp_ms"],
        bound_ms=train_timing["k2b_bound_ms"], bound_by=train_timing["k2b_bound_by"],
        library_ms=None, yardstick_ms=train_timing["yardstick_bwd_ms"],
    ), row(
        "ell_sum", source="tpugnn_torch/kernels/csrc/spmm.cu",
        replaces="tpugnn/kernels/spmm.py:79", **new_kernels["ell_sum"],
    ), row(
        "ell_max", source="tpugnn_torch/kernels/csrc/spmm.cu",
        replaces="tpugnn/kernels/spmm.py:129", **new_kernels["ell_max"],
    ), row(
        "sddmm_edge_hidden", source="tpugnn_torch/kernels/csrc/sddmm.cu",
        replaces="tpugnn/kernels/sddmm.py:100", on_main_path=False,
        **new_kernels["sddmm_edge_hidden"],
    ), row(
        "roll_rounds", source="tpugnn_torch/kernels/csrc/roll_gather.cu",
        replaces="tpugnn/kernels/roll_gather.py:364", **roll_row,
    )]})
    emit({"total_seconds": round(time.perf_counter() - t_start, 3)})
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0].strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
