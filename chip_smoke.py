#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpugnn_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's decode path on the card and checks it, in phases that each
print one JSON line with their wall time:

  0 environment: torch, nvcc and the card's name and power limit
  1 build: the CUDA kernels from the sources in the checkout (one nvcc per
    source, all eight started together -> .so), and beside them the host
    decoders' library from csrc/ (g++)
  2 kernel vs plain: the fused-rounds kernel (K1 at W = 128) against
    rounds_plain on the card at the main path's shapes, d=11, H=128, B=4096
    (R=8 bf16 and R=14 f32), and at d=13 in bf16 (B=64, R=3: 176-row sides),
    with stated tolerances; at d=13 and d=15 in f32 (B=64, R=3); models of
    width 64 and 96 (d=11, B=64, R=3, both state types) on the kernel's 128
    columns, zero-padded; each case must launch K1 once and nothing else.
    In f32 (d=11, R=14) the kernel and the plain version are also held to
    the same rounds in f64 (rounds_f64), the kernel's max error there gated
    at TOL_F32; and cuobjdump -sass must find HGMMA (wgmma) instructions in
    every f32 W = 128 instantiation (K1's and K2a's kernel, K2b's four): the
    f32 path runs on tensor cores (3xTF32)
  3 serve: a DecodeEngine on the trained d=11 weights answers requests of
    1, 1000 and 5000 syndromes; outputs equal the model's direct decode;
    then an engine per cleanup mode (uf, mwpm, best_of with both cost
    rules, eager and lazy, device, best_of_device) answers the same
    requests: every output syndrome-consistent, every request one K1
    launch per chunk and nothing else, uf/mwpm equal to
    gnn_cleanup_corrections and eager best_of to min_weight_select over
    eval/hybrid's candidates bit for bit, lazy best_of never lighter than
    eager, best_of_device's mean weight within 1.25 of best_of's, device
    with no host decoder call and its repair on the card; each mode's
    shots/s on 4096-syndrome requests and on one 4 x 4096 request with the
    host tail's and the device span's share, and DeviceRepair's ms per
    4096-shot chunk
  4 LER: ler_monte_carlo of the trained weights at p=0.05 on 65,536 shots,
    z-scores against the JAX package's own f32 LER recorded in the weights
    file (both heads gated at |z| <= 4) and against benchmarks/LER_TABLE.md:30
    (logical head gated at |z| <= 4; per-qubit head reported, see below)
  4b checkpoints: every surface-code checkpoint of benchmarks/LER_TABLE.md
    (d=3, 5, 7, 9, 11, 13, 15; tpugnn_torch/assets/) through
    DecodeEngine.from_npz and ler_monte_carlo at p=0.05 (32,768 shots,
    f32; d=11 is phase 4's run): each must launch K1 (at d=3 and d=5 on
    padded widths) and nothing else, both heads gated at |z| <= 4 against
    the JAX f32 rate in its
    weights file; the logical, hybrid and per-qubit z against the table's
    p=0.05 row reported beside the 2-stderr criterion, not gated (the table
    was taken on a TPU at one bf16 pass); the decode ms of one 4096-shot
    forward; at d=13 and d=15 the roll path (K5's f32 kernel: at d=13 its
    shared-panel one, at d=15 its global-panel variant) on 8,192 of the
    same shots, its per-shot decisions against the fused path's (>= 99.9%
    equal)
  4c hybrid: ler_all_columns of the trained d=11 weights at p=0.05 on
    phase 4's 65,536 shots (same seed; B=4096, f32) with best-of, GNN+MWPM
    and the raw union-find and MWPM baselines: ler, ler_logical and
    ler_hybrid equal phase 4's exactly; GNN+UF, GNN+MWPM and best-of
    within |z| <= 4 of the JAX f32 columns in the weights file's sidecar;
    raw union-find and MWPM within |z| <= 4 of benchmarks/LER_TABLE.md:30;
    no cleanup column leaves a syndrome; 16 K1 launches and nothing else;
    every column's z against the table's row reported beside the 2-stderr
    criterion, with the host's and the device's seconds
  4d detector_and_stream: the detector-graph path.  The d=5 decoder over 5
    noisy rounds (spacetime_surface_d5_t5_h96_r8_4000.npz: M=64, N=176,
    Dc=6, Dq=2, H=96 padded, f32) through ler_all_columns at p=0.02 on
    65,536 shots: every GNN column within |z| <= 4 of the JAX f32 columns
    of its sidecar, raw union-find and MWPM within |z| <= 4 of
    benchmarks/LER_DETECTOR.md:41, no syndrome left, 16 K1 launches; K1
    held to its plain version on that graph (B=4096, R=8) and timed.
    BP+OSD-0 at p=0.05 on 32,768 shots at d=11 and d=5 within |z| <= 4 of
    LER_TABLE.md:26 and :14, no syndrome left; plain BP beside it, BP's ms
    a chunk on the card, the OSD's median on the host.  The window decoder
    (..._d5_t5_w_...) on the numpy streams of its sidecar, which are those
    of runs/stream_quality_w.json's d=5 p=0.02 row (window 5, commit 1, 11
    rounds, seed 11, 10,000 shots), with the five decoders of
    benchmarks/stream_quality.py: union-find windowed and monolithic equal
    to the JAX rates exactly, the GNN adapters (raw with deferral,
    union-find cleanup, device repair) within 5 failing shots of the JAX
    f32 counts on the same streams, one K1 launch per GNN window; ms per
    window and committed rounds/s
  4e circuit_and_cli: circuit-level detector graphs and the command line.
    The five circuit checkpoints of benchmarks/LER_DETECTOR.md's [nll]
    rows (circuit_surface_*.npz: d=3, 5 in both sectors and d=7, H=128,
    R=8, bits) decoded in f32 at p=0.01 on 32,768 shots each, on the graph
    their record names (d=3: M=16, N=56, Dc=10 in z and 11 in x; d=5:
    64, 304, 14; d=7: 176, 920, 14): both heads within |z| <= 4 of the JAX
    f32 rate in the weights file, K1 once a chunk and nothing else, every
    head's z against
    the table's row reported; d=5 z through ler_all_columns with the NLL
    rule, every GNN column within |z| <= 4 of its sidecar's JAX f32
    columns, raw union-find and MWPM of LER_DETECTOR.md:35, no syndrome
    left; K1 on each graph held to its plain version (B=4096, R=8) and
    timed beside its bound.  Then `python -m tpugnn_torch.cli train` through
    its main: the circuit d=5 training config (bf16, B=4096, p-mix
    0.004..0.015, K2a/K2b) for 20 steps, a finite, falling loss and one K2a
    and one K2b launch a step; K1, K2a and K2b in bf16 on that graph against
    their plain versions (B=64, R=3) and timed (B=4096, R=8); f32 K1, K2a
    and K2b on the trained circuit d=5 and d=7 checkpoints against their
    plain versions (B=64, R=3: K2b's every leaf within TOL_GRAD_REL_F32, the
    graphs where its tie re-decisions sum a row's 10 to 14 slots); one step
    through them against their plain versions; the CLI's default training
    (generic 'segment', d=5,
    H=128, B=256) for 20 steps, a falling loss, one step's gradients on the
    card against the CPU's; `cli eval` and `cli serve` on the d=5 weights
    file with --cleanup mwpm
  4g circuit_d7_bfloat16: the circuit d=7 checkpoint in bf16, the state
    type it was trained in.  On the trained weights (B=64, R=3) K1, K2a and
    K2b against their plain versions (K2a equal to K1, K2b every leaf and
    twice bit-equal); K1, K2a and K2b timed at B=4096, R=8 beside
    their bounds and plain versions; `cli eval --dtype bfloat16` on the
    weights file at p=0.01 on 32,768 shots, both heads within |z| <= 4 of
    the JAX f32 rate in the file, its z against LER_DETECTOR.md:43
    reported, K1 once a chunk and nothing else;
    DecodeEngine.from_npz(dtype='bfloat16') serving a request; `cli train`
    at the checkpoint's settings (scripts/tpu_queue_r5a.sh:104-108: bf16,
    B=4096, p-mix 0.004..0.015, lr 1e-3, EMA 0.999) for 10 steps, a finite,
    falling loss and one K2a and K2b launch a step; HGMMA in every bf16
    W = 128 instantiation
  4f dist: graph- and data-parallel decoding and training on
    torch.distributed (tpugnn_torch/dist/) on the one card, each part in
    turn, so that nothing else runs on the card beside it.  (a) NCCL at
    world size 1 in this process: the d=15 weights' sharded apply at P=1
    against the unsharded generic forward (1e-4, index_add_ deterministic
    in both).  (b) The d=15 checkpoint
    (surface_d15_h128_r14_ema8000.npz, generic 'segment' rounds, f32)
    sharded over P=4 gloo ranks that time-share the card, their exchanges
    staged through the host: ler_monte_carlo of make_sharded_apply at
    p=0.05 on 8,192 shots (chunks of 1024), both heads within |z| <= 4 of the
    JAX f32 rate in the weights file, >= 99.9% of the shots decided as the
    unsharded generic path and as K1 on the same shots, the
    logits within 1e-3 of the generic path's; the ring and gather exchanges
    against alltoall (a chunk's exchange buffers bit for bit, the logits of
    the first 128 shots within 1e-4, index_add_ deterministic) and the bf16
    and int8 wires against f32 on those shots (>= 99.5% of per-qubit
    decisions).  (c) make_sharded_train_step on a data=2 x graph=2
    mesh at the CLI's generic defaults (surface d=5, H=128, R=8, B=256,
    f32): its first gradients against the unsharded step on the card (phase
    4e's 2e-3 whole and 3e-3 worst leaf), a finite, falling loss over 10
    steps, and two int8 steps that move the parameters by more than 0.3 of
    two f32 steps'.  (d) dryrun's body (one sharded train step at d=5,
    H=16) on the same 4 ranks, not a second launch: every rank's loss the
    same, within dryrun's own 1e-6 relative test.  (e)
    Reported, labelled as ranks time-sharing one card: the sharded, the
    unsharded generic and K1's ms a chunk, the exchange's bytes and ms a
    round for each halo mode and wire type, and the bytes staged through
    the host
  5 timing: the bench config (d=11, B=4096, R=8, H=128, bf16) with CUDA
    events: the kernel's step and its TFLOP/s beside its bound and the f32
    CUDA-core floor, rounds_plain, and an index_select + index_add_ round
    loop as the yardstick; the trained config's f32 K1 (B=4096, R=14) and
    K1 at d=13 and d=15 (B=4096, R=14, f32) against
    its plain version, with its time, the plain version's and its bound;
    K1 and K5 at d=3 with H=64 and at d=5 with H=96 (padded) beside a
    128-wide model on the same graph.  Every f32 K1 and K5 time (here and
    in phases 4d, 4e and 11) has its 3xTF32 floor beside the f32 CUDA-core
    one: three TF32 products for each f32 one at 495 TFLOP/s
  6 training kernels vs plain: at the flagship training shapes (d=11, H=128,
    R=14, B=4096) in bf16 and in f32, K2a's outputs against K1's (the same
    kernel with its stash flag: bit-equal in both state types), its stash
    against rounds_fwd_stash_plain, and K2b's gradients (states, syndrome and
    every weight leaf) against rounds_vjp_plain fed the same stash, with
    stated tolerances; K2b twice on the same inputs, bit-equal; in f32 one
    K2a and one K2b call timed beside their bounds (K2a 3xTF32 with its
    stash, K2b at the f32 CUDA-core peak); the same checks at d=13 in bf16
    (B=64, R=3); a model of width 64 (padded to 128) in both state types
    (d=11, B=64, R=3): K2a's outputs against the plain version's and every
    gradient leaf at width 64 of K2b against rounds_vjp_plain, both fed
    K2a's stash; the whole path (kernels under autograd against the plain
    versions under autograd) gated in bf16 and reported in f32, where a
    relu that K2a's rounding flips decides a whole autograd path; and two
    train steps from a 10-step run through K2a/K2b against the plain
    versions
  6b f32_training_past_smem: f32 training on the larger graphs (surface
    d=13, circuit d=5).  At d=13 (B=64,
    R=3) K1, K2a and K2b each once: K2a equal to K1, its outputs and stash
    within TOL_F32 of rounds_fwd_stash_plain, K2b's every leaf within
    TOL_GRAD_REL_F32 of rounds_vjp_plain on the same stash and twice
    bit-equal; K2a and K2b timed at d=13, B=4096, R=14 beside their 3xTF32
    bounds and plain versions; `cli train` on the circuit d=5 graph in f32
    (B=512, 10 steps): a finite, falling loss, one K2a and K2b launch a
    step, one step against the plain versions (TRAIN_STEP_REL)
  6c fused_configs: the fused backend at H=64, MH=96 (K1 against
    rounds_plain in both state types; K2a/K2b and two train steps against
    the plain versions in f32; the model's decode, one K1 launch, against
    its plain rounds) and with per-round weights (d=5, R=3: the forward
    launches K1 R times, the backward K2a and K2b R times each; against
    the plain rounds)
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
    function (index_add_, scatter_reduce amax).  K4 runs both directions,
    with the states in the compute type; each call must launch the
    tensor-core kernel in bf16 and the FMA kernel in f32; bf16 twice on the
    same inputs, bit-equal; bf16 at d=13 and d=15 (B=64, both directions:
    larger panels, d=15's rounded up to 16-row groups) against the plain
    version; cuobjdump -sass must find HMMA in its tensor-core kernel and
    none in its FMA kernels; its time in bf16 and f32 (one call on f32
    states, the wrapper's cast inside, as the other kernels are timed; per
    call over 8 back-to-back calls on compute-type states beside it), bound
    and achieved GB/s
  9 generic flagship: the trained d=11 weights on the generic engine
    (load_decoder(backend='pallas'), f32, R=14): LER at p=0.05 on 32,768 of
    phase 4's shots, both heads gated at |z| <= 4 against the JAX f32 rate;
    per-shot decisions against phase 4's fused decode (>= 99.9% equal);
    2 R K3a launches per chunk and no K1; the forward's time and K3a's share
 10 toric d=7: the trained toric weights through the fused path (K1) and
    the generic path (K3a), LER at p=0.05 on 32,768 shots, both heads gated
    at |z| <= 4 against the JAX f32 rate and the logical head against
    benchmarks/LER_TORIC.md:18; then random-weight full-width generic
    forwards (d=11, H=128, B=4096, R=8) with aggr max (K3b) and mean (K3a)
    against the same model on the plain versions, and the bench config's
    generic forward (bf16, sum) for its edges/s
 11 roll gather: K5 (the rounds on the surface code's raster) at the bench
    config with f32 slots and with slot16 against roll_rounds_plain on the
    card (every raster cell) and against K1 on the real rows, with stated
    tolerances, and twice on the same inputs, bit-equal; its time and
    TFLOP/s beside its bound and the f32 CUDA-core floor, its plain
    version's time and K1's on the same inputs, and edges/s of both
    schedules; its bf16 instantiation at d=13 (both slot modes: a 144-row
    chunk and a 56-row tail) and d=15 (f32 slots: 144 + 112 rows, 32-row
    weight slabs) against roll_rounds_plain (B=64, R=3); the HMMA
    instructions of each of its kernels (cuobjdump -sass: the bf16 ones and
    both f32 (3xTF32) placements run on tensor cores, each gated; fails
    where the toolkit has no cuobjdump) and the shared memory of each
    raster; then the trained d=11 weights
    through PallasDecoder(schedule=('rollgather',)) (f32, R=14): K5's
    shared-panel f32 kernel against the plain version (TOL_F32) and, on the
    real rows, against the same rounds in f64 (rounds_f64, gated at
    K1_F64_RATIO times the plain version's distance), its time beside its
    3xTF32 bound and the plain version's (the kernel the main path
    launches), LER at p=0.05 on 32,768 of
    phase 4's shots (both heads gated at |z| <= 4 against the JAX f32 rate),
    per-shot decisions against phase 4's fused decode (>= 99.9% equal), one
    K5 launch per chunk and no K1, the forward's time; K5 in f32 at d=13
    (its panel in shared memory) and d=15 (its global-panel variant)
    against the plain version (B=64, R=3) and timed (B=4096, R=14),
    K5 at widths 64 and 96 in both state types (d=11, B=64, R=3); and the
    refusal of a width-160 model by K5's and K1's wrappers, before a launch

Phases 3 (each engine's requests), 4, 4b, 4c, 4d (the monolithic decode
and the streams), 4e (each circuit decode and each CLI run), 4g (the CLI's
eval and train and the engine's request), 4f (the K1
reference decodes beside the sharded ones, which launch no kernel), 6b (the
CLI's f32 circuit training), 6c (each model's decode and backward), 7, 9,
10 and 11 are the main paths; the launch counts of every kernel are reset before
and read after each.  Then it prints the kernel
table as one JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any
failure raises and exits nonzero.  It exits nonzero without printing a result
when there is no CUDA device or when run outside the repository.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASE_LIMIT_S = 180       # a phase that runs longer is taken for a hang
D = 11                    # surface-code distance of the main path
B = 4096                  # the main path's batch (serve microbatch, LER chunk)
LER_SHOTS = 65536         # Monte-Carlo shots of the d=11 LER and hybrid phases
# shots of the other LER runs: the checkpoint sweep but d=11, the generic,
# toric and roll paths and BP+OSD-0 (half of LER_SHOTS, so that the cold
# smoke stays within its 5 minutes; every gate on them is a z-score or a
# share of shots)
SWEEP_SHOTS = 32768

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
# f32: the rounds kernels form each product as three TF32 products (3xTF32,
# within 2^-21 of f32 a product) where the plain version runs the library's
# f32 GEMMs, summed in another order, carried through 14 LayerNorm'd rounds;
# a state is O(1), so 1e-3 leaves two orders of magnitude over that noise,
# while a single TF32 pass lands 4.4e-3 away at d=11, R=14.
TOL_F32 = 1e-3
# bf16: states, slot sums and update hiddens are stored in bf16 by both
# versions; a different f32 summation order flips a bf16 rounding now and
# then (1 ulp = 2^-8 relative, 0.016 at |x| = 4) and the flip travels through
# later rounds.  Max 0.25 (16 ulp at |x| = 4) and mean 1e-2 bound that drift.
TOL_BF16_MAX = 0.25
TOL_BF16_MEAN = 1e-2
# bf16 K1 on a trained checkpoint at the training shapes (B=4096, R=8): over
# 8 trained rounds a bf16 rounding flip grows to several tenths in a few
# entries (on an H100, circuit d=7: 0.40 and 0.61 in two runs, 25 of its 575
# M entries past TOL_BF16_MAX; the unchanged shared-panel kernel on the
# circuit d=5 checkpoint 0.56), while the kernel and the plain version lie
# equally far from the same rounds in f64 (3.04 and 3.04 at most, means equal
# to four digits).  There each of the kernel's max and mean distance from the
# f64 rounds is held to BF16_F64_RATIO times the plain version's: a wrong
# gather or a wrong sample moves the kernel far past the plain version.
BF16_F64_RATIO = 1.25
# share of real qubits whose argmax correction under a random pauli4 head
# must agree between kernel and plain
MIN_AGREE_F32 = 0.999
MIN_AGREE_BF16 = 0.99

# K2a against K1: in both state types the same kernel code with a flag that
# adds the stash stores, so the same arithmetic in the same order; outputs
# must be equal.
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

# The surface-code checkpoints of benchmarks/LER_TABLE.md as
# tpugnn_torch/assets/ carries them (scripts/export_torch_weights.py, each
# with the JAX package's f32 LER at p=0.05): (weights file, d, H = MH, R, the
# line of the table's p=0.05 row, its logical-head, hybrid and per-qubit
# rates, 1e6 shots each, taken on a TPU).  The configs are those of
# scripts/tpu_queue_r1b.sh:26-29, tpu_queue_r4a.sh:89 and tpu_queue_r4f.sh:50
# as benchmarks/ler_table.py:132-142 reads them.
CHECKPOINTS = (
    ("surface_d3_h64_r8_4000.npz", 3, 64, 8, 10, 0.02917, 0.02923, 0.07777),
    ("surface_d5_h96_r8_4000.npz", 5, 96, 8, 14, 0.01449, 0.01415, 0.232),
    ("surface_d7_h128_r10_8000.npz", 7, 128, 10, 18, 0.005111, 0.005031, 0.3215),
    ("surface_d9_h128_r12_8000.npz", 9, 128, 12, 22, 0.003465, 0.003385, 0.3923),
    ("surface_d11_h128_r14_ema40000.npz", 11, 128, 14, 30, 0.00211, 0.002062, 0.4386),
    ("surface_d13_h128_r14_ema8000.npz", 13, 128, 14, 34, 0.00711, 0.006938, 0.5532),
    ("surface_d15_h128_r14_ema8000.npz", 15, 128, 14, 37, 0.04344, 0.04275, 0.6663),
)
# shots of d=13 and d=15 that the roll path (K5's global-panel variant)
# decodes beside the fused path in the checkpoints phase
ROLL_CHECK_SHOTS = 8192
# R of the trained checkpoints from d=11 on: the shapes at which K1 at d=13
# and d=15 and K5 are timed (B=4096, f32)
TRAINED_ROUNDS = 14
# steps of the width-64 training run whose state the two-step check of
# K2a/K2b at H=64 starts from (phase 6): AdamW's moments then hold that many
# gradients, as phase 7's 30 steps do at H=128
WIDTH_TRAIN_STEPS = 10

# benchmarks/LER_TABLE.md:30 (v3_surface_d11/ema@40000, p=0.05, 1e6 shots,
# taken on a TPU), every column the hybrid phase reports: the GNN hybrid,
# GNN+UF, GNN+MWPM, best-of, logical and per-qubit heads, and the raw
# union-find and MWPM baselines
TABLE_D11_P05 = {"ler_hybrid": 0.002062, "gnn_uf": 0.0009805, "gnn_mwpm": 0.0009696,
                 "gnn_best_of": 0.0007264, "ler_logical": 0.00211, "ler": 0.4386,
                 "uf": 0.002856, "mwpm": 0.001777}
# the hybrid phase's gate: |z| of the cleanup columns against the JAX f32
# columns of the same weights, and of the raw baselines against the table
HYBRID_Z = 4
# phase 3's cleanup engines: (cleanup, keyword arguments); best_of with both
# cost rules, eager and lazy
SERVE_MODES = (
    ("uf", {}), ("mwpm", {}),
    ("best_of", {"select_cost": "weight"}), ("best_of", {"select_cost": "weight", "lazy": True}),
    ("best_of", {"select_cost": "nll"}), ("best_of", {"select_cost": "nll", "lazy": True}),
    ("device", {}), ("best_of_device", {}),
)
# 4096-syndrome requests timed per cleanup engine
SERVE_TIMED = 1
# best_of_device's mean correction weight over best_of's (tests/test_serve.py:
# test_best_of_device_not_heavier_than_full_best_of)
BEST_OF_DEVICE_WEIGHT_RATIO = 1.25

# The detector_and_stream phase.  benchmarks/LER_DETECTOR.md:41
# (spacetime_surface_d5_t5@4000: surface d=5 over 5 noisy rounds, sector z,
# p=0.02, 200,000 shots, taken on a TPU), every column it reports.
DETECTOR_ROW = {"ler_hybrid": 0.03616, "gnn_uf": 0.04264, "gnn_mwpm": 0.04085,
                "gnn_best_of": 0.03341, "ler_logical": 0.0362, "ler": 0.6164,
                "uf": 0.05344, "mwpm": 0.03392}
DETECTOR_ROW_SHOTS = 200_000
DETECTOR_P = 0.02
# the GNN columns, gated against the JAX f32 columns of the same weights
# (the weights file's sidecar); the raw baselines against the row
DETECTOR_GNN_COLUMNS = ("ler", "ler_logical", "ler_hybrid", "gnn_uf", "gnn_mwpm",
                        "gnn_best_of")
# BP+OSD-0 at p=0.05 (benchmarks/LER_TABLE.md, 1e6 shots; BP has no matrix
# product, so the table's TPU rate is the same f32 computation): (d, line, rate)
BP_OSD_ROWS = ((11, 26, 0.001996), (5, 14, 0.01629))
BP_OSD_P = 0.05
# runs/stream_quality_w.json, the d=5 p=0.02 row (the JAX package on a CPU),
# which the window weights' sidecar reproduces on the same streams at the same
# settings (window 5, commit 1, 11 rounds, seed 11, batch 256, 10,000 shots)
STREAM_ROW = {"gnn_stream": 0.8134, "gnn_uf_stream": 0.0942, "gnn_dev_stream": 0.0922,
              "uf_stream": 0.1261, "uf_monolithic": 0.1226}
# the GNN window adapters decode the sidecar's own streams, so their failure
# counts may differ from the JAX f32 counts only by the few shots whose
# logits f32 rounding moves across 0
STREAM_FAIL_SLACK = 5
DETECTOR_Z = 4

# The circuit_and_cli phase.  The circuit-level checkpoints behind
# benchmarks/LER_DETECTOR.md's [nll] rows (H = MH = 128, R=8, bits, trained
# in bf16 through the fused kernels; tpugnn_torch/assets/), each decoded in
# f32 at p=0.01: (weights file, d = d_t, sector, the kernel counter its
# decode must move, the line of the table's p=0.01 row, that row's GNN
# hybrid, GNN+UF, GNN+MWPM, best-of, logical, per-qubit, union-find and MWPM
# rates, 1e6 shots each, taken on a TPU).
CIRCUIT_P = 0.01
CIRCUIT_SHOTS = 32768
CIRCUIT_ROW_SHOTS = 1_000_000
_ROW = ("ler_hybrid", "gnn_uf", "gnn_mwpm", "gnn_best_of", "ler_logical", "ler", "uf", "mwpm")
CIRCUIT_CHECKPOINTS = (
    ("circuit_surface_d3_t3_h128_r8_ema24000.npz", 3, "z", "fused_rounds", 17,
     dict(zip(_ROW, (0.02973, 0.03207, 0.03013, 0.03022, 0.02974, 0.1187, 0.03958, 0.02998)))),
    ("circuit_surface_d5_t5_h128_r8_ema24000.npz", 5, "z", "fused_rounds", 35,
     dict(zip(_ROW, (0.0578, 0.07201, 0.06551, 0.05753, 0.05781, 0.6043, 0.1215, 0.05593)))),
    ("circuit_surface_d3_t3_x_h128_r8_ema6000.npz", 3, "x", "fused_rounds", 7,
     dict(zip(_ROW, (0.02912, 0.03089, 0.03022, 0.03025, 0.02909, 0.09584, 0.03875, 0.03014)))),
    ("circuit_surface_d5_t5_x_h128_r8_ema8000.npz", 5, "x", "fused_rounds", 25,
     dict(zip(_ROW, (0.05938, 0.07549, 0.0703, 0.05799, 0.05941, 0.6394, 0.1169, 0.05613)))),
    ("circuit_surface_d7_t7_h128_r8_ema2000.npz", 7, "z", "fused_rounds", 43,
     dict(zip(_ROW, (0.4253, 0.1584, 0.1435, 0.09086, 0.4253, 0.9624, 0.2235, 0.08001)))),
)
# the checkpoint whose every column runs (ler_all_columns, select_cost='nll',
# as the table's [nll] rows were taken), gated against its sidecar's JAX f32
# columns, the raw union-find and MWPM against the table's row
CIRCUIT_COLUMNS = "circuit_surface_d5_t5_h128_r8_ema24000.npz"
CIRCUIT_Z = 4
# K1 on a circuit graph against the same rounds in f64: its max error there
# within this many times the plain f32 version's.  Both are f32 rounding
# carried through R trained rounds, largest in a few shots whose states grow
# large (scripts/k1_precision_probe.py), so K1 against the plain version can
# read far more than either's distance from f64 suggests.
K1_F64_RATIO = 3
# the circuit training config of scripts/tpu_queue_r4d.sh:59-63 (circuit
# d=5 over 5 rounds, bf16 through K2a/K2b, batch 4096, p-mix 0.004..0.015,
# bits head) through the CLI, and the CLI's default (generic) training at
# d=5, CLI_TRAIN_STEPS steps each; CLI_LOSS_FALL bounds the mean loss of the
# last 5 steps over that of the first 5 (a CPU run of the generic config
# gave 0.36; the warmup of 100 steps keeps the learning rate small here)
CLI_TRAIN_STEPS = 20
CLI_LOSS_FALL = 0.9
CIRCUIT_TRAIN_ARGS = ("train", "--noise", "circuit", "--dt", "5", "-d", "5", "--backend",
                      "pallas", "--dtype", "bfloat16", "--hidden", "128", "--msg-hidden",
                      "128", "--rounds", "8", "--batch", "4096", "--p-mix", "0.004", "0.015",
                      "--qubit-head", "bits")
# one step of the generic training on the card against the same step on the
# CPU through the port: the relative L2 error of the whole gradient.
# tests/test_torch_generic_train.py holds H=16, R=3, B=8 entry by entry to
# 1e-5 of the largest gradient; at this config (H=128, R=8, B=256, f32, TF32
# off) the card is not that steady against itself: two backward passes of
# the same step (index_add_ adds by atomics, and a ReLU whose input sits at
# 0 flips with the order) differ by up to 1e-4 of the largest entry and
# 1.1e-5 to 6.5e-5 in relative L2, and the card against the CPU by 1.6e-5 to
# 2.3e-4 in relative L2 (five batches on H100s).  The same step with TF32
# products reads 7.1e-3 to 1.1e-2.  The bound sits between, near their
# geometric middle.
GENERIC_GRAD_REL = 2e-3
# the same, leaf by leaf, so that a fault in one small leaf (a bias, a
# LayerNorm scale) does not hide under the norm of the large ones: the worst
# leaf's relative L2 error read 1.9e-4 to 2.8e-4 card against CPU and 2.5e-2
# to 3.7e-2 with TF32 products (three batches on H100s).  The phase runs the
# TF32 step as a control and requires this bound to reject it.
GENERIC_LEAF_REL = 3e-3
# the CLI's eval and serve on the d=5 circuit weights file
CLI_EVAL_SHOTS = 8192
CLI_WEIGHTS_ARGS = ("--noise", "circuit", "--dt", "5", "-d", "5", "--backend", "pallas",
                    "--hidden", "128", "--msg-hidden", "128", "--rounds", "8",
                    "--qubit-head", "bits", "-p", str(CIRCUIT_P), "--cleanup", "mwpm")

# Phase 4g: the circuit d=7 checkpoint (LER_DETECTOR.md:43's row) in bf16,
# the state type scripts/tpu_queue_r5a.sh:104-108 trained it in through the
# Pallas kernels (M=176, N=920 rows: the largest graph the smoke trains).
# `cli eval` decodes it at CIRCUIT_P on CIRCUIT_SHOTS shots (both
# heads gated at |z| <= CIRCUIT_Z against the JAX f32 rate in the weights
# file); `cli train` runs the checkpoint's training settings (bf16, B=4096,
# H=128, R=8, p-mix 0.004..0.015, lr 1e-3, EMA 0.999) from a seeded random
# init for D7_TRAIN_STEPS steps: a finite loss whose mean over the last 5
# steps is below CLI_LOSS_FALL of the first 5's (the circuit d=5 run fell to
# 0.68 of it by step 10 on an H100).  D7_GP_BATCH: phase 6d's d=11
# comparison of bf16 K5's two panel placements runs more samples than the
# card has SMs, so the global-panel variant's persistent blocks walk several
# samples each.
D7_WEIGHTS = "circuit_surface_d7_t7_h128_r8_ema2000.npz"
D7_ROW_LINE = 43
D7_ARGS = ("--noise", "circuit", "--dt", "7", "-d", "7", "--backend", "pallas", "--dtype",
           "bfloat16", "--hidden", "128", "--msg-hidden", "128", "--rounds", "8")
D7_EVAL_ARGS = ("eval", *D7_ARGS, "--qubit-head", "bits", "-p", str(CIRCUIT_P), "--shots",
                str(CIRCUIT_SHOTS))
D7_TRAIN_ARGS = ("train", *D7_ARGS, "--batch", "4096", "--p-mix", "0.004", "0.015", "--lr",
                 "0.001", "--ema", "0.999")
D7_TRAIN_STEPS = 10
D7_GP_BATCH = 300
# the launch counters of K1, K2a and K2b at W = 128 (above it: WIDE_NAMES)
ROUNDS_NAMES = ("fused_rounds", "fused_rounds_fwd_stash", "fused_rounds_bwd")
# K2b with f32 states against rounds_vjp_plain on the trained circuit
# checkpoints (phase 4e): the graphs with 10 to 14 slots a check row, where
# K2b's re-decided t ties must sum a row's hs as torch's reduction does
CIRCUIT_F32_K2B = ("circuit_surface_d5_t5_h128_r8_ema24000.npz",
                   "circuit_surface_d7_t7_h128_r8_ema2000.npz")

# Phase 6b: f32 training on the larger graphs (surface d=13, circuit d=5:
# 168 + 169 and 64 + 304 rows).  The circuit d=5 training config
# of CIRCUIT_TRAIN_ARGS in f32 at batch 512 for CIRCUIT_F32_TRAIN_STEPS steps
# through the CLI, gated as the bf16 run is (gate_training).
CIRCUIT_F32_TRAIN_ARGS = (*CIRCUIT_TRAIN_ARGS, "--dtype", "float32", "--batch", "512")
CIRCUIT_F32_TRAIN_STEPS = 10
# Phase 6c: the fused backend's msg_hidden != hidden (H=64, MH=96: the packs
# padded to 96 and on to the kernels' 128, the LayerNorm over 64) and its
# per-round weights (weight_tied=False: R calls of one round, a round's
# weights each; d=5, H=128, R=3)
MH_WIDTH = 96
UNTIED_D = 5
# Phase 6d: widths above 128 on the wide kernels (csrc/wide_rounds.cuh): K1,
# K2a, K2b and K5 at H = MH = WIDE_H against their plain versions (d=11 and
# circuit d=5, B=D13_BATCH, R=D13_ROUNDS; the bf16 states held as at
# W = 128), two training steps of a WIDE_H model on surface
# WIDE_TRAIN_D through the kernels against the plain versions, the circuit
# training config through the CLI at WIDE_H for WIDE_CLI_STEPS steps, bf16
# K5 past shared memory (surface K5_GP_D, global panels; its placement
# check on d=11 at D7_GP_BATCH), and one timed call of each wide kernel at
# d=11, B=WIDE_TIMING_BATCH, R=WIDE_TIMING_ROUNDS beside its plain version,
# its bound and the same kernels at H=128 (W = 128) on the same inputs.
WIDE_H = 256
WIDE_TRAIN_D = 5
WIDE_CLI_STEPS = 10
WIDE_CLI_ARGS = (*CIRCUIT_TRAIN_ARGS, "--hidden", str(WIDE_H), "--msg-hidden", str(WIDE_H))
WIDE_TIMING_BATCH = 4096
WIDE_TIMING_ROUNDS = 8
WIDE_NAMES = ("fused_rounds_wide", "fused_rounds_fwd_stash_wide", "fused_rounds_bwd_wide")
WIDE_MORE_H = (384, 512)   # the wider packs, checked on surface WIDE_TRAIN_D
K5_GP_D = 17

# The dist phase (4f): graph- and data-parallel decoding and training on
# torch.distributed.  One card: NCCL at world size 1 in this process, and P
# gloo ranks time-sharing the card, their exchanges staged through the host
# (NCCL takes one rank per card).  The d=15 checkpoint (LER_TABLE.md:37's,
# f32) on the generic rounds, P=4 shards of a graph padded for them, at
# p=0.05 on DIST_SHOTS shots in chunks of DIST_CHUNK (8192 until the wide
# kernels' phase needed room within the smoke's 400 s: a sharded chunk takes
# about 3 s of ranks time-sharing the card)
DIST_WEIGHTS = "surface_d15_h128_r14_ema8000.npz"
DIST_D = 15
DIST_P = 4
DIST_SHOTS = 4096
DIST_CHUNK = 1024
# shots of the first chunk on which the halo modes and wire types are held
# to alltoall's f32, with index_add_ deterministic (its CUDA path sorts the
# indices, so these forwards cost a multiple of an atomic one; the exchange
# buffers, bytes and times are those of a whole chunk)
DIST_CHECK = 128
DIST_SEED = 2031
DIST_Z = 4
# the sharded forward against the unsharded generic one on the card: the same
# f32 function, each sum split at the shard boundaries (interior and boundary
# edges summed apart), through 14 trained rounds; and the sharded per-shot
# decisions against the unsharded generic and K1 paths
DIST_LOGIT_TOL = 1e-3
DIST_SHOT_AGREE = 0.999
# ring and gather against alltoall on one chunk: the same slices moved
# otherwise, the same sums (gather: all edges summed in one segment sum)
DIST_MODE_TOL = 1e-4
# bf16 and int8 wires against the f32 wire: per-qubit decisions (argmax of
# the pauli4 head over real qubits)
DIST_WIRE_AGREE = 0.995
# NCCL at world size 1: the sharded apply of one shard against the model,
# both with index_add_ deterministic (with atomics the two forwards' summation
# orders differ from call to call: 3.5e-5 to 1.0e-4 apart over 1024 shots)
DIST_NCCL_TOL = 1e-4
# the sharded train step: mesh data=2 x graph=2, the CLI's generic defaults
# (surface d=5, H=128, R=8, B=256, segment, f32); gradients of its first step
# against the unsharded step on the card, with phase 4e's bounds
# (GENERIC_GRAD_REL, GENERIC_LEAF_REL); DIST_TRAIN_STEPS steps, a finite
# loss whose mean over the last 3 is below that over the first 3; two int8
# steps move the parameters by more than DIST_INT8_MOVE of two f32 steps'
DIST_TRAIN_STEPS = 10
DIST_TRAIN_SEED = 79
DIST_INT8_MOVE = 0.3
# a launch of phase 4f's ranks that outlasts DIST_TIMEOUT_S fails
DIST_TIMEOUT_S = 600

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12    # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak: every f32 rounds kernel forms 3 TF32 products
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


def host_ms(fn, iters: int = 5) -> float:
    """Median wall time of ``iters`` calls of ``fn``, for work on the host."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_ms_per_call(fn, calls: int = 8) -> float:
    """time_ms of ``calls`` back-to-back calls of ``fn``, per call: the host
    enqueues a call while the card runs the last, so a kernel under a
    millisecond is timed without the host's time to launch it."""
    def run():
        for _ in range(calls):
            fn()
    return time_ms(run) / calls


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


def train_kernel_bounds(graph, batch: int, rounds: int, h: int, k2a_ms: float,
                        k2b_ms: float, dtype: str = "bfloat16") -> dict:
    """K2a's and K2b's bounds on ``graph`` (B, R, width h) in a state type:
    K2a the forward's products at the tensor-core peak (bf16; f32 as
    3xTF32, three TF32 products each) or its bytes with the stash; K2b
    three times the forward's products (:func:`rounds_bwd_flops`) at the
    tensor-core peak (bf16; f32 as 3xTF32), or its bytes (the stash, the
    f32 cotangents in and out, the syndrome, the packed weights and their
    f32 gradients); each with its TFLOP/s and f32 CUDA-core floor."""
    f32 = dtype == "float32"
    item = 4 if f32 else 2
    flops_a = rounds_flops(graph, h) * batch * rounds
    flops_b = rounds_bwd_flops(graph, h) * batch * rounds
    t_ops_a = (3 * flops_a / H100_TF32_FLOPS if f32 else flops_a / H100_BF16_FLOPS) * 1e3
    t_bytes_a = (rounds_bytes(graph, batch, h, item)
                 + stash_bytes(graph, batch, rounds, h, item)) / H100_HBM_BPS * 1e3
    rows = graph.n_checks + graph.n_qubits
    t_ops_b = (3 * flops_b / H100_TF32_FLOPS if f32 else flops_b / H100_BF16_FLOPS) * 1e3
    t_bytes_b = (stash_bytes(graph, batch, rounds, h, item) + 2 * 2 * batch * rows * h * 4
                 + 2 * batch * graph.n_checks * 4 + 10 * h * h * (2 * item + 4)
                 + 2 * 14 * h * 4) / H100_HBM_BPS * 1e3
    return dict(
        k2a_bound_ms=max(t_ops_a, t_bytes_a),
        k2a_bound_by="operations" if t_ops_a >= t_bytes_a else "bytes",
        k2b_bound_ms=max(t_ops_b, t_bytes_b),
        k2b_bound_by="operations" if t_ops_b >= t_bytes_b else "bytes",
        k2a_bytes_ms=t_bytes_a, k2b_bytes_ms=t_bytes_b,
        k2a_tflops=flops_a / (k2a_ms * 1e-3) / 1e12,
        k2b_tflops=flops_b / (k2b_ms * 1e-3) / 1e12,
        k2a_f32_core_ms=flops_a / H100_F32_FLOPS * 1e3,
        k2b_f32_core_ms=flops_b / H100_F32_FLOPS * 1e3)


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


def yardstick_training_times(xc, xq, syn, dg, w, cot_c, cot_q, rounds: int, dtype) -> dict:
    """The autograd yardstick of the training rounds: :func:`yardstick_rounds`
    in ``dtype`` under autograd, its forward alone and a step (the forward
    and the backward of the cotangents' inner product), by CUDA events at
    ``rounds`` rounds, or at 8 (then 4) where the card runs out of memory;
    ``yardstick_rounds`` says which ran."""
    import torch

    leaves = type(w)(*[t.clone().requires_grad_(True) for t in w])
    xcg, xqg = xc.clone().requires_grad_(True), xq.clone().requires_grad_(True)

    def y_forward(r):
        with torch.enable_grad():
            return yardstick_rounds(xcg, xqg, syn, dg, leaves, r, dtype)

    def y_step(r):
        yc, yq = y_forward(r)
        with torch.enable_grad():
            ((yc * cot_c).sum() + (yq * cot_q).sum()).backward()

    for r in dict.fromkeys((rounds, 8, 4)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            step_ms = time_ms(lambda: y_step(r), warmup=1, iters=3)
            break
        except torch.cuda.OutOfMemoryError:
            continue
    else:
        raise RuntimeError(f"the {dtype} yardstick does not fit the card at 4 rounds")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms = time_ms(lambda: y_forward(r), warmup=1, iters=3)
    return dict(yardstick_rounds=r, yardstick_step_ms=step_ms, yardstick_fwd_ms=fwd_ms,
                yardstick_bwd_ms=step_ms - fwd_ms, yardstick_peak_gb=peak_gb)


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


def random_round_case(d: int, batch: int, rounds: int, dtype: str, seed: int, dev,
                      h: int = 128, mh: int | None = None, graph=None):
    """A surface code of distance d (or ``graph``) on the card, seeded random
    round weights of width H = h (the full width by default) and message
    width MH = mh (h by default) and random states: ``(graph, dg, ops, w,
    xc, xq, syn, gen)``."""
    import torch

    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.tanner import build_code

    graph = graph if graph is not None else build_code("surface", d)
    dg = graph.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = GNNDecoder(ModelConfig(hidden=h, msg_hidden=mh or h, rounds=rounds,
                                   backend="fused", qubit_head="pauli4", dtype=dtype), k=1)
    model.init_random(torch.Generator().manual_seed(seed + 1), bias_std=0.1)
    w = fd.RoundWeights(*[t.detach() for t in model.to(dev).rounds.round_weights()])
    xc, xq, syn = random_states(dg, batch, h, gen)
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


def tf32x3_floor_ms(flops: float) -> float:
    """The least time of ``flops`` f32 operations done as 3xTF32 (three TF32
    products for each f32 one) at the TF32 tensor-core peak, in ms."""
    return 3 * flops / H100_TF32_FLOPS * 1e3


_TF32X3_KERNEL = re.compile(r"roll_rounds_tf32x3_kernelILb([01])E")


def f32_hmma(mma: dict) -> dict:
    """The HMMA count of each f32 (3xTF32) K5 kernel in ``mma``
    (:func:`sass_mma_counts` of the roll_gather_tf32 library), by
    instantiation: ``shared`` or ``gpanels`` by its panel."""
    out = {}
    for name, count in mma.items():
        m = _TF32X3_KERNEL.search(name)
        if m:
            out["gpanels" if m.group(1) == "1" else "shared"] = count
    return out


def ptxas_usage(build_log: str, pattern: str) -> dict:
    """Registers and spill bytes of each function whose name matches
    ``pattern``, from a library's build log (nvcc -Xptxas -v)."""
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        if m:
            name = m.group(1) or m.group(2)
            continue
        if name is None or not re.search(pattern, name):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m[1])
    return out


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


def sddmm_bytes(graph, batch: int, h: int, mh: int, compute: str) -> float:
    """Bytes K4 to checks must move: the real rows of both sides read once,
    each real slot's f32 output written once, the weights, bias and slot
    table once."""
    itemsize = 2 if compute == "bfloat16" else 4
    rows = graph.n_checks + graph.n_qubits
    return (batch * rows * h * itemsize + batch * graph.n_edges * mh * 4 + 2 * h * mh * 4
            + mh * 4 + graph.n_checks_pad * graph.deg_max_check * 4)


def sddmm_padded_bytes(graph, batch: int, h: int, mh: int, compute: str) -> float:
    """Bytes K4's kernels move to checks at least: the padded rows of both
    sides read and every padded slot's f32 row written."""
    itemsize = 2 if compute == "bfloat16" else 4
    rows_pad = graph.n_checks_pad + graph.n_qubits_pad
    return (batch * rows_pad * h * itemsize
            + batch * graph.n_checks_pad * graph.deg_max_check * mh * 4)


def sddmm_bound(graph, batch: int, h: int, mh: int, compute: str) -> tuple[float, str]:
    """K4 to checks: sddmm_bytes at the HBM rate against both projections
    over the real rows and an add, add and relu per real slot and column, at
    the compute type's peak (bf16 tensor cores or f32 CUDA cores)."""
    peak = H100_BF16_FLOPS if compute == "bfloat16" else H100_F32_FLOPS
    rows = graph.n_checks + graph.n_qubits
    ops = 2 * batch * rows * h * mh + 3 * batch * graph.n_edges * mh
    return bound(sddmm_bytes(graph, batch, h, mh, compute), ops, peak)


def sddmm_vs_plain(args, compute: str, name: str, twice: bool) -> dict:
    """K4 on the card against its plain version on the same inputs, at
    H = MH = 128: the call must launch the tensor-core kernel in bf16 and the
    FMA kernel in f32, once; the max error and the share of outputs that
    differ are gated at the compute type's tolerance; with ``twice`` a
    second call on the same inputs must be bit-equal."""
    import torch

    from tpugnn_torch.kernels import sddmm

    sddmm.reset_launch_counts()
    k = sddmm.sddmm_edge_hidden(*args, compute_dtype=compute)
    routes = sddmm.launch_counts()
    want = "sddmm_edge_hidden_tc" if compute == "bfloat16" else "sddmm_edge_hidden"
    if routes != {**{r: 0 for r in routes}, want: 1}:
        raise RuntimeError(f"K4 {name}: launched {routes}, not one {want}")
    p = sddmm.sddmm_edge_hidden_plain(*args, compute_dtype=compute)
    torch.cuda.synchronize()
    diff = (k - p).abs()
    out = dict(kernel=want, max_abs_err=float(diff.max()),
               differing_share=float(torch.count_nonzero(diff)) / diff.numel())
    finite = bool(torch.isfinite(k).all())
    del p, diff
    if twice:
        out["bit_equal_twice"] = bool(torch.equal(k, sddmm.sddmm_edge_hidden(
            *args, compute_dtype=compute)))
    del k
    if not finite:
        raise RuntimeError(f"K4 {name}: non-finite output")
    if compute == "float32" and out["max_abs_err"] > TOL_SDDMM_F32:
        raise RuntimeError(f"K4 {name} disagrees with the plain version: {out}")
    if compute == "bfloat16" and (out["max_abs_err"] > TOL_SDDMM_BF16_MAX
                                  or out["differing_share"] > TOL_SDDMM_BF16_SHARE):
        raise RuntimeError(f"K4 {name} disagrees with the plain version: {out}")
    if twice and not out["bit_equal_twice"]:
        raise RuntimeError(f"K4 {name}: two calls on the same inputs differ")
    return out


def train_steps_vs_plain(state, cfg, dg, dev, steps: int = TRAIN_CHECK_STEPS,
                         seed: int = 77, witness: bool = False, extra: dict | None = None
                         ) -> dict:
    """Phase 7's check that K2b trains: ``steps`` train steps from
    the run's last state, through K2a/K2b (``kernels``), through their plain
    versions on the same CUDA tensors (``plain``), and through K2a/K2b with
    K2b's weight gradients replaced by zeros (``zero_wgrads``, what the check
    must catch), on the same batches (drawn from ``seed``).  Returns each
    variant's relative L2 error against ``plain`` of every parameter leaf's
    change from the start, after every step.  With ``witness`` (a bf16
    model) the same steps also run through the plain versions with f32
    states (``f32_states``): ``vs_f32`` then holds every variant's errors
    against those, and ``grads`` the first step's gradients' errors
    (``kernels`` against ``plain``; each of the two against
    ``f32_states``).  ``extra``: more variants, name -> a context manager
    factory under which the plain versions run (reported as the others)."""
    import copy

    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.models import decoder as dec
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.train.loop import train_step
    from tpugnn_torch.train.optim import make_optimizer

    gen = torch.Generator(device=dev).manual_seed(seed)
    batches = [sample_batch(gen, dg, 0.05, cfg.train.batch) for _ in range(steps)]
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    rounds_fn, bwd_cuda = dec.decoder_rounds, fb._bwd_cuda

    def plain_rounds(xc, xq, syn, ops, weights, rounds, state_dtype):
        return fb.trained_rounds(xc, xq, syn, ops, weights, rounds, state_dtype, kernels=False)

    def f32_rounds(xc, xq, syn, ops, weights, rounds, state_dtype):
        return fb.trained_rounds(xc, xq, syn, ops, weights, rounds, "float32", kernels=False)

    def zero_wgrads(*args):
        g_c, g_q, dsyn, dmats, dvecs = bwd_cuda(*args)
        return g_c, g_q, dsyn, torch.zeros_like(dmats), torch.zeros_like(dvecs)

    extra = extra or {}
    deltas, grads = {}, {}
    for variant in (("kernels", "plain", "zero_wgrads") + (("f32_states",) if witness else ())
                    + tuple(extra)):
        model = copy.deepcopy(state.model)
        opt = make_optimizer(cfg, model.parameters())
        opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
        if variant == "plain" or variant in extra:
            dec.decoder_rounds = plain_rounds
        elif variant == "f32_states":
            dec.decoder_rounds = f32_rounds
        elif variant == "zero_wgrads":
            fb._bwd_cuda = zero_wgrads
        try:
            deltas[variant] = []
            for batch in batches:
                with extra[variant]() if variant in extra else contextlib.nullcontext():
                    train_step(model, opt, dg, batch, cfg)
                if not deltas[variant]:
                    grads[variant] = {n: p.grad.detach().clone()
                                      for n, p in model.named_parameters() if p.grad is not None}
                deltas[variant].append({n: p.detach() - start[n]
                                        for n, p in model.named_parameters()})
        finally:
            dec.decoder_rounds, fb._bwd_cuda = rounds_fn, bwd_cuda
        del model, opt

    def errors(a, b):
        return [{n: rel_err(x[n], y[n]) for n in x} for x, y in zip(deltas[a], deltas[b])]

    out = {v: errors(v, "plain") for v in ("kernels", "zero_wgrads", *extra)}
    if witness:
        out["vs_f32"] = {v: errors(v, "f32_states")
                         for v in ("kernels", "plain", "zero_wgrads", *extra)}
        out["grads"] = {f"{a}_vs_{b}": {n: rel_err(grads[a][n], grads[b][n]) for n in grads[a]}
                        for a, b in (("kernels", "plain"), ("kernels", "f32_states"),
                                     ("plain", "f32_states"),
                                     *((v, "plain") for v in extra))}
    return out


def phase_spmm_sddmm(graph, dg, dev, info: dict) -> dict:
    """Phase 8: K3a, K3b and K4 against their plain versions at the main
    path's shapes (d=11, B=4096, F = H = MH = 128), f32 and bf16; their
    times, bounds and the library calls.  Returns the kernel-table rows'
    numbers."""
    import torch

    from tpugnn_torch import mp
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import sddmm, spmm
    from tpugnn_torch.kernels._build import build_libraries, load_library
    from tpugnn_torch.tanner import build_code

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

        # K4 in both directions at the bench config (to checks: x_dst the
        # check states, x_src the qubit states); bf16 at H = MH = 128 must
        # take the tensor-core kernel, f32 the FMA kernel
        h = mh = 128
        src_c, mask_c, _, src_q, mask_q, _ = fd.make_operators(dg)
        xc = torch.randn((B, graph.n_checks_pad, h), generator=gen, device=dev)
        xq = torch.randn((B, graph.n_qubits_pad, h), generator=gen, device=dev)
        xc *= dg.check_mask[:, None]
        xq *= dg.qubit_mask[:, None]
        wd = torch.randn((h, mh), generator=gen, device=dev) / h ** 0.5
        ws = torch.randn((h, mh), generator=gen, device=dev) / h ** 0.5
        b = 0.1 * torch.randn(mh, generator=gen, device=dev)
        k4 = {}
        for cdt in ("float32", "bfloat16"):
            # the states in the compute type, as a model of that type holds
            # them (the JAX wrapper casts them before its kernel)
            c, q = xc.to(fd.STATE_DTYPES[cdt]), xq.to(fd.STATE_DTYPES[cdt])
            for to, args in (("check", (c, q, src_c, mask_c, wd, ws, b)),
                             ("qubit", (q, c, src_q, mask_q, wd, ws, b))):
                name = f"{to}_{cdt}"
                k4[name] = sddmm_vs_plain(args, cdt, name, twice=cdt == "bfloat16")
            # the kernels line's time, as PR 8 took it: one call to checks on
            # the f32 states, the wrapper's cast to the compute type inside;
            # that call must launch the same kernel and give the same output
            # as the call on the compute-type states
            name, args, args32 = (f"check_{cdt}", (c, q, src_c, mask_c, wd, ws, b),
                                  (xc, xq, src_c, mask_c, wd, ws, b))
            sddmm.reset_launch_counts()
            same = torch.equal(sddmm.sddmm_edge_hidden(*args32, compute_dtype=cdt),
                               sddmm.sddmm_edge_hidden(*args, compute_dtype=cdt))
            routes = sddmm.launch_counts()
            if not same or routes[k4[name]["kernel"]] != 2 or sum(routes.values()) != 2:
                raise RuntimeError(f"K4 {name} on f32 states: launched {routes}, output "
                                   f"equal to the compute-type states' {same}")
            t_k = time_ms(lambda: sddmm.sddmm_edge_hidden(*args32, compute_dtype=cdt))
            t_p = time_ms(lambda: sddmm.sddmm_edge_hidden_plain(*args32, compute_dtype=cdt))
            t_c = time_ms_per_call(lambda: sddmm.sddmm_edge_hidden(*args, compute_dtype=cdt))
            b_ms, b_by = sddmm_bound(graph, B, h, mh, cdt)
            k4[name].update(
                ms=t_k, plain_ms=t_p, per_call_ms_compute_states=t_c, bound_ms=b_ms,
                bound_by=b_by, gb_per_s=sddmm_bytes(graph, B, h, mh, cdt) / (t_k * 1e-3) / 1e9,
                padded_gb_per_s_compute_states=sddmm_padded_bytes(graph, B, h, mh, cdt)
                / (t_c * 1e-3) / 1e9)
            del c, q, args, args32
        del xc, xq
        # the tensor-core kernel on larger panels: d=13 (176 rows a side)
        # and d=15 (232 rows, in 240-row panels)
        for d in (13, 15):
            g_d = build_code("surface", d)
            dg_d = g_d.to(dev)
            sc, mc, _, sq, mq, _ = fd.make_operators(dg_d)
            xc = torch.randn((D13_BATCH, g_d.n_checks_pad, h), generator=gen, device=dev)
            xq = torch.randn((D13_BATCH, g_d.n_qubits_pad, h), generator=gen, device=dev)
            xc = (xc * dg_d.check_mask[:, None]).bfloat16()
            xq = (xq * dg_d.qubit_mask[:, None]).bfloat16()
            for to, args in (("check", (xc, xq, sc, mc, wd, ws, b)),
                             ("qubit", (xq, xc, sq, mq, wd, ws, b))):
                k4[f"d{d}_{to}_bfloat16"] = sddmm_vs_plain(args, "bfloat16",
                                                           f"d={d} {to}", twice=False)
        lib = load_library("sddmm")
        info["sddmm_tc_smem_bytes"] = {
            f"d{d}": lib.sddmm_tc_smem_bytes(g.n_checks_pad, g.n_qubits_pad, g.deg_max_check)
            for d, g in ((d, build_code("surface", d)) for d in (11, 13, 15))}
        # the tensor-core kernel runs its products on HMMA, the FMA one does not
        mma = sass_mma_counts(build_libraries(["sddmm"])["sddmm"][0])
        info["sass_hmma"] = mma
        tc = [v for k, v in mma.items() if "sddmm_tc_kernel" in k]
        fma = [v for k, v in mma.items() if "sddmm_kernel" in k]
        if not tc or not all(tc) or not fma or any(fma):
            raise RuntimeError(f"K4's HMMA counts are not tensor-core kernel > 0, FMA "
                               f"kernels 0: {mma}")
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
        "sddmm_edge_hidden": dict(
            max_abs_err=max(v["max_abs_err"] for k, v in k4.items() if "bfloat16" in k),
            max_abs_err_f32=max(v["max_abs_err"] for k, v in k4.items() if "float32" in k),
            ms=k4["check_bfloat16"]["ms"], plain_ms=k4["check_bfloat16"]["plain_ms"],
            bound_ms=k4["check_bfloat16"]["bound_ms"],
            bound_by=k4["check_bfloat16"]["bound_by"], library_ms=None,
            gb_per_s=k4["check_bfloat16"]["gb_per_s"],
            per_call_ms_compute_states=k4["check_bfloat16"]["per_call_ms_compute_states"],
            ms_f32=k4["check_float32"]["ms"], plain_ms_f32=k4["check_float32"]["plain_ms"],
            bound_ms_f32=k4["check_float32"]["bound_ms"],
            bound_by_f32=k4["check_float32"]["bound_by"],
            gb_per_s_f32=k4["check_float32"]["gb_per_s"]),
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
    shots = SWEEP_SHOTS
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
        fwd_ms = time_ms(lambda: model(dg, syn), warmup=1, iters=3)
        fused_ms = time_ms(lambda: trained(dg, syn), warmup=1, iters=3)
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
    shots = SWEEP_SHOTS
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
            fwd_ms = time_ms(lambda: model(dg, syn), warmup=1, iters=3)
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
        bench_ms = time_ms(lambda: model(dg, syn), warmup=1, iters=5)
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


# the rounds kernels' libraries (K1, K2a and K2b at every width, K5 above
# 128 columns), and the build phase's result (build_libraries'), which
# phase 6d reports
WIDE_LIBRARIES = ("wide_rounds", "wide_rounds_tf32", "wide_backward", "wide_backward_tf32")
_BUILT: dict = {}


def hgmma_w128(dt: str) -> dict:
    """HGMMA (wgmma) instructions of K1's, K2a's and K2b's W = 128
    instantiations in state type ``dt`` (:func:`wide_hgmma` of its two
    libraries, the width-generic weight-gradient kernel with K2b's); raises
    where one is missing or runs no wgmma."""
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels._build import build_libraries

    libs = [fd.wide_library(fd.STATE_DTYPES[dt], backward=b) for b in (False, True)]
    built = build_libraries(libs)
    rows = wide_hgmma({k: v for lib in libs
                       for k, v in sass_mma_counts(built[lib][0], "HGMMA").items()})
    out = {k: {t: n for t, n in rows[k].items() if t.endswith("_w128") or t == "wgrad"}
           for k in ("k1", "k2a", "k2b")}
    want = {"k1": {"fwd_w128"}, "k2a": {"fwd_w128"},
            "k2b": {"project_w128", "replay_w128", "cotangent_w128", "wgrad"}}
    if any(set(out[k]) != want[k] or not all(n > 0 for n in out[k].values()) for k in want):
        raise RuntimeError(f"a {dt} W = 128 rounds kernel is missing or runs no wgmma: {out}")
    return out


# cuobjdump's HMMA (mma.sync) and HGMMA (wgmma) counts by library file and
# instruction: futures, started by prefetch_sass
_SASS: dict = {}


def prefetch_sass(libraries, op: str = "HMMA") -> None:
    """Starts the count of instruction ``op`` (HMMA or HGMMA) in each library
    (cuobjdump -sass, seconds for the larger ones) in a thread of its own, so
    that the phases that check them find the counts ready instead of
    waiting on the disassembly."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(libraries))
    for library in libraries:
        _SASS.setdefault((library, op), pool.submit(_sass_counts, library, op))
    pool.shutdown(wait=False)


def sass_mma_counts(library: str, op: str = "HMMA") -> dict:
    """Instructions ``op`` (HMMA: mma.sync; HGMMA: wgmma) per kernel of a
    built library, from cuobjdump -sass beside nvcc (once a library file and
    instruction; :func:`prefetch_sass` may have started it)."""
    if (library, op) not in _SASS:
        prefetch_sass([library], op)
    return _SASS[(library, op)].result()


def _sass_counts(library: str, op: str) -> dict:
    from tpugnn_torch.kernels._build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"no cuobjdump beside nvcc ({tool}): cannot check that the "
                           "kernels run on tensor cores")
    out, name = {}, None
    for line in run([tool, "-sass", library]).splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = 0
        elif name is not None and op in line:   # neither name holds the other
            out[name] += 1
    return out


def phase_roll_gather(graph, dg, dev, trained, info: dict) -> tuple[dict, dict]:
    """Phase 11: K5 at the bench config against its plain version and K1,
    their times; K5 at d=13 and d=15; its SASS; the trained d=11 weights on
    the roll path.  Returns the launches of its LER run and the kernel-table
    row's numbers."""
    import torch

    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.kernels._build import build_libraries, load_library
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
    flops = rounds_flops(graph, h) * B * rounds
    bench = {}
    with torch.inference_mode():
        r_ops = rg.to_raster(xc, xq, s, plan, w, "bfloat16")
        k1c, k1q = fd.decoder_rounds(xc, xq, s, ops, w, rounds, "bfloat16")
        for slot in ("float32", "bfloat16"):
            kc, kq = rg._roll_rounds_cuda(r_ops, rounds=rounds, slot_dtype=slot)
            kc2, kq2 = rg._roll_rounds_cuda(r_ops, rounds=rounds, slot_dtype=slot)
            pc, pq = rg.roll_rounds_plain(r_ops, rounds=rounds, slot_dtype=slot)
            torch.cuda.synchronize()
            repeatable = bool(torch.equal(kc, kc2) and torch.equal(kq, kq2))
            del kc2, kq2
            max_err, mean_err = raster_errors(kc, kq, pc, pq)
            oc, oq = rg.from_raster(kc, kq, plan)
            k1_max, k1_mean = raster_errors(real(oc, graph.n_checks), real(oq, graph.n_qubits),
                                            real(k1c, graph.n_checks), real(k1q, graph.n_qubits))
            finite = bool(torch.isfinite(oc).all() and torch.isfinite(oq).all())
            del kc, kq, pc, pq, oc, oq
            k_ms = time_ms(lambda: rg._roll_rounds_cuda(r_ops, rounds=rounds, slot_dtype=slot),
                           warmup=2, iters=10)
            call_ms = time_ms(lambda: rg.decoder_rounds_roll(
                xc, xq, s, plan, w, rounds=rounds, state_dtype="bfloat16", slot_dtype=slot),
                warmup=2, iters=10)
            p_ms = time_ms(lambda: rg.roll_rounds_plain(r_ops, rounds=rounds, slot_dtype=slot),
                           warmup=0, iters=1)
            bench[slot] = dict(max_abs_err=max_err, mean_abs_err=mean_err,
                               vs_k1_real_rows_max=k1_max, vs_k1_real_rows_mean=k1_mean,
                               repeatable=repeatable, kernel_ms=k_ms,
                               kernel_tflops=flops / (k_ms * 1e-3) / 1e12, call_ms=call_ms,
                               plain_ms=p_ms, edges_per_s=edges / (call_ms / 1e3),
                               edges_per_s_kernel=edges / (k_ms / 1e3))
            if not finite:
                raise RuntimeError(f"K5 slots {slot}: non-finite states")
            if not repeatable:
                raise RuntimeError(f"K5 slots {slot}: two runs on the same inputs differ")
            if max_err > TOL_BF16_MAX or mean_err > TOL_BF16_MEAN:
                raise RuntimeError(f"K5 slots {slot} disagrees with roll_rounds_plain: "
                                   f"{bench[slot]}")
            if k1_max > TOL_BF16_MAX or k1_mean > TOL_BF16_MEAN:
                raise RuntimeError(f"K5 slots {slot} disagrees with K1 on the real rows: "
                                   f"{bench[slot]}")
        k1_ms = time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, w, rounds, "bfloat16"))
    del r_ops, k1c, k1q
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, rounds_bytes(graph, B, h, 2) / H100_HBM_BPS * 1e3
    info.update(batch=B, rounds=rounds, l_pad=plan.l_pad, raster_rows=2 * plan.l_pad,
                real_rows=graph.n_checks + graph.n_qubits, bench=bench, k1_ms=k1_ms,
                k1_edges_per_s=edges / (k1_ms / 1e3), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes", gflop=flops / 1e9,
                f32_core_ms=flops / H100_F32_FLOPS * 1e3,
                tol_max=TOL_BF16_MAX, tol_mean=TOL_BF16_MEAN)

    # the bf16 kernel on larger rasters: d=13 (a 144-row chunk and a 56-row
    # tail, both slot modes), d=15 (144 + 112 rows, 32-row weight slabs)
    lib = load_library("roll_gather")
    info["larger_rasters"] = {}
    for d, slots, seed in ((13, ("float32", "bfloat16"), 31), (15, ("float32",), 32)):
        l_pad = rg.plan_for_graph(build_code("surface", d)).l_pad
        for slot in slots:
            info["larger_rasters"][f"d{d}_slots_{slot}"] = dict(
                l_pad=l_pad, smem_bytes=lib.roll_rounds_smem_bytes(1, l_pad),
                **rounds_vs_plain("k5", d, h, "bfloat16", seed, dev, "roll_rounds", slot))
    # f32 at d=13 and d=15, in the placement the wrapper picks (d=13 its
    # panel in shared memory, d=15 in global memory), at B=64, R=3 and at
    # the trained shapes; narrower models zero-padded to 128 (d=11) in both
    # state types
    info["larger_float32"] = {
        f"d{d}": rounds_vs_plain("k5", d, h, "float32", 80 + d, dev, k5_f32_kernel(d))
        for d in (13, 15)}
    info["larger_float32_timing"] = {
        f"d{d}": f32_rounds_timing(k5_f32_kernel(d), d, dev, 90 + d) for d in (13, 15)}
    info["padded_widths"] = {
        f"h{hw}_{dt}": rounds_vs_plain("k5", D, hw, dt, 100 + hw, dev, "roll_rounds")
        for hw in (64, 96) for dt in ("bfloat16", "float32")}
    lib32 = load_library("roll_gather_tf32")
    info["smem_bytes"] = {
        f"d{d}": {dt: lb.roll_rounds_smem_bytes(code, rg.plan_for_graph(
            build_code("surface", d)).l_pad)
            for dt, code, lb in (("float32", 0, lib32), ("bfloat16", 1, lib))}
        for d in (11, 13, 15)}
    info["gpanels_smem_bytes"] = {
        f"d{d}": lib32.roll_rounds_gpanels_smem_bytes(rg.plan_for_graph(
            build_code("surface", d)).l_pad) for d in (11, 13, 15)}
    # every K5 kernel runs its products on tensor cores: the bf16 ones and
    # both f32 (3xTF32) placements
    libs = build_libraries(["roll_gather", "roll_gather_tf32"])
    mma = sass_mma_counts(libs["roll_gather"][0])
    info["sass_hmma"] = mma
    tc = {k: v for k, v in mma.items()   # bf16: both panel placements
          if "roll_rounds_tc_kernel" in k or "roll_rounds_tc_gpanels_kernel" in k}
    f32_mma = f32_hmma(sass_mma_counts(libs["roll_gather_tf32"][0]))
    info["f32_sass_hmma"] = f32_mma
    if not tc or not all(tc.values()):
        raise RuntimeError(f"K5's bf16 kernels have no HMMA instruction: {mma}")
    if not all(f32_mma.get(k, 0) > 0 for k in ("shared", "gpanels")):
        raise RuntimeError(f"an f32 K5 kernel has no HMMA instruction: {f32_mma}")

    # the trained d=11 weights through PallasDecoder on the roll path
    pd = PallasDecoder(trained, ("rollgather",))
    r_t = trained.cfg.rounds
    wt = fd.RoundWeights(*[t.detach() for t in trained.rounds.round_weights()])
    gen = torch.Generator(device=dev).manual_seed(6)
    xc, xq, s = random_states(dg, B, h, gen)
    with torch.inference_mode():
        t_ops_r = rg.to_raster(xc, xq, s, plan, wt, "float32")
        reset_counts()
        kc, kq = rg._roll_rounds_cuda(t_ops_r, rounds=r_t)
        f32_kernel = next(k for k, v in counts().items() if v)
        pc, pq = rg.roll_rounds_plain(t_ops_r, rounds=r_t)
        torch.cuda.synchronize()
        f32_max, f32_mean = raster_errors(kc, kq, pc, pq)
        # the real rows of both against the same rounds in f64: the kernel's
        # distance within K1_F64_RATIO times the plain version's
        exact = rounds_f64_chunked(xc, xq, s, ops, wt, r_t)
        real_rows = lambda a, b: (real(a, graph.n_checks), real(b, graph.n_qubits))
        ex = real_rows(*exact)
        f32_f64 = raster_errors(*real_rows(*rg.from_raster(kc, kq, plan)), *ex)[0]
        plain_f64 = raster_errors(*real_rows(*rg.from_raster(pc, pq, plan)), *ex)[0]
        del kc, kq, pc, pq, exact, ex
        # the kernel the main path launches: f32 as 3xTF32
        f32_ms = time_ms(lambda: rg._roll_rounds_cuda(t_ops_r, rounds=r_t), warmup=1, iters=5)
        f32_plain_ms = time_ms(lambda: rg.roll_rounds_plain(t_ops_r, rounds=r_t),
                               warmup=0, iters=1)
        del t_ops_r
    f32_flops = rounds_flops(graph, h) * B * r_t
    f32_bound_ms, f32_bound_by = bound(rounds_bytes(graph, B, h, 4), 3 * f32_flops,
                                       H100_TF32_FLOPS)
    if f32_kernel != "roll_rounds":
        raise RuntimeError(f"K5 f32 at d=11 launched {f32_kernel}, not its shared-panel kernel")
    if f32_max > TOL_F32:
        raise RuntimeError(f"K5 f32 (trained weights, R={r_t}) disagrees with "
                           f"roll_rounds_plain: max {f32_max}")
    if f32_f64 > K1_F64_RATIO * plain_f64:
        raise RuntimeError(f"K5 f32 (trained weights, R={r_t}) is {f32_f64} from the rounds "
                           f"in f64, over {K1_F64_RATIO} times plain's {plain_f64}")
    reset_counts()
    gen = torch.Generator(device=dev).manual_seed(2025)      # phase 4's shots
    t0 = time.perf_counter()
    ev = ler_monte_carlo(pd, graph, p=0.05, shots=SWEEP_SHOTS, batch=B, generator=gen,
                         device="cuda")
    ler_s = time.perf_counter() - t0
    launched = counts()
    chunks = SWEEP_SHOTS // B
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
        fwd_ms = time_ms(lambda: pd(dg, syn), warmup=1, iters=3)
        fused_ms = time_ms(lambda: trained(dg, syn), warmup=1, iters=3)
        # a model wider than 128 columns (H=160, MH=200: packs of 256
        # columns, the LayerNorm over 160): K1's and K5's wrappers, as
        # the model calls them, each launch the wide kernel once and match
        # their plain versions (B=D13_BATCH, R=D13_ROUNDS)
        g160, _, ops160, w160, xc160, xq160, s160, _ = random_round_case(
            D, D13_BATCH, D13_ROUNDS, "float32", 103, dev, h=160, mh=200)
        plan160 = rg.plan_for_graph(g160)

        def roll160_plain():
            r_ops = rg.pad_raster(rg.to_raster(xc160, xq160, s160, plan160, w160), 200)
            oc, oq = rg.roll_rounds_plain(r_ops, rounds=D13_ROUNDS, width=160)
            return rg.from_raster(oc[..., :160], oq[..., :160], plan160)

        routed = {
            "fused_rounds_wide": held_to_plain(
                lambda: fd.decoder_rounds(xc160, xq160, s160, ops160, w160, D13_ROUNDS,
                                          "float32"),
                lambda: fd.rounds_plain(xc160, xq160, s160, ops160, w160, rounds=D13_ROUNDS),
                "fused_rounds_wide", "float32", "K1, H=160 MH=200"),
            "roll_rounds_wide": held_to_plain(
                lambda: rg.decoder_rounds_roll(xc160, xq160, s160, plan160, w160,
                                               rounds=D13_ROUNDS),
                roll160_plain, "roll_rounds_wide", "float32", "K5, H=160 MH=200")}
        del g160, ops160, w160, xc160, xq160, s160
    info["trained"] = dict(
        rounds=r_t, kernel=f32_kernel, k5_vs_plain_f32_max=f32_max,
        k5_vs_plain_f32_mean=f32_mean, tol_f32=TOL_F32, kernel_vs_f64_max=f32_f64,
        plain_vs_f64_max=plain_f64, f64_ratio_bound=K1_F64_RATIO, kernel_ms=f32_ms,
        kernel_tflops=f32_flops / (f32_ms * 1e-3) / 1e12, plain_ms=f32_plain_ms,
        bound_ms=f32_bound_ms, bound_by=f32_bound_by,
        f32_core_ms=f32_flops / H100_F32_FLOPS * 1e3, shots=n,
        ler_logical=ev["ler_logical"], ler_qubit=ev["ler"],
        ler_hybrid=ev["ler_hybrid"], z=z, ler_seconds=ler_s,
        jax_f32=dict(shots=ref["shots"], ler_logical=ref["ler_logical"], ler_qubit=ref["ler"]),
        launches=launched, shot_agreement_with_fused=agree, min_shot_agreement=MIN_SHOT_AGREE,
        forward_ms=fwd_ms, fused_forward_ms=fused_ms,
        edges_per_s=B * graph.n_edges * r_t / (fwd_ms / 1e3), width160_routed=routed)
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
               tflops=f32s["kernel_tflops"], tflops_slot16=s16["kernel_tflops"],
               call_ms=f32s["call_ms"], plain_ms=f32s["plain_ms"],
               plain_ms_slot16=s16["plain_ms"], bound_ms=info["bound_ms"],
               bound_by=info["bound_by"], library_ms=None,
               ms_f32=info["trained"]["kernel_ms"], tflops_f32=info["trained"]["kernel_tflops"],
               plain_ms_f32=info["trained"]["plain_ms"], bound_ms_f32=info["trained"]["bound_ms"],
               bound_by_f32=info["trained"]["bound_by"],
               f32_core_ms_f32=info["trained"]["f32_core_ms"],
               kernel_vs_f64_max_f32=f32_f64, plain_vs_f64_max_f32=plain_f64,
               sass_hmma_f32=f32_mma,
               yardstick_ms=k1_ms, yardstick="K1 (fused_rounds) on the same inputs")
    return launched, row


def rounds_tols(dtype: str) -> tuple[float, float]:
    """The max and mean tolerances of the rounds kernels against their
    plain versions in a state type."""
    return (TOL_F32, TOL_F32) if dtype == "float32" else (TOL_BF16_MAX, TOL_BF16_MEAN)


def kernel_and_plain(kernel: str, g, ops, w, xc, xq, s, rounds: int, dtype: str,
                     slot_dtype: str = "float32"):
    """``(run, plain)``: one call of K1's wrapper (``kernel`` 'k1', through
    ``decoder_rounds``) or K5's ('k5', its raster wrapper) on a case, and its
    plain version on the same inputs."""
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg

    if kernel == "k1":
        return (lambda: fd.decoder_rounds(xc, xq, s, ops, w, rounds, dtype),
                lambda: fd.rounds_plain(xc, xq, s, ops, w, rounds=rounds, state_dtype=dtype))
    r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(g), w, dtype)
    return (lambda: rg._roll_rounds_cuda(r_ops, rounds=rounds, slot_dtype=slot_dtype),
            lambda: rg.roll_rounds_plain(r_ops, rounds=rounds, slot_dtype=slot_dtype))


def rounds_f64(xc, xq, syn, ops, w, rounds: int, keeps: list | None = None):
    """The plain version's f32 rounds (``rounds_plain``) computed on f64
    tensors with no rounding: ``(xc, xq)`` in f64.  ``keeps``, a list,
    receives each round's ``(checks, qubits)`` dicts of what the adjoint
    reads (the LayerNorm's ``inv`` among them)."""
    from tpugnn_torch.kernels import fused_decoder as fd

    mats, vecs = (t.double() for t in fd.pack_weights_f32(w))
    src_c, mask_c, deg_c, src_q, mask_q, deg_q = ops
    same = lambda t: t
    xc, xq = xc.double(), xq.double()
    synterm = syn.reshape(xc.shape[0], xc.shape[1], 1).double() * vecs[2]
    for _ in range(rounds):
        kc, kq = {}, {}
        ys_c, ys_q = xq @ mats[7], xc @ mats[2]
        xc, xq = (
            fd._update(xc, ys_c, src_c, mask_c.double(), deg_c.double(), mats[0:5], vecs[0:7],
                       synterm, same, keep=kc),
            fd._update(xq, ys_q, src_q, mask_q.double(), deg_q.double(), mats[5:10], vecs[7:14],
                       0.0, same, keep=kq),
        )
        if keeps is not None:
            keeps.append((kc, kq))
    return xc, xq


def rounds_f64_chunked(xc, xq, syn, ops, w, rounds: int, chunk: int = 512):
    """:func:`rounds_f64` ``chunk`` samples at a time."""
    import torch

    outs = [rounds_f64(xc[i:i + chunk], xq[i:i + chunk], syn[i:i + chunk], ops, w, rounds)
            for i in range(0, xc.shape[0], chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def held_to_plain(run, plain, want: str, dtype: str, what: str) -> dict:
    """One untimed call of ``run`` against ``plain``: it must launch ``want``
    once and nothing else, and its states must be finite, of the plain
    version's shapes and within the state type's tolerance.  Raises
    otherwise; returns the errors and tolerances."""
    import torch

    with torch.inference_mode():
        reset_counts()
        kc, kq = run()
        launched = counts()
        pc, pq = plain()
        torch.cuda.synchronize()
        max_err, mean_err = raster_errors(kc, kq, pc, pq)
        finite = bool(torch.isfinite(kc.float()).all() and torch.isfinite(kq.float()).all())
        shapes = tuple(kc.shape) == tuple(pc.shape) and tuple(kq.shape) == tuple(pq.shape)
    tol_max, tol_mean = rounds_tols(dtype)
    res = dict(kernel=want, max_abs_err=max_err, mean_abs_err=mean_err, tol_max=tol_max,
               tol_mean=tol_mean)
    if launched[want] != 1 or sum(launched.values()) != 1:
        raise RuntimeError(f"{what}: launched {launched}, not one {want}")
    if not (finite and shapes) or max_err > tol_max or mean_err > tol_mean:
        raise RuntimeError(f"{what} disagrees with its plain version: {res}")
    return res


def rounds_vs_plain(kernel: str, d: int, h: int, dtype: str, seed: int, dev, want: str,
                    slot_dtype: str = "float32", mh: int | None = None) -> dict:
    """K1 ('k1') or K5 ('k5') on a random case of width ``h`` and message
    width ``mh`` (h by default; d, B=64, R=3) held to its plain version at
    that width (:func:`held_to_plain`): it must launch ``want``."""
    g, _, ops, w, xc, xq, s, _ = random_round_case(d, D13_BATCH, D13_ROUNDS, dtype, seed, dev,
                                                   h=h, mh=mh)
    run, plain = kernel_and_plain(kernel, g, ops, w, xc, xq, s, D13_ROUNDS, dtype, slot_dtype)
    res = held_to_plain(run, plain, want, dtype,
                        f"{kernel} d={d} H={h} MH={mh or h} {dtype} slots {slot_dtype}")
    return dict(d=d, width=h, msg_width=mh or h, dtype=dtype, batch=D13_BATCH,
                rounds=D13_ROUNDS, **res)


def k5_f32_kernel(d: int) -> str:
    """The f32 K5 kernel the wrapper launches at distance d: its
    shared-panel kernel where that fits, else the global-panel variant."""
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.kernels._build import load_library
    from tpugnn_torch.tanner import build_code

    l_pad = rg.plan_for_graph(build_code("surface", d)).l_pad
    smem = load_library("roll_gather_tf32").roll_rounds_smem_bytes(0, l_pad)
    return "roll_rounds" if smem <= fd.SMEM_LIMIT else "roll_rounds_gpanels"


def f32_rounds_timing(kernel: str, d: int, dev, seed: int) -> dict:
    """An f32 rounds kernel at the trained configs' shapes (B=4096,
    R=TRAINED_ROUNDS, random full-width weights): K1 ('fused_rounds'), or
    K5 ('roll_rounds' or 'roll_rounds_gpanels', whichever the raster calls
    for).  One call held
    to the plain version (:func:`held_to_plain`), its time, the plain
    version's, and the bound on the graph's real rows: its products at
    three TF32 products each on the tensor cores (``f32_core_ms`` beside
    it, the same products on the CUDA cores)."""
    import torch

    r, h = TRAINED_ROUNDS, 128
    g, _, ops, w, xc, xq, s, _ = random_round_case(d, B, r, "float32", seed, dev)
    run, plain = kernel_and_plain("k1" if kernel == "fused_rounds" else "k5",
                                  g, ops, w, xc, xq, s, r, "float32")
    res = held_to_plain(run, plain, kernel, "float32", f"{kernel} at d={d}, B={B}, R={r}")
    with torch.inference_mode():
        ms = time_ms(run, warmup=1, iters=3)
        plain_ms = time_ms(plain, warmup=0, iters=1)
    flops = rounds_flops(g, h) * B * r
    b_ms, b_by = bound(rounds_bytes(g, B, h, 4), 3 * flops, H100_TF32_FLOPS)
    torch.cuda.empty_cache()
    return dict(d=d, batch=B, rounds=r, dtype="float32", real_rows=g.n_checks + g.n_qubits,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                tflops=flops / (ms * 1e-3) / 1e12, tf32x3_floor_ms=tf32x3_floor_ms(flops),
                f32_core_ms=flops / H100_F32_FLOPS * 1e3, **res)


def padded_width_timing(d: int, h: int, dev, seed: int) -> dict:
    """K1 and K5 at distance d with a width-h model (zero-padded to 128) and
    with a 128-wide one, B=4096, R=8, in f32 and bf16 (one wrapper call
    each, its padding inside): each call first held to its plain version
    (:func:`held_to_plain`; ``<kernel>_max_abs_err_<dtype>_h<width>``),
    then timed.  A padded model runs the 128-wide work, where a kernel built
    for h would need (h/128)^2 of the products.  Beside them the bound of
    the width-h work."""
    import torch

    rounds = 8
    out = dict(d=d, width=h, batch=B, rounds=rounds)
    for dtype in ("float32", "bfloat16"):
        for width in (h, 128):
            g, _, ops, w, xc, xq, s, _ = random_round_case(d, B, rounds, dtype, seed, dev,
                                                           h=width)
            for kernel, want in (("k1", "fused_rounds"), ("k5", "roll_rounds")):
                run, plain = kernel_and_plain(kernel, g, ops, w, xc, xq, s, rounds, dtype)
                res = held_to_plain(run, plain, want, dtype,
                                    f"{kernel} d={d} H={width} B={B} R={rounds} {dtype}")
                out[f"{kernel}_max_abs_err_{dtype}_h{width}"] = res["max_abs_err"]
                with torch.inference_mode():
                    out[f"{kernel}_ms_{dtype}_h{width}"] = time_ms(run, warmup=1, iters=3)
                del run, plain
            itemsize = 4 if dtype == "float32" else 2
            flops = rounds_flops(g, width) * B * rounds
            nbytes = rounds_bytes(g, B, width, itemsize)
            if dtype == "float32":    # K1's and K5's products run as 3xTF32
                for kernel in ("k1", "k5"):
                    out[f"{kernel}_bound_ms_{dtype}_h{width}"] = bound(
                        nbytes, 3 * flops, H100_TF32_FLOPS)[0]
                    out[f"{kernel}_f32_core_ms_{dtype}_h{width}"] = flops / H100_F32_FLOPS * 1e3
            else:
                for kernel in ("k1", "k5"):
                    out[f"{kernel}_bound_ms_{dtype}_h{width}"] = bound(
                        nbytes, flops, H100_BF16_FLOPS)[0]
    return out


def rounds_kernel_times() -> dict:
    """The rounds kernels' times on one card, by CUDA events, each one call
    of the wrapper the main path calls, on seeded random full-width weights
    (``scripts/smoke_turns.py --kernels`` runs this in turns on two
    checkouts; it needs only the checkout's ``tpugnn_torch`` on
    ``sys.path``), at B=4096:

    * ``k1_bf16``, ``k5_bf16``: K1 and K5 at the bench config (d=11, R=8,
      bf16);
    * ``k1_f32``, ``k5_f32``: K1 and K5 at the trained decode's shape (d=11,
      R=14, f32 states);
    * ``k2a_bf16``, ``k2b_bf16``, ``k2a_f32``, ``k2b_f32``: K2a and K2b at
      the training shape (d=11, R=14) with bf16 and with f32 states;
    * ``k1_d7c_bf16``, ``k2a_d7c_bf16``, ``k2b_d7c_bf16``: K1, K2a and K2b
      on circuit d=7 (bf16, R=8, the checkpoint's training shape), and
      ``k1_d13_f32``, ``k2a_d13_f32``, ``k2b_d13_f32`` on surface d=13
      (f32, R=14): the largest graphs of the training and decode paths;
    * ``k1w_bf16``, ``k2aw_bf16``, ``k2bw_bf16``, ``k5w_bf16`` and the same
      with ``_f32``: the wide widths (phase 6d's ``wide_timing`` inputs:
      d=11, H = MH = WIDE_H, B=WIDE_TIMING_BATCH, R=WIDE_TIMING_ROUNDS), each
      call held to one launch of its wide kernel."""
    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.kernels._build import SOURCES, build_libraries
    from tpugnn_torch.tanner import build_circuit_code

    def launched_once(name, fn):
        before = counts()[name]
        fn()
        torch.cuda.synchronize()
        if counts()[name] != before + 1:
            raise RuntimeError(f"{name} was not launched")

    t0 = time.perf_counter()
    build_libraries([n for n in SOURCES if n not in ("spmm", "sddmm")])
    out = dict(build_seconds=round(time.perf_counter() - t0, 1))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        g, _, ops, w, xc, xq, s, _ = random_round_case(D, B, 8, "bfloat16", 13, dev)
        out["k1_bf16"] = time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, w, 8, "bfloat16"))
        r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(g), w, "bfloat16")
        out["k5_bf16"] = time_ms(lambda: rg._roll_rounds_cuda(r_ops, rounds=8))
        r = TRAINED_ROUNDS
        g, _, ops, w, xc, xq, s, _ = random_round_case(D, B, r, "float32", 6, dev)
        r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(g), w, "float32")
        out["k1_f32"] = time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, w, r, "float32"),
                                warmup=2, iters=7)
        out["k5_f32"] = time_ms(lambda: rg._roll_rounds_cuda(r_ops, rounds=r), warmup=2,
                                iters=7)
        del r_ops, xc, xq, s
    cases = (("", D, None, "bfloat16", "bf16", TRAINED_ROUNDS, False),
             ("", D, None, "float32", "f32", TRAINED_ROUNDS, False),
             ("_d7c", 7, build_circuit_code("surface", 7, 7), "bfloat16", "bf16", 8, True),
             ("_d13", 13, None, "float32", "f32", TRAINED_ROUNDS, True))
    for tag, d, graph, dtype, ttag, r, with_k1 in cases:
        with torch.no_grad():
            _, _, ops, w, xc, xq, s, gen = random_round_case(d, B, r, dtype, 10, dev, graph=graph)
            if with_k1:
                out[f"k1{tag}_{ttag}"] = time_ms(
                    lambda: fd.decoder_rounds(xc, xq, s, ops, w, r, dtype), warmup=1, iters=5)
            mats32, vecs32 = fd.pack_weights_f32(w)
            cot_c = torch.randn(xc.shape, generator=gen, device=dev)
            cot_q = torch.randn(xq.shape, generator=gen, device=dev)
            out[f"k2a{tag}_{ttag}"] = time_ms(lambda: fb._fwd_stash_cuda(
                xc, xq, s, ops, mats32, vecs32, r, dtype), warmup=2, iters=7)
            _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, r, dtype)
            out[f"k2b{tag}_{ttag}"] = time_ms(lambda: fb._bwd_cuda(
                sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dtype), warmup=1, iters=3)
            del sc, sq, xc, xq, s, cot_c, cot_q
        torch.cuda.empty_cache()
    r = WIDE_TIMING_ROUNDS
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        with torch.no_grad():
            g, _, ops, w, xc, xq, s, gen = random_round_case(D, WIDE_TIMING_BATCH, r, dtype, 95,
                                                             dev, h=WIDE_H)
            mats32, vecs32 = fd.pack_weights_f32(w)
            cot_c = torch.randn(xc.shape, generator=gen, device=dev)
            cot_q = torch.randn(xq.shape, generator=gen, device=dev)
            _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, r, dtype)
            r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(g), w, dtype)
            for key, name, fn, iters in (
                    ("k1w", "fused_rounds_wide",
                     lambda: fd.decoder_rounds(xc, xq, s, ops, w, r, dtype), 5),
                    ("k2aw", "fused_rounds_fwd_stash_wide",
                     lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, r, dtype), 5),
                    ("k2bw", "fused_rounds_bwd_wide",
                     lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dtype),
                     3),
                    ("k5w", "roll_rounds_wide", lambda: rg._roll_rounds_cuda(r_ops, rounds=r),
                     5)):
                launched_once(name, fn)
                out[f"{key}_{tag}"] = time_ms(fn, warmup=1, iters=iters)
            del sc, sq, r_ops, xc, xq, s, cot_c, cot_q
        torch.cuda.empty_cache()
    return out


def width_train_config(dtype: str, steps: int, mh: int = 64):
    """A width-64 model trained through K2a/K2b (zero-padded to 128): the
    flagship training recipe at d=11 with H = 64, MH = ``mh`` (64 by
    default), R=3, batch 256."""
    from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig

    return ExperimentConfig(
        code=CodeConfig(family="surface", distance=D, p=0.05),
        model=ModelConfig(hidden=64, msg_hidden=mh, rounds=D13_ROUNDS, backend="fused",
                          readout="both", qubit_head="pauli4", dtype=dtype),
        train=TrainConfig(batch=256, steps=steps, lr=1e-3, warmup_steps=200,
                          eval_every=1000, eval_shots=1024, seed=0, p_mix=(0.01, 0.05)))


def width_case(dtype: str, dev, seed: int = 70, mh: int = 64) -> dict:
    """K2a/K2b for a model of width 64 and message width ``mh`` (states and
    packs zero-padded to 128 outside the autograd Function; with mh > 64
    the packs at mh first) on a random case (d=11, B=64, R=3, made from
    ``seed``), with the launches and the tolerances of the width-128
    checks; gates nothing (:func:`train_width_check` does):

    * the whole path: the outputs and every gradient leaf (both states and
      the 25 round-weight leaves, at width 64) through the kernels under
      autograd against the plain versions under autograd (``k2a_vs_plain``,
      ``whole_path_worst_rel``).  Each backward replays its own forward, so
      a relu that K2a's rounding flips takes a whole autograd path with it;
    * K2b against ``rounds_vjp_plain``, both fed K2a's stash of the same
      call, as the width-128 check is (``k2b_worst_rel``: dxc, dxq, dsyn
      and the 25 leaves at width 64)."""
    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    h = 64
    _, _, ops, w, xc, xq, s, gen = random_round_case(D, D13_BATCH, D13_ROUNDS, dtype, seed,
                                                     dev, h=h, mh=mh)
    wid = fd.pack_width(w)
    cot_c = torch.randn(xc.shape, generator=gen, device=dev)
    cot_q = torch.randn(xq.shape, generator=gen, device=dev)

    def run(kernels):
        leaves = [t.clone().requires_grad_(True) for t in w]
        xs = [xc.clone().requires_grad_(True), xq.clone().requires_grad_(True)]
        with torch.enable_grad():
            oc, oq = fb.trained_rounds(xs[0], xs[1], s, ops, fd.RoundWeights(*leaves),
                                       D13_ROUNDS, dtype, kernels=kernels)
            ((oc * cot_c).sum() + (oq * cot_q).sum()).backward()
        return oc.detach(), oq.detach(), [t.grad for t in xs + leaves]

    reset_counts()
    kc, kq, kg = run(True)
    launched = counts()
    pc, pq, pg = run(False)
    torch.cuda.synchronize()
    names = ("dxc", "dxq") + fd.RoundWeights._fields
    whole = {n: rel_err(a, b) for n, a, b in zip(names, kg, pg)}
    whole_worst = max(whole, key=whole.get)
    shapes = all(tuple(a.shape) == tuple(b.shape) == tuple(t.shape)
                 for a, b, t in zip(kg, pg, [xc, xq, *w]))
    max_err, mean_err = raster_errors(kc, kq, pc, pq)

    # both backward versions read the kernel's stash, on the padded operands
    # as padded_rounds hands them over; the gradients sliced to width 64
    # (the packs' to their width)
    mats32, vecs32 = fd.pad_packs(*fd.pack_weights_f32(w))
    xcp, xqp, ccp, cqp = fd.pad_states(xc, xq, cot_c, cot_q)
    with torch.no_grad():
        _, _, sc, sq = fb._fwd_stash_cuda(xcp, xqp, s, ops, mats32, vecs32, D13_ROUNDS,
                                          dtype, h)
        kg_s = fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, ccp, cqp, dtype, h, mh)
        pg_s = fb.rounds_vjp_plain(sc, sq, s, ops, mats32, vecs32, ccp, cqp,
                                   state_dtype=dtype, width=h)
        torch.cuda.synchronize()
    at_h = lambda g: (g[0][..., :h], g[1][..., :h], g[2], g[3][:, :wid, :wid], g[4][:, :wid])
    rels = grad_errors(w, at_h(kg_s), at_h(pg_s))
    worst = max(rels, key=rels.get)
    tol_max, tol_mean = rounds_tols(dtype)
    tol_rel = TOL_GRAD_REL_F32 if dtype == "float32" else TOL_GRAD_REL_BF16
    return dict(width=h, msg_width=mh, batch=D13_BATCH, rounds=D13_ROUNDS, launches=launched,
                k2a_vs_plain_max=max_err, k2a_vs_plain_mean=mean_err,
                k2b_worst_rel=rels[worst], k2b_worst_leaf=worst, k2b_rel=rels,
                whole_path_worst_rel=whole[whole_worst], whole_path_worst_leaf=whole_worst,
                whole_path_rel=whole, tol_max=tol_max, tol_mean=tol_mean, tol_rel=tol_rel,
                grads_at_model_width=shapes)


def train_width_check(dtype: str, dg, dev, mh: int = 64) -> dict:
    """K2a/K2b for a model of width 64 and message width ``mh``: (1)
    :func:`width_case`, gated as at
    128: K2a's outputs against the plain version's, K2b's gradient leaves
    against ``rounds_vjp_plain`` on K2a's stash; in bf16 the whole path's
    leaves too (in f32 reported only: a relu that K2a's 3xTF32 rounding
    flips decides a whole autograd path there); (2) TRAIN_CHECK_STEPS train
    steps from the state of a WIDTH_TRAIN_STEPS-step run through K2a/K2b
    and through the plain versions (train_steps_vs_plain), each
    parameter's change gated at TRAIN_STEP_REL."""
    import torch

    from tpugnn_torch.train import train

    out = width_case(dtype, dev, mh=mh)
    what = f"H=64 MH={mh} {dtype}"
    launched = out["launches"]
    want = {"fused_rounds_fwd_stash": 1, "fused_rounds_bwd": 1}
    if any(launched[k] != v for k, v in want.items()) or sum(launched.values()) != 2:
        raise RuntimeError(f"{what}: launched {launched}, not one K2a and one K2b")
    if (not out["grads_at_model_width"] or out["k2a_vs_plain_max"] > out["tol_max"]
            or out["k2a_vs_plain_mean"] > out["tol_mean"]
            or out["k2b_worst_rel"] > out["tol_rel"]
            or (dtype == "bfloat16" and out["whole_path_worst_rel"] > out["tol_rel"])):
        raise RuntimeError(f"{what}: K2a/K2b disagree with the plain versions: {out}")

    cfg = width_train_config(dtype, WIDTH_TRAIN_STEPS, mh)
    state, _, _, _ = train(cfg, device="cuda", log=lambda msg: None)
    step_errs = train_steps_vs_plain(state, cfg, dg, dev)
    k_worst = [max(e.items(), key=lambda kv: kv[1]) for e in step_errs["kernels"]]
    out["steps_vs_plain"] = dict(
        warmup_steps=WIDTH_TRAIN_STEPS, steps=TRAIN_CHECK_STEPS, bound=TRAIN_STEP_REL,
        kernels_worst=[dict(leaf=n, rel=v) for n, v in k_worst],
        zero_wgrads_least=[dict(leaf=n, rel=v) for n, v in (
            min(((n, v) for n, v in e.items() if n.startswith("rounds.")), key=lambda kv: kv[1])
            for e in step_errs["zero_wgrads"])])
    if any(v > TRAIN_STEP_REL for _, v in k_worst):
        raise RuntimeError(f"{what}: steps through K2a/K2b move the parameters "
                           f"otherwise than their plain versions: {out['steps_vs_plain']}")
    del state
    torch.cuda.empty_cache()
    return out


def consistent(graph, corr, syn) -> bool:
    """Every correction [B, n, 2] reproduces its syndrome [B, >= m]; the
    parity products run on the graph's device (``graph``: tensors)."""
    import torch

    n, m = graph.n_qubits, graph.n_checks
    dev = graph.h_syn_ex.device
    c = torch.from_numpy(corr).to(dev).float()
    s_hat = torch.remainder(c[:, :, 0] @ graph.h_syn_ex[:m, :n].T
                            + c[:, :, 1] @ graph.h_syn_ez[:m, :n].T, 2.0)
    return bool(torch.equal(s_hat, torch.from_numpy(syn[:, :m]).to(dev).float()))


def padded_chunks(graph, syn):
    """A request's syndromes as the engine sends them: f32 [B, m_pad]
    chunks zero-padded to B rows, each with its number of real rows."""
    import numpy as np

    full = np.zeros((syn.shape[0], graph.n_checks_pad), np.float32)
    full[:, :syn.shape[1]] = syn
    for lo in range(0, syn.shape[0], B):
        part = full[lo:lo + B]
        chunk = np.zeros((B, graph.n_checks_pad), np.float32)
        chunk[:len(part)] = part
        yield chunk, len(part)


class HostDecoderCalls:
    """Counts the calls of the host decoders (union-find and each MWPM
    sector) while it is entered, from any thread."""

    def __enter__(self):
        import threading

        from tpugnn_torch.baselines import mwpm, union_find

        self.n, lock = 0, threading.Lock()
        self._orig = [(union_find.UnionFindDecoder, union_find.UnionFindDecoder.decode),
                      (mwpm.MWPMSectorDecoder, mwpm.MWPMSectorDecoder.decode)]

        def counted(f):
            def g(*a, **kw):
                with lock:
                    self.n += 1
                return f(*a, **kw)
            return g

        for cls, f in self._orig:
            cls.decode = counted(f)
        return self

    def __exit__(self, *exc):
        for cls, f in self._orig:
            cls.decode = f
        return False


def serve_references(mode: str, kw: dict, eng, graph, dev, reqs, outs) -> dict:
    """The serve outputs of ``mode`` against eval/hybrid on the same padded
    chunks: 'uf'/'mwpm' against gnn_cleanup_corrections, 'best_of' with
    lazy=False against min_weight_select over the candidates eval/hybrid
    builds; bit for bit.  Returns the number of shots compared."""
    import numpy as np
    import torch

    from tpugnn_torch.baselines import MWPMDecoder, UnionFindDecoder
    from tpugnn_torch.eval import gnn_cleanup_corrections
    from tpugnn_torch.eval.hybrid import _chunk, _HostCopy, lazy_decode, min_weight_select

    n = graph.n_qubits
    uf, mw = UnionFindDecoder(graph), MWPMDecoder(graph, p=eng.cfg.code.p)
    nll = kw.get("select_cost") == "nll"
    temp = float(os.environ.get("TPUGNN_NLL_TEMP", "1.0"))
    dg = graph.to(dev)
    compared = 0
    for r, o in zip(reqs, outs):
        want = []
        for chunk, nb in padded_chunks(graph, r):
            if mode in ("uf", "mwpm"):
                ex, ez = gnn_cleanup_corrections(eng.model, graph, chunk,
                                                 uf if mode == "uf" else mw, device=dev)
            else:
                h = _HostCopy(_chunk(eng.model, dg, torch.from_numpy(chunk).to(dev), None,
                                     with_nlp=nll, nll_temp=temp)).numpy()
                exg, ezg, s_res = h["ex_g"][:, :n], h["ez_g"][:, :n], h["s_res"]
                exu, ezu = lazy_decode(uf, s_res)
                exm, ezm = lazy_decode(mw, s_res)
                cands = {"qubit": (exg, ezg), "logical": (h["lex"][:, :n], h["lez"][:, :n]),
                         "gnn_uf": (exg ^ exu, ezg ^ ezu), "gnn_mwpm": (exg ^ exm, ezg ^ ezm),
                         "mwpm": mw.decode(chunk.astype(np.uint8))}
                syn_u8 = chunk.astype(np.uint8)
                ex, ez, _ = min_weight_select(
                    tuple(cands), cands, syn_u8, eng._hz, eng._hx,
                    qubit_inconsistent=s_res.any(axis=1),
                    nlp=h["nlp"][:, :n] if nll else None)
            want.append(np.stack([ex, ez], axis=-1)[:nb])
        if not np.array_equal(o, np.concatenate(want)):
            raise RuntimeError(f"serve {mode} {kw}: the engine's corrections differ from "
                               f"eval/hybrid's on the same syndromes")
        compared += o.shape[0]
    return compared


def phase_serve_cleanup(graph, dev, reqs, info: dict) -> dict:
    """Phase 3's cleanup modes (SERVE_MODES): for each, a DecodeEngine on
    the trained d=11 weights answers the same requests of 1, 1000 and 5000
    syndromes as the cleanup=None engine.  Gates: every output is
    syndrome-consistent; every request launches K1 once per chunk and no
    other kernel; 'uf'/'mwpm' equal gnn_cleanup_corrections and 'best_of'
    with lazy=False equals min_weight_select over eval/hybrid's candidates
    on the same padded chunks, bit for bit; lazy best_of is never lighter
    than the eager engine's answer on a shot, and best_of_device's mean
    weight is at most BEST_OF_DEVICE_WEIGHT_RATIO times the eager best_of's
    (tests/test_serve.py); 'device' calls no host decoder and its repair
    tables sit on the card.  Reported per mode: decoded shots/s of
    4096-syndrome requests (median of SERVE_TIMED) and of one 4 x 4096
    request (the in-flight window), each with the host tail's ms and the
    device span's ms per chunk (the engine's ``timing``).  Returns the
    launches of the modes' requests, by mode."""
    import numpy as np
    import torch

    from tpugnn_torch.eval.hybrid import _chunk
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.serve import DecodeEngine

    dg = graph.to(dev)
    timed = sample_batch(torch.Generator(device=dev).manual_seed(2026), dg, 0.05,
                         4 * B).syndrome.cpu().numpy().astype(np.uint8)
    out_launches, weights = {}, {}
    for mode, kw in SERVE_MODES:
        name = "_".join([mode] + [f"{k}_{v}" for k, v in sorted(kw.items())])
        launched = dict.fromkeys(counts(), 0)

        def request(r):
            reset_counts()
            out = eng.decode(r)
            c = counts()
            want = {**dict.fromkeys(c, 0), "fused_rounds": -(-r.shape[0] // B)}
            if c != want:
                raise RuntimeError(f"serve {name}: a request of {r.shape[0]} launched {c}, "
                                   f"not {want['fused_rounds']} K1 and nothing else")
            for k, v in c.items():
                launched[k] += v
            return out

        with HostDecoderCalls() as calls, DecodeEngine.from_npz(
                device=dev, max_batch=B, cleanup=mode, **kw) as eng:
            outs = [request(r) for r in reqs]
            walls = []
            eng.reset_timing()
            for _ in range(SERVE_TIMED):
                t0 = time.perf_counter()
                request(timed[:B])
                walls.append((time.perf_counter() - t0) * 1e3)
            one = dict(eng.timing)
            eng.reset_timing()
            t0 = time.perf_counter()
            request(timed)
            wall4 = (time.perf_counter() - t0) * 1e3
            four = dict(eng.timing)
            host_calls = calls.n
            res = dict(mode=mode, **kw, requests=[int(r.shape[0]) for r in reqs],
                       host_decoder_calls=host_calls, launches=launched)
            for r, o in zip(reqs, outs):
                if o.shape != (r.shape[0], graph.n_qubits, 2) or not consistent(dg, o, r):
                    raise RuntimeError(f"serve {name}: an output of shape {o.shape} is not "
                                       f"syndrome-consistent")
            if mode in ("uf", "mwpm") or (mode == "best_of" and not kw.get("lazy")):
                res["equal_to_eval_hybrid_shots"] = serve_references(
                    mode, kw, eng, graph, dev, reqs, outs)
            if mode == "device":
                # DeviceRepair alone on the residuals of a 4096-shot chunk
                with torch.inference_mode():
                    s_res = _chunk(eng.model, dg, torch.from_numpy(timed[:B]).to(dev).float(),
                                   None, with_logical=False)["s_res"].float()
                    res["repair_ms_per_chunk"] = time_ms(lambda: eng._repair.repair(s_res))
                    res["residual_defects_per_shot"] = float(s_res.sum(1).mean())
            if mode in ("device", "best_of_device"):
                res["repair_device"] = str(eng._repair._x[0].device)
                if eng._repair._x[0].device.type != dev.type:
                    raise RuntimeError(f"serve {name}: the repair tables are not on the card")
            if mode == "device" and host_calls:
                raise RuntimeError(f"serve {name}: {host_calls} host decoder calls")
        wall = statistics.median(walls)
        per = lambda a, b: None if a is None else a / b
        res.update(
            shots_per_s_4096=B / (wall / 1e3), request_ms_4096=walls,
            host_ms_per_chunk=one["host_ms"] / one["chunks"],
            device_ms_per_chunk=per(one["device_ms"], one["chunks"]),
            host_share=one["host_ms"] / sum(walls), device_share=per(one["device_ms"], sum(walls)),
            shots_per_s_4x4096=4 * B / (wall4 / 1e3), request_ms_4x4096=wall4,
            host_share_4x4096=four["host_ms"] / wall4,
            device_share_4x4096=per(four["device_ms"], wall4))
        w = np.concatenate([(o[:, :, 0] | o[:, :, 1]).sum(axis=1) for o in outs])
        weights[name] = w
        if mode == "best_of" and kw.get("select_cost") == "weight":
            if kw.get("lazy"):
                res["lazy_never_lighter"] = bool((w >= weights["best_of_select_cost_weight"])
                                                 .all())
                if not res["lazy_never_lighter"]:
                    raise RuntimeError(f"serve {name}: a lazy answer is lighter than the "
                                       f"eager engine's")
        if mode == "best_of_device":
            ref_w = weights["best_of_select_cost_weight"].mean()
            res["mean_weight_vs_best_of"] = float(w.mean() / ref_w)
            if w.mean() > BEST_OF_DEVICE_WEIGHT_RATIO * ref_w:
                raise RuntimeError(f"serve {name}: mean weight {w.mean()} against best_of's "
                                   f"{ref_w}")
        info[name] = res
        out_launches[f"serve_{name}"] = launched
        torch.cuda.empty_cache()
    return out_launches


def phase_hybrid(graph, dev, trained, ev: dict, info: dict) -> dict:
    """The `hybrid` phase: ler_all_columns of the trained d=11 weights at
    p=0.05 on LER_SHOTS shots (B=4096, f32) from phase 4's seed, with
    best-of (weight rule), GNN+MWPM and the raw union-find and MWPM
    baselines.  Gates: ler, ler_logical and ler_hybrid equal phase 4's
    ler_monte_carlo exactly (the same generator draws); gnn_uf, gnn_mwpm
    and gnn_best_of within |z| <= HYBRID_Z of the JAX f32 columns of the
    same weights (the sidecar of the weights file); raw uf and mwpm, which
    depend on no network, within |z| <= HYBRID_Z of LER_TABLE.md:30;
    syn_mismatch 0 for every cleanup column; 16 K1 launches and nothing
    else.  Reported: every column's z against the table's row beside the
    2-stderr criterion, and the phase's host and device seconds.  Returns
    the run's launches."""
    import torch

    from tpugnn_torch.eval.hybrid import ler_all_columns
    from tpugnn_torch.models.convert import read_columns, read_meta

    ref = read_columns()
    meta = read_meta()
    if (ref["step"], ref["model"], ref["code"], ref["p"]) != (
            meta["step"], meta["model"], meta["code"], 0.05):
        raise RuntimeError(f"the columns sidecar is not of these weights at p=0.05: {ref}")
    reset_counts()
    gen = torch.Generator(device=dev).manual_seed(2025)
    cols = ler_all_columns(trained, graph, p=0.05, shots=LER_SHOTS, batch=B, generator=gen,
                           best_of=True, with_mwpm=True, with_uf_raw=True, device=dev)
    launched = counts()
    n = int(cols["shots"])
    jax_cols = ref["columns"]
    z_jax = {k: z_score(cols[k], n, jax_cols[k], ref["shots"])
             for k in ("gnn_uf", "gnn_mwpm", "gnn_best_of", "uf", "mwpm", "ler_logical",
                       "ler_hybrid", "ler")}
    z_table = {k: z_score(cols[k], n, v, REF_SHOTS) for k, v in TABLE_D11_P05.items()}
    plain = {k: (cols[k], ev[k]) for k in ("ler", "ler_logical", "ler_hybrid")}
    info.update(shots=n, batch=B, p=0.05, columns={k: cols[k] for k in TABLE_D11_P05},
                picked=cols["picked"], syn_mismatch=cols["syn_mismatch"],
                jax_f32=dict(shots=ref["shots"], seed=ref["seed"], columns=jax_cols),
                z_vs_jax_f32=z_jax, table=dict(shots=REF_SHOTS, columns=TABLE_D11_P05),
                z_vs_table=z_table,
                within_2_stderr_of_table={k: abs(v) <= 2 for k, v in z_table.items()},
                plain_equal_to_ler_phase={k: a == b for k, (a, b) in plain.items()},
                timing=cols["timing"], launches=launched)
    if any(a != b for a, b in plain.values()):
        raise RuntimeError(f"hybrid: the plain columns differ from phase 4's: {plain}")
    gated = {"gnn_uf": z_jax["gnn_uf"], "gnn_mwpm": z_jax["gnn_mwpm"],
             "gnn_best_of": z_jax["gnn_best_of"], "uf": z_table["uf"],
             "mwpm": z_table["mwpm"]}
    if any(abs(v) > HYBRID_Z for v in gated.values()):
        raise RuntimeError(f"hybrid: a column is off its reference: {gated}")
    if any(cols["syn_mismatch"].values()):
        raise RuntimeError(f"hybrid: a cleanup column left syndromes: {cols['syn_mismatch']}")
    chunks = LER_SHOTS // B
    if launched != {**dict.fromkeys(launched, 0), "fused_rounds": chunks}:
        raise RuntimeError(f"hybrid: launched {launched}, not {chunks} K1 and nothing else")
    return launched


def phase_checkpoints(dev, d11: dict, info: dict) -> dict:
    """The `checkpoints` phase: every surface-code checkpoint of
    benchmarks/LER_TABLE.md (CHECKPOINTS) through DecodeEngine.from_npz on
    the card and ler_monte_carlo at p=0.05 (SWEEP_SHOTS shots, B=4096, f32);
    d=11 takes phase 4's run of LER_SHOTS (``d11``: its LER and launches).  Gates: each
    run launched K1 (at W = 128; narrower models on padded widths) once a
    chunk and nothing else; both heads within |z| <= 4 of the JAX f32
    rate in the weights file.  Reported: the logical, hybrid and per-qubit
    z against the table's row beside the 2-stderr criterion (not gated: the
    table was taken on a TPU at one bf16 pass), and the decode ms of one
    4096-shot forward.  At d=13 and d=15 the roll path (K5's global-panel
    variant) decodes ROLL_CHECK_SHOTS of the same shots, and its per-shot
    decisions must agree with the fused decode's (>= MIN_SHOT_AGREE).
    Returns the launches of the phase's LER and roll runs."""
    import torch

    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models import PallasDecoder
    from tpugnn_torch.models.convert import read_meta
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.serve import DecodeEngine

    assets = os.path.join(REPO, "tpugnn_torch", "assets")
    total = dict.fromkeys(counts(), 0)
    for fname, d, h, rounds, line, t_log, t_hyb, t_qub in CHECKPOINTS:
        path = os.path.join(assets, fname)
        meta = read_meta(path)
        ref = meta["ler_reference"]
        m = meta["model"]
        if (meta["code"]["distance"], m["hidden"], m["msg_hidden"], m["rounds"]) != (d, h, h, rounds):
            raise RuntimeError(f"{fname}: config {meta['code']} {m}")
        if ref["p"] != 0.05:
            raise RuntimeError(f"{fname}: reference LER at p={ref['p']}")
        eng = DecodeEngine.from_npz(path, device="cuda", max_batch=B)
        graph, model = eng.graph, eng.model
        dgc = graph.to(dev)
        want = "fused_rounds"
        seed = 3000 + d
        if d == D:     # phase 4's run of the same weights
            ev, launched, seed = d11["ev"], d11["launches"], 2025
        else:
            reset_counts()
            ev = ler_monte_carlo(model, graph, p=0.05, shots=SWEEP_SHOTS, batch=B,
                                 generator=torch.Generator(device=dev).manual_seed(seed),
                                 device="cuda")
            launched = counts()
        n = int(ev["shots"])
        z = lambda rate, ref_rate, ref_n: z_score(rate, n, ref_rate, ref_n)
        res = dict(
            d=d, width=h, rounds=rounds, step=meta["step"], source=meta["source"],
            table_line=f"benchmarks/LER_TABLE.md:{line}", shots=n,
            ler_logical=ev["ler_logical"], ler_hybrid=ev["ler_hybrid"], ler_qubit=ev["ler"],
            jax_f32=dict(shots=ref["shots"], seed=ref["seed"], ler_logical=ref["ler_logical"],
                         ler_hybrid=ref["ler_hybrid"], ler_qubit=ref["ler"]),
            z_vs_jax_f32=dict(logical=z(ev["ler_logical"], ref["ler_logical"], ref["shots"]),
                              hybrid=z(ev["ler_hybrid"], ref["ler_hybrid"], ref["shots"]),
                              qubit=z(ev["ler"], ref["ler"], ref["shots"])),
            table=dict(shots=REF_SHOTS, ler_logical=t_log, ler_hybrid=t_hyb, ler_qubit=t_qub),
            z_vs_table=dict(logical=z(ev["ler_logical"], t_log, REF_SHOTS),
                            hybrid=z(ev["ler_hybrid"], t_hyb, REF_SHOTS),
                            qubit=z(ev["ler"], t_qub, REF_SHOTS)),
            kernel=want, padded_width=h < fd.WIDTH, launches=launched)
        res["within_2_stderr_of_table"] = {k: abs(v) <= 2 for k, v in res["z_vs_table"].items()}
        with torch.inference_mode():
            syn = sample_batch(torch.Generator(device=dev).manual_seed(seed + 1), dgc, 0.05,
                               B).syndrome
            res["decode_ms"] = time_ms(lambda: model(dgc, syn), warmup=1, iters=3)
        chunks = n // B
        others = {k: v for k, v in launched.items() if k != want and v}
        if launched[want] != chunks or others:
            raise RuntimeError(f"checkpoint d={d}: launched {launched}, expected {chunks} "
                               f"{want} and nothing else")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + (v if d != D else 0)
        if d >= 13:      # the same shots through the roll path, on the f32 K5 kernel
            pd = PallasDecoder(model, ("rollgather",))     # the raster calls for
            want_k5 = k5_f32_kernel(d)
            gen = torch.Generator(device=dev).manual_seed(seed)
            same = torch.zeros((), device=dev)
            reset_counts()
            with torch.inference_mode():
                for _ in range(ROLL_CHECK_SHOTS // B):
                    b = sample_batch(gen, dgc, 0.05, B)
                    fr, lr = shot_decisions(pd, dgc, b)
                    ff, lf = shot_decisions(model, dgc, b)
                    same += ((fr["fail_qubit"] == ff["fail_qubit"]) & (lr == lf).all(-1)).sum()
            roll = counts()
            res["roll"] = dict(shots=ROLL_CHECK_SHOTS, kernel=want_k5, launches=roll,
                               agreement_with_fused=float(same) / ROLL_CHECK_SHOTS)
            for k in ("roll_rounds", "roll_rounds_gpanels"):
                total[k] = total.get(k, 0) + roll[k]
            other = ({"roll_rounds", "roll_rounds_gpanels"} - {want_k5}).pop()
            if (roll[want_k5] != ROLL_CHECK_SHOTS // B or roll[other]
                    or res["roll"]["agreement_with_fused"] < MIN_SHOT_AGREE):
                raise RuntimeError(f"checkpoint d={d} on the roll path: {res['roll']}")
        info[f"d{d}"] = res
        if abs(res["z_vs_jax_f32"]["logical"]) > 4 or abs(res["z_vs_jax_f32"]["qubit"]) > 4:
            raise RuntimeError(f"checkpoint d={d}: LER off the JAX f32 reference: {res}")
        del eng, model
        torch.cuda.empty_cache()
    info.update(shots=SWEEP_SHOTS, shots_d11=LER_SHOTS, batch=B, p=0.05,
                min_shot_agreement=MIN_SHOT_AGREE)
    return total


def detector_k1_check(model, graph, dev, p: float = DETECTOR_P,
                      want: str = "fused_rounds", iters: int = 5, f64: bool = False) -> dict:
    """K1 on a detector graph (phase 4d's: M=64, N=176, Dc=6, Dq=2, width 96
    padded to 128, f32, R=8) at the monolithic decode's shapes (B=4096): the
    trained model's embedded states of shots sampled at ``p``, one call held
    to the plain version (:func:`held_to_plain`: ``want`` once), its time,
    the plain
    version's and its bound (the f32 CUDA-core floor on the real rows at the
    model's width).  With ``f64``, both also against the same rounds in f64
    (:func:`rounds_f64`): K1's max error there within K1_F64_RATIO times the
    plain f32 version's."""
    import torch

    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.sampling import sample_batch

    dg = graph.to(dev)
    cfg = model.cfg
    with torch.inference_mode():
        syn = sample_batch(torch.Generator(device=dev).manual_seed(41), dg, p, B).syndrome
        xc, xq, s_pm = model.embed(dg, syn)
        xq = xq.contiguous()
        w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
    ops = fd.make_operators(dg)
    run, plain = kernel_and_plain("k1", graph, ops, w, xc, xq, s_pm[..., None], cfg.rounds,
                                  cfg.dtype)
    res = held_to_plain(run, plain, want, cfg.dtype, f"K1 on the detector graph {graph.name}")
    if f64:
        with torch.inference_mode():
            exact = rounds_f64_chunked(xc, xq, s_pm[..., None], ops, w, cfg.rounds)
            k_max, _ = raster_errors(*run(), *exact)
            p_max, _ = raster_errors(*plain(), *exact)
        res.update(k1_vs_f64_max=k_max, plain_vs_f64_max=p_max, f64_ratio_bound=K1_F64_RATIO)
        if not k_max <= K1_F64_RATIO * p_max:
            raise RuntimeError(f"K1 on {graph.name} lies further from the f64 rounds than the "
                               f"plain f32 version does: {res}")
    with torch.inference_mode():
        ms = time_ms(run, warmup=1, iters=iters)
        plain_ms = time_ms(plain, warmup=0, iters=1)
    flops = rounds_flops(graph, cfg.hidden) * B * cfg.rounds
    # f32 K1 forms three TF32 products for each f32 one
    b_ms, b_by = bound(rounds_bytes(graph, B, cfg.hidden, 4), 3 * flops, H100_TF32_FLOPS)
    return dict(graph=graph.name, m_pad=graph.n_checks_pad, n_pad=graph.n_qubits_pad,
                dc=graph.deg_max_check, dq=graph.deg_max_qubit, width=cfg.hidden,
                batch=B, rounds=cfg.rounds, dtype=cfg.dtype, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, tf32x3_floor_ms=tf32x3_floor_ms(flops),
                f32_core_ms=flops / H100_F32_FLOPS * 1e3, **res)


def phase_detector_and_stream(dev, info: dict) -> tuple[dict, dict]:
    """The `detector_and_stream` phase: the detector-graph decode path.

    a. The monolithic detector decoder (tpugnn_torch/assets/
       spacetime_surface_d5_t5_h96_r8_4000.npz: H=96, R=8, bits, f32) on its
       detector graph through ler_all_columns at p=0.02 on LER_SHOTS shots
       (B=4096): every GNN column within |z| <= DETECTOR_Z of the JAX f32
       columns in its sidecar, raw union-find and MWPM within |z| <=
       DETECTOR_Z of LER_DETECTOR.md:41, no cleanup syndrome left, 16 K1
       launches (the shared-panel kernel) and nothing else; every column's
       z against the row reported; K1 held to its plain version on the
       graph and timed (:func:`detector_k1_check`); the decode ms of one
       4096-shot forward.
    b. ler_bp_osd at p=0.05 on SWEEP_SHOTS shots at d=11 and d=5, each within
       |z| <= DETECTOR_Z of LER_TABLE.md:26 / :14 with no syndrome mismatch,
       and no kernel launch; ler_bp beside it (rate and syndrome mismatch
       rate); BP's ms per 4096-shot chunk on the card and the OSD's host ms
       per chunk.
    c. The window decoder (spacetime_surface_d5_t5_w_h96_r8_4000.npz) in the
       five decoders of benchmarks/stream_quality.py on the numpy streams
       its sidecar's rates were measured on (the sidecar's settings):
       uf_stream and uf_monolithic equal to the JAX rates in the sidecar
       exactly; the three GNN adapters' failure counts within
       STREAM_FAIL_SLACK shots of the sidecar's JAX f32 counts; one K1
       launch per GNN window and nothing else; the z against the JAX rates
       and runs/stream_quality_w.json's row reported, with each adapter's
       ms per window and committed rounds per second.
    Returns ``(launches by path, K1's check on the detector graph)``."""
    import torch

    from tpugnn_torch.baselines import BPOSDDecoder
    from tpugnn_torch.baselines.bp import bp_posteriors
    from tpugnn_torch.eval import ler_bp, ler_bp_osd
    from tpugnn_torch.eval.hybrid import ler_all_columns
    from tpugnn_torch.models.convert import (DETECTOR_D5_WEIGHTS, STREAM_D5_WEIGHTS,
                                             load_decoder, read_columns, read_meta)
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.streaming import SlidingWindowDecoder, stream_ler
    from tpugnn_torch.tanner import build_code

    launches = {}
    chunks = LER_SHOTS // B

    # a. the monolithic detector decode
    ref, meta = read_columns(DETECTOR_D5_WEIGHTS), read_meta(DETECTOR_D5_WEIGHTS)
    if any(ref[k] != meta[k] for k in ("step", "source", "code", "model", "graph")) or \
            ref["p"] != DETECTOR_P:
        raise RuntimeError(f"the detector sidecar is not of these weights at p={DETECTOR_P}")
    _, model, graph = load_decoder(DETECTOR_D5_WEIGHTS, device=dev)
    reset_counts()
    cols = ler_all_columns(model, graph, p=DETECTOR_P, shots=LER_SHOTS, batch=B,
                           generator=torch.Generator(device=dev).manual_seed(2026),
                           best_of=True, with_mwpm=True, with_uf_raw=True, device=dev)
    launches["detector"] = launched = counts()
    n = int(cols["shots"])
    z_jax = {k: z_score(cols[k], n, ref["columns"][k], ref["shots"]) for k in ref["columns"]}
    z_row = {k: z_score(cols[k], n, v, DETECTOR_ROW_SHOTS) for k, v in DETECTOR_ROW.items()}
    dg = graph.to(dev)
    with torch.inference_mode():
        syn = sample_batch(torch.Generator(device=dev).manual_seed(42), dg, DETECTOR_P,
                           B).syndrome
        decode_ms = time_ms(lambda: model(dg, syn), warmup=1, iters=5)
    k1 = detector_k1_check(model, graph, dev)
    info["monolithic"] = dict(
        weights=os.path.relpath(DETECTOR_D5_WEIGHTS, REPO), graph=graph.name,
        m_pad=graph.n_checks_pad, n_pad=graph.n_qubits_pad, dc=graph.deg_max_check,
        dq=graph.deg_max_qubit, p=DETECTOR_P, shots=n, batch=B,
        columns={k: cols[k] for k in DETECTOR_ROW}, picked=cols["picked"],
        syn_mismatch=cols["syn_mismatch"],
        jax_f32=dict(shots=ref["shots"], seed=ref["seed"], columns=ref["columns"]),
        z_vs_jax_f32=z_jax, row=dict(line="benchmarks/LER_DETECTOR.md:41",
                                     shots=DETECTOR_ROW_SHOTS, columns=DETECTOR_ROW),
        z_vs_row=z_row, within_2_stderr_of_row={k: abs(v) <= 2 for k, v in z_row.items()},
        timing=cols["timing"], decode_ms=decode_ms, k1_vs_plain=k1, launches=launched)
    gated = {**{k: z_jax[k] for k in DETECTOR_GNN_COLUMNS}, "uf": z_row["uf"],
             "mwpm": z_row["mwpm"]}
    if any(abs(v) > DETECTOR_Z for v in gated.values()):
        raise RuntimeError(f"detector: a column is off its reference: {gated}")
    if any(cols["syn_mismatch"].values()):
        raise RuntimeError(f"detector: a cleanup column left syndromes: {cols['syn_mismatch']}")
    if launched != {**dict.fromkeys(launched, 0), "fused_rounds": chunks}:
        raise RuntimeError(f"detector: launched {launched}, not {chunks} K1 and nothing else")
    del model
    torch.cuda.empty_cache()

    # b. BP and BP+OSD-0
    for d, line, rate in BP_OSD_ROWS:
        g = build_code("surface", d)
        reset_counts()
        osd = ler_bp_osd(g, p=BP_OSD_P, shots=SWEEP_SHOTS, batch=B,
                         generator=torch.Generator(device=dev).manual_seed(3100 + d),
                         device=dev)
        bp = ler_bp(g, p=BP_OSD_P, shots=SWEEP_SHOTS, batch=B,
                    generator=torch.Generator(device=dev).manual_seed(3100 + d), device=dev)
        launched = counts()
        dec = BPOSDDecoder(g, p=BP_OSD_P, device=dev)
        dgb = g.to(dev)
        with torch.inference_mode():
            syn = sample_batch(torch.Generator(device=dev).manual_seed(3200 + d), dgb,
                               BP_OSD_P, B).syndrome
            bp_ms = time_ms(lambda: bp_posteriors(dgb, syn, BP_OSD_P), warmup=1, iters=5)
        post = dec.posteriors(syn)
        osd_ms = host_ms(lambda: dec.osd(*post))
        z = z_score(osd["ler"], int(osd["shots"]), rate, REF_SHOTS)
        info[f"bp_osd_d{d}"] = dict(
            p=BP_OSD_P, shots=int(osd["shots"]), ler_bp_osd=osd["ler"],
            syn_mismatch_rate=osd["syn_mismatch_rate"],
            table=dict(line=f"benchmarks/LER_TABLE.md:{line}", shots=REF_SHOTS, ler=rate),
            z_vs_table=z, ler_bp=bp["ler"], bp_syn_mismatch_rate=bp["syn_mismatch_rate"],
            bp_ms_per_chunk=bp_ms, osd_host_ms_per_chunk=osd_ms, batch=B,
            launches=launched)
        if abs(z) > DETECTOR_Z or osd["syn_mismatch_rate"] != 0.0:
            raise RuntimeError(f"BP+OSD d={d}: {info[f'bp_osd_d{d}']}")
        if any(launched.values()):
            raise RuntimeError(f"BP+OSD d={d} launched a kernel: {launched}")

    # c. the streaming decoders
    side, meta = read_columns(STREAM_D5_WEIGHTS), read_meta(STREAM_D5_WEIGHTS)
    st = side["stream"]
    if any(side[k] != meta[k] for k in ("step", "source", "code", "model", "graph")):
        raise RuntimeError("the stream sidecar is not of these weights")
    _, wmodel, _ = load_decoder(STREAM_D5_WEIGHTS, device=dev)
    w, c, rounds = st["window"], st["commit"], st["rounds"]
    gnn = dict(window=w, commit=c, model=wmodel, device=dev)
    decoders = {
        "gnn_stream": SlidingWindowDecoder.from_gnn("surface", 5, **gnn),
        "gnn_uf_stream": SlidingWindowDecoder.from_gnn_cleanup("surface", 5, **gnn),
        "gnn_dev_stream": SlidingWindowDecoder.from_gnn_device("surface", 5, **gnn),
        "uf_stream": SlidingWindowDecoder.from_union_find("surface", 5, window=w, commit=c),
        "uf_monolithic": SlidingWindowDecoder.from_union_find("surface", 5, window=rounds,
                                                              commit=rounds),
    }
    stream = {}
    reset_counts()
    for name, dec in decoders.items():
        r = stream_ler(dec, p=st["p"], rounds=rounds, shots=st["shots"], seed=st["seed"],
                       batch=st["batch"])
        jax_rate, row_rate = st["rates"][name], STREAM_ROW[name]
        stream[name] = dict(
            ler=r["ler"], jax_f32=jax_rate, row=row_rate,
            fails=round(r["ler"] * st["shots"]), jax_f32_fails=round(jax_rate * st["shots"]),
            z_vs_jax_f32=z_score(r["ler"], st["shots"], jax_rate, st["shots"]),
            z_vs_row=z_score(r["ler"], st["shots"], row_rate, st["shots"]),
            windows=r["windows"], ms_per_window=r["decode_seconds"] * 1e3 / r["windows"],
            committed_rounds_per_s=st["shots"] * rounds / r["decode_seconds"])
    launches["stream"] = launched = counts()
    gnn_windows = sum(stream[k]["windows"] for k in ("gnn_stream", "gnn_uf_stream",
                                                      "gnn_dev_stream"))
    info["stream"] = dict(weights=os.path.relpath(STREAM_D5_WEIGHTS, REPO),
                          **{k: st[k] for k in ("p", "window", "commit", "rounds", "seed",
                                                "batch", "shots")},
                          row="runs/stream_quality_w.json (d=5, p=0.02)", decoders=stream,
                          launches=launched)
    for name in ("uf_stream", "uf_monolithic"):
        if stream[name]["ler"] != st["rates"][name]:
            raise RuntimeError(f"stream: {name} {stream[name]} differs from the JAX rate "
                               f"on the same streams")
    for name in ("gnn_stream", "gnn_uf_stream", "gnn_dev_stream"):
        if abs(stream[name]["fails"] - stream[name]["jax_f32_fails"]) > STREAM_FAIL_SLACK:
            raise RuntimeError(f"stream: {name} fails more than {STREAM_FAIL_SLACK} shots "
                               f"apart from JAX f32 on the same streams: {stream[name]}")
    if launched != {**dict.fromkeys(launched, 0), "fused_rounds": gnn_windows}:
        raise RuntimeError(f"stream: launched {launched}, not {gnn_windows} K1 (one per "
                           f"GNN window) and nothing else")
    return launches, k1


def circuit_decode(dev, info: dict) -> tuple[dict, dict]:
    """Part (a) of the circuit_and_cli phase: every checkpoint of
    CIRCUIT_CHECKPOINTS from its weights file (load_decoder builds the
    circuit graph its record names) decoded on the card in f32 at
    CIRCUIT_P on CIRCUIT_SHOTS shots (B=4096): both heads within |z| <=
    CIRCUIT_Z of the JAX f32 rate in the weights file, the K1 variant its
    graph calls for launched once a chunk and nothing else, every head's z
    against the table's row reported.  CIRCUIT_COLUMNS runs
    ler_all_columns with the NLL rule instead (its plain columns are
    ler_monte_carlo's on the same shots): every GNN column within |z| <=
    CIRCUIT_Z of the sidecar's JAX f32 columns, the raw union-find and MWPM
    of the table's row, no syndrome left.  On each graph K1 held to its
    plain version at B=4096, R=8 and both to the rounds in f64, and timed
    beside its bound (:func:`detector_k1_check`), and one 4096-shot forward
    timed.  Returns
    ``(launches by checkpoint, K1's check by graph)``."""
    import torch

    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.eval.hybrid import ler_all_columns
    from tpugnn_torch.models.convert import load_decoder, read_columns, read_meta
    from tpugnn_torch.sampling import sample_batch

    launches, k1 = {}, {}
    chunks = CIRCUIT_SHOTS // B
    for fname, d, sector, want, line, row in CIRCUIT_CHECKPOINTS:
        path = os.path.join(REPO, "tpugnn_torch", "assets", fname)
        meta = read_meta(path)
        ref = meta["ler_reference"]
        if meta["graph"] != {"kind": "circuit", "d_t": d, "sector": sector} or \
                ref["p"] != CIRCUIT_P:
            raise RuntimeError(f"{fname}: graph {meta['graph']}, reference at p={ref['p']}")
        _, model, graph = load_decoder(path, device=dev)
        gen = torch.Generator(device=dev).manual_seed(4000 + 10 * d + (sector == "x"))
        columns = fname == CIRCUIT_COLUMNS
        reset_counts()
        if columns:
            ev = ler_all_columns(model, graph, p=CIRCUIT_P, shots=CIRCUIT_SHOTS, batch=B,
                                 generator=gen, best_of=True, with_mwpm=True,
                                 with_uf_raw=True, select_cost="nll", device=dev)
        else:
            ev = ler_monte_carlo(model, graph, p=CIRCUIT_P, shots=CIRCUIT_SHOTS, batch=B,
                                 generator=gen, device=dev)
        name = f"d{d}{sector}"
        launches[f"circuit_{name}"] = launched = counts()
        n = int(ev["shots"])
        z_jax = {k: z_score(ev[k], n, ref[k], ref["shots"])
                 for k in ("ler_logical", "ler_hybrid", "ler")}
        z_row = {k: z_score(ev[k], n, v, CIRCUIT_ROW_SHOTS) for k, v in row.items() if k in ev}
        dg = graph.to(dev)
        with torch.inference_mode():
            syn = sample_batch(torch.Generator(device=dev).manual_seed(43), dg, CIRCUIT_P,
                               B).syndrome
            decode_ms = time_ms(lambda: model(dg, syn), warmup=1, iters=2)
        k1[graph.name] = detector_k1_check(model, graph, dev, p=CIRCUIT_P, want=want, iters=3,
                                           f64=True)
        res = dict(
            weights=os.path.relpath(path, REPO), graph=graph.name, m_pad=graph.n_checks_pad,
            n_pad=graph.n_qubits_pad, dc=graph.deg_max_check, dq=graph.deg_max_qubit,
            step=meta["step"], p=CIRCUIT_P, shots=n,
            rates={k: ev[k] for k in row if k in ev},
            jax_f32=dict(shots=ref["shots"], **{k: ref[k] for k in z_jax}), z_vs_jax_f32=z_jax,
            row=dict(line=f"benchmarks/LER_DETECTOR.md:{line}", shots=CIRCUIT_ROW_SHOTS, **row),
            z_vs_row=z_row, within_2_stderr_of_row={k: abs(v) <= 2 for k, v in z_row.items()},
            kernel=want, launches=launched, decode_ms=decode_ms,
            k1_ms=k1[graph.name]["ms"], k1_bound_ms=k1[graph.name]["bound_ms"],
            k1_tf32x3_floor_ms=k1[graph.name]["tf32x3_floor_ms"],
            k1_f32_core_ms=k1[graph.name]["f32_core_ms"])
        if abs(z_jax["ler_logical"]) > CIRCUIT_Z or abs(z_jax["ler"]) > CIRCUIT_Z:
            raise RuntimeError(f"circuit {name}: a head is off its JAX f32 rate: {res}")
        if launched != {**dict.fromkeys(launched, 0), want: chunks}:
            raise RuntimeError(f"circuit {name}: launched {launched}, not {chunks} {want} "
                               f"and nothing else")
        if columns:
            side = read_columns(path)
            if any(side[k] != meta[k] for k in ("step", "source", "code", "model", "graph")) \
                    or side["p"] != CIRCUIT_P or side["select_cost"] != "nll":
                raise RuntimeError(f"{fname}: the sidecar is not of these weights at "
                                   f"p={CIRCUIT_P} with the NLL rule")
            z_cols = {k: z_score(ev[k], n, v, side["shots"]) for k, v in side["columns"].items()}
            res.update(columns_jax_f32=dict(shots=side["shots"], **side["columns"]),
                       z_columns_vs_jax_f32=z_cols, picked=ev["picked"],
                       syn_mismatch=ev["syn_mismatch"], timing=ev["timing"])
            gated = {**{k: z_cols[k] for k in DETECTOR_GNN_COLUMNS}, "uf": z_row["uf"],
                     "mwpm": z_row["mwpm"]}
            if any(abs(v) > CIRCUIT_Z for v in gated.values()):
                raise RuntimeError(f"circuit {name}: a column is off its reference: {gated}")
            if any(ev["syn_mismatch"].values()):
                raise RuntimeError(f"circuit {name}: a cleanup column left syndromes: "
                                   f"{ev['syn_mismatch']}")
        info[name] = res
        del model
        torch.cuda.empty_cache()
    return launches, k1


class StepRecorder:
    """Wraps ``tpugnn_torch.train.loop.train_step`` while a CLI run trains:
    per step the loss, the kernel launches inside the step and a CUDA event
    after it (on a card), and the last step's model, optimizer, graph and
    config."""

    def __init__(self):
        self.losses, self.launches, self.events = [], [], []
        self.last = None

    def __enter__(self):
        from tpugnn_torch.kernels import fused_decoder as fd
        from tpugnn_torch.train import loop

        self._orig = orig = loop.train_step

        def step(model, optimizer, graph, batch, cfg):
            before = fd.launch_counts()
            metrics = orig(model, optimizer, graph, batch, cfg)
            after = fd.launch_counts()
            if graph.check_mask.device.type == "cuda":
                import torch

                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
            self.losses.append(metrics["loss"])
            self.launches.append({k: after[k] - before[k] for k in after})
            self.last = (model, optimizer, graph, cfg)
            return metrics

        loop.train_step = step
        return self

    def __exit__(self, *exc):
        from tpugnn_torch.train import loop

        loop.train_step = self._orig
        return False

    def summary(self) -> dict:
        losses = [float(v) for v in self.losses]
        first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        step_ms = [self.events[i - 1].elapsed_time(self.events[i])
                   for i in range(2, len(self.events))]
        return dict(steps=len(losses), losses=losses, loss_first5=first5, loss_last5=last5,
                    loss_ratio=last5 / first5, loss_fall_bound=CLI_LOSS_FALL,
                    step_ms_median=statistics.median(step_ms) if step_ms else None)


def run_cli(argv: list[str]) -> list[dict]:
    """``tpugnn_torch.cli.main(argv)`` with its stdout captured: its JSON
    lines, parsed; the rest goes to stderr.  Raises on a nonzero return."""
    import contextlib
    import io

    from tpugnn_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    lines = buf.getvalue().splitlines()
    for line in lines:
        if not line.startswith("{"):
            log(line)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} returned {rc}")
    return [json.loads(line) for line in lines if line.startswith("{")]


def gate_training(what: str, summary: dict, steps: int = CLI_TRAIN_STEPS) -> None:
    losses = summary["losses"]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"{what}: {len(losses)} steps, losses {losses}")
    if not summary["loss_last5"] < CLI_LOSS_FALL * summary["loss_first5"]:
        raise RuntimeError(f"{what}: the loss did not fall: {summary['loss_first5']} -> "
                           f"{summary['loss_last5']}")


def train_kernels_vs_plain(graph, dg, w, gen, want: tuple[str, str, str],
                           dt: str = "bfloat16") -> dict:
    """K1, K2a and K2b in state type ``dt`` on ``graph`` (``dg`` on the
    card) with round weights ``w`` at B=D13_BATCH, R=D13_ROUNDS on random
    states: each call must launch the kernel ``want`` names for it (K1,
    K2a, K2b) once and nothing else; K2a's outputs equal K1's, its outputs
    and stash are within the state type's tolerances of the plain versions
    (bf16: TOL_BF16_MAX and TOL_BF16_MEAN; f32: TOL_F32), K2b's gradients
    (every leaf) within TOL_GRAD_REL_BF16 (f32: TOL_GRAD_REL_F32) of
    rounds_vjp_plain fed the same stash, and a second K2b call equals the
    first.  Where K2b refuses the state type at this width
    (``fb.F32_BWD_REFUSED``; ROADMAP.md, Queue 3) its call must raise
    ValueError before any launch, and K1 and K2a are held as above.
    Raises otherwise; returns the errors."""
    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    h, r3 = w.wd_c.shape[0], D13_ROUNDS
    tol_max, tol_mean, tol_rel = ((TOL_F32, TOL_F32, TOL_GRAD_REL_F32) if dt == "float32"
                                  else (TOL_BF16_MAX, TOL_BF16_MEAN, TOL_GRAD_REL_BF16))
    mats32, vecs32 = fd.pack_weights_f32(w)
    ops = fd.make_operators(dg)
    dev = dg.check_mask.device
    xc, xq, s = random_states(dg, D13_BATCH, h, gen)
    cot_c = torch.randn(xc.shape, generator=gen, device=dev)
    cot_q = torch.randn(xq.shape, generator=gen, device=dev)
    refused = dt == "float32" and fd.kernel_width(h) in fb.F32_BWD_REFUSED
    launched = {}
    with torch.no_grad():
        calls = (("k1", lambda: fd.decoder_rounds(xc, xq, s, ops, w, r3, dt)),
                 ("k2a", lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, r3, dt)),
                 ("k2b", lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q,
                                              dt)))
        outs = {}
        for (kernel, call), name in zip(calls, want):
            reset_counts()
            if kernel == "k2b" and refused:
                try:
                    call()
                except ValueError as e:
                    outs[kernel] = str(e)
                else:
                    raise RuntimeError(f"{graph.name}: f32 K2b at {fd.kernel_width(h)} "
                                       f"columns ran; it refuses that width")
            else:
                outs[kernel] = call()
            launched[kernel] = counts()
            if kernel == "k2a":
                sc, sq = outs[kernel][2:]
        (k1c, k1q), (kc, kq, _, _), kg = outs["k1"], outs["k2a"], outs["k2b"]
        again = kg if refused else fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q,
                                                dt)
        pc, pq, psc, psq = fb.rounds_fwd_stash_plain(xc, xq, s, ops, mats32, vecs32,
                                                     rounds=r3, state_dtype=dt)
        pg = None if refused else fb.rounds_vjp_plain(sc, sq, s, ops, mats32, vecs32, cot_c,
                                                      cot_q, state_dtype=dt)
        torch.cuda.synchronize()
        same_as_k1 = bool(torch.equal(kc, k1c) and torch.equal(kq, k1q))
        repeatable = refused or all(torch.equal(a, b) for a, b in zip(kg, again))
        out_diff = torch.cat([(kc - pc).abs().flatten(), (kq - pq).abs().flatten()])
        st_diff = torch.cat([(sc.float() - psc.float()).abs().flatten(),
                             (sq.float() - psq.float()).abs().flatten()])
        finite = all(bool(torch.isfinite(t).all()) for t in (kc, kq, *([] if refused else kg)))
    res = dict(graph=graph.name, m_pad=graph.n_checks_pad, n_pad=graph.n_qubits_pad,
               dc=graph.deg_max_check, dq=graph.deg_max_qubit, batch=D13_BATCH, rounds=r3,
               kernels=dict(zip(("k1", "k2a", "k2b"), want)), launched=launched,
               k2a_equals_k1=same_as_k1, k2b_repeatable=repeatable,
               k2a_vs_plain_max=float(out_diff.max()), k2a_vs_plain_mean=float(out_diff.mean()),
               stash_vs_plain_max=float(st_diff.max()),
               stash_vs_plain_mean=float(st_diff.mean()), state_dtype=dt, tol_rel=tol_rel,
               tol_max=tol_max, tol_mean=tol_mean)
    if refused:
        res["k2b_refused"] = kg
    else:
        rels = grad_errors(w, kg, pg)
        worst = max(rels, key=rels.get)
        k_leaves, p_leaves = weight_leaves(w, kg[3], kg[4]), weight_leaves(w, pg[3], pg[4])
        res.update(k2b_max_abs_err=max(float((a - b).abs().max()) for a, b in zip(
            list(kg[:3]) + list(k_leaves.values()), list(pg[:3]) + list(p_leaves.values()))),
            k2b_worst_rel=rels[worst], k2b_worst_leaf=worst)
    for kernel, name in zip(("k1", "k2a", "k2b"), want):
        one = {**dict.fromkeys(launched[kernel], 0), name: 1}
        if launched[kernel] != (dict.fromkeys(one, 0) if kernel == "k2b" and refused else one):
            raise RuntimeError(f"{graph.name}: {kernel} launched {launched[kernel]}, not "
                               f"{'no kernel' if kernel == 'k2b' and refused else 'one'} "
                               f"{name}")
    if not finite or not same_as_k1 or not repeatable:
        raise RuntimeError(f"{graph.name} K2a/K2b non-finite, K2a differs from K1 or K2b "
                           f"from itself: {res}")
    if (res["k2a_vs_plain_max"] > tol_max or res["k2a_vs_plain_mean"] > tol_mean
            or res["stash_vs_plain_max"] > tol_max or res["stash_vs_plain_mean"] > tol_mean
            or res.get("k2b_worst_rel", 0.0) > tol_rel):
        raise RuntimeError(f"{graph.name}: K2a or K2b disagrees with its plain version: {res}")
    del outs, again, kc, kq, sc, sq, pc, pq, psc, psq, kg, pg, out_diff, st_diff
    torch.cuda.empty_cache()
    return res


def held_to_f64(run, plain, ops, w, xc, xq, s, rounds: int, want: str, what: str) -> dict:
    """One untimed bf16 K1 call ``run`` against its plain version ``plain``
    and both against the same rounds in f64: it must launch ``want`` once
    and nothing else, be finite, and its max and mean distance from the f64
    rounds within BF16_F64_RATIO of the plain version's.  Raises otherwise;
    returns the distances, its distance from the plain version beside."""
    import torch

    with torch.inference_mode():
        reset_counts()
        kc, kq = run()
        launched = counts()
        pc, pq = plain()
        ec, eq = (t.float() for t in rounds_f64_chunked(xc, xq, s, ops, w, rounds))
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(kc).all() and torch.isfinite(kq).all())
        res = dict(kernel=want, max_abs_err=raster_errors(kc, kq, pc, pq)[0],
                   mean_abs_err=raster_errors(kc, kq, pc, pq)[1])
        (res["vs_f64_max"], res["vs_f64_mean"]), (res["plain_vs_f64_max"],
                                                  res["plain_vs_f64_mean"]) = (
            raster_errors(kc, kq, ec, eq), raster_errors(pc, pq, ec, eq))
    res["f64_ratio_bound"] = BF16_F64_RATIO
    if launched[want] != 1 or sum(launched.values()) != 1:
        raise RuntimeError(f"{what}: launched {launched}, not one {want}")
    if not finite or any(res[f"vs_f64_{k}"] > BF16_F64_RATIO * res[f"plain_vs_f64_{k}"]
                         for k in ("max", "mean")):
        raise RuntimeError(f"{what} is further from the f64 rounds than its plain version: "
                           f"{res}")
    return res


def train_kernels_timed(graph, dg, w, gen, rounds: int, k1: str | None, f64: bool = False,
                        plain_calls: int = 1, dt: str = "bfloat16") -> dict:
    """K1, K2a and K2b in state type ``dt`` (bf16 by default) on ``graph``
    at the training shapes (B, ``rounds``) on random states: K1 (the kernel
    ``k1``, as the training run's evaluation runs it; none where ``k1`` is
    None) held to its plain version (with ``f64``, both to the rounds in
    f64: :func:`held_to_f64`) and timed beside its bound, then K2a and K2b
    each timed beside its plain version and its bound.  Each plain version
    of K2a and K2b is timed as ``plain_calls`` calls on equal slices of the
    batch between the same two events: on circuit d=7 the plain adjoint of
    all 4096 samples in one call peaks near 69 GB, and after the smoke's
    earlier phases the card's allocator could not place it (two runs out of
    memory with 24 GB of its cache fragmented)."""
    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    h = w.wd_c.shape[0]
    mats32, vecs32 = fd.pack_weights_f32(w)
    ops = fd.make_operators(dg)
    dev = dg.check_mask.device
    xc, xq, s = random_states(dg, B, h, gen)
    cot_c = torch.randn(xc.shape, generator=gen, device=dev)
    cot_q = torch.randn(xq.shape, generator=gen, device=dev)
    k1_res = {}
    if k1 is not None:
        run, plain = kernel_and_plain("k1", graph, ops, w, xc, xq, s, rounds, dt)
        what = f"K1 {dt} on {graph.name}, B={B}, R={rounds}"
        k1_check = (held_to_f64(run, plain, ops, w, xc, xq, s, rounds, k1, what) if f64
                    else held_to_plain(run, plain, k1, dt, what))
        with torch.inference_mode():
            k1_ms = time_ms(run, warmup=1, iters=5)
            k1_plain_ms = time_ms(plain, warmup=0, iters=1)
        b_ms, b_by = bound(rounds_bytes(graph, B, h, 2), rounds_flops(graph, h) * B * rounds,
                           H100_BF16_FLOPS)
        k1_res[f"k1_{dt}"] = dict(batch=B, rounds=rounds, ms=k1_ms, plain_ms=k1_plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, **k1_check)
        del run, plain
        torch.cuda.empty_cache()
    with torch.no_grad():
        k2a_ms = time_ms(lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, rounds, dt),
                         warmup=1, iters=5)
        _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, rounds, dt)
        k2b_ms = time_ms(lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dt),
                         warmup=1, iters=5)
        parts = [slice(i * B // plain_calls, (i + 1) * B // plain_calls)
                 for i in range(plain_calls)]

        def plain_fwd():
            for p in parts:
                fb.rounds_fwd_stash_plain(xc[p], xq[p], s[p], ops, mats32, vecs32,
                                          rounds=rounds, state_dtype=dt)

        def plain_bwd():
            for p in parts:
                fb.rounds_vjp_plain(sc[:, p], sq[:, p], s[p], ops, mats32, vecs32, cot_c[p],
                                    cot_q[p], state_dtype=dt)

        plain_fwd_ms = time_ms(plain_fwd, warmup=0, iters=1)
        del xc, xq
        torch.cuda.empty_cache()
        plain_bwd_ms = time_ms(plain_bwd, warmup=0, iters=1)
    item = 4 if dt == "float32" else 2
    res = dict(timed_batch=B, timed_rounds=rounds, k2a_ms=k2a_ms, k2b_ms=k2b_ms,
               plain_fwd_stash_ms=plain_fwd_ms, plain_vjp_ms=plain_bwd_ms,
               plain_calls=plain_calls,
               stash_gb=stash_bytes(graph, B, rounds, h, item) / 1e9,
               **train_kernel_bounds(graph, B, rounds, h, k2a_ms, k2b_ms, dt), **k1_res)
    del sc, sq, s, cot_c, cot_q
    torch.cuda.empty_cache()
    return res


def circuit_train_kernels(model, dg, dev) -> dict:
    """K2a and K2b on the circuit d=5 graph (M=64, N=304, Dc=14, Dq=2) in
    bf16, on the trained weights: against the plain versions
    (:func:`train_kernels_vs_plain`, B=64, R=3) and timed at the training
    shapes (:func:`train_kernels_timed`, B=4096, R=8), K1 in bf16 beside
    them.  ``dg`` is the graph on the card."""
    import torch

    from tpugnn_torch.kernels import fused_decoder as fd

    w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
    gen = torch.Generator(device=dev).manual_seed(16)
    res = train_kernels_vs_plain(dg, dg, w, gen, ROUNDS_NAMES)
    res.update(train_kernels_timed(dg, dg, w, gen, model.cfg.rounds, ROUNDS_NAMES[0]))
    return res


def circuit_f32_k2b(dev) -> dict:
    """f32 K1, K2a and K2b on the trained circuit checkpoints of
    CIRCUIT_F32_K2B (circuit d=5 and d=7, their own weights; B=D13_BATCH,
    R=D13_ROUNDS), each held to its plain version as
    :func:`train_kernels_vs_plain` holds it: K2b's every leaf within
    TOL_GRAD_REL_F32 of rounds_vjp_plain.  On these graphs (10 to 14 slots a
    check row) a t-relu tie K2b takes again must sum the row's hs over its
    slots as torch's reduction behind the plain version does."""
    import torch

    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models.convert import load_decoder

    out = {}
    for i, fname in enumerate(CIRCUIT_F32_K2B):
        _, model, graph = load_decoder(os.path.join(REPO, "tpugnn_torch", "assets", fname),
                                       device=dev)
        w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
        gen = torch.Generator(device=dev).manual_seed(18 + i)
        out[graph.name] = train_kernels_vs_plain(graph, graph.to(dev), w, gen, ROUNDS_NAMES,
                                                 "float32")
        del model
        torch.cuda.empty_cache()
    return out


def phase_circuit_and_cli(dev, info: dict) -> tuple[dict, dict, dict]:
    """The `circuit_and_cli` phase: circuit-level detector graphs and the
    command line on the card.

    a. :func:`circuit_decode`: the five circuit checkpoints in f32 at
       CIRCUIT_P, d=5 z through every column with the NLL rule.
    b. ``python -m tpugnn_torch.cli`` train on the circuit training config
       (CIRCUIT_TRAIN_ARGS) for CLI_TRAIN_STEPS steps through the CLI's
       ``main``: a finite, falling loss, one K2a and one K2b launch and no
       K1 a step, the median step ms; then :func:`circuit_train_kernels`
       on the trained weights, f32 K1, K2a and K2b on the trained circuit d=5
       and d=7 checkpoints against their plain versions
       (:func:`circuit_f32_k2b`: K2b within TOL_GRAD_REL_F32), and one
       train step from the run's last state
       through K2a/K2b and through their plain versions on the same CUDA
       tensors (:func:`train_steps_vs_plain`), each parameter leaf's change
       within TRAIN_STEP_REL.
    c. cli train at the CLI's defaults on the surface code at d=5 (generic
       'segment' backend, H=128, R=8, batch 256, f32): a finite, falling
       loss and no kernel launch; one step's gradients on the card against
       the same step on the CPU through the port, within GENERIC_GRAD_REL
       in relative L2 and every leaf within GENERIC_LEAF_REL; the same step
       with TF32 products, which this leaf gate must reject.
    d. cli eval (CLI_EVAL_SHOTS shots) and cli serve (a 4096-shot demo
       request) on the d=5 circuit weights file with --cleanup mwpm: their
       JSON lines; the logical head and GNN+MWPM within |z| <= CIRCUIT_Z of
       the JAX f32 references; only K1 launched.
    Returns ``(launches by path, K1's check by circuit graph, K2a/K2b on
    the circuit graph)``."""
    import copy
    import types

    import torch

    t0 = time.perf_counter()
    launches, k1 = circuit_decode(dev, info)
    part_s = {"decode": time.perf_counter() - t0}

    # b. circuit training through the CLI, K2a/K2b
    argv = [*CIRCUIT_TRAIN_ARGS, "--steps", str(CLI_TRAIN_STEPS), "--eval-every",
            str(CLI_TRAIN_STEPS)]
    reset_counts()
    with StepRecorder() as rec:
        row = run_cli(argv)[-1]
    launches["cli_train_circuit"] = counts()
    summary = rec.summary()
    model, optimizer, dg, cfg = rec.last
    per_step = rec.launches
    info["cli_train_circuit"] = dict(argv=argv, last_line=row, launches=launches[
        "cli_train_circuit"], **summary)
    gate_training("cli train (circuit, pallas)", summary)
    if any(c != {**dict.fromkeys(c, 0), "fused_rounds_fwd_stash": 1, "fused_rounds_bwd": 1}
           for c in per_step):
        raise RuntimeError(f"cli train (circuit): a step did not launch K2a and K2b once "
                           f"each and nothing else: {per_step}")
    k2 = circuit_train_kernels(model, dg, dev)
    k2["f32_k2b_trained"] = circuit_f32_k2b(dev)
    state = types.SimpleNamespace(model=model, optimizer=optimizer)
    errs = train_steps_vs_plain(state, cfg, dg, dev, steps=1)
    worst = max(errs["kernels"][0].items(), key=lambda kv: kv[1])
    least = min(((n, v) for n, v in errs["zero_wgrads"][0].items() if n.startswith("rounds.")),
                key=lambda kv: kv[1])
    k2["step_vs_plain"] = dict(bound=TRAIN_STEP_REL, kernels_worst=dict(leaf=worst[0],
                                                                         rel=worst[1]),
                               zero_wgrads_least=dict(leaf=least[0], rel=least[1]))
    k2["step_ms_median"] = summary["step_ms_median"]
    info["cli_train_circuit"]["kernels"] = k2
    if worst[1] > TRAIN_STEP_REL:
        raise RuntimeError(f"cli train (circuit): a step through K2a/K2b moves the "
                           f"parameters otherwise than the plain versions: {k2}")
    del model, optimizer, state, rec
    torch.cuda.empty_cache()
    part_s["train_circuit"] = time.perf_counter() - t0 - sum(part_s.values())

    # c. generic training through the CLI at its defaults, d=5
    argv = ["train", "-d", "5", "--steps", str(CLI_TRAIN_STEPS), "--eval-every",
            str(CLI_TRAIN_STEPS)]
    reset_counts()
    with StepRecorder() as rec:
        row = run_cli(argv)[-1]
    launches["cli_train_generic"] = counts()
    summary = rec.summary()
    model, _, dg, cfg = rec.last
    info["cli_train_generic"] = dict(argv=argv, last_line=row, backend=model.cfg.backend,
                                     launches=launches["cli_train_generic"], **summary)
    gate_training("cli train (generic)", summary)
    if model.cfg.backend != "segment" or any(launches["cli_train_generic"].values()):
        raise RuntimeError(f"cli train (generic): {model.cfg.backend}, launched "
                           f"{launches['cli_train_generic']}")
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.tanner import build_code
    from tpugnn_torch.train import loss_fn

    batch = sample_batch(torch.Generator(device=dev).manual_seed(78), dg, cfg.code.p,
                         cfg.train.batch)
    graphs = {"cuda": dg, "cuda_again": dg, "cuda_tf32": dg,
              "cpu": build_code(cfg.code.family, cfg.code.distance).to("cpu")}
    grads = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for run, g in graphs.items():
        where = run.split("_")[0]
        m = copy.deepcopy(model).to(where)
        b = type(batch)(*[t.to(where) for t in batch])
        torch.backends.cuda.matmul.allow_tf32 = run == "cuda_tf32"
        try:
            total, _ = loss_fn(m, g, b, cfg)
            total.backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        grads[run] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
    vec = {run: torch.cat([g[n].flatten() for n in sorted(g)]) for run, g in grads.items()}
    gmax = float(vec["cpu"].abs().max())
    rel = float((vec["cuda"] - vec["cpu"]).norm() / vec["cpu"].norm())

    def worst_leaf(run: str) -> dict:
        """The parameter leaf whose gradient lies furthest from the CPU's in
        relative L2 (a leaf whose CPU gradient is 0 must be 0)."""
        def leaf_rel(n):
            diff, ref = float((grads[run][n] - grads["cpu"][n]).norm()), float(
                grads["cpu"][n].norm())
            return diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
        leaf = max(grads["cpu"], key=leaf_rel)
        return dict(leaf=leaf, rel=leaf_rel(leaf))

    leaf, leaf_tf32 = worst_leaf("cuda"), worst_leaf("cuda_tf32")
    info["cli_train_generic"]["grad_vs_cpu"] = dict(
        rel_l2=rel, bound=GENERIC_GRAD_REL, worst_leaf=leaf, leaf_bound=GENERIC_LEAF_REL,
        max_abs_share=float((vec["cuda"] - vec["cpu"]).abs().max()) / gmax,
        card_vs_card_rel_l2=float((vec["cuda_again"] - vec["cuda"]).norm()
                                  / vec["cuda"].norm()),
        card_vs_card_max_abs_share=float((vec["cuda_again"] - vec["cuda"]).abs().max()) / gmax,
        tf32_rel_l2=float((vec["cuda_tf32"] - vec["cpu"]).norm() / vec["cpu"].norm()),
        tf32_worst_leaf=leaf_tf32)
    if not leaf_tf32["rel"] > GENERIC_LEAF_REL:
        raise RuntimeError(f"cli train (generic): the leaf gate does not reject the TF32 "
                           f"step: {info['cli_train_generic']['grad_vs_cpu']}")
    if not (rel <= GENERIC_GRAD_REL and leaf["rel"] <= GENERIC_LEAF_REL):
        raise RuntimeError(f"cli train (generic): the card's gradients differ from the "
                           f"CPU's: {info['cli_train_generic']['grad_vs_cpu']}")
    del model, rec, grads
    torch.cuda.empty_cache()
    part_s["train_generic"] = time.perf_counter() - t0 - sum(part_s.values())

    # d. eval and serve on the d=5 circuit weights file
    from tpugnn_torch.models.convert import read_columns, read_meta

    path = os.path.join(REPO, "tpugnn_torch", "assets", CIRCUIT_COLUMNS)
    ref, side = read_meta(path)["ler_reference"], read_columns(path)
    reset_counts()
    ev = run_cli(["eval", *CLI_WEIGHTS_ARGS, "--shots", str(CLI_EVAL_SHOTS),
                  "--checkpoint-dir", path])[-1]
    launches["cli_eval"] = counts()
    reset_counts()
    served = run_cli(["serve", *CLI_WEIGHTS_ARGS, "--max-batch", str(B),
                      "--checkpoint-dir", path])[-1]
    launches["cli_serve"] = counts()
    n = int(ev["shots"])
    z = dict(ler_logical=z_score(ev["ler_logical"], n, ref["ler_logical"], ref["shots"]),
             gnn_mwpm_ler=z_score(ev["gnn_mwpm_ler"], n, side["columns"]["gnn_mwpm"],
                                  side["shots"]))
    info["cli_weights"] = dict(weights=os.path.relpath(path, REPO), eval=ev, serve=served,
                               z_vs_jax_f32=z, launches_eval=launches["cli_eval"],
                               launches_serve=launches["cli_serve"])
    if any(abs(v) > CIRCUIT_Z for v in z.values()) or served["shots"] != B:
        raise RuntimeError(f"cli eval/serve on the circuit weights: {info['cli_weights']}")
    for path_name in ("cli_eval", "cli_serve"):
        c = launches[path_name]
        if c["fused_rounds"] < 1 or sum(c.values()) != c["fused_rounds"]:
            raise RuntimeError(f"{path_name}: launched {c}, not K1 alone")
    part_s["eval_serve"] = time.perf_counter() - t0 - sum(part_s.values())
    info["part_seconds"] = part_s
    return launches, k1, k2


@contextlib.contextmanager
def smem_limit(module, limit):
    """The shared-memory limit a wrapper module compares against, set to
    ``limit`` inside the block: a graph that needs more takes the module's
    global-panel variant."""
    old, module.SMEM_LIMIT = module.SMEM_LIMIT, limit
    try:
        yield
    finally:
        module.SMEM_LIMIT = old


def phase_circuit_d7_bfloat16(dev, info: dict) -> dict:
    """Phase 4g: the circuit d=7 checkpoint in bf16 on K1, K2a and K2b at
    W = 128 (176 + 920 rows, the largest graph the smoke trains).

    a. On the trained weights (M=176, N=920, Dc=14, Dq=2; B=64, R=3): each
       kernel launched once and nothing else, K2a equal to K1, both and
       K2a's stash within the bf16 tolerances of the plain versions, K2b's
       gradients (every leaf) within TOL_GRAD_REL_BF16 and equal across two
       calls (:func:`train_kernels_vs_plain`).
    b. K1, K2a and K2b timed at B=4096, R=8 on the trained weights beside
       their bounds and their plain versions (:func:`train_kernels_timed`).
    c. ``cli eval`` in bf16 on the weights file at CIRCUIT_P on
       CIRCUIT_SHOTS shots: both heads within |z| <= CIRCUIT_Z of the JAX
       f32 rate in the file, the z against LER_DETECTOR.md:43 reported, K1
       launched once a chunk and nothing else; and
       ``DecodeEngine.from_npz(dtype='bfloat16')`` serving a 4096-syndrome
       request with one such launch.
    d. ``cli train`` at the checkpoint's settings (D7_TRAIN_ARGS) for
       D7_TRAIN_STEPS steps: a finite, falling loss, one K2a and one K2b
       launch a step and nothing else, the median step ms.
    e. cuobjdump -sass: HGMMA in every bf16 W = 128 instantiation.
    Returns the launches by path; ``info`` gets every number."""
    import numpy as np
    import torch

    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models.convert import load_decoder, read_meta
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.serve import DecodeEngine

    dt, t0, part_s, launches = "bfloat16", time.perf_counter(), {}, {}

    def lap(name):
        part_s[name] = time.perf_counter() - t0 - sum(part_s.values())

    torch.cuda.empty_cache()    # the plain adjoint at B=4096 below peaks near 69 GB
    path = os.path.join(REPO, "tpugnn_torch", "assets", D7_WEIGHTS)
    _, model, graph = load_decoder(path, device=dev, dtype=dt)
    dg = graph.to(dev)
    w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
    gen = torch.Generator(device=dev).manual_seed(72)
    info["checks"] = train_kernels_vs_plain(graph, dg, w, gen, ROUNDS_NAMES)
    lap("checks")

    # b. the training shapes
    info["timed"] = train_kernels_timed(graph, dg, w, gen, model.cfg.rounds, ROUNDS_NAMES[0],
                                        f64=True, plain_calls=2)
    del model
    torch.cuda.empty_cache()
    lap("timed")

    # c. cli eval and DecodeEngine on the weights file in bf16
    meta = read_meta(path)
    ref = meta["ler_reference"]
    reset_counts()
    ev = run_cli([*D7_EVAL_ARGS, "--checkpoint-dir", path])[-1]
    launches["cli_eval_d7_bf16"] = launched = counts()
    n = int(ev["shots"])
    row = dict(CIRCUIT_CHECKPOINTS[-1][-1])
    z_jax = {k: z_score(ev[k], n, ref[k], ref["shots"]) for k in ("ler_logical", "ler")}
    z_row = {k: z_score(ev[k], n, row[k], CIRCUIT_ROW_SHOTS) for k in ("ler_logical", "ler")}
    chunks = CIRCUIT_SHOTS // B
    info["cli_eval"] = dict(
        argv=[*D7_EVAL_ARGS, "--checkpoint-dir", os.path.relpath(path, REPO)], row=ev,
        jax_f32=dict(shots=ref["shots"], **{k: ref[k] for k in z_jax}), z_vs_jax_f32=z_jax,
        table_row=dict(line=f"benchmarks/LER_DETECTOR.md:{D7_ROW_LINE}",
                       shots=CIRCUIT_ROW_SHOTS, **{k: row[k] for k in z_row}),
        z_vs_row=z_row, launches=launched)
    if any(abs(v) > CIRCUIT_Z for v in z_jax.values()):
        raise RuntimeError(f"cli eval bf16 on circuit d=7: a head is off its JAX f32 rate: "
                           f"{info['cli_eval']}")
    if launched != {**dict.fromkeys(launched, 0), ROUNDS_NAMES[0]: chunks}:
        raise RuntimeError(f"cli eval bf16 on circuit d=7: launched {launched}, not {chunks} "
                           f"{ROUNDS_NAMES[0]} and nothing else")
    with DecodeEngine.from_npz(path, device="cuda", dtype=dt, max_batch=B) as eng:
        syn = sample_batch(torch.Generator(device=dev).manual_seed(74), dg, CIRCUIT_P,
                           B).syndrome[:, :graph.n_checks].to(torch.uint8).cpu().numpy()
        reset_counts()
        t1 = time.perf_counter()
        corr = eng.decode(syn)
        serve_ms = (time.perf_counter() - t1) * 1e3
        launches["serve_d7_bf16"] = launched = counts()
        dtype_served = eng.model.cfg.dtype
    info["serve"] = dict(shots=B, request_ms=serve_ms, model_dtype=dtype_served,
                         launches=launched)
    if (corr.shape != (B, graph.n_qubits, 2) or corr.dtype != np.uint8 or dtype_served != dt
            or launched != {**dict.fromkeys(launched, 0), ROUNDS_NAMES[0]: 1}):
        raise RuntimeError(f"DecodeEngine bf16 on circuit d=7: {corr.shape} {corr.dtype} "
                           f"{info['serve']}")
    torch.cuda.empty_cache()
    lap("eval_serve")

    # d. cli train at the checkpoint's settings
    argv = [*D7_TRAIN_ARGS, "--steps", str(D7_TRAIN_STEPS), "--eval-every",
            str(D7_TRAIN_STEPS)]
    reset_counts()
    with StepRecorder() as rec:
        last = run_cli(argv)[-1]
    launches["cli_train_d7_bf16"] = counts()
    summary = rec.summary()
    per_step = rec.launches
    info["cli_train"] = dict(argv=argv, last_line=last, launches=launches["cli_train_d7_bf16"],
                             **summary)
    del rec
    torch.cuda.empty_cache()
    gate_training("cli train (circuit d=7, bf16)", summary, D7_TRAIN_STEPS)
    step_want = {ROUNDS_NAMES[1]: 1, ROUNDS_NAMES[2]: 1}
    if any(c != {**dict.fromkeys(c, 0), **step_want} for c in per_step):
        raise RuntimeError(f"cli train (circuit d=7): a step did not launch K2a and K2b once "
                           f"each and nothing else: {per_step}")
    lap("train")

    # e. the W = 128 instantiations on the tensor cores
    info["sass_hgmma"] = hgmma_w128(dt)
    lap("sass")
    info["part_seconds"] = part_s
    return launches


def phase_f32_training_past_smem(dev, info: dict) -> dict:
    """Phase 6b: f32 training on the larger graphs, on K2a and K2b at
    W = 128.

    a. d=13 (random weights, B=64, R=3): K1, K2a and K2b each launched once
       and nothing else, K2a equal to K1, its outputs and stash within
       TOL_F32 of rounds_fwd_stash_plain, K2b's gradients (every leaf)
       within TOL_GRAD_REL_F32 of rounds_vjp_plain fed the same stash, and a
       second K2b call equal to the first (:func:`train_kernels_vs_plain`).
    b. K2a and K2b timed at d=13, B=4096, R=TRAINED_ROUNDS beside their
       3xTF32 bounds and their plain versions (two half-batch calls each).
    c. ``cli train`` on the circuit d=5 graph in f32
       (CIRCUIT_F32_TRAIN_ARGS) for CIRCUIT_F32_TRAIN_STEPS steps: a finite,
       falling loss, one K2a and one K2b launch a step and nothing else; one
       step from its last state through the kernels and
       through their plain versions (:func:`train_steps_vs_plain`), every
       parameter leaf's change within TRAIN_STEP_REL.
    Returns the launches by path; ``info`` gets every number."""
    import types

    import torch

    dt, t0, part_s, launches = "float32", time.perf_counter(), {}, {}

    def lap(name):
        part_s[name] = time.perf_counter() - t0 - sum(part_s.values())

    # a. d=13
    g13, dg13, _, w13, _, _, _, gen = random_round_case(13, D13_BATCH, D13_ROUNDS, dt, 17, dev)
    info["d13"] = train_kernels_vs_plain(g13, dg13, w13, gen, ROUNDS_NAMES, dt)
    lap("d13_checks")

    # b. the training shapes at d=13
    info["timed"] = train_kernels_timed(g13, dg13, w13, gen, TRAINED_ROUNDS, None,
                                        plain_calls=2, dt=dt)
    torch.cuda.empty_cache()
    lap("timed")

    # c. circuit d=5 training in f32 through the CLI
    argv = [*CIRCUIT_F32_TRAIN_ARGS, "--steps", str(CIRCUIT_F32_TRAIN_STEPS), "--eval-every",
            str(CIRCUIT_F32_TRAIN_STEPS)]
    reset_counts()
    with StepRecorder() as rec:
        row = run_cli(argv)[-1]
    launches["cli_train_circuit_f32"] = counts()
    summary = rec.summary()
    model, optimizer, dg, cfg = rec.last
    info["cli_train_circuit"] = dict(argv=argv, last_line=row,
                                     launches=launches["cli_train_circuit_f32"], **summary)
    gate_training("cli train (circuit d=5, f32)", summary, CIRCUIT_F32_TRAIN_STEPS)
    step_want = {ROUNDS_NAMES[1]: 1, ROUNDS_NAMES[2]: 1}
    if any(c != {**dict.fromkeys(c, 0), **step_want} for c in rec.launches):
        raise RuntimeError(f"cli train (circuit d=5, f32): a step did not launch K2a and K2b "
                           f"once each and nothing else: {rec.launches}")
    errs = train_steps_vs_plain(types.SimpleNamespace(model=model, optimizer=optimizer), cfg,
                                dg, dev, steps=1)
    worst = max(errs["kernels"][0].items(), key=lambda kv: kv[1])
    least = min(((n, v) for n, v in errs["zero_wgrads"][0].items() if n.startswith("rounds.")),
                key=lambda kv: kv[1])
    info["cli_train_circuit"]["step_vs_plain"] = dict(
        bound=TRAIN_STEP_REL, kernels_worst=dict(leaf=worst[0], rel=worst[1]),
        zero_wgrads_least=dict(leaf=least[0], rel=least[1]))
    if worst[1] > TRAIN_STEP_REL:
        raise RuntimeError(f"cli train (circuit d=5, f32): a step through K2a/K2b moves the "
                           f"parameters otherwise than the plain versions: "
                           f"{info['cli_train_circuit']['step_vs_plain']}")
    del model, optimizer, rec
    torch.cuda.empty_cache()
    lap("circuit_train")
    info["part_seconds"] = part_s
    return launches


def phase_fused_configs(dev, info: dict) -> dict:
    """Phase 6c: the fused backend's msg_hidden != hidden and per-round
    weights on the kernels.

    a. H=64, MH=MH_WIDTH (d=11): K1 against rounds_plain in both state
       types (B=64, R=3, :func:`rounds_vs_plain`); in f32 K2a/K2b gated as
       the width-64 check is, and two train steps from a 10-step run
       through K2a/K2b against their plain versions
       (:func:`train_width_check`); the model's decode of 64 syndromes at
       p=0.05 launching K1 once and nothing else, its per-qubit argmax on
       real qubits within MIN_AGREE_F32 of the same model on the plain
       rounds, its logits' distance reported.
    b. weight_tied=False (surface d=UNTIED_D, H=128, R=3, f32, B=64): the
       model's forward launches K1 R times and nothing else, its argmax as
       in (a); one backward of a random functional of its logits through
       K2a/K2b, R launches of each and nothing else, every gradient leaf's
       distance from the plain versions' reported (a relu that K2a's 3xTF32
       rounding flips decides a whole autograd path, as at width 64).
    Returns the launches by path; ``info`` gets every number."""
    import torch

    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.models import decoder as dec
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.tanner import build_code

    launches = {}
    rounds_fn = dec.decoder_rounds

    def plain_rounds(xc, xq, syn, ops, w, rounds, state_dtype):
        if torch.is_grad_enabled():
            from tpugnn_torch.kernels import fused_backward as fb

            return fb.trained_rounds(xc, xq, syn, ops, w, rounds, state_dtype, kernels=False)
        return fd.rounds_plain(xc, xq, syn, ops, w, rounds=rounds, state_dtype=state_dtype)

    def both(model, dg, syn, path, grad):
        """The model on the kernels (launches counted under ``path``) and on
        the plain rounds, with grad (a backward of a random functional of
        the logits) or without: ``(kernel out, plain out, kernel grads,
        plain grads)``."""
        outs, grads = [], []
        for kernels in (True, False):
            model.zero_grad(set_to_none=True)
            dec.decoder_rounds = rounds_fn if kernels else plain_rounds
            try:
                reset_counts()
                with torch.set_grad_enabled(grad):
                    out = model(dg, syn)
                    if grad:
                        g = torch.Generator(device=dev).manual_seed(81)
                        loss = sum((t * torch.randn(t.shape, generator=g, device=dev)).sum()
                                   for t in (out.qubit_logits, out.logical_logits))
                        loss.backward()
                if kernels:
                    launches[path] = counts()
            finally:
                dec.decoder_rounds = rounds_fn
            outs.append(out)
            grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()}
                         if grad else None)
        torch.cuda.synchronize()
        return (*outs, *grads)

    def agreement(k, p, dg):
        real = dg.qubit_mask > 0
        same = (k.qubit_logits.argmax(-1) == p.qubit_logits.argmax(-1))[:, real]
        return dict(agree=float(same.float().mean()),
                    qubit_logits_max_abs_err=float((k.qubit_logits - p.qubit_logits).abs().max()),
                    logical_logits_max_abs_err=float(
                        (k.logical_logits - p.logical_logits).abs().max()))

    # a. msg_hidden != hidden
    info["mh_k1"] = {dt: rounds_vs_plain("k1", D, 64, dt, 90, dev, "fused_rounds", mh=MH_WIDTH)
                     for dt in ("float32", "bfloat16")}
    info["mh_train"] = train_width_check("float32", build_code("surface", D).to(dev), dev,
                                         mh=MH_WIDTH)
    g11 = build_code("surface", D)
    dg11 = g11.to(dev)
    model = GNNDecoder(ModelConfig(hidden=64, msg_hidden=MH_WIDTH, rounds=D13_ROUNDS,
                                   backend="fused", qubit_head="pauli4"), k=g11.k)
    model.init_random(torch.Generator().manual_seed(91), bias_std=0.1)
    model.to(dev)
    syn = sample_batch(torch.Generator(device=dev).manual_seed(92), dg11, 0.05,
                       D13_BATCH).syndrome
    k_out, p_out, _, _ = both(model, dg11, syn, "fused_mh_decode", grad=False)
    info["mh_decode"] = dict(hidden=64, msg_hidden=MH_WIDTH, batch=D13_BATCH,
                             rounds=D13_ROUNDS, launches=launches["fused_mh_decode"],
                             min_agree=MIN_AGREE_F32, **agreement(k_out, p_out, dg11))
    if launches["fused_mh_decode"] != {**dict.fromkeys(launches["fused_mh_decode"], 0),
                                       "fused_rounds": 1}:
        raise RuntimeError(f"H=64 MH={MH_WIDTH} decode: launched "
                           f"{launches['fused_mh_decode']}, not one K1")
    if not info["mh_decode"]["agree"] >= MIN_AGREE_F32:
        raise RuntimeError(f"H=64 MH={MH_WIDTH} decode disagrees with its plain version: "
                           f"{info['mh_decode']}")

    # b. per-round weights
    g5 = build_code("surface", UNTIED_D)
    dg5 = g5.to(dev)
    model = GNNDecoder(ModelConfig(hidden=128, msg_hidden=128, rounds=D13_ROUNDS,
                                   backend="fused", qubit_head="pauli4", weight_tied=False),
                       k=g5.k)
    model.init_random(torch.Generator().manual_seed(93), bias_std=0.1)
    model.to(dev)
    syn = sample_batch(torch.Generator(device=dev).manual_seed(94), dg5, 0.05,
                       D13_BATCH).syndrome
    k_out, p_out, _, _ = both(model, dg5, syn, "fused_untied_decode", grad=False)
    _, _, k_grads, p_grads = both(model, dg5, syn, "fused_untied_train", grad=True)
    rels = {n: rel_err(k_grads[n], p_grads[n]) for n in p_grads}
    worst = max(rels, key=rels.get)
    info["untied"] = dict(d=UNTIED_D, hidden=128, rounds=D13_ROUNDS, batch=D13_BATCH,
                          launches_decode=launches["fused_untied_decode"],
                          launches_train=launches["fused_untied_train"],
                          min_agree=MIN_AGREE_F32, **agreement(k_out, p_out, dg5),
                          grad_worst_rel=rels[worst], grad_worst_leaf=worst)
    want = {"decode": {"fused_rounds": D13_ROUNDS},
            "train": {"fused_rounds_fwd_stash": D13_ROUNDS, "fused_rounds_bwd": D13_ROUNDS}}
    for what, w in want.items():
        c = launches[f"fused_untied_{what}"]
        if c != {**dict.fromkeys(c, 0), **w}:
            raise RuntimeError(f"per-round weights, {what}: launched {c}, not {w}")
    if not info["untied"]["agree"] >= MIN_AGREE_F32:
        raise RuntimeError(f"per-round weights: the decode disagrees with its plain version: "
                           f"{info['untied']}")
    del model
    torch.cuda.empty_cache()
    return launches


class _Recorder:
    """A sharded apply that keeps each chunk's logits on the host and its
    host-clock ms (every rank's apply ends in the same all-gather)."""

    def __init__(self, apply, keep: bool):
        self.apply, self.keep, self.q, self.l, self.ms = apply, keep, [], [], []

    def __call__(self, graph, syn):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.apply(graph, syn)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if self.keep:
            self.q.append(out.qubit_logits.cpu())
            self.l.append(out.logical_logits.cpu())
        return out

    def to(self, device):
        self.apply.to(device)
        return self


def dist_ranks(weights: str) -> dict:
    """One of the DIST_P gloo ranks of phase 4f, all on the one card: (b)
    the d=15 decode sharded DIST_P ways through ler_monte_carlo, each
    chunk timed; the halo modes and wire types on its first DIST_CHECK
    shots and a chunk's exchange buffers; a round's exchange by mode and
    wire type, its bytes and ms; (c) the sharded train step on a 2 x 2
    mesh; and (d) dryrun's sharded step on its small mesh.  Returns this
    rank's numbers (rank 0: the logits too)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpugnn_torch.configs import (CodeConfig, ExperimentConfig, MeshConfig, ModelConfig,
                                      TrainConfig)
    from tpugnn_torch.dist import (exchange, make_mesh, make_sharded_apply,
                                   make_sharded_train_step, partition_graph)
    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.models.convert import load_decoder
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.tanner import build_code
    from tpugnn_torch.train import init_state

    dev = torch.device("cuda", torch.cuda.current_device())
    me = dist.get_rank()
    out = {"rank": me, "backend": dist.get_backend()}
    t_start = time.perf_counter()
    part_s = {}

    def lap(name):
        part_s[name] = time.perf_counter() - t_start - sum(part_s.values())

    def sync_ms(fn) -> float:
        """Host-clock ms of one call of ``fn`` on every rank at once (a call
        before it has warmed the path up)."""
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # b. the d=15 decode, sharded
    _, model, _ = load_decoder(weights, device=dev, backend="segment")
    graph = build_code("surface", DIST_D, pad_nodes=8 * DIST_P)
    dg = graph.to(dev)
    mesh = make_mesh(MeshConfig(data=1, graph=DIST_P))
    wires = (("alltoall", "float32"), ("ring", "float32"), ("gather", "float32"),
             ("alltoall", "bfloat16"), ("alltoall", "int8"))
    pgs = {k: partition_graph(graph, DIST_P, halo=k[0], halo_dtype=k[1]) for k in wires}
    applies = {k: make_sharded_apply(model, mesh, pg, device=dev) for k, pg in pgs.items()}
    rec = _Recorder(applies[wires[0]], keep=me == 0)
    lap("setup")
    exchange.reset_counts()
    ev = ler_monte_carlo(rec, graph, p=0.05, shots=DIST_SHOTS, batch=DIST_CHUNK,
                         generator=torch.Generator(device=dev).manual_seed(DIST_SEED),
                         device=dev)
    torch.cuda.synchronize()
    lap("decode")
    # a chunk's ms: the median over the pass's chunks but the first
    out.update(ler=ev, ler_counts=exchange.counts(), chunk_ms=statistics.median(rec.ms[1:]))
    if me == 0:
        out["qubit_logits"] = torch.cat(rec.q).numpy()
        out["logical_logits"] = torch.cat(rec.l).numpy()
    del rec

    # the halo modes on the first DIST_CHECK shots, with index_add_
    # deterministic, so that equal exchange buffers give equal logits; beside
    # them the same path twice with atomics (their noise), and the wire types
    # (gated on decisions) with atomics
    syn = sample_batch(torch.Generator(device=dev).manual_seed(DIST_SEED), dg, 0.05,
                       DIST_CHUNK).syndrome
    chk = syn[:DIST_CHECK]
    view = applies[wires[0]].view
    g, mb = view.rank, view.n_checks_pad
    with torch.inference_mode():
        again = applies[wires[0]](None, chk).qubit_logits
        if me == 0:
            out["atomics_max_abs_err"] = float(
                (again.cpu() - torch.from_numpy(out["qubit_logits"][:DIST_CHECK])).abs().max())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            logits = {k: applies[k](None, chk) for k in wires[:3]}
        finally:
            torch.use_deterministic_algorithms(False)
        lap("modes")
        logits.update({k: applies[k](None, chk) for k in wires[3:]})
        ref = logits[wires[0]]
        out["modes_max_abs_err"] = {
            k[0]: max(float((logits[k].qubit_logits - ref.qubit_logits).abs().max()),
                      float((logits[k].logical_logits - ref.logical_logits).abs().max()))
            for k in wires[1:3]}
        n = graph.n_qubits
        dec = lambda o: o.qubit_logits[:, :n].argmax(-1)
        out["wire_agree"] = {w: float((dec(logits[(h, w)]) == dec(ref)).float().mean())
                             for h, w in wires[3:]}
        del again, logits, ref
        lap("wires")
        # a round's exchange buffers (states of a 1024-shot chunk): ring and
        # alltoall equal, and equal to the rows the send tables pick from
        # the all-gathered blocks
        xc, xq, _ = model.embed(view, syn[:, g * mb:(g + 1) * mb])
        c_a, q_a = exchange.halo_exchange(view, xc, xq)
        c_r, q_r = exchange.halo_exchange(applies[wires[1]].view, xc, xq)
        pg = pgs[wires[0]]

        def from_blocks(x, send_idx, send_mask, block):
            """What each peer sends this rank, picked from the gathered blocks."""
            rows = send_idx[:, g, :].astype("int64") + block * np.arange(DIST_P)[:, None]
            rows = torch.from_numpy(rows.reshape(-1)).to(dev)
            mask = torch.from_numpy(send_mask[:, g, :].reshape(-1)).to(dev)
            return exchange.gather_rows(x, view.group).index_select(-2, rows) * mask[:, None]

        out["buffers_equal"] = {
            "ring": bool(torch.equal(c_a, c_r) and torch.equal(q_a, q_r)),
            "gather": bool(torch.equal(from_blocks(xq, pg.qsend_idx, pg.qsend_mask, pg.nb), q_a)
                           and torch.equal(from_blocks(xc, pg.csend_idx, pg.csend_mask, pg.mb),
                                           c_a))}
        del c_a, q_a, c_r, q_r
    torch.cuda.empty_cache()
    lap("buffers")

    # e. a round's exchanges (bytes a rank sends its peers, and ms) by mode
    # and wire type, the counted call warming each up for the timed one
    with torch.inference_mode():
        per_round = {}
        for k in wires:
            v = applies[k].view

            def round_exchange(v=v):
                if v.halo == "gather":
                    exchange.gather_rows(xq, v.group)
                    exchange.gather_rows(xc, v.group)
                else:
                    exchange.halo_exchange(v, xc, xq)
            exchange.reset_counts()
            round_exchange()
            sent = exchange.counts()
            per_round[f"{k[0]}_{k[1]}"] = dict(halo_bytes=sent["halo_bytes"],
                                                staged_bytes=sent["staged_bytes"],
                                                ms=sync_ms(round_exchange))
        out["per_round"] = per_round
    del applies, model, xc, xq, syn
    torch.cuda.empty_cache()
    lap("exchange_timing")

    # c. the sharded train step, mesh 2 x 2, the CLI's generic defaults at d=5
    tcfg = ExperimentConfig(code=CodeConfig(family="surface", distance=5, p=0.05),
                            model=ModelConfig(), train=TrainConfig())
    g5 = build_code("surface", 5, pad_nodes=16)
    dg5 = g5.to(dev)
    mesh22 = make_mesh(MeshConfig(data=2, graph=2))
    train = {}
    for wire, steps in (("float32", DIST_TRAIN_STEPS), ("int8", 2)):
        state = init_state(tcfg, g5, dev)
        start = [p.detach().clone() for p in state.model.parameters()]
        step = make_sharded_train_step(tcfg, state.model, mesh22, g5,
                                       partition_graph(g5, 2, halo_dtype=wire),
                                       state.optimizer, device=dev)
        gen = torch.Generator(device=dev).manual_seed(DIST_TRAIN_SEED)
        losses, step_ms, moved = [], [], None
        for i in range(steps):
            batch = sample_batch(gen, dg5, tcfg.code.p, tcfg.train.batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch)["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and wire == "float32" and me == 0:
                out["grads"] = {k: p.grad.detach().cpu()
                                for k, p in state.model.named_parameters()}
            if i == 1:
                moved = sum(float((p.detach() - q).abs().sum())
                            for p, q in zip(state.model.parameters(), start))
        train[wire] = dict(losses=losses, step_ms=step_ms, moved_after_2=moved)
        del state, step, start
    out["train"] = train
    lap("train")

    # d. dryrun's body (one sharded train step on its small mesh, at dryrun's
    # defaults) on these ranks, so that the phase starts no second set
    from tpugnn_torch.dist.api import _dryrun_rank

    out["dryrun_loss"] = _dryrun_rank(DIST_P, 5, "surface", 16, 2, "alltoall", "cuda")
    lap("dryrun")
    out["part_seconds"] = part_s
    return out


def wide_design_bytes(graph, batch: int, rounds: int, w: int, item: int,
                      backward: bool) -> tuple[float, float]:
    """``(hbm, l2_weights)``, a model, not a measurement: the bytes the wide
    kernels' design moves through HBM (its own traffic, against the
    function's least in ``rounds_bytes``) and the weight bytes it reads from
    L2 into shared memory, over ``rounds`` rounds at pack width ``w`` in a
    state type of ``item`` bytes (csrc/wide_rounds.cuh).

    HBM: a forward round reads each side's states twice (projection,
    update), writes and reads its gather source once (each slot's read of
    it counted once: the rest hit L2) and writes the new states.  The
    backward's round: the projection's; the replay's reads (stash, gather
    source, cotangent) and its residuals written once (hs, hc, rnd(dt),
    rnd(dydb), rnd(dhs), in bf16 rnd(dpre) too; dpre in f32); the gather
    adjoint's (rnd(dhs) read, dys written); the cotangent launch's (rnd(dydb),
    dys, rnd(dt) and dpre read, the cotangent read and written); and the
    weight gradients' ten A and ten G operands, each read W / 128 times.
    The bias gradients' column sums go to per-warp partials from the
    replay's registers and cross no HBM a row.

    L2 weights: every tile streams each of its products' [W, W] packs once
    (bf16 2 bytes an entry, f32 8: the TF32 halves).  A tile is 128 rows
    where one warpgroup holds a row's columns (bf16 W <= 256, f32 W = 128),
    else 64 (csrc/wide_mma.cuh, Geo); the replay's tiles are 64 rows (its
    two warpgroups split the columns) but f32 at W = 128, 128 rows
    (csrc/wide_rounds.cuh, ReplayGeo).  Five products a forward round and
    tile (projection included); a backward round's ten: the projection and
    the three cotangent products on the forward's tiles, the six replay
    products on the replay's."""
    rows = batch * (graph.n_checks + graph.n_qubits)
    pack = w * w * (8 if item == 4 else 2)

    def tiles(rt):
        return -(-batch * graph.n_checks // rt) + -(-batch * graph.n_qubits // rt)

    rt = 128 if w <= (128 if item == 4 else 256) else 64
    if not backward:
        return rounds * rows * w * item * 5, rounds * tiles(rt) * 5 * pack
    t = rows * w * item
    f = rows * w * 4
    res = t * (5 + (item == 2)) + f
    per_round = (2 * t + (2 * t + f + res) + 2 * t + (3 * t + 3 * f)
                 + 10 * t * (w // 128))
    rt_replay = 128 if item == 4 and w == 128 else 64
    return rounds * per_round, rounds * (tiles(rt) * 4 + tiles(rt_replay) * 6) * pack


def wide_timing(graph, dt: str, dev, batch: int, rounds: int) -> dict:
    """One timed call of each wide kernel (K1, K2a, K2b, K5) at H = MH =
    WIDE_H on ``graph`` (surface), B=``batch``, R=``rounds`` in state type
    ``dt``, its plain version's (one call; where the card runs out of
    memory, two half-batch calls), its bound (``rounds_flops`` at the bf16
    or 3xTF32 peak, or the function's bytes), the design's modelled bytes
    beside (``wide_design_bytes``: ``model_hbm_bytes``, their time at the
    HBM rate, ``model_l2_weight_bytes``), and the same kernels at H=128
    (W = 128; K5 there is roll_gather.cu's) on inputs of the same shapes."""
    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg

    f32 = dt == "float32"
    item = 4 if f32 else 2

    def plain_ms(fn, *halves):
        try:
            return time_ms(fn, warmup=0, iters=1), 1
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            return sum(time_ms(h, warmup=0, iters=1) for h in halves), 2

    out = dict(batch=batch, rounds=rounds, width=WIDE_H, state_dtype=dt)
    for h in (WIDE_H, 128):
        tag = "" if h == WIDE_H else "_h128"
        _, dg, ops, w, xc, xq, s, gen = random_round_case(D, batch, rounds, dt, 95, dev, h=h)
        mats32, vecs32 = fd.pack_weights_f32(w)
        cot_c = torch.randn(xc.shape, generator=gen, device=dev)
        cot_q = torch.randn(xq.shape, generator=gen, device=dev)
        half = batch // 2
        with torch.no_grad():
            reset_counts()
            k1 = lambda: fd.decoder_rounds(xc, xq, s, ops, w, rounds, dt)
            out[f"k1{tag}_ms"] = time_ms(k1, warmup=1, iters=3)
            k2a = lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, rounds, dt)
            out[f"k2a{tag}_ms"] = time_ms(k2a, warmup=1, iters=3)
            _, _, sc, sq = k2a()
            out[f"k2b{tag}_ms"] = time_ms(lambda: fb._bwd_cuda(
                sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dt), warmup=1, iters=3)
            r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(graph), w, dt)
            out[f"k5{tag}_ms"] = time_ms(lambda: rg._roll_rounds_cuda(r_ops, rounds=rounds),
                                         warmup=1, iters=3)
            out[f"launched{tag}"] = {k: v for k, v in counts().items() if v}
            if h == WIDE_H:
                sl = lambda t, i: t[i * half:(i + 1) * half]
                out["k1_plain_ms"], out["k1_plain_calls"] = plain_ms(
                    lambda: fd.rounds_plain(xc, xq, s, ops, w, rounds=rounds, state_dtype=dt),
                    *(lambda i=i: fd.rounds_plain(sl(xc, i), sl(xq, i), sl(s, i), ops, w,
                                                  rounds=rounds, state_dtype=dt)
                      for i in range(2)))
                out["k2a_plain_ms"], out["k2a_plain_calls"] = plain_ms(
                    lambda: fb.rounds_fwd_stash_plain(xc, xq, s, ops, mats32, vecs32,
                                                      rounds=rounds, state_dtype=dt),
                    *(lambda i=i: fb.rounds_fwd_stash_plain(
                        sl(xc, i), sl(xq, i), sl(s, i), ops, mats32, vecs32, rounds=rounds,
                        state_dtype=dt) for i in range(2)))
                out["k2b_plain_ms"], out["k2b_plain_calls"] = plain_ms(
                    lambda: fb.rounds_vjp_plain(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q,
                                                state_dtype=dt),
                    *(lambda i=i: fb.rounds_vjp_plain(
                        sc[:, i * half:(i + 1) * half], sq[:, i * half:(i + 1) * half],
                        sl(s, i), ops, mats32, vecs32, sl(cot_c, i), sl(cot_q, i),
                        state_dtype=dt) for i in range(2)))
                out["k5_plain_ms"], out["k5_plain_calls"] = plain_ms(
                    lambda: rg.roll_rounds_plain(r_ops, rounds=rounds),
                    *(lambda i=i: rg.roll_rounds_plain(r_ops._replace(
                        xc=sl(r_ops.xc, i), xq=sl(r_ops.xq, i), syn=sl(r_ops.syn, i)),
                        rounds=rounds) for i in range(2)))
        del xc, xq, s, sc, sq, cot_c, cot_q, r_ops, mats32, vecs32
        torch.cuda.empty_cache()
    peak = H100_TF32_FLOPS / 3 if f32 else H100_BF16_FLOPS
    flops = rounds_flops(graph, WIDE_H) * batch * rounds
    fwd_bound = bound(rounds_bytes(graph, batch, WIDE_H, item), flops, peak)
    tb = train_kernel_bounds(graph, batch, rounds, WIDE_H, out["k2a_ms"], out["k2b_ms"], dt)
    for k, (bms, by) in (("k1", fwd_bound), ("k5", fwd_bound),
                         ("k2a", (tb["k2a_bound_ms"], tb["k2a_bound_by"])),
                         ("k2b", (tb["k2b_bound_ms"], tb["k2b_bound_by"]))):
        out[f"{k}_bound_ms"], out[f"{k}_bound_by"] = bms, by
        out[f"{k}_bound_share"] = bms / out[f"{k}_ms"]
        hbm, l2w = wide_design_bytes(graph, batch, rounds, WIDE_H, item, k == "k2b")
        out[f"{k}_model_hbm_bytes"], out[f"{k}_model_l2_weight_bytes"] = hbm, l2w
        out[f"{k}_model_hbm_ms"] = hbm / H100_HBM_BPS * 1e3
    return out


def held_to_f32_states(errs: dict, what: str) -> list:
    """The gate of bf16 training steps (``train_steps_vs_plain`` with its
    witness): after each step, the kernels' worst-leaf and mean distance
    from the same steps with f32 states within BF16_F64_RATIO of the plain
    bf16 versions' (as bf16 K1 is held to the rounds in f64), and the
    zero-weight-gradient fault past that ratio, else the gate could not see
    it.  A bound on the kernels' distance from plain does not hold in bf16:
    the plain versions with every f32 product formed in f64 land up to
    2.8e-2 from plain on phase 6d's steps (scripts/wide_bf16_steps.py),
    summation order alone.  Raises; returns each step's distances."""
    def worst_mean(e):
        return max(e.values()), sum(e.values()) / len(e)

    out = []
    vs = errs["vs_f32"]
    for k, p, z in zip(vs["kernels"], vs["plain"], vs["zero_wgrads"]):
        (kw, km), (pw, pm), (zw, zm) = worst_mean(k), worst_mean(p), worst_mean(z)
        out.append(dict(kernels_worst=kw, kernels_mean=km, plain_worst=pw, plain_mean=pm,
                        zero_wgrads_worst=zw, zero_wgrads_mean=zm, ratio_worst=kw / pw,
                        ratio_mean=km / pm, zero_wgrads_ratio_worst=zw / pw,
                        zero_wgrads_ratio_mean=zm / pm, bound=BF16_F64_RATIO))
    if any(o["ratio_worst"] > BF16_F64_RATIO or o["ratio_mean"] > BF16_F64_RATIO for o in out):
        raise RuntimeError(f"{what}: the kernels land further from the f32-state steps than "
                           f"the plain bf16 versions: {out}")
    if any(o["zero_wgrads_ratio_worst"] <= BF16_F64_RATIO
           and o["zero_wgrads_ratio_mean"] <= BF16_F64_RATIO for o in out):
        raise RuntimeError(f"{what}: the zero-weight-gradient fault passes the gate: {out}")
    return out


def wide_train_state(h: int, dt: str, seed: int, dev):
    """Phase 6d's training config (surface WIDE_TRAIN_D, H = MH = ``h``,
    R=D13_ROUNDS, B=256, the fused backend in state type ``dt``) after two
    steps from init seed ``seed``: the state whose next steps the phase
    holds to the plain versions, and the config."""
    from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig
    from tpugnn_torch.train import train

    cfg = ExperimentConfig(
        code=CodeConfig(family="surface", distance=WIDE_TRAIN_D, p=0.05),
        model=ModelConfig(hidden=h, msg_hidden=h, rounds=D13_ROUNDS, backend="fused",
                          readout="both", qubit_head="pauli4", dtype=dt),
        train=TrainConfig(batch=256, steps=2, lr=1e-3, warmup_steps=200, eval_every=1000,
                          eval_shots=1024, seed=seed, p_mix=(0.01, 0.05)))
    state, _, _, _ = train(cfg, device=dev, log=lambda msg: None)
    return state, cfg


_WIDE_KERNEL = re.compile(r"wide_(fwd|replay|cotangent|wgrad)_kernelI(?:13__nv_bfloat16|f)"
                          r"(?:Li(\d+)E(?:Lb([01])ELb([01])E(?:Lb([01])E)?)?)?")


def wide_hgmma(counts: dict) -> dict:
    """The HGMMA (wgmma) count of each wide kernel instantiation in
    ``counts`` (:func:`sass_mma_counts` of a state type's two wide
    libraries with op HGMMA, merged), by the row of the kernels line it
    serves: K1 and K2a the table forward at each width, K5 the raster
    forward (bf16 slots apart), K2b its projection, replay, cotangent and
    weight-gradient kernels."""
    out = {"k1": {}, "k2a": {}, "k2b": {}, "k5": {}}
    for name, n in counts.items():
        m = _WIDE_KERNEL.search(name)
        if m is None:
            continue
        kind, w, roll, slot16, project = m.groups()
        if kind == "fwd" and project == "1":
            out["k2b"][f"project_w{w}"] = n
        elif kind == "fwd":
            tag = f"fwd_w{w}" + ("_roll" if roll == "1" else "") + ("_slot16" if slot16 == "1"
                                                                    else "")
            for k in (("k5",) if roll == "1" else ("k1", "k2a")):
                out[k][tag] = n
        else:
            out["k2b"][f"{kind}_w{w}" if w else kind] = n
    return out


def phase_wide_rounds(dev, info: dict) -> dict:
    """Phase 6d: widths above 128 on the wide kernels (and bf16 K5 past
    shared memory).  Gates, each raising:

    a. wide K1 and K5 (f32 slots; bf16 also bf16 slots) at H = MH = WIDE_H
       on d=11, and K1 on circuit d=5, against their plain versions in both
       state types (B=D13_BATCH, R=D13_ROUNDS; TOL_F32, and in bf16
       TOL_BF16_MAX / TOL_BF16_MEAN), each launching its wide kernel once
       and nothing else;
    b. wide K2a bit-equal to wide K1, within the state type's tolerances of
       its plain version, and wide K2b leaf by leaf against
       rounds_vjp_plain fed the same stash (TOL_GRAD_REL_F32 1e-4,
       TOL_GRAD_REL_BF16 1e-2), two K2b calls bit-equal (d=11 and circuit
       d=5, both state types; train_kernels_vs_plain);
    c. a decode through the model's own wrappers: a GNNDecoder of width
       WIDE_H on d=11 in bf16 (K1 wide once) and the same model's roll
       schedule (PallasDecoder, K5 wide once), each against its plain
       rounds as (a);
    d. TRAIN_CHECK_STEPS training steps of a WIDE_H model (surface
       WIDE_TRAIN_D, R=D13_ROUNDS) through K2a/K2b against the plain
       versions (train_steps_vs_plain): f32 within TRAIN_STEP_REL; bf16,
       on two seeds, held to the same steps with f32 states
       (held_to_f32_states), and a width-128 model's steps beside;
    e. the circuit d=5 training config through the CLI at --hidden and
       --msg-hidden WIDE_H for WIDE_CLI_STEPS steps: every step one wide
       K2a and one wide K2b and nothing else, the loss finite and falling
       (gate_training);
    f. bf16 K5 on surface K5_GP_D through its global panels against its
       plain version (B=D13_BATCH, R=D13_ROUNDS), a roll decode of a bf16
       model there (PallasDecoder), and on d=11 the two placements bit for
       bit (the shared limit lowered, B=D7_GP_BATCH);
    g. timings (wide_timing) in both state types, and bf16 K5's global
       variant at K5_GP_D, B=WIDE_TIMING_BATCH, R=WIDE_TIMING_ROUNDS;
    h. the wider packs: K1, K5, K2a and K2b at H = MH = 384 and 512 on surface
       d=5 (B=D13_BATCH, R=D13_ROUNDS), held as (a) and (b); f32 K2b at 384
       columns must refuse before any launch (``fb.F32_BWD_REFUSED``;
       ROADMAP.md, Queue 3: its slot ties there);
    i. cuobjdump -sass: HGMMA (wgmma) in every instantiation of the rounds
       kernels, W = 128 included (the forward in both modes, the replay, the
       cotangent and the weight gradients) in both state types.
    Returns the launches by path; ``info`` gets every number."""
    import torch

    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.kernels._build import load_library
    from tpugnn_torch.models import GNNDecoder, PallasDecoder
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.tanner import build_circuit_code, build_code

    launches = {}
    t0 = time.perf_counter()
    part_s = {}

    def lap(name):
        part_s[name] = round(time.perf_counter() - t0 - sum(part_s.values()), 3)

    # the rounds libraries (the build phase's): their nvcc seconds and the
    # kernels' registers and spills (under setmaxnreg the consumers may use
    # 240 registers; ptxas reports the launch's 168)
    wide_built = {n: _BUILT[n] for n in WIDE_LIBRARIES}
    info["build"] = {n: dict(library=os.path.relpath(p, REPO), build_seconds=round(sec, 3),
                             ptxas=ptxas_usage(blog, "wide_"))
                     for n, (p, sec, blog) in wide_built.items()}
    lap("build")

    # a. the wide forward kernels against their plain versions
    checks = {}
    circuit5 = build_circuit_code("surface", 5, 5)
    for dt in ("float32", "bfloat16"):
        checks[f"k1_d11_{dt}"] = rounds_vs_plain("k1", D, WIDE_H, dt, 90, dev, WIDE_NAMES[0])
        checks[f"k5_d11_{dt}"] = rounds_vs_plain("k5", D, WIDE_H, dt, 91, dev,
                                                 "roll_rounds_wide")
        g, _, ops, w, xc, xq, s, _ = random_round_case(5, D13_BATCH, D13_ROUNDS, dt, 92, dev,
                                                       h=WIDE_H, graph=circuit5)
        run, plain = kernel_and_plain("k1", g, ops, w, xc, xq, s, D13_ROUNDS, dt)
        checks[f"k1_circuit_d5_{dt}"] = held_to_plain(run, plain, WIDE_NAMES[0], dt,
                                                      f"wide K1 circuit d=5 {dt}")
    checks["k5_d11_bfloat16_slots"] = rounds_vs_plain("k5", D, WIDE_H, "bfloat16", 93, dev,
                                                      "roll_rounds_wide",
                                                      slot_dtype="bfloat16")
    info["vs_plain"] = checks
    lap("vs_plain")

    # b. K2a and K2b, on d=11 and on circuit d=5 (M=64 check rows against
    # N=304 qubit rows)
    train_checks = {}
    for dt in ("float32", "bfloat16"):
        for tag, graph in (("", None), ("_circuit_d5", circuit5)):
            g, dg, _, w, _, _, _, gen = random_round_case(D, D13_BATCH, D13_ROUNDS, dt, 94, dev,
                                                          h=WIDE_H, graph=graph)
            train_checks[dt + tag] = train_kernels_vs_plain(g, dg, w, gen, WIDE_NAMES, dt)
    info["train_kernels"] = train_checks
    lap("train_kernels")

    # c. a decode through the model's wrappers: K1 and K5 wide
    graph = build_code("surface", D)
    dg = graph.to(dev)
    model = GNNDecoder(ModelConfig(hidden=WIDE_H, msg_hidden=WIDE_H, rounds=D13_ROUNDS,
                                   backend="fused", qubit_head="pauli4", dtype="bfloat16"), k=1)
    model.init_random(torch.Generator().manual_seed(96), bias_std=0.1)
    model = model.to(dev).eval()
    syn = sample_batch(torch.Generator(device=dev).manual_seed(97), dg, 0.05,
                       D13_BATCH).syndrome
    decode = {}
    for path, dec_model, want in (("wide_decode", model, WIDE_NAMES[0]),
                                  ("wide_roll_decode", PallasDecoder(
                                      model, schedule=("rollgather",)), "roll_rounds_wide")):
        with torch.inference_mode():
            reset_counts()
            out = dec_model(dg, syn)
            launches[path] = launched = counts()
            torch.cuda.synchronize()
        decode[path] = dict(launches=launched, finite=bool(torch.isfinite(out.qubit_logits).all()))
        if launched[want] != 1 or sum(launched.values()) != 1 or not decode[path]["finite"]:
            raise RuntimeError(f"{path}: launched {launched}, not one {want}, or non-finite")
    info["decode"] = decode
    del model
    lap("decode")

    # d. training steps through K2a/K2b against the plain versions: f32 at
    # TRAIN_STEP_REL; bf16 against the same steps with f32 states
    # (held_to_f32_states), on two seeds, and beside it a width-128 model's
    steps = {}
    for dt, h, seed in (("float32", WIDE_H, 0), ("bfloat16", WIDE_H, 0),
                        ("bfloat16", WIDE_H, 1), ("bfloat16", 128, 0)):
        state, cfg = wide_train_state(h, dt, seed, dev)
        reset_counts()
        step_errs = train_steps_vs_plain(state, cfg, build_code("surface", WIDE_TRAIN_D).to(dev),
                                         dev, seed=77 + seed, witness=dt == "bfloat16")
        path = (f"wide_train_steps_{dt}" if h == WIDE_H else f"train_steps_h128_{dt}") + (
            f"_seed{seed}" if seed else "")
        launches[path] = counts()
        k_worst = [max(e.items(), key=lambda kv: kv[1]) for e in step_errs["kernels"]]
        steps[path] = dict(
            graph=f"surface d={WIDE_TRAIN_D}", width=h, rounds=D13_ROUNDS, batch=256,
            state_dtype=dt, seed=seed, steps=TRAIN_CHECK_STEPS, launches=launches[path],
            kernels_worst=[dict(leaf=n, rel=v) for n, v in k_worst],
            zero_wgrads_least=[dict(leaf=n, rel=v) for n, v in (
                min(((n, v) for n, v in e.items() if n.startswith("rounds.")),
                    key=lambda kv: kv[1]) for e in step_errs["zero_wgrads"])])
        if h == WIDE_H and not all(launches[path][n] for n in WIDE_NAMES[1:]):
            raise RuntimeError(f"width {WIDE_H} {dt}: the training steps did not launch the "
                               f"wide K2a and K2b: {launches[path]}")
        if dt == "float32":
            steps[path]["bound"] = TRAIN_STEP_REL
            if any(v > TRAIN_STEP_REL for _, v in k_worst):
                raise RuntimeError(f"width {WIDE_H}: steps through the wide K2a/K2b move the "
                                   f"parameters otherwise than the plain versions: "
                                   f"{steps[path]}")
        else:
            steps[path]["vs_f32_states"] = held_to_f32_states(
                step_errs, f"width {h} bf16 training steps, seed {seed}")
        del state
        torch.cuda.empty_cache()
    info["train_steps"] = steps
    lap("train_steps")

    # e. the circuit training config through the CLI at width WIDE_H
    argv = [*WIDE_CLI_ARGS, "--steps", str(WIDE_CLI_STEPS), "--eval-every",
            str(WIDE_CLI_STEPS)]
    reset_counts()
    with StepRecorder() as rec:
        row = run_cli(argv)[-1]
    launches["cli_train_wide"] = counts()
    summary = rec.summary()
    info["cli_train"] = dict(argv=argv, last_line=row, launches=launches["cli_train_wide"],
                             **summary)
    gate_training(f"cli train (circuit d=5, width {WIDE_H})", summary, WIDE_CLI_STEPS)
    step_want = {WIDE_NAMES[1]: 1, WIDE_NAMES[2]: 1}
    if any(c != {**dict.fromkeys(c, 0), **step_want} for c in rec.launches):
        raise RuntimeError(f"cli train (width {WIDE_H}): a step did not launch the wide K2a "
                           f"and K2b once each and nothing else: {rec.launches}")
    del rec
    torch.cuda.empty_cache()
    lap("cli_train")

    # f. bf16 K5 past shared memory (the d=17 graph built once: a large
    # code takes seconds to build on the host)
    g17 = build_code("surface", K5_GP_D)
    dg17 = g17.to(dev)
    g, _, ops, w, xc, xq, s, _ = random_round_case(K5_GP_D, D13_BATCH, D13_ROUNDS, "bfloat16",
                                                   98, dev, graph=g17)
    run, plain = kernel_and_plain("k5", g, ops, w, xc, xq, s, D13_ROUNDS, "bfloat16")
    gp = {"vs_plain": dict(d=K5_GP_D, batch=D13_BATCH, rounds=D13_ROUNDS, **held_to_plain(
        run, plain, "roll_rounds_tc_gpanels", "bfloat16", f"bf16 K5 d={K5_GP_D}"))}
    m17 = GNNDecoder(ModelConfig(hidden=128, msg_hidden=128, rounds=D13_ROUNDS,
                                 backend="fused", qubit_head="pauli4", dtype="bfloat16"), k=1)
    m17.init_random(torch.Generator().manual_seed(99), bias_std=0.1)
    roll17 = PallasDecoder(m17.to(dev).eval(), schedule=("rollgather",))
    syn17 = sample_batch(torch.Generator(device=dev).manual_seed(100), dg17, 0.05,
                         D13_BATCH).syndrome
    with torch.inference_mode():
        reset_counts()
        out = roll17(dg17, syn17)
        launches["roll_decode_d17"] = launched = counts()
    if launched["roll_rounds_tc_gpanels"] != 1 or sum(launched.values()) != 1 or not bool(
            torch.isfinite(out.qubit_logits).all()):
        raise RuntimeError(f"bf16 roll decode at d={K5_GP_D}: launched {launched}")
    gp["launches"] = launched["roll_rounds_tc_gpanels"]
    g11, _, _, w11, xc, xq, s, _ = random_round_case(D, D7_GP_BATCH, D13_ROUNDS, "bfloat16",
                                                     101, dev)
    r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(g11), w11, "bfloat16")
    lib = load_library("roll_gather")
    need = lib.roll_rounds_tc_gpanels_smem_bytes(r_ops.xc.shape[1])
    with torch.inference_mode():
        reset_counts()
        shared = rg._roll_rounds_cuda(r_ops, rounds=D13_ROUNDS)
        with smem_limit(rg, need):
            glob = rg._roll_rounds_cuda(r_ops, rounds=D13_ROUNDS)
        placed = counts()
        torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(shared, glob))
    gp["d11_placements"] = dict(batch=D7_GP_BATCH, rounds=D13_ROUNDS, gpanels_smem_bytes=need,
                                launched=placed, bit_equal=equal,
                                shared_smem_bytes=lib.roll_rounds_smem_bytes(
                                    1, r_ops.xc.shape[1]))
    if not equal or placed["roll_rounds"] != 1 or placed["roll_rounds_tc_gpanels"] != 1:
        raise RuntimeError(f"d=11 bf16 K5: the global-panel layout differs from the shared "
                           f"one: {gp['d11_placements']}")
    del r_ops, shared, glob, xc, xq, s
    l_pads = {d: -(-(d + 1) ** 2 // 8) * 8 for d in (15, 17, 19)}   # raster_plan's l_pad
    gp["smem_bytes"] = {f"d{d}": dict(shared=lib.roll_rounds_smem_bytes(1, lp),
                                      gpanels=lib.roll_rounds_tc_gpanels_smem_bytes(lp))
                        for d, lp in l_pads.items()}
    # its time at K5_GP_D, bench-like shapes, beside the plain version and its bound
    g, _, _, w, xc, xq, s, _ = random_round_case(K5_GP_D, WIDE_TIMING_BATCH, WIDE_TIMING_ROUNDS,
                                                 "bfloat16", 102, dev, graph=g17)
    r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(g), w, "bfloat16")
    with torch.inference_mode():
        gp_ms = time_ms(lambda: rg._roll_rounds_cuda(r_ops, rounds=WIDE_TIMING_ROUNDS),
                        warmup=1, iters=5)
        gp_plain_ms = time_ms(lambda: rg.roll_rounds_plain(r_ops, rounds=WIDE_TIMING_ROUNDS),
                              warmup=0, iters=1)
    gp_bound, gp_by = bound(rounds_bytes(g, WIDE_TIMING_BATCH, 128, 2),
                            rounds_flops(g, 128) * WIDE_TIMING_BATCH * WIDE_TIMING_ROUNDS,
                            H100_BF16_FLOPS)
    gp["timed"] = dict(d=K5_GP_D, batch=WIDE_TIMING_BATCH, rounds=WIDE_TIMING_ROUNDS,
                       ms=gp_ms, plain_ms=gp_plain_ms, bound_ms=gp_bound, bound_by=gp_by)
    info["k5_bfloat16_gpanels"] = gp
    del r_ops, xc, xq, s, roll17, m17
    torch.cuda.empty_cache()
    lap("k5_gpanels")

    # g. timings
    info["timed"] = {dt: wide_timing(graph, dt, dev, WIDE_TIMING_BATCH, WIDE_TIMING_ROUNDS)
                     for dt in ("bfloat16", "float32")}
    lap("timed")

    # h. the wider packs on d=5
    wider = {}
    for dt in ("float32", "bfloat16"):
        for h in WIDE_MORE_H:
            wider[f"k1_w{h}_{dt}"] = rounds_vs_plain("k1", WIDE_TRAIN_D, h, dt, 103, dev,
                                                     WIDE_NAMES[0])
            wider[f"k5_w{h}_{dt}"] = rounds_vs_plain("k5", WIDE_TRAIN_D, h, dt, 104, dev,
                                                     "roll_rounds_wide")
            g, dg, _, w, _, _, _, gen = random_round_case(WIDE_TRAIN_D, D13_BATCH, D13_ROUNDS, dt,
                                                          105, dev, h=h)
            wider[f"train_w{h}_{dt}"] = train_kernels_vs_plain(g, dg, w, gen, WIDE_NAMES, dt)
    info["wider"] = wider
    lap("wider")

    # i. HGMMA in every wide kernel
    hg = {}
    for dt in ("bfloat16", "float32"):
        libs = [fd.wide_library(fd.STATE_DTYPES[dt], backward=b) for b in (False, True)]
        hg[dt] = wide_hgmma({k: v for lib in libs
                             for k, v in sass_mma_counts(wide_built[lib][0], "HGMMA").items()})
    info["sass_hgmma"] = hg
    widths = (128, WIDE_H, *WIDE_MORE_H)   # K5's raster mode from WIDE_H on
    want = {"k1": len(widths), "k2a": len(widths), "k5": 2 * (len(widths) - 1),
            "k2b": 3 * len(widths) + 1}
    for dt, rows in hg.items():
        for k, n in want.items():
            n -= len(widths) - 1 if dt == "float32" and k == "k5" else 0   # f32: no bf16 slots
            if len(rows[k]) != n or not all(c > 0 for c in rows[k].values()):
                raise RuntimeError(f"a wide {dt} kernel is missing or runs no wgmma: {hg}")
    lap("sass_hgmma")
    info["part_seconds"] = part_s
    return launches


def phase_dist(dev, info: dict, card: str) -> dict:
    """Phase 4f: the port's dist/ on one card.  (a) NCCL at world size 1 in
    this process; (b) the d=15 decode of the DIST_P gloo ranks sharing the
    card (dist_ranks), held to the JAX f32 rate, and to the unsharded
    generic and K1 paths on the same shots, decoded here first; the halo
    modes and wire types; (c) the 2 x 2 sharded train step against the
    unsharded one; (d) dryrun's step on the same ranks.  Returns the
    launches of the K1 reference decodes."""
    import tempfile

    import torch
    import torch.distributed as dist

    from tpugnn_torch.configs import CodeConfig, ExperimentConfig, MeshConfig, ModelConfig
    from tpugnn_torch.configs import TrainConfig
    from tpugnn_torch.dist import exchange, make_mesh, make_sharded_apply, partition_graph
    from tpugnn_torch.dist.multihost import initialize, launch
    from tpugnn_torch.eval import count_failures, decode_corrections
    from tpugnn_torch.models.convert import load_decoder, read_meta
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.tanner import build_code
    from tpugnn_torch.train import init_state, loss_fn

    weights = os.path.join(REPO, "tpugnn_torch", "assets", DIST_WEIGHTS)
    label = f"{DIST_P} ranks time-sharing one {card}, gloo staged through the host"
    t0 = time.perf_counter()
    part_s = {}
    torch.cuda.empty_cache()

    # a. NCCL at world size 1, in this process, on the graph padded for the
    # ranks (the references below use it too)
    graph = build_code("surface", DIST_D, pad_nodes=8 * DIST_P)
    dg = graph.to(dev)
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    exchange.reset_counts()
    initialize("file://" + os.path.join(store, "store"), 1, 0, device="cuda")
    try:
        backend = dist.get_backend()
        _, model, _ = load_decoder(weights, device="cuda", backend="segment")
        apply = make_sharded_apply(model, make_mesh(MeshConfig(data=1, graph=1)),
                                   partition_graph(graph, 1), device=dev)
        syn = sample_batch(torch.Generator(device=dev).manual_seed(DIST_SEED), dg, 0.05,
                           DIST_CHUNK).syndrome
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with torch.inference_mode():
                got, want = apply(None, syn), model(dg, syn)
        finally:
            torch.use_deterministic_algorithms(False)
        err = max(float((got.qubit_logits - want.qubit_logits).abs().max()),
                  float((got.logical_logits - want.logical_logits).abs().max()))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    nccl_counts = exchange.counts()
    info["nccl_world1"] = dict(backend=backend, batch=DIST_CHUNK, max_abs_err=err,
                               tol=DIST_NCCL_TOL, exchanges=nccl_counts)
    if backend != "nccl" or not err <= DIST_NCCL_TOL or nccl_counts["staged_bytes"]:
        raise RuntimeError(f"dist (a): NCCL at world size 1: {info['nccl_world1']}")
    part_s["nccl_world1"] = time.perf_counter() - t0

    # b. the references on the ranks' shots: unsharded generic, and K1
    _, fused, _ = load_decoder(weights, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    chunks = DIST_SHOTS // DIST_CHUNK
    batches, generic, k1 = [], [], []
    reset_counts()
    with torch.inference_mode():
        for _ in range(chunks):
            b = sample_batch(gen, dg, 0.05, DIST_CHUNK)
            batches.append(b)
            generic.append(model(dg, b.syndrome))
            k1.append(shot_decisions(fused, dg, b))
    launched = counts()
    with torch.inference_mode():
        syn = batches[0].syndrome
        generic_ms = time_ms(lambda: model(dg, syn), warmup=1, iters=3)
        k1_ms = time_ms(lambda: fused(dg, syn), warmup=1, iters=3)
    # c. the unsharded step's gradients on the card
    tcfg = ExperimentConfig(code=CodeConfig(family="surface", distance=5, p=0.05),
                            model=ModelConfig(), train=TrainConfig())
    g5 = build_code("surface", 5, pad_nodes=16)
    dg5 = g5.to(dev)
    state = init_state(tcfg, g5, dev)
    total, _ = loss_fn(state.model, dg5, sample_batch(
        torch.Generator(device=dev).manual_seed(DIST_TRAIN_SEED), dg5, tcfg.code.p,
        tcfg.train.batch), tcfg)
    total.backward()
    ref_grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    del state, total
    torch.cuda.synchronize()
    part_s["references"] = time.perf_counter() - t0 - sum(part_s.values())

    # the ranks, alone on the card
    torch.cuda.empty_cache()
    results = launch(dist_ranks, DIST_P, args=(weights,), device="cuda", backend="gloo",
                     timeout=DIST_TIMEOUT_S, echo=False)
    part_s["ranks"] = time.perf_counter() - t0 - sum(part_s.values())

    r0 = results[0]
    ql, lgl = torch.from_numpy(r0["qubit_logits"]), torch.from_numpy(r0["logical_logits"])
    same_generic = same_k1 = 0
    logit_err = 0.0
    with torch.inference_mode():
        for i, (b, og, (fk, lk)) in enumerate(zip(batches, generic, k1)):
            q = ql[i * DIST_CHUNK:(i + 1) * DIST_CHUNK].to(dev)
            lg = lgl[i * DIST_CHUNK:(i + 1) * DIST_CHUNK].to(dev)
            fs = count_failures(dg, b, *decode_corrections(q), lg)
            fg = count_failures(dg, b, *decode_corrections(og.qubit_logits), og.logical_logits)
            same_generic += int(((fs["fail_qubit"] == fg["fail_qubit"])
                                 & ((lg > 0) == (og.logical_logits > 0)).all(-1)).sum())
            same_k1 += int(((fs["fail_qubit"] == fk["fail_qubit"])
                            & ((lg > 0) == lk).all(-1)).sum())
            logit_err = max(logit_err, float((q - og.qubit_logits).abs().max()),
                            float((lg - og.logical_logits).abs().max()))
    del batches, generic, k1, model, fused
    torch.cuda.empty_cache()
    ev, ref = r0["ler"], read_meta(weights)["ler_reference"]
    n = int(ev["shots"])
    z = {"logical_vs_jax_f32": z_score(ev["ler_logical"], n, ref["ler_logical"], ref["shots"]),
         "qubit_vs_jax_f32": z_score(ev["ler"], n, ref["ler"], ref["shots"])}
    staged_per_chunk = r0["ler_counts"]["staged_bytes"] / chunks
    info["decode"] = dict(
        weights=DIST_WEIGHTS, shards=DIST_P, halo="alltoall", wire="float32", p=0.05,
        shots=n, chunk=DIST_CHUNK, ler_qubit=ev["ler"], ler_logical=ev["ler_logical"],
        ler_hybrid=ev["ler_hybrid"], z=z, jax_f32=dict(shots=ref["shots"], ler=ref["ler"],
                                                       ler_logical=ref["ler_logical"]),
        shot_agreement_generic=same_generic / n, shot_agreement_k1=same_k1 / n,
        min_shot_agreement=DIST_SHOT_AGREE, logits_max_abs_err_vs_generic=logit_err,
        logit_tol=DIST_LOGIT_TOL, check_shots=DIST_CHECK,
        modes_max_abs_err=r0["modes_max_abs_err"], mode_tol=DIST_MODE_TOL,
        atomics_max_abs_err=r0["atomics_max_abs_err"], buffers_equal=r0["buffers_equal"],
        wire_agree=r0["wire_agree"], min_wire_agree=DIST_WIRE_AGREE,
        launches=launched)
    info["numbers"] = dict(
        on=label, chunk=DIST_CHUNK, sharded_chunk_ms=r0["chunk_ms"],
        unsharded_generic_ms=generic_ms, k1_ms=k1_ms,
        exchange_per_round=r0["per_round"], staged_bytes_per_chunk=staged_per_chunk,
        halo_bytes_per_chunk=r0["ler_counts"]["halo_bytes"] / chunks)
    if any(abs(v) > DIST_Z for v in z.values()):
        raise RuntimeError(f"dist (b): the sharded LER is off the JAX f32 rate: {z}")
    if any(r["ler"] != ev for r in results):
        raise RuntimeError("dist (b): the ranks' LER results differ")
    if min(same_generic, same_k1) / n < DIST_SHOT_AGREE or logit_err > DIST_LOGIT_TOL:
        raise RuntimeError(f"dist (b): the sharded decode departs from the unsharded one: "
                           f"{info['decode']}")
    if (max(r0["modes_max_abs_err"].values()) > DIST_MODE_TOL
            or not all(r0["buffers_equal"].values())
            or min(r0["wire_agree"].values()) < DIST_WIRE_AGREE):
        raise RuntimeError(f"dist (b): halo modes or wire types disagree: {info['decode']}")
    if launched["fused_rounds"] != chunks or sum(launched.values()) != chunks:
        raise RuntimeError(f"dist (b): the K1 reference launched {launched}")
    bytes_of = {k: v["halo_bytes"] for k, v in r0["per_round"].items()}
    if not (bytes_of["alltoall_float32"] == bytes_of["ring_float32"]
            and bytes_of["alltoall_bfloat16"] * 2 == bytes_of["alltoall_float32"]
            and 3.5 * bytes_of["alltoall_int8"] < bytes_of["alltoall_float32"]
            and staged_per_chunk > 0):
        raise RuntimeError(f"dist (b): halo bytes {bytes_of}, staged {staged_per_chunk}")

    # c. the sharded train step
    tr = r0["train"]
    grads = r0["grads"]
    vec = lambda gs: torch.cat([gs[k].flatten() for k in sorted(gs)])
    rel = float((vec(grads) - vec(ref_grads)).norm() / vec(ref_grads).norm())

    def leaf_rel(k):
        d, r = float((grads[k] - ref_grads[k]).norm()), float(ref_grads[k].norm())
        return d / r if r > 0 else (0.0 if d == 0 else math.inf)
    leaf = max(ref_grads, key=leaf_rel)
    losses = tr["float32"]["losses"]
    info["train"] = dict(
        mesh="data=2 x graph=2", config="surface d=5, H=128, R=8, B=256, segment, f32",
        losses=losses, int8_losses=tr["int8"]["losses"],
        step_ms_median=statistics.median(tr["float32"]["step_ms"][1:]),
        grad_rel_l2=rel, grad_bound=GENERIC_GRAD_REL,
        worst_leaf=dict(leaf=leaf, rel=leaf_rel(leaf)), leaf_bound=GENERIC_LEAF_REL,
        moved_after_2_f32=tr["float32"]["moved_after_2"],
        moved_after_2_int8=tr["int8"]["moved_after_2"], int8_move_bound=DIST_INT8_MOVE)
    if not (rel <= GENERIC_GRAD_REL and leaf_rel(leaf) <= GENERIC_LEAF_REL):
        raise RuntimeError(f"dist (c): sharded gradients differ from the unsharded step's: "
                           f"{info['train']}")
    if (not all(map(math.isfinite, losses + tr["int8"]["losses"]))
            or not statistics.mean(losses[-3:]) < statistics.mean(losses[:3])
            or any(r["train"]["float32"]["losses"] != losses for r in results)):
        raise RuntimeError(f"dist (c): the sharded training loss: {info['train']}")
    if not tr["int8"]["moved_after_2"] > DIST_INT8_MOVE * tr["float32"]["moved_after_2"]:
        raise RuntimeError(f"dist (c): int8 steps do not move the parameters: {info['train']}")

    # d. dryrun's step: the same loss on every rank, within dryrun's own test
    dry = [r["dryrun_loss"] for r in results]
    info["dryrun"] = dict(ranks=DIST_P, losses=dry, loss=dry[0])
    if (not all(map(math.isfinite, dry))
            or max(dry) - min(dry) > 1e-6 * max(1.0, abs(dry[0]))):
        raise RuntimeError(f"dist (d): the dry-run step's losses differ: {dry}")
    part_s["checks"] = time.perf_counter() - t0 - sum(part_s.values())
    info["part_seconds"] = part_s
    info["rank0_part_seconds"] = r0["part_seconds"]
    return {"dist": launched}


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
    from tpugnn_torch.kernels._build import SOURCES, build_libraries, nvcc_path
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
        import threading

        from tpugnn_torch.utils import native

        t0 = time.perf_counter()
        host = {}

        def build_host():       # the host decoders' g++ build, beside nvcc's
            try:
                native.load()
                host["seconds"] = round(time.perf_counter() - t0, 3)
            except Exception as e:      # raised below, in this thread
                host["error"] = e

        host_thread = threading.Thread(target=build_host)
        host_thread.start()
        # one nvcc per source, all at once
        built = build_libraries(list(SOURCES))
        _BUILT.update(built)
        host_thread.join()
        if "error" in host:
            raise host["error"]
        for name, (path, seconds, build_log) in built.items():
            log(build_log)
            info[name] = dict(library=os.path.relpath(path, REPO), cold=seconds > 0,
                              build_seconds=round(seconds, 3))
        # the W = 128 rounds kernels' registers and spills (under setmaxnreg
        # the consumers may use 240 registers; ptxas reports the launch's 168)
        info["w128_ptxas"] = {n: ptxas_usage(built[n][2], "Li128E|wgrad")
                              for n in WIDE_LIBRARIES}
        info["host_library_seconds"] = host["seconds"]
        # the phases' HMMA and HGMMA checks, disassembled while the phases run
        prefetch_sass([built[n][0] for n in ("sddmm", "roll_gather", "roll_gather_tf32")])
        prefetch_sass([built[n][0] for n in WIDE_LIBRARIES], "HGMMA")
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
            if dtype == "float32":   # both against the same rounds in f64
                with torch.inference_mode():
                    exact = rounds_f64_chunked(xc, xq, s, ops, w, rounds)
                    info[dtype].update(kernel_vs_f64_max=raster_errors(kc, kq, *exact)[0],
                                       plain_vs_f64_max=raster_errors(pc, pq, *exact)[0],
                                       tol_vs_f64=TOL_F32)
                del exact
            if not finite:
                raise RuntimeError(f"{dtype}: kernel produced non-finite states")
            if (max_err > tol_max or mean_err > tol_mean or agree < min_agree
                    or info[dtype].get("kernel_vs_f64_max", 0.0) > TOL_F32):
                raise RuntimeError(f"{dtype} R={rounds}: kernel disagrees with "
                                   f"rounds_plain or the f64 rounds: {info[dtype]}")
        # the yardstick's function, checked once in f32 against the plain version
        with torch.inference_mode():
            yc, yq = yardstick_rounds(xc, xq, s, dg, w, 14, torch.float32)
            info["yardstick_vs_plain_f32"] = float(torch.maximum(
                (yc - pc).abs().max(), (yq - pq).abs().max()))
        # d=13 in bf16: 176-row sides
        info["d13_bfloat16"] = rounds_vs_plain("k1", 13, h, "bfloat16", 12, dev,
                                               "fused_rounds")
        # f32 at d=13 and d=15, the largest surface codes
        info["d13_d15_float32"] = {
            f"d{d}": rounds_vs_plain("k1", d, h, "float32", 20 + d, dev, "fused_rounds")
            for d in (13, 15)}
        # narrower models on the kernel's 128 columns, zero-padded (d=11)
        info["padded_widths"] = {
            f"h{hw}_{dt}": rounds_vs_plain("k1", D, hw, dt, 40 + hw, dev, "fused_rounds")
            for hw in (64, 96) for dt in ("bfloat16", "float32")}
        gp_checks, pw_checks = info["d13_d15_float32"], info["padded_widths"]
        # K1's and K2a's f32 kernel at W = 128 runs its products on wgmma
        f32_hgmma = hgmma_w128("float32")
        info["f32_sass_hgmma"] = f32_hgmma
        k1_f32_check = dict(info["float32"], sass_hgmma=f32_hgmma["k1"])

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
        launches.update(phase_serve_cleanup(graph, dev, reqs, info))

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

    with Phase("checkpoints") as info:
        launches["checkpoints"] = phase_checkpoints(
            dev, {"ev": ev, "launches": launches["ler"]}, info)

    with Phase("hybrid") as info:
        launches["hybrid"] = phase_hybrid(graph, dev, trained, ev, info)

    with Phase("detector_and_stream") as info:
        det_launches, det_k1 = phase_detector_and_stream(dev, info)
        launches.update(det_launches)

    with Phase("circuit_and_cli") as info:
        circ_launches, circ_k1, circ_k2 = phase_circuit_and_cli(dev, info)
        launches.update(circ_launches)

    with Phase("circuit_d7_bfloat16") as info:
        launches.update(phase_circuit_d7_bfloat16(dev, info))
        d7 = dict(info)

    with Phase("dist") as info:
        launches.update(phase_dist(dev, info, smi))

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
                                                   state_dtype="bfloat16"), warmup=1, iters=3)
            y_ms = time_ms(lambda: yardstick_rounds(xc, xq, s, dg, w, rounds, torch.bfloat16),
                           warmup=1, iters=5)
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
            fwd_ms = time_ms(lambda: trained(dg, syn), warmup=1, iters=5)
            rk_ms = time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, wt, r_t, "float32"),
                            warmup=1, iters=5)
        flops_t = rounds_flops(graph, h) * b * r_t
        info.update(trained_forward_ms=fwd_ms, trained_kernel_ms=rk_ms,
                    trained_gflop=flops_t / 1e9,
                    trained_bound_ms=bound(rounds_bytes(graph, b, h, 4), 3 * flops_t,
                                           H100_TF32_FLOPS)[0],
                    trained_f32_core_ms=flops_t / H100_F32_FLOPS * 1e3,
                    trained_tf32x3_floor_ms=tf32x3_floor_ms(flops_t),
                    trained_kernel_share=rk_ms / fwd_ms,
                    trained_edges_per_s=b * graph.n_edges * r_t / (fwd_ms / 1e3))
        # K1 at the d=13 and d=15 checkpoints' shapes, and K1 and K5 on the
        # padded widths of the d=3 and d=5 checkpoints
        info["d13_d15_float32"] = {
            f"d{d}": f32_rounds_timing("fused_rounds", d, dev, 50 + d) for d in (13, 15)}
        info["padded_width"] = {f"d{d}_h{hw}": padded_width_timing(d, hw, dev, 60 + d)
                                for d, hw in ((3, 64), (5, 96))}
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
                # K2a is K1 with its stash flag, equal bit for bit
                k2a_vs_k1 = raster_errors(kc, kq, k1c, k1q)[0]
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
                rounds=rounds, batch=B, k2a_equals_k1=same_as_k1, k2a_vs_k1_max=k2a_vs_k1,
                k2b_repeatable=repeatable,
                k2a_vs_plain_max=float(out_diff.max()), k2a_vs_plain_mean=float(out_diff.mean()),
                stash_vs_plain_max=st_max, stash_vs_plain_mean=st_sum / st_n,
                k2b_max_abs_err=grad_max, k2b_worst_rel=rels[worst], k2b_worst_leaf=worst,
                k2b_rel=rels, tol_rel=tol_rel, tol_max=tol_max, tol_mean=tol_mean)
            train_errs[dtype] = info[dtype]
            if not finite:
                raise RuntimeError(f"{dtype}: K2a/K2b produced non-finite values")
            if not same_as_k1:
                raise RuntimeError(f"{dtype}: K2a's outputs differ from K1's: {k2a_vs_k1}")
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
            del kc, kq, pc, pq, psc, psq, kg, pg, out_diff
            torch.cuda.empty_cache()
            if dtype == "float32":   # the f32 training kernels at the flagship shape
                with torch.no_grad():
                    k2a_ms = time_ms(lambda: fb._fwd_stash_cuda(
                        xc, xq, s, ops, mats32, vecs32, rounds, dtype), warmup=1, iters=5)
                    k2b_ms = time_ms(lambda: fb._bwd_cuda(
                        sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dtype), warmup=1, iters=3)
                    plain_fwd_ms = time_ms(lambda: fb.rounds_fwd_stash_plain(
                        xc, xq, s, ops, mats32, vecs32, rounds=rounds, state_dtype=dtype),
                        warmup=0, iters=1)
                    plain_bwd_ms = time_ms(lambda: fb.rounds_vjp_plain(
                        sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, state_dtype=dtype),
                        warmup=0, iters=1)
                del sc, sq
                # every product of the f32 K2b kernels on wgmma
                info[dtype].update(
                    k2a_ms=k2a_ms, k2b_ms=k2b_ms, plain_fwd_stash_ms=plain_fwd_ms,
                    plain_vjp_ms=plain_bwd_ms, k2b_sass_hgmma=f32_hgmma["k2b"],
                    stash_gb=stash_bytes(graph, B, rounds, h, 4) / 1e9,
                    **train_kernel_bounds(graph, B, rounds, h, k2a_ms, k2b_ms, dtype),
                    **yardstick_training_times(xc, xq, s, dg, w, cot_c, cot_q, rounds,
                                               torch.float32))
            else:
                del sc, sq
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
        # a model of width 64 trains through K2a/K2b on padded operands
        info["width64"] = {dt: train_width_check(dt, dg, dev) for dt in ("bfloat16", "float32")}

    with Phase("f32_training_past_smem") as info:
        launches.update(phase_f32_training_past_smem(dev, info))
        f32gp = dict(info)

    with Phase("fused_configs") as info:
        launches.update(phase_fused_configs(dev, info))

    with Phase("wide_rounds") as info:
        launches.update(phase_wide_rounds(dev, info))
        wide = dict(info)

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
        if any(c != {**dict.fromkeys(c, 0), "fused_rounds_fwd_stash": 1, "fused_rounds_bwd": 1}
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
                warmup=0, iters=1)
            plain_bwd_ms = time_ms(lambda: fb.rounds_vjp_plain(
                sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, state_dtype="bfloat16"),
                warmup=0, iters=1)
        del sc, sq
        yard = yardstick_training_times(xc, xq, s, dg, w, cot_c, cot_q, rounds, torch.bfloat16)
        info.update(
            k2a_ms=k2a_ms, k2b_ms=k2b_ms, plain_fwd_stash_ms=plain_fwd_ms,
            plain_vjp_ms=plain_bwd_ms,
            **train_kernel_bounds(graph, B, rounds, h, k2a_ms, k2b_ms),
            rounds_share_of_step=(k2a_ms + k2b_ms) / statistics.median(step_ms), **yard)
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
        roll_info = dict(info)
    del trained

    def by_path(kernel, bf16_d7: bool | None = None):
        """Launches of ``kernel`` by path; with ``bf16_d7`` only (True) or
        all but (False) phase 4g's paths (circuit d=7 in bf16)."""
        return {p: c[kernel] for p, c in launches.items() if c[kernel] and (
            bf16_d7 is None or p.endswith("_d7_bf16") == bf16_d7)}

    def row(name, **kw):
        paths = by_path(name)
        return {"name": name, "route": "cuda", "launches": sum(paths.values()),
                "launches_by_path": paths, **kw}

    def variant(name, source: str, checks: dict, timings: dict) -> dict:
        """An f32 variant's fields (K5's global panels): its source, its
        launches, its max error against the plain version (B=64, R=3 and at
        the timed shapes), and per graph its time, the plain version's and
        its bound."""
        paths = by_path(name, bf16_d7=False)
        return dict(name=name, source=source, launches=sum(paths.values()),
                    launches_by_path=paths, **larger_graphs(checks, timings))

    def larger_graphs(checks: dict, timings: dict) -> dict:
        """The max error against the plain version of the cases in
        ``checks`` (B=64, R=3) and ``timings`` (the timed shapes), and per
        graph the time, the plain version's and the bound."""
        return dict(max_abs_err=max(max(v["max_abs_err"] for v in checks.values()),
                                    max(v["max_abs_err"] for v in timings.values())),
                    **{d: {k: t[k] for k in ("batch", "rounds", "real_rows", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "tflops",
                                             "tf32x3_floor_ms", "f32_core_ms") if k in t}
                       for d, t in timings.items()})

    def circuit_d7(k: int, **kw) -> dict:
        """K1 (k=0), K2a (1) or K2b (2) on the circuit d=7 checkpoint in bf16
        (phase 4g): its launches there, its time at B=4096, R=8 beside its
        plain version's and its bound, and its HGMMA count."""
        t, c = d7["timed"], d7["checks"]
        tag = ("k1", "k2a", "k2b")[k]
        paths = by_path(ROUNDS_NAMES[k], bf16_d7=True)
        return dict(launches=sum(paths.values()), launches_by_path=paths, graph=c["graph"],
                    batch=t["timed_batch"], rounds=t["timed_rounds"],
                    sass_hgmma=d7["sass_hgmma"][tag], **kw)

    def surface_d13(k: int, **kw) -> dict:
        """K2a (k=1) or K2b (2) with f32 states on surface d=13 (phase 6b):
        its error against the plain version (B=64, R=3), its time at
        B=4096, R=TRAINED_ROUNDS beside its plain version's and its 3xTF32
        bound."""
        t = f32gp["timed"]
        tag = ("k1", "k2a", "k2b")[k]
        return dict(graph="surface d=13", batch=t["timed_batch"], rounds=t["timed_rounds"],
                    ms=t[f"{tag}_ms"],
                    plain_ms=t["plain_fwd_stash_ms" if k == 1 else "plain_vjp_ms"],
                    plain_calls=t["plain_calls"], bound_ms=t[f"{tag}_bound_ms"],
                    bound_by=t[f"{tag}_bound_by"], f32_core_ms=t[f"{tag}_f32_core_ms"],
                    tflops=t[f"{tag}_tflops"], **kw)

    def padded(kernel: str, checks: dict) -> dict:
        """The padded widths' fields: max errors against the plain version by
        state type (H=64 and 96 at d=11, B=64, R=3, and every timed case) and
        per case the d=3 (H=64) and d=5 (H=96) times and errors beside a
        128-wide model's on the same graph."""
        cases = timing["padded_width"]

        def worst(dtype):
            return max([v["max_abs_err"] for k, v in checks.items() if dtype in k] +
                       [v for t in cases.values() for k, v in t.items()
                        if k.startswith(f"{kernel}_max_abs_err_{dtype}")])
        return dict(
            max_abs_err=worst("bfloat16"), max_abs_err_f32=worst("float32"),
            **{case: {k.replace(f"{kernel}_", "", 1): v for k, v in t.items()
                      if k.startswith(f"{kernel}_")}
               for case, t in cases.items()})

    def wide_rows() -> list:
        """The wide kernels' rows (phase 6d): bf16 numbers at the top, f32
        under ``f32``; times at d=11, H = MH = WIDE_H, B=WIDE_TIMING_BATCH,
        R=WIDE_TIMING_ROUNDS beside the same kernel's at H=128 (W = 128)
        (``h128_ms``), and the HGMMA count of each instantiation of the row's
        kernels (``sass_hgmma``).  The design's modelled bytes stay in phase
        6d's info (``timed``): nothing in this line is a model."""
        vs, tk, tm = wide["vs_plain"], wide["train_kernels"], wide["timed"]
        err = lambda k, dt: max(v["max_abs_err"] for n, v in vs.items()
                                if n.startswith(k) and dt in n)
        out = []
        for name, k, replaces in (
                (WIDE_NAMES[0], "k1", "tpugnn/kernels/fused_decoder.py:637"),
                (WIDE_NAMES[1], "k2a", "tpugnn/kernels/fused_backward.py:575"),
                (WIDE_NAMES[2], "k2b", "tpugnn/kernels/fused_backward.py:624"),
                ("roll_rounds_wide", "k5", "tpugnn/kernels/roll_gather.py:364")):
            def numbers(dt):
                t = tm[dt]
                n = dict(ms=t[f"{k}_ms"], plain_ms=t[f"{k}_plain_ms"],
                         plain_calls=t[f"{k}_plain_calls"], bound_ms=t[f"{k}_bound_ms"],
                         bound_by=t[f"{k}_bound_by"], h128_ms=t[f"{k}_h128_ms"],
                         sass_hgmma=wide["sass_hgmma"][dt][k])
                if k in ("k1", "k5"):
                    n["max_abs_err"] = err(k, dt)
                elif k == "k2a":   # d=11 and circuit d=5
                    cs = (tk[dt], tk[dt + "_circuit_d5"])
                    n.update(max_abs_err=max(max(c["k2a_vs_plain_max"], c["stash_vs_plain_max"])
                                             for c in cs),
                             equals_k1=all(c["k2a_equals_k1"] for c in cs))
                else:
                    cs = (tk[dt], tk[dt + "_circuit_d5"])
                    n.update(max_abs_err=max(c["k2b_max_abs_err"] for c in cs),
                             max_rel_err=max(c["k2b_worst_rel"] for c in cs),
                             repeatable=all(c["k2b_repeatable"] for c in cs))
                return n
            out.append(row(name, source="tpugnn_torch/kernels/csrc/wide_rounds.cuh",
                           replaces=replaces, width=WIDE_H, batch=WIDE_TIMING_BATCH,
                           rounds=WIDE_TIMING_ROUNDS, library_ms=None, **numbers("bfloat16"),
                           f32=numbers("float32")))
        return out

    src = "tpugnn_torch/kernels/csrc/wide_rounds.cuh"
    emit({"kernels": [row(
        "fused_rounds", source=src, libraries=list(WIDE_LIBRARIES[:2]), width=128,
        replaces="tpugnn/kernels/fused_decoder.py:637",
        max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
        ms=timing["kernel_ms"], plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
        library_ms=None, yardstick_ms=timing["yardstick_ms"],
        f32_trained=dict(batch=B, rounds=TRAINED_ROUNDS, ms=timing["trained_kernel_ms"],
                         bound_ms=timing["trained_bound_ms"],
                         f32_core_ms=timing["trained_f32_core_ms"],
                         tf32x3_floor_ms=timing["trained_tf32x3_floor_ms"],
                         **{k: k1_f32_check[k] for k in ("max_abs_err", "kernel_vs_f64_max",
                                                         "plain_vs_f64_max", "sass_hgmma")}),
        d13_d15_float32=larger_graphs(gp_checks, timing["d13_d15_float32"]),
        padded_width=padded("k1", pw_checks),
        detector_graph=det_k1, circuit_graphs=circ_k1,
        circuit_d5_bfloat16={"graph": circ_k2["graph"], **circ_k2["k1_bfloat16"]},
        circuit_d7_bfloat16=circuit_d7(
            0, max_abs_err=d7["checks"]["k2a_vs_plain_max"],   # B=64: K2a's, bit-equal to K1
            b4096={k: d7["timed"]["k1_bfloat16"][k] for k in (
                "max_abs_err", "mean_abs_err", "vs_f64_max", "vs_f64_mean", "plain_vs_f64_max",
                "plain_vs_f64_mean", "f64_ratio_bound")},
            ms=d7["timed"]["k1_bfloat16"]["ms"], plain_ms=d7["timed"]["k1_bfloat16"]["plain_ms"],
            bound_ms=d7["timed"]["k1_bfloat16"]["bound_ms"],
            bound_by=d7["timed"]["k1_bfloat16"]["bound_by"]),
    ), row(
        "fused_rounds_fwd_stash", source=src, libraries=list(WIDE_LIBRARIES[:2]), width=128,
        replaces="tpugnn/kernels/fused_backward.py:575",
        max_abs_err=train_errs["bfloat16"]["k2a_vs_plain_max"],
        max_abs_err_f32=train_errs["float32"]["k2a_vs_plain_max"],
        ms=train_timing["k2a_ms"], plain_ms=train_timing["plain_fwd_stash_ms"],
        bound_ms=train_timing["k2a_bound_ms"], bound_by=train_timing["k2a_bound_by"],
        library_ms=None, yardstick_ms=train_timing["yardstick_fwd_ms"],
        f32=dict(batch=B, rounds=train_errs["float32"]["rounds"],
                 sass_hgmma=f32_hgmma["k2a"], equals_k1=train_errs["float32"]["k2a_equals_k1"],
                 plain_ms=train_errs["float32"]["plain_fwd_stash_ms"],
                 yardstick_ms=train_errs["float32"]["yardstick_fwd_ms"],
                 **{k: train_errs["float32"][k] for k in (
                     "k2a_ms", "k2a_bound_ms", "k2a_bound_by", "k2a_f32_core_ms",
                     "k2a_tflops", "stash_gb", "yardstick_rounds")}),
        circuit_d5={k: circ_k2[k] for k in (
            "graph", "k2a_ms", "plain_fwd_stash_ms", "k2a_bound_ms", "k2a_bound_by",
            "k2a_vs_plain_max", "stash_vs_plain_max", "timed_batch", "timed_rounds")},
        circuit_d7_bfloat16=circuit_d7(
            1, max_abs_err=max(d7["checks"]["k2a_vs_plain_max"], d7["checks"]["stash_vs_plain_max"]),
            ms=d7["timed"]["k2a_ms"], plain_ms=d7["timed"]["plain_fwd_stash_ms"],
            bound_ms=d7["timed"]["k2a_bound_ms"], bound_by=d7["timed"]["k2a_bound_by"],
            equals_k1=d7["checks"]["k2a_equals_k1"]),
        d13_float32=surface_d13(
            1, max_abs_err=max(f32gp["d13"]["k2a_vs_plain_max"],
                               f32gp["d13"]["stash_vs_plain_max"]),
            equals_k1=f32gp["d13"]["k2a_equals_k1"]),
    ), row(
        "fused_rounds_bwd", source=src, libraries=list(WIDE_LIBRARIES[2:]), width=128,
        replaces="tpugnn/kernels/fused_backward.py:624",
        max_abs_err=train_errs["bfloat16"]["k2b_max_abs_err"],
        max_rel_err=train_errs["bfloat16"]["k2b_worst_rel"],
        max_rel_err_f32=train_errs["float32"]["k2b_worst_rel"],
        ms=train_timing["k2b_ms"], plain_ms=train_timing["plain_vjp_ms"],
        bound_ms=train_timing["k2b_bound_ms"], bound_by=train_timing["k2b_bound_by"],
        library_ms=None, yardstick_ms=train_timing["yardstick_bwd_ms"],
        f32=dict(batch=B, rounds=train_errs["float32"]["rounds"],
                 sass_hgmma=train_errs["float32"]["k2b_sass_hgmma"],
                 f32_core_ms=train_errs["float32"]["k2b_f32_core_ms"],
                 plain_ms=train_errs["float32"]["plain_vjp_ms"],
                 yardstick_ms=train_errs["float32"]["yardstick_bwd_ms"],
                 **{k: train_errs["float32"][k] for k in (
                     "k2b_ms", "k2b_bound_ms", "k2b_bound_by", "k2b_tflops", "k2b_worst_rel",
                     "k2b_repeatable", "yardstick_rounds")}),
        circuit_d5={k: circ_k2[k] for k in (
            "graph", "k2b_ms", "plain_vjp_ms", "k2b_bound_ms", "k2b_bound_by",
            "k2b_max_abs_err", "k2b_worst_rel", "timed_batch", "timed_rounds")},
        circuit_f32_trained={g: {k: c[k] for k in ("k2b_worst_rel", "k2b_worst_leaf",
                                                   "k2b_repeatable", "tol_rel")}
                             for g, c in circ_k2["f32_k2b_trained"].items()},
        circuit_d7_bfloat16=circuit_d7(
            2, max_abs_err=d7["checks"]["k2b_max_abs_err"],
            max_rel_err=d7["checks"]["k2b_worst_rel"], ms=d7["timed"]["k2b_ms"],
            plain_ms=d7["timed"]["plain_vjp_ms"], bound_ms=d7["timed"]["k2b_bound_ms"],
            bound_by=d7["timed"]["k2b_bound_by"], repeatable=d7["checks"]["k2b_repeatable"]),
        d13_float32=surface_d13(
            2, max_abs_err=f32gp["d13"]["k2b_max_abs_err"],
            max_rel_err=f32gp["d13"]["k2b_worst_rel"],
            repeatable=f32gp["d13"]["k2b_repeatable"]),
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
        source_float32="tpugnn_torch/kernels/csrc/roll_gather_tf32.cu",
        replaces="tpugnn/kernels/roll_gather.py:364", **roll_row,
        f32_larger={d: {k: t[k] for k in (
            "kernel", "rounds", "ms", "plain_ms", "bound_ms", "bound_by", "tf32x3_floor_ms",
            "f32_core_ms", "max_abs_err")} for d, t in roll_info["larger_float32_timing"].items()},
        gpanels=variant("roll_rounds_gpanels", "tpugnn_torch/kernels/csrc/roll_gather_tf32.cu", *(
            {d: c for d, c in roll_info[key].items() if c["kernel"] == "roll_rounds_gpanels"}
            for key in ("larger_float32", "larger_float32_timing"))),
        padded_width=padded("k5", roll_info["padded_widths"]),
        gpanels_bfloat16=dict(
            name="roll_rounds_tc_gpanels", route="cuda",
            source="tpugnn_torch/kernels/csrc/roll_gather.cu",
            replaces="tpugnn/kernels/roll_gather.py:364",
            launches=sum(by_path("roll_rounds_tc_gpanels").values()),
            launches_by_path=by_path("roll_rounds_tc_gpanels"),
            max_abs_err=wide["k5_bfloat16_gpanels"]["vs_plain"]["max_abs_err"],
            d11_bit_equal_to_shared=wide["k5_bfloat16_gpanels"]["d11_placements"]["bit_equal"],
            library_ms=None, sass_hmma={k: v for k, v in roll_info["sass_hmma"].items()
                                        if "roll_rounds_tc_gpanels_kernel" in k},
            **wide["k5_bfloat16_gpanels"]["timed"]),
    ), *wide_rows()]})
    # no performance gain is claimed by this script's run
    emit({"total_seconds": round(time.perf_counter() - t_start, 3), "claim": None})
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0].strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
