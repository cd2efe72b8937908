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

Phases 3 and 4 are the main path; the kernel's launch count is reset before
and read after each.  Then it prints the kernel table as one JSON line, the
card's name and power limit, and last {"ok": true, "device": {...}}.  Any
failure raises and exits nonzero.  It exits nonzero without printing a result
when there is no CUDA device or when run outside the repository.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import faulthandler
import json
import os
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
    from tpugnn_torch.kernels._build import build_library, nvcc_path
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
        path, seconds, build_log = build_library()
        log(build_log)
        info.update(library=os.path.relpath(path, REPO), cold=seconds > 0,
                    build_seconds=round(seconds, 3))

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

    emit({"kernels": [{
        "name": "fused_rounds", "route": "cuda",
        "source": "tpugnn_torch/kernels/csrc/fused_rounds.cu",
        "replaces": "tpugnn/kernels/fused_decoder.py:637",
        "launches": launches["serve"] + launches["ler"],
        "max_abs_err": errs["bfloat16"], "max_abs_err_f32": errs["float32"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "yardstick_ms": timing["yardstick_ms"],
    }]})
    emit({"total_seconds": round(time.perf_counter() - t_start, 3)})
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0].strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
