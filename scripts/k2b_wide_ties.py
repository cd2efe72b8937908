#!/usr/bin/env python3
"""f32 wide K2b's slot-tie re-decisions against the plain version's
products, on one NVIDIA card.

    python3 scripts/k2b_wide_ties.py [--parent DIR]

On ``chip_smoke.py`` phase 6d (h)'s case (surface d=5, B=64, R=3, seeded
random weights of width W, ``chip_smoke.random_round_case``; K2a's stash and
seeded cotangents), each measurement printed as one JSON line:

  orders    whether the card's f32 product ``xq @ ws`` (cuBLAS, as
            ``rounds_vjp_plain`` forms the gather source ``ys``) equals,
            bit for bit, a loop of one FMA per k over S equal slices of k,
            each from 0, the slices' sums added in order (S = 1: the
            sequential sum the kernel's re-decision assumes), at W = 256,
            384 and 512; and the cuBLAS kernels that product launches.
  variants  f32 K2b's distance from ``rounds_vjp_plain`` (worst relative
            error over dxc, dxq, dsyn and the 25 weight leaves, the gate's
            measure) for copies of the backward library: ``base`` (the
            source as it is), ``noZ`` (no re-decision of z's ties: the
            masks the kernel's own z gives), ``exact`` (z's ties taken
            again from the products summed in f64), on seeds 105-110 at W =
            256, 384 and 512, and on circuit d=5 at W = 384.
  parent    with ``--parent DIR`` (a checkout of another commit, its
            ``tpugnn_torch`` imported in place of this one's): that
            library's f32 wide K2b on the same cases, and nothing else.

The wrapper refuses f32 K2b at 384 columns (``fused_backward.F32_BWD_REFUSED``,
the finding of this probe); the probe lifts that refusal in its own process
to measure what the kernel would give there.  The copies build with the flags
of ``tpugnn_torch/kernels/_build.py`` into ``tpugnn_torch/_build/``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _probe_common import CSRC, REPO, build_copies, emit, replaced, with_library  # noqa: E402

LIBRARY = "wide_backward_tf32"
WIDTHS = (256, 384, 512)
SEEDS = tuple(range(105, 111))
SPLITS = (1, 2, 3, 4, 6, 8, 12)

SPLIT_DOT = r"""
// out[r][c]: S slices of k, each one FMA per k from 0, the slices added in order
extern "C" __global__ void split_dot(const float* x, const float* w, float* out, int K, int N,
                                     int S) {
  const int r = blockIdx.x, ks = K / S;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float tot = 0.f;
    for (int s = 0; s < S; ++s) {
      float p = 0.f;
      for (int k = s * ks; k < (s + 1) * ks; ++k) p = fmaf(x[size_t(r) * K + k], w[k * N + c], p);
      tot = s == 0 ? p : tot + p;
    }
    out[size_t(r) * N + c] = tot;
  }
}
extern "C" int split_dot_launch(const float* x, const float* w, float* out, int rows, int K,
                                int N, int S, void* stream) {
  split_dot<<<rows, 256, 0, (cudaStream_t)stream>>>(x, w, out, K, N, S);
  return (int)cudaGetLastError();
}
"""

# z's tie test in the replay, and its re-decision's sum
NO_Z = [("                if (TIES && w.col(j, qq) + e < job.msg_width && fabsf(z) < band)",
         "                if (false)")]
EXACT_Z = [("""              const float ex = __fadd_rn(
                  seq_dot(xs, d.wsrc32t + size_t(c) * W, W),
                  __fadd_rn(seq_dot(xr, d.w32t + size_t(M_WD) * W * W + size_t(c) * W, W),
                            __ldg(vec + V_B0 * W + c)));""",
            """              double exd = __ldg(vec + V_B0 * W + c);
              for (int k = 0; k < W; ++k)
                exd += double(xs[k]) * double(__ldg(d.wsrc32t + size_t(c) * W + k)) +
                       double(xr[k]) * double(__ldg(d.w32t + size_t(M_WD) * W * W + size_t(c) * W + k));
              const float ex = float(exd);""")]


def case(graph, w: int, seed: int, dev):
    """6d (h)'s K2b case: (w, the wrapper's call, the plain version's call)."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    _, dg, ops, wts, _, _, _, gen = cs.random_round_case(cs.WIDE_TRAIN_D, cs.D13_BATCH,
                                                         cs.D13_ROUNDS, "float32", seed, dev,
                                                         h=w, graph=graph)
    mats32, vecs32 = fd.pack_weights_f32(wts)
    xc, xq, s = cs.random_states(dg, cs.D13_BATCH, w, gen)
    cot_c = torch.randn(xc.shape, generator=gen, device=dev)
    cot_q = torch.randn(xq.shape, generator=gen, device=dev)
    with torch.no_grad():
        _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, cs.D13_ROUNDS,
                                          "float32")
    args = (sc, sq, s, ops, mats32, vecs32, cot_c, cot_q)
    return (wts, lambda: fb._bwd_cuda(*args, "float32"),
            lambda: fb.rounds_vjp_plain(*args, state_dtype="float32"), (xq, mats32))


def worst(w, kg, pg) -> dict:
    import chip_smoke as cs

    rels = cs.grad_errors(w, kg, pg)
    leaf = max(rels, key=rels.get)
    return dict(worst_rel=rels[leaf], worst_leaf=leaf)


def cases(dev):
    from tpugnn_torch.tanner import build_circuit_code, build_code

    surface, circuit = build_code("surface", 5), build_circuit_code("surface", 5, 5)
    for w in WIDTHS:
        for seed in SEEDS:
            yield "surface_d5", surface, w, seed
    for seed in SEEDS[:3]:
        yield "circuit_d5", circuit, 384, seed


def orders(dev) -> None:
    import torch

    from tpugnn_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, nvcc_path
    from tpugnn_torch.tanner import build_code

    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, "split_dot.cu")
    lib_path = os.path.join(BUILD_DIR, "libsplit_dot.so")
    with open(src, "w") as f:
        f.write(SPLIT_DOT)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.split_dot_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    surface = build_code("surface", 5)
    for w in WIDTHS:
        _, _, _, (xq, mats32) = case(surface, w, SEEDS[0], dev)
        ws = mats32[7].float()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = xq @ ws
            torch.cuda.synchronize()
        names = sorted({e.name[:120] for e in prof.events() if e.device_type.name == "CUDA"})
        x2 = xq.reshape(-1, w).contiguous()
        rows = x2.shape[0]
        match = {}
        for s in SPLITS:
            if w % s:
                continue
            loop = torch.empty((rows, w), device=dev)
            lib.split_dot_launch(x2.data_ptr(), ws.data_ptr(), loop.data_ptr(), rows, w, w, s,
                                 torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            match[s] = float((got.reshape(rows, w) == loop).float().mean())
        emit(dict(mode="orders", width=w, rows=rows, equal_share_by_slices=match,
                  cublas_kernels=names))


def build_variants():
    """The backward library's copies (base, noZ, exact), loaded."""
    with open(os.path.join(CSRC, "wide_rounds.cuh")) as f:
        body = f.read()
    head = "#define WIDE_STATE float\n#define WIDE_CODE 0\n#define WIDE_BACKWARD\n"
    texts = {k: head + replaced(body, v) for k, v in
             (("base", []), ("noZ", NO_Z), ("exact", EXACT_Z))}
    return build_copies(LIBRARY, texts)[0]


def variants(dev, copies) -> None:
    import torch

    libs = {"parent": None} if copies is None else copies.result()
    for gname, graph, w, seed in cases(dev):
        wts, run, plain, _ = case(graph, w, seed, dev)
        with torch.no_grad():
            pg = plain()
            res = dict(mode="parent" if copies is None else "variants", graph=gname, width=w,
                       seed=seed)
            for name, lib in libs.items():
                kg = run() if lib is None else with_library(LIBRARY, lib, run)
                res[name] = worst(wts, kg, pg)
        emit(res)
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout whose tpugnn_torch is measured in place of this one's")
    args = ap.parse_args(argv)
    if args.parent:
        sys.path.insert(0, os.path.abspath(args.parent))
    sys.path.insert(1 if args.parent else 0, REPO)
    import concurrent.futures

    import torch

    from tpugnn_torch.kernels import fused_backward as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    fb.F32_BWD_REFUSED = ()   # the widths the wrapper refuses are measured here
    dev = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the copies build while the orders run (their library builds on first use)
        copies = None if args.parent else pool.submit(build_variants)
        if copies is not None:
            orders(dev)
        variants(dev, copies)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
