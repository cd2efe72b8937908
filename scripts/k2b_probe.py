#!/usr/bin/env python3
"""Where K2b's time goes, on one NVIDIA card.

    python3 scripts/k2b_probe.py [--f32-only | --bf16-only]

K2b at the flagship training shapes (surface d=11, H=128, R=14, seeded
random weights and states), for each state type: bf16
(``tpugnn_torch/kernels/csrc/fused_backward.cu``) and f32
(``csrc/fused_backward_tf32.cu``, 3xTF32).  Three measurements each,
printed as one JSON line with the state type:

  scale   K2b's time per block and sample-round at B = 64, 256, 1056 and
          4096: with few blocks on the card against all 132 busy.
  probe   one block's clock cycles per stage (S1 projections, S2 per
          direction, S3, S4, S5), from a copy of the source with
          ``clock64()`` probes at the stage boundaries in the kernel's
          sample loop (thread 0 of block 0), B=4096, and per sample and
          round beside those at B=64 (8 blocks busy).
  cuts    K2b's time with parts cut out of a copy of the source (timing
          only: the gradients are wrong), and f32's with a tile of 4
          samples (right gradients), without its tie re-decisions, with
          the residual stores streaming and with mma_pass not inlined,
          beside the unchanged kernel in the same process, B=4096; with the
          copies' registers and spills (ptxas).  For f32 the probe line
          also counts the ties the kernel took again (a counting copy).

The copies are built with the flags of ``tpugnn_torch/kernels/_build.py``
into ``tpugnn_torch/_build/`` and loaded in place of the library.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

from _probe_common import (CSRC, REPO, build_copies, emit, kernel_resources, replaced,
                           stage_cycles, with_library, with_probes)

sys.path.insert(0, REPO)

# bf16: parts cut out for the `cuts` measurement, name -> list of (text,
# replacement); each text must occur in the source.
S2_STORES = [(f"    store_rows_warp(d.{a} + so + size_t(r0) * H, {b}, n);\n", "    __syncwarp();\n")
             for a, b in (("hs", "ha"), ("hc", "ha"), ("dpre", "xa"), ("dt", "ha"),
                          ("dydb", "xa"))]
COTANGENT = [
    ("        if (r < rows) gg = __ldcg(reinterpret_cast<const float2*>"
     "(gs + size_t(r) * H + 8 * j + 2 * t));\n", ""),
    ("        if (r < rows)\n          *reinterpret_cast<float2*>(gs + size_t(r) * H + c) =\n"
     "              make_float2(gv[j][2 * h], gv[j][2 * h + 1]);\n", ""),
]

KERNELS = {
    "bfloat16": dict(
        source="fused_backward.cu", library="fused_backward", tile=8,
        cuts={
            "s2_tile_stores": S2_STORES,
            "s2_cotangent_load_store": COTANGENT,
            "s2_both": S2_STORES + COTANGENT,
            "s3": [("        gather_adjoint(c, i);\n        gather_adjoint(q, i);\n", "")],
            "s5": [("      weight_grads(c, nt * M, s);     // starts with a barrier\n"
                    "      weight_grads(q, nt * N, s);\n", "")],
        },
        # (text in the kernel's sample loop, stage that ends there)
        probes=[
            ("        const int b = b0 + i;\n", "loop top (launch gap, discarded)"),
            ("                            c.W + size_t(M_WD) * HH);\n", "S1 projections"),
            ("                           q.W + size_t(M_WD) * HH, true);\n", "S2 check rows"),
            ("                           false);\n", "S2 qubit rows"),
            ("        gather_adjoint(q, i);\n", "S3"),
            ("        state_cotangent<SR>(q, i, s, sl, proj_q);\n", "S4"),
            ("      weight_grads(q, nt * N, s);\n", "S5"),
        ]),
    "float32": dict(
        source="fused_backward_tf32.cu", library="fused_backward_tf32", tile=8,
        cuts={
            "tile4": [("constexpr int TILE = 8;", "constexpr int TILE = 4;")],
            "no_ties": [("      if (ties) fix_slots(dref, i, r);\n", ""),
                        ("    if (__any_sync(0xffffffffu, (tunc[0] | tunc[1]) != 0u)) {",
                         "    if (false) {")],
            "s3": [("        gather_adjoint(c, i);\n        gather_adjoint(q, i);\n", "")],
            "s5": [("      weight_grads(c, nt * M, s.stage);     // starts with a barrier\n"
                    "      weight_grads(q, nt * N, s.stage);\n", "")],
        },
        probes=[
            ("        const int b = b0 + i;\n", "loop top (launch gap, discarded)"),
            ("                             c.W + size_t(M_WD) * MAT);\n", "S1 projections"),
            ("                       q.W + size_t(M_WD) * MAT);\n", "S2 check rows"),
            ("        replay_adjoint(q, i, nullptr, nullptr, nullptr, s.xs, rg, "
             "c.WT + size_t(M_WD) * MAT);\n", "S2 qubit rows"),
            ("        gather_adjoint(q, i);\n", "S3"),
            ("        state_cotangent(q, i, s.xs, rg, proj_q);\n", "S4"),
            ("      weight_grads(q, nt * N, s.stage);\n", "S5"),
        ]),
}


# f32: a copy that counts the ties it takes again (slot mask bits, rows whose
# hs is summed again, t mask bits), read with ties_read
TIE_COUNTS = [
    ('#include "rounds_mma.cuh"\n',
     '#include "rounds_mma.cuh"\n__device__ unsigned long long g_ties[3];\n'),
    ("      const float2 p = seq_dot2(xr, d.W32T + size_t(M_WD) * HH",
     "      atomicAdd(&g_ties[0], 1ull);\n"
     "      const float2 p = seq_dot2(xr, d.W32T + size_t(M_WD) * HH"),
    ("      hs_exact_row(d, i, r, buf);\n",
     "      if ((threadIdx.x & 31) == 0) atomicAdd(&g_ties[1], 1ull);\n"
     "      hs_exact_row(d, i, r, buf);\n"),
    ("          const float2 p = seq_dot2(xr, d.W32T + size_t(M_UX) * HH",
     "          atomicAdd(&g_ties[2], 1ull);\n"
     "          const float2 p = seq_dot2(xr, d.W32T + size_t(M_UX) * HH"),
]
TIE_API = """
extern "C" int ties_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_ties, sizeof(unsigned long long) * 3);
}
extern "C" int ties_reset() {
  unsigned long long z[3] = {0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_ties, z, sizeof(z));
}
"""


# f32: copies that change what is not a cut: the residual stores streaming
# (evict-first), and mma_pass not inlined (a copy of rounds_mma.cuh beside
# the source, so its code is one copy for every product)
STREAM_RESIDUALS = [
    ("namespace t3b {\n",
     "namespace t3b {\n__device__ __forceinline__ void stcs2(float* p, float a, float b) {\n"
     "  __stcs(reinterpret_cast<float2*>(p), make_float2(a, b));\n}\n"),
    ("if (r < rows) st2(d.hs + so", "if (r < rows) stcs2(d.hs + so"),
    ("if (r < rows) st2(d.hc + so", "if (r < rows) stcs2(d.hc + so"),
    ("          st2(d.dpre + so", "          stcs2(d.dpre + so"),
    ("if (r < rows) st2(d.dt + so", "if (r < rows) stcs2(d.dt + so"),
    ("          st2(d.dydb + so", "          stcs2(d.dydb + so"),
    ("      if (sr < d.src_rows) store4(dys + size_t(sr) * H + c0, acc[v]);",
     "      if (sr < d.src_rows)\n"
     "        __stcs(reinterpret_cast<float4*>(dys + size_t(sr) * H + c0),\n"
     "               make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]));"),
]
NOT_INLINED_HEADER = "_probe_rounds_mma_not_inlined.cuh"
MMA_NOT_INLINED = [("__device__ __forceinline__ void mma_pass(const float* A,",
                    "__device__ __noinline__ void mma_pass(const float* A,")]


def tie_counts(lib, fn, sample_rounds: int) -> dict:
    """One run of fn() on the counting copy: the ties it took again, in all
    and per sample-round."""
    import ctypes

    import torch

    lib.ties_read.argtypes = [ctypes.c_void_p]
    lib.ties_reset()
    fn()
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 3)()
    lib.ties_read(ctypes.cast(out, ctypes.c_void_p))
    names = ("slot_bits", "t_rows", "t_bits")
    return {**{n: int(v) for n, v in zip(names, out)},
            **{f"{n}_per_sample_round": v / sample_rounds for n, v in zip(names, out)}}


def case(batch: int, dtype: str):
    """K2b's inputs at the flagship shapes in a state type, and a call of it."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    _, _, ops, w, xc, xq, s, gen = cs.random_round_case(11, batch, 14, dtype, 10,
                                                         torch.device("cuda", 0))
    mats32, vecs32 = fd.pack_weights_f32(w)
    cot_c = torch.randn(xc.shape, generator=gen, device="cuda")
    cot_q = torch.randn(xq.shape, generator=gen, device="cuda")
    with torch.no_grad():
        _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, 14, dtype)
    return lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dtype)


def probe(dtype: str, card: str) -> None:
    import torch

    import chip_smoke as cs

    k = KERNELS[dtype]
    src = open(os.path.join(CSRC, k["source"])).read()
    copies = {"clock": with_probes(src, k["probes"], " " * 8),
              **{name: replaced(src, pairs) for name, pairs in k["cuts"].items()}}
    header = os.path.join(CSRC, NOT_INLINED_HEADER)
    if dtype == "float32":
        copies["tie_counts"] = replaced(src, TIE_COUNTS) + TIE_API
        copies["stream_residuals"] = replaced(src, STREAM_RESIDUALS)
        copies["mma_not_inlined"] = replaced(src, [('#include "rounds_mma.cuh"\n',
                                                    f'#include "{NOT_INLINED_HEADER}"\n')])
        with open(os.path.join(CSRC, "rounds_mma.cuh")) as f:
            text = replaced(f.read(), MMA_NOT_INLINED)
        with open(header, "w") as f:
            f.write(text)
    try:
        libs, logs = build_copies(k["library"], copies)
    finally:
        if os.path.exists(header):
            os.remove(header)
    counting = libs.pop("tie_counts", None)
    resources = {name: kernel_resources(log, "fused_rounds_bwd") for name, log in logs.items()}

    scale = {}
    for b in (64, 256, 1056, 4096):
        run = case(b, dtype)
        with torch.no_grad():
            ms = cs.time_ms(run, warmup=2, iters=5)
        tiles = -(-b // k["tile"])
        grid = min(tiles, torch.cuda.get_device_properties(0).multi_processor_count)
        per_block = -(-tiles // grid) * k["tile"]
        scale[b] = dict(ms=ms, blocks=grid, us_per_block_sample_round=ms * 1e3 / (per_block * 14))
        del run
        torch.cuda.empty_cache()
    emit({"dtype": dtype, "scale": scale, "card": card})

    lib = libs.pop("clock")
    with torch.no_grad():   # block 0 takes 1 tile at B=64, 4 at 4096
        small = case(64, dtype)
        few = stage_cycles(lib, k["probes"], lambda: with_library(k["library"], lib, small))
        del small
        run = case(4096, dtype)
        stages = stage_cycles(lib, k["probes"], lambda: with_library(k["library"], lib, run))
        stages["per_sample_round"] = {st: c / (4 * k["tile"] * 14)
                                      for st, c in stages["cycles"].items()}
        stages["per_sample_round_b64"] = {st: c / (k["tile"] * 14)
                                          for st, c in few["cycles"].items()}
        if counting is not None:
            stages["ties"] = tie_counts(counting, lambda: with_library(k["library"], counting, run),
                                        4096 * 14)
    emit({"dtype": dtype, "probe": stages, "card": card})

    times = {}
    with torch.no_grad():
        times["unchanged"] = cs.time_ms(run, warmup=2, iters=7)
        for name, lib in libs.items():
            times[name] = with_library(k["library"], lib,
                                       lambda: cs.time_ms(run, warmup=2, iters=7))
        times["unchanged_again"] = cs.time_ms(run, warmup=2, iters=7)
    emit({"dtype": dtype, "cuts_ms": times, "resources": resources, "card": card})
    del run
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels._build import build_libraries

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--f32-only", action="store_true")
    only.add_argument("--bf16-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2b_probe.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    build_libraries(["fused_rounds", "fused_rounds_tf32", "fused_backward",
                     "fused_backward_tf32"])
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    dtypes = (["float32"] if args.f32_only else ["bfloat16"] if args.bf16_only
              else ["float32", "bfloat16"])
    for dtype in dtypes:
        probe(dtype, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
