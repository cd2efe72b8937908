#!/usr/bin/env python3
"""Where K2b's time goes, on one NVIDIA card.

    python3 scripts/k2b_probe.py

K2b (``tpugnn_torch/kernels/csrc/fused_backward.cu``, bf16 states) at the
flagship training shapes (surface d=11, H=128, R=14, seeded random weights
and states), three measurements, each printed as one JSON line:

  scale   K2b's time per block and sample-round at B = 64, 256, 1056 and
          4096: with few blocks on the card against all 132 busy.
  probe   one block's clock cycles per stage (S1 projections, S2 per
          direction, S3, S4, S5), from a copy of the source with
          ``clock64()`` probes at the stage boundaries in the kernel's
          sample loop (thread 0 of block 0), B=4096.
  cuts    K2b's time with parts cut out of a copy of the source (timing
          only: the gradients are wrong), beside the unchanged kernel in
          the same process, B=4096.

The copies are built with the flags of ``tpugnn_torch/kernels/_build.py``
into ``tpugnn_torch/_build/`` and loaded in place of the library.  Imports
nothing of JAX.
"""

from __future__ import annotations

import os
import sys

from _probe_common import (CSRC, REPO, build_copies, emit, replaced, stage_cycles,
                           with_library, with_probes)

sys.path.insert(0, REPO)

SOURCE = os.path.join(CSRC, "fused_backward.cu")
LIBRARY = "fused_backward"

# Parts of the source cut out for the `cuts` measurement: name -> list of
# (text, replacement).  Each text must occur in the source.
S2_STORES = [(f"    store_rows_warp(d.{a} + so + size_t(r0) * H, {b}, n);\n", "    __syncwarp();\n")
             for a, b in (("hs", "ha"), ("hc", "ha"), ("dpre", "xa"), ("dt", "ha"),
                          ("dydb", "xa"))]
COLSUMS = [("  red_add2(p + c, v[0], v[1]);\n  red_add2(p + c + 8, v[2], v[3]);\n", "")]
COTANGENT = [
    ("        if (r < rows) gg = __ldcg(reinterpret_cast<const float2*>"
     "(gs + size_t(r) * H + 8 * j + 2 * t));\n", ""),
    ("        if (r < rows)\n          *reinterpret_cast<float2*>(gs + size_t(r) * H + c) =\n"
     "              make_float2(gv[j][2 * h], gv[j][2 * h + 1]);\n", ""),
]
CUTS = {
    "s2_tile_stores": S2_STORES,
    "column_sums": COLSUMS,
    "s2_cotangent_load_store": COTANGENT,
    "s2_all_above": S2_STORES + COLSUMS + COTANGENT,
    "s3": [("        gather_adjoint(c, i);\n        gather_adjoint(q, i);\n", "")],
    "s5": [("      weight_grads(c, nt * M, s);     // starts with a barrier\n"
            "      weight_grads(q, nt * N, s);\n", "")],
}

# Probe points of the `probe` measurement: (text in the kernel's sample
# loop, stage that ends there)
PROBES = [
    ("        const int b = b0 + i;\n", "loop top (launch gap, discarded)"),
    ("                            c.W + size_t(M_WD) * HH);\n", "S1 projections"),
    ("                           q.W + size_t(M_WD) * HH, true);\n", "S2 check rows"),
    ("                           false);\n", "S2 qubit rows"),
    ("        gather_adjoint(q, i);\n", "S3"),
    ("        state_cotangent<SR>(q, i, s, sl, proj_q);\n", "S4"),
    ("      weight_grads(q, nt * N, s);\n", "S5"),
]
def case(batch: int):
    """K2b's inputs at the flagship shapes, and a call of it."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    _, _, ops, w, xc, xq, s, gen = cs.random_round_case(11, batch, 14, "bfloat16", 10,
                                                         torch.device("cuda", 0))
    mats32, vecs32 = fd.pack_weights_f32(w)
    cot_c = torch.randn(xc.shape, generator=gen, device="cuda")
    cot_q = torch.randn(xq.shape, generator=gen, device="cuda")
    with torch.no_grad():
        _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, 14, "bfloat16")
    return lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, "bfloat16")


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels._build import build_libraries

    if not torch.cuda.is_available():
        print("k2b_probe.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    build_libraries(["fused_rounds", "fused_backward"])
    src = open(SOURCE).read()
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    libs, _ = build_copies(LIBRARY, {
        "clock": with_probes(src, PROBES, " " * 8),
        **{name: replaced(src, pairs) for name, pairs in CUTS.items()}})

    scale = {}
    for b in (64, 256, 1056, 4096):
        run = case(b)
        with torch.no_grad():
            ms = cs.time_ms(run, warmup=2, iters=5)
        tiles = -(-b // 8)
        grid = min(tiles, torch.cuda.get_device_properties(0).multi_processor_count)
        per_block = -(-tiles // grid) * 8
        scale[b] = dict(ms=ms, blocks=grid, us_per_block_sample_round=ms * 1e3 / (per_block * 14))
        del run
        torch.cuda.empty_cache()
    emit({"scale": scale, "card": card})

    lib = libs.pop("clock")
    run = case(4096)
    with torch.no_grad():
        probe = stage_cycles(lib, PROBES, lambda: with_library(LIBRARY, lib, run))
    emit({"probe": probe, "card": card})

    times = {}
    with torch.no_grad():
        times["unchanged"] = cs.time_ms(run, warmup=2, iters=7)
        for name, lib in libs.items():
            times[name] = with_library(LIBRARY, lib, lambda: cs.time_ms(run, warmup=2, iters=7))
    emit({"cuts_ms": times, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
