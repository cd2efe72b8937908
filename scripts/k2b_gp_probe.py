#!/usr/bin/env python3
"""What keeping the gather panels in global memory costs the bf16 rounds
kernels, on one NVIDIA card.

    python3 scripts/k2b_gp_probe.py

Every number is a median of CUDA events of one wrapper call on seeded random
full-width weights and states (B=4096, R=8), each pair in turns (A, B, B, A):

* ``k1``: bf16 K1 on the d=11 code graph and on the circuit d=5 graph with
  its panels in shared memory and in global memory (the wrapper's
  shared-memory limit lowered to the variant's need, so that the main path's
  wrapper launches it);
* ``k2b_d5``: bf16 K2b on the circuit d=5 graph in its shared-panel layout
  (the library) and in a copy of ``fused_backward.cu`` that tries only the
  global-panel layouts: the panels' cost where both fit;
* ``k2b_d7``: bf16 K2b on the circuit d=7 graph (its first global layout:
  64-row slabs, the slot masks in the scratch) against copies that try
  32-row slabs with the masks in shared memory first, and with the residual
  stores streaming (``st.global.cs``, evict-first), which keeps the 1.8 GB
  of residuals from pushing the 37 MB of panels out of L2: if the residuals
  evicted the panels, the streaming copy would be faster.

Prints one JSON line per measurement and the card's name and power limit.
The copies build into ``tpugnn_torch/_build/`` (scripts/_probe_common.py).
About three minutes.  Imports nothing of JAX.
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _probe_common import (CSRC, build_copies, emit, kernel_resources,  # noqa: E402
                           replaced, with_library)

ROUNDS = 8
# the layouts a copy tries, in order: (slab rows, masks in shared memory,
# panels in the scratch)
GP_ONLY = ((64, 1, 1), (64, 0, 1), (32, 1, 1), (32, 0, 1))
MASKS_FIRST = ((64, 1, 0), (32, 1, 0), (64, 0, 0), (32, 0, 0), (64, 1, 1), (32, 1, 1),
               (64, 0, 1), (32, 0, 1))
STREAM_FN = """
__device__ __forceinline__ void store_rows_warp_cs(bf16* dst, const bf16* src, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int u = lane; u < 16 * 16; u += 32) {
    const int r = u >> 4, c = (u & 15) * 8;
    if (r < n)
      __stcs(reinterpret_cast<uint4*>(dst + size_t(r) * H + c),
             *reinterpret_cast<const uint4*>(src + r * LDB + c));
  }
}
"""
STREAMING = [("using namespace rounds::tc;\n\nconstexpr int TILE",
              "using namespace rounds::tc;\n" + STREAM_FN + "\nconstexpr int TILE")] + [
    (f"store_rows_warp(d.{a} + so", f"store_rows_warp_cs(d.{a} + so")
    for a in ("hs", "hc", "dpre", "dt", "dydb")] + [
    ("if (sr < d.src_rows) store4(dys + size_t(sr) * H + c0, acc[v]);",
     "if (sr < d.src_rows) {\n        uint2 q;\n"
     "        const __nv_bfloat162 a2 = __floats2bfloat162_rn(acc[v][0], acc[v][1]);\n"
     "        const __nv_bfloat162 b2 = __floats2bfloat162_rn(acc[v][2], acc[v][3]);\n"
     "        q.x = *reinterpret_cast<const uint32_t*>(&a2);\n"
     "        q.y = *reinterpret_cast<const uint32_t*>(&b2);\n"
     "        __stcs(reinterpret_cast<uint2*>(dys + size_t(sr) * H + c0), q);\n      }")]


def with_layouts(src: str, order) -> str:
    """fused_backward.cu with its layouts tried in ``order``."""
    text = ", ".join(f"{{{sr}, {'true' if live else 'false'}, {'true' if gp else 'false'}}}"
                     for sr, live, gp in order)
    out, n = re.subn(r"constexpr Layout LAYOUTS\[\] = \{.*?\};",
                     f"constexpr Layout LAYOUTS[] = {{{text}}};", src, count=1, flags=re.S)
    if n != 1:
        raise RuntimeError("no LAYOUTS table in fused_backward.cu")
    return out


def graph_case(d: int, circuit: bool, seed: int):
    """(graph, ops, weights, states, syndrome, generator) on the card."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.tanner import build_circuit_code, build_code

    dev = torch.device("cuda", 0)
    g = build_circuit_code("surface", d, d) if circuit else build_code("surface", d)
    dg = g.to(dev)
    model = GNNDecoder(ModelConfig(hidden=128, msg_hidden=128, rounds=ROUNDS, backend="fused",
                                   dtype="bfloat16"), k=g.k)
    model.init_random(torch.Generator().manual_seed(seed), bias_std=0.1)
    w = fd.RoundWeights(*[t.detach() for t in model.to(dev).rounds.round_weights()])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    xc, xq, s = cs.random_states(dg, cs.B, 128, gen)
    return g, fd.make_operators(dg), w, xc, xq, s, gen


def turns(a, b) -> dict:
    """ms of a and b in the order a, b, b, a."""
    import chip_smoke as cs

    t = {"a": [], "b": []}
    for k, fn in (("a", a), ("b", b), ("b", b), ("a", a)):
        t[k].append(cs.time_ms(fn, warmup=1, iters=5))
    return t


def k1_placements(card: str) -> None:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels._build import load_library

    for d, circuit in ((11, False), (5, True)):
        g, ops, w, xc, xq, s, _ = graph_case(d, circuit, 80 + d)
        run = lambda: fd.decoder_rounds(xc, xq, s, ops, w, ROUNDS, "bfloat16")
        need = cs.gpanels_smem(load_library("fused_rounds"), 1, ops)

        def global_panels():
            with cs.smem_limit(fd, need):
                return run()
        with torch.inference_mode():
            cs.reset_counts()
            global_panels()
            if cs.counts()["fused_rounds_gpanels"] != 1:
                raise RuntimeError("the global-panel K1 was not launched")
            t = turns(run, global_panels)
        emit({"k1": g.name, "shared_ms": t["a"], "global_ms": t["b"], "card": card})
        torch.cuda.empty_cache()


def k2b_case(d: int, seed: int):
    """A call of bf16 K2b on the circuit graph of distance d, its stash from K2a."""
    import torch

    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    g, ops, w, xc, xq, s, gen = graph_case(d, True, seed)
    mats32, vecs32 = fd.pack_weights_f32(w)
    cot_c = torch.randn(xc.shape, generator=gen, device="cuda")
    cot_q = torch.randn(xq.shape, generator=gen, device="cuda")
    with torch.no_grad():
        _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, ROUNDS, "bfloat16")
    return g, lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, "bfloat16")


def k2b_copies(card: str) -> None:
    import torch

    src = open(os.path.join(CSRC, "fused_backward.cu")).read()
    libs, logs = build_copies("fused_backward", {
        "gp_only": with_layouts(src, GP_ONLY),
        "masks_first": with_layouts(src, MASKS_FIRST),
        "streaming": replaced(src, STREAMING)})
    emit({"resources": {n: kernel_resources(log, "fused_rounds_bwd_tc_kernel")
                        for n, log in logs.items()}})
    cases = ((5, ("gp_only",)), (7, ("masks_first", "streaming")))
    for d, names in cases:
        g, run = k2b_case(d, 90 + d)
        with torch.no_grad():
            for name in names:
                copy = lambda: with_library("fused_backward", libs[name], run)
                t = turns(run, copy)
                emit({"k2b": g.name, "library_ms": t["a"], f"{name}_ms": t["b"], "card": card})
        del run
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels._build import build_libraries

    if not torch.cuda.is_available():
        print("k2b_gp_probe.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build_libraries(["fused_rounds", "fused_backward"])
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    k1_placements(card)
    k2b_copies(card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
