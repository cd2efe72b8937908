#!/usr/bin/env python3
"""Where f32 K1's time and error go, on one NVIDIA card.

    python3 scripts/k1_f32_probe.py [--parent OLD_fused_rounds_tf32.cu] [--other NAME=FILE.cu]
                                    [--no-graphs]

K1 with f32 states (``tpugnn_torch/kernels/csrc/fused_rounds_tf32.cu``, 3xTF32 on
``mma.sync``) at the trained decode's shape (surface d=11, B=4096, R=14,
H=128, seeded random weights and states), against copies of its source
(and of ``rounds_mma.cuh``, inlined into the copy) that change one thing,
each printed as one JSON line:

  variants  the time of each copy, in turns within one process (as built,
            the copies, then the same in reverse), and of the shared-panel
            kernels of some of them run as the global-panel variant
            (``*_gp``: the wrappers' shared-memory limit lowered to that
            variant's need, as ``chip_smoke.rounds_kernel_times`` does).
            The copies: ``acc_direct`` accumulates the three TF32 products
            straight into the running sum on the tensor cores (no sum a
            slab); ``small_first`` sums a slab's small products (lo hi, hi
            lo) before its hi hi ones instead of k-step by k-step;
            ``one_pass`` forms only hi hi (one TF32 product);
            ``wsplit_regs`` streams the f32 weights (half the bytes) and
            splits them in every warp's registers; ``keep_xr`` keeps each
            warp's 16 state rows in registers (64 a thread) for x @ ux and
            the residual instead of reading them again; ``no_mma`` forms no
            product and ``no_bload`` reads no weight fragment from shared
            memory (timing only: their states are wrong); ``sp_8x3``
            streams the weights through three 8-row slabs (one sum a
            k-step), and ``gp_32x2``, ``gp_8x4`` give the global-panel
            variant other rings (timed as ``*_gp``).
  errors    the max abs difference of each copy that computes the function
            from ``rounds_plain`` and from the same rounds in f64
            (``chip_smoke.rounds_f64``), beside the plain version's.
  graphs    (not with ``--no-graphs``) on each circuit checkpoint's graph
            and the detector graph, K1 held to its plain version and both
            to the rounds in f64 through ``chip_smoke.detector_k1_check``
            (its ``K1_F64_RATIO`` gate) for as built, ``acc_direct``,
            ``small_first`` and ``gp_32x2``.
  probe     one block's clock cycles per stage (A projection, B check rows,
            C qubit rows) from a copy with ``clock64()`` probes.
  parent    with ``--parent`` (and ``--other``, repeatable): as built
            against other versions of ``fused_rounds_tf32.cu`` (say the parent
            commit's, from ``git show``; a version with other headers has
            them inlined in place of their includes), in turns (others,
            built, built, others).

The copies are built by ``_probe_common.py`` and loaded in place of the
library; the registers and spills ``ptxas`` reports for each f32 kernel are
printed with them.  Every line also goes to ``chiprun_out/k1_f32_probe.jsonl``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from _probe_common import (CSRC, REPO, build_copies, kernel_resources, replaced, stage_cycles,
                           with_library, with_probes)

sys.path.insert(0, REPO)

SOURCE = os.path.join(CSRC, "fused_rounds_tf32.cu")
HEADER = os.path.join(CSRC, "rounds_mma.cuh")
LIBRARY = "fused_rounds_tf32"
KERNEL = "fused_rounds_tf32x3_kernel"

_THREE = ("          mma_tf32(c, al[kk], wh[0], wh[1]);\n"
          "          mma_tf32(c, ah[kk], wl[0], wl[1]);\n"
          "          mma_tf32(c, ah[kk], wh[0], wh[1]);\n")
_ADD = "#pragma unroll\n        for (int e = 0; e < 4; ++e) acc[j][e] += c[e];\n"
_BLOAD = "          const float4 w = b[kk * NT * 32 + 32 * j];\n"
_WSPLIT = ("          const uint32_t wh[2] = {__float_as_uint(w.x), __float_as_uint(w.y)};\n"
           "          const uint32_t wl[2] = {__float_as_uint(w.z), __float_as_uint(w.w)};\n")
# header text replacements of each copy
HEADER_VARIANTS = {
    "acc_direct": [(_THREE, _THREE.replace("(c, ", "(acc[j], ")), (_ADD, "")],
    "small_first": [
        (_THREE, "          mma_tf32(c, al[kk], wh[0], wh[1]);\n"
                 "          mma_tf32(c, ah[kk], wl[0], wl[1]);\n"
                 "          hh[kk][0] = wh[0];\n          hh[kk][1] = wh[1];\n"),
        ("        float c[4] = {0.f, 0.f, 0.f, 0.f};\n",
         "        float c[4] = {0.f, 0.f, 0.f, 0.f};\n        uint32_t hh[KK][2];\n"),
        (_ADD, "#pragma unroll\n        for (int kk = 0; kk < KK; ++kk) "
               "mma_tf32(c, ah[kk], hh[kk][0], hh[kk][1]);\n" + _ADD)],
    "one_pass": [(_THREE, "          mma_tf32(acc[j], ah[kk], wh[0], wh[1]);\n"), (_ADD, "")],
    "no_mma": [(_THREE, ""), (_ADD, "")],
    "no_bload": [(_BLOAD, "          const float4 w = make_float4(__uint_as_float(lane + j), "
                          "__uint_as_float(kk + s), 0.f, 0.f);\n")],
    # f32 weights in fragment order (half the bytes), split by every warp
    "wsplit_regs": [
        ("constexpr int KSTEP = NT * 32 * 4;", "constexpr int KSTEP = NT * 32 * 2;"),
        ("      const float4* b = reinterpret_cast<const float4*>(cur) + lane;\n",
         "      const float2* b = reinterpret_cast<const float2*>(cur) + lane;\n"),
        (_BLOAD + _WSPLIT, "          const float2 w = b[kk * NT * 32 + 32 * j];\n"
                           "          uint32_t wh[2], wl[2];\n"
                           "          split(w.x, wh[0], wl[0]);\n"
                           "          split(w.y, wh[1], wl[1]);\n")],
}
# source text replacements: the weight ring's slab rows and depth
_SP = "constexpr int SP_SR = 16, SP_NS = 2;"
_GP = "constexpr int GP_SR = 16, GP_NS = 3;"
SOURCE_VARIANTS = {
    "sp_8x3": [(_SP, "constexpr int SP_SR = 8, SP_NS = 3;")],
    "gp_32x2": [(_GP, "constexpr int GP_SR = 32, GP_NS = 2;")],
    "gp_8x4": [(_GP, "constexpr int GP_SR = 8, GP_NS = 4;")],
}
# source text replacements: each warp keeps its 16 state rows in registers
# (64 a thread) for x @ ux and the residual instead of reading them again
KEEP_XR = [
    ("    float acc[NT][4];\n\n    if (CHECK) {   // the other direction's gather source\n"
     "      mma_pass<SR, NS>(",
     "    float xr[NT][4];\n"
     "#pragma unroll\n    for (int j = 0; j < NT; ++j)\n#pragma unroll\n"
     "      for (int h = 0; h < 2; ++h) {\n"
     "        const float2 v = ld2(xa + (g + 8 * h) * LDX + 8 * j + 2 * t);\n"
     "        xr[j][2 * h] = v.x;\n        xr[j][2 * h + 1] = v.y;\n      }\n"
     "    float acc[NT][4];\n\n    if (CHECK) {   // the other direction's gather source\n"
     "      mma_pass<SR, NS>("),
    ("    mma_pass<SR, NS>(xa, wf, rg, ux, acc, active);\n"
     "    load_rows_warp(xa, x_src + size_t(r0) * H, n);\n",
     "    mma_pass<SR, NS>(xa, wf, rg, ux, acc, active);\n#pragma unroll\n"
     "    for (int j = 0; j < NT; ++j)\n#pragma unroll\n      for (int h = 0; h < 2; ++h)\n"
     "        st2(xa + (g + 8 * h) * LDX + 8 * j + 2 * t, xr[j][2 * h], xr[j][2 * h + 1]);\n"
     "    __syncwarp();\n"),
    ("        const float2 x = r < rows ? ld2(xrow + 8 * j) : make_float2(0.f, 0.f);\n",
     "        const float2 x = make_float2(xr[j][2 * h], xr[j][2 * h + 1]);\n"),
]


def fragment_pack(mats):
    """The f32 matrices in the split pack's fragment order, unsplit (the
    ``wsplit_regs`` copy's operand)."""
    return mats.float().reshape(-1, 16, 2, 4, 16, 8).permute(0, 1, 4, 5, 3, 2).contiguous()


# the copies that compute the function
EXACT = ("as_built", "acc_direct", "small_first", "one_pass", "wsplit_regs", "keep_xr", "sp_8x3")

# Probe points (text in the round loop of the f32 kernel, stage that ends there)
PROBES = [
    ("      const float* xq_src = round == 0 ? xq_in + b * size_t(N) * H : xq;\n",
     "loop top (launch gap, discarded)"),
    ("      project_rows(xq_src, N, proj, s.ys_c, s.xs, rg, wc + size_t(M_WS) * MAT);\n",
     "A projection"),
    ("                                      vecs, s.xs, rg, wq + size_t(M_WD) * MAT, width);\n",
     "B check rows"),
    ("                                       width);\n      __syncthreads();",
     "C qubit rows"),
]


def using(libs: dict, name: str, fn):
    """fn() with the library `name` loaded, and for ``wsplit_regs`` its
    weight pack in place of the split one."""
    from tpugnn_torch.kernels import fused_decoder as fd

    real = fd.tf32_split_pack
    if name == "wsplit_regs":
        fd.tf32_split_pack = fragment_pack
    try:
        return with_library(LIBRARY, libs[name], fn)
    finally:
        fd.tf32_split_pack = real


OUT = os.path.join(REPO, "chiprun_out", "k1_f32_probe.jsonl")


def emit(obj) -> None:
    """One JSON line to stdout and to OUT."""
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def flags(name: str) -> str:
    """An f32 K1 instantiation's panel placement from its mangled name,
    ``shared`` or ``gpanels`` (``stash`` for K2a's; as chip_smoke.f32_hmma)."""
    import chip_smoke as cs

    return next(iter(cs.f32_hmma({name: 0})), name)


def inline_header(src: str, header: str) -> str:
    """The source with the (changed) rounds_mma.cuh in place of its include."""
    return replaced(src, [('#include "rounds_mma.cuh"\n', header + "\n")])


def in_turns(libs: dict, order, call) -> dict:
    """call's ms on each library of `order`, then in the reverse order."""
    import chip_smoke as cs

    t = {k: [] for k in order}
    for name in (*order, *reversed(order)):
        t[name].append(using(libs, name, lambda: cs.time_ms(call)))
    return t


def gp_call(lib, ops, call):
    """call() with the wrappers' shared-memory limit at the global-panel
    variant's need, so that K1 launches that variant."""
    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_decoder as fd

    with cs.smem_limit(fd, cs.gpanels_smem(lib, 0, ops)):
        return call()


def graph_checks(libs: dict) -> dict:
    """detector_k1_check (K1 against plain and both against f64, the
    K1_F64_RATIO gate) on the circuit and detector graphs, per library."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.models.convert import DETECTOR_D5_WEIGHTS, load_decoder

    dev = torch.device("cuda", 0)
    cases = [(os.path.join(REPO, "tpugnn_torch", "assets", f), want, cs.CIRCUIT_P)
             for f, _, _, want, _, _ in cs.CIRCUIT_CHECKPOINTS]
    cases.append((DETECTOR_D5_WEIGHTS, "fused_rounds", cs.DETECTOR_P))
    out = {}
    for path, want, p in cases:
        _, model, graph = load_decoder(path, device=dev)
        for name in ("as_built", "acc_direct", "small_first", "gp_32x2"):
            def check():
                try:
                    r = cs.detector_k1_check(model, graph, dev, p=p, want=want, iters=3, f64=True)
                    return {k: r[k] for k in ("ms", "max_abs_err", "k1_vs_f64_max",
                                              "plain_vs_f64_max", "tf32x3_floor_ms")}
                except RuntimeError as e:
                    return {"failed": str(e)[:300]}
            out[f"{graph.name}/{name}"] = with_library(LIBRARY, libs[name], check)
        del model
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_decoder as fd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another version of fused_rounds_tf32.cu to time against")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=FILE",
                    help="a further version of fused_rounds_tf32.cu to time against")
    ap.add_argument("--no-graphs", action="store_true", help="skip the circuit and "
                    "detector graphs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_f32_probe.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    src, header = open(SOURCE).read(), open(HEADER).read()
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    texts = {"as_built": src,
             **{name: inline_header(src, replaced(header, pairs))
                for name, pairs in HEADER_VARIANTS.items()},
             "keep_xr": replaced(src, KEEP_XR),
             **{name: replaced(src, pairs) for name, pairs in SOURCE_VARIANTS.items()},
             "clock": with_probes(src, PROBES, " " * 6)}
    others = dict(o.split("=", 1) for o in args.other)
    if args.parent:
        others["parent"] = args.parent
    texts.update({name: open(path).read() for name, path in others.items()})
    libs, logs = build_copies(LIBRARY, texts)
    resources = {name: {flags(k): v for k, v in kernel_resources(log, KERNEL).items()}
                 for name, log in logs.items() if name not in others}

    dev = torch.device("cuda", 0)
    r = cs.TRAINED_ROUNDS
    graph, _, ops, w, xc, xq, s, _ = cs.random_round_case(cs.D, cs.B, r, "float32", 6, dev)
    flops = cs.rounds_flops(graph, 128) * cs.B * r
    call = lambda: fd.decoder_rounds(xc, xq, s, ops, w, r, "float32")
    with torch.inference_mode():
        order = ("as_built", *HEADER_VARIANTS, "keep_xr", "sp_8x3")
        times = in_turns(libs, order, call)
        for name in ("as_built", "acc_direct", "gp_32x2", "gp_8x4"):
            times[f"{name}_gp"] = [with_library(LIBRARY, libs[name], lambda: gp_call(
                libs[name], ops, lambda: cs.time_ms(call))) for _ in range(2)]
        pc, pq = fd.rounds_plain(xc, xq, s, ops, w, rounds=r, state_dtype="float32")
        exact = cs.rounds_f64_chunked(xc, xq, s, ops, w, r)
        errors = {"plain_vs_f64": cs.raster_errors(pc, pq, *exact)}
        for name in EXACT:
            kc, kq = using(libs, name, call)
            errors[name] = dict(vs_plain=cs.raster_errors(kc, kq, pc, pq),
                                vs_f64=cs.raster_errors(kc, kq, *exact))
        del pc, pq, exact, kc, kq
    emit({"variants": {k: dict(ms=v, tflops=[flops / (x * 1e-3) / 1e12 for x in v])
                       for k, v in times.items()},
          "tf32x3_floor_ms": cs.tf32x3_floor_ms(flops),
          "f32_core_ms": flops / cs.H100_F32_FLOPS * 1e3, "errors_max_mean": errors,
          "resources": resources, "card": card})

    with torch.inference_mode():
        probe = stage_cycles(libs["clock"], PROBES,
                             lambda: with_library(LIBRARY, libs["clock"], call))
    emit({"probe": probe, "card": card})

    if others:
        with torch.inference_mode():
            t = in_turns(libs, (*others, "as_built"), call)
        emit({"parent": t, "card": card})

    if not args.no_graphs:
        torch.cuda.empty_cache()
        emit({"graphs": graph_checks(libs), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
