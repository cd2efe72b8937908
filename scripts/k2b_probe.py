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

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = os.path.join(REPO, "tpugnn_torch", "kernels", "csrc", "fused_backward.cu")

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
PROBE_DEFS = """
__device__ long long g_probe[16];
__device__ long long g_probe_last;
#define PROBE(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
    long long now = clock64(); g_probe[k] += now - g_probe_last; g_probe_last = now; } } while (0)
"""
PROBE_API = """
extern "C" int probe_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(long long) * 16);
}
extern "C" int probe_reset() {
  long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_copies(texts: dict) -> dict:
    """Build copies of the source (name -> text), one nvcc each, all started
    together; returns them loaded, name -> library."""
    from tpugnn_torch.kernels import _build

    out_dir = os.path.join(REPO, "tpugnn_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        path = os.path.join(os.path.dirname(SOURCE), f"_probe_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib_path = os.path.join(out_dir, f"libk2b_probe_{name}.so")
        procs[name] = (path, lib_path, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib_path, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, lib_path, proc) in procs.items():
        log = proc.communicate()[0]
        os.remove(path)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(lib_path)
        for fn, (args, res) in _build._SIGNATURES["fused_backward"].items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = res
        libs[name] = lib
    return libs


def replaced(src: str, pairs) -> str:
    for a, b in pairs:
        if src.count(a) != 1:
            raise RuntimeError(f"text not once in the source: {a!r}")
        src = src.replace(a, b)
    return src


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


def with_library(lib, fn):
    from tpugnn_torch.kernels import _build

    real = _build.load_library
    _build.load_library = lambda name: lib if name == "fused_backward" else real(name)
    try:
        return fn()
    finally:
        _build.load_library = real


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
    text = src.replace('#include "rounds_mma.cuh"\n', '#include "rounds_mma.cuh"\n' + PROBE_DEFS, 1)
    text = replaced(text, [(a, a + f"        PROBE({k});\n") for k, (a, _) in enumerate(PROBES)])
    libs = build_copies({"clock": text + PROBE_API,
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
    lib.probe_read.argtypes = [ctypes.c_void_p]
    run = case(4096)
    with torch.no_grad():
        with_library(lib, run)
        torch.cuda.synchronize()
        lib.probe_reset()
        ms = with_library(lib, lambda: cs.time_ms(run, warmup=0, iters=1))
    cycles = (ctypes.c_longlong * 16)()
    lib.probe_read(ctypes.cast(cycles, ctypes.c_void_p))
    # the loop-top probe's first count spans the gap since the previous launch
    counts = {name: int(cycles[k]) for k, (_, name) in enumerate(PROBES)}
    del counts[PROBES[0][1]]
    total = sum(counts.values())
    emit({"probe": {"ms": ms, "cycles": counts,
                    "share": {k: v / total for k, v in counts.items()}}, "card": card})

    times = {}
    with torch.no_grad():
        times["unchanged"] = cs.time_ms(run, warmup=2, iters=7)
        for name, lib in libs.items():
            times[name] = with_library(lib, lambda: cs.time_ms(run, warmup=2, iters=7))
    emit({"cuts_ms": times, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
