#!/usr/bin/env python3
"""Where the wide rounds kernels' time goes, on one NVIDIA card.

    python3 scripts/wide_probe.py [--dtypes bfloat16,float32] [--widths 256] [--stages]

For each state type and pack width W (default 256: H = MH = W), at d=11,
B=4096, R=8 on seeded random weights (``chip_smoke.random_round_case``),
one call of each wide wrapper of the main path (K1 ``decoder_rounds``, K2a
``_fwd_stash_cuda``, K2b ``_bwd_cuda`` on K2a's stash, K5
``_roll_rounds_cuda``) under ``torch.profiler``: the call's time by CUDA
events (median of three after a warm-up) and the device time of each CUDA
kernel the call launched, summed by kernel name, with its launches.  Prints
one JSON line per state type, width and wrapper, and last the card's name
and power limit.

With ``--stages``, instead: copies of the library with ``clock64()`` probes
(``_probe_common.py``) at the stage boundaries of the forward tile (K1:
ydb product, gather, t products, t epilogue, v product, LayerNorm) and of
the replay tile (K2b: ydb product, gather, t products, t epilogue, v
product, LayerNorm adjoint, dt product and epilogue, dhs product and
epilogue), one block's first consumer thread's cycles per stage over one
call of K1 and of K2b at the same shapes.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def by_kernel(fn) -> dict:
    """{kernel name: (device ms, launches)} of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0 and e.count > 0:
            out[e.key[:120]] = dict(ms=t / 1e3, launches=e.count)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


# (text in csrc/wide_rounds.cuh, stage that ends there); the first, at the
# top of the tile loop, spans the gap since the last tile
FWD_PROBES = [
    ("      const float* vec = d.vec;\n      float acc[NJ][32];\n"
     "      w.sync();   // the row group is done with its last tile\n", "top"),
    ("      zero(acc);\n      x_product(acc);\n", "x_load_ydb_product"),
    ("        if constexpr (!F32) fence_async();\n        w.sync();\n"
     "        // t = hs @ wf + x @ ux + the degree, syndrome and bias terms\n", "gather"),
    ("        zero(acc);\n        h_product(acc);\n        x_product(acc);\n", "t_products"),
    ("                  fmaxf(acc[j][4 * qq + 2 * h + 1], 0.f));\n"
     "        if constexpr (!F32) fence_async();\n        w.sync();\n", "t_epilogue_hc"),
    ("        // v = x + hc @ w1 + ub1, and the LayerNorm of each row\n        zero(acc);"
     "\n        h_product(acc);\n", "v_product"),
    ("        }\n        w.sync();\n"
     "        store_tile<W, Who<G>::nthr>(d.out, S, row0, d.total, w);\n", "layernorm_store"),
]
BWD_PROBES = [
    ("    float* part = d.part + size_t(pslot) * 7 * W;\n    float acc[NJ][32];\n"
     "    w.sync();\n", "top"),
    ("    zero(acc);\n    x_product(acc);\n    float hsq[2] = {0.f, 0.f};\n", "x_load_ydb_product"),
    ("    store_tile<W, Who<G>::nthr>(d.hs, H, row0, d.total, w);\n", "gather"),
    ("    zero(acc);\n    h_product(acc);\n    x_product(acc);\n"
     "    uint32_t tp[NJ], tu[NJ];\n", "t_products"),
    ("    // v = x + hc @ w1 + ub1, the LayerNorm again and its adjoint: dpre; the\n",
     "t_epilogue_ties_hc"),
    ("    zero(acc);\n    h_product(acc);\n"
     "    w.sync();   // every warpgroup of the row group is done reading hc\n", "v_product"),
    ("    // dt = (rnd(dpre) @ w1^T) * (t > 0); rnd(dt) into the next A tile; dsyn;\n",
     "layernorm_adjoint"),
    ("    zero(acc);\n    h_product(acc);\n"
     "    if constexpr (!G::XS) w.sync();   // dt goes into H, which the product read\n",
     "dt_product"),
    ("    // dhs = rnd(dt) @ wf^T; dydb = dhs times the row's live slots of the\n", "dt_epilogue"),
    ("    zero(acc);\n    tile_product<G>(acc, S, ring, w);\n", "dhs_product"),
    ("      colsum(part, 0, w.col(j, 0) - 2 * w.t(), cs, w, W);\n    }\n    w.sync();\n"
     "    store_tile<W, Who<G>::nthr>(d.dydb_r, S, row0, d.total, w);\n", "dydb_epilogue"),
]


def stages(dtypes, widths, batch, rounds) -> None:
    """The --stages mode (see the module's docstring)."""
    import torch

    import _probe_common as pc
    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    import concurrent.futures

    with open(os.path.join(pc.CSRC, "wide_rounds.cuh")) as f:
        body = f.read()
    dev = torch.device("cuda", 0)
    for dt in dtypes:
        tdt = fd.STATE_DTYPES[dt]
        head = ("#define WIDE_STATE float\n#define WIDE_CODE 0\n" if dt == "float32" else
                "#include <cuda_bf16.h>\n#define WIDE_STATE __nv_bfloat16\n#define WIDE_CODE 1\n")
        names = {"fwd": fd.wide_library(tdt), "bwd": fd.wide_library(tdt, backward=True)}
        libs, logs = {}, {}

        def copy(tag):   # the forward's copy and the backward's, built together
            probes = FWD_PROBES if tag == "fwd" else BWD_PROBES
            text = pc.replaced(body, [(a, a + f"PROBE({k});\n") for k, (a, _) in enumerate(probes)])
            text = (head + ("#define WIDE_FORWARD\n" if tag == "fwd" else "#define WIDE_BACKWARD\n")
                    + text.replace('#include "wide_mma.cuh"\n',
                                   '#include "wide_mma.cuh"\n' + pc.PROBE_DEFS, 1) + pc.PROBE_API)
            built, log = pc.build_copies(names[tag], {tag: text})
            libs.update(built)
            logs.update(log)

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            list(pool.map(copy, ("fwd", "bwd")))
        for h in widths:
            with torch.no_grad():
                g, _, ops, w, xc, xq, s, gen = cs.random_round_case(cs.D, batch, rounds, dt, 95,
                                                                    dev, h=h)
                mats32, vecs32 = fd.pack_weights_f32(w)
                cot_c = torch.randn(xc.shape, generator=gen, device=dev)
                cot_q = torch.randn(xq.shape, generator=gen, device=dev)
                _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, rounds, dt)
                k1 = lambda: fd.decoder_rounds(xc, xq, s, ops, w, rounds, dt)
                k2b = lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dt)
                for tag, probes, fn in (("fwd", FWD_PROBES, k1), ("bwd", BWD_PROBES, k2b)):
                    res = pc.with_library(names[tag], libs[tag],
                                          lambda: pc.stage_cycles(libs[tag], probes, fn))
                    print(json.dumps(dict(state_dtype=dt, width=h, batch=batch, rounds=rounds,
                                          kernel=tag, resources=pc.kernel_resources(
                                              logs[tag], "replay" if tag == "bwd" else "fwd"),
                                          **res)), flush=True)
                del sc, sq
            torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--widths", default="256")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--stages", action="store_true")
    args = ap.parse_args(argv)
    if args.stages:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        stages(args.dtypes.split(","), [int(w) for w in args.widths.split(",")], args.batch,
               args.rounds)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        return 0

    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.kernels._build import SOURCES, build_libraries

    built = build_libraries([n for n in SOURCES if n.startswith("wide_")])
    print(json.dumps({"build_seconds": {n: round(s, 1) for n, (_, s, _) in built.items()}}),
          flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    r = args.rounds
    for dt in args.dtypes.split(","):
        for h in (int(w) for w in args.widths.split(",")):
            with torch.no_grad():
                g, _, ops, w, xc, xq, s, gen = cs.random_round_case(cs.D, args.batch, r, dt, 95,
                                                                    dev, h=h)
                mats32, vecs32 = fd.pack_weights_f32(w)
                cot_c = torch.randn(xc.shape, generator=gen, device=dev)
                cot_q = torch.randn(xq.shape, generator=gen, device=dev)
                _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, r, dt)
                r_ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(g), w, dt)
                calls = {
                    "k1": lambda: fd.decoder_rounds(xc, xq, s, ops, w, r, dt),
                    "k2a": lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, r, dt),
                    "k2b": lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q,
                                                dt),
                    "k5": lambda: rg._roll_rounds_cuda(r_ops, rounds=r),
                }
                for name, fn in calls.items():
                    ms = cs.time_ms(fn, warmup=1, iters=3)
                    print(json.dumps(dict(state_dtype=dt, width=h, batch=args.batch, rounds=r,
                                          call=name, ms=ms, kernels=by_kernel(fn))), flush=True)
                del sc, sq, r_ops, xc, xq, s, cot_c, cot_q
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
