#!/usr/bin/env python3
"""Where K4's bf16 time goes, on one NVIDIA card.

    python3 scripts/k4_probe.py [--parent OLD_sddmm.cu ...]

K4 (``tpugnn_torch/kernels/csrc/sddmm.cu``) at the bench config (surface
d=11, B=4096, H = MH = 128, to checks, seeded random weights, the states in
bf16), against copies of its source that change one thing, each printed as
one JSON line:

  variants  the tensor-core kernel as built (one block of 16 warps per
            sample: the rows through cp.async, the projections on mma.sync,
            the output in streaming 16-byte stores) in turns with
            copies: ``warps8`` (8 warps a block), ``no_cs`` (plain stores
            instead of st.global.cs), ``tma_loads`` (x through TMA bulk
            copies, one a row on an mbarrier, instead of cp.async); and,
            timing only (their outputs are wrong), ``no_x_loads``,
            ``no_products``, ``no_stores`` and ``loads_only`` (the x loads,
            the projections, the stores, or the latter two cut out).  Beside them the time
            of ``Tensor.zero_()`` on a tensor of the output's size, the
            card's own rate of writing it.  The copies that compute the
            function must give the as-built output bit for bit; as built
            against ``sddmm_edge_hidden_plain``.  Each time is per call over
            8 back-to-back calls, with its GB/s on the bytes the kernel
            moves (padded rows read in bf16, every padded slot row written
            in f32).
  probe     one block's clock cycles per phase (issuing the loads, waiting
            for x and the weights, the projections, streaming the output; a
            store's cycles are its issue and the stalls behind it), from a
            copy with ``clock64()`` probes on thread 0 of block 0.
  parent    with ``--parent`` (repeatable): the kernel as built against
            another version of the source (say the parent commit's, from
            ``git show``), in turns (parent, built, built, parent), bf16
            and f32, through the wrapper where the other version has the
            tensor-core entry point and else through its C entry point (FMA
            kernel, f32 weights); whether the two f32 outputs are bit-equal.

The copies are built by ``_probe_common.py`` and loaded in place of the
library; the registers and spills ``ptxas`` reports for each kernel are
printed with them.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from _probe_common import (CSRC, REPO, build_copies, emit, kernel_resources, replaced,
                           stage_cycles, with_library, with_probes)

sys.path.insert(0, REPO)

SOURCE = os.path.join(CSRC, "sddmm.cu")
LIBRARY = "sddmm"

STORE = "      __stcs(reinterpret_cast<float4*>(ob + (size_t(r) * D + k) * H), v);\n"
ROW_COPIES = """  for (int u = threadIdx.x; u < (ns16 + nd16) * (H / 8); u += NTH) {
    const int r = u / (H / 8), c = (u % (H / 8)) * 8;
    const bool src = r < ns16;
    const int rr = src ? r : r - ns16;
    const bool real = rr < (src ? rows_src : rows_dst);
    const bf16* x = src ? xs + (size_t(b) * rows_src + rr) * H
                        : xd + (size_t(b) * rows_dst + rr) * H;
    cp_async16(ys + r * LDB + c, real ? x + c : xs, real ? 16 : 0);
  }
"""
WAIT = "  cp_async_wait_all();\n  __syncthreads();\n"
PROJECTIONS = ("  for (int q = warp; q < (ns16 + nd16) / 16; q += NWARP)\n"
               "    project_in_place(ys + q * 16 * LDB, q * 16 < ns16 ? w_s : w_d);\n")
# x through the TMA, one bulk copy a row completing on an mbarrier, in place
# of cp.async
TMA_LOADS = [(ROW_COPIES, """  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_s = smem_u32(&bar);
  if (threadIdx.x == 0)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n"
                 "fence.mbarrier_init.release.cluster;\\n" :: "r"(bar_s) : "memory");
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                 :: "r"(bar_s), "r"((rows_src + rows_dst) * H * 2) : "memory");
  for (int r = threadIdx.x; r < ns16 + nd16; r += NTH) {
    const bool src = r < ns16;
    const int rr = src ? r : r - ns16;
    if (rr < (src ? rows_src : rows_dst)) {
      const bf16* x = src ? xs + (size_t(b) * rows_src + rr) * H
                          : xd + (size_t(b) * rows_dst + rr) * H;
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                   " [%0], [%1], %2, [%3];\\n"
                   :: "r"(smem_u32(ys + r * LDB)), "l"(x), "r"(H * 2), "r"(bar_s) : "memory");
    } else {
      for (int c = 0; c < H; c += 8)
        *reinterpret_cast<uint4*>(ys + r * LDB + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
"""), (WAIT, """  cp_async_wait_all();
  for (uint32_t done = 0; !done;)
    asm volatile("{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\\n"
                 " selp.u32 %0, 1, 0, p;\\n}\\n" : "=r"(done) : "r"(bar_s) : "memory");
  __syncthreads();
""")]
VARIANTS = {
    "warps8": [("constexpr int NWARP = 16; ", "constexpr int NWARP = 8;  ")],
    "no_cs": [(STORE, STORE.replace("__stcs(reinterpret_cast<float4*>(ob + (size_t(r) * D + k) * H), v)",
                                    "*reinterpret_cast<float4*>(ob + (size_t(r) * D + k) * H) = v"))],
    "tma_loads": TMA_LOADS,
    # timing only (the outputs are wrong): the x loads, the products or the
    # stores cut out
    "no_x_loads": [(ROW_COPIES, "")],
    "no_products": [(PROJECTIONS, "")],
    "no_stores": [(STORE, "      if (v.x == 12345.f)\n  " + STORE)],
}
VARIANTS["loads_only"] = VARIANTS["no_products"] + VARIANTS["no_stores"]
EXACT = ("warps8", "no_cs", "tma_loads")

# Probe points of the `probe` measurement: (text in the tensor-core kernel,
# phase that ends there), on thread 0 of block 0
PROBES = [
    ("  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n",
     "block start (gap since the previous launch, discarded)"),
    ("  cp_async_commit();\n", "issue the loads"),
    (WAIT, "wait for x and the weights"),
    ("    project_in_place(ys + q * 16 * LDB, q * 16 < ns16 ? w_s : w_d);\n  __syncthreads();\n",
     "projections"),
    ("      __stcs(reinterpret_cast<float4*>(ob + (size_t(r) * D + k) * H), v);\n    }\n  }\n",
     "stream the output"),
]


def bench_operands():
    """K4 to checks at the bench config on the card: the graph and (x_dst,
    x_src, slot sources, slot mask, wd, ws, bias), the states in bf16 (the
    JAX wrapper casts them to the compute type before its kernel)."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.tanner import build_code

    dev = torch.device("cuda", 0)
    graph = build_code("surface", cs.D)
    dg = graph.to(dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    h = 128
    xd = torch.randn((cs.B, graph.n_checks_pad, h), generator=gen, device=dev)
    xs = torch.randn((cs.B, graph.n_qubits_pad, h), generator=gen, device=dev)
    xd *= dg.check_mask[:, None]
    xs *= dg.qubit_mask[:, None]
    wd = torch.randn((h, h), generator=gen, device=dev) / h ** 0.5
    ws = torch.randn((h, h), generator=gen, device=dev) / h ** 0.5
    b = 0.1 * torch.randn(h, generator=gen, device=dev)
    src, mask = fd.make_operators(dg)[:2]
    return graph, (xd.bfloat16(), xs.bfloat16(), src, mask, wd, ws, b)


def parent_call(lib, args, compute: str):
    """The parent source's FMA kernel through its C entry point (x in the
    compute type, f32 weights); returns a function that launches it."""
    import torch

    from tpugnn_torch.kernels.fused_decoder import STATE_DTYPES

    xd, xs, src, mask, wd, ws, b = args
    cdt = STATE_DTYPES[compute]
    bsz, rows_dst, h = xd.shape
    rows_src, d, mh = xs.shape[1], src.shape[1], wd.shape[1]
    ops = [xd.to(cdt).contiguous(), xs.to(cdt).contiguous(),
           torch.where(mask > 0, src, -1).to(torch.int32).contiguous(),
           wd.float().contiguous(), ws.float().contiguous(), b.float().contiguous()]
    out = torch.empty((bsz, rows_dst * d, mh), dtype=torch.float32, device=xd.device)
    code = 1 if compute == "bfloat16" else 0

    def call():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = lib.sddmm_edge_hidden_launch(code, *(t.data_ptr() for t in ops), out.data_ptr(),
                                           bsz, rows_dst, rows_src, d, h, mh, stream)
        if err:
            raise RuntimeError(f"parent launch failed: CUDA error {err}")
        return out
    return call


def in_turns(calls: dict, order) -> dict:
    """Each call's ms in `order`, then in the reverse order (8 back-to-back
    calls a timing, per call)."""
    import chip_smoke as cs

    t = {k: [] for k in order}
    for name in (*order, *reversed(order)):
        t[name].append(cs.time_ms_per_call(calls[name]))
    return t


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import sddmm

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="another version of sddmm.cu to time against (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_probe.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    src = open(SOURCE).read()
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    texts = {"as_built": src, **{name: replaced(src, pairs) for name, pairs in VARIANTS.items()},
             "clock": with_probes(src, PROBES, "  ")}
    parents = {f"parent{k}": path for k, path in enumerate(args.parent)}
    texts.update({name: open(path).read() for name, path in parents.items()})
    libs, logs = build_copies(LIBRARY, texts)
    resources = {name: kernel_resources(log, "sddmm") for name, log in logs.items()}

    graph, ops = bench_operands()
    nbytes = cs.sddmm_padded_bytes(graph, cs.B, 128, 128, "bfloat16")
    gbs = lambda ms: nbytes / (ms * 1e-3) / 1e9
    run = lambda name: with_library(
        LIBRARY, libs[name], lambda: sddmm.sddmm_edge_hidden(*ops, compute_dtype="bfloat16"))
    with torch.inference_mode():
        built = run("as_built").clone()
        plain = sddmm.sddmm_edge_hidden_plain(*ops, compute_dtype="bfloat16")
        diff = (built - plain).abs()
        errors = {"as_built_vs_plain": dict(
            max_abs_err=float(diff.max()),
            differing_share=float(torch.count_nonzero(diff)) / diff.numel())}
        del plain, diff
        for name in EXACT:
            errors[f"{name}_equals_as_built"] = bool(torch.equal(run(name), built))
        fill = torch.empty_like(built)
        del built
        order = ("as_built", *VARIANTS)
        t = in_turns({name: (lambda n=name: run(n)) for name in order}, order)
        t["zero_fill"] = [cs.time_ms_per_call(fill.zero_) for _ in range(2)]
        del fill
    emit({"variants": {k: dict(ms=v, gb_per_s=[gbs(x) for x in v]) for k, v in t.items()},
          "bytes": nbytes, "bound_ms": cs.sddmm_bound(graph, cs.B, 128, 128, "bfloat16")[0],
          "errors": errors, "resources": resources, "card": card})

    with torch.inference_mode():
        call = lambda: sddmm.sddmm_edge_hidden(*ops, compute_dtype="bfloat16")
        probe = stage_cycles(libs["clock"], PROBES,
                             lambda: with_library(LIBRARY, libs["clock"], call))
    emit({"probe": probe, "card": card})

    for name, path in parents.items():
        out = {}
        with torch.inference_mode():
            for compute in ("bfloat16", "float32"):
                dt = fd.STATE_DTYPES[compute]
                ops_c = (ops[0].to(dt), ops[1].to(dt), *ops[2:])
                new, old = (lambda c=compute, o=ops_c, n=n: with_library(
                    LIBRARY, libs[n], lambda: sddmm.sddmm_edge_hidden(*o, compute_dtype=c))
                    for n in ("as_built", name))
                if not hasattr(libs[name], "sddmm_edge_hidden_tc_launch"):
                    old = parent_call(libs[name], ops_c, compute)   # a source from before it
                if compute == "float32":
                    out["f32_bit_equal"] = bool(torch.equal(new(), old()))
                out[f"{compute}_ms"] = in_turns({"parent": old, "as_built": new},
                                                ("parent", "as_built"))
        emit({"parent": out, "source": path, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
