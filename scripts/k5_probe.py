#!/usr/bin/env python3
"""Where K5's time goes, on one NVIDIA card.

    python3 scripts/k5_probe.py [--parent OLD_roll_gather.cu [--parent-f32 OLD.cu]]
                                [--f32-only]

K5 (``tpugnn_torch/kernels/csrc/roll_gather.cu``, bf16 states, and
``roll_gather_tf32.cu``, f32 states) against copies of its sources that
change one thing, each printed as one JSON line.  With f32
states (the trained decode's shape: surface d=11, B=4096, R=14, H=128,
seeded random weights and states; the 3xTF32 kernel):

  f32       K5's time as built (9 warps, 144-row chunks, two 16-row slabs
            of split weights, a fresh sum every two k-steps, the gather
            panel in shared memory) in turns with copies: ``warps8`` (8
            warps: d=11's raster side as a 128-row chunk and a 16-row one),
            ``ns3`` (three slabs), ``sr32`` (two 32-row slabs, so one fresh
            sum every four k-steps: fewer barriers and adds, less
            precision), and the
            kernel as built with its panel in global memory (``gpanels``,
            the wrapper's shared-memory limit lowered); each one's max
            distance from ``roll_rounds_plain``; the registers and spills
            ``ptxas`` reports for each f32 kernel; and one block's clock
            cycles per stage (A, B, A', C of a round) from a copy with
            ``clock64()`` probes.

With bf16 states (skipped with ``--f32-only``), at the bench config
(surface d=11, B=4096, R=8, H=128, seeded random weights and states), with
f32 slots and with ``slot16``:

  variants  K5's time as built (9 warps, 144-row chunks), beside copies
            with 8 warps, so d=11's raster side runs as a 128-row chunk and
            a 16-row tail (``warps8``), and the same with the tail cut out
            (``warps8_no_tail``; timing only, its states are wrong), in turns
            within one process; the states of the copies that compute the
            function against ``roll_rounds_plain``.
  larger    the same for ``as_built`` and ``warps8`` at d=13 and d=15
            (B=4096, R=8, f32 slots), where both run a ragged tail.
  probe     one block's clock cycles per stage (A, B, C of a round) of the
            kernel as built, from a copy with ``clock64()`` probes at the
            stage boundaries (thread 0 of block 0), and of ``warps8``.
  parent    with ``--parent``: K5 as built against another version of its
            source (say the parent commit's, from ``git show``; the f32
            kernel from ``--parent-f32``, by default the same file, as
            before the two state types built apart), in turns
            (parent, built, built, parent): bf16 at the bench config, and
            f32 on the trained d=11 weights (B=4096, R=14) with whether the
            two f32 results are bit-equal.

The copies (the unchanged source among them) are built by
``_probe_common.py`` and loaded in place of the library; the registers and
spills ``ptxas`` reports for each bf16 kernel are printed with them.  Last
it prints the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

from _probe_common import (CSRC, REPO, build_copies, emit, kernel_resources, replaced,
                           stage_cycles, with_library, with_probes)

sys.path.insert(0, REPO)

SOURCE = os.path.join(CSRC, "roll_gather.cu")
LIBRARY = "roll_gather"
SOURCE_F32 = os.path.join(CSRC, "roll_gather_tf32.cu")
LIBRARY_F32 = "roll_gather_tf32"

WARPS8 = [("constexpr int TC_WARPS = 9;", "constexpr int TC_WARPS = 8;")]
NO_TAIL = [
    ("  for (int row0 = 0; row0 < L; row0 += CRN) {\n    const int r0 = row0 + 16 * warp;\n"
     "    const int n = max(0, min(16, L - r0));\n    const bool active = n > 0;",
     "  for (int row0 = 0; row0 < min(L, CRN); row0 += CRN) {\n"
     "    const int r0 = row0 + 16 * warp;\n"
     "    const int n = max(0, min(16, L - r0));\n    const bool active = n > 0;"),
    ("    project_rows_tc<SR, NTH>(xq_src, L, proj,",
     "    project_rows_tc<SR, NTH>(xq_src, min(L, 16 * NWARP), proj,"),
]
VARIANTS = {"warps8": WARPS8, "warps8_no_tail": WARPS8 + NO_TAIL}

# the f32 kernel's copies: its shape constants, one thing changed each
F32_SHAPE = "constexpr int NWARP = 9, SR = 16, NS = 2;"
F32_VARIANTS = {
    "f32_warps8": [(F32_SHAPE, "constexpr int NWARP = 8, SR = 16, NS = 2;")],
    "f32_ns3": [(F32_SHAPE, "constexpr int NWARP = 9, SR = 16, NS = 3;")],
    "f32_sr32": [(F32_SHAPE, "constexpr int NWARP = 9, SR = 32, NS = 2;")],
}
# probe points of the f32 kernel's round loop
F32_PROBES = [
    ("      float* nxt = (R - 1 - round) % 2 == 0 ? xc : other;\n",
     "loop top (launch gap, discarded)"),
    ("                                wc + size_t(M_WD) * MAT);\n", "A projection x_q @ ws_c"),
    ("                         s.xs, rg, proj_q, width);\n", "B check cells"),
    ("      project_rows<SR, NS, NTH>(cur, rows, proj_q, s.panel, s.xs, rg, wq + size_t(M_WD) * MAT);\n",
     "A' projection x_c @ ws_q"),
    ("                          more ? proj_c : nullptr, width);\n", "C qubit cells"),
]

# Probe points of the `probe` measurement: (text in the round loop of the
# bf16 kernel, stage that ends there)
PROBES = [
    ("    const bf16* xq_src = round == 0 ? xq_in + b * size_t(L) * H : xq;\n",
     "loop top (launch gap, discarded)"),
    ("    project_rows_tc<SR, NTH>(xq_src, L, proj, s.ys_c, s.xs, sl, wc + size_t(M_WS) * HH);\n",
     "A projection"),
    ("                                             wq + size_t(M_WD) * HH, width);\n",
     "B check cells"),
    ("                                              round + 1 < R ? proj : nullptr, width);\n",
     "C qubit cells"),
]


def raster_operands(d: int):
    """The graph and K5's raster operands of surface distance d at the bench
    config (B=4096, R=8, seeded random weights and states) on the card."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import roll_gather as rg

    graph, _, _, w, xc, xq, s, _ = cs.random_round_case(d, cs.B, 8, "bfloat16", 5,
                                                        torch.device("cuda", 0))
    with torch.inference_mode():
        return graph, rg.to_raster(xc, xq, s, rg.plan_for_graph(graph), w, "bfloat16")


def in_turns(libs: dict, order, call, library: str = LIBRARY) -> dict:
    """call's ms on each library of `order`, then in the reverse order."""
    import chip_smoke as cs

    t = {k: [] for k in order}
    for name in (*order, *reversed(order)):
        t[name].append(with_library(library, libs[name], lambda: cs.time_ms(call)))
    return t


def versus_plain(libs: dict, names, ops, rounds: int, slot: str,
                 library: str = LIBRARY) -> dict:
    """Max and mean abs difference from roll_rounds_plain of each library."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import roll_gather as rg

    pc, pq = rg.roll_rounds_plain(ops, rounds=rounds, slot_dtype=slot)
    out = {}
    for name in names:
        kc, kq = with_library(library, libs[name], lambda: rg._roll_rounds_cuda(
            ops, rounds=rounds, slot_dtype=slot))
        torch.cuda.synchronize()
        out[name] = cs.raster_errors(kc, kq, pc, pq)
    return out


def parent_comparison(libs: dict, libs32: dict, ops, rounds: int, card: str) -> None:
    """K5 as built against the ``parent`` libraries: bf16 at the bench
    config, f32 on the trained d=11 weights; prints one JSON line."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.models.convert import load_decoder

    order = ("parent", "as_built")
    out = {}
    with torch.inference_mode():
        for slot in ("float32", "bfloat16"):
            out[f"bf16_slots_{slot}_ms"] = in_turns(
                libs, order, lambda: rg._roll_rounds_cuda(ops, rounds=rounds, slot_dtype=slot))
        _, model, graph = load_decoder(device="cuda")
        dg = graph.to("cuda")
        w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
        xc, xq, s = cs.random_states(dg, cs.B, 128, torch.Generator("cuda").manual_seed(6))
        f32 = rg.to_raster(xc, xq, s, rg.plan_for_graph(graph), w, "float32")
        r_t = model.cfg.rounds
        call = lambda: rg._roll_rounds_cuda(f32, rounds=r_t)
        a, b = (with_library(LIBRARY_F32, libs32[n], call) for n in order)
        torch.cuda.synchronize()
        out["f32_trained_bit_equal"] = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
        out["f32_trained_ms"] = in_turns(libs32, order, call, LIBRARY_F32)
    emit({"parent": out, "card": card})


def f32_measurements(libs: dict, logs: dict, card: str) -> None:
    """The ``f32`` line: the f32 kernel as built and its copies, in turns,
    on the trained decode's shape; their distances from the plain version,
    registers and spills, and one block's cycles per stage."""
    import contextlib

    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import roll_gather as rg
    from tpugnn_torch.kernels._build import load_library

    rounds = cs.TRAINED_ROUNDS
    graph, _, _, w, xc, xq, s, _ = cs.random_round_case(11, cs.B, rounds, "float32", 6,
                                                        torch.device("cuda", 0))
    flops = cs.rounds_flops(graph, 128) * cs.B * rounds
    names = ("as_built", *F32_VARIANTS)

    @contextlib.contextmanager
    def global_panel():
        old = rg.SMEM_LIMIT
        rg.SMEM_LIMIT = load_library(LIBRARY_F32).roll_rounds_gpanels_smem_bytes(
            ops.xc.shape[1])
        try:
            yield
        finally:
            rg.SMEM_LIMIT = old

    with torch.inference_mode():
        ops = rg.to_raster(xc, xq, s, rg.plan_for_graph(graph), w, "float32")
        call = lambda: rg._roll_rounds_cuda(ops, rounds=rounds)
        errors = {k: v[0] for k, v in versus_plain(libs, names, ops, rounds, "float32",
                                                   LIBRARY_F32).items()}
        t = in_turns(libs, names, call, LIBRARY_F32)
        with global_panel():
            before = rg.launch_counts()["roll_rounds_gpanels"]
            kc, kq = with_library(LIBRARY_F32, libs["as_built"], call)
            pc, pq = rg.roll_rounds_plain(ops, rounds=rounds)
            torch.cuda.synchronize()
            if rg.launch_counts()["roll_rounds_gpanels"] != before + 1:
                raise RuntimeError("the global-panel kernel was not launched")
            errors["gpanels"] = cs.raster_errors(kc, kq, pc, pq)[0]
            del kc, kq, pc, pq
            t["gpanels"] = in_turns(libs, ("as_built",), call, LIBRARY_F32)["as_built"]
        cycles = stage_cycles(libs["f32_clock"], F32_PROBES,
                              lambda: with_library(LIBRARY_F32, libs["f32_clock"], call))
    emit({"f32": {k: dict(ms=v, tflops=[flops / (x * 1e-3) / 1e12 for x in v],
                          max_abs_err=errors[k]) for k, v in t.items()},
          "f32_resources": {name: kernel_resources(logs[name], "roll_rounds_tf32x3")
                            for name in (*names, "f32_clock")},
          "f32_probe": cycles, "card": card})


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import roll_gather as rg

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another version of roll_gather.cu to time against")
    ap.add_argument("--parent-f32", help="the f32 kernel's source of that version "
                    "(default: the --parent file)")
    ap.add_argument("--f32-only", action="store_true", help="only the f32 kernel's copies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_probe.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    src, src32 = open(SOURCE).read(), open(SOURCE_F32).read()
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    texts32 = {"as_built": src32,
               **{name: replaced(src32, pairs) for name, pairs in F32_VARIANTS.items()},
               "f32_clock": with_probes(src32, F32_PROBES, " " * 6)}
    texts = {}
    if not args.f32_only:
        texts = {"as_built": src,
                 **{name: replaced(src, pairs) for name, pairs in VARIANTS.items()},
                 "clock": with_probes(src, PROBES, " " * 4),
                 "clock_warps8": with_probes(replaced(src, WARPS8), PROBES, " " * 4)}
    if args.parent:
        texts["parent"] = open(args.parent).read()
        texts32["parent"] = open(args.parent_f32 or args.parent).read()
    libs32, logs32 = build_copies(LIBRARY_F32, texts32)
    libs, logs = build_copies(LIBRARY, texts) if texts else ({}, {})
    f32_measurements(libs32, logs32, card)
    if args.f32_only:
        print(card)
        return 0
    resources = {name: kernel_resources(log, "roll_rounds_tc_kernel")
                 for name, log in logs.items()}

    graph, ops = raster_operands(11)
    rounds = 8
    flops = cs.rounds_flops(graph, 128) * cs.B * rounds
    times, errors = {}, {}
    with torch.inference_mode():
        for slot in ("float32", "bfloat16"):
            call = lambda: rg._roll_rounds_cuda(ops, rounds=rounds, slot_dtype=slot)
            for name, e in versus_plain(libs, ("as_built", "warps8"), ops, rounds, slot).items():
                errors[f"{name}/{slot}"] = e
            t = in_turns(libs, ("as_built", "warps8", "warps8_no_tail"), call)
            times[slot] = {k: dict(ms=v, tflops=[flops / (x * 1e-3) / 1e12 for x in v])
                           for k, v in t.items()}
    emit({"variants": times, "errors_max_mean": errors, "resources": resources, "card": card})

    larger = {}
    for d in (13, 15):
        g_d, ops_d = raster_operands(d)
        flops_d = cs.rounds_flops(g_d, 128) * cs.B * rounds
        with torch.inference_mode():
            t = in_turns(libs, ("as_built", "warps8"),
                         lambda: rg._roll_rounds_cuda(ops_d, rounds=rounds))
            larger[f"d{d}"] = dict(
                l_pad=ops_d.xc.shape[1],
                times={k: dict(ms=v, tflops=[flops_d / (x * 1e-3) / 1e12 for x in v])
                       for k, v in t.items()},
                errors_max_mean=versus_plain(libs, ("as_built", "warps8"), ops_d, rounds,
                                             "float32"))
        del ops_d
        torch.cuda.empty_cache()
    emit({"larger": larger, "card": card})

    probes = {}
    with torch.inference_mode():
        call = lambda: rg._roll_rounds_cuda(ops, rounds=rounds)
        for name in ("clock", "clock_warps8"):
            probes[name] = stage_cycles(libs[name], PROBES,
                                        lambda: with_library(LIBRARY, libs[name], call))
    emit({"probe": probes, "card": card})
    if args.parent:
        parent_comparison(libs, libs32, ops, rounds, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
