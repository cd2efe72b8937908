#!/usr/bin/env python3
"""The W = 128 rounds kernels against variants of their design, on one
NVIDIA card.

    python3 scripts/w128_levers.py

``csrc/wide_rounds.cuh`` runs K1, K2a and K2b at W = 128 with choices its
source note gives; this builds copies of its libraries with one choice
changed (text replaced in the sources, ``_probe_common.py``; the copies
instantiate W = 128 only, except ``gather4``) and times each against the
libraries as built, at d=11, B=4096 on seeded random weights
(``chip_smoke.random_round_case``): K1 at R=8, K2a and K2b at R=14, in
the state types the variant touches.  The variants:

* ``gather1``: the forward gather one slot (both rows) at a time, not
  four (f32: two);
* ``ring16``: a ring of sixteen weight slabs, not four (bf16);
* ``slab64``: 64-row weight slabs, not 32 (bf16; the packs re-cut to
  match);
* ``replay_flip``: the replay's tiles flipped, bf16 on 128 rows (its
  warpgroups each holding a row's 128 columns) and f32 on 64 (the columns
  split);
* ``replay_single``: the replay's gather one slot of one row at a time,
  its loads beside its sums (as past W = 128), not four slots (bf16) or
  one (f32) of both rows loaded ahead;
* ``gather4``: the forward gather four slots deep at every width (bf16),
  timed at W = 256 (H = MH = 256, R=8), where the kernel takes one.

Each variant's K1 and K2b are first held to the plain versions (B=64, R=3,
surface d=11 and circuit d=5: K1's largest distance, K2b's worst leaf as
``chip_smoke.grad_errors`` reads it, K2a equal to K1, two K2b calls
equal).  Prints one JSON line per check and per timing, and last the
card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _probe_common import CSRC, build_copies, emit, replaced  # noqa: E402

ONLY_128 = [("    case 256: return run_forward_w<T, 256, ROLL, SLOT16>(a);\n"
             "    case 384: return run_forward_w<T, 384, ROLL, SLOT16>(a);\n"
             "    case 512: return run_forward_w<T, 512, ROLL, SLOT16>(a);\n", ""),
            ("    case 256: return run_backward_w<T, 256>(a);\n"
             "    case 384: return run_backward_w<T, 384>(a);\n"
             "    case 512: return run_backward_w<T, 512>(a);\n", "")]
KB_FWD = "          constexpr int KB = NJ > 2 ? 1 : F32 ? 2 : 4;"
NS = "  static constexpr int NS = F32 ? (W <= 128 ? 4 : 2) : (W <= 384 ? 4 : 2);"
KS = "  static constexpr int KS = F32 ? (W <= 384 ? 16 : 8) : 32;"
REPLAY_GEO = "using ReplayGeo = Geo<T, W, (W > 128 || sizeof(T) == 2)>;"
# the replay's gather at W = 128: its slots loaded ahead of their sums
REPLAY_W128 = "      if constexpr (W == 128) {\n        // the slots' sources and values loaded ahead"

# name -> (libraries as (state type, forward?), replacements in wide_rounds.cuh,
#          in wide_mma.cuh, W = 128 only, bf16 slab rows at W = 128)
VARIANTS = {
    "gather1": ((("bfloat16", True), ("float32", True)), [(KB_FWD, "          constexpr int KB = 1;")],
                [], True, None),
    "ring16": ((("bfloat16", True), ("bfloat16", False)), [],
               [(NS, "  static constexpr int NS = F32 ? 4 : (W <= 128 ? 16 : W <= 384 ? 4 : 2);")],
               True, None),
    "slab64": ((("bfloat16", True), ("bfloat16", False)), [],
               [(KS, "  static constexpr int KS = F32 ? (W <= 384 ? 16 : 8) : (W == 128 ? 64 : 32);")],
               True, 64),
    "replay_flip": ((("bfloat16", False), ("float32", False)),
                    [(REPLAY_GEO, "using ReplayGeo = Geo<T, W, (W > 128 || sizeof(T) == 4)>;")], [],
                    True, None),
    "replay_single": ((("bfloat16", False), ("float32", False)),
                      [(REPLAY_W128, REPLAY_W128.replace("W == 128", "false"))], [], True, None),
    "gather4": ((("bfloat16", True),), [(KB_FWD, "          constexpr int KB = F32 ? 2 : 4;")], [],
                False, None),
}


def source(dt: str, forward: bool, rounds_pairs, mma_pairs, only128: bool) -> str:
    """A library's source with the variant's text: wide_mma.cuh inlined into
    wide_rounds.cuh, the entry points' defines ahead."""
    with open(os.path.join(CSRC, "wide_rounds.cuh")) as f:
        body = f.read()
    with open(os.path.join(CSRC, "wide_mma.cuh")) as f:
        mma = f.read()
    pairs = list(rounds_pairs) + (
        [ONLY_128[0] if forward else ONLY_128[1]] if only128 else [])
    body = replaced(body, [p for p in pairs if p[0] in body])
    body = body.replace('#include "wide_mma.cuh"\n', replaced(mma, mma_pairs), 1)
    head = ("#define WIDE_STATE float\n#define WIDE_CODE 0\n" if dt == "float32" else
            "#include <cuda_bf16.h>\n#define WIDE_STATE __nv_bfloat16\n#define WIDE_CODE 1\n")
    return head + ("#define WIDE_FORWARD\n" if forward else "#define WIDE_BACKWARD\n") + body


@contextlib.contextmanager
def in_place_of(libs: dict, slab_rows=None):
    """The libraries of ``libs`` (name -> loaded copy) in place of the
    built ones, and bf16 packs cut in slabs of ``slab_rows`` at W = 128."""
    import torch

    from tpugnn_torch.kernels import _build
    from tpugnn_torch.kernels import fused_decoder as fd

    real, real_rows = _build.load_library, fd.wide_slab_rows
    _build.load_library = lambda n: libs[n] if n in libs else real(n)
    if slab_rows is not None:
        fd.wide_slab_rows = lambda wid, dt: (slab_rows if wid == 128 and dt != torch.float32
                                             else real_rows(wid, dt))
    try:
        yield
    finally:
        _build.load_library, fd.wide_slab_rows = real, real_rows


def checks(dt: str) -> list:
    """K1 and K2b held to the plain versions (see the module's docstring)."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.tanner import build_circuit_code

    dev = torch.device("cuda", 0)
    out = []
    for gname, graph in (("surface_d11", None), ("circuit_d5", build_circuit_code("surface", 5, 5))):
        with torch.no_grad():
            _, _, ops, w, xc, xq, s, gen = cs.random_round_case(11, 64, 3, dt, 110, dev,
                                                                graph=graph)
            mats32, vecs32 = fd.pack_weights_f32(w)
            cot_c = torch.randn(xc.shape, generator=gen, device=dev)
            cot_q = torch.randn(xq.shape, generator=gen, device=dev)
            k1c, k1q = fd.decoder_rounds(xc, xq, s, ops, w, 3, dt)
            pc, pq = fd.rounds_plain(xc, xq, s, ops, w, rounds=3, state_dtype=dt)
            oc, oq, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, 3, dt)
            args = (sc, sq, s, ops, mats32, vecs32, cot_c, cot_q)
            kg = fb._bwd_cuda(*args, dt)
            again = fb._bwd_cuda(*args, dt)
            rels = cs.grad_errors(w, kg, fb.rounds_vjp_plain(*args, state_dtype=dt))
        leaf = max(rels, key=rels.get)
        out.append(dict(graph=gname, k1_vs_plain_max=cs.raster_errors(k1c, k1q, pc, pq)[0],
                        k2a_equals_k1=bool(torch.equal(oc, k1c) and torch.equal(oq, k1q)),
                        k2b_worst_rel=rels[leaf], k2b_worst_leaf=leaf,
                        k2b_repeatable=all(torch.equal(a, b) for a, b in zip(kg, again))))
    return out


def times(dt: str, forward: bool, backward: bool, h: int = 128) -> dict:
    """K1 (R=8) and K2a (R=14) with ``forward``, K2b (R=14) with
    ``backward``, at d=11, B=4096 and width ``h``."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    dev = torch.device("cuda", 0)
    out = {}
    if forward:
        with torch.inference_mode():
            _, _, ops, w, xc, xq, s, _ = cs.random_round_case(11, 4096, 8, dt, 13, dev, h=h)
            out["k1_r8_ms"] = cs.time_ms(lambda: fd.decoder_rounds(xc, xq, s, ops, w, 8, dt),
                                         warmup=2, iters=9)
            del xc, xq, s
    if h == 128:
        with torch.no_grad():
            _, _, ops, w, xc, xq, s, gen = cs.random_round_case(11, 4096, 14, dt, 10, dev)
            mats32, vecs32 = fd.pack_weights_f32(w)
            cot_c = torch.randn(xc.shape, generator=gen, device=dev)
            cot_q = torch.randn(xq.shape, generator=gen, device=dev)
            if forward:
                out["k2a_r14_ms"] = cs.time_ms(lambda: fb._fwd_stash_cuda(
                    xc, xq, s, ops, mats32, vecs32, 14, dt), warmup=2, iters=7)
            if backward:
                _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, 14, dt)
                out["k2b_r14_ms"] = cs.time_ms(lambda: fb._bwd_cuda(
                    sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, dt), warmup=1, iters=5)
                del sc, sq
            del xc, xq, s, cot_c, cot_q
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels._build import build_libraries

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = {}
    for name, (libs, rp, mp, only128, _) in VARIANTS.items():
        for dt, forward in libs:
            lib = fd.wide_library(fd.STATE_DTYPES[dt], backward=not forward)
            jobs[(name, lib)] = source(dt, forward, rp, mp, only128)
    copies = {}

    def build(key):
        name, lib = key
        return key, build_copies(lib, {name: jobs[key]})[0][name]

    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        base = pool.submit(build_libraries, ["wide_rounds", "wide_rounds_tf32", "wide_backward",
                                             "wide_backward_tf32"])
        for key, lib in pool.map(build, list(jobs)):
            copies[key] = lib
        base.result()
    for name, (libs, _, _, _, rows) in (("as_built", ((("bfloat16", True), ("float32", True)),
                                                      None, None, None, None)),
                                        *VARIANTS.items()):
        mine = {lib: c for (n, lib), c in copies.items() if n == name}
        for dt in dict.fromkeys(d for d, _ in libs):
            with in_place_of(mine, rows):
                if name != "gather4":
                    for c in checks(dt):
                        emit(dict(check=name, state_dtype=dt, **c))
    for name, (libs, _, _, _, rows) in VARIANTS.items():
        mine = {lib: c for (n, lib), c in copies.items() if n == name}
        for dt in dict.fromkeys(d for d, _ in libs):
            fwd = any(d == dt and f for d, f in libs)
            bwd = any(d == dt and not f for d, f in libs)
            h = 256 if name == "gather4" else 128
            # the libraries as built, then the variant, then as built again
            runs = [times(dt, fwd, bwd, h)]
            with in_place_of(mine, rows):
                runs.append(times(dt, fwd, bwd, h))
            runs.append(times(dt, fwd, bwd, h))
            emit(dict(variant=name, state_dtype=dt, width=h, as_built=runs[0], variant_ms=runs[1],
                      as_built_again=runs[2]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
