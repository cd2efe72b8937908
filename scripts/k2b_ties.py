#!/usr/bin/env python3
"""Why and how f32 K2b takes the ties of its replay again, on one NVIDIA card.

    python3 scripts/k2b_ties.py

At the f32 case of ``chip_smoke.py`` phase 6 (surface d=11, H=128, B=4096,
R=14, its seeded random weights, states and cotangents; K2a's stash), each
measurement printed as one JSON line:

  cublas    whether the card's f32 products (``torch.matmul``, cuBLAS) equal
            a loop of one FMA per k, k ascending, from 0, bit for bit, at
            the row counts the rounds use, 2-d and batched (the loop is a
            small kernel built here).
  emulated  ``rounds_vjp_plain``'s distance from itself (worst relative
            error over dxc, dxq, dsyn and the 25 weight leaves) with its
            products formed otherwise: all split three ways (3xTF32), only
            the replay's, only the adjoint's and weight gradients', the
            replay's in f64 rounded to f32.
  kernel    f32 K2b's distance from ``rounds_vjp_plain``, and that of a copy
            without the tie re-decisions.
  bands     copies with other tie bands (TAU_Z, TAU_T): the distance, the
            ties taken again (counted) and the time.
  cost      the time of copies that take no row of t again, or nothing (both
            bands 0), beside the kernel's, in turns.
  widths    models of width 64 and 96 on the same shapes (padded to 128 as
            the wrapper pads them): the kernel's time and the ties taken
            again a sample and round (their padded columns take none).

The copies build with the flags of ``tpugnn_torch/kernels/_build.py`` into
``tpugnn_torch/_build/``.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

from _probe_common import CSRC, REPO, build_copies, emit, replaced, with_library
from k2b_probe import KERNELS, TIE_API, TIE_COUNTS, tie_counts

sys.path.insert(0, REPO)

LIBRARY = "fused_backward_tf32"
TAU_Z = "constexpr float TAU_Z = 1.f / 1048576;   // 2^-20"
TAU_T = "constexpr float TAU_T = 1.f / 1048576;"
BANDS = ((16, 14), (18, 18), (22, 20))   # (z, t): bands of 2^-z and 2^-t
ROWS = (2048, 8192, 524288)              # B x 128 rows of a side

SEQ_DOT = r"""
// out[r][c] = one FMA per k, k ascending, from 0, of x[r][k] * w[k][c]
extern "C" __global__ void seq_dot(const float* x, const float* w, float* out, int rows) {
  const int c = threadIdx.x, r = blockIdx.x;
  float acc = 0.f;
  for (int k = 0; k < 128; ++k) acc = fmaf(x[r * 128 + k], w[k * 128 + c], acc);
  out[r * 128 + c] = acc;
}
extern "C" int seq_dot_launch(const float* x, const float* w, float* out, int rows,
                              void* stream) {
  seq_dot<<<rows, 128, 0, (cudaStream_t)stream>>>(x, w, out, rows);
  return (int)cudaGetLastError();
}
"""


def band(tz: int, tt: int) -> list:
    return [(TAU_Z, f"constexpr float TAU_Z = {2.0 ** -tz!r}f;"),
            (TAU_T, f"constexpr float TAU_T = {2.0 ** -tt!r}f;")]


def cublas_order() -> dict:
    """Rows of x @ w equal to the FMA loop's, 2-d and batched [B, 128, 128]."""
    import torch

    from tpugnn_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, "seq_dot.cu")
    lib_path = os.path.join(BUILD_DIR, "libseq_dot.so")
    with open(src, "w") as f:
        f.write(SEQ_DOT)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.seq_dot_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((128, 128), generator=gen, device="cuda") / 128 ** 0.5
    out = {}
    for rows in ROWS:
        x = torch.randn((rows, 128), generator=gen, device="cuda")
        loop = torch.empty_like(x)
        lib.seq_dot_launch(x.data_ptr(), w.data_ptr(), loop.data_ptr(), rows,
                           torch.cuda.current_stream().cuda_stream)
        batched = (x.reshape(-1, 128, 128) @ w).reshape(rows, 128)
        out[rows] = dict(equal_2d=float(((x @ w) == loop).float().mean()),
                         equal_batched=float((batched == loop).float().mean()))
    return out


def phase6_case():
    """chip_smoke.py phase 6's f32 case: its weights, K2a's stash, the
    cotangents; returns (w, the wrapper's call, the plain version's call)."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.tanner import build_code

    dev = torch.device("cuda", 0)
    dg = build_code("surface", cs.D).to(dev)
    ops = fd.make_operators(dg)
    gen = torch.Generator(device=dev).manual_seed(9)
    model = GNNDecoder(ModelConfig(hidden=128, msg_hidden=128, rounds=14, backend="fused",
                                   qubit_head="pauli4", dtype="float32"), k=1)
    model.init_random(torch.Generator().manual_seed(14), bias_std=0.1)
    w = fd.RoundWeights(*[t.detach() for t in model.to(dev).rounds.round_weights()])
    mats32, vecs32 = fd.pack_weights_f32(w)
    xc, xq, s = cs.random_states(dg, cs.B, 128, gen)
    cot_c = torch.randn(xc.shape, generator=gen, device=dev)
    cot_q = torch.randn(xq.shape, generator=gen, device=dev)
    with torch.no_grad():
        _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, 14, "float32")
    args = (sc, sq, s, ops, mats32, vecs32, cot_c, cot_q)
    return w, (lambda: fb._bwd_cuda(*args, "float32")), (lambda: fb.rounds_vjp_plain(*args))


def padded_case(h: int):
    """A model of width h at phase 6's shapes, states and packs padded to
    128 as ``padded_rounds`` pads them; returns the wrapper's call."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd

    dev = torch.device("cuda", 0)
    _, _, ops, w, xc, xq, s, gen = cs.random_round_case(cs.D, cs.B, 14, "float32", 70, dev, h=h)
    mats32, vecs32 = fd.pad_packs(*fd.pack_weights_f32(w))
    xc, xq = fd.pad_states(xc, xq)
    cot_c = torch.randn(xc.shape, generator=gen, device=dev)
    cot_q = torch.randn(xq.shape, generator=gen, device=dev)
    with torch.no_grad():
        _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, 14, "float32", h)
    return lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c, cot_q, "float32", h)


def products_mode(kinds, how):
    """A TorchFunctionMode forming the selected kinds of f32 product
    otherwise: ``replay`` (x @ W), ``adjoint`` (g @ W^T) and ``wgrad``
    (a^T @ b), each as ``how``: '3xtf32' (both operands split into TF32
    halves, three products) or 'f64' (rounded back to f32)."""
    import torch
    from torch.overrides import TorchFunctionMode

    from tpugnn_torch.kernels import fused_decoder as fd

    products = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}

    def kind(a, w):
        if a.dim() == 2 and a.shape[0] > 1 and a.stride(0) == 1 and a.stride(1) != 1:
            return "wgrad"
        if w.dim() == 2 and w.stride(0) == 1 and w.stride(1) != 1:
            return "adjoint"
        return "replay"

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in products and all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
                                        for t in args[:2]):
                a, w = args[:2]
                if kind(a, w) in kinds:
                    if how == "f64":
                        return (a.double() @ w.double()).float()
                    ah, wh = fd.tf32_round(a), fd.tf32_round(w)
                    al, wl = fd.tf32_round(a - ah), fd.tf32_round(w - wh)
                    return torch.matmul(al, wh) + torch.matmul(ah, wl) + torch.matmul(ah, wh)
            return func(*args, **kwargs)

    return Mode()


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels._build import build_libraries

    if not torch.cuda.is_available():
        print("k2b_ties.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build_libraries(["fused_rounds_tf32", LIBRARY])
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    emit({"cublas": cublas_order(), "card": card})

    src = open(os.path.join(CSRC, KERNELS["float32"]["source"])).read()
    copies = {"no_ties": replaced(src, KERNELS["float32"]["cuts"]["no_ties"]),
              "no_t_ties": replaced(src, [(TAU_T, "constexpr float TAU_T = 0.f;")]),
              "idle": replaced(src, [(TAU_Z, "constexpr float TAU_Z = 0.f;"),
                                     (TAU_T, "constexpr float TAU_T = 0.f;")]),
              **{f"z{tz}_t{tt}": replaced(src, TIE_COUNTS + band(tz, tt)) + TIE_API
                 for tz, tt in BANDS},
              "z20_t20": replaced(src, TIE_COUNTS) + TIE_API}
    libs, _ = build_copies(LIBRARY, copies)

    w, run, plain = phase6_case()
    with torch.no_grad():
        pg = plain()
        worst = lambda g: max(cs.grad_errors(w, g, pg).values())
        emulated = {}
        for name, kinds, how in (("all_3xtf32", ("replay", "adjoint", "wgrad"), "3xtf32"),
                                 ("replay_3xtf32", ("replay",), "3xtf32"),
                                 ("adjoint_wgrad_3xtf32", ("adjoint", "wgrad"), "3xtf32"),
                                 ("replay_f64", ("replay",), "f64")):
            with products_mode(kinds, how):
                g = plain()
            emulated[name] = worst(g)
        emit({"emulated": emulated, "card": card})
        emit({"kernel": {"kernel": worst(run()),
                         "no_ties": worst(with_library(LIBRARY, libs["no_ties"], run))},
              "card": card})
        bands = {}
        for name in [f"z{tz}_t{tt}" for tz, tt in BANDS] + ["z20_t20"]:
            lib = libs[name]
            bands[name] = dict(worst_rel=worst(with_library(LIBRARY, lib, run)),
                               **tie_counts(lib, lambda: with_library(LIBRARY, lib, run),
                                            cs.B * 14),
                               ms=with_library(LIBRARY, lib,
                                               lambda: cs.time_ms(run, warmup=1, iters=3)))
        emit({"bands": bands, "card": card})
        cost = {}
        for _ in range(2):
            cost.setdefault("kernel", []).append(cs.time_ms(run, warmup=1, iters=5))
            for name in ("no_t_ties", "idle"):
                cost.setdefault(name, []).append(with_library(
                    LIBRARY, libs[name], lambda: cs.time_ms(run, warmup=1, iters=5)))
        emit({"cost": cost, "card": card})
        del run, plain, pg
        torch.cuda.empty_cache()
        widths = {}
        for h in (64, 96):
            padded = padded_case(h)
            counted = tie_counts(libs["z20_t20"],
                                 lambda: with_library(LIBRARY, libs["z20_t20"], padded), cs.B * 14)
            widths[h] = dict(ms=cs.time_ms(padded, warmup=1, iters=3),
                             **{k: v for k, v in counted.items() if k.endswith("per_sample_round")})
            del padded
            torch.cuda.empty_cache()
        emit({"widths": widths, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
