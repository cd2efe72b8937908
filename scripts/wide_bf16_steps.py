#!/usr/bin/env python3
"""Where bf16 training steps through the rounds kernels stand against f32
states, at width 128 and above, on one NVIDIA card.

    python3 scripts/wide_bf16_steps.py [--seeds N] [--widths 128,256]

``chip_smoke.py`` phase 6d holds two bf16 training steps of a width-256
model (surface d=5, R=3, B=256, the phase's config) through the wide K2a
and K2b against the same steps through the plain versions, and both
against the same steps with f32 states (``train_steps_vs_plain`` with its
witness).  This prints, for N seeds (default 3: the model's init and the
batches both move) and each width, one JSON line:

  steps   after each step, the worst parameter leaf's relative L2 error of
          its change from the start, and the mean over leaves: kernels
          against plain, kernels, plain and the zero-weight-gradient fault
          against f32 states;
  grads   the first step's gradients, worst leaf and mean over leaves:
          kernels against plain, kernels and plain against f32 states;
  ratio   kernels' distance from f32 states over plain's, worst leaf and
          mean, after each step (phase 6d's gate), and the fault's;
  order   the same steps through the plain versions with every f32 matrix
          product formed in f64 and rounded once (``f64_products``: the same
          function, only the products' f32 rounding moved) against plain,
          and its gradients: how far a change of summation order alone
          moves the bf16 steps, beside the kernels' distance from plain;
  adjoint K2b alone on the same model: the rounds' inputs of one batch
          (the model's embedding), K2a's stash, random cotangents; per
          leaf of K2b's outputs (dxc, dxq, dsyn, the 25 round weights) its
          relative L2 error against ``rounds_vjp_plain`` fed the same stash
          (``k_vs_p``), and K2b's and plain's against the same adjoint with
          f32 states (``k_vs_f32``, ``p_vs_f32``) and plain with f64
          products against plain (``order``); the worst leaf of each, and
          the leaves where K2b lands more than 1.1 times plain's distance
          from f32; and K2a's outputs beside (``forward``: max and mean abs
          distance of K2a and of the plain forward from the f32-state one).

Last it prints the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def f64_products():
    """A context in which the plain rounds (``rounds_fwd_stash_plain``,
    ``rounds_vjp_plain``) form every f32 matrix product in f64, rounded to
    f32 once; the wrappers enter the mode themselves, so the backward (run
    on autograd's own thread) takes it too."""
    import contextlib

    import torch
    from torch.overrides import TorchFunctionMode

    from tpugnn_torch.kernels import fused_backward as fb

    products = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}

    class F64Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in products and all(isinstance(a, torch.Tensor)
                                        and a.dtype == torch.float32 for a in args[:2]):
                return torch.matmul(args[0].double(), args[1].double()).float()
            return func(*args, **(kwargs or {}))

    def in_f64(fn):
        def run(*args, **kwargs):
            with F64Products():
                return fn(*args, **kwargs)
        return run

    @contextlib.contextmanager
    def patched():
        fwd, vjp = fb.rounds_fwd_stash_plain, fb.rounds_vjp_plain
        fb.rounds_fwd_stash_plain, fb.rounds_vjp_plain = in_f64(fwd), in_f64(vjp)
        try:
            yield
        finally:
            fb.rounds_fwd_stash_plain, fb.rounds_vjp_plain = fwd, vjp

    return patched()


def adjoint(state, cfg, dg, dev, seed: int) -> dict:
    """K2b of the model's rounds on one batch against the plain adjoint,
    both against the adjoint with f32 states (see ``adjoint`` above)."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.sampling import sample_batch

    model, dt, rounds = state.model, cfg.model.dtype, cfg.model.rounds
    gen = torch.Generator(device=dev).manual_seed(1000 + seed)
    syndrome = sample_batch(gen, dg, 0.05, cfg.train.batch).syndrome
    w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
    mats32, vecs32 = fd.pack_weights_f32(w)
    ops = fd.make_operators(dg)
    with torch.no_grad():
        xc, xq, s_pm = model.embed(dg, syndrome)
        syn = s_pm[..., None].float()
        kc, kq, sc, sq = fb._fwd_stash_cuda(xc, xq, syn, ops, mats32, vecs32, rounds, dt)
        pc, pq, _, _ = fb.rounds_fwd_stash_plain(xc, xq, syn, ops, mats32, vecs32,
                                                 rounds=rounds, state_dtype=dt)
        tc, tq, _, _ = fb.rounds_fwd_stash_plain(xc, xq, syn, ops, mats32, vecs32,
                                                 rounds=rounds, state_dtype="float32")
        forward = {f"{a}_vs_f32": dict(zip(("max", "mean"), cs.raster_errors(
            c.float(), q.float(), tc, tq))) for a, c, q in (("k", kc, kq), ("p", pc, pq))}
        forward["k_vs_p"] = dict(zip(("max", "mean"), cs.raster_errors(
            kc.float(), kq.float(), pc.float(), pq.float())))
        cot_c = torch.randn(xc.shape, generator=gen, device=dev)
        cot_q = torch.randn(xq.shape, generator=gen, device=dev)
        args = (sc, sq, syn, ops, mats32, vecs32, cot_c, cot_q)
        kg = fb._bwd_cuda(*args, dt)
        pg = fb.rounds_vjp_plain(*args, state_dtype=dt)
        tg = fb.rounds_vjp_plain(*args, state_dtype="float32")
        with f64_products():
            og = fb.rounds_vjp_plain(*args, state_dtype=dt)
        torch.cuda.synchronize()
    errs = dict(k_vs_p=cs.grad_errors(w, kg, pg), k_vs_f32=cs.grad_errors(w, kg, tg),
                p_vs_f32=cs.grad_errors(w, pg, tg), order=cs.grad_errors(w, og, pg))
    out = {k: worst_mean(v) for k, v in errs.items()}
    out["kernel_further"] = {n: dict(ratio=errs["k_vs_f32"][n] / errs["p_vs_f32"][n],
                                     **{k: v[n] for k, v in errs.items()})
                             for n in errs["k_vs_f32"]
                             if errs["k_vs_f32"][n] > 1.1 * errs["p_vs_f32"][n]}
    out["leaves"] = errs
    out["forward"] = forward
    return out


def worst_mean(errs: dict) -> dict:
    leaf = max(errs, key=errs.get)
    return dict(worst=errs[leaf], leaf=leaf, mean=sum(errs.values()) / len(errs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--widths", default="128,256")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels._build import build_libraries
    from tpugnn_torch.tanner import build_code

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    build_libraries(["fused_rounds", "fused_backward", "wide_rounds", "wide_backward"])
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dg = build_code("surface", cs.WIDE_TRAIN_D).to(dev)
    for seed in range(args.seeds):
        for h in (int(w) for w in args.widths.split(",")):
            state, cfg = cs.wide_train_state(h, "bfloat16", seed, dev)
            errs = cs.train_steps_vs_plain(state, cfg, dg, dev, seed=77 + seed, witness=True,
                                           extra={"f64_products": f64_products})
            vs = errs["vs_f32"]
            steps = [dict(kernels_vs_plain=worst_mean(k), kernels_vs_f32=worst_mean(kf),
                          plain_vs_f32=worst_mean(pf), zero_vs_f32=worst_mean(zf))
                     for k, kf, pf, zf in zip(errs["kernels"], vs["kernels"], vs["plain"],
                                              vs["zero_wgrads"])]
            ratio = [{k: dict(worst=s[f"{k}_vs_f32"]["worst"] / s["plain_vs_f32"]["worst"],
                              mean=s[f"{k}_vs_f32"]["mean"] / s["plain_vs_f32"]["mean"])
                      for k in ("kernels", "zero")} for s in steps]
            cs.emit(dict(seed=seed, width=h, graph=f"surface d={cs.WIDE_TRAIN_D}",
                         rounds=cs.D13_ROUNDS, batch=cfg.train.batch, steps=steps,
                         grads={k: worst_mean(v) for k, v in errs["grads"].items()},
                         ratio=ratio,
                         order=dict(steps=[worst_mean(e) for e in errs["f64_products"]],
                                    grads=worst_mean(errs["grads"]["f64_products_vs_plain"])),
                         adjoint=adjoint(state, cfg, dg, dev, seed)))
            del state
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
