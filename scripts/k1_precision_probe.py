#!/usr/bin/env python3
"""Where K1's f32 error against its plain version comes from, on one card.

    python3 scripts/k1_precision_probe.py [--weights NAME.npz ...] [--cpu] [--batch B]

For each circuit weights file (default: the five in ``tpugnn_torch/assets``)
the script embeds the shots of ``chip_smoke.py``'s check on that graph
(``detector_k1_check``: p=0.01, B=4096, generator seed 41) and runs the
f32 rounds three ways: K1 (``decoder_rounds``, the variant the graph calls
for), the plain f32 version (``rounds_plain``) and the same rounds in f64
(``chip_smoke.rounds_f64``: the plain version's steps on f64 tensors, no
rounding). It prints one JSON line per file:

  errors  the max and mean abs error of K1 against plain f32, K1 against
          f64 and plain f32 against f64, on each side (checks, fault
          classes);
  worst   the entry where K1 and plain f32 differ most: side, sample, row,
          column, whether the row is real, its degree, the three values
          there, and by round (1..R, each a separate run) the two f32
          errors against f64 at that entry with the f64 LayerNorm's
          1/std of the row.

With ``--cpu`` (and ``--batch`` to cut the shots) there is no K1: the
plain f32 version against f64 on the CPU's own shots, and ``worst`` is the
entry where those two differ most. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from tpugnn_torch.kernels import fused_decoder as fd  # noqa: E402
from tpugnn_torch.models.convert import load_decoder  # noqa: E402
from tpugnn_torch.sampling import sample_batch  # noqa: E402

ASSETS = os.path.join(REPO, "tpugnn_torch", "assets")
WEIGHTS = ("circuit_surface_d3_t3_h128_r8_ema24000.npz",
           "circuit_surface_d5_t5_h128_r8_ema24000.npz",
           "circuit_surface_d3_t3_x_h128_r8_ema6000.npz",
           "circuit_surface_d5_t5_x_h128_r8_ema8000.npz",
           "circuit_surface_d7_t7_h128_r8_ema2000.npz")
P, B, SEED = 0.01, 4096, 41


def errs(a, b) -> dict:
    d = (a.double() - b.double()).abs()
    return dict(max=float(d.max()), mean=float(d.mean()))


def probe(name: str, dev, cpu: bool, batch: int) -> dict:
    _, model, graph = load_decoder(os.path.join(ASSETS, name), device=dev)
    dg = graph.to(dev)
    with torch.inference_mode():
        syn = sample_batch(torch.Generator(device=dev).manual_seed(SEED), dg, P, batch).syndrome
        xc, xq, s_pm = model.embed(dg, syn)
        xq = xq.contiguous()
        w = fd.RoundWeights(*[t.detach() for t in model.rounds.round_weights()])
        s = s_pm[..., None]
        ops = fd.make_operators(dg)
        rounds = model.cfg.rounds

        def k1(r):
            return fd.decoder_rounds(xc, xq, s, ops, w, r, "float32")

        def plain(r):
            return fd.rounds_plain(xc, xq, s, ops, w, rounds=r)

        pc, pq = plain(rounds)
        ec, eq = cs.rounds_f64_chunked(xc, xq, s, ops, w, rounds)
        kc, kq = (pc, pq) if cpu else k1(rounds)
        errors = {side: {"k1_vs_plain": errs(k, p), "k1_vs_f64": errs(k, e),
                         "plain_vs_f64": errs(p, e)}
                  for side, k, p, e in (("checks", kc, pc, ec), ("faults", kq, pq, eq))}
        by = "plain_vs_f64" if cpu else "k1_vs_plain"
        side = max(errors, key=lambda sd: errors[sd][by]["max"])
        at = 0 if side == "checks" else 1
        k, p, e = (kc, kq)[at], (pc, pq)[at], (ec, eq)[at]
        b, i, j = (int(v) for v in torch.unravel_index(
            ((p - e) if cpu else (k - p)).abs().argmax(), k.shape))
        mask = graph.check_mask if side == "checks" else graph.qubit_mask
        deg = ops[2] if side == "checks" else ops[5]
        by_round = []
        for r in range(1, rounds + 1):
            p_r = plain(r)[at]
            keeps = []
            e_r = cs.rounds_f64(xc[b:b + 1], xq[b:b + 1], s[b:b + 1], ops, w, r, keeps)[at]
            row = dict(round=r, plain_vs_f64=float(p_r[b, i, j] - e_r[0, i, j]),
                       f64=float(e_r[0, i, j]), ln_inv_f64=float(keeps[-1][at]["inv"][0, i, 0]))
            if not cpu:
                row["k1_vs_f64"] = float(k1(r)[at][b, i, j] - e_r[0, i, j])
            by_round.append(row)
        worst = dict(side=side, sample=b, row=i, column=j, real=bool(mask[i]),
                     degree=float(deg[i]), k1=None if cpu else float(k[b, i, j]),
                     plain=float(p[b, i, j]), f64=float(e[b, i, j]), by_round=by_round)
    return dict(weights=name, graph=graph.name, device=str(dev), errors=errors, worst=worst)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", nargs="*", default=list(WEIGHTS))
    ap.add_argument("--cpu", action="store_true",
                    help="plain f32 one sample at a time in K1's place, on the CPU")
    ap.add_argument("--batch", type=int, default=B)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("k1_precision_probe: no CUDA device (use --cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    for name in args.weights:
        print(json.dumps(probe(name, dev, args.cpu, args.batch)), flush=True)


if __name__ == "__main__":
    main()
