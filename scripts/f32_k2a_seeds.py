#!/usr/bin/env python3
"""The f32 training kernels' readings over seeds, on one NVIDIA card.

    python3 scripts/f32_k2a_seeds.py [--seeds N]

``chip_smoke.py`` phase 6 reads two f32 numbers on one seed each; this
prints their spread over N seeds (default 6), one JSON line a case:

  width64   ``chip_smoke.width_case`` (d=11, B=64, R=3, a width-64 model
            padded to 128), beside phase 6's TOL_GRAD_REL_F32: the worst
            gradient leaf's relative L2 error of K2b against
            ``rounds_vjp_plain``, both fed K2a's stash (the gate,
            ``k2b_worst_rel``), and of the whole path, kernels under
            autograd against the plain versions under autograd (reported,
            ``whole_path_worst_rel``); the smoke's seed is 70, the sweep 70
            onward.
  k2a_k1    phase 6's f32 case (d=11, B=4096, R=14, H=128, random weights
            with bias_std 0.1): whether K2a's outputs equal K1's bit for bit
            and their max abs difference; the smoke's seeds are 9 (states)
            and 14 (weights), the sweep adds k to both.

Last it prints the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def k2a_vs_k1(dev, k: int) -> tuple[bool, float]:
    """Phase 6's f32 K2a against K1 with its seeds shifted by k: whether
    the outputs are equal and their max abs difference."""
    import torch

    import chip_smoke as cs
    from tpugnn_torch.configs import ModelConfig
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.tanner import build_code

    h, rounds = 128, 14
    dg = build_code("surface", cs.D).to(dev)
    ops = fd.make_operators(dg)
    gen = torch.Generator(device=dev).manual_seed(9 + k)
    model = GNNDecoder(ModelConfig(hidden=h, msg_hidden=h, rounds=rounds, backend="fused",
                                   qubit_head="pauli4", dtype="float32"), k=1)
    model.init_random(torch.Generator().manual_seed(14 + k), bias_std=0.1)
    w = fd.RoundWeights(*[t.detach() for t in model.to(dev).rounds.round_weights()])
    mats32, vecs32 = fd.pack_weights_f32(w)
    xc, xq, s = cs.random_states(dg, cs.B, h, gen)
    with torch.no_grad():
        k1c, k1q = fd.decoder_rounds(xc, xq, s, ops, w, rounds, "float32")
        kc, kq, _, _ = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, rounds, "float32")
        torch.cuda.synchronize()
    return (bool(torch.equal(kc, k1c) and torch.equal(kq, k1q)),
            cs.raster_errors(kc, kq, k1c, k1q)[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels._build import build_libraries

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    build_libraries(["wide_rounds_tf32", "wide_backward_tf32"])
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in range(args.seeds):
        r = cs.width_case("float32", dev, seed=70 + k)
        print(json.dumps(dict(case="width64", seed=70 + k, k2b_worst_rel=r["k2b_worst_rel"],
                              k2b_worst_leaf=r["k2b_worst_leaf"], tol_rel=r["tol_rel"],
                              over=r["k2b_worst_rel"] > r["tol_rel"],
                              whole_path_worst_rel=r["whole_path_worst_rel"],
                              whole_path_worst_leaf=r["whole_path_worst_leaf"],
                              whole_path_over=r["whole_path_worst_rel"] > r["tol_rel"],
                              k2a_vs_plain_max=r["k2a_vs_plain_max"])), flush=True)
    for k in range(args.seeds):
        equal, err = k2a_vs_k1(dev, k)
        print(json.dumps(dict(case="k2a_k1", seeds=[9 + k, 14 + k], equal=equal, max_abs=err)),
              flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
