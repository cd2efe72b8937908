#!/usr/bin/env python3
"""ROADMAP A10: the wide rounds family at 128 columns against the
128-column kernels' global-panel variants, on one NVIDIA card.

    python3 scripts/a10_probe.py [--batch 4096] [--rounds 8]
    python3 scripts/a10_probe.py --vs-plain [--batch 64] [--rounds 3]

The wrappers send packs of 128 columns to the 128-column kernels; the wide
kernels (``csrc/wide_rounds.cuh``) hold no gather panels, so they take any
graph, and W = 128 in a build that instantiates it.  On surface d=13 and circuit d=7 (seeded random
weights of width 128, ``chip_smoke.random_round_case``), in both state
types, this times one call each (CUDA events, median after a warm-up) of:

* the global-panel variants through their wrappers: K1
  ``fused_rounds_gpanels`` and K2a ``fused_rounds_fwd_stash_gpanels`` (the
  shared-memory limit lowered to the variant's need where the shared panels
  would fit), K2b ``fused_rounds_bwd_gpanels`` (f32: ``force_gpanels``;
  bf16: the layout its library picks for the graph, named in the output);
* the wide family at W = 128 through the same wrappers with the wrappers'
  128-column limit moved below 128 (``fused_rounds_wide``,
  ``fused_rounds_fwd_stash_wide``, ``fused_rounds_bwd_wide``), on the same
  inputs, with each output's largest distance from the variant's beside.
  The wide libraries instantiate W = 128 only with WIDE_W128 defined: this
  builds copies of their four sources so (``_probe_common.py``, the repo's
  build flags) and loads them in place of the libraries.

Prints one JSON line per graph and state type (the launches, the times and
the distances), and last the card's name and power limit.

With ``--vs-plain`` it times nothing: on circuit d=5, circuit d=7 and
surface d=13, in both state types, at a batch the plain version can run, it
holds each K2b family to ``rounds_vjp_plain`` on the same stash (K2a's, of
the 128-column kernels) and cotangents, as ``chip_smoke.py`` gates K2b: the
worst relative L2 error over dxc, dxq, dsyn and the 25 weight leaves
(``chip_smoke.grad_errors``), for the 128-column K2b as the wrapper routes it,
its global-panel layout in f32 (``force_gpanels``) and the wide family at W =
128.  Changes no routing.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def wide_at_128():
    """The wrappers with their 128-column kernels' width moved to 64, so
    that packs of 128 columns go to the wide family."""
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels import roll_gather as rg

    old = fd.WIDTH, rg.WIDTH
    fd.WIDTH = rg.WIDTH = 64
    try:
        yield
    finally:
        fd.WIDTH, rg.WIDTH = old


@contextlib.contextmanager
def in_place_of(libs: dict):
    """The libraries of ``libs`` (name -> loaded copy) in place of the
    built ones inside the block."""
    from tpugnn_torch.kernels import _build

    real = _build.load_library
    _build.load_library = lambda n: libs[n] if n in libs else real(n)
    try:
        yield
    finally:
        _build.load_library = real


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vs-plain", action="store_true",
                    help="hold each K2b family to rounds_vjp_plain instead of timing")
    ap.add_argument("--batch", type=int, default=None, help="4096 (--vs-plain: 64)")
    ap.add_argument("--rounds", type=int, default=None, help="8 (--vs-plain: 3)")
    args = ap.parse_args(argv)
    b = args.batch or (64 if args.vs_plain else 4096)
    r = args.rounds or (3 if args.vs_plain else 8)

    import concurrent.futures

    import torch

    import chip_smoke as cs
    from tpugnn_torch.kernels import _build
    from tpugnn_torch.kernels import fused_backward as fb
    from tpugnn_torch.kernels import fused_decoder as fd
    from tpugnn_torch.kernels._build import build_libraries, load_library
    from tpugnn_torch.tanner import build_circuit_code, build_code

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _probe_common as pc

    build_libraries()
    wide = {}

    def copy(lib):
        with open(os.path.join(pc.CSRC, _build.SOURCES[lib])) as f:
            libs, _ = pc.build_copies(lib, {"w128": "#define WIDE_W128\n" + f.read()})
        wide[lib] = libs["w128"]

    names = [fd.wide_library(fd.STATE_DTYPES[dt], backward=b)
             for dt in ("bfloat16", "float32") for b in (False, True)]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(copy, names))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs = (("surface_d13", build_code("surface", 13)),
              ("circuit_d7", build_circuit_code("surface", 7, 7)))
    if args.vs_plain:
        graphs = (("circuit_d5", build_circuit_code("surface", 5, 5)),) + graphs

    def vs_plain(gname, graph, dt):
        """Each K2b family's worst relative error against the plain version."""
        res = dict(graph=gname, state_dtype=dt, batch=b, rounds=r, width=128,
                   tol_rel=cs.TOL_GRAD_REL_F32 if dt == "float32" else cs.TOL_GRAD_REL_BF16)
        with torch.no_grad():
            g, _, ops, w, xc, xq, s, gen = cs.random_round_case(0, b, r, dt, 110, dev, h=128,
                                                                graph=graph)
            mats32, vecs32 = fd.pack_weights_f32(w)
            cot_c = torch.randn(xc.shape, generator=gen, device=dev)
            cot_q = torch.randn(xq.shape, generator=gen, device=dev)
            _, _, sc, sq = fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32, r, dt)
            args_ = (sc, sq, s, ops, mats32, vecs32, cot_c, cot_q)
            pg = fb.rounds_vjp_plain(*args_, state_dtype=dt)
            fwd, bwd = (fd.wide_library(fd.STATE_DTYPES[dt], backward=k) for k in (False, True))
            runs = {"routed": lambda: fb._bwd_cuda(*args_, dt)}
            if dt == "float32":
                runs["gpanels"] = lambda: fb._bwd_cuda(*args_, dt, force_gpanels=True)
            for name, run in (*runs.items(), ("wide", None)):
                cs.reset_counts()
                if run is None:
                    with wide_at_128(), in_place_of({fwd: wide[fwd], bwd: wide[bwd]}):
                        kg = fb._bwd_cuda(*args_, dt)
                else:
                    kg = run()
                torch.cuda.synchronize()
                rels = cs.grad_errors(w, kg, pg)
                leaf = max(rels, key=rels.get)
                res[name] = dict(launched={k: v for k, v in cs.counts().items() if v},
                                 worst_rel=rels[leaf], worst_leaf=leaf)
        return res

    def timed(name, fn, iters):
        cs.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launched = {k: v for k, v in cs.counts().items() if v}
        return out, launched, cs.time_ms(fn, warmup=1, iters=iters)

    def dist(a, b):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))

    for gname, graph in graphs:
        for dt in ("bfloat16", "float32"):
            if args.vs_plain:
                print(json.dumps(vs_plain(gname, graph, dt)), flush=True)
                torch.cuda.empty_cache()
                continue
            tdt = fd.STATE_DTYPES[dt]
            res = dict(graph=gname, state_dtype=dt, batch=b, rounds=r, width=128)
            try:
                with torch.no_grad():
                    g, _, ops, w, xc, xq, s, gen = cs.random_round_case(
                        0, b, r, dt, 110, dev, h=128, graph=graph)
                    mats32, vecs32 = fd.pack_weights_f32(w)
                    cot_c = torch.randn(xc.shape, generator=gen, device=dev)
                    cot_q = torch.randn(xq.shape, generator=gen, device=dev)
                    need = cs.gpanels_smem(load_library(fd.forward_library(tdt)),
                                           fd._DTYPE_CODE[tdt], ops)
                    with cs.smem_limit(fd, min(need, fd.SMEM_LIMIT)):
                        k1, res["k1_launched"], res["k1_ms"] = timed(
                            "k1", lambda: fd.decoder_rounds(xc, xq, s, ops, w, r, dt), 3)
                        k2a, res["k2a_launched"], res["k2a_ms"] = timed(
                            "k2a", lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32,
                                                              r, dt), 3)
                    sc, sq = k2a[2], k2a[3]
                    force = dt == "float32"
                    k2b, res["k2b_launched"], res["k2b_ms"] = timed(
                        "k2b", lambda: fb._bwd_cuda(sc, sq, s, ops, mats32, vecs32, cot_c,
                                                    cot_q, dt, force_gpanels=force), 2)
                    del sc, sq
                    fwd, bwd = (fd.wide_library(tdt, backward=b) for b in (False, True))
                    with wide_at_128(), in_place_of({fwd: wide[fwd], bwd: wide[bwd]}):
                        k1w, res["k1w_launched"], res["k1w_ms"] = timed(
                            "k1w", lambda: fd.decoder_rounds(xc, xq, s, ops, w, r, dt), 3)
                        res["k1w_vs_k1_max"] = dist(k1w, k1)
                        del k1w
                        k2aw, res["k2aw_launched"], res["k2aw_ms"] = timed(
                            "k2aw", lambda: fb._fwd_stash_cuda(xc, xq, s, ops, mats32, vecs32,
                                                               r, dt), 3)
                        res["k2aw_vs_k2a_max"] = dist(k2aw[:2], k2a[:2])
                        wc, wq = k2aw[2], k2aw[3]
                        del k2aw
                        k2bw, res["k2bw_launched"], res["k2bw_ms"] = timed(
                            "k2bw", lambda: fb._bwd_cuda(wc, wq, s, ops, mats32, vecs32, cot_c,
                                                         cot_q, dt), 2)
                        res["k2bw_vs_k2b_max"] = dist(k2bw, k2b)
                        del wc, wq, k2bw
                    for k in ("k1", "k2a", "k2b"):
                        res[f"{k}_wide_over_variant"] = res[f"{k}w_ms"] / res[f"{k}_ms"]
                    del k1, k2a, k2b, xc, xq, s, cot_c, cot_q
            except torch.cuda.OutOfMemoryError as e:
                res["error"] = f"out of memory: {str(e)[:200]}"
            torch.cuda.empty_cache()
            print(json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
