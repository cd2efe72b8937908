"""LER of a trained decoder in the JAX package at two GEMM precisions.

Restores a checkpoint (from a temporary copy) and runs the JAX package's own
``tpugnn.eval.ler_monte_carlo`` on the CPU with ``GNNDecoder(backend='fused')``
in f32, in one of two modes:

  f32   every dot product at full f32 precision (what XLA on a CPU does)
  bf16  every f32 dot product with its operands rounded to bf16 and f32
        accumulation: what ``jax_default_matmul_precision='bfloat16'``, a
        TPU's default for f32 GEMMs, means.  XLA on a CPU ignores that flag,
        so this mode lowers ``dot_general`` with explicit bf16 converts.

The shots come from ``jax.random.PRNGKey(--seed)`` and are the same in both
modes, so the two rates are paired.  Prints one JSON line.

    JAX_PLATFORMS=cpu python scripts/jax_ler_precision.py --mode bf16 \
        --ckpt runs/v3_surface_d11/ema --distance 11 --hidden 128 --rounds 14 \
        --p 0.05 --shots 131072 --seed 0

Imports JAX and ``tpugnn``; it is a reference measurement, not part of
``tpugnn_torch``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def lower_dots_at_bf16() -> None:
    """Make XLA on this process lower every f32 ``dot_general`` with both
    operands rounded to bf16 (f32 result, f32 accumulation)."""
    from jax import lax
    from jax._src.interpreters import mlir
    from jax._src.lib.mlir import ir
    from jax._src.lib.mlir.dialects import hlo

    entry = (mlir._platform_specific_lowerings["cpu"].get(lax.dot_general_p)
             or mlir._lowerings[lax.dot_general_p])
    base = entry.rule

    def to_bf16_and_back(x, aval):
        if aval.dtype != np.float32:
            return x
        shape = list(aval.shape)
        y = hlo.convert(ir.RankedTensorType.get(shape, ir.BF16Type.get()), x)
        return hlo.convert(ir.RankedTensorType.get(shape, ir.F32Type.get()), y)

    def rule(ctx, lhs, rhs, **params):
        lhs_aval, rhs_aval = ctx.avals_in
        return base(ctx, to_bf16_and_back(lhs, lhs_aval),
                    to_bf16_and_back(rhs, rhs_aval), **params)

    mlir.register_lowering(lax.dot_general_p, rule, platform="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("f32", "bf16"), required=True)
    ap.add_argument("--ckpt", required=True, help="orbax checkpoint directory")
    ap.add_argument("--family", default="surface")
    ap.add_argument("--distance", type=int, required=True)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--head", default="pauli4", choices=("bits", "pauli4"))
    ap.add_argument("--p", type=float, default=0.05)
    ap.add_argument("--shots", type=int, default=131072)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tpugnn.configs import CodeConfig, ExperimentConfig, ModelConfig
    from tpugnn.eval import ler_monte_carlo
    from tpugnn.tanner import build_code
    from tpugnn.train.checkpoint import CheckpointManager
    from tpugnn.train.loop import init_state

    if args.mode == "bf16":
        lower_dots_at_bf16()
        # the converts survive XLA's simplifier: a product must now differ
        # from the f32 one exactly as the bf16-rounded operands' does
        a = jnp.asarray(np.random.default_rng(0).standard_normal((8, 128)), jnp.float32)
        q = lambda t: np.asarray(t.astype(jnp.bfloat16).astype(jnp.float32))
        if not np.allclose(np.asarray(jax.jit(jnp.dot)(a, a.T)), q(a) @ q(a).T,
                           rtol=1e-5, atol=1e-4):
            raise SystemExit("bf16 lowering of dot_general did not take effect")

    cfg = ExperimentConfig(
        code=CodeConfig(family=args.family, distance=args.distance),
        model=ModelConfig(hidden=args.hidden, msg_hidden=args.hidden,
                          rounds=args.rounds, backend="fused", qubit_head=args.head),
    )
    graph = build_code(cfg.code.family, cfg.code.distance)
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "ckpt")
        shutil.copytree(args.ckpt, copy)
        state, model = init_state(cfg, graph)
        mgr = CheckpointManager(copy)
        restored = mgr.restore_latest(state)
        mgr.close()
    if restored is None:
        raise SystemExit(f"no checkpoint in {args.ckpt}")
    t0 = time.perf_counter()
    ev = ler_monte_carlo(model.apply, restored.params, graph, p=args.p,
                         shots=args.shots, batch=args.batch,
                         key=jax.random.PRNGKey(args.seed))
    print(json.dumps({
        "mode": args.mode, "step": int(restored.step), "p": args.p,
        "shots": int(ev["shots"]), "seed": args.seed, "ler": ev["ler"],
        "ler_logical": ev["ler_logical"], "ler_hybrid": ev["ler_hybrid"],
        "seconds": round(time.perf_counter() - t0, 1),
        "jax": jax.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
