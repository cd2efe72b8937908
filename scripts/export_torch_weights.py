"""Export a trained flax checkpoint to the PyTorch port's weights file.

Restores the newest step of an orbax checkpoint directory (from a temporary
copy, so the checkpoint manager never touches the original) and writes its
flax parameter tree, flattened to '/'-joined keys, to an .npz with a
``__meta__`` JSON record of the step and the config.  The port reads the file
with NumPy alone (``tpugnn_torch.models.convert.load_npz``).

With ``--ler-shots N`` it also measures the Monte-Carlo LER of the restored
decoder with the JAX package itself (``GNNDecoder(backend='fused')``, f32, on
the CPU, ``tpugnn.eval.ler_monte_carlo``) and records it under
``ler_reference``: the value of the reference function at the port's
precision, which ``chip_smoke.py`` holds the port's LER on the card against.

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py \
        --ckpt runs/v3_surface_d11/ema --distance 11 --hidden 128 --rounds 14 \
        --head pauli4 --ler-p 0.05 --ler-shots 131072 --ler-seed 0 \
        --out tpugnn_torch/assets/surface_d11_h128_r14_ema40000.npz

With ``--columns-shots N`` it runs the JAX package's hybrid evaluator
``tpugnn.eval.hybrid.ler_all_columns`` (f32, on the CPU, best-of with the
weight rule, GNN+MWPM and the raw union-find and MWPM baselines) and writes
its columns to a sidecar JSON beside the weights file
(``<out without .npz>.columns.json``), with the step and config they belong
to; ``--columns-only`` writes the sidecar alone and leaves the weights file
as it is.  ``chip_smoke.py`` holds the port's hybrid columns on the card
against it.  131,072 shots take about 12 minutes at d=11:

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py \
        --ckpt runs/v3_surface_d11/ema --distance 11 --hidden 128 --rounds 14 \
        --head pauli4 --ler-p 0.05 --columns-shots 131072 --ler-seed 0 \
        --columns-only --out tpugnn_torch/assets/surface_d11_h128_r14_ema40000.npz

This script imports JAX and ``tpugnn``; nothing in ``tpugnn_torch`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="orbax checkpoint directory")
    ap.add_argument("--family", default="surface")
    ap.add_argument("--distance", type=int, required=True)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--head", default="pauli4", choices=("bits", "pauli4"))
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--ler-p", type=float, default=0.05)
    ap.add_argument("--ler-shots", type=int, default=0,
                    help="shots of the JAX f32 reference LER (0: none)")
    ap.add_argument("--ler-seed", type=int, default=0)
    ap.add_argument("--columns-shots", type=int, default=0,
                    help="shots of the JAX f32 hybrid columns (0: none)")
    ap.add_argument("--columns-batch", type=int, default=2048)
    ap.add_argument("--columns-only", action="store_true",
                    help="write the columns sidecar and not the weights file")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tpugnn.configs import CodeConfig, ExperimentConfig, ModelConfig
    from tpugnn.tanner import build_code
    from tpugnn.train.checkpoint import CheckpointManager
    from tpugnn.train.loop import init_state

    cfg = ExperimentConfig(
        code=CodeConfig(family=args.family, distance=args.distance),
        model=ModelConfig(hidden=args.hidden, msg_hidden=args.hidden,
                          rounds=args.rounds, backend="fused",
                          qubit_head=args.head, dtype=args.dtype),
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
    step = int(restored.step)

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored.params)[0]:
        key = "/".join(str(p.key) for p in path)
        flat[key] = np.asarray(leaf, np.float32)
    model_cfg = dataclasses.asdict(cfg.model)
    model_cfg.pop("remat", None)    # a training option the port does not have
    code = dataclasses.asdict(cfg.code)
    meta = {"step": step, "source": os.path.normpath(args.ckpt),
            "code": code, "model": model_cfg}
    if args.ler_shots:
        from tpugnn.eval import ler_monte_carlo

        ev = ler_monte_carlo(model.apply, restored.params, graph, p=args.ler_p,
                             shots=args.ler_shots, batch=2048,
                             key=jax.random.PRNGKey(args.ler_seed))
        meta["ler_reference"] = {
            "p": args.ler_p, "shots": int(ev["shots"]), "seed": args.ler_seed,
            "ler": ev["ler"], "ler_logical": ev["ler_logical"],
            "ler_hybrid": ev["ler_hybrid"],
            "function": "tpugnn GNNDecoder(backend='fused') float32, "
                        f"JAX {jax.__version__} on {jax.default_backend()}",
        }
        print(f"reference LER at p={args.ler_p}: {meta['ler_reference']}")
    if args.columns_shots:
        write_columns(args, model, restored.params, graph, meta)
    if args.columns_only:
        return 0
    np.savez(args.out, __meta__=np.array(json.dumps(meta, sort_keys=True)), **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: step {step}, {len(flat)} arrays, {n} parameters")
    return 0


def write_columns(args, model, params, graph, meta) -> None:
    """Run the JAX package's ``ler_all_columns`` on the restored decoder and
    write its columns, with the weights' step and config, to the sidecar."""
    import time

    import jax
    from tpugnn.eval.hybrid import ler_all_columns
    from tpugnn_torch.models.convert import columns_path

    t0 = time.perf_counter()
    cols = ler_all_columns(model.apply, params, graph, p=args.ler_p,
                           shots=args.columns_shots, batch=args.columns_batch,
                           key=jax.random.PRNGKey(args.ler_seed), best_of=True,
                           with_mwpm=True, with_uf_raw=True, select_cost="weight")
    out = {"step": meta["step"], "source": meta["source"], "code": meta["code"],
           "model": meta["model"], "p": args.ler_p, "shots": int(cols["shots"]),
           "seed": args.ler_seed, "batch": args.columns_batch,
           "select_cost": "weight",
           "columns": {k: cols[k] for k in ("ler", "ler_logical", "ler_hybrid", "gnn_uf",
                                            "gnn_mwpm", "gnn_best_of", "uf", "mwpm")},
           "picked": cols["picked"],
           "function": "tpugnn.eval.hybrid.ler_all_columns, GNNDecoder(backend='fused') "
                       f"float32, JAX {jax.__version__} on {jax.default_backend()}",
           "seconds": round(time.perf_counter() - t0, 1)}
    path = columns_path(args.out)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}: {out['columns']}")


if __name__ == "__main__":
    sys.exit(main())
