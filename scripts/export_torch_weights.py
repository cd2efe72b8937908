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

A detector-graph checkpoint (the phenomenological spacetime graph of
``--d-t`` noisy rounds of the z sector, measurement faults at the data
rate) takes ``--noise phenomenological``, and ``--t0-scale`` the round-0
fault boost it was trained with (``benchmarks/train_quality_circuit.py
--t0-scale``); the weights file's record then names the graph (``graph``:
``d_t``, ``sector``, ``meas_ratio``, ``t0_scale``), and ``load_decoder``
builds it.  Its columns run on that graph (at p=0.02, 131,072 shots, about
7 minutes):

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py \
        --ckpt runs/spacetime_surface_d5_t5 --distance 5 --hidden 96 --rounds 8 \
        --head bits --noise phenomenological --d-t 5 --ler-p 0.02 \
        --columns-shots 131072 --ler-seed 0 \
        --out tpugnn_torch/assets/spacetime_surface_d5_t5_h96_r8_4000.npz

A circuit-level checkpoint (``benchmarks/train_quality_circuit.py``: the
detector graph of ``--d-t`` rounds of one sector under circuit-level noise,
``tpugnn.tanner.circuit``) takes ``--noise circuit`` and ``--sector z|x``;
the record then names that graph (``graph``: ``kind`` ``'circuit'``,
``d_t``, ``sector``).  Its columns are taken with ``--select-cost nll``, as
``benchmarks/LER_DETECTOR.md``'s ``[nll]`` rows were (about 2 minutes at
d=3, 10 at d=5 and 60 at d=7 for 131,072 shots of both references):

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py \
        --ckpt runs/circuit_surface_d5_t5_h128c/ema --distance 5 --hidden 128 \
        --rounds 8 --head bits --noise circuit --d-t 5 --sector z --ler-p 0.01 \
        --ler-shots 131072 --columns-shots 131072 --select-cost nll --ler-seed 0 \
        --out tpugnn_torch/assets/circuit_surface_d5_t5_h128_r8_ema24000.npz

With ``--stream-shots N`` it decodes ``tpugnn.streaming.stream_ler``'s
streams (numpy ``default_rng``, so the port draws the same ones) at the
settings of ``runs/stream_quality_w.json``'s rows (``STREAM``: window
``--d-t``, commit 1, 11 rounds, p=0.02, seed 11, batch 256) with the five
window decoders of ``benchmarks/stream_quality.py`` (the GNN raw with
deferral, with union-find cleanup and with the device repair; union-find in
windows and over the whole stream) and writes their rates and settings
under ``stream`` in the sidecar (10,000 shots take about 5 minutes):

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py \
        --ckpt runs/spacetime_surface_d5_t5_w --distance 5 --hidden 96 --rounds 8 \
        --head bits --noise phenomenological --d-t 5 --t0-scale 2 --stream-shots 10000 \
        --out tpugnn_torch/assets/spacetime_surface_d5_t5_w_h96_r8_4000.npz

With ``--qubit-ps P ...`` it adds the JAX f32 ``ler_monte_carlo`` rates of
the restored decoder at each p (131,072 shots each) to the sidecar under
``per_qubit_reference``, leaving its other entries as they are.  The
sidecar is updated, never replaced, by every option that writes to it.

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

# the settings of the streams (runs/stream_quality_w.json's rows; the window
# is --d-t) and the shots of each --qubit-ps rate
STREAM = dict(p=0.02, commit=1, rounds=11, seed=11, batch=256)
QUBIT_SHOTS = 131072


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
    ap.add_argument("--ler-batch", type=int, default=2048,
                    help="batch of the reference LER and of --qubit-ps")
    ap.add_argument("--columns-shots", type=int, default=0,
                    help="shots of the JAX f32 hybrid columns (0: none)")
    ap.add_argument("--columns-batch", type=int, default=2048)
    ap.add_argument("--columns-only", action="store_true",
                    help="write the columns sidecar and not the weights file")
    ap.add_argument("--noise", default="code",
                    choices=("code", "phenomenological", "circuit"),
                    help="code: the code graph; phenomenological: the spacetime "
                         "detector graph of --d-t rounds; circuit: the circuit-level "
                         "detector graph of --d-t rounds of --sector")
    ap.add_argument("--d-t", type=int, default=1)
    ap.add_argument("--sector", default="z", choices=("z", "x"),
                    help="CSS sector of the circuit-level detector graph")
    ap.add_argument("--select-cost", default="weight", choices=("weight", "nll"),
                    help="best-of selection rule of the columns")
    ap.add_argument("--t0-scale", type=float, default=1.0,
                    help="round-0 data-fault rate of the detector graph, in units of p")
    ap.add_argument("--stream-shots", type=int, default=0,
                    help="shots of the JAX f32 streaming rates (0: none)")
    ap.add_argument("--qubit-ps", type=float, nargs="*", default=[],
                    help="p values of the JAX f32 ler_monte_carlo rates for the sidecar")
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
    graph_meta = None
    if args.noise == "phenomenological":
        from tpugnn.tanner.spacetime import build_spacetime_code

        graph = build_spacetime_code(args.family, args.distance, args.d_t,
                                     t0_scale=args.t0_scale)
        graph_meta = {"kind": "spacetime", "d_t": args.d_t, "sector": "z",
                      "meas_ratio": 1.0, "t0_scale": args.t0_scale}
    elif args.noise == "circuit":
        from tpugnn.tanner.circuit import build_circuit_code

        graph = build_circuit_code(args.family, args.distance, args.d_t,
                                   sector=args.sector)
        graph_meta = {"kind": "circuit", "d_t": args.d_t, "sector": args.sector}
    else:
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
    if graph_meta is not None:
        meta["graph"] = graph_meta
    if args.ler_shots:
        from tpugnn.eval import ler_monte_carlo

        ev = ler_monte_carlo(model.apply, restored.params, graph, p=args.ler_p,
                             shots=args.ler_shots, batch=args.ler_batch,
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
    if args.qubit_ps:
        write_qubit_rates(args, model, restored.params, graph, meta)
    if args.stream_shots:
        write_stream(args, model, restored.params, meta)
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
                           with_mwpm=True, with_uf_raw=True, select_cost=args.select_cost)
    out = {"p": args.ler_p, "shots": int(cols["shots"]),
           "seed": args.ler_seed, "batch": args.columns_batch,
           "select_cost": args.select_cost,
           "columns": {k: cols[k] for k in ("ler", "ler_logical", "ler_hybrid", "gnn_uf",
                                            "gnn_mwpm", "gnn_best_of", "uf", "mwpm")},
           "picked": cols["picked"],
           "function": "tpugnn.eval.hybrid.ler_all_columns, GNNDecoder(backend='fused') "
                       f"float32, JAX {jax.__version__} on {jax.default_backend()}",
           "seconds": round(time.perf_counter() - t0, 1)}
    update_sidecar(args.out, meta, out)
    print(f"columns: {out['columns']}")


def update_sidecar(out_path: str, meta: dict, updates: dict) -> None:
    """Merge ``updates`` and the weights' identity (step, source, code,
    model, graph) into the sidecar of ``out_path``, keeping its other
    entries."""
    from tpugnn_torch.models.convert import columns_path

    path = columns_path(out_path)
    side = {}
    if os.path.exists(path):
        with open(path) as f:
            side = json.load(f)
    side.update({k: meta[k] for k in ("step", "source", "code", "model", "graph")
                 if k in meta})
    side.update(updates)
    with open(path, "w") as f:
        json.dump(side, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"updated {path}: {sorted(updates)}")


def write_qubit_rates(args, model, params, graph, meta) -> None:
    """The JAX package's f32 ``ler_monte_carlo`` rates (per-qubit, logical
    and hybrid heads) of the restored decoder at each of ``--qubit-ps``."""
    import time

    import jax
    from tpugnn.eval import ler_monte_carlo

    rows = []
    for p in args.qubit_ps:
        t0 = time.perf_counter()
        ev = ler_monte_carlo(model.apply, params, graph, p=p, shots=QUBIT_SHOTS,
                             batch=args.ler_batch, key=jax.random.PRNGKey(args.ler_seed))
        rows.append({"p": p, "shots": int(ev["shots"]), "seed": args.ler_seed,
                     "ler": ev["ler"], "ler_logical": ev["ler_logical"],
                     "ler_hybrid": ev["ler_hybrid"],
                     "seconds": round(time.perf_counter() - t0, 1)})
        print(f"p={p}: {rows[-1]}", flush=True)
    update_sidecar(args.out, meta, {"per_qubit_reference": {
        "rows": rows,
        "function": "tpugnn.eval.ler_monte_carlo, GNNDecoder(backend='fused') float32, "
                    f"JAX {jax.__version__} on {jax.default_backend()}"}})


def write_stream(args, model, params, meta) -> None:
    """``stream_ler`` of the five window decoders of
    ``benchmarks/stream_quality.py`` on the same numpy streams."""
    import time

    import jax
    from tpugnn.streaming import SlidingWindowDecoder, stream_ler

    fam, d, w, c = args.family, args.distance, args.d_t, STREAM["commit"]
    total = STREAM["rounds"]
    gnn = dict(window=w, commit=c, apply_fn=model.apply, params=params)
    decoders = {
        "gnn_stream": lambda: SlidingWindowDecoder.from_gnn(fam, d, **gnn),
        "gnn_uf_stream": lambda: SlidingWindowDecoder.from_gnn_cleanup(fam, d, **gnn),
        "gnn_dev_stream": lambda: SlidingWindowDecoder.from_gnn_device(fam, d, **gnn),
        "uf_stream": lambda: SlidingWindowDecoder.from_union_find(fam, d, window=w, commit=c),
        "uf_monolithic": lambda: SlidingWindowDecoder.from_union_find(
            fam, d, window=total, commit=total),
    }
    rates, seconds = {}, {}
    for name, make in decoders.items():
        t0 = time.perf_counter()
        r = stream_ler(make(), p=STREAM["p"], rounds=total, shots=args.stream_shots,
                       seed=STREAM["seed"], batch=STREAM["batch"])
        rates[name] = r["ler"]
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"{name}: {r}", flush=True)
    update_sidecar(args.out, meta, {"stream": {
        **STREAM, "window": w, "shots": args.stream_shots, "rates": rates, "seconds": seconds,
        "function": "tpugnn.streaming.stream_ler, SlidingWindowDecoder adapters of "
                    "benchmarks/stream_quality.py, GNNDecoder(backend='fused') float32, "
                    f"JAX {jax.__version__} on {jax.default_backend()}"}})


if __name__ == "__main__":
    sys.exit(main())
