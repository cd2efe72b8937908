"""Command-line interface (the port of ``tpugnn/cli.py``).

    python -m tpugnn_torch.cli train --family surface -d 3 -p 0.05 --steps 2000
    python -m tpugnn_torch.cli eval  --family surface -d 5 -p 0.03 --shots 100000 \
        --checkpoint-dir runs/d5
    python -m tpugnn_torch.cli sweep --family surface -d 3 -p 0.01 --ps 0.01 0.03
    python -m tpugnn_torch.cli eval --noise circuit --dt 5 -d 5 --backend pallas \
        --qubit-head bits -p 0.01 --shots 65536 --cleanup mwpm \
        --checkpoint-dir tpugnn_torch/assets/circuit_surface_d5_t5_h128_r8_ema24000.npz

Every flag of the JAX package's CLI, mapped onto the same config fields,
and the same JSON lines on stdout.  It runs on the card; ``--cpu`` runs the
plain PyTorch versions on the CPU instead.  ``--checkpoint-dir`` names a
directory of the port's own checkpoints (``tpugnn_torch.train.
CheckpointManager``), or a weights file (``.npz``) written by
``scripts/export_torch_weights.py``, whose model must be the one the flags
describe, on the graph they build; orbax directories of the JAX package are
not read.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig

__all__ = ["main", "build_config"]

# the model fields a weights file must share with the flags
_MODEL_FIELDS = ("hidden", "msg_hidden", "rounds", "aggr", "weight_tied", "readout",
                 "qubit_head", "update")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--family", default="surface",
                   choices=["surface", "toric", "repetition", "steane"])
    p.add_argument("-d", "--distance", type=int, default=3)
    p.add_argument("-p", "--error-rate", type=float, default=0.05)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--msg-hidden", type=int, default=128)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--backend", default="segment",
                   choices=["segment", "dense", "ell", "fused", "pallas"])
    p.add_argument("--aggr", default="sum", choices=["sum", "mean", "max"])
    p.add_argument("--per-round-weights", action="store_true")
    p.add_argument("--readout", default="both", choices=["per_qubit", "logical", "both"])
    p.add_argument("--qubit-head", default="bits", choices=["bits", "pauli4"])
    p.add_argument("--remat", action="store_true",
                   help="per-round activation rematerialization (large-d training)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ema", type=float, default=None, metavar="DECAY",
                   help="keep an EMA of the parameters with this decay (evaluated "
                        "beside the live ones)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--eval-shots", type=int, default=4096)
    p.add_argument("--checkpoint-dir", default=None,
                   help="a directory of the port's checkpoints, or a weights .npz")
    p.add_argument("--p-mix", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="per-shot training noise rate ~ Uniform[LO, HI]")
    p.add_argument("--dt", type=int, default=1,
                   help="syndrome-measurement rounds; >1 decodes a "
                        "spacetime detector graph (see --noise)")
    p.add_argument("--sector", default="z", choices=["z", "x"],
                   help="CSS sector of the --noise circuit detector graph")
    p.add_argument("--noise", default="phenomenological",
                   choices=["phenomenological", "circuit"],
                   help="spacetime noise model for --dt > 1: independent "
                        "data/measurement faults, or full circuit-level "
                        "faults (CNOT depolarizing, hooks; surface, toric, repetition)")
    p.add_argument("--meas-ratio", type=float, default=1.0,
                   help="measurement-fault rate relative to data-fault rate "
                        "(phenomenological noise only)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions of the kernels)")


def build_config(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        code=CodeConfig(family=args.family, distance=args.distance, p=args.error_rate),
        model=ModelConfig(
            hidden=args.hidden,
            msg_hidden=args.msg_hidden,
            rounds=args.rounds,
            backend=args.backend,
            aggr=args.aggr,
            weight_tied=not args.per_round_weights,
            readout=args.readout,
            qubit_head=args.qubit_head,
            remat=args.remat,
            dtype=args.dtype,
        ),
        train=TrainConfig(
            batch=args.batch,
            steps=args.steps,
            lr=args.lr,
            ema_decay=args.ema,
            seed=args.seed,
            eval_every=args.eval_every,
            eval_shots=args.eval_shots,
            checkpoint_dir=args.checkpoint_dir,
            p_mix=tuple(args.p_mix) if args.p_mix else None,
        ),
    )


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpugnn_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("train", "eval", "sweep", "serve"):
        sp = sub.add_parser(name)
        _add_common(sp)
        if name == "eval":
            sp.add_argument("--shots", type=int, default=100_000)
        if name == "sweep":
            sp.add_argument("--shots", type=int, default=20_000)
            sp.add_argument("--ps", type=float, nargs="+", default=[0.01, 0.03, 0.05, 0.08])
            sp.add_argument("--baseline", action="store_true",
                            help="also report union-find + exact-MWPM "
                                 "decoder LER per p")
        if name in ("eval", "sweep"):
            sp.add_argument("--cleanup", default=None,
                            choices=["uf", "mwpm", "best_of"],
                            help="also report the GNN+cleanup hybrid LER "
                                 "(per-qubit correction + classical repair "
                                 "of the residual syndrome; best_of = "
                                 "per-shot min-weight MAP over GNN/cleanup/"
                                 "MWPM candidates)")
            sp.add_argument("--tau", type=float, default=None,
                            help="confidence gate for --cleanup (keep GNN "
                                 "flips with posterior max-prob >= tau)")
        if name == "serve":
            sp.add_argument("--in", dest="infile", default=None,
                            help=".npy uint8 [B, m] syndromes (default: "
                                 "sample a demo batch at -p)")
            sp.add_argument("--out", dest="outfile", default=None,
                            help=".npy uint8 [B, n, 2] corrections "
                                 "(default: <in>.corrections.npy or stdout "
                                 "summary only)")
            sp.add_argument("--max-batch", type=int, default=4096)
            sp.add_argument("--cleanup", default=None,
                            choices=["uf", "mwpm", "best_of"],
                            help="serve the GNN+classical hybrid (classical "
                                 "repair of the residual syndrome; best_of "
                                 "= per-shot min-weight MAP over GNN/"
                                 "cleanup/MWPM candidates)")
            sp.add_argument("--tau", type=float, default=None,
                            help="confidence gate for --cleanup")
            sp.add_argument("--lazy", action="store_true",
                            help="best_of only: run the raw-MWPM matcher "
                                 "only on shots whose GNN correction is "
                                 "syndrome-inconsistent (approximate; see "
                                 "DecodeEngine docs)")
    return ap


def _graph(cfg: ExperimentConfig, args: argparse.Namespace):
    from tpugnn_torch.tanner import build_circuit_code, build_code, build_spacetime_code

    if args.dt > 1:
        if args.noise == "circuit":
            return build_circuit_code(cfg.code.family, cfg.code.distance, args.dt,
                                      sector=args.sector)
        return build_spacetime_code(cfg.code.family, cfg.code.distance, args.dt,
                                    meas_ratio=args.meas_ratio)
    return build_code(cfg.code.family, cfg.code.distance)


def _load_weights(model, graph, path: str) -> None:
    """The parameters of a weights file into ``model``, converted to its
    layout; raises where the file holds another model or names another
    graph than the flags."""
    from tpugnn_torch.models.convert import (convert_flat_layout, graph_of_meta, load_npz,
                                             read_meta, state_dict_from_flat)

    fcfg, flat, _ = load_npz(path)
    theirs = {k: getattr(fcfg.model, k) for k in _MODEL_FIELDS}
    ours = {k: getattr(model.cfg, k) for k in _MODEL_FIELDS}
    if theirs != ours:
        raise ValueError(f"{path} holds the model {theirs}; the flags describe {ours}")
    name = graph_of_meta(read_meta(path)).name
    if name != graph.name:
        raise ValueError(f"{path} was trained on the graph {name}; the flags build "
                         f"{graph.name}")
    flat = convert_flat_layout(flat, fcfg.model.backend, model.cfg.backend)
    model.load_state_dict(state_dict_from_flat(flat))


def _restored_model(cfg: ExperimentConfig, graph, dev, what: str):
    """The model of ``cfg`` on ``dev``: fresh from the seed, with the
    parameters of ``--checkpoint-dir`` where it holds any."""
    from tpugnn_torch.train import CheckpointManager, init_state

    model = init_state(cfg, graph, dev).model
    path = cfg.train.checkpoint_dir
    if path.endswith(".npz"):
        _load_weights(model, graph, path)
        return model
    restored = CheckpointManager(path).restore_latest()
    if restored is None:
        print(f"no checkpoint found; {what} fresh params", file=sys.stderr)
    else:
        model.load_state_dict(restored["model"])
    return model


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)

    import torch

    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.train import train as train_fn
    from tpugnn_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = build_config(args)
    seed = cfg.train.seed

    def gen(offset: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed + offset)

    if args.cmd == "train":
        _, _, _, history = train_fn(cfg, graph=_graph(cfg, args), device=dev)
        print(json.dumps(history[-1] if history else {}))
        return 0

    if args.cmd == "serve":
        import time

        import numpy as np

        from tpugnn_torch.serve import DecodeEngine

        graph = _graph(cfg, args)
        if cfg.train.checkpoint_dir:
            model = _restored_model(cfg, graph, dev, "serving")
        else:
            from tpugnn_torch.train import init_state

            model = init_state(cfg, graph, dev).model
        with DecodeEngine(cfg, model, graph, max_batch=args.max_batch, cleanup=args.cleanup,
                          cleanup_tau=args.tau, lazy=args.lazy, device=dev) as eng:
            if args.infile:
                syn = np.load(args.infile)
            else:
                from tpugnn_torch.sampling import sample_batch

                b = sample_batch(gen(0), graph.to(dev), cfg.code.p, args.max_batch)
                syn = b.syndrome[:, : graph.n_checks].to(torch.uint8).cpu().numpy()
            t0 = time.perf_counter()
            corr = eng.decode(syn)
            dt_s = time.perf_counter() - t0
        out = args.outfile or (f"{args.infile}.corrections.npy" if args.infile else None)
        if out:
            np.save(out, corr)
        print(json.dumps({
            "shots": int(syn.shape[0]),
            "decode_s": round(dt_s, 4),
            "shots_per_s": round(syn.shape[0] / dt_s, 1),
            "mean_correction_weight": float(corr.sum(axis=(1, 2)).mean()),
            **({"out": out} if out else {}),
        }))
        return 0

    if args.cmd in ("eval", "sweep"):
        graph = _graph(cfg, args)
        if cfg.train.checkpoint_dir:
            model = _restored_model(cfg, graph, dev, "evaluating")
        else:
            _, model, graph, _ = train_fn(cfg, graph=graph, device=dev)
        model.eval()
        ps = args.ps if args.cmd == "sweep" else [cfg.code.p]
        batch = min(args.shots, 4096)
        for p in ps:
            ev = ler_monte_carlo(model, graph, p=p, shots=args.shots, batch=batch,
                                 generator=gen(99), device=dev)
            row = {"family": cfg.code.family, "d": cfg.code.distance,
                   "p": p, **{k: ev[k] for k in ("ler", "ler_stderr", "shots")},
                   **({"ler_logical": ev["ler_logical"]} if "ler_logical" in ev else {})}
            if args.cleanup:
                from tpugnn_torch.eval.hybrid import ler_best_of, ler_gnn_cleanup

                if args.cleanup == "best_of":
                    hy = ler_best_of(model, graph, p=p, shots=args.shots, batch=batch,
                                     tau=args.tau, generator=gen(99), device=dev)
                else:
                    hy = ler_gnn_cleanup(model, graph, p=p, shots=args.shots, batch=batch,
                                         cleanup=args.cleanup, tau=args.tau,
                                         generator=gen(99), device=dev)
                row[f"gnn_{args.cleanup}_ler"] = hy["ler"]
            if getattr(args, "baseline", False):
                from tpugnn_torch.eval.baseline import ler_mwpm, ler_union_find

                row["uf_ler"] = ler_union_find(graph, p=p, shots=args.shots, batch=batch,
                                               generator=gen(7), device=dev)["ler"]
                row["mwpm_ler"] = ler_mwpm(graph, p=p, shots=args.shots, batch=batch,
                                           generator=gen(7), device=dev)["ler"]
            print(json.dumps(row))
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
