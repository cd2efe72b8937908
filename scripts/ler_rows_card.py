#!/usr/bin/env python3
"""The d=11 checkpoint's p=0.02 and p=0.03 rows of benchmarks/LER_TABLE.md,
every column, through the port on one NVIDIA card; with ``--circuit``, the
circuit-level checkpoints' rows of benchmarks/LER_DETECTOR.md instead.

    python3 scripts/ler_rows_card.py [--shots 1000000] [--p 0.02 0.03]
    python3 scripts/ler_rows_card.py --circuit [--shots 1000000] [--p 0.01 0.02 0.03] \
        [--weights circuit_surface_d7_t7_h128_r8_ema2000.npz ...]

Runs ``tpugnn_torch.eval.hybrid.ler_all_columns`` of the trained d=11
weights (``v3_surface_d11/ema@40000``, f32, B=4096) with best-of (weight
rule), GNN+MWPM and the raw union-find and MWPM baselines, one seeded
generator per p, and holds each column against the table's row
(``LER_TABLE.md:28`` and ``:29``, 1e6 shots each, taken on a TPU): the
pooled two-sample z and whether it is within the 2-stderr criterion.  The
per-qubit head is held at |z| <= 4 to the JAX package's f32 rate at that p
(``per_qubit_reference`` in the weights file's sidecar, 131,072 shots; the
table's per-qubit rate is the TPU's one-bf16-pass GEMM rate), as
``chip_smoke.py`` holds it at p=0.05; the script exits 1 when it is off.
Prints one JSON line per row (columns, failures, z, picked candidates,
syndrome mismatches, the host's and the device's seconds), then the card's
name and power limit.  About 35 s a row on an H100 (245 forwards of 4096
shots; four host threads decode meanwhile).

``--circuit`` runs the five circuit weights files of ``tpugnn_torch/assets/``
(``circuit_surface_*``: d=3 and d=5 in both sectors, d=7, H=128, R=8,
bits, f32; the detector graph each record names) at p=0.01, 0.02 and 0.03
with the NLL rule, as the table's ``[nll]`` rows were taken, against those
rows (``CIRCUIT_TABLE``, 1e6 shots each, taken on a TPU).  At p=0.01, the
rate of the JAX references, the logical and per-qubit heads are held at
|z| <= 4 to the JAX f32 rates in the weights file and every GNN column to
the JAX f32 columns of its sidecar; the script exits 1 when one is off.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# benchmarks/LER_TABLE.md:28-29, v3_surface_d11/ema@40000, 1e6 shots
TABLE = {
    0.02: {"line": 28, "ler_hybrid": 1.594e-05, "gnn_uf": 2.989e-06, "gnn_mwpm": 2.989e-06,
           "gnn_best_of": 9.965e-07, "ler_logical": 1.694e-05, "ler": 0.1608,
           "uf": 1.893e-05, "mwpm": 9.965e-06},
    0.03: {"line": 29, "ler_hybrid": 0.0001465, "gnn_uf": 5.879e-05, "gnn_mwpm": 5.68e-05,
           "gnn_best_of": 3.687e-05, "ler_logical": 0.0001505, "ler": 0.2526,
           "uf": 0.0001794, "mwpm": 0.0001036},
}
TABLE_SHOTS = 1_000_000
QUBIT_Z = 4      # the per-qubit head's gate against the JAX f32 rate

# benchmarks/LER_DETECTOR.md's [nll] rows of the circuit checkpoints (1e6
# shots each): weights file -> p -> the line and its columns
_COLS = ("ler_hybrid", "gnn_uf", "gnn_mwpm", "gnn_best_of", "ler_logical", "ler", "uf", "mwpm")
_ROWS = {
    "circuit_surface_d3_t3_h128_r8_ema24000.npz": (
        (17, 0.01, (0.02973, 0.03207, 0.03013, 0.03022, 0.02974, 0.1187, 0.03958, 0.02998)),
        (19, 0.02, (0.09598, 0.1023, 0.09738, 0.09741, 0.09598, 0.2734, 0.1198, 0.09644)),
        (21, 0.03, (0.1726, 0.1821, 0.1755, 0.175, 0.1726, 0.4196, 0.2055, 0.1734))),
    "circuit_surface_d5_t5_h128_r8_ema24000.npz": (
        (35, 0.01, (0.0578, 0.07201, 0.06551, 0.05753, 0.05781, 0.6043, 0.1215, 0.05593)),
        (37, 0.02, (0.2399, 0.2662, 0.2484, 0.2361, 0.2399, 0.9063, 0.3341, 0.2334)),
        (39, 0.03, (0.3924, 0.4078, 0.3931, 0.3867, 0.3925, 0.9815, 0.4445, 0.3841))),
    "circuit_surface_d3_t3_x_h128_r8_ema6000.npz": (
        (7, 0.01, (0.02912, 0.03089, 0.03022, 0.03025, 0.02909, 0.09584, 0.03875, 0.03014)),
        (8, 0.02, (0.09438, 0.09912, 0.09743, 0.0975, 0.09429, 0.2538, 0.1181, 0.09679)),
        (9, 0.03, (0.1711, 0.1779, 0.1755, 0.1756, 0.1709, 0.4095, 0.2029, 0.1743))),
    "circuit_surface_d5_t5_x_h128_r8_ema8000.npz": (
        (25, 0.01, (0.05938, 0.07549, 0.0703, 0.05799, 0.05941, 0.6394, 0.1169, 0.05613)),
        (26, 0.02, (0.244, 0.2678, 0.254, 0.2369, 0.2441, 0.9154, 0.329, 0.2336)),
        (27, 0.03, (0.3976, 0.4086, 0.3977, 0.3888, 0.3976, 0.9832, 0.4421, 0.3859))),
    "circuit_surface_d7_t7_h128_r8_ema2000.npz": (
        (43, 0.01, (0.4253, 0.1584, 0.1435, 0.09086, 0.4253, 0.9624, 0.2235, 0.08001)),
        (44, 0.02, (0.4902, 0.4334, 0.42, 0.3797, 0.4902, 0.9998, 0.4653, 0.3647)),
        (45, 0.03, (0.4996, 0.4938, 0.4919, 0.4862, 0.4996, 1.0, 0.4969, 0.4814))),
}
CIRCUIT_TABLE = {f: {p: {"line": line, **dict(zip(_COLS, vals))} for line, p, vals in rows}
                 for f, rows in _ROWS.items()}
COLUMN_Z = 4     # the circuit rows' gate at p=0.01 against the JAX f32 references


def z_score(rate: float, n: int, ref: float, ref_n: int) -> float:
    """Two-sample z of a binomial rate against the reference, pooled (0 when
    both rates are 0)."""
    pool = (rate * n + ref * ref_n) / (n + ref_n)
    se = (pool * (1 - pool) * (1 / n + 1 / ref_n)) ** 0.5
    return 0.0 if se == 0 else (rate - ref) / se


def run_row(model, graph, p: float, ref: dict, args, select_cost: str, seed: int,
            table: str) -> dict:
    """``ler_all_columns`` at ``p`` on ``args.shots`` shots with best-of
    (``select_cost``), GNN+MWPM and the raw baselines, held against the
    table's row ``ref`` (its line in ``table``)."""
    import torch

    from tpugnn_torch.eval.hybrid import ler_all_columns

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cols = ler_all_columns(model, graph, p=p, shots=args.shots, batch=args.batch,
                           generator=gen, best_of=True, with_mwpm=True, with_uf_raw=True,
                           select_cost=select_cost, device="cuda")
    n = int(cols["shots"])
    keys = [k for k in ref if k != "line"]
    z = {k: z_score(cols[k], n, ref[k], TABLE_SHOTS) for k in keys}
    return dict(p=p, shots=n, batch=args.batch, seed=seed, select_cost=select_cost,
                table_line=f"{table}:{ref['line']}", columns={k: cols[k] for k in keys},
                failures={k: round(cols[k] * n) for k in keys},
                table={k: ref[k] for k in keys}, z_vs_table=z,
                within_2_stderr_of_table={k: abs(v) <= 2 for k, v in z.items()},
                picked=cols["picked"], syn_mismatch=cols["syn_mismatch"],
                timing=cols["timing"], seconds=time.perf_counter() - t0)


def d11_rows(args) -> list:
    """The d=11 rows; returns the p at which the per-qubit head is off."""
    from tpugnn_torch.models.convert import load_decoder, read_columns, read_meta

    meta = read_meta()
    jax_qubit = {r["p"]: r for r in read_columns()["per_qubit_reference"]["rows"]}
    off = []
    _, model, graph = load_decoder(device="cuda")
    for p in args.p:
        row = run_row(model, graph, p, TABLE[p], args, "weight", 2000 + round(p * 100),
                      "benchmarks/LER_TABLE.md")
        row.update(step=meta["step"], source=meta["source"])
        jq = jax_qubit[p]
        row["qubit_jax_f32"] = dict(shots=jq["shots"], seed=jq["seed"], ler=jq["ler"],
                                    z=z_score(row["columns"]["ler"], row["shots"], jq["ler"],
                                              jq["shots"]),
                                    gate=QUBIT_Z)
        if abs(row["qubit_jax_f32"]["z"]) > QUBIT_Z:
            off.append(p)
        print(json.dumps(row), flush=True)
    return off


def circuit_rows(args) -> list:
    """The circuit checkpoints' rows; returns (weights file, p, column) of
    every column off its JAX f32 reference at p=0.01."""
    import torch

    from tpugnn_torch.models.convert import load_decoder, read_columns, read_meta

    off = []
    for i, (fname, rows) in enumerate(CIRCUIT_TABLE.items()):
        if args.weights and fname not in args.weights:
            continue
        path = os.path.join(REPO, "tpugnn_torch", "assets", fname)
        meta, side = read_meta(path), read_columns(path)
        _, model, graph = load_decoder(path, device="cuda")
        for p in args.p:
            row = run_row(model, graph, p, rows[p], args, "nll", 5000 + 10 * i + round(p * 100),
                          "benchmarks/LER_DETECTOR.md")
            row.update(weights=fname, graph=graph.name, step=meta["step"],
                       source=meta["source"])
            if p == meta["ler_reference"]["p"] == side["p"]:
                ref = meta["ler_reference"]
                jax = {k: (ref[k], ref["shots"]) for k in ("ler", "ler_logical")}
                jax.update({k: (v, side["shots"]) for k, v in side["columns"].items()
                            if k not in jax})
                row["z_vs_jax_f32"] = z = {
                    k: z_score(row["columns"][k], row["shots"], r, rn)
                    for k, (r, rn) in jax.items()}
                off += [(fname, p, k) for k, v in z.items() if abs(v) > COLUMN_Z]
            print(json.dumps(row), flush=True)
        del model
        torch.cuda.empty_cache()
    return off


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shots", type=int, default=1_000_000)
    ap.add_argument("--p", type=float, nargs="+", default=None,
                    help="default: 0.02 0.03, with --circuit 0.01 0.02 0.03")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--circuit", action="store_true",
                    help="the circuit checkpoints' rows of benchmarks/LER_DETECTOR.md")
    ap.add_argument("--weights", nargs="+", default=None, choices=sorted(CIRCUIT_TABLE),
                    help="with --circuit, these weights files only (default: all five)")
    args = ap.parse_args(argv)
    if args.p is None:
        args.p = [0.01, 0.02, 0.03] if args.circuit else [0.02, 0.03]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: ler_rows_card.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    off = circuit_rows(args) if args.circuit else d11_rows(args)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    if off:
        print(f"off the JAX f32 references: {off}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
