#!/usr/bin/env python3
"""The d=11 checkpoint's p=0.02 and p=0.03 rows of benchmarks/LER_TABLE.md,
every column, through the port on one NVIDIA card.

    python3 scripts/ler_rows_card.py [--shots 1000000] [--p 0.02 0.03]

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
shots; four host threads decode meanwhile).  Imports nothing of JAX.
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


def z_score(rate: float, n: int, ref: float, ref_n: int) -> float:
    """Two-sample z of a binomial rate against the reference, pooled (0 when
    both rates are 0)."""
    pool = (rate * n + ref * ref_n) / (n + ref_n)
    se = (pool * (1 - pool) * (1 / n + 1 / ref_n)) ** 0.5
    return 0.0 if se == 0 else (rate - ref) / se


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shots", type=int, default=1_000_000)
    ap.add_argument("--p", type=float, nargs="+", default=[0.02, 0.03])
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: ler_rows_card.py runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpugnn_torch.eval.hybrid import ler_all_columns
    from tpugnn_torch.models.convert import load_decoder, read_columns, read_meta

    meta = read_meta()
    jax_qubit = {r["p"]: r for r in read_columns()["per_qubit_reference"]["rows"]}
    off = []
    _, model, graph = load_decoder(device="cuda")
    for p in args.p:
        ref = TABLE[p]
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(2000 + round(p * 100))
        cols = ler_all_columns(model, graph, p=p, shots=args.shots, batch=args.batch,
                               generator=gen, best_of=True, with_mwpm=True, with_uf_raw=True,
                               device="cuda")
        n = int(cols["shots"])
        keys = [k for k in ref if k != "line"]
        z = {k: z_score(cols[k], n, ref[k], TABLE_SHOTS) for k in keys}
        row = dict(p=p, step=meta["step"], source=meta["source"], shots=n, batch=args.batch,
                   seed=gen.initial_seed(), table_line=f"benchmarks/LER_TABLE.md:{ref['line']}",
                   columns={k: cols[k] for k in keys},
                   failures={k: round(cols[k] * n) for k in keys},
                   table={k: ref[k] for k in keys}, z_vs_table=z,
                   within_2_stderr_of_table={k: abs(v) <= 2 for k, v in z.items()},
                   picked=cols["picked"], syn_mismatch=cols["syn_mismatch"],
                   timing=cols["timing"], seconds=time.perf_counter() - t0)
        jq = jax_qubit[p]
        row["qubit_jax_f32"] = dict(shots=jq["shots"], seed=jq["seed"], ler=jq["ler"],
                                    z=z_score(cols["ler"], n, jq["ler"], jq["shots"]),
                                    gate=QUBIT_Z)
        if abs(row["qubit_jax_f32"]["z"]) > QUBIT_Z:
            off.append(p)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    if off:
        print(f"the per-qubit head is off its JAX f32 rate at p={off}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
