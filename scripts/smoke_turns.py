#!/usr/bin/env python3
"""chip_smoke.py from two checkouts in turns on one NVIDIA card, so that a
change's kernel times can be read against the spread of its parent's.

    python3 scripts/smoke_turns.py PARENT_DIR [CHANGE_DIR]

Runs ``chip_smoke.py`` from PARENT_DIR, CHANGE_DIR (default: this
checkout), CHANGE_DIR and PARENT_DIR, one after the other, each in its own
directory (so each builds its own kernels; the second run of a checkout
finds them built).  Each run's output and errors go to
``chiprun_out/smoke_turns/<n>_<label>.out`` / ``.err``.  Prints one JSON
line per run (its exit code, wall seconds and every ``*ms*`` number of each
row of its kernels line) and last one line with, for each kernel and
number, the values of each checkout in run order.  Stops, nonzero, at the
first run that exits nonzero.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out", "smoke_turns")
RUN_LIMIT_S = 1200      # chip_smoke.py's own limit


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_times(stdout: str) -> dict:
    """{kernel: {key: value}} of the ``*ms*`` numbers of the kernels line."""
    for line in stdout.splitlines():
        if line.startswith('{"kernels"'):
            return {k["name"]: {key: v for key, v in k.items()
                                if "ms" in key and isinstance(v, (int, float))}
                    for k in json.loads(line)["kernels"]}
    return {}


def smoke(checkout: str, label: str, n: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=checkout, capture_output=True,
                       text=True, timeout=RUN_LIMIT_S)
    for ext, text in (("out", p.stdout), ("err", p.stderr)):
        with open(os.path.join(OUT, f"{n}_{label}.{ext}"), "w") as f:
            f.write(text)
    return dict(run=n, label=label, rc=p.returncode,
                seconds=round(time.perf_counter() - t0, 1), kernels=kernel_times(p.stdout))


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"parent": os.path.abspath(argv[0]),
            "change": os.path.abspath(argv[1] if len(argv) == 2 else REPO)}
    for d in dirs.values():
        if not os.path.isfile(os.path.join(d, "chip_smoke.py")):
            raise SystemExit(f"no chip_smoke.py in {d}")
    os.makedirs(OUT, exist_ok=True)
    runs = []
    for n, label in enumerate(("parent", "change", "change", "parent")):
        runs.append(smoke(dirs[label], label, n))
        emit(runs[-1])
        if runs[-1]["rc"] != 0:
            return 1
    summary: dict = {}
    for r in runs:
        for name, times in r["kernels"].items():
            for key, v in times.items():
                summary.setdefault(name, {}).setdefault(key, {}).setdefault(
                    r["label"], []).append(v)
    emit({"turns": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
