#!/usr/bin/env python3
"""chip_smoke.py, or only its rounds-kernel timings, from two checkouts in
turns on one NVIDIA card, so that a change's kernel times can be read
against the spread of its parent's.

    python3 scripts/smoke_turns.py [--kernels] PARENT_DIR [CHANGE_DIR]

Runs PARENT_DIR, CHANGE_DIR (default: this checkout), CHANGE_DIR and
PARENT_DIR, one after the other, each in its own directory (so each builds
its own kernels; the second run of a checkout finds them built).

* Without ``--kernels``: ``chip_smoke.py`` of each checkout.  Each run's
  output and errors go to ``chiprun_out/smoke_turns/<n>_<label>.out`` /
  ``.err``.  Prints one JSON line per run (its exit code, wall seconds and
  every ``*ms*`` number of each row of its kernels line).  About 9 minutes.
* With ``--kernels``: this checkout's ``chip_smoke.rounds_kernel_times``
  in a process of its own on each checkout's ``tpugnn_torch`` (K1, K2a,
  K2b and K5 at d=11, B=4096; see its docstring).  Prints one JSON line per
  run with its times.  A few minutes.

Last it prints one line with, for each kernel and number, the values of
each run in run order (None where a checkout has no such number), and the
card's name and power limit.  Stops, nonzero, at the first run that exits
nonzero.  Imports nothing of JAX.
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
KERNELS_LIMIT_S = 600


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


def kernels_mode() -> dict:
    """The ``--time`` mode: rounds_kernel_times of this checkout's
    chip_smoke.py on the package of the working directory."""
    import importlib.util

    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.rounds_kernel_times()


def kernels(checkout: str, label: str, n: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--time"], cwd=checkout,
                       capture_output=True, text=True, timeout=KERNELS_LIMIT_S)
    run = dict(run=n, label=label, rc=p.returncode, seconds=round(time.perf_counter() - t0, 1))
    if p.returncode == 0:
        run["kernels"] = {"rounds": json.loads(p.stdout.strip().splitlines()[-1])}
    else:
        print(p.stderr[-4000:], file=sys.stderr)
    return run


def main(argv: list[str]) -> int:
    if argv == ["--time"]:
        emit(kernels_mode())
        return 0
    step, needs = smoke, "chip_smoke.py"
    if argv[:1] == ["--kernels"]:
        step, needs, argv = kernels, "tpugnn_torch", argv[1:]
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"parent": os.path.abspath(argv[0]),
            "change": os.path.abspath(argv[1] if len(argv) == 2 else REPO)}
    for d in dirs.values():
        if not os.path.exists(os.path.join(d, needs)):
            raise SystemExit(f"no {needs} in {d}")
    os.makedirs(OUT, exist_ok=True)
    runs = []
    for n, label in enumerate(("parent", "change", "change", "parent")):
        runs.append(step(dirs[label], label, n))
        emit(runs[-1])
        if runs[-1]["rc"] != 0:
            return 1
    summary: dict = {}
    for name in dict.fromkeys(k for r in runs for k in r["kernels"]):
        keys = dict.fromkeys(key for r in runs for key in r["kernels"].get(name, {}))
        summary[name] = {key: [r["kernels"].get(name, {}).get(key) for r in runs]
                         for key in keys if key != "build_seconds"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"order": [r["label"] for r in runs], "turns": summary,
          "device": smi.stdout.strip().splitlines()[0]})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
