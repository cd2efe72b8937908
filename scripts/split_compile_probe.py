#!/usr/bin/env python3
"""Whether ``nvcc --split-compile`` shortens the kernels' cold build
without changing their machine code, on the card's machine.

    python3 scripts/split_compile_probe.py

Builds every library of ``tpugnn_torch/kernels/_build.py`` cold twice, one
``nvcc`` per source, all started together as the build does: first with
``NVCC_FLAGS`` plus ``--split-compile=0`` (the compiler's optimization
passes on as many threads as there are cores), then with ``NVCC_FLAGS`` as
they are, each into a directory of its own under ``tpugnn_torch/_build/``.
Prints one JSON line per build (each library's seconds from the start, and
the wall), then one line per library: its functions in ``cuobjdump -sass``
and those whose SASS differs between the two builds (the translation
unit's anonymous-namespace tag masked).  Last it prints the card's name
and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ANON = re.compile(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+")


def build(flags, tag: str) -> tuple[dict, dict]:
    """Every library built cold with ``flags`` into ``_build/<tag>``;
    returns their paths and seconds."""
    from tpugnn_torch.kernels import _build

    out = os.path.join(_build.BUILD_DIR, tag)
    os.makedirs(out, exist_ok=True)
    nvcc, t0, procs = _build.nvcc_path(), time.perf_counter(), {}
    for name, src in _build.SOURCES.items():
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-o", lib, os.path.join(_build._CSRC, src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    seconds, running = {}, dict(procs)
    while running:
        for name, (_, proc) in list(running.items()):
            if proc.poll() is not None:
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name} ({tag})")
                seconds[name] = round(time.perf_counter() - t0, 1)
                del running[name]
        time.sleep(0.05)
    return {name: lib for name, (lib, _) in procs.items()}, seconds


def sass(lib: str) -> dict:
    """Each function's SASS lines, the anonymous-namespace tag masked."""
    from tpugnn_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    funcs, name = {}, None
    for line in subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        if "Function : " in line:
            name = ANON.sub("ANON", line.split("Function : ")[1].strip())
            funcs[name] = []
        elif name is not None:
            funcs[name].append(ANON.sub("ANON", line.strip()))
    return funcs


def main() -> int:
    from tpugnn_torch.kernels import _build

    split, t_split = build((*_build.NVCC_FLAGS, "--split-compile=0"), "split_compile")
    print(json.dumps({"split_compile": t_split, "wall": max(t_split.values())}), flush=True)
    as_is, t_as_is = build(_build.NVCC_FLAGS, "as_is")
    print(json.dumps({"as_is": t_as_is, "wall": max(t_as_is.values())}), flush=True)
    for name in _build.SOURCES:
        a, b = sass(as_is[name]), sass(split[name])
        differ = [f for f in a if a[f] != b.get(f)]
        print(json.dumps({"library": name, "functions": len(a),
                          "same_names": sorted(a) == sorted(b), "n_differ": len(differ),
                          "differ": differ}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
