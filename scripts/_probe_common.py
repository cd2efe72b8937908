"""What the kernel probes (``k4_probe.py``, ``k5_probe.py``, ``wide_probe.py``) share: copies
of a kernel's source with text replaced, built with the flags of
``tpugnn_torch/kernels/_build.py`` into ``tpugnn_torch/_build/`` and loaded
in place of its library, and ``clock64()`` probes at stage boundaries.
Imports nothing of JAX."""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpugnn_torch", "kernels", "csrc")

# Prepended (after the includes) to a copy with probes: PROBE(k) adds the
# cycles since the previous probe to slot k, on thread 0 of block 0.
PROBE_DEFS = """
__device__ long long g_probe[16];
__device__ long long g_probe_last;
#define PROBE(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
    long long now = clock64(); g_probe[k] += now - g_probe_last; g_probe_last = now; } } while (0)
"""
PROBE_API = """
extern "C" int probe_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(long long) * 16);
}
extern "C" int probe_reset() {
  long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def replaced(src: str, pairs) -> str:
    """src with each (text, replacement) applied; each text must occur once."""
    for a, b in pairs:
        if src.count(a) != 1:
            raise RuntimeError(f"text not once in the source: {a!r}")
        src = src.replace(a, b)
    return src


def with_probes(src: str, probes, indent: str) -> str:
    """A copy of src with PROBE(k) after the k-th probe text and the probe
    API appended; probes: [(text, stage that ends there)]."""
    text = src.replace('#include "rounds_mma.cuh"\n', '#include "rounds_mma.cuh"\n' + PROBE_DEFS, 1)
    return replaced(text, [(a, a + f"{indent}PROBE({k});\n")
                           for k, (a, _) in enumerate(probes)]) + PROBE_API


def build_copies(library: str, texts: dict) -> tuple[dict, dict]:
    """Build copies of a library's source (name -> text), one nvcc each, all
    started together; returns them loaded (name -> library) and the
    compiler's log of each (name -> text)."""
    from tpugnn_torch.kernels import _build

    out_dir = os.path.join(REPO, "tpugnn_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        path = os.path.join(CSRC, f"_probe_{library}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib_path = os.path.join(out_dir, f"lib_probe_{library}_{name}.so")
        procs[name] = (path, lib_path, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib_path, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (path, lib_path, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        os.remove(path)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name][-3000:]}")
        lib = ctypes.CDLL(lib_path)
        for fn, (args, res) in _build._SIGNATURES[library].items():
            if not hasattr(lib, fn):   # an older source without this entry point
                continue
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = res
        libs[name] = lib
    return libs, logs


def kernel_resources(log: str, kernel: str) -> dict:
    """Registers and spill bytes from a ptxas -v log, per function whose
    name contains `kernel`."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            name = m.group(1)
        if name and kernel in name:
            s = re.search(r"(\d+) bytes spill stores", line)
            if s:
                out.setdefault(name, {})["spill_store_bytes"] = int(s.group(1))
            r = re.search(r"Used (\d+) registers", line)
            if r:
                out.setdefault(name, {})["registers"] = int(r.group(1))
    return out


def with_library(library: str, lib, fn):
    """fn() with `lib` loaded in place of the named library."""
    from tpugnn_torch.kernels import _build

    real = _build.load_library
    _build.load_library = lambda name: lib if name == library else real(name)
    try:
        return fn()
    finally:
        _build.load_library = real


def stage_cycles(lib, probes, fn) -> dict:
    """One run of fn() on a copy with probes: its ms and one block's cycles
    per stage, with each stage's share."""
    import torch

    import chip_smoke as cs

    lib.probe_read.argtypes = [ctypes.c_void_p]
    fn()
    torch.cuda.synchronize()
    lib.probe_reset()
    ms = cs.time_ms(fn, warmup=0, iters=1)
    cycles = (ctypes.c_longlong * 16)()
    lib.probe_read(ctypes.cast(cycles, ctypes.c_void_p))
    counts = {stage: int(cycles[k]) for k, (_, stage) in enumerate(probes)}
    del counts[probes[0][1]]   # the loop-top probe spans the gap since the previous launch
    total = sum(counts.values())
    return {"ms": ms, "cycles": counts, "share": {k: v / total for k, v in counts.items()}}
