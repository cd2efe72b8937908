"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library -> ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so a
cold build takes seconds.  Each source becomes its own library in
``tpugnn_torch/_build/`` (ignored by git), named by a hash of the source, the
headers the rounds sources share, the flags and the compiler's version
line.  The ``nvcc``
processes of a build all start together, under a file lock so that
concurrent processes build a library once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["BUILD_DIR", "HEADERS", "NVCC_FLAGS", "SOURCES", "build_libraries", "load_library",
           "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# library name -> source: wide_rounds (bf16 states) and wide_rounds_tf32 (f32)
# hold K1, K2a and, above 128 columns, K5; wide_backward and
# wide_backward_tf32 K2b; the 128-column K5 builds in two libraries, bf16
# and f32 states; each its own nvcc run, all in parallel
SOURCES = {"spmm": "spmm.cu", "sddmm": "sddmm.cu", "roll_gather": "roll_gather.cu",
           "roll_gather_tf32": "roll_gather_tf32.cu", "wide_rounds": "wide_rounds.cu",
           "wide_rounds_tf32": "wide_rounds_tf32.cu", "wide_backward": "wide_backward.cu",
           "wide_backward_tf32": "wide_backward_tf32.cu"}
HEADERS = ("rounds_common.cuh", "rounds_mma.cuh", "roll_gather_api.cuh", "wide_mma.cuh",
           "wide_rounds.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# K5's two libraries (bf16 and f32 states) share these entry points
# (csrc/roll_gather_api.cuh); each has its global-panel variant's own
_ROLL = {
    "roll_rounds_smem_bytes": ([_I] * 2, ctypes.c_longlong),
    "roll_rounds_launch": ([_I] * 2 + [_P] * 10 + [_I] * 5 + [_P, _I, _P], _I),
}
# the rounds kernels' forward and backward libraries, each in both state types
# (csrc/wide_rounds.cuh)
_WIDE_FORWARD = {
    "wide_rounds_launch": ([_I] + [_P] * 13 + [_I] * 8 + [_P], _I),
    "wide_roll_launch": ([_I] * 2 + [_P] * 12 + [_I] * 5 + [_P], _I),
}
_WIDE_BACKWARD = {
    "wide_rounds_bwd_scratch_bytes": ([_I] * 7, ctypes.c_longlong),
    "wide_rounds_bwd_segments": ([], _I),
    "wide_rounds_bwd_launch": ([_I] + [_P] * 28 + [_I] * 10 + [_P], _I),
}
# C entry points per library: name -> (argument types, result type)
_SIGNATURES = {
    "spmm": {
        "ell_aggregate_launch": ([_I, _I] + [_P] * 3 + [_I] * 5 + [_P], _I),
    },
    "sddmm": {
        "sddmm_smem_bytes": ([_I] * 4, ctypes.c_longlong),
        "sddmm_edge_hidden_launch": ([_I] + [_P] * 7 + [_I] * 6 + [_P], _I),
        "sddmm_tc_smem_bytes": ([_I] * 3, ctypes.c_longlong),
        "sddmm_edge_hidden_tc_launch": ([_P] * 7 + [_I] * 6 + [_P], _I),
    },
    "roll_gather": {
        **_ROLL,
        "roll_rounds_tc_gpanels_smem_bytes": ([_I], ctypes.c_longlong),
        "roll_rounds_tc_gpanels_launch": ([_I] + [_P] * 11 + [_I] * 5 + [_P], _I),
    },
    "roll_gather_tf32": {
        **_ROLL,
        "roll_rounds_gpanels_smem_bytes": ([_I], ctypes.c_longlong),
        "roll_rounds_gpanels_launch": ([_P] * 11 + [_I] * 5 + [_P], _I),
    },
    "wide_rounds": _WIDE_FORWARD,
    "wide_rounds_tf32": _WIDE_FORWARD,
    "wide_backward": _WIDE_BACKWARD,
    "wide_backward_tf32": _WIDE_BACKWARD,
}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _library_path(name: str, version: str) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name], *HEADERS):
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS + (version,)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_libraries(names=None, nice: int = 0) -> dict:
    """Build the named libraries (all by default) that are not built yet,
    one ``nvcc`` each, all started together (with ``nice`` > 0 at that
    lower priority, so that a build in the background yields the cores).

    Returns ``{name: (path, seconds spent building, compiler log)}``;
    seconds is 0 and the log empty for a library that was already there.
    """
    names = list(SOURCES) if names is None else list(names)
    nvcc = nvcc_path()
    version = subprocess.run([nvcc, "--version"], check=True, capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    out = {n: (_library_path(n, version), 0.0, "") for n in names}
    if all(os.path.exists(p) for p, _, _ in out.values()):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            t0 = time.perf_counter()
            for n in names:
                lib = out[n][0]
                if os.path.exists(lib):
                    continue
                tmp = f"{lib}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[n])]
                log = open(f"{tmp}.log", "w+")   # a file: a full pipe would stall nvcc
                procs[n] = (cmd, tmp, log, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
                    preexec_fn=(lambda: os.nice(nice)) if nice > 0 else None))
            failed, running = [], dict(procs)
            while running:     # each library's own seconds, as its nvcc ends
                for n, (cmd, tmp, log, proc) in list(running.items()):
                    if proc.poll() is None:
                        continue
                    seconds = time.perf_counter() - t0
                    del running[n]
                    log.seek(0)
                    text = log.read()
                    log.close()
                    os.remove(f"{tmp}.log")
                    if proc.returncode != 0:
                        failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{text}")
                        continue
                    os.replace(tmp, out[n][0])
                    out[n] = (out[n][0], seconds, text)
                time.sleep(0.05)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its C entry points' signatures set."""
    path, _, _ = build_libraries([name])[name]
    lib = ctypes.CDLL(path)
    for fn, (args, res) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = res
    return lib
