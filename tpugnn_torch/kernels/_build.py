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

__all__ = ["HEADERS", "NVCC_FLAGS", "SOURCES", "build_libraries", "load_library", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# library name -> source
SOURCES = {"fused_rounds": "fused_rounds.cu", "fused_backward": "fused_backward.cu",
           "spmm": "spmm.cu", "sddmm": "sddmm.cu", "roll_gather": "roll_gather.cu"}
HEADERS = ("rounds_common.cuh", "rounds_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points per library: name -> (argument types, result type)
_SIGNATURES = {
    "fused_rounds": {
        "fused_rounds_smem_bytes": ([_I] * 5, ctypes.c_longlong),
        "fused_rounds_launch": ([_I] + [_P] * 9 + [_I] * 6 + [_P], _I),
        "fused_rounds_stash_launch": ([_I] + [_P] * 11 + [_I] * 6 + [_P], _I),
    },
    "fused_backward": {
        "fused_rounds_bwd_smem_bytes": ([_I] * 5, ctypes.c_longlong),
        "fused_rounds_bwd_tile": ([_I], _I),
        "fused_rounds_bwd_scratch_bytes": ([_I] * 5, ctypes.c_longlong),
        "fused_rounds_bwd_launch": ([_I] + [_P] * 17 + [_I] * 7 + [_P], _I),
    },
    "spmm": {
        "ell_aggregate_launch": ([_I, _I] + [_P] * 3 + [_I] * 5 + [_P], _I),
    },
    "sddmm": {
        "sddmm_smem_bytes": ([_I] * 4, ctypes.c_longlong),
        "sddmm_edge_hidden_launch": ([_I] + [_P] * 7 + [_I] * 6 + [_P], _I),
    },
    "roll_gather": {
        "roll_rounds_smem_bytes": ([_I] * 2, ctypes.c_longlong),
        "roll_rounds_launch": ([_I] * 2 + [_P] * 10 + [_I] * 3 + [_P], _I),
    },
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
    return os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_libraries(names=None) -> dict:
    """Build the named libraries (all by default) that are not built yet,
    one ``nvcc`` each, all started together.

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
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
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
                procs[n] = (cmd, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            failed = []
            for n, (cmd, tmp, proc) in procs.items():
                log = proc.communicate()[0]
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, out[n][0])
                out[n] = (out[n][0], seconds, log)
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
