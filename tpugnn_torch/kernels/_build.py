"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library -> ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so a
cold build takes seconds.  The library goes to ``tpugnn_torch/_build/``
(ignored by git), named by a hash of the sources, the flags and the
compiler's version line, under a file lock so that concurrent processes build
it once.  Nothing here runs at import time.
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

__all__ = ["NVCC_FLAGS", "build_library", "load_library", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("fused_rounds.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def build_library() -> tuple[str, float, str]:
    """Build the kernels' library if it is not built yet.

    Returns ``(path, seconds spent building, compiler log)``; seconds is 0
    and the log empty when the library was already there.
    """
    nvcc = nvcc_path()
    version = subprocess.run([nvcc, "--version"], check=True, capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + (version,)).encode())
    lib = os.path.join(_BUILD_DIR, f"libtpugnn_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):
                return lib, 0.0, ""
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(_CSRC, s) for s in SOURCES)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
            return lib, seconds, proc.stdout + proc.stderr
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with its C entry points' signatures set."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_rounds_smem_bytes.argtypes = [i, i, i, i, i]
    lib.fused_rounds_smem_bytes.restype = ctypes.c_longlong
    lib.fused_rounds_launch.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, p]
    lib.fused_rounds_launch.restype = i
    return lib
