"""ctypes loader for the repo's C++ host library (``csrc/*.cpp``), built on use.

The port's counterpart of ``tpugnn.utils.native``: the same sources and the
same C entry points (packed GF(2) algebra, the union-find, OSD-0 and MWPM
batch decoders), built with ``g++`` and ``csrc/Makefile``'s flags into
``tpugnn_torch/_build/`` (ignored by git), never into the JAX package's
``_native/``.  The library is named by a hash of the sources, the flags and
the compiler's version line, and built under the same file lock as the CUDA
kernels (``tpugnn_torch.kernels._build``), so that concurrent processes build
it once.  Nothing here runs at import time.

Unlike the JAX loader, ``load()`` raises when the build or the load fails:
the decoders' pure-Python twins run only when a caller asks for them
(``force_python=True``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from tpugnn_torch.kernels._build import BUILD_DIR

__all__ = ["SOURCES", "CXX_FLAGS", "library_path", "load"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_REPO, "csrc")
SOURCES = ("f2.cpp", "unionfind.cpp", "osd.cpp", "mwpm.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I = ctypes.c_int
# C entry points: name -> (argument types, result type)
_SIGNATURES = {
    "f2_row_reduce": ([_u8, _I, _I, _i32], _I),
    "f2_rank": ([_u8, _I, _I], _I),
    "f2_nullspace": ([_u8, _I, _I, _u8], _I),
    "f2_solve": ([_u8, _u8, _I, _I, _u8], _I),
    # edge endpoints, n_edges, n_verts, syndromes [batch, n_verts], batch,
    # corrections out [batch, n_edges]
    "uf_decode_batch": ([_i32, _i32, _I, _I, _u8, _I, _u8], _I),
    # h [m, n], m, n, syndromes [batch, m], llrs [batch, n], batch, out [batch, n]
    "osd0_decode_batch": ([_u8, _I, _I, _u8, _f32, _I, _u8], _I),
    "mwpm_match": ([_i64, _I, _i32], ctypes.c_longlong),
    # dist, par_v, par_e [(nv+1)^2], nv, n_edges, has_boundary, inf sentinel,
    # syndromes [batch, nv], batch, corrections out [batch, n_edges]
    "mwpm_decode_batch": ([_i64, _i32, _i32, _I, _I, _I, ctypes.c_longlong, _u8, _I, _u8],
                          _I),
}


def _cxx() -> str:
    path = shutil.which(os.environ.get("CXX", "g++"))
    if path is None:
        raise RuntimeError("no C++ compiler (g++) found: the host decoders' library "
                           "is built from csrc/ on first use")
    return path


def library_path(cxx: str) -> str:
    """The library's path: a hash of the sources, the flags and ``cxx``'s
    version line."""
    version = subprocess.run([cxx, "--version"], check=True, capture_output=True,
                             text=True).stdout.splitlines()[0]
    h = hashlib.sha256()
    for f in SOURCES:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(CXX_FLAGS + (version,)).encode())
    return os.path.join(BUILD_DIR, f"libtpugnn_host_{h.hexdigest()[:16]}.so")


def _build(cxx: str, lib: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # its own lock: under the kernels' one it would wait for every nvcc
    with open(os.path.join(BUILD_DIR, ".lock_host"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):
                return
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(os.path.join(_CSRC, f) for f in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """The host library with its entry points' signatures set, built first
    if it is not there.  Raises if it cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        cxx = _cxx()
        lib_path = library_path(cxx)
        if not os.path.exists(lib_path):
            _build(cxx, lib_path)
        lib = ctypes.CDLL(lib_path)
        for fn, (args, res) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = res
        _LIB = lib
        return lib
