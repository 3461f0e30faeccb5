"""Build and load the port's CUDA kernels.

The kernels live in ``simplex_tpu_torch/csrc/*.cu`` and expose a plain C
interface.  At first use this module compiles them with ``nvcc`` for Hopper
(``sm_90a``) into one shared library under ``runtime/build/`` (listed in
``.gitignore``) and loads it with ``ctypes``.  The library's file name
carries a hash of the sources, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "runtime", "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsimplex_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.

    Returns its path.  The compiler's register/spill report (``-Xptxas -v``)
    is kept beside it as ``<library>.log``.
    """
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    with open(out + ".log", "w", encoding="utf-8") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent loader never sees a partial file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's C types declared."""
    lib = ctypes.CDLL(build())
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("k1_pivot_update_f32", "k1_pivot_update_f64"):
        fn = getattr(lib, name)
        # tab, R, W, r, s, do_pivot, clamp_rhs, col, prow, vectorized, stream
        fn.argtypes = [p, i64, i64, p, p, p, i32, p, p, i32, p]
        fn.restype = i32
    return lib
