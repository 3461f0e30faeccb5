"""Build and load the port's CUDA kernels.

The kernels live in ``simplex_tpu_torch/csrc/*.cu`` and expose a plain C
interface.  At first use this module compiles them with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process a source, all started together, links
them into one shared library under ``runtime/build/`` (listed in
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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

    Returns its path.  The compilers' register/spill reports (``-Xptxas
    -v``) are kept beside it as ``<library>.log``.
    """
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        jobs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            stdout, stderr = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{stderr}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp,
                               *(obj for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        with open(out + ".log", "w", encoding="utf-8") as f:
            f.write("".join(log))
        # Atomic: a concurrent loader never sees a partial file.
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


_P, _I64, _U64, _I32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                        ctypes.c_int)


def _k2(real):
    # tab, B, M, N, basis, cm1, cm2, phase, status, bland, w, tol, devex,
    # s, r, optimal, unbounded, did_pivot, stream
    return [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, real, _I32,
            _P, _P, _P, _P, _P, _P]


def _k3(real):
    # tab, B, M, N, basis, at_upper, cm1, cm2, phase, status, bland, w, ub,
    # ub_B, is_art_row, art_mask, tol, devex, with_art, s, r, optimal,
    # unbounded, moving, stream
    return [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _P, _P, real, _I32, _I32, _P, _P, _P, _P, _P, _P]


def _cert():
    return [_P, _P, _P, _P, _I32, _I32, _I32, _I64, _P, _I64, _P, _P, _I64,
            _P, _I64, _I64, _I64, ctypes.c_double, _P, _P, _P, _P]


# Every C entry point of csrc/*.cu and its argument types, in order; each
# returns a CUDA error code (int).  tests/test_torch_kernel_abi.py holds
# this table to the sources' signatures.
ARGTYPES = {
    # tab, R, W, magic, shift, r, s, do_pivot, clamp_rhs, col, prow, stream
    "k1_pivot_update_f32": [_P, _I64, _I64, _U64, _I32, _P, _P, _P, _I32,
                            _P, _P, _P],
    "k1_pivot_update_f64": [_P, _I64, _I64, _U64, _I32, _P, _P, _P, _I32,
                            _P, _P, _P],
    "k2_fused_pivot_step_f32": _k2(ctypes.c_float),
    "k2_fused_pivot_step_f64": _k2(ctypes.c_double),
    "k3_fused_pivot_step_bounded_f32": _k3(ctypes.c_float),
    "k3_fused_pivot_step_bounded_f64": _k3(ctypes.c_double),
    # x, out, numel, stream
    "k4_stream_copy_f32": [_P, _P, _I64, _P],
    "k4_stream_copy_f64": [_P, _P, _I64, _P],
    # csrc/certify_bounded.cu: A, b, c, ub, b_f64, c_f64, ub_f64, ld_ub,
    # at_upper, ld_up, maximize, basis, ldb, status, B, m, n, tol,
    # certified, x, fun, stream
    "certify_le_bounded_f32": _cert(),
    "certify_le_bounded_f64": _cert(),
    # csrc/graph_steps.cu: n, parts, flags, counts, limits, exec_out,
    # stream; exec, stream; graph, n_types, counts; stream_out
    "graph_chain_build": [_I64, _P, _P, _P, _P, _P, _P],
    "graph_chain_launch": [_P, _P],
    "graph_chain_destroy": [_P, _P],
    "graph_node_counts": [_U64, _I64, _P],
    "graph_stream_create": [_P],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's C types declared
    (:data:`ARGTYPES`)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
