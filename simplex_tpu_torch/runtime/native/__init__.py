# Copied from simplex_tpu/runtime/native/__init__.py; keep in step (tests/test_torch_core.py).
"""Native (C++) runtime components, built on demand with g++.

The shared library is compiled once into ``build/`` next to the sources and
loaded via ctypes (no pybind11 in this environment — SURVEY.md env notes).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(__file__)
_BUILD = os.path.join(_HERE, "build")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _compile() -> str:
    os.makedirs(_BUILD, exist_ok=True)
    src = os.path.join(_HERE, "simplex_host.cpp")
    out = os.path.join(_BUILD, "libsimplex_host.so")
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               src, "-o", out]
        subprocess.run(cmd, check=True, capture_output=True)
    return out


def load_simplex_host() -> ctypes.CDLL:
    """Build (if needed) and load the native simplex library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_compile())
            lib.simplex_solve_dense.restype = ctypes.c_int
            lib.simplex_solve_dense.argtypes = [
                ctypes.c_int, ctypes.c_int,                    # m, n
                ctypes.POINTER(ctypes.c_double),               # A
                ctypes.POINTER(ctypes.c_double),               # b
                ctypes.POINTER(ctypes.c_double),               # c
                ctypes.POINTER(ctypes.c_int8),                 # ops
                ctypes.c_int,                                  # maximize
                ctypes.c_double, ctypes.c_long,                # tol, max_iters
                ctypes.POINTER(ctypes.c_double),               # x_out
                ctypes.POINTER(ctypes.c_double),               # z_out
                ctypes.POINTER(ctypes.c_long),                 # iters_out
            ]
            lib.simplex_solve_dense_ub.restype = ctypes.c_int
            lib.simplex_solve_dense_ub.argtypes = [
                ctypes.c_int, ctypes.c_int,                    # m, n
                ctypes.POINTER(ctypes.c_double),               # A
                ctypes.POINTER(ctypes.c_double),               # b
                ctypes.POINTER(ctypes.c_double),               # c
                ctypes.POINTER(ctypes.c_int8),                 # ops
                ctypes.POINTER(ctypes.c_double),               # ub (or NULL)
                ctypes.c_int,                                  # maximize
                ctypes.c_double, ctypes.c_long,                # tol, max_iters
                ctypes.POINTER(ctypes.c_double),               # x_out
                ctypes.POINTER(ctypes.c_double),               # z_out
                ctypes.POINTER(ctypes.c_long),                 # iters_out
            ]
            _LIB = lib
    return _LIB
