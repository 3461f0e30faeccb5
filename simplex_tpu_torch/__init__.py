"""simplex_tpu_torch: the PyTorch / CUDA port of simplex_tpu.

Sits beside the JAX package, which stays the reference.  This slice ports
the single-LP path end to end: ``LinearProgram`` -> standard form ->
two-phase dense tableau simplex on torch tensors, whose pivot runs through
the hand-written Hopper kernel K1 (``csrc/pivot_update.cu``) on a CUDA
device -> f64 certification -> the report.  The package imports torch,
numpy and scipy and never JAX, so it runs on a machine without JAX.
"""
__version__ = "0.1.0"

from .config import SolverConfig
from .core.problem import LinearProgram, compile_standard_form
from .models.dense import SimplexResult, solve_lp

__all__ = [
    "LinearProgram",
    "SimplexResult",
    "SolverConfig",
    "compile_standard_form",
    "solve_lp",
]
