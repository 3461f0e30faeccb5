"""simplex_tpu_torch: the PyTorch / CUDA port of simplex_tpu.

Sits beside the JAX package, which stays the reference.  Ported so far:
the single-LP path end to end (``LinearProgram`` -> standard form ->
two-phase dense tableau simplex on torch tensors, whose pivot runs through
the hand-written Hopper kernel K1, ``csrc/pivot_update.cu``, on a CUDA
device -> f64 certification -> the report), and batches of LPs of one
padded shape (``BatchedSimplexSolver``, ``solve_lp_batch``), whose pivot
step runs through the fused kernel K2, ``csrc/fused_pivot_step.cu``, or,
with native upper bounds (``solve_arrays(ub=...)``, ``solve_lp_sweep``),
through the bounded kernel K3, ``csrc/fused_pivot_step_bounded.cu``.  The
pivot-rate measurement (``utils/pivot_bench.py``) holds K1 against the
card's streaming ceiling, measured by the copy kernel K4,
``csrc/stream_copy.cu``; ``utils/profiling.py`` keeps the solve records.
Off the tableau path: netlib-style LPs from MPS files (``load_mps``,
``parse_mps``) through the revised engine (``RevisedSimplexSolver``, basis
inverse on the card) or the native C++ host engine, and every entry point
of the JAX package's CLI and web app (``cli.py``, ``web/app.py``).  The
dual reoptimizer (``reoptimize``, ``DenseSimplexSolver``) pivots through
K1; the first-order solver (``PdhgSolver``) runs batched matrix-vector
products, with crossover to exact vertices (``models/crossover.py``); the
streaming sweeps (``solve_arrays_stream`` here and in ``models/pdhg.py``)
stage the next batch while the card solves the current one.  The public
names equal the JAX package's.
The package imports torch, numpy and scipy and never JAX, so it runs on a
machine without JAX.
"""
__version__ = "0.1.0"

from .config import SolverConfig
from .core.parsing import (
    Constraint,
    ConstraintsParser,
    ConstraintsValidator,
    ObjectiveFunctionParser,
)
from .core.problem import (
    BoundsTransform,
    LinearProgram,
    compile_standard_form,
    lower_bounds_to_rows,
    merge_free_solution,
    normalize_bounds,
    split_free_variables,
)
from .utils.mps import load_mps, parse_mps
from .models.batched import (BatchedSimplexSolver, BatchResult,
                             solve_arrays_stream, solve_lp_batch,
                             solve_lp_sweep)
from .models.dense import (DenseSimplexSolver, SimplexResult,
                           reoptimize, solve_lp)
from .models.pdhg import PdhgSolver
from .models.revised import RevisedSimplexSolver

__all__ = [
    "BatchResult",
    "BatchedSimplexSolver",
    "BoundsTransform",
    "lower_bounds_to_rows",
    "normalize_bounds",
    "Constraint",
    "ConstraintsParser",
    "ConstraintsValidator",
    "DenseSimplexSolver",
    "LinearProgram",
    "ObjectiveFunctionParser",
    "PdhgSolver",
    "RevisedSimplexSolver",
    "SimplexResult",
    "SolverConfig",
    "compile_standard_form",
    "load_mps",
    "merge_free_solution",
    "parse_mps",
    "reoptimize",
    "solve_arrays_stream",
    "solve_lp",
    "solve_lp_batch",
    "solve_lp_sweep",
    "split_free_variables",
]
