# Copied from simplex_tpu/models/crossover.py; keep in step (tests/test_torch_core.py).
"""PDHG → simplex crossover: exact vertices from first-order solutions.

The standard PDLP deployment pattern (cf. PAPERS.md first-order-LP survey):
the first-order method does the bulk O(matmul) work to ~1e-4 residuals,
then a simplex "cleanup" recovers an exact vertex in a handful of pivots
because it starts at a near-optimal basis instead of from scratch.  The
reference has no analogue (scipy/HiGHS solves cold per request).

Mechanics here:

1. :func:`basis_guess` reads a basis off the approximate primal ``x``:
   score every decision column by its value and every inequality row's
   slack/surplus by its residual, take the top-m as basic, and map them
   into ``compile_standard_form``'s column layout (slack k-th inequality
   row → column n+k, matching ``core/problem.py:465-484``).
2. :func:`crossover_lp` hands that basis to :func:`models.dense.reoptimize`
   — the dual-simplex reoptimizer: a near-optimal basis is near
   DUAL-feasible, which is exactly the state dual simplex finishes from
   (primal infeasibilities iterate away in few pivots).  A stale/singular
   guess falls back to a cold ``solve_lp`` inside ``reoptimize``, so the
   result is exact either way, with the usual f64 certification.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import SolverConfig, DEFAULT_CONFIG
from ..core.problem import OP_EQ, OP_GE, OP_LE, LinearProgram
from .dense import SimplexResult, reoptimize, _pad_plan


def basis_guess(lp: LinearProgram, x: np.ndarray) -> Optional[np.ndarray]:
    """Basis column indices implied by an approximate primal solution.

    Returns a (m_pad,) int32 basis in the padded standard-form layout, or
    None when the LP's shape rules out a guess (no constraints).
    """
    m, n = lp.n_cons, lp.n_vars
    if m == 0:
        return None
    x = np.asarray(x, np.float64).reshape(n)

    A = lp.A.copy()
    b = lp.b.copy()
    ops = lp.ops.astype(np.int64).copy()
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0
    ops[neg] *= -1

    resid = b - A @ x                         # slack for LE, -surplus for GE
    # Column scores: larger ⇒ more likely basic at the optimum.
    scores = []                               # (score, col_index)
    for j in range(n):
        scores.append((x[j], j))
    slack_at = n
    for i in range(m):
        if ops[i] == OP_LE:
            scores.append((max(resid[i], 0.0), slack_at))
            slack_at += 1
        elif ops[i] == OP_GE:
            scores.append((max(-resid[i], 0.0), slack_at))
            slack_at += 1
        # EQ rows contribute no slack column.
    scores.sort(key=lambda t: -t[0])
    chosen = [col for _, col in scores[:m]]

    row_pad, col_pad = _pad_plan(lp)
    from ..core.problem import compile_standard_form

    sf = compile_standard_form(lp, row_pad=row_pad, col_pad=col_pad,
                               dtype=np.float64)
    basis = np.asarray(sf.basis, np.int32).copy()
    # EQ-heavy batches can have m > n + n_ineq (fewer candidate columns
    # than rows): keep sf.basis's artificial columns on the surplus rows —
    # ``reoptimize`` validates the guess and cold-solves if it is singular.
    basis[: len(chosen)] = np.asarray(chosen, np.int32)
    return basis


def basis_guess_bounded(lp_n: LinearProgram, x: np.ndarray):
    """Basis + at-upper guess for a NORMALIZED bounded LP (lb = 0).

    A variable is basic-likely when it sits INTERIOR to its bounds
    (score = distance to the NEARER bound); a nonbasic variable closer to
    its finite upper bound than to zero is guessed at-upper.  Row
    slacks/surpluses score by their residual as in :func:`basis_guess`.
    Returns ``(basis (m_pad,), at_upper (n_pad,) bool)`` in the bounded
    standard-form layout, or None when no guess is possible.
    """
    m, n = lp_n.n_cons, lp_n.n_vars
    if m == 0:
        return None
    x = np.asarray(x, np.float64).reshape(n)
    ub = lp_n.ub

    A = lp_n.A.copy()
    b = lp_n.b.copy()
    ops = lp_n.ops.astype(np.int64).copy()
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0
    ops[neg] *= -1

    resid = b - A @ x
    scores = []
    for j in range(n):
        lo = max(x[j], 0.0)
        hi = (ub[j] - x[j]) if np.isfinite(ub[j]) else np.inf
        scores.append((min(lo, hi), j))
    slack_at = n
    for i in range(m):
        if ops[i] == OP_LE:
            scores.append((max(resid[i], 0.0), slack_at))
            slack_at += 1
        elif ops[i] == OP_GE:
            scores.append((max(-resid[i], 0.0), slack_at))
            slack_at += 1
    scores.sort(key=lambda t: -t[0])
    chosen = [col for _, col in scores[:m]]

    row_pad, col_pad = _pad_plan(lp_n)
    from ..core.problem import compile_standard_form

    sf = compile_standard_form(lp_n, row_pad=row_pad, col_pad=col_pad,
                               dtype=np.float64, bounded=True)
    basis = np.asarray(sf.basis, np.int32).copy()
    basis[: len(chosen)] = np.asarray(chosen, np.int32)
    at_up = np.zeros((sf.n_pad,), bool)
    in_basis = np.zeros((sf.n_pad,), bool)
    in_basis[basis] = True
    for j in range(n):
        if not in_basis[j] and np.isfinite(ub[j]) and \
                (ub[j] - x[j]) < max(x[j], 0.0):
            at_up[j] = True
    return basis, at_up


def crossover_lp(lp: LinearProgram, x_approx: np.ndarray,
                 config: SolverConfig = DEFAULT_CONFIG) -> SimplexResult:
    """Exact solve warm-started from a first-order solution.

    Classic ``x >= 0`` LPs route through :func:`models.dense.reoptimize`
    (dual simplex from the guessed basis, cold-start fallback inside);
    BOUNDED LPs normalize their bounds and warm-start the revised
    engine's bounded phase 2 with the guessed (basis, at-upper) pair
    (VERDICT r3 item 8) — an infeasible/singular guess falls back to a
    cold start inside ``_check_warm_basis``.  Either way the returned
    optimum carries the same f64 certification as any single-LP solve.
    """
    from .dense import solve_lp

    if lp.n_cons == 0:
        return solve_lp(lp, config)
    if lp.has_finite_bounds:
        from ..core.problem import normalize_bounds
        from .revised import RevisedSimplexSolver

        lp_n, tr = normalize_bounds(lp)
        if lp_n.has_free:
            return solve_lp(lp, config)
        # Map the approximate point into the normalized space
        # (inverse of BoundsTransform.restore_x: x' = sign (x - shift)).
        x_n = tr.sign * (np.asarray(x_approx, np.float64)[: lp.n_vars]
                         - tr.shift)
        guess = basis_guess_bounded(lp_n, x_n)
        solver = RevisedSimplexSolver(config)
        if guess is None:
            return solver.solve(lp)
        return solver.solve(lp, warm_basis=guess[0],
                            warm_at_upper=guess[1])
    if lp.has_free:
        return solve_lp(lp, config)
    guess = basis_guess(lp, x_approx)
    if guess is None:
        return solve_lp(lp, config)
    return reoptimize(lp, guess, config)


def crossover_batch(c, A, b, ops, maximize, x,
                    indices: Optional[Sequence[int]] = None,
                    config: SolverConfig = DEFAULT_CONFIG
                    ) -> List[SimplexResult]:
    """Crossover for selected instances of a uniform array batch.

    ``x`` is the (B, n) approximate primal block (e.g. ``PdhgResult.x``);
    ``indices`` selects which instances need exact vertices (default all).
    Returns one :class:`SimplexResult` per selected index, in order.
    """
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    ops = np.asarray(ops)
    B = A.shape[0]
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B,))
    if indices is None:
        indices = range(B)
    out = []
    for i in indices:
        lp = LinearProgram(c=c[i], A=A[i], b=b[i], ops=ops,
                           maximize=bool(maximize[i]))
        out.append(crossover_lp(lp, x[i], config))
    return out
