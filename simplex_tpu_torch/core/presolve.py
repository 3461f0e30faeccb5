# Copied from simplex_tpu/core/presolve.py; keep in step (tests/test_torch_core.py).
"""Presolve: cheap problem reductions before the device solve.

The reference reaches presolve through scipy (``presolve: True``,
``solver_controller.py:76``); this is the in-framework equivalent.  Only
reductions whose POSTSOLVE is trivial are performed, so solution values,
shadow prices, and reduced costs map back exactly:

* empty rows        — ``0 (op) b``: dropped when trivially satisfied,
                      infeasibility detected otherwise (dual = 0);
* empty columns     — a variable in no constraint: fixed at 0 when its
                      min-form cost is nonnegative (reduced cost = user
                      cost); improving empty columns are KEPT — they mean
                      "unbounded if feasible", and feasibility is the
                      engine's phase-1 call, not presolve's;
* redundant bounds  — singleton rows implied by ``x >= 0``
                      (``a x_j >= b`` with ``a > 0 >= b``, etc.): dropped
                      (dual = 0); singleton rows that contradict
                      ``x >= 0`` prove infeasibility immediately;
* duplicate rows    — proportional rows (same op, positive ratio): only
                      the TIGHTEST survives; the dropped row is implied,
                      so dual = 0 stays a valid (possibly degenerate)
                      KKT choice.  Proportional ``=`` rows with
                      inconsistent RHS prove infeasibility;
* dominated columns — ``c_min_j >= 0`` and the column never helps
                      feasibility (``a_ij >= 0`` on every ``<=`` row,
                      ``<= 0`` on every ``>=`` row, ``0`` on every ``=``
                      row): ``x_j = 0`` is optimal.  Generalizes the
                      empty-column rule; the dropped column's reduced
                      cost is reconstructed from the duals in postsolve
                      (``rc_j = c_j - y·A_j`` in user-sense signs).

Substitution-style reductions (fixed variables, doubleton elimination,
forcing rows) are deliberately left out: they would remap duals
nontrivially and the device engines handle those rows at full speed
anyway.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .problem import LinearProgram, OP_EQ, OP_GE, OP_LE


@dataclasses.dataclass
class PresolveResult:
    """Outcome of presolve on one LP."""

    lp: Optional[LinearProgram]      # reduced problem (None if decided)
    status: Optional[int]            # 2/3 when presolve decides the LP
    kept_rows: np.ndarray            # original row index per kept row
    kept_cols: np.ndarray            # original col index per kept col
    n_rows_orig: int
    n_cols_orig: int

    @property
    def decided(self) -> bool:
        return self.status is not None

    @property
    def reduced(self) -> bool:
        return (len(self.kept_rows) < self.n_rows_orig
                or len(self.kept_cols) < self.n_cols_orig)

    # ------------------------------------------------------------------ #
    def postsolve_x(self, x_red: np.ndarray) -> np.ndarray:
        """Map reduced-problem variables back (dropped columns are 0)."""
        x = np.zeros((self.n_cols_orig,))
        x[self.kept_cols] = x_red
        return x

    def postsolve_duals(self, duals_red: Optional[np.ndarray]
                        ) -> Optional[np.ndarray]:
        """Dropped rows are non-binding by construction: dual 0."""
        if duals_red is None:
            return None
        y = np.zeros((self.n_rows_orig,))
        y[self.kept_rows] = duals_red
        return y

    def postsolve_reduced_costs(self, rc_red: Optional[np.ndarray],
                                lp_orig: LinearProgram,
                                duals: Optional[np.ndarray] = None
                                ) -> Optional[np.ndarray]:
        """Reconstruct dropped columns' reduced costs.

        With ``duals`` (the POSTSOLVED user-sense shadow prices), any
        dropped-at-zero column's marginal is exact:
        ``rc_j = c_j - duals·A[:, j]`` — the identity follows from
        ``duals = dZ_user/db`` regardless of max/min sense.  Without
        duals (or for empty columns, where A_j = 0) it reduces to the
        user cost itself.
        """
        if rc_red is None:
            return None
        rc = np.zeros((self.n_cols_orig,))
        rc[self.kept_cols] = rc_red
        dropped = np.setdiff1d(np.arange(self.n_cols_orig), self.kept_cols)
        if dropped.size:
            c_user = np.asarray(lp_orig.c, np.float64)[dropped]
            if duals is not None and lp_orig.n_cons:
                rc[dropped] = c_user - np.asarray(
                    duals, np.float64) @ np.asarray(
                        lp_orig.A, np.float64)[:, dropped]
            else:
                rc[dropped] = c_user
        return rc


def presolve(lp: LinearProgram, tol: float = 1e-9) -> PresolveResult:
    """Apply the safe reductions.  Never raises on a well-formed LP."""
    m, n = lp.n_cons, lp.n_vars
    A = np.asarray(lp.A, np.float64)
    b = np.asarray(lp.b, np.float64)
    ops = np.asarray(lp.ops)
    c_min = -np.asarray(lp.c, np.float64) if lp.maximize \
        else np.asarray(lp.c, np.float64)

    def decided(status: int) -> PresolveResult:
        return PresolveResult(lp=None, status=status,
                              kept_rows=np.arange(m),
                              kept_cols=np.arange(n),
                              n_rows_orig=m, n_cols_orig=n)

    keep_row = np.ones((m,), bool)
    nz = np.abs(A) > tol
    row_nnz = nz.sum(axis=1)

    # ---- empty rows: 0 (op) b ------------------------------------------ #
    for i in np.where(row_nnz == 0)[0]:
        ok = ((ops[i] == OP_LE and b[i] >= -tol)
              or (ops[i] == OP_GE and b[i] <= tol)
              or (ops[i] == OP_EQ and abs(b[i]) <= tol))
        if not ok:
            return decided(2)
        keep_row[i] = False

    # ---- singleton rows vs x >= 0 -------------------------------------- #
    for i in np.where(row_nnz == 1)[0]:
        j = int(np.argmax(nz[i]))
        a = A[i, j]
        bound = b[i] / a
        if ops[i] == OP_LE:
            # a*x_j <= b  ->  x_j <= bound (a>0) / x_j >= bound (a<0)
            if a > 0 and bound < -tol:
                return decided(2)          # x_j <= negative: empty
            if a < 0 and bound <= tol:
                keep_row[i] = False        # x_j >= nonpositive: implied
        elif ops[i] == OP_GE:
            if a > 0 and bound <= tol:
                keep_row[i] = False        # x_j >= nonpositive: implied
            if a < 0 and bound < -tol:
                return decided(2)          # x_j <= negative: empty
        else:                              # a*x_j = b
            if bound < -tol:
                return decided(2)          # x_j = negative: empty

    # ---- duplicate (proportional) rows ---------------------------------- #
    # Rows i, k with A_k = lam * A_i (lam > 0, same op after normalization):
    # only the tightest survives; the dropped row is implied everywhere the
    # kept one holds, so dual = 0 remains a valid KKT assignment (possibly
    # degenerate when both are tight).  Normalizing each row by its max
    # |entry| turns proportionality into equality, caught by lexicographic
    # sort + adjacent compare — O(m n log m), no pairwise loop.
    live = np.where(keep_row & (row_nnz > 0))[0]
    if live.size > 1:
        row_max = np.max(np.abs(A[live]), axis=1)
        norm = A[live] / row_max[:, None]
        b_norm = b[live] / row_max
        ops_l = ops[live].copy()
        # EQ rows: canonicalize the sign (first nonzero positive) so
        # A_k = -lam * A_i equalities are caught too.
        is_eq = ops_l == OP_EQ
        if np.any(is_eq):
            first = np.argmax(np.abs(norm) > tol, axis=1)
            lead = norm[np.arange(live.size), first]
            flip = is_eq & (lead < 0)
            norm[flip] *= -1.0
            b_norm[flip] *= -1.0
        order = np.lexsort(np.vstack(
            [ops_l[None, :].astype(np.float64),
             np.round(norm, 12).T[::-1]]))
        sn, so, sb, sidx = (norm[order], ops_l[order],
                            b_norm[order], live[order])
        same = np.all(np.abs(sn[1:] - sn[:-1])
                      <= tol * (1.0 + np.abs(sn[1:])), axis=1)
        same &= so[1:] == so[:-1]
        t = 0
        while t < same.size:
            if not same[t]:
                t += 1
                continue
            t1 = t
            while t1 < same.size and same[t1]:
                t1 += 1
            run = np.arange(t, t1 + 1)           # indices into sorted view
            op = so[run[0]]
            bs = sb[run]
            if op == OP_EQ:
                if np.any(np.abs(bs - bs[0]) > tol * (1.0 + abs(bs[0]))):
                    return decided(2)            # inconsistent = rows
                winner = run[0]
            elif op == OP_LE:
                winner = run[int(np.argmin(bs))]  # tightest <=
            else:
                winner = run[int(np.argmax(bs))]  # tightest >=
            for t2 in run:
                if t2 != winner:
                    keep_row[sidx[t2]] = False
            t = t1 + 1

    # ---- dominated / empty columns --------------------------------------- #
    # x_j = 0 is optimal when the column can never pay (c_min_j >= 0) and
    # never helps feasibility: nonnegative on every kept <= row (raising
    # x_j only consumes slack), nonpositive on every kept >= row, zero on
    # every kept = row.  Empty columns are the special case with all-zero
    # entries; improving (c_min < 0) empty columns are KEPT — they mean
    # "unbounded if feasible", and feasibility is the engine's phase-1
    # call, not presolve's.  Dropped columns' reduced costs are
    # reconstructed from duals in postsolve.  Exact sign comparisons: a
    # tol-level negative entry could still matter at huge x_j.
    keep_col = np.ones((n,), bool)
    if keep_row.any():
        Ak = A[keep_row]
        opk = ops[keep_row]
        le_ok = np.all(Ak[opk == OP_LE] >= 0.0, axis=0) \
            if np.any(opk == OP_LE) else np.ones(n, bool)
        ge_ok = np.all(Ak[opk == OP_GE] <= 0.0, axis=0) \
            if np.any(opk == OP_GE) else np.ones(n, bool)
        eq_ok = np.all(Ak[opk == OP_EQ] == 0.0, axis=0) \
            if np.any(opk == OP_EQ) else np.ones(n, bool)
        dominated = (c_min >= -tol) & le_ok & ge_ok & eq_ok
    else:
        dominated = c_min >= -tol
    keep_col &= ~dominated

    kept_rows = np.where(keep_row)[0]
    kept_cols = np.where(keep_col)[0]

    if len(kept_cols) == 0:
        # Everything fixed at zero; remaining rows must accept x = 0.
        for i in kept_rows:
            ok = ((ops[i] == OP_LE and b[i] >= -tol)
                  or (ops[i] == OP_GE and b[i] <= tol)
                  or (ops[i] == OP_EQ and abs(b[i]) <= tol))
            if not ok:
                return decided(2)
        kept_rows = np.array([], dtype=np.int64)

    lp_red = LinearProgram(
        c=lp.c[kept_cols],
        A=A[np.ix_(kept_rows, kept_cols)] if len(kept_rows) else
          np.zeros((0, len(kept_cols))),
        b=b[kept_rows],
        ops=ops[kept_rows],
        maximize=lp.maximize,
        variables=[lp.variables[j] for j in kept_cols],
    )
    return PresolveResult(lp=lp_red, status=None,
                          kept_rows=kept_rows, kept_cols=kept_cols,
                          n_rows_orig=m, n_cols_orig=n)


@dataclasses.dataclass
class Equilibration:
    """Inverse map of :func:`equilibrate` (Ruiz row/column scaling).

    The scaled LP is ``A~ = diag(r) A diag(s)``, ``b~ = r∘b``,
    ``c~ = s∘c``, ``lb~ = lb/s``, ``ub~ = ub/s`` with ``x = s∘x'`` — the
    objective VALUE is preserved exactly (``c~·x' = c·x``), shadow prices
    map as ``y = r∘y~`` (``b~ = r∘b`` ⇒ ``dZ/db = r·dZ/db~``) and reduced
    costs as ``rc = rc~/s``.
    """

    r: np.ndarray                    # (m,) row scales
    s: np.ndarray                    # (n,) column scales

    @property
    def identity(self) -> bool:
        return bool(np.all(self.r == 1.0) and np.all(self.s == 1.0))

    def restore_x(self, x: np.ndarray) -> np.ndarray:
        return self.s * np.asarray(x, np.float64)

    def restore_duals(self, y: Optional[np.ndarray]) -> Optional[np.ndarray]:
        return None if y is None else self.r * np.asarray(y, np.float64)

    def restore_reduced(self, rc: Optional[np.ndarray]
                        ) -> Optional[np.ndarray]:
        return None if rc is None else np.asarray(rc, np.float64) / self.s


def coefficient_range(A: np.ndarray) -> float:
    """max|a|/min|a| over nonzeros — the spread equilibration targets."""
    absA = np.abs(np.asarray(A, np.float64))
    nz = absA[absA > 0]
    if nz.size == 0:
        return 1.0
    return float(np.max(nz) / np.min(nz))


def equilibrate(lp: LinearProgram,
                threshold: float = 1e3):
    """Ruiz row/column equilibration of badly-scaled LPs.

    Netlib-style coefficient spreads of 1e±4 stall f32 simplex engines
    (pricing noise swamps genuine reduced costs; tiny pivots go singular
    — the round-4 adversarial corpus measured 100k+ iterations without
    convergence unscaled, ~2k scaled).  HiGHS does the same internally
    behind the reference's ``solver_controller.py:78-85``.

    Returns ``(lp_scaled, Equilibration)``; identity when the coefficient
    range is already under ``threshold``.  Scaling is row-only (see the
    in-function note): ``s`` stays 1, so ``x``/``rc``/bounds are
    untouched and only duals need restoring.  Row scaling is exact in f32
    binary arithmetic terms (scales are free-form floats, not powers of
    two — the f64 certification re-checks everything downstream anyway).
    """
    A = np.asarray(lp.A, np.float64)
    m, n = A.shape
    ident = Equilibration(r=np.ones(m), s=np.ones(n))
    if m == 0 or n == 0 or coefficient_range(A) <= threshold:
        return lp, ident

    # ROW-ONLY scaling (infinity-norm): each row is divided by its max
    # |entry|, so b scales with it and the variable space (costs, bounds,
    # reduced costs) is untouched.  Column scaling was measured to HURT
    # the f32 engines on the adversarial corpus: it multiplies costs and
    # divides bounds by up to 1e2, pushing genuine reduced costs below
    # the fixed pricing tolerance and creating near-fixed variables —
    # instances that solved in ~2k pivots unscaled ran 100k+ with Ruiz
    # row+column scaling (round-4 bisection: row-only kept every win).
    s = np.ones(n)
    As = A.copy()
    with np.errstate(divide="ignore"):
        row_max = np.max(np.abs(As), axis=1)
        r = np.where(row_max > 0, 1.0 / row_max, 1.0)
    As *= r[:, None]

    lb2 = np.where(np.isfinite(lp.lb), lp.lb / s, lp.lb)
    ub2 = np.where(np.isfinite(lp.ub), lp.ub / s, lp.ub)
    lp2 = LinearProgram(c=lp.c * s, A=As, b=lp.b * r, ops=lp.ops.copy(),
                        maximize=lp.maximize,
                        variables=list(lp.variables), lb=lb2, ub=ub2)
    return lp2, Equilibration(r=r, s=s)
