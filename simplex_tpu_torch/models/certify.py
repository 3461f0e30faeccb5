# Copied from simplex_tpu/models/certify.py; keep in step (tests/test_torch_core.py).
"""Vectorized f64 certification of batched simplex verdicts.

The single-LP paths KKT-check every claimed optimum in host float64 and
re-solve failures exactly (``models/dense.py`` ``_finalize_on_host`` /
``_host_simplex_f64``) — the safety net that makes the f32 device loop
trustworthy.  Sweeps are exactly where one silent f32 mis-verdict hides
among 10k right answers, so batched (``models/batched.py``) and sharded
(``parallel/sharded.py``) verdicts get the same treatment here, vectorized:

* **Certification** is one batched LU over the (B, m, m) basis matrices
  (``np.linalg.solve`` broadcasts) + one reduced-cost matvec — numpy-cheap
  at sweep shapes (m ≤ a few hundred).  The KKT conditions checked are
  identical to the single-LP ``_finalize_on_host``: primal feasibility of
  ``B x_B = b`` in f64, no artificial basic above tolerance, and dual
  feasibility ``rc >= -tol`` over the phase-2 columns.
* **Escalation** re-solves every failed-certification optimum and every
  claimed infeasible/unbounded/iteration-limit instance through
  :func:`models.dense.solve_lp_host_exact` — the same exact host engine
  single-LP escalation uses — so a batch element can never carry a verdict
  a single solve of the same LP would have rejected.

The reference gets this guarantee for free by trusting HiGHS f64
(``app/controllers/solver_controller.py:78-85``); an f32
TPU sweep has to earn it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..core.problem import (
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
    LinearProgram,
)
from ..runtime import counters
from ..utils.profiling import count, trace_span

# Instances re-solved on the exact host engine since the counter was last
# reset to 0: every escalation loop here, and ``models/dense.py::solve_lp``,
# on every thread.  The web app's ``/metrics`` exports it.
ESCALATIONS = 0


def count_escalation():
    """One instance escalated: :data:`ESCALATIONS` and the ``escalations``
    of the open solve record (``utils/profiling.py``) rise by one."""
    counters.add(globals(), "ESCALATIONS")
    count("escalations")


def certify_bases_f64(A_std: np.ndarray, b_std: np.ndarray,
                      c_std: np.ndarray, art_mask: np.ndarray,
                      valid_mask: np.ndarray, basis: np.ndarray,
                      check: Optional[np.ndarray] = None,
                      tol: float = 1e-7):
    """Batched f64 KKT check of claimed-optimal bases.

    Args (all numpy, f64 where float):
      A_std:      (B, m, N) standard-form constraint columns
      b_std:      (B, m) canonicalized RHS
      c_std:      (B, N) raw min-form phase-2 costs
      art_mask:   (B, N) bool — artificial columns
      valid_mask: (B, N) bool — phase-2-eligible columns
      basis:      (B, m) int — claimed basis column per row
      check:      (B,) bool — instances to certify (others return False)

    Returns ``(certified (B,) bool, x_full (B, N) f64 vertex, fun (B,) f64
    min-form objective)``; x_full/fun are meaningful only where certified.
    """
    A_std = np.asarray(A_std, np.float64)
    b_std = np.asarray(b_std, np.float64)
    c_std = np.asarray(c_std, np.float64)
    basis = np.asarray(basis, np.int64)
    B_, m, N = A_std.shape
    if check is None:
        check = np.ones((B_,), bool)

    with trace_span("certify.gather"):
        in_range = ~np.any((basis < 0) | (basis >= N), axis=1)
        safe_basis = np.where(in_range[:, None], basis, 0)

        Bmat = np.take_along_axis(A_std, safe_basis[:, None, :], axis=2)
        cB = np.take_along_axis(c_std, safe_basis, axis=1)
    with trace_span("certify.lapack"):
        ok_solve = np.zeros((B_,), bool)
        xB = np.zeros((B_, m))
        y = np.zeros((B_, m))
        sel = check & in_range
        if np.any(sel):
            idx = np.nonzero(sel)[0]
            if m >= 512:
                # Large-m regime (sharded row-block solves): ONE LU per
                # instance serves both triangular solves — numpy's batched
                # ``solve`` would factorize B twice (for B and Bᵀ), and at
                # m=16k each factorization is ~45 s of host LAPACK.
                from scipy.linalg import lu_factor, lu_solve

                for i in idx:
                    try:
                        lu = lu_factor(Bmat[i])
                        xB[i] = lu_solve(lu, b_std[i])
                        y[i] = lu_solve(lu, cB[i], trans=1)
                        ok_solve[i] = True
                    except (np.linalg.LinAlgError, ValueError):
                        pass
            else:
                try:
                    xB[idx] = np.linalg.solve(
                        Bmat[idx], b_std[idx][..., None])[..., 0]
                    y[idx] = np.linalg.solve(np.swapaxes(Bmat[idx], 1, 2),
                                             cB[idx][..., None])[..., 0]
                    ok_solve[idx] = True
                except np.linalg.LinAlgError:
                    # Some instance's basis matrix is singular: numpy's batched
                    # solve rejects the whole stack, so fall back per instance.
                    for i in idx:
                        try:
                            xB[i] = np.linalg.solve(Bmat[i], b_std[i])
                            y[i] = np.linalg.solve(Bmat[i].T, cB[i])
                            ok_solve[i] = True
                        except np.linalg.LinAlgError:
                            pass
            finite = np.all(np.isfinite(xB), axis=1) & \
                np.all(np.isfinite(y), axis=1)
            ok_solve &= finite

    with trace_span("certify.check"):
        rc = c_std - np.einsum("bm,bmn->bn", y, A_std)
        scale = 1.0 + np.max(np.abs(b_std), axis=1, initial=0.0)
        c_scale = 1.0 + np.max(np.abs(c_std), axis=1, initial=0.0)
        prim_ok = ~np.any(xB < -tol * scale[:, None], axis=1)
        art_basic = np.take_along_axis(art_mask, safe_basis, axis=1)
        art_ok = ~np.any(art_basic & (np.abs(xB) > tol * scale[:, None]), axis=1)
        dual_ok = np.all((~valid_mask) | (rc >= -tol * c_scale[:, None]), axis=1)
        certified = check & in_range & ok_solve & prim_ok & art_ok & dual_ok

        x_full = np.zeros((B_, N))
        np.put_along_axis(x_full, safe_basis, xB, axis=1)
        fun = np.einsum("bn,bn->b", c_std, x_full)
    return certified, x_full, fun


def certify_infeasible_f64(A_std: np.ndarray, b_std: np.ndarray,
                           c1_std: np.ndarray, mask_p1: np.ndarray,
                           basis: np.ndarray,
                           check: Optional[np.ndarray] = None,
                           tol: float = 1e-7) -> np.ndarray:
    """Batched f64 certificate of claimed-INFEASIBLE verdicts.

    An f32 'infeasible' claim means the device's phase 1 terminated with
    artificials still carrying weight.  That claim is exact iff the final
    basis is a true phase-1 optimum in f64 with positive objective: primal
    feasible (``B x_B = b``, ``x_B >= -tol``), dual feasible over phase-1
    columns for the phase-1 costs, and ``c1' x > tol`` — the optimal value
    of min sum-of-artificials being positive IS the infeasibility proof
    (the KKT form of a Farkas certificate).  Verdicts certified here skip
    the per-instance host re-solve entirely, so a sweep full of genuinely
    infeasible instances stays vectorized.
    """
    certified, x_full, fun1 = certify_bases_f64(
        A_std, b_std, c1_std, np.zeros_like(mask_p1), mask_p1, basis,
        check=check, tol=tol)
    scale = 1.0 + np.max(np.abs(b_std), axis=1, initial=0.0)
    return certified & (fun1 > tol * scale)


def _certify_raw_instance_f64(c_min: np.ndarray, A: np.ndarray,
                              b: np.ndarray, ops: np.ndarray,
                              basis_m: np.ndarray, phase: int = 2,
                              tol: float = 1e-7,
                              ub: Optional[np.ndarray] = None,
                              at_up: Optional[np.ndarray] = None):
    """Structured f64 KKT check of ONE basis directly on raw (c, A, b, ops).

    The scalable large-m certification path (VERDICT r3 item 2): a
    standard-form basis contains at most ``k <= n`` STRUCTURAL columns —
    every other basic column is a signed unit vector (slack ``±e_i``,
    artificial ``e_i``).  Exploiting that structure, ``B x = b`` and
    ``Bᵀ y = c_B`` reduce to ONE shared k×k LU plus O(m·k) substitution,
    and the reduced-cost check is one O(m·n) matvec — so certifying an
    m=16k (or m=100k) row-sharded solve costs milliseconds where the dense
    m×m LU needed ~45 s of host LAPACK (``tests/test_sharded.py`` r3).
    No m×N standard form is ever materialized.

    Block elimination: let S = rows whose basic column is structural
    (k of them), U = rows holding unit columns with unit-row ``r_u`` and
    sign ``s_u``; the unit rows must be distinct (else B is singular).
    On the k uncovered rows R0:  ``A[R0, cols_S] x_S = b[R0]``; then
    ``x_u = s_u (b[r_u] - A[r_u, cols_S] x_S)``.  Dually ``y[r_u] =
    s_u c_B[u]`` and ``A[R0, cols_S]ᵀ y[R0] = c_B[S] - A[r_u, cols_S]ᵀ
    y[r_u]`` — the same LU, transposed solve.

    ``phase=1`` certifies with the phase-1 costs (artificials cost 1): a
    positive phase-1 optimum is the Farkas infeasibility certificate.

    ``ub``/``at_up`` ((n,) each): NATIVE-bounds certification — the primal
    solve uses the at-upper-adjusted RHS ``b - A u_U``, basic structural
    variables must sit inside [0 - tol, ub + tol], and the dual sign test
    splits per bound status: at-lower nonbasic needs rc >= -tol, at-upper
    needs rc <= +tol (fixed ub == 0 columns impose no sign).  This is the
    KKT system of the bounded ratio-test kernels
    (``ops/batched.solve_tableau_batch_bounded``, ``models/revised.py``).

    Expects ROW-NORMALIZED data (b >= 0; callers flip rows first, matching
    ``compile_batch_uniform``).  ``basis_m`` is the device basis restricted
    to the m real rows, in the uniform layout (structural j < n, slack i at
    n+i, artificial i at n+m+i).  Returns ``(certified, x_struct (n,),
    fun)`` — or ``(False, None, nan)`` when the basis is structurally
    invalid/singular (caller escalates).
    """
    from scipy.linalg import LinAlgError, lu_factor, lu_solve

    m, n = A.shape
    bad = (False, None, np.nan)
    bidx = np.asarray(basis_m, np.int64)
    if bidx.shape[0] != m or np.any(bidx < 0) or np.any(bidx >= n + 2 * m):
        return bad

    from ..core.problem import OP_EQ, OP_LE

    is_le = ops == OP_LE
    is_ineq = ops != OP_EQ
    sign_slack = np.where(is_le, 1.0, -1.0)

    is_struct = bidx < n
    S = np.nonzero(is_struct)[0]
    U = np.nonzero(~is_struct)[0]
    cols_S = bidx[S]
    if len(np.unique(cols_S)) != len(cols_S):
        return bad                       # duplicate structural column
    unit_idx = bidx[U] - n
    is_art_u = unit_idx >= m
    r_u = np.where(is_art_u, unit_idx - m, unit_idx)
    # A slack column on an equality row does not exist in the layout —
    # a basis pointing at one is invalid.
    if np.any((~is_art_u) & ~is_ineq[r_u]):
        return bad
    if len(np.unique(r_u)) != len(r_u):
        return bad                       # two unit columns share a row
    s_u = np.where(is_art_u, 1.0, sign_slack[r_u])

    covered = np.zeros(m, bool)
    covered[r_u] = True
    R0 = np.nonzero(~covered)[0]
    k = len(S)
    if len(R0) != k:
        return bad

    if ub is None:
        ub = np.full(n, np.inf)
    if at_up is None:
        at_up = np.zeros(n, bool)
    at_up = at_up & np.isfinite(ub)
    at_up[cols_S] = False                # basic columns are never at-upper
    b_eff = b
    if np.any(at_up):
        u_vec = np.where(at_up, ub, 0.0)
        b_eff = b - A @ u_vec

    A_S = A[:, cols_S] if k else np.zeros((m, 0))
    if k:
        M = A_S[R0]                      # (k, k) — the whole factorization
        try:
            lu = lu_factor(M)
        except (LinAlgError, ValueError):
            return bad
        x_S = lu_solve(lu, b_eff[R0])
    else:
        x_S = np.zeros(0)
    x_U = s_u * (b_eff[r_u] - A_S[r_u] @ x_S)

    # Dual: phase-appropriate basic costs.
    if phase == 1:
        c_struct = np.zeros(n)
        cB_U = np.where(is_art_u, 1.0, 0.0)
    else:
        c_struct = c_min
        cB_U = np.zeros(len(U))
    y = np.zeros(m)
    y[r_u] = s_u * cB_U
    if k:
        rhs_d = c_struct[cols_S] - A_S[r_u].T @ y[r_u]
        y[R0] = lu_solve(lu, rhs_d, trans=1)

    if not (np.all(np.isfinite(x_S)) and np.all(np.isfinite(x_U))
            and np.all(np.isfinite(y))):
        return bad

    scale = 1.0 + (np.max(np.abs(b)) if m else 0.0)
    c_scale = 1.0 + (np.max(np.abs(c_struct)) if n else 0.0)

    prim_ok = np.all(x_S >= -tol * scale) and np.all(x_U >= -tol * scale)
    ub_S = ub[cols_S]
    fin_S = np.isfinite(ub_S)
    prim_ok = prim_ok and np.all(
        x_S[fin_S] <= ub_S[fin_S] + tol * scale)
    art_ok = not np.any(is_art_u & (np.abs(x_U) > tol * scale)) \
        if phase == 2 else True
    rc_struct = c_struct - y @ A         # (n,) — the one O(m·n) op
    rc_slack = -sign_slack * y           # live on inequality rows only
    # Dual sign test per bound status: basic columns have rc = 0 by
    # construction of y (satisfy both); fixed columns impose no sign.
    fixed = ub == 0.0
    lo_ok = at_up | fixed | (rc_struct >= -tol * c_scale)
    up_ok = ~at_up | (rc_struct <= tol * c_scale)
    dual_ok = np.all(lo_ok) and np.all(up_ok) and \
        np.all(rc_slack[is_ineq] >= -tol * c_scale)
    if phase == 1:
        dual_ok = dual_ok and np.all(1.0 - y >= -tol * c_scale)

    certified = bool(prim_ok and art_ok and dual_ok)
    x_struct = np.zeros(n)
    x_struct[cols_S] = x_S
    x_struct[at_up] = ub[at_up]
    if phase == 1:
        fun = float(cB_U @ x_U)          # sum of basic-artificial levels
    else:
        fun = float(c_min @ x_struct)
    return certified, x_struct, fun


def certify_sweep_le_f64(status: np.ndarray, basis: np.ndarray,
                         c, A, b, maximize, ub=None, at_upper=None,
                         tol: float = 1e-7):
    """Fully-VECTORIZED f64 certification for the all-<= sweep regime.

    The 1M-instance exact-sweep path (VERDICT r4 item 2): for batches
    whose rows are all ``<=`` with ``b >= 0`` (every generated benchmark
    sweep, and any user batch after sign normalization that stays <=),
    the standard form is ``[A | I]`` — so the basis matrix assembles
    directly from raw data (structural columns gathered from A, slack
    columns as unit vectors) and the whole KKT check runs as ONE batched
    LAPACK solve pair + one reduced-cost einsum.  No per-instance Python
    loop (``certify_and_escalate_raw`` costs ~1 ms/instance in pure
    Python — 17 min at 1M) and no (B, m, N) f64 standard form
    (``certify_and_escalate``'s assembly + copies cost ~50 s per 65k
    chunk; this path certifies the same chunk in ~3 s).

    Native bounds supported: ``b_eff = b - A u_U`` and the two-sided dual
    sign test, same KKT system as ``_certify_raw_instance_f64``.

    Returns the usual correction dict, or ``None`` when the batch does
    not meet the preconditions (caller falls through to the general
    certifiers).  Escalation of non-certified instances still routes to
    the exact host engine per instance (rare by construction).
    """
    from .dense import solve_lp_host_exact

    # A stays in its INPUT dtype: f32 problem data is exactly
    # representable in f64, so gathers from it lose nothing and the full
    # (B, m, n) f64 conversion (~0.8 GB at 65k x 30 x 50, one of the two
    # dominant costs of the first cut of this path) is never made —
    # float64 enters at the LU/einsum accumulators.
    A = np.asarray(A)
    b = np.asarray(b, np.float64)
    if np.any(b < 0.0):
        return None
    c = np.asarray(c, np.float64)
    status = np.asarray(status).copy()
    B_, m, n = A.shape
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B_,))
    c_min = np.where(maximize[:, None], -c, c)
    if ub is not None:
        ub = np.broadcast_to(np.asarray(ub, np.float64), (B_, n))

    with trace_span("certify.gather"):
        bidx = np.asarray(basis, np.int64)[:, :m]          # real rows only
        is_struct = bidx < n
        in_range = np.all(bidx < n + m, axis=1) & np.all(bidx >= 0, axis=1)
        safe_col = np.where(is_struct, bidx, 0)
        claimed_opt = status == STATUS_OPTIMAL
        check = claimed_opt & in_range

        # at-upper state restricted to structural columns; basic columns are
        # never at-upper.
        if ub is not None:
            at_up = (np.zeros((B_, n), bool) if at_upper is None
                     else np.asarray(at_upper, bool)[:, :n].copy())
            at_up &= np.isfinite(ub)
            bs = np.where(is_struct, safe_col, n)          # n = scratch slot
            at_up_ext = np.concatenate([at_up, np.zeros((B_, 1), bool)],
                                       axis=1)
            np.put_along_axis(at_up_ext, bs, False, axis=1)
            at_up = at_up_ext[:, :n]
            u_vec = np.where(at_up, ub, 0.0)
            b_eff = b - np.einsum("bmn,bn->bm", A, u_vec)
        else:
            at_up = None
            b_eff = b

        # Basis matrix straight from raw data: structural columns from A via
        # ONE flat fancy-index gather (take_along_axis on the 3-D view
        # measured ~4 s per 65k chunk; the flat gather is ~5x faster), slack
        # columns as unit entries scattered flat instead of materializing a
        # (B, m, m) one-hot tensor.
        idt = np.int32 if B_ * m * n < 2**31 else np.int64
        gidx = ((np.arange(B_, dtype=idt)[:, None, None] * m
                 + np.arange(m, dtype=idt)[None, :, None]) * n
                + safe_col[:, None, :].astype(idt))
        Bmat = A.reshape(-1)[gidx].astype(np.float64)             # (B, m, m)
        Bmat *= is_struct[:, None, :]
        bb_i, ii = np.nonzero(~is_struct)
        unit_rows = bidx[bb_i, ii] - n
        ok_unit = (unit_rows >= 0) & (unit_rows < m)
        flat_pos = ((bb_i[ok_unit] * m + unit_rows[ok_unit]) * m
                    + ii[ok_unit])
        Bmat.reshape(-1)[flat_pos] = 1.0
        cB = np.where(is_struct,
                      np.take_along_axis(c_min, safe_col, axis=1), 0.0)

    with trace_span("certify.lapack"):
        xB = np.zeros((B_, m))
        y = np.zeros((B_, m))
        ok_solve = np.zeros((B_,), bool)
        idx = np.nonzero(check)[0]
        if idx.size:
            try:
                xB[idx] = np.linalg.solve(Bmat[idx], b_eff[idx][..., None])[..., 0]
                y[idx] = np.linalg.solve(np.swapaxes(Bmat[idx], 1, 2),
                                         cB[idx][..., None])[..., 0]
                ok_solve[idx] = True
            except np.linalg.LinAlgError:
                for i in idx:
                    try:
                        xB[i] = np.linalg.solve(Bmat[i], b_eff[i])
                        y[i] = np.linalg.solve(Bmat[i].T, cB[i])
                        ok_solve[i] = True
                    except np.linalg.LinAlgError:
                        pass
            ok_solve &= np.all(np.isfinite(xB), axis=1) \
                & np.all(np.isfinite(y), axis=1)

    with trace_span("certify.check"):
        scale = 1.0 + np.max(np.abs(b), axis=1, initial=0.0)
        c_scale = 1.0 + np.max(np.abs(c_min), axis=1, initial=0.0)
        prim_ok = ~np.any(xB < -tol * scale[:, None], axis=1)
        if ub is not None:
            # Basic structural variables must respect their own upper bound.
            ub_ext = np.concatenate([ub, np.full((B_, 1), np.inf)], axis=1)
            ub_B = np.take_along_axis(
                ub_ext, np.where(is_struct, safe_col, n), axis=1)
            fin = np.isfinite(ub_B)
            prim_ok &= ~np.any(fin & (xB > ub_B + tol * scale[:, None]), axis=1)

        # Dual: rc over structural columns (one einsum) + slack rc = -y.
        rc = c_min - np.einsum("bm,bmn->bn", y, A)         # (B, n)
        basic_mask = np.zeros((B_, n + 1), bool)
        np.put_along_axis(basic_mask, np.where(is_struct, safe_col, n),
                          True, axis=1)
        nonbasic = ~basic_mask[:, :n]
        if ub is not None:
            fixed = ub == 0.0
            lo_ok = np.all(
                ~(nonbasic & ~at_up & ~fixed)
                | (rc >= -tol * c_scale[:, None]), axis=1)
            up_ok = np.all(~(nonbasic & at_up)
                           | (rc <= tol * c_scale[:, None]), axis=1)
            dual_ok = lo_ok & up_ok
        else:
            dual_ok = np.all((~nonbasic) | (rc >= -tol * c_scale[:, None]),
                             axis=1)
        dual_ok &= np.all(y <= tol * c_scale[:, None], axis=1)  # slack rc = -y

        certified = check & ok_solve & prim_ok & dual_ok

        x = np.full((B_, n), np.nan)
        fun_out = np.full((B_,), np.nan)
        ci = np.nonzero(certified)[0]
        if ci.size:
            xs = np.zeros((len(ci), n + 1))
            np.put_along_axis(
                xs, np.where(is_struct[ci], safe_col[ci], n), xB[ci], axis=1)
            x_struct = np.maximum(xs[:, :n], 0.0)
            if at_up is not None:
                x_struct = np.where(at_up[ci], ub[ci], x_struct)
            x[ci] = x_struct
            fun_out[ci] = np.einsum("bn,bn->b", c_min[ci], x_struct)

    with trace_span("certify.escalate"):
        escalated = ~certified
        for i in np.nonzero(escalated)[0]:
            count_escalation()
            lp = LinearProgram(c=c[i], A=A[i], b=b[i],
                               ops=np.full(m, -1), maximize=bool(maximize[i]),
                               ub=(None if ub is None else ub[i]))
            res = solve_lp_host_exact(lp)
            status[i] = res.status
            if res.success:
                xi = np.asarray(res.x, np.float64)
                x[i, : min(n, xi.shape[0])] = xi[:n]
                fun_out[i] = res.fun
                certified[i] = True
            else:
                certified[i] = res.status in (STATUS_INFEASIBLE,
                                              STATUS_UNBOUNDED)

    return {
        "certified": certified,
        "escalated": escalated,
        "status": status,
        "x": x,
        "fun": fun_out,
        "z": np.where(maximize, -fun_out, fun_out) + 0.0,
    }


def certify_and_escalate_raw(status: np.ndarray, basis: np.ndarray,
                             c, A, b, ops, maximize,
                             tol: float = 1e-7,
                             make_lp: Optional[Callable[
                                 [int], LinearProgram]] = None,
                             ub=None, at_upper=None):
    """Certify + escalate a uniform batch's verdicts from RAW data.

    The large-m twin of :func:`certify_and_escalate`: no f64 standard-form
    tableau is built (at m=16k that alone is ~4 GB), and each instance's
    KKT systems collapse to a k×k solve via
    :func:`_certify_raw_instance_f64`.  ``basis`` may carry padded rows
    (entries >= n + 2m are padding unit columns and are ignored; only the
    first m rows' columns define the basis).  Same return contract as
    :func:`certify_and_escalate`.
    """
    from .dense import solve_lp_host_exact

    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    ops = np.asarray(ops, np.int64)
    status = np.asarray(status).copy()
    B_, m, n = A.shape
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B_,))
    if ub is not None:
        ub = np.broadcast_to(np.asarray(ub, np.float64), (B_, n))
    if make_lp is None:
        def make_lp(i):
            return LinearProgram(
                c=c[i], A=A[i], b=b[i],
                ops=ops if ops.ndim == 1 else ops[i],
                maximize=bool(maximize[i]),
                ub=(None if ub is None else ub[i]))

    certified = np.zeros((B_,), bool)
    escalated = np.zeros((B_,), bool)
    x = np.full((B_, n), np.nan)
    fun_out = np.full((B_,), np.nan)

    for i in range(B_):
        ops_i = ops if ops.ndim == 1 else ops[i]
        # Row normalization — identical to compile_batch_uniform.
        neg = b[i] < 0
        A_i = np.where(neg[:, None], -A[i], A[i])
        b_i = np.where(neg, -b[i], b[i])
        ops_n = np.where(neg, -ops_i, ops_i)
        c_min = -c[i] if maximize[i] else c[i]
        bidx = np.asarray(basis[i], np.int64)[:m]
        ub_i = None if ub is None else ub[i]
        up_i = None if at_upper is None else \
            np.asarray(at_upper[i], bool)[:n]

        st = int(status[i])
        if st == STATUS_OPTIMAL:
            ok, x_s, fun = _certify_raw_instance_f64(
                c_min, A_i, b_i, ops_n, bidx, phase=2, tol=tol,
                ub=ub_i, at_up=up_i)
            if ok:
                certified[i] = True
                x[i] = np.maximum(x_s, 0.0)
                fun_out[i] = fun
                continue
        elif st == STATUS_INFEASIBLE:
            ok, _, fun1 = _certify_raw_instance_f64(
                c_min, A_i, b_i, ops_n, bidx, phase=1, tol=tol,
                ub=ub_i, at_up=up_i)
            scale = 1.0 + (np.max(np.abs(b_i)) if m else 0.0)
            if ok and fun1 > tol * scale:
                certified[i] = True      # Farkas certificate holds
                continue
        # Unbounded / iteration-limit claims, and anything the certificates
        # above could not prove, go to the exact host engine.
        with trace_span("certify.escalate"):
            escalated[i] = True
            count_escalation()
            res = solve_lp_host_exact(make_lp(int(i)))
            status[i] = res.status
            if res.success:
                xi = np.asarray(res.x, np.float64)
                x[i, : min(n, xi.shape[0])] = xi[:n]
                fun_out[i] = res.fun
                certified[i] = True
            else:
                certified[i] = res.status in (STATUS_INFEASIBLE,
                                              STATUS_UNBOUNDED)

    return {
        "certified": certified,
        "escalated": escalated,
        "status": status,
        "x": x,
        "fun": fun_out,
        "z": np.where(maximize, -fun_out, fun_out) + 0.0,
    }


def certify_and_escalate(status: np.ndarray, basis: np.ndarray,
                         A_std: np.ndarray, b_std: np.ndarray,
                         c_std: np.ndarray, art_mask: np.ndarray,
                         valid_mask: np.ndarray,
                         make_lp: Callable[[int], LinearProgram],
                         maximize: np.ndarray, n_vars: int,
                         tol: float = 1e-7,
                         c1_std: Optional[np.ndarray] = None,
                         mask_p1: Optional[np.ndarray] = None):
    """Certify a batch's verdicts and exactly re-solve the untrusted ones.

    ``make_lp(i)`` must build the i-th instance's :class:`LinearProgram` in
    the SAME space the batch was solved in (bounds already lowered, free
    variables already split), so escalated solutions line up column-for-
    column with the batch arrays.

    ``c1_std``/``mask_p1`` (raw phase-1 costs + phase-1 column mask): when
    given, claimed-infeasible instances are first checked against the
    vectorized Farkas certificate (:func:`certify_infeasible_f64`); only
    the ones it cannot certify fall through to the host re-solve.

    Returns a dict of per-instance corrections:
      ``certified`` (B,) bool — every True verdict passed an f64 KKT check
        (directly or via exact host re-solve);
      ``escalated`` (B,) bool — instances re-solved by the host engine;
      ``status``/``x``/``fun`` — corrected arrays (x is (B, n_vars), NaN
        where not optimal).
    """
    from .dense import solve_lp_host_exact

    status = np.asarray(status).copy()
    B_ = status.shape[0]
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B_,))

    claimed_opt = status == STATUS_OPTIMAL
    certified, x_full, fun = certify_bases_f64(
        A_std, b_std, c_std, art_mask, valid_mask, basis,
        check=claimed_opt, tol=tol)

    claimed_inf = status == STATUS_INFEASIBLE
    inf_certified = np.zeros((B_,), bool)
    if c1_std is not None and mask_p1 is not None and np.any(claimed_inf):
        inf_certified = certify_infeasible_f64(
            A_std, b_std, c1_std, mask_p1, basis, check=claimed_inf,
            tol=tol)

    # Untrusted: optimal-but-uncertified, plus every terminal non-optimal
    # claim the certificates above couldn't prove (an f32 'infeasible' can
    # be drift; 'unbounded' can be a fake eligible column; iteration-limit
    # may be a numeric stall).
    escalate = (claimed_opt & ~certified) | (claimed_inf & ~inf_certified) \
        | np.isin(status, (STATUS_UNBOUNDED, STATUS_ITERATION_LIMIT))

    x = np.full((B_, n_vars), np.nan)
    fun_out = np.full((B_,), np.nan)
    ok = certified | inf_certified
    if np.any(certified):
        ci = np.nonzero(certified)[0]
        x[ci] = np.maximum(x_full[ci, :n_vars], 0.0)
        fun_out[ci] = fun[ci]

    with trace_span("certify.escalate"):
        for i in np.nonzero(escalate)[0]:
            count_escalation()
            res = solve_lp_host_exact(make_lp(int(i)))
            status[i] = res.status
            if res.success:
                xi = np.asarray(res.x, np.float64)
                x[i, : xi.shape[0]] = xi[:n_vars]
                fun_out[i] = res.fun
                ok[i] = True
            else:
                ok[i] = res.status in (STATUS_INFEASIBLE, STATUS_UNBOUNDED)

    return {
        "certified": ok,
        "escalated": escalate,
        "status": status,
        "x": x,
        "fun": fun_out,
        "z": np.where(maximize, -fun_out, fun_out) + 0.0,
    }
