"""A plain dense simplex in PyTorch, batched over LPs.

Solves ``max c.x  s.t.  A x <= b,  0 <= x <= ub`` with ``b >= 0`` from the
slack basis, by Dantzig's rule on the condensed (Tucker) tableau: one row a
basic variable, one column a nonbasic one, so an LP of m rows and n
variables needs an (m + 1) x (n + 1) array whatever its shape.  Finite upper
bounds become rows ``x_j <= ub_j``; an infinite one a vacuous row ``0 <= 1``
that never enters a ratio test, so every LP of a batch keeps one shape.

It shares no code and no data with the program: it is the reference the
program's answers are judged against.  ``precision`` picks the arithmetic:
``"float64"`` for the reference, ``"tf32"`` for the control (float32 with
both factors of every update rounded to TF32's 10-bit mantissa, as a
TF32 matrix product rounds them).
"""
from __future__ import annotations

import numpy as np
import torch

OPTIMAL, ITERATION_LIMIT, UNBOUNDED = 0, 1, 3

# Tolerances by arithmetic: the reduced cost a column needs to enter and
# the pivot a row needs to leave.
_TOL = {"float64": 1e-9, "tf32": 1e-6}
# Steps between two host reads of whether any LP still runs: a read waits
# for the card, and a finished LP's steps are masked no-ops.
_CHECK_EVERY = 16


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to
    nearest, as the tensor cores read a TF32 product's factors."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tableau(c, A, b, ub, dtype, device):
    """The condensed tableau, its basic and nonbasic labels.  Labels:
    0..n-1 the variables, n..n+m'-1 the slacks of the m' rows."""
    c = torch.as_tensor(np.asarray(c, np.float64), device=device)
    A = torch.as_tensor(np.asarray(A, np.float64), device=device)
    b = torch.as_tensor(np.asarray(b, np.float64), device=device)
    B, m, n = A.shape
    if ub is not None:
        ub = torch.as_tensor(np.asarray(ub, np.float64), device=device)
        finite = torch.isfinite(ub)
        eye = torch.eye(n, dtype=A.dtype, device=device).expand(B, n, n)
        A = torch.cat([A, eye * finite[:, :, None]], 1)
        b = torch.cat([b, torch.where(finite, ub, 1.0)], 1)
    rows = A.shape[1]
    M = torch.zeros((B, rows + 1, n + 1), dtype=torch.float64, device=device)
    M[:, :rows, :n] = A
    M[:, :rows, n] = b
    M[:, rows, :n] = -c
    basic = torch.arange(n, n + rows, device=device).expand(B, rows).clone()
    nonbasic = torch.arange(n, device=device).expand(B, n).clone()
    return M.to(dtype), basic, nonbasic


def solve(c, A, b, ub=None, precision: str = "float64", device="cpu",
          max_iters: int = None):
    """Solve a batch: ``c`` (B, n), ``A`` (B, m, n), ``b`` (B, m), ``ub``
    (B, n) with ``inf`` where unbounded, or None.

    Returns numpy float64 arrays: ``status`` (B,) (0 optimal, 1 iteration
    limit, 3 unbounded), ``x`` (B, n), ``z`` (B,), ``y`` (B, m) the duals of
    the rows of ``A`` (dz/db), ``rc`` (B, n) the reduced costs (dz/dx_j of a
    nonbasic variable, 0 for a basic one); NaN where not optimal.
    """
    dtype = torch.float64 if precision == "float64" else torch.float32
    tol = _TOL[precision]
    M, basic, nonbasic = _tableau(c, A, b, ub, dtype, device)
    B, R1, N1 = M.shape
    rows, n = R1 - 1, N1 - 1
    m = np.shape(A)[1]
    if max_iters is None:
        max_iters = 20 * (rows + n)
    status = torch.full((B,), -1, dtype=torch.int64, device=device)
    ar = torch.arange(B, device=device)
    for it in range(max_iters):
        running = status < 0
        if it % _CHECK_EVERY == 0 and not bool(running.any()):
            break
        obj = M[:, rows, :n]
        j = torch.argmin(obj, 1)
        enter = obj[ar, j] < -tol
        col = M[ar, :rows, j]                       # (B, rows)
        ok = col > tol
        ratio = torch.where(ok, M[:, :rows, n] / torch.where(ok, col, 1.0),
                            torch.inf)
        i = torch.argmin(ratio, 1)
        bounded = ok.any(1)
        status = torch.where(running & ~enter, OPTIMAL, status)
        status = torch.where(running & enter & ~bounded, UNBOUNDED, status)
        go = running & enter & bounded
        # The exchange of basic row i and nonbasic column j.
        p = M[ar, i, j]
        p = torch.where(go, p, 1.0)
        prow = M[ar, i, :] / p[:, None]             # (B, N1)
        pcol = M[ar, :, j]                          # (B, R1)
        if precision == "tf32":
            upd = _tf32(pcol)[:, :, None] * _tf32(prow)[:, None, :]
        else:
            upd = pcol[:, :, None] * prow[:, None, :]
        new = M - upd
        new[ar, :, j] = -pcol / p[:, None]
        new[ar, i, :] = prow
        new[ar, i, j] = 1.0 / p
        M = torch.where(go[:, None, None], new, M)
        bi, nj = basic[ar, i], nonbasic[ar, j]
        basic[ar, i] = torch.where(go, nj, bi)
        nonbasic[ar, j] = torch.where(go, bi, nj)
    status = torch.where(status < 0, ITERATION_LIMIT, status)

    M64 = M.double()
    full = torch.zeros((B, n + rows), dtype=torch.float64, device=device)
    full.scatter_(1, basic, M64[:, :rows, n])
    x = full[:, :n]
    dual = torch.zeros((B, n + rows), dtype=torch.float64, device=device)
    dual.scatter_(1, nonbasic, M64[:, rows, :n])
    y = dual[:, n:n + m]
    rc = -dual[:, :n]
    z = M64[:, rows, n]
    ok = (status == OPTIMAL)
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=device)
    out = {"status": status,
           "x": torch.where(ok[:, None], x, nan),
           "z": torch.where(ok, z, nan),
           "y": torch.where(ok[:, None], y, nan),
           "rc": torch.where(ok[:, None], rc, nan)}
    return {k: v.cpu().numpy() for k, v in out.items()}
