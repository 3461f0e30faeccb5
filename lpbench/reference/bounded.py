"""A plain bounded simplex in PyTorch, batched over LPs: the reference of
cells whose variables keep their upper bounds as bounds.

Solves ``max c.x  s.t.  A x <= b,  0 <= x <= ub`` with ``b >= 0`` (``ub``
may hold +inf) from the slack basis by the textbook upper-bounding simplex
(V. Chvátal, *Linear Programming*, 1983, ch. 8) on the condensed (Tucker)
tableau: one row a basic variable, one column a nonbasic one, so an LP of
m rows and n variables needs an (m + 1) x (n + 1) array, bounded or not
(``simplex.py`` turns each finite bound into a row instead, which at 30 x
500 makes a 531 x 501 tableau).  A step enters the column with the most
negative reduced cost (Dantzig's rule); the ratio test stops a basic
variable at 0 or at its own upper bound; where the entering variable's own
bound comes first, it flips to that bound and the basis stays.

Departures from the textbook, none of which changes the optimum it finds:

* a variable at its upper bound is kept complemented, ``x' = u - x`` (its
  column and the right-hand side rewritten), so that every nonbasic
  variable of the tableau sits at 0 and one exchange rule serves every
  step: a flip complements the entering column, and a basic variable that
  leaves at its upper bound complements its row before the exchange;
* each row of ``A`` and ``b`` is divided by its largest ``|a_ij|``, and
  ``c`` by its largest ``|c_j|``, before the solve, so that the
  tolerances are relative to the data (``x`` is unchanged; ``z`` is scaled
  back);
* a rounding residue below 0 in ``x_B`` or in ``u_B - x_B`` counts as 0 in
  the ratio test, and ties go to the lowest index;
* LPs are solved in blocks of ``block`` at once, an LP that has stopped
  taking masked no-op steps, and one still running after ``max_iters``
  steps reports the iteration limit.

It shares no code and no data with the program: it is the reference the
program's answers are judged against.  ``precision`` picks the arithmetic,
as in ``simplex.py``: ``"float64"`` for the reference, ``"tf32"`` for the
control (float32 with both factors of every update rounded to TF32's
10-bit mantissa).
"""
from __future__ import annotations

import numpy as np
import torch

from .simplex import ITERATION_LIMIT, OPTIMAL, UNBOUNDED, _tf32

# Tolerances by arithmetic, on the scaled data: the reduced cost a column
# needs to enter and the entry a row needs to take part in the ratio test.
_TOL = {"float64": 1e-9, "tf32": 1e-6}
# Steps between two host reads of whether any LP still runs.
_CHECK_EVERY = 16
# LPs a block: a float64 block of 30 x 500 LPs holds 1 GB of tableau.
BLOCK = 8192


def _nonzero(v):
    return torch.where(v > 0, v, torch.ones_like(v))


def _solve_block(c, A, b, ub, precision, device, max_iters):
    dtype = torch.float64 if precision == "float64" else torch.float32
    tol = _TOL[precision]

    def t64(a):
        return torch.as_tensor(np.array(a, np.float64), device=device)

    A, b, c = t64(A), t64(b), t64(c)
    B, m, n = A.shape
    u = (torch.full((B, n), torch.inf, dtype=torch.float64, device=device)
         if ub is None else t64(np.broadcast_to(ub, (B, n))))
    row_scale = _nonzero(A.abs().amax(2))
    c_scale = _nonzero(c.abs().amax(1))
    M = torch.zeros((B, m + 1, n + 1), dtype=torch.float64, device=device)
    M[:, :m, :n] = A / row_scale[:, :, None]
    M[:, :m, n] = b / row_scale
    M[:, m, :n] = -c / c_scale[:, None]
    M = M.to(dtype)
    del A
    # Labels 0..n-1 the variables, n..n+m-1 the slacks: their bounds, and
    # whether each is held complemented.
    lab_u = torch.cat([u, torch.full((B, m), torch.inf, dtype=torch.float64,
                                     device=device)], 1).to(dtype)
    comp = torch.zeros((B, n + m), dtype=torch.bool, device=device)
    basic = torch.arange(n, n + m, device=device).expand(B, m).clone()
    nonbasic = torch.arange(n, device=device).expand(B, n).clone()
    status = torch.full((B,), -1, dtype=torch.int64, device=device)
    ar = torch.arange(B, device=device)
    inf = torch.inf
    for it in range(max_iters):
        running = status < 0
        if it % _CHECK_EVERY == 0 and not bool(running.any()):
            break
        obj = M[:, m, :n]
        j = torch.argmin(obj, 1)
        enter = obj[ar, j] < -tol
        colf = M[ar, :, j]                          # (B, m + 1)
        col, xB = colf[:, :m], M[:, :m, n]
        uB = lab_u.gather(1, basic)
        jl = nonbasic[ar, j]
        uj = lab_u[ar, jl]
        dec = col > tol                             # x_B falls to 0
        inc = (col < -tol) & torch.isfinite(uB)     # x_B rises to u_B
        t_dec = torch.where(dec, xB.clamp_min(0) / torch.where(dec, col, 1.0),
                            inf)
        t_inc = torch.where(inc, (uB - xB).clamp_min(0)
                            / torch.where(inc, -col, 1.0), inf)
        t = torch.minimum(t_dec, t_inc)
        i = torch.argmin(t, 1)
        t_min = t[ar, i]
        unbounded = torch.isinf(t_min) & torch.isinf(uj)
        flip = torch.isfinite(uj) & (uj <= t_min)
        status = torch.where(running & ~enter, OPTIMAL, status)
        status = torch.where(running & enter & unbounded, UNBOUNDED, status)
        go = running & enter & ~unbounded
        do_flip = go & flip
        do_piv = go & ~flip

        # Bound flip: x_j goes to its other bound, column j is complemented.
        M[:, :, n] -= colf * torch.where(do_flip, uj, 0.0)[:, None]
        M[ar, :, j] = torch.where(do_flip[:, None], -colf, colf)
        comp[ar, jl] ^= do_flip

        # A basic variable that leaves at its upper bound is complemented
        # first, so that it leaves at 0.
        up = do_piv & (t_inc[ar, i] < t_dec[ar, i])
        row = M[ar, i, :]
        crow = -row
        crow[:, n] = uB[ar, i] - row[:, n]
        M[ar, i, :] = torch.where(up[:, None], crow, row)
        bi = basic[ar, i]
        comp[ar, bi] ^= up

        # The exchange of basic row i and nonbasic column j.
        p = torch.where(do_piv, M[ar, i, j], 1.0)
        prow = M[ar, i, :] / p[:, None]             # (B, n + 1)
        pcol = torch.where(do_piv[:, None], M[ar, :, j], 0.0)
        if precision == "tf32":
            M.addcmul_(_tf32(pcol)[:, :, None], _tf32(prow)[:, None, :],
                       value=-1.0)
        else:
            M.addcmul_(pcol[:, :, None], prow[:, None, :], value=-1.0)
        M[ar, i, :] = torch.where(do_piv[:, None], prow, M[ar, i, :])
        M[ar, :, j] = torch.where(do_piv[:, None], -pcol / p[:, None],
                                  M[ar, :, j])
        M[ar, i, j] = torch.where(do_piv, 1.0 / p, M[ar, i, j])
        basic[ar, i] = torch.where(do_piv, jl, bi)
        nonbasic[ar, j] = torch.where(do_piv, bi, jl)
    status = torch.where(status < 0, ITERATION_LIMIT, status)

    M64 = M.double()
    val = torch.zeros((B, n + m), dtype=torch.float64, device=device)
    val.scatter_(1, basic, M64[:, :m, n])
    u64 = lab_u.double()
    x = torch.where(comp, u64 - val, val)[:, :n]
    z = M64[:, m, n] * c_scale
    # The objective row over the nonbasic labels: a slack's entry is its
    # row's dual, a variable's minus its reduced cost (dz/dx, whose sign a
    # complemented variable turns), in the scaled data.
    dual = torch.zeros((B, n + m), dtype=torch.float64, device=device)
    dual.scatter_(1, nonbasic, M64[:, m, :n])
    y = dual[:, n:] * c_scale[:, None] / row_scale
    rc = torch.where(comp[:, :n], dual[:, :n], -dual[:, :n]) \
        * c_scale[:, None]
    ok = status == OPTIMAL
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=device)
    out = {"status": status,
           "x": torch.where(ok[:, None], x, nan),
           "z": torch.where(ok, z, nan),
           "y": torch.where(ok[:, None], y, nan),
           "rc": torch.where(ok[:, None], rc, nan)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def solve(c, A, b, ub=None, precision: str = "float64", device="cpu",
          max_iters: int = None, block: int = BLOCK):
    """Solve a batch: ``c`` (B, n), ``A`` (B, m, n), ``b`` (B, m) with
    ``b >= 0``, ``ub`` (B, n) or (n,) with ``inf`` where unbounded, or
    None.

    Returns numpy arrays: ``status`` (B,) (0 optimal, 1 iteration limit, 3
    unbounded), and in float64, NaN where not optimal, ``x`` (B, n), ``z``
    (B,), ``y`` (B, m) the duals of the rows of ``A`` (dz/db) and ``rc``
    (B, n) the reduced costs (dz/dx_j of a nonbasic variable, 0 for a basic
    one)."""
    B, m, n = np.shape(A)
    if max_iters is None:
        max_iters = 20 * (m + n)
    parts = [_solve_block(c[s:s + block], A[s:s + block], b[s:s + block],
                          ub if ub is None or np.ndim(ub) == 1
                          else ub[s:s + block], precision, device, max_iters)
             for s in range(0, B, block)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
