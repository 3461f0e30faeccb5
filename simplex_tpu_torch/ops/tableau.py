"""Dense tableau simplex on torch tensors (port of ``simplex_tpu/ops/tableau.py``).

The main-path subset of the JAX module: pricing and the ratio test
(:func:`select_pivot`), the rank-1 pivot through kernel K1
(:func:`pivot_update`), exact refactorization, the Devex weights, the
two-phase loop (:func:`solve_tableau`), solution extraction and the
history-recording solve behind the reports (:func:`solve_tableau_history`).

Tableau convention (min form), as in the reference: ``T[:-1]`` are the
constraint rows with the RHS in the last column; ``T[-1]`` holds the
reduced costs with ``T[-1, -1] == -z``.

Differences from the JAX module, all deliberate:

* The tableau is updated IN PLACE (the pivot, the objective install and
  the refactor write into ``T``), which saves the copy a functional update
  makes.  :func:`solve_tableau` clones its input once and leaves it intact.
* The ``lax.while_loop`` becomes a host loop over chunks of device steps.
  Each step is branch-free on the device: pricing, the masked Devex update
  and K1 read a 0-d ``do_pivot`` flag instead of branching, so nothing is
  read back to the host per pivot.  The host reads the loop state once per
  chunk and takes the accept / refactor decision there, which puts every
  refactor on the same pivot count as the JAX loop.
* ``basis`` is int64 (torch's index type); the JAX package keeps int32.
* ``newton_resync`` is not ported: the exact refactor (``torch.linalg``)
  has no size limit on the card.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..core.problem import (
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
    StandardForm,
)
from .pivot_kernel import pivot_update_

RUNNING = -1  # internal sentinel while the pivot loop is active

_INT_MAX = int(np.iinfo(np.int32).max)


def state_from_standard_form(sf: StandardForm, device, dtype) -> Dict:
    """The compiled standard form as the port's tensors on ``device``.

    Returns the keyword arguments :func:`solve_tableau` takes for the
    arrays: ``T0`` and the objective rows cast to ``dtype``, ``basis0`` as
    int64, the column masks as bool.
    """
    def f(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return {
        "T0": f(sf.tableau).contiguous(),
        "basis0": torch.as_tensor(np.asarray(sf.basis, np.int64),
                                  device=device),
        "col_mask_p1": torch.as_tensor(np.asarray(sf.col_mask_p1, bool),
                                       device=device),
        "col_mask_p2": torch.as_tensor(np.asarray(sf.col_mask_p2, bool),
                                       device=device),
        "obj_row_p1": f(sf.obj_row_p1),
        "obj_row_p2": f(sf.obj_row_p2),
    }


def _full(value, dtype, device):
    """0-d device tensor without a host-to-device copy (a fill kernel)."""
    return torch.full((), value, dtype=dtype, device=device)


def select_pivot(T, basis, col_mask, tol, use_bland, weights=None):
    """Choose the entering column and leaving row.

    Returns 0-d tensors ``(s, r, optimal, unbounded)``; see the JAX
    function for the rules (Dantzig or Devex pricing, Bland's first
    eligible column, RHS-clamped Harris ratio test, Bland's smallest basis
    index among round-off ties).  ``use_bland`` is a 0-d bool tensor.
    Ties go to the lowest index, as in JAX: ``torch.argmax`` and
    ``torch.argmin`` return the first extremum.
    """
    rc = torch.where(col_mask, T[-1, :-1], math.inf)
    eligible = rc < -tol

    if weights is None:
        s_price = torch.argmin(rc)
    else:
        score = torch.where(eligible, (rc * rc) / weights, -math.inf)
        s_price = torch.argmax(score)
    s_bland = torch.argmax(eligible.to(torch.int32))  # first eligible index
    s = torch.where(use_bland, s_bland, s_price)

    optimal = ~torch.any(eligible)

    col = T[:-1].index_select(1, s.reshape(1))[:, 0]
    rhs = T[:-1, -1]
    positive = col > tol
    # Never step backward: clamped, a tolerance-negative RHS row exits at
    # theta = 0 (see the JAX function).
    rhs_c = torch.clamp_min(rhs, 0.0)
    safe_col = torch.where(positive, col, 1.0)
    ratios = torch.where(positive, rhs_c / safe_col, math.inf)
    min_ratio = torch.min(ratios)
    unbounded = (~optimal) & torch.isinf(min_ratio)

    # Harris two-pass ratio test: the largest pivot among rows whose ratio
    # fits under the tol-relaxed minimum.
    delta = tol * (1.0 + torch.abs(rhs))
    theta_relax = torch.where(positive, (rhs_c + delta) / safe_col, math.inf)
    theta_max = torch.min(theta_relax)
    cand = positive & (ratios <= theta_max)
    r_harris = torch.argmax(torch.where(cand, col, -math.inf))

    # Bland mode: smallest basis index among round-off-level ratio ties.
    eps = torch.finfo(T.dtype).eps
    near = ratios <= min_ratio + 64.0 * eps * (1.0 + torch.abs(min_ratio))
    tie_key = torch.where(near & positive, basis, _INT_MAX)
    r_bland = torch.argmin(tie_key)
    r = torch.where(use_bland, r_bland, r_harris)
    return s, r, optimal, unbounded


def _set_basis_(basis, r, s, do_pivot):
    """``basis[r] = s`` where ``do_pivot``, in place, without a host sync."""
    rr = r.reshape(1)
    basis.index_copy_(0, rr, torch.where(do_pivot, s,
                                         basis.index_select(0, rr)[0])
                      .reshape(1))


def pivot_update(T, basis, r, s, clamp_rhs: bool = False, do_pivot=None):
    """Pivot on ``(r, s)`` IN PLACE through K1 and record ``basis[r] = s``.

    ``do_pivot`` (0-d bool tensor, default True) masks the whole step.
    Returns ``(T, basis)``, the same objects, updated.
    """
    if do_pivot is None:
        do_pivot = _full(True, torch.bool, T.device)
    pivot_update_(T, r, s, do_pivot, clamp_rhs=clamp_rhs)
    _set_basis_(basis, r, s, do_pivot)
    return T, basis


def refactor_tableau(T0_rows, basis, raw_obj):
    """Recompute the tableau exactly from the original rows and the basis.

    ``T_rows = B⁻¹ · T0_rows`` with ``B = T0_rows[:, basis]``, then the raw
    objective row priced out.  Returns ``(T_new, ok)``: ``ok`` is a 0-d
    bool tensor, False when ``B`` is singular or the result is not finite
    (``solve_ex`` reports instead of raising, so there is no host sync).
    """
    B = T0_rows.index_select(1, basis)
    T_rows, info = torch.linalg.solve_ex(B, T0_rows)
    obj = raw_obj - raw_obj.index_select(0, basis) @ T_rows
    T_new = torch.cat([T_rows, obj[None, :]], dim=0)
    ok = (info == 0) & torch.all(torch.isfinite(T_new))
    return T_new, ok


def _devex_update(w, T, basis, r, s):
    """Forrest-Goldfarb Devex weight update for pivot ``(r, s)`` (reads the
    pivot row BEFORE the pivot).  Returns new weights."""
    rr, ss = r.reshape(1), s.reshape(1)
    piv_row = T.index_select(0, rr)[0, :-1]
    alpha = piv_row / piv_row.index_select(0, ss)
    w_s = w.index_select(0, ss)
    w_new = torch.maximum(w, (alpha * alpha) * w_s)
    j_out = basis.index_select(0, rr)
    w_new = w_new.index_put((j_out,), torch.clamp_min(w_s, 1.0))
    w_new = w_new.index_put((ss,), torch.ones_like(w_s))
    return torch.where(torch.max(w_new) > 1e8, torch.ones_like(w_new), w_new)


def _run_phase(T, basis, col_mask, T0_rows, raw_obj, tol, max_iters,
               bland_after, refactor_every, iters0: int, devex: bool = False):
    """Pivot until optimal / unbounded / iteration cap, in place on ``T``.

    The JAX loop's per-iteration three-way switch (accept, refactor, pivot)
    is split between the device and the host:

    * a chunk of ``refactor_every - since_ref + 1`` device steps only ever
      pivots.  A step pivots when there is no verdict, the refactor period
      has room, and neither the iteration cap nor the stall cutoff is hit.
      Otherwise the step is a no-op, and since a no-op leaves the state as
      it was, every later step of the chunk is one too;
    * once per chunk the host reads the state (one sync) and takes the
      JAX loop's non-pivot branch: accept a verdict from a freshly
      refactorized tableau (or after 3 stalled confirms), otherwise
      refactorize, for a verdict ("confirm before exit") or for the period.

    Returns ``(T, basis, iters, status)`` with host ints.
    """
    dev, dt = T.device, T.dtype
    i64 = torch.int64
    stall_limit = bland_after + 1024
    w = torch.ones((T.shape[1] - 1,), dtype=dt, device=dev)
    iters = _full(iters0, i64, dev)
    since_ref = _full(1, i64, dev)  # first verdict is confirmed too
    stall = _full(0, i64, dev)
    no_imp = _full(0, i64, dev)
    best = _full(math.inf, dt, dev)
    since0 = 1

    def improved_since(best_):
        obj = -T[-1, -1]
        return obj < best_ - tol * (1.0 + torch.abs(best_)), obj

    while True:
        for _ in range(refactor_every - since0 + 1):
            use_bland = no_imp >= bland_after
            s, r, optimal, unbounded = select_pivot(
                T, basis, col_mask, tol, use_bland,
                weights=w if devex else None)
            want_stop = optimal | unbounded
            do = ((~want_stop) & (since_ref < refactor_every)
                  & (iters < max_iters) & (no_imp < stall_limit))
            if devex:
                w = torch.where(do, _devex_update(w, T, basis, r, s), w)
            pivot_update(T, basis, r, s, clamp_rhs=True, do_pivot=do)
            step = do.to(i64)
            since_ref = since_ref + step
            iters = iters + step
            improved, obj = improved_since(best)
            no_imp = torch.where(improved, 0, no_imp + step)
            stall = torch.where(improved, 0, stall)
            best = torch.minimum(best, obj)

        want, opt, it, ni, st, sr = torch.stack([
            want_stop.to(i64), optimal.to(i64), iters, no_imp, stall,
            since_ref]).tolist()
        if it >= max_iters or ni >= stall_limit:
            status = STATUS_ITERATION_LIMIT
            break
        if want and (sr == 0 or st >= 3):
            status = STATUS_OPTIMAL if opt else STATUS_UNBOUNDED
            break
        # Refactor branch: for a verdict (confirm) or for the period.
        T_new, ok = refactor_tableau(T0_rows, basis, raw_obj)
        T.copy_(torch.where(ok, T_new, T))
        improved, obj = improved_since(best)
        stall = torch.where(improved, 0, stall + int(bool(want)))
        no_imp = torch.where(improved, 0, no_imp)
        best = torch.minimum(best, obj)
        since_ref = _full(0, i64, dev)
        since0 = 0
    return T, basis, it, status


def _price_out(T, basis, obj_row):
    """Install ``obj_row`` as the objective row, priced out against the
    basis, IN PLACE.  Returns ``T``."""
    basis_costs = obj_row.index_select(0, basis)
    T[-1].copy_(obj_row - basis_costs @ T[:-1])
    return T


def _evict_artificials(T, basis, art_mask_ext, col_mask_p2, tol):
    """Pivot basic artificials out of the basis where possible (in place).

    A pivot in row ``i`` changes only ``basis[i]``, so the rows that hold an
    artificial are known from the incoming basis: one host read, then one
    unclamped pivot per such row, masked on the device when the row has no
    eligible real column (a redundant row, left in place).
    """
    art_rows = torch.nonzero(art_mask_ext.index_select(0, basis))[:, 0]
    for i in art_rows.tolist():
        row = T[i, :-1]
        cand = col_mask_p2 & (torch.abs(row) > tol)
        # Largest-magnitude eligible entry (pivot size is numerical hygiene).
        j = torch.argmax(torch.where(cand, torch.abs(row), -math.inf))
        pivot_update(T, basis, _full(i, torch.int64, T.device), j,
                     do_pivot=torch.any(cand))
    return T, basis


def solve_tableau(T0, basis0, col_mask_p1, col_mask_p2, obj_row_p1,
                  obj_row_p2, need_phase1: bool, tol: float = 1e-6,
                  max_iters: int = 16384, bland_after: int = 2048,
                  feas_tol: float = 1e-5, refactor_every: int = 64,
                  devex: bool = False):
    """Full two-phase dense simplex on one padded tableau.

    ``T0`` is left intact (it is the refactorization anchor); the solve
    works on one clone.  Returns ``(T, basis, status, iters)`` with
    scipy-compatible status codes (0 optimal, 1 iteration limit,
    2 infeasible, 3 unbounded) as host ints.
    """
    T = T0.clone()
    basis = basis0.to(torch.int64).clone()
    T0_rows = T0[:-1]

    if need_phase1:
        b_scale = 1.0 + torch.max(torch.abs(T0[:-1, -1]))
        T, basis, iters, status = _run_phase(
            T, basis, col_mask_p1, T0_rows, obj_row_p1, tol, max_iters,
            bland_after, refactor_every, 0, devex=devex)
        infeasible = bool(-T[-1, -1] > feas_tol * b_scale)
        art_mask_ext = torch.cat([col_mask_p1 & ~col_mask_p2,
                                  torch.zeros((1,), dtype=torch.bool,
                                              device=T.device)])
        T, basis = _evict_artificials(T, basis, art_mask_ext, col_mask_p2,
                                      tol)
        hard_fail = status != STATUS_OPTIMAL
    else:
        iters, infeasible, hard_fail = 0, False, False
        status = STATUS_OPTIMAL

    _price_out(T, basis, obj_row_p2)
    T, basis, iters2, status2 = _run_phase(
        T, basis, col_mask_p2, T0_rows, obj_row_p2, tol, max_iters,
        bland_after, refactor_every, iters, devex=devex)

    if infeasible:
        final_status = STATUS_INFEASIBLE
    else:
        final_status = status if hard_fail else status2
    return T, basis, final_status, iters2


def extract_solution(T, basis, n_vars: int):
    """Decision variables and the min-form objective from a tableau
    (0-d / 1-d tensors on the tableau's device)."""
    rhs = T[:-1, -1]
    onehot = basis[:, None] == torch.arange(n_vars, device=T.device)[None, :]
    x = torch.sum(torch.where(onehot, rhs[:, None], 0.0), dim=0)
    z_min = -T[-1, -1]
    return x, z_min


def solve_tableau_history(T0, basis0, col_mask_p1, col_mask_p2, obj_row_p2,
                          need_phase1: bool, tol: float = 1e-6,
                          max_steps: int = 64, bland_after: int = 2048,
                          feas_tol: float = 1e-5, devex: bool = False):
    """Two-phase solve that records every pivot (presentation path).

    The same pricing, Devex weights, stall-gated Bland switch and phase-1
    verdict as :func:`solve_tableau`, over ``max_steps`` steps a phase.  It
    serves small problems only and reads the state back every step.
    Returns ``(T, basis, status, snapshots, pivots, valid)`` as in the JAX
    function: ``snapshots[k]`` is the tableau BEFORE step k, ``pivots[k]``
    its ``(row, col)`` (``-1`` when no pivot) and ``valid[k]`` whether it
    pivoted.
    """
    dev, dt = T0.device, T0.dtype
    inf_ = _full(math.inf, dt, dev)

    def run(T, basis, status, iters, col_mask):
        w = torch.ones((T.shape[1] - 1,), dtype=dt, device=dev)
        best, no_imp = inf_, 0
        snaps, pivots, valid = [], [], []
        for _ in range(max_steps):
            s, r, optimal, unbounded = select_pivot(
                T, basis, col_mask, tol,
                _full(no_imp >= bland_after, torch.bool, dev),
                weights=w if devex else None)
            snaps.append(T.clone())
            do = False
            if status == RUNNING:
                if bool(optimal):
                    status = STATUS_OPTIMAL
                elif bool(unbounded):
                    status = STATUS_UNBOUNDED
                else:
                    do = True
            if do:
                if devex:
                    w = _devex_update(w, T, basis, r, s)
                pivot_update(T, basis, r, s, clamp_rhs=True)
            iters += int(do)
            obj = -T[-1, -1]
            improved = bool(obj < best - tol * (1.0 + torch.abs(best)))
            no_imp = 0 if improved else no_imp + int(do)
            best = torch.minimum(best, obj)
            pivots.append((int(r), int(s)) if do else (-1, -1))
            valid.append(do)
        return T, basis, status, iters, snaps, pivots, valid

    T = T0.clone()
    basis = basis0.to(torch.int64).clone()
    status, iters = RUNNING, 0
    snaps, pivots, valid = [], [], []
    if need_phase1:
        T, basis, status, iters, s1, p1, v1 = run(T, basis, status, iters,
                                                  col_mask_p1)
        snaps, pivots, valid = s1, p1, v1
        infeasible = bool(-T[-1, -1] > feas_tol * (
            1.0 + torch.max(torch.abs(T0[:-1, -1]))))
        art_mask_ext = torch.cat([col_mask_p1 & ~col_mask_p2,
                                  torch.zeros((1,), dtype=torch.bool,
                                              device=dev)])
        T, basis = _evict_artificials(T, basis, art_mask_ext, col_mask_p2,
                                      tol)
        if infeasible:
            status = STATUS_INFEASIBLE
        elif status == STATUS_OPTIMAL:
            status = RUNNING
    _price_out(T, basis, obj_row_p2)
    T, basis, status, iters, s2, p2, v2 = run(T, basis, status, iters,
                                              col_mask_p2)
    if status == RUNNING:
        status = STATUS_ITERATION_LIMIT
    return (T, basis, status, torch.stack(snaps + s2),
            torch.tensor(pivots + p2, dtype=torch.int64),
            torch.tensor(valid + v2, dtype=torch.bool))
