"""Dense tableau simplex on torch tensors (port of ``simplex_tpu/ops/tableau.py``).

Pricing and the ratio test (:func:`select_pivot`), the rank-1 pivot
through kernel K1 (:func:`pivot_update`), exact refactorization, the Devex
weights, the two-phase loop (:func:`solve_tableau`), the dual loops that
reoptimize from a dual-feasible basis (:func:`solve_tableau_dual`, and
:func:`solve_tableau_dual_bounded` with native upper bounds), solution
extraction and the history-recording solve behind the reports
(:func:`solve_tableau_history`).

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
  read back to the host per pivot.  On the card each chunk is one CUDA
  graph, replayed (``runtime/graphs.py``); on the CPU it runs eagerly.  A
  chunk stops after its first step that does not pivot, as the JAX loop's
  ``cond`` stops it: on the card the steps after a chunk's first are the
  body of a WHILE conditional node of its graph.
  The host reads the loop state once per chunk (counted in
  ``STATE_READS``) and takes the accept / refactor decision there, which
  puts every refactor on the same pivot count as the JAX loop.  The dual
  loops have the same shape.
* ``_gather_col_single`` (a one-hot matmul, which spares the TPU a lane
  gather) is an ``index_select``: the two agree for a finite tableau.
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
from ..runtime import counters, graphs
from .pivot_kernel import pivot_update_

RUNNING = -1  # internal sentinel while the pivot loop is active

_INT_MAX = int(np.iinfo(np.int32).max)

# Host reads of a solve loop's state since the counter was last reset to 0
# (one a chunk).
STATE_READS = 0


def _read(lp, *vals):
    """The host's one read of the loop state a chunk: 0-d tensors as ints
    (``graphs.Loop.read``)."""
    counters.add(globals(), "STATE_READS")
    return lp.read(*vals)


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


def _improved_below(T, best, tol):
    """Whether the objective ``-T[-1, -1]`` fell below ``best`` by more than
    the tolerance, and the objective."""
    obj = -T[-1, -1]
    return obj < best - tol * (1.0 + torch.abs(best)), obj


def _phase_chunk(st, cs, static, n_steps: int):
    """``n_steps`` device steps of :func:`_run_phase`'s loop, the chunk body
    that ``runtime/graphs.py`` runs eagerly or replays as one CUDA graph.
    Each step writes its state in place; a step runs only while the one
    before it pivoted (``go``), since a step that does not pivot leaves
    the state as it was."""
    tol, max_iters, bland_after, stall_limit, refactor_every, devex = static
    i64 = torch.int64
    T, basis, col_mask = st["T"], st["basis"], cs["col_mask"]
    for _ in graphs.steps(st, n_steps):
        w, iters, since_ref = st["w"], st["iters"], st["since_ref"]
        stall, no_imp, best = st["stall"], st["no_imp"], st["best"]
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
        improved, obj = _improved_below(T, best, tol)
        graphs.store(st, w=w, iters=iters + step,
                     since_ref=since_ref + step,
                     stall=torch.where(improved, 0, stall),
                     no_imp=torch.where(improved, 0, no_imp + step),
                     best=torch.minimum(best, obj), want_stop=want_stop,
                     optimal=optimal, go=do)


def _run_phase(T, basis, col_mask, T0_rows, raw_obj, tol, max_iters,
               bland_after, refactor_every, iters0: int, devex: bool = False):
    """Pivot until optimal / unbounded / iteration cap, in place on ``T``.

    The JAX loop's per-iteration three-way switch (accept, refactor, pivot)
    is split between the device and the host:

    * a chunk of ``refactor_every - since_ref + 1`` device steps
      (:func:`_phase_chunk`; one CUDA graph on the card) only ever pivots.
      A step pivots when there is no verdict, the refactor period has room,
      and neither the iteration cap nor the stall cutoff is hit.  Otherwise
      the step is a no-op, and since a no-op leaves the state as it was,
      every later step of the chunk would be one too: the chunk ends there,
      as the JAX loop's ``cond`` ends it;
    * once per chunk the host reads the state (one sync) and takes the
      JAX loop's non-pivot branch: accept a verdict from a freshly
      refactorized tableau (or after 3 stalled confirms), otherwise
      refactorize, for a verdict ("confirm before exit") or for the period.

    Returns ``(T, basis, iters, status)`` with host ints.
    """
    dev, dt = T.device, T.dtype
    i64 = torch.int64
    stall_limit = bland_after + 1024
    state = {"T": T, "basis": basis,
             "w": torch.ones((T.shape[1] - 1,), dtype=dt, device=dev),
             "iters": _full(iters0, i64, dev),
             "since_ref": _full(1, i64, dev),  # first verdict confirmed too
             "stall": _full(0, i64, dev), "no_imp": _full(0, i64, dev),
             "best": _full(math.inf, dt, dev),
             "want_stop": _full(False, torch.bool, dev),
             "optimal": _full(False, torch.bool, dev),
             **graphs.step_state(dev)}
    static = (float(tol), int(max_iters), int(bland_after), stall_limit,
              int(refactor_every), bool(devex))
    since0 = 1
    with graphs.Loop("tableau.phase", state, {"col_mask": col_mask},
                     static) as lp:
        st = lp.state
        while True:
            lp.run(_phase_chunk, refactor_every - since0 + 1)
            want, opt, it, ni, stl, sr = _read(
                lp, st["want_stop"], st["optimal"], st["iters"],
                st["no_imp"], st["stall"], st["since_ref"])
            if it >= max_iters or ni >= stall_limit:
                status = STATUS_ITERATION_LIMIT
                break
            if want and (sr == 0 or stl >= 3):
                status = STATUS_OPTIMAL if opt else STATUS_UNBOUNDED
                break
            # Refactor branch: for a verdict (confirm) or for the period.
            T_new, ok = refactor_tableau(T0_rows, st["basis"], raw_obj)
            st["T"].copy_(torch.where(ok, T_new, st["T"]))
            improved, obj = _improved_below(st["T"], st["best"], tol)
            st["stall"].copy_(torch.where(improved, 0,
                                          st["stall"] + int(bool(want))))
            st["no_imp"].copy_(torch.where(improved, 0, st["no_imp"]))
            st["best"].copy_(torch.minimum(st["best"], obj))
            st["since_ref"].fill_(0)
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


# --------------------------------------------------------------------------- #
# Dual simplex: reoptimization from a dual-feasible basis                     #
# --------------------------------------------------------------------------- #
def _dual_devex_update(w, T, r, s):
    """Dual Devex weights after a pivot on ``(r, s)``, from the entering
    column BEFORE the pivot (see the JAX function).  Returns new weights."""
    m = w.shape[0]
    alpha = T[:-1].index_select(1, s.reshape(1))[:, 0]
    rr = torch.clamp_max(r, m - 1).reshape(1)
    a_r = alpha.index_select(0, rr)
    a_r = torch.where(torch.abs(a_r) > 0, a_r, 1.0)
    q = alpha / a_r
    w_r = w.index_select(0, rr)
    w_new = torch.maximum(w, (q * q) * w_r)
    is_r = torch.arange(m, device=w.device) == r
    w_new = torch.where(is_r, torch.clamp_min(w_r / (a_r * a_r), 1.0), w_new)
    return torch.where(torch.max(w_new) > 1e8, torch.ones_like(w_new), w_new)


def _dual_entering(row_key, eligible, num, tol, use_bland):
    """The dual ratio test over the eligible columns: ``num / row_key`` at
    its minimum, the largest ``row_key`` in the tol-relaxed window (Harris),
    or the first eligible column in stall mode.  Returns ``(s, no_pivot)``."""
    safe = torch.where(eligible, row_key, 1.0)
    ratios = torch.where(eligible, num / safe, math.inf)
    min_ratio = torch.min(ratios)
    window = eligible & (
        ratios <= min_ratio + tol * (1.0 + torch.abs(min_ratio)))
    s_harris = torch.argmax(torch.where(window, row_key, -math.inf))
    # argmax of a bool mask needs an integer type on CUDA.
    s_bland = torch.argmax(eligible.to(torch.int32))
    return torch.where(use_bland, s_bland, s_harris), ~torch.any(eligible)


def _dual_select(T, col_mask, w, tol, use_bland, devex):
    """Leaving row and entering column of the classic dual step.  Returns
    0-d tensors ``(r, s, primal_ok, no_pivot)``."""
    rhs = T[:-1, -1]
    infeas = rhs < -tol
    r_min = torch.argmin(rhs)
    if devex:
        r_price = torch.argmax(torch.where(infeas, (rhs * rhs) / w,
                                           -math.inf))
    else:
        r_price = r_min
    # Stall mode: the most negative row (ties to the lowest index).
    r = torch.where(use_bland, r_min, r_price)
    row = T.index_select(0, r.reshape(1))[0, :-1]
    eligible = col_mask & (row < -tol)
    s, no_pivot = _dual_entering(-row, eligible,
                                 torch.clamp_min(T[-1, :-1], 0.0), tol,
                                 use_bland)
    return r, s, ~torch.any(infeas), no_pivot


def _dual_select_bounded(T, basis, col_mask, at_upper, ub, w, tol,
                         use_bland, devex):
    """The bounded dual step's choice: the largest two-sided violation
    leaves (``leave_up`` when above its upper bound), and the entering
    candidates are NONBASIC columns on the sign-adjusted row (the
    self-pivot fix; see the JAX function).  Returns 0-d tensors
    ``(r, s, primal_ok, no_pivot, leave_up)``."""
    rhs = T[:-1, -1]
    ub_B = ub.index_select(0, basis)
    viol_lo = -rhs
    viol_up = torch.where(torch.isfinite(ub_B), rhs - ub_B, -math.inf)
    viol = torch.maximum(viol_lo, viol_up)
    infeas = viol > tol
    r_max = torch.argmax(torch.where(infeas, viol, -math.inf))
    if devex:
        r_price = torch.argmax(torch.where(infeas, (viol * viol) / w,
                                           -math.inf))
    else:
        r_price = r_max
    r = torch.where(use_bland, r_max, r_price)
    r1 = r.reshape(1)
    leave_up = ~(viol_lo.index_select(0, r1)[0]
                 >= viol_up.index_select(0, r1)[0])
    row = T.index_select(0, r1)[0, :-1]
    rowp = torch.where(leave_up, -row, row)
    basic = torch.zeros_like(col_mask).index_fill_(0, basis, True)
    cand = col_mask & ~basic
    eligible = (cand & ~at_upper & (rowp < -tol)) | \
        (cand & at_upper & (rowp > tol))
    rc = T[-1, :-1]
    num = torch.where(at_upper, torch.clamp_min(-rc, 0.0),
                      torch.clamp_min(rc, 0.0))
    s, no_pivot = _dual_entering(torch.abs(rowp), eligible, num, tol,
                                 use_bland)
    return r, s, ~torch.any(infeas), no_pivot, leave_up


def _refactor_bounded(T0_rows, basis, raw_obj, at_upper, ub_safe):
    """:func:`refactor_tableau` with the at-upper columns' contribution
    taken out of the RHS column.  Returns ``(T_new, ok)``."""
    T_new, ok = refactor_tableau(T0_rows, basis, raw_obj)
    u_vec = torch.where(at_upper, ub_safe, 0.0)
    T_new[:, -1] -= T_new[:, :-1] @ u_vec
    return T_new, ok & torch.all(torch.isfinite(T_new))


def _dual_chunk(st, cs, static, n_steps: int):
    """``n_steps`` device steps of :func:`_run_dual`'s loop, the chunk body
    that ``runtime/graphs.py`` runs eagerly or replays as one CUDA graph.
    Each step writes its state in place and runs only while the one before
    it pivoted (``go``), as in :func:`_phase_chunk`."""
    tol, max_iters, bland_after, refactor_every, devex, bounded = static
    i64 = torch.int64
    T, basis, col_mask = st["T"], st["basis"], cs["col_mask"]
    if bounded:
        ub, ub_safe, cols = cs["ub"], cs["ub_safe"], cs["cols"]
    for _ in graphs.steps(st, n_steps):
        w, iters, since_ref = st["w"], st["iters"], st["since_ref"]
        stall, no_imp, best = st["stall"], st["no_imp"], st["best"]
        use_bland = no_imp >= bland_after
        if not bounded:
            r, s, primal_ok, no_pivot = _dual_select(
                T, col_mask, w, tol, use_bland, devex)
        else:
            at_upper = st["at_upper"]
            r, s, primal_ok, no_pivot, leave_up = _dual_select_bounded(
                T, basis, col_mask, at_upper, ub, w, tol, use_bland, devex)
        want_stop = primal_ok | no_pivot
        do = ((~want_stop) & (since_ref < refactor_every)
              & (iters < max_iters))
        if devex:
            w = torch.where(do, _dual_devex_update(w, T, r, s), w)
        if not bounded:
            pivot_update(T, basis, r, s, clamp_rhs=False, do_pivot=do)
        else:
            # Pre-flip: an entering column at its upper bound returns to
            # its lower bound (RHS += column * u_s).
            s1 = s.reshape(1)
            u_s = torch.where(at_upper.index_select(0, s1)[0],
                              ub_safe.index_select(0, s1)[0], 0.0)
            col_s = T.index_select(1, s1)[:, 0]
            T[:, -1] = torch.where(do, T[:, -1] + u_s * col_s, T[:, -1])
            at_upper = torch.where(do & (cols == s), False, at_upper)
            j_out = basis.index_select(0, r.reshape(1))
            pivot_update(T, basis, r, s, clamp_rhs=False, do_pivot=do)
            # Post-flip: a variable that leaves above its upper bound parks
            # at it (RHS -= post-pivot column * u_jout).
            u_out = torch.where(
                leave_up, ub_safe.index_select(0, j_out)[0], 0.0)
            col_out = T.index_select(1, j_out)[:, 0]
            T[:, -1] = torch.where(do, T[:, -1] + (-u_out) * col_out,
                                   T[:, -1])
            at_upper = torch.where(do & (cols == j_out[0]), leave_up,
                                   at_upper)
            graphs.store(st, at_upper=at_upper)
        step = do.to(i64)
        improved, obj = _improved_above(T, best, tol)
        graphs.store(st, w=w, iters=iters + step,
                     since_ref=since_ref + step,
                     stall=torch.where(improved, 0, stall),
                     no_imp=torch.where(improved, 0, no_imp + step),
                     best=torch.maximum(best, obj), want_stop=want_stop,
                     primal_ok=primal_ok, go=do)


def _improved_above(T, best, tol):
    """Whether the dual objective ``-T[-1, -1]`` rose above ``best`` by more
    than the tolerance, and the objective."""
    obj = -T[-1, -1]
    return obj > best + tol * (1.0 + torch.abs(best)), obj


def _run_dual(T, basis, col_mask, T0_rows, raw_obj, tol, max_iters,
              bland_after, refactor_every, devex, since0, bounds=None):
    """Dual pivots until primal feasible (optimal), a row without an
    entering column (infeasible) or the iteration cap, IN PLACE on ``T``
    and ``basis`` (and ``bounds["at_upper"]``).

    The JAX loop's three-way switch split as in :func:`_run_phase`: a chunk
    of device steps (:func:`_dual_chunk`; one CUDA graph on the card) only
    pivots, masked by ``do``; once a chunk the host reads the state and
    accepts a verdict from a fresh refactor (or after 3 stalled confirms),
    or refactors.  The dual objective ``-T[-1, -1]`` does not decrease, so
    progress is a new maximum.  ``since0`` is the refactor counter's start:
    1 (the first verdict is confirmed) or 0 (``T`` is a fresh refactor).
    Returns ``(iters, status)`` as host ints.
    """
    dev, dt = T.device, T.dtype
    i64 = torch.int64
    m, n_cols = T.shape[0] - 1, T.shape[1] - 1
    state = {"T": T, "basis": basis,
             "w": torch.ones((m,), dtype=dt, device=dev),
             "iters": _full(0, i64, dev),
             "since_ref": _full(since0, i64, dev),
             "stall": _full(0, i64, dev), "no_imp": _full(0, i64, dev),
             "best": _full(-math.inf, dt, dev),
             "want_stop": _full(False, torch.bool, dev),
             "primal_ok": _full(False, torch.bool, dev),
             **graphs.step_state(dev)}
    consts = {"col_mask": col_mask}
    if bounds is not None:
        state["at_upper"] = bounds["at_upper"]
        consts.update(ub=bounds["ub"], ub_safe=bounds["ub_safe"],
                      cols=torch.arange(n_cols, device=dev))
    static = (float(tol), int(max_iters), int(bland_after),
              int(refactor_every), bool(devex), bounds is not None)
    with graphs.Loop("tableau.dual", state, consts, static) as lp:
        st = lp.state
        while True:
            lp.run(_dual_chunk, refactor_every - since0 + 1)
            want, ok, it, stl, sr = _read(lp, st["want_stop"],
                                          st["primal_ok"], st["iters"],
                                          st["stall"], st["since_ref"])
            if it >= max_iters:
                status = STATUS_ITERATION_LIMIT
                break
            if want and (sr == 0 or stl >= 3):
                status = STATUS_OPTIMAL if ok else STATUS_INFEASIBLE
                break
            # Refactor branch: for a verdict (confirm) or for the period.
            if bounds is None:
                T_new, ok_t = refactor_tableau(T0_rows, st["basis"], raw_obj)
            else:
                T_new, ok_t = _refactor_bounded(T0_rows, st["basis"],
                                                raw_obj, st["at_upper"],
                                                bounds["ub_safe"])
            st["T"].copy_(torch.where(ok_t, T_new, st["T"]))
            improved, obj = _improved_above(st["T"], st["best"], tol)
            st["stall"].copy_(torch.where(improved, 0,
                                          st["stall"] + int(bool(want))))
            st["no_imp"].copy_(torch.where(improved, 0, st["no_imp"]))
            st["best"].copy_(torch.maximum(st["best"], obj))
            st["since_ref"].fill_(0)
            since0 = 0
    return it, status


def solve_tableau_dual(T0, basis0, col_mask, tol: float = 1e-6,
                       max_iters: int = 16384, bland_after: int = 2048,
                       refactor_every: int = 64, devex: bool = True):
    """Dual simplex pivots on a tableau with nonnegative reduced costs.

    Start state: a basis that is dual-feasible (``T[-1, :-1] >= -tol`` on
    eligible columns) but possibly primal-infeasible (negative RHS), as
    after a change of ``b`` under a previously optimal basis.  Rules as in
    the JAX function: the leaving row by dual Devex (``rhs_r² / w_r`` over
    the infeasible rows) or the most negative RHS, the entering column by
    the Harris-stabilized dual ratio test, the stall-gated Bland fallback,
    a refactor from ``T0`` every ``refactor_every`` pivots and a verdict
    accepted from a fresh refactor only.  Each pivot runs K1 with the RHS
    clamp off.

    ``T0`` is left intact (it is the drift anchor).  Returns ``(T, basis,
    status, iters)``: STATUS_OPTIMAL when the RHS is nonnegative,
    STATUS_INFEASIBLE when a negative row has no eligible entry,
    STATUS_ITERATION_LIMIT otherwise; ``status`` and ``iters`` host ints.
    """
    T = T0.clone()
    basis = basis0.to(torch.int64).clone()
    iters, status = _run_dual(T, basis, col_mask, T0[:-1], T0[-1], tol,
                              max_iters, bland_after, refactor_every, devex,
                              since0=1)
    return T, basis, status, iters


def solve_tableau_dual_bounded(T0, basis0, col_mask, ub, at_upper0,
                               tol: float = 1e-6, max_iters: int = 16384,
                               bland_after: int = 2048,
                               refactor_every: int = 64,
                               devex: bool = True):
    """Dual simplex with native bounds ``0 <= x <= ub``.

    The bounded mirror of :func:`solve_tableau_dual` (see the JAX function
    for the rules): a basic variable is infeasible below 0 or above its
    upper bound, the largest violation leaves, and the bound semantics ride
    as two RHS axpys around the K1 pivot, both masked by the step's ``do``:
    the pre-flip of an entering column at its upper bound and the post-flip
    of a column that leaves at its upper bound.

    ``T0`` holds the RAW rows and the raw phase-2 objective (the drift
    anchor, left intact); the starting tableau is the refactor of
    ``basis0`` with the at-upper columns subtracted.  ``ub`` is (n_cols,),
    +inf where unbounded; ``at_upper0`` (n_cols,) bool, basic columns
    False.  Returns ``(T, basis, at_upper, status, iters)``.
    """
    dt = T0.dtype
    T0_rows, raw_obj = T0[:-1], T0[-1]
    ub = ub.to(dt)
    bounds = {"ub": ub,
              "ub_safe": torch.where(torch.isfinite(ub), ub, 0.0),
              "at_upper": at_upper0.to(torch.bool).clone()}
    basis = basis0.to(torch.int64).clone()
    T_start, ok = _refactor_bounded(T0_rows, basis, raw_obj,
                                    bounds["at_upper"], bounds["ub_safe"])
    T = torch.where(ok, T_start, T0).contiguous()
    # since_ref starts at 0: T is a fresh refactor, so an immediate verdict
    # is already confirmed.
    iters, status = _run_dual(T, basis, col_mask, T0_rows, raw_obj, tol,
                              max_iters, bland_after, refactor_every, devex,
                              since0=0, bounds=bounds)
    return T, basis, bounds["at_upper"], status, iters


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
