"""Batched tableau simplex on torch (port of ``simplex_tpu/ops/batched.py``).

One padded shape, many LP instances: ``T`` is (B, M, N) with the objective
row last and the RHS column last, ``basis`` (B, M-1) int32.  Two solvers:
:func:`solve_tableau_batch` for ``x >= 0`` and
:func:`solve_tableau_batch_bounded` for ``0 <= x <= ub`` with the bounds
kept native (bound flips, no extra rows).  The step of every iteration
goes through kernel K2, or K3 for the bounded solver
(``ops/batched_kernel.py``), or, with ``backend="xla"``, through the
unfused torch step (:func:`_select_pivot_b`, :func:`_devex_update_b` and
:func:`_pivot_update_b`; :func:`_bounded_step_b`), the counterpart of the
reference's ``backend="xla"``.

Differences from the JAX module, all deliberate:

* The ``lax.while_loop`` becomes a host loop over chunks of device steps
  (:func:`_batch_chunk`, one replayed CUDA graph on the card:
  ``runtime/graphs.py``), with one host read of the loop state per chunk
  (``Loop.read``), never one per pivot.  A chunk's steps stop at the first
  step that finds no instance running, the reference's ``icond``: on the
  card the steps after a chunk's first are the body of a WHILE
  conditional node of its graph, so K2 or K3 runs once a step of
  ``iters``.  ``iters`` counts the steps taken while some instance was
  running (a device counter), so ``iters`` and the per-instance
  ``pivots`` equal the reference's when the trajectories agree.
* The general (two-phase) loop flips an instance to phase 2 at the end of
  the chunk in which it completed phase 1, not in that same iteration: the
  instance idles meanwhile (the step reports it optimal and does not pivot
  it).  Its chunks are ``_FLIP_CHUNK`` steps long, or shorter where a
  refactor falls, so the idling is short.  Refactors keep the reference's
  ``since_ref >= refactor_every`` schedule, so they fall at other points
  of a flipped instance's pivot sequence than in the reference.  Parity
  for this loop is at solve level: the same verdicts and objectives.
* K2 and K3 update the tableau and the carried state in place on the
  loop's own copies; the unfused helpers stay functional, like the
  reference.  The unfused bounded step is one function, where the
  reference writes it inline in each of its two loops.
* No fallback to the unfused step for batch counts that no block divides
  (``ops/batched.py:306-316`` and ``:671-676`` of the reference, a Mosaic
  constraint): K2 and K3 take any batch count.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.problem import (
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
)
from ..runtime import graphs
from .batched_kernel import (
    fma_rn,
    fused_pivot_step_,
    fused_pivot_step_bounded_,
    fused_pivot_step_bounded_ref,
    fused_pivot_step_ref,
)

RUNNING = -1
_INT_MAX = int(np.iinfo(np.int32).max)

# Steps between host reads in the general loop: an instance that has
# completed phase 1 idles at most this many steps before its flip.
_FLIP_CHUNK = 8

# config.batched_backend -> the step that runs every iteration.
_BACKENDS = {
    "auto": "kernel",            # K2 / K3: the kernel on CUDA, its twin on CPU
    "pallas": "kernel",
    "pallas_interpret": "twin",  # the kernel's twin on any device
    "xla": "unfused",            # the unfused torch step
}


def batch_state_from_compiled(cb, device, dtype):
    """A compiled batch as the port's tensors on ``device``.

    The batched counterpart of ``ops/tableau.py::state_from_standard_form``:
    takes a ``CompiledBatch`` of numpy arrays (either package's) or of
    tensors, and returns the keyword arguments of
    :func:`solve_tableau_batch` for the arrays: ``T0`` and the objective
    rows cast to ``dtype``, ``basis0`` int32, masks and ``need_p1`` bool.
    A bounded batch (``ub_ext`` set) also gives ``ub`` in ``dtype``: the
    keyword arguments of :func:`solve_tableau_batch_bounded`.
    """
    def t(a, dt):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dt)
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return {
        "T0": t(cb.T0, dtype).contiguous(),
        "basis0": t(cb.basis, torch.int32).contiguous(),
        "col_mask_p1": t(cb.col_mask_p1, torch.bool),
        "col_mask_p2": t(cb.col_mask_p2, torch.bool),
        "obj_row_p1": t(cb.obj_row_p1, dtype),
        "obj_row_p2": t(cb.obj_row_p2, dtype),
        "need_p1": t(cb.need_p1, torch.bool),
        **({} if cb.ub_ext is None else {"ub": t(cb.ub_ext, dtype)}),
    }


def _gather_col(T, s):
    """Column ``T[b, :, s[b]]`` per instance."""
    B, M, _ = T.shape
    return T.gather(2, s.long()[:, None, None].expand(B, M, 1))[:, :, 0]


def _gather_row(T, r):
    """Row ``T[b, r[b], :]`` per instance."""
    B, _, N = T.shape
    return T.gather(1, r.long()[:, None, None].expand(B, 1, N))[:, 0, :]


def _select_pivot_b(T, basis, col_mask, tol, use_bland, weights=None):
    """Batched pivot selection (see the JAX function); ties go to the
    lowest index, as ``torch.argmin`` / ``torch.argmax`` return the first
    extremum.  Returns ``(s, r, optimal, unbounded)``, each (B,)."""
    rc = torch.where(col_mask, T[:, -1, :-1], math.inf)
    eligible = rc < -tol

    if weights is None:
        s_price = torch.argmin(rc, dim=-1)
    else:
        score = torch.where(eligible, (rc * rc) / weights, -math.inf)
        s_price = torch.argmax(score, dim=-1)
    # argmax of a bool mask needs an integer type on CUDA.
    s_bland = torch.argmax(eligible.to(torch.int32), dim=-1)
    s = torch.where(use_bland, s_bland, s_price)

    optimal = ~torch.any(eligible, dim=-1)

    col = _gather_col(T, s)[:, :-1]
    rhs = T[:, :-1, -1]
    positive = col > tol
    # Backward-step clamp — see ops/tableau.select_pivot.
    rhs_c = torch.clamp_min(rhs, 0.0)
    safe_col = torch.where(positive, col, 1.0)
    ratios = torch.where(positive, rhs_c / safe_col, math.inf)
    min_ratio = torch.amin(ratios, dim=-1)
    unbounded = (~optimal) & torch.isinf(min_ratio)

    # Harris two-pass ratio test; Bland mode keeps the smallest-basis-index
    # rule.  The numerator rounds once, as the reference's compiled loop
    # contracts it (see ops/batched_kernel.py).
    tol_t = torch.full((), tol, dtype=T.dtype, device=T.device)
    theta_relax = torch.where(
        positive, fma_rn(1.0 + rhs.abs(), tol_t, rhs_c) / safe_col, math.inf)
    theta_max = torch.amin(theta_relax, dim=-1)
    cand = positive & (ratios <= theta_max[:, None])
    r_harris = torch.argmax(torch.where(cand, col, -math.inf), dim=-1)

    eps = torch.finfo(T.dtype).eps
    near = ratios <= (min_ratio + 64.0 * eps
                      * (1.0 + min_ratio.abs()))[:, None]
    tie_key = torch.where(near & positive, basis, _INT_MAX)
    r_bland = torch.argmin(tie_key, dim=-1)
    r = torch.where(use_bland, r_bland, r_harris)
    return s, r, optimal, unbounded


def _devex_update_b(w, T, basis, r, s, active):
    """Batched Forrest-Goldfarb Devex update for pivots ``(r, s)`` (see the
    JAX function).  The overflow reset reads the ``n`` structural lanes
    only, as the reference's unfused step does (K2 also reads the padded
    RHS lane: each port keeps its own reference's behaviour)."""
    n = T.shape[2] - 1
    piv_row = _gather_row(T, r)[:, :n]                         # (B, n)
    sl = s.long()[:, None]
    pivot = piv_row.gather(1, sl)
    safe = torch.where(pivot.abs() > 0, pivot, 1.0)
    alpha = piv_row / safe
    w_s = w.gather(1, sl)                                      # (B, 1)
    w_new = torch.maximum(w, (alpha * alpha) * w_s)
    idx = torch.arange(n, device=T.device)[None, :]
    j_out = basis.gather(1, r.long()[:, None])
    w_new = torch.where(idx == j_out, torch.clamp_min(w_s, 1.0), w_new)
    w_new = torch.where(idx == sl, 1.0, w_new)
    w_new = torch.where(w_new.amax(dim=1, keepdim=True) > 1e8, 1.0, w_new)
    return torch.where(active[:, None], w_new, w)


def _pivot_update_b(T, basis, r, s, active, clamp_rhs: bool = False):
    """Batched masked rank-1 pivot: inactive instances pass through
    untouched.  ``clamp_rhs`` executes theta = max(rhs_r, 0)/pivot (the
    primal solve path); eviction sweeps keep the exact step.  The update
    rounds once, as the reference's compiled loop does.  Returns new
    ``(T, basis)``."""
    B, M, N = T.shape
    piv_row = _gather_row(T, r)
    pivot = piv_row.gather(1, s.long()[:, None])
    safe_pivot = torch.where(active[:, None] & (pivot.abs() > 0), pivot, 1.0)
    piv_row = piv_row / safe_pivot
    if clamp_rhs:
        piv_row = torch.cat([piv_row[:, :-1],
                             torch.clamp_min(piv_row[:, -1:], 0.0)], dim=1)

    col = _gather_col(T, s)
    T_new = fma_rn(-col[:, :, None], piv_row[:, None, :], T)

    row_hot = torch.arange(M, device=T.device)[None, :] == r.long()[:, None]
    T_new = torch.where(row_hot[:, :, None], piv_row[:, None, :], T_new)
    col_hot = torch.arange(N, device=T.device)[None, :] == s.long()[:, None]
    T_new = torch.where(col_hot[:, None, :], row_hot.to(T.dtype)[:, :, None],
                        T_new)

    T_out = torch.where(active[:, None, None], T_new, T)
    basis_new = torch.where(active[:, None] & row_hot[:, :M - 1],
                            s[:, None].to(basis.dtype), basis)
    return T_out, basis_new


def _price_out_b(T, basis, obj_row):
    """Batched objective install + price-out against the current basis."""
    basis_costs = obj_row.gather(1, basis.long())                # (B, m)
    obj2 = obj_row - torch.bmm(basis_costs[:, None, :], T[:, :-1, :])[:, 0]
    return torch.cat([T[:, :-1, :], obj2[:, None, :]], dim=1)


def _evict_artificials_b(T, basis, art_mask_ext, col_mask_p2, tol):
    """Batched post-phase-1 eviction of basic artificial columns: one
    unclamped masked pivot per row, as the reference's ``fori_loop``."""
    for i in range(T.shape[1] - 1):
        is_art = art_mask_ext.gather(1, basis[:, i:i + 1].long())[:, 0]
        row = T[:, i, :-1]
        cand = col_mask_p2 & (row.abs() > tol)
        j = torch.argmax(cand.to(torch.int32), dim=-1)
        active = is_art & torch.any(cand, dim=-1)
        r = torch.full_like(j, i)
        T, basis = _pivot_update_b(T, basis, r, j, active)
    return T, basis


def _basis_columns(rows, basis):
    """``rows[b, :, basis[b, i]]`` as (B, k, m): the basis matrix of each
    instance read from its rows."""
    B, k, _ = rows.shape
    m = basis.shape[1]
    return rows.gather(2, basis.long()[:, None, :].expand(B, k, m))


def _refine_solution_b(T, basis, basis0, T0_rows, raw_obj):
    """One Newton step on the reported x_B with the approximate inverse
    embedded in the tableau (see the JAX function); kept only where it
    lowers the residual.  Returns a new ``T``."""
    T_rows = T[:, :-1, :]
    Bmat = _basis_columns(T0_rows, basis)                # (B, mp, mp)
    Minv = _basis_columns(T_rows, basis0)                # ~ B^{-1}

    b0 = T0_rows[:, :, -1]
    xB = T[:, :-1, -1]
    r0 = b0 - torch.bmm(Bmat, xB[:, :, None])[:, :, 0]
    xB1 = xB + torch.bmm(Minv, r0[:, :, None])[:, :, 0]
    r1 = b0 - torch.bmm(Bmat, xB1[:, :, None])[:, :, 0]
    better = ((r1 * r1).sum(-1) < (r0 * r0).sum(-1)) \
        & torch.all(torch.isfinite(xB1), dim=-1)
    xB_out = torch.where(better[:, None], xB1, xB)

    cB = raw_obj.gather(1, basis.long())                 # (B, mp)
    z_min = (cB * xB_out).sum(-1)
    T = T.clone()
    T[:, :-1, -1] = xB_out
    T[:, -1, -1] = -z_min
    return T


def _refactor_b(T, basis, T0_rows, raw_obj, active):
    """Batched exact recomputation of the tableaus from (T0, basis).

    Instances that are inactive, or whose basis matrix is singular
    (``solve_ex`` reports it instead of raising) or gives a non-finite
    tableau, keep their incremental tableau.  Returns a new ``T``.
    """
    Bmat = _basis_columns(T0_rows, basis)
    T_rows, info = torch.linalg.solve_ex(Bmat, T0_rows)
    basis_costs = raw_obj.gather(1, basis.long())
    obj = raw_obj - torch.bmm(basis_costs[:, None, :], T_rows)[:, 0]
    T_new = torch.cat([T_rows, obj[:, None, :]], dim=1)
    ok = active & (info == 0) & torch.all(torch.isfinite(T_new), dim=(1, 2))
    return torch.where(ok[:, None, None], T_new, T)


def _evict_artificials_bounded_b(T, basis, at_upper, art_mask_ext,
                                 col_mask_p2, tol):
    """Post-phase-1 eviction with bounds: entering candidates must be
    nonbasic at their lower bound (see the JAX function)."""
    for i in range(T.shape[1] - 1):
        is_art = art_mask_ext.gather(1, basis[:, i:i + 1].long())[:, 0]
        cand = col_mask_p2 & ~at_upper & (T[:, i, :-1].abs() > tol)
        j = torch.argmax(cand.to(torch.int32), dim=-1)
        active = is_art & torch.any(cand, dim=-1)
        T, basis = _pivot_update_b(T, basis, torch.full_like(j, i), j, active)
    return T, basis


def _at_upper_terms(at_upper, ub, raw_obj):
    """``u_U``, the at-upper columns at their bound (0 elsewhere), and the
    objective's at-upper part ``c_U · u_U``, per instance."""
    ub_safe = torch.where(torch.isfinite(ub), ub, 0.0)
    u_vec = torch.where(at_upper, ub_safe, 0.0)
    z_up = torch.where(at_upper, raw_obj[:, :-1] * ub_safe, 0.0).sum(-1)
    return u_vec, z_up


def _refine_solution_bounded_b(T, basis, basis0, T0_rows, raw_obj, at_upper,
                               ub):
    """Bounded twin of :func:`_refine_solution_b`: the Newton residual is
    taken against ``b_eff = b0 - A u_U`` and the objective adds the
    at-upper terms.  Returns a new ``T``."""
    Bmat = _basis_columns(T0_rows, basis)
    Minv = _basis_columns(T[:, :-1, :], basis0)
    u_vec, z_up = _at_upper_terms(at_upper, ub, raw_obj)
    b_eff = T0_rows[:, :, -1] - torch.bmm(T0_rows[:, :, :-1],
                                          u_vec[:, :, None])[:, :, 0]
    xB = T[:, :-1, -1]
    r0 = b_eff - torch.bmm(Bmat, xB[:, :, None])[:, :, 0]
    xB1 = xB + torch.bmm(Minv, r0[:, :, None])[:, :, 0]
    r1 = b_eff - torch.bmm(Bmat, xB1[:, :, None])[:, :, 0]
    better = ((r1 * r1).sum(-1) < (r0 * r0).sum(-1)) \
        & torch.all(torch.isfinite(xB1), dim=-1)
    xB_out = torch.where(better[:, None], xB1, xB)
    z_min = (raw_obj.gather(1, basis.long()) * xB_out).sum(-1) + z_up
    T = T.clone()
    T[:, :-1, -1] = xB_out
    T[:, -1, -1] = -z_min
    return T


def _bounded_tableau(basis, at_upper, ub, T0_rows, raw_obj):
    """The bounded tableau at ``(basis, at_upper)`` computed from ``T0``:
    ``B^{-1} A`` and the reduced costs as in :func:`_refactor_b`, the RHS
    column solved against ``b_eff`` and the objective cell with the
    at-upper terms.  The basic columns are set as a pivot leaves them,
    exact unit columns with zero reduced costs: the solve's rounding there
    (about 1e-4 in float32 beside costs near 1e3) would otherwise price a
    basic column in, and K3 would flip or pivot on it.  Returns ``(T,
    ok)``, ``ok`` false where the basis is singular or the tableau not
    finite."""
    Bmat = _basis_columns(T0_rows, basis)
    u_vec, z_up = _at_upper_terms(at_upper, ub, raw_obj)
    b_eff = T0_rows[:, :, -1] - torch.bmm(T0_rows[:, :, :-1],
                                          u_vec[:, :, None])[:, :, 0]
    rhs_all = torch.cat([T0_rows[:, :, :-1], b_eff[:, :, None]], dim=2)
    T_rows, info = torch.linalg.solve_ex(Bmat, rhs_all)
    B, R, _ = T_rows.shape
    bl = basis.long()
    eye = torch.eye(R, dtype=T_rows.dtype, device=T_rows.device)
    T_rows = T_rows.scatter(2, bl[:, None, :].expand(B, R, R),
                            eye.expand(B, R, R))
    basis_costs = raw_obj.gather(1, bl)
    obj = raw_obj - torch.bmm(basis_costs[:, None, :], T_rows)[:, 0]
    obj = obj.scatter(1, bl, 0.0)
    obj[:, -1] = -((basis_costs * T_rows[:, :, -1]).sum(-1) + z_up)
    T_new = torch.cat([T_rows, obj[:, None, :]], dim=1)
    return T_new, (info == 0) & torch.all(torch.isfinite(T_new), dim=(1, 2))


def _refactor_bounded_b(T, basis, at_upper, ub, T0_rows, raw_obj, active):
    """Bounded exact refactorization (:func:`_bounded_tableau`).  Inactive,
    singular and non-finite instances keep their tableau.  Returns a new
    ``T``."""
    T_new, ok = _bounded_tableau(basis, at_upper, ub, T0_rows, raw_obj)
    return torch.where((active & ok)[:, None, None], T_new, T)


# How far a warm start's basic values may lie outside their bounds, relative
# to 1 + the bound (a basic slack: to the instance's 1 + max |b|).
_WARM_SLACK = 1e-7


def _within_bounds(T, basis, ub, b_scale):
    """Per instance, whether the basic values of the bounded tableau ``T``
    lie within their bounds, ``[0, ub]``, up to ``_WARM_SLACK``.  The loop
    clips its right-hand side into the bounds at every step, so a basis
    that float32 rounding left slightly infeasible looks feasible to it;
    solved afresh in float64, its basic values show the infeasibility, and
    a loop resumed from it would carry that to the answer."""
    xB = T[:, :-1, -1]
    ub_B = ub.gather(1, basis.long())
    fin = torch.isfinite(ub_B)
    scale = torch.where(fin, 1.0 + torch.where(fin, ub_B, 0.0),
                        b_scale[:, None])
    out = (xB < -_WARM_SLACK * scale) \
        | (fin & (xB > ub_B + _WARM_SLACK * scale))
    return ~out.any(dim=1)


def _clip_b(x, ub):
    """``clip(x, 0, ub)`` as ``jnp.clip``: ``min(ub, max(0, x))``."""
    return torch.minimum(ub, torch.clamp_min(x, 0.0))


def _bounded_step_b(T, basis, at_upper, col_mask, in_p1, live, use_bland, w,
                    ub, ub_B, is_art_row, art_mask_ext, tol, devex, with_art):
    """The unfused bounded step, the reference's ``backend="xla"`` loop
    body (written there inline in both loops; ``with_art`` is the general
    loop's, without it the ``phase2_only`` loop's).  ``w`` is (B, n).

    It computes what K3 computes, with the reference's own rounding: all
    five of its product-sums as one fused multiply-add in float32 (the
    two Harris numerators, the rank-1 update, the RHS steps ``xB - dd·θ``
    and ``xB - dd·ub_s``), and the objective cell as ``z + σ·rc_s·θ``
    (also one fused multiply-add) where K3 steps it like a constraint
    row.  Returns new tensors ``(T, basis, at_upper, w, ub_B, is_art_row,
    s, r, optimal, unbounded, moving)``; an instance that does not move
    keeps its tableau and state."""
    B, M, N = T.shape
    dt, dev = T.dtype, T.device
    inf = math.inf
    rc = T[:, -1, :-1]
    eligible = (col_mask & ~at_upper & (rc < -tol)) \
        | (col_mask & at_upper & (rc > tol))
    viol = torch.where(eligible, rc.abs(), -inf)
    if devex:
        s_price = torch.argmax(torch.where(eligible, (viol * viol) / w, -inf),
                               dim=-1)
    else:
        s_price = torch.argmax(viol, dim=-1)
    s_bland = torch.argmax(eligible.to(torch.int32), dim=-1)
    s = torch.where(use_bland, s_bland, s_price)
    optimal = ~torch.any(eligible, dim=-1)
    sl = s[:, None]
    s_from_up = at_upper.gather(1, sl)[:, 0]
    sigma = torch.where(s_from_up, -1.0, 1.0).to(dt)
    rc_s = rc.gather(1, sl)[:, 0]
    ub_s = ub.gather(1, sl)[:, 0]
    ub_s_safe = torch.where(torch.isfinite(ub_s), ub_s, 0.0)

    dd = sigma[:, None] * _gather_col(T, s)[:, :-1]
    xB = T[:, :-1, -1]
    pos = dd > tol
    neg = (dd < -tol) & torch.isfinite(ub_B)
    span = ub_B - xB
    xB_c = torch.clamp_min(xB, 0.0)
    span_c = torch.clamp_min(span, 0.0)
    pos_dd = torch.where(pos, dd, 1.0)
    neg_dd = torch.where(neg, -dd, 1.0)
    t_lo = torch.where(pos, xB_c / pos_dd, inf)
    cand = pos | neg
    if with_art:
        art_exit = (~in_p1)[:, None] & is_art_row & (dd.abs() > tol)
        t_lo = torch.where(art_exit, 0.0, t_lo)
        cand = cand | art_exit
    t_hi = torch.where(neg, span_c / neg_dd, inf)
    t_row = torch.minimum(t_lo, t_hi)
    min_row = torch.amin(t_row, dim=-1)
    theta = torch.minimum(min_row, ub_s)
    unbounded = ~optimal & torch.isinf(theta)
    flip = ~optimal & ~unbounded & (ub_s <= min_row)
    theta_safe = torch.where(torch.isfinite(theta), theta, 0.0)

    tol_t = torch.full((), tol, dtype=dt, device=dev)
    t_lo_rel = torch.where(pos, fma_rn(1.0 + xB.abs(), tol_t, xB_c) / pos_dd,
                           inf)
    t_hi_rel = torch.where(neg, fma_rn(1.0 + span.abs(), tol_t, span_c)
                           / neg_dd, inf)
    theta_max = torch.amin(torch.minimum(t_lo_rel, t_hi_rel), dim=-1)
    harris_cand = cand & (t_row <= theta_max[:, None])
    hval = dd.abs()
    if with_art:
        harris_cand = harris_cand | art_exit
        hval = hval + torch.where(art_exit, torch.full((), 1e30, dtype=dt,
                                                       device=dev), 0.0)
    r_harris = torch.argmax(torch.where(harris_cand, hval, -inf), dim=-1)
    eps = torch.finfo(dt).eps
    near = cand & (t_row <= (min_row + 64.0 * eps
                             * (1.0 + min_row.abs()))[:, None])
    r_bland = torch.argmin(torch.where(near, basis, _INT_MAX), dim=-1)
    r = torch.where(use_bland, r_bland, r_harris)
    rl = r[:, None]
    leave_up = t_hi.gather(1, rl)[:, 0] < t_lo.gather(1, rl)[:, 0]

    moving = live & ~optimal & ~unbounded
    do_pivot = moving & ~flip
    do_flip = moving & flip
    if devex:
        w = _devex_update_b(w, T, basis, r, s, do_pivot)

    z_min_old = -T[:, -1, -1]
    step_z = sigma * rc_s
    idx_c = torch.arange(N - 1, device=dev)
    s_hot = idx_c == sl
    row_hot = torch.arange(M - 1, device=dev) == rl
    x_enter = torch.where(s_from_up, ub_s_safe - theta_safe, theta_safe)
    xB_piv = torch.where(row_hot, x_enter[:, None],
                         fma_rn(-dd, theta_safe[:, None], xB))
    j_out = basis.gather(1, rl)
    T_upd, basis_upd = _pivot_update_b(T, basis, r, s, do_pivot)
    upd_row = do_pivot[:, None] & row_hot
    ub_B = torch.where(upd_row, ub_s[:, None], ub_B)
    if with_art:
        is_art_row = torch.where(upd_row, art_mask_ext.gather(1, sl),
                                 is_art_row)
    T_upd[:, :-1, -1] = torch.where(
        do_pivot[:, None], _clip_b(xB_piv, ub_B),
        torch.where(do_flip[:, None],
                    _clip_b(fma_rn(-dd, ub_s_safe[:, None], xB), ub_B), xB))
    T_upd[:, -1, -1] = -torch.where(
        do_pivot, fma_rn(step_z, theta_safe, z_min_old),
        torch.where(do_flip, fma_rn(step_z, ub_s_safe, z_min_old),
                    z_min_old))
    at_up_piv = torch.where(idx_c == j_out, leave_up[:, None], at_upper) \
        & ~s_hot
    at_upper = torch.where(do_pivot[:, None], at_up_piv,
                           torch.where(do_flip[:, None], at_upper ^ s_hot,
                                       at_upper))
    return (T_upd, basis_upd, at_upper, w, ub_B, is_art_row, s, r, optimal,
            unbounded, moving)


def _step(kind, T, basis, cm1f, cm2f, col_mask, phase, status, use_bland, w,
          tol, devex):
    """One pivot step of every instance; returns ``(T, basis, optimal,
    unbounded, active)``.  K2 and its twin update ``T``, ``basis`` and the
    padded (B, N) weights ``w`` in place; the unfused step returns new
    tensors for ``T`` and ``basis`` and writes ``w`` in place."""
    if kind != "unfused":
        step = fused_pivot_step_ if kind == "kernel" else fused_pivot_step_ref
        out = step(T, basis, cm1f, cm2f, phase, status, use_bland, w,
                   tol=tol, devex=devex)
        return T, basis, out[5], out[6], out[7]
    live = status == RUNNING
    s, r, optimal, unbounded = _select_pivot_b(
        T, basis, col_mask, tol, use_bland,
        weights=w[:, :-1] if devex else None)
    active = live & ~optimal & ~unbounded
    if devex:
        w[:, :-1] = _devex_update_b(w[:, :-1], T, basis, r, s, active)
    T, basis = _pivot_update_b(T, basis, r, s, active, clamp_rhs=True)
    return T, basis, optimal, unbounded, active


def _step_bounded(kind, T, basis, bst, cm1f, cm2f, col_mask, phase, status,
                  use_bland, w, ub, art_mask_ext, tol, devex, with_art):
    """One bounded step of every instance; ``bst`` holds the carried bound
    state ``at_upper``, ``ub_B`` and ``is_art_row``.  K3 and its twin
    update ``T``, ``basis``, ``bst`` and the padded (B, N) weights in place;
    the unfused step returns new ``T`` and ``basis``, stores new tensors in
    ``bst`` and writes ``w`` in place.  Returns ``(T, basis, optimal,
    unbounded, moving, flipped)``, ``flipped`` marking the moving
    instances whose step was a bound flip."""
    if kind != "unfused":
        step = (fused_pivot_step_bounded_ if kind == "kernel"
                else fused_pivot_step_bounded_ref)
        out = step(T, basis, bst["at_upper"], cm1f, cm2f, phase, status,
                   use_bland, w, ub, bst["ub_B"], bst["is_art_row"],
                   art_mask_ext, tol=tol, devex=devex, with_art=with_art)
    else:
        out = _bounded_step_b(T, basis, bst["at_upper"], col_mask,
                              phase == 1, status == RUNNING, use_bland,
                              w[:, :-1], ub, bst["ub_B"], bst["is_art_row"],
                              art_mask_ext, tol, devex, with_art)
        T, basis, bst["at_upper"], w[:, :-1], bst["ub_B"], \
            bst["is_art_row"] = out[:6]
    s, r, moving = out[6], out[7], out[10]
    # A pivot leaves s basic in row r; a flip changes no basis entry, and s
    # was nonbasic.
    flipped = moving & (basis.gather(1, r.long()[:, None])[:, 0] != s)
    return T, basis, out[8], out[9], moving, flipped


def solve_tableau_batch(T0, basis0, col_mask_p1, col_mask_p2,
                        obj_row_p1, obj_row_p2, need_p1,
                        tol: float = 1e-6, max_iters: int = 4096,
                        bland_after: int = 1024, feas_tol: float = 1e-5,
                        refactor_every: int = 64, backend: str = "auto",
                        devex: bool = False, phase2_only: bool = False):
    """Solve a batch of LPs sharing one padded tableau shape.

    Arguments and results as the JAX function: ``T0`` (B, m+1, n+1) as
    ``models.batched.compile_batch`` produces it (left intact: it is the
    refactorization anchor), ``basis0`` (B, m) int32, the (B, n) bool
    column masks, the (B, n+1) raw cost rows and the (B,) bool
    ``need_p1``, all on one device.  Returns ``(T, basis, status, iters,
    pivots)``: ``status`` (B,) int32 with scipy codes, ``iters`` the shared
    step count as a host int, ``pivots`` (B,) int32.

    ``backend``: ``"auto"`` and ``"pallas"`` run K2 (the CUDA kernel on a
    CUDA tensor, its twin on a CPU tensor), ``"pallas_interpret"`` K2's
    twin on any device, ``"xla"`` the unfused torch step.  ``phase2_only``
    (the caller asserts ``need_p1`` is all False) runs the loop without
    phase flips; see the module docstring for the chunked loop.
    """
    T, basis, _, status, iters, pivots, _ = _solve_loop(
        T0, basis0, col_mask_p1, col_mask_p2, obj_row_p1, obj_row_p2,
        need_p1, None, tol, max_iters, bland_after, feas_tol, refactor_every,
        backend, devex, phase2_only)
    return T, basis, status, iters, pivots


def solve_tableau_batch_bounded(T0, basis0, col_mask_p1, col_mask_p2,
                                obj_row_p1, obj_row_p2, need_p1, ub,
                                tol: float = 1e-6, max_iters: int = 4096,
                                bland_after: int = 1024,
                                feas_tol: float = 1e-5,
                                refactor_every: int = 64,
                                backend: str = "auto", devex: bool = False,
                                phase2_only: bool = False):
    """Solve a batch of LPs with native upper bounds ``0 <= x <= ub``.

    Arguments as :func:`solve_tableau_batch`, plus ``ub`` (B, n) in the
    tableau's dtype, +inf where a column is unbounded (slack, artificial
    and padding columns must be +inf; fixed columns, ``ub == 0``, masked
    out of both column masks by the compiler).  The step: a column enters
    from its lower bound when rc < -tol, from its upper bound when
    rc > tol; the step length is limited by a basic variable reaching 0
    or its own upper bound, or by the entering variable reaching its other
    bound, a bound flip (no basis change).  ``backend`` as in
    :func:`solve_tableau_batch`, with K3 in K2's place; ``phase2_only``
    batches have no artificial columns, so K3 runs without its
    artificial-exit rows.

    Returns ``(T, basis, at_upper, status, iters, pivots)``: ``at_upper``
    (B, n) bool marks the nonbasic columns at their upper bound, and
    ``pivots`` counts pivots and bound flips.
    """
    return _solve_loop(T0, basis0, col_mask_p1, col_mask_p2, obj_row_p1,
                       obj_row_p2, need_p1, ub, tol, max_iters, bland_after,
                       feas_tol, refactor_every, backend, devex,
                       phase2_only)[:6]


def _batch_chunk(st, cs, static, n_steps: int):
    """``n_steps`` steps of :func:`_solve_loop`, the chunk body that
    ``runtime/graphs.py`` runs eagerly or replays as one CUDA graph.  Each
    step writes its state in place (K2 and K3 update theirs themselves)
    and runs only while some instance is RUNNING (``go``), the reference's
    ``icond``: a step with none running changes no state tensor."""
    kind, bounded, phase2_only, tol, bland_after, feas_tol, devex = static
    i32 = torch.int32
    w, phase = st["w"], st["phase"]
    cm1f, cm2f = cs["cm1f"], cs["cm2f"]
    col_mask_p1, col_mask_p2 = cs["col_mask_p1"], cs["col_mask_p2"]
    art_mask_ext = cs["art_mask_ext"]
    for _ in graphs.steps(st, n_steps):
        T, basis, status = st["T"], st["basis"], st["status"]
        pivots, best_obj, no_imp = st["pivots"], st["best_obj"], st["no_imp"]
        to_p2 = st["to_p2"]
        running = status == RUNNING
        iters = st["iters"] + running.any()
        use_bland = no_imp >= bland_after
        col_mask = None
        if kind == "unfused":
            col_mask = col_mask_p2 if phase2_only else torch.where(
                (phase == 1)[:, None], col_mask_p1, col_mask_p2)
        bst = None
        if bounded:
            bst = {k: st[k] for k in ("at_upper", "ub_B", "is_art_row")}
            T, basis, optimal, unbounded, active, flipped = _step_bounded(
                kind, T, basis, bst, cm1f, cm2f, col_mask, phase, status,
                use_bland, w, cs["ub"], art_mask_ext, tol, devex,
                not phase2_only)
            # Stored with the carried bound state below.
            bst["flips"] = st["flips"] + flipped.to(i32)
        else:
            T, basis, optimal, unbounded, active = _step(
                kind, T, basis, cm1f, cm2f, col_mask, phase, status,
                use_bland, w, tol, devex)
        want_stop = (optimal | unbounded) & running
        if phase2_only:
            status = torch.where(
                want_stop & optimal, STATUS_OPTIMAL,
                torch.where(want_stop & unbounded, STATUS_UNBOUNDED,
                            status))
        else:
            # Phase-1 completion: infeasible is decided here; a feasible
            # instance idles until the chunk's end flips it.
            in_p1 = phase == 1
            p1_done = want_stop & in_p1
            infeasible = p1_done & (-T[:, -1, -1]
                                    > feas_tol * cs["b_scale"])
            to_p2 = p1_done & ~infeasible
            finish_p2 = want_stop & ~in_p1
            status = torch.where(
                infeasible, STATUS_INFEASIBLE,
                torch.where(finish_p2 & optimal, STATUS_OPTIMAL,
                            torch.where(finish_p2 & unbounded,
                                        STATUS_UNBOUNDED, status)))
        # Objective progress for the stall-gated Bland switch (the
        # threshold rounds once, as the reference's loop contracts it).
        obj_b = -T[:, -1, -1]
        improved = obj_b < fma_rn(1.0 + best_obj.abs(), cs["neg_tol"],
                                  best_obj)
        graphs.store(st, T=T, basis=basis, status=status, iters=iters,
                     pivots=pivots + active.to(i32),
                     best_obj=torch.minimum(best_obj, obj_b),
                     no_imp=torch.where(improved, 0,
                                        no_imp + active.to(i32)),
                     to_p2=to_p2, go=(status == RUNNING).any(),
                     **(bst or {}))


def _solve_loop(T0, basis0, col_mask_p1, col_mask_p2, obj_row_p1, obj_row_p2,
                need_p1, ub, tol, max_iters, bland_after, feas_tol,
                refactor_every, backend, devex, phase2_only,
                _on_first_chunk=None, start=None):
    """The chunked loop of both solvers; ``ub`` None is the classic one.
    Each chunk is :func:`_batch_chunk`, one CUDA graph on the card.
    ``_on_first_chunk`` (private) is called once, right after the first
    chunk has been enqueued: the batched stream issues the next batch's
    uploads there.  ``start`` (bounded ``phase2_only`` loops): ``(basis,
    at_upper, resume)``, a warm start; the instances marked in ``resume``
    go on from that basis and at-upper set, their tableau rebuilt from
    ``T0`` (:func:`_bounded_tableau`), and every other instance stops at
    once with the iteration limit.  A resumed instance whose basis is
    singular, or whose basic values, solved afresh, leave their bounds
    (:func:`_within_bounds`), starts over from ``basis0`` instead.
    Returns ``(T, basis, at_upper, status, iters, pivots, flips)``,
    ``at_upper`` None for the classic solver; ``flips`` (B,) int32 counts
    each instance's bound flips, which ``pivots`` includes (zeros for the
    classic solver)."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown batched backend {backend!r}; expected "
                         f"one of {sorted(_BACKENDS)}")
    kind = _BACKENDS[backend]
    bounded = ub is not None
    dev, dt = T0.device, T0.dtype
    Bsz, M, N = T0.shape
    i32 = torch.int32
    T0_rows = T0[:, :-1, :]
    zero_lane = torch.zeros((Bsz, 1), dtype=torch.bool, device=dev)
    art_mask_ext = torch.cat([col_mask_p1 & ~col_mask_p2, zero_lane], dim=1)
    state = {
        "T": T0.clone(),
        "basis": basis0.to(i32).clone(),
        "status": torch.full((Bsz,), RUNNING, dtype=i32, device=dev),
        "iters": torch.zeros((), dtype=torch.int64, device=dev),
        "pivots": torch.zeros((Bsz,), dtype=i32, device=dev),
        "flips": torch.zeros((Bsz,), dtype=i32, device=dev),
        "best_obj": torch.full((Bsz,), math.inf, dtype=dt, device=dev),
        "no_imp": torch.zeros((Bsz,), dtype=i32, device=dev),
        "w": torch.ones((Bsz, N), dtype=dt, device=dev),  # RHS lane 1
        "to_p2": torch.zeros((Bsz,), dtype=torch.bool, device=dev),
        "phase": torch.where(need_p1, 1, 2).to(i32),
        **graphs.step_state(dev),
    }
    consts = {
        "cm1f": torch.cat([col_mask_p1, zero_lane], dim=1),
        "cm2f": torch.cat([col_mask_p2, zero_lane], dim=1),
        "col_mask_p1": col_mask_p1, "col_mask_p2": col_mask_p2,
        "b_scale": 1.0 + torch.amax(T0[:, :-1, -1].abs(), dim=1),
        "neg_tol": torch.full((), -tol, dtype=dt, device=dev),
        "art_mask_ext": art_mask_ext,
    }
    if bounded:
        # The carried bound state, gathered by the initial basis.
        ub = ub.to(dt).contiguous()
        bl = state["basis"].long()
        state.update(
            at_upper=torch.zeros((Bsz, N - 1), dtype=torch.bool, device=dev),
            ub_B=ub.gather(1, bl).contiguous(),
            is_art_row=art_mask_ext.gather(1, bl).contiguous())
        consts["ub"] = ub
    if start is not None:
        basis_w, at_up_w, resume = start
        T_w, ok = _bounded_tableau(basis_w, at_up_w, ub, T0_rows,
                                   obj_row_p2)
        warm = ok & _within_bounds(T_w, basis_w, ub, consts["b_scale"])
        basis_w = torch.where(warm[:, None], basis_w.to(i32), state["basis"])
        state.update(
            T=torch.where(warm[:, None, None], T_w, T0),
            basis=basis_w, at_upper=at_up_w & warm[:, None],
            status=torch.where(resume, RUNNING,
                               STATUS_ITERATION_LIMIT).to(i32),
            ub_B=ub.gather(1, basis_w.long()).contiguous())
    static = (kind, bounded, bool(phase2_only), float(tol), int(bland_after),
              float(feas_tol), bool(devex))

    with graphs.Loop("batched.solve", state, consts, static) as lp:
        st = lp.state

        def obj_rows():
            """Each instance's raw cost row for its phase."""
            return torch.where((st["phase"] == 1)[:, None], obj_row_p1,
                               obj_row_p2)

        def refactor(raw_obj):
            active = st["status"] == RUNNING
            if bounded:
                return _refactor_bounded_b(st["T"], st["basis"],
                                           st["at_upper"], ub, T0_rows,
                                           raw_obj, active)
            return _refactor_b(st["T"], st["basis"], T0_rows, raw_obj,
                               active)

        iters_h, any_run = 0, 1
        # The reference refactors at the start of iteration k for
        # k = refactor_every - 1, 2*refactor_every - 1, ...
        next_ref = refactor_every - 1
        while any_run and iters_h < max_iters:
            if not phase2_only and iters_h == next_ref:
                st["T"].copy_(refactor(obj_rows()))
                next_ref += refactor_every
            n_steps = refactor_every if phase2_only else min(
                next_ref - iters_h, _FLIP_CHUNK)
            lp.run(_batch_chunk, min(n_steps, max_iters - iters_h))
            if _on_first_chunk is not None:
                _on_first_chunk()
                _on_first_chunk = None
            any_run, iters_h, any_flip = lp.read(
                (st["status"] == RUNNING).any(), st["iters"],
                st["to_p2"].any())
            if any_flip:
                _flip_to_phase2(st, bounded, ub, art_mask_ext, col_mask_p2,
                                obj_row_p2, tol, devex)
            if phase2_only and any_run and iters_h < max_iters:
                # Drift refactor at the chunk boundary, as the reference's
                # outer loop body.
                st["T"].copy_(refactor(obj_row_p2))

    # Final polish of x_B and the objective (see the JAX function).
    T, basis, phase = state["T"], state["basis"], state["phase"]
    raw = torch.where((phase == 1)[:, None], obj_row_p1, obj_row_p2)
    if bounded:
        T = _refine_solution_bounded_b(T, basis, basis0, T0_rows, raw,
                                       state["at_upper"], ub)
    else:
        T = _refine_solution_b(T, basis, basis0, T0_rows, raw)
    status = torch.where(state["status"] == RUNNING, STATUS_ITERATION_LIMIT,
                         state["status"])
    return (T, basis, state["at_upper"] if bounded else None, status,
            iters_h, state["pivots"], state["flips"])


def _flip_to_phase2(st, bounded, ub, art_mask_ext, col_mask_p2, obj_row_p2,
                    tol, devex):
    """The reference's phase flip, at a chunk's end, in place on the loop
    state: evict the artificials, install the phase-2 objective, and reset
    the progress state and the Devex framework of the instances in
    ``to_p2``."""
    T, basis, to_p2 = st["T"], st["basis"], st["to_p2"]
    flip_b = to_p2[:, None]
    if bounded:
        T_ev, basis_ev = _evict_artificials_bounded_b(
            T, basis, st["at_upper"], art_mask_ext, col_mask_p2, tol)
        # Eviction re-bases rows: refresh the carried row state.
        bl = basis_ev.long()
        st["ub_B"].copy_(torch.where(flip_b, ub.gather(1, bl), st["ub_B"]))
        st["is_art_row"].copy_(torch.where(
            flip_b, art_mask_ext.gather(1, bl), st["is_art_row"]))
        T_p2 = _price_out_b(T_ev, basis_ev, obj_row_p2)
        # The objective cell with the at-upper terms, which the price-out
        # cannot know about.
        _, z_up = _at_upper_terms(st["at_upper"], ub, obj_row_p2)
        T_p2[:, -1, -1] = -((obj_row_p2.gather(1, bl)
                             * T_p2[:, :-1, -1]).sum(-1) + z_up)
    else:
        T_ev, basis_ev = _evict_artificials_b(T, basis, art_mask_ext,
                                              col_mask_p2, tol)
        T_p2 = _price_out_b(T_ev, basis_ev, obj_row_p2)
    T.copy_(torch.where(flip_b[:, :, None], T_p2, T))
    basis.copy_(torch.where(flip_b, basis_ev, basis))
    st["phase"].copy_(torch.where(to_p2, 2, st["phase"]))
    st["best_obj"].copy_(torch.where(to_p2, math.inf, st["best_obj"]))
    st["no_imp"].copy_(torch.where(to_p2, 0, st["no_imp"]))
    if devex:
        st["w"].copy_(torch.where(flip_b, 1.0, st["w"]))
    to_p2.zero_()


def extract_solution_batch(T, basis, n_vars: int):
    """Batched decision-variable recovery: x from basic rows' RHS."""
    rhs = T[:, :-1, -1]                                           # (B, m)
    onehot = basis[:, :, None] == torch.arange(
        n_vars, dtype=basis.dtype, device=T.device)[None, None, :]
    x = torch.sum(torch.where(onehot, rhs[:, :, None], 0.0), dim=1)
    z_min = -T[:, -1, -1]
    return x, z_min


def extract_solution_batch_bounded(T, basis, at_upper, ub, n_vars: int):
    """Decision-variable recovery with bounds: the basic rows' RHS, and the
    at-upper nonbasic columns at their bound."""
    x, z_min = extract_solution_batch(T, basis, n_vars)
    ub_n = ub[:, :n_vars]
    ub_safe = torch.where(torch.isfinite(ub_n), ub_n, 0.0)
    return torch.where(at_upper[:, :n_vars], ub_safe, x), z_min


# Instances the float64 finish resumes at once: a (4096, 32, 640) float64
# tableau is 0.67 GB, and every full chunk's CUDA graph is one cache entry.
_FINISH_CHUNK = 4096


def finish_bounded_f64(T, T0, basis0, col_mask_p2, obj_row_p2, ub, basis,
                       at_upper, status, n_vars: int, *, tol, max_iters,
                       bland_after, refactor_every, backend, devex):
    """The answers of a float32 bounded ``phase2_only`` solve, its optimal
    instances taken on in float64 from where the float32 loop stopped.

    A float32 tableau of data a thousand times larger than 1 carries
    reduced costs whose rounding reaches the certifier's tolerance
    (``1e-7 (1 + max |c|)``), so a basis the float32 loop takes as optimal
    can fail the float64 check, and the instance then goes to the exact
    host engine.  Here each optimal instance's tableau is rebuilt in
    float64 from ``T0`` at its final basis and at-upper set, and the
    bounded loop (:func:`_solve_loop` with ``start``, K3 in float64) takes
    whatever steps remain, ``_FINISH_CHUNK`` instances at a time; most take
    none.  One whose final basis is infeasible in float64 (the float32
    loop's clipped right-hand side hid it) starts over from the initial
    basis.  The float64 loop clips its right-hand side too, so an instance
    whose answer, solved afresh from ``T0`` at the finish's final basis,
    still leaves its bounds (:func:`_within_bounds`) is returned with the
    iteration-limit status, as is one the finish leaves without a
    verdict: the certifier sends both to the exact host engine, and no
    answer keeps a basic value beyond its bound.  ``tol`` is the float64
    loop's: its ratio test passes over the rows whose entry is at most
    ``tol``, and a step of ``θ`` moves those by up to ``tol · θ`` unseen.

    ``T``, ``basis``, ``at_upper`` and ``status`` are the float32 solve's
    outputs, the rest its inputs.  Returns ``(x, z_min, status, basis,
    at_upper, steps, launches)``: ``x`` (B, n_vars) and ``z_min`` in
    float64 and the finish's own steps (pivots and flips) an instance,
    where the finish ends with a verdict; an instance not optimal in
    float32 keeps the float32 solve's answer and counts no step.
    ``launches`` is the loop iterations of every chunk, one K3 launch
    each."""
    dt = torch.float64
    x, z_min = extract_solution_batch_bounded(T, basis, at_upper, ub, n_vars)
    x, z_min = x.to(dt), z_min.to(dt)
    status, basis, at_upper = status.clone(), basis.clone(), at_upper.clone()
    steps = torch.zeros_like(status)
    launches = 0
    for s in range(0, T.shape[0], _FINISH_CHUNK):
        e = min(s + _FINISH_CHUNK, T.shape[0])
        obj = obj_row_p2[s:e].to(dt)
        cm = col_mask_p2[s:e]
        ub_c = ub[s:e].to(dt)
        T0_c = T0[s:e].to(dt)
        T_f, b_f, au_f, st_f, iters, piv_f, _ = _solve_loop(
            T0_c, basis0[s:e], cm, cm, obj, obj,
            torch.zeros_like(cm[:, 0]), ub_c, tol, max_iters, bland_after,
            1e-5, refactor_every, backend, devex, True,
            start=(basis[s:e], at_upper[s:e],
                   status[s:e] == STATUS_OPTIMAL))
        x_f, z_f = extract_solution_batch_bounded(T_f, b_f, au_f, ub_c,
                                                  n_vars)
        T_x, ok = _bounded_tableau(b_f, au_f, ub_c, T0_c[:, :-1, :], obj)
        inside = ok & _within_bounds(
            T_x, b_f, ub_c, 1.0 + T0_c[:, :-1, -1].abs().amax(1))
        done = (st_f == STATUS_UNBOUNDED) | ((st_f == STATUS_OPTIMAL)
                                            & inside)
        d1 = done[:, None]
        x[s:e] = torch.where(d1, x_f, x[s:e])
        z_min[s:e] = torch.where(done, z_f, z_min[s:e])
        resumed = status[s:e] == STATUS_OPTIMAL
        status[s:e] = torch.where(
            done, st_f, torch.where(resumed, STATUS_ITERATION_LIMIT,
                                    status[s:e]))
        basis[s:e] = torch.where(d1, b_f, basis[s:e])
        at_upper[s:e] = torch.where(d1, au_f, at_upper[s:e])
        steps[s:e] = torch.where(done, piv_f, 0)
        launches += iters
    return x, z_min, status, basis, at_upper, steps, launches
