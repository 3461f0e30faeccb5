"""Revised simplex with an explicit basis inverse, on torch (port of
``simplex_tpu/models/revised.py``).

BASELINE config 4 ("netlib-style LPs via revised simplex with
basis-factorization updates").  The engine keeps the m x m basis inverse
and the original columns on ``config.device`` and never forms the
tableau:

  pricing:    pi = c_B  B_inv,  rc = c - pi A
  FTRAN:      d  = B_inv a_s
  update:     eta rank-1 on B_inv, and an exact refactorization
              (``torch.linalg.solve_ex`` against the identity) every
              ``refactor_every`` iterations

with the bounded ratio test (basics blocked at 0 or at their upper bound,
or the entering column flipping to its opposite bound) and Devex pricing,
exactly as in the JAX engine.  The products are plain torch matmuls; the
engine has no hand-written kernel because its JAX counterpart has none.

Differences from the JAX module, all deliberate:

* The ``lax.while_loop`` becomes a host loop over chunks of device steps
  (the shape of ``ops/tableau.py::_run_phase``), each one CUDA graph on
  the card (``runtime/graphs.py``).  The state stays in
  device tensors, one step is branch-free (the reference's three-way
  switch stop / flip / pivot becomes updates masked by 0-d flags), a chunk
  stops at the first step whose loop condition no longer holds (on the
  card its later steps are a WHILE conditional node), and the host reads
  the state (status, iters, no_imp, the objective) once a chunk (counted
  in ``STATE_READS``).
* The refactor counter ``since`` lives on the host.  It counts loop
  iterations, and every step of a chunk that starts with the loop running
  is one until the loop stops, after which the counter no longer matters.
  So a chunk is the refactor period (its first is one shorter, since the
  counter starts at 1), and the refactor falls on the host read between
  two chunks, on the same iteration as in the JAX loop.
* ``basis`` is int64 (torch's index type); the JAX engine keeps int32.
* Results carry ``escalated`` (True when the host f64 engine decided the
  verdict), as the port's ``SimplexResult`` does.

The numpy parts (warm-basis check, f64 finalize and escalation) are copied
as they are.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig, DEFAULT_CONFIG, resolve_dtype, \
    torch_device
from ..core.problem import (
    LinearProgram,
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_MESSAGES,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
    compile_standard_form,
    lower_bounds_to_rows,
    merge_free_solution,
    normalize_bounds,
    split_free_variables,
)
from ..runtime import counters, graphs
from .dense import (
    SimplexResult,
    _finalize_on_host,
    _finalize_on_host_bounded,
    _host_simplex_f64,
)

RUNNING = -1
# Host reads of the loop state (one a chunk) since the counter was last
# reset to 0.
STATE_READS = 0
_INT_MAX = int(np.iinfo(np.int32).max)
_ART_BONUS = 1 << 20


def _refactor(A_std, b, basis, at_upper=None, ub=None):
    """Exact B_inv and x_B from the original data.

    With bounds, nonbasic-at-upper columns contribute their bound value:
    ``x_B = B_inv (b - A_U u_U)`` where U is the at-upper set.
    ``solve_ex`` reports a singular basis instead of raising, so the
    refactor never reads the device back (a singular B gives non-finite
    entries, as ``jnp.linalg.solve`` does).
    """
    B = A_std.index_select(1, basis)
    eye = torch.eye(B.shape[0], dtype=A_std.dtype, device=A_std.device)
    B_inv = torch.linalg.solve_ex(B, eye)[0].contiguous()
    if at_upper is None:
        x_B = B_inv @ b
    else:
        ub_safe = torch.where(torch.isfinite(ub), ub, 0.0)
        u_vec = torch.where(at_upper, ub_safe, 0.0)
        x_B = B_inv @ (b - A_std @ u_vec)
    return B_inv, x_B


def _objective(cs, basis, x_B, at_upper):
    """The phase objective with the at-upper nonbasics (for the stall gate
    only: the verdicts come from the f64 finalize)."""
    return (cs["cost_n"].index_select(0, basis) @ x_B
            + torch.sum(torch.where(at_upper, cs["cost_up"], 0.0)))


def _revised_chunk(st, cs, static, n_steps: int):
    """``n_steps`` steps of :func:`_run_phase_revised`'s loop, the chunk
    body that ``runtime/graphs.py`` runs eagerly or replays as one CUDA
    graph.  Each step writes its state in place and sets ``go`` to the
    next step's ``active``, the JAX loop's condition: a step that is not
    active changes nothing, so the chunk ends there."""
    tol, max_iters, bland_after, stall_limit, devex, in_phase2 = static
    i64 = torch.int64
    inf = math.inf
    A_std, cost_n, col_mask = cs["A_std"], cs["cost_n"], cs["col_mask"]
    ub, ub_safe, art_mask_ext = cs["ub"], cs["ub_safe"], cs["art_mask_ext"]
    art_bonus = cs["art_bonus"]
    k_run, k_opt, k_unb = cs["k_run"], cs["k_opt"], cs["k_unb"]
    eps = torch.finfo(A_std.dtype).eps
    B_inv, basis, at_upper = st["B_inv"], st["basis"], st["at_upper"]
    for _ in graphs.steps(st, n_steps):
        x_B, w, iters, status = st["x_B"], st["w"], st["iters"], st["status"]
        best_obj, no_imp = st["best_obj"], st["no_imp"]
        active = ((status == RUNNING) & (iters < max_iters)
                  & (no_imp < stall_limit))

        # Pricing: dual-infeasibility magnitude per nonbasic column.
        pi = cost_n.index_select(0, basis) @ B_inv
        rc = cost_n - pi @ A_std
        eligible = col_mask & torch.where(at_upper, rc > tol, rc < -tol)
        viol = torch.where(eligible, torch.abs(rc), -inf)
        use_bland = no_imp >= bland_after
        # argmax and argmin return the first extremum, as in JAX; Bland's
        # first eligible column is the argmax of the mask cast to int.
        if devex:
            s_price = torch.argmax(
                torch.where(eligible, (viol * viol) / w, -inf))
        else:
            s_price = torch.argmax(viol)
        s = torch.where(use_bland, torch.argmax(eligible.to(torch.int32)),
                        s_price)
        optimal = ~torch.any(eligible)
        ss = s.reshape(1)

        # FTRAN; sigma = +1 entering from lower, -1 from upper.
        d = B_inv @ A_std.index_select(1, ss)[:, 0]
        at_s = at_upper.index_select(0, ss)[0]
        dd = (1.0 - 2.0 * at_s.to(A_std.dtype)) * d
        ub_B = ub.index_select(0, basis)

        pos = dd > tol
        neg = (dd < -tol) & torch.isfinite(ub_B)
        # Backward-step clamps on both limits.
        t_lo = torch.where(pos, torch.clamp_min(x_B, 0.0)
                           / torch.where(pos, dd, 1.0), inf)
        cand = pos | neg
        if in_phase2:
            art_exit = (art_mask_ext.index_select(0, basis)
                        & (torch.abs(dd) > tol))
            t_lo = torch.where(art_exit, 0.0, t_lo)
            cand = cand | art_exit
        t_hi = torch.where(neg, torch.clamp_min(ub_B - x_B, 0.0)
                           / torch.where(neg, -dd, 1.0), inf)
        t_row = torch.minimum(t_lo, t_hi)
        min_row = torch.min(t_row)
        t_self = ub.index_select(0, ss)[0]            # entering's span
        theta = torch.minimum(min_row, t_self)
        unbounded = (~optimal) & torch.isinf(theta)
        # Bound flip: the entering variable reaches its opposite bound
        # before any basic variable blocks; the basis is unchanged.
        flip = (~optimal) & (~unbounded) & (t_self <= min_row)

        near = cand & (t_row <= min_row
                       + 64.0 * eps * (1.0 + torch.abs(min_row)))
        key = torch.where(near, basis - art_bonus.index_select(0, basis),
                          _INT_MAX)
        rr = torch.argmin(key).reshape(1)
        leave_up = t_hi.index_select(0, rr)[0] < t_lo.index_select(0, rr)[0]

        stop = optimal | unbounded
        new_status = torch.where(stop, torch.where(optimal, k_opt, k_unb),
                                 k_run)
        pivot = active & ~stop & ~flip
        flip = active & flip
        j_out = basis.index_select(0, rr)

        # x_B: a flip and a pivot both step by theta (a flip's theta is
        # t_self); a pivot puts the entering value in row r and clips
        # against the new basis' raw bounds (inf = no clip).
        x_new = x_B - dd * theta
        x_enter = torch.where(at_s, ub_safe.index_select(0, ss)[0] - theta,
                              theta)
        x_new.index_copy_(0, rr, torch.where(
            pivot, x_enter, x_new.index_select(0, rr)[0]).reshape(1))
        ub_B.index_copy_(0, rr, torch.where(
            pivot, t_self, ub_B.index_select(0, rr)[0]).reshape(1))
        x_B = torch.where(pivot | flip,
                          torch.minimum(torch.clamp_min(x_new, 0.0), ub_B),
                          x_B)

        # The eta update, written only where the step pivots: d is zeroed
        # otherwise and d[r] replaced by 1, so nothing non-finite enters.
        dr = torch.where(pivot, d.index_select(0, rr)[0], 1.0)
        row_r = B_inv.index_select(0, rr)[0]
        if devex:
            alpha = (row_r @ A_std) / dr                   # pivot row
            w_s = w.index_select(0, ss)
            w_new = torch.maximum(w, (alpha * alpha) * w_s)
            w_new.index_copy_(0, j_out, torch.clamp_min(w_s, 1.0))
            w_new.index_copy_(0, ss, torch.ones_like(w_s))
            w_new = torch.where(torch.max(w_new) > 1e8, 1.0, w_new)
            w = torch.where(pivot, w_new, w)
        er = row_r / dr
        B_inv.addr_(torch.where(pivot, d, 0.0), er, alpha=-1.0)
        B_inv.index_copy_(0, rr, torch.where(pivot, er, row_r)[None, :])

        basis.index_copy_(0, rr, torch.where(pivot, s, j_out[0]).reshape(1))
        at_upper.index_copy_(0, j_out, torch.where(
            pivot, leave_up, at_upper.index_select(0, j_out)[0]).reshape(1))
        at_upper.index_copy_(0, ss, torch.where(
            flip, ~at_s, at_s & ~pivot).reshape(1))

        obj = _objective(cs, basis, x_B, at_upper)
        improved = obj < best_obj - tol * (1.0 + torch.abs(best_obj))
        best_obj = torch.where(active, torch.minimum(best_obj, obj),
                               best_obj)
        moved = (active & ~stop).to(i64)
        no_imp = torch.where(active, torch.where(improved, 0, no_imp + moved),
                             no_imp)
        iters = iters + moved
        status = torch.where(active, new_status, status)
        graphs.store(st, x_B=x_B, w=w, iters=iters, status=status,
                     best_obj=best_obj, no_imp=no_imp,
                     go=((status == RUNNING) & (iters < max_iters)
                         & (no_imp < stall_limit)))


def _run_phase_revised(A_std, b, cost, col_mask, art_mask_ext,
                       B_inv, x_B, basis, at_upper, ub, iters0,
                       in_phase2: bool, tol: float = 1e-6,
                       max_iters: int = 8192, bland_after: int = 2048,
                       refactor_every: int = 64, devex: bool = False):
    """One phase of BOUNDED-VARIABLE revised simplex (see the JAX function
    for the rules).  The inputs are left intact.  Each chunk of steps is
    :func:`_revised_chunk`, one CUDA graph on the card.

    Returns ``(B_inv, x_B, basis, at_upper, iters, status, objective)``:
    tensors on the device for the first four, host numbers for the rest.
    """
    dev, dt = A_std.device, A_std.dtype
    i64 = torch.int64
    # f32 numeric-stall cutoff: exit after a full Bland budget of
    # consecutive non-improving pivots (the solver then escalates).
    stall_limit = bland_after + 1024

    def full(value, dtype):
        return torch.full((), value, dtype=dtype, device=dev)

    ub_safe = torch.where(torch.isfinite(ub), ub, 0.0)
    cost_n = cost[:-1]
    consts = {"A_std": A_std, "cost_n": cost_n, "col_mask": col_mask,
              "ub": ub, "ub_safe": ub_safe, "art_mask_ext": art_mask_ext,
              # an at-upper nonbasic's objective
              "cost_up": cost_n * ub_safe,
              "art_bonus": torch.where(art_mask_ext, _ART_BONUS, 0).to(i64),
              "k_run": full(RUNNING, i64), "k_opt": full(STATUS_OPTIMAL, i64),
              "k_unb": full(STATUS_UNBOUNDED, i64)}
    state = {"B_inv": B_inv.clone(), "x_B": x_B.clone(),
             "basis": basis.to(i64).clone(), "at_upper": at_upper.clone(),
             "w": torch.ones((A_std.shape[1],), dtype=dt, device=dev),
             "iters": full(int(iters0), i64), "status": full(RUNNING, i64),
             "best_obj": full(math.inf, dt), "no_imp": full(0, i64),
             **graphs.step_state(dev)}
    static = (float(tol), int(max_iters), int(bland_after), stall_limit,
              bool(devex), bool(in_phase2))

    n_steps = refactor_every - 1        # since starts at 1
    with graphs.Loop("revised.phase", state, consts, static) as lp:
        st = lp.state
        while True:
            lp.run(_revised_chunk, n_steps)
            st_, it, ni, obj = lp.read(
                st["status"], st["iters"], st["no_imp"],
                _objective(lp.consts, st["basis"], st["x_B"],
                           st["at_upper"]), dtype=torch.float64)
            counters.add(globals(), "STATE_READS")
            st_, it, ni = int(st_), int(it), int(ni)
            if not (st_ == RUNNING and it < max_iters and ni < stall_limit):
                break
            B_inv_new, x_B_new = _refactor(A_std, b, st["basis"],
                                           st["at_upper"], ub)
            st["B_inv"].copy_(B_inv_new)
            st["x_B"].copy_(x_B_new)
            n_steps = refactor_every
    if st_ == RUNNING:
        st_ = STATUS_ITERATION_LIMIT
    return (state["B_inv"], state["x_B"], state["basis"], state["at_upper"],
            it, st_, obj)


class RevisedSimplexSolver:
    """Single-LP revised simplex (basis-inverse maintenance) on
    ``config.device``."""

    def __init__(self, config: SolverConfig = DEFAULT_CONFIG):
        self.config = config

    def solve(self, lp: LinearProgram,
              warm_basis: Optional[np.ndarray] = None,
              _tol_scale: float = 1.0,
              warm_at_upper: Optional[np.ndarray] = None,
              _equilibrated: bool = False) -> SimplexResult:
        """Solve one LP; the same contract as the JAX engine's ``solve``
        (equilibration, native bounds, free-variable split, warm start
        from ``warm_basis`` / ``warm_at_upper``, f64 certification, the
        one-shot loose-tol retry and exact escalation).  Raises where
        ``config.device`` is a GPU and none is present."""
        t0 = time.perf_counter()
        device = torch_device(self.config.device)
        if self.config.presolve and not _equilibrated and lp.n_cons > 0:
            # Ruiz equilibration for netlib-style 1e±4 coefficient
            # spreads (core/presolve.equilibrate; identity under 1e3
            # range).
            from ..core.presolve import equilibrate

            lp_e, eq = equilibrate(lp)
            if not eq.identity:
                res = self.solve(lp_e, warm_basis, _tol_scale,
                                 warm_at_upper, _equilibrated=True)
                if res.x is not None:
                    res.x = eq.restore_x(res.x)
                    c_min = -lp.c if lp.maximize else lp.c
                    res.fun = float(c_min @ res.x)
                    res.z = (-res.fun if lp.maximize else res.fun) + 0.0
                res.duals = eq.restore_duals(res.duals)
                res.reduced_costs = eq.restore_reduced(res.reduced_costs)
                res.solve_time = time.perf_counter() - t0
                return res
        if lp.has_finite_bounds:
            lp_n, tr = normalize_bounds(lp)
            if not tr.identity:
                # Warm data lives in the NORMALIZED space: forward it.
                res = self.solve(lp_n, warm_basis, _tol_scale,
                                 warm_at_upper,
                                 _equilibrated=_equilibrated)
                if res.x is not None:
                    res.x = tr.restore_x(res.x)
                    c_min = -lp.c if lp.maximize else lp.c
                    res.fun = float(c_min @ res.x)
                    res.z = (-res.fun if lp.maximize else res.fun) + 0.0
                if res.reduced_costs is not None:
                    res.reduced_costs = tr.restore_reduced(
                        res.reduced_costs)
                res.solve_time = time.perf_counter() - t0
                return res
        if lp.has_free:
            lp2, fidx = split_free_variables(lp)
            res = self.solve(lp2, warm_basis, _tol_scale, warm_at_upper,
                             _equilibrated=_equilibrated)
            if res.x is not None:
                res.x = merge_free_solution(res.x, lp.n_vars, fidx)
            if res.reduced_costs is not None:
                res.reduced_costs = res.reduced_costs[: lp.n_vars]
            return res
        if lp.n_cons == 0:
            from .dense import solve_lp
            return solve_lp(lp, self.config)

        dtype, torch_dtype = resolve_dtype(self.config.dtype)
        sf = compile_standard_form(lp, dtype=np.float64, bounded=True)
        m_pad, n_pad = sf.m_pad, sf.n_pad
        ub_np = (sf.ub_ext if sf.ub_ext is not None
                 else np.full((n_pad,), np.inf))

        def dev(a, dt=None):
            a = np.ascontiguousarray(a if dt is None else a.astype(dt))
            return torch.as_tensor(a, device=device)

        A_std = dev(sf.tableau[:m_pad, :n_pad], dtype)
        b = dev(sf.tableau[:m_pad, n_pad], dtype)
        basis = dev(sf.basis, np.int64)
        at_up = torch.zeros((n_pad,), dtype=torch.bool, device=device)
        ub_dev = dev(ub_np, dtype)
        col_p1 = dev(sf.col_mask_p1, bool)
        col_p2 = dev(sf.col_mask_p2, bool)
        art_ext = dev(np.concatenate([sf.col_mask_p1 & ~sf.col_mask_p2,
                                      np.ones((m_pad,), bool)])[:n_pad])
        cost1 = dev(sf.obj_row_p1[:n_pad + 1], dtype)
        cost2 = dev(sf.obj_row_p2[:n_pad + 1], dtype)
        if device.type == "cuda":
            # Pricing, FTRAN, the Devex row and the refactor in full f32
            # (TF32 would keep about three decimal digits).
            torch.backends.cuda.matmul.allow_tf32 = False

        tol = max(self.config.tol, 1e-6 if dtype == np.float32 else 1e-9)
        tol *= _tol_scale
        max_iters = min(self.config.max_iters, 50 * (m_pad + n_pad))
        bland_after = min(self.config.bland_after, max_iters // 2)
        devex = self.config.pivot_rule == "devex"

        need_phase1 = sf.need_phase1
        if warm_basis is not None:
            wb = self._check_warm_basis(sf, warm_basis, warm_at_upper,
                                        ub_np)
            if wb is not None:
                basis = dev(wb[0], np.int64)
                at_up = dev(wb[1], bool)
                need_phase1 = False

        B_inv, x_B = _refactor(A_std, b, basis, at_up, ub_dev)
        iters = 0

        if need_phase1:
            B_inv, x_B, basis, at_up, iters, status, obj1 = \
                _run_phase_revised(
                    A_std, b, cost1, col_p1, art_ext, B_inv, x_B, basis,
                    at_up, ub_dev, iters, False, tol=tol,
                    max_iters=max_iters, bland_after=bland_after,
                    devex=devex)
            b_scale = 1.0 + float(np.max(np.abs(sf.tableau[:m_pad, n_pad])))
            if status != STATUS_OPTIMAL:
                return self._finish_failed(status, iters, lp, sf, t0)
            if obj1 > 1e-5 * b_scale:
                return self._finish_failed(STATUS_INFEASIBLE, iters,
                                           lp, sf, t0)

        B_inv, x_B, basis, at_up, nit, status, _ = _run_phase_revised(
            A_std, b, cost2, col_p2, art_ext, B_inv, x_B, basis, at_up,
            ub_dev, iters, True, tol=tol, max_iters=max_iters,
            bland_after=bland_after, devex=devex)
        basis_np = basis.cpu().numpy()
        at_up_np = at_up.cpu().numpy()

        # f64 verdict certification + escalation (see the JAX engine).
        escalated = False
        fin = (False, None, None, None)
        if status == STATUS_OPTIMAL:
            fin = _finalize_on_host_bounded(sf, lp, basis_np, at_up_np,
                                            sf64=sf)
            escalated = not fin[0]
        elif status in (STATUS_INFEASIBLE, STATUS_UNBOUNDED):
            escalated = True
        elif status == STATUS_ITERATION_LIMIT and \
                nit < self.config.max_iters:
            # Numeric-stall exit, not the user's cap: retry once with a
            # 10x looser device tol, and only then escalate.
            if _tol_scale == 1.0:
                res = self.solve(lp, warm_basis, _tol_scale=10.0,
                                 warm_at_upper=warm_at_upper,
                                 _equilibrated=_equilibrated)
                res.nit += nit
                res.solve_time = time.perf_counter() - t0
                return res
            escalated = True
        if escalated:
            if sf.ub_ext is not None:
                return self._escalate_bounded(lp, nit, t0)
            status, basis_np, nit2 = _host_simplex_f64(sf)
            nit += nit2
            if status == STATUS_OPTIMAL:
                fin = _finalize_on_host(sf, lp, basis_np, sf64=sf)
                if fin[1] is None:
                    return self._fail(STATUS_ITERATION_LIMIT, nit, t0, True)
        if status != STATUS_OPTIMAL:
            return self._fail(status, nit, t0, escalated)

        certified, x_full, duals, reduced = fin
        c_min = -lp.c if lp.maximize else lp.c
        if x_full is not None and (escalated or self.config.refine):
            x = x_full[: lp.n_vars]
        else:
            x_B_np = x_B.cpu().numpy().astype(np.float64)
            x = np.zeros((sf.n_pad,))
            x[basis_np] = x_B_np
            up = at_up_np & np.isfinite(ub_np)
            x[up] = ub_np[up]
            x = x[: lp.n_vars]
        fun = float(c_min @ x)
        z_user = (-fun if lp.maximize else fun) + 0.0
        return SimplexResult(
            x=np.maximum(x, 0.0), fun=fun, status=0, success=True,
            message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
            basis=basis_np, z=z_user,
            solve_time=time.perf_counter() - t0,
            duals=duals, reduced_costs=reduced,
            at_upper=at_up_np, escalated=escalated,
        )

    def _escalate_bounded(self, lp: LinearProgram, nit: int,
                          t0: float) -> SimplexResult:
        """Exact f64 escalation for bounded LPs: lower the (already
        normalized, lb=0) upper bounds onto rows and run the host f64
        reference engine, then report duals/reduced costs in the NATIVE
        sense (dual y restricted to the structural rows; rc = c - y'A),
        so the sensitivity contract matches the bounded fast path."""
        lp_rows = lower_bounds_to_rows(lp)
        sf_l = compile_standard_form(lp_rows, dtype=np.float64)
        status, basis_l, nit2 = _host_simplex_f64(sf_l)
        nit += nit2
        if status != STATUS_OPTIMAL:
            return self._fail(status, nit, t0, True)
        ok, x_full, duals_l, _ = _finalize_on_host(sf_l, lp_rows, basis_l,
                                                   sf64=sf_l)
        if x_full is None:
            return self._fail(STATUS_ITERATION_LIMIT, nit, t0, True)
        m = lp.n_cons
        x = x_full[: lp.n_vars]
        c_min = -lp.c if lp.maximize else lp.c
        user_sign = -1.0 if lp.maximize else 1.0
        duals = None if duals_l is None else duals_l[:m]
        reduced = None
        if duals is not None:
            row_sign = np.where(lp.b < 0, -1.0, 1.0)
            y_min = user_sign * row_sign * duals
            reduced = user_sign * (c_min - y_min @ lp.A)
        fun = float(c_min @ x)
        z_user = (-fun if lp.maximize else fun) + 0.0
        return SimplexResult(
            x=x, fun=fun, status=0, success=True,
            message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
            basis=basis_l, z=z_user,
            solve_time=time.perf_counter() - t0,
            duals=duals, reduced_costs=reduced, escalated=True,
        )

    @staticmethod
    def _check_warm_basis(sf, warm_basis, warm_at_upper=None, ub=None):
        """Validate a saved basis (+ optional at-upper set): right shape,
        no artificials, no basic-at-upper conflicts, invertible, and
        primal-feasible WITHIN BOUNDS for the new data:
        ``x_B = B^{-1}(b - A_U u_U)`` must sit in ``[0, ub_B]``.
        Returns ``(basis, at_upper)`` or None → cold start."""
        basis = np.asarray(warm_basis, dtype=np.int32).reshape(-1)
        if basis.shape[0] != sf.m_pad or np.any(basis < 0) or \
                np.any(basis >= sf.n_pad):
            return None
        art = sf.col_mask_p1 & ~sf.col_mask_p2
        if np.any(art[basis]):
            return None
        if ub is None:
            ub = np.full((sf.n_pad,), np.inf)
        ub = np.asarray(ub, np.float64)[: sf.n_pad]
        if warm_at_upper is None:
            at_up = np.zeros((sf.n_pad,), bool)
        else:
            at_up = np.asarray(warm_at_upper, bool).reshape(-1)
            if at_up.shape[0] != sf.n_pad:
                return None
            at_up = at_up & np.isfinite(ub)
            if np.any(at_up[basis]):
                return None            # basic columns cannot sit at-upper
        rows = sf.tableau.astype(np.float64)[: sf.m_pad]
        rhs = rows[:, sf.n_pad]
        if np.any(at_up):
            u_vec = np.where(at_up, np.where(np.isfinite(ub), ub, 0.0),
                             0.0)
            rhs = rhs - rows[:, : sf.n_pad] @ u_vec
        try:
            x_B = np.linalg.solve(rows[:, basis], rhs)
        except np.linalg.LinAlgError:
            return None
        if not np.all(np.isfinite(x_B)) or np.any(x_B < -1e-9):
            return None
        ub_B = ub[basis]
        fin = np.isfinite(ub_B)
        if np.any(x_B[fin] > ub_B[fin] + 1e-9):
            return None
        return basis, at_up

    def _finish_failed(self, status: int, nit: int, lp, sf,
                       t0: float) -> SimplexResult:
        """Phase-1 failure: certify infeasibility in f64 before reporting."""
        if sf.ub_ext is not None:
            # Bounded problem: the classic host engine would drop the upper
            # bounds — escalate through the row-lowered exact solve instead.
            return self._escalate_bounded(lp, nit, t0)
        status2, basis2, nit2 = _host_simplex_f64(sf)
        nit += nit2
        if status2 != STATUS_OPTIMAL:
            return self._fail(status2, nit, t0, True)
        _, x_full, duals, reduced = _finalize_on_host(sf, lp, basis2,
                                                      sf64=sf)
        if x_full is None:
            return self._fail(status, nit, t0, True)
        c_min = -lp.c if lp.maximize else lp.c
        x = x_full[: lp.n_vars]
        fun = float(c_min @ x)
        z_user = (-fun if lp.maximize else fun) + 0.0
        return SimplexResult(
            x=np.maximum(x, 0.0), fun=fun, status=0, success=True,
            message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
            basis=basis2, z=z_user, solve_time=time.perf_counter() - t0,
            duals=duals, reduced_costs=reduced, escalated=True,
        )

    @staticmethod
    def _fail(status: int, nit: int, t0: float,
              escalated: bool = False) -> SimplexResult:
        return SimplexResult(
            x=None, fun=None, status=status, success=False,
            message=STATUS_MESSAGES.get(status, "Unknown status."),
            nit=nit, solve_time=time.perf_counter() - t0,
            escalated=escalated,
        )
