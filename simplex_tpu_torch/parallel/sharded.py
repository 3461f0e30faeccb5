"""Row-block sharded simplex on ``torch.distributed`` (port of
``simplex_tpu/parallel/sharded.py``).

The constraint rows of the tableau are split in blocks across the ``row``
axis of a (batch, row) mesh of ranks, independent LP instances across its
``batch`` axis.  One rank holds one device (a CUDA card under NCCL, or the
CPU under gloo) and runs the pivot loop on its own block; the collectives
run over the process group of its row:

  * pricing         — replicated (every rank of a row holds the objective
                      row), no communication;
  * ratio test      — local minima, then MIN / MAX all-reduces over the row
                      for the minimum ratio, the Harris bound, the largest
                      pivot element and the unique owner row's key;
  * pivot row       — a SUM all-reduce of the owner's normalized row (every
                      other rank adds zeros, so the sum is exact);
  * rank-1 update   — row-parallel, no communication (an in-place
                      ``addr_``, or ``baddbmm_`` for several instances).

The reference's six (classic Devex) or ten (bounded) reductions a pivot are
packed into four all-reduces: in each packed sum exactly one rank adds a
nonzero value, so the packed results are bit-identical to separate ones.

Differences from the JAX module, all of them in how the loop runs:

* ``shard_map`` over a ``lax.while_loop`` becomes a loop on each rank, on
  its own device, with one host read of the loop state a chunk of at most
  ``_CHUNK`` steps (``ops/batched.py``'s rule); on the card each chunk,
  its NCCL collectives included, is one replayed CUDA graph
  (``runtime/graphs.py``).  Every rank issues the same collectives in the
  same order, so the host branches only on state that is replicated
  across a row: the chunk cuts (a chunk ends before the next drift
  resync, so the resync is always a chunk's first step), the phase
  flip's reprice (run on every step, masked by ``to_p2``, while the last
  read showed a RUNNING instance in phase 1).  Within a chunk the steps
  stop at the reference's ``cond``: a step runs only while some instance
  of the batch shard is RUNNING (``graphs.steps``).  The status is
  computed from row-reduced values and the replicated objective row
  only, so that flag is the same on every rank of a row, with no
  collective of its own.  ``iters`` counts the steps taken, as the
  reference's does.
* Columns and rows are read with ``gather`` where the reference contracts
  a one-hot vector against the whole tableau for more than one instance.
* torch tensors carry no sharding: each rank passes its own shards in and
  gets its own shards back, and :func:`extract_solution_sharded` takes the
  mesh.

Without a process group only the 1x1 mesh exists, and its collectives are
the identity.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import torch_device
from ..runtime import graphs
from ..utils.profiling import recorded, trace_span
from ..core.problem import (
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
)

RUNNING = -1
_INT_MAX = int(np.iinfo(np.int32).max)
_ART_BONUS = 1 << 20  # tie-break bonus: artificial-basic rows leave first

# Steps between host reads of the loop state.
_CHUNK = 32

# Integers below this are exact in the dtype: a column index packs into the
# float SUM of the pivot row only below it.
_EXACT_INT = {torch.float32: 2 ** 24, torch.float64: 2 ** 53}

_MIN, _MAX, _SUM = dist.ReduceOp.MIN, dist.ReduceOp.MAX, dist.ReduceOp.SUM
# The all-gather into one tensor, under the name the installed torch has.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Mesh:
    """A (batch, row) layout of ranks, the counterpart of JAX's ``Mesh``
    (one device a rank).

    ``shape`` is ``{"batch": b, "row": r}`` as JAX's.  Mesh position ``k``
    sits at ``(k // r, k % r)``, JAX's ``reshape(batch, row)``.
    ``row_group`` and ``batch_group`` are the process groups of this rank's
    row and batch; both are None on the 1x1 mesh without a process group,
    whose collectives are the identity.
    """

    def __init__(self, batch: int, row: int, index: int = 0,
                 row_group=None, batch_group=None):
        self.shape = {"batch": batch, "row": row}
        self.batch_index, self.row_index = divmod(index, row)
        self.row_group = row_group
        self.batch_group = batch_group


def _group(ranks, world):
    """The process group of ``ranks`` (the world's own where they are all
    of it).  Every rank of the world must call this in the same order."""
    if list(ranks) == list(range(world)):
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(batch: int = 1, row: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a (batch, row) mesh over the ranks of the process group.

    ``devices``: the ranks to lay out, in increasing order (default every
    rank); the first ``batch * row`` form the mesh, and this rank must be
    among them.  Every rank calls this with the same arguments (the groups
    are created collectively).  Without a process group only the 1x1 mesh
    exists.
    """
    need = batch * row
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(
                f"mesh {batch}x{row} needs {need} ranks; without a process "
                "group (parallel.distributed.initialize) only 1x1 exists")
        return Mesh(1, 1)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(d)
                                                        for d in devices]
    if need > len(ranks):
        raise ValueError(f"mesh {batch}x{row} needs {need} ranks, have "
                         f"{len(ranks)}")
    ranks = ranks[:need]
    if ranks != sorted(set(ranks)):
        raise ValueError(f"mesh ranks must increase: {ranks}")
    row_groups = [_group(ranks[k * row:(k + 1) * row], world)
                  for k in range(batch)]
    batch_groups = [_group(ranks[k::row], world) for k in range(row)]
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the {batch}x{row} mesh")
    k = ranks.index(me)
    return Mesh(batch, row, k, row_groups[k // row], batch_groups[k % row])


def _reduce(x, op, group):
    """All-reduce ``x`` in place over ``group`` (the identity without one)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _gather(x, group, n):
    """``x`` from the ``n`` ranks of ``group`` stacked on a new first axis,
    in group order (``x[None]`` without a group)."""
    if group is None:
        return x[None]
    x = x.contiguous().reshape((1,) + tuple(x.shape))
    out = x.new_empty((n,) + tuple(x.shape[1:]))
    # The concatenated form, which every backend takes.
    _all_gather(out, x, group=group)
    return out


def _gather_rows(x, mesh):
    """Tiled all-gather along axis 1 over the row: (B, m_loc) -> (B, m)."""
    n = mesh.shape["row"]
    out = _gather(x, mesh.row_group, n)
    return out.transpose(0, 1).reshape(x.shape[0], n * x.shape[1])


def _gather_batch(x, mesh):
    """Concatenation along axis 0 over the batch: (B_loc, ...) -> (B, ...).
    Bool tensors travel as uint8."""
    was_bool = x.dtype == torch.bool
    out = _gather(x.to(torch.uint8) if was_bool else x, mesh.batch_group,
                  mesh.shape["batch"])
    out = out.reshape((-1,) + tuple(x.shape[1:]))
    return out.bool() if was_bool else out


def _matvec(M, v):
    """(B, m, n) @ (B, n) -> (B, m)."""
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def _scatter_cols(cs, idx_full, val_full):
    """Per-row values at their basis columns: (B, m) -> (B, N+1).  Basis
    columns are distinct within an instance, so the add sets."""
    T0 = cs["T0_loc"]
    return torch.zeros((T0.shape[0], T0.shape[2]), dtype=T0.dtype,
                       device=T0.device).scatter_add_(
        1, idx_full.long(), val_full)


def _newton_rhs(cs, rg, n_row, T_cur, basis_cur, u_vec=None):
    """One sharded Newton step on x_B against the original data, kept only
    where it lowers the residual and stays finite (see the JAX function).
    Returns the refined RHS column (B, m_loc)."""
    T0_loc = cs["T0_loc"]
    b0_loc = T0_loc[:, :, -1]
    xB_loc = T_cur[:, :, -1]
    b_eff = b0_loc if u_vec is None else b0_loc - _matvec(T0_loc, u_vec)
    basis_full = _gather_rows_in(basis_cur, rg, n_row)
    xfull = _scatter_cols(cs, basis_full, _gather_rows_in(xB_loc, rg, n_row))
    r0_loc = b_eff - _matvec(T0_loc, xfull)
    rfull = _scatter_cols(cs, cs["basis0_full"],
                          _gather_rows_in(r0_loc, rg, n_row))
    xB1_loc = xB_loc + _matvec(T_cur, rfull)
    xfull1 = _scatter_cols(cs, basis_full,
                           _gather_rows_in(xB1_loc, rg, n_row))
    r1_loc = b_eff - _matvec(T0_loc, xfull1)
    ss = _reduce(torch.stack([(r0_loc * r0_loc).sum(1),
                              (r1_loc * r1_loc).sum(1)]), _SUM, rg)
    finite = _reduce(torch.all(torch.isfinite(xB1_loc), dim=1)
                     .to(torch.int32), _MIN, rg) > 0
    better = (ss[1] < ss[0]) & finite
    return torch.where(better[:, None], xB1_loc, xB_loc)


def _reprice(cs, rg, T_cur, basis_cur, raw_obj):
    """Exact reduced costs for the current rows: raw - c_B' T_rows."""
    cB = torch.where(cs["rv"], raw_obj.gather(1, basis_cur.long()), 0.0)
    local_dot = torch.bmm(cB[:, None, :], T_cur)[:, 0]
    return raw_obj - _reduce(local_dot, _SUM, rg)


def _at_upper_vec(cs, at_upper):
    """The at-upper columns at their bound, with the RHS slot 0."""
    return torch.cat([torch.where(at_upper, cs["ub_safe"], 0.0),
                      cs["zero_col"]], dim=1)


def _cost_at_upper(cs, raw_obj, at_upper):
    return torch.where(at_upper, raw_obj[:, :-1] * cs["ub_safe"],
                       0.0).sum(1)


def _gather_rows_in(x, rg, n_row):
    """:func:`_gather_rows` over the row group ``rg`` of ``n_row`` ranks."""
    out = _gather(x, rg, n_row)
    return out.transpose(0, 1).reshape(x.shape[0], n_row * x.shape[1])


def _sharded_chunk(st, cs, static, n_steps: int, resync_first: bool,
                   any_p1: bool):
    """``n_steps`` pivot steps of :func:`_sharded_body`'s loop, the chunk
    body that ``runtime/graphs.py`` runs eagerly or replays as one CUDA
    graph (with its collectives).  Each step writes its state in place
    and runs only while some instance of this batch shard is RUNNING
    (``go``, the reference's ``cond``): a step with none running changes
    no state tensor.  The drift resync runs on the first step where
    ``resync_first``; the phase flip's reprice on every step while
    ``any_p1``."""
    (tol, feas_tol, bland_after, devex, bounded, rg, n_row) = static
    T = st["T"]
    Bl, m_loc, N1 = T.shape
    N = N1 - 1
    dt = T.dtype
    i32 = torch.int32
    inf = math.inf
    rv, col_idx, art_ext = cs["rv"], cs["col_idx"], cs["art_ext"]
    col_mask_p1, col_mask_p2 = cs["col_mask_p1"], cs["col_mask_p2"]
    obj_row_p1, obj_row_p2 = cs["obj_row_p1"], cs["obj_row_p2"]
    ub, ub_ext = cs["ub"], cs["ub_ext"]
    eps = torch.finfo(dt).eps
    pack_int = N1 < _EXACT_INT[dt]
    use_j = devex or bounded

    def pmin(x):
        return _reduce(x, _MIN, rg)

    def pmax(x):
        return _reduce(x, _MAX, rg)

    def psum(x):
        return _reduce(x, _SUM, rg)

    for k in graphs.steps(st, n_steps):
        basis, obj, phase, status = st["basis"], st["obj"], st["phase"], \
            st["status"]
        w, best_obj, no_imp, at_upper = st["w"], st["best_obj"], \
            st["no_imp"], st["at_upper"]
        live = status == RUNNING
        in_p1 = phase == 1
        col_mask = torch.where(in_p1[:, None], col_mask_p1, col_mask_p2)
        raw_obj = torch.where(in_p1[:, None], obj_row_p1, obj_row_p2)
        use_bland = no_imp >= bland_after

        # ---- periodic drift resync: the RHS column and the objective
        # row, on a chunk's first step (every rank together) ------------ #
        if k == 0 and resync_first:
            xB_n = _newton_rhs(cs, rg, n_row, T, basis,
                               _at_upper_vec(cs, at_upper) if bounded
                               else None)
            obj_n = _reprice(cs, rg, T, basis, raw_obj)
            cB = torch.where(rv, raw_obj.gather(1, basis.long()), 0.0)
            z_min = psum((cB * xB_n).sum(1))
            if bounded:
                z_min = z_min + _cost_at_upper(cs, raw_obj, at_upper)
            obj_n[:, -1] = raw_obj[:, -1] - z_min
            T[:, :, -1] = torch.where(live[:, None], xB_n, T[:, :, -1])
            obj = torch.where(live[:, None], obj_n, obj)

        # ---- pricing (replicated, no communication) ---------------- #
        rc = obj[:, :-1]
        if bounded:
            eligible = (col_mask & ~at_upper & (rc < -tol)) \
                | (col_mask & at_upper & (rc > tol))
            viol = torch.where(eligible, rc.abs(), -inf)
            if devex:
                s_price = torch.argmax(
                    torch.where(eligible, (viol * viol) / w, -inf), dim=-1)
            else:
                s_price = torch.argmax(viol, dim=-1)
        else:
            rc_m = torch.where(col_mask, rc, inf)
            eligible = rc_m < -tol
            if devex:
                s_price = torch.argmax(
                    torch.where(eligible, (rc_m * rc_m) / w, -inf), dim=-1)
            else:
                s_price = torch.argmin(rc_m, dim=-1)
        # argmax of a bool mask needs an integer type on CUDA.
        s = torch.where(use_bland,
                        torch.argmax(eligible.to(i32), dim=-1), s_price)
        optimal = ~torch.any(eligible, dim=-1)
        sl = s[:, None]

        # ---- ratio test (local, then MIN / MAX over the row) ------- #
        col_loc = T.gather(2, s[:, None, None].expand(Bl, m_loc, 1))[
            :, :, 0]
        rhs_loc = T[:, :, -1].clone()
        basis_l = basis.long()
        is_art_row = art_ext.gather(1, basis_l)
        if bounded:
            s_from_up = at_upper.gather(1, sl)[:, 0]
            sigma = torch.where(s_from_up, -1.0, 1.0).to(dt)
            rc_s = rc.gather(1, sl)[:, 0]
            ub_s = ub.gather(1, sl)[:, 0]
            ub_s_safe = torch.where(torch.isfinite(ub_s), ub_s, 0.0)
            dd_loc = sigma[:, None] * col_loc
            ub_B_loc = ub_ext.gather(1, basis_l)
        else:
            dd_loc = col_loc
        positive = (dd_loc > tol) & rv
        # Phase 2 only: artificial-basic rows with a nonzero entry
        # leave at ratio 0.
        art_exit = ((~in_p1)[:, None] & is_art_row
                    & (dd_loc.abs() > tol) & rv)
        # Backward-step clamp — see ops/tableau.select_pivot.
        rhs_c = torch.clamp_min(rhs_loc, 0.0)
        t_lo = torch.where(positive,
                           rhs_c / torch.where(positive, dd_loc, 1.0), inf)
        t_lo = torch.where(art_exit, 0.0, t_lo)
        if bounded:
            negd = (dd_loc < -tol) & rv & torch.isfinite(ub_B_loc)
            span_c = torch.clamp_min(ub_B_loc - rhs_loc, 0.0)
            t_hi = torch.where(
                negd, span_c / torch.where(negd, -dd_loc, 1.0), inf)
            ratios = torch.minimum(t_lo, t_hi)
            cand = positive | negd | art_exit
        else:
            ratios = t_lo
            cand = positive | art_exit
        # Harris pass 1: the tol-relaxed bound (packed with the ratio
        # minimum into one MIN).
        delta = tol * (1.0 + rhs_loc.abs())
        theta_relax = torch.where(
            positive,
            (rhs_c + delta) / torch.where(positive, dd_loc, 1.0), inf)
        if bounded:
            delta_hi = tol * (1.0 + (ub_B_loc - rhs_loc).abs())
            theta_relax = torch.minimum(theta_relax, torch.where(
                negd, (span_c + delta_hi)
                / torch.where(negd, -dd_loc, 1.0), inf))
        mins = pmin(torch.stack([torch.amin(ratios, dim=1),
                                 torch.amin(theta_relax, dim=1)]))
        global_min, theta_max = mins[0], mins[1]
        if bounded:
            theta_all = torch.minimum(global_min, ub_s)
            unbounded = ~optimal & torch.isinf(theta_all)
            do_flip = ~optimal & ~unbounded & (ub_s <= global_min)
            theta_safe = torch.where(torch.isfinite(theta_all),
                                     theta_all, 0.0)
        else:
            unbounded = ~optimal & torch.isinf(global_min)

        # Harris pass 2: the largest pivot element under the bound;
        # artificial-exit rows get a bonus above any magnitude.
        harris_cand = (cand & (ratios <= theta_max[:, None])) | art_exit
        hval = torch.where(harris_cand,
                           dd_loc.abs() + art_exit.to(dt) * 1e30, -inf)
        hmax = pmax(torch.amax(hval, dim=1))
        harris_rows = harris_cand & (hval == hmax[:, None])

        # Bland (stall) mode: smallest basis index among near-minimal
        # ratios.
        near = cand & (ratios <= (global_min + 64.0 * eps
                                  * (1.0 + global_min.abs()))[:, None])
        sel_cand = torch.where(use_bland[:, None], near, harris_rows)
        # The unique owner: the least key over the row (basis columns
        # are distinct within an instance; artificial rows win ties).
        key_row = basis_l - torch.where(is_art_row, _ART_BONUS, 0)
        key = torch.where(sel_cand, key_row, _INT_MAX)
        global_key = pmin(torch.amin(key, dim=1))
        owner_rows = sel_cand & (key_row == global_key[:, None])
        has_owner = torch.any(owner_rows, dim=1)
        r_loc = torch.argmax(owner_rows.to(i32), dim=1)

        # ---- pivot-row broadcast: one SUM of the owner's row and its
        # scalars (every other rank adds zeros) ---------------------- #
        r_idx = r_loc[:, None, None].expand(Bl, 1, N1)
        piv_row_own = T.gather(1, r_idx)[:, 0, :]
        pivot_own = piv_row_own.gather(1, sl)[:, 0]
        safe = torch.where(has_owner & (pivot_own.abs() > 0), pivot_own,
                           1.0)
        contrib = torch.where(has_owner[:, None],
                              piv_row_own / safe[:, None], 0.0)
        extra = []
        if use_j:
            j_own = torch.where(owner_rows, basis_l, 0).sum(1)
            if pack_int:
                extra.append(j_own.to(dt))
        if bounded:
            extra += [
                torch.where(owner_rows, t_lo, 0.0).sum(1),
                torch.where(owner_rows, torch.where(
                    torch.isfinite(t_hi), t_hi, 0.0), 0.0).sum(1),
                (owner_rows & ~torch.isfinite(t_hi)).to(dt).sum(1)]
        packed = psum(torch.cat([contrib] + [e[:, None] for e in extra],
                                dim=1))
        piv_row = packed[:, :N1]
        # The clamped step theta = max(rhs_r, 0)/pivot — see
        # ops/tableau.pivot_update.
        piv_row[:, -1] = torch.clamp_min(piv_row[:, -1], 0.0)
        if use_j:
            j_out = (packed[:, N1].long() if pack_int
                     else psum(j_own.clone()))
        if bounded:
            k = N1 + int(pack_int)
            t_lo_own = packed[:, k]
            t_hi_own = torch.where(packed[:, k + 2] > 0, inf,
                                   packed[:, k + 1])
            leave_up = t_hi_own < t_lo_own
            step = torch.minimum(torch.minimum(t_lo_own, t_hi_own),
                                 theta_safe)
            step = torch.where(torch.isfinite(step), step, 0.0)

        # ---- decide action per instance ---------------------------- #
        want_stop = (optimal | unbounded) & live
        p1_done = want_stop & in_p1
        infeasible = p1_done & (-obj[:, -1] > feas_tol * cs["b_scale"])
        to_p2 = p1_done & ~infeasible
        finish_p2 = want_stop & ~in_p1
        # The step's last writes go straight into the state tensors
        # (in place or ``out=``): no copy ends the step.
        status = status.masked_fill_(finish_p2 & unbounded, STATUS_UNBOUNDED) \
            .masked_fill_(finish_p2 & optimal, STATUS_OPTIMAL) \
            .masked_fill_(infeasible, STATUS_INFEASIBLE)
        active = live & ~want_stop
        if bounded:
            do_flip_now = active & do_flip
            do_pivot_now = active & ~do_flip
        else:
            do_pivot_now = active

        # ---- Devex weights (replicated; pre-pivot pivot row) ------- #
        if devex:
            w_s = w.gather(1, sl)
            alpha = piv_row[:, :-1]
            w_new = torch.maximum(w, (alpha * alpha) * w_s)
            w_new = torch.where(col_idx == j_out[:, None],
                                torch.clamp_min(w_s, 1.0), w_new)
            w_new = torch.where(col_idx == sl, 1.0, w_new)
            w_new = torch.where(w_new.amax(dim=1, keepdim=True) > 1e8,
                                1.0, w_new)
            w = torch.where(do_pivot_now[:, None], w_new, w, out=w)

        # ---- rank-1 update in place, masked (no communication) ----- #
        # A masked instance's column is scaled to 0 and its row to 0,
        # so its rows stay as they are; then the owner row is written.
        col_m = col_loc * do_pivot_now.to(dt)[:, None]
        piv_m = torch.where(do_pivot_now[:, None], piv_row, 0.0)
        if Bl == 1:
            T[0].addr_(col_m[0], piv_m[0], alpha=-1)
        else:
            T.baddbmm_(col_m[:, :, None], piv_m[:, None, :], alpha=-1)
        own_now = (do_pivot_now & has_owner)[:, None, None]
        T.scatter_(1, r_idx, torch.where(own_now, piv_row[:, None, :],
                                         T.gather(1, r_idx)))
        own_piv = do_pivot_now[:, None] & owner_rows
        if bounded:
            # Explicit bounded RHS (see the JAX function).
            z_old = -obj[:, -1]
            x_enter = torch.where(s_from_up, ub_s_safe - step, step)
            rhs_piv = rhs_loc - dd_loc * step[:, None]
            rhs_piv = torch.where(owner_rows, x_enter[:, None], rhs_piv)
            ub_B_new = ub_ext.gather(
                1, torch.where(owner_rows, sl, basis_l))
            rhs_piv = torch.minimum(torch.clamp_min(rhs_piv, 0.0),
                                    ub_B_new)
            rhs_flip = torch.minimum(torch.clamp_min(
                rhs_loc - dd_loc * ub_s_safe[:, None], 0.0), ub_B_loc)
            T[:, :, -1] = torch.where(
                do_pivot_now[:, None], rhs_piv,
                torch.where(do_flip_now[:, None], rhs_flip, rhs_loc))
        basis = torch.where(own_piv, s[:, None].to(i32), basis, out=basis)

        # ---- objective row (replicated) ---------------------------- #
        obj_new = obj - obj.gather(1, sl) * piv_row
        if bounded:
            z_piv = z_old + sigma * rc_s * step
            z_flip = z_old + sigma * rc_s * ub_s_safe
            obj = torch.where(do_pivot_now[:, None], obj_new, obj,
                              out=st["obj"])
            obj[:, -1] = torch.where(
                do_pivot_now, -z_piv,
                torch.where(do_flip_now, -z_flip, obj[:, -1]))
            # at-upper bookkeeping: the leaving column exits at its
            # bound; the entering or flipping column toggles.
            jout_hot = col_idx == j_out[:, None]
            s_hot = col_idx == sl
            at_up_piv = torch.where(jout_hot, leave_up[:, None], at_upper)
            at_up_piv = at_up_piv & ~s_hot
            at_upper = torch.where(
                do_pivot_now[:, None], at_up_piv,
                torch.where(do_flip_now[:, None], at_upper ^ s_hot,
                            at_upper), out=at_upper)
        else:
            obj = torch.where(active[:, None], obj_new, obj, out=st["obj"])

        # ---- objective progress (stall-gated Bland) ---------------- #
        obj_val = -obj[:, -1]
        improved = obj_val < best_obj - tol * (1.0 + best_obj.abs())
        best_obj = torch.minimum(best_obj, obj_val, out=best_obj)
        no_imp = torch.add(no_imp, active.to(i32), out=no_imp) \
            .masked_fill_(improved, 0)

        # ---- phase flip: the phase-2 objective, priced out; masked by
        # to_p2 and run by every rank while any may flip ------------- #
        if any_p1:
            priced = _reprice(cs, rg, T, basis, obj_row_p2)
            if bounded:
                priced[:, -1] -= _cost_at_upper(cs, obj_row_p2, at_upper)
            torch.where(to_p2[:, None], priced, obj, out=obj)
            phase.masked_fill_(to_p2, 2)
        best_obj.masked_fill_(to_p2, inf)
        no_imp.masked_fill_(to_p2, 0)
        if devex:
            w.masked_fill_(to_p2[:, None], 1.0)
        st["iters"].add_(live.any())
        graphs.store(st, go=(status == RUNNING).any())


def _sharded_body(T_loc, basis_loc, obj, col_mask_p1, col_mask_p2,
                  art_mask, obj_row_p1, obj_row_p2, need_p1,
                  row_valid_loc, ub, mesh, tol, feas_tol, max_iters,
                  bland_after, refactor_every, devex, bounded):
    """The pivot loop of one rank.  Shapes (rank-local):

    T_loc:        (B, m_loc, N+1) constraint-row block (no objective row);
                  the drift anchor, left as it is (the loop works on a copy)
    basis_loc:    (B, m_loc) int32
    obj:          (B, N+1) replicated objective row (priced out)
    col_mask_*:   (B, N) replicated
    art_mask:     (B, N) replicated — artificial columns
    obj_row_*:    (B, N+1) replicated raw cost rows
    need_p1:      (B,) replicated
    row_valid_loc:(B, m_loc) — False on padding rows
    ub:           (B, N) replicated upper bounds (+inf where unbounded)

    ``bounded``: the native 0 <= x <= ub machinery (see the JAX function).
    Each chunk is :func:`_sharded_chunk`, one CUDA graph on the card, its
    all-reduces included (NCCL); gloo on the CPU runs it eagerly.
    Returns ``(T_loc, basis_loc, obj, status, iters, at_upper)``; ``iters``
    a host int, this batch shard's own count.
    """
    rg = mesh.row_group
    n_row = mesh.shape["row"]
    Bl, m_loc, N1 = T_loc.shape
    N = N1 - 1
    dt, dev = T_loc.dtype, T_loc.device
    i32 = torch.int32
    inf = math.inf
    rv = row_valid_loc

    # Extended artificial mask including the RHS slot (basis may point at
    # padding unit columns, which are never artificial).
    zero_lane = torch.zeros((Bl, 1), dtype=torch.bool, device=dev)
    # Drift anchors: the initial rows and basis index the exact original
    # data; the current tableau's basis0 columns approximate B^{-1}.
    cs = {"T0_loc": T_loc, "rv": rv,
          "col_idx": torch.arange(N, device=dev)[None, :],
          "art_ext": torch.cat([art_mask, zero_lane], dim=1),
          "col_mask_p1": col_mask_p1, "col_mask_p2": col_mask_p2,
          "obj_row_p1": obj_row_p1, "obj_row_p2": obj_row_p2, "ub": ub,
          "ub_safe": torch.where(torch.isfinite(ub), ub, 0.0),
          "ub_ext": torch.cat([ub, torch.full((Bl, 1), inf, dtype=dt,
                                              device=dev)], dim=1),
          "zero_col": torch.zeros((Bl, 1), dtype=dt, device=dev),
          "b_scale": 1.0 + _reduce(torch.amax(
              torch.where(rv, T_loc[:, :, -1].abs(), 0.0), dim=1), _MAX, rg),
          "basis0_full": _gather_rows_in(basis_loc, rg, n_row)}

    state = {"T": T_loc.clone(), "basis": basis_loc.to(i32).clone(),
             "obj": obj.clone(), "phase": torch.where(need_p1, 1, 2).to(i32),
             "status": torch.full((Bl,), RUNNING, dtype=i32, device=dev),
             "iters": torch.zeros((), dtype=torch.int64, device=dev),
             "w": torch.ones((Bl, N), dtype=dt, device=dev),
             "best_obj": torch.full((Bl,), inf, dtype=dt, device=dev),
             "no_imp": torch.zeros((Bl,), dtype=i32, device=dev),
             "at_upper": torch.zeros((Bl, N), dtype=torch.bool, device=dev),
             **graphs.step_state(dev)}
    static = (float(tol), float(feas_tol), int(bland_after), bool(devex),
              bool(bounded), rg, n_row)

    # The reference resyncs on step k where (k + 1) % refactor_every == 0
    # (every step for a period below 1).  A chunk ends before that step,
    # so the next one starts with it.
    period = max(int(refactor_every), 1)
    next_ref, iters_h = period - 1, 0
    any_run, any_p1 = True, bool(need_p1.any())
    with graphs.Loop("sharded.body", state, cs, static) as lp:
        st = lp.state
        while any_run and iters_h < max_iters:
            resync = iters_h == next_ref
            if resync:
                next_ref += period
            lp.run(_sharded_chunk,
                   min(_CHUNK, next_ref - iters_h, max_iters - iters_h),
                   resync, bool(any_p1))
            running = st["status"] == RUNNING
            any_run, any_p1, iters_h = lp.read(
                running.any(), (running & (st["phase"] == 1)).any(),
                st["iters"])
    T, basis, obj = state["T"], state["basis"], state["obj"]
    status, phase, at_upper = state["status"], state["phase"], \
        state["at_upper"]
    status = torch.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)

    # Final polish: Newton-refine x_B and recompute the objective value.
    T[:, :, -1] = _newton_rhs(cs, rg, n_row, T, basis,
                              _at_upper_vec(cs, at_upper) if bounded
                              else None)
    raw_obj = torch.where((phase == 1)[:, None], obj_row_p1, obj_row_p2)
    cB = torch.where(rv, raw_obj.gather(1, basis.long()), 0.0)
    z_min = _reduce((cB * T[:, :, -1]).sum(1), _SUM, rg)
    if bounded:
        z_min = z_min + _cost_at_upper(cs, raw_obj, at_upper)
    obj[:, -1] = -z_min
    return T, basis, obj, status, iters_h, at_upper


def solve_tableau_sharded(T_rows, basis, obj, col_mask_p1, col_mask_p2,
                          art_mask, obj_row_p1, obj_row_p2, need_p1,
                          row_valid, ub, mesh: Mesh,
                          tol: float = 1e-6, feas_tol: float = 1e-5,
                          max_iters: int = 4096, bland_after: int = 1024,
                          refactor_every: int = 64, devex: bool = True,
                          bounded: bool = False):
    """Solve LPs with constraint rows sharded over ``mesh`` axis ``row`` and
    instances sharded over ``batch``.

    Each rank passes its own shards, all on its device: ``T_rows`` (B_loc,
    m_loc, N+1) (the drift anchor: not written), ``basis`` and
    ``row_valid`` (B_loc, m_loc), and its batch shard of the row-replicated
    ``obj`` (B_loc, N+1), masks (B_loc, N), raw cost rows (B_loc, N+1),
    ``need_p1`` (B_loc,) and ``ub`` (B_loc, N) in the tableau's dtype
    (+inf where unbounded; ``bounded=False`` runs the classic loop).

    Returns this rank's ``(T_rows, basis, obj, status, iters, at_upper)``;
    ``iters`` is a host int, batch shard 0's count on every rank (the
    reference returns device 0's value for its unsharded output).
    """
    if T_rows.device.type == "cuda":
        # The resync's and reprice's products in full f32 (TF32 keeps
        # about three digits).
        torch.backends.cuda.matmul.allow_tf32 = False
    dt = T_rows.dtype
    T, basis_o, obj_o, status, iters, at_upper = _sharded_body(
        T_rows, basis, obj, col_mask_p1.bool(), col_mask_p2.bool(),
        art_mask.bool(), obj_row_p1.to(dt), obj_row_p2.to(dt),
        need_p1.bool(), row_valid.bool(), ub.to(dt), mesh, tol, feas_tol,
        int(max_iters), int(bland_after), int(refactor_every), bool(devex),
        bool(bounded))
    if mesh.batch_group is not None and mesh.shape["batch"] > 1:
        it = torch.tensor([iters if mesh.batch_index == 0 else 0],
                          dtype=torch.int64, device=T.device)
        iters = int(_reduce(it, _SUM, mesh.batch_group)[0])
    return T, basis_o, obj_o, status, iters, at_upper


def extract_solution_sharded(T_rows, basis, obj, row_valid, n_vars: int,
                             at_upper=None, ub=None, mesh: Mesh = None):
    """Recover ``(x, z_min)`` from sharded results, as numpy arrays of the
    whole batch on every rank.

    Each rank places its rows' values at their basis columns, the row sums
    them (one nonzero a column) and the batch gathers them.  ``at_upper`` /
    ``ub`` (this rank's batch shard): bounded solves place nonbasic
    at-upper columns at their bound.  ``mesh`` (default 1x1): the layout
    the shards come from.
    """
    mesh = mesh or Mesh(1, 1)
    Bl, _, N1 = T_rows.shape
    rhs = torch.where(row_valid.bool(), T_rows[..., -1], 0.0)
    x = torch.zeros((Bl, max(N1, n_vars)), dtype=T_rows.dtype,
                    device=T_rows.device).scatter_add_(1, basis.long(), rhs)
    x = _reduce(x[:, :n_vars].contiguous(), _SUM, mesh.row_group)
    if at_upper is not None:
        ub_n = ub[:, :n_vars]
        ub_s = torch.where(torch.isfinite(ub_n), ub_n, 0.0)
        x = torch.where(at_upper[:, :n_vars], ub_s, x)
    z_min = -obj[:, -1]
    return (_gather_batch(x, mesh).cpu().numpy(),
            _gather_batch(z_min.contiguous(), mesh).cpu().numpy())


def _shard(x, mesh, spec):
    """This rank's block of the host array ``x``: dimension ``d`` is split
    evenly over mesh axis ``spec[d]`` (None: kept whole)."""
    idx = []
    for d, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        n = mesh.shape[axis]
        k = mesh.batch_index if axis == "batch" else mesh.row_index
        size = x.shape[d] // n
        idx.append(slice(k * size, (k + 1) * size))
    return x[tuple(idx)]


# How each input of solve_tableau_sharded is split over the mesh axes.
_ROWS, _REP = ("batch", "row", None), ("batch", None)
SPECS = (_ROWS, _ROWS[:2], _REP, _REP, _REP, _REP, _REP, _REP, ("batch",),
         _ROWS[:2], _REP)


def stage_shards(arrays, mesh, device):
    """This rank's block of each of :func:`compile_sharded`'s host arrays,
    split as ``SPECS`` says, as contiguous tensors on ``device``: the
    arguments of :func:`solve_tableau_sharded`.  No other rank's block
    crosses to the device."""
    return [torch.from_numpy(np.ascontiguousarray(_shard(a, mesh, spec)))
            .to(device) for a, spec in zip(arrays, SPECS)]


def compile_sharded(c, A, b, ops, maximize, n_batch=1, n_row=1,
                    dtype=np.float32, ub=None):
    """:func:`solve_arrays_sharded`'s assembly on the host.

    Pads the batch to a multiple of ``n_batch`` with trivial instances
    (x = 0 optimal) and compiles it with the rows padded to a multiple of
    ``n_row``.  Returns ``(cb, arrays, bounded)``: the compiled batch, the
    global host inputs of :func:`solve_tableau_sharded` in its order
    (``T_rows`` a view of ``cb.T0``; ``ub`` all +inf where the batch has
    no bounds) and whether it has bounds.
    """
    from ..models.batched import compile_batch_uniform

    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    B, m, n = A.shape
    if ub is not None:
        ub = np.broadcast_to(np.asarray(ub, np.float64), (B, n))
    pad = -B % n_batch
    if pad:
        A = np.concatenate([A, np.zeros((pad, m, n))])
        b = np.concatenate([b, np.ones((pad, m))])
        c = np.concatenate([c, np.zeros((pad, n))])
        if ub is not None:
            ub = np.concatenate([ub, np.full((pad, n), np.inf)])
    cb = compile_batch_uniform(c, A, b, ops, maximize, row_pad=n_row,
                               dtype=np.dtype(dtype), align_total=False,
                               ub=ub)
    row_valid = np.zeros(cb.basis.shape, bool)
    row_valid[:, :m] = True
    bounded = cb.ub_ext is not None
    ub_full = (cb.ub_ext if bounded else
               np.full(cb.col_mask_p1.shape, np.inf, np.dtype(dtype)))
    arrays = [cb.T0[:, :-1, :], cb.basis, cb.T0[:, -1, :], cb.col_mask_p1,
              cb.col_mask_p2, cb.col_mask_p1 & ~cb.col_mask_p2,
              cb.obj_row_p1, cb.obj_row_p2, cb.need_p1, row_valid, ub_full]
    return cb, arrays, bounded


def _world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


@recorded("sharded.solve_arrays")
def solve_arrays_sharded(c, A, b, ops, maximize=True, mesh: Mesh = None,
                         dtype=np.float32, tol: float = 1e-6,
                         max_iters: int = 4096, bland_after: int = 1024,
                         refactor_every: int = 64, devex: bool = True,
                         certify: bool = True, ub=None, device="cuda"):
    """Uniform array batch → sharded solve → results, on every rank.

    Pads the batch to the ``batch`` axis and rows to a multiple of the
    ``row`` axis, stages only this rank's shard on ``device`` (the card by
    default; it raises where there is none, ``"cpu"`` runs on the CPU),
    runs the sharded loop and returns the same dict on every rank:
    ``x``, ``z``, ``status``, ``iters``, and with ``certify`` (f64 KKT
    certification and exact host escalation, ``models/certify.py``)
    ``certified`` and ``escalated``.  ``ub`` ((n,) or (B, n)): native upper
    bounds.  ``mesh`` defaults to every rank on the row axis.  Each call
    is a solve record (``utils/profiling.py``) whose stages are the spans
    ``sharded.assemble``, ``.stage``, ``.solve``, ``.extract`` and
    ``.certify``.
    """
    dev = torch_device(device)
    if mesh is None:
        mesh = make_mesh(batch=1, row=_world_size())
    B = np.shape(A)[0]

    with trace_span("sharded.assemble"):
        cb, arrays, bounded = compile_sharded(
            c, A, b, ops, maximize, mesh.shape["batch"], mesh.shape["row"],
            dtype, ub)
    with trace_span("sharded.stage"):
        args = stage_shards(arrays, mesh, dev)
        # The host tableau is dropped before the solve.
        cb.T0 = arrays[0] = arrays[2] = None
    with trace_span("sharded.solve"):
        T_out, basis_out, obj_out, status, iters, at_up = \
            solve_tableau_sharded(
                *args, mesh=mesh, tol=tol, max_iters=max_iters,
                bland_after=bland_after, refactor_every=refactor_every,
                devex=devex, bounded=bounded)
    with trace_span("sharded.extract"):
        x, z_min = extract_solution_sharded(
            T_out, basis_out, obj_out, args[9], cb.n_vars,
            at_upper=(at_up if bounded else None),
            ub=(args[10] if bounded else None), mesh=mesh)
        del args, T_out
        status = _gather_batch(status, mesh).cpu().numpy()[:B]
        if certify:
            basis_np = _gather_batch(_gather_rows(basis_out, mesh),
                                     mesh).cpu().numpy()[:B]
            at_up_np = (_gather_batch(at_up, mesh).cpu().numpy()[:B]
                        if bounded else None)
    x = np.maximum(x[:B], 0.0)
    fun = z_min[:B]
    maxi = np.asarray(cb.maximize[:B])
    z = np.where(maxi, -fun, fun) + 0.0
    ok = status == STATUS_OPTIMAL
    out = {
        "x": np.where(ok[:, None], x, np.nan),
        "z": np.where(ok, z, np.nan),
        "status": status,
        "iters": int(iters),
    }
    if certify:
        # The structured f64 certifier of the batched path: a k x k LU an
        # instance, no m x N f64 standard form.
        from ..models.certify import certify_and_escalate_raw

        with trace_span("sharded.certify"):
            fix = certify_and_escalate_raw(
                status, basis_np, c, A, b, ops, maxi, ub=ub,
                at_upper=at_up_np)
        out.update(
            x=fix["x"], z=fix["z"], status=fix["status"],
            certified=fix["certified"], escalated=fix["escalated"])
    return out
